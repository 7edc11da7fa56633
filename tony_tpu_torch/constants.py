"""The names the port shares with the orchestrator.

The port's own copy of the entries it needs from `tony_tpu/constants.py`
(which it does not import): the same names and the same values, so a
trainer or server of either package speaks the same exit codes and reads
the same environment the executor renders.
"""

# Checkpoint retention: committed step directories the trainer keeps after
# each commit (the executor renders it from tony.checkpoint.keep; 0 = keep
# everything).
CHECKPOINT_KEEP = "TONY_CHECKPOINT_KEEP"

# The trainer left through its SIGTERM-driven emergency checkpoint
# (checkpoint-then-evict preemption or an operator stop).
EXIT_PREEMPTED = 12

# -- the task identity and the AM's address (rendered into every task) ----
JOB_NAME = "JOB_NAME"                # task type, e.g. "worker", "serving"
TASK_INDEX = "TASK_INDEX"            # index within the task type
CLUSTER_SPEC = "CLUSTER_SPEC"        # JSON {jobtype: ["host:port", ...]}
WORKER_JOB_NAME = "worker"           # the workers' jobtype
IS_CHIEF = "IS_CHIEF"                # "true" if this task is the chief
TB_PORT = "TB_PORT"                  # TensorBoard port, chief only
AM_HOST = "AM_HOST"
AM_PORT = "AM_PORT"
METRICS_RPC_PORT = "METRICS_RPC_PORT"
APP_ID = "APP_ID"
TASK_ATTEMPT = "TASK_ATTEMPT"        # per-task attempt number

# -- serving -------------------------------------------------------------
SERVING_JOB_NAME = "serving"         # the serving jobtype's name
SERVING_PORT = "SERVING_PORT"        # the executor-registered HTTP port
SERVING_WEIGHTS_GENERATION = "TONY_SERVING_WEIGHTS_GENERATION"
SERVING_ROLE = "TONY_SERVING_ROLE"   # "both" | "prefill" | "decode"

# -- observability -------------------------------------------------------
# trace context: trace id = app id; the parent span is the executor's
# user_process span, so the task's spans chain into the job's waterfall
TONY_TRACE_ID = "TONY_TRACE_ID"
TONY_PARENT_SPAN = "TONY_PARENT_SPAN"
# executor-accounted goodput phases handed to the user process (JSON
# {"localization": s, "rendezvous_wait": s})
TONY_GOODPUT_SEED = "TONY_GOODPUT_SEED"
# on-demand profile capture: the executor writes the request file into
# the task's cwd; traces land in profiles/<request_id>/
PROFILE_REQUEST_FILE = "profile_request.json"
PROFILES_DIR_NAME = "profiles"
# structured JSON logs unless this is 1/true/yes
PLAIN_LOGS_ENV = "TONY_LOG_PLAIN"

# the executor's persistent compile cache directory (from
# tony.executor.jax-cache-dir): the port keeps its kernel builds there
JAX_CACHE_DIR = "TONY_JAX_CACHE_DIR"

# -- configuration -------------------------------------------------------
TONY_CONF_PATH = "TONY_CONF_PATH"    # abs path of the frozen tony-final.json

# -- fault injection -----------------------------------------------------
# a fixed per-step host sleep (ms) that makes this task a steady straggler
TRAINER_STEP_DELAY_MS = "TONY_TRAINER_STEP_DELAY_MS"
# seed for the RPC client's retry jitter, so a replay draws the same delays
TEST_SEED = "TONY_TEST_SEED"

# -- rendezvous and the mesh (a gang of training ranks) -----------------
# the pytorch runtime's env (TonY's parseClusterSpecForPytorch)
INIT_METHOD = "INIT_METHOD"          # tcp://<worker0 host:port>
RANK = "RANK"
WORLD = "WORLD"
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"
# the jax runtime's env, read when the pytorch one is absent
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"   # host:port of rank 0
JAX_PROCESS_ID = "JAX_PROCESS_ID"
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
TPU_MESH_SHAPE = "TPU_MESH_SHAPE"    # e.g. "2,2,1": the mesh's axis sizes
TPU_MESH_AXES = "TPU_MESH_AXES"      # e.g. "dp,fsdp,tp"
TPU_SLICE_ID = "TPU_SLICE_ID"        # a rank's slice (DCN island) index
TPU_NUM_SLICES = "TPU_NUM_SLICES"
