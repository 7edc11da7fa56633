"""The names the port shares with the orchestrator.

The port's own copy of the entries it needs from `tony_tpu/constants.py`
(which it does not import): the same names and the same values, so a
trainer, server or executor of either package speaks the same exit codes
and reads and renders the same environment. They are wire names: the AM
that launches the port's executor is the JAX package's, unchanged.
"""

# Checkpoint retention: committed step directories the trainer keeps after
# each commit (the executor renders it from tony.checkpoint.keep; 0 = keep
# everything).
CHECKPOINT_KEEP = "TONY_CHECKPOINT_KEEP"

# -- exit codes ------------------------------------------------------------
EXIT_SUCCESS = 0
EXIT_FAILURE = 1
EXIT_HEARTBEAT_FAILURE = 9   # the executor left after missed heartbeats
# the executor gave up at the gang barrier (the AM reads the
# barrier_timeout flag of the result, not this value)
EXIT_RENDEZVOUS_TIMEOUT = 10
# The trainer left through its SIGTERM-driven emergency checkpoint
# (checkpoint-then-evict preemption or an operator stop).
EXIT_PREEMPTED = 12
# the AM stopped the container (YARN's KILLED_BY_APPMASTER)
EXIT_KILLED_BY_AM = -105
# consecutive failed heartbeats after which an executor gives up
MAX_CONSECUTIVE_FAILED_HEARTBEATS = 5

# -- the task identity and the AM's address (rendered into every task) ----
JOB_NAME = "JOB_NAME"                # task type, e.g. "worker", "serving"
TASK_INDEX = "TASK_INDEX"            # index within the task type
TASK_NUM = "TASK_NUM"                # number of tasks of this type
CLUSTER_SPEC = "CLUSTER_SPEC"        # JSON {jobtype: ["host:port", ...]}
IS_CHIEF = "IS_CHIEF"                # "true" if this task is the chief
TB_PORT = "TB_PORT"                  # TensorBoard port, chief only
SESSION_ID = "SESSION_ID"            # the AM's session (bumped on retry)
AM_HOST = "AM_HOST"
AM_PORT = "AM_PORT"
METRICS_RPC_PORT = "METRICS_RPC_PORT"
CONTAINER_ID = "CONTAINER_ID"
APP_ID = "APP_ID"
ATTEMPT_NUMBER = "ATTEMPT_NUMBER"    # the AM session id, as YARN named it
TASK_ATTEMPT = "TASK_ATTEMPT"        # per-task attempt number
# the cluster-spec generation the user process was launched against
SPEC_GENERATION = "SPEC_GENERATION"
TASK_COMMAND = "TASK_COMMAND"        # the user command the executor runs
# parameters a preprocess stage printed, handed to every task
MODEL_PARAMS = "MODEL_PARAMS"

# -- jobtypes with their own meaning --------------------------------------
CHIEF_JOB_NAME = "chief"
WORKER_JOB_NAME = "worker"           # the workers' jobtype
SCHEDULER_JOB_NAME = "scheduler"     # MXNet
SERVER_JOB_NAME = "server"           # MXNet

# -- the frameworks whose rendezvous the executor renders -----------------
FRAMEWORK_TENSORFLOW = "tensorflow"
FRAMEWORK_PYTORCH = "pytorch"
FRAMEWORK_MXNET = "mxnet"
FRAMEWORK_HOROVOD = "horovod"
FRAMEWORK_JAX = "jax"
TF_CONFIG = "TF_CONFIG"              # {"cluster": spec, "task": {...}}
DMLC_ROLE = "DMLC_ROLE"
DMLC_PS_ROOT_URI = "DMLC_PS_ROOT_URI"
DMLC_PS_ROOT_PORT = "DMLC_PS_ROOT_PORT"
DMLC_NUM_SERVER = "DMLC_NUM_SERVER"
DMLC_NUM_WORKER = "DMLC_NUM_WORKER"

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

# -- configuration and the application's directory -----------------------
TONY_CONF_PATH = "TONY_CONF_PATH"    # abs path of the frozen tony-final.json
TONY_CONF_URI = "TONY_CONF_URI"      # its staged URI, for off-host tasks
TONY_APP_DIR = "TONY_APP_DIR"        # the application's directory
TONY_FINAL_CONF = "tony-final.json"  # the frozen conf's file name
AM_HOSTPORT_FILE = "amhostport"      # the AM's host:port, in the app dir

# -- fault injection -----------------------------------------------------
# a fixed per-step host sleep (ms) that makes this task a steady straggler
TRAINER_STEP_DELAY_MS = "TONY_TRAINER_STEP_DELAY_MS"
# the executor's hooks, read from its own environment:
# skip the first N heartbeats
TEST_TASK_EXECUTOR_NUM_HB_MISS = "TEST_TASK_EXECUTOR_NUM_HB_MISS"
# "type#index#ms": sleep after the barrier, before the user process
TEST_TASK_EXECUTOR_SKEW = "TEST_TASK_EXECUTOR_SKEW"
# "type#index#after_ms#attempt": crash the executor after_ms after its
# user process starts, with no result registered
TEST_TASK_KILL = "TEST_TASK_KILL"
# "type#index#attempt": never heartbeat while the user process runs
TEST_TASK_HB_SILENCE = "TEST_TASK_HB_SILENCE"
# "type#index#attempt": park the main thread after the barrier
TEST_TASK_WEDGE = "TEST_TASK_WEDGE"
# "type#index#ms[#attempt]": render TRAINER_STEP_DELAY_MS into that task
TEST_TRAINER_STEP_DELAY = "TEST_TRAINER_STEP_DELAY"
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
# an elastic resize's mesh shape, which overrides the frozen conf's in the
# task env (the AM renders it into containers launched mid-resize)
ELASTIC_MESH_SHAPE = "TONY_ELASTIC_MESH_SHAPE"
