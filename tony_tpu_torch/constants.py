"""The names the port shares with the orchestrator: env var names, file
names, framework ids, exit codes and test hooks.

The port's own copy of `tony_tpu/constants.py` (which it does not import):
the same names and the same values, so an AM, executor, trainer or server
of either package speaks the same exit codes and writes and reads the same
environment and files. They are wire names, kept as they are.
"""


# ---------------------------------------------------------------------------
# Core env vars injected into every task container
# (reference: ApplicationMaster.java:1109-1121, Constants.java)
# ---------------------------------------------------------------------------
JOB_NAME = "JOB_NAME"                # task type, e.g. "worker", "ps", "chief"
TASK_INDEX = "TASK_INDEX"            # index within the task type
TASK_NUM = "TASK_NUM"                # total number of tasks in this type
IS_CHIEF = "IS_CHIEF"                # "true" if this task is the chief
SESSION_ID = "SESSION_ID"            # AM session generation (bumped on retry)
AM_HOST = "AM_HOST"
AM_PORT = "AM_PORT"
METRICS_RPC_PORT = "METRICS_RPC_PORT"
CONTAINER_ID = "CONTAINER_ID"
APP_ID = "APP_ID"
ATTEMPT_NUMBER = "ATTEMPT_NUMBER"    # reference: ApplicationMaster.java:369
NUM_AM_RETRIES = "NUM_AM_RETRIES"    # reference: Constants.java:113-114
TASK_ATTEMPT = "TASK_ATTEMPT"        # per-task attempt number (bumped on
                                     # single-task relaunch, not AM retry)
SPEC_GENERATION = "SPEC_GENERATION"  # cluster-spec generation the user
                                     # process was launched against (bumped
                                     # on every task relaunch)
TASK_COMMAND = "TASK_COMMAND"        # the user command this executor runs
AM_ATTEMPT = "TONY_AM_ATTEMPT"       # AM process attempt number, set by the
                                     # supervisor (am/supervisor.py) on every
                                     # relaunch; attempt > 0 replays the
                                     # control-plane journal and RECOVERs
                                     # (ATTEMPT_NUMBER is taken: it carries
                                     # the SESSION id into container envs)
MODEL_PARAMS = "MODEL_PARAMS"        # preprocess-scraped params injected into
                                     # every task env (Constants.java:84,
                                     # ApplicationMaster.java:753-764)
MODEL_PARAMS_MARKER = "Model parameters: "  # stdout line prefix the AM scans

# ---------------------------------------------------------------------------
# Framework bootstrap env (reference: TaskExecutor.java:161-207)
# ---------------------------------------------------------------------------
CLUSTER_SPEC = "CLUSTER_SPEC"        # JSON {jobtype: ["host:port", ...]}
TF_CONFIG = "TF_CONFIG"              # TF_CONFIG JSON (TFConfig.java:13-74)
TB_PORT = "TB_PORT"                  # TensorBoard port, chief only

# Serving (new in this build — no reference equivalent; the reference's
# lifecycle ended at training): the port a `serving` task's HTTP frontend
# must bind. Rendered by runtimes.render_framework_env from the task's own
# cluster-spec entry, so the endpoint the AM gossips IS the live server.
SERVING_PORT = "SERVING_PORT"
# weights rollout epoch a serving replica announces with its endpoint
# (rolling updates; 0/absent = the AM stamps its current epoch)
SERVING_WEIGHTS_GENERATION = "TONY_SERVING_WEIGHTS_GENERATION"
# per-replica disaggregation role override ("prefill"|"decode"|"both");
# absent = tony.serving.role from the frozen conf
SERVING_ROLE = "TONY_SERVING_ROLE"

# PyTorch (reference: Constants.java:50-54, Utils.parseClusterSpecForPytorch)
INIT_METHOD = "INIT_METHOD"          # tcp://<worker0 host:port>
RANK = "RANK"
WORLD = "WORLD"
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"

# MXNet (reference: TaskExecutor.java:180-200)
DMLC_ROLE = "DMLC_ROLE"
DMLC_PS_ROOT_URI = "DMLC_PS_ROOT_URI"
DMLC_PS_ROOT_PORT = "DMLC_PS_ROOT_PORT"
DMLC_NUM_SERVER = "DMLC_NUM_SERVER"
DMLC_NUM_WORKER = "DMLC_NUM_WORKER"

# JAX / TPU (new in this build — no reference equivalent; renders the env
# consumed by jax.distributed.initialize and TPU topology discovery)
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"   # host:port of process 0
JAX_PROCESS_ID = "JAX_PROCESS_ID"
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
TPU_MESH_SHAPE = "TPU_MESH_SHAPE"    # e.g. "2,2,1" — job-requested mesh axes
TPU_MESH_AXES = "TPU_MESH_AXES"      # e.g. "dp,fsdp,tp"
TPU_SLICE_ID = "TPU_SLICE_ID"        # multi-slice (DCN) slice index
TPU_NUM_SLICES = "TPU_NUM_SLICES"
# elastic gang resize (cluster/elastic.py): the mesh shape the CURRENT
# width implies, overriding the frozen conf's TPU_MESH_SHAPE in every
# (re)launched user process env. Rendered by the AM into containers
# launched mid-resize; survivors receive the same value on the
# heartbeat-piggybacked resize ask.
ELASTIC_MESH_SHAPE = "TONY_ELASTIC_MESH_SHAPE"

# Observability (observability/ subsystem): trace context rendered into
# every child process env — trace_id = app_id; the parent span id is the
# AM's task span for executors, the executor's user_process span for the
# user process, so client→AM→executor→trainer spans chain into one
# waterfall on the portal job page.
TONY_TRACE_ID = "TONY_TRACE_ID"
TONY_PARENT_SPAN = "TONY_PARENT_SPAN"
# executor-accounted goodput phases handed to the user process (JSON
# {"localization": s, "rendezvous_wait": s}) so the trainer's single
# per-task ledger covers the whole container lifetime without
# double-counting (observability/perf.py GoodputLedger.from_env)
TONY_GOODPUT_SEED = "TONY_GOODPUT_SEED"
# checkpoint retention (tony.checkpoint.keep rendered into every user
# process env): the trainer's checkpointer prunes committed step dirs
# beyond this count after each successful commit (train/checkpoint.py
# prune_checkpoints; 0 = keep everything)
CHECKPOINT_KEEP = "TONY_CHECKPOINT_KEEP"
# persistent XLA compile cache dir (tony.executor.jax-cache-dir rendered
# into every trainer/serving user env; utils/compilecache.py applies it
# before the first jit so the Nth identical trainer skips the cold
# compile — empty/absent = no persistent cache)
JAX_CACHE_DIR = "TONY_JAX_CACHE_DIR"
# warm-pool bind fence (cluster/warmpool.py): the pool stamps a
# per-child nonce into the child env at fork and every stdin bind spec
# must echo it — a spec written by anything other than THIS child's
# pool (a stale pipe, a crossed fd after re-exec) is rejected, the
# process-identity half of the task-token attempt fence
WARMPOOL_NONCE = "TONY_WARMPOOL_NONCE"

# Paths handed to AM / executor processes via env
TONY_CONF_PATH = "TONY_CONF_PATH"    # abs path of the frozen tony-final.json
TONY_CONF_URI = "TONY_CONF_URI"      # staged conf URI for off-host executors
TONY_APP_DIR = "TONY_APP_DIR"        # per-app staging/work dir

# ---------------------------------------------------------------------------
# File names / layout
# ---------------------------------------------------------------------------
TONY_FINAL_CONF = "tony-final.json"  # frozen merged conf shipped to every process
AM_HOSTPORT_FILE = "amhostport"      # written by AM once its RPC server is up
AM_STATUS_FILE = "status.json"       # final {status, message}, written at AM exit
HISTORY_DIR_NAME = "history"         # per-app intermediate history dir
CONTAINERS_DIR_NAME = "containers"   # per-app container log dirs
AM_STDOUT = "am.stdout"
AM_STDERR = "am.stderr"
TONY_DEFAULT_CONF = "tony-default.json"
TONY_SITE_CONF = "tony-site.json"
TONY_CONF_DIR_ENV = "TONY_CONF_DIR"
TONY_APP_STAGING_PREFIX = ".tony"    # per-app staging dir (reference: .tony/<appId>)
TONY_SRC_ZIP = "tony_src.zip"
HISTORY_SUFFIX = "jhist"
HISTORY_INPROGRESS_SUFFIX = "jhist.inprogress"
PORTAL_CONFIG_FILE = "config.json"   # frozen conf copy in each history dir
HISTORY_LOGS_DIR_NAME = "logs"       # aggregated container logs in history
SPANS_FILE = "spans.json"            # lifecycle spans flushed next to events
METRICS_FILE = "metrics.json"        # per-gauge timeseries flushed at finish
GOODPUT_FILE = "goodput.json"        # per-task + job time accounting (perf.py)
DIAGNOSTICS_FILE = "diagnostics.json"  # root-cause bundle on job failure:
                                     # first-failing task, exit signal,
                                     # matched signature, redacted tails
                                     # (observability/logs.py)
TRACE_SEED_FILE = "trace.json"       # client-written {trace_id, submit_ms}
AM_METRICS_PORT_FILE = "am-metrics-port"  # bound /metrics scrape port
AM_INFO_FILE = "am.json"             # {host, rpc_port} in the history dir, so
                                     # the portal can reach a RUNNING job's AM
                                     # (POST /api/jobs/:id/profile)
AM_JOURNAL_FILE = "journal.jsonl"    # append-only fsync'd write-ahead journal
                                     # of control-plane state (am/journal.py):
                                     # a recovering AM attempt replays it into
                                     # a fresh TonySession and adopts the
                                     # still-running gang
AM_JOURNAL_SNAPSHOT_FILE = "journal-snapshot.json"  # tmp+rename compacted
                                     # journal prefix; replay = snapshot +
                                     # incremental records after it
PROFILE_REQUEST_FILE = "profile_request.json"  # executor-written, trainer-read
                                     # (heartbeat-piggybacked request_profile)
PROFILES_DIR_NAME = "profiles"       # trace artifacts: container cwd + history
SKEW_FILE = "skew.json"              # cross-task skew bundle flushed next to
                                     # the event log (observability/skew.py):
                                     # gang sketch summaries, step-time
                                     # heatmap, latched stragglers +
                                     # detection log
JOBSTATE_FILE = "jobstate.json"      # compact heartbeat-stamped job summary
                                     # (observability/fleet.py): published to
                                     # the staging store while the job runs
                                     # (the live cross-job registry's source)
                                     # and flushed into history at finish
FLEET_DIR_NAME = "fleet"             # staging-store namespace of the fleet
                                     # layer: <app_id>/fleet/jobstate.json
                                     # per job, fleet/accounting.json at the
                                     # store root (durable chip-hour ledger)
ALERTS_FILE = "alerts.json"          # alert-engine bundle flushed next to
                                     # the event log (observability/alerts.py):
                                     # currently-firing alerts + the bounded
                                     # transition log; refreshed on every
                                     # transition so the portal's sidecar
                                     # fallback stays live-ish mid-run
SERVING_TRACES_FILE = "serving_traces.json"  # tail-sampled per-request
                                     # serving traces (observability/
                                     # reqtrace.py), piggybacked on the
                                     # metrics RPC and flushed next to the
                                     # event log; the portal's request
                                     # waterfall and `cli trace` render it
PROFILE_FOLDED_FILE = "profile.folded"  # AM's collapsed-stack profile
                                     # (flamegraph.pl format, one
                                     # "thread;frame;... count" line per
                                     # stack) flushed next to the event
                                     # log at finish and served live via
                                     # get_profile / /api/jobs/:id/flame
CORE_SITE_CONF = "core-site.xml"

# ---------------------------------------------------------------------------
# Task / job type names with special semantics
# (reference: TonySession.java:364-367 chief semantics)
# ---------------------------------------------------------------------------
CHIEF_JOB_NAME = "chief"
WORKER_JOB_NAME = "worker"
PS_JOB_NAME = "ps"
EVALUATOR_JOB_NAME = "evaluator"
SCHEDULER_JOB_NAME = "scheduler"     # MXNet
SERVER_JOB_NAME = "server"           # MXNet
NOTEBOOK_JOB_NAME = "notebook"
DRIVER_JOB_NAME = "driver"
SERVING_JOB_NAME = "serving"         # online inference (serve/ subsystem):
                                     # default command = python -m
                                     # tony_tpu_torch.serve; endpoint recorded in
                                     # the cluster spec + history events
AM_NAME = "am"

# ---------------------------------------------------------------------------
# ML framework ids (reference: TonyConfigurationKeys.java:12-17 MLFramework)
# ---------------------------------------------------------------------------
FRAMEWORK_TENSORFLOW = "tensorflow"
FRAMEWORK_PYTORCH = "pytorch"
FRAMEWORK_MXNET = "mxnet"
FRAMEWORK_HOROVOD = "horovod"
FRAMEWORK_JAX = "jax"                # new: first-class TPU runtime
SUPPORTED_FRAMEWORKS = (
    FRAMEWORK_TENSORFLOW,
    FRAMEWORK_PYTORCH,
    FRAMEWORK_MXNET,
    FRAMEWORK_HOROVOD,
    FRAMEWORK_JAX,
)

# ---------------------------------------------------------------------------
# Fault-injection test hooks compiled into prod code
# (reference: Constants.java:116-121; ApplicationMaster.java:337-342,1204-1215;
#  TaskExecutor.java:334-344,372-392)
# ---------------------------------------------------------------------------
TEST_AM_CRASH = "TEST_AM_CRASH"
TEST_WORKER_TERMINATION = "TEST_WORKER_TERMINATION"
TEST_TASK_COMPLETION_NOTIFICATION_DELAYED = "TEST_TASK_COMPLETION_NOTIFICATION_DELAYED"
TEST_TASK_EXECUTOR_NUM_HB_MISS = "TEST_TASK_EXECUTOR_NUM_HB_MISS"
TEST_TASK_EXECUTOR_SKEW = "TEST_TASK_EXECUTOR_SKEW"  # format: "type#index#sleep_ms"
# chaos-harness kill/delay injection points (tests/chaos.py drives these):
# hard-crash one specific task attempt's executor mid-run — the container
# exits non-zero WITHOUT registering a result, exercising the
# container-completion relaunch path. Format: "type#index#after_ms#attempt"
# with after_ms measured from the user process's launch (not executor
# boot), so the gang is guaranteed past the barrier when the kill fires.
TEST_TASK_KILL = "TEST_TASK_KILL"
# silently drop every heartbeat of one specific task attempt while its user
# process keeps running — exercises the heartbeat-expiry relaunch path.
# Format: "type#index#attempt".
TEST_TASK_HB_SILENCE = "TEST_TASK_HB_SILENCE"
# wedge injection (chaos harness): park one specific task attempt's
# executor MAIN thread in a recognizably-named function
# (_tony_test_wedge) right after its log/stack service is up, while its
# heartbeats are typically silenced alongside via TEST_TASK_HB_SILENCE —
# the liveliness expiry then autopsies a process that is alive-but-stuck
# and diagnostics.json names the blocking frame. Format: "type#index#attempt".
TEST_TASK_WEDGE = "TEST_TASK_WEDGE"
# preemption injection (chaos harness): the AM preempts ITSELF
# `after_ms` after prepare(), exactly as if an arbiter's
# request_preemption RPC had arrived — drain ask rides the heartbeats,
# executors TERM their user processes, trainers emergency-checkpoint
# within the grace window. Format: "after_ms[#grace_ms]".
TEST_TASK_PREEMPT = "TEST_TASK_PREEMPT"
# steady-state straggler injection: slow EVERY train step of one specific
# task attempt by a fixed delay (the complement of the startup-only
# TEST_TASK_EXECUTOR_SKEW above). Format: "type#index#ms[#attempt]";
# attempt defaults to '*' (every attempt). The executor renders the
# matching task's delay into its user-process env as
# TONY_TRAINER_STEP_DELAY_MS; the trainer (and the chaos gang scripts)
# sleep that long per step.
TEST_TRAINER_STEP_DELAY = "TEST_TRAINER_STEP_DELAY"
# the rendered per-process form of the hook above (ms per step; unset or
# 0 = no delay) — read by the trainer hot loop's test seam
TRAINER_STEP_DELAY_MS = "TONY_TRAINER_STEP_DELAY_MS"
# serving chaos: slow one replica's DECODE by a fixed per-step delay
# (ms; unset or 0 = none), read once at engine construction — the
# slow-hop-attribution e2e plants it on one decode replica of a
# disaggregated fleet and asserts the sampled trace blames that hop
TEST_SERVE_DECODE_DELAY = "TEST_SERVE_DECODE_DELAY"
# AM crash injection (chaos harness): the AM SIGKILLs its own process
# `after_ms` after prepare() — no teardown, no history flush, nothing; the
# supervisor (am/supervisor.py) relaunches it and the new attempt replays
# the control-plane journal. Format: "after_ms[#attempt]" — the kill fires
# only on the named AM attempt (default 0), so the recovered attempt runs
# clean.
TEST_AM_KILL = "TEST_AM_KILL"
# AM hang injection: SIGSTOP the AM `after_ms` after prepare() for
# `hang_ms`, then SIGCONT — executors see heartbeat timeouts, enter orphan
# mode, find the SAME amhostport, and resume once the AM thaws (recovery
# without a restart). Format: "after_ms#hang_ms[#attempt]".
TEST_AM_HANG = "TEST_AM_HANG"
# seed for jittered backoff/injection randomness so chaos failures replay
# exactly (propagates into AM + executor child processes)
TEST_SEED = "TONY_TEST_SEED"

# Executor self-destructs after this many consecutive failed heartbeats
# (reference: TaskExecutor.java:36 MAX_CONSECUTIVE_FAILED_HEARTBEATS)
MAX_CONSECUTIVE_FAILED_HEARTBEATS = 5

# Exit codes
EXIT_SUCCESS = 0
EXIT_FAILURE = 1
EXIT_HEARTBEAT_FAILURE = 9  # executor killed itself after missed heartbeats
# executor gave up waiting at the gang-rendezvous barrier. Observability
# only: the AM's no-relaunch decision rides the barrier_timeout flag on
# register_execution_result, NOT this value — every 0-255 exit code is
# also reachable by the user process, so the code alone proves nothing
EXIT_RENDEZVOUS_TIMEOUT = 10
# trainer exited through its SIGTERM-driven emergency-checkpoint path
# (checkpoint-then-evict preemption, real TPU maintenance/spot eviction,
# or an operator stop). Observability only, like the rendezvous code
# above: the AM's no-fault decision rides the `preempted` flag on
# register_execution_result, NOT this value — every 0-255 exit code is
# also reachable by the user process itself.
EXIT_PREEMPTED = 12
# Exit code reported when the AM itself stops a container; matches YARN's
# ContainerExitStatus.KILLED_BY_APPMASTER used by the reference
# (TonySession.java:485-488). Single source of truth for all modules.
EXIT_KILLED_BY_AM = -105

# structured JSON logs unless this is 1/true/yes (the port's log setup
# reads it; the JAX package keeps it in its logs module)
PLAIN_LOGS_ENV = "TONY_LOG_PLAIN"
