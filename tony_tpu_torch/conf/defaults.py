"""Default values for every static configuration key.

The port's copy of `tony_tpu/conf/defaults.py`: the same values.

Equivalent of the reference's tony-default.xml
(tony-core/src/main/resources/tony-default.xml). The drift test
(tests/test_conf.py::test_defaults_drift) asserts — like the reference's
TestTonyConfigurationFields.java:13-66 — that every static key declared in
`tony_tpu_torch.conf.keys` has a default here and vice versa.
"""

from tony_tpu_torch.conf import keys as K

# Keys that intentionally have NO default (user- or system-supplied only).
# Mirrors the reference's configurationPropsToSkipCompare set.
NO_DEFAULT_KEYS = frozenset({
    K.TASK_COMMAND,
    K.APPLICATION_NODE_LABEL,
    K.APPLICATION_RESUMED_FROM,
    K.APPLICATION_PREEMPTED_AT_MS,
    K.APPLICATION_PREEMPT_COUNT,
    K.APPLICATION_HDFS_CONF_LOCATION,
    K.APPLICATION_YARN_CONF_LOCATION,
    K.APPLICATION_PREPARE_STAGE,
    K.APPLICATION_TRAINING_STAGE,
    K.APPLICATION_UNTRACKED_JOBTYPES,
    K.APPLICATION_STOP_ON_FAILURE_JOBTYPES,
    K.CONTAINERS_RESOURCES,
    K.DOCKER_IMAGE,
    K.DOCKER_MOUNTS,
    K.KEYTAB_USER,
    K.KEYTAB_LOCATION,
    K.PORTAL_URL,
    K.PORTAL_TOKEN_FILE,
    K.PORTAL_USER_TOKENS_FILE,
    K.HISTORY_STORE_LOCATION,
    K.SRC_DIR,
    K.PYTHON_VENV,
    K.EXECUTION_ENV,
    K.APPLICATION_TAGS,
    K.TPU_MESH_SHAPE,
    K.TPU_MESH_AXES,
    K.CLUSTER_NODES,
    K.CLUSTER_SSH_OPTS,
    K.PROXY_URL,
    K.ALERTS_RULES,
    K.ALERTS_WEBHOOK_URL,
    K.ALERTS_FILE_SINK,
    K.HISTORY_LOCATION,
    K.HISTORY_INTERMEDIATE,
    K.HISTORY_FINISHED,
})

DEFAULTS = {
    # application
    K.APPLICATION_NAME: "tony_tpu",
    K.APPLICATION_QUEUE: "default",
    K.APPLICATION_PRIORITY: 0,
    K.APPLICATION_TIMEOUT: 0,
    K.APPLICATION_SECURITY_ENABLED: False,
    K.APPLICATION_FRAMEWORK: "jax",
    K.APPLICATION_SINGLE_NODE: False,
    K.APPLICATION_ENABLE_PREPROCESS: False,
    K.APPLICATION_FAIL_ON_WORKER_FAILURE: False,

    # am (reference defaults: tony-default.xml am section)
    K.AM_RETRY_COUNT: 0,
    K.AM_RETRY_BACKOFF_BASE_MS: 1000,
    K.AM_RETRY_BACKOFF_MAX_MS: 30_000,
    K.AM_MEMORY: "2g",
    K.AM_VCORES: 1,
    K.AM_GANG_MAX_WAIT_MS: 0,
    # reference AM monitor cadence: 5 s (ApplicationMaster.java:643-648);
    # tests dial this down to keep the E2E suite fast
    K.AM_MONITOR_INTERVAL_MS: 5000,
    # how long the AM waits for the client's finish signal before
    # unregistering (ApplicationMaster.stop poll, ApplicationMaster.java:669-710)
    K.AM_STOP_POLL_TIMEOUT_MS: 30_000,
    # control-plane sizing; 0 = width-aware auto (rpc/service.py
    # auto_rpc_workers, am/liveliness.py auto_liveliness_shards)
    K.AM_RPC_WORKERS: 0,
    K.AM_LIVELINESS_SHARDS: 0,
    # AM crash survivability (am/supervisor.py + am/journal.py);
    # 1 = unsupervised single process (an AM crash fails the app)
    K.AM_MAX_ATTEMPTS: 1,
    K.AM_ORPHAN_GRACE_MS: 30_000,
    K.AM_JOURNAL_ENABLED: True,
    K.AM_JOURNAL_SNAPSHOT_EVERY: 256,
    K.AM_RECOVERY_SETTLE_MS: 30_000,

    # task cadences (reference: TonyConfigurationKeys.java:143-150)
    K.TASK_HEARTBEAT_INTERVAL_MS: 1000,
    K.TASK_MAX_MISSED_HEARTBEATS: 25,
    # reference MAX_CONSECUTIVE_FAILED_HEARTBEATS (TaskExecutor.java:36)
    K.TASK_HB_FAILURE_BUDGET: 5,
    # fault tolerance: 1 attempt = the reference's all-or-nothing behavior;
    # raise to enable single-task relaunch without full-gang teardown
    K.TASK_MAX_TASK_ATTEMPTS: 1,
    K.APPLICATION_MAX_TOTAL_TASK_FAILURES: -1,
    K.TASK_METRICS_INTERVAL_MS: 5000,
    K.TASK_LOW_UTIL_INTERVALS: 24,
    # GPU sampling for `gpus` jobtypes (reference defaults: enabled, bare
    # binary name resolved through the search dirs —
    # TonyConfigurationKeys.java:152-154,273-274)
    K.TASK_GPU_METRICS_ENABLED: True,
    K.GPU_PATH_TO_EXEC: "",
    K.TASK_EXECUTOR_JVM_OPTS: "",
    # reference default constant 15 min (TonyConfigurationKeys.java:243-244)
    K.CONTAINER_ALLOCATION_TIMEOUT: 15 * 60 * 1000,
    K.TASK_REGISTRATION_TIMEOUT_SEC: 300,
    K.TASK_REGISTRATION_RETRY_COUNT: 0,
    # TERM→KILL grace on every user-process termination path, sized to
    # cover an emergency checkpoint (AsyncCheckpointer.wait + one
    # synchronous sharded save); the wait returns as soon as the process
    # exits, so well-behaved shutdowns never pay the full window
    K.TASK_TERM_GRACE_MS: 15_000,
    # checkpoint retention: committed step dirs kept (0 = unlimited)
    K.CHECKPOINT_KEEP: 3,

    # limits: -1 = unlimited (reference: TonyClient.java:598-667)
    K.MAX_TOTAL_INSTANCES: -1,
    K.MAX_TOTAL_TPUS: -1,
    K.MAX_TOTAL_GPUS: -1,

    # history
    K.HISTORY_RETENTION_SEC: 30 * 24 * 3600,
    K.HISTORY_MOVER_INTERVAL_MS: 5 * 60 * 1000,
    K.HISTORY_PURGER_INTERVAL_MS: 6 * 3600 * 1000,
    K.HISTORY_STALE_INPROGRESS_SEC: 24 * 3600,
    K.HISTORY_LOG_MAX_SIZE: "10m",

    # observability
    K.METRICS_HISTORY_POINTS: 512,
    K.METRICS_PORT: 0,           # 0 = ephemeral; -1 = no /metrics endpoint
    K.TRACE_ENABLED: True,
    K.TRACE_MAX_SPANS: 2048,
    K.GOODPUT_ENABLED: True,
    K.PROFILING_ENABLED: True,
    K.PROFILING_DEFAULT_STEPS: 5,
    # always-on control-plane profiler + stall watchdog
    # (observability/profiler.py)
    K.PROFILER_ENABLED: True,
    K.PROFILER_HZ: 19.0,               # prime-ish; jittered at runtime
    K.PROFILER_MAX_STACKS: 2000,
    K.PROFILER_STALL_FACTOR: 4.0,
    K.PROFILER_OVERHEAD_BUDGET_PCT: 1.0,
    K.SLO_STEP_TIME_REGRESSION_PCT: 0,   # 0 = step-time check disabled
    K.SLO_GOODPUT_FLOOR_PCT: 0,          # 0 = goodput-floor check disabled
    # live log streaming / diagnostics (observability/logs.py)
    K.LOGS_TAIL_BYTES: 65536,
    K.LOGS_CHUNK_BYTES: 32768,
    K.LOGS_FOLLOW_POLL_MS: 500,
    K.LOGS_DIAGNOSTICS_LINES: 200,
    # cross-task skew / straggler detection (observability/skew.py)
    K.STRAGGLER_ENABLED: True,
    K.STRAGGLER_THRESHOLD_PCT: 50,
    K.STRAGGLER_WINDOWS: 3,
    K.STRAGGLER_WINDOW_MS: 15_000,
    K.STRAGGLER_SKETCH_BUCKETS: 96,
    K.STRAGGLER_HEATMAP_WINDOWS: 32,
    K.STRAGGLER_MIN_TASKS: 3,
    K.STRAGGLER_RELAUNCH_AFTER_WINDOWS: 0,   # 0 = detect only
    # alerting engine (observability/alerts.py)
    K.ALERTS_ENABLED: True,
    K.ALERTS_FOR_MS: 10_000,
    K.ALERTS_FLAP_SUPPRESS_MS: 60_000,
    K.ALERTS_LOG_MAX_ENTRIES: 256,
    K.ALERTS_WEBHOOK_TIMEOUT_MS: 2000,
    K.ALERTS_WEBHOOK_RETRIES: 2,
    K.ALERTS_FAST_WINDOW_MS: 300_000,     # 5 min
    K.ALERTS_SLOW_WINDOW_MS: 3_600_000,   # 1 h
    K.ALERTS_BURN_RATE_FACTOR: 14.0,      # classic fast-burn page factor
    K.ALERTS_TTFT_P95_SLO_MS: 0,          # 0 = rule disabled
    K.ALERTS_QUEUE_DEPTH_SLO: 0,          # 0 = rule disabled
    K.ALERTS_REJECT_RATE_BUDGET_PCT: 0.0,  # 0 = rule disabled
    K.ALERTS_STEP_REGRESSION_PCT: 0,      # 0 = inherit tony.slo.*
    K.ALERTS_GOODPUT_FLOOR_PCT: 0,        # 0 = inherit tony.slo.*
    K.ALERTS_MFU_FLOOR_PCT: 0,            # 0 = rule disabled
    K.ALERTS_QUEUE_QUOTA_PCT: 95,
    K.ALERTS_IDLE_CHIPS_FOR_MS: 120_000,
    # admission arbiter (cluster/arbiter.py)
    K.ARBITER_TOTAL_TPUS: 0,          # 0 = sum of declared queue quotas
    K.ARBITER_GRACE_MS: 30_000,
    K.ARBITER_PREEMPTION_ENABLED: True,

    # elastic gang resize (cluster/elastic.py)
    K.ELASTIC_ENABLED: False,
    K.ELASTIC_MIN_WIDTH: 1,
    K.ELASTIC_MAX_WIDTH: 0,           # 0 = unbounded
    K.ELASTIC_COOLDOWN_MS: 60_000,
    K.ELASTIC_QUIESCE_GRACE_MS: 30_000,
    # fleet registry / chip-hour accounting (observability/fleet.py)
    K.FLEET_PUBLISH_INTERVAL_MS: 5000,
    K.FLEET_STALE_AFTER_MS: 30_000,
    K.FLEET_HISTORY_JOBS: 200,

    # portal
    K.PORTAL_PORT: 19886,
    K.PORTAL_CACHE_MAX_ENTRIES: 1000,

    # serving (serve/ subsystem knobs; read by python -m tony_tpu_torch.serve)
    K.SERVING_SLOTS: 4,
    K.SERVING_TOKEN_BUDGET: 2048,
    K.SERVING_QUEUE_DEPTH: 64,
    K.SERVING_PORT: 0,           # 0 = executor-assigned $SERVING_PORT
    K.SERVING_ROLE: "both",      # "both" | "prefill" | "decode"
    K.SERVING_MIGRATE_TO: "",    # "" = discover decode endpoints via AM
    # paged prefix-shared KV cache (serve/kvcache.py)
    K.SERVING_KV_PREFIX_SHARING: False,
    K.SERVING_KV_PAGE_SIZE: 16,
    K.SERVING_KV_PAGES: 0,       # 0 = auto-size from slots x budget
    # serving fleet router (serve/router.py)
    K.SERVING_FLEET_ROUTER_PORT: 0,           # 0 = ephemeral
    K.SERVING_FLEET_PROBE_TTL_MS: 500,
    K.SERVING_FLEET_PROBE_TIMEOUT_MS: 1000,
    K.SERVING_FLEET_SPILLOVER_RETRIES: 2,
    K.SERVING_FLEET_DEAD_AFTER_FAILURES: 2,
    # must fit inside tony.task.term-grace-ms (15 s default) so the
    # executor's KILL never lands before the drain finishes
    K.SERVING_FLEET_DRAIN_TIMEOUT_MS: 10_000,
    # request-scoped tracing (observability/reqtrace.py); on by default —
    # the unsampled fast path is an in-process append dropped at
    # completion, so the steady-state cost is noise
    K.SERVING_TRACE_ENABLED: True,
    K.SERVING_TRACE_SLOW_THRESHOLD_MS: 1000,
    K.SERVING_TRACE_SLOWEST_K: 8,
    K.SERVING_TRACE_WINDOW_MS: 60_000,
    K.SERVING_TRACE_MAX_TRACES: 256,
    # serving autoscaler (serve/autoscaler.py); opt-in
    K.AUTOSCALER_ENABLED: False,
    K.AUTOSCALER_MIN_REPLICAS: 1,
    K.AUTOSCALER_MAX_REPLICAS: 4,
    K.AUTOSCALER_TTFT_P95_UP_MS: 0,           # 0 = signal disabled
    K.AUTOSCALER_QUEUE_DEPTH_UP: 8,
    K.AUTOSCALER_REJECT_RATE_UP_PCT: 1.0,
    K.AUTOSCALER_ITL_P50_UP_MS: 0,            # 0 = signal disabled
    K.AUTOSCALER_OCCUPANCY_DOWN_PCT: 30,
    K.AUTOSCALER_HYSTERESIS_PASSES: 3,
    K.AUTOSCALER_COOLDOWN_MS: 60_000,

    # docker
    K.DOCKER_ENABLED: False,

    # tpu
    K.TPU_NUM_SLICES: 1,
    K.TPU_COORDINATOR_PORT: 0,   # 0 = pick ephemeral

    # cluster backend
    K.CLUSTER_BACKEND: "local",
    K.CLUSTER_WORKDIR: "",       # "" = tempdir
    K.CLUSTER_NODE_TRANSPORT: "ssh",
    K.CLUSTER_NODE_ROOT: "",     # "" = /tmp/tony_tpu/<app_id> on each node
    K.STAGING_LOCATION: "",      # "" = <app_dir>/staging (shared filesystem)

    # warm executor pool (cluster/warmpool.py); opt-in
    K.WARMPOOL_ENABLED: False,
    K.WARMPOOL_SIZE: 4,
    K.WARMPOOL_TTL_MS: 300_000,

    # content-addressed localization cache (utils/localization.py); opt-in
    K.LOCALIZATION_CACHE_ENABLED: False,
    K.LOCALIZATION_CACHE_DIR: "",   # "" = <tmp>/tony_loc_cache

    # persistent XLA compile cache dir rendered into user envs; "" = off
    K.EXECUTOR_JAX_CACHE_DIR: "",

    # misc
    K.PYTHON_BINARY_PATH: "",
}
