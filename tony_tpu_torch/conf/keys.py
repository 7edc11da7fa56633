"""Configuration key names + dynamic per-jobtype key builders.

The port's copy of `tony_tpu/conf/keys.py`: the same names and values.

Equivalent of the reference's TonyConfigurationKeys.java
(tony-core/src/main/java/com/linkedin/tony/TonyConfigurationKeys.java).
Static keys live here; their defaults live in `tony_tpu_torch.conf.defaults`.
Dynamic keys follow the reference's `tony.<jobtype>.<attr>` scheme
(TonyConfigurationKeys.java:171-239) with `tpus` added as a first-class
resource type per the TPU re-target.
"""

import re

TONY_PREFIX = "tony."

# --- application ---------------------------------------------------------
APPLICATION_NAME = "tony.application.name"
APPLICATION_NODE_LABEL = "tony.application.node-label"
APPLICATION_QUEUE = "tony.application.queue"
APPLICATION_TIMEOUT = "tony.application.timeout"          # ms; 0 = none
APPLICATION_SECURITY_ENABLED = "tony.application.security.enabled"
APPLICATION_FRAMEWORK = "tony.application.framework"      # tensorflow|pytorch|mxnet|horovod|jax
APPLICATION_SINGLE_NODE = "tony.application.single-node"  # run everything on the AM
APPLICATION_ENABLE_PREPROCESS = "tony.application.enable-preprocess"
APPLICATION_PREPARE_STAGE = "tony.application.prepare-stage"
APPLICATION_TRAINING_STAGE = "tony.application.training-stage"
APPLICATION_UNTRACKED_JOBTYPES = "tony.application.untracked.jobtypes"
APPLICATION_STOP_ON_FAILURE_JOBTYPES = "tony.application.stop-on-failure.jobtypes"
APPLICATION_FAIL_ON_WORKER_FAILURE = "tony.application.fail-on-worker-failure-enabled"
APPLICATION_HDFS_CONF_LOCATION = "tony.application.hdfs-conf-path"
APPLICATION_YARN_CONF_LOCATION = "tony.application.yarn-conf-path"
# arbitration priority (higher wins): the admission arbiter
# (cluster/arbiter.py) admits higher-priority gangs first and selects
# preemption victims lowest-priority-first
APPLICATION_PRIORITY = "tony.application.priority"
# checkpoint-then-evict resume lineage: a re-admitted application names
# the PREEMPTED application it continues (`resumed-from`) and the epoch
# millis its predecessor was evicted at (`preempted-at-ms`) — the AM
# emits a RESUMED history event and prices the downtime gap into the
# goodput ledger (preemption_downtime_s). `preempt-count` carries the
# lineage's cumulative preemption count into tony_job_preemptions_total.
APPLICATION_RESUMED_FROM = "tony.application.resumed-from"
APPLICATION_PREEMPTED_AT_MS = "tony.application.preempted-at-ms"
APPLICATION_PREEMPT_COUNT = "tony.application.preempt-count"

# --- am ------------------------------------------------------------------
AM_RETRY_COUNT = "tony.am.retry-count"
# capped jittered exponential backoff between whole-session retries
# (attempt N waits in [cap/2, cap], cap = min(max, base * 2^(N-1)); 0 = none)
AM_RETRY_BACKOFF_BASE_MS = "tony.am.retry-backoff-base-ms"
AM_RETRY_BACKOFF_MAX_MS = "tony.am.retry-backoff-max-ms"
AM_MEMORY = "tony.am.memory"
AM_VCORES = "tony.am.vcores"
AM_GANG_MAX_WAIT_MS = "tony.am.gang-allocation-timeout-ms"
AM_MONITOR_INTERVAL_MS = "tony.am.monitor-interval-ms"
AM_STOP_POLL_TIMEOUT_MS = "tony.am.stop-poll-timeout-ms"
# control-plane sizing (both width-aware when 0 = auto): gRPC handler
# threads serving the cluster/metrics RPCs — auto is min(64, width//16+16)
# so 1 s heartbeats from a 1k gang never queue behind a fixed 16-thread
# pool — and the number of liveliness shards (per-shard locks, the sweep
# examines one shard per tick) — auto is min(16, width//64)
AM_RPC_WORKERS = "tony.am.rpc-workers"
AM_LIVELINESS_SHARDS = "tony.am.liveliness-shards"
# AM crash survivability (am/journal.py + am/supervisor.py): total AM
# PROCESS attempts (first launch + supervised relaunches). > 1 makes the
# client spawn the supervisor, which relaunches a crashed AM with the
# session-retry jittered backoff; each new attempt replays the
# control-plane journal and adopts the still-running gang. 1 = today's
# single-process behavior (an AM crash fails the application).
AM_MAX_ATTEMPTS = "tony.am.max-attempts"
# how long an orphaned executor (heartbeat budget exhausted, user process
# untouched) polls the app dir for a new AM address before gracefully
# self-fencing through the TERM→emergency-checkpoint→KILL ladder
AM_ORPHAN_GRACE_MS = "tony.am.orphan-grace-ms"
# write-ahead journal of control-plane state (registrations/attempts/
# generations, endpoints, preemption/resize in-flight state, downtime
# clocks) in the app dir — the replay source for a recovering AM attempt
AM_JOURNAL_ENABLED = "tony.am.journal-enabled"
# incremental records appended before the journal is compacted into a
# tmp+rename snapshot (bounds replay length and journal file size)
AM_JOURNAL_SNAPSHOT_EVERY = "tony.am.journal-snapshot-every"
# adoption barrier: how long a RECOVERING AM waits for every journaled
# live task to re-register before declaring the rest lost (and spending
# relaunch budget on them)
AM_RECOVERY_SETTLE_MS = "tony.am.recovery-settle-ms"

# --- task / containers ---------------------------------------------------
# default task command when no per-jobtype tony.<jobtype>.command is set
# (the CLI's positional task command lands here; registered late — it
# rode as a bare literal in client/AM until tonylint's
# config-key-registry rule flushed it out)
TASK_COMMAND = "tony.task.command"
TASK_HEARTBEAT_INTERVAL_MS = "tony.task.heartbeat-interval-ms"
TASK_MAX_MISSED_HEARTBEATS = "tony.task.max-missed-heartbeats"
# consecutive failed heartbeats before an executor stops trusting its AM
# address (the reference's hard-coded MAX_CONSECUTIVE_FAILED_HEARTBEATS=5,
# TaskExecutor.java:36). Exhaustion no longer os._exit()s: the executor
# enters ORPHAN mode — user process untouched — and polls for a
# recovering AM within tony.am.orphan-grace-ms before self-fencing
# through the TERM→emergency-checkpoint→KILL ladder.
TASK_HB_FAILURE_BUDGET = "tony.task.hb-failure-budget"
# task-attempt budget: total attempts (first run + relaunches) a tracked
# task slot gets before its failure fails the session; 1 = no relaunch
# (today's all-or-nothing behavior). Per-jobtype override:
# tony.<jobtype>.max-task-attempts.
TASK_MAX_TASK_ATTEMPTS = "tony.task.max-task-attempts"
# app-wide circuit breaker: once MORE than this many tracked-task failures
# have occurred (across all attempts and sessions), stop relaunching tasks
# and fail the session instead; -1 = unlimited
APPLICATION_MAX_TOTAL_TASK_FAILURES = "tony.application.max-total-task-failures"
TASK_METRICS_INTERVAL_MS = "tony.task.metrics-interval-ms"
# consecutive ~0%-duty metric updates before a heartbeating task is
# flagged as wedged (AM MetricsStore; 24 x 5s default = 2 min)
TASK_LOW_UTIL_INTERVALS = "tony.task.low-utilization-intervals"
# GPU sampling for `gpus` jobtypes (reference:
# TonyConfigurationKeys.java:152,273-274 + GpuDiscoverer.java:43-209)
TASK_GPU_METRICS_ENABLED = "tony.task.gpu-metrics.enabled"
GPU_PATH_TO_EXEC = "tony.gpu-exec-path"
TASK_EXECUTOR_JVM_OPTS = "tony.task.executor.jvm.opts"    # kept for parity; unused
CONTAINER_ALLOCATION_TIMEOUT = "tony.container.allocation.timeout"  # ms
CONTAINERS_RESOURCES = "tony.containers.resources"        # multi-value append key
TASK_REGISTRATION_TIMEOUT_SEC = "tony.task.registration-timeout-sec"
TASK_REGISTRATION_RETRY_COUNT = "tony.task.registration-retry-count"
# TERM→KILL grace window (ms) the executor gives its user process group
# on any termination path — graceful drain (preemption), backend
# container stop, SIGTERM from the substrate. Sized to cover the
# trainer's emergency checkpoint (AsyncCheckpointer.wait + one
# synchronous save); the wait returns the moment the process exits, so
# a clean shutdown never sleeps the full window.
TASK_TERM_GRACE_MS = "tony.task.term-grace-ms"
# checkpoint retention: committed step_N dirs kept per checkpoint dir
# (pruned oldest-first after each successful commit, on both the
# local-rename and the gs:// COMMIT-marker protocols; the step a restore
# resumed from is never deleted). 0 = keep everything.
CHECKPOINT_KEEP = "tony.checkpoint.keep"

# --- limits (reference: TonyClient.validateTonyConf, TonyClient.java:598-667)
MAX_TOTAL_INSTANCES = "tony.application.max-total-instances"
MAX_TOTAL_RESOURCES_PREFIX = "tony.application.max-total-"  # e.g. ...max-total-tpus
MAX_TOTAL_TPUS = "tony.application.max-total-tpus"
MAX_TOTAL_GPUS = "tony.application.max-total-gpus"

# --- history / events ----------------------------------------------------
HISTORY_LOCATION = "tony.history.location"
HISTORY_INTERMEDIATE = "tony.history.intermediate"
HISTORY_FINISHED = "tony.history.finished"
HISTORY_RETENTION_SEC = "tony.history.retention-sec"
HISTORY_MOVER_INTERVAL_MS = "tony.history.mover-interval-ms"
HISTORY_PURGER_INTERVAL_MS = "tony.history.purger-interval-ms"
# inprogress files older than this are finalized as KILLED by the mover
HISTORY_STALE_INPROGRESS_SEC = "tony.history.stale-inprogress-sec"
# per-stream tail cap for aggregated container logs (memory syntax: 10m, 1g)
HISTORY_LOG_MAX_SIZE = "tony.history.log-max-size"
KEYTAB_USER = "tony.keytab.user"
KEYTAB_LOCATION = "tony.keytab.location"

# --- portal --------------------------------------------------------------
PORTAL_URL = "tony.portal.url"
PORTAL_PORT = "tony.portal.port"
PORTAL_CACHE_MAX_ENTRIES = "tony.portal.cache-max-entries"
# bearer token file gating every portal route (the reference
# sat behind YARN/Play auth filters; here the portal requires this token
# in Authorization: Bearer or ?token= when configured)
PORTAL_TOKEN_FILE = "tony.portal.token-file"
# file of `user=token` lines: named per-user credentials whose job
# visibility is scoped to that user's own jobs (the shared token-file
# credential above stays the all-seeing admin). Multi-tenant identity in
# place of the reference's Kerberos + service ACLs
# (TonyPolicyProvider.java:23)
PORTAL_USER_TOKENS_FILE = "tony.portal.user-tokens-file"
# staging-store location the portal pulls finished history from (AMs on
# other hosts publish jhist there; the reference's HDFS history dir)
HISTORY_STORE_LOCATION = "tony.history.store-location"

# --- serving (new: online inference jobtype, serve/ subsystem) -----------
# `serving` is a REGULAR jobtype (declared via tony.serving.instances like
# any other — deliberately NOT a reserved segment); these static keys are
# the engine/frontend knobs its default command (python -m tony_tpu_torch.serve)
# reads from the frozen conf.
SERVING_SLOTS = "tony.serving.slots"              # concurrent decode slots
# per-slot prompt+generation budget (the static cache length; capped at
# the model's max_seq at startup)
SERVING_TOKEN_BUDGET = "tony.serving.token-budget"
# bounded pending-request queue; a full queue answers HTTP 429
SERVING_QUEUE_DEPTH = "tony.serving.queue-depth"
# explicit HTTP port; 0 = the executor-assigned rendezvous port
# ($SERVING_PORT), so the cluster-spec entry is the live endpoint
SERVING_PORT = "tony.serving.port"
# disaggregated serving role: "both" (default, monolithic replica),
# "prefill" (admission-heavy; hands decode off over /v1/migrate), or
# "decode" (accepts /v1/migrate installs; excluded from /v1/generate
# routing). Overridable per replica via $TONY_SERVING_ROLE.
SERVING_ROLE = "tony.serving.role"
# decode-replica base URLs (comma-separated) a prefill replica migrates
# to; empty = discover decode-role endpoints from the AM endpoint set
SERVING_MIGRATE_TO = "tony.serving.migrate-to"

# --- serving paged KV cache (serve/kvcache.py): prefix sharing ----------
# master switch: paged prefix-shared admission (OFF keeps the admission
# path byte-identical to the pre-paging engine)
SERVING_KV_PREFIX_SHARING = "tony.serving.kv.prefix-sharing"
# tokens per KV page (the prefix-match granularity; capped at the token
# budget)
SERVING_KV_PAGE_SIZE = "tony.serving.kv.page-size"
# device page-pool size incl. the reserved scratch page; 0 = auto
# (1 + n_slots * token_budget / page_size — every slot can seal fully)
SERVING_KV_PAGES = "tony.serving.kv.pages"

# --- serving fleet (serve/router.py): one front door over N replicas ----
# router HTTP port (0 = ephemeral); the router spreads /v1/generate
# least-loaded across the endpoints registered via
# register_serving_endpoint, with 429 spill-over and connection draining
SERVING_FLEET_ROUTER_PORT = "tony.serving.fleet.router-port"
# TTL on the router's cached per-replica /v1/load probes: within the
# TTL, routing a request costs ZERO extra RPCs
SERVING_FLEET_PROBE_TTL_MS = "tony.serving.fleet.probe-ttl-ms"
# per-probe timeout (also the deadness-detection latency floor)
SERVING_FLEET_PROBE_TIMEOUT_MS = "tony.serving.fleet.probe-timeout-ms"
# additional replicas tried when the least-loaded pick answers 429/5xx
# or is unreachable, before the client sees the failure
SERVING_FLEET_SPILLOVER_RETRIES = "tony.serving.fleet.spillover-retries"
# consecutive probe/send failures before a replica is marked DOWN and
# evicted from routing (it re-admits on the first successful probe)
SERVING_FLEET_DEAD_AFTER_FAILURES = \
    "tony.serving.fleet.dead-after-failures"
# bound on the in-flight drain a SIGTERMed serving replica waits out
# before stopping (connection-draining contract; must fit inside
# tony.task.term-grace-ms or the executor's KILL cuts streams mid-token)
SERVING_FLEET_DRAIN_TIMEOUT_MS = "tony.serving.fleet.drain-timeout-ms"

# --- serving request tracing (observability/reqtrace.py) ----------------
# master switch for request-scoped tracing: the X-Tony-Trace context
# minted at the router (or adopted from the client) and carried through
# admission, engine phases, and /v1/migrate into the decode replica
SERVING_TRACE_ENABLED = "tony.serving.trace.enabled"
# tail-sampling slow gate: completed traces at or above this duration
# compete for the slowest-k slots per window (errors, 429 spills, and
# migrated requests are kept unconditionally)
SERVING_TRACE_SLOW_THRESHOLD_MS = "tony.serving.trace.slow-threshold-ms"
# slowest-k per sampling window kept above the slow threshold
SERVING_TRACE_SLOWEST_K = "tony.serving.trace.slowest-k"
# the rolling sampling window the slowest-k competition runs over
SERVING_TRACE_WINDOW_MS = "tony.serving.trace.window-ms"
# bound on sampled traces buffered per process (pull-exported via
# /v1/traces and drained into history); overflow drops oldest, counted
SERVING_TRACE_MAX_TRACES = "tony.serving.trace.max-traces"

# --- autoscaler (serve/autoscaler.py): SLI-driven replica scaling -------
# master switch: the AM evaluates the serving-fleet autoscaler on its
# monitor cadence when the application carries a serving jobtype
AUTOSCALER_ENABLED = "tony.autoscaler.enabled"
# replica-count bounds the autoscaler may move within
AUTOSCALER_MIN_REPLICAS = "tony.autoscaler.min-replicas"
AUTOSCALER_MAX_REPLICAS = "tony.autoscaler.max-replicas"
# scale-up signals (0 disables a signal): fleet TTFT p95 ceiling,
# per-replica engine queue-depth ceiling, windowed 429 reject-rate
# budget — the same SLIs the burn-rate alert rules watch
AUTOSCALER_TTFT_P95_UP_MS = "tony.autoscaler.ttft-p95-up-ms"
AUTOSCALER_QUEUE_DEPTH_UP = "tony.autoscaler.queue-depth-up"
AUTOSCALER_REJECT_RATE_UP_PCT = "tony.autoscaler.reject-rate-up-pct"
# decode-pool up-signal for role-split (prefill/decode) fleets: fleet
# ITL p50 ceiling in ms (0 disables). With roles present, TTFT burn
# asks for prefill replicas while ITL/occupancy asks for decode ones.
AUTOSCALER_ITL_P50_UP_MS = "tony.autoscaler.itl-p50-up-ms"
# scale-down signal: mean slot occupancy below this (with an empty
# queue and zero rejects) marks the fleet oversized
AUTOSCALER_OCCUPANCY_DOWN_PCT = "tony.autoscaler.occupancy-down-pct"
# hysteresis: a signal must hold for this many consecutive monitor
# passes before any action — one slow request never scales the fleet
AUTOSCALER_HYSTERESIS_PASSES = "tony.autoscaler.hysteresis-passes"
# cooldown after any executed action: no second action within this
# window, so scale-up/scale-down can never flap against each other
AUTOSCALER_COOLDOWN_MS = "tony.autoscaler.cooldown-ms"

# --- observability (observability/ subsystem) ----------------------------
# per-gauge timeseries ring buffer in the AM's MetricsStore: max points
# kept per (task, metric); on overflow the buffer compacts (drops every
# other point, doubling its stride) so memory stays capped while the
# series still covers the whole run
METRICS_HISTORY_POINTS = "tony.metrics.history-points"
# AM Prometheus /metrics HTTP endpoint: 0 = ephemeral port (written to
# the app dir's am-metrics-port file), -1 = disabled
METRICS_PORT = "tony.metrics.port"
# lifecycle span recording (trace_id = app_id) across client/AM/
# executor/trainer; spans land in history next to the event log and
# render as the portal job page's waterfall
TRACE_ENABLED = "tony.trace.enabled"
# cap on spans held by the AM's SpanStore (and per-process recorders);
# overflow is counted, never grown
TRACE_MAX_SPANS = "tony.trace.max-spans"
# goodput ledger (observability/perf.py): AM-side aggregation of per-task
# phase accounting into goodput.json + job-level Prometheus gauges
GOODPUT_ENABLED = "tony.goodput.enabled"
# on-demand profiler capture (request_profile RPC / CLI verb / portal
# POST): master switch + trace length when the request doesn't name one
PROFILING_ENABLED = "tony.profiling.enabled"
PROFILING_DEFAULT_STEPS = "tony.profiling.default-steps"
# always-on control-plane profiler + stall watchdog
# (observability/profiler.py): a daemon sampler walking
# sys._current_frames() in EVERY long-running process (AM, executor,
# portal, serve replica, router), folding samples into a bounded
# collapsed-stack table exported as profile.folded / get_profile /
# /api/jobs/:id/flame, plus the beacon watchdog that turns a wedged
# daemon loop into a PROCESS_STALL_DETECTED event with the blocking
# frame as evidence
PROFILER_ENABLED = "tony.profiler.enabled"
# sampling cadence; deliberately prime-ish and jittered +/-25% so the
# sampler never phase-locks with the 1 s/5 s control-plane loops
PROFILER_HZ = "tony.profiler.hz"
# bound on distinct collapsed stacks retained (overflow folds into an
# "(other)" bucket and is disclosed as dropped_samples)
PROFILER_MAX_STACKS = "tony.profiler.max-stacks"
# a progress beacon stale past this factor x its registered cadence is
# a stall: all-thread capture + latched event pair + tony_stalls_total
PROFILER_STALL_FACTOR = "tony.profiler.stall-factor"
# hard self-overhead ceiling (percent of wall time spent sampling);
# past it the profiler throttles its own cadence rather than blow it
PROFILER_OVERHEAD_BUDGET_PCT = "tony.profiler.overhead-budget-pct"
# SLO watchdog (AM monitor loop): WARNING history events + alert gauges
# when a task's step time regresses past this percentage over its own
# baseline, or job goodput falls below this floor; 0 disables either check
SLO_STEP_TIME_REGRESSION_PCT = "tony.slo.step-time-regression-pct"
SLO_GOODPUT_FLOOR_PCT = "tony.slo.goodput-floor-pct"
# live log streaming + failure diagnostics (observability/logs.py):
# how far back a fresh tail cursor starts into a stream file (bytes) —
# the "ring buffer" bound on what a live tail can ever replay
LOGS_TAIL_BYTES = "tony.logs.tail-bytes"
# hard per-chunk cap on read_task_logs / read_log responses (bytes);
# clients may ask for less, never get more
LOGS_CHUNK_BYTES = "tony.logs.chunk-bytes"
# CLI/portal --follow polling cadence between chunk reads
LOGS_FOLLOW_POLL_MS = "tony.logs.follow-poll-ms"
# redacted last-lines budget per failing task in failure reports and the
# job's diagnostics.json bundle
LOGS_DIAGNOSTICS_LINES = "tony.logs.diagnostics-lines"
# cross-task skew analytics + straggler detection (observability/skew.py):
# master switch for the AM-side windowed sketches, analyzer pass, skew
# gauges, and the skew.json / get_skew surfaces
STRAGGLER_ENABLED = "tony.straggler.enabled"
# a task whose windowed step-time/stall mean exceeds the gang median by
# more than this percentage counts as lagging in that window
STRAGGLER_THRESHOLD_PCT = "tony.straggler.threshold-pct"
# consecutive lagging windows before STRAGGLER_DETECTED latches (and
# consecutive healthy windows before the latch clears)
STRAGGLER_WINDOWS = "tony.straggler.windows"
# length of one analysis window (per-task means + one gang sketch per
# signal are folded per window; the analyzer runs when a window closes)
STRAGGLER_WINDOW_MS = "tony.straggler.window-ms"
# fixed bucket count of the gang distribution sketch — the O(buckets)
# memory bound that replaces O(width x points) trajectories at width 1k
STRAGGLER_SKETCH_BUCKETS = "tony.straggler.sketch-buckets"
# closed windows retained for the tasks x windows step-time heatmap
STRAGGLER_HEATMAP_WINDOWS = "tony.straggler.heatmap-windows"
# minimum reporting tasks before any skew verdict (a gang of two has no
# meaningful median)
STRAGGLER_MIN_TASKS = "tony.straggler.min-tasks"
# opt-in remediation: a steady-state straggler still lagging after this
# many consecutive windows is routed through the task-attempt relaunch
# machinery (attempt-fenced, budget-counted); 0 = detect only
STRAGGLER_RELAUNCH_AFTER_WINDOWS = "tony.straggler.relaunch-after-windows"
# alerting engine (observability/alerts.py): declarative rules evaluated
# on the AM monitor cadence (and the portal's fleet-scan cadence for
# fleet-scope rules) over the EXISTING metric trajectories / goodput
# ledger / fleet registry — no new collection, zero hot-loop work.
ALERTS_ENABLED = "tony.alerts.enabled"
# custom rules (multi-value, appended across conf layers). Spec grammar:
#   <rule-id>:<METRIC><op><threshold>[:for=<dur>][:severity=<sev>]
#   [:scope=task|job]
# e.g. "hbm.high:TPU_MEMORY_USAGE_PCT>95:for=30s:severity=critical"
ALERTS_RULES = "tony.alerts.rules"
# default pending duration: a rule's condition must hold this long
# before pending escalates to firing (per-rule `for=` overrides)
ALERTS_FOR_MS = "tony.alerts.for-ms"
# a resolved alert that re-fires within this window is a flap: the
# transition still latches and lands in the alert log, but sinks and
# history events are suppressed until the signal stabilizes
ALERTS_FLAP_SUPPRESS_MS = "tony.alerts.flap-suppress-ms"
# bound on retained alert-transition log entries (alerts.json `log`)
ALERTS_LOG_MAX_ENTRIES = "tony.alerts.log-max-entries"
# delivery sinks: webhook POST (bounded retry on a daemon worker — the
# monitor thread never blocks on delivery) and an append-only JSON-lines
# file; every outbound payload passes through logs.redact()
ALERTS_WEBHOOK_URL = "tony.alerts.webhook-url"
ALERTS_WEBHOOK_TIMEOUT_MS = "tony.alerts.webhook-timeout-ms"
ALERTS_WEBHOOK_RETRIES = "tony.alerts.webhook-retries"
ALERTS_FILE_SINK = "tony.alerts.file"
# multi-window burn-rate evaluation (serving SLO rules): both the fast
# and the slow trailing window must burn the error budget at >= this
# factor for the rule to fire — fast catches the page-worthy cliff,
# slow filters the blip
ALERTS_FAST_WINDOW_MS = "tony.alerts.fast-window-ms"
ALERTS_SLOW_WINDOW_MS = "tony.alerts.slow-window-ms"
ALERTS_BURN_RATE_FACTOR = "tony.alerts.burn-rate-factor"
# serving SLO thresholds (0 disables the respective built-in rule):
# TTFT p95 ceiling (ms), engine queue-depth ceiling, and the 429/reject
# error budget in percent of submitted requests
ALERTS_TTFT_P95_SLO_MS = "tony.alerts.ttft-p95-slo-ms"
ALERTS_QUEUE_DEPTH_SLO = "tony.alerts.queue-depth-slo"
ALERTS_REJECT_RATE_BUDGET_PCT = "tony.alerts.reject-rate-budget-pct"
# training SLO thresholds; 0 falls back to the legacy tony.slo.* keys
# (the engine's rules subsume the SloWatchdog's checks)
ALERTS_STEP_REGRESSION_PCT = "tony.alerts.step-regression-pct"
ALERTS_GOODPUT_FLOOR_PCT = "tony.alerts.goodput-floor-pct"
ALERTS_MFU_FLOOR_PCT = "tony.alerts.mfu-floor-pct"
# fleet-scope rules (evaluated by the portal's FleetView refresh):
# queue-quota saturation percentage, and how long a RUNNING job may sit
# with zero allocated chips (while its queue has headroom) before the
# chips-idle-while-queued rule fires
ALERTS_QUEUE_QUOTA_PCT = "tony.alerts.queue-quota-saturation-pct"
ALERTS_IDLE_CHIPS_FOR_MS = "tony.alerts.idle-chips-for-ms"
# fleet layer (observability/fleet.py): cross-job registry + chip-hour
# accounting over the staging store. With a staging location configured,
# each AM republishes its heartbeat-stamped jobstate.json summary at
# this cadence (the live registry has no new RPC surface — it's files)
FLEET_PUBLISH_INTERVAL_MS = "tony.fleet.publish-interval-ms"
# a RUNNING registry entry whose heartbeat stamp is older than this is
# demoted to LOST (its AM died without publishing a terminal state);
# LOST jobs still fold into the chip-hour accounting at their last
# known extent
FLEET_STALE_AFTER_MS = "tony.fleet.stale-after-ms"
# bound on jobs held by the registry / per-job accounting entries / the
# portal index table; evicted ledger entries fold into the per-queue and
# per-user running totals so chip-hours are never lost, only coarsened
FLEET_HISTORY_JOBS = "tony.fleet.history-jobs"

# --- arbiter (cluster/arbiter.py): gang-aware admission + preemption -----
# modeled TPU inventory the arbiter admits gangs against (chips); 0 =
# derive from the summed declared queue quotas
ARBITER_TOTAL_TPUS = "tony.arbiter.total-tpus"
# drain window handed to a preemption victim's AM when the arbiter (or
# `cli preempt`) doesn't name one: the victim's tasks get this long to
# emergency-checkpoint before containers are force-stopped
ARBITER_GRACE_MS = "tony.arbiter.grace-ms"
# safety valve: when false, decide() never returns preemption victims —
# asks that don't fit whole simply queue (admission stays gang-atomic)
ARBITER_PREEMPTION_ENABLED = "tony.arbiter.preemption-enabled"

# --- elastic gang resize (cluster/elastic.py) ----------------------------
# master switch: this application's training gang may be grown/shrunk in
# place (quiesce → in-place checkpoint → re-render the cluster spec at
# the new width behind a generation bump → reshard-restore → resume)
# by the arbiter, an operator (`cli resize`), or a reclaim-instead-of-
# evict verdict. Off (the default), request_resize answers an error and
# the arbiter never selects this job for a reclaim.
ELASTIC_ENABLED = "tony.elastic.enabled"
# the narrowest gang width (task instances of the elastic jobtype) a
# reclaim/shrink may drain this job down to — the job's floor in the
# arbiter's reclaim-instead-of-evict victim selection
ELASTIC_MIN_WIDTH = "tony.elastic.min-width"
# the widest gang width a grow/offer may reach; 0 = unbounded
ELASTIC_MAX_WIDTH = "tony.elastic.max-width"
# minimum gap between two ARBITER-triggered resizes (offer/reclaim);
# operator request_resize asks are exempt — a human override must never
# be refused because an automatic resize just happened
ELASTIC_COOLDOWN_MS = "tony.elastic.cooldown-ms"
# quiesce window: how long the gang gets to stop its user processes and
# commit the in-place emergency checkpoint before the resize is
# abandoned (survivors self-heal back to the old width; the application
# never fails over a resize)
ELASTIC_QUIESCE_GRACE_MS = "tony.elastic.quiesce-grace-ms"

# --- proxy ---------------------------------------------------------------
# externally reachable base URL of an authenticated tony_tpu.proxy fronting
# in-cluster HTTP endpoints (serving, notebook, TB). When set, the portal
# links endpoints through it instead of the raw in-cluster host:port.
PROXY_URL = "tony.proxy.url"

# --- docker (reference: TonyConfigurationKeys.java:227-239,266-268) ------
DOCKER_ENABLED = "tony.docker.enabled"
DOCKER_IMAGE = "tony.docker.containers.image"
DOCKER_MOUNTS = "tony.docker.containers.mounts"

# --- TPU (new) -----------------------------------------------------------
TPU_MESH_SHAPE = "tony.tpu.mesh-shape"   # e.g. "2,2" per-job requested mesh
TPU_MESH_AXES = "tony.tpu.mesh-axes"     # e.g. "dp,tp"
TPU_NUM_SLICES = "tony.tpu.num-slices"   # multi-slice (DCN) count
TPU_COORDINATOR_PORT = "tony.tpu.coordinator-port"

# --- cluster backend -----------------------------------------------------
CLUSTER_BACKEND = "tony.cluster.backend"      # "local" | "remote"
CLUSTER_WORKDIR = "tony.cluster.workdir"      # staging root for local backend
# remote backend (off-host executors — the YARN RM/NM role, ApplicationMaster
# .java:1002-1156): static node pool + per-container transport channel
# node spec grammar: "host[:slots][;label=X][;tpus=N][;gpus=N][;memory=16g]"
# — labels are YARN-exclusive partitions (request label must match exactly);
# declared capacities bound co-resident containers; undeclared = unlimited
CLUSTER_NODES = "tony.cluster.nodes"          # "host[:slots][;attr=val...],..."
CLUSTER_NODE_TRANSPORT = "tony.cluster.node-transport"  # "ssh" | "exec" (test)
CLUSTER_NODE_ROOT = "tony.cluster.node-root"  # node-side container workdir base
CLUSTER_SSH_OPTS = "tony.cluster.ssh-opts"    # extra ssh flags (spaces split)

# --- staging store (HDFS upload/localize equivalent, TonyClient.java:519-590)
STAGING_LOCATION = "tony.staging.location"    # ""=<app_dir>/staging | dir | gs://

# --- warm executor pool (cluster/warmpool.py) ----------------------------
# Pre-forked, pre-imported executor processes the local backend leases
# instead of cold-spawning: a lease re-binds the warm process to its
# container via a one-shot stdin spec (fresh task token, env,
# TONY_TRACE_ID — the same attempt fence a cold launch gets). A miss
# falls back to cold spawn; a crashed/poisoned warm proc is evicted,
# never reused.
WARMPOOL_ENABLED = "tony.warmpool.enabled"
WARMPOOL_SIZE = "tony.warmpool.size"          # idle warm procs kept ready
WARMPOOL_TTL_MS = "tony.warmpool.ttl-ms"      # idle proc retired past this age

# --- localization cache (utils/localization.py) --------------------------
# Content-addressed machine-wide resource cache: bytes fetched once per
# digest into cache-dir (atomic tmp+rename), then hardlinked/copied into
# each container dir — the Nth job (and every elastic-grow slot) skips
# the fetch.
LOCALIZATION_CACHE_ENABLED = "tony.localization.cache-enabled"
LOCALIZATION_CACHE_DIR = "tony.localization.cache-dir"  # ""=/tmp/tony_loc_cache

# --- executor-rendered user-env knobs ------------------------------------
# Persistent XLA compile cache dir rendered into every trainer/serving
# user env as $TONY_JAX_CACHE_DIR (train/trainer.py + serve honor it via
# utils/compilecache.py); "" disables. The Nth identical trainer skips
# its cold XLA compile.
EXECUTOR_JAX_CACHE_DIR = "tony.executor.jax-cache-dir"

# --- misc ----------------------------------------------------------------
SRC_DIR = "tony.srcdir"
PYTHON_VENV = "tony.python.venv"
PYTHON_BINARY_PATH = "tony.python.binary.path"
EXECUTION_ENV = "tony.execution.env"          # multi-value append key k=v pairs
APPLICATION_TAGS = "tony.application.tags"

# Keys whose values append across conf layers instead of replacing
# (reference: TonyConfigurationKeys.java:285-287 MULTI_VALUE_CONF).
MULTI_VALUE_CONF = frozenset({
    CONTAINERS_RESOURCES,
    EXECUTION_ENV,
    APPLICATION_UNTRACKED_JOBTYPES,
    ALERTS_RULES,
})

# --- dynamic per-jobtype keys -------------------------------------------
# reference: regex `tony\.([a-z]+)\.instances` (TonyConfigurationKeys.java:171)
JOBTYPE_INSTANCES_RE = re.compile(r"^tony\.([a-z][a-z0-9_\-]*)\.instances$")

# Attributes reserved as non-jobtype key segments (so tony.task.* etc. never
# parse as a jobtype called "task").
RESERVED_SEGMENTS = frozenset({
    "application", "am", "task", "containers", "container", "history",
    "portal", "docker", "tpu", "cluster", "keytab", "python", "srcdir",
    "execution", "other", "queues", "metrics", "trace", "goodput",
    "profiling", "profiler", "slo", "logs", "straggler", "fleet", "alerts",
    "arbiter", "checkpoint", "autoscaler", "elastic", "warmpool",
    "localization", "executor",
})


def queue_max_tpus_key(queue: str) -> str:
    """Cap on a SINGLE application's summed TPU ask when submitted into
    this queue (the capacity-scheduler slice the reference inherited
    from YARN queues, TonyClient.java:249-251 — aggregate cross-app
    capacity is enforced by the admission arbiter, cluster/arbiter.py)."""
    return f"tony.queues.{queue}.max-tpus"


def queue_capacity_share_key(queue: str) -> str:
    """Percentage of the arbiter's chip inventory this queue (or, for a
    child queue, of its parent's capacity) may hold across RUNNING
    applications — the capacity-scheduler share of the reference's YARN
    queue story, enforced cross-app by cluster/arbiter.py."""
    return f"tony.queues.{queue}.capacity-share"


def queue_max_tpus_per_user_key(queue: str) -> str:
    """Cap on one user's summed chips across RUNNING applications in
    this queue (arbiter-enforced per-user quota)."""
    return f"tony.queues.{queue}.max-tpus-per-user"


def queue_parent_key(queue: str) -> str:
    """Names this queue's parent, making tony.queues.* a hierarchy: a
    child's capacity-share is a slice of the parent's capacity, and its
    usage counts against every ancestor."""
    return f"tony.queues.{queue}.parent"


def jobtype_key(jobtype: str, attr: str) -> str:
    """Build `tony.<jobtype>.<attr>` (reference: TonyConfigurationKeys.java:178-239)."""
    return f"{TONY_PREFIX}{jobtype}.{attr}"


def instances_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "instances")


def max_instances_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "max-instances")


def memory_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "memory")


def vcores_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "vcores")


def gpus_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "gpus")


def tpus_key(jobtype: str) -> str:
    """New resource type: TPU chips per task (BASELINE north star: tony.worker.tpus)."""
    return jobtype_key(jobtype, "tpus")


def command_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "command")


def resources_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "resources")


def depends_on_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "depends-on")


def max_task_attempts_key(jobtype: str) -> str:
    """Per-jobtype override of tony.task.max-task-attempts."""
    return jobtype_key(jobtype, "max-task-attempts")


def node_label_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "node-label")


def docker_image_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "docker.image")
