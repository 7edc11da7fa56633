"""The control plane's gRPC services: the port's copy of
`tony_tpu/rpc/service.py`.

The AM serves `tony.ClusterService` and `tony.MetricsService`; every
executor serves `tony.TaskLogService`, the live-log and stack reads the AM
proxies to it. The methods are registered through grpc's generic handlers
with JSON payloads (`_ser`/`_deser`), so the names and the codec below are
the wire protocol, kept as they are: either package's AM talks to either
package's executor. Handlers are plain Python objects implementing the
abstract interfaces below. `grpc` is imported only when a server is built,
so a process that never serves (a trainer outside TonY) never loads it.
"""

from __future__ import annotations

import abc
import json
import time
from typing import Any, Optional

CLUSTER_SERVICE = "tony.ClusterService"
METRICS_SERVICE = "tony.MetricsService"
# Executor-hosted live-log service (observability/logs.py): the one RPC
# surface a container SERVES instead of calling. The AM proxies operator
# reads (CLI `logs --follow`, portal job page) to it; offset-cursor
# chunk reads keep both sides' memory bounded.
TASK_LOG_SERVICE = "tony.TaskLogService"

# The 7 methods of the reference's TensorFlowClusterService, same names
# modulo snake_case (proto/tensorflow_cluster_service_protos.proto:11-20),
# plus register_serving_endpoint (new: the serving jobtype announces its
# HTTP endpoint — the inference-side sibling of register_tensorboard_url).
CLUSTER_METHODS = (
    "get_task_infos",
    "get_cluster_spec",
    "register_worker_spec",
    "register_tensorboard_url",
    "register_serving_endpoint",
    "register_execution_result",
    "finish_application",
    "task_executor_heartbeat",
    "request_profile",
    "read_task_logs",
    "get_skew",
    "get_alerts",
    "request_preemption",
    "request_rolling_update",
    "request_resize",
    "report_serving_migrated",
    "get_profile",
)
METRICS_METHODS = ("update_metrics",)
TASK_LOG_METHODS = ("read_log", "read_stacks")


def auto_rpc_workers(width: int) -> int:
    """Width-aware default for tony.am.rpc-workers: the AM's handler pool
    must absorb `width` 1 s heartbeats plus metric pushes without queueing
    — a fixed 16-thread pool at width 1024 meant every ping waited behind
    63 others. min(64, width//16 + 16): small gangs keep the old 16-ish
    pool, width 1024 gets the full 64 (threads are parked in epoll when
    idle; past ~64 the GIL, not the pool, is the ceiling)."""
    return min(64, max(16, int(width) // 16 + 16))


def _ser(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


def _deser(data: bytes) -> Any:
    return json.loads(data.decode("utf-8")) if data else {}


class ClusterServiceHandler(abc.ABC):
    """AM-side implementation surface for the cluster control plane."""

    @abc.abstractmethod
    def get_task_infos(self, req: dict) -> list[dict]:
        """-> [TaskInfo dict] (reference: getTaskInfos)."""

    @abc.abstractmethod
    def get_cluster_spec(self, req: dict) -> dict:
        """req: {task_id} -> {"spec": json-str|None} (reference: getClusterSpec)."""

    @abc.abstractmethod
    def register_worker_spec(self, req: dict) -> dict:
        """req: {task_id, spec, session_id?, task_attempt?} ->
        {"spec": json-str|None, "generation": int?}. Returns None spec
        until ALL expected tasks have registered — the gang-rendezvous barrier
        (reference: ApplicationMaster.java:840-888). `generation` stamps
        which cluster-spec generation the returned spec belongs to; a task
        relaunch bumps it and invalidates the dead task's registration, so
        surviving executors re-enter this barrier."""

    @abc.abstractmethod
    def register_tensorboard_url(self, req: dict) -> dict:
        """req: {task_id, url} -> {}."""

    @abc.abstractmethod
    def register_serving_endpoint(self, req: dict) -> dict:
        """req: {task_id, url, weights_generation?, draining?, role?}
        -> {}. A
        serving task's HTTP frontend came up at `url` (or, with
        draining=true, announced it is connection-draining ahead of a
        relaunch/preemption); the AM records it (history event + task
        infos) so the portal/proxy/fleet router can reach — or route
        around — the endpoint. weights_generation stamps the weight
        rollout epoch this replica serves (0 = the AM's current
        epoch). role names the disaggregation pool this replica works
        in ("prefill" | "decode" | "both"; empty = both) so the
        router/autoscaler can treat the pools independently."""

    @abc.abstractmethod
    def register_execution_result(self, req: dict) -> dict:
        """req: {exit_code, job_name, job_index, session_id, task_attempt?}
        -> {}. Results from a stale session or a superseded task attempt
        are ignored."""

    @abc.abstractmethod
    def finish_application(self, req: dict) -> dict:
        """client tells AM to shut down -> {}."""

    @abc.abstractmethod
    def task_executor_heartbeat(self, req: dict) -> dict:
        """req: {task_id, task_attempt?} -> {"spec_generation": int?,
        "profile_request": {request_id, num_steps}?}. Pings from a
        superseded attempt (zombie executor of a relaunched task) are
        ignored; the response carries the current cluster-spec generation
        so running executors detect peer relaunches, and piggybacks any
        pending on-demand profiler request for this task."""

    @abc.abstractmethod
    def read_task_logs(self, req: dict) -> dict:
        """Operator/client plane: req {task_id?, stream?, offset?,
        max_bytes?} -> one bounded log chunk {task_id, stream, data,
        offset, next_offset, eof, source} (or {error}). A RUNNING task's
        chunk is proxied live from its executor's TaskLogService; a
        completed task's comes from the logs the AM aggregated into
        history at task completion. offset < 0 starts a tail cursor
        (size - tony.logs.tail-bytes); callers pass next_offset back to
        follow. Chunk size is capped server-side at
        tony.logs.chunk-bytes regardless of max_bytes."""

    @abc.abstractmethod
    def get_skew(self, req: dict) -> dict:
        """Operator/client plane: req {} -> the live cross-task skew
        bundle (observability/skew.py SkewTracker.bundle): gang sketch
        summaries per signal, the tasks x windows step-time heatmap,
        startup values, latched stragglers + the detection log. The
        portal's /api/jobs/:id/skew proxies this for RUNNING jobs; the
        same shape is flushed to history as skew.json at finish."""

    @abc.abstractmethod
    def get_alerts(self, req: dict) -> dict:
        """Operator/client plane: req {} -> the live alert bundle
        (observability/alerts.py AlertEngine.bundle): currently-firing
        alerts + the bounded transition log. The portal's
        /api/jobs/:id/alerts proxies this for RUNNING jobs; the same
        shape is flushed to history as alerts.json on every
        transition."""

    @abc.abstractmethod
    def request_preemption(self, req: dict) -> dict:
        """Arbiter/operator plane: req {grace_ms?, reason?,
        requested_by?} -> {app_id, grace_ms, deadline_ms} (or {error}).
        Begins checkpoint-then-evict: the drain ask rides every task's
        next heartbeat, executors TERM their user processes (trainers
        emergency-checkpoint within the grace window), and the
        application finishes PREEMPTED once the gang has stopped —
        containers still running at the deadline are force-stopped.
        Idempotent: a second request returns the in-flight drain's
        deadline. Client-plane only; task tokens fail closed."""

    @abc.abstractmethod
    def request_rolling_update(self, req: dict) -> dict:
        """Operator/client plane: req {generation?, requested_by?} ->
        {app_id, generation, replicas} (or {error}). Begin a
        zero-downtime rolling weight update over the serving replicas:
        one at a time, each endpoint is marked draining (the fleet
        router stops new sends), its container relaunches (restoring
        the latest promoted checkpoint), and the rollout advances only
        once the replacement re-registers healthy at the new
        generation. generation 0 = bump the AM's epoch by one.
        Idempotent while a rollout is in flight (returns the in-flight
        one). Client-plane only; task tokens fail closed."""

    @abc.abstractmethod
    def request_resize(self, req: dict) -> dict:
        """Arbiter/operator plane: req {job_name?, width?, tpus_per_task?,
        grace_ms?, reason?, requested_by?, session_attempt?} ->
        {app_id, job_name, from_width, to_width, ...} (or {error}).
        Begin an in-place elastic gang resize (cluster/elastic.py):
        quiesce the gang (trainers emergency-checkpoint within the
        grace window, containers stay alive), change membership
        (session.add_task_instance / trailing-slot removal) or re-mesh
        per-task chips, bump the cluster-spec generation so survivors
        re-rendezvous via heartbeat spec diffs, and resume from the
        quiesce checkpoint via the resharding restore. Idempotent while
        a resize is in flight (returns the in-flight one); a
        session_attempt >= 0 that doesn't match the CURRENT session
        attempt is rejected. Client-plane only; task tokens fail
        closed."""

    @abc.abstractmethod
    def request_profile(self, req: dict) -> dict:
        """Operator/client plane: req {task_id?, num_steps?} ->
        {request_id, task_id, num_steps} (or {error}). Asks one task's
        trainer (default: the first running tracked task) to capture a
        profiler trace for N steps; the ask rides the task's next
        heartbeat. Idempotent: a second request while one is in flight
        for the same task returns the in-flight request_id."""

    def report_serving_migrated(self, req: dict) -> dict:
        """req: {task_id, target_url, count?} -> {}. A prefill replica
        handed a request's KV prefix + sampler state to a decode
        replica at target_url over /v1/migrate; the AM records the
        hand-off in job history (SERVING_MIGRATED) so operators can see
        disaggregation traffic. Non-abstract with a no-op default: the
        verb is telemetry-only and older handler stubs keep working."""
        return {}

    def get_profile(self, req: dict) -> dict:
        """Operator/client plane: req {} -> the AM's live sampling-profiler
        snapshot (observability/profiler.py): {process, hz, samples,
        overhead_pct, ...} plus `folded` — the collapsed-stack text the
        portal flamegraph / `cli flame` render. Non-abstract with an
        unsupported default so older handler stubs keep working; the same
        text is flushed to history as profile.folded at finish."""
        return {"error": "profiler not available"}


class MetricsServiceHandler(abc.ABC):
    @abc.abstractmethod
    def update_metrics(self, req: dict) -> dict:
        """req: {task_type, index, metrics: [Metric dict]} -> {}."""


class TaskLogServiceHandler(abc.ABC):
    """Executor-side live-log read surface (observability/logs.LogTail
    over the container's own stdout/stderr files)."""

    @abc.abstractmethod
    def read_log(self, req: dict) -> dict:
        """req: {stream, offset?, max_bytes?} -> {data, offset,
        next_offset, size, eof} — one bounded, redacted chunk. offset < 0
        opens a tail cursor at (size - tail window)."""

    def read_stacks(self, req: dict) -> dict:
        """req: {} -> {task_id, attempt, generated_ms, threads: [{name,
        ident, daemon, frames}]} — a redacted all-thread stack snapshot
        of the executor process (observability/profiler.py
        collect_thread_stacks). The wedge-autopsy read: when liveliness
        expiry / barrier timeout / orphan-grace fires, the AM pulls this
        before recording the failure so diagnostics.json can name the
        blocking frame. Served from a separate gRPC worker thread, so it
        answers even while the executor's main thread is wedged.
        Non-abstract with an unsupported default so minimal handlers
        (bench pool executors) keep working."""
        return {"error": "stack dump not available"}


def _generic_handler(service_name: str, handler: Any,
                     methods: tuple[str, ...]):
    import grpc

    from tony_tpu_torch.observability.metrics import REGISTRY

    rpc_handlers = {}
    for method in methods:
        fn = getattr(handler, method)

        def unary(req, ctx, _fn=fn, _method=method):
            # self-health telemetry: server-side handler latency +
            # outcome counters into the process registry (the AM's
            # /metrics endpoint exposes them)
            t0 = time.monotonic()
            try:
                resp = _fn(req)
            except Exception:
                REGISTRY.counter("tony_rpc_server_calls_total",
                                 method=_method, status="error").inc()
                raise
            REGISTRY.summary("tony_rpc_server_latency_seconds",
                             method=_method).observe(time.monotonic() - t0)
            REGISTRY.counter("tony_rpc_server_calls_total",
                             method=_method, status="ok").inc()
            return resp

        rpc_handlers[method] = grpc.unary_unary_rpc_method_handler(
            unary, request_deserializer=_deser, response_serializer=_ser)
    return grpc.method_handlers_generic_handler(service_name, rpc_handlers)


def serve(cluster_handler: Optional[ClusterServiceHandler] = None,
          metrics_handler: Optional[MetricsServiceHandler] = None,
          host: str = "0.0.0.0", port: int = 0,
          max_workers: int = 16,
          auth_token: Optional[str] = None,
          log_handler: Optional[TaskLogServiceHandler] = None):
    """Start a gRPC server hosting any of the three services on `port`
    (0 = an ephemeral one): the AM passes the cluster and metrics
    handlers, an executor its log handler. With `auth_token` every call
    must carry it, or a task token derived from it for the task methods
    (on an executor, `auth_token` is that task's own derived token).
    Returns (server, bound_port)."""
    from concurrent import futures

    import grpc

    interceptors = ()
    if auth_token:
        from tony_tpu_torch.security.tokens import token_auth_interceptor
        interceptors = (token_auth_interceptor(auth_token),)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         interceptors=interceptors)
    for service, handler, methods in (
            (CLUSTER_SERVICE, cluster_handler, CLUSTER_METHODS),
            (METRICS_SERVICE, metrics_handler, METRICS_METHODS),
            (TASK_LOG_SERVICE, log_handler, TASK_LOG_METHODS)):
        if handler is not None:
            server.add_generic_rpc_handlers(
                (_generic_handler(service, handler, methods),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"failed to bind RPC server on {host}:{port}")
    server.start()
    return server, bound
