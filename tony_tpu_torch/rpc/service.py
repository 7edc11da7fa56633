"""The control plane's gRPC services: the port's copy of the names and of
the serving half of `tony_tpu/rpc/service.py`.

The JAX package's AM serves `tony.ClusterService` and `tony.MetricsService`;
every executor serves `tony.TaskLogService`, the live-log and stack reads
the AM proxies to it. The methods are registered through grpc's generic
handlers with JSON payloads (`_ser`/`_deser`), so the names and the codec
below are the wire protocol, kept as they are. `serve` hosts the
executor's service; `grpc` is imported only when a server is built.
"""

from __future__ import annotations

import abc
import json
import time
from typing import Any, Optional

CLUSTER_SERVICE = "tony.ClusterService"
METRICS_SERVICE = "tony.MetricsService"
TASK_LOG_SERVICE = "tony.TaskLogService"

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


def _ser(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


def _deser(data: bytes) -> Any:
    return json.loads(data.decode("utf-8")) if data else {}


class TaskLogServiceHandler(abc.ABC):
    """The executor's read surface: bounded log chunks of its container's
    stdout/stderr and a stack snapshot of its own threads."""

    @abc.abstractmethod
    def read_log(self, req: dict) -> dict:
        """req: {stream, offset?, max_bytes?} -> {data, offset,
        next_offset, size, eof} — one bounded, redacted chunk. offset < 0
        opens a tail cursor at (size - tail window)."""

    def read_stacks(self, req: dict) -> dict:
        """req: {} -> {task_id, attempt, generated_ms, threads} — a
        redacted snapshot of every thread's stack, served on a gRPC worker
        thread so it answers while the main thread is wedged."""
        return {"error": "stack dump not available"}


def _generic_handler(service_name: str, handler: Any,
                     methods: tuple[str, ...]):
    import grpc

    from tony_tpu_torch.observability.metrics import REGISTRY

    rpc_handlers = {}
    for method in methods:
        fn = getattr(handler, method)

        def unary(req, ctx, _fn=fn, _method=method):
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


def serve(log_handler: TaskLogServiceHandler, host: str = "0.0.0.0",
          port: int = 0, max_workers: int = 16,
          auth_token: Optional[str] = None):
    """Start the executor's TaskLogService on `port` (0 = an ephemeral
    one). With `auth_token` every call must carry it (or a task token
    derived from it, for the task methods). Returns (server, bound_port).
    The AM's two services are the JAX package's AM's."""
    from concurrent import futures

    import grpc

    interceptors = ()
    if auth_token:
        from tony_tpu_torch.security.tokens import token_auth_interceptor
        interceptors = (token_auth_interceptor(auth_token),)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         interceptors=interceptors)
    server.add_generic_rpc_handlers(
        (_generic_handler(TASK_LOG_SERVICE, log_handler, TASK_LOG_METHODS),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"failed to bind RPC server on {host}:{port}")
    server.start()
    return server, bound
