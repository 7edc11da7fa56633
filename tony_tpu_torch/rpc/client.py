"""Retrying JSON-over-gRPC clients of the AM's control plane.

The port's copy of the task-side half of `tony_tpu/rpc/client.py` and
`rpc/service.py`: the same service and method names, the same JSON codec
(`_ser`/`_deser`), the same per-call token metadata, and the same retry
ladder (capped equal-jitter exponential backoff over UNAVAILABLE and
DEADLINE_EXCEEDED). It carries the three calls a port trainer or server
makes: `register_serving_endpoint`, `report_serving_migrated` and
`update_metrics`.

`grpc` is imported only when a client is built, so a process with no AM
in its environment never loads it.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Any, Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.observability.metrics import REGISTRY

CLUSTER_SERVICE = "tony.ClusterService"
METRICS_SERVICE = "tony.MetricsService"
CLUSTER_METHODS = ("register_serving_endpoint", "report_serving_migrated")
METRICS_METHODS = ("update_metrics",)

DEFAULT_RETRIES = 10
DEFAULT_RETRY_SLEEP_SEC = 0.5
DEFAULT_RETRY_MAX_SLEEP_SEC = 8.0


def _ser(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


def _deser(data: bytes) -> Any:
    return json.loads(data.decode("utf-8")) if data else {}


def equal_jitter_backoff_sec(base_sec: float, max_sec: float, exponent: int,
                             rng: random.Random) -> float:
    """Uniform in [cap/2, cap], cap = min(max_sec, base_sec * 2^exponent)
    (max_sec <= 0: no cap); 0 when base_sec <= 0 or exponent < 0."""
    if base_sec <= 0 or exponent < 0:
        return 0.0
    cap = base_sec * (2 ** min(exponent, 30))
    if max_sec > 0:
        cap = min(max_sec, cap)
    return rng.uniform(cap / 2.0, cap)


class _JsonRpcClient:
    def __init__(self, service: str, methods: tuple[str, ...],
                 host: str, port: int,
                 retries: int = DEFAULT_RETRIES,
                 retry_sleep_sec: float = DEFAULT_RETRY_SLEEP_SEC,
                 retry_max_sleep_sec: float = DEFAULT_RETRY_MAX_SLEEP_SEC,
                 timeout_sec: float = 30.0,
                 auth_token: Optional[str] = None,
                 task_auth_id: Optional[str] = None):
        import grpc

        from tony_tpu_torch.security.tokens import token_call_creds
        self._grpc = grpc
        self._retries = retries
        self._retry_sleep_sec = retry_sleep_sec
        self._retry_max_sleep_sec = retry_max_sleep_sec
        self._timeout_sec = timeout_sec
        # jitter seeded per task identity (and TONY_TEST_SEED for replay):
        # the executors of a booting AM must not retry in lockstep
        seed = os.environ.get(C.TEST_SEED)
        ident = (f"{os.environ.get(C.JOB_NAME, '')}:"
                 f"{os.environ.get(C.TASK_INDEX, '')}:"
                 f"{os.environ.get(C.TASK_ATTEMPT, '')}")
        self._rng = random.Random(
            None if seed is None
            else f"{seed}:{ident}:{service}:{host}:{port}")
        self._metadata = token_call_creds(auth_token, task_auth_id)
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._stubs = {
            m: self._channel.unary_unary(
                f"/{service}/{m}", request_serializer=_ser,
                response_deserializer=_deser)
            for m in methods}
        # only transient transport statuses are worth retrying; anything
        # else (a handler's exception, a refused token) is a real error
        self._retryable = (grpc.StatusCode.UNAVAILABLE,
                           grpc.StatusCode.DEADLINE_EXCEEDED)

    def call(self, method: str, req: Optional[dict] = None,
             retries: Optional[int] = None,
             timeout_sec: Optional[float] = None,
             wait_for_ready: bool = True) -> Any:
        """One call with the retry ladder; `retries=1` (one attempt, no
        sleep) for a path that must fail fast."""
        retries = self._retries if retries is None else retries
        timeout_sec = self._timeout_sec if timeout_sec is None else timeout_sec
        last_err: Optional[Exception] = None
        for attempt in range(retries):
            t0 = time.monotonic()
            try:
                resp = self._stubs[method](req or {}, timeout=timeout_sec,
                                           wait_for_ready=wait_for_ready,
                                           metadata=self._metadata)
                REGISTRY.summary("tony_rpc_client_latency_seconds",
                                 method=method).observe(
                    time.monotonic() - t0)
                REGISTRY.counter("tony_rpc_client_calls_total",
                                 method=method, status="ok").inc()
                return resp
            except self._grpc.RpcError as e:
                if e.code() not in self._retryable:
                    REGISTRY.counter("tony_rpc_client_calls_total",
                                     method=method, status="error").inc()
                    raise
                last_err = e
                REGISTRY.counter("tony_rpc_client_retries_total",
                                 method=method).inc()
                if attempt + 1 < retries:
                    time.sleep(equal_jitter_backoff_sec(
                        self._retry_sleep_sec, self._retry_max_sleep_sec,
                        attempt, self._rng))
        REGISTRY.counter("tony_rpc_client_calls_total",
                         method=method, status="exhausted").inc()
        raise ConnectionError(
            f"RPC {method} failed after {retries} attempts: {last_err}")

    def close(self) -> None:
        self._channel.close()


class ClusterServiceClient(_JsonRpcClient):
    """The serving task's calls on the AM's cluster service."""

    def __init__(self, host: str, port: int, **kw):
        super().__init__(CLUSTER_SERVICE, CLUSTER_METHODS, host, port, **kw)

    def register_serving_endpoint(self, task_id: str, url: str,
                                  weights_generation: int = 0,
                                  draining: bool = False,
                                  role: str = "") -> None:
        """Announce this replica's live HTTP endpoint (or, with
        `draining=True`, that it is connection-draining, so the fleet
        router stops new sends). `weights_generation` 0 lets the AM stamp
        its current epoch; `role` names the disaggregation pool."""
        req = {"task_id": task_id, "url": url}
        if weights_generation > 0:
            req["weights_generation"] = int(weights_generation)
        if draining:
            req["draining"] = True
        if role:
            req["role"] = str(role)
        self.call("register_serving_endpoint", req)

    def report_serving_migrated(self, task_id: str, target_url: str,
                                count: int = 1) -> None:
        """Telemetry: `count` request(s) handed to the decode replica at
        target_url. One attempt, short deadline: a lost report costs an
        event line."""
        self.call("report_serving_migrated",
                  {"task_id": task_id, "target_url": target_url,
                   "count": int(count)},
                  retries=1, timeout_sec=5.0, wait_for_ready=False)


class MetricsServiceClient(_JsonRpcClient):
    def __init__(self, host: str, port: int, **kw):
        super().__init__(METRICS_SERVICE, METRICS_METHODS, host, port, **kw)

    def update_metrics(self, task_type: str, index: int,
                       metrics: list[dict],
                       spans: Optional[list[dict]] = None,
                       serving_traces: Optional[list[dict]] = None,
                       attempt: int = -1) -> None:
        """Gauges, with finished spans and sampled request traces riding
        the same call; `attempt` labels the task attempt."""
        req = {"task_type": task_type, "index": index, "metrics": metrics}
        if spans:
            req["spans"] = spans
        if serving_traces:
            req["serving_traces"] = serving_traces
        if attempt >= 0:
            req["attempt"] = attempt
        self.call("update_metrics", req)

