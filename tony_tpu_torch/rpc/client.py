"""Retrying JSON-over-gRPC clients of the AM's control plane.

The port's copy of `tony_tpu/rpc/client.py`: the service and method names
and the JSON codec of `rpc/service.py`, the same per-call token metadata,
and the same retry ladder (capped equal-jitter exponential backoff over
UNAVAILABLE and DEADLINE_EXCEEDED). It carries the calls a port trainer
or server makes (`register_serving_endpoint`, `report_serving_migrated`,
`update_metrics`), the executor's (the gang barrier, heartbeats, the
TensorBoard URL and the execution result), the application side's (the
client's `get_task_infos` and `finish_application`, and the operator
verbs of the CLI: logs, profiles, skew, alerts, preemption, resize and
rolling updates), and `TaskLogServiceClient`, the AM's reader of an
executor's logs and stacks.

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
from tony_tpu_torch.rpc.service import (  # noqa: F401 — the client's names
    CLUSTER_METHODS, CLUSTER_SERVICE, METRICS_METHODS, METRICS_SERVICE,
    TASK_LOG_METHODS, TASK_LOG_SERVICE, _deser, _ser,
)
from tony_tpu_torch.utils.common import equal_jitter_backoff_sec

DEFAULT_RETRIES = 10
DEFAULT_RETRY_SLEEP_SEC = 0.5
DEFAULT_RETRY_MAX_SLEEP_SEC = 8.0


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
                    time.sleep(self._backoff_sec(attempt))
        REGISTRY.counter("tony_rpc_client_calls_total",
                         method=method, status="exhausted").inc()
        raise ConnectionError(
            f"RPC {method} failed after {retries} attempts: {last_err}")

    def _backoff_sec(self, attempt: int) -> float:
        """Capped equal-jitter exponential backoff: attempt N sleeps in
        [cap/2, cap], cap = min(max, base * 2^N)."""
        return equal_jitter_backoff_sec(self._retry_sleep_sec,
                                        self._retry_max_sleep_sec,
                                        attempt, self._rng)

    def close(self) -> None:
        self._channel.close()


class ClusterServiceClient(_JsonRpcClient):
    """Calls on the AM's cluster service: a task's, its executor's, the
    client's and the operator's."""

    def __init__(self, host: str, port: int, **kw):
        super().__init__(CLUSTER_SERVICE, CLUSTER_METHODS, host, port, **kw)

    def get_task_infos(self) -> list[dict]:
        return self.call("get_task_infos", {})

    def get_cluster_spec(self, task_id: str) -> Optional[dict]:
        spec = self.call("get_cluster_spec", {"task_id": task_id}).get("spec")
        return json.loads(spec) if spec else None

    def register_worker_spec(self, task_id: str, spec: str,
                             session_id: int = -1, task_attempt: int = -1,
                             with_generation: bool = False):
        """The gang barrier: the full cluster spec once every task has
        registered, else None. The AM refuses a stale session's or a
        superseded attempt's registration. With with_generation=True the
        spec comes as (spec, spec_generation)."""
        resp = self.call("register_worker_spec",
                         {"task_id": task_id, "spec": spec,
                          "session_id": session_id,
                          "task_attempt": task_attempt})
        spec_json = resp.get("spec")
        if not spec_json:
            return None
        parsed = json.loads(spec_json)
        if with_generation:
            return parsed, int(resp.get("generation", 0))
        return parsed

    def register_tensorboard_url(self, task_id: str, url: str) -> None:
        self.call("register_tensorboard_url", {"task_id": task_id, "url": url})

    def register_execution_result(self, exit_code: int, job_name: str,
                                  job_index: int, session_id: int,
                                  task_attempt: int = -1,
                                  barrier_timeout: bool = False,
                                  preempted: bool = False,
                                  resized: bool = False,
                                  diagnostics: Optional[dict] = None
                                  ) -> None:
        """The task's exit. The flags say what an exit code cannot:
        `barrier_timeout` (the gang never formed: no relaunch budget
        spent), `preempted` (a drain asked for it), `resized` (an elastic
        shrink released the slot). `diagnostics` (failures only) is the
        executor's classified, redacted post-mortem."""
        req = {
            "exit_code": exit_code, "job_name": job_name,
            "job_index": job_index, "session_id": session_id,
            "task_attempt": task_attempt,
            "barrier_timeout": barrier_timeout,
            "preempted": preempted,
            "resized": resized}
        if diagnostics:
            req["diagnostics"] = diagnostics
        self.call("register_execution_result", req)

    def finish_application(self) -> None:
        self.call("finish_application", {})

    def task_executor_heartbeat(self, task_id: str,
                                task_attempt: int = -1,
                                log_addr: str = "",
                                spec_generation: int = -1,
                                resize_ack: int = 0) -> dict:
        """Liveness: one attempt, a short deadline, no wait_for_ready (the
        heartbeater counts failures itself). The request gossips the
        executor's TaskLogService address, the spec generation it holds
        and the newest resize it has quiesced for; the response carries
        the AM's spec generation, a spec diff or refetch verdict, and any
        profile, drain or resize ask."""
        req = {"task_id": task_id, "task_attempt": task_attempt}
        if log_addr:
            req["log_addr"] = log_addr
        if spec_generation > 0:
            req["spec_generation"] = spec_generation
        if resize_ack > 0:
            req["resize_ack"] = resize_ack
        return self.call("task_executor_heartbeat", req,
                         retries=1, timeout_sec=5.0, wait_for_ready=False)

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


    def request_rolling_update(self, generation: int = 0,
                               requested_by: str = "operator") -> dict:
        """Begin a zero-downtime rolling weight update over this app's
        serving replicas (cli rollout verb). Client-plane: never a task
        token."""
        return self.call("request_rolling_update",
                         {"generation": int(generation),
                          "requested_by": requested_by},
                         retries=1, timeout_sec=10.0,
                         wait_for_ready=False)

    def request_resize(self, job_name: str = "", width: int = 0,
                       tpus_per_task: int = 0, grace_ms: int = 0,
                       reason: str = "",
                       requested_by: str = "operator",
                       session_attempt: int = -1) -> dict:
        """Elastic gang resize (cluster/elastic.py + `cli resize`):
        grow/shrink a RUNNING gang in place. `width` changes the
        jobtype's task-instance count; alternatively `tpus_per_task`
        re-meshes the chips of a fixed-membership gang.
        `session_attempt` (>= 0) fences the ask to one AM session
        attempt. Client-plane: never a task token."""
        return self.call("request_resize",
                         {"job_name": job_name, "width": int(width),
                          "tpus_per_task": int(tpus_per_task),
                          "grace_ms": int(grace_ms), "reason": reason,
                          "requested_by": requested_by,
                          "session_attempt": int(session_attempt)},
                         retries=1, timeout_sec=10.0,
                         wait_for_ready=False)

    def request_preemption(self, grace_ms: int = 0, reason: str = "",
                           requested_by: str = "operator") -> dict:
        """Begin checkpoint-then-evict on this AM (`cli preempt`): the
        drain ask rides every task's next heartbeat, trainers
        emergency-checkpoint within `grace_ms`, and the application
        finishes PREEMPTED. Client-plane: never a task token."""
        return self.call("request_preemption",
                         {"grace_ms": int(grace_ms), "reason": reason,
                          "requested_by": requested_by},
                         retries=1, timeout_sec=10.0, wait_for_ready=False)

    def request_profile(self, task_id: str = "",
                        num_steps: int = 0) -> dict:
        """Ask the AM to capture a profile on one task's trainer.
        Client-plane: operator CLI / portal POST, never a task token."""
        return self.call("request_profile",
                         {"task_id": task_id, "num_steps": num_steps},
                         retries=1, timeout_sec=10.0, wait_for_ready=False)

    def get_skew(self) -> dict:
        """The AM's live cross-task skew bundle (observability/skew.py):
        gang quantiles, step-time heatmap, latched stragglers."""
        return self.call("get_skew", {}, retries=1, timeout_sec=10.0,
                         wait_for_ready=False)

    def get_alerts(self) -> dict:
        """The AM's live alert bundle (the port's AM runs no alert
        engine and answers as the JAX AM does with alerting off)."""
        return self.call("get_alerts", {}, retries=1, timeout_sec=10.0,
                         wait_for_ready=False)

    def get_profile(self) -> dict:
        """The AM's live sampling-profiler snapshot + collapsed-stack
        text (observability/profiler.py); `cli flame` polls this."""
        return self.call("get_profile", {}, retries=1, timeout_sec=10.0,
                         wait_for_ready=False)

    def read_task_logs(self, task_id: str = "", stream: str = "stderr",
                       offset: int = -1, max_bytes: int = 0) -> dict:
        """One bounded log chunk for a task (live when running, from
        aggregated history otherwise). CLI `logs [--follow]` polls this
        with the returned next_offset as its cursor."""
        return self.call("read_task_logs",
                         {"task_id": task_id, "stream": stream,
                          "offset": int(offset),
                          "max_bytes": int(max_bytes)},
                         retries=1, timeout_sec=10.0, wait_for_ready=False)


class TaskLogServiceClient(_JsonRpcClient):
    """A reader of an executor's TaskLogService (the AM's proxy side):
    one attempt and a short deadline per call, so a wedged executor
    degrades a read and never holds the caller."""

    def __init__(self, host: str, port: int, **kw):
        super().__init__(TASK_LOG_SERVICE, TASK_LOG_METHODS, host, port, **kw)

    def read_log(self, stream: str = "stderr", offset: int = -1,
                 max_bytes: int = 0) -> dict:
        return self.call("read_log",
                         {"stream": stream, "offset": int(offset),
                          "max_bytes": int(max_bytes)},
                         retries=1, timeout_sec=5.0, wait_for_ready=False)

    def read_stacks(self) -> dict:
        return self.call("read_stacks", {},
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

