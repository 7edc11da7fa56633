"""The frozen configuration a task reads: the reading half of
`tony_tpu/conf/configuration.py`.

The client freezes the job's configuration into ``tony-final.json`` and
the AM hands its path to every executor, which hands it to its task, as
``TONY_CONF_PATH``. The port's executor, trainer and server read their
knobs from it with the same typed getters (`get`, `get_str`, `get_int`,
`get_float`, `get_bool`, `get_time_ms`, `get_strings`, `source_of`) and
the same parsing ('5s', '500ms', 'true'/'off', 'a,b'). The keys they read
and their defaults (those of `tony_tpu/conf/keys.py` and `defaults.py`)
are below; outside the orchestrator `Configuration()` holds only those
defaults.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

# -- keys the port reads -------------------------------------------------
TONY_PREFIX = "tony."
TASK_METRICS_INTERVAL_MS = "tony.task.metrics-interval-ms"

# the executor's
APPLICATION_FRAMEWORK = "tony.application.framework"   # runtimes.py's key
APPLICATION_TIMEOUT = "tony.application.timeout"       # ms; 0 = none
TASK_HEARTBEAT_INTERVAL_MS = "tony.task.heartbeat-interval-ms"
TASK_REGISTRATION_TIMEOUT_SEC = "tony.task.registration-timeout-sec"
TASK_HB_FAILURE_BUDGET = "tony.task.hb-failure-budget"
TASK_TERM_GRACE_MS = "tony.task.term-grace-ms"
AM_ORPHAN_GRACE_MS = "tony.am.orphan-grace-ms"
TASK_GPU_METRICS_ENABLED = "tony.task.gpu-metrics.enabled"
GPU_PATH_TO_EXEC = "tony.gpu-exec-path"
LOGS_TAIL_BYTES = "tony.logs.tail-bytes"
LOGS_CHUNK_BYTES = "tony.logs.chunk-bytes"
LOGS_DIAGNOSTICS_LINES = "tony.logs.diagnostics-lines"
SRC_DIR = "tony.srcdir"
PYTHON_VENV = "tony.python.venv"
CONTAINERS_RESOURCES = "tony.containers.resources"
LOCALIZATION_CACHE_ENABLED = "tony.localization.cache-enabled"
LOCALIZATION_CACHE_DIR = "tony.localization.cache-dir"  # "" = <tmp>/...
CHECKPOINT_KEEP = "tony.checkpoint.keep"
TPU_MESH_SHAPE = "tony.tpu.mesh-shape"
TPU_MESH_AXES = "tony.tpu.mesh-axes"
TPU_NUM_SLICES = "tony.tpu.num-slices"
TPU_COORDINATOR_PORT = "tony.tpu.coordinator-port"     # 0 = process 0's
EXECUTOR_JAX_CACHE_DIR = "tony.executor.jax-cache-dir"

SERVING_SLOTS = "tony.serving.slots"
SERVING_TOKEN_BUDGET = "tony.serving.token-budget"
SERVING_QUEUE_DEPTH = "tony.serving.queue-depth"
SERVING_PORT = "tony.serving.port"
SERVING_ROLE = "tony.serving.role"
SERVING_MIGRATE_TO = "tony.serving.migrate-to"
SERVING_KV_PREFIX_SHARING = "tony.serving.kv.prefix-sharing"
SERVING_KV_PAGE_SIZE = "tony.serving.kv.page-size"
SERVING_KV_PAGES = "tony.serving.kv.pages"
SERVING_FLEET_DRAIN_TIMEOUT_MS = "tony.serving.fleet.drain-timeout-ms"
SERVING_TRACE_ENABLED = "tony.serving.trace.enabled"
SERVING_TRACE_SLOW_THRESHOLD_MS = "tony.serving.trace.slow-threshold-ms"
SERVING_TRACE_SLOWEST_K = "tony.serving.trace.slowest-k"
SERVING_TRACE_WINDOW_MS = "tony.serving.trace.window-ms"
SERVING_TRACE_MAX_TRACES = "tony.serving.trace.max-traces"

PROFILER_ENABLED = "tony.profiler.enabled"
PROFILER_HZ = "tony.profiler.hz"
PROFILER_MAX_STACKS = "tony.profiler.max-stacks"
PROFILER_STALL_FACTOR = "tony.profiler.stall-factor"
PROFILER_OVERHEAD_BUDGET_PCT = "tony.profiler.overhead-budget-pct"

def jobtype_key(jobtype: str, attr: str) -> str:
    """``tony.<jobtype>.<attr>``."""
    return f"{TONY_PREFIX}{jobtype}.{attr}"


def gpus_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "gpus")


def resources_key(jobtype: str) -> str:
    return jobtype_key(jobtype, "resources")


# tony.srcdir, tony.python.venv, tony.containers.resources and the mesh
# keys have no default, as in the JAX package
DEFAULTS: dict[str, Any] = {
    TASK_METRICS_INTERVAL_MS: 5000,
    APPLICATION_FRAMEWORK: "jax",
    APPLICATION_TIMEOUT: 0,
    TASK_HEARTBEAT_INTERVAL_MS: 1000,
    TASK_REGISTRATION_TIMEOUT_SEC: 300,
    TASK_HB_FAILURE_BUDGET: 5,
    TASK_TERM_GRACE_MS: 15_000,
    AM_ORPHAN_GRACE_MS: 30_000,
    TASK_GPU_METRICS_ENABLED: True,
    GPU_PATH_TO_EXEC: "",
    LOGS_TAIL_BYTES: 65536,
    LOGS_CHUNK_BYTES: 32768,
    LOGS_DIAGNOSTICS_LINES: 200,
    LOCALIZATION_CACHE_ENABLED: False,
    LOCALIZATION_CACHE_DIR: "",
    CHECKPOINT_KEEP: 3,
    TPU_NUM_SLICES: 1,
    TPU_COORDINATOR_PORT: 0,
    EXECUTOR_JAX_CACHE_DIR: "",
    SERVING_SLOTS: 4,
    SERVING_TOKEN_BUDGET: 2048,
    SERVING_QUEUE_DEPTH: 64,
    SERVING_PORT: 0,             # 0 = the executor-assigned $SERVING_PORT
    SERVING_ROLE: "both",        # "both" | "prefill" | "decode"
    SERVING_MIGRATE_TO: "",
    SERVING_KV_PREFIX_SHARING: False,
    SERVING_KV_PAGE_SIZE: 16,
    SERVING_KV_PAGES: 0,         # 0 = one full prefix per slot
    SERVING_FLEET_DRAIN_TIMEOUT_MS: 10_000,
    SERVING_TRACE_ENABLED: True,
    SERVING_TRACE_SLOW_THRESHOLD_MS: 1000,
    SERVING_TRACE_SLOWEST_K: 8,
    SERVING_TRACE_WINDOW_MS: 60_000,
    SERVING_TRACE_MAX_TRACES: 256,
    PROFILER_ENABLED: True,
    PROFILER_HZ: 19.0,
    PROFILER_MAX_STACKS: 2000,
    PROFILER_STALL_FACTOR: 4.0,
    PROFILER_OVERHEAD_BUDGET_PCT: 1.0,
}

_TIME_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h|d)?\s*$",
                      re.IGNORECASE)
_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off", ""}


def parse_time_ms(value: Any) -> int:
    """'500ms' / '5s' / '2m' / '1h' / a bare number (ms) in milliseconds."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _TIME_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse duration: {value!r}")
    unit = (m.group(2) or "ms").lower()
    mult = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
            "d": 86_400_000}[unit]
    return int(float(m.group(1)) * mult)


class Configuration:
    """Key -> value, read-only, with the JAX package's typed getters and
    its per-key source ("default", "test", "cli", a file name...)."""

    def __init__(self, values: dict[str, Any] | None = None,
                 sources: dict[str, str] | None = None):
        if values is None:
            self._values: dict[str, Any] = dict(DEFAULTS)
            self._sources = {k: "default" for k in DEFAULTS}
        else:
            self._values = dict(values)
            self._sources = (dict(sources) if sources is not None
                             else {k: "programmatic" for k in values})

    @classmethod
    def read(cls, path: str) -> "Configuration":
        """A frozen tony-final.json ({"values": ..., "sources": ...}) or a
        plain JSON object, as the JAX package writes and reads it."""
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        if "values" in payload:
            return cls(dict(payload["values"]),
                       dict(payload.get("sources", {})))
        return cls(dict(payload),
                   {k: os.path.basename(path) for k in payload})

    @classmethod
    def from_env(cls, env=None) -> "Configuration":
        """The file `TONY_CONF_PATH` names, else the defaults."""
        from tony_tpu_torch import constants as C
        e = env if env is not None else os.environ
        path = e.get(C.TONY_CONF_PATH, "")
        return cls.read(path) if path and os.path.exists(path) else cls()

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def get_str(self, key: str, default: str = "") -> str:
        v = self._values.get(key, default)
        return "" if v is None else str(v)

    def get_strings(self, key: str) -> list[str]:
        """A comma-separated (or JSON list) value as a list."""
        v = self._values.get(key)
        if v is None or v == "":
            return []
        if isinstance(v, (list, tuple)):
            return [str(x) for x in v]
        return [s.strip() for s in str(v).split(",") if s.strip()]

    def source_of(self, key: str) -> str:
        return self._sources.get(key, "unset")

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._values.get(key)
        return default if v is None or v == "" else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._values.get(key)
        return default if v is None or v == "" else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._values.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        s = str(v).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"cannot parse bool for {key}: {v!r}")

    def get_time_ms(self, key: str, default: int = 0) -> int:
        v = self._values.get(key)
        return default if v is None or v == "" else parse_time_ms(v)
