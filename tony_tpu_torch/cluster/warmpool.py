"""Warm executor pool: pre-forked, pre-imported processes the local
backend leases instead of cold-spawning.

The port's copy of `tony_tpu/cluster/warmpool.py`. Cold bring-up at a
wide gang is dominated by per-container `subprocess.Popen` + full
interpreter boot + executor-stack import. The pool pays that cost ONCE
per slot, ahead of time: each child runs
`python -m tony_tpu_torch.cluster.warmpool`, imports the executor stack
(never torch: the user process the executor starts owns the card), prints
``WARM-READY`` and blocks on stdin. A lease writes ONE line of JSON — the
bind spec — and the child becomes the container process: it re-binds to
the new application through the exact state a cold launch would get
(fresh task token, env, TONY_TRACE_ID), so the attempt fence is
unchanged.

Fencing (the no-cross-app-leak contract):
- every child carries a fork-time nonce in $TONY_WARMPOOL_NONCE; the bind
  spec must echo it or the child refuses to become anything
  (EXIT_BIND_REJECTED) — a crossed pipe can never bind a foreign spec;
- before applying the spec env the child SCRUBS every task-identity and
  TONY_* variable inherited from the pool parent, so no stale app-A
  state (tokens, trace ids, cluster specs) survives into app B's bind;
- a lease is one-shot: a leased child is never returned to the pool, and
  a child found dead at lease time is evicted, never reused — the caller
  falls back to a cold spawn (the task does not fail).

The pool is deliberately backend-side (not scheduler-side): elastic grow
slots and autoscaler replicas go through the same
`LocalClusterBackend.launch_container`, so they lease warm processes for
free.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field

LOG = logging.getLogger(__name__)

WARM_READY_LINE = "WARM-READY"
# bind-spec refused: nonce mismatch / unparsable spec — the child was
# asked to become something its own pool never leased it for
EXIT_BIND_REJECTED = 97

# env vars scrubbed before a bind spec's env is applied: everything that
# identifies a task/application. The spec then provides the new app's
# values — identical to what a cold-spawned container would see.
_IDENTITY_ENV = (
    "JOB_NAME", "TASK_INDEX", "TASK_NUM", "IS_CHIEF", "SESSION_ID",
    "AM_HOST", "AM_PORT", "METRICS_RPC_PORT", "CONTAINER_ID", "APP_ID",
    "ATTEMPT_NUMBER", "NUM_AM_RETRIES", "TASK_ATTEMPT", "SPEC_GENERATION",
    "TASK_COMMAND", "MODEL_PARAMS", "CLUSTER_SPEC", "TF_CONFIG", "TB_PORT",
    "SERVING_PORT",
)


# ---------------------------------------------------------------------------
# child side: python -m tony_tpu_torch.cluster.warmpool
# ---------------------------------------------------------------------------

def _scrub_task_env() -> None:
    """Remove every inherited task-identity / TONY_* variable (the
    attempt-fence half the child owns: stale app-A env must never leak
    into the app-B bind; the spec env re-supplies the fresh values)."""
    for key in list(os.environ):
        if key.startswith("TONY_") or key in _IDENTITY_ENV:
            del os.environ[key]


def _redirect(path: str, fileno: int) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, fileno)
    os.close(fd)


def _run_entry(spec: dict) -> int:
    entry = spec.get("entry", "executor")
    if entry == "executor":
        from tony_tpu_torch.executor.__main__ import main as executor_main
        return int(executor_main() or 0)
    if entry == "script":
        # bench/test harness entry: load a module by path and call one
        # of its functions with the spec argv (bench.py cp_pool_main)
        import importlib.util
        mod_spec = importlib.util.spec_from_file_location(
            "_tony_warm_script", spec["path"])
        module = importlib.util.module_from_spec(mod_spec)
        sys.argv = list(spec.get("argv") or [spec["path"]])
        mod_spec.loader.exec_module(module)
        rv = getattr(module, spec["func"])()
        return int(rv or 0)
    print(f"warmpool: unknown entry {entry!r}", file=sys.stderr, flush=True)
    return EXIT_BIND_REJECTED


def warm_child_main() -> int:
    """Pre-import, announce readiness, block for the one-shot bind."""
    from tony_tpu_torch import constants as C

    # the whole point: pay the executor-stack import (rpc, conf,
    # observability, executor) BEFORE the application exists
    import tony_tpu_torch.executor.task_executor  # noqa: F401

    nonce = os.environ.get(C.WARMPOOL_NONCE, "")
    print(WARM_READY_LINE, flush=True)
    line = sys.stdin.readline()
    if not line.strip():
        return 0   # pool retirement (TTL/stop): EOF, exit clean
    try:
        spec = json.loads(line)
    except ValueError:
        print("warmpool: unparsable bind spec", file=sys.stderr, flush=True)
        return EXIT_BIND_REJECTED
    if not nonce or spec.get("nonce") != nonce:
        print("warmpool: bind spec nonce mismatch — refusing bind",
              file=sys.stderr, flush=True)
        return EXIT_BIND_REJECTED
    cwd = spec.get("cwd")
    if cwd:
        os.makedirs(cwd, exist_ok=True)
        os.chdir(cwd)
    # stdout/stderr go where a cold container's would (the backend's
    # stdout/stderr files); absent paths keep the inherited pipe — the
    # bench pool parent reads CP-POOL-* lines from it
    if spec.get("stdout"):
        _redirect(spec["stdout"], 1)
    if spec.get("stderr"):
        _redirect(spec["stderr"], 2)
    _scrub_task_env()
    os.environ.update({str(k): str(v)
                       for k, v in (spec.get("env") or {}).items()})
    return _run_entry(spec)


# ---------------------------------------------------------------------------
# pool side (AM / bench process)
# ---------------------------------------------------------------------------

@dataclass
class _WarmProc:
    proc: subprocess.Popen
    nonce: str
    born: float
    ready: threading.Event = field(default_factory=threading.Event)


class WarmExecutorPool:
    """Lease-based pool of warm `python -m tony_tpu_torch.cluster.warmpool`
    children. `lease_and_bind` pops a ready live child, writes the bind
    spec, and returns its Popen (which slots into the backend's waiter
    machinery exactly like a cold `subprocess.Popen`); None = miss, the
    caller cold-spawns. Instrumented on the shared metrics registry:
    tony_warmpool_lease_total{outcome}, tony_warmpool_evictions_total
    {reason}, tony_warmpool_ready, tony_warmpool_lease_seconds."""

    def __init__(self, size: int, ttl_ms: int = 300_000, tracer=None):
        self.size = max(1, int(size))
        self.ttl_sec = max(0.0, float(ttl_ms) / 1000.0)
        self.tracer = tracer   # optional SpanRecorder (lease spans)
        self._idle: list[_WarmProc] = []
        self._spawning = 0
        self._lock = threading.Lock()
        self._stopping = False
        from tony_tpu_torch.observability.metrics import REGISTRY
        self._registry = REGISTRY

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        for _ in range(self.size):
            self._spawn_async()

    def stop(self) -> None:
        self._stopping = True
        with self._lock:
            idle, self._idle = self._idle, []
        for rec in idle:
            self._retire(rec, reason="stop")
        self._set_ready_gauge()

    # -- spawning ------------------------------------------------------
    def _spawn_async(self) -> None:
        with self._lock:
            if self._stopping:
                return
            if len(self._idle) + self._spawning >= self.size:
                return
            self._spawning += 1
        threading.Thread(target=self._spawn_one, daemon=True,
                         name="warmpool-spawn").start()

    def _spawn_one(self) -> None:
        from tony_tpu_torch import constants as C
        nonce = uuid.uuid4().hex
        env = dict(os.environ)
        env[C.WARMPOOL_NONCE] = nonce
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tony_tpu_torch.cluster.warmpool"],
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True, start_new_session=True)
        except OSError:
            LOG.exception("warmpool: spawn failed")
            with self._lock:
                self._spawning -= 1
            return
        rec = _WarmProc(proc=proc, nonce=nonce, born=time.monotonic())

        def _await_ready():
            # exactly ONE readline: the child writes nothing further
            # until bound, and post-bind output (bench CP-POOL lines)
            # must stay in proc.stdout for the lessee's reader
            line = proc.stdout.readline() if proc.stdout else ""
            if line.strip() == WARM_READY_LINE:
                rec.ready.set()
                self._set_ready_gauge()
            else:
                LOG.warning("warmpool: child pid %d died before ready",
                            proc.pid)
                self._evict(rec, reason="dead")

        with self._lock:
            self._spawning -= 1
            if self._stopping:
                pass   # retire below, outside the lock
            else:
                self._idle.append(rec)
        if self._stopping:
            self._retire(rec, reason="stop")
            return
        threading.Thread(target=_await_ready, daemon=True,
                         name="warmpool-ready").start()

    # -- leasing -------------------------------------------------------
    def lease_and_bind(self, env: dict, cwd: str | None = None,
                       stdout_path: str | None = None,
                       stderr_path: str | None = None,
                       entry: str = "executor",
                       script_path: str | None = None,
                       script_func: str | None = None,
                       argv: list[str] | None = None,
                       ready_timeout: float = 5.0):
        """Lease one warm child and bind it to a container. Returns the
        bound Popen or None (pool empty / every candidate dead — caller
        cold-spawns; the task never fails on a pool miss)."""
        t0 = time.monotonic()
        span = (self.tracer.start("warmpool_lease") if self.tracer
                else None)
        outcome = "miss"
        proc = None
        try:
            while True:
                rec = self._pop_candidate(ready_timeout)
                if rec is None:
                    self._registry.counter("tony_warmpool_lease_total",
                                           outcome="miss").inc()
                    return None
                if rec.proc.poll() is not None:
                    self._evict(rec, reason="dead")
                    self._registry.counter("tony_warmpool_lease_total",
                                           outcome="dead").inc()
                    continue
                spec = {"nonce": rec.nonce, "entry": entry, "env": env,
                        "cwd": cwd, "stdout": stdout_path,
                        "stderr": stderr_path}
                if entry == "script":
                    spec.update({"path": script_path, "func": script_func,
                                 "argv": argv or []})
                try:
                    rec.proc.stdin.write(
                        json.dumps(spec, separators=(",", ":")) + "\n")
                    rec.proc.stdin.flush()
                    rec.proc.stdin.close()
                except (BrokenPipeError, OSError, ValueError):
                    # died mid-lease: evict, try the next warm child —
                    # exhausting the pool returns None (cold fallback)
                    self._evict(rec, reason="dead")
                    self._registry.counter("tony_warmpool_lease_total",
                                           outcome="dead").inc()
                    continue
                outcome = "hit"
                self._registry.counter("tony_warmpool_lease_total",
                                       outcome="hit").inc()
                self._registry.summary(
                    "tony_warmpool_lease_seconds").observe(
                        time.monotonic() - t0)
                self._spawn_async()   # refill the leased slot
                self._set_ready_gauge()
                proc = rec.proc
                return proc
        finally:
            if span is not None:
                self.tracer.end(span, "OK" if proc is not None else "ERROR",
                                attrs={"outcome": outcome})

    def _pop_candidate(self, ready_timeout: float):
        """Oldest ready, live, unexpired child — expired ones retire on
        the way (the TTL sweep rides the lease path)."""
        while True:
            with self._lock:
                if not self._idle:
                    return None
                rec = self._idle.pop(0)
            if self.ttl_sec and time.monotonic() - rec.born > self.ttl_sec:
                self._retire(rec, reason="ttl")
                self._spawn_async()
                continue
            if not rec.ready.wait(timeout=ready_timeout):
                # never came up — treat as dead, never hand out a child
                # that hasn't finished its imports
                self._evict(rec, reason="dead")
                continue
            return rec

    def sweep(self) -> None:
        """Retire expired/dead idle children and refill."""
        with self._lock:
            idle, self._idle = self._idle, []
        for rec in idle:
            if rec.proc.poll() is not None:
                self._evict(rec, reason="dead")
            elif self.ttl_sec and time.monotonic() - rec.born > self.ttl_sec:
                self._retire(rec, reason="ttl")
            else:
                with self._lock:
                    self._idle.append(rec)
        for _ in range(self.size):
            self._spawn_async()
        self._set_ready_gauge()

    # -- eviction ------------------------------------------------------
    def _retire(self, rec: _WarmProc, reason: str) -> None:
        """Clean retirement: close stdin (EOF → the child's readline
        returns empty → clean exit 0), escalate if it lingers."""
        try:
            if rec.proc.stdin:
                rec.proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass
        try:
            rec.proc.wait(timeout=2)
        except subprocess.TimeoutExpired:
            rec.proc.kill()
        self._close_pipes(rec)
        self._registry.counter("tony_warmpool_evictions_total",
                               reason=reason).inc()

    def _evict(self, rec: _WarmProc, reason: str) -> None:
        """Hard eviction of a dead/poisoned child: kill outright, never
        reuse (a half-imported or crashed warm proc must not serve a
        lease)."""
        with self._lock:
            if rec in self._idle:
                self._idle.remove(rec)
        try:
            rec.proc.kill()
        except (ProcessLookupError, OSError):
            pass
        try:
            rec.proc.wait(timeout=2)
        except subprocess.TimeoutExpired:
            pass
        self._close_pipes(rec)
        self._registry.counter("tony_warmpool_evictions_total",
                               reason=reason).inc()
        self._set_ready_gauge()
        if not self._stopping:
            self._spawn_async()

    @staticmethod
    def _close_pipes(rec: _WarmProc) -> None:
        for f in (rec.proc.stdin, rec.proc.stdout):
            try:
                if f:
                    f.close()
            except (BrokenPipeError, OSError):
                pass

    def _set_ready_gauge(self) -> None:
        with self._lock:
            n = sum(1 for r in self._idle
                    if r.ready.is_set() and r.proc.poll() is None)
        self._registry.gauge("tony_warmpool_ready").set(n)

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._idle
                       if r.ready.is_set() and r.proc.poll() is None)

    def wait_ready(self, n: int = 0, timeout: float = 30.0) -> bool:
        """Block until `n` (default: pool size) children are ready —
        bench/tests pre-warm with this so the measured window starts
        with a genuinely warm pool."""
        n = n or self.size
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ready_count() >= n:
                return True
            time.sleep(0.05)
        return self.ready_count() >= n


def from_conf(conf, tracer=None) -> "WarmExecutorPool | None":
    """Build the pool `tony.warmpool.*` asks for (None when disabled)."""
    from tony_tpu_torch.conf import keys as K
    if not conf.get_bool(K.WARMPOOL_ENABLED, False):
        return None
    pool = WarmExecutorPool(
        size=conf.get_int(K.WARMPOOL_SIZE, 4),
        ttl_ms=conf.get_time_ms(K.WARMPOOL_TTL_MS, 300_000),
        tracer=tracer)
    pool.start()
    return pool


if __name__ == "__main__":
    sys.exit(warm_child_main())
