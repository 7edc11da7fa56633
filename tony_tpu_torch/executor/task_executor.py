"""TaskExecutor: runs inside each container and wraps the user process: the
port's copy of `tony_tpu/executor/task_executor.py`.

The AM (the JAX package's, unchanged) launches it as ``python -m
tony_tpu_torch.executor`` with the task's identity, its own address and
the frozen conf's path in the env. The lifecycle is the JAX executor's,
call for call:

- the TaskLogService comes up first (live tails and stack snapshots of
  this container, behind the task's token);
- localization (src zip, venv, resources; the content-addressed cache),
  then the rendezvous port (held with SO_REUSEPORT until the user process
  starts) and, for the chief, a TensorBoard port whose URL it registers;
- the gang barrier: `register_worker_spec` polled with a jittered
  backoff until the AM returns the full cluster spec; the time spent here
  and in localization goes to the user process as its goodput seed;
- the Heartbeater (start phase spread by task index; five consecutive
  failures put the executor into orphan mode: it polls the app dir for a
  recovered AM and re-registers, or fences its user process and exits);
- the framework's rendezvous env (`runtimes.py`), then the user command
  under bash, with the TaskMonitor pushing RSS and the card's duty cycle
  and memory (`cuda_metrics.py`) every metrics interval;
- generation bumps: a peer's relaunch stops only the user process; the
  survivor patches its held spec with the heartbeat-piggybacked diff (or
  refetches on the AM's verdict) and relaunches the command;
- drain, resize and profile asks riding the heartbeat response;
- the TEST_* fault hooks of the chaos harness, the lifecycle spans, and
  `_report`: the exit code with the flags and, for a failure, the
  classified and redacted diagnostics.

It imports no torch: the user process owns the card.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import TonyConfiguration
from tony_tpu_torch.executor.runtimes import render_framework_env
from tony_tpu_torch.executor.task_monitor import TaskMonitor
from tony_tpu_torch.rpc.client import (
    ClusterServiceClient, MetricsServiceClient,
)
from tony_tpu_torch.utils.common import (
    current_host, equal_jitter_backoff_sec, pick_free_port,
)
from tony_tpu_torch.utils.fs import unzip
from tony_tpu_torch.utils.localization import (
    fetch_remote_spec, localize_resource,
)
from tony_tpu_torch.utils.ports import reserve_port
from tony_tpu_torch.utils.shell import launch_shell, wait_or_kill

LOG = logging.getLogger(__name__)


def heartbeat_jitter_sec(task_index: int, interval_sec: float) -> float:
    """Deterministic start-phase offset for a task's heartbeater, spread
    low-discrepancy across indices (golden-ratio sequence): a barrier
    release would otherwise synchronize 1,024 heartbeats into the same
    1 s phase and hammer the AM with width-sized bursts forever."""
    return ((max(0, int(task_index)) * 0.6180339887498949) % 1.0) \
        * max(0.0, interval_sec)


def apply_spec_diff(spec: dict, changed: dict,
                    removed: Optional[dict] = None) -> dict:
    """Patch a held cluster spec with a generation-keyed diff
    ({jobtype: {index: host_port}} plus, for membership shrinks,
    {jobtype: [removed indices]}) — the executor-side half of the
    heartbeat-piggybacked spec-diff protocol. Removals apply first (the
    session only ever removes TRAILING slots, so surviving entries keep
    their indices); `changed` then rebinds/extends, so a grow's new
    indices append past the current width. Returns a NEW dict whose
    JSON render is bit-identical to the AM's full render at the diff's
    generation (same job order, same entry order by index)."""
    out = {job: list(entries) for job, entries in spec.items()}
    for job, idxs in (removed or {}).items():
        entries = out.get(job)
        if not entries:
            continue
        gone = {int(i) for i in idxs}
        entries = [e for i, e in enumerate(entries) if i not in gone]
        if entries:
            out[job] = entries
        else:
            del out[job]
    for job, updates in (changed or {}).items():
        entries = out.setdefault(job, [])
        for idx_s, host_port in updates.items():
            i = int(idx_s)
            while len(entries) <= i:
                entries.append("")
            entries[i] = host_port
    return out


def _tony_test_wedge() -> None:
    """TEST hook parking frame (TEST_TASK_WEDGE): the chaos harness
    wedges an executor's MAIN thread here forever so the AM's wedge
    autopsy has a recognizable blocking function to name in
    diagnostics.json — the e2e asserts this frame shows up there."""
    while True:
        time.sleep(0.25)


class Heartbeater(threading.Thread):
    """(reference: TaskExecutor.Heartbeater, TaskExecutor.java:330-370).

    Besides liveness, each heartbeat response carries the AM's current
    cluster-spec generation; `on_generation` lets the executor detect a
    peer's relaunch (generation bump) and re-enter the rendezvous barrier
    without its container being restarted."""

    def __init__(self, client: ClusterServiceClient, task_id: str,
                 interval_sec: float, on_fatal=None, task_attempt: int = -1,
                 on_generation=None, silent: bool = False,
                 on_profile=None, log_addr: str = "", on_drain=None,
                 jitter_sec: float = 0.0, gen_source=None,
                 on_spec_diff=None, on_spec_ready=None,
                 on_spec_refetch=None, on_resize=None, ack_source=None,
                 failure_budget: int = C.MAX_CONSECUTIVE_FAILED_HEARTBEATS,
                 on_orphaned=None):
        super().__init__(name="heartbeater", daemon=True)
        self._client = client
        self._task_id = task_id
        self._task_attempt = task_attempt
        # start-phase desynchronization: slept once before the first ping
        # (deterministic from the task index — see heartbeat_jitter_sec)
        self._jitter_sec = max(0.0, jitter_sec)
        # reports the generation of the spec this executor currently
        # holds; the AM piggybacks the matching spec DIFF on the response
        self._gen_source = gen_source
        self._on_spec_diff = on_spec_diff
        self._on_spec_ready = on_spec_ready
        self._on_spec_refetch = on_spec_refetch
        # consecutive-failure self-destruct threshold (the reference's
        # MAX_CONSECUTIVE_FAILED_HEARTBEATS=5); overridable so harnesses
        # hosting many executors per process can tolerate load-induced
        # heartbeat timeouts without one executor's os._exit taking the
        # whole pool down
        self._failure_budget = max(1, int(failure_budget))
        # this executor's TaskLogService host:port, gossiped to the AM on
        # every heartbeat (the live-tail read surface; observability/logs)
        self._log_addr = log_addr
        self._interval = interval_sec
        self._on_fatal = on_fatal  # kill the user process before we die
        # AM-crash survivability: when the budget exhausts, give the
        # executor a chance to go ORPHAN (user process untouched,
        # backoff-poll staging for a recovered AM, re-register) instead
        # of self-destructing. The hook returns True once a (new or
        # thawed) AM has adopted us — the failure counter resets and
        # heartbeating resumes against the swapped client; False means
        # the orphan grace expired and the executor already self-fenced
        # through the TERM→checkpoint→KILL ladder.
        self._on_orphaned = on_orphaned
        self._on_generation = on_generation
        # checkpoint-then-evict: a preemption drain ask piggybacked on
        # the heartbeat response (the AM never opens a connection TO a
        # container — asks always ride this channel)
        self._on_drain = on_drain
        # elastic gang resize: the quiesce/release ask rides the same
        # channel; ack_source reports the newest resize id this executor
        # has fully quiesced for (user process exited, emergency
        # checkpoint committed) back to the AM on every ping
        self._on_resize = on_resize
        self._ack_source = ack_source
        # heartbeat-piggybacked on-demand profiler ask (observability/
        # perf.py): the executor relays it to the trainer via a cwd file
        self._on_profile = on_profile
        self._stop = threading.Event()
        # TEST hook: skip the first N heartbeats to simulate missed HBs
        # (TaskExecutor.java:334-344)
        self._skip_remaining = int(
            os.environ.get(C.TEST_TASK_EXECUTOR_NUM_HB_MISS, "0"))
        # TEST hook: permanently silent heartbeater (chaos harness wedge —
        # the user process keeps running while the AM sees only silence)
        self._silent = silent
        self._consecutive_failures = 0

    def stop(self) -> None:
        self._stop.set()

    def swap_client(self, client: ClusterServiceClient) -> None:
        """Re-point heartbeats at a recovered AM. Called from the orphan
        hook, which runs ON this thread — no lock needed."""
        self._client = client

    def run(self) -> None:
        # stall-watchdog beacon (observability/profiler.py): a heartbeater
        # that stops iterating — wedged RPC stack, not a crashed thread —
        # is exactly the loop whose silence kills the task from the AM's
        # point of view, so its progress is worth watching locally too
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon(f"heartbeater:{self._task_id}",
                                 self._interval)
        try:
            self._run_loop(beacon)
        finally:
            # a STOPPED heartbeater is idle, not stalled — park the
            # beacon so its age stops counting against the watchdog
            beacon.idle()

    def _run_loop(self, beacon) -> None:
        if self._jitter_sec and self._stop.wait(self._jitter_sec):
            return
        while not self._stop.wait(self._interval):
            beacon.beat()
            if self._silent:
                continue
            if self._skip_remaining > 0:
                self._skip_remaining -= 1
                LOG.warning("TEST hook: skipping heartbeat (%d more)",
                            self._skip_remaining)
                continue
            try:
                held_gen = int(self._gen_source()) if self._gen_source else -1
                ack = int(self._ack_source()) if self._ack_source else 0
                resp = self._client.task_executor_heartbeat(
                    self._task_id, self._task_attempt,
                    log_addr=self._log_addr,
                    spec_generation=held_gen,
                    resize_ack=ack)
                self._consecutive_failures = 0
                generation = (resp or {}).get("spec_generation")
                if generation and self._on_generation is not None:
                    self._on_generation(int(generation))
                # generation-keyed spec diff / full-refetch verdict / the
                # barrier-ready hint — the coalesced control plane's whole
                # survivor-side re-rendezvous rides these three fields
                spec_diff = (resp or {}).get("spec_diff")
                if spec_diff and self._on_spec_diff is not None:
                    self._on_spec_diff(spec_diff)
                if (resp or {}).get("spec_refetch") \
                        and self._on_spec_refetch is not None:
                    self._on_spec_refetch()
                if (resp or {}).get("spec_ready") \
                        and self._on_spec_ready is not None:
                    self._on_spec_ready()
                profile_req = (resp or {}).get("profile_request")
                if profile_req and self._on_profile is not None:
                    self._on_profile(profile_req)
                drain = (resp or {}).get("drain")
                if drain and self._on_drain is not None:
                    self._on_drain(drain)
                resize = (resp or {}).get("resize")
                if resize and self._on_resize is not None:
                    self._on_resize(resize)
            except Exception:  # noqa: BLE001
                self._consecutive_failures += 1
                LOG.warning("heartbeat failed (%d consecutive)",
                            self._consecutive_failures)
                if self._consecutive_failures >= self._failure_budget:
                    if self._on_orphaned is not None:
                        LOG.error("%d consecutive heartbeat failures — the "
                                  "AM is unreachable; entering orphan mode",
                                  self._consecutive_failures)
                        adopted = False
                        try:
                            adopted = bool(self._on_orphaned())
                        except Exception:  # noqa: BLE001
                            LOG.exception("orphan recovery hook failed")
                        if adopted:
                            self._consecutive_failures = 0
                            continue
                    # no orphan hook (or the grace expired and the hook
                    # already self-fenced the user process through the
                    # TERM→checkpoint→KILL ladder): take the user process
                    # down with us — there is no NodeManager to reap the
                    # tree here — then exit (TaskExecutor.java:358-368)
                    LOG.error("%d consecutive heartbeat failures — exiting",
                              self._consecutive_failures)
                    if self._on_fatal is not None:
                        try:
                            self._on_fatal()
                        except Exception:  # noqa: BLE001
                            LOG.debug("on_fatal hook failed before exit",
                                      exc_info=True)
                    os._exit(C.EXIT_HEARTBEAT_FAILURE)


class TaskExecutor:
    # heartbeat self-destruct budget handed to the Heartbeater; a class
    # attr so multi-executor-per-process harnesses (bench --cp-pool) can
    # widen it — in production each executor owns its process and the
    # reference's 5-strike exit is exactly right
    HB_FAILURE_BUDGET = C.MAX_CONSECUTIVE_FAILED_HEARTBEATS

    def __init__(self, env: Optional[dict] = None,
                 client: Optional[ClusterServiceClient] = None,
                 metrics_client: Optional[MetricsServiceClient] = None):
        """`client`/`metrics_client` let a harness hosting many executors
        in one process (bench --cp-pool) share gRPC channels — a python
        process cannot drive 2 x width independent channels. Production
        executors own their process and build their own (default)."""
        e = env if env is not None else os.environ
        # -- init_configs (TaskExecutor.java:255-293) ----------------------
        self.job_name = e[C.JOB_NAME]
        self.task_index = int(e[C.TASK_INDEX])
        self.task_num = int(e.get(C.TASK_NUM, "1"))
        self.is_chief = e.get(C.IS_CHIEF, "false").lower() == "true"
        self.session_id = int(e.get(C.SESSION_ID, "0"))
        self.task_attempt = int(e.get(C.TASK_ATTEMPT, "0"))
        self.am_host = e[C.AM_HOST]
        self.am_port = int(e[C.AM_PORT])
        self.metrics_port = int(e.get(C.METRICS_RPC_PORT, self.am_port))
        self.task_command = e.get(C.TASK_COMMAND, "")
        self.app_dir = e.get(C.TONY_APP_DIR, ".")
        conf_path = e.get(C.TONY_CONF_PATH, "")
        if conf_path and not os.path.exists(conf_path):
            # off-host container: the client's app dir isn't mounted here —
            # localize the frozen conf through the staging store instead
            # (the reference localized tony-final.xml into every container,
            # TaskExecutor.java:269)
            conf_uri = e.get(C.TONY_CONF_URI, "")
            if conf_uri:
                from tony_tpu_torch.storage.store import fetch_uri
                conf_path = fetch_uri(
                    conf_uri, os.path.join(os.getcwd(), C.TONY_FINAL_CONF))
        self.conf = (TonyConfiguration.read(conf_path)
                     if conf_path and os.path.exists(conf_path)
                     else TonyConfiguration())
        self.framework = self.conf.get_str(K.APPLICATION_FRAMEWORK, "jax")
        self.hb_interval_sec = self.conf.get_time_ms(
            K.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1000.0
        self.metrics_interval_sec = self.conf.get_time_ms(
            K.TASK_METRICS_INTERVAL_MS, 5000) / 1000.0
        self.registration_timeout_sec = self.conf.get_int(
            K.TASK_REGISTRATION_TIMEOUT_SEC, 300)
        # heartbeat self-destruct budget: an explicitly configured
        # tony.task.hb-failure-budget wins; otherwise the class attr
        # stands so multi-executor harnesses (bench --cp-pool) can still
        # widen it process-wide
        if self.conf.source_of(K.TASK_HB_FAILURE_BUDGET) \
                not in ("default", "unset"):
            self.HB_FAILURE_BUDGET = max(1, self.conf.get_int(
                K.TASK_HB_FAILURE_BUDGET,
                C.MAX_CONSECUTIVE_FAILED_HEARTBEATS))
        # orphan mode: how long a heartbeat-starved executor keeps the
        # user process alive while polling staging for a recovered AM
        # before self-fencing (TERM→emergency-checkpoint→KILL)
        self._orphan_grace_sec = self.conf.get_time_ms(
            K.AM_ORPHAN_GRACE_MS, 30_000) / 1000.0
        # TERM→KILL grace on every user-process termination path
        # (tony.task.term-grace-ms), sized to cover the trainer's
        # emergency checkpoint; proc.wait returns the moment the
        # process exits, so clean shutdowns never pay the full window
        self._term_grace_sec = self.conf.get_time_ms(
            K.TASK_TERM_GRACE_MS, 15_000) / 1000.0
        # checkpoint-then-evict drain state: set once when a preemption
        # ask arrives (heartbeat piggyback), read by the run loop to
        # report a PREEMPTED (not failed) result
        self._drain_requested = False
        self._drain_lock = threading.Lock()
        # elastic gang resize state (cluster/elastic.py): the newest
        # resize ask id this executor has acted on (one-shot TERM per
        # id), the id it has fully QUIESCED for (user process exited —
        # emergency checkpoint committed — gossiped back to the AM on
        # every heartbeat), whether this slot is a shrink victim being
        # released (the run loop then reports a `resized` terminal
        # result instead of re-entering the barrier), and the mesh
        # shape the current width implies (overrides the frozen conf's
        # TPU_MESH_SHAPE in every (re)launched user process env —
        # containers launched mid-resize get it via TONY_ELASTIC_MESH_SHAPE)
        self._resize_seen_id = 0      # guarded-by: _drain_lock
        self._resize_ack = 0
        self._resize_release = False
        self._mesh_override = e.get(C.ELASTIC_MESH_SHAPE) or None  # guarded-by: _drain_lock
        self.host = current_host()
        self.port = 0
        self.tb_port: Optional[int] = None
        self._port_reservation = None
        # security: the AM passes a per-task derived token via env (scoped
        # replacement for the reference's launch-context credential
        # duplication, ApplicationMaster.java:1137-1140); the task id rides
        # the call metadata so the AM can re-derive and verify
        from tony_tpu_torch.security.tokens import TOKEN_ENV
        token = e.get(TOKEN_ENV) or None
        task_auth = self.task_id if token else None
        self._task_token = token
        self.client = client if client is not None else \
            ClusterServiceClient(self.am_host, self.am_port,
                                 auth_token=token,
                                 task_auth_id=task_auth)
        self.metrics_client = metrics_client if metrics_client is not None \
            else MetricsServiceClient(self.am_host, self.metrics_port,
                                      auth_token=token,
                                      task_auth_id=task_auth)
        self.heartbeater: Optional[Heartbeater] = None
        self.monitor: Optional[TaskMonitor] = None
        # set when an orphan re-attached to a recovered AM: the metrics
        # channel still dials the dead attempt's port (only relaunched
        # containers get the new one rendered into their env), so span
        # pushes are skipped rather than spent on a doomed retry ladder
        self._metrics_stale = False
        self._user_proc = None
        # lifecycle tracing (observability/trace.py): context arrives in
        # the env the AM rendered (parent = this attempt's AM task span);
        # finished spans piggyback on the metrics RPC
        from tony_tpu_torch.observability.trace import SpanRecorder
        self.tracer = SpanRecorder.from_env(e, task_id=self.task_id,
                                            attempt=self.task_attempt)
        # generation-aware re-rendezvous state: the spec generation the
        # running user process was launched with, the newest generation any
        # heartbeat has carried, and whether a newer generation (a peer's
        # relaunch) has requested a barrier re-entry
        self._spec_generation = 0
        self._latest_generation = 0
        self._respec_pending = False
        self._respec_lock = threading.Lock()
        # coalesced re-rendezvous: the spec this executor currently holds
        # and the newest heartbeat-piggybacked diff against it. A survivor
        # re-enters the gang by PATCHING its held spec with the diff —
        # zero register_worker_spec re-polls, zero full-spec re-fetches.
        self._cluster_spec: Optional[dict] = None
        self._pending_diff: Optional[dict] = None
        self._diff_event = threading.Event()
        # AM verdict: this executor's generation fell outside the diff
        # window — patching is impossible, fall back to a full fetch
        self._spec_refetch = False
        # barrier-ready hint piggybacked on heartbeats: lets the
        # registration poll back off exponentially and still fetch the
        # spec within ~one heartbeat of the gang completing
        self._spec_ready_event = threading.Event()
        self._test_kill_scheduled = False
        # live-log service (observability/logs.py): this executor serves
        # bounded offset-cursor reads over its own container stdout/stderr
        # files (the backend redirects both into the cwd); the AM proxies
        # operator tails to it. Bounds come from the frozen conf.
        self._log_tail_bytes = self.conf.get_int(K.LOGS_TAIL_BYTES, 65536)
        self._log_chunk_bytes = self.conf.get_int(K.LOGS_CHUNK_BYTES, 32768)
        self._diag_lines = self.conf.get_int(K.LOGS_DIAGNOSTICS_LINES, 200)
        self._log_server = None
        self._log_port = 0

    @property
    def task_id(self) -> str:
        return f"{self.job_name}:{self.task_index}"

    # ------------------------------------------------------------------
    # live-log service (observability/logs.py)
    # ------------------------------------------------------------------
    def _start_log_service(self) -> None:
        """Serve bounded log-chunk reads over this container's own
        stdout/stderr. With security on, the service requires this task's
        derived token — exactly the credential the AM can re-derive to
        authenticate its proxy reads; nothing new ships in the env."""
        try:
            from tony_tpu_torch.rpc.service import serve
            self._log_server, self._log_port = serve(
                log_handler=self, auth_token=self._task_token)
            LOG.info("task log service on port %d", self._log_port)
        except Exception:  # noqa: BLE001 — observability must not kill the task
            LOG.exception("could not start the task log service")
            self._log_server, self._log_port = None, 0

    def _stop_log_service(self) -> None:
        if self._log_server is not None:
            self._log_server.stop(grace=0.2)
            self._log_server = None

    @property
    def log_addr(self) -> str:
        return f"{self.host}:{self._log_port}" if self._log_port else ""

    def read_log(self, req: dict) -> dict:
        """TaskLogServiceHandler: one redacted chunk of stdout/stderr.
        Chunk size is capped at tony.logs.chunk-bytes no matter what the
        caller asks; a fresh cursor never reaches further back than
        tony.logs.tail-bytes — bounded memory on both ends."""
        from tony_tpu_torch.observability.logs import STREAMS, LogTail
        stream = str(req.get("stream", "stderr") or "stderr")
        if stream not in STREAMS:
            return {"error": f"unknown stream {stream!r}"}
        proc = self._user_proc
        final = proc is not None and proc.poll() is not None
        tail = LogTail(os.path.join(os.getcwd(), stream),
                       tail_bytes=self._log_tail_bytes,
                       chunk_bytes=self._log_chunk_bytes)
        chunk = tail.read_chunk(offset=int(req.get("offset", -1)),
                                max_bytes=int(req.get("max_bytes", 0) or 0),
                                final=final)
        chunk["stream"] = stream
        chunk["task_id"] = self.task_id
        return chunk

    def read_stacks(self, req: dict) -> dict:
        """TaskLogServiceHandler: redacted all-thread stack snapshot —
        the wedge-autopsy read surface, served next to read_log on the
        same token-authed server. It runs on a gRPC worker thread, so it
        answers even while the MAIN thread is parked in a wedged frame;
        the AM pulls it when liveliness expiry, a barrier timeout, or
        the orphan grace fires and folds it into diagnostics.json."""
        from tony_tpu_torch.observability.profiler import collect_thread_stacks
        return {
            "task_id": self.task_id,
            "attempt": self.task_attempt,
            "generated_ms": int(time.time() * 1000),
            "threads": collect_thread_stacks(),
        }

    def _failure_diagnostics(self, exit_code: int) -> dict:
        """Classified + redacted failure summary shipped with the
        execution result: exit/signal decoding, matched error signature,
        last tony.logs.diagnostics-lines lines per stream."""
        from tony_tpu_torch.observability.logs import (
            classify_container_failure,
        )
        try:
            diag = classify_container_failure(
                os.getcwd(), exit_code, self._diag_lines,
                tail_bytes=self._log_tail_bytes)
            diag["task_id"] = self.task_id
            diag["attempt"] = self.task_attempt
            return diag
        except Exception:  # noqa: BLE001 — diagnostics must not mask the exit
            LOG.exception("failed to build failure diagnostics")
            return {"exit_code": exit_code, "task_id": self.task_id,
                    "attempt": self.task_attempt}

    # ------------------------------------------------------------------
    def setup_ports(self) -> None:
        """Reserve this task's rendezvous port before registering it with the
        AM. The reference needed an SO_REUSEPORT helper so TF could rebind
        the pre-announced port (ReusablePort.java:149-235,
        reserve_reusable_port.py); `reserve_port` is the native equivalent —
        it holds the port with SO_REUSEPORT until the user process binds.
        Chief additionally reserves a TensorBoard port and registers its URL
        (TaskExecutor.java:83-95,311-319)."""
        self._port_reservation = reserve_port()
        self.port = self._port_reservation.port
        if self.is_chief:
            self.tb_port = pick_free_port()
            self.client.register_tensorboard_url(
                self.task_id, f"http://{self.host}:{self.tb_port}")

    def register_and_get_cluster_spec(self) -> Optional[dict]:
        """Gang barrier (TaskExecutor.java:295-309): start heartbeating, then
        poll register_worker_spec until every expected task has registered.
        Re-entrant: a generation bump (peer relaunch) sends the executor back
        here; the heartbeater keeps running across re-entries.

        The poll backs off exponentially while the gang fills (0.2 s
        doubling to ~1.6 s, phase-jittered by task index) — at width 1k a
        fixed 0.2 s cadence meant ~5k barrier polls/s against the AM —
        and the heartbeat-piggybacked spec_ready hint short-circuits the
        backoff so the completing spec is still fetched promptly."""
        if self.heartbeater is None:
            self.heartbeater = Heartbeater(
                self.client, self.task_id, self.hb_interval_sec,
                on_fatal=self._kill_user_proc,
                task_attempt=self.task_attempt,
                on_generation=self._on_generation,
                silent=self._hb_silent_for_testing(),
                on_profile=self._on_profile_request,
                log_addr=self.log_addr,
                on_drain=self._on_drain_request,
                on_resize=self._on_resize_request,
                ack_source=lambda: self._resize_ack,
                jitter_sec=heartbeat_jitter_sec(self.task_index,
                                                self.hb_interval_sec),
                gen_source=lambda: self._spec_generation,
                on_spec_diff=self._on_spec_diff,
                on_spec_ready=self._spec_ready_event.set,
                on_spec_refetch=self._on_spec_refetch,
                failure_budget=self.HB_FAILURE_BUDGET,
                on_orphaned=self._on_hb_orphaned)
            self.heartbeater.start()
        host_port = f"{self.host}:{self.port}"
        LOG.info("registering %s at %s (attempt %d)", self.task_id,
                 host_port, self.task_attempt)
        # deterministic per-task phase factor in [0.8, 1.2): decorrelates
        # same-length backoffs across the gang without an RNG
        phase = 0.8 + 0.4 * ((self.task_index * 0.6180339887498949) % 1.0)
        deadline = time.monotonic() + self.registration_timeout_sec
        interval, cap = 0.2, 1.6
        result = None
        while True:
            result = self.client.register_worker_spec(
                self.task_id, host_port, self.session_id,
                task_attempt=self.task_attempt, with_generation=True)
            if result is not None:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self._spec_ready_event.clear()
            self._spec_ready_event.wait(min(interval * phase, remaining))
            interval = min(cap, interval * 2)
        spec, generation = result
        with self._respec_lock:
            self._spec_generation = generation
            self._cluster_spec = spec
            # a bump observed mid-poll that is NEWER than the spec we just
            # got keeps the respec flag armed; anything older is already
            # satisfied by this spec
            self._respec_pending = self._latest_generation > generation
            # a diff the heartbeater delivered while this full fetch was
            # in flight is satisfied by the fetched spec unless it is
            # strictly newer; a stale one left behind would be applied by
            # a LATER respec and roll the held spec backwards
            pending = self._pending_diff
            if (pending is not None
                    and int(pending.get("generation", 0)) <= generation):
                self._pending_diff = None
            # likewise any refetch verdict: this WAS the full fetch
            self._spec_refetch = False
        return spec

    def _on_generation(self, generation: int) -> None:
        """Heartbeat-piggybacked spec generation: a bump past the launched
        generation means a peer was relaunched — stop only the user process
        and arm a barrier re-entry (the container and its localized
        resources stay alive)."""
        launched = 0
        kill = False
        with self._respec_lock:
            if generation > self._latest_generation:
                self._latest_generation = generation
            launched = self._spec_generation
            if (launched > 0 and generation > launched
                    and not self._respec_pending):
                self._respec_pending = True
                kill = True
        if kill:
            LOG.warning("cluster-spec generation %d > launched %d — a peer "
                        "was relaunched; re-entering gang rendezvous",
                        generation, launched)
            self._kill_user_proc()

    def _on_spec_diff(self, diff: dict) -> None:
        """Heartbeat-piggybacked generation-keyed spec diff: the AM saw
        this executor's held generation behind the current one and sent
        the changed entries. Stash it for the respec loop (which patches
        the held spec instead of re-fetching O(width) bytes) and make
        sure the re-entry is armed — the diff can arrive in the same
        response as the generation bump itself."""
        try:
            gen = int(diff.get("generation", 0) or 0)
        except (TypeError, ValueError):
            return
        if gen <= 0:
            return
        self._on_generation(gen)
        with self._respec_lock:
            if gen <= self._spec_generation:
                return  # stale diff (already applied a newer spec)
            pending = self._pending_diff
            if pending is None or gen >= int(pending.get("generation", 0)):
                self._pending_diff = diff
        self._diff_event.set()

    def _on_spec_refetch(self) -> None:
        """AM verdict: our generation fell outside the retained diff
        window — patching is impossible; the respec wait falls back to
        the full register_worker_spec fetch."""
        self._spec_refetch = True
        self._diff_event.set()

    def _await_respec_spec(self) -> Optional[dict]:
        """Survivor-side re-rendezvous via the diff channel: wait for the
        heartbeater to deliver the generation-keyed spec diff and patch
        the held spec with it. Returns the patched spec, or None to fall
        back to the full register_worker_spec poll (no live heartbeater,
        a silenced-for-testing one, an AM refetch verdict, or timeout).
        Survivors' registrations stay valid across a peer's relaunch, so
        this path re-enters the gang with ZERO barrier re-polls and
        O(changed) instead of O(width) bytes."""
        hb = self.heartbeater
        if (hb is None or not hb.is_alive() or hb._silent
                or self._cluster_spec is None):
            return None
        deadline = time.monotonic() + self.registration_timeout_sec
        while True:
            with self._respec_lock:
                diff = self._pending_diff
                self._pending_diff = None
                if (diff is not None and int(diff.get("generation", 0))
                        <= self._spec_generation):
                    # stale leftover (a newer spec was installed since it
                    # was stashed): applying it would downgrade the held
                    # generation and resurrect a dead peer address
                    diff = None
            if diff is not None:
                patched = apply_spec_diff(self._cluster_spec,
                                          diff.get("changed") or {},
                                          diff.get("removed") or {})
                gen = int(diff["generation"])
                with self._respec_lock:
                    self._spec_generation = gen
                    self._cluster_spec = patched
                    self._respec_pending = self._latest_generation > gen
                LOG.info("applied spec diff for generation %d (%d task(s) "
                         "changed) — re-joined the gang without re-fetching "
                         "the cluster spec", gen,
                         sum(len(v) for v in
                             (diff.get("changed") or {}).values()))
                return patched
            if self._spec_refetch:
                self._spec_refetch = False
                LOG.warning("AM says our spec generation is outside the "
                            "diff window — falling back to a full fetch")
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                LOG.warning("no spec diff arrived within %ds — falling "
                            "back to the rendezvous barrier poll",
                            self.registration_timeout_sec)
                return None
            if not hb.is_alive():
                return None
            self._diff_event.wait(min(1.0, remaining))
            self._diff_event.clear()

    def _on_profile_request(self, preq: dict) -> None:
        """Relay a heartbeat-piggybacked request_profile ask to the user
        process: write it atomically into the container cwd (the
        trainer's cwd), where ProfileCapture.poll() finds it at log
        boundaries. Resends of the same request id rewrite the same
        content — the trainer dedups by id, so this is idempotent."""
        rid = str(preq.get("request_id", "") or "")
        if not rid or rid == getattr(self, "_last_profile_request", ""):
            return
        self._last_profile_request = rid
        try:
            from tony_tpu_torch.events.history import write_json_atomic
            write_json_atomic(
                os.path.join(os.getcwd(), C.PROFILE_REQUEST_FILE),
                {"request_id": rid,
                 "num_steps": int(preq.get("num_steps", 1) or 1)})
            LOG.info("profile request %s relayed to the user process "
                     "(%s steps)", rid, preq.get("num_steps"))
        except OSError:
            LOG.exception("could not write the profile request file")

    def _on_drain_request(self, drain: dict) -> None:
        """Checkpoint-then-evict: the heartbeat response carried the
        AM's drain ask. One-shot: forward SIGTERM to the user process
        group on a helper thread (never the heartbeater — it must keep
        pinging so the AM sees this task alive while it drains), give
        it the grace window to emergency-checkpoint, then KILL anything
        still running. The run loop observes the exit with
        _drain_requested set and registers a PREEMPTED result instead
        of a failure."""
        with self._drain_lock:
            if self._drain_requested:
                return
            self._drain_requested = True
        # the AM sends the REMAINING grace; 0 means the deadline already
        # passed — TERM then immediate KILL, never the full local
        # default (a late-heartbeating task must not overshoot the
        # window every earlier task was held to). The conf default only
        # covers an ask that carries no window at all.
        raw = drain.get("grace_ms")
        grace = (self._term_grace_sec if raw is None
                 else max(0, int(raw)) / 1000.0)
        LOG.warning("preemption drain requested (%s): TERM→%0.fs "
                    "grace→KILL", drain.get("reason", "") or "unspecified",
                    grace)
        threading.Thread(
            target=lambda: self._terminate_user_proc(grace),
            name="drain", daemon=True).start()

    def _on_resize_request(self, ask: dict) -> None:
        """Elastic gang resize: the heartbeat response carried the AM's
        quiesce (or release) ask. One-shot PER RESIZE ID — the ask rides
        every heartbeat while the resize is in flight, and a rollback's
        corrective ask arrives under a fresh id, re-triggering the same
        TERM→grace→relaunch cycle against the reverted width.

        Survivors: arm a barrier re-entry (exactly the peer-relaunch
        respec path — container and localized resources stay alive),
        record the new width's mesh override, and TERM the user process
        group so the trainer commits its in-place emergency checkpoint
        inside the grace window. Once the process has exited the resize
        id is acked back to the AM on the next heartbeat — the signal
        the coordinator gates the membership change on, so a new-width
        trainer can never restore before the quiesce checkpoint
        committed.

        Shrink victims (`release: true`): same TERM→checkpoint drain,
        but the run loop then BREAKS and reports a `resized` terminal
        result instead of re-entering the barrier — the slot is leaving
        the gang."""
        try:
            rid = int(ask.get("id", 0) or 0)
        except (TypeError, ValueError):
            return
        if rid <= 0:
            return
        with self._drain_lock:
            if rid <= self._resize_seen_id:
                return
            self._resize_seen_id = rid
            mesh = ask.get("mesh_shape")
            if mesh is not None:
                self._mesh_override = str(mesh) or None
            release = bool(ask.get("release"))
            if release:
                self._resize_release = True
        raw = ask.get("grace_ms")
        grace = (self._term_grace_sec if raw is None
                 else max(0, int(raw)) / 1000.0)
        LOG.warning("elastic resize ask %d (%s): %s — TERM→%.0fs "
                    "grace→%s", rid,
                    ask.get("reason", "") or "unspecified",
                    "releasing this slot" if release
                    else "quiescing for re-rendezvous", grace,
                    "report" if release else "re-enter barrier")
        if not release:
            # survivor: the re-entry must be armed BEFORE the process
            # dies, so the run loop re-rendezvouses instead of probing
            # the (not yet bumped) generation and reporting a failure
            with self._respec_lock:
                self._respec_pending = True
        threading.Thread(
            target=lambda: self._quiesce_for_resize(rid, grace),
            name="resize-quiesce", daemon=True).start()

    def _quiesce_for_resize(self, rid: int, grace_sec: float) -> None:
        """Helper thread (never the heartbeater — it must keep pinging
        so the AM sees this task alive while it quiesces): TERM the
        user process group, wait out the emergency-checkpoint grace,
        then publish the ack the heartbeater gossips to the AM. With no
        process running (still at the barrier) the TERM is a no-op and
        the ack is immediate. Monotonic: a slow older quiesce thread
        finishing late must never roll the ack back over a newer
        (corrective-revert) resize id's."""
        self._terminate_user_proc(grace_sec)
        with self._drain_lock:
            self._resize_ack = max(self._resize_ack, rid)

    def _take_respec(self) -> bool:
        with self._respec_lock:
            pending = self._respec_pending
            self._respec_pending = False
            return pending

    def _generation_bumped_at_am(self) -> bool:
        """One synchronous probe of the AM's spec generation, used after a
        non-zero user exit that arrived with no respec pending: if a peer's
        relaunch already bumped the generation, this exit is collateral of
        the peer's death (failed collective), not an independent fault."""
        try:
            resp = self.client.task_executor_heartbeat(self.task_id,
                                                       self.task_attempt)
        except Exception:  # noqa: BLE001
            return False
        generation = int((resp or {}).get("spec_generation") or 0)
        if generation > self._spec_generation:
            LOG.warning("user exit coincides with spec generation bump "
                        "(%d > %d) — treating as a peer relaunch, not an "
                        "independent failure", generation,
                        self._spec_generation)
            return True
        return False

    def _hb_silent_for_testing(self) -> bool:
        """TEST_TASK_HB_SILENCE='type#index#attempt': this attempt's
        heartbeater never pings while the user process keeps running — the
        chaos harness's wedge, exercising the heartbeat-expiry relaunch
        path (attempt '*' matches every attempt)."""
        spec = os.environ.get(C.TEST_TASK_HB_SILENCE)
        if not spec:
            return False
        try:
            jtype, idx, attempt = spec.split("#")
            match = (jtype == self.job_name and int(idx) == self.task_index
                     and attempt in ("*", str(self.task_attempt)))
        except ValueError:
            LOG.error("bad TEST_TASK_HB_SILENCE spec: %r", spec)
            return False
        if match:
            LOG.warning("TEST hook: heartbeater silenced for attempt %d",
                        self.task_attempt)
        return match

    def _wedge_if_testing(self) -> None:
        """TEST_TASK_WEDGE='type#index#attempt': park THIS attempt's MAIN
        thread in _tony_test_wedge forever, right after the gang barrier
        completes (the log/stack service is already up) — the chaos
        harness's process wedge (attempt '*' matches every attempt). One
        direct heartbeat ships the stack service's address first:
        combined with TEST_TASK_HB_SILENCE the wedged attempt's own
        heartbeater never will, and without the address the AM's
        autopsy has nothing to pull."""
        spec = os.environ.get(C.TEST_TASK_WEDGE)
        if not spec:
            return
        try:
            jtype, idx, attempt = spec.split("#")
            match = (jtype == self.job_name and int(idx) == self.task_index
                     and attempt in ("*", str(self.task_attempt)))
        except ValueError:
            LOG.error("bad TEST_TASK_WEDGE spec: %r", spec)
            return
        if not match:
            return
        LOG.warning("TEST hook: wedging attempt %d in _tony_test_wedge",
                    self.task_attempt)
        try:
            self.client.task_executor_heartbeat(
                self.task_id, self.task_attempt, log_addr=self.log_addr)
        except Exception:  # noqa: BLE001 — the wedge must park regardless
            LOG.warning("wedge hook could not ship the stack-service addr")
        _tony_test_wedge()

    def _schedule_kill_if_testing(self) -> None:
        """TEST_TASK_KILL='type#index#after_ms#attempt': hard-crash THIS
        attempt's container after_ms after its user process launches,
        WITHOUT registering a result — the chaos harness's mid-run crash,
        exercising the container-completion relaunch path (attempt '*'
        matches every attempt). One-shot per executor: the respec loop may
        pass here again."""
        if self._test_kill_scheduled:
            return
        self._test_kill_scheduled = True
        spec = os.environ.get(C.TEST_TASK_KILL)
        if not spec:
            return
        try:
            jtype, idx, after_ms, attempt = spec.split("#")
            if (jtype != self.job_name or int(idx) != self.task_index
                    or attempt not in ("*", str(self.task_attempt))):
                return
            delay = int(after_ms) / 1000.0
        except ValueError:
            LOG.error("bad TEST_TASK_KILL spec: %r", spec)
            return

        def _die():
            LOG.error("TEST hook: TEST_TASK_KILL — hard-crashing attempt %d",
                      self.task_attempt)
            self._kill_user_proc()
            os._exit(C.EXIT_FAILURE)

        LOG.warning("TEST hook: attempt %d will hard-crash in %d ms",
                    self.task_attempt, int(after_ms))
        timer = threading.Timer(delay, _die)
        timer.daemon = True
        timer.start()

    def _skew_if_testing(self) -> None:
        """TEST_TASK_EXECUTOR_SKEW='type#index#ms': delay this specific task
        after the barrier, before exec (TaskExecutor.java:372-392)."""
        spec = os.environ.get(C.TEST_TASK_EXECUTOR_SKEW)
        if not spec:
            return
        try:
            jtype, idx, ms = spec.split("#")
            if jtype == self.job_name and int(idx) == self.task_index:
                LOG.warning("TEST hook: skewing %s by %s ms", self.task_id, ms)
                time.sleep(int(ms) / 1000.0)
        except ValueError:
            LOG.error("bad TEST_TASK_EXECUTOR_SKEW spec: %r", spec)

    def _step_delay_if_testing(self, env: dict) -> None:
        """TEST_TRAINER_STEP_DELAY='type#index#ms[#attempt]': render a
        per-step delay into THIS task's user-process env — the
        steady-state straggler injection (the hook above is startup-only;
        a one-shot sleep before exec can never exercise the windowed
        skew analyzer). Attempt-scoped like TEST_TASK_KILL, so a
        relaunch-then-clear chaos case can slow attempt 0 and let the
        replacement run healthy ('*' matches every attempt)."""
        spec = os.environ.get(C.TEST_TRAINER_STEP_DELAY)
        if not spec:
            return
        try:
            parts = spec.split("#")
            jtype, idx, ms = parts[0], parts[1], parts[2]
            attempt = parts[3] if len(parts) > 3 else "*"
            if (jtype != self.job_name or int(idx) != self.task_index
                    or attempt not in ("*", str(self.task_attempt))):
                return
            delay_ms = int(ms)
        except (ValueError, IndexError):
            LOG.error("bad TEST_TRAINER_STEP_DELAY spec: %r", spec)
            return
        LOG.warning("TEST hook: attempt %d runs with a %d ms per-step "
                    "delay", self.task_attempt, delay_ms)
        env[C.TRAINER_STEP_DELAY_MS] = str(delay_ms)

    # ------------------------------------------------------------------
    def localize_resources(self) -> None:
        """Materialize staged src/venv/resources into this container's cwd
        (Utils.extractResources + addResources, util/Utils.java:506-550,
        699-712): the src zip unpacks in place so `python train.py` resolves,
        the venv unpacks under ./venv, archives expand, files copy in."""
        # content-addressed cache (tony.localization.cache-*): remote
        # fetches happen once machine-wide, plain files hardlink out of
        # the digest store — the Nth job (and every elastic-grow slot)
        # skips the fetch entirely. None = disabled = per-container copy.
        from tony_tpu_torch.utils.localization import LocalizationCache
        self._loc_cache = LocalizationCache.from_conf(self.conf)
        src_zip, src_fetched = fetch_remote_spec(
            self.conf.get_str(K.SRC_DIR), os.getcwd(),
            cache=self._loc_cache)
        if src_zip and src_zip.endswith(".zip") and os.path.exists(src_zip):
            unzip(src_zip, os.getcwd())
            if src_fetched:
                os.remove(src_zip)
        venv = self.conf.get_str(K.PYTHON_VENV)
        if venv:
            path, venv_fetched = fetch_remote_spec(venv.split("#", 1)[0],
                                                   os.getcwd(),
                                                   cache=self._loc_cache)
            if path and path.endswith(".zip") and os.path.exists(path):
                unzip(path, os.path.join(os.getcwd(), "venv"))
                if venv_fetched:
                    os.remove(path)
        specs = (self.conf.get_strings(K.resources_key(self.job_name))
                 + self.conf.get_strings(K.CONTAINERS_RESOURCES))
        for spec in specs:
            try:
                localize_resource(spec, os.getcwd(), cache=self._loc_cache)
            except FileNotFoundError:
                LOG.error("resource missing at localization time: %s", spec)
                raise

    def run(self) -> int:
        """Full executor lifecycle; returns the user process exit code
        (TaskExecutor.main, TaskExecutor.java:211-253).

        The inner loop is the generation-aware re-rendezvous: when a peer is
        relaunched the AM bumps the cluster-spec generation, this executor
        stops only its user process, re-enters the gang barrier, and
        relaunches the user command against the replacement's host:port —
        the container and its localized resources stay alive."""
        # goodput seed: the phases THIS process owns (localization,
        # barrier wait) are handed to the user process so the trainer's
        # single per-task ledger covers them (observability/perf.py)
        self._goodput_seed = {"localization": 0.0, "rendezvous_wait": 0.0}
        # the live-tail surface comes up FIRST: a task stuck in
        # localization or at the barrier is exactly the one an operator
        # needs to tail
        self._start_log_service()
        loc_t0 = time.monotonic()
        loc_span = self.tracer.start("executor_localization")
        ok = False
        try:
            self.localize_resources()
            ok = True
        finally:
            cache = getattr(self, "_loc_cache", None)
            self.tracer.end(loc_span, "OK" if ok else "ERROR", attrs={
                "cache_hits": cache.hits if cache else 0,
                "cache_misses": cache.misses if cache else 0,
            })
        self._goodput_seed["localization"] = time.monotonic() - loc_t0
        self.setup_ports()
        try:
            barrier_t0 = time.monotonic()
            barrier_span = self.tracer.start("rendezvous_wait")
            cluster_spec = self.register_and_get_cluster_spec()
            self.tracer.end(barrier_span,
                            "OK" if cluster_spec is not None else "ERROR")
            self._goodput_seed["rendezvous_wait"] += (
                time.monotonic() - barrier_t0)
            self._push_spans()
            if cluster_spec is None:
                LOG.error("gang rendezvous timed out after %ds",
                          self.registration_timeout_sec)
                # flagged as a barrier timeout: an allocation problem, not
                # a task fault — the AM excludes it from task relaunch
                self._report(C.EXIT_RENDEZVOUS_TIMEOUT,
                             barrier_timeout=True)
                return C.EXIT_RENDEZVOUS_TIMEOUT
            timeout_ms = self.conf.get_time_ms(K.APPLICATION_TIMEOUT, 0)
            rendezvous_gave_up = False
            while True:
                # wedge AFTER the barrier: the task is registered (its
                # liveliness entry exists) and the gang proceeds, so the
                # AM's heartbeat-expiry autopsy — not the registration
                # deadline — is what catches the park
                self._wedge_if_testing()
                LOG.info("cluster spec (generation %d): %s",
                         self._spec_generation, cluster_spec)
                env = render_framework_env(self.framework, cluster_spec,
                                           self.job_name, self.task_index,
                                           self.conf)
                env[C.JOB_NAME] = self.job_name
                env[C.TASK_INDEX] = str(self.task_index)
                env[C.TASK_NUM] = str(self.task_num)
                env[C.IS_CHIEF] = str(self.is_chief).lower()
                env[C.TASK_ATTEMPT] = str(self.task_attempt)
                env[C.SPEC_GENERATION] = str(self._spec_generation)
                # elastic resize: the current width's mesh shape wins
                # over the frozen conf's TPU_MESH_SHAPE (delivered on
                # the resize ask for survivors, via container env for
                # tasks launched mid-resize)
                with self._drain_lock:
                    mesh_override = self._mesh_override
                if mesh_override:
                    env[C.TPU_MESH_SHAPE] = mesh_override
                # checkpoint retention knob for the trainer's GC
                # (tony.checkpoint.keep; train/checkpoint.py prunes
                # committed steps past it after each commit)
                env[C.CHECKPOINT_KEEP] = str(
                    self.conf.get_int(K.CHECKPOINT_KEEP, 3))
                if self.tb_port is not None:
                    env[C.TB_PORT] = str(self.tb_port)
                self._skew_if_testing()
                self._step_delay_if_testing(env)
                # hand the reserved port over to the user process right
                # before exec (TaskExecutor.java:227-235 release-or-keep
                # logic); re-rendezvous keeps the SAME host:port, the
                # relaunched user process simply rebinds it
                self._release_port_reservation()
                # the chaos kill clock starts at user-process launch, not
                # executor boot: a "crash after N ms mid-run" must not fire
                # while the gang is still at the barrier, or the injected
                # timing (peers running when the victim dies) is lost
                self._schedule_kill_if_testing()
                # user-process span: the trace context rendered into the
                # child env parents trainer-side spans under it
                proc_span = self.tracer.start(
                    "user_process",
                    attrs={"generation": self._spec_generation})
                env.update(self.tracer.env(proc_span))
                import json as _json
                env[C.TONY_GOODPUT_SEED] = _json.dumps(
                    {k: round(v, 4)
                     for k, v in self._goodput_seed.items()})
                exit_code = self._execute(env, timeout_ms / 1000.0)
                self.tracer.end(proc_span,
                                "OK" if exit_code == 0 else "ERROR",
                                attrs={"exit_code": exit_code})
                respec = self._take_respec()
                if self._drain_requested:
                    # checkpoint-then-evict: the user process was TERMed
                    # on the AM's drain ask and (a Trainer) committed its
                    # emergency checkpoint — this exit is the drain
                    # completing, never a fault and never a re-rendezvous
                    LOG.info("user process drained for preemption "
                             "(rc=%d)", exit_code)
                    break
                if self._resize_release:
                    # elastic shrink victim: the slot is leaving the
                    # gang — the emergency checkpoint is committed, so
                    # report a `resized` terminal result (never a fault,
                    # never a re-rendezvous) and let the AM remove the
                    # slot and stop this container
                    LOG.info("user process released for elastic shrink "
                             "(rc=%d)", exit_code)
                    break
                if not respec and exit_code != 0:
                    # a dying peer can take this task's collectives down
                    # BEFORE the next heartbeat delivers the AM's
                    # generation bump — probe once so the collateral exit
                    # re-rendezvouses instead of reporting a failure that
                    # would burn this healthy task's own attempt budget
                    # (and, gang-wide, replay the full-gang teardown this
                    # layer exists to avoid)
                    respec = self._generation_bumped_at_am()
                if not respec:
                    break
                LOG.warning("user process stopped for re-rendezvous "
                            "(rc=%d); re-entering the barrier", exit_code)
                # the wait for the replacement peer is governed by the
                # AM's re-armed allocation deadline, not the local poll
                # timeout: reporting EXIT_FAILURE on the first timeout
                # would relaunch every healthy survivor exactly when
                # allocation is starved. Bounded, though: an executor the
                # AM keeps answering but never accepts (a superseded
                # attempt that outlived its container stop, or a
                # replacement unplaceable beyond the AM's own deadline)
                # must not poll the AM for the rest of the application's
                # life. A dead AM is covered by the heartbeater's
                # self-destruct.
                cluster_spec = None
                barrier_t0 = time.monotonic()
                barrier_span = self.tracer.start(
                    "rendezvous_wait", attrs={"re_entry": True})
                # coalesced path first: this survivor's registration is
                # still valid at the AM, so the replacement's address
                # arrives as a heartbeat-piggybacked diff — no barrier
                # re-poll, no O(width) re-fetch. The barrier poll below
                # is the fallback (no live heartbeater, refetch verdict,
                # or the diff never arriving within the timeout).
                cluster_spec = self._await_respec_spec()
                if cluster_spec is None:
                    for _ in range(3):
                        cluster_spec = self.register_and_get_cluster_spec()
                        if cluster_spec is not None:
                            break
                        LOG.warning("re-rendezvous barrier still open after "
                                    "%ds — retrying (the AM's allocation "
                                    "deadline governs)",
                                    self.registration_timeout_sec)
                self.tracer.end(
                    barrier_span,
                    "OK" if cluster_spec is not None else "ERROR")
                self._goodput_seed["rendezvous_wait"] += (
                    time.monotonic() - barrier_t0)
                self._push_spans()
                if cluster_spec is None:
                    LOG.error("re-rendezvous never completed after 3 "
                              "rounds of %ds — giving up",
                              self.registration_timeout_sec)
                    rendezvous_gave_up = True
                    exit_code = C.EXIT_FAILURE
                    break
            LOG.info("user process exited with %d", exit_code)
            # a given-up re-rendezvous is a barrier problem, not a task
            # fault — flag it so the AM spends no relaunch budget on it
            # (a superseded attempt's report is attempt-fenced anyway)
            self._report(exit_code, barrier_timeout=rendezvous_gave_up,
                         preempted=self._drain_requested,
                         resized=self._resize_release)
            return exit_code
        finally:
            # every exit path — including the rendezvous-timeout returns
            # above and unexpected exceptions — must free the reservation,
            # or the SO_REUSEPORT socket stays held for the executor's
            # remaining lifetime
            self._release_port_reservation()
            self._stop_log_service()

    def _release_port_reservation(self) -> None:
        if self._port_reservation is not None:
            self._port_reservation.release()
            self._port_reservation = None

    def _push_spans(self) -> None:
        """Best-effort ship of finished spans to the AM's SpanStore over
        the metrics RPC (phase boundaries only — never the hot path)."""
        if not self.tracer.enabled or self._metrics_stale:
            # an adopted orphan's metrics channel still points at the
            # dead AM attempt: pushing would grind through the retry
            # ladder and starve whatever liveness-critical call comes
            # next (the result report has a 25s expiry window to beat)
            return
        spans = self.tracer.drain()
        if not spans:
            return
        try:
            self.metrics_client.update_metrics(
                self.job_name, self.task_index, [], spans=spans,
                attempt=self.task_attempt)
        except Exception:  # noqa: BLE001 — tracing must never fail the task
            LOG.debug("span push failed", exc_info=True)

    def _execute(self, env: dict[str, str], timeout_sec: float) -> int:
        if not self.task_command:
            LOG.error("no task command configured")
            return C.EXIT_FAILURE
        self._user_proc = launch_shell(self.task_command, extra_env=env,
                                       cwd=os.getcwd())
        if self._respec_pending:
            # a generation bump landed between _on_generation's kill (which
            # found no live process) and this launch — take the fresh
            # process down so the respec loop re-enters the barrier
            self._kill_user_proc()
        if self._drain_requested or self._resize_release:
            # a drain/release ask landed before this launch (e.g. while
            # still at the barrier): there is no progress to checkpoint
            # — stop the fresh process so the drain completes immediately
            self._kill_user_proc()
        from tony_tpu_torch.executor.gpu_metrics import maybe_gpu_sampler
        from tony_tpu_torch.executor.task_monitor import default_tpu_sampler
        proc = self._user_proc

        def pid_fn():
            return proc.pid if proc.poll() is None else None

        self.monitor = TaskMonitor(
            self.metrics_client, self.job_name, self.task_index,
            pid_fn=pid_fn,
            interval_sec=self.metrics_interval_sec,
            # the cards the user's process tree holds a context on
            tpu_sampler=lambda: default_tpu_sampler(pid_fn()),
            gpu_sampler=maybe_gpu_sampler(self.conf, self.job_name),
            attempt=self.task_attempt)
        self.monitor.start()
        rc = wait_or_kill(self._user_proc, timeout_sec)
        self.monitor.stop()
        return rc

    def _kill_user_proc(self) -> None:
        proc = self._user_proc
        if proc is not None and proc.poll() is None:
            import signal
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()

    def _terminate_user_proc(self,
                             grace_sec: Optional[float] = None) -> None:
        """TERM the user process group and give it the grace window to
        exit cleanly before the KILL. The default is
        tony.task.term-grace-ms, sized to cover a trainer's emergency
        checkpoint (the TERM→checkpoint→KILL contract,
        docs/FAULT_TOLERANCE.md); long-running workloads (a serving
        task's HTTP server) get their shutdown hooks; anything that
        ignores the TERM dies at the deadline exactly as before. The
        wait returns the moment the process exits — a clean shutdown
        never sleeps the full window."""
        proc = self._user_proc
        if proc is None or proc.poll() is not None:
            return
        if grace_sec is None:
            grace_sec = self._term_grace_sec
        import signal
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            proc.terminate()
        try:
            proc.wait(timeout=grace_sec)
        except Exception:  # noqa: BLE001 — TimeoutExpired and friends
            self._kill_user_proc()

    # ------------------------------------------------------------------
    # AM-crash survivability: orphan mode (docs/FAULT_TOLERANCE.md)
    # ------------------------------------------------------------------
    def _on_hb_orphaned(self) -> bool:
        """Heartbeat budget exhausted: the AM crashed or wedged. Instead
        of the reference's immediate self-destruct
        (TaskExecutor.java:358-368) the executor goes ORPHAN: the user
        process keeps training while this (heartbeater) thread
        backoff-polls the app staging dir for an AM address — a
        supervised restart republishes `amhostport` on its new port; a
        merely hung AM (SIGSTOP) keeps the old address and answers once
        it thaws — and re-registers attempt-fenced. Returns True once
        adopted (clients swapped, heartbeats resume). If no AM adopts us
        within tony.am.orphan-grace-ms, the user process is self-fenced
        through the normal TERM→emergency-checkpoint→KILL ladder (no
        orphaned gang member holding its cards forever, and no bare
        os._exit losing the trainer's emergency checkpoint) and False is
        returned — the heartbeater then exits the process."""
        import random
        rng = random.Random(f"orphan:{self.task_id}:{self.task_attempt}")
        grace_sec = self._orphan_grace_sec
        deadline = time.monotonic() + grace_sec
        hostport_path = os.path.join(self.app_dir, C.AM_HOSTPORT_FILE)
        LOG.warning("orphaned: polling %s for up to %.1f s for a live AM "
                    "(user process untouched)", hostport_path, grace_sec)
        exponent = 0
        while time.monotonic() < deadline:
            addr = ""
            try:
                with open(hostport_path, "r", encoding="utf-8") as f:
                    addr = f.read().strip()
            except OSError:
                pass
            if addr and ":" in addr and self._orphan_reattach(addr):
                return True
            sleep = equal_jitter_backoff_sec(0.5, 5.0, exponent, rng)
            exponent += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(sleep, remaining))
        LOG.error("no AM adopted this executor within the %.1f s orphan "
                  "grace — self-fencing (TERM→checkpoint→KILL)", grace_sec)
        self._terminate_user_proc()
        try:
            # best-effort, fail-FAST: if an AM came back at the last
            # moment this records the terminal verdict, but a still-dead
            # AM must not hold the fence open through the client's
            # default retry ladder (~minutes) — one attempt, short
            # deadline, then exit
            self.client.call(
                "register_execution_result",
                {"exit_code": C.EXIT_HEARTBEAT_FAILURE,
                 "job_name": self.job_name,
                 "job_index": self.task_index,
                 "session_id": self.session_id,
                 "task_attempt": self.task_attempt},
                retries=1, timeout_sec=5.0, wait_for_ready=False)
        except Exception:  # noqa: BLE001
            LOG.debug("orphan self-fence result report failed",
                      exc_info=True)
        return False

    def _orphan_reattach(self, addr: str) -> bool:
        """One fast re-adoption attempt against `addr` — possibly the
        SAME address we already held (a thawed AM). A fresh channel
        re-registers this task attempt-fenced (a recovering AM drains
        its adoption barrier on exactly this call; a zombie superseded
        attempt gets an open barrier and is fenced by later heartbeats).
        On success the executor's and heartbeater's clients swap to the
        new channel. The metrics channel is NOT rebound — the recovered
        AM's metrics port is only rendered into relaunched containers,
        so adopted executors push metrics best-effort until then."""
        host, _, port_s = addr.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            return False
        candidate = ClusterServiceClient(
            host, port, auth_token=self._task_token,
            task_auth_id=self.task_id if self._task_token else None)
        try:
            candidate.call(
                "register_worker_spec",
                {"task_id": self.task_id,
                 "spec": f"{self.host}:{self.port}",
                 "session_id": self.session_id,
                 "task_attempt": self.task_attempt},
                retries=1, timeout_sec=5.0, wait_for_ready=False)
        except Exception:  # noqa: BLE001 — not up yet; the poll retries
            try:
                candidate.close()
            except Exception:  # noqa: BLE001
                LOG.debug("candidate channel close failed", exc_info=True)
            return False
        old = self.client
        self.client = candidate
        self._metrics_stale = True
        if self.heartbeater is not None:
            self.heartbeater.swap_client(candidate)
        if old is not None and old is not candidate:
            try:
                old.close()
            except Exception:  # noqa: BLE001
                LOG.debug("stale channel close failed", exc_info=True)
        LOG.warning("re-registered %s (attempt %d) with the AM at %s — "
                    "adopted; resuming heartbeats", self.task_id,
                    self.task_attempt, addr)
        return True

    def _report(self, exit_code: int, barrier_timeout: bool = False,
                preempted: bool = False, resized: bool = False) -> None:
        if self.heartbeater is not None:
            self.heartbeater.stop()
        self._push_spans()
        # a failing exit ships its own post-mortem: classified signature +
        # redacted tail ride the result RPC, so the AM's diagnostics
        # bundle works even when it can't reach this container's files
        # (off-host backends). A preempted drain / elastic-shrink release
        # is not a failure — no post-mortem to ship.
        diagnostics = None
        if not preempted and not resized \
                and exit_code not in (C.EXIT_SUCCESS,
                                      C.EXIT_KILLED_BY_AM):
            diagnostics = self._failure_diagnostics(exit_code)
        try:
            self.client.register_execution_result(
                exit_code, self.job_name, self.task_index, self.session_id,
                task_attempt=self.task_attempt,
                barrier_timeout=barrier_timeout,
                preempted=preempted,
                resized=resized,
                diagnostics=diagnostics)
        except Exception:  # noqa: BLE001
            LOG.exception("failed to register execution result")
