"""LocalClusterBackend: subprocess-based container runtime.

The port's copy of `tony_tpu/cluster/local.py`; a warm lease matches
`-m tony_tpu_torch.executor`.

The tony-mini equivalent (MiniCluster.java:43-60 brought up MiniYARNCluster +
MiniDFSCluster in-process): containers are real OS processes on this host, so
E2E tests exercise the genuine client→AM→executor→user-python chain — the
reference's highest-leverage test pattern (SURVEY.md §4) — without a cluster.
It is also the production substrate for single-host TPU VMs, where all chips
hang off one host and "containers" are per-process XLA clients.

Allocation is immediate but delivered from a separate dispatcher thread to
preserve the asynchronous callback contract of a real RM.
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import subprocess
import threading
from typing import Mapping

from tony_tpu_torch.cluster.backend import (
    ClusterBackend, Container, EXIT_KILLED_BY_AM,
)
from tony_tpu_torch.utils.common import current_host

LOG = logging.getLogger(__name__)


class LocalClusterBackend(ClusterBackend):
    def __init__(self, app_id: str = "local", capacity: int = 0,
                 stop_grace_sec: float = 0.0, warmpool=None):
        """capacity > 0 caps concurrently-allocated containers (MiniCluster's
        bounded NodeManagers); 0 = unbounded. stop_grace_sec > 0 widens
        the TERM→KILL escalation past the default (backend_from_conf
        sizes it to outlast tony.task.term-grace-ms, so an emergency
        checkpoint is never SIGKILLed mid-write). warmpool (a started
        cluster.warmpool.WarmExecutorPool) makes launch_container LEASE
        pre-imported executor processes instead of cold-spawning; a miss
        or a dead warm child falls back to the cold path transparently."""
        self._app_id = app_id
        self._capacity = capacity
        self._warmpool = warmpool
        if stop_grace_sec > 0:
            self.STOP_GRACE_SEC = stop_grace_sec   # instance override
        self._seq = 0
        self._host = current_host()
        self._procs: dict[str, subprocess.Popen] = {}
        self._killed: set[str] = set()
        self._docker_cids: set[str] = set()   # containers run via docker
        self._allocated: dict[str, Container] = {}
        self._pending: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stopping = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="rm-dispatcher", daemon=True)
        self._waiters: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._dispatcher.start()

    def request_containers(self, num: int, priority: int, memory_mb: int,
                           vcores: int, gpus: int, tpus: int,
                           node_label: str = "", gang: bool = True) -> None:
        for _ in range(num):
            self._pending.put((priority, memory_mb, vcores, gpus, tpus,
                               node_label))

    def _dispatch_loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("container-dispatch", 0.2)
        while not self._stopping:
            beacon.beat()
            try:
                item = self._pending.get(timeout=0.2)
            except queue.Empty:
                continue
            if self._capacity > 0:
                # FIFO within capacity, like the mini cluster's FifoScheduler
                while (not self._stopping
                       and self._live_container_count() >= self._capacity):
                    # waiting on capacity is progress, not a wedge
                    beacon.beat()
                    threading.Event().wait(0.1)
                if self._stopping:
                    return
            priority, memory_mb, vcores, gpus, tpus, node_label = item
            with self._lock:
                self._seq += 1
                cid = f"container_{self._app_id}_{self._seq:06d}"
                container = Container(
                    container_id=cid, host=self._host, priority=priority,
                    memory_mb=memory_mb, vcores=vcores, gpus=gpus, tpus=tpus,
                    node_label=node_label)
                self._allocated[cid] = container
            try:
                self._on_allocated(container)
            except Exception:  # noqa: BLE001 — a bad callback must not kill the RM
                LOG.exception("on_allocated callback failed for %s", cid)

    def _live_container_count(self) -> int:
        with self._lock:
            return sum(1 for p in self._procs.values() if p.poll() is None)

    # ------------------------------------------------------------------
    def launch_container(self, container: Container, command: list[str],
                         env: Mapping[str, str], cwd: str) -> None:
        os.makedirs(cwd, exist_ok=True)
        container.log_dir = cwd
        proc = self._try_warm_lease(command, env, cwd)
        if proc is not None:
            stdout = stderr = None   # the warm child opens its own files
            LOG.info("leased warm executor for %s pid=%d",
                     container.container_id, proc.pid)
        else:
            stdout = open(os.path.join(cwd, "stdout"), "ab")
            stderr = open(os.path.join(cwd, "stderr"), "ab")
            full_env = dict(os.environ)
            full_env.update({k: str(v) for k, v in env.items()})
            command = self._maybe_docker_wrap(container.container_id,
                                              command, env, cwd)
            proc = subprocess.Popen(
                command, env=full_env, cwd=cwd, stdout=stdout,
                stderr=stderr,
                start_new_session=True)  # own pgid → kill the whole tree
            LOG.info("launched %s pid=%d cmd=%s", container.container_id,
                     proc.pid, " ".join(command[:4]))
        with self._lock:
            self._procs[container.container_id] = proc
        waiter = threading.Thread(
            target=self._wait_container,
            args=(container.container_id, proc, stdout, stderr),
            name=f"wait-{container.container_id}", daemon=True)
        waiter.start()
        self._waiters.append(waiter)

    def _try_warm_lease(self, command: list[str], env: Mapping[str, str],
                        cwd: str):
        """Lease from the warm pool when this launch is a plain (non-
        docker) `python -m tony_tpu_torch.executor` — anything else (custom
        commands, docker containers) always cold-spawns. The leased
        child re-binds via its stdin spec: fresh task env (token,
        TONY_TRACE_ID), cwd, and the container's stdout/stderr files."""
        from tony_tpu_torch.cluster.docker import ENV_CONTAINER_TYPE
        if self._warmpool is None:
            return None
        if list(command[-2:]) != ["-m", "tony_tpu_torch.executor"]:
            return None
        if env.get(ENV_CONTAINER_TYPE) == "docker":
            return None
        return self._warmpool.lease_and_bind(
            env={k: str(v) for k, v in env.items()}, cwd=cwd,
            stdout_path=os.path.join(cwd, "stdout"),
            stderr_path=os.path.join(cwd, "stderr"))

    def _maybe_docker_wrap(self, cid: str, command: list[str],
                           env: Mapping[str, str], cwd: str) -> list[str]:
        """Honor the docker opt-in env (the YARN NodeManager's
        DockerLinuxContainerRuntime role). Degrades to a plain subprocess
        with a loud warning when no docker binary is on the host."""
        from tony_tpu_torch.cluster.docker import (
            ENV_CONTAINER_TYPE, ENV_DOCKER_IMAGE, ENV_DOCKER_MOUNTS,
            docker_wrap_command,
        )
        import shutil as _shutil

        if env.get(ENV_CONTAINER_TYPE) != "docker":
            return command
        if _shutil.which("docker") is None:
            LOG.warning("tony.docker.enabled set but no docker binary on "
                        "this host — launching as a plain subprocess")
            return command
        with self._lock:
            self._docker_cids.add(cid)
        return docker_wrap_command(
            env[ENV_DOCKER_IMAGE], command, env,
            mounts=env.get(ENV_DOCKER_MOUNTS, ""), workdir=cwd, name=cid)

    def _wait_container(self, cid: str, proc: subprocess.Popen,
                        stdout, stderr) -> None:
        rc = proc.wait()
        # warm-leased containers have no parent-side log files (the
        # child dup2'ed its own); close whatever this side holds
        for f in (stdout, stderr, proc.stdout, proc.stdin):
            try:
                if f:
                    f.close()
            except OSError:
                pass
        with self._lock:
            was_killed = cid in self._killed
        exit_code = EXIT_KILLED_BY_AM if was_killed else rc
        if self._stopping:
            return
        try:
            self._on_completed(cid, exit_code)
        except Exception:  # noqa: BLE001
            LOG.exception("on_completed callback failed for %s", cid)

    def stop_container(self, container_id: str) -> None:
        with self._lock:
            proc = self._procs.get(container_id)
            if proc is None or proc.poll() is not None:
                return
            self._killed.add(container_id)
        self._docker_kill(container_id)
        self._terminate_tree(proc)

    def _docker_kill(self, container_id: str) -> None:
        """Killing the `docker run` client does not kill the daemon-side
        container — docker-wrapped containers need `docker kill <name>`."""
        with self._lock:
            if container_id not in self._docker_cids:
                return
        try:
            subprocess.run(["docker", "kill", container_id],
                           capture_output=True, timeout=20)
        except (OSError, subprocess.TimeoutExpired):
            LOG.exception("docker kill %s failed", container_id)

    def release_container(self, container_id: str) -> None:
        with self._lock:
            self._allocated.pop(container_id, None)

    @staticmethod
    def _kill_tree(proc: subprocess.Popen) -> None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                proc.kill()
            except ProcessLookupError:
                pass

    # grace between the TERM and the KILL escalation: enough for the
    # executor's SIGTERM handler to reap its user process (which runs in
    # its OWN session, so a bare SIGKILL of the container group would
    # orphan it — fatal for long-running serving workloads: process and
    # port would outlive the application)
    STOP_GRACE_SEC = 5.0

    def _terminate_tree(self, proc: subprocess.Popen) -> None:
        """TERM-then-KILL container stop, non-blocking for the caller
        (stop_container runs on AM monitor/relaunch paths): the KILL
        escalation happens on a daemon timer iff the TERM didn't land.
        Instance method so the conf-derived STOP_GRACE_SEC override
        (sized past tony.task.term-grace-ms) governs the timer."""
        grace = self.STOP_GRACE_SEC
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            self._kill_tree(proc)
            return

        def _escalate():
            if proc.poll() is None:
                LOG.warning("container pid %d ignored SIGTERM for %.0fs "
                            "— killing", proc.pid, grace)
                self._kill_tree(proc)

        timer = threading.Timer(grace, _escalate)
        timer.daemon = True
        timer.start()

    def stop(self) -> None:
        self._stopping = True
        if self._warmpool is not None:
            self._warmpool.stop()
        with self._lock:
            procs = list(self._procs.values())
            cids = list(self._procs)
        for cid in cids:
            self._docker_kill(cid)
        # TERM first (the executor handler reaps its own-session user
        # process), escalate to KILL for anything still alive at the
        # grace deadline — teardown stays bounded either way
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    self._kill_tree(proc)
        # the KILL escalation waits STRICTLY LONGER than the executor's
        # own user-process grace (tony.task.term-grace-ms; backend_from_
        # conf sizes STOP_GRACE_SEC past it): SIGKILLing the executor's
        # group mid-grace would race its reap of the own-session user
        # process — the orphan this ladder exists to prevent — and cut
        # an in-flight emergency checkpoint short
        for proc in procs:
            try:
                proc.wait(timeout=self.STOP_GRACE_SEC)
            except subprocess.TimeoutExpired:
                self._kill_tree(proc)
        for proc in procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                LOG.warning("container pid %d did not die", proc.pid)
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=2)
