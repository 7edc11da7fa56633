"""RemoteClusterBackend: launch executors on OTHER hosts.

The port's copy of `tony_tpu/cluster/remote.py`. The reference placed
containers on other machines via YARN — `TonyClient.submitApplication`
(TonyClient.java:231-266) hands the app to the RM, and the AM's
`RMCallbackHandler` / `ContainerLauncher`
(ApplicationMaster.java:1002-1073,1078-1156) turn RM allocations into
`NMClientAsync.startContainerAsync` calls on NodeManager hosts. This
backend is the off-host equivalent for fleets of GPU hosts, where there
is no RM/NM pair: the node set is declared up front
(`tony.cluster.nodes` = "host[:slots],..."), the AM both *allocates*
(slot bookkeeping per node) and *launches* (via a NodeTransport), and
exit codes stream back over the transport channel.

Two transports:
- `SSHTransport` — production: one ssh channel per container. The launch
  script travels over **stdin** (never argv — env values include the app
  secret) and execs the command with its pgid recorded on the node, so
  `stop_container` can kill the whole remote tree. stdout/stderr of the
  remote process flow back through the channel into the AM-side container
  log files, keeping task URLs and the portal working unchanged.
- `ExecTransport` — the multi-host test double (SURVEY §4's MiniYARN
  analogue): same script machinery, but "nodes" are per-node root dirs on
  this host and the channel is a local `bash` process. E2E tests
  gang-schedule across 2+ simulated hosts without sshd.

Container workdirs live under the NODE's root (`tony.cluster.node-root`),
not the client's app dir — executors must localize everything through the
staging store (tony_tpu_torch/storage), which is what makes this backend work
without a shared filesystem.
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import threading
from dataclasses import dataclass
from typing import IO, Mapping, Optional

from tony_tpu_torch.cluster.backend import (
    ClusterBackend, Container, EXIT_KILLED_BY_AM,
    UnsatisfiableRequestError,
)

LOG = logging.getLogger(__name__)

# ssh uses 255 for transport failure; remote command rcs pass through.
SSH_TRANSPORT_ERROR = 255


@dataclass
class NodeSpec:
    host: str
    slots: int = 1
    root: str = ""          # node-side base dir for container workdirs
    # placement attributes (reference: YARN node labels + resource
    # quantities, TonyClient.java:260 setNodeLabelExpression +
    # util/Utils.java:186-204). label follows YARN's exclusive-partition
    # semantics: a request's node_label must EQUAL the node's label
    # (both may be "", the default partition). Capacities of -1 mean
    # "undeclared" = unconstrained, so plain "host:slots" pools keep
    # their old behavior.
    label: str = ""
    tpus: int = -1
    gpus: int = -1
    memory_mb: int = -1

    @classmethod
    def parse(cls, spec: str, default_root: str = "") -> "NodeSpec":
        """Grammar: host[:slots][;attr=val...] with attrs label, tpus,
        gpus, memory (memory accepts 16g/512m suffixes)."""
        head, *attrs = [p.strip() for p in spec.split(";")]
        host, _, slots = head.partition(":")
        if not host:
            raise ValueError(f"empty host in node spec {spec!r}")
        node = cls(host=host.strip(), slots=int(slots) if slots else 1,
                   root=default_root)
        for attr in attrs:
            if not attr:
                continue
            k, sep, v = attr.partition("=")
            if not sep:
                raise ValueError(
                    f"bad node attribute {attr!r} in {spec!r} "
                    f"(want key=value)")
            k = k.strip().lower()
            if k == "label":
                node.label = v.strip()
            elif k in ("tpus", "gpus"):
                setattr(node, k, int(v))
            elif k in ("memory", "memory_mb"):
                from tony_tpu_torch.conf.configuration import parse_memory_mb
                node.memory_mb = parse_memory_mb(v)
            else:
                raise ValueError(
                    f"unknown node attribute {k!r} in {spec!r} "
                    f"(label|tpus|gpus|memory)")
        return node

    def describe(self) -> str:
        parts = [f"{self.host}:{self.slots}"]
        if self.label:
            parts.append(f"label={self.label}")
        for k in ("tpus", "gpus", "memory_mb"):
            v = getattr(self, k)
            if v >= 0:
                parts.append(f"{k}={v}")
        return ";".join(parts)


def parse_nodes(specs: str, default_root: str = "") -> list[NodeSpec]:
    return [NodeSpec.parse(s, default_root)
            for s in specs.split(",") if s.strip()]


# resource dimensions a request claims on its node; "slots" is implicit
# (always 1 per container). ONE place defines the vector shape — init,
# fit checks, claim, and release all iterate these dicts.
def _request_vector(memory_mb: int, gpus: int, tpus: int) -> dict:
    return {"slots": 1, "tpus": tpus or 0, "gpus": gpus or 0,
            "memory_mb": memory_mb or 0}


def _zero_vector() -> dict:
    return _request_vector(0, 0, 0) | {"slots": 0}


def _node_capacity(node: NodeSpec) -> dict:
    """Declared capacities; -1 = undeclared/unconstrained."""
    return {"slots": node.slots, "tpus": node.tpus, "gpus": node.gpus,
            "memory_mb": node.memory_mb}


def _fits(node: NodeSpec, used: dict, need: dict,
          node_label: str) -> bool:
    """Can `node` host one more container of `need` given `used`?
    Labels follow YARN exclusive partitions: exact match, "" = the
    default partition. A declared capacity (>= 0) bounds the summed
    quantities of resident containers; undeclared (-1) is
    unconstrained (plain "host:slots" pools behave as before)."""
    if node.label != (node_label or ""):
        return False
    cap = _node_capacity(node)
    return all(cap[k] < 0 or used[k] + need[k] <= cap[k]
               for k in need)


def _node_max_fit(node: NodeSpec, need: dict, node_label: str) -> int:
    """How many containers of `need` this node can ever hold
    SIMULTANEOUSLY (gang feasibility)."""
    if node.label != (node_label or ""):
        return 0
    cap = _node_capacity(node)
    bound = node.slots
    for k, v in need.items():
        if k != "slots" and cap[k] >= 0 and v > 0:
            bound = min(bound, cap[k] // v)
    return max(0, bound)


def build_launch_script(command: list[str], env: Mapping[str, str],
                        workdir: str, pidfile: str) -> str:
    """The node-side launcher. Records the process-group id for kill,
    cds into the node-local workdir, exports the task env (values are
    shell-quoted — the script never passes through argv), and execs."""
    lines = ["set -e", f"mkdir -p {shlex.quote(workdir)}",
             f"cd {shlex.quote(workdir)}",
             f"echo $$ > {shlex.quote(pidfile)}"]
    for k in sorted(env):
        lines.append(f"export {k}={shlex.quote(str(env[k]))}")
    lines.append("exec " + " ".join(shlex.quote(c) for c in command))
    return "\n".join(lines) + "\n"


class NodeTransport:
    """How to run a launch script on a node and kill it later."""

    def launch(self, node: NodeSpec, script: str,
               stdout: IO, stderr: IO) -> subprocess.Popen:
        raise NotImplementedError

    def kill(self, node: NodeSpec, pidfile: str,
             channel: subprocess.Popen) -> None:
        raise NotImplementedError


class SSHTransport(NodeTransport):
    def __init__(self, ssh_opts: Optional[list[str]] = None):
        # BatchMode: never prompt; ServerAlive*: detect dead hosts in ~30s
        # (the liveliness monitor's transport-level backstop).
        self.ssh_opts = ssh_opts if ssh_opts is not None else [
            "-o", "BatchMode=yes", "-o", "ServerAliveInterval=15",
            "-o", "ServerAliveCountMax=2",
            "-o", "StrictHostKeyChecking=accept-new",
        ]

    def argv(self, node: NodeSpec, remote_cmd: str) -> list[str]:
        return ["ssh", *self.ssh_opts, node.host, remote_cmd]

    def launch(self, node, script, stdout, stderr):
        proc = subprocess.Popen(
            self.argv(node, "bash -s"),
            stdin=subprocess.PIPE, stdout=stdout, stderr=stderr,
            start_new_session=True)
        proc.stdin.write(script.encode())
        proc.stdin.close()
        return proc

    def kill(self, node, pidfile, channel):
        q = shlex.quote(pidfile)
        # TERM the process group, then KILL stragglers; ignore a vanished
        # pidfile (process already gone).
        remote = (f"pg=$(cat {q} 2>/dev/null) && "
                  f"{{ kill -TERM -- -$pg 2>/dev/null; sleep 2; "
                  f"kill -KILL -- -$pg 2>/dev/null; }} || true")
        try:
            subprocess.run(self.argv(node, remote), capture_output=True,
                           timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            LOG.exception("remote kill on %s failed", node.host)
        # the channel dies with the remote process; reap it defensively
        if channel.poll() is None:
            try:
                channel.terminate()
            except OSError:
                pass


class ExecTransport(NodeTransport):
    """Local test double: identical script/pidfile/kill machinery, node
    roots are directories on this host. Inherits os.environ so the e2e
    suite's fault-injection env vars reach executors, like the local
    backend (a real ssh node would get only the script's exports)."""

    def launch(self, node, script, stdout, stderr):
        proc = subprocess.Popen(
            ["bash", "-s"], stdin=subprocess.PIPE, stdout=stdout,
            stderr=stderr, env=dict(os.environ), start_new_session=True)
        proc.stdin.write(script.encode())
        proc.stdin.close()
        return proc

    def kill(self, node, pidfile, channel):
        try:
            with open(pidfile, "r", encoding="utf-8") as f:
                pg = int(f.read().strip())
        except (OSError, ValueError):
            pg = None
        if pg is not None:
            import signal as _signal
            for sig in (_signal.SIGTERM, _signal.SIGKILL):
                try:
                    os.killpg(pg, sig)
                except (ProcessLookupError, PermissionError):
                    break
        if channel.poll() is None:
            try:
                channel.kill()
            except OSError:
                pass


@dataclass
class _Live:
    container: Container
    node: NodeSpec
    channel: subprocess.Popen
    pidfile: str
    stdout: IO
    stderr: IO
    killed: bool = False


class RemoteClusterBackend(ClusterBackend):
    """Static-node-pool scheduler + transport launcher (the AM-side merge
    of AMRMClientAsync allocation and NMClientAsync launch)."""

    off_host = True

    def __init__(self, nodes: list[NodeSpec], transport: NodeTransport,
                 app_id: str = "remote"):
        if not nodes:
            raise ValueError("RemoteClusterBackend needs at least one node")
        self._nodes = nodes
        self._transport = transport
        self._app_id = app_id
        self._seq = 0
        # FIFO-preference pending list (NOT a strict queue: the
        # dispatcher places the FIRST item that fits *right now*, so a
        # label/capacity-starved head can't starve later requests whose
        # partition has free capacity — head-of-line blocking)
        self._pending_list: list[tuple] = []
        self._allocated: dict[str, tuple[Container, NodeSpec]] = {}
        self._live: dict[str, _Live] = {}
        # per-node usage vector: slots + the declared-capacity resources
        self._used: dict[str, dict[str, int]] = {
            n.host: _zero_vector() for n in nodes}
        self._lock = threading.Lock()
        # set whenever placement state changes (new request, usage
        # released, stop) — the dispatcher blocks on it when idle or
        # starved instead of busy-polling
        self._work = threading.Event()
        self._stopping = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="remote-rm", daemon=True)
        self._waiters: list[threading.Thread] = []

    # -- allocation ----------------------------------------------------
    def start(self) -> None:
        self._dispatcher.start()

    def request_containers(self, num: int, priority: int, memory_mb: int,
                           vcores: int, gpus: int, tpus: int,
                           node_label: str = "", gang: bool = True) -> None:
        # fail-fast feasibility gate (reference: YARN rejected resource
        # asks beyond any node's capacity at submission instead of
        # letting the app spin to the registration timeout): an
        # impossible request must surface in <1s with a clear message.
        # Gang semantics (tracked jobtypes): all `num` must be
        # CO-RESIDENT — the barrier waits for every instance — so the
        # bound is the sum over matching nodes of how many of this
        # request each can ever hold simultaneously. Untracked
        # (gang=False) jobs may reuse slots sequentially: they only need
        # ONE container to ever fit.
        need = _request_vector(memory_mb, gpus, tpus)
        max_coresident = sum(_node_max_fit(n, need, node_label)
                             for n in self._nodes)
        if max_coresident < (num if gang else 1):
            inventory = ", ".join(n.describe() for n in self._nodes)
            want = [f"{num} {'co-resident ' if gang else ''}container(s)"]
            if node_label:
                want.append(f"label={node_label!r}")
            want += [f"{k}={v}" for k, v in need.items()
                     if k != "slots" and v]
            raise UnsatisfiableRequestError(
                f"the node pool can co-host at most {max_coresident} of "
                f"the requested [{' '.join(want)}] — nodes: [{inventory}]")
        with self._lock:
            for _ in range(num):
                self._pending_list.append(
                    (priority, memory_mb, vcores, gpus, tpus, node_label))
        self._work.set()

    def validate_coresident(self, asks: list[tuple[int, int, int, int,
                                                   str]]) -> None:
        """Joint gang feasibility over MULTIPLE tracked jobtypes that
        must all be resident at once (the barrier waits for every
        instance of every one). Each ask is (num, memory_mb, gpus, tpus,
        node_label). Checks a sound NECESSARY condition per label
        partition — total slots and, where every partition node declares
        a resource, total declared capacity vs summed demand — so it
        only raises when co-residency is provably impossible
        (fragmentation may still starve; the per-request gate and the
        registration timeout cover that)."""
        by_label: dict[str, list[tuple]] = {}
        for ask in asks:
            by_label.setdefault(ask[4] or "", []).append(ask)
        for label, group in by_label.items():
            part = [n for n in self._nodes if n.label == label]
            total = {"slots": sum(n.slots for n in part)}
            demand = {"slots": sum(a[0] for a in group)}
            for key, idx in (("memory_mb", 1), ("gpus", 2), ("tpus", 3)):
                if part and all(getattr(n, key) >= 0 for n in part):
                    total[key] = sum(getattr(n, key) for n in part)
                    demand[key] = sum(a[0] * (a[idx] or 0)
                                      for a in group)
            over = [k for k in demand if demand[k] > total.get(k, 0)]
            if over:
                inventory = ", ".join(n.describe() for n in self._nodes)
                raise UnsatisfiableRequestError(
                    f"tracked jobtypes jointly need "
                    f"{ {k: demand[k] for k in over} } in partition "
                    f"label={label!r} which can ever provide only "
                    f"{ {k: total.get(k, 0) for k in over} } — "
                    f"nodes: [{inventory}]")

    def _pick_node(self, need: dict, node_label: str) -> Optional[NodeSpec]:
        """Least-slot-loaded node satisfying the request's label and
        resource constraints (deterministic tie-break by list order,
        which keeps allocation→task matching reproducible). Claims the
        request's resource vector on the chosen node."""
        best = None
        with self._lock:
            for node in self._nodes:
                if not _fits(node, self._used[node.host], need,
                             node_label):
                    continue
                if (best is None or self._used[node.host]["slots"]
                        < self._used[best.host]["slots"]):
                    best = node
            if best is not None:
                u = self._used[best.host]
                for k, v in need.items():
                    u[k] += v
        return best

    def _release_usage(self, container: Container, host: str) -> None:
        """Return a container's resource vector to its node (caller holds
        the lock)."""
        u = self._used[host]
        vec = _request_vector(container.memory_mb, container.gpus,
                              container.tpus)
        for k, v in vec.items():
            u[k] = max(0, u[k] - v)
        self._work.set()

    def _dispatch_loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("container-dispatch", 1.0)
        while not self._stopping:
            beacon.beat()
            # clear BEFORE scanning so a state change during the scan
            # re-wakes us instead of being lost
            self._work.clear()
            with self._lock:
                pending = list(self._pending_list)
            # first-fit over the whole pending list (FIFO preference,
            # no head-of-line blocking): a currently-starved head must
            # not stall later requests placeable on other partitions
            placed = None
            for item in pending:
                priority, memory_mb, vcores, gpus, tpus, node_label = item
                node = self._pick_node(
                    _request_vector(memory_mb, gpus, tpus), node_label)
                if node is not None:
                    placed = (item, node)
                    break
            if placed is None:
                # idle or starved: block until a request arrives or
                # capacity frees (1s backstop timeout)
                self._work.wait(1.0)
                continue
            item, node = placed
            priority, memory_mb, vcores, gpus, tpus, node_label = item
            if self._stopping:
                # stop() raced the placement: don't allocate a container
                # the stop loop's _live snapshot will never kill
                return
            with self._lock:
                # single dispatcher thread: the item is still present
                self._pending_list.remove(item)
                self._seq += 1
                cid = f"container_{self._app_id}_{self._seq:06d}"
                container = Container(
                    container_id=cid, host=node.host, priority=priority,
                    memory_mb=memory_mb, vcores=vcores, gpus=gpus,
                    tpus=tpus, node_label=node_label)
                self._allocated[cid] = (container, node)
            try:
                self._on_allocated(container)
            except Exception:  # noqa: BLE001
                LOG.exception("on_allocated callback failed for %s", cid)

    # -- launch --------------------------------------------------------
    def launch_container(self, container: Container, command: list[str],
                         env: Mapping[str, str], cwd: str) -> None:
        """`cwd` is the AM-side container dir: stdout/stderr land there
        (streamed back over the channel), keeping task log URLs valid.
        The process itself runs in a node-side workdir under node.root."""
        with self._lock:
            _, node = self._allocated[container.container_id]
        os.makedirs(cwd, exist_ok=True)
        container.log_dir = cwd
        node_root = node.root or f"/tmp/tony_tpu/{self._app_id}"
        workdir = os.path.join(node_root, container.container_id)
        pidfile = os.path.join(workdir, "container.pid")
        script = build_launch_script(command, env, workdir, pidfile)
        stdout = open(os.path.join(cwd, "stdout"), "ab")
        stderr = open(os.path.join(cwd, "stderr"), "ab")
        try:
            channel = self._transport.launch(node, script, stdout, stderr)
        except OSError as e:
            # ssh missing / fork failure: free the slot and report the
            # container failed, or a 1-slot node wedges the dispatcher
            stdout.close()
            stderr.close()
            with self._lock:
                self._release_usage(container, node.host)
                self._allocated.pop(container.container_id, None)
            LOG.error("transport launch on %s failed: %s", node.host, e)
            self._on_completed(container.container_id, 1)
            return
        live = _Live(container=container, node=node, channel=channel,
                     pidfile=pidfile, stdout=stdout, stderr=stderr)
        with self._lock:
            self._live[container.container_id] = live
        waiter = threading.Thread(
            target=self._wait_container, args=(live,),
            name=f"wait-{container.container_id}", daemon=True)
        waiter.start()
        self._waiters.append(waiter)
        LOG.info("launched %s on node %s (workdir %s)",
                 container.container_id, node.host, workdir)

    def _wait_container(self, live: _Live) -> None:
        rc = live.channel.wait()
        live.stdout.close()
        live.stderr.close()
        cid = live.container.container_id
        with self._lock:
            self._release_usage(live.container, live.node.host)
            killed = live.killed
            # prune per-container state: a long-lived AM cycling many
            # sessions must not accumulate dead channels/threads forever
            self._live.pop(cid, None)
            self._allocated.pop(cid, None)
            self._waiters = [t for t in self._waiters if t.is_alive()]
        exit_code = EXIT_KILLED_BY_AM if killed else rc
        if rc == SSH_TRANSPORT_ERROR and not killed:
            LOG.warning("transport to %s failed for %s (rc 255)",
                        live.node.host, live.container.container_id)
        if self._stopping:
            return
        try:
            self._on_completed(live.container.container_id, exit_code)
        except Exception:  # noqa: BLE001
            LOG.exception("on_completed callback failed for %s",
                          live.container.container_id)

    # -- kill / release ------------------------------------------------
    def stop_container(self, container_id: str) -> None:
        with self._lock:
            live = self._live.get(container_id)
            if live is None or live.channel.poll() is not None:
                return
            live.killed = True
        self._transport.kill(live.node, live.pidfile, live.channel)

    def release_container(self, container_id: str) -> None:
        with self._lock:
            entry = self._allocated.pop(container_id, None)
            if entry is not None and container_id not in self._live:
                container, node = entry
                self._release_usage(container, node.host)

    def stop(self) -> None:
        self._stopping = True
        self._work.set()
        with self._lock:
            lives = list(self._live.values())
        for live in lives:
            if live.channel.poll() is None:
                live.killed = True
                self._transport.kill(live.node, live.pidfile, live.channel)
        for live in lives:
            try:
                live.channel.wait(timeout=5)
            except subprocess.TimeoutExpired:
                LOG.warning("container %s channel did not die",
                            live.container.container_id)
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=2)
