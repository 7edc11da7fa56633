"""ClusterBackend interface + Container record.

The port's copy of `tony_tpu/cluster/backend.py`.

The reference talked to YARN through two async clients: AMRMClientAsync
(container allocation, ApplicationMaster.java:1002-1073) and NMClientAsync
(container launch/stop, ApplicationMaster.java:970-1000). This interface
merges both roles: the AM requests containers, gets allocation callbacks,
launches commands into allocated containers, and gets completion callbacks.

The allocation→task matching contract is the same as the reference's: each
jobtype's containers are requested at a **unique priority**, and allocations
echo that priority back (util/Utils.java:392-398, TonySession.java:208-224).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

from tony_tpu_torch import constants as C


@dataclass
class Container:
    """An allocated execution slot (YARN Container equivalent)."""
    container_id: str
    host: str
    priority: int
    memory_mb: int = 0
    vcores: int = 0
    gpus: int = 0
    tpus: int = 0
    node_label: str = ""
    # populated at launch time
    log_dir: str = ""
    extra: dict = field(default_factory=dict)


EXIT_KILLED_BY_AM = C.EXIT_KILLED_BY_AM


class UnsatisfiableRequestError(ValueError):
    """No node in the pool can EVER satisfy a container request (label
    mismatch or a resource quantity above every node's declared capacity).
    Raised synchronously from request_containers so the AM fails the app
    immediately instead of spinning until the registration timeout — the
    fail-fast YARN gave the reference by rejecting impossible resource
    asks at submission (util/Utils.java:186-204)."""


AllocatedCallback = Callable[[Container], None]
CompletedCallback = Callable[[str, int], None]  # (container_id, exit_code)


class ClusterBackend(abc.ABC):
    """What the ApplicationMaster needs from a cluster substrate."""

    # True when containers may run on hosts that do NOT share the client's
    # filesystem; the AM then references staged artifacts by store URI
    # instead of app-dir paths (TonyClient.java:519-590's HDFS role).
    off_host = False

    def set_callbacks(self, on_allocated: AllocatedCallback,
                      on_completed: CompletedCallback) -> None:
        self._on_allocated: Optional[AllocatedCallback] = on_allocated
        self._on_completed: Optional[CompletedCallback] = on_completed

    @abc.abstractmethod
    def start(self) -> None:
        """Bring up the backend (NMClientAsync.start equivalent)."""

    @abc.abstractmethod
    def request_containers(self, num: int, priority: int, memory_mb: int,
                           vcores: int, gpus: int, tpus: int,
                           node_label: str = "", gang: bool = True) -> None:
        """Ask for `num` containers at `priority`; answers arrive via the
        on_allocated callback (AMRMClientAsync.addContainerRequest equiv).
        `gang=True` (tracked jobtypes) means all `num` must be able to
        run CO-RESIDENTLY — they rendezvous at the barrier — and a pool
        that can never co-host them raises UnsatisfiableRequestError;
        gang=False (untracked) permits sequential reuse of slots."""

    def validate_coresident(self, asks: list[tuple[int, int, int, int,
                                                   str]]) -> None:
        """Joint gang feasibility across jobtypes that must all be
        resident at once; each ask is (num, memory_mb, gpus, tpus,
        node_label). Raises UnsatisfiableRequestError only when
        co-residency is provably impossible. Default: no static node
        pool to check against — accept."""

    @abc.abstractmethod
    def launch_container(self, container: Container, command: list[str],
                         env: Mapping[str, str], cwd: str) -> None:
        """Start `command` inside an allocated container
        (NMClientAsync.startContainerAsync equivalent). Exit is reported via
        the on_completed callback."""

    @abc.abstractmethod
    def stop_container(self, container_id: str) -> None:
        """Kill a running container; its completion callback reports
        EXIT_KILLED_BY_AM (NMClientAsync.stopContainerAsync equivalent)."""

    @abc.abstractmethod
    def release_container(self, container_id: str) -> None:
        """Return an allocated-but-unlaunched container
        (amRMClient.releaseAssignedContainer equivalent)."""

    @abc.abstractmethod
    def stop(self) -> None:
        """Tear everything down; kill any still-running containers."""
