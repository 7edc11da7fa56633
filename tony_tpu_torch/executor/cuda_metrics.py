"""Card duty cycle and memory through NVML: the port's counterpart of
`tony_tpu/executor/tpu_metrics.py`.

The executor must see whether its user process is still working on the
card while it keeps heartbeating (a hung NCCL collective, a stalled input
pipeline): the AM's wedge detector reads the duty cycle the executor
pushes. The executor never touches the card itself (the user process owns
it, and a bare executor must not create a CUDA context), so it reads the
card out of process, as `nvidia-smi` does: through NVML, the driver's own
library (`libnvidia-ml.so.1`), called with `ctypes`. No package is needed.

Per card, one sample reads the utilization NVML reports (the share of its
last sample period in which a kernel ran: the card's duty cycle), its
memory, and its compute processes, each with its pid and used memory
(`nvmlDeviceGetComputeRunningProcesses_v3`, whose `nvmlProcessInfo_t` is
the v2 layout of `nvml.h`: pid, used bytes, GPU and compute instance ids;
the v1 call's struct has only the first two, so v1 is never called).

`card_use` attributes the cards to the user's process tree:
- where NVML names a pid of the tree on a card, the tree holds a context
  there: the duty cycle is the highest utilization over those cards, the
  memory the sum of those pids' used memory;
- NVML's pids are the driver's, in the host's pid namespace. Inside a
  container they may name no process here. Only when no card names a
  tree pid, a card whose compute processes NVML names outside this
  namespace (no local process of that pid maps the card's device file)
  counts as the tree's if a tree process holds a context there: it maps
  `/dev/nvidia-uvm` (only a context maps it; `cuInit` alone and NVML
  alone do not) and `/dev/nvidia<minor>`. The memory is then what NVML
  reports for those foreign entries, each distinct (pid, bytes) once. In
  a sandbox that reports every process of its own as one pid, that is
  the sandbox's compute memory on the card, an upper bound of the task's.

A tree with no context on any card gets no duty at all, so the AM does
not judge it, as it does not judge a task with no source. `CardSampler`
runs each NVML read on a worker thread and waits a bounded time: a
driver that stops answering costs an interval without a sample, never a
blocked monitor. NVML that cannot be loaded is logged once and sampling
stops.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

LOG = logging.getLogger(__name__)

NVML_LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_ERROR_INSUFFICIENT_SIZE = 7
# a used-memory value NVML cannot give (WDDM, some containers)
NVML_VALUE_NOT_AVAILABLE = 0xFFFFFFFFFFFFFFFF
# mapped only by a process that holds a CUDA context
UVM_DEVICE = "/dev/nvidia-uvm"


class Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample period."""
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Memory(ctypes.Structure):
    """nvmlMemory_t (v1), in bytes."""
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class ProcessInfo(ctypes.Structure):
    """nvmlProcessInfo_t, the struct of the _v3 (and _v2) process calls."""
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


class NvmlError(RuntimeError):
    def __init__(self, call: str, rc: int):
        super().__init__(f"{call} returned NVML error {rc}")
        self.call, self.rc = call, rc


@dataclass
class DeviceSample:
    """One card at one sample."""
    index: int
    minor: int                       # its device file is /dev/nvidia<minor>
    utilization_pct: float
    memory_used: int
    memory_total: int
    # (pid as NVML names it, used bytes or None) per compute context
    processes: list[tuple[int, Optional[int]]] = field(default_factory=list)


def _declare(lib) -> None:
    """argtypes and restype of every NVML function called."""
    ptr, uint_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)
    sigs = {
        "nvmlInit_v2": [],
        "nvmlShutdown": [],
        "nvmlDeviceGetCount_v2": [uint_p],
        "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                          ctypes.POINTER(ptr)],
        "nvmlDeviceGetMinorNumber": [ptr, uint_p],
        "nvmlDeviceGetUtilizationRates": [ptr, ctypes.POINTER(Utilization)],
        "nvmlDeviceGetMemoryInfo": [ptr, ctypes.POINTER(Memory)],
        "nvmlDeviceGetComputeRunningProcesses_v3": [
            ptr, uint_p, ctypes.POINTER(ProcessInfo)],
        "nvmlDeviceGetComputeRunningProcesses_v2": [
            ptr, uint_p, ctypes.POINTER(ProcessInfo)],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int


class NvmlReader:
    """The cards of this host through NVML. `lib` is `libnvidia-ml.so.1`
    loaded with ctypes unless a stand-in is given (the tests')."""

    def __init__(self, lib=None):
        self._lib = lib
        self._handles: Optional[list] = None
        self._minors: list[int] = []
        self._procs_fn = None
        self._cap = 64

    @property
    def started(self) -> bool:
        """Whether NVML is loaded and initialised."""
        return self._handles is not None

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != NVML_SUCCESS:
            raise NvmlError(name, rc)

    def _ensure(self) -> None:
        """Load and initialise NVML and find the cards, once. OSError when
        the library is missing, NvmlError when it refuses to start."""
        if self._handles is not None:
            return
        if self._lib is None:
            self._lib = ctypes.CDLL(NVML_LIBRARY)
        if isinstance(self._lib, ctypes.CDLL):
            _declare(self._lib)
        self._call("nvmlInit_v2")
        count = ctypes.c_uint(0)
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(count))
        handles, minors = [], []
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._call("nvmlDeviceGetHandleByIndex_v2", i, ctypes.byref(h))
            minor = ctypes.c_uint(i)
            try:
                self._call("nvmlDeviceGetMinorNumber", h,
                           ctypes.byref(minor))
            except NvmlError:
                minor = ctypes.c_uint(i)
            handles.append(h)
            minors.append(int(minor.value))
        # the _v3 symbol on current drivers, _v2 on older ones: one layout
        self._procs_fn = (getattr(self._lib,
                                  "nvmlDeviceGetComputeRunningProcesses_v3",
                                  None)
                          or self._lib.nvmlDeviceGetComputeRunningProcesses_v2)
        self._handles, self._minors = handles, minors

    def _processes(self, handle) -> list[tuple[int, Optional[int]]]:
        for _ in range(3):
            infos = (ProcessInfo * self._cap)()
            count = ctypes.c_uint(self._cap)
            rc = self._procs_fn(handle, ctypes.byref(count), infos)
            if rc == NVML_ERROR_INSUFFICIENT_SIZE:
                self._cap = max(self._cap * 2, int(count.value) + 16)
                continue
            if rc != NVML_SUCCESS:
                raise NvmlError("nvmlDeviceGetComputeRunningProcesses", rc)
            out = []
            for info in infos[:count.value]:
                used = int(info.usedGpuMemory)
                out.append((int(info.pid),
                            None if used == NVML_VALUE_NOT_AVAILABLE
                            else used))
            return out
        raise NvmlError("nvmlDeviceGetComputeRunningProcesses",
                        NVML_ERROR_INSUFFICIENT_SIZE)

    def sample(self) -> list[DeviceSample]:
        self._ensure()
        out = []
        for i, (h, minor) in enumerate(zip(self._handles, self._minors)):
            util, mem = Utilization(), Memory()
            self._call("nvmlDeviceGetUtilizationRates", h, ctypes.byref(util))
            self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(mem))
            out.append(DeviceSample(
                index=i, minor=minor, utilization_pct=float(util.gpu),
                memory_used=int(mem.used), memory_total=int(mem.total),
                processes=self._processes(h)))
        return out

    def close(self) -> None:
        if self._handles is not None:
            self._lib.nvmlShutdown()
            self._handles = None


# ---------------------------------------------------------------------------
# the user's process tree, from /proc
# ---------------------------------------------------------------------------

def process_tree(root_pid: int) -> set[int]:
    """`root_pid` and its descendants (parent links from /proc/<pid>/stat):
    the task command runs through a shell, so the trainer is a grandchild
    of the executor, and its workers are further down."""
    children: dict[int, list[int]] = {}
    try:
        entries = os.listdir("/proc")
    except OSError:
        return {root_pid}
    for entry in entries:
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat", "r") as f:
                fields = f.read().rsplit(")", 1)[-1].split()
            children.setdefault(int(fields[1]), []).append(int(entry))
        except (OSError, IndexError, ValueError):
            continue
    seen: set[int] = set()
    stack = [root_pid]
    while stack:
        pid = stack.pop()
        if pid in seen:
            continue
        seen.add(pid)
        stack.extend(children.get(pid, []))
    return seen


def mapped_devices(pid: int) -> set[str]:
    """The /dev/nvidia* files `pid` maps (empty when /proc does not show
    them: no such process, or no permission)."""
    out = set()
    try:
        with open(f"/proc/{pid}/maps", "r") as f:
            for line in f:
                path = line.rsplit(None, 1)[-1] if "/dev/nvidia" in line \
                    else ""
                if path.startswith("/dev/nvidia"):
                    out.add(path)
    except OSError:
        pass
    return out


def holds_context(pid: int) -> bool:
    """Whether `pid` holds a CUDA context, by what /proc shows of it."""
    return UVM_DEVICE in mapped_devices(pid)


def card_use(devices: list[DeviceSample], tree: set[int],
             maps: Callable[[int], set[str]] = mapped_devices
             ) -> dict[str, float]:
    """{"duty_cycle", "hbm_bytes"} over the cards the tree holds a context
    on (see the module docstring), or {} when it holds none."""
    held: list[DeviceSample] = []
    hbm = 0
    for dev in devices:
        mine = [used for pid, used in dev.processes if pid in tree]
        if mine:
            held.append(dev)
            hbm += sum(u for u in mine if u is not None)
    if not held:
        tree_maps = None
        for dev in devices:
            node = f"/dev/nvidia{dev.minor}"
            foreign = {(pid, used) for pid, used in dev.processes
                       if node not in maps(pid)}
            if not foreign:
                continue
            if tree_maps is None:
                tree_maps = [maps(pid) for pid in tree]
            if any(UVM_DEVICE in m and node in m for m in tree_maps):
                held.append(dev)
                hbm += sum(u for _, u in foreign if u is not None)
    if not held:
        return {}
    return {"duty_cycle": max(d.utilization_pct for d in held),
            "hbm_bytes": float(hbm)}


class CardSampler:
    """The card use of a process tree, one NVML read per call, each on a
    worker thread waited for at most `timeout_sec`."""

    def __init__(self, reader: Optional[NvmlReader] = None,
                 timeout_sec: float = 2.0):
        self._reader = reader if reader is not None else NvmlReader()
        self._timeout = timeout_sec
        self._inflight: Optional[threading.Thread] = None
        self._disabled = False
        self._warned_slow = False

    def read(self) -> Optional[list[DeviceSample]]:
        """One NVML read of every card; None when NVML is unavailable, the
        read failed, or a read is still in flight past the timeout."""
        if self._disabled:
            return None
        if self._inflight is not None and self._inflight.is_alive():
            return None
        box: dict = {}

        def run():
            try:
                box["devices"] = self._reader.sample()
            except Exception as e:  # noqa: BLE001 — reported below
                box["error"] = e

        t = threading.Thread(target=run, name="nvml-sample", daemon=True)
        t.start()
        t.join(self._timeout)
        if t.is_alive():
            self._inflight = t
            if not self._warned_slow:
                self._warned_slow = True
                LOG.warning("an NVML read took over %.1f s; this interval "
                            "reports no card sample", self._timeout)
            return None
        err = box.get("error")
        if isinstance(err, (OSError, NvmlError)) \
                and not self._reader.started:
            # the library is missing or refused to start: say it once
            self._disabled = True
            LOG.warning("NVML is unavailable (%s); no card duty cycle or "
                        "memory will be reported", err)
            return None
        if err is not None:
            LOG.debug("NVML read failed", exc_info=err)
            return None
        return box["devices"]

    def __call__(self, root_pid: Optional[int]) -> dict[str, float]:
        if root_pid is None:
            return {}
        devices = self.read()
        if not devices:
            return {}
        return card_use(devices, process_tree(root_pid))
