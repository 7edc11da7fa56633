"""TaskMonitor: the task's resource metrics, pushed to the AM: the port's
copy of `tony_tpu/executor/task_monitor.py`.

Every `tony.task.metrics-interval-ms` it samples the user process tree's
RSS (from /proc), the accelerator plane and, for a jobtype that asked for
GPUs, nvidia-smi's GPU plane, and pushes max, running average and (for
the duty cycle) the last sample over the metrics RPC, with the same names
and the same aggregation as the JAX package's.

The accelerator plane of the card is `default_tpu_sampler`: the duty
cycle and memory of the cards the user's process tree holds a context on,
read out of process through NVML (`cuda_metrics.py`), with the executor
process's own device memory as a second source when torch is already
initialised in it. The monitor never imports torch, and never makes a
CUDA context: the user process owns the card.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Callable, Optional

from tony_tpu_torch.executor.cuda_metrics import process_tree
from tony_tpu_torch.rpc.client import MetricsServiceClient

LOG = logging.getLogger(__name__)

# The names the AM reads. The accelerator plane's are TPU_*: they are the
# protocol's names for it (the AM's wedge detector reads TPU_UTILIZATION
# only), kept as the port keeps TPU_MESH_* and TONY_JAX_CACHE_DIR; on the
# card they carry its duty cycle (percent) and its memory (bytes).
MAX_MEMORY_BYTES = "MAX_MEMORY_BYTES"
AVG_MEMORY_BYTES = "AVG_MEMORY_BYTES"
MAX_TPU_UTILIZATION = "MAX_TPU_UTILIZATION"
AVG_TPU_UTILIZATION = "AVG_TPU_UTILIZATION"
MAX_TPU_HBM_BYTES = "MAX_TPU_HBM_BYTES"
AVG_TPU_HBM_BYTES = "AVG_TPU_HBM_BYTES"
# the LAST sample, not a lifetime aggregate: the AM's wedge detector needs
# the current duty cycle
TPU_UTILIZATION = "TPU_UTILIZATION"
# the reference's names for a GPU jobtype's nvidia-smi plane
MAX_GPU_UTILIZATION = "MAX_GPU_UTILIZATION"
AVG_GPU_UTILIZATION = "AVG_GPU_UTILIZATION"
MAX_GPU_FB_MEMORY_USAGE = "MAX_GPU_FB_MEMORY_USAGE"
AVG_GPU_FB_MEMORY_USAGE = "AVG_GPU_FB_MEMORY_USAGE"
MAX_GPU_MAIN_MEMORY_USAGE = "MAX_GPU_MAIN_MEMORY_USAGE"
AVG_GPU_MAIN_MEMORY_USAGE = "AVG_GPU_MAIN_MEMORY_USAGE"


def _proc_tree_rss_bytes(root_pid: int) -> int:
    """VmRSS summed over `root_pid` and its descendants."""
    total = 0
    for pid in process_tree(root_pid):
        try:
            with open(f"/proc/{pid}/status", "r") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        total += int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
    return total


_card_sampler = None


def _card_sample(root_pid: int) -> dict[str, float]:
    """Duty cycle and memory of the cards the tree of `root_pid` holds a
    context on (`cuda_metrics.CardSampler`; one reader per process)."""
    global _card_sampler
    if _card_sampler is None:
        from tony_tpu_torch.executor.cuda_metrics import CardSampler
        _card_sampler = CardSampler()
    return _card_sampler(root_pid)


def default_tpu_sampler(root_pid: Optional[int] = None) -> dict[str, float]:
    """Accelerator sample of the user process tree rooted at `root_pid`,
    best source first:

    1. NVML, out of process (see _card_sample): duty cycle and memory;
       nothing when the tree holds no context on any card;
    2. the executor process's own device memory, but ONLY if torch is
       already in it with CUDA initialised (a task run in the executor's
       process): the monitor must never make a CUDA context itself."""
    sample: dict[str, float] = {}
    if root_pid is not None:
        try:
            sample = _card_sample(root_pid)
        except Exception:  # noqa: BLE001 — never break metrics for stats
            LOG.debug("card metrics unavailable", exc_info=True)
    if "hbm_bytes" in sample:
        return sample
    torch = sys.modules.get("torch")
    if torch is None:
        return sample
    try:
        if not torch.cuda.is_initialized():
            return sample
        hbm = sum(torch.cuda.memory_allocated(d)
                  for d in range(torch.cuda.device_count()))
        if hbm:
            sample["hbm_bytes"] = float(hbm)
        return sample
    except Exception:  # noqa: BLE001 — never break metrics for stats
        return sample


class _Stat:
    def __init__(self):
        self.max = 0.0
        self.avg = 0.0
        self.n = 0

    def update(self, value: float) -> None:
        self.max = max(self.max, value)
        self.n += 1
        self.avg += (value - self.avg) / self.n


class _GpuPlane:
    """Running max-of-per-sample-max and avg-of-per-sample-avg, matching
    the reference's setMaxMetrics/setAvgMetrics pair per GPU metric
    (TaskMonitor.java:152-160)."""

    def __init__(self):
        self.max_stat = _Stat()
        self.avg_stat = _Stat()

    @property
    def n(self) -> int:
        return self.max_stat.n

    def update(self, sample_max: float, sample_avg: float) -> None:
        self.max_stat.update(sample_max)
        self.avg_stat.update(sample_avg)


class TaskMonitor:
    """Samples every `interval_sec` and pushes to the AM's metrics RPC."""

    def __init__(self, client: MetricsServiceClient, task_type: str,
                 index: int, pid_fn: Callable[[], Optional[int]],
                 interval_sec: float = 5.0,
                 tpu_sampler: Optional[Callable[[], dict[str, float]]] = None,
                 gpu_sampler: Optional[Callable[[], dict[str, float]]] = None,
                 attempt: int = -1):
        self._client = client
        self._task_type = task_type
        self._index = index
        self._attempt = attempt   # Prometheus attempt label at the AM
        self._pid_fn = pid_fn
        self._interval = interval_sec
        self._tpu_sampler = tpu_sampler
        self._gpu_sampler = gpu_sampler
        self._mem = _Stat()
        self._tpu_util = _Stat()
        self._tpu_util_last: Optional[float] = None
        self._tpu_hbm = _Stat()
        self._gpu_util = _GpuPlane()
        self._gpu_fb = _GpuPlane()
        self._gpu_main = _GpuPlane()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="task-monitor",
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def snapshot(self) -> list[dict]:
        metrics = [
            {"name": MAX_MEMORY_BYTES, "value": self._mem.max},
            {"name": AVG_MEMORY_BYTES, "value": self._mem.avg},
        ]
        if self._tpu_util.n:
            metrics += [
                {"name": MAX_TPU_UTILIZATION, "value": self._tpu_util.max},
                {"name": AVG_TPU_UTILIZATION, "value": self._tpu_util.avg},
                {"name": MAX_TPU_HBM_BYTES, "value": self._tpu_hbm.max},
                {"name": AVG_TPU_HBM_BYTES, "value": self._tpu_hbm.avg},
            ]
        # current duty only when THIS interval produced a sample: a hung
        # driver stops answering NVML entirely, and repeating the last
        # healthy number would hide exactly that wedge
        if self._tpu_util_last is not None:
            metrics.append({"name": TPU_UTILIZATION,
                            "value": self._tpu_util_last})
        if self._gpu_util.n:
            metrics += [
                {"name": MAX_GPU_UTILIZATION,
                 "value": self._gpu_util.max_stat.max},
                {"name": AVG_GPU_UTILIZATION,
                 "value": self._gpu_util.avg_stat.avg},
                {"name": MAX_GPU_FB_MEMORY_USAGE,
                 "value": self._gpu_fb.max_stat.max},
                {"name": AVG_GPU_FB_MEMORY_USAGE,
                 "value": self._gpu_fb.avg_stat.avg},
                {"name": MAX_GPU_MAIN_MEMORY_USAGE,
                 "value": self._gpu_main.max_stat.max},
                {"name": AVG_GPU_MAIN_MEMORY_USAGE,
                 "value": self._gpu_main.avg_stat.avg},
            ]
        return metrics

    def _run(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("task-monitor", self._interval)
        while not self._stop.wait(self._interval):
            beacon.beat()
            self._sample_and_push()
        beacon.idle()
        # final push so the AM's TASK_FINISHED event carries the last numbers
        self._sample_and_push()

    def _sample_and_push(self) -> None:
        pid = self._pid_fn()
        if pid is not None:
            rss = _proc_tree_rss_bytes(pid)
            if rss > 0:
                self._mem.update(float(rss))
        if self._tpu_sampler is not None:
            try:
                sample = self._tpu_sampler()
                # None (not carry-forward) when this interval had no duty
                # sample — see snapshot()
                self._tpu_util_last = sample.get("duty_cycle")
                if "duty_cycle" in sample:
                    self._tpu_util.update(sample["duty_cycle"])
                if "hbm_bytes" in sample:
                    self._tpu_hbm.update(sample["hbm_bytes"])
            except Exception:  # noqa: BLE001 — metrics must never kill a task
                self._tpu_util_last = None   # no current sample this interval
                LOG.exception("tpu sampler failed")
        if self._gpu_sampler is not None:
            try:
                g = self._gpu_sampler()
                if g:
                    self._gpu_util.update(g["util_max"], g["util_avg"])
                    self._gpu_fb.update(g["fb_pct_max"], g["fb_pct_avg"])
                    self._gpu_main.update(g["main_pct_max"],
                                          g["main_pct_avg"])
            except Exception:  # noqa: BLE001 — metrics must never kill
                LOG.exception("gpu sampler failed")
        try:
            self._client.update_metrics(self._task_type, self._index,
                                        self.snapshot(),
                                        attempt=self._attempt)
        except Exception:  # noqa: BLE001
            LOG.warning("metrics push failed", exc_info=True)
