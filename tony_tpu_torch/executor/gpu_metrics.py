"""nvidia-smi sampler for jobtypes that ask for GPUs: the port's copy of
`tony_tpu/executor/gpu_metrics.py`.

A jobtype with ``tony.<job>.gpus`` > 0 (and ``tony.task.gpu-metrics.
enabled``) gets the reference's sampler: `nvidia-smi -x -q` parsed with
the stdlib, its six max/avg aggregates under the reference GPU names
(utilization, framebuffer and BAR1 memory), off after 10 consecutive
failures. It reads the whole host; the card duty cycle the AM judges is
`cuda_metrics.py`'s, which reads only the user's processes' cards.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

LOG = logging.getLogger(__name__)

# reference: GpuDiscoverer.DEFAULT_BINARY_SEARCH_DIRS
DEFAULT_SEARCH_DIRS = ("/usr/bin", "/bin", "/usr/local/nvidia/bin")
# reference: Constants.MAX_REPEATED_GPU_ERROR_ALLOWED (Constants.java:169)
MAX_REPEATED_ERRORS = 10
EXEC_TIMEOUT_SEC = 10.0     # reference: MAX_EXEC_TIMEOUT_MS


@dataclass
class GpuInfo:
    """One <gpu> element of `nvidia-smi -x -q`."""
    utilization_pct: float          # <utilization><gpu_util>
    fb_used_mib: float              # <fb_memory_usage>
    fb_total_mib: float
    bar1_used_mib: float            # <bar1_memory_usage> ("main memory"
    bar1_total_mib: float           # in the reference's metric names)

    @property
    def fb_pct(self) -> float:
        return 100.0 * self.fb_used_mib / self.fb_total_mib \
            if self.fb_total_mib else 0.0

    @property
    def bar1_pct(self) -> float:
        return 100.0 * self.bar1_used_mib / self.bar1_total_mib \
            if self.bar1_total_mib else 0.0


def find_nvidia_smi(path_override: Optional[str] = None) -> Optional[str]:
    """Resolve the nvidia-smi binary: explicit conf path, $PATH, then the
    reference's default search dirs (GpuDiscoverer.java:52-54)."""
    if path_override:
        return path_override if os.access(path_override, os.X_OK) else None
    found = shutil.which("nvidia-smi")
    if found:
        return found
    for d in DEFAULT_SEARCH_DIRS:
        cand = os.path.join(d, "nvidia-smi")
        if os.access(cand, os.X_OK):
            return cand
    return None


def _num(text: Optional[str]) -> float:
    """'95 %' / '1024 MiB' / 'N/A' -> float (0.0 for absent/N-A)."""
    if not text:
        return 0.0
    head = text.strip().split()[0]
    try:
        return float(head)
    except ValueError:
        return 0.0


def parse_gpu_xml(xml_text: str) -> list[GpuInfo]:
    """Parse `nvidia-smi -x -q` output (the reference's
    GpuDeviceInformationParser equivalent)."""
    root = ET.fromstring(xml_text)
    gpus = []
    for gpu in root.iter("gpu"):
        util = gpu.find("utilization/gpu_util")
        fb = gpu.find("fb_memory_usage")
        bar1 = gpu.find("bar1_memory_usage")
        gpus.append(GpuInfo(
            utilization_pct=_num(util.text if util is not None else None),
            fb_used_mib=_num(fb.findtext("used") if fb is not None else None),
            fb_total_mib=_num(fb.findtext("total") if fb is not None
                              else None),
            bar1_used_mib=_num(bar1.findtext("used") if bar1 is not None
                               else None),
            bar1_total_mib=_num(bar1.findtext("total") if bar1 is not None
                                else None),
        ))
    return gpus


class GpuSampler:
    """Callable sampler for TaskMonitor's gpu plane. Returns the
    reference's six aggregates per sample; after MAX_REPEATED_ERRORS
    consecutive failures it disables itself (empty samples) the way the
    reference flips isGpuMachine off (TaskMonitor.java:163-169)."""

    def __init__(self, binary: str):
        self._binary = binary
        self._errors = 0

    def __call__(self) -> dict[str, float]:
        if self._errors >= MAX_REPEATED_ERRORS:
            return {}
        try:
            out = subprocess.run(
                [self._binary, "-x", "-q"], capture_output=True, text=True,
                timeout=EXEC_TIMEOUT_SEC, check=True).stdout
            gpus = parse_gpu_xml(out)
        except Exception as e:  # noqa: BLE001 — metrics must never kill
            self._errors += 1
            if self._errors == MAX_REPEATED_ERRORS:
                LOG.warning("nvidia-smi failed %d times; disabling GPU "
                            "sampling: %s", self._errors, e)
            return {}
        self._errors = 0
        if not gpus:
            return {}
        utils = [g.utilization_pct for g in gpus]
        fbs = [g.fb_pct for g in gpus]
        bar1s = [g.bar1_pct for g in gpus]
        return {
            "util_max": max(utils),
            "util_avg": sum(utils) / len(utils),
            "fb_pct_max": max(fbs),
            "fb_pct_avg": sum(fbs) / len(fbs),
            "main_pct_max": max(bar1s),
            "main_pct_avg": sum(bar1s) / len(bar1s),
        }


def maybe_gpu_sampler(conf, jobtype: str) -> Optional[GpuSampler]:
    """A sampler iff this jobtype requested GPUs, GPU metrics are enabled
    (`tony.task.gpu-metrics.enabled`, reference
    TonyConfigurationKeys.java:152), and a binary exists."""
    from tony_tpu_torch.conf import keys as K

    if conf.get_int(K.gpus_key(jobtype), 0) <= 0:
        return None
    if not conf.get_bool(K.TASK_GPU_METRICS_ENABLED, True):
        return None
    binary = find_nvidia_smi(conf.get_str(K.GPU_PATH_TO_EXEC) or None)
    if binary is None:
        LOG.info("jobtype %s requests GPUs but nvidia-smi is not "
                 "available on this host; GPU metrics disabled", jobtype)
        return None
    return GpuSampler(binary)
