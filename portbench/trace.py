"""The device trace of a traced window: `torch.profiler` over the window,
reduced to what the per-layer metrics read.

`reduce` keeps, from the profiler's events:
- `busy_s`: the union of every device interval (kernels, copies, fills);
- `kernels`: device seconds and launches by short kernel name;
- `device_ops` and `idle_gaps`: the ten device operations that took most
  time, and the ten longest gaps in which no device operation ran, each
  named by the host op that was running at its middle (outermost >
  innermost, or "host: no op").
"""

from __future__ import annotations

import bisect
import re
import time
from contextlib import contextmanager

import torch

_TEMPLATE = re.compile(r"<[^<>]*>")


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, return type, templates or
    arguments: `void (anonymous namespace)::flash_fwd_tc<128>(...)` is
    `flash_fwd_tc`."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (", 1)[0]
    n = name.replace("(anonymous namespace)::", "")
    while _TEMPLATE.search(n):
        n = _TEMPLATE.sub("", n)
    n = n.split("(", 1)[0].strip()
    n = n.rsplit(" ", 1)[-1]
    return n.rsplit("::", 1)[-1] or name


class _Unparsed(torch.autograd.profiler.profile):
    """The autograd profiler, stopped without turning its events into
    Python objects: that takes tens of seconds over a busy window, and the
    thread that stops it (a serving engine's) would stall for as long.
    The raw events are read later by `reduce`."""

    def __exit__(self, *exc):
        self.kineto_results = torch.autograd.profiler._disable_profiler()
        return False


class Trace:
    """The profiler from `start()` to `stop()`, which returns the host-clock
    length of the traced window; `result()` then reduces the events. Both
    ends wait for the device, so the window holds whole work. CPU ops are
    recorded on the thread that starts it, device work on every thread."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.prof = _Unparsed(use_device="cuda" if self.cuda else None,
                              use_kineto=True)
        self.t0 = 0.0
        self.window_s = 0.0

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.monotonic() - self.t0
        self.prof.__exit__(None, None, None)
        return self.window_s

    def result(self) -> dict:
        out = reduce(self.prof.kineto_results.events())
        out["window_s"] = self.window_s
        out["on_device"] = self.cuda
        return out


@contextmanager
def traced(box: dict):
    """Trace the block; `box` gets the reduced trace after it ends."""
    t = Trace()
    t.start()
    try:
        yield box
    finally:
        t.stop()
    box.update(t.result())


def reduce(events) -> dict:
    """The profiler's raw (kineto) events, reduced."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                # the device-side mirror of a record_function range
                # (train_step, Optimizer.step) spans other work
                continue
            dev.append((start, start + dur, short_name(e.name())))
        elif e.device_type() == DeviceType.CPU and dur > 0:
            cpu.append((start, start + dur, e.name()))
    kernels: dict = {}
    for s, t, n in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (t - s) / 1e9
        k[1] += 1
    dev.sort()
    merged: list = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    cpu.sort()
    starts = [c[0] for c in cpu]
    # ops longer than a millisecond may start far before a gap
    long_ops = [c for c in cpu if c[1] - c[0] > 1_000_000]
    idle = []
    for length, s, t in gaps:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid)
        near = cpu[max(0, i - 2000):i]
        covering = [c for c in near + long_ops
                    if c[0] <= mid <= c[1]]
        if covering:
            outer = min(covering, key=lambda c: c[0])[2]
            inner = max(covering, key=lambda c: c[0])[2]
            label = outer if outer == inner else f"{outer} > {inner}"
        else:
            label = "host: no op"
        idle.append([label, length / 1e9])
    ops = sorted(([n, v[0]] for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"busy_s": busy, "kernels": kernels, "device_ops": ops,
            "idle_gaps": idle}


def flash_seconds(trace: dict) -> dict:
    """Device seconds and launches of K1 (flash_fwd*), K2 (flash_bwd_dq*)
    and K3 (flash_bwd_dkv*)."""
    out = {"k1": [0.0, 0], "k2": [0.0, 0], "k3": [0.0, 0]}
    for name, (sec, n) in trace.get("kernels", {}).items():
        key = ("k3" if "flash_bwd_dkv" in name else
               "k2" if "flash_bwd_dq" in name else
               "k1" if "flash_fwd" in name else None)
        if key:
            out[key][0] += sec
            out[key][1] += n
    return out
