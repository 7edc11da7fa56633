#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (`tony_tpu_torch`) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase, as the port's proof of life

Phases (any failure exits non-zero, and the result line is not printed):

1. build    — compile every hand-written CUDA kernel from `tony_tpu_torch/
              csrc/` (one nvcc per source, all at once); print the build
              seconds, nvcc's register report per kernel and the card's
              name and power limit; count the HGMMA (wgmma) instructions
              in the SASS of each bf16 flash kernel (forward and
              backward, cuobjdump) and fail if one has none.
2. kernels  — call each kernel's wrapper at the shapes of the serving
              and training paths and hold it against its plain PyTorch
              version on the same inputs: elementwise (bf16 at 3e-2, f32
              at 2e-5 for the forwards and 2e-4 for the flash backward, as
              tests/test_ops.py holds the JAX kernels) and, for bf16
              flash outputs, by norm: ||got - want|| / ||want|| over the
              whole tensor and over each row of D, within 1e-2 (late rows
              are small, so an elementwise 3e-2 alone would pass a kernel
              that dropped their tiles), printing where the worst row is;
              print the errors, kernel ms, plain ms, the library call's ms
              and the bound (RMSNorm also with a cold L2). At the training
              shape the flash kernels run twice and must agree bit for
              bit, and print their TFLOP/s and share of the bound.
3. serve    — the serving path at full width: `build_server` with
              llama3_8b (bf16, random weights from a fixed seed), 4 slots,
              a 2048-token budget; 8 concurrent HTTP /v1/generate requests
              (2 streamed) with prompts of 1 to 1900 tokens, 16 new tokens
              each. Checks every answer, /v1/metrics, and that the kernel
              launch counts are exactly what the path must launch.
4. engine   — `tiny` in f32 on the card: the engine's greedy streams under
              staggered arrivals equal the offline `generate`, and the
              forward on the card agrees with the forward on the CPU.
5. profile  — where a full-width prefill's and decode step's time goes
              (host wall, device busy time, idle share, top kernels).
6. train    — the training path at full width: the Trainer that
              `python -m tony_tpu_torch.train` builds, on llama3_1b_proxy
              (full depth, bf16, random weights from a fixed seed) at
              batch 4 x 4096 tokens with save_flash remat, 5 steps of
              synthetic tokens plus one profiled step, in one run.
              Checks finite losses, the exact kernel launches of every
              step and peak device memory; prints the Trainer's own
              tokens/s and MFU (its metrics_history) and where a step's
              time goes. Then `tiny` f32 trains 3 SGD steps on the
              card and on the CPU: the same losses and parameters.

`--phases build,kernels` (for instance) runs a subset.

Two lines before the last is a JSON object with one entry per kernel
(`launches`: its launches on the serve and train paths together, split
in `launches_by_path`), then the card's name and power limit from
nvidia-smi; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

SERVE_CONFIG = "llama3_8b"
# K1 at llama3_8b's head layout (B1 H32/8 D128 causal), at serving's prompt
# lengths, timed; the last is the timed summary
FLASH_SEQS = (1, 37, 512, 513, 2000)
# more bf16 K1 cases, held and not timed, (B, H, Hkv, S, D, causal):
# bench_350m's D64, D32 and D16, each at a ragged S (not a multiple of the
# 128-key tile), a non-causal case, an H == Hkv case, a group of 4 at B2
FLASH_CASES = (
    (1, 16, 8, 1000, 64, True),
    (1, 4, 2, 100, 32, True),
    (2, 4, 4, 37, 16, True),
    (1, 32, 8, 1000, 128, False),
    (1, 8, 8, 513, 128, True),
    (2, 8, 2, 777, 128, True),
)
# (rows, D): serving's shapes (2000 x 4096 is the timed summary), the
# training path's (B4 x S4096 rows of llama3_1b_proxy's 2048), bench_350m's
# 1024, and two rows that are not a power of two: 1000 (bf16: 125 16-byte
# vectors, the vector path) and 1001 (not a whole number of 16-byte
# vectors in either dtype: the scalar path)
RMS_CASES = ((1, 4096), (4, 4096), (513, 4096), (2000, 4096),
             (16384, 2048), (2000, 1024), (2000, 1000), (2000, 1001))
RMS_SUMMARY = (2000, 4096)
TOL = {"bfloat16": 3e-2, "float32": 2e-5}
BWD_TOL = {"bfloat16": 3e-2, "float32": 2e-4}
# bf16 flash outputs: the limit on the norm-wise relative error, over the
# whole tensor and over each row. Both sides round the same f32 sums to
# bf16, so they differ by at most one bf16 ulp (2^-7 relative) in a few
# elements; a dropped or misplaced tile costs its rows O(1).
NORM_TOL = 1e-2
# the limit on K1's lse at the training shape: both sides sum in f32, in
# another order, and the plain version scales q before the product where
# the bf16 kernel scales S after it
LSE_TOL = 1e-4
# (B, H, Hkv, S, D, causal, dtype) of the flash backward cases: the
# training shape of llama3_1b_proxy first (timed, and K1 held and timed
# there too), llama3_8b's head layout (group 4), bench_350m's (D 64),
# ragged S (not a multiple of 64 or 128) at every head dim, a non-causal
# case, an H == Hkv case, contiguous (B, H, S, D) operands (an eighth
# field "bhsd"; the others are `qkv_proj`'s (B, S, H, D) views); in bf16
# the tensor-core kernels, in f32 (D 128 S 1024 and small shapes) the
# CUDA-core ones
BWD_CASES = (
    (4, 16, 8, 4096, 128, True, "bfloat16"),
    (1, 32, 8, 2048, 128, True, "bfloat16"),
    (1, 16, 8, 1000, 128, True, "bfloat16"),
    (1, 16, 8, 37, 128, True, "bfloat16"),
    (2, 8, 2, 777, 128, True, "bfloat16"),
    (1, 16, 8, 1000, 128, False, "bfloat16"),
    (1, 8, 8, 512, 128, True, "bfloat16"),
    (2, 8, 4, 300, 128, True, "bfloat16", "bhsd"),
    (1, 4, 2, 129, 64, True, "bfloat16"),
    (1, 16, 8, 2048, 64, True, "bfloat16"),
    (1, 4, 2, 100, 32, True, "bfloat16"),
    (2, 4, 4, 37, 16, True, "bfloat16"),
    (1, 4, 2, 1024, 128, True, "float32"),
    (1, 4, 2, 100, 32, True, "float32"),
    (1, 4, 2, 100, 32, False, "float32"),
    (2, 4, 4, 37, 16, True, "float32"),
)
# the bf16 flash kernels' symbols, by source, whose SASS must hold HGMMA
# (wgmma)
TC_KERNELS = {"flash_fwd.cu": ("flash_fwd_tc",),
              "flash_bwd.cu": ("flash_bwd_dq_tc", "flash_bwd_dkv_tc")}
TRAIN_CONFIG = "llama3_1b_proxy"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 5
# peak device memory the train phase may reach, GiB: 12.31 GiB measured
# (PERF.md: weights, grads and AdamW moments 9.1 GB, saved block inputs and
# flash out/lse 2.2 GB, one block's replay and backward), which the flash
# backward kernels must not grow: they allocate no scratch
TRAIN_PEAK_GIB = 12.5
PROMPT_LENS = (1, 17, 128, 512, 513, 1000, 1500, 1900)
MAX_NEW = 16
N_STREAMED = 2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def log(message: str) -> None:
    print(message, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float, float]:
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) from the port's table
    (`tony_tpu_torch/device.py`)."""
    from tony_tpu_torch.device import card_peaks as table
    peaks = table(name)
    if peaks is None:
        raise SmokeFailure(f"no peak rates known for {name!r}")
    return peaks


def _device_us(event) -> float:
    return event.self_device_time_total


def device_events(prof) -> list:
    """A profile's device-side events (kernels, copies, fills): the host
    ops that launched them carry the same time again. The device-side
    mirrors of `record_function` ranges (train_step, Optimizer.step) span
    other kernels and are left out."""
    events = prof.key_averages()
    annotations = {e.key for e in events
                   if getattr(e, "is_user_annotation", False)}
    return [e for e in events if str(e.device_type).endswith("CUDA")
            and e.key not in annotations
            and not getattr(e, "is_user_annotation", False)]


def log_top(kernels: list, n: int) -> None:
    """The profile's `n` largest device ops, then each of the port's own
    kernels (by the templates of csrc/: flash_*, rmsnorm_*) that is not
    among them."""
    ranked = sorted(kernels, key=_device_us, reverse=True)
    for e in ranked[:n]:
        log(f"profile:   {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    for e in ranked[n:]:
        if re.search(r"\b(flash_\w+|rmsnorm_\w+)<", e.key):
            log(f"profile:   {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} "
                f"{e.key[:90]} (a port kernel)")


def _events_ms(fn, iters: int, sleep_cycles: int = 0) -> float:
    """CUDA-event time of `iters` back-to-back fn() calls, over `iters`,
    optionally queued behind a sleep kernel of `sleep_cycles`."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device_ms, call_ms) of one fn() call, after `warmup` calls.
    call_ms: CUDA-event time per call as the host issues them; where the
    device outruns the host it measures the host's launch cost. device_ms:
    the same calls queued behind a sleep kernel that lasts twice as long as
    issuing them took, so the device runs them back to back: the device
    time per call, the host's cost hidden."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    call_ms = _events_ms(fn, iters)
    return _events_ms(fn, iters, _sleep_cycles(call_ms * iters)), call_ms


def _sleep_cycles(host_ms: float) -> int:
    """Cycles of a sleep kernel that outlasts twice `host_ms` of host
    launch time (and 5 ms at least)."""
    import torch
    cycles_per_ms = 1e6 / _events_ms(lambda: torch.cuda._sleep(1_000_000), 1)
    return int(cycles_per_ms * max(5.0, 2 * host_ms))


def timed_cold(fn, iters: int, flush) -> float:
    """Device ms of one fn() call that finds the L2 cold: before each call,
    outside the CUDA events that bracket fn() alone, `flush` (twice the
    L2) is written and then read back, so fn()'s inputs are evicted and the
    write-back of the flush's own dirty lines is done before fn() starts
    (written alone, it would land inside the timed call). The calls queue
    behind a sleep kernel, so the host's cost stays hidden."""
    import torch
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

    def run(sleep_cycles: int) -> float:
        torch.cuda.synchronize()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        t0 = time.monotonic()
        for start, end in pairs:
            flush.zero_().sum()
            start.record()
            fn()
            end.record()
        host_ms = (time.monotonic() - t0) * 1e3
        torch.cuda.synchronize()
        return host_ms

    host_ms = run(0)                         # warm-up, and the host's pace
    run(_sleep_cycles(host_ms))
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def max_err(got, want, tol: float) -> tuple[float, bool]:
    """max |got - want| and whether |got - want| <= tol + tol * |want|
    everywhere (numpy's assert_allclose with atol = rtol = tol)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.all(diff <= tol + tol * w.abs()).item()) and \
        bool(torch.isfinite(g).all().item())
    return float(diff.max().item()), ok


def norm_err(got, want) -> tuple[float, float, tuple[int, ...]]:
    """(||got - want|| / ||want||, the worst row's ||got_r - want_r|| /
    (||want_r|| + 1e-3 * rms_r ||want_r||), that row's index over the
    leading dims, e.g. (b, h, s)), rows along the last dim. The floor keeps
    rows whose exact value is 0 (causal dQ of row 0) from dividing
    rounding noise by nothing."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    diff = (g - w).norm(dim=-1)
    rows = w.norm(dim=-1)
    floor = 1e-3 * rows.square().mean().sqrt()
    total = float(diff.norm() / rows.norm().clamp_min(1e-30))
    ratio = diff / (rows + floor).clamp_min(1e-30)
    flat = int(ratio.argmax())
    where = []
    for n in reversed(got.shape[:-1]):
        where.append(flat % n)
        flat //= n
    return total, float(ratio.max()), tuple(reversed(where))


def hold(got, want, tol: float, by_norm: bool, name: str = "") -> dict:
    """The case's verdict: elementwise within `tol`, and with `by_norm` the
    norm-wise errors within NORM_TOL (and where the worst row is, as
    `name` (b, h, s))."""
    err, ok = max_err(got, want, tol)
    r = {"max_abs_err": err, "ok": ok}
    if by_norm:
        total, row, where = norm_err(got, want)
        r.update(norm_err=total, row_err=row,
                 worst_row=f"{name} {where}".strip(),
                 ok=ok and total <= NORM_TOL and row <= NORM_TOL)
    return r


def merge(*held: dict) -> dict:
    """One verdict for several outputs of a kernel: the worst of each
    error (and the worst row's place), ok only if every output is."""
    r = {"ok": all(h["ok"] for h in held)}
    for key in ("max_abs_err", "norm_err", "row_err"):
        if any(key in h for h in held):
            r[key] = max(h.get(key, 0.0) for h in held)
    if "row_err" in r:
        r["worst_row"] = max((h for h in held if "row_err" in h),
                             key=lambda h: h["row_err"])["worst_row"]
    return r


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from tony_tpu_torch.ops import attention, rmsnorm  # noqa: F401 (register)
    from tony_tpu_torch.ops import cuda_lib

    sources = sorted({k.source for k in cuda_lib.KERNELS.values()})
    version = subprocess.run([cuda_lib.find_nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.strip().splitlines()
    log(f"build: {version[-1] if version else 'nvcc version unknown'}")
    t0 = time.monotonic()
    seconds = cuda_lib.build(sources)
    log(f"build: {len(seconds)} of {len(sources)} sources compiled in "
        f"{time.monotonic() - t0:.1f} s wall "
        + ", ".join(f"{s} {t:.1f} s" for s, t in seconds.items()))
    for source in sources:
        entry = ""
        for line in cuda_lib.build_log(source).splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1]) if "'" in line else ""
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {source} {entry}: {line.strip()}")
        cuda_lib.load(source)
    for source, tc_kernels in TC_KERNELS.items():
        counts = hgmma_counts(cuda_lib.library_path(source))
        for kernel in tc_kernels:
            found = {sym: n for sym, n in counts.items() if kernel in sym}
            for sym, n in sorted(found.items()):
                log(f"build: {kernel_name(sym)}: {n} HGMMA instructions")
            check(found and all(n > 0 for n in found.values()),
                  f"no HGMMA (wgmma) in the SASS of {kernel}: {found}")


def kernel_name(symbol: str) -> str:
    """A mangled kernel symbol as `name<template arguments>`, e.g.
    `flash_bwd_dq_tc<Li128>`: the source name is the one whose length
    prefix leads to a template argument list."""
    for m in re.finditer(r"\d+", symbol):
        digits, end = m.group(), m.end()
        for k in range(1, len(digits) + 1):
            length = int(digits[-k:])
            name, rest = symbol[end:end + length], symbol[end + length:]
            if name.isidentifier() and rest.startswith("I") and "E" in rest:
                return f"{name}<{rest[1:rest.index('E')]}>"
    return symbol[-60:]


def hgmma_counts(library) -> dict[str, int]:
    """{kernel symbol: HGMMA instructions in its SASS}, from cuobjdump."""
    from tony_tpu_torch.ops import cuda_lib
    tool = Path(cuda_lib.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts: dict[str, int] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            counts[current] = 0
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_fwd_times(q, k, v, causal: bool, scale: float, peaks,
                     iters: int, plain_iters: int, label: str) -> dict:
    """K1's device ms (and call ms) beside `blockwise_forward`'s, SDPA's
    forward on the same q, k, v and the bound, with its TFLOP/s and share
    of the bound logged."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.attention import (
        blockwise_forward, flash_fwd_cuda,
    )
    b, h, s, d = q.shape
    hk = k.shape[1]
    ms, call_ms = timed(lambda: flash_fwd_cuda(q, k, v, causal, scale),
                        iters)
    plain_ms, _ = timed(lambda: blockwise_forward(q, k, v, causal, scale),
                        plain_iters, warmup=1)
    library_ms, _ = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, enable_gqa=True), iters)
    bw, bf16_peak, f32_peak = peaks
    itemsize = q.element_size()
    nbytes = 2 * b * h * s * d * itemsize + 2 * b * hk * s * d * itemsize \
        + 4 * b * h * s
    # two products of 2 * D per (query, key) pair; causal keeps half
    flops = 4.0 * b * h * (s * s / 2 if causal else s * s) * d
    peak = bf16_peak if q.dtype == torch.bfloat16 else f32_peak
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    bound = max(t_bytes, t_ops)
    log(f"kernel flash_fwd {label}: {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound / ms * 100:.1f}% of its bound; SDPA forward "
        f"{library_ms:.4f} ms")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _flash_case(b: int, h: int, hk: int, s: int, d: int, causal: bool,
                dtype, peaks, iters: int) -> dict:
    """K1 against `blockwise_forward` on the same inputs; timed when
    `iters` is not 0."""
    import torch

    from tony_tpu_torch.ops.attention import (
        blockwise_forward, flash_fwd_cuda,
    )
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(s + 1000 * d + h)
    # the layout qkv_proj hands the kernel: (B, S, H, D) products viewed
    # as (B, H, S, D)
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    ref_out, ref_lse = blockwise_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    dtype_name = str(dtype).split(".")[-1]
    tol = TOL[dtype_name]
    shape = f"B{b} H{h} Hkv{hk} S{s} D{d}{' causal' if causal else ''}"
    r = {"shape": shape, "dtype": dtype_name, "tol": tol,
         "summary": (b, h, hk, s, d, causal) == (1, 32, 8, FLASH_SEQS[-1],
                                                 128, True),
         **merge(hold(out, ref_out, tol, dtype == torch.bfloat16, "out"),
                 hold(lse, ref_lse, tol, False))}
    if iters:
        r.update(_flash_fwd_times(q, k, v, causal, scale, peaks, iters,
                                  max(1, iters // 4), f"{dtype_name} {shape}"))
    return r


def _rms_case(rows: int, d: int, dtype, peaks, iters: int, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.rmsnorm import rms_norm_cuda, rms_norm_reference
    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
    w = torch.randn((d,), generator=g, device="cuda") * 0.1 + 1.0
    out = rms_norm_cuda(x, w, eps)
    ref = rms_norm_reference(x, w, eps)
    torch.cuda.synchronize()
    tol = TOL[str(dtype).split(".")[-1]]
    err, ok = max_err(out, ref, tol)
    ms, call_ms = timed(lambda: rms_norm_cuda(x, w, eps), iters)
    plain_ms, _ = timed(lambda: rms_norm_reference(x, w, eps), iters)
    w_x = w.to(dtype)
    library_ms, _ = timed(lambda: F.rms_norm(x, (d,), w_x, eps), iters)
    # as the path finds x between layers: not in the L2
    cold_ms = timed_cold(lambda: rms_norm_cuda(x, w, eps), iters, flush)
    cold_library_ms = timed_cold(lambda: F.rms_norm(x, (d,), w_x, eps),
                                 iters, flush)
    bw = peaks[0]
    nbytes = 2 * rows * d * x.element_size() + 4 * d
    # the kernel's dispatch on shape: 16-byte vectors where a row is a
    # whole number of them (x is aligned here)
    path = "vector" if d * x.element_size() % 16 == 0 else "scalar"
    return {"shape": f"rows{rows} D{d} ({path})",
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ok": ok, "tol": tol,
            "summary": (rows, d) == RMS_SUMMARY, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "cold_ms": cold_ms, "cold_library_ms": cold_library_ms,
            "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes"}


def _flash_bwd_case(b: int, h: int, hk: int, s: int, d: int, causal: bool,
                    dtype_name: str, layout: str, peaks, timed_case: bool
                    ) -> tuple[dict, dict, dict | None]:
    """K2 and K3 against `blockwise_backward` on the same (out, lse) and
    dO, in the layouts the training path gives them; at the timed case
    (the training shape) also K1's (out, lse) against `blockwise_forward`,
    K1, K2 and K3 run again and compared bit for bit, and their times
    beside the plain versions', SDPA's forward and SDPA's backward.
    Returns the K2 entry, the K3 entry and the K1 entry or None."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.attention import (
        attention_delta, blockwise_backward, blockwise_forward,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda,
    )
    dtype = getattr(torch, dtype_name)
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(s + h)

    def operand(heads):
        x = torch.randn((b, s, heads, d), generator=gen,
                        device="cuda").to(dtype).transpose(1, 2)
        return x.contiguous() if layout == "bhsd" else x

    q, k, v, dout = operand(h), operand(hk), operand(hk), operand(h)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    delta = attention_delta(dout, out)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale)
    want = blockwise_backward(q, k, v, out, lse, dout, causal, scale)
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name]
    bf16 = dtype == torch.bfloat16
    held = [hold(got, w, tol, bf16, name)
            for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv"))]
    shape = (f"B{b} H{h} Hkv{hk} S{s} D{d}"
             f"{' causal' if causal else ''}"
             f"{' bhsd' if layout == 'bhsd' else ''}")
    entries = [{"shape": shape, "dtype": dtype_name, "tol": tol,
                "summary": timed_case, **verdict}
               for verdict in (held[0], merge(held[1], held[2]))]
    del want, held
    if not timed_case:
        return entries[0], entries[1], None
    ref_out, ref_lse = blockwise_forward(q, k, v, causal, scale)
    fwd = {"shape": shape, "dtype": dtype_name, "tol": TOL[dtype_name],
           "summary": False,
           **merge(hold(out, ref_out, TOL[dtype_name], bf16, "out"),
                   hold(lse, ref_lse, LSE_TOL, False))}
    del ref_out, ref_lse
    # the kernels are deterministic: no atomics, a fixed order of sums
    again = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    again_out, again_lse = flash_fwd_cuda(q, k, v, causal, scale)
    again_dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    again_dk, again_dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                            causal, scale)
    torch.cuda.synchronize()
    for name, b_ in zip(again, (again_out, again_lse, again_dq, again_dk,
                                again_dv)):
        same = torch.equal(again[name], b_)
        log(f"kernel flash {shape}: {name} bitwise equal over two calls: "
            f"{same}")
        check(same, f"flash {name} differs between two calls")
    del again, again_out, again_lse, again_dq, again_dk, again_dv
    iters = 5
    fwd.update(_flash_fwd_times(q, k, v, causal, scale, peaks, iters, 1,
                                f"{dtype_name} {shape}"))
    ms_dq, call_dq = timed(lambda: flash_bwd_dq_cuda(
        q, k, v, dout, lse, delta, causal, scale), iters)
    ms_dkv, call_dkv = timed(lambda: flash_bwd_dkv_cuda(
        q, k, v, dout, lse, delta, causal, scale), iters)
    plain_ms, _ = timed(lambda: blockwise_backward(
        q, k, v, out, lse, dout, causal, scale), 2, warmup=1)
    # the library yardstick: SDPA's backward on the same q, k, v and dO
    # (one number for K2 and K3 together)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=causal, scale=scale, enable_gqa=True)
    library_ms, _ = timed(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), iters)
    library_call = lib_out.grad_fn.name()
    bw, bf16_peak, f32_peak = peaks
    peak = bf16_peak if dtype == torch.bfloat16 else f32_peak
    item = q.element_size()
    # each causal product covers half the S x S pairs
    pairs = s * s / 2 if causal else s * s
    product = 2.0 * b * h * pairs * d
    in_bytes = (2 * b * h * s * d + 2 * b * hk * s * d) * item \
        + 2 * 4 * b * h * s
    for name, entry, ms, call_ms, n_products, out_bytes in (
            ("flash_bwd_dq", entries[0], ms_dq, call_dq, 3,
             b * h * s * d * item),
            ("flash_bwd_dkv", entries[1], ms_dkv, call_dkv, 4,
             2 * b * hk * s * d * item)):
        t_ops = n_products * product / peak * 1e3
        t_bytes = (in_bytes + out_bytes) / bw * 1e3
        log(f"kernel {name} {shape}: "
            f"{n_products * product / ms / 1e9:.1f} TFLOP/s, "
            f"{max(t_ops, t_bytes) / ms * 100:.1f}% of its bound")
        entry.update({"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "library_call": library_call,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes"})
    return entries[0], entries[1], fwd


def _report(name: str, r: dict) -> None:
    """Log one case of a kernel: its errors, times and bound."""
    line = (f"kernel {name} {r['dtype']} {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e} (tol {r['tol']})")
    if "norm_err" in r:
        line += (f" norm_err {r['norm_err']:.3e} row_err "
                 f"{r['row_err']:.3e} at {r['worst_row']} "
                 f"(tol {NORM_TOL})")
    if "ms" in r:
        lib, call = r["library_ms"], r.get("library_call")
        line += (f" ms {r['ms']:.4f} call_ms {r['call_ms']:.4f} "
                 f"plain_ms {r['plain_ms']:.4f} library_ms "
                 f"{'null' if lib is None else f'{lib:.4f}'}"
                 f"{f' ({call})' if call else ''}"
                 f" bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    if "cold_ms" in r:
        line += (f" cold L2: ms {r['cold_ms']:.4f} library_ms "
                 f"{r['cold_library_ms']:.4f}")
    log(line + ("" if r["ok"] else "  <-- OUT OF TOLERANCE"))


def _hold_all(name: str, results: list[dict]) -> None:
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"{name} disagrees with its plain version at "
                   + ", ".join(f"{r['dtype']} {r['shape']}" for r in bad))


def phase_kernels(peaks) -> dict[str, dict]:
    """Every kernel at every listed shape and dtype. Returns, per kernel,
    its timed bf16 summary entry (serving's largest shape for K1 and K4,
    the training shape for K2 and K3), with the worst bf16 error."""
    import torch

    from tony_tpu_torch.ops.attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
    )
    from tony_tpu_torch.ops.rmsnorm import RMSNORM_FWD

    cases = {FLASH_FWD.name: [], FLASH_BWD_DQ.name: [],
             FLASH_BWD_DKV.name: [], RMSNORM_FWD.name: []}
    # written and read back between RMSNorm launches timed with a cold L2:
    # twice the L2
    flush = torch.empty(2 * torch.cuda.get_device_properties(0).L2_cache_size
                        // 4, device="cuda")
    def add(name: str, r: dict) -> None:
        _report(name, r)
        cases[name].append(r)

    for dtype in (torch.bfloat16, torch.float32):
        for s in FLASH_SEQS:
            add(FLASH_FWD.name, _flash_case(1, 32, 8, s, 128, True, dtype,
                                            peaks, 20 if s >= 512 else 50))
        for rows, d in RMS_CASES:
            add(RMSNORM_FWD.name,
                _rms_case(rows, d, dtype, peaks, 100, flush))
    del flush
    for case in FLASH_CASES:
        add(FLASH_FWD.name, _flash_case(*case, torch.bfloat16, peaks, 0))
    # the backward cases run on K1's (out, lse): a wrong forward fails here,
    # under its own name
    for name in (FLASH_FWD.name, RMSNORM_FWD.name):
        _hold_all(name, cases[name])
    for i, case in enumerate(BWD_CASES):
        layout = case[7] if len(case) > 7 else "bshd"
        dq, dkv, fwd = _flash_bwd_case(*case[:7], layout, peaks,
                                       timed_case=i == 0)
        add(FLASH_BWD_DQ.name, dq)
        add(FLASH_BWD_DKV.name, dkv)
        if fwd is not None:
            add(FLASH_FWD.name, fwd)
        torch.cuda.empty_cache()
    summary = {}
    for name, results in cases.items():
        _hold_all(name, results)
        bf16 = [r for r in results if r["dtype"] == "bfloat16"]
        top = dict(next(r for r in bf16 if r["summary"]))
        top["max_abs_err"] = max(r["max_abs_err"] for r in bf16)
        summary[name] = top
    return summary


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

def _post(url: str, body: dict, stream: bool, timeout: float = 600.0
          ) -> dict:
    """One /v1/generate request; returns {tokens, finish_reason, wall_s,
    first_s} (first_s: client-side time to the first streamed token)."""
    body = dict(body, stream=stream)
    rq = urllib.request.Request(url + "/v1/generate",
                                data=json.dumps(body).encode(),
                                headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    with urllib.request.urlopen(rq, timeout=timeout) as resp:
        if not stream:
            obj = json.loads(resp.read())
            return {"tokens": obj["tokens"],
                    "finish_reason": obj["finish_reason"],
                    "wall_s": time.monotonic() - t0, "first_s": None}
        tokens, finish = [], None
        for raw in resp:
            raw = raw.strip()
            if not raw:
                continue
            obj = json.loads(raw)
            if obj.get("done"):
                finish = obj["finish_reason"]
                break
            if first is None:
                first = time.monotonic() - t0
            tokens.append(obj["token"])
    return {"tokens": tokens, "finish_reason": finish,
            "wall_s": time.monotonic() - t0, "first_s": first}


def phase_serve(config_name: str) -> dict[str, int]:
    """Returns each kernel's launch count over the burst."""
    import numpy as np
    import torch

    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.ops.attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
    )
    from tony_tpu_torch.ops.rmsnorm import RMSNORM_FWD
    from tony_tpu_torch.serve.__main__ import build_arg_parser, build_server

    args = build_arg_parser().parse_args(
        ["--config", config_name, "--device", "cuda", "--slots", "4",
         "--token-budget", "2048", "--port", "0", "--host", "127.0.0.1"])
    t0 = time.monotonic()
    server = build_server(args)
    engine, cfg = server.engine, server.engine.config
    log(f"serve: {config_name} (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{str(cfg.dtype).split('.')[-1]}) built in "
        f"{time.monotonic() - t0:.1f} s; {engine.n_slots} slots, budget "
        f"{engine.token_budget}; weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    try:
        # one short request first: cuBLAS and allocator warm-up stay out
        # of the measured burst
        warm = _post(server.url, {"prompt": [1, 2, 3, 4, 5, 6, 7, 8],
                                  "max_new_tokens": 4}, stream=False)
        check(len(warm["tokens"]) == 4, f"warm-up request: {warm}")
        finished = []
        engine.on_request_finished = finished.append
        rng = np.random.RandomState(0)
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
                   for n in PROMPT_LENS]
        before = dict(engine.snapshot())
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        results: dict[int, object] = {}

        def run(i: int) -> None:
            try:
                results[i] = _post(server.url,
                                   {"prompt": prompts[i],
                                    "max_new_tokens": MAX_NEW},
                                   stream=i < N_STREAMED)
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e

        t_burst = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        burst_s = time.monotonic() - t_burst
        launches = cuda_lib.launches()
        after = dict(engine.snapshot())
        metrics = json.loads(urllib.request.urlopen(
            server.url + "/v1/metrics", timeout=30).read())
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        for i, n in enumerate(PROMPT_LENS):
            r = results.get(i)
            check(isinstance(r, dict), f"request {i} (prompt {n}): {r!r}")
            toks = r["tokens"]
            check(len(toks) == MAX_NEW and all(
                0 <= t < cfg.vocab_size for t in toks)
                and r["finish_reason"] == "length",
                f"request {i} (prompt {n}): {r}")
        check("tokens_emitted" in metrics, f"/v1/metrics: {metrics}")
        admissions = after["admissions"] - before["admissions"]
        steps = after["decode_steps"] - before["decode_steps"]
        check(admissions == len(PROMPT_LENS),
              f"{admissions} admissions for {len(PROMPT_LENS)} requests")
        want = {FLASH_FWD.name: cfg.n_layers * len(PROMPT_LENS),
                FLASH_BWD_DQ.name: 0, FLASH_BWD_DKV.name: 0,
                RMSNORM_FWD.name: (2 * cfg.n_layers + 1)
                * (admissions + steps)}
        log(f"serve: launches {launches}, expected {want} "
            f"({admissions} admissions, {steps} decode steps)")
        check(launches == want, f"launch counts {launches} != {want}")

        by_len = {len(h.prompt): h for h in finished}
        for i, n in enumerate(PROMPT_LENS):
            h = by_len[n]
            per_tok = h.decode_s / (len(h.tokens) - 1) * 1e3
            log(f"serve: request {i} prompt {n} "
                f"{'stream' if i < N_STREAMED else 'blocking'}: ttft "
                f"{h.ttft_s * 1e3:.1f} ms (queue {h.queue_wait_s * 1e3:.1f}"
                f" ms, prefill {h.prefill_s * 1e3:.1f} ms), decode "
                f"{per_tok:.2f} ms/token, wall {results[i]['wall_s']:.3f} s")
        total = len(PROMPT_LENS) * MAX_NEW
        log(f"serve: {total} tokens in {burst_s:.3f} s = "
            f"{total / burst_s:.1f} tokens/s; decode p50 "
            f"{metrics['decode_ms_per_token_p50']:.2f} ms/token; peak "
            f"memory allocated {peak_gib:.2f} GiB")

        # the 8B outputs are right in kind: a prefill's f32 logits are
        # finite and of the vocab's width
        from tony_tpu_torch.models.generate import prefill
        with torch.inference_mode():
            logits, _ = prefill(engine.params,
                                torch.tensor([prompts[1]], device="cuda"),
                                cfg, len(prompts[1]))
        check(logits.shape == (1, cfg.vocab_size)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"8B prefill logits {logits.shape} {logits.dtype}")
        return launches
    finally:
        server.stop(drain_timeout=0)
        del server, engine
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: engine against offline generate, tiny f32
# ---------------------------------------------------------------------------

def phase_engine() -> None:
    import numpy as np
    import torch

    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.llama import (
        get_config, llama_forward, llama_init,
    )
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine

    cfg = get_config("tiny")
    with torch.inference_mode():
        params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in (8, 5, 8, 11, 5, 3, 1)]

    # the forward on the card (kernels) against the forward on the CPU
    # (plain versions), same weights: f32 sums in another order
    cpu_params = {k: ({n: w.cpu() for n, w in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    toks = torch.tensor([prompts[3]])
    got = llama_forward(params, toks.cuda(), cfg).cpu()
    want = llama_forward(cpu_params, toks, cfg)
    err = float((got - want).abs().max())
    log(f"engine: tiny forward card vs cpu max_abs_err {err:.3e} "
        f"(tol 1e-4)")
    check(err <= 1e-4, f"tiny forward on the card differs by {err}")

    engine = ContinuousBatchingEngine(params, cfg, n_slots=2,
                                      token_budget=32, queue_depth=16)

    def drain(handles, max_steps=200):
        for _ in range(max_steps):
            if all(h.done.is_set() for h in handles):
                return
            engine.step()
        raise SmokeFailure("engine did not finish the workload")

    handles = [engine.submit(prompts[0], 6), engine.submit(prompts[1], 6)]
    engine.step()
    engine.step()
    handles.append(engine.submit(prompts[2], 4))
    handles.append(engine.submit(prompts[3], 6))
    engine.step()
    handles.append(engine.submit(prompts[4], 3))
    handles.append(engine.submit(prompts[5], 5))
    handles.append(engine.submit(prompts[6], 5))
    drain(handles)
    for h, p in zip(handles, prompts):
        want = generate(params, cfg, torch.tensor([p], device="cuda"),
                        h.max_new_tokens)[0].tolist()
        check(h.tokens == want and h.finish_reason == "length",
              f"engine request {h.request_id} (prompt {len(p)}): "
              f"{h.tokens} != offline {want}")
    log(f"engine: {len(handles)} staggered requests equal offline "
        f"generate token for token")


# ---------------------------------------------------------------------------
# optional phase: where the serving path's time goes
# ---------------------------------------------------------------------------

def phase_profile(config_name: str) -> None:
    """A prefill of 1900 tokens into one slot and a decode step over 4
    slots at full width: host wall time (CUDA-synchronised, profiler off),
    device busy time and the top kernels by device time (torch.profiler),
    and the device's idle share, 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.models.generate import (
        decode_step, empty_cache, prefill,
    )
    from tony_tpu_torch.serve.__main__ import _load_model, build_arg_parser

    args = build_arg_parser().parse_args(["--config", config_name])
    device = torch.device("cuda")
    params, cfg = _load_model(args, device)
    slots, budget = 4, 2048
    cache = empty_cache(cfg, slots, budget, device)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, 1900), generator=g,
                           device="cuda")
    rows = {n: a[:, 0:1] for n, a in cache.items()}
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=g,
                           device="cuda")
    pos = torch.tensor([1900, 700, 300, 20], device="cuda")
    work = {
        "prefill 1900 tokens": lambda: prefill(params, prompt, cfg, budget,
                                               cache=rows),
        "decode step, 4 slots": lambda: decode_step(params, cfg, cache,
                                                    tokens, pos),
    }
    with torch.inference_mode():
        for label, fn in work.items():
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                walls.append((time.monotonic() - t0) * 1e3)
            wall = sorted(walls)[len(walls) // 2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = device_events(prof)
            busy = sum(_device_us(e) for e in kernels) / 1e3
            n_launch = sum(e.count for e in kernels)
            log(f"profile: {label}: wall {wall:.2f} ms (median of 5), "
                f"device busy {busy:.2f} ms, idle share "
                f"{max(0.0, 1 - busy / wall):.3f}, {n_launch} device ops")
            log_top(kernels, 10)
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the training path at full width
# ---------------------------------------------------------------------------

def _step_launches(n_layers: int) -> dict[str, int]:
    """The kernel launches one save_flash training step must make: the
    flash forward once per layer (the replay takes its saved out and lse),
    each backward kernel once per layer, RMSNorm twice per layer plus the
    final norm in the forward and twice per layer again in the replay."""
    return {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers, "rmsnorm_fwd": 4 * n_layers + 1}


def phase_train() -> dict[str, int]:
    """One `Trainer.run()` of TRAIN_STEPS steps and a profiled last one.
    Its step is wrapped to count each step's kernel launches (counts set to
    0 just before the step, read just after); the step time, tokens/s and
    MFU are the Trainer's own `metrics_history`. Returns each kernel's
    launches over the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.device import peak_flops
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    steps = TRAIN_STEPS + 1                  # the last one is profiled
    args = build_arg_parser().parse_args(
        ["--config", TRAIN_CONFIG, "--device", "cuda", "--steps",
         str(steps), "--batch-size", str(TRAIN_BATCH), "--seq-len",
         str(TRAIN_SEQ), "--log-every", "1"])
    t0 = time.monotonic()
    trainer, cfg = build_trainer(args)
    trainer.setup()
    log(f"train: {TRAIN_CONFIG} (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, ffn {cfg.ffn_dim}, vocab "
        f"{cfg.vocab_size}, {str(cfg.dtype).split('.')[-1]}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, xent_chunk "
        f"{cfg.xent_chunk}), batch {TRAIN_BATCH} x {TRAIN_SEQ}; set up in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{cfg.num_params() / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    want = _step_launches(cfg.n_layers)
    step_fn = trainer.train_step
    per_step: list[dict[str, int]] = []
    profiled: dict = {}

    def counted_step(params, opt_state, batch):
        """The Trainer's step with its launches counted; the last step runs
        under the profiler, from a drained device to a drained device."""
        cuda_lib.reset_launches()
        if len(per_step) + 1 < steps:
            out = step_fn(params, opt_state, batch)
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t_step = time.monotonic()
                out = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
                profiled["wall_ms"] = (time.monotonic() - t_step) * 1e3
            profiled["prof"] = prof
        per_step.append({name: cuda_lib.launches()[name] for name in want})
        return out

    trainer.train_step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.run()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.metrics_history
    check(len(history) == steps and len(per_step) == steps,
          f"{len(history)} log entries, {len(per_step)} steps, want {steps}")
    total = {name: 0 for name in want}
    for entry, got in zip(history, per_step):
        log(f"train: step {entry['step']} loss {entry['loss']:.4f} "
            f"interval tokens/s {entry.get('tokens_per_s', 0.0):.1f} "
            f"launches {got}")
        check(got == want, f"step {entry['step']} launches {got} != {want}")
        for name in want:
            total[name] += got[name]
    losses = [e["loss"] for e in history]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # With log_every 1 the Trainer reads step k-1's loss at step k's
    # boundary, so in steady state the host time between two boundaries is
    # one step of device time. Step 1's interval is host issue alone, step
    # 2's holds the warm-up, and the last is profiled: steps 3-5 count.
    window = history[TRAIN_STEPS - 3:TRAIN_STEPS]
    check(all("mfu_pct" in e for e in window),
          f"the Trainer reported no MFU: {window}")
    tok_s = sorted(e["tokens_per_s"] for e in window)[1]
    mfu = sorted(e["mfu_pct"] for e in window)[1]
    peak = peak_flops(torch.device("cuda"))
    # the Trainer counts a batch's B x (S + 1) tokens, as the JAX one does
    step_s = TRAIN_BATCH * (TRAIN_SEQ + 1) / tok_s
    log(f"train: the Trainer's median interval over steps "
        f"{TRAIN_STEPS - 2}-{TRAIN_STEPS}: {step_s:.4f} s per step = "
        f"{tok_s:.1f} "
        f"tokens/s, MFU {mfu:.2f}% of {peak / 1e12:.0f} TFLOP/s "
        f"(flops_per_token {cfg.flops_per_token(TRAIN_SEQ):.4e}); peak "
        f"memory allocated {peak_gib:.2f} GiB (limit {TRAIN_PEAK_GIB})")
    check(peak_gib <= TRAIN_PEAK_GIB,
          f"peak memory {peak_gib:.2f} GiB > {TRAIN_PEAK_GIB} GiB")

    wall = profiled["wall_ms"]
    kernels = device_events(profiled["prof"])
    busy = sum(_device_us(e) for e in kernels) / 1e3
    copies = [e for e in kernels if "copy" in e.key.lower()
              or "memcpy" in e.key.lower()]
    log(f"profile: train step {steps}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
        f"{sum(e.count for e in kernels)} device ops, of which "
        f"{sum(e.count for e in copies)} copies "
        f"({sum(_device_us(e) for e in copies) / 1e3:.2f} ms)")
    log_top(kernels, 12)
    del trainer, profiled, step_fn
    torch.cuda.empty_cache()
    return total


def phase_train_parity() -> None:
    """`tiny` in f32 (save_flash remat on, so the selective checkpoint
    runs too), 3 SGD steps on the same batches from the same weights: on
    the card through the kernels, on the CPU through the plain versions.
    f32 sums in another order over three steps: 1e-4."""
    import torch

    from tony_tpu_torch.models.llama import get_config, llama_init, llama_loss
    from tony_tpu_torch.train.data import synthetic_tokens
    from tony_tpu_torch.train.optim import sgd, tree_leaves
    from tony_tpu_torch.train.step import make_train_step

    cfg = get_config("tiny", remat=True)
    with torch.no_grad():
        init = llama_init(cfg, torch.Generator().manual_seed(0))
    batches = synthetic_tokens(4, 64, cfg.vocab_size, seed=3)
    batches = [torch.from_numpy(next(batches)["tokens"]) for _ in range(3)]
    results = {}
    for device in ("cuda", "cpu"):
        params = {k: ({n: w.to(device, copy=True).requires_grad_()
                       for n, w in v.items()} if isinstance(v, dict)
                      else v.to(device, copy=True).requires_grad_())
                  for k, v in init.items()}
        opt = sgd(0.1)
        state = opt.init(params)
        fn = make_train_step(lambda p, b: llama_loss(p, b, cfg), opt)
        losses = []
        for tokens in batches:
            params, state, loss = fn(params, state,
                                     {"tokens": tokens.to(device)})
            losses.append(float(loss))
        results[device] = (losses, [t.detach().cpu()
                                    for t in tree_leaves(params)])
    loss_err = max(abs(a - b) for a, b in zip(results["cuda"][0],
                                              results["cpu"][0]))
    param_err = max(float((a - b).abs().max()) for a, b in
                    zip(results["cuda"][1], results["cpu"][1]))
    log(f"train: tiny 3 SGD steps, card vs cpu: losses "
        f"{results['cuda'][0]} vs {results['cpu'][0]}, max loss err "
        f"{loss_err:.3e}, max param err {param_err:.3e} (tol 1e-4)")
    check(loss_err <= 1e-4 and param_err <= 1e-4,
          f"tiny training on the card differs from the CPU by "
          f"{loss_err}, {param_err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,serve,engine,profile,train",
                    help="comma-separated phases to run")
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; it runs only on the "
              "card", file=sys.stderr)
        return 2
    try:
        import tony_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              f"from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card {name}; "
        f"nvidia-smi: {smi}")
    peaks = card_peaks(name)
    t_start = time.monotonic()
    try:
        kernels: dict[str, dict] = {}
        launches: dict[str, dict[str, int]] = {}
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            kernels = phase_kernels(peaks)
        if "serve" in phases:
            launches["serve"] = phase_serve(SERVE_CONFIG)
        if "engine" in phases:
            phase_engine()
        if "profile" in phases:
            phase_profile(SERVE_CONFIG)
        if "train" in phases:
            launches["train"] = phase_train()
            phase_train_parity()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    from tony_tpu_torch.ops import cuda_lib
    entries = []
    for kname, r in kernels.items():
        k = cuda_lib.KERNELS[kname]
        by_path = {path: counts.get(kname, 0)
                   for path, counts in launches.items()}
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"tony_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r.get("library_call"), "shape": r["shape"],
            "dtype": r["dtype"]})
    log(f"chip_smoke: phases {phases} passed in "
        f"{time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
