#!/usr/bin/env python3
"""Time K5, the port's W8A16 int8-weight product, of one source tree on
one card, at the decode products of llama3_8b and mixtral_proxy.

    python3 tools/k5_compare.py --tree DIR [--tag NAME] [--iters N]

DIR is the root of a checkout of this repository (its `tony_tpu_torch`
is imported, and its `csrc/int8_matmul.cu` built into DIR's own build
directory). To compare two trees on one card, run the script once per
tree in one command, in turns (A B B A): the numbers of one run are only
comparable with those of the same card.

Every product goes through the tree's public functions, so trees of
different K5 designs compare like with like: `int8_matmul` for a dense
product, and `models.moe._bank_product` for an int8 expert bank (E
experts of C rows). Each is first held against the plain version (the
f32 weight q * bf16(scale) and an f32 product; a bank, each expert's
plain product stacked) at bf16's 3e-2 and, by norm, 1e-2, and run twice
bit for bit, with a product of another shape launched in between. Then
timed: device ms per call (the calls queued behind a sleep kernel, so the
host's cost is hidden) and call ms (as the host issues them). Beside
them, each product's bytes bound on the card's memory rate, and two
library calls on the same inputs: torch.matmul (a bank: torch.bmm) on
the weight dequantized to bf16 beforehand, and torch._weight_int8pack_mm
on the (N, K) int8 weight with bf16 scales, or the error it raises.

Prints one line per product and, last, one JSON object with every case
and K5's sum over one decode step of 4 slots of each model: llama3_8b
32 x (wq, wk, wv, wo, w_gate, w_up, w_down) + the LM head; mixtral_proxy
16 x (wq, wk, wv, wo and the three expert banks) + the LM head.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BF16_TOL, NORM_TOL = 3e-2, 1e-2
ROWS = 4
# (label, K, N, LM head: f32 out); each at M 1 and 4 unless M4_ONLY
LLAMA = (("wq/wo", 4096, 4096, False), ("wk/wv", 4096, 1024, False),
         ("w_gate/w_up", 4096, 14336, False), ("w_down", 14336, 4096, False),
         ("output", 4096, 128256, True))
MIXTRAL = (("mixtral wq/wo", 2048, 2048, False),
           ("mixtral wk/wv", 2048, 1024, False),
           ("mixtral output", 2048, 32000, True))
# (label, E, C, K, N): mixtral_proxy's banks at its 4 slots (no-drop
# capacity: 4 rows an expert)
BANKS = (("mixtral we_gate/we_up", 8, 4, 2048, 4096),
         ("mixtral we_down", 8, 4, 4096, 2048))
# bytes/s of device memory by card name (tony_tpu_torch/device.py)
BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}


def events_ms(torch, fn, iters: int, sleep_cycles: int = 0) -> float:
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


def timed(torch, fn, iters: int) -> tuple[float, float]:
    """(device ms, call ms) per call, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    call = events_ms(torch, fn, iters)
    per_ms = 1e6 / events_ms(torch, lambda: torch.cuda._sleep(1_000_000), 1)
    cycles = int(max(2 * call * iters, 5.0) * per_ms)
    return events_ms(torch, fn, iters, cycles), call


def held(torch, got, want, again) -> dict:
    diff = (got.float() - want.float())
    err = float(diff.abs().max())
    norm = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    same = bool(torch.equal(got, again))
    return {"max_abs_err": err, "norm_err": norm, "bitwise": same,
            "ok": err <= BF16_TOL and norm <= NORM_TOL and same}


SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 9, 12, 16, 24, 32, 33, 48, 64, 96, 128)


def sweep(torch, opts, weight, g, bw) -> None:
    """Every split of K from SWEEP_SPLITS that the product allows (each k
    lane keeps 4 rows; a block's staged x fits), with the split sums
    added in one round (group = splits) and, from 12 splits, in two
    (group ~ sqrt(splits)): device ms of each, held against the plain
    version first. The tree's split plan and grouping are replaced for
    the sweep and put back after it."""
    import math

    from tony_tpu_torch.ops import int8_matmul as k5
    plan, grouping = k5.splits_for, k5.fold_group
    products = [(lab, 1, m, k, n) for lab, k, n, _ in LLAMA[:4]
                for m in (1, ROWS)]
    products += [(lab, 1, ROWS, k, n) for lab, k, n, _ in MIXTRAL[:2]]
    products += [(lab, e, c, k, n) for lab, e, c, k, n in BANKS]
    try:
        for label, e, m, k, n in products:
            t = weight(e, k, n) if e > 1 else weight(k, n)
            x = torch.randn((e, m, k) if e > 1 else (m, k), generator=g,
                            device="cuda").to(torch.bfloat16)
            ref = (torch.stack([k5.int8_matmul_reference(
                x[i], {"int8": t["int8"][i], "scale": t["scale"][i]})
                for i in range(e)]) if e > 1
                else k5.int8_matmul_reference(x, t))
            fn = ((lambda: k5.int8_bmm(x, t)) if e > 1
                  else (lambda: k5.int8_matmul(x, t)))
            least = -(-k * k5.rows_per_block(m) // k5.MAX_STAGED)
            best = None
            for s in SWEEP_SPLITS:
                if s < least or s > max(1, k // 32):
                    continue
                for grp in sorted({s, math.isqrt(s - 1) + 1 if s >= 12
                                   else s}, reverse=True):
                    k5.splits_for = lambda *a, s=s, **kw: s
                    k5.fold_group = lambda *a, grp=grp: grp
                    out = fn()
                    err = float((out.float() - ref.float()).abs().max())
                    ms, _ = timed(torch, fn, opts.iters)
                    ok = err <= BF16_TOL
                    if ok and (best is None or ms < best[0]):
                        best = (ms, s, grp)
                    print(f"k5_compare {opts.tag}: sweep {label} E{e} M{m} "
                          f"K{k} N{n} splits {s} group {grp}: ms {ms:.4f} "
                          f"max_abs_err {err:.3e}"
                          + ("" if ok else "  <-- OUT OF TOLERANCE"),
                          flush=True)
            print(f"k5_compare {opts.tag}: sweep best {label} E{e} M{m}: "
                  f"splits {best[1]} group {best[2]} ms {best[0]:.4f} "
                  f"(plan {plan(m, k, n, 132, e)}, bound "
                  f"{e * k * n / bw * 1e3:.4f})", flush=True)
            del t, x, ref
    finally:
        k5.splits_for, k5.fold_group = plan, grouping


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sweep", action="store_true",
                    help="also time every split of K (and one or two "
                         "rounds of adding the split sums) at each product "
                         "of a tree whose ops/int8_matmul.py has "
                         "fold_group")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("k5_compare: torch sees no CUDA device", file=sys.stderr)
        return 2
    import tony_tpu_torch
    if not os.path.abspath(tony_tpu_torch.__file__).startswith(tree):
        print(f"k5_compare: imported {tony_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    from tony_tpu_torch.models.moe import _bank_product
    from tony_tpu_torch.models.quant import dequantize, quantize
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.ops.int8_matmul import (
        INT8_MATMUL, int8_matmul, int8_matmul_reference,
    )
    from tony_tpu_torch.ops.xent import matmul_f32

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    bw = next((v for k, v in BYTES_PER_S.items() if k in name), None)
    if bw is None:
        print(f"k5_compare: no memory rate known for {name!r}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    cuda_lib.build([INT8_MATMUL.source])
    print(f"k5_compare {opts.tag}: tree {tree}; {smi}; torch "
          f"{torch.__version__}; built in {time.monotonic() - t0:.1f} s",
          flush=True)
    # nvcc's -Xptxas -v report: each w8a16 instance's registers and spills
    entry = ""
    for line in cuda_lib.build_log(INT8_MATMUL.source).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else ""
        elif "w8a16" in entry and ("registers" in line or "spill" in line):
            print(f"k5_compare {opts.tag}: nvcc {entry[:40]}: {line.strip()}")
    # the card's clocks up before the first timing
    warm = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    for _ in range(50):
        warm @ warm
    torch.cuda.synchronize()
    del warm
    g = torch.Generator(device="cuda").manual_seed(0)

    def weight(*shape):
        return quantize((torch.randn(shape, generator=g, device="cuda")
                         * shape[-2] ** -0.5).to(torch.bfloat16))

    # a product of another shape, launched between a case's two calls:
    # a counter a launch left non-zero would show in the second
    other_t = weight(1024, 2048)
    other_x = torch.randn((3, 1024), generator=g,
                          device="cuda").to(torch.bfloat16)

    def other():
        int8_matmul(other_x, other_t)

    cases, bad = [], []

    def run(label, m, x, t, fn, ref, lib, nbytes, e=1):
        out = fn()
        other()
        again = fn()
        r = held(torch, out, ref(), again)
        r.update(label=label, m=m, e=e)
        # timed twice, the first a warm-up (a process's first timings of
        # a new library read high)
        timed(torch, fn, opts.iters)
        r["ms"], r["call_ms"] = timed(torch, fn, opts.iters)
        r["bound_ms"] = nbytes / bw * 1e3
        for key, call in lib.items():
            try:
                r[key], _ = timed(torch, call, opts.iters)
            except Exception as exc:  # record why the library call fails
                r[key] = None
                r[key + "_error"] = f"{type(exc).__name__}: {exc}"[:200]
        cases.append(r)
        if not r["ok"]:
            bad.append(f"{label} M{m}")
        lib_txt = " ".join(
            f"{k} {r[k]:.4f}" if r[k] is not None
            else f"{k} ({r[k + '_error']})" for k in lib)
        print(f"k5_compare {opts.tag}: {label} E{e} M{m}: ms {r['ms']:.4f} "
              f"call_ms {r['call_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"{lib_txt} max_abs_err {r['max_abs_err']:.3e} norm_err "
              f"{r['norm_err']:.3e} bitwise {r['bitwise']}"
              + ("" if r["ok"] else "  <-- OUT OF TOLERANCE"), flush=True)

    for group, rows in ((LLAMA, (1, ROWS)), (MIXTRAL, (ROWS,))):
        for label, k, n, out_f32 in group:
            t = weight(k, n)
            w = dequantize(t)
            q_nk = t["int8"].t().contiguous()
            s_n = t["scale"].reshape(-1).to(torch.bfloat16)
            for m in rows:
                x = torch.randn((m, k), generator=g,
                                device="cuda").to(torch.bfloat16)
                out_bytes = 4 if out_f32 else 2
                nbytes = k * n + 4 * n + 2 * m * k + out_bytes * m * n
                run(label, m, x, t,
                    lambda: int8_matmul(x, t, out_f32),
                    lambda: int8_matmul_reference(x, t, out_f32),
                    {"matmul_bf16_ms": (lambda: matmul_f32(x, w)) if out_f32
                     else (lambda: x @ w),
                     "int8pack_mm_ms": lambda: torch._weight_int8pack_mm(
                         x, q_nk, s_n)},
                    nbytes)
            del t, w, q_nk
    for label, e, c, k, n in BANKS:
        t = weight(e, k, n)
        w = dequantize(t)
        x = torch.randn((e, c, k), generator=g,
                        device="cuda").to(torch.bfloat16)
        nbytes = e * (k * n + 4 * n + 2 * c * k + 2 * c * n)
        run(label, c, x, t, lambda: _bank_product(x, t),
            lambda: torch.stack([int8_matmul_reference(
                x[i], {"int8": t["int8"][i], "scale": t["scale"][i]})
                for i in range(e)]),
            {"bmm_bf16_ms": lambda: torch.bmm(x, w)}, nbytes, e)
        del t, w

    if opts.sweep:
        sweep(torch, opts, weight, g, bw)
    by = {(r["label"], r["m"]): r for r in cases}

    def step(key):
        llama = 32 * sum(mult * by[lab, ROWS][key] for lab, mult in (
            ("wq/wo", 2), ("wk/wv", 2), ("w_gate/w_up", 2), ("w_down", 1))
        ) + by["output", ROWS][key]
        mixtral = 16 * sum(mult * by[lab, ROWS][key] for lab, mult in (
            ("mixtral wq/wo", 2), ("mixtral wk/wv", 2),
            ("mixtral we_gate/we_up", 2), ("mixtral we_down", 1))
        ) + by["mixtral output", ROWS][key]
        return llama, mixtral

    steps = {key: step(key) for key in ("ms", "call_ms", "bound_ms")}
    print(f"k5_compare {opts.tag}: K5 over one decode step of {ROWS} slots: "
          f"llama3_8b {steps['ms'][0]:.4f} ms (call {steps['call_ms'][0]:.4f}"
          f", bound {steps['bound_ms'][0]:.4f}); mixtral_proxy "
          f"{steps['ms'][1]:.4f} ms (call {steps['call_ms'][1]:.4f}, bound "
          f"{steps['bound_ms'][1]:.4f})", flush=True)
    print(json.dumps({"tag": opts.tag, "tree": tree, "card": smi,
                      "steps": steps, "cases": cases, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
