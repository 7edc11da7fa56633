#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (`tony_tpu_torch`) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase, as the port's proof of life

Phases (any failure exits non-zero, and the result line is not printed):

1. build    — compile every hand-written CUDA kernel from `tony_tpu_torch/
              csrc/` (one nvcc per source, all at once); print the build
              seconds, nvcc's register report and the card's name and
              power limit.
2. kernels  — call each kernel's wrapper at the serving path's shapes and
              hold it against its plain PyTorch version on the same inputs
              (bf16 at 3e-2, f32 at 2e-5, as tests/test_ops.py holds the
              JAX kernels); print max error, kernel ms, plain ms, the
              library call's ms and the bound.
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

`--phases build,kernels` (for instance) runs a subset.

Two lines before the last is a JSON object with one entry per kernel, then
the card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request

# (substring of the card's name, memory TB/s, dense bf16 TFLOP/s, f32
# non-tensor TFLOP/s), from NVIDIA's data sheets; first match wins
PEAKS = (
    ("H100 PCIe", 2.0, 756.0, 51.0),
    ("H100 NVL", 3.9, 835.0, 60.0),
    ("H200", 4.8, 989.0, 67.0),
    ("H100", 3.35, 989.0, 67.0),
)

SERVE_CONFIG = "llama3_8b"
FLASH_SEQS = (1, 37, 512, 513, 2000)
RMS_ROWS = (1, 4, 513, 2000)
TOL = {"bfloat16": 3e-2, "float32": 2e-5}
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
    for key, tbs, bf16, f32 in PEAKS:
        if key in name:
            return tbs * 1e12, bf16 * 1e12, f32 * 1e12
    raise SmokeFailure(f"no peak rates known for {name!r}")


def _device_us(event) -> float:
    return event.self_device_time_total


def device_events(prof) -> list:
    """A profile's device-side events (kernels, copies, fills): the host
    ops that launched them carry the same time again."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]


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
    cycles_per_ms = 1e6 / _events_ms(lambda: torch.cuda._sleep(1_000_000), 1)
    cycles = int(cycles_per_ms * max(5.0, 2 * call_ms * iters))
    return _events_ms(fn, iters, sleep_cycles=cycles), call_ms


def max_err(got, want, tol: float) -> tuple[float, bool]:
    """max |got - want| and whether |got - want| <= tol + tol * |want|
    everywhere (numpy's assert_allclose with atol = rtol = tol)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.all(diff <= tol + tol * w.abs()).item()) and \
        bool(torch.isfinite(g).all().item())
    return float(diff.max().item()), ok


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
        for line in cuda_lib.build_log(source).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {source}: {line.strip()}")
        cuda_lib.load(source)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_case(s: int, dtype, peaks, iters: int) -> dict:
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.attention import (
        blockwise_forward, flash_fwd_cuda,
    )
    b, h, hk, d = 1, 32, 8, 128
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(s)
    # the layout qkv_proj hands the kernel: (B, S, H, D) products viewed
    # as (B, H, S, D)
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    out, lse = flash_fwd_cuda(q, k, v, True, scale)
    ref_out, ref_lse = blockwise_forward(q, k, v, True, scale)
    torch.cuda.synchronize()
    tol = TOL[str(dtype).split(".")[-1]]
    err_o, ok_o = max_err(out, ref_out, tol)
    err_l, ok_l = max_err(lse, ref_lse, tol)
    ms, call_ms = timed(lambda: flash_fwd_cuda(q, k, v, True, scale), iters)
    plain_ms, _ = timed(lambda: blockwise_forward(q, k, v, True, scale),
                        max(1, iters // 4))
    library_ms, _ = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True), iters)
    bw, bf16_peak, f32_peak = peaks
    itemsize = q.element_size()
    nbytes = 2 * b * h * s * d * itemsize + 2 * b * hk * s * d * itemsize \
        + 4 * b * h * s
    flops = 2.0 * b * h * s * s * d          # causal: half of 4 * S^2 * D
    peak = bf16_peak if dtype == torch.bfloat16 else f32_peak
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return {"shape": f"B{b} H{h} Hkv{hk} S{s} D{d} causal",
            "dtype": str(dtype).split(".")[-1], "max_abs_err": max(err_o,
                                                                    err_l),
            "ok": ok_o and ok_l, "tol": tol, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _rms_case(rows: int, dtype, peaks, iters: int) -> dict:
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.rmsnorm import rms_norm_cuda, rms_norm_reference
    d, eps = 4096, 1e-5
    g = torch.Generator(device="cuda").manual_seed(rows)
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
    bw = peaks[0]
    nbytes = 2 * rows * d * x.element_size() + 4 * d
    return {"shape": f"rows{rows} D{d}", "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ok": ok, "tol": tol, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes"}


def phase_kernels(peaks) -> dict[str, dict]:
    """Every kernel at every listed shape and dtype. Returns, per kernel,
    the bf16 entry at the largest shape, with the worst bf16 error."""
    import torch

    from tony_tpu_torch.ops.attention import FLASH_FWD
    from tony_tpu_torch.ops.rmsnorm import RMSNORM_FWD

    cases = {FLASH_FWD.name: [], RMSNORM_FWD.name: []}
    for dtype in (torch.bfloat16, torch.float32):
        for s in FLASH_SEQS:
            cases[FLASH_FWD.name].append(
                _flash_case(s, dtype, peaks, 20 if s >= 512 else 50))
        for rows in RMS_ROWS:
            cases[RMSNORM_FWD.name].append(_rms_case(rows, dtype, peaks, 100))
    summary = {}
    for name, results in cases.items():
        for r in results:
            lib = r["library_ms"]
            log(f"kernel {name} {r['dtype']} {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3e} (tol {r['tol']}) ms {r['ms']:.4f} "
                f"call_ms {r['call_ms']:.4f} plain_ms {r['plain_ms']:.4f} "
                f"library_ms {'null' if lib is None else f'{lib:.4f}'} "
                f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
                f"{'' if r['ok'] else '  <-- OUT OF TOLERANCE'}")
        bad = [r for r in results if not r["ok"]]
        check(not bad, f"{name} disagrees with its plain version at "
                       + ", ".join(f"{r['dtype']} {r['shape']}" for r in bad))
        bf16 = [r for r in results if r["dtype"] == "bfloat16"]
        top = dict(bf16[-1])
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
    from tony_tpu_torch.ops.attention import FLASH_FWD
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
            for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
                log(f"profile:   {_device_us(e) / 1e3:8.3f} ms  "
                    f"x{e.count:<5d} {e.key[:90]}")
    del params, cache
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve,engine,profile",
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
        launches: dict[str, int] = {}
        if "build" in phases:
            phase_build()
        if "kernels" in phases:
            kernels = phase_kernels(peaks)
        if "serve" in phases:
            launches = phase_serve(SERVE_CONFIG)
        if "engine" in phases:
            phase_engine()
        if "profile" in phases:
            phase_profile(SERVE_CONFIG)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    from tony_tpu_torch.ops import cuda_lib
    entries = []
    for kname, r in kernels.items():
        k = cuda_lib.KERNELS[kname]
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"tony_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches.get(kname, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
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
