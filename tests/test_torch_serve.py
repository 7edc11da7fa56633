"""The port's serving path (tony_tpu_torch/serve) on the CPU, and the port's
isolation from JAX.

The load-bearing contract, as tests/test_serve.py pins it for the JAX
package: continuous-batching greedy decode equals the offline `generate()`
for the same prompts, under staggered arrivals and slot recycling. Around
it: backpressure, the HTTP frontend (blocking and streamed), the entry
point's lifecycle and flags, and that neither the port nor chip_smoke.py
loads jax or tony_tpu.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.models.llama import get_config, llama_init
from tony_tpu_torch.serve.__main__ import build_arg_parser, build_server
from tony_tpu_torch.serve.engine import (
    BudgetExceededError, ContinuousBatchingEngine, QueueFullError,
)
from tony_tpu_torch.serve.frontend import ServeFrontend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tiny")
    return llama_init(cfg, torch.Generator().manual_seed(0)), cfg


def _prompts(cfg, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
            for n in lengths]


def _oracle(params, cfg, prompt, n, **kw):
    """Offline single-request greedy generate — the parity oracle."""
    return generate(params, cfg, torch.tensor([prompt]), n, **kw)[0].tolist()


def _drain(engine, handles, max_steps=200):
    for _ in range(max_steps):
        if all(h.done.is_set() for h in handles):
            return
        engine.step()
    raise AssertionError("engine did not finish the workload")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_staggered_arrivals_equal_offline_generate(model):
    params, cfg = model
    prompts = _prompts(cfg, (8, 5, 8, 11, 5, 3, 1))
    engine = ContinuousBatchingEngine(params, cfg, n_slots=2,
                                      token_budget=32, queue_depth=16)
    handles = [engine.submit(prompts[0], 6), engine.submit(prompts[1], 6)]
    engine.step()
    engine.step()
    # staggered: these arrive while slots are mid-decode
    handles.append(engine.submit(prompts[2], 4))
    handles.append(engine.submit(prompts[3], 6))
    engine.step()
    handles += [engine.submit(p, 5) for p in prompts[4:]]
    _drain(engine, handles)
    for h, p in zip(handles, prompts):
        assert h.tokens == _oracle(params, cfg, p, h.max_new_tokens), \
            f"request {h.request_id} diverged"
        assert h.finish_reason == "length"
    snap = engine.snapshot()
    assert snap["admissions"] == len(prompts)
    assert snap["tokens_emitted"] == sum(h.max_new_tokens for h in handles)
    assert engine.active_slots() == 0


def test_slot_recycling_under_eos_latch(model):
    params, cfg = model
    prompts = _prompts(cfg, (6, 9, 4), seed=1)
    full = _oracle(params, cfg, prompts[0], 8)
    eos = full[2]
    engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                      token_budget=32, queue_depth=8,
                                      eos_id=eos)
    handles = [engine.submit(prompts[0], 8), engine.submit(prompts[1], 4),
               engine.submit(prompts[2], 4)]
    _drain(engine, handles)
    first = handles[0]
    assert first.finish_reason == "eos" and first.tokens[-1] == eos
    assert first.tokens == full[:len(first.tokens)]
    for h, p in zip(handles[1:], prompts[1:]):
        want = _oracle(params, cfg, p, h.max_new_tokens, eos_id=eos)
        assert h.tokens == want[:len(h.tokens)]


def test_submit_validation_and_backpressure(model):
    params, cfg = model
    engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                      token_budget=16, queue_depth=2)
    with pytest.raises(BudgetExceededError):
        engine.submit(list(range(10)), 10)      # 20 > budget 16
    with pytest.raises(BudgetExceededError):
        engine.submit([], 4)
    with pytest.raises(BudgetExceededError):
        engine.submit([cfg.vocab_size], 4)      # out-of-range id
    engine.submit([1, 2, 3], 4)
    engine.submit([1, 2, 3], 4)
    with pytest.raises(QueueFullError):
        engine.submit([1, 2, 3], 4)             # queue_depth=2
    assert engine.snapshot()["requests_rejected"] == 1


def test_cancel_and_stop_finish_every_handle(model):
    params, cfg = model
    engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                      token_budget=32, queue_depth=8)
    a = engine.submit([1, 2, 3], 10)
    b = engine.submit([4, 5], 10)
    engine.step()
    a.cancel()
    engine.step()
    assert a.finish_reason == "cancelled"
    engine.stop()
    assert b.done.is_set() and b.finish_reason in ("shutdown", "length")


def test_drain_refuses_new_work(model):
    from tony_tpu_torch.serve.engine import DrainingError
    params, cfg = model
    engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                      token_budget=32)
    h = engine.submit([1, 2], 3)
    engine.begin_drain()
    with pytest.raises(DrainingError):
        engine.submit([1], 2)
    assert not engine.drained()
    _drain(engine, [h])
    assert engine.drained() and engine.load()["draining"]


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(url, body, timeout=60):
    rq = urllib.request.Request(url + "/v1/generate",
                                data=json.dumps(body).encode(),
                                headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(rq, timeout=timeout) as resp:
        return [json.loads(line) for line in resp.read().splitlines()
                if line.strip()]


def test_http_round_trip_blocking_and_streamed(model):
    params, cfg = model
    engine = ContinuousBatchingEngine(params, cfg, n_slots=2,
                                      token_budget=32, queue_depth=8)
    engine.start()
    frontend = ServeFrontend(engine, port=0, host="127.0.0.1")
    frontend.start()
    url = f"http://127.0.0.1:{frontend.port}"
    try:
        prompt = _prompts(cfg, (6,), seed=4)[0]
        want = _oracle(params, cfg, prompt, 5)
        [blocking] = _post(url, {"prompt": prompt, "max_new_tokens": 5})
        assert blocking["tokens"] == want
        assert blocking["finish_reason"] == "length"
        lines = _post(url, {"prompt": prompt, "max_new_tokens": 5,
                            "stream": True})
        assert [line["token"] for line in lines[:-1]] == want
        assert lines[-1]["done"] and lines[-1]["n_tokens"] == 5
        for path, key in (("/healthz", "ok"), ("/v1/metrics",
                                                "tokens_emitted"),
                          ("/v1/load", "slots_free")):
            body = json.loads(urllib.request.urlopen(url + path,
                                                     timeout=10).read())
            assert key in body, path
        for body, code in (({"prompt": "x"}, 400),
                           ({"prompt": list(range(40))}, 400),
                           ({"prompt": [1], "temperature": 0.5}, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, body)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/v1/nope", timeout=10)
        assert e.value.code == 404
    finally:
        frontend.stop()
        engine.stop()


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_build_server_on_cpu_serves():
    args = build_arg_parser().parse_args(
        ["--device", "cpu", "--slots", "2", "--token-budget", "64",
         "--port", "0", "--host", "127.0.0.1"])
    server = build_server(args)
    try:
        assert server.engine.token_budget == 64
        [out] = _post(server.url, {"prompt": [3, 1, 4], "max_new_tokens": 4})
        assert len(out["tokens"]) == 4
    finally:
        server.stop(drain_timeout=5)


def test_cuda_without_a_card_raises(monkeypatch):
    from tony_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(build_arg_parser().parse_args([]))


@pytest.mark.parametrize("flags", [
    ["--quant", "int8"], ["--quant-cache"], ["--checkpoint-dir", "/x"],
    ["--prefix-sharing", "on"], ["--role", "prefill"],
    ["--migrate-to", "http://h:1"], ["--kv-pages", "64"],
    ["--config", "moe_tiny"],
])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="slice"):
        build_server(build_arg_parser().parse_args(["--device", "cpu",
                                                    *flags]))


def test_serve_main_up_and_sigterm():
    """python -m tony_tpu_torch.serve: SERVING_UP, one request, SIGTERM,
    clean exit."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.serve", "--device", "cpu",
         "--port", "0", "--host", "127.0.0.1", "--token-budget", "32"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVING_UP http://127.0.0.1:"), line
        url = line.split()[1]
        [out] = _post(url, {"prompt": [5, 6], "max_new_tokens": 3})
        assert len(out["tokens"]) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# isolation from jax and tony_tpu; chip_smoke needs a card
# ---------------------------------------------------------------------------

ISOLATION_PROBE = """
import importlib, pkgutil, sys
import tony_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tony_tpu_torch.__path__,
                                               "tony_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# top-level package of every loaded module: "tony_tpu_torch" is not
# "tony_tpu", though it starts with it
bad = sorted({n.split(".")[0] for n in sys.modules}
             & {"jax", "jaxlib", "tony_tpu"})
print(len(names), ",".join(bad))
"""


def test_port_and_chip_smoke_load_no_jax_and_no_tony_tpu():
    out = subprocess.run([sys.executable, "-c", ISOLATION_PROBE],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    n_modules, _, bad = out.stdout.strip().partition(" ")
    assert int(n_modules) >= 12
    assert bad == "", f"loaded: {bad}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run, not fail")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env={k: v for k, v in
                                            os.environ.items()
                                            if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
