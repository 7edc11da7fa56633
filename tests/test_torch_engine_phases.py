"""The port's serving engine step phases, the MoE layer's expert-row
counters and the train step's ranges, on the CPU at tiny sizes.

- Each admission and decode step is counted into `EngineStats`'s phase
  sums (`PHASE_COUNTERS`, also in `snapshot()` and `/v1/metrics`).
- The phases cover `step()`'s wall, and with the loop's idle wait the
  loop's wall, within 5%.
- Under `torch.profiler` the step's phases are flat `engine.*` ranges
  (`engine.admit.wait` nested in `engine.admit`), one per admission and
  decode step, and the update is a `train.optimizer` range inside
  `train_step`; with the profiler off `device_range` never enters a
  `record_function`.
- `moe_mlp` counts E * C rows executed and T * k routed a call.
- Greedy streams, traced or not, equal the offline `generate()`.
"""

import time
from functools import partial

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tony_tpu_torch.models import moe
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.models.llama import get_config, llama_init, llama_loss
# imported by the engine's loop as it starts: imported here, so that its
# first import does not count in the loop's wall
import tony_tpu_torch.observability.profiler  # noqa: F401
from tony_tpu_torch.observability.metrics import REGISTRY
from tony_tpu_torch.serve.engine import (
    PHASE_COUNTERS, ContinuousBatchingEngine,
)
from tony_tpu_torch.serve.frontend import engine_prometheus_text
from tony_tpu_torch.train import optim
from tony_tpu_torch.train.step import make_train_step

pytestmark = pytest.mark.serving

PHASES = ("admit_s", "decode_launch_s", "decode_wait_s", "decode_emit_s")
LENGTHS = (8, 5, 11, 3)
MAX_NEW = 6


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tiny")
    return llama_init(cfg, torch.Generator().manual_seed(0)), cfg


def _prompts(cfg, lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
            for n in lengths]


def _engine(model, n_slots=2):
    params, cfg = model
    return ContinuousBatchingEngine(params, cfg, n_slots=n_slots,
                                    token_budget=32, queue_depth=16)


def _drain(engine, handles, max_steps=200):
    """Steps until every handle is done; the steps that did work."""
    busy = 0
    for _ in range(max_steps):
        if all(h.done.is_set() for h in handles):
            return busy
        busy += engine.step()
    raise AssertionError("engine did not finish the workload")


def _staggered(engine, prompts):
    """Two requests, two steps, then the rest: admissions land between
    decode steps."""
    handles = [engine.submit(p, MAX_NEW) for p in prompts[:2]]
    engine.step()
    engine.step()
    handles += [engine.submit(p, MAX_NEW) for p in prompts[2:]]
    return handles, 2 + _drain(engine, handles)


def _assert_streams_equal_generate(model, prompts, handles):
    params, cfg = model
    for h, p in zip(handles, prompts):
        want = generate(params, cfg, torch.tensor([p]), MAX_NEW)[0].tolist()
        assert h.tokens == want, f"request {h.request_id} diverged"


def test_phase_counters_count_each_admission_and_decode_step(model):
    engine = _engine(model)
    prompts = _prompts(model[1])
    # each admission's sums are in stats before the next admission of
    # the same step starts, in step with `admissions`
    seen = []
    admit = engine._admit

    def spy(slot, handle):
        seen.append((engine.stats.admissions,
                     engine.stats.prompt_tokens_admitted))
        return admit(slot, handle)

    engine._admit = spy
    handles, _ = _staggered(engine, prompts)
    assert seen == [(i, sum(LENGTHS[:i])) for i in range(len(prompts))]
    snap = engine.snapshot()
    stats = engine.stats
    assert snap["admissions"] == len(prompts)
    assert snap["prompt_tokens_admitted"] == sum(LENGTHS)
    # 2 slots, 4 requests of 6 tokens: the first token of each comes from
    # its admission, 5 more from decode steps over both slots
    assert snap["decode_steps"] == 2 * (MAX_NEW - 1)
    assert snap["tokens_emitted"] == len(prompts) * MAX_NEW
    assert len(stats.itl_s) == len(prompts) * (MAX_NEW - 1)
    for key in PHASE_COUNTERS:
        assert snap[key] == getattr(stats, key)
        if key != "idle_wait_s":        # step() was driven by hand
            assert snap[key] > 0, key
    assert snap["admit_wait_s"] < snap["admit_s"]
    text = engine_prometheus_text(engine)
    assert "serving_decode_wait_s " in text
    assert "serving_prompt_tokens_admitted " in text
    _assert_streams_equal_generate(model, prompts, handles)


def test_phases_cover_the_step_and_the_loop(model):
    engine = _engine(model)
    _staggered(engine, _prompts(model[1]))
    s = engine.stats
    phases = sum(getattr(s, k) for k in PHASES)
    assert 0.95 * s.step_s <= phases <= s.step_s
    # the loop: steps that did work and its idle waits cover its wall
    engine = _engine(model)
    t0 = time.perf_counter()
    engine.start()
    try:
        handles = [engine.submit(p, MAX_NEW)
                   for p in _prompts(model[1], seed=1)]
        for h in handles:
            assert h.done.wait(timeout=60)
        time.sleep(0.5)                 # idle ticks, which count too
    finally:
        engine.stop()
        wall = time.perf_counter() - t0
    covered = engine.stats.step_s + engine.stats.idle_wait_s
    assert engine.stats.idle_wait_s > 0
    assert 0.95 * wall <= covered <= wall


def _ranges(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def test_ranges_under_the_profiler(model):
    engine = _engine(model)
    prompts = _prompts(model[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        handles, _ = _staggered(engine, prompts)
    _assert_streams_equal_generate(model, prompts, handles)
    engine_ranges = _ranges(prof, "engine.")
    names = [e.name for e in engine_ranges]
    assert names.count("engine.admit") == engine.stats.admissions
    assert names.count("engine.admit.wait") == engine.stats.admissions
    for phase in ("launch", "wait", "emit"):
        assert (names.count(f"engine.decode.{phase}")
                == engine.stats.decode_steps)
    for e in engine_ranges:
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        # flat: only the first token's read nests, in its admission
        want = "engine.admit" if e.name == "engine.admit.wait" else None
        assert parent == want, (e.name, parent)
    launch = next(e for e in engine_ranges
                  if e.name == "engine.decode.launch")
    assert any(c.name.startswith("aten::") for c in launch.cpu_children)


def test_train_step_ranges_under_the_profiler():
    cfg = get_config("tiny")
    params = llama_init(cfg, torch.Generator().manual_seed(0))
    for leaf in optim.tree_leaves(params):
        leaf.requires_grad_(True)
    optimizer = optim.adamw(lambda step: 1e-3)
    train_step = make_train_step(partial(llama_loss, config=cfg), optimizer)
    opt_state = optimizer.init(params)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 9))).long()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(params, opt_state, {"tokens": tokens})
    (step_range,) = _ranges(prof, "train_step")
    (opt_range,) = _ranges(prof, "train.optimizer")
    assert opt_range.cpu_parent is step_range
    assert train_step.step_num == 1


def test_no_record_function_with_the_profiler_off(model, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def spy(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    engine = _engine(model)
    _staggered(engine, _prompts(model[1]))
    assert calls == []
    # the control: under the profiler the same spy sees every phase
    with profile(activities=[ProfilerActivity.CPU]):
        handles = [engine.submit(p, 2) for p in _prompts(model[1])[:1]]
        _drain(engine, handles)
    assert {"engine.admit", "engine.admit.wait", "engine.decode.launch",
            "engine.decode.wait", "engine.decode.emit"} <= set(calls)


def _rows():
    snap = REGISTRY.snapshot()
    return (snap.get(moe.EXPERT_ROWS_EXECUTED, 0.0),
            snap.get(moe.EXPERT_ROWS_ROUTED, 0.0))


@pytest.mark.parametrize("dispatch_mode", ["sparse", "dense"])
@pytest.mark.parametrize("capacity_factor,capacity", [
    (1.25, 10),         # int(1.25 * 16 * 2 / 4): tokens may drop
    (2.0, 16),          # moe_tiny's no-drop E / k: C = T
])
def test_moe_row_counters(capacity_factor, capacity, dispatch_mode):
    cfg = moe.get_moe_config("moe_tiny", capacity_factor=capacity_factor,
                             dispatch_mode=dispatch_mode)
    layer = {k: v[0] for k, v in moe.moe_init(
        cfg, torch.Generator().manual_seed(0))["layers"].items()}
    b, s = 2, 8                          # T = 16 tokens, k = 2, E = 4
    x = torch.randn(b, s, cfg.dim, generator=torch.Generator().manual_seed(1))
    executed0, routed0 = _rows()
    with torch.no_grad():
        moe.moe_mlp(x, layer, cfg)
    executed1, routed1 = _rows()
    assert executed1 - executed0 == cfg.n_experts * capacity
    assert routed1 - routed0 == b * s * cfg.top_k
