"""The port's training path (tony_tpu_torch/ops/xent.py, the training side
of models/llama.py, and tony_tpu_torch/train) against the JAX package's,
on the CPU.

Inputs are made with numpy from a seed; weights move from JAX's
`llama_init` through `params_from_jax`. Tolerances: 2e-5 for f32 values
and the fused cross-entropy (tests/test_ops.py:33, same math, sums in
another order), 5e-4 for gradients through the whole model
(tests/test_ops.py:49), rtol 2e-5 / atol 1e-6 for parameters after a step
(tests/test_models.py:199-202), 2e-5 between the remat policies (the same
operations in the same order; only what is kept differs).
"""

import dataclasses
import os
import subprocess
import sys
import threading
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tony_tpu.models import llama as jllama
from tony_tpu.ops import xent as jxent
from tony_tpu.train import data as jdata
from tony_tpu.train import step as jstep
from tony_tpu_torch.models import llama
from tony_tpu_torch.models.convert import params_from_jax
from tony_tpu_torch.ops import attention, xent
from tony_tpu_torch.train import data, optim, step, trainer
from tony_tpu_torch.train.__main__ import main as train_main

F32_TOL = 2e-5
GRAD_TOL = 5e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _normal(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(b, s, seed, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _jax_tiny(**overrides):
    jcfg = jllama.get_config("tiny", **overrides)
    return jcfg, jllama.llama_init(jcfg, jax.random.PRNGKey(0))


def _port_params(jparams, cfg):
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    for leaf in optim.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# fused cross-entropy
# ---------------------------------------------------------------------------

def test_fused_cross_entropy_matches_jax():
    """Value, dx and dw, with a chunk that does not divide S (JAX pads and
    masks; the port's last chunk is short)."""
    x = _normal((2, 10, 32), 1)
    w = _normal((32, 256), 2) * 0.2
    t = _tokens(2, 10, 3)

    def jloss(x, w):
        return jxent.fused_cross_entropy(x, w, jnp.asarray(t), chunk=4)

    want, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = xent.fused_cross_entropy(xt, wt, torch.from_numpy(t), chunk=4)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_TOL)
    for g, j in ((xt.grad, jdx), (wt.grad, jdw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=F32_TOL,
                                   rtol=F32_TOL)
    # and the unfused loss of the same head, in the port
    full = llama.cross_entropy(xt.detach() @ wt.detach(),
                               torch.from_numpy(t))
    np.testing.assert_allclose(full.item(), got.item(), rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the Llama loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xent_chunk", [0, 16])
def test_llama_loss_and_gradients_match_jax(xent_chunk):
    jcfg, jparams = _jax_tiny(xent_chunk=xent_chunk)
    cfg = llama.get_config("tiny", xent_chunk=xent_chunk)
    toks = _tokens(2, 25, 4)
    want, jgrads = jax.value_and_grad(jllama.llama_loss)(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    params = _port_params(jparams, cfg)
    loss = llama.llama_loss(params, {"tokens": torch.from_numpy(toks)}, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=F32_TOL)
    jflat = _flat(jax.device_get(jgrads))
    for path, leaf in _flat(params).items():
        assert leaf.grad is not None, path
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jflat[path]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=path)


def _grads_under(cfg, params0, toks):
    params = {k: ({n: w.clone().requires_grad_() for n, w in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_())
              for k, v in params0.items()}
    loss = llama.llama_loss(params, {"tokens": toks}, cfg)
    loss.backward()
    return loss.item(), {p: t.grad for p, t in _flat(params).items()}


def test_remat_policies_agree_and_count_flash_forwards(monkeypatch):
    """remat=False, save_flash and full give the same gradients; the flash
    forward runs L times per step under save_flash (the replay takes the
    saved out and lse) and 2L times under full."""
    calls = []
    real = attention.blockwise_forward
    monkeypatch.setattr(attention, "blockwise_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = llama.get_config("tiny")
    params0 = llama.llama_init(base, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(2, 17, 5))
    results = {}
    for name, cfg, want_calls in (
            ("off", base, base.n_layers),
            ("save_flash", dataclasses.replace(base, remat=True),
             base.n_layers),
            ("full", dataclasses.replace(base, remat=True,
                                         remat_policy="full"),
             2 * base.n_layers)):
        calls.clear()
        results[name] = _grads_under(cfg, params0, toks)
        assert len(calls) == want_calls, (name, len(calls))
    loss_off, grads_off = results["off"]
    for name in ("save_flash", "full"):
        loss, grads = results[name]
        assert loss == loss_off
        for path, g in grads.items():
            np.testing.assert_allclose(g.numpy(), grads_off[path].numpy(),
                                       atol=2e-5, rtol=2e-5,
                                       err_msg=f"{name} {path}")


def test_stacked_weight_gradients_land_in_one_buffer():
    """Each layer's gradient is accumulated in place into its slice of the
    stacked weight's .grad (no per-layer full-size select_backward), and
    equals what autograd through w[i] views gives."""
    cfg = llama.get_config("tiny")
    params = llama.llama_init(cfg, torch.Generator().manual_seed(1))
    for leaf in optim.tree_leaves(params):
        leaf.requires_grad_(True)
    layers = llama.layer_params_for_grad(params)
    for name, w in params["layers"].items():
        assert layers[1][name].grad.data_ptr() == w.grad[1].data_ptr()
        assert layers[1][name].data_ptr() == w[1].data_ptr()
    for w in params["layers"].values():
        w.grad = None
    toks = torch.from_numpy(_tokens(1, 9, 6))
    llama.llama_loss(params, {"tokens": toks}, cfg).backward()
    routed = {n: w.grad.clone() for n, w in params["layers"].items()}
    # the plain way: autograd through w[i] into the stacked leaf
    plain = {k: ({n: w.detach().clone().requires_grad_()
                  for n, w in v.items()} if isinstance(v, dict)
                 else v.detach().clone().requires_grad_())
             for k, v in params.items()}
    x = llama.embed_lookup(plain["embed"], toks[:, :-1], cfg)
    cos, sin = llama.rope_tables(cfg, 8)
    for i in range(cfg.n_layers):
        x = llama._block(cfg, cos, sin, x, llama.layer_params(plain, i))
    x = llama.rms_norm(x, plain["final_norm"], cfg.norm_eps)
    llama._head_loss(x, plain, toks[:, 1:], cfg).backward()
    for name, g in routed.items():
        np.testing.assert_allclose(g.numpy(),
                                   plain["layers"][name].grad.numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_train_step_with_sgd_matches_jax():
    jcfg, jparams = _jax_tiny()
    cfg = llama.get_config("tiny")
    toks = _tokens(4, 33, 7)
    jfn = jstep.make_train_step(partial(jllama.llama_loss, config=jcfg),
                                optax.sgd(0.1), jit=False)
    jopt = optax.sgd(0.1)
    jnew, _, jloss = jfn(jparams, jopt.init(jparams),
                         {"tokens": jnp.asarray(toks)})
    params = _port_params(jparams, cfg)
    opt = optim.sgd(0.1)
    fn = step.make_train_step(partial(llama.llama_loss, config=cfg), opt)
    new, _, loss = fn(params, opt.init(params),
                      {"tokens": torch.from_numpy(toks)})
    assert isinstance(loss, torch.Tensor) and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    jflat = _flat(jax.device_get(jnew))
    for path, leaf in _flat(new).items():
        assert leaf.grad is None, path
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(jflat[path]), rtol=2e-5,
                                   atol=1e-6, err_msg=path)


def test_grad_accum_matches_full_batch_and_checks_divisibility():
    cfg = llama.get_config("tiny")
    init = llama.llama_init(cfg, torch.Generator().manual_seed(2))
    batch = {"tokens": torch.from_numpy(_tokens(4, 33, 8))}
    loss_fn = partial(llama.llama_loss, config=cfg)
    out = []
    for accum in (1, 2):
        params = {k: ({n: w.clone().requires_grad_() for n, w in v.items()}
                      if isinstance(v, dict) else v.clone().requires_grad_())
                  for k, v in init.items()}
        opt = optim.sgd(0.1)
        fn = step.make_train_step(loss_fn, opt, grad_accum=accum)
        out.append(fn(params, opt.init(params), batch))
    np.testing.assert_allclose(out[0][2].item(), out[1][2].item(), rtol=1e-6)
    for (path, a), b in zip(_flat(out[0][0]).items(),
                            _flat(out[1][0]).values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=path)
    with pytest.raises(ValueError, match="not divisible"):
        step.make_train_step(loss_fn, optim.sgd(0.1), grad_accum=3)(
            out[0][0], optim.sgd(0.1).init(out[0][0]), batch)


def test_strided_microbatch_split():
    rows = torch.arange(6)[:, None].expand(6, 2)
    parts = step.split_microbatches({"x": rows}, 3)
    assert [p["x"][:, 0].tolist() for p in parts] == [[0, 3], [1, 4], [2, 5]]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 3, 10)
    got = optim.warmup_cosine_decay_schedule(0.0, 3e-3, 3, 10)
    for count in range(14):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0


def test_adamw_matches_optax_over_four_updates():
    """The Trainer's optimizer: the same (numpy) gradients fed to optax's
    adamw and the port's for 4 updates give the same parameters. The first
    update has lr 0, so only decay-free zero motion. f32; 1e-6: the same
    elementwise math in another order."""
    sched = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                 decay_steps=6)
    init = {"w": _normal((3, 4), 20), "n": np.ones(4, np.float32)}
    grads = [{"w": _normal((3, 4), 30 + i), "n": _normal((4,), 40 + i)}
             for i in range(4)]
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(**sched),
                       weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jp)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in init.items()}
    opt = optim.adamw(optim.warmup_cosine_decay_schedule(**sched),
                      weight_decay=0.01)
    state = opt.init(params)
    for i, g in enumerate(grads):
        updates, jstate = jopt.update({k: jnp.asarray(v)
                                       for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        state.step()
        if i == 0:
            for k, p in params.items():
                np.testing.assert_array_equal(p.detach().numpy(), init[k])
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i} {k}")
    assert state.count == 4


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,process_index", [(0, 0), (0, 1), (5, 0),
                                                (5, 1)])
def test_synthetic_tokens_bit_identical_to_jax(seed, process_index):
    ours = data.synthetic_tokens(3, 40, 101, seed, process_index)
    ref = jdata.synthetic_tokens(3, 40, 101, seed, process_index)
    for _ in range(3):
        a, b = next(ours)["tokens"], next(ref)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _numbered(n):
    for i in range(n):
        yield {"x": np.full((2,), i, np.int64)}


def test_prefetch_order_leftover_and_cpu_transfer():
    with data.PrefetchIterator(_numbered(20), "cpu", depth=2) as it:
        first = [next(it) for _ in range(5)]
    assert [int(b["x"][0]) for b in first] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in first)
    left = [int(b["x"][0]) for b in it.leftover]
    assert left == list(range(5, 5 + len(left))) and 1 <= len(left) <= 3
    successor = data.PrefetchIterator(_numbered(0), "cpu",
                                      initial=it.leftover)
    assert [int(b["x"][0]) for b in successor] == left
    assert successor.batches == len(left)


def test_prefetch_bounded_and_reraises_producer_errors():
    pulled = []
    gate = threading.Event()

    def source():
        for i in range(100):
            pulled.append(i)
            yield {"x": np.zeros(1)}

    it = data.PrefetchIterator(source(), "cpu", depth=2)
    gate.wait(0.3)
    assert len(pulled) <= 4          # queue (2) + in-flight (1) + one pull
    it.close()

    def failing():
        yield {"x": np.zeros(1)}
        raise RuntimeError("source broke")

    it = data.PrefetchIterator(failing(), "cpu", depth=1)
    next(it)
    with pytest.raises(RuntimeError, match="source broke"):
        next(it)
    assert it.closed


# ---------------------------------------------------------------------------
# the Trainer and the entry point
# ---------------------------------------------------------------------------

def test_trainer_loss_falls_on_tiny_cpu():
    cfg = llama.get_config("tiny")
    t = trainer.Trainer(
        loss_fn=partial(llama.llama_loss, config=cfg),
        init_fn=partial(llama.llama_init, cfg),
        data_iter=data.synthetic_tokens(8, 32, cfg.vocab_size),
        config=trainer.TrainerConfig(num_steps=30, log_every=1,
                                     learning_rate=1e-2, warmup_steps=1,
                                     flops_per_token=cfg.flops_per_token(32)),
        device="cpu")
    final = t.run()
    losses = [m["loss"] for m in t.metrics_history]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert final == losses[-1]
    assert losses[-1] < losses[0] * 0.8, losses[::10]
    assert all(m["tokens_per_s"] > 0 for m in t.metrics_history[1:])
    # no card: no MFU, a CPU run is not a device metric
    assert not any("mfu_pct" in m for m in t.metrics_history)
    assert t.opt_state.count == 30


@pytest.mark.parametrize("field,value", [
    ("checkpoint_dir", "/nonexistent"), ("checkpoint_every", 5),
    ("eval_every", 5), ("master_weights", True),
    ("optimizer", optim.sgd(0.1))])
def test_trainer_refuses_unported_options(field, value):
    cfg = trainer.TrainerConfig(**{field: value})
    t = trainer.Trainer(lambda p, b: None, lambda g: {}, iter(()), cfg,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        t.setup()


@pytest.mark.parametrize("flag", [["--data", "x.bin"],
                                  ["--checkpoint-dir", "/tmp/c"],
                                  ["--checkpoint-every", "2"],
                                  ["--eval-every", "2"],
                                  ["--master-weights"], ["--pp-micro", "2"],
                                  ["--pp-virtual", "2"]])
def test_entry_point_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="slice"):
        train_main(["--device", "cpu", "--steps", "1", *flag])


def test_entry_point_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would be used")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--config", "tiny", "--steps", "1"])


def test_entry_point_prints_final_loss():
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.train", "--device", "cpu",
         "--config", "tiny", "--steps", "3", "--batch-size", "2",
         "--seq-len", "16"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("final loss ") and np.isfinite(float(last[11:]))
