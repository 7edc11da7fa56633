"""The port's training path (tony_tpu_torch/ops/xent.py, the training side
of models/llama.py, and tony_tpu_torch/train) against the JAX package's,
on the CPU.

Inputs are made with numpy from a seed; weights move from JAX's
`llama_init` through `params_from_jax`. Tolerances: 2e-5 for f32 values
and the fused cross-entropy (tests/test_ops.py:33, same math, sums in
another order), 5e-4 for gradients through the whole model
(tests/test_ops.py:49), rtol 2e-5 / atol 1e-6 for parameters after a step
(tests/test_models.py:199-202), 2e-5 between the remat policies (the same
operations in the same order; only what is kept differs). The Trainer's
state lifecycle (resume, eval, a caller-given optimizer, SIGTERM on the
entry point, the AM's retry) is held bit for bit where both runs are the
port's on the CPU; f32 master weights against JAX's as their test says.
"""

import dataclasses
import json
import os
import re
import signal
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
from tony_tpu.train import precision as jprecision
from tony_tpu.train import step as jstep
from tony_tpu_torch.models import llama
from tony_tpu_torch.models.convert import params_from_jax
from tony_tpu_torch.ops import attention, xent
from tony_tpu_torch.train import (
    checkpoint, data, optim, precision, step, trainer,
)
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


def _quadratic_loss_jax(params, batch):
    pred = batch["x"] @ params["w"].astype(jnp.float32) * params["n"]
    return jnp.mean(jnp.square(pred - batch["y"]))


def _quadratic_loss_port(params, batch):
    pred = batch["x"] @ params["w"].float() * params["n"]
    return torch.mean(torch.square(pred - batch["y"]))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_f32_master_adamw_matches_jax(grad_accum):
    """with_f32_master(adamw) on a bf16 and an f32 leaf, 4 updates of the
    same f32 loss on the same batches in both packages (grad_accum 2: the
    f32 mean reaches the master unrounded, as JAX's `emit_accum_dtype`
    gives it). After
    every update the port's bf16 parameter is exactly its cast master; the
    masters and the f32 moments agree with JAX's within 1e-6 (f32 math in
    another order; the Adam step is lr-sized), the bf16 parameters within
    one bf16 ulp (the cast of masters that close); the state has JAX's
    {"inner", "master"} layout."""
    sched = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                 decay_steps=6)
    init = {"w": _normal((3, 4), 50), "n": np.ones(4, np.float32)}
    batches = [{"x": _normal((4, 3), 60 + i), "y": _normal((4, 4), 70 + i)}
               for i in range(4)]
    jopt = jprecision.with_f32_master(optax.adamw(
        optax.warmup_cosine_decay_schedule(**sched), weight_decay=0.01))
    jparams = {"w": jnp.asarray(init["w"]).astype(jnp.bfloat16),
               "n": jnp.asarray(init["n"])}
    jstate = jopt.init(jparams)
    jfn = jstep.make_train_step(_quadratic_loss_jax, jopt, jit=False,
                                grad_accum=grad_accum,
                                emit_accum_dtype=True)
    params = {"w": torch.from_numpy(init["w"]).to(torch.bfloat16)
              .requires_grad_(),
              "n": torch.from_numpy(init["n"].copy()).requires_grad_()}
    opt = precision.with_f32_master(optim.adamw(
        optim.warmup_cosine_decay_schedule(**sched), weight_decay=0.01))
    state = opt.init(params)
    fn = step.make_train_step(_quadratic_loss_port, opt,
                              grad_accum=grad_accum)
    for i, batch in enumerate(batches):
        jparams, jstate, jloss = jfn(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, loss = fn(
            params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
        w = params["w"].detach()
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, state.master["w"].detach().to(torch.bfloat16))
        jflat = jax.tree_util.tree_flatten_with_path(
            jax.device_get(jstate))[0]
        pflat = checkpoint.flatten_with_paths(state.tree())
        assert len(pflat) == len(jflat)
        for (path, got), (_, want) in zip(pflat, jflat):
            np.testing.assert_allclose(
                got.detach().float().numpy(), np.asarray(want, np.float32),
                rtol=1e-6, atol=1e-6, err_msg=f"update {i} {path}")
        np.testing.assert_allclose(
            w.float().numpy(), np.asarray(jparams["w"], np.float32),
            rtol=2.0 ** -8, atol=0, err_msg=f"update {i}")
    paths = [p for p, _ in checkpoint.flatten_with_paths(state.tree())]
    assert paths[0] == ("inner", "0", "count")
    assert paths[-1] == ("master", "w")
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


@pytest.mark.parametrize("flag", [["--config", "moe_tiny"],
                                  ["--pp-micro", "2"],
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


# ---------------------------------------------------------------------------
# the Trainer's state lifecycle
# ---------------------------------------------------------------------------

def _tiny_trainer(num_steps, data_iter, **config):
    cfg = llama.get_config("tiny")
    return trainer.Trainer(
        partial(llama.llama_loss, config=cfg), partial(llama.llama_init, cfg),
        data_iter,
        trainer.TrainerConfig(num_steps=num_steps, log_every=1,
                              learning_rate=1e-2, warmup_steps=5,
                              prefetch_depth=0, **config),
        device="cpu")


def _stream(skip=0):
    it = data.synthetic_tokens(2, 16, 256)
    for _ in range(skip):
        next(it)
    return it


@pytest.mark.parametrize("master_weights", [False, True])
def test_resume_continues_bit_for_bit(tmp_path, master_weights):
    """2 steps, the final checkpoint, a new Trainer resuming to step 4 on
    the next batches: the same losses and parameters, bit for bit, as 4
    steps in one run (the moments, the update count and the schedule's
    position all come back)."""
    whole = _tiny_trainer(4, _stream(), master_weights=master_weights)
    whole.run()
    d = str(tmp_path / "ck")
    _tiny_trainer(2, _stream(), master_weights=master_weights,
                  checkpoint_dir=d).run()
    resumed = _tiny_trainer(4, _stream(skip=2),
                            master_weights=master_weights, checkpoint_dir=d)
    resumed.run()
    want = [m["loss"] for m in whole.metrics_history[2:]]
    assert [m["loss"] for m in resumed.metrics_history] == want
    for (path, a), b in zip(_flat(resumed.params).items(),
                            _flat(whole.params).values()):
        assert torch.equal(a, b), path
    assert resumed.opt_state.count == whole.opt_state.count == 4
    assert checkpoint.committed_steps(d) == [2, 4]


def test_eval_loss_on_a_fixed_set_across_resetup():
    """The held-out set is drawn once (eval_batches from the eval
    iterator, no more) and kept across a re-setup(); the eval loss is the
    mean of the loss on it, logged every eval_every steps."""
    eval_iter = data.synthetic_tokens(2, 16, 256, seed=1)
    t = _tiny_trainer(2, _stream(), eval_every=1, eval_batches=2)
    t.eval_data_iter = eval_iter
    t.run()
    evals = [m for m in t.metrics_history if "eval_loss" in m]
    assert [m["step"] for m in evals] == [1, 2]
    cfg = llama.get_config("tiny")
    fresh = data.synthetic_tokens(2, 16, 256, seed=1)
    held = [torch.from_numpy(next(fresh)["tokens"]) for _ in range(2)]
    with torch.no_grad():
        want = np.mean([llama.llama_loss(t.params, {"tokens": b}, cfg).item()
                        for b in held])
    np.testing.assert_allclose(t.last_eval_loss, want, rtol=2e-5)
    kept = t._eval_set
    t.setup()
    assert t._eval_set is kept
    # the iterator gave exactly eval_batches batches
    np.testing.assert_array_equal(next(eval_iter)["tokens"],
                                  next(fresh)["tokens"])


def test_trainer_takes_a_caller_given_optimizer(tmp_path):
    """TrainerConfig.optimizer (here sgd, as optax.sgd) replaces the
    default AdamW; its checkpoint holds no optimizer leaves, as optax's
    sgd state has none, and resumes."""
    d = str(tmp_path / "ck")
    t = _tiny_trainer(2, _stream(), optimizer=optim.sgd(0.1),
                      checkpoint_dir=d)
    t.run()
    assert t.opt_state.kind == "sgd"
    assert len(jax.tree.leaves(optax.sgd(0.1).init({"w": jnp.zeros(2)}))) == 0
    with open(os.path.join(d, "step_2", "index.json")) as f:
        assert len(json.load(f)["leaves"]) == len(_flat(t.params)) + 1
    resumed = _tiny_trainer(3, _stream(skip=2), optimizer=optim.sgd(0.1),
                            checkpoint_dir=d)
    resumed.setup()
    assert resumed.step == 2
    for (path, a), b in zip(_flat(resumed.params).items(),
                            _flat(t.params).values()):
        assert torch.equal(a, b), path


def test_checkpoint_dir_refuses_an_optimizer_without_an_optax_layout(
        tmp_path):
    """A custom Optimizer has no optax layout to save: with a
    checkpoint_dir, setup() refuses it before any step; without one, it
    trains."""
    custom = optim.Optimizer(
        lambda leaves: (torch.optim.SGD(leaves, lr=0.1), None))
    t = _tiny_trainer(2, _stream(), optimizer=custom,
                      checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError, match="optax layout"):
        t.setup()
    assert not os.path.exists(str(tmp_path / "ck"))
    assert np.isfinite(_tiny_trainer(1, _stream(), optimizer=custom).run())


def _run_until_step_line(cmd, env):
    """Start `cmd`, read its log until the first step line; returns the
    process."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)
    timer = threading.Timer(120, proc.kill)
    timer.start()
    try:
        for line in proc.stderr:
            if re.search(r"step \d+ loss", line):
                return proc
    finally:
        timer.cancel()
    raise AssertionError(f"no step line; exit {proc.wait()}")


def test_entry_point_sigterm_exits_12_then_resumes(tmp_path):
    """python -m tony_tpu_torch.train under SIGTERM after its first step
    line: exit 12 with the step it stopped at committed; a rerun with 2
    more steps resumes there, exits 0 and prints the final loss."""
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "tony_tpu_torch.train", "--device", "cpu",
           "--config", "tiny", "--batch-size", "2", "--seq-len", "16",
           "--log-every", "1", "--checkpoint-dir", d]
    proc = _run_until_step_line(cmd + ["--steps", "100000"], env)
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 12, err[-2000:]
    stopped = int(re.search(r"preempted at step (\d+)", err).group(1))
    assert checkpoint.latest_step(d) == stopped >= 1
    out = subprocess.run(cmd + ["--steps", str(stopped + 2)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"resuming from checkpoint step {stopped}" in out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("final loss ")
    assert checkpoint.latest_step(d) == stopped + 2


RETRY_SCRIPT = """
import json, os, sys
from functools import partial
sys.path.insert(0, os.environ["TONY_REPO_ROOT"])
from tony_tpu_torch.models.llama import get_config, llama_init, llama_loss
from tony_tpu_torch.train.data import synthetic_tokens
from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

ckpt_dir = os.environ["CKPT_DIR"]
attempt = int(os.environ.get("ATTEMPT_NUMBER", "0"))
cfg = get_config("tiny")
trainer = Trainer(
    partial(llama_loss, config=cfg), partial(llama_init, cfg),
    synthetic_tokens(2, 16, cfg.vocab_size),
    TrainerConfig(num_steps=3 if attempt == 0 else 6, log_every=1,
                  checkpoint_every=1, checkpoint_dir=ckpt_dir,
                  learning_rate=1e-2, warmup_steps=1),
    device="cpu")
trainer.setup()
resumed_from = trainer.step
trainer.run()
if attempt == 0:
    print(f"attempt 0 dying at step {trainer.step}", flush=True)
    os._exit(1)
with open(os.path.join(ckpt_dir, "resume_report.json"), "w") as f:
    json.dump({"attempt": attempt, "resumed_from": resumed_from,
               "finished_at": trainer.step}, f)
sys.exit(0)
"""


def test_am_retry_resumes_the_port_trainer(tmp_path):
    """TonY's own retry loop around the port's Trainer: attempt 0 dies
    after its step-3 checkpoint, the AM's retry resumes from 3 and
    finishes at 6."""
    from test_e2e import _dump_logs, run_job

    script = tmp_path / "train_port_crash_resume.py"
    script.write_text(RETRY_SCRIPT)
    ckpt_dir = str(tmp_path / "ckpts")
    client = run_job(
        tmp_path,
        ["--executes", str(script),
         "--conf", "tony.worker.instances=1",
         "--conf", "tony.am.retry-count=2",
         "--conf", f"tony.execution.env=CKPT_DIR={ckpt_dir}",
         "--conf", f"tony.execution.env=TONY_REPO_ROOT={REPO}"])
    assert client.final_status == "SUCCEEDED", _dump_logs(client)
    with open(os.path.join(ckpt_dir, "resume_report.json")) as f:
        report = json.load(f)
    assert report == {"attempt": 1, "resumed_from": 3, "finished_at": 6}
