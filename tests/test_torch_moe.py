"""The port's mixture-of-experts Llama (tony_tpu_torch/models/moe.py and its
uses in generate, quant, kvcache, the engine, both entry points and the
checkpoint) against the JAX package's, on the CPU at `moe_tiny` size.

JAX's `moe_init` makes the weights, `params_from_jax` carries them over,
and both packages see the same numpy inputs. Routing is discrete: a near
tie summed in another order flips a choice and the output then differs by
a whole expert. So the tests capture each package's top-k choices (the
JAX package's as its dispatch receives them, op by op under
`jax.disable_jit`) and require them equal, and they print and assert the
smallest top-k margin of the router logits against the router product's
f32 error bound. Tolerances: f32 2e-5 for the MLP and forward
(tests/test_ops.py:33), 1e-5 between the port's sparse and dense dispatch
(tests/test_moe.py:71), bf16 3e-2, gradients and Trainer losses 5e-4
(tests/test_ops.py:49), decode logits 3e-5 (tests/test_generate.py:62,
tests/test_torch_quant.py:38), the JAX side of int8 jitted (ROADMAP
conventions); checkpoint files byte for byte and resumes bit for bit.
"""

import dataclasses
import importlib
import json
import os
import warnings
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tony_tpu.models import moe as jmoe
from tony_tpu.models import quant as jquant
from tony_tpu.train import checkpoint as jckpt
from tony_tpu.train import data as jdata
from tony_tpu.train.trainer import Trainer as JaxTrainer
from tony_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tony_tpu_torch.models import convert, llama, moe, quant
from tony_tpu_torch.models.convert import params_from_jax
from tony_tpu_torch.models.llama import layer_params
from tony_tpu_torch.ops.int8_matmul import int8_matmul
from tony_tpu_torch.serve.__main__ import build_arg_parser, build_server
from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
from tony_tpu_torch.train import checkpoint as ckpt
from tony_tpu_torch.train import data, optim, trainer
from tony_tpu_torch.train.__main__ import build_arg_parser as train_parser
from tony_tpu_torch.train.__main__ import build_trainer

# the package exports the function `generate` (as the JAX package does);
# the module comes by its full name
generate = importlib.import_module("tony_tpu_torch.models.generate")

jgen = importlib.import_module("tony_tpu.models.generate")

F32_TOL = 2e-5
SPARSE_DENSE_TOL = 1e-5
BF16_TOL = 3e-2
GRAD_TOL = 5e-4
DECODE_TOL = 3e-5
# moe_tiny at no-drop capacity: n_experts / top_k
NO_DROP = 2.0


def _tokens(b, s, seed, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _jax_moe(dtype="float32", **overrides):
    jcfg = jmoe.get_moe_config("moe_tiny", dtype=getattr(jnp, dtype),
                               **overrides)
    cfg = moe.get_moe_config("moe_tiny", dtype=getattr(torch, dtype),
                             **overrides)
    jparams = jmoe.moe_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg,
                                               "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _jax_moe()


@pytest.fixture(scope="module")
def no_drop():
    return _jax_moe(capacity_factor=NO_DROP)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jax.device_get(x), np.float32)


# ---------------------------------------------------------------------------
# routing records and margins
# ---------------------------------------------------------------------------

def _record_jax_routing(monkeypatch):
    """[(topk_idx, keep)] of every JAX dispatch call from now on."""
    calls = []
    for name in ("_sparse_dispatch", "_dense_dispatch"):
        orig = getattr(jmoe, name)

        def spy(xt, layer, gates, keep, position, capacity, *rest,
                _orig=orig, _sparse=name == "_sparse_dispatch"):
            # the sparse dispatch takes topk_idx; the dense one, the
            # chosen mask only (keep is compared for both)
            calls.append((rest[0] if _sparse else None, keep))
            return _orig(xt, layer, gates, keep, position, capacity, *rest)
        monkeypatch.setattr(jmoe, name, spy)
    return calls


def _record_port_routing(monkeypatch):
    """[(Routing, router logits margin, f32 error bound)] of every port
    routing from now on."""
    calls = []
    orig = moe.route

    def spy(xt, router, config):
        r = orig(xt, router, config)
        calls.append((r, *_margin_and_bound(xt, router, config.top_k)))
        return r
    monkeypatch.setattr(moe, "route", spy)
    return calls


def _margin_and_bound(xt, router, k):
    """The smallest gap between consecutive sorted router logits among
    each token's k + 1 largest (what decides its top-k, in order), and
    the f32 product's error bound gamma_d * sum_i |x_i| |w_ie| (largest
    over the tokens and experts), both in f64."""
    x = xt.detach().double()
    w = router.detach().double()
    logits = x @ w
    top = torch.sort(logits, dim=-1, descending=True).values[:, :k + 1]
    margin = float((top[:, :-1] - top[:, 1:]).min())
    d = x.shape[-1]
    u = 2.0 ** -24
    bound = float((d * u / (1 - d * u)) * (x.abs() @ w.abs()).max())
    return margin, bound


def _assert_routing_equal(jcalls, pcalls):
    assert len(jcalls) == len(pcalls) > 0
    for (jtopk, jkeep), (r, margin, bound) in zip(jcalls, pcalls):
        print(f"smallest top-k margin {margin:.3e}, router product f32 "
              f"error bound {bound:.3e}")
        # both packages' logits are within `bound` of the exact ones: a
        # margin above twice that cannot flip
        assert margin > 2 * bound, (margin, bound)
        if jtopk is not None:
            for want, got in zip(jtopk, r.topk_idx):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(r.keep.numpy(), np.asarray(jkeep))


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(moe.PRESETS))
def test_presets_match_jax(name):
    port, ref = moe.PRESETS[name], jmoe.PRESETS[name]
    for f in dataclasses.fields(port):
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "dtype":
            assert str(got).split(".")[-1] == jnp.dtype(want).name
        else:
            assert got == want, f.name
    assert port.num_params() == ref.num_params()
    assert port.active_params() == ref.active_params()
    for seq in (None, 1024, 4096):
        assert port.flops_per_token(seq) == ref.flops_per_token(seq)
    assert moe.is_moe_preset(name) and not moe.is_moe_preset("tiny")
    assert moe.no_drop_capacity_floor(port) == \
        jmoe.no_drop_capacity_floor(ref)
    with pytest.raises(ValueError, match="dispatch_mode"):
        moe.get_moe_config(name, dispatch_mode="ring")


def test_moe_init_and_conversion_keep_the_jax_layout(tiny):
    jcfg, jparams, cfg, params = tiny
    host = jax.device_get(jparams)
    own = moe.moe_init(cfg, torch.Generator().manual_seed(0))
    empty = convert.empty_params(cfg, "cpu")
    flat = jax.tree_util.tree_leaves_with_path(host)
    assert len(flat) == 3 + len(params["layers"])
    for path, leaf in flat:
        keys = [p.key for p in path]
        for tree in (params, own, empty):
            t = tree[keys[0]] if len(keys) == 1 else tree[keys[0]][keys[1]]
            assert tuple(t.shape) == leaf.shape, keys
            assert str(t.dtype).split(".")[-1] == leaf.dtype.name, keys
        t = params[keys[0]] if len(keys) == 1 else params[keys[0]][keys[1]]
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert "w_gate" not in own["layers"] and "router" in own["layers"]
    # an empty tree for a restore lists its leaves in the init's order
    # (`tree_leaves` pairs two trees by it), dense and MoE
    assert list(empty["layers"]) == list(own["layers"])
    dense = llama.get_config("tiny")
    assert list(convert.empty_params(dense, "cpu")["layers"]) == \
        list(llama.llama_init(dense, torch.Generator())["layers"])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(host, moe.get_moe_config("moe_tiny", n_experts=8),
                        "cpu")


# ---------------------------------------------------------------------------
# the MoE MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sparse", "dense"])
@pytest.mark.parametrize("capacity_factor", [10.0, 1.0, 0.1],
                         ids=["no-drops", "cf1", "heavy-drops"])
def test_moe_mlp_matches_jax(monkeypatch, tiny, mode, capacity_factor):
    _, jparams, _, params = tiny
    jcfg = jmoe.get_moe_config("moe_tiny", capacity_factor=capacity_factor,
                               dispatch_mode=mode)
    cfg = moe.get_moe_config("moe_tiny", capacity_factor=capacity_factor,
                             dispatch_mode=mode)
    x = np.random.RandomState(1).standard_normal((2, 32, 64)).astype(
        np.float32)
    jcalls = _record_jax_routing(monkeypatch)
    pcalls = _record_port_routing(monkeypatch)
    jlayer = jax.tree.map(lambda p: p[0], jparams["layers"])
    want, want_aux = jmoe.moe_mlp(jnp.asarray(x), jlayer, jcfg)
    got, got_aux = moe.moe_mlp(torch.from_numpy(x), layer_params(params, 0),
                               cfg)
    _assert_routing_equal(jcalls, pcalls)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=F32_TOL)
    r = pcalls[0][0]
    dropped = int((r.gates > 0).sum() - r.keep.sum())
    rows_zero = int((got.reshape(-1, 64).norm(dim=-1) == 0).sum())
    if capacity_factor == 10.0:
        assert dropped == 0 and r.capacity >= 64
    if capacity_factor == 0.1:
        # capacity 3 of 64 tokens' 128 choices: dropped tokens are zero rows
        assert r.capacity == 3 and dropped > 100 and rows_zero > 0


@pytest.mark.parametrize("capacity_factor", [10.0, 0.5])
def test_sparse_and_dense_dispatch_agree(tiny, capacity_factor):
    """The port's two dispatches: same routing semantics, same outputs,
    drops included (tests/test_moe.py:58-73)."""
    _, _, _, params = tiny
    layer = layer_params(params, 0)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (2, 32, 64)).astype(np.float32))
    out = {}
    for mode in ("sparse", "dense"):
        cfg = moe.get_moe_config("moe_tiny", capacity_factor=capacity_factor,
                                 dispatch_mode=mode)
        out[mode] = moe.moe_mlp(x, layer, cfg)
    torch.testing.assert_close(out["sparse"][0], out["dense"][0],
                               rtol=SPARSE_DENSE_TOL, atol=SPARSE_DENSE_TOL)
    assert float(out["sparse"][1]) == float(out["dense"][1])


def test_router_product_is_ieee_f32_whatever_the_tf32_flag():
    """The router's f32 product runs with TF32 off, and the process's own
    setting comes back after it."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    seen = []
    try:
        matmul.allow_tf32 = True
        with moe._ieee_f32():
            seen.append(matmul.allow_tf32)
        seen.append(matmul.allow_tf32)
        x = torch.randn(5, 8, requires_grad=True)
        w = torch.randn(8, 3, requires_grad=True)
        logits = moe.router_logits(x, w)
        logits.sum().backward()
        assert logits.dtype == torch.float32
        torch.testing.assert_close(x.grad, torch.ones(5, 3) @ w.t())
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = before
    assert seen == [False, True]


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_moe_forward_and_loss_match_jax(monkeypatch, dtype, tol):
    jcfg, jparams, cfg, params = _jax_moe(dtype)
    toks = _tokens(2, 16, 2)
    want, want_aux = jmoe.moe_forward(jparams, jnp.asarray(toks), jcfg)
    jcalls = _record_jax_routing(monkeypatch)
    with jax.disable_jit():                 # the routing, concretely
        jmoe.moe_forward(jparams, jnp.asarray(toks), jcfg)
    pcalls = _record_port_routing(monkeypatch)
    got, got_aux = moe.moe_forward(params, torch.from_numpy(toks).long(), cfg)
    _assert_routing_equal(jcalls, pcalls)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=tol)
    batch = _tokens(2, 17, 3)
    jl = jmoe.moe_loss(jparams, {"tokens": jnp.asarray(batch)}, jcfg)
    with torch.no_grad():
        pl = moe.moe_loss(params, {"tokens": torch.from_numpy(batch).long()},
                          cfg)
    np.testing.assert_allclose(float(pl), float(jl), rtol=tol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("remat,xent_chunk,capacity_factor", [
    (False, 0, 1.25), (True, 8, 1.25), (False, 0, 0.5)],
    ids=["plain", "save_flash-chunked", "heavy-drops"])
def test_moe_loss_gradients_match_jax(remat, xent_chunk, capacity_factor):
    """Through the gather-form backward of the sparse dispatch (a token's
    k slots, a slot's one choice; the dropped choices' sentinel)."""
    jcfg, jparams, cfg, params = _jax_moe(remat=remat,
                                          xent_chunk=xent_chunk,
                                          capacity_factor=capacity_factor)
    for leaf in optim.tree_leaves(params):
        leaf.requires_grad_(True)
    batch = _tokens(2, 17, 4)
    jloss, jgrads = jax.value_and_grad(jmoe.moe_loss)(
        jparams, {"tokens": jnp.asarray(batch)}, jcfg)
    loss = moe.moe_loss(params, {"tokens": torch.from_numpy(batch).long()},
                        cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=F32_TOL)
    want = _flat(jax.device_get(jgrads))
    got = _flat(params)
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path].grad.numpy(), g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=path)
    assert float(np.abs(want["layers/router"]).max()) > 0


# ---------------------------------------------------------------------------
# generation: greedy, int8 weights and cache, the capacity warning
# ---------------------------------------------------------------------------

def test_greedy_decode_equals_a_forward_rerun_and_jax(no_drop):
    """At no-drop capacity incremental decode is the training forward
    (tests/test_moe_generate.py:32), and the port's greedy stream is the
    JAX package's."""
    jcfg, jparams, cfg, params = no_drop
    prompt = _tokens(2, 8, 1)
    n = 6
    got = generate.generate(params, cfg, torch.from_numpy(prompt).long(), n)
    seq = torch.from_numpy(prompt).long()
    want = []
    for _ in range(n):
        logits, _ = moe.moe_forward(params, seq, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        want.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), torch.stack(want, 1).numpy())
    jax_stream = np.asarray(jgen.generate(jparams, jcfg, jnp.asarray(prompt),
                                          n))
    np.testing.assert_array_equal(got.numpy(), jax_stream)


def test_quantize_params_moe_tree(no_drop):
    """we_* quantize per (layer, expert, channel), bit for bit as JAX's;
    the router and the norms stay as they were."""
    _, jparams, cfg, params = no_drop
    jq = jquant.quantize_params(jparams)
    pq = quant.quantize_params(params)
    carried = params_from_jax(jax.device_get(jq), cfg, "cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jq)):
        node, twin = pq, carried
        for p in path:
            node, twin = node[p.key], twin[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        np.testing.assert_array_equal(twin.numpy(), np.asarray(leaf))
    for name in ("we_gate", "we_up", "we_down", "wq", "wo"):
        assert quant.is_qtensor(pq["layers"][name]), name
    assert tuple(pq["layers"]["we_down"]["scale"].shape) == (2, 4, 1, 64)
    assert not quant.is_qtensor(pq["layers"]["router"])
    assert pq["layers"]["router"] is params["layers"]["router"]
    assert quant.quantized_bytes(pq) == jquant.quantized_bytes(jq)


_jprefill = jax.jit(jgen.prefill, static_argnums=(2, 3, 4))
_jdecode = jax.jit(jgen.decode_step, static_argnums=1)


@pytest.mark.parametrize("weights,cache", [
    ("int8", "fp"), ("fp", "int8"), ("int8", "int8")],
    ids=["int8-weights", "int8-cache", "both"])
def test_int8_prefill_and_decode_logits_match_jax(no_drop, weights, cache):
    """Against the jitted JAX prefill and decode step (XLA keeps the bf16
    product of dequantize unrounded in a compiled step; the port's int8
    product multiplies by the same element), at DECODE_TOL."""
    jcfg, jparams, cfg, params = no_drop
    quant_cache = cache == "int8"
    if weights == "int8":
        jparams = jquant.quantize_params(jparams)
        params = quant.quantize_params(params)
    tokens = _tokens(2, 12, 5)
    jl, jc = _jprefill(jparams, jnp.asarray(tokens), jcfg, 16, quant_cache)
    pl, pc = generate.prefill(params, torch.from_numpy(tokens).long(), cfg,
                              16, quant_cache=quant_cache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = np.array([12, 9], np.int32)
    jd, _ = _jdecode(jparams, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
    pd, _ = generate.decode_step(params, cfg, pc,
                                 torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos).long())
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_int8_bank_product_is_one_int8_bmm_per_bank(monkeypatch, no_drop):
    """An int8 expert bank is one `int8_bmm` (on the card one K5 launch),
    not a product per expert: 3 banks a layer in a prefill and in a
    decode step, each over all E experts' queues at once, and the
    logits those of the banks' per-expert plain products."""
    _, _, cfg, params = no_drop
    qparams = quant.quantize_params(params)
    calls = []
    real = moe.int8_bmm

    def counting(x, w):
        calls.append((tuple(x.shape), tuple(w["int8"].shape)))
        return real(x, w)

    monkeypatch.setattr(moe, "int8_bmm", counting)
    tokens = torch.from_numpy(_tokens(2, 12, 5)).long()
    logits, cache = generate.prefill(qparams, tokens, cfg, 16)
    assert len(calls) == 3 * cfg.n_layers
    assert all(x[0] == w[0] == cfg.n_experts for x, w in calls)
    calls.clear()
    generate.decode_step(qparams, cfg, cache, torch.argmax(logits, -1),
                         torch.tensor([12, 12]))
    assert len(calls) == 3 * cfg.n_layers

    def per_expert(x, w):
        return torch.stack([int8_matmul(x[e], {"int8": w["int8"][e],
                                               "scale": w["scale"][e]})
                            for e in range(x.shape[0])])

    monkeypatch.setattr(moe, "int8_bmm", per_expert)
    looped, _ = generate.prefill(qparams, tokens, cfg, 16)
    np.testing.assert_array_equal(looped.numpy(), logits.numpy())


def test_below_capacity_warns_from_generate_and_the_engine(tiny, no_drop):
    _, _, cfg, params = tiny                  # moe_tiny's cf 1.25 < 2
    prompt = torch.from_numpy(_tokens(1, 4, 7)).long()
    with pytest.warns(UserWarning, match="decode path below no-drop"):
        generate.generate(params, cfg, prompt, 2)
    with pytest.warns(UserWarning, match="serve path below no-drop"):
        ContinuousBatchingEngine(params, cfg, n_slots=1, token_budget=16)
    _, _, cfg_ok, params_ok = no_drop
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        generate.generate(params_ok, cfg_ok, prompt, 2)
        ContinuousBatchingEngine(params_ok, cfg_ok, n_slots=1,
                                 token_budget=16)


# ---------------------------------------------------------------------------
# the serve entry point
# ---------------------------------------------------------------------------

def _post(url, body):
    import urllib.request
    rq = urllib.request.Request(url + "/v1/generate",
                                data=json.dumps(body).encode())
    with urllib.request.urlopen(rq, timeout=120) as resp:
        return [json.loads(line) for line in resp.read().splitlines()
                if line.strip()]


SERVE = ["--device", "cpu", "--config", "moe_tiny", "--slots", "2",
         "--token-budget", "32", "--port", "0", "--host", "127.0.0.1"]


@pytest.mark.parametrize("flags", [
    [], ["--quant", "int8", "--quant-cache"],
    ["--prefix-sharing", "on", "--kv-page-size", "4", "--kv-pages", "64"]],
    ids=["bf16-path", "int8-quant-cache", "prefix-sharing"])
def test_serve_entry_point_streams_equal_generate(flags):
    """`--config moe_tiny` serves at no-drop capacity; two concurrent
    requests' greedy streams are offline `generate`'s (the second prompt
    shares the first's prefix: with sharing on it takes the suffix
    prefill, which routes its own suffix tokens)."""
    import threading

    server = build_server(build_arg_parser().parse_args(SERVE + flags))
    try:
        engine = server.engine
        cfg = engine.config
        assert isinstance(cfg, moe.MoEConfig)
        assert cfg.capacity_factor == NO_DROP
        assert moe.PRESETS["moe_tiny"].capacity_factor < NO_DROP
        assert quant.is_qtensor(engine.params["layers"]["we_up"]) == \
            ("--quant" in flags)
        prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5],
                   [3, 1, 4, 1, 5, 9, 2, 6, 7, 7, 1]]
        outs = {}

        def send(i):
            outs[i] = _post(server.url, {"prompt": prompts[i],
                                         "max_new_tokens": 5})[0]
        threads = [threading.Thread(target=send, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, p in enumerate(prompts):
            want = generate.generate(engine.params, cfg, torch.tensor([p]),
                                     5, quant_cache=engine.quant_cache)
            assert outs[i]["tokens"] == want[0].tolist(), i
    finally:
        server.stop(drain_timeout=5)


def test_serve_a_jax_trainer_moe_checkpoint(tmp_path):
    """--checkpoint-dir on an MoE checkpoint the JAX package saved (params
    with AdamW state beside them): the served greedy tokens are the JAX
    package's `generate` on those parameters at no-drop capacity."""
    jcfg = jmoe.get_moe_config("moe_tiny", capacity_factor=NO_DROP)
    jparams = jmoe.moe_init(jcfg, jax.random.PRNGKey(3))
    jckpt.save_checkpoint(str(tmp_path), 7, {
        "params": jparams, "opt_state": optax.adamw(1e-3).init(jparams),
        "step": 7})
    prompt = [5, 17, 3, 250, 9]
    want = np.asarray(jgen.generate(jparams, jcfg, jnp.asarray([prompt]),
                                    6))[0].tolist()
    server = build_server(build_arg_parser().parse_args(
        SERVE + ["--checkpoint-dir", str(tmp_path)]))
    try:
        [out] = _post(server.url, {"prompt": prompt, "max_new_tokens": 6})
        assert out["tokens"] == want
    finally:
        server.stop(drain_timeout=5)


# ---------------------------------------------------------------------------
# the train entry point
# ---------------------------------------------------------------------------

TRAIN = dict(log_every=1, learning_rate=1e-2, warmup_steps=1,
             prefetch_depth=0)


def test_train_entry_point_matches_the_jax_trainer():
    """`--config moe_tiny` builds moe_init/moe_loss with MFU reckoned on
    the active parameters (JAX's flops_per_token); from the JAX Trainer's
    initial parameters, on the same synthetic tokens, its 3 steps give
    the JAX Trainer's losses (a learning rate that moves the loss)."""
    steps, batch, seq = 3, 4, 16
    t, cfg = build_trainer(train_parser().parse_args(
        ["--device", "cpu", "--config", "moe_tiny", "--steps", str(steps),
         "--batch-size", str(batch), "--seq-len", str(seq)]))
    jcfg = jmoe.get_moe_config("moe_tiny")
    assert isinstance(cfg, moe.MoEConfig)
    assert t.loss_fn.func is moe.moe_loss and t.init_fn.func is moe.moe_init
    assert t.config.flops_per_token == jcfg.flops_per_token(seq)
    # on the active parameters: fewer than all of them
    assert t.config.flops_per_token < 6.0 * jcfg.num_params()
    jt = JaxTrainer(partial(jmoe.moe_loss, config=jcfg),
                    partial(jmoe.moe_init, jcfg),
                    jdata.synthetic_tokens(batch, seq, jcfg.vocab_size),
                    JaxTrainerConfig(num_steps=steps, **TRAIN))
    jt.run()
    want = [m["loss"] for m in jt.metrics_history if "loss" in m]
    jparams = jax.device_get(jmoe.moe_init(jcfg, jax.random.PRNGKey(0)))
    t.init_fn = lambda _generator: params_from_jax(jparams, cfg, "cpu")
    t.config = dataclasses.replace(t.config, **TRAIN)
    t.run()
    got = [m["loss"] for m in t.metrics_history]
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL)


def test_train_entry_point_keeps_refusing_pipeline_flags(monkeypatch):
    """An MoE preset with --pp-micro on a mesh with a pp axis exits, as
    the JAX script does: the pipeline is the dense model's path."""
    monkeypatch.setenv("TPU_MESH_AXES", "pp")
    with pytest.raises(SystemExit, match="MoE scales via the ep/fsdp axes"):
        build_trainer(train_parser().parse_args(
            ["--device", "cpu", "--config", "moe_tiny", "--pp-micro", "2"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

SCHEDULE = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                decay_steps=10)


def test_moe_checkpoint_files_equal_the_jax_packages(tmp_path):
    """An f32 MoE AdamW state two updates in, saved by the JAX package,
    restored into the port's own state and saved again: index.json, the
    manifest, tree.pkl and every shard are the JAX package's bytes."""
    jcfg, jparams, cfg, _ = _jax_moe()
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(**SCHEDULE),
                       weight_decay=0.01)
    js = jopt.init(jparams)
    for step in range(2):
        leaves, treedef = jax.tree.flatten(jparams)
        grads = jax.tree.unflatten(treedef, [
            jnp.asarray(np.random.RandomState(10 * step + i)
                        .standard_normal(p.shape), p.dtype)
            for i, p in enumerate(leaves)])
        updates, js = jopt.update(grads, js, jparams)
        jparams = optax.apply_updates(jparams, updates)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 2, {"params": jparams, "opt_state": js,
                                    "step": 2})
    params = moe.moe_init(cfg, torch.Generator().manual_seed(1))
    for leaf in optim.tree_leaves(params):
        leaf.requires_grad_(True)
    opt = optim.adamw(optim.warmup_cosine_decay_schedule(**SCHEDULE),
                      weight_decay=0.01).init(params)
    state = ckpt.restore_checkpoint(
        jdir, 2, template={"params": params, "opt_state": opt.tree(),
                           "step": 0})
    opt.load_tree(state["opt_state"])
    np.testing.assert_array_equal(
        params["layers"]["we_down"].detach().numpy(),
        np.asarray(jparams["layers"]["we_down"]))
    ckpt.save_checkpoint(pdir, 2, {"params": params, "opt_state": opt.tree(),
                                   "step": state["step"]})
    j_step, p_step = os.path.join(jdir, "step_2"), os.path.join(pdir,
                                                                "step_2")
    for name in ("index.json", "manifest_p0.json"):
        with open(os.path.join(j_step, name)) as a, \
                open(os.path.join(p_step, name)) as b:
            assert json.load(a) == json.load(b), name
    with open(os.path.join(j_step, "tree.pkl"), "rb") as a, \
            open(os.path.join(p_step, "tree.pkl"), "rb") as b:
        assert b.read() == a.read()
    files = sorted(os.listdir(os.path.join(j_step, "shards")))
    assert files == sorted(os.listdir(os.path.join(p_step, "shards")))
    for name in files:
        with open(os.path.join(j_step, "shards", name), "rb") as a, \
                open(os.path.join(p_step, "shards", name), "rb") as b:
            assert a.read() == b.read(), name


def _moe_trainer(num_steps, data_iter, **config):
    cfg = moe.get_moe_config("moe_tiny")
    return trainer.Trainer(
        partial(moe.moe_loss, config=cfg), partial(moe.moe_init, cfg),
        data_iter,
        trainer.TrainerConfig(num_steps=num_steps, log_every=1,
                              learning_rate=1e-2, warmup_steps=2,
                              prefetch_depth=0, **config),
        device="cpu")


def _stream(skip=0):
    it = data.synthetic_tokens(2, 16, 256)
    for _ in range(skip):
        next(it)
    return it


def test_moe_resume_is_bit_for_bit(tmp_path):
    """2 steps and the final checkpoint, then a new Trainer resuming to
    step 4: the losses and parameters of 4 steps in one run, bit for
    bit; and the server's --checkpoint-dir serves those parameters."""
    whole = _moe_trainer(4, _stream())
    whole.run()
    d = str(tmp_path / "ck")
    _moe_trainer(2, _stream(), checkpoint_dir=d).run()
    resumed = _moe_trainer(4, _stream(skip=2), checkpoint_dir=d)
    resumed.run()
    assert [m["loss"] for m in resumed.metrics_history] == \
        [m["loss"] for m in whole.metrics_history[2:]]
    for (path, a), b in zip(_flat(resumed.params).items(),
                            _flat(whole.params).values()):
        assert torch.equal(a, b), path
    assert ckpt.committed_steps(d) == [2, 4]
    server = build_server(build_arg_parser().parse_args(
        SERVE + ["--checkpoint-dir", d]))
    try:
        served = server.engine.params
        for (path, a), b in zip(_flat(whole.params).items(),
                                _flat(served).values()):
            assert torch.equal(a.detach(), b), path
    finally:
        server.stop(drain_timeout=0)
