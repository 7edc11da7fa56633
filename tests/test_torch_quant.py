"""The port's int8 weights and int8 KV cache (tony_tpu_torch/models/quant.py,
ops/int8_matmul.py and their uses in models/generate.py) against the JAX
package's, on the CPU.

The same numpy inputs go through both packages, the port on its plain
versions. Quantization is held bit for bit (both round half to even and
divide in f32); K5's plain version against JAX's dequantize and einsum at
tests/test_ops.py's f32 2e-5 and bf16 3e-2; logits through the real
prefill and decode at 3e-5 (tests/test_generate.py:62); greedy tokens
exactly.

The JAX side runs compiled, as its engine and `generate` run it: inside a
compiled computation XLA keeps the bf16 product of `dequantize` unrounded
(q * bf16(scale), exact in f32), which is the element the port multiplies
by; run op by op, JAX rounds it to bf16 and differs by up to 2^-9 of a
weight (`test_compiled_dequantize_keeps_the_product_unrounded`).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tony_tpu.models import llama as jllama
from tony_tpu.models import quant as jquant
from tony_tpu_torch.models import llama, quant
from tony_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from tony_tpu_torch.ops import int8_matmul as k5

# the package exports the function `generate` (as the JAX package does);
# the module comes by its full name
generate = importlib.import_module("tony_tpu_torch.models.generate")

jgen = importlib.import_module("tony_tpu.models.generate")

F32_TOL = 2e-5
BF16_TOL = 3e-2
DECODE_TOL = 3e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.get_config("tiny")
    jparams = jllama.llama_init(jcfg, jax.random.PRNGKey(0))
    cfg = llama.get_config("tiny")
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _np(x):
    """A tensor or jax array as numpy (bf16 by its bits as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(jax.device_get(x))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _weight(shape, seed):
    """Channels of wildly different ranges, some exact halves of a step."""
    rng = np.random.RandomState(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    return w * np.linspace(0.05, 8.0, shape[-1], dtype=np.float32)


def _tokens(b, s, seed, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the schemes, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 32), (3, 16, 40), (2, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bitwise(shape, dtype):
    w = _weight(shape, 1)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = tensor_from_numpy(np.asarray(jax.device_get(jw)), "cpu")
    want, got = jquant.quantize(jw), quant.quantize(tw)
    assert got["int8"].dtype == torch.int8
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(_np(got["int8"]), _np(want["int8"]))
    np.testing.assert_array_equal(_np(got["scale"]), _np(want["scale"]))
    # dequantize defaults to bf16 whatever the weight's dtype
    np.testing.assert_array_equal(_np(quant.dequantize(got)),
                                  _np(jquant.dequantize(want)))
    np.testing.assert_array_equal(
        _np(quant.dequantize(got, torch.float32)),
        _np(jquant.dequantize(want, jnp.float32)))
    # the layer map dequantizes the qtensors and passes the rest through
    layer = quant.dequantize_layer({"w": got, "norm": tw})
    np.testing.assert_array_equal(
        _np(layer["w"]), _np(jquant.dequantize_layer({"w": want})["w"]))
    assert layer["norm"] is tw and quant.maybe_dequantize(tw) is tw


def test_quantize_rows_bitwise():
    x = _weight((2, 2, 7, 16), 2)
    x[0, 0, 3] = 0.0                          # an all-zero row: 1e-8 floor
    qj, sj = jquant.quantize_rows(jnp.asarray(x))
    qp, sp = quant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(qp), _np(qj))
    np.testing.assert_array_equal(_np(sp), _np(sj))
    assert tuple(sp.shape) == (2, 2, 7, 1)
    np.testing.assert_array_equal(
        _np(quant.dequantize_rows(qp, sp)),
        _np(jquant.dequantize_rows(qj, sj)))


@pytest.mark.parametrize("include_output", [True, False])
def test_quantize_params_bitwise_and_bytes(tiny, include_output):
    _, jparams, cfg, params = tiny
    jq = jquant.quantize_params(jparams, include_output=include_output)
    pq = quant.quantize_params(params, include_output=include_output)
    # the JAX tree carried over by convert.py is the port's own result
    carried = params_from_jax(jax.device_get(jq), cfg, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jq))
    for path, leaf in flat_j:
        node, twin = pq, carried
        for p in path:
            node, twin = node[p.key], twin[p.key]
        np.testing.assert_array_equal(_np(node), _np(leaf))
        np.testing.assert_array_equal(_np(twin), _np(leaf))
    assert quant.is_qtensor(pq["layers"]["wq"])
    assert quant.is_qtensor(pq["output"]) == include_output
    assert not quant.is_qtensor(pq["layers"]["attn_norm"])
    assert quant.quantized_bytes(pq) == jquant.quantized_bytes(jq)


# ---------------------------------------------------------------------------
# K5's plain version against JAX's dequantize + einsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("dtype,out_f32,tol", [
    ("float32", False, F32_TOL), ("float32", True, F32_TOL),
    ("bfloat16", False, BF16_TOL), ("bfloat16", True, BF16_TOL)])
def test_int8_matmul_plain_matches_jax(m, dtype, out_f32, tol):
    # at the init's scale (d ** -0.5): XLA's CPU dot of bf16 operands
    # strays from an f32 sum by more than the tolerance at sums near 30
    w = _weight((96, 48), 3) * 96 ** -0.5
    x = np.random.RandomState(4).standard_normal((m, 96)).astype(np.float32)
    jt = jquant.quantize(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jax.jit(lambda x, t: jnp.einsum(
        "md,dn->mn", x, jquant.dequantize(t),
        preferred_element_type=jnp.float32 if out_f32 else None))(jx, jt)
    t = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jt.items()}
    got = k5.int8_matmul(tensor_from_numpy(np.asarray(jax.device_get(jx)),
                                           "cpu"), t, out_f32=out_f32)
    assert got.dtype == (torch.float32 if out_f32 or dtype == "float32"
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,splits", [
    (4, 4096, 1024, 64), (4, 4096, 4096, 16), (4, 4096, 14336, 9),
    (4, 14336, 4096, 33), (4, 4096, 128256, 1), (1, 4096, 128256, 1),
    (1, 4096, 1024, 64), (16, 4096, 1024, 30), (16, 65536, 128256, 11),
    (3, 64, 128, 1)])
def test_k5_split_plan(m, k, n, splits):
    """K5's split of K on 132 SMs at llama3_8b's decode shapes, under the
    time model fitted to the card's sweep: the small products at about
    one block per SM (the split sums' rounds cost more than a second
    block a SM gains), w_gate and w_down at about two, none for the LM
    head, whose tiles fill a wave; and never below the split that keeps a
    block's staged x in shared memory (K 65536 at M 16: 11)."""
    assert k5.splits_for(m, k, n, 132) == splits


@pytest.mark.parametrize("m,k,n,batch,splits", [
    (4, 2048, 4096, 8, 4), (4, 4096, 2048, 8, 8), (1, 2048, 4096, 8, 4),
    (16, 2048, 4096, 8, 2), (4, 4096, 14336, 1, 9)])
def test_k5_split_plan_batched(m, k, n, batch, splits):
    """The split of K planned over the whole batched grid (column tiles x
    row blocks x experts before any split), at mixtral_proxy's expert
    banks (E 8, C 4: K 2048 N 4096 and K 4096 N 2048); a batch of one is
    the plain product's plan."""
    assert k5.splits_for(m, k, n, 132, batch) == splits
    if batch == 1:
        assert k5.splits_for(m, k, n, 132) == splits


@pytest.mark.parametrize("m,n,splits,batch,group,counters", [
    (4, 4096, 1, 1, 1, 0), (4, 14336, 9, 1, 9, 28 * 2),
    (4, 1024, 64, 1, 8, 2 * 9), (4, 4096, 16, 1, 4, 8 * 5),
    (1, 4096, 16, 1, 16, 8 * 2), (1, 4096, 33, 1, 33, 8 * 2),
    (4, 4096, 33, 1, 6, 8 * 7), (4, 4096, 4, 8, 4, 8 * 8 * 2),
    (16, 2048, 8, 8, 8, 4 * 2 * 8 * 2), (5, 1024, 36, 3, 6, 2 * 3 * 7)])
def test_k5_fold_groups_and_counters(m, n, splits, batch, group, counters):
    """The split sums' groups, whole (one round) or about the square
    root of the splits (two rounds), whichever the model finds faster for
    the rows of x, and the arrival counters a grid needs: one per group
    and one for the groups, per (expert, row block, column tile)."""
    assert k5.fold_group(splits, m) == group
    assert group == splits or (group - 1) ** 2 < splits <= group ** 2
    assert k5.counters_for(m, n, splits, batch) == counters


@pytest.mark.parametrize("c", [1, 4, 20])
@pytest.mark.parametrize("e", [1, 3])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_int8_bmm_plain_matches_jax(c, e, dtype, tol):
    """A bank of E int8 expert weights against the JAX package's bank
    product, jitted: einsum "ecd,edf->ecf" on its dequantize
    (tony_tpu/models/moe.py:179-182)."""
    w = np.stack([_weight((96, 48), 10 + i) for i in range(e)]) * 96 ** -0.5
    x = np.random.RandomState(11).standard_normal((e, c, 96)).astype(
        np.float32)
    jt = jquant.quantize(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jax.jit(lambda x, t: jnp.einsum(
        "ecd,edf->ecf", x, jquant.dequantize(t)))(jx, jt)
    t = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jt.items()}
    got = k5.int8_bmm(tensor_from_numpy(np.asarray(jax.device_get(jx)),
                                        "cpu"), t)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (e, c, 48)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("c", [1, 4, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_bmm_plain_is_each_experts_product(c, dtype):
    """The bank's plain version is, bit for bit, each expert's
    `int8_matmul_reference` stacked, so the int8 MoE path computes on the
    CPU what it computed expert by expert."""
    t = quant.quantize(torch.from_numpy(np.stack(
        [_weight((64, 32), 20 + i) for i in range(3)])))
    x = torch.from_numpy(np.random.RandomState(21).standard_normal(
        (3, c, 64)).astype(np.float32)).to(getattr(torch, dtype))
    want = torch.stack([
        k5.int8_matmul_reference(x[i], {"int8": t["int8"][i],
                                        "scale": t["scale"][i]})
        for i in range(3)])
    for got in (k5.int8_bmm(x, t), k5.int8_bmm_reference(x, t)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_np(got), _np(want))


def test_dequantized_bmm_is_each_experts_dequantized_product():
    """A prefill's bank product on the card (more rows than K5 takes):
    the bank dequantized to x's dtype and one library product, the
    arithmetic of each expert's `_dequantized_matmul` (here on the CPU, at
    the bf16 tolerance: a batched product may add in another order)."""
    t = quant.quantize(torch.from_numpy(np.stack(
        [_weight((64, 32), 30 + i) for i in range(3)]) * 64 ** -0.5))
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        x = torch.from_numpy(np.random.RandomState(31).standard_normal(
            (3, 20, 64)).astype(np.float32)).to(dtype)
        got = k5._dequantized_bmm(x, t)
        want = torch.stack([k5._dequantized_matmul(
            x[i], {"int8": t["int8"][i], "scale": t["scale"][i]}, False)
            for i in range(3)])
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   want.float().numpy(), rtol=tol, atol=tol)


def test_int8_bmm_refuses_bad_banks():
    """The bank product refuses what `_qt` refuses, with its messages: a
    bad shape, a bad dtype, a device other than cuda or cpu."""
    x = torch.zeros(2, 4, 8)
    bank = {"int8": torch.zeros(2, 8, 16, dtype=torch.int8),
            "scale": torch.zeros(2, 1, 16)}
    with pytest.raises(ValueError, match="int8 weight"):
        k5.int8_bmm(x, {"int8": bank["int8"][0], "scale": bank["scale"][0]})
    with pytest.raises(ValueError, match="int8 weight"):
        k5.int8_bmm(x, {"int8": bank["int8"], "scale": torch.zeros(2, 16)})
    with pytest.raises(ValueError, match="int8 weight"):
        k5._qt(bank)
    with pytest.raises(ValueError, match="does not fit"):
        k5.int8_bmm(torch.zeros(3, 4, 8), bank)
    with pytest.raises(TypeError, match="int8 weight and a float32"):
        k5.int8_bmm(x, {"int8": bank["int8"].float(),
                        "scale": bank["scale"]})
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        k5.int8_bmm(x.half(), bank)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.int8_bmm(x.to("meta"), {k: v.to("meta") for k, v in
                                    bank.items()})
    with pytest.raises(ValueError, match="weight on meta"):
        k5.int8_bmm(x, {k: v.to("meta") for k, v in bank.items()})
    assert tuple(k5.int8_bmm(x, bank).shape) == (2, 4, 16)
    # the kernel's own entries take only a tensor on the card
    with pytest.raises(ValueError, match="CUDA tensor"):
        k5.int8_bmm_cuda(x, bank)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k5.int8_matmul_cuda(x[0], {"int8": bank["int8"][0],
                                   "scale": bank["scale"][0]})


def test_compiled_dequantize_keeps_the_product_unrounded():
    """What the port's weight element rests on: JAX's compiled product
    equals x @ (q * bf16(scale)) in f32, its op-by-op dequantize rounds
    the element to bf16."""
    w = _weight((64, 48), 7)
    x = np.random.RandomState(8).standard_normal((3, 64)).astype(np.float32)
    jt = jquant.quantize(jnp.asarray(w))
    t = {k: tensor_from_numpy(v, "cpu") for k, v in jt.items()}
    compiled = np.asarray(jax.jit(lambda x, t: x @ jquant.dequantize(t))(
        jnp.asarray(x), jt))
    exact = (torch.from_numpy(x) @ k5.weight_f32(t)).numpy()
    rounded = (torch.from_numpy(x) @ quant.dequantize(t).float()).numpy()
    np.testing.assert_allclose(compiled, exact, rtol=F32_TOL, atol=F32_TOL)
    assert np.abs(compiled - rounded).max() > 10 * F32_TOL
    np.testing.assert_allclose(
        np.asarray(jnp.asarray(x) @ jquant.dequantize(jt)), rounded,
        rtol=F32_TOL, atol=F32_TOL)


def test_k5_wrapper_refuses_bad_weights():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="int8 weight"):
        k5._qt({"int8": torch.zeros(2, 8, 16, dtype=torch.int8),
                "scale": torch.zeros(2, 1, 16)})
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.int8_matmul(x.to("meta"), {"int8": torch.zeros(
            8, 16, dtype=torch.int8), "scale": torch.zeros(1, 16)})


# ---------------------------------------------------------------------------
# the real prefill and decode step
# ---------------------------------------------------------------------------

_jprefill = jax.jit(jgen.prefill, static_argnums=(2, 3, 4))
_jdecode = jax.jit(jgen.decode_step, static_argnums=1)


@pytest.mark.parametrize("weights,cache", [
    ("int8", "fp"), ("fp", "int8"), ("int8", "int8")],
    ids=["int8-weights", "int8-cache", "both"])
def test_prefill_and_decode_logits_match_jax(tiny, weights, cache):
    jcfg, jparams, cfg, params = tiny
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
    assert set(pc) == set(jc)
    if quant_cache:
        assert pc["k"].dtype == torch.int8
        assert tuple(pc["k_scale"].shape) == jc["k_scale"].shape
        for name in ("k", "v"):
            # rows within one rounding step of JAX's (a 1e-7 gap in the
            # f32 K/V may cross a half-step), scales to f32 rounding
            gap = np.abs(_np(pc[name]).astype(np.int32)
                         - np.asarray(jc[name]).astype(np.int32))
            assert gap.max() <= 1, name
            np.testing.assert_allclose(_np(pc[name + "_scale"]),
                                       np.asarray(jc[name + "_scale"]),
                                       rtol=1e-5, atol=0)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = np.array([12, 9], np.int32)
    jd, _ = _jdecode(jparams, jcfg, jc, jnp.asarray(tok), jnp.asarray(pos))
    pd, pc2 = generate.decode_step(params, cfg, pc,
                                   torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos).long())
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    if quant_cache:
        assert pc2["k"].dtype == torch.int8      # int8 step to step


@pytest.mark.parametrize("weights", ["fp", "int8"])
def test_generate_quant_cache_greedy_equals_jax(tiny, weights):
    jcfg, jparams, cfg, params = tiny
    # a decisive argmax (the LM head scaled), as tests/test_quant.py does
    jparams = dict(jparams, output=jparams["output"] * 8.0)
    params = dict(params, output=params["output"] * 8.0)
    if weights == "int8":
        jparams = jquant.quantize_params(jparams)
        params = quant.quantize_params(params)
    prompt = _tokens(2, 8, 6)
    want = np.asarray(jgen.generate(jparams, jcfg, jnp.asarray(prompt), 6,
                                    quant_cache=True))
    got = generate.generate(params, cfg, torch.from_numpy(prompt).long(),
                            6, quant_cache=True)
    np.testing.assert_array_equal(got.numpy(), want)
