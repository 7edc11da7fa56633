"""K6's plain version (tony_tpu_torch/ops/decode_attention.py) on the CPU:
equal to the decode step's unfused composition (`apply_rope` of q and k,
`write_cache_rows`, `cache_attention`) at ragged per-row positions, GQA
groups of 1 and 4, f32 and bf16; the cache rows it writes; an explicit
per-row softmax as a second reference; `decode_step`'s routing (one call a
layer, none for an int8 cache); and the kernel wrapper's refusals, which
raise before anything reaches the card. The kernel itself is held against
this plain version on the card by `chip_smoke.py` (DECODE_ATTN_CASES).
"""

import importlib

import numpy as np
import pytest
import torch

from tony_tpu_torch.models import llama
from tony_tpu_torch.ops import decode_attention as da
from tony_tpu_torch.ops.rope import apply_rope, rope_frequencies

generate = importlib.import_module("tony_tpu_torch.models.generate")

LAYERS, B, S, HD, HKV = 2, 4, 24, 16, 2
# ragged: the first row and the last budget row among them
POSITIONS = (0, S - 1, 5, 17)


def _case(dtype, rep, seed=0):
    """q, k, v, caches (L, B, Hkv, S, hd) filled with noise, f32 tables
    and int64 positions."""
    g = torch.Generator().manual_seed(seed)

    def noise(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    h = HKV * rep
    q = noise(B, 1, h, HD).transpose(1, 2)
    k = noise(B, 1, HKV, HD).transpose(1, 2)
    v = noise(B, 1, HKV, HD).transpose(1, 2)
    kc, vc = noise(LAYERS, B, HKV, S, HD), noise(LAYERS, B, HKV, S, HD)
    cos, sin = rope_frequencies(HD, S, 10_000.0)
    return q, k, v, kc, vc, cos, sin, torch.tensor(POSITIONS)


def _unfused(q, k, v, kc, vc, layer, cos, sin, pos):
    """The decode step's layer before K6, as it composed the pieces."""
    q = apply_rope(q, cos, sin, pos[:, None])
    k = apply_rope(k, cos, sin, pos[:, None])
    k_eff, v_eff = generate.write_cache_rows(kc[layer], vc[layer], None, k,
                                             v, pos)
    attn = da.cache_attention(q, k_eff, v_eff, pos + 1)
    return attn.transpose(1, 2).reshape(q.shape[0], 1, -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4])
def test_plain_version_equals_the_unfused_step(dtype, rep):
    q, k, v, kc, vc, cos, sin, pos = _case(dtype, rep)
    want_kc, want_vc = kc.clone(), vc.clone()
    want = _unfused(q, k, v, want_kc, want_vc, 1, cos, sin, pos)
    got = da.decode_attention(q, k, v, kc, vc, 1, cos, sin, pos)
    assert got.shape == (B, 1, HKV * rep * HD) and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(kc, want_kc) and torch.equal(vc, want_vc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4])
def test_cache_rows_written(dtype, rep):
    """Row pos[b] of the given layer holds the rotated k and the raw v;
    every other row and layer is as it was."""
    q, k, v, kc, vc, cos, sin, pos = _case(dtype, rep, seed=1)
    before_k, before_v = kc.clone(), vc.clone()
    da.decode_attention(q, k, v, kc, vc, 0, cos, sin, pos)
    k_rot = apply_rope(k, cos, sin, pos[:, None])
    written = torch.zeros(LAYERS, B, HKV, S, dtype=torch.bool)
    for b, p in enumerate(POSITIONS):
        assert torch.equal(kc[0, b, :, p], k_rot[b, :, 0])
        assert torch.equal(vc[0, b, :, p], v[b, :, 0])
        written[0, b, :, p] = True
    assert torch.equal(kc[~written], before_k[~written])
    assert torch.equal(vc[~written], before_v[~written])


@pytest.mark.parametrize("rep", [1, 4])
def test_plain_version_against_a_per_row_softmax(rep):
    """f32: each head's softmax over its row's positions [0, pos], written
    out row by row in float64 (the sums in another order: 1e-5)."""
    q, k, v, kc, vc, cos, sin, pos = _case(torch.float32, rep, seed=2)
    got = da.decode_attention(q, k, v, kc, vc, 1, cos, sin, pos)
    q_rot = apply_rope(q, cos, sin, pos[:, None]).double()
    for b, p in enumerate(POSITIONS):
        for h in range(HKV * rep):
            keys = kc[1, b, h // rep, :p + 1].double()
            vals = vc[1, b, h // rep, :p + 1].double()
            w = torch.softmax(keys @ q_rot[b, h, 0] * HD ** -0.5, dim=0)
            np.testing.assert_allclose(
                got[b, 0, h * HD:(h + 1) * HD].numpy(), (w @ vals).numpy(),
                rtol=1e-5, atol=1e-5)


def _tiny(quant_cache=False):
    cfg = llama.get_config("tiny")
    params = llama.llama_init(cfg, torch.Generator().manual_seed(0))
    prompt = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
    _, cache = generate.prefill(params, prompt, cfg, 12,
                                quant_cache=quant_cache)
    return cfg, params, cache


@pytest.mark.parametrize("quant_cache", [False, True])
def test_decode_step_calls_decode_attention_once_a_layer(monkeypatch,
                                                         quant_cache):
    """A bf16/f32 cache takes one `decode_attention` call a layer; an
    int8 cache (found by "k_scale") none: its rows are dequantized for
    `cache_attention` as before."""
    cfg, params, cache = _tiny(quant_cache)
    calls = []

    def spy(*args):
        calls.append(args[5])
        return da.decode_attention(*args)

    monkeypatch.setattr(generate, "decode_attention", spy)
    with torch.inference_mode():
        generate.decode_step(params, cfg, cache, torch.tensor([7, 8]),
                             torch.tensor([5, 5]))
    assert calls == ([] if quant_cache else list(range(cfg.n_layers)))


def test_decode_step_scalar_and_row_positions_agree():
    """The scalar-pos form (offline generate) makes the (B,) positions and
    gives the per-row form's logits and cache bit for bit."""
    cfg, params, cache = _tiny()
    other = {name: t.clone() for name, t in cache.items()}
    token = torch.tensor([7, 8])
    with torch.inference_mode():
        a, cache = generate.decode_step(params, cfg, cache, token, 5)
        b, other = generate.decode_step(params, cfg, other, token,
                                        torch.tensor([5, 5]))
    assert torch.equal(a, b)
    assert all(torch.equal(cache[n], other[n]) for n in cache)


def _refused(**change):
    args = dict(zip(("q", "k", "v", "k_cache", "v_cache", "cos", "sin",
                     "pos"), _case(torch.float32, 4)))
    args["layer"] = 0
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    ({"pos": torch.tensor(POSITIONS, dtype=torch.int32)}, TypeError),
    ({"q": torch.zeros(B, 8, 1, HD, dtype=torch.bfloat16)}, TypeError),
    ({"layer": LAYERS}, ValueError),
    ({"q": torch.zeros(B, 6, 1, HD)}, ValueError),
    ({name: torch.zeros(LAYERS, B, S, HKV, HD).transpose(2, 3)
      for name in ("k_cache", "v_cache")}, ValueError),
    ({"cos": torch.zeros(S - 1, HD // 2)}, TypeError),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(change, error):
    """Checked before any launch, so these raise on the CPU too."""
    with pytest.raises(error):
        da.decode_attention_cuda(**_refused(**change))


def test_kernel_wrapper_refuses_more_heads_than_a_row_has_lanes():
    """bf16 D16: a row is two 16-byte vectors, so a group of 4 is out."""
    args = _refused(**{n: t.to(torch.bfloat16) for n, t in zip(
        ("q", "k", "v", "k_cache", "v_cache"), _case(torch.float32, 4))})
    with pytest.raises(ValueError, match="at most"):
        da.decode_attention_cuda(**args)


def test_kernel_wrapper_refuses_a_head_dim_it_is_not_built_for():
    q = torch.zeros(B, 4, 1, 32, dtype=torch.bfloat16)
    k = torch.zeros(B, 1, 1, 32, dtype=torch.bfloat16)
    cache = torch.zeros(1, B, 1, S, 32, dtype=torch.bfloat16)
    cos = torch.zeros(S, 16)
    with pytest.raises(ValueError, match="head dims"):
        da.decode_attention_cuda(q, k, k, cache, cache, 0, cos, cos,
                                 torch.tensor(POSITIONS))
