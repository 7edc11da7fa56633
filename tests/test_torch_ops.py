"""The port's ops (tony_tpu_torch/ops) against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX function
and the port's counterpart on the CPU, where the port runs the plain
PyTorch version beside each CUDA kernel (the kernels themselves run only on
the card: `python3 chip_smoke.py` holds each against its plain version
there). Tolerances are tests/test_ops.py's: 2e-5 in f32 (same math, sums
in another order), 3e-2 in bf16 (one bf16 rounding of the output); for
gradients 5e-4 (`:49`) and, kernel against blockwise backward, 2e-4
(`:172`).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tony_tpu.ops import attention as jattn
from tony_tpu.ops import rmsnorm as jrms
from tony_tpu.ops import rope as jrope
from tony_tpu_torch.ops import attention, cuda_lib, rmsnorm, rope
from tony_tpu_torch.ops import int8_matmul  # noqa: F401 (registers K5)

F32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_TOL = 5e-4
BWD_TOL = 2e-4


def _normal(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _jax_inverse_frequencies(head_dim, theta, scaling, orig_max_seq):
    """The JAX package's rotation rates, by `jrope.rope_frequencies`'s own
    expression (it does not return them)."""
    inv = 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32)
                           / head_dim))
    if scaling and scaling > 1.0:
        inv = jrope.scale_rope_frequencies(inv, scaling, orig_max_seq)
    return np.asarray(inv)


@pytest.mark.parametrize("scaling", [0.0, 8.0])
def test_rope_frequencies_match_jax(scaling):
    """The tables part only where their inputs part. Each side builds the
    rates inv (a pow, a division and, scaled, the rescale), rounds the
    angle t * inv to f32 and takes cos/sin. So: inv within 1 ulp of
    JAX's; then every entry within the angle's gap, t * |d inv| plus the
    two sides' roundings of the product (one f32 ulp of the angle), plus
    one ulp of 1.0 for each side's cos/sin (ATen's and XLA's f32 cos/sin
    stay within 0.61 ulp of the exact value at these angles). Measured on
    an AVX-512 host, with 1 to 8 torch threads, ATen's AVX-512, AVX2 and
    scalar kernels and XLA limited to AVX2 or SSE4.2, in one process and
    under 4 xdist workers: the rates equal bit for bit, the tables within
    one ulp of 1.0."""
    args = dict(scaling_factor=scaling, orig_max_seq=64)
    jc, js = jrope.rope_frequencies(64, 300, 500_000.0, **args)
    tc, ts = rope.rope_frequencies(64, 300, 500_000.0, **args)
    assert tc.dtype == torch.float32 and tc.shape == (300, 32)
    jinv = _jax_inverse_frequencies(64, 500_000.0, scaling, 64)
    tinv = rope.inverse_frequencies(64, 500_000.0, **args).numpy()
    d_inv = np.abs(tinv.astype(np.float64) - jinv.astype(np.float64))
    inv_ulp = np.spacing(np.abs(jinv)).astype(np.float64)
    assert np.all(d_inv <= inv_ulp), (d_inv / inv_ulp).max()
    t = np.arange(300, dtype=np.float32)[:, None]
    angle = np.abs(t * jinv)                      # JAX's f32 angles
    eps = float(np.finfo(np.float32).eps)
    bound = (t.astype(np.float64) * d_inv + np.spacing(angle) + 2 * eps)
    for name, got, want in (("cos", tc, jc), ("sin", ts, js)):
        diff = np.abs(got.numpy().astype(np.float64)
                      - np.asarray(want, np.float64))
        worst = np.unravel_index(np.argmax(diff - bound), diff.shape)
        assert np.all(diff <= bound), (
            f"{name} at (t, i) = {worst}: gap {diff[worst]:.3e} > bound "
            f"{bound[worst]:.3e} (angle {angle[worst]:.4f})")


@pytest.mark.parametrize("form", ["none", "shared", "per_row"])
@pytest.mark.parametrize("scaling", [0.0, 4.0])
def test_apply_rope_matches_jax(form, scaling):
    b, h, s, d = 2, 3, 7, 16
    x = _normal((b, h, s, d), 1)
    rng = np.random.RandomState(2)
    positions = {"none": None,
                 "shared": rng.randint(0, 40, size=(s,)),
                 "per_row": rng.randint(0, 40, size=(b, s))}[form]
    # both rotate with the same tables (the JAX ones), so this checks
    # apply_rope alone; the tables are held to each other above
    jc, js = jrope.rope_frequencies(d, 40, 10_000.0, scaling, 16)
    want = jrope.apply_rope(jnp.asarray(x), jc, js,
                            None if positions is None
                            else jnp.asarray(positions))
    got = rope.apply_rope(torch.from_numpy(x),
                          torch.from_numpy(np.array(jc)),
                          torch.from_numpy(np.array(js)),
                          None if positions is None
                          else torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_apply_rope_rejects_bad_positions():
    tc, ts = rope.rope_frequencies(8, 4)
    with pytest.raises(ValueError):
        rope.apply_rope(torch.zeros(1, 1, 2, 8), tc, ts,
                        torch.zeros(1, 1, 2, dtype=torch.long))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rms_norm_matches_jax(dtype, tol):
    x = _normal((3, 5, 256), 3) * 2.0
    w = _normal((256,), 4) + 1.0
    want = jrms.rms_norm(jnp.asarray(x, getattr(jnp, dtype)),
                         jnp.asarray(w), 1e-5)
    got = rmsnorm.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(w), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_rms_norm_cpu_path_launches_nothing():
    before = rmsnorm.RMSNORM_FWD.launches
    rmsnorm.rms_norm(torch.ones(2, 8), torch.ones(8))
    assert rmsnorm.RMSNORM_FWD.launches == before


def test_rms_norm_vjp_matches_jax():
    x = _normal((3, 5, 64), 11) * 2.0
    w = _normal((64,), 12) + 1.0
    g = _normal((3, 5, 64), 13)
    want_y, vjp = jax.vjp(lambda x, w: jrms.rms_norm(x, w, 1e-5),
                          jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = rmsnorm.rms_norm(xt, wt, 1e-5)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    for got, want in ((y.detach(), want_y), (dx, want_dx), (dw, want_dw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_rms_norm_backward_keeps_dtypes():
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    rmsnorm.rms_norm(x, w, 1e-5).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert w.grad.shape == (8,)


def test_rms_norm_refuses_other_devices():
    with pytest.raises(ValueError):
        rmsnorm.rms_norm(torch.ones(2, 8, device="meta"),
                         torch.ones(8, device="meta"))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(b, h, hk, s, d, seed):
    return (_normal((b, h, s, d), seed), _normal((b, hk, s, d), seed + 1),
            _normal((b, hk, s, d), seed + 2))


CASES = [  # (b, h, hk, s, d, causal)
    (1, 4, 2, 1, 16, True),
    (2, 4, 2, 37, 16, True),
    (1, 4, 2, 37, 16, False),
    (1, 2, 2, 100, 32, True),
    (2, 4, 4, 100, 32, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}h{}kv{}s{}d{}{}"
                         .format(*c[:5], "causal" if c[5] else ""))
def test_flash_matches_jax_pallas_interpret_and_dispatch(case):
    """Port's plain flash (out AND lse) == the real Pallas kernel run in
    interpret mode, and == JAX flash_attention's dispatch."""
    b, h, hk, s, d, causal = case
    q, k, v = _qkv(b, h, hk, s, d, 10 * s + h)
    scale = d ** -0.5
    jout, jlse = jattn._pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=scale, block_q=s, block_k=s, interpret=True)
    jflash = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal)
    out, lse = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, return_lse=True)
    assert out.shape == (b, h, s, d) and lse.shape == (b, h, s)
    assert lse.dtype == torch.float32
    for want in (jout, jflash):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=F32_TOL,
                               rtol=F32_TOL)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(1, 4, 2, 70, 32, 5)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jattn.flash_attention(*args, True)
    got = attention.flash_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("block_k", [1, 16, 512])
def test_blockwise_forward_any_block_matches_reference(block_k):
    """The plain online softmax at a ragged block split equals the O(S^2)
    oracle, so the CPU path's answer does not depend on the blocking."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 45, 16, 7))
    out, _ = attention.blockwise_forward(q, k, v, True, 0.25, block_k)
    ref = attention.reference_attention(q, k, v, True, 0.25)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


def test_flash_takes_strided_views():
    """qkv_proj's transposed (non-contiguous) views give what contiguous
    copies give."""
    x = torch.from_numpy(_normal((2, 9, 4, 16), 8))
    view = x.transpose(1, 2)
    assert not view.is_contiguous()
    a = attention.flash_attention(view, view[:, :2], view[:, 2:], True)
    b = attention.flash_attention(view.contiguous(),
                                  view[:, :2].contiguous(),
                                  view[:, 2:].contiguous(), True)
    assert torch.equal(a, b)


GRAD_CASES = [  # (h, hk, s, causal)
    (h, hk, s, causal) for h, hk in ((4, 2), (4, 4)) for s in (64, 100, 128)
    for causal in (True, False)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "h{}kv{}s{}{}"
                         .format(*c[:3], "causal" if c[3] else ""))
def test_flash_gradients_match_jax(case):
    """jax.grad of JAX's flash_attention (its pad-and-mask path at S=100)
    against the port's autograd through the flash operator."""
    h, hk, s, causal = case
    q, k, v = _qkv(1, h, hk, s, 16, s + h + hk)

    def loss(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, causal) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.flash_attention(qt, kt, vt, causal)
    got = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    for name, g_got, g_want in zip("qkv", got, want):
        assert g_got.shape == g_want.shape, name
        np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 100])
def test_blockwise_backward_matches_jax_blockwise_and_pallas(s, causal):
    """The port's plain backward against JAX's `_blockwise_backward` and
    the real Pallas backward kernels (interpret mode), on shared
    (out, lse) and narrow GQA K/V."""
    q, k, v = _qkv(1, 4, 2, s, 16, 40 + s)
    g = _normal((1, 4, s, 16), 41 + s)
    scale = 16 ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jattn._blockwise_forward(jq, jk, jv, causal, scale, s)
    wants = [jattn._blockwise_backward(jq, jk, jv, out, lse, jg, causal,
                                       scale, s),
             jattn._pallas_backward(jq, jk, jv, out, lse, jg, causal, scale,
                                    s, s, None, interpret=True)]
    got = attention.blockwise_backward(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(g), causal, scale, block_k=32)
    for want in wants:
        for name, g_got, g_want in zip("qkv", got, want):
            np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want),
                                       atol=BWD_TOL, rtol=BWD_TOL,
                                       err_msg=f"d{name}")


def test_blockwise_backward_bf16_matches_jax():
    q, k, v = _qkv(1, 4, 2, 70, 32, 50)
    g = _normal((1, 4, 70, 32), 51)
    scale = 32 ** -0.5
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    out, lse = jattn._blockwise_forward(*jargs, True, scale, 70)
    jg = jnp.asarray(g, jnp.bfloat16)
    want = jattn._blockwise_backward(*jargs, out, lse, jg, True, scale, 70)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g)]
    got = attention.blockwise_backward(
        bf[0], bf[1], bf[2],
        torch.from_numpy(np.array(out.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(lse)), bf[3], True, scale)
    for name, g_got, g_want in zip("qkv", got, want):
        assert g_got.dtype == torch.bfloat16
        np.testing.assert_allclose(g_got.float().numpy(),
                                   np.asarray(g_want.astype(jnp.float32)),
                                   atol=BF16_TOL, rtol=BF16_TOL,
                                   err_msg=f"d{name}")


# chip_smoke.py's limits for the bf16 flash backward on the card
NORM_TOL = 1e-2


def _norm_errors(got, want):
    """chip_smoke.py's `norm_err`: the whole tensor's and the worst row's
    norm-wise relative error, rows along D, with a floor of 1e-3 of the rms
    row norm."""
    g = got.reshape(-1, got.shape[-1]).astype(np.float64)
    w = want.reshape(-1, want.shape[-1]).astype(np.float64)
    diff = np.linalg.norm(g - w, axis=-1)
    rows = np.linalg.norm(w, axis=-1)
    floor = 1e-3 * np.sqrt(np.mean(rows ** 2))
    return (np.linalg.norm(diff) / np.linalg.norm(rows),
            float(np.max(diff / (rows + floor))))


def _bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).bfloat16()


def _tensor_core_backward(q, k, v, out, lse, g, scale):
    """A test-only emulation of the bf16 backward kernels' numerics
    (csrc/flash_bwd.cu, causal): bf16 operands, f32 scores and sums, P and
    dS rounded to bf16 before P^T.dO, dS^T.Q and dS.K, results rounded to
    bf16."""
    q, k, v, g = (_bf16(a).float() for a in (q, k, v, g))
    hk = k.shape[1]
    k, v = attention._gqa_broadcast(q, k, v)
    s = q.shape[2]
    scores = (q @ k.transpose(-1, -2)) * scale
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(scores - torch.from_numpy(lse)[..., None]),
                    0.0)
    delta = attention.attention_delta(g, _bf16(out))[..., None]
    ds = (p * (g @ v.transpose(-1, -2) - delta) * scale).bfloat16().float()
    p = p.bfloat16().float()
    dk, dv = attention._gqa_reduce(ds.transpose(-1, -2) @ q,
                                   p.transpose(-1, -2) @ g, hk)
    return [t.bfloat16().float().numpy() for t in (ds @ k, dk, dv)]


@pytest.mark.parametrize("hk", [2, 4])
@pytest.mark.parametrize("d", [128, 64])
def test_tensor_core_rounding_holds_the_card_limits(d, hk):
    """Before any card run: rounding P and dS to bf16 ahead of their
    products, with f32 sums, stays within chip_smoke.py's limits against
    JAX's `_blockwise_backward` on the same bf16-rounded inputs, at
    B1 H4/Hkv S512, causal: 3e-2 elementwise, 1e-2 by norm over the whole
    tensor and over the worst row."""
    b, h, s = 1, 4, 512
    q, k, v = (np.asarray(_bf16(a).float()) for a in _qkv(b, h, hk, s, d, 60))
    g = np.asarray(_bf16(_normal((b, h, s, d), 61)).float())
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jattn._blockwise_forward(jq, jk, jv, True, scale, s)
    # the backward sees the forward's bf16 out, as on the card
    out = np.asarray(_bf16(out).float())
    want = jattn._blockwise_backward(jq, jk, jv, jnp.asarray(out), lse, jg,
                                     True, scale, s)
    got = _tensor_core_backward(q, k, v, out, np.array(lse), g, scale)
    for name, g_got, g_want in zip("qkv", got, want):
        g_want = np.asarray(_bf16(g_want).float())
        np.testing.assert_allclose(g_got, g_want, atol=BF16_TOL,
                                   rtol=BF16_TOL, err_msg=f"d{name}")
        total, row = _norm_errors(g_got, g_want)
        assert total <= NORM_TOL and row <= NORM_TOL, (name, total, row)


def _tensor_core_forward(q, k, v, causal, scale, block_k):
    """A test-only emulation of the bf16 forward kernel's numerics
    (csrc/flash_fwd.cu): bf16 q, k and v; S = q.k in f32 with the scale
    applied after the product; an online softmax over key tiles of
    `block_k`; P rounded to bf16 before P.V; l summed from the f32 P; out
    rounded to bf16. Returns out (as f32) and lse."""
    q, k, v = (_bf16(a).float() for a in (q, k, v))
    k, v = attention._gqa_broadcast(q, k, v)
    b, h, s, d = q.shape
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), attention.NEG_INF)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, block_k):
        scores = (q @ k[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
        if causal:
            cols = k0 + torch.arange(scores.shape[-1])
            scores = torch.where(rows >= cols, scores, attention.NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ v[:, :, k0:k0 + block_k]
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return ((acc / l).bfloat16().float().numpy(),
            (m + torch.log(l))[..., 0].numpy())


# the card's limit on K1's lse at the training shape (chip_smoke.LSE_TOL)
LSE_TOL = 1e-4


@pytest.mark.parametrize("d,hk,causal,block_k", [
    (128, 2, True, 128), (64, 2, True, 128), (128, 4, False, 128),
    (128, 2, True, 64)], ids=lambda c: str(c))
def test_tensor_core_forward_rounding_holds_the_card_limits(d, hk, causal,
                                                            block_k):
    """Before any card run: bf16 operands for q.k and P rounded to bf16
    before P.V, with f32 sums (the kernel's 128-key tiles, and 64-key ones),
    stay within chip_smoke.py's limits against JAX's `_blockwise_forward`
    on the same bf16-rounded inputs at B1 H4/Hkv S512: 3e-2 elementwise,
    1e-2 by norm over the whole tensor and over the worst row, and lse
    within 1e-4."""
    b, h, s = 1, 4, 512
    q, k, v = (np.asarray(_bf16(a).float()) for a in _qkv(b, h, hk, s, d, 70))
    scale = d ** -0.5
    out, lse = jattn._blockwise_forward(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, scale, s)
    want = np.asarray(_bf16(out).float())     # the plain version's bf16 out
    got, got_lse = _tensor_core_forward(q, k, v, causal, scale, block_k)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)
    total, row = _norm_errors(got, want)
    assert total <= NORM_TOL and row <= NORM_TOL, (total, row)
    np.testing.assert_allclose(got_lse, np.asarray(lse), atol=LSE_TOL,
                               rtol=LSE_TOL)


def test_flash_backward_cpu_path_launches_nothing():
    before = (attention.FLASH_BWD_DQ.launches,
              attention.FLASH_BWD_DKV.launches)
    q = torch.randn(1, 2, 5, 16, requires_grad=True)
    attention.flash_attention(q, q.detach(), q.detach(), True).sum() \
        .backward()
    assert q.grad.shape == q.shape
    assert (attention.FLASH_BWD_DQ.launches,
            attention.FLASH_BWD_DKV.launches) == before


def test_flash_forward_is_one_operator_with_bshd_memory():
    """The forward is the custom op (what the save_flash policy keys on);
    out is a (B, H, S, D) view of (B, S, H, D) memory."""
    q = torch.randn(1, 4, 6, 16)
    buf, lse = torch.ops.tony_tpu_torch.flash_fwd(q, q[:, :2], q[:, :2],
                                                 True, 0.25)
    assert buf.shape == (1, 6, 4, 16) and buf.is_contiguous()
    assert lse.shape == (1, 4, 6) and lse.dtype == torch.float32
    out = attention.flash_attention(q, q[:, :2], q[:, :2], True, 0.25)
    assert torch.equal(out, buf.transpose(1, 2))
    assert out.transpose(1, 2).is_contiguous()


def test_flash_rejects_bad_shapes():
    with pytest.raises(ValueError):
        attention.flash_attention(torch.zeros(1, 3, 4, 8),
                                  torch.zeros(1, 2, 4, 8),
                                  torch.zeros(1, 2, 4, 8))


# ---------------------------------------------------------------------------
# the kernels' wrappers: validation, and no fallback to the plain version
# ---------------------------------------------------------------------------

def test_kernel_wrappers_validate_before_launching():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(TypeError):
        attention.flash_fwd_cuda(q.half(), q.half(), q.half(), True, 0.25)
    with pytest.raises(ValueError):                 # head_dim 40
        z = torch.zeros(1, 2, 4, 40)
        attention.flash_fwd_cuda(z, z, z, True, 0.25)
    with pytest.raises(ValueError):                 # strided last dim
        z = torch.zeros(1, 2, 16, 4).transpose(2, 3)
        attention.flash_fwd_cuda(z, z, z, True, 0.25)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(TypeError):                  # dO in another dtype
        attention.flash_bwd_cuda(q, q, q, q.double(), lse, lse, True, 0.25)
    with pytest.raises(ValueError):                 # lse of another shape
        attention.flash_bwd_cuda(q, q, q, q, lse[..., :2], lse, True, 0.25)
    with pytest.raises(ValueError):                 # bf16 delta
        attention.flash_bwd_cuda(q, q, q, q, lse, lse.bfloat16(), True,
                                 0.25)
    with pytest.raises(TypeError):                  # bf16 weight
        rmsnorm.rms_norm_cuda(torch.zeros(2, 8), torch.zeros(8).bfloat16(),
                              1e-5)
    with pytest.raises(ValueError):                 # non-contiguous x
        rmsnorm.rms_norm_cuda(torch.zeros(8, 2).t(), torch.zeros(8), 1e-5)


def test_bf16_backward_checks_what_tma_can_load():
    """The bf16 backward kernels load q, k, v and dO by TMA: a base that is
    not 16-byte aligned, or a batch, head or sequence stride that is not a
    multiple of 16 bytes, raises before any launch. float32 takes both."""
    lse = torch.zeros(1, 2, 4)
    q = torch.zeros(1, 2, 4, 16, dtype=torch.bfloat16)
    shifted = torch.zeros(2 * 4 * 16 + 1, dtype=torch.bfloat16)[1:].view(
        1, 2, 4, 16)
    narrow_rows = torch.zeros(1, 2, 4, 20, dtype=torch.bfloat16)[..., :16]
    before = attention.FLASH_BWD_DQ.launches
    for bad in (shifted, narrow_rows):
        with pytest.raises(ValueError, match="16-byte"):
            attention.flash_bwd_dq_cuda(q, q, q, bad, lse, lse, True, 0.25)
        with pytest.raises(ValueError, match="16-byte"):
            attention.flash_bwd_dkv_cuda(bad, q, q, q, lse, lse, True, 0.25)
    assert attention.FLASH_BWD_DQ.launches == before
    # f32 operands with the same strides pass the checks (and then need
    # the card's toolchain)
    f32 = torch.zeros(1, 2, 4, 20)[..., :16]
    assert attention._check_bwd_inputs(f32, f32, f32, f32, lse, lse) == 0


def _tma_breaking(kind: str, dtype) -> torch.Tensor:
    """A (1, 2, 4, 16) view that TMA cannot load: its base one element
    past a 16-byte boundary, or its rows 20 elements apart."""
    if kind == "shifted_base":
        return torch.zeros(2 * 4 * 16 + 1, dtype=dtype)[1:].view(1, 2, 4, 16)
    return torch.zeros(1, 2, 4, 20, dtype=dtype)[..., :16]


@pytest.mark.parametrize("operand", ["q", "k", "v"])
@pytest.mark.parametrize("bad", ["shifted_base", "narrow_rows"])
def test_bf16_forward_checks_what_tma_can_load(operand, bad):
    """The bf16 forward kernel loads q, k and v by TMA, through the same
    check as the backward: a misaligned base or a 16-byte-breaking stride
    raises before any launch; f32 operands with the same strides pass."""
    for dtype in (torch.bfloat16, torch.float32):
        args = {name: torch.zeros(1, 2, 4, 16, dtype=dtype) for name in "qkv"}
        args[operand] = _tma_breaking(bad, dtype)
        if dtype == torch.float32:
            assert attention._check_fwd_inputs(*args.values()) == 0
            continue
        before = attention.FLASH_FWD.launches
        with pytest.raises(ValueError,
                           match=f"bf16 {operand} needs a 16-byte"):
            attention.flash_fwd_cuda(*args.values(), True, 0.25)
        assert attention.FLASH_FWD.launches == before


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_libs", {})
    if cuda_lib.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.find_nvcc()
    before = attention.FLASH_FWD.launches
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        attention.flash_fwd_cuda(q, q, q, True, 0.25)
    assert attention.FLASH_FWD.launches == before
    assert not (tmp_path / "build").exists()


def test_library_path_is_keyed_by_source_content(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "_compiler", "nvcc: release 12.9\n")
    first = cuda_lib.library_path("k.cu")
    (tmp_path / "k.cu").write_text("// two\n")
    second = cuda_lib.library_path("k.cu")
    assert second != first
    assert first.parent == cuda_lib.BUILD_DIR
    # a header the source includes: adding it, then editing it, rebuilds
    (tmp_path / "helpers.cuh").write_text("// one\n")
    third = cuda_lib.library_path("k.cu")
    (tmp_path / "helpers.cuh").write_text("// two\n")
    assert len({first, second, third, cuda_lib.library_path("k.cu")}) == 4


def test_every_kernel_is_registered_with_its_source():
    assert set(cuda_lib.KERNELS) == {"flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv", "rmsnorm_fwd",
                                     "int8_matmul"}
    for kernel in cuda_lib.KERNELS.values():
        assert (cuda_lib.CSRC_DIR / kernel.source).is_file()
        if kernel.name == "int8_matmul":
            # no Pallas kernel behind it: XLA's fused dequantize -> dot
            assert kernel.replaces.startswith("tony_tpu/models/quant.py:66 ")
            continue
        path, line = kernel.replaces.split(":")
        assert path.startswith("tony_tpu/ops/") and int(line) > 0
