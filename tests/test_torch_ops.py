"""The port's ops (tony_tpu_torch/ops) against the JAX package's.

The same inputs, made with numpy from a seed, go through the JAX function
and the port's counterpart on the CPU, where the port runs the plain
PyTorch version beside each CUDA kernel (the kernels themselves run only on
the card: `python3 chip_smoke.py` holds each against its plain version
there). Tolerances are tests/test_ops.py's: 2e-5 in f32 (same math, sums
in another order), 3e-2 in bf16 (one bf16 rounding of the output).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tony_tpu.ops import attention as jattn
from tony_tpu.ops import rmsnorm as jrms
from tony_tpu.ops import rope as jrope
from tony_tpu_torch.ops import attention, cuda_lib, rmsnorm, rope

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _normal(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _angles(head_dim, max_seq, theta):
    """The table's angles t * inv_freq, in f64."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2) / head_dim)
    return np.outer(np.arange(max_seq), inv)


def _assert_table_close(got, want, angles):
    """f32 `pow`, `cos` and `sin` may differ by a few ulps between ATen and
    XLA, and an entry at angle x then moves by about |x| * ulps * eps32:
    2e-5 plus 16 ulps of the angle."""
    bound = F32_TOL + 16 * np.finfo(np.float32).eps * np.abs(angles)
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(diff <= bound), (diff - bound).max()


@pytest.mark.parametrize("scaling", [0.0, 8.0])
def test_rope_frequencies_match_jax(scaling):
    jc, js = jrope.rope_frequencies(64, 300, 500_000.0,
                                    scaling_factor=scaling, orig_max_seq=64)
    tc, ts = rope.rope_frequencies(64, 300, 500_000.0,
                                   scaling_factor=scaling, orig_max_seq=64)
    assert tc.dtype == torch.float32 and tc.shape == (300, 32)
    angles = _angles(64, 300, 500_000.0)     # the scaled ones are smaller
    _assert_table_close(tc.numpy(), jc, angles)
    _assert_table_close(ts.numpy(), js, angles)


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
    with pytest.raises(TypeError):                  # bf16 weight
        rmsnorm.rms_norm_cuda(torch.zeros(2, 8), torch.zeros(8).bfloat16(),
                              1e-5)
    with pytest.raises(ValueError):                 # non-contiguous x
        rmsnorm.rms_norm_cuda(torch.zeros(8, 2).t(), torch.zeros(8), 1e-5)


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
    first = cuda_lib.library_path("k.cu")
    (tmp_path / "k.cu").write_text("// two\n")
    assert cuda_lib.library_path("k.cu") != first
    assert first.parent == cuda_lib.BUILD_DIR


def test_every_kernel_is_registered_with_its_source():
    assert set(cuda_lib.KERNELS) == {"flash_fwd", "rmsnorm_fwd"}
    for kernel in cuda_lib.KERNELS.values():
        assert (cuda_lib.CSRC_DIR / kernel.source).is_file()
        path, line = kernel.replaces.split(":")
        assert path.startswith("tony_tpu/ops/") and int(line) > 0
