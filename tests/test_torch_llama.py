"""The port's Llama forward, weight carry-over and KV-cache generation
(tony_tpu_torch/models) against the JAX package's, on the `tiny` config.

JAX's `llama_init` makes the weights; `params_from_jax` carries them into
the port; both packages then see the same tokens, made with numpy from a
seed. Tolerances are tests/test_generate.py's: 2e-5 for the forward and
prefill logits, 3e-5 for a decode step (f32 end to end, sums in another
order).
"""

import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tony_tpu.models import llama as jllama
from tony_tpu_torch.models import convert, generate, llama
from tony_tpu_torch.models.convert import params_from_jax, tensor_from_numpy

# tony_tpu.models re-exports the function `generate` under the module's name
jgen = importlib.import_module("tony_tpu.models.generate")

FWD_TOL = 2e-5
DECODE_TOL = 3e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.get_config("tiny")
    jparams = jllama.llama_init(jcfg, jax.random.PRNGKey(0))
    cfg = llama.get_config("tiny")
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(b, s, seed, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(llama.PRESETS))
def test_presets_match_jax(name):
    port, ref = llama.PRESETS[name], jllama.PRESETS[name]
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if f.name == "dtype":
            assert str(got).split(".")[-1] == jnp.dtype(want).name
        else:
            assert got == want, f.name
    assert port.num_params() == ref.num_params()
    assert port.flops_per_token() == ref.flops_per_token()
    assert port.flops_per_token(1024) == ref.flops_per_token(1024)


def test_moe_preset_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="models slice"):
        llama.get_config("moe_tiny")


def test_params_from_jax_keeps_layout_and_values(tiny):
    _, jparams, cfg, params = tiny
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams))
    assert len(flat_j) == 4 + len(params["layers"]) - 1
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = params[keys[0]] if len(keys) == 1 else params[keys[0]][keys[1]]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(jax.device_get(jparams),
                        llama.get_config("tiny", dim=32), "cpu")


def test_params_from_jax_defaults_to_the_card(tiny, monkeypatch):
    """With no device given it goes to the card; without one it raises
    before any leaf is placed on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would use it")
    _, jparams, cfg, _ = tiny
    placed = []
    monkeypatch.setattr(convert, "tensor_from_numpy",
                        lambda *a: placed.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(jax.device_get(jparams), cfg)
    assert placed == []


def test_bf16_leaves_carry_over_by_their_bits():
    a = jax.random.normal(jax.random.PRNGKey(3), (5, 7)).astype(jnp.bfloat16)
    host = jax.device_get(a)
    t = tensor_from_numpy(host, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(host).view(np.int16))


def test_llama_init_is_seeded_and_shaped():
    cfg = llama.get_config("tiny")
    a = llama.llama_init(cfg, torch.Generator().manual_seed(1))
    b = llama.llama_init(cfg, torch.Generator().manual_seed(1))
    ref = jllama.llama_init(jllama.get_config("tiny"), jax.random.PRNGKey(0))
    for name, leaf in a["layers"].items():
        assert torch.equal(leaf, b["layers"][name])
        assert tuple(leaf.shape) == ref["layers"][name].shape
        assert str(leaf.dtype).split(".")[-1] == ref["layers"][name].dtype
    assert tuple(a["output"].shape) == ref["output"].shape


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def test_llama_forward_matches_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    toks = _tokens(2, 13, 1)
    want = jllama.llama_forward(jparams, jnp.asarray(toks), jcfg)
    got = llama.llama_forward(params, torch.from_numpy(toks).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 13, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_prefill_and_decode_match_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    toks = _tokens(2, 8, 2)
    jlogits, jcache = jgen.prefill(jparams, jnp.asarray(toks), jcfg, 16)
    with torch.inference_mode():
        logits, cache = generate.prefill(
            params, torch.from_numpy(toks).long(), cfg, 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=FWD_TOL,
                                   rtol=FWD_TOL)
    tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    jstep, _ = jgen.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                jnp.int32(8))
    with torch.inference_mode():
        step, cache = generate.decode_step(params, cfg, cache,
                                           torch.from_numpy(tok).long(), 8)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    # the decode wrote its K/V row in place, at position 8
    assert cache["k"][:, :, :, 8].abs().sum() > 0
    assert torch.all(cache["k"][:, :, :, 9:] == 0)


def test_decode_per_row_positions_match_jax(tiny):
    """(B,) positions, each row at its own length (the engine's shape)."""
    jcfg, jparams, cfg, params = tiny
    toks = _tokens(3, 6, 3)
    _, jcache = jgen.prefill(jparams, jnp.asarray(toks), jcfg, 16)
    with torch.inference_mode():
        _, cache = generate.prefill(params, torch.from_numpy(toks).long(),
                                    cfg, 16)
    nxt = _tokens(1, 3, 4)[0]
    pos = np.array([6, 3, 5], np.int32)
    jstep, _ = jgen.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt),
                                jnp.asarray(pos))
    with torch.inference_mode():
        step, _ = generate.decode_step(params, cfg, cache,
                                       torch.from_numpy(nxt).long(),
                                       torch.from_numpy(pos).long())
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                               atol=DECODE_TOL, rtol=DECODE_TOL)


def test_prefill_into_given_cache_rows(tiny):
    """Prefill writes into a slot's rows of a shared cache, in place, and
    leaves the other rows and positions as they were."""
    _, _, cfg, params = tiny
    toks = torch.from_numpy(_tokens(1, 5, 5)).long()
    shared = generate.empty_cache(cfg, 3, 16, torch.device("cpu"))
    shared["k"].fill_(7.0)
    rows = {n: a[:, 1:2] for n, a in shared.items()}
    with torch.inference_mode():
        logits, _ = generate.prefill(params, toks, cfg, 16, cache=rows)
        want_logits, want = generate.prefill(params, toks, cfg, 16)
    assert torch.equal(logits, want_logits)
    assert torch.equal(shared["k"][:, 1, :, :5], want["k"][:, 0, :, :5])
    assert torch.all(shared["k"][:, 1, :, 5:] == 7.0)
    assert torch.all(shared["k"][:, 0] == 7.0)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_jax(tiny, seed):
    """Equal greedy tokens, and at every step the port's top-2 logit gap
    exceeds the decode tolerance, so equality is no accident of a near
    tie."""
    jcfg, jparams, cfg, params = tiny
    toks = _tokens(2, 7, 10 + seed)
    n = 6
    want = np.asarray(jgen.generate(jparams, jcfg, jnp.asarray(toks), n))
    prompt = torch.from_numpy(toks).long()
    got = generate.generate(params, cfg, prompt, n)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.inference_mode():
        logits, cache = generate.prefill(params, prompt, cfg, 7 + n)
        for step in range(n):
            top2 = torch.topk(logits, 2, dim=-1).values
            assert torch.all(top2[:, 0] - top2[:, 1] > 10 * DECODE_TOL), step
            if step < n - 1:
                logits, cache = generate.decode_step(
                    params, cfg, cache, got[:, step], 7 + step)


def test_generate_eos_latches(tiny):
    _, _, cfg, params = tiny
    prompt = torch.from_numpy(_tokens(2, 6, 20)).long()
    free = generate.generate(params, cfg, prompt, 8)
    eos = int(free[0, 2])
    got = generate.generate(params, cfg, prompt, 8, eos_id=eos)
    row = got[0].tolist()
    first = row.index(eos)
    assert all(t == eos for t in row[first:])
    assert row[:first] == free[0, :first].tolist()


def test_generate_rejects_overlong():
    cfg = llama.get_config("tiny")
    params = llama.llama_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_seq"):
        generate.generate(params, cfg, torch.zeros(1, 120, dtype=torch.long),
                          16)


def test_sampling_is_seeded_and_in_range(tiny):
    _, _, cfg, params = tiny
    prompt = torch.from_numpy(_tokens(2, 5, 30)).long()
    runs = [generate.generate(params, cfg, prompt, 5, temperature=0.8,
                              top_k=4, top_p=0.9,
                              generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert bool(((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all())


def test_top_k_and_top_p_semantics():
    """The JAX package's nucleus contract (tests/test_generate.py): only
    tokens inside the smallest prefix whose mass reaches top_p survive,
    the most probable always does; top_k keeps the k largest."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    g = torch.Generator().manual_seed(0)
    seen = {int(generate._sample(logits, 1.0, 0, g, top_p=0.6)[0])
            for _ in range(64)}
    assert seen <= {0, 1} and 1 in seen
    seen = {int(generate._sample(logits, 1.0, 0, g, top_p=0.0)[0])
            for _ in range(16)}
    assert seen == {0}
    seen = {int(generate._sample(logits, 1.0, 3, g)[0]) for _ in range(128)}
    assert seen <= {0, 1, 2} and len(seen) == 3
    assert int(generate._sample(logits, 0.0, 0, None)[0]) == 0


def test_write_cache_rows_in_place():
    kc = torch.zeros(3, 2, 8, 4)
    vc = torch.zeros(3, 2, 8, 4)
    k = torch.ones(3, 2, 1, 4)
    generate.write_cache_rows(kc, vc, k, 2 * k, torch.tensor([0, 5, 7]))
    for row, off in enumerate((0, 5, 7)):
        assert torch.all(kc[row, :, off] == 1) and torch.all(
            vc[row, :, off] == 2)
    assert float(kc.sum()) == 3 * 2 * 4
