"""The port's speculative decoding (tony_tpu_torch/models/speculative.py)
and `generate_text` against the JAX package's, on the CPU.

JAX's `llama_init` makes the weights (target `tiny`, draft `tiny` with one
layer, as tests/test_speculative.py), `params_from_jax` carries them over,
and both packages decode the same numpy prompts. Greedy speculative
decoding is lossless, so every stream is held token for token: the port's
against JAX's `speculative_generate` and against both packages' greedy
`generate`. `window_logits` against `decode_step` at 1e-4
(tests/test_speculative.py:44). int8 weights are compared with the JAX
side jitted (its `speculative_generate` and `generate` are jitted).
"""

import importlib
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tony_tpu.models import llama as jllama
from tony_tpu.models import moe as jmoe
from tony_tpu.models import quant as jquant
from tony_tpu.models import speculative as jspec
from tony_tpu_torch.models import llama, moe, quant, speculative
from tony_tpu_torch.models.convert import params_from_jax

jgen = importlib.import_module("tony_tpu.models.generate")
generate = importlib.import_module("tony_tpu_torch.models.generate")

WINDOW_TOL = 1e-4
JCFG, JDRAFT = jllama.get_config("tiny"), jllama.get_config("tiny",
                                                             n_layers=1)
CFG, DRAFT = llama.get_config("tiny"), llama.get_config("tiny", n_layers=1)


def _pair(seed, jcfg=JCFG, cfg=CFG):
    jp = jax.device_get(jllama.llama_init(jcfg, jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jp, cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    jp, tp = _pair(0)
    jd, td = _pair(7, JDRAFT, DRAFT)
    return {"target": (jp, tp), "draft": (jd, td)}


def _prompt(seed, b=2, p=8, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, p)).astype(
        np.int32)


def _streams(target, draft, jcfg, jdcfg, cfg, dcfg, prompt, n, gamma,
             **kw):
    """(port speculative, JAX speculative, port greedy, JAX greedy)."""
    (jp, tp), (jd, td) = target, draft
    stats = {}
    port = speculative.speculative_generate(
        tp, td, cfg, dcfg, torch.from_numpy(prompt).long(), n, gamma=gamma,
        stats=stats, **kw).numpy()
    ref = np.asarray(jspec.speculative_generate(
        jp, jd, jcfg, jdcfg, jnp.asarray(prompt), n, gamma=gamma, **kw))
    greedy = generate.generate(tp, cfg, torch.from_numpy(prompt).long(), n,
                               **kw).numpy()
    jgreedy = np.asarray(jgen.generate(jp, jcfg, jnp.asarray(prompt), n,
                                       **kw))
    return port, ref, greedy, jgreedy, stats


def _assert_all_equal(port, ref, greedy, jgreedy):
    np.testing.assert_array_equal(jgreedy, ref)      # the reference's own
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, greedy)
    np.testing.assert_array_equal(greedy, jgreedy)


@pytest.mark.parametrize("quant_cache", [False, True])
def test_window_logits_match_decode_step(models, quant_cache):
    """A window of one against a uniform-length cache is a decode step
    (another masking path), on both cache layouts; and the port's window
    logits equal JAX's."""
    (jp, tp) = models["target"]
    tokens = _prompt(3, p=10)
    t = torch.from_numpy(tokens).long()
    logits, cache = generate.prefill(tp, t, CFG, 16,
                                     quant_cache=quant_cache)
    tok = torch.argmax(logits, -1)
    ref, _ = generate.decode_step(tp, CFG, {k: v.clone() for k, v in
                                            cache.items()}, tok, 10)
    lens = torch.full((2,), 10)
    win, _ = speculative.window_logits(tp, CFG, cache, tok[:, None], lens)
    np.testing.assert_allclose(ref.numpy(), win[:, 0].numpy(), rtol=0,
                               atol=WINDOW_TOL)
    jlogits, jcache = jgen.prefill(jp, jnp.asarray(tokens), JCFG, 16,
                                   quant_cache=quant_cache)
    jwin, _ = jspec.window_logits(
        jp, JCFG, jcache, jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None],
        jnp.full((2,), 10, jnp.int32))
    np.testing.assert_allclose(win.numpy(), np.asarray(jwin), rtol=0,
                               atol=WINDOW_TOL)


def test_window_of_several_rows_at_per_row_lengths(models):
    """A 3-token window at per-row lengths (6 and 9) against JAX's: the
    within-window causal mask and the per-row RoPE positions and cache
    writes."""
    (jp, tp) = models["target"]
    tokens = _prompt(4, p=10)
    _, cache = generate.prefill(tp, torch.from_numpy(tokens).long(), CFG, 16)
    _, jcache = jgen.prefill(jp, jnp.asarray(tokens), JCFG, 16)
    window = _prompt(5, p=3)
    lens = np.array([6, 9], np.int32)
    win, cache = speculative.window_logits(
        tp, CFG, cache, torch.from_numpy(window).long(),
        torch.from_numpy(lens).long())
    jwin, jcache = jspec.window_logits(jp, JCFG, jcache, jnp.asarray(window),
                                       jnp.asarray(lens))
    np.testing.assert_allclose(win.numpy(), np.asarray(jwin), rtol=0,
                               atol=WINDOW_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=WINDOW_TOL)


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_lossless_against_jax_and_both_greedy(models, gamma):
    _assert_all_equal(*_streams(models["target"], models["draft"], JCFG,
                                JDRAFT, CFG, DRAFT, _prompt(1), 12,
                                gamma)[:4])


def test_perfect_draft_accepts_every_token(models):
    """Draft == target: every drafted token is accepted, gamma + 1 tokens
    a round, and the stream is still greedy's."""
    target = models["target"]
    port, ref, greedy, jgreedy, stats = _streams(
        target, target, JCFG, JCFG, CFG, CFG, _prompt(2), 10, 3)
    _assert_all_equal(port, ref, greedy, jgreedy)
    # 1 token from the prefill, then 4 a round: 3 rounds (the last clipped)
    assert stats["rounds"] == 3
    assert stats["accepted"] == 2 * 3 * 3


def test_adversarial_draft_accepts_nothing_and_stays_lossless(models):
    """A draft from another seed at the target's size: the accepted == 0
    correction path, one token a round."""
    jd, td = _pair(99)
    port, ref, greedy, jgreedy, stats = _streams(
        models["target"], (jd, td), JCFG, JCFG, CFG, CFG,
        _prompt(4, b=3, p=6), 9, 4)
    _assert_all_equal(port, ref, greedy, jgreedy)
    assert stats["rounds"] >= 8 - stats["accepted"] // 3


def test_gamma_past_the_budget_and_a_long_run(models):
    """gamma larger than the whole budget (every round over-drafts), then
    a run whose rows finish in different rounds."""
    for n, gamma in ((2, 6), (33, 5)):
        _assert_all_equal(*_streams(models["target"], models["draft"], JCFG,
                                    JDRAFT, CFG, DRAFT,
                                    _prompt(8, b=3, p=5), n, gamma)[:4])


@pytest.fixture(scope="module")
def int8_target(models):
    jp, _ = models["target"]
    jq = jax.device_get(jquant.quantize_params(jax.tree.map(jnp.asarray,
                                                            jp)))
    return jq, params_from_jax(jq, CFG, "cpu")


@pytest.mark.parametrize("weights,quant_cache", [
    ("int8", False), ("bf16", True), ("int8", True)],
    ids=["int8_weights", "int8_cache", "full_int8_stack"])
def test_composes_with_int8(models, int8_target, weights, quant_cache):
    """int8 weights (the draft stays float), the int8 KV cache (both paths
    quantize the same rows at the same positions) and both together:
    equal to the same stack's greedy decode in each package."""
    target = int8_target if weights == "int8" else models["target"]
    _assert_all_equal(*_streams(target, models["draft"], JCFG, JDRAFT, CFG,
                                DRAFT, _prompt(6), 10, 3,
                                quant_cache=quant_cache)[:4])


def test_eos_latch_matches_greedy(models):
    """An eos that fires mid-stream (a token of greedy's row 0): the
    latched tail equals greedy's in both packages."""
    base = generate.generate(models["target"][1], CFG,
                             torch.from_numpy(_prompt(11)).long(), 12)
    eos = int(base[0, 4])
    port, ref, greedy, jgreedy, _ = _streams(
        models["target"], models["draft"], JCFG, JDRAFT, CFG, DRAFT,
        _prompt(11), 12, 3, eos_id=eos)
    assert (greedy[0] == eos).any()
    _assert_all_equal(port, ref, greedy, jgreedy)


def test_moe_target_at_no_drop_capacity(models):
    """moe_tiny at no-drop capacity (n_experts / top_k) as the target,
    the dense one-layer draft (the same vocabulary)."""
    jcfg = jmoe.get_moe_config("moe_tiny", capacity_factor=2.0)
    cfg = moe.get_moe_config("moe_tiny", capacity_factor=2.0)
    jp = jax.device_get(jmoe.moe_init(jcfg, jax.random.PRNGKey(0)))
    target = (jp, params_from_jax(jp, cfg, "cpu"))
    _assert_all_equal(*_streams(target, models["draft"], jcfg, JDRAFT, cfg,
                                DRAFT, _prompt(12), 8, 3)[:4])


def test_refusals_match_jax(models):
    """Another vocabulary, an MoE target or draft below no-drop capacity
    and a budget past max_seq raise ValueError, as in the JAX package."""
    (_, tp), (_, td) = models["target"], models["draft"]
    prompt = torch.from_numpy(_prompt(5)).long()
    bad = llama.get_config("tiny", vocab_size=128)
    with pytest.raises(ValueError, match="vocabulary"):
        speculative.speculative_generate(
            tp, llama.llama_init(bad, torch.Generator().manual_seed(1)), CFG,
            bad, prompt, 4)
    lossy = moe.get_moe_config("moe_tiny", capacity_factor=1.0)
    lossy_params = moe.moe_init(lossy, torch.Generator().manual_seed(0))
    for args in ((lossy_params, td, lossy, DRAFT),
                 (tp, lossy_params, CFG, lossy)):
        with pytest.raises(ValueError, match="no-drop capacity"):
            speculative.speculative_generate(*args, prompt, 4)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        speculative.speculative_generate(tp, td, CFG, DRAFT, prompt, 120)
    jlossy = jmoe.get_moe_config("moe_tiny", capacity_factor=1.0)
    with pytest.raises(ValueError, match="no-drop capacity"):
        jspec.speculative_generate(
            jax.device_get(jmoe.moe_init(jlossy, jax.random.PRNGKey(0))),
            models["draft"][0], jlossy, JDRAFT, jnp.asarray(_prompt(5)), 4)


class _Bytes:
    """A stand-in tokenizer: one token per byte (vocab 256), so nothing
    is downloaded."""

    def encode(self, text):
        return list(text.encode())

    def decode(self, ids):
        return bytes(int(i) for i in ids).decode("latin-1")


def test_generate_text_groups_by_length_as_jax_does(models):
    """Ragged prompts are generated in length groups (no padding) and come
    back in their order: the same strings as JAX's `generate_text`."""
    (jp, tp) = models["target"]
    prompts = ["hello", "tony", "world", "hi"]
    got = generate.generate_text(tp, CFG, prompts, _Bytes(),
                                 max_new_tokens=6)
    want = jgen.generate_text(jp, JCFG, prompts, _Bytes(), max_new_tokens=6)
    assert got == want and len(got) == 4
    assert generate.generate_text(tp, CFG, "hello", _Bytes(),
                                  max_new_tokens=6) == [got[0]]
