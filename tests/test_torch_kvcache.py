"""The port's paged prefix-shared KV cache and prefill -> decode migration
(tony_tpu_torch/serve/kvcache.py and their engine and frontend paths)
against the JAX package's, on the CPU.

Held to the JAX package: the chain hashes as strings, the fixed-shape page
copies bit for bit on the same numpy cache, the suffix prefill's logits at
3e-5 (tests/test_generate.py:62) and its cache rows, and the migration
wire format byte for byte (each package unpacks the other's payload, bf16
leaves by their bits). Held as tests/test_kvcache.py holds the JAX engine:
the pool's refcount, pin, eviction-order and chaos invariants; greedy
streams with sharing on equal to sharing off and to offline `generate`
under staggered arrivals; a migrated request bit-identical to local
decode, with and without the int8 cache, in process and over HTTP between
two frontends.
"""

import importlib
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from tony_tpu.models import llama as jllama
from tony_tpu.serve import kvcache as jkvc
from tony_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.models.llama import get_config, llama_init
from tony_tpu_torch.serve import kvcache as kvc
from tony_tpu_torch.serve.engine import (
    BudgetExceededError, ContinuousBatchingEngine,
)
from tony_tpu_torch.serve.frontend import ServeFrontend

jgen = importlib.import_module("tony_tpu.models.generate")

pytestmark = pytest.mark.kv

DECODE_TOL = 3e-5


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tiny")
    return llama_init(cfg, torch.Generator().manual_seed(0)), cfg


def _prompts(cfg, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
            for n in lengths]


def _oracle(params, cfg, prompt, n, **kw):
    return generate(params, cfg, torch.tensor([prompt]), n, **kw)[0].tolist()


def _drain(engine, handles, max_steps=300):
    for _ in range(max_steps):
        if all(h.done.is_set() for h in handles):
            return
        engine.step()
    raise AssertionError("engine did not finish the workload")


def _np(x):
    """A tensor or jax array as numpy (bf16 by its bits as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(jax.device_get(x))
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# chain hashes and the page copies, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,page", [(40, 4), (7, 4), (33, 16), (40, 0)])
def test_chain_hashes_equal_jax(n, page):
    tokens = [int(t) for t in np.random.RandomState(n).randint(0, 1 << 17,
                                                              n)]
    assert kvc.chain_hashes(tokens, page) == jkvc.chain_hashes(tokens, page)


def _caches(quant: bool, seed: int = 0):
    """A slot cache (L2, 3 slots, Hkv 2, S 16, d 4) and a page pool
    (L2, 5 pages of 4) as numpy, f32 or int8 with f32 scales."""
    rng = np.random.RandomState(seed)

    def tree(shape):
        if quant:
            return {"k": rng.randint(-127, 128, shape).astype(np.int8),
                    "v": rng.randint(-127, 128, shape).astype(np.int8),
                    "k_scale": rng.rand(*shape[:-1], 1).astype(np.float32),
                    "v_scale": rng.rand(*shape[:-1], 1).astype(np.float32)}
        return {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    return tree((2, 3, 2, 16, 4)), tree((2, 5, 2, 4, 4))


def _port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_page_copies_equal_jax(quant):
    cache, pool = _caches(quant)
    table = np.array([3, 1, 0, 0], np.int32)
    slot = 2
    want = jkvc.gather_pages(_jax(cache), _jax(pool), jnp.asarray(table),
                             jnp.int32(slot))
    got = kvc.gather_pages(_port(cache), _port(pool),
                           torch.from_numpy(table).long(), slot)
    for name in cache:
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))

    seal = np.array([0, 4, 2, 0], np.int32)
    want = jkvc.seal_pages(_jax(pool), _jax(cache), jnp.asarray(seal),
                           jnp.int32(1))
    got = kvc.seal_pages(_port(pool), _port(cache),
                         torch.from_numpy(seal).long(), 1)
    for name in pool:
        # page 0 is scratch: its bytes are whichever padded block wrote last
        np.testing.assert_array_equal(_np(got[name])[:, 1:],
                                      _np(want[name])[:, 1:])

    rows = {k: v[:, :1] * 0 + v[:, 1:2] for k, v in cache.items()}
    want = jkvc.install_rows(_jax(cache), _jax(rows), jnp.int32(0))
    got = kvc.install_rows(_port(cache), _port(rows), 0)
    for name in cache:
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_prefill_suffix_equals_jax(quant):
    """Prefix K/V from a full prefill in slot 1's rows [0, 8), then the
    suffix prefill of 5 more tokens in both packages: the logits at 3e-5
    and the slot's cache rows (int8 rows within one rounding step)."""
    jcfg = jllama.get_config("tiny")
    jparams = jllama.llama_init(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("tiny")
    params = params_from_jax(jax.device_get(jparams), cfg, "cpu")
    prompt = np.random.RandomState(3).randint(0, 256, 13).astype(np.int32)
    budget, slot, start = 24, 1, 8
    _, pc = jgen.prefill(jparams, jnp.asarray(prompt[None, :start]), jcfg,
                         budget, quant_cache=quant)
    shape = (2, 3) + tuple(pc["k"].shape[2:])
    cache = {}
    for name, leaf in pc.items():
        full = np.zeros(shape[:-1] + leaf.shape[-1:],
                        np.asarray(leaf).dtype)
        full[:, slot] = np.asarray(leaf)[:, 0]
        cache[name] = full
    suffix = prompt[start:]
    jl, jc = jkvc.prefill_suffix(jparams, jcfg, _jax(cache),
                                 jnp.asarray(suffix), jnp.int32(start),
                                 jnp.int32(slot), quant)
    pl, pcache = kvc.prefill_suffix(params, cfg, _port(cache),
                                    torch.from_numpy(suffix).long(), start,
                                    slot)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    for name in cache:
        got, want = _np(pcache[name]), _np(jc[name])
        if got.dtype == np.int8:
            gap = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert gap.max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=DECODE_TOL,
                                       atol=DECODE_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# pool refcount / copy-on-write invariants (tests/test_kvcache.py:112-196)
# ---------------------------------------------------------------------------

def _register_chain(pool, hashes):
    parent = ""
    for depth, digest in enumerate(hashes, start=1):
        if pool.has(digest):
            parent = digest
            continue
        pid = pool.allocate()
        if pid is None:
            return
        pool.register(parent, digest, pid, depth)
        parent = digest


def test_pool_refcount_pinning_and_eviction_order(model):
    _, cfg = model
    pool = kvc.KVPagePool(cfg, token_budget=32, page_size=4, n_pages=6,
                          n_slots=1, device="cpu")
    assert pool.pages_total == 5                 # scratch excluded
    ha = kvc.chain_hashes(list(range(12)), 4)    # 3-block chain
    hb = kvc.chain_hashes([7] * 8, 4)            # 2-block chain
    _register_chain(pool, ha)
    _register_chain(pool, hb)
    pool.check_invariants()
    assert pool.pages_used == 5 and pool.pages_free == 0

    ids, depth = pool.match(ha)
    assert depth == 3 and len(ids) == 3
    assert pool._nodes[ha[2]].pins == 1
    ids2, depth2 = pool.match(kvc.chain_hashes(list(range(8)), 4))
    assert depth2 == 2 and ids2 == ids[:2]
    pool.unpin(ha[1])

    assert pool.evictable_pages() == 1
    assert pool.headroom_pages() == 1
    p1 = pool.allocate()                         # LRU leaf hb[1] evicted
    assert p1 is not None and pool.evicted_pages == 1
    assert not pool.has(hb[1]) and pool.has(hb[0])
    p2 = pool.allocate()                         # hb[0] is a leaf now
    assert p2 is not None and not pool.has(hb[0])
    held = [p1, p2]
    assert pool.allocate() is None               # all pinned or interior
    pool.unpin(ha[2])
    held.append(pool.allocate())
    assert held[-1] is not None
    pool._free.extend(held)
    pool.check_invariants()
    assert set(pool.advertised) == set(pool._nodes)


def test_pool_eviction_chaos_invariants_hold(model):
    _, cfg = model
    pool = kvc.KVPagePool(cfg, token_budget=64, page_size=4, n_pages=9,
                          n_slots=1, device="cpu")
    rng = np.random.RandomState(1234)
    pinned: list[str] = []
    last_evicted = 0
    for _ in range(400):
        op = rng.randint(0, 4)
        if op == 0:
            prompt = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                  size=rng.randint(4, 24))]
            _register_chain(pool, kvc.chain_hashes(prompt, 4))
        elif op == 1:
            prompt = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                  size=rng.randint(4, 24))]
            hashes = kvc.chain_hashes(prompt, 4)
            _, depth = pool.match(hashes)
            if depth:
                pinned.append(hashes[depth - 1])
        elif op == 2 and pinned:
            pool.unpin(pinned.pop(rng.randint(0, len(pinned))))
        else:
            pid = pool.allocate()
            if pid is not None:
                assert pid != kvc.SCRATCH_PAGE
                pool._free.append(pid)
        pool.check_invariants()
        assert pool.evicted_pages >= last_evicted
        last_evicted = pool.evicted_pages
    for digest in pinned:
        pool.unpin(digest)
    pool.check_invariants()
    assert pool.sealed_pages > 0 and pool.evicted_pages > 0


# ---------------------------------------------------------------------------
# sharing on == sharing off == offline generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_prefix_sharing_on_equals_off_staggered(model, quant):
    params, cfg = model
    shared = _prompts(cfg, (8,), seed=5)[0]      # two full 4-token blocks
    tails = _prompts(cfg, (5, 3, 9, 1, 6), seed=6)
    prompts = [shared + t for t in tails] + _prompts(cfg, (7,), seed=7)
    outs = {}
    for sharing in (False, True):
        engine = ContinuousBatchingEngine(
            params, cfg, n_slots=2, token_budget=32, queue_depth=16,
            prefix_sharing=sharing, kv_page_size=4, quant_cache=quant)
        handles = [engine.submit(p, 4) for p in prompts[:2]]
        for _ in range(3):
            engine.step()
        handles += [engine.submit(p, 4) for p in prompts[2:]]
        _drain(engine, handles)
        outs[sharing] = [h.tokens for h in handles]
        if sharing:
            pool = engine.kv_pool
            pool.check_invariants()
            assert pool.req_hits == len(tails) - 1
            assert pool.hit_tokens == 8 * (len(tails) - 1)
            assert [h.kv_matched_tokens for h in handles] == \
                [0, 8, 8, 8, 8, 0]
            load = engine.load()
            assert load["kv_page_size"] == 4 and load["prefix_hashes"]
            assert engine.snapshot()["kv_hit_total"] == pool.hit_tokens
    assert outs[True] == outs[False]
    for toks, p in zip(outs[True], prompts):
        assert toks == _oracle(params, cfg, p, 4, quant_cache=quant)


# ---------------------------------------------------------------------------
# migration: the wire format, against the JAX package
# ---------------------------------------------------------------------------

META = {"prompt": [1, 2, 3], "max_new_tokens": 4, "pos": 3, "tok0": 9,
        "emitted": 1}


def _wire_leaves():
    rng = np.random.RandomState(0)
    bf16 = rng.standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16)
    return {"k": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "v": rng.randint(-127, 128, (2, 3, 4)).astype(np.int8),
            "k_scale": rng.rand(2, 3, 1).astype(np.float32),
            "h": bf16}


def test_pack_migration_bytes_equal_jax_and_cross_unpack():
    leaves = _wire_leaves()
    port_leaves = {k: tensor_from_numpy(v, "cpu") for k, v in leaves.items()}
    body = kvc.pack_migration(META, port_leaves)
    assert body == jkvc.pack_migration(META, leaves)
    # each package reads the other's payload; bf16 by its bits
    header, got = kvc.unpack_migration(jkvc.pack_migration(META, leaves))
    assert {k: header[k] for k in META} == META
    assert got["h"].dtype == torch.bfloat16
    for name in leaves:
        np.testing.assert_array_equal(_np(got[name]), _np(leaves[name]))
    _, back = jkvc.unpack_migration(body)
    for name in leaves:
        assert back[name].dtype == leaves[name].dtype
        np.testing.assert_array_equal(_np(back[name]), _np(leaves[name]))


def test_unpack_migration_refuses_malformed_payloads():
    body = kvc.pack_migration(META, {"k": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="truncated"):
        kvc.unpack_migration(body[:-5])
    with pytest.raises(ValueError, match="JSON"):
        kvc.unpack_migration(b"not-json\n" + b"x" * 8)
    with pytest.raises(ValueError, match="header line"):
        kvc.unpack_migration(b"no header separator at all")
    head = json.dumps({**META, "leaves": [
        {"name": "k", "shape": [2, 3], "dtype": "float32", "nbytes": 8}]})
    with pytest.raises(ValueError, match="bytes for shape"):
        kvc.unpack_migration(head.encode() + b"\n" + b"\0" * 8)


# ---------------------------------------------------------------------------
# migration: prefill -> decode equals local decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True],
                         ids=["fp-cache", "int8-cache"])
def test_migrate_roundtrip_bit_identical_to_local_decode(model, quant):
    params, cfg = model
    prompts = _prompts(cfg, (9, 6), seed=11)
    max_new = 5
    pre = ContinuousBatchingEngine(params, cfg, n_slots=2, token_budget=32,
                                   queue_depth=8, quant_cache=quant,
                                   role="prefill")
    dec = ContinuousBatchingEngine(params, cfg, n_slots=2, token_budget=32,
                                   queue_depth=8, quant_cache=quant,
                                   role="decode")
    for p in prompts:
        h_pre = pre.submit(p, max_new, migrate_out=True)
        _drain(pre, [h_pre])
        assert h_pre.finish_reason == "migrated"
        body = kvc.pack_migration(h_pre.migration["meta"],
                                  h_pre.migration["leaves"])
        header, leaves = kvc.unpack_migration(body)
        h_dec = dec.submit_migration(header, leaves)
        _drain(dec, [h_dec])
        assert h_dec.finish_reason == "length"
        full = h_pre.tokens + h_dec.tokens
        assert full == _oracle(params, cfg, p, max_new, quant_cache=quant)
    assert pre.snapshot()["migrated_out_total"] == len(prompts)
    assert dec.snapshot()["migrated_in_total"] == len(prompts)
    assert dec.load()["role"] == "decode"


@pytest.mark.parametrize("case", [
    "pos", "missing-leaf", "budget", "dtype", "shape", "token", "meta"])
def test_submit_migration_validation(model, case):
    params, cfg = model
    dec = ContinuousBatchingEngine(params, cfg, n_slots=1, token_budget=32,
                                   queue_depth=4)
    good = {name: torch.zeros((cfg.n_layers, cfg.n_kv_heads, 3,
                               cfg.head_dim), dtype=arr.dtype)
            for name, arr in dec._cache.items()}
    meta = dict(META, max_new_tokens=2)
    leaves = dict(good)
    if case == "pos":
        meta["pos"] = 2
    elif case == "missing-leaf":
        leaves = {"k": good["k"]}
    elif case == "budget":
        meta["max_new_tokens"] = 64
    elif case == "dtype":
        leaves["v"] = good["v"].to(torch.bfloat16)
    elif case == "shape":
        leaves["k"] = good["k"][:, :, :2]
    elif case == "token":
        meta["tok0"] = cfg.vocab_size
    else:
        meta["max_new_tokens"] = "many"
    with pytest.raises(BudgetExceededError):
        dec.submit_migration(meta, leaves)
    assert dec.queue_size() == 0


def _post(url, body, stream=False):
    data = json.dumps({**body, "stream": stream}).encode()
    rq = urllib.request.Request(url + "/v1/generate", data=data,
                                headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(rq, timeout=60) as resp:
        lines = [json.loads(x) for x in resp.read().decode().splitlines()
                 if x.strip()]
    if not stream:
        return lines[0]
    tokens = [x["token"] for x in lines if "token" in x]
    return {"tokens": tokens, **lines[-1]}


def test_http_prefill_to_decode_relay(model):
    """Two frontends: a prefill replica relays to a decode replica over
    /v1/migrate, blocking and streamed, with the greedy tokens of local
    decode; with its only target dead it finishes the request itself."""
    params, cfg = model
    dec = ContinuousBatchingEngine(params, cfg, n_slots=2, token_budget=32,
                                   role="decode")
    pre = ContinuousBatchingEngine(params, cfg, n_slots=2, token_budget=32,
                                   role="prefill")
    dec_fe = ServeFrontend(dec, port=0, host="127.0.0.1")
    with socket.socket() as s:                   # a port bound, then closed
        s.bind(("127.0.0.1", 0))
        dead_url = f"http://127.0.0.1:{s.getsockname()[1]}"
    pre_fe = ServeFrontend(pre, port=0, host="127.0.0.1", migrate_targets=[
        f"http://127.0.0.1:{dec_fe.port}"])
    lone_fe = ServeFrontend(pre, port=0, host="127.0.0.1",
                            migrate_targets=[dead_url])
    for engine in (dec, pre):
        engine.start()
    for fe in (dec_fe, pre_fe, lone_fe):
        fe.start()
    try:
        prompts = _prompts(cfg, (7, 12), seed=21)
        url = f"http://127.0.0.1:{pre_fe.port}"
        for i, p in enumerate(prompts):
            out = _post(url, {"prompt": p, "max_new_tokens": 5},
                        stream=bool(i))
            assert out["migrated"] is True
            assert out["tokens"] == _oracle(params, cfg, p, 5)
        assert dec.snapshot()["migrated_in_total"] == 2
        lone = _post(f"http://127.0.0.1:{lone_fe.port}",
                     {"prompt": prompts[0], "max_new_tokens": 4})
        assert lone["tokens"] == _oracle(params, cfg, prompts[0], 4)
        assert pre.snapshot()["migrated_in_total"] == 1
        bad = urllib.request.Request(
            f"http://127.0.0.1:{dec_fe.port}/v1/migrate", data=b"junk")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400
    finally:
        for fe in (pre_fe, lone_fe, dec_fe):
            fe.stop()
        for engine in (pre, dec):
            engine.stop()
