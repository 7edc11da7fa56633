"""Paged prefix-shared KV cache and the migration wire format.

Counterpart of `tony_tpu/serve/kvcache.py`. The engine's slot cache
(L, n_slots, Hkv, token_budget, hd) stays the decode surface; this module
adds a device page pool (L, n_pages, Hkv, page_size, hd) and a host radix
index over page-aligned token blocks, so that requests sharing a prompt
prefix do not prefill it again:

- **Chain hashes.** A prompt is cut into `page_size`-token blocks; block
  i's identity is blake2b(hash[i-1] || tokens[i]), so equal hashes mean
  equal whole prefixes. The strings are the JAX package's, so a router
  may key on either package's replicas.
- **Admission.** The matched pages are gathered into the slot's rows
  [0, start) with one fixed-shape copy (the page table padded with the
  scratch page 0), and only the unmatched suffix is prefilled
  (`prefill_suffix`, a masked-einsum attention over the slot row). Decode
  writes land in the slot only, so a sealed page never changes: the
  sharing is copy-on-write at the first diverging token.
- **Sealing.** After admission the slot's complete blocks that the index
  lacks are copied out into free pages and registered.
- **Eviction.** A node is pinned while an admission uses it and held by
  its children; `allocate()` evicts the least recently used leaf that is
  neither.

The copies run in place on the port's tensors, where the JAX package
donated its buffers to jitted functions.

The migration wire format frames one prefill replica's handoff: a JSON
header line (sampler state and a leaf manifest) and the raw leaf bytes.
The bytes are the JAX package's for the same leaves: a bf16 leaf is
written by its bits under the dtype name "bfloat16" (as `str(dtype)` of
an `ml_dtypes` array reads) and read back through int16 and a `view`, so
no numpy bf16 type is needed.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from tony_tpu_torch.models.llama import (
    LlamaConfig, Params, embed_lookup, layer_params, linear, lm_head, mlp,
    qkv_proj, rope_tables,
)
from tony_tpu_torch.models.quant import dequantize_rows, quantize_rows
from tony_tpu_torch.ops.attention import NEG_INF
from tony_tpu_torch.ops.rmsnorm import rms_norm
from tony_tpu_torch.ops.rope import apply_rope

# page 0 is the scratch page: padded page-table entries point at it, so
# every page-table copy runs at one fixed shape
SCRATCH_PAGE = 0

# bound on the prefix hashes a replica advertises on /v1/load, most
# recently used first
ADVERTISE_CAP = 256

Cache = dict[str, torch.Tensor]


def chain_hashes(tokens: Sequence[int], page_size: int) -> list[str]:
    """Cumulative hashes of the complete page-aligned blocks of `tokens`:
    out[i] identifies tokens[0 : (i+1)*page_size]."""
    if page_size <= 0:
        return []
    out: list[str] = []
    prev = b""
    for i in range(len(tokens) // page_size):
        block = np.asarray(tokens[i * page_size:(i + 1) * page_size],
                           np.int32).tobytes()
        prev = hashlib.blake2b(prev + block, digest_size=12).hexdigest() \
            .encode("ascii")
        out.append(prev.decode("ascii"))
    return out


# ---------------------------------------------------------------------------
# fixed-shape page-table copies (in place)
# ---------------------------------------------------------------------------

@torch.no_grad()
def gather_pages(cache: Cache, pool: Cache, page_ids: torch.Tensor,
                 slot: int) -> Cache:
    """Copy the pages `page_ids` (padded to blocks-per-slot with the
    scratch page) from the pool into `slot`'s cache rows
    [0, n*page_size). Padded entries write scratch-page bytes into rows
    the suffix prefill, or the decode mask, covers."""
    for name, arr in cache.items():
        pages = pool[name].index_select(1, page_ids)    # (L, n, Hkv, P, d)
        l, n, h, p, d = pages.shape
        arr[:, slot, :, :n * p] = pages.transpose(1, 2).reshape(
            l, h, n * p, d).to(arr.dtype)
    return cache


@torch.no_grad()
def seal_pages(pool: Cache, cache: Cache, page_ids: torch.Tensor,
               slot: int) -> Cache:
    """Copy `slot`'s cache rows out into pool pages: block i of the slot
    lands in page page_ids[i]. Padded (and already indexed) blocks carry
    the scratch page and write into it."""
    n = page_ids.shape[0]
    for name, buf in pool.items():
        l, _, h, p, d = buf.shape
        row = cache[name][:, slot, :, :n * p]            # (L, Hkv, n*P, d)
        pages = row.reshape(l, h, n, p, d).transpose(1, 2)
        buf[:, page_ids] = pages.to(buf.dtype)
    return pool


@torch.no_grad()
def install_rows(cache: Cache, rows: Cache, slot: int) -> Cache:
    """Install one full-budget slot row tree (L, 1, Hkv, S, d), a
    migrated-in request's K/V zero-padded past its position, into
    `slot`."""
    for name, arr in cache.items():
        arr[:, slot] = rows[name][:, 0].to(arr.dtype)
    return cache


# ---------------------------------------------------------------------------
# suffix prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_suffix(params: Params, config: LlamaConfig, cache: Cache,
                   suffix: torch.Tensor, start: int, slot: int
                   ) -> tuple[torch.Tensor, Cache]:
    """Prefill only the unmatched suffix of a prompt into `slot`.

    suffix: (W,) int, the prompt's tokens [start, start+W); the slot's
    rows [0, start) already hold the gathered prefix K/V. Writes the
    suffix K/V into rows [start, start+W) (int8 with scales when the cache
    holds "k_scale") and returns (last-position logits (1, V) f32, cache).
    Attention is the masked-einsum form of the JAX package: suffix query i
    sees the slot positions j <= start + i, grouped by GQA head group (the
    JAX package takes the whole slot row, whose positions past start+W
    every query masks; here they are left out); the RoPE rows are gathered
    at the absolute positions. An MoE config's MLP routes the W suffix
    tokens on their own, as the JAX package's does."""
    quant = "k_scale" in cache
    w = suffix.shape[0]
    end = start + w
    device = suffix.device
    cos, sin = rope_tables(config, cache["k"].shape[3], device)
    positions = start + torch.arange(w, device=device)
    x = embed_lookup(params["embed"], suffix[None, :], config)    # (1,W,D)
    qi = torch.arange(w, device=device)[:, None]
    mask = torch.arange(end, device=device)[None, :] <= start + qi
    for i in range(config.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], config.norm_eps)
        q, k, v = qkv_proj(h, layer, config)     # (1,H,W,hd)/(1,Hkv,W,hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        # the slot's rows [0, end): the positions past it are masked for
        # every suffix query, so they are left out of the products
        kc = cache["k"][i, slot, :, :end]                     # (Hkv, E, hd)
        vc = cache["v"][i, slot, :, :end]
        if quant:
            ksc = cache["k_scale"][i, slot, :, :end]
            vsc = cache["v_scale"][i, slot, :, :end]
            kc[:, start:], ksc[:, start:] = quantize_rows(k[0])
            vc[:, start:], vsc[:, start:] = quantize_rows(v[0])
            k_eff, v_eff = dequantize_rows(kc, ksc), dequantize_rows(vc, vsc)
        else:
            kc[:, start:] = k[0].to(kc.dtype)
            vc[:, start:] = v[0].to(vc.dtype)
            k_eff, v_eff = kc, vc
        _, nh, _, hd = q.shape
        nkv = k_eff.shape[0]
        rep = nh // nkv
        qg = q.reshape(nkv, rep, w, hd).float() * hd ** -0.5
        scores = torch.einsum("grwd,gsd->grws", qg, k_eff.float())
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("grws,gsd->grwd", probs, v_eff.float())
        attn = out.reshape(1, nh, w, hd).to(q.dtype)
        attn = attn.transpose(1, 2).reshape(1, w, -1)
        x = x + linear(attn, layer["wo"])
        h = rms_norm(x, layer["mlp_norm"], config.norm_eps)
        x = x + mlp(h, layer, config)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return lm_head(x[:, -1], params["output"]), cache


# ---------------------------------------------------------------------------
# host-side radix index + page allocator
# ---------------------------------------------------------------------------

@dataclass
class _PageNode:
    digest: str
    parent: str          # parent block's digest ("" at depth 1)
    page_id: int
    depth: int           # 1-based block count this node's chain covers
    children: int = 0    # ref count: live child nodes
    pins: int = 0        # ref count: admissions mid-flight using it
    seq: int = 0         # LRU clock (monotonic use counter)


class KVPagePool:
    """Device page pool + host radix index. Single writer: only the
    engine's stepper thread changes the index; probe readers see atomic
    snapshots (`advertised`, int counters), so `/v1/load` stays
    lock-free."""

    def __init__(self, config: LlamaConfig, token_budget: int,
                 page_size: int = 16, n_pages: int = 0, n_slots: int = 4,
                 quant_cache: bool = False,
                 device: torch.device | str = "cuda"):
        if page_size <= 0:
            raise ValueError("kv page_size must be positive")
        self.page_size = min(page_size, token_budget)
        self.blocks_per_slot = max(1, token_budget // self.page_size)
        if n_pages <= 0:
            # default: every slot can seal a full prefix, + scratch
            n_pages = 1 + n_slots * self.blocks_per_slot
        self.n_pages = max(2, n_pages)          # >= scratch + 1 usable
        self.quant_cache = quant_cache
        c = config
        shape = (c.n_layers, self.n_pages, c.n_kv_heads, self.page_size,
                 c.head_dim)
        if quant_cache:
            scale = shape[:-1] + (1,)
            self.pool = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device)}
        else:
            self.pool = {
                "k": torch.zeros(shape, dtype=c.dtype, device=device),
                "v": torch.zeros(shape, dtype=c.dtype, device=device)}
        self._nodes: dict[str, _PageNode] = {}
        self._free: list[int] = list(range(1, self.n_pages))
        self._clock = 0
        # lock-free probe surface: an atomically swapped tuple + plain ints
        self.advertised: tuple[str, ...] = ()
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evicted_pages = 0
        self.sealed_pages = 0
        self.req_hits = 0
        self.req_misses = 0

    # -- index ----------------------------------------------------------
    @property
    def pages_total(self) -> int:
        return self.n_pages - 1                 # scratch excluded

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return len(self._nodes)

    def evictable_pages(self) -> int:
        return sum(1 for n in self._nodes.values()
                   if n.children == 0 and n.pins == 0)

    def headroom_pages(self) -> int:
        """Free + evictable pages: the router's load-score input."""
        return self.pages_free + self.evictable_pages()

    def has(self, digest: str) -> bool:
        return digest in self._nodes

    def match(self, hashes: list[str]) -> tuple[list[int], int]:
        """Longest indexed prefix of `hashes`: (page ids, depth). The
        deepest matched node is pinned (the caller unpins it after the
        admission's gather and seal); its ancestors are held by child
        refs."""
        ids: list[int] = []
        deepest: Optional[_PageNode] = None
        for digest in hashes:
            node = self._nodes.get(digest)
            if node is None:
                break
            ids.append(node.page_id)
            deepest = node
        self._clock += 1
        if deepest is not None:
            deepest.pins += 1
            for digest in hashes[:len(ids)]:
                self._nodes[digest].seq = self._clock
        return ids, len(ids)

    def pin(self, digest: str) -> None:
        node = self._nodes.get(digest)
        if node is not None:
            node.pins += 1

    def unpin(self, digest: str) -> None:
        node = self._nodes.get(digest)
        if node is not None and node.pins > 0:
            node.pins -= 1

    def allocate(self) -> Optional[int]:
        """One free page id, evicting the least recently used unpinned
        leaf when none is free. None when every page is pinned or interior
        (the caller skips sealing: reuse degrades, correctness never)."""
        if self._free:
            return self._free.pop()
        victim: Optional[_PageNode] = None
        for node in self._nodes.values():
            if node.children or node.pins:
                continue
            if victim is None or node.seq < victim.seq:
                victim = node
        if victim is None:
            return None
        self._evict(victim)
        return self._free.pop() if self._free else None

    def _evict(self, node: _PageNode) -> None:
        del self._nodes[node.digest]
        parent = self._nodes.get(node.parent)
        if parent is not None and parent.children > 0:
            parent.children -= 1
        self._free.append(node.page_id)
        self.evicted_pages += 1
        self._refresh_advertised()

    def register(self, parent: str, digest: str, page_id: int,
                 depth: int) -> None:
        """Insert one sealed block under `parent` (its chain predecessor;
        "" at depth 1)."""
        if digest in self._nodes:               # already indexed: keep it
            self._free.append(page_id)
            return
        self._clock += 1
        self._nodes[digest] = _PageNode(digest, parent, page_id, depth,
                                        seq=self._clock)
        p = self._nodes.get(parent)
        if p is not None:
            p.children += 1
        self.sealed_pages += 1
        self._refresh_advertised()

    def _refresh_advertised(self) -> None:
        nodes = sorted(self._nodes.values(), key=lambda n: -n.seq)
        self.advertised = tuple(n.digest for n in nodes[:ADVERTISE_CAP])

    def check_invariants(self) -> None:
        """Test hook: page ids partition into {scratch} + free + indexed,
        and every parent's child count equals its live children."""
        indexed = [n.page_id for n in self._nodes.values()]
        all_ids = sorted([SCRATCH_PAGE] + list(self._free) + indexed)
        if all_ids != list(range(self.n_pages)):
            raise AssertionError(f"page ids do not partition: {all_ids}")
        kids: dict[str, int] = {}
        for n in self._nodes.values():
            if n.parent:
                kids[n.parent] = kids.get(n.parent, 0) + 1
        for n in self._nodes.values():
            if n.children != kids.get(n.digest, 0):
                raise AssertionError(f"child count of {n}")
        for parent in kids:
            if parent not in self._nodes:
                raise AssertionError(f"dangling parent {parent}")

    # -- probe surface --------------------------------------------------
    def hit_rate_pct(self) -> float:
        total = self.hit_tokens + self.miss_tokens
        return 100.0 * self.hit_tokens / total if total else 0.0

    def load_fields(self) -> dict:
        """Fields merged into the engine's lock-free /v1/load snapshot."""
        return {
            "kv_page_size": self.page_size,
            "kv_pages_total": self.pages_total,
            "kv_pages_free": self.pages_free,
            "kv_pages_headroom": self.headroom_pages(),
            "kv_hit_rate_pct": round(self.hit_rate_pct(), 2),
            "prefix_hashes": list(self.advertised),
        }

    def stats_fields(self) -> dict:
        """Gauges for the engine snapshot (/v1/metrics)."""
        used = self.pages_used
        return {
            "kv_hit_total": self.hit_tokens,
            "kv_miss_total": self.miss_tokens,
            "kv_evict_total": self.evicted_pages,
            "kv_sealed_total": self.sealed_pages,
            "kv_req_hit_total": self.req_hits,
            "kv_req_miss_total": self.req_misses,
            "kv_pages_total": self.pages_total,
            "kv_pages_free": self.pages_free,
            "kv_page_size": self.page_size,
            "kv_occupancy_pct": (100.0 * used / self.pages_total
                                 if self.pages_total else 0.0),
            "kv_hit_rate_pct": round(self.hit_rate_pct(), 2),
        }


# ---------------------------------------------------------------------------
# migration wire format (prefill -> decode handoff)
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _wire_dtype(name: str) -> tuple[np.dtype, Optional[torch.dtype]]:
    """(numpy dtype the bytes are read as, torch dtype to view them as)."""
    if name == "bfloat16":
        return np.dtype(np.int16), torch.bfloat16
    return np.dtype(name), None


def pack_migration(meta: dict, leaves: dict[str, torch.Tensor]) -> bytes:
    """Frame one migrated request: a JSON header line (sampler state and
    the leaf manifest) and the raw leaf bytes in manifest order. The K/V
    bytes travel as they are: greedy decode across a migrate is
    bit-identical to local decode because of that."""
    header = dict(meta)
    header["leaves"] = [
        {"name": k, "shape": list(v.shape), "dtype": _dtype_name(v.dtype),
         "nbytes": v.numel() * v.element_size()} for k, v in leaves.items()]
    blob = b"".join(_host_bytes(v) for v in leaves.values())
    return json.dumps(header).encode("utf-8") + b"\n" + blob


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def unpack_migration(body: bytes) -> tuple[dict, dict[str, torch.Tensor]]:
    """The header and the leaves (CPU tensors) of a `pack_migration`
    payload, the JAX package's included. Raises ValueError on a malformed
    one."""
    head, sep, _ = body.partition(b"\n")
    if not sep:
        raise ValueError("migration payload missing header line")
    try:
        header = json.loads(head.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise ValueError("migration header is not valid JSON") from None
    manifest = header.pop("leaves", None)
    if not isinstance(manifest, list):
        raise ValueError("migration header missing leaf manifest")
    leaves: dict[str, torch.Tensor] = {}
    off = len(head) + 1
    for spec in manifest:
        n = int(spec["nbytes"])
        if off + n > len(body):
            raise ValueError("migration payload truncated")
        storage, view = _wire_dtype(str(spec["dtype"]))
        shape = [int(s) for s in spec["shape"]]
        if n != math.prod(shape) * storage.itemsize:
            raise ValueError(f"migration leaf {spec['name']}: {n} bytes "
                             f"for shape {shape}")
        arr = np.frombuffer(body, dtype=storage, count=n // storage.itemsize,
                            offset=off).copy()
        t = torch.from_numpy(arr).reshape(shape)
        leaves[str(spec["name"])] = t.view(view) if view is not None else t
        off += n
    return header, leaves
