"""Continuous-batching inference engine over the KV-cache decode core.

Counterpart of `tony_tpu/serve/engine.py`. Requests flow through fixed
shapes:

- **Admission**: a request is admitted by prefilling its prompt (batch 1,
  the same `prefill` the offline path uses), which writes the prompt's K/V
  straight into its slot's rows of the shared cache
  (L, n_slots, Hkv, token_budget, hd), the JAX package's layout. The
  writes happen in place, where JAX donated the buffer.
- **Decode**: every engine step runs `decode_step` over ALL slots with
  per-row positions (each slot at its own sequence length); rows are
  independent, so an active slot's tokens are those of decoding that
  request alone, and therefore those of the offline `generate()`.
- **Latch + recycle**: per-slot eos/length latches run on the host on the
  sampled tokens; a finished row frees its slot for the next queued
  request at once. K/V an idle slot writes, and rows past a new
  occupant's prompt, are always masked (positions >= the slot's length)
  and overwritten by that occupant's decode writes, so recycling needs no
  cache scrubbing.

Composes with the offline path's levers: the int8 KV cache
(`quant_cache`, the shared `write_cache_rows`) and int8 weights
(quantized params pass straight through).

Prefix sharing (`prefix_sharing=True`, serve/kvcache.py): admission first
gathers the radix-indexed pages of the prompt's longest known prefix into
the slot on the device, then prefills only the unmatched suffix
(`prefill_suffix`), and seals the newly computed complete blocks into the
page pool for the next sharer. An admission that matches no page prefills
as with sharing off (the flash kernel), where the JAX package runs its
suffix prefill from position 0; the greedy streams are the same either
way. Decode is untouched.

Disaggregation: `role="prefill"` engines admit with `migrate_out=True`
and, instead of decoding, extract the slot's K/V and sampler state into
`handle.migration` (finish_reason "migrated"); a `role="decode"` engine
installs it with `submit_migration()` and decodes from the transplanted
bytes, so greedy decode across a migrate is bit-identical to decoding
locally.

Sampling: greedy (`temperature=0`) is the contract, equal to offline
greedy. Temperature/top-k/top-p are engine-wide settings; sampled streams
draw from one engine `torch.Generator` seeded with SAMPLING_SEED at
construction, in admission and step order.

Observability: the stepper beats the `serve-engine` profiler beacon each
iteration (a wedged loop is a stall the watchdog reports), handles carry
the request-trace context the frontend adopts (`trace`, `trace_ctx`) and
the phase stamps `record_engine_phases` reads (`kv_match_s`,
`migrated_in`), and `on_request_finished` is the hook request tracing
and the serve_request span compose onto.
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from tony_tpu_torch.models.generate import (
    _sample, decode_step, empty_cache, prefill,
)
from tony_tpu_torch.models.llama import LlamaConfig, Params
from tony_tpu_torch.serve import kvcache as kvc

LOG = logging.getLogger(__name__)

_DONE = object()
SAMPLING_SEED = 0


class QueueFullError(RuntimeError):
    """Pending-request queue (or its token budget) is full — backpressure;
    the frontend maps this to HTTP 429."""


class DrainingError(RuntimeError):
    """The engine is draining: in-flight requests finish, NEW submissions
    are refused — the frontend maps this to HTTP 503."""


class BudgetExceededError(ValueError):
    """prompt + max_new_tokens exceeds the engine's per-slot token budget —
    a permanent rejection (retries would never help); HTTP 400."""


class RequestHandle:
    """Caller-side view of one request: a thread-safe token stream plus
    completion state and latency timestamps (TTFT / inter-token)."""

    def __init__(self, request_id: int, prompt: list[int],
                 max_new_tokens: int):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tokens: list[int] = []
        # "eos" | "length" | "shutdown" | "cancelled" | "migrated"
        self.finish_reason: Optional[str] = None
        # disaggregation: migrate_out marks a prefill-role request whose
        # decode is handed off; on finish_reason "migrated", `migration`
        # holds {"meta", "leaves"} for pack_migration. On the decode side,
        # `install` carries the unpacked payload until the stepper
        # installs it into a slot.
        self.migrate_out = False
        self.migration: Optional[dict] = None
        self.install: Optional[dict] = None
        # prefix tokens whose K/V came from the page pool at admission
        self.kv_matched_tokens = 0
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # time queued before a slot freed, and the admission prefill itself
        self.queue_wait_s: Optional[float] = None
        self.prefill_s: Optional[float] = None
        # the prefix match's share of the prefill (paged admission only)
        self.kv_match_s: Optional[float] = None
        # installed from a prefill replica's /v1/migrate handoff
        self.migrated_in = False
        # request tracing (observability/reqtrace.py), set by the frontend
        self.trace = None
        self.trace_ctx = None
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self._queue: "queue.Queue" = queue.Queue()

    # engine side -------------------------------------------------------
    def _push(self, token: int, now: float) -> None:
        if self.first_token_at is None:
            self.first_token_at = now
        self.tokens.append(token)
        self._queue.put(token)

    def _finish(self, reason: str, now: float) -> None:
        self.finish_reason = reason
        self.finished_at = now
        self.done.set()
        self._queue.put(_DONE)

    # caller side -------------------------------------------------------
    def cancel(self) -> None:
        """Abandon this request: a pending request is dropped at admission
        time, an in-flight one frees its slot at the next step boundary."""
        self.cancelled.set()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def decode_s(self) -> Optional[float]:
        """Wall time spent decoding past the first token."""
        if self.first_token_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.first_token_at

    def iter_tokens(self, timeout: Optional[float] = None):
        """Yield tokens as they are generated; returns on completion.
        Raises TimeoutError when the stream stalls past `timeout`."""
        while True:
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.request_id}: no token within "
                    f"{timeout}s") from None
            if item is _DONE:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> list[int]:
        """Block until the request finishes; returns all generated tokens."""
        if not self.done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.request_id} not done "
                               f"within {timeout}s")
        return list(self.tokens)


@dataclass
class _Slot:
    index: int
    handle: Optional[RequestHandle] = None
    pos: int = 0          # next cache position the decode writes at
    emitted: int = 0      # generated tokens so far (incl. the prefill one)
    last_emit_at: float = 0.0   # inter-token latency anchor

    @property
    def active(self) -> bool:
        return self.handle is not None


@dataclass
class EngineStats:
    """Aggregate serving metrics, guarded by the engine lock. Percentile
    sources are bounded deques — a gauge window, not an unbounded log."""
    tokens_emitted: int = 0
    requests_finished: int = 0
    queue_depth_max: int = 0
    requests_submitted: int = 0
    requests_rejected: int = 0
    # device work: prefills run (one per admitted request) and decode
    # steps run (one per step over all slots)
    admissions: int = 0
    decode_steps: int = 0
    started_at: float = field(default_factory=time.monotonic)
    ttft_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=512))
    itl_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=2048))
    queue_wait_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=512))
    prefill_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=512))
    # requests handed off to a decode replica (prefill role) / adopted
    # from a prefill replica (decode role)
    migrated_out: int = 0
    migrated_in: int = 0


def _percentile(samples, q: float) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def _phase_percentiles(snap: dict, key: str, samples, scale: float = 1.0
                       ) -> None:
    """p50/p95/p99 of one latency phase into the snapshot (None-valued
    when the window is empty, so idle servers still expose the keys)."""
    for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
        v = _percentile(samples, q)
        snap[f"{key}_{tag}"] = None if v is None else v * scale


class ContinuousBatchingEngine:
    """Slot-managed online decode over one shared KV cache on the device
    that holds `params`.

    Thread model: `submit()` is called from any number of frontend threads;
    a single loop thread (`start()`) — or a test driving `step()` directly —
    owns the device state. The lock guards only the pending queue, slot
    table, and stats; device tensors are touched exclusively by the stepper.
    """

    def __init__(self, params: Params, config: LlamaConfig,
                 n_slots: int = 4, token_budget: int = 0,
                 queue_depth: int = 64, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_id: Optional[int] = None, quant_cache: bool = False,
                 weights_generation: int = 0,
                 prefix_sharing: bool = False, kv_page_size: int = 16,
                 kv_pages: int = 0, role: str = "both"):
        if token_budget <= 0:
            token_budget = config.max_seq
        if token_budget > config.max_seq:
            raise ValueError(f"token_budget {token_budget} exceeds "
                             f"config.max_seq {config.max_seq}")
        # queued-WORK bound next to the request-count bound: half-budget
        # average request size, so a few near-budget requests shed load as
        # early as many small ones
        self.queue_token_budget = max(token_budget,
                                      queue_depth * token_budget // 2)
        self.params = params
        self.config = config
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.token_budget = token_budget
        self.queue_depth = queue_depth
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.quant_cache = quant_cache
        # disaggregated serving role: "prefill" replicas migrate decode
        # work out after admission, "decode" replicas accept /v1/migrate
        # installs, "both" is the monolithic replica
        self.role = role if role in ("prefill", "decode", "both") else "both"
        self._cache = empty_cache(config, n_slots, token_budget, self.device,
                                  quant_cache)
        # paged prefix-shared KV pool (serve/kvcache.py); None = sharing off
        self.kv_pool: Optional[kvc.KVPagePool] = None
        if prefix_sharing:
            self.kv_pool = kvc.KVPagePool(
                config, token_budget=token_budget,
                page_size=kv_page_size if kv_page_size > 0 else 16,
                n_pages=kv_pages, n_slots=n_slots, quant_cache=quant_cache,
                device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(
            SAMPLING_SEED)
        # host mirrors of the per-slot device state; uploaded per step
        self._tokens_np = np.zeros((n_slots,), np.int64)
        self._pos_np = np.zeros((n_slots,), np.int64)
        self._slots = [_Slot(i) for i in range(n_slots)]
        self._pending: collections.deque[RequestHandle] = collections.deque()
        self._pending_tokens = 0   # queued prompt+max_new total
        self._next_id = itertools.count()
        self._lock = threading.Lock()
        self._work = threading.Event()      # submit() kicks the loop
        self._stop = threading.Event()
        self._draining = threading.Event()
        self.weights_generation = int(weights_generation)
        self._thread: Optional[threading.Thread] = None
        self.stats = EngineStats()
        # called (outside the engine lock) with each RequestHandle as it
        # finishes
        self.on_request_finished: Optional[Callable] = None

    # -- intake ---------------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int,
               migrate_out: bool = False) -> RequestHandle:
        """Enqueue a request. Raises BudgetExceededError when it can never
        fit a slot, QueueFullError when the bounded queue (or its token
        budget) is full, DrainingError while draining.

        migrate_out=True (prefill-role frontends): after admission
        computes the prompt's K/V and first token, the request finishes
        with reason "migrated" and `handle.migration` carries the decode
        handoff instead of decoding here."""
        if max_new_tokens < 1:
            raise BudgetExceededError("max_new_tokens must be >= 1")
        if not prompt:
            raise BudgetExceededError("empty prompt")
        vocab = self.config.vocab_size
        if any(t < 0 or t >= vocab for t in prompt):
            raise BudgetExceededError(
                f"prompt contains token ids outside [0, {vocab})")
        need = len(prompt) + max_new_tokens
        if need > self.token_budget:
            raise BudgetExceededError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"the per-slot token budget {self.token_budget}")
        handle = RequestHandle(next(self._next_id), list(prompt),
                               max_new_tokens)
        handle.migrate_out = bool(migrate_out)
        return self._enqueue(handle, need)

    def submit_migration(self, meta: dict,
                         leaves: dict[str, torch.Tensor]) -> RequestHandle:
        """Adopt a migrated request from a prefill replica: check the K/V
        payload against this engine's cache layout and enqueue it; the
        stepper installs it into a slot with `install_rows` (no prefill is
        paid here). The same backpressure as submit()."""
        try:
            prompt = [int(t) for t in meta.get("prompt") or []]
            max_new = int(meta.get("max_new_tokens", 0))
            pos = int(meta.get("pos", -1))
            tok0 = int(meta.get("tok0", -1))
            emitted = int(meta.get("emitted", 1))
        except (TypeError, ValueError):
            raise BudgetExceededError("invalid migration metadata") from None
        if not prompt or max_new < 1:
            raise BudgetExceededError("invalid migration metadata")
        vocab = self.config.vocab_size
        if any(t < 0 or t >= vocab for t in prompt + [tok0]):
            raise BudgetExceededError(
                f"migration carries token ids outside [0, {vocab})")
        if pos != len(prompt):
            raise BudgetExceededError(
                f"migration pos {pos} != prompt length {len(prompt)}")
        need = len(prompt) + max_new
        if need > self.token_budget:
            raise BudgetExceededError(
                f"migrated prompt {len(prompt)} + max_new {max_new} "
                f"exceeds the per-slot token budget {self.token_budget}")
        if set(leaves) != set(self._cache):
            raise BudgetExceededError(
                f"migration cache layout mismatch: payload "
                f"{sorted(leaves)}, serving {sorted(self._cache)}")
        for name, arr in self._cache.items():
            l, _, h, _, d = arr.shape
            leaf = leaves[name]
            if tuple(leaf.shape) != (l, h, pos, d):
                raise BudgetExceededError(
                    f"migration leaf {name} shape {tuple(leaf.shape)} != "
                    f"{(l, h, pos, d)}")
            if leaf.dtype != arr.dtype:
                raise BudgetExceededError(
                    f"migration leaf {name} dtype {leaf.dtype} != "
                    f"{arr.dtype}")
        handle = RequestHandle(next(self._next_id), prompt, max_new)
        handle.install = {"pos": pos, "tok0": tok0, "emitted": emitted,
                          "leaves": leaves}
        return self._enqueue(handle, need)

    def _enqueue(self, handle: RequestHandle, need: int) -> RequestHandle:
        """Queue a checked request under the draining, stop, depth and
        queued-token bounds."""
        if self._draining.is_set():
            raise DrainingError("engine is draining")
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("engine is stopped")
            if len(self._pending) >= self.queue_depth:
                self.stats.requests_rejected += 1
                raise QueueFullError(
                    f"request queue full ({self.queue_depth} pending)")
            if self._pending_tokens + need > self.queue_token_budget:
                self.stats.requests_rejected += 1
                raise QueueFullError(
                    f"queued token budget exhausted "
                    f"({self._pending_tokens} of "
                    f"{self.queue_token_budget} tokens pending)")
            self.stats.requests_submitted += 1
            self._pending.append(handle)
            self._pending_tokens += need
            self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                             len(self._pending))
        self._work.set()
        return handle

    def queue_size(self) -> int:
        with self._lock:
            return len(self._pending)

    def active_slots(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s.active)

    # -- draining + load probe ------------------------------------------
    def begin_drain(self) -> None:
        """Enter the draining state: in-flight and queued requests run to
        completion, new submissions raise DrainingError. Idempotent."""
        if not self._draining.is_set():
            LOG.info("engine draining: refusing new work, %d pending / "
                     "%d active to finish", len(self._pending),
                     sum(1 for s in self._slots if s.active))
        self._draining.set()
        self._work.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drained(self) -> bool:
        """True once a draining engine holds no pending or in-flight work."""
        with self._lock:
            idle = not self._pending
        return idle and not any(s.active for s in self._slots)

    def wait_drained(self, timeout: float) -> bool:
        """Bounded wait for drained() — the shutdown path's grace."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.drained():
                return True
            time.sleep(0.02)
        return self.drained()

    def load(self) -> dict:
        """The router's load probe: queue depth, free slots, draining
        state, weights generation. Lock-free: a momentarily stale count
        only costs one slightly uneven routing decision."""
        active = sum(1 for s in self._slots if s.handle is not None)
        load = {
            "queue_depth": len(self._pending),
            "slots_free": max(0, self.n_slots - active),
            "active_slots": active,
            "n_slots": self.n_slots,
            "draining": self._draining.is_set(),
            "weights_generation": self.weights_generation,
            "role": self.role,
            "token_budget": self.token_budget,
        }
        pool = self.kv_pool
        if pool is not None:
            # page-pool headroom and advertised prefix hashes (plain ints
            # and an atomically swapped tuple: still lock-free)
            load.update(pool.load_fields())
        return load

    # -- stepping -------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> bool:
        """One engine iteration: reap cancelled slots, admit as many queued
        requests as there are free slots, then decode every active slot one
        token. Returns True when any work happened (the loop's idle
        signal)."""
        reaped = False
        for slot in self._slots:
            if slot.active and slot.handle.cancelled.is_set():
                self._finish_slot(slot, "cancelled", time.monotonic())
                reaped = True
        admitted = self._admit_pending() or reaped
        active = [s for s in self._slots if s.active]
        if not active:
            return admitted
        tokens = torch.tensor(self._tokens_np, device=self.device)
        pos = torch.tensor(self._pos_np, device=self.device)
        logits, _ = decode_step(self.params, self.config, self._cache,
                                tokens, pos)
        nxt = _sample(logits, self.temperature, self.top_k, self._generator,
                      self.top_p)
        nxt_np = nxt.cpu().numpy()
        now = time.monotonic()
        with self._lock:
            self.stats.decode_steps += 1
        for slot in active:
            token = int(nxt_np[slot.index])
            slot.pos += 1
            self._pos_np[slot.index] = slot.pos
            self._tokens_np[slot.index] = token
            slot.emitted += 1
            slot.handle._push(token, now)
            with self._lock:
                self.stats.tokens_emitted += 1
                self.stats.itl_s.append(now - slot.last_emit_at)
            slot.last_emit_at = now
            self._maybe_finish(slot, token, now)
        return True

    def _admit_pending(self) -> bool:
        admitted = False
        while True:
            free = next((s for s in self._slots if not s.active), None)
            if free is None:
                return admitted
            with self._lock:
                if not self._pending:
                    return admitted
                handle = self._pending.popleft()
                self._pending_tokens -= (len(handle.prompt)
                                         + handle.max_new_tokens)
            if handle.cancelled.is_set():
                # dropped while still queued: no prefill is ever paid
                handle._finish("cancelled", time.monotonic())
                admitted = True
                continue
            if handle.install is not None:
                self._admit_migrated(free, handle)
            else:
                self._admit(free, handle)
            admitted = True

    def _admit(self, slot: _Slot, handle: RequestHandle) -> None:
        # queue wait ends when a free slot dequeues the request; everything
        # until the first sampled token reaches the host is the prefill
        t_dequeue = time.monotonic()
        handle.queue_wait_s = t_dequeue - handle.submitted_at
        i = slot.index
        pool = self.kv_pool
        hashes: list[str] = []
        depth = 0
        if pool is not None:
            # the longest indexed prefix, capped so that at least one
            # suffix token is left to give the logits
            hashes = kvc.chain_hashes(handle.prompt, pool.page_size)
            usable = (len(handle.prompt) - 1) // pool.page_size
            page_ids, depth = pool.match(hashes[:usable])
            handle.kv_match_s = time.monotonic() - t_dequeue
        start = depth * pool.page_size if depth else 0
        if depth:
            table = torch.full((pool.blocks_per_slot,), kvc.SCRATCH_PAGE,
                               dtype=torch.long)
            table[:depth] = torch.tensor(page_ids)
            kvc.gather_pages(self._cache, pool.pool, table.to(self.device),
                             i)
            handle.kv_match_s = time.monotonic() - t_dequeue
            suffix = torch.tensor(handle.prompt[start:], dtype=torch.long,
                                  device=self.device)
            logits, _ = kvc.prefill_suffix(self.params, self.config,
                                           self._cache, suffix, start, i)
        else:
            prompt = torch.tensor([handle.prompt], dtype=torch.long,
                                  device=self.device)
            rows = {name: arr[:, i:i + 1]
                    for name, arr in self._cache.items()}
            logits, _ = prefill(self.params, prompt, self.config,
                                self.token_budget, cache=rows)
        tok0 = int(_sample(logits, self.temperature, self.top_k,
                           self._generator, self.top_p)[0])
        if pool is not None:
            # the slot holds the whole prompt's K/V: seal the complete
            # blocks the index lacks, release the admission's pin and
            # count the reuse
            self._seal_prefix(slot, handle, hashes, depth)
            if depth:
                pool.unpin(hashes[depth - 1])
            pool.hit_tokens += start
            pool.miss_tokens += len(handle.prompt) - start
            if start:
                pool.req_hits += 1
            else:
                pool.req_misses += 1
        handle.kv_matched_tokens = start
        now = time.monotonic()
        handle.prefill_s = now - t_dequeue
        handle.admitted_at = now
        slot.handle = handle
        slot.pos = len(handle.prompt)
        slot.emitted = 1
        slot.last_emit_at = now
        self._pos_np[i] = slot.pos
        self._tokens_np[i] = tok0
        handle._push(tok0, now)
        with self._lock:
            self.stats.admissions += 1
            self.stats.tokens_emitted += 1
            self.stats.ttft_s.append(now - handle.submitted_at)
            self.stats.queue_wait_s.append(handle.queue_wait_s)
            self.stats.prefill_s.append(handle.prefill_s)
        LOG.debug("admitted request %d into slot %d (prompt %d, matched %d, "
                  "max_new %d)", handle.request_id, i, len(handle.prompt),
                  start, handle.max_new_tokens)
        if handle.migrate_out:
            done = ((self.eos_id is not None and tok0 == self.eos_id)
                    or handle.max_new_tokens <= 1)
            if not done:
                # hand the decode off: the slot's K/V rows [0, pos) and
                # the sampler state, then free the slot at once (the
                # frontend relays the payload to a decode replica)
                handle.migration = self._extract_migration(slot, handle,
                                                           tok0)
                with self._lock:
                    self.stats.migrated_out += 1
                self._finish_slot(slot, "migrated", now)
                return
        self._maybe_finish(slot, tok0, now)

    def _seal_prefix(self, slot: _Slot, handle: RequestHandle,
                     hashes: list[str], depth: int) -> None:
        """Copy the slot's complete blocks past the matched depth into pool
        pages and index them. When every page is pinned or interior the
        rest is not sealed: reuse degrades, correctness never."""
        pool = self.kv_pool
        n_complete = min(len(handle.prompt) // pool.page_size,
                         pool.blocks_per_slot)
        if n_complete <= depth:
            return
        table = torch.full((pool.blocks_per_slot,), kvc.SCRATCH_PAGE,
                           dtype=torch.long)
        parent = hashes[depth - 1] if depth else ""
        newly: list[str] = []
        for b in range(depth, n_complete):
            digest = hashes[b]
            if pool.has(digest):
                parent = digest
                continue
            pid = pool.allocate()
            if pid is None:
                break
            pool.register(parent, digest, pid, b + 1)
            # pinned until its bytes are sealed: allocate() for a later
            # block must not evict it and hand its page out twice
            pool.pin(digest)
            table[b] = pid
            newly.append(digest)
            parent = digest
        if newly:
            kvc.seal_pages(pool.pool, self._cache, table.to(self.device),
                           slot.index)
            for digest in newly:
                pool.unpin(digest)

    def _extract_migration(self, slot: _Slot, handle: RequestHandle,
                           tok0: int) -> dict:
        """Host copies of the slot's K/V rows [0, pos) and the sampler
        state a decode replica needs to continue where this admission
        stopped (tok0's own K/V is written by the first decode step, there
        as here)."""
        leaves = {name: arr[:, slot.index, :, :slot.pos].to("cpu")
                  .contiguous() for name, arr in self._cache.items()}
        meta = {"prompt": list(handle.prompt),
                "max_new_tokens": handle.max_new_tokens,
                "pos": int(slot.pos), "tok0": int(tok0), "emitted": 1}
        return {"meta": meta, "leaves": leaves}

    def _admit_migrated(self, slot: _Slot, handle: RequestHandle) -> None:
        """Install a migrated-in request: its rows zero-padded to the full
        budget, one `install_rows`, decode resumed at pos. tok0 was already
        streamed to the client by the prefill replica: it is not pushed
        again; it is the next decode step's input."""
        t_dequeue = time.monotonic()
        handle.queue_wait_s = t_dequeue - handle.submitted_at
        handle.migrated_in = True
        install, handle.install = handle.install, None
        pos = install["pos"]
        rows = {}
        for name, arr in self._cache.items():
            l, _, h, s, d = arr.shape
            full = torch.zeros((l, 1, h, s, d), dtype=arr.dtype,
                               device=self.device)
            full[:, 0, :, :pos] = install["leaves"][name].to(self.device)
            rows[name] = full
        kvc.install_rows(self._cache, rows, slot.index)
        now = time.monotonic()
        handle.prefill_s = now - t_dequeue
        handle.admitted_at = now
        slot.handle = handle
        slot.pos = pos
        slot.emitted = install["emitted"]
        slot.last_emit_at = now
        self._pos_np[slot.index] = pos
        self._tokens_np[slot.index] = install["tok0"]
        with self._lock:
            self.stats.queue_wait_s.append(handle.queue_wait_s)
            self.stats.prefill_s.append(handle.prefill_s)
            self.stats.migrated_in += 1
        LOG.debug("installed migrated request %d into slot %d (pos %d)",
                  handle.request_id, slot.index, pos)
        if slot.emitted >= handle.max_new_tokens:
            self._finish_slot(slot, "length", now)

    def _maybe_finish(self, slot: _Slot, token: int, now: float) -> None:
        """Per-slot eos/length latch + immediate slot recycling."""
        reason = None
        if self.eos_id is not None and token == self.eos_id:
            reason = "eos"
        elif slot.emitted >= slot.handle.max_new_tokens:
            reason = "length"
        if reason is not None:
            self._finish_slot(slot, reason, now)

    def _finish_slot(self, slot: _Slot, reason: str, now: float) -> None:
        """Free a slot (eos/length latch, or a cancelled request) and
        recycle it immediately."""
        handle, slot.handle = slot.handle, None
        # park the freed slot's decode writes at the last budget row:
        # always masked for the next occupant until its own decode
        # overwrites it
        slot.pos = self.token_budget - 1
        self._pos_np[slot.index] = slot.pos
        handle._finish(reason, now)
        with self._lock:
            self.stats.requests_finished += 1
        sink = self.on_request_finished
        if sink is not None:
            try:
                sink(handle)
            except Exception:  # noqa: BLE001 — observability never wedges
                LOG.debug("request-finished hook failed", exc_info=True)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-engine", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        # a wedged loop hangs every in-flight request; the cadence is one
        # idle backstop tick, so the watchdog sees it quickly
        beacon = register_beacon("serve-engine", 1.0)
        while not self._stop.is_set():
            beacon.beat()
            try:
                busy = self.step()
            except Exception:  # noqa: BLE001 — a poisoned step must not
                LOG.exception("engine step failed")    # wedge the server
                busy = False
            if not busy:
                self._work.wait(timeout=0.02)
                self._work.clear()
        beacon.idle()

    def stop(self) -> None:
        """Stop the loop and fail outstanding work (pending AND in-flight)
        with finish_reason='shutdown' so no caller blocks forever."""
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        now = time.monotonic()
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
            self._pending_tokens = 0
        for handle in pending:
            handle._finish("shutdown", now)
        for slot in self._slots:
            if slot.active:
                handle, slot.handle = slot.handle, None
                handle._finish("shutdown", now)

    # -- observability --------------------------------------------------
    def snapshot(self) -> dict:
        """Serving gauges for /v1/metrics: TTFT, inter-token latency, queue
        depth, slot occupancy, tokens/sec, and the device work counts."""
        with self._lock:
            active = sum(1 for s in self._slots if s.active)
            depth = len(self._pending)
            elapsed = max(time.monotonic() - self.stats.started_at, 1e-9)
            snap = {
                "tokens_emitted": self.stats.tokens_emitted,
                "requests_finished": self.stats.requests_finished,
                "requests_submitted": self.stats.requests_submitted,
                "requests_rejected": self.stats.requests_rejected,
                "admissions": self.stats.admissions,
                "decode_steps": self.stats.decode_steps,
                "tokens_per_sec": self.stats.tokens_emitted / elapsed,
                "queue_depth": depth,
                "queue_depth_max": self.stats.queue_depth_max,
                "active_slots": active,
                "n_slots": self.n_slots,
                "slot_occupancy_pct": 100.0 * active / self.n_slots,
                "ttft_p50_s": _percentile(self.stats.ttft_s, 0.50),
                "ttft_p95_s": _percentile(self.stats.ttft_s, 0.95),
                "itl_p50_ms": None,
                "token_budget": self.token_budget,
                "draining": self._draining.is_set(),
                "weights_generation": self.weights_generation,
                "role": self.role,
                "migrated_out_total": self.stats.migrated_out,
                "migrated_in_total": self.stats.migrated_in,
                "device": str(self.device),
            }
            if self.kv_pool is not None:
                snap.update(self.kv_pool.stats_fields())
            itl = _percentile(self.stats.itl_s, 0.50)
            if itl is not None:
                snap["itl_p50_ms"] = itl * 1000.0
            _phase_percentiles(snap, "queue_wait_s",
                               self.stats.queue_wait_s)
            _phase_percentiles(snap, "prefill_s", self.stats.prefill_s)
            _phase_percentiles(snap, "decode_ms_per_token",
                               self.stats.itl_s, scale=1000.0)
            return snap

    def metrics(self) -> list[dict]:
        """snapshot() as metric dicts ({name, value}), the shape the JAX
        package's metrics reporter pushes to the AM."""
        names = {
            "tokens_per_sec": "SERVING_TOKENS_PER_SEC",
            "queue_depth": "SERVING_QUEUE_DEPTH",
            "slot_occupancy_pct": "SERVING_SLOT_OCCUPANCY_PCT",
            "ttft_p50_s": "SERVING_TTFT_P50_S",
            "ttft_p95_s": "SERVING_TTFT_P95_S",
            "itl_p50_ms": "SERVING_ITL_P50_MS",
            "tokens_emitted": "SERVING_TOKENS_TOTAL",
            "requests_submitted": "SERVING_SUBMITTED_TOTAL",
            "requests_rejected": "SERVING_REJECTED_TOTAL",
            "queue_wait_s_p50": "SERVING_QUEUE_WAIT_P50_S",
            "queue_wait_s_p95": "SERVING_QUEUE_WAIT_P95_S",
            "prefill_s_p50": "SERVING_PREFILL_P50_S",
            "prefill_s_p95": "SERVING_PREFILL_P95_S",
            "decode_ms_per_token_p50": "SERVING_DECODE_P50_MS",
            "decode_ms_per_token_p95": "SERVING_DECODE_P95_MS",
            # paged-KV reuse and disaggregation (absent with sharing off:
            # filtered below)
            "kv_hit_total": "SERVING_KV_HIT_TOTAL",
            "kv_miss_total": "SERVING_KV_MISS_TOTAL",
            "kv_evict_total": "SERVING_KV_EVICT_TOTAL",
            "kv_occupancy_pct": "SERVING_KV_OCCUPANCY_PCT",
            "kv_hit_rate_pct": "SERVING_KV_HIT_RATE_PCT",
            "migrated_out_total": "SERVING_MIGRATED_OUT_TOTAL",
            "migrated_in_total": "SERVING_MIGRATED_IN_TOTAL",
        }
        snap = self.snapshot()
        return [{"name": metric, "value": float(snap[key])}
                for key, metric in names.items()
                if snap.get(key) is not None]
