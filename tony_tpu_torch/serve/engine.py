"""Continuous-batching inference engine over the KV-cache decode core.

Counterpart of `tony_tpu/serve/engine.py` (prefix sharing off, role
"both"). Requests flow through fixed shapes:

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

Sampling: greedy (`temperature=0`) is the contract, equal to offline
greedy. Temperature/top-k/top-p are engine-wide settings; sampled streams
draw from one engine `torch.Generator` seeded with SAMPLING_SEED at
construction, in admission and step order.

Not in this slice: the int8 KV cache, prefix sharing and prefill/decode
disaggregation (the port's kvcache slice), and the profiler beacon on the
loop thread (the port's observability slice).
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
        # "eos" | "length" | "shutdown" | "cancelled"
        self.finish_reason: Optional[str] = None
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # time queued before a slot freed, and the admission prefill itself
        self.queue_wait_s: Optional[float] = None
        self.prefill_s: Optional[float] = None
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
                 eos_id: Optional[int] = None, weights_generation: int = 0):
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
        self._cache = empty_cache(config, n_slots, token_budget, self.device)
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
    def submit(self, prompt: list[int], max_new_tokens: int
               ) -> RequestHandle:
        """Enqueue a request. Raises BudgetExceededError when it can never
        fit a slot, QueueFullError when the bounded queue (or its token
        budget) is full, DrainingError while draining."""
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
            handle = RequestHandle(next(self._next_id), list(prompt),
                                   max_new_tokens)
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
        return {
            "queue_depth": len(self._pending),
            "slots_free": max(0, self.n_slots - active),
            "active_slots": active,
            "n_slots": self.n_slots,
            "draining": self._draining.is_set(),
            "weights_generation": self.weights_generation,
            "role": "both",
            "token_budget": self.token_budget,
        }

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
            self._admit(free, handle)
            admitted = True

    def _admit(self, slot: _Slot, handle: RequestHandle) -> None:
        # queue wait ends when a free slot dequeues the request; everything
        # until the first sampled token reaches the host is the prefill
        t_dequeue = time.monotonic()
        handle.queue_wait_s = t_dequeue - handle.submitted_at
        prompt = torch.tensor([handle.prompt], dtype=torch.long,
                              device=self.device)
        i = slot.index
        rows = {name: arr[:, i:i + 1] for name, arr in self._cache.items()}
        logits, _ = prefill(self.params, prompt, self.config,
                            self.token_budget, cache=rows)
        tok0 = int(_sample(logits, self.temperature, self.top_k,
                           self._generator, self.top_p)[0])
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
        LOG.debug("admitted request %d into slot %d (prompt %d, max_new "
                  "%d)", handle.request_id, i, len(handle.prompt),
                  handle.max_new_tokens)
        self._maybe_finish(slot, tok0, now)

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
        while not self._stop.is_set():
            try:
                busy = self.step()
            except Exception:  # noqa: BLE001 — a poisoned step must not
                LOG.exception("engine step failed")    # wedge the server
                busy = False
            if not busy:
                self._work.wait(timeout=0.02)
                self._work.clear()

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
                "role": "both",
                "device": str(self.device),
            }
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
        }
        snap = self.snapshot()
        return [{"name": metric, "value": float(snap[key])}
                for key, metric in names.items()
                if snap.get(key) is not None]
