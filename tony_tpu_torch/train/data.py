"""Training data: the synthetic token stream and the overlapped device
prefetcher.

Counterpart of `tony_tpu/train/data.py`:

- `synthetic_tokens` is a numpy copy, bit-identical to the JAX package's
  for a given (seed, process_index): the same generator, the same draw
  order and the same closed-form affine prefix scan.
- `PrefetchIterator` keeps the JAX package's contracts (order, bounded
  depth, clean `close()`, `.leftover`, producer errors re-raised on
  `next()`, `stall_s`/`batches`). Its default transfer is
  `device_put_batch`: on a card, each array is copied into pinned host
  memory and then to the device with `non_blocking=True` on a side
  stream, and an event recorded after the copies is what the consumer's
  stream waits on when the batch is handed out. PyTorch's pinned-memory
  allocator records each non-blocking copy on its block, so a pinned
  buffer is not reused before its copy ends.

Single process only: the multi-host global-array assembly waits for the
parallel slice, and the `tony_prefetch_stall_seconds_total` registry
counter for the observability slice.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

LOG = logging.getLogger(__name__)


def _affine_prefix_tokens(first: np.ndarray, noise: np.ndarray,
                          vocab_size: int) -> np.ndarray:
    """Exact vectorized evaluation of the token recurrence
    ``toks[:, t+1] = (3*toks[:, t] + noise[:, t]) % vocab_size``.

    Each step is the affine map f_t(x) = (3x + n_t) mod V; the prefix
    composition is itself affine (A_t, B_t), so toks[:, t] =
    (A_t * toks[:, 0] + B_t) mod V. A doubling scan composes all prefixes
    in ceil(log2(S)) vectorized rounds; int64 intermediates and a mod after
    every round keep it exact."""
    b, s = noise.shape
    v = int(vocab_size)
    a = np.full((b, s), 3 % v, dtype=np.int64)
    acc = noise.astype(np.int64) % v
    shift = 1
    while shift < s:
        hi = a[:, shift:]
        acc[:, shift:] = (hi * acc[:, :-shift] + acc[:, shift:]) % v
        a[:, shift:] = (hi * a[:, :-shift]) % v
        shift *= 2
    toks = np.empty((b, s + 1), np.int32)
    toks[:, 0] = first
    toks[:, 1:] = (a * first.astype(np.int64)[:, None] + acc) % v
    return toks


def synthetic_tokens(batch_size: int, seq_len: int, vocab_size: int,
                     seed: int = 0, process_index: int = 0
                     ) -> Iterator[dict[str, np.ndarray]]:
    """Markov-ish token stream: next token = (3*tok + noise) % vocab, so a
    language model can reduce loss well below uniform. Yields
    {'tokens': (batch_size, seq_len + 1) int32} numpy arrays."""
    rng = np.random.default_rng(seed * 1_000_003 + process_index)
    while True:
        first = rng.integers(0, vocab_size, batch_size)
        noise = rng.integers(0, 2, (batch_size, seq_len))
        yield {"tokens": _affine_prefix_tokens(first, noise, vocab_size)}


class DeviceBatch(dict):
    """A batch of device tensors and, for a card, the event recorded after
    their copies (`ready`), on the side stream that made them."""

    ready: Optional[torch.cuda.Event] = None


def side_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """The stream a card's transfers run on; None for the CPU."""
    return torch.cuda.Stream(device=device) if device.type == "cuda" \
        else None


def device_put_batch(batch: dict, device: torch.device | str,
                     stream: Optional[torch.cuda.Stream] = None
                     ) -> DeviceBatch:
    """Transfer ONE host batch to `device`. On a card: pinned host copy,
    then a non-blocking copy on `stream` (a side stream), then an event
    (`ready`) that the consumer waits on (`hand_over`). On the CPU:
    tensors that share the numpy arrays' memory."""
    device = torch.device(device)
    out = DeviceBatch()
    if device.type != "cuda":
        for k, v in batch.items():
            out[k] = torch.as_tensor(np.asarray(v), device=device)
        return out
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            out[k] = host.to(device, non_blocking=True)
        out.ready = torch.cuda.Event()
        out.ready.record(stream)
    return out


def hand_over(batch: Any) -> Any:
    """Make the current stream wait for a DeviceBatch's copies and tell
    the allocator the tensors are used there; a no-op for anything else."""
    ready = getattr(batch, "ready", None)
    if ready is not None:
        current = torch.cuda.current_stream()
        current.wait_event(ready)
        for t in batch.values():
            t.record_stream(current)
        batch.ready = None
    return batch


def global_batch_iterator(local_iter: Iterator[dict],
                          device: torch.device | str = "cuda"
                          ) -> Iterator[dict]:
    """Synchronous reference path: one batch at a time, transferred on the
    caller's thread. PrefetchIterator is the overlapped equivalent."""
    device = torch.device(device)
    stream = side_stream(device)
    for batch in local_iter:
        yield hand_over(device_put_batch(batch, device, stream))


_DONE = object()


class PrefetchIterator:
    """Overlapped input pipeline: a background thread pulls host batches
    from `local_iter`, transfers each (`device_put_batch` by default), and
    keeps up to `depth` transferred batches queued.

    Contracts (as the JAX package's, tests/test_torch_train.py):
      - **Determinism**: the single producer consumes `local_iter` strictly
        in order.
      - **Bounded**: at most `depth` batches are queued; the producer
        blocks when the queue is full (device residency is up to depth+1
        batches: the queue plus the in-flight transfer).
      - **Clean shutdown**: `close()` (or context-manager exit) stops and
        joins the producer, even mid-put.
      - **No lost batches**: batches pulled from the source but never
        yielded are kept in order on `.leftover` after `close()`; a
        successor built with ``initial=old.leftover`` resumes the stream
        with no gap.
      - **Error transparency**: a producer-side exception is re-raised on
        the consumer's next `next()`.

    `stall_s` accumulates the time the consumer spent blocked in `next()`
    and `batches` counts yields.
    """

    def __init__(self, local_iter: Iterator[dict],
                 device: torch.device | str = "cuda", depth: int = 2,
                 transfer: Optional[Callable[[dict], Any]] = None,
                 initial: Any = ()):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the producer thread binds to the consumer's card
            self.device = torch.device("cuda", torch.cuda.current_device())
        if transfer is None:
            stream = side_stream(self.device)
            transfer = lambda b: device_put_batch(  # noqa: E731
                b, self.device, stream)
        self._transfer = transfer
        self._local_iter = local_iter
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._closed = False
        self.stall_s = 0.0
        self.batches = 0
        self._initial: list = list(initial)
        self._spill: list = []    # producer's in-flight batch on close
        self.leftover: list = []  # populated by close(), in order
        self._thread = threading.Thread(
            target=self._produce, name="tony-torch-prefetch", daemon=True)
        self._thread.start()

    # -- producer ------------------------------------------------------
    def _produce(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            for batch in self._local_iter:
                item = self._transfer(batch)
                if not self._offer(item):
                    self._spill.append(item)
                    return
            self._offer(_DONE)
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._offer(e)

    def _offer(self, item) -> bool:
        """put() that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer ------------------------------------------------------
    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._initial:
            self.batches += 1
            return hand_over(self._initial.pop(0))
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._closed:
                    raise StopIteration from None
                if not self._thread.is_alive():
                    # the producer always enqueues a terminal item before
                    # exiting; look once more before concluding exhaustion
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        raise StopIteration from None
        self.stall_s += time.perf_counter() - t0
        if item is _DONE:
            self._closed = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._closed = True
            raise item
        self.batches += 1
        return hand_over(item)

    def stall_snapshot(self) -> tuple[float, int]:
        return self.stall_s, self.batches

    @property
    def closed(self) -> bool:
        return self._closed

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and join its thread. Idempotent. Undelivered
        batches (unserved `initial`, the queue, the in-flight one) are
        kept in order on `.leftover`."""
        self._closed = True
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
            if self._thread.is_alive():
                LOG.warning(
                    "prefetch producer did not exit within %.1fs; "
                    "leftover batches may be incomplete", timeout)
        kept, self._initial = self._initial, []
        try:
            while True:
                item = self._q.get_nowait()
                if item is not _DONE and not isinstance(item,
                                                        BaseException):
                    kept.append(item)
        except queue.Empty:
            pass
        kept.extend(self._spill)
        self._spill = []
        self.leftover.extend(kept)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close(timeout=0.2)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
