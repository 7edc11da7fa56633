"""Token-shard data: random-crop training batches from a raw int32 shard.

Counterpart of `tony_tpu/train/native_data.py`. A shard is raw
little-endian int32 tokens (`write_token_file`, the same bytes);
`token_batches(path, batch, seq, seed)` yields {'tokens': (B, S+1)} int32
windows, each a contiguous crop at a random start. Two streams, each
equal bit for bit to its JAX counterpart for the same seed:

- ``prefer_native=True`` (the default): the stream of the JAX package's
  native loader (`src/native/tony_dataload.cc`): each window start is
  xorshift64* seeded ``seed * 0x9E3779B97F4A7C15 + 1``, reduced
  ``% (max_start + 1)``. The port draws it in Python with uint64 masking,
  on a background thread that keeps the next batch ready in a double
  buffer, as the C++ worker does: a batch is B draws and B memcpys of
  S+1 tokens from the memory-mapped shard, which Python issues in well
  under a millisecond at B4 x S4096, so no native build is needed.
- ``prefer_native=False``: JAX's numpy fallback, ``np.random.
  default_rng(seed).integers(0, max_start + 1, batch)`` per batch.

A shard shorter than ``seq + 1`` tokens raises ValueError.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Iterator

import numpy as np

LOG = logging.getLogger(__name__)

_MASK = (1 << 64) - 1
_SEED_MUL = 0x9E3779B97F4A7C15
_OUT_MUL = 0x2545F4914F6CDD1D
_DEPTH = 2          # batches ready ahead of the consumer (a double buffer)


def write_token_file(path: str, tokens: np.ndarray) -> str:
    """Write `tokens` as a raw int32 shard (atomically, via a .tmp)."""
    arr = np.ascontiguousarray(tokens, dtype=np.int32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        arr.tofile(f)
    os.replace(tmp, path)
    return path


def _open_shard(path: str, seq: int) -> np.ndarray:
    tokens = np.memmap(path, dtype=np.int32, mode="r")
    row = seq + 1
    if len(tokens) < row:
        raise ValueError(f"{path}: {len(tokens)} tokens < seq+1={row}")
    return tokens


def _numpy_batches(path: str, batch: int, seq: int, seed: int
                   ) -> Iterator[dict[str, np.ndarray]]:
    """JAX's numpy stream: default_rng(seed) window starts."""
    tokens = _open_shard(path, seq)
    row = seq + 1
    rng = np.random.default_rng(seed)
    max_start = len(tokens) - row
    while True:
        starts = rng.integers(0, max_start + 1, batch)
        out = np.stack([tokens[s:s + row] for s in starts])
        yield {"tokens": np.ascontiguousarray(out, np.int32)}


class XorShiftStarts:
    """The native loader's window starts: xorshift64* over a uint64
    state seeded ``seed * 0x9E3779B97F4A7C15 + 1`` (mod 2^64)."""

    def __init__(self, seed: int, n_starts: int):
        self.state = (int(seed) * _SEED_MUL + 1) & _MASK
        self.n_starts = int(n_starts)

    def next(self) -> int:
        x = self.state
        x ^= x >> 12
        x ^= (x << 25) & _MASK
        x ^= x >> 27
        self.state = x
        return ((x * _OUT_MUL) & _MASK) % self.n_starts


class ShardLoader:
    """The native loader's stream on a background thread: the worker
    fills up to `_DEPTH` batches ahead; `next()` hands one over. `close()`
    stops the thread (a daemon: it never holds the process open)."""

    def __init__(self, path: str, batch: int, seq: int, seed: int):
        if batch <= 0 or seq <= 0:
            raise ValueError(f"batch {batch} and seq {seq} must be > 0")
        self._tokens = _open_shard(path, seq)
        self._batch, self._row = batch, seq + 1
        self._starts = XorShiftStarts(seed, len(self._tokens) - self._row + 1)
        self._ready: queue.Queue = queue.Queue(maxsize=_DEPTH)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._fill,
                                        name="tony-shard-loader",
                                        daemon=True)
        self._worker.start()

    def _batch_at(self) -> np.ndarray:
        out = np.empty((self._batch, self._row), np.int32)
        for b in range(self._batch):
            s = self._starts.next()
            out[b] = self._tokens[s:s + self._row]
        return out

    def _fill(self) -> None:
        try:
            while not self._stop.is_set():
                batch = self._batch_at()
                while not self._stop.is_set():
                    try:
                        self._ready.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._ready.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._stop.is_set():
            raise StopIteration
        item = self._ready.get()
        if isinstance(item, BaseException):
            raise RuntimeError("shard loader failed") from item
        return {"tokens": item}

    def close(self) -> None:
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def token_batches(path: str, batch: int, seq: int, seed: int = 0,
                  prefer_native: bool = True
                  ) -> Iterator[dict[str, np.ndarray]]:
    """Infinite {'tokens': (batch, seq+1)} stream from a token shard: the
    native loader's stream on a prefetch thread, or JAX's numpy stream."""
    if prefer_native:
        loader = ShardLoader(path, batch, seq, seed)
        LOG.info("prefetching shard loader active: %s (double-buffer "
                 "thread, seed %d)", path, seed)
        return loader
    return _numpy_batches(path, batch, seq, seed)
