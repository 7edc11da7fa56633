"""Step-keyed checkpoints in the JAX package's on-disk layout.

Counterpart of `tony_tpu/train/checkpoint.py`, for one process. A
checkpoint written by either package reads back in the other:

- `step_<N>.tmp/` is written, then renamed to `step_<N>/` in one
  `os.replace`: a save that dies half way leaves a `.tmp` directory that
  `latest_step` and `committed_steps` never see.
- `index.json` holds `{"leaves": [{"shape", "dtype"[, "py"]}]}`, one entry
  per leaf in the order `jax.tree.flatten` gives the state: dict keys
  sorted, a namedtuple's fields and a tuple's items in order (the optax
  layout of `train/optim.py`). `"py"` marks a plain Python number, such as
  the trainer's `step`.
- `manifest_p0.json` lists each shard file with the global index region it
  covers; `shards/leaf_{i}.p0_{k}.npy` holds the data (`p0_full` for a
  Python number). One device writes one shard per tensor leaf (`p0_0`).
- bf16 has no numpy dtype here: a bf16 shard is written and read by its
  bits, under the header the JAX package's `np.save` gives an
  `ml_dtypes.bfloat16` array (`'<V2'`), and `index.json` says "bfloat16".
- `tree.json` (the key path of every leaf) takes the place of the JAX
  package's `tree.pkl`, a pickled jax treedef that cannot be read without
  jax. It is what `restore_checkpoint(..., template=None)` rebuilds the
  tree from, so a JAX-written checkpoint (only `tree.pkl`) is restored
  through a template.

Restore reads shard files mmap-backed and pastes the regions each leaf
needs, so a JAX checkpoint written from a sharded mesh (several shard
files per leaf) assembles into whole tensors. With a template, each leaf
is copied in place into the template's tensor on its device, one leaf at a
time: the state is never held twice on the host.

`AsyncCheckpointer` takes the snapshot synchronously (the train step
updates parameters and moments in place, so the copy must be complete
before the next step runs: every device-to-host copy is issued into
pinned buffers before one wait) and writes the files on a thread; at most
one save is in flight.

A `gs://` directory raises NotImplementedError: the object-store protocol
comes with the port's orchestrator slice (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

LOG = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")
_TREE_FILE = "tree.json"
_INDEX_FILE = "index.json"
_MANIFEST_RE = re.compile(r"^manifest_p(\d+)\.json$")
# the header descr the JAX package's np.save gives an ml_dtypes.bfloat16
# array (numpy's own 2-byte void would be '|V2')
_BF16_DESCR = "<V2"


def _check_local(ckpt_dir: str) -> None:
    if ckpt_dir.startswith("gs://"):
        raise NotImplementedError(
            f"{ckpt_dir}: gs:// checkpoint directories are not ported to "
            f"tony_tpu_torch yet; the object-store protocol arrives with "
            f"ROADMAP queue 1 item 4 (the port in the orchestrator)")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _children(node) -> Optional[list[tuple[str, Any]]]:
    """(key, child) pairs of a container in jax's flatten order, or None
    for a leaf: dicts by sorted key, namedtuples by field, tuples and
    lists by position."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree) -> list[tuple[tuple[str, ...], Any]]:
    """[(key path, leaf)] in jax's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    return [((key,) + path, leaf) for key, child in kids
            for path, leaf in flatten_with_paths(child)]


def _rebuild(template, leaves) -> Any:
    """`template`'s structure with its leaves, in flatten order, replaced
    from the iterator `leaves`."""
    if isinstance(template, dict):
        new = {k: None for k in template}
        for k in sorted(template):
            new[k] = _rebuild(template[k], leaves)
        return new
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _unflatten_paths(paths: list[list[str]], leaves: list) -> dict:
    """Nested dicts keyed by the path components (a tuple or namedtuple
    comes back as a dict keyed by its positions or fields)."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return root


# ---------------------------------------------------------------------------
# dtypes and .npy files
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf of dtype `name` is held in on the host:
    bf16 by its bits as int16."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _write_npy(path: str, data) -> None:
    """np.save's bytes for `data` (a CPU tensor or a numpy array); a bf16
    tensor under the header of an ml_dtypes.bfloat16 array."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bfloat16:
            arr, descr = data.view(torch.int16).numpy(), _BF16_DESCR
        else:
            arr = data.numpy()
            descr = np.lib.format.dtype_to_descr(arr.dtype)
    else:
        arr = np.asarray(data)
        descr = np.lib.format.dtype_to_descr(arr.dtype)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.data)


def _load_npy(path: str, storage: np.dtype, mmap: bool) -> np.ndarray:
    """A shard file as `storage` (a bf16 shard's '<V2' viewed as int16).
    mmap: copy-on-write map, so the array is writable (torch.from_numpy
    takes it) and the file is never written."""
    data = np.load(path, mmap_mode="c" if mmap else None)
    if data.dtype != storage:
        if data.dtype.kind != "V" or data.dtype.itemsize != storage.itemsize:
            raise ValueError(f"{path}: dtype {data.dtype}, the index says "
                             f"{storage}")
        data = data.view(storage)
    return data


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _snapshot(state: Any, buffers: Optional[dict] = None):
    """The state on the host, complete when this returns: every
    device-to-host copy is issued (into pinned buffers, reused from
    `buffers` where shape and dtype still match) before one wait, and a
    CPU tensor is cloned, since the next step updates it in place.
    Returns (paths, metas, records), each record (leaf index, shard file,
    index region, host data)."""
    leaves = flatten_with_paths(state)
    metas, records, synced = [], [], set()
    for i, (_, leaf) in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            src = leaf.detach()
            if src.device.type == "cuda":
                host = None if buffers is None else buffers.get(i)
                if (host is None or host.shape != src.shape
                        or host.dtype != src.dtype):
                    host = torch.empty(src.shape, dtype=src.dtype,
                                       pin_memory=True)
                    if buffers is not None:
                        buffers[i] = host
                host.copy_(src, non_blocking=True)
                synced.add(src.device)
            else:
                host = src.clone()
            metas.append({"shape": list(src.shape),
                          "dtype": _dtype_name(src.dtype)})
            records.append((i, f"leaf_{i}.p0_0.npy",
                            [[0, d] for d in src.shape], host))
        else:
            arr = np.asarray(leaf)
            metas.append({"shape": list(arr.shape), "dtype": str(arr.dtype),
                          "py": not isinstance(leaf, np.ndarray)})
            records.append((i, f"leaf_{i}.p0_full.npy",
                            [[0, d] for d in arr.shape], arr))
    for device in synced:
        torch.cuda.synchronize(device)
    return [list(path) for path, _ in leaves], metas, records


def _write_snapshot(ckpt_dir: str, step: int, paths, metas,
                    records) -> str:
    """File IO, then the atomic rename (safe on a background thread)."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "shards"))
    manifest: dict[str, Any] = {"process": 0, "shards": []}
    for i, fname, index_spec, data in records:
        _write_npy(os.path.join(tmp, "shards", fname), data)
        manifest["shards"].append({"leaf": i, "file": fname,
                                   "index": index_spec})
    for name, obj in (("manifest_p0.json", manifest),
                      (_INDEX_FILE, {"leaves": metas}),
                      (_TREE_FILE, {"paths": paths})):
        with open(os.path.join(tmp, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _write_and_prune(ckpt_dir: str, step: int, snapshot, keep: int = 0,
                     pinned: Optional[int] = None) -> str:
    final = _write_snapshot(ckpt_dir, step, *snapshot)
    # the step just written is always kept, so a failed prune can never
    # undo the commit that triggered it
    if keep > 0:
        try:
            prune_checkpoints(ckpt_dir, keep, pinned=pinned)
        except Exception:  # noqa: BLE001 — GC must never fail a commit
            LOG.exception("checkpoint retention prune failed under %s",
                          ckpt_dir)
    return final


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 0,
                    pinned: Optional[int] = None) -> str:
    """Write `state` (nested dicts, tuples and namedtuples of tensors and
    Python numbers) as step `step`; returns the step's directory.

    keep > 0 prunes older committed steps down to the newest `keep` after
    the commit; `pinned` names a step kept regardless of age (the step the
    current run restored from)."""
    _check_local(ckpt_dir)
    return _write_and_prune(ckpt_dir, step, _snapshot(state), keep=keep,
                            pinned=pinned)


def committed_steps(ckpt_dir: str) -> list[int]:
    """Every complete checkpoint step, ascending."""
    _check_local(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(name)))


def prune_checkpoints(ckpt_dir: str, keep: int,
                      pinned: Optional[int] = None) -> list[int]:
    """Delete committed `step_N` directories beyond the newest `keep`,
    oldest first, never `pinned`. Returns the pruned steps."""
    if keep <= 0:
        return []
    steps = committed_steps(ckpt_dir)
    victims = [s for s in steps[:-keep] if s != pinned] \
        if len(steps) > keep else []
    for step in victims:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{step}"),
                      ignore_errors=True)
    if victims:
        LOG.info("checkpoint GC pruned step(s) %s (keep=%d%s)", victims,
                 keep, f", pinned={pinned}" if pinned is not None else "")
    return victims


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint step, or None."""
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def _load_manifests(path: str) -> dict[int, list[dict]]:
    """leaf index -> shard records (file + global index region)."""
    by_leaf: dict[int, list[dict]] = {}
    for name in os.listdir(path):
        if not _MANIFEST_RE.match(name):
            continue
        with open(os.path.join(path, name), "r", encoding="utf-8") as f:
            manifest = json.load(f)
        for rec in manifest["shards"]:
            by_leaf.setdefault(rec["leaf"], []).append(rec)
    return by_leaf


def _paste_region(out: np.ndarray, out_index: tuple, path: str,
                  rec: dict) -> int:
    """Copy the overlap of a shard file and the region `out_index` (which
    `out` covers exactly) into `out`, reading only the overlapping part
    (mmap). Returns the number of elements pasted."""
    saved = tuple(slice(a, b) for a, b in rec["index"])
    if not saved:                       # scalar leaf
        out[...] = _load_npy(path, out.dtype, mmap=False)
        return 1
    src_sl, dst_sl = [], []
    for o_sl, s_sl in zip(out_index, saved):
        lo = max(o_sl.start, s_sl.start)
        hi = min(o_sl.stop, s_sl.stop)
        if hi <= lo:
            return 0                    # no overlap on this dim
        src_sl.append(slice(lo - s_sl.start, hi - s_sl.start))
        dst_sl.append(slice(lo - o_sl.start, hi - o_sl.start))
    data = _load_npy(path, out.dtype, mmap=True)
    out[tuple(dst_sl)] = data[tuple(src_sl)]
    return math.prod(sl.stop - sl.start for sl in dst_sl)


def _read_leaf(i: int, meta: dict, records: list[dict],
               shards_dir: str) -> np.ndarray:
    """Leaf `i` whole, in its storage dtype. A leaf saved as one file
    covering all of it comes back as that file's copy-on-write map; one
    saved in shards is pasted region by region into a new array, which
    must be covered exactly."""
    dims = list(meta["shape"])
    storage = _storage_dtype(meta["dtype"])
    whole = [[0, d] for d in dims]
    if len(records) == 1 and records[0]["index"] == whole:
        return _load_npy(os.path.join(shards_dir, records[0]["file"]),
                         storage, mmap=bool(dims))
    target = tuple(slice(0, d) for d in dims)
    out = np.empty(dims, storage)
    pasted = sum(_paste_region(out, target,
                               os.path.join(shards_dir, rec["file"]), rec)
                 for rec in records)
    if pasted != math.prod(dims):
        raise ValueError(f"leaf {i}: its shard files cover {pasted} of "
                         f"{math.prod(dims)} elements")
    return out


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _python_or_tensor(arr: np.ndarray, meta: dict):
    if meta.get("py") and arr.ndim == 0:
        return arr.item()
    return _as_tensor(np.array(arr), meta["dtype"])


def _open_step(ckpt_dir: str, step: Optional[int]):
    _check_local(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, _INDEX_FILE), "r", encoding="utf-8") as f:
        metas = json.load(f)["leaves"]
    tree_path = os.path.join(path, _TREE_FILE)
    paths = None
    if os.path.exists(tree_path):
        with open(tree_path, "r", encoding="utf-8") as f:
            paths = [tuple(p) for p in json.load(f)["paths"]]
    return path, metas, paths, _load_manifests(path)


@torch.no_grad()
def _fill(ref: torch.Tensor, i: int, meta: dict, by_leaf, shards_dir: str,
          where: str) -> None:
    """Copy leaf `i` into the tensor `ref`, in place, on its device."""
    if (list(ref.shape) != list(meta["shape"])
            or _dtype_name(ref.dtype) != meta["dtype"]):
        raise ValueError(
            f"{where}: the checkpoint has {meta['dtype']} "
            f"{meta['shape']}, the template {_dtype_name(ref.dtype)} "
            f"{list(ref.shape)}")
    arr = _read_leaf(i, meta, by_leaf.get(i, []), shards_dir)
    ref.copy_(_as_tensor(arr, meta["dtype"]))


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       template: Any = None) -> Any:
    """Read a checkpoint back (the latest step when `step` is None).

    template=None: nested dicts keyed by `tree.json`'s key paths, with CPU
    tensors (Python numbers where the leaf was one). A checkpoint the JAX
    package wrote has no `tree.json` and needs a template.

    template: a state of the same tree. Each tensor leaf is filled in
    place (`copy_`, on its device) and the template's structure is
    returned with its tensors and the checkpoint's Python numbers."""
    path, metas, paths, by_leaf = _open_step(ckpt_dir, step)
    shards_dir = os.path.join(path, "shards")
    if template is None:
        if paths is None:
            raise ValueError(
                f"{path} has no {_TREE_FILE} (a checkpoint of the JAX "
                f"package, which pickles its tree): restore it with a "
                f"template")
        leaves = [_python_or_tensor(
            _read_leaf(i, meta, by_leaf.get(i, []), shards_dir), meta)
            for i, meta in enumerate(metas)]
        return _unflatten_paths([list(p) for p in paths], leaves)
    t_leaves = flatten_with_paths(template)
    if len(t_leaves) != len(metas):
        raise ValueError(f"template has {len(t_leaves)} leaves, checkpoint "
                         f"{path} {len(metas)}")
    if paths is not None:
        for (t_path, _), c_path in zip(t_leaves, paths):
            if t_path != c_path:
                raise ValueError(f"template leaf {'/'.join(t_path)} where "
                                 f"{path} has {'/'.join(c_path)}")
    out = []
    for i, ((t_path, ref), meta) in enumerate(zip(t_leaves, metas)):
        if isinstance(ref, torch.Tensor):
            _fill(ref, i, meta, by_leaf, shards_dir,
                  f"{path} leaf {i} ({'/'.join(t_path)})")
            out.append(ref)
        else:
            out.append(_python_or_tensor(
                _read_leaf(i, meta, by_leaf.get(i, []), shards_dir), meta))
    return _rebuild(template, iter(out))


def trainer_state(params: Any, opt_state: Any, step: int) -> dict:
    """What a trainer checkpoint holds, as the JAX Trainer saves it. Its
    keys flatten sorted: opt_state..., params..., step."""
    return {"params": params, "opt_state": opt_state, "step": step}


def restore_params(ckpt_dir: str, step: Optional[int],
                   template: Any) -> Any:
    """Only the `params` subtree of a trainer checkpoint
    (`trainer_state`), into `template` (a parameter tree of tensors,
    filled in place), whatever optimizer state lies beside it. With a
    `tree.json` the leaves under `params` are picked by path; a JAX
    checkpoint has none, but its trainer state flattens as
    opt_state..., params..., step, so the params are the leaves just
    before the last, and their shapes and dtypes are checked against the
    template."""
    path, metas, paths, by_leaf = _open_step(ckpt_dir, step)
    shards_dir = os.path.join(path, "shards")
    t_leaves = flatten_with_paths(template)
    n = len(t_leaves)
    if paths is not None:
        index = [i for i, p in enumerate(paths) if p[:1] == ("params",)]
        found = [paths[i][1:] for i in index]
        if found != [p for p, _ in t_leaves]:
            raise ValueError(f"{path}: its params {found} are not the "
                             f"template's {[p for p, _ in t_leaves]}")
    else:
        if len(metas) < n + 1:
            raise ValueError(f"{path} has {len(metas)} leaves, fewer than "
                             f"the template's {n} params and a step")
        index = list(range(len(metas) - 1 - n, len(metas) - 1))
    for i, (t_path, ref) in zip(index, t_leaves):
        _fill(ref, i, metas[i], by_leaf, shards_dir,
              f"{path} leaf {i} (params/{'/'.join(t_path)})")
    return template


# ---------------------------------------------------------------------------
# async save
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Overlap checkpoint file IO with training.

    `save(step, state)` snapshots the state into pinned host buffers
    synchronously (the next step updates the tensors in place) and writes
    the files on a background thread. At most one save is in flight: the
    next `save` waits for the previous commit first, which also frees its
    buffers for reuse. Call `wait()` before reading `latest_step` and
    `close()` at the end."""

    def __init__(self, ckpt_dir: str, keep: int = 0,
                 pinned: Optional[int] = None):
        _check_local(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.pinned = pinned
        self.last_step: Optional[int] = None
        self._buffers: dict[int, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        snapshot = _snapshot(state, self._buffers)

        def work():
            try:
                _write_and_prune(self.ckpt_dir, step, snapshot,
                                 keep=self.keep, pinned=self.pinned)
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                self._error = e
                LOG.exception("async checkpoint step %d failed", step)

        self.last_step = step
        self._thread = threading.Thread(target=work, name=f"ckpt-{step}",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from err

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._buffers.clear()
