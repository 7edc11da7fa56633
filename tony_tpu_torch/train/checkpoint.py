"""Step-keyed checkpoints in the JAX package's on-disk layout.

Counterpart of `tony_tpu/train/checkpoint.py`. A checkpoint written by
either package reads back in the other:

- `step_<N>.tmp/` is written, then renamed to `step_<N>/` in one
  `os.replace`: a save that dies half way leaves a `.tmp` directory that
  `latest_step` and `committed_steps` never see.
- `index.json` holds `{"leaves": [{"shape", "dtype"[, "py"]}]}`, one entry
  per leaf in the order `jax.tree.flatten` gives the state: dict keys
  sorted, a namedtuple's fields and a tuple's items in order (the optax
  layout of `train/optim.py`). `"py"` marks a plain Python number, such as
  the trainer's `step`.
- `manifest_p{rank}.json` lists each shard file with the global index
  region it covers; `shards/leaf_{i}.p{rank}_{k}.npy` holds the data
  (`p0_full` for a Python number). A plain tensor is one shard (`p0_0`,
  written by rank 0); a DTensor (under a mesh) is written by each rank
  that holds replica 0 of its local shard, as `p{rank}_0` with that
  shard's region.
- Under a gang of ranks every rank writes its own files into
  `step_<N>.tmp/` (rank 0 also the index and tree files), then all meet
  at a barrier and rank 0 makes the same atomic commit; on a store rank 0
  writes `COMMIT` with `"processes"` the world size. The barriers run on
  the caller's thread: `AsyncCheckpointer` writes the files on its
  thread and commits in `wait()`, so no collective ever runs beside the
  training step's.
- bf16 has no numpy dtype here: a bf16 shard is written and read by its
  bits, under the header the JAX package's `np.save` gives an
  `ml_dtypes.bfloat16` array (`'<V2'`), and `index.json` says "bfloat16".
- `tree.json` (the key path of every leaf) is what the port's
  `restore_checkpoint(..., template=None)` rebuilds the tree from, so a
  JAX-written checkpoint (only `tree.pkl`) is restored through a
  template.
- `tree.pkl`, beside it, is the JAX package's file: the pickled jax
  treedef its restore opens, with or without a template. Pickling a
  treedef needs jax, so `_treedef_pickle` writes the pickle's opcodes by
  hand, as jax 0.9.0's own pickler lays them out (a `PyTreeDef` rebuilt
  from jax's default registry and one tuple per node, in post-order), and
  names each optax state class by optax's module path.

Restore reads shard files mmap-backed and pastes the regions each leaf
needs, so a JAX checkpoint written from a sharded mesh (several shard
files per leaf) assembles into whole tensors. With a template, each leaf
is copied in place into the template's tensor on its device, one leaf at a
time: the state is never held twice on the host. A DTensor leaf of the
template takes only this rank's region, pasted from whatever shards
cover it, so a checkpoint restores onto another mesh (or onto one
process) as the JAX template restore does.

`AsyncCheckpointer` takes the snapshot synchronously (the train step
updates parameters and moments in place, so the copy must be complete
before the next step runs: every device-to-host copy is issued into
pinned buffers before one wait) and writes the files on a thread; at most
one save is in flight.

A `gs://` directory (for a fleet with no shared filesystem) holds the same
objects under `step_<N>/`, through the `gsutil` or `gcloud storage` CLI
(`tony_tpu_torch/storage/store.py`). An object store has no atomic rename,
so the protocol is the JAX package's: every file is uploaded, then a
`COMMIT` marker (`{"step": N, "processes": 1}`) last. A step counts only
once its marker landed, so a save that dies half way stays invisible;
retention deletes the marker first. Restore fetches the step's metadata
and exactly the manifests `COMMIT` names into a temporary cache, fetches
each shard on first touch, and removes the cache when it is done.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import struct
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from tony_tpu_torch.parallel.distributed import barrier, rank, world_size
from tony_tpu_torch.parallel.sharding import local_region

LOG = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")
_TREE_FILE = "tree.json"
_TREEDEF_FILE = "tree.pkl"
_INDEX_FILE = "index.json"
_COMMIT_FILE = "COMMIT"
_MANIFEST_RE = re.compile(r"^manifest_p(\d+)\.json$")
_COMMIT_KEY_RE = re.compile(r"^step_(\d+)/COMMIT$")
# the header descr the JAX package's np.save gives an ml_dtypes.bfloat16
# array (numpy's own 2-byte void would be '|V2')
_BF16_DESCR = "<V2"


def _is_store_path(path: str) -> bool:
    return path.startswith("gs://")


def _ckpt_store(base: str):
    from tony_tpu_torch.storage.store import GCSStore
    return GCSStore(base.rstrip("/"))


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _children(node) -> Optional[list[tuple[str, Any]]]:
    """(key, child) pairs of a container in jax's flatten order, or None
    for a leaf: dicts by sorted key, namedtuples by field, tuples and
    lists by position; None is a node without children, as in jax."""
    if node is None:
        return []
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
    if template is None:
        return None
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


# jax 0.9.0's pickled treedef: `PyTreeDef()` from this class, then its
# state (the registry, [one tuple per node]); the node kinds are jaxlib's
_PYTREEDEF = ("jaxlib._jax.pytree", "PyTreeDef")
_REGISTRY = ("jax._src.tree_util", "default_registry")
_LEAF, _NONE, _TUPLE, _NAMEDTUPLE, _LIST, _DICT = range(6)
# optax's module of each state class of train/optim.py, by class name
_OPTAX_MODULES = {"ScaleByAdamState": "optax._src.transform",
                  "EmptyState": "optax._src.base",
                  "ScaleByScheduleState": "optax._src.transform"}


class _Pickler:
    """The few protocol-4 opcodes a treedef's pickle uses, memoised as
    CPython's pickler does (a repeated string or class is a BINGET of its
    first occurrence)."""

    def __init__(self):
        self.out = bytearray()
        self.memo: dict = {}

    def _memoize(self, key) -> None:
        self.memo[key] = len(self.memo)
        self.out += b"\x94"                                  # MEMOIZE

    def _repeat(self, key) -> bool:
        idx = self.memo.get(key)
        if idx is None:
            return False
        self.out += (b"h" + bytes([idx]) if idx < 256        # BINGET
                     else b"j" + struct.pack("<I", idx))     # LONG_BINGET
        return True

    def int(self, n: int) -> None:
        if 0 <= n < 256:
            self.out += b"K" + bytes([n])                    # BININT1
        elif 0 <= n < 65536:
            self.out += b"M" + struct.pack("<H", n)          # BININT2
        else:
            self.out += b"J" + struct.pack("<i", n)          # BININT

    def str(self, s: str) -> None:
        if self._repeat(("str", s)):
            return
        data = s.encode("utf-8")
        if len(data) < 256:
            self.out += b"\x8c" + bytes([len(data)]) + data  # SHORT_BINUNICODE
        else:
            self.out += b"X" + struct.pack("<I", len(data)) + data
        self._memoize(("str", s))

    def glob(self, module: str, name: str) -> None:
        if self._repeat(("global", module, name)):
            return
        self.str(module)
        self.str(name)
        self.out += b"\x93"                                  # STACK_GLOBAL
        self._memoize(("global", module, name))

    def items(self, emit: list) -> None:
        """A list's items as CPython's pickler appends them: one item by
        APPEND, more by MARK ... APPENDS in batches of 1000."""
        if len(emit) == 1:
            emit[0]()
            self.out += b"a"                                 # APPEND
            return
        for at in range(0, len(emit), 1000):
            self.out += b"("                                 # MARK
            for fn in emit[at:at + 1000]:
                fn()
            self.out += b"e"                                 # APPENDS

    def list(self, emit: list) -> None:
        self.out += b"]"                                     # EMPTY_LIST
        self._memoize(("list", len(self.memo)))
        self.items(emit)


def _treedef_nodes(node) -> list[tuple]:
    """The nodes of `node`'s treedef in post-order, each (kind, arity,
    node data, leaves, nodes): node data is a dict's sorted keys or a
    namedtuple's optax class (module, name), else None."""
    kids = _children(node)
    if kids is None:
        return [(_LEAF, 0, None, 1, 1)]
    out: list[tuple] = []
    for _, child in kids:
        out += _treedef_nodes(child)
    leaves = sum(n[3] for n in out if n[0] == _LEAF)
    nodes = len(out) + 1
    if node is None:
        kind, data = _NONE, None
    elif isinstance(node, dict):
        kind, data = _DICT, [k for k, _ in kids]
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        cls = type(node).__name__
        if cls not in _OPTAX_MODULES:
            raise TypeError(f"no optax class for the namedtuple {cls}")
        kind, data = _NAMEDTUPLE, (_OPTAX_MODULES[cls], cls)
    elif isinstance(node, tuple):
        kind, data = _TUPLE, None
    else:
        kind, data = _LIST, None
    return out + [(kind, len(kids), data, leaves, nodes)]


def _treedef_pickle(tree) -> bytes:
    """`pickle.dumps(jax.tree.structure(tree))` under jax 0.9.0, without
    jax: PROTO 4, one FRAME, `PyTreeDef()` by NEWOBJ and BUILD with
    (default_registry, [(kind, arity, node data, None, leaves, nodes)])."""
    p = _Pickler()

    def node(kind, arity, data, leaves, nodes):
        def emit():
            p.out += b"("                                    # MARK
            p.int(kind)
            p.int(arity)
            if data is None:
                p.out += b"N"                                # NONE
            elif kind == _DICT:
                p.list([lambda k=k: p.str(k) for k in data])
            else:
                p.glob(*data)
            p.out += b"N"
            p.int(leaves)
            p.int(nodes)
            p.out += b"t"                                    # TUPLE
            p._memoize(("tuple", len(p.memo)))
        return emit

    p.glob(*_PYTREEDEF)
    p.out += b")\x81"                                        # EMPTY_TUPLE NEWOBJ
    p._memoize(("obj",))
    p.glob(*_REGISTRY)
    p.list([node(*n) for n in _treedef_nodes(tree)])
    p.out += b"\x86"                                         # TUPLE2
    p._memoize(("state",))
    p.out += b"b."                                           # BUILD STOP
    return b"\x80\x04\x95" + struct.pack("<Q", len(p.out)) + bytes(p.out)


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

def _host_copy(src: torch.Tensor, i: int, buffers: Optional[dict],
               synced: set) -> torch.Tensor:
    """A host copy of `src`: a device tensor into a pinned buffer (reused
    from `buffers` where shape and dtype still match), issued without a
    wait; a CPU tensor cloned."""
    if src.device.type != "cuda":
        return src.clone()
    host = None if buffers is None else buffers.get(i)
    if host is None or host.shape != src.shape or host.dtype != src.dtype:
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        if buffers is not None:
            buffers[i] = host
    host.copy_(src, non_blocking=True)
    synced.add(src.device)
    return host


def _local_shard(leaf: DTensor) -> Optional[tuple[list, torch.Tensor]]:
    """(global index region, local tensor) of this rank's shard of a
    DTensor, or None when another rank holds replica 0 of it."""
    mesh = leaf.device_mesh
    coord = mesh.get_coordinate()
    if any(c != 0 for c, p in zip(coord, leaf.placements)
           if not p.is_shard()):
        return None
    return (local_region(leaf.shape, mesh, leaf.placements),
            leaf.to_local())


def _snapshot(state: Any, buffers: Optional[dict] = None):
    """This rank's share of the state on the host, complete when this
    returns: every device-to-host copy is issued (into pinned buffers,
    reused from `buffers` where shape and dtype still match) before one
    wait, and a CPU tensor is cloned, since the next step updates it in
    place. Returns (paths, pickled treedef, metas, records), each record
    (leaf index, shard file, index region, host data)."""
    leaves = flatten_with_paths(state)
    pidx = rank()
    metas, records, synced = [], [], set()
    for i, (_, leaf) in enumerate(leaves):
        if isinstance(leaf, DTensor):
            src = leaf.detach()
            metas.append({"shape": list(src.shape),
                          "dtype": _dtype_name(src.dtype)})
            shard = _local_shard(src)
            if shard is not None:
                region, local = shard
                records.append((i, f"leaf_{i}.p{pidx}_0.npy", region,
                                _host_copy(local, i, buffers, synced)))
        elif isinstance(leaf, torch.Tensor):
            src = leaf.detach()
            metas.append({"shape": list(src.shape),
                          "dtype": _dtype_name(src.dtype)})
            if pidx == 0:
                records.append((i, f"leaf_{i}.p0_0.npy",
                                [[0, d] for d in src.shape],
                                _host_copy(src, i, buffers, synced)))
        else:
            arr = np.asarray(leaf)
            metas.append({"shape": list(arr.shape), "dtype": str(arr.dtype),
                          "py": not isinstance(leaf, np.ndarray)})
            if pidx == 0:
                records.append((i, f"leaf_{i}.p0_full.npy",
                                [[0, d] for d in arr.shape], arr))
    for device in synced:
        torch.cuda.synchronize(device)
    return ([list(path) for path, _ in leaves], _treedef_pickle(state),
            metas, records)


def _write_files(out_dir: str, paths, treedef: bytes, metas, records,
                 put=lambda name: None) -> None:
    """Write this rank's files of a step under `out_dir`: its shards and
    manifest_p{rank}.json, and on rank 0 index.json, tree.json and
    tree.pkl. `put(name)` is called with each file's relative name as
    soon as it is written."""
    pidx = rank()
    os.makedirs(os.path.join(out_dir, "shards"), exist_ok=True)
    manifest: dict[str, Any] = {"process": pidx, "shards": []}
    for i, fname, index_spec, data in records:
        _write_npy(os.path.join(out_dir, "shards", fname), data)
        put(f"shards/{fname}")
        manifest["shards"].append({"leaf": i, "file": fname,
                                   "index": index_spec})
    files = [(f"manifest_p{pidx}.json", manifest)]
    if pidx == 0:
        files += [(_INDEX_FILE, {"leaves": metas}),
                  (_TREE_FILE, {"paths": paths})]
    for name, obj in files:
        with open(os.path.join(out_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)
        put(name)
    if pidx == 0:
        with open(os.path.join(out_dir, _TREEDEF_FILE), "wb") as f:
            f.write(treedef)
        put(_TREEDEF_FILE)


def _tmp_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}") + ".tmp"


def _clear_tmp(ckpt_dir: str, step: int) -> None:
    """Remove a stale `.tmp` of the step (rank 0) before any rank writes
    into it; every rank waits for that."""
    tmp = _tmp_dir(ckpt_dir, step)
    if rank() == 0 and not _is_store_path(ckpt_dir) and \
            os.path.exists(tmp):
        shutil.rmtree(tmp)
    barrier()


def _write_rank_files(ckpt_dir: str, step: int, paths, treedef: bytes,
                      metas, records) -> None:
    """This rank's files: under `step_<N>.tmp/`, or uploaded under
    `step_<N>/` on a store (each written to a scratch directory and
    removed once uploaded)."""
    if not _is_store_path(ckpt_dir):
        _write_files(_tmp_dir(ckpt_dir, step), paths, treedef, metas,
                     records)
        return
    store = _ckpt_store(ckpt_dir)
    prefix = f"step_{step}"
    scratch = tempfile.mkdtemp(prefix="tony-ckpt-")

    def put(name: str) -> None:
        local = os.path.join(scratch, name)
        store.put(local, f"{prefix}/{name}")
        os.remove(local)

    try:
        _write_files(scratch, paths, treedef, metas, records, put)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _commit(ckpt_dir: str, step: int, keep: int = 0,
            pinned: Optional[int] = None) -> str:
    """Rank 0's commit of a step every rank has written: the atomic
    rename of the local `.tmp`, or on a store the COMMIT marker, last,
    naming the manifest set of this attempt (an aborted earlier upload of
    the same step by more processes may have left stale manifest_p*.json
    behind, which restore must not read); then the retention prune.
    Returns the step's directory (or URI)."""
    if _is_store_path(ckpt_dir):
        store = _ckpt_store(ckpt_dir)
        prefix = f"step_{step}"
        scratch = tempfile.mkdtemp(prefix="tony-ckpt-")
        try:
            marker = os.path.join(scratch, _COMMIT_FILE)
            with open(marker, "w", encoding="utf-8") as f:
                json.dump({"step": step, "processes": world_size()}, f)
            store.put(marker, f"{prefix}/{_COMMIT_FILE}")
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        final = store.uri(prefix)
    else:
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(_tmp_dir(ckpt_dir, step), final)
    # the step just written is always kept, so a failed prune can never
    # undo the commit that triggered it
    if keep > 0:
        try:
            prune_checkpoints(ckpt_dir, keep, pinned=pinned)
        except Exception:  # noqa: BLE001 — GC must never fail a commit
            LOG.exception("checkpoint retention prune failed under %s",
                          ckpt_dir)
    return final


def _commit_gang(ckpt_dir: str, step: int, keep: int,
                 pinned: Optional[int]) -> str:
    """Every rank's files are written: meet, rank 0 commits, meet again
    (so no rank reads `latest_step` before the commit). A no-op meeting
    on one process."""
    barrier()
    final = _commit(ckpt_dir, step, keep, pinned) if rank() == 0 else ""
    barrier()
    return final


def save_checkpoint(ckpt_dir: str, step: int, state: Any, keep: int = 0,
                    pinned: Optional[int] = None) -> str:
    """Write `state` (nested dicts, tuples and namedtuples of tensors,
    DTensors and Python numbers) as step `step`; returns the step's
    directory (or its URI on a `gs://` store; "" on ranks other than 0).
    Under a gang every rank calls it with its shards.

    keep > 0 prunes older committed steps down to the newest `keep` after
    the commit; `pinned` names a step kept regardless of age (the step the
    current run restored from)."""
    snapshot = _snapshot(state)
    _clear_tmp(ckpt_dir, step)
    _write_rank_files(ckpt_dir, step, *snapshot)
    return _commit_gang(ckpt_dir, step, keep, pinned)


def committed_steps(ckpt_dir: str) -> list[int]:
    """Every complete checkpoint step, ascending: a local `step_N`
    directory (the rename made it whole), or on a store a step whose
    COMMIT marker landed (a targeted glob of the markers, not a walk of
    every shard object)."""
    if _is_store_path(ckpt_dir):
        return sorted(int(m.group(1))
                      for key in _ckpt_store(ckpt_dir).glob("step_*/COMMIT")
                      if (m := _COMMIT_KEY_RE.match(key)))
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(name)))


def prune_checkpoints(ckpt_dir: str, keep: int,
                      pinned: Optional[int] = None) -> list[int]:
    """Delete committed `step_N` directories beyond the newest `keep`,
    oldest first, never `pinned`. On a store each step's COMMIT marker
    goes first, so a reader racing the prune sees an uncommitted step,
    never half of one. Returns the pruned steps."""
    if keep <= 0:
        return []
    steps = committed_steps(ckpt_dir)
    victims = [s for s in steps[:-keep] if s != pinned] \
        if len(steps) > keep else []
    if _is_store_path(ckpt_dir):
        store = _ckpt_store(ckpt_dir)
        for step in victims:
            marker = f"step_{step}/{_COMMIT_FILE}"
            store.delete(marker)
            for key in store.list_keys(f"step_{step}"):
                if key != marker:
                    store.delete(key)
    else:
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


def _read_leaf(i: int, meta: dict, records: list[dict], resolve,
               region: Optional[list] = None) -> np.ndarray:
    """Leaf `i` (or its `region`, [[start, stop], ...] per dim), in its
    storage dtype; `resolve(file)` gives a shard file's local path. A
    region saved as one file covering exactly it comes back as that
    file's copy-on-write map; anything else is pasted from every shard
    that overlaps it into a new array, which must be covered exactly."""
    dims = list(meta["shape"])
    storage = _storage_dtype(meta["dtype"])
    if region is None:
        region = [[0, d] for d in dims]
    if len(records) == 1 and records[0]["index"] == region:
        return _load_npy(resolve(records[0]["file"]), storage,
                         mmap=bool(dims))
    target = tuple(slice(a, b) for a, b in region)
    shape = [b - a for a, b in region]
    out = np.empty(shape, storage)
    pasted = sum(_paste_region(out, target, resolve(rec["file"]), rec)
                 for rec in records)
    if pasted != math.prod(shape):
        raise ValueError(f"leaf {i}: its shard files cover {pasted} of "
                         f"{math.prod(shape)} elements (region {region})")
    return out


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _python_or_tensor(arr: np.ndarray, meta: dict):
    if meta.get("py") and arr.ndim == 0:
        return arr.item()
    return _as_tensor(np.array(arr), meta["dtype"])


class _Step:
    """One committed step opened for reading: its leaves' metadata, the
    key paths of `tree.json` (None for a JAX checkpoint), the shard
    records by leaf, and `resolve(file)`, a shard's local path. On a store
    the files land in a temporary cache, which `close()` removes: a `with`
    block removes it whatever its body raises."""

    def __init__(self, where: str, metas: list, paths, by_leaf: dict,
                 resolve, cache: Optional[str] = None):
        self.where = where
        self.metas = metas
        self.paths = paths
        self.by_leaf = by_leaf
        self.resolve = resolve
        self._cache = cache

    def leaf(self, i: int, region: Optional[list] = None) -> np.ndarray:
        return _read_leaf(i, self.metas[i], self.by_leaf.get(i, []),
                          self.resolve, region)

    @torch.no_grad()
    def fill(self, ref: torch.Tensor, i: int, name: str) -> None:
        """Copy leaf `i` into the tensor `ref`, in place, on its device: a
        DTensor takes this rank's region of it."""
        meta = self.metas[i]
        if (list(ref.shape) != list(meta["shape"])
                or _dtype_name(ref.dtype) != meta["dtype"]):
            raise ValueError(
                f"{self.where} leaf {i} ({name}): the checkpoint has "
                f"{meta['dtype']} {meta['shape']}, the template "
                f"{_dtype_name(ref.dtype)} {list(ref.shape)}")
        if isinstance(ref, DTensor):
            region = local_region(ref.shape, ref.device_mesh,
                                  ref.placements)
            ref.to_local().copy_(_as_tensor(self.leaf(i, region),
                                            meta["dtype"]))
            return
        ref.copy_(_as_tensor(self.leaf(i), meta["dtype"]))

    def close(self) -> None:
        if self._cache is not None:
            shutil.rmtree(self._cache, ignore_errors=True)
            self._cache = None

    def __enter__(self) -> "_Step":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_json(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _open_local_step(ckpt_dir: str, step: int) -> _Step:
    path = os.path.join(ckpt_dir, f"step_{step}")
    metas = _read_json(os.path.join(path, _INDEX_FILE))["leaves"]
    tree_path = os.path.join(path, _TREE_FILE)
    paths = None
    if os.path.exists(tree_path):
        paths = [tuple(p) for p in _read_json(tree_path)["paths"]]
    shards_dir = os.path.join(path, "shards")
    return _Step(path, metas, paths, _load_manifests(path),
                 lambda fname: os.path.join(shards_dir, fname))


def _open_store_step(base: str, step: int) -> _Step:
    """Fetch a store step's index.json, tree.json (where there is one),
    COMMIT and exactly the manifests COMMIT names into a temporary cache;
    each shard is fetched on first touch. Manifests of an aborted earlier
    attempt with more processes may lie beside them and are never read:
    merging them would paste stale shards over fresh regions."""
    store = _ckpt_store(base)
    prefix = f"step_{step}"
    cache = tempfile.mkdtemp(prefix="tony-ckpt-restore-")

    def fetch(name: str) -> str:
        return store.fetch(store.uri(f"{prefix}/{name}"),
                           os.path.join(cache, name))

    try:
        metas = _read_json(fetch(_INDEX_FILE))["leaves"]
        paths = None
        if store.exists(store.uri(f"{prefix}/{_TREE_FILE}")):
            paths = [tuple(p) for p in _read_json(fetch(_TREE_FILE))["paths"]]
        commit = _read_json(fetch(_COMMIT_FILE))
        by_leaf: dict[int, list[dict]] = {}
        for p in range(int(commit.get("processes", 1))):
            for rec in _read_json(fetch(f"manifest_p{p}.json"))["shards"]:
                by_leaf.setdefault(rec["leaf"], []).append(rec)
    except BaseException:
        shutil.rmtree(cache, ignore_errors=True)
        raise

    def resolve(fname: str) -> str:
        local = os.path.join(cache, "shards", fname)
        if not os.path.exists(local):
            store.fetch(store.uri(f"{prefix}/shards/{fname}"), local)
        return local

    return _Step(store.uri(prefix), metas, paths, by_leaf, resolve, cache)


def _open_step(ckpt_dir: str, step: Optional[int]) -> _Step:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if _is_store_path(ckpt_dir):
        return _open_store_step(ckpt_dir, step)
    return _open_local_step(ckpt_dir, step)


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       template: Any = None) -> Any:
    """Read a checkpoint back (the latest step when `step` is None).

    template=None: nested dicts keyed by `tree.json`'s key paths, with CPU
    tensors (Python numbers where the leaf was one). A checkpoint the JAX
    package wrote has no `tree.json` and needs a template.

    template: a state of the same tree. Each tensor leaf is filled in
    place (`copy_`, on its device) and the template's structure is
    returned with its tensors and the checkpoint's Python numbers."""
    with _open_step(ckpt_dir, step) as st:
        if template is None:
            if st.paths is None:
                raise ValueError(
                    f"{st.where} has no {_TREE_FILE} (a checkpoint of the "
                    f"JAX package, which pickles its tree): restore it with "
                    f"a template")
            leaves = [_python_or_tensor(st.leaf(i), meta)
                      for i, meta in enumerate(st.metas)]
            return _unflatten_paths([list(p) for p in st.paths], leaves)
        t_leaves = flatten_with_paths(template)
        if len(t_leaves) != len(st.metas):
            raise ValueError(f"template has {len(t_leaves)} leaves, "
                             f"checkpoint {st.where} {len(st.metas)}")
        if st.paths is not None:
            for (t_path, _), c_path in zip(t_leaves, st.paths):
                if t_path != c_path:
                    raise ValueError(
                        f"template leaf {'/'.join(t_path)} where "
                        f"{st.where} has {'/'.join(c_path)}")
        out = []
        for i, ((t_path, ref), meta) in enumerate(zip(t_leaves, st.metas)):
            if isinstance(ref, torch.Tensor):
                st.fill(ref, i, "/".join(t_path))
                out.append(ref)
            else:
                out.append(_python_or_tensor(st.leaf(i), meta))
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
    t_leaves = flatten_with_paths(template)
    n = len(t_leaves)
    with _open_step(ckpt_dir, step) as st:
        if st.paths is not None:
            index = [i for i, p in enumerate(st.paths)
                     if p[:1] == ("params",)]
            found = [st.paths[i][1:] for i in index]
            if found != [p for p, _ in t_leaves]:
                raise ValueError(f"{st.where}: its params {found} are not "
                                 f"the template's {[p for p, _ in t_leaves]}")
        else:
            if len(st.metas) < n + 1:
                raise ValueError(f"{st.where} has {len(st.metas)} leaves, "
                                 f"fewer than the template's {n} params "
                                 f"and a step")
            index = list(range(len(st.metas) - 1 - n, len(st.metas) - 1))
        for i, (t_path, ref) in zip(index, t_leaves):
            st.fill(ref, i, f"params/{'/'.join(t_path)}")
    return template


# ---------------------------------------------------------------------------
# async save
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Overlap checkpoint file IO with training.

    `save(step, state)` snapshots the state into pinned host buffers
    synchronously (the next step updates the tensors in place) and writes
    the files (or uploads them, on a store) on a background thread; an
    error there is raised by the next `save`, `wait` or `close`. At most
    one save is in flight: the next `save` waits for the previous commit
    first, which also frees its buffers for reuse. Under a gang the
    commit (barriers, rank 0's rename or marker) runs in `wait()`, on the
    caller's thread. Call `wait()` before reading `latest_step` and
    `close()` at the end."""

    def __init__(self, ckpt_dir: str, keep: int = 0,
                 pinned: Optional[int] = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.pinned = pinned
        self.last_step: Optional[int] = None
        self._buffers: dict[int, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the step whose files are written and whose commit is due
        self._pending: Optional[int] = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        snapshot = _snapshot(state, self._buffers)
        gang = world_size() > 1
        if gang:
            _clear_tmp(self.ckpt_dir, step)

        def work():
            try:
                _write_rank_files(self.ckpt_dir, step, *snapshot)
                if not gang:
                    _commit(self.ckpt_dir, step, self.keep, self.pinned)
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                self._error = e
                LOG.exception("async checkpoint step %d failed", step)

        self.last_step = step
        self._pending = step if gang else None
        self._thread = threading.Thread(target=work, name=f"ckpt-{step}",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        step, self._pending = self._pending, None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from err
        if step is not None:
            _commit_gang(self.ckpt_dir, step, self.keep, self.pinned)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._buffers.clear()
