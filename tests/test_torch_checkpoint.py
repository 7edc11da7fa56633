"""The port's checkpoints (tony_tpu_torch/train/checkpoint.py and the
Trainer's state lifecycle) against the JAX package's, on the CPU.

A checkpoint must read back in the other package: the port's index.json,
manifest and shard bytes equal the JAX package's for the same state, a JAX
Trainer's checkpoint written on the 8-device CPU mesh (several shard files
per leaf) restores into the port bit for bit, and the port's Trainer
resumes from it with the JAX Trainer's losses. Losses are held to 5e-4
(gradients through the whole model, tests/test_ops.py:49); restored leaves
and file bytes exactly. Around that, ports of tests/test_checkpoint.py and
tests/test_preemption.py for the protocol (no-template assembly, a
snapshot that survives the next in-place update, `.tmp` ignored, GC with
keep/pin, the emergency save and SIGTERM -> EXIT_PREEMPTED).

`gs://` directories run against the `fake_gcs` stand-in (tests/conftest.py:
a `gsutil` on PATH mapping `cp`/`ls`/`rm` onto a local directory): the
same objects byte for byte as the JAX package's (the port's tree.json
aside), each package restoring the other's, the COMMIT protocol (an
uncommitted step invisible, stale manifests ignored, the marker deleted
first by retention), a failed `ls` raising, the async upload, the
Trainer resumed bitwise and the server on a `gs://` checkpoint.
"""

import json
import os
import shutil
import signal
import stat
import tempfile
import time
import urllib.request
from functools import partial, wraps

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tony_tpu.models import llama as jllama
from tony_tpu.train import checkpoint as jckpt
from tony_tpu.train import data as jdata
from tony_tpu.train.trainer import Trainer as JaxTrainer
from tony_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tony_tpu_torch import constants as C
from tony_tpu_torch.models import llama
from tony_tpu_torch.storage import store
from tony_tpu_torch.train import checkpoint as ckpt
from tony_tpu_torch.train import data, optim, trainer

LOSS_TOL = 5e-4
SCHEDULE = dict(init_value=0.0, peak_value=1e-2, warmup_steps=2,
                decay_steps=10)


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an array to compare exactly (bf16 by its bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_leaves(port_state, jax_state):
    """Every leaf of the port's state equals the JAX state's leaf at the
    same key path, bit for bit (and the trees have the same paths)."""
    jflat = jax.tree_util.tree_flatten_with_path(jax.device_get(jax_state))[0]
    pflat = ckpt.flatten_with_paths(port_state)
    assert len(pflat) == len(jflat)
    for (path, got), (jpath, want) in zip(pflat, jflat):
        keys = tuple(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in jpath)
        assert path == keys, (path, keys)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg="/".join(path))


# ---------------------------------------------------------------------------
# the on-disk layout, byte for byte
# ---------------------------------------------------------------------------

def _jax_adamw_state(dtype):
    """A tiny-Llama AdamW state two updates in, as the JAX Trainer keeps
    it."""
    jcfg = jllama.get_config("tiny", dtype=dtype)
    jp = jllama.llama_init(jcfg, jax.random.PRNGKey(0))
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(**SCHEDULE),
                       weight_decay=0.01)
    js = jopt.init(jp)
    for step in range(2):
        leaves, treedef = jax.tree.flatten(jp)
        grads = jax.tree.unflatten(treedef, [
            jnp.asarray(np.random.RandomState(10 * step + i)
                        .standard_normal(p.shape), p.dtype)
            for i, p in enumerate(leaves)])
        updates, js = jopt.update(grads, js, jp)
        jp = optax.apply_updates(jp, updates)
    return {"params": jp, "opt_state": js, "step": 2}


def _port_state(dtype):
    cfg = llama.get_config("tiny", dtype=dtype)
    params = llama.llama_init(cfg, torch.Generator().manual_seed(1))
    for leaf in optim.tree_leaves(params):
        leaf.requires_grad_(True)
    opt = optim.adamw(optim.warmup_cosine_decay_schedule(**SCHEDULE),
                      weight_decay=0.01).init(params)
    return params, opt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_and_shards_equal_the_jax_packages(tmp_path, dtype):
    """The JAX package saves a state; the port restores it into a fresh
    state of its own (every leaf bit for bit, the lr at the schedule's
    count) and saves it again: index.json, the manifest and every shard
    file's bytes are the JAX package's (bf16 shards by their bits, under
    the '<V2' header)."""
    jstate = _jax_adamw_state(getattr(jnp, dtype))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 2, jstate)
    params, opt = _port_state(getattr(torch, dtype))
    state = ckpt.restore_checkpoint(
        jdir, 2, template={"params": params, "opt_state": opt.tree(),
                           "step": 0})
    opt.load_tree(state["opt_state"])
    assert state["step"] == 2 and opt.count == 2
    port_state = {"params": params, "opt_state": opt.tree(),
                  "step": state["step"]}
    _assert_same_leaves(port_state, jstate)
    want_lr = float(optax.warmup_cosine_decay_schedule(**SCHEDULE)(2))
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr,
                                                                rel=1e-6)
    ckpt.save_checkpoint(pdir, 2, port_state)
    j_step, p_step = os.path.join(jdir, "step_2"), os.path.join(pdir,
                                                                "step_2")
    for name in ("index.json", "manifest_p0.json"):
        with open(os.path.join(j_step, name)) as a, \
                open(os.path.join(p_step, name)) as b:
            assert json.load(a) == json.load(b), name
    files = sorted(os.listdir(os.path.join(j_step, "shards")))
    assert files == sorted(os.listdir(os.path.join(p_step, "shards")))
    for name in files:
        with open(os.path.join(j_step, "shards", name), "rb") as a, \
                open(os.path.join(p_step, "shards", name), "rb") as b:
            assert a.read() == b.read(), name
    # the port's tree.json names every leaf as jax flattens it
    with open(os.path.join(p_step, "tree.json")) as f:
        paths = json.load(f)["paths"]
    assert paths[0] == ["opt_state", "0", "count"]
    assert paths[-1] == ["step"]
    assert ["params", "layers", "attn_norm"] in paths


# ---------------------------------------------------------------------------
# tree.pkl: the JAX package restores and serves what the port wrote
# ---------------------------------------------------------------------------

def _port_tree(tree):
    """A JAX state of numpy leaves as the port holds it: tensors for the
    arrays, the port's namedtuples for optax's, Python numbers kept."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = getattr(optim, type(tree).__name__)
        return cls(*(_port_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_port_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16) if tree.dtype.name == "bfloat16" else \
            torch.from_numpy(tree.copy())
    return tree


def _sgd_state():
    jp = jax.device_get(jllama.llama_init(jllama.get_config("tiny"),
                                          jax.random.PRNGKey(1)))
    return {"params": jp, "opt_state": optax.sgd(1e-2).init(jp), "step": 5}


def _master_state():
    state = jax.device_get(_jax_adamw_state(jnp.bfloat16))
    master = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          state["params"])
    return {"params": state["params"], "step": 2,
            "opt_state": {"inner": state["opt_state"], "master": master}}


def _odd_state():
    return {"b": 1.5, "a": (np.zeros(2, np.float32), None,
                            [np.ones(3, np.int32), 2]), "n": None, "e": {}}


TREES = {"adamw-f32": lambda: jax.device_get(_jax_adamw_state(jnp.float32)),
         "adamw-bf16": lambda: jax.device_get(
             _jax_adamw_state(jnp.bfloat16)),
         "sgd": _sgd_state, "masters": _master_state, "odd": _odd_state}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_tree_pkl_equals_the_jax_packages(tmp_path, kind):
    """The port's tree.pkl for a state is, byte for byte, the one
    `tony_tpu.train.checkpoint.save_checkpoint` writes for the same state
    built from the same numpy arrays (jax 0.9.0 and optax as installed);
    the JAX package restores the port's checkpoint without a template into
    that state's structure and leaves, bit for bit. A state with bf16
    leaves the JAX package restores from neither package: its restore
    casts the '<V2' shards its own np.save wrote and numpy refuses."""
    jstate = TREES[kind]()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 3, jstate)
    ckpt.save_checkpoint(pdir, 3, _port_tree(jstate))
    with open(os.path.join(jdir, "step_3", "tree.pkl"), "rb") as a, \
            open(os.path.join(pdir, "step_3", "tree.pkl"), "rb") as b:
        assert b.read() == a.read()
    if any(getattr(leaf, "dtype", None) == jnp.bfloat16
           for leaf in jax.tree.leaves(jstate)):
        for d in (jdir, pdir):
            with pytest.raises(ValueError, match="No cast function"):
                jckpt.restore_checkpoint(d, 3)
        return
    back = jckpt.restore_checkpoint(pdir, 3)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_jax_restores_a_port_trainer_checkpoint(tmp_path):
    """A port AdamW state two updates in (f32: see the bf16 case above),
    saved by the port, restored by the JAX package with and without a
    template: every leaf bit for bit, the optax counts and the step
    included."""
    params, opt = _port_state(torch.float32)
    for step in range(2):
        for i, p in enumerate(optim.tree_leaves(params)):
            g = np.random.RandomState(10 * step + i).standard_normal(
                p.shape)
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
    state = {"params": params, "opt_state": opt.tree(), "step": 2}
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    template = _jax_adamw_state(jnp.float32)
    for restored in (jckpt.restore_checkpoint(str(tmp_path), 2),
                     jckpt.restore_checkpoint(str(tmp_path), 2, template)):
        assert jax.tree.structure(restored) == jax.tree.structure(template)
        _assert_same_leaves(state, restored)
        assert restored["step"] == 2
        assert int(restored["opt_state"][0].count) == 2


def test_jax_server_serves_a_port_checkpoint(tmp_path):
    """`python -m tony_tpu.serve --checkpoint-dir` loads a checkpoint the
    port's Trainer layout wrote (tony_tpu/serve/__main__.py:112-120): its
    greedy tokens are the port's `generate` on the same parameters."""
    from tony_tpu.models.generate import generate as jax_generate
    from tony_tpu.serve.__main__ import _load_model, build_arg_parser
    from tony_tpu_torch.models.generate import generate

    params, opt = _port_state(torch.float32)
    ckpt.save_checkpoint(str(tmp_path), 4, {
        "params": params, "opt_state": opt.tree(), "step": 4})
    jparams, jcfg = _load_model(build_arg_parser().parse_args(
        ["--config", "tiny", "--checkpoint-dir", str(tmp_path)]))
    prompt = [5, 17, 3, 250, 9]
    want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray([prompt]),
                                   6))[0].tolist()
    with torch.no_grad():
        got = generate({k: v.detach() if isinstance(v, torch.Tensor) else
                        {n: w.detach() for n, w in v.items()}
                        for k, v in params.items()},
                       llama.get_config("tiny"), torch.tensor([prompt]),
                       6)[0].tolist()
    assert got == want


# ---------------------------------------------------------------------------
# a JAX Trainer's sharded checkpoint, restored and resumed in the port
# ---------------------------------------------------------------------------

BATCH, SEQ = 8, 16
TRAIN = dict(log_every=1, learning_rate=1e-2, warmup_steps=1,
             prefetch_depth=0)


def _skipped(it, n):
    for _ in range(n):
        next(it)
    return it


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer on the 8-device CPU mesh, fsdp-sharded: 2 steps to
    a checkpoint, then a resumed run to step 4 on a copy of it."""
    root = tmp_path_factory.mktemp("jax_trainer")
    jcfg = jllama.get_config("tiny")

    def run(ckpt_dir, num_steps, skip):
        t = JaxTrainer(
            partial(jllama.llama_loss, config=jcfg),
            partial(jllama.llama_init, jcfg),
            _skipped(jdata.synthetic_tokens(BATCH, SEQ, jcfg.vocab_size),
                     skip),
            JaxTrainerConfig(num_steps=num_steps, checkpoint_dir=ckpt_dir,
                             **TRAIN),
            param_axes=jllama.llama_param_axes(jcfg))
        t.run()
        return t

    first = run(str(root / "first"), 2, 0)
    state = jax.device_get({"params": first.params,
                            "opt_state": first.opt_state, "step": 2})
    resumed_dir = str(root / "resumed")
    shutil.copytree(str(root / "first"), resumed_dir)
    resumed = run(resumed_dir, 4, 2)
    return {"dir": str(root / "first"), "state": state,
            "losses": [m["loss"] for m in resumed.metrics_history
                       if "loss" in m]}


def test_sharded_jax_trainer_checkpoint_restores_bit_exact(jax_run):
    step_dir = os.path.join(jax_run["dir"], "step_2")
    with open(os.path.join(step_dir, "manifest_p0.json")) as f:
        files = [r for r in json.load(f)["shards"] if r["leaf"] == 26]
    assert len(files) == 8            # params/embed: one file per device
    assert not os.path.exists(os.path.join(step_dir, "tree.json"))
    params, opt = _port_state(torch.float32)
    template = {"params": params, "opt_state": opt.tree(), "step": 0}
    state = ckpt.restore_checkpoint(jax_run["dir"], None, template)
    opt.load_tree(state["opt_state"])
    _assert_same_leaves({"params": params, "opt_state": opt.tree(),
                         "step": state["step"]}, jax_run["state"])
    # without tree.json there is no template-free restore
    with pytest.raises(ValueError, match="tree.json"):
        ckpt.restore_checkpoint(jax_run["dir"])


def test_port_trainer_resumes_a_jax_checkpoint(jax_run, tmp_path):
    """The port's Trainer on a copy of the JAX step-2 checkpoint: its
    steps 3 and 4 (the optax layout, the lr position and the data stream
    all taken over) give the JAX Trainer's resumed losses."""
    ckpt_dir = str(tmp_path / "ck")
    shutil.copytree(jax_run["dir"], ckpt_dir)
    cfg = llama.get_config("tiny")
    t = trainer.Trainer(
        partial(llama.llama_loss, config=cfg), partial(llama.llama_init, cfg),
        _skipped(data.synthetic_tokens(BATCH, SEQ, cfg.vocab_size), 2),
        trainer.TrainerConfig(num_steps=4, checkpoint_dir=ckpt_dir, **TRAIN),
        device="cpu")
    t.setup()
    assert t.step == 2 and t.opt_state.count == 2
    t.run()
    losses = [m["loss"] for m in t.metrics_history]
    assert [m["step"] for m in t.metrics_history] == [3, 4]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_TOL)
    # the restored step stays pinned beside the final one
    assert ckpt.committed_steps(ckpt_dir) == [2, 4]


# ---------------------------------------------------------------------------
# the protocol (ports of tests/test_checkpoint.py, tests/test_preemption.py)
# ---------------------------------------------------------------------------

def _state():
    return {"w": torch.arange(64.0).reshape(8, 8),
            "b": torch.arange(8.0).to(torch.bfloat16), "step": 4}


def test_restore_without_template_assembles(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 2, _state())
    restored = ckpt.restore_checkpoint(str(tmp_path))
    assert isinstance(restored["w"], torch.Tensor)
    torch.testing.assert_close(restored["w"],
                               torch.arange(64.0).reshape(8, 8))
    assert restored["b"].dtype == torch.bfloat16
    assert torch.equal(restored["b"], torch.arange(8.0).to(torch.bfloat16))
    assert restored["step"] == 4 and isinstance(restored["step"], int)


def test_async_snapshot_survives_the_next_in_place_update(tmp_path):
    """save() returns with the snapshot taken: the caller updates the
    tensor in place right away (as the train step does)."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.arange(16.0)
    for step in range(3):
        saver.save(step, {"x": x})
        x.mul_(2.0)
    saver.close()
    assert ckpt.latest_step(str(tmp_path)) == 2
    restored = ckpt.restore_checkpoint(str(tmp_path), 2)
    torch.testing.assert_close(restored["x"], torch.arange(16.0) * 4.0)


def test_partial_tmp_dir_is_ignored(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 5, _state())
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp", "shards"))
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.restore_checkpoint(str(tmp_path))["step"] == 4


def test_gc_keeps_newest_and_pinned(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save_checkpoint(d, step, _state())
    ckpt.save_checkpoint(d, 4, _state(), keep=2, pinned=1)
    assert ckpt.committed_steps(d) == [1, 3, 4]
    ckpt.save_checkpoint(d, 5, _state(), keep=2, pinned=1)
    assert ckpt.committed_steps(d) == [1, 4, 5]
    assert ckpt.latest_step(d) == 5
    assert ckpt.restore_checkpoint(d, 1)["step"] == 4


def test_gc_never_deletes_below_keep(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, _state())
    ckpt.save_checkpoint(d, 2, _state())
    assert ckpt.prune_checkpoints(d, keep=3) == []
    assert ckpt.prune_checkpoints(d, keep=0) == []
    assert ckpt.committed_steps(d) == [1, 2]


def test_sharded_leaf_pastes_each_record_once(tmp_path, monkeypatch):
    """A leaf saved in many shard files (as a JAX mesh writes it) is
    pasted from each file once, and a leaf whose files leave a hole is
    refused."""
    n = 64
    step_dir = tmp_path / "step_1"
    os.makedirs(step_dir / "shards")
    records = []
    for i in range(n):
        fname = f"leaf_0.p0_{i}.npy"
        np.save(step_dir / "shards" / fname, np.array([float(i)], np.float32))
        records.append({"leaf": 0, "file": fname, "index": [[i, i + 1]]})
    (step_dir / "manifest_p0.json").write_text(json.dumps(
        {"process": 0, "shards": records}))
    (step_dir / "index.json").write_text(json.dumps(
        {"leaves": [{"shape": [n], "dtype": "float32"}]}))
    pastes = []
    real = ckpt._paste_region
    monkeypatch.setattr(ckpt, "_paste_region",
                        lambda *a: (pastes.append(a[2]), real(*a))[1])
    restored = ckpt.restore_checkpoint(str(tmp_path), 1,
                                       template={"w": torch.zeros(n)})
    torch.testing.assert_close(restored["w"], torch.arange(float(n)))
    assert len(pastes) == n == len(set(pastes))
    (step_dir / "manifest_p0.json").write_text(json.dumps(
        {"process": 0, "shards": records[1:]}))
    with pytest.raises(ValueError, match="cover 63 of 64"):
        ckpt.restore_checkpoint(str(tmp_path), 1,
                                template={"w": torch.zeros(n)})


def test_template_mismatch_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, _state())
    bad = {"w": torch.zeros(8, 8), "b": torch.zeros(8), "step": 0}
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore_checkpoint(str(tmp_path), 1, template=bad)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(str(tmp_path), 1, template={"w": bad["w"]})
    renamed = {"v": torch.zeros(8, 8),
               "b": torch.zeros(8, dtype=torch.bfloat16), "step": 0}
    with pytest.raises(ValueError, match="template leaf"):
        ckpt.restore_checkpoint(str(tmp_path), 1, template=renamed)


# ---------------------------------------------------------------------------
# gs:// checkpoints (the fake_gcs stand-in)
# ---------------------------------------------------------------------------

def _objects(root) -> dict:
    """{key: bytes} of every object under a stand-in bucket prefix."""
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def _assert_state_equal(got, want):
    assert [p for p, _ in ckpt.flatten_with_paths(got)] == \
        [p for p, _ in ckpt.flatten_with_paths(want)]
    for (path, a), (_, b) in zip(ckpt.flatten_with_paths(got),
                                 ckpt.flatten_with_paths(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg="/".join(path))


@pytest.fixture
def restore_tmp(tmp_path, monkeypatch):
    """A temporary directory of its own for the store's scratch and
    restore caches, so a test can see that they are removed."""
    d = tmp_path / "tmpdir"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def test_store_round_trip_and_uncommitted_step_invisible(fake_gcs,
                                                         restore_tmp):
    uri = "gs://bkt/ckpts"
    assert ckpt.latest_step(uri) is None          # "no URLs matched"
    state = _state()
    assert ckpt.save_checkpoint(uri, 7, state) == f"{uri}/step_7"
    step_dir = fake_gcs / "bkt" / "ckpts" / "step_7"
    assert json.loads((step_dir / "COMMIT").read_text()) == {
        "step": 7, "processes": 1}
    assert ckpt.latest_step(uri) == 7
    _assert_state_equal(ckpt.restore_checkpoint(uri), state)
    template = {"w": torch.zeros(8, 8),
                "b": torch.zeros(8, dtype=torch.bfloat16), "step": 0}
    _assert_state_equal(ckpt.restore_checkpoint(uri, 7, template), state)
    # a later save whose COMMIT never landed stays invisible
    later = {"w": state["w"] + 1, "b": state["b"], "step": 9}
    ckpt.save_checkpoint(uri, 9, later)
    os.remove(fake_gcs / "bkt" / "ckpts" / "step_9" / "COMMIT")
    assert ckpt.committed_steps(uri) == [7]
    _assert_state_equal(ckpt.restore_checkpoint(uri), state)
    # a template of the wrong dtype raises part way through the fill
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore_checkpoint(uri, 7, {"w": torch.zeros(8, 8),
                                         "b": torch.zeros(8), "step": 0})
    # the upload scratch and the restore caches are gone, the failed
    # restore's too
    assert os.listdir(restore_tmp) == []


def test_store_restore_ignores_stale_manifests(fake_gcs, restore_tmp):
    """A manifest of an aborted earlier attempt by two processes, naming
    a poisoned shard over the whole leaf, lies beside the committed one:
    restore reads exactly the manifests COMMIT names."""
    uri = "gs://bkt/stale"
    ckpt.save_checkpoint(uri, 3, _state())
    step_dir = fake_gcs / "bkt" / "stale" / "step_3"
    np.save(step_dir / "shards" / "leaf_2.p1_0.npy",
            np.full((8, 8), -1.0, np.float32))
    (step_dir / "manifest_p1.json").write_text(json.dumps({
        "process": 1, "shards": [{"leaf": 2, "file": "leaf_2.p1_0.npy",
                                  "index": [[0, 8], [0, 8]]}]}))
    restored = ckpt.restore_checkpoint(uri, 3)
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(64.0).reshape(8, 8))
    assert os.listdir(restore_tmp) == []


def test_async_checkpointer_on_store(fake_gcs, monkeypatch):
    """Uploads run on the checkpointer's thread; each snapshot survives
    the next in-place update. A failed upload surfaces at the next wait
    and leaves no COMMIT: the step never counts."""
    uri = "gs://bkt/async"
    x = torch.arange(16.0)
    saver = ckpt.AsyncCheckpointer(uri)
    for step in range(2):
        saver.save(step, {"x": x})
        x.mul_(2.0)
    saver.close()
    assert ckpt.committed_steps(uri) == [0, 1]
    np.testing.assert_array_equal(ckpt.restore_checkpoint(uri)["x"].numpy(),
                                  np.arange(16.0) * 2.0)
    real_put = store.GCSStore.put

    def failing_put(self, local_path, key):
        if key == "step_2/index.json":
            raise RuntimeError("gsutil cp failed rc=1: 503")
        return real_put(self, local_path, key)
    monkeypatch.setattr(store.GCSStore, "put", failing_put)
    saver.save(2, {"x": x})
    with pytest.raises(RuntimeError, match="async checkpoint failed") as e:
        saver.close()
    assert "503" in str(e.value.__cause__)
    assert ckpt.committed_steps(uri) == [0, 1]
    assert not (fake_gcs / "bkt" / "async" / "step_2" / "COMMIT").exists()


def test_store_prune_deletes_commit_first_and_keeps_pinned(fake_gcs,
                                                           monkeypatch):
    uri = "gs://bkt/gc"
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(uri, step, _state())
    deleted = []
    real_delete = store.GCSStore.delete
    monkeypatch.setattr(store.GCSStore, "delete", lambda self, key: (
        deleted.append(key), real_delete(self, key))[1])
    assert ckpt.prune_checkpoints(uri, keep=1, pinned=2) == [1, 3]
    assert ckpt.committed_steps(uri) == [2, 4]
    for step in (1, 3):
        mine = [k for k in deleted if k.startswith(f"step_{step}/")]
        assert mine[0] == f"step_{step}/COMMIT"
        assert len(mine) == len(set(mine)) > 5
        assert not (fake_gcs / "bkt" / "gc" / f"step_{step}").exists() or \
            _objects(fake_gcs / "bkt" / "gc" / f"step_{step}") == {}
    assert all(not k.startswith(("step_2/", "step_4/")) for k in deleted)
    # retention through save: keep 1, the pinned step survives
    ckpt.save_checkpoint(uri, 5, _state(), keep=1, pinned=2)
    assert ckpt.committed_steps(uri) == [2, 5]
    # an object already gone is deleted
    store.GCSStore(uri).delete("step_1/COMMIT")


FAILING_LS = """#!/bin/bash
if [[ $1 == ls ]]; then
  echo "AccessDeniedException: 403 caller does not have storage.objects.list" >&2
  exit 1
fi
exec "$REAL_FAKE_GSUTIL" "$@"
"""


def test_store_failing_ls_raises(fake_gcs, tmp_path, monkeypatch):
    """A listing that fails for another reason than "matched no objects"
    raises: a resuming trainer must not read it as "no checkpoints" and
    start again from step 0 over the good ones."""
    uri = "gs://bkt/denied"
    ckpt.save_checkpoint(uri, 4, _state())
    bindir = tmp_path / "denied-bin"
    bindir.mkdir()
    gsutil = bindir / "gsutil"
    gsutil.write_text(FAILING_LS)
    gsutil.chmod(gsutil.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("REAL_FAKE_GSUTIL", shutil.which("gsutil"))
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    for call in (lambda: ckpt.latest_step(uri),
                 lambda: ckpt.committed_steps(uri),
                 lambda: ckpt.restore_checkpoint(uri)):
        with pytest.raises(RuntimeError, match="403"):
            call()
    t = _tiny_trainer(uri, data.synthetic_tokens(2, 16, 256), num_steps=1)
    with pytest.raises(RuntimeError, match="403"):
        t.setup()
    assert t.step == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_objects_equal_the_jax_packages(fake_gcs, dtype):
    """The same AdamW state saved to gs:// by both packages: the same
    object keys with the same bytes (bf16 shards under the '<V2' header,
    COMMIT included), the port's tree.json the one extra object."""
    jstate = _jax_adamw_state(getattr(jnp, dtype))
    jckpt.save_checkpoint("gs://bkt/jax", 3, jstate)
    ckpt.save_checkpoint("gs://bkt/port", 3,
                         _port_tree(jax.device_get(jstate)))
    j = _objects(fake_gcs / "bkt" / "jax")
    p = _objects(fake_gcs / "bkt" / "port")
    assert sorted(p) == sorted([*j, "step_3/tree.json"])
    assert "step_3/COMMIT" in j and len(j) > 30
    for key, data_ in j.items():
        assert p[key] == data_, key


def test_jax_restores_a_port_store_checkpoint(fake_gcs):
    """A port AdamW state (f32: the JAX package reads no bf16 leaf) on
    gs://, restored by the JAX package with and without a template."""
    params, opt = _port_state(torch.float32)
    for step in range(2):
        for i, p in enumerate(optim.tree_leaves(params)):
            p.grad = torch.from_numpy(np.random.RandomState(
                10 * step + i).standard_normal(p.shape)).to(p.dtype)
        opt.step()
    state = {"params": params, "opt_state": opt.tree(), "step": 2}
    uri = "gs://bkt/port-adamw"
    ckpt.save_checkpoint(uri, 2, state)
    assert jckpt.latest_step(uri) == 2
    template = _jax_adamw_state(jnp.float32)
    for restored in (jckpt.restore_checkpoint(uri),
                     jckpt.restore_checkpoint(uri, 2, template)):
        assert jax.tree.structure(restored) == jax.tree.structure(template)
        _assert_same_leaves(state, restored)


def test_port_restores_a_sharded_jax_store_checkpoint(fake_gcs):
    """A JAX AdamW state sharded over the 8-device CPU mesh (fsdp on every
    leaf whose first dimension splits 8 ways) saved to gs://: several
    shard objects per leaf, pasted region by region into the port's
    state. Then the step as two processes lay it out (each process's
    files in its own manifest, COMMIT naming both): the same leaves."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:8]), ("fsdp",))

    def place(x):
        if getattr(x, "ndim", 0) and x.shape[0] % 8 == 0:
            return jax.device_put(x, NamedSharding(mesh, P("fsdp")))
        return x
    jstate = jax.tree.map(place, _jax_adamw_state(jnp.float32))
    uri = "gs://bkt/jax-sharded"
    jckpt.save_checkpoint(uri, 2, jstate)
    step_dir = fake_gcs / "bkt" / "jax-sharded" / "step_2"
    manifest = json.loads((step_dir / "manifest_p0.json").read_text())
    per_leaf = {}
    for rec in manifest["shards"]:
        per_leaf[rec["leaf"]] = per_leaf.get(rec["leaf"], 0) + 1
    assert max(per_leaf.values()) == 8
    assert not (step_dir / "tree.json").exists()

    def restored():
        params, opt = _port_state(torch.float32)
        state = ckpt.restore_checkpoint(uri, None, {
            "params": params, "opt_state": opt.tree(), "step": 0})
        opt.load_tree(state["opt_state"])
        return {"params": params, "opt_state": opt.tree(),
                "step": state["step"]}

    _assert_same_leaves(restored(), jstate)
    half = len(manifest["shards"]) // 2
    for p, recs in enumerate((manifest["shards"][:half],
                              manifest["shards"][half:])):
        (step_dir / f"manifest_p{p}.json").write_text(json.dumps(
            {"process": p, "shards": recs}))
    (step_dir / "COMMIT").write_text(json.dumps({"step": 2,
                                                 "processes": 2}))
    _assert_same_leaves(restored(), jstate)


def test_trainer_resumes_from_store_bitwise(fake_gcs):
    """Run A trains 2 steps and commits to gs://; run B resumes it to step
    4 saving every step with keep 1; run C trains 4 steps unbroken. B's
    losses and parameters equal C's bit for bit, and retention keeps the
    pinned step 2 beside step 4."""
    uri = "gs://bkt/trainer"

    def run(ckpt_dir, steps, skip, **extra):
        cfg = llama.get_config("tiny")
        t = trainer.Trainer(
            partial(llama.llama_loss, config=cfg),
            partial(llama.llama_init, cfg),
            _skipped(data.synthetic_tokens(BATCH, SEQ, cfg.vocab_size),
                     skip),
            trainer.TrainerConfig(num_steps=steps, checkpoint_dir=ckpt_dir,
                                  **TRAIN, **extra),
            device="cpu")
        t.run()
        return t

    a = run(uri, 2, 0)
    assert ckpt.committed_steps(uri) == [2]
    b = run(uri, 4, 2, checkpoint_every=1, checkpoint_keep=1)
    c = run("", 4, 0)
    assert [m["step"] for m in b.metrics_history] == [3, 4]
    assert [m["loss"] for m in b.metrics_history] == \
        [m["loss"] for m in c.metrics_history][2:]
    assert [m["loss"] for m in a.metrics_history] == \
        [m["loss"] for m in c.metrics_history][:2]
    for x, y in zip(optim.tree_leaves(b.params), optim.tree_leaves(c.params)):
        assert torch.equal(x, y)
    assert ckpt.committed_steps(uri) == [2, 4]


def test_emergency_checkpoint_on_store(fake_gcs):
    """An error mid-run commits the step it died at on gs://, and the
    error propagates."""
    def poisoned():
        src = data.synthetic_tokens(2, 16, 256)
        for i in range(10_000):
            if i == 3:
                raise RuntimeError("data pipeline exploded")
            yield next(src)

    uri = "gs://bkt/emergency"
    t = _tiny_trainer(uri, poisoned(), checkpoint_every=0)
    with pytest.raises(RuntimeError, match="exploded"):
        t.run()
    assert ckpt.latest_step(uri) == t.step == 3


def test_server_serves_a_store_checkpoint(fake_gcs):
    """`build_server --checkpoint-dir gs://...` on the CPU: the latest
    committed step's params, the greedy tokens of `generate` on them."""
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.serve.__main__ import build_arg_parser, build_server

    params, opt = _port_state(torch.float32)
    uri = "gs://bkt/serve"
    ckpt.save_checkpoint(uri, 4, {"params": params, "opt_state": opt.tree(),
                                  "step": 4})
    server = build_server(build_arg_parser().parse_args(
        ["--device", "cpu", "--config", "tiny", "--checkpoint-dir", uri,
         "--slots", "1", "--token-budget", "32", "--port", "0",
         "--host", "127.0.0.1"]))
    try:
        for x, y in zip(optim.tree_leaves(server.engine.params),
                        optim.tree_leaves(params)):
            assert torch.equal(x, y.detach())
        prompt = [5, 17, 3, 250, 9]
        req = urllib.request.Request(
            server.url + "/v1/generate", data=json.dumps(
                {"prompt": prompt, "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["tokens"]
    finally:
        server.stop(drain_timeout=5)
    with torch.no_grad():
        want = generate({k: v.detach() if isinstance(v, torch.Tensor) else
                         {n: w.detach() for n, w in v.items()}
                         for k, v in params.items()},
                        llama.get_config("tiny"), torch.tensor([prompt]),
                        6)[0].tolist()
    assert got == want


def _tiny_trainer(ckpt_dir, data_iter, num_steps=50, checkpoint_every=1):
    cfg = llama.get_config("tiny")
    return trainer.Trainer(
        partial(llama.llama_loss, config=cfg), partial(llama.llama_init, cfg),
        data_iter,
        trainer.TrainerConfig(num_steps=num_steps,
                              checkpoint_every=checkpoint_every,
                              checkpoint_dir=ckpt_dir, **TRAIN),
        device="cpu")


def test_emergency_checkpoint_on_unhandled_exception(tmp_path):
    """A run that raises mid-epoch commits the step it died at (not just
    the last cadence save), and the error still propagates."""
    def poisoned():
        src = data.synthetic_tokens(2, 16, 256)
        for i in range(10_000):
            if i == 7:
                raise RuntimeError("data pipeline exploded")
            yield next(src)

    d = str(tmp_path / "ck")
    t = _tiny_trainer(d, poisoned(), checkpoint_every=5)
    with pytest.raises(RuntimeError, match="exploded"):
        t.run()
    assert t.step == 7
    assert ckpt.latest_step(d) == 7
    assert not t.preempted


def test_emergency_checkpoint_on_sigterm_exits_preempted(tmp_path):
    """SIGTERM raises TrainerPreempted in the main thread, the emergency
    save commits the current step, and the exit code is EXIT_PREEMPTED."""
    def term_after():
        src = data.synthetic_tokens(2, 16, 256)
        for i in range(10_000):
            if i == 5:
                os.kill(os.getpid(), signal.SIGTERM)
                # the raise lands at a bytecode boundary: give it one
                time.sleep(0.5)
            yield next(src)

    d = str(tmp_path / "ck")
    t = _tiny_trainer(d, term_after())
    old = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(SystemExit) as exc:
            t.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert exc.value.code == C.EXIT_PREEMPTED == 12
    assert t.preempted is True
    assert ckpt.latest_step(d) == t.step == 5


def _cut_update(t, at, action):
    """Make `action()` land inside the `at`-th update of a set-up Trainer:
    after torch's optimizer has written the parameters and moments, before
    the schedule's step and the update count."""
    real = t.opt_state.optimizer.step
    calls = []

    @wraps(real)                    # keeps the lr scheduler's step marker
    def step(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(None)
        if len(calls) == at:
            action()
        return out

    t.opt_state.optimizer.step = step


def _assert_state_equals(restored, t):
    """A template-free restore equals the Trainer's live state, leaf for
    leaf and bit for bit."""
    want = ckpt.flatten_with_paths(t._state())
    got = ckpt.flatten_with_paths(restored)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b.detach().cpu()), path
        else:
            assert a == b, path


def test_sigterm_mid_update_commits_a_whole_step(tmp_path):
    """A SIGTERM that lands inside the optimizer's update is held until
    the update is whole: the emergency save commits the step it finished,
    with its params, moments and counts, equal to an uninterrupted run's
    after as many steps."""
    def term():
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.5)             # the handler runs here, mid-update

    d = str(tmp_path / "ck")
    t = _tiny_trainer(d, data.synthetic_tokens(2, 16, 256),
                      checkpoint_every=0)
    old = signal.getsignal(signal.SIGTERM)
    try:
        t.setup()
        _cut_update(t, 3, term)
        with pytest.raises(SystemExit) as exc:
            t.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    assert exc.value.code == C.EXIT_PREEMPTED
    assert ckpt.latest_step(d) == t.step == 3
    whole = _tiny_trainer("", data.synthetic_tokens(2, 16, 256))
    whole.setup()                   # the same schedule, num_steps 50
    whole.config.num_steps = 3
    whole.run()
    restored = ckpt.restore_checkpoint(d)
    assert restored["opt_state"]["0"]["count"] == 3
    _assert_state_equals(restored, whole)


def test_error_mid_update_commits_nothing(tmp_path):
    """An error that escapes the update part way (parameters written, the
    count not) gets no emergency save: the last committed step stands and
    still restores, and the error propagates."""
    def fault():
        raise RuntimeError("device fault")

    d = str(tmp_path / "ck")
    t = _tiny_trainer(d, data.synthetic_tokens(2, 16, 256),
                      checkpoint_every=2)
    t.setup()
    _cut_update(t, 4, fault)
    with pytest.raises(RuntimeError, match="device fault"):
        t.run()
    assert t.step == 3
    assert ckpt.committed_steps(d) == [2]
    assert ckpt.restore_checkpoint(d)["step"] == 2
