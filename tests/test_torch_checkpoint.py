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
"""

import json
import os
import shutil
import signal
import time
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


def test_gs_directory_raises(tmp_path):
    uri = "gs://bucket/ckpts"
    for call in (lambda: ckpt.save_checkpoint(uri, 1, _state()),
                 lambda: ckpt.latest_step(uri),
                 lambda: ckpt.restore_checkpoint(uri, 1),
                 lambda: ckpt.AsyncCheckpointer(uri)):
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            call()
    cfg = llama.get_config("tiny")
    t = trainer.Trainer(
        partial(llama.llama_loss, config=cfg), partial(llama.llama_init, cfg),
        data.synthetic_tokens(2, 8, cfg.vocab_size),
        trainer.TrainerConfig(num_steps=1, checkpoint_dir=uri), device="cpu")
    with pytest.raises(NotImplementedError, match="gs://"):
        t.setup()


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
