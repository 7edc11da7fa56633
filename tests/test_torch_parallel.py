"""The port's parallel layer (tony_tpu_torch/parallel) against the JAX
package's, on the CPU.

Without processes: the mesh plans, the env mesh, the multi-slice
ordering and the logical-axis rules against the JAX functions on the same
inputs. In gloo worlds of 2 and 4 ranks (started with the `spawn` method:
this process already runs JAX's threads; rendezvous through a file under
tmp_path, so parallel test workers never share a port): ring and Ulysses
attention against the JAX `ring_attention_sharded` /
`ulysses_attention_sharded` on the 8-CPU mesh (f32: 2e-5 forward, 5e-4
gradients, as tests/test_parallel.py), one `tiny` train step on each
mesh against the JAX Trainer on the same mesh (loss 2e-5, params 5e-4),
the optimizer state's sharding, and the entry point as a gang under the
pytorch and the jax runtime's env.
"""

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from functools import partial

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tony_tpu_torch.parallel import mesh, sharding

# The JAX side is imported by the tests that use it (`_jax()` puts its
# modules into this module's namespace), not at import: the spawned ranks
# import this module for their worker functions and need torch alone.


def _jax():
    import jax
    import jax.numpy as jnp

    from tony_tpu.models import llama as jllama
    from tony_tpu.parallel import mesh as jmesh
    from tony_tpu.parallel import sharding as jsharding
    from tony_tpu.parallel.ring import ring_attention_sharded as jring
    from tony_tpu.parallel.ulysses import (
        ulysses_attention_sharded as julysses,
    )
    from tony_tpu.train.trainer import Trainer as JaxTrainer
    from tony_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    globals().update(jax=jax, jnp=jnp, jllama=jllama, jmesh=jmesh,
                     jsharding=jsharding, jring=jring, julysses=julysses,
                     JaxTrainer=JaxTrainer,
                     JaxTrainerConfig=JaxTrainerConfig)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# how long a spawned world may run before its ranks are killed
SPAWN_TIMEOUT_S = 300
FWD_TOL, GRAD_TOL = 2e-5, 5e-4
LOSS_TOL, PARAM_TOL = 2e-5, 5e-4
# one tiny train step: global batch rows, sequence, the JAX Trainer's knobs
BATCH, SEQ = 4, 16
TRAIN = dict(num_steps=1, log_every=1, learning_rate=1e-2, warmup_steps=1,
             prefetch_depth=0)
# the train-step meshes, (shape, axes): 4 ranks each but fsdp alone
MESHES = (("2", "fsdp"), ("2,2", "fsdp,tp"), ("2,2", "dp,fsdp"),
          ("2,2", "fsdp,sp"))


# ---------------------------------------------------------------------------
# without processes
# ---------------------------------------------------------------------------

PLANS = [dict(n=8, tp=2), dict(n=8, tp=2, sp=2, dp=2), dict(n=8, tp=3),
         dict(n=8, fsdp=4), dict(n=8, dp=2), dict(n=8, dp=3),
         dict(n=8, fsdp=3), dict(n=8, dp=2, fsdp=2),
         dict(n=8, dp=2, fsdp=4), dict(n=4, sp=4), dict(n=1)]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", PLANS, ids=lambda c: str(c))
def test_plan_mesh_matches_jax(case):
    _jax()
    kw = dict(case)
    n = kw.pop("n")
    want = _outcome(lambda: jmesh.plan_mesh(n, **kw))
    got = _outcome(lambda: mesh.plan_mesh(n, **kw))
    if isinstance(want, tuple):
        assert got == want
        return
    assert got.shape == want.shape
    assert got.axis_names == want.axis_names
    assert got.num_devices == want.num_devices and got.dims() == want.dims()
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.MeshPlan({"xp": 2})


@pytest.mark.parametrize("shape,axes,slices", [
    ("", "", "1"), ("2,2,2", "dp,fsdp,tp", "1"), ("4,2", "fsdp,tp", "1"),
    ("2,4", "dp,fsdp", "2"), ("2,2", "dp,fsdp", "1"), ("2,2", "dp", "1")])
def test_mesh_from_env_matches_jax(monkeypatch, shape, axes, slices):
    _jax()
    for name, value in (("TPU_MESH_SHAPE", shape), ("TPU_MESH_AXES", axes),
                        ("TPU_NUM_SLICES", slices)):
        monkeypatch.setenv(name, value)
    want = _outcome(lambda: jmesh.mesh_from_env(jax.devices()))
    got = _outcome(lambda: mesh.env_rank_grid(8))
    if isinstance(want, tuple):
        assert got == want
        return
    plan, grid = got
    assert plan.axis_names == want.axis_names
    ids = np.vectorize(lambda d: d.id)(want.devices)
    # a single-slice CPU mesh: devices in jax.devices() order, ids 0..7
    assert np.array_equal(grid, ids)


class _FakeDev:
    def __init__(self, i, s):
        self.id = i
        self.slice_index = s


@pytest.mark.parametrize("slice_of,plan", [
    ([i % 2 for i in range(8)], dict(tp=2, dp=2, fsdp=2)),
    ([i // 4 for i in range(8)], dict(tp=2, dp=2, fsdp=2)),
    ([i // 4 for i in range(8)], dict(dp=1, fsdp=4, tp=2)),
    ([i // 2 for i in range(8)], dict(dp=4, tp=2)),
    ([i // 4 for i in range(8)], dict(tp=4, dp=1, fsdp=1)),
    ([0, 0, 0, 1, 1, 1, 1, 1], dict(dp=2, fsdp=2)),
    ([i // 4 for i in range(8)], dict(sp=8)),
])
def test_hybrid_ordering_matches_jax(slice_of, plan):
    """Ranks in slices (the fake devices of tests/test_parallel.py): the
    same grid of ids, or the same error."""
    _jax()
    n = len(slice_of)
    kw = dict(plan)
    jplan = jmesh.plan_mesh(min(n, _prod(kw) or n), **kw) \
        if _prod(kw) <= n else None
    devs = [_FakeDev(i, s) for i, s in enumerate(slice_of)]
    want = _outcome(lambda: np.vectorize(lambda d: d.id)(
        jmesh.make_hybrid_mesh(jplan, devs).devices))
    pplan = mesh.plan_mesh(jplan.num_devices, **kw)
    got = _outcome(lambda: mesh.hybrid_rank_grid(pplan, slice_of))
    if isinstance(want, tuple):
        assert got == want
    else:
        assert np.array_equal(got, want)


def _prod(kw):
    out = 1
    for v in kw.values():
        out *= v
    return out


def test_slices_are_the_executors_ceil_div_blocks():
    assert mesh.slice_of_ranks(8, 2) == [0] * 4 + [1] * 4
    assert mesh.slice_of_ranks(7, 2) == [0] * 4 + [1] * 3
    assert mesh.slice_of_ranks(3, 1) == [0, 0, 0]


JAX_MESHES = [dict(tp=2), dict(tp=2, fsdp=2), dict(sp=4, dp=2, fsdp=1),
              dict(dp=8)]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("plan", JAX_MESHES, ids=str)
def test_param_rules_match_jax_partition_specs(plan):
    """Every leaf of llama_param_axes('tiny'), and the activation axes the
    forward constrains: the port's spec is the JAX PartitionSpec, and its
    placements shard tensor dim d over exactly the mesh axes (of size > 1)
    that the spec puts there."""
    _jax()
    from tony_tpu_torch.models.llama import get_config, llama_param_axes

    jm = jmesh.make_mesh(jmesh.plan_mesh(8, **plan))
    axes = dict(_leaves(llama_param_axes(get_config("tiny"))))
    assert axes == dict(_leaves(jllama.llama_param_axes(
        jllama.get_config("tiny"))))
    extra = {("act", str(i)): a for i, a in enumerate([
        ("batch", "seq", None), ("batch", "heads", "seq", None),
        ("batch", "seq", "mlp"), ("batch", "seq", "vocab"),
        ("batch", "seq"), ("embed", "embed"), ("vocab", None)])}

    class _Mesh:           # the placements need names and sizes only
        mesh_dim_names = jm.axis_names

        @staticmethod
        def size(i):
            return jm.devices.shape[i]

    for path, logical in {**axes, **extra}.items():
        want = jsharding.logical_to_mesh_axes(logical, mesh=jm)
        spec = sharding.logical_to_spec(logical, axis_names=jm.axis_names)
        assert spec == tuple(want), (path, spec, want)
        placements = sharding.spec_to_placements(spec, _Mesh)
        for i, name in enumerate(jm.axis_names):
            dims = [d for d, e in enumerate(want)
                    if name == e or (isinstance(e, tuple) and name in e)]
            p = placements[i]
            if dims and _Mesh.size(i) > 1:
                assert p.is_shard() and p.dim == dims[0], (path, name, p)
            else:
                assert p.is_replicate(), (path, name, p)
    small = jmesh.make_mesh(jmesh.MeshPlan({"dp": 8}))
    assert sharding.logical_to_spec(("vocab", "embed"), axis_names=(
        "dp",)) == tuple(jsharding.logical_to_mesh_axes(
            ("vocab", "embed"), mesh=small)) == ()


def test_opt_state_specs_follow_param_paths():
    """f32 masters and Adam moments take their parameter's placements;
    the counts take none."""
    from torch.distributed.tensor import Replicate, Shard

    from tony_tpu_torch.train.optim import adamw
    from tony_tpu_torch.train.precision import with_f32_master

    params = {"embed": torch.zeros(16, 8, requires_grad=True),
              "layers": {"wq": torch.zeros(4, 8, 8, requires_grad=True)}}
    pspecs = {"embed": (Shard(1), Shard(0)),
              "layers": {"wq": (Shard(1), Shard(2))}}
    state = with_f32_master(adamw(lambda n: 1e-3)).init(params)
    specs = sharding.opt_state_specs(state.tree(), pspecs)
    assert specs["master"] == pspecs
    adam = specs["inner"][0]
    assert adam.mu == pspecs and adam.nu == pspecs
    assert adam.count is None and specs["inner"][2].count is None
    assert Replicate() not in pspecs["embed"]


def test_a_mesh_without_a_rendezvous_raises(monkeypatch):
    from tony_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    for name in ("WORLD", "RANK", "INIT_METHOD", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("TPU_MESH_SHAPE", raising=False)
    assert maybe_initialize_distributed(torch.device("cpu")) is False
    monkeypatch.setenv("TPU_MESH_SHAPE", "2")
    monkeypatch.setenv("TPU_MESH_AXES", "sp")
    with pytest.raises(RuntimeError, match="no rendezvous env"):
        maybe_initialize_distributed(torch.device("cpu"))


def test_sequence_parallel_without_a_group_raises():
    from tony_tpu_torch.parallel.ring import ring_attention
    from tony_tpu_torch.parallel.ulysses import ulysses_attention

    q = torch.zeros(1, 2, 8, 16)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError, match="sp process group"):
            fn(q, q, q, None, causal=True)


def test_rendezvous_env_reads_either_runtime():
    from tony_tpu_torch.parallel.distributed import (
        backend_for, gang, rendezvous_env,
    )
    assert rendezvous_env({}) is None and gang({}) == (1, 0)
    assert rendezvous_env({"INIT_METHOD": "tcp://h:1", "RANK": "1",
                           "WORLD": "2"}) == ("tcp://h:1", 1, 2)
    assert rendezvous_env({"JAX_COORDINATOR_ADDRESS": "h:2",
                           "JAX_PROCESS_ID": "3",
                           "JAX_NUM_PROCESSES": "4"}) == ("tcp://h:2", 3, 4)
    assert gang({"JAX_COORDINATOR_ADDRESS": "h:2", "JAX_PROCESS_ID": "3",
                 "JAX_NUM_PROCESSES": "4"}) == (4, 3)
    # torch's own env:// reads MASTER_ADDR/MASTER_PORT
    assert rendezvous_env({"WORLD": "2", "RANK": "1"}) == ("env://", 1, 2)
    assert backend_for(torch.device("cuda")) == "nccl"
    assert backend_for(torch.device("cpu")) == "gloo"


# ---------------------------------------------------------------------------
# gloo worlds
# ---------------------------------------------------------------------------

def _spawn(fn, world: int, tmp_path, *args, meanwhile=None):
    """Run fn(rank, world, init_method, out_dir, *args) on `world` spawned
    ranks; rank r's results land in tmp_path/out/rank{r}.pt. `meanwhile()`
    (the JAX side of a comparison) runs in this process while the ranks
    do; returns (the ranks' results, what `meanwhile` returned)."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    init = f"file://{tmp_path / 'rendezvous'}"
    ctx = mp.start_processes(fn, args=(world, init, str(out)) + args,
                             nprocs=world, start_method="spawn",
                             join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        theirs = meanwhile() if meanwhile is not None else None
    finally:
        # a rank stuck in a collective must fail the test, not hang the
        # suite: past the deadline every rank is killed
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)], theirs


def _join(rank, world, init):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SPAWN_TIMEOUT_S))


def _qkv(b, h, hk, s, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d),
                          (b, h, s, d))]


# (mesh dims, flavour, causal, (B, H, Hkv, S, D)); the ring streams
# narrow GQA K/V, Ulysses takes K/V with Q's heads
ATTN_CASES = [((("sp", 4),), "ring", True, (2, 4, 2, 64, 16)),
              ((("sp", 4),), "ring", False, (2, 4, 2, 64, 16)),
              ((("dp", 2), ("sp", 2)), "ring", True, (2, 2, 2, 64, 16)),
              ((("sp", 4),), "ulysses", True, (2, 4, 4, 64, 16)),
              ((("sp", 4),), "ulysses", False, (2, 4, 4, 64, 16)),
              ((("dp", 2), ("sp", 2)), "ulysses", True, (2, 4, 4, 64, 16))]


def _attention_world(rank, world, init, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from tony_tpu_torch.ops.attention import kernel_placements
    from tony_tpu_torch.parallel.ring import ring_attention_sharded
    from tony_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    _join(rank, world, init)
    results = []
    for i, (dims, flavour, causal, shape) in enumerate(ATTN_CASES):
        names = tuple(n for n, _ in dims)
        m = DeviceMesh("cpu", torch.arange(world).reshape(
            [k for _, k in dims]), mesh_dim_names=names)
        q, k, v, g = (torch.from_numpy(x) for x in _qkv(*shape, seed=i))
        places = kernel_placements(m, q.shape[0], q.shape[1], k.shape[1],
                                   seq_axis="sp")
        qd, kd, vd = (distribute_tensor(x, m, places).requires_grad_()
                      for x in (q, k, v))
        fn = ring_attention_sharded if flavour == "ring" \
            else ulysses_attention_sharded
        o = fn(qd, kd, vd, causal=causal)
        (o * distribute_tensor(g, m, places)).sum().backward()
        results.append([o.full_tensor().detach().numpy()] + [
            x.grad.full_tensor().numpy() for x in (qd, kd, vd)])
    # a kernel that fails inside a chunk is not caught: the ring raises
    # (on every rank at its first chunk, so no rank waits on a rotation)
    from tony_tpu_torch.parallel import ring

    def failing(*args, **kwargs):
        raise RuntimeError("chunk kernel failed")

    ring.blockwise_forward = failing
    try:
        ring_attention_sharded(qd, kd, vd, causal=True)
        raised = False
    except RuntimeError as e:
        raised = "chunk kernel failed" in str(e)
    results.append(raised)
    if rank == 0:
        torch.save(results, os.path.join(out, "rank0.pt"))
    else:
        torch.save(None, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_ring_and_ulysses_match_jax(tmp_path):
    """sp = 4 and sp = 2 (beside dp = 2), causal and dense, one 4-rank
    world: out and the q, k, v gradients of sum(out * g) against the JAX
    package's sharded ring and Ulysses on the 8-CPU mesh. Then a chunk
    whose kernel fails: the ring raises, nothing falls back."""
    _jax()
    got, wants = _spawn(_attention_world, 4, tmp_path,
                        meanwhile=_jax_attention)
    assert got[0][-1] is True, "a failing chunk kernel was swallowed"
    for i, want in enumerate(wants):
        for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got[0][i],
                                   want, (FWD_TOL, GRAD_TOL, GRAD_TOL,
                                          GRAD_TOL)):
            np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol,
                                       err_msg=f"case {i} {name}")


def _jax_attention():
    """The JAX package's sharded ring and Ulysses on each case: out and
    the gradients of sum(out * g), jitted."""
    wants = []
    for i, (dims, flavour, causal, shape) in enumerate(ATTN_CASES):
        q, k, v, g = (jnp.asarray(x) for x in _qkv(*shape, seed=i))
        plan = dict(dims)
        jm = jmesh.make_mesh(jmesh.plan_mesh(
            8, sp=plan["sp"], dp=8 // plan["sp"], fsdp=1))
        jfn = jring if flavour == "ring" else julysses

        def loss(q, k, v):
            out = jfn(q, k, v, jm, causal=causal)
            return jnp.sum(out * g), out

        (_, want_o), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        wants.append([want_o] + list(grads))
    return wants


def _jax_params():
    jcfg = jllama.get_config("tiny")
    return jax.device_get(jllama.llama_init(jcfg, jax.random.PRNGKey(0)))


def _batch(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, size=(BATCH, SEQ + 1)).astype(np.int32)


def _train_world(rank, world, init, out, jparams, tokens, runs):
    """One tiny train step per (mesh shape, axes, sp_mode), each rank fed
    its rows of the global batch; rank 0 saves (loss, params after the
    step, placements)."""
    import torch.distributed as dist

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.models.convert import params_from_jax
    from tony_tpu_torch.parallel.mesh import data_index
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.optim import tree_leaves, tree_map

    _join(rank, world, init)
    results = []
    for shape, axes, sp_mode in runs:
        # save_flash remat, as the presets train on the card: the
        # selective checkpoint replays every DTensor op of a block
        cfg = llama.get_config("tiny", sp_mode=sp_mode, remat=True)
        os.environ["TPU_MESH_SHAPE"], os.environ["TPU_MESH_AXES"] = \
            shape, axes
        n = mesh.plan_from_env(world)[0].num_devices
        if rank >= n:
            # a mesh over fewer ranks: every rank takes part in making
            # its process groups, and those outside it sit the step out
            mesh.mesh_from_env("cpu")
            continue
        idx = data_index(n, rank)
        shards = mesh.plan_from_env(world)[0].shape
        rows = BATCH // (shards.get("dp", 1) * shards.get("fsdp", 1))
        local = tokens[idx * rows:(idx + 1) * rows]
        t = trainer.Trainer(
            partial(llama.llama_loss, config=cfg),
            # fresh tensors: an unsplit leaf would share the arrays' memory
            # and the updates would reach the next run's start
            lambda _g: tree_map(torch.clone,
                                params_from_jax(jparams, cfg, "cpu")),
            iter([{"tokens": local}]),
            trainer.TrainerConfig(**TRAIN), device="cpu",
            param_axes=llama.llama_param_axes(cfg))
        t.run()
        # a copy: a replicated leaf's full_tensor() is the parameter itself
        params = tree_map(lambda p: p.full_tensor().detach().numpy().copy(),
                          t.params)
        adam = t.opt_state.tree()[0]
        # AdamW on DTensors stays elementwise: one more update (on the
        # grads of ones) issues no collective, and each rank steps its
        # own LambdaLR
        from torch.distributed.tensor.debug import CommDebugMode
        for p in tree_leaves(t.params):
            p.grad = torch.ones_like(p)
        with CommDebugMode() as comm:
            t.opt_state.step()
        placed = {"update_collectives": comm.get_total_counts(),
                  "lr_position": t.opt_state.scheduler.last_epoch,
                  "param": tuple(t.params["layers"]["wq"].placements),
                  "mu": tuple(adam.mu["layers"]["wq"].placements),
                  "nu": tuple(adam.nu["embed"].placements),
                  "param_embed": tuple(t.params["embed"].placements)}
        results.append((t.metrics_history[0]["loss"], params, placed))
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _jax_step(monkeypatch, shape, axes, jparams, tokens):
    monkeypatch.setenv("TPU_MESH_SHAPE", shape)
    monkeypatch.setenv("TPU_MESH_AXES", axes)
    jcfg = jllama.get_config("tiny")
    t = JaxTrainer(partial(jllama.llama_loss, config=jcfg),
                   lambda _key: jparams, iter([{"tokens": tokens}]),
                   JaxTrainerConfig(**TRAIN),
                   param_axes=jllama.llama_param_axes(jcfg))
    t.run()
    return t.metrics_history[0]["loss"], jax.device_get(t.params)


def _check_step(got, want, label):
    loss, params, placed = got
    jloss, jparams = want
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL, atol=LOSS_TOL,
                               err_msg=label)
    for path, leaf in _leaves(params):
        ref = jparams
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(leaf, np.asarray(ref), atol=PARAM_TOL,
                                   rtol=PARAM_TOL,
                                   err_msg=f"{label} {'/'.join(path)}")


def test_train_step_on_each_mesh_matches_jax(tmp_path, monkeypatch):
    """fsdp=2, fsdp=2 x tp=2, dp=2 x fsdp=2 and fsdp=2 x sp=2 (the ring,
    then Ulysses), each one tiny step from the JAX Trainer's initial
    parameters on the same global batch: the loss and every parameter
    after the AdamW update against the JAX Trainer on the same mesh (its
    ring for both of the port's sp flavours). The Adam moments carry
    their parameter's placements: sharded, never replicated."""
    _jax()
    jparams, tokens = _jax_params(), _batch()
    runs = [(shape, axes, "ring") for shape, axes in MESHES] + [
        MESHES[-1] + ("ulysses",)]
    got, want = _spawn(_train_world, 4, tmp_path, jparams, tokens, runs,
                       meanwhile=lambda: {
                           (shape, axes): _jax_step(monkeypatch, shape, axes,
                                                    jparams, tokens)
                           for shape, axes in MESHES})
    got = got[0]
    assert len(got) == len(runs)
    for (shape, axes, sp_mode), result in zip(runs, got):
        _check_step(result, want[shape, axes], f"{axes}={shape} {sp_mode}")
        placed = result[2]
        assert placed["mu"] == placed["param"], placed
        assert placed["update_collectives"] == 0, placed
        assert placed["lr_position"] == 2, placed
        if "fsdp" in axes:
            # wq ("layers", "embed", "heads"): embed over fsdp
            assert any(p.is_shard() for p in placed["param"]), placed
            assert any(p.is_shard() for p in placed["nu"]), placed


# ---------------------------------------------------------------------------
# the entry point as a gang
# ---------------------------------------------------------------------------

ENTRY_ARGS = ["--device", "cpu", "--config", "tiny", "--steps", "3",
              "--batch-size", "2", "--seq-len", "16", "--log-every", "1"]
ENTRY_MESH = {"TPU_MESH_SHAPE": "2", "TPU_MESH_AXES": "fsdp"}


def _entry_world(rank, world, init, out):
    """The entry point's Trainer in-process on each rank, its own
    rendezvous from the pytorch runtime's env (a file init method)."""
    import torch.distributed as dist

    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    os.environ.update(ENTRY_MESH, INIT_METHOD=init, RANK=str(rank),
                      WORLD=str(world))
    torch.set_num_threads(1)
    t, _ = build_trainer(build_arg_parser().parse_args(ENTRY_ARGS))
    t.run()
    assert dist.get_backend() == "gloo"
    torch.save([m["loss"] for m in t.metrics_history],
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang(env_of) -> list[float]:
    """`python -m tony_tpu_torch.train` as 2 processes; rank 0's step
    losses, parsed from its step lines."""
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, TONY_LOG_PLAIN="1",
                   OMP_NUM_THREADS="1", **ENTRY_MESH, **env_of(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.train", *ENTRY_ARGS],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
        assert o.strip().splitlines()[-1].startswith("final loss ")
    lines = [line for line in outs[0][1].splitlines() if " loss " in line
             and "step " in line]
    assert not [line for line in outs[1][1].splitlines()
                if "step 1 loss" in line], "only rank 0 logs the step line"
    return [float(line.split(" loss ")[1].split()[0]) for line in lines]


def test_entry_point_as_a_gang_under_either_runtimes_env(tmp_path):
    """The same 2-rank fsdp run three ways: in-process ranks joined
    through the rendezvous of the pytorch env (a file init method), then
    `python -m tony_tpu_torch.train` as 2 processes under the env the
    executor's pytorch runtime renders, and under the jax runtime's: the
    same losses, bit for bit."""
    want = _spawn(_entry_world, 2, tmp_path)[0]
    assert want[0] == want[1] and len(want[0]) == 3
    port = _free_port()
    torch_env = _gang(lambda r: {"INIT_METHOD": f"tcp://127.0.0.1:{port}",
                                 "RANK": str(r), "WORLD": "2"})
    port = _free_port()
    jax_env = _gang(lambda r: {
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_PROCESS_ID": str(r), "JAX_NUM_PROCESSES": "2"})
    assert [f"{x:.9g}" for x in want[0]] == [f"{x:.9g}" for x in torch_env]
    assert torch_env == jax_env


# ---------------------------------------------------------------------------
# sharded checkpoints (the test is tests/test_torch_checkpoint.py's; the
# worker lives here, in a module the ranks import without JAX)
# ---------------------------------------------------------------------------

CKPT_BATCH, CKPT_SEQ = 8, 16
CKPT_TRAIN = dict(log_every=1, learning_rate=1e-2, warmup_steps=1,
                  prefetch_depth=0)


def _rows(rank_rows, skip):
    """The rows `rank_rows` of the JAX package's synthetic stream's global
    batches (synthetic_tokens(8, 16, 256), bit-identical in the port),
    after `skip` batches."""
    from tony_tpu_torch.train.data import synthetic_tokens

    it = synthetic_tokens(CKPT_BATCH, CKPT_SEQ, 256)
    for _ in range(skip):
        next(it)
    for b in it:
        yield {"tokens": b["tokens"][rank_rows]}


def _gathered(tree):
    """A state tree with every DTensor gathered whole (a plain copy)."""
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_gathered(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(
            vals)
    if hasattr(tree, "full_tensor"):
        return tree.full_tensor().detach().clone()
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _ckpt_world(rank, world, init, out, root, jax_dir):
    """fsdp = 2 tiny f32: run A (2 steps, saved), run C (4 steps
    unbroken), run B (A's step 2 resumed to 4), run J (the JAX package's
    2-device step 2 resumed to 4), run A again onto gs://. Rank 0 saves
    what the test compares."""
    import torch.distributed as dist

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.train import trainer

    os.environ.update(TPU_MESH_SHAPE="2", TPU_MESH_AXES="fsdp")
    _join(rank, world, init)
    cfg = llama.get_config("tiny")
    rows = slice(rank * CKPT_BATCH // 2, (rank + 1) * CKPT_BATCH // 2)

    def run(steps, ckpt_dir, skip):
        t = trainer.Trainer(
            partial(llama.llama_loss, config=cfg),
            partial(llama.llama_init, cfg), _rows(rows, skip),
            trainer.TrainerConfig(num_steps=steps, checkpoint_dir=ckpt_dir,
                                  **CKPT_TRAIN),
            device="cpu", param_axes=llama.llama_param_axes(cfg))
        t.run()
        state = _gathered({"params": t.params,
                           "opt_state": dict(enumerate(t.opt_state.tree()))})
        return [m["loss"] for m in t.metrics_history], state, t

    a_losses, a_state, a = run(2, os.path.join(root, "a"), 0)
    placed = {str(p.placements) for p in
              (a.params["embed"], a.params["layers"]["wq"])}
    if rank == 0:
        import shutil
        shutil.copytree(os.path.join(root, "a"), os.path.join(root, "b"))
        # the JAX run's step 2 alone (it went on to commit step 4)
        shutil.copytree(os.path.join(jax_dir, "step_2"),
                        os.path.join(root, "j", "step_2"))
    dist.barrier()
    c_losses, c_state, _ = run(4, "", 0)
    b_losses, b_state, b = run(4, os.path.join(root, "b"), 2)
    j_losses, _, j = run(4, os.path.join(root, "j"), 2)
    # run A again onto a gs:// directory (the test's gsutil stand-in):
    # every rank uploads its files, rank 0 the COMMIT marker
    run(2, "gs://bucket/gang", 0)
    if rank == 0:
        torch.save({"a": (a_losses, a_state), "c": (c_losses, c_state),
                    "b": (b_losses, b_state), "j": j_losses,
                    "resumed_steps": ([m["step"] for m in
                                       b.metrics_history],
                                      [m["step"] for m in
                                       j.metrics_history]),
                    "placements": placed},
                   os.path.join(out, "rank0.pt"))
    else:
        torch.save(None, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_cli_submit_runs_the_port_as_a_two_rank_gang(tmp_path):
    """`python -m tony_tpu.cli submit` with two workers under the pytorch
    framework, the mesh through tony.execution.env: each worker execs
    `python -m tony_tpu_torch.train` on the rendezvous env its executor
    rendered, and both finish their steps and exit 0."""
    script = tmp_path / "train_gang.py"
    script.write_text(
        "import os, sys\n"
        "os.execv(sys.executable, [sys.executable, '-m', "
        "'tony_tpu_torch.train', '--device', 'cpu', '--config', 'tiny', "
        "'--steps', '2', '--batch-size', '2', '--seq-len', '16', "
        "'--log-every', '1'])\n")
    workdir = tmp_path / "cluster"
    conf = {"tony.worker.instances": "2",
            "tony.application.framework": "pytorch",
            "tony.cluster.workdir": str(workdir),
            "tony.task.heartbeat-interval-ms": "200",
            "tony.am.monitor-interval-ms": "200",
            "tony.am.stop-poll-timeout-ms": "2000",
            "tony.application.timeout": "240000"}
    argv = [sys.executable, "-m", "tony_tpu.cli", "submit", "--executes",
            str(script)]
    for k, v in conf.items():
        argv += ["--conf", f"{k}={v}"]
    for k, v in ENTRY_MESH.items():
        argv += ["--conf", f"tony.execution.env={k}={v}"]
    argv += ["--conf", "tony.execution.env=OMP_NUM_THREADS=1"]
    out = subprocess.run(argv, cwd=tmp_path, capture_output=True, text=True,
                         timeout=280, env=dict(os.environ, PYTHONPATH=REPO))
    logs = {}
    for d, _, files in os.walk(workdir):
        for f in files:
            if f in ("stdout", "stderr"):
                with open(os.path.join(d, f)) as fh:
                    logs[os.path.join(d, f)] = fh.read()
    worker_out = [text for path, text in logs.items()
                  if f"containers{os.sep}worker_" in path
                  and path.endswith("stdout")]
    assert out.returncode == 0, (out.stderr[-3000:], logs)
    assert len(worker_out) == 2 and all(
        "final loss " in text for text in worker_out), logs
    assert any("init_process_group(gloo" in text
               for path, text in logs.items() if path.endswith("stderr")), \
        logs
