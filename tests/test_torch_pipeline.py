"""The port's pipeline parallelism (tony_tpu_torch/parallel/pipeline.py and
`llama_loss_pipelined`) against the JAX package's, on the CPU.

Without processes: the tick plan (`_sched_fwd`, `_sched_bwd`,
`_exit_ticks`, `interleaved_ticks`), the chunk layout
(`interleave_stage_dim`) and the microbatch split case for case against
the JAX functions, the wave invariants of tests/test_pipeline.py on the
port's own plan, and `LocalStages` (every stage in one process, the
one-process seam) against JAX's pipelined loss and gradients.

In a gloo world of 4 ranks (spawned, rendezvous through a file under
tmp_path; the worker functions import no JAX): the pipelined tiny Llama
(f32, 4 layers) on pp 4 (M 4 and M 1), pp 2 x fsdp 2, pp 2 x tp 2, pp 2 x
sp 2 (ring, then Ulysses) and, interleaved (v 2), on pp 2 x fsdp 2 and pp
2 x sp 2, its loss (2e-5) and every gradient (5e-4) against the JAX
package's `llama_loss_pipelined` on a mesh of the same shape over the
first 4 of the 8 CPU devices; the plain loss on a pp 2 x fsdp 2 mesh
against JAX's plain loss; a checkpoint written by the pipelined Trainer
on pp 2 x fsdp 2, read back bit for bit by the port on one process and by
the JAX package. Then the entry point: `--pp-micro 2 --pp-virtual 2` on a
2-rank pp gang against the plain run, and an MoE preset with
`--pp-micro` on a pp mesh exiting as the JAX script exits.
"""

import logging
import os
from functools import partial

import numpy as np
import pytest
import torch

from tony_tpu_torch.parallel import pipeline
from test_torch_parallel import _join, _spawn

FWD_TOL, GRAD_TOL = 2e-5, 5e-4
LAYERS, BATCH, SEQ = 4, 8, 32


def _jax():
    import jax
    import jax.numpy as jnp

    from tony_tpu.models import llama as jllama
    from tony_tpu.parallel import mesh as jmesh
    from tony_tpu.parallel import pipeline as jpipe

    globals().update(jax=jax, jnp=jnp, jllama=jllama, jmesh=jmesh,
                     jpipe=jpipe)


# ---------------------------------------------------------------------------
# the tick plan and the layout, without processes
# ---------------------------------------------------------------------------

PLANS = [(8, 4, 2), (4, 2, 2), (8, 2, 4), (4, 4, 1), (1, 4, 1), (3, 2, 1),
         (6, 3, 2), (2, 1, 3)]


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_tick_plan_matches_jax(plan):
    """Every (tick, device) of both phases: valid, chunk and microbatch as
    the JAX package's schedule gives them; the phase length and the exit
    ticks too."""
    _jax()
    M, n, v = plan
    T = pipeline.interleaved_ticks(M, n, v)
    assert T == jpipe.interleaved_ticks(M, n, v)
    assert pipeline._exit_ticks(M, n, v) == \
        [int(x) for x in jpipe._exit_ticks(M, n, v)]
    for mine, theirs in ((pipeline._sched_fwd, jpipe._sched_fwd),
                         (pipeline._sched_bwd, jpipe._sched_bwd)):
        for t in range(T):
            for d in range(n):
                got = mine(t, d, M, n, v)
                want = tuple(int(x) for x in theirs(t, d, M, n, v))
                assert (int(got[0]), got[1], got[2]) == want, (t, d)


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_wave_invariants_of_the_ports_plan(plan):
    """tests/test_pipeline.py's invariants on the port's plan: each
    (chunk, microbatch) slot runs once on every device, virtual stage s
    consumes s-1's output one tick after it was made on the sending
    device (mirrored in the backward), and each backward slot's saved
    input is the one its forward slot kept."""
    M, n, v = plan
    T = pipeline.interleaved_ticks(M, n, v)
    fwd_tick = {}
    for sched, direction in ((pipeline._sched_fwd, +1),
                             (pipeline._sched_bwd, -1)):
        seen = {}
        for t in range(T):
            for d in range(n):
                valid, j, m = sched(t, d, M, n, v)
                if valid:
                    assert (j, m, d) not in seen
                    seen[(j, m, d)] = t
        assert len(seen) == M * v * n
        for (j, m, d), t in seen.items():
            if direction == +1:
                s = j * n + d
                if s == 0:
                    continue
                pj, pd = (s - 1) // n, (s - 1) % n
            else:
                if j == v - 1 and d == n - 1:
                    continue
                succ = j * n + d + 1
                pj, pd = succ // n, succ % n
                if pj >= v:
                    continue
            assert seen.get((pj, m, pd)) == t - 1, (j, m, d, t, direction)
        if direction == +1:
            fwd_tick = seen
        else:
            for (j, m, d) in seen:
                assert pipeline._saved_tick(j, m, d, n, v) == \
                    fwd_tick[(j, m, d)]


@pytest.mark.parametrize("n,v", [(2, 2), (4, 2), (2, 4), (3, 1)])
def test_interleave_stage_dim_matches_jax(n, v):
    """The chunk layout equals the JAX package's, and each device's
    contiguous slice of it holds the layers `virtual_stage_layers`
    names."""
    _jax()
    per = 2
    stacked = np.arange(n * v * per * 3, dtype=np.float32).reshape(
        n * v, per, 3)
    got = pipeline.interleave_stage_dim({"w": torch.from_numpy(stacked)},
                                        n, v)["w"].numpy()
    want = np.asarray(jpipe.interleave_stage_dim({"w": stacked}, n, v)["w"])
    np.testing.assert_array_equal(got, want)
    layers = got.reshape(n * v * per, 3)[:, 0] / 3
    for d in range(n):
        mine = layers[d * v * per:(d + 1) * v * per].astype(int).tolist()
        assert mine == pipeline.virtual_stage_layers(d, n, v, per)
    with pytest.raises(ValueError, match="stage dim"):
        pipeline.interleave_stage_dim(torch.zeros(n * v + 1, 2), n, v)


def test_microbatch_split_merge_and_stack_match_jax():
    _jax()
    x = np.arange(12 * 3, dtype=np.float32).reshape(12, 3)
    got = pipeline.split_microbatches(torch.from_numpy(x), 4)
    want = jpipe.split_microbatches(jnp.asarray(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pipeline.merge_microbatches(got).numpy(), x)
    for mod, arr in ((pipeline, torch.zeros(10, 3)),
                     (jpipe, jnp.zeros((10, 3)))):
        with pytest.raises(ValueError, match="not divisible by n_micro 4"):
            mod.split_microbatches(arr, 4)
    stages = [{"w": np.full((2, 2), i, np.float32)} for i in range(3)]
    np.testing.assert_array_equal(
        pipeline.stack_stage_params([{"w": torch.from_numpy(s["w"])}
                                     for s in stages])["w"].numpy(),
        np.asarray(jpipe.stack_stage_params(stages)["w"]))


def test_the_interleaved_schedule_needs_divisible_microbatches():
    _jax()
    jm = jmesh.make_mesh(jmesh.plan_mesh(2, pp=2), jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jpipe.make_pipelined_fn(lambda p, x: x, jm, n_micro=3, n_virtual=2)
    with pytest.raises(ValueError) as got:
        pipeline.make_pipelined_fn(lambda p, x: x, pipeline.LocalStages(2),
                                   n_micro=3, n_virtual=2)
    assert str(got.value) == str(want.value)


def _tokens(seed=1):
    return np.random.RandomState(seed).randint(
        0, 256, size=(BATCH, SEQ + 1)).astype(np.int32)


def _jax_pipelined(jparams, tokens, plan, n_micro, n_virtual, sp_mode="ring",
                   pipelined=True):
    """(loss, grads) of the JAX package's pipelined (or plain) loss on a
    mesh of `plan` over the first devices, jitted under that mesh."""
    jcfg = jllama.get_config("tiny", n_layers=LAYERS, sp_mode=sp_mode)
    n = 1
    for k in plan.values():
        n *= k
    jm = jmesh.make_mesh(jmesh.plan_mesh(n, **plan), jax.devices()[:n])
    loss = (partial(jllama.llama_loss_pipelined, config=jcfg, mesh=jm,
                    n_micro=n_micro, n_virtual=n_virtual) if pipelined
            else partial(jllama.llama_loss, config=jcfg))
    with jax.set_mesh(jm):
        value, grads = jax.jit(jax.value_and_grad(loss))(
            jparams, {"tokens": jnp.asarray(tokens)})
    return float(value), jax.device_get(grads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _check(got, want, label):
    loss, grads = got
    jloss, jgrads = want
    np.testing.assert_allclose(loss, jloss, rtol=FWD_TOL, atol=FWD_TOL,
                               err_msg=label)
    jgrads = _flat(jgrads)
    assert set(grads) == set(jgrads), label
    for path, g in jgrads.items():
        np.testing.assert_allclose(grads[path], np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{label} {path}")


@pytest.mark.parametrize("n,n_micro,v,remat", [(4, 4, 1, False),
                                               (2, 4, 2, True)])
def test_local_stages_match_jax(n, n_micro, v, remat):
    """Every stage in this process (`LocalStages`, copies for the sends:
    the seam `chip_smoke.py` drives on one card), save_flash remat in the
    stages or none: loss and gradients against the JAX package's
    pipelined loss on a pp = n mesh."""
    _jax()
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.models.convert import params_from_jax
    from tony_tpu_torch.train.optim import tree_leaves

    jparams, tokens = _jax_params_layers(), _tokens()
    cfg = llama.get_config("tiny", n_layers=LAYERS, remat=remat)
    params = params_from_jax(jparams, cfg, "cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss = llama.llama_loss_pipelined(
        params, {"tokens": torch.from_numpy(tokens).long()}, cfg,
        pipeline.LocalStages(n), n_micro, n_virtual=v)
    loss.backward()
    got = (loss.item(), {p: leaf.grad.numpy() for p, leaf in
                         _flat(params).items()})
    _check(got, _jax_pipelined(jparams, tokens, {"pp": n}, n_micro, v),
           f"local n={n} M={n_micro} v={v}")


def test_pipelined_forward_matches_jax():
    """`llama_forward_pipelined` on two local stages, interleaved (v 2):
    the f32 logits against the JAX package's on a pp = 2 mesh (2e-5)."""
    _jax()
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.models.convert import params_from_jax

    jparams, tokens = _jax_params_layers(), _tokens()[:, :-1]
    jcfg = jllama.get_config("tiny", n_layers=LAYERS)
    jm = jmesh.make_mesh(jmesh.plan_mesh(2, pp=2), jax.devices()[:2])
    with jax.set_mesh(jm):
        want = jax.jit(partial(jllama.llama_forward_pipelined, config=jcfg,
                               mesh=jm, n_micro=2, n_virtual=2))(
            jparams, jnp.asarray(tokens))
    cfg = llama.get_config("tiny", n_layers=LAYERS)
    got = llama.llama_forward_pipelined(
        params_from_jax(jparams, cfg, "cpu"),
        torch.from_numpy(tokens).long(), cfg, pipeline.LocalStages(2), 2,
        n_virtual=2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def _jax_params_layers():
    jcfg = jllama.get_config("tiny", n_layers=LAYERS)
    return jax.device_get(jllama.llama_init(jcfg, jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# a gloo world of 4 ranks
# ---------------------------------------------------------------------------

# (mesh shape, axes, JAX plan, n_micro, n_virtual, sp_mode, pipelined)
CASES = [
    ("4", "pp", dict(pp=4), 4, 1, "ring", True),
    ("4", "pp", dict(pp=4), 1, 1, "ring", True),
    ("2,2", "fsdp,pp", dict(pp=2, fsdp=2), 2, 1, "ring", True),
    ("2,2", "tp,pp", dict(pp=2, tp=2), 2, 1, "ring", True),
    ("2,2", "sp,pp", dict(pp=2, sp=2), 2, 1, "ring", True),
    ("2,2", "sp,pp", dict(pp=2, sp=2), 2, 1, "ulysses", True),
    ("2,2", "fsdp,pp", dict(pp=2, fsdp=2), 2, 2, "ring", True),
    ("2,2", "sp,pp", dict(pp=2, sp=2), 2, 2, "ring", True),
    ("2,2", "fsdp,pp", dict(pp=2, fsdp=2), 0, 1, "ring", False),
]
CKPT_TRAIN = dict(log_every=1, learning_rate=1e-2, warmup_steps=1,
                  prefetch_depth=0)


def _rows(world, rank, tokens):
    from tony_tpu_torch.parallel import mesh

    plan = mesh.plan_from_env(world)[0].shape
    rows = tokens.shape[0] // (plan.get("dp", 1) * plan.get("fsdp", 1))
    idx = mesh.data_index(world, rank)
    return tokens[idx * rows:(idx + 1) * rows]


def _pipeline_world(rank, world, init, out, jparams, tokens, root):
    """Each CASES entry: the loss and the gathered gradients on this
    rank's rows of the global batch; the pp neighbours and the stage
    gradients' placements; then the pipelined Trainer's checkpoint on pp
    2 x fsdp 2. Rank 0 saves what the test compares."""
    import torch.distributed as dist

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.models.convert import params_from_jax
    from tony_tpu_torch.parallel import mesh, sharding
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.data import global_batch
    from tony_tpu_torch.train.optim import tree_leaves, tree_map

    _join(rank, world, init)
    results = []
    for shape, axes, _, n_micro, v, sp_mode, pipelined in CASES:
        os.environ["TPU_MESH_SHAPE"], os.environ["TPU_MESH_AXES"] = \
            shape, axes
        m = mesh.mesh_from_env("cpu")
        cfg = llama.get_config("tiny", n_layers=LAYERS, sp_mode=sp_mode,
                               remat=True)
        params = sharding.shard_pytree(
            tree_map(torch.clone, params_from_jax(jparams, cfg, "cpu")),
            llama.llama_param_axes(cfg), m)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        batch = global_batch({"tokens": torch.from_numpy(
            _rows(world, rank, tokens)).long()}, m)
        if pipelined:
            loss = llama.llama_loss_pipelined(params, batch, cfg, m,
                                              n_micro, n_virtual=v)
        else:
            loss = llama.llama_loss(params, batch, cfg)
        loss.backward()
        grads = {p: leaf.grad.full_tensor().numpy().copy()
                 for p, leaf in _flat(params).items()}
        peers = None
        if "pp" in axes:
            group = m.get_group("pp")
            n, me = dist.get_world_size(group), dist.get_rank(group)
            peers = (mesh.pp_neighbours(m),
                     (dist.get_global_rank(group, (me - 1) % n),
                      dist.get_global_rank(group, (me + 1) % n)))
        placed = (tuple(params["layers"]["wq"].grad.placements),
                  tuple(params["layers"]["wq"].placements))
        results.append((loss.item(), grads, peers, placed))
    applied = _apply_on_the_pp_group(dist, mesh)
    # the pipelined Trainer on pp 2 x fsdp 2: one step, then the final
    # checkpoint
    os.environ["TPU_MESH_SHAPE"], os.environ["TPU_MESH_AXES"] = \
        "2,2", "fsdp,pp"
    cfg = llama.get_config("tiny", n_layers=LAYERS)
    t = trainer.Trainer(
        partial(llama.llama_loss_pipelined, config=cfg, n_micro=2),
        lambda _g: tree_map(torch.clone, params_from_jax(jparams, cfg,
                                                         "cpu")),
        iter([{"tokens": _rows(world, rank, tokens)}]),
        trainer.TrainerConfig(num_steps=1, checkpoint_dir=root,
                              **CKPT_TRAIN),
        device="cpu", param_axes=llama.llama_param_axes(cfg),
        loss_takes_mesh=True)
    t.run()
    state = {"params": tree_map(
        lambda p: p.full_tensor().detach().clone(), t.params),
        "loss": t.metrics_history[0]["loss"]}
    if rank == 0:
        torch.save({"cases": results, "trained": state,
                    "applied": applied},
                   os.path.join(out, "rank0.pt"))
    else:
        torch.save(None, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


APPLY_DIM, APPLY_STAGES = 8, 4


def _apply_inputs():
    """Weights of 2 * APPLY_STAGES tanh stages, microbatches (M 4, mb 3)
    and the cotangent of the output."""
    gen = torch.Generator().manual_seed(5)
    d, n = APPLY_DIM, 2 * APPLY_STAGES
    return (torch.randn(n, d, d, generator=gen) / d ** 0.5,
            torch.randn(n, d, generator=gen) * 0.1,
            torch.randn(4, 3, d, generator=gen),
            torch.randn(4, 3, d, generator=gen))


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"].reshape(APPLY_DIM, APPLY_DIM)
                      + p["b"].reshape(APPLY_DIM))


def _apply_on_the_pp_group(dist, mesh):
    """`pipeline_apply` (stage d: weights d) and
    `pipeline_apply_interleaved` (v 2: chunk j of stage d is virtual
    stage j * 4 + d) on a pp 4 mesh: each rank's output, and every rank's
    weight gradients gathered, with the input's gradient, for sum(out *
    g)."""
    os.environ["TPU_MESH_SHAPE"], os.environ["TPU_MESH_AXES"] = "4", "pp"
    m = mesh.mesh_from_env("cpu")
    group = m.get_group("pp")
    me = dist.get_rank(group)
    w, b, x, g = _apply_inputs()
    out = {}
    for v in (1, 2):
        layers = [j * APPLY_STAGES + me for j in range(v)]
        params = {"w": w[layers].clone().requires_grad_(),
                  "b": b[layers].clone().requires_grad_()}
        if v == 1:
            params = {k: p[0].detach().requires_grad_()
                      for k, p in params.items()}
        xl = x.clone().requires_grad_()
        if v == 1:
            y = pipeline.pipeline_apply(_tanh_stage, group, params, xl)
        else:
            y = pipeline.pipeline_apply_interleaved(_tanh_stage, group, v,
                                                    params, xl)
        (y * g).sum().backward()
        grads = {}
        for k, p in params.items():
            parts = [torch.empty_like(p.grad) for _ in range(APPLY_STAGES)]
            dist.all_gather(parts, p.grad.contiguous(), group=group)
            grads[k] = parts
        out[v] = (y.detach(), xl.grad, grads)
    return out


def _check_applied(applied):
    """`pipeline_apply` and its interleaved form on a 4-rank pp group
    against the stages applied in sequence: the output, the input's and
    every weight's gradient (f32, 1e-6)."""
    w, b, x, g = _apply_inputs()
    for v, (y, dx, grads) in applied.items():
        ws, bs = w.clone().requires_grad_(), b.clone().requires_grad_()
        xs = x.clone().requires_grad_()
        h = xs
        for s in range(v * APPLY_STAGES):
            h = _tanh_stage({"w": ws[s], "b": bs[s]}, h)
        (h * g).sum().backward()
        torch.testing.assert_close(y, h.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dx, xs.grad, rtol=1e-6, atol=1e-6)
        for d in range(APPLY_STAGES):
            layers = [j * APPLY_STAGES + d for j in range(v)]
            for k, ref in (("w", ws.grad), ("b", bs.grad)):
                got = grads[k][d].reshape(ref[layers].shape)
                torch.testing.assert_close(got, ref[layers], rtol=1e-6,
                                           atol=1e-6, msg=f"v={v} {k} {d}")


def test_pipelined_llama_matches_jax_on_each_mesh(tmp_path):
    """Each CASES mesh, one 4-rank world: the loss and every gradient
    against the JAX package on a mesh of the same shape. The stage
    weights' gradients keep their parameter's placements (split over pp);
    the pp neighbours are the group's ring peers. The pipelined Trainer's
    checkpoint (pp 2 x fsdp 2, every leaf f32) reads back bit for bit in
    the port on one process and in the JAX package."""
    _jax()
    from test_torch_checkpoint import _assert_same_leaves

    from tony_tpu.train import checkpoint as jckpt
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.train import checkpoint as ckpt
    from tony_tpu_torch.train import trainer

    jparams, tokens = _jax_params_layers(), _tokens()
    root = tmp_path / "ckpt"
    got, wants = _spawn(
        _pipeline_world, 4, tmp_path, jparams, tokens, str(root),
        meanwhile=lambda: [
            _jax_pipelined(jparams, tokens, plan, n_micro, v, sp_mode,
                           pipelined)
            for _, _, plan, n_micro, v, sp_mode, pipelined in CASES])
    got = got[0]
    for case, (loss, grads, peers, placed), want in zip(CASES, got["cases"],
                                                        wants):
        label = f"{case[1]}={case[0]} M={case[3]} v={case[4]} {case[5]}"
        _check((loss, grads), want, label)
        grad_placed, param_placed = placed
        assert grad_placed == param_placed, (label, placed)
        if peers is not None:
            assert peers[0] == peers[1], (label, peers)
    assert any(p.is_shard() and p.dim == 0 for p in got["cases"][2][3][1])
    _check_applied(got["applied"])
    # the checkpoint: the port on one process and the JAX package
    trained = got["trained"]
    assert np.isfinite(trained["loss"])
    restored = ckpt.restore_checkpoint(str(root))
    assert restored["step"] == 1
    for path, leaf in _flat(trained["params"]).items():
        back = _flat(restored["params"])[path]
        assert back.dtype == torch.float32
        assert torch.equal(back, leaf), path
    _assert_same_leaves(restored, jckpt.restore_checkpoint(str(root), 1))
    cfg = llama.get_config("tiny", n_layers=LAYERS)
    t = trainer.Trainer(
        partial(llama.llama_loss, config=cfg), partial(llama.llama_init, cfg),
        iter(()), trainer.TrainerConfig(num_steps=1, checkpoint_dir=str(
            root), **CKPT_TRAIN), device="cpu")
    t.setup()
    t._global_data_iter = None
    assert t.step == 1 and t.mesh is None
    for path, leaf in _flat(t.params).items():
        assert torch.equal(leaf.detach(), _flat(trained["params"])[path])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

ENTRY_ARGS = ["--device", "cpu", "--config", "tiny", "--n-layers",
              str(LAYERS), "--steps", "2", "--batch-size", "4",
              "--seq-len", "16", "--log-every", "1"]


def _entry_world(rank, world, init, out, extra):
    """The entry point's Trainer on a pp gang of `world` ranks."""
    import torch.distributed as dist

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    os.environ.update(TPU_MESH_SHAPE=str(world), TPU_MESH_AXES="pp",
                      INIT_METHOD=init, RANK=str(rank), WORLD=str(world))
    torch.set_num_threads(1)
    t, _ = build_trainer(build_arg_parser().parse_args(ENTRY_ARGS + extra))
    assert t.loss_fn.func is llama.llama_loss_pipelined
    assert t.loss_takes_mesh
    t.run()
    torch.save([m["loss"] for m in t.metrics_history],
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_entry_point_trains_a_pp_gang(tmp_path):
    """`--pp-micro 2 --pp-virtual 2` on a 2-rank gang with
    TPU_MESH_AXES=pp: every rank logs the plain one-process run's losses
    (the pp ranks hold the same rows)."""
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    got = _spawn(_entry_world, 2, tmp_path,
                 ["--pp-micro", "2", "--pp-virtual", "2"])[0]
    plain, _ = build_trainer(build_arg_parser().parse_args(ENTRY_ARGS))
    plain.run()
    want = [m["loss"] for m in plain.metrics_history]
    assert got[0] == got[1] and len(want) == 2
    np.testing.assert_allclose(got[0], want, rtol=FWD_TOL)


def test_entry_point_pipeline_flags_as_the_jax_script(monkeypatch, caplog):
    """An MoE preset with --pp-micro on a pp mesh exits with the JAX
    script's message; --pp-micro on a mesh with no pp axis warns and
    trains the plain loss; a pp axis of 1 still selects the pipeline."""
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    def build(*flags):
        return build_trainer(build_arg_parser().parse_args(
            ["--device", "cpu", "--steps", "1", *flags]))[0]

    monkeypatch.setenv("TPU_MESH_AXES", "fsdp,pp")
    with pytest.raises(SystemExit, match="pipelined training is the "
                       "dense-Llama path; MoE scales via the ep/fsdp axes"):
        build("--config", "moe_tiny", "--pp-micro", "2")
    t = build("--pp-micro", "2", "--pp-virtual", "2")
    assert t.loss_fn.func is llama.llama_loss_pipelined and \
        t.loss_takes_mesh
    assert t.loss_fn.keywords["n_micro"] == 2
    assert t.loss_fn.keywords["n_virtual"] == 2
    monkeypatch.setenv("TPU_MESH_AXES", "fsdp")
    with caplog.at_level(logging.WARNING):
        t = build("--pp-micro", "2")
    assert t.loss_fn.func is llama.llama_loss and not t.loss_takes_mesh
    assert "training WITHOUT pipeline parallelism" in caplog.text
