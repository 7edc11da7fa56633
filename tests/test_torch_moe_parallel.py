"""The port's MoE on split meshes (`moe_param_axes`, the expert banks over
`ep`, routing over the global batch) against the JAX package's, on the
CPU.

In a gloo world of 4 ranks (spawned, rendezvous through a file under
tmp_path; the worker functions import no JAX): `moe_tiny` (f32) at
capacity factor 1.25 on fsdp 2 x ep 2, ep 2 x tp 2 and sp 2 x ep 2, with
the sparse and the dense dispatch, on a batch whose routing overflows
some queues (tokens from 8 ids, so tokens drop): the loss (2e-5), the aux
loss summed over the layers (2e-5), every layer's kept mask (exactly) and
every gradient (5e-4) against the JAX package's `moe_loss` on a mesh of
the same shape over the first 4 of the 8 CPU devices (its kept masks
captured from its dispatch under `jax.disable_jit`). Where the batch is
split (fsdp 2), a routing of each rank's own tokens alone keeps another
set, which the test asserts too. Then the entry point: `--config
moe_tiny` on a 2-rank ep gang against the plain run.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

from test_torch_parallel import _join, _spawn

FWD_TOL, GRAD_TOL = 2e-5, 5e-4
BATCH, SEQ, IDS = 4, 16, 8
# (mesh shape, axes, JAX plan, dispatch mode)
CASES = [("2,2", "fsdp,ep", dict(fsdp=2, ep=2), "sparse"),
         ("2,2", "fsdp,ep", dict(fsdp=2, ep=2), "dense"),
         ("2,2", "tp,ep", dict(tp=2, ep=2), "sparse"),
         ("2,2", "tp,ep", dict(tp=2, ep=2), "dense"),
         ("2,2", "sp,ep", dict(sp=2, ep=2), "sparse")]


def _jax():
    import jax
    import jax.numpy as jnp

    from tony_tpu.models import moe as jmoe
    from tony_tpu.parallel import mesh as jmesh

    globals().update(jax=jax, jnp=jnp, jmoe=jmoe, jmesh=jmesh)


def _tokens():
    return np.random.RandomState(0).randint(
        0, IDS, size=(BATCH, SEQ + 1)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _moe_world(rank, world, init, out, jparams, tokens):
    """Each CASES entry on this rank's rows: loss, aux, kept masks, the
    dropped count, the masks a per-rank routing would keep, gathered
    gradients and the expert banks' placements. Rank 0 saves them."""
    import torch.distributed as dist

    from tony_tpu_torch.models import moe
    from tony_tpu_torch.models.convert import params_from_jax
    from tony_tpu_torch.observability.metrics import REGISTRY
    from tony_tpu_torch.parallel import mesh, sharding
    from tony_tpu_torch.train.data import global_batch
    from tony_tpu_torch.train.optim import tree_leaves, tree_map

    _join(rank, world, init)
    route, aux_loss = moe.route, moe.aux_loss
    results = []
    for shape, axes, _, mode in CASES:
        os.environ["TPU_MESH_SHAPE"], os.environ["TPU_MESH_AXES"] = \
            shape, axes
        m = mesh.mesh_from_env("cpu")
        cfg = moe.get_moe_config("moe_tiny", dispatch_mode=mode)
        params = sharding.shard_pytree(
            tree_map(torch.clone, params_from_jax(jparams, cfg, "cpu")),
            moe.moe_param_axes(cfg), m)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        plan = mesh.plan_from_env(world)[0].shape
        shards = plan.get("dp", 1) * plan.get("fsdp", 1)
        rows = BATCH // shards
        idx = mesh.data_index(world, rank)
        routed, auxes = [], []

        def spy_route(xt, router, config):
            r = route(xt, router, config)
            routed.append((xt.detach(), router.detach(), r))
            return r

        def spy_aux(r, config):
            a = aux_loss(r, config)
            auxes.append(float(a))
            return a

        moe.route, moe.aux_loss = spy_route, spy_aux
        counted = [REGISTRY.counter(moe.EXPERT_ROWS_EXECUTED).value,
                   REGISTRY.counter(moe.EXPERT_ROWS_ROUTED).value]
        try:
            batch = global_batch({"tokens": torch.from_numpy(
                tokens[idx * rows:(idx + 1) * rows]).long()}, m)
            loss = moe.moe_loss(params, batch, cfg)
        finally:
            moe.route, moe.aux_loss = route, aux_loss
        counted = [REGISTRY.counter(moe.EXPERT_ROWS_EXECUTED).value
                   - counted[0],
                   REGISTRY.counter(moe.EXPERT_ROWS_ROUTED).value
                   - counted[1]]
        loss.backward()
        keeps, dropped, per_rank_differs = [], 0, 0
        for xt, router, r in routed:
            keeps.append(r.keep.numpy().copy())
            dropped += int(((r.gates > 0) & ~r.keep).sum())
            if shards > 1:
                # this rank's tokens routed alone
                own = slice(idx * rows * SEQ, (idx + 1) * rows * SEQ)
                alone = route(xt[own], router, cfg)
                per_rank_differs += int((alone.keep != r.keep[own]).sum())
        grads = {p: leaf.grad.full_tensor().numpy().copy()
                 for p, leaf in _flat(params).items()}
        results.append({
            "loss": loss.item(), "aux": sum(auxes), "keeps": keeps,
            "rows": counted, "capacities": [r.capacity for *_, r in routed],
            "dropped": dropped, "per_rank_differs": per_rank_differs,
            "grads": grads,
            "we_gate": (tuple(params["layers"]["we_gate"].placements),
                        tuple(params["layers"]["we_gate"].grad.placements))})
    if rank == 0:
        torch.save(results, os.path.join(out, "rank0.pt"))
    else:
        torch.save(None, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _jax_case(jparams, tokens, plan, mode, monkeypatch):
    """JAX's moe_loss and gradients on the mesh (jitted), its aux loss,
    and its kept masks from its dispatch (`jax.disable_jit`)."""
    jcfg = jmoe.get_moe_config("moe_tiny", dispatch_mode=mode)
    n = 1
    for k in plan.values():
        n *= k
    jm = jmesh.make_mesh(jmesh.plan_mesh(n, **plan), jax.devices()[:n])
    batch = {"tokens": jnp.asarray(tokens)}
    with jax.set_mesh(jm):
        loss, grads = jax.jit(jax.value_and_grad(
            partial(jmoe.moe_loss, config=jcfg)))(jparams, batch)
    _, aux = jmoe.moe_hidden(jparams, batch["tokens"][:, :-1], jcfg)
    keeps = []
    name = "_dense_dispatch" if mode == "dense" else "_sparse_dispatch"
    orig = getattr(jmoe, name)

    def spy(xt, layer, gates, keep, *rest):
        keeps.append(np.asarray(keep))
        return orig(xt, layer, gates, keep, *rest)

    with monkeypatch.context() as mp_:
        mp_.setattr(jmoe, name, spy)
        with jax.disable_jit():
            jmoe.moe_loss(jparams, batch, jcfg)
    return float(loss), float(aux), keeps, jax.device_get(grads)


def test_moe_on_split_meshes_matches_jax(tmp_path, monkeypatch):
    """Each CASES mesh and dispatch, one 4-rank world, against the JAX
    package on a mesh of the same shape: loss, aux loss, kept masks and
    gradients; tokens dropped at cf 1.25; a routing per rank keeps
    another set where the batch is split; the expert banks split over ep
    (dim 1), and their gradients placed as they are."""
    _jax()
    jcfg = jmoe.get_moe_config("moe_tiny")
    jparams = jax.device_get(jmoe.moe_init(jcfg, jax.random.PRNGKey(0)))
    tokens = _tokens()
    got, wants = _spawn(
        _moe_world, 4, tmp_path, jparams, tokens,
        meanwhile=lambda: [_jax_case(jparams, tokens, plan, mode,
                                     monkeypatch)
                           for _, _, plan, mode in CASES])
    for (shape, axes, _, mode), res, (jloss, jaux, jkeeps, jgrads) in zip(
            CASES, got[0], wants):
        label = f"{axes}={shape} {mode}"
        np.testing.assert_allclose(res["loss"], jloss, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=label)
        np.testing.assert_allclose(res["aux"], jaux, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=label)
        assert len(res["keeps"]) == len(jkeeps) == jcfg.n_layers, label
        for layer, (a, b) in enumerate(zip(res["keeps"], jkeeps)):
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {layer}")
        assert res["dropped"] > 0, f"{label}: no token dropped"
        # each layer's rows counted once, from the global T = B * S
        n_tokens = BATCH * SEQ
        assert res["capacities"] == [int(jcfg.capacity_factor * n_tokens
                                         * jcfg.top_k / jcfg.n_experts)
                                     ] * jcfg.n_layers, label
        assert res["rows"] == [
            jcfg.n_layers * jcfg.n_experts * res["capacities"][0],
            jcfg.n_layers * n_tokens * jcfg.top_k], label
        if "fsdp" in axes:
            assert res["per_rank_differs"] > 0, label
        jflat = _flat(jgrads)
        assert set(jflat) == set(res["grads"]), label
        for path, g in jflat.items():
            np.testing.assert_allclose(res["grads"][path], np.asarray(g),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{label} {path}")
        placed, grad_placed = res["we_gate"]
        assert placed == grad_placed, (label, res["we_gate"])
        ep = axes.split(",").index("ep")
        assert placed[ep].is_shard() and placed[ep].dim == 1, placed


ENTRY_ARGS = ["--device", "cpu", "--config", "moe_tiny", "--steps", "2",
              "--batch-size", "2", "--seq-len", "16", "--log-every", "1"]


def _entry_world(rank, world, init, out):
    """The entry point's Trainer on an ep gang of `world` ranks."""
    import torch.distributed as dist

    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    os.environ.update(TPU_MESH_SHAPE=str(world), TPU_MESH_AXES="ep",
                      INIT_METHOD=init, RANK=str(rank), WORLD=str(world))
    torch.set_num_threads(1)
    t, _ = build_trainer(build_arg_parser().parse_args(ENTRY_ARGS))
    t.run()
    torch.save([m["loss"] for m in t.metrics_history],
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_entry_point_trains_moe_on_an_ep_gang(tmp_path):
    """`--config moe_tiny` on a 2-rank gang with TPU_MESH_AXES=ep (the
    experts split in two): both ranks log the plain one-process run's
    losses."""
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    got = _spawn(_entry_world, 2, tmp_path)[0]
    plain, _ = build_trainer(build_arg_parser().parse_args(ENTRY_ARGS))
    plain.run()
    want = [m["loss"] for m in plain.metrics_history]
    assert got[0] == got[1] and len(want) == 2
    np.testing.assert_allclose(got[0], want, rtol=FWD_TOL)


@pytest.mark.parametrize("plan", [dict(ep=2), dict(fsdp=2), dict(tp=2),
                                  dict(ep=2, tp=2, fsdp=2)], ids=str)
def test_moe_param_axes_match_jax(plan):
    """The port's logical axes of every MoE leaf equal the JAX package's,
    and so do the mesh axes they give on each mesh."""
    _jax()
    from tony_tpu.parallel import sharding as jsharding
    from tony_tpu_torch.models import moe
    from tony_tpu_torch.parallel import sharding

    mine = _flat(moe.moe_param_axes(moe.get_moe_config("moe_tiny")))
    theirs = _flat(jmoe.moe_param_axes(jmoe.get_moe_config("moe_tiny")))
    assert mine == {k: tuple(v) for k, v in theirs.items()}
    n = 1
    for k in plan.values():
        n *= k
    jm = jmesh.make_mesh(jmesh.plan_mesh(n, **plan), jax.devices()[:n])
    for path, logical in mine.items():
        assert sharding.logical_to_spec(logical, axis_names=jm.axis_names) \
            == tuple(jsharding.logical_to_mesh_axes(logical, mesh=jm)), path
