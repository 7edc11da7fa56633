"""The port's image zoo and small models (tony_tpu_torch/models/{vit,
resnet,mnist,linear}.py), their data streams and their TonY example entry
points (tony_tpu_torch/examples/) against the JAX package's, on the CPU.

The JAX inits make the weights (zero leaves such as the ViT head made
random, so every gradient is exercised), `tree_from_jax` carries them
over, and both packages see the same seeded numpy inputs. Tolerances are
the reference's: f32 forward 2e-5 (tests/test_ops.py:33), gradients and
Trainer losses and parameters 5e-4 (:49). The data streams are held bit
for bit.

Multi-rank cases run in one gloo world of 2 ranks started with the
`spawn` method (`test_torch_parallel._spawn`): `train_allreduce`'s
Horovod-style rendezvous from CLUSTER_SPEC against the single-process run
on the global batch, and `vit_tiny` on fsdp 2 and tp 2 meshes against the
JAX Trainer on the same meshes. The rank functions live here, so this
module imports no JAX at its top (`_jax()` imports it for the tests).
"""

import json
import os
import socket
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from test_torch_parallel import _spawn
from tony_tpu_torch.models import linear, mnist, resnet, vit
from tony_tpu_torch.models.convert import tree_from_jax
from tony_tpu_torch.train import data
from tony_tpu_torch.train.checkpoint import flatten_with_paths
from tony_tpu_torch.train.optim import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL, GRAD_TOL = 2e-5, 5e-4
LOSS_TOL, PARAM_TOL = 5e-4, 5e-4


def _jax():
    import jax
    import jax.numpy as jnp

    from tony_tpu.models import linear as jlinear
    from tony_tpu.models import mnist as jmnist
    from tony_tpu.models import resnet as jresnet
    from tony_tpu.models import vit as jvit
    from tony_tpu.train import data as jdata

    globals().update(jax=jax, jnp=jnp, jlinear=jlinear, jmnist=jmnist,
                     jresnet=jresnet, jvit=jvit, jdata=jdata)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _randomize_zeros(tree, seed):
    """Zero leaves (the ViT head and CLS, biases) made small random ones,
    so their gradients and the products they feed are exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        if not np.any(a) else a, _np_tree(tree))


def _hold(jax_fn, port_fn, jparams, port_params, args, label):
    """The forward's output within FWD_TOL, and the gradient of its sum
    (or of the loss) within GRAD_TOL, every parameter."""
    want = np.asarray(jax.jit(jax_fn)(jparams, *args))
    leaves = flatten_with_paths(port_params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    got = port_fn(port_params, *[
        {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
        if isinstance(a, dict) else torch.from_numpy(np.asarray(a))
        for a in args])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_TOL,
                               atol=FWD_TOL, err_msg=f"{label} forward")
    got.sum().backward()
    jgrads = dict(flatten_with_paths(_np_tree(jax.jit(jax.grad(
        lambda p, a: jnp.sum(jax_fn(p, *a))))(jparams, args))))
    for path, leaf in leaves:
        np.testing.assert_allclose(
            leaf.grad.numpy(), jgrads[path], rtol=GRAD_TOL, atol=GRAD_TOL,
            err_msg=f"{label} gradient {'/'.join(path)}")


# ---------------------------------------------------------------------------
# the data streams, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,process_index", [(0, 0), (3, 1)])
def test_synthetic_streams_equal_the_jax_packages(seed, process_index):
    _jax()
    for port, ref in (
            (data.synthetic_mnist(16, seed, process_index),
             jdata.synthetic_mnist(16, seed, process_index)),
            (data.synthetic_linreg(16, 10, seed, process_index),
             jdata.synthetic_linreg(16, 10, seed, process_index))):
        for _ in range(3):
            got, want = next(port), next(ref)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# ResNet: XLA's SAME padding, GroupNorm, the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", [7, 8], ids=["odd", "even"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_conv_same_matches_xla(side, k, stride):
    """`conv_same` against `lax.conv_general_dilated(..., "SAME")`: a 3x3
    stride-2 conv on an even side pads 0 before and 1 after."""
    _jax()
    rng = np.random.RandomState(side + 10 * k + stride)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)

    def xla(params, x):
        return jax.lax.conv_general_dilated(
            x, params["w"], (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _hold(xla, lambda p, x: resnet.conv_same(x, p["w"], stride), {"w": w},
          {"w": torch.from_numpy(w)}, (x,), f"conv k{k} s{stride}")
    if (side, k, stride) == (8, 3, 2):
        assert resnet.same_padding(side, k, stride) == (0, 1)


@pytest.mark.parametrize("channels", [16, 12])
def test_group_norm_matches_jax(channels):
    """Statistics in f32 per sample and group; 12 channels with 8 groups
    lowers the count to 6, the largest divisor."""
    _jax()
    rng = np.random.RandomState(channels)
    x = rng.standard_normal((2, 5, 4, channels)).astype(np.float32)
    p = {"scale": rng.standard_normal(channels).astype(np.float32),
         "bias": rng.standard_normal(channels).astype(np.float32)}
    _hold(lambda p, x: jresnet._group_norm(x, p["scale"], p["bias"], 8),
          lambda p, x: resnet._group_norm(x, p["scale"], p["bias"], 8),
          p, {k: torch.from_numpy(v) for k, v in p.items()}, (x,),
          f"group norm C{channels}")


def _resnet_pair(**overrides):
    jcfg = jresnet.get_resnet_config("resnet_tiny", **overrides)
    cfg = resnet.get_resnet_config("resnet_tiny", **overrides)
    jp = _np_tree(jresnet.resnet_init(jcfg, jax.random.PRNGKey(0)))
    like = resnet.resnet_init(cfg, torch.Generator().manual_seed(0))
    return jcfg, cfg, jp, tree_from_jax(jp, "cpu", like=like)


# the smallest |pre-ReLU| value a gradient comparison needs: f32 rounding
# moves the logits by ~1e-6 (both packages against float64), and a value
# within that of 0 takes the ReLU's other branch in one package, which
# changes the gradients upstream of it by O(1e-3)
RELU_MARGIN = 1e-5
# (side, numpy seed) of the images: an even and an odd side for the
# stride-2 SAME convs, seeds whose pre-activations all clear RELU_MARGIN
RESNET_INPUTS = ((28, 34), (27, 31))


def _relu_margin(monkeypatch, tp, images):
    """The smallest |x| entering a ReLU in the port's float64 forward."""
    seen = []
    relu = resnet.F.relu

    def spy(x, *a, **k):
        seen.append(float(x.abs().min()))
        return relu(x, *a, **k)

    monkeypatch.setattr(resnet.F, "relu", spy)
    resnet.resnet_forward(
        tree_map(lambda t: t.double(), tp),
        torch.from_numpy(images).double(),
        resnet.get_resnet_config("resnet_tiny", dtype=torch.float64))
    monkeypatch.setattr(resnet.F, "relu", relu)
    return min(seen)


@pytest.mark.parametrize("side,seed", RESNET_INPUTS, ids=["even", "odd"])
def test_resnet_tiny_matches_jax(side, seed, monkeypatch):
    """resnet_tiny's logits and loss, and their gradients (the stride-2
    stages at an even and an odd side), against the JAX package's. ReLU
    has a kink at 0: the test first asserts that no pre-activation lies
    within RELU_MARGIN of it (the MoE tests' routing margins, for the
    same reason)."""
    _jax()
    jcfg, cfg, jp, tp = _resnet_pair()
    images = np.random.RandomState(seed).standard_normal(
        (2, side, side, 1)).astype(np.float32)
    labels = np.array([1, 9], np.int32)
    margin = _relu_margin(monkeypatch, tp, images)
    print(f"side {side}: smallest |pre-ReLU| {margin:.3e}")
    assert margin > RELU_MARGIN
    _hold(partial(jresnet.resnet_forward, config=jcfg),
          partial(resnet.resnet_forward, config=cfg), jp, tp, (images,),
          f"resnet_tiny {side}")
    batch = {"images": images.reshape(2, -1) if side == 28 else images,
             "labels": labels}
    _hold(partial(jresnet.resnet_loss, config=jcfg),
          partial(resnet.resnet_loss, config=cfg), jp, tp, (batch,),
          f"resnet_tiny loss {side}")
    assert float(resnet.resnet_accuracy(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)) == \
        pytest.approx(float(jresnet.resnet_accuracy(jp, batch, jcfg)))


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", [{}, dict(image_size=28, patch_size=7,
                                               in_channels=1)],
                         ids=["32/4", "mnist 28/7"])
def test_vit_tiny_matches_jax(geometry):
    """vit_tiny's logits (non-causal attention, the tanh GELU, the CLS
    row) and loss, and their gradients, at its own geometry and at the
    allreduce example's mnist geometry (flat images)."""
    _jax()
    jcfg = jvit.get_config("vit_tiny", **geometry)
    cfg = vit.get_config("vit_tiny", **geometry)
    jp = _randomize_zeros(jvit.vit_init(jcfg, jax.random.PRNGKey(0)), 1)
    tp = tree_from_jax(jp, "cpu", like=vit.vit_init(
        cfg, torch.Generator().manual_seed(0)))
    side, c = cfg.image_size, cfg.in_channels
    rng = np.random.RandomState(side)
    images = rng.standard_normal((3, side, side, c)).astype(np.float32)
    _hold(partial(jvit.vit_forward, config=jcfg),
          partial(vit.vit_forward, config=cfg), jp, tp, (images,),
          f"vit_tiny {geometry}")
    flat = images.reshape(3, -1) if c == 1 else images
    batch = {"images": flat, "labels": np.array([0, 3, 7], np.int32)}
    _hold(partial(jvit.vit_loss, config=jcfg),
          partial(vit.vit_loss, config=cfg), jp, tp, (batch,),
          f"vit_tiny loss {geometry}")


def test_vit_presets_and_axes_match_jax():
    _jax()
    for name in ("vit_tiny", "vit_s16_proxy"):
        j, p = jvit.get_config(name), vit.get_config(name)
        assert (p.seq, p.head_dim, p.n_patches) == (j.seq, j.head_dim,
                                                    j.n_patches)
        assert p.dtype == getattr(torch, jnp.dtype(j.dtype).name)
        assert vit.vit_param_axes(p) == jvit.vit_param_axes(j)
    assert vit.get_config("vit_s16_proxy").seq == 197


def test_models_package_exports_the_jax_packages_names():
    _jax()
    import tony_tpu.models as jmodels
    import tony_tpu_torch.models as models

    assert sorted(models.__all__) == sorted(jmodels.__all__)
    assert all(callable(getattr(models, name)) for name in models.__all__)


def test_tree_from_jax_keeps_bf16_bits_and_checks_the_tree():
    """A bf16 ViT tree and ResNet's list of stages of blocks carried over
    leaf by leaf (bf16 by its bits); a tree that does not fit the port's
    is refused."""
    _jax()
    jcfg = jvit.get_config("vit_tiny", dtype=jnp.bfloat16)
    jp = jax.device_get(jvit.vit_init(jcfg, jax.random.PRNGKey(0)))
    like = vit.vit_init(vit.get_config("vit_tiny", dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0))
    tp = tree_from_jax(jp, "cpu", like=like)
    like_leaves, jax_leaves = (dict(flatten_with_paths(t))
                               for t in (like, jp))
    for path, leaf in flatten_with_paths(tp):
        want = jax_leaves[path]
        assert leaf.dtype == like_leaves[path].dtype
        got = leaf.view(torch.int16).numpy() if leaf.dtype == \
            torch.bfloat16 else leaf.numpy()
        ref = np.asarray(want)
        ref = ref.view(np.int16) if ref.dtype.name == "bfloat16" else ref
        np.testing.assert_array_equal(got, ref, err_msg="/".join(path))
    _, _, jr, tr = _resnet_pair()
    assert isinstance(tr["stages"], list) and len(tr["stages"]) == 3
    assert "proj" in tr["stages"][1][0] and "proj" not in tr["stages"][0][0]
    bad = dict(jp, head_b=np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="head_b"):
        tree_from_jax(bad, "cpu", like=like)
    short = dict(jr, stages=jr["stages"][:2])
    with pytest.raises(ValueError, match="stages"):
        tree_from_jax(short, "cpu", like=tr)


# ---------------------------------------------------------------------------
# MNIST and linear regression
# ---------------------------------------------------------------------------

def test_mnist_matches_jax():
    _jax()
    jp = _randomize_zeros(jmnist.mnist_init(jax.random.PRNGKey(0)), 2)
    tp = tree_from_jax(jp, "cpu", like=mnist.mnist_init(
        torch.Generator().manual_seed(0)))
    batch = next(jdata.synthetic_mnist(8))
    _hold(jmnist.mnist_forward, mnist.mnist_forward, jp, tp,
          (batch["images"],), "mnist")
    _hold(jmnist.mnist_loss, mnist.mnist_loss, jp, tp, (batch,),
          "mnist loss")
    assert float(mnist.mnist_accuracy(tp, {
        k: torch.from_numpy(v) for k, v in batch.items()})) == \
        pytest.approx(float(jmnist.mnist_accuracy(jp, batch)))


def test_linreg_matches_jax():
    _jax()
    jp = _randomize_zeros(jlinear.linreg_init(jax.random.PRNGKey(0)), 3)
    tp = tree_from_jax(jp, "cpu", like=linear.linreg_init(
        torch.Generator().manual_seed(0)))
    batch = next(jdata.synthetic_linreg(8))
    _hold(jlinear.linreg_forward, linear.linreg_forward, jp, tp,
          (batch["x"],), "linreg")
    _hold(jlinear.linreg_loss, linear.linreg_loss, jp, tp, (batch,),
          "linreg loss")


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_generate_demo_speculative_equals_greedy(capsys):
    """The demo with --draft-config (random draft) prints the same samples
    as without it, and GENERATE_OK; with --quant int8 --quant-cache too."""
    from tony_tpu_torch.examples import generate_demo

    base = ["--device", "cpu", "--config", "tiny", "--max-new", "10"]
    for extra in ([], ["--quant", "int8", "--quant-cache"]):
        plain = generate_demo.run(base + extra)
        spec = generate_demo.run(base + extra + ["--draft-config", "tiny",
                                                 "--gamma", "3"])
        assert torch.equal(plain["tokens"], spec["tokens"])
        assert spec["stats"]["rounds"] >= 1
    out = capsys.readouterr().out
    assert out.count("GENERATE_OK") == 4
    assert "speculative: draft=tiny gamma=3" in out


def test_generate_demo_restores_a_checkpoint(tmp_path, capsys):
    """--checkpoint-dir: the params of a port Trainer checkpoint, served
    by the demo as `generate` decodes them."""
    from tony_tpu_torch.examples import generate_demo
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.train.__main__ import main as train_main

    assert train_main(["--device", "cpu", "--config", "tiny", "--steps",
                       "2", "--batch-size", "2", "--seq-len", "16",
                       "--checkpoint-dir", str(tmp_path)]) == 0
    got = generate_demo.run(["--device", "cpu", "--config", "tiny",
                             "--checkpoint-dir", str(tmp_path)])
    assert "restored checkpoint step 2" in capsys.readouterr().out
    want = generate(got["params"], got["config"], got["prompt"], 16)
    assert torch.equal(got["tokens"], want)


@pytest.mark.parametrize("model", ["vit", "resnet"])
def test_train_allreduce_trains_on_the_cpu(model, capsys):
    from tony_tpu_torch.examples import train_allreduce

    assert train_allreduce.main(["--device", "cpu", "--model", model,
                                 "--steps", "3", "--batch-size", "8"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("final loss ") and line.endswith("(rank 0)")
    assert np.isfinite(float(line.split()[2]))


def test_mnist_distributed_gate(capsys):
    """Trained, the chief's accuracy passes 0.9; untrained (a zero
    learning rate) it fails the run."""
    from tony_tpu_torch.examples import mnist_distributed

    assert mnist_distributed.main(["--device", "cpu", "--steps", "40"]) == 0
    acc = float(capsys.readouterr().out.split("accuracy ")[1].split()[0])
    assert acc >= 0.9
    assert mnist_distributed.main(["--device", "cpu", "--steps", "2",
                                   "--learning-rate", "0"]) == 1


DMLC = {"DMLC_ROLE": "worker", "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": "9000", "DMLC_NUM_SERVER": "1",
        "DMLC_NUM_WORKER": "1"}


def test_linreg_dmlc_by_path_and_its_roles(monkeypatch, capsys):
    """By path, as TonY's --executes runs it (TONY_REPO_ROOT on sys.path):
    a worker fits below 0.01 MSE; the scheduler exits 0 without a fit; a
    missing DMLC variable fails."""
    from tony_tpu_torch.examples import linreg_dmlc

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tony_tpu_torch", "examples",
                                      "linreg_dmlc.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env=dict(env, TONY_REPO_ROOT=REPO, **DMLC))
    assert out.returncode == 0, out.stderr[-2000:]
    assert float(out.stdout.split("final mse ")[1]) < 0.01
    for k, v in DMLC.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DMLC_ROLE", "scheduler")
    assert linreg_dmlc.main(["--device", "cpu"]) == 0
    assert "final mse" not in capsys.readouterr().out
    monkeypatch.delenv("DMLC_NUM_WORKER")
    assert linreg_dmlc.main(["--device", "cpu"]) == 1


# ---------------------------------------------------------------------------
# a gloo world of 2: the allreduce rendezvous, and ViT on fsdp and tp
# ---------------------------------------------------------------------------

RANK_BATCH, STEPS = 4, 3
MESH_RUNS = (("2", "fsdp"), ("2", "tp"))
MESH_BATCH = 4
MESH_TRAIN = dict(num_steps=2, log_every=1, learning_rate=1e-2,
                  warmup_steps=1, prefetch_depth=0)
MESH_GEOMETRY = dict(image_size=16, patch_size=4, in_channels=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _allreduce_trainer(model, rank):
    from tony_tpu_torch.examples import train_allreduce

    args = train_allreduce.build_arg_parser().parse_args(
        ["--device", "cpu", "--model", model, "--steps", str(STEPS),
         "--batch-size", str(RANK_BATCH)])
    t, _ = train_allreduce.build_trainer(args, rank)
    t.config.log_every = 1
    return t


def _zoo_world(rank, world, init, out, port, jparams, images, labels):
    """(a) train_allreduce's rendezvous from CLUSTER_SPEC and TASK_INDEX,
    ViT then ResNet for STEPS steps; (b) vit_tiny from the JAX init on
    each mesh of MESH_RUNS with vit_param_axes, each rank fed its rows."""
    import torch.distributed as dist

    from tony_tpu_torch.examples import train_allreduce
    from tony_tpu_torch.parallel import mesh
    from tony_tpu_torch.train import trainer

    torch.set_num_threads(1)
    os.environ.update(CLUSTER_SPEC=json.dumps(
        {"worker": [f"127.0.0.1:{port}"] * world}), TASK_INDEX=str(rank))
    assert train_allreduce.horovod_style_rendezvous() == rank
    results = {}
    for model in ("vit", "resnet"):
        t = _allreduce_trainer(model, rank)
        t.run()
        results[model] = [m["loss"] for m in t.metrics_history]
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    cfg = vit.get_config("vit_tiny", **MESH_GEOMETRY)
    rows = MESH_BATCH // world
    for shape, axes in MESH_RUNS:
        os.environ["TPU_MESH_SHAPE"], os.environ["TPU_MESH_AXES"] = \
            shape, axes
        # fsdp splits the rows; tp feeds every rank the whole batch
        sl = slice(rank * rows, (rank + 1) * rows) if axes == "fsdp" \
            else slice(None)
        t = trainer.Trainer(
            partial(vit.vit_loss, config=cfg),
            lambda _g: tree_map(torch.clone, tree_from_jax(jparams, "cpu")),
            iter([{"images": images[i][sl], "labels": labels[i][sl]}
                  for i in range(MESH_TRAIN["num_steps"])]),
            trainer.TrainerConfig(**MESH_TRAIN), device="cpu",
            param_axes=vit.vit_param_axes(cfg))
        t.run()
        assert t.mesh is not None and mesh.axis_size(t.mesh, axes) == 2
        placed = tuple(t.params["layers"]["wq"].placements)
        params = tree_map(lambda p: p.full_tensor().detach().numpy().copy(),
                          t.params)
        results[axes] = ([m["loss"] for m in t.metrics_history], params,
                         placed)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _jax_mesh_runs(monkeypatch, jparams, images, labels):
    from tony_tpu.train.trainer import Trainer as JaxTrainer
    from tony_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    jcfg = jvit.get_config("vit_tiny", **MESH_GEOMETRY)
    out = {}
    for shape, axes in MESH_RUNS:
        monkeypatch.setenv("TPU_MESH_SHAPE", shape)
        monkeypatch.setenv("TPU_MESH_AXES", axes)
        t = JaxTrainer(partial(jvit.vit_loss, config=jcfg),
                       lambda _key: jax.tree.map(jnp.asarray, jparams),
                       iter([{"images": images[i], "labels": labels[i]}
                             for i in range(MESH_TRAIN["num_steps"])]),
                       JaxTrainerConfig(**MESH_TRAIN),
                       param_axes=jvit.vit_param_axes(jcfg))
        t.run()
        out[axes] = ([m["loss"] for m in t.metrics_history],
                     _np_tree(t.params))
    return out


def test_allreduce_world_and_vit_on_meshes_match(tmp_path, monkeypatch):
    """(a) Each rank of train_allreduce's 2-rank world trains on its own
    stream (process_index = its rank), the gradients summed over the
    ranks: both ranks' losses equal a single process's on the two streams'
    rows together (the global batch), for ViT and ResNet. (b) vit_tiny on
    fsdp 2 (wq's embed dim split) and tp 2 (its heads split): the losses
    and every parameter after two AdamW steps against the JAX Trainer on
    the same meshes."""
    _jax()
    jcfg = jvit.get_config("vit_tiny", **MESH_GEOMETRY)
    jparams = _randomize_zeros(jvit.vit_init(jcfg, jax.random.PRNGKey(0)),
                               4)
    rng = np.random.RandomState(5)
    images = rng.standard_normal((MESH_TRAIN["num_steps"], MESH_BATCH,
                                  16 * 16)).astype(np.float32)
    labels = rng.randint(0, 10, (MESH_TRAIN["num_steps"],
                                 MESH_BATCH)).astype(np.int32)

    def single():
        """The port's single-process runs on the global batch."""
        want = {}
        for model in ("vit", "resnet"):
            t = _allreduce_trainer(model, 0)
            streams = [data.synthetic_mnist(RANK_BATCH, process_index=r)
                       for r in range(2)]
            t.data_iter = ({k: np.concatenate([b[k] for b in batches])
                            for k in batches[0]}
                           for batches in zip(*streams))
            t.run()
            want[model] = [m["loss"] for m in t.metrics_history]
        return want, _jax_mesh_runs(monkeypatch, jparams, images, labels)

    got, (want, jax_runs) = _spawn(_zoo_world, 2, tmp_path, _free_port(),
                                   jparams, images, labels, meanwhile=single)
    for model in ("vit", "resnet"):
        assert len(want[model]) == STEPS
        for r in range(2):
            np.testing.assert_allclose(got[r][model], want[model],
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=f"{model} rank {r}")
    for _, axes in MESH_RUNS:
        losses, params, placed = got[0][axes]
        jlosses, jparams_after = jax_runs[axes]
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=axes)
        assert any(p.is_shard() for p in placed), (axes, placed)
        jflat = dict(flatten_with_paths(jparams_after))
        for path, leaf in flatten_with_paths(params):
            np.testing.assert_allclose(
                leaf, jflat[path], rtol=PARAM_TOL, atol=PARAM_TOL,
                err_msg=f"{axes} {'/'.join(path)}")
        assert got[1][axes][0] == losses
