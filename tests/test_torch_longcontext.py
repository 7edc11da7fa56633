"""The port's long-context entry point (tony_tpu_torch/examples/
pretrain_long.py) against the JAX script (examples/longcontext-ring/
pretrain_long.py), and the rescaled RoPE tables at long positions, on the
CPU.

- argv -> LlamaConfig: both scripts' `main` with the Trainer stubbed out
  (it records its arguments and trains nothing), every field equal, for
  --seq-len 0 or 256, --rope-scaling 0 or 8, --sp-mode ring or ulysses.
- One gloo world of 4 ranks (fsdp 2 x sp 2 through TPU_MESH_*, started
  with the `spawn` method, rendezvous through a file under tmp_path) runs
  the port's `main` on `tiny` at --seq-len 256 --batch-size 2 --steps 3,
  first with the ring and then with Ulysses, then the refusal of
  --seq-len 255. The JAX script's `main` runs meanwhile in this process
  on the 2 x 2 mesh of the test harness's virtual CPU devices. Both start
  from the same JAX init and see the same global batch: the port's ranks
  draw their rows seeded by their fsdp coordinate (0 and 1), so the JAX
  script's token stream is swapped for those two streams' rows stacked.
  Every step's loss (read off each Trainer's step) is held at LOSS_TOL =
  2e-5, as tests/test_torch_parallel.py holds a mesh's train step; the
  refusal's text and exit are the JAX script's.
- RoPE at 32768 positions, rescaled by 8 from 4096, for head_dim 64 and
  128: `inv_freq` within 1 ulp of JAX's; each cos/sin entry within t *
  |d inv| + one ulp of the angle + one ulp of 1.0 per side (ROADMAP's
  RoPE rule, tests/test_torch_ops.py).
- The script by path through `python -m tony_tpu_torch.cli submit
  --executes`, as tests/test_examples.py runs the JAX one: two workers
  on an fsdp 1 x sp 2 mesh the orchestrator renders.

The rank functions live here, so this module imports no JAX at its top.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import _join, _spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "examples", "longcontext-ring",
                          "pretrain_long.py")
LOSS_TOL = 2e-5
WORLD_ARGS = ["--config", "tiny", "--seq-len", "256", "--batch-size", "2",
              "--steps", "3"]
MESH = {"TPU_MESH_SHAPE": "2,2", "TPU_MESH_AXES": "fsdp,sp"}
# a sequence the sp of 2 does not divide
REFUSED_ARGS = ["--config", "tiny", "--seq-len", "255"]


def _jax_script():
    """The JAX script as a module (it is no package member)."""
    spec = importlib.util.spec_from_file_location("jax_pretrain_long",
                                                  JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(module, monkeypatch, argv) -> str:
    """The JAX script's `main` on `argv`; returns its last line."""
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT, *argv])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert module.main() == 0
    return out.getvalue().strip().splitlines()[-1]


class _StubTrainer:
    """Records the Trainer's arguments; `run()` trains nothing."""

    made: list = []

    def __init__(self, **kwargs):
        _StubTrainer.made.append(kwargs)

    def run(self) -> float:
        return 0.0


def _fields(config) -> dict:
    """A config's fields, its dtype by name."""
    out = {}
    for f in dataclasses.fields(config):
        value = getattr(config, f.name)
        if f.name == "dtype":
            value = np.dtype(value).name if not isinstance(
                value, torch.dtype) else str(value).split(".")[-1]
        out[f.name] = value
    return out


@pytest.mark.parametrize("sp_mode", ["ring", "ulysses"])
@pytest.mark.parametrize("rope_scaling", ["0", "8"])
@pytest.mark.parametrize("seq_len", ["0", "256"])
def test_argv_gives_the_jax_scripts_config(monkeypatch, seq_len,
                                           rope_scaling, sp_mode):
    from tony_tpu_torch.examples import pretrain_long
    from tony_tpu_torch.train import trainer

    for name in MESH:
        monkeypatch.delenv(name, raising=False)
    argv = ["--config", "tiny", "--seq-len", seq_len, "--rope-scaling",
            rope_scaling, "--sp-mode", sp_mode]
    module = _jax_script()
    monkeypatch.setattr(module, "Trainer", _StubTrainer)
    monkeypatch.setattr(trainer, "Trainer", _StubTrainer)
    _StubTrainer.made = []
    jax_line = _run_jax(module, monkeypatch, argv)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert pretrain_long.main(argv + ["--device", "cpu"]) == 0
    port_line = out.getvalue().strip().splitlines()[-1]
    assert port_line == jax_line
    jax_made, port_made = _StubTrainer.made
    want = jax_made["loss_fn"].keywords["config"]
    got = port_made["loss_fn"].keywords["config"]
    assert got is port_made["init_fn"].args[0]
    assert _fields(got) == _fields(want)
    seq = int(seq_len) or want.max_seq
    assert jax_line == f"final loss 0.0000 (seq={seq}, sp_mode={sp_mode})"
    assert port_made["config"].num_steps == jax_made["config"].num_steps
    assert port_made["config"].log_every == jax_made["config"].log_every
    batch = next(port_made["data_iter"])["tokens"]
    np.testing.assert_array_equal(batch, next(jax_made["data_iter"])[
        "tokens"])
    assert batch.shape == (1, seq + 1)


def test_rope_rescaled_tables_at_32768_positions_match_jax():
    """The Llama-3.1 rescale by 8 from a 4096 window, over 32768
    positions, at llama3_1b_proxy's theta, for head_dim 64 and 128. At
    t = 32767 one f32 ulp of the largest angle is 2^-9 rad; the rule
    still holds, because both sides round the same f32 product of equal
    rates."""
    from tony_tpu.ops import rope as jrope
    from tony_tpu_torch.models.llama import get_config
    from tony_tpu_torch.ops import rope

    import jax.numpy as jnp

    theta = get_config("llama3_1b_proxy").rope_theta
    seq, factor, window = 32768, 8.0, 4096
    eps = float(np.finfo(np.float32).eps)
    t = np.arange(seq, dtype=np.float32)[:, None]
    for head_dim in (64, 128):
        args = dict(scaling_factor=factor, orig_max_seq=window)
        jc, js = jrope.rope_frequencies(head_dim, seq, theta, **args)
        tc, ts = rope.rope_frequencies(head_dim, seq, theta, **args)
        assert tc.shape == (seq, head_dim // 2)
        jinv = np.asarray(jrope.scale_rope_frequencies(
            1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32)
                             / head_dim)), factor, window))
        tinv = rope.inverse_frequencies(head_dim, theta, **args).numpy()
        d_inv = np.abs(tinv.astype(np.float64) - jinv.astype(np.float64))
        assert np.all(d_inv <= np.spacing(np.abs(jinv))), head_dim
        angle = np.abs(t * jinv)
        bound = t.astype(np.float64) * d_inv + np.spacing(angle) + 2 * eps
        for name, got, want in (("cos", tc, jc), ("sin", ts, js)):
            diff = np.abs(got.numpy().astype(np.float64)
                          - np.asarray(want, np.float64))
            worst = np.unravel_index(np.argmax(diff - bound), diff.shape)
            assert np.all(diff <= bound), (
                f"head_dim {head_dim} {name} at (t, i) = {worst}: gap "
                f"{diff[worst]:.3e} > bound {bound[worst]:.3e} (angle "
                f"{angle[worst]:.4f})")


# ---------------------------------------------------------------------------
# the 2 x 2 world
# ---------------------------------------------------------------------------

def _long_world(rank, world, init, out, jparams):
    """The port's `main` on each rank, ring then Ulysses, from the JAX
    init, each step's loss recorded; then the refusal. Each rank saves
    {mode: (exit, losses, last line), "refusal": SystemExit's code}."""
    import torch.distributed as dist

    from tony_tpu_torch.examples import pretrain_long
    from tony_tpu_torch.models import llama
    from tony_tpu_torch.models.convert import params_from_jax
    from tony_tpu_torch.train import trainer
    from tony_tpu_torch.train.optim import tree_map

    os.environ.update(MESH)
    _join(rank, world, init)
    # fresh tensors each run: the first run's updates must not reach the
    # second's start
    llama.llama_init = lambda cfg, _gen: tree_map(
        torch.clone, params_from_jax(jparams, cfg, "cpu"))
    losses: list = []

    class Recording(trainer.Trainer):
        def setup(self):
            super().setup()
            step = self.train_step

            def recorded(*args):
                result = step(*args)
                losses.append(float(result[2]))
                return result
            self.train_step = recorded

    trainer.Trainer = Recording
    results = {}
    for mode in ("ring", "ulysses"):
        losses.clear()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = pretrain_long.main(WORLD_ARGS + ["--sp-mode", mode,
                                                  "--device", "cpu"])
        results[mode] = (rc, list(losses),
                         printed.getvalue().strip().splitlines()[-1])
    try:
        pretrain_long.main(REFUSED_ARGS + ["--device", "cpu"])
        results["refusal"] = None
    except SystemExit as e:
        results["refusal"] = e.code
    assert dist.is_initialized(), "main closed a group it did not open"
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _jax_world(monkeypatch, jparams) -> dict:
    """The JAX script's `main` on the 2 x 2 mesh, on the port's global
    batch and from `jparams`: {mode: (losses, last line), "refusal":
    SystemExit's code}."""
    from tony_tpu.train import data as jdata

    module = _jax_script()
    losses: list = []

    def global_batches(batch, seq, vocab, process_index=0):
        # the rows the port's two fsdp coordinates draw, stacked
        streams = [jdata.synthetic_tokens(batch, seq, vocab,
                                          process_index=i) for i in (0, 1)]
        while True:
            yield {"tokens": np.concatenate([next(s)["tokens"]
                                             for s in streams])}

    class Recording(module.Trainer):
        def setup(self):
            super().setup()
            step = self.train_step

            def recorded(*args):
                result = step(*args)
                losses.append(float(result[2]))
                return result
            self.train_step = recorded

    monkeypatch.setattr(module, "synthetic_tokens", global_batches)
    monkeypatch.setattr(module, "llama_init", lambda _cfg, _key: jparams)
    monkeypatch.setattr(module, "Trainer", Recording)
    for name, value in MESH.items():
        monkeypatch.setenv(name, value)
    results = {}
    for mode in ("ring", "ulysses"):
        losses.clear()
        line = _run_jax(module, monkeypatch, WORLD_ARGS + ["--sp-mode",
                                                           mode])
        results[mode] = (list(losses), line)
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT, *REFUSED_ARGS])
    with pytest.raises(SystemExit) as refused:
        module.main()
    results["refusal"] = refused.value.code
    return results


def test_a_2x2_fsdp_sp_world_trains_as_the_jax_script(tmp_path,
                                                      monkeypatch):
    import jax

    from tony_tpu.models import llama as jllama

    jparams = jax.device_get(jllama.llama_init(jllama.get_config("tiny"),
                                               jax.random.PRNGKey(0)))
    got, want = _spawn(_long_world, 4, tmp_path, jparams,
                       meanwhile=lambda: _jax_world(monkeypatch, jparams))
    for mode in ("ring", "ulysses"):
        jax_losses, jax_line = want[mode]
        assert len(jax_losses) == 3, want
        for rank, result in enumerate(got):
            rc, losses, line = result[mode]
            assert rc == 0
            np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_TOL,
                                       atol=LOSS_TOL,
                                       err_msg=f"{mode} rank {rank}")
            assert line == (f"final loss {losses[-1]:.4f} (seq=256, "
                            f"sp_mode={mode})")
        assert jax_line.endswith(f"(seq=256, sp_mode={mode})")
    assert want["refusal"] == "--seq-len 255 must divide by sp=2"
    assert [r["refusal"] for r in got] == [want["refusal"]] * 4


def test_the_script_by_path_as_a_two_rank_sp_gang(tmp_path):
    """As `tests/test_examples.py` runs the JAX script through the real
    chain: `python -m tony_tpu_torch.cli submit --executes` the port's
    script by path, two workers of the jax framework (whose runtime
    renders TPU_MESH_* from tony.tpu.mesh-*, and the rendezvous the port
    reads), the mesh fsdp 1 x sp 2: the sequence split over the two ranks
    (Ulysses), both finish and print the final line."""
    script = os.path.join(REPO, "tony_tpu_torch", "examples",
                          "pretrain_long.py")
    workdir = tmp_path / "cluster"
    conf = {"tony.worker.instances": "2",
            "tony.application.framework": "jax",
            "tony.tpu.mesh-shape": "1,2", "tony.tpu.mesh-axes": "fsdp,sp",
            "tony.cluster.workdir": str(workdir),
            "tony.task.heartbeat-interval-ms": "200",
            "tony.am.monitor-interval-ms": "200",
            "tony.am.stop-poll-timeout-ms": "2000",
            "tony.application.timeout": "240000",
            "tony.execution.env": "OMP_NUM_THREADS=1"}
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit",
            "--executes", script, "--task_params",
            "--device cpu --config tiny --seq-len 128 --batch-size 2 "
            "--steps 2 --sp-mode ulysses"]
    for k, v in conf.items():
        argv += ["--conf", f"{k}={v}"]
    out = subprocess.run(argv, cwd=tmp_path, capture_output=True, text=True,
                         timeout=280, env=dict(os.environ, PYTHONPATH=REPO))
    logs = {}
    for d, _, files in os.walk(workdir):
        for f in files:
            if f in ("stdout", "stderr"):
                with open(os.path.join(d, f)) as fh:
                    logs[os.path.join(d, f)] = fh.read()
    assert out.returncode == 0, (out.stderr[-3000:], logs)
    lines = [text.strip().splitlines()[-1] for path, text in logs.items()
             if f"containers{os.sep}worker_" in path
             and path.endswith("stdout")]
    assert len(lines) == 2 and lines[0] == lines[1], logs
    assert lines[0].startswith("final loss ") and lines[0].endswith(
        "(seq=128, sp_mode=ulysses)")
    assert any("mesh: {'fsdp': 1, 'sp': 2}" in text
               for path, text in logs.items() if path.endswith("stderr")), \
        logs
