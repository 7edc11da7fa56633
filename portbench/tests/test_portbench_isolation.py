"""Nothing the benchmark loads may be JAX or the JAX package, matched by
whole top-level names; and with no card it prints no result."""

import json
import os
import subprocess
import sys

from portbench.isolation import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "tony_tpu", "tony_tpu.ops.attention", "tony_tpu_torch",
             "tony_tpu_torch.models.llama", "jaxtyping", "tony_tpux",
             "portbench.run"]
    assert forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "tony_tpu",
        "tony_tpu.ops.attention"]


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import portbench.run, portbench.train_cell, portbench.serve_cell\n"
        "import portbench.serve_proc, portbench.calibrate\n"
        "import tony_tpu_torch.train.trainer, tony_tpu_torch.serve.engine\n"
        "import tony_tpu_torch.serve.frontend, tony_tpu_torch.models.moe\n"
        "from portbench.isolation import forbidden_modules\n"
        "print(json.dumps(forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "mistral7b-train-s4096", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr
