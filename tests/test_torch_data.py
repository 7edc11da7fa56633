"""The port's token-shard data (tony_tpu_torch/train/native_data.py)
against the JAX package's (tony_tpu/train/native_data.py), on the CPU.

Both streams are held bit for bit: the numpy one against JAX's
`prefer_native=False`, the native-equivalent one against JAX's native
loader (libtony_data.so, built here by g++; the test asserts the JAX side
really took it). Then the port's Trainer on a shard against the JAX
Trainer on the same shard. (The entry point trains on a shard in
tests/test_torch_serve.py's no-AM probe and in tests/test_torch_orch.py's
TonY job.)
"""

import logging
import os
import shutil
from functools import partial

import jax
import numpy as np
import pytest

from tony_tpu.models import llama as jllama
from tony_tpu.train import native_data as jnd
from tony_tpu.train.trainer import Trainer as JaxTrainer
from tony_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from tony_tpu_torch.models import llama
from tony_tpu_torch.models.convert import params_from_jax
from tony_tpu_torch.train import native_data as nd
from tony_tpu_torch.train import trainer

# the Trainer's loss tolerance against the JAX Trainer
# (tests/test_torch_checkpoint.py LOSS_TOL)
LOSS_TOL = 5e-4
SEEDS = (0, 7, 1_000_000)
SHAPES = ((4, 16), (2, 100))
N_BATCHES = 5

NEEDS_TOOLCHAIN = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("make") is None,
    reason="no native toolchain for the JAX package's loader")


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    toks = np.random.default_rng(123).integers(0, 256, 5_000,
                                               dtype=np.int32)
    path = str(tmp_path_factory.mktemp("shard") / "tokens.bin")
    nd.write_token_file(path, toks)
    return path


def test_write_token_file_same_bytes_as_jax(tmp_path):
    toks = np.random.default_rng(1).integers(-5, 32_000, 777)
    ours = nd.write_token_file(str(tmp_path / "p.bin"), toks)
    theirs = jnd.write_token_file(str(tmp_path / "j.bin"), toks)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(ours + ".tmp")


@pytest.mark.parametrize("batch,seq", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_stream_bitwise_jax(shard, seed, batch, seq):
    ours = nd.token_batches(shard, batch, seq, seed=seed,
                            prefer_native=False)
    theirs = jnd.token_batches(shard, batch, seq, seed=seed,
                               prefer_native=False)
    for _ in range(N_BATCHES):
        a, b = next(ours)["tokens"], next(theirs)["tokens"]
        assert a.dtype == b.dtype == np.int32
        assert a.shape == (batch, seq + 1)
        np.testing.assert_array_equal(a, b)


@NEEDS_TOOLCHAIN
@pytest.mark.parametrize("batch,seq", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_native_stream_bitwise_jax_native_loader(shard, seed, batch, seq,
                                                 caplog):
    with caplog.at_level(logging.INFO, logger="tony_tpu.train.native_data"):
        theirs = jnd.token_batches(shard, batch, seq, seed=seed,
                                   prefer_native=True)
    # the JAX side took libtony_data.so, not its numpy fallback
    assert "native prefetching loader active" in caplog.text
    assert type(theirs).__name__ == "_NativeLoader"
    with nd.token_batches(shard, batch, seq, seed=seed) as ours:
        for _ in range(N_BATCHES):
            a, b = next(ours)["tokens"], next(theirs)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    theirs.close()


def test_xorshift_starts_wrap_like_uint64():
    """A negative or huge seed wraps modulo 2^64 as the C++ `long` ->
    uint64 cast does; every start lies in range."""
    for seed in (-1, 2 ** 63 + 5):
        gen = nd.XorShiftStarts(seed, 10)
        assert gen.state == (seed * 0x9E3779B97F4A7C15 + 1) % 2 ** 64
        assert all(0 <= gen.next() < 10 for _ in range(100))


@pytest.mark.parametrize("prefer_native", [True, False])
def test_short_shard_raises_value_error(tmp_path, prefer_native):
    path = nd.write_token_file(str(tmp_path / "short.bin"),
                               np.arange(16, dtype=np.int32))
    with pytest.raises(ValueError, match="seq\\+1=17"):
        next(iter(nd.token_batches(path, 2, 16,
                                   prefer_native=prefer_native)))


def test_loader_close_stops_its_thread(shard):
    loader = nd.token_batches(shard, 2, 8, seed=3)
    next(loader)
    loader.close()
    assert not loader._worker.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


BATCH, SEQ, STEPS = 8, 16, 4
TRAIN = dict(log_every=1, learning_rate=1e-2, warmup_steps=1,
             prefetch_depth=0)


@NEEDS_TOOLCHAIN
def test_trainer_on_a_shard_matches_the_jax_trainer(shard):
    """tiny f32, 4 steps from the JAX Trainer's initial parameters on the
    same shard and seed: the JAX Trainer reads it through its native
    loader, the port's through its own stream."""
    jcfg = jllama.get_config("tiny")
    jt = JaxTrainer(partial(jllama.llama_loss, config=jcfg),
                    partial(jllama.llama_init, jcfg),
                    jnd.token_batches(shard, BATCH, SEQ, seed=0),
                    JaxTrainerConfig(num_steps=STEPS, **TRAIN))
    jt.run()
    want = [m["loss"] for m in jt.metrics_history if "loss" in m]
    cfg = llama.get_config("tiny")
    # the JAX Trainer's init (PRNGKey(config seed 0)) for the port's
    jparams = jax.device_get(jllama.llama_init(jcfg, jax.random.PRNGKey(0)))

    def init_fn(_generator):
        return params_from_jax(jparams, cfg, "cpu")

    with nd.token_batches(shard, BATCH, SEQ, seed=0) as stream:
        t = trainer.Trainer(partial(llama.llama_loss, config=cfg),
                            init_fn, stream,
                            trainer.TrainerConfig(num_steps=STEPS, **TRAIN),
                            device="cpu")
        t.run()
    got = [m["loss"] for m in t.metrics_history if "loss" in m]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)

