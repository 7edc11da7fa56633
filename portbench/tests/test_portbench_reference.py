"""The plain reference against the port at tiny sizes, in float32 on the
CPU: forward logits, loss and gradients of the dense and the MoE block,
and the whole training comparison (two AdamW steps) of a tiny cell."""

import pytest
import torch

from portbench import weights
from portbench.reference import llama as ref
from pb_tiny import DENSE, MOE

F32 = dict(DENSE, torch_dtype="float32")
F32_MOE = dict(MOE, torch_dtype="float32")


def _port(cfg, **kw):
    from portbench.program import port_config
    return port_config(cfg, remat=False, **kw)


def _tokens(b, s, v, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, v, (b, s), generator=g)


@pytest.mark.parametrize("cfg", [F32, F32_MOE], ids=["dense", "moe"])
def test_forward_logits(cfg):
    from tony_tpu_torch.models.llama import llama_forward
    from tony_tpu_torch.models.moe import moe_forward
    params = weights.make_params(cfg, 11, "cpu")
    toks = _tokens(1, 40, cfg["vocab_size"])
    if cfg.get("num_local_experts"):
        # served at no-drop capacity, as the engine serves an MoE
        config = _port(cfg, capacity_factor=2.0)
        want = moe_forward(params, toks, config)[0][0]
    else:
        want = llama_forward(params, toks, _port(cfg))[0]
    got = ref.logits_at(cfg, params, [toks[0]],
                        [torch.arange(40)])[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [F32, F32_MOE], ids=["dense", "moe"])
def test_loss_and_gradients(cfg):
    from tony_tpu_torch.models.llama import llama_loss
    from tony_tpu_torch.models.moe import moe_loss
    params = weights.make_params(cfg, 12, "cpu")
    toks = _tokens(2, 33, cfg["vocab_size"], seed=5)
    moe = bool(cfg.get("num_local_experts"))
    config = _port(cfg)
    port_params = weights.make_params(cfg, 12, "cpu")
    for leaf in [weights.get_leaf(port_params, p)
                 for p in weights.leaf_paths(port_params)]:
        leaf.requires_grad_(True)
    loss_fn = moe_loss if moe else llama_loss
    loss = loss_fn(port_params, {"tokens": toks}, config)
    loss.backward()
    layer_grads = {}

    def keep(i, g):
        for k, v in g.items():
            layer_grads.setdefault(k, {})[i] = v
    got_loss, top = ref.loss_and_grads(
        cfg, params, toks, capacity_factor=1.25 if moe else None,
        on_layer_grads=keep)
    assert float(got_loss) == pytest.approx(float(loss.detach()), rel=1e-5)
    for k in ("embed", "final_norm", "output"):
        torch.testing.assert_close(top[k], port_params[k].grad,
                                   rtol=1e-4, atol=1e-5)
    for k, per_layer in layer_grads.items():
        got = torch.stack([per_layer[i] for i in sorted(per_layer)])
        torch.testing.assert_close(got, port_params["layers"][k].grad,
                                   rtol=1e-4, atol=1e-5)


def test_training_comparison_agrees_in_float32(tmp_path):
    """The whole cell at f32 on the CPU: the program's two steps against
    the reference's, read as the benchmark reads them."""
    from pb_tiny import run
    out = run(tmp_path, "train32")
    r = {k: v["value"] for k, v in out["checks"].items()}
    assert r["loss_rel"] < 1e-5
    assert r["grad_gap"] < 1e-4
    assert r["change_gap"] < 1e-3


def test_fp8_products_are_coarser_than_f32():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 64, generator=g), torch.randn(64, 64, generator=g)
    exact = a @ b
    low = ref.product(a, b, "fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.2
