"""The benchmark's FLOP and byte counts against the bounds `chip_smoke.py`
holds the kernels to, and against the port's own FLOP count."""

import pytest

from portbench import roofline as r

H100 = r.card_peaks("NVIDIA H100 80GB HBM3")


def ms(x):
    return round(x * 1e3, 4)


@pytest.mark.parametrize("shape,bound_ms", [
    ((1, 32, 8, 2000, 128), 0.0331),
    ((4, 16, 8, 4096, 128), 0.2779),
    ((1, 16, 8, 4096, 128), 0.0695),
    ((1, 16, 8, 32768, 128), 4.4470),
])
def test_k1_bound_is_chip_smokes(shape, bound_ms):
    # chip_smoke.py's printed bounds for the same shapes (PERF.md's table)
    assert ms(r.flash_fwd_bound_s(*shape, H100)) == bound_ms


@pytest.mark.parametrize("shape,bounds_ms", [
    ((4, 16, 8, 4096, 128), (0.4169, 0.5559)),
    ((1, 16, 8, 4096, 128), (0.1042, 0.1390)),
    ((1, 16, 8, 32768, 128), (6.6704, 8.8939)),
])
def test_k2_k3_bounds_are_chip_smokes(shape, bounds_ms):
    assert tuple(ms(x) for x in r.flash_bwd_bounds_s(*shape, H100)) \
        == bounds_ms


def test_peaks_tell_the_h100_parts_apart():
    assert r.card_peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12, 67e12)
    assert r.card_peaks("NVIDIA H100 PCIe")[1] == 756e12
    assert r.card_peaks("NVIDIA H100 NVL")[0] == 3.9e12
    assert r.card_peaks("some other card") is None


@pytest.mark.parametrize("name", ["mistral-7b-v0.3", "mixtral-8x7b-v0.1-16l"])
def test_useful_flops_against_the_ports_count(name):
    """The port counts 6 N (N with the embedding) + 12 L D S; the
    benchmark leaves the lookup out and counts the causal half."""
    import json
    import os
    from portbench.program import port_config
    cfg = json.load(open(os.path.join(os.path.dirname(r.__file__),
                                      "configs", f"{name}.json")))
    config = port_config(cfg)
    s = 4096
    ours = r.useful_flops_per_token(cfg, s)
    theirs = config.flops_per_token(s)
    d, v, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    norms = 2 * d * L + d         # the port's N counts the norms' weights
    assert ours == pytest.approx(theirs - 6 * v * d - 6 * norms
                                 - 6 * L * d * s, rel=1e-12)


def test_mistral_counts():
    import json
    import os
    cfg = json.load(open(os.path.join(os.path.dirname(r.__file__),
                                      "configs", "mistral-7b-v0.3.json")))
    assert r.product_params(cfg) == pytest.approx(7.11e9, rel=2e-3)
    assert r.useful_flops_per_token(cfg, 4096) == pytest.approx(45.9e9,
                                                                rel=2e-3)
    # weights a decode step reads: every product once, in bf16
    assert r.weight_bytes(cfg) == 2 * r.product_params(cfg)
    assert r.kv_bytes_per_position(cfg) == 2 * 32 * 8 * 128 * 2


def test_mixtral_counts_active_and_all_experts():
    import json
    import os
    cfg = json.load(open(os.path.join(os.path.dirname(r.__file__),
                                      "configs",
                                      "mixtral-8x7b-v0.1-16l.json")))
    per_expert = 3 * 4096 * 14336
    assert (r.layer_product_params(cfg, active=False)
            - r.layer_product_params(cfg)) == 6 * per_expert
    # a prompt's prefill: 2 per active product parameter a token, the
    # causal half of attention, the head on the last position
    p = 1000
    want = (2 * 16 * r.layer_product_params(cfg) * p
            + 2 * 16 * 32 * 128 * p * p + 2 * 4096 * 32000)
    assert r.prefill_flops(cfg, p) == want
