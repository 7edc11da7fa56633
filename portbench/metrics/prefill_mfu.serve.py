"""Prefill's share of the card's bf16 peak: the useful FLOPs
(`roofline.prefill_flops`: active products, the causal half of
attention, the head on the last position) of the prompts the engine
admitted in the span the counters cover (the window, or in a traced run
its part before the trace), over that span times the peak."""

from portbench import roofline


def read(ctx):
    c = ctx["result"]["counters"]
    if not c["admitted_prompts"]:
        return None
    flops = sum(roofline.prefill_flops(ctx["cfg"], p)
                for p in c["admitted_prompts"])
    return 100.0 * flops / (c["window_s"] * ctx["chips"] * ctx["peaks"][1])
