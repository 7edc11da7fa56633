"""The whole training step's share of the cards' bf16 peak over the traced
steps: useful FLOPs (`roofline.useful_flops_per_token`: products at top-k,
the causal half of attention, no recompute, no lookup) times the tokens
the traced steps trained, over the traced window times the chips' peak."""

from portbench import roofline


def read(ctx):
    tr, c = ctx["result"]["trace"], ctx["result"]["counters"]
    if not tr or not c.get("traced_steps"):
        return None
    flops = (roofline.useful_flops_per_token(ctx["cfg"], c["seq"])
             * c["tokens_per_step"] * c["traced_steps"])
    return 100.0 * flops / (tr["window_s"] * ctx["chips"] * ctx["peaks"][1])
