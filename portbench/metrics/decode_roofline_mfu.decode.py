"""The decode steps' share of their roofline over the span the counters
cover (the window, or in a traced run its part before the trace): the
larger of their FLOPs at the bf16 peak and their bytes at the memory
rate, over the span. Bytes: every product's weights once a step, and the
cache of each decoding request up to its length; FLOPs: each decoded
token's products and attention over its context."""

from portbench import roofline


def read(ctx):
    c, cfg = ctx["result"]["counters"], ctx["cfg"]
    if not c["decode_steps"]:
        return None
    kv = roofline.kv_bytes_per_position(cfg)
    nbytes = (c["decode_steps"] * roofline.weight_bytes(cfg)
              + kv * sum(c["decoded_contexts"]))
    flops = sum(roofline.decode_token_flops(cfg, n)
                for n in c["decoded_contexts"])
    bw, bf16, _ = ctx["peaks"]
    return 100.0 * max(nbytes / bw, flops / bf16) / c["window_s"]
