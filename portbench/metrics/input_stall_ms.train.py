"""Milliseconds a window step waited on the Trainer's input pipeline: the
prefetcher's `stall_snapshot()` seconds over the window, per step."""


def read(ctx):
    c = ctx["result"]["counters"]
    return 1000.0 * c["stall_s"] / c["steps"]
