"""Tokens trained per second over the whole window: B * S of every step
the window ran, over the window's host-clock length (the Trainer's loop,
its input pipeline and its log boundaries included)."""


def read(ctx):
    c = ctx["result"]["counters"]
    return c["steps"] * c["tokens_per_step"] / ctx["result"]["window_s"]
