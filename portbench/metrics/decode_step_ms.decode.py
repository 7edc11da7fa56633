"""Milliseconds an engine step took, admissions included: the span the
counters cover (the window, or in a traced run its part before the
trace) over the `EngineStats.decode_steps` run in it."""


def read(ctx):
    c = ctx["result"]["counters"]
    if not c["decode_steps"]:
        return None
    return 1000.0 * c["window_s"] / c["decode_steps"]
