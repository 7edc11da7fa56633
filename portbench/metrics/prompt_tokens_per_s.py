"""Prompt tokens prefilled per second: the prompts of the requests whose
first token reached the load generator inside the window, over the
window. Offered above what the port sustains, the engine is busy all
through the window, so this is its prefill capacity."""


def read(ctx):
    return ctx["result"]["e2e"]["prompt_tokens_per_s"]
