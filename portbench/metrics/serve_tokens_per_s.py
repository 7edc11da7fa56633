"""`serve_tokens_per_s` as the load generator measured it on its own clock
(`serve_cell.summarize`): over every request of the window, a failed
request counting as missing."""


def read(ctx):
    return ctx["result"]["e2e"]["serve_tokens_per_s"]
