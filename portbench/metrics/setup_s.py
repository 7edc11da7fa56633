"""Set-up seconds: from the start of the run to the window's opening
(loading, weights from the seed, kernel builds, warm-up, the first steps),
less the benchmark's own correctness readings. Host clock."""


def read(ctx):
    return ctx["result"]["setup_s"]
