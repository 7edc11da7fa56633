"""The share of the traced window in which no device operation ran: one
less the union of the trace's device intervals over the window."""


def read(ctx):
    tr = ctx["result"]["trace"]
    if not tr or not tr.get("on_device") or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
