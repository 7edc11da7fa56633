"""K1-K3's summed bound (`roofline.flash_train_step_bound_s`, every layer
once a step) over their summed device time in the traced steps."""

from portbench import roofline
from portbench.trace import flash_seconds


def read(ctx):
    tr, c = ctx["result"]["trace"], ctx["result"]["counters"]
    if not tr or not c.get("traced_steps"):
        return None
    secs = sum(v[0] for v in flash_seconds(tr).values())
    if secs <= 0:
        return None
    bound = c["traced_steps"] * roofline.flash_train_step_bound_s(
        ctx["cfg"], c["batch"], c["seq"], ctx["peaks"])
    return 100.0 * bound / secs
