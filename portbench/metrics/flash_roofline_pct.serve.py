"""K1's bound over the prompts admitted in the traced engine steps
(`roofline.flash_prefill_bound_s`), over K1's device time there."""

from portbench import roofline
from portbench.trace import flash_seconds


def read(ctx):
    tr = ctx["result"]["trace"]
    if not tr or not tr.get("admitted_prompts"):
        return None
    secs = flash_seconds(tr)["k1"][0]
    if secs <= 0:
        return None
    bound = sum(roofline.flash_prefill_bound_s(ctx["cfg"], p, ctx["peaks"])
                for p in tr["admitted_prompts"])
    return 100.0 * bound / secs
