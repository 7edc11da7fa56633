"""The comparison that decides `correct`: the numbers compared, each beside
its limit from `portbench/limits/<workload>.json`.

Training (the first two steps; the reference follows two steps for three,
to stay shorter than the window):
- `loss_rel`: the largest |program - reference| / |reference| of the two
  steps' losses;
- `grad_gap`: over the leaves, the largest gap between the program's norm
  of the first gradient (read from its first moment after one step:
  |mu| / (1 - b1)) and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
- `change_gap`: the same of the parameters' change after the two steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (round-off alone moves them under Adam).

Serving: `logit_gap`, the widest gap by which a served token's logit lies
below the reference's best at its position, over a sample of finished
requests.
"""

from __future__ import annotations

import json
import os
import statistics

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")
# a leaf counts for the change when its reference gradient is at least
# this share of the median leaf's
MOVED_SHARE = 1e-3


def load_limits(workload: str) -> dict:
    with open(os.path.join(LIMITS_DIR, f"{workload}.json")) as f:
        return json.load(f)["limits"]


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Each leaf's gap between the two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    leaves = list(leaves)
    median = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in leaves}


def training_readings(prog: dict, ref: dict) -> dict:
    """prog and ref: {"loss": [...], "grad_norm": {...},
    "change_norm": {...}}."""
    loss_rel = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                       ref["loss"]))
    if any(p != p for p in prog["loss"]):        # NaN
        loss_rel = float("inf")
    g_ref = ref["grad_norm"]
    median = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= MOVED_SHARE * median]
    grads = _leaf_gaps(prog["grad_norm"], g_ref, g_ref)
    changes = _leaf_gaps(prog["change_norm"], ref["change_norm"], moved)
    grad_leaf = max(grads, key=grads.get)
    change_leaf = max(changes, key=changes.get)
    return {"loss_rel": loss_rel, "grad_gap": grads[grad_leaf],
            "change_gap": changes[change_leaf], "grad_gap_leaf": grad_leaf,
            "change_gap_leaf": change_leaf}


def served_gaps(ref_logits, tokens) -> list[float]:
    """max(ref) - ref[token] at each position."""
    import torch
    t = torch.as_tensor(tokens, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return (best - ref_logits.gather(1, t[:, None])[:, 0]).tolist()


def gap_readings(gaps: list) -> dict:
    """The widest gap, with the spread of the rest beside it: its 99th
    percentile, its mean and the share of tokens that are not the
    reference's best."""
    ordered = sorted(gaps)
    n = len(ordered)
    return {"logit_gap": ordered[-1],
            "logit_gap_p99": ordered[max(0, -(-99 * n // 100) - 1)],
            "logit_gap_mean": sum(ordered) / n,
            "not_best_share": sum(1 for g in ordered if g > 0) / n,
            "served_tokens_compared": n}


def checks(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit; a missing reading
    counts as infinitely far."""
    return {k: {"value": readings.get(k, float("inf")), "limit": lim}
            for k, lim in limits.items()}


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
