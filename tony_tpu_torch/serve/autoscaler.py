"""Serving replica autoscaler: burn-rate SLIs → arbiter-backed asks.

The port's copy of `tony_tpu/serve/autoscaler.py`. The AM evaluates this
ONLY on its monitor cadence (next to _check_slo / _check_alerts — the
serving hot path never pays for it): the serving SLIs (TTFT p95,
engine queue depth, 429 reject rate, slot occupancy) are folded into
one of three verdicts per pass — scale up, scale down, hold — with **hysteresis** (a signal must hold for
``tony.autoscaler.hysteresis-passes`` consecutive passes) and a
**cooldown** (no second action within ``tony.autoscaler.cooldown-ms``)
so a traffic blip never flaps the fleet.

The decision engine is pure: feed it SLIs + the live replica count, get
a verdict. The *capacity* side goes through the admission arbiter
(cluster/arbiter.py): a scale-up files a GangAsk for one replica's
chips against the live fleet book — ADMIT launches, PREEMPT may evict a
lower-priority trainer first (checkpoint-then-evict, never a kill),
QUEUE waits without flapping. Scale-down drains a replica (connection
draining — in-flight requests finish) and returns its chips to the
pool. Every decision is event-pinned (AUTOSCALE_DECISION) with the SLI
evidence and the arbiter's verdict.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from tony_tpu_torch.conf import keys as K

LOG = logging.getLogger(__name__)

UP = "up"
DOWN = "down"
HOLD = "hold"


@dataclass
class AutoscalerConfig:
    """tony.autoscaler.* knobs (a 0 threshold disables that signal)."""
    min_replicas: int = 1
    max_replicas: int = 4
    ttft_p95_up_ms: float = 0.0        # scale up when TTFT p95 exceeds
    itl_p50_up_ms: float = 0.0         # ... or inter-token latency exceeds
    queue_depth_up: float = 8.0        # ... or per-replica queue exceeds
    reject_rate_up_pct: float = 1.0    # ... or 429 rate (windowed) exceeds
    occupancy_down_pct: float = 30.0   # scale down below this occupancy
    hysteresis_passes: int = 3
    cooldown_ms: int = 60_000

    @classmethod
    def from_conf(cls, conf) -> "AutoscalerConfig":
        return cls(
            min_replicas=conf.get_int(K.AUTOSCALER_MIN_REPLICAS, 1),
            max_replicas=conf.get_int(K.AUTOSCALER_MAX_REPLICAS, 4),
            ttft_p95_up_ms=float(
                conf.get_time_ms(K.AUTOSCALER_TTFT_P95_UP_MS, 0)),
            itl_p50_up_ms=float(
                conf.get_time_ms(K.AUTOSCALER_ITL_P50_UP_MS, 0)),
            queue_depth_up=float(
                conf.get_int(K.AUTOSCALER_QUEUE_DEPTH_UP, 8)),
            reject_rate_up_pct=conf.get_float(
                K.AUTOSCALER_REJECT_RATE_UP_PCT, 1.0),
            occupancy_down_pct=float(
                conf.get_int(K.AUTOSCALER_OCCUPANCY_DOWN_PCT, 30)),
            hysteresis_passes=conf.get_int(
                K.AUTOSCALER_HYSTERESIS_PASSES, 3),
            cooldown_ms=conf.get_time_ms(K.AUTOSCALER_COOLDOWN_MS,
                                         60_000))


class ReplicaAutoscaler:
    """Hysteresis/cooldown state machine over the serving SLIs.

    SLI dict (one per evaluate() call, aggregated over live replicas):
      ttft_p95_s       max over replicas (the fleet tail)
      queue_depth      summed engine queue depth
      occupancy_pct    mean slot occupancy
      submitted_total  cumulative admissions (sum)
      rejected_total   cumulative 429s (sum)
    The reject RATE is computed here from the cumulative counters'
    inter-pass deltas — the same windowing discipline as the
    burn-rate rules, without a second counter pipeline."""

    def __init__(self, config: AutoscalerConfig):
        self.config = config
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_ms: float = float("-inf")
        self._last_totals: Optional[tuple[float, float]] = None

    # -- bookkeeping ----------------------------------------------------
    def note_scaled(self, now_ms: float) -> None:
        """An action was EXECUTED: start the cooldown, reset streaks."""
        self._last_action_ms = now_ms
        self._up_streak = 0
        self._down_streak = 0

    def reject_rate_pct(self, slis: dict) -> float:
        """Windowed 429 rate: rejected/submitted over the delta since the
        previous pass (cumulative counters never reset, so the delta IS
        the last monitor interval's traffic)."""
        sub = float(slis.get("submitted_total", 0) or 0)
        rej = float(slis.get("rejected_total", 0) or 0)
        prev = self._last_totals
        self._last_totals = (sub, rej)
        if prev is None:
            return 0.0
        dsub, drej = sub - prev[0], rej - prev[1]
        if dsub <= 0 and drej <= 0:
            return 0.0
        total = dsub + drej if dsub >= 0 and drej >= 0 else 0.0
        return 100.0 * max(0.0, drej) / total if total > 0 else 0.0

    # -- the verdict ----------------------------------------------------
    def evaluate(self, slis: dict, replicas: int,
                 now_ms: float) -> dict:
        """One monitor-cadence pass → {"action", "target", "reason",
        "slis"}. Hysteresis counts consecutive breaching passes;
        cooldown suppresses ACTIONS, not streak accounting, so a breach
        that outlives the cooldown fires on the first eligible pass."""
        cfg = self.config
        reject_pct = self.reject_rate_pct(slis)
        ttft_ms = float(slis.get("ttft_p95_s", 0) or 0) * 1000.0
        itl_ms = float(slis.get("itl_p50_ms", 0) or 0)
        queue_per_replica = (float(slis.get("queue_depth", 0) or 0)
                             / max(1, replicas))
        occupancy = float(slis.get("occupancy_pct", 0) or 0)
        evidence = {"ttft_p95_s": round(ttft_ms / 1000.0, 4),
                    "queue_depth": float(slis.get("queue_depth", 0) or 0),
                    "reject_rate_pct": round(reject_pct, 3),
                    "occupancy_pct": round(occupancy, 2)}

        up_reasons = []
        if cfg.ttft_p95_up_ms > 0 and ttft_ms > cfg.ttft_p95_up_ms:
            up_reasons.append(
                f"ttft_p95 {ttft_ms:.0f}ms > {cfg.ttft_p95_up_ms:.0f}ms")
        if cfg.itl_p50_up_ms > 0 and itl_ms > cfg.itl_p50_up_ms:
            up_reasons.append(
                f"itl_p50 {itl_ms:.1f}ms > {cfg.itl_p50_up_ms:.0f}ms")
        if cfg.queue_depth_up > 0 and queue_per_replica > cfg.queue_depth_up:
            up_reasons.append(
                f"queue/replica {queue_per_replica:.1f} > "
                f"{cfg.queue_depth_up:g}")
        if cfg.reject_rate_up_pct > 0 and \
                reject_pct > cfg.reject_rate_up_pct:
            up_reasons.append(f"reject rate {reject_pct:.1f}% > "
                              f"{cfg.reject_rate_up_pct:g}%")
        want_down = (cfg.occupancy_down_pct > 0
                     and occupancy < cfg.occupancy_down_pct
                     and float(slis.get("queue_depth", 0) or 0) == 0
                     and reject_pct == 0.0)

        if up_reasons:
            self._up_streak += 1
            self._down_streak = 0
        elif want_down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0

        cooling = now_ms - self._last_action_ms < cfg.cooldown_ms
        if (self._up_streak >= cfg.hysteresis_passes
                and replicas < cfg.max_replicas and not cooling):
            return {"action": UP, "target": replicas + 1,
                    "reason": "; ".join(up_reasons), "slis": evidence}
        if (self._down_streak >= cfg.hysteresis_passes
                and replicas > cfg.min_replicas and not cooling):
            return {"action": DOWN, "target": replicas - 1,
                    "reason": f"occupancy {occupancy:.1f}% < "
                              f"{cfg.occupancy_down_pct:g}% with an "
                              f"empty queue", "slis": evidence}
        return {"action": HOLD, "target": replicas,
                "reason": ("cooldown" if cooling and
                           (up_reasons or want_down) else ""),
                "slis": evidence}


def aggregate_serving_slis(latest_gauges: dict,
                           job_name: str = "serving",
                           live_task_ids: Optional[set] = None,
                           roles: Optional[dict] = None,
                           role: Optional[str] = None
                           ) -> Optional[dict]:
    """Fold the per-replica SERVING_* gauges (MetricsStore
    latest_gauges(): task_id -> {metric: value}) into the fleet SLI
    dict evaluate() consumes. None until at least one replica has
    pushed serving metrics. `live_task_ids` restricts the fold to the
    CURRENT replica set — the store keeps a completed task's last
    gauges forever, and a scaled-down replica's dying snapshot (idle
    occupancy, stale TTFT tail) must not keep skewing every later
    verdict.

    Disaggregated fleets (prefill/decode roles): pass `roles`
    (task_id -> role from the AM's endpoint records) and `role` to fold
    ONLY that pool's replicas — a prefill pool's verdict must not be
    polluted by decode-side occupancy and vice versa. A replica whose
    role is unknown/"both" counts toward every pool."""
    ttft, itl, queues, occ, sub, rej = [], [], [], [], 0.0, 0.0
    seen = False
    for task_id, gauges in latest_gauges.items():
        if not task_id.startswith(f"{job_name}:"):
            continue
        if live_task_ids is not None and task_id not in live_task_ids:
            continue
        if role:
            r = (roles or {}).get(task_id, "") or "both"
            if r not in (role, "both"):
                continue
        if "SERVING_QUEUE_DEPTH" not in gauges \
                and "SERVING_TOKENS_PER_SEC" not in gauges:
            continue
        seen = True
        if gauges.get("SERVING_TTFT_P95_S") is not None:
            ttft.append(float(gauges["SERVING_TTFT_P95_S"]))
        if gauges.get("SERVING_ITL_P50_MS") is not None:
            itl.append(float(gauges["SERVING_ITL_P50_MS"]))
        queues.append(float(gauges.get("SERVING_QUEUE_DEPTH", 0) or 0))
        occ.append(float(gauges.get("SERVING_SLOT_OCCUPANCY_PCT", 0)
                         or 0))
        sub += float(gauges.get("SERVING_SUBMITTED_TOTAL", 0) or 0)
        rej += float(gauges.get("SERVING_REJECTED_TOTAL", 0) or 0)
    if not seen:
        return None
    return {
        "ttft_p95_s": max(ttft) if ttft else 0.0,
        "itl_p50_ms": max(itl) if itl else 0.0,
        "queue_depth": sum(queues),
        "occupancy_pct": sum(occ) / len(occ) if occ else 0.0,
        "submitted_total": sub,
        "rejected_total": rej,
    }


def replica_ask_verdict(conf, app_id: str, chips: int,
                        fleet_summaries: Optional[list] = None,
                        queue: str = "default", user: str = "",
                        priority: int = 0, role: Optional[str] = None):
    """One replica's chip ask through the admission arbiter. Returns the
    (pure) Decision; the caller executes preemption / launches. With
    chips == 0 (CPU/dev fleets) the ask trivially admits — the arbiter
    is authoritative only where chips are modeled. `role` names the
    disaggregation pool asking (prefill/decode) so the two pools' asks
    are distinct book entries — a queued prefill ask must not shadow a
    decode ask, and vice versa."""
    from tony_tpu_torch.cluster.arbiter import Arbiter, GangAsk
    arb = Arbiter.from_conf(conf)
    if fleet_summaries:
        arb.sync_from_fleet(fleet_summaries)
    suffix = f"-{role}" if role else ""
    ask = GangAsk(app_id=f"{app_id}/serving-scaleup{suffix}",
                  chips=max(0, chips),
                  queue=queue, user=user, priority=priority)
    return arb.decide(ask)
