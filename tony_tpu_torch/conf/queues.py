"""Scheduler-queue quota validation.

The port's copy of `tony_tpu/conf/queues.py`.

The reference submitted into a YARN queue (TonyClient.java:249-251) and
inherited capacity scheduling + ACLs from the RM. There is no RM here, so
`--queue` names a queue DECLARED IN CONFIGURATION: any
`tony.queues.<name>.max-tpus` key declares a queue with a TPU quota, and
an application's summed TPU ask (instances x tpus across jobtypes) must
fit its queue's quota. With no queues configured the queue name is a
recorded tag only (standalone mode — matches the reference's default
queue behavior); once ANY queue is configured, submitting into an
undeclared queue is an error, not a silent no-op.

Validated twice, like resource caps: at client submission
(TonyClient.validate_conf) and again in the AM (conf files can reach the
AM without passing through this client).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from tony_tpu_torch.conf import keys as K

_QUEUE_KEY_RE = re.compile(r"^tony\.queues\.([^.]+)\.max-tpus$")
_QUEUE_ATTR_RE = re.compile(
    r"^tony\.queues\.([^.]+)\.(max-tpus|capacity-share|max-tpus-per-user"
    r"|parent)$")


def configured_queues(conf) -> dict[str, int]:
    """{queue: max_tpus} for every queue with an ABSOLUTE per-app cap.

    Deliberately narrower than `queue_specs` (any tony.queues.* attr
    declares a queue): the quota-utilization surfaces (fleet registry,
    portal per-queue bars, `cli top --queues-conf`) need an absolute
    chip cap to divide by — a share-only queue's capacity is relative
    to the arbiter's inventory and is enforced by cluster/arbiter.py,
    not renderable as a standalone utilization bar."""
    out: dict[str, int] = {}
    for key, value in conf.to_dict().items():
        m = _QUEUE_KEY_RE.match(key)
        if m:
            try:
                out[m.group(1)] = int(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{key}: quota must be an integer TPU count, "
                    f"got {value!r}") from None
    return out


@dataclass
class QueueSpec:
    """One declared queue, hierarchy-aware (cluster/arbiter.py input).

    `max_tpus` is the per-APPLICATION ask cap (the original, validated
    at submission); `capacity_share` is the percentage of the parent's
    capacity (root queues: of the arbiter's inventory) this queue may
    hold across RUNNING applications; `max_tpus_per_user` caps one
    user's running chips inside the queue. Any unset field (-1/None)
    means unlimited at that level."""
    name: str
    max_tpus: int = -1
    capacity_share: float = -1.0   # percent; -1 = uncapped
    max_tpus_per_user: int = -1
    parent: Optional[str] = None
    children: list = field(default_factory=list)

    def capacity_chips(self, total: int,
                       queues: dict[str, "QueueSpec"]) -> int:
        """Absolute chip capacity under `total` inventory: the share
        chain multiplied down from the root (unset shares pass the
        parent's capacity through)."""
        parent_cap = total
        if self.parent and self.parent in queues:
            parent_cap = queues[self.parent].capacity_chips(total, queues)
        if self.capacity_share < 0:
            return parent_cap
        return int(parent_cap * self.capacity_share / 100.0)


def queue_specs(conf) -> dict[str, QueueSpec]:
    """Every declared queue as a QueueSpec (any tony.queues.<name>.*
    attribute declares the queue), with parent links resolved. Raises
    ValueError on an unknown parent or a parent cycle — a malformed
    hierarchy must fail at conf time, not deep in an admission pass."""
    specs: dict[str, QueueSpec] = {}
    for key, value in conf.to_dict().items():
        m = _QUEUE_ATTR_RE.match(key)
        if not m:
            continue
        name, attr = m.group(1), m.group(2)
        spec = specs.setdefault(name, QueueSpec(name))
        try:
            if attr == "max-tpus":
                spec.max_tpus = int(value)
            elif attr == "capacity-share":
                spec.capacity_share = float(value)
            elif attr == "max-tpus-per-user":
                spec.max_tpus_per_user = int(value)
            else:
                spec.parent = str(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{key}: bad value {value!r}") from None
    for spec in specs.values():
        if spec.parent:
            if spec.parent not in specs:
                raise ValueError(
                    f"queue {spec.name!r}: unknown parent "
                    f"{spec.parent!r} (declare a tony.queues."
                    f"{spec.parent}.* key)")
            specs[spec.parent].children.append(spec.name)
    for spec in specs.values():
        seen = {spec.name}
        cur = spec.parent
        while cur:
            if cur in seen:
                raise ValueError(
                    f"queue hierarchy cycle through {cur!r}")
            seen.add(cur)
            cur = specs[cur].parent
    return specs


def queue_ancestry(name: str, queues: dict[str, QueueSpec]) -> list[str]:
    """[queue, parent, grandparent, ...] — usage charges every level."""
    chain = []
    cur: Optional[str] = name
    while cur and cur in queues:
        chain.append(cur)
        cur = queues[cur].parent
    if not chain:
        chain = [name]
    return chain


def app_priority(conf) -> int:
    """The application's arbitration priority (higher admits first,
    preempts last)."""
    return conf.get_int(K.APPLICATION_PRIORITY, 0)


def app_queue(conf) -> str:
    """The queue an application is (or was) submitted into — the one
    normalization of `tony.application.queue` shared by quota
    validation, the AM's fleet jobstate summary, and the portal."""
    return conf.get_str(K.APPLICATION_QUEUE, "default") or "default"


def total_requested_tpus(conf) -> int:
    return sum(conf.get_int(K.instances_key(j), 0)
               * conf.get_int(K.tpus_key(j), 0)
               for j in conf.job_types())


def validate_queue_quota(conf) -> None:
    """Raise ValueError (queue named in the message) when the app's TPU
    ask exceeds its queue's quota, or the queue isn't declared while
    others are. Declaration is ANY tony.queues.<name>.* attribute (a
    share-only queue is still a real queue); the per-app cap stays
    max-tpus."""
    queues = queue_specs(conf)
    if not queues:
        return
    queue = app_queue(conf)
    if queue not in queues:
        raise ValueError(
            f"unknown queue {queue!r}: configured queues are "
            f"{sorted(queues)} (declare tony.queues.{queue}.max-tpus "
            f"or submit into one of them)")
    cap = queues[queue].max_tpus
    total = total_requested_tpus(conf)
    if 0 <= cap < total:
        raise ValueError(
            f"queue {queue!r}: requested {total} TPUs exceeds the "
            f"queue's max-tpus quota of {cap}")
