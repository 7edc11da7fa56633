"""Control-plane message types: the port's copy of `tony_tpu/rpc/messages.py`.

Task status, task info, a metric and a log chunk as plain dataclasses with
the JAX package's dict codecs (the gRPC layer carries them as JSON).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, asdict
from typing import Any


class TaskStatus(str, enum.Enum):
    """Task lifecycle (reference: rpc/impl/TaskStatus.java)."""
    NEW = "NEW"
    SCHEDULED = "SCHEDULED"
    REQUESTED = "REQUESTED"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    FINISHED = "FINISHED"  # killed by the AM; completed but not a failure
    PREEMPTED = "PREEMPTED"  # checkpoint-then-evict drain: stopped on
                             # request, expected to resume from checkpoint

    def is_terminal(self) -> bool:
        return self in (TaskStatus.SUCCEEDED, TaskStatus.FAILED,
                        TaskStatus.FINISHED, TaskStatus.PREEMPTED)


@dataclass
class TaskInfo:
    """Mirrors rpc/TaskInfo.java:15-80: (name, index, url, status)."""
    name: str
    index: int
    url: str = ""
    status: TaskStatus = TaskStatus.NEW

    @property
    def task_id(self) -> str:
        return f"{self.name}:{self.index}"

    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        d["status"] = self.status.value
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TaskInfo":
        return cls(name=d["name"], index=int(d["index"]), url=d.get("url", ""),
                   status=TaskStatus(d.get("status", "NEW")))


@dataclass
class Metric:
    """One sampled metric (reference: rpc/MetricWritable.java)."""
    name: str
    value: float

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "value": self.value}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Metric":
        return cls(name=d["name"], value=float(d["value"]))


@dataclass
class LogChunk:
    """One bounded slice of a task's stdout/stderr (observability/logs.py
    LogTail shape, carried by read_task_logs / read_log). `next_offset`
    is the follow cursor; `source` says whether the bytes came live from
    the executor or from history-aggregated logs."""
    task_id: str = ""
    stream: str = "stderr"
    data: str = ""
    offset: int = 0
    next_offset: int = 0
    size: int = 0
    eof: bool = False
    source: str = "live"          # "live" | "aggregated"

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LogChunk":
        return cls(task_id=str(d.get("task_id", "")),
                   stream=str(d.get("stream", "stderr")),
                   data=str(d.get("data", "")),
                   offset=int(d.get("offset", 0) or 0),
                   next_offset=int(d.get("next_offset", 0) or 0),
                   size=int(d.get("size", 0) or 0),
                   eof=bool(d.get("eof", False)),
                   source=str(d.get("source", "live")))


def parse_task_id(task_id: str) -> tuple[str, int]:
    """'worker:1' -> ('worker', 1)."""
    name, _, idx = task_id.rpartition(":")
    return name, int(idx)
