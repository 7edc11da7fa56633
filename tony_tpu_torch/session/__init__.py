"""Job session state machine + DAG scheduler (reference: tensorflow/TonySession.java,
TaskScheduler.java)."""

from tony_tpu_torch.session.session import (
    TonySession, Task, FinalStatus, EXIT_KILLED_BY_AM,
)
from tony_tpu_torch.session.requests import JobContainerRequest, parse_container_requests
from tony_tpu_torch.session.scheduler import TaskScheduler, ResourceRequestor

__all__ = [
    "TonySession", "Task", "FinalStatus", "EXIT_KILLED_BY_AM",
    "JobContainerRequest", "parse_container_requests",
    "TaskScheduler", "ResourceRequestor",
]
