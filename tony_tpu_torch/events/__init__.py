"""Event history subsystem (reference: tony-core avro schemas + events/EventHandler.java)."""

from tony_tpu_torch.events.schema import (
    Event, EventType, ApplicationInited, ApplicationFinished,
    ServingEndpointRegistered, TaskStarted, TaskFinished,
)
from tony_tpu_torch.events.handler import EventHandler
from tony_tpu_torch.events.history import (
    JobMetadata, history_file_name, parse_history_file_name,
)

__all__ = [
    "Event", "EventType", "ApplicationInited", "ApplicationFinished",
    "ServingEndpointRegistered", "TaskStarted", "TaskFinished",
    "EventHandler",
    "JobMetadata", "history_file_name", "parse_history_file_name",
]
