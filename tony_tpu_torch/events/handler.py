"""EventHandler: async event log writer.

The port's copy of `tony_tpu/events/handler.py`.

Equivalent of the reference's events/EventHandler.java:43-155 — a
producer-consumer thread draining a queue of events into an append-only
history file. Events land in `<dir>/<appId>-<started>-<user>.jhist.inprogress`
(JSON lines instead of Avro container files); on stop the queue is drained
and the file renamed to the final
`<appId>-<started>-<completed>-<user>-<STATUS>.jhist` name.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from typing import Optional

from tony_tpu_torch.events.schema import Event
from tony_tpu_torch.events.history import (
    JobMetadata, inprogress_file_name, history_file_name,
    parse_history_file_name,
)

LOG = logging.getLogger(__name__)


class EventHandler:
    def __init__(self, history_dir: str, metadata: JobMetadata,
                 resume: bool = False):
        self._dir = history_dir
        self._metadata = metadata
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, name="event-handler",
                                        daemon=True)
        self._started = False
        self._stopped = False
        os.makedirs(self._dir, exist_ok=True)
        if resume:
            # AM crash recovery: adopt the previous attempt's in-progress
            # file so the job ends with exactly ONE .jhist. The original
            # `started`/user are encoded in the file name — restore them
            # into our metadata so the final rename matches the history
            # this file already holds.
            self._adopt_inprogress()
        self._inprogress_path = os.path.join(self._dir,
                                             inprogress_file_name(metadata))
        self._file = open(self._inprogress_path, "a", encoding="utf-8")

    def _adopt_inprogress(self) -> None:
        for name in sorted(os.listdir(self._dir)):
            if not name.endswith(".inprogress"):
                continue
            try:
                md = parse_history_file_name(name)
            except ValueError:
                continue
            if md.application_id == self._metadata.application_id:
                self._metadata.started = md.started
                self._metadata.user = md.user
                return

    # -- producer side ----------------------------------------------------
    def emit(self, event: Event) -> None:
        """Enqueue an event (reference: emitEvent, EventHandler.java:97-104).
        Never blocks the caller; drops with a log if already stopped."""
        if self._stopped:
            LOG.warning("event emitted after stop, dropping: %s", event.type)
            return
        self._queue.put(event)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._started = True
        self._thread.start()

    def stop(self, final_status: str) -> str:
        """Drain remaining events, close, rename to the final history file
        (reference: EventHandler.java:126-155). Returns the final path."""
        self._stopped = True
        if self._started:
            self._queue.put(None)  # sentinel
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # consumer wedged in a write (hung filesystem): do NOT close
                # or rename underneath it — leave the .inprogress file behind
                LOG.error("event consumer did not stop in 30s; leaving %s",
                          self._inprogress_path)
                return self._inprogress_path
        self._drain_sync()
        self._file.close()
        import time
        self._metadata.completed = int(time.time() * 1000)
        self._metadata.status = final_status
        final_path = os.path.join(self._dir, history_file_name(self._metadata))
        os.replace(self._inprogress_path, final_path)
        return final_path

    # -- consumer side ----------------------------------------------------
    def _run(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        # queue-driven: idle() before the blocking get() so an empty
        # queue is not a stall; an ACTIVE beacon means _write is wedged
        beacon = register_beacon("event-writer", 5.0)
        while True:
            beacon.idle()
            event = self._queue.get()
            beacon.beat()
            if event is None:
                beacon.idle()
                return
            self._write(event)

    def _drain_sync(self) -> None:
        while True:
            try:
                event = self._queue.get_nowait()
            except queue.Empty:
                return
            if event is not None:
                self._write(event)

    def _write(self, event: Event) -> None:
        try:
            self._file.write(json.dumps(event.to_dict()) + "\n")
            self._file.flush()
        except Exception:  # noqa: BLE001 — never kill the job for history IO
            LOG.exception("failed to write event %s", event.type)


def parse_events(path: str) -> list[Event]:
    """Read a history file back into events (reference:
    util/ParserUtils.parseEvents, util/ParserUtils.java:258-285)."""
    events = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(Event.from_dict(json.loads(line)))
    return events
