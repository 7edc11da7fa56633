"""HistoryFileMover: intermediate → finished/yyyy/MM/dd relocation.

Equivalent of the reference's app/history/HistoryFileMover.java:35-169: a
background loop that (a) moves per-app history dirs containing a *final*
jhist file from the intermediate dir into a finished/<yyyy>/<MM>/<dd>/ tree
keyed by completion date, and (b) finalizes apps that died without renaming
their `.jhist.inprogress` (the reference detects these via the RM's app
state; without an RM we treat an inprogress file whose mtime is older than
`stale_sec` as killed and rename it with KILLED status before moving).
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import threading
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.events.history import (
    JobMetadata, history_file_name, parse_history_file_name,
)

LOG = logging.getLogger(__name__)


def ensure_history_dirs(intermediate: str, finished: str) -> None:
    """Create/verify the history tree (reference: app/hadoop/
    Requirements.java:24-120 minus the kerberos login)."""
    for d in (intermediate, finished):
        os.makedirs(d, exist_ok=True)
        if not os.access(d, os.W_OK):
            raise PermissionError(f"history dir not writable: {d}")


def finished_subdir(finished: str, completed_ms: int) -> str:
    """finished/<yyyy>/<MM>/<dd> from the completion timestamp
    (reference: HistoryFileMover.java:74-117)."""
    dt = datetime.datetime.fromtimestamp(completed_ms / 1000.0,
                                         tz=datetime.timezone.utc)
    return os.path.join(finished, f"{dt.year:04d}", f"{dt.month:02d}",
                        f"{dt.day:02d}")


class HistoryFileMover:
    def __init__(self, intermediate: str, finished: str,
                 interval_ms: int = 5 * 60 * 1000,
                 stale_sec: float = 24 * 3600.0):
        self.intermediate = intermediate
        self.finished = finished
        self.interval_s = interval_ms / 1000.0
        self.stale_sec = stale_sec
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="history-mover", daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        ensure_history_dirs(self.intermediate, self.finished)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("history-mover", self.interval_s)
        while not self._stop.is_set():
            beacon.beat()
            try:
                self.move_once()
            except Exception:  # noqa: BLE001 — keep the daemon alive
                LOG.exception("history move pass failed")
            self._stop.wait(self.interval_s)
        beacon.idle()

    # -- one pass ----------------------------------------------------------
    def move_once(self) -> list[str]:
        """Scan the intermediate dir; returns destination paths moved."""
        moved = []
        if not os.path.isdir(self.intermediate):
            return moved
        for name in sorted(os.listdir(self.intermediate)):
            app_dir = os.path.join(self.intermediate, name)
            if not os.path.isdir(app_dir):
                continue
            md = self._finalize_app_dir(app_dir)
            if md is None:
                continue  # still running
            dest_parent = finished_subdir(self.finished, md.completed)
            os.makedirs(dest_parent, exist_ok=True)
            dest = os.path.join(dest_parent, name)
            if os.path.exists(dest):
                # An AM retry may have regenerated history after an earlier
                # move — never destroy the newer copy; park it for manual
                # reconciliation OUTSIDE the finished tree (PortalCache
                # walks finished/ and would list a parked copy as a
                # phantom application).
                dup_parent = os.path.join(
                    os.path.dirname(self.finished.rstrip(os.sep)),
                    "duplicates")
                os.makedirs(dup_parent, exist_ok=True)
                dup = os.path.join(dup_parent,
                                   f"{name}.dup-{int(time.time())}")
                while os.path.exists(dup):
                    dup += "x"
                shutil.move(app_dir, dup)
                LOG.warning("destination exists, kept duplicate at %s", dup)
                continue
            shutil.move(app_dir, dest)
            LOG.info("moved history %s -> %s", app_dir, dest)
            moved.append(dest)
        return moved

    def _finalize_app_dir(self, app_dir: str):
        """Return final JobMetadata if the app dir is ready to move.
        Renames stale .jhist.inprogress files to -KILLED finals first
        (reference: HistoryFileMover.java:135-169)."""
        for fname in os.listdir(app_dir):
            if fname.endswith("." + C.HISTORY_SUFFIX):
                try:
                    return parse_history_file_name(fname)
                except ValueError:
                    continue
        for fname in os.listdir(app_dir):
            if not fname.endswith("." + C.HISTORY_INPROGRESS_SUFFIX):
                continue
            path = os.path.join(app_dir, fname)
            mtime = os.path.getmtime(path)
            if time.time() - mtime < self.stale_sec:
                return None  # presumed still running
            try:
                md = parse_history_file_name(fname)
            except ValueError:
                continue
            killed = JobMetadata(application_id=md.application_id,
                                 started=md.started,
                                 completed=int(mtime * 1000),
                                 user=md.user, status="KILLED")
            final = os.path.join(app_dir, history_file_name(killed))
            os.replace(path, final)
            LOG.info("finalized stale inprogress history as KILLED: %s", final)
            return killed
        return None
