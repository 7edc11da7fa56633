"""HistoryFilePurger: retention deletes over the finished tree.

Equivalent of the reference's app/history/HistoryFilePurger.java:26-113:
periodically deletes finished/<yyyy>/<MM>/<dd>/<app> dirs whose history file
completed longer than `retention_sec` ago, then prunes empty date dirs.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.events.history import parse_history_file_name

LOG = logging.getLogger(__name__)


class HistoryFilePurger:
    def __init__(self, finished: str, retention_sec: float,
                 interval_ms: int = 6 * 3600 * 1000):
        self.finished = finished
        self.retention_sec = retention_sec
        self.interval_s = interval_ms / 1000.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="history-purger", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("history-purger", self.interval_s)
        while not self._stop.is_set():
            beacon.beat()
            try:
                self.purge_once()
            except Exception:  # noqa: BLE001 — keep the daemon alive
                LOG.exception("history purge pass failed")
            self._stop.wait(self.interval_s)
        beacon.idle()

    def purge_once(self, now_ms: int | None = None) -> list[str]:
        """Delete expired app dirs; returns the paths removed."""
        now_ms = now_ms if now_ms is not None else int(time.time() * 1000)
        cutoff_ms = now_ms - int(self.retention_sec * 1000)
        removed = []
        if not os.path.isdir(self.finished):
            return removed
        for dirpath, dirnames, filenames in os.walk(self.finished,
                                                    topdown=False):
            for fname in filenames:
                if not fname.endswith("." + C.HISTORY_SUFFIX):
                    continue
                try:
                    md = parse_history_file_name(fname)
                except ValueError:
                    continue
                if md.completed and md.completed < cutoff_ms:
                    LOG.info("purging expired history dir %s", dirpath)
                    shutil.rmtree(dirpath, ignore_errors=True)
                    removed.append(dirpath)
                    break
            # prune now-empty date dirs (but never the root)
            if (dirpath != self.finished and os.path.isdir(dirpath)
                    and not os.listdir(dirpath)):
                os.rmdir(dirpath)
        return removed
