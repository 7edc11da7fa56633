"""HistoryStoreFetcher: pull finished job history from the staging store.

On a multi-host fleet the AM runs off the portal host, so its local
history dir is unreachable; `ApplicationMaster._publish_history` uploads
the finalized jhist + config snapshot to `<location>/<app_id>/history/*`
and this daemon syncs those keys into the portal's intermediate dir,
where the existing mover/cache pipeline takes over (finalized jhist files
move straight to `finished/`). Reference role: the portal reading jhist
off HDFS (tony-portal HistoryFileMover over the shared store;
events/EventHandler.java:97-113 wrote it there).
"""

from __future__ import annotations

import logging
import os
import threading

from tony_tpu_torch import constants as C
from tony_tpu_torch.storage import location_store

LOG = logging.getLogger(__name__)


class HistoryStoreFetcher:
    """Periodically mirror `<location>/<app_id>/history/<file>` into
    `<intermediate>/<app_id>/<file>`. Files are immutable once published
    (the AM uploads only FINALIZED jhist), so presence == done and the
    sync is a cheap list+fetch of new keys."""

    def __init__(self, location: str, intermediate: str,
                 interval_ms: int = 60_000, finished: str = ""):
        self._location = location
        self._intermediate = intermediate
        # mover destination tree: an app already moved there must not be
        # re-fetched into intermediate (it would churn the network every
        # pass and pile copies into duplicates/ forever)
        self._finished = finished
        self._moved_apps: set[str] = set()
        self._interval_sec = interval_ms / 1000.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="history-fetcher", daemon=True)

    def _app_moved(self, app_id: str) -> bool:
        """Is the app already under finished/ (memoized — moved dirs are
        immutable, so a hit never needs re-checking)?"""
        if not self._finished:
            return False
        if app_id in self._moved_apps:
            return True
        for dirpath, dirnames, _ in os.walk(self._finished):
            if os.path.basename(dirpath) == app_id:
                self._moved_apps.add(app_id)
                return True
        return False

    def fetch_once(self) -> list[str]:
        """One sync pass; returns newly fetched destination paths."""
        store = location_store(self._location)
        fetched = []
        try:
            keys = store.list_keys()
        except Exception:  # noqa: BLE001 — store hiccups must not kill us
            LOG.exception("history store listing failed")
            return fetched
        logs_dir = C.HISTORY_LOGS_DIR_NAME
        moved: dict[str, bool] = {}      # one finished-tree check per app
        for key in keys:
            parts = key.split("/")
            if len(parts) == 3 and parts[1] == "history":
                app_id, fname = parts[0], parts[2]
                dest = os.path.join(self._intermediate, app_id, fname)
            elif (len(parts) == 5 and parts[1] == "history"
                  and parts[2] == logs_dir):
                # aggregated container logs:
                # <app>/history/logs/<container-dir>/<stream>
                app_id, cdir, fname = parts[0], parts[3], parts[4]
                dest = os.path.join(self._intermediate, app_id, logs_dir,
                                    cdir, fname)
            else:
                continue
            if app_id not in moved:
                moved[app_id] = self._app_moved(app_id)
            if os.path.exists(dest) or moved[app_id]:
                continue
            try:
                # fetch to a tmp name + atomic rename: `dest` existing is
                # the done-marker, so a crash mid-copy must never leave a
                # truncated file under the final name (the mover would
                # finalize corrupt history and every later pass skip it)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                tmp = dest + ".fetch-tmp"
                store.fetch(store.uri(key), tmp)
                os.replace(tmp, dest)
                fetched.append(dest)
            except Exception:  # noqa: BLE001
                LOG.exception("failed to fetch history key %s", key)
        if fetched:
            LOG.info("fetched %d history file(s) from %s", len(fetched),
                     self._location)
        return fetched

    def _run(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("history-fetcher", self._interval_sec)
        while not self._stop.wait(self._interval_sec):
            beacon.beat()
            self.fetch_once()
        beacon.idle()

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
