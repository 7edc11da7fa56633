"""PortalCache: job metadata/config/event/log caches over the history tree.

Equivalent of the reference's app/cache/CacheWrapper.java:28-132 (four Guava
caches warmed from HDFS). Finished history files are immutable, so entries
are cached by path; in-progress apps are re-read when their file mtime
changes. Eviction is LRU with a max entry count
(tony.portal.cache-max-entries).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
from dataclasses import asdict
from typing import Any, Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.events.handler import parse_events
from tony_tpu_torch.events.history import JobMetadata, parse_history_file_name
from tony_tpu_torch.events.schema import EventType

LOG = logging.getLogger(__name__)


class _LRU:
    def __init__(self, max_entries: int):
        self.max_entries = max_entries
        self._d: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)


class PortalCache:
    def __init__(self, intermediate: str, finished: str,
                 max_entries: int = 1000):
        self.intermediate = intermediate
        self.finished = finished
        self._lock = threading.Lock()
        # path -> (mtime, parsed events); immutable finals hit by path
        self._events = _LRU(max_entries)
        self._configs = _LRU(max_entries)
        # observability sidecars (spans.json / metrics.json), same scheme
        self._sidecars = _LRU(max_entries)
        # finished app dirs are immutable once moved: job_id -> dir
        self._finished_dirs: dict[str, str] = {}
        # a job's queue never changes: job_id -> queue, no re-stat
        self._queues: dict[str, str] = {}

    # -- directory scan ----------------------------------------------------
    def _finished_app_dirs(self):
        """(app_id, dir) for the finished tree, memoized — moved dirs never
        change, so one full walk amortizes across requests (reference:
        CacheWrapper's warmed metadata cache)."""
        seen = dict(self._finished_dirs)
        if os.path.isdir(self.finished):
            for dirpath, dirnames, filenames in os.walk(self.finished):
                if any(f.endswith("." + C.HISTORY_SUFFIX)
                       for f in filenames):
                    seen[os.path.basename(dirpath)] = dirpath
                    dirnames[:] = []
        # drop entries the purger deleted
        seen = {k: v for k, v in seen.items() if os.path.isdir(v)}
        with self._lock:
            self._finished_dirs = seen
        return seen

    def _app_dirs(self):
        """Yield (app_id, app_dir) across intermediate + finished trees."""
        if os.path.isdir(self.intermediate):
            for name in sorted(os.listdir(self.intermediate)):
                d = os.path.join(self.intermediate, name)
                if os.path.isdir(d):
                    yield name, d
        yield from self._finished_app_dirs().items()

    def _find_app_dir(self, job_id: str) -> Optional[str]:
        # running apps first (cheap single listdir), then the memoized
        # finished map, re-walking only on a miss (a just-moved app)
        candidate = os.path.join(self.intermediate, job_id)
        if os.path.isdir(candidate):
            return candidate
        with self._lock:
            cached = self._finished_dirs.get(job_id)
        if cached and os.path.isdir(cached):
            return cached
        return self._finished_app_dirs().get(job_id)

    @staticmethod
    def _history_file(app_dir: str) -> Optional[str]:
        """The jhist (final preferred over inprogress) in an app dir."""
        final, inprog = None, None
        for f in os.listdir(app_dir):
            if f.endswith("." + C.HISTORY_SUFFIX):
                final = os.path.join(app_dir, f)
            elif f.endswith("." + C.HISTORY_INPROGRESS_SUFFIX):
                inprog = os.path.join(app_dir, f)
        return final or inprog

    # -- public API (the four caches) -------------------------------------
    def list_metadata(self) -> list[JobMetadata]:
        """All known jobs, newest first (reference: metadata cache)."""
        out = []
        for name, d in self._app_dirs():
            hist = self._history_file(d)
            if hist is None:
                continue
            try:
                out.append(parse_history_file_name(os.path.basename(hist)))
            except ValueError:
                continue
        out.sort(key=lambda m: m.started, reverse=True)
        return out

    def get_metadata(self, job_id: str) -> Optional[JobMetadata]:
        d = self._find_app_dir(job_id)
        if d is None:
            return None
        hist = self._history_file(d)
        if hist is None:
            return None
        try:
            return parse_history_file_name(os.path.basename(hist))
        except ValueError:
            return None

    def get_events(self, job_id: str) -> list[dict[str, Any]]:
        """Parsed event dicts for a job (reference: event cache)."""
        d = self._find_app_dir(job_id)
        if d is None:
            return []
        hist = self._history_file(d)
        if hist is None:
            return []
        mtime = os.path.getmtime(hist)
        with self._lock:
            cached = self._events.get(hist)
            if cached is not None and cached[0] == mtime:
                return cached[1]
        try:
            events = [e.to_dict() for e in parse_events(hist)]
        except Exception:  # noqa: BLE001 — damaged file, serve empty
            LOG.exception("failed to parse %s", hist)
            return []
        with self._lock:
            self._events.put(hist, (mtime, events))
        return events

    def get_config(self, job_id: str) -> dict[str, Any]:
        """The frozen per-job config (reference: config cache reading the
        config.xml the AM wrote into the history dir)."""
        d = self._find_app_dir(job_id)
        if d is None:
            return {}
        path = os.path.join(d, C.PORTAL_CONFIG_FILE)
        if not os.path.isfile(path):
            return {}
        mtime = os.path.getmtime(path)
        with self._lock:
            cached = self._configs.get(path)
            if cached is not None and cached[0] == mtime:
                return cached[1]
        try:
            with open(path, "r", encoding="utf-8") as f:
                conf = json.load(f)
        except Exception:  # noqa: BLE001
            LOG.exception("failed to read %s", path)
            return {}
        with self._lock:
            self._configs.put(path, (mtime, conf))
        return conf

    def _get_sidecar(self, job_id: str, filename: str, default: Any) -> Any:
        """mtime-cached JSON sidecar from the app's history dir (the AM
        flushes spans.json/metrics.json next to the jhist)."""
        d = self._find_app_dir(job_id)
        if d is None:
            return default
        path = os.path.join(d, filename)
        if not os.path.isfile(path):
            return default
        mtime = os.path.getmtime(path)
        with self._lock:
            cached = self._sidecars.get(path)
            if cached is not None and cached[0] == mtime:
                return cached[1]
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except Exception:  # noqa: BLE001 — damaged sidecar, serve default
            LOG.exception("failed to read %s", path)
            return default
        if not isinstance(data, type(default)):
            return default
        with self._lock:
            self._sidecars.put(path, (mtime, data))
        return data

    def get_spans(self, job_id: str) -> list[dict[str, Any]]:
        """Lifecycle spans for the job page's waterfall (spans.json)."""
        return self._get_sidecar(job_id, C.SPANS_FILE, [])

    def get_serving_traces(self, job_id: str) -> list[dict[str, Any]]:
        """Tail-sampled serving request traces (serving_traces.json
        sidecar, observability/reqtrace.py record shape) — the job
        page's request-waterfall + slowest-requests source. [] for
        jobs that never served."""
        return self._get_sidecar(job_id, C.SERVING_TRACES_FILE, [])

    def get_metrics_timeseries(self, job_id: str) -> dict[str, Any]:
        """Per-gauge trajectories ({task: {metric: [[ts, v], ...]}}) —
        the /jobs/:id/metrics.json payload (metrics.json sidecar)."""
        return self._get_sidecar(job_id, C.METRICS_FILE, {})

    def get_goodput(self, job_id: str) -> dict[str, Any]:
        """Time-accounting aggregate ({tasks, job} — see
        observability/perf.aggregate_goodput); goodput.json sidecar."""
        return self._get_sidecar(job_id, C.GOODPUT_FILE, {})

    def get_skew(self, job_id: str) -> dict[str, Any]:
        """Cross-task skew bundle (skew.json sidecar): gang sketch
        summaries per signal, the tasks x windows step-time heatmap,
        latched stragglers + detection log. {} for old jobs."""
        return self._get_sidecar(job_id, C.SKEW_FILE, {})

    def get_alerts(self, job_id: str) -> dict[str, Any]:
        """Alert bundle (alerts.json sidecar): currently-firing alerts
        + the bounded transition log. The AM refreshes it on every
        transition, so this is live-ish even mid-run. {} for old jobs
        or jobs that never alerted."""
        return self._get_sidecar(job_id, C.ALERTS_FILE, {})

    def get_diagnostics(self, job_id: str) -> dict[str, Any]:
        """Root-cause bundle a failed job's AM flushed
        (diagnostics.json sidecar): first-failing task, exit signal,
        matched signature, redacted tails. {} for succeeded/old jobs."""
        return self._get_sidecar(job_id, C.DIAGNOSTICS_FILE, {})

    def get_profile_folded(self, job_id: str) -> str:
        """Collapsed-stack control-plane profile (profile.folded
        sidecar — plain-text `stack count` lines the AM's sampling
        profiler flushed at finish; NOT JSON, so it bypasses
        _get_sidecar). "" for jobs that predate the profiler."""
        d = self._find_app_dir(job_id)
        if d is None:
            return ""
        from tony_tpu_torch.events.history import read_profile_file
        return read_profile_file(d)

    def get_am_info(self, job_id: str) -> dict[str, Any]:
        """The AM's RPC address ({host, rpc_port}) written into the
        history dir at prepare — how the portal reaches a RUNNING job's
        control plane (profile-capture POST). Stale for finished jobs;
        callers treat connection failures as 'job not running'."""
        return self._get_sidecar(job_id, C.AM_INFO_FILE, {})

    def get_log_links(self, job_id: str) -> list[dict[str, Any]]:
        """Per-task log links. The reference synthesized NodeManager
        containerlogs URLs (models/JobLog.java:27-60) pointing at a live
        NM web server; no such server exists here, so links point at the
        portal's OWN /logs/:jobId/:dir/:stream routes over the logs the
        AM aggregated into the history dir. Tasks whose logs haven't
        been aggregated yet (still running) get url="" — never a URL
        that can't resolve."""
        d = self._find_app_dir(job_id)
        logs_root = (os.path.join(d, C.HISTORY_LOGS_DIR_NAME)
                     if d else None)
        # host/container enrichment from TASK_STARTED events, keyed by
        # the AM's container-dir naming <jobtype>_<index>_s<session>
        started: dict[str, dict] = {}
        for ev in self.get_events(job_id):
            if ev["type"] != EventType.TASK_STARTED.value:
                continue
            p = ev["payload"]
            # later sessions (AM retries) overwrite earlier ones
            started[f'{p["task_type"]}:{p["task_index"]}'] = p
        links, seen = [], set()
        if logs_root and os.path.isdir(logs_root):
            for cdir in sorted(os.listdir(logs_root)):
                streams = [s for s in ("stdout", "stderr")
                           if os.path.isfile(
                               os.path.join(logs_root, cdir, s))]
                if not streams:
                    continue
                task, attempt = self._task_label(cdir)
                p = started.get(task, {})
                seen.add(task)
                links.append({
                    "task": task,
                    "attempt": attempt,
                    "host": p.get("host", ""),
                    "container_id": p.get("container_id", ""),
                    "url": f"/logs/{job_id}/{cdir}/stdout",
                    "streams": {
                        s: f"/logs/{job_id}/{cdir}/{s}"
                        for s in streams},
                })
        for task, p in started.items():
            if task not in seen:       # running / not yet aggregated
                links.append({
                    "task": task, "attempt": 0, "host": p.get("host", ""),
                    "container_id": p.get("container_id", ""),
                    "url": "", "streams": {},
                })
        return links

    # `worker_0_s1` / `worker_0_s1_a2` (relaunched attempts get an
    # attempt-suffixed dir, application_master._on_container_allocated)
    _CDIR_RE = re.compile(
        r"^(?P<job>.+)_(?P<idx>\d+)_s\d+(?:_a(?P<attempt>\d+))?$")

    @classmethod
    def _task_label(cls, container_dir: str) -> tuple[str, int]:
        """`worker_0_s1` -> ("worker:0", 0); `worker_0_s1_a2` ->
        ("worker:0", 2). Non-task dirs (`am`) pass through as
        (name, 0) — ALL attempts of a slot share one task label, with
        the attempt number carried separately so callers can pick the
        newest evidence."""
        m = cls._CDIR_RE.match(container_dir)
        if m is None:
            return container_dir, 0
        return (f"{m.group('job')}:{m.group('idx')}",
                int(m.group("attempt") or 0))

    def get_log_file(self, job_id: str, container_dir: str,
                     stream: str) -> Optional[str]:
        """Path of an aggregated log file, with containment checks (the
        serving route must not traverse outside the app's logs dir)."""
        if stream not in ("stdout", "stderr"):
            return None
        d = self._find_app_dir(job_id)
        if d is None:
            return None
        root = os.path.realpath(os.path.join(d, C.HISTORY_LOGS_DIR_NAME))
        path = os.path.realpath(os.path.join(root, container_dir, stream))
        if not path.startswith(root + os.sep) or not os.path.isfile(path):
            return None
        return path

    def get_queue(self, job_id: str) -> str:
        """The job's scheduler queue, memoized forever (immutable) — the
        index page reads it per row and must not re-stat config.json on
        every render."""
        with self._lock:
            cached = self._queues.get(job_id)
        if cached is not None:
            return cached
        conf = self.get_config(job_id)
        queue = str(conf.get("tony.application.queue", "default")
                    or "default")
        if conf:
            # memoize only once the config snapshot exists — a RUNNING
            # job may not have written it yet
            with self._lock:
                self._queues[job_id] = queue
        return queue

    def metadata_dicts(self) -> list[dict[str, Any]]:
        return [asdict(m) for m in self.list_metadata()]
