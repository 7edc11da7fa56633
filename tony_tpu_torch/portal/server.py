"""Portal HTTP server: job list, per-job config/events/logs.

The port's copy of `tony_tpu/portal/server.py`; only its imports differ.
The pages keep the JAX package's labels, so the two portals render the
same history alike: the `TPU_UTILIZATION` and `MAX_/AVG_TPU_HBM_BYTES`
series a port job shows are the card's duty and memory as the port's
executor reads them (`executor/cuda_metrics.py`).

Equivalent of the reference's tony-portal Play routes (tony-portal/conf/
routes:1-5): `/`, `/config/:jobId`, `/jobs/:jobId`, `/logs/:jobId` rendered
as HTML, plus the same data under `/api/...` as JSON (the idiomatic
replacement for Play's scala.html templates). Runs on the stdlib threading
HTTP server — the portal is read-only observability, off the training path.
"""

from __future__ import annotations

import html
import json
import logging
import os
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from tony_tpu_torch.portal.cache import PortalCache

LOG = logging.getLogger(__name__)

_PAGE = """<!doctype html><html><head><title>TonY-TPU portal</title>
<style>
body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #ccc;padding:4px 10px;text-align:left}}
th{{background:#eee}}a{{text-decoration:none}}
.RUNNING{{color:#b8860b}}.SUCCEEDED{{color:green}}.FAILED{{color:red}}
.KILLED{{color:#555}}.LOST{{color:#c0392b;font-style:italic}}
.PREEMPTED{{color:#8e44ad}}
.waterfall td{{vertical-align:middle}}
.spanbar{{height:10px;border-radius:2px;min-width:2px}}
</style></head><body><h2>{title}</h2>{body}</body></html>"""


def read_user_tokens(path: str) -> dict[str, str]:
    """Parse a `user=token`-per-line credentials file (blank lines and
    #-comments ignored) — the tony.portal.user-tokens-file format."""
    out: dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            user, sep, tok = line.partition("=")
            if sep and user.strip() and tok.strip():
                out[user.strip()] = tok.strip()
    return out


def _table(headers: list[str], rows: list[list[str]]) -> str:
    head = "".join(f"<th>{h}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _probe_serving_load(url: str, timeout: float = 1.5) -> Optional[dict]:
    """One bounded /v1/load probe against a serving replica (the same
    snapshot the fleet router polls) for the job page's paged-KV panel.
    Any failure degrades to None — a page render never blocks on a sick
    replica."""
    if not url:
        return None
    import urllib.request
    try:
        with urllib.request.urlopen(url.rstrip("/") + "/v1/load",
                                    timeout=timeout) as resp:
            load = json.loads(resp.read().decode("utf-8"))
        return load if isinstance(load, dict) else None
    except Exception:  # noqa: BLE001 — panel extras are best-effort
        return None


def _now_ms() -> int:
    import time
    return int(time.time() * 1000)


def _fmt_ts(ms: int) -> str:
    import datetime
    if not ms:
        return "-"
    return datetime.datetime.fromtimestamp(
        ms / 1000.0).strftime("%Y-%m-%d %H:%M:%S")


class _Handler(BaseHTTPRequestHandler):
    cache: PortalCache  # injected by PortalServer
    token: Optional[str] = None  # injected by PortalServer; None = open
    # named per-user tokens (tony.portal.user-tokens); a match scopes job
    # visibility to that user's own jobs, while the shared `token` above
    # stays the all-seeing admin credential. This is the multi-tenant
    # identity layer the reference got from Kerberos + service ACLs
    # (TonyPolicyProvider.java:23, TokenCache.java:44-72) re-based on the
    # rebuild's token scheme.
    user_tokens: dict[str, str] = {}
    # fleet layer (observability/fleet.py FleetView) — None when no
    # staging/history-store location is configured: the live cross-job
    # registry, chip-hour accounting, and quota views behind /, /metrics,
    # /api/fleet and /api/fleet/queues
    fleet = None
    # index-table bound (tony.fleet.history-jobs): newest N rows render,
    # the footer carries the full count
    history_jobs: int = 200

    # -- plumbing ----------------------------------------------------------
    def log_message(self, fmt, *args):  # route through logging, not stderr
        LOG.debug("portal: " + fmt, *args)

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype + "; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _html(self, title: str, body: str, code: int = 200) -> None:
        self._send(code, _PAGE.format(title=html.escape(title), body=body),
                   "text/html")

    def _json(self, obj: Any, code: int = 200) -> None:
        self._send(code, json.dumps(obj, indent=1), "application/json")

    def _authorized(self) -> bool:
        """Bearer-token gate: constant-time compare of
        `Authorization: Bearer <tok>` or `?token=<tok>` against the
        configured portal token. Job configs can embed user env k=v pairs
        (tony.execution.env), so every data route is gated."""
        self._auth_user: Optional[str] = None   # None = admin / open
        if self.token is None and not self.user_tokens:
            return True
        supplied = ""
        via_query = False
        auth = self.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            supplied = auth[len("Bearer "):].strip()
        else:
            qs = parse_qs(urlparse(self.path).query)
            supplied = (qs.get("token") or [""])[0]
            via_query = True
        # byte compare: compare_digest raises TypeError on non-ASCII str
        # operands, which a scanner's %C3%A9-style token would trigger
        supplied_b = supplied.encode("utf-8", "replace")
        ok = self.token is not None and secrets.compare_digest(
            supplied_b, self.token.encode())
        # check EVERY named token even after a match so response timing
        # doesn't depend on which user's token was supplied
        for user, tok in self.user_tokens.items():
            if secrets.compare_digest(supplied_b, tok.encode()) and not ok:
                self._auth_user = user
                ok = True
        # query-authenticated browsers don't resend the token on link
        # clicks — propagate it into generated page links
        self._link_qs = f"?token={supplied}" if ok and via_query else ""
        return ok

    def _visible(self, owner: Optional[str]) -> bool:
        """Owner scoping: admin (or open portal) sees everything; a named
        user sees only jobs whose history records them as the user.
        Callers pass the owner they already hold — no metadata refetch."""
        return self._auth_user is None or owner == self._auth_user

    # -- routing -----------------------------------------------------------
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        path = urlparse(self.path).path.rstrip("/") or "/"
        parts = [p for p in path.split("/") if p]
        try:
            if path == "/healthz":   # liveness probe stays tokenless
                return self._json({"ok": True})
            if not self._authorized():
                if parts and parts[0] == "api":
                    return self._json({"error": "unauthorized"}, 401)
                return self._html("unauthorized",
                                  "<p>401: missing or invalid token</p>", 401)
            if path == "/":
                return self._index()
            if path == "/metrics":
                return self._metrics()
            if parts[0] == "api":
                return self._api(parts[1:])
            if (len(parts) == 3 and parts[0] == "jobs"
                    and parts[2] == "metrics.json"):
                # scrape-friendly alias of /api/jobs/:id/metrics — the
                # gauge trajectories the AM flushed into history
                job_id = parts[1]
                md = self.cache.get_metadata(job_id)
                if md is None or not self._visible(md.user):
                    return self._json({"error": "not found"}, 404)
                return self._json(self.cache.get_metrics_timeseries(job_id))
            if (len(parts) in (2, 4) and parts[0] in ("jobs", "config",
                                                      "logs")):
                job_id = parts[1]
                md = self.cache.get_metadata(job_id)
                # another user's job 404s identically to a missing one:
                # a scoped token must not even confirm existence
                if md is None or not self._visible(md.user):
                    return self._html("not found",
                                      f"<p>no such job {html.escape(job_id)}</p>",
                                      404)
                if len(parts) == 4 and parts[0] == "logs":
                    # /logs/:jobId/:containerDir/:stream — the served
                    # replacement for the reference's NM containerlogs
                    return self._log_file(job_id, parts[2], parts[3])
                if len(parts) == 2:
                    return getattr(self, "_" + parts[0])(job_id)
            self._html("not found", "<p>404</p>", 404)
        except Exception:  # noqa: BLE001
            LOG.exception("portal request failed: %s", self.path)
            self._html("error", "<p>internal error</p>", 500)

    def _metrics(self) -> None:
        """Fleet-level Prometheus exposition: every live job's
        `tony_job_*` gauges with {app_id, queue, user} labels (see
        fleet.fleet_families) + this portal process's own health
        registry — one scrape target for the whole cluster."""
        from tony_tpu_torch.observability.metrics import REGISTRY
        from tony_tpu_torch.observability.prometheus import render
        families = []
        if self.fleet is not None:
            from tony_tpu_torch.observability.fleet import fleet_families
            self.fleet.refresh()
            # owner scoping holds on the scrape too: a user-scoped token
            # must not read another tenant's labeled job gauges
            live = [j for j in self._fleet_jobs_visible()
                    if j.get("state") == "RUNNING"]
            families += fleet_families(live, self.fleet.queues)
            if self.fleet.alert_engine is not None \
                    and self._auth_user is None:
                # cluster-level firing alerts (queues, LOST jobs) are
                # admin-plane: a scoped token's scrape stays job-only
                from tony_tpu_torch.observability.alerts import (
                    alert_firing_families,
                )
                families += alert_firing_families(
                    self.fleet.alert_engine.firing())
        families += REGISTRY.families()
        self._send(200, render(families), "text/plain; version=0.0.4")

    def _fleet_jobs_visible(self) -> list[dict]:
        """The registry's jobs this credential may see (owner scoping
        matches the history routes: a named user sees only their own)."""
        return [j for j in self.fleet.registry.jobs()
                if self._visible(j.get("user"))]

    def _api(self, parts: list[str]) -> None:
        if parts == ["jobs"]:
            return self._json([d for d in self.cache.metadata_dicts()
                               if self._visible(d["user"])])
        if parts and parts[0] == "fleet":
            if self.fleet is None:
                return self._json(
                    {"error": "fleet view disabled (no history-store/"
                              "staging location configured)"}, 404)
            self.fleet.refresh()
            if parts == ["fleet"]:
                from tony_tpu_torch.observability.fleet import chips_of
                payload = self.fleet.api_fleet()
                jobs = [j for j in payload["jobs"]
                        if self._visible(j.get("user"))]
                payload["jobs"] = jobs
                payload["live_jobs"] = sum(
                    1 for j in jobs if j.get("state") == "RUNNING")
                if self._auth_user is not None:
                    # a scoped token's headline numbers must agree with
                    # the jobs it can see — and the cluster-wide
                    # timeline would leak other tenants' occupancy
                    payload["chips_in_use"] = sum(
                        chips_of(j) for j in jobs
                        if j.get("state") == "RUNNING")
                    payload["timeline"] = []
                return self._json(payload)
            if parts == ["fleet", "alerts"]:
                payload = self.fleet.api_alerts()
                if self._auth_user is not None:
                    # scoped tokens see only their own jobs' counts;
                    # cluster-level firing alerts (queues, LOST jobs)
                    # would leak other tenants' state
                    payload = {
                        "firing": [], "log": [], "rules": [],
                        "jobs": [j for j in payload.get("jobs", [])
                                 if self._visible(j.get("user"))]}
                return self._json(payload)
            if parts == ["fleet", "queues"]:
                payload = self.fleet.api_queues()
                if self._auth_user is not None:
                    # scoped tokens get the quota view but only their own
                    # rows of the accounting
                    acct = payload["accounting"]
                    acct["jobs"] = {k: v
                                    for k, v in acct["jobs"].items()
                                    if self._visible(v.get("user"))}
                    acct["users"] = {k: v
                                     for k, v in acct["users"].items()
                                     if self._visible(k)}
                return self._json(payload)
            return self._json({"error": "not found"}, 404)
        if len(parts) == 3 and parts[0] == "jobs":
            job_id, what = parts[1], parts[2]
            md = self.cache.get_metadata(job_id)
            if md is None or not self._visible(md.user):
                return self._json({"error": "not found"}, 404)
            if what == "events":
                return self._json(self.cache.get_events(job_id))
            if what == "config":
                return self._json(self.cache.get_config(job_id))
            if what == "logs":
                return self._json(self.cache.get_log_links(job_id))
            if what == "spans":
                return self._json(self.cache.get_spans(job_id))
            if what == "metrics":
                return self._json(self.cache.get_metrics_timeseries(job_id))
            if what == "goodput":
                return self._json(self.cache.get_goodput(job_id))
            if what == "diagnostics":
                return self._json(self.cache.get_diagnostics(job_id))
            if what == "skew":
                # RUNNING job: live bundle from the AM (same plumbing as
                # the log/profile proxies); else — or when the AM is
                # unreachable — the skew.json the AM flushed at finish
                return self._json(self._skew_bundle(
                    job_id, md.status == "RUNNING"))
            if what == "alerts":
                # same live-then-sidecar ladder as skew
                return self._json(self._alerts_bundle(
                    job_id, md.status == "RUNNING"))
            if what == "timeline":
                return self._json(self._incident_timeline(job_id))
            if what == "serving":
                # the fleet-serving panel's data: live endpoint set
                # (url/generation/draining) for RUNNING jobs, history
                # events otherwise
                return self._json(self._serving_bundle(
                    job_id, md.status == "RUNNING"))
            if what == "requests":
                # stitched request traces + the slowest-requests table
                # (serving_traces.json sidecar, observability/reqtrace)
                return self._json(self._requests_bundle(job_id))
            if what == "flame":
                # the always-on control-plane profiler's collapsed-stack
                # profile — live fold table (+ self-overhead reading)
                # from a RUNNING job's AM, profile.folded sidecar after
                return self._json(self._flame_bundle(
                    job_id, md.status == "RUNNING"))
        if len(parts) == 4 and parts[0] == "jobs" and parts[2] == "logs":
            # /api/jobs/:id/logs/:task[?stream=&offset=&max_bytes=&follow]
            # — one bounded chunk; followers poll with the returned
            # next_offset as their cursor
            job_id, task = parts[1], parts[3]
            md = self.cache.get_metadata(job_id)
            if md is None or not self._visible(md.user):
                return self._json({"error": "not found"}, 404)
            return self._api_log_chunk(job_id, task,
                                       md.status == "RUNNING")
        self._json({"error": "not found"}, 404)

    def _api_log_chunk(self, job_id: str, task: str,
                       running: bool) -> None:
        """Live-tail proxy: a RUNNING job's chunk is fetched through its
        AM (read_task_logs, address from am.json — same plumbing as the
        profile POST); otherwise (or when the AM is unreachable) the
        chunk comes from the aggregated history logs. Offsets are a
        shared cursor contract either way, so a follower that starts
        live degrades to aggregated reads without restarting."""
        qs = parse_qs(urlparse(self.path).query)

        def _q(name: str, default: int) -> int:
            try:
                return int((qs.get(name) or [default])[0])
            except (TypeError, ValueError):
                return default

        stream = (qs.get("stream") or ["stderr"])[0]
        if stream not in ("stdout", "stderr"):
            return self._json({"error": f"unknown stream {stream!r}"}, 400)
        offset = _q("offset", -1)
        max_bytes = _q("max_bytes", 0)
        am = self.cache.get_am_info(job_id) if running else {}
        if running and am.get("host") and am.get("rpc_port") \
                and not am.get("security_enabled"):
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            client = ClusterServiceClient(str(am["host"]),
                                          int(am["rpc_port"]))
            try:
                chunk = client.read_task_logs(
                    task_id=task, stream=stream, offset=offset,
                    max_bytes=max_bytes)
                if not (chunk or {}).get("error"):
                    return self._json(chunk)
            except Exception:  # noqa: BLE001 — degrade to aggregated logs
                LOG.debug("live log proxy to the AM failed", exc_info=True)
            finally:
                client.close()
        # aggregated fallback: resolve the task's container dir through
        # the same links the /logs page renders — NEWEST attempt first
        # (a relaunched slot has one dir per attempt; the latest holds
        # the evidence an operator is after)
        matches = [link for link in self.cache.get_log_links(job_id)
                   if link.get("task") == task
                   and (link.get("streams") or {}).get(stream)]
        matches.sort(key=lambda lk: int(lk.get("attempt", 0)),
                     reverse=True)
        for link in matches:
            url = link["streams"][stream]
            cdir = url.rsplit("/", 2)[-2]
            path = self.cache.get_log_file(job_id, cdir, stream)
            if path is None:
                continue
            from tony_tpu_torch.observability.logs import LogTail
            chunk = LogTail(path).read_chunk(offset=offset,
                                             max_bytes=max_bytes,
                                             final=not running)
            chunk.update({"task_id": task, "stream": stream,
                          "attempt": int(link.get("attempt", 0)),
                          "source": "aggregated"})
            return self._json(chunk)
        self._json({"error": f"no logs available for {task} ({stream})"},
                   404)

    def _serving_bundle(self, job_id: str, running: bool) -> dict:
        """Serving fleet view: a RUNNING job's live endpoint set — url,
        weights generation, draining state — proxied off its AM's task
        infos (the same set the fleet router consumes), with rollout/
        autoscale context from the event log; otherwise the last
        registration events from history. Degrades silently."""
        endpoints: list[dict] = []
        source = "history"
        am = self.cache.get_am_info(job_id) if running else {}
        if running and am.get("host") and am.get("rpc_port") \
                and not am.get("security_enabled"):
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            from tony_tpu_torch.serve.router import endpoints_from_task_infos
            client = ClusterServiceClient(str(am["host"]),
                                          int(am["rpc_port"]))
            try:
                # operator plane: fail FAST to the history fallback (the
                # get_skew/get_alerts proxy discipline) — a page render
                # must never ride the full client retry ladder against a
                # dead AM
                infos = client.call("get_task_infos", {}, retries=1,
                                    timeout_sec=10.0,
                                    wait_for_ready=False)
                endpoints = endpoints_from_task_infos(infos or [])
                source = "live"
            except Exception:  # noqa: BLE001 — degrade to history
                LOG.debug("live serving proxy to the AM failed",
                          exc_info=True)
            finally:
                client.close()
        if endpoints and source == "live":
            # one short /v1/load probe per replica (capped — a page
            # render must stay bounded on wide fleets) for the paged-KV
            # panel: page occupancy + prefix hit rate + live role
            for p in endpoints[:8]:
                load = _probe_serving_load(p.get("url", ""))
                if not load:
                    continue
                p["role"] = p.get("role") or str(load.get("role", ""))
                total = float(load.get("kv_pages_total", 0) or 0)
                if total > 0:
                    free = float(load.get("kv_pages_free", 0) or 0)
                    p["kv_occupancy_pct"] = round(
                        100.0 * (1.0 - free / total), 1)
                    p["kv_hit_rate_pct"] = float(
                        load.get("kv_hit_rate_pct", 0.0) or 0.0)
        if not endpoints:
            by_task: dict[tuple, dict] = {}
            for ev in self.cache.get_events(job_id):
                if ev["type"] == "SERVING_ENDPOINT_REGISTERED":
                    p = ev["payload"]
                    by_task[(p.get("task_type"), p.get("task_index"))] = {
                        "url": p.get("url", ""),
                        "task_id": f'{p.get("task_type", "serving")}:'
                                   f'{p.get("task_index", 0)}',
                        "generation": 0, "draining": False}
            endpoints = list(by_task.values())
        scaling = [ev for ev in self.cache.get_events(job_id)
                   if ev["type"] in ("AUTOSCALE_DECISION",
                                     "ROLLING_UPDATE_STARTED",
                                     "ROLLING_UPDATE_COMPLETED")]
        return {"endpoints": endpoints, "source": source,
                "scaling_events": scaling[-20:]}

    def _requests_bundle(self, job_id: str) -> dict:
        """Stitched serving request traces + the slowest-requests table
        off the serving_traces.json sidecar — per-process sampled
        records from every replica (and the router) merged by trace_id,
        so one request's router/prefill/decode hops read as one
        waterfall."""
        from tony_tpu_torch.observability.reqtrace import slowest_table, stitch
        traces = [t for t in self.cache.get_serving_traces(job_id)
                  if isinstance(t, dict)]
        stitched = stitch([traces])
        return {"traces": stitched, "slowest": slowest_table(stitched)}

    def _skew_bundle(self, job_id: str, running: bool) -> dict:
        """Live-then-history skew bundle: a RUNNING job's bundle comes
        from its AM's get_skew RPC (address from am.json, like the log
        and profile proxies); anything else falls back to the skew.json
        sidecar. Degrades silently — skew must never 500 a job page."""
        am = self.cache.get_am_info(job_id) if running else {}
        if running and am.get("host") and am.get("rpc_port") \
                and not am.get("security_enabled"):
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            client = ClusterServiceClient(str(am["host"]),
                                          int(am["rpc_port"]))
            try:
                bundle = client.get_skew()
                if isinstance(bundle, dict) and not bundle.get("error"):
                    bundle["source"] = "live"
                    return bundle
            except Exception:  # noqa: BLE001 — degrade to the sidecar
                LOG.debug("live skew proxy to the AM failed", exc_info=True)
            finally:
                client.close()
        bundle = self.cache.get_skew(job_id)
        if bundle:
            bundle = dict(bundle)
            bundle["source"] = "history"
        return bundle

    def _alerts_bundle(self, job_id: str, running: bool) -> dict:
        """Live-then-sidecar alert bundle: a RUNNING job's bundle comes
        from its AM's get_alerts RPC; anything else falls back to the
        alerts.json the AM refreshes on every transition. Degrades
        silently — alerting must never 500 a job page."""
        am = self.cache.get_am_info(job_id) if running else {}
        if running and am.get("host") and am.get("rpc_port") \
                and not am.get("security_enabled"):
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            client = ClusterServiceClient(str(am["host"]),
                                          int(am["rpc_port"]))
            try:
                bundle = client.get_alerts()
                if isinstance(bundle, dict) and not bundle.get("error"):
                    bundle["source"] = "live"
                    return bundle
            except Exception:  # noqa: BLE001 — degrade to the sidecar
                LOG.debug("live alerts proxy to the AM failed",
                          exc_info=True)
            finally:
                client.close()
        bundle = self.cache.get_alerts(job_id)
        if bundle:
            bundle = dict(bundle)
            bundle["source"] = "history"
        return bundle

    def _flame_bundle(self, job_id: str, running: bool) -> dict:
        """Live-then-sidecar collapsed-stack profile: a RUNNING job's
        AM answers get_profile with its in-memory fold table plus the
        profiler's self-overhead reading; anything else falls back to
        the profile.folded text the AM flushed at finish. Degrades
        silently — the flame panel must never 500 a job page."""
        am = self.cache.get_am_info(job_id) if running else {}
        if running and am.get("host") and am.get("rpc_port") \
                and not am.get("security_enabled"):
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            client = ClusterServiceClient(str(am["host"]),
                                          int(am["rpc_port"]))
            try:
                snap = client.get_profile()
                if isinstance(snap, dict) and not snap.get("error") \
                        and snap.get("folded"):
                    snap["source"] = "live"
                    return snap
            except Exception:  # noqa: BLE001 — degrade to the sidecar
                LOG.debug("live profile proxy to the AM failed",
                          exc_info=True)
            finally:
                client.close()
        folded = self.cache.get_profile_folded(job_id)
        if folded:
            return {"folded": folded, "source": "history"}
        return {}

    def _incident_timeline(self, job_id: str) -> list[dict]:
        """Alerts + history events + straggler/SLO detections + the
        diagnostics bundle correlated into one ordered view with span
        links (observability/alerts.build_incident_timeline). Sidecar
        sources only — the page render never blocks on a live RPC."""
        from tony_tpu_torch.observability.alerts import build_incident_timeline
        return build_incident_timeline(
            events=self.cache.get_events(job_id),
            alerts_bundle=self.cache.get_alerts(job_id),
            diagnostics=self.cache.get_diagnostics(job_id))

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
        """POST /api/jobs/:id/profile — forward an on-demand profiler
        request to the RUNNING job's AM (address from the am.json the AM
        wrote into its history dir). The one write route the portal has;
        it proxies, never mutates history itself."""
        path = urlparse(self.path).path.rstrip("/")
        parts = [p for p in path.split("/") if p]
        try:
            if not self._authorized():
                return self._json({"error": "unauthorized"}, 401)
            if (len(parts) != 4 or parts[:2] != ["api", "jobs"]
                    or parts[3] != "profile"):
                return self._json({"error": "not found"}, 404)
            job_id = parts[2]
            md = self.cache.get_metadata(job_id)
            if md is None or not self._visible(md.user):
                return self._json({"error": "not found"}, 404)
            if md.status != "RUNNING":
                return self._json(
                    {"error": f"job is {md.status}; profiles can only be "
                              f"captured on a running job"}, 409)
            am = self.cache.get_am_info(job_id)
            if not am.get("host") or not am.get("rpc_port"):
                return self._json(
                    {"error": "no AM address recorded for this job"}, 409)
            if am.get("security_enabled"):
                # the portal holds no app credential; forwarding would be
                # rejected UNAUTHENTICATED and read as an AM outage
                return self._json(
                    {"error": "application runs with security enabled; "
                              "use `python -m tony_tpu_torch.cli profile "
                              "<app_dir>` (it reads the app token)"}, 409)
            body = {}
            length = int(self.headers.get("Content-Length", 0) or 0)
            if 0 < length <= 1 << 20:
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, UnicodeDecodeError):
                    return self._json({"error": "body must be JSON"}, 400)
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            client = ClusterServiceClient(str(am["host"]),
                                          int(am["rpc_port"]))
            try:
                resp = client.request_profile(
                    task_id=str(body.get("task_id", "") or ""),
                    num_steps=int(body.get("num_steps", 0) or 0))
            except Exception as e:  # noqa: BLE001 — AM gone mid-request
                return self._json(
                    {"error": f"could not reach the job's AM: {e}"}, 502)
            finally:
                client.close()
            code = 200 if not (resp or {}).get("error") else 409
            return self._json(resp or {}, code)
        except Exception:  # noqa: BLE001
            LOG.exception("portal POST failed: %s", self.path)
            self._json({"error": "internal error"}, 500)

    # -- pages (reference: 4 page controllers) -----------------------------
    def _index(self) -> None:
        qs = getattr(self, "_link_qs", "")
        body = []
        if self.fleet is not None:
            try:
                self.fleet.refresh()
                body.append(self._fleet_html(qs))
            except Exception:  # noqa: BLE001 — fleet must not 500 the index
                LOG.exception("fleet panel render failed")
        visible = [m for m in self.cache.list_metadata()
                   if self._visible(m.user)]
        # state-then-start-time: RUNNING jobs surface first, newest
        # first within each bucket — a directory of hundreds of
        # finished jobs must not bury the live ones
        visible.sort(key=lambda m: (m.status != "RUNNING", -m.started))
        total = len(visible)
        rows = []
        for m in visible[:max(1, self.history_jobs)]:
            app = html.escape(m.application_id)
            queue = self.cache.get_queue(m.application_id)
            rows.append([
                f'<a href="/jobs/{app}{qs}">{app}</a>',
                html.escape(m.user), html.escape(str(queue)),
                _fmt_ts(m.started), _fmt_ts(m.completed),
                f'<span class="{html.escape(m.status)}">'
                f'{html.escape(m.status)}</span>',
                f'<a href="/config/{app}{qs}">config</a> '
                f'<a href="/logs/{app}{qs}">logs</a>',
            ])
        body.append(_table(["Job", "User", "Queue", "Started", "Completed",
                            "Status", ""], rows))
        # the bound is visible, never silent: the footer always carries
        # the full directory count
        body.append(f"<p>showing {len(rows)} of {total} job(s)</p>")
        self._html("TonY-TPU jobs", "".join(body))

    def _fleet_html(self, qs: str) -> str:
        """The cluster panels above the job directory: live jobs table,
        per-queue quota/utilization bars, and the chip-utilization
        timeline — the whole pool on one screen (the reference portal's
        reason to exist, rebuilt over the fleet registry)."""
        from tony_tpu_torch.observability.fleet import chips_of, quota_utilization
        jobs = self._fleet_jobs_visible()
        live = [j for j in jobs if j.get("state") == "RUNNING"]
        out = ["<h3>Cluster</h3>"]
        chips = sum(chips_of(j) for j in live)
        out.append(f"<p><b>{len(live)}</b> live job(s), <b>{chips}</b> "
                   "chip(s) in use</p>")
        util = quota_utilization(self.fleet.queues, live)
        if util:
            bars = []
            for q in sorted(util):
                b = util[q]
                cap = b["max_tpus"]
                used = b["chips_in_use"]
                pct = b.get("utilization_pct")
                width = min(100.0, pct if pct is not None else
                            (100.0 if used else 0.0))
                color = "#cc0000" if width >= 95 else "#2e8b57"
                label = (f"{used}/{cap} chips ({pct:.0f}%)"
                         if pct is not None else f"{used} chips (no quota)")
                bars.append(
                    f"<tr><td>{html.escape(q)}</td>"
                    f'<td style="min-width:240px"><div class="spanbar" '
                    f'style="width:{width:.1f}%;background:{color}">'
                    f"</div></td><td>{html.escape(label)} — "
                    f"{b['live_jobs']} job(s)</td></tr>")
            out.append("<p><b>queues</b></p><table>"
                       + "".join(bars) + "</table>")
        out.append(self._fleet_alerts_html())
        out.append(self._fleet_timeline_html())
        if jobs:
            rows = []
            for j in jobs:
                app = html.escape(str(j.get("app_id", "")))
                state = html.escape(str(j.get("state", "?")))
                age_s = max(0.0, (_now_ms() - int(
                    j.get("heartbeat_ms", 0) or 0)) / 1000.0)
                # elastic width surface: "cur &gt; req" (highlighted)
                # while a resize is in flight, bare width otherwise
                cur_w = int(j.get("gang_width", 0) or 0)
                req_w = int(j.get("requested_width", cur_w) or cur_w)
                width_cell = (f'<b style="color:#b8860b">{cur_w}'
                              f'&nbsp;&rarr;&nbsp;{req_w}</b>'
                              if req_w != cur_w else str(cur_w))
                rows.append([
                    f'<a href="/jobs/{app}{qs}">{app}</a>',
                    html.escape(str(j.get("queue", ""))),
                    html.escape(str(j.get("user", ""))),
                    f'<span class="{state}">{state}</span>',
                    width_cell,
                    str(chips_of(j)),
                    ("-" if j.get("goodput_pct") is None
                     else f"{j['goodput_pct']:.1f}%"),
                    ("-" if j.get("mfu_pct") is None
                     else f"{j['mfu_pct']:.1f}%"),
                    str(j.get("straggler_count", 0)),
                    (f'<span style="color:#c0392b"><b>'
                     f"{int(j.get('alerts_firing', 0) or 0)}</b></span>"
                     if int(j.get("alerts_firing", 0) or 0) else "0"),
                    ("-" if j.get("serving_tokens_per_sec") is None
                     else f"{j['serving_tokens_per_sec']:.0f}"),
                    f"{age_s:.0f}s",
                ])
            out.append("<p><b>fleet registry</b></p>")
            out.append(_table(
                ["Job", "Queue", "User", "State", "Width", "Chips",
                 "Goodput", "MFU", "Strag", "Alerts", "Serve tok/s",
                 "HB age"],
                rows))
        out.append("<h3>Job directory</h3>")
        return "".join(out)

    def _fleet_alerts_html(self) -> str:
        """Cluster firing-alerts panel: the fleet-scope engine's firing
        set (queue saturation, LOST jobs, queued gangs) + every
        registry job that reports its own firing alerts. Admin/open
        portals only — a scoped token's index stays job-scoped."""
        if self._auth_user is not None:
            return ""
        out = []
        rows = []
        engine = getattr(self.fleet, "alert_engine", None)
        if engine is not None:
            for a in engine.firing():
                sev = str(a.get("severity", "warning"))
                color = self._SEVERITY_COLORS.get(sev, "#555")
                rows.append([
                    f'<span style="color:{color}"><b>{html.escape(sev)}'
                    f"</b></span>",
                    html.escape(str(a.get("rule_id", "?"))),
                    html.escape(str(a.get("key", ""))),
                    html.escape(str(a.get("message", ""))),
                ])
        job_rows = [
            (str(j.get("app_id", "")), int(j.get("alerts_firing", 0)
                                           or 0))
            for j in self.fleet.registry.jobs()
            if int(j.get("alerts_firing", 0) or 0) > 0]
        if not rows and not job_rows:
            return ""
        out.append('<p><b style="color:#c0392b">firing alerts</b></p>')
        if rows:
            out.append(_table(["Severity", "Rule", "On", "Evidence"],
                              rows))
        if job_rows:
            qs = getattr(self, "_link_qs", "")
            items = "".join(
                f'<li><a href="/jobs/{html.escape(app)}{qs}">'
                f"{html.escape(app)}</a>: {n} firing</li>"
                for app, n in job_rows)
            out.append(f"<ul>{items}</ul>")
        return "".join(out)

    def _fleet_timeline_html(self) -> str:
        """Inline-SVG cluster chip-utilization timeline (the registry's
        chips-in-use series, sampled per refresh)."""
        points = [(int(p[0]), float(p[1]))
                  for p in self.fleet.registry.timeline()
                  if isinstance(p, (list, tuple)) and len(p) == 2]
        if len(points) < 2:
            return ""
        w, h = 420, 60
        t0, t1 = points[0][0], points[-1][0]
        extent = max(1, t1 - t0)
        peak = max(1.0, max(v for _, v in points))
        coords = " ".join(
            f"{w * (ts - t0) / extent:.1f},{h - h * v / (1.15 * peak):.1f}"
            for ts, v in points)
        return (f"<p>chips in use over time (peak {peak:.0f})</p>"
                f'<svg width="{w}" height="{h}" '
                'style="border:1px solid #ccc">'
                f'<polyline points="{coords}" fill="none" '
                'stroke="#4a90d9" stroke-width="1.5"></polyline></svg>')

    def _jobs(self, job_id: str) -> None:
        from tony_tpu_torch.events.render import render_event
        rows = []
        events = self.cache.get_events(job_id)
        for ev in events:
            rows.append([
                _fmt_ts(ev["timestamp"]),
                html.escape(ev["type"]),
                html.escape(render_event(ev["type"], ev["payload"])),
                html.escape(json.dumps(ev["payload"])),
            ])
        self._html(f"events — {job_id}",
                   self._diagnostics_html(job_id)
                   + self._alerts_html(job_id)
                   + self._serving_endpoints_html(job_id)
                   + self._width_timeline_html(events)
                   + self._skew_html(job_id)
                   + self._goodput_html(job_id)
                   + self._timeline_html(job_id)
                   + self._waterfall_html(job_id)
                   + self._requests_html(job_id)
                   + _table(["Time", "Event", "Summary", "Payload"], rows))

    @staticmethod
    def _width_timeline_html(events: list[dict]) -> str:
        """Gang-width timeline: the width step-function the RESIZE_*
        events describe (elastic resizes, cluster/elastic.py), rendered
        as an inline SVG next to a transition table. Empty string for
        jobs that never resized — static gangs stay clean."""
        points: list[tuple[int, int]] = []   # (ts_ms, width after)
        rows = []
        started_ms = 0
        for ev in events:
            etype = ev.get("type")
            p = ev.get("payload") or {}
            ts = int(ev.get("timestamp", 0) or 0)
            if etype == "APPLICATION_INITED" and not started_ms:
                started_ms = ts
            # the timeline tracks the ELASTIC jobtype's width, so it
            # seeds from the first resize's from_width (num_tasks spans
            # every jobtype — mixed units would draw phantom changes)
            if not points and str(etype).startswith("RESIZE_"):
                points.append((started_ms or ts,
                               int(p.get("from_width", 0) or 0)))
            if etype == "RESIZE_COMPLETED":
                points.append((ts, int(p.get("to_width", 0) or 0)))
                rows.append([_fmt_ts(ts), "completed",
                             f"{p.get('from_width', '?')} &rarr; "
                             f"{p.get('to_width', '?')}",
                             f"{int(p.get('duration_ms', 0) or 0)} ms"])
            elif etype == "RESIZE_FAILED":
                rows.append([
                    _fmt_ts(ts),
                    '<span style="color:#c0392b">failed'
                    + (" (rolled back)" if p.get("rolled_back") else "")
                    + "</span>",
                    f"{p.get('from_width', '?')} &rarr; "
                    f"{p.get('to_width', '?')}",
                    html.escape(str(p.get("reason", "")))])
        if not rows:
            return ""
        out = ["<h3>Gang width timeline</h3>"]
        widths = [w for _, w in points if w > 0]
        if len(points) >= 2 and widths:
            w_px, h_px = 480, 60
            t0, t1 = points[0][0], points[-1][0]
            extent = max(1, t1 - t0)
            peak = max(widths)
            coords = []
            prev_w = None
            for ts, w in points:
                x = w_px * (ts - t0) / extent
                y = h_px - h_px * w / (1.2 * peak)
                if prev_w is not None:
                    # step function: hold the previous width until the
                    # resize lands
                    coords.append(f"{x:.1f},{h_px - h_px * prev_w / (1.2 * peak):.1f}")
                coords.append(f"{x:.1f},{y:.1f}")
                prev_w = w
            out.append(
                f'<p>gang width over time (peak {peak})</p>'
                f'<svg width="{w_px}" height="{h_px}" '
                'style="border:1px solid #ccc">'
                f'<polyline points="{" ".join(coords)}" fill="none" '
                'stroke="#b8860b" stroke-width="2"></polyline></svg>')
        out.append(_table(["Time", "Resize", "Width", "Detail"], rows))
        return "".join(out)

    def _diagnostics_html(self, job_id: str) -> str:
        """Root-cause panel for failed jobs (the diagnostics.json bundle
        the AM flushed): first-failing task, exit signal, matched error
        signature + hint, and the redacted tail excerpt — the
        one-screen answer to 'which of N tasks broke first and why'.
        Empty string when no bundle exists (succeeded / pre-diagnostics
        history)."""
        diag = self.cache.get_diagnostics(job_id)
        first = diag.get("first_failure") or {}
        if not diag or not first:
            return ""
        sig = first.get("signature", "")
        sigdesc = first.get("signal_name") \
            or (f"exit {first.get('exit_code')}"
                if first.get("exit_code") is not None else "no exit code")
        out = ['<h3 style="color:#c0392b">Root cause</h3>']
        out.append(
            "<p>first failing task <b>"
            + html.escape(str(first.get("task_id", "?")))
            + f"</b> (attempt {int(first.get('attempt', 0) or 0)}, "
            + html.escape(str(sigdesc))
            + (", signature <b>" + html.escape(sig) + "</b>" if sig else "")
            + ")</p>")
        if first.get("hint"):
            out.append(f"<p><i>{html.escape(str(first['hint']))}</i></p>")
        if first.get("line"):
            out.append(f"<p><code>{html.escape(str(first['line']))}</code>"
                       "</p>")
        tails = first.get("tail") or {}
        for stream in ("stderr", "stdout"):
            lines = tails.get(stream) or []
            if not lines:
                continue
            excerpt = "\n".join(str(ln) for ln in lines[-40:])
            out.append(
                f"<p>{html.escape(stream)} (last {len(lines)} lines, "
                "redacted):</p><pre style=\"background:#f8f8f8;"
                "border:1px solid #ddd;padding:8px;max-height:320px;"
                f"overflow:auto\">{html.escape(excerpt)}</pre>")
        others = [r for r in (diag.get("failures") or [])
                  if (r.get("task_id"), r.get("attempt"))
                  != (first.get("task_id"), first.get("attempt"))]
        if others:
            out.append(
                "<p>"
                + html.escape(f"{len(others)} further failure record(s)")
                + f' — <a href="/api/jobs/{html.escape(job_id)}'
                  '/diagnostics">full bundle (JSON)</a></p>')
        return "".join(out)

    # phase palette: productive train time pops green, stalls/downtime
    # warn, infrastructure phases stay muted
    _PHASE_COLORS = {
        "train_step": "#2e8b57", "compile": "#8e7cc3",
        "input_stall": "#e69138", "checkpoint_save": "#6fa8dc",
        "checkpoint_restore": "#9fc5e8", "eval": "#46bdc6",
        "localization": "#b7b7b7", "rendezvous_wait": "#ffd966",
        "relaunch_downtime": "#cc0000", "resize": "#b8860b",
        "init": "#cccccc", "idle": "#efefef",
    }

    # severity → display color on the alert/timeline panels
    _SEVERITY_COLORS = {"info": "#555", "warning": "#b8860b",
                        "critical": "#c0392b", "page": "#8e0000"}

    def _alerts_html(self, job_id: str) -> str:
        """Firing-alerts panel (alerts.json sidecar): rule, scope key,
        severity, evidence. Empty string when nothing fires and nothing
        ever fired — quiet jobs stay quiet."""
        bundle = self.cache.get_alerts(job_id)
        firing = (bundle or {}).get("firing") or []
        if not firing:
            return ""
        rows = []
        for a in firing:
            sev = str(a.get("severity", "warning"))
            color = self._SEVERITY_COLORS.get(sev, "#555")
            rows.append([
                f'<span style="color:{color}"><b>{html.escape(sev)}'
                f"</b></span>",
                html.escape(str(a.get("rule_id", "?"))),
                html.escape(str(a.get("key", ""))),
                html.escape(str(a.get("message", ""))),
                _fmt_ts(int(a.get("since_ms", 0) or 0)),
            ])
        return ('<h3 style="color:#c0392b">Firing alerts</h3>'
                + _table(["Severity", "Rule", "On", "Evidence", "Since"],
                         rows))

    def _timeline_html(self, job_id: str) -> str:
        """Incident timeline: alerts + events + detections + diagnosis
        in one time-ordered table with span links into the waterfall.
        Renders only when the job has a story (an alert, a failure, a
        straggler, a relaunch) — healthy histories skip it."""
        timeline = self._incident_timeline(job_id)
        if not any(r.get("severity") in ("warning", "critical", "page")
                   for r in timeline):
            return ""
        rows = []
        for r in timeline:
            sev = str(r.get("severity", "info"))
            color = self._SEVERITY_COLORS.get(sev, "#555")
            spans = ", ".join(r.get("span_ids") or [])
            rows.append([
                _fmt_ts(int(r.get("ts_ms", 0) or 0)),
                f'<span style="color:{color}">{html.escape(sev)}</span>',
                html.escape(str(r.get("kind", ""))),
                html.escape(str(r.get("summary", ""))),
                f"<code>{html.escape(spans)}</code>" if spans else "",
            ])
        return ("<h3>Incident timeline</h3>"
                + _table(["Time", "Severity", "Kind", "What happened",
                          "Spans"], rows))

    def _skew_html(self, job_id: str) -> str:
        """Cross-task skew panel: top-k outliers (latched stragglers
        first, then the worst last-window step times) + the tasks x
        windows step-time heatmap — cell shade = that task's windowed
        mean relative to the gang's worst. Sidecar-only, like every
        sibling panel: the page render must never block on a live AM RPC
        (a wedged AM would hold a handler thread for the full deadline)
        — live bundles are the /api/jobs/:id/skew endpoint's job. Empty
        string for jobs with no skew bundle (pre-skew history, gangs
        below min-tasks)."""
        bundle = self.cache.get_skew(job_id)
        heatmap = (bundle or {}).get("heatmap") or {}
        tasks = heatmap.get("tasks") or {}
        stragglers = (bundle or {}).get("stragglers") or []
        if not tasks and not stragglers:
            return ""
        out = ["<h3>Cross-task skew</h3>"]
        if stragglers:
            rows = [[html.escape(str(s.get("task_id", "?"))),
                     html.escape(str(s.get("phase", "?"))),
                     html.escape(str(s.get("signal", "?"))),
                     f"{s.get('value_ms', 0)} ms",
                     f"{s.get('gang_median_ms', 0)} ms",
                     str(s.get("z_score", 0)),
                     str(s.get("windows", 0))]
                    for s in stragglers]
            out.append("<p><b>latched stragglers</b></p>")
            out.append(_table(["Task", "Phase", "Signal", "Windowed",
                               "Gang median", "z", "Windows"], rows))
        if tasks:
            peak = max((v for row in tasks.values() for v in row
                        if isinstance(v, (int, float))), default=0.0)
            # top-k outliers by last reported window
            last_vals = []
            for tid, row in tasks.items():
                vals = [v for v in row if isinstance(v, (int, float))]
                if vals:
                    last_vals.append((vals[-1], tid))
            last_vals.sort(reverse=True)
            if last_vals:
                top = ", ".join(f"{html.escape(t)} ({v:.1f} ms)"
                                for v, t in last_vals[:5])
                out.append(f"<p>slowest last window: {top}</p>")
            cells_rows = []
            for tid in sorted(tasks):
                cells = []
                for v in tasks[tid]:
                    if not isinstance(v, (int, float)) or peak <= 0:
                        cells.append(
                            '<td style="background:#f5f5f5">&nbsp;</td>')
                        continue
                    # white → red ramp on the gang's worst windowed mean
                    frac = max(0.0, min(1.0, v / peak))
                    g = int(255 - 180 * frac)
                    cells.append(
                        f'<td style="background:rgb(255,{g},{g});'
                        f'min-width:14px" title="{v:.1f} ms">&nbsp;</td>')
                cells_rows.append(
                    f"<tr><td>{html.escape(tid)}</td>"
                    + "".join(cells) + "</tr>")
            out.append(
                '<p>step-time heatmap (tasks &times; windows, darker = '
                'slower)</p><table border="0" cellspacing="1">'
                + "".join(cells_rows) + "</table>")
        return "".join(out)

    def _goodput_html(self, job_id: str) -> str:
        """Stacked time-accounting bar per task (the goodput.json ledger)
        + an MFU trajectory sparkline from the metrics sidecar — where
        the wall-clock went, and what the chips sustained while it did.
        Empty string for pre-goodput history."""
        goodput = self.cache.get_goodput(job_id)
        tasks = goodput.get("tasks") or {}
        if not tasks:
            return ""
        job = goodput.get("job") or {}
        out = ["<h3>Goodput</h3>"]
        if job:
            out.append(
                f"<p><b>{job.get('goodput_pct', 0)}%</b> goodput — "
                f"{job.get('productive_s', 0)}s productive of "
                f"{job.get('wall_s', 0)}s wall"
                + (f", {job['relaunch_downtime_s']}s relaunch downtime"
                   if job.get("relaunch_downtime_s") else "") + "</p>")
        rows = []
        for task_id, entry in sorted(tasks.items()):
            phases = entry.get("phases") or {}
            wall = float(entry.get("wall_s") or 0) or 1.0
            segs = []
            for phase, secs in sorted(phases.items(),
                                      key=lambda kv: -kv[1]):
                if secs <= 0:
                    continue
                width = max(0.4, 100.0 * float(secs) / wall)
                color = self._PHASE_COLORS.get(phase, "#999")
                segs.append(
                    f'<div class="spanbar" style="display:inline-block;'
                    f'width:{width:.2f}%;background:{color}" '
                    f'title="{html.escape(phase)}: {secs:.2f}s"></div>')
            mfu = entry.get("mfu_pct")
            rows.append([
                html.escape(task_id),
                f'<div style="min-width:320px;white-space:nowrap">'
                + "".join(segs) + "</div>",
                "-" if mfu is None else f"{mfu:.2f}%",
            ])
        out.append(_table(["Task", "Time accounting", "MFU"], rows))
        legend = " ".join(
            f'<span style="background:{color};padding:0 6px">&nbsp;</span>'
            f' {html.escape(phase)}'
            for phase, color in self._PHASE_COLORS.items())
        out.append(f'<p style="font-size:80%">{legend}</p>')
        out.append(self._mfu_sparkline_html(job_id))
        return "".join(out)

    def _mfu_sparkline_html(self, job_id: str) -> str:
        """Inline-SVG MFU trajectories (TRAIN_MFU_PCT series per task)
        from the metrics sidecar — flat lines are the goal."""
        series = self.cache.get_metrics_timeseries(job_id)
        lines = []
        peak = 1.0
        for task_id, metrics in sorted(series.items()):
            points = metrics.get("TRAIN_MFU_PCT") or []
            pts = [(int(p[0]), float(p[1])) for p in points
                   if isinstance(p, (list, tuple)) and len(p) == 2]
            if len(pts) >= 2:
                lines.append((task_id, pts))
                peak = max(peak, max(v for _, v in pts))
        if not lines:
            return ""
        w, h = 420, 80
        svgs = []
        for task_id, pts in lines:
            t0, t1 = pts[0][0], pts[-1][0]
            extent = max(1, t1 - t0)
            coords = " ".join(
                f"{w * (ts - t0) / extent:.1f},"
                f"{h - h * v / (1.15 * peak):.1f}" for ts, v in pts)
            svgs.append(
                f'<polyline points="{coords}" fill="none" '
                f'stroke="#2e8b57" stroke-width="1.5">'
                f'<title>{html.escape(task_id)}</title></polyline>')
        return (f"<p>MFU trajectory (peak {peak:.1f}%)</p>"
                f'<svg width="{w}" height="{h}" '
                f'style="border:1px solid #ccc">' + "".join(svgs)
                + "</svg>")

    def _waterfall_html(self, job_id: str) -> str:
        """Lifecycle-span waterfall: one row per span, a bar positioned/
        sized by start/duration relative to the trace extent, indented by
        parent depth — where a slow job answers 'which phase ate the
        time' (submit vs localization vs rendezvous vs compile vs steps)
        at a glance. Empty string when the job has no spans (pre-
        observability history stays renderable)."""
        spans = [s for s in self.cache.get_spans(job_id)
                 if isinstance(s, dict) and s.get("start_ms")]
        if not spans:
            return ""
        t0 = min(int(s["start_ms"]) for s in spans)
        t1 = max(max(int(s.get("end_ms") or 0), int(s["start_ms"]))
                 for s in spans)
        extent = max(1, t1 - t0)
        parents = {str(s.get("span_id", "")): str(s.get("parent_id", ""))
                   for s in spans}

        def _depth(sid: str) -> int:
            d, cur, seen = 0, parents.get(sid, ""), {sid}
            while cur and cur in parents and cur not in seen:
                seen.add(cur)
                d += 1
                cur = parents.get(cur, "")
            return d
        rows = []
        for s in spans:
            sid = str(s.get("span_id", ""))
            start = int(s["start_ms"])
            end = int(s.get("end_ms") or 0) or start
            left = 100.0 * (start - t0) / extent
            width = max(0.5, 100.0 * (end - start) / extent)
            color = "#c0392b" if s.get("status") == "ERROR" else "#4a90d9"
            indent = 1.2 * _depth(sid)
            label = s.get("name", "")
            task = s.get("task_id") or ""
            if task and not label.endswith(task):
                label = f"{label} [{task}"
                if int(s.get("attempt", 0)) > 0:
                    label += f" a{s['attempt']}"
                label += "]"
            rows.append(
                f'<tr><td style="padding-left:{indent:.1f}em">'
                f'{html.escape(label)}</td>'
                f"<td>{end - start} ms</td>"
                f'<td style="min-width:320px"><div class="spanbar" '
                f'style="margin-left:{left:.2f}%;width:{width:.2f}%;'
                f'background:{color}" title="{html.escape(str(s.get("status")))}">'
                f"</div></td></tr>")
        return ("<h3>Lifecycle waterfall</h3>"
                '<table class="waterfall"><tr><th>Span</th><th>Duration</th>'
                f"<th>Timeline ({extent} ms)</th></tr>"
                + "".join(rows) + "</table>")

    def _requests_html(self, job_id: str) -> str:
        """Serving request-trace panel: the slowest-requests table
        (dominant hop names the guilty replica) plus a per-hop waterfall
        of the slowest stitched trace. Empty string for jobs that never
        served or sampled nothing — non-serving history stays clean."""
        bundle = self._requests_bundle(job_id)
        stitched = bundle.get("traces") or []
        if not stitched:
            return ""
        rows = []
        for r in bundle.get("slowest") or []:
            rows.append([
                html.escape(str(r.get("trace_id", ""))[:12]),
                f'{float(r.get("duration_ms", 0) or 0):.1f} ms',
                html.escape(str(r.get("kept_reason", ""))),
                html.escape(f'{r.get("dominant_hop", "")} '
                            f'({r.get("dominant_process", "")}, '
                            f'{r.get("dominant_ms", 0)} ms)'),
                html.escape(", ".join(r.get("processes") or [])),
                str(r.get("hop_count", 0)),
            ])
        out = ("<h3>Slowest requests</h3>"
               + _table(["Trace", "Duration", "Kept", "Dominant hop",
                         "Processes", "Hops"], rows))
        top = stitched[0]
        hops = [h for h in top.get("hops") or []
                if isinstance(h, dict) and h.get("start_ms")]
        if not hops:
            return out
        t0 = min(int(h["start_ms"]) for h in hops)
        t1 = max(max(int(h.get("end_ms") or 0), int(h["start_ms"]))
                 for h in hops)
        extent = max(1, t1 - t0)
        wrows = []
        for h in hops:
            start = int(h["start_ms"])
            end = int(h.get("end_ms") or 0) or start
            left = 100.0 * (start - t0) / extent
            width = max(0.5, 100.0 * (end - start) / extent)
            color = "#c0392b" if h.get("status") == "ERROR" else "#2e8b57"
            label = f'{h.get("name", "")} [{h.get("process", "")}]'
            wrows.append(
                f"<tr><td>{html.escape(label)}</td>"
                f"<td>{end - start} ms</td>"
                f'<td style="min-width:320px"><div class="spanbar" '
                f'style="margin-left:{left:.2f}%;width:{width:.2f}%;'
                f'background:{color}" '
                f'title="{html.escape(str(h.get("status")))}">'
                f"</div></td></tr>")
        out += (f'<h3>Request waterfall — '
                f'{html.escape(str(top.get("trace_id", ""))[:12])} '
                f'({html.escape(str(top.get("kept_reason", "")))})</h3>'
                '<table class="waterfall"><tr><th>Hop</th><th>Duration'
                f"</th><th>Timeline ({extent} ms)</th></tr>"
                + "".join(wrows) + "</table>")
        return out

    def _serving_endpoints_html(self, job_id: str) -> str:
        """Fleet serving panel: the replica set with its live state —
        weights generation and DRAINING badge (the fleet router's view)
        — plus the recent autoscale/rolling-update lifecycle. With
        tony.proxy.url configured the link goes THROUGH the
        authenticated proxy (the raw in-cluster address stays visible
        as text, since the browser usually can't reach it directly)."""
        md = self.cache.get_metadata(job_id)
        bundle = self._serving_bundle(
            job_id, md is not None and md.status == "RUNNING")
        endpoints = bundle.get("endpoints") or []
        if not endpoints:
            return ""
        proxy = str(self.cache.get_config(job_id).get(
            "tony.proxy.url", "") or "")
        items = []
        for p in endpoints:
            task = html.escape(str(p.get("task_id", "serving:0")))
            url = str(p.get("url", ""))
            badge = ""
            if p.get("draining"):
                badge = ' <b style="color:#c0392b">[DRAINING]</b>'
            role = str(p.get("role", "") or "")
            if role and role != "both":
                badge = (f' <b style="color:#2471a3">'
                         f'[{html.escape(role.upper())}]</b>') + badge
            if p.get("kv_occupancy_pct") is not None:
                badge += (f" — KV pages "
                          f"{float(p['kv_occupancy_pct']):g}% full, "
                          f"prefix hit rate "
                          f"{float(p.get('kv_hit_rate_pct', 0)):g}%")
            gen = int(p.get("generation", 0) or 0)
            gen_txt = f" (weights gen {gen})" if gen > 0 else ""
            if proxy:
                items.append(
                    f'<li>{task}: <a href="{html.escape(proxy)}">'
                    f'{html.escape(url)}</a> (via proxy)'
                    f'{gen_txt}{badge}</li>')
            else:
                items.append(f'<li>{task}: <a href="{html.escape(url)}">'
                             f'{html.escape(url)}</a>{gen_txt}{badge}</li>')
        out = [f"<h3>Serving fleet ({bundle.get('source', 'history')})"
               "</h3><ul>" + "".join(items) + "</ul>"]
        scaling = bundle.get("scaling_events") or []
        if scaling:
            from tony_tpu_torch.events.render import render_event
            out.append("<p>recent fleet lifecycle:</p><ul>")
            for ev in scaling[-8:]:
                out.append("<li>" + html.escape(render_event(
                    ev["type"], ev["payload"])) + "</li>")
            out.append("</ul>")
        return "".join(out)

    def _config(self, job_id: str) -> None:
        conf = self.cache.get_config(job_id)
        rows = [[html.escape(k), html.escape(str(v))]
                for k, v in sorted(conf.items())]
        self._html(f"config — {job_id}", _table(["Key", "Value"], rows))

    def _logs(self, job_id: str) -> None:
        rows = []
        qs = getattr(self, "_link_qs", "")
        md = self.cache.get_metadata(job_id)
        # a terminal job with no aggregated logs will never get them
        # (AM died before aggregation) — don't claim "still running"
        terminal = md is not None and md.status != "RUNNING"
        for link in self.cache.get_log_links(job_id):
            if link["streams"]:
                cell = " ".join(
                    f'<a href="{html.escape(url)}{qs}">'
                    f'{html.escape(stream)}</a>'
                    for stream, url in sorted(link["streams"].items()))
            elif terminal:
                cell = "<i>logs unavailable (not aggregated)</i>"
            else:
                cell = "<i>pending (task still running)</i>"
            rows.append([
                html.escape(link["task"]), html.escape(link["host"]),
                html.escape(link["container_id"]), cell,
            ])
        self._html(f"logs — {job_id}",
                   _table(["Task", "Host", "Container", "Logs"], rows))

    def _log_file(self, job_id: str, container_dir: str,
                  stream: str) -> None:
        path = self.cache.get_log_file(job_id, container_dir, stream)
        if path is None:
            return self._html("not found", "<p>no such log</p>", 404)
        try:
            # stream in constant memory: aggregated logs may be large
            # (tony.history.log-max-size) and the threading server can
            # hold many of these handlers at once
            import shutil
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(size))
                self.end_headers()
                shutil.copyfileobj(f, self.wfile)
        except OSError:
            LOG.exception("failed to serve log %s", path)


class PortalServer:
    """Owns the HTTP server plus the mover/purger daemons."""

    def __init__(self, cache: PortalCache, port: int = 0,
                 host: str = "0.0.0.0", token: Optional[str] = None,
                 user_tokens: Optional[dict[str, str]] = None,
                 fleet=None, history_jobs: int = 200):
        self.cache = cache
        self.fleet = fleet
        handler = type("BoundHandler", (_Handler,),
                       {"cache": cache, "token": token,
                        "user_tokens": dict(user_tokens or {}),
                        "fleet": fleet,
                        "history_jobs": max(1, int(history_jobs))})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="portal-http", daemon=True)

    def start(self) -> None:
        self._thread.start()
        LOG.info("portal serving on port %d", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
