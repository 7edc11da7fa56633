"""Fleet router: one HTTP front door over N serving replicas.

The port's copy of `tony_tpu/serve/router.py`. One serving instance
hard-caps throughput at its `n_slots` decode slots;
`tony.serving.instances > 1` gives N independent endpoints (each
registered with the AM via register_serving_endpoint). This module
promotes that set to a **fleet**: a router that spreads `/v1/generate`
across the replicas so clients see one endpoint whose capacity is the
sum of the parts — the serving-side half of the MPMD-specialization
story (arxiv 2412.14374) and, per arxiv 2011.03641's rule, built so the
routing layer is never the reason decode slots idle:

- **Least-loaded routing.** Replicas are ranked by live
  ``(queue_depth, -slots_free)`` read off each engine's lock-free
  ``/v1/load`` probe. A background prober keeps every endpoint's
  snapshot fresher than the TTL (``tony.serving.fleet.probe-ttl-ms``),
  so routing a request adds ZERO RPCs — the request path only ever
  reads the cache, at any traffic rate (a lazy probe-on-request design
  taxes exactly the low-rate requests that can least absorb it).
- **Streaming passthrough.** ``stream=true`` responses are relayed
  line-by-line as they arrive (the chunked JSON-lines framing is
  preserved end to end), so the router adds no time-to-first-token
  buffering.
- **429 spill-over.** A replica answering 429 (bounded queue full) gets
  its load probe invalidated and the request retries on the
  next-least-loaded replica, up to ``spillover-retries`` times; only
  when the WHOLE fleet sheds does the client see a 429.
- **Connection draining.** A replica whose probe reports
  ``draining: true`` (relaunch, preemption drain, rolling update, or
  scale-down) stops receiving new sends immediately; its in-flight
  requests — including open token streams — run to completion through
  the sockets they already hold. Zero client-visible errors across a
  replica drain is the contract (pinned by the chaos e2e).
- **Dead-endpoint eviction.** ``dead-after-failures`` consecutive
  probe/send failures mark a replica DOWN (SIGKILL, host loss); it
  keeps being probed at the TTL cadence and re-admits itself the
  moment a probe succeeds.

The endpoint set is dynamic: ``set_endpoints`` diff-merges a new set
(probe state survives for unchanged URLs), which is how the
generation-bumped set from the AM — polled off ``get_task_infos``, the
same channel the serving endpoints already ride — reaches the router
without restarts. The AM's rolling-update state machine
(application_master._check_rolling_update) builds the zero-downtime
weight rollout on exactly these primitives: mark draining, relaunch,
wait for the healthy re-registration at the new generation.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import urlparse

from tony_tpu_torch.observability import reqtrace

LOG = logging.getLogger(__name__)

# generous per-request relay ceiling (matches the frontend's stream stall
# guard): deadness is detected by probes/connect failures, not by
# starving a slow-but-live token stream
RELAY_TIMEOUT_SEC = 300.0

UP = "UP"
DRAINING = "DRAINING"
DOWN = "DOWN"


class BurstBacklogHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for bursts: the
    stdlib default of 5 overflows under a few dozen concurrent opens
    and the spilled SYNs come back 1s/3s later (kernel retransmit) —
    which reads as a fabricated multi-second TTFT tail. Shared by the
    router's front door and the serving frontend (the router opens one
    fresh connection per relayed request, so both sides burst
    together)."""
    request_queue_size = 128
    daemon_threads = True


@dataclass
class Endpoint:
    """One replica in the router's table: identity + cached probe state."""
    url: str                    # http://host:port
    task_id: str = ""
    generation: int = 0         # weights/rollout generation (AM-stamped)
    draining_hint: bool = False   # AM-side drain mark (endpoint set)
    role: str = ""              # ""|"both"|"prefill"|"decode" (AM-stamped)
    # probe cache (guarded by the router lock; the cached dict itself is
    # read-only once stored)
    load: Optional[dict] = None
    probed_at: float = 0.0
    failures: int = 0           # consecutive probe/send failures
    sent: int = 0               # requests routed here (stats)

    def state(self, dead_after: int) -> str:
        if self.failures >= dead_after:
            return DOWN
        if self.draining_hint or bool((self.load or {}).get("draining")):
            return DRAINING
        return UP

    def effective_role(self) -> str:
        """AM-stamped role, else the replica's own /v1/load claim."""
        return self.role or str((self.load or {}).get("role", "") or "")

    def to_dict(self, dead_after: int) -> dict:
        return {"url": self.url, "task_id": self.task_id,
                "generation": self.generation,
                "draining": self.draining_hint,
                "role": self.effective_role(),
                "state": self.state(dead_after),
                "failures": self.failures, "sent": self.sent,
                "load": self.load}


def _normalize(spec) -> Endpoint:
    if isinstance(spec, str):
        return Endpoint(url=spec.rstrip("/"))
    return Endpoint(url=str(spec.get("url", "")).rstrip("/"),
                    task_id=str(spec.get("task_id", "") or ""),
                    generation=int(spec.get("generation", 0) or 0),
                    draining_hint=bool(spec.get("draining")),
                    role=str(spec.get("role", "") or ""))


def endpoints_from_task_infos(infos: list[dict]) -> list[dict]:
    """The AM's get_task_infos carries one `serving-endpoint` entry per
    registered replica (url + generation + draining + role) — the fleet
    router's endpoint-set source for orchestrated runs."""
    return [{"url": i.get("url", ""), "task_id": i.get("task_id", ""),
             "generation": int(i.get("generation", 0) or 0),
             "draining": bool(i.get("draining")),
             "role": str(i.get("role", "") or "")}
            for i in infos
            if i.get("name") == "serving-endpoint" and i.get("url")]


def _prefix_match_depth(hashes: list[str], advertised) -> int:
    """Deepest page-aligned block of `hashes` present in an endpoint's
    advertised prefix index. Chain hashes make membership of block i
    imply the whole prefix [0, (i+1)*page_size) once lived there — the
    deepest hit is the affinity depth."""
    if not hashes or not advertised:
        return 0
    advset = set(advertised)
    for i in range(len(hashes) - 1, -1, -1):
        if hashes[i] in advset:
            return i + 1
    return 0


def _effective_slots(load: dict) -> float:
    """Load-score capacity of one replica. Slot count alone lies for a
    paged replica: free slots with an exhausted (no free, no evictable)
    KV pool means every admission re-prefills at full length — so the
    page-pool headroom scales the advertised capacity down (to half at
    zero headroom; replicas without a pool are unscaled)."""
    slots_free = int(load.get("slots_free", 0) or 0)
    headroom = load.get("kv_pages_headroom")
    total = int(load.get("kv_pages_total", 0) or 0)
    if headroom is None or total <= 0:
        return float(slots_free)
    ratio = max(0.0, min(1.0, int(headroom) / total))
    return slots_free * (0.5 + 0.5 * ratio)


class FleetRouter:
    """Least-loaded HTTP router over a dynamic serving-endpoint set.

    Thread model: handler threads (one per in-flight client request)
    share the endpoint table under one lock; the lock is held only for
    table reads/updates — never across a probe or a relay, so a slow
    replica cannot serialize the fleet.
    """

    def __init__(self, endpoints=(), port: int = 0,
                 host: str = "0.0.0.0",
                 probe_ttl_ms: int = 500,
                 probe_timeout_ms: int = 1000,
                 spillover_retries: int = 2,
                 dead_after_failures: int = 2,
                 collector=None):
        self.probe_ttl_s = max(probe_ttl_ms, 1) / 1000.0
        self.probe_timeout_s = max(probe_timeout_ms, 50) / 1000.0
        self.spillover_retries = max(0, spillover_retries)
        self.dead_after_failures = max(1, dead_after_failures)
        # request-trace ingress: the router mints (or adopts) the trace
        # context every request carries through the fleet; its own
        # collector tail-samples the route-side view
        self.collector = (collector if collector is not None
                          else reqtrace.ReqTraceCollector("router"))
        self._lock = threading.Lock()
        self._endpoints: dict[str, Endpoint] = {}  # guarded-by: _lock
        self._probing: set[str] = set()            # guarded-by: _lock
        # router-level counters (guarded-by: _lock)
        self.stats = {"requests_routed": 0, "requests_failed": 0,
                      "spillovers_429": 0, "failovers_error": 0,
                      "probe_failures": 0, "dead_evictions": 0,
                      "set_updates": 0,
                      # prefix-affinity outcome per routed request that
                      # carried at least one complete hashable block
                      "affinity_hits": 0, "affinity_misses": 0}
        self.set_endpoints(list(endpoints))
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router": self})
        self._httpd = BurstBacklogHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-router", daemon=True)
        self._prober_stop = threading.Event()
        self._prober = threading.Thread(target=self._probe_loop,
                                        name="router-prober", daemon=True)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread.start()
        self._prober.start()
        LOG.info("fleet router on port %d over %d endpoint(s)", self.port,
                 len(self.endpoints()))

    def stop(self) -> None:
        self._prober_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._prober.join(timeout=5.0)

    def _probe_loop(self) -> None:
        """Background probe refresh: every endpoint's snapshot is kept
        fresher than the TTL so the ROUTING path never pays a probe RPC
        (the design contract), drains/deaths are noticed without
        needing traffic, and a DOWN replica re-admits itself the moment
        it answers again. Endpoints refresh concurrently — one wedged
        replica's timeout must not stale the others' snapshots."""
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("router-prober",
                                 max(self.probe_ttl_s / 4, 0.01))
        while not self._prober_stop.is_set():
            beacon.beat()
            with self._lock:
                now = time.monotonic()
                # one in-flight probe per endpoint, ever: a wedged
                # replica (connect hangs to its timeout) must not
                # accumulate a pile of stuck probe threads sweep after
                # sweep — that pile IS load on the host the live
                # replicas are sharing
                due = [ep.url for ep in self._endpoints.values()
                       if now - ep.probed_at >= self.probe_ttl_s / 2
                       and ep.url not in self._probing]
                self._probing.update(due)
            for url in due:
                threading.Thread(target=self._probe_once, args=(url,),
                                 daemon=True).start()
            self._prober_stop.wait(max(self.probe_ttl_s / 4, 0.01))
        beacon.idle()

    def _probe_once(self, url: str) -> None:
        try:
            self.probe(url, force=True)
        finally:
            with self._lock:
                self._probing.discard(url)

    # -- endpoint set ---------------------------------------------------
    def set_endpoints(self, specs: list) -> None:
        """Install a new endpoint set (diff-merge: probe state survives
        for URLs present in both sets). This is the generation-bumped
        set from the AM — a removed replica stops receiving new sends
        instantly; its in-flight relays finish on their own sockets."""
        fresh = {}
        with self._lock:
            for spec in specs:
                ep = _normalize(spec)
                if not ep.url:
                    continue
                known = self._endpoints.get(ep.url)
                if known is not None:
                    known.task_id = ep.task_id or known.task_id
                    known.generation = ep.generation
                    known.draining_hint = ep.draining_hint
                    fresh[ep.url] = known
                else:
                    fresh[ep.url] = ep
            self._endpoints = fresh
            self.stats["set_updates"] += 1

    def remove_endpoint(self, url: str) -> None:
        with self._lock:
            self._endpoints.pop(url.rstrip("/"), None)

    def endpoints(self) -> list[dict]:
        with self._lock:
            return [ep.to_dict(self.dead_after_failures)
                    for ep in self._endpoints.values()]

    # -- load probe -----------------------------------------------------
    def probe(self, url: str, force: bool = False) -> Optional[dict]:
        """TTL-cached `/v1/load` read for one endpoint. Returns the load
        dict, or None when the replica is unreachable (failure counted
        toward dead-endpoint eviction)."""
        with self._lock:
            ep = self._endpoints.get(url.rstrip("/"))
            if ep is None:
                return None
            now = time.monotonic()
            if not force and now - ep.probed_at < self.probe_ttl_s:
                return ep.load
        try:
            with urllib.request.urlopen(ep.url + "/v1/load",
                                        timeout=self.probe_timeout_s) as r:
                load = json.loads(r.read().decode("utf-8"))
        except Exception:  # noqa: BLE001 — any probe failure = unreachable
            self._note_failure(ep, "probe")
            return None
        with self._lock:
            if ep.failures >= self.dead_after_failures:
                LOG.info("endpoint %s back up (probe ok)", ep.url)
            ep.load = load
            ep.probed_at = time.monotonic()
            ep.failures = 0
        return load

    def _note_failure(self, ep: Endpoint, kind: str) -> None:
        with self._lock:
            ep.failures += 1
            ep.probed_at = time.monotonic()
            ep.load = None
            self.stats["probe_failures"] += 1
            if ep.failures == self.dead_after_failures:
                self.stats["dead_evictions"] += 1
                LOG.warning("endpoint %s marked DOWN after %d consecutive "
                            "%s failure(s)", ep.url, ep.failures, kind)

    def invalidate(self, url: str) -> None:
        """Drop the cached probe for one endpoint (a 429/503 response is
        newer information than any cached snapshot)."""
        with self._lock:
            ep = self._endpoints.get(url.rstrip("/"))
            if ep is not None:
                ep.probed_at = 0.0

    # -- routing --------------------------------------------------------
    def candidates(self, prompt: Optional[list] = None) -> list[Endpoint]:
        """UP endpoints in routing order (see _ranked); `prompt` enables
        prefix-affinity ranking."""
        return [ep for ep, _ in self._ranked(prompt)]

    def _ranked(self, prompt: Optional[list] = None
                ) -> list[tuple["Endpoint", int]]:
        """UP endpoints as (endpoint, prefix_match_depth), best first:
        (-match_depth, queue_depth, -effective_slots, url) off the
        prober-maintained snapshots — the request path only READS the
        cache, it never pays a probe RPC (the one exception: a
        just-installed endpoint nobody has probed yet gets a one-time
        inline bootstrap probe). Affinity (the deepest advertised
        prefix-index match for `prompt`, hashed per the replica's own
        kv_page_size) is preferred, falling back least-loaded — but it
        NEVER overrides the state filter: DOWN endpoints stay in the
        prober's sweep so they re-admit themselves, a DRAINING endpoint
        is excluded from new sends entirely, and decode-role replicas
        only take /v1/migrate handoffs, never /v1/generate."""
        with self._lock:
            eps = list(self._endpoints.values())
        hash_memo: dict[int, list[str]] = {}
        ranked = []
        for ep in eps:
            load = ep.load
            if load is None and ep.probed_at == 0.0:
                load = self.probe(ep.url)       # bring-up bootstrap only
            if ep.state(self.dead_after_failures) != UP or load is None:
                continue
            if ep.effective_role() == "decode":
                continue
            depth = 0
            if prompt:
                psize = int(load.get("kv_page_size", 0) or 0)
                advertised = load.get("prefix_hashes")
                if psize > 0 and advertised:
                    if psize not in hash_memo:
                        from tony_tpu_torch.serve.kvcache import chain_hashes
                        hash_memo[psize] = chain_hashes(prompt, psize)
                    depth = _prefix_match_depth(hash_memo[psize],
                                                advertised)
            ranked.append((-depth, int(load.get("queue_depth", 0)),
                           -_effective_slots(load), ep.url, ep, depth))
        ranked.sort(key=lambda t: t[:4])
        return [(t[4], t[5]) for t in ranked]

    def fleet_load(self) -> dict:
        """Aggregate load over UP+DRAINING replicas (the router's own
        /v1/load — a fleet of routers can stack), read off the cached
        snapshots."""
        totals = {"queue_depth": 0, "slots_free": 0, "active_slots": 0,
                  "n_slots": 0, "kv_pages_free": 0, "kv_pages_total": 0}
        states = {UP: 0, DRAINING: 0, DOWN: 0}
        with self._lock:
            eps = list(self._endpoints.values())
        for ep in eps:
            load = ep.load
            state = ep.state(self.dead_after_failures)
            states[state] += 1
            if load is not None and state != DOWN:
                for key in totals:
                    totals[key] += int(load.get(key, 0) or 0)
        return {**totals, "endpoints_up": states[UP],
                "endpoints_draining": states[DRAINING],
                "endpoints_down": states[DOWN],
                "draining": states[UP] == 0 and states[DRAINING] > 0}

    # -- relay ----------------------------------------------------------
    # tony: disable=redact-on-egress -- data-plane relay: the payload is the client's own /v1/generate body, verbatim
    def relay(self, body: bytes, send_response: Callable,
              headers: Optional[dict] = None) -> None:
        """Route one /v1/generate body: try replicas least-loaded first,
        spilling over on 429/5xx/transport errors. `send_response(status,
        headers, upstream_or_bytes)` is the handler-side writer —
        streaming is detected off the upstream Transfer-Encoding, never
        by parsing the request body. `headers` are the client's request
        headers: an X-Tony-Trace there is adopted, otherwise this
        ingress mints the trace the whole fleet will carry."""
        ctx, _ = reqtrace.adopt_or_mint(
            (headers or {}).get(reqtrace.HEADER))
        t_ingress = time.monotonic()
        trace = (self.collector.trace(ctx)
                 if self.collector is not None else None)
        tried: list[str] = []
        last_429 = None
        last_err: Optional[str] = None
        # prefix-affinity source: the prompt token ids, parsed once (a
        # non-JSON or promptless body simply routes least-loaded)
        prompt: Optional[list] = None
        try:
            parsed = json.loads(body.decode("utf-8"))
            raw = parsed.get("prompt") if isinstance(parsed, dict) else None
            if isinstance(raw, list):
                prompt = [int(t) for t in raw]
        except (ValueError, TypeError, UnicodeDecodeError):
            prompt = None
        for _ in range(1 + self.spillover_retries):
            picks = [(ep, d) for ep, d in self._ranked(prompt)
                     if ep.url not in tried]
            if not picks:
                break
            ep, match_depth = picks[0]
            tried.append(ep.url)
            # the route span's id goes on the wire BEFORE the hop is
            # recorded — the replica's hops parent under it; route_ms
            # rides the header so the replica's TTFT attribution can
            # include the router's overhead without cross-host clocks
            t_send = time.monotonic()
            route_ms = 1000.0 * (t_send - t_ingress)
            route_span = reqtrace.new_span_id()
            req = urllib.request.Request(
                ep.url + "/v1/generate", data=body,
                headers={"Content-Type": "application/json",
                         reqtrace.HEADER: ctx.child(
                             route_span, route_ms).header_value()})
            try:
                resp = urllib.request.urlopen(req,
                                              timeout=RELAY_TIMEOUT_SEC)
            except urllib.error.HTTPError as e:
                payload = e.read()
                if e.code == 429:
                    # this replica is shedding: newer info than the cached
                    # probe — invalidate and spill to the next-least-loaded
                    last_429 = (e.code, dict(e.headers), payload)
                    self.invalidate(ep.url)
                    with self._lock:
                        self.stats["spillovers_429"] += 1
                    continue
                if e.code in (500, 502, 503, 504):
                    # draining/stopped/broken replica: fail over; a
                    # draining 503 is not a deadness signal, just a
                    # routing miss — re-probe will see draining=true
                    self.invalidate(ep.url)
                    last_err = f"{ep.url} answered {e.code}"
                    with self._lock:
                        self.stats["failovers_error"] += 1
                    continue
                # 4xx contract errors (400 bad request) are the CLIENT's:
                # no replica would answer differently — relay verbatim
                with self._lock:
                    ep.sent += 1
                    self.stats["requests_routed"] += 1
                    self._note_affinity(prompt, match_depth)
                send_response(e.code, dict(e.headers), payload)
                self._finish_route_trace(
                    trace, t_ingress, t_send, route_span, ep.url,
                    match_depth, prompt, tried, e.code)
                return
            except Exception as e:  # noqa: BLE001 — transport failure
                self._note_failure(ep, "send")
                last_err = f"{ep.url} unreachable: {e}"
                with self._lock:
                    self.stats["failovers_error"] += 1
                continue
            with self._lock:
                ep.sent += 1
                self.stats["requests_routed"] += 1
                self._note_affinity(prompt, match_depth)
            send_response(resp.status, dict(resp.headers), resp)
            # finished AFTER the full relay (including the token
            # stream): the router-side duration is client-observed
            self._finish_route_trace(
                trace, t_ingress, t_send, route_span, ep.url,
                match_depth, prompt, tried, resp.status)
            return
        with self._lock:
            self.stats["requests_failed"] += 1
        if last_429 is not None:
            code, hdrs_429, payload = last_429
            send_response(code, {"Retry-After":
                                 hdrs_429.get("Retry-After", "1")}, payload)
            self._finish_route_trace(trace, t_ingress, time.monotonic(),
                                     None, "", 0, prompt, tried, 429)
            return
        detail = last_err or "no serving replica available"
        send_response(503, {}, json.dumps(
            {"error": f"fleet unavailable: {detail}",
             "tried": tried}).encode("utf-8") + b"\n")
        self._finish_route_trace(trace, t_ingress, time.monotonic(),
                                 None, "", 0, prompt, tried, 503)

    def _finish_route_trace(self, trace, t_ingress: float, t_send: float,
                            route_span: Optional[str], target: str,
                            match_depth: int, prompt: Optional[list],
                            tried: list, status: int) -> None:
        """Record the router.route hop and tail-sample the route-side
        trace; route_ms feeds the router's own attribution rollup."""
        if trace is None or self.collector is None:
            return
        route_ms = 1000.0 * (t_send - t_ingress)
        now = time.monotonic()
        attrs = {"target": target,
                 "affinity": (("hit" if match_depth > 0 else "miss")
                              if prompt else "n/a"),
                 "match_depth": int(match_depth),
                 "attempts": len(tried),
                 "spilled": status == 429,
                 "failed_over": len(tried) > 1,
                 "http_status": int(status)}
        trace.hop("router.route",
                  reqtrace.mono_to_wall_ms(t_ingress),
                  reqtrace.mono_to_wall_ms(t_send), attrs=attrs,
                  status="OK" if status < 500 else "ERROR",
                  span_id=route_span)
        self.collector.attribution.record({"route_ms": route_ms})
        self.collector.finish(trace, 1000.0 * (now - t_ingress),
                              error=status >= 500, spilled=status == 429)

    def _note_affinity(self, prompt: Optional[list],
                       match_depth: int) -> None:
        """Affinity outcome counter for one routed request (caller holds
        the lock). Only requests that COULD match count — a promptless
        or sub-page body is neither hit nor miss."""
        if not prompt:
            return
        if match_depth > 0:
            self.stats["affinity_hits"] += 1
        else:
            self.stats["affinity_misses"] += 1

    def bundle(self) -> dict:
        """The /v1/fleet surface: endpoint table + router counters."""
        with self._lock:
            stats = dict(self.stats)
        return {"endpoints": self.endpoints(), "stats": stats,
                "load": self.fleet_load()}

    # -- trace pull + stitch --------------------------------------------
    def collect_traces(self) -> dict:
        """The fleet's stitched request traces: this router's own
        sampled buffer merged with every replica's /v1/traces pull
        (decode replicas included — routing skips them, tracing must
        not). Pull-only by construction: replicas are contacted ONLY
        when an operator asks for this surface, never per request."""
        with self._lock:
            urls = list(self._endpoints)
        lists = [self.collector.export()
                 if self.collector is not None else []]
        pulled = {}
        for url in urls:
            try:
                with urllib.request.urlopen(
                        url + "/v1/traces",
                        timeout=self.probe_timeout_s) as r:
                    payload = json.loads(r.read().decode("utf-8"))
            except Exception:  # noqa: BLE001 — a dead replica has no traces
                pulled[url] = 0
                continue
            traces = payload.get("traces") or []
            pulled[url] = len(traces)
            lists.append(traces)
        stitched = reqtrace.stitch(lists)
        return {"traces": stitched,
                "slowest": reqtrace.slowest_table(stitched),
                "pulled": pulled}


def router_prometheus_text(router: FleetRouter) -> str:
    """The router's /metrics exposition: every stats counter as a
    tony_router_*_total counter plus the route-overhead percentile
    gauges — the same shared-encoder contract the serving frontend and
    the AM use (observability/prometheus.py)."""
    from tony_tpu_torch.observability.prometheus import (
        render, task_metric_name,
    )
    with router._lock:
        stats = dict(router.stats)
    families = []
    for key in sorted(stats):
        families.append({
            "name": task_metric_name(f"router_{key}_total"),
            "type": "counter", "help": "",
            "samples": [({}, float(stats[key]))]})
    if router.collector is not None:
        gauges = router.collector.attribution.gauges()
        for tag in ("p50", "p95"):
            value = gauges.get(f"ttft_attr_route_ms_{tag}")
            if value is not None:
                families.append({
                    "name": task_metric_name(f"router_route_ms_{tag}"),
                    "type": "gauge", "help": "",
                    "samples": [({}, float(value))]})
    return render(families)


class _RouterHandler(BaseHTTPRequestHandler):
    router: FleetRouter                   # injected by FleetRouter
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        LOG.debug("router: " + fmt, *args)

    def _json(self, obj, code: int = 200, extra: Optional[dict] = None
              ) -> None:
        data = (json.dumps(obj) + "\n").encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path.rstrip("/")
        if path == "/healthz":
            load = self.router.fleet_load()
            return self._json({"ok": load["endpoints_up"] > 0, **load})
        if path == "/v1/load":
            return self._json({"ok": True, **self.router.fleet_load()})
        if path == "/v1/fleet":
            return self._json(self.router.bundle())
        if path == "/v1/traces":
            # on-demand stitch: this is the ONE moment replicas are
            # asked for traces — operator-initiated, never per request
            return self._json(self.router.collect_traces())
        if path == "/metrics":
            from tony_tpu_torch.observability.prometheus import CONTENT_TYPE
            data = router_prometheus_text(self.router).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self._json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path.rstrip("/")
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length > 0 else b""
        if path != "/v1/generate":
            return self._json({"error": "not found"}, 404)
        self.router.relay(body, self._send_relayed,
                          headers=dict(self.headers))

    def _send_relayed(self, status: int, headers: dict, payload) -> None:
        """Write one upstream response through: bytes verbatim, file-like
        bodies relayed line-by-line under chunked framing (streaming
        passthrough — no buffering between replica and client)."""
        chunked = str(headers.get("Transfer-Encoding", "")
                      ).lower() == "chunked"
        if isinstance(payload, (bytes, bytearray)):
            self.send_response(status)
            self.send_header("Content-Type",
                             headers.get("Content-Type",
                                         "application/json"))
            self.send_header("Content-Length", str(len(payload)))
            for k in ("Retry-After", "X-Tony-Draining"):
                if headers.get(k):
                    self.send_header(k, headers[k])
            self.end_headers()
            self.wfile.write(payload)
            return
        # file-like upstream (urllib response). Non-chunked: relay with
        # Content-Length. Chunked: re-chunk line-by-line as data arrives.
        if not chunked:
            data = payload.read()
            self.send_response(status)
            self.send_header("Content-Type",
                             headers.get("Content-Type",
                                         "application/json"))
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self.send_response(status)
        self.send_header("Content-Type",
                         headers.get("Content-Type", "application/json"))
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for line in payload:      # urllib decodes upstream chunking
                self.wfile.write(f"{len(line):x}\r\n".encode("ascii")
                                 + line + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            # client gone mid-stream: close our side; the replica's own
            # broken-pipe handling cancels the request
            self.close_connection = True
        finally:
            try:
                payload.close()
            except Exception:  # noqa: BLE001 — teardown best effort
                LOG.debug("upstream close failed", exc_info=True)


# ---------------------------------------------------------------------------
# AM-backed endpoint watcher (orchestrated runs)
# ---------------------------------------------------------------------------

class AmEndpointWatcher:
    """Polls the AM's get_task_infos for the serving-endpoint set and
    diff-merges it into the router — endpoint registrations, drain marks
    and generation bumps reach the router at the poll cadence without
    the router ever becoming a control-plane participant."""

    def __init__(self, router: FleetRouter, client,
                 interval_s: float = 1.0):
        self.router = router
        self.client = client
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="router-am-watch",
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def poll_once(self) -> int:
        infos = self.client.get_task_infos()
        eps = endpoints_from_task_infos(infos or [])
        self.router.set_endpoints(eps)
        return len(eps)

    def _loop(self) -> None:
        from tony_tpu_torch.observability.profiler import register_beacon
        beacon = register_beacon("router-endpoint-watcher",
                                 self.interval_s)
        while not self._stop.is_set():
            beacon.beat()
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — AM mid-boot/restart
                LOG.debug("endpoint poll failed", exc_info=True)
            self._stop.wait(self.interval_s)
        beacon.idle()
