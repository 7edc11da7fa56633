"""The port's serving fleet (`tony_tpu_torch/serve/{router,autoscaler}.py`)
and admission arbiter (`tony_tpu_torch/cluster/arbiter.py`) against the
JAX package's.

- Asks, inventories and queue trees from a seed through both `Arbiter`s:
  the verdicts, the reasons, the victim and reclaim sets; the delivery
  edges (`execute_preemption`, `execute_reclaims`, `offer_idle_chips`)
  against one recording RPC server.
- SLI sequences from a seed through both `ReplicaAutoscaler`s, the SLI
  fold of per-replica gauges and the replica ask's verdict; one monitor
  pass of each package's AM over the same pushed gauges.
- Both `FleetRouter`s over the same stub replicas, driven through the
  same script: the routing order, 429 spill-over and the fleet-wide 429,
  drain exclusion, eviction and re-admission, the endpoint-set merge, the
  `/v1/fleet` bundle and the Prometheus counters.
- Real requests through the port's router to two port servers of a tiny
  llama on the CPU: every stream is the JAX package's `generate`.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tony_tpu.cluster import arbiter as jarb
from tony_tpu.observability import fleet as jfleet
from tony_tpu.serve import autoscaler as jscale
from tony_tpu.serve import router as jrouter
from tony_tpu_torch.cluster import arbiter as parb
from tony_tpu_torch.observability import fleet as pfleet
from tony_tpu_torch.serve import autoscaler as pscale
from tony_tpu_torch.serve import router as prouter

pytestmark = pytest.mark.serving


def _conf(pkg: str, settings: dict):
    if pkg == "jax":
        from tony_tpu.conf import TonyConfiguration
    else:
        from tony_tpu_torch.conf import TonyConfiguration
    conf = TonyConfiguration()
    for k, v in settings.items():
        conf.set(k, v, "test")
    return conf


# ---------------------------------------------------------------------------
# the arbiter
# ---------------------------------------------------------------------------

def _book(F, rng) -> list[dict]:
    jobs = []
    for i in range(int(rng.integers(2, 9))):
        width = int(rng.integers(1, 5))
        cpt = int(rng.integers(1, 3))
        elastic = rng.random() < 0.4
        jobs.append(F.job_summary(
            f"app_{i}", f"u{int(rng.integers(0, 3))}",
            str(rng.choice(["prod", "dev", "batch"])),
            "RUNNING" if rng.random() < 0.85 else "SUCCEEDED",
            gang_width=width, allocated_chips=width * cpt,
            started_ms=int(rng.integers(0, 10_000)),
            priority=int(rng.integers(-2, 3)),
            elastic_job="worker" if elastic else "",
            elastic_width=width if elastic else 0,
            elastic_chips_per_task=cpt if elastic else 0,
            elastic_min_chips=cpt if elastic else 0,
            elastic_max_width=width + 2 if elastic else 0))
    return jobs


def _queue_settings(rng) -> dict:
    settings = {"tony.arbiter.total-tpus": int(rng.integers(8, 33)),
                "tony.arbiter.preemption-enabled": bool(rng.random() < 0.8),
                "tony.queues.root.capacity-share": 100,
                "tony.queues.prod.parent": "root",
                "tony.queues.prod.capacity-share":
                    int(rng.integers(40, 101)),
                "tony.queues.dev.parent": "root",
                "tony.queues.dev.capacity-share": int(rng.integers(10, 60)),
                "tony.queues.batch.capacity-share":
                    int(rng.integers(10, 100))}
    if rng.random() < 0.5:
        settings["tony.queues.dev.max-tpus-per-user"] = \
            int(rng.integers(1, 8))
    return settings


def _decisions(pkg: str, seed: int) -> list:
    A, F = (jarb, jfleet) if pkg == "jax" else (parb, pfleet)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(12):
        arb = A.Arbiter.from_conf(_conf(pkg, _queue_settings(rng)))
        arb.sync_from_fleet(_book(F, rng))
        for _ in range(4):
            ask = A.GangAsk(app_id="ask", chips=int(rng.integers(1, 20)),
                            queue=str(rng.choice(["prod", "dev", "batch",
                                                  "nope"])),
                            user=f"u{int(rng.integers(0, 3))}",
                            priority=int(rng.integers(-1, 4)))
            d = arb.decide(ask)
            out.append((d.action, d.reason,
                        [v.app_id for v in d.victims],
                        [(a.app_id, c) for a, c in d.reclaims],
                        arb.free_chips(), arb.used_chips(),
                        sorted(arb.running)))
            if rng.random() < 0.3:
                out.append(arb.admit(ask).action)
                arb.release("ask")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arbiter_verdicts_match_jax(seed):
    got = {pkg: _decisions(pkg, seed) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    actions = {d[0] for d in got["port"] if isinstance(d, tuple)}
    assert {"admit", "queue"} <= actions
    assert actions & {"preempt", "reclaim"}


def test_gang_ask_and_resume_overrides_match_jax():
    rng = np.random.default_rng(5)
    for s in _book(jfleet, rng):
        j, p = jarb.GangAsk.from_summary(s), parb.GangAsk.from_summary(s)
        assert vars(p) == vars(j)
        assert (p.chips_per_task, p.reclaimable_chips) == (
            j.chips_per_task, j.reclaimable_chips)
        assert parb.resume_conf_overrides(s) == jarb.resume_conf_overrides(s)


class _Recorder:
    """Cluster-service handler that records the asks the delivery edges
    send (request_resize, request_preemption)."""

    def __init__(self):
        self.asks = []

    def request_resize(self, req):
        self.asks.append(("resize", req))
        return {"app_id": "victim", "to_width": int(req.get("width", 0))}

    def request_preemption(self, req):
        self.asks.append(("preempt", req))
        return {"app_id": "victim"}

    def __getattr__(self, name):
        return lambda req: {}


def test_delivery_edges_match_jax():
    from tony_tpu.rpc.service import serve
    handler = _Recorder()
    server, port = serve(cluster_handler=handler)
    addr = f"127.0.0.1:{port}"
    got = {}
    try:
        for pkg, (A, F) in {"jax": (jarb, jfleet),
                            "port": (parb, pfleet)}.items():
            handler.asks.clear()
            elastic = F.job_summary(
                "ela", "u", "q", "RUNNING", gang_width=4, allocated_chips=8,
                elastic_job="worker", elastic_width=4,
                elastic_chips_per_task=2, elastic_min_chips=2,
                elastic_max_width=8, am_addr=addr)
            lost = F.job_summary("gone", "u", "q", "RUNNING",
                                 gang_width=1, allocated_chips=2)
            victim = A.GangAsk.from_summary(elastic)
            reached = (
                A.execute_preemption([victim, A.GangAsk.from_summary(lost)],
                                     grace_ms=1234, reason="admit hi"),
                A.execute_reclaims([(victim, 4)], grace_ms=99,
                                   reason="reclaim"),
                A.offer_idle_chips([elastic, lost], 5, reason="offer"))
            got[pkg] = (reached, list(handler.asks))
    finally:
        server.stop(grace=None)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (["ela"], ["ela"],
                              [{"app_id": "ela", "job_name": "worker",
                                "width": 6}])


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------

def _sli_run(S, seed: int) -> list:
    rng = np.random.default_rng(seed)
    cfg = S.AutoscalerConfig(
        min_replicas=1, max_replicas=4, ttft_p95_up_ms=400.0,
        itl_p50_up_ms=60.0, queue_depth_up=8, reject_rate_up_pct=1.0,
        occupancy_down_pct=30, hysteresis_passes=int(rng.integers(1, 4)),
        cooldown_ms=int(rng.integers(0, 5000)))
    sc = S.ReplicaAutoscaler(cfg)
    replicas, sub, rej, now = 1, 0.0, 0.0, 0
    out = []
    for i in range(80):
        hot = (i // 15) % 2 == 0
        sub += float(rng.integers(10, 50))
        rej += float(rng.integers(0, 5)) if hot else 0.0
        slis = {"ttft_p95_s": float(rng.uniform(0.1, 0.8) if hot
                                    else rng.uniform(0.05, 0.3)),
                "itl_p50_ms": float(rng.uniform(10, 90) if hot
                                    else rng.uniform(5, 40)),
                "queue_depth": float(rng.integers(0, 40) if hot else 0),
                "occupancy_pct": float(rng.uniform(70, 100) if hot
                                       else rng.uniform(0, 25)),
                "submitted_total": sub, "rejected_total": rej}
        v = sc.evaluate(slis, replicas, now)
        out.append(v)
        if v["action"] != "hold":
            replicas = v["target"]
            sc.note_scaled(now)
        now += int(rng.integers(200, 1500))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_autoscaler_verdicts_match_jax(seed):
    got = {"jax": _sli_run(jscale, seed), "port": _sli_run(pscale, seed)}
    assert got["port"] == got["jax"]
    assert {v["action"] for v in got["port"]} == {"up", "down", "hold"}


def test_sli_fold_and_replica_ask_match_jax():
    rng = np.random.default_rng(3)
    gauges = {}
    for k in range(5):
        g = {"SERVING_QUEUE_DEPTH": float(rng.integers(0, 20)),
             "SERVING_SLOT_OCCUPANCY_PCT": float(rng.uniform(0, 100)),
             "SERVING_SUBMITTED_TOTAL": float(rng.integers(0, 500)),
             "SERVING_REJECTED_TOTAL": float(rng.integers(0, 9))}
        if k % 2:
            g["SERVING_TTFT_P95_S"] = float(rng.uniform(0, 1))
            g["SERVING_ITL_P50_MS"] = float(rng.uniform(5, 50))
        gauges[f"serving:{k}"] = g
    gauges["worker:0"] = {"SERVING_QUEUE_DEPTH": 99.0}
    gauges["serving:9"] = {"TPU_UTILIZATION": 50.0}
    roles = {"serving:0": "prefill", "serving:1": "decode",
             "serving:2": "both"}
    for kw in ({}, {"live_task_ids": {"serving:0", "serving:3"}},
               {"roles": roles, "role": "prefill"},
               {"roles": roles, "role": "decode"},
               {"live_task_ids": {"serving:9"}}):
        assert pscale.aggregate_serving_slis(gauges, **kw) == \
            jscale.aggregate_serving_slis(gauges, **kw), kw
    book = [jfleet.job_summary("trainer", "b", "default", "RUNNING",
                               allocated_chips=8, priority=-1,
                               started_ms=1000),
            jfleet.job_summary("other", "c", "default", "RUNNING",
                               allocated_chips=2, priority=9)]
    for chips, total, prio, role in ((4, 8, 5, None), (4, 16, 0, "decode"),
                                     (1, 10, 0, None), (0, 8, 0, None),
                                     (4, 10, -5, "prefill")):
        out = []
        for pkg, S in (("jax", jscale), ("port", pscale)):
            d = S.replica_ask_verdict(
                _conf(pkg, {"tony.arbiter.total-tpus": total}), "serve_app",
                chips, fleet_summaries=book, priority=prio, role=role)
            out.append((d.action, d.reason, [v.app_id for v in d.victims]))
        assert out[0] == out[1]


def _fleet_am(pkg: str, tmp_path, **extra):
    """An in-process AM of `pkg` with a 1-replica serving jobtype, a stub
    backend and scheduler, and an event recorder."""
    if pkg == "jax":
        from tony_tpu.am.application_master import ApplicationMaster
        from tony_tpu.session.session import TonySession
    else:
        from tony_tpu_torch.am.application_master import ApplicationMaster
        from tony_tpu_torch.session.session import TonySession

    class _Backend:
        def start(self):
            ...

        def stop_container(self, cid):
            ...

    class _Scheduler:
        def __init__(self):
            self.scale_ups = []

        def schedule_scale_up(self, job_name):
            self.scale_ups.append(job_name)

    conf = _conf(pkg, {"tony.serving.instances": 1, **extra})
    app_dir = tmp_path / pkg
    app_dir.mkdir()
    am = ApplicationMaster(conf, "app_fleet", str(app_dir),
                           backend=_Backend())
    am.session = TonySession(conf, session_id=0)
    am.scheduler = _Scheduler()
    events = []
    am.event_handler.emit = events.append
    return am, events


def test_am_autoscaler_pass_matches_jax(tmp_path):
    """Two monitor passes of each AM over the same pushed gauges: the
    first scales up through the arbiter, the cooldown holds the second."""
    got = {}
    for pkg in ("jax", "port"):
        am, events = _fleet_am(
            pkg, tmp_path, **{"tony.autoscaler.enabled": True,
                              "tony.autoscaler.hysteresis-passes": 1,
                              "tony.autoscaler.max-replicas": 4,
                              "tony.autoscaler.queue-depth-up": 8})
        assert am.autoscaler is not None
        am.metrics_store.update_metrics({
            "task_type": "serving", "index": 0, "metrics": [
                {"name": "SERVING_QUEUE_DEPTH", "value": 40.0},
                {"name": "SERVING_SLOT_OCCUPANCY_PCT", "value": 100.0},
                {"name": "SERVING_TTFT_P95_S", "value": 0.4},
                {"name": "SERVING_SUBMITTED_TOTAL", "value": 50.0},
                {"name": "SERVING_REJECTED_TOTAL", "value": 0.0}]})
        am._check_autoscaler()
        am._check_autoscaler()
        got[pkg] = ([(e.type.name, vars(e.payload)) for e in events],
                    am.scheduler.scale_ups,
                    [t.task_id for t in am.session.job_tasks["serving"]])
    assert got["port"] == got["jax"]
    [(name, payload)] = got["port"][0]
    assert name == "AUTOSCALE_DECISION"
    assert payload["direction"] == "up"
    assert payload["arbiter_action"] == "admit"
    assert got["port"][1] == ["serving"]


# ---------------------------------------------------------------------------
# the router over stub replicas
# ---------------------------------------------------------------------------

class _Stub:
    """A replica with a scriptable /v1/load and a /v1/generate that names
    itself."""

    def __init__(self, name: str, port: int = 0, **load):
        self.name = name
        self.load = {"queue_depth": 0, "slots_free": 4, "active_slots": 0,
                     "n_slots": 4, "draining": False,
                     "weights_generation": 0, **load}
        self.status = 200
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if code == 429:
                    self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") == "/v1/load":
                    return self._json(dict(stub.load))
                self._json({"error": "nope"}, 404)

            def do_POST(self):  # noqa: N802
                self.rfile.read(int(self.headers.get("Content-Length", 0)
                                    or 0))
                if stub.status != 200:
                    return self._json({"error": "shed"}, stub.status)
                self._json({"served_by": stub.name})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), H)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def kill(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _served(rtr) -> str:
    try:
        return json.loads(_post(rtr.port, {"prompt": [1]}).read())[
            "served_by"]
    except urllib.error.HTTPError as e:
        return f"http {e.code} retry-after {e.headers.get('Retry-After')}"


def _until(rtr, url: str, state: str, what: str) -> None:
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if {e["url"]: e["state"] for e in rtr.endpoints()}.get(url) == state:
            return
        time.sleep(0.02)
    raise AssertionError(f"{what}: {url} never reached {state}")


def _router_script(R) -> dict:
    """One script through router module R over fresh stubs. Returns what
    the client and the router's surfaces showed at each step; stub URLs
    are replaced by the stub names."""
    a = _Stub("a", queue_depth=5, slots_free=0)
    b = _Stub("b", queue_depth=0, slots_free=1)
    c = _Stub("c", queue_depth=0, slots_free=4)
    names = {s.url: s.name for s in (a, b, c)}
    rtr = R.FleetRouter([a.url, b.url, c.url], port=0, host="127.0.0.1",
                        probe_ttl_ms=30, probe_timeout_ms=300,
                        spillover_retries=2, dead_after_failures=2)
    rtr.start()
    seen = []
    try:
        seen.append(("least-loaded", _served(rtr)))
        c.load.update(queue_depth=9)
        time.sleep(0.3)
        seen.append(("deeper queue", _served(rtr)))
        b.status = 429
        seen.append(("429 spill", _served(rtr)))
        for s in (a, c):
            s.status = 429
        time.sleep(0.3)
        seen.append(("fleet-wide 429", _served(rtr)))
        for s in (a, b, c):
            s.status = 200
        a.load.update(queue_depth=0, slots_free=8)
        b.load["draining"] = True
        time.sleep(0.3)
        seen.append(("drain", [_served(rtr) for _ in range(3)]))
        b.load["draining"] = False
        port = a.port
        a.kill()
        _until(rtr, a.url, R.DOWN, "eviction")
        seen.append(("dead", [_served(rtr) for _ in range(2)]))
        a2 = _Stub("a2", port=port, slots_free=16)
        try:
            _until(rtr, a.url, R.UP, "re-admission")
            seen.append(("back", _served(rtr)))
        finally:
            a2.kill()
        bundle = rtr.bundle()
        rtr.set_endpoints(R.endpoints_from_task_infos([
            {"name": "serving-endpoint", "task_id": "serving:1",
             "url": b.url, "generation": 2, "draining": True},
            {"name": "serving-endpoint", "task_id": "serving:2",
             "url": c.url, "generation": 2},
            {"name": "tensorboard", "url": "http://tb:1"}]))
        merged = rtr.endpoints()
        text = R.router_prometheus_text(rtr)
    finally:
        rtr.stop()
        for s in (b, c):
            s.kill()

    def named(obj):
        out = json.dumps(obj, sort_keys=True)
        for url, name in names.items():
            out = out.replace(url, name)
        return json.loads(out)

    counters = sorted(line for line in text.splitlines()
                      if line.startswith("tony_router_")
                      and "_total" in line.split(" ")[0])
    for e in bundle["endpoints"]:
        e.pop("failures")           # how many probes failed in the gap
    bundle["stats"].pop("probe_failures")
    return {"seen": named(seen), "bundle": named(bundle),
            "merged": named(merged),
            "counters": [c for c in counters
                         if not c.startswith("tony_router_probe_failures")]}


def test_router_over_stub_replicas_matches_jax():
    got = {"jax": _router_script(jrouter), "port": _router_script(prouter)}
    assert got["port"] == got["jax"]
    seen = dict(got["port"]["seen"])
    assert seen["least-loaded"] == "c" and seen["deeper queue"] == "b"
    assert seen["429 spill"] in ("a", "c")
    assert seen["fleet-wide 429"] == "http 429 retry-after 1"
    assert "b" not in seen["drain"]
    assert seen["back"] == "a2"
    assert got["port"]["bundle"]["stats"]["spillovers_429"] >= 4
    assert [e["state"] for e in got["port"]["merged"]] == [
        "DRAINING", "UP"]


# ---------------------------------------------------------------------------
# real requests through the port's router to two port servers
# ---------------------------------------------------------------------------

def test_router_to_two_port_servers_streams_equal_jax_generate():
    """Two port engines of a tiny llama (f32, the JAX package's weights)
    behind the port's router: streamed and blocking requests, spread over
    both replicas by the router's load probes (the second request goes
    where the first one's queue is not), each equal to the JAX package's
    greedy `generate` on the same prompt."""
    import jax
    import jax.numpy as jnp
    import torch

    from tony_tpu.models import llama as jllama
    from tony_tpu.models.generate import generate as jax_generate
    from tony_tpu_torch.models.convert import params_from_jax
    from tony_tpu_torch.models.llama import get_config
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tony_tpu_torch.serve.frontend import ServeFrontend

    jcfg = jllama.get_config("tiny")
    jparams = jllama.llama_init(jcfg, jax.random.PRNGKey(2))
    cfg = get_config("tiny")
    params = params_from_jax(jparams, cfg, device=torch.device("cpu"))
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in (9, 5, 12, 7)]
    new = [24, 6, 6, 6]
    engines, fronts = [], []
    for _ in range(2):
        e = ContinuousBatchingEngine(params, cfg, n_slots=2,
                                     token_budget=64, queue_depth=8)
        f = ServeFrontend(e, port=0, host="127.0.0.1")
        f.start()
        engines.append(e)
        fronts.append(f)
    rtr = prouter.FleetRouter(
        [f"http://127.0.0.1:{f.port}" for f in fronts], port=0,
        host="127.0.0.1", probe_ttl_ms=30, probe_timeout_ms=500)
    rtr.start()
    got: dict[int, list] = {}

    def stream(i):
        with _post(rtr.port, {"prompt": prompts[i], "max_new_tokens": new[i],
                              "stream": True}) as r:
            got[i] = [rec["token"] for rec in map(json.loads, r)
                      if "token" in rec]

    def queued(n: int) -> None:
        deadline = time.monotonic() + 30
        while sum(int((e["load"] or {}).get("queue_depth", 0))
                  for e in rtr.endpoints()) < n:
            assert time.monotonic() < deadline, rtr.endpoints()
            time.sleep(0.01)

    try:
        # the engines' loops wait: each request queues where the router
        # sent it, and the prober shows the queue before the next is sent
        threads = []
        for i in (0, 1):
            threads.append(threading.Thread(target=stream, args=(i,)))
            threads[-1].start()
            queued(i + 1)
        for e in engines:
            e.start()
        for t in threads:
            t.join(timeout=60)
        for i in (2, 3):
            got[i] = json.loads(_post(rtr.port, {
                "prompt": prompts[i], "max_new_tokens": new[i]}).read())[
                    "tokens"]
    finally:
        rtr.stop()
        for f in fronts:
            f.stop()
        for e in engines:
            e.stop()
    for i, p in enumerate(prompts):
        want = np.asarray(jax_generate(jparams, jcfg, jnp.asarray([p]),
                                       new[i]))[0].tolist()
        assert got[i] == want, i
    served = [e.stats.requests_finished for e in engines]
    assert sum(served) == 4 and min(served) >= 1, served
