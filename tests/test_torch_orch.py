"""The port as a TonY task, on the CPU: its reports to the orchestrator
against the JAX package's.

- Wire and format parity: the Prometheus text byte for byte, the
  X-Tony-Trace header, the goodput ledger under patched clocks, span dicts
  and the redacted trace export.
- The port's RPC client against the JAX AM's real gRPC server
  (`tony_tpu.rpc.service.serve` with recording handlers): reporter and
  endpoint-registration payloads equal the JAX package's, and the task
  token passes or fails as it does for JAX.
- The port's frontend: /metrics, /v1/traces, /v1/drain, and one trace id
  across a prefill -> decode relay.
- Two jobs under the JAX package's real control plane: the port's server
  as the serving jobtype, and the port's trainer on a token shard.
"""

import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import grpc
import jax
import numpy as np
import pytest
import torch

from tony_tpu.observability import perf as jperf
from tony_tpu.observability import prometheus as jprom
from tony_tpu.observability import reqtrace as jreqtrace
from tony_tpu.observability import trace as jtrace
from tony_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from tony_tpu.rpc.service import serve as jax_rpc_serve
from tony_tpu.security.tokens import derive_task_token
from tony_tpu_torch.models.llama import get_config, llama_init
from tony_tpu_torch.observability import perf, prometheus, reqtrace, trace
from tony_tpu_torch.observability.metrics import MetricsRegistry
from tony_tpu_torch.serve import __main__ as serve_main
from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
from tony_tpu_torch.serve.frontend import (
    ServeFrontend, engine_prometheus_text, install_engine_tracing,
)
from tony_tpu_torch.train import metrics as tmetrics
from tony_tpu_torch.train.native_data import write_token_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TID = "ab" * 16
SPAN = "cd" * 8


# ---------------------------------------------------------------------------
# wire and format parity
# ---------------------------------------------------------------------------

def _families():
    return [
        {"name": "tony_serving_ttft_p50_s", "type": "gauge",
         "help": "time to first token\nsecond line \\ slash",
         "samples": [({"app_id": 'a"b', "index": "0"}, 0.0123),
                     ({"app_id": "x\ny"}, float("nan"))]},
        {"name": "9bad-name.x", "type": "histogram", "help": "",
         "samples": [({}, float("inf")), ({"1lbl": "v"}, float("-inf"))]},
        {"name": "tony_count", "type": "counter", "help": "",
         "samples": [({}, 3.0), ({"k": "v"}, 1e20), ({"k": "w"}, -2.5)]},
    ]


def test_prometheus_text_byte_for_byte_jax():
    assert prometheus.render(_families()) == jprom.render(_families())
    assert prometheus.CONTENT_TYPE == jprom.CONTENT_TYPE
    for name in ("SERVING_TTFT_P50_S", "tony_x", "TPU_HBM_BYTES_IN_USE",
                 "3d.name"):
        assert prometheus.task_metric_name(name) \
            == jprom.task_metric_name(name)
    text = prometheus.render(_families())
    assert prometheus.parse(text).keys() == jprom.parse(text).keys()


def test_registry_families_render_as_jax():
    """The same counters, gauges and summary observations render to the
    same exposition bytes (summary quantiles from the same sketch)."""
    ours, theirs = MetricsRegistry(), JaxRegistry()
    for reg in (ours, theirs):
        reg.counter("tony_rpc_client_calls_total", method="m",
                    status="ok").inc(3)
        reg.gauge("tony_profiler_overhead_pct", process="p").set(0.42)
        for v in (1e-4, 3e-3, 0.02, 0.5, 7.0, 2e6):
            reg.summary("tony_rpc_client_latency_seconds",
                        method="m").observe(v)
    assert prometheus.render(ours.families()) \
        == jprom.render(theirs.families())


@pytest.mark.parametrize("value", [
    f"{TID}:{SPAN}", f"{TID}:{SPAN}:12.5", f"{TID}", f"{TID}:{SPAN}:x",
    "ZZ:" + SPAN, f"{TID}:nothex", "", None, f"{TID}:{SPAN}:-3"])
def test_trace_header_parse_and_format_as_jax(value):
    ours, theirs = reqtrace.parse_header(value), jreqtrace.parse_header(value)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert (ours.trace_id, ours.parent_span_id, ours.route_ms) == \
            (theirs.trace_id, theirs.parent_span_id, theirs.route_ms)
        assert ours.header_value() == theirs.header_value()
        assert ours.child("ef" * 8, 1.25).header_value() == \
            theirs.child("ef" * 8, 1.25).header_value()
    assert reqtrace.HEADER == jreqtrace.HEADER


def _clock(times):
    it = iter(times)
    return lambda: next(it)


def test_goodput_ledger_snapshot_equals_jax():
    seed = {"localization": 1.5, "rendezvous_wait": 0.25}
    times = [100.0, 101.0, 103.5, 104.0, 110.0, 111.25, 112.0, 115.0,
             116.0, 116.0]

    def drive(ledger):
        ledger.transition("compile")
        ledger.transition("train_step")
        ledger.transition("eval")
        ledger.transition("train_step")
        ledger.carve("input_stall", 0.75, source="train_step")
        ledger.transition("checkpoint_save")
        ledger.transition("idle")
        return ledger.snapshot(), ledger.metrics()

    ours = drive(perf.GoodputLedger(clock=_clock(times), seed=seed))
    theirs = drive(jperf.GoodputLedger(clock=_clock(times), seed=seed))
    assert ours == theirs
    assert sum(ours[0]["phases"].values()) == pytest.approx(ours[0]["wall_s"])
    assert perf.PHASES == jperf.PHASES


def test_goodput_ledger_from_env_seed_as_jax():
    env = {"TONY_GOODPUT_SEED": json.dumps({"localization": 2.0,
                                            "bad": "x"})}
    ours = perf.GoodputLedger.from_env(env).snapshot()["phases"]
    theirs = jperf.GoodputLedger.from_env(env).snapshot()["phases"]
    assert ours.keys() == theirs.keys()
    assert ours["localization"] == theirs["localization"] == 2.0


def test_span_dicts_have_the_jax_keys():
    env = {"TONY_TRACE_ID": "app_1", "TONY_PARENT_SPAN": "parent0"}
    ours = trace.SpanRecorder.from_env(env, task_id="worker:0", attempt=1)
    theirs = jtrace.SpanRecorder.from_env(env, task_id="worker:0", attempt=1)
    for rec in (ours, theirs):
        assert rec.enabled
        with rec.span("trainer_setup", attrs={"k": 1}):
            pass
        rec.record_complete("serve_request", 10, 20, attrs={"tokens": 3})
    a, b = ours.drain(), theirs.drain()
    assert [sorted(d) for d in a] == [sorted(d) for d in b]
    for x, y in zip(a, b):
        for key in ("name", "trace_id", "parent_id", "task_id", "attempt",
                    "status", "attrs"):
            assert x[key] == y[key]


def _collector_export(mod):
    coll = mod.ReqTraceCollector(
        "replica:0", sampler=mod.TailSampler(slow_threshold_ms=0.0))
    tr = mod.RequestTrace(mod.TraceContext(TID, SPAN), process="replica:0",
                          request_id="7")
    tr.hop("queue_wait", 1000, 1002, span_id="11" * 8)
    tr.hop("migrate.transfer", 1002, 1010,
           attrs={"target": "http://h:1?token=" + "f" * 64,
                  "note": "Bearer abc.def", "bytes": 12},
           span_id="22" * 8)
    coll.finish(tr, 12.0, migrated=True)
    return coll.export()


def test_redacted_trace_export_equals_jax():
    assert _collector_export(reqtrace) == _collector_export(jreqtrace)


def test_profile_capture_writes_a_torch_trace_with_the_jax_payload(
        tmp_path):
    """A request file starts torch.profiler for its steps; the trace lands
    in profiles/<id>/ and the published payload has the JAX keys."""
    with open(tmp_path / "profile_request.json", "w") as f:
        json.dump({"request_id": "r1", "num_steps": 2}, f)
    published = []
    cap = perf.ProfileCapture(cwd=str(tmp_path), publish=published.append)
    cap.poll()
    assert cap.active
    for _ in range(2):
        torch.ones(8).sum()
        cap.on_step()
    assert not cap.active and len(published) == 1
    assert os.path.exists(os.path.join(published[0]["path"], "trace.json"))
    assert not os.path.exists(tmp_path / "profile_request.json")
    theirs = []
    with open(tmp_path / "profile_request.json", "w") as f:
        json.dump({"request_id": "r1", "num_steps": 2}, f)
    jcap = jperf.ProfileCapture(cwd=str(tmp_path), publish=theirs.append,
                                start_fn=lambda d: None,
                                stop_fn=lambda: None)
    jcap.poll()
    jcap.on_step()
    jcap.on_step()
    assert sorted(published[0]) == sorted(theirs[0])
    assert published[0]["num_steps"] == theirs[0]["num_steps"] == 2
    # a seen request id never restarts a capture
    cap.poll()
    assert not cap.active


def test_sampling_profiler_measures_itself_and_the_watchdog_latches(
        caplog):
    from tony_tpu_torch.observability import profiler
    from tony_tpu_torch.observability.metrics import REGISTRY

    prof = profiler.SamplingProfiler("test:orch", hz=50.0)
    parked = threading.Event()
    other = threading.Thread(target=parked.wait, name="parked", daemon=True)
    other.start()
    for _ in range(4):         # the sampling thread skips its own stack
        prof.sample_once()
    parked.set()
    other.join(timeout=10)
    assert prof.samples == 4
    assert any(k.startswith("parked;") for k in prof.table.snapshot())
    # the gauge is the cost so far over the wall so far: it only falls
    # while nothing is sampled
    gauge = REGISTRY.gauge("tony_profiler_overhead_pct",
                           process="test:orch").value
    assert 0 < prof.overhead_pct() <= gauge
    beacon = profiler.register_beacon("test-loop", 0.1)
    beacon.beat()
    dog = profiler.StallWatchdog("test:orch", stall_factor=2.0)
    stalls = REGISTRY.counter("tony_stalls_total", process="test:orch")
    before = stalls.value
    with caplog.at_level("WARNING"):
        dog.check_once(now=time.monotonic() + 10.0)
        dog.check_once(now=time.monotonic() + 10.0)   # latched: no storm
        beacon.beat()
        dog.check_once()
        beacon.idle()
    assert stalls.value == before + 1
    events = [r.getMessage().split()[0] for r in caplog.records
              if "test-loop" in r.getMessage()]
    assert events == [profiler.STALL_DETECTED, profiler.STALL_CLEARED]


# ---------------------------------------------------------------------------
# the port's RPC client against the JAX AM's real RPC server
# ---------------------------------------------------------------------------

class _Recorder:
    """Duck-typed handler for every cluster and metrics method: records
    (method, request) and answers {}."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)

        def handler(req):
            with self._lock:
                self.calls.append((method, req))
            return {}
        return handler


@pytest.fixture
def am():
    """A recording AM on the JAX package's gRPC server, and a factory for
    the task environment pointing at it."""
    servers = []

    def start(token=None):
        rec = _Recorder()
        server, port = jax_rpc_serve(cluster_handler=rec,
                                     metrics_handler=rec,
                                     host="127.0.0.1", auth_token=token)
        servers.append(server)
        env = {"AM_HOST": "127.0.0.1", "AM_PORT": str(port),
               "JOB_NAME": "serving", "TASK_INDEX": "0",
               "TASK_ATTEMPT": "2"}
        return rec, env

    yield start
    for server in servers:
        server.stop(grace=None)


def _wait_calls(rec, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(rec.calls) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    return list(rec.calls)


GAUGES = [{"name": "TRAIN_STEP_TIME_MS", "value": 12.5},
          {"name": "GOODPUT_TRAIN_STEP_SECONDS", "value": 3.25}]
SPANS = [{"name": "trainer_setup", "span_id": "1", "trace_id": "t",
          "parent_id": "p", "task_id": "serving:0", "attempt": 2,
          "start_ms": 1, "end_ms": 2, "status": "OK", "attrs": {}}]


def test_reporter_payloads_equal_the_jax_reporters(am):
    from tony_tpu.train import metrics as jmetrics

    got = []
    for mod in (tmetrics, jmetrics):
        rec, env = am()
        r = mod.TpuMetricsReporter(env=env)
        # one push at a time: the queue is drop-newest by design
        r.report(extra=GAUGES)
        _wait_calls(rec, 1)
        r.report_spans(SPANS)
        _wait_calls(rec, 2)
        r.report_profile_done({"request_id": "r1", "path": "/p",
                               "num_steps": 2, "duration_ms": 5})
        _wait_calls(rec, 3)
        r.close(timeout=10)
        s = mod.ServingMetricsReporter(
            lambda: list(GAUGES), env=env, interval_sec=60.0,
            span_source=lambda: list(SPANS),
            trace_source=lambda: [{"trace_id": TID, "hops": []}])
        s.report_now()
        got.append(_wait_calls(rec, 4))
        s._sampler_stop.set()
        super(mod.ServingMetricsReporter, s).close(timeout=10)
    assert got[0] == got[1]
    assert [m for m, _ in got[0]] == ["update_metrics"] * 4
    assert got[0][0][1] == {"task_type": "serving", "index": 0,
                            "metrics": GAUGES, "attempt": 2}


def test_endpoint_registration_and_drain_equal_jax(am):
    from tony_tpu.serve import __main__ as jserve_main

    got = []
    for mod in (serve_main, jserve_main):
        rec, env = am()
        mod._register_endpoint("http://h:1", env, weights_generation=3,
                               role="prefill")
        mod._register_endpoint("http://h:1", env, draining=True,
                               role="prefill")
        mod._migrated_reporter(env)("http://decode:2")
        got.append(sorted(_wait_calls(rec, 3), key=lambda c: c[0]))
    assert got[0] == got[1]
    assert got[0][1][1] == {"task_id": "serving:0", "url": "http://h:1",
                            "draining": True, "role": "prefill"}


@pytest.mark.parametrize("good", [True, False])
def test_task_token_passes_and_a_wrong_one_fails_as_for_jax(am, good):
    from tony_tpu.rpc.client import MetricsServiceClient as JaxClient
    from tony_tpu_torch.rpc.client import MetricsServiceClient

    secret = "s" * 64
    token = derive_task_token(secret, "serving:0") if good else "0" * 64
    outcomes = []
    for cls in (MetricsServiceClient, JaxClient):
        rec, env = am(token=secret)
        client = cls("127.0.0.1", int(env["AM_PORT"]), auth_token=token,
                     task_auth_id="serving:0", retries=1)
        try:
            client.update_metrics("serving", 0, GAUGES)
            outcomes.append(("ok", len(rec.calls)))
        except grpc.RpcError as e:
            outcomes.append((e.code(), len(rec.calls)))
        finally:
            client.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == (("ok", 1) if good
                           else (grpc.StatusCode.UNAUTHENTICATED, 0))


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = get_config("tiny")
    return llama_init(cfg, torch.Generator().manual_seed(0)), cfg


def _prompts(n_list, seed=0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 256, size=n)] for n in n_list]


def _post(url, body, headers=None, timeout=60):
    rq = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(rq, timeout=timeout) as resp:
        return json.loads(resp.read().decode().splitlines()[-1])


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.headers, r.read().decode()


def _traces(base, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        snap = json.loads(_get(base + "/v1/traces")[1])
        if len(snap["traces"]) >= n or time.monotonic() > deadline:
            return snap
        time.sleep(0.05)


def _serve(engine_cls, frontend_mod, params, cfg, **fe):
    engine = engine_cls(params, cfg, n_slots=2, token_budget=32,
                        queue_depth=8, role=fe.pop("role", "both"))
    coll = fe.pop("collector_mod").ReqTraceCollector(
        fe.pop("process", "replica:0"),
        sampler=jreqtrace.TailSampler(slow_threshold_ms=0.0))
    frontend_mod.install_engine_tracing(engine, coll)
    engine.start()
    frontend = frontend_mod.ServeFrontend(engine, port=0, host="127.0.0.1",
                                          collector=coll, **fe)
    frontend.start()
    return engine, frontend, f"http://127.0.0.1:{frontend.port}"


def test_traces_and_metrics_have_the_jax_shape(model):
    """The same greedy requests on tiny f32 through the port's and the
    JAX frontend: /v1/traces has the same keys, hop names and parents;
    /metrics parses with the JAX parser and has the JAX families."""
    from tony_tpu.models.llama import get_config as jget_config
    from tony_tpu.models.llama import llama_init as jllama_init
    from tony_tpu.serve import frontend as jfrontend
    from tony_tpu.serve.engine import ContinuousBatchingEngine as JaxEngine
    from tony_tpu_torch.serve import frontend as pfrontend

    params, cfg = model
    jcfg = jget_config("tiny")
    jparams = jllama_init(jcfg, jax.random.PRNGKey(0))
    prompts = _prompts((6, 9))
    shapes = []
    for engine_cls, fe_mod, ps, c, coll_mod in (
            (ContinuousBatchingEngine, pfrontend, params, cfg, reqtrace),
            (JaxEngine, jfrontend, jparams, jcfg, jreqtrace)):
        engine, frontend, base = _serve(engine_cls, fe_mod, ps, c,
                                        collector_mod=coll_mod)
        try:
            for p in prompts:
                _post(base + "/v1/generate", {"prompt": p,
                                              "max_new_tokens": 4},
                      headers={reqtrace.HEADER: f"{TID}:{SPAN}"})
            snap = _traces(base, len(prompts))
            headers, text = _get(base + "/metrics")
            _, negotiated = _get(base + "/v1/metrics?format=prometheus")
            parsed = jprom.parse(text)
            jprom.parse(negotiated)
            shapes.append({
                "keys": sorted(snap),
                "trace_keys": sorted(snap["traces"][0]),
                "hops": [[(h["name"], h["parent_id"], sorted(h))
                          for h in t["hops"]] for t in snap["traces"]],
                "reasons": [t["kept_reason"] for t in snap["traces"]],
                "ids": {t["trace_id"] for t in snap["traces"]},
                "counts": snap["http_requests"]["/v1/generate"],
                "content_type": headers["Content-Type"],
                "families": {n for n, _ in parsed
                             if n.startswith("tony_serving_ttft_attr")}})
        finally:
            frontend.stop()
            engine.stop()
    assert shapes[0] == shapes[1]
    assert shapes[0]["ids"] == {TID} and shapes[0]["counts"] == 2
    assert shapes[0]["hops"][0][0][:2] == ("queue_wait", SPAN)


@pytest.mark.parametrize("token", ["", "t" * 64])
def test_drain_route_token_check(model, monkeypatch, token):
    params, cfg = model
    monkeypatch.setenv("TONY_SECURITY_TOKEN", token)
    engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                      token_budget=32)
    frontend = ServeFrontend(engine, port=0, host="127.0.0.1")
    frontend.start()
    url = f"http://127.0.0.1:{frontend.port}/v1/drain"
    try:
        if token:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    url, data=b"", method="POST"), timeout=10)
            assert e.value.code == 403
            assert not engine.draining
        ok = urllib.request.urlopen(urllib.request.Request(
            url, data=b"", method="POST",
            headers={"Authorization": f"Bearer {token}"}), timeout=10)
        assert ok.status == 200
        assert json.loads(ok.read())["draining"] is True
        assert engine.draining
    finally:
        frontend.stop()
        engine.stop()


def test_relay_keeps_one_trace_id_with_the_migrate_hops(model):
    params, cfg = model
    dec, dec_fe, dec_url = _serve(ContinuousBatchingEngine,
                                  sys.modules[ServeFrontend.__module__],
                                  params, cfg, collector_mod=reqtrace,
                                  role="decode", process="decode:0")
    migrated = []
    pre, pre_fe, pre_url = _serve(
        ContinuousBatchingEngine, sys.modules[ServeFrontend.__module__],
        params, cfg, collector_mod=reqtrace, role="prefill",
        process="prefill:0", migrate_targets=[dec_url],
        on_migrated=migrated.append)
    try:
        out = _post(pre_url + "/v1/generate",
                    {"prompt": _prompts((7,))[0], "max_new_tokens": 5},
                    headers={reqtrace.HEADER: f"{TID}:{SPAN}"})
        assert out["migrated"] is True and len(out["tokens"]) == 5
        pre_t = _traces(pre_url, 1)["traces"]
        dec_t = _traces(dec_url, 1)["traces"]
        assert [t["trace_id"] for t in pre_t + dec_t] == [TID, TID]
        pre_hops = {h["name"]: h for h in pre_t[0]["hops"]}
        assert {"migrate.pack", "migrate.transfer"} <= set(pre_hops)
        pack = pre_hops["migrate.pack"]
        assert pre_hops["migrate.transfer"]["parent_id"] == pack["span_id"]
        dec_hops = [h["name"] for h in dec_t[0]["hops"]]
        assert dec_hops == ["queue_wait", "migrate.install", "decode"]
        # the decode replica continues the trace under the pack hop
        assert all(h["parent_id"] == pack["span_id"]
                   for h in dec_t[0]["hops"])
        assert migrated == [dec_url]
        stitched = reqtrace.stitch([pre_t, dec_t])
        assert len(stitched) == 1
        assert stitched[0]["processes"] == ["prefill:0", "decode:0"]
    finally:
        for fe, engine in ((pre_fe, pre), (dec_fe, dec)):
            fe.stop()
            engine.stop()


def test_engine_prometheus_text_labels_under_the_orchestrator(
        model, monkeypatch):
    params, cfg = model
    for key, value in (("APP_ID", "app_9"), ("JOB_NAME", "serving"),
                       ("TASK_INDEX", "1"), ("TASK_ATTEMPT", "0")):
        monkeypatch.setenv(key, value)
    engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                      token_budget=32)
    parsed = jprom.parse(engine_prometheus_text(engine))
    labels = dict(next(ls for (n, ls) in parsed
                       if n == "tony_serving_n_slots"))
    assert labels == {"app_id": "app_9", "task_type": "serving",
                      "index": "1", "attempt": "0"}
    # no traffic yet: TTFT is NaN, not absent
    assert np.isnan(jprom.get_sample(parsed, "tony_serving_ttft_p50_s"))


def test_tpu_memory_metrics_empty_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tmetrics.tpu_memory_metrics() == []


# ---------------------------------------------------------------------------
# two jobs under the JAX package's real control plane
# ---------------------------------------------------------------------------

def _fast_conf(tmp_path, **overrides):
    from tony_tpu.conf import TonyConfiguration, keys as K
    conf = TonyConfiguration()
    conf.set(K.CLUSTER_WORKDIR, str(tmp_path), "test")
    conf.set(K.AM_MONITOR_INTERVAL_MS, 100, "test")
    conf.set(K.TASK_HEARTBEAT_INTERVAL_MS, 200, "test")
    conf.set(K.TASK_METRICS_INTERVAL_MS, 300, "test")
    conf.set(K.TASK_REGISTRATION_TIMEOUT_SEC, 60, "test")
    conf.set(K.AM_STOP_POLL_TIMEOUT_MS, 3000, "test")
    for k, v in overrides.items():
        conf.set(k, v, "test")
    return conf


def _history_events(client):
    from tony_tpu import constants as C
    from tony_tpu.events.handler import parse_events
    base = os.path.join(client.app_dir, C.HISTORY_DIR_NAME)
    finals = [os.path.join(d, f) for d, _, files in os.walk(base)
              for f in files if f.endswith(".jhist")]
    assert len(finals) == 1, finals
    return parse_events(finals[0])


def _port_closed(host, port):
    with socket.socket() as s:
        s.settimeout(1.0)
        return s.connect_ex((host, port)) != 0


@pytest.mark.serving
def test_port_server_as_the_serving_jobtype(tmp_path):
    """tony.serving.command runs the port's server: the AM's task infos
    list its endpoint, /metrics and /v1/generate answer, the history holds
    SERVING_* metrics, and stopping the job announces the drain."""
    from tony_tpu import constants as C
    from tony_tpu.client.tony_client import TonyClient
    from tony_tpu.conf import keys as K
    from tony_tpu.events.schema import EventType
    from tony_tpu.rpc.client import ClusterServiceClient

    conf = _fast_conf(tmp_path, **{K.SERVING_SLOTS: 2,
                                   K.SERVING_TOKEN_BUDGET: 64,
                                   K.SERVING_QUEUE_DEPTH: 8})
    client = TonyClient(conf)
    client.init(["--conf", "tony.serving.instances=1", "--conf",
                 f"tony.serving.command={sys.executable} -m "
                 f"tony_tpu_torch.serve --device cpu --config tiny"])
    client.submit()
    monitor = threading.Thread(target=client.monitor, daemon=True)
    monitor.start()
    endpoint = None
    try:
        hostport = os.path.join(client.app_dir, C.AM_HOSTPORT_FILE)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not os.path.exists(hostport):
            time.sleep(0.1)
        with open(hostport) as f:
            host, _, port = f.read().strip().rpartition(":")
        rpc = ClusterServiceClient(host, int(port), retries=2,
                                   retry_sleep_sec=0.2, timeout_sec=5.0)
        while time.monotonic() < deadline and endpoint is None:
            try:
                infos = rpc.get_task_infos()
            except Exception:  # noqa: BLE001 — AM mid-boot
                infos = []
            endpoint = next((i["url"] for i in infos
                             if i.get("name") == "serving-endpoint"), None)
            if endpoint is None:
                time.sleep(0.2)
        assert endpoint, "the port's serving endpoint never registered"
        out = _post(endpoint + "/v1/generate",
                    {"prompt": [1, 2, 3, 4], "max_new_tokens": 4})
        assert len(out["tokens"]) == 4
        parsed = jprom.parse(_get(endpoint + "/metrics")[1])
        assert jprom.get_sample(parsed, "tony_serving_n_slots",
                                task_type="serving") == 2.0
        time.sleep(1.0)          # two or three 300 ms metric pushes
        rpc.finish_application()
        rpc.close()
    finally:
        monitor.join(timeout=120)
        client.cleanup()
    assert not monitor.is_alive()
    srv_host = endpoint.split("//", 1)[1].rsplit(":", 1)[0]
    assert _port_closed(srv_host, int(endpoint.rsplit(":", 1)[1]))
    events = _history_events(client)
    served = [e for e in events
              if e.type == EventType.SERVING_ENDPOINT_REGISTERED]
    assert served and served[0].payload.url == endpoint
    names = {m.get("name") for e in events if hasattr(e.payload, "metrics")
             for m in e.payload.metrics}
    assert {"SERVING_TOKENS_PER_SEC", "SERVING_TTFT_P50_S"} <= names, names
    # the SIGTERM drain re-registered the endpoint with draining=True: the
    # AM journals every endpoint record
    journal = os.path.join(client.app_dir, C.AM_JOURNAL_FILE)
    with open(journal) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    drains = [r for r in recs if r.get("type") == "endpoint"
              and r.get("url") == endpoint and r.get("draining") is True]
    assert drains, "no draining re-registration reached the AM"


def test_port_trainer_on_a_shard_as_a_worker(tmp_path):
    """--executes a script that runs `python -m tony_tpu_torch.train
    --data`: the spans chain user_process -> trainer_setup, and
    metrics.json holds the GOODPUT_* and TRAIN_* gauges."""
    from tony_tpu.client.tony_client import TonyClient
    from tony_tpu.events.history import read_metrics_file, read_spans_file

    shard = write_token_file(
        str(tmp_path / "tokens.bin"),
        np.random.default_rng(0).integers(0, 256, 4096, dtype=np.int32))
    script = tmp_path / "train_on_shard.py"
    script.write_text(
        "import os, sys\n"
        "os.execv(sys.executable, [sys.executable, '-m', "
        "'tony_tpu_torch.train', '--device', 'cpu', '--config', 'tiny', "
        "'--steps', '6', '--batch-size', '2', '--seq-len', '32', "
        f"'--log-every', '2', '--eval-every', '3', '--data', {shard!r}])\n")
    hist = str(tmp_path / "hist-int")
    client = TonyClient(_fast_conf(tmp_path,
                                   **{"tony.history.intermediate": hist}))
    client.init(["--executes", str(script),
                 "--conf", "tony.worker.instances=1"])
    assert client.run() is True, client.final_message
    history_dir = os.path.join(hist, client.app_id)
    by_name = {}
    for s in read_spans_file(history_dir):
        by_name.setdefault(s["name"], s)
    for name in ("user_process", "trainer_setup", "first_step"):
        assert name in by_name, (name, sorted(by_name))
    assert by_name["trainer_setup"]["parent_id"] \
        == by_name["user_process"]["span_id"]
    assert by_name["trainer_setup"]["trace_id"] == client.app_id
    series = read_metrics_file(history_dir)["worker:0"]
    for gauge in ("GOODPUT_TRAIN_STEP_SECONDS", "GOODPUT_WALL_SECONDS",
                  "GOODPUT_EVAL_SECONDS", "TRAIN_STEP_TIME_MS",
                  "TRAIN_TOKENS_PER_SEC_PER_CHIP"):
        assert gauge in series, (gauge, sorted(series))
