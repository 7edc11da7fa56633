"""Serving entry point: ``python -m tony_tpu_torch.serve``.

Counterpart of ``python -m tony_tpu.serve``: it builds the model (random
weights from a fixed seed, or a checkpoint's), a
``ContinuousBatchingEngine`` and a ``ServeFrontend``, prints
``SERVING_UP <url>`` on stdout, and on SIGTERM or SIGINT drains in-flight
requests, then stops the frontend and the engine.

The flags are the JAX entry point's, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels).
``--checkpoint-dir`` serves the parameters of the latest step there, as
the port's or the JAX package's Trainer wrote it, loaded onto the serving
device. ``--quant int8`` quantizes the weights (decode products on the
W8A16 kernel), ``--quant-cache`` keeps the KV cache in int8,
``--prefix-sharing on`` (with ``--kv-page-size``/``--kv-pages``) admits
through the paged prefix pool, ``--role prefill --migrate-to URL,...``
hands each request's decode to a ``--role decode`` replica over
``/v1/migrate``. An MoE preset (``--config moe_tiny``, ``mixtral_proxy``)
is served at no-drop capacity, ``capacity_factor = max(cf, n_experts /
top_k)``, so each decode step routes as the training forward would; all
of the flags above work with it.

As a TonY task (``tony.serving.command=<python> -m tony_tpu_torch.serve
...``) it does what the JAX server does toward the AM, each step a no-op
outside the orchestrator:
- reads its knobs from the flags, else the frozen conf
  (``TONY_CONF_PATH``: ``tony.serving.*``), else the JAX defaults; the
  port from ``SERVING_PORT``, the role from ``TONY_SERVING_ROLE``;
- logs structured JSON lines and runs the sampling profiler;
- registers its endpoint with the AM (``register_serving_endpoint``) and
  reports each prefill -> decode handoff (``report_serving_migrated``);
- pushes the engine's gauges, the TTFT attribution, ``serve_request``
  spans and tail-sampled request traces over the metrics RPC;
- on SIGTERM refuses new work, re-registers with ``draining=True``, waits
  up to ``tony.serving.fleet.drain-timeout-ms`` for in-flight requests,
  then exits 0.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from tony_tpu_torch import conf as K
from tony_tpu_torch import constants as C

LOG = logging.getLogger(__name__)

DRAIN_TIMEOUT_S = K.DEFAULTS[K.SERVING_FLEET_DRAIN_TIMEOUT_MS] / 1000.0
INIT_SEED = 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tony_tpu_torch.serve")
    p.add_argument("--config", default="tiny",
                   help="model preset (models/llama.py or models/moe.py "
                        "PRESETS)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda or cpu)")
    p.add_argument("--checkpoint-dir", default="",
                   help="serve the params of the latest checkpoint step "
                        "there")
    p.add_argument("--quant", default="", choices=("", "int8"),
                   help="int8 weight-only decode (models/quant.py)")
    p.add_argument("--quant-cache", action="store_true",
                   help="per-row int8 KV cache for the shared slot cache")
    p.add_argument("--slots", type=int, default=0,
                   help="decode slots (0 = tony.serving.slots)")
    p.add_argument("--token-budget", type=int, default=0,
                   help="per-slot prompt+generation budget "
                        "(0 = tony.serving.token-budget, capped at "
                        "config.max_seq)")
    p.add_argument("--queue-depth", type=int, default=0,
                   help="bounded pending-request queue "
                        "(0 = tony.serving.queue-depth)")
    p.add_argument("--port", type=int, default=-1,
                   help="HTTP port (-1 = tony.serving.port, else the "
                        "executor-assigned $SERVING_PORT, else ephemeral)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="eos token id latching a row (-1 = none)")
    p.add_argument("--weights-generation", type=int, default=0,
                   help="weights rollout epoch this replica serves "
                        "(0 = $TONY_SERVING_WEIGHTS_GENERATION, else "
                        "the AM stamps its current epoch)")
    p.add_argument("--role", default="",
                   choices=("", "both", "prefill", "decode"),
                   help="disaggregated serving role ('' = "
                        "$TONY_SERVING_ROLE, else tony.serving.role)")
    p.add_argument("--migrate-to", default="",
                   help="comma-separated decode-replica base URLs a "
                        "prefill replica hands decode work to "
                        "('' = tony.serving.migrate-to)")
    p.add_argument("--prefix-sharing", default="",
                   choices=("", "on", "off"),
                   help="paged prefix-shared KV admission "
                        "('' = tony.serving.kv.prefix-sharing)")
    p.add_argument("--kv-page-size", type=int, default=0,
                   help="tokens per KV page "
                        "(0 = tony.serving.kv.page-size)")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="device page-pool size incl. scratch "
                        "(0 = tony.serving.kv.pages, 0 = one full prefix "
                        "per slot)")
    return p


def _load_model(args, device):
    import torch

    from tony_tpu_torch.models.llama import get_config, llama_init
    from tony_tpu_torch.models.moe import (
        get_moe_config, is_moe_preset, moe_init,
    )

    if is_moe_preset(args.config):
        base = get_moe_config(args.config)
        # no-drop capacity: a decode step routes as the training forward
        config = get_moe_config(args.config, capacity_factor=max(
            base.capacity_factor, base.n_experts / base.top_k))
        init = moe_init
    else:
        config = get_config(args.config)
        init = llama_init
    if args.checkpoint_dir:
        from tony_tpu_torch.models.convert import empty_params
        from tony_tpu_torch.train.checkpoint import (
            latest_step, restore_params,
        )
        step = latest_step(args.checkpoint_dir)
        if step is None:
            raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
        # filled leaf by leaf on the serving device, whatever optimizer
        # state lies beside the params (a checkpoint of either package)
        params = restore_params(args.checkpoint_dir, step,
                                empty_params(config, device))
        LOG.info("restored checkpoint step %d from %s", step,
                 args.checkpoint_dir)
    else:
        generator = torch.Generator(device=device).manual_seed(INIT_SEED)
        with torch.inference_mode():
            params = init(config, generator)
    if args.quant == "int8":
        from tony_tpu_torch.models.quant import quantize_params
        with torch.inference_mode():
            params = quantize_params(params)
        LOG.info("int8 weight-only params")
    return params, config


def current_host() -> str:
    """Best-effort resolvable hostname for the SERVING_UP url."""
    host = socket.gethostname()
    try:
        socket.gethostbyname(host)
        return host
    except OSError:
        return "127.0.0.1"


def _task_id(env) -> str:
    return f"{env.get(C.JOB_NAME, 'serving')}:{env.get(C.TASK_INDEX, '0')}"


def _register_endpoint(url: str, env, weights_generation: int = 0,
                       draining: bool = False, role: str = "") -> None:
    """Tell the AM where this server listens, or (draining=True) that it
    is connection-draining, so the fleet router stops new sends. No-op
    outside the orchestrator; a failure is logged, never raised."""
    host, port = env.get(C.AM_HOST), env.get(C.AM_PORT)
    if not host or not port:
        return
    from tony_tpu_torch.rpc.client import ClusterServiceClient
    from tony_tpu_torch.security.tokens import TOKEN_ENV
    task_id = _task_id(env)
    token = env.get(TOKEN_ENV) or None
    client = ClusterServiceClient(host, int(port), auth_token=token,
                                  task_auth_id=task_id if token else None,
                                  # the drain announcement runs inside the
                                  # TERM grace window: one fast try
                                  retries=1 if draining else 10)
    try:
        client.register_serving_endpoint(
            task_id, url, weights_generation=weights_generation,
            draining=draining, role=role)
        LOG.info("registered serving endpoint %s with the AM%s", url,
                 " (draining)" if draining else "")
    except Exception:  # noqa: BLE001 — registration is observability
        LOG.exception("failed to register serving endpoint")
    finally:
        client.close()


def _migrated_reporter(env) -> Optional[Callable[[str], None]]:
    """Hook(target_url) reporting each prefill -> decode handoff to the
    AM on a daemon thread (the relay never waits); None outside the
    orchestrator."""
    host, port = env.get(C.AM_HOST), env.get(C.AM_PORT)
    if not host or not port:
        return None
    from tony_tpu_torch.security.tokens import TOKEN_ENV
    task_id = _task_id(env)
    token = env.get(TOKEN_ENV) or None

    def report(target_url: str) -> None:
        def _send() -> None:
            from tony_tpu_torch.rpc.client import ClusterServiceClient
            client = ClusterServiceClient(
                host, int(port), auth_token=token,
                task_auth_id=task_id if token else None, retries=1)
            try:
                client.report_serving_migrated(task_id, target_url)
            except Exception:  # noqa: BLE001 — observability only
                LOG.debug("report_serving_migrated failed", exc_info=True)
            finally:
                client.close()
        threading.Thread(target=_send, name="migrate-report",
                         daemon=True).start()

    return report


def _request_span_recorder(engine, env):
    """The SpanRecorder of this task; when a trace context was rendered,
    each finished request also becomes a `serve_request` span."""
    from tony_tpu_torch.observability.trace import SpanRecorder
    recorder = SpanRecorder.from_env(
        env,
        task_id=(f"{env.get(C.JOB_NAME, '')}:{env.get(C.TASK_INDEX, '0')}"
                 if env.get(C.JOB_NAME) else ""),
        attempt=int(env.get(C.TASK_ATTEMPT, "0") or 0))
    if not recorder.enabled:
        return recorder

    def _record(handle) -> None:
        dur_s = max(0.0, (handle.finished_at or 0) - handle.submitted_at)
        now_ms = int(time.time() * 1000)
        attrs = {"request_id": handle.request_id,
                 "tokens": len(handle.tokens),
                 "finish_reason": handle.finish_reason or ""}
        if handle.trace_ctx is not None:
            attrs["request_trace_id"] = handle.trace_ctx.trace_id
        for key, value in (("queue_wait_ms", handle.queue_wait_s),
                           ("prefill_ms", handle.prefill_s),
                           ("decode_ms", handle.decode_s)):
            if value is not None:
                attrs[key] = round(value * 1000.0, 3)
        recorder.record_complete("serve_request",
                                 now_ms - int(dur_s * 1000), now_ms,
                                 attrs=attrs)

    engine.on_request_finished = _record
    return recorder


@dataclass
class Server:
    """A running server: the engine loop, the HTTP frontend, and what
    reports them (`reporter` is set by `main`)."""
    engine: object
    frontend: object
    url: str
    collector: object = None
    recorder: object = None
    role: str = "both"
    weights_generation: int = 0
    drain_timeout: float = DRAIN_TIMEOUT_S
    reporter: object = None

    def stop(self, drain_timeout: Optional[float] = None,
             on_drain: Optional[Callable[[], None]] = None) -> None:
        """Refuse new work (then call `on_drain`, the AM announcement),
        let in-flight requests finish inside `drain_timeout` (default:
        the configured one), then stop the reporter, the frontend and the
        engine."""
        if drain_timeout is None:
            drain_timeout = self.drain_timeout
        self.engine.begin_drain()
        if on_drain is not None:
            on_drain()
        if drain_timeout:
            if self.engine.wait_drained(drain_timeout):
                # let handler threads flush their final chunks
                time.sleep(0.2)
            else:
                LOG.warning("drain window (%.1fs) expired with work still "
                            "in flight", drain_timeout)
        if self.reporter is not None:
            self.reporter.close()
        self.frontend.stop()
        self.engine.stop()


def build_server(args, env=None, conf=None) -> Server:
    """Model, engine (with request tracing) and frontend from parsed
    flags, the frozen conf (`conf`, else the one `TONY_CONF_PATH` names)
    and the task environment, started. The one place `main()` and
    `chip_smoke.py` build a server."""
    from tony_tpu_torch.conf import Configuration
    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.observability.reqtrace import (
        ReqTraceCollector, TailSampler,
    )
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tony_tpu_torch.serve.frontend import (
        ServeFrontend, install_engine_tracing,
    )

    env = os.environ if env is None else env
    conf = Configuration.from_env(env) if conf is None else conf
    device = resolve_device(args.device)
    params, config = _load_model(args, device)
    # the budget is capped at the model's max_seq, flag or conf
    token_budget = min(
        args.token_budget or conf.get_int(K.SERVING_TOKEN_BUDGET, 2048),
        config.max_seq)
    port = args.port
    if port < 0:
        port = conf.get_int(K.SERVING_PORT, 0) \
            or int(env.get(C.SERVING_PORT, "0") or 0)
    weights_generation = args.weights_generation \
        or int(env.get(C.SERVING_WEIGHTS_GENERATION, "0") or 0)
    # flag > $TONY_SERVING_ROLE > tony.serving.role
    role = args.role or env.get(C.SERVING_ROLE, "") \
        or conf.get(K.SERVING_ROLE, "both") or "both"
    if args.prefix_sharing:
        prefix_sharing = args.prefix_sharing == "on"
    else:
        prefix_sharing = conf.get_bool(K.SERVING_KV_PREFIX_SHARING, False)
    migrate_to = args.migrate_to or conf.get(K.SERVING_MIGRATE_TO, "") or ""
    migrate_targets = [u.strip() for u in migrate_to.split(",")
                       if u.strip()]
    engine = ContinuousBatchingEngine(
        params, config, n_slots=args.slots or conf.get_int(K.SERVING_SLOTS,
                                                           4),
        token_budget=token_budget,
        queue_depth=args.queue_depth or conf.get_int(K.SERVING_QUEUE_DEPTH,
                                                     64),
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos_id if args.eos_id >= 0 else None,
        quant_cache=args.quant_cache,
        weights_generation=weights_generation,
        prefix_sharing=prefix_sharing,
        kv_page_size=args.kv_page_size
        or conf.get_int(K.SERVING_KV_PAGE_SIZE, 16),
        kv_pages=args.kv_pages or conf.get_int(K.SERVING_KV_PAGES, 0),
        role=role)
    recorder = _request_span_recorder(engine, env)
    # tail-sampled request traces: /v1/traces and the metrics push
    collector = ReqTraceCollector(
        process=(f"{env.get(C.JOB_NAME, role or 'serving')}"
                 f":{env.get(C.TASK_INDEX, str(os.getpid()))}"),
        sampler=TailSampler(
            slow_threshold_ms=conf.get_time_ms(
                K.SERVING_TRACE_SLOW_THRESHOLD_MS, 1000),
            slowest_k=conf.get_int(K.SERVING_TRACE_SLOWEST_K, 8),
            window_ms=conf.get_time_ms(K.SERVING_TRACE_WINDOW_MS, 60_000)),
        max_traces=conf.get_int(K.SERVING_TRACE_MAX_TRACES, 256),
        enabled=conf.get_bool(K.SERVING_TRACE_ENABLED, True))
    install_engine_tracing(engine, collector)
    engine.start()
    frontend = ServeFrontend(engine, port=port, host=args.host,
                             migrate_targets=migrate_targets,
                             on_migrated=_migrated_reporter(env),
                             collector=collector)
    frontend.start()
    host = args.host if args.host not in ("", "0.0.0.0") else current_host()
    return Server(engine, frontend, f"http://{host}:{frontend.port}",
                  collector=collector, recorder=recorder, role=role,
                  weights_generation=weights_generation,
                  drain_timeout=conf.get_time_ms(
                      K.SERVING_FLEET_DRAIN_TIMEOUT_MS, 10_000) / 1000.0)


def main(argv=None) -> int:
    from tony_tpu_torch.conf import Configuration
    from tony_tpu_torch.train.metrics import ServingMetricsReporter

    args = build_arg_parser().parse_args(argv)
    env = os.environ
    conf = Configuration.from_env(env)
    server = build_server(args, env=env, conf=conf)
    # log-ok: greppable bring-up marker on raw stdout
    print(f"SERVING_UP {server.url}", flush=True)
    _register_endpoint(server.url, env,
                       weights_generation=server.weights_generation,
                       role=server.role)
    engine, collector, recorder = (server.engine, server.collector,
                                   server.recorder)

    def _sample_metrics() -> list:
        # the engine's gauges and the TTFT attribution
        # (SERVING_TTFT_ATTR_<component>_MS_P50/P95) on one push
        out = list(engine.metrics())
        for key, value in collector.attribution.gauges().items():
            out.append({"name": f"SERVING_{key.upper()}",
                        "value": float(value)})
        return out

    server.reporter = ServingMetricsReporter(
        _sample_metrics,
        interval_sec=conf.get_time_ms(K.TASK_METRICS_INTERVAL_MS,
                                      5000) / 1000.0,
        span_source=recorder.drain if recorder.enabled else None,
        trace_source=collector.drain if collector.enabled else None)
    server.reporter.start()

    stop = threading.Event()

    def _on_signal(signum, frame):
        LOG.info("signal %d — shutting down serving", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        stop.wait()
    finally:
        # connection draining: refuse new work, announce the drain (the
        # router stops new sends), finish in-flight requests inside the
        # drain window, then tear down
        server.stop(on_drain=lambda: _register_endpoint(
            server.url, env, weights_generation=server.weights_generation,
            draining=True, role=server.role))
        LOG.info("serving stopped cleanly")
    return 0


if __name__ == "__main__":
    from tony_tpu_torch.observability.profiler import (
        install_task_observability,
    )
    install_task_observability("serve")
    sys.exit(main())
