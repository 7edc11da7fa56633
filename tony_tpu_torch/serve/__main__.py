"""Serving entry point: ``python -m tony_tpu_torch.serve``.

Counterpart of ``python -m tony_tpu.serve`` as a standalone server: it
builds the model (random weights from a fixed seed, or a checkpoint's), a
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
``/v1/migrate``. MoE presets raise NotImplementedError (the port's models
slice). Orchestrator wiring (AM endpoint registration, the metrics
reporter, the profiler, the frozen conf file and its ``tony.serving.*``
fallbacks) lives in ``tony_tpu``, which the port does not import; here
the knobs come from the flags, with the JAX package's defaults, and from
the ``SERVING_PORT``, ``TONY_SERVING_ROLE`` and
``TONY_SERVING_WEIGHTS_GENERATION`` environment variables.
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
from typing import Optional

LOG = logging.getLogger(__name__)

DEFAULT_SLOTS = 4
DEFAULT_QUEUE_DEPTH = 64
DEFAULT_TOKEN_BUDGET = 2048
DEFAULT_KV_PAGE_SIZE = 16
DRAIN_TIMEOUT_S = 10.0
INIT_SEED = 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tony_tpu_torch.serve")
    p.add_argument("--config", default="tiny",
                   help="model preset (models/llama.py PRESETS)")
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
                   help=f"decode slots (0 = {DEFAULT_SLOTS})")
    p.add_argument("--token-budget", type=int, default=0,
                   help=f"per-slot prompt+generation budget (0 = "
                        f"{DEFAULT_TOKEN_BUDGET}, capped at "
                        f"config.max_seq)")
    p.add_argument("--queue-depth", type=int, default=0,
                   help=f"bounded pending-request queue "
                        f"(0 = {DEFAULT_QUEUE_DEPTH})")
    p.add_argument("--port", type=int, default=-1,
                   help="HTTP port (-1 = $SERVING_PORT, else ephemeral)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="eos token id latching a row (-1 = none)")
    p.add_argument("--weights-generation", type=int, default=0,
                   help="weights rollout epoch this replica serves "
                        "(0 = $TONY_SERVING_WEIGHTS_GENERATION)")
    p.add_argument("--role", default="",
                   choices=("", "both", "prefill", "decode"),
                   help="disaggregated serving role ('' = "
                        "$TONY_SERVING_ROLE, else both)")
    p.add_argument("--migrate-to", default="",
                   help="comma-separated decode-replica base URLs a "
                        "prefill replica hands decode work to")
    p.add_argument("--prefix-sharing", default="",
                   choices=("", "on", "off"),
                   help="paged prefix-shared KV admission ('' = off)")
    p.add_argument("--kv-page-size", type=int, default=0,
                   help=f"tokens per KV page (0 = {DEFAULT_KV_PAGE_SIZE})")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="device page-pool size incl. scratch (0 = one full "
                        "prefix per slot)")
    return p


def _load_model(args, device):
    import torch

    from tony_tpu_torch.models.llama import get_config, llama_init

    config = get_config(args.config)
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
            params = llama_init(config, generator)
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


@dataclass
class Server:
    """A running server: the engine loop and the HTTP frontend."""
    engine: object
    frontend: object
    url: str

    def stop(self, drain_timeout: Optional[float] = DRAIN_TIMEOUT_S) -> None:
        """Refuse new work, let in-flight requests finish inside
        `drain_timeout`, then stop the frontend and the engine."""
        self.engine.begin_drain()
        if drain_timeout:
            if self.engine.wait_drained(drain_timeout):
                # let handler threads flush their final chunks
                time.sleep(0.2)
            else:
                LOG.warning("drain window (%.1fs) expired with work still "
                            "in flight", drain_timeout)
        self.frontend.stop()
        self.engine.stop()


def build_server(args) -> Server:
    """Model, engine and frontend from parsed flags, started. The one
    place `main()` and `chip_smoke.py` build a server."""
    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tony_tpu_torch.serve.frontend import ServeFrontend

    device = resolve_device(args.device)
    params, config = _load_model(args, device)
    token_budget = min(args.token_budget or DEFAULT_TOKEN_BUDGET,
                       config.max_seq)
    port = args.port
    if port < 0:
        port = int(os.environ.get("SERVING_PORT", "0") or 0)
    weights_generation = args.weights_generation or int(
        os.environ.get("TONY_SERVING_WEIGHTS_GENERATION", "0") or 0)
    role = args.role or os.environ.get("TONY_SERVING_ROLE", "") or "both"
    migrate_targets = [u.strip() for u in args.migrate_to.split(",")
                       if u.strip()]
    engine = ContinuousBatchingEngine(
        params, config, n_slots=args.slots or DEFAULT_SLOTS,
        token_budget=token_budget,
        queue_depth=args.queue_depth or DEFAULT_QUEUE_DEPTH,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=args.eos_id if args.eos_id >= 0 else None,
        quant_cache=args.quant_cache,
        weights_generation=weights_generation,
        prefix_sharing=args.prefix_sharing == "on",
        kv_page_size=args.kv_page_size or DEFAULT_KV_PAGE_SIZE,
        kv_pages=args.kv_pages, role=role)
    engine.start()
    frontend = ServeFrontend(engine, port=port, host=args.host,
                             migrate_targets=migrate_targets)
    frontend.start()
    host = args.host if args.host not in ("", "0.0.0.0") else current_host()
    return Server(engine, frontend, f"http://{host}:{frontend.port}")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    args = build_arg_parser().parse_args(argv)
    server = build_server(args)
    # log-ok: greppable bring-up marker on raw stdout
    print(f"SERVING_UP {server.url}", flush=True)

    stop = threading.Event()

    def _on_signal(signum, frame):
        LOG.info("signal %d — shutting down serving", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        stop.wait()
    finally:
        server.stop()
        LOG.info("serving stopped cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
