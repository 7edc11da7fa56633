"""Submit an online-serving job for a pretrained Llama checkpoint: the port
of ``examples/llama-serve/serve_submit.py``.

The serving half of the pretrain lifecycle: train with ``python -m
tony_tpu_torch.train --checkpoint-dir D``, then point this submitter at
D. It submits a ``serving`` jobtype through the port's client
(`client/tony_client.py`); the port's AM brings up ``python -m
tony_tpu_torch.serve`` in a container, the endpoint is registered in the
cluster spec and the history, and ``/v1/generate`` answers live traffic
(continuous batching, slot-recycled KV cache).

    python -m tony_tpu_torch.examples.serve_submit --config llama3_1b_proxy \\
        --checkpoint-dir D --quant int8 --slots 4 [--smoke]

``--smoke`` sends one blocking /v1/generate request (prompt 1-8, 16 new
tokens) once the endpoint registers, prints the generated token ids and
``SERVE_SMOKE_OK``, then stops the job: the whole train -> serve handoff
as one command. Without it the job serves until killed. The flags are
the JAX script's plus ``--device`` (default ``cuda``), which the serving
command passes on. The job's site conf (``$TONY_CONF_DIR/tony-site.json``:
the work dir, the AM's intervals, the kernel cache) applies as for any
submission.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))

from tony_tpu_torch import constants as C  # noqa: E402
from tony_tpu_torch.client.tony_client import TonyClient  # noqa: E402
from tony_tpu_torch.conf import TonyConfiguration, keys as K  # noqa: E402
from tony_tpu_torch.rpc.client import ClusterServiceClient  # noqa: E402

# the smoke request
SMOKE_PROMPT = [1, 2, 3, 4, 5, 6, 7, 8]
SMOKE_NEW_TOKENS = 16


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.examples."
                                          "serve_submit")
    parser.add_argument("--config", default="tiny")
    parser.add_argument("--checkpoint-dir", default="",
                        help="a checkpoint dir of `python -m "
                             "tony_tpu_torch.train` (or of the JAX package)")
    parser.add_argument("--quant", default="", choices=("", "int8"))
    parser.add_argument("--quant-cache", action="store_true")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--token-budget", type=int, default=2048)
    parser.add_argument("--queue-depth", type=int, default=64)
    parser.add_argument("--smoke", action="store_true",
                        help="one /v1/generate request, then stop the job")
    parser.add_argument("--device", default="cuda",
                        help="the server's torch device (cuda or cpu)")
    return parser


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    serve_cmd = (f"{sys.executable} -m tony_tpu_torch.serve --config "
                 f"{args.config} --device {args.device}")
    if args.checkpoint_dir:
        serve_cmd += f" --checkpoint-dir {args.checkpoint_dir}"
    if args.quant:
        serve_cmd += f" --quant {args.quant}"
    if args.quant_cache:
        serve_cmd += " --quant-cache"

    conf = TonyConfiguration()
    conf.set(K.SERVING_SLOTS, args.slots, "example")
    conf.set(K.SERVING_TOKEN_BUDGET, args.token_budget, "example")
    conf.set(K.SERVING_QUEUE_DEPTH, args.queue_depth, "example")
    client = TonyClient(conf)
    client.init(["--conf", "tony.serving.instances=1",
                 "--conf", f"tony.serving.command={serve_cmd}"])
    client.submit()
    print(f"submitted {client.app_id}; waiting for the endpoint...")

    monitor = threading.Thread(target=client.monitor, daemon=True)
    monitor.start()
    try:
        endpoint = _wait_endpoint(client)
        print(f"serving endpoint: {endpoint}/v1/generate")
        if not args.smoke:
            print("serving until killed (Ctrl-C to stop)")
            monitor.join()
            return 0 if client.final_status == "SUCCEEDED" else 1
        body = json.dumps({"prompt": SMOKE_PROMPT,
                           "max_new_tokens": SMOKE_NEW_TOKENS}).encode()
        req = urllib.request.Request(
            f"{endpoint}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        resp = json.loads(urllib.request.urlopen(req, timeout=300).read())
        print(f"generated: {resp['tokens']}")
        print("SERVE_SMOKE_OK")
        return 0
    finally:
        client.cleanup()


def _wait_endpoint(client: TonyClient, timeout_sec: float = 600.0) -> str:
    """The serving task's registered URL: the AM's RPC address from its
    `amhostport` file, then the `serving-endpoint` task info."""
    hostport = os.path.join(client.app_dir, C.AM_HOSTPORT_FILE)
    deadline = time.monotonic() + timeout_sec
    while time.monotonic() < deadline and not os.path.exists(hostport):
        time.sleep(0.2)
    if not os.path.exists(hostport):
        raise SystemExit("AM never came up (no amhostport file) — see "
                         f"{client.app_dir}/am.stderr")
    with open(hostport, encoding="utf-8") as f:
        host, _, port = f.read().strip().rpartition(":")
    rpc = ClusterServiceClient(host, int(port), retries=2,
                               retry_sleep_sec=0.2, timeout_sec=5.0,
                               auth_token=client.auth_token)
    try:
        while time.monotonic() < deadline:
            try:
                infos = rpc.get_task_infos()
            except Exception:  # noqa: BLE001 — AM mid-boot
                infos = []
            for info in infos:
                if info.get("name") == "serving-endpoint":
                    return info["url"]
            time.sleep(0.5)
    finally:
        rpc.close()
    raise SystemExit("serving endpoint never registered")


if __name__ == "__main__":
    sys.exit(main())
