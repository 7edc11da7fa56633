"""A serving replica without a model, for autoscaler jobs: it listens on
an HTTP port, registers that endpoint with the AM as the servers of both
packages do, and pushes the serving gauges the autoscaler folds every
0.2 s (replica 0 a queue of STUB_QUEUE_DEPTH, every replica full slots)
until SIGTERM, then exits 0."""
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tony_tpu_torch import constants as C
from tony_tpu_torch.rpc.client import MetricsServiceClient
from tony_tpu_torch.security.tokens import TOKEN_ENV
from tony_tpu_torch.serve.__main__ import _register_endpoint


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{httpd.server_address[1]}"
print(f"SERVING_UP {url}", flush=True)
_register_endpoint(url, os.environ)

stop = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: stop.set())
job = os.environ[C.JOB_NAME]
index = int(os.environ[C.TASK_INDEX])
token = os.environ.get(TOKEN_ENV) or None
client = MetricsServiceClient(
    os.environ[C.AM_HOST],
    int(os.environ.get(C.METRICS_RPC_PORT) or os.environ[C.AM_PORT]),
    auth_token=token, task_auth_id=f"{job}:{index}" if token else None)
depth = float(os.environ.get("STUB_QUEUE_DEPTH", "40")) if index == 0 \
    else 0.0
gauges = [{"name": "SERVING_QUEUE_DEPTH", "value": depth},
          {"name": "SERVING_SLOT_OCCUPANCY_PCT", "value": 100.0},
          {"name": "SERVING_TTFT_P95_S", "value": 0.25},
          {"name": "SERVING_SUBMITTED_TOTAL", "value": 10.0},
          {"name": "SERVING_REJECTED_TOTAL", "value": 0.0}]
while not stop.is_set():
    try:
        client.call("update_metrics", {"task_type": job, "index": index,
                                       "metrics": gauges},
                    retries=1, timeout_sec=5.0, wait_for_ready=False)
    except Exception:  # noqa: BLE001 — the AM may be stopping
        pass
    stop.wait(0.2)
client.close()
httpd.shutdown()
time.sleep(0.05)
