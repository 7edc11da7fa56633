"""A task that pushes one gauge, TEST_GAUGE, over the AM's metrics RPC on
a fixed schedule: 1.0 for ALERT_LOW_S seconds, 9.0 for ALERT_HIGH_S, then
1.0 again. A threshold rule on TEST_GAUGE > 5 sees one fault that
clears: pending -> firing -> resolved. Imports nothing of either
package's compute plane, so it runs under either AM's executor."""
import os
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.rpc.client import MetricsServiceClient
from tony_tpu_torch.security.tokens import TOKEN_ENV

low_s = float(os.environ.get("ALERT_LOW_S", "1.0"))
high_s = float(os.environ.get("ALERT_HIGH_S", "1.5"))
job = os.environ[C.JOB_NAME]
index = int(os.environ[C.TASK_INDEX])
token = os.environ.get(TOKEN_ENV) or None
client = MetricsServiceClient(
    os.environ[C.AM_HOST],
    int(os.environ.get(C.METRICS_RPC_PORT) or os.environ[C.AM_PORT]),
    auth_token=token, task_auth_id=f"{job}:{index}" if token else None)
for value, seconds in ((1.0, low_s), (9.0, high_s), (1.0, low_s)):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        client.call("update_metrics",
                    {"task_type": job, "index": index,
                     "metrics": [{"name": "TEST_GAUGE", "value": value}]},
                    retries=1, timeout_sec=5.0, wait_for_ready=False)
        time.sleep(0.1)
client.close()
