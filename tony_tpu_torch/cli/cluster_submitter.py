"""ClusterSubmitter: production submit path.

Equivalent of cli/ClusterSubmitter.java:41-94 — the reference uploaded its
own fat jar to HDFS and installed a kill-on-exit shutdown hook before
delegating to TonyClient. Here the framework ships with the interpreter, so
"upload self" reduces to recording the package location in the conf; the
shutdown hook semantics (SIGINT/SIGTERM kills the running app) are kept.
"""

from __future__ import annotations

import logging
import os
import signal

from tony_tpu_torch.client.tony_client import TonyClient
from tony_tpu_torch.conf import keys as K

LOG = logging.getLogger(__name__)

DEFAULT_WORKDIR = os.path.expanduser("~/.tony_tpu/apps")


def submit(argv: list[str]) -> int:
    client = TonyClient()
    client.init(argv)
    if not client.conf.get_str(K.CLUSTER_WORKDIR):
        client.conf.set(K.CLUSTER_WORKDIR, DEFAULT_WORKDIR, "submitter")

    # kill-on-exit shutdown hook (ClusterSubmitter.java:63-70 equivalent)
    def _on_signal(signum, frame):
        LOG.warning("signal %d — killing application", signum)
        client.kill()
        raise SystemExit(130)

    old_int = signal.signal(signal.SIGINT, _on_signal)
    old_term = signal.signal(signal.SIGTERM, _on_signal)
    try:
        ok = client.run()
    finally:
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)
    return 0 if ok else -1
