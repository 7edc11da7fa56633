"""LocalSubmitter: ephemeral local run.

Equivalent of cli/LocalSubmitter.java:33-71 — the reference spun a 2-NM
MiniCluster, wrote its confs to a temp dir, and ran a real job against it.
Here the local backend IS the mini cluster, so this submitter just points
the workdir at a temp dir and removes it afterwards.
"""

from __future__ import annotations

import logging
import shutil
import tempfile

from tony_tpu_torch.client.tony_client import TonyClient
from tony_tpu_torch.conf import keys as K

LOG = logging.getLogger(__name__)


def submit(argv: list[str], keep_workdir: bool = False) -> int:
    workdir = tempfile.mkdtemp(prefix="tony-local-")
    client = TonyClient()
    client.init(argv)
    client.conf.set(K.CLUSTER_WORKDIR, workdir, "local-submitter")
    try:
        ok = client.run()
        LOG.info("local run %s", "succeeded" if ok else "FAILED")
        return 0 if ok else -1
    finally:
        if not keep_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
