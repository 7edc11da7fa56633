"""History portal: web UI + history-dir lifecycle daemons.

The port's copy of `tony_tpu/portal/`: the same daemons and routes over
the same history tree, importing nothing of torch, jax or grpc (grpc
loads only when a page proxies a RUNNING job's AM). Equivalent of the
reference's tony-portal Play application:
`Requirements` (dir bring-up) → `ensure_history_dirs`, `CacheWrapper` →
`PortalCache`, `HistoryFileMover`/`HistoryFilePurger` → `mover`/`purger`,
and the four page controllers (routes /, /config/:jobId, /jobs/:jobId,
/logs/:jobId — tony-portal/conf/routes:1-5) → `server.PortalServer`, which
also exposes the same data as a JSON API.
"""

from tony_tpu_torch.portal.cache import PortalCache
from tony_tpu_torch.portal.mover import HistoryFileMover, ensure_history_dirs
from tony_tpu_torch.portal.purger import HistoryFilePurger
from tony_tpu_torch.portal.server import PortalServer

__all__ = [
    "PortalCache",
    "HistoryFileMover",
    "HistoryFilePurger",
    "PortalServer",
    "ensure_history_dirs",
]
