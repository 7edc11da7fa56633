"""Application Master: per-job controller.

Equivalent of the reference's ApplicationMaster.java (tony-core): registers
with the cluster backend, serves the control-plane RPC, gang-schedules
containers through the TaskScheduler, monitors heartbeats, retries the whole
session on failure, and writes the event history.
"""

from tony_tpu_torch.am.application_master import ApplicationMaster

__all__ = ["ApplicationMaster"]
