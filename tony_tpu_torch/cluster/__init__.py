"""Cluster substrate: resource-manager backends that hand out containers.

The port's copy of `tony_tpu/cluster/__init__.py`. The `ClusterBackend`
interface is what the ApplicationMaster programs against;
`LocalClusterBackend` implements it with local subprocesses, so the whole
client → AM → executor → user-process chain runs on one host (dev, tests,
one card). The remote backend (executors placed on other hosts over ssh)
and the warm executor pool are not in the port yet: `backend_from_conf`
refuses a configuration that asks for either, naming the key.
"""

from tony_tpu_torch.cluster.backend import ClusterBackend, Container
from tony_tpu_torch.cluster.local import LocalClusterBackend


def backend_from_conf(conf, app_id: str) -> ClusterBackend:
    """Build the backend `tony.cluster.backend` names."""
    from tony_tpu_torch.conf import keys as K

    kind = conf.get_str(K.CLUSTER_BACKEND, "local") or "local"
    if kind == "remote":
        raise ValueError(
            f"{K.CLUSTER_BACKEND}=remote is not supported by the port yet "
            "(only the local backend is)")
    if kind != "local":
        raise ValueError(f"unknown cluster backend {kind!r} (local|remote)")
    if conf.get_bool(K.WARMPOOL_ENABLED, False):
        raise ValueError(
            f"{K.WARMPOOL_ENABLED}=true is not supported by the port yet "
            "(no warm executor pool)")
    # the TERM→KILL escalation must outlast the executor's user-process
    # grace (tony.task.term-grace-ms) — SIGKILLing the container group
    # mid-grace would cut the trainer's emergency checkpoint short and
    # orphan the own-session user process
    grace = conf.get_time_ms(K.TASK_TERM_GRACE_MS, 15_000) / 1000.0
    return LocalClusterBackend(app_id=app_id, stop_grace_sec=grace + 5.0)


__all__ = ["ClusterBackend", "Container", "LocalClusterBackend",
           "backend_from_conf"]
