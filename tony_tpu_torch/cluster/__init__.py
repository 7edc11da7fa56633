"""Cluster substrate: resource-manager backends that hand out containers.

The port's copy of `tony_tpu/cluster/__init__.py`. Equivalent of the
reference's L0 (YARN RM/NM, consumed through AMRMClientAsync/
NMClientAsync) plus tony-mini's in-process MiniCluster
(tony-mini/src/main/java/com/linkedin/tony/MiniCluster.java:24-84). The
`ClusterBackend` interface is what the ApplicationMaster programs against;
`LocalClusterBackend` implements it with local subprocesses so the full
client→AM→executor→user-process chain runs on one host (dev, tests, one
card); `RemoteClusterBackend` places executors on other hosts over a
NodeTransport (ssh in production, exec for multi-host e2e tests).
"""

from tony_tpu_torch.cluster.backend import ClusterBackend, Container
from tony_tpu_torch.cluster.local import LocalClusterBackend
from tony_tpu_torch.cluster.remote import RemoteClusterBackend


def backend_from_conf(conf, app_id: str) -> ClusterBackend:
    """Build the backend `tony.cluster.backend` names (the AM-side
    equivalent of the reference hard-wiring AMRMClientAsync+NMClientAsync;
    here the substrate is pluggable)."""
    from tony_tpu_torch.conf import keys as K

    kind = conf.get_str(K.CLUSTER_BACKEND, "local") or "local"
    if kind == "local":
        # the TERM→KILL escalation must outlast the executor's
        # user-process grace (tony.task.term-grace-ms) — SIGKILLing the
        # container group mid-grace would cut the trainer's emergency
        # checkpoint short and orphan the own-session user process
        grace = conf.get_time_ms(K.TASK_TERM_GRACE_MS, 15_000) / 1000.0
        # warm executor pool (tony.warmpool.enabled): pre-imported
        # processes launch_container leases instead of cold-spawning —
        # elastic grow and autoscale slots ride the same path for free
        from tony_tpu_torch.cluster import warmpool as wp
        return LocalClusterBackend(app_id=app_id,
                                   stop_grace_sec=grace + 5.0,
                                   warmpool=wp.from_conf(conf))
    if kind == "remote":
        from tony_tpu_torch.cluster.remote import (
            ExecTransport, SSHTransport, parse_nodes,
        )

        nodes = parse_nodes(conf.get_str(K.CLUSTER_NODES, ""),
                            default_root=conf.get_str(K.CLUSTER_NODE_ROOT, ""))
        transport_name = conf.get_str(K.CLUSTER_NODE_TRANSPORT, "ssh")
        if transport_name == "exec":
            transport = ExecTransport()
        elif transport_name == "ssh":
            # ssh nodes share no filesystem with the client: without a
            # staging store the executors would silently run on an EMPTY
            # conf (the app-dir conf path doesn't resolve there) — fail
            # fast at submission instead of far downstream. The exec
            # transport (test double on one host) is exempt.
            if not conf.get_str(K.STAGING_LOCATION, ""):
                raise ValueError(
                    "tony.cluster.node-transport=ssh requires "
                    "tony.staging.location (gs:// bucket or shared dir) "
                    "so off-host executors can localize the conf and "
                    "resources")
            extra = conf.get_str(K.CLUSTER_SSH_OPTS, "")
            transport = SSHTransport(
                ssh_opts=None if not extra else extra.split())
        else:
            raise ValueError(
                f"unknown node transport {transport_name!r} (ssh|exec)")
        return RemoteClusterBackend(nodes, transport, app_id=app_id)
    raise ValueError(f"unknown cluster backend {kind!r} (local|remote)")


__all__ = ["ClusterBackend", "Container", "LocalClusterBackend",
           "RemoteClusterBackend", "backend_from_conf"]
