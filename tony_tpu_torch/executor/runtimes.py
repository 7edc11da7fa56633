"""Per-framework rendezvous env: the port's copy of
`tony_tpu/executor/runtimes.py`.

From the gang's cluster spec, a task's identity and the frozen conf, each
framework's bootstrap env, as the JAX package's executor renders it:

- tensorflow: ``TF_CONFIG`` ({"cluster": spec, "task": {type, index}});
- pytorch: ``INIT_METHOD=tcp://<worker 0>``, ``RANK``, ``WORLD`` and
  ``MASTER_ADDR``/``MASTER_PORT`` (what the port's
  `parallel/distributed.py` reads);
- mxnet: ``DMLC_*`` around the scheduler;
- horovod: nothing (its launcher owns the rendezvous);
- jax: the coordinator (global process 0's address, or its host with
  ``tony.tpu.coordinator-port``), the process id and count, the slice id
  and count from ``tony.tpu.num-slices``, and the mesh shape and axes
  (which the port's rendezvous also reads).

Every framework also gets ``CLUSTER_SPEC``; a serving task gets the
``SERVING_PORT`` it registered; every task gets ``TONY_JAX_CACHE_DIR``
from ``tony.executor.jax-cache-dir`` (the port builds its kernels there).
The renderers are pure: (cluster_spec, job_name, index, conf) -> env.
"""

from __future__ import annotations

import json

from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf import TonyConfiguration

ClusterSpec = dict[str, list[str]]  # {jobtype: ["host:port", ...]}


def global_task_order(cluster_spec: ClusterSpec) -> list[tuple[str, int]]:
    """Canonical total order over tasks for rank/process-id assignment:
    chief first, then jobtypes alphabetically, then by index. Deterministic
    on every host because the spec is identical everywhere (the AM broadcast
    the same JSON to all executors)."""
    jobs = sorted(cluster_spec.keys(),
                  key=lambda j: (j != C.CHIEF_JOB_NAME, j))
    return [(job, i) for job in jobs for i in range(len(cluster_spec[job]))]


def global_rank(cluster_spec: ClusterSpec, job_name: str, index: int) -> int:
    return global_task_order(cluster_spec).index((job_name, index))


def _tf_env(cluster_spec: ClusterSpec, job_name: str, index: int,
            conf: TonyConfiguration) -> dict[str, str]:
    tf_config = {
        "cluster": cluster_spec,
        "task": {"type": job_name, "index": index},
    }
    return {
        C.CLUSTER_SPEC: json.dumps(cluster_spec),
        C.TF_CONFIG: json.dumps(tf_config),
    }


def _pytorch_env(cluster_spec: ClusterSpec, job_name: str, index: int,
                 conf: TonyConfiguration) -> dict[str, str]:
    workers = cluster_spec.get(C.WORKER_JOB_NAME)
    if not workers:
        raise ValueError("pytorch runtime requires a 'worker' jobtype "
                         "in the cluster spec")
    host0, _, port0 = workers[0].rpartition(":")
    env = {
        C.INIT_METHOD: f"tcp://{workers[0]}",
        C.RANK: str(index if job_name == C.WORKER_JOB_NAME
                    else global_rank(cluster_spec, job_name, index)),
        C.WORLD: str(len(workers)),
        C.MASTER_ADDR: host0,
        C.MASTER_PORT: port0,
    }
    return env


def _mxnet_env(cluster_spec: ClusterSpec, job_name: str, index: int,
               conf: TonyConfiguration) -> dict[str, str]:
    schedulers = cluster_spec.get(C.SCHEDULER_JOB_NAME)
    if not schedulers:
        raise ValueError("mxnet runtime requires a 'scheduler' jobtype")
    host, _, port = schedulers[0].rpartition(":")
    role = {C.SCHEDULER_JOB_NAME: "scheduler",
            C.SERVER_JOB_NAME: "server"}.get(job_name, "worker")
    return {
        C.DMLC_ROLE: role,
        C.DMLC_PS_ROOT_URI: host,
        C.DMLC_PS_ROOT_PORT: port,
        C.DMLC_NUM_SERVER: str(len(cluster_spec.get(C.SERVER_JOB_NAME, []))),
        C.DMLC_NUM_WORKER: str(len(cluster_spec.get(C.WORKER_JOB_NAME, []))),
    }


def _horovod_env(cluster_spec: ClusterSpec, job_name: str, index: int,
                 conf: TonyConfiguration) -> dict[str, str]:
    # horovodrun / the user's launcher handles its own rendezvous
    # (TaskExecutor.java:201-204 deliberately sets nothing)
    return {}


def _jax_env(cluster_spec: ClusterSpec, job_name: str, index: int,
             conf: TonyConfiguration) -> dict[str, str]:
    order = global_task_order(cluster_spec)
    process_id = order.index((job_name, index))
    num_processes = len(order)
    coord_job, coord_idx = order[0]
    coordinator = cluster_spec[coord_job][coord_idx]
    # explicit coordinator port override (tony.tpu.coordinator-port) replaces
    # the port component of process 0's registered address
    coord_port = conf.get_int(K.TPU_COORDINATOR_PORT, 0)
    if coord_port > 0:
        coordinator = f"{coordinator.rpartition(':')[0]}:{coord_port}"
    num_slices = max(1, conf.get_int(K.TPU_NUM_SLICES, 1))
    # ceil-div so the last slice absorbs the remainder and slice ids stay
    # in [0, num_slices) even when processes don't divide evenly
    per_slice = max(1, -(-num_processes // num_slices))
    env = {
        C.JAX_COORDINATOR_ADDRESS: coordinator,
        C.JAX_PROCESS_ID: str(process_id),
        C.JAX_NUM_PROCESSES: str(num_processes),
        C.TPU_SLICE_ID: str(process_id // per_slice),
        C.TPU_NUM_SLICES: str(num_slices),
    }
    mesh_shape = conf.get_str(K.TPU_MESH_SHAPE)
    mesh_axes = conf.get_str(K.TPU_MESH_AXES)
    if mesh_shape:
        env[C.TPU_MESH_SHAPE] = mesh_shape
    if mesh_axes:
        env[C.TPU_MESH_AXES] = mesh_axes
    return env


_RENDERERS = {
    C.FRAMEWORK_TENSORFLOW: _tf_env,
    C.FRAMEWORK_PYTORCH: _pytorch_env,
    C.FRAMEWORK_MXNET: _mxnet_env,
    C.FRAMEWORK_HOROVOD: _horovod_env,
    C.FRAMEWORK_JAX: _jax_env,
}


def render_framework_env(framework: str, cluster_spec: ClusterSpec,
                         job_name: str, index: int,
                         conf: TonyConfiguration) -> dict[str, str]:
    """Dispatch on tony.application.framework; ValueError for another."""
    try:
        renderer = _RENDERERS[framework.lower()]
    except KeyError:
        raise ValueError(
            f"unsupported framework {framework!r}; expected one of "
            f"{sorted(_RENDERERS)}") from None
    env = renderer(cluster_spec, job_name, index, conf)
    # CLUSTER_SPEC is universal here (the reference rendered it TF-only,
    # TaskExecutor.java:161-167): role-based gangs (ray-style head/worker)
    # need gang visibility regardless of framework.
    env.setdefault(C.CLUSTER_SPEC, json.dumps(cluster_spec))
    # serving tasks (serve/ subsystem) bind the port THIS task registered
    # at the rendezvous barrier, so the endpoint the AM gossips in the
    # cluster spec is the live HTTP server — framework-independent, like
    # CLUSTER_SPEC above
    if job_name == C.SERVING_JOB_NAME:
        entries = cluster_spec.get(C.SERVING_JOB_NAME, [])
        if 0 <= index < len(entries):
            env.setdefault(C.SERVING_PORT,
                           entries[index].rpartition(":")[2])
    # the persistent build cache (tony.executor.jax-cache-dir) lands in
    # EVERY framework's user env: the port's trainer and server build
    # their kernels under it (utils/compilecache.py), so the Nth identical
    # task skips the cold nvcc build
    jax_cache_dir = conf.get_str(K.EXECUTOR_JAX_CACHE_DIR, "")
    if jax_cache_dir:
        env.setdefault(C.JAX_CACHE_DIR, jax_cache_dir)
    return env
