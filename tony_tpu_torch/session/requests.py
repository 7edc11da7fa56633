"""Container request parsing from configuration.

The port's copy of `tony_tpu/session/requests.py`.

Equivalent of Utils.parseContainerRequests (util/Utils.java:364-406) +
JobContainerRequest (tensorflow/JobContainerRequest.java:9-63), with `tpus`
added as a first-class resource. Each jobtype gets a **unique priority** —
the reference relied on unique YARN priorities to match allocations back to
jobtypes (comment at util/Utils.java:392-398); the local backend keeps the
same contract so a future real-RM backend can too.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tony_tpu_torch.conf import TonyConfiguration, keys as K


@dataclass
class JobContainerRequest:
    job_name: str
    num_instances: int
    memory_mb: int = 2048
    vcores: int = 1
    gpus: int = 0
    tpus: int = 0
    priority: int = 0
    node_label: str = ""
    command: str = ""          # per-jobtype override of the task command
    depends_on: list[str] = field(default_factory=list)
    # untracked jobtypes don't gang at the barrier, so their instances
    # may run sequentially through the pool (no co-residency requirement)
    untracked: bool = False

    def __hash__(self):
        return hash(self.job_name)


def _staged_tasks(conf: TonyConfiguration, all_jobs: list[str],
                  untracked: set[str]) -> dict[str, list[str]]:
    """Prepare/training stage handling: auto-fill the missing stage with the
    complement and validate coverage (Utils.ensureStagedTasksIntegrity,
    util/Utils.java:408-426). Returns {job: implicit depends_on list}."""
    prepare = conf.get_strings(K.APPLICATION_PREPARE_STAGE)
    training = conf.get_strings(K.APPLICATION_TRAINING_STAGE)
    if not prepare and not training:
        return {}
    if not prepare:
        prepare = [j for j in all_jobs if j not in training]
    elif not training:
        training = [j for j in all_jobs if j not in prepare]
    if len(prepare) + len(training) != len(all_jobs):
        raise ValueError(
            f"application stages do not cover all jobtypes: "
            f"{len(prepare)} prepare + {len(training)} training != "
            f"{len(all_jobs)} total")
    # training-stage jobs depend on every *tracked* prepare-stage job
    deps = [j for j in prepare if j not in untracked]
    return {j: list(deps) for j in training}


def parse_container_requests(conf: TonyConfiguration) -> dict[str, JobContainerRequest]:
    """Build one JobContainerRequest per jobtype with instances > 0, each at a
    unique priority (util/Utils.java:364-406)."""
    all_jobs = conf.job_types()
    untracked = set(conf.get_strings(K.APPLICATION_UNTRACKED_JOBTYPES))
    stage_deps = _staged_tasks(conf, all_jobs, untracked)

    requests: dict[str, JobContainerRequest] = {}
    priority = 0
    for job in all_jobs:
        num = conf.get_int(K.instances_key(job), 0)
        if num <= 0:
            continue
        depends_on = conf.get_strings(K.depends_on_key(job))
        depends_on += [d for d in stage_deps.get(job, []) if d not in depends_on]
        requests[job] = JobContainerRequest(
            job_name=job,
            num_instances=num,
            memory_mb=conf.get_memory_mb(K.memory_key(job), 2048),
            vcores=conf.get_int(K.vcores_key(job), 1),
            gpus=conf.get_int(K.gpus_key(job), 0),
            tpus=conf.get_int(K.tpus_key(job), 0),
            priority=priority,
            node_label=conf.get_str(K.node_label_key(job)),
            command=conf.get_str(K.command_key(job)),
            depends_on=depends_on,
            untracked=job in untracked,
        )
        priority += 1
    # validate depends-on targets exist
    for req in requests.values():
        for dep in req.depends_on:
            if dep not in requests:
                raise ValueError(
                    f"jobtype {req.job_name!r} depends on unknown/empty "
                    f"jobtype {dep!r}")
    return requests
