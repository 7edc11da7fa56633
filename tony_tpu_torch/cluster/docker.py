"""Docker container-runtime opt-in.

The port's copy of `tony_tpu/cluster/docker.py`.

Equivalent of the reference's reflection-set YARN docker env
(util/Utils.java:718-765; keys TonyConfigurationKeys.java:227-239,266-268):
when `tony.docker.enabled` is true, each task container carries env telling
the substrate to run the executor inside the configured image, with
per-jobtype image override `tony.<jobtype>.docker.image` beating the global
`tony.docker.containers.image`. Backends that exec processes directly can
instead wrap the launch command with `docker_wrap_command`.
"""

from __future__ import annotations

from typing import Mapping, Optional

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.configuration import TonyConfiguration

# env names mirror YARN's DockerLinuxContainerRuntime contract
ENV_CONTAINER_TYPE = "TONY_CONTAINER_RUNTIME_TYPE"
ENV_DOCKER_IMAGE = "TONY_CONTAINER_RUNTIME_DOCKER_IMAGE"
ENV_DOCKER_MOUNTS = "TONY_CONTAINER_RUNTIME_DOCKER_MOUNTS"


def docker_image_for(conf: TonyConfiguration, jobtype: str) -> str:
    """Per-jobtype image beats the global one (Utils.java:744-752)."""
    return (conf.get_str(K.jobtype_key(jobtype, "docker.image"))
            or conf.get_str(K.DOCKER_IMAGE))


def docker_env(conf: TonyConfiguration,
               jobtype: str) -> Optional[dict[str, str]]:
    """The docker env block for a task container, or None when disabled or
    no image is configured (Utils.java:718-742)."""
    if not conf.get_bool(K.DOCKER_ENABLED, False):
        return None
    image = docker_image_for(conf, jobtype)
    if not image:
        return None
    env = {ENV_CONTAINER_TYPE: "docker", ENV_DOCKER_IMAGE: image}
    mounts = conf.get_str(K.DOCKER_MOUNTS)
    if mounts:
        env[ENV_DOCKER_MOUNTS] = mounts
    return env


def docker_wrap_command(image: str, command: list[str],
                        env: Mapping[str, str],
                        mounts: str = "", workdir: str = "",
                        name: str = "") -> list[str]:
    """Build the `docker run` argv a process-exec backend uses to honor the
    opt-in (the YARN runtime did this inside the NodeManager). Pass `name`
    so the backend can `docker kill` the daemon-side container on stop —
    killing the docker CLI client alone leaves the container running.

    Env vars use docker's pass-through form (`-e KEY`, no value): values —
    which include TONY_SECURITY_TOKEN when security is on — must never
    appear in argv, where they'd be world-readable via /proc/<pid>/cmdline
    for the container's lifetime. The caller must export the same env to
    the docker CLI process (LocalClusterBackend passes full_env), which the
    daemon reads to resolve the pass-through names."""
    argv = ["docker", "run", "--rm", "--network=host"]
    if name:
        argv += ["--name", name]
    if workdir:
        argv += ["-v", f"{workdir}:{workdir}", "-w", workdir]
    for mount in filter(None, mounts.split(",")):
        src, _, dst = mount.partition(":")
        argv += ["-v", f"{src}:{dst or src}"]
    for k in sorted(env):
        argv += ["-e", k]
    return argv + [image] + list(command)
