"""The user process: the port's copy of `tony_tpu/utils/shell.py`.

The executor runs the task command under ``bash -c`` in a session of its
own (so a signal reaches the whole tree), with the inherited rendezvous
env scrubbed (the executor renders it anew for each launch) and the
extra env merged; output goes to the executor's stdout and stderr, which
the backend sends to the container's files.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Mapping, Optional

from tony_tpu_torch import constants as C

# rendezvous env that must not leak from the launcher into the user
# process: stale values would misdirect its process group
_SCRUBBED_ENV = (
    C.JAX_COORDINATOR_ADDRESS, C.JAX_PROCESS_ID, C.JAX_NUM_PROCESSES,
    C.TPU_SLICE_ID, C.TPU_NUM_SLICES, C.TF_CONFIG, C.CLUSTER_SPEC,
    C.INIT_METHOD, C.RANK, C.WORLD, C.MASTER_ADDR, C.MASTER_PORT,
)


def launch_shell(command: str, extra_env: Optional[Mapping[str, str]] = None,
                 cwd: Optional[str] = None, stdout=None, stderr=None
                 ) -> subprocess.Popen:
    """Start `command` via bash in a new session; the caller waits."""
    env = dict(os.environ)
    for var in _SCRUBBED_ENV:
        env.pop(var, None)
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    return subprocess.Popen(
        ["bash", "-c", command], env=env, cwd=cwd,
        stdout=stdout if stdout is not None else sys.stdout,
        stderr=stderr if stderr is not None else sys.stderr,
        start_new_session=True)


def wait_or_kill(proc: subprocess.Popen, timeout_sec: float = 0) -> int:
    """Wait for `proc`; on timeout kill its process group and return 124."""
    try:
        return proc.wait(timeout=timeout_sec if timeout_sec > 0 else None)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        return 124


def execute_shell(command: str, timeout_sec: float = 0,
                  extra_env: Optional[Mapping[str, str]] = None,
                  cwd: Optional[str] = None,
                  stdout=None, stderr=None) -> int:
    """Run `command` via bash and return its exit code (the AM's
    preprocessing job). timeout 0 = unlimited; on a timeout the whole
    process group is killed and 124 returned."""
    proc = launch_shell(command, extra_env=extra_env, cwd=cwd,
                        stdout=stdout, stderr=stderr)
    return wait_or_kill(proc, timeout_sec)
