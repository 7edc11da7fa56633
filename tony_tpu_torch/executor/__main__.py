"""Executor process entry: ``python -m tony_tpu_torch.executor``.

Everything it needs arrives in the env the AM's container launcher
rendered. It exits with the user process's exit code; SIGTERM (the
backend stopping the container) forwards TERM to the user process group
with the term grace, then exits with the killed-by-AM code.
"""

from __future__ import annotations

import logging
import os
import signal
import sys

from tony_tpu_torch import constants as C
from tony_tpu_torch.executor.task_executor import TaskExecutor


def main() -> int:
    # structured JSON-lines logging: every record stamped with
    # {app_id, task_type, index, attempt, trace_id} so executor log lines
    # correlate with the span waterfall (TONY_LOG_PLAIN=1 opts out)
    from tony_tpu_torch.observability.logs import (
        configure_structured_logging,
    )
    configure_structured_logging()
    executor = TaskExecutor()
    # continuous profiler + stall watchdog + faulthandler (SIGUSR2 →
    # all-thread dump): a wedged executor is precisely the process whose
    # stacks the AM's autopsy pulls, and the local pair names the stall
    # in this process's own logs too
    from tony_tpu_torch.observability.profiler import (
        install_process_profiler,
    )
    install_process_profiler(f"executor:{executor.task_id}",
                             conf=executor.conf)

    # Graceful container stop: the backend sends SIGTERM (escalating to
    # SIGKILL) when the AM stops this container — and the substrate
    # sends the same signal on a maintenance or spot eviction.
    # The user process runs in its OWN session (launch_shell
    # start_new_session=True), so dying without reaping it would orphan
    # long-running workloads — a serving task's HTTP server would keep
    # the port and the process forever. SIGTERM is forwarded to the
    # user process group with the tony.task.term-grace-ms window (the
    # TERM→checkpoint→KILL contract: a Trainer's SIGTERM handler
    # commits an emergency checkpoint inside it — docs/
    # FAULT_TOLERANCE.md), then this executor exits with the
    # killed-by-AM code (the backend records EXIT_KILLED_BY_AM
    # regardless; no result is registered, exactly like the previous
    # hard-kill behavior).
    def _on_sigterm(signum, frame):
        logging.getLogger(__name__).warning(
            "SIGTERM — stopping user process and exiting")
        try:
            executor._terminate_user_proc()
        # signal handler mid-os._exit: logging here may deadlock on the
        # logging module's own lock, so this swallow stays silent
        # tony: disable=thread-hygiene -- no logging inside a signal handler
        except Exception:  # noqa: BLE001 — nothing must block the exit
            pass
        os._exit(C.EXIT_KILLED_BY_AM & 0xFF)

    signal.signal(signal.SIGTERM, _on_sigterm)
    return executor.run()


if __name__ == "__main__":
    sys.exit(main())
