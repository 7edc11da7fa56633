"""AM process supervisor: `python -m tony_tpu_torch.am.supervisor --app_id X --app_dir D`.

The port's copy of `tony_tpu/am/supervisor.py`.

The in-process session-retry loop (ApplicationMaster.run) restarts a
*session*, but a crashed AM **process** — SIGKILL, OOM, a native
crash — used to take the whole application with it: every executor
hard-exited after its heartbeat budget and the gang's work was lost.
The reference system leaned on YARN to relaunch AM attempts
(ApplicationMaster retry, TonY arxiv 1904.01631 §3.3); the local
substrate has no resource manager, so this module is that parent.

The client spawns the supervisor instead of the AM whenever
`tony.am.max-attempts` > 1. The supervisor:

- launches `python -m tony_tpu_torch.am` with `TONY_AM_ATTEMPT=<n>` in its
  environment (attempt 0 = the normal first launch; attempt > 0 makes
  the AM replay the control-plane journal and RECOVER);
- forwards SIGTERM to the child (the client's kill path TERMs the
  supervisor's process group, so the AM still gets its graceful
  shutdown);
- on a clean exit (rc == 0) or any exit that left `status.json`
  behind (the AM completed its lifecycle — even FAILED is a *decision*,
  not a crash), stops;
- on a crash, relaunches after the same deterministic jittered backoff
  the in-process session retry uses, up to `tony.am.max-attempts`
  total process attempts.

Crucially the supervisor itself holds NO state beyond the attempt
counter — everything the next attempt needs is in the journal.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.am.application_master import session_retry_backoff_sec
from tony_tpu_torch.conf import TonyConfiguration, keys as K

log = logging.getLogger(__name__)


def supervise(app_id: str, app_dir: str,
              conf: TonyConfiguration | None = None) -> int:
    if conf is None:
        conf = TonyConfiguration.read(os.path.join(app_dir,
                                                   C.TONY_FINAL_CONF))
    max_attempts = max(1, conf.get_int(K.AM_MAX_ATTEMPTS, 1))
    base_ms = conf.get_int(K.AM_RETRY_BACKOFF_BASE_MS, 1000)
    max_ms = conf.get_int(K.AM_RETRY_BACKOFF_MAX_MS, 30_000)
    status_path = os.path.join(app_dir, C.AM_STATUS_FILE)

    child: subprocess.Popen | None = None
    terming = {"flag": False}

    def _forward_term(signum, frame):
        terming["flag"] = True
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signal.SIGTERM)
            except OSError:
                pass

    signal.signal(signal.SIGTERM, _forward_term)

    rc = 1
    for attempt in range(max_attempts):
        env = dict(os.environ)
        env[C.AM_ATTEMPT] = str(attempt)
        log.info("launching AM process attempt %d/%d for %s", attempt + 1,
                 max_attempts, app_id)
        child = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.am",
             "--app_id", app_id, "--app_dir", app_dir],
            env=env)
        rc = child.wait()
        if rc == 0:
            return 0
        if terming["flag"]:
            log.info("AM exited %d under supervisor SIGTERM; not "
                     "relaunching", rc)
            return rc
        if os.path.exists(status_path):
            # the AM reached _finish and wrote its verdict — a non-zero
            # exit here is an application outcome, not an AM crash
            log.info("AM exited %d after writing %s; lifecycle complete",
                     rc, C.AM_STATUS_FILE)
            return rc
        if attempt + 1 >= max_attempts:
            break
        backoff = session_retry_backoff_sec(app_id, attempt + 1, base_ms,
                                            max_ms)
        log.warning("AM process attempt %d crashed (rc=%d); relaunch "
                    "%d/%d after %d ms backoff", attempt, rc, attempt + 2,
                    max_attempts, int(backoff * 1000))
        deadline = time.time() + backoff
        while time.time() < deadline and not terming["flag"]:
            time.sleep(min(0.2, max(0.0, deadline - time.time())))
        if terming["flag"]:
            return rc
    log.error("AM crashed on final process attempt (rc=%d); giving up", rc)
    return rc if rc != 0 else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.am.supervisor")
    parser.add_argument("--app_id", required=True)
    parser.add_argument("--app_dir", required=True)
    args = parser.parse_args(argv)
    from tony_tpu_torch.observability.logs import configure_structured_logging
    configure_structured_logging(app_id=args.app_id, trace_id=args.app_id)
    return supervise(args.app_id, args.app_dir)


if __name__ == "__main__":
    sys.exit(main())
