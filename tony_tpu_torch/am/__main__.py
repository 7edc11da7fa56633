"""AM process entry: `python -m tony_tpu_torch.am --app_id X --app_dir D`.

The port's copy of `tony_tpu/am/__main__.py`.

Equivalent of ApplicationMaster.main (ApplicationMaster.java:299-309): reads
the frozen tony-final.json from the app dir, runs the AM, exits 0 on overall
success, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

from tony_tpu_torch import constants as C
from tony_tpu_torch.am.application_master import ApplicationMaster
from tony_tpu_torch.conf import TonyConfiguration


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.am")
    parser.add_argument("--app_id", required=True)
    parser.add_argument("--app_dir", required=True)
    args = parser.parse_args(argv)
    # structured JSON-lines logging stamped with {app_id, trace_id} so AM
    # records join the span waterfall (TONY_LOG_PLAIN=1 opts out)
    from tony_tpu_torch.observability.logs import configure_structured_logging
    configure_structured_logging(app_id=args.app_id, trace_id=args.app_id)
    conf_path = os.path.join(args.app_dir, C.TONY_FINAL_CONF)
    conf = TonyConfiguration.read(conf_path)
    # always-on control-plane profiler + stall watchdog + faulthandler
    # (SIGUSR2 → all-thread dump): the AM adopts the pair so stall
    # transitions land in the job history and the collapsed-stack
    # profile flushes to profile.folded at finish
    from tony_tpu_torch.observability.profiler import install_process_profiler
    profiler, watchdog = install_process_profiler("am", conf=conf)
    am = ApplicationMaster(conf, app_id=args.app_id, app_dir=args.app_dir)
    am.adopt_profiler(profiler, watchdog)

    # Graceful shutdown on SIGTERM: behave as if the client signaled finish so
    # the monitor loop exits, containers are stopped by _teardown, and the
    # history/status artifacts are still written (the reference relied on
    # YARN to reap containers; the local substrate must do it itself).
    import signal

    def _on_sigterm(signum, frame):
        am.finish_application({})

    signal.signal(signal.SIGTERM, _on_sigterm)
    ok = am.run()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
