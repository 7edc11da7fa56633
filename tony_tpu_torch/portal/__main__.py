"""Portal daemon entry: `python -m tony_tpu_torch.portal [--conf file]
[--port N]`.

Equivalent of booting the reference's Play portal (tony-portal): brings up
the history dirs, the cache, the mover + purger daemons, and the HTTP
server, then blocks until interrupted.
"""

from __future__ import annotations

import argparse
import os
import time

from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.configuration import TonyConfiguration
from tony_tpu_torch.portal.cache import PortalCache
from tony_tpu_torch.portal.fetcher import HistoryStoreFetcher
from tony_tpu_torch.portal.mover import HistoryFileMover, ensure_history_dirs
from tony_tpu_torch.portal.purger import HistoryFilePurger
from tony_tpu_torch.portal.server import PortalServer, read_user_tokens


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tony-portal")
    parser.add_argument("--conf", default=None, help="tony conf file (json)")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--history-location", default=None,
                        help="overrides tony.history.location")
    parser.add_argument("--token-file", default=None,
                        help="bearer token file gating all routes "
                             "(overrides tony.portal.token-file)")
    parser.add_argument("--user-tokens-file", default=None,
                        help="file of user=token lines; each token sees "
                             "only that user's jobs "
                             "(overrides tony.portal.user-tokens-file)")
    parser.add_argument("--history-store", default=None,
                        help="staging-store location (gs:// or shared dir) "
                             "to pull off-host AMs' finished history from "
                             "(overrides tony.history.store-location)")
    args = parser.parse_args(argv)

    # structured JSON-lines logging like the rest of the control plane
    # (TONY_LOG_PLAIN=1 opts out)
    from tony_tpu_torch.observability.logs import configure_structured_logging
    configure_structured_logging()
    conf = TonyConfiguration.read(args.conf) if args.conf \
        else TonyConfiguration()
    # continuous profiler + stall watchdog + faulthandler (SIGUSR2 →
    # all-thread dump): the portal is a long-running daemon fleet-wide
    # operators depend on — it gets the same always-on coverage
    from tony_tpu_torch.observability.profiler import install_process_profiler
    install_process_profiler("portal", conf=conf)
    location = (args.history_location or conf.get_str(K.HISTORY_LOCATION)
                or os.path.expanduser("~/.tony_tpu/history"))
    intermediate = conf.get_str(K.HISTORY_INTERMEDIATE) or os.path.join(
        location, "intermediate")
    finished = conf.get_str(K.HISTORY_FINISHED) or os.path.join(
        location, "finished")
    ensure_history_dirs(intermediate, finished)

    cache = PortalCache(intermediate, finished,
                        conf.get_int(K.PORTAL_CACHE_MAX_ENTRIES, 1000))
    mover = HistoryFileMover(
        intermediate, finished,
        conf.get_time_ms(K.HISTORY_MOVER_INTERVAL_MS, 5 * 60 * 1000),
        conf.get_int(K.HISTORY_STALE_INPROGRESS_SEC, 24 * 3600))
    purger = HistoryFilePurger(
        finished, conf.get_int(K.HISTORY_RETENTION_SEC, 30 * 24 * 3600),
        conf.get_time_ms(K.HISTORY_PURGER_INTERVAL_MS, 6 * 3600 * 1000))
    port = args.port if args.port is not None else conf.get_int(
        K.PORTAL_PORT, 19886)
    token = None
    token_file = args.token_file or conf.get_str(K.PORTAL_TOKEN_FILE)
    if token_file:
        with open(token_file, "r", encoding="utf-8") as f:
            token = f.read().strip()
        if not token:
            raise SystemExit(f"empty portal token file: {token_file}")
    user_tokens = {}
    user_tokens_file = (args.user_tokens_file
                        or conf.get_str(K.PORTAL_USER_TOKENS_FILE))
    if user_tokens_file:
        user_tokens = read_user_tokens(user_tokens_file)
        if not user_tokens:
            raise SystemExit(
                f"empty portal user-tokens file: {user_tokens_file}")
    store_location = args.history_store or conf.get_str(
        K.HISTORY_STORE_LOCATION) or conf.get_str(K.STAGING_LOCATION)
    # fleet view (observability/fleet.py): the live cross-job registry,
    # chip-hour accounting, and quota bars need a shared store the AMs
    # publish jobstate into — the same location the history fetcher
    # pulls from. Quotas come from this portal's own conf (the same
    # tony.queues.<name>.max-tpus keys the client/AM validate against).
    fleet = None
    if store_location:
        from tony_tpu_torch.conf.queues import configured_queues
        from tony_tpu_torch.observability.alerts import fleet_engine_from_conf
        from tony_tpu_torch.observability.fleet import FleetView
        fleet = FleetView(
            store_location,
            queues=configured_queues(conf),
            stale_after_ms=conf.get_time_ms(K.FLEET_STALE_AFTER_MS, 30_000),
            history_jobs=conf.get_int(K.FLEET_HISTORY_JOBS, 200),
            refresh_interval_ms=max(
                500, conf.get_time_ms(K.FLEET_PUBLISH_INTERVAL_MS,
                                      5000) // 2),
            # fleet-scope alert rules (queue saturation, job LOST, chips
            # idle while queued) run on this view's refresh cadence;
            # webhook/file sinks come from the same tony.alerts.* keys
            # the AMs use
            alert_engine=fleet_engine_from_conf(conf))
    server = PortalServer(cache, port=port, token=token,
                          user_tokens=user_tokens, fleet=fleet,
                          history_jobs=conf.get_int(K.FLEET_HISTORY_JOBS,
                                                    200))
    fetcher = None
    if store_location:
        fetcher = HistoryStoreFetcher(store_location, intermediate,
                                      finished=finished)
        fetcher.fetch_once()   # immediate first sync before serving
        fetcher.start()

    mover.start()
    purger.start()
    server.start()
    # log-ok: interactive bootstrap banner for the operator's terminal
    print(f"tony-tpu portal: http://localhost:{server.port}/")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        mover.stop()
        purger.stop()
        if fetcher is not None:
            fetcher.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
