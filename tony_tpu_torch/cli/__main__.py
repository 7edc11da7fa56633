"""`python -m tony_tpu_torch.cli
{submit|local|notebook|profile|logs|diagnose|stragglers|alerts|top
|preempt|resize|arbiter|router|rollout|trace|flame} ...`

The port's copy of `tony_tpu/cli/__main__.py`: the same subcommands, the
same text and exit codes, the client, AM and executor of the port.

- submit   — ClusterSubmitter equivalent (cli/ClusterSubmitter.java:41-94):
             run against the configured cluster workdir; app artifacts
             persist for the history server.
- local    — LocalSubmitter equivalent (cli/LocalSubmitter.java:33-71):
             ephemeral workdir, removed after the run.
- notebook — NotebookSubmitter equivalent (cli/NotebookSubmitter.java:46-146):
             single-node app on the AM + local TCP proxy to it.
- profile  — ask a RUNNING app's AM to capture a profiler trace on
             one task's trainer (request_profile RPC; the artifact lands
             in the job's history as profiles/<request_id>/ and a
             PROFILE_CAPTURED event links it).
- logs     — stream a task's stdout/stderr through the app's AM
             (read_task_logs RPC): live from the executor while the task
             runs, from history-aggregated logs after; `--follow` polls
             with an offset cursor (bounded chunks on every hop).
- diagnose — print a failed app's root-cause bundle (diagnostics.json):
             first-failing task, exit signal, matched error signature,
             redacted last-lines excerpt.
- stragglers — render a job's cross-task skew bundle (skew.json) offline
             from history: latched stragglers with evidence, gang
             quantiles per signal, and the step-time heatmap.
- alerts   — render a job's alert bundle (alerts.json) offline from
             history: firing alerts, the transition log, and the
             incident timeline correlated with events + diagnostics;
             `--follow` polls for new transitions.
- top      — polling text view of the live fleet over a shared staging
             location (the jobstate.json registry every AM publishes
             into): per-job state/chips/goodput plus per-queue
             quota-utilization rollups. `--once` prints one frame.
- router   — serving fleet router (serve/router.py): one front door
             spreading /v1/generate least-loaded across the app's
             registered serving endpoints, with 429 spill-over,
             connection draining, and dead-endpoint eviction.
- rollout  — zero-downtime rolling weight update over a running app's
             serving replicas (request_rolling_update RPC): drain one,
             relaunch on the latest checkpoint, wait healthy, repeat.
- resize   — elastic gang resize (request_resize RPC): grow/shrink a
             running app's training gang in place — quiesce, in-place
             emergency checkpoint, generation-bumped re-rendezvous,
             reshard-restore; no evict, no resubmit.
- flame    — render the always-on control-plane profiler's collapsed-
             stack profile (live from a RUNNING app's AM via the
             get_profile RPC, or the profile.folded history sidecar)
             as a sorted hot-stack table; `--folded` emits raw
             flamegraph.pl / speedscope input.
"""

from __future__ import annotations

import logging
import sys

from tony_tpu_torch.cli.cluster_submitter import submit as cluster_submit
from tony_tpu_torch.cli.local_submitter import submit as local_submit
from tony_tpu_torch.cli.notebook_submitter import submit as notebook_submit

USAGE = ("usage: python -m tony_tpu_torch.cli "
         "{submit|local|notebook|profile|logs|diagnose|stragglers"
         "|alerts|top|preempt|resize|arbiter|router|rollout|trace"
         "|flame} [args...]")


def _am_client(app_dir: str):
    """(client, error) for the app's AM, from the amhostport file +
    token the client left in the app dir — the same plumbing as the
    `profile` verb."""
    import os

    from tony_tpu_torch import constants as C
    from tony_tpu_torch.rpc.client import ClusterServiceClient
    from tony_tpu_torch.security import read_token_file

    hostport_path = os.path.join(app_dir, C.AM_HOSTPORT_FILE)
    try:
        with open(hostport_path, "r", encoding="utf-8") as f:
            host, _, port = f.read().strip().rpartition(":")
    except OSError as e:
        return None, f"cannot read {hostport_path}: {e} — is the app running?"
    token = read_token_file(app_dir)
    return ClusterServiceClient(host, int(port),
                                auth_token=token or None), None


def logs(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli logs <app_dir> [task] [--stream stderr]
    [--follow]` — live task log streaming through the AM. Both sides are
    bounded: a fresh cursor starts at most tony.logs.tail-bytes back,
    every chunk is capped at tony.logs.chunk-bytes, and --follow polls
    at tony.logs.follow-poll-ms (flag-overridable)."""
    import argparse
    import time

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli logs")
    parser.add_argument("app_dir",
                        help="the application dir the client created "
                             "(holds the amhostport file)")
    parser.add_argument("task", nargs="?", default="",
                        help="task to tail, e.g. worker:0 (default: the "
                             "AM picks the first running tracked task)")
    parser.add_argument("--stream", default="stderr",
                        choices=("stdout", "stderr"))
    parser.add_argument("--follow", "-f", action="store_true",
                        help="keep polling for new output until the "
                             "stream ends (or Ctrl-C)")
    parser.add_argument("--poll-ms", type=int, default=500,
                        help="--follow poll interval")
    parser.add_argument("--max-bytes", type=int, default=0,
                        help="per-chunk byte cap (0 = server default; "
                             "the server enforces tony.logs.chunk-bytes "
                             "regardless)")
    args = parser.parse_args(argv)
    from tony_tpu_torch.rpc.messages import LogChunk

    client, err = _am_client(args.app_dir)
    if err:
        print(err, file=sys.stderr)
        return 1
    offset = -1
    task_id = args.task
    # --follow rides out transient blips (AM busy, relaunch window):
    # only this many CONSECUTIVE failed polls end the stream — a single
    # deadline miss must not kill a tail mid-incident
    max_consecutive_failures = 10 if args.follow else 1
    failures = 0
    got_any = False
    try:
        while True:
            chunk = None
            try:
                resp = client.read_task_logs(
                    task_id=task_id, stream=args.stream, offset=offset,
                    max_bytes=args.max_bytes)
                if (resp or {}).get("error"):
                    print(f"error: {resp['error']}", file=sys.stderr)
                else:
                    chunk = LogChunk.from_dict(resp or {})
            except Exception as e:  # noqa: BLE001 — transient or AM gone
                print(f"log read failed: {e}", file=sys.stderr)
            if chunk is None:
                failures += 1
                if failures >= max_consecutive_failures:
                    if args.follow:
                        print("log stream ended", file=sys.stderr)
                    return 0 if got_any else 1
                time.sleep(max(50, args.poll_ms) / 1000.0)
                continue
            failures = 0
            if chunk.data:
                got_any = True
                sys.stdout.write(chunk.data)
                sys.stdout.flush()
            # lock onto the task the AM picked so the cursor never
            # migrates between tasks mid-stream
            task_id = chunk.task_id or task_id
            offset = chunk.next_offset
            if not args.follow and not chunk.data:
                return 0
            if chunk.eof:
                return 0
            if not chunk.data:
                time.sleep(max(50, args.poll_ms) / 1000.0)
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()


def _history_candidates(target: str, fname: str) -> list[str]:
    """Candidate paths for a history sidecar (`fname`) given an app dir,
    a history dir, or a direct file path."""
    import glob
    import os

    from tony_tpu_torch import constants as C

    if os.path.isfile(target):
        return [target]
    candidates = (
        [os.path.join(target, fname)]
        + sorted(glob.glob(os.path.join(
            target, C.HISTORY_DIR_NAME, "*", fname)))
        + sorted(glob.glob(os.path.join(target, "*", fname))))
    # an app dir with a configured tony.history.intermediate keeps
    # its history elsewhere — follow the frozen conf there
    frozen = os.path.join(target, C.TONY_FINAL_CONF)
    if os.path.isfile(frozen):
        try:
            from tony_tpu_torch.conf import TonyConfiguration, keys as K
            intermediate = TonyConfiguration.read(frozen).get_str(
                K.HISTORY_INTERMEDIATE, "")
        except Exception:  # noqa: BLE001 — conf damage ≠ no diagnosis
            intermediate = ""
        if intermediate:
            app_id = os.path.basename(os.path.normpath(target))
            candidates += (
                [os.path.join(intermediate, app_id, fname)]
                + sorted(glob.glob(os.path.join(
                    intermediate, "*", fname))))
    return candidates


def _find_history_json(target: str, fname: str):
    """Resolve a history sidecar (`fname`) from an app dir, a history
    dir, or a direct file path; returns (dict | None, searched paths)."""
    import json
    import os

    candidates = _history_candidates(target, fname)
    for path in candidates:
        if os.path.isfile(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    return json.load(f), candidates
            except (OSError, ValueError):
                continue
    return None, candidates


def _find_history_text(target: str, fname: str):
    """Like `_find_history_json` but for plain-text sidecars
    (profile.folded is collapsed-stack lines, not JSON); returns
    (text | None, searched paths)."""
    import os

    candidates = _history_candidates(target, fname)
    for path in candidates:
        if os.path.isfile(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
            if text.strip():
                return text, candidates
    return None, candidates


def _find_diagnostics(target: str):
    from tony_tpu_torch import constants as C
    return _find_history_json(target, C.DIAGNOSTICS_FILE)


def diagnose(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli diagnose <app_dir>` — print the job's
    root-cause bundle (the same diagnostics.json the portal's failure
    panel renders)."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli diagnose")
    parser.add_argument("target",
                        help="app dir, history dir, or a diagnostics.json")
    parser.add_argument("--json", action="store_true",
                        help="dump the raw bundle instead of a summary")
    args = parser.parse_args(argv)
    bundle, searched = _find_diagnostics(args.target)
    if bundle is None:
        print("no diagnostics bundle found (searched: "
              + ", ".join(searched[:4])
              + "). The job may have succeeded, still be running, or "
                "predate diagnostics.", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(bundle, indent=1, sort_keys=True))
        return 0
    first = bundle.get("first_failure") or {}
    print(f"application {bundle.get('app_id', '?')}: "
          f"{bundle.get('status', '?')}")
    if bundle.get("message"):
        print(f"  {bundle['message']}")
    if not first:
        print("no task failure records — the failure was not task-level "
              "(preprocess, allocation, or client stop)")
        return 0
    sigdesc = first.get("signal_name") or (
        f"exit {first.get('exit_code')}"
        if first.get("exit_code") is not None else "no exit code")
    print(f"first failing task: {first.get('task_id', '?')} "
          f"(attempt {first.get('attempt', 0)}, {sigdesc})")
    print(f"  reason: {first.get('reason', '')}")
    if first.get("signature"):
        print(f"  signature: {first['signature']}")
        if first.get("hint"):
            print(f"  hint: {first['hint']}")
    if first.get("line"):
        print(f"  matched: {first['line']}")
    tails = first.get("tail") or {}
    for stream in ("stderr", "stdout"):
        lines = tails.get(stream) or []
        if not lines:
            continue
        print(f"--- {stream} (last {len(lines)} lines, redacted) ---")
        for ln in lines:
            print(f"  {ln}")
    others = [r for r in (bundle.get("failures") or [])
              if (r.get("task_id"), r.get("attempt"))
              != (first.get("task_id"), first.get("attempt"))]
    if others:
        print(f"{len(others)} further failure record(s):")
        for r in others:
            rsig = r.get("signature") or "no signature"
            print(f"  {r.get('task_id', '?')} attempt "
                  f"{r.get('attempt', 0)}: {r.get('reason', '')} ({rsig})")
    # wedge autopsies: the stacks the AM pulled off suspects before
    # declaring them dead — the blocking frame names the wedge
    stacks = bundle.get("stacks") or {}
    if stacks:
        print(f"{len(stacks)} wedge autopsy(ies) — stacks captured "
              "before the task was declared dead:")
        for task_id in sorted(stacks):
            rec = stacks[task_id] or {}
            print(f"  {task_id} attempt {rec.get('attempt', 0)} "
                  f"({rec.get('reason', '')}): blocked in "
                  f"{rec.get('blocking_frame') or '?'}")
        print("  (full per-thread stacks: --json, key 'stacks')")
    return 0


def stragglers(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli stragglers <target>` — render the job's
    cross-task skew bundle (the same skew.json the portal's skew panel
    reads) offline from history: latched stragglers with their evidence,
    the detection log, per-signal gang quantiles, and an ASCII step-time
    heatmap."""
    import argparse
    import json

    from tony_tpu_torch import constants as C

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli stragglers")
    parser.add_argument("target",
                        help="app dir, history dir, or a skew.json")
    parser.add_argument("--json", action="store_true",
                        help="dump the raw bundle instead of a summary")
    args = parser.parse_args(argv)
    bundle, searched = _find_history_json(args.target, C.SKEW_FILE)
    if bundle is None:
        print("no skew bundle found (searched: "
              + ", ".join(searched[:4])
              + "). The job may predate skew analytics or never closed "
                "an analysis window.", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(bundle, indent=1, sort_keys=True))
        return 0
    latched = bundle.get("stragglers") or []
    if latched:
        print(f"{len(latched)} latched straggler(s):")
        for s in latched:
            print(f"  {s.get('task_id', '?')}: {s.get('phase', '?')} via "
                  f"{s.get('signal', '?')} — {s.get('value_ms', 0)} ms vs "
                  f"gang median {s.get('gang_median_ms', 0)} ms "
                  f"(z={s.get('z_score', 0)}, "
                  f"{s.get('windows', 0)} window(s))")
    else:
        print("no latched stragglers")
    detections = bundle.get("detections") or []
    if detections:
        print(f"{len(detections)} detection-log entr(ies):")
        for d in detections[-10:]:
            print(f"  [{d.get('ts_ms', 0)}] {d.get('action', '?')} "
                  f"{d.get('task_id', '?')} ({d.get('phase', '?')} via "
                  f"{d.get('signal', '?')}, {d.get('value_ms', 0)} ms vs "
                  f"{d.get('gang_median_ms', 0)} ms"
                  + (f", {d['reason']}" if d.get("reason") else "") + ")")
    for signal, entry in sorted((bundle.get("signals") or {}).items()):
        windows = entry.get("windows") or []
        if not windows:
            continue
        gang = windows[-1].get("gang") or {}
        print(f"{signal}: last window p50={gang.get('p50', 0)} "
              f"p95={gang.get('p95', 0)} p99={gang.get('p99', 0)} ms "
              f"over {gang.get('count', 0)} sample(s) "
              f"({len(windows)} window(s) retained)")
    heatmap = bundle.get("heatmap") or {}
    tasks = heatmap.get("tasks") or {}
    if tasks:
        peak = max((v for row in tasks.values() for v in row
                    if isinstance(v, (int, float))), default=0.0)
        if peak > 0:
            blocks = " ▁▂▃▄▅▆▇█"
            print(f"{heatmap.get('signal', 'step_time_ms')} heatmap "
                  f"(darker = slower; peak {peak:.1f} ms):")
            for tid in sorted(tasks):
                cells = "".join(
                    blocks[min(8, 1 + int(7.999 * v / peak))]
                    if isinstance(v, (int, float)) else "."
                    for v in tasks[tid])
                print(f"  {tid:>16} {cells}")
    return 0


def _print_alert_line(t: dict) -> None:
    status = str(t.get("status", "?")).upper()
    print(f"  [{t.get('ts_ms', 0)}] {status:<8} "
          f"[{t.get('severity', 'warning')}] {t.get('rule_id', '?')} "
          f"on {t.get('key', '?')}"
          + (f": {t['message']}" if t.get("message") else ""))


def alerts(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli alerts <target> [--json] [--follow]` —
    render a job's alert bundle offline from history (the same
    alerts.json the portal's panel reads): firing alerts, the bounded
    transition log, and the incident timeline correlated from the event
    log + diagnostics bundle when they sit next to it. `--follow`
    re-polls the bundle and prints new transitions as the AM appends
    them (the AM refreshes alerts.json on every transition)."""
    import argparse
    import glob as _glob
    import json
    import os
    import time

    from tony_tpu_torch import constants as C

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli alerts")
    parser.add_argument("target",
                        help="app dir, history dir, or an alerts.json")
    parser.add_argument("--json", action="store_true",
                        help="dump the raw bundle instead of a summary")
    parser.add_argument("--follow", "-f", action="store_true",
                        help="keep polling for new transitions until "
                             "Ctrl-C")
    parser.add_argument("--poll-ms", type=int, default=1000,
                        help="--follow poll interval")
    args = parser.parse_args(argv)
    bundle, searched = _find_history_json(args.target, C.ALERTS_FILE)
    if bundle is None:
        print("no alert bundle found (searched: "
              + ", ".join(searched[:4])
              + "). The job may predate alerting, have no live rules, "
                "or never have evaluated one.", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(bundle, indent=1, sort_keys=True))
        return 0
    firing = bundle.get("firing") or []
    if firing:
        print(f"{len(firing)} firing alert(s):")
        for a in firing:
            print(f"  [{a.get('severity', 'warning')}] "
                  f"{a.get('rule_id', '?')} on {a.get('key', '?')} "
                  f"since {a.get('since_ms', 0)}: "
                  f"{a.get('message', '')} "
                  f"(value {a.get('value', 0)} vs threshold "
                  f"{a.get('threshold', 0)})")
    else:
        print("no firing alerts")
    log = bundle.get("log") or []
    if log:
        print(f"{len(log)} transition(s) in the log:")
        for t in log[-20:]:
            _print_alert_line(t)
    # incident timeline when the bundle sits inside a history dir that
    # also holds the event log / diagnostics bundle
    bundle_path = next((p for p in searched if os.path.isfile(p)), None)
    if bundle_path is not None:
        hist_dir = os.path.dirname(os.path.abspath(bundle_path))
        events = []
        for jhist in sorted(_glob.glob(os.path.join(
                hist_dir, "*." + C.HISTORY_SUFFIX))):
            try:
                from tony_tpu_torch.events.handler import parse_events
                events = [e.to_dict() for e in parse_events(jhist)]
                break
            except Exception:  # noqa: BLE001 — timeline is best-effort
                continue
        diagnostics, _ = _find_history_json(hist_dir, C.DIAGNOSTICS_FILE)
        from tony_tpu_torch.observability.alerts import build_incident_timeline
        timeline = build_incident_timeline(
            events=events, alerts_bundle=bundle,
            diagnostics=diagnostics)
        if timeline:
            print(f"incident timeline ({len(timeline)} entr(ies)):")
            for r in timeline:
                spans = r.get("span_ids") or []
                print(f"  [{r.get('ts_ms', 0)}] "
                      f"{r.get('severity', 'info'):<8} "
                      f"{r.get('kind', '?'):<9} "
                      f"{r.get('summary', '')}"
                      + (f" (spans: {', '.join(spans)})"
                         if spans else ""))
    if not args.follow:
        return 0
    last_ts = max((int(t.get("ts_ms", 0) or 0) for t in log), default=0)
    try:
        while True:
            time.sleep(max(100, args.poll_ms) / 1000.0)
            bundle, _ = _find_history_json(args.target, C.ALERTS_FILE)
            if bundle is None:
                continue
            fresh = [t for t in bundle.get("log") or []
                     if int(t.get("ts_ms", 0) or 0) > last_ts]
            for t in fresh:
                _print_alert_line(t)
                last_ts = max(last_ts, int(t.get("ts_ms", 0) or 0))
            sys.stdout.flush()
    except KeyboardInterrupt:
        return 0


def _render_fleet_frame(view) -> str:
    """One `cli top` frame: the live jobs table (state-then-start
    order, like the portal index) + per-queue quota rollups."""
    from tony_tpu_torch.observability.fleet import chips_of, quota_utilization
    import time as _time

    lines = []
    jobs = view.registry.jobs()
    live = [j for j in jobs if j.get("state") == "RUNNING"]
    now_ms = int(_time.time() * 1000)
    lines.append(f"fleet @ {view.location} — {len(live)} live job(s), "
                 f"{sum(chips_of(j) for j in live)} chip(s) in use")
    header = (f"{'APP':<36} {'QUEUE':<10} {'USER':<10} {'STATE':<9} "
              f"{'W':>7} {'CHIPS':>5} {'GOOD%':>6} {'MFU%':>6} "
              f"{'STRAG':>5} {'ALRT':>4} {'TOK/S':>7} {'HB':>5}")
    lines.append(header)
    for j in jobs:
        age = max(0.0, (now_ms - int(j.get("heartbeat_ms", 0) or 0))
                  / 1000.0)

        def _pct(v):
            return "-" if v is None else f"{float(v):.1f}"

        # elastic width surface: "cur>req" while a resize is in flight
        # (requested width diverges from current), bare width otherwise
        cur_w = int(j.get("gang_width", 0) or 0)
        req_w = int(j.get("requested_width", cur_w) or cur_w)
        width_cell = f"{cur_w}>{req_w}" if req_w != cur_w else str(cur_w)
        lines.append(
            f"{str(j.get('app_id', ''))[:36]:<36} "
            f"{str(j.get('queue', ''))[:10]:<10} "
            f"{str(j.get('user', ''))[:10]:<10} "
            f"{str(j.get('state', '?')):<9} "
            f"{width_cell:>7} "
            f"{chips_of(j):>5} "
            f"{_pct(j.get('goodput_pct')):>6} "
            f"{_pct(j.get('mfu_pct')):>6} "
            f"{int(j.get('straggler_count', 0) or 0):>5} "
            f"{int(j.get('alerts_firing', 0) or 0):>4} "
            + (f"{float(j['serving_tokens_per_sec']):>7.0f} "
               if j.get("serving_tokens_per_sec") is not None
               else f"{'-':>7} ")
            + f"{age:>4.0f}s")
    util = quota_utilization(view.queues, live)
    if util:
        lines.append("queues:")
        for q in sorted(util):
            b = util[q]
            if b["max_tpus"] > 0:
                lines.append(
                    f"  {q:<12} {b['chips_in_use']}/{b['max_tpus']} chips "
                    f"({b.get('utilization_pct', 0.0):.0f}% of quota), "
                    f"{b['live_jobs']} live job(s)")
            else:
                lines.append(f"  {q:<12} {b['chips_in_use']} chips "
                             f"(no quota), {b['live_jobs']} live job(s)")
    return "\n".join(lines)


def top(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli top <staging-location> [--interval-ms N]
    [--once] [--json]` — the live fleet, polled straight off the
    registry files (no portal required)."""
    import argparse
    import json
    import time

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli top")
    parser.add_argument("location",
                        help="shared staging location the AMs publish "
                             "jobstate into (tony.staging.location)")
    parser.add_argument("--interval-ms", type=int, default=2000,
                        help="poll cadence")
    parser.add_argument("--once", action="store_true",
                        help="print a single frame and exit")
    parser.add_argument("--json", action="store_true",
                        help="dump the /api/fleet payload instead of "
                             "the table (implies --once)")
    parser.add_argument("--queues-conf", default="",
                        help="conf file declaring tony.queues.<name>."
                             "max-tpus quotas for the utilization rollup")
    args = parser.parse_args(argv)
    from tony_tpu_torch.conf import TonyConfiguration
    from tony_tpu_torch.conf.queues import configured_queues
    from tony_tpu_torch.observability.fleet import FleetView

    queues = {}
    if args.queues_conf:
        queues = configured_queues(TonyConfiguration.read(args.queues_conf))
    # read-only observer: top renders the registry + quotas but never
    # folds/saves the durable accounting (that's the portal's job, run
    # with the cluster's configured staleness/bounds)
    view = FleetView(args.location, queues=queues,
                     refresh_interval_ms=max(200, args.interval_ms // 2),
                     settle_accounting=False)
    try:
        while True:
            view.refresh(force=True)
            if args.json:
                print(json.dumps(view.api_fleet(), indent=1,
                                 sort_keys=True))
                return 0
            frame = _render_fleet_frame(view)
            if not args.once:
                # ANSI home+clear keeps the frame in place like top(1)
                print("\x1b[H\x1b[2J", end="")
            print(frame, flush=True)
            if args.once:
                return 0
            time.sleep(max(200, args.interval_ms) / 1000.0)
    except KeyboardInterrupt:
        return 0


def profile(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli profile <app_dir> [--task-id worker:0]
    [--steps N]` — the operator verb behind the request_profile RPC."""
    import argparse
    import json
    import os

    from tony_tpu_torch import constants as C
    from tony_tpu_torch.rpc.client import ClusterServiceClient

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli profile")
    parser.add_argument("app_dir",
                        help="the application dir the client created "
                             "(holds the amhostport file)")
    parser.add_argument("--task-id", default="",
                        help="task to profile, e.g. worker:0 (default: "
                             "the AM picks the first running tracked "
                             "task)")
    parser.add_argument("--steps", type=int, default=0,
                        help="trace length in train steps (0 = "
                             "tony.profiling.default-steps)")
    args = parser.parse_args(argv)
    hostport_path = os.path.join(args.app_dir, C.AM_HOSTPORT_FILE)
    try:
        with open(hostport_path, "r", encoding="utf-8") as f:
            host, _, port = f.read().strip().rpartition(":")
    except OSError as e:
        print(f"cannot read {hostport_path}: {e} — is the app running?",
              file=sys.stderr)
        return 1
    from tony_tpu_torch.security import read_token_file
    token = read_token_file(args.app_dir)
    client = ClusterServiceClient(host, int(port),
                                  auth_token=token or None)
    try:
        resp = client.request_profile(task_id=args.task_id,
                                      num_steps=args.steps)
    except Exception as e:  # noqa: BLE001 — operator tool, report and exit
        print(f"request_profile failed: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(json.dumps(resp or {}, indent=1))
    return 0 if not (resp or {}).get("error") else 1


def preempt(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli preempt <app_dir> [--grace-ms N]
    [--reason ...]` — checkpoint-then-evict one running application:
    the AM drains its gang (trainers emergency-checkpoint within the
    grace window) and finishes PREEMPTED, resumable from the
    checkpoint. The operator edge of the arbiter's eviction path."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli preempt")
    parser.add_argument("app_dir",
                        help="the application dir the client created "
                             "(holds the amhostport file)")
    parser.add_argument("--grace-ms", type=int, default=0,
                        help="emergency-checkpoint window before the "
                             "force-stop (0 = tony.arbiter.grace-ms)")
    parser.add_argument("--reason", default="operator preemption")
    args = parser.parse_args(argv)
    client, err = _am_client(args.app_dir)
    if err:
        print(err, file=sys.stderr)
        return 1
    try:
        resp = client.request_preemption(grace_ms=args.grace_ms,
                                         reason=args.reason,
                                         requested_by="operator")
    except Exception as e:  # noqa: BLE001 — operator tool, report and exit
        print(f"request_preemption failed: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(json.dumps(resp or {}, indent=1))
    return 0 if not (resp or {}).get("error") else 1


def resize(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli resize <app_dir> <job> <width>
    [--tpus-per-task N] [--grace-ms N] [--reason ...]` — elastic gang
    resize: grow/shrink a RUNNING application's training gang in place
    (request_resize RPC): the gang quiesces, emergency-checkpoints in
    place, re-renders its cluster spec at the new width behind a
    generation bump, and reshard-restores — no evict, no resubmit.
    `width` is the jobtype's task-instance count; `--tpus-per-task`
    instead re-meshes the chips of a fixed-membership gang (pass width
    0 with it)."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli resize")
    parser.add_argument("app_dir",
                        help="the application dir the client created "
                             "(holds the amhostport file)")
    # job is REQUIRED on the CLI: with both positionals optional,
    # `cli resize <app> 8` would silently bind job="8" and drop the
    # width. (The RPC itself still accepts an empty job_name — the AM
    # then picks the widest tracked training jobtype.)
    parser.add_argument("job",
                        help="the elastic jobtype (e.g. worker)")
    parser.add_argument("width", nargs="?", type=int, default=0,
                        help="target task-instance count (0 with "
                             "--tpus-per-task)")
    parser.add_argument("--tpus-per-task", type=int, default=0,
                        help="re-mesh the per-task chip count instead "
                             "of changing membership")
    parser.add_argument("--grace-ms", type=int, default=0,
                        help="quiesce/checkpoint window (0 = "
                             "tony.elastic.quiesce-grace-ms)")
    parser.add_argument("--session-attempt", type=int, default=-1,
                        help="fence the ask to one AM session attempt "
                             "(-1 = current)")
    parser.add_argument("--reason", default="operator resize")
    args = parser.parse_args(argv)
    if not args.width and not args.tpus_per_task:
        print("resize: pass a width or --tpus-per-task", file=sys.stderr)
        return 2
    client, err = _am_client(args.app_dir)
    if err:
        print(err, file=sys.stderr)
        return 1
    try:
        resp = client.request_resize(
            job_name=args.job, width=args.width,
            tpus_per_task=args.tpus_per_task, grace_ms=args.grace_ms,
            reason=args.reason, requested_by="operator",
            session_attempt=args.session_attempt)
    except Exception as e:  # noqa: BLE001 — operator tool, report and exit
        print(f"request_resize failed: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(json.dumps(resp or {}, indent=1))
    return 0 if not (resp or {}).get("error") else 1


def arbiter(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli arbiter <staging-location> --chips N
    [--queue q --user u --priority p] [--queues-conf file] [--evict]
    [--offer-idle N]` — one gang-admission verdict against the LIVE
    fleet registry: prints admit / reclaim (elastic jobs shrink in
    place, preferred) / queue / preempt (with the minimal victim set);
    with --evict, delivers request_resize shrinks to reclaim victims
    and request_preemption to eviction victims. `--offer-idle N` is the
    offer loop's edge instead: hand N idle chips to RUNNING elastic
    jobs that can widen (the jobs the annotated
    fleet.chips_idle_while_queued alert names)."""
    import argparse
    import json

    from tony_tpu_torch.cluster.arbiter import (
        Arbiter, GangAsk, execute_preemption, execute_reclaims,
        offer_idle_chips,
    )
    from tony_tpu_torch.conf import TonyConfiguration
    from tony_tpu_torch.observability.fleet import FleetRegistry

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli arbiter")
    parser.add_argument("location",
                        help="staging-store location the fleet registry "
                             "scans (tony.staging.location)")
    parser.add_argument("--chips", type=int, default=0,
                        help="the gang's summed chip ask (all-or-nothing)")
    parser.add_argument("--offer-idle", type=int, default=0,
                        help="offer this many idle chips to widenable "
                             "elastic jobs (request_resize grow) instead "
                             "of judging an ask")
    parser.add_argument("--queue", default="default")
    parser.add_argument("--user", default="")
    parser.add_argument("--priority", type=int, default=0)
    parser.add_argument("--app-id", default="ask")
    parser.add_argument("--queues-conf", default="",
                        help="conf file declaring tony.queues.* / "
                             "tony.arbiter.* (defaults apply otherwise)")
    parser.add_argument("--evict", action="store_true",
                        help="on a preempt verdict, actually deliver "
                             "request_preemption to the victim AMs")
    parser.add_argument("--grace-ms", type=int, default=0)
    args = parser.parse_args(argv)

    conf = TonyConfiguration()
    if args.queues_conf:
        conf.merge_file(args.queues_conf, "arbiter-cli")
    registry = FleetRegistry(location=args.location)
    registry.refresh(force=True)
    if args.offer_idle > 0:
        delivered = offer_idle_chips(
            registry.live_jobs(), args.offer_idle,
            reason=f"operator offer of {args.offer_idle} idle chip(s)",
            requested_by="arbiter")
        print(json.dumps({"action": "offer", "offered": delivered},
                         indent=1))
        return 0
    if args.chips <= 0:
        print("arbiter: need --chips (or --offer-idle)", file=sys.stderr)
        return 2
    arb = Arbiter.from_conf(conf)
    arb.sync_from_fleet(registry.live_jobs())
    ask = GangAsk(app_id=args.app_id, chips=args.chips, queue=args.queue,
                  user=args.user, priority=args.priority)
    decision = arb.decide(ask)
    out = {"action": decision.action, "reason": decision.reason,
           "victims": [v.app_id for v in decision.victims],
           "reclaims": [(a.app_id, chips)
                        for a, chips in decision.reclaims],
           "free_chips": (arb.free_chips() if arb.total_chips > 0
                          else None),
           "total_chips": arb.total_chips or None,
           "running": sorted(arb.running)}
    from tony_tpu_torch.conf import keys as K
    grace_ms = args.grace_ms or conf.get_time_ms(K.ARBITER_GRACE_MS,
                                                 30_000)
    if decision.action == "reclaim" and args.evict:
        out["reclaimed"] = execute_reclaims(
            decision.reclaims, grace_ms=grace_ms,
            reason=f"reclaimed to admit {args.app_id} "
                   f"(priority {args.priority}, {args.chips} chips)")
    if decision.action == "preempt" and args.evict:
        out["evicted"] = execute_preemption(
            decision.victims, grace_ms=grace_ms,
            reason=f"preempted to admit {args.app_id} "
                   f"(priority {args.priority}, {args.chips} chips)")
    print(json.dumps(out, indent=1))
    return 0


def _router_status(url: str) -> int:
    """One-shot fleet table off a running router's /v1/fleet bundle:
    per replica — role, health state, queue/slots, paged-KV page
    occupancy and prefix hit rate (from the cached /v1/load probes) —
    plus the router's routing counters incl. prefix-affinity hit/miss."""
    import json as _json
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + "/v1/fleet",
                                    timeout=5.0) as resp:
            bundle = _json.loads(resp.read().decode("utf-8"))
    except Exception as exc:  # noqa: BLE001 — operator-facing one-liner
        print(f"router: /v1/fleet unreachable at {url}: {exc}",
              file=sys.stderr)
        return 1
    print(f"{'ENDPOINT':<28} {'ROLE':<8} {'STATE':<9} {'QUEUE':>5} "
          f"{'FREE':>4} {'KV-OCC%':>7} {'KV-HIT%':>7}")
    for ep in bundle.get("endpoints") or []:
        load = ep.get("load") or {}
        occ = hit = "-"
        total = float(load.get("kv_pages_total", 0) or 0)
        if total > 0:
            free = float(load.get("kv_pages_free", 0) or 0)
            occ = f"{100.0 * (1.0 - free / total):.1f}"
            hit = f"{float(load.get('kv_hit_rate_pct', 0) or 0):.1f}"
        role = str(ep.get("role", "") or load.get("role", "") or "both")
        print(f"{ep.get('url', ''):<28} {role:<8} "
              f"{ep.get('state', '?'):<9} "
              f"{int(load.get('queue_depth', 0) or 0):>5} "
              f"{int(load.get('slots_free', 0) or 0):>4} "
              f"{occ:>7} {hit:>7}")
    stats = bundle.get("stats") or {}
    hits = int(stats.get("affinity_hits", 0) or 0)
    misses = int(stats.get("affinity_misses", 0) or 0)
    routed = hits + misses
    pct = f" ({100.0 * hits / routed:.1f}%)" if routed else ""
    print(f"routed={stats.get('requests_routed', 0)} "
          f"failed={stats.get('requests_failed', 0)} "
          f"spillovers={stats.get('spillovers_429', 0)} "
          f"affinity hits={hits} misses={misses}{pct}")
    return 0


def router(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli router <app_dir> [--port N]` (or
    `--endpoints url1,url2` standalone) — stand up the serving fleet
    router (serve/router.py): one front door spreading /v1/generate
    least-loaded across the app's registered serving endpoints, with
    429 spill-over, connection draining, and dead-endpoint eviction.
    Orchestrated mode polls the AM's task infos so endpoint
    registrations, drain marks, and rolling-update generation bumps
    reach the router live."""
    import argparse
    import threading
    import time

    from tony_tpu_torch.conf import TonyConfiguration, keys as K
    from tony_tpu_torch.serve.router import AmEndpointWatcher, FleetRouter

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli router")
    parser.add_argument("app_dir", nargs="?", default="",
                        help="the application dir the client created "
                             "(holds the amhostport file)")
    parser.add_argument("--endpoints", default="",
                        help="comma-separated replica URLs (standalone "
                             "mode, no AM)")
    parser.add_argument("--port", type=int, default=-1,
                        help="router HTTP port (-1 = "
                             "tony.serving.fleet.router-port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--poll-ms", type=int, default=1000,
                        help="AM endpoint-set poll cadence")
    parser.add_argument("--probe-ttl-ms", type=int, default=-1,
                        help="load-probe cache TTL (-1 = "
                             "tony.serving.fleet.probe-ttl-ms)")
    parser.add_argument("--spillover-retries", type=int, default=-1,
                        help="429/5xx spill-over retries (-1 = "
                             "tony.serving.fleet.spillover-retries)")
    parser.add_argument("--status", default="",
                        help="one-shot: render a RUNNING router's "
                             "/v1/fleet table (pass the router URL) "
                             "and exit")
    args = parser.parse_args(argv)
    if args.status:
        return _router_status(args.status)
    if not args.app_dir and not args.endpoints:
        print("router: need an app_dir or --endpoints", file=sys.stderr)
        return 2
    conf = TonyConfiguration()
    # the router is a long-running front door: same always-on coverage
    # as the AM/executor/portal/serve daemons (profiler + stall
    # watchdog + SIGUSR2 all-thread dump)
    from tony_tpu_torch.observability.profiler import install_process_profiler
    install_process_profiler("router", conf=conf)
    port = args.port if args.port >= 0 \
        else conf.get_int(K.SERVING_FLEET_ROUTER_PORT, 0)
    rtr = FleetRouter(
        endpoints=[u for u in args.endpoints.split(",") if u],
        port=port, host=args.host,
        probe_ttl_ms=(args.probe_ttl_ms if args.probe_ttl_ms >= 0 else
                      conf.get_time_ms(K.SERVING_FLEET_PROBE_TTL_MS,
                                       500)),
        probe_timeout_ms=conf.get_time_ms(
            K.SERVING_FLEET_PROBE_TIMEOUT_MS, 1000),
        spillover_retries=(args.spillover_retries
                           if args.spillover_retries >= 0 else
                           conf.get_int(
                               K.SERVING_FLEET_SPILLOVER_RETRIES, 2)),
        dead_after_failures=conf.get_int(
            K.SERVING_FLEET_DEAD_AFTER_FAILURES, 2))
    watcher = None
    client = None
    if args.app_dir:
        client, err = _am_client(args.app_dir)
        if err:
            print(err, file=sys.stderr)
            return 1
        watcher = AmEndpointWatcher(rtr, client,
                                    interval_s=args.poll_ms / 1000.0)
        watcher.start()
    rtr.start()
    # log-ok: greppable bring-up marker (mirrors SERVING_UP)
    print(f"ROUTER_UP http://127.0.0.1:{rtr.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        if watcher is not None:
            watcher.stop()
        if client is not None:
            client.close()
        rtr.stop()
    return 0


def rollout(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli rollout <app_dir> [--generation N]` —
    zero-downtime rolling weight update over a running app's serving
    replicas: one at a time, each endpoint drains (router stops new
    sends, in-flight requests finish), relaunches restoring the latest
    promoted checkpoint, and the rollout advances only once the
    replacement re-registers healthy at the new generation."""
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli rollout")
    parser.add_argument("app_dir",
                        help="the application dir the client created "
                             "(holds the amhostport file)")
    parser.add_argument("--generation", type=int, default=0,
                        help="weights epoch the updated replicas serve "
                             "(0 = bump the AM's epoch by one)")
    args = parser.parse_args(argv)
    client, err = _am_client(args.app_dir)
    if err:
        print(err, file=sys.stderr)
        return 1
    try:
        resp = client.request_rolling_update(generation=args.generation,
                                             requested_by="operator")
    except Exception as e:  # noqa: BLE001 — operator tool, report and exit
        print(f"request_rolling_update failed: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(json.dumps(resp or {}, indent=1))
    return 0 if not (resp or {}).get("error") else 1


def trace(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli trace <target>` — render the job's
    tail-sampled serving request traces offline from history (the same
    serving_traces.json the portal's request panel reads): the
    slowest-requests table (dominant hop names the guilty replica) plus
    an ASCII per-hop waterfall of the slowest — or a chosen — trace."""
    import argparse
    import json

    from tony_tpu_torch import constants as C
    from tony_tpu_torch.observability.reqtrace import slowest_table, stitch

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli trace")
    parser.add_argument("target",
                        help="app dir, history dir, or a "
                             "serving_traces.json")
    parser.add_argument("--json", action="store_true",
                        help="dump the stitched bundle instead of a "
                             "summary")
    parser.add_argument("--trace-id", default="",
                        help="render only traces whose id starts with "
                             "this prefix")
    parser.add_argument("--slowest", type=int, default=10,
                        help="rows in the slowest-requests table")
    args = parser.parse_args(argv)
    raw, searched = _find_history_json(args.target, C.SERVING_TRACES_FILE)
    if raw is None:
        print("no serving traces found (searched: "
              + ", ".join(searched[:4])
              + "). The job may predate request tracing, never have "
                "served, or have sampled nothing.", file=sys.stderr)
        return 1
    records = [t for t in raw if isinstance(t, dict)] \
        if isinstance(raw, list) else []
    stitched = stitch([records])
    if args.trace_id:
        stitched = [t for t in stitched
                    if str(t.get("trace_id", "")).startswith(
                        args.trace_id)]
    table = slowest_table(stitched, args.slowest)
    if args.json:
        print(json.dumps({"traces": stitched, "slowest": table},
                         indent=1, sort_keys=True))
        return 0
    if not stitched:
        print("no sampled request traces match")
        return 1
    print(f"{len(stitched)} sampled request trace(s); slowest first:")
    for r in table:
        print(f"  {r['trace_id'][:12]}  {r['duration_ms']:9.1f} ms  "
              f"[{r['kept_reason']:8s}]  dominant: {r['dominant_hop']} "
              f"({r['dominant_process']}, {r['dominant_ms']} ms)  "
              f"processes: {', '.join(r['processes'])}")
    # ASCII waterfall of the top trace (slowest, or the --trace-id pick)
    top = stitched[0]
    hops = [h for h in top.get("hops") or []
            if isinstance(h, dict) and h.get("start_ms")]
    if not hops:
        return 0
    t0 = min(int(h["start_ms"]) for h in hops)
    t1 = max(max(int(h.get("end_ms") or 0), int(h["start_ms"]))
             for h in hops)
    extent, cols = max(1, t1 - t0), 40
    print(f"waterfall — trace {str(top.get('trace_id', ''))[:12]} "
          f"({top.get('kept_reason', '')}, "
          f"{float(top.get('duration_ms', 0) or 0):.1f} ms, "
          f"extent {extent} ms):")
    for h in hops:
        start = int(h["start_ms"])
        end = int(h.get("end_ms") or 0) or start
        pad = int(cols * (start - t0) / extent)
        bar = max(1, int(cols * (end - start) / extent))
        bar = min(bar, cols - min(pad, cols - 1))
        label = f"{h.get('name', '')} [{h.get('process', '')}]"
        mark = "!" if h.get("status") == "ERROR" else "#"
        print(f"  {label:<38.38s} {end - start:>7d} ms "
              f"|{' ' * pad}{mark * bar}"
              f"{' ' * (cols - pad - bar)}|")
    return 0


def flame(argv: list[str]) -> int:
    """`python -m tony_tpu_torch.cli flame <target>` — render the always-on
    control-plane profiler's collapsed-stack profile as a sorted hot-
    stack table. For a RUNNING app the AM serves its live fold table
    over the get_profile RPC (with the self-overhead reading); after
    finish the profile.folded sidecar in history is read instead.
    `--folded` dumps the raw collapsed-stack text for flamegraph.pl or
    speedscope."""
    import argparse
    import os

    from tony_tpu_torch import constants as C

    parser = argparse.ArgumentParser(prog="tony_tpu_torch.cli flame")
    parser.add_argument("target",
                        help="app dir (live AM or history), history "
                             "dir, or a profile.folded file")
    parser.add_argument("--top", type=int, default=25,
                        help="hot-stack rows to print")
    parser.add_argument("--folded", action="store_true",
                        help="dump the raw collapsed-stack text "
                             "(flamegraph.pl / speedscope input)")
    args = parser.parse_args(argv)

    text, meta = None, {}
    # live first: a running AM answers get_profile with its in-memory
    # fold table plus the self-overhead reading against the <1% budget
    if os.path.isfile(os.path.join(args.target, C.AM_HOSTPORT_FILE)):
        client, err = _am_client(args.target)
        if not err:
            try:
                snap = client.get_profile()
            except Exception:  # noqa: BLE001 — fall back to the sidecar
                snap = None
            finally:
                client.close()
            if isinstance(snap, dict) and not snap.get("error") \
                    and snap.get("folded"):
                text = str(snap["folded"])
                meta = snap
    if text is None:
        text, searched = _find_history_text(args.target,
                                            C.PROFILE_FOLDED_FILE)
        if text is None:
            print("no profile found (searched: " + ", ".join(searched[:4])
                  + "). The job may predate the control-plane profiler, "
                    "still be starting, or have tony.profiler.enabled "
                    "off.", file=sys.stderr)
            return 1
    if args.folded:
        print(text, end="" if text.endswith("\n") else "\n")
        return 0
    rows = []
    for line in text.splitlines():
        stack, _, count = line.rpartition(" ")
        if not stack or not count.isdigit():
            continue
        rows.append((int(count), stack))
    if not rows:
        print("profile is empty (no samples folded yet)", file=sys.stderr)
        return 1
    rows.sort(key=lambda r: (-r[0], r[1]))
    total = sum(c for c, _ in rows)
    head = (f"{total} samples across {len(rows)} distinct stacks")
    if meta:
        head += (f" — live from {meta.get('process', 'am')} @ "
                 f"{meta.get('hz', '?')} Hz, overhead "
                 f"{meta.get('overhead_pct', '?')}% "
                 f"(budget {meta.get('overhead_budget_pct', '?')}%)")
    print(head)
    width = 24
    for count, stack in rows[:max(1, args.top)]:
        pct = 100.0 * count / total
        bar = "#" * max(1, int(width * count / rows[0][0]))
        thread, _, frames = stack.partition(";")
        # leaf-most frames carry the signal; elide the common trunk
        tail = frames.split(";")
        shown = ";".join(tail[-3:]) if frames else "(no frames)"
        if len(tail) > 3:
            shown = "...;" + shown
        print(f"  {pct:5.1f}% {count:>8d}  {bar:<{width}s} "
              f"[{thread}] {shown}")
    if len(rows) > args.top:
        print(f"  ... {len(rows) - args.top} more stacks "
              f"(--top to widen, --folded for the raw profile)")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    # `tony logs ... | head` must not traceback when the pager closes
    # the pipe — restore the default SIGPIPE disposition for this
    # operator-facing process
    import signal as _signal
    try:
        _signal.signal(_signal.SIGPIPE, _signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass    # non-POSIX, or not the main thread
    if not argv:
        print(USAGE, file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "submit":
        return cluster_submit(rest)
    if cmd == "local":
        return local_submit(rest)
    if cmd == "notebook":
        return notebook_submit(rest)
    if cmd == "profile":
        return profile(rest)
    if cmd == "logs":
        return logs(rest)
    if cmd == "diagnose":
        return diagnose(rest)
    if cmd == "stragglers":
        return stragglers(rest)
    if cmd == "alerts":
        return alerts(rest)
    if cmd == "top":
        return top(rest)
    if cmd == "preempt":
        return preempt(rest)
    if cmd == "resize":
        return resize(rest)
    if cmd == "arbiter":
        return arbiter(rest)
    if cmd == "router":
        return router(rest)
    if cmd == "rollout":
        return rollout(rest)
    if cmd == "trace":
        return trace(rest)
    if cmd == "flame":
        return flame(rest)
    print(USAGE, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
