"""`python -m tony_tpu_torch.cli
{submit|local|notebook|profile|logs|diagnose|stragglers|preempt|resize
|rollout|trace|flame} ...`

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

`alerts`, `top`, `arbiter` and `router` read modules the port does not
have yet (`UNPORTED`): each exits 2 with a message naming the module it
waits for, instead of running with part of the feature missing.
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

# subcommand -> the module of the JAX package it waits for
UNPORTED = {
    "alerts": "observability/alerts.py",
    "top": "the fleet reader (FleetView in observability/fleet.py)",
    "arbiter": "cluster/arbiter.py",
    "router": "serve/router.py",
}


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
    if cmd in UNPORTED:
        print(f"{cmd}: not in the port yet: it waits for "
              f"{UNPORTED[cmd]}", file=sys.stderr)
        return 2
    if cmd == "preempt":
        return preempt(rest)
    if cmd == "resize":
        return resize(rest)
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
