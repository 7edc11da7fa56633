"""The readings a cell's limits are set from, on the card at the cell's own
size: the program's numbers over many seeds, the control's (the
reference computed in fp8) and each planted fault's.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 1,2,3] \
        [--seconds 20]
    python3 portbench/calibrate.py --workload NAME --control-runs 1,2,3 \
        [--seconds 20]

Training reads the first two steps alone (no window). Serving runs the
cell with a short window at its own load and reads the control on the
same served tokens; `--rates` instead sweeps an open-loop cell's rate
(no reference) to find the highest the port sustains. `--control-runs`
runs the whole cell (`run.run_cell`, a window of `--seconds`) on each
seed with the control judged in the program's place, by the cell's own
limits: its `correct` has to come out false. One JSON line per reading
on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import compare, run as bench_run  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def train(cfg, mix, args) -> None:
    from portbench import train_cell as tc
    for seed in args.seeds:
        t = time.monotonic()
        trainer, config = tc.build_trainer(cfg, mix, seed, "cuda")
        prog, _, _ = tc.first_two_steps(trainer, cfg, mix, seed)
        dev = tc.free(trainer)
        del trainer
        ref = tc.reference_steps(cfg, mix, seed, dev, config)
        emit(seed=seed, what="program",
             readings=compare.training_readings(prog, ref),
             prog=prog["loss"], ref=ref["loss"],
             seconds=time.monotonic() - t)
        if seed in args.control_seeds:
            t = time.monotonic()
            low = tc.reference_steps(cfg, mix, seed, dev, config, "fp8")
            emit(seed=seed, what="control",
                 readings=compare.training_readings(low, ref),
                 seconds=time.monotonic() - t)
        if args.fault and seed in args.fault_seeds:
            t = time.monotonic()
            trainer, _ = tc.build_trainer(cfg, mix, seed, "cuda", args.fault)
            bad, _, _ = tc.first_two_steps(trainer, cfg, mix, seed)
            tc.free(trainer)
            del trainer
            emit(seed=seed, what=args.fault,
                 readings=compare.training_readings(bad, ref),
                 seconds=time.monotonic() - t)


def serve(cfg, mix, args, files, cell) -> None:
    from portbench import serve_cell as sc
    for rate in args.rates:
        t = time.monotonic()
        # each rate as offered, waited for past the close, not judged
        sweep = dict(mix, rate_per_s=rate, above_capacity=False)
        res = sc.run(cell, cfg, sweep, args.seeds[0],
                     args.seconds, False, "cuda", t, files=files,
                     check=False)
        c = res["counters"]
        emit(rate=rate, what="sweep", attempted=res["attempted"],
             failed=res["failed"], e2e=res["e2e"],
             queue_wait_p95_ms=1000 * sc.percentile(c["queue_wait_s"], 95),
             queue_wait_quarters_s=c["queue_wait_quarters_s"],
             decode_steps=c["decode_steps"], seconds=time.monotonic() - t)
    for seed in ([] if args.rates else args.seeds):
        t = time.monotonic()
        res = sc.run(cell, cfg, mix, seed, args.seconds, False, "cuda", t,
                     files=files, control=seed in args.control_seeds,
                     check=not args.timings)
        extra = {}
        if args.timings:
            # every request's first-token wait and stream gaps, seconds
            recs = res["records"]
            extra = {"ttft": [round(r.arrivals[0] - r.due, 6) if r.arrivals
                              else None for r in recs],
                     "prompt": [len(r.req.prompt) for r in recs],
                     "gaps": [round(b - a, 6) for r in recs
                              for a, b in zip(r.arrivals, r.arrivals[1:])]}
        emit(seed=seed, what="program", readings=res["readings"],
             control_readings=res["control_readings"], attempted=res["attempted"], failed=res["failed"],
             e2e=res["e2e"], seconds=time.monotonic() - t, **extra)
        if args.fault and seed in args.fault_seeds:
            t = time.monotonic()
            res = sc.run(cell, cfg, mix, seed, args.seconds, False, "cuda",
                         t, fault=args.fault, files=files)
            emit(seed=seed, what=args.fault, readings=res["readings"],
                 seconds=time.monotonic() - t)


def control_runs(bench, args) -> None:
    for seed in args.control_runs:
        t = time.monotonic()
        out = bench_run.run_cell(bench, args.workload, seed, args.seconds,
                                 False, t_start=t, control=True)
        emit(seed=seed, what="control_run", correct=out["correct"],
             checks=out["checks"], readings=out["readings"],
             control_readings=out["control_readings"],
             seconds=time.monotonic() - t)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-runs", type=_seeds, default=[],
                   help="run the cell on these seeds with the control "
                   "judged in the program's place")
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--timings", action="store_true",
                   help="serving: no reference; emit every request's "
                   "first-token wait and stream gaps")
    p.add_argument("--rates", type=lambda t: [float(x) for x in t.split(",")],
                   default=[], help="serving: sweep these open-loop rates "
                   "(requests/s) on the first seed instead")
    args = p.parse_args(argv)
    bench = bench_run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, conf = bench_run.find_cell(bench, args.workload)
    config_file = os.path.join(ROOT, conf["file"])
    traffic_file = os.path.join(HERE, "traffic", f"{cell['traffic']}.json")
    cfg = bench_run.load_json(config_file)
    mix = bench_run.load_json(traffic_file)
    if args.control_runs:
        control_runs(bench, args)
    elif mix["kind"] == "train":
        train(cfg, mix, args)
    else:
        serve(cfg, mix, args, (config_file, traffic_file), cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
