"""The benchmark of the port (`tony_tpu_torch`) on the H100.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of `BENCHMARK.json` (a configuration under a traffic mix) on
the card and prints one JSON line last on stdout: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics; with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and `checks`,
each number compared for `correct` beside its limit (also printed last on
stderr).

Everything is found by name: the configuration's file from
`BENCHMARK.json`, the mix in `traffic/<traffic>.json`, each metric's
reader in `metrics/<metric>.py`, the limits in `limits/<workload>.json`,
and the runner by the mix's `kind` (`train_cell`, `serve_cell`). Exits
non-zero and prints no result when torch sees no CUDA device or fewer
than the cell asks for, when a run loads JAX or the JAX package, or when
anything fails.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RUNNERS = {"train": "portbench.train_cell", "serve": "portbench.serve_cell"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration entry)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def metric_names(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: (name, unit) of its end-to-end metrics, or with
    trace of its per-layer ones; a metric with `workloads` only in those."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        out.append((m["name"], m["unit"]))
    return out


def read_metric(name: str, ctx: dict):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", fault: str = "",
             t_start: float = T_START, root: str = ROOT,
             traffic_dir: str = "", limits: dict | None = None,
             control: bool = False) -> dict:
    """Run one cell and return the result object (no chip check here).
    The tests point `root`, `traffic_dir` and `limits` at tiny cells. With
    `control`, the control (the reference in fp8) is also read on the
    run's own inputs and is what the comparison judges: `correct` has to
    come out false."""
    from portbench import compare, isolation, roofline

    cell, conf = find_cell(bench, workload)
    config_file = os.path.join(root, conf["file"])
    traffic_file = os.path.join(traffic_dir or os.path.join(HERE, "traffic"),
                                f"{cell['traffic']}.json")
    cfg, mix = load_json(config_file), load_json(traffic_file)
    runner = importlib.import_module(RUNNERS[mix["kind"]])
    res = runner.run(cell, cfg, mix, seed, seconds, trace, device, t_start,
                     fault=fault, files=(config_file, traffic_file),
                     control=control)
    forbidden = isolation.forbidden_modules() + res.get("forbidden", [])
    if forbidden:
        raise RuntimeError(f"loaded forbidden modules: {forbidden}")
    import torch
    on_card = torch.device(device).type == "cuda"
    kind = res.get("device_kind") or (torch.cuda.get_device_name(0)
                                      if on_card else "cpu")
    peaks = roofline.card_peaks(kind) or roofline.card_peaks("H100")
    ctx = {"cfg": cfg, "mix": mix, "cell": cell, "chips": cell["chips"],
           "peaks": peaks, "result": res}
    metrics = {}
    for name, unit in metric_names(bench, workload, trace):
        value = read_metric(name, ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    judged = res["control_readings"] if control else res["readings"]
    checks = compare.checks(judged or {}, limits if limits is not None
                            else compare.load_limits(workload))
    out = {"correct": compare.passed(checks), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": kind, "count": cell["chips"],
                      "memory_peak_bytes": res["peak_bytes"]}}
    tr = res.get("trace")
    if trace and tr:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    if "load" in res:
        out["load"] = res["load"]
    out["readings"] = res["readings"]
    if control:
        out["control_readings"] = res["control_readings"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _ = find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: torch sees no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} cards asked for, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    print("readings " + json.dumps(out.pop("readings")), file=sys.stderr)
    if "load" in out:
        print("load " + json.dumps(out["load"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
