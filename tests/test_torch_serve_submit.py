"""The port's serving submitter (tony_tpu_torch/examples/serve_submit.py)
and goodput report (tony_tpu_torch/tools/goodput_report.py) against the
JAX package's (examples/llama-serve/serve_submit.py, tools/
goodput_report.py), on the CPU.

- `serve_submit --smoke --config tiny` through each package's client on
  the local backend, both at once, on one `tiny` checkpoint the port's
  trainer wrote (each package's server reads it): each submits a serving
  job, waits for the registered endpoint, sends the one /v1/generate
  request and stops the job. Both exit 0 with SERVE_SMOKE_OK last, and
  their `generated:` tokens are equal (greedy, f32).
- `goodput_report` on one goodput.json (two tasks, a relaunch downtime)
  and spans.json, in an app dir's layout and in a history dir's: the
  table and the --json dump equal the JAX tool's, byte for byte, and so
  does the refusal of a path without goodput.json; the report loads no
  torch, jax or grpc at import.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_S = 240


def _submit(tmp_path, name: str, argv: list, ckpt: str):
    """One submitter as a subprocess, its work dir and the AM's cadences
    in its own site conf."""
    site = tmp_path / f"{name}-site"
    site.mkdir()
    (site / "tony-site.json").write_text(json.dumps({
        "tony.cluster.workdir": str(tmp_path / f"{name}-apps"),
        "tony.am.monitor-interval-ms": 200,
        "tony.task.heartbeat-interval-ms": 300,
        "tony.task.term-grace-ms": 2000}))
    env = dict(os.environ, PYTHONPATH=REPO, TONY_CONF_DIR=str(site))
    return subprocess.Popen(
        [sys.executable, *argv, "--config", "tiny", "--checkpoint-dir",
         ckpt, "--smoke"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def test_serve_submit_smoke_generates_the_jax_scripts_tokens(tmp_path):
    from tony_tpu_torch.train.__main__ import main as train_main

    ckpt = str(tmp_path / "ckpt")
    with contextlib.redirect_stdout(io.StringIO()):
        assert train_main(["--device", "cpu", "--config", "tiny", "--steps",
                           "2", "--batch-size", "2", "--seq-len", "32",
                           "--checkpoint-dir", ckpt]) == 0
    procs = {
        "port": _submit(tmp_path, "port", [
            "-m", "tony_tpu_torch.examples.serve_submit", "--device",
            "cpu"], ckpt),
        "jax": _submit(tmp_path, "jax", [
            os.path.join(REPO, "examples", "llama-serve",
                         "serve_submit.py")], ckpt)}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=SMOKE_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    lines = {}
    for name, (out, err) in outs.items():
        assert procs[name].returncode == 0, f"{name}: {out}{err[-3000:]}"
        lines[name] = out.strip().splitlines()
        assert lines[name][-1] == "SERVE_SMOKE_OK", (name, out)
        assert lines[name][0].startswith("submitted application_")
        assert lines[name][1].startswith("serving endpoint: http://")
        assert lines[name][1].endswith("/v1/generate")
    generated = {name: json.loads(next(
        line for line in got if line.startswith("generated: "))[11:])
        for name, got in lines.items()}
    assert len(generated["port"]) == 16
    assert generated["port"] == generated["jax"]
    # the port's job ran the port's server, killed by the client
    [app] = os.listdir(tmp_path / "port-apps")
    with open(tmp_path / "port-apps" / app / "tony-final.json") as f:
        command = json.load(f)["values"]["tony.serving.command"]
    assert command.split()[1:4] == ["-m", "tony_tpu_torch.serve",
                                    "--config"]
    assert "--device cpu" in command


def _goodput() -> dict:
    from tony_tpu_torch.observability import perf

    return perf.aggregate_goodput({
        "worker:0": {perf.goodput_metric_name("train_step"): 8.25,
                     perf.goodput_metric_name("compile"): 1.5,
                     perf.goodput_metric_name("input_stall"): 0.125,
                     perf.goodput_metric_name("idle"): 0.0,
                     perf.GOODPUT_WALL_METRIC: 10.0,
                     "TRAIN_MFU_PCT": 27.3125},
        "worker:1": {perf.goodput_metric_name("train_step"): 6.0,
                     perf.goodput_metric_name("checkpoint_save"): 2.5,
                     perf.GOODPUT_WALL_METRIC: 9.5},
        "ps:0": {"SOME_OTHER_GAUGE": 3.0}}, relaunch_downtime_s=4.75)


def _report(tool: str, argv: list) -> tuple[int, str, str]:
    """One tool's `main(argv)` in this process: (exit, stdout, stderr)."""
    if tool == "port":
        from tony_tpu_torch.tools.goodput_report import main
    else:
        from tools.goodput_report import main
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("layout", ["app_dir", "history_dir"])
def test_goodput_report_prints_the_jax_tools_table_and_json(tmp_path,
                                                            layout):
    from tony_tpu_torch.events.history import write_goodput_file

    app_id = "application_1_0001"
    hist = tmp_path / "app" / "history" / app_id
    hist.mkdir(parents=True)
    goodput = _goodput()
    write_goodput_file(str(hist), goodput)
    (hist / "spans.json").write_text(json.dumps([
        {"name": "application", "start_ms": 0, "end_ms": 21000}]))
    path = str(tmp_path / "app" if layout == "app_dir" else hist)
    for flags in ([], ["--json"]):
        port = _report("port", [path, *flags])
        assert port == _report("jax", [path, *flags])
        assert port[0] == 0 and port[2] == ""
    text = _report("port", [path])[1]
    assert "worker:0         train_step" in text and "82.5%" in text
    assert "job goodput:" in text
    assert json.loads(_report("port", [path, "--json"])[1]) == json.loads(
        json.dumps(goodput))
    # a path with no goodput.json under it
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    missing = _report("port", [empty])
    assert missing == _report("jax", [empty])
    assert missing[0] == 1 and missing[2].startswith("no goodput.json")
    # the module entry, as an operator runs it
    run = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.tools.goodput_report", path],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 0 and run.stdout == text


def test_goodput_report_imports_no_torch_jax_or_grpc():
    """Like the AM core, the report loads none of them at import."""
    probe = ("import sys, tony_tpu_torch.tools.goodput_report\n"
             "print(sorted({n.split('.')[0] for n in sys.modules}\n"
             "             & {'torch', 'jax', 'jaxlib', 'grpc', "
             "'tony_tpu'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
