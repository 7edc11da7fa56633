"""The serving process of a serving cell: the port's
`ContinuousBatchingEngine` and `ServeFrontend`, as `python -m
tony_tpu_torch.serve` builds them, in a process of their own, on the
configuration file's model (weights from the seed) and the mix's slots
and budget, greedy.

    python3 portbench/serve_proc.py CONFIG_FILE TRAFFIC_FILE SEED DEVICE

It warms the shapes the mix uses, starts the engine loop and the HTTP
frontend on a free localhost port, prints `PB {json}` (the port) on
stdout, then answers each command line on stdin with one `PB {json}`
line:
- `mark`: the engine's counters and this process's clock;
- `trace_start` (answered as `mark`) / `trace_stop`: the profiler over
  whole engine steps, started and stopped by the engine's own thread at a
  step boundary;
- `finish`: the reduced trace with the prompt lengths admitted in the
  traced steps, the peak device memory, the requests' queue waits and
  admissions, and the forbidden modules loaded;
- `exit`: stops the frontend and the engine and exits.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults, isolation, traffic as tr, weights  # noqa: E402
from portbench.program import serving_config  # noqa: E402
from portbench.trace import Trace  # noqa: E402


def _reply(obj) -> None:
    sys.stdout.write("PB " + json.dumps(obj) + "\n")
    sys.stdout.flush()


def budget_of(mix: dict) -> int:
    b = mix["token_budget"]
    return tr.longest_request(mix) if b == "longest" else int(b)


def warm(engine, mix: dict, vocab: int) -> None:
    """The mix's prompt lengths (shortest, median, longest) through
    prefill, and decode steps with every slot busy."""
    import numpy as np
    rng = np.random.default_rng(0)
    p = mix["prompt"]
    lens = [p["min"], int(p["median"]), p["max"]]
    lens += [p["min"]] * max(0, engine.n_slots - len(lens))
    handles = [engine.submit(rng.integers(0, vocab, n).tolist(), 3)
               for n in lens[:engine.n_slots]]
    while not all(h.done.is_set() for h in handles):
        engine.step()


class Stepper:
    """The engine's `step`, wrapped: at a step boundary, start or stop the
    profiler when asked (once a run), noting the serving clock at each
    end. An admission happens inside a step, so the traced steps admit
    exactly the requests whose `admitted_at` lies between the two."""

    def __init__(self, engine):
        self.step = engine.step
        self.want = False
        self.trace = None           # the Trace, kept after it stops
        self.span = [None, None]    # this clock at the trace's two ends
        self.done = threading.Event()

    def __call__(self):
        if self.want and self.trace is None:
            self.trace = Trace()
            self.span[0] = time.monotonic()
            self.trace.start()
        elif not self.want and self.trace is not None \
                and not self.done.is_set():
            self.trace.stop()
            self.span[1] = time.monotonic()
            self.done.set()
        return self.step()


def main(argv) -> int:
    t0 = time.monotonic()
    config_file, traffic_file, seed, device = argv[:4]
    with open(config_file) as f:
        cfg = json.load(f)
    with open(traffic_file) as f:
        mix = json.load(f)
    import torch

    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tony_tpu_torch.serve.frontend import ServeFrontend

    faults.install_serving(cfg["vocab_size"])
    config = serving_config(cfg)
    with torch.inference_mode():
        params = weights.make_params(cfg, int(seed), device)
    engine = ContinuousBatchingEngine(
        params, config, n_slots=int(mix["slots"]),
        token_budget=budget_of(mix), queue_depth=int(mix["queue_depth"]),
        temperature=0.0)
    warm(engine, mix, cfg["vocab_size"])
    records: list = []
    submit = engine.submit

    def recording_submit(*args, **kwargs):
        h = submit(*args, **kwargs)
        records.append(h)
        return h
    engine.submit = recording_submit
    stepper = Stepper(engine)
    engine.step = stepper
    engine.start()
    frontend = ServeFrontend(engine, port=0, host="127.0.0.1")
    frontend.start()
    on_card = torch.device(device).type == "cuda"
    _reply({"port": frontend.port, "setup_s": time.monotonic() - t0,
            "kind": torch.cuda.get_device_name() if on_card else "cpu"})
    for line in sys.stdin:
        cmd = line.strip()
        if cmd in ("mark", "trace_start"):
            if cmd == "trace_start":
                stepper.want = True
            s = engine.stats
            _reply({"t": time.monotonic(), "decode_steps": s.decode_steps,
                    "admissions": s.admissions,
                    "tokens": s.tokens_emitted})
        elif cmd == "trace_stop":
            stepper.want = False
            stepper.done.wait(timeout=120)
            _reply({"ok": stepper.done.is_set()})
        elif cmd == "finish":
            # the events are reduced once the window is over
            trace = None
            if stepper.done.is_set():
                a, b = stepper.span
                trace = dict(stepper.trace.result(), admitted_prompts=[
                    len(h.prompt) for h in records
                    if h.admitted_at is not None
                    and a <= h.admitted_at <= b])
            _reply({
                "trace": trace,
                "peak_bytes": (torch.cuda.max_memory_allocated()
                               if on_card else 0),
                "requests": [{"submitted": h.submitted_at,
                              "queue_wait_s": h.queue_wait_s,
                              "admitted": h.admitted_at,
                              "prompt": len(h.prompt)} for h in records],
                "forbidden": isolation.forbidden_modules()})
        elif cmd == "exit":
            break
    # the engine first: it ends every queued request, so no handler
    # thread waits on a stream that will not come
    engine.stop()
    frontend.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
