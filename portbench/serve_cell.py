"""A serving cell: the serving process (`serve_proc.py`) holds the card;
this process is the load generator, the clock and, once the serving
process has ended, the reference.

Each request is one streamed `POST /v1/generate` on a connection of its
own, timed on this process's clock from its due time (open loop) or its
send (closed loop) to each token line's arrival. Open loop: every request
of the schedule is due inside the window, and each is waited for up to a
minute past the window's close; a mix offered `above_capacity` instead
cuts its backlog at the close, as a closed loop does, and the run fails
unless the backlog grew (`saturation`). Closed loop: the clients start in
set-up, and the window opens once each has its first token; at the close
the clients stop and the requests still streaming are cancelled.

After the window: the serving process's counters, its trace (a traced
run) and its peak memory; it exits; then the reference runs over a
sample of finished requests, drawn from the seed with the longest
(prompt plus answer) in it.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import os
import subprocess
import sys
import threading
import time

import torch

from portbench import compare, faults, traffic as tr, weights
from portbench.reference import llama as reference

HERE = os.path.dirname(os.path.abspath(__file__))
LATE_S = 60.0          # how long past the close an open-loop request waits
# above capacity: the window serves at most this share of the prompt
# tokens offered, and the last quarter of its requests waits at least
# this share of the window longer than the first quarter
SATURATED_SHARE = 0.8
WAIT_RISE_SHARE = 0.1


class Record:
    __slots__ = ("req", "due", "sent", "arrivals", "tokens", "error",
                 "finished")

    def __init__(self, req):
        self.req = req
        self.due = None
        self.sent = None
        self.arrivals: list = []
        self.tokens: list = []
        self.error = None
        self.finished = False


def stream(port: int, rec: Record, stop: threading.Event,
           timeout: float) -> None:
    """One streamed request; `stop` set closes it part way (a cancel)."""
    body = json.dumps({"prompt": rec.req.prompt,
                       "max_new_tokens": rec.req.max_new, "stream": True})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        rec.sent = time.monotonic()
        conn.request("POST", "/v1/generate", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            rec.error = f"HTTP {resp.status}: {resp.read()[:200]!r}"
            return
        while True:
            line = resp.readline()
            if not line:
                break
            msg = json.loads(line)
            if "token" in msg:
                rec.arrivals.append(time.monotonic())
                rec.tokens.append(int(msg["token"]))
            elif msg.get("done"):
                rec.finished = len(rec.tokens) == rec.req.max_new
                if not rec.finished and not stop.is_set():
                    rec.error = f"ended early: {msg}"
                resp.read()         # the last chunk: the connection ends clean
                break
            if stop.is_set():
                break
    except Exception as e:  # noqa: BLE001 — counted as a failed request
        if not stop.is_set():   # after the close a broken stream is a cut
            rec.error = f"{type(e).__name__}: {e}"
    finally:
        conn.close()


class Server:
    """The serving process and its command pipe."""

    def __init__(self, config_file: str, traffic_file: str, seed: int,
                 device: str, fault: str):
        env = dict(os.environ)
        if fault:
            env[faults.ENV] = fault
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "serve_proc.py"),
             config_file, traffic_file, str(seed), device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env)
        self.up = self._read()

    def _read(self) -> dict:
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"serving process ended (rc {self.proc.wait()})")
            if line.startswith("PB "):
                return json.loads(line[3:])

    def ask(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self._read()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("exit\n")
                self.proc.stdin.flush()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (q in [0, 100]) of every value;
    inf stands for a request that failed."""
    ordered = sorted(values)
    if not ordered:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def _open_loop(server, port, mix, seed, seconds, vocab, trace_s):
    reqs = tr.open_loop(mix, seed, seconds, vocab)
    recs = [Record(r) for r in reqs]
    stop = threading.Event()
    t0 = time.monotonic() + 0.5
    for rec in recs:
        rec.due = t0 + rec.req.due_s

    def fire(rec):
        delay = rec.due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        if not stop.is_set():
            stream(port, rec, stop, timeout=seconds + LATE_S + 60)

    threads = [threading.Thread(target=fire, args=(r,), daemon=True)
               for r in recs]
    for th in threads:
        th.start()
    marks = _window(server, t0, seconds, trace_s)
    if mix.get("above_capacity"):
        stop.set()      # the backlog is cut; its streams end with the server
        return recs, t0, marks
    deadline = t0 + seconds + LATE_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    stop.set()
    for rec in recs:
        if not rec.finished and rec.error is None:
            rec.error = "not finished a minute past the close"
    return recs, t0, marks


def _closed_loop(server, port, mix, seed, seconds, vocab, trace_s):
    per_client = tr.closed_loop(mix, seed, vocab)
    recs_all: list = []
    lock = threading.Lock()
    stop = threading.Event()
    first = threading.Barrier(len(per_client) + 1)

    def client(reqs):
        for j, req in enumerate(reqs):
            if stop.is_set():
                break
            rec = Record(req)
            with lock:
                recs_all.append(rec)
            if j == 0:
                waiter = threading.Thread(target=_first_token,
                                          args=(rec, first, stop),
                                          daemon=True)
                waiter.start()
            stream(port, rec, stop, timeout=600)
            rec.due = rec.sent

    threads = [threading.Thread(target=client, args=(r,), daemon=True)
               for r in per_client]
    for th in threads:
        th.start()
    first.wait(timeout=600)
    t0 = time.monotonic()
    marks = _window(server, t0, seconds, trace_s)
    stop.set()
    for th in threads:
        th.join(timeout=120)
    with lock:
        recs = [r for r in recs_all
                if r.sent is not None and r.sent < t0 + seconds]
    return recs, t0, marks


def _first_token(rec, barrier, stop):
    while not rec.arrivals and rec.error is None and not stop.is_set():
        time.sleep(0.005)
    barrier.wait(timeout=600)


def _window(server, t0, seconds, trace_s) -> dict:
    """Marks at the window's ends and, in a traced run, where the trace of
    the window's last `trace_s` seconds starts (`t_trace`, this clock)."""
    while time.monotonic() < t0:
        time.sleep(0.001)
    marks = {"start": server.ask("mark")}
    if trace_s:
        time.sleep(max(0.0, t0 + seconds - trace_s - time.monotonic()))
        marks["t_trace"] = time.monotonic()
        marks["trace"] = server.ask("trace_start")
    time.sleep(max(0.0, t0 + seconds - time.monotonic()))
    if trace_s:
        server.ask("trace_stop")
    marks["end"] = server.ask("mark")
    return marks


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, fault: str = "",
        files: tuple = (), control: bool = False,
        check: bool = True) -> dict:
    config_file, traffic_file = files
    vocab = cfg["vocab_size"]
    server = Server(config_file, traffic_file, seed, device, fault)
    try:
        port = server.up["port"]
        trace_s = min(float(mix["trace_s"]), seconds / 2) if trace else 0.0
        loop = _open_loop if mix["loop"] == "open" else _closed_loop
        recs, t0, marks = loop(server, port, mix, seed, seconds, vocab,
                               trace_s)
        fin = server.ask("finish")
    finally:
        server.close()
    result = summarize(recs, t0, t0 + seconds, mix, marks, fin)
    if mix.get("above_capacity"):
        saturation(result["load"], seconds)
    result["setup_s"] = t0 - t_start
    result["device_kind"] = server.up["kind"]
    result["readings"], result["control_readings"] = (
        reference_readings(cfg, mix, seed, recs, device, control)
        if check else ({}, None))
    return result


def saturation(load: dict, seconds: float) -> None:
    """Fail a run offered above capacity whose engine was not saturated:
    it served nearly all it was offered, or its queue did not grow."""
    first, last = load["queue_wait_quarters_s"] or (0.0, 0.0)
    if (load["served_share"] > SATURATED_SHARE
            or last - first < WAIT_RISE_SHARE * seconds):
        raise RuntimeError(
            f"offered above capacity, the engine was not saturated: "
            f"{load}; wanted a served share of at most {SATURATED_SHARE} "
            f"and a rise of the queue wait of at least "
            f"{WAIT_RISE_SHARE * seconds:.3f} s")


def summarize(recs, t0, t1, mix, marks, fin) -> dict:
    """End-to-end numbers over the window [t0, t1] (this clock), and the
    counters the per-layer readers take: over the window, or in a traced
    run over its part before the trace (the profiler slows the host)."""
    open_loop = mix["loop"] == "open"
    ttft, gaps, streamed, prompt_tokens = [], [], 0, 0
    for r in recs:
        if r.arrivals:
            ttft.append(r.arrivals[0] - r.due)
            if t0 <= r.arrivals[0] <= t1:
                prompt_tokens += len(r.req.prompt)
        elif open_loop:
            ttft.append(math.inf)
        for a, b in zip(r.arrivals, r.arrivals[1:]):
            if open_loop or t0 <= b <= t1:
                gaps.append(b - a)
        streamed += sum(1 for a in r.arrivals if t0 <= a <= t1)
    # the counters' span: to the trace's start when traced
    tc = marks.get("t_trace", t1)
    m0, mc = marks["start"], marks.get("trace", marks["end"])
    submitted = [q for q in fin["requests"]
                 if m0["t"] <= q["submitted"] <= mc["t"]]
    waits = [q["queue_wait_s"] for q in submitted
             if q["queue_wait_s"] is not None]
    admitted = [q["prompt"] for q in fin["requests"]
                if q["admitted"] is not None
                and m0["t"] <= q["admitted"] <= mc["t"]]
    decoded = []   # context length of each decode-produced token
    for r in recs:
        p = len(r.req.prompt)
        decoded.extend(p + j for j, a in enumerate(r.arrivals)
                       if j and t0 <= a <= tc)
    quarter = max(1, len(waits) // 4)
    offered = sum(len(r.req.prompt) for r in recs
                  if r.due is not None and t0 <= r.due <= t1)
    quarters = [sorted(waits[:quarter])[quarter // 2],
                sorted(waits[-quarter:])[quarter // 2]] if waits else []
    return {
        "window_s": t1 - t0, "attempted": len(recs),
        "failed": sum(1 for r in recs if r.error is not None),
        "cut": sum(1 for r in recs if r.error is None and not r.finished),
        "peak_bytes": fin["peak_bytes"], "forbidden": fin["forbidden"],
        "e2e": {"ttft_p95_ms": 1000.0 * percentile(ttft, 95),
                "ttft_p50_ms": 1000.0 * percentile(ttft, 50),
                "itl_p95_ms": 1000.0 * percentile(gaps, 95),
                "serve_tokens_per_s": streamed / (t1 - t0),
                "prompt_tokens_per_s": prompt_tokens / (t1 - t0)},
        "trace": fin["trace"],
        "counters": {
            "window_s": tc - t0,
            "decode_steps": mc["decode_steps"] - m0["decode_steps"],
            "queue_wait_s": waits,
            "admitted_prompts": admitted,
            "decoded_contexts": decoded,
            # median queue wait of the first and last quarter of the
            # requests: a backlog that grows shows as a rise
            "queue_wait_quarters_s": quarters,
        },
        # what the window was offered beside what it served
        "load": {"offered_prompt_tokens_per_s": offered / (t1 - t0),
                 "prompt_tokens_per_s": prompt_tokens / (t1 - t0),
                 "served_share": prompt_tokens / max(offered, 1),
                 "queue_wait_quarters_s": quarters},
        "records": recs,
    }


def sample_requests(recs, seed: int, n: int) -> list:
    """n finished requests drawn from the seed, the longest among them."""
    done = [r for r in recs if r.finished]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.prompt) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = tr.rng_for(seed, 5)
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_readings(cfg, mix, seed, recs, device,
                       control: bool = False) -> tuple:
    """(readings, the control's readings or None): the gaps of each served
    token's logit below the reference's best, over the sample, on this
    process's device (the serving process has ended). With `control`, the
    control's too: at the same positions, the gap of the token the
    reference computed in fp8 puts first."""
    sample = sample_requests(recs, seed, int(mix["sample_requests"]))
    if not sample:
        return {}, None
    gc.collect()
    reference.plain_float32()
    params = weights.make_params(cfg, seed, device)
    seqs, rows = [], []
    for r in sample:
        toks = r.req.prompt + r.tokens[:-1]
        seqs.append(torch.tensor(toks, dtype=torch.long, device=device))
        p = len(r.req.prompt)
        rows.append(torch.arange(p - 1, p - 1 + len(r.tokens), device=device))
    logits = reference.logits_at(cfg, params, seqs, rows)
    gaps = []
    for lg, r in zip(logits, sample):
        gaps.extend(compare.served_gaps(lg, r.tokens))
    out, ctrl = compare.gap_readings(gaps), None
    if control:
        low = reference.logits_at(cfg, params, seqs, rows, precision="fp8")
        ctrl = compare.gap_readings(
            [g for lg, lo in zip(logits, low)
             for g in compare.served_gaps(lg, lo.argmax(-1).tolist())])
        del low
    del params, logits
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out, ctrl
