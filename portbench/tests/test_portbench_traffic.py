"""The one generator: seeded, deterministic, the same work on every seed;
and the percentiles taken over every request."""

import math

import numpy as np

from portbench import traffic as tr
from portbench.serve_cell import Record, percentile, summarize

OPEN = {"rate_per_s": 4.0,
        "prompt": {"dist": "lognormal", "median": 1024, "sigma": 0.8,
                   "min": 128, "max": 4096},
        "answer": {"dist": "uniform", "min": 4, "max": 16}}


def test_open_loop_is_deterministic_per_seed():
    a = tr.open_loop(OPEN, 2**31 + 11, 51, 32000)
    b = tr.open_loop(OPEN, 2**31 + 11, 51, 32000)
    assert [(r.prompt, r.max_new, r.due_s) for r in a] == \
        [(r.prompt, r.max_new, r.due_s) for r in b]


def test_seeds_permute_the_same_work():
    a = tr.open_loop(OPEN, 5, 51, 32000)
    b = tr.open_loop(OPEN, 2**40 + 3, 51, 32000)
    assert len(a) == len(b) == math.ceil(4.0 * 51)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in b)
    assert sorted(r.max_new for r in a) == sorted(r.max_new for r in b)
    gaps = lambda rs: sorted(np.round(np.diff([r.due_s for r in rs]), 9))
    assert gaps(a)[1:] != [] and [r.prompt for r in a] != [r.prompt
                                                            for r in b]
    # the same arrival gaps, in another order (the first is dropped: the
    # schedule starts at the first arrival)
    assert len(set(gaps(a)) ^ set(gaps(b))) <= 2


def test_lengths_follow_the_mix():
    q = tr.quantiles(OPEN["prompt"], 1000)
    assert q.min() >= 128 and q.max() <= 4096
    assert abs(np.median(q) - 1024) <= 2
    u = tr.quantiles(OPEN["answer"], 1300)
    assert set(u) == set(range(4, 17))


def test_closed_loop_clients_start_spread():
    mix = dict(OPEN, clients=8, per_client=3,
               answer={"dist": "uniform", "min": 256, "max": 1024})
    streams = tr.closed_loop(mix, 9, 32768)
    assert len(streams) == 8 and all(len(s) == 3 for s in streams)
    firsts = [s[0].max_new for s in streams]
    assert min(firsts) < 256 and max(firsts) <= 1024


def test_train_batches_rows_all_differ():
    mix = {"batch": 2, "seq": 4096}
    b1, b2 = tr.first_batches(mix, 2**33, 32768, 2)
    rows = [tuple(r) for b in (b1, b2) for r in b["tokens"]]
    assert len(set(rows)) == 4
    assert b1["tokens"].shape == (2, 4097) and b1["tokens"].dtype == np.int32


def test_percentile_is_nearest_rank_over_every_value():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2, math.inf], 50) == 2
    assert percentile([1, 2, math.inf], 95) == math.inf


def _rec(prompt, due, arrivals, max_new=None, error=None):
    r = Record(tr.Request(0, [1] * prompt, max_new or len(arrivals)))
    r.due, r.arrivals, r.error = due, arrivals, error
    r.tokens = [0] * len(arrivals)
    r.finished = error is None
    return r


def test_a_failed_request_counts_as_missing_the_tail():
    recs = [_rec(8, 0.0, [0.1 + 0.01 * i, 0.2 + 0.01 * i]) for i in range(9)]
    recs.append(_rec(8, 0.0, [], max_new=2, error="HTTP 429"))
    marks = {"start": {"t": 0, "decode_steps": 0},
             "end": {"t": 10, "decode_steps": 5}}
    fin = {"peak_bytes": 0, "forbidden": [], "trace": None, "requests": []}
    out = summarize(recs, 0.0, 10.0, {"loop": "open", "slots": 4}, marks,
                    fin)
    assert out["failed"] == 1
    assert out["e2e"]["ttft_p95_ms"] == math.inf
    recs[-1] = _rec(8, 0.0, [5.0, 5.1])
    out = summarize(recs + recs[:10], 0.0, 10.0,
                    {"loop": "open", "slots": 4}, marks, fin)
    # 20 requests: the 19th value in order is the p95, not an average
    assert out["e2e"]["ttft_p95_ms"] == 1000 * 5.0
    assert out["e2e"]["ttft_p50_ms"] == 1000 * 0.14


def test_every_stretch_of_an_open_loop_offers_the_same_mix():
    """What a window cuts off is the same work on every seed: the prompt
    tokens of each prefix of the schedule agree across seeds."""
    mix = dict(OPEN, rate_per_s=6.0)
    prefix = [np.cumsum([len(r.prompt) for r in tr.open_loop(mix, s, 51,
                                                              32000)])
              for s in (1, 2**31 + 3, 2**45)]
    for k in (128, 229):
        vals = [p[k] for p in prefix]
        assert max(vals) / min(vals) < 1.05
    assert len({p[-1] for p in prefix}) == 1
