"""The 95th percentile of the engine's `queue_wait_s` (submission to a
free slot's dequeue) over the requests submitted in the span the counters
cover (the window, or in a traced run its part before the trace). Offered
above capacity, the queue grows through the window: this reads how far."""

from portbench.serve_cell import percentile


def read(ctx):
    waits = ctx["result"]["counters"]["queue_wait_s"]
    if not waits:
        return None
    return 1000.0 * percentile(waits, 95)
