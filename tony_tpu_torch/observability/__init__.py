"""The port's reports to the orchestrator: health registry, Prometheus
exposition, lifecycle spans, goodput, request traces, structured logs and
the sampling profiler."""
