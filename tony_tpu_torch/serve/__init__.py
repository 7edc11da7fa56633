"""Online serving: continuous-batching engine over the KV-cache decode
core (models/generate.py), fronted by an HTTP server.

Exports resolve lazily (PEP 562), so `python -m tony_tpu_torch.serve
--help` parses flags without importing torch.
"""

_EXPORTS = {
    "BudgetExceededError": "tony_tpu_torch.serve.engine",
    "ContinuousBatchingEngine": "tony_tpu_torch.serve.engine",
    "QueueFullError": "tony_tpu_torch.serve.engine",
    "RequestHandle": "tony_tpu_torch.serve.engine",
    "ServeFrontend": "tony_tpu_torch.serve.frontend",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)
