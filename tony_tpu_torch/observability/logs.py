"""Structured task logs and the redaction of what leaves the task.

The port's copy of the task-side half of `tony_tpu/observability/logs.py`:
- `configure_structured_logging` installs a JSON-lines root handler whose
  every record is stamped ``{app_id, task_type, index, attempt,
  trace_id}`` from the environment the executor rendered, so a log line
  joins the span waterfall (``TONY_LOG_PLAIN=1`` keeps the plain format);
- `redact` strips credential-shaped material (64-hex tokens,
  ``*TOKEN=``-style assignments, ``Bearer`` credentials) from anything
  that leaves the process: request-trace attributes, stack snapshots.

The live tail and the failure classifier stay the AM's and the
executor's.
"""

from __future__ import annotations

import json
import logging
import os
import re
import sys
from typing import Optional

from tony_tpu_torch.constants import PLAIN_LOGS_ENV

# ---------------------------------------------------------------------------
# redaction
# ---------------------------------------------------------------------------

# The token scheme (security/tokens.py) mints 64-hex app secrets and
# HMAC-SHA256 task/proxy tokens — also 64 hex chars. Any such run is
# treated as a credential wherever it appears.
_HEX_TOKEN_RE = re.compile(r"\b[0-9a-fA-F]{64}\b")
# KEY=value / KEY: value assignments whose key smells like a secret
# (TONY_SECURITY_TOKEN, *_SECRET, api-key, password, ...)
_ASSIGN_RE = re.compile(
    r"(?P<key>[A-Za-z0-9_\-\.]*(?:token|secret|password|passwd|credential"
    r"|api[-_]?key)[A-Za-z0-9_\-\.]*)(?P<sep>\s*[=:]\s*)(?P<val>\S+)",
    re.IGNORECASE)
_BEARER_RE = re.compile(r"(?P<scheme>\bBearer\s+)\S+")

REDACTED = "<redacted>"


def redact(text: str) -> str:
    """Strip credential-shaped material from text that leaves the
    container (live tail chunks, diagnostics excerpts). Applied line-wise
    by callers that stream, so a chunk boundary can never split a match
    (chunks end on line boundaries — LogTail.read_chunk)."""
    if not text:
        return text
    text = _ASSIGN_RE.sub(lambda m: m.group("key") + m.group("sep")
                          + REDACTED, text)
    text = _BEARER_RE.sub(lambda m: m.group("scheme") + REDACTED, text)
    return _HEX_TOKEN_RE.sub(REDACTED, text)


class StructuredLogHandler(logging.Handler):
    """JSON-lines handler for control-plane processes. Each record:

    ``{"ts_ms", "level", "logger", "message", "app_id", "task_type",
    "index", "attempt", "trace_id"}``

    The context block is constant per process (it identifies the
    principal) so log lines correlate with spans (same trace_id) and
    with the portal's task pages (same app_id/task_type/index/attempt).
    The human-readable message stays intact inside ``message`` — greps
    and the chaos harness's log regexes keep working."""

    def __init__(self, context: Optional[dict] = None, stream=None):
        super().__init__()
        self.context = {k: v for k, v in (context or {}).items()
                        if v not in (None, "")}
        self.stream = stream if stream is not None else sys.stderr

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "ts_ms": int(record.created * 1000),
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
            }
            if record.exc_info and record.exc_info[0] is not None:
                entry["exc"] = logging.Formatter().formatException(
                    record.exc_info)[-2000:]
            entry.update(self.context)
            self.stream.write(json.dumps(entry, ensure_ascii=False) + "\n")
            self.stream.flush()
        except Exception:  # noqa: BLE001 — logging must never raise
            self.handleError(record)


def log_context_from_env(env=None) -> dict:
    """The per-process identity block, from the env the AM/executor
    rendered: app_id, task_type/index/attempt (executors), trace_id."""
    from tony_tpu_torch import constants as C
    e = env if env is not None else os.environ
    ctx = {
        "app_id": e.get(C.APP_ID, ""),
        "task_type": e.get(C.JOB_NAME, ""),
        "trace_id": e.get(C.TONY_TRACE_ID, ""),
    }
    if e.get(C.TASK_INDEX, "") != "":
        try:
            ctx["index"] = int(e[C.TASK_INDEX])
        except ValueError:
            pass
    if e.get(C.TASK_ATTEMPT, "") != "":
        try:
            ctx["attempt"] = int(e[C.TASK_ATTEMPT])
        except ValueError:
            pass
    return ctx


def configure_structured_logging(env=None, stream=None,
                                 level: int = logging.INFO
                                 ) -> logging.Handler:
    """Install the structured handler as THE root handler of the process
    (the port's trainer and server). Context comes from the env contract
    (APP_ID/JOB_NAME/TASK_INDEX/TASK_ATTEMPT/TONY_TRACE_ID).
    ``TONY_LOG_PLAIN=1`` falls back to the classic human format for
    interactive debugging."""
    e = env if env is not None else os.environ
    root = logging.getLogger()
    root.setLevel(level)
    if str(e.get(PLAIN_LOGS_ENV, "")).lower() in ("1", "true", "yes"):
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
        return root.handlers[0]
    handler = StructuredLogHandler(log_context_from_env(e), stream=stream)
    root.handlers[:] = [handler]
    return handler
