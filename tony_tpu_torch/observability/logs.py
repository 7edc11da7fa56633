"""Structured task logs and the redaction of what leaves the task.

The port's copy of the task-side half of `tony_tpu/observability/logs.py`:
- `configure_structured_logging` installs a JSON-lines root handler whose
  every record is stamped ``{app_id, task_type, index, attempt,
  trace_id}`` from the environment the executor rendered, so a log line
  joins the span waterfall (``TONY_LOG_PLAIN=1`` keeps the plain format);
- `redact` strips credential-shaped material (64-hex tokens,
  ``*TOKEN=``-style assignments, ``Bearer`` credentials) from anything
  that leaves the process: request-trace attributes, stack snapshots,
  log chunks;
- the executor's live tail and post-mortem: `LogTail`, a bounded
  offset-cursor reader over the container's stdout or stderr (chunks end
  on a line, so redaction sees whole lines); `classify`, the table of
  error signatures matched against the last matching line of a tail;
  `decode_exit`, exit code to signal; and `classify_container_failure`,
  the diagnostics a failing result carries to the AM.
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal as _signal
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


# ---------------------------------------------------------------------------
# error-signature classification
# ---------------------------------------------------------------------------

# Ordered (first match wins within a line; across the tail the LAST
# matching line wins — failures print last). Each entry:
# (signature, compiled regex, operator hint).
SIGNATURES: tuple[tuple[str, "re.Pattern[str]", str], ...] = (
    ("device_oom",
     re.compile(r"RESOURCE_EXHAUSTED|out of memory|OutOfMemory"
                r"|Failed to allocate|exceeds the amount of (?:HBM|memory)"
                r"|hbm_?budget|OOM (?:when|while)", re.IGNORECASE),
     "device/host memory exhausted — shrink the batch/model shard or "
     "raise per-task memory"),
    ("xla_compile_failure",
     re.compile(r"XlaRuntimeError|Mosaic (?:lowering|failed)"
                r"|INTERNAL: .*[Cc]ompil|RET_CHECK failure.*xla"
                r"|pallas.*lowering (?:error|failed)"),
     "XLA/Mosaic compilation failed — usually a shape/layout or kernel "
     "lowering problem, not a data fault"),
    ("rendezvous_timeout",
     re.compile(r"gang rendezvous timed out|re-rendezvous never completed"
                r"|barrier timeout|DEADLINE_EXCEEDED.*(?:rendezvous|barrier)"
                r"|failed to connect to coordination service",
                re.IGNORECASE),
     "the gang barrier never completed — a peer is missing or "
     "allocation is starved; no relaunch budget is spent on this"),
    ("nan_loss",
     re.compile(r"loss (?:is|became|went) (?:nan|non-finite)"
                r"|\bNaN\b.*loss|loss.*\bNaN\b|non-finite (?:loss|gradient)",
                re.IGNORECASE),
     "training diverged (non-finite loss) — lower the LR or enable "
     "gradient clipping; a relaunch will diverge again"),
    # deadlock before stall (more specific), both before preempted: a
    # wedged task the AM kills also prints SIGTERM/Killed, and the wedge
    # — not the kill — is the root cause the operator must chase
    ("deadlock",
     re.compile(r"deadlock|would block.*lock|lock ordering"
                r"|acquire.*already (?:held|locked)", re.IGNORECASE),
     "threads are mutually blocked on locks — the stacks section of "
     "diagnostics.json names every thread's blocking frame; fix the "
     "lock ordering, relaunching only postpones the next wedge"),
    ("stall",
     re.compile(r"PROCESS_STALL_DETECTED|stall(?:ed)? (?:detected|for)"
                r"|watchdog.*(?:stale|wedge)|wedged?\b"
                r"|missed \d+ heartbeats?|heartbeats? for [\d.]+s",
                re.IGNORECASE),
     "the process stopped making progress (wedged, not crashed) — the "
     "stacks section of diagnostics.json names the blocking frame the "
     "stall watchdog captured; look there before blaming the kill "
     "signal"),
    ("preempted",
     re.compile(r"SIGTERM|SIGKILL|Killed\b|preempt(?:ed|ion)"
                r"|killed by the (?:AM|scheduler)", re.IGNORECASE),
     "the process was terminated by signal — preemption or an operator "
     "stop, not a code fault"),
    ("import_error",
     re.compile(r"ModuleNotFoundError|ImportError"
                r"|No module named"),
     "a dependency is missing in the container image/venv — fix "
     "localization (tony.python.venv / resources), relaunching won't help"),
)


def signature_hint(name: str) -> str:
    for sig, _, hint in SIGNATURES:
        if sig == name:
            return hint
    return ""


def classify(text: str) -> Optional[dict]:
    """Match the signature table against a log excerpt. Scans bottom-up so
    the LAST matching line wins (the terminal error, not an earlier
    warning that happened to share words). Returns
    ``{"signature", "hint", "line"}`` or None."""
    if not text:
        return None
    for line in reversed(text.splitlines()):
        for name, pattern, hint in SIGNATURES:
            if pattern.search(line):
                return {"signature": name, "hint": hint,
                        "line": redact(line.strip())[:400]}
    return None


def decode_exit(exit_code: Optional[int]) -> dict:
    """Exit-code → signal attribution: a negative Popen returncode is
    -signum; a shell-style 128+signum also decodes. SIGKILL is the
    preemption/OOM-killer fingerprint, SIGTERM the graceful stop."""
    out: dict = {"exit_code": exit_code, "signal": 0, "signal_name": ""}
    if exit_code is None:
        return out
    signum = 0
    if exit_code < 0:
        signum = -exit_code
    elif 128 < exit_code < 160:
        signum = exit_code - 128
    if signum:
        out["signal"] = signum
        try:
            out["signal_name"] = _signal.Signals(signum).name
        except ValueError:
            out["signal_name"] = f"SIG{signum}"
    return out


# ---------------------------------------------------------------------------
# bounded tail / offset-cursor chunk reads
# ---------------------------------------------------------------------------

DEFAULT_TAIL_BYTES = 65536
DEFAULT_CHUNK_BYTES = 32768
STREAMS = ("stdout", "stderr")


class LogTail:
    """Bounded reader over one stream file (a container's stdout or
    stderr). Memory is bounded on BOTH ends of a follow stream:

    - a fresh cursor (``offset < 0``) starts at ``size - tail_bytes``,
      never at 0 — a gigabyte of history costs nothing;
    - each read returns at most ``chunk_bytes`` (callers may ask for
      less, never more);
    - unless the stream is final, a chunk is cut at its last newline so
      a partial line is held back until complete — redaction always sees
      whole lines, so a credential can never straddle a chunk boundary
      and slip through half-redacted.
    """

    def __init__(self, path: str, tail_bytes: int = DEFAULT_TAIL_BYTES,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.path = path
        self.tail_bytes = max(1024, int(tail_bytes))
        self.chunk_bytes = max(256, int(chunk_bytes))

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def read_chunk(self, offset: int = -1, max_bytes: int = 0,
                   final: bool = False) -> dict:
        """One bounded chunk from ``offset`` (cursor semantics: pass the
        returned ``next_offset`` back to continue). ``final=True`` means
        the writer is done (process exited): partial last lines are
        delivered instead of held back. Returns
        ``{data, offset, next_offset, size, eof}`` with ``data``
        redacted text."""
        limit = min(max_bytes, self.chunk_bytes) if max_bytes > 0 \
            else self.chunk_bytes
        size = self.size()
        if offset is None or offset < 0:
            offset = max(0, size - self.tail_bytes)
        offset = min(offset, size)
        try:
            with open(self.path, "rb") as f:
                f.seek(offset)
                raw = f.read(limit)
        except OSError:
            raw = b""
        at_end = offset + len(raw) >= size
        if raw and not (final and at_end):
            # EVERY non-terminal chunk ends on a line boundary — mid-file
            # boundaries included, or a credential straddling two chunks
            # would ship half-redacted. The unterminated tail line is
            # held back until the writer finishes it (or the stream goes
            # final). One escape hatch: a single line longer than the
            # chunk ships whole-chunk (progress must be guaranteed; a
            # >chunk_bytes line is pathological and documented).
            cut = raw.rfind(b"\n")
            if cut >= 0:
                raw = raw[:cut + 1]
            elif len(raw) < limit:
                raw = b""
        next_offset = offset + len(raw)
        data = redact(raw.decode("utf-8", errors="replace"))
        return {"data": data, "offset": offset,
                "next_offset": next_offset, "size": size,
                "eof": final and next_offset >= size}

    def tail_lines(self, max_lines: int,
                   max_bytes: int = 0) -> list[str]:
        """The last ``max_lines`` lines (redacted), reading at most
        ``max_bytes`` (default: the tail window) from the file end —
        the diagnostics-excerpt primitive."""
        window = min(max_bytes or self.tail_bytes, self.tail_bytes)
        size = self.size()
        start = max(0, size - window)
        try:
            with open(self.path, "rb") as f:
                f.seek(start)
                raw = f.read(window)
        except OSError:
            return []
        text = raw.decode("utf-8", errors="replace")
        if start > 0:
            # drop the partial first line a mid-file seek landed in
            text = text.split("\n", 1)[-1]
        lines = [redact(ln) for ln in text.splitlines()]
        return lines[-max_lines:]


def tail_excerpt(container_dir: str, max_lines: int,
                 tail_bytes: int = DEFAULT_TAIL_BYTES) -> dict[str, list[str]]:
    """Redacted last-lines excerpt per stream for one container dir —
    what ships in a failure report / diagnostics bundle. Missing or
    empty streams are omitted."""
    out: dict[str, list[str]] = {}
    for stream in STREAMS:
        path = os.path.join(container_dir, stream)
        if not os.path.isfile(path):
            continue
        lines = LogTail(path, tail_bytes=tail_bytes).tail_lines(max_lines)
        if lines:
            out[stream] = lines
    return out


def classify_container_failure(container_dir: str, exit_code: Optional[int],
                               max_lines: int,
                               tail_bytes: int = DEFAULT_TAIL_BYTES) -> dict:
    """One-stop failure record body: exit/signal decoding + tail excerpt
    + signature classification over that excerpt (stderr preferred —
    tracebacks land there). Used by the executor's failure report and by
    the AM when a container died without reporting."""
    record = decode_exit(exit_code)
    tails = tail_excerpt(container_dir, max_lines, tail_bytes=tail_bytes)
    record["tail"] = tails
    text = "\n".join(tails.get("stderr", []) + tails.get("stdout", []))
    sig = classify(text)
    if sig is None and record.get("signal_name") in ("SIGKILL", "SIGTERM"):
        sig = {"signature": "preempted",
               "hint": signature_hint("preempted"),
               "line": f"exit by {record['signal_name']}"}
    if sig is not None:
        record.update(sig)
    return record


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
                                 level: int = logging.INFO,
                                 **extra) -> logging.Handler:
    """Install the structured handler as THE root handler of the process
    (the port's AM, trainer and server). Context comes from the env
    contract (APP_ID/JOB_NAME/TASK_INDEX/TASK_ATTEMPT/TONY_TRACE_ID) plus
    ``extra`` overrides. ``TONY_LOG_PLAIN=1`` falls back to the classic
    human format for interactive debugging."""
    e = env if env is not None else os.environ
    root = logging.getLogger()
    root.setLevel(level)
    if str(e.get(PLAIN_LOGS_ENV, "")).lower() in ("1", "true", "yes"):
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
        return root.handlers[0]
    ctx = log_context_from_env(e)
    ctx.update({k: v for k, v in extra.items() if v not in (None, "")})
    handler = StructuredLogHandler(ctx, stream=stream)
    root.handlers[:] = [handler]
    return handler
