"""Prometheus text exposition (version 0.0.4): the encoder and its parser.

The port's copy of `tony_tpu/observability/prometheus.py`, byte for byte
in what it emits: name sanitization, label escaping, NaN/±Inf formatting
and the ``tony_`` namespace of task gauges are those of the JAX package,
so a scraper and the AM read a port replica's ``/metrics`` as they read
the JAX one's. `parse` reads back exactly what `render` emits.

A *family* is ``{"name": str, "type": "counter"|"gauge"|"untyped",
"help": str, "samples": [(labels_dict, value), ...]}``, the shape
``MetricsRegistry.families()`` produces.
"""

from __future__ import annotations

import math
import re
from typing import Iterable

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def sanitize_metric_name(name: str) -> str:
    """Any string → a legal metric name: illegal chars become ``_``, a
    leading digit gets a ``_`` prefix, empty becomes ``_``. Gauge names
    arriving from tasks (``SERVING_TTFT_P50_S``…) are lowercased and
    prefixed ``tony_`` so the whole exposition shares one namespace."""
    name = _NAME_BAD_CHARS.sub("_", str(name))
    if not name:
        name = "_"
    if name[0].isdigit():
        name = "_" + name
    return name


def task_metric_name(name: str) -> str:
    """A task-pushed gauge name (``TPU_HBM_BYTES_IN_USE``) → the
    exposition name (``tony_tpu_hbm_bytes_in_use``)."""
    n = sanitize_metric_name(name).lower()
    return n if n.startswith("tony_") else "tony_" + n


def sanitize_label_name(name: str) -> str:
    name = _LABEL_BAD_CHARS.sub("_", str(name))
    if not name:
        name = "_"
    if name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _unescape_label_value(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def format_value(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render(families: Iterable[dict]) -> str:
    """Families → exposition text. Names/labels are sanitized here so
    callers can pass raw gauge names straight through."""
    lines: list[str] = []
    for fam in families:
        name = sanitize_metric_name(fam["name"])
        ftype = fam.get("type", "untyped")
        if ftype not in ("counter", "gauge", "untyped"):
            ftype = "untyped"
        if fam.get("help"):
            help_text = str(fam["help"]).replace("\\", r"\\").replace(
                "\n", r"\n")
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {ftype}")
        for labels, value in fam.get("samples", []):
            if labels:
                rendered = ",".join(
                    f'{sanitize_label_name(k)}="{escape_label_value(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{rendered}}} {format_value(value)}")
            else:
                lines.append(f"{name} {format_value(value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(raw: str) -> float:
    if raw == "NaN":
        return float("nan")
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


def parse(text: str) -> dict[tuple[str, tuple], float]:
    """Exposition text → {(name, ((label, value), ...)): value}.
    Raises ValueError on a malformed sample line — the tests use this as
    the validity check on everything the encoders emit."""
    out: dict[tuple[str, tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {line!r}")
        labels_raw = m.group("labels") or ""
        labels = tuple(sorted(
            (k, _unescape_label_value(v))
            for k, v in _LABEL_RE.findall(labels_raw)))
        out[(m.group("name"), labels)] = _parse_value(m.group("value"))
    return out


def get_sample(parsed: dict, name: str, **labels) -> float:
    """Convenience lookup into ``parse()`` output (test + bench helper):
    the first sample of ``name`` whose labels are a superset of the ones
    given. KeyError when absent."""
    want = set(labels.items())
    for (n, ls), v in parsed.items():
        if n == name and want.issubset(set(ls)):
            return v
    raise KeyError(f"{name}{labels or ''} not in exposition")
