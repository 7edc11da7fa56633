"""Atomic JSON files: the port's copy of `write_json_atomic` from
`tony_tpu/events/history.py` (the executor relays a profile request to
its user process through one)."""

from __future__ import annotations

import json
import os
from typing import Any


def write_json_atomic(path: str, obj: Any) -> None:
    """Write `obj` as JSON to a temporary file beside `path` and rename it
    over `path`: a reader sees the old file or the whole new one."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
