"""Cascading configuration: defaults ← job conf file ← CLI overrides ← site.

The port's copy of `tony_tpu/conf/configuration.py`: the same layering,
getters and frozen `tony-final.json` format, so either package reads the
file the other wrote. The description below is the original's.

Equivalent of the reference's Hadoop-XML cascade
(TonyClient.initTonyConf, TonyClient.java:483-517):

    tony-default.xml  ←  user tony.xml / -conf_file  ←  -conf k=v  ←  tony-site.xml

re-done idiomatically: JSON (or `k=v` properties) files, per-key source
tracking for the portal's config page (models/JobConfig), multi-value keys
appended rather than replaced (TonyConfigurationKeys.java:285-287), typed
getters with duration/memory-string parsing (util/Utils.java:145-156), and a
frozen `tony-final.json` artifact shipped to every process
(TonyClient.processFinalTonyConf, TonyClient.java:189-228).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterator

from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.defaults import DEFAULTS

_TIME_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h|d)?\s*$", re.IGNORECASE)
_MEM_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgt])?b?\s*$", re.IGNORECASE)
_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off", ""}


def parse_time_ms(value: Any) -> int:
    """Parse '500ms' / '5s' / '2m' / '1h' / bare number (= ms) into milliseconds."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _TIME_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse duration: {value!r}")
    num = float(m.group(1))
    unit = (m.group(2) or "ms").lower()
    mult = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}[unit]
    return int(num * mult)


def parse_memory_mb(value: Any) -> int:
    """Parse '2g' / '512m' / '2048' (MB) into MB (reference: Utils.parseMemoryString,
    util/Utils.java:145-156)."""
    if isinstance(value, (int, float)):
        return int(value)
    m = _MEM_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse memory string: {value!r}")
    num = float(m.group(1))
    unit = (m.group(2) or "m").lower()
    mult = {"k": 1 / 1024, "m": 1, "g": 1024, "t": 1024 * 1024}[unit]
    mb = num * mult
    # round sub-MB values up so a nonzero request never becomes a 0-MB ask
    return max(1, int(mb)) if mb > 0 else 0


class TonyConfiguration:
    """Layered key→value store with per-key source attribution."""

    def __init__(self, load_defaults: bool = True):
        self._values: dict[str, Any] = {}
        self._sources: dict[str, str] = {}
        if load_defaults:
            for k, v in DEFAULTS.items():
                self._values[k] = v
                self._sources[k] = "default"

    # -- mutation ---------------------------------------------------------
    def set(self, key: str, value: Any, source: str = "programmatic") -> None:
        if key in K.MULTI_VALUE_CONF and key in self._values and \
                self._sources.get(key) != "default":
            # append semantics for multi-value keys (TonyClient.java:498-510)
            existing = self.get_strings(key)
            if isinstance(value, (list, tuple)):
                new = [str(v).strip() for v in value if str(v).strip()]
            else:
                new = [v.strip() for v in str(value).split(",") if v.strip()]
            merged = existing + [v for v in new if v not in existing]
            self._values[key] = ",".join(merged)
            self._sources[key] = f"{self._sources[key]}+{source}"
        else:
            self._values[key] = value
            self._sources[key] = source

    def merge_dict(self, d: dict[str, Any], source: str) -> None:
        for k, v in d.items():
            self.set(k, v, source)

    def merge_file(self, path: str, source: str | None = None) -> None:
        """Merge a JSON object file or a `key=value`-per-line properties file."""
        source = source or os.path.basename(path)
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        stripped = text.lstrip()
        if stripped.startswith("{"):
            self.merge_dict(json.loads(text), source)
        else:
            for line in text.splitlines():
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    raise ValueError(f"{path}: bad properties line: {line!r}")
                k, _, v = line.partition("=")
                self.set(k.strip(), v.strip(), source)

    def merge_cli(self, overrides: list[str], source: str = "cli") -> None:
        """Merge `-conf k=v` style overrides (TonyClient.java:379-400)."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"bad -conf override (expected k=v): {item!r}")
            k, _, v = item.partition("=")
            self.set(k.strip(), v.strip(), source)

    def merge_site(self) -> None:
        """Merge $TONY_CONF_DIR/tony-site.json if present (TonyClient.java:512-516)."""
        conf_dir = os.environ.get(C.TONY_CONF_DIR_ENV)
        if conf_dir:
            site = os.path.join(conf_dir, C.TONY_SITE_CONF)
            if os.path.exists(site):
                self.merge_file(site, source="site")

    # -- typed getters ----------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def get_str(self, key: str, default: str = "") -> str:
        v = self._values.get(key, default)
        return "" if v is None else str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._values.get(key)
        if v is None or v == "":
            return default
        return int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._values.get(key)
        if v is None or v == "":
            return default
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._values.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        s = str(v).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"cannot parse bool for {key}: {v!r}")

    def get_time_ms(self, key: str, default: int = 0) -> int:
        v = self._values.get(key)
        return default if v is None or v == "" else parse_time_ms(v)

    def get_memory_mb(self, key: str, default: int = 0) -> int:
        v = self._values.get(key)
        return default if v is None or v == "" else parse_memory_mb(v)

    def get_strings(self, key: str) -> list[str]:
        """Comma-separated list getter."""
        v = self._values.get(key)
        if v is None or v == "":
            return []
        if isinstance(v, (list, tuple)):
            return [str(x) for x in v]
        return [s.strip() for s in str(v).split(",") if s.strip()]

    def source_of(self, key: str) -> str:
        return self._sources.get(key, "unset")

    # -- dynamic jobtype keys --------------------------------------------
    def job_types(self) -> list[str]:
        """All jobtypes declared via `tony.<jobtype>.instances`
        (reference regex: TonyConfigurationKeys.java:171)."""
        out = []
        for key in self._values:
            m = K.JOBTYPE_INSTANCES_RE.match(key)
            if m and m.group(1) not in K.RESERVED_SEGMENTS:
                out.append(m.group(1))
        return sorted(out)

    # -- iteration / serialization ---------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._values))

    def items(self):
        return sorted(self._values.items())

    def to_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def entries_with_sources(self) -> list[tuple[str, Any, str]]:
        """(key, value, source) rows for the portal config page."""
        return [(k, self._values[k], self._sources.get(k, "unset"))
                for k in sorted(self._values)]

    def write(self, path: str) -> None:
        """Freeze to the tony-final.json artifact (TonyClient.java:219-227)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {"values": self._values, "sources": self._sources}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def from_env(cls, env=None) -> "TonyConfiguration":
        """The frozen file `TONY_CONF_PATH` names (what the executor hands
        its task), else the defaults alone."""
        e = env if env is not None else os.environ
        path = e.get(C.TONY_CONF_PATH, "")
        return cls.read(path) if path and os.path.exists(path) else cls()

    @classmethod
    def read(cls, path: str) -> "TonyConfiguration":
        """Load a frozen tony-final.json (ApplicationMaster.java:215,
        TaskExecutor.java:269 read-back equivalent)."""
        conf = cls(load_defaults=False)
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        if "values" in payload:
            conf._values = dict(payload["values"])
            conf._sources = dict(payload.get("sources", {}))
        else:  # plain JSON object also accepted
            conf._values = dict(payload)
            conf._sources = {k: os.path.basename(path) for k in payload}
        return conf
