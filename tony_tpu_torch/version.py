"""Build/version stamping: the port's copy of `tony_tpu/version.py`.

Equivalent of the reference's util/VersionInfo.java:28-130, which injected
build metadata (version, git ref, build user/time) into the job conf at
submission (TonyClient.java:152) so every process and the portal could
report which build ran a job.
"""

from __future__ import annotations

import getpass
import os
import subprocess
import time

VERSION = "0.1.0"

# tony: disable=config-key-registry -- metadata-stamp prefix, not a conf key
_KEY_PREFIX = "tony.version"


def _git(*args: str) -> str:
    try:
        # the framework's own checkout, not the submitter's cwd — this
        # stamps which BUILD ran the job
        out = subprocess.run(
            ["git", *args],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError):  # incl. TimeoutExpired
        return "unknown"


def _git_ref() -> str:
    return _git("rev-parse", "--short", "HEAD")


def _build_time() -> str:
    """The commit date of the running checkout — stable across submissions
    of the same build (a wall clock would make two submissions of one
    checkout report different 'builds'). Falls back to the current time
    (flagged as submit-time) outside a git checkout."""
    commit_date = _git("show", "-s", "--format=%cI", "HEAD")
    if commit_date != "unknown":
        return commit_date
    return time.strftime("%Y-%m-%dT%H:%M:%S") + " (submit-time)"


def _user() -> str:
    try:
        return getpass.getuser()
    except (KeyError, OSError):  # containers with no passwd entry for UID
        return "unknown"


def stamp_conf(conf) -> None:
    """Write version metadata into the conf (TonyClient.java:152 analogue);
    lands in tony-final.json and the portal's /config page."""
    conf.set(f"{_KEY_PREFIX}", VERSION, "version-info")
    conf.set(f"{_KEY_PREFIX}.git-ref", _git_ref(), "version-info")
    conf.set(f"{_KEY_PREFIX}.user", _user(), "version-info")
    conf.set(f"{_KEY_PREFIX}.build-time", _build_time(), "version-info")
