"""A flat keyed blob namespace on a `gs://` bucket, through its CLI.

The port's own copy of what its checkpoints need from
`tony_tpu/storage/store.py` (which it does not import): `StagingStore`,
the interface, and `GCSStore`, the object store behind a `gs://`
checkpoint directory, with the reference's behaviour kept exactly:
- the CLI is `gsutil` when it is on PATH, else `gcloud storage`; neither
  raises FileNotFoundError;
- `fetch` downloads into a temporary file and renames it, so a killed
  download never leaves a torn file behind;
- `_ls` tells "matched no objects" (an empty listing) from a real failure
  (authentication, network, a missing bucket), which raises: a resuming
  trainer that read a transient failure as "no checkpoints" would restart
  from step 0 and overwrite the good ones;
- `delete` treats an object that is already gone as deleted.
"""

from __future__ import annotations

import abc
import os
import shutil
import subprocess
import uuid

# the CLI's stderr when a name or pattern matched nothing
_NO_MATCH = ("matched no objects", "no urls matched", "not found")


def _tmp_suffix() -> str:
    """Unique per use (pid and a random part): two threads of one process
    fetching the same destination must not share a temporary name."""
    return f"{os.getpid()}-{uuid.uuid4().hex[:12]}"


class StagingStore(abc.ABC):
    """A flat keyed blob namespace."""

    @abc.abstractmethod
    def put(self, local_path: str, key: str) -> str:
        """Upload `local_path` under `key`; returns its URI."""

    @abc.abstractmethod
    def fetch(self, uri: str, dest_path: str) -> str:
        """Download `uri` to `dest_path` (parent directories created);
        returns dest_path."""

    @abc.abstractmethod
    def exists(self, uri: str) -> bool: ...

    @abc.abstractmethod
    def list_keys(self, prefix: str = "") -> list[str]:
        """Keys (relative to the store's base) under `prefix`,
        recursively."""

    @abc.abstractmethod
    def uri(self, key: str) -> str:
        """The fetchable URI of a key."""

    @abc.abstractmethod
    def glob(self, pattern: str) -> list[str]:
        """Keys matching a shell-style pattern relative to the base (e.g.
        "step_*/COMMIT"): a targeted listing, not a walk of the tree."""

    def delete(self, key: str) -> None:
        """Remove one object by key (relative to the base)."""
        raise NotImplementedError(f"{type(self).__name__} cannot delete")


class GCSStore(StagingStore):
    """Objects under a `gs://bucket/prefix` base, through the gsutil or
    `gcloud storage` CLI on PATH (no client library)."""

    def __init__(self, base_uri: str):
        if not base_uri.startswith("gs://"):
            raise ValueError(f"GCSStore needs a gs:// base, got {base_uri!r}")
        self.base = base_uri.rstrip("/")
        self._cli = self._find_cli()

    @staticmethod
    def _find_cli() -> list[str]:
        if shutil.which("gsutil"):
            return ["gsutil"]
        if shutil.which("gcloud"):
            return ["gcloud", "storage"]
        raise FileNotFoundError(
            "gs:// storage requires gsutil or gcloud on PATH")

    def _run(self, *args: str) -> subprocess.CompletedProcess:
        cmd = [*self._cli, *args]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd[:3])} failed rc={out.returncode}: "
                f"{out.stderr.strip()[-500:]}")
        return out

    def put(self, local_path: str, key: str) -> str:
        uri = f"{self.base}/{key}"
        self._run("cp", local_path, uri)
        return uri

    def fetch(self, uri: str, dest_path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(dest_path)),
                    exist_ok=True)
        # the CLI writes its destination in place: a killed download must
        # not leave a torn file where a whole one is expected
        tmp = f"{dest_path}.fetch-tmp-{_tmp_suffix()}"
        try:
            self._run("cp", uri, tmp)
            os.replace(tmp, dest_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return dest_path

    def exists(self, uri: str) -> bool:
        cmd = [*self._cli, "ls", uri]
        return subprocess.run(cmd, capture_output=True,
                              timeout=120).returncode == 0

    def _ls(self, pattern_uri: str) -> list[str]:
        """The keys `ls` lists for a pattern: [] when it matched nothing,
        RuntimeError on any other failure."""
        cmd = [*self._cli, "ls", pattern_uri]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            if any(s in out.stderr.lower() for s in _NO_MATCH):
                return []
            raise RuntimeError(
                f"{' '.join(cmd[:2])} {pattern_uri} failed "
                f"rc={out.returncode}: {out.stderr.strip()[-500:]}")
        keys = []
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith(self.base + "/"):
                keys.append(line[len(self.base) + 1:])
        return sorted(keys)

    def list_keys(self, prefix: str = "") -> list[str]:
        base = f"{self.base}/{prefix.rstrip('/')}" if prefix else self.base
        return self._ls(f"{base.rstrip('/')}/**")

    def glob(self, pattern: str) -> list[str]:
        return self._ls(f"{self.base}/{pattern}")

    def uri(self, key: str) -> str:
        return f"{self.base}/{key}"

    def delete(self, key: str) -> None:
        cmd = [*self._cli, "rm", f"{self.base}/{key}"]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            # already gone is deleted: a prune racing another is not a
            # failure
            if any(s in out.stderr.lower() for s in _NO_MATCH):
                return
            raise RuntimeError(
                f"{' '.join(cmd[:2])} {self.base}/{key} failed "
                f"rc={out.returncode}: {out.stderr.strip()[-500:]}")
