"""A flat keyed blob namespace on a `gs://` bucket, through its CLI.

The port's own copy of `tony_tpu/storage/store.py` (which it does not
import): `StagingStore`, the interface; `LocalDirStore`, a shared
directory; `GCSStore`, the object store behind a `gs://` checkpoint
directory or staging location; and the executor's `store_for_uri` and
`fetch_uri`, which localize a staged URI by its scheme alone. The
reference's behaviour is kept exactly:
- the CLI is `gsutil` when it is on PATH, else `gcloud storage`; neither
  raises FileNotFoundError;
- `fetch` downloads into a temporary file and renames it, so a killed
  download never leaves a torn file behind;
- `_ls` tells "matched no objects" (an empty listing) from a real failure
  (authentication, network, a missing bucket), which raises: a resuming
  trainer that read a transient failure as "no checkpoints" would restart
  from step 0 and overwrite the good ones;
- `delete` treats an object that is already gone as deleted;
- a `LocalDirStore` writes through a temporary file and a rename too, so
  a reader never sees half a file.
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


class LocalDirStore(StagingStore):
    """Shared-filesystem store rooted at a directory (the round-1 layout:
    `<app_dir>/staging`). URIs are plain absolute paths, which keeps every
    existing conf/spec backward compatible."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def put(self, local_path: str, key: str) -> str:
        dest = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        if os.path.abspath(local_path) != dest:
            # copy-to-tmp + rename: readers polling a store key (the
            # fleet registry's jobstate scan, the durable accounting)
            # must never observe a half-written file — GCS puts are
            # server-side atomic, the local twin has to earn it
            tmp = f"{dest}.put-tmp-{_tmp_suffix()}"
            shutil.copy2(local_path, tmp)
            os.replace(tmp, dest)
        return dest

    def fetch(self, uri: str, dest_path: str) -> str:
        src = uri[len("file://"):] if uri.startswith("file://") else uri
        os.makedirs(os.path.dirname(os.path.abspath(dest_path)),
                    exist_ok=True)
        if os.path.abspath(src) != os.path.abspath(dest_path):
            # download-to-tmp + rename, same idiom as put(): an executor
            # killed mid-fetch must never leave a torn file that the
            # localization cache (or a retry) would then serve as whole
            tmp = f"{dest_path}.fetch-tmp-{_tmp_suffix()}"
            try:
                shutil.copy2(src, tmp)
                os.replace(tmp, dest_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        return dest_path

    def exists(self, uri: str) -> bool:
        src = uri[len("file://"):] if uri.startswith("file://") else uri
        return os.path.exists(src)

    def list_keys(self, prefix: str = "") -> list[str]:
        base = os.path.join(self.root, prefix) if prefix else self.root
        out = []
        for dirpath, _dirs, files in os.walk(base):
            for f in files:
                out.append(os.path.relpath(os.path.join(dirpath, f),
                                           self.root))
        return sorted(out)

    def uri(self, key: str) -> str:
        return os.path.join(self.root, key)

    def glob(self, pattern: str) -> list[str]:
        import glob as _glob
        hits = _glob.glob(os.path.join(self.root, pattern))
        return sorted(os.path.relpath(h, self.root) for h in hits
                      if os.path.isfile(h))

    def delete(self, key: str) -> None:
        try:
            os.remove(os.path.join(self.root, key))
        except FileNotFoundError:
            pass


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


def staging_store(location: str, app_dir: str) -> StagingStore:
    """Build the app's store from `tony.staging.location`: empty -> the
    local `<app_dir>/staging` dir (round-1 behavior), `gs://...` -> GCS,
    anything else -> a shared local/NFS dir. Shared locations (gs:// and
    explicit dirs) are namespaced by a per-app subdir the way
    `.tony/<appId>` namespaced HDFS — without it, two concurrent apps
    staging fixed keys (tony_src.zip, tony-final.json) into one NFS dir
    would clobber each other."""
    if not location:
        return LocalDirStore(os.path.join(app_dir, "staging"))
    app_id = os.path.basename(os.path.normpath(app_dir))
    if location.startswith("gs://"):
        return GCSStore(f"{location.rstrip('/')}/{app_id}")
    return LocalDirStore(os.path.join(location, app_id))


def location_store(location: str) -> StagingStore:
    """A store rooted at a staging LOCATION itself (no per-app subdir) —
    the reader-side twin of `staging_store`: the portal's history
    fetcher and the fleet registry scan `<location>/<app_id>/...` keys
    across ALL applications, so their store must sit at the root the
    per-app writers namespaced under."""
    if location.startswith("gs://"):
        return GCSStore(location)
    return LocalDirStore(location)


def store_for_uri(uri: str) -> StagingStore:
    """Container-side: a store capable of fetching `uri` (no conf needed —
    the scheme is self-describing)."""
    if uri.startswith("gs://"):
        base, _, _ = uri.rpartition("/")
        return GCSStore(base)
    return LocalDirStore(os.path.dirname(
        uri[len("file://"):] if uri.startswith("file://") else uri) or ".")


def fetch_uri(uri: str, dest_path: str) -> str:
    """One-shot localize of any staged URI."""
    return store_for_uri(uri).fetch(uri, dest_path)
