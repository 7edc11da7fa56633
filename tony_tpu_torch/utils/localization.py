"""Resource localization: the port's copy of
`tony_tpu/utils/localization.py`.

A resource spec is ``path[::newName][#archive]``. The client staged each
one (a directory zipped) and wrote its URI into the frozen conf; the
executor materializes it into the task's cwd: archives unzip in place,
plain files copy in, remote URIs (``gs://``) are fetched through the
staging store first. With ``tony.localization.cache-enabled`` a
content-addressed cache on the machine fetches each remote URI once and
hardlinks plain files out of its digest store.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from dataclasses import dataclass

from tony_tpu_torch.utils.fs import copy_into, unzip, zip_dir

ARCHIVE_SUFFIX = "#archive"
NAME_SEP = "::"


def _tmp_suffix() -> str:
    """Unique per use (pid and a random part): executors sharing a process
    must not share a temporary name."""
    import uuid
    return f"{os.getpid()}-{uuid.uuid4().hex[:12]}"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class LocalizationCache:
    """Content-addressed machine-wide resource cache
    (tony.localization.cache-*): bytes land ONCE per digest under
    `by_digest/<sha256>` (written tmp + os.replace, so a killed fetch
    can never leave a torn blob a later hit would serve), remote URIs
    resolve through `by_uri/<sha256(uri)>` marker files naming the
    digest (staged URIs are per-app-namespaced, hence immutable), and
    containers materialize blobs by hardlink — falling back to copy
    across filesystems — and `by_stat/<dev-ino-size-mtimens>` markers
    memoize local-file digests so a hit never re-reads the source. The
    Nth job, and every elastic-grow / autoscale slot, skips the fetch
    entirely."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.by_digest = os.path.join(self.root, "by_digest")
        self.by_uri = os.path.join(self.root, "by_uri")
        self.by_stat = os.path.join(self.root, "by_stat")
        os.makedirs(self.by_digest, exist_ok=True)
        os.makedirs(self.by_uri, exist_ok=True)
        os.makedirs(self.by_stat, exist_ok=True)
        self.hits = 0
        self.misses = 0
        from tony_tpu_torch.observability.metrics import REGISTRY
        self._registry = REGISTRY

    @classmethod
    def from_conf(cls, conf) -> "LocalizationCache | None":
        """The cache `tony.localization.cache-enabled` asks for (None =
        disabled, today's copy-per-container semantics)."""
        from tony_tpu_torch.conf import keys as K
        if not conf.get_bool(K.LOCALIZATION_CACHE_ENABLED, False):
            return None
        root = (conf.get_str(K.LOCALIZATION_CACHE_DIR, "")
                or os.path.join(tempfile.gettempdir(), "tony_loc_cache"))
        return cls(root)

    # -- accounting ----------------------------------------------------
    def _hit(self) -> None:
        self.hits += 1
        self._registry.counter("tony_localization_cache_hits_total").inc()

    def _miss(self) -> None:
        self.misses += 1
        self._registry.counter("tony_localization_cache_misses_total").inc()

    # -- blob store ----------------------------------------------------
    def _add_blob(self, src_path: str, digest: str) -> str:
        """Atomic content-addressed add: tmp in the SAME directory, then
        os.replace — readers only ever see absent or complete."""
        dest = os.path.join(self.by_digest, digest)
        if not os.path.exists(dest):
            tmp = f"{dest}.tmp-{_tmp_suffix()}"
            shutil.copy2(src_path, tmp)
            os.replace(tmp, dest)
        return dest

    def _stat_key(self, src_path: str) -> str | None:
        """Identity key for the digest memo: (dev, inode, size,
        mtime_ns) — the git/rsync assumption that an unchanged stat
        means unchanged bytes."""
        try:
            st = os.stat(src_path)
        except OSError:
            return None
        return f"{st.st_dev}-{st.st_ino}-{st.st_size}-{st.st_mtime_ns}"

    def _known_digest(self, stat_key: str | None) -> str | None:
        if stat_key is None:
            return None
        try:
            with open(os.path.join(self.by_stat, stat_key), "r",
                      encoding="utf-8") as f:
                return f.read().strip() or None
        except OSError:
            return None

    def _memo_digest(self, stat_key: str | None, digest: str) -> None:
        if stat_key is None:
            return
        marker = os.path.join(self.by_stat, stat_key)
        tmp = f"{marker}.tmp-{_tmp_suffix()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(digest)
        os.replace(tmp, marker)

    def get_or_add_file(self, src_path: str) -> str:
        """Cache a local file by content digest; returns the cached blob
        path (hit = digest already present machine-wide). The digest
        itself is memoized by stat identity: hashing the source costs
        MORE than the copy the cache saves (a width-256 gang re-hashing
        one 4 MB resource reads a gigabyte), so only the first toucher
        machine-wide ever runs sha256 — everyone after keys straight
        into the blob store."""
        stat_key = self._stat_key(src_path)
        digest = self._known_digest(stat_key)
        if digest:
            dest = os.path.join(self.by_digest, digest)
            if os.path.exists(dest):
                self._hit()
                return dest
        digest = _sha256_file(src_path)
        dest = os.path.join(self.by_digest, digest)
        hit = os.path.exists(dest)
        if hit:
            self._hit()
        else:
            self._miss()
            dest = self._add_blob(src_path, digest)
        self._memo_digest(stat_key, digest)
        return dest

    def get_or_fetch_uri(self, uri: str, fetcher) -> str:
        """Resolve a remote URI through the cache: a hit never calls
        `fetcher(uri, dest_path)`; a miss fetches into the cache dir,
        digests, and writes the by_uri marker LAST (also atomically) so
        a kill between the two steps costs a refetch, never a torn
        serve."""
        marker = os.path.join(self.by_uri,
                              hashlib.sha256(uri.encode()).hexdigest())
        try:
            with open(marker, "r", encoding="utf-8") as f:
                digest = f.read().strip()
            blob = os.path.join(self.by_digest, digest)
            if digest and os.path.exists(blob):
                self._hit()
                return blob
        except OSError:
            pass
        self._miss()
        tmp_fetch = os.path.join(self.root, f".fetch-tmp-{_tmp_suffix()}")
        try:
            fetcher(uri, tmp_fetch)
            digest = _sha256_file(tmp_fetch)
            blob = self._add_blob(tmp_fetch, digest)
        finally:
            try:
                os.remove(tmp_fetch)
            except OSError:
                pass
        tmp_marker = f"{marker}.tmp-{_tmp_suffix()}"
        with open(tmp_marker, "w", encoding="utf-8") as f:
            f.write(digest)
        os.replace(tmp_marker, marker)
        return blob

    def materialize(self, blob_path: str, dest_dir: str, name: str) -> str:
        """Hardlink the cached blob into a container dir (atomic: link
        to tmp + os.replace overwrites any stale entry), copy when the
        cache sits on a different filesystem."""
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, name)
        tmp = f"{dest}.link-tmp-{_tmp_suffix()}"
        try:
            os.link(blob_path, tmp)
        except OSError:
            shutil.copy2(blob_path, tmp)
        os.replace(tmp, dest)
        return dest


@dataclass
class LocalizableResource:
    """Parsed `path[::newName][#archive]` spec (LocalizableResource.java:20-102)."""
    source_path: str
    local_name: str
    is_archive: bool

    @classmethod
    def parse(cls, spec: str) -> "LocalizableResource":
        is_archive = spec.endswith(ARCHIVE_SUFFIX)
        if is_archive:
            spec = spec[: -len(ARCHIVE_SUFFIX)]
        if NAME_SEP in spec:
            path, _, name = spec.partition(NAME_SEP)
        else:
            path, name = spec, os.path.basename(spec.rstrip("/"))
        if not path:
            raise ValueError(f"empty path in resource spec {spec!r}")
        return cls(source_path=path, local_name=name, is_archive=is_archive)


def stage_resource(spec: str, staging_dir_or_store) -> str:
    """Ship one resource into the staging store (dirs are zipped, like
    TonyClient.java:539-551). Returns the staged spec string (URI
    [+#archive]) to write back into the conf. Accepts a plain dir path
    (wrapped in a LocalDirStore) or any `StagingStore`."""
    from tony_tpu_torch.storage import LocalDirStore, StagingStore

    store = (staging_dir_or_store
             if isinstance(staging_dir_or_store, StagingStore)
             else LocalDirStore(staging_dir_or_store))
    res = LocalizableResource.parse(spec)
    src = res.source_path
    if not os.path.exists(src):
        raise FileNotFoundError(f"resource not found: {src}")
    if os.path.isdir(src):
        with tempfile.TemporaryDirectory() as tmp:
            zipped = os.path.join(tmp, res.local_name + ".zip")
            zip_dir(src, zipped)
            staged = store.put(zipped, res.local_name + ".zip")
        return staged + ARCHIVE_SUFFIX
    staged = store.put(src, res.local_name)
    return staged + (ARCHIVE_SUFFIX if res.is_archive else "")


def fetch_remote_spec(path: str, dest_dir: str, name: str = "",
                      cache: LocalizationCache | None = None
                      ) -> tuple[str, bool]:
    """Resolve a remote staged URI (gs://-style) to a local file under
    `dest_dir/.fetch`; plain / file:// paths pass through untouched.
    Returns (local_path, was_fetched) — callers delete fetched archives
    after extraction so a multi-GB zip doesn't double the container's
    disk footprint (a cache-served file is a hardlink, so the delete
    drops the link, never the cached blob). The single scheme-dispatch
    point for both the resource specs and the src/venv conf entries."""
    if path and "://" in path and not path.startswith("file://"):
        from tony_tpu_torch.storage.store import fetch_uri

        dest = os.path.join(dest_dir, ".fetch",
                            name or os.path.basename(path))
        if cache is not None:
            blob = cache.get_or_fetch_uri(path, fetch_uri)
            local = cache.materialize(blob, os.path.dirname(dest),
                                      os.path.basename(dest))
            return local, True
        local = fetch_uri(path, dest)
        return local, True
    return path, False


def localize_resource(spec: str, dest_dir: str,
                      cache: LocalizationCache | None = None) -> str:
    """Container-side: materialize a staged resource into the task workdir —
    archives are unzipped, plain files copied
    (Utils.addResources + extractResources, util/Utils.java:506-550,699-712).
    Remote URIs (gs://) are fetched through the staging store first, so the
    same spec works with or without a shared filesystem. With a
    LocalizationCache, remote fetches happen once machine-wide and plain
    files hardlink out of the content-addressed store instead of copying."""
    res = LocalizableResource.parse(spec)
    src, fetched = fetch_remote_spec(res.source_path, dest_dir,
                                     name=res.local_name, cache=cache)
    if res.is_archive or src.endswith(".zip"):
        name = res.local_name
        if name.endswith(".zip"):
            name = name[:-4]
        out = unzip(src, os.path.join(dest_dir, name))
        if fetched:
            os.remove(src)
        return out
    if cache is not None and os.path.isfile(src):
        blob = cache.get_or_add_file(src)
        return cache.materialize(blob, dest_dir, res.local_name)
    return copy_into(src, dest_dir, new_name=res.local_name)
