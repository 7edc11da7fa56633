"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in `tony_tpu_torch/csrc/`, one `.cu` file per kernel, each
with a plain C interface. They are compiled by `nvcc` for Hopper
(`sm_90a`) into shared libraries at first use, one `nvcc` process per
source, all started together. The build directory is
`tony_tpu_torch/_build/` (listed in `.gitignore`) unless `set_build_dir`
points it elsewhere before the first `load()`: a trainer or server run as
a TonY task keeps its builds in the executor's cache directory
(`tony_tpu_torch.utils.compilecache`), so a later task on the same host
loads them instead of compiling. A library's file name carries a hash of
its source, of the shared headers in `csrc/` (`*.cuh`), of the flags and
of `nvcc --version`, so an edited source or header, or another toolkit,
builds anew and an unchanged one is loaded as it is.

Processes sharing a build directory compile each library once: `build`
holds an exclusive `fcntl.flock` on `<library>.lock` from its check for
the library to the rename of the finished one, so a second process
waits, then loads. The kernel drops the lock when its holder exits, so a
killed build leaves no stale lock. `flock` over NFS is advisory and may
not hold across hosts; there two builds may race, and each writes its
own temporary file and renames it into place whole (`os.replace`), so
the loser only repeats the work.

There is no fallback: a missing `nvcc`, a failed build or a non-zero
launch status raises. The plain PyTorch versions beside each kernel run
only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

import torch

LOG = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR / "_build"
# where library_path and build put the libraries; set_build_dir moves it
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_logs: dict[str, str] = {}
# `nvcc --version`, read once per process
_compiler: Optional[str] = None


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default install directory."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def compiler_version() -> str:
    """`nvcc --version`'s output, read once per process."""
    global _compiler
    if _compiler is None:
        _compiler = subprocess.run([find_nvcc(), "--version"],
                                   capture_output=True, text=True,
                                   timeout=120, check=True).stdout
    return _compiler


def set_build_dir(path) -> Path:
    """Build and load the libraries under `path` (created). Call it before
    the first `load()`: with a library already loaded from another
    directory it raises RuntimeError."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _lock:
        if _libs and path != BUILD_DIR:
            raise RuntimeError(
                f"kernel libraries are already loaded from {BUILD_DIR}; "
                f"the build directory cannot move to {path}")
        path.mkdir(parents=True, exist_ok=True)
        BUILD_DIR = path
    return path


def library_path(source: str) -> Path:
    """Where the library built from `source` lives: keyed by a hash of the
    source text, of every header in `csrc/` (a source may include any of
    them), of the compiler flags and of the compiler's version."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(compiler_version().encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _locked(target: Path):
    """An open file holding the exclusive lock of `target`'s build (it
    waits for another process's); closing the file releases it."""
    f = open(target.with_name(f"{target.name}.lock"), "a")
    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
    except BaseException:
        f.close()
        raise
    return f


def build(sources: list[str]) -> dict[str, float]:
    """Compile every source whose library is missing, one `nvcc` each, all
    at once, each under its library's lock (taken in sorted order; a
    library another process finished while this one waited is not
    compiled again). Returns {source: seconds} for the ones compiled here.
    Raises with the compiler's output when any of them fails."""
    todo = sorted(s for s in sources if not library_path(s).exists())
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    try:
        for source in todo:
            target = library_path(source)
            lock = _locked(target)
            if target.exists():
                lock.close()
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}."
                                   f"{uuid.uuid4().hex[:8]}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except BaseException:
                lock.close()
                raise
            running.append((source, target, tmp, proc, time.monotonic(),
                            lock))
        seconds: dict[str, float] = {}
        failures = []
        for source, target, tmp, proc, started, lock in running:
            log, _ = proc.communicate()
            seconds[source] = time.monotonic() - started
            _build_logs[source] = log
            if proc.returncode != 0:
                failures.append(f"nvcc {source} exited {proc.returncode}:"
                                f"\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
                LOG.info("nvcc compiled %s in %.1f s into %s", source,
                         seconds[source], target)
            lock.close()
    finally:
        for _, _, tmp, proc, _, lock in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
            lock.close()
    if failures:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failures))
    return seconds


def build_log(source: str) -> str:
    """The compiler's output (`-Xptxas -v` register and shared-memory
    report) from this process's build of `source`; empty if it was loaded
    from an earlier build."""
    return _build_logs.get(source, "")


def load(source: str) -> ctypes.CDLL:
    """The library built from `source`, built first if missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            lib.tt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tt_cuda_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


KERNELS: dict[str, "Kernel"] = {}


class Kernel:
    """One hand-written kernel: its source, its C entry point with the
    ctypes types of its arguments (the trailing stream argument is added
    here), the TPU kernel it replaces, and a plain count of its launches.
    The count grows by one at each successful launch and nowhere else."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: list, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _entry(self):
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream (the stream is appended to
        `args`). Raises when the launch status is not cudaSuccess."""
        lib, fn = self._entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            status = fn(*args, ctypes.c_void_p(stream))
        if status != 0:
            reason = lib.tt_cuda_error_string(status).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{reason} (cudaError {status})")
        self.launches += 1


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def launches() -> dict[str, int]:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def dtype_code(dtype: torch.dtype) -> Optional[int]:
    """The kernels' dtype argument: 0 = float32, 1 = bfloat16."""
    return {torch.float32: 0, torch.bfloat16: 1}.get(dtype)
