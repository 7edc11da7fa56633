"""The persistent compile cache of a port task: its kernel builds.

Counterpart of `tony_tpu/utils/compilecache.py`. The executor renders
`$TONY_JAX_CACHE_DIR` (`tony.executor.jax-cache-dir`) into every trainer's
and server's environment; the JAX package points jax's compilation cache
there before its first compile. The port's compiled artifacts are its
hand-written kernels' libraries, so it points the kernel build directory
at `<dir>/tony_tpu_torch-kernels` before the first kernel loads: the Nth
task on a host loads the libraries the first one built instead of running
`nvcc` again (`tony_tpu_torch/ops/cuda_lib.py` keys each library by its
source, headers, flags and compiler, and locks each build).

As in the reference, a cache that cannot be used is a log line: the
kernels then build into the default `_build/` directory, with `nvcc`, and
a failed build still raises.
"""

from __future__ import annotations

import logging
import os
import tempfile

LOG = logging.getLogger(__name__)

KERNELS_SUBDIR = "tony_tpu_torch-kernels"


def maybe_enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Build the port's kernels under $TONY_JAX_CACHE_DIR (or an explicit
    `cache_dir`). Returns the kernel build directory applied, None when
    the variable is unset or the directory cannot be used (created and
    written), or when a kernel library is already loaded from elsewhere."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.ops import cuda_lib

    d = cache_dir if cache_dir is not None else os.environ.get(
        C.JAX_CACHE_DIR, "")
    if not d:
        return None
    kernels = os.path.join(d, KERNELS_SUBDIR)
    try:
        os.makedirs(kernels, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=kernels, prefix=".probe-")
        os.close(fd)
        os.remove(probe)
        applied = str(cuda_lib.set_build_dir(kernels))
    except (OSError, RuntimeError) as e:
        LOG.warning("persistent kernel build cache unavailable, building "
                    "into %s: %s: %s", cuda_lib.BUILD_DIR, type(e).__name__,
                    e)
        return None
    LOG.info("persistent kernel build cache at %s", applied)
    return applied
