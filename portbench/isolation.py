"""What the benchmark may not load: JAX, its libraries and the JAX package
the port was made from. A module is matched by its top-level name (the
part before the first dot) compared whole, since the port's own name,
`tony_tpu_torch`, begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tony_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
