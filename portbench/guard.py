"""The import guard: no module of JAX, Flax or the JAX package may be loaded
in a benchmark run. A module counts by its top-level name (the part before
the first dot), compared whole, so `gaussreg_tpu_torch` passes and
`gaussreg_tpu.ops` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gaussreg_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded (or given) module names whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
