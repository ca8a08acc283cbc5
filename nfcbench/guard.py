"""The import guard: the benchmark measures the PyTorch port alone, so no
module of JAX or of the JAX package may be loaded in the process that
reports.  Names are compared by their top-level part, whole: the port's
``nfclab_torch`` is not the JAX package's ``nfclab``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nfclab")


def forbidden_loaded(modules=None) -> list:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))
