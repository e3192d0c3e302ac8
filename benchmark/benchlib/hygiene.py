"""What the process that prints the result may not hold: JAX, its
libraries, and the JAX package of the repository (``mdqe_cvpr2023_tpu``),
compared by whole top-level module names (``mdqe_cvpr2023_tpu_torch``, the
port, is another name)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mdqe_cvpr2023_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)
