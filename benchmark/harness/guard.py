"""The modules a run of the benchmark must never load: JAX and the JAX
package the port was made from, compared by whole top-level names (the
port's own name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "snark_verifier_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({name for name in names if name.split(".")[0] in FORBIDDEN})
