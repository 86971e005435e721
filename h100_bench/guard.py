"""The check that the measured process loaded neither JAX nor the JAX
package: top-level module names compared whole, so ``sesa_tpu_torch`` (the
program) passes and ``sesa_tpu`` (the JAX package) does not."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sesa_tpu")


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names in ``modules`` (default ``sys.modules``) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
