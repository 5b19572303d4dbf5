"""The check that the measured process ran without JAX: neither JAX nor
the JAX package (`uresnet_pytorch_tpu`, whose name the port's begins
with) may be loaded once the window has closed, in the process that
prints the result or in any rank process of a cell over several cards.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "uresnet_pytorch_tpu")


class ForbiddenModules(RuntimeError):
    """A rank process had loaded a forbidden module by the close of its
    window; the run prints no result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)
