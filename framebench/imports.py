"""The check that a run loaded no JAX: the top-level name of every
module in ``sys.modules`` (the part before the first dot), compared
whole, so that ``hybridrenderer_tpu_torch`` is not taken for
``hybridrenderer_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hybridrenderer_tpu"})


def forbidden(names) -> list:
    """The forbidden top-level names among module ``names``."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def loaded_forbidden() -> list:
    return forbidden(list(sys.modules))
