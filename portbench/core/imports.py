"""The JAX side may not run in a benchmark process.

Modules are compared by their whole top-level name, the part before the
first dot: ``bbocr_tpu_torch`` is the program, ``bbocr_tpu`` is not."""

from __future__ import annotations

import sys
from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bbocr_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_in(names: Iterable[str]) -> Set[str]:
    return {n for n in names if top_level(n) in FORBIDDEN}


def forbidden_loaded() -> Set[str]:
    return forbidden_in(list(sys.modules))
