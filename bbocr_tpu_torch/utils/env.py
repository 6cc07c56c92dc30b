"""Environment flags, with the JAX package's truthy-string convention.

Counterpart of ``bbocr_tpu/utils/env.py::env_flag``.
"""

from __future__ import annotations

import os


def env_flag(name: str, default: bool = False) -> bool:
    """True if the variable is a truthy string ("1", "true", "yes", "on");
    ``default`` when it is unset."""
    raw = os.getenv(name)
    if raw is None:
        return default
    return str(raw).strip().lower() in ("1", "true", "yes", "on")
