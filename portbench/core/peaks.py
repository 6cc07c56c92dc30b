"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit). A share of a peak is stated against these, with the
card's power limit recorded beside it (``power_limit_w``)."""

from __future__ import annotations

import subprocess
from typing import Optional

BF16_FLOPS = 989e12  # FLOP/s, bfloat16 tensor cores, dense
HBM_BYTES = 3.35e12  # bytes/s


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
