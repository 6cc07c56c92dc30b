"""Shared arithmetic of the per-layer metric readers."""

from __future__ import annotations

from typing import Optional

from portbench.core import peaks


def stage_s_per_unit(run, stage: str) -> Optional[float]:
    """Host seconds the engine's ``StageTimer`` gave ``stage`` over the
    window, per unit completed; None where the run kept no stage times."""
    t0, t1 = run.state.get("timings0"), run.state.get("timings1")
    if t1 is None or stage not in t1 or not run.completed:
        return None
    before = t0.get(stage, {}).get("total_s", 0.0) if t0 else 0.0
    return (t1[stage]["total_s"] - before) / run.completed


def idle_pct(run) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card."""
    tr = run.trace_summary
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def bf16_peak_pct(flops: float, seconds: float) -> Optional[float]:
    """FLOPs over the time and the card's bfloat16 peak, in percent."""
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peaks.BF16_FLOPS)
