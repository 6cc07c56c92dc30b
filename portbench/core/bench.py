"""One run of one cell: set-up, a measured window, the check, the result line.

The order is fixed by what each step must not disturb: the window runs with
nothing else on the card; ``memory_peak_bytes`` is read when it closes; the
program's state is freed before the plain reference runs, so that the
reference neither sets the peak nor competes with the program.

With ``--trace 1`` a traced window of a third of ``--seconds`` comes first
and gives the device readings (busy time, kernels, idle gaps); the profiler
slows the host's launches, so the window after it, untraced and the same as
a ``--trace 0`` run's, gives every host-clock reading and the answers the
check judges.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from portbench.core import imports, registry
from portbench.core.trace import DeviceTrace, TraceSummary

CACHE = os.path.join(registry.PORTBENCH, "_cache")  # fixed, inside the checkout


@dataclass
class Check:
    """One number the run compares, with its limit: ``value <= limit`` passes."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """What a run knows; drivers fill it and metric readers read it."""

    cell: registry.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    state: Dict[str, Any] = field(default_factory=dict)  # the driver's own
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    end_to_end: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace_summary: Optional[TraceSummary] = None
    checks: List[Check] = field(default_factory=list)


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_environment() -> None:
    """Caches at fixed paths inside the checkout, no ``BB_OCR_*`` knob from
    the caller's environment (the configuration file states the program's
    options), and one thread for each of the numeric libraries' pools."""
    for key in [k for k in os.environ if k.startswith("BB_OCR_")]:
        del os.environ[key]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the program's own host threads (its
    # stream stages and pool) and the cell's decode pool, no BLAS or OpenMP
    # pools beside them (with them the camera cell read 16 % slower, my
    # chip runs)
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[key] = "1"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(run: Run, driver, *, require_cuda: bool = True) -> Dict[str, Any]:
    """Set-up, window, check: the result object, or raises."""
    import torch

    run.device = torch.device("cuda" if require_cuda else "cpu")
    driver.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - run.state["t_process"]
    if run.trace:
        run.trace_summary = traced_window(run, driver)
    driver.window(run)
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    driver.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    run.checks = driver.check(run)
    return result(run, peak)


def traced_window(run: Run, driver) -> TraceSummary:
    """A window of a third of the run's seconds under the profiler; its
    summary, with the window's length and the units it completed."""
    seconds = run.seconds
    run.seconds = seconds / 3.0
    try:
        with DeviceTrace() as tr:
            driver.window(run)
    finally:
        run.seconds = seconds
    tr.summary.window_s = run.window_s
    tr.summary.completed = run.completed
    run.end_to_end.clear()
    return tr.summary


def result(run: Run, memory_peak: int) -> Dict[str, Any]:
    import torch

    if run.trace:
        metrics = {}
        for m in run.cell.per_layer:
            value = registry.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in run.cell.end_to_end}
    on_card = run.device.type == "cuda"
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
        "count": run.cell.chips,
        "memory_peak_bytes": int(memory_peak),
        "power_limit_w": run.state.get("power_limit_w"),
    }
    out = {
        "correct": all(c.ok for c in run.checks) and run.completed == run.attempted,
        "attempted": run.attempted,
        "failed": run.attempted - run.completed,
        "metrics": metrics,
        "device": device,
    }
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary.busy_s
        device["window_s"] = run.trace_summary.window_s
        out["breakdown"] = {
            "device_ops": run.trace_summary.top_ops(10),
            "idle_gaps": [[name, secs] for name, secs in run.trace_summary.gaps[:10]],
        }
    out["check"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv: List[str], t_process: Optional[float] = None, require_cuda: bool = True) -> int:
    args = parse(argv)
    pin_environment()
    cell = registry.find_cell(args.workload)
    import torch

    if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); this machine has {have}")
        return 2
    torch.set_num_threads(1)
    run = Run(cell, args.seed, args.seconds, bool(args.trace))
    run.state["t_process"] = t_process if t_process is not None else time.perf_counter()
    if require_cuda:
        from portbench.core.peaks import power_limit_w

        run.state["power_limit_w"] = power_limit_w()
    out = execute(run, registry.driver(cell), require_cuda=require_cuda)
    found = imports.forbidden_loaded()
    if found:
        _log(f"portbench: the process holds {sorted(found)} after the window; no result")
        return 3
    for c in run.checks:
        _log(f"check {c.name} = {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(out), flush=True)
    return 0
