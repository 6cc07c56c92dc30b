"""Readings that set a cell's limits: the program's, and its control's.

    python3 portbench/control.py --workload <cell> --mode program|control \
        --seeds <n> [<n> ...] --seconds <s> [--out <file>]

Sets the cell up once, then for each seed runs a window of the cell's own
traffic from that seed and the cell's check, and prints one JSON line per
seed with every number compared. ``--mode control`` puts the plain
reference in the program's place, computed in float8 (the step below the
bfloat16 the configurations state; ``install_control`` of the cell's
driver). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.core import bench, corpus, registry  # noqa: E402


def readings(cell: registry.Cell, mode: str, seeds: List[int], seconds: float, device: str = "cuda") -> List[Dict]:
    """One reading per seed, in one process."""
    import torch

    drv = registry.driver(cell)
    run = bench.Run(cell, seeds[0], seconds, False)
    run.device = torch.device(device)
    t0 = time.perf_counter()
    drv.setup(run)
    if mode == "control":
        drv.install_control(run)
    setup_s = time.perf_counter() - t0
    out = []
    for seed in seeds:
        run.seed = seed
        run.state["order"] = corpus.order(seed, len(run.state["paths"]))
        run.end_to_end.clear()
        drv.window(run)
        checks = drv.check(run)
        out.append({
            "workload": cell.name, "mode": mode, "seed": seed, "setup_s": setup_s,
            "completed": run.completed, "rate": dict(run.end_to_end),
            "counters": dict(run.counters), "check": {c.name: c.value for c in checks},
        })
    return out


def main(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench.pin_environment()
    import torch

    torch.set_num_threads(1)
    cell = registry.find_cell(args.workload)
    rows = readings(cell, args.mode, args.seeds, args.seconds)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
