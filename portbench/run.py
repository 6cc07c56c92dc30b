"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic and
per-layer metrics are found by the names in ``BENCHMARK.json``
(``portbench/core/registry.py``). Measures ``bbocr_tpu_torch`` on a CUDA card
and exits non-zero, printing no result, without one.
"""

import time

_T_PROCESS = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    # the checkout's root in place of this folder, for ``portbench`` and the program
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench.core.bench import main

    sys.exit(main(sys.argv[1:], t_process=_T_PROCESS))
