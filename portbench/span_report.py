"""Where a cell's device idle time and device work go, by the program's spans,
and what recording the spans costs.

    python3 portbench/span_report.py --workload <cell> --seed <n> --seconds <s> [--pairs <k>] [--pair-seconds <s>] [--out <file>]

Run from the root of a checkout, on a CUDA card. After the cell's set-up it
traces one window of a third of ``--seconds`` as ``--trace 1`` does, under
``core/launches.py::SpanTrace``, and
prints, as JSON lines: the device time launched inside spans and outside
every span (``core/spans.py::coverage``); the idle gaps' time by thread and
the innermost span open on it (``idle_by_span``); the device time and
kernels launched inside each span name; the cell's per-layer metrics; and
the device-attributed readings of ``core/launches.py::READINGS``, which a
result line does not carry. Then ``--pairs`` pairs of untraced windows of
``--pair-seconds``, one with ``record_spans()`` forced on and one without,
in turns (off, on, on, off, ...), each with the cell's rate. ``--out``
also writes everything printed to one JSON file.
"""

import time

_T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402


def _roles(spans_):
    """Native thread id -> the stage it runs, by the spans it holds."""
    names = defaultdict(set)
    for s in spans_:
        names[s.tid].add(s.name)
    out = {}
    for tid, held in names.items():
        if "letterbox" in held:
            out[tid] = "detect thread"
        elif "boxes" in held:
            out[tid] = "middle thread"
        elif "vlm.generate" in held:
            out[tid] = "caller"
        else:
            out[tid] = "collect thread (caller)"
    return out


def traced_window(run, driver):
    """``core/bench.py::traced_window`` under ``SpanTrace``: a window of a
    third of the run's seconds, its summary with the launches, the gaps and
    the spans, which the span readers then find in ``run.state``."""
    from portbench.core.launches import SpanTrace

    seconds = run.seconds
    run.seconds = seconds / 3.0
    try:
        with SpanTrace() as tr:
            driver.window(run)
    finally:
        run.seconds = seconds
    tr.summary.window_s = run.window_s
    tr.summary.completed = run.completed
    run.end_to_end.clear()
    run.state["spans"] = tr.summary.spans
    return tr.summary


def report(run, tr):
    from portbench.core import launches, registry, spans

    roles = _roles(tr.spans)
    idle_total = sum(b - a for a, b in tr.idle)
    by_span = {f"{roles.get(tid, tid)}: {name}": ns * 1e-9 for (tid, name), ns in
               sorted(spans.idle_by_span(tr).items(), key=lambda kv: -kv[1])}
    launched, outside = {}, {}
    line = spans.lineage(tr.spans)
    threads = {spans.thread_key(s.ident) for s in tr.spans}
    for ln, s in zip(tr.launches, spans.innermost(tr.spans, tr.launches)):
        key = " < ".join(line[s.id][:2]) if s is not None else "(outside every span)"
        slot = launched.setdefault(key, [0, 0.0, 0])
        slot[0] += 1
        slot[1] += ln.device_ns * 1e-9
        slot[2] += ln.kernel
        if s is None:  # by name, and whether a span thread launched it
            where = "unjoined" if ln.host_ns is None else "span thread" if ln.thread in threads else "other thread"
            slot = outside.setdefault(f"{where}: {ln.name}", [0, 0.0])
            slot[0] += 1
            slot[1] += ln.device_ns * 1e-9
    metrics = {}
    for m in run.cell.per_layer:
        value = registry.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = value
    for name in launches.READINGS:
        value = launches.reading(name, tr)
        if value is not None:
            metrics[name] = value
    host = defaultdict(float)
    for s in tr.spans:
        host[f"{roles.get(s.tid, s.tid)}: {s.name}"] += (s.end_ns - s.start_ns) * 1e-9
    return {
        "window_s": tr.window_s, "busy_s": tr.busy_s, "completed": tr.completed, "spans": len(tr.spans),
        "coverage": spans.coverage(tr),
        "idle_gaps": len(tr.idle), "idle_in_gaps_s": idle_total * 1e-9, "idle_short_s": tr.idle_short_s,
        "idle_before_first_op_s": _edge(tr.idle[:1], 0, tr.start_ns), "idle_after_last_op_s": _edge(tr.idle[-1:], 1, tr.end_ns),
        "idle_by_span_s": by_span,
        "launched_by_span": {k: {"launches": v[0], "device_s": v[1], "kernels": v[2]}
                             for k, v in sorted(launched.items(), key=lambda kv: -kv[1][1])},
        "outside_by_name": dict(sorted(outside.items(), key=lambda kv: -kv[1][1])[:12]),
        "host_s_by_span": dict(sorted(host.items(), key=lambda kv: -kv[1])),
        "metrics": metrics,
    }


def main(argv):
    p = argparse.ArgumentParser(prog="portbench/span_report.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--pairs", type=int, default=0)
    p.add_argument("--pair-seconds", type=float, default=12.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from portbench.core import bench, registry
    from portbench.core.peaks import power_limit_w

    bench.pin_environment()
    cell = registry.find_cell(args.workload)
    import torch

    from bbocr_tpu_torch.utils.profiling import record_spans, take_spans

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    run = bench.Run(cell, args.seed, args.seconds, True)
    run.state["t_process"] = _T_PROCESS
    run.device = torch.device("cuda")
    driver = registry.driver(cell)
    driver.setup(run)
    torch.cuda.synchronize()
    out = {"cell": cell.name, "seed": args.seed, "card": torch.cuda.get_device_name(0),
           "power_limit_w": power_limit_w(), "setup_s": time.perf_counter() - _T_PROCESS}
    run.trace_summary = traced_window(run, driver)
    out["traced"] = report(run, run.trace_summary)
    print(json.dumps(out), flush=True)
    rate = cell.traffic["rate_metric"]
    seconds = run.seconds
    run.seconds = args.pair_seconds
    rates = {"off": [], "on": []}
    n_spans = []
    for i in range(2 * args.pairs):
        on = (i % 4) in (1, 2)  # off, on, on, off, ...
        with record_spans() if on else contextlib.nullcontext():
            driver.window(run)
        kept = take_spans()
        if on:
            n_spans.append(len(kept))
        rates["on" if on else "off"].append(run.end_to_end[rate])
        print(json.dumps({"window": i, "record_spans": on, rate: run.end_to_end[rate], "spans": len(kept)}), flush=True)
    run.seconds = seconds
    if args.pairs:
        out["cost"] = {k: {"rates": v, "median": statistics.median(v), "spread": _spread(v)} for k, v in rates.items()}
        out["cost"]["spans_per_window"] = n_spans
        print(json.dumps({"cost": out["cost"]}), flush=True)
    driver.release(run)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _edge(gaps, side, at):
    """The length of the gap that touches the window's edge ``at``, or 0."""
    return sum(b - a for a, b in gaps if (a, b)[side] == at) * 1e-9


def _spread(values):
    """Quartile spread over the median (``statistics.quantiles``)."""
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
