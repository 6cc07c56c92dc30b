"""CUDA kernels launched in the traced window per page completed."""


def read(run):
    tr = run.trace_summary
    if tr is None or not tr.completed:
        return None
    return tr.kernels / tr.completed
