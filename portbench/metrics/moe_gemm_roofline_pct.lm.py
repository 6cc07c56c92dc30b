"""The routed experts' grouped GEMM against its roofline (percent): over the
traced window, the least time the card could take for the expert GEMMs of
each forward, max(FLOPs / bfloat16 peak, bytes / memory peak) by the
reference's ``expert_gemm_cost`` (an ``lm.prefill`` span's ``tokens``; an
``lm.step`` span's rows, its ``lm.generate``'s ``requests``), over the
device time of the kernels named ``bbocr_moe_*``. None without those spans
or kernels."""

from portbench.core import peaks, registry, spans

KERNELS = "bbocr_moe_"


def read(run):
    tr = run.trace_summary
    window = spans.window_spans(run)
    if tr is None or not window:
        return None
    device_s = sum(secs for name, (_, secs) in tr.by_name.items() if name.startswith(KERNELS))
    if device_s <= 0:
        return None
    cfg = run.cell.config
    ref = registry.reference(run.cell)
    requests = {s.id: s.attrs.get("requests") for s in window if s.name == "lm.generate"}
    best = 0.0
    for s in window:
        if s.name == "lm.prefill":
            tokens = s.attrs.get("tokens")
        elif s.name == "lm.step":
            tokens = requests.get(s.parent)
        else:
            continue
        if tokens:
            best += ref.roofline_s(cfg, tokens, peaks.BF16_FLOPS, peaks.HBM_BYTES)
    return 100.0 * best / device_s if best else None
