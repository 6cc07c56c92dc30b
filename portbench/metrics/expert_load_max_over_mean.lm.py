"""How uneven the routing is: the mean over the traced window's
``lm.generate`` spans of their ``expert_load_max_over_mean`` (over the
expert layers, the most-loaded expert's token-expert pairs over the mean
expert's, prefill and decode together)."""

from portbench.core import spans


def read(run):
    got = [s.attrs["expert_load_max_over_mean"] for s in spans.window_spans(run)
           if s.name == "lm.generate" and "expert_load_max_over_mean" in s.attrs]
    return sum(got) / len(got) if got else None
