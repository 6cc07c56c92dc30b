"""``metrics/graph_replay_share.pagereader.py`` on hand-made spans."""

from types import SimpleNamespace

import pytest

from portbench.core import registry


def _read(flags, trace=True):
    """The reading of a traced window whose ``vlm.step`` spans carry
    ``flags`` (None: a step without the attribute), beside a ``vlm.encode``."""
    kept = [SimpleNamespace(name="vlm.encode", attrs={})]
    for i, flag in enumerate(flags):
        attrs = {"step": i} if flag is None else {"step": i, "graph": flag}
        kept.append(SimpleNamespace(name="vlm.step", attrs=attrs))
    run = SimpleNamespace(trace_summary=object() if trace else None, state={"spans": kept})
    return registry.metric_reader("graph_replay_share.pagereader").read(run)


def test_every_step_replayed():
    assert _read([True] * 5) == 1.0


def test_mixed_steps():
    assert _read([True, False, True, True]) == pytest.approx(0.75)
    assert _read([False, False]) == 0.0


def test_nothing_to_read():
    assert _read([]) is None
    assert _read([None, None]) is None  # steps of a program that does not say how they ran
    assert _read([True], trace=False) is None
