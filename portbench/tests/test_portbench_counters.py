"""The yardstick's counters and the trace's reduction on small shapes."""

import numpy as np
import pytest
import torch

from portbench.core import registry
from portbench.core.trace import reduce_intervals


def _ref(name):
    return registry.load_module(f"{registry.PORTBENCH}/configs/{name}_reference.py", "test_ref_" + name)


def test_count_flops_of_a_product():
    ocr = _ref("ocr_craftgn_crnn97")
    a, b = torch.empty(3, 5, device="meta"), torch.empty(5, 7, device="meta")
    assert ocr.count_flops(lambda: a @ b) == 2 * 3 * 5 * 7


def test_detector_flops_grow_with_the_canvas():
    ocr = _ref("ocr_craftgn_crnn97")
    cfg = registry.load_json(f"{registry.PORTBENCH}/configs/ocr_craftgn_crnn97.json")
    small, big = ocr.craft_flops(registry.ROOT, cfg, (64, 64)), ocr.craft_flops(registry.ROOT, cfg, (128, 128))
    assert 3.9 < big / small < 4.1
    # the first convolution alone: 3 -> 64 channels, 3x3, at every pixel
    assert small > 2 * 64 * 64 * 64 * 3 * 9


def test_recognizer_flops_by_hand():
    ocr = _ref("ocr_craftgn_crnn97")
    cfg = registry.load_json(f"{registry.PORTBENCH}/configs/ocr_craftgn_crnn97.json")
    w = 64
    t = w // 4 - 1
    convs = 2 * 9 * (32 * w * 1 * 32 + 16 * (w // 2) * 32 * 64 + 8 * (w // 4) * (64 * 128 + 128 * 128)
                     + 4 * (w // 4) * (128 * 256 + 256 * 256)) + 2 * 4 * t * 256 * 256
    lstm = 2 * (2 * 2 * t * 256 * 1024 * 2 + 2 * t * 512 * 256)
    head = 2 * t * 256 * 97
    assert ocr.crnn_flops(registry.ROOT, cfg, w) == convs + lstm + head


def test_photo_flops_counts_the_retry():
    ocr = _ref("ocr_craftgn_crnn97")
    cfg = registry.load_json(f"{registry.PORTBENCH}/configs/ocr_craftgn_crnn97.json")
    craft = {tuple(c): 1000 for c in cfg["engine"]["canvases"]}
    crnn = {w: w for w in cfg["engine"]["width_buckets"]}
    quad = np.array([[0, 0], [100, 0], [100, 20], [0, 20]], float)  # 160 px wide at height 32
    answers = [(quad, "ab", 0.9), (quad, "cd", 0.05)]
    assert ocr.photo_flops(answers, (800, 600), cfg, craft, crnn) == 1000 + 256 + 2 * 256


def test_page_flops_by_hand():
    pr = _ref("pagereader_5m")
    cfg = dict(dim=8, patch=4, page_h=8, page_w=8, enc_depth=1, dec_depth=1, vocab=5)
    s, d, m = 4, 8, 32
    enc = 2 * s * 16 * d + (2 * s * 4 * d * d + 4 * s * s * d + 4 * s * d * m)
    dec = 2 * s * 2 * d * d
    for t in range(2):
        dec += 2 * 4 * d * d + 4 * (t + 1) * d + 4 * d * d + 4 * s * d + 4 * d * m + 2 * d * 5
    assert pr.page_flops(cfg, 2) == enc + dec


def test_served_length():
    pr = _ref("pagereader_5m")
    assert pr.served_length(np.array([97, 5, 6, 98, 98, 0]), 98) == 4
    assert pr.served_length(np.array([97, 5, 6]), 98) == 3


def test_reduce_intervals_unions_and_names_gaps():
    busy, gaps = reduce_intervals([(0, 10, "a"), (5, 20, "b"), (30, 35, "c"), (36, 40, "d"), (100, 101, "e")])
    assert busy == 20 + 5 + 4 + 1
    assert gaps == [("before e", 60), ("before c", 10), ("before d", 1)]


def test_ctc_best_emissions():
    ocr = _ref("ocr_craftgn_crnn97")
    lp = np.log(np.array([[0.1, 0.8, 0.1], [0.7, 0.2, 0.1], [0.1, 0.1, 0.8]]))
    assert ocr.ctc_best_emissions(lp, [1, 2]) == pytest.approx(np.log(0.8) + np.log(0.8))
    assert ocr.ctc_best_emissions(lp, [1, 1]) == pytest.approx(np.log(0.8) + np.log(0.1))
    assert ocr.ctc_best_emissions(lp, [1, 2, 1, 2]) == -np.inf


def test_traced_window_comes_first_and_host_readings_come_from_the_untraced_one(monkeypatch):
    """A ``--trace 1`` run: a traced window of a third of the seconds, then
    the untraced window that the end-to-end and host-clock readings, and
    the check, take."""
    from portbench.core import bench
    from portbench.core.trace import TraceSummary

    class FakeTrace:
        def __enter__(self):
            self.summary = TraceSummary(busy_s=1.0, kernels=12)
            return self

        def __exit__(self, *exc):
            return False

    class Driver:
        windows = []

        @staticmethod
        def setup(run):
            pass

        @staticmethod
        def window(run):
            Driver.windows.append(run.seconds)
            run.window_s = run.seconds + 0.5
            run.completed = run.attempted = 3 * len(Driver.windows)
            run.end_to_end["rate"] = run.completed / run.window_s

        @staticmethod
        def release(run):
            pass

        @staticmethod
        def check(run):
            return [bench.Check("completed", run.completed, 6)]

    monkeypatch.setattr(bench, "DeviceTrace", FakeTrace)
    cell = registry.Cell("c", 1, "cfg", "mix", {}, {}, [{"name": "rate", "unit": "1/s"}], [], {})
    run = bench.Run(cell, 1, 30.0, True)
    run.state["t_process"] = 0.0
    out = bench.execute(run, Driver, require_cuda=False)
    assert Driver.windows == [10.0, 30.0]
    assert (run.trace_summary.window_s, run.trace_summary.completed) == (10.5, 3)
    assert (run.window_s, run.completed, run.seconds) == (30.5, 6, 30.0)
    assert run.end_to_end == {"rate": 6 / 30.5}
    assert out["device"]["window_s"] == 10.5 and out["device"]["busy_s"] == 1.0
    assert out["correct"] and out["attempted"] == 6
