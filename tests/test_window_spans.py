"""Spans of the port (``bbocr_tpu_torch/utils/profiling.py``) and the
benchmark's reading of them (``portbench/core/launches.py``,
``portbench/core/spans.py``, the span metrics in ``portbench/metrics/``).

- With recording off no span is kept and ``timings()`` counts as before;
  under ``record_spans()`` a ``readtext_stream`` run gives a span tree with
  one batch number a batch across its three threads, ``stream.wait`` on
  each thread and the contrast re-read's check as a ``download`` under
  ``recognize``; a ``greedy_generate`` call gives ``vlm.generate`` with
  ``vlm.encode`` and one ``vlm.step`` a step.
- Under a CPU profiler session a span and a ``record_function`` around the
  same block agree within 1 ms, and ``device_trace`` writes the spans into
  its Chrome trace on their threads.
- ``SpanTrace._reduce`` on a synthetic event list: ``DeviceTrace``'s
  readings as they are, and the idle gaps and launches it keeps besides;
  the attribution of launches and gaps to nested spans on two threads; each
  span reading, in a result line or in ``core/launches.py::READINGS``.

The engine here runs stand-in detector and recognizer outputs, so the
stage code runs in milliseconds on the CPU.
"""

import contextlib
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bbocr_tpu_torch.models import vlm
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.runtime.engine import EngineConfig, OCREngine
from bbocr_tpu_torch.utils import profiling
from bbocr_tpu_torch.utils.profiling import Span, StageTimer, record_spans, span, take_spans
from portbench.core import launches, registry, spans
from portbench.core.launches import Launch, SpanSummary, SpanTrace
from portbench.core.trace import DeviceTrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_COUNTS = {"letterbox": 6, "detect": 12, "boxes": 6, "rectify": 6, "recognize": 12}


@pytest.fixture(autouse=True)
def _empty_store():
    take_spans()
    yield
    take_spans()


class _TimedStages:
    """The stream's three stages as stand-ins that enter the engine's stage
    timers as the engine does (letterbox and detect; the maps' download as
    detect, boxes, rectify, recognize; the ids' download as recognize)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.timers = StageTimer()

    def _stage_detect(self, imgs):
        for name in ("letterbox", "detect"):
            with self.timers.stage(name):
                time.sleep(0.0005)
        return imgs[0]

    def _stage_boxes_recognize(self, ctx):
        for name in ("detect", "boxes", "rectify", "recognize"):
            with self.timers.stage(name):
                time.sleep(0.0005)

    def _stage_collect(self, ctx):
        with self.timers.stage("recognize"):
            return [ctx]


@pytest.mark.parametrize("recording", [False, True])
def test_stage_timings_keep_their_counts(recording):
    stages = _TimedStages()
    with record_spans() if recording else contextlib.nullcontext():
        got = list(OCREngine.readtext_stream(stages, ([i] for i in range(6)), depth=2))
    assert got == [[i] for i in range(6)]
    t = stages.timers.snapshot()
    assert {k: v["count"] for k, v in t.items()} == STAGE_COUNTS
    assert all(set(v) == {"count", "total_s", "mean_s", "max_s"} and v["total_s"] >= 0 for v in t.values())
    kept = take_spans()
    assert profiling.recording() is False
    if not recording:
        assert kept == []
    else:
        stage_spans = [s for s in kept if s.name in STAGE_COUNTS]
        assert {n: sum(s.name == n for s in stage_spans) for n in STAGE_COUNTS} == STAGE_COUNTS
        assert len({s.batch for s in stage_spans}) == 6


@pytest.fixture(scope="module")
def engine():
    """An engine at one small canvas whose detector finds one text box in
    every photo and whose recognizer reads every crop below ``contrast_ths``
    (so every width bucket runs the re-read)."""
    eng = OCREngine.from_checkpoint(
        os.path.join(ROOT, "checkpoints", "craft.npz"), os.path.join(ROOT, "checkpoints", "crnn.npz"),
        EngineConfig(canvases=(CanvasSpec(64, 96),), compute_dtype=torch.float32, host_rectify=True,
                     decoder="greedy", detect_coarse=0, contrast_ths=1.01),
        device="cpu",
    )

    def detect(gray, pool=1):
        b, h, w = gray.shape
        region = torch.zeros((b, h // 2, w // 2), dtype=torch.uint8)
        region[:, 10:20, 8:40] = 255
        return (region > 0).to(torch.uint8), region

    def recognizer_logits(crops):
        n, _, w = crops.shape
        t = w // 4
        logits = torch.zeros((n, t, eng.charset.num_classes))
        logits[:, torch.arange(t), torch.arange(t) % 5 + 1] = 1.0
        return logits

    eng.detect, eng.recognizer_logits = detect, recognizer_logits
    return eng


def _photos(n):
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, (64, 96), dtype=np.uint8)] for _ in range(n)]


def test_recording_off_keeps_no_span(engine):
    engine.timers.reset()
    out = list(engine.readtext_stream(iter(_photos(2))))
    assert len(out) == 2 and all(len(r[0]) == 1 for r in out)
    assert take_spans() == []
    t = engine.timings()
    assert set(t) == {"letterbox", "detect", "boxes", "rectify", "recognize"}
    assert {k: v["count"] for k, v in t.items()} == {"letterbox": 2, "detect": 4, "boxes": 2, "rectify": 2,
                                                    "recognize": 4}


def test_stream_span_tree(engine):
    with record_spans():
        out = list(engine.readtext_stream(iter(_photos(3)), depth=2))
    assert len(out) == 3
    kept = take_spans()
    by_id = {s.id: s for s in kept}
    assert len(by_id) == len(kept)
    for s in kept:
        assert s.end_ns >= s.start_ns > 0
        if s.parent:  # a parent is open around its child on the same thread
            p = by_id[s.parent]
            assert p.tid == s.tid and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    roles = {
        "detect": {s.tid for s in kept if s.name == "letterbox"},
        "mid": {s.tid for s in kept if s.name == "boxes"},
        "collect": {s.tid for s in kept if s.name == "recognize" and any(
            c.parent == s.id and c.name == "download" and not c.attrs for c in kept)} - {
            s.tid for s in kept if s.name == "boxes"},
    }
    assert all(len(t) == 1 for t in roles.values()) and len(set.union(*roles.values())) == 3
    assert threading.get_native_id() in roles["collect"]
    # one batch number a batch, carried on all three threads
    numbers = sorted({s.batch for s in kept if s.name in spans.STAGES})
    assert len(numbers) == 3 and 0 not in numbers
    for n in numbers:
        assert {s.tid for s in kept if s.batch == n and s.name in spans.STAGES} == set.union(*roles.values())
    # a queue wait on each thread, named
    waits = {(s.tid, s.attrs["queue"], s.attrs["op"]) for s in kept if s.name == "stream.wait"}
    (d,), (m,), (c,) = roles["detect"], roles["mid"], roles["collect"]
    assert {(d, "q_mid", "put"), (m, "q_mid", "get"), (m, "q_out", "put"), (c, "q_out", "get")} <= waits
    # children where the engine opens them
    def children(parent_name, tid):
        return [(s.name, s.attrs) for s in kept if s.parent and by_id[s.parent].name == parent_name
                and s.tid == tid]

    assert ("craft", {}) in children("detect", d) and ("upload", {}) in children("letterbox", d)
    assert ("download", {}) in children("detect", m) and ("upload", {}) in children("rectify", m)
    assert children("recognize", m)[:4] == [("upload", {}), ("crnn", {"reread": False}),
                                           ("download", {"check": "reread"}), ("crnn", {"reread": True})]
    assert ("download", {}) in children("recognize", c)


def test_readtext_batch_has_a_batch_number(engine):
    with record_spans():
        engine.readtext_batch(_photos(1)[0])
        engine.readtext_batch(_photos(1)[0])
    kept = take_spans()
    numbers = sorted({s.batch for s in kept if s.name == "letterbox"})
    assert len(numbers) == 2 and 0 not in numbers and {s.batch for s in kept} == set(numbers)


def test_greedy_generate_spans():
    torch.manual_seed(0)
    model = vlm.PageReader(dim=16, enc_depth=1, dec_depth=1, heads=2, dtype=torch.float32).eval()
    page = torch.randint(0, 256, (2, 32, 24, 1), dtype=torch.uint8)
    with record_spans(), torch.no_grad():
        vlm.greedy_generate(model, page, max_len=6)
        vlm.greedy_generate(model, page, max_len=6)
    kept = take_spans()
    gens = [s for s in kept if s.name == "vlm.generate"]
    assert len(gens) == 2 and gens[0].batch != gens[1].batch and all(g.attrs == {"pages": 2} for g in gens)
    for g in gens:
        kids = sorted((s for s in kept if s.parent == g.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["vlm.encode"] + ["vlm.step"] * 5
        assert [s.attrs.get("step") for s in kids[1:]] == list(range(5))
        assert all(s.attrs["graph"] is False for s in kids[1:])  # no graph on the CPU
        assert all(s.batch == g.batch for s in kids)


def test_span_agrees_with_record_function():
    def worker():  # a thread started inside the session records too
        with span("worker"):
            pass

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with span("probe", k=1) as sp, torch.profiler.record_function("probe"):
            torch.ones(256, 256).matmul(torch.ones(256, 256))
            time.sleep(0.002)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    kept = take_spans()
    assert kept[0] is sp and sp.attrs == {"k": 1}
    assert [s.name for s in kept[1:]] == ["worker"] and kept[1].tid == t.native_id != sp.tid
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert abs(ev.start_ns() - sp.start_ns) < 1_000_000 and abs(ev.end_ns() - sp.end_ns) < 1_000_000
    assert sp.tid == threading.get_native_id() and sp.ident == threading.get_ident()


def test_device_trace_writes_the_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with span("probe"), torch.profiler.record_function("probe_fn"):
            torch.ones(64).sum()
            time.sleep(0.002)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "span"]
    (theirs,) = [e for e in events if e.get("name") == "probe_fn"]
    assert mine["name"] == "probe" and mine["tid"] == theirs["tid"] == threading.get_native_id()
    assert mine["pid"] == theirs["pid"] and abs(mine["ts"] - theirs["ts"]) < 1000
    assert abs(mine["dur"] - theirs["dur"]) < 1000 and mine["args"]["parent"] == 0
    assert take_spans() == []


# -- the benchmark's side: the trace, the attribution, the readers --------


class _Ev:
    def __init__(self, device, name, start, dur, corr=0, resource=0):
        self._d, self._n, self._s, self._dur, self._c, self._r = device, name, start, dur, corr, resource

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._d else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._c

    def device_resource_id(self):
        return self._r


def test_reduce_keeps_its_readings_and_adds_gaps_and_launches():
    t1, t2 = -352124160, 1969223360  # CUPTI's signed 32-bit thread ids
    events = [
        _Ev(0, "cudaLaunchKernel", 100, 5, corr=1, resource=t1),
        _Ev(0, "cuLaunchKernel", 101, 2, corr=1, resource=0),  # the same call without its thread
        _Ev(0, "Activity Buffer Request", 102, 2, corr=3, resource=t2),  # the profiler's own, not a call
        _Ev(0, "cudaMemcpyAsync", 200, 5, corr=2, resource=t2),
        _Ev(0, "cudaLaunchKernel", 300, 5, corr=3, resource=t1),
        _Ev(0, "cudaMalloc", 50, 5, corr=9, resource=t1),
        _Ev(0, "cudaLaunchKernel", 400, 5, corr=4, resource=0),  # CUPTI gave no thread: corr 3's
        _Ev(1, "gemm", 1_000, 10_000, corr=1),  # busy 1,000..11,000
        _Ev(1, "Memcpy HtoD (Pageable -> Device)", 11_010, 5_000, corr=2),  # a 10 ns gap
        _Ev(1, "relu", 12_000, 8_000, corr=3),  # overlaps the copy: 3,990 ns its own
        _Ev(1, "gemm", 50_000, 1_000, corr=4),  # a 30 us gap
        _Ev(1, "zero", 60_000, 0, corr=5),  # no duration: not an operation
        _Ev(1, "relu", 70_000, 500, corr=6),  # no runtime call joined
    ]
    trace = SpanTrace()
    trace._start_ns, trace._end_ns = 1_000, 70_500  # the window's edges at its first and last operation
    tr = trace._reduce(events)
    base = DeviceTrace._reduce(events)  # the result line's readings, as they are
    assert {k: getattr(tr, k) for k in vars(base)} == vars(base)
    assert tr.busy_s == pytest.approx(20_490e-9)  # the union of the intervals
    assert tr.kernels == 4
    assert tr.by_name == {"gemm": [2, pytest.approx(11_000e-9)], "relu": [2, pytest.approx(8_500e-9)],
                          "Memcpy HtoD (Pageable -> Device)": [1, pytest.approx(5_000e-9)]}
    assert tr.gaps == [("before gemm", 30_000e-9), ("before relu", 19_000e-9),
                       ("before Memcpy HtoD (Pageable -> Device)", 10e-9)]
    assert tr.idle == [(20_000, 50_000)] and tr.idle_short_s == pytest.approx(19_010e-9)
    assert tr.launches == [
        Launch(100, t1 & 0xFFFFFFFF, 10_000, True, "gemm"),
        Launch(200, t2, 5_000, False, "Memcpy HtoD (Pageable -> Device)"),
        Launch(300, t1 & 0xFFFFFFFF, 3_990, True, "relu"),
        Launch(400, t1 & 0xFFFFFFFF, 1_000, True, "gemm"),
        Launch(None, None, 500, True, "relu"),
    ]
    assert sum(ln.device_ns for ln in tr.launches) * 1e-9 == pytest.approx(tr.busy_s)
    assert tr.spans == []
    # with the window's edges apart from the operations: the idle before the
    # first and after the last
    trace._start_ns, trace._end_ns = 0, 100_000
    edged = trace._reduce(events)
    assert (edged.start_ns, edged.end_ns) == (0, 100_000)
    assert edged.idle == [(20_000, 50_000), (70_500, 100_000)] and edged.idle_short_s == pytest.approx(20_010e-9)
    assert (edged.busy_s, edged.gaps, edged.launches) == (tr.busy_s, tr.gaps, tr.launches)


def _sp(id, parent, name, tid, start, end, batch=1, **attrs):
    return Span(id, parent, batch, name, tid, tid + (7 << 32), start, end, attrs)


def _stream_summary():
    """Two threads: the detect thread (tid 10) with letterbox > upload and
    detect > craft; the middle thread (tid 20) with detect > download,
    boxes, recognize > crnn, download (the re-read check), crnn (re-read),
    then a queue wait and a second recognize with one crnn."""
    sp = [
        _sp(1, 0, "letterbox", 10, 0, 100),
        _sp(2, 1, "upload", 10, 10, 20),
        _sp(3, 0, "detect", 10, 100, 300),
        _sp(4, 3, "craft", 10, 110, 290),
        _sp(5, 0, "detect", 20, 300, 400),
        _sp(6, 5, "download", 20, 300, 380),
        _sp(7, 0, "boxes", 20, 400, 500),
        _sp(8, 0, "recognize", 20, 500, 800),
        _sp(9, 8, "crnn", 20, 510, 600, reread=False),
        _sp(10, 8, "download", 20, 600, 700, check="reread"),
        _sp(11, 8, "crnn", 20, 700, 790, reread=True),
        _sp(12, 0, "stream.wait", 20, 800, 1000, queue="q_out", op="put"),
        _sp(13, 0, "recognize", 20, 1000, 1100, batch=2),
        _sp(14, 13, "crnn", 20, 1010, 1090, batch=2, reread=False),
    ]
    k = lambda tid: (tid + (7 << 32)) & 0xFFFFFFFF  # noqa: E731
    launches = [
        Launch(15, k(10), 5, False, "Memcpy"),  # upload under letterbox
        Launch(50, k(10), 7, True, "k"),  # letterbox itself
        Launch(150, k(10), 100, True, "k"),  # craft
        Launch(160, k(10), 50, True, "k"),  # craft
        Launch(305, k(20), 20, False, "Memcpy"),  # the maps' download
        Launch(520, k(20), 30, True, "k"),  # crnn
        Launch(720, k(20), 40, True, "k"),  # the re-read's crnn
        Launch(1050, k(20), 10, True, "k"),  # the second recognize's crnn
        Launch(1050, k(10), 3, True, "k"),  # the detect thread, outside every span
        Launch(None, None, 11, True, "k"),  # no runtime call joined
    ]
    # the card idles at 380..500 (the middle thread: the download's end,
    # then boxes) and 850..1000 (both threads outside host work)
    idle = [(380, 500), (850, 1000)]
    return SpanSummary(busy_s=sum(ln.device_ns for ln in launches) * 1e-9, window_s=2e-6, completed=4,
                       idle=idle, launches=launches, spans=sp)


def test_launches_go_to_the_innermost_span_on_their_thread():
    tr = _stream_summary()
    got = [None if s is None else s.id for s in spans.innermost(tr.spans, tr.launches)]
    assert got == [2, 1, 4, 4, 6, 9, 11, 14, None, None]
    assert spans.launched_in(tr, "detect") == (170, 2)  # the download is a copy
    assert spans.launched_in(tr, "recognize") == (80, 3)
    assert spans.launched_in(tr, "crnn") == (80, 3)
    cov = spans.coverage(tr)
    assert (cov["inside_s"], cov["outside_s"], cov["unjoined_s"]) == (
        pytest.approx(262e-9), pytest.approx(3e-9), pytest.approx(11e-9))
    assert (cov["launches_inside"], cov["launches_outside"], cov["launches_unjoined"]) == (8, 1, 1)


def test_idle_meets_host_work_and_spans():
    tr = _stream_summary()
    # host work: stage spans less their downloads and queue waits
    assert spans.union(spans.host_work(tr.spans)) == [(0, 300), (380, 600), (700, 800), (1000, 1100)]
    assert spans.host_work(tr.spans, {20}) == [(380, 400), (400, 500), (500, 600), (700, 800), (1000, 1100)]
    assert spans.idle_outside(tr, spans.host_work(tr.spans)) == pytest.approx(100.0 * 150 / 270)
    by = spans.idle_by_span(tr)
    assert by[(20, "boxes")] == 100 and by[(20, "detect")] == 20 and by[(20, "stream.wait")] == 150
    assert by[(10, "-")] == 270
    assert sum(v for (tid, _), v in by.items() if tid == 20) == 270


def _reader(name):
    return registry.metric_reader(name)


STREAM_READINGS = {
    # device ns 170 (craft 150, the maps' download 20) over 4 photos
    "detect_device_s_per_photo.stream": 170e-9 / 4,
    "recognize_device_s_per_photo.stream": 80e-9 / 4,
    "recognize_kernels_per_photo.stream": 3 / 4,
    "retry_share.stream": 1 / 2,
    # the middle thread's host work: 20 + 100 + 100 + 100 + 100 ns of 2 us
    "mid_busy_pct.stream": 100.0 * 420e-9 / 2e-6,
    # downloads: 80 + 100 ns
    "host_wait_s_per_photo.stream": 180e-9 / 4,
    "idle_outside_spans_pct.stream": 100.0 * 150 / 270,
}


def _pagereader_summary():
    sp = [
        _sp(1, 0, "vlm.generate", 10, 0, 1000, pages=2),
        _sp(2, 1, "vlm.encode", 10, 0, 100),
        _sp(3, 1, "vlm.step", 10, 100, 400, step=0, graph=True),
        _sp(4, 1, "vlm.step", 10, 400, 1000, step=1, graph=False),
        _sp(5, 0, "vlm.generate", 10, 2000, 2500, batch=2, pages=2),
    ]
    k = (10 + (7 << 32)) & 0xFFFFFFFF
    launches = [Launch(50, k, 40, True, "k"), Launch(150, k, 100, True, "k"), Launch(500, k, 300, True, "k"),
                Launch(1500, k, 20, False, "Memcpy"), Launch(2100, k, 60, True, "k")]
    return SpanSummary(busy_s=520e-9, window_s=3e-6, completed=4, idle=[(900, 1200), (1800, 2100)],
                       launches=launches, spans=sp)


PAGE_READINGS = {
    "decode_step_device_ms.pagereader": 400e-6 / 2,
    "decode_step_host_ms.pagereader": 900e-6 / 2,
    "graph_replay_share.pagereader": 1 / 2,
    # idle 600 ns, of which 900..1000 and 2000..2100 inside a call
    "idle_between_calls_pct.pagereader": 100.0 * 400 / 600,
}


def _read(name, summary, kept):
    """The reading ``name`` of a traced window whose spans the program kept
    as ``kept``: a reader of ``portbench/metrics/`` where the benchmark
    declares it, else ``core/launches.py::READINGS``."""
    if name in launches.READINGS:
        if summary is not None:
            summary.spans = kept
        return launches.reading(name, summary)
    return _reader(name).read(SimpleNamespace(trace_summary=summary, state={"spans": kept}))


@pytest.mark.parametrize("name", sorted(STREAM_READINGS) + sorted(PAGE_READINGS))
def test_span_readers(name):
    summary = _stream_summary() if name in STREAM_READINGS else _pagereader_summary()
    want = {**STREAM_READINGS, **PAGE_READINGS}[name]
    assert _read(name, summary, summary.spans) == pytest.approx(want)
    assert _read(name, None, []) is None
    assert _read(name, summary, []) is None  # a program that records no spans
    if name in launches.READINGS:  # the other cell's window holds none of its spans
        other = _pagereader_summary() if name in STREAM_READINGS else _stream_summary()
        assert launches.reading(name, other) is None


def test_window_spans_are_taken_once_from_the_program():
    with record_spans(), span("probe"):
        pass
    run = SimpleNamespace(trace_summary=object(), state={})
    kept = spans.window_spans(run)
    assert [s.name for s in kept] == ["probe"] and spans.window_spans(run) is kept
    assert take_spans() == [] and spans.window_spans(SimpleNamespace(trace_summary=None, state={})) == []


def test_span_readers_are_declared():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        declared = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in {**STREAM_READINGS, **PAGE_READINGS}:
        if name in launches.READINGS:  # needs the launches, which the result line's trace does not keep
            assert name not in declared and not os.path.exists(os.path.join(registry.PORTBENCH, "metrics", name + ".py"))
            continue
        cell = "ocr_stream_camera" if name.endswith(".stream") else "pagereader_backlog128"
        assert declared[name]["workloads"][0] == cell
