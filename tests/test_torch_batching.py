"""The port's batcher, shared engine, pipelined stream, warm-up and text
helpers against the JAX package's, on the CPU.

- The no-engine extractor of each package over the same recording fake
  engine: the same wrapper, the same engine calls and the same output
  (the route fault: the port's extractor used to build a bare engine and
  take the fast path and the re-reads, which the JAX extractor's wrapped
  shared engine never takes).
- ``BatchingOCR``'s contract, as ``tests/test_batching_beam.py`` holds the
  JAX one to it.
- ``readtext_stream`` equal to ``readtext_batch`` per batch (texts equal,
  quads within 1e-5 px, confidences within 1e-5), and to the JAX engine's
  stream (texts equal, quads within 1 px, confidences within 1e-3), float32.
- ``warmup``'s calls, ``read_joined`` and ``read_lines`` as the JAX
  engine's.
"""

import os
import sys
import threading
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.extract import extractor as jax_extractor_module
from bbocr_tpu.runtime.batching import BatchingOCR as JaxBatchingOCR
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.extract import BookMetadataExtractor
from bbocr_tpu_torch.extract import extractor as port_extractor_module
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")
CANVAS = (416, 320)


class _RecordingEngine:
    """Fake engine: records every call; every image reads as the same two
    boxes, the first an ISBN-suspect with low confidence."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _results():
        return [(np.float32([[10, 10], [200, 10], [200, 40], [10, 40]]), "ISBN 978O3I6769488", 0.3),
                (np.float32([[10, 60], [150, 60], [150, 90], [10, 90]]), "The Title", 0.9)]

    def readtext_batch(self, images):
        self.calls.append(("readtext_batch", [tuple(np.shape(im)) for im in images]))
        return [self._results() for _ in images]

    def readtext(self, image):
        self.calls.append(("readtext", tuple(image.shape)))
        return self._results()

    def readtext_fast(self, image):
        self.calls.append(("readtext_fast", tuple(image.shape)))
        return self._results()

    def reread_low_conf(self, image, results, conf_ths):
        self.calls.append(("reread_low_conf", tuple(image.shape), conf_ths))
        return [(q, t.replace("O3I", "031"), c) for q, t, c in results]

    def reread_isbn(self, image, results):
        self.calls.append(("reread_isbn", tuple(image.shape)))
        return "9780316769488"

    def timings(self):
        return {}


@pytest.mark.parametrize("batching", [None, "0"], ids=["wrapped", "BB_OCR_BATCHING=0"])
@pytest.mark.parametrize("shape", [(1300, 900), (800, 600)], ids=["camera", "small"])
def test_no_engine_extractor_takes_the_jax_route(monkeypatch, batching, shape):
    """Both packages' extractors built with no engine take their shared
    engine from ``from_checkpoint`` (replaced by a recording fake, so no
    model runs): the same wrapper type, the same engine calls and the same
    text, lines and line infos. Wrapped, the route has no fast path and no
    re-read."""
    if batching is None:
        monkeypatch.delenv("BB_OCR_BATCHING", raising=False)
    else:
        monkeypatch.setenv("BB_OCR_BATCHING", batching)
    ours, ref = _RecordingEngine(), _RecordingEngine()
    monkeypatch.setattr(jax_extractor_module, "_ENGINE_CACHE", {})
    monkeypatch.setattr(JaxOCREngine, "from_checkpoint", classmethod(lambda cls, *a, **kw: ref))
    monkeypatch.setattr(port_extractor_module, "_ENGINE_CACHE", {}, raising=False)
    monkeypatch.setattr(OCREngine, "from_checkpoint", classmethod(lambda cls, *a, **kw: ours))
    jax_extractor = jax_extractor_module.BookMetadataExtractor(llm_backend="heuristic", warm_model=False)
    port_extractor = BookMetadataExtractor(llm_backend="heuristic", device="cpu")
    image = np.random.default_rng(0).integers(0, 256, shape).astype(np.float32)
    try:
        exp = jax_extractor._ocr_text(image, 0)
        got = port_extractor._ocr_text(image, 0)
        assert type(port_extractor.engine).__name__ == type(jax_extractor.engine).__name__
        assert ours.calls == ref.calls
        assert got[:3] == exp
        names = {c[0] for c in ours.calls}
        if batching is None:
            assert names == {"readtext_batch"}
            assert len(ours.calls) == (4 if shape == (1300, 900) else 1)
        else:
            assert {"reread_low_conf", "reread_isbn"} <= names
            assert ("readtext_fast" in names) == (shape == (800, 600))
        assert port_extractor.engine is BookMetadataExtractor(llm_backend="heuristic", device="cpu").engine
    finally:
        for extractor in (jax_extractor, port_extractor):
            if hasattr(extractor.engine, "close"):
                extractor.engine.close()


def test_shared_engine_names_missing_checkpoints(monkeypatch, tmp_path):
    monkeypatch.setenv("BB_OCR_CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(port_extractor_module, "_ENGINE_CACHE", {})
    with pytest.raises(FileNotFoundError, match="craft.npz"):
        BookMetadataExtractor(llm_backend="heuristic", device="cpu").engine


# ---------------------------------------------------------------------------
# BatchingOCR's contract (tests/test_batching_beam.py::TestBatchingOCR)
# ---------------------------------------------------------------------------


class _CountingEngine:
    def __init__(self, delay=0.02):
        self.calls = []
        self.delay = delay

    def readtext_batch(self, images):
        self.calls.append(len(images))
        time.sleep(self.delay)
        return [[(np.zeros((4, 2)), f"img{np.asarray(im).sum():.0f}", 0.9)] for im in images]

    def timings(self):
        return {"calls": len(self.calls)}


def _batcher(*args, **kwargs):
    from bbocr_tpu_torch.runtime.batching import BatchingOCR

    return BatchingOCR(*args, **kwargs)


def test_batcher_forwards_what_the_jax_one_forwards():
    public = {n for n in dir(JaxBatchingOCR) if not n.startswith("_")}
    assert {n for n in dir(type(_batcher(_CountingEngine()))) if not n.startswith("_")} == public
    b = _batcher(_CountingEngine(), max_batch=8, max_wait_ms=5)
    assert {"engine", "max_batch", "max_wait_s", "batches_dispatched", "images_processed"} <= set(vars(b))
    assert not hasattr(b, "readtext_fast") and not hasattr(b, "reread_low_conf") and not hasattr(b, "reread_isbn")
    b.close()


def test_batcher_single_request():
    eng = _CountingEngine()
    b = _batcher(eng, max_batch=8, max_wait_ms=5)
    assert b.readtext(np.ones((4, 4)))[0][1] == "img16"
    assert (b.batches_dispatched, b.images_processed, b.timings()) == (1, 1, {"calls": 1})
    b.close()


def test_batcher_coalesces_concurrent_requests():
    eng = _CountingEngine(delay=0.05)
    b = _batcher(eng, max_batch=16, max_wait_ms=30)
    results = {}

    def worker(i):
        results[i] = b.readtext(np.full((2, 2), i, np.float32))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert all(results[i][0][1] == f"img{i * 4}" for i in range(10))
    assert b.batches_dispatched < 10 and sum(eng.calls) == 10 == b.images_processed
    b.close()


def test_batcher_keeps_every_request_under_contention():
    """Stress: 24 threads x 4 requests with a short switch interval; every
    caller gets its own result and the counters add up."""
    eng = _CountingEngine(delay=0.001)
    b = _batcher(eng, max_batch=7, max_wait_ms=1)
    errors = []

    def worker(i):
        for j in range(4):
            v = i * 4 + j
            got = b.readtext(np.full((1, 1), v, np.float32), timeout=30)
            if got[0][1] != f"img{v}":
                errors.append((v, got))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert b.images_processed == 96 == sum(eng.calls) and b.batches_dispatched == len(eng.calls)
    assert max(eng.calls) <= 7
    b.close()


def test_batcher_passes_engine_errors_to_callers():
    class Boom:
        def readtext_batch(self, images):
            raise RuntimeError("device on fire")

    b = _batcher(Boom(), max_wait_ms=1)
    with pytest.raises(RuntimeError, match="device on fire"):
        b.readtext(np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match="device on fire"):
        b.readtext_batch([np.zeros((2, 2)), np.ones((2, 2))])
    assert b.batches_dispatched == 0
    b.close()


def test_batcher_close_rejects_and_drains():
    class Slow:
        def readtext_batch(self, images):
            time.sleep(0.2)
            return [[] for _ in images]

    b = _batcher(Slow(), max_batch=1, max_wait_ms=1)
    # occupy the worker, then queue a request that close() must fail
    t = threading.Thread(target=lambda: b.readtext(np.zeros((2, 2)), timeout=2))
    t.start()
    time.sleep(0.05)
    fut = b._submit(np.zeros((2, 2)))
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=1)
    with pytest.raises(RuntimeError, match="closed"):
        b.readtext(np.zeros((2, 2)))
    t.join(timeout=5)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# Real engines: text helpers, stream, warm-up
# ---------------------------------------------------------------------------


def _jax_engine(config):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BB_OCR_COMPILE_CACHE", "0")  # no compilation cache under HOME
        return JaxOCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, config)


def _configs(canvases, **kw):
    knobs = dict(host_rectify=True, decoder="greedy", wire_bits=8, detect_coarse=0)
    knobs.update(kw)
    jax_config = JaxEngineConfig(canvases=tuple(JaxCanvasSpec(*c) for c in canvases), compute_dtype=jnp.float32,
                                 detect_pool=1, **knobs)
    port_config = EngineConfig(canvases=tuple(CanvasSpec(*c) for c in canvases), compute_dtype=torch.float32, **knobs)
    return jax_config, port_config


@pytest.fixture(scope="module")
def engines():
    jax_config, port_config = _configs([CANVAS])
    return _jax_engine(jax_config), OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, port_config, device="cpu")


@pytest.fixture(scope="module")
def cover_u8():
    gray = cv2.cvtColor(load_rgb(BOOK1), cv2.COLOR_RGB2GRAY)
    return cv2.resize(gray, (320, 400), interpolation=cv2.INTER_AREA)


def test_read_joined_and_read_lines_match_jax(engines, cover_u8):
    """The engine's helpers and the batcher's, against the JAX engine's."""
    jax_engine, port = engines
    joined, lines = jax_engine.read_joined(cover_u8), jax_engine.read_lines(cover_u8)
    assert joined and len(lines) > 1
    assert port.read_joined(cover_u8) == joined
    assert port.read_lines(cover_u8) == lines
    wrapped = _batcher(port, max_wait_ms=1)
    try:
        assert wrapped.read_joined(cover_u8) == joined
        assert wrapped.read_lines(cover_u8) == lines
        assert wrapped.read_lines(np.zeros((64, 64), np.uint8)) == jax_engine.read_lines(np.zeros((64, 64), np.uint8))
    finally:
        wrapped.close()


def _assert_same_results(got, want, quad_tol, conf_tol):
    """``got`` and ``want``: per batch, per image, the (quad, text,
    confidence) list."""
    assert [len(b) for b in got] == [len(b) for b in want]
    for g_img, w_img in zip((r for b in got for r in b), (r for b in want for r in b)):
        assert len(g_img) == len(w_img)
        for (gq, gt, gc), (wq, wt, wc) in zip(g_img, w_img):
            assert gt == wt
            assert np.abs(np.asarray(gq) - np.asarray(wq)).max() <= quad_tol
            assert abs(gc - wc) <= conf_tol


def _stream_batches(cover_u8):
    """``test_stream_matches_batch``'s batches (two canvases, an empty batch,
    mixed sizes), with the cover in the mix so that text is read."""
    rng = np.random.default_rng(1)
    cover = cv2.resize(cover_u8, (150, 200), interpolation=cv2.INTER_AREA)
    return [
        [rng.integers(0, 255, (200, 150), np.uint8), cover],
        [],
        [cv2.resize(cover_u8, (300, 420), interpolation=cv2.INTER_AREA)],
        [rng.integers(0, 255, (200, 150), np.uint8), cover, rng.integers(0, 255, (200, 150), np.uint8)],
    ]


@pytest.fixture(scope="module")
def stream_engines():
    canvases = [(128, 96), (256, 192)]
    jax_config, port_config = _configs(canvases, width_buckets=(32, 64), batch_capacities=(4, 8))
    return _jax_engine(jax_config), OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, port_config, device="cpu")


def test_stream_matches_batch_and_jax(stream_engines, cover_u8):
    jax_engine, port = stream_engines
    batches = _stream_batches(cover_u8)
    want = [port.readtext_batch(b) for b in batches]
    got = list(port.readtext_stream(iter(batches)))
    assert got[1] == []
    _assert_same_results(got, want, 1e-5, 1e-5)
    ref = list(jax_engine.readtext_stream(iter(batches)))
    assert sum(len(r) for b in ref for r in b) > 0
    _assert_same_results(got, ref, 1.0, 1e-3)


def test_stream_with_depth_one_and_a_generator(stream_engines, cover_u8):
    _, port = stream_engines
    batches = _stream_batches(cover_u8)
    got = list(port.readtext_stream((b for b in batches), depth=1))
    _assert_same_results(got, [port.readtext_batch(b) for b in batches], 1e-5, 1e-5)


def test_stream_raises_a_stage_error_in_the_consumer(stream_engines, cover_u8):
    _, port = stream_engines

    def batches():
        yield [cover_u8]
        raise ValueError("decoder failed")

    gen = port.readtext_stream(batches())
    with pytest.raises(ValueError, match="decoder failed"):
        list(gen)
    assert port._lock.acquire(timeout=5)  # the stream let go of the engine
    port._lock.release()


def test_abandoned_stream_does_not_hang(cover_u8):
    """A consumer that stops after the first batch closes the generator; the
    stage threads stop and are joined. The test has its own limit of 120 s
    and its own engine, so that a hang cannot hold a shared engine's lock."""
    _, port_config = _configs([(128, 96)], width_buckets=(32, 64), batch_capacities=(4, 8))
    port = OCREngine.from_checkpoint(CRAFT_NPZ, CRNN_NPZ, port_config, device="cpu")
    small = cv2.resize(cover_u8, (96, 128), interpolation=cv2.INTER_AREA)
    done = []

    def consume():
        gen = port.readtext_stream(([small] for _ in range(12)), depth=1)
        next(gen)
        gen.close()
        done.append(threading.active_count())

    before = threading.active_count()
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the abandoned stream did not return within 120 s"
    assert done and done[0] <= before + 1  # the stage threads are gone
    assert port.timings()["letterbox"]["count"] < 12  # detect took no further batch


class _StandInStages:
    """The engine's three stages as stand-ins that sleep a random moment,
    for the stream's thread protocol alone; ``fail`` names a stage that
    raises on the third batch."""

    def __init__(self, seed, fail=None):
        self._lock = threading.Lock()
        self.rng, self.fail = np.random.default_rng(seed), fail

    def _work(self, stage, ctx):
        time.sleep(float(self.rng.uniform(0, 0.003)))
        if stage == self.fail and ctx == 2:
            raise RuntimeError(f"{stage} failed")

    def _stage_detect(self, imgs):
        self._work("detect", imgs[0])
        return imgs[0]

    def _stage_boxes_recognize(self, ctx):
        self._work("mid", ctx)

    def _stage_collect(self, ctx):
        self._work("collect", ctx)
        return [ctx]


def _in_thread(fn, timeout=10):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    t.start()
    t.join(timeout=timeout)
    assert not t.is_alive(), "the stream hung"
    return out[0]


@pytest.mark.parametrize("fail", [None, "detect", "mid", "collect"])
def test_stream_protocol_never_hangs(fail):
    """60 streams of 6 batches over stand-in stages with random delays, each
    abandoned after its first batch, and one run to its end: no stream
    hangs (the JAX engine's drain, which also empties the middle queue,
    can swallow the detect stage's end marker), batches come in order, and
    a stage's error reaches the consumer after the batches before it."""
    for trial in range(60):
        stages = _StandInStages(trial, fail if fail != "collect" else None)

        def abandon():
            gen = OCREngine.readtext_stream(stages, ([i] for i in range(6)), depth=1)
            first = next(gen)
            gen.close()
            return first

        assert _in_thread(abandon) == [0]
        assert stages._lock.acquire(timeout=1)
        stages._lock.release()
    stages = _StandInStages(60, fail)

    def run():
        got = []
        try:
            for res in OCREngine.readtext_stream(stages, ([i] for i in range(6)), depth=2):
                got.append(res)
        except RuntimeError as e:
            return got, str(e)
        return got, None

    got, error = _in_thread(run)
    if fail is None:
        assert (got, error) == ([[i] for i in range(6)], None)
    else:
        assert got == [[0], [1]] and error == f"{fail} failed"


def test_warmup_calls_as_jax(stream_engines):
    """The same calls on the same default images (one uniform-noise gray
    image per canvas, from default_rng(0)): one batch, then each alone."""
    jax_engine, port = stream_engines
    calls = {"jax": [], "port": []}

    def recorder(name, kind):
        def record(images):
            calls[name].append((kind, [np.asarray(im).copy() for im in (images if kind == "batch" else [images])]))
            return [[]] * len(images) if kind == "batch" else []
        return record

    with pytest.MonkeyPatch.context() as mp:
        for name, eng in (("jax", jax_engine), ("port", port)):
            mp.setattr(eng, "readtext_batch", recorder(name, "batch"), raising=False)
            mp.setattr(eng, "readtext", recorder(name, "single"), raising=False)
        n_jax, n_port = jax_engine.warmup(), port.warmup()
    assert n_port == n_jax == 3
    assert [k for k, _ in calls["port"]] == [k for k, _ in calls["jax"]] == ["batch", "single", "single"]
    for (_, ours), (_, ref) in zip(calls["port"], calls["jax"]):
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(ours, ref))


def test_warmup_runs_the_engine(stream_engines):
    _, port = stream_engines
    before = port.timings().get("letterbox", {}).get("count", 0)
    assert port.warmup() == 3
    assert port.timings()["letterbox"]["count"] == before + 4  # two canvases batched, then each alone
