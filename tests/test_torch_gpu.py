"""The port's CUDA kernels against their plain versions, its device paths
(beam, labels, stream, batcher, auto-crop, wire) against the CPU, and the
PageReader's graphed greedy decode against its eager cached step and the
full-buffer loop, on a card.

Every test here is marked ``gpu`` and skips where no CUDA card is present.
The file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -p no:cacheprovider
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from bbocr_tpu_torch import kernels, ops
from bbocr_tpu_torch.io import load_gray, load_rgb
from bbocr_tpu_torch.llm.native_vlm import letterbox_page
from bbocr_tpu_torch.models import vlm
from bbocr_tpu_torch.preprocess import preprocess_for_book_cover
from bbocr_tpu_torch.preprocess.chain import PLAIN_OPS, _preprocess
from bbocr_tpu_torch.utils.checkpoint import load_params
from pagereader_loops import cached_steps, full_buffer_generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOK1 = os.path.join(ROOT, "data", "real", "covers", "book1.png")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# the slice's shape and its neighbours, odd widths, images smaller than the
# 7-tap halo, and a row pitch that is not 8-byte aligned
SHAPES = [(2, 70, 90), (1, 33, 41), (1, 1312, 1050), (1, 1, 1), (1, 2, 3), (1, 3, 8), (2, 7, 5),
          (1, 1313, 1051), (1, 64, 4099)]


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, shape):
    """Bit-exact: the kernels round every operation as the plain versions do."""
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, shape).astype(np.float32)).to(cuda_device)
    mean = ops.rounded_mean(x)
    kernels.reset_launches()
    assert torch.equal(kernels.blur3_u8(x), kernels.blur3_u8_plain(x))
    assert torch.equal(kernels.unsharp_u8(x), kernels.unsharp_u8_plain(x))
    assert torch.equal(kernels.enhance_u8(x, mean, 1.9, 1.2), kernels.enhance_u8_plain(x, mean, 1.9, 1.2))
    assert all(fn.launches == 1 for fn in kernels.KERNELS.values())


@pytest.mark.parametrize("percent", [30, 31.5, -200, 70000])
def test_cuda_unsharp_takes_any_percent(cuda_device, percent):
    """Integer percents up to 65793 divide in integers, others in float:
    both bit-exact against the plain version."""
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (1, 97, 300)).astype(np.float32)).to(cuda_device)
    assert torch.equal(kernels.unsharp_u8(x, percent, 0), kernels.unsharp_u8_plain(x, percent, 0))


def test_cuda_kernels_take_an_unaligned_view(cuda_device):
    """A contiguous view 4 bytes past an 8-byte boundary takes the 4-byte path."""
    flat = torch.from_numpy(np.random.default_rng(10).integers(0, 256, 2 * 40 * 64 + 1).astype(np.float32)).to(cuda_device)
    x = flat[1:].view(2, 40, 64)
    assert x.data_ptr() % 8 == 4
    assert torch.equal(kernels.blur3_u8(x), kernels.blur3_u8_plain(x))
    assert torch.equal(kernels.unsharp_u8(x), kernels.unsharp_u8_plain(x))


def test_cuda_chain_matches_plain_chain(cuda_device):
    rgb = load_rgb(BOOK1)
    a, _ = preprocess_for_book_cover(rgb, device=cuda_device)
    b = _preprocess(rgb, 1.5, cuda_device, PLAIN_OPS)
    assert torch.equal(a, b)


def test_cuda_wrapper_rejects_cpu_mean(cuda_device):
    x = torch.zeros((1, 8, 8), device=cuda_device)
    with pytest.raises(ValueError):
        kernels.enhance_u8(x, torch.zeros(1), 1.9, 1.2)


@pytest.mark.parametrize("shape,lengths", [((8, 95, 97), [95, 60, 31, 1, 95, 80, 47, 12]), ((3, 24, 12), None)],
                         ids=["reread_batch", "small"])
def test_cuda_beam_matches_cpu(cuda_device, shape, lengths):
    """The device prefix beam on the card: the CPU's ids and lengths, scores
    within 1e-4 (exp and log are not the CPU's to the last bit)."""
    from bbocr_tpu_torch.decode.beam_device import ctc_beam_decode_device

    logits = torch.from_numpy(np.random.default_rng(12).normal(0, 3, shape).astype(np.float32))
    if lengths is None:
        logits = torch.round(logits)  # ties
    lens = None if lengths is None else torch.tensor(lengths)
    cpu = ctc_beam_decode_device(logits, lens, max_len=48)
    card = ctc_beam_decode_device(logits.to(cuda_device), None if lens is None else lens.to(cuda_device), max_len=48)
    assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])
    assert float((card[2].cpu() - cpu[2]).abs().max()) <= 1e-4


@pytest.mark.parametrize("max_iters", [1024, 13])
def test_cuda_labels_match_cpu(cuda_device, max_iters):
    """Device CC labeling and component stats on the card equal the CPU's,
    also when the step cap stops the labeling early."""
    from bbocr_tpu_torch.decode.cc_device import component_stats_device, label_components_device

    rng = np.random.default_rng(13)
    mask = torch.from_numpy(rng.uniform(0, 1, (120, 160)) > 0.45)
    score = torch.from_numpy(rng.uniform(0, 1, (120, 160)).astype(np.float32))
    cpu, cpu_steps = label_components_device(mask, max_iters=max_iters)
    card, card_steps = label_components_device(mask.to(cuda_device), max_iters=max_iters)
    assert torch.equal(card.cpu(), cpu) and card_steps == cpu_steps
    for a, b in zip(component_stats_device(card, 24, score.to(cuda_device)), component_stats_device(cpu, 24, score)):
        assert torch.equal(a.cpu(), b)


def _small_card_engine(device):
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    return OCREngine.from_checkpoint(
        os.path.join(ROOT, "checkpoints", "craft.npz"), os.path.join(ROOT, "checkpoints", "crnn.npz"),
        EngineConfig(canvases=(CanvasSpec(704, 512), CanvasSpec(512, 704)), compute_dtype=torch.float32),
        device=device,
    )


def _cover_batches():
    rng = np.random.default_rng(14)
    covers = [load_rgb(os.path.join(ROOT, "data", "real", "covers", f"book{i}.png")) for i in (2, 4)]
    return [covers, [], [covers[1][::-1].copy()], [covers[0], rng.integers(0, 256, (600, 800), np.uint8), covers[1]]]


def _same_results(a, b):
    return len(a) == len(b) and all(
        len(x) == len(y) and all(tx == ty and np.abs(qx - qy).max() <= 1e-5 and abs(cx - cy) <= 1e-5
                                 for (qx, tx, cx), (qy, ty, cy) in zip(x, y))
        for x, y in zip(a, b))


def test_cuda_stream_matches_batch(cuda_device):
    """``readtext_stream`` on the card: each batch equals ``readtext_batch``."""
    engine = _small_card_engine(cuda_device)
    batches = _cover_batches()
    want = [engine.readtext_batch(b) for b in batches]
    got = list(engine.readtext_stream(iter(batches)))
    assert got[1] == [] and sum(len(r) for b in got for r in b) > 0
    assert all(_same_results(g, w) for g, w in zip(got, want))


def test_cuda_batcher_results_equal_their_batches(cuda_device):
    """``BatchingOCR`` over a card engine under 4 threads: fewer batches than
    requests, and each result equals ``readtext_batch`` on the batch it was
    coalesced into."""
    import threading

    from bbocr_tpu_torch.runtime.batching import BatchingOCR

    engine = _small_card_engine(cuda_device)
    photos = [p for b in _cover_batches() for p in b]
    batches = []
    inner = engine.readtext_batch

    def recording(images):
        out = inner(images)
        batches.append((list(images), out))
        return out

    engine.readtext_batch = recording
    wrapped = BatchingOCR(engine, max_wait_ms=20)
    got = {}

    def worker(t):
        for i, photo in enumerate(photos):
            got[(t, i)] = (photo, wrapped.readtext(photo, timeout=300))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wrapped.close()
    assert not any(t.is_alive() for t in threads)
    assert wrapped.images_processed == 4 * len(photos) and wrapped.batches_dispatched < 4 * len(photos)
    for images, out in batches:
        assert all(_same_results([a], [b]) for a, b in zip(inner(images), out))


def test_cuda_autocrop_and_wire_match_cpu(cuda_device):
    """The auto-crop mask and rectangle, the pooled canvas and the wire
    unpacking on the card equal the CPU's."""
    from bbocr_tpu_torch.preprocess import auto_crop_text_region, text_mask
    from bbocr_tpu_torch.runtime.wire import pack_canvas, unpack_widen

    pre, _ = preprocess_for_book_cover(load_rgb(os.path.join(ROOT, "data", "real", "covers", "book4.png")), device="cpu")
    for a, b in zip(text_mask(pre.to(cuda_device)), text_mask(pre)):
        assert torch.equal(a.cpu(), b)
    assert auto_crop_text_region(pre.to(cuda_device), 128) == auto_crop_text_region(pre, 128)
    canvas = np.random.default_rng(15).integers(0, 256, (2, 64, 96)).astype(np.uint8)
    for bits in (1, 2, 4, 8):
        packed = torch.from_numpy(pack_canvas(canvas, bits))
        assert torch.equal(unpack_widen(packed.to(cuda_device), bits).cpu(), unpack_widen(packed, bits))
    x = torch.from_numpy(canvas.astype(np.float32))
    pooled = x.to(cuda_device).reshape(2, 16, 4, 24, 4).mean((2, 4)).cpu()
    assert torch.equal(pooled, x.reshape(2, 16, 4, 24, 4).mean((2, 4)))


def test_span_brackets_the_device_work_it_launches(cuda_device):
    """In a CUDA-only profiler session (the benchmark's) spans are recorded;
    a span around ``torch.cuda._sleep`` and ``synchronize()`` brackets the
    sleep kernel's device interval and the runtime call that launched it,
    whose thread is the span's (CUPTI's id: the low 32 bits of
    ``threading.get_ident()``); ``SpanTrace`` puts every launch of the
    window down to the span."""
    from bbocr_tpu_torch.utils.profiling import recording, span, take_spans
    from portbench.core import spans
    from portbench.core.launches import SpanTrace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    take_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        assert recording()
        with span("sleep") as sp:
            torch.cuda._sleep(10_000_000)
            torch.cuda.synchronize()
    kept = take_spans()
    events = list(prof.profiler.kineto_results.events())
    (k,) = [e for e in events if "spin_kernel" in e.name()]
    calls = [e for e in events if e.device_type() != k.device_type() and e.correlation_id() == k.correlation_id()
             and e.name().startswith("cu")]  # not the profiler's own events
    k_end = k.start_ns() + k.duration_ns()
    print(f"\nspan offsets: the launch calls {[(e.name(), (e.start_ns() - sp.start_ns) / 1e3) for e in calls]} us "
          f"after the span opens, the kernel {(k.start_ns() - sp.start_ns) / 1e3:.1f} us after, ends "
          f"{(sp.end_ns - k_end) / 1e3:.1f} us before it closes ({k.duration_ns() / 1e6:.3f} ms); CUPTI threads "
          f"{[e.device_resource_id() & 0xFFFFFFFF for e in calls]}, the span's {spans.thread_key(sp.ident)}; "
          f"start_thread_id {[e.start_thread_id() for e in calls]}")
    assert kept == [sp] and calls
    assert all(sp.start_ns <= e.start_ns() <= k.start_ns() for e in calls) and k_end <= sp.end_ns
    assert spans.thread_key(sp.ident) in {e.device_resource_id() & 0xFFFFFFFF for e in calls}
    def work():
        with span("sleep"):
            torch.cuda._sleep(1_000_000)
            out.append(torch.ones(1024, device=cuda_device).cpu())

    out = []
    with SpanTrace() as t:  # on the calling thread and on one started inside the session
        work()
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=60)
    tr = t.summary
    print(f"two threads: {len(tr.launches)} launches, threads {sorted({ln.thread for ln in tr.launches})}, spans on "
          f"{sorted((spans.thread_key(s.ident), s.tid) for s in tr.spans)}; {spans.coverage(tr)}")
    assert len(tr.spans) == 2 and {s.tid for s in tr.spans} == {threading.get_native_id(), worker.native_id}
    assert len(tr.launches) >= 6 and [float(x.sum()) for x in out] == [1024.0, 1024.0]
    owners = spans.innermost(tr.spans, tr.launches)
    assert all(s is not None for s in owners) and {s.tid for s in owners} == {s.tid for s in tr.spans}
    assert spans.coverage(tr)["inside_s"] == pytest.approx(tr.busy_s)


VLM_CKPT = os.path.join(ROOT, "checkpoints", "vlm.npz")
VLM_PAGES = os.path.join(ROOT, "tests", "data", "vlm_jax_f32.json")


def _pagereader(dev, dtype):
    return vlm.PageReader(dtype=dtype).load_params(load_params(VLM_CKPT)).to(dev).eval()


def _vlm_pages(dev, n):
    """The 24 recorded pages as the ``tpu`` route makes them, cycled to ``n``:
    (n, 256, 192, 1) float32 on ``dev``."""
    with open(VLM_PAGES) as f:
        rels = [p["page"] for p in json.load(f)["pages"]]
    pages = []
    for rel in rels[:n]:
        with open(os.path.join(ROOT, rel), "rb") as f:
            pages.append(letterbox_page(load_gray(f.read())))
    return torch.from_numpy(np.stack([pages[i % len(pages)] for i in range(n)]))[..., None].to(dev)


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graph_decode_equals_the_eager_step(cuda_device, dtype, batch):
    """Replaying the captured step gives the eager cached step's ids bit for
    bit, on the shipped checkpoint; each replay moved the step index on, so
    the graph holds the step."""
    model = _pagereader(cuda_device, dtype)
    page = _vlm_pages(cuda_device, batch)
    ids = vlm.greedy_generate(model, page)
    (state,) = vlm._STATES[model].values()
    assert state.graph is not None and int(state.t) == vlm.MAX_JSON_LEN - 1
    assert torch.equal(ids, cached_steps(model, page)[0])


def test_cuda_graph_decode_on_a_second_card():
    """The PageReader on ``cuda:1`` while ``cuda:0`` is current (as
    ``--device cuda:1`` runs it): the step is captured on the page's card, so
    each replay moves the step index on and the ids are the eager cached
    step's there. A step launched on the other card's stream would leave the
    graph empty and the read BOS then PAD."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        model = _pagereader(dev, torch.float32)
        page = _vlm_pages(dev, 2)
        ids = vlm.greedy_generate(model, page)
        assert torch.cuda.current_device() == 0
        (state,) = vlm._STATES[model].values()
        assert int(state.t) == vlm.MAX_JSON_LEN - 1
        assert torch.equal(ids, cached_steps(model, page)[0])
        assert bool((ids[:, 1] != vlm.PAD_ID).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cached_decode_reads_as_the_full_buffer_loop(cuda_device, dtype):
    """The 24 recorded pages at once: the graphed decode's ids against the
    full-buffer loop's on the card, equal in float32; each step's logits
    against row ``t`` of one full-buffer pass over the same ids, within
    1e-4 in float32 (printed in both types: bfloat16's differ where a
    float32 sum over another GEMM shape rounds to the other side)."""
    model = _pagereader(cuda_device, dtype)
    page = _vlm_pages(cuda_device, 24)
    want, _ = full_buffer_generate(model, page)
    ids = vlm.greedy_generate(model, page)
    got, got_logits = cached_steps(model, page)
    with torch.no_grad():
        forced = model.decode(model.encode(page), got)[:, :-1].transpose(0, 1)
    gap = float((got_logits - forced).abs().max())
    same = sum(bool(torch.equal(a, b)) for a, b in zip(ids, want))
    print(f"\n{dtype}: {same} of 24 pages read as the full-buffer loop; a step's logits within {gap:.3g} of a "
          f"full-buffer pass over the same ids")
    assert torch.equal(ids, got)
    if dtype == torch.float32:
        assert same == 24 and gap < 1e-4


def test_cuda_graph_decode_reads_parameters_changed_in_place(cuda_device):
    """Between two calls, a cross-attention kernel and the head's bias change
    in place (as a training step changes them): the second call's last
    logits are the eager step's on the changed model, bit for bit."""
    model = _pagereader(cuda_device, torch.float32)
    page = _vlm_pages(cuda_device, 2)
    vlm.greedy_generate(model, page)
    (state,) = vlm._STATES[model].values()
    before = state.logits.clone()
    with torch.no_grad():
        model.blocks[1].attns[1].key.weight.mul_(0.5)
        model.head.bias[vlm.EOS_ID] += 5.0
    ids = vlm.greedy_generate(model, page)
    tokens, logits = cached_steps(model, page)
    assert not torch.equal(state.logits, before)
    assert torch.equal(ids, tokens) and torch.equal(state.logits, logits[-1])


def test_cuda_graph_per_batch_size(cuda_device):
    model = _pagereader(cuda_device, torch.bfloat16)
    pages = _vlm_pages(cuda_device, 3)
    ids = [vlm.greedy_generate(model, pages[:1]), vlm.greedy_generate(model, pages)]
    states = vlm._STATES[model]
    assert sorted(key[0] for key in states) == [1, 3]
    graphs = [state.graph for state in states.values()]
    assert all(g is not None for g in graphs) and graphs[0] is not graphs[1]
    assert torch.equal(ids[0], cached_steps(model, pages[:1])[0]) and torch.equal(ids[1], cached_steps(model, pages)[0])


def test_cuda_graph_capture_beside_another_thread(cuda_device):
    """While the decode captures its step, another thread allocates,
    launches and synchronises: the capture succeeds and reads as eager.
    (The other thread draws no random numbers: PyTorch refuses a draw on the
    card's generator while any thread captures.)"""
    model = _pagereader(cuda_device, torch.bfloat16)
    page = _vlm_pages(cuda_device, 4)
    stop, done = threading.Event(), []

    def churn():
        while not stop.is_set():
            x = torch.full((512, 512), 0.5, device=cuda_device)
            done.append(float((x @ x).sum()))

    worker = threading.Thread(target=churn)
    worker.start()
    try:
        ids = vlm.greedy_generate(model, page)
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and done
    assert torch.equal(ids, cached_steps(model, page)[0])


def test_cuda_graph_kernels_show_in_the_benchmark_trace(cuda_device):
    """A graph captured before a CUDA-only profiler session (the benchmark
    captures in set-up, traces later): its replays' kernels are in the
    session's events, with their device time."""
    from portbench.core.trace import DeviceTrace

    model = _pagereader(cuda_device, torch.bfloat16)
    page = _vlm_pages(cuda_device, 8)
    vlm.greedy_generate(model, page)
    torch.cuda.synchronize()
    with DeviceTrace() as t:
        vlm.greedy_generate(model, page)
        torch.cuda.synchronize()
    tr = t.summary
    print(f"\none traced call of 8 pages: {tr.kernels} kernels ({tr.kernels / 191:.1f} a step), busy {tr.busy_s:.4f} s; "
          f"top {tr.top_ops(3)}")
    assert tr.kernels > 191 * 100
