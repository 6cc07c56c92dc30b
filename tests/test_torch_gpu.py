"""The port's CUDA kernels against their plain versions, and its device
paths (beam, labels, stream, batcher, auto-crop, wire) against the CPU, on
a card.

Every test here is marked ``gpu`` and skips where no CUDA card is present.
The file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from bbocr_tpu_torch import kernels, ops
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.preprocess import preprocess_for_book_cover
from bbocr_tpu_torch.preprocess.chain import PLAIN_OPS, _preprocess

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
