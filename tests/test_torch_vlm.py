"""The port's PageReader route against the JAX package's.

- The token helpers equal JAX's.
- A seeded small ``PageReader`` (the size of ``tests/test_models.py``'s),
  initialised by flax with its CTC head, carried over and compared live
  with the jitted flax model: logits and ``encode_ctc`` within 1e-5 in
  float32 and the greedy ids equal; in bfloat16 within 0.05 (three
  bfloat16 steps at the logits' size: the products' float32 sums meet
  bfloat16 midpoints in another order, and XLA's fusions drop roundings
  that flax run op by op makes).
- The shipped ``checkpoints/vlm.npz`` against the JAX package's recorded
  readings (``tests/data/vlm_jax_{f32,bf16}.json``, logits in
  ``vlm_jax_*_logits.npz``; ``scripts/torch_port_reference.py --vlm``):
  float32 teacher-forced logits within 1e-4 of JAX's at every step up to
  the first EOS on all 24 recorded pages, and their argmax the recorded ids,
  which proves the greedy ids (with the causal mask the greedy buffer is a
  fixed point of one teacher-forced pass); the full 191-step greedy on one
  page. In bfloat16 the logits of six pages lie within 1.0 of JAX's jitted
  run: bfloat16 roundings that differ in one place in a thousand per
  operation compound over ten blocks, and JAX's own op-by-op and jitted
  runs differ by up to 0.33 on these pages.
- ``greedy_generate``'s cached step against the full-buffer loop it
  replaced (``tests/pagereader_loops.py``: 191 passes of ``decode``, the
  argmax of row ``t``, sticky EOS) on a seeded small ``PageReader``, at
  batch 1 and 3 and ``max_len`` 6 and 24, one row reaching EOS at slot 3:
  the ids equal, each step's logits within 1e-5 in float32 and 0.05 in
  bfloat16 (the products' float32 sums run over other GEMM shapes).
- The client: ``_page_from_b64`` pixel for pixel with the JAX client's on
  PNG and JPEG inputs of several modes and aspect ratios,
  ``create_llm_client("tpu")`` the cached client, ``_ensure_loaded``
  following a changed path.
- The routes, float32 through ``client._model``: the extractor's ``tpu``
  route on ``books/1`` through ``process_book --llm-backend tpu`` with the
  shared engine on one 416x320 canvas; ``vlm_bench --backend tpu`` over two
  books (a stub engine: the fields come from the PageReader alone); and
  ``vlm_eval``'s ``eval_real`` on two books, each equal to the JAX run.
"""

import base64
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bbocr_tpu.llm import native_vlm as jax_native
from bbocr_tpu.models import vlm as jax_vlm
from bbocr_tpu_torch.cli import process_book, vlm_bench, vlm_eval
from bbocr_tpu_torch.extract import extractor as extractor_module
from bbocr_tpu_torch.llm import NativeVLMClient, create_llm_client, native_vlm
from bbocr_tpu_torch.models import vlm
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.utils.checkpoint import load_params
from pagereader_loops import cached_steps, full_buffer_generate

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CKPT = os.path.join(ROOT, "checkpoints", "vlm.npz")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(dim=32, enc_depth=1, dec_depth=1, heads=2, max_len=24)


def _reference(suffix):
    with open(os.path.join(DATA, f"vlm_jax_{suffix}.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(DATA, ref["logits_file"])) as lg:
        logits = [lg[f"page{i}"] for i in range(len(ref["pages"]))]
    return ref, logits


@pytest.fixture(scope="module")
def tree():
    return load_params(CKPT)


def _small_init(seed, page, toks):
    """float32 parameters of a small flax PageReader with its CTC head (the
    parameters are float32 whatever the compute type)."""
    jm = jax_vlm.PageReader(dtype=jnp.float32, **SMALL)
    return jax.jit(lambda key, a, b: jm.init(key, a, b, with_ctc=True))(jax.random.PRNGKey(seed), page, toks)


def _page(rel):
    with open(os.path.join(ROOT, rel), "rb") as f:
        return NativeVLMClient._page_from_b64(base64.b64encode(f.read()).decode())


def test_token_helpers_match_jax():
    long = '{"title":"' + "A very long title, " * 20 + '"}'
    for text in ('{"title":"Red Men","year":"1915"}', "", "ünïcödé ~ {}", long):
        ids, n = vlm.encode_json(text)
        want_ids, want_n = jax_vlm.encode_json(text)
        np.testing.assert_array_equal(ids, want_ids)
        assert n == want_n and ids.dtype == want_ids.dtype
        assert vlm.decode_ids(ids) == jax_vlm.decode_ids(want_ids)
        assert vlm.decode_ids(torch.from_numpy(ids)) == jax_vlm.decode_ids(want_ids)
    assert (vlm.PAD_ID, vlm.BOS_ID, vlm.EOS_ID, vlm.VOCAB_SIZE, vlm.MAX_JSON_LEN) == (
        jax_vlm.PAD_ID, jax_vlm.BOS_ID, jax_vlm.EOS_ID, jax_vlm.VOCAB_SIZE, jax_vlm.MAX_JSON_LEN)
    for h, w, d in ((32, 24, 192), (8, 6, 32), (1, 1, 4)):
        np.testing.assert_array_equal(vlm._sincos_2d(h, w, d), jax_vlm._sincos_2d(h, w, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_pagereader_matches_flax(dtype):
    """A seeded small PageReader with its CTC head, flax against the port
    on the same numpy-seeded pages and tokens."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    page = rng.uniform(0, 255, (2, 64, 48, 1)).astype(np.float32)
    toks = rng.integers(1, jax_vlm.VOCAB_SIZE, (2, 24)).astype(np.int32)
    jm = jax_vlm.PageReader(dtype=jdt, **SMALL)
    params = _small_init(3, jnp.asarray(page), jnp.asarray(toks))
    model = vlm.PageReader(dtype=tdt, **SMALL).load_params(jax.tree_util.tree_map(np.asarray, params))
    assert model.ctc_head is not None
    want, want_ctc = jax.jit(lambda p, a, b: jm.apply(p, a, b, with_ctc=True))(
        params, jnp.asarray(page), jnp.asarray(toks))
    with torch.no_grad():
        got, got_ctc = model(torch.from_numpy(page), torch.from_numpy(toks).long(), with_ctc=True)
    tol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    np.testing.assert_allclose(got_ctc.numpy(), np.asarray(want_ctc), rtol=0, atol=tol)
    if dtype == "float32":
        ids = vlm.greedy_generate(model, torch.from_numpy(page), max_len=24)
        want_ids = np.asarray(jax_vlm.greedy_generate(params, jm, jnp.asarray(page), max_len=24))
        np.testing.assert_array_equal(ids.numpy(), want_ids)


def test_checkpoint_tree_maps_every_key(tree):
    """The shipped tree has 210 arrays and no CTC head: every array lands in
    the module, and ``encode_ctc`` then refuses."""
    sd = vlm.PageReader().load_params(tree).state_dict()
    assert len(sd) == 210 and not any(k.startswith("ctc_head") for k in sd)
    model = vlm.PageReader(dtype=torch.float32).load_params(tree)
    with pytest.raises(ValueError, match="ctc_head"):
        model.encode_ctc(torch.zeros(1, 256, 192, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_forced_logits_match_jax(tree, dtype):
    """Teacher-forced logits of the shipped checkpoint on JAX's greedy ids:
    float32 within 1e-4 on all 24 pages with the argmax equal to the ids;
    bfloat16 within 1.0 on six."""
    suffix = "f32" if dtype == "float32" else "bf16"
    ref, logits = _reference(suffix)
    assert len(ref["pages"]) == 24
    model = vlm.PageReader(dtype=DTYPES[dtype][1]).load_params(tree).eval()
    pages = list(zip(ref["pages"], logits))
    if dtype == "bfloat16":
        pages = pages[::4]
    for p, want in pages:
        with torch.no_grad():
            got = model(torch.from_numpy(_page(p["page"]))[None, ..., None], torch.tensor([p["ids"]]))[0]
        got = got[: p["steps"]].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if dtype == "float32" else 1.0, err_msg=p["page"])
        if dtype == "float32":
            np.testing.assert_array_equal(got.argmax(-1), p["ids"][1 : p["steps"] + 1], err_msg=p["page"])


def test_checkpoint_greedy_matches_jax(tree):
    """The full 191-step greedy decode of one page, float32."""
    ref, _ = _reference("f32")
    p = ref["pages"][3]
    model = vlm.PageReader(dtype=torch.float32).load_params(tree).eval()
    ids = vlm.greedy_generate(model, torch.from_numpy(_page(p["page"]))[None, ..., None])
    assert ids[0].tolist() == p["ids"]
    assert vlm.decode_ids(ids[0]) == p["text"]


@pytest.mark.parametrize("max_len", [6, 24])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_greedy_matches_the_full_buffer_loop(dtype, batch, max_len):
    """Pages black, white and seeded noise: the noise's row emits EOS into
    slot 3 and keeps it, the others run on (batch 1 takes the noise)."""
    torch.manual_seed(0)
    model = vlm.PageReader(dim=32, enc_depth=1, dec_depth=2, heads=2, max_len=24, dtype=DTYPES[dtype][1]).eval()
    noise = torch.randint(0, 256, (32, 24, 1), generator=torch.Generator().manual_seed(0)).float()
    page = torch.stack([torch.zeros(32, 24, 1), torch.full((32, 24, 1), 255.0), noise])[-batch:]
    want, want_logits = full_buffer_generate(model, page, max_len)
    assert want[-1, 3:].eq(vlm.EOS_ID).all() and not want[-1, :3].eq(vlm.EOS_ID).any()
    if batch == 3:
        assert not want[:2, :4].eq(vlm.EOS_ID).any()
    ids = vlm.greedy_generate(model, page, max_len)
    got, got_logits = cached_steps(model, page, max_len)
    assert torch.equal(ids, want) and torch.equal(got, want)
    tol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got_logits.numpy(), want_logits.numpy(), rtol=0, atol=tol)


def _encoded(arr, mode, fmt):
    img = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
    buf = io.BytesIO()
    img.save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return base64.b64encode(buf.getvalue()).decode()


def test_page_loader_matches_jax_client():
    """Gray, RGB and RGBA PNGs and gray and RGB JPEGs, taller and wider than
    the page, the page's own size and tiny, and repository photos: the
    port's page equals the JAX client's (Pillow) pixel for pixel."""
    rng = np.random.default_rng(11)
    inputs = []
    for rel in ("data/real/covers/book1.png", "books/1/IMG_0000.jpg", "data/real/photos/3/IMG_9687.jpg"):
        with open(os.path.join(ROOT, rel), "rb") as f:
            inputs.append((rel, base64.b64encode(f.read()).decode()))
    for h, w in ((37, 300), (500, 41), (256, 192), (3, 2), (801, 603)):
        for mode, fmt in (("L", "PNG"), ("RGB", "PNG"), ("RGBA", "PNG"), ("L", "JPEG"), ("RGB", "JPEG")):
            arr = rng.integers(0, 256, (h, w, {"L": 1, "RGB": 3, "RGBA": 4}[mode]), dtype=np.uint8)
            inputs.append((f"{h}x{w} {mode} {fmt}", _encoded(arr, mode, fmt)))
    for name, b64 in inputs:
        got = NativeVLMClient._page_from_b64(b64)
        assert got.dtype == np.float32 and got.shape == (native_vlm.PAGE_H, native_vlm.PAGE_W)
        np.testing.assert_array_equal(got, jax_native.NativeVLMClient._page_from_b64(b64), err_msg=name)


def test_create_llm_client_returns_the_cached_native_client(monkeypatch):
    monkeypatch.setattr(native_vlm, "_CLIENT_CACHE", {})
    monkeypatch.delenv("BB_OCR_VLM_CKPT", raising=False)
    client = create_llm_client("tpu", device="cpu")
    assert isinstance(client, NativeVLMClient) and client.device == torch.device("cpu")
    assert create_llm_client("native", device="cpu") is client
    assert create_llm_client("pagereader", device="cpu") is client
    assert client.ckpt_path == native_vlm.DEFAULT_CKPT == jax_native.DEFAULT_CKPT
    assert client.generate("x", "prompt", []) == "{}"  # no image: nothing to read, nothing loaded
    assert client._model is None
    monkeypatch.setenv("BB_OCR_VLM_CKPT", "elsewhere.npz")
    assert create_llm_client("tpu", device="cpu").ckpt_path == "elsewhere.npz"


def _small_checkpoint(path, seed):
    params = _small_init(seed, jnp.zeros((1, 256, 192, 1)), jnp.zeros((1, 24), jnp.int32))
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path, **flat)


def test_ensure_loaded_follows_a_changed_path(tmp_path):
    """Two small checkpoints: a ``model`` argument that is a file names the
    checkpoint of the call, and the client reloads when it changes, as the
    JAX client does; each reply equals the JAX client's."""
    paths = [str(tmp_path / f"vlm{seed}.npz") for seed in (1, 2)]
    for seed, path in zip((1, 2), paths):
        _small_checkpoint(path, seed)
    with open(os.path.join(ROOT, "data", "real", "covers", "book2.png"), "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    port = NativeVLMClient(paths[0], device="cpu")
    port._model = vlm.PageReader(dtype=torch.float32, **SMALL)
    jaxc = jax_native.NativeVLMClient(paths[0])
    jaxc._model = jax_vlm.PageReader(dtype=jnp.float32, **SMALL)
    replies = []
    for model in ("gemma3:4b", paths[1], paths[0]):
        # the small model's position table has 24 slots: decode 24 tokens
        jaxc._ensure_loaded(model)
        page = jnp.asarray(jaxc._page_from_b64(b64))[None, ..., None]
        want = jax_vlm.decode_ids(np.asarray(jax_vlm.greedy_generate(jaxc._params, jaxc._model, page, max_len=24))[0])
        port._ensure_loaded(model)
        ids = vlm.greedy_generate(port._model, torch.from_numpy(port._page_from_b64(b64))[None, ..., None], max_len=24)
        assert port._loaded[0] == jaxc._loaded_path
        assert vlm.decode_ids(ids[0]) == want
        replies.append(want)
    assert replies[0] == replies[2] != replies[1]


@pytest.fixture
def float32_client(monkeypatch):
    """The cached CPU client, its model a float32 PageReader (``client._model``)."""
    monkeypatch.setattr(native_vlm, "_CLIENT_CACHE", {})
    monkeypatch.delenv("BB_OCR_VLM_CKPT", raising=False)
    monkeypatch.chdir(ROOT)
    client = native_vlm.get_native_client(device="cpu")
    client._model = vlm.PageReader(dtype=torch.float32)
    return client


def _small_shared_engine(monkeypatch):
    from_checkpoint = OCREngine.__dict__["from_checkpoint"]
    config = EngineConfig(canvases=(CanvasSpec(416, 320),), compute_dtype=torch.float32)
    monkeypatch.setattr(OCREngine, "from_checkpoint", classmethod(
        lambda cls, craft, crnn, *_, device, **__: from_checkpoint.__func__(cls, craft, crnn, config, device=device)))
    monkeypatch.setattr(extractor_module, "_ENGINE_CACHE", {})
    monkeypatch.delenv("BB_OCR_BATCHING", raising=False)


def test_process_book_tpu_route_matches_jax(float32_client, monkeypatch, tmp_path):
    """``books/1`` through ``process_book --llm-backend tpu`` (the no-engine
    extractor's ``tpu`` route): the metadata it saves equals the JAX
    extractor's (``route_416x320``), timings aside."""
    ref, _ = _reference("f32")
    want = ref["route_416x320"]["runs"]["1"]
    _small_shared_engine(monkeypatch)
    try:
        out = tmp_path / "out"
        assert process_book.main(["1", "--llm-backend", "tpu", "--no-warm-model", "--device", "cpu",
                                  "--output-dir", str(out)]) in (0, None)
        with open(out / "book_1_enhanced.json") as f:
            saved = json.load(f)
    finally:
        for engine in extractor_module._ENGINE_CACHE.values():
            engine.close()
    info = saved.pop("_processing_info")
    info.pop("engine_timings", None)
    assert {**saved, "_processing_info": info} == want
    assert float32_client._loaded[0] == native_vlm.DEFAULT_CKPT


class _StubEngine:
    def readtext(self, image):
        return []

    def timings(self):
        return {}


def test_vlm_bench_tpu_matches_jax(float32_client, monkeypatch):
    """``vlm_bench --backend tpu --limit 2``: the JAX run's fields, seconds
    aside (the OCR text does not reach the PageReader: a stub engine reads
    nothing)."""
    ref, _ = _reference("f32")
    monkeypatch.setattr(extractor_module, "_shared_engine", lambda *a: _StubEngine())
    got = vlm_bench.bench_backend("tpu", "", os.path.join(ROOT, "books"), 2, device="cpu")
    for row in got["details"]:
        row.pop("seconds")
    got.pop("mean_seconds")
    assert got == ref["bench"]


def test_vlm_eval_real_matches_jax(tree, tmp_path):
    """``eval_real`` with a float32 model on a cover and a camera photo's
    book: each row equals the JAX report's for that book."""
    ref, _ = _reference("f32")
    keys = ["covers/book2", "photos/3"]
    real = os.path.join(ROOT, "data", "real")
    with open(os.path.join(real, "ground_truth.json")) as f:
        books = json.load(f)["books"]
    (tmp_path / "covers").mkdir()
    shutil.copy(os.path.join(real, "covers", "book2.png"), tmp_path / "covers" / "book2.png")
    shutil.copytree(os.path.join(real, "photos", "3"), tmp_path / "photos" / "3")
    with open(tmp_path / "ground_truth.json", "w") as f:
        json.dump({"books": {k: books[k] for k in keys}}, f)
    model = vlm.PageReader(dtype=torch.float32).load_params(tree).eval()
    got = vlm_eval.eval_real(model, str(tmp_path))
    assert got["books"] == 2
    assert got["rows"] == [row for row in ref["eval_real"]["rows"] if row["book"] in keys]


def test_vlm_eval_synthetic_is_not_ported(monkeypatch):
    """``--synthetic`` is ported (``tests/test_torch_train_cli.py`` holds
    it to JAX's with a model): the CLI scores the held-out synthetic pages
    as JAX's does, here with a stub model that reads every page as its JSON
    minus the title."""
    from bbocr_tpu.cli import vlm_eval as jax_vlm_eval

    def reads(count):
        def generate(*args):
            pages = args[-1]
            count.append(pages.shape)
            return ['{"publisher": "x"}'] * len(pages)
        return generate

    seen = {"port": [], "jax": []}
    monkeypatch.setattr(vlm_eval, "_load", lambda *a, **k: None)
    monkeypatch.setattr(vlm_eval, "_generate", reads(seen["port"]))
    monkeypatch.setattr(jax_vlm_eval, "_generate", reads(seen["jax"]))
    got = vlm_eval.main(["--synthetic", "--device", "cpu", "--n", "3", "--batch", "2", "--page-h", "64",
                         "--page-w", "48"])["synthetic"]
    assert got == jax_vlm_eval.eval_synthetic(None, None, 3, 2, 64, 48)
    assert seen["port"] == seen["jax"] == [(2, 64, 48), (1, 64, 48)]
