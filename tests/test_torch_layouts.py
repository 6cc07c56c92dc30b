"""The published and lite model layouts against flax: ``CRAFTLite``,
``CRAFTPublished`` and ``CRNN(norm="batch")`` on variables made from a
numpy seed, the imports of published torch weights and their ``.pth``
loaders, the engine's choice of detector, and the lite detector's
checkpoint read end to end."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbocr_tpu.models import weights as jax_weights
from bbocr_tpu.models.craft import CRAFTLite as JaxCRAFTLite
from bbocr_tpu.models.craft import CRAFTPublished as JaxCRAFTPublished
from bbocr_tpu.models.crnn import CRNN as JaxCRNN
from bbocr_tpu.runtime.bucketing import CanvasSpec as JaxCanvasSpec
from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
from bbocr_tpu_torch.io import load_rgb
from bbocr_tpu_torch.models import (
    CRNN,
    CRAFTLite,
    CRAFTPublished,
    cast_for_compute,
    craft_state_dict,
    crnn_state_dict,
    fold_gray_stem,
    import_craft_from_torch,
    import_crnn_from_torch,
    load_craft_torch_checkpoint,
    load_crnn_torch_checkpoint,
)
from bbocr_tpu_torch.models.layers import BatchNorm
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.utils.checkpoint import load_params
from chip_smoke import seeded_variables

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRAFT_NPZ = os.path.join(ROOT, "checkpoints", "craft.npz")
CRNN_NPZ = os.path.join(ROOT, "checkpoints", "crnn.npz")
LITE_NPZ = os.path.join(ROOT, "checkpoints", "candidates", "craft_lite_raw.npz")
SIZES = [(64, 64), (96, 128)]
BF16 = torch.bfloat16


def _shapes(model, x):
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    return jax.tree_util.tree_map(lambda a: list(a.shape), dict(tree))


def _variables(model, x, seed):
    return seeded_variables(_shapes(model, x), seed)


def _jax_tree(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _port(module, variables, convert, dtype=torch.float32):
    module.load_state_dict(convert(variables), strict=True)
    return cast_for_compute(module, dtype).eval()


def _run(module, x_nhwc: np.ndarray, dtype=torch.float32) -> np.ndarray:
    with torch.no_grad():
        out = module(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(dtype))
    return out.float().permute(0, 2, 3, 1).numpy()


def _craft_case(name, size, seed=3):
    """(flax model class, port module class, variables, input NHWC)."""
    h, w = size
    rng = np.random.default_rng(seed)
    if name == "lite_gray":
        x = rng.uniform(0, 255, (2, h, w, 1)).astype(np.float32)
        variables = fold_gray_stem(_variables(JaxCRAFTLite(dtype=jnp.float32), jnp.zeros((1, h, w, 3)), seed))
        return lambda dt: JaxCRAFTLite(dtype=dt, gray_input=True), lambda: CRAFTLite(gray_input=True), variables, x
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    cls, port = {"lite": (JaxCRAFTLite, CRAFTLite), "published": (JaxCRAFTPublished, CRAFTPublished)}[name]
    variables = _variables(cls(dtype=jnp.float32), jnp.zeros((1, h, w, 3)), seed)
    return lambda dt: cls(dtype=dt), port, variables, x


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["lite", "lite_gray", "published"])
def test_craft_layouts_f32_match_flax(name, size):
    """Float32 score maps within 1e-4 of flax's (the lite stem's stride-2
    "SAME" padding (0, 1), the published pools and dilated conv as flax
    pads them, BatchNorm on running statistics)."""
    jax_model, port_cls, variables, x = _craft_case(name, size)
    ref = np.asarray(jax_model(jnp.float32).apply(_jax_tree(variables), jnp.asarray(x)))
    got = _run(_port(port_cls(), variables, craft_state_dict), x)
    assert got.shape == ref.shape == (2, size[0] // 2, size[1] // 2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# bfloat16 against flax run op by op: the float32 sums inside a conv run in
# another order, which flips a bfloat16 rounding on about 2e-5 of the stem's
# values; those one-ulp differences grow layer by layer (to a third of the
# values at the decoder, on these random variables). Measured at the two
# sizes: the lite sigmoid maps within 0.021, the published raw scores
# within 1.7 % of their largest magnitude. Stated limits: 0.03 and 3 %.
BF16_LIMIT = {"lite": 0.03, "lite_gray": 0.03, "published": 0.03}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["lite", "lite_gray", "published"])
def test_craft_layouts_bf16_match_flax(name, size):
    jax_model, port_cls, variables, x = _craft_case(name, size)
    ref = np.asarray(jax_model(jnp.bfloat16).apply(_jax_tree(variables), jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = _run(_port(port_cls(), variables, craft_state_dict, BF16), x, BF16)
    scale = 1.0 if name.startswith("lite") else float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= BF16_LIMIT[name] * scale


def _crnn_case(width, seed=5):
    x = np.random.default_rng(seed).uniform(-1, 1, (3, 32, width, 1)).astype(np.float32)
    variables = _variables(JaxCRNN(num_classes=97, dtype=jnp.float32, norm="batch"), jnp.zeros((1, 32, width, 1)), seed)
    return variables, x


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crnn_batch_norm_matches_flax(width, dtype):
    """``CRNN(norm="batch")`` logits against flax's: float32 within 1e-4;
    bfloat16 (flax op by op) within 0.125, the argmax equal."""
    variables, x = _crnn_case(width)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF16)
    ref = np.asarray(JaxCRNN(num_classes=97, dtype=jdt, norm="batch").apply(
        _jax_tree(variables), jnp.asarray(x, jdt)), np.float32)
    model = _port(CRNN(97, norm="batch"), variables, crnn_state_dict, tdt)
    assert all(isinstance(n, BatchNorm) for n in model.features.norms)
    assert model.features.norms[0].running_var.dtype == torch.float32
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)).numpy()
    assert got.shape == ref.shape == (3, width // 4 - 1, 97)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 if dtype == "float32" else 0.125)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _torch_craft_state_dict(seed=7):
    """A published CRAFT state dict (torch layout) of seeded values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(base, cin, cout, k):
        sd[f"{base}.weight"] = rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.05
        sd[f"{base}.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.1

    def bn(base, c):
        sd[f"{base}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{base}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{base}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{base}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{base}.num_batches_tracked"] = np.int64(10)

    chans = {"slice1": (3, 64, 64, 128, 128), "slice2": (128, 256, 256), "slice3": (256, 256, 512, 512),
             "slice4": (512, 512, 512, 512)}
    for name, (convs, bns) in jax_weights._CRAFT_SLICES.items():
        c = chans[name]
        for i, (ci, bi) in enumerate(zip(convs, bns)):
            conv(f"basenet.{name}.{ci}", c[i], c[i + 1], 3)
            bn(f"basenet.{name}.{bi}", c[i + 1])
    conv("basenet.slice5.1", 512, 1024, 3)
    conv("basenet.slice5.2", 1024, 1024, 1)
    for u, (cin, mid, out) in enumerate([(1536, 512, 256), (768, 256, 128), (384, 128, 64), (192, 64, 32)], 1):
        conv(f"upconv{u}.conv.0", cin, mid, 1)
        bn(f"upconv{u}.conv.1", mid)
        conv(f"upconv{u}.conv.3", mid, out, 3)
        bn(f"upconv{u}.conv.4", out)
    for ti, (cin, cout, k) in zip((0, 2, 4, 6, 8), [(32, 32, 3), (32, 32, 3), (32, 16, 3), (16, 16, 1), (16, 2, 1)]):
        conv(f"conv_cls.{ti}", cin, cout, k)
    return {f"module.{k}": torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _torch_crnn_state_dict(seed=8):
    """An EasyOCR generation-2 recognizer state dict of seeded values."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))  # noqa: E731
    sd = {}
    for idx, (cin, cout, k, bias) in {0: (1, 32, 3, True), 3: (32, 64, 3, True), 6: (64, 128, 3, True),
                                      8: (128, 128, 3, True), 11: (128, 256, 3, False), 14: (256, 256, 3, False),
                                      18: (256, 256, 2, True)}.items():
        sd[f"FeatureExtraction.ConvNet.{idx}.weight"] = r(cout, cin, k, k)
        if bias:
            sd[f"FeatureExtraction.ConvNet.{idx}.bias"] = r(cout)
    for idx in (12, 15):
        base = f"FeatureExtraction.ConvNet.{idx}"
        sd[f"{base}.weight"], sd[f"{base}.bias"], sd[f"{base}.running_mean"] = 1 + r(256), r(256), r(256)
        sd[f"{base}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, 256).astype(np.float32))
    for i in range(2):
        base = f"SequenceModeling.{i}"
        for sfx in ("", "_reverse"):
            sd[f"{base}.rnn.weight_ih_l0{sfx}"], sd[f"{base}.rnn.weight_hh_l0{sfx}"] = r(1024, 256), r(1024, 256)
            sd[f"{base}.rnn.bias_ih_l0{sfx}"], sd[f"{base}.rnn.bias_hh_l0{sfx}"] = r(1024), r(1024)
        sd[f"{base}.linear.weight"], sd[f"{base}.linear.bias"] = r(256, 512), r(256)
    sd["Prediction.weight"], sd["Prediction.bias"] = r(97, 256), r(97)
    return sd


def _assert_trees_equal(got, want):
    assert isinstance(got, dict) and sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["craft", "crnn"])
def test_torch_weight_imports_match_jax(kind, tmp_path):
    """``import_*_from_torch`` and the ``.pth`` loaders give JAX's variables
    on one seeded state dict; the imported variables load strictly into the
    port's ``CRAFTPublished`` / ``CRNN(norm="batch")``."""
    sd = _torch_craft_state_dict() if kind == "craft" else _torch_crnn_state_dict()
    port_import, jax_import = ((import_craft_from_torch, jax_weights.import_craft_from_torch) if kind == "craft"
                               else (import_crnn_from_torch, jax_weights.import_crnn_from_torch))
    port_load, jax_load = ((load_craft_torch_checkpoint, jax_weights.load_craft_torch_checkpoint) if kind == "craft"
                           else (load_crnn_torch_checkpoint, jax_weights.load_crnn_torch_checkpoint))
    variables = port_import(sd)
    _assert_trees_equal(variables, jax_import(sd))
    path = tmp_path / f"{kind}.pth"
    torch.save({"state_dict": sd} if kind == "craft" else sd, path)
    _assert_trees_equal(port_load(str(path)), jax_load(str(path)))
    if kind == "craft":
        CRAFTPublished().load_state_dict(craft_state_dict(variables), strict=True)
    else:
        CRNN(97, norm="batch").load_state_dict(crnn_state_dict(variables), strict=True)


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "rgb_stem"])
@pytest.mark.parametrize("layout", ["vgg", "lite", "published"])
def test_engine_picks_the_jax_detector(layout, fold):
    """The engine sniffs the parameter tree as the JAX engine does: the
    same detector class and the same folded-stem decision."""
    crnn = load_params(CRNN_NPZ)
    if layout == "vgg":
        craft = load_params(CRAFT_NPZ)
    elif layout == "lite":
        craft = load_params(LITE_NPZ)
    else:
        craft = _variables(JaxCRAFTPublished(dtype=jnp.float32), jnp.zeros((1, 64, 64, 3)), 3)
    ref = JaxOCREngine(craft, crnn, JaxEngineConfig(fold_gray_stem=fold, compute_dtype=jnp.float32))
    got = OCREngine(craft, crnn, EngineConfig(fold_gray_stem=fold, compute_dtype=torch.float32), device="cpu")
    assert type(got.craft).__name__ == type(ref.craft).__name__
    assert got._fold == ref._fold


def test_lite_checkpoint_reads_as_jax():
    """An engine from ``craft_lite_raw.npz`` reads a 400x320 gray cover at
    one 416x320 canvas in float32: JAX's texts, quads within 1 px."""
    import cv2

    gray = cv2.cvtColor(load_rgb(os.path.join(ROOT, "data", "real", "covers", "book1.png")), cv2.COLOR_RGB2GRAY)
    image = cv2.resize(gray, (320, 400), interpolation=cv2.INTER_AREA)
    knobs = dict(host_rectify=True, wire_bits=8, decoder="greedy", detect_pool=1, detect_coarse=0)
    ref = JaxOCREngine.from_checkpoint(LITE_NPZ, CRNN_NPZ, JaxEngineConfig(
        canvases=(JaxCanvasSpec(416, 320),), compute_dtype=jnp.float32, **knobs)).readtext(image)
    engine = OCREngine.from_checkpoint(LITE_NPZ, CRNN_NPZ, EngineConfig(
        canvases=(CanvasSpec(416, 320),), compute_dtype=torch.float32, **knobs), device="cpu")
    assert type(engine.craft).__name__ == "CRAFTLite" and engine._fold
    got = engine.readtext(image)
    assert len(ref) > 0 and [t for _, t, _ in got] == [t for _, t, _ in ref]
    for (q, _, c), (rq, _, rc) in zip(got, ref):
        assert np.abs(np.asarray(q) - np.asarray(rq)).max() <= 1.0
        assert abs(c - rc) <= 1e-3
