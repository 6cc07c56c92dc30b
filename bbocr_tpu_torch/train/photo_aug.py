"""Photo-realistic augmentation for synthetic training data.

Round-1 negative result (ROADMAP.md): fine-tuning on the clean synthetic
distribution REGRESSED real-photo behavior — the models overfit to flat
backgrounds, one font family, and uniform lighting. This module injects the
factors that real book photos have (reference corpus
``pipeline_components/img_to_json/ollama_to_JSON/books/``, copied to
``data/real/``):

- style: letterspacing, shear (faux italic), anisotropic stretch, outline /
  embossed low-contrast text (gold-on-cloth covers), inverted polarity
- photometric: lighting gradients, shadow bands, glare spots, vignette,
  gaussian blur, sensor noise, JPEG artifacts
- structural: paper texture, show-through (faint mirrored text from the
  reverse side), cluttered photo background around a perspective-warped page

Everything is host-side numpy/PIL (data generation, not device compute) and
deterministic per seed, matching the contract of ``train/synth.py``.
"""

from __future__ import annotations

import io
import os
import random
from typing import Optional, Tuple

import sysconfig

import numpy as np


def require_pillow(*names: str) -> tuple:
    """The named ``PIL`` modules; ``ImportError`` naming Pillow where it is
    missing (the machine with the card has none). The generators draw text
    with Pillow's FreeType, so every function that draws asks for it here,
    at call time: importing this module needs no Pillow."""
    import importlib

    try:
        return tuple(importlib.import_module(f"PIL.{name}") for name in names)
    except ImportError as e:
        raise ImportError(
            "the synthetic data generators (train/synth.py, train/photo_aug.py) draw with Pillow, "
            "which is not installed"
        ) from e


def lighting_gradient(rng: random.Random, h: int, w: int, strength: float = 0.35) -> np.ndarray:
    """Multiplicative lighting field in [1-strength, 1+strength], (H, W)."""
    theta = rng.uniform(0, 2 * np.pi)
    gx, gy = np.cos(theta), np.sin(theta)
    ys = np.linspace(-0.5, 0.5, h)[:, None]
    xs = np.linspace(-0.5, 0.5, w)[None, :]
    ramp = gx * xs + gy * ys  # [-~0.7, ~0.7]
    amp = rng.uniform(0.3, 1.0) * strength
    return 1.0 + amp * ramp / 0.7


def vignette(rng: random.Random, h: int, w: int, strength: float = 0.25) -> np.ndarray:
    ys = np.linspace(-1, 1, h)[:, None]
    xs = np.linspace(-1, 1, w)[None, :]
    r2 = xs * xs + ys * ys
    return 1.0 - rng.uniform(0.2, 1.0) * strength * r2


def glare_spot(rng: random.Random, h: int, w: int) -> np.ndarray:
    """Additive glare blob (camera flash on glossy covers), (H, W) in [0, 90]."""
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    sigma = rng.uniform(0.15, 0.5) * max(h, w)
    ys = np.arange(h)[:, None] - cy
    xs = np.arange(w)[None, :] - cx
    g = np.exp(-(xs * xs + ys * ys) / (2 * sigma * sigma))
    return g * rng.uniform(25, 90)


def shadow_band(rng: random.Random, h: int, w: int) -> np.ndarray:
    """Multiplicative soft shadow band (hand/phone shadow), (H, W)."""
    vertical = rng.random() < 0.5
    n = w if vertical else h
    c = rng.uniform(0.2, 0.8) * n
    width = rng.uniform(0.08, 0.3) * n
    ax = np.arange(n)
    band = 1.0 - rng.uniform(0.15, 0.45) * np.exp(-((ax - c) ** 2) / (2 * width * width))
    return band[None, :] if vertical else band[:, None]


def paper_texture(rng: random.Random, h: int, w: int, amp: float = 6.0) -> np.ndarray:
    """Low-frequency cloth/paper texture, additive (H, W)."""
    Image, = require_pillow("Image")
    np_rng = np.random.default_rng(rng.randint(0, 1 << 31))
    small = np_rng.normal(0, 1.0, (max(2, h // 8), max(2, w // 8)))
    tex = np.asarray(
        Image.fromarray((small * 40 + 128).clip(0, 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR
        ),
        np.float32,
    )
    return (tex - tex.mean()) / 40.0 * amp * rng.uniform(0.3, 1.0)


def jpeg_artifacts(rng: random.Random, img: np.ndarray) -> np.ndarray:
    """Round-trip through JPEG at a random low quality."""
    Image, = require_pillow("Image")
    q = rng.randint(35, 80)
    pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", quality=q)
    buf.seek(0)
    return np.asarray(Image.open(buf), np.float32)


def gaussian_blur(rng: random.Random, img: np.ndarray, max_sigma: float = 1.6) -> np.ndarray:
    Image, ImageFilter = require_pillow("Image", "ImageFilter")
    sigma = rng.uniform(0.4, max_sigma)
    pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    return np.asarray(pil.filter(ImageFilter.GaussianBlur(sigma)), np.float32)


def motion_blur(rng: random.Random, img: np.ndarray) -> np.ndarray:
    """1-D box blur along a random axis (hand shake)."""
    k = rng.choice([3, 5])
    kernel = np.ones(k) / k
    axis = rng.randint(0, 1)
    return np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), axis, img)


def lowres_cycle(rng: random.Random, img: np.ndarray) -> np.ndarray:
    """Downscale-(jpeg)-upscale round trip: the upscaled-from-tiny-source
    regime.

    The real eval covers are web-resolution scans (data/real/covers: 293 to
    1000 px tall), so their rectified 32 px crops are UPSCALED from ~8-20 px
    of source text — soft, aliased, with JPEG ringing baked in at the SMALL
    size. The generator otherwise only ever downsamples sharp renders, and
    the recognizer never sees this blur family (round-3 diagnosis: EasyOCR's
    cover recall comes from exactly the small-print lines that upscale
    worst)."""
    Image, = require_pillow("Image")
    h, w = img.shape
    f = rng.uniform(0.30, 0.85)
    dh, dw = max(4, int(h * f)), max(8, int(w * f))
    pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    down = pil.resize((dw, dh), rng.choice((Image.BILINEAR, Image.NEAREST, Image.BOX)))
    if rng.random() < 0.5:
        buf = io.BytesIO()
        down.save(buf, format="JPEG", quality=rng.randint(45, 85))
        buf.seek(0)
        down = Image.open(buf)
    up = down.resize((w, h), rng.choice((Image.BILINEAR, Image.BICUBIC)))
    return np.asarray(up, np.float32)


def photometric_crop_aug(
    rng: random.Random, crop: np.ndarray, *, strength: float = 1.0
) -> np.ndarray:
    """Compose the photometric stack on a recognizer crop (H, W) [0,255]."""
    h, w = crop.shape
    out = crop.astype(np.float32)
    if rng.random() < 0.55 * strength:
        out = out * lighting_gradient(rng, h, w)
    if rng.random() < 0.25 * strength:
        out = out * shadow_band(rng, h, w)
    if rng.random() < 0.2 * strength:
        out = out + glare_spot(rng, h, w)
    if rng.random() < 0.5 * strength:
        out = out + paper_texture(rng, h, w)
    # global contrast squeeze: embossed/low-contrast text on covers
    if rng.random() < 0.3 * strength:
        mid = rng.uniform(90, 165)
        factor = rng.uniform(0.35, 0.8)
        out = mid + (out - mid) * factor
    if rng.random() < 0.35 * strength:
        out = gaussian_blur(rng, out)
    elif rng.random() < 0.15 * strength:
        out = motion_blur(rng, out)
    if rng.random() < 0.35 * strength:
        out = jpeg_artifacts(rng, np.clip(out, 0, 255))
    # LAST: capture-time degradations above happened at the source's native
    # (small) resolution; the engine's rectify-upscale to 32 px comes after.
    if rng.random() < 0.35 * strength:
        out = lowres_cycle(rng, out)
    return np.clip(out, 0, 255).astype(np.float32)


def perspective_coeffs(
    src: Tuple[Tuple[float, float], ...], dst: Tuple[Tuple[float, float], ...]
) -> Tuple[float, ...]:
    """PIL Image.transform(PERSPECTIVE) coefficients mapping dst -> src."""
    a = []
    b = []
    for (x, y), (u, v) in zip(dst, src):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.extend([u, v])
    coeffs = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return tuple(coeffs)


def warp_page_and_maps(
    rng: random.Random,
    page: np.ndarray,
    maps: np.ndarray,
    *,
    max_tilt: float = 0.08,
    bg_value: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply one random perspective to a page and its half-res heatmaps.

    The page stays the same size; corners move inward by up to
    ``max_tilt`` of the side length (camera not perfectly overhead).
    Heatmaps get the identical transform at half resolution so the
    detector's supervision stays aligned.
    """
    Image, = require_pillow("Image")
    h, w = page.shape
    src = ((0, 0), (w, 0), (w, h), (0, h))

    def jit(x, y):
        return (
            x + rng.uniform(-max_tilt, max_tilt) * w,
            y + rng.uniform(-max_tilt, max_tilt) * h,
        )

    dst = tuple(jit(x, y) for x, y in src)
    bg = int(np.median(page[0])) if bg_value is None else bg_value
    coeffs = perspective_coeffs(src, dst)
    page_w = Image.fromarray(np.clip(page, 0, 255).astype(np.uint8)).transform(
        (w, h), Image.PERSPECTIVE, coeffs, Image.BILINEAR, fillcolor=bg
    )
    hh, hw = maps.shape[0], maps.shape[1]
    half = tuple((x / 2, y / 2) for x, y in src)
    half_dst = tuple((x / 2, y / 2) for x, y in dst)
    coeffs_h = perspective_coeffs(half, half_dst)
    maps_w = np.zeros_like(maps)
    for c in range(maps.shape[-1]):
        ch = Image.fromarray((maps[..., c] * 255).astype(np.uint8)).transform(
            (hw, hh), Image.PERSPECTIVE, coeffs_h, Image.BILINEAR, fillcolor=0
        )
        maps_w[..., c] = np.asarray(ch, np.float32) / 255.0
    return np.asarray(page_w, np.float32), maps_w


def art_background(rng: random.Random, h: int, w: int) -> np.ndarray:
    """Book-cover artwork stand-in: multi-scale blurred noise + shapes.

    Real covers (data/real/covers: photographic jackets, painted fantasy
    art, worn cloth) put display text over high-frequency imagery. The
    detector must learn "text = glyph-shaped local contrast", not "dark
    marks on flat paper" — this supplies the busy ground, (H, W) [0,255].
    """
    Image, ImageDraw, ImageFilter = require_pillow("Image", "ImageDraw", "ImageFilter")

    # Compose at half resolution (the result is blurred art anyway) — this
    # runs inside the training data loop, where full-res PIL work measurably
    # starves the chip.
    hh, ww = max(16, h // 2), max(16, w // 2)
    np_rng = np.random.default_rng(rng.randint(0, 1 << 31))
    img = np.full((hh, ww), rng.uniform(40, 200), np.float32)
    for scale in (2, 4, 8):
        small = np_rng.uniform(0, 255, (max(2, hh // scale), max(2, ww // scale)))
        up = np.asarray(
            Image.fromarray(small.astype(np.uint8)).resize((ww, hh), Image.BILINEAR),
            np.float32,
        )
        img = img + (up - 128.0) * rng.uniform(0.15, 0.5)
    pil = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    d = ImageDraw.Draw(pil)
    for _ in range(rng.randint(2, 8)):
        x0, y0 = rng.randint(-ww // 4, ww), rng.randint(-hh // 4, hh)
        x1 = x0 + rng.randint(4, max(5, ww // 2))
        y1 = y0 + rng.randint(4, max(5, hh // 2))
        shade = rng.randint(0, 255)
        if rng.random() < 0.5:
            d.ellipse([x0, y0, x1, y1], fill=shade)
        else:
            d.rectangle([x0, y0, x1, y1], fill=shade)
    pil = pil.filter(ImageFilter.GaussianBlur(rng.uniform(0.4, 1.4)))
    return np.asarray(pil.resize((w, h), Image.BILINEAR), np.float32)


_REAL_TEXTURES: "list[np.ndarray] | None" = None


def _real_textures() -> "list[np.ndarray]":
    """Grayscale crops of REAL photographic imagery shipped inside unrelated
    site-packages (mujoco/dm_control/gymnasium textures: wood, marble, skin,
    grass, skyboxes; matplotlib's grace_hopper portrait).

    Round-3 diagnosis on data/real/covers/book6: the detector's region map
    fires on 30% of a painted fantasy cover — procedural art_background noise
    does not span organic texture statistics (skin, cloth, foliage), so the
    model learned "local contrast = text". These are the negatives that do.
    Eval imagery (data/real/) is deliberately NOT in the sweep."""
    Image, = require_pillow("Image")
    global _REAL_TEXTURES
    if _REAL_TEXTURES is not None:
        return _REAL_TEXTURES
    import glob as _glob

    site = sysconfig.get_paths()["purelib"]
    roots = (
        os.path.join(site, "mujoco", "**"),
        os.path.join(site, "dm_control", "**"),
        os.path.join(site, "gymnasium_robotics", "**"),
        os.path.join(site, "matplotlib", "mpl-data", "sample_data", "**"),
    )
    paths: list = []
    for r in roots:
        for ext in ("*.png", "*.jpg", "*.bmp"):
            paths.extend(_glob.glob(os.path.join(r, ext), recursive=True))
    # Organic imagery first (wood/marble/skin/grass/sky/foliage — the
    # statistics cover art actually has); the bulk of the sweep is rendered
    # sim test frames (checkerboard floors) which are useful but must not
    # dominate, so they are capped at 2 per directory.
    _ORGANIC = (
        "/textures", "outdoor_natural", "dog_assets", "sample_data",
        "/pitch", "soccer_ball", "skybox",
    )
    organic = [p for p in paths if any(t in p for t in _ORGANIC)]
    rest = [p for p in paths if p not in set(organic)]
    rng = random.Random(0)
    rng.shuffle(organic)
    rng.shuffle(rest)
    per_dir: dict = {}
    capped_rest: list = []
    for p in rest:
        d = os.path.dirname(p)
        if per_dir.get(d, 0) >= 2:
            continue
        per_dir[d] = per_dir.get(d, 0) + 1
        capped_rest.append(p)

    def _load(p, min_bytes):
        try:
            if os.path.getsize(p) < min_bytes:
                return None
            img = Image.open(p).convert("L")
            if min(img.size) < 96:
                return None
            if max(img.size) > 640:
                f = 640.0 / max(img.size)
                img = img.resize(
                    (max(1, int(img.size[0] * f)), max(1, int(img.size[1] * f))),
                    Image.BILINEAR,
                )
            arr = np.asarray(img, np.float32)
            if arr.std() < 12.0:  # flat fills teach nothing
                return None
            return arr
        except Exception:
            return None

    out: list = []
    for p in organic:  # organic textures are small files; no size floor
        if len(out) >= 40:
            break
        arr = _load(p, 2_000)
        if arr is not None:
            out.append(arr)
    for p in capped_rest:
        if len(out) >= 64:
            break
        arr = _load(p, 8_000)
        if arr is not None:
            out.append(arr)
    _REAL_TEXTURES = out
    return out


def real_texture_background(rng: random.Random, h: int, w: int) -> np.ndarray:
    """Random crop of a real texture/photo, tone-jittered, (H, W) [0,255]."""
    Image, = require_pillow("Image")
    pool = _real_textures()
    if not pool:
        return art_background(rng, h, w)
    src = pool[rng.randrange(len(pool))]
    sh, sw = src.shape
    # random zoom: crop between 40% and 100% of the source, then resize
    f = rng.uniform(0.4, 1.0)
    ch, cw = max(16, int(sh * f)), max(16, int(sw * f))
    y0 = rng.randint(0, max(0, sh - ch))
    x0 = rng.randint(0, max(0, sw - cw))
    crop = src[y0 : y0 + ch, x0 : x0 + cw]
    k = rng.randint(0, 3)
    if k:
        crop = np.rot90(crop, k)
    pil = Image.fromarray(np.clip(crop, 0, 255).astype(np.uint8))
    arr = np.asarray(pil.resize((w, h), Image.BILINEAR), np.float32)
    # tone jitter so one texture covers many cover palettes
    gain = rng.uniform(0.5, 1.3)
    bias = rng.uniform(-40, 60)
    arr = arr * gain + bias
    if rng.random() < 0.3:
        arr = 255.0 - arr
    return np.clip(arr, 0, 255)


def cover_background(rng: random.Random, h: int, w: int) -> np.ndarray:
    """Busy cover ground: real photographic texture or procedural art."""
    if rng.random() < 0.55:
        return real_texture_background(rng, h, w)
    return art_background(rng, h, w)


def clutter_background(rng: random.Random, h: int, w: int) -> np.ndarray:
    """Bookshelf-ish clutter: random gray rectangles + texture, (H, W)."""
    np_rng = np.random.default_rng(rng.randint(0, 1 << 31))
    bg = np.full((h, w), rng.randint(40, 120), np.float32)
    for _ in range(rng.randint(4, 12)):
        x0 = rng.randint(0, max(1, w - 8))
        y0 = rng.randint(0, max(1, h - 8))
        x1 = min(w, x0 + rng.randint(8, max(9, w // 2)))
        y1 = min(h, y0 + rng.randint(8, max(9, h // 2)))
        bg[y0:y1, x0:x1] = rng.randint(20, 200)
    bg += np_rng.normal(0, 8, bg.shape)
    return np.clip(bg, 0, 255)


def page_in_scene(
    rng: random.Random,
    page: np.ndarray,
    maps: np.ndarray,
    *,
    scene_scale: float = 1.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paste the page into a larger cluttered scene (book on a table/shelf).

    The page occupies most of the frame (like the reference photos); the
    heatmaps are zero-padded into the same scene geometry.
    """
    Image, = require_pillow("Image")
    h, w = page.shape
    sh, sw = int(h * scene_scale), int(w * scene_scale)
    # Make scene dims even so half-res heatmaps align exactly.
    sh += sh % 2
    sw += sw % 2
    scene = clutter_background(rng, sh, sw)
    y0 = rng.randint(0, sh - h)
    x0 = rng.randint(0, sw - w)
    scene[y0 : y0 + h, x0 : x0 + w] = page
    smaps = np.zeros((sh // 2, sw // 2, maps.shape[-1]), np.float32)
    # half-res offsets; page dims are even (generator contract)
    smaps[y0 // 2 : y0 // 2 + maps.shape[0], x0 // 2 : x0 // 2 + maps.shape[1]] = maps
    # resize back to the page's training shape
    scene_img = Image.fromarray(np.clip(scene, 0, 255).astype(np.uint8)).resize(
        (w, h), Image.BILINEAR
    )
    out_maps = np.zeros_like(maps)
    for c in range(maps.shape[-1]):
        ch = Image.fromarray((smaps[..., c] * 255).astype(np.uint8)).resize(
            (maps.shape[1], maps.shape[0]), Image.BILINEAR
        )
        out_maps[..., c] = np.asarray(ch, np.float32) / 255.0
    return np.asarray(scene_img, np.float32), out_maps
