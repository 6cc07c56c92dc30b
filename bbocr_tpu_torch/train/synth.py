"""Synthetic training data: rendered text crops + detection heatmaps.

The reference consumes pretrained EasyOCR weights; this rebuild owns its
training loop, so it needs a data source. Book covers/imprint pages are
short latin text on low-texture backgrounds — synthetic rendering with real
fonts covers that distribution well (the PP-OCR line of work trains
production recognizers largely on synthetic data).

Host-side generation (PIL rasterization), arranged for async prefetch into
device batches by the trainer.
"""

from __future__ import annotations

import glob
import os
import random
import string
from dataclasses import dataclass
from typing import List, Optional, Tuple

import sys
import sysconfig

import numpy as np

from bbocr_tpu_torch.models.charset import EN_CHARSET, Charset
from bbocr_tpu_torch.models.crnn import INPUT_HEIGHT
from bbocr_tpu_torch.train.photo_aug import require_pillow

_FONT_DIRS = (
    "/usr/share/fonts/truetype/dejavu",
    "/usr/share/fonts/truetype",
    "/usr/share/fonts",
)

# TeX math faces whose Unicode cmaps still resolve Latin codepoints to
# symbol glyphs (verified by rendering): the probe can't catch these.
_FONT_BLACKLIST = frozenset({"cmex10.ttf", "cmsy10.ttf", "cmmi10.ttf"})


def _font_coverage(path: str) -> Optional[frozenset]:
    """Chars of the EN charset a face actually renders, or None if unusable.

    Display faces with PARTIAL coverage (MathJax Calligraphic/Fraktur ship
    caps-heavy cmaps) are still valuable for cover synthesis — real covers
    set titles in exactly such faces, all-caps — so instead of the all-or-
    nothing probe, each face carries its renderable-char set and the line
    generator only hands it text it can honestly render (labels must match
    pixels)."""
    if os.path.basename(path) in _FONT_BLACKLIST:
        return None
    try:
        ImageFont, = require_pillow("ImageFont")
        f = ImageFont.truetype(path, 24)
        a, b = f.getmask("A"), f.getmask("B")
        if a.getbbox() is None or b.getbbox() is None or bytes(a) == bytes(b):
            return None
        # .notdef reference: unmapped codepoints render the tofu box, which
        # HAS a bbox — a bbox-only probe calls tofu "covered" (MathJax AMS/
        # Calligraphic lowercase, math-italic digits). Compare mask bytes
        # against the tofu glyph instead.
        try:
            tofu = bytes(f.getmask("￾"))
        except Exception:
            tofu = None

        def renders(ch: str) -> bool:
            try:
                m = f.getmask(ch)
            except Exception:
                return False
            if m.getbbox() is None:
                return ch == " "
            return tofu is None or bytes(m) != tofu

        covered = {" "}
        covered.update(ch for ch in EN_CHARSET.chars if ch != " " and renders(ch))
        # minimum to be worth sampling: the full caps alphabet (display
        # faces without digits/lowercase stay usable for caps-only lines)
        if not set(string.ascii_uppercase) <= covered:
            return None
        return frozenset(covered)
    except Exception:
        return None


def _harvest_woff_fonts() -> List[str]:
    """Convert woff1 faces bundled with jupyter (MathJax Main/SansSerif/
    Typewriter/Fraktur/Calligraphic/Script) to loose .ttf files PIL can
    open. woff1 is zlib-only (fontTools handles it without brotli); the
    conversions are cached in the temporary directory (written to a
    temporary name and renamed) and keyed by family-subfamily."""
    import tempfile

    out_dir = os.path.join(tempfile.gettempdir(), "bbocr_torch_fonts")
    try:
        os.makedirs(out_dir, exist_ok=True)
        from fontTools.ttLib import TTFont
    except Exception:
        return []
    srcs: List[str] = []
    for root in (
        os.path.join(sys.prefix, "share", "jupyter", "lab", "static"),
        os.path.join(sysconfig.get_paths()["purelib"], "jupyterlab", "static"),
    ):
        srcs.extend(sorted(glob.glob(os.path.join(root, "*.woff"))))
    out: List[str] = []
    seen = set()
    for p in srcs:
        try:
            f = TTFont(p)
            fam = (f["name"].getDebugName(1) or "").replace(" ", "")
            sub = (f["name"].getDebugName(2) or "").replace(" ", "")
            if not fam or (fam, sub) in seen:
                continue
            seen.add((fam, sub))
            dst = os.path.join(out_dir, f"{fam}-{sub}.ttf")
            if not os.path.isfile(dst):
                f.flavor = None
                tmp = f"{dst}.{os.getpid()}.tmp"
                f.save(tmp)
                os.replace(tmp, dst)
            out.append(dst)
        except Exception:
            continue
    return out


def _extra_font_paths() -> List[str]:
    """Display/text faces shipped inside unrelated site-packages (pygame,
    gymnasium, mujoco) — found by a filesystem-wide sweep; each adds a
    glyph style the DejaVu/STIX/CM set lacks (Playfair = display serif,
    Minecraft = blocky display, Atkinson = humanist sans)."""
    roots: List[str] = []
    for mod in ("pygame", "gymnasium", "mujoco"):
        try:
            m = __import__(mod)
            roots.append(os.path.dirname(m.__file__))
        except Exception:
            pass
    rel = (
        ("pygame", "tests/fixtures/fonts/PlayfairDisplaySemibold.ttf"),
        ("pygame", "freesansbold.ttf"),
        ("gymnasium", "envs/toy_text/font/Minecraft.ttf"),
        ("mujoco", "experimental/studio/assets/AtkinsonHyperlegibleNext[wght].ttf"),
    )
    out = []
    for mod, sub in rel:
        for root in roots:
            if os.path.basename(root) == mod:
                p = os.path.join(root, sub)
                if os.path.isfile(p):
                    out.append(p)
    return out

_WORDS = (
    "the of and a to in is was he for it with as his on be at by had not are "
    "but from or have an they which one you were her all she there would "
    "their we him been has when who will more no if out so said what up its "
    "press books publishing edition library first second copyright printed "
    "published reserved rights international paperback hardcover isbn new "
    "york london chapter novel author history science art house random"
).split()

# Name-shaped text: author lines are a weak spot of word-soup sampling
# (real title pages say "by RANDALL PARRISH", "J. K. ROWLING").
_SURNAMES = (
    "Parrish Rowling Lansing Moorcock Orwell Finley Harte Turow Date Koock "
    "Ward Rubin Johnson Steffensen Brown Smith Miller Davis Wilson Clark "
    "Lewis Walker Young King Wright Hill Adams Baker Carter Mitchell"
).split()
# Western-European words for latin-ext recognizer heads (BASELINE config 4):
# sampled only when the charset covers the accents (DejaVu has coverage).
_ACCENT_WORDS = (
    "édition préface français théâtre poésie château être déjà après "
    "größe straße über müller für königs bücher zürich "
    "españa año señor música código "
    "città perché così più caffè "
    "histoire littérature bibliothèque ausgabe verlag übersetzt"
).split()

_PUBLISHER_PATTERNS = (
    "{s} Books", "{s} Press", "{s} Publishing", "{s} & Company",
    "{s}, Mead and Company", "{s} Company", "Little, Brown and Company",
    "Houghton Mifflin Company", "Random House", "Chronicle Books",
    "HarperCollins Publishers", "A. L. Burt Company", "Macmillan",
    "Addison-Wesley", "Grosset & Dunlap", "Coward-McCann, Inc.",
)


_ONSETS = (
    "b c d f g h j k l m n p r s t v w y z bl br ch cl cr dr fl fr gl gr "
    "kn ph pl pr qu sc sh sk sl sm sn sp st str th tr wh wr"
).split()
_VOWELS = "a e i o u a e i o ai ea ee ie oa oo ou y".split()
_CODAS = (
    " b ck ct d ft g ge k l ld ll lt m mb n nd ng nt p r rd rk rn rt s sh "
    "ss st t th x"
).split()


def _pseudo_word(rng: random.Random) -> str:
    """English-shaped nonsense (SHACKLETON / MELNIBONE are in nobody's
    lexicon): keeps the CTC head char-level honest instead of memorizing
    the small _WORDS list — real covers are mostly rare proper nouns."""
    n_syll = rng.choice((1, 2, 2, 3, 3, 4))
    parts = []
    for i in range(n_syll):
        parts.append(rng.choice(_ONSETS) if (i or rng.random() < 0.8) else "")
        parts.append(rng.choice(_VOWELS))
    if rng.random() < 0.7:
        parts.append(rng.choice(_CODAS).strip())
    w = "".join(parts)
    if rng.random() < 0.08:
        w += "'s"
    return w


def _sample_name(rng: random.Random) -> str:
    s = rng.choice(_SURNAMES)
    style = rng.random()
    if style < 0.35:
        initials = " ".join(
            f"{rng.choice(string.ascii_uppercase)}." for _ in range(rng.randint(1, 2))
        )
        return f"{initials} {s}"
    first = rng.choice(_SURNAMES)
    if style < 0.55:
        return f"{first} {rng.choice(string.ascii_uppercase)}. {s}"
    return f"{first} {s}"


_FONTS_CACHE: Optional[List[str]] = None
_FONT_COVERAGE: dict = {}  # path -> frozenset of renderable EN chars


def _find_fonts() -> List[str]:
    """Every usable text face on the image, deduped by file basename.

    The system ships only 6 DejaVu faces; matplotlib's bundled fonts add
    the STIX serif family, Computer Modern (serif/sans/typewriter/italic)
    and the DejaVu Display variants; round 3 adds faces swept from other
    site-packages (Playfair Display, Minecraft, Atkinson, FreeSans) and
    the MathJax woff set (Fraktur/Calligraphic/Script — the blackletter
    and script styles vintage covers actually use). Symbol/math faces are
    filtered by glyph probing; partial-coverage display faces are kept
    with their coverage recorded in ``_FONT_COVERAGE`` so the generator
    never labels glyphs a face can't draw.
    """
    global _FONTS_CACHE
    if _FONTS_CACHE is not None:
        return _FONTS_CACHE
    candidates: List[str] = []
    for d in _FONT_DIRS:
        found = sorted(glob.glob(os.path.join(d, "**", "*.ttf"), recursive=True))
        if found:
            candidates.extend(found)
            break
    try:
        import matplotlib

        mpl_dir = os.path.join(matplotlib.get_data_path(), "fonts", "ttf")
        candidates.extend(sorted(glob.glob(os.path.join(mpl_dir, "*.ttf"))))
    except Exception:
        pass
    candidates.extend(_extra_font_paths())
    candidates.extend(_harvest_woff_fonts())
    seen = set()
    fonts: List[str] = []
    for p in candidates:
        base = os.path.basename(p)
        if base in seen:
            continue
        seen.add(base)
        cov = _font_coverage(p)
        if cov is not None:
            fonts.append(p)
            _FONT_COVERAGE[p] = cov
    _FONTS_CACHE = fonts
    return fonts


@dataclass
class SynthConfig:
    charset: Charset = EN_CHARSET
    max_label_len: int = 24
    height: int = INPUT_HEIGHT
    invert_prob: float = 0.3
    noise_std: float = 6.0
    # Photo-realism strength (0 = round-1 clean distribution, 1 = full
    # lighting/glare/texture/JPEG stack from train.photo_aug). The round-1
    # negative result showed the clean distribution overfits; see
    # docs/ROADMAP.md and data/real/.
    photo_aug: float = 1.0
    # Typography variety: letterspacing / shear / stroke / low-contrast.
    style_aug: float = 1.0


class TextLineGenerator:
    """Random text line crops for recognizer training."""

    def __init__(self, config: SynthConfig = SynthConfig(), seed: int = 0):
        self.config = config
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.fonts = _find_fonts()
        self._font_cache = {}

    def _font(self, size: int, text: Optional[str] = None):
        """Random face; with ``text`` given, only faces that can render
        every char of it (partial-coverage display faces stay honest)."""
        ImageFont, = require_pillow("ImageFont")
        if not self.fonts:
            return ImageFont.load_default(size=size)
        pool = self.fonts
        if text is not None:
            need = set(text)
            pool = [p for p in pool if need <= _FONT_COVERAGE.get(p, need)] or self.fonts
        path = self.rng.choice(pool)
        key = (path, size)
        if key not in self._font_cache:
            self._font_cache[key] = ImageFont.truetype(path, size)
        return self._font_cache[key]

    def sample_text(self) -> str:
        r = self.rng.random()
        if r < 0.12 and len(self.config.charset.chars) > 100:
            # accented words for latin-ext heads
            n = self.rng.randint(1, 3)
            text = " ".join(self.rng.choice(_ACCENT_WORDS) for _ in range(n))
            return text.title() if self.rng.random() < 0.4 else text
        if r < 0.2:
            # numbers / ISBN-ish strings (digit-heavy CTC per BASELINE config 3)
            n = self.rng.randint(4, 17)
            chars = string.digits + "-"
            return "".join(self.rng.choice(chars) for _ in range(n))
        if r < 0.3:
            year = self.rng.randint(1850, 2029)
            return self.rng.choice([f"© {year}", f"Copyright {year}", str(year)])
        if r < 0.42:
            # author/name lines (real title pages: "by RANDALL PARRISH")
            name = _sample_name(self.rng)
            s = self.rng.random()
            if s < 0.3:
                return f"by {name}"
            if s < 0.55:
                return name.upper()
            return name
        if r < 0.52:
            pub = self.rng.choice(_PUBLISHER_PATTERNS).format(s=self.rng.choice(_SURNAMES))
            return pub.upper() if self.rng.random() < 0.4 else pub
        if r < 0.68:
            # proper-noun-shaped pseudo-words: the dominant regime of real
            # cover titles (ENDURANCE / MELNIBONE / SHACKLETON'S)
            n = self.rng.randint(1, 3)
            words = [_pseudo_word(self.rng) for _ in range(n)]
            s = self.rng.random()
            text = " ".join(words)
            if s < 0.5:
                return text.upper()
            if s < 0.85:
                return text.title()
            return text
        n_words = self.rng.randint(1, 4)
        words = [self.rng.choice(_WORDS) for _ in range(n_words)]
        style = self.rng.random()
        text = " ".join(words)
        if style < 0.3:
            return text.upper()
        if style < 0.6:
            return text.title()
        return text

    def render(self, text: Optional[str] = None, width: int = 256, _retry: int = 0) -> Tuple[np.ndarray, str]:
        """Render one (height, width) float32 crop in [0,255] + its label."""
        Image, ImageDraw, ImageFont = require_pillow("Image", "ImageDraw", "ImageFont")
        cfg = self.config
        if text is None:
            text = self.sample_text()
        # Cap label length so a CTC alignment exists in T = width/4 - 1
        # frames (worst case needs ~2 frames per char: char + separator).
        frames = width // 4 - 1
        max_chars = max(1, min(cfg.max_label_len, (frames - 1) // 2))
        # strip() after the cap: truncation can leave a trailing space the
        # crop has no ink evidence for (label chars must all be visible).
        text = "".join(c for c in text if c in cfg.charset.chars)[:max_chars].strip()
        if not text:
            text = self.rng.choice(_WORDS)[:max_chars]
        size = self.rng.randint(18, 30)
        font = self._font(size, text)
        tracking = 0
        if self.rng.random() < 0.3 * cfg.style_aug:
            # Letterspaced display caps: real covers track up to ~0.8em
            # ("S H A C K L E T O N ' S" — data/real/covers/book4). The
            # round-2 cap of size/3 never showed the recognizer the wide
            # end, and those lines were its worst misses.
            hi = max(3, int(size * (0.8 if self.rng.random() < 0.3 else 0.35)))
            tracking = self.rng.randint(2, hi)
        # Size the render canvas to the MEASURED text (clip-poison fix): the
        # ink crop is resized into the final (height, width) window anyway,
        # so a wide canvas costs nothing — but the old fixed width*2 canvas
        # clipped tail glyphs of tracked/narrow-target lines while the label
        # kept them: invisible-label-char poison, the same class as the
        # round-3 textbbox/woff poisons (w=64 audit: 'GLUDAI[C]', 'Brown[ &]').
        # Arched baseline: cover titles bow along a curve ("HARRY POTTER",
        # "MOORCOCK" — data/real/covers/book1/book6); the rectified quad
        # keeps the bow, so the recognizer sees chars riding a parabola.
        # Sampled HERE because the arc branch lays out per-char (its width
        # is the per-char sum, not the kerned full-text advance), which the
        # canvas sizing below must account for.
        arc = 0.0
        if self.rng.random() < 0.12 * cfg.style_aug and len(text) >= 4:
            arc = size * self.rng.uniform(0.12, 0.4) * self.rng.choice([-1.0, 1.0])
        _meas = ImageDraw.Draw(Image.new("L", (4, 4)))
        _full_w = _meas.textbbox((0, 0), text, font=font)[2]
        # per-char widths only when the per-char layout needs them (the
        # data path is GIL-bound on 1-core serving hosts; ~len(text) extra
        # textbbox calls per crop are measurable at training rates)
        char_widths = (
            [_meas.textbbox((0, 0), ch, font=font)[2] for ch in text]
            if tracking or arc
            else None
        )
        _needed = (
            max(_full_w, sum(char_widths) + tracking * max(0, len(text) - 1))
            if char_widths is not None
            else _full_w
        )
        canvas_w = max(width * 2, int(_needed) + 2 * (size // 7) + 24)
        bg = self.rng.randint(170, 255)
        fg = self.rng.randint(0, 90)
        if self.rng.random() < cfg.invert_prob:
            bg, fg = fg, bg
        # Low-contrast pairs: embossed gold-on-cloth covers and faded ink
        # have |fg-bg| far below the clean 80+ the round-1 generator used.
        if self.rng.random() < 0.25 * cfg.style_aug:
            mid = self.rng.randint(70, 185)
            delta = self.rng.randint(25, 60)
            bg, fg = mid + delta // 2, mid - delta // 2
            if self.rng.random() < 0.5:
                bg, fg = fg, bg
        busy_bg = self.rng.random() < 0.2 * cfg.style_aug
        if busy_bg:
            # cover-art ground: display text over busy imagery (the
            # rectified-crop view of data/real/covers)
            from bbocr_tpu_torch.train.photo_aug import cover_background

            art = cover_background(self.rng, cfg.height * 2, canvas_w)
            img = Image.fromarray(art.astype(np.uint8))
            m = float(art.mean())
            if m < 110:
                fg = self.rng.randint(180, 255)
            elif m < 180:
                fg = self.rng.choice([self.rng.randint(0, 50), self.rng.randint(230, 255)])
            else:
                fg = self.rng.randint(0, 60)
            bg = int(m)
        else:
            img = Image.new("L", (canvas_w, cfg.height * 2), bg)
        draw = ImageDraw.Draw(img)
        x0 = self.rng.randint(0, 6)
        y0 = self.rng.randint(0, max(1, cfg.height * 2 - size - 8))
        stroke = 0
        stroke_color = fg
        fill = fg
        if self.rng.random() < (0.5 if busy_bg else 0.08 * cfg.style_aug):
            # contrasting outline around the glyphs (movie-poster display)
            stroke = max(1, size // 12)
            stroke_color = 0 if fg > 127 else 255
        elif self.rng.random() < 0.06 * cfg.style_aug and size >= 22:
            # hollow/outline-only display caps (engraved or knockout titles:
            # stroke carries the letterform, interior matches the ground)
            stroke = max(1, size // 14)
            stroke_color = fg
            fill = bg
        elif self.rng.random() < 0.15 * cfg.style_aug:
            stroke = self.rng.randint(1, 2)  # display/outline faces
        # drop shadow: offset copy behind the glyphs (cover titles over art).
        # Visible only when it contrasts the ground; drawn first so the main
        # fill overprints it.
        shadow = None
        if abs(fg - bg) > 60 and self.rng.random() < (0.25 if busy_bg else 0.10) * cfg.style_aug:
            sdx = self.rng.randint(1, max(2, size // 7))
            sdy = self.rng.randint(1, max(2, size // 7))
            shadow = ((sdx, sdy), (fg + bg) // 2 + self.rng.randint(-20, 20))
        # (arc was sampled before canvas sizing; clamp y0 for the bow here)
        if arc > 0:  # upward bow: keep mid chars inside the canvas
            y0 = max(y0, int(arc) + 1)
        elif arc < 0:  # downward bow
            y0 = min(y0, max(0, img.height - size - int(-arc) - 2))
        pre_draw = np.asarray(img, np.int16).copy()
        if tracking or arc:
            x = x0
            jitter = max(1, size // 10) if self.rng.random() < 0.35 * cfg.style_aug else 0
            widths = (
                char_widths
                if char_widths is not None
                else [draw.textbbox((0, 0), ch, font=font)[2] for ch in text]
            )
            total = sum(widths) + tracking * max(0, len(text) - 1)
            for i, ch in enumerate(text):
                dy = self.rng.randint(-jitter, jitter) if jitter else 0
                if arc and total > 0:
                    t = (x - x0 + widths[i] / 2) / total
                    dy += int(round(-arc * 4.0 * t * (1.0 - t)))
                if shadow is not None:
                    draw.text((x + shadow[0][0], y0 + dy + shadow[0][1]), ch,
                              fill=int(np.clip(shadow[1], 0, 255)), font=font)
                draw.text((x, y0 + dy), ch, fill=fill, font=font, stroke_width=stroke, stroke_fill=stroke_color)
                x += widths[i] + tracking
        else:
            if shadow is not None:
                draw.text((x0 + shadow[0][0], y0 + shadow[0][1]), text,
                          fill=int(np.clip(shadow[1], 0, 255)), font=font)
            draw.text((x0, y0), text, fill=fill, font=font, stroke_width=stroke, stroke_fill=stroke_color)
        if self.rng.random() < 0.2 * cfg.style_aug:
            # faux italic: horizontal shear around the text baseline
            shear = self.rng.uniform(-0.25, 0.25)
            img = img.transform(
                img.size, Image.AFFINE, (1, shear, -shear * y0, 0, 1, 0),
                Image.BILINEAR, fillcolor=bg,
            )
        # INK bbox from pixels, not font metrics (round-3 diagnosis): some
        # converted display faces report coverage yet render nothing (empty
        # crop with a label), and faces with inflated vertical metrics made
        # textbbox ~5x the glyph height — the resize-to-text_h step then
        # shrank the glyphs to ~4px scrawl. Both poison CTC training with
        # unlearnable targets. diff vs the pre-draw background is exact for
        # every branch (stroke, tracking, busy art, shear moves bg too but
        # fillcolor=bg keeps uniform grounds clean).
        post_draw = np.asarray(img, np.int16)
        ink = np.abs(post_draw - pre_draw) > 8
        ys, xs = np.nonzero(ink)
        if xs.size < 4:
            # Broken face rendered no ink: redraw with a face that proved
            # itself (DejaVu ships with the image and always renders).
            if _retry < 2:
                return self.render(text=text, width=width, _retry=_retry + 1)
            font = ImageFont.load_default(size=size)
            draw.text((x0, y0), text, fill=fg, font=font)
            post_draw = np.asarray(img, np.int16)
            ink = np.abs(post_draw - pre_draw) > 8
            ys, xs = np.nonzero(ink)
            if xs.size == 0:  # pathological fg==bg style; just emit something
                ys = np.asarray([0, img.height - 1]); xs = np.asarray([0, img.width - 1])
        left, top = int(xs.min()), int(ys.min())
        right, bottom = int(xs.max()) + 1, int(ys.max()) + 1
        self._last_render = {"canvas_w": int(img.width), "ink_right": right}
        if right >= img.width and _retry < 2:
            # Ink touches the canvas edge: a glyph clipped despite the
            # measured canvas (exotic metrics). The label would then cite
            # invisible chars — re-render rather than emit poison.
            return self.render(text=text, width=width, _retry=_retry + 1)
        if self.rng.random() < 0.12 * cfg.style_aug:
            # gradient ink: metallic/foil display type fades across the line
            # (covers set titles in gold foil whose luminance ramps 2x within
            # a word); modulate only the ink's deviation from the ground so
            # the background stays untouched.
            arr = np.asarray(img, np.float32)
            hh, ww = arr.shape
            lo = self.rng.uniform(0.35, 0.8)
            if self.rng.random() < 0.6:
                ramp = np.linspace(lo, 1.0, ww, dtype=np.float32)[None, :]
            else:
                ramp = np.linspace(lo, 1.0, hh, dtype=np.float32)[:, None]
            if self.rng.random() < 0.5:
                ramp = ramp[::-1] if ramp.shape[0] > 1 else ramp[:, ::-1]
            bgf = float(bg)
            arr = np.where(ink, bgf + (arr - bgf) * ramp, arr)
            img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
        pad = self.rng.randint(1, 4)
        crop = img.crop((max(0, left - pad), max(0, top - pad), right + pad, bottom + pad))
        # Loose-crop augmentation: detected quads include margins around the
        # glyphs (CRAFT dilation growth), so the text occupies only part of
        # the rectified 32px crop; train with the same looseness.
        text_h = int(cfg.height * self.rng.uniform(0.45, 1.0))
        # Condensed/extended faces: real display type is often set narrow
        # (movie-poster condensed) or wide; the six DejaVu faces are all
        # normal-width, so synthesize the regime by aspect jitter.
        aspect_j = self.rng.uniform(0.65, 1.3) if self.rng.random() < 0.35 * cfg.style_aug else 1.0
        w = max(8, min(int(crop.width * text_h * aspect_j / max(crop.height, 1)), width))
        crop = crop.resize((w, text_h), Image.BILINEAR)
        out = np.full((cfg.height, width), bg, np.float32)
        y_off = self.rng.randint(0, cfg.height - text_h) if cfg.height > text_h else 0
        # Cover furniture: display lines are flanked by rules/ornaments
        # INSIDE the detected quad ("- SHACKLETON'S ----", data/real/covers/
        # book4): the affinity map links the rule to the word, so the
        # rectified crop contains dashes/dots the recognizer must read
        # THROUGH, not decode as text. When furniture is on, the text also
        # moves off the left edge (the quad starts at the left rule).
        furniture = self.rng.random() < 0.20 * cfg.style_aug and width - w >= 32
        if furniture:
            x_off = self.rng.randint(12, min(width - w, 12 + (width - w) // 2))
        else:
            x_off = self.rng.randint(0, max(0, min(6, width - w)))
        out[y_off : y_off + text_h, x_off : x_off + w] = np.asarray(crop, np.float32)
        content_end = x_off + w
        if furniture:
            content_end = max(content_end, self._draw_furniture(
                out, x_off, w, y_off, text_h, float(fg), float(bg), width))
        if self.rng.random() < 0.15 * cfg.style_aug:
            # Neighbor bleed: real quads clip ascenders/descenders of the
            # adjacent line (a 2-6px sliver at the crop's top or bottom) and
            # cut glyphs of neighboring words at the left/right boundary.
            # The model must learn edge slivers are not characters.
            content_end = self._draw_neighbor_bleed(
                out, x_off, y_off, text_h, float(fg), float(bg),
                content_end, width)
        edge = min(content_end, width - 1)
        out[:, edge:] = out[:, edge - 1 : edge]  # edge-replicate like the engine
        # photo-like jitter: small rotation (book photos are hand-held) and
        # mild blur, matching what rectified crops of real captures look like
        if self.rng.random() < 0.5:
            angle = self.rng.uniform(-2.5, 2.5)
            pil = Image.fromarray(out.astype(np.uint8))
            out = np.asarray(
                pil.rotate(angle, resample=Image.BILINEAR, fillcolor=int(bg)),
                np.float32,
            )
        if cfg.photo_aug > 0:
            from bbocr_tpu_torch.train.photo_aug import photometric_crop_aug

            # Legibility gate (round-3 diagnosis): the low-contrast style
            # branch composed with the photometric stack's contrast squeeze
            # + texture + noise produced crops whose text is INVISIBLE to a
            # human (~10% of the corpus at full strength). Training on
            # unreadable targets both caps val CER (~0.09 plateau) and
            # teaches the model to hallucinate text on flat noise — the
            # real-photo texture misreads. Gate: text/background separation
            # after the stack must clear the noise floor, else re-run the
            # stack milder on the clean render.
            pre = out
            # Text mask from the clean render, thresholded RELATIVE to the
            # style's own fg/bg distance (the low-contrast branch renders at
            # |fg-bg| as low as 25; a fixed threshold misses exactly the
            # crops most at risk).
            thr = max(8.0, 0.4 * abs(float(fg) - float(bg)))
            mask = np.abs(pre - float(bg)) > thr
            n_text = int(mask.sum())
            sig_pre = (
                abs(float(pre[mask].mean()) - float(pre[~mask].mean()))
                if 0 < n_text < mask.size
                else 0.0
            )
            out = photometric_crop_aug(self.rng, out, strength=cfg.photo_aug)
            sig = -1.0
            if sig_pre > 0:
                sig = abs(float(out[mask].mean()) - float(out[~mask].mean()))
                # Illegible = separation fell under the noise floor OR lost
                # most of what the clean render had.
                if sig < max(1.8 * cfg.noise_std, 0.35 * sig_pre):
                    out = photometric_crop_aug(
                        self.rng, pre, strength=0.35 * cfg.photo_aug
                    )
            self._last_gate = {
                "fg": fg, "bg": bg, "thr": thr, "n_text": n_text,
                "sig_pre": round(sig_pre, 1), "sig_post": round(sig, 1),
                "busy": busy_bg,
            }
        elif self.rng.random() < 0.3:
            k = np.array([0.25, 0.5, 0.25])
            out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, out)
        noise = self.np_rng.normal(0.0, cfg.noise_std, out.shape)
        out = np.clip(out + noise, 0, 255)
        return out.astype(np.float32), text

    def _draw_furniture(self, out: np.ndarray, x_off: int, w: int, y_off: int,
                        text_h: int, fg: float, bg: float, width: int) -> int:
        """Flanking rules/ornaments in the text's own ink; returns the
        rightmost drawn column (content end for edge replication)."""
        rng = self.rng
        ink = bg + (fg - bg) * rng.uniform(0.6, 1.0)  # rules often set lighter
        yc = y_off + int(text_h * rng.uniform(0.35, 0.65))
        th = rng.randint(1, 2)
        gap = rng.randint(4, 14)
        style = rng.random()  # 0-0.7 solid rule, 0.7-0.9 dotted, else ornament
        content_end = x_off + w

        def _rule(xa: int, xb: int) -> None:
            ya, yb = max(0, yc - th // 2), min(out.shape[0], yc + (th + 1) // 2)
            if style < 0.7:
                out[ya:yb, xa:xb] = ink
            elif style < 0.9:
                step = rng.randint(3, 6)
                dot = rng.randint(1, 2)
                for x in range(xa, xb, step):
                    out[ya:yb, x : min(x + dot, xb)] = ink
            else:
                s = rng.randint(2, min(6, max(3, text_h // 3)))
                cx = (xa + xb) // 2
                out[max(0, yc - s // 2) : yc + (s + 1) // 2, cx : cx + s] = ink

        lx1 = x_off - gap
        if lx1 > 6:
            _rule(rng.randint(0, 4), lx1)
        rx0 = x_off + w + gap
        rx1 = min(width - rng.randint(0, 4), rx0 + rng.randint(10, width))
        if rx1 - rx0 > 6:
            _rule(rx0, rx1)
            content_end = max(content_end, rx1)
        return content_end

    def _draw_neighbor_bleed(self, out: np.ndarray, x_off: int, y_off: int,
                             text_h: int, fg: float, bg: float,
                             content_end: int, width: int) -> int:
        """Slivers of adjacent lines/words clipped by the quad boundary.
        Only partial glyphs (<=40% visible) so the CTC label stays honest:
        the model learns to ignore cut shapes at crop edges. Returns the
        (possibly extended) content end for edge replication."""
        Image, ImageDraw = require_pillow("Image", "ImageDraw")
        rng = self.rng
        h = out.shape[0]
        ink = bg + (fg - bg) * rng.uniform(0.7, 1.0)
        frag = rng.choice(string.ascii_uppercase + string.ascii_lowercase + string.digits)
        frag = frag + rng.choice(string.ascii_lowercase) * rng.randint(0, 2)
        size = rng.randint(max(10, text_h // 2), max(12, text_h))
        font = self._font(size, frag)
        fw = size * (len(frag) + 1)
        tile = Image.new("L", (fw, size * 2), int(bg))
        ImageDraw.Draw(tile).text((2, size // 3), frag, fill=int(ink), font=font)
        ta = np.asarray(tile, np.float32)
        ys, xs = np.nonzero(np.abs(ta - bg) > 8)
        if xs.size < 4:
            return content_end
        glyph = ta[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
        gh, gw = glyph.shape

        def _blend(dst: np.ndarray, src: np.ndarray) -> None:
            if ink < bg:
                np.minimum(dst, src, out=dst)
            else:
                np.maximum(dst, src, out=dst)

        mode = rng.random()
        if mode < 0.75:
            # top/bottom sliver of the neighbouring line
            s = rng.randint(2, max(3, min(6, gh - 1)))
            top_margin, bot_margin = y_off, h - (y_off + text_h)
            if max(top_margin, bot_margin) < s:
                return content_end  # text fills the crop; sliver would overwrite
            x = rng.randint(0, max(1, min(content_end, width) - gw - 1)) if gw < width else 0
            band = glyph[:s] if rng.random() < 0.5 else glyph[-s:]
            row = 0 if top_margin > bot_margin else h - s
            dst = out[row : row + s, x : x + min(gw, width - x)]
            _blend(dst, band[:, : dst.shape[1]])
        else:
            # left/right cut glyph of a neighbouring word
            vis = max(2, int(gw * rng.uniform(0.15, 0.4)))
            y = max(0, min(h - gh, y_off + rng.randint(-3, 3)))
            if rng.random() < 0.5 and x_off >= vis + 3:
                dst = out[y : y + gh, 0:vis]
                _blend(dst, glyph[:, gw - vis :][: dst.shape[0], : dst.shape[1]])
            elif content_end + 2 + vis < width:
                x = content_end + rng.randint(2, 8)
                x = min(width - vis, x)
                dst = out[y : y + gh, x : x + vis]
                _blend(dst, glyph[:, :vis][: dst.shape[0], : dst.shape[1]])
                content_end = x + vis
        return content_end

    def batch(self, batch_size: int, width: int = 256):
        """(B, H, W) crops, (B, L) labels, (B,) label_lens, (B,) frame_lens."""
        cfg = self.config
        crops = np.zeros((batch_size, cfg.height, width), np.float32)
        labels = np.zeros((batch_size, cfg.max_label_len), np.int32)
        label_lens = np.zeros(batch_size, np.int32)
        for i in range(batch_size):
            crop, text = self.render(width=width)
            crops[i] = crop
            enc = cfg.charset.encode(text)[: cfg.max_label_len]
            labels[i, : len(enc)] = enc
            label_lens[i] = len(enc)
        frame_lens = np.full(batch_size, width // 4 - 1, np.int32)
        return crops, labels, label_lens, frame_lens


class PageGenerator:
    """Synthetic pages + CRAFT-style region/affinity heatmaps for the detector."""

    def __init__(self, config: SynthConfig = SynthConfig(), seed: int = 0):
        self.config = config
        self.rng = random.Random(seed + 7)
        self.lines = TextLineGenerator(config, seed + 13)

    def render(self, height: int = 256, width: int = 192):
        """Returns (page (H, W) float32, heatmaps (H/2, W/2, 2) float32).

        Layouts mirror the real corpus (data/real/): running-text pages,
        centered title pages (large display lines), dense copyright blocks,
        and book covers (dark/mid background, large light display text,
        decorative rules as hard negatives). With ``photo_aug`` the page
        then goes through perspective, scene clutter, and the lighting/
        glare/texture/JPEG stack — the factors whose absence caused the
        round-1 fine-tune regression.
        """
        Image, ImageDraw, ImageFont = require_pillow("Image", "ImageDraw", "ImageFont")
        cfg = self.config
        # Scale font sizes with the canvas so training pages cover the text
        # heights seen at serving time (covers letterboxed to 704x512 carry
        # 30-90px display text; the round-1 fixed 9-34px range did not).
        s = height / 256.0

        def ri(lo, hi):  # randint tolerant of ranges collapsed by small s
            lo = max(1, int(lo))
            return self.rng.randint(lo, max(lo, int(hi)))

        mode = self.rng.random()
        cover = mode >= 0.72
        art_cover = False
        if cover:
            # covers: any tone, incl. dark cloth/jacket; text picked for
            # contrast below. 60% get procedural artwork backgrounds
            # (photographic jackets / painted art — data/real/covers).
            art_cover = self.rng.random() < 0.6
            bg = self.rng.choice(
                [self.rng.randint(15, 90), self.rng.randint(90, 170), self.rng.randint(170, 250)]
            )
        else:
            bg = self.rng.randint(160, 250)
        if art_cover:
            from bbocr_tpu_torch.train.photo_aug import cover_background

            page = cover_background(self.rng, height, width)
            bg = int(page.mean())
        else:
            page = np.full((height, width), bg, np.float32)
        region = np.zeros((height // 2, width // 2), np.float32)
        affinity = np.zeros((height // 2, width // 2), np.float32)

        if mode < 0.3:  # title page: few large centered lines, big gaps
            n_lines = self.rng.randint(2, 4)
            sizes = [ri(22 * s, 40 * s)] + [
                ri(12 * s, 22 * s) for _ in range(n_lines - 1)
            ]
            gap_range = (max(1, int(10 * s)), max(2, int(36 * s)))
            centered = True
        elif mode < 0.52:  # copyright block: dense small left-aligned lines
            n_lines = self.rng.randint(4, 7)
            sizes = [ri(9, 14 * s)] * n_lines
            gap_range = (2, max(3, int(8 * s)))
            centered = False
        elif not cover:  # generic running lines (round-1 distribution)
            n_lines = self.rng.randint(1, 5)
            sizes = [ri(10 * s, 34 * s) for _ in range(n_lines)]
            gap_range = (max(1, int(4 * s)), max(2, int(20 * s)))
            centered = False
        else:  # cover: huge display title + author/publisher lines
            n_lines = self.rng.randint(2, 4)
            if self.rng.random() < 0.3:
                # Giant-title regime: real covers set the title at 1/3 of
                # the cover height ("1984", the HARRY POTTER logo) — 300+px
                # on the serving canvas. The old 64px cap meant the region
                # map had never seen such strokes and the detector
                # fragmented them (covers/book1/book2 diagnoses).
                first = ri(64 * s, int(height * 0.45))
            else:
                first = ri(30 * s, 64 * s)
            sizes = [first] + [ri(14 * s, 30 * s) for _ in range(n_lines - 1)]
            gap_range = (max(1, int(14 * s)), max(2, int(48 * s)))
            centered = True

        # Decorative non-text elements (horizontal rules, frames, solid
        # blobs): present on real covers/title pages, labeled as background
        # so the detector learns to suppress them.
        if self.rng.random() < (0.5 if cover else 0.25):
            ink = self.rng.randint(0, 255)
            for _ in range(self.rng.randint(1, 3)):
                kind = self.rng.random()
                if kind < 0.5:  # horizontal rule
                    ry = self.rng.randint(0, height - 4)
                    rx0 = self.rng.randint(0, width // 3)
                    rx1 = self.rng.randint(2 * width // 3, width)
                    page[ry : ry + self.rng.randint(1, 4), rx0:rx1] = ink
                elif kind < 0.8:  # frame/border
                    t = self.rng.randint(1, 3)
                    m = ri(2, 10 * s)
                    page[m : m + t, m : width - m] = ink
                    page[height - m - t : height - m, m : width - m] = ink
                    page[m : height - m, m : m + t] = ink
                    page[m : height - m, width - m - t : width - m] = ink
                else:  # solid blob (illustration stand-in)
                    bw = ri(20 * s, width // 2)
                    bh = ri(20 * s, height // 3)
                    bx = self.rng.randint(0, max(1, width - bw))
                    by = self.rng.randint(0, max(1, height - bh))
                    page[by : by + bh, bx : bx + bw] = ink

        y = ri(4, 24 * s + 4)
        # Pure hard-negative pages: art/texture with NO text teaches the
        # detector to stay silent on cover illustrations and cloth grain
        # (the main false-positive source on the real corpus).
        if self.rng.random() < (0.15 if art_cover else 0.04):
            sizes = []
        pil_page = Image.fromarray(np.clip(page, 0, 255).astype(np.uint8))
        draw = ImageDraw.Draw(pil_page)
        page_dirty = False
        giant_cut = int(56 * s)
        # Drawn line texts, exposed for pipeline-consistent crop harvesting
        # (cli/make_pipeline_crops.py): the page's GT "phrases".
        self.last_texts: List[str] = []
        for size in sizes:
            if size >= giant_cut:
                # giant titles are short: a year or one display word
                r = self.rng.random()
                if r < 0.3:
                    text = str(self.rng.randint(1850, 2029))
                else:
                    text = _pseudo_word(self.rng)[:7].upper() if r < 0.75 else self.rng.choice(_WORDS)[:7].upper()
            else:
                text = self.lines.sample_text()
            font = self.lines._font(size, text)
            # display-type styling on covers: letterspaced caps + outline
            tracking = 0
            if cover and self.rng.random() < 0.4:
                text = text.upper()
                # wide end teaches the detector's affinity to LINK widely
                # spaced display letters (real covers fragment per-char
                # without it — diag: book5 detected single 'A'/'i' boxes)
                hi = max(3, int(size * (0.7 if self.rng.random() < 0.3 else 0.35)))
                tracking = self.rng.randint(2, hi)
            bbox0 = draw.textbbox((0, 0), text, font=font)
            # shrink-to-fit: overflowing lines would clip glyphs at the page
            # edge while the even-split gaussians squeeze inside it — a
            # glyph/label mismatch that corrupts the region map.
            while size > 9 and bbox0[2] + 2 + tracking * max(0, len(text) - 1) > width:
                size = max(9, int(size * 0.85))
                try:
                    font = ImageFont.truetype(font.path, size)
                except (AttributeError, OSError):
                    break
                bbox0 = draw.textbbox((0, 0), text, font=font)
            tw = min(bbox0[2] + 2 + tracking * max(0, len(text) - 1), width)
            th = min(bbox0[3] + 2, height)
            if y + th >= height:
                break
            if centered:
                x = min(max(0, (width - tw) // 2 + self.rng.randint(-4, 4)), width - tw)
            else:
                x = self.rng.randint(0, width - tw) if width > tw else 0
            # contrast-aware fill vs the LOCAL ground (art covers vary)
            if art_cover:
                local = np.asarray(pil_page, np.float32)[y : y + th, x : x + tw]
                local_mean = float(local.mean()) if local.size else float(bg)
            else:
                local_mean = float(bg)
            if cover or self.rng.random() < 0.1:
                if local_mean < 110:
                    fill = self.rng.randint(170, 255)
                elif local_mean < 180:
                    fill = self.rng.choice([self.rng.randint(0, 60), self.rng.randint(230, 255)])
                else:
                    fill = self.rng.randint(0, 80)
            else:
                fill = self.rng.randint(0, 80)
            stroke_w, stroke_fill = 0, None
            if art_cover and self.rng.random() < 0.5:
                # contrasting outline (the "1984" / movie-poster look) keeps
                # display text legible over any art
                stroke_w = max(1, size // 14)
                stroke_fill = 0 if fill > 127 else 255
            char_xs = []  # exact per-char left edges for supervision
            if tracking:
                cx_pen = x
                for ch in text:
                    draw.text((cx_pen, y), ch, fill=fill, font=font,
                              stroke_width=stroke_w, stroke_fill=stroke_fill)
                    char_xs.append(cx_pen)
                    cw_ch = draw.textbbox((0, 0), ch, font=font)[2]
                    cx_pen += cw_ch + tracking
            else:
                draw.text((x, y), text, fill=fill, font=font,
                          stroke_width=stroke_w, stroke_fill=stroke_fill)
            page_dirty = True
            self.last_texts.append(text)
            # char-level gaussians: exact centers when letterspaced,
            # even-split approximation otherwise
            n_chars = max(len(text), 1)
            cw = tw / n_chars
            for ci in range(n_chars):
                if text[ci] == " ":
                    continue
                cx = (char_xs[ci] + cw / 2.0) / 2.0 if tracking else (x + (ci + 0.5) * cw) / 2.0
                cy = (y + th / 2.0) / 2.0
                _add_gaussian(region, cx, cy, max(cw, th) / 4.0)
                if ci + 1 < n_chars and text[ci + 1] != " ":
                    ax = (char_xs[ci + 1] / 2.0) if tracking else (x + (ci + 1.0) * cw) / 2.0
                    _add_gaussian(affinity, ax, cy, max(cw, th) / 5.0)
            y += th + self.rng.randint(*gap_range)
        if page_dirty or art_cover:
            page = np.asarray(pil_page, np.float32)

        maps = np.clip(np.stack([region, affinity], axis=-1), 0.0, 1.0).astype(np.float32)

        if cfg.photo_aug > 0:
            from bbocr_tpu_torch.train import photo_aug as pa

            if self.rng.random() < 0.5 * cfg.photo_aug:
                page, maps = pa.warp_page_and_maps(self.rng, page, maps, bg_value=bg)
            if self.rng.random() < 0.35 * cfg.photo_aug:
                page, maps = pa.page_in_scene(self.rng, page, maps)
            page = pa.photometric_crop_aug(self.rng, page, strength=cfg.photo_aug)

        noise = np.random.default_rng(self.rng.randint(0, 1 << 31)).normal(
            0, self.config.noise_std, page.shape
        )
        page = np.clip(page + noise, 0, 255).astype(np.float32)
        return page, maps

    def batch(self, batch_size: int, height: int = 256, width: int = 192):
        pages = np.zeros((batch_size, height, width), np.float32)
        maps = np.zeros((batch_size, height // 2, width // 2, 2), np.float32)
        for i in range(batch_size):
            pages[i], maps[i] = self.render(height, width)
        return pages, maps

    def render_labeled(self, height: int = 256, width: int = 192):
        """Title-page-like page + the metadata JSON it depicts.

        Training pairs for the PageReader VLM head (BASELINE config 5):
        the fields are KNOWN because this generator placed them, so the
        target is the exact compact JSON the extractor schema expects.
        Returns (page (H, W) float32, json_text str).
        """
        Image, ImageDraw = require_pillow("Image", "ImageDraw")
        import json as _json

        cfg = self.config
        rng = self.rng
        title = " ".join(rng.choice(_WORDS) for _ in range(rng.randint(1, 3))).title()
        author = _sample_name(rng)
        publisher = rng.choice(_PUBLISHER_PATTERNS).format(s=rng.choice(_SURNAMES))
        year = str(rng.randint(1850, 2029))
        meta = {"title": title, "authors": [author], "publisher": publisher, "year": year}
        lines = [
            (title, rng.randint(20, 34), True),
            (rng.choice([f"by {author}", author.upper(), author]), rng.randint(12, 18), True),
            (publisher, rng.randint(10, 15), True),
            (rng.choice([year, f"Copyright {year}", f"© {year}"]), rng.randint(9, 13), False),
        ]
        if rng.random() < 0.5:
            body = "978" + "".join(str(rng.randint(0, 9)) for _ in range(9))
            check = (10 - sum((1 if i % 2 == 0 else 3) * int(d) for i, d in enumerate(body)) % 10) % 10
            isbn13 = body + str(check)
            meta["isbn_13"] = isbn13
            lines.append((f"ISBN {isbn13}", rng.randint(9, 12), False))
        bg = rng.randint(185, 250)
        page = Image.new("L", (width, height), bg)
        d = ImageDraw.Draw(page)
        y = rng.randint(10, 30)
        drawn: List[str] = []
        for text, size, centered in lines:
            font = self.lines._font(size, text)
            bb = d.textbbox((0, 0), text, font=font)
            tw, th = min(bb[2] + 2, width), bb[3] + 2
            x = max(0, (width - tw) // 2) if centered else rng.randint(4, max(5, width - tw))
            if y + th >= height:
                break
            d.text((x, y), text, fill=rng.randint(0, 70), font=font)
            drawn.append(text)
            y += th + rng.randint(8, 26)
        arr = np.asarray(page, np.float32)
        if cfg.photo_aug > 0:
            from bbocr_tpu_torch.train.photo_aug import photometric_crop_aug

            arr = photometric_crop_aug(self.rng, arr, strength=0.5 * cfg.photo_aug)
        noise = np.random.default_rng(rng.randint(0, 1 << 31)).normal(
            0, cfg.noise_std, arr.shape
        )
        arr = np.clip(arr + noise, 0, 255).astype(np.float32)
        rendered = " ".join(drawn)
        return arr, _json.dumps(meta, separators=(",", ":")), rendered

    def batch_labeled(
        self,
        batch_size: int,
        height: int = 256,
        width: int = 192,
        target: str = "json",
        with_ctc: bool = False,
    ):
        """(B, H, W) pages, (B, L) token ids, (B,) lengths for VLM training.

        ``target``: "json" = the metadata JSON (the end task); "text" = the
        literal rendered page text — the READING-curriculum phase. A
        from-scratch encoder-decoder at this scale does not discover visual
        grounding from the JSON task alone (measured: loss plateaus at the
        unconditional entropy, field accuracy ~3%); transcription pulls the
        cross-attention onto the glyphs first, then the JSON phase
        fine-tunes from it (--init-from).

        ``with_ctc``: additionally return (char_labels (B, Lc), char_lens)
        — the rendered text charset-encoded for the encoder's CTC auxiliary
        loss (trainer.vlm_ctc_aux_loss), regardless of ``target``.
        """
        from bbocr_tpu_torch.models.charset import EN_CHARSET
        from bbocr_tpu_torch.models.vlm import MAX_JSON_LEN, encode_json

        pages = np.zeros((batch_size, height, width), np.float32)
        tokens = np.zeros((batch_size, MAX_JSON_LEN), np.int32)
        lens = np.zeros(batch_size, np.int32)
        texts: List[str] = []
        for i in range(batch_size):
            pages[i], js, rendered = self.render_labeled(height, width)
            tokens[i], lens[i] = encode_json(js if target == "json" else rendered)
            texts.append(rendered)
        if not with_ctc:
            return pages, tokens, lens
        encoded = [EN_CHARSET.encode(t)[: MAX_JSON_LEN] for t in texts]
        char_labels = np.zeros((batch_size, MAX_JSON_LEN), np.int32)
        char_lens = np.zeros(batch_size, np.int32)
        for i, ids in enumerate(encoded):
            char_labels[i, : len(ids)] = ids
            char_lens[i] = len(ids)
        return pages, tokens, lens, char_labels, char_lens


def _add_gaussian(canvas: np.ndarray, cx: float, cy: float, sigma: float) -> None:
    h, w = canvas.shape
    r = max(int(3 * sigma), 2)
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r) + 1)
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r) + 1)
    if x0 >= x1 or y0 >= y1:
        return
    ys = np.arange(y0, y1)[:, None] - cy
    xs = np.arange(x0, x1)[None, :] - cx
    g = np.exp(-(xs**2 + ys**2) / (2 * sigma * sigma))
    canvas[y0:y1, x0:x1] = np.maximum(canvas[y0:y1, x0:x1], g)
