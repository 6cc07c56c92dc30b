"""Generate synthetic example books (cover/title/copyright photo sets).

Counterpart of ``bbocr_tpu/cli/make_examples.py``: renders photo sets with
known ground truth, powering the UI "Examples" dropdown, the CER harness
and batch-CLI smoke runs. It draws with Pillow and the DejaVu fonts, as the
JAX tool does, and writes the same bytes. Pillow is imported when a book is
drawn: where it is missing the call raises ``ImportError`` naming it, and
where a DejaVu font file is missing, ``FileNotFoundError`` naming the file
(Pillow's own ``OSError`` does not name it).

    python -m bbocr_tpu_torch.cli.make_examples --out books --count 5
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np

_FONTS_BOLD = "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf"
_FONTS_REG = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
_FONTS_SERIF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"

_TITLES = [
    ("The Silent River", "Maria Keller"),
    ("Garden of Hours", "Thomas Wren"),
    ("A History of Light", "Elena Park"),
    ("The Last Cartographer", "Samuel Reyes"),
    ("Winter Letters", "Anne Whitfield"),
    ("Stone and Salt", "David Okafor"),
    ("The Collected Essays", "J. M. Harlan"),
    ("Field Notes from the North", "Iris Chen"),
    ("The Glass Harbor", "Nora Vance"),
    ("Maps of a Vanished Coast", "Peter Aldous"),
    ("Midnight at the Observatory", "Lucia Romero"),
    ("The Clockmaker's Daughter", "Henry Bell"),
    ("Salt Roads", "Amara Diallo"),
    ("A Field Guide to Forgetting", "Oscar Lindqvist"),
    ("The Paper Orchard", "Yuki Tanaka"),
    ("Seven Bridges Down", "Marcus Doyle"),
    ("The Archivist's Song", "Helene Dubois"),
    ("Notes on a Burning Coast", "Ravi Menon"),
    ("The Tin Whistle Years", "Bridget O'Rourke"),
    ("Glacier Mathematics", "Sofia Bergman"),
    ("The Gravity of Small Things", "Abel Santos"),
    ("Letters to the Harbormaster", "Clara Voss"),
    ("An Atlas of Quiet Rooms", "Jonas Richter"),
    ("The Understory", "Margaret Ash"),
    ("Ninety Days of Rain", "Theodore Blake"),
]
_SUBTITLES = [
    None, None, None,
    "A Novel", "Stories", "A Memoir",
    "An Inquiry into Place and Memory",
    "Essays on the Modern Condition",
]
_PUBLISHERS = [
    "Harbor Press", "Meridian Books", "Bluestone Publishing", "Atlas House",
    "Crescent & Vale", "Northlake Editions", "The Foundry Press",
    "Gable and Sons", "Windrow Books",
]


def _isbn13(rng: random.Random) -> str:
    core = "978" + "".join(str(rng.randint(0, 9)) for _ in range(9))
    check = (10 - sum(int(c) * (1 if i % 2 == 0 else 3) for i, c in enumerate(core)) % 10) % 10
    return core + str(check)


def _pillow(*names: str) -> tuple:
    """The named ``PIL`` modules; ``ImportError`` naming Pillow where it is
    missing."""
    import importlib

    try:
        return tuple(importlib.import_module(f"PIL.{name}") for name in names)
    except ImportError as e:
        raise ImportError("cli/make_examples.py draws its books with Pillow, which is not installed") from e


def _fonts() -> None:
    """``FileNotFoundError`` naming the first DejaVu font file missing."""
    for path in (_FONTS_BOLD, _FONTS_REG, _FONTS_SERIF):
        if not os.path.exists(path):
            raise FileNotFoundError(f"cli/make_examples.py draws with the DejaVu fonts, and {path} is missing")


def _photo(img, rng: random.Random):
    """Make a rendered page look photographed: slight rotation + noise."""
    Image, = _pillow("Image")
    img = img.rotate(rng.uniform(-2.0, 2.0), expand=False, fillcolor=(210, 205, 196))
    arr = np.asarray(img).astype(np.int16)
    noise = np.random.default_rng(rng.randint(0, 1 << 31)).normal(0, 5, arr.shape)
    return Image.fromarray(np.clip(arr + noise, 0, 255).astype(np.uint8))


def _fit_text(d, text, font_path, start_size, max_w):
    """Largest font size <= start_size whose rendering fits max_w."""
    ImageFont, = _pillow("ImageFont")
    size = start_size
    while size > 12:
        font = ImageFont.truetype(font_path, size)
        if d.textbbox((0, 0), text, font=font)[2] <= max_w:
            return font
        size -= 2
    return ImageFont.truetype(font_path, 12)


def make_book(out_dir: str, idx: int, seed: int) -> dict:
    """Book ``idx + 1`` under ``out_dir``: three JPEG photos and its
    ``ground_truth.json``; returns the truth."""
    Image, ImageDraw, ImageFont = _pillow("Image", "ImageDraw", "ImageFont")
    _fonts()
    rng = random.Random(seed)
    title, author = _TITLES[idx % len(_TITLES)]
    subtitle = rng.choice(_SUBTITLES)
    publisher = rng.choice(_PUBLISHERS)
    year = str(rng.randint(1965, 2022))
    isbn = _isbn13(rng)
    size = (600, 800)

    # Layout variety: light or dark cover, centered or left-aligned,
    # varying margins/sizes, optional subtitle and publisher-on-cover.
    dark_cover = rng.random() < 0.35
    if dark_cover:
        bg = tuple(rng.randint(20, 80) for _ in range(3))
        ink = tuple(rng.randint(200, 250) for _ in range(3))
    else:
        bg = (rng.randint(205, 245), rng.randint(200, 240), rng.randint(190, 230))
        ink = tuple(rng.randint(15, 70) for _ in range(3))
    centered = rng.random() < 0.5
    serif_title = rng.random() < 0.5
    title_font_path = _FONTS_SERIF if serif_title else _FONTS_BOLD
    small = ImageFont.truetype(_FONTS_REG, rng.randint(20, 26))

    def place(d, text, font, y, fill):
        w = d.textbbox((0, 0), text, font=font)[2]
        x = (size[0] - w) // 2 if centered else rng.randint(40, 80)
        d.text((max(10, x), y), text, fill=fill, font=font)

    cover = Image.new("RGB", size, bg)
    d = ImageDraw.Draw(cover)
    title_font = _fit_text(d, title, title_font_path, rng.randint(42, 58), size[0] - 80)
    y = rng.randint(120, 240)
    place(d, title, title_font, y, ink)
    y += title_font.size + rng.randint(20, 60)
    if subtitle and rng.random() < 0.8:
        place(d, subtitle, ImageFont.truetype(_FONTS_REG, rng.randint(24, 30)), y, ink)
        y += 60
    place(d, author, ImageFont.truetype(_FONTS_SERIF, rng.randint(26, 34)),
          rng.randint(max(y + 40, 420), 560), ink)
    if rng.random() < 0.4:
        place(d, publisher.upper(), small, rng.randint(680, 730), ink)

    title_page = Image.new("RGB", size, (245, 242, 235))
    d = ImageDraw.Draw(title_page)
    tp_font = _fit_text(d, title, title_font_path, rng.randint(40, 52), size[0] - 100)
    y = rng.randint(150, 260)
    place(d, title, tp_font, y, (25, 25, 25))
    y += tp_font.size + rng.randint(30, 70)
    if subtitle:
        place(d, subtitle, small, y, (40, 40, 40))
        y += 55
    by = rng.choice([f"by {author}", author, author.upper()])
    place(d, by, ImageFont.truetype(_FONTS_SERIF, rng.randint(26, 32)), y + 20, (40, 40, 40))
    place(d, publisher, small, rng.randint(600, 680), (60, 60, 60))

    copyright_page = Image.new("RGB", size, (245, 242, 235))
    d = ImageDraw.Draw(copyright_page)
    lines = [
        f"Copyright {year} by {author}",
        "All rights reserved.",
        f"Published by {publisher}",
        rng.choice([f"First edition {year}", f"First published {year}",
                    f"Second printing, {year}"]),
        f"ISBN {isbn}",
        rng.choice(["Printed in the United States", "Printed in Great Britain"]),
    ]
    y = rng.randint(140, 220)
    gap = rng.randint(36, 64)
    for ln in lines:
        d.text((rng.randint(50, 70), y), ln, fill=(35, 35, 35), font=small)
        y += gap

    book_dir = os.path.join(out_dir, str(idx + 1))
    os.makedirs(book_dir, exist_ok=True)
    for i, page in enumerate((cover, title_page, copyright_page)):
        _photo(page, rng).save(os.path.join(book_dir, f"IMG_{i:04d}.jpg"), quality=92)

    truth = {
        "title": title,
        "subtitle": subtitle,
        "authors": [author],
        "publisher": publisher,
        "year": year,
        "isbn_13": isbn,
    }
    with open(os.path.join(book_dir, "ground_truth.json"), "w") as f:
        json.dump(truth, f, indent=2)
    return truth


def main(argv=None):
    p = argparse.ArgumentParser(description="Render synthetic example books")
    p.add_argument("--out", default="books")
    p.add_argument("--count", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for i in range(args.count):
        truth = make_book(args.out, i, args.seed + i)
        print(f"book {i + 1}: {truth['title']} ({truth['year']}) {truth['isbn_13']}")


if __name__ == "__main__":
    main()
