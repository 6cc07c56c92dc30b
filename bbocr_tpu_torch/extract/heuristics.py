"""Regex/heuristic OCR-text -> metadata structurer (no LLM).

Role of the reference's heuristics extractor
(``pipeline_components/img_to_json/ocr_testing/hueristics/book_extractor.py``),
rebuilt with stricter logic: checksum-validated ISBN-10/13 (the reference
only pattern-matches), imprint-aware year picking, publisher suffix +
known-list matching, price/currency, and first-lines title/author fallback.

Copied from ``bbocr_tpu/extract/heuristics.py`` (pure Python). It is the
structurer of the ``llm_backend="heuristic"`` path: no model round trip.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from bbocr_tpu_torch.extract.schema import empty_metadata

_ISBN13_RE = re.compile(r"(?<!\d)(97[89][- ]?(?:\d[- ]?){9}\d)(?!\d)")
_ISBN10_RE = re.compile(r"(?<![\dX])((?:\d[- ]?){9}[\dXx])(?![\dX])")
_YEAR_IMPRINT_RE = re.compile(
    r"(?:©|\(c\)|copyright|published|printed|edition)[^\d]{0,20}((?:1[5-9]|20)\d{2})",
    re.IGNORECASE,
)
_YEAR_RE = re.compile(r"\b((?:1[5-9]|20)\d{2})\b")
_PRICE_RE = re.compile(r"(?:\$|USD|£|GBP|€|EUR)\s*(\d+(?:[.,]\d{1,2})?)|(\d+(?:[.,]\d{1,2})?)\s*(?:\$|USD|£|GBP|€|EUR)")
_CURRENCY_RE = re.compile(r"(\$|USD|£|GBP|€|EUR)")
_PUBLISHER_SUFFIX_RE = re.compile(
    r"\b([A-Z][A-Za-z&.' -]{2,40}?"
    r"(?i:Press|Publishing|Publishers|Publications|Books|House|Editions|Company))\b"
)
# "by <Name Name>": same line only, and not the imprint's "published by"
_AUTHOR_BY_RE = re.compile(
    r"(?<![Pp]ublished )(?<![Pp]rinted )\bby[ \t]+"
    r"([A-Z][a-z]+(?:[ \t]+[A-Z]\.?)?(?:[ \t]+[A-Z][a-z]+)+)"
)
_EDITION_RE = re.compile(
    r"\b((?:first|second|third|fourth|fifth|1st|2nd|3rd|\d+th|revised|limited|special)\s+(?:edition|printing|impression))\b",
    re.IGNORECASE,
)

KNOWN_PUBLISHERS = (
    "Penguin", "Random House", "HarperCollins", "Simon & Schuster", "Hachette",
    "Macmillan", "Scholastic", "Wiley", "Oxford University Press",
    "Cambridge University Press", "MIT Press", "Pearson", "McGraw-Hill",
    "Bloomsbury", "Vintage", "Knopf", "Bantam", "Ballantine", "Del Rey",
    "Tor", "Orbit", "DAW", "Baen", "Ace", "Pocket Books", "Doubleday",
    "Houghton Mifflin", "Farrar", "Norton", "Viking", "Harper & Row",
)

_CURRENCY_MAP = {"$": "USD", "USD": "USD", "£": "GBP", "GBP": "GBP", "€": "EUR", "EUR": "EUR"}


def _clean_isbn(raw: str) -> str:
    return re.sub(r"[- ]", "", raw).upper()


def isbn10_valid(isbn: str) -> bool:
    if len(isbn) != 10 or not re.fullmatch(r"\d{9}[\dX]", isbn):
        return False
    total = sum((10 - i) * (10 if c == "X" else int(c)) for i, c in enumerate(isbn))
    return total % 11 == 0


def isbn13_valid(isbn: str) -> bool:
    if len(isbn) != 13 or not isbn.isdigit():
        return False
    total = sum(int(c) * (1 if i % 2 == 0 else 3) for i, c in enumerate(isbn))
    return total % 10 == 0


def isbn10_to_13(isbn10: str) -> Optional[str]:
    if not isbn10_valid(isbn10):
        return None
    core = "978" + isbn10[:9]
    check = (10 - sum(int(c) * (1 if i % 2 == 0 else 3) for i, c in enumerate(core)) % 10) % 10
    return core + str(check)


def find_isbns(text: str) -> Dict[str, Optional[str]]:
    isbn_13 = None
    isbn_10 = None
    for m in _ISBN13_RE.finditer(text):
        cand = _clean_isbn(m.group(1))
        if isbn13_valid(cand):
            isbn_13 = cand
            break
    if isbn_13 is None:
        # OCR fuses the "ISBN" label into the digit run ('I'->1 'S'->5
        # 'B'->8 'N'->0: "ISBN 9787..." reads as "15809787...") which
        # defeats the boundary-anchored regex; slide a checksum-validated
        # 13-digit window over every long digit run instead.
        for run in re.findall(r"\d[\d\- ]{11,}", text):
            digits = re.sub(r"\D", "", run)
            for s in range(len(digits) - 12):
                cand = digits[s : s + 13]
                if cand.startswith(("978", "979")) and isbn13_valid(cand):
                    isbn_13 = cand
                    break
            if isbn_13:
                break
    for m in _ISBN10_RE.finditer(text):
        cand = _clean_isbn(m.group(1))
        if cand.startswith(("978", "979")):
            continue  # fragment of an ISBN-13
        if isbn10_valid(cand):
            isbn_10 = cand
            break
    if isbn_13 is None and isbn_10 is not None:
        isbn_13 = isbn10_to_13(isbn_10)
    return {"isbn_10": isbn_10, "isbn_13": isbn_13}


def find_year(text: str) -> Optional[str]:
    m = _YEAR_IMPRINT_RE.search(text)
    if m:
        return m.group(1)
    years = _YEAR_RE.findall(text)
    if years:
        # latest plausible year ~ the printing of this copy
        return max(years)
    return None


_PUBLISHED_BY_RE = re.compile(
    r"published by[ \t]+([A-Z][A-Za-z&.' -]{2,40}?)[ \t]*(?:$|[\n,.])",
    re.IGNORECASE | re.MULTILINE,
)


def _clean_publisher(name: str) -> str:
    """Trim junk LEADING tokens off a suffix-anchored publisher capture:
    'by Houghton Mifflin & Company', 'ss kz HarperCollins Publishers',
    'First Chronicle Books', 'An Are Books' — connective words, edition
    ordinals, and short OCR-noise fragments precede the real name on real
    pages. Dotted tokens stop the trim ('A. L. BURT COMPANY' keeps its
    initials)."""
    drop = {"by", "published", "first", "a", "an", "the"}
    toks = name.split()
    while len(toks) > 1 and "." not in toks[0] and (
        toks[0].lower() in drop or len(toks[0]) <= 2
    ):
        toks.pop(0)
    return " ".join(toks)


def find_publisher(text: str) -> Optional[str]:
    m = _PUBLISHED_BY_RE.search(text)
    tail = m.group(1).strip() if m else None
    if tail:
        suffix = _PUBLISHER_SUFFIX_RE.search(tail)
        if suffix:
            return _clean_publisher(suffix.group(1).strip())
    # A suffix-shaped imprint anywhere in the text ("A. L. BURT COMPANY")
    # beats a suffix-less "published by <tail>" capture: on real pages the
    # tail is often OCR junk mid-sentence ("published by arensenerts with
    # a") while the cased imprint line survives recognition.
    m = _PUBLISHER_SUFFIX_RE.search(text)
    if m:
        return _clean_publisher(m.group(1).strip())
    for pub in KNOWN_PUBLISHERS:
        if re.search(r"\b" + re.escape(pub) + r"\b", text, re.IGNORECASE):
            return pub
    return _clean_publisher(tail) if tail else None


def find_price(text: str) -> Dict[str, Any]:
    m = _PRICE_RE.search(text)
    if not m:
        return {"currency": None, "amount": None}
    amount = next(g for g in m.groups() if g)
    cur = _CURRENCY_RE.search(m.group(0))
    return {
        "currency": _CURRENCY_MAP.get(cur.group(1)) if cur else None,
        "amount": float(amount.replace(",", ".")),
    }


def heuristic_extract(text: str) -> Dict[str, Any]:
    """OCR text -> metadata dict in the standard schema (all heuristic)."""
    meta = empty_metadata()
    if not text or not text.strip():
        return meta

    meta.update(find_isbns(text))
    meta["year"] = find_year(text)
    meta["publisher"] = find_publisher(text)
    meta["price"] = find_price(text)

    m = _EDITION_RE.search(text)
    if m:
        meta["edition"] = m.group(1)

    m = _AUTHOR_BY_RE.search(text)
    if m:
        meta["authors"] = [m.group(1)]

    lines = [ln.strip() for ln in text.split("\n") if ln.strip()]
    if not lines:
        lines = [s.strip() for s in re.split(r"[.!?]|\s{2,}", text) if s.strip()]
    if lines:
        # first non-numeric-ish line as the title candidate
        for ln in lines:
            if len(ln) >= 3 and not ln.replace(" ", "").isdigit():
                meta["title"] = ln
                break
    if not meta["authors"] and len(lines) > 1 and meta["title"] in lines:
        idx = lines.index(meta["title"])
        for cand in lines[idx + 1 : idx + 4]:
            if _plausible_author(cand):
                meta["authors"] = [cand]
                break
    return meta


_NON_AUTHOR_RE = re.compile(
    r"\b(press|publish(?:ed|ers?|ing)?|books|house|editions|copyright"
    r"|rights|reserved|printed|edition|impression|isbn|chapter|volume"
    r"|first|all|company|co|inc|ltd"
    # role/reference words: "AUTHOR OF ...", "by the same author",
    # "translated/edited/illustrated by" lines are about the author,
    # never the name itself (photos/17 picked 'the same author')
    r"|authou?rs?|same|translated|edited|illustrated)\b",
    re.IGNORECASE,
)


def _clean_author(line: str) -> str:
    """Drop ISOLATED bare 1-letter noise tokens (stray detections around a
    byline: 'By N MARTHA a AMi FINLEY' -> 'MARTHA AMi FINLEY'). Dotted
    initials ('J.') are always kept, and so are RUNS of 2+ consecutive
    single letters ('J K Rowling') — those are undotted initials."""
    toks = line.split()
    bare = [len(t) == 1 and "." not in t for t in toks]
    keep = [
        t
        for i, t in enumerate(toks)
        if not bare[i]
        or (i > 0 and bare[i - 1])
        or (i + 1 < len(toks) and bare[i + 1])
    ]
    return " ".join(keep) if keep else line.strip()


def _plausible_author(line: str) -> bool:
    """A name-like line: 1-5 words, no digits, no imprint vocabulary."""
    line = line.strip()
    if not (0 < len(line) <= 60) or any(ch.isdigit() for ch in line):
        return False
    if _NON_AUTHOR_RE.search(line):
        return False
    words = line.split()
    return 1 <= len(words) <= 5


_NON_TITLE_RE = re.compile(
    r"\b(company|press|publishers?|publishing|published|inc|ltd|copyright"
    r"|reserved|printed|printing|isbn|edition|impression|authorized|york"
    r"|london|boston|chicago|authou?r|volume|novel|stories|essays|memoir"
    r"|tales|poems)\b",
    re.IGNORECASE,
)

# Imprint vocabulary for the FUZZY line filter: OCR noise defeats the exact
# word list above ("Prinling", "Ortther", "CopyriGhT 1899" read from real
# pages), but an imprint word at edit distance <= 1-2 is still an imprint
# line, and imprint lines on title/copyright pages are often tall enough to
# win the title prominence score.
_IMPRINT_VOCAB = (
    "published", "publisher", "publishers", "publishing", "printing",
    "printed", "copyright", "edition", "impression", "reserved",
    "simultaneously", "arrangement",
)

# Month names are imprint evidence only next to a digit ("October 1899"):
# bare months appear in real titles ("October Sky"), which the general
# vocabulary above must never reject.
_MONTH_VOCAB = ("october", "september", "november", "december", "january",
                "february", "august")


def _edit_within(a: str, b: str, k: int) -> bool:
    """len-bounded Levenshtein <= k (tiny strings; O(len^2) fine)."""
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        if min(cur) > k:
            return False
        prev = cur
    return prev[lb] <= k


def _looks_like_imprint(text: str) -> bool:
    has_digit = any(c.isdigit() for c in text)
    for w in re.findall(r"[A-Za-z]+", text.lower()):
        if len(w) < 6:
            continue
        # edit<=2 on 6-7 letter words hits real title words ("Pronter" ~
        # "printed") — allow 2 edits only on 8+ letter words
        k = 1 if len(w) < 8 else 2
        for v in _IMPRINT_VOCAB:
            if _edit_within(w, v, k):
                return True
        if has_digit:
            for v in _MONTH_VOCAB:
                if _edit_within(w, v, k):
                    return True
    return re.search(r"&\s*co\b", text, re.IGNORECASE) is not None


def _title_plausible(text: str) -> bool:
    t = text.strip()
    if len(t) < 4 or _NON_TITLE_RE.search(t) or _looks_like_imprint(t):
        return False
    alpha = sum(ch.isalpha() for ch in t)
    if alpha / max(len(t), 1) < 0.55:
        return False
    # at least one real-word-ish token (3+ letters incl. a vowel)
    return any(
        len(w) >= 3 and any(v in w.lower() for v in "aeiouy")
        for w in re.findall(r"[A-Za-z]+", t)
    )


def heuristic_extract_lines(lines: List[Tuple]) -> Dict[str, Any]:
    """Structure metadata from OCR *lines with prominence*.

    ``lines``: (text, mean_confidence, relative_height[, image_index]) per
    visual line, where relative_height is the line's text height normalized
    by the tallest line of the same image (title text is the big text) and
    image_index follows the reference's page order (0 = cover, then title
    page, then copyright page).

    Pattern-driven fields (ISBN/year/publisher/price/edition) scan the FULL
    text — regexes are robust to junk, and confidence-gating them loses
    correct mid-confidence reads (measured: year exact 0.267 -> 0.133 on
    the real corpus under a blunt conf >= 0.3 gate). Title/author selection
    is HEIGHT-dominated with only a weak confidence term: display titles
    read at conf 0.1-0.3 (decorative faces), so a confidence gate reliably
    picks the author line instead — measured across the synthetic corpus
    dumps, h^4 * (0.3 + c) with a 0.3x weight on pages after the first two
    picks the true title where conf-weighted scoring picked subtitles.
    """
    norm = [
        (l[0], l[1], l[2], l[3] if len(l) > 3 else 0)
        for l in lines
    ]
    full = "\n".join(t for t, _, _, _ in norm)
    meta = heuristic_extract(full)

    cands = [
        (t.strip(), c, h, img, i)
        for i, (t, c, h, img) in enumerate(norm)
        if c >= 0.05 and len(t.strip()) >= 3
    ]

    def tscore(t, c, h, img):
        # mild multi-word boost: real titles are usually phrases, and a
        # lone high-confidence name (the author) otherwise outranks the
        # decorative multi-word title line at near-equal height (measured
        # round 5: book4 picked 'ALFRED' over 'H ENDURANCE ID ANAE')
        words = len(re.findall(r"[A-Za-z]{2,}", t))
        return (
            (h ** 4) * (0.3 + c)
            * (1.0 + 0.15 * min(max(words - 1, 0), 3))
            * (1.0 if img <= 1 else 0.3)
        )

    scored = sorted(cands, key=lambda x: -tscore(x[0], x[1], x[2], x[3]))
    seed = next(
        ((t, c, h, img, i) for t, c, h, img, i in scored if _title_plausible(t)),
        None,
    )
    if seed:
        meta["title"] = _assemble_title(norm, seed)

    # an explicit "by <Name>" line outranks positional/base guesses
    by_line = next(
        (
            _clean_author(re.sub(r"(?i)^by\s+", "", t))
            for t, c, h, img, i in scored
            if re.match(r"(?i)^by\s+\S", t)
        ),
        None,
    )
    if by_line and _plausible_author(by_line):
        meta["authors"] = [by_line]
    elif not meta["authors"]:
        skip = {seed[0]} if seed else set()
        for t, c, h, img, i in scored:
            if t in skip:
                continue
            cand = _clean_author(re.sub(r"(?i)^by\s+", "", t))
            if _plausible_author(cand):
                meta["authors"] = [cand]
                break
    return meta


def _assemble_title(norm, seed) -> str:
    """Join the seed title line with adjacent same-block lines.

    Display titles wrap across detection lines ('A TREATISE ON THE' /
    'CONTRACT OF SALE'); the per-image line list is in reading order, so
    neighbors of the seed that share the image, sit in the same height
    band, and read as title-plausible text are part of the same title
    block. Capped at 2 lines each direction and ~60 joined chars.
    """
    t0, _, h0, img0, i0 = seed
    parts = {i0: t0}
    total = len(t0)
    for step in (-1, 1):
        j = i0 + step
        taken = 0
        while 0 <= j < len(norm) and taken < 2:
            t, c, h, img = norm[j]
            t = t.strip()
            if img != img0 or not (0.55 * h0 <= h <= 1.8 * h0):
                break
            # no confidence floor on joined neighbors: measured (round 5,
            # both lines artifacts) a c>=0.12 floor lost more mean ratio
            # from dropped true title lines than it saved on junk joins
            if not _title_plausible(t) or total + len(t) > 60:
                break
            parts[j] = t
            total += len(t)
            j += step
            taken += 1
    return " ".join(parts[k] for k in sorted(parts))
