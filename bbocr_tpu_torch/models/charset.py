"""Recognition charsets and label codecs.

The reference's recognizer (EasyOCR english_g2) emits the latin/number/symbol
charset below with CTC blank at index 0; we keep the same alphabet so decoded
strings are drop-in comparable (reference call site:
``pipeline_demo/extractor/enhanced_extractor.py:520-521``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

# digits + ASCII symbols + space + euro + latin letters (EasyOCR en ordering).
EN_CHARS = (
    "0123456789"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
    "€"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
)

BLANK_ID = 0


@dataclass(frozen=True)
class Charset:
    chars: str

    @property
    def num_classes(self) -> int:
        # +1 for the CTC blank at index 0.
        return len(self.chars) + 1

    def encode(self, text: str) -> List[int]:
        lut = _index(self.chars)
        return [lut[c] for c in text if c in lut]

    def decode_ids(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if i == BLANK_ID:
                continue
            if 1 <= i <= len(self.chars):
                out.append(self.chars[i - 1])
        return "".join(out)

    def ctc_collapse(self, ids: Sequence[int]) -> str:
        """Greedy CTC post-processing: merge repeats, drop blanks."""
        out = []
        prev = -1
        for i in ids:
            if i != prev and i != BLANK_ID:
                out.append(self.chars[i - 1])
            prev = i
        return "".join(out)


def _index(chars: str) -> Dict[str, int]:
    return {c: i + 1 for i, c in enumerate(chars)}


EN_CHARSET = Charset(EN_CHARS)

# Latin-extended alphabet (BASELINE.json config 4 "multilingual recognition
# heads"): EN plus the western-European accented repertoire. A recognizer
# head sized for this charset trains from the same synthetic pipeline once
# fonts with coverage are supplied; the engine accepts any Charset.
LATIN_EXT_CHARS = EN_CHARS + (
    "ÀÁÂÃÄÅÆÇÈÉÊËÌÍÎÏÐÑÒÓÔÕÖØÙÚÛÜÝÞß"
    "àáâãäåæçèéêëìíîïðñòóôõöøùúûüýþÿ"
    "ĀāĂăĄąĆćČčĎďĐđĒēĖėĘęĚěĞğĠġĢģĪīĮįİıĶķĹĺĻļĽľŁłŃńŅņŇňŌōŐőŒœŔŕŘřŚśŞşŠš"
    "ŢţŤťŪūŮůŰűŲųŹźŻżŽž"
)

LATIN_EXT_CHARSET = Charset(LATIN_EXT_CHARS)

# CJK head scaffold (BASELINE config 4 "latin + CJK"): full kana, CJK
# punctuation/fullwidth forms, and the first two CJK Unified Ideograph
# columns as a bring-up subset. The head/codec/bucketing mechanics are
# exercised in tests at this vocabulary size; TRAINING it needs fonts with
# CJK coverage, which this image does not ship (DejaVu only) — the train
# CLI verifies glyph coverage and refuses to synthesize tofu.
_KANA = "".join(chr(c) for c in range(0x3041, 0x3097)) + "".join(
    chr(c) for c in range(0x30A1, 0x30FB)
)
_CJK_PUNCT = "、。〈〉《》「」『』【】〜・ー"
_IDEOGRAPHS = "".join(chr(c) for c in range(0x4E00, 0x5000))
CJK_CHARS = EN_CHARS + _KANA + _CJK_PUNCT + _IDEOGRAPHS
CJK_CHARSET = Charset(CJK_CHARS)

CHARSETS = {
    "en": EN_CHARSET,
    "latin_ext": LATIN_EXT_CHARSET,
    "cjk": CJK_CHARSET,
}


def charset_for_num_classes(num_classes: int) -> Charset:
    """Infer the charset a recognizer head was trained with from its CTC
    output width (chars + 1 blank). Lets the engine load en and latin-ext
    checkpoints interchangeably (BASELINE config 4)."""
    for cs in CHARSETS.values():
        if cs.num_classes == num_classes:
            return cs
    raise ValueError(f"no known charset with num_classes={num_classes}")
