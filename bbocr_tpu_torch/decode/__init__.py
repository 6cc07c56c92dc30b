from bbocr_tpu_torch.decode.boxes import (
    DetectionParams,
    extract_boxes,
    extract_boxes_masked,
    extract_boxes_masked_plain,
    group_lines,
    merge_coarse_quads,
    sort_reading_order,
    split_multiline_quads,
)
from bbocr_tpu_torch.decode.ctc import ctc_greedy_decode

__all__ = [
    "DetectionParams",
    "ctc_greedy_decode",
    "extract_boxes",
    "extract_boxes_masked",
    "extract_boxes_masked_plain",
    "group_lines",
    "merge_coarse_quads",
    "sort_reading_order",
    "split_multiline_quads",
]
