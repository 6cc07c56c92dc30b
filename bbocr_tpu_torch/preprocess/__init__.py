from bbocr_tpu_torch.preprocess.autocrop import auto_crop_text_region, central_edge_crop, text_mask
from bbocr_tpu_torch.preprocess.chain import (
    BOOK_COVER_STEPS,
    preprocess_for_book_cover,
    preprocess_for_book_cover_batch,
)

__all__ = [
    "BOOK_COVER_STEPS",
    "auto_crop_text_region",
    "central_edge_crop",
    "preprocess_for_book_cover",
    "preprocess_for_book_cover_batch",
    "text_mask",
]
