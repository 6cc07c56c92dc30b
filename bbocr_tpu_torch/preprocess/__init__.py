from bbocr_tpu_torch.preprocess.autocrop import central_edge_crop
from bbocr_tpu_torch.preprocess.chain import BOOK_COVER_STEPS, preprocess_for_book_cover

__all__ = ["BOOK_COVER_STEPS", "central_edge_crop", "preprocess_for_book_cover"]
