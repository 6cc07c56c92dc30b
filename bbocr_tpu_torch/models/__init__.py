from bbocr_tpu_torch.models.charset import EN_CHARSET, Charset, charset_for_num_classes
from bbocr_tpu_torch.models.convert import (
    craft_params,
    craft_state_dict,
    crnn_params,
    crnn_state_dict,
    pagereader_params,
    pagereader_state_dict,
)
from bbocr_tpu_torch.models.craft import CRAFT, CRAFTLite, CRAFTPublished
from bbocr_tpu_torch.models.crnn import CRNN
from bbocr_tpu_torch.models.layers import cast_for_compute
from bbocr_tpu_torch.models.vlm import PageReader, greedy_generate
from bbocr_tpu_torch.models.weights import (
    fold_gray_stem,
    import_craft_from_torch,
    import_crnn_from_torch,
    load_craft_torch_checkpoint,
    load_crnn_torch_checkpoint,
)

__all__ = [
    "CRAFT",
    "CRAFTLite",
    "CRAFTPublished",
    "CRNN",
    "PageReader",
    "Charset",
    "cast_for_compute",
    "EN_CHARSET",
    "charset_for_num_classes",
    "craft_params",
    "craft_state_dict",
    "crnn_params",
    "crnn_state_dict",
    "fold_gray_stem",
    "greedy_generate",
    "import_craft_from_torch",
    "import_crnn_from_torch",
    "load_craft_torch_checkpoint",
    "load_crnn_torch_checkpoint",
    "pagereader_params",
    "pagereader_state_dict",
]
