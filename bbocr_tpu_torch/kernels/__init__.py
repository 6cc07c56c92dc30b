from bbocr_tpu_torch.kernels.preprocess_cuda import (
    KERNELS,
    blur3_u8,
    blur3_u8_plain,
    enhance_u8,
    enhance_u8_plain,
    reset_launches,
    unsharp_u8,
    unsharp_u8_plain,
)

__all__ = [
    "KERNELS",
    "blur3_u8",
    "blur3_u8_plain",
    "enhance_u8",
    "enhance_u8_plain",
    "reset_launches",
    "unsharp_u8",
    "unsharp_u8_plain",
]
