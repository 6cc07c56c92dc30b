"""Native (C++) host-side pieces, built with g++ and loaded via ctypes."""

from bbocr_tpu_torch.native.loader import connected_components_numpy, extract_quads_masked_native

__all__ = ["connected_components_numpy", "extract_quads_masked_native"]
