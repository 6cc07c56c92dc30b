"""BB-OCR in PyTorch for one NVIDIA H100: the port of ``bbocr_tpu``.

The package mirrors ``bbocr_tpu``'s layout and names, so each module's
counterpart is easy to find, and keeps its public layouts at function
boundaries: (N, H, W) gray images, (B, 32, W) crops and (B, T, C) logits.
It imports ``torch`` and never ``jax``, ``flax`` or ``bbocr_tpu``; the
modules it needs from there that are plain numpy are copied here.

Entry points take ``device=`` and default to ``"cuda"``; the CPU runs only
when a caller asks for it. On CUDA tensors the preprocessing chain runs the
hand-written kernels in ``csrc/preprocess.cu``; on CPU tensors their plain
PyTorch versions.

Multi-device serving and training run SPMD over a ``torch.distributed``
process group (``parallel/``): one process per card, the batch split over
``dp`` and the widest products over ``tp``.
"""

from bbocr_tpu_torch.version import __version__

__all__ = ["__version__"]
