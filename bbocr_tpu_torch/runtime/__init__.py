from bbocr_tpu_torch.runtime.engine import EngineConfig, OCREngine

__all__ = ["EngineConfig", "OCREngine"]
