from bbocr_tpu_torch.utils.env import env_flag

__all__ = ["env_flag"]
