from bbocr_tpu_torch.llm.client import (
    GeminiClient,
    LLMClient,
    OllamaClient,
    OpenAIClient,
    create_llm_client,
)
from bbocr_tpu_torch.llm.native_vlm import NativeVLMClient, get_native_client

__all__ = [
    "LLMClient",
    "OllamaClient",
    "OpenAIClient",
    "GeminiClient",
    "NativeVLMClient",
    "create_llm_client",
    "get_native_client",
]
