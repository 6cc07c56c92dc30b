from bbocr_tpu_torch.llm.client import (
    GeminiClient,
    LLMClient,
    OllamaClient,
    OpenAIClient,
    create_llm_client,
)

__all__ = [
    "LLMClient",
    "OllamaClient",
    "OpenAIClient",
    "GeminiClient",
    "create_llm_client",
]
