"""Backend-pluggable LLM clients: text+images -> text.

Counterpart of ``bbocr_tpu/llm/client.py``, with the same surface:
- ``create_llm_client(backend, session)`` factory
- ``LLMClient.generate(model, prompt, images_b64, timeout_seconds) -> str``
- Ollama /api/generate with base64 images and split connect/read timeouts
- OpenAI chat completions with data-URL image parts, temperature 0
- Gemini generateContent with inline_data parts, 404 model-name fallback
  chain and 403/429 cheaper-model fallback chain, last_url/tried_models
  debug fields

Env vars honored: OPENAI_API_KEY / OPENAI_BASE_URL,
GOOGLE_API_KEY / GEMINI_API_KEY / GOOGLE_API_BASE.

``requests`` is imported only where a client is built without a session
(the machine with the card has no HTTP library; callers pass their own
session there). ``"tpu"`` (also ``"native"`` and ``"pagereader"``) is the
PageReader on the card (``llm/native_vlm.py``): no HTTP, no session, one
cached client per checkpoint and device.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional


def _new_session() -> Any:
    try:
        import requests
    except ImportError as e:
        raise ImportError("an LLM client without a session needs the requests package; pass session=...") from e
    return requests.Session()


def _request_errors() -> tuple:
    """``requests.RequestException`` when requests imports, else nothing
    (``except ()`` catches no exception)."""
    try:
        import requests
    except ImportError:
        return ()
    return (requests.RequestException,)


class LLMClient:
    """Provider-agnostic interface.

    After a successful ``generate``, ``last_usage`` holds per-request
    accounting for metered backends (``{"prompt_tokens", "completion_tokens",
    "cost_usd"}``) or None for free/local ones.
    """

    last_usage: Optional[dict] = None

    def generate(self, model: str, prompt: str, images_b64: List[str], timeout_seconds: float = 300.0) -> str:
        raise NotImplementedError


# $/1K tokens in, out.
_COST_PER_1K = {
    "openai": (0.005, 0.015),
    # Gemini flash-tier public list price; flash is the fallback chain's floor.
    "gemini": (0.000075, 0.0003),
}


def _usage(backend: str, prompt_tokens: Optional[int], completion_tokens: Optional[int]) -> Optional[dict]:
    if prompt_tokens is None and completion_tokens is None:
        return None
    rate_in, rate_out = _COST_PER_1K.get(backend, (0.0, 0.0))
    cost = None
    if prompt_tokens is not None and completion_tokens is not None:
        cost = round(prompt_tokens / 1000.0 * rate_in + completion_tokens / 1000.0 * rate_out, 6)
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "cost_usd": cost,
    }


class OllamaClient(LLMClient):
    def __init__(self, session: Optional[Any] = None, base_url: str = "http://127.0.0.1:11434"):
        self.session = session or _new_session()
        self.base_url = base_url.rstrip("/")

    def generate(self, model, prompt, images_b64, timeout_seconds=300.0):
        payload = {"model": model, "prompt": prompt, "stream": False, "images": images_b64}
        connect = 2.5
        read = max(30.0, timeout_seconds - connect)
        resp = self.session.post(f"{self.base_url}/api/generate", json=payload, timeout=(connect, read))
        if resp.status_code != 200:
            raise RuntimeError(f"Ollama HTTP {resp.status_code}: {resp.text[:300]}")
        return resp.json().get("response", "")


class OpenAIClient(LLMClient):
    def __init__(self, session: Optional[Any] = None):
        self.session = session or _new_session()
        self.api_key = os.getenv("OPENAI_API_KEY", "")
        self.base_url = os.getenv("OPENAI_BASE_URL", "https://api.openai.com/v1").rstrip("/")

    def generate(self, model, prompt, images_b64, timeout_seconds=300.0):
        if not self.api_key:
            raise RuntimeError("OPENAI_API_KEY not configured")
        content = [{"type": "text", "text": prompt}]
        for b64 in images_b64:
            content.append(
                {"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{b64}"}}
            )
        payload = {
            "model": model,
            "messages": [{"role": "user", "content": content}],
            "temperature": 0,
        }
        resp = self.session.post(
            f"{self.base_url}/chat/completions",
            json=payload,
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=(5.0, max(30.0, timeout_seconds)),
        )
        if resp.status_code != 200:
            raise RuntimeError(f"OpenAI HTTP {resp.status_code}: {resp.text[:300]}")
        data = resp.json()
        u = data.get("usage") or {}
        self.last_usage = _usage("openai", u.get("prompt_tokens"), u.get("completion_tokens"))
        return data["choices"][0]["message"]["content"]


class GeminiClient(LLMClient):
    # Model-name fallbacks tried on 404 (renamed API ids), and cheaper-model
    # fallbacks tried on 403/429 (quota/entitlement).
    NAME_FALLBACKS = {
        "gemini-1.5-flash": ["gemini-1.5-flash-latest", "gemini-1.5-flash-002"],
        "gemini-1.5-pro": ["gemini-1.5-pro-latest", "gemini-1.5-pro-002"],
        "gemini-2.0-flash": ["gemini-2.0-flash-exp"],
    }
    QUOTA_FALLBACKS = ["gemini-1.5-flash", "gemini-1.5-flash-8b"]

    def __init__(self, session: Optional[Any] = None):
        self.session = session or _new_session()
        self.api_key = os.getenv("GOOGLE_API_KEY") or os.getenv("GEMINI_API_KEY") or ""
        self.base_url = os.getenv("GOOGLE_API_BASE", "https://generativelanguage.googleapis.com").rstrip("/")
        self.last_url: Optional[str] = None
        self.tried_models: List[str] = []

    def _call(self, model, prompt, images_b64, timeout_seconds):
        parts = [{"text": prompt}]
        for b64 in images_b64:
            parts.append({"inline_data": {"mime_type": "image/jpeg", "data": b64}})
        url = f"{self.base_url}/v1beta/models/{model}:generateContent?key={self.api_key}"
        self.last_url = url.split("?")[0]
        self.tried_models.append(model)
        resp = self.session.post(
            url,
            json={"contents": [{"parts": parts}]},
            timeout=(5.0, max(30.0, timeout_seconds)),
        )
        return resp

    def generate(self, model, prompt, images_b64, timeout_seconds=300.0):
        if not self.api_key:
            raise RuntimeError("GOOGLE_API_KEY/GEMINI_API_KEY not configured")
        self.tried_models = []
        queue = [model] + self.NAME_FALLBACKS.get(model, [])
        quota_queue = [m for m in self.QUOTA_FALLBACKS if m != model]
        last_err = None
        while queue:
            m = queue.pop(0)
            try:
                resp = self._call(m, prompt, images_b64, timeout_seconds)
            except _request_errors() as e:
                last_err = e
                continue
            if resp.status_code == 200:
                data = resp.json()
                cands = data.get("candidates") or []
                if not cands:
                    raise RuntimeError(f"Gemini returned no candidates: {str(data)[:300]}")
                um = data.get("usageMetadata") or {}
                self.last_usage = _usage(
                    "gemini", um.get("promptTokenCount"), um.get("candidatesTokenCount")
                )
                parts = cands[0].get("content", {}).get("parts", [])
                return "".join(p.get("text", "") for p in parts)
            if resp.status_code == 404 and m in self.NAME_FALLBACKS:
                queue = self.NAME_FALLBACKS[m] + queue
                last_err = RuntimeError(f"Gemini 404 for {m}")
                continue
            if resp.status_code in (403, 429) and quota_queue:
                # quota/entitlement problem: abandon the name-fallback chain
                # and switch to the cheaper-model chain entirely
                queue = list(quota_queue)
                quota_queue = []
                last_err = RuntimeError(f"Gemini {resp.status_code} for {m}")
                continue
            raise RuntimeError(f"Gemini HTTP {resp.status_code}: {resp.text[:300]}")
        raise RuntimeError(f"Gemini request failed after fallbacks: {last_err}")


NATIVE_BACKENDS = ("tpu", "native", "pagereader")


def create_llm_client(backend: str, session: Optional[Any] = None, device="cuda") -> LLMClient:
    """The client of ``backend``; ``session`` serves the HTTP backends and
    ``device`` the PageReader's."""
    backend = (backend or "ollama").lower()
    if backend == "ollama":
        return OllamaClient(session)
    if backend == "openai":
        return OpenAIClient(session)
    if backend == "gemini":
        return GeminiClient(session)
    if backend in NATIVE_BACKENDS:
        # The PageReader on the card: no model server at all. Cached
        # process-wide: the parameters stay on the device across requests.
        from bbocr_tpu_torch.llm.native_vlm import get_native_client

        return get_native_client(device=device)
    raise ValueError(f"Unknown LLM backend: {backend}")
