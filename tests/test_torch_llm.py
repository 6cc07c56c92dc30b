"""The port's LLM clients and JSON repair against the JAX package's.

Each backend's client of both packages is driven by the same scripted fake
HTTP session (no network, no model): the requests posted (URL, JSON body,
headers, timeout), the return value or the exception's type and message,
``last_usage``, and Gemini's ``tried_models`` and ``last_url`` must be
equal, exactly. ``repair_and_parse`` must return what the JAX one returns,
or raise the same ``JSONDecodeError``.
"""

import json
import sys

import pytest
import requests

from bbocr_tpu.extract.jsonrepair import repair_and_parse as jax_repair
from bbocr_tpu.llm import client as jax_client
from bbocr_tpu_torch.extract import repair_and_parse
from bbocr_tpu_torch.llm import client as port_client


class FakeResponse:
    def __init__(self, status_code, payload=None, text=""):
        self.status_code = status_code
        self._payload = payload or {}
        self.text = text

    def json(self):
        return self._payload


class FakeSession:
    """Replays ``script`` (responses, or exceptions to raise) and records
    every post."""

    def __init__(self, script):
        self.script = list(script)
        self.posts = []

    def post(self, url, json=None, headers=None, timeout=None):
        self.posts.append((url, json, headers, timeout))
        item = self.script.pop(0)
        if isinstance(item, BaseException):
            raise item
        return item


def ok_gemini(text="{}", usage=True):
    payload = {"candidates": [{"content": {"parts": [{"text": text[:1]}, {"text": text[1:]}]}}]}
    if usage:
        payload["usageMetadata"] = {"promptTokenCount": 1200, "candidatesTokenCount": 80}
    return FakeResponse(200, payload)


def ok_openai(text="{}", usage=True):
    payload = {"choices": [{"message": {"content": text}}]}
    if usage:
        payload["usage"] = {"prompt_tokens": 2000, "completion_tokens": 1000}
    return FakeResponse(200, payload)


SCENARIOS = {
    "ollama": {
        "ok": [FakeResponse(200, {"response": '{"title": "T"}'})],
        "no_response_key": [FakeResponse(200, {"done": True})],
        "http_500": [FakeResponse(500, text="model not loaded" * 40)],
    },
    "openai": {
        "ok_usage": [ok_openai('{"title": "T"}')],
        "ok_no_usage": [ok_openai("x", usage=False)],
        "http_429": [FakeResponse(429, text="rate limited")],
        "missing_key": [],
    },
    "gemini": {
        "ok_usage": [ok_gemini('{"title": "T"}')],
        "ok_no_usage": [ok_gemini("abc", usage=False)],
        "404_name_chain": [FakeResponse(404), ok_gemini("renamed")],
        "404_chain_exhausted": [FakeResponse(404)] * 3,
        "403_quota_chain": [FakeResponse(403), ok_gemini("cheap")],
        "403_then_429": [FakeResponse(403), FakeResponse(429, text="still over quota")],
        "429_then_500": [FakeResponse(429), FakeResponse(500, text="boom")],
        "no_candidates": [FakeResponse(200, {"candidates": [], "promptFeedback": {"blockReason": "SAFETY"}})],
        "request_exception": [requests.ConnectionError("refused"), ok_gemini("after")],
        "all_raise": [requests.Timeout("slow")] * 3,
        "missing_key": [],
    },
}
CASES = [(b, s) for b, scenarios in SCENARIOS.items() for s in scenarios]
ANSWERED = {"ok", "no_response_key", "ok_usage", "ok_no_usage", "404_name_chain", "403_quota_chain", "request_exception"}
CLASSES = {"ollama": "OllamaClient", "openai": "OpenAIClient", "gemini": "GeminiClient"}


def _drive(module, backend, scenario, monkeypatch):
    for key in ("OPENAI_API_KEY", "OPENAI_BASE_URL", "GOOGLE_API_KEY", "GEMINI_API_KEY", "GOOGLE_API_BASE"):
        monkeypatch.delenv(key, raising=False)
    if scenario != "missing_key":
        monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
        monkeypatch.setenv("GEMINI_API_KEY", "g-test")
    session = FakeSession(SCENARIOS[backend][scenario])
    client = module.create_llm_client(backend, session=session)
    assert type(client).__name__ == CLASSES[backend]
    model = {"ollama": "gemma3:4b", "openai": "gpt-4o", "gemini": "gemini-1.5-flash"}[backend]
    try:
        result = ("ok", client.generate(model, "PROMPT", ["aGVsbG8=", "d29ybGQ="], timeout_seconds=12.0))
    except Exception as e:
        result = ("raised", type(e).__name__, str(e))
    extra = {k: getattr(client, k, None) for k in ("last_usage", "tried_models", "last_url")}
    return session.posts, result, extra


@pytest.mark.parametrize("backend,scenario", CASES, ids=[f"{b}-{s}" for b, s in CASES])
def test_client_matches_jax(backend, scenario, monkeypatch):
    ref = _drive(jax_client, backend, scenario, monkeypatch)
    got = _drive(port_client, backend, scenario, monkeypatch)
    assert got == ref
    assert got[1][0] == ("ok" if scenario in ANSWERED else "raised")


def test_usage_and_costs_match_jax():
    for args in (("openai", 2000, 1000), ("gemini", 1200, 80), ("ollama", 5, None), ("openai", None, None)):
        assert port_client._usage(*args) == jax_client._usage(*args)
    assert port_client._COST_PER_1K == jax_client._COST_PER_1K
    assert port_client.GeminiClient.NAME_FALLBACKS == jax_client.GeminiClient.NAME_FALLBACKS
    assert port_client.GeminiClient.QUOTA_FALLBACKS == jax_client.GeminiClient.QUOTA_FALLBACKS


def test_factory_names_what_is_not_ported(monkeypatch):
    """Every JAX backend is ported: ``tpu``, ``native`` and ``pagereader``
    give the PageReader's cached client in both packages (nothing is loaded
    until a page comes); an unknown backend raises JAX's ``ValueError``."""
    from bbocr_tpu.llm import native_vlm as jax_native
    from bbocr_tpu_torch.llm import native_vlm

    monkeypatch.setattr(jax_native, "_CLIENT_CACHE", {})
    monkeypatch.setattr(native_vlm, "_CLIENT_CACHE", {})
    for name in ("tpu", "native", "pagereader"):
        ref = jax_client.create_llm_client(name)
        got = port_client.create_llm_client(name, session=FakeSession([]), device="cpu")
        assert isinstance(ref, jax_native.NativeVLMClient) and isinstance(got, native_vlm.NativeVLMClient)
        assert got is port_client.create_llm_client("tpu", device="cpu") and got.ckpt_path == ref.ckpt_path
    with pytest.raises(ValueError) as ref:
        jax_client.create_llm_client("claude", session=FakeSession([]))
    with pytest.raises(ValueError) as got:
        port_client.create_llm_client("claude", session=FakeSession([]))
    assert str(got.value) == str(ref.value) == "Unknown LLM backend: claude"


@pytest.mark.parametrize("backend", ["ollama", "openai", "gemini"])
def test_client_without_session_names_requests(backend, monkeypatch):
    """Without ``requests`` a client needs a session, and says so; with a
    session it never imports ``requests``, and Gemini's handler catches
    nothing (``except ()``)."""
    monkeypatch.setitem(sys.modules, "requests", None)
    with pytest.raises(ImportError, match="requests"):
        port_client.create_llm_client(backend)
    monkeypatch.setenv("GEMINI_API_KEY", "g-test")
    gemini = port_client.create_llm_client("gemini", session=FakeSession([ConnectionError("down")]))
    with pytest.raises(ConnectionError, match="down"):
        gemini.generate("gemini-1.5-pro", "p", [])


REPAIR_CASES = [
    'Sure! ```json\n{"title": "T", "authors": []}\n``` hope that helps',
    '{"title": "T", "year": "YYYY | null", "subtitle": "string | null", "page_count": "integer | null"}',
    'prefix {"title": "T"} suffix',
    "no json here",
    '```\n{"title": "T", "authors": ["string", "..."] | [], "price": {"amount": "float | null"}}\n```',
    '{"title": "A"} and then {"title": "B"}',
    '{"title": "A"} junk {"x": 1}',
    "} backwards {",
    "",
    '```json{"categories": ["string", "..."] | [], "isbn_13": "string | null"}```',
    '{"title": "Caf\\u00e9", "authors": ["A", "B"], "page_count": 320}',
]


@pytest.mark.parametrize("raw", REPAIR_CASES, ids=range(len(REPAIR_CASES)))
def test_repair_and_parse_matches_jax(raw):
    try:
        ref = ("ok", jax_repair(raw))
    except json.JSONDecodeError as e:
        ref = ("raised", str(e))
    try:
        got = ("ok", repair_and_parse(raw))
    except json.JSONDecodeError as e:
        got = ("raised", str(e))
    assert got == ref
