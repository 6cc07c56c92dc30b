"""The port's scanner service against the JAX package's, on the CPU, over
sockets on 127.0.0.1 with the standard library's HTTP client.

- Every flow of ``tests/test_server.py`` (basics, jobs, SSE and poll
  dedup, review, sanitised ids, the oversized body and OPTIONS, the
  unknown job stream, the pricing endpoints, examples, metrics) against
  both packages' services through one fixture parametrised over the two,
  with its ``FakeExtractor``.
- One scripted request sequence (a fake Ollama on 127.0.0.1, canned
  pricing clients, jobs, review, pricing, metrics) with equal status codes
  and equal bodies in both packages, volatile fields masked.
- The port's service with the real extractor at a 416x320 canvas in
  float32 on ``books/1`` (heuristic, and ollama through the canned
  session) against the JAX service's run recorded in
  ``tests/data/server_route_jax_f32_416x320.json``; its pricing requests
  and the pricing CLI against ``tests/data/pricing_jax.json``.
- ``BB_OCR_FAST_SINGLE=1`` takes the same wrapped route (no fast path) in
  both; the engine warm-up; the Ollama calls through a session passed in;
  the standalone pricing server and the Sheets rows (through stand-ins of
  the Google libraries) as the JAX package's; the static files byte-equal.

The services' jobs never overlap: both write uploads to the same
``tempfile.gettempdir()/bb_ocr_ui_uploads`` under millisecond ids, so each
test waits for its jobs and the fixture for all of them.
"""

import http.server
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import bbocr_tpu.pricing.aggregator as jax_aggregator
from bbocr_tpu.extract import extractor as jax_extractor_module
from bbocr_tpu.runtime.batching import BatchingOCR as JaxBatchingOCR
from bbocr_tpu.server import app as jax_app
from bbocr_tpu_torch.extract import extractor as port_extractor_module
from bbocr_tpu_torch.pricing import aggregator as port_aggregator
from bbocr_tpu_torch.pricing.providers import abebooks_html as port_abe
from bbocr_tpu_torch.pricing.providers import google_books as port_gb
from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
from bbocr_tpu_torch.runtime.batching import BatchingOCR
from bbocr_tpu_torch.runtime.bucketing import CanvasSpec
from bbocr_tpu_torch.server import app as port_app
from chip_smoke import job_differences
from scripts.torch_port_reference import (
    LLM_MODELS,
    LLM_REPLIES,
    CannedHttp,
    CannedSession,
    ServiceThread,
    http_call,
    http_json,
    masked,
    multipart,
    pricing_flow,
    server_jobs,
    sse_frames,
    wait_jobs_idle,
)
from tests.test_server import PNG_1PX, FakeExtractor

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_ROUTE = os.path.join(ROOT, "tests", "data", "server_route_jax_f32_416x320.json")
PRICING = os.path.join(ROOT, "tests", "data", "pricing_jax.json")
APPS = {"jax": jax_app, "torch": port_app}


def _service(package: str, data_dir: str, **kw):
    if package == "torch":
        kw.setdefault("device", "cpu")
    return APPS[package].ScannerService(data_dir=data_dir, **kw)


@pytest.fixture(scope="module", params=list(APPS))
def server(request, tmp_path_factory):
    service = _service(request.param, str(tmp_path_factory.mktemp(f"data_{request.param}")))
    service._build_extractor = lambda **kw: FakeExtractor()
    with ServiceThread(service) as srv:
        yield srv.base, service
        assert wait_jobs_idle(service, 30)


def _get(base, path):
    return http_json(base, "GET", path)


def _post(base, path, payload):
    return http_json(base, "POST", path, payload)


def _submit(base, n_files=2, form=None):
    body, ctype = multipart(form or {"llm_backend": "ollama", "model": "gemma3:4b", "run_ocr": "true"},
                            [("images", f"p{i}.png", "image/png", PNG_1PX) for i in range(n_files)])
    status, _, data = http_call(base, "POST", "/api/process_images", body, {"Content-Type": ctype})
    assert status == 200, data
    return json.loads(data)


def _wait_done(base, job_id, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        job = _get(base, f"/api/job_status?id={job_id}")[1]
        if job.get("status") in ("done", "error"):
            return job
        time.sleep(0.05)
    raise TimeoutError("job did not finish")


# ---------------------------------------------------------------------------
# tests/test_server.py's flows, on both packages
# ---------------------------------------------------------------------------


class TestBasics:
    def test_health(self, server):
        base, _ = server
        data = _get(base, "/api/health")[1]
        assert data["status"] == "ok" and data["pipeline_imported"] is True and data["pricing_available"] is True

    def test_404_and_405(self, server):
        base, _ = server
        assert _get(base, "/api/nope")[0] == 404
        assert _get(base, "/api/accept")[0] == 405

    def test_models_fallback(self, server):
        base, _ = server
        assert "gemma3:4b" in _get(base, "/api/models")[1]["models"]

    def test_index_and_static(self, server):
        base, _ = server
        status, text = _get(base, "/")
        assert status == 200 and "Scanner" in text
        assert http_call(base, "GET", "/static/script.js")[0] == 200
        assert http_call(base, "GET", "/static/../app.py")[0] == 404

    @pytest.mark.parametrize("backend,model", [("gemini", "gemma3:4b"), ("openai", "llava:7b"), ("ollama", "a:b"),
                                               ("gemini", "gemini-2.5-flash"), ("gpt-4o", "gemini-x"), ("", "")])
    def test_validate_backend_model(self, server, backend, model):
        assert port_app.validate_backend_model(backend, model) == jax_app.validate_backend_model(backend, model)


class TestJobs:
    def test_process_and_result(self, server):
        base, _ = server
        data = _submit(base)
        assert data["status"] == "started" and data["id"].startswith("batch_")
        job = _wait_done(base, data["id"])
        assert job["status"] == "done" and job["metadata"]["title"] == "Fake Book"
        assert job["metadata"]["_processing_info"]["ocr_images_processed"] == 1  # [1] for two images
        assert _get(base, f"/api/job_result?id={data['id']}")[0] == 200

    def test_rejects_non_image(self, server):
        base, _ = server
        body, ctype = multipart({"llm_backend": "ollama", "model": "m"}, [("images", "x.txt", "text/plain", b"hi")])
        assert http_call(base, "POST", "/api/process_images", body, {"Content-Type": ctype})[0] == 400

    def test_bad_backend_model(self, server):
        base, _ = server
        body, ctype = multipart({"llm_backend": "gemini", "model": "gemma3:4b"},
                                [("images", "p.png", "image/png", PNG_1PX)])
        status, _, data = http_call(base, "POST", "/api/process_images", body, {"Content-Type": ctype})
        assert status == 400 and "Invalid model for Gemini" in json.loads(data)["error"]

    def test_trace_poll_heavy_dedup(self, server):
        base, _ = server
        data = _submit(base)
        _wait_done(base, data["id"])
        items = _get(base, f"/api/trace_poll?id={data['id']}&after=0")[1]["items"]
        assert len(items) >= 2
        assert items[0]["trace"]["images"][0]["original_b64"] is not None
        assert items[1]["trace"]["images"][0]["original_b64"] is None

    def test_log_poll_coalescing(self, server):
        base, _ = server
        data = _submit(base)
        _wait_done(base, data["id"])
        lines = [i["line"] for i in _get(base, f"/api/log_poll?id={data['id']}&after=0")[1]["items"]]
        assert any("(x2)" in line for line in lines), lines

    def test_sse_job_stream(self, server):
        base, _ = server
        data = _submit(base)
        _, headers, _ = http_call(base, "GET", "/api/job_stream?id=no_such_job")
        assert headers["content-type"].startswith("text/event-stream")
        frames = sse_frames(base, f"/api/job_stream?id={data['id']}", lambda f: f.get("status") in ("done", "error"),
                            timeout=10)
        statuses = [f["status"] for _, f in frames if "status" in f]
        assert statuses[-1] == "done"
        assert "queued" in statuses or "running" in statuses


class TestReviewWorkflow:
    def test_accept_transfer_finalize(self, server):
        base, _ = server
        meta = {"title": "The Sea", "authors": ["J. B."], "year": "2005"}
        r = _post(base, "/api/accept", {"id": "item_1", "metadata": meta})[1]
        assert r["status"] == "saved" and r["path"].endswith("item_1.json")
        assert _get(base, f"/api/transfer_get?key={r['transfer_key']}")[1]["metadata"]["title"] == "The Sea"
        assert _get(base, "/api/transfer_get?key=bogus")[0] == 404
        fin = _post(base, "/api/pricing/finalize", {"id": "item_1", "decision": "approved",
                                                    "merged": dict(meta, price={"currency": "USD", "amount": 5})})[1]
        assert fin["status"] == "approved" and "the_sea_" in fin["path"]
        assert _post(base, "/api/pricing/finalize", {"decision": "maybe"})[0] == 400

    def test_reject(self, server):
        base, _ = server
        r = _post(base, "/api/reject", {"id": "item_2", "reason": "blurry"})[1]
        assert r["status"] == "rejected"
        with open(r["path"]) as f:
            assert f.read() == "blurry"

    def test_accept_reject_ids_are_sanitized(self, server):
        base, service = server
        r = _post(base, "/api/accept", {"id": "../../escape", "metadata": {"title": "X"}})[1]
        assert os.path.dirname(os.path.abspath(r["path"])) == os.path.abspath(service.accepted_dir)
        r2 = _post(base, "/api/reject", {"id": "/abs/path", "reason": "x"})[1]
        assert os.path.dirname(os.path.abspath(r2["path"])) == os.path.abspath(service.rejected_dir)

    def test_oversized_body_and_options_preflight(self, server):
        base, _ = server
        host, port = base.replace("http://", "").split(":")
        with socket.create_connection((host, int(port)), timeout=5) as s:
            s.sendall(b"POST /api/accept HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                      b"Content-Length: 68157440\r\n\r\n")
            status_line = s.recv(4096).split(b"\r\n", 1)[0]
        assert b"413" in status_line
        status, headers, _ = http_call(base, "OPTIONS", "/api/accept")
        assert status == 204 and headers.get("access-control-allow-origin") == "*"

    def test_job_stream_unknown_id_terminates(self, server):
        base, _ = server
        frames = sse_frames(base, "/api/job_stream?id=no_such_job", lambda f: False, timeout=5)
        assert any(f.get("error") == "unknown job" for _, f in frames)


class TestPricingEndpoints:
    def test_lookup_with_fake_provider(self, server, monkeypatch):
        base, service = server
        aggregator = port_aggregator if isinstance(service, port_app.ScannerService) else jax_aggregator
        offer = {"provider": "fake", "listing_id": "1", "title": "The Sea", "amount": 9.0, "currency": "USD"}

        class FP:
            async def lookup(self, **q):
                return [offer]

        monkeypatch.setitem(aggregator.DEFAULT_PROVIDERS, "fake", FP)
        data = _post(base, "/api/pricing_lookup", {"title": "The Sea", "authors": "J. B.", "providers": ["fake"]})[1]
        assert data["offers"][0]["amount"] == 9.0 and data["query"]["authors"] == ["J. B."]

    def test_select_best(self, server):
        base, _ = server
        offers = [dict(provider="a", listing_id="1", title="The Sea", amount=5.0, currency="USD",
                       publication_date="2005"),
                  dict(provider="a", listing_id="2", title="Other", amount=2.0, currency="USD")]
        data = _post(base, "/api/pricing/select_best",
                     {"metadata": {"title": "The Sea", "year": "2005"}, "offers": offers})[1]
        assert data["best_offer"]["listing_id"] == "1" and data["merged"]["price"]["amount"] == 5.0

    def test_providers_alias_and_embed(self, server):
        base, _ = server
        names = _get(base, "/providers")[1]["providers"]
        assert "abebooks" in names and "google_books" in names
        html = _get(base, "/pricing_embed")[1]
        assert "/pricing_static/" in html and "/static/pricing.css" not in html

    def test_processed_load_path_allowlist(self, server):
        base, _ = server
        assert _get(base, "/processed/load?path=/etc/passwd")[0] == 400


class TestExamples:
    def test_example_flow(self, server, tmp_path):
        base, service = server
        book = tmp_path / "books" / "demo"
        book.mkdir(parents=True)
        (book / "p0.png").write_bytes(PNG_1PX)
        (book / "p1.png").write_bytes(PNG_1PX)
        service.books_dir = str(tmp_path / "books")
        assert _get(base, "/api/examples")[1]["examples"][0]["has_output"] is False
        r = _post(base, "/api/process_example", {"name": "demo", "llm_backend": "ollama", "model": "m"})[1]
        assert r["status"] == "started"
        _wait_done(base, r["id"])
        assert _get(base, "/api/example_output?name=demo")[1]["metadata"]["title"] == "Fake Book"
        assert _get(base, "/api/examples")[1]["examples"][0]["has_output"] is True

    def test_unknown_example(self, server):
        base, _ = server
        assert _post(base, "/api/process_example", {"name": "nope"})[0] == 404


class TestMetrics:
    def test_metrics_endpoint(self, server):
        base, _ = server
        data = _get(base, "/api/metrics")[1]
        assert data["uptime_s"] >= 0 and isinstance(data["jobs"], dict) and "engine_timings" in data


# ---------------------------------------------------------------------------
# One scripted sequence, equal in both packages
# ---------------------------------------------------------------------------


class _FakeOllama(http.server.BaseHTTPRequestHandler):
    def _reply(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._reply({"models": [{"name": "gemma3:4b"}, {"name": "llava:7b"}, {}]})

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self._reply({"response": "pong"})

    def log_message(self, *args):
        pass


class _TimedEngine:
    def timings(self):
        return {"detect": {"count": 1, "total_s": 0.5}}


def _scripted(base: str, service, tmp) -> list:
    book = os.path.join(tmp, "books", "demo")
    os.makedirs(book)
    for name in ("a.png", "b.png", "c.png"):
        with open(os.path.join(book, name), "wb") as f:
            f.write(PNG_1PX)
    service.books_dir = os.path.join(tmp, "books")
    root, out = tmp, []

    def call(method, path, payload=None):
        status, body = http_json(base, method, path, payload)
        out.append((method, masked(path, root), status, masked(body, root)))
        return body

    call("GET", "/api/health")
    call("GET", "/api/models")
    call("POST", "/api/test_model", {"backend": "ollama", "model": "gemma3:4b"})
    call("POST", "/api/test_model", {"backend": "gemini", "model": "gemma3:4b"})
    call("POST", "/api/test_model", {"backend": "openai", "model": "gpt-4o"})
    call("POST", "/api/test_model", {"backend": "gemini", "model": "gemini-2.5-flash"})
    call("GET", "/api/nope")
    call("GET", "/api/accept")
    call("GET", "/static/style.css")
    call("GET", "/pricing_static/pricing.js")
    call("GET", "/api/examples")
    call("POST", "/api/process_example", {"name": "demo", "llm_backend": "ollama", "model": "m"})
    assert wait_jobs_idle(service, 30)
    call("POST", "/api/process_example", {"name": "nope"})
    call("GET", "/api/example_output?name=demo")
    call("GET", "/api/examples")
    job = _submit(base, 3, {"llm_backend": "heuristic", "run_ocr": "true", "crop_ocr": "yes", "edge_crop": "2.5"})
    assert wait_jobs_idle(service, 30)
    for path in ("job_status", "job_result", "trace_poll", "log_poll"):
        call("GET", f"/api/{path}?id={job['id']}")
    call("GET", "/api/job_status?id=nope")
    call("GET", "/api/job_result?id=nope")
    call("POST", "/api/reject", {"id": "Bad Scan", "reason": "blurry"})
    with open(os.path.join(ROOT, "tests", "data", "pricing_jax.json")) as f:
        accepted = json.load(f)["accepted"]
    out.append(("flow", "pricing", 200, pricing_flow(base, accepted, root)))
    call("GET", "/api/google_sheets/test")
    call("GET", "/api/metrics")
    return out


def test_scripted_sequence_matches_jax(tmp_path, monkeypatch):
    """The same requests to both packages' services give equal status codes
    and bodies: a fake Ollama on 127.0.0.1 answers the model list and test;
    the pricing clients are canned; jobs run the fake extractor."""
    ollama = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FakeOllama)
    threading.Thread(target=ollama.serve_forever, daemon=True).start()
    with open(PRICING) as f:
        ref = json.load(f)
    pages = {kn: ref["pages"][name] for kn, name in ref["lookup_pages"].items()}
    ours, theirs = CannedHttp(ref["google_payload"], pages), CannedHttp(ref["google_payload"], pages)
    monkeypatch.setattr(port_gb, "_async_client", ours)
    monkeypatch.setattr(port_abe, "_async_client", ours)
    monkeypatch.setattr("httpx.AsyncClient", theirs)
    monkeypatch.setenv("BB_OCR_OLLAMA_URL", f"http://127.0.0.1:{ollama.server_address[1]}")
    for key in ("OPENAI_API_KEY", "GEMINI_API_KEY", "GOOGLE_API_KEY", "GOOGLE_SHEETS_CREDENTIALS_JSON"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(jax_extractor_module, "_ENGINE_CACHE", {"engine": _TimedEngine()})
    monkeypatch.setattr(port_extractor_module, "_ENGINE_CACHE", {"cpu": _TimedEngine()})
    runs = {}
    try:
        for package in APPS:
            tmp = tmp_path / package
            service = _service(package, str(tmp / "data"))
            service._build_extractor = lambda **kw: FakeExtractor()
            with ServiceThread(service) as srv:
                runs[package] = _scripted(srv.base, service, str(tmp))
                assert wait_jobs_idle(service, 30)
    finally:
        ollama.shutdown()
    assert len(runs["torch"]) == len(runs["jax"])
    for got, want in zip(runs["torch"], runs["jax"]):
        if got[1] == "/api/metrics":
            got[3]["uptime_s"] = want[3]["uptime_s"]
        assert got == want
    statuses = {(m, p): s for m, p, s, _ in runs["torch"]}
    assert statuses[("GET", "/api/models")] == 200 and statuses[("POST", "/api/test_model")] == 502
    assert sorted(map(json.dumps, ours.requests)) == sorted(map(json.dumps, theirs.requests))


# ---------------------------------------------------------------------------
# The real extractor, the warm-up, FAST_SINGLE, the static files
# ---------------------------------------------------------------------------


def test_service_route_matches_jax_at_416x320(tmp_path, monkeypatch):
    """The port's service on the CPU with the real extractor (its shared
    engine float32 on one 416x320 canvas, in ``BatchingOCR``): ``books/1``
    on the heuristic and the ollama backend, each job's metadata, trace
    steps and LLM request equal to the JAX service's recorded run (the
    OCR'd photos' JPEGs aside: the two chains differ on a few pixels)."""
    for key in [k for k in os.environ if k.startswith("BB_OCR_")]:
        monkeypatch.delenv(key)
    with open(SMALL_ROUTE) as f:
        ref = json.load(f)
    config = EngineConfig(canvases=(CanvasSpec(*ref["canvas"]),), compute_dtype=torch.float32)
    from_checkpoint = OCREngine.from_checkpoint.__func__
    monkeypatch.setattr(OCREngine, "from_checkpoint", classmethod(
        lambda cls, craft, crnn, *_, **kw: from_checkpoint(cls, craft, crnn, config, **kw)))
    monkeypatch.setattr(port_extractor_module, "_ENGINE_CACHE", {})
    session = CannedSession(LLM_REPLIES, LLM_MODELS["gemini"])
    service = _service("torch", str(tmp_path), session=session)
    try:
        with ServiceThread(service) as srv:
            records, jobs = server_jobs(srv.base, session, ref["books"], ref["backends"])
            assert wait_jobs_idle(service, 30)
    finally:
        for engine in port_extractor_module._ENGINE_CACHE.values():
            engine.close()
    for backend in ref["backends"]:
        for book in ref["books"]:
            job = jobs[backend][book]
            assert job["statuses"][-1] == "done" and job["trace_frames"] > 0
            assert not [line for line in job["logs"] if "OCR failed" in line]
            bad = job_differences(records[backend][book], ref["runs"][backend][book])
            assert not bad, (backend, book, bad, records[backend][book]["meta"])


def test_service_pricing_matches_recorded_jax(tmp_path, monkeypatch, capsys):
    """The port's review and pricing requests, and ``cli/pricing.py
    --from-json <accepted> --select``, through the canned clients, equal
    the JAX outputs recorded in ``tests/data/pricing_jax.json``."""
    from bbocr_tpu_torch.cli import pricing as port_cli

    with open(PRICING) as f:
        ref = json.load(f)
    http = CannedHttp(ref["google_payload"], {kn: ref["pages"][name] for kn, name in ref["lookup_pages"].items()})
    monkeypatch.setattr(port_gb, "_async_client", http)
    monkeypatch.setattr(port_abe, "_async_client", http)
    monkeypatch.delenv("GOOGLE_BOOKS_API_KEY", raising=False)
    service = _service("torch", str(tmp_path))
    with ServiceThread(service) as srv:
        flow = pricing_flow(srv.base, ref["accepted"], str(tmp_path))
    assert flow == ref["service"]
    capsys.readouterr()
    port_cli.main(["--from-json", os.path.join(service.accepted_dir, "book_1_ollama.json"), "--select"])
    assert json.loads(capsys.readouterr().out) == ref["cli"]
    assert sorted(map(json.dumps, http.requests)) == sorted(map(json.dumps, ref["requests"]))


class _RecordingEngine:
    def __init__(self):
        self.calls = []

    def readtext_batch(self, images):
        self.calls.append(("readtext_batch", [tuple(np.shape(im)) for im in images]))
        return [[(np.float32([[10, 10], [200, 10], [200, 40], [10, 40]]), "The Title", 0.9)] for _ in images]

    def readtext_fast(self, image):
        self.calls.append(("readtext_fast", tuple(image.shape)))
        return []

    def warmup(self):
        self.calls.append(("warmup",))
        return 1

    def timings(self):
        return {}


def test_fast_single_takes_the_wrapped_route_in_both(tmp_path, monkeypatch):
    """``BB_OCR_FAST_SINGLE=1`` passes ``fast_single=True`` to the jobs'
    extractor in both packages, and both still read a small upright photo
    through the wrapped shared engine, which has no fast path (ROADMAP
    Queue 3: a question about the reference, reproduced)."""
    monkeypatch.setenv("BB_OCR_FAST_SINGLE", "1")
    ours, ref = _RecordingEngine(), _RecordingEngine()
    wrappers = [BatchingOCR(ours), JaxBatchingOCR(ref)]
    monkeypatch.setattr(port_extractor_module, "_ENGINE_CACHE", {"cpu": wrappers[0]})
    monkeypatch.setattr(jax_extractor_module, "_ENGINE_CACHE", {"engine": wrappers[1]})
    image = np.random.default_rng(0).integers(0, 256, (600, 450)).astype(np.float32)
    knobs = dict(model="m", ocr_engine="easyocr", use_preprocessing=False, edge_crop=0.0, auto_crop=False,
                 llm_backend="heuristic")
    try:
        got = [_service(p, str(tmp_path / p))._build_extractor(**knobs) for p in ("torch", "jax")]
        assert [e.fast_single for e in got] == [True, True] and [e.ocr_engine for e in got] == ["tpu", "tpu"]
        texts = [e._ocr_text(image, 0)[:2] for e in got]
    finally:
        for w in wrappers:
            w.close()
    assert texts[0] == texts[1]
    assert ours.calls == ref.calls == [("readtext_batch", [(600, 450)])]


def test_engine_warmup_runs_in_both(tmp_path, monkeypatch):
    """``BB_OCR_ENGINE_WARMUP=1``: the service's daemon thread runs the
    shared engine's ``warmup`` once, unwrapped, in both packages."""
    monkeypatch.setenv("BB_OCR_ENGINE_WARMUP", "1")
    ours, ref = _RecordingEngine(), _RecordingEngine()
    wrappers = [BatchingOCR(ours), JaxBatchingOCR(ref)]
    monkeypatch.setattr(port_extractor_module, "_ENGINE_CACHE", {"cpu": wrappers[0]})
    monkeypatch.setattr(jax_extractor_module, "_ENGINE_CACHE", {"engine": wrappers[1]})
    try:
        for package in ("torch", "jax"):
            _service(package, str(tmp_path / package))
        t0 = time.time()
        while (not ours.calls or not ref.calls) and time.time() - t0 < 10:
            time.sleep(0.01)
    finally:
        for w in wrappers:
            w.close()
    assert ours.calls == ref.calls == [("warmup",)]


def test_ollama_calls_use_the_session_passed_in(tmp_path):
    """With a session passed in, the model list and the model test go
    through it (no ``requests``)."""
    calls = []

    class Reply:
        status_code, text = 200, ""

        def __init__(self, payload):
            self.payload = payload

        def json(self):
            return self.payload

    class Session:
        def get(self, url, timeout=None):
            calls.append(("get", url, timeout))
            return Reply({"models": [{"name": "x:1"}]})

        def post(self, url, json=None, timeout=None, headers=None):
            calls.append(("post", url, json, timeout))
            return Reply({"response": "pong"})

    service = _service("torch", str(tmp_path), session=Session())
    with ServiceThread(service) as srv:
        assert _get(srv.base, "/api/models") == (200, {"models": ["x:1"]})
        status, body = _post(srv.base, "/api/test_model", {"backend": "ollama", "model": "m:1"})
    assert status == 200 and body["detail"] == "pong" and body["ok"] is True
    url = service.ollama_base_url
    assert calls == [("get", f"{url}/api/tags", 3),
                     ("post", f"{url}/api/generate", {"model": "m:1", "prompt": "ping", "stream": False}, (2.5, 6.0))]


def test_static_files_are_byte_equal_to_jax():
    def files(root):
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
        return out

    ours, ref = files(port_app.STATIC_DIR), files(jax_app.STATIC_DIR)
    assert ours == ref and len(ref) == 6


def test_standalone_pricing_app_matches_jax(tmp_path, monkeypatch):
    """``server/pricing_app.py``: the same requests to both packages'
    standalone pricing servers give equal status codes and bodies (status,
    UI, providers, the processed list and its path allowlist, a lookup
    through canned clients, a static file)."""
    import types

    from bbocr_tpu.server import pricing_app as jax_pricing_app
    from bbocr_tpu_torch.server import pricing_app as port_pricing_app

    with open(PRICING) as f:
        ref = json.load(f)
    pages = {"The Sea John Banville 2005": ref["pages"]["synthetic_2"]}
    ours, theirs = CannedHttp(ref["google_payload"], pages), CannedHttp(ref["google_payload"], pages)
    monkeypatch.setattr(port_gb, "_async_client", ours)
    monkeypatch.setattr(port_abe, "_async_client", ours)
    monkeypatch.setattr("httpx.AsyncClient", theirs)
    runs = {}
    for name, module in (("jax", jax_pricing_app), ("torch", port_pricing_app)):
        out_dir = tmp_path / name / "output"
        out_dir.mkdir(parents=True)
        (out_dir / "book_1_enhanced.json").write_text(json.dumps({"title": "The Sea", "year": "2005"}))
        root, calls = str(tmp_path / name), []
        app = module.create_pricing_app([str(out_dir)])
        with ServiceThread(types.SimpleNamespace(app=app)) as srv:
            for method, path, payload in [
                ("GET", "/", None), ("GET", "/ui", None), ("GET", "/providers", None),
                ("GET", "/processed/list", None),
                ("GET", f"/processed/load?path={out_dir / 'book_1_enhanced.json'}", None),
                ("GET", "/processed/load?path=/etc/passwd", None), ("GET", "/static/pricing.js", None),
                ("POST", "/lookup", {"title": "The Sea", "authors": "John Banville", "publication_date": "2005",
                                     "providers": ["abebooks", "google_books"]}),
            ]:
                status, body = http_json(srv.base, method, path, payload)
                calls.append((method, masked(path, root), status, masked(body, root)))
        runs[name] = calls
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][-1][3]["offers"] and runs["torch"][3][3]["items"][0]["label"] == "book_1_enhanced.json"
    assert sorted(map(json.dumps, ours.requests)) == sorted(map(json.dumps, theirs.requests))


def _fake_gspread(monkeypatch, header, rows):
    """``gspread`` and ``google.oauth2.service_account`` stand-ins: one
    worksheet whose first row is ``header``; appended rows go to ``rows``."""
    import sys
    import types

    class Worksheet:
        title = "Sheet1"

        def row_values(self, i):
            return list(header)

        def append_row(self, row):
            rows.append(row)

    class Book:
        def worksheet(self, name):
            return Worksheet()

    class Credentials:
        @staticmethod
        def from_service_account_info(info, scopes):
            return ("info", tuple(scopes))

    gspread = types.ModuleType("gspread")
    gspread.authorize = lambda creds: types.SimpleNamespace(open_by_key=lambda key: Book())
    account = types.ModuleType("google.oauth2.service_account")
    account.Credentials = Credentials
    monkeypatch.setitem(sys.modules, "gspread", gspread)
    monkeypatch.setitem(sys.modules, "google.oauth2", types.ModuleType("google.oauth2"))
    monkeypatch.setitem(sys.modules, "google.oauth2.service_account", account)


@pytest.mark.parametrize("configured,header", [(False, []), (True, []), (True, None)],
                         ids=["unconfigured", "audit", "table8"])
def test_sheets_match_jax(monkeypatch, configured, header):
    """``server/sheets.py``: ``append_row`` (both row formats),
    ``is_configured`` and ``connectivity`` as the JAX module's, through
    stand-ins of the Google client libraries, and what both return when
    nothing is configured."""
    from bbocr_tpu.server import sheets as jax_sheets
    from bbocr_tpu_torch.server import sheets as port_sheets

    header = jax_sheets.TABLE8_HEADER if header is None else header
    rows = []
    if configured:
        _fake_gspread(monkeypatch, header, rows)
        monkeypatch.setenv("GOOGLE_SHEETS_CREDENTIALS_JSON", '{"type": "service_account"}')
        monkeypatch.setenv("GOOGLE_SHEETS_SPREADSHEET_ID", "sheet-id")
    else:
        monkeypatch.delenv("GOOGLE_SHEETS_CREDENTIALS_JSON", raising=False)
    calls = [
        dict(stage="scanner", action="approved", id="b1", source_path="/x/b1.json", comment="ok",
             metadata={"title": "T", "authors": ["A", None, "B"], "isbn_13": "978", "publication_date": "2005-01"}),
        dict(stage="pricing", action="rejected", id="b2", comment=None, metadata={"authors": "Solo", "year": 1999},
             offer={"provider": "abebooks", "amount": 4.5, "currency": "USD", "url": "u"}),
        dict(stage="pricing", action="approved", offer={"amount": "n/a"}),
    ]
    got = {}
    for name, module in (("jax", jax_sheets), ("torch", port_sheets)):
        for var in ("_client", "_sheet", "_last_error"):
            monkeypatch.setattr(module, var, None)
        rows.clear()
        results = [module.append_row(**c) for c in calls]
        audit = header != jax_sheets.TABLE8_HEADER  # an audit row starts with its time
        got[name] = (results, [r[1:] if audit else r for r in rows], module.is_configured(), module.connectivity(),
                     module._last_error)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0]["ok"] is configured
