"""Scanner web service: the reference's i2j_ui API surface on the port.

Endpoint-compatible with ``pipeline_demo/i2j_ui/app/main.py`` (SURVEY.md
§2.6): process jobs with SSE trace/log/status streams + poll fallbacks,
accept/reject review, pricing embed + finalize, transfer-key handoff,
Google Sheets audit logging, health/model endpoints. Runs on the
framework's own asyncio HTTP server (no FastAPI in this stack); the
extraction engine and pricing aggregator are imported in-process, matching
the reference's "no second server" deployment (``i2j_ui/README.md:47-48``).

Counterpart of ``bbocr_tpu/server/app.py``, with its routes, JSON shapes and
status codes. Jobs run the port's ``BookMetadataExtractor`` on ``device``
(the card by default): with no engine passed in it takes the process-wide
shared engine of that device in ``BatchingOCR``, and each OCR'd photo is
preprocessed by the CUDA kernels. Every Ollama call of the service (model
list, model test, warm-up) goes through ``session``, the HTTP session the
LLM backends take (anything with ``get`` and ``post`` as ``requests``
has them); without one, a ``requests.Session`` is made on first use, so
``requests`` is needed only then. The pricing endpoints need ``httpx``
only when a provider reaches the network.

    python -m bbocr_tpu_torch.server [--device cuda] [--port 8000]
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional

from bbocr_tpu_torch.server import sheets
from bbocr_tpu_torch.server.http import App, Request, Response, SSEResponse, sse_format
from bbocr_tpu_torch.server.jobs import JobManager, TransferStore

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")
PRICING_STATIC_DIR = os.path.join(STATIC_DIR, "pricing")

DEFAULT_MODELS = ["gemma3:4b", "llava:13b", "llava:7b", "llava-phi3", "moondream"]

_SSE_RETRY_MS = 2000
_SSE_POLL_S = 0.3
_SSE_HEARTBEAT_S = 10.0


def _slugify(s: str) -> str:
    out = re.sub(r"\s+", " ", str(s or "").strip().lower())
    out = re.sub(r"[^a-z0-9 _.-]+", "", out)
    out = out.replace(" ", "_")
    out = re.sub(r"_+", "_", out).strip("._-")
    return out[:80]


def _default_ocr_indices(n: int) -> List[int]:
    # UI variant includes the single-image case (reference ``main.py:703-711``)
    if n >= 3:
        return [1, 2]
    if n == 2:
        return [1]
    if n == 1:
        return [0]
    return []


def validate_backend_model(backend: str, model: str) -> Optional[str]:
    """Reject obviously-incompatible backend/model combos
    (reference ``main.py:399-423``)."""
    b = (backend or "").strip().lower()
    m = (model or "").strip()
    if b == "gemini":
        if ":" in m or m.lower().startswith(("gemma", "llava", "moondream", "gpt", "openai")):
            return (
                "Invalid model for Gemini. Use a Gemini model name, e.g. "
                "'gemini-2.5-flash' or 'gemini-2.5-pro'. Currently using: " + m
            )
    if b in ("openai", "gpt", "gpt-4", "gpt-4o", "gpt-4o-mini"):
        if ":" in m or m.lower().startswith(("gemma", "llava", "moondream", "gemini")):
            return (
                "Invalid model for OpenAI. Use an OpenAI model name, e.g. "
                "'gpt-4o-mini' or 'gpt-4o'. Currently using: " + m
            )
    return None


class ScannerService:
    """Holds state + wiring; ``.app`` is the routed HTTP application."""

    def __init__(
        self,
        data_dir: Optional[str] = None,
        books_dir: Optional[str] = None,
        device="cuda",
        session: Optional[Any] = None,
    ):
        root = data_dir or os.path.join(os.getcwd(), "data")
        self.accepted_dir = os.path.join(root, "accepted")
        self.rejected_dir = os.path.join(root, "rejected")
        self.priced_dir = os.path.join(root, "accepted", "priced")
        self.pricing_rejected_dir = os.path.join(root, "rejected", "pricing")
        for d in (self.accepted_dir, self.rejected_dir, self.priced_dir, self.pricing_rejected_dir):
            os.makedirs(d, exist_ok=True)
        self.output_dir = os.path.join(root, "output")
        os.makedirs(self.output_dir, exist_ok=True)
        self.books_dir = books_dir or os.environ.get("BB_OCR_BOOKS_DIR") or os.path.join(os.getcwd(), "books")

        self.device = device
        self._session = session
        self.jobs = JobManager(max_concurrent=1)
        self.transfers = TransferStore()
        self.import_error: Optional[str] = None
        self.pricing_error: Optional[str] = None
        try:  # degrade endpoints rather than crash startup (reference :42-56)
            from bbocr_tpu_torch.extract import BookMetadataExtractor  # noqa: F401
        except Exception as e:
            self.import_error = str(e)
        try:
            from bbocr_tpu_torch.pricing import aggregate_offers  # noqa: F401
        except Exception as e:
            self.pricing_error = str(e)

        self.ollama_base_url = os.environ.get("BB_OCR_OLLAMA_URL", "http://127.0.0.1:11434")
        # local Ollama must not route through proxies (reference main.py:74-78)
        no_proxy = os.environ.get("NO_PROXY", "")
        for host in ("127.0.0.1", "localhost"):
            if host not in no_proxy:
                no_proxy = f"{no_proxy},{host}" if no_proxy else host
        os.environ["NO_PROXY"] = no_proxy
        self.started_at = time.time()
        self.app = App()
        self._register_routes()
        self._maybe_warm_ollama()
        self._maybe_warm_engine()

    @property
    def session(self):
        """The HTTP session of the service's Ollama calls and its jobs' LLM
        backends, made on first use when none was passed in."""
        if self._session is None:
            from bbocr_tpu_torch.extract.extractor import _new_http_session

            self._session = _new_http_session()
        return self._session

    def _maybe_warm_ollama(self) -> None:
        """Opt-in startup model warm-up (reference BB_OCR_OLLAMA_WARMUP,
        main.py:425-439), in a daemon thread so startup never blocks."""
        from bbocr_tpu_torch.utils.env import env_flag

        if not env_flag("BB_OCR_OLLAMA_WARMUP"):
            return

        def warm():
            session = self.session

            try:
                session.post(
                    f"{self.ollama_base_url}/api/generate",
                    json={"model": os.environ.get("BB_OCR_WARM_MODEL", "gemma3:4b"),
                          "prompt": "ping", "stream": False},
                    timeout=(5, 30),
                )
            except Exception:
                pass

        import threading

        threading.Thread(target=warm, daemon=True).start()

    def _maybe_warm_engine(self) -> None:
        """Opt-in OCR-engine warm-up (BB_OCR_ENGINE_WARMUP=1): the shared
        engine's ``warmup()`` runs the serving canvas menu once in a daemon
        thread at startup, so the first request does not pay each canvas's
        first call; the analog of the reference's Ollama warm-up. As in the
        JAX service, a failure there is ignored."""
        from bbocr_tpu_torch.utils.env import env_flag

        if not env_flag("BB_OCR_ENGINE_WARMUP"):
            return

        def warm():
            try:
                from bbocr_tpu_torch.extract.extractor import _shared_engine

                engine = _shared_engine(self.device)
                inner = getattr(engine, "engine", engine)  # unwrap BatchingOCR
                if hasattr(inner, "warmup"):
                    inner.warmup()
            except Exception:
                pass

        import threading

        threading.Thread(target=warm, daemon=True).start()

    # ------------------------------------------------------------------
    # extraction jobs
    # ------------------------------------------------------------------

    def _build_extractor(self, *, model, ocr_engine, use_preprocessing, edge_crop, auto_crop, llm_backend):
        from bbocr_tpu_torch.extract import BookMetadataExtractor
        from bbocr_tpu_torch.utils.env import env_flag

        engine = (ocr_engine or "tpu").lower()
        if engine == "easyocr":  # compat alias: the CRAFT + CRNN engine replaces EasyOCR
            engine = "tpu"
        return BookMetadataExtractor(
            model=model,
            ocr_engine=engine,
            use_preprocessing=use_preprocessing,
            crop_for_ocr=auto_crop,
            warm_model=False,
            edge_crop_percent=float(edge_crop),
            ollama_timeout_seconds=180.0,
            llm_backend=str(llm_backend or "ollama"),
            ollama_base_url=self.ollama_base_url,
            # BB_OCR_FAST_SINGLE=1 forces every request through the
            # single-dispatch OCR program; unset keeps the extractor's
            # per-image auto policy (fast for upright webcam captures).
            fast_single=True if env_flag("BB_OCR_FAST_SINGLE") else None,
            device=self.device,
            session=self._session,
        )

    def _start_job(self, job_id: str, image_paths: List[str], params: Dict[str, Any]) -> None:
        files = [os.path.basename(p) for p in image_paths]
        self.jobs.reset_streams(job_id)

        def work():
            extractor = self._build_extractor(
                model=params["model"],
                ocr_engine=params["ocr_engine"],
                use_preprocessing=params["use_preprocessing"],
                edge_crop=params["edge_crop"],
                auto_crop=params["crop_ocr"],
                llm_backend=params["llm_backend"],
            )
            ocr_indices = (
                _default_ocr_indices(len(image_paths)) if params["run_ocr"] else []
            )
            metadata = extractor.extract_metadata_from_images(
                image_paths,
                ocr_image_indices=ocr_indices,
                capture_trace=True,
                trace_sink=lambda tr: self.jobs.push_trace(job_id, tr),
            )
            # Example jobs persist their output for has_output / "Load
            # Output" replay (reference ``main.py:850-860,921-933``).
            if job_id.startswith("example_"):
                name = job_id[len("example_"):]
                out_path = os.path.join(self.output_dir, f"book_{name}_enhanced.json")
                slim = {k: v for k, v in metadata.items() if k != "_trace"}
                with open(out_path, "w", encoding="utf-8") as f:
                    json.dump(slim, f, indent=2, ensure_ascii=False)
            return metadata

        self.jobs.submit(job_id, work, files)

    @staticmethod
    def _job_params(form: Dict[str, Any]) -> Dict[str, Any]:
        def truthy(v, default=False):
            if v is None:
                return default
            return str(v).strip().lower() in ("1", "true", "yes", "on")

        return {
            "model": form.get("model", "gemma3:4b"),
            "ocr_engine": form.get("ocr_engine", "tpu"),
            "run_ocr": truthy(form.get("run_ocr"), False),
            "use_preprocessing": truthy(form.get("use_preprocessing"), True),
            "edge_crop": float(form.get("edge_crop", 0.0) or 0.0),
            "crop_ocr": truthy(form.get("crop_ocr"), False),
            "llm_backend": form.get("llm_backend", "ollama"),
        }

    # ------------------------------------------------------------------
    # SSE helpers
    # ------------------------------------------------------------------

    def _sse_stream(self, job_id: str, kind: str):
        jobs = self.jobs

        async def gen():
            yield sse_format({"type": "hello", "id": job_id}, retry_ms=_SSE_RETRY_MS)
            if kind == "status" and jobs.get(job_id) is None:
                # Unknown job: the status loop below would otherwise hold the
                # connection open forever waiting for a done/error item.
                yield sse_format({"type": "error", "error": "unknown job", "id": job_id})
                return
            seq = 0
            last_beat = time.time()
            while True:
                if kind == "trace":
                    items = jobs.traces_after(job_id, seq)
                elif kind == "log":
                    items = jobs.logs_after(job_id, seq)
                else:
                    items = jobs.statuses_after(job_id, seq)
                for item in items:
                    seq = item["seq"]
                    yield sse_format(item)
                    last_beat = time.time()
                if kind == "status" and items and items[-1].get("status") in ("done", "error"):
                    return
                if kind != "status" and not jobs.is_active(job_id) and not items:
                    # deliver a final frame then exit so clients close cleanly
                    job = jobs.get(job_id)
                    if job is not None:
                        yield sse_format({"type": "end", "status": job["status"]})
                    return
                if time.time() - last_beat > _SSE_HEARTBEAT_S:
                    yield sse_format({"type": "ping"})
                    last_beat = time.time()
                await asyncio.sleep(_SSE_POLL_S)

        return SSEResponse(gen())

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _register_routes(self) -> None:
        app = self.app
        app.static("/static", STATIC_DIR)
        app.static("/pricing_static", PRICING_STATIC_DIR)

        @app.route("/")
        async def index(req: Request):
            return Response.file(os.path.join(STATIC_DIR, "index.html"))

        @app.route("/api/health")
        async def health(req: Request):
            return {
                "status": "ok",
                "pipeline_imported": self.import_error is None,
                "pipeline_import_error": self.import_error,
                "pricing_available": self.pricing_error is None,
                "google_sheets_configured": bool(sheets.is_configured()),
            }

        @app.route("/api/metrics")
        async def metrics(req: Request):
            """Operational metrics: job counts + engine stage timers."""
            with self.jobs._lock:
                counts: Dict[str, int] = {}
                for job in self.jobs.jobs.values():
                    counts[job["status"]] = counts.get(job["status"], 0) + 1
            engine_timings = {}
            try:
                import torch

                from bbocr_tpu_torch.extract.extractor import _ENGINE_CACHE

                eng = _ENGINE_CACHE.get(str(torch.device(self.device)))
                if eng is not None and hasattr(eng, "timings"):
                    engine_timings = eng.timings()
            except Exception:
                pass
            return {
                "uptime_s": round(time.time() - self.started_at, 1),
                "jobs": counts,
                "engine_timings": engine_timings,
            }

        @app.route("/api/models")
        async def models(req: Request):
            session = self.session

            try:
                resp = session.get(f"{self.ollama_base_url}/api/tags", timeout=3)
                if resp.status_code == 200:
                    names = [m.get("name") for m in resp.json().get("models", []) if m.get("name")]
                    return {"models": names}
                return Response.json({"error": f"ollama tags status {resp.status_code}"}, 502)
            except Exception:
                return {"models": list(DEFAULT_MODELS)}

        @app.route("/api/test_model", methods=("POST",))
        async def test_model(req: Request):
            session = self.session

            payload = req.json()
            backend = (payload.get("backend") or "ollama").lower()
            model = (payload.get("model") or "").strip()
            bad = validate_backend_model(backend, model)
            if bad:
                return Response.json({"ok": False, "backend": backend, "model": model, "error": bad}, 400)
            try:
                if backend == "ollama":
                    resp = session.post(
                        f"{self.ollama_base_url}/api/generate",
                        json={"model": model or "gemma3:4b", "prompt": "ping", "stream": False},
                        timeout=(2.5, 6.0),
                    )
                    ok = resp.status_code == 200
                    return {
                        "ok": ok,
                        "backend": backend,
                        "model": model or "gemma3:4b",
                        "status": resp.status_code,
                        "prompt": "ping",
                        "detail": (resp.json().get("response", "") if ok else resp.text[:200]),
                    }
                from bbocr_tpu_torch.llm import create_llm_client

                client = create_llm_client(backend, session=session)
                out = client.generate(model, "ping", [], timeout_seconds=12.0)
                return {"ok": True, "backend": backend, "model": model, "prompt": "ping", "detail": str(out)[:200]}
            except Exception as e:
                return Response.json(
                    {"ok": False, "backend": backend, "model": model, "prompt": "ping", "error": str(e)[:300]},
                    502,
                )

        # -------------------------- process endpoints ------------------

        @app.route("/api/process_image", methods=("POST",))
        async def process_image(req: Request):
            return await self._handle_process(req, single=True)

        @app.route("/api/process_images", methods=("POST",))
        async def process_images(req: Request):
            return await self._handle_process(req, single=False)

        @app.route("/api/examples")
        async def examples(req: Request):
            return {"examples": self._list_examples()}

        @app.route("/api/process_example", methods=("POST",))
        async def process_example(req: Request):
            payload = req.json()
            name = payload.get("name") or ""
            entry = next((e for e in self._list_examples() if e["name"] == name), None)
            if entry is None:
                return Response.json({"error": f"unknown example: {name}"}, 404)
            job_id = f"example_{_slugify(name)}"
            if self.jobs.is_active(job_id):  # duplicate-guard (reference :892-895)
                return Response.json({"error": "example job already running", "id": job_id}, 409)
            params = self._job_params(payload)
            params["run_ocr"] = True
            bad = validate_backend_model(params["llm_backend"], params["model"])
            if bad:
                return Response.json({"error": bad}, 400)
            self._start_job(job_id, entry["paths"], params)
            return {"id": job_id, "files": [os.path.basename(p) for p in entry["paths"]], "status": "started"}

        @app.route("/api/example_output")
        async def example_output(req: Request):
            name = req.query.get("name", "")
            out_path = os.path.join(self.output_dir, f"book_{_slugify(name)}_enhanced.json")
            if not os.path.isfile(out_path):
                return Response.json({"error": "no saved output"}, 404)
            with open(out_path, "r", encoding="utf-8") as f:
                return {"name": name, "metadata": json.load(f)}

        # --------------------------- job streams ------------------------

        @app.route("/api/job_status")
        async def job_status(req: Request):
            job = self.jobs.get(req.query.get("id", ""))
            if job is None:
                return Response.json({"error": "unknown job"}, 404)
            return job

        @app.route("/api/job_result")
        async def job_result(req: Request):
            job = self.jobs.get(req.query.get("id", ""))
            if job is None:
                return Response.json({"error": "unknown job"}, 404)
            if job["status"] in ("queued", "running"):
                return Response.json({"status": job["status"]}, 202)
            return job

        @app.route("/api/job_stream")
        async def job_stream(req: Request):
            return self._sse_stream(req.query.get("id", ""), "status")

        @app.route("/api/trace_stream")
        async def trace_stream(req: Request):
            return self._sse_stream(req.query.get("id", ""), "trace")

        @app.route("/api/log_stream")
        async def log_stream(req: Request):
            return self._sse_stream(req.query.get("id", ""), "log")

        @app.route("/api/trace_poll")
        async def trace_poll(req: Request):
            job_id = req.query.get("id", "")
            after = int(req.query.get("after", 0) or 0)
            return {"items": self.jobs.traces_after(job_id, after, limit=100)}

        @app.route("/api/log_poll")
        async def log_poll(req: Request):
            job_id = req.query.get("id", "")
            after = int(req.query.get("after", 0) or 0)
            return {"items": self.jobs.logs_after(job_id, after, limit=100)}

        # ------------------------ review workflow -----------------------

        @app.route("/api/accept", methods=("POST",))
        async def accept(req: Request):
            payload = req.json()
            # Slugify the client-supplied id: a raw join would let
            # "../../x" or an absolute path escape the accepted dir.
            item_id = _slugify(str(payload.get("id") or "")) or f"item_{int(time.time() * 1000)}"
            metadata = payload.get("metadata") or {}
            out_path = os.path.join(self.accepted_dir, f"{item_id}.json")
            with open(out_path, "w", encoding="utf-8") as f:
                json.dump(metadata, f, indent=2, ensure_ascii=False)
            try:
                sheets_res = sheets.append_row(
                    stage="scanner", action="approved", id=item_id,
                    source_path=out_path, comment=payload.get("notes"),
                    metadata=metadata,
                )
            except Exception as e:
                sheets_res = {"ok": False, "error": str(e)}
            transfer_key = self.transfers.put({"id": item_id, "metadata": metadata})
            return {"status": "saved", "path": out_path, "transfer_key": transfer_key, "sheets": sheets_res}

        @app.route("/api/reject", methods=("POST",))
        async def reject(req: Request):
            payload = req.json()
            item_id = _slugify(str(payload.get("id") or "")) or f"item_{int(time.time() * 1000)}"
            log_path = os.path.join(self.rejected_dir, f"{item_id}.txt")
            with open(log_path, "w", encoding="utf-8") as f:
                f.write(payload.get("reason") or "rejected")
            try:
                sheets_res = sheets.append_row(
                    stage="scanner", action="rejected", id=item_id,
                    source_path=log_path, comment=payload.get("reason"),
                )
            except Exception as e:
                sheets_res = {"ok": False, "error": str(e)}
            return {"status": "rejected", "path": log_path, "sheets": sheets_res}

        @app.route("/api/transfer_get")
        async def transfer_get(req: Request):
            item = self.transfers.get(req.query.get("key", ""))
            if not item:
                return Response.json({"detail": "transfer not found or expired"}, 404)
            return item

        # --------------------------- pricing ----------------------------

        @app.route("/api/pricing/providers")
        async def pricing_providers(req: Request):
            from bbocr_tpu_torch.pricing.aggregator import DEFAULT_PROVIDERS

            return {"providers": list(DEFAULT_PROVIDERS)}

        @app.route("/api/pricing_lookup", methods=("POST",))
        async def pricing_lookup(req: Request):
            return await self._pricing_lookup(req)

        @app.route("/api/pricing/select_best", methods=("POST",))
        async def pricing_select_best(req: Request):
            from bbocr_tpu_torch.pricing.select import merge_offer_into_metadata, select_best_offer

            payload = req.json()
            metadata = payload.get("metadata") or {}
            offers = payload.get("offers") or []
            best, reason = select_best_offer(metadata, offers)
            merged = merge_offer_into_metadata(metadata, best)
            return {"best_offer": best, "reason": reason, "merged": merged}

        @app.route("/api/pricing/processed/list")
        async def processed_list(req: Request):
            return {"items": self._processed_items()}

        @app.route("/api/pricing/processed/load")
        async def processed_load(req: Request):
            path = req.query.get("path", "")
            if not self._allowed_path(path):
                return Response.json({"detail": "Invalid path"}, 400)
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            payload = {
                k: data.get(k)
                for k in ("title", "subtitle", "authors", "publisher", "publication_date", "isbn_13", "isbn_10")
            }
            if payload.get("publication_date") is None:
                payload["publication_date"] = data.get("year")
            return {"path": path, "payload": payload, "raw": data}

        # aliases used by the embedded pricing SPA (absolute paths)
        @app.route("/providers")
        async def providers_alias(req: Request):
            return await pricing_providers(req)

        @app.route("/lookup", methods=("POST",))
        async def lookup_alias(req: Request):
            return await self._pricing_lookup(req)

        @app.route("/processed/list")
        async def processed_list_alias(req: Request):
            return await processed_list(req)

        @app.route("/processed/load")
        async def processed_load_alias(req: Request):
            return await processed_load(req)

        @app.route("/pricing_embed")
        async def pricing_embed(req: Request):
            index_path = os.path.join(PRICING_STATIC_DIR, "index.html")
            if not os.path.isfile(index_path):
                return Response.json({"detail": "pricing index not found"}, 404)
            with open(index_path, "r", encoding="utf-8") as f:
                html = f.read()
            html = html.replace('href="/static/', 'href="/pricing_static/')
            html = html.replace('src="/static/', 'src="/pricing_static/')
            return Response.html(html)

        @app.route("/api/pricing/finalize", methods=("POST",))
        async def pricing_finalize(req: Request):
            payload = req.json()
            decision = (payload.get("decision") or "").strip().lower()
            if decision not in ("approved", "rejected"):
                return Response.json({"detail": "decision must be 'approved' or 'rejected'"}, 400)
            ts = int(time.time() * 1000)
            merged = payload.get("merged") if isinstance(payload.get("merged"), dict) else None
            item_id = self._pricing_item_id(payload.get("id"), merged, ts)
            if decision == "approved":
                out_path = os.path.join(self.priced_dir, f"{item_id}.json")
                with open(out_path, "w", encoding="utf-8") as f:
                    json.dump(merged or {}, f, indent=2, ensure_ascii=False)
                try:
                    sheets_res = sheets.append_row(
                        stage="pricing", action="approved", id=item_id,
                        source_path=out_path, comment=payload.get("comment"),
                        metadata=merged or {}, offer=payload.get("best_offer"),
                    )
                except Exception as e:
                    sheets_res = {"ok": False, "error": str(e)}
                return {"status": "approved", "path": out_path, "sheets": sheets_res}
            rej_path = os.path.join(self.pricing_rejected_dir, f"{item_id}.txt")
            with open(rej_path, "w", encoding="utf-8") as f:
                f.write(payload.get("comment") or "rejected")
            try:
                sheets_res = sheets.append_row(
                    stage="pricing", action="rejected", id=item_id,
                    source_path=rej_path, comment=payload.get("comment"),
                    offer=payload.get("best_offer"),
                )
            except Exception as e:
                sheets_res = {"ok": False, "error": str(e)}
            return {"status": "rejected", "path": rej_path, "sheets": sheets_res}

        @app.route("/api/google_sheets/test")
        async def sheets_test(req: Request):
            try:
                return sheets.connectivity()
            except Exception as e:
                return Response.json({"ok": False, "error": str(e)}, 500)

    # ------------------------------------------------------------------
    # handlers' shared logic
    # ------------------------------------------------------------------

    async def _handle_process(self, req: Request, single: bool):
        files = req.files()
        uploads = files.get("image" if single else "images") or files.get("images") or files.get("image")
        if not uploads:
            return Response.json({"detail": "No images uploaded"}, 400)
        for uf in uploads:
            if not (uf.content_type or "").startswith("image/"):
                return Response.json({"detail": f"File {uf.filename} is not an image"}, 400)
        form = req.form()
        params = self._job_params(form)
        bad = validate_backend_model(params["llm_backend"], params["model"])
        if bad:
            return Response.json({"error": bad}, 400)

        ts = int(time.time() * 1000)
        item_id = f"capture_{ts}" if single else f"batch_{ts}"
        tmp_dir = os.path.join(tempfile.gettempdir(), "bb_ocr_ui_uploads")
        os.makedirs(tmp_dir, exist_ok=True)
        saved = []
        for idx, uf in enumerate(uploads):
            ext = os.path.splitext(uf.filename or f"capture_{idx}.jpg")[1] or ".jpg"
            suffix = ext if single else f"_{idx}{ext}"
            path = os.path.join(tmp_dir, f"{item_id}{suffix}")
            with open(path, "wb") as f:
                f.write(uf.data)
            saved.append(path)
        self._start_job(item_id, saved, params)
        return {"id": item_id, "files": [os.path.basename(p) for p in saved], "status": "started"}

    async def _pricing_lookup(self, req: Request):
        if self.pricing_error is not None:
            return Response.json({"error": "pricing aggregator unavailable"}, 500)
        from bbocr_tpu_torch.pricing import aggregate_offers
        from bbocr_tpu_torch.pricing.aggregator import DEFAULT_PROVIDERS

        payload = req.json()

        def to_str(x):
            return None if x is None else str(x)

        def to_str_list(x):
            if x is None:
                return []
            if isinstance(x, list):
                return [str(i) for i in x if i is not None]
            return [str(x)]

        providers = payload.get("providers")
        safe_providers = [str(p) for p in providers if p is not None] if providers is not None else None
        query = {
            "title": to_str(payload.get("title")),
            "authors": to_str_list(payload.get("authors")),
            "isbn_13": to_str(payload.get("isbn_13")),
            "isbn_10": to_str(payload.get("isbn_10")),
            "publisher": to_str(payload.get("publisher")),
            "publication_date": to_str(payload.get("publication_date")),
        }
        offers, errors = await aggregate_offers(
            **query, providers=safe_providers, timeout_seconds=8.0
        )
        return {
            "query": {**query, "providers": safe_providers},
            "providers": safe_providers or list(DEFAULT_PROVIDERS),
            "offers": offers,
            "errors": errors,
        }

    # ------------------------------------------------------------------
    # misc helpers
    # ------------------------------------------------------------------

    def _list_examples(self) -> List[Dict[str, Any]]:
        out = []
        if os.path.isdir(self.books_dir):
            for name in sorted(os.listdir(self.books_dir)):
                book = os.path.join(self.books_dir, name)
                if not os.path.isdir(book):
                    continue
                paths = [
                    os.path.join(book, f)
                    for f in sorted(os.listdir(book))
                    if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".tiff"))
                ]
                if paths:
                    out_path = os.path.join(self.output_dir, f"book_{_slugify(name)}_enhanced.json")
                    out.append(
                        {
                            "name": name,
                            "paths": paths,
                            "count": len(paths),
                            "has_output": os.path.isfile(out_path),
                        }
                    )
        return out

    def _processed_items(self) -> List[Dict[str, Any]]:
        items = []
        for base in (self.output_dir, self.accepted_dir):
            if not os.path.isdir(base):
                continue
            for name in os.listdir(base):
                if not name.lower().endswith(".json"):
                    continue
                path = os.path.join(base, name)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                items.append(
                    {"label": name, "path": path, "size": st.st_size, "mtime": st.st_mtime, "dir": base}
                )
        items.sort(key=lambda x: x["mtime"], reverse=True)
        return items

    def _allowed_path(self, path: str) -> bool:
        rp = os.path.abspath(path)
        for base in (self.output_dir, self.accepted_dir):
            ab = os.path.abspath(base)
            if rp == ab or rp.startswith(ab + os.sep):
                return True
        return False

    @staticmethod
    def _pricing_item_id(payload_id: Optional[str], merged: Optional[Dict[str, Any]], ts: int) -> str:
        title = merged.get("title") if isinstance(merged, dict) else None
        slug = _slugify(str(title or ""))
        if slug:
            return f"{slug}_{ts}"
        if payload_id:
            return f"{_slugify(payload_id) or payload_id}_{ts}"
        return f"priced_{ts}"


def create_app(
    data_dir: Optional[str] = None, books_dir: Optional[str] = None, device="cuda", session: Optional[Any] = None
) -> ScannerService:
    return ScannerService(data_dir=data_dir, books_dir=books_dir, device=device, session=session)
