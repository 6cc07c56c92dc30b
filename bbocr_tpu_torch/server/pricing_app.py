"""Standalone pricing server (alternative deployment, reference L8:
``pipeline_demo/pricing_api/app/main.py``, port 8099): status, /ui,
/providers, /lookup, /processed/list, /processed/load with a path
allowlist. Reuses the scanner service's pricing handlers.

Counterpart of ``bbocr_tpu/server/pricing_app.py``, with the same routes
and JSON; no device work runs here.

    python -m bbocr_tpu_torch.server.pricing_app [--port 8099]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from bbocr_tpu_torch.server.http import App, Request, Response

PRICING_STATIC_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "static", "pricing"
)


def create_pricing_app(processed_dirs: Optional[List[str]] = None) -> App:
    app = App()
    dirs = processed_dirs or [
        os.path.join(os.getcwd(), "output"),
        os.path.join(os.getcwd(), "batch_output"),
        os.path.join(os.getcwd(), "data", "accepted"),
    ]
    app.static("/static", PRICING_STATIC_DIR)

    def allowed(path: str) -> bool:
        rp = os.path.abspath(path)
        for base in dirs:
            ab = os.path.abspath(base)
            if rp == ab or rp.startswith(ab + os.sep):
                return True
        return False

    @app.route("/")
    async def status(req: Request):
        from bbocr_tpu_torch.pricing.aggregator import DEFAULT_PROVIDERS

        return {"service": "bbocr-pricing", "status": "ok", "providers": list(DEFAULT_PROVIDERS)}

    @app.route("/ui")
    async def ui(req: Request):
        return Response.file(os.path.join(PRICING_STATIC_DIR, "index.html"))

    @app.route("/providers")
    async def providers(req: Request):
        from bbocr_tpu_torch.pricing.aggregator import DEFAULT_PROVIDERS

        return {"providers": list(DEFAULT_PROVIDERS)}

    @app.route("/processed/list")
    async def processed_list(req: Request):
        items = []
        for base in dirs:
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
        return {"items": items}

    @app.route("/processed/load")
    async def processed_load(req: Request):
        path = req.query.get("path", "")
        if not allowed(path):
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

    @app.route("/lookup", methods=("POST",))
    async def lookup(req: Request):
        from bbocr_tpu_torch.pricing import aggregate_offers
        from bbocr_tpu_torch.pricing.aggregator import DEFAULT_PROVIDERS

        payload = req.json()
        authors = payload.get("authors")
        if isinstance(authors, str):
            authors = [authors]
        providers = payload.get("providers")
        offers, errors = await aggregate_offers(
            title=payload.get("title"),
            authors=[str(a) for a in authors or [] if a is not None],
            isbn_13=payload.get("isbn_13"),
            isbn_10=payload.get("isbn_10"),
            publisher=payload.get("publisher"),
            publication_date=payload.get("publication_date"),
            providers=[str(p) for p in providers if p is not None] if providers else None,
        )
        return {
            "query": payload,
            "providers": providers or list(DEFAULT_PROVIDERS),
            "offers": offers,
            "errors": errors,
        }

    return app


def main(argv=None):
    p = argparse.ArgumentParser(description="bbocr_tpu_torch standalone pricing server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8099)
    args = p.parse_args(argv)
    create_pricing_app().run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
