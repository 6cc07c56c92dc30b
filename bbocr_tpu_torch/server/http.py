"""Minimal asyncio HTTP/1.1 framework: routing, forms, SSE, static files.

The reference serves its scanner/pricing UIs with FastAPI+uvicorn
(``pipeline_demo/i2j_ui/app/main.py:72``); this image has neither, and the
serving layer of a standalone framework should own its runtime anyway —
so this module implements the slice of HTTP the API surface needs:

- request parsing (headers, Content-Length bodies), keep-alive off,
- urlencoded + multipart/form-data forms (file uploads),
- JSON / text / bytes / file responses with permissive CORS,
- Server-Sent Events via async generators (the trace/log/job streams),
- static directory mounts with content-type guessing.

No external dependencies; plugs into ``asyncio.start_server``.

Copied from ``bbocr_tpu/server/http.py`` (stdlib only).
"""

from __future__ import annotations

import asyncio
import io
import json
import mimetypes
import os
import traceback
import urllib.parse
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

MAX_BODY_BYTES = 64 * 1024 * 1024  # uploads are multi-MB photos

_STATUS_TEXT = {
    200: "OK", 202: "Accepted", 204: "No Content", 302: "Found",
    400: "Bad Request", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 413: "Payload Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class UploadFile:
    def __init__(self, filename: str, content_type: str, data: bytes):
        self.filename = filename
        self.content_type = content_type
        self.data = data


class Request:
    def __init__(
        self,
        method: str,
        target: str,
        headers: Dict[str, str],
        body: bytes,
        oversized: bool = False,
    ):
        self.method = method
        # True when Content-Length exceeded MAX_BODY_BYTES and the body was
        # not read; dispatch answers 413 instead of handing handlers an
        # empty body (which reads as a confusing "no images uploaded" 400).
        self.oversized = oversized
        parsed = urllib.parse.urlsplit(target)
        self.path = parsed.path
        self.query: Dict[str, str] = {
            k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()
        }
        self.headers = headers
        self.body = body
        self._form: Optional[Dict[str, Any]] = None
        self._files: Optional[Dict[str, List[UploadFile]]] = None

    def json(self) -> Any:
        if not self.body:
            return {}
        return json.loads(self.body.decode("utf-8"))

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "")

    def _parse_form(self) -> None:
        if self._form is not None:
            return
        self._form = {}
        self._files = {}
        ctype = self.content_type
        if ctype.startswith("application/x-www-form-urlencoded"):
            for k, v in urllib.parse.parse_qs(self.body.decode("utf-8", "replace")).items():
                self._form[k] = v[0] if len(v) == 1 else v
        elif ctype.startswith("multipart/form-data"):
            boundary = None
            for part in ctype.split(";"):
                part = part.strip()
                if part.startswith("boundary="):
                    boundary = part[len("boundary="):].strip('"')
            if boundary:
                self._parse_multipart(boundary.encode())

    def _parse_multipart(self, boundary: bytes) -> None:
        delim = b"--" + boundary
        segments = self.body.split(delim)
        for seg in segments[1:-1]:
            seg = seg.lstrip(b"\r\n")
            if seg in (b"", b"--", b"--\r\n"):
                continue
            head, _, payload = seg.partition(b"\r\n\r\n")
            payload = payload[:-2] if payload.endswith(b"\r\n") else payload
            disp: Dict[str, str] = {}
            part_ct = "application/octet-stream"
            for line in head.decode("utf-8", "replace").split("\r\n"):
                name, _, value = line.partition(":")
                name = name.strip().lower()
                if name == "content-disposition":
                    for item in value.split(";"):
                        item = item.strip()
                        if "=" in item:
                            k, _, v = item.partition("=")
                            disp[k.strip()] = v.strip().strip('"')
                elif name == "content-type":
                    part_ct = value.strip()
            field = disp.get("name", "")
            if "filename" in disp:
                self._files.setdefault(field, []).append(
                    UploadFile(disp["filename"], part_ct, payload)
                )
            else:
                self._form[field] = payload.decode("utf-8", "replace")

    def form(self) -> Dict[str, Any]:
        self._parse_form()
        return dict(self._form or {})

    def files(self) -> Dict[str, List[UploadFile]]:
        self._parse_form()
        return dict(self._files or {})


class Response:
    def __init__(
        self,
        body: Any = b"",
        status: int = 200,
        content_type: Optional[str] = None,
        headers: Optional[Dict[str, str]] = None,
    ):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode("utf-8")
            content_type = content_type or "application/json"
        elif isinstance(body, str):
            body = body.encode("utf-8")
            content_type = content_type or "text/plain; charset=utf-8"
        self.body: bytes = body
        self.status = status
        self.content_type = content_type or "application/octet-stream"
        self.headers = headers or {}

    @classmethod
    def json(cls, data: Any, status: int = 200) -> "Response":
        return cls(json.dumps(data).encode("utf-8"), status, "application/json")

    @classmethod
    def html(cls, markup: str, status: int = 200) -> "Response":
        return cls(markup.encode("utf-8"), status, "text/html; charset=utf-8")

    @classmethod
    def file(cls, path: str) -> "Response":
        if not os.path.isfile(path):
            return cls.json({"detail": "Not Found"}, 404)
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        with open(path, "rb") as f:
            return cls(f.read(), 200, ctype)


class SSEResponse:
    """Wraps an async generator of already-SSE-formatted strings."""

    def __init__(self, gen: AsyncIterator[str]):
        self.gen = gen


def sse_format(data: Any, event: Optional[str] = None, retry_ms: Optional[int] = None) -> str:
    """Encode one SSE frame (reference ``_sse_format``, ``main.py:183``)."""
    out = []
    if retry_ms is not None:
        out.append(f"retry: {retry_ms}")
    if event:
        out.append(f"event: {event}")
    payload = data if isinstance(data, str) else json.dumps(data)
    for line in payload.splitlines() or [""]:
        out.append(f"data: {line}")
    return "\n".join(out) + "\n\n"


Handler = Callable[[Request], Awaitable[Any]]


class App:
    def __init__(self):
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._static: List[Tuple[str, str, Optional[Dict[str, Tuple[str, str]]]]] = []
        # Live per-connection tasks, so a shutdown can cancel them instead of
        # leaving them to be destroyed with the loop (long-lived SSE streams
        # outlive their request otherwise).
        self._conn_tasks: set = set()

    def route(self, path: str, methods: Tuple[str, ...] = ("GET",)):
        def deco(fn: Handler) -> Handler:
            for m in methods:
                self._routes[(m.upper(), path)] = fn
            return fn

        return deco

    def static(self, prefix: str, directory: str) -> None:
        self._static.append((prefix.rstrip("/"), directory, None))

    def lookup_static(self, path: str) -> Optional[str]:
        for prefix, directory, _ in self._static:
            if path.startswith(prefix + "/"):
                rel = path[len(prefix) + 1 :]
                rel = os.path.normpath(rel)
                if rel.startswith(("..", "/")):
                    return None
                return os.path.join(directory, rel)
        return None

    async def dispatch(self, req: Request) -> Any:
        if req.oversized:
            return Response.json({"detail": "Payload Too Large"}, 413)
        if req.method == "OPTIONS":
            # CORS preflight: the wildcard Allow-* headers are attached to
            # every response in _write_response; a bare 204 completes it.
            return Response(b"", 204)
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            static_path = self.lookup_static(req.path)
            if static_path is not None and req.method == "GET":
                return Response.file(static_path)
            if any(p == req.path for (_, p) in self._routes):
                return Response.json({"detail": "Method Not Allowed"}, 405)
            return Response.json({"detail": "Not Found"}, 404)
        return await handler(req)

    # ------------------------------------------------------------------
    # asyncio server plumbing
    # ------------------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            try:
                result = await self.dispatch(req)
            except Exception:
                traceback.print_exc()
                result = Response.json({"detail": "Internal Server Error"}, 500)
            await self._write_response(writer, req, result)
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        if not lines or " " not in lines[0]:
            return None
        method, target, *_ = lines[0].split(" ")
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY_BYTES:
            return Request(method.upper(), target, headers, b"", oversized=True)
        body = await reader.readexactly(length) if length else b""
        return Request(method.upper(), target, headers, body)

    async def _write_response(self, writer: asyncio.StreamWriter, req: Request, result: Any):
        if isinstance(result, SSEResponse):
            head = (
                "HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                "Connection: close\r\n"
                "Access-Control-Allow-Origin: *\r\n"
                "\r\n"
            )
            writer.write(head.encode())
            await writer.drain()
            try:
                async for chunk in result.gen:
                    writer.write(chunk.encode("utf-8"))
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
            return

        if not isinstance(result, Response):
            result = Response.json(result)
        status_line = f"HTTP/1.1 {result.status} {_STATUS_TEXT.get(result.status, 'OK')}\r\n"
        headers = {
            "Content-Type": result.content_type,
            "Content-Length": str(len(result.body)),
            "Connection": "close",
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Headers": "*",
            "Access-Control-Allow-Methods": "*",
            **result.headers,
        }
        head = status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
        writer.write(head.encode("latin-1") + result.body)
        await writer.drain()

    async def serve(self, host: str = "127.0.0.1", port: int = 8000):
        server = await asyncio.start_server(
            self._handle_conn, host, port, limit=MAX_BODY_BYTES + 65536
        )
        addrs = ", ".join(str(s.getsockname()) for s in server.sockets)
        print(f"bbocr server listening on {addrs}")
        async with server:
            await server.serve_forever()

    async def shutdown(self) -> None:
        """Cancel live connection tasks (SSE streams included) and wait for
        them to unwind — call before stopping the loop that ran :meth:`serve`."""
        tasks = [t for t in self._conn_tasks if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def run(self, host: str = "127.0.0.1", port: int = 8000):
        asyncio.run(self.serve(host, port))
