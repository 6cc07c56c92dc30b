"""The scanner service and the standalone pricing server: counterpart of
``bbocr_tpu/server/``, on the framework's own asyncio HTTP server."""

from bbocr_tpu_torch.server.http import App, Request, Response, SSEResponse

__all__ = ["App", "Request", "Response", "SSEResponse"]
