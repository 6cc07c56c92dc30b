"""Cross-request batching for the OCR engine (the scanner queue).

Counterpart of ``bbocr_tpu/runtime/batching.py``. ``BatchingOCR`` wraps an
``OCREngine`` with a submission queue and a worker thread that drains up to
``max_batch`` images within a ``max_wait_ms`` window and dispatches them as
one ``readtext_batch`` call; callers block on their own future only. A lone
request pays at most ``max_wait_ms`` extra; under load the queue refills
while the device runs, so the wait does not trigger.

It forwards what the JAX wrapper forwards and nothing more: ``readtext``,
``readtext_batch``, ``read_joined``, ``read_lines``, ``close`` and
``timings``. The extractor checks for the fast path and the re-reads with
``hasattr``, so behind this wrapper it takes neither, as the JAX extractor
does with its shared engine.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, List, Optional, Sequence

import numpy as np

from bbocr_tpu_torch.decode import group_lines


class BatchingOCR:
    def __init__(self, engine: Any, max_batch: int = 16, max_wait_ms: float = 10.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.batches_dispatched = 0
        self.images_processed = 0

    def readtext(self, image: np.ndarray, timeout: Optional[float] = None):
        """Submit one image; blocks until its OCR result is ready."""
        return self._submit(image).result(timeout=timeout)

    def readtext_batch(self, images: Sequence[np.ndarray], timeout: Optional[float] = None):
        futs = [self._submit(img) for img in images]
        return [f.result(timeout=timeout) for f in futs]

    def _submit(self, image: np.ndarray) -> Future:
        if self._closed.is_set():
            raise RuntimeError("BatchingOCR is closed")
        fut: Future = Future()
        self._queue.put((image, fut))
        return fut

    def read_joined(self, image: np.ndarray, timeout: Optional[float] = None) -> str:
        return " ".join(t for _, t, _ in self.readtext(image, timeout=timeout))

    def read_lines(self, image: np.ndarray, timeout: Optional[float] = None):
        res = self.readtext(image, timeout=timeout)
        if not res:
            return []
        lines = group_lines([r[0] for r in res])
        return [" ".join(res[i][1] for i in line) for line in lines]

    def close(self) -> None:
        self._closed.set()
        self._queue.put(None)  # wake the worker
        # Fail any request still queued (or racing close) so that callers
        # blocked on fut.result() without a timeout are released.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("engine closed"))

    def timings(self):
        return self.engine.timings()

    def _run(self) -> None:
        while not self._closed.is_set():
            item = self._queue.get()
            if item is None:
                continue
            batch: List = [item]
            # linger briefly for companions, then drain whatever is queued
            wait = self.max_wait_s
            while len(batch) < self.max_batch:
                try:
                    nxt = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
                wait = 0.0  # after the first linger, only drain
            images = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            try:
                results = self.engine.readtext_batch(images)
                self.batches_dispatched += 1
                self.images_processed += len(images)
                for fut, res in zip(futs, results):
                    fut.set_result(res)
            except Exception as e:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
