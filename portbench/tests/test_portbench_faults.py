"""Runs of the harness with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have, and true without one.

Each run skips the look for a card and drives the rest on the CPU: the
cell's configuration in float32 on one 512x512 canvas, three photos of
``books/1`` in batches of two, a window of one second, the cell's own
check with the configuration's limits. One card, so no exchange between
cards can be left out.
"""

import copy

import numpy as np
import pytest
import torch

from portbench.core import bench, registry


def small_cell(name):
    cell = registry.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["dtype"] = "float32"
    if "engine" in cell.config:
        cell.config["engine"]["canvases"] = [[512, 512]]
        cell.traffic["check_photos"] = 3
    else:
        cell.traffic["check_pages"] = 3
    cell.traffic["corpus"] = ["books/1/*.jpg"]
    cell.traffic["batch"] = 2
    return cell


def run_cell(name, seed=20261018):
    torch.set_num_threads(4)
    cell = small_cell(name)
    run = bench.Run(cell, seed, 1.0, False)
    import time

    run.state["t_process"] = time.perf_counter()
    out = bench.execute(run, registry.driver(cell), require_cuda=False)
    return out


def _other_char(ch):
    return "e" if ch != "e" else "a"


# ---------------------------------------------------------------- OCR


@pytest.fixture
def stream_fault(monkeypatch):
    from bbocr_tpu_torch.runtime.engine import OCREngine

    real = OCREngine.readtext_stream

    def install(kind):
        def broken(self, batches, depth=2):
            for answers in real(self, batches, depth):
                if kind == "half_batch":
                    answers = [a if i < (len(answers) + 1) // 2 else [] for i, a in enumerate(answers)]
                elif kind == "altered":  # the last character swapped
                    answers = [[(q, t[:-1] + _other_char(t[-1]), c) for q, t, c in a] for a in answers]
                elif kind == "unchanged":  # the answers as the stream starts them
                    answers = [[] for _ in answers]
                yield answers

        monkeypatch.setattr(OCREngine, "readtext_stream", broken)

    return install


@pytest.fixture
def drop_last_char(monkeypatch):
    """The greedy CTC decode drops each read's last character where it is
    produced, its confidence recomputed over the frames still emitted."""
    from bbocr_tpu_torch.runtime import engine

    real = engine.ctc_greedy_decode

    def broken(logits, lengths=None, blank=0):
        ids, lens, _ = real(logits, lengths, blank)
        b, t, _ = logits.shape
        best = torch.argmax(logits, dim=-1)
        if lengths is not None:
            best = torch.where(torch.arange(t)[None, :] < lengths[:, None], best, torch.full_like(best, blank))
        prev = torch.cat([torch.full((b, 1), -1, dtype=best.dtype), best[:, :-1]], dim=1)
        keep = (best != blank) & (best != prev)
        last = t - 1 - torch.argmax(keep.flip(1).to(torch.int32), dim=1)
        keep[torch.arange(b), last] = False
        lens = torch.clamp(lens - 1, min=0)
        ids = torch.where(torch.arange(t)[None, :] < lens[:, None], ids, torch.zeros_like(ids))
        logp = torch.where(keep, torch.log_softmax(logits.float(), -1).amax(-1), torch.zeros(()))
        conf = torch.where(lens > 0, torch.exp(logp.sum(1)), torch.zeros(()))
        return ids, lens, conf

    monkeypatch.setattr(engine, "ctc_greedy_decode", broken)


def test_ocr_sound_run_is_correct():
    out = run_cell("ocr_stream_camera")
    assert out["correct"], out["check"]


@pytest.mark.parametrize("kind", ["half_batch", "altered", "unchanged"])
def test_ocr_fault_is_not_correct(stream_fault, kind):
    stream_fault(kind)
    out = run_cell("ocr_stream_camera")
    assert not out["correct"], out["check"]


def test_ocr_dropped_character_is_not_correct(drop_last_char):
    out = run_cell("ocr_stream_camera")
    differ = out["check"]["read_text_differ_share"]
    assert differ["value"] > differ["limit"] and not out["correct"], out["check"]


# ---------------------------------------------------------------- PageReader


@pytest.fixture
def decode_fault(monkeypatch):
    from bbocr_tpu_torch.models import vlm

    real = vlm.greedy_generate

    def install(kind):
        def broken(model, page, max_len=vlm.MAX_JSON_LEN):
            tokens = real(model, page, max_len)
            if kind == "half_batch":
                tokens[(tokens.shape[0] + 1) // 2 :, 1:] = vlm.PAD_ID
            elif kind == "altered":
                tokens[:, 2] = torch.where(tokens[:, 2] == 5, 6, 5)
            elif kind == "unchanged":
                tokens[:, 1:] = vlm.PAD_ID
            return tokens

        monkeypatch.setattr(vlm, "greedy_generate", broken)

    return install


def test_pagereader_sound_run_is_correct():
    out = run_cell("pagereader_backlog128")
    assert out["correct"], out["check"]


@pytest.mark.parametrize("kind", ["half_batch", "altered", "unchanged"])
def test_pagereader_fault_is_not_correct(decode_fault, kind):
    decode_fault(kind)
    out = run_cell("pagereader_backlog128")
    assert not out["correct"], out["check"]


def test_decoder_fault_is_not_correct(monkeypatch):
    """A decoder that returns a plane other than the file's fails the digests."""
    from bbocr_tpu_torch import io

    real = io.imread_gray
    monkeypatch.setattr(io, "imread_gray", lambda path: np.minimum(real(path).astype(np.int32) + 1, 255).astype(np.uint8))
    out = run_cell("ocr_stream_camera")
    assert out["check"]["decode_sha256_mismatches"]["value"] > 0 and not out["correct"]
