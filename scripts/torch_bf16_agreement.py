"""How often the port's bfloat16 recognizer reads the JAX engine's text, on
the same crops, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_bf16_agreement.py [--lstm scan|nn]

The five covers of ``data/real/covers/`` are preprocessed by the port and
read by its default bfloat16 engine at the four right-angle rotations;
every batch of crops the port recognizes is also recognized by the JAX
engine's compiled recognize program (bfloat16, contrast retry included).
Prints the number of crops, how many texts differ, the largest and mean
confidence difference, and the JAX confidence of each crop whose text
differs. ``--lstm nn`` swaps the port's LSTM scan for ``torch.nn.LSTM``
with the same weights, the form the port used before the scan.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lstm", choices=("scan", "nn"), default="scan")
    args = p.parse_args()
    os.environ.setdefault("BB_OCR_COMPILE_CACHE", "0")

    import jax.numpy as jnp
    import numpy as np
    import torch

    from bbocr_tpu.runtime.engine import EngineConfig as JaxEngineConfig
    from bbocr_tpu.runtime.engine import OCREngine as JaxOCREngine
    from bbocr_tpu_torch.io import load_rgb
    from bbocr_tpu_torch.models import crnn as crnn_module
    from bbocr_tpu_torch.preprocess import preprocess_for_book_cover
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine

    craft, crnn = (os.path.join(ROOT, "checkpoints", f) for f in ("craft.npz", "crnn.npz"))
    jax_engine = JaxOCREngine.from_checkpoint(craft, crnn, config=JaxEngineConfig(
        compute_dtype=jnp.bfloat16, host_rectify=False, wire_bits=8, decoder="greedy",
        detect_pool=1, detect_coarse=0,
    ))
    port = OCREngine.from_checkpoint(craft, crnn, EngineConfig(host_rectify=False, decoder="greedy"), device="cpu")
    if args.lstm == "nn":
        lstms = {}
        for m in (port.crnn.rnn0, port.crnn.rnn1):
            lstm = torch.nn.LSTM(m.fwd.w_ih.shape[0], m.fwd.w_hh.shape[0], batch_first=True, bidirectional=True)
            with torch.no_grad():
                for sfx, d in (("l0", m.fwd), ("l0_reverse", m.bwd)):
                    getattr(lstm, f"weight_ih_{sfx}").copy_(d.w_ih.T)
                    getattr(lstm, f"weight_hh_{sfx}").copy_(d.w_hh.T)
                    getattr(lstm, f"bias_ih_{sfx}").copy_(d.b_ih)
                    getattr(lstm, f"bias_hh_{sfx}").zero_()
            lstms[id(m.fwd)] = lstm.to(torch.bfloat16)
        crnn_module.bidirectional_scan = lambda x, fwd, bwd: lstms[id(fwd)](x)[0]

    batches = []
    recognize = port.recognize

    def record(crops, lengths, valid):
        batches.append((crops.clone(), lengths.clone(), valid.clone()))
        return recognize(crops, lengths, valid)

    port.recognize = record
    for path in sorted(glob.glob(os.path.join(ROOT, "data", "real", "covers", "*.png"))):
        image = preprocess_for_book_cover(load_rgb(path), device="cpu")[0].numpy()
        for k in range(4):
            port.readtext(np.ascontiguousarray(np.rot90(image, k)))
    port.recognize = recognize

    rows = []
    for crops, lengths, valid in batches:
        ref = [np.asarray(a) for a in jax_engine._recognize(
            jax_engine.crnn_params, jnp.asarray(crops.numpy()), jnp.asarray(lengths.numpy()), jnp.asarray(valid.numpy()))]
        got = [a.numpy() for a in port.recognize(crops, lengths, valid)]
        for k in range(int(valid.sum())):
            texts = [port.charset.decode_ids(ids[k][: lens[k]]) for ids, lens, _ in (got, ref)]
            rows.append((texts[0] != texts[1], abs(float(got[2][k]) - float(ref[2][k])), float(ref[2][k])))
    a = np.array(rows)
    differ = sorted(round(c, 4) for d, _, c in rows if d)
    print(f"lstm={args.lstm}: {len(rows)} crops, {int(a[:, 0].sum())} texts differ from the JAX engine's; "
          f"confidence difference max {a[:, 1].max():.4f}, mean {a[:, 1].mean():.6f}; "
          f"JAX confidence of the differing crops {differ}")


if __name__ == "__main__":
    main()
