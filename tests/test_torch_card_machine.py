"""The port runs where JAX, Pillow, OpenCV, jsonschema and requests are
missing, as on the machine with the card.

A subprocess blocks those imports with a ``sys.meta_path`` finder, runs
the port's extractor on a small PNG on the CPU, and imports
``chip_smoke`` without running its main.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib.abc
    import json
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "bbocr_tpu", "PIL", "cv2", "jsonschema", "requests"}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Blocker())
    try:
        import cv2  # noqa: F401
    except ImportError:
        pass
    else:
        raise SystemExit("the import blocker does not work")

    import torch

    torch.set_num_threads(2)
    from bbocr_tpu_torch.cli.process_book import make_extractor
    from bbocr_tpu_torch.runtime import EngineConfig, OCREngine
    from bbocr_tpu_torch.runtime.bucketing import CanvasSpec

    extractor = make_extractor(device="cpu")
    extractor._engine = OCREngine.from_checkpoint(
        "checkpoints/craft.npz", "checkpoints/crnn.npz",
        EngineConfig(canvases=(CanvasSpec(288, 224),), compute_dtype=torch.float32),
        device="cpu",
    )
    meta = extractor.extract_metadata_from_images([sys.argv[1]], ocr_image_indices=[0])
    import chip_smoke  # noqa: F401  (imported, main not run)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
    print(json.dumps({"meta": meta, "loaded": loaded}))
    """
)


def test_port_runs_without_jax_pillow_cv2_jsonschema_requests(tmp_path):
    with Image.open(os.path.join(ROOT, "data", "real", "covers", "book1.png")) as img:
        small = np.asarray(img.convert("RGB"))[::5, ::5]
    png = tmp_path / "small.png"
    Image.fromarray(small).save(png)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(png)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["meta"]["_processing_info"]["structurer"] == "heuristic"
    assert "title" in out["meta"]


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
