"""Nothing the harness runs imports JAX or the JAX package; names compare by
their whole top-level part, so ``bbocr_tpu_torch`` is not ``bbocr_tpu``."""

import subprocess
import sys

from portbench.core import imports, registry


def test_whole_top_level_names():
    assert imports.forbidden_in(["bbocr_tpu_torch", "bbocr_tpu_torch.models.vlm", "jaxtyping", "flaxen"]) == set()
    assert imports.forbidden_in(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "bbocr_tpu.io"]) == {
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "bbocr_tpu.io"}


def test_run_and_its_parts_import_no_jax():
    code = f"""
import sys
sys.path.insert(0, {registry.ROOT!r})
from portbench.core import bench, imports, registry
b = registry.load_json(registry.ROOT + "/BENCHMARK.json")
for w in b["workloads"]:
    cell = registry.find_cell(w["name"], b)
    registry.driver(cell); registry.reference(cell)
    for m in cell.per_layer:
        registry.metric_reader(m["name"])
import portbench.control
import bbocr_tpu_torch.runtime.engine, bbocr_tpu_torch.models.vlm, bbocr_tpu_torch.llm.native_vlm, bbocr_tpu_torch.io
found = imports.forbidden_loaded()
print(sorted(found))
sys.exit(1 if found else 0)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
