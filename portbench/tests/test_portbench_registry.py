"""A cell's parts are found by name: a later change adds a configuration, a
traffic mix or a per-layer metric as files and entries, and edits nothing."""

import json
import shutil

import pytest

from portbench.core import registry


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "drivers", "metrics", "limits"):
        shutil.copytree(f"{registry.PORTBENCH}/{sub}", root / sub)
    bench = registry.load_json(f"{registry.ROOT}/BENCHMARK.json")
    return root, bench


def test_every_cell_of_the_benchmark_resolves():
    bench = registry.load_json(f"{registry.ROOT}/BENCHMARK.json")
    for w in bench["workloads"]:
        cell = registry.find_cell(w["name"], bench)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        registry.driver(cell)
        registry.reference(cell)
        for m in cell.per_layer:
            assert callable(registry.metric_reader(m["name"]).read)


def test_new_config_traffic_and_metric_are_found_by_name(tree):
    root, bench = tree
    cfg = json.loads((root / "configs" / "ocr_craftgn_crnn97.json").read_text())
    cfg["engine"]["canvases"] = [[704, 512]]
    (root / "configs" / "ocr_small_menu.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "stream_pages.json").read_text())
    tr["batch"] = 8
    (root / "traffic" / "stream_pages8.json").write_text(json.dumps(tr))
    (root / "metrics" / "photos_done.stream8.py").write_text("def read(run):\n    return run.completed\n")
    (root / "limits" / "ocr_pages8.json").write_text(json.dumps({"read_gap": {"limit": 0.5, "readings": "-"}}))
    bench["workloads"].append({"name": "ocr_pages8", "config": "ocr_small_menu", "traffic": "stream_pages8",
                               "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("ocr_pages8")
    bench["per_layer"].append({"name": "photos_done.stream8", "unit": "photos", "better": "higher",
                               "source": "program_counter", "layer": "Engine stages", "moves": "photos_per_s",
                               "workloads": ["ocr_pages8"]})
    cell = registry.find_cell("ocr_pages8", bench, root=str(root))
    assert cell.config["engine"]["canvases"] == [[704, 512]] and cell.traffic["batch"] == 8
    assert cell.limits == {"read_gap": 0.5}
    assert [m["name"] for m in cell.per_layer][-1] == "photos_done.stream8"
    assert registry.driver(cell, root=str(root)).__name__.endswith("stream")

    class FakeRun:
        completed = 17

    assert registry.metric_reader("photos_done.stream8", root=str(root)).read(FakeRun()) == 17


def test_a_metric_without_workloads_goes_to_every_cell_reporting_its_metric():
    bench = registry.load_json(f"{registry.ROOT}/BENCHMARK.json")
    bench["per_layer"].append({"name": "x", "unit": "s", "better": "lower", "source": "host_clock",
                               "layer": "Device", "moves": "pages_per_s"})
    assert "x" in {m["name"] for m in registry.find_cell("pagereader_backlog128", bench).per_layer}
    assert "x" not in {m["name"] for m in registry.find_cell("ocr_stream_camera", bench).per_layer}


def test_an_unknown_cell_names_what_there_is():
    with pytest.raises(KeyError, match="ocr_stream_camera"):
        registry.find_cell("no_such_cell")
