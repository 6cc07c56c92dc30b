"""The port's training CLI (``bbocr_tpu_torch/cli/train.py``) and
``vlm_eval --synthetic`` against the JAX package's, on the CPU.

- ``main``'s flags and defaults are the JAX CLI's, with ``--device`` added;
- two steps of each component at tiny sizes from the synthetic generators
  (the CLI in its own process, its workers forked; the PageReader's loop
  in the test's process): the checkpoint it writes loads in JAX's
  ``load_params`` as a tree of flax's keys and shapes;
- ``--distill-from``, ``--pipeline-crops`` and ``--val-real`` run;
- ``--state-dir``: a run saved at step 2 and resumed to step 3 ends where
  an uninterrupted 3-step run ends, bit for bit (a recorded batch source);
- the SIGTERM flag stops the loop after one step, with a checkpoint;
- the Pillow-free crop loaders (``_load_real_val``,
  ``_load_pipeline_crops``) give the JAX CLI's arrays on crops of several
  heights and widths;
- ``vlm_eval --synthetic`` on two held-out pages gives the JAX CLI's
  report with a float32 PageReader from ``checkpoints/vlm.npz``.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bbocr_tpu.cli import train as jax_train
from bbocr_tpu.cli import vlm_eval as jax_vlm_eval
from bbocr_tpu.models import CRAFTLite as JaxCRAFTLite
from bbocr_tpu.models import CRNN as JaxCRNN
from bbocr_tpu.models.vlm import PageReader as JaxPageReader
from bbocr_tpu.utils.checkpoint import load_params as jax_load_params
from bbocr_tpu_torch.cli import train
from bbocr_tpu_torch.cli import vlm_eval

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    seen = {}

    def grab(self, *a, **k):
        seen["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jax_train.main()
    return seen["parser"]


def test_flags_and_defaults_match_jax(monkeypatch):
    want = {a.dest: (a.default, a.choices, a.type, a.required, a.option_strings)
            for a in _jax_parser(monkeypatch)._actions}
    monkeypatch.undo()
    got = {a.dest: (a.default, a.choices, a.type, a.required, a.option_strings)
           for a in train.build_parser()._actions}
    assert got.pop("device")[0] == "cuda"
    assert got == want


def _args(tmp_path, component, *extra):
    return train.build_parser().parse_args(
        ["--component", component, "--steps", "2", "--batch", "2", "--log-every", "1", "--data-threads", "1",
         "--out", str(tmp_path), "--device", "cpu", *extra])


def _run_cli(tmp_path, component, *extra) -> str:
    """``python -m bbocr_tpu_torch.cli.train`` in a fresh process (its
    workers fork from a process without JAX's threads, as a user's run
    does); returns its output."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "bbocr_tpu_torch.cli.train", "--component", component, "--steps", "2", "--batch", "2",
         "--log-every", "1", "--data-threads", "1", "--out", str(tmp_path), "--device", "cpu", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _flax_shapes(module, *inputs, **kw):
    tree = jax.eval_shape(lambda key: module.init(key, *inputs, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda v: tuple(v.shape), dict(tree))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), tree)


@pytest.mark.parametrize("component", ["crnn", "craft", "vlm"])
def test_two_synthetic_steps_write_checkpoints_jax_loads(component, tmp_path, capsys):
    """The CLI in its own process, synthetic batches from a forked worker
    (the PageReader's loop in this process on generated batches)."""
    if component == "crnn":
        out = _run_cli(tmp_path, "crnn", "--width", "64")
        path, want = "crnn.npz", _flax_shapes(JaxCRNN(num_classes=97), jnp.zeros((1, 32, 64, 1)))
    elif component == "craft":
        out = _run_cli(tmp_path, "craft", "--arch", "lite", "--page-h", "64", "--page-w", "64")
        path, want = "craft.npz", _flax_shapes(JaxCRAFTLite(), jnp.zeros((1, 64, 64, 3)))
    else:  # in this process on batches of the JAX generator: the default validation decodes 8 pages
        from bbocr_tpu.models.vlm import decode_ids
        from bbocr_tpu.train.synth import PageGenerator, SynthConfig

        batch = PageGenerator(SynthConfig(), seed=5).batch_labeled(2, 64, 48, with_ctc=True)
        batch = (batch[0].astype(np.uint8),) + tuple(batch[1:])
        train.train_vlm(_args(tmp_path, "vlm", "--page-h", "64", "--page-w", "48", "--vlm-ctc-weight", "0.5"),
                        source=train.Batches([batch]), val=(batch[0][:1], [decode_ids(batch[1][0])]))
        out = capsys.readouterr().out
        path = "vlm.npz"
        want = _flax_shapes(JaxPageReader(), jnp.zeros((1, 64, 48, 1)), jnp.zeros((1, 8), jnp.int32), with_ctc=True)
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert steps[-1].split()[1] == "2" and "nan" not in out
    assert _shapes(jax_load_params(str(tmp_path / path))) == want


def test_resume_ends_where_an_uninterrupted_run_ends(tmp_path):
    """2 steps saved, then resumed to 3, against 3 straight steps, on a
    recorded batch of 4 crops at width 64."""
    from bbocr_tpu.train.synth import SynthConfig, TextLineGenerator

    batches = [tuple(np.asarray(a) for a in TextLineGenerator(SynthConfig(), seed=s).batch(4, width=64))
               for s in (1, 2, 3)]
    batches = [(b[0].astype(np.uint8),) + b[1:] for b in batches]
    val = (batches[0][0][:2], ["a", "b"])
    flags = ["--component", "crnn", "--batch", "4", "--width", "64", "--log-every", "1", "--save-every", "2",
             "--device", "cpu", "--schedule", "cosine", "--warmup", "1"]
    parse = train.build_parser().parse_args
    straight = train.train_crnn(parse(flags + ["--steps", "3", "--out", str(tmp_path / "a")]),
                                source=train.Batches(batches), val=val)
    state = str(tmp_path / "state")
    first = train.train_crnn(parse(flags + ["--steps", "2", "--out", str(tmp_path / "b"), "--state-dir", state]),
                             source=train.Batches(batches), val=val)
    assert first["start_step"] == 0 and sorted(os.listdir(state)) == ["step_2"]
    second = train.train_crnn(parse(flags + ["--steps", "3", "--out", str(tmp_path / "b"), "--state-dir", state]),
                              source=train.Batches(batches[2:]), val=val)
    assert second["start_step"] == 2 and [row["step"] for row in second["log"]] == [3]
    assert second["log"][0]["loss"] == straight["log"][2]["loss"]
    a, b = jax_load_params(straight["path"]), jax_load_params(second["path"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, b, a)
    assert sorted(os.listdir(state)) == ["step_2", "step_3"]


def test_stop_flag_saves_and_stops_after_one_step(tmp_path, capsys):
    from bbocr_tpu.train.synth import SynthConfig, TextLineGenerator

    batch = TextLineGenerator(SynthConfig(), seed=1).batch(2, width=64)
    batch = (batch[0].astype(np.uint8),) + batch[1:]
    train._STOP_REQUESTED.set()
    try:
        out = train.train_crnn(_args(tmp_path, "crnn", "--width", "64", "--steps", "50",
                                     "--state-dir", str(tmp_path / "state")),
                               source=train.Batches([batch]), val=(batch[0], ["x", "y"]))
    finally:
        train._STOP_REQUESTED.clear()
    assert "stopped early at step 1" in capsys.readouterr().out
    assert [row["step"] for row in out["log"]] == [1]
    assert os.path.exists(out["path"]) and os.listdir(tmp_path / "state") == ["step_1"]


def _crops_dir(tmp_path):
    rng = np.random.default_rng(0)
    meta = {}
    for i, (h, w) in enumerate([(32, 90), (20, 57), (48, 300), (40, 23), (32, 400), (17, 130)]):
        name = f"crop_{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w)).astype(np.uint8)).save(tmp_path / name)
        meta[name] = {"label": f"text {i}"} if i % 2 else f"text {i}"
    Image.fromarray(rng.integers(0, 256, (25, 60, 3)).astype(np.uint8)).save(tmp_path / "rgb.png")
    meta["rgb.png"] = "colour"
    with open(tmp_path / "labels.json", "w") as f:
        json.dump(meta, f)
    return str(tmp_path)


def test_pillow_free_loaders_match_jax(tmp_path):
    d = _crops_dir(tmp_path)
    for width in (256, 384):
        got, got_refs = train._load_real_val(d, width)
        want, want_refs = jax_train._load_real_val(d, width)
        assert got_refs == want_refs
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    got, want = train._load_pipeline_crops(d), jax_train._load_pipeline_crops(d)
    assert [label for _, label in got] == [label for _, label in want]
    for (g, _), (w, _) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_vlm_eval_synthetic_matches_jax():
    """Two held-out synthetic pages at 64x48 through a float32 PageReader
    from the shipped checkpoint in each package: the same report."""
    from bbocr_tpu.utils.checkpoint import load_params
    from bbocr_tpu_torch.models.vlm import PageReader

    path = os.path.join(ROOT, "checkpoints", "vlm.npz")
    tree = load_params(path)
    want = jax_vlm_eval.eval_synthetic(JaxPageReader(dtype=jnp.float32),
                                       jax.tree_util.tree_map(jnp.asarray, tree), 2, 2, 64, 48)
    model = PageReader(dtype=torch.float32).load_params(tree).eval()
    got = vlm_eval.eval_synthetic(model, 2, 2, 64, 48)
    assert got == want


def test_distillation_real_val_and_pipeline_crops_run(tmp_path):
    """``--distill-from`` (a lite teacher from its checkpoint) on the lite
    detector, and the recognizer with ``--pipeline-crops`` mixed into the
    synthetic batches and ``--val-real`` reported, one step each."""
    (tmp_path / "crops").mkdir()
    d = _crops_dir(tmp_path / "crops")
    teacher = os.path.join(ROOT, "checkpoints", "candidates", "craft_lite_raw.npz")
    out = _run_cli(tmp_path / "craft", "craft", "--arch", "lite", "--page-h", "64", "--page-w", "64", "--steps", "1",
                   "--distill-from", teacher, "--distill-weight", "0.5")
    assert "distilling from" in out and "step      1 loss" in out
    out = _run_cli(tmp_path / "crnn", "crnn", "--steps", "1", "--pipeline-crops", f"{d}:0.5", "--val-real", d)
    assert "pipeline crops: 7" in out and "real_cer" in out
    assert os.path.exists(tmp_path / "crnn" / "crnn_best_real.npz")
    with open(tmp_path / "crnn" / "best_real.json") as f:
        assert json.load(f)["step"] == 1
