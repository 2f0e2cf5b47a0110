"""The port's large-speaker-count tool (pkr_tpu_torch.tools.bigspk) against
tools/bigspk_demo.py, on the CPU at a tiny size.

- make_featdir: the same seed gives the JAX tool's matrices, labels and
  speaker count (each read back by its own package);
- run_cli_train: stage 3 on tiny_resnet with the device cache on the CPU
  gives a parsed ms/step, and a run that logs no window raises;
- cpu_mesh_demo: run_train with model_parallel = 2 over two gloo ranks;
- the tools import neither jax nor pkr_tpu, and their entry points (and
  those of the corpus rehearsal, the recipe demo, the stage-1 bench and
  the train-step roofline) raise without a card, having written nothing.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from pkr_tpu.io.kaldi_ark import read_mat_scp as jax_read_mat_scp
from pkr_tpu_torch.io import read_mat_scp
from pkr_tpu_torch.tools import (bench_stage1, bigspk, corpus_rehearsal, parity_e2e,
                                 recipe_demo, train_roofline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_featdir_matches_jax_tool(tmp_path):
    ref = _jax_tool("bigspk_demo").make_featdir(str(tmp_path / "jax"), 50)
    got = bigspk.make_featdir(str(tmp_path / "port"), 50)
    for split, n in (("train", bigspk.N_TRAIN), ("cv", bigspk.N_CV)):
        want = dict(jax_read_mat_scp(os.path.join(ref, split, "feats.scp")))
        have = dict(read_mat_scp(os.path.join(got, split, "feats.scp")))
        assert sorted(have) == sorted(want) and len(have) == n
        for utt, mat in want.items():
            assert have[utt].shape == (bigspk.FRAMES, bigspk.FDIM)
            np.testing.assert_array_equal(have[utt], mat, err_msg=utt)
        assert (open(os.path.join(got, split, "utt2spkid")).read()
                == open(os.path.join(ref, split, "utt2spkid")).read())
    assert open(os.path.join(got, "num_spk")).read() == "50"
    assert open(os.path.join(ref, "num_spk")).read() == "50"


@pytest.mark.parametrize("print_freq", [3, 1000])
def test_run_cli_train_on_the_cpu(tmp_path, print_freq):
    """A window every 3 steps gives its mean step time; with no window
    logged the tool raises instead of reporting nothing."""
    kw = dict(epochs=2, trunk="tiny_resnet", batch_size=128, chunk=32,
              print_freq=print_freq, device="cpu")
    if print_freq > 6:  # 768 / 128 = 6 steps an epoch: no window
        with pytest.raises(RuntimeError, match="no 'time' meter lines"):
            bigspk.run_cli_train(64, str(tmp_path), **kw)
        return
    run = bigspk.run_cli_train(64, str(tmp_path), **kw)
    assert run.step_ms > 0 and run.wall_s > 0
    recs = [json.loads(line) for line in open(os.path.join(run.exp_dir,
                                                           "train_metrics.jsonl"))]
    assert sum("CV" in r["msg"] for r in recs) == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert os.path.isdir(os.path.join(run.exp_dir, "checkpoints"))


def test_cpu_mesh_demo_trains_over_two_ranks():
    assert bigspk.cpu_mesh_demo() == "mesh-train OK ranks= 2"


def test_tools_import_neither_jax_nor_pkr_tpu():
    """The tools' sources name no module of jax, flax or pkr_tpu (the
    package-wide import check is tests/test_torch_slice.py's)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|pkr_tpu)(\.|\s|$)")
    tools = os.path.join(REPO, "pkr_tpu_torch", "tools")
    names = sorted(f for f in os.listdir(tools) if f.endswith(".py"))
    assert names == ["__init__.py", "bench_stage1.py", "bigspk.py", "corpus_rehearsal.py",
                     "parity_e2e.py", "recipe_demo.py", "train_roofline.py"]
    for name in names:
        for i, line in enumerate(open(os.path.join(tools, name)), 1):
            assert not pat.match(line), f"{name}:{i}: {line.strip()}"


ENTRY_POINTS = {
    "run_cli_train": lambda tmp: bigspk.run_cli_train(8, tmp, trunk="tiny_resnet"),
    "bigspk_main": lambda tmp: bigspk.main(["--speakers", "8", "--skip-mesh"]),
    "run_once": lambda tmp: parity_e2e.run_once(tmp, parity_e2e.StudyConfig(n_spk=2)),
    "parity_main": lambda tmp: parity_e2e.main(["--root", tmp, "--spk", "2"]),
    "rehearse": lambda tmp: corpus_rehearsal.rehearse(os.path.join(tmp, "r"), spk=2, utt=2,
                                                      trunk="tiny_resnet"),
    "rehearsal_main": lambda tmp: corpus_rehearsal.main(["--out", os.path.join(tmp, "r"),
                                                         "--spk", "2", "--synth-only"]),
    "run_demo": lambda tmp: recipe_demo.run_demo(os.path.join(tmp, "d"), train_spk=2,
                                                 trunk="tiny_resnet"),
    "demo_main": lambda tmp: recipe_demo.main(["--root", os.path.join(tmp, "d"),
                                               "--train-spk", "2"]),
    "run_bench": lambda tmp: bench_stage1.run_bench(tmp, utts=2),
    "bench_main": lambda tmp: bench_stage1.main(["--out", tmp, "--utts", "2"]),
    "roofline_measure": lambda tmp: train_roofline.measure(),
    "roofline_main": lambda tmp: train_roofline.main([]),
}


@pytest.mark.parametrize("call", sorted(ENTRY_POINTS))
def test_tool_entry_points_raise_without_a_card(call, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[call](str(tmp_path))
    assert not os.listdir(tmp_path)  # nothing was written first
