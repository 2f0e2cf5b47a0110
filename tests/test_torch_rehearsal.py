"""The port's corpus rehearsal and recipe demo (pkr_tpu_torch.tools.
corpus_rehearsal, .recipe_demo) against tools/corpus_rehearsal.py and
tools/recipe_demo.py, on the CPU at a tiny size.

- the synthetic corpora, MUSAN and RIR trees and in-memory pools: the same
  seeds give the JAX tools' wav samples (array-equal), manifests and pool
  arrays, each read back by its own package;
- the rehearsal's Config equals, field by field, the one the JAX tool
  builds (tools/corpus_rehearsal.py:203-215), dense and flash;
- a tiny rehearsal on tiny_resnet, stages 0-6 and the flash stage 3, writes
  a summary of every stage with a rotation record and a finite EER, and a
  resumed run redoes nothing;
- a tiny recipe demo runs every stage to a finite EER.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

from pkr_tpu.io.wav import read_wav as jax_read_wav
from pkr_tpu_torch.io.wav import read_wav
from pkr_tpu_torch.tools import corpus_rehearsal as cr
from pkr_tpu_torch.tools import recipe_demo as rd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["stage0", "stage1", "stage2", "stage3", "stage4", "stage5", "stage6",
          "stage3_flash"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(got_root, ref_root):
    """Every file under both roots: the same names; wavs array-equal as read
    back by each package, other files equal as text with the roots' paths
    taken out."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(ref_root)
    assert files(got_root) == names and names
    for rel in names:
        got, ref = os.path.join(got_root, rel), os.path.join(ref_root, rel)
        if rel.endswith(".wav"):
            (a, ra), (b, rb) = read_wav(got), jax_read_wav(ref)
            assert ra == rb == 16000
            np.testing.assert_array_equal(a, b, err_msg=rel)
        else:
            assert (open(got).read().replace(got_root, "ROOT")
                    == open(ref).read().replace(ref_root, "ROOT")), rel


def _same_datadir(got, ref, got_root, ref_root):
    assert got["utt2spk"] == ref["utt2spk"]
    assert {u: p.replace(got_root, "ROOT") for u, p in got["wav.scp"].items()} == \
        {u: p.replace(ref_root, "ROOT") for u, p in ref["wav.scp"].items()}


def test_synth_corpus_matches_jax_tool(tmp_path):
    ref_root, got_root = str(tmp_path / "jax"), str(tmp_path / "port")
    names = ["s0000", "s0001", "s0002"]
    ref = _jax_tool("corpus_rehearsal").synth_corpus(ref_root, names, 2, seed=10)
    got = cr.synth_corpus(got_root, names, 2, seed=10)
    _same_datadir(got, ref, got_root, ref_root)
    _same_tree(got_root, ref_root)


def test_synth_musan_and_rir_tree_match_jax_tool(tmp_path):
    tool = _jax_tool("corpus_rehearsal")
    for side, mod in (("jax", tool), ("port", cr)):
        mod.synth_musan(str(tmp_path / side / "musan"), n_noise=3, n_music=2, n_speech=2,
                        sec=0.5)
        mod.synth_rir_tree(str(tmp_path / side / "RIRS_NOISES"))
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_recipe_demo_synth_speakers_matches_jax_tool(tmp_path):
    ref_root, got_root = str(tmp_path / "jax"), str(tmp_path / "port")
    names = ["spk000", "spk001", "spk017"]
    ref = _jax_tool("recipe_demo").synth_speakers(ref_root, names, 2, 0.25, 1)
    got = rd.synth_speakers(got_root, names, 2, 0.25, 1)
    _same_datadir(got, ref, got_root, ref_root)
    _same_tree(got_root, ref_root)


def test_recipe_demo_pools_match_jax_tool():
    ref = _jax_tool("recipe_demo").build_pools()
    got = rd.build_pools(device="cpu")
    assert sorted(got.pools) == sorted(ref.pools) == ["babble", "music", "noise"]
    for kind in ref.pools:
        for a, b in zip(got.pools[kind], ref.pools[kind]):
            np.testing.assert_array_equal(a, b, err_msg=kind)
    for a, b in zip(got.rirs, ref.rirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flash", [False, True])
def test_rehearsal_config_matches_jax_tool(flash):
    """Field by field (both packages' to_json), the JAX tool's construction
    at tools/corpus_rehearsal.py:203-215, then its flash variant."""
    from pkr_tpu.config import Config

    d = Config()
    ref = Config(
        model=dataclasses.replace(d.model, loss="AAM"),
        train=dataclasses.replace(d.train, epochs=2, batch_size=256, device_cache=True,
                                  print_freq=100),
        eval=dataclasses.replace(d.eval, backend="snorm", batch_size=64,
                                 cohort_subset=10000),
        data=dataclasses.replace(d.data, min_frames=150, cv_fraction=0.02,
                                 pool_shard_mb=8, pool_rotate_rows=2000))
    got = cr.rehearsal_config(2)
    if flash:
        ref = dataclasses.replace(ref, train=dataclasses.replace(ref.train, flash_aam=True))
        got = dataclasses.replace(got, train=dataclasses.replace(got.train, flash_aam=True))
    assert json.loads(got.to_json()) == json.loads(ref.to_json())


def test_tiny_rehearsal_on_the_cpu(tmp_path, capsys):
    root = str(tmp_path / "reh")
    kw = dict(spk=8, utt=3, test_spk=4, test_utt=3, epochs=1, trunk="tiny_resnet",
              batch_size=8, print_freq=2, device="cpu")
    summary = cr.rehearse(root, **kw)
    assert list(summary["times_s"]) == ["synth"] + STAGES
    assert summary["peak_hbm_gb"] == dict.fromkeys(STAGES)  # None on the CPU, never 0
    rot = json.loads(summary["rotation"])
    assert rot["pool_rotation_errors"] == 0 and "pool_rotations_done" in rot
    assert np.isfinite(summary["results"]["eer"])
    assert summary["rows"] == {"train": 48, "test": 12, "extracted": 60, "trials": 66}
    assert summary["route_launches"]["stage3_flash"] == {"flash_aam_fwd": {},
                                                         "flash_aam_bwd": {}}
    assert summary["cache"]["stage3"]["mb"] > 0
    assert summary["train"]["stage3"]["ms_per_step"] > 0
    assert summary["card"] == "cpu"
    with open(os.path.join(root, "rehearsal_summary.json")) as f:
        assert json.load(f)["times_s"] == summary["times_s"]
    assert os.path.islink(os.path.join(root, "exp_flash", "feats"))
    # a resumed run over the same corpus redoes no stage
    capsys.readouterr()
    again = cr.rehearse(root, skip_synth=True, resume=True, **kw)
    out = capsys.readouterr().out
    assert again["times_s"] == summary["times_s"]
    assert out.count("done in a previous attempt") == len(STAGES)
    assert "== stage" not in out


def test_tiny_recipe_demo_on_the_cpu(tmp_path):
    out = rd.run_demo(str(tmp_path / "demo"), train_spk=4, test_spk=3, train_utt=4,
                      test_utt=3, epochs=1, batch=8, trunk="tiny_resnet", device="cpu")
    assert list(out["stages"]) == ["1 features (aug 2x + test)", "2 split", "3 train",
                                   "4 extract", "5 backend stats", "6 score (snorm)"]
    assert out["n_train"] == 32 and out["num_spk"] == 4
    assert out["n_trials"] == 3 * 2 * 3  # 3 enrolments x 6 test sides
    assert np.isfinite(out["results"]["eer"])
    assert 0.0 <= out["results"]["min_dcf_p0.01"] <= 1.0
