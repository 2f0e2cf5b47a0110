"""The port's recipe CLI over several processes on the CPU:
``python -m pkr_tpu_torch.recipes.run --device cpu`` started on 2 local
"hosts" by the port's ``launch_hosts`` (a local stand-in for ssh), which
hands each process the env contract of ``parallel/distributed.py``; the
processes form a gloo group.

- The aam_cpu_debug recipe, stages 0-6, on a tiny corpus: every stage
  completes on both ranks, the per-rank arks (``train.iv.<rank>``,
  ``test.iv.<rank>``) cover each utterance exactly once and no
  single-process ark is left, and the scores and the checkpoints are
  written once.
- ``train.model_parallel = 2`` with the flash head: stage 3 over a 1 x 2
  mesh (each rank half the AAM weight's class rows, the same batches)
  trains, and its checkpoint (the whole weight, gathered) equals a
  one-process run of stage 3 from the same features at lr 1e-3 to within a
  quarter of each tensor's change over the second epoch (+1e-6), for every
  parameter and BatchNorm statistic; the cv top-1 and top-5 are equal and
  the cv losses within 5e-3 of themselves.  The bound is the bf16 trunk's
  (see LR); a head that dropped a class shard's share of dê would move each
  trunk tensor by about half its change.  The momentum, the last steps'
  bf16 gradients, parts by as much as it changes and is held in f32 by
  test_torch_parallel.py instead.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pkr_tpu_torch.io import DataDir, load_text_vec_ark, read_text_vec_ark
from pkr_tpu_torch.recipes.presets import PRESETS
from pkr_tpu_torch.utils.cluster import launch_hosts

from test_e2e import synth_corpus
from test_torch_parallel_cluster import _local_transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the recipe's trunk computes in bf16 (build_model): its backward rounds the
# gradients to bf16, so a difference of 1e-8 in dê (the class-sharded head's
# merged sums round apart from one process's) flips some roundings and
# moves a conv weight's gradient by ~1e-3 of itself.  At the preset's rate
# 0.1 two epochs turn that into a different run; at 1e-3 each tensor of the
# two runs parts by 1-12 % of its change over the second epoch (in f32,
# test_torch_parallel.py holds the same step to 1e-6)
LR = 1e-3


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}


def _launch(tmp_path, name, argv):
    cmd = " ".join([sys.executable, "-m", "pkr_tpu_torch.recipes.run", "--device", "cpu"]
                   + list(argv))
    launch_hosts(cmd, hosts=["localhost", "localhost"], log_dir=str(tmp_path / "log"),
                 name=name, port=_free_port(), transport=_local_transport(tmp_path),
                 env_extra={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}, timeout=300)
    return [open(tmp_path / "log" / f"{name}.{r}.log").read() for r in range(2)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("par_corpus")
    data, test = str(root / "data"), str(root / "test")
    synth_corpus(data, n_spk=4, n_utt=6, seconds=1.0)
    synth_corpus(test, n_spk=4, n_utt=2, seconds=1.0, seed=3)
    t_u2s = DataDir.load(test, names=("utt2spk",))["utt2spk"]
    trials = str(root / "trials")
    with open(trials, "w") as f:
        f.writelines(f"{a} {b} {'target' if t_u2s[a] == t_u2s[b] else 'nontarget'}\n"
                     for a in sorted(t_u2s) for b in sorted(t_u2s) if a < b)
    return {"data": data, "test": test, "trials": trials}


def test_two_process_recipe_stages_0_to_6(corpus, tmp_path):
    exp = str(tmp_path / "exp")
    logs = _launch(tmp_path, "recipe", [
        "--preset", "aam_cpu_debug", "--data-dir", corpus["data"], "--test-data-dir",
        corpus["test"], "--trials", corpus["trials"], "--exp-dir", exp])
    assert "== stage 6: score" in logs[0] and "rc=0" in logs[0]
    assert "== stage 3: train" in logs[1] and "== stage 6" not in logs[1]
    res = json.load(open(os.path.join(exp, "results.json")))
    assert 0.0 <= res["eer"] <= 1.0
    assert open(os.path.join(exp, "checkpoints", "latest")).read() == "ckpt_3"
    train_utts = [l.split()[0] for l in open(os.path.join(exp, "feats", "train",
                                                          "feats.scp"))]
    test_utts = sorted(DataDir.load(corpus["test"], names=("utt2spk",))["utt2spk"])
    for name, utts in (("train.iv", train_utts), ("test.iv", test_utts)):
        assert not os.path.exists(os.path.join(exp, name))
        keys = [k for r in range(2) for k, _ in read_text_vec_ark(
            os.path.join(exp, f"{name}.{r}"))]
        assert len(keys) == len(set(keys)) and sorted(keys) == sorted(utts), name
        merged = load_text_vec_ark(os.path.join(exp, name))
        assert all(np.isfinite(v).all() for v in merged.values())
    scores = open(os.path.join(exp, "scores.txt")).read().splitlines()
    assert len(scores) == sum(1 for _ in open(corpus["trials"]))


def test_model_parallel_2_trains_as_one_process(corpus, tmp_path):
    exp = str(tmp_path / "exp")
    from pkr_tpu_torch.recipes import run as trun

    assert trun.main(["--device", "cpu", "--preset", "aam_cpu_debug", "--data-dir",
                      corpus["data"], "--exp-dir", exp, "--stage", "0",
                      "--stop-stage", "2"]) == 0
    cfg = PRESETS["aam_cpu_debug"]()
    outs = {}
    for tp in (1, 2):
        run_exp = str(tmp_path / f"exp_tp{tp}")
        shutil.copytree(os.path.join(exp, "feats"), os.path.join(run_exp, "feats"))
        cfg_path = str(tmp_path / f"tp{tp}.json")
        c = cfg.__class__.from_json(cfg.to_json())
        import dataclasses

        c = dataclasses.replace(c, train=dataclasses.replace(
            c.train, model_parallel=tp, flash_aam=True, epochs=2, lr=LR))
        open(cfg_path, "w").write(c.to_json())
        argv = ["--config", cfg_path, "--data-dir", corpus["data"], "--exp-dir", run_exp,
                "--stage", "3", "--stop-stage", "3"]
        if tp == 1:  # one process, with the ranks' thread count
            subprocess.run([sys.executable, "-m", "pkr_tpu_torch.recipes.run", "--device",
                            "cpu"] + argv, check=True, env=_env())
        else:
            logs = _launch(tmp_path, "tp2", argv)
            assert all("rc=0" in l for l in logs)
        ck = [torch.load(os.path.join(run_exp, "checkpoints", f"ckpt_{e}", "state.pt"),
                         weights_only=True) for e in (1, 2)]
        recs = [json.loads(l) for l in open(os.path.join(run_exp, "train_metrics.jsonl"))]
        outs[tp] = (ck, [(r["epoch"], r["acc1"], r["acc5"], r["loss"])
                         for r in recs if "CV" in r["msg"]])
    ((ck1_e1, ck1), cv1), ((_, ck2), cv2) = outs[1], outs[2]
    assert ck2["model"]["last.weight"].shape == ck1["model"]["last.weight"].shape
    assert [r[:3] for r in cv2] == [r[:3] for r in cv1] and len(cv1) == 2
    np.testing.assert_allclose([r[3] for r in cv2], [r[3] for r in cv1], rtol=5e-3)
    assert sorted(ck2["momentum"]) == sorted(ck1["momentum"])
    for k, ref in ck1["model"].items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(ck2["model"][k], ref), k
            continue
        change = float((ref - ck1_e1["model"][k]).abs().max())
        np.testing.assert_allclose(ck2["model"][k].numpy(), ref.numpy(), rtol=0,
                                   atol=0.25 * change + 1e-6, err_msg=k)
