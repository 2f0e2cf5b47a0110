"""The port's end-to-end quality study (pkr_tpu_torch.tools.parity_e2e)
against tools/parity_e2e.py, on the CPU at a tiny size (tiny_resnet, a few
speakers, a few steps; the JAX tool's globals set with monkeypatch).

- synth_corpus: the same wav bytes, tables and stamp for the same config;
- run_once's data path: the same split, schedule and per-step LR;
- the two-phase training from the same weights (carried across with
  convert.state_dict_from_flax, trunk BatchNorm β away from 0), 2 + 2
  steps: embeddings at rtol 1e-3, atol 1e-5, the parameter tolerance of
  tests/test_torch_train.py; the warm start leaves the AAM weight fresh;
- the warm-start rule: a bare name-and-shape copy would carry the softmax
  classifier into the AAM weight, the port's rule gives pkr_tpu's result;
- the torch_default init is the JAX tool's torch half's initial weights;
- score and bootstrap_metrics: the JAX tool's EER, minDCF and CIs to 1e-9;
- main: rows and tables under --root, the banked rows unchanged.
"""

import copy
import dataclasses
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax

from pkr_tpu_torch.convert import state_dict_from_flax
from pkr_tpu_torch.tools import parity_e2e as pe
from pkr_tpu_torch.train import warm_start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPK, UTT, EVAL, B, CROP, F = 6, 6, 4, 8, 24, 40
EMB_TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def jt():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_parity_e2e", os.path.join(REPO, "tools", "parity_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(jt, monkeypatch):
    """The JAX tool's globals and the port's StudyConfig at one tiny size."""
    for name, val in (("N_SPK", SPK), ("N_UTT", UTT), ("N_EVAL", EVAL), ("SECONDS", 0.5),
                      ("BATCH", B), ("CROP_T", CROP), ("EPOCHS", 1), ("EPOCHS_SOFTMAX", 1),
                      ("LR0", 0.01), ("SEED", 3), ("TRUNK", "tiny_resnet")):
        monkeypatch.setattr(jt, name, val)
    return pe.StudyConfig(n_spk=SPK, n_utt=UTT, n_eval=EVAL, seconds=0.5, batch=B,
                          crop=CROP, epochs=1, epochs_softmax=1, lr0=0.01, seed=3,
                          trunk="tiny_resnet")


def _fake_corpus(seed=5, n_frames=(40, 90)):
    """utt2spk and (T, 40) features of the tiny corpus, T varying by
    utterance."""
    rng = np.random.default_rng(seed)
    utt2spk = {f"spk{i:03d}-utt{j:02d}": f"spk{i:03d}" for i in range(SPK) for j in range(UTT)}
    feats = {u: rng.standard_normal((int(rng.integers(*n_frames)), F)).astype(np.float32)
             for u in sorted(utt2spk)}
    return utt2spk, feats


def _digest(root):
    out = {}
    for name in sorted(os.listdir(root)):
        data = open(os.path.join(root, name), "rb").read()
        if name in ("wav.scp", ".done"):  # paths name the directory
            data = data.replace(root.encode(), b"ROOT")
        out[name] = hashlib.sha256(data).hexdigest()
    return out


def test_synth_corpus_matches_jax_tool(jt, tiny, tmp_path):
    ref_dir, got_dir = str(tmp_path / "jax" / "data_s3"), str(tmp_path / "port" / "data_s3")
    ref = jt.synth_corpus(ref_dir)
    got = pe.synth_corpus(got_dir, tiny)
    assert got == ref and len(got[0]) == SPK * UTT
    ref_files, got_files = _digest(ref_dir), _digest(got_dir)
    assert sorted(got_files) == sorted(ref_files)
    assert sum(f.endswith(".wav") for f in got_files) == SPK * UTT
    assert got_files == ref_files
    # the stamp serves a second call; other parameters re-synthesize
    assert pe.synth_corpus(got_dir, tiny) == got
    os.makedirs(str(tmp_path / "port" / "feats_s3"))
    louder = dataclasses.replace(tiny, noise=600.0)
    pe.synth_corpus(got_dir, louder)
    assert not os.path.exists(str(tmp_path / "port" / "feats_s3"))
    assert json.load(open(os.path.join(got_dir, ".done")))["params"]["noise"] == 600.0


class _Stop(Exception):
    pass


def test_run_once_schedule_and_lr_match_jax_tool(jt, tiny, tmp_path, monkeypatch):
    """run_once's split, speaker ids, batch schedule and per-step LR, taken
    where each tool hands them to its two-phase training."""
    utt2spk, feats = _fake_corpus()
    seen = {}

    def jax_train(*args, **kw):
        seen["jax"] = args
        raise _Stop

    def port_train(*args, **kw):
        seen["port"] = args
        raise _Stop

    monkeypatch.setattr(jt, "synth_corpus", lambda root: (sorted(utt2spk), utt2spk))
    monkeypatch.setattr(jt, "load_features", lambda d, f: feats)
    monkeypatch.setattr(jt, "train_pkr_two_phase", jax_train)
    monkeypatch.setattr(pe, "synth_corpus", lambda root, cfg: (sorted(utt2spk), utt2spk))
    monkeypatch.setattr(pe, "load_features", lambda d, f, device: feats)
    monkeypatch.setattr(pe, "train_two_phase", port_train)
    cfg = dataclasses.replace(tiny, epochs=2, epochs_softmax=3, lr0=0.1)
    monkeypatch.setattr(jt, "EPOCHS", 2)
    monkeypatch.setattr(jt, "EPOCHS_SOFTMAX", 3)
    monkeypatch.setattr(jt, "LR0", 0.1)
    for call in (lambda: jt.run_once(str(tmp_path), pilot=True),
                 lambda: pe.run_once(str(tmp_path), cfg, device="cpu")):
        with pytest.raises(_Stop):
            call()
    ref, got = seen["jax"], seen["port"]
    steps = (SPK * (UTT - EVAL)) // B
    assert ref[0].shape == (3 * steps, B, F, CROP) and ref[3].shape == (2 * steps, B, F, CROP)
    for i in range(6):  # xs1, ys1, lr1, xs2, ys2, lr2
        np.testing.assert_array_equal(got[i], ref[i])
        assert got[i].dtype == ref[i].dtype
    assert got[6] == ref[6] == SPK
    assert ref[2][0] == 0.1 and ref[2][-1] < ref[2][0]  # a per-epoch cosine


def _trunk_beta(sd, beta):
    """Every trunk BatchNorm's β set to ``beta`` (tests/test_torch_train.py)."""
    sd = dict(sd)
    for k in sd:
        if k.startswith("res.") and k.endswith(".bias") and ".conv" not in k:
            sd[k] = torch.full_like(sd[k], beta)
    return sd


def _flax_inits(jt):
    """The JAX tool's phase models' flax-native inits as port state dicts."""
    sds = []
    for loss in ("softmax", "AAM"):
        _, state = jt._pkr_model_state(loss, SPK)
        sds.append(state_dict_from_flax(jax.tree.map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})))
    return sds


def test_two_phase_training_matches_jax_tool(jt, tiny, monkeypatch):
    """2 softmax + 2 AAM steps from the same weights on the same schedule:
    the embeddings agree at the train test's parameter tolerance; after the
    warm start the AAM weight is the fresh draw and the trunk and fc1 are
    the softmax phase's."""
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((4, B, F, CROP)).astype(np.float32)
    ys = rng.integers(0, SPK, (4, B))
    lr = np.full(2, 0.01)
    sd1, sd2 = _flax_inits(jt)
    sd1 = _trunk_beta(sd1, 0.5)
    fm, state, _ = jt.train_pkr_two_phase(xs[:2], ys[:2], lr, xs[2:], ys[2:], lr, SPK,
                                          init_sd=sd1, aam_init=sd2["last.weight"])
    at = {}
    run_phase = pe.run_phase

    def spy(model, xs_, ys_, lrs, tag, device=None):
        if tag == "aam":
            at["aam_start"] = copy.deepcopy(model.state_dict())
        dt = run_phase(model, xs_, ys_, lrs, tag, device)
        if tag == "softmax":
            at["softmax_end"] = copy.deepcopy(model.state_dict())
        return dt

    monkeypatch.setattr(pe, "run_phase", spy)
    model, _ = pe.train_two_phase(xs[:2], ys[:2], lr, xs[2:], ys[2:], lr, SPK, tiny,
                                  device="cpu", init=(sd1, sd2))
    start, end1 = at["aam_start"], at["softmax_end"]
    assert torch.equal(start["last.weight"], sd2["last.weight"])
    assert not torch.equal(start["last.weight"], end1["last.weight"])
    carried = [k for k in start if k.startswith(("res.", "fc1."))
               and not k.endswith("num_batches_tracked")]  # no pkr_tpu variable
    assert carried and all(torch.equal(start[k], end1[k]) for k in carried)
    feats = {f"u{i}": rng.standard_normal((60, F)).astype(np.float32) for i in range(5)}
    ref = jt.eval_embeddings_pkr(fm, state, feats, sorted(feats))
    got = pe.eval_embeddings(model, feats, sorted(feats), device="cpu")
    for utt in feats:
        np.testing.assert_allclose(got[utt], ref[utt], **EMB_TOL, err_msg=utt)


def test_warm_start_leaves_the_aam_weight_fresh(jt, tiny):
    """pkr_tpu's heads are last/kernel (D, C) and aam_weight (C, D); the
    port's are both last.weight (C, D).  A bare copy by name and shape
    would carry the softmax classifier into the AAM weight; the port's
    rule (by pkr_tpu variable path) gives what the JAX tool's _warm_start
    gives."""
    sd1, sd2 = _flax_inits(jt)
    sd1 = _trunk_beta(sd1, 0.5)
    m1 = pe.new_model("softmax", SPK, tiny, "cpu")
    m1.load_state_dict(sd1, strict=True)
    m2 = pe.new_model("AAM", SPK, tiny, "cpu")
    m2.load_state_dict(sd2, strict=True)
    assert m1.last.weight.shape == m2.last.weight.shape

    bare = copy.deepcopy(m2).state_dict()
    for k, v in m1.state_dict().items():
        if k in bare and bare[k].shape == v.shape:
            bare[k] = v
    assert torch.equal(bare["last.weight"], sd1["last.weight"])  # the trap

    warm_start(m1.state_dict(), m1.loss, m1.trunk, m2, verbose=False)
    _, st1 = jt._pkr_model_state("softmax", SPK, sd1)
    _, st2 = jt._pkr_model_state("AAM", SPK)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": jt._warm_start(st1.params, st2.params),
        "batch_stats": jt._warm_start(st1.batch_stats, st2.batch_stats)}))
    got = m2.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert torch.equal(got["last.weight"], sd2["last.weight"])


@pytest.mark.parametrize("trunk,n_spk,seed", [("tiny_resnet", 12, 3), ("resnet34", 40, 0)])
def test_torch_default_init_is_the_banked_start(jt, monkeypatch, trunk, n_spk, seed):
    """The banked rows' initial weights: the JAX tool's torch softmax
    trainer after torch.manual_seed(seed), then its AAM weight."""
    from test_engine_parity import TorchAAMTrainer

    monkeypatch.setattr(jt, "TRUNK", trunk)
    torch.manual_seed(seed)
    tm1 = jt.make_torch_softmax_trainer(n_spk)
    aam = TorchAAMTrainer(tm1.base, n_spk).last.detach()
    ref = {k.replace("base.", ""): v for k, v in tm1.state_dict().items()}
    cfg = pe.StudyConfig(trunk=trunk, seed=seed, init="torch_default")
    m1 = pe.new_model("softmax", n_spk, cfg, "cpu")
    m2 = pe.new_model("AAM", n_spk, cfg, "cpu")
    pe.torch_default_init(m1, m2, seed)
    got = m1.state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert torch.equal(m2.last.weight.detach(), aam)


def test_score_and_bootstrap_match_jax_tool(jt, monkeypatch):
    """Every (enroll, test) pair of the held-out utterances of 40 speakers,
    scored by each tool from the same embeddings."""
    monkeypatch.setattr(jt, "N_UTT", 8)
    monkeypatch.setattr(jt, "N_EVAL", 4)
    cfg = pe.StudyConfig(n_utt=8, n_eval=4)
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((40, 16))
    utt2spk, embs = {}, {}
    for i in range(40):
        for j in range(4, 8):
            u = f"spk{i:03d}-utt{j:02d}"
            utt2spk[u] = f"spk{i:03d}"
            embs[u] = (centers[i] + 0.9 * rng.standard_normal(16)).astype(np.float32)
    eval_utts = sorted(embs)
    ref = jt.score(embs, eval_utts, utt2spk)
    got = pe.score(embs, eval_utts, utt2spk, cfg, device="cpu")
    assert len(got[0]) == 40 * 120 and int(got[1].sum()) == 120
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2:], ref[2:], rtol=0, atol=1e-9)
    assert 0.0 < got[2] < 0.5
    for n in (37, 200):
        ci_ref, dci_ref = jt.bootstrap_metrics(ref[0], ref[1], n=n)
        ci, dci = pe.bootstrap_metrics(got[0], got[1], n=n)
        np.testing.assert_allclose(ci, ci_ref, rtol=0, atol=1e-9)
        np.testing.assert_allclose(dci, dci_ref, rtol=0, atol=1e-9)


def test_paired_gaps_and_banked_range():
    banked = pe.load_banked()
    assert sorted(banked) == list(range(14))
    eer = [r[f"eer_{c}"] for r in banked.values() for c in "tp"]
    lo, hi = pe.banked_range(banked, "eer")
    assert lo == pytest.approx(np.mean(eer) - 4 * np.std(eer, ddof=1))
    assert hi == pytest.approx(np.mean(eer) + 4 * np.std(eer, ddof=1))
    shift = [0.001, 0.003]
    rows = [dict(seed=s, n_trials=786432, steps=480, eer=banked[s]["eer_p"] + d,
                 dcf1=banked[s]["dcf1_t"]) for s, d in zip((2, 5), shift)]
    rows.append(dict(seed=99, n_trials=786432, steps=480, eer=0.5, dcf1=0.5))  # no bank
    rows.append(dict(seed=1, n_trials=10, steps=480, eer=0.5, dcf1=0.5))  # another study
    gaps = pe.paired_gaps(rows, banked)
    g = gaps["pkr_tpu"]["eer"]
    assert g["n"] == 2 and g["mean"] == pytest.approx(0.002)
    assert g["two_se"] == pytest.approx(2 * np.std(shift, ddof=1) / np.sqrt(2))
    assert gaps["torch"]["dcf1"]["mean"] == pytest.approx(0.0, abs=1e-12)
    one = pe.paired_gaps(rows[:1], banked)["torch"]["eer"]
    assert one["n"] == 1 and one["two_se"] is None
    with pytest.raises(FileNotFoundError):
        pe.load_banked(os.path.join(REPO, "docs", "no_such_rows.jsonl"))


def test_main_writes_rows_and_tables_under_root(tmp_path):
    kept = [os.path.join(REPO, "docs", "parity_rows.jsonl"), os.path.join(REPO, "PARITY_E2E.md")]
    before = [open(p, "rb").read() for p in kept]
    root = str(tmp_path / "study")
    argv = ["--device", "cpu", "--root", root, "--spk", "4", "--utt", "6", "--epochs", "1",
            "--softmax-epochs", "1", "--batch", "4", "--crop", "24", "--trunk",
            "tiny_resnet", "--seeds", "2", "--seed-start", "1",
            "--init", "port", "torch_default"]
    assert pe.main(argv) == 0
    rows = [json.loads(line) for line in open(os.path.join(root, "parity_rows.jsonl"))]
    assert [(r["seed"], r["init"]) for r in rows] == [
        (1, "port"), (1, "torch_default"), (2, "port"), (2, "torch_default")]
    for r in rows:
        assert r["n_trials"] == 4 * 12 and r["steps"] == 2 * ((4 * 2) // 4)
        assert np.isfinite([r["eer"], r["dcf1"], r["dcf2"]]).all()
        assert r["precision"] == {"conv_tf32": False, "matmul_tf32": False}
        assert set(r["seconds"]) == {"synthesis", "features", "training", "scoring",
                                     "bootstrap"}
    doc = open(os.path.join(root, "parity_e2e.md")).read()
    assert "## port init (2 seed(s))" in doc and "## torch_default init (2 seed(s))" in doc
    assert "| port − pkr_tpu | 0 | no seed in common |" in doc  # another study's trials
    assert [open(p, "rb").read() for p in kept] == before
