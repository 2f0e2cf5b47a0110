"""The port's recipe driver (pkr_tpu_torch.recipes.run) against
pkr_tpu.recipes.run on the CPU, on tests/test_e2e.py's synthetic corpus.

Stage by stage, the same inputs through both packages:
- run_features at dither 0: the same utterances, utt2num_frames and VAD
  decisions; the decoded features within the frontend's 2e-4
  (tests/test_torch_frontend.py) plus one CM code step of their column: each
  package CM-compresses its own features, and two values 2e-4 apart can
  land one code apart.  The step is the widest of the column's three
  quantization bins in the reference's percentile table, max((p25 − p0)/64,
  (p75 − p25)/128, (p100 − p75)/63);
- run_split: byte-identical files;
- run_train from one shared .pth init, which both packages load through
  their own import_torch_checkpoint, on the host TrainLoader (the same numpy
  batches in both) with an f32 trunk (each package's build_model patched),
  2 epochs with the dense head and with the flash head: the final
  parameters, momentum and BatchNorm statistics within
  tests/test_torch_train.py's bounds, the same 'latest' and 'best', and the
  cv metrics of each epoch (loss at its 2e-4, top-1/top-5 exactly);
- run_extract from one checkpoint: embeddings within 1e-4 of their largest
  entry;
- run_backend_stats and run_score with each backend on the same arks:
  mean.vec and the speaker means exactly, the cohort statistics and the
  scores within 1e-5, EER and minDCF within one trial's step.
Then main through the port alone, mirroring tests/test_e2e.py: the full
pipeline learns (EER < 0.35), resume runs only the next epoch, training
from the card-resident cache, and the softmax_plda flow with PLDA scoring.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pkr_tpu.recipes.run as jrun
import pkr_tpu_torch.recipes.run as trun
from pkr_tpu.config import Config as JaxConfig
from pkr_tpu.train import create_train_state as jax_create_train_state
from pkr_tpu.train import restore_checkpoint as jax_restore
from pkr_tpu.train.checkpoint import save_checkpoint as jax_save
from pkr_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from pkr_tpu_torch.convert import train_state_from_flax
from pkr_tpu_torch.eval import compute_eer, cosine_scores, speaker_means
from pkr_tpu_torch.io import DataDir, kaldi_ark, load_text_vec_ark
from pkr_tpu_torch.recipes.presets import PRESETS
from pkr_tpu_torch.train import restore_checkpoint, save_checkpoint

from test_e2e import synth_corpus
from test_torch_train import LOSS_TOL, assert_state_matches

MIN_FRAMES, CV = 50, 0.3


def tiny_cfg(**train):
    kw = dict(epochs=2, batch_size=8, lr=0.01, chunk_size=(50,), seed=0, print_freq=1000)
    kw.update(train)
    return Config(model=ModelConfig(trunk="tiny_resnet", loss="AAM"),
                  train=TrainConfig(**kw),
                  eval=EvalConfig(backend="cosine", bucket_quantum=50, max_len=150,
                                  batch_size=4, lda_dim=16),
                  data=DataConfig(min_frames=MIN_FRAMES, cv_fraction=CV))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Train and test data dirs, and the port's stage-1 and stage-2 output."""
    root = tmp_path_factory.mktemp("recipe")
    data, test = str(root / "data"), str(root / "test")
    synth_corpus(data, n_spk=4, n_utt=8, seconds=1.0)
    synth_corpus(test, n_spk=4, n_utt=3, seconds=1.0, seed=3)
    feats = str(root / "feats")
    trun.run_features(data, feats, batch=4, dither=0.0, device="cpu")
    num_spk = trun.run_split(feats, data, MIN_FRAMES, CV, 0)
    test_feats = str(root / "feats_test")
    trun.run_features(test, test_feats, batch=4, dither=0.0, device="cpu")
    return {"root": root, "data": data, "test": test, "feats": feats,
            "test_feats": test_feats, "num_spk": num_spk}


def _table(path):
    return dict(line.split(None, 1) for line in open(path).read().splitlines())


def test_run_features_matches_pkr_tpu(corpus):
    ref_dir = str(corpus["root"] / "feats_jax")
    jrun.run_features(corpus["data"], ref_dir, batch=4, dither=0.0)
    got_dir = corpus["feats"]
    assert (open(os.path.join(got_dir, "utt2num_frames")).read()
            == open(os.path.join(ref_dir, "utt2num_frames")).read())
    got_scp = _table(os.path.join(got_dir, "feats.scp"))
    ref_scp = _table(os.path.join(ref_dir, "feats.scp"))
    assert list(got_scp) == list(ref_scp) and len(got_scp) == 32
    got_vad = _table(os.path.join(got_dir, "vad.scp"))
    ref_vad = _table(os.path.join(ref_dir, "vad.scp"))
    for utt in ref_scp:
        np.testing.assert_array_equal(kaldi_ark.read_vec_flt(got_vad[utt]),
                                      kaldi_ark.read_vec_flt(ref_vad[utt]))
        got, ref = kaldi_ark.read_mat(got_scp[utt]), kaldi_ark.read_mat(ref_scp[utt])
        assert got.shape == ref.shape and got.shape[1] == 40
        _, pct = kaldi_ark.read_mat_codes(ref_scp[utt])
        step = np.max([(pct[1] - pct[0]) / 64, (pct[2] - pct[1]) / 128,
                       (pct[3] - pct[2]) / 63], axis=0)
        excess = np.abs(got - ref) - (step + 2e-4 * (1 + np.abs(ref)))
        assert excess.max() <= 0, (utt, float(excess.max()))


def test_run_split_matches_pkr_tpu(corpus, tmp_path):
    ref_dir = str(tmp_path / "feats")
    shutil.copytree(corpus["feats"], ref_dir, ignore=shutil.ignore_patterns("train", "cv",
                                                                             "num_spk"))
    assert jrun.run_split(ref_dir, corpus["data"], MIN_FRAMES, CV, 0) == corpus["num_spk"]
    for sub in ("train", "cv"):
        names = sorted(os.listdir(os.path.join(ref_dir, sub)))
        assert names == sorted(os.listdir(os.path.join(corpus["feats"], sub)))
        assert "utt2spkid" in names
        for name in names:
            with open(os.path.join(ref_dir, sub, name), "rb") as a, \
                    open(os.path.join(corpus["feats"], sub, name), "rb") as b:
                assert a.read() == b.read(), (sub, name)
    assert (open(os.path.join(ref_dir, "num_spk")).read()
            == open(os.path.join(corpus["feats"], "num_spk")).read())


def _f32_builders(monkeypatch):
    """Patch both packages' build_model to an f32 trunk; returns them."""
    jax_build, port_build = jrun.build_model, trun.build_model
    monkeypatch.setattr(jrun, "build_model",
                        lambda c, n: jax_build(c, n).clone(dtype=jnp.float32))
    monkeypatch.setattr(trun, "build_model",
                        lambda c, n, device=None, dtype=None, generator=None:
                        port_build(c, n, device, torch.float32, generator))
    return jrun.build_model, trun.build_model


def _jax_template(build, cfg, num_spk):
    return jax_create_train_state(build(cfg.model, num_spk), jax.random.key(0),
                                  jnp.zeros((2, cfg.model.feat_dim, 50)),
                                  jnp.zeros((2,), jnp.int32))


def _cv_records(exp_dir):
    lines = [json.loads(l) for l in open(os.path.join(exp_dir, "train_metrics.jsonl"))]
    return [(r["epoch"], r["loss"], r["acc1"], r["acc5"]) for r in lines if "CV" in r["msg"]]


@pytest.mark.parametrize("flash", [False, True])
def test_run_train_matches_pkr_tpu(corpus, tmp_path, monkeypatch, flash):
    jbuild, tbuild = _f32_builders(monkeypatch)
    init = trun.build_model(tiny_cfg().model, corpus["num_spk"], "cpu",
                            generator=torch.Generator().manual_seed(11))
    torch.save(init.state_dict(), str(tmp_path / "init.pth"))
    cfg = tiny_cfg(flash_aam=flash, pretrained=str(tmp_path / "init.pth"))
    exp_j, exp_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jrun.run_train(JaxConfig.from_json(cfg.to_json()), corpus["feats"], exp_j)
    trun.run_train(cfg, corpus["feats"], exp_t, device="cpu")

    cv_j, cv_t = _cv_records(exp_j), _cv_records(exp_t)
    assert [r[0] for r in cv_t] == [r[0] for r in cv_j] == [0, 1]
    np.testing.assert_allclose([r[1] for r in cv_t], [r[1] for r in cv_j], **LOSS_TOL)
    assert [r[2:] for r in cv_t] == [r[2:] for r in cv_j]
    ck_j, ck_t = os.path.join(exp_j, "checkpoints"), os.path.join(exp_t, "checkpoints")
    assert open(os.path.join(ck_t, "latest")).read() == open(os.path.join(ck_j, "latest")).read()
    template = _jax_template(jbuild, cfg, corpus["num_spk"])
    model = tbuild(cfg.model, corpus["num_spk"], "cpu")
    for which in ("best", "latest"):
        jstate = jax_restore(ck_j, template, which=which)
        state = restore_checkpoint(ck_t, model, which=which)
        assert state.epoch == int(jstate.epoch) and int(state.step) == int(jstate.step)
        np.testing.assert_allclose(state.best_acc1, float(jstate.best_acc1), rtol=1e-6)
    assert_state_matches(jstate, model, state)


@pytest.fixture(scope="module")
def extracted(corpus, tmp_path_factory):
    """One AAM checkpoint in both packages' formats (pkr_tpu's f32 init,
    carried over), and both packages' run_extract of the train split (a
    subset of 10) and the test dir."""
    root = tmp_path_factory.mktemp("extract")
    mp = pytest.MonkeyPatch()
    jbuild, _ = _f32_builders(mp)
    cfg = tiny_cfg()
    jstate = _jax_template(jbuild, cfg, corpus["num_spk"])
    exp = {"jax": str(root / "jax"), "port": str(root / "port")}
    jax_save(os.path.join(exp["jax"], "checkpoints"), jstate, is_best=True)
    sd, tstate = train_state_from_flax(jax.tree.map(np.asarray, jstate))
    model = trun.build_model(cfg.model, corpus["num_spk"], "cpu")
    model.load_state_dict(sd)
    save_checkpoint(os.path.join(exp["port"], "checkpoints"), model, tstate, is_best=True)
    for name, (mod, kw) in {"jax": (jrun, {}), "port": (trun, {"device": "cpu"})}.items():
        cfg_ = cfg if name == "port" else JaxConfig.from_json(cfg.to_json())
        mod.run_extract(cfg_, corpus["feats"], exp[name],
                        os.path.join(corpus["feats"], "train", "feats.scp"), "train.iv",
                        subset=10, **kw)
        mod.run_extract(cfg_, corpus["feats"], exp[name],
                        os.path.join(corpus["test_feats"], "feats.scp"), "test.iv", **kw)
    mp.undo()
    return exp


def test_run_extract_matches_pkr_tpu(extracted):
    for ark, n in (("train.iv", 10), ("test.iv", 12)):
        got = load_text_vec_ark(os.path.join(extracted["port"], ark))
        ref = load_text_vec_ark(os.path.join(extracted["jax"], ark))
        assert sorted(got) == sorted(ref) and len(ref) == n
        for k in ref:
            assert np.abs(got[k] - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), (ark, k)
    assert (open(os.path.join(extracted["port"], "decode_train.iv.scp")).read()
            == open(os.path.join(extracted["jax"], "decode_train.iv.scp")).read())


def _same_arks(extracted, tmp_path):
    """Both packages' exp dirs holding pkr_tpu's arks."""
    exp = {}
    for name in ("jax", "port"):
        exp[name] = str(tmp_path / name)
        os.makedirs(exp[name])
        for ark in ("train.iv", "test.iv"):
            shutil.copy(os.path.join(extracted["jax"], ark), exp[name])
    return exp


def test_backend_stats_match_pkr_tpu(corpus, extracted, tmp_path):
    exp = _same_arks(extracted, tmp_path)
    cfg = tiny_cfg()
    jrun.run_backend_stats(JaxConfig.from_json(cfg.to_json()), exp["jax"], corpus["data"])
    trun.run_backend_stats(cfg, exp["port"], corpus["data"], device="cpu")
    for name in ("mean.vec", "spk_xvector.iv"):
        with open(os.path.join(exp["port"], name), "rb") as a, \
                open(os.path.join(exp["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    got = _table(os.path.join(exp["port"], "topk_mean_std"))
    ref = _table(os.path.join(exp["jax"], "topk_mean_std"))
    assert list(got) == list(ref) and len(ref) == 12
    for k in ref:
        np.testing.assert_allclose(np.array(got[k].split(), float),
                                   np.array(ref[k].split(), float), rtol=0, atol=1e-5)


def _dcf_step(labels, p):
    n_tgt = sum(labels)
    n_non = len(labels) - n_tgt
    return max(p / n_tgt, (1 - p) / n_non) / min(p, 1 - p)


@pytest.mark.parametrize("backend", ["cosine", "snorm", "plda", "pool"])
def test_run_score_matches_pkr_tpu(corpus, extracted, tmp_path, backend):
    exp = _same_arks(extracted, tmp_path)
    test_u2s = DataDir.load(corpus["test"], names=("utt2spk",))["utt2spk"]
    utts = sorted(test_u2s)
    trials = tmp_path / "trials"
    with open(trials, "w") as f:
        if backend == "pool":  # enroll keys are speakers
            pairs = [(s, u) for s in sorted(set(test_u2s.values())) for u in utts]
            f.writelines(f"{s} {u} {'target' if test_u2s[u] == s else 'nontarget'}\n"
                         for s, u in pairs)
        else:
            f.writelines(f"{a} {b} {'target' if test_u2s[a] == test_u2s[b] else 'nontarget'}\n"
                         for a in utts for b in utts if a < b)
    cfg = dataclasses.replace(tiny_cfg(), eval=dataclasses.replace(tiny_cfg().eval,
                                                                   backend=backend, topk=3))
    u2s = DataDir.load(corpus["data"], names=("utt2spk",))["utt2spk"]
    s2u = {s: v.split() for s, v in DataDir.load(corpus["test"], names=("utt2spk",))
           .make_spk2utt()["spk2utt"].items()}
    results = {}
    for name, mod, c, kw in (("jax", jrun, JaxConfig.from_json(cfg.to_json()), {}),
                             ("port", trun, cfg, {"device": "cpu"})):
        test_ark = os.path.join(exp[name], "test.iv")
        results[name] = mod.run_score(c, exp[name], str(trials), test_ark, test_ark,
                                      cohort_ark=os.path.join(exp[name], "train.iv"),
                                      cohort_utt2spk=u2s, enroll_spk2utt=s2u, **kw)
    got = _table(os.path.join(exp["port"], "scores.txt"))
    ref = _table(os.path.join(exp["jax"], "scores.txt"))
    assert list(got) == list(ref)
    np.testing.assert_allclose([float(v.split()[-1]) for v in got.values()],
                               [float(v.split()[-1]) for v in ref.values()], rtol=0, atol=1e-5)
    labels = [1 if l.split()[2] == "target" else 0 for l in open(trials)]
    assert sorted(results["port"]) == sorted(results["jax"])
    assert abs(results["port"]["eer"] - results["jax"]["eer"]) <= (
        1.0 / min(sum(labels), len(labels) - sum(labels)) + 1e-12)
    for p in cfg.eval.p_targets:
        key = f"min_dcf_p{p}"
        assert abs(results["port"][key] - results["jax"][key]) <= _dcf_step(labels, p) + 1e-12
    assert json.load(open(os.path.join(exp["port"], "results.json"))) == results["port"]


def _main(*args, config=None, preset=None):
    argv = ["--device", "cpu", *args]
    if config is not None:
        argv += ["--config", config]
    if preset is not None:
        argv += ["--preset", preset]
    assert trun.main(argv) == 0


def test_main_full_pipeline(tmp_path):
    """test_e2e.py's test_full_pipeline through the port's CLI (stages 0–6,
    the aam_cpu_debug preset) and its stage functions."""
    data, test, exp = str(tmp_path / "data"), str(tmp_path / "test"), str(tmp_path / "exp")
    synth_corpus(data)
    synth_corpus(test, n_utt=2, seed=3)
    t_u2s = DataDir.load(test, names=("utt2spk",))["utt2spk"]
    with open(tmp_path / "trials", "w") as f:
        f.writelines(f"{a} {b} {'target' if t_u2s[a] == t_u2s[b] else 'nontarget'}\n"
                     for a in sorted(t_u2s) for b in sorted(t_u2s) if a < b)
    _main("--data-dir", data, "--test-data-dir", test, "--trials", str(tmp_path / "trials"),
          "--exp-dir", exp, preset="aam_cpu_debug")
    res = json.load(open(os.path.join(exp, "results.json")))
    assert 0.0 <= res["eer"] <= 1.0
    assert open(os.path.join(exp, "checkpoints", "latest")).read() == "ckpt_3"
    for name in ("mean.vec", "spk_xvector.iv", "topk_mean_std", "scores.txt"):
        assert os.path.exists(os.path.join(exp, name)), name
    # cv utterances against the train speakers' means (test_full_pipeline)
    cfg = PRESETS["aam_cpu_debug"]()
    feats = os.path.join(exp, "feats")
    trun.run_extract(cfg, feats, exp, os.path.join(feats, "cv", "feats.scp"), "cv.iv",
                     device="cpu")
    utt2spk = DataDir.load(data, names=("utt2spk",))["utt2spk"]
    enroll = speaker_means(load_text_vec_ark(os.path.join(exp, "train.iv")), utt2spk)
    cv = load_text_vec_ark(os.path.join(exp, "cv.iv"))
    pairs = [(s, u) for u in cv for s in enroll]
    scores = cosine_scores(enroll, cv, pairs, device="cpu")
    eer = compute_eer(scores.tolist(), [int(utt2spk[u] == s) for s, u in pairs])
    assert eer < 0.35, f"EER {eer}: the pipeline is not learning"


def test_main_resume_and_device_cache(corpus, tmp_path):
    """test_e2e.py's test_recipe_resume (resume runs only the next epoch) and
    test_recipe_device_cache_training, through main."""
    exp = str(tmp_path / "exp")
    shutil.copytree(corpus["feats"], os.path.join(exp, "feats"))
    args = ("--data-dir", corpus["data"], "--exp-dir", exp, "--stage", "3",
            "--stop-stage", "3")
    cfg_path = str(tmp_path / "cfg.json")
    for train in ({"epochs": 2}, {"epochs": 3, "resume": True}):
        open(cfg_path, "w").write(tiny_cfg(lr=0.1, **train).to_json())
        _main(*args, config=cfg_path)
        assert (open(os.path.join(exp, "checkpoints", "latest")).read()
                == f"ckpt_{train['epochs']}")
    assert [r[0] for r in _cv_records(exp)] == [0, 1, 2]  # the resume ran epoch 2 only

    exp2 = str(tmp_path / "exp_cache")
    shutil.copytree(corpus["feats"], os.path.join(exp2, "feats"))
    open(cfg_path, "w").write(tiny_cfg(epochs=1, device_cache=True, flash_aam=True,
                                       print_freq=1).to_json())
    _main("--data-dir", corpus["data"], "--exp-dir", exp2, "--stage", "3",
          "--stop-stage", "3", config=cfg_path)
    assert os.path.exists(os.path.join(exp2, "checkpoints", "latest"))
    losses = [json.loads(l)["loss"] for l in open(os.path.join(exp2, "train_metrics.jsonl"))]
    assert len(losses) > 1 and np.isfinite(losses).all()


def test_main_softmax_plda_flow_then_aam_warm_start(tmp_path):
    """test_e2e.py's test_cli_softmax_plda_preset_flow through the port's
    CLI, then an AAM run warm-started from it (the aam_v2 preset's
    pretrained) and the other backends on its embeddings."""
    data, test = str(tmp_path / "data"), str(tmp_path / "test")
    synth_corpus(data, n_spk=4, n_utt=6, seconds=1.0)
    synth_corpus(test, n_spk=4, n_utt=2, seconds=1.0, seed=3)
    t_u2s = DataDir.load(test, names=("utt2spk",))["utt2spk"]
    with open(tmp_path / "trials", "w") as f:
        f.writelines(f"{a} {b} {'target' if t_u2s[a] == t_u2s[b] else 'nontarget'}\n"
                     for a in sorted(t_u2s) for b in sorted(t_u2s) if a < b)
    base = PRESETS["softmax_plda"]()
    assert base.model.loss == "softmax" and base.eval.backend == "plda"
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, trunk="tiny_resnet"),
        train=dataclasses.replace(base.train, epochs=2, batch_size=8, chunk_size=(50,),
                                  print_freq=1000),
        eval=dataclasses.replace(base.eval, lda_dim=16, bucket_quantum=50, max_len=150,
                                 batch_size=4),
        data=DataConfig(min_frames=50, cv_fraction=0.25))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    exp = str(tmp_path / "exp")
    common = ("--data-dir", data, "--test-data-dir", test, "--trials",
              str(tmp_path / "trials"))
    _main(*common, "--exp-dir", exp, config=str(tmp_path / "cfg.json"))
    res = json.load(open(os.path.join(exp, "results.json")))
    assert 0.0 <= res["eer"] <= 1.0 and np.isfinite(res["eer"])
    assert os.path.exists(os.path.join(exp, "mean.vec"))

    aam = PRESETS["aam_v2"]()
    cfg2 = dataclasses.replace(
        cfg, model=dataclasses.replace(aam.model, trunk="tiny_resnet"),
        train=dataclasses.replace(cfg.train, pretrained=os.path.join(exp, "checkpoints"),
                                  epochs=1),
        eval=dataclasses.replace(cfg.eval, backend="snorm", topk=3))
    (tmp_path / "cfg2.json").write_text(cfg2.to_json())
    exp2 = str(tmp_path / "exp2")
    shutil.copytree(os.path.join(exp, "feats"), os.path.join(exp2, "feats"))
    shutil.copytree(os.path.join(exp, "feats_test"), os.path.join(exp2, "feats_test"))
    _main(*common, "--exp-dir", exp2, "--stage", "2", config=str(tmp_path / "cfg2.json"))
    for backend in ("cosine", "plda"):
        _main(*common, "--exp-dir", exp2, "--stage", "6", "--backend", backend,
              config=str(tmp_path / "cfg2.json"))
        res = json.load(open(os.path.join(exp2, "results.json")))
        assert 0.0 <= res["eer"] <= 1.0 and np.isfinite(res["min_dcf_p0.01"])


def test_unported_options_raise(corpus, tmp_path):
    with pytest.raises(NotImplementedError, match="A.5"):
        _main("--data-dir", corpus["data"], "--musan-dir", str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.5"):
        trun.run_features(corpus["data"], str(tmp_path / "f"), pools=object(), device="cpu")
    with pytest.raises(ValueError, match="A.11"):
        trun.run_train(tiny_cfg(model_parallel=2), corpus["feats"], str(tmp_path),
                       device="cpu")
