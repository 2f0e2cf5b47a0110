"""The port's config, presets and scoring back end against pkr_tpu on the CPU.

- Config and presets: every pkr_tpu preset's JSON loads into the port's
  Config equal to the port's preset (compared through dataclasses.asdict),
  and survives a round trip.
- Scoring (pkr_tpu_torch.eval.scoring) against pkr_tpu.eval.scoring on
  seeded embeddings: cohort_topk_stats within 1e-5 in the mean and the std
  (one f32 product on each side, summed in different orders);
  speaker_means, pooled_speaker_means, adaptive_snorm, read_trials and
  write_scores exactly.
- LDA/PLDA (pkr_tpu_torch.eval.plda) against pkr_tpu.eval.plda within 1e-10
  (the same float64 code), and against the literal Kaldi transcriptions of
  tests/kaldi_plda_oracle.py at the bounds tests/test_plda.py holds
  pkr_tpu to.
- The metrics CLI prints what pkr_tpu's prints.
"""

import contextlib
import dataclasses
import io
import subprocess
import sys
import os

import numpy as np
import pytest

import kaldi_plda_oracle as oracle
import pkr_tpu.eval.plda as jplda
import pkr_tpu.eval.scoring as jscore
import pkr_tpu_torch.eval.plda as tplda
import pkr_tpu_torch.eval.scoring as tscore
from pkr_tpu.config import Config as JaxConfig
from pkr_tpu.recipes.presets import PRESETS as JAX_PRESETS
from pkr_tpu_torch.config import Config
from pkr_tpu_torch.recipes.presets import PRESETS
from test_plda import _unbalanced_corpus, synth_speakers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_load_from_pkr_tpu_json(name):
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    ours = PRESETS[name]()
    got = Config.from_json(JAX_PRESETS[name]().to_json())
    assert dataclasses.asdict(got) == dataclasses.asdict(ours)
    again = Config.from_json(got.to_json())
    assert again == got
    # and back: the port's JSON loads into pkr_tpu's Config unchanged
    assert (dataclasses.asdict(JaxConfig.from_json(ours.to_json()))
            == dataclasses.asdict(JAX_PRESETS[name]()))


def _embeddings(n, d, seed, prefix="u"):
    rng = np.random.default_rng(seed)
    return {f"{prefix}{i:03d}": rng.standard_normal(d).astype(np.float32)
            for i in range(n)}


@pytest.mark.parametrize("with_mean,topk", [(False, 300), (True, 7), (True, 1000)])
def test_cohort_topk_stats_matches_pkr_tpu(with_mean, topk):
    vecs = _embeddings(40, 24, seed=1)
    cohort = np.random.default_rng(2).standard_normal((500, 24)).astype(np.float32)
    mean = tscore.global_mean(vecs) if with_mean else None
    got = tscore.cohort_topk_stats(vecs, cohort, topk, mean, device="cpu")
    ref = jscore.cohort_topk_stats(vecs, cohort, topk, mean)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)
    assert all(isinstance(v, float) for pair in got.values() for v in pair)


def test_means_and_snorm_match_pkr_tpu():
    vecs = _embeddings(30, 16, seed=3)
    utt2spk = {u: f"s{i % 7}" for i, u in enumerate(vecs)}
    got, ref = tscore.speaker_means(vecs, utt2spk), jscore.speaker_means(vecs, utt2spk)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    spk2utt = {}
    for u, s in utt2spk.items():
        spk2utt.setdefault(s, []).append(u)
    spk2utt["missing"] = ["nope"]
    got = tscore.pooled_speaker_means(vecs, spk2utt)
    ref = jscore.pooled_speaker_means(vecs, spk2utt)
    assert list(got) == list(ref) and "missing" not in got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])

    rng = np.random.default_rng(4)
    keys = list(vecs)
    trials = [(keys[i], keys[j]) for i in range(10) for j in range(10, 20)]
    scores = rng.standard_normal(len(trials))
    stats = {k: (float(rng.normal()), float(rng.uniform(0, 1))) for k in keys}
    stats[keys[0]] = (0.1, 0.0)  # σ floored at 1e-8
    np.testing.assert_array_equal(tscore.adaptive_snorm(scores, trials, stats, stats),
                                  jscore.adaptive_snorm(scores, trials, stats, stats))


def test_trial_files_match_pkr_tpu(tmp_path):
    p = tmp_path / "trials"
    p.write_text("e1 t1 target\ne2 t2 nontarget\n\ne3 t1 target\n")
    assert tscore.read_trials(str(p)) == jscore.read_trials(str(p))
    for text in ("e1 t1 target\ne2 t2\n", "e1 t1\ne2 t2 target\n"):
        p.write_text(text)
        with pytest.raises(ValueError) as got:
            tscore.read_trials(str(p))
        with pytest.raises(ValueError) as ref:
            jscore.read_trials(str(p))
        assert str(got.value) == str(ref.value)
    p.write_text("e1 t1\ne2 t2\n")
    assert tscore.read_trials(str(p)) == ([("e1", "t1"), ("e2", "t2")], [])
    trials = [("a", "b"), ("c", "d"), ("e", "f")]
    scores = np.asarray([0.1, -2.5e-7, 3.0], np.float32)
    tscore.write_scores(str(tmp_path / "got"), trials, scores)
    jscore.write_scores(str(tmp_path / "ref"), trials, scores)
    assert (tmp_path / "got").read_bytes() == (tmp_path / "ref").read_bytes()


def test_lda_plda_match_pkr_tpu():
    vecs, utt2spk, _ = synth_speakers(n_spk=12, n_utt=6, d=10, seed=5)
    x = np.stack(list(vecs.values()))
    np.testing.assert_allclose(tplda.length_normalize(x), jplda.length_normalize(x),
                               rtol=1e-10, atol=1e-12)
    for f in (0.0, 0.1):
        got = tplda.compute_lda(vecs, utt2spk, dim=6, total_covariance_factor=f)
        ref = jplda.compute_lda(vecs, utt2spk, dim=6, total_covariance_factor=f)
        np.testing.assert_allclose(got.matrix, ref.matrix, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got.apply(x), ref.apply(x), rtol=1e-10, atol=1e-12)
    proj = {k: tplda.length_normalize(got.apply(v)) for k, v in vecs.items()}
    model = tplda.train_plda(proj, utt2spk)
    ref_model = jplda.train_plda(proj, utt2spk)
    for name in ("mean", "transform", "psi"):
        np.testing.assert_allclose(getattr(model, name), getattr(ref_model, name),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    keys = list(proj)
    trials = [(a, b) for a in keys[:8] for b in keys[-8:]]
    enroll = {k: proj[k] for k in keys[:8]}
    test = {k: proj[k] for k in keys[-8:]}
    counts = {k: 1 + i % 3 for i, k in enumerate(enroll)}
    for kw in ({}, {"enroll_counts": counts}, {"simple_length_norm": True}):
        np.testing.assert_allclose(tplda.plda_scores(model, enroll, test, trials, **kw),
                                   jplda.plda_scores(ref_model, enroll, test, trials, **kw),
                                   rtol=1e-10, atol=1e-10, err_msg=str(kw))


def test_lda_plda_match_kaldi_oracle():
    """The oracle bounds of tests/test_plda.py."""
    vecs, utt2spk, spk2utt = _unbalanced_corpus()
    for iters in (1, 10):
        model = tplda.train_plda(vecs, utt2spk, n_iters=iters)
        ref = oracle.ivector_compute_plda(spk2utt, vecs, num_em_iters=iters)
        np.testing.assert_allclose(model.mean, ref.mean, rtol=1e-10)
        np.testing.assert_allclose(model.psi, ref.psi, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(model.transform, ref.transform, rtol=1e-6, atol=1e-8)
    keys = sorted(vecs)
    trials = [(a, b) for a in keys[:6] for b in keys[-6:]]
    enroll, test = {k: vecs[k] for k in keys[:6]}, {k: vecs[k] for k in keys[-6:]}
    np.testing.assert_allclose(tplda.plda_scores(model, enroll, test, trials),
                               oracle.ivector_plda_scoring(ref, enroll, test, trials),
                               rtol=1e-7, atol=1e-9)
    vecs, utt2spk, _ = _unbalanced_corpus(n_spk=12, d=9, seed=13)
    for f in (0.0, 0.1):
        lda = tplda.compute_lda(vecs, utt2spk, dim=5, total_covariance_factor=f)
        ref_mat, ref_mean = oracle.ivector_compute_lda(
            vecs, utt2spk, lda_dim=5, total_covariance_factor=f)
        np.testing.assert_allclose(lda.mean, ref_mean, rtol=1e-12)
        got, want = np.asarray(lda.matrix), np.asarray(ref_mat)
        for i in range(got.shape[0]):  # eigenvector signs are free
            j = np.argmax(np.abs(want[i]))
            if np.sign(got[i, j]) != np.sign(want[i, j]):
                got[i] = -got[i]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_metrics_cli_matches_pkr_tpu(tmp_path):
    rng = np.random.default_rng(6)
    trials, scores = tmp_path / "trials", tmp_path / "scores"
    with open(trials, "w") as t, open(scores, "w") as s:
        for i in range(200):
            tgt = i % 4 == 0
            t.write(f"e{i} t{i} {'target' if tgt else 'nontarget'}\n")
            s.write(f"e{i} t{i} {rng.normal(1.0 if tgt else 0.0)}\n")
    from pkr_tpu.eval.metrics import _cli as jax_cli
    from pkr_tpu_torch.eval.metrics import _cli

    printed = {}
    for extra in ((), ("--p-target", "0.01"), ("--p-target", "0.05", "--c-miss", "10")):
        out = []
        for cli in (_cli, jax_cli):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli([*extra, str(scores), str(trials)]) == 0
            out.append(buf.getvalue())
        assert out[0] == out[1] and out[0].strip(), extra
        printed[extra] = out[0]
    # the module runs as a script and prints the same
    proc = subprocess.run([sys.executable, "-m", "pkr_tpu_torch.eval.metrics", "--p-target",
                           "0.01", str(scores), str(trials)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == printed[("--p-target", "0.01")]
    from pkr_tpu.eval.metrics import scores_and_labels_from_files as jsl
    from pkr_tpu_torch.eval.metrics import scores_and_labels_from_files as tsl

    assert tsl(str(scores), str(trials)) == jsl(str(scores), str(trials))
    with open(scores, "a") as s:
        s.write("x y 0.5\n")
    with pytest.raises(KeyError, match="Missing trial entry"):
        tsl(str(scores), str(trials))
