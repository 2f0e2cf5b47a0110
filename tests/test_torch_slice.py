"""The port's first slice end to end on the CPU, against pkr_tpu.

wavs → frontend → tiny_resnet speaker model (AAM head) → eval step, dense
and flash → extraction → cosine scoring → EER, through both packages with
the same inputs (numpy, from a seed) and the same weights
(convert.state_dict_from_flax).  Tolerances: features 2e-4 and embeddings
5e-4 as in test_torch_frontend.py and test_torch_model.py; eval losses
within 1e-4 per example (the flash bar of tests/test_flash_aam.py); top-k
counts, the trial scores' ordering and the EER exactly.

Also the package's rules: it imports neither JAX nor pkr_tpu, and an entry
point called without a device on a machine with no card raises.
"""

import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pkr_tpu.frontend as jf
import pkr_tpu_torch.frontend as tf
from pkr_tpu.eval.extract import extract_embeddings as jax_extract
from pkr_tpu.eval.metrics import compute_eer as jax_compute_eer
from pkr_tpu.eval.scoring import cosine_scores as jax_cosine_scores
from pkr_tpu.models import SpeakerModel as FlaxSpeakerModel
from pkr_tpu.train.loop import make_eval_step as jax_make_eval_step
from pkr_tpu_torch.convert import state_dict_from_flax
from pkr_tpu_torch.data import BalancedRepetitionSampler, DeviceCacheLoader, DeviceFeatureCache
from pkr_tpu_torch.eval import cohort_topk_stats, compute_eer, cosine_scores, extract_embeddings
from pkr_tpu_torch.models import SpeakerModel
from pkr_tpu_torch.recipes.run import main as recipe_main
from pkr_tpu_torch.train import make_eval_step, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPK = 12
B = 6


def make_wavs(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5000, 8000, B)
    wav = np.zeros((B, int(lengths.max())), np.float32)
    freqs = rng.uniform(80, 300, B)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        wav[i, :n] = (3000 * np.sin(2 * np.pi * freqs[i] * t)
                      + 400 * rng.standard_normal(n))
    return wav, lengths


def test_slice_matches_pkr_tpu():
    wav, lengths = make_wavs()
    fcfg = jf.FrontendConfig(fbank=jf.FbankConfig(dither=0.0))
    tcfg = tf.FrontendConfig(fbank=tf.FbankConfig(dither=0.0))
    feats_j, mask_j, _ = jf.wav_to_train_feats(jnp.asarray(wav), jnp.asarray(lengths),
                                               None, fcfg)
    feats_t, mask_t, _ = tf.wav_to_train_feats(wav, lengths, None, tcfg, device="cpu")
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    x_j = np.asarray(jnp.transpose(feats_j, (0, 2, 1)))
    x_t = feats_t.permute(0, 2, 1).contiguous()

    fm = FlaxSpeakerModel(spk_num=SPK, feat_dim=40, trunk="tiny_resnet", loss="AAM",
                          dtype=jnp.float32)
    variables = fm.init(jax.random.key(0), jnp.zeros((1, 40, 32)), train=False)
    variables = jax.tree.map(np.asarray, variables)
    tm = SpeakerModel(SPK, 40, loss="AAM", trunk="tiny_resnet", dtype=torch.float32,
                      device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)

    labels = np.random.default_rng(1).integers(0, SPK, B)
    State = collections.namedtuple("State", "params batch_stats")
    state = State(variables["params"], variables["batch_stats"])
    for flash in (False, True):
        ref = jax_make_eval_step(fm, flash_aam=flash, flash_interpret=True)(
            state, jnp.asarray(x_j), jnp.asarray(labels))
        got = make_eval_step(tm, flash_aam=flash, device="cpu")(x_t, labels)
        assert abs(float(got["loss"]) - float(ref["loss"])) < 1e-4 * B, (flash, got, ref)
        for k in ("n1", "n5", "n"):
            assert float(got[k]) == float(ref[k]), (flash, k, got, ref)
    flash_t = make_eval_step(tm, flash_aam=True, device="cpu")(x_t, labels)
    dense_t = make_eval_step(tm, flash_aam=False, device="cpu")(x_t, labels)
    assert abs(float(flash_t["loss"]) - float(dense_t["loss"])) < 1e-4 * B

    keys = [f"utt{i}" for i in range(B)]
    # two batches; the second holds two segments of one utterance ('##')
    loader_t = [(keys[:4], x_t[:4], mask_t[:4]),
                (keys[4:] + ["utt0##0", "utt0##1"],
                 torch.cat([x_t[4:], x_t[:1], x_t[1:2]]),
                 torch.cat([mask_t[4:], mask_t[:1], mask_t[1:2]]))]
    loader_j = [(k, np.asarray(f), np.asarray(m)) for k, f, m in loader_t]
    emb_t = extract_embeddings(tm, loader_t, device="cpu")
    emb_j = jax_extract(fm, variables, loader_j)
    assert sorted(emb_t) == sorted(emb_j)
    for k in emb_j:
        np.testing.assert_allclose(emb_t[k], emb_j[k], rtol=5e-4, atol=5e-4)

    enroll = {k: emb_t[k] for k in keys[:3]}
    test = {k: emb_t[k] for k in keys[3:]}
    trials = [(a, b) for a in enroll for b in test]
    trial_labels = [1 if (i + j) % 3 == 0 else 0 for i in range(3) for j in range(3)]
    mean = np.mean(np.stack(list(emb_t.values())), axis=0)
    s_t = cosine_scores(enroll, test, trials, mean, device="cpu")
    s_j = jax_cosine_scores({k: emb_j[k] for k in enroll}, {k: emb_j[k] for k in test},
                            trials, mean)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.argsort(s_t), np.argsort(s_j))
    sparse = cosine_scores(enroll, test, trials[:2], mean, device="cpu")
    np.testing.assert_allclose(sparse, s_t[:2], rtol=1e-6, atol=1e-6)
    eer = compute_eer(s_t, trial_labels)
    assert 0.0 <= eer <= 1.0
    assert eer == jax_compute_eer(s_j, trial_labels)


def test_package_imports_neither_jax_nor_pkr_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pkr_tpu_torch\n"
        "for m in pkgutil.walk_packages(pkr_tpu_torch.__path__, 'pkr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'pkr_tpu' or n.startswith('pkr_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('pkr_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 46  # every submodule was imported


@pytest.mark.parametrize("call", ["frontend", "model", "eval_step", "train_step",
                                  "scores", "cache_build", "cache_loader", "cohort_stats",
                                  "recipe_main"])
def test_entry_points_raise_without_a_card(call, monkeypatch):
    """device=None means the card; where there is none, raise instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav, lengths = make_wavs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "frontend":
            tf.wav_to_train_feats(wav, lengths)
        elif call == "model":
            SpeakerModel(SPK, 40, loss="AAM", trunk="tiny_resnet")
        elif call == "eval_step":
            tm = SpeakerModel(SPK, 40, loss="AAM", trunk="tiny_resnet", device="cpu")
            make_eval_step(tm, flash_aam=True)
        elif call == "train_step":
            tm = SpeakerModel(SPK, 40, loss="AAM", trunk="tiny_resnet", device="cpu")
            make_train_step(tm, flash_aam=True)
        elif call == "scores":
            v = {"a": np.ones(4, np.float32), "b": np.ones(4, np.float32)}
            cosine_scores(v, v, [("a", "b")])
        elif call == "cohort_stats":
            v = {"a": np.ones(4, np.float32)}
            cohort_topk_stats(v, np.ones((3, 4), np.float32), 2)
        elif call == "recipe_main":
            recipe_main(["--data-dir", REPO, "--stage", "6", "--stop-stage", "6"])
        elif call == "cache_build":
            DeviceFeatureCache.build({"u": np.ones((30, 8), np.float32)}, {"u": 0})
        else:
            cache = DeviceFeatureCache.build({"u": np.ones((30, 8), np.float32)}, {"u": 0},
                                             device="cpu")
            DeviceCacheLoader(cache, BalancedRepetitionSampler(["u"], [0]), 1)
