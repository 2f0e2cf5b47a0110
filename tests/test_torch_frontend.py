"""Port frontend (pkr_tpu_torch.frontend) against pkr_tpu.frontend on the CPU.

Inputs are made with numpy from a seed and handed to both packages; ragged
lengths exercise the true-length mirror padding and every mask.  Parity is
at dither=0: the two packages' random generators differ by construction.

Tolerances: framing is a copy of samples, so it must be exact; the fbank,
CMVN and pipeline features go through f32 matmuls and cumulative sums whose
summation order differs between XLA and PyTorch, so they are held at
rtol=atol=2e-4 (the bar tests/test_frontend.py holds pkr_tpu to against
Kaldi); VAD decisions and the voiced-frame mask are 0/1 and must be equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pkr_tpu.frontend as jf
import pkr_tpu_torch.frontend as tf

LENGTHS = np.array([8037, 6400, 4001])
TOL = dict(rtol=2e-4, atol=2e-4)


def make_wavs(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), int(max(lengths))), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000
        wav[i, :n] = (3000 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                      + 400 * rng.standard_normal(n))
    # some utterances silent for a stretch, so the VAD has work to do
    wav[0, 2000:4000] *= 0.001
    return wav


@pytest.mark.parametrize("snip_edges,max_frames", [(False, None), (True, None),
                                                   (False, 64)])
def test_frame_signal_exact(snip_edges, max_frames):
    wav = make_wavs()
    fcfg = jf.FbankConfig(dither=0.0, snip_edges=snip_edges)
    tcfg = tf.FbankConfig(dither=0.0, snip_edges=snip_edges)
    fr_j, m_j = jax.vmap(lambda w, n: jf.frame_signal(w, n, fcfg, max_frames))(
        jnp.asarray(wav), jnp.asarray(LENGTHS))
    fr_t, m_t = tf.frame_signal(torch.from_numpy(wav), torch.from_numpy(LENGTHS),
                                tcfg, max_frames)
    np.testing.assert_array_equal(fr_t.numpy(), np.asarray(fr_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_fbank_parity():
    wav = make_wavs()
    got, m_t = tf.fbank(wav, LENGTHS, tf.FbankConfig(dither=0.0), device="cpu")
    ref, m_j = jf.fbank(jnp.asarray(wav), jnp.asarray(LENGTHS),
                        jf.FbankConfig(dither=0.0))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_energy", [True, False])
def test_mfcc_parity(use_energy):
    """The DCT of the log-mels, liftered; with use_energy, C0 is the raw log
    energy.  Held to the fbank's bound: the DCT and the lifter keep the
    log-mels' 2e-4 (the largest coefficient here is ~1e2)."""
    wav = make_wavs()
    got, m_t = tf.mfcc(wav, LENGTHS, tf.MfccConfig(dither=0.0, use_energy=use_energy),
                       device="cpu")
    ref, m_j = jf.mfcc(jnp.asarray(wav), jnp.asarray(LENGTHS),
                       jf.MfccConfig(dither=0.0, use_energy=use_energy))
    assert got.shape == (3, 50, 40)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cmn_window,center", [(300, True), (30, True), (30, False)])
def test_wav_to_train_feats_parity(cmn_window, center):
    wav = make_wavs()
    fcfg = jf.FrontendConfig(fbank=jf.FbankConfig(dither=0.0),
                             cmn_window=cmn_window, cmn_center=center)
    tcfg = tf.FrontendConfig(fbank=tf.FbankConfig(dither=0.0),
                             cmn_window=cmn_window, cmn_center=center)
    ref = jf.wav_to_train_feats(jnp.asarray(wav), jnp.asarray(LENGTHS), None, fcfg)
    got = tf.wav_to_train_feats(wav, LENGTHS, None, tcfg, device="cpu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < got[1].sum() < got[1].numel()  # the VAD dropped some frames


def _ragged_mask(B, T, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(T // 3, T + 1, B)
    n[0] = T
    return np.arange(T)[None, :] < n[:, None]


def test_energy_vad_parity():
    rng = np.random.default_rng(1)
    loge = rng.normal(10.0, 3.0, (4, 57)).astype(np.float32)
    mask = _ragged_mask(4, 57, 1)
    ref = jf.energy_vad(jnp.asarray(loge), jnp.asarray(mask))
    got = tf.energy_vad(torch.from_numpy(loge), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("center,norm_vars", [(True, False), (False, False),
                                              (True, True)])
def test_sliding_cmvn_parity(center, norm_vars):
    rng = np.random.default_rng(2)
    feats = rng.normal(12.0, 4.0, (3, 80, 5)).astype(np.float32)
    mask = _ragged_mask(3, 80, 2)
    ref = jf.sliding_cmvn(jnp.asarray(feats), jnp.asarray(mask), 25, center,
                          norm_vars, 10)
    got = tf.sliding_cmvn(torch.from_numpy(feats), torch.from_numpy(mask), 25,
                          center, norm_vars, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_select_voiced_parity():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 40, 4)).astype(np.float32)
    voiced = (rng.uniform(size=(3, 40)) > 0.4).astype(np.float32)
    mask = _ragged_mask(3, 40, 3)
    ref_f, ref_m = jf.select_voiced(jnp.asarray(feats), jnp.asarray(voiced),
                                    jnp.asarray(mask))
    got_f, got_m = tf.select_voiced(torch.from_numpy(feats), torch.from_numpy(voiced),
                                    torch.from_numpy(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))


def test_dither_draws_from_the_generator():
    """Dither is reproducible from a seeded torch.Generator and is really
    applied."""
    wav = make_wavs()
    cfg = tf.FrontendConfig()

    def run(seed):
        return tf.wav_to_train_feats(wav, LENGTHS, torch.Generator().manual_seed(seed),
                                     cfg, device="cpu")[0]

    a, b, c = run(0), run(0), run(1)
    plain = tf.wav_to_train_feats(wav, LENGTHS, None, cfg, device="cpu")[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()
    assert not torch.equal(a, plain)
