"""The port's card-resident feature cache and quantized extraction transport
against pkr_tpu, on the CPU.

- quantize_utterance gives pkr_tpu's bytes;
- dequantize equals a numpy evaluation of its own formula bit for bit, and
  pkr_tpu's dequantize and the CM decoder within atol 2e-5 (the bound of
  tests/test_device_cache.py: XLA may fuse the formula's products and sums);
- the crop sampler, given pkr_tpu's own uniform draws, reads exactly the
  code rows pkr_tpu's sampler reads (short utterances tile cyclically), and
  decodes them within atol 2e-5;
- DeviceCacheLoader drives tiny_resnet flash train steps;
- extraction over (codes, pct) batches equals the port's f32 transport of
  the same utterances within 1e-5 relative, and pkr_tpu's quantized
  extraction within the port's model tolerance (rtol = atol = 5e-4, as
  tests/test_torch_model.py).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pkr_tpu.data import device_cache as jdc
from pkr_tpu.eval.extract import _embed_codes_jit
from pkr_tpu.io import kaldi_ark as jka
from pkr_tpu.models import SpeakerModel as FlaxSpeakerModel
from pkr_tpu_torch.convert import state_dict_from_flax
from pkr_tpu_torch.data import (BalancedRepetitionSampler, DeviceCacheLoader,
                                DeviceFeatureCache, EvalLoader, FeatureSource)
from pkr_tpu_torch.data import device_cache as dc
from pkr_tpu_torch.eval import extract_embeddings
from pkr_tpu_torch.io import kaldi_ark as ka
from pkr_tpu_torch.models import SpeakerModel
from pkr_tpu_torch.train import create_train_state, make_train_step

F = 16


def make_mats(n=9, seed=0):
    """Utterances of 20–200 rows; every third one is shorter than the
    crops below."""
    rng = np.random.default_rng(seed)
    return {f"u{i}": (rng.standard_normal((20 + 23 * i if i % 3 else 20 + i, F)) * 3 + 12
                      ).astype(np.float32) for i in range(n)}


def numpy_dequantize(codes, pct):
    """The formula of dequantize, evaluated by numpy in f32."""
    c = codes.astype(np.float32)
    p0, p25, p75, p100 = (pct[..., k:k + 1, :] for k in range(4))
    low = p0 + (p25 - p0) * (c * np.float32(1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - np.float32(64.0)) * np.float32(1.0 / 128.0))
    high = p75 + (p100 - p75) * ((c - np.float32(192.0)) * np.float32(1.0 / 63.0))
    return np.where(c <= 64.0, low, np.where(c <= 192.0, mid, high))


def test_quantize_and_dequantize_match_pkr_tpu():
    for m in make_mats().values():
        codes, pct = dc.quantize_utterance(m)
        ref_codes, ref_pct = jdc.quantize_utterance(m)
        assert codes.dtype == np.uint8 and codes.tobytes() == ref_codes.tobytes()
        assert pct.tobytes() == ref_pct.tobytes()
        got = dc.dequantize(torch.from_numpy(codes), torch.from_numpy(pct)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, numpy_dequantize(codes, pct))
        ref = np.asarray(jdc.dequantize(jnp.asarray(codes), jnp.asarray(pct)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        cm = jka.decompress_matrix(io.BytesIO(jka.compress_matrix(m, 1)[3:]))
        np.testing.assert_allclose(got, cm, rtol=0, atol=2e-5)
        # every code value, batched as the extraction transport batches them
        all_codes = np.arange(256, dtype=np.uint8)[None, :, None].repeat(F, axis=2)
        batch_pct = pct[None]
        np.testing.assert_array_equal(
            dc.dequantize(torch.from_numpy(all_codes), torch.from_numpy(batch_pct)).numpy(),
            numpy_dequantize(all_codes, batch_pct))


@pytest.mark.parametrize("seq_len", [24, 64])
def test_crop_sampler_reads_pkr_tpu_rows(seq_len):
    mats = make_mats()
    labels = {u: i % 4 for i, u in enumerate(mats)}
    cache = DeviceFeatureCache.build(mats, labels, device="cpu")
    ref = jdc.DeviceFeatureCache.build(mats, labels)
    assert np.array_equal(cache.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(cache.pct.numpy(), np.asarray(ref.pct))
    assert cache.nbytes == ref.nbytes
    ids = np.array([0, 1, 2, 3, 5, 6, 8, 8, 4], np.int32)
    assert (np.asarray([len(mats[cache.utts[i]]) for i in ids]) < seq_len).any()
    for seed in range(3):
        key = jax.random.key(seed)
        u = torch.tensor(np.asarray(jax.random.uniform(key, ids.shape)))
        idx = dc._crop_index(cache.offsets, cache.rows, torch.from_numpy(ids).long(), u,
                             seq_len).numpy()
        r = np.asarray(ref.rows)[ids]
        span = jnp.maximum(jnp.asarray(r) - seq_len + 1, 1)
        starts = np.asarray(ref.offsets[ids] + (jax.random.uniform(key, ids.shape)
                                                * span).astype(jnp.int32))
        np.testing.assert_array_equal(idx[:, 0], starts)
        # identity tables (0, 64, 192, 255) decode a code to itself, so
        # pkr_tpu's sampler shows which code rows it read
        ident = np.tile(np.array([0, 64, 192, 255], np.float32)[:, None], (1, F))
        ident = np.repeat(ident[None], len(mats), axis=0)
        ref_rows = np.asarray(jdc._sample_cache(ref.codes, jnp.asarray(ident), ref.offsets,
                                                ref.rows, jnp.asarray(ids), key, seq_len))
        got_rows = dc._sample_cache(cache.codes, torch.from_numpy(ident), cache.offsets,
                                    cache.rows, torch.from_numpy(ids).long(), u, seq_len)
        assert got_rows.shape == (len(ids), F, seq_len)
        np.testing.assert_array_equal(np.rint(ref_rows).astype(np.uint8),
                                      np.rint(got_rows.numpy()).astype(np.uint8))
        np.testing.assert_array_equal(
            cache.codes.numpy()[idx].transpose(0, 2, 1),
            np.rint(got_rows.numpy()).astype(np.uint8))
        feats, labs = cache.sample_batch(ids, u, seq_len)
        ref_feats, ref_labs = ref.sample_batch(jnp.asarray(ids), key, seq_len)
        np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), rtol=0, atol=2e-5)
        np.testing.assert_array_equal(labs.numpy(), np.asarray(ref_labs))
        # a short utterance's crop is its own rows, tiled
        short = int(np.argmax(r < seq_len))
        n = r[short]
        tiled = np.asarray(ref.offsets)[ids[short]] + np.arange(seq_len) % n
        np.testing.assert_array_equal(idx[short], tiled)


def test_device_cache_loader_trains_tiny_resnet():
    mats = make_mats(n=12, seed=1)
    utts = list(mats)
    labels = {u: i % 4 for i, u in enumerate(utts)}
    cache = DeviceFeatureCache.build(mats, labels, device="cpu")
    sampler = BalancedRepetitionSampler(utts, [labels[u] for u in utts])
    loader = DeviceCacheLoader(cache, sampler, 4, chunk=32, seed=3, device="cpu")
    first = [x.clone() for x, _ in loader.epoch(0)]
    again = [x for x, _ in loader.epoch(0)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))  # seeded by (seed, epoch)
    assert not torch.equal(first[0], next(iter(loader.epoch(1)))[0])
    torch.manual_seed(0)
    model = SpeakerModel(4, F, loss="AAM", trunk="tiny_resnet", dtype=torch.float32,
                         device="cpu")
    step = make_train_step(model, flash_aam=True, device="cpu")
    state = create_train_state(model)
    losses = []
    for b, (x, y) in enumerate(loader.epoch(0)):
        if b == 3:
            break
        assert x.shape == (4, F, 32) and y.dtype == torch.int64
        state, m = step(state, x, y, 0.05)
        losses.append(float(m["loss"]))
    assert len(losses) == 3 and np.isfinite(losses).all() and int(state.step) == 3


def test_quantized_extraction_matches_f32_and_pkr_tpu(tmp_path):
    mats = make_mats(n=7, seed=2)
    with ka.write_ark_scp(str(tmp_path / "f.ark"), str(tmp_path / "f.scp"),
                          compress=True) as w:
        for k, m in mats.items():
            w.write(k, m)
    src = FeatureSource(str(tmp_path / "f.scp"))
    fm = FlaxSpeakerModel(spk_num=5, feat_dim=F, trunk="tiny_resnet", loss="AAM",
                          dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, fm.init(jax.random.key(0), jnp.zeros((1, F, 32)),
                                                 train=False))
    tm = SpeakerModel(5, F, loss="AAM", trunk="tiny_resnet", dtype=torch.float32,
                      device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    kw = dict(batch_size=3, quantum=40, max_len=120)
    batches = list(EvalLoader(src, transport="auto", **kw))
    assert all(isinstance(p, tuple) for _, p, _ in batches)
    f32 = list(EvalLoader(src, transport="f32", **kw))
    # the codes are a quarter of the f32 feature bytes
    assert 4 * sum(p[0].nbytes for _, p, _ in batches) == sum(p.nbytes for _, p, _ in f32)
    got = extract_embeddings(tm, batches, device="cpu")
    plain = extract_embeddings(tm, f32, device="cpu")
    assert sorted(got) == sorted(plain) == sorted(mats)
    for k in got:
        np.testing.assert_allclose(got[k], plain[k], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(plain[k]).max()))
    for keys, (codes, pct), mask in batches:
        ref = np.asarray(_embed_codes_jit(fm, variables, jnp.asarray(codes), jnp.asarray(pct),
                                          jnp.asarray(mask)))
        for k, e in zip(keys, ref):
            np.testing.assert_allclose(got[k], e, rtol=5e-4, atol=5e-4)
