"""The reference against the port at tiny sizes on the CPU, so that a
fault of the reference shows before the chip: the AAM loss and its
gradients (B = 4, C = 64, D = 256) against the port's dense and flash
heads, the trunk and embedding against ``SpeakerModel`` in f32, the crops
against ``DeviceCacheLoader``, the frontend against
``wav_to_train_feats``, and three f32 train steps against the port's."""

import numpy as np
import pytest
import torch

from portbench import build
from portbench.reference import aam, crops, frontend, resnet

CFG = {"trunk": "tiny_resnet", "feat_dim": 40, "pooling": "mean+std", "emb_dim": 256,
       "loss": "AAM", "m": 0.2, "s": 30.0, "n_spk": 64, "head": "dense", "dtype": "float32",
       "corpus": {"speakers": 16, "utts_per_speaker": 3, "frames": [150, 260]}}
CPU = torch.device("cpu")


def _emb_w_labels(seed=0):
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(4, 256, generator=g)
    w = torch.randn(64, 256, generator=g) * 0.1
    return emb, w, torch.tensor([3, 17, 63, 0])


@pytest.mark.parametrize("block", [64, 16])
def test_aam_against_the_port(block, monkeypatch):
    from pkr_tpu_torch.ops.flash_aam import flash_aam_loss_acc, reference_aam_loss

    monkeypatch.setattr(aam, "BLOCK", block)
    emb, w, y = _emb_w_labels()
    e1, w1 = emb.clone().requires_grad_(), w.clone().requires_grad_()
    loss, _, _ = aam.aam_loss_acc(e1, w1, y, 0.2, 30.0)
    loss.backward()
    e2, w2 = emb.clone().requires_grad_(), w.clone().requires_grad_()
    ref = reference_aam_loss(e2, w2, y, 0.2, 30.0)
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(e1.grad, e2.grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-5, atol=1e-7)
    fl, a1, a5 = flash_aam_loss_acc(emb, w, y, 0.2, 30.0)
    _, r1, r5 = aam.aam_loss_acc(emb, w, y, 0.2, 30.0)
    torch.testing.assert_close(fl, loss.detach(), rtol=1e-5, atol=1e-6)
    assert (float(a1), float(a5)) == (float(r1), float(r5))


def test_embed_against_speaker_model():
    weights = build.make_weights(CFG, 5, CPU)
    model = build.build_model(CFG, weights, CPU)
    x = torch.randn(3, 40, 37, generator=torch.Generator().manual_seed(1))
    mask = torch.arange(37)[None, :] < torch.tensor([37, 30, 21])[:, None]
    with torch.no_grad():
        for m in (None, mask):
            got = model.embed(x, m)
            want = resnet.embed(weights, CFG, x, False, m)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        model.train()
        stats = {}
        torch.testing.assert_close(model.embed(x), resnet.embed(weights, CFG, x, True, None, stats),
                                   rtol=1e-5, atol=1e-5)
        for m in model.modules():
            if getattr(m, "staged", None) is not None:
                m.staged = None
    assert len(stats) == sum(n.endswith("running_mean") for n in weights)


def test_crops_against_the_loader():
    from pkr_tpu_torch.data.device_cache import DeviceCacheLoader, DeviceFeatureCache
    from pkr_tpu_torch.data.sampler import BalancedRepetitionSampler

    c = build.make_corpus({"speakers": 6, "utts_per_speaker": 3, "frames": [150, 260]}, 40,
                          2 ** 31 + 11, CPU)
    labels = c.labels.copy()
    labels[:5] = 0  # uneven classes: the balanced repetition at work
    cache = DeviceFeatureCache(c.codes, c.pct, c.offsets, c.rows, c.utts, labels)
    loader = DeviceCacheLoader(cache, BalancedRepetitionSampler(c.utts, labels, 500), 4,
                               chunk=200, seed=2 ** 31 + 11, device="cpu")
    got = list(loader.epoch(0))[:3]
    want = crops.crops(c.codes, c.pct, c.offsets, c.rows, labels, 500, 2 ** 31 + 11, 4, 200, 3)
    for (x, y), (xr, yr) in zip(got, want):
        assert torch.equal(y, yr)
        assert torch.equal(x, xr)


def test_frontend_against_the_port():
    from pkr_tpu_torch.frontend import FrontendConfig, wav_to_train_feats

    rng = np.random.default_rng(0)
    t = np.arange(8000) / 16000
    wav = (3000 * np.sin(2 * np.pi * rng.uniform(80, 300, (3, 1)) * t)
           + 400 * rng.standard_normal((3, 8000))).astype(np.float32)
    wav[1, 4000:] *= 0.001  # a quiet half: the VAD drops frames
    feats, mask, _ = wav_to_train_feats(wav, np.full(3, 8000), torch.Generator().manual_seed(9),
                                        FrontendConfig(), device="cpu")
    rf, rm = frontend.features(torch.as_tensor(wav), 8000, torch.Generator().manual_seed(9))
    assert torch.equal(mask, rm) and int(rm[1].sum()) < 50
    assert float((feats - rf).abs()[rm].max()) < 1e-3


def test_train_steps_against_the_port():
    from portbench import manifest
    from portbench.run import Ctx

    drv = manifest.load_module(manifest.driver_path("train"), "pb_train_ref_test")
    tr = {"batch": 4, "frames": 200, "lr": 0.1, "momentum": 0.9, "weight_decay": 5e-4,
          "max_per_class": 500, "checked_steps": 3, "warmup_steps": 0}
    for head in ("dense", "flash"):
        ctx = Ctx("t", dict(CFG, head=head), tr, 7, 0.0, False, CPU, {})
        (row,) = list(drv.calibrate(ctx, False))
        assert row["crops_gap"] == 0.0
        for k in ("loss_gap", "grad_med", "change_med", "mom_med", "bnstat_med",
                  "grad_worst", "change_worst", "mom_worst"):
            assert row[k] < 1e-4, (head, k, row[k])
        where = row["where"]  # every leaf, not only the median
        for k in ("grad1", "change", "mom", "bnstat"):
            gap, leaf = where[k]["all"] if k != "bnstat" else where[k]
            assert gap < 1e-4, (head, k, leaf, gap)
