"""The port's host data plane (pkr_tpu_torch.data) against pkr_tpu.data.

The samplers, TrainLoader, EvalLoader and the materialized pack are copies
of pkr_tpu's numpy code, so they must give pkr_tpu's indices, batches,
payloads and masks exactly, on a tiny compressed corpus written by the
port's own ark writer (a few utterances shorter than the crop, to exercise
the cyclic tiling).  TrainLoader is also held to itself across the native
reader and the python codec.
"""

import numpy as np
import pytest

from pkr_tpu.data import (BalancedRepetitionSampler as JBalanced, EvalLoader as JEvalLoader,
                          FeatureSource as JFeatureSource, MaterializedSource as JMaterialized,
                          SpeakerBalancedSampler as JSpeakerBalanced, TrainLoader as JTrainLoader,
                          materialize as j_materialize)
from pkr_tpu_torch.data import (BalancedRepetitionSampler, EvalLoader, FeatureSource,
                                MaterializedSource, SpeakerBalancedSampler, TrainLoader,
                                bucket_lengths, load_utt2spkid, materialize)
from pkr_tpu_torch.io import kaldi_ark as ka

F = 20


def write_corpus(root, n=14, seed=0, compress=True):
    """n utterances of 30–330 frames (every third one under 60), labels
    over 4 speakers, as feats.ark/feats.scp and utt2spkid."""
    rng = np.random.default_rng(seed)
    root.mkdir(exist_ok=True)
    utts, labels = [], []
    with ka.write_ark_scp(str(root / "feats.ark"), str(root / "feats.scp"),
                          compress=compress) as w:
        for i in range(n):
            rows = int(rng.integers(30, 60) if i % 3 == 0 else rng.integers(60, 330))
            w.write(f"u{i:02d}", (rng.standard_normal((rows, F)) * 3 + 9).astype(np.float32))
            utts.append(f"u{i:02d}")
            labels.append(i % 4)
    (root / "utt2spkid").write_text("".join(f"{u} {l}\n" for u, l in zip(utts, labels)))
    return str(root / "feats.scp"), utts, labels


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.mark.parametrize("kind", ["balanced", "speaker"])
def test_samplers_match_pkr_tpu(kind):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 9, 60)
    utts = [f"u{i}" for i in range(60)]
    port, ref = ((BalancedRepetitionSampler(utts, labels), JBalanced(utts, labels))
                 if kind == "balanced" else
                 (SpeakerBalancedSampler(utts, labels), JSpeakerBalanced(utts, labels)))
    assert len(port) == len(ref)
    for seed, epoch, proc, count in ((0, 0, 0, 1), (3, 2, 0, 1), (7, 5, 1, 2), (7, 5, 2, 3)):
        np.testing.assert_array_equal(port.epoch_indices(epoch, seed, proc, count),
                                      ref.epoch_indices(epoch, seed, proc, count))


def test_load_utt2spkid(corpus):
    scp, utts, labels = corpus
    table = load_utt2spkid(scp.replace("feats.scp", "utt2spkid"))
    assert table == dict(zip(utts, labels))


def test_train_loader_matches_pkr_tpu_and_itself(corpus):
    """The same seed gives the same batches over the native reader, the
    python codec and pkr_tpu's loader (python codec)."""
    scp, utts, labels = corpus
    native_src = FeatureSource(scp)
    assert native_src._native is not None
    loaders = [TrainLoader(src, labels, BalancedRepetitionSampler(utts, labels), 4, chunk=64,
                           seed=5)
               for src in (native_src, FeatureSource(scp, use_native=False))]
    loaders.append(JTrainLoader(JFeatureSource(scp, use_native=False), labels,
                                JBalanced(utts, labels), 4, chunk=64, seed=5))
    assert len({ld.batches_per_epoch() for ld in loaders}) == 1
    for epoch in (0, 1):
        runs = [list(ld.epoch(epoch)) for ld in loaders]
        assert len(runs[0]) == loaders[0].batches_per_epoch() > 0
        for other in runs[1:]:
            assert len(other) == len(runs[0])
            for (x, y), (xo, yo) in zip(runs[0], other):
                assert x.shape == (4, F, 64) and x.dtype == np.float32
                np.testing.assert_array_equal(x, xo)
                np.testing.assert_array_equal(y, yo)
    # a random chunk size per epoch
    a = TrainLoader(native_src, labels, BalancedRepetitionSampler(utts, labels), 4,
                    chunk=(40, 90), seed=2)
    b = JTrainLoader(JFeatureSource(scp, use_native=False), labels, JBalanced(utts, labels), 4,
                     chunk=(40, 90), seed=2)
    for (x, y), (xr, yr) in zip(a.epoch(3), b.epoch(3)):
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(y, yr)


def test_train_loader_abandoned_epoch_stops(corpus):
    scp, utts, labels = corpus
    loader = TrainLoader(FeatureSource(scp), labels, BalancedRepetitionSampler(utts, labels),
                         2, chunk=32, prefetch=1)
    it = loader.epoch(0)
    next(it)
    it.close()  # the producer thread sees the stop and exits


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for (k, p, m), (kr, pr, mr) in zip(got, ref):
        assert k == kr
        np.testing.assert_array_equal(m, mr)
        assert isinstance(p, tuple) == isinstance(pr, tuple)
        for a, b in (zip(p, pr) if isinstance(p, tuple) else [(p, pr)]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("transport", ["auto", "f32"])
@pytest.mark.parametrize("long_mode", ["truncate", "average"])
def test_eval_loader_matches_pkr_tpu(corpus, transport, long_mode):
    """Keys, payloads ((codes, pct) or f32) and masks, with tail buckets
    padded to the batch and long utterances cut into '##' segments."""
    scp, _, _ = corpus
    kw = dict(batch_size=3, quantum=50, max_len=150, long_mode=long_mode, transport=transport)
    got = list(EvalLoader(FeatureSource(scp), **kw))
    ref = list(JEvalLoader(JFeatureSource(scp, use_native=False), **kw))
    _assert_batches_equal(got, ref)
    assert any(isinstance(p, tuple) for _, p, _ in got) == (transport == "auto")
    assert any(len(k) < m.shape[0] for k, _, m in got)  # a padded tail bucket
    if long_mode == "average":
        assert any("##" in key for k, _, _ in got for key in k)
    for sharded in ((0, 2), (1, 2)):
        a = list(EvalLoader(FeatureSource(scp), batch_size=4, process_index=sharded[0],
                            process_count=sharded[1]))
        b = list(JEvalLoader(JFeatureSource(scp, use_native=False), batch_size=4,
                             process_index=sharded[0], process_count=sharded[1]))
        _assert_batches_equal(a, b)
    np.testing.assert_array_equal(bucket_lengths([1, 50, 51, 400], 50, 150), [50, 50, 100, 150])


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_materialize_matches_pkr_tpu(corpus, tmp_path, dtype):
    scp, utts, _ = corpus
    idx = materialize(scp, str(tmp_path / "port" / "pack"), dtype=dtype)
    idx_ref = j_materialize(scp, str(tmp_path / "ref" / "pack"), dtype=dtype)
    assert open(idx.replace(".json", ".bin"), "rb").read() == \
        open(idx_ref.replace(".json", ".bin"), "rb").read()
    src, ref = MaterializedSource(idx), JMaterialized(idx_ref)
    assert src.utts == ref.utts == utts
    for i in range(len(src)):
        assert src.dims(i) == ref.dims(i)
        np.testing.assert_array_equal(src.read(i), ref.read(i))
        for start in (0, src.dims(i)[0] - 5):
            np.testing.assert_array_equal(src.read_crop_t(i, start, 64),
                                          ref.read_crop_t(i, start, 64))
    got = list(EvalLoader(src, batch_size=4, quantum=50, max_len=200))
    _assert_batches_equal(got, list(JEvalLoader(ref, batch_size=4, quantum=50, max_len=200)))
