"""The port's RIR-set machinery and corpus augmentation (pkr_tpu_torch.recipes
.rir and .augment_dir) against pkr_tpu's on the CPU.

Both are host code whose draws are numpy ``default_rng`` draws, so with one
seed they must give the same parsed lists, the same plans, the same data-dir
tables and the same pool shards — exactly.  Rotation of the pool shards
depends on a prefetch thread's timing, so the parity tests turn it off; the
port's rotation is checked on its own.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import pkr_tpu.recipes.augment_dir as jad
import pkr_tpu.recipes.rir as jrir
import pkr_tpu_torch.recipes.augment_dir as tad
import pkr_tpu_torch.recipes.rir as trir
from pkr_tpu.io.datadir import DataDir as JaxDataDir
from pkr_tpu_torch.data.augment import tile_pool
from pkr_tpu_torch.io import DataDir
from pkr_tpu_torch.io.wav import write_wav

from test_rir import _make_noise_list, _make_rir_tree

RATE = 16000


def _dicts(items):
    return [dataclasses.asdict(i) for i in items]


@pytest.fixture
def rir_tree(tmp_path):
    root = _make_rir_tree(str(tmp_path / "RIRS_NOISES"), n_small=4, n_medium=3)
    return root, _make_noise_list(root)


def test_parsers_match_pkr_tpu(rir_tree, tmp_path):
    root, noise_list = rir_tree
    sets = trir.find_rir_sets(root)
    assert sets == jrir.find_rir_sets(root) and len(sets) == 2
    assert _dicts(trir.parse_rir_list(sets, base_dir=root)) == _dicts(
        jrir.parse_rir_list(sets, base_dir=root))
    # explicit probabilities, a set given by weight, records with --probability
    lst = tmp_path / "rir_list"
    lst.write_text("--rir-id a --room-id r1 --probability 0.7 a.wav\n\n"
                   "--rir-id b --room-id r1 b.wav\n--rir-id c --room-id r2 c.wav\n")
    params = ["0.3, " + str(lst), str(lst)]
    got = trir.parse_rir_list(params, base_dir=str(tmp_path))
    assert _dicts(got) == _dicts(jrir.parse_rir_list(params, base_dir=str(tmp_path)))
    np.testing.assert_allclose(sum(r.probability for r in got), 1.0)
    point, iso = trir.parse_noise_list([noise_list], base_dir=root)
    ref_point, ref_iso = jrir.parse_noise_list([noise_list], base_dir=root)
    assert _dicts(point) == _dicts(ref_point) and len(point) == 2
    assert {k: _dicts(v) for k, v in iso.items()} == {k: _dicts(v) for k, v in ref_iso.items()}
    bad = tmp_path / "bad_list"
    bad.write_text("--noise-id x --noise-type isotropic x.wav\n")
    with pytest.raises(ValueError, match="room-linkage"):
        trir.parse_noise_list([str(bad)])
    bad.write_text("--rir-id x --room-id\n")
    with pytest.raises(ValueError, match="no value"):
        trir.parse_rir_list([str(bad)])
    with pytest.raises(FileNotFoundError):
        trir.find_rir_sets(str(tmp_path / "empty"))


@pytest.mark.parametrize("max_rirs,room_convolve", [(4096, True), (5, False)])
def test_planner_draws_match_pkr_tpu(rir_tree, max_rirs, room_convolve):
    """500 draws from one seed: the same plans (RIR, noises with SNR, start,
    duration and noise RIR), the same cap hits and SNR cycles; max_rirs
    below the set's size subsamples the RIRs once, as the reference does."""
    root, noise_list = rir_tree
    planners = []
    for mod in (jrir, trir):
        rirs = mod.parse_rir_list(mod.find_rir_sets(root), base_dir=root)
        point, iso = mod.parse_noise_list([noise_list], base_dir=root)
        planners.append(mod.ReverbPlanner(
            rirs, point, iso, foreground_snrs=(15.0, 10.0, 5.0), background_snrs=(20.0, 13.0),
            speech_rvb_probability=0.7, pointsource_noise_addition_probability=0.8,
            isotropic_noise_addition_probability=0.6, max_noises_per_minute=90,
            max_rirs=max_rirs, seed=9, room_convolve_noises=room_convolve))
    ref, port = planners
    assert [r.rir_id for r in port.rirs] == [r.rir_id for r in ref.rirs]
    assert len(port.rirs) == min(max_rirs, 7)
    np.testing.assert_array_equal(port.rir_probs, ref.rir_probs)
    assert _dicts(port.noise_entries) == _dicts(ref.noise_entries)
    noise_lens = np.array([8000, 16000, 11200])
    rng = np.random.default_rng(0)
    kinds = set()
    for i in range(500):
        n = int(rng.integers(RATE, 8 * RATE))
        slots = None if i % 3 else 2
        a = ref.draw(n, noise_lens, max_slots=slots)
        b = port.draw(n, noise_lens, max_slots=slots)
        assert (a is None) == (b is None), i
        if a is not None:
            assert (b.rir, b.noises) == (a.rir, a.noises), i
            kinds |= {(a.rir < 0, len(a.noises) > 1)}
    assert (port.cap_hits, port._fg_i, port._bg_i) == (ref.cap_hits, ref._fg_i, ref._bg_i)
    assert port.cap_hits > 0 and len(kinds) == 4


def test_augment_and_perturb_tables_match_pkr_tpu():
    tables = {"utt2spk": {f"u{i}": f"s{i % 3}" for i in range(9)},
              "wav.scp": {f"u{i}": f"/w/u{i}.wav" for i in range(9)},
              "utt2warp": {f"u{i}": "1.0" for i in range(9)},
              "utt2num_frames": {f"u{i}": "100" for i in range(9)}}
    got = tad.augment_data_dir(DataDir(dict(tables)).make_spk2utt(), seed=4)
    ref = jad.augment_data_dir(JaxDataDir(dict(tables)).make_spk2utt(), seed=4)
    assert got.tables == ref.tables and got.num_utts == 18
    assert "utt2num_frames" not in got.tables and len(got["utt2warp"]) == 18
    assert set(got["utt2aug"].values()) == {"none", *tad.AUG_KINDS}
    for factors, keep in (((0.9, 1.1), True), ((0.9,), False)):
        sp = tad.perturb_data_dir_speed(got, factors=factors, keep_original=keep)
        assert sp.tables == jad.perturb_data_dir_speed(ref, factors, keep).tables
        assert sp.validate() == []
    assert sp.num_utts == 18 and sp["utt2spk"]["sp0.9-u0"] == "sp0.9-s0"


def _musan_dirs(root, n=12):
    """MUSAN-style data dirs of `n` noise and 5 speech recordings whose
    lengths straddle the pool length."""
    rng = np.random.default_rng(2)
    dirs = {}
    for kind, count in (("noise", n), ("speech", 5)):
        wav = {}
        for i in range(count):
            path = os.path.join(root, f"{kind}{i}.wav")
            write_wav(path, rng.standard_normal(int(rng.integers(400, 2400))) * 1000, RATE)
            wav[f"{kind}{i}"] = path
        dirs[kind] = {"wav.scp": wav, "utt2spk": {u: u for u in wav}}
    return dirs


def test_augment_pools_load_matches_pkr_tpu(tmp_path, rir_tree):
    """AugmentPools.load with rotation off: the same shuffled cycle, shard
    size and shard contents; attach_rir_set: the same planner draws, RIR
    pool with its trailing delta row, and point/iso noise pool; the
    augmenter's seed drawn from the same stream."""
    dirs = _musan_dirs(str(tmp_path))
    kw = dict(max_len_sec=0.1, rate=RATE, seed=6, snr={"noise": (7.0, 3.0)},
              shard_mb=0, rotate_rows=0)
    ref = jad.AugmentPools.load({k: JaxDataDir(dict(v)) for k, v in dirs.items()}, **kw)
    got = tad.AugmentPools.load({k: DataDir(dict(v)) for k, v in dirs.items()},
                                device="cpu", **kw)
    assert got._shards == ref._shards and got._shards["noise"]["k"] == 2
    assert sorted(got.pools) == ["babble", "noise"]
    for kind in got.pools:
        for a, b in zip(got.pools[kind], ref.pools[kind]):
            np.testing.assert_array_equal(a, b)
    root, noise_list = rir_tree
    for pools in (got, ref):
        pools.attach_rir_set(root, noise_set_params=[noise_list],
                             max_noises_per_minute=120, max_rir_sec=0.05, max_noise_sec=0.5)
    for a, b in zip(got.rirs + got.rvb_noise, ref.rirs + ref.rvb_noise):
        np.testing.assert_array_equal(a, b)
    assert got.rirs[1][-1] == 1 and got.rirs[0][-1, 0] == 1 and not got.rirs[0][-1, 1:].any()
    for _ in range(20):
        a, b = ref.reverb_planner.draw(RATE, ref.rvb_noise[1]), got.reverb_planner.draw(
            RATE, got.rvb_noise[1])
        assert (a is None and b is None) or (b.rir, b.noises) == (a.rir, a.noises)
    aug = got.augmenter
    assert aug.SNR["noise"] == (7.0, 3.0) and aug.kinds() == ["noise", "babble", "reverb"]
    assert aug.rng.integers(1 << 30) == ref.augmenter.rng.integers(1 << 30)


def test_augment_pools_rotate_shards(tmp_path):
    """The port's rotation alone: fixed-shape shards swap in between batches
    once rotate_rows utterances were augmented, set_pool uploads them and
    drops the kind's tiles, and the counters say what happened."""
    dirs = _musan_dirs(str(tmp_path), n=24)
    pools = tad.AugmentPools.load({"noise": DataDir(dict(dirs["noise"]))}, max_len_sec=0.1,
                                  rate=RATE, shard_mb=0, rotate_rows=4, seed=1, device="cpu")
    st = pools._shards["noise"]
    assert st["k"] == 2 and pools._rotating_kinds() == ["noise"]
    aug = pools.augmenter
    sigs = np.random.default_rng(3).standard_normal((4, 800)).astype(np.float32) * 500
    seen = [aug.pools["noise"][0]]
    for _ in range(12):
        out = aug(sigs, np.full(4, 800), kinds=["noise"] * 4)
        assert out.shape == sigs.shape and np.isfinite(out).all()
        if pools._prefetch is not None:
            pools._prefetch["thread"].join(timeout=30)
            assert not pools._prefetch["thread"].is_alive()
        mats, lens = aug.pools["noise"]
        if mats is not seen[-1]:
            assert mats.shape == seen[-1].shape
            # the old shard's tile went with it; this batch tiled the new one
            assert torch.equal(aug._tiled[("noise", 800)], tile_pool(mats, lens, 800))
            seen.append(mats)
    assert pools.rotations_done == len(seen) - 1 >= 3
    assert pools.rotation_errors == 0 and pools.rotation_wait_batches == 0
    assert st["pos"] == (2 * (pools.rotations_done + 2)) % 24  # the live shard + one prefetched
    assert aug._tiled_bytes <= aug.tile_budget_bytes
