"""The port's waveform augmentation (pkr_tpu_torch.data.augment) against
pkr_tpu.data.augment on the CPU.

Inputs and pools are made with numpy from a seed and handed to both
packages.  Every draw of the augmenter is a numpy ``default_rng`` draw made
in the reference's order, so one seed gives both packages the same plans:
they are held ``array_equal``.  The mixed rows go through f32 sums (and
rFFTs for reverb) whose order differs between XLA and PyTorch, so they are
held within 1e-5 (additive kinds, babble) or 1e-4 (reverb) of each row's
peak; clean rows come back bit for bit.  Sizes stay small (n ≤ 8000, RIRs ≤
1600 samples) so pkr_tpu's compiles stay short.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pkr_tpu.data.augment as ja
import pkr_tpu.recipes.rir as jrir
import pkr_tpu_torch.data.augment as ta
import pkr_tpu_torch.recipes.rir as trir

N = 8000
LENGTHS = np.array([8000, 6400, 8000, 3001, 8000, 5000, 7999, 4000])
ADD_TOL, RVB_TOL = 1e-5, 1e-4
PLAN_KEYS = ("src", "starts", "snrs", "sig_starts", "durs", "nrirs", "n_src")


def make_wavs(lengths=LENGTHS, n=N, seed=0):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), n), np.float32)
    for i, ln in enumerate(lengths):
        t = np.arange(ln) / 16000
        wav[i, :ln] = (3000 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                       + 400 * rng.standard_normal(ln))
    return wav


def _pool(rng, lens, width, scale):
    mats = np.zeros((len(lens), width), np.float32)
    for i, ln in enumerate(lens):
        mats[i, :ln] = rng.standard_normal(ln) * scale
    return mats, np.asarray(lens, np.int64)


def make_rirs(rng, k=5, width=1600):
    """k RIRs, zero-padded to `width`, whose peaks are not at sample 0 (a
    weaker early reflection comes first), then the delta row."""
    mats = np.zeros((k + 1, width), np.float32)
    lens = np.zeros(k + 1, np.int64)
    for i in range(k):
        ln = width - 200 * i
        tail = np.exp(-np.arange(ln) / (80 + 40 * i)) * rng.standard_normal(ln) * 0.3
        mats[i, :ln] = tail
        mats[i, 3 + i] = 0.5
        mats[i, 17 + 5 * i] = 1.0 + 0.1 * i
        lens[i] = ln
    mats[k, 0], lens[k] = 1.0, 1
    return mats, lens


@pytest.fixture(scope="module")
def pools():
    rng = np.random.default_rng(1)
    return {"noise": _pool(rng, [4000, 2500, 3333], 4000, 50),
            "music": _pool(rng, [3900, 1200], 4000, 300),
            "speech": _pool(rng, [3000, 2500, 2000, 3000, 1500, 2900, 2200, 1800], 3000, 80),
            "rirs": make_rirs(rng)}


# one compiled batch function per (n, pool set) shared by the reference
# augmenters of a test: each WavAugmenter would otherwise compile its own
_JAX_FNS = {}


def _pair(pools, seed, keys=("noise", "music", "speech", "rirs")):
    args = {k: pools[k] for k in keys}
    ref = ja.WavAugmenter(seed=seed, **args)
    ref._fns = _JAX_FNS.setdefault(keys, {})
    return ref, ta.WavAugmenter(seed=seed, device="cpu", **args)


def _assert_rows(got, ref, wavs, codes, tol):
    for b in range(len(got)):
        if codes[b] == 0:
            np.testing.assert_array_equal(got[b], wavs[b])
            np.testing.assert_array_equal(ref[b], wavs[b])
        else:
            peak = np.abs(ref[b]).max()
            err = np.abs(got[b] - ref[b]).max()
            assert err <= tol * peak, (b, codes[b], err / peak)


def test_add_noise_snr_matches_pkr_tpu():
    rng = np.random.default_rng(2)
    sig = make_wavs()
    noise = rng.standard_normal((len(LENGTHS), 3000)).astype(np.float32) * 60
    noise_len = np.array([3000, 2000, 1, 2999, 100, 3000, 1500, 2500])
    snr = np.array([15, 10, 5, 0, 8, 13, 20, 17], np.float32)
    start = rng.integers(0, noise_len)
    ref = np.stack([np.asarray(ja.add_noise_snr(*map(jnp.asarray, a)))
                    for a in zip(sig, LENGTHS, noise, noise_len, snr, start)])
    got = ta.add_noise_snr(*map(torch.as_tensor, (sig, LENGTHS, noise, noise_len, snr,
                                                  start))).numpy()
    _assert_rows(got, ref, sig, np.ones(len(sig)), ADD_TOL)
    one = ta.add_noise_snr(torch.as_tensor(sig[1]), LENGTHS[1], torch.as_tensor(noise[1]),
                           noise_len[1], snr[1], start[1]).numpy()
    np.testing.assert_array_equal(one, got[1])
    for b, ln in enumerate(LENGTHS):  # exact SNR, silent tail
        added = got[b, :ln] - sig[b, :ln]
        assert abs(10 * np.log10((sig[b, :ln] ** 2).sum() / (added ** 2).sum()) - snr[b]) < 1e-3
        assert not got[b, ln:].any()


def test_reverberate_matches_pkr_tpu():
    """RIRs whose peak is not at 0, padded rows (rir_len < width), ragged
    signal lengths; the FFT size comes from the padded width."""
    rng = np.random.default_rng(3)
    sig = make_wavs()
    mats, lens = make_rirs(rng)
    pick = np.array([0, 1, 2, 3, 4, 5, 1, 3])
    ref = np.stack([np.asarray(ja.reverberate(jnp.asarray(s), jnp.asarray(ln),
                                              jnp.asarray(mats[k]), jnp.asarray(lens[k])))
                    for s, ln, k in zip(sig, LENGTHS, pick)])
    got = ta.reverberate(torch.as_tensor(sig), torch.as_tensor(LENGTHS),
                         torch.as_tensor(mats[pick]), torch.as_tensor(lens[pick])).numpy()
    _assert_rows(got, ref, sig, np.ones(len(sig)), RVB_TOL)
    np.testing.assert_allclose(got[5], sig[5], atol=1e-5 * np.abs(sig[5]).max())  # delta
    for b, ln in enumerate(LENGTHS):  # power-normalized, silent tail
        assert abs((got[b] ** 2).sum() / (sig[b, :ln] ** 2).sum() - 1) < 1e-4
        assert not got[b, ln:].any()


def test_tile_pool_matches_pkr_tpu():
    """More rows than one gather tiles, zero- and one-sample rows."""
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 300, size=ta._TILE_ROWS + 9)
    lens[[1, 2, -1]] = 0, 1, 300
    mats, lens = _pool(rng, lens, 300, 1.0)
    ref = np.asarray(ja.tile_pool(jnp.asarray(mats), jnp.asarray(lens), 450))
    got = ta.tile_pool(torch.as_tensor(mats), torch.as_tensor(lens), 450).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (len(lens), 750) and not got[1].any()  # zero-length: 0s


@pytest.mark.parametrize("kind", ["noise", "music", "babble", "reverb", "mixed"])
def test_wav_augmenter_matches_pkr_tpu(pools, kind):
    """Each kind on its own rows (two rows left clean), and a mixed draw
    (kinds=None): the same plans from one seed, the rows within tolerance,
    clean rows bit for bit."""
    wavs = make_wavs()
    kinds = None if kind == "mixed" else [kind, "none", kind, kind, kind, "none", kind, kind]
    ref_aug, port_aug = _pair(pools, seed=5)
    names = port_aug.kinds()
    assert names == ref_aug.kinds() == ["noise", "music", "babble", "reverb"]
    ref = ref_aug(wavs.copy(), LENGTHS, kinds=kinds)
    got = port_aug(wavs.copy(), LENGTHS, kinds=kinds)
    # the plans: draw again from fresh instances with the same seed
    r2, p2 = _pair(pools, seed=5)
    if kinds is None:
        codes = r2.rng.integers(0, len(names) + 1, size=len(wavs))
        codes = np.where(codes == len(names), 0, codes + 1).astype(np.int32)
        draw = p2.rng.integers(0, len(names) + 1, size=len(wavs))
        np.testing.assert_array_equal(np.where(draw == len(names), 0, draw + 1), codes)
        assert set(codes) == {0, 1, 2, 3, 4}
    else:
        codes = np.asarray([0 if k == "none" else names.index(k) + 1 for k in kinds])
    for a, b, key in zip(r2._draw_plan(codes, names, LENGTHS),
                         p2._draw_plan(codes, names, LENGTHS), PLAN_KEYS):
        np.testing.assert_array_equal(b, a, err_msg=key)
    assert isinstance(got, np.ndarray) and got.shape == wavs.shape
    _assert_rows(got, ref, wavs, codes, RVB_TOL if kind in ("reverb", "mixed") else ADD_TOL)
    for b, ln in enumerate(LENGTHS):
        assert not got[b, ln:].any()
    # the same seed on the card's code path returns the tensor (device_out)
    _, p3 = _pair(pools, seed=5)
    out = p3(torch.as_tensor(wavs), LENGTHS, kinds=kinds, device_out=True)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), got)


def _planner_pair(seed=5):
    """The same RIR and noise entries through both packages' planners, with
    room-convolved point noises: 5 RIRs in 2 rooms (the delta row is the
    augmenter's), 2 point noises (fg and bg), one isotropic noise in room
    'r0'.  600 noises a minute lets a 0.5-s utterance draw several."""
    def build(mod):
        rirs = [mod.RirEntry(f"rir{i}", f"r{i % 2}", f"rir{i}.wav") for i in range(5)]
        point = [mod.NoiseEntry("fg", "point-source", "fg.wav", bg_fg_type="foreground"),
                 mod.NoiseEntry("bg", "point-source", "bg.wav")]
        iso = {"r0": [mod.NoiseEntry("iso", "isotropic", "iso.wav", room_linkage="r0")]}
        for items in (rirs, point, iso["r0"]):
            mod.smooth_probabilities(items)
        return mod.ReverbPlanner(rirs, point, iso, foreground_snrs=(15.0, 10.0, 5.0),
                                 background_snrs=(20.0, 13.0), max_noises_per_minute=600,
                                 seed=seed)
    return build(jrir), build(trir)


def test_composed_reverb_matches_pkr_tpu(pools):
    """The composed reverb branch: reverberated speech plus up to 6 RIR-set
    noises, point-source noises convolved with an RIR of the speech's room,
    fg windows at their starts, the iso noise dry."""
    rng = np.random.default_rng(6)
    rvb_noise = _pool(rng, [4000, 8000, 6000], 8000, 500)
    wavs = make_wavs(seed=7)
    ref_pl, port_pl = _planner_pair()
    args = dict(rirs=pools["rirs"], rvb_noise=rvb_noise)
    ref_aug = ja.WavAugmenter(seed=3, reverb_planner=ref_pl, **args)
    port_aug = ta.WavAugmenter(seed=3, reverb_planner=port_pl, device="cpu", **args)
    kinds = ["reverb"] * 7 + ["none"]
    for _ in range(2):  # a second batch continues the planners' SNR cycles
        ref = ref_aug(wavs.copy(), LENGTHS, kinds=kinds)
        got = port_aug(wavs.copy(), LENGTHS, kinds=kinds)
        _assert_rows(got, ref, wavs, [1] * 7 + [0], RVB_TOL)
    assert port_pl.cap_hits == ref_pl.cap_hits
    assert (port_pl._fg_i, port_pl._bg_i) == (ref_pl._fg_i, ref_pl._bg_i)
    # the draws exercised every path: noises, several at once, room-convolved
    # point noises, the dry iso noise and a foreground window
    ref_pl, port_pl = _planner_pair()
    ref_aug = ja.WavAugmenter(seed=3, reverb_planner=ref_pl, **args)
    port_aug = ta.WavAugmenter(seed=3, reverb_planner=port_pl, device="cpu", **args)
    codes = np.array([1] * 7 + [0], np.int32)
    plan_r = ref_aug._draw_plan(codes, ["reverb"], LENGTHS)
    plan_p = port_aug._draw_plan(codes, ["reverb"], LENGTHS)
    for a, b, key in zip(plan_r, plan_p, PLAN_KEYS):
        np.testing.assert_array_equal(b, a, err_msg=key)
    src, _, _, sig_starts, durs, nrirs, n_src = plan_p
    assert n_src.max() >= 3 and (nrirs >= 0).any() and (durs > 0).any()
    assert ((nrirs < 0) & (np.arange(7)[None, :] < n_src[:, None])
            & (np.arange(7)[None, :] > 0)).any()  # a dry (iso) noise


def test_tile_budget_lru_and_set_pool_match_pkr_tpu(pools):
    """The byte-accounted LRU keeps its tiles under a small budget and evicts
    the least recently used; a call tiles only the kinds its rows use;
    set_pool drops that kind's tiles and the next batch mixes from the new
    shard.  The mixed rows match the reference's throughout."""
    ref_aug, port_aug = _pair(pools, seed=2, keys=("noise", "music"))
    for a in (ref_aug, port_aug):
        a.tile_budget_bytes = 3 * 3 * (4000 + 2000) * 4  # about three tiles

    def held():
        assert port_aug._tiled_bytes == sum(
            port_aug._tile_cost(*k) for k in port_aug._tiled) <= port_aug.tile_budget_bytes
        return list(port_aug._tiled)

    # each call tiles noise, then music; the budget holds three tiles
    N2, M2, N16, M16 = ("noise", 2000), ("music", 2000), ("noise", 1600), ("music", 1600)
    expect = [[N2, M2], [M2, N16, M16], [M16, N2, M2], [M2, ("noise", 1200), ("music", 1200)]]
    for n, keys in zip((2000, 1600, 2000, 1200), expect):
        wavs = make_wavs(lengths=[n] * 3, n=n, seed=n)
        lens = np.full(3, n)
        ref = ref_aug(wavs.copy(), lens, kinds=["noise", "music", "noise"])
        got = port_aug(wavs.copy(), lens, kinds=["noise", "music", "noise"])
        _assert_rows(got, ref, wavs, [1, 1, 1], ADD_TOL)
        assert held() == keys
    rng = np.random.default_rng(9)
    shard = _pool(rng, [4000, 100, 2000], 4000, 1000)
    for a in (ref_aug, port_aug):
        a.set_pool("noise", shard)
    assert held() == [("music", 2000), ("music", 1200)]
    wavs = make_wavs(lengths=[1200] * 3, n=1200, seed=1)
    ref = ref_aug(wavs.copy(), np.full(3, 1200), kinds=["noise"] * 3)
    got = port_aug(wavs.copy(), np.full(3, 1200), kinds=["noise"] * 3)
    _assert_rows(got, ref, wavs, [1, 1, 1], ADD_TOL)
    # a batch of noise rows only tiles no music
    assert held() == [("music", 2000), ("music", 1200), ("noise", 1200)]
    with pytest.raises(ValueError, match="shape"):
        port_aug.set_pool("noise", _pool(rng, [10], 10, 1.0))
