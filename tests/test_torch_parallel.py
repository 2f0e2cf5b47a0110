"""The port's parallelism against pkr_tpu's, on the CPU.

Each group of checks spawns its ranks once, as processes of one gloo group
(``pkr_tpu_torch.parallel.distributed.spawn``; the ranks' functions are in
test_torch_parallel_ranks.py, which imports neither JAX nor pkr_tpu), and
holds what they return against ``pkr_tpu`` on the conftest's 8-device CPU
mesh, its Pallas kernels in interpret mode, on the same numpy inputs:

- the class-sharded flash head on a 2 x 2 mesh (B = 8, C = 64, D = 32) and
  its replicated fallback (C = 63, which a 2-way model axis does not
  divide), each against ``make_flash_aam_sharded(..., interpret=True)``:
  loss within 1e-5, top-1 and top-5 equal, dE and dW within 1e-5 of their
  tensor's largest entry (+1e-7).  Every data shard's labels lie on both
  class shards, so each class shard sees shard-local labels below 0 and
  at or above its width;
- two data-parallel train steps of tiny_resnet (global B = 8, 2 ranks),
  dense and flash heads, against ``pkr_tpu``'s ``make_train_step`` over a
  2-device mesh and against the port's one-process step: the losses, every
  parameter, the momentum and the BatchNorm running statistics at
  test_torch_train.py's bounds; an inf in one rank's shard commits nothing
  on any rank;
- the sharded cache: the shard assignment, the loader's per-step ids and
  the crops at ``pkr_tpu``'s own draws against its sharded sampling
  (within 2e-5);
- a checkpoint written by two class-sharded ranks restores in one process,
  and a one-process checkpoint restores into the two ranks' shards;
- ``dryrun_multichip(4)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pkr_tpu_torch.parallel.distributed import spawn

from test_torch_parallel_ranks import checkpoint_rank, head_rank, train_rank
from test_torch_train import (
    LOSS_TOL,
    LR,
    B,
    F,
    SPK,
    T,
    assert_state_matches,
    batches,
    make_pair,
    port_from,
)

HEAD_TOL = 1e-5
HEAD_B, HEAD_D = 8, 32
# rows 0-3 are data shard 0, rows 4-7 shard 1; each holds targets on both
# class shards of C = 64 (0-31, 32-63), and all lie below 63
HEAD_LABELS = np.asarray([3, 40, 17, 60, 31, 32, 5, 50])
HEAD_CASES = {"class_sharded": 64, "replicated": 63}


def _jax_mesh(n_data, n_model):
    from pkr_tpu.parallel import make_mesh

    return make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])


def _head_inputs(C, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((C, HEAD_D)).astype(np.float32)
    emb = (0.5 * w[HEAD_LABELS] + rng.standard_normal((HEAD_B, HEAD_D))).astype(np.float32)
    return emb, w, HEAD_LABELS.copy()


@pytest.fixture(scope="module")
def head_runs():
    cases = [(name, *_head_inputs(C, seed)) for seed, (name, C) in
             enumerate(HEAD_CASES.items())]
    return cases, spawn(head_rank, 4, args=(cases, 2, 2), device="cpu")


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_sharded_head_matches_pkr_tpu(head_runs, name):
    from pkr_tpu.ops.flash_aam import make_flash_aam_sharded

    cases, ranks = head_runs
    _, emb, w, labels = next(c for c in cases if c[0] == name)
    C = w.shape[0]
    fn = make_flash_aam_sharded(_jax_mesh(2, 2), C, 0.2, 30.0, interpret=True,
                                with_acc=True)
    loss, acc1, acc5 = (float(v) for v in fn(jnp.asarray(emb), jnp.asarray(w),
                                               jnp.asarray(labels)))
    de_ref, dw_ref = (np.asarray(g) for g in jax.grad(
        lambda e, wt: fn(e, wt, jnp.asarray(labels))[0], argnums=(0, 1))(
            jnp.asarray(emb), jnp.asarray(w)))
    de, dw = np.zeros_like(de_ref), np.zeros_like(dw_ref)
    for r in ranks:
        got = r[name]
        assert got["sharded"] == (name == "class_sharded")
        assert abs(got["loss"] - loss) <= HEAD_TOL, (got["loss"], loss)
        assert (got["acc1"], got["acc5"]) == (acc1, acc5)
        de[slice(*got["rows"])] = got["de"]
        if got["sharded"] or r["model_index"] == 0:
            dw[slice(*got["cls"])] = got["dw"]
        else:  # the whole weight's gradient, the same on every model rank
            np.testing.assert_array_equal(got["dw"], ranks[0][name]["dw"])
    for g, ref in ((de, de_ref), (dw, dw_ref)):
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=HEAD_TOL * float(np.abs(ref).max()) + 1e-7)


def test_sharded_head_labels_cover_both_shards(head_runs):
    """The labels put targets on both class shards in each data shard."""
    for half in (HEAD_LABELS[:4], HEAD_LABELS[4:]):
        assert (half < 32).any() and (half >= 32).any()
    assert acc_rows_varied(head_runs)


def acc_rows_varied(head_runs):
    """Some rows' targets win and some lose, so top-1/top-5 are exercised."""
    _, ranks = head_runs
    accs = {(r["class_sharded"]["acc1"], r["class_sharded"]["acc5"]) for r in ranks}
    return all(0.0 < a5 for _, a5 in accs) and all(a1 < 1.0 for a1, _ in accs)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------

TRAIN_HEADS = {"dense": ("AAM", False), "flash": ("AAM", True)}


def _jax_mesh_steps(fm, jstate, data, flash):
    from pkr_tpu.parallel import batch_sharding
    from pkr_tpu.train.loop import make_train_step as jax_make_train_step

    mesh = _jax_mesh(2, 1)
    _, jstep = jax_make_train_step(fm, flash_aam=flash, flash_interpret=True, mesh=mesh)
    shard = batch_sharding(mesh)
    metrics = []
    for x, y in data:
        jstate, m = jstep(jstate, jax.device_put(jnp.asarray(x), shard),
                          jax.device_put(jnp.asarray(y), shard),
                          jnp.asarray(LR, jnp.float32))
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


@pytest.fixture(scope="module")
def train_runs():
    runs, refs = [], {}
    for name, (loss, flash) in TRAIN_HEADS.items():
        fm, jstate, tm, tstate = make_pair(loss, seed=3)
        data = batches(2, seed=11)
        refs[name] = (fm, jstate, data)
        cfg = {"spk": SPK, "feat": F, "loss": loss, "step": 0}
        runs.append((name, tm.state_dict(), tstate.momentum, flash, data, LR, None, cfg))
    # an inf in rank 1's shard of the first batch, from a state with momentum
    fm, jstate, tm, tstate = refs["dense"][0], refs["dense"][1], None, None
    tm, tstate = port_from(jstate, "AAM")
    cfg = {"spk": SPK, "feat": F, "loss": "AAM", "step": 0}
    runs.append(("nan", tm.state_dict(), tstate.momentum, True, batches(1, seed=12),
                 LR, 1, cfg))
    return refs, spawn(train_rank, 2, args=(runs, 2), device="cpu")


@pytest.mark.parametrize("name", list(TRAIN_HEADS))
def test_data_parallel_steps_match_pkr_tpu_mesh(train_runs, name):
    """Two steps over 2 ranks (B = 4 each) against pkr_tpu's step over a
    2-device data mesh at the global B = 8: the same global losses and
    metrics on both ranks, and every rank's parameters, momentum and
    BatchNorm statistics (the global batch's) at test_torch_train.py's
    bounds."""
    from test_torch_train import assert_metrics_match

    refs, ranks = train_runs
    fm, jstate, data = refs[name]
    jstate, jm = _jax_mesh_steps(fm, jstate, data, TRAIN_HEADS[name][1])
    for r in ranks:
        got = r[name]
        assert_metrics_match(jm, got["metrics"])
        tm, tstate = port_from(jstate, TRAIN_HEADS[name][0])
        tm.load_state_dict(got["sd"])
        tstate.momentum = got["momentum"]
        tstate.step = torch.tensor(got["step"])
        assert_state_matches(jstate, tm, tstate)


@pytest.mark.parametrize("name", list(TRAIN_HEADS))
def test_data_parallel_steps_match_one_process(train_runs, name):
    """The 2-rank steps against the port's one-process step on the whole
    batch: the losses at LOSS_TOL, the parameters at rtol 1e-3 / atol 1e-5,
    the statistics and momentum at rtol 1e-4 / 1e-4 of their tensor's
    largest entry (the one-pass global BatchNorm and the split sums round
    differently from one process's)."""
    from test_torch_train import run_port, stat_tol

    refs, ranks = train_runs
    _, jstate, data = refs[name]
    loss, flash = TRAIN_HEADS[name]
    tm, tstate = port_from(jstate, loss)
    tstate, tmm = run_port(tm, tstate, data, flash)
    ref_sd = tm.state_dict()
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in tmm], **LOSS_TOL)
        for k, ref in ref_sd.items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(got["sd"][k], ref), k
                continue
            tol = (stat_tol(ref) if ".running_" in k else dict(rtol=1e-3, atol=1e-5))
            np.testing.assert_allclose(got["sd"][k].numpy(), ref.numpy(), **tol, err_msg=k)
        for k, ref in tstate.momentum.items():
            np.testing.assert_allclose(got["momentum"][k].numpy(), ref.numpy(),
                                       **stat_tol(ref), err_msg=k)
    # the ranks hold the same bits: one reduction, one update
    for k, v in ranks[0][name]["sd"].items():
        assert torch.equal(v, ranks[1][name]["sd"][k]), k


def test_nan_on_one_rank_commits_nothing(train_runs):
    """An inf in rank 1's features: the global loss is not finite on both
    ranks, and neither commits its parameters, momentum or BatchNorm
    statistics; the step advances."""
    refs, ranks = train_runs
    tm, tstate = port_from(refs["dense"][1], "AAM")
    for r in ranks:
        got = r["nan"]
        assert not np.isfinite(got["metrics"][0]["loss"])
        assert got["step"] == 1
        for k, v in tm.state_dict().items():
            assert torch.equal(got["sd"][k], v), k
        for k, v in tstate.momentum.items():
            assert torch.equal(got["momentum"][k], v), k


# ---------------------------------------------------------------------------
# the sharded cache
# ---------------------------------------------------------------------------

CACHE_UTTS, CACHE_SPK, CACHE_B, CACHE_T = 13, 4, 4, 24


def _cache_corpus():
    rng = np.random.default_rng(21)
    mats = {f"utt{i:02d}": rng.standard_normal((int(rng.integers(10, 60)), 8))
            .astype(np.float32) for i in range(CACHE_UTTS)}
    labels = {u: i % CACHE_SPK for i, u in enumerate(mats)}
    return mats, labels


def test_sharded_cache_matches_pkr_tpu():
    """Shard assignment, n_utts, the per-step global ids over two epochs and
    each rank's crops at pkr_tpu's own uniform draws (fold_in(key(step
    seed), shard)) against pkr_tpu's ShardedDeviceFeatureCache and
    ShardedCacheLoader on a 2-device mesh: crops within atol 2e-5 (the bar
    test_torch_device_cache.py holds the one-card cache to: XLA fuses the
    dequantization's products, the port rounds each on its own), labels
    equal."""
    from pkr_tpu.data.device_cache import ShardedCacheLoader as JaxLoader
    from pkr_tpu.data.device_cache import ShardedDeviceFeatureCache as JaxCache
    from pkr_tpu_torch.data import ShardedCacheLoader, ShardedDeviceFeatureCache
    from pkr_tpu_torch.parallel.mesh import Mesh

    mats, labels = _cache_corpus()
    jcache = JaxCache.build(mats, labels, _jax_mesh(2, 1))
    jloader = JaxLoader(jcache, CACHE_B, chunk=CACHE_T, seed=5)
    steps = []
    real_sample = jcache.sample_batch
    jcache.sample_batch = lambda ids, key, seq: steps.append((ids, key)) or real_sample(
        ids, key, seq)
    jbatches = [b for e in range(2) for b in jloader.epoch(e)]
    assert steps
    b_local = CACHE_B // 2
    for d in range(2):
        cache = ShardedDeviceFeatureCache.build(mats, labels, Mesh(2, 1, d, 0),
                                                device="cpu")
        assert cache.utts_per_shard == jcache.utts_per_shard
        np.testing.assert_array_equal(cache.n_utts, jcache.n_utts)
        loader = ShardedCacheLoader(cache, CACHE_B, chunk=CACHE_T, seed=5)
        assert loader.batches_per_epoch() == jloader.batches_per_epoch()
        ids = [i for e in range(2) for i in loader.step_ids(e)]
        assert len(ids) == len(steps)
        mine = [b for e in range(2) for b in loader.epoch(e)]
        for (jids, key32), got_ids, (jf, jl), (_, tl) in zip(steps, ids, jbatches, mine):
            np.testing.assert_array_equal(got_ids, jids)
            seg = slice(d * b_local, (d + 1) * b_local)
            u = jax.random.uniform(jax.random.fold_in(jax.random.key(
                jnp.asarray([key32], jnp.uint32)[0]), d), (b_local,))
            feats, lab = cache.sample_batch(jids[seg], torch.from_numpy(np.array(u)),
                                            CACHE_T)
            np.testing.assert_allclose(feats.numpy(), np.asarray(jf)[seg], rtol=0,
                                       atol=2e-5)
            np.testing.assert_array_equal(lab.numpy(), np.asarray(jl)[seg])
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl)[seg])


# ---------------------------------------------------------------------------
# checkpoints and the dry run
# ---------------------------------------------------------------------------


def test_class_sharded_checkpoint_round_trip(tmp_path):
    """A one-process checkpoint restores into two class-sharded ranks (each
    holds its rows of the weight and the momentum); after a flash step the
    ranks save together, and the checkpoint, restored in one process, holds
    the whole weight and momentum: both ranks' rows, bit for bit."""
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.train import create_train_state, restore_checkpoint, save_checkpoint

    cfg = {"spk": SPK, "feat": F}
    model = SpeakerModel(SPK, F, loss="AAM", trunk="tiny_resnet", dtype=torch.float32,
                         device="cpu", generator=torch.Generator().manual_seed(4))
    state = create_train_state(model)
    state.momentum["last.weight"].normal_(generator=torch.Generator().manual_seed(5))
    save_checkpoint(str(tmp_path / "whole"), model, state, sync=True)
    (x, y), = batches(1, seed=13)
    ranks = spawn(checkpoint_rank, 2, args=(str(tmp_path / "whole"), str(tmp_path / "tp"),
                                            x, y, cfg), device="cpu")
    half = SPK // 2
    for r in ranks:
        assert r["spec"] == {"last.weight": 0}
        rows = slice(r["model_index"] * half, (r["model_index"] + 1) * half)
        assert torch.equal(r["restored"][0], model.last.weight.detach()[rows])
        assert torch.equal(r["restored"][1], state.momentum["last.weight"][rows])
    fresh = SpeakerModel(SPK, F, loss="AAM", trunk="tiny_resnet", dtype=torch.float32,
                         device="cpu")
    got = restore_checkpoint(str(tmp_path / "tp"), fresh, create_train_state(fresh))
    assert got is not None and got.epoch == 1 and int(got.step) == 1
    by_rank = sorted(ranks, key=lambda r: r["model_index"])
    assert torch.equal(fresh.last.weight.detach(),
                       torch.cat([r["weight"] for r in by_rank]))
    assert torch.equal(got.momentum["last.weight"],
                       torch.cat([r["momentum"] for r in by_rank]))
    for k, v in fresh.state_dict().items():
        if k != "last.weight":
            assert torch.equal(v, by_rank[0]["sd"][k]), k


def test_dryrun_multichip_on_cpu():
    """pkr_tpu_torch's dryrun_multichip(4): a 2 x 2 mesh; a dense step, the
    flash head class-sharded (16 speakers) and replicated (7325), and a
    step from the sharded cache, every loss finite and equal on the four
    ranks."""
    from pkr_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, device="cpu")
    assert (res["n_data"], res["n_model"], res["aam_rows"]) == (2, 2, 8)
    for k in ("loss", "flash_sharded", "flash_replicated", "cache_step"):
        assert np.isfinite(res[k]), k
