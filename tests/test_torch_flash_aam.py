"""Port flash AAM head (pkr_tpu_torch.ops.flash_aam) on the CPU.

On a CPU tensor both directions run their plain class-tiled PyTorch
versions; they are held against pkr_tpu's Pallas kernels in interpret mode
and against both packages' dense reference, on the cases of
tests/test_flash_aam.py: class counts that are not a multiple of the tile,
both margin branches, and a saturated target cosine (exactly 1.0).  The
loss is held within 1e-4, the bar tests/test_flash_aam.py holds the Pallas
kernel to; top-1 and top-5 must be equal; the per-example online state
(lse, zy, mx) within 1e-4 (logits are scaled by s=30, so that is ~3e-6 in
cosine) and the rank count exactly.  Gradients are held at rtol 2e-3,
atol 1e-6, the bar of tests/test_flash_aam.py's gradient tests.  The
backward's raw outputs (dê, dW) are held against the Pallas backward within
2e-4 of their largest entry: the random cases agree to ~1e-6 of it, but the
margin case's aligned rows have sin θ ≈ 1e-4, where phi' = cos_m +
sin_m·cos/sin turns a 1-ulp difference of cos into ~1e-4 of dê's scale (a
component along ê, which the unprojection of the gradient removes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pkr_tpu.ops import flash_aam as jax_flash
from pkr_tpu_torch.ops import flash_aam as port_flash
from pkr_tpu_torch.ops.aam import aam_logits
from pkr_tpu_torch.train.loop import topk_correct


def make(B=16, D=32, C=50, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, D)).astype(np.float32)
    w = rng.standard_normal((C, D)).astype(np.float32)
    labels = rng.integers(0, C, B)
    return emb, w, labels


def margin_branch_case():
    """Half the embeddings aligned with their class (phi branch), half
    anti-aligned (the cos - mm guard)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    labels = np.arange(8) % 64
    base = w[labels]
    emb = (np.concatenate([base[:4], -base[4:]]) * 3.0).astype(np.float32)
    return emb, w, labels


def saturated_case():
    """cos(target) EXACTLY 1.0: one-hot embedding = normalized weight row."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    w[5] = 0.0
    w[5, 2] = 2.0
    emb = np.zeros((4, 16), np.float32)
    emb[:, 2] = 1.0
    return emb, w, np.array([5, 5, 7, 9])


CASES = {
    "C50_tile128": (make(C=50), 128),
    "C300_tile256": (make(C=300), 256),
    "C257_tile128": (make(C=257), 128),
    "margin_branches": (margin_branch_case(), 128),
    "saturated": (saturated_case(), 128),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_accuracy_parity(name):
    (emb, w, labels), tile = CASES[name]
    ref = jax_flash.flash_aam_loss_acc(jnp.asarray(emb), jnp.asarray(w),
                                       jnp.asarray(labels), 0.2, 30.0, tile, True)
    dense = float(jax_flash.reference_aam_loss(jnp.asarray(emb), jnp.asarray(w),
                                               jnp.asarray(labels)))
    got = port_flash.flash_aam_loss_acc(torch.from_numpy(emb), torch.from_numpy(w),
                                        torch.from_numpy(labels), 0.2, 30.0, tile)
    port_dense = float(port_flash.reference_aam_loss(
        torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(labels)))
    assert abs(float(got[0]) - float(ref[0])) < 1e-4, (float(got[0]), float(ref[0]))
    assert abs(float(got[0]) - dense) < 1e-4, (float(got[0]), dense)
    assert abs(port_dense - dense) < 1e-4, (port_dense, dense)
    assert float(got[1]) == float(ref[1])
    assert float(got[2]) == float(ref[2])
    assert np.isfinite([float(g) for g in got]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_online_state_parity(name):
    """Per-example (lse, zy, mx, cnt) of the plain version against the
    Pallas kernel's outputs (interpret mode)."""
    (emb, w, labels), tile = CASES[name]
    e_hat_j, _ = jax_flash._normalize(jnp.asarray(emb))
    ref = jax_flash._fwd_pallas(e_hat_j, jnp.asarray(w), jnp.asarray(labels),
                                0.2, 30.0, tile, True)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    wt, lt = torch.from_numpy(w), torch.from_numpy(labels)
    zt = port_flash._margined_target_z(e_hat, wt, lt, 0.2, 30.0)
    got = port_flash.flash_aam_fwd(e_hat, wt, lt, zt, 0.2, 30.0, tile)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_online_topk_matches_dense_topk():
    """zy >= mx and cnt < 5 count what dense top-1/top-5 of the margined
    logits count."""
    emb, w, labels = make(B=64, D=16, C=40, seed=5)
    e, wt, lt = torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(labels)
    logits = aam_logits(e, wt, lt)
    _, acc1, acc5 = port_flash.flash_aam_loss_acc(e, wt, lt, tile=16)
    assert float(acc1) * 64 == float(topk_correct(logits, lt, 1))
    assert float(acc5) * 64 == float(topk_correct(logits, lt, 5))


def _port_grads(fn, emb, w, labels, tile):
    e = torch.from_numpy(emb).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = fn(e, wt, torch.from_numpy(labels), tile)
    loss.backward()
    return float(loss), e.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_parity(name):
    """d loss / d (emb, weight) of the flash op, whose backward runs
    flash_aam_bwd_plain here, against pkr_tpu's flash gradients (Pallas,
    interpret mode) and the port's dense autograd."""
    (emb, w, labels), tile = CASES[name]
    r_emb, r_w = jax.grad(
        lambda e, w_: jax_flash.flash_aam_loss(e, w_, jnp.asarray(labels), 0.2, 30.0,
                                               tile, True),
        argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    loss, g_emb, g_w = _port_grads(
        lambda e, w_, y, t: port_flash.flash_aam_loss(e, w_, y, 0.2, 30.0, t),
        emb, w, labels, tile)
    _, d_emb, d_w = _port_grads(
        lambda e, w_, y, t: port_flash.reference_aam_loss(e, w_, y, 0.2, 30.0),
        emb, w, labels, tile)
    assert np.isfinite(g_emb).all() and np.isfinite(g_w).all()
    for got, ref in ((g_emb, r_emb), (g_w, r_w), (g_emb, d_emb), (g_w, d_w)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_matches_pallas_bwd(name):
    """(dê, dW) of flash_aam_bwd (its plain version on the CPU) against the
    Pallas backward kernel's outputs, with a per-example gradient g."""
    (emb, w, labels), tile = CASES[name]
    e_hat_j, _ = jax_flash._normalize(jnp.asarray(emb))
    lse_j = jax_flash._fwd_pallas(e_hat_j, jnp.asarray(w), jnp.asarray(labels), 0.2, 30.0,
                                  tile, True)[0]
    g = np.linspace(0.5, 1.5, len(labels)).astype(np.float32)
    ref = jax_flash._bwd_pallas(e_hat_j, jnp.asarray(w), jnp.asarray(labels), lse_j,
                                jnp.asarray(g), 0.2, 30.0, tile, True)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    got = port_flash.flash_aam_bwd(e_hat, torch.from_numpy(w), torch.from_numpy(labels),
                                   torch.tensor(np.asarray(lse_j)), torch.from_numpy(g),
                                   0.2, 30.0, tile)
    for gt, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(gt.numpy(), r, rtol=1e-4,
                                   atol=2e-4 * float(np.abs(r).max()) + 1e-6)


def test_forward_only_raises_on_grad():
    """The forward-only guard is gone: with gradients enabled the op builds a
    graph, the loss's gradients reach emb and weight, and the metrics carry
    none.  Under no_grad (the eval head) no graph is built."""
    emb, w, labels = make()
    e = torch.from_numpy(emb).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss, acc, acc5 = port_flash.flash_aam_loss_acc(e, wt, torch.from_numpy(labels))
    assert loss.requires_grad and not acc.requires_grad and not acc5.requires_grad
    (loss + acc + acc5).backward()
    assert torch.isfinite(e.grad).all() and float(e.grad.abs().max()) > 0
    assert torch.isfinite(wt.grad).all() and float(wt.grad.abs().max()) > 0
    with torch.no_grad():
        loss2, _, _ = port_flash.flash_aam_loss_acc(e, wt, torch.from_numpy(labels))
    assert not loss2.requires_grad and float(loss2) == float(loss)


def test_wrapper_checks_inputs():
    emb, w, labels = make()
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    zt = torch.zeros(16)
    with pytest.raises(ValueError):
        port_flash.flash_aam_fwd(e_hat, torch.from_numpy(w[:, :8]),
                                 torch.from_numpy(labels), zt)
    with pytest.raises(TypeError):
        port_flash.flash_aam_fwd(e_hat.double(), torch.from_numpy(w).double(),
                                 torch.from_numpy(labels), zt)
    before = port_flash.flash_aam_fwd.launches
    port_flash.flash_aam_fwd(e_hat, torch.from_numpy(w), torch.from_numpy(labels), zt)
    assert port_flash.flash_aam_fwd.launches == before  # CPU: plain version


def test_cpu_call_counts_no_route():
    """A CPU call of either wrapper runs the plain version and leaves every
    route's launch count at 0: only a launch on the card counts."""
    emb, w, labels = make(D=300)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    wt, lt = torch.from_numpy(w), torch.from_numpy(labels)
    zt = port_flash._margined_target_z(e_hat, wt, lt, 0.2, 30.0)
    lse = port_flash.flash_aam_fwd(e_hat, wt, lt, zt)[0]
    port_flash.flash_aam_bwd(e_hat, wt, lt, lse, torch.ones(16))
    assert port_flash.flash_aam_fwd.route_launches == {"tiles": 0, "cluster": 0, "passes": 0}
    assert port_flash.flash_aam_bwd.route_launches == {"tiles": 0, "wide": 0, "passes": 0,
                                                       "cluster": 0}


# D -> (depth passes, blocks a cluster, de workers a batch tile and split) of
# the passes routes (D > 4096): 4097 (a last slice of one column) to 8192 in
# two passes of 9 to 16 blocks, then three, four and five
PASSES_GEOMETRY = {4097: (2, 9, 2), 4608: (2, 9, 2), 6001: (2, 12, 2), 8192: (2, 16, 2),
                   8193: (3, 11, 4), 12288: (3, 16, 4), 12289: (4, 13, 4), 20000: (5, 16, 6)}


@pytest.mark.parametrize("D", sorted(PASSES_GEOMETRY))
def test_bwd_passes_geometry(D):
    """passes_geometry, the libraries' n_passes and passes_cluster: the
    ⌈D/256⌉ slices in the fewest passes of at most 16, each pass on a
    cluster of 9 to 16 blocks (past the portable 8, within Hopper's 16),
    the fewest that cover the slices in that many passes, so that only the
    last pass has idle blocks; and the backward's de workers, a half tile
    and an output group of two passes each."""
    passes, blocks, workers = PASSES_GEOMETRY[D]
    assert port_flash.passes_geometry(D) == (passes, blocks)
    assert port_flash.bwd_passes_de_workers(D) == workers
    n_s = -(-D // 256)
    assert 9 <= blocks <= 16
    assert (passes - 1) * blocks < n_s <= passes * blocks
    assert passes == -(-n_s // 16) and (blocks - 1) * passes < n_s


def test_bwd_passes_geometry_is_past_the_cluster_route():
    with pytest.raises(ValueError):
        port_flash.passes_geometry(4096)


@pytest.mark.parametrize("D", [4097, 4608, 6001, 8192, 8193, 12288])
def test_fwd_passes_geometry(D):
    """Past 4096 the forward takes its passes route on the backward's
    geometry (one layout in flash_aam_cosine.cuh): the same depth passes and
    clusters as PASSES_GEOMETRY, and its scratch holds a partial state of
    each row for every block of each split's cluster, n_splits × blocks."""
    passes, blocks, _ = PASSES_GEOMETRY[D]
    assert port_flash.fwd_geometry(D) == ("passes", passes, blocks)
    assert port_flash.fwd_geometry(D)[1:] == port_flash.passes_geometry(D)
    for n_splits in (1, 7, 58):
        assert port_flash.fwd_states(D, n_splits) == n_splits * blocks


@pytest.mark.parametrize("D,route,blocks", [(37, "tiles", 1), (256, "tiles", 1),
                                            (257, "cluster", 2), (2048, "cluster", 8),
                                            (2049, "cluster", 9), (4096, "cluster", 16)])
def test_fwd_geometry_up_to_the_passes_route(D, route, blocks):
    """Up to 4096 the forward's workers are a block (the tiles route) or a
    cluster of ⌈D/256⌉ blocks in one pass (the cluster route), each block
    with its own partial states."""
    assert port_flash.fwd_geometry(D) == (route, 1, blocks)
    assert port_flash.fwd_states(D, 5) == 5 * blocks


# (class tiles, batch tiles, SMs, blocks an SM): the kernels' shapes on an
# H100 (132 SMs; the backward's wide route holds one block an SM, the other
# routes and the forward two), then small and ragged cards
SPLIT_CASES = [(229, 8, 132, 2), (229, 8, 132, 1), (229, 32, 132, 2), (229, 4, 132, 2),
               (4096, 8, 132, 2), (219, 4, 132, 1), (219, 4, 132, 2), (2, 1, 132, 2),
               (1, 1, 132, 1), (5, 1, 2, 2), (101, 1, 100, 1), (63, 2, 8, 3),
               (1000, 3, 7, 1)]


@pytest.mark.parametrize("n_tiles,n_btiles,sms,blocks_per_sm", SPLIT_CASES)
def test_split_rule_covers_every_class_tile_once(n_tiles, n_btiles, sms, blocks_per_sm):
    """The class splits of both kernels (_n_splits): split s takes the class
    tiles [s·tps, min(s·tps + tps, n_tiles)), as the kernels read it, so
    every class tile lies in exactly one split and none is empty.  Each
    (batch tile, split) block takes the even share of the target = SMs ×
    blocks per SM, tps = ⌈pairs / target⌉ tile pairs (pairs = batch tiles ×
    class tiles), so the blocks reach the target's fill as far as the tiles
    allow: every pair its own block where pairs ≤ target, else at least
    ⌈pairs / tps⌉ blocks and fewer than target + batch tiles."""
    tps, n_splits = port_flash._n_splits(n_tiles, n_btiles, sms, blocks_per_sm)
    target, pairs = sms * blocks_per_sm, n_tiles * n_btiles
    owned = [t for split in range(n_splits)
             for t in range(split * tps, min(split * tps + tps, n_tiles))]
    assert sorted(owned) == list(range(n_tiles))
    assert (n_splits - 1) * tps < n_tiles  # the last split holds a tile
    fill = n_btiles * n_splits
    if pairs <= target:
        assert tps == 1 and fill == pairs
    else:
        assert (tps - 1) * target < pairs <= tps * target
        assert -(-pairs // tps) <= fill < target + n_btiles


# the parent's (tiles per split, splits) of SPLIT_CASES, before the
# backward's cluster route: the block routes keep them
BLOCK_ROUTE_SPLITS = {
    (229, 8, 132, 2): (7, 33), (229, 8, 132, 1): (14, 17), (229, 32, 132, 2): (28, 9),
    (229, 4, 132, 2): (4, 58), (4096, 8, 132, 2): (125, 33), (219, 4, 132, 1): (7, 32),
    (219, 4, 132, 2): (4, 55), (2, 1, 132, 2): (1, 2), (1, 1, 132, 1): (1, 1),
    (5, 1, 2, 2): (2, 3), (101, 1, 100, 1): (2, 51), (63, 2, 8, 3): (6, 11),
    (1000, 3, 7, 1): (429, 3)}


def test_split_rule_of_the_block_routes_is_unchanged():
    """The tiles routes of both kernels and the backward's wide route split
    by resident blocks (SMs × blocks an SM) and give the same numbers as
    before the cluster routes."""
    assert set(BLOCK_ROUTE_SPLITS) == set(SPLIT_CASES)
    for case, want in BLOCK_ROUTE_SPLITS.items():
        assert port_flash._n_splits(*case) == want, case


# (class tiles, batch tiles, clusters the card holds at once): the
# backward's cluster route on an H100 (two blocks an SM: 62 clusters of 4 at
# D = 1024, 30 of 8 at 2048, 79 of 3 at 513, and past the portable size 23
# of 9 at 2304, 16 of 12 at 3001, 14 of 16 at 4096), then small and ragged
# cards
CLUSTER_SPLIT_CASES = [(219, 4, 62), (229, 8, 62), (229, 8, 30), (219, 2, 79), (229, 1, 62),
                       (1, 1, 62), (5, 3, 2), (63, 2, 1), (1000, 3, 7), (219, 4, 23),
                       (219, 4, 16), (229, 8, 14), (229, 4, 14)]


@pytest.mark.parametrize("n_tiles,n_btiles,clusters", CLUSTER_SPLIT_CASES)
def test_split_rule_by_clusters_covers_every_class_tile_once(n_tiles, n_btiles, clusters):
    """On the backward's cluster route every (batch tile, split) worker is
    a cluster of blocks, so the target is the clusters that the card holds
    at once (_n_splits(n_tiles, n_btiles, clusters, 1)): every class tile
    lies in exactly one split, none is empty, and the clusters reach the
    target's fill as the block routes' blocks reach theirs."""
    tps, n_splits = port_flash._n_splits(n_tiles, n_btiles, clusters, 1)
    pairs = n_tiles * n_btiles
    owned = [t for split in range(n_splits)
             for t in range(split * tps, min(split * tps + tps, n_tiles))]
    assert sorted(owned) == list(range(n_tiles))
    assert (n_splits - 1) * tps < n_tiles
    fill = n_btiles * n_splits
    if pairs <= clusters:
        assert tps == 1 and fill == pairs
    else:
        assert (tps - 1) * clusters < pairs <= tps * clusters
        assert -(-pairs // tps) <= fill < clusters + n_btiles


# (class tiles, batch tiles, clusters the card holds at once) -> the
# forward's cluster route's (tiles per split, splits): on an H100 (132
# clusters of 2 at D = 300 and 512, 62 of 4 at 1024, 30 of 8 at 2048, and
# past the portable size 23 of 9 at 2304, 16 of 12 at 3001, 14 of 16 at
# 4096) at B = 256, 128 and 100 over 7325 and 7001 classes, then small and
# ragged cards
FWD_CLUSTER_SPLITS = {
    (229, 8, 132): (14, 17), (229, 8, 62): (31, 8), (229, 8, 30): (31, 8),
    (229, 4, 132): (7, 33), (229, 4, 62): (15, 16), (219, 4, 132): (7, 32),
    (219, 4, 62): (15, 15), (219, 4, 30): (30, 8), (219, 2, 30): (15, 15),
    (229, 1, 62): (4, 58), (1, 1, 62): (1, 1), (5, 3, 2): (4, 2), (63, 2, 1): (126, 1),
    (1000, 3, 7): (429, 3), (7, 4, 9): (4, 2), (219, 4, 23): (40, 6), (219, 4, 16): (55, 4),
    (229, 8, 14): (66, 4), (229, 4, 14): (66, 4)}


def _list_scheduled_end(n_tiles, n_btiles, clusters, tps):
    """The end of the last worker, one worker at a time: (batch tile, split)
    workers in grid order, each on the cluster that frees first, taking its
    split's tiles plus the start-up tiles."""
    n_splits = -(-n_tiles // tps)
    free = [0] * clusters
    for u in range(n_btiles * n_splits):
        split = u // n_btiles
        tiles = min(tps, n_tiles - split * tps)
        k = free.index(min(free))
        free[k] += tiles + port_flash._START_TILES
    return max(free)


@pytest.mark.parametrize("case", list(FWD_CLUSTER_SPLITS))
def test_forward_cluster_splits_keep_one_wave(case):
    """The forward's cluster route (_cluster_splits): every class tile lies
    in exactly one split and none is empty; its last worker ends no later
    than with any other split size, and it keeps the workers to one wave
    unless more waves end sooner.  _span agrees with scheduling the workers
    one at a time."""
    n_tiles, n_btiles, clusters = case
    tps, n_splits = port_flash._cluster_splits(*case)
    assert (tps, n_splits) == FWD_CLUSTER_SPLITS[case]
    owned = [t for split in range(n_splits)
             for t in range(split * tps, min(split * tps + tps, n_tiles))]
    assert sorted(owned) == list(range(n_tiles))
    assert (n_splits - 1) * tps < n_tiles
    span = port_flash._span(*case, tps)
    assert span == _list_scheduled_end(*case, tps)
    spans = {t: port_flash._span(*case, t) for t in range(1, n_tiles + 1)}
    assert span <= min(spans.values())
    one_wave = [v for t, v in spans.items() if n_btiles * -(-n_tiles // t) <= clusters]
    if one_wave and n_btiles * n_splits > clusters:
        assert span < min(one_wave)
    even = port_flash._n_splits(n_tiles, n_btiles, clusters, 1)[0]
    assert span <= port_flash._span(*case, even)


# (class tiles, batch tiles, clusters the card holds at once) of the
# forward's passes route on an H100 (23 clusters of 9 at D = 4608, 16 of 12
# at 6001, 14 of 16 at 8192, two blocks an SM) at B = 100, 128 and 256 over
# 7001 and 7325 classes, then small and ragged cards
PASSES_SPLIT_CASES = [(219, 4, 23), (229, 4, 23), (229, 8, 23), (219, 4, 16), (229, 8, 16),
                      (219, 2, 14), (229, 8, 14), (1, 1, 23), (5, 3, 2), (63, 2, 1)]


@pytest.mark.parametrize("n_tiles,n_btiles,clusters", PASSES_SPLIT_CASES)
def test_passes_route_workers_cover_every_class_tile_once(n_tiles, n_btiles, clusters):
    """The forward's passes route splits as its cluster route
    (_cluster_splits), and its grid has one cluster for each (batch tile,
    split) worker, cluster u on batch tile u % n_rt of split u / n_rt, as
    fwd_passes_kernel reads it: every (batch tile, class tile) pair lies in
    exactly one worker and no worker is empty, whatever the depth passes
    (each worker walks every pass over the same tiles)."""
    tps, n_splits = port_flash._cluster_splits(n_tiles, n_btiles, clusters)
    seen = []
    for u in range(n_btiles * n_splits):
        bt, split = u % n_btiles, u // n_btiles
        lo, hi = split * tps, min(split * tps + tps, n_tiles)
        assert lo < hi
        seen += [(bt, t) for t in range(lo, hi)]
    assert sorted(seen) == [(bt, t) for bt in range(n_btiles) for t in range(n_tiles)]


def test_bwd_wrapper_checks_inputs():
    emb, w, labels = make()
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    wt, lt = torch.from_numpy(w), torch.from_numpy(labels)
    lse, g = torch.zeros(16), torch.ones(16)
    with pytest.raises(ValueError):
        port_flash.flash_aam_bwd(e_hat, wt[:, :8], lt, lse, g)
    with pytest.raises(ValueError):
        port_flash.flash_aam_bwd(e_hat, wt, lt, lse[:3], g)
    with pytest.raises(TypeError):
        port_flash.flash_aam_bwd(e_hat, wt, lt, lse, g.double())
    before = port_flash.flash_aam_bwd.launches
    de, dw = port_flash.flash_aam_bwd(e_hat, wt, lt, lse, g)
    assert de.shape == e_hat.shape and dw.shape == wt.shape
    assert port_flash.flash_aam_bwd.launches == before  # CPU: plain version
