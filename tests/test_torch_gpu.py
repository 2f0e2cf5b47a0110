"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skipped (with a reason) where there is no CUDA device, which
is decided inside the test.  This file imports neither JAX nor pkr_tpu, so
on the machine with the card it runs without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: per-example lse and zy within 5e-4 (logits are scaled by s=30;
the kernel and cuBLAS sum the 256-long dot products in different orders),
the loss within 2e-4, and the online top-1/top-5 decisions equal.  The
backward's dê and dW row by row: each example's and each class's gradient
within 1e-3 of its own norm, the bar chip_smoke.py holds it to (a
non-target class's gradient is far below the largest entry, so a bound on
the whole tensor could not see it), and within 1e-3 of the largest entry
(+1e-6).  The confident case (every target p ≈ 0.993, where a = p − 1
cancels and s·Δcos/(1 − p) magnifies any cosine rounding ~4000×) is held
to the plain version run in f64: the f32 plain version is itself ~3e-3 off
there.  Two calls of either kernel on the same inputs give the same bits.
The two kernels form the same cosine bits: with one class, the backward's
gradients from the forward's own lse are exactly 0, at D <= 256 and at
D > 256, where the forward splits the depth over a thread-block cluster up
to D = 4096 (its cluster route; clusters of up to 8 blocks to D = 2048, the
portable size, and of 9 to 16 past it) and beyond walks it in depth passes
over a cluster (its passes route), and the backward keeps the chunks
resident up to D = 512 (its wide route), splits them over a cluster up to
4096 (its cluster route) and beyond walks them in depth passes over a
cluster (its passes route; D = 300, 301, 512, 777, 1024, 2048, 2304, 3001,
4096, 4097, 4608, 6001, 8192 and 8193 are held to the plain version in both
directions, each on its routes; D = 301, 777, 3001 and 6001 take the 4-byte
copies).  Each backward route and the forward's passes route hold as many
blocks on an SM as their shared memory allows, and each cluster and passes
route as many clusters as the card holds at once, at least one of 16.  The
flash gradients
against the dense head's autograd (cuBLAS f32) at rtol 2e-3, atol 1e-6 as
tests/test_flash_aam.py, and row by row within 1e-3.  Labels outside
[0, C), the shard-local labels of a class-sharded head, give no target
column and every row's whole non-target gradient in both kernels, as in
the plain versions (test_flash_aam_off_shard_labels_match_plain).
"""

import numpy as np
import pytest
import torch

from pkr_tpu_torch.ops import flash_aam
from pkr_tpu_torch.ops.aam import cosine_logits


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,D", [(256, 7325, 256), (37, 1000, 96), (8, 50, 32),
                                   (64, 1000, 37)])
def test_flash_aam_fwd_matches_plain(B, C, D):
    dev = _card()
    rng = np.random.default_rng(B + C)
    emb = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, C, B)).to(dev)
    e_hat, _ = flash_aam._normalize(emb)
    zt = flash_aam._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    before = flash_aam.flash_aam_fwd.launches
    got = flash_aam.flash_aam_fwd(e_hat, w, labels, zt)
    torch.cuda.synchronize()
    assert flash_aam.flash_aam_fwd.launches == before + 1
    ref = flash_aam.flash_aam_fwd_plain(e_hat, w, labels, zt)
    for g, r in zip(got[:3], ref[:3]):
        assert float((g - r).abs().max()) <= 5e-4
    assert abs(float((got[0] - got[1]).mean() - (ref[0] - ref[1]).mean())) <= 2e-4
    assert torch.equal(got[1] >= got[2], ref[1] >= ref[2])
    assert torch.equal(got[3] < 5, ref[3] < 5)


@pytest.mark.gpu
def test_flash_aam_fwd_rejects_bad_inputs():
    dev = _card()
    e = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        flash_aam.flash_aam_fwd(e, torch.ones((5, 8), device="cpu"),
                                torch.zeros(4, dtype=torch.int64, device=dev),
                                torch.zeros(4, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [256, 300, 512, 1024, 2048, 4096, 4097, 4608, 6001, 8192, 8193])
def test_flash_aam_fwd_is_deterministic(D):
    dev = _card()
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.standard_normal((256, D)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((7325, D)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 7325, 256)).to(dev)
    e_hat, _ = flash_aam._normalize(emb)
    zt = flash_aam._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    first = flash_aam.flash_aam_fwd(e_hat, w, labels, zt)
    second = flash_aam.flash_aam_fwd(e_hat, w, labels, zt)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("B,D,exact", [
    (B, D, exact) for B, D in ((256, 256), (100, 37), (256, 512), (100, 300), (100, 301),
                               (100, 1024), (100, 777), (64, 2048), (100, 2304), (64, 3001),
                               (64, 4096), (64, 4608), (64, 6001), (64, 8192), (64, 8193))
    for exact in (True, False)] + [(64, 4097, False)])
def test_fwd_and_bwd_cosines_agree_bit_for_bit(B, D, exact):
    """With one class and every label 0, the forward's lse is its zy, so the
    backward's p = exp(z − lse) is exactly 1 and its gradients exactly 0
    where both kernels computed the same cosine bits (the f32-FMA forward of
    earlier versions fails this).  D = 4097 has no exact construction (its
    Σw² cannot be a power of 4 with entries ±1, ±2 and one zero), so it
    takes the Gaussian case alone."""
    dev = _card()
    from chip_smoke import consistency_inputs

    emb, w, labels = consistency_inputs(torch, B, D, B + D, exact)
    zt = flash_aam._margined_target_z(emb, w, labels, 0.2, 30.0)
    lse, zy, mx, cnt = flash_aam.flash_aam_fwd(emb, w, labels, zt)
    assert torch.equal(lse, zy) and torch.equal(zy, mx) and not bool(cnt.any())
    de, dw = flash_aam.flash_aam_bwd(emb, w, labels, lse, torch.full((B,), 1.0 / B, device=dev))
    torch.cuda.synchronize()
    assert float(de.abs().max()) == 0.0 and float(dw.abs().max()) == 0.0
    if exact:  # rows 0..4 sit at cos = 1.0 and 1..4 ulps below it: their
        # margined logits, formed on the CPU with the kernels' roundings
        cos = torch.tensor([1.0 - k * 2.0 ** -24 for k in range(5)])
        assert zy[:5].tolist() == (flash_aam._phi(cos, 0.2) * 30.0).tolist()


def _row_rel_err(got, ref):
    """max over rows of ‖got_r − ref_r‖ / ‖ref_r‖, in f64."""
    num = (got.double() - ref.double()).norm(dim=1)
    den = ref.double().norm(dim=1)
    return float((num / den).max())


def _bwd_inputs(dev, B, C, D, seed, confident=False):
    """Embeddings half-way to their class row, or (confident) at cosine 0.68
    to it, which puts every target p near 0.993 for C ≈ 7000 and D = 256."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, C, B)).to(dev)
    noise = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
    if not confident:
        return 0.5 * w[labels] + noise, w, labels
    w_y = w[labels] / w[labels].norm(dim=1, keepdim=True)
    u = noise - (noise * w_y).sum(dim=1, keepdim=True) * w_y
    u = u / u.norm(dim=1, keepdim=True)
    return 0.68 * w_y + (1 - 0.68 ** 2) ** 0.5 * u, w, labels


def _bwd_case(dev, B, C, D, confident=False):
    emb, w, labels = _bwd_inputs(dev, B, C, D, B + C, confident)
    e_hat, _ = flash_aam._normalize(emb)
    zt = flash_aam._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    lse = flash_aam.flash_aam_fwd(e_hat, w, labels, zt)[0]
    g = torch.full((B,), 1.0 / B, device=dev)
    return e_hat, w, labels, lse, g


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,D,confident", [
    (256, 7325, 256, False), (100, 7001, 256, False), (37, 1000, 96, False),
    (64, 1000, 37, False), (256, 7325, 256, True)])
def test_flash_aam_bwd_matches_plain(B, C, D, confident):
    dev = _card()
    e_hat, w, labels, lse, g = _bwd_case(dev, B, C, D, confident)
    before = flash_aam.flash_aam_bwd.launches
    got = flash_aam.flash_aam_bwd(e_hat, w, labels, lse, g)
    torch.cuda.synchronize()
    assert flash_aam.flash_aam_bwd.launches == before + 1
    if confident:
        ref = flash_aam.flash_aam_bwd_plain(e_hat.double(), w.double(), labels,
                                            lse.double(), g.double())
    else:
        ref = flash_aam.flash_aam_bwd_plain(e_hat, w, labels, lse, g)
    for gt, r in zip(got, ref):
        assert gt.shape == r.shape and bool(torch.isfinite(gt).all())
        assert _row_rel_err(gt, r) <= 1e-3
        assert float((gt - r).abs().max()) <= 1e-3 * float(r.abs().max()) + 1e-6
    # the row check sees a dW whose non-target classes were left out
    fault = got[1].clone()
    keep = torch.zeros(C, dtype=torch.bool, device=dev)
    keep[labels] = True
    fault[~keep] = 0.0
    assert _row_rel_err(fault, ref[1]) > 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["minus_c", "plus_c", "mixed"])
@pytest.mark.parametrize("B,C,D", [(256, 7325, 256), (100, 2001, 300)])
def test_flash_aam_off_shard_labels_match_plain(B, C, D, how):
    """Labels outside [0, C), as a class-sharded head hands a shard the rows
    whose target lies on another shard (every label shifted by −C, by +C,
    or by a mix of −3C..+2C): both kernels against their plain versions,
    at D = 256 and on the chunked path (D = 300).  No column is a target:
    zy is exactly 0, lse and mx within 5e-4, and cnt, counted against zt
    (the owner's pivot, here the in-range target's), apart only by classes
    within 1e-4 of zt; every row of dê and dW
    within 1e-3 of its own norm and the tensor within 1e-3 of its largest
    entry (+1e-6).  A backward that took a negative label for a padded row
    zeroes these rows (the −C and mixed cases)."""
    dev = _card()
    emb, w, labels = _bwd_inputs(dev, B, C, D, B + C + 1)
    shift = {"minus_c": torch.full_like(labels, -1), "plus_c": torch.full_like(labels, 1),
             "mixed": torch.tensor([-1, 1, 2, -3], device=dev).repeat(B // 4 + 1)[:B]}[how]
    off = labels + C * shift
    e_hat, _ = flash_aam._normalize(emb)
    zt = flash_aam._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    got = flash_aam.flash_aam_fwd(e_hat, w, off, zt)
    ref = flash_aam.flash_aam_fwd_plain(e_hat, w, off, zt)
    torch.cuda.synchronize()
    assert not bool(got[1].any()) and not bool(ref[1].any())
    for i in (0, 2):
        assert float((got[i] - ref[i]).abs().max()) <= 5e-4
    # the rank counts part only by classes whose logit lies within rounding
    # of zt (no class is a target: every logit is s·cos)
    near = ((cosine_logits(e_hat, w) * 30.0 - zt[:, None]).abs() < 1e-4).sum(1)
    assert bool(((got[3] - ref[3]).abs() <= near).all())
    g = torch.full((B,), 1.0 / B, device=dev)
    got = flash_aam.flash_aam_bwd(e_hat, w, off, ref[0], g)
    torch.cuda.synchronize()
    ref = flash_aam.flash_aam_bwd_plain(e_hat, w, off, ref[0], g)
    for gt, r in zip(got, ref):
        assert bool(torch.isfinite(gt).all())
        assert _row_rel_err(gt, r) <= 1e-3
        assert float((gt - r).abs().max()) <= 1e-3 * float(r.abs().max()) + 1e-6


def _fwd_route(D):
    return "tiles" if D <= 256 else "cluster" if D <= 4096 else "passes"


def _bwd_route(D):
    return "tiles" if D <= 256 else "wide" if D <= 512 else "cluster" if D <= 4096 else "passes"


@pytest.mark.gpu
@pytest.mark.parametrize("D", [300, 301, 512, 777, 1024, 2048, 2304, 3001, 4096, 4097, 4608,
                               6001, 8192, 8193])
def test_flash_aam_deep_rows_match_plain(D):
    """D > 256 (the forward's cluster route up to 4096 and its passes route
    beyond; the backward's wide route up to 512, its cluster route to 4096
    and its passes route beyond; D = 777 takes the 4-byte copies and a
    ragged last slice, 2048 a cluster of 8, 2304 one of 9, 3001 one of 12
    with 4-byte copies and a ragged last slice, 4096 one of 16; past it
    4097 two passes of 9 blocks with a last slice of one column, 4608 two
    of 9, 6001 two of 12 with 4-byte copies and a ragged last slice, 8192
    two of 16, 8193 three of 11, two output groups) against the plain
    versions at the bars above, forward and backward, each launch on its
    route."""
    fwd, bwd = _fwd_route(D), _bwd_route(D)
    before = (flash_aam.flash_aam_fwd.route_launches[fwd],
              flash_aam.flash_aam_bwd.route_launches[bwd])
    test_flash_aam_fwd_matches_plain(100, 2001, D)
    test_flash_aam_bwd_matches_plain(100, 2001, D, False)
    # the backward case launches the forward once more, for its lse
    assert (flash_aam.flash_aam_fwd.route_launches[fwd],
            flash_aam.flash_aam_bwd.route_launches[bwd]) == (before[0] + 2, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [256, 257, 512, 513, 2048, 2049, 3001, 4096, 4097, 4608])
def test_flash_aam_fwd_route_by_depth(D):
    """The forward's library picks the tiles route up to D = 256, the
    cluster route to 4096 (clusters of ceil(D / 256) blocks, up to 16) and
    the passes route beyond (clusters of passes_cluster(D) blocks walking
    n_passes(D) depth passes, passes_geometry), as fwd_geometry says; on
    both cluster routes the card holds at least one cluster at once, and no
    more blocks than two an SM; and a launch is counted on that route."""
    dev = _card()
    index = dev.index or 0
    kernel = flash_aam._KERNEL
    route = _fwd_route(D)
    assert flash_aam._route(kernel, D) == route
    size = flash_aam._query(kernel, "flash_aam_fwd_cluster_size", D)
    passes = flash_aam._query(kernel, "flash_aam_fwd_passes", D)
    assert flash_aam.fwd_geometry(D) == (route, passes, size)
    if route == "tiles":
        assert size == 1 and passes == 1
        assert flash_aam._query(kernel, "flash_aam_fwd_clusters", D) == -1
    else:
        want = (1, -(-D // 256)) if route == "cluster" else flash_aam.passes_geometry(D)
        assert (passes, size) == want
        clusters = flash_aam._occupancy(kernel, index, D, "flash_aam_fwd_clusters")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        assert 1 <= clusters and clusters * size <= 2 * sms
    before = dict(flash_aam.flash_aam_fwd.route_launches)
    test_flash_aam_fwd_matches_plain(40, 300, D)
    after = flash_aam.flash_aam_fwd.route_launches
    assert {k: after[k] - before[k] for k in after} == {k: int(k == route) for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4608, 6001, 8192, 12288])
def test_flash_aam_fwd_passes_occupancy(D):
    """The forward's passes route holds two blocks an SM (its 114,688 bytes
    of shared memory each) and at least one cluster of passes_cluster(D)
    blocks at once, no more blocks than two an SM, with the backward's depth
    passes and cluster size."""
    dev = _card()
    index = dev.index or 0
    kernel = flash_aam._KERNEL
    assert flash_aam._occupancy(kernel, index, D, "flash_aam_fwd_blocks_per_sm") == 2
    passes = flash_aam._query(kernel, "flash_aam_fwd_passes", D)
    size = flash_aam._query(kernel, "flash_aam_fwd_cluster_size", D)
    assert (passes, size) == flash_aam.passes_geometry(D) == (
        flash_aam._query(flash_aam._BWD_KERNEL, "flash_aam_bwd_passes", D),
        flash_aam._query(flash_aam._BWD_KERNEL, "flash_aam_bwd_cluster_size", D))
    clusters = flash_aam._occupancy(kernel, index, D, "flash_aam_fwd_clusters")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    assert 1 <= clusters and clusters * size <= 2 * sms


@pytest.mark.gpu
@pytest.mark.parametrize("D,blocks", [(37, 2), (256, 2), (257, 1), (301, 1), (512, 1),
                                      (513, 2), (1024, 2), (2048, 2), (2049, 2), (3001, 2),
                                      (4096, 2), (4097, 2), (4608, 2), (6001, 2), (8192, 2),
                                      (12288, 2)])
def test_flash_aam_bwd_blocks_per_sm_by_route(D, blocks):
    """The occupancy the split rule reads: two blocks an SM for the tiles,
    cluster (512 < D <= 4096) and passes routes, one for the wide route
    (256 < D <= 512).  The cluster route also reports its cluster size,
    ceil(D / 256), the passes route its cluster size and depth passes
    (passes_geometry), and both how many clusters the card holds at
    once: at least one, and no more blocks than its SMs hold."""
    dev = _card()
    index = dev.index or 0
    kernel = flash_aam._BWD_KERNEL
    assert flash_aam._bwd_blocks_per_sm(index, D) == blocks
    size = flash_aam._query(kernel, "flash_aam_bwd_cluster_size", D)
    passes = flash_aam._query(kernel, "flash_aam_bwd_passes", D)
    if D > 512:
        want = (1, -(-D // 256)) if D <= 4096 else flash_aam.passes_geometry(D)
        assert (passes, size) == want
        clusters = flash_aam._occupancy(kernel, index, D, "flash_aam_bwd_clusters")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        assert 1 <= clusters and clusters * size <= blocks * sms
    else:
        assert size == 1 and passes == 1
        assert flash_aam._query(kernel, "flash_aam_bwd_clusters", D) == -1


@pytest.mark.gpu
@pytest.mark.parametrize("D", [256, 300, 301, 512, 777, 1024, 2048, 4096, 4097, 4608, 6001,
                               8192, 8193])
def test_flash_aam_bwd_is_deterministic(D):
    dev = _card()
    args = _bwd_case(dev, 256, 7325, D)
    first = flash_aam.flash_aam_bwd(*args)
    second = flash_aam.flash_aam_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_flash_grads_match_dense_on_card():
    dev = _card()
    emb, w, labels = _bwd_inputs(dev, 64, 3000, 256, 5)
    grads = []
    for fn in (flash_aam.flash_aam_loss, flash_aam.reference_aam_loss):
        e = emb.clone().requires_grad_(True)
        wt = w.clone().requires_grad_(True)
        loss = fn(e, wt, labels, 0.2, 30.0)
        loss.backward()
        grads.append((float(loss), e.grad, wt.grad))
    (lf, ef, wf), (ld, ed, wd) = grads
    assert abs(lf - ld) <= 2e-4
    for got, ref in ((ef, ed), (wf, wd)):
        torch.testing.assert_close(got, ref, rtol=2e-3, atol=1e-6)
        assert _row_rel_err(got, ref) <= 1e-3


def _r34_steps(dev, sd, x, y, contiguous, n_steps=1):
    """A bf16 ResNet-34 AAM model from ``sd`` on the card, in the card's
    channels_last layout or (``contiguous``) in the CPU's, and its state
    after ``n_steps`` train steps on (x, y); the strides of each parameter,
    its gradient and its momentum as the update received them."""
    from pkr_tpu_torch.models import SpeakerModel, layout
    from pkr_tpu_torch.train import create_train_state, loop, make_train_step

    orig_fmt, orig_sgd = layout.memory_format_for, loop.sgd_step
    strides = []

    def spy(params, grads, bufs, *args, **kwargs):
        strides.append([(p.stride(), g.stride(), b.stride())
                        for p, g, b in zip(params, grads, bufs)])
        return orig_sgd(params, grads, bufs, *args, **kwargs)

    if contiguous:
        layout.memory_format_for = lambda device: torch.contiguous_format
    loop.sgd_step = spy
    try:
        model = SpeakerModel(7325, 40, loss="AAM", trunk="resnet34", device=dev)
        model.load_state_dict(sd)
        step = make_train_step(model, device=dev)
        state = create_train_state(model)
        losses = []
        for _ in range(n_steps):
            state, met = step(state, x, y, 0.1)
            losses.append(float(met["loss"]))
    finally:
        layout.memory_format_for, loop.sgd_step = orig_fmt, orig_sgd
    return model, state, step, losses, strides


@pytest.mark.gpu
def test_resnet34_step_channels_last_matches_contiguous():
    """The trunk's channels_last layout on the card against a contiguous
    copy of the same model: one bf16 ResNet-34 train step at B = 32 (dense
    AAM head, 7325 speakers) gives the same loss within 1 % and gradients
    (the momentum after one step) within portbench's bf16 limits: the
    median leaf's norm gap within 2.5 % (``grad_med``), the worst leaf's
    outside BatchNorm within 40 % (``grad_worst``); every parameter, its
    gradient and its momentum share strides, the trunk's maps are
    channels_last (the counter ``trunk.channels_last``), and a profiled
    step runs cuDNN's layout transposes (``nchwToNhwc``/``nhwcToNchw``,
    which the contiguous copy runs on every convolution pass) only in the
    stem's backward, whose input has one channel: at most two a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pkr_tpu_torch.models import BatchNorm, SpeakerModel
    from pkr_tpu_torch.utils import trace

    dev = _card()
    g = torch.Generator().manual_seed(0)
    sd = SpeakerModel(7325, 40, loss="AAM", trunk="resnet34", device="cpu",
                      generator=g).state_dict()
    x = torch.randn((32, 40, 200), generator=g).to(dev)
    y = torch.randint(0, 7325, (32,), generator=g).to(dev)
    cl, cl_state, cl_step, cl_loss, cl_strides = _r34_steps(dev, sd, x, y, False)
    nc, nc_state, nc_step, nc_loss, nc_strides = _r34_steps(dev, sd, x, y, True)
    assert cl.res.memory_format == torch.channels_last
    assert nc.res.memory_format == torch.contiguous_format
    assert cl.res.layer1[0].conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert nc.res.layer1[0].conv1.weight.is_contiguous()
    assert abs(cl_loss[0] - nc_loss[0]) <= 0.01 * abs(nc_loss[0])
    # portbench's gap of norms: each leaf's against the larger of its own
    # and the median leaf's norm, leaves under 1e-3 of the median left out
    ref = {k: float(v.norm()) for k, v in nc_state.momentum.items()}
    med = float(np.median(list(ref.values())))
    gaps = {k: abs(float(cl_state.momentum[k].norm()) - r) / max(r, med)
            for k, r in ref.items() if r >= 1e-3 * med}
    assert float(np.median(list(gaps.values()))) <= 0.025, gaps
    bn = {f"{n}.{p}" for n, m in nc.named_modules() if isinstance(m, BatchNorm)
          for p in ("weight", "bias")}
    assert max(g for k, g in gaps.items() if k not in bn) <= 0.4, gaps
    for strides in cl_strides + nc_strides:
        assert all(p == gr == b for p, gr, b in strides)

    def transposes(step, state):
        """cuDNN's layout transposes a step: (by a convolution with a
        one-channel input or weight: the stem's, any other)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(2):
                state, _ = step(state, x, y, 0.1)
            torch.cuda.synchronize()
        assert any(e.device_type == DeviceType.CUDA for e in prof.events()), \
            "the profiler saw no device activity"
        stem = other = 0
        for e in prof.events():
            n = sum(("nchwToNhwc" in k.name or "nhwcToNchw" in k.name)
                    for k in getattr(e, "kernels", []))
            if n and any(len(s) == 4 and s[1] == 1 for s in e.input_shapes):
                stem += n
            else:
                other += n
        return stem / 2, other / 2

    trace.reset()
    stem, other = transposes(cl_step, cl_state)
    assert other == 0 and stem <= 2, (stem, other)
    summary = trace.summary()
    assert summary["counters"]["trunk.channels_last"] == summary["spans"]["step.forward"]["n"] == 2
    assert sum(transposes(nc_step, nc_state)) > 10  # the NCHW copy transposes each pass
    trace.reset()
