"""The 3×TF32 arithmetic of the flash kernels, emulated on the CPU.

``pkr_tpu_torch/csrc/flash_aam_fwd.cu`` forms its cosine tile ê·Wᵀ, and
``pkr_tpu_torch/csrc/flash_aam_bwd.cu`` that tile and its two other products
(aᵀ·ê and a·ŵ), on the tensor cores in 3×TF32: each f32 operand x splits
into big = rna_tf32(x) and small = rna_tf32(x − big), and a product sums
a_small·b_big + a_big·b_small + a_big·b_big in f32.  No card runs here, so
this file emulates that arithmetic with int32 bit operations (rna_tf32 is
``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest, ties away
from zero), puts it in place of each product of the port's plain forward
and backward (``flash_aam._mm``), and holds the results against pkr_tpu's
Pallas kernels in interpret mode, at the cases of
tests/test_torch_flash_aam.py: the forward's (lse, zy, mx) within 1e-4 (the
bar of tests/test_torch_flash_aam.py) with the rank count and top-1/top-5
equal; every row of dê and dW within 1e-3 of its own norm; both but the
rows of examples whose target cosine sits at the sin clip (see
_off_the_clip).  The saturated case's cosine is exactly 1.0.  It also shows
that the split's error is at least 10× below that of one TF32 product (big
parts only), so the checks can tell the two apart.

Rows deeper than 256 take the chunk order's bits (flash_aam_cosine.cuh),
on every deep route of both kernels: the depth in chunks of 128, the last
padded with zeros, each chunk's dot the sum of its two 64-deep halves, each
half the f32 sum of its 16-deep 3×TF32 products in order, and the chunks'
dots added in chunk order.  The forward's cluster route (fwd_cluster_kernel,
256 < D ≤ 4096) adds the chunks' dots and sums of squares that the
cluster's blocks publish in that same order; past 4096 its passes route
(fwd_passes_kernel) carries each cosine's running sum in that order across
the depth passes of a cluster, and its norms come from a kernel of their
own, in the same order.  mm_chunked emulates that order for the depth
product and is held to the Pallas kernels at the same bars, up to D = 4096,
a cluster of 16 (clusters of 9, 12 and 16 at D = 2304, 3001 and 4096, past
the portable size of 8), and past it at D = 4097 (a last chunk of one
column), 4608, 6001, 8192 and 8193 (three passes).  Up to
D = 512 the backward takes its wide route (flash_aam_bwd.cu:
bwd_wide_kernel), which forms the same cosines but sums dW's projection
dŵ·ŵ over the whole depth in one pass, in its warps' order (row_dot_wide);
the backward test holds that model to the Pallas kernel at D = 300 and 512.
From 512 to 4096 it takes its cluster route (bwd_cluster_kernel), whose
blocks each hold a 256-wide slice of the depth: the same cosines, and dW's
projection summed per slice in its warps' order, then over the slices in
slice order (row_dot_sliced), held to the Pallas kernel at D = 777, 1024,
2048, 2304, 3001 and 4096, and to the f64 dot within f32 rounding.  Past
4096 it takes its passes route (bwd_passes_kernel), whose clusters walk
the depth in passes, each block accumulating two 256-wide slices of half a
tile: the cosines in the same chunk order, carried across the passes, and
dW's projection in the same order per slice and over the slices
(row_dot_sliced again), held to the Pallas kernel at D = 4097, 4608, 6001
(the 4-byte copies and a ragged last slice), 8192 and 8193.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pkr_tpu.ops import flash_aam as jax_flash
from pkr_tpu_torch.ops import flash_aam as port_flash
from test_torch_flash_aam import CASES, make

ROW_TOL = 1e-3


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of finite f32 values: add half of the 13 dropped
    bits' range to the magnitude (the int32 view is sign and magnitude, so
    adding to it moves away from zero), then clear them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: three products of TF32 parts (exact in
    f32), small terms first, summed in f32."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


KC = 128  # depth chunk of the kernels' chunked path (flash_aam_cosine.cuh)


def mm_chunked(depth: int):
    """A product like mm_tf32x3, but one whose contraction is ``depth``
    (> 256) is summed as the chunked kernels sum it: 16-deep 3×TF32 steps
    added in order within each 64-deep half of a 128-deep chunk, the two
    halves added, then the chunks' dots added in chunk order (zeros pad the
    last chunk and add nothing)."""

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.shape[1] != depth:
            return mm_tf32x3(a, b)
        total = None
        for c0 in range(0, depth, KC):
            halves = []
            for h0 in (c0, c0 + KC // 2):
                acc = None
                for k0 in range(h0, min(h0 + KC // 2, depth), 16):
                    part = mm_tf32x3(a[:, k0:k0 + 16], b[k0:k0 + 16])
                    acc = part if acc is None else acc + part
                halves.append(acc)
            dot = halves[0] if halves[1] is None else halves[0] + halves[1]
            total = dot if total is None else total + dot
        return total

    return mm


DEEP_CASES = {"D300": (make(B=24, D=300, C=200, seed=12), 128),
              "D512": (make(B=24, D=512, C=300, seed=13), 256),
              "D1024": (make(B=24, D=1024, C=200, seed=14), 128),
              "D777": (make(B=24, D=777, C=200, seed=15), 128),
              "D2048": (make(B=16, D=2048, C=100, seed=16), 128),
              "D2304": (make(B=16, D=2304, C=100, seed=17), 128),
              "D3001": (make(B=16, D=3001, C=100, seed=18), 128),
              "D4096": (make(B=16, D=4096, C=100, seed=19), 128),
              "D4608": (make(B=16, D=4608, C=100, seed=20), 128),
              "D6001": (make(B=16, D=6001, C=100, seed=21), 128),
              "D8192": (make(B=16, D=8192, C=100, seed=22), 128),
              "D4097": (make(B=16, D=4097, C=100, seed=23), 128),
              "D8193": (make(B=16, D=8193, C=100, seed=24), 128)}


def row_dot_wide(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_d x·y of each row, kept as a column, in the order in which
    bwd_wide_kernel sums dW's projection (256 < D ≤ 512, zeros to 512):
    depth d = 32·(w + 8·s) + 8·j + 2·t + q lies with lane t of a class's
    four in warp w; each lane adds its products in the order s, j, q, one
    rounding each (fmaf; modelled in f64, then rounded to f32), the four
    lanes add as (t0 + t1) + (t2 + t3), and the warps' sums add from 0 in
    warp order."""
    C, D = x.shape
    assert 256 < D <= 512
    prod = torch.nn.functional.pad(x.double() * y.double(), (0, 512 - D))
    prod = prod.reshape(C, 2, 8, 4, 4, 2)  # (class, s, w, j, t, q)
    lane = torch.zeros((C, 8, 4), dtype=torch.float32)
    for s in range(2):
        for j in range(4):
            for q in range(2):
                lane = (lane.double() + prod[:, s, :, j, :, q]).float()
    warp = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
    total = torch.zeros(C, dtype=torch.float32)
    for w in range(8):
        total = total + warp[:, w]
    return total[:, None]


SW = 256  # the depth of a block's slice on the cluster route (flash_aam_cosine.cuh)


def row_dot_sliced(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_d x·y of each row, kept as a column, in the order in which
    bwd_cluster_kernel (512 < D ≤ 4096, one slice per block of a cluster of
    up to 16) and bwd_passes_kernel (D > 4096, slices walked in depth
    passes) sum dW's projection, zeros to a multiple of 256: depth
    d = 256·s + 32·w + 8·j + 2·t + q of slice s lies with lane t of a
    class's four in warp w; each lane adds its products in the order j, q,
    one rounding each (fmaf; modelled in f64, then rounded to f32), the four
    lanes add as (t0 + t1) + (t2 + t3), the warps' sums add from 0 in warp
    order, and the slices' sums add in slice order."""
    C, D = x.shape
    assert 512 < D
    n_s = -(-D // SW)
    prod = torch.nn.functional.pad(x.double() * y.double(), (0, n_s * SW - D))
    prod = prod.reshape(C, n_s, 8, 4, 4, 2)  # (class, slice, w, j, t, q)
    lane = torch.zeros((C, n_s, 8, 4), dtype=torch.float32)
    for j in range(4):
        for q in range(2):
            lane = (lane.double() + prod[:, :, :, j, :, q]).float()
    warp = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
    per_slice = torch.zeros((C, n_s), dtype=torch.float32)
    for w in range(8):
        per_slice = per_slice + warp[:, :, w]
    total = per_slice[:, 0]
    for sl in range(1, n_s):
        total = total + per_slice[:, sl]
    return total[:, None]


@pytest.mark.parametrize("D", [777, 2048, 2304, 3001, 4096, 4608, 6001, 8192])
def test_row_dot_sliced_is_f32_accurate(D):
    """row_dot_sliced (the order of dW's projection on the cluster route, up
    to 16 slices, and on the passes route past them) against the f64 dot of
    each row: within the error bound of a recursive f32 sum of its terms,
    n·u·Σ|x·y| (u = 2⁻²⁴, n = D), and no further from it than the plain f32
    row sum is, times 4."""
    rng = np.random.default_rng(D)
    x = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((64, D)).astype(np.float32))
    exact = (x.double() * y.double()).sum(dim=1, keepdim=True)
    err = (row_dot_sliced(x, y).double() - exact).abs()
    bound = D * 2.0 ** -24 * (x.double() * y.double()).abs().sum(dim=1, keepdim=True)
    assert bool((err <= bound).all())
    plain = float((port_flash._row_dot(x, y).double() - exact).abs().max())
    assert float(err.max()) <= 4 * plain + 1e-6


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 product (the big parts only)."""
    return rna_tf32(a) @ rna_tf32(b)


def test_rna_tf32_known_values():
    ulp = 2.0 ** -10  # a TF32 mantissa step at 1.0
    cases = {
        1.0: 1.0,
        1.0 + ulp / 2: 1.0 + ulp,              # halfway: away from zero (not to even)
        -(1.0 + ulp / 2): -(1.0 + ulp),
        1.0 + 3 * ulp / 2: 1.0 + 2 * ulp,      # halfway above an odd step
        1.0 + ulp / 2 - 2.0 ** -23: 1.0,       # just below halfway
        1.0 + ulp / 2 + 2.0 ** -23: 1.0 + ulp,
        2.0 - 2.0 ** -23: 2.0,                 # rounds up into the next binade
        0.0: 0.0,
        3.0 + 2.0 ** -10: 3.0 + 2.0 ** -9,     # halfway in [2, 4), where a step is 2^-9
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    got = rna_tf32(x)
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    assert torch.all(got.view(torch.int32) & 0x1FFF == 0)


def test_split_is_exact_for_short_mantissas():
    """1.0, 2.0 and other values with at most 11 significant bits split with
    no remainder, so the saturated cosine (a one-hot row against a row
    2·e_k) is exact; a general value is big + small to within 2^-22."""
    short = torch.tensor([1.0, 2.0, 0.5, 3.0, -1.5, 1.0 + 2.0 ** -10])
    big, small = split(short)
    assert torch.equal(big, short) and torch.all(small == 0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big, small = split(x)
    assert torch.all((big + small - x).abs() <= 2.0 ** -22 * x.abs())
    assert torch.all(small.abs() <= 2.0 ** -11 * x.abs())


def test_split_error_is_far_below_one_tf32_product():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 300)).astype(np.float32))
    exact = a.double() @ b.double()
    err3 = float((mm_tf32x3(a, b).double() - exact).abs().max())
    err1 = float((mm_tf32(a, b).double() - exact).abs().max())
    err32 = float(((a @ b).double() - exact).abs().max())
    assert err3 * 10 <= err1, (err3, err1)
    assert err3 <= 4 * err32 + 1e-6, (err3, err32)  # f32 accuracy


def _row_ok(got: np.ndarray, ref: np.ndarray, tol: float = ROW_TOL) -> float:
    """max over rows of ‖got_r − ref_r‖ / ‖ref_r‖ (a zero row must be zero);
    asserts it is within tol and returns it."""
    num = np.linalg.norm(got.astype(np.float64) - ref.astype(np.float64), axis=1)
    den = np.linalg.norm(ref.astype(np.float64), axis=1)
    assert np.all(num[den == 0] == 0)
    rel = float(np.max(num[den > 0] / den[den > 0], initial=0.0))
    assert rel <= tol, rel
    return rel


def _port_bwd(emb, w, labels, lse, g, tile, mm, monkeypatch):
    monkeypatch.setattr(port_flash, "_mm", mm)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    de, dw = port_flash.flash_aam_bwd(e_hat, torch.from_numpy(w), torch.from_numpy(labels),
                                      torch.tensor(np.asarray(lse)), torch.from_numpy(g),
                                      0.2, 30.0, tile)
    return de.numpy(), dw.numpy()


def _pallas(emb, w, labels, tile):
    e_hat, _ = jax_flash._normalize(jnp.asarray(emb))
    lse = jax_flash._fwd_pallas(e_hat, jnp.asarray(w), jnp.asarray(labels), 0.2, 30.0,
                                tile, True)[0]
    g = np.linspace(0.5, 1.5, len(labels)).astype(np.float32)
    ref = jax_flash._bwd_pallas(e_hat, jnp.asarray(w), jnp.asarray(labels), lse,
                                jnp.asarray(g), 0.2, 30.0, tile, True)
    return lse, g, [np.asarray(r) for r in ref]


def _off_the_clip(emb, w, labels):
    """(examples, classes) whose rows the row check holds: all but the
    examples whose target cosine has 1 − cos² < 1e-4, and the classes they
    are labelled with.  Such an example's row is decided by the last bits of
    its cosine, in any f32 arithmetic: at the sin clip the margin's slope
    sin_m·cos/sin jumps between 1 and ~600 on one bit, p = exp(z − lse)
    then moves by ~1e-3 while a = p − 1 is ~0, and the row projection of dW
    cancels an (anti-)aligned example's whole term.  The port's f32 plain
    version misses these rows of the Pallas kernel's by up to 1.45 of their
    norm too."""
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    w_t = torch.from_numpy(w)[torch.from_numpy(labels)]
    cos = torch.sum(e_hat * w_t / w_t.norm(dim=1, keepdim=True), dim=1)
    rows = (1 - cos.double() ** 2 >= 1e-4).numpy()
    classes = np.ones(len(w), bool)
    classes[labels[~rows]] = False
    return rows, classes


@pytest.mark.parametrize("name", list(CASES))
def test_tf32x3_fwd_matches_pallas_fwd(name, monkeypatch):
    """(lse, zy, mx, cnt) of the plain forward with its product in emulated
    3×TF32 against the Pallas forward kernel (interpret mode): lse, zy and
    mx within 1e-4, cnt, top-1 and top-5 equal, on every example but those
    at the sin clip (_off_the_clip), which only the margin and saturated
    cases have."""
    (emb, w, labels), tile = CASES[name]
    e_hat_j, _ = jax_flash._normalize(jnp.asarray(emb))
    ref = [np.asarray(r) for r in jax_flash._fwd_pallas(
        e_hat_j, jnp.asarray(w), jnp.asarray(labels), 0.2, 30.0, tile, True)]
    monkeypatch.setattr(port_flash, "_mm", mm_tf32x3)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    wt, lt = torch.from_numpy(w), torch.from_numpy(labels)
    zt = port_flash._margined_target_z(e_hat, wt, lt, 0.2, 30.0)
    got = [g.numpy() for g in port_flash.flash_aam_fwd(e_hat, wt, lt, zt, 0.2, 30.0, tile)]
    rows, _ = _off_the_clip(emb, w, labels)
    assert rows.all() == (name not in ("margin_branches", "saturated"))
    for g, r in zip(got[:3], ref[:3]):
        assert np.isfinite(g).all() and g.shape == r.shape
        np.testing.assert_allclose(g[rows], r[rows], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3][rows], ref[3][rows])
    np.testing.assert_array_equal((got[1] >= got[2])[rows], (ref[1] >= ref[2])[rows])
    np.testing.assert_array_equal((got[3] < 5)[rows], (ref[3] < 5)[rows])


@pytest.mark.parametrize("name", list(CASES) + list(DEEP_CASES))
def test_tf32x3_bwd_matches_pallas_bwd(name, monkeypatch):
    """(dê, dW) of the plain backward with its three products in emulated
    3×TF32 against the Pallas backward kernel (interpret mode), every row
    within 1e-3 of its own norm but those of examples at the sin clip
    (_off_the_clip), which only the margin and saturated cases have.  The
    deep cases model the backward's route for their depth: the chunked
    cosine (mm_chunked) and dW's projection in the route's order, the wide
    route's (row_dot_wide) at D = 300 and 512, the cluster route's
    (row_dot_sliced) at D = 777, 1024, 2048, 2304, 3001 and 4096, and the
    passes route's (row_dot_sliced too) at D = 4097, 4608, 6001, 8192 and
    8193."""
    (emb, w, labels), tile = {**CASES, **DEEP_CASES}[name]
    mm = mm_tf32x3
    if name in DEEP_CASES:
        D = emb.shape[1]
        mm = mm_chunked(D)
        monkeypatch.setattr(port_flash, "_row_dot", row_dot_wide if D <= 512 else row_dot_sliced)
    lse, g, ref = _pallas(emb, w, labels, tile)
    got = _port_bwd(emb, w, labels, lse, g, tile, mm, monkeypatch)
    rows, classes = _off_the_clip(emb, w, labels)
    assert rows.all() == (name not in ("margin_branches", "saturated"))
    for gt, r, keep in zip(got, ref, (rows, classes)):
        assert np.isfinite(gt).all() and gt.shape == r.shape
        _row_ok(gt[keep], r[keep])


@pytest.mark.parametrize("name", list(DEEP_CASES))
def test_chunked_tf32x3_matches_pallas(name, monkeypatch):
    """D > 256: the plain forward and backward with the depth product summed
    in the chunked kernels' order (mm_chunked) against the Pallas kernels in
    interpret mode, at the bars of the two tests above; the chunked sum is
    f32-accurate (within 4× of a plain f32 product's error)."""
    (emb, w, labels), tile = DEEP_CASES[name]
    D = emb.shape[1]
    mm = mm_chunked(D)
    a, b = torch.from_numpy(emb), torch.from_numpy(w).T
    exact = a.double() @ b.double()
    err = float((mm(a, b).double() - exact).abs().max())
    assert err <= 4 * float(((a @ b).double() - exact).abs().max()) + 1e-6
    rows, classes = _off_the_clip(emb, w, labels)
    assert rows.all()

    e_hat_j, _ = jax_flash._normalize(jnp.asarray(emb))
    ref = [np.asarray(r) for r in jax_flash._fwd_pallas(
        e_hat_j, jnp.asarray(w), jnp.asarray(labels), 0.2, 30.0, tile, True)]
    monkeypatch.setattr(port_flash, "_mm", mm)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    wt, lt = torch.from_numpy(w), torch.from_numpy(labels)
    zt = port_flash._margined_target_z(e_hat, wt, lt, 0.2, 30.0)
    got = [g.numpy() for g in port_flash.flash_aam_fwd(e_hat, wt, lt, zt, 0.2, 30.0, tile)]
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[1] >= got[2], ref[1] >= ref[2])

    lse, g, ref = _pallas(emb, w, labels, tile)
    got = _port_bwd(emb, w, labels, lse, g, tile, mm, monkeypatch)
    for gt, r in zip(got, ref):
        assert np.isfinite(gt).all() and gt.shape == r.shape
        _row_ok(gt, r)


def test_saturated_cosine_is_exact():
    """A one-hot embedding against a class row 2·e_k: 3×TF32 gives the
    cosine exactly 1.0, so the sin clip (no gradient through sin) holds as
    in the Pallas kernel."""
    (emb, w, labels), _ = CASES["saturated"]
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    w_t = torch.from_numpy(w)
    cos = mm_tf32x3(e_hat, (w_t / w_t.norm(dim=1, keepdim=True)).T)
    assert torch.equal(cos[:2, 5], torch.ones(2))


def test_row_check_tells_tf32x3_from_one_tf32_product(monkeypatch):
    """Against the plain backward in f64, one TF32 product per f32 product
    misses the 1e-3 row bar that 3×TF32 meets with room to spare."""
    emb, w, labels = make(B=32, D=64, C=300, seed=7)
    lse, g, _ = _pallas(emb, w, labels, 128)
    e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
    ref = port_flash.flash_aam_bwd_plain(e_hat.double(), torch.from_numpy(w).double(),
                                         torch.from_numpy(labels),
                                         torch.tensor(np.asarray(lse)).double(),
                                         torch.from_numpy(g).double(), 0.2, 30.0, 128)
    ref = [r.numpy() for r in ref]
    three = _port_bwd(emb, w, labels, lse, g, 128, mm_tf32x3, monkeypatch)
    one = _port_bwd(emb, w, labels, lse, g, 128, mm_tf32, monkeypatch)
    for t3, t1, r in zip(three, one, ref):
        rel3 = _row_ok(t3, r)
        rel1 = _row_ok(t1, r, tol=np.inf)
        assert rel3 * 10 <= rel1 and rel1 > ROW_TOL, (rel3, rel1)


# labels outside [0, C): the shard-local labels a class-sharded head hands
# each class shard for the rows whose target lies on another shard
OFF_SHARD = ("minus_c", "plus_c", "mixed")


def off_shard_labels(labels: np.ndarray, C: int, how: str) -> np.ndarray:
    shift = {"minus_c": np.full(len(labels), -1), "plus_c": np.full(len(labels), 1),
             "mixed": np.asarray([-1, 1, 2, -3])[np.arange(len(labels)) % 4]}[how]
    return labels + C * shift


@pytest.mark.parametrize("how", OFF_SHARD)
def test_off_shard_labels_match_pallas(how, monkeypatch):
    """Every row's label outside [0, C) (shifted by −C, by +C, or a mix of
    −3C..+2C), as a class shard sees the rows whose target lies elsewhere.
    The Pallas kernels mask by column only, so such a row has no target
    column (zy = 0) and keeps its whole non-target gradient; its rank count
    runs against the owner's pivot zt (here the in-range target's).  The
    port's plain forward and backward, their products in f32 and in
    emulated 3×TF32, against the Pallas kernels in interpret mode: lse and
    mx within 1e-4, zy exactly 0 in both, cnt equal, and every row of dê
    and dW within 1e-3 of its own norm.  This pins the semantics that the
    CUDA kernels' row test must meet (a kernel that takes a negative label
    for a padded row zeroes these rows' gradients)."""
    (emb, w, labels), tile = CASES["C300_tile256"]
    C = w.shape[0]
    lab = off_shard_labels(labels, C, how)
    assert ((lab < 0) | (lab >= C)).all()
    e_hat_j, _ = jax_flash._normalize(jnp.asarray(emb))
    zt_j = jax_flash._margined_target_z(e_hat_j, jnp.asarray(w), jnp.asarray(labels),
                                        0.2, 30.0)
    ref_fwd = [np.asarray(r) for r in jax_flash._fwd_pallas(
        e_hat_j, jnp.asarray(w), jnp.asarray(lab), 0.2, 30.0, tile, True, zt=zt_j)]
    g = np.linspace(0.5, 1.5, len(lab)).astype(np.float32)
    ref_bwd = [np.asarray(r) for r in jax_flash._bwd_pallas(
        e_hat_j, jnp.asarray(w), jnp.asarray(lab), jnp.asarray(ref_fwd[0]), jnp.asarray(g),
        0.2, 30.0, tile, True)]
    # no target term anywhere, and every class keeps a gradient
    assert not ref_fwd[1].any() and (np.abs(ref_bwd[1]).max(axis=1) > 0).all()
    for mm in (port_flash._mm, mm_tf32x3):
        monkeypatch.setattr(port_flash, "_mm", mm)
        e_hat, _ = port_flash._normalize(torch.from_numpy(emb))
        wt = torch.from_numpy(w)
        zt = torch.from_numpy(np.asarray(zt_j))
        got = [v.numpy() for v in port_flash.flash_aam_fwd(
            e_hat, wt, torch.from_numpy(lab), zt, 0.2, 30.0, tile)]
        for i in (0, 2):
            np.testing.assert_allclose(got[i], ref_fwd[i], rtol=0, atol=1e-4)
        assert not got[1].any()
        np.testing.assert_array_equal(got[3], ref_fwd[3])
        de, dw = _port_bwd(emb, w, lab, ref_fwd[0], g, tile, mm, monkeypatch)
        _row_ok(de, ref_bwd[0])
        _row_ok(dw, ref_bwd[1])
