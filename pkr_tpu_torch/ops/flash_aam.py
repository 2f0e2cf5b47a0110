"""Flash AAM-softmax loss: margin + online-softmax CE over class tiles.

Port of ``pkr_tpu/ops/flash_aam.py``.  The dense head
materializes (B, n_spk) cosine logits; at large speaker counts that tensor
dominates the step's memory traffic.  The flash head streams class tiles
instead and keeps per example only the online state (lse, zy, mx, cnt):

- lse — log-sum-exp of the margined logits (loss = mean(lse - zy));
- zy  — the target's margined logit, the very float folded into the max;
- mx  — the running max (top-1: zy >= mx);
- cnt — non-target classes whose logit beats zt (top-5: cnt < 5).

The backward recomputes each cosine tile and forms the logit gradients
a = (softmax − onehot)·dz/dcos·g tile by tile, accumulating dê (B, D) and
dW (C, D); the (B, n_spk) logits and probabilities never exist either.

Each direction has a kernel wrapper and its plain version:
:func:`flash_aam_fwd` launches ``pkr_tpu_torch/csrc/flash_aam_fwd.cu`` and
:func:`flash_aam_bwd` launches ``pkr_tpu_torch/csrc/flash_aam_bwd.cu``
(both sm_90a) on a CUDA tensor, or raise; on a CPU tensor they run
:func:`flash_aam_fwd_plain` and :func:`flash_aam_bwd_plain`, the
class-tiled PyTorch versions of the same functions, which are also what the
kernels are held against on the card.  :func:`flash_aam_loss` and
:func:`flash_aam_loss_acc` are differentiable in ``emb`` and ``weight``
through one ``torch.autograd.Function``, the counterpart of the reference's
two ``jax.custom_vjp`` functions.

Over a process mesh (``parallel/mesh.py``), :func:`make_flash_aam_sharded`
composes the same two kernels with explicit collectives, in ``pkr_tpu``'s
two regimes: the weight whole on every rank, or its class rows split over
the ``model`` axis, each rank running the kernels on its shard with
shard-local labels and merging the online states over ``model``.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Optional

import torch
import torch.distributed as dist

from pkr_tpu_torch.device import full_f32
from pkr_tpu_torch.ops import _native
from pkr_tpu_torch.ops.aam import _normalize, _phi, aam_logits
from pkr_tpu_torch.utils import trace

DEFAULT_TILE = 2048
_NEG_INF = -1e30
_KERNEL = "flash_aam_fwd"
_BWD_KERNEL = "flash_aam_bwd"
# CUDA blocks per SM to aim for when the forward's tiles route splits the
# class axis: two of its blocks fill an SM's shared memory.  Its cluster and
# passes routes and every route of the backward ask their library instead
# (_occupancy).
_BLOCKS_PER_SM = 2


def _margin_consts(m: float):
    return (math.cos(m), math.sin(m), math.cos(math.pi - m),
            math.sin(math.pi - m) * m)


def _margined_target_z(e_hat: torch.Tensor, weight: torch.Tensor,
                       labels: torch.Tensor, m: float, s: float) -> torch.Tensor:
    """The target class's margined, scaled logit via a (B, D) gather +
    row-dot — the pivot the kernel's online rank count compares against.
    Same normalization and margin formulas as the kernel.  ``labels`` must
    lie in [0, C): a class-sharded caller clips them and masks the rows
    whose target lives on another shard."""
    w_y = weight.index_select(0, labels).to(torch.float32)  # (B, D)
    w_hat = w_y / torch.sqrt(torch.clamp(torch.sum(w_y * w_y, dim=1, keepdim=True),
                                         min=1e-24))
    cos = torch.sum(e_hat * w_hat, dim=1)
    return _phi(cos, m) * s


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b without TF32: the product of the plain forward and each product
    of the plain backward."""
    with full_f32():
        return torch.matmul(a, b)


def _row_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_d x·y of each row, kept as a column: the plain backward's dW
    projection dŵ·ŵ."""
    return torch.sum(x * y, dim=1, keepdim=True)


def flash_aam_fwd_plain(e_hat: torch.Tensor, weight: torch.Tensor,
                        labels: torch.Tensor, zt: torch.Tensor, m: float = 0.2,
                        s: float = 30.0, tile: int = DEFAULT_TILE):
    """The plain PyTorch version of the forward kernel: class tiles with the
    same online (max, sum-exp) merge.  Returns (lse, zy, mx, cnt), each (B,)
    f32."""
    B = e_hat.shape[0]
    C = weight.shape[0]
    dev = e_hat.device
    run_m = torch.full((B,), _NEG_INF, dtype=torch.float32, device=dev)
    run_s = torch.zeros((B,), dtype=torch.float32, device=dev)
    zy = torch.zeros((B,), dtype=torch.float32, device=dev)
    cnt = torch.zeros((B,), dtype=torch.float32, device=dev)
    lab = labels.to(device=dev, dtype=torch.int64)[:, None]
    zt2 = zt[:, None]
    for c0 in range(0, C, tile):
        w = weight[c0:c0 + tile].to(torch.float32)
        wnorm = torch.sqrt(torch.clamp(torch.sum(w * w, dim=1, keepdim=True), min=1e-24))
        cos = _mm(e_hat, (w / wnorm).T)  # (B, tile)
        col = torch.arange(c0, c0 + w.shape[0], device=dev)[None, :]
        is_tgt = col == lab
        z = torch.where(is_tgt, _phi(cos, m), cos) * s
        m_new = torch.maximum(run_m, torch.max(z, dim=1).values)
        run_s = run_s * torch.exp(run_m - m_new) + torch.sum(
            torch.exp(z - m_new[:, None]), dim=1)
        run_m = m_new
        zy = zy + torch.sum(torch.where(is_tgt, z, 0.0), dim=1)
        cnt = cnt + torch.sum(~is_tgt & (z > zt2), dim=1).to(torch.float32)
    return run_m + torch.log(run_s), zy, run_m, cnt


def flash_aam_bwd_plain(e_hat: torch.Tensor, weight: torch.Tensor,
                        labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        m: float = 0.2, s: float = 30.0, tile: int = DEFAULT_TILE):
    """The plain PyTorch version of the backward kernel, class tile by class
    tile as ``_bwd_kernel`` goes: recompute cos and p = exp(z − lse), form
    a = (p − onehot)·dz/dcos·g, accumulate dê += a·ŵ and write each tile's
    dW = (aᵀe − proj·ŵ)/‖w‖.  Returns (dê (B, D), dW (C, D)) in e_hat's
    type: f32, or f64 for a reference free of f32 rounding."""
    B, D = e_hat.shape
    C = weight.shape[0]
    dev, dt = e_hat.device, e_hat.dtype
    cos_m, sin_m, th, mm = _margin_consts(m)
    de = torch.zeros((B, D), dtype=dt, device=dev)
    dw = torch.empty((C, D), dtype=dt, device=dev)
    lab = labels.to(device=dev, dtype=torch.int64)[:, None]
    lse2, g2 = lse[:, None], g[:, None]
    for c0 in range(0, C, tile):
        w = weight[c0:c0 + tile].to(dt)
        wnorm = torch.sqrt(torch.clamp(torch.sum(w * w, dim=1, keepdim=True), min=1e-24))
        w_hat = w / wnorm
        cos = _mm(e_hat, w_hat.T)  # (B, tile)
        sin2 = 1.0 - cos * cos
        sin = torch.sqrt(torch.clamp(sin2, 1e-12, 1.0))
        in_phi = cos - th > 0
        phi = torch.where(in_phi, cos * cos_m - sin * sin_m, cos - mm)
        is_tgt = torch.arange(c0, c0 + w.shape[0], device=dev)[None, :] == lab
        p = torch.exp(torch.where(is_tgt, phi, cos) * s - lse2)
        # dz/dcos: s off the target, s·phi' on it; no gradient through sin
        # where its clip is active (cos → ±1), as the dense autograd
        dsin = torch.where(sin2 >= 1e-12, -cos / sin, 0.0)
        dphi = torch.where(in_phi, cos_m - sin_m * dsin, 1.0)
        dz = torch.where(is_tgt, s * dphi, s)
        a = (p - is_tgt.to(dt)) * dz * g2
        de += _mm(a, w_hat)
        dw_hat = _mm(a.T, e_hat)  # (tile, D)
        proj = _row_dot(dw_hat, w_hat)
        dw[c0:c0 + tile] = (dw_hat - proj * w_hat) / wnorm
    return de, dw


def _check_inputs(e_hat, weight, labels, per_row, what):
    """Shapes and types shared by both wrappers; ``per_row`` are the other
    (B,) f32 inputs, named in ``what``."""
    B, D = e_hat.shape
    if weight.ndim != 2 or weight.shape[1] != D:
        raise ValueError(f"weight must be (C, {D}), got {tuple(weight.shape)}")
    if weight.shape[0] < 1:
        raise ValueError("weight has no classes")
    for name, t in zip(("labels",) + what, (labels,) + per_row):
        if t.shape != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    for name, t in zip(("e_hat", "weight") + what, (e_hat, weight) + per_row):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _on_card(e_hat, others, op):
    """True for CUDA inputs (all on e_hat's device), False for CPU ones."""
    if e_hat.device.type == "cpu":
        return False
    if e_hat.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {e_hat.device}")
    for name, t in others.items():
        if t.device != e_hat.device:
            raise ValueError(f"{name} is on {t.device}, e_hat on {e_hat.device}")
    return True


@functools.lru_cache(maxsize=None)
def _kernel():
    """(launch function, block rows, block classes, scratch function) of the
    built library: the scratch function gives the floats of scratch that a
    launch needs past the partial states, for (B, C, D)."""
    lib = _native.load(_KERNEL)
    fn = lib.flash_aam_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
                   + [ctypes.c_void_p] * 6)
    scratch = lib.flash_aam_fwd_scratch
    scratch.argtypes, scratch.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return fn, lib.flash_aam_fwd_block_rows(), lib.flash_aam_fwd_block_classes(), scratch


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _n_splits(n_tiles, n_btiles, units, per_unit):
    """(class tiles per split, splits) for ``n_btiles`` batch tiles over
    ``n_tiles`` class tiles on ``units`` units that hold ``per_unit`` workers
    each: SMs and blocks an SM, or clusters that the card holds at once and
    1.  Each (batch tile, split) worker takes the even share of the card's
    target = units × per_unit resident workers, ⌈pairs / target⌉ class
    tiles (at least one), so the split workers fill the card about once: at
    most target + n_btiles − 1 of them, and every class tile of its own
    where the tile pairs number no more than the target."""
    target = units * per_unit
    tiles_per_split = max(1, -(-n_tiles * n_btiles // target))
    return tiles_per_split, -(-n_tiles // tiles_per_split)


# class tiles' worth of time that a worker of the forward's cluster route
# spends before its first tile (staging and splitting its e slice); on the
# passes route a worker does so once a depth pass, and every tile step once
# a pass too, so its time is the passes times that of a cluster worker and
# the same split ends first
_START_TILES = 1


def _span(n_tiles, n_btiles, clusters, tps):
    """Tile steps until the last worker of the forward's cluster (or
    passes) route ends with splits of ``tps`` class tiles: the card starts
    the (batch tile, split) clusters in grid order (split by split; the last
    split's are the short ones) on the ``clusters`` that it holds at once,
    each as soon as one ends, and each takes its split's tiles and
    _START_TILES more (on the passes route, each pass)."""
    n_splits = -(-n_tiles // tps)
    full = tps + _START_TILES
    last = n_tiles - (n_splits - 1) * tps + _START_TILES
    waves, left = divmod((n_splits - 1) * n_btiles, clusters)
    free = [(waves + 1) * full] * left + [waves * full] * (clusters - left)
    end = max(free)
    heapq.heapify(free)
    for _ in range(n_btiles):
        t = heapq.heappop(free) + last
        end = max(end, t)
        heapq.heappush(free, t)
    return end


@functools.lru_cache(maxsize=None)
def _cluster_splits(n_tiles, n_btiles, clusters):
    """(class tiles per split, splits) for the forward's cluster and passes
    routes, whose (batch tile, split) workers are clusters with nothing to
    fill the card around them: the split whose last worker ends first
    (_span), over every split size from 1 to n_tiles and _n_splits' even
    share; a tie goes to the fewer workers.  Where the workers outnumber the
    clusters, this takes more waves of shorter workers over a last wave that
    leaves clusters idle (at 14 clusters and 8 batch tiles, 4 splits of 66
    tiles, not the even share's 2 of 131: 134 tile steps, not 198)."""
    candidates = set(range(1, n_tiles + 1))
    candidates.add(_n_splits(n_tiles, n_btiles, clusters, 1)[0])
    best = min(candidates, key=lambda t: (_span(n_tiles, n_btiles, clusters, t), -t))
    return best, -(-n_tiles // best)


# each library's routes, in the order of its <kernel>_route(D) codes
_ROUTES = {_KERNEL: ("tiles", "cluster", "passes"),
           _BWD_KERNEL: ("tiles", "wide", "passes", "cluster")}


def _query(kernel: str, name: str, D: int) -> int:
    """``int name(int D)`` of the built library of ``kernel``."""
    fn = getattr(_native.load(kernel), name)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(D)


@functools.lru_cache(maxsize=None)
def _route(kernel: str, D: int) -> str:
    """A kernel's route for depth D, as its library picks it.  The
    forward's: ``tiles`` (D ≤ 256), ``cluster`` (to 4096) or ``passes``; the
    backward's: ``tiles`` (D ≤ 256), ``wide`` (to 512), ``cluster`` (to
    4096) or ``passes``.  A cluster route runs clusters of ⌈D/256⌉ blocks:
    up to 8 (D ≤ 2048) at the portable size, 9–16 past it; a passes route
    clusters of 9–16 that walk the depth in passes
    (:func:`passes_geometry`)."""
    return _ROUTES[kernel][_query(kernel, f"{kernel}_route", D)]


@functools.lru_cache(maxsize=None)
def _occupancy(kernel: str, index: int, D: int, query: str) -> int:
    """The library's occupancy ``query`` for depth D on card ``index``:
    blocks of the route an SM (``flash_aam_bwd_blocks_per_sm``) or clusters
    of the route on the card (``flash_aam_fwd_clusters`` and
    ``flash_aam_bwd_clusters``: each kernel's cluster and passes routes)."""
    with torch.cuda.device(index):
        n = _query(kernel, query, D)
    if n < 1:
        raise RuntimeError(f"{kernel}: {query} gave {n} at D = {D}")
    return n


def passes_geometry(D: int):
    """(depth passes, blocks a cluster) of both kernels' passes routes for
    depth D > 4096, as ``flash_aam_cosine.cuh`` (``n_passes``,
    ``passes_cluster``) lays it out: the depth's ⌈D/256⌉ slices in the
    fewest passes of at most 16 (Hopper's largest cluster), then the fewest
    blocks that cover them in that many passes, one slice a block a pass.
    D = 4608: 2 passes of 9 blocks; 8192: 2 of 16; 12288: 3 of 16."""
    if D <= 4096:
        raise ValueError(f"the passes routes take D > 4096, not {D}")
    n_s = -(-D // 256)
    blocks = -(-n_s // -(-n_s // 16))
    return -(-n_s // blocks), blocks


def bwd_passes_de_workers(D: int) -> int:
    """The de workers (clusters) of the passes route for each batch tile and
    class split: one for each half of the tile's rows and each output group
    of two depth passes."""
    return 2 * -(-passes_geometry(D)[0] // 2)


def fwd_geometry(D: int):
    """(route, depth passes, blocks a worker) of the forward for depth D, as
    ``flash_aam_fwd.cu`` (``route_of``, ``flash_aam_fwd_passes``,
    ``cluster_size``) lays it out: ``tiles`` (D ≤ 256), one block a (batch
    tile, split) worker; ``cluster`` (to 4096), a cluster of ⌈D/256⌉;
    ``passes`` beyond, a cluster walking the depth in passes
    (:func:`passes_geometry`).  Each block writes its own partial states."""
    if D <= 256:
        return "tiles", 1, 1
    if D <= 4096:
        return "cluster", 1, -(-D // 256)
    return ("passes",) + passes_geometry(D)


def fwd_states(D: int, n_splits: int) -> int:
    """The partial states of each batch row that the forward's scratch holds
    for ``n_splits`` class splits, merged in order after the launch: one for
    each block of each split's worker."""
    return n_splits * fwd_geometry(D)[2]


def _launch(e_hat, weight, labels, zt, m, s):
    fn, bm, bn, scratch = _kernel()
    B, D = e_hat.shape
    C = weight.shape[0]
    dev = e_hat.device
    e_hat, weight, zt = (t.contiguous() for t in (e_hat, weight, zt))
    labels = labels.to(torch.int32).contiguous()
    index = _device_index(dev)
    route = _route(_KERNEL, D)
    n_tiles, n_btiles = -(-C // bn), -(-B // bm)
    if route == "tiles":
        tiles_per_split, n_splits = _n_splits(n_tiles, n_btiles, _sm_count(index),
                                              _BLOCKS_PER_SM)
    else:  # each worker is a cluster: split by the resident ones
        tiles_per_split, n_splits = _cluster_splits(
            n_tiles, n_btiles, _occupancy(_KERNEL, index, D, "flash_aam_fwd_clusters"))
    # the partial states, then (passes route) the running sums and the norms
    part = torch.empty(4 * fwd_states(D, n_splits) * B + scratch(B, C, D),
                       dtype=torch.float32, device=dev)
    out = torch.empty((4, B), dtype=torch.float32, device=dev)
    cos_m, sin_m, th, mm = _margin_consts(m)
    with torch.cuda.device(dev):  # the launch goes to dev's current stream
        err = fn(e_hat.data_ptr(), weight.data_ptr(), labels.data_ptr(),
                 zt.data_ptr(), B, C, D, tiles_per_split, n_splits,
                 s, cos_m, sin_m, th, mm, part.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_aam_fwd kernel launch failed: cudaError {err}")
    flash_aam_fwd.launches += 1
    flash_aam_fwd.route_launches[route] += 1
    return out[0], out[1], out[2], out[3]


def flash_aam_fwd(e_hat: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                  zt: torch.Tensor, m: float = 0.2, s: float = 30.0,
                  tile: int = DEFAULT_TILE):
    """(lse, zy, mx, cnt) of the margined logits, each (B,) f32.

    e_hat (B, D) f32 L2-normalized embeddings, weight (C, D) f32 raw class
    weights, labels (B,) integer, zt (B,) f32 margined target logits.  A CUDA
    tensor launches the kernel (counted in ``flash_aam_fwd.launches``, and
    by its route for D in ``flash_aam_fwd.route_launches``; any D) or
    raises; a CPU tensor runs the plain version (``tile`` sets its class
    tile; the kernel tiles by its own 32 × 32 blocks)."""
    _check_inputs(e_hat, weight, labels, (zt,), ("zt",))
    if _on_card(e_hat, {"weight": weight, "labels": labels, "zt": zt}, "flash_aam_fwd"):
        return _launch(e_hat, weight, labels, zt, m, s)
    return flash_aam_fwd_plain(e_hat, weight, labels, zt, m, s, tile)


flash_aam_fwd.launches = 0
flash_aam_fwd.route_launches = dict.fromkeys(_ROUTES[_KERNEL], 0)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """(launch function, block rows, block classes, scratch function) of the
    built backward library: the scratch function gives the floats of
    scratch that a launch needs past the splits' partials, for (C, D)."""
    lib = _native.load(_BWD_KERNEL)
    fn = lib.flash_aam_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5
                   + [ctypes.c_void_p] * 4)
    scratch = lib.flash_aam_bwd_scratch
    scratch.argtypes, scratch.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn, lib.flash_aam_bwd_block_rows(), lib.flash_aam_bwd_block_classes(), scratch


def _bwd_blocks_per_sm(index: int, D: int) -> int:
    """Blocks of the backward's route for depth D that one SM of card
    ``index`` holds at once."""
    return _occupancy(_BWD_KERNEL, index, D, "flash_aam_bwd_blocks_per_sm")


def _launch_bwd(e_hat, weight, labels, lse, g, m, s):
    fn, bm, bn, scratch = _bwd_kernel()
    B, D = e_hat.shape
    C = weight.shape[0]
    dev = e_hat.device
    e_hat, weight, lse, g = (t.contiguous() for t in (e_hat, weight, lse, g))
    labels = labels.to(torch.int32).contiguous()
    index = _device_index(dev)
    route = _route(_BWD_KERNEL, D)
    n_btiles = -(-B // bm)
    if route in ("cluster", "passes"):  # each de worker is a cluster: split by the resident ones
        units, per_unit = _occupancy(_BWD_KERNEL, index, D, "flash_aam_bwd_clusters"), 1
        if route == "passes":
            n_btiles *= bwd_passes_de_workers(D)
    else:
        units, per_unit = _sm_count(index), _bwd_blocks_per_sm(index, D)
    tiles_per_split, n_splits = _n_splits(-(-C // bn), n_btiles, units, per_unit)
    part = torch.empty(n_splits * B * D + scratch(C, D), dtype=torch.float32, device=dev)
    de = torch.empty((B, D), dtype=torch.float32, device=dev)
    dw = torch.empty((C, D), dtype=torch.float32, device=dev)
    cos_m, sin_m, th, mm = _margin_consts(m)
    with torch.cuda.device(dev):  # the launch goes to dev's current stream
        err = fn(e_hat.data_ptr(), weight.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                 g.data_ptr(), B, C, D, tiles_per_split, n_splits, s, cos_m, sin_m, th,
                 mm, part.data_ptr(), de.data_ptr(), dw.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_aam_bwd kernel launch failed: cudaError {err}")
    flash_aam_bwd.launches += 1
    flash_aam_bwd.route_launches[route] += 1
    return de, dw


def flash_aam_bwd(e_hat: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                  lse: torch.Tensor, g: torch.Tensor, m: float = 0.2, s: float = 30.0,
                  tile: int = DEFAULT_TILE):
    """(dê (B, D), dW (C, D)) f32: the gradients of sum_b g_b·(lse_b − zy_b)
    with respect to the normalized embeddings and the raw class weights.

    e_hat (B, D) f32 L2-normalized embeddings, weight (C, D) f32, labels (B,)
    integer, lse (B,) f32 from the forward, g (B,) f32 per-example loss
    gradient.  A CUDA tensor launches the kernel (counted in
    ``flash_aam_bwd.launches``, and by its route for D in
    ``flash_aam_bwd.route_launches``; any D) or raises; a CPU tensor runs
    the plain version with class tile ``tile``."""
    _check_inputs(e_hat, weight, labels, (lse, g), ("lse", "g"))
    if _on_card(e_hat, {"weight": weight, "labels": labels, "lse": lse, "g": g},
                "flash_aam_bwd"):
        return _launch_bwd(e_hat, weight, labels, lse, g, m, s)
    return flash_aam_bwd_plain(e_hat, weight, labels, lse, g, m, s, tile)


flash_aam_bwd.launches = 0
flash_aam_bwd.route_launches = dict.fromkeys(_ROUTES[_BWD_KERNEL], 0)


def _acc_from(zy: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Margined top-1 from the online state: the target is the argmax iff
    its logit equals the running max.  Exact comparison — zy itself is folded
    into the running max, so zy == mx holds bit for bit when the target wins."""
    return torch.mean((zy >= mx).to(torch.float32))


def _acc5_from(cnt: torch.Tensor) -> torch.Tensor:
    """Top-5 from the online target rank: the target sits in the top k iff
    fewer than k classes strictly beat it."""
    return torch.mean((cnt < 5.0).to(torch.float32))


class _FlashAAMLoss(torch.autograd.Function):
    """(mean ArcFace CE, top-1, top-5) forward through the forward kernel;
    the backward kernel gives the loss's gradients in emb and weight.  The
    two metrics are marked non-differentiable: they are not loss terms."""

    @staticmethod
    @trace.spanned("flash.fwd")
    def forward(ctx, emb, weight, labels, m, s, tile):
        e_hat, e_norm = _normalize(emb.to(torch.float32))
        w = weight.to(torch.float32)
        labels = labels.to(device=e_hat.device, dtype=torch.int64)
        safe = torch.clamp(labels, 0, w.shape[0] - 1)
        zt = _margined_target_z(e_hat, w, safe, m, s)
        lse, zy, mx, cnt = flash_aam_fwd(e_hat, w, labels, zt, m, s, tile)
        ctx.save_for_backward(e_hat, e_norm, w, labels, lse)
        ctx.consts = (m, s, tile, emb.dtype, weight.dtype)
        acc, acc5 = _acc_from(zy, mx), _acc5_from(cnt)
        ctx.mark_non_differentiable(acc, acc5)
        return torch.mean(lse - zy), acc, acc5

    @staticmethod
    @trace.spanned("flash.bwd")
    def backward(ctx, gloss, _gacc, _gacc5):
        e_hat, e_norm, w, labels, lse = ctx.saved_tensors
        m, s, tile, emb_dtype, w_dtype = ctx.consts
        B = e_hat.shape[0]
        g = (gloss.to(torch.float32) / B).expand(B).contiguous()
        de_hat, dw = flash_aam_bwd(e_hat, w, labels, lse, g, m, s, tile)
        # unproject dê through the embedding normalization
        proj = torch.sum(de_hat * e_hat, dim=1, keepdim=True)
        de = (de_hat - proj * e_hat) / e_norm
        return de.to(emb_dtype), dw.to(w_dtype), None, None, None, None


def flash_aam_loss(emb: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                   m: float = 0.2, s: float = 30.0, tile: int = DEFAULT_TILE
                   ) -> torch.Tensor:
    """Mean ArcFace cross-entropy without materializing (B, n_classes)
    logits; differentiable in emb (B, D) and weight (n_classes, D)."""
    return _FlashAAMLoss.apply(emb, weight, labels, m, s, tile)[0]


def flash_aam_loss_acc(emb: torch.Tensor, weight: torch.Tensor,
                       labels: torch.Tensor, m: float = 0.2, s: float = 30.0,
                       tile: int = DEFAULT_TILE):
    """(loss, top-1, top-5): the loss as :func:`flash_aam_loss` plus the
    margined top-1 from the forward's online max and top-5 from its online
    target-rank count (no extra pass; the metrics carry no gradient)."""
    return _FlashAAMLoss.apply(emb, weight, labels, m, s, tile)


def reference_aam_loss(emb: torch.Tensor, weight: torch.Tensor,
                       labels: torch.Tensor, m: float = 0.2, s: float = 30.0
                       ) -> torch.Tensor:
    """Dense reference (ops.aam path + CE)."""
    logits = aam_logits(emb, weight, labels, m, s)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.to(torch.int64)[:, None]))


# ---------------------------------------------------------------------------
# the head over a process mesh
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all_reduce over ``group``; the identity where it is None (an
    axis of one rank)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _FlashAAMSharded(torch.autograd.Function):
    """The flash head over a mesh (``pkr_tpu``'s ``_sm_fwd``/``_sm_bwd``
    under ``shard_map``).  Forward: with a class-sharded weight, the pivot
    zt comes from the owning shard (a clipped gather, masked, summed over
    ``model``), each rank runs the forward kernel on its shard with
    shard-local labels, and the states merge over ``model`` (lse by its
    maximum and then the sum of exp, zy and cnt by sum, mx by maximum);
    loss and both accuracies are means over ``data``.  Backward: g =
    gloss / (B_local · n_data), the backward kernel on the shard, dê summed
    over ``model`` (class-sharded) and dW over ``data``."""

    @staticmethod
    @trace.spanned("flash.fwd")
    def forward(ctx, emb, weight, labels, mesh, c_local, sharded, m, s, tile):
        e_hat, e_norm = _normalize(emb.to(torch.float32))
        w = weight.to(torch.float32)
        if w.shape[0] != c_local:
            raise ValueError(f"weight has {w.shape[0]} rows, this rank's shard "
                             f"{c_local}")
        y = labels.to(device=e_hat.device, dtype=torch.int64)
        if sharded:
            y = y - mesh.model_index * c_local
            in_range = (y >= 0) & (y < c_local)
            zt = torch.where(in_range, _margined_target_z(
                e_hat, w, torch.clamp(y, 0, c_local - 1), m, s), 0.0)
            _all_reduce(zt, dist.ReduceOp.SUM, mesh.model_group)
        else:
            zt = _margined_target_z(e_hat, w, torch.clamp(y, 0, c_local - 1), m, s)
        lse, zy, mx, cnt = flash_aam_fwd(e_hat, w, y, zt, m, s, tile)
        if sharded and mesh.model_group is not None:
            peak = _all_reduce(torch.stack([lse, mx]), dist.ReduceOp.MAX,
                               mesh.model_group)
            sums = _all_reduce(torch.stack([torch.exp(lse - peak[0]), zy, cnt]),
                               dist.ReduceOp.SUM, mesh.model_group)
            lse, mx = peak[0] + torch.log(sums[0]), peak[1]
            zy, cnt = sums[1], sums[2]
        out = torch.stack([torch.mean(lse - zy), _acc_from(zy, mx), _acc5_from(cnt)])
        _all_reduce(out, dist.ReduceOp.SUM, mesh.data_group)
        out = out / mesh.n_data
        ctx.save_for_backward(e_hat, e_norm, w, y, lse)
        ctx.consts = (mesh, sharded, m, s, tile, emb.dtype, weight.dtype)
        loss, acc, acc5 = (out[i].clone() for i in range(3))
        ctx.mark_non_differentiable(acc, acc5)
        return loss, acc, acc5

    @staticmethod
    @trace.spanned("flash.bwd")
    def backward(ctx, gloss, _gacc, _gacc5):
        e_hat, e_norm, w, y, lse = ctx.saved_tensors
        mesh, sharded, m, s, tile, emb_dtype, w_dtype = ctx.consts
        B = e_hat.shape[0]
        g = (gloss.to(torch.float32) / (B * mesh.n_data)).expand(B).contiguous()
        de_hat, dw = flash_aam_bwd(e_hat, w, y, lse, g, m, s, tile)
        if sharded:
            _all_reduce(de_hat, dist.ReduceOp.SUM, mesh.model_group)
        _all_reduce(dw, dist.ReduceOp.SUM, mesh.data_group)
        proj = torch.sum(de_hat * e_hat, dim=1, keepdim=True)
        de = (de_hat - proj * e_hat) / e_norm
        return (de.to(emb_dtype), dw.to(w_dtype), None, None, None, None, None, None,
                None)


def make_flash_aam_sharded(mesh, n_classes: int, m: float = 0.2, s: float = 30.0,
                           tile: int = DEFAULT_TILE,
                           weight_sharded: Optional[bool] = None,
                           with_acc: bool = False):
    """The flash loss over a process mesh: loss_fn(emb, weight, labels) →
    the global mean loss, or (loss, top-1, top-5) with ``with_acc``, each
    the same on every rank.

    ``emb`` (B_local, D) and ``labels`` (B_local,) are this rank's share of
    the global batch (ranks of one data row hold the same share); ``weight``
    is, by the regime:

    - **whole** on every rank (default where the mesh has no ``model`` axis
      over 1 or ``n_classes`` does not divide it): each rank runs the
      kernels over every class; dW is summed over ``data`` in the backward
      (the reference's DDP layout);
    - **class-sharded** (``weight_sharded``, default where ``n_classes``
      divides ``n_model``; ``parallel.shard_params`` makes it): rank m holds
      rows [m·C/n_model, (m + 1)·C/n_model) and runs the kernels over them
      with shard-local labels; the online softmax merges over ``model`` in
      two collectives of (B,) vectors, dê is summed over ``model`` and dW
      over ``data``.  The (B, C) logits exist nowhere, and no rank holds the
      whole weight.

    The top-1 and top-5 equal the dense head's: the maxima merge by maximum
    and the rank counts, each shard's against the one global pivot, by
    sum."""
    n_model = int(mesh.n_model)
    if weight_sharded is None:
        weight_sharded = n_model > 1 and n_classes % n_model == 0
    if weight_sharded and n_classes % n_model:
        raise ValueError(f"the class-sharded flash head needs n_classes % n_model == 0, "
                         f"got {n_classes} % {n_model}")
    c_local = n_classes // n_model if weight_sharded else n_classes

    def loss_acc_fn(emb, weight, labels):
        return _FlashAAMSharded.apply(emb, weight, labels, mesh, c_local,
                                      bool(weight_sharded), m, s, tile)

    if with_acc:
        return loss_acc_fn
    return lambda emb, weight, labels: loss_acc_fn(emb, weight, labels)[0]


def flash_aam_loss_sharded(emb: torch.Tensor, weight: torch.Tensor,
                           labels: torch.Tensor, mesh, m: float = 0.2,
                           s: float = 30.0, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """The data-parallel (whole-weight) flash loss over a mesh; see
    :func:`make_flash_aam_sharded` for the regimes."""
    return make_flash_aam_sharded(mesh, weight.shape[0], m, s, tile,
                                  weight_sharded=False)(emb, weight, labels)
