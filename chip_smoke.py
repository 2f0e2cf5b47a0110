#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pkr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:
  env     the card's name, count and power limit (nvidia-smi);
  build   nvcc builds every kernel of the paths from csrc/, one nvcc per
          source, all at once (seconds, ptxas registers and shared memory,
          and the tensor-core HMMA instructions cuobjdump finds in each:
          both kernels run on the tensor cores, so neither may have none);
  kernel  each kernel against its plain PyTorch version on the card, at the
          shapes of the paths and beyond, D = 256 and the chunked D = 512 and
          300 (a gradient row by row, each row within 1e-3 of its own norm,
          with planted faults the check must reject; the backward also with
          every target p ≈ 0.993 against the plain version in f64, at D = 37,
          and twice for the same bits), with its time, the plain version's
          time, a dense library yardstick's time and two roofline bounds (f32
          CUDA cores; 3×TF32 tensor cores); then the two kernels against each
          other: with one class the backward's gradients are exactly 0 iff
          both formed the same cosine bits (check_consistency); and one flash
          and one dense train step of a 512-wide embedding agree;
  slice   the serving path at full width — 128 six-second utterances through
          wav_to_train_feats → ResNet-34 SpeakerModel (7325-speaker AAM head,
          seeded random weights) → extract_embeddings → the flash eval step →
          cosine_scores → compute_eer — with its launch counts and checks;
  profile the device and wall time of the slice's stages (frontend, bf16
          embedding, flash eval step) and their longest kernels;
  train   the training path at full width — ResNet-34, B=256 synthetic
          200-frame crops, 7325 speakers, bf16 trunk — through
          make_train_step (flash head, then dense head) and one epoch of
          train_and_validate, with its launch counts, checks (the loss falls,
          flash and dense steps agree), train examples/s, ms/step and
          conv-MFU;
  train_profile  the device and wall time of one train step per head and
          its longest kernels;
  corpus  training and extraction from a Kaldi data dir at the train
          phase's width: a synthetic CM-compressed feats.ark/scp of 7325
          speakers × 2 utterances (utt2spk, spk2utt, utt2spkid, a cv split);
          one epoch of train_and_validate on the host TrainLoader (native
          reader), one on the card-resident DeviceCacheLoader, and
          extraction over the quantized transport → cosine scores → EER,
          with loader rates, the native reader's cost per call, step times
          and bytes sent to the card;
  recipe  the recipe CLI, python -m pkr_tpu_torch.recipes.run, through its
          main on the card (no --device): stages 0-1 over 512 synthetic 6-s
          wavs of 128 speakers (cut from a corpus so the phase fits the
          script's time; default frontend, dither from the seed); then, on a
          synthetic CM-compressed corpus at the train phase's width (7325
          speakers x 2 utterances, placed as stage 1 would leave it) and a
          test side of 256 other speakers x 4 utterances with ~20k trials
          from voxceleb.make_trials: softmax_plda, one epoch on the
          card-resident cache (stages 2-3); aam_v2 warm-started from it with
          the flash head, one epoch, a 2048-utterance cohort extraction and
          S-norm scoring (stages 2-6); the same resumed to 2 epochs (stage 3
          runs epoch 2 only); stage 6 again with PLDA and cosine.  Gates:
          finite losses, the warm start loads what pkr_tpu's rule loads,
          'latest', and 'best' where a cv top-1 beat the running best (the
          short runs here stay at 0, so a re-save of the trained model with
          is_best must give a 'best' that restores), one finite score per
          trial, EER and minDCF in [0, 1], both kernels launched.  Prints
          stage-1 utterances/s, train ms/step per run, checkpoint
          save/best-save/restore ms and bytes, extraction
          utterances/s, cohort top-k ms, scoring s and EER/minDCF per
          backend;
  kernels every kernel with its launches on the paths and its errors.
Then the card's nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero before the last line.  Without a CUDA card,
or outside a checkout, it fails at once and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, dense bf16 and
# TF32 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
KERNELS = ("flash_aam_fwd", "flash_aam_bwd")

SECONDS = 6.0
RATE = 16000
N_SAMPLES = int(SECONDS * RATE)
BATCH = 128
SPK = 7325
TRAIN_B = 256
TRAIN_T = 200  # the recipe's training crop

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def make_wavs(batch, seed=0):
    """Synthetic 6-s utterances: a low sine (the 'voice') plus noise, int16 scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES) / RATE
    freqs = rng.uniform(80, 300, size=(batch, 1))
    sig = 3000 * np.sin(2 * np.pi * freqs * t[None, :])
    sig += 400 * rng.standard_normal((batch, N_SAMPLES))
    return sig.astype(np.float32), freqs[:, 0]


def call_ms(torch, fn, iters, warmup=2):
    """Mean time of one call, host included: CUDA events around `iters`
    back-to-back calls (a call whose host work outlasts its kernels is
    measured at its host rate)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, only=None):
    """Device time of one call, traced by torch.profiler over `iters` calls:
    (summed durations of its device activities (kernels, copies) in ms,
    activities per call, the six longest by name as [name, ms per call]).
    `only` keeps activities whose name contains one of the given strings.
    The time is None when the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without the device activities of
    # launches that other traces of the same call show: trace again, up to
    # three times, before reporting none
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        n = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (only is None or
                                                     any(o in e.name for o in only)):
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / iters)
                n += 1
        if n:
            break
    if not n:
        return None, 0, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return sum(by_name.values()), n / iters, [[k[:80], v] for k, v in top]


def _bounds(flops, nbytes):
    """(bound ms, what bounds it) on the f32 CUDA cores, and the bound ms of
    the same products in 3×TF32 on the tensor cores (three TF32 operations
    per f32 operation at the dense TF32 peak), each against the bytes."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    t_tc = 3 * flops / PEAK_TF32_FLOPS
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            1e3 * max(t_tc, t_bytes))


def flash_bound(B, C, D):
    """Least time for (lse, zy, mx, cnt): 2·B·C·D f32 operations against
    reading e, W, labels, zt once and writing four (B,) f32."""
    return _bounds(2.0 * B * C * D, 4.0 * (B * D + C * D + 2 * B + 4 * B))


def flash_bwd_bound(B, C, D):
    """Least time for (dê, dW): 6·B·C·D f32 operations (the cosine product,
    a·ŵ and aᵀe) against reading e, W, labels, lse, g once and writing dê
    and dW."""
    return _bounds(6.0 * B * C * D, 4.0 * (2 * (B * D + C * D) + 3 * B))


def resnet34_train_flops(batch, feat_dim, frames):
    """Conv FLOPs of one ResNet-34 AAM training step (fwd + bwd ≈ 3× fwd,
    matmul/conv MACs only): a copy of bench.py's formula for the flagship
    geometry (3×3 stem to 32 channels, stages 32/64/128/256 × 3/4/6/3
    blocks, strides 1/2/2/2, fc1 and the 7325-class head)."""
    h, w = feat_dim, frames
    flops = 2 * 1 * 32 * 9 * h * w  # stem
    cin = 32
    for c, n, s in ((32, 3, 1), (64, 4, 2), (128, 6, 2), (256, 3, 2)):
        h, w = -(-h // s), -(-w // s)
        for j in range(n):
            c_in = cin if j == 0 else c
            flops += 2 * 9 * c_in * c * h * w   # conv1
            flops += 2 * 9 * c * c * h * w      # conv2
            if j == 0 and (s != 1 or c_in != c):
                flops += 2 * c_in * c * h * w   # 1×1 downsample
            cin = c
    flops += 2 * (5 * 2 * 256) * 256
    flops += 2 * 256 * 7325
    return 3.0 * batch * flops


def phase_env(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "env", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi_line


def hmma_count(lib):
    """HMMA (tensor-core matrix) instructions in a built library's SASS."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr[-2000:]}")
    return sum(1 for line in out.stdout.splitlines() if " HMMA." in line)


def phase_build():
    from pkr_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.build_all(KERNELS)
    wall = time.perf_counter() - t0
    for name in KERNELS:
        _native.load(name)
        info = _native.BUILD_INFO[name]
        hmma = hmma_count(info["path"])
        emit({"phase": "build", "kernel": name, "seconds": info["seconds"],
              "wall_seconds_all": wall, "ptxas": info["ptxas"], "hmma_instructions": hmma})
        check(hmma > 0, f"the {name} library has no HMMA instruction")


# target cosine of the confident case, by D: every target p ≈ 0.993 at
# C = 7325.  The non-target logits s·cos spread as s/√D, so they sum to
# about (C − 1)·exp(s²/2D), and the target logit s·phi(cos) must be
# ln(0.993/0.007) above that sum's log: cos = 0.68 at D = 256, 0.654 at
# D = 512
CONFIDENT_COS = {256: 0.68, 512: 0.654}


def _flash_inputs(torch, B, C, D, seed, saturated=False, confident=False):
    dev = torch.device("cuda")
    if saturated:
        # cos(target) exactly 1.0: a one-hot embedding equals a normalized
        # one-hot weight row (tests/test_flash_aam.py's saturated case)
        g = torch.Generator(device=dev).manual_seed(seed)
        w = torch.randn((C, D), generator=g, device=dev)
        w[5] = 0.0
        w[5, 2] = 2.0
        emb = torch.zeros((B, D), device=dev)
        emb[:, 2] = 1.0
        labels = torch.tensor([5, 5, 7, 9][:B], device=dev)
        return emb, w, labels
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((C, D), generator=g, device=dev)
    labels = torch.randint(0, C, (B,), generator=g, device=dev)
    if confident:
        # each embedding at cosine CONFIDENT_COS[D] to its class row (a
        # random unit direction orthogonal to it makes up the rest): with
        # C = 7325 every target p is ≈ 0.993, so a = p − 1 cancels
        w_y = w[labels] / w[labels].norm(dim=1, keepdim=True)
        u = torch.randn((B, D), generator=g, device=dev)
        u = u - (u * w_y).sum(dim=1, keepdim=True) * w_y
        u = u / u.norm(dim=1, keepdim=True)
        cos = CONFIDENT_COS[D]
        return cos * w_y + (1 - cos ** 2) ** 0.5 * u, w, labels
    # embeddings half-way to their class (target cosine ≈ 0.45): the target
    # wins for some rows and loses for others, so top-1/top-5 are exercised
    emb = 0.5 * w[labels] + torch.randn((B, D), generator=g, device=dev)
    return emb, w, labels


def _rank_gaps(torch, emb, w, labels, rows, k):
    """|target logit − k-th best non-target logit| of the given rows (dense)."""
    from pkr_tpu_torch.ops.aam import aam_logits

    z = aam_logits(emb[rows], w, labels[rows])
    tgt = z.gather(1, labels[rows][:, None])[:, 0]
    z = z.scatter(1, labels[rows][:, None], float("-inf"))
    kth = torch.topk(z, k, dim=1).values[:, k - 1]
    return (tgt - kth).abs()


FWD_KERNELS = ("fwd_tiles_kernel", "fwd_chunks_kernel", "merge_kernel")


def check_flash_case(torch, name, B, C, D, seed, saturated=False, timed=True):
    from pkr_tpu_torch.ops import flash_aam as fa

    emb, w, labels = _flash_inputs(torch, B, C, D, seed, saturated)
    e_hat, _ = fa._normalize(emb)
    zt = fa._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    got = fa.flash_aam_fwd(e_hat, w, labels, zt)
    torch.cuda.synchronize()
    ref = fa.flash_aam_fwd_plain(e_hat, w, labels, zt)
    err_lse = float((got[0] - ref[0]).abs().max())
    err_zy = float((got[1] - ref[1]).abs().max())
    loss_got = float((got[0] - got[1]).mean())
    loss_ref = float((ref[0] - ref[1]).mean())
    n1 = (int((got[1] >= got[2]).sum()), int((ref[1] >= ref[2]).sum()))
    n5 = (int((got[3] < 5).sum()), int((ref[3] < 5).sum()))
    row = {"phase": "kernel", "kernel": "flash_aam_fwd", "case": name, "B": B, "C": C,
           "D": D, "max_abs_err_lse": err_lse, "max_abs_err_zy": err_zy,
           "loss": loss_got, "loss_plain": loss_ref, "n1": n1, "n5": n5,
           "tol": {"lse_zy": 5e-4, "loss": 2e-4, "topk_gap": 1e-4}}
    check(np.isfinite([err_lse, err_zy, loss_got]).all(), f"{name}: non-finite output")
    check(err_lse <= 5e-4 and err_zy <= 5e-4, f"{name}: lse/zy error {err_lse}, {err_zy}")
    check(abs(loss_got - loss_ref) <= 2e-4, f"{name}: loss {loss_got} vs {loss_ref}")
    for tag, k, a, b in (("top1", 1, got[1] >= got[2], ref[1] >= ref[2]),
                         ("top5", 5, got[3] < 5, ref[3] < 5)):
        rows = torch.nonzero(a != b)[:, 0]
        if rows.numel():
            gaps = _rank_gaps(torch, emb, w, labels, rows, min(k, C - 1))
            row[f"{tag}_gap"] = float(gaps.max())
            check(float(gaps.max()) < 1e-4,
                  f"{name}: {tag} differs on {rows.numel()} rows, gap {float(gaps.max())}")
    if timed:
        from pkr_tpu_torch.ops.aam import aam_logits

        def dense():
            z = aam_logits(emb, w, labels)
            return torch.logsumexp(z, dim=1), z.gather(1, labels[:, None])

        iters = max(3, min(50, int(2e11 / (B * C * D))))
        timed_fns = (("kernel", lambda: fa.flash_aam_fwd(e_hat, w, labels, zt),
                      FWD_KERNELS),
                     ("plain", lambda: fa.flash_aam_fwd_plain(e_hat, w, labels, zt), None),
                     ("library", dense, None))
        for tag, fn, only in timed_fns:
            row[f"{tag}_ms"], row[f"{tag}_device_kernels_per_call"], top = device_ms(
                torch, fn, iters, only)
            row[f"{tag}_call_ms"] = call_ms(torch, fn, iters)
            if tag == "kernel":  # the tile kernel and the merge, ms each per call
                row["kernel_ms_by_launch"] = top
        check(row["kernel_ms"] is not None, f"{name}: the trace shows no kernel time")
        row["bound_ms"], row["bound_by"], row["bound_tc_ms"] = flash_bound(B, C, D)
    emit(row)
    return row


BWD_KERNELS = ("bwd_tiles_kernel", "bwd_chunks_kernel", "bwd_de_sum_kernel")
ROW_TOL = 1e-3


def row_rel_err(torch, got, ref):
    """max over rows r of ‖got_r − ref_r‖ / ‖ref_r‖ (in f64), where a row is
    one class of a weight gradient or one example of an embedding gradient.
    Each row is held to its own scale: a non-target class's gradient is
    orders of magnitude below a target class's, so a bound on the whole
    tensor's largest entry cannot see it.  A row whose reference is 0 must
    be 0."""
    num = (got.double() - ref.double()).norm(dim=1)
    den = ref.double().norm(dim=1)
    rel = torch.where(den > 0, num / den.clamp_min(1e-300),
                      torch.where(num > 0, float("inf"), 0.0))
    return float(rel.max())


def planted_faults(torch, got, ref, labels=None):
    """The faults the row check must reject, as {name: (row error, whether
    the whole-tensor check max|Δ| ≤ 1e-3·max|ref| + 1e-6 would pass it)}:
    the smallest non-zero row off by 3·ROW_TOL of itself and, for a weight
    gradient (`labels` given), every class that is no example's target
    zeroed, as a kernel that wrote only the one-hot term would."""
    faults = {}
    small = ref.double().norm(dim=1)
    small = torch.where(small > 0, small, float("inf")).argmin()
    f = got.clone()
    f[small] *= 1.0 + 3 * ROW_TOL
    faults["smallest_row_off"] = f
    if labels is not None:
        f = got.clone()
        keep = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
        keep[labels] = True
        f[~keep] = 0.0
        faults["non_target_rows_zeroed"] = f
    scale = float(ref.abs().max())
    return {k: (row_rel_err(torch, f, ref),
                float((f - ref).abs().max()) <= 1e-3 * scale + 1e-6)
            for k, f in faults.items()}


def check_flash_bwd_case(torch, name, B, C, D, seed, saturated=False, timed=True,
                         confident=False, repeat=False):
    """flash_aam_bwd against flash_aam_bwd_plain, on dê and on dW: every row
    within ROW_TOL of its own norm (row_rel_err), and max|Δ| ≤
    1e-3·max|ref| + 1e-6 over the tensor (the kernel and cuBLAS sum in
    different orders, and dz/dcos magnifies cosine rounding near cos = ±1).
    Planted faults in the kernel's output must fail the row check.

    `confident` puts every target p near 0.993, where a = p − 1 cancels and
    s·Δcos/(1 − p) magnifies any rounding of a cosine ~4000×: there the f32
    plain version is itself ~3e-3 off, so the kernel is held to the plain
    version run in f64 (the f32 plain version's own row error is reported).
    `repeat` also checks that a second call gives the same bits."""
    from pkr_tpu_torch.ops import flash_aam as fa

    emb, w, labels = _flash_inputs(torch, B, C, D, seed, saturated, confident)
    e_hat, _ = fa._normalize(emb)
    zt = fa._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    lse = fa.flash_aam_fwd(e_hat, w, labels, zt)[0]
    g = torch.full((B,), 1.0 / B, device=emb.device)
    got = fa.flash_aam_bwd(e_hat, w, labels, lse, g)
    torch.cuda.synchronize()
    ref = fa.flash_aam_bwd_plain(e_hat, w, labels, lse, g)
    row = {"phase": "kernel", "kernel": "flash_aam_bwd", "case": name, "B": B, "C": C,
           "D": D, "tol": {"row_rel": ROW_TOL, "max_abs": "1e-3*max|ref| + 1e-6"}}
    if confident:
        p_t = torch.exp(zt - lse)
        row["target_p"] = {"min": float(p_t.min()), "median": float(p_t.median())}
        check(float(p_t.min()) >= 0.99, f"{name}: target p {row['target_p']} below 0.99")
        ref64 = fa.flash_aam_bwd_plain(e_hat.double(), w.double(), labels, lse.double(),
                                       g.double())
        row["plain_f32_row_rel_err"] = {"de": row_rel_err(torch, ref[0], ref64[0]),
                                        "dw": row_rel_err(torch, ref[1], ref64[1])}
        row["reference"] = "flash_aam_bwd_plain in f64"
        ref = ref64
    if repeat:
        again = fa.flash_aam_bwd(e_hat, w, labels, lse, g)
        row["same_bits_twice"] = bool(torch.equal(got[0], again[0]) and
                                      torch.equal(got[1], again[1]))
        check(row["same_bits_twice"], f"{name}: two calls gave different bits")
    for tag, gt, r, lab in (("de", got[0], ref[0], None), ("dw", got[1], ref[1], labels)):
        err, scale = float((gt - r).abs().max()), float(r.abs().max())
        rel = row_rel_err(torch, gt, r)
        norms = r.double().norm(dim=1)
        row[f"max_abs_err_{tag}"], row[f"max_abs_{tag}"] = err, scale
        row[f"row_rel_err_{tag}"] = rel
        row[f"row_norm_range_{tag}"] = [float(norms.min()), float(norms.max())]
        check(bool(torch.isfinite(gt).all()), f"{name}: non-finite {tag}")
        check(rel <= ROW_TOL, f"{name}: {tag} row error {rel} (whole-tensor error {err} "
                              f"against scale {scale})")
        check(err <= 1e-3 * scale + 1e-6, f"{name}: {tag} error {err} against scale {scale}")
        faults = planted_faults(torch, gt, r, lab)
        row[f"planted_{tag}"] = {k: {"row_rel_err": v[0], "whole_tensor_check_passes": v[1]}
                                 for k, v in faults.items()}
        for k, (f_rel, _) in faults.items():
            check(f_rel > ROW_TOL, f"{name}: the row check missed the planted {tag} fault {k}")
    if timed:
        from pkr_tpu_torch.ops.aam import aam_logits

        # the dense head's backward (cuBLAS f32) for the same loss Σ g·CE,
        # its graph built once: each call runs the backward alone
        e_d = e_hat.clone().requires_grad_(True)
        w_d = w.clone().requires_grad_(True)
        logp = torch.log_softmax(aam_logits(e_d, w_d, labels), dim=1)
        dense_loss = -torch.sum(g * logp.gather(1, labels[:, None])[:, 0])

        def dense_bwd():
            return torch.autograd.grad(dense_loss, (e_d, w_d), retain_graph=True)

        iters = max(3, min(30, int(1e11 / (B * C * D))))
        for tag, fn, only in (
                ("kernel", lambda: fa.flash_aam_bwd(e_hat, w, labels, lse, g), BWD_KERNELS),
                ("plain", lambda: fa.flash_aam_bwd_plain(e_hat, w, labels, lse, g), None),
                ("library", dense_bwd, None)):
            row[f"{tag}_ms"], row[f"{tag}_device_kernels_per_call"], _ = device_ms(
                torch, fn, iters, only)
            row[f"{tag}_call_ms"] = call_ms(torch, fn, iters)
        check(row["kernel_ms"] is not None, f"{name}: the trace shows no kernel time")
        row["bound_ms"], row["bound_by"], row["bound_tc_ms"] = flash_bwd_bound(B, C, D)
    emit(row)
    return row


def consistency_inputs(torch, B, D, seed, exact):
    """One class row w (C = 1) and B unit embeddings, every label 0.

    `exact`: w has entries ±1 and ±2 (random signs) and, where D ≢ 1 (mod 3),
    one or two zeros, with Σw² a power of 4, so 1/‖w‖ is a power of two and
    every product and sum is exact: row 0 is
    w/‖w‖ (cosine exactly 1.0), rows j = 1..4 the same with one entry lowered
    so that the cosine is exactly 1 − j·2⁻²⁴ (j ulps below 1.0, the sin
    clip); the rest lie at cosines spread over (−1, 1).  Otherwise w is
    Gaussian (the norm and the dot round at every step) and 33 rows, w/‖w‖
    scaled by 1 + j·2⁻²⁴ (j = −16..16), sweep the floats around 1.0."""
    rng = np.random.default_rng(seed)
    if exact:
        n_zero = (D - 1) % 3
        n_two = (4 ** int(np.ceil(np.log(D) / np.log(4))) - D + n_zero) // 3
        check(n_two + n_zero < D, f"no exact construction at D = {D}")
        i = np.arange(D)
        w = (np.where(i < n_two, 2.0, np.where(i < n_two + n_zero, 0.0, 1.0))
             * rng.choice([-1.0, 1.0], D))
        rinv = 1.0 / np.sqrt(np.sum(w * w))
        w_hat = w * rinv
        near = np.repeat(w_hat[None, :], 5, axis=0)
        near[:, -1] -= np.sign(w[-1]) * np.arange(5) * 2.0 ** -24 / rinv
    else:
        w = rng.standard_normal(D)
        w_hat = w / np.linalg.norm(w)
        near = w_hat[None, :] * (1.0 + np.arange(-16, 17)[:, None] * 2.0 ** -24)
    cos = np.linspace(-1.0, 1.0, B - len(near) + 2)[1:-1]
    u = rng.standard_normal((len(cos), D))
    u -= (u @ w_hat)[:, None] * w_hat[None, :]
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    far = cos[:, None] * w_hat[None, :] + np.sqrt(1.0 - cos ** 2)[:, None] * u
    emb = np.concatenate([near, far]).astype(np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(emb).to(dev), torch.from_numpy(w[None, :].astype(np.float32)).to(dev),
            torch.zeros(B, dtype=torch.int64, device=dev))


def check_consistency(torch, B, D, seed, exact):
    """The forward and the backward kernel form the same cosine bits.  With
    one class (C = 1) and every label 0, the forward's lse is its zy (one
    logit), so where the backward's cosine has the forward's bits its
    p = exp(z − lse) is exactly 1, a = (p − 1)·… exactly 0, and dê and dW
    exactly 0.  A cosine one ulp off moves z by s·phi'·ulp (s·phi' ≈ 29 at
    cos = 0, larger toward 1), so p ≠ 1 almost everywhere: a forward that
    sums e·w on f32 FMAs in depth order, as this repository's first forward
    kernel did, fails the check.  The
    `exact` case also puts rows at cosine 1.0 and 1–4 ulps below it (read
    back from zy through the margin: each of those cosines has its own
    margined logit)."""
    from pkr_tpu_torch.ops import flash_aam as fa

    emb, w, labels = consistency_inputs(torch, B, D, seed, exact)
    zt = fa._margined_target_z(emb, w, labels, 0.2, 30.0)
    lse, zy, mx, cnt = fa.flash_aam_fwd(emb, w, labels, zt)
    de, dw = fa.flash_aam_bwd(emb, w, labels, lse, torch.full((B,), 1.0 / B, device=emb.device))
    torch.cuda.synchronize()
    # the margined target logit at cos = 1 − k·2⁻²⁴, formed on the CPU with
    # the kernels' roundings
    z_near = (fa._phi(torch.tensor([1.0 - k * 2.0 ** -24 for k in range(5)]), 0.2)
              * 30.0).tolist()
    zy_cpu = zy.cpu()
    row = {"phase": "kernel", "kernel": "consistency", "case": "exact" if exact else "gaussian",
           "B": B, "C": 1, "D": D, "lse_equals_zy": bool(torch.equal(lse, zy)),
           "max_abs_de": float(de.abs().max()), "max_abs_dw": float(dw.abs().max()),
           "rows_at_cos_1_minus_k_ulp": [int((zy_cpu == z).sum()) for z in z_near],
           "tol": "exactly 0"}
    emit(row)
    check(row["lse_equals_zy"] and torch.equal(zy, mx) and not bool(cnt.any()),
          f"C = 1: the forward's lse is not its zy ({B} x {D})")
    check(row["max_abs_de"] == 0.0 and row["max_abs_dw"] == 0.0,
          f"C = 1 ({B} x {D}): the backward's cosines differ from the forward's "
          f"(max |dê| {row['max_abs_de']}, max |dW| {row['max_abs_dw']})")
    if exact:
        check(zy_cpu[:5].tolist() == z_near, f"C = 1 ({B} x {D}): the rows meant for "
                                             f"cos = 1 − k ulps are elsewhere")
    return row


def phase_kernel(torch, smi_line):
    # D > 256 (the chunked path of both kernels): the 512-wide embedding at
    # the train batch, and a ragged 100 x 7001 x 300
    cases = [("slice_eval", BATCH, SPK, 256, True), ("path_b256", 256, SPK, 256, True),
             ("path_b1024", 1024, SPK, 256, True), ("scale_c131072", 256, 131072, 256, True),
             ("ragged", 100, 7001, 256, False), ("path_b256_d512", 256, SPK, 512, True),
             ("ragged_d300", 100, 7001, 300, True)]
    rows = [check_flash_case(torch, name, B, C, D, seed=i, timed=timed)
            for i, (name, B, C, D, timed) in enumerate(cases)]
    rows.append(check_flash_case(torch, "saturated", 4, 300, 256, seed=9, saturated=True,
                                 timed=False))
    bwd_cases = [("train_b256", TRAIN_B, SPK, 256, True), ("path_b1024", 1024, SPK, 256, True),
                 ("scale_c131072", 256, 131072, 256, True), ("ragged", 100, 7001, 256, True),
                 ("train_b256_d512", TRAIN_B, SPK, 512, True),
                 ("ragged_d300", 100, 7001, 300, True)]
    bwd_rows = [check_flash_bwd_case(torch, name, B, C, D, seed=20 + i, timed=timed,
                                     repeat=(i in (0, 4)))
                for i, (name, B, C, D, timed) in enumerate(bwd_cases)]
    bwd_rows.append(check_flash_bwd_case(torch, "saturated", 4, 300, 256, seed=29,
                                         saturated=True, timed=False))
    for name, D, seed in (("confident", 256, 30), ("confident_d512", 512, 32)):
        bwd_rows.append(check_flash_bwd_case(torch, name, TRAIN_B, SPK, D, seed=seed,
                                             timed=False, confident=True))
    bwd_rows.append(check_flash_bwd_case(torch, "ragged_depth", 100, 7001, 37, seed=31,
                                         timed=False))
    for i, (B, D) in enumerate(((256, 256), (100, 37), (256, 512), (100, 300))):
        for exact in (True, False):
            check_consistency(torch, B, D, seed=40 + i, exact=exact)
    check_wide_train(torch, smi_line)
    return rows, bwd_rows


WIDE_B = 128


def check_wide_train(torch, smi_line):
    """A 512-wide embedding (SpeakerModel(emb_dim=512), D = 512: the chunked
    kernels): one flash step and one dense step from the same weights agree
    (flash_dense_agree)."""
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.train import cosine_epoch_lr, make_train_step

    dev = torch.device("cuda")
    torch.manual_seed(3)
    model = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34", emb_dim=512,
                         dtype=torch.bfloat16, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((WIDE_B, 40, TRAIN_T), generator=gen, device=dev)
    y = torch.randint(0, SPK, (WIDE_B,), generator=gen, device=dev)
    agree = flash_dense_agree(torch, model, init, make_train_step(model, flash_aam=True),
                              make_train_step(model), x, y, cosine_epoch_lr(0.1, 10)(0))
    emit({"phase": "kernel", "kernel": "train_step", "case": "emb_dim_512", "B": WIDE_B,
          "C": SPK, "D": 512, "agree": agree, "card": smi_line})


def phase_slice(torch, smi_line):
    from pkr_tpu_torch.eval import compute_eer, cosine_scores, extract_embeddings
    from pkr_tpu_torch.frontend import wav_to_train_feats
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.train import make_eval_step

    dev = torch.device("cuda")
    wavs, freqs = make_wavs(BATCH)
    lengths = np.full((BATCH,), N_SAMPLES, np.int64)
    torch.manual_seed(0)
    model = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34",
                         dtype=torch.bfloat16, device=dev)
    labels = np.random.default_rng(1).integers(0, SPK, BATCH)
    keys = [f"utt{i:03d}" for i in range(BATCH)]
    eval_flash = make_eval_step(model, flash_aam=True)
    eval_dense = make_eval_step(model, flash_aam=False)
    torch.cuda.reset_peak_memory_stats()

    # --- the main path, with every kernel count at 0 just before it ---
    fa.flash_aam_fwd.launches = 0
    t0 = time.perf_counter()
    feats, mask, vad = wav_to_train_feats(wavs, lengths,
                                          torch.Generator(device=dev).manual_seed(0))
    x = feats.permute(0, 2, 1).contiguous()  # (B, F, T)
    half = BATCH // 2
    emb = extract_embeddings(model, [(keys[:half], x[:half], mask[:half]),
                                     (keys[half:], x[half:], mask[half:])])
    ev = eval_flash(x, labels)
    enroll = {k: emb[k] for k in keys[:16]}
    test = {k: emb[k] for k in keys[16:32]}
    trials = [(a, b) for a in enroll for b in test]
    trial_labels = [int(abs(freqs[int(a[3:])] - freqs[int(b[3:])]) < 20.0)
                    for a, b in trials]
    scores = cosine_scores(enroll, test, trials, np.mean(np.stack(list(emb.values())), 0))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches}
    # --- end of the main path ---

    check(0 < sum(trial_labels) < len(trial_labels), "trials need both labels")
    eer = compute_eer(scores, trial_labels)
    check(launches["flash_aam_fwd"] > 0, "the slice never launched flash_aam_fwd")
    T = feats.shape[1]
    check(tuple(feats.shape) == (BATCH, T, 40) and tuple(mask.shape) == (BATCH, T),
          f"feature shapes {tuple(feats.shape)}, {tuple(mask.shape)}")
    check(bool(torch.isfinite(feats).all()), "non-finite features")
    check(0 < int(mask.sum()) <= BATCH * T, "the VAD kept no frame")
    E = np.stack([emb[k] for k in keys])
    check(E.shape == (BATCH, 256) and np.isfinite(E).all(), "embeddings")
    check(all(np.isfinite(float(v)) for v in ev.values()), f"eval step {ev}")
    check(np.isfinite(scores).all() and 0.0 <= eer <= 1.0, f"scores / EER {eer}")

    dense = eval_dense(x, labels)
    loss_gap = abs(float(ev["loss"]) - float(dense["loss"])) / BATCH
    check(loss_gap <= 2e-4, f"flash eval loss {float(ev['loss'])} vs dense "
                            f"{float(dense['loss'])}")

    # f32 on the card (TF32 off) against the port on the CPU, two utterances
    state = model.state_dict()
    m_gpu = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34",
                         dtype=torch.float32, device=dev)
    m_cpu = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34",
                         dtype=torch.float32, device="cpu")
    m_gpu.load_state_dict(state)
    m_cpu.load_state_dict(state)
    f_gpu, k_gpu, _ = wav_to_train_feats(wavs[:2], lengths[:2])
    f_cpu, k_cpu, _ = wav_to_train_feats(wavs[:2], lengths[:2], device="cpu")
    feat_err = float((f_gpu.cpu() - f_cpu).abs().max())
    check(feat_err <= 2e-4 * max(1.0, float(f_cpu.abs().max())) and
          torch.equal(k_gpu.cpu(), k_cpu), f"frontend card vs CPU {feat_err}")
    with torch.no_grad():
        e_gpu = m_gpu.embed(x[:2].float(), mask[:2]).cpu()
        e_cpu = m_cpu.embed(x[:2].float().cpu(), mask[:2].cpu())
    emb_rel = float((e_gpu - e_cpu).abs().max() / e_cpu.abs().max())
    check(emb_rel <= 1e-3, f"f32 embedding card vs CPU: rel err {emb_rel}")

    # throughput of wav → embedding with the bf16 trunk
    def wav_to_emb():
        f, m, _ = wav_to_train_feats(wavs, lengths, torch.Generator(device=dev).manual_seed(1))
        with torch.no_grad():
            return model.embed(f.permute(0, 2, 1), m)

    wav_to_emb()
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        t1 = time.perf_counter()
        for _ in range(3):
            out = wav_to_emb()
        out.cpu()
        rates.append(3 * BATCH / (time.perf_counter() - t1))
    emit({"phase": "slice", "batch": BATCH, "frames": T, "voiced_frames": int(mask.sum()),
          "launches": launches, "path_seconds_first_call": path_s,
          "eval_flash": {k: float(v) for k, v in ev.items()},
          "eval_dense": {k: float(v) for k, v in dense.items()},
          "flash_vs_dense_loss_gap": loss_gap, "eer": eer, "n_trials": len(trials),
          "feats_card_vs_cpu_max_abs": feat_err, "emb_f32_card_vs_cpu_rel": emb_rel,
          "wav_to_emb_per_s_bf16": rates, "wav_to_emb_per_s_median": float(np.median(rates)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "card": smi_line})
    # where the device time goes: each stage traced on its own, beside its
    # wall time per call; busy = device / wall
    stages = {}
    for tag, fn in (("frontend", lambda: wav_to_train_feats(
                        wavs, lengths, torch.Generator(device=dev).manual_seed(1))),
                    ("embed_bf16", lambda: model.embed(x, mask)),
                    ("eval_step_flash", lambda: eval_flash(x, labels))):
        with torch.no_grad():
            dev_ms, n_act, top = device_ms(torch, fn, 2)
            wall = call_ms(torch, fn, 3, warmup=1)
        stages[tag] = {"device_ms": dev_ms, "wall_ms": wall, "activities": n_act,
                       "busy": None if dev_ms is None else dev_ms / wall, "top": top}
    emit({"phase": "profile", "batch": BATCH, "stages": stages, "card": smi_line})

    return launches


class _Loader:
    """Duck-typed loader for train_and_validate: the same batches each epoch."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return iter(self.batches)


def _median_step_ms(torch, step, state, x, y, lr, windows=3, steps=4):
    """Median over `windows` of the mean wall ms per step of `steps` back-to-back
    train steps, ended by a synchronize."""
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, x, y, lr)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / steps)
    return float(np.median(times)), times, m


def flash_dense_agree(torch, model, init, flash_step, dense_step, x, y, lr):
    """One flash step and one dense step from the same weights agree: the
    losses within 2e-4, and the head's gradients, compared on one embedding
    batch (cuDNN's backward is not deterministic, so trunk parameters are
    not compared bit for bit), each row within ROW_TOL of its own norm, with
    planted faults the row check must reject."""
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.ops.aam import aam_logits
    from pkr_tpu_torch.train import create_train_state, cross_entropy

    agree = {}
    for tag, step in (("flash", flash_step), ("dense", dense_step)):
        model.load_state_dict(init)
        _, m = step(create_train_state(model), x, y, lr)
        agree[f"{tag}_loss"] = float(m["loss"])
    check(abs(agree["flash_loss"] - agree["dense_loss"]) <= 2e-4,
          f"flash vs dense step loss {agree}")
    model.load_state_dict(init)
    model.train()
    with torch.no_grad():
        emb = model.head_input(x)
    grads = {}
    for tag in ("flash", "dense"):
        e = emb.detach().clone().requires_grad_(True)
        w = model.last.weight.detach().clone().requires_grad_(True)
        if tag == "flash":
            loss = fa.flash_aam_loss(e, w, y, model.m, model.s)
        else:
            loss = cross_entropy(aam_logits(e, w, y, model.m, model.s), y)
        grads[tag] = torch.autograd.grad(loss, (e, w))
    for i, tag in enumerate(("emb", "last_weight")):
        got, ref = grads["flash"][i], grads["dense"][i]
        rel = row_rel_err(torch, got, ref)
        agree[f"{tag}_grad_row_rel"] = rel
        agree[f"{tag}_grad_max_rel"] = float((got - ref).abs().max() / ref.abs().max())
        check(rel <= ROW_TOL, f"flash vs dense {tag} gradient: row error {rel}")
        faults = planted_faults(torch, got, ref, y if tag == "last_weight" else None)
        agree[f"{tag}_planted"] = {k: v[0] for k, v in faults.items()}
        for k, (f_rel, _) in faults.items():
            check(f_rel > ROW_TOL, f"the row check missed the planted {tag} fault {k}")
    return agree


def phase_train(torch, smi_line):
    import io

    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.train import (cosine_epoch_lr, create_train_state, make_train_step,
                                     train_and_validate)
    from pkr_tpu_torch.utils import ProgressLogger

    dev = torch.device("cuda")
    torch.manual_seed(1)
    model = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34",
                         dtype=torch.bfloat16, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((TRAIN_B, 40, TRAIN_T), generator=gen, device=dev)
    y = torch.randint(0, SPK, (TRAIN_B,), generator=gen, device=dev)
    x_cv = torch.randn((TRAIN_B, 40, TRAIN_T), generator=gen, device=dev)
    lr = cosine_epoch_lr(0.1, 10)(0)
    flash_step = make_train_step(model, flash_aam=True)
    dense_step = make_train_step(model)
    torch.cuda.reset_peak_memory_stats()

    # --- the main path, with every kernel count at 0 just before it ---
    fa.flash_aam_fwd.launches = 0
    fa.flash_aam_bwd.launches = 0
    t0 = time.perf_counter()
    state = create_train_state(model)
    flash_losses = []
    for _ in range(10):  # one fixed batch: the loss must fall
        state, m = flash_step(state, x, y, lr)
        flash_losses.append(m["loss"])
    dense_losses = []
    for _ in range(3):
        state, m = dense_step(state, x, y, lr)
        dense_losses.append(m["loss"])
    epochs = []
    state = train_and_validate(
        model, state, _Loader([(x, y)] * 3), _Loader([(x_cv, y)]), epochs=1, lr0=lr,
        flash_aam=True, logger=ProgressLogger(io.StringIO()),
        on_epoch_end=lambda s, e, mt: epochs.append(mt))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                "flash_aam_bwd": fa.flash_aam_bwd.launches}
    # --- end of the main path ---

    flash_losses = [float(v) for v in flash_losses]
    dense_losses = [float(v) for v in dense_losses]
    check(np.isfinite(flash_losses + dense_losses).all(),
          f"non-finite train loss {flash_losses} {dense_losses}")
    check(flash_losses[-1] < flash_losses[0], f"the loss did not fall: {flash_losses}")
    check(launches["flash_aam_bwd"] > 0, "the flash train path never launched flash_aam_bwd")
    check(launches["flash_aam_fwd"] > 0, "the flash train path never launched flash_aam_fwd")
    check(int(state.step) == 16 and state.epoch == 1, f"step {int(state.step)}, "
                                                      f"epoch {state.epoch}")
    check(len(epochs) == 1 and np.isfinite(epochs[0]["loss"]), f"cv {epochs}")

    agree = flash_dense_agree(torch, model, init, flash_step, dense_step, x, y, lr)

    # throughput: median of a few windows per head
    flops = resnet34_train_flops(TRAIN_B, 40, TRAIN_T)
    speed = {}
    for tag, step in (("flash", flash_step), ("dense", dense_step)):
        model.load_state_dict(init)
        st = create_train_state(model)
        st, _ = step(st, x, y, lr)  # warm-up
        ms, windows, _ = _median_step_ms(torch, step, st, x, y, lr)
        speed[tag] = {"ms_per_step": ms, "window_ms": windows,
                      "examples_per_s": TRAIN_B * 1e3 / ms,
                      "conv_mfu_bf16": flops / (ms * 1e-3) / PEAK_BF16_FLOPS}
    emit({"phase": "train", "batch": TRAIN_B, "frames": TRAIN_T, "spk": SPK,
          "launches": launches, "path_seconds_first_call": path_s,
          "flash_losses": flash_losses, "dense_losses": dense_losses, "cv": epochs[0],
          "agree": agree, "speed": speed, "conv_flops_per_step": flops,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "card": smi_line})

    stages = {}
    for tag, step in (("train_step_flash", flash_step), ("train_step_dense", dense_step)):
        model.load_state_dict(init)
        st = create_train_state(model)
        dev_ms, n_act, top = device_ms(torch, lambda: step(st, x, y, lr), 2)
        wall = call_ms(torch, lambda: step(st, x, y, lr), 3, warmup=1)
        head = device_ms(torch, lambda: step(st, x, y, lr), 2,
                         only=BWD_KERNELS + FWD_KERNELS)[0]
        stages[tag] = {"device_ms": dev_ms, "wall_ms": wall, "activities": n_act,
                       "busy": None if dev_ms is None else dev_ms / wall,
                       "flash_kernels_ms": head, "top": top}
    emit({"phase": "train_profile", "batch": TRAIN_B, "stages": stages, "card": smi_line})
    return launches


CORPUS_UTTS_PER_SPK = 2
CORPUS_CV = 512       # utterances in the cv split (train_cv_split, by utterance)
EXTRACT_SPK = 256     # speakers whose utterances are extracted and scored
WINDOW = 8            # steps per timing window (train_and_validate's print_freq)


def write_corpus(root, seed=0, n_spk=SPK, per_spk=CORPUS_UTTS_PER_SPK, prefix="spk",
                 split=True):
    """A synthetic Kaldi data dir under `root`: n_spk speakers × per_spk
    utterances of 250–450 frames (every 97th one 120–199, shorter than the
    crop) of 40 log-mel-like values (a speaker's envelope, a channel offset
    per utterance, frame noise), as CM-compressed feats.ark/feats.scp,
    utt2spk, spk2utt, utt2num_frames and utt2spkid (the recipe's data prep:
    assign_spk_ids, train_cv_split); with `split`, `train` and `cv`
    subdirectories hold the split.  Returns (DataDir of everything, number
    of frames)."""
    from pkr_tpu_torch.io import DataDir, kaldi_ark

    rng = np.random.default_rng(seed)
    envelope = rng.uniform(4.0, 14.0, (n_spk, 40)).astype(np.float32)
    utt2spk, utt2nf, frames = {}, {}, 0
    with kaldi_ark.write_ark_scp(os.path.join(root, "feats.ark"),
                                 os.path.join(root, "feats.scp"), compress=True) as w:
        for s in range(n_spk):
            for j in range(per_spk):
                key = f"{prefix}{s:04d}-u{j}"
                n = len(utt2spk)
                rows = int(rng.integers(120, 200) if n % 97 == 5 else rng.integers(250, 451))
                mat = (envelope[s] + rng.normal(0.0, 1.0, 40).astype(np.float32)
                       + 1.5 * rng.standard_normal((rows, 40), dtype=np.float32))
                w.write(key, mat)
                utt2spk[key] = f"{prefix}{s:04d}"
                utt2nf[key] = str(rows)
                frames += rows
    scp = {k: v for k, v in (ln.split(None, 1) for ln in
                             open(os.path.join(root, "feats.scp")).read().splitlines())}
    data, got_spk = DataDir({"utt2spk": utt2spk, "feats.scp": scp,
                             "utt2num_frames": utt2nf}).make_spk2utt().assign_spk_ids()
    check(got_spk == n_spk, f"{got_spk} speakers")
    data.save(root)
    if split:
        train, cv = data.train_cv_split(CORPUS_CV / len(utt2spk), seed=seed)
        train.save(os.path.join(root, "train"))
        cv.save(os.path.join(root, "cv"))
    return data, frames


class _Records:
    """A ProgressLogger stand-in that keeps every record with its host time:
    train_and_validate logs after a synchronize every print_freq steps."""

    def __init__(self):
        self.records = []

    def log(self, msg, **metrics):
        self.records.append((time.perf_counter(), metrics))


class _TimedLoader:
    """Wraps a loader: counts its batches and stamps the epoch's start."""

    def __init__(self, loader):
        self.loader = loader
        self.t0 = None

    def epoch(self, epoch):
        self.t0 = time.perf_counter()
        yield from self.loader.epoch(epoch)


def _train_epoch(torch, model, state, loader, cv_loader, lr):
    """One epoch of train_and_validate(flash_aam=True); returns (state, row):
    steps, ms/step (median over WINDOW-step windows, the first one, which
    holds the loader's start and cuDNN's first calls, left out) and the
    logged train and cv losses."""
    from pkr_tpu_torch.train import train_and_validate

    rec, cv = _Records(), []
    timed = _TimedLoader(loader)
    step0 = int(state.step)
    state = train_and_validate(model, state, timed, cv_loader, epochs=1, lr0=lr,
                               flash_aam=True, logger=rec, print_freq=WINDOW,
                               on_epoch_end=lambda s, e, mt: cv.append(mt))
    torch.cuda.synchronize()
    stamps = [timed.t0] + [t for t, m in rec.records if "step" in m]
    windows = [1e3 * (b - a) / WINDOW for a, b in zip(stamps, stamps[1:])]
    steps = int(state.step) - step0
    losses = [m["loss"] for _, m in rec.records if "step" in m]
    check(steps == loader.batches_per_epoch() and steps >= 3 * WINDOW,
          f"the epoch took {steps} steps, the loader has {loader.batches_per_epoch()}")
    check(len(cv) == 1 and np.isfinite(losses + [cv[0]["loss"]]).all(),
          f"non-finite losses: train {losses}, cv {cv}")
    ms = float(np.median(windows[1:]))
    return state, {"steps": steps, "ms_per_step": ms, "window_ms": windows,
                   "examples_per_s": TRAIN_B * 1e3 / ms, "train_losses": losses,
                   "cv": cv[0]}


def _crops_per_s(torch, loader):
    """Crops/s of the loader alone over one epoch (no training)."""
    t0 = time.perf_counter()
    n = 0
    for x, _ in loader.epoch(0):
        n += x.shape[0]
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def _reader_us(src, n=200):
    """Mean µs per call of the native ark reader over the first n
    utterances of `src`: the header alone (open, seek, read: mat_dims), a
    TRAIN_T-frame crop (read_crop_t: the same and the crop's decode), and
    the same crop cut from the decoded matrix already in memory."""
    from pkr_tpu_torch.io import native

    specs = src._split[:n]
    n = len(specs)
    out = {}
    t0 = time.perf_counter()
    for path, off in specs:
        native.mat_dims(path, off)
    out["header"] = 1e6 * (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for path, off in specs:
        native.read_crop_t(path, off, 0, TRAIN_T, 40)
    out["crop"] = 1e6 * (time.perf_counter() - t0) / n
    mats = [native.read_mat(path, off) for path, off in specs]
    t0 = time.perf_counter()
    for m in mats:
        np.ascontiguousarray(m[:TRAIN_T].T)
    out["crop_in_memory"] = 1e6 * (time.perf_counter() - t0) / n
    return out


def numpy_dequantize(codes, pct):
    """data/device_cache.dequantize's formula, evaluated by numpy in f32."""
    c = codes.astype(np.float32)
    p0, p25, p75, p100 = (pct[..., k:k + 1, :] for k in range(4))
    low = p0 + (p25 - p0) * (c * np.float32(1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - np.float32(64.0)) * np.float32(1.0 / 128.0))
    high = p75 + (p100 - p75) * ((c - np.float32(192.0)) * np.float32(1.0 / 63.0))
    return np.where(c <= 64.0, low, np.where(c <= 192.0, mid, high))


def check_cache_crops(torch, cache, source, ids):
    """A device-cache batch at given draws against (a) a numpy decode of
    the same rows of the cache's own codes, bit for bit, and (b) the host
    reader's crops at the same starts, within the CM round-trip bound of
    tests/test_device_cache.py (per column: its range / 50 + 1e-3; the
    cache re-quantizes the decoded arks)."""
    from pkr_tpu_torch.data import device_cache as dc

    dev = cache.codes.device
    u = torch.rand((len(ids),), generator=torch.Generator(device=dev).manual_seed(9),
                   device=dev)
    feats, _ = cache.sample_batch(ids, u, TRAIN_T)
    idx = dc._crop_index(cache.offsets, cache.rows, torch.as_tensor(ids, device=dev), u,
                         TRAIN_T).cpu().numpy()
    want = numpy_dequantize(cache.codes.cpu().numpy()[idx], cache.pct.cpu().numpy()[ids])
    got = feats.cpu().numpy()
    check(np.array_equal(got, want.transpose(0, 2, 1)),
          "a device-cache batch differs from the numpy decode of its own rows")
    offsets = cache.offsets.cpu().numpy()
    worst, excess = 0.0, -np.inf
    for b, i in enumerate(ids):
        host = source.read_crop_t(int(i), int(idx[b, 0] - offsets[i]), TRAIN_T)
        full = source.read(int(i))
        bound = (full.max(axis=0) - full.min(axis=0)) / 50 + 1e-3
        err = np.abs(got[b] - host).max(axis=1)
        worst = max(worst, float(err.max()))
        excess = max(excess, float((err - bound).max()))
    check(excess <= 0.0, f"device-cache crops off the host reader's by more than the CM "
                         f"bound (worst {worst})")
    return {"bit_equal_numpy_decode": True, "max_abs_err_vs_host_reader": worst,
            "short_crops": int(sum(cache.rows.cpu().numpy()[ids] < TRAIN_T))}


def phase_corpus(torch, smi_line):
    import tempfile

    from pkr_tpu_torch.data import (BalancedRepetitionSampler, DeviceCacheLoader,
                                    DeviceFeatureCache, EvalLoader, FeatureSource, TrainLoader)
    from pkr_tpu_torch.eval import compute_eer, cosine_scores, extract_embeddings
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.train import create_train_state

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="pkr_corpus_") as root:
        t0 = time.perf_counter()
        data, frames = write_corpus(root)
        write_s = time.perf_counter() - t0
        train_dir = DataDir.load(os.path.join(root, "train"))
        cv_dir = DataDir.load(os.path.join(root, "cv"))
        utt2spkid = {u: int(v) for u, v in data["utt2spkid"].items()}
        src = FeatureSource(os.path.join(root, "train", "feats.scp"))
        check(src._native is not None, "the native ark reader did not build or load")
        labels = [utt2spkid[u] for u in src.utts]
        cv_src = FeatureSource(os.path.join(root, "cv", "feats.scp"))
        cv_labels = [utt2spkid[u] for u in cv_src.utts]
        host_loader = TrainLoader(src, labels, BalancedRepetitionSampler(src.utts, labels),
                                  TRAIN_B, chunk=TRAIN_T, seed=0)
        cv_loader = TrainLoader(cv_src, cv_labels,
                                BalancedRepetitionSampler(cv_src.utts, cv_labels), TRAIN_B,
                                chunk=TRAIN_T, seed=0)
        ex_utts = [f"spk{s:04d}-u{j}" for s in range(EXTRACT_SPK)
                   for j in range(CORPUS_UTTS_PER_SPK)]
        DataDir({"feats.scp": {u: data["feats.scp"][u] for u in ex_utts}}).save(
            os.path.join(root, "extract"))
        ex_src = FeatureSource(os.path.join(root, "extract", "feats.scp"))
        torch.manual_seed(5)
        model = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34",
                             dtype=torch.bfloat16, device=dev)
        lr = 0.05

        # --- the main path, with every kernel count at 0 just before it ---
        fa.flash_aam_fwd.launches = 0
        fa.flash_aam_bwd.launches = 0
        t0 = time.perf_counter()
        state = create_train_state(model)
        state, host_row = _train_epoch(torch, model, state, host_loader, cv_loader, lr)
        t1 = time.perf_counter()
        cache = DeviceFeatureCache.from_scp(os.path.join(root, "train", "feats.scp"),
                                            utt2spkid)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        cache_loader = DeviceCacheLoader(cache, BalancedRepetitionSampler(
            cache.utts, [utt2spkid[u] for u in cache.utts]), TRAIN_B, chunk=TRAIN_T, seed=0)
        state, cache_row = _train_epoch(torch, model, state, cache_loader, cv_loader, lr)
        t2 = time.perf_counter()
        ex_batches = list(EvalLoader(ex_src, batch_size=64, transport="auto"))
        emb = extract_embeddings(model, ex_batches)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t2
        path_s = time.perf_counter() - t0
        launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                    "flash_aam_bwd": fa.flash_aam_bwd.launches}
        # --- end of the main path ---

        check(launches["flash_aam_fwd"] > 0 and launches["flash_aam_bwd"] > 0,
              f"the corpus path launched {launches}")
        check(src.utts == cache.utts, "the cache's utterance order is not the scp's")
        rng = np.random.default_rng(1)
        crops = check_cache_crops(torch, cache, src,
                                  rng.choice(len(src.utts), TRAIN_B, replace=False))

        # extraction: the quantized transport against the f32 one, f32 model
        check(all(isinstance(p, tuple) for _, p, _ in ex_batches),
              "the quantized transport was not taken")
        f32_batches = list(EvalLoader(ex_src, batch_size=64, transport="f32"))
        code_bytes = sum(p[0].nbytes for _, p, _ in ex_batches)
        table_bytes = sum(p[1].nbytes for _, p, _ in ex_batches)
        f32_bytes = sum(p.nbytes for _, p, _ in f32_batches)
        check(4 * code_bytes == f32_bytes, f"codes {code_bytes} B vs f32 {f32_bytes} B")
        m32 = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34",
                           dtype=torch.float32, device=dev)
        m32.load_state_dict(model.state_dict())
        e_q = extract_embeddings(m32, ex_batches)
        e_f = extract_embeddings(m32, f32_batches)
        check(sorted(e_q) == sorted(e_f) == sorted(ex_utts), "extracted keys")
        q_rel = max(float(np.abs(e_q[k] - e_f[k]).max() / np.abs(e_f[k]).max()) for k in e_f)
        check(q_rel <= 1e-4, f"quantized vs f32 extraction: relative error {q_rel}")

        # trials drawn from the corpus: each speaker's two utterances, and
        # as many pairs of different speakers
        E = np.stack([emb[u] for u in ex_utts])
        check(E.shape == (len(ex_utts), 256) and np.isfinite(E).all(), "embeddings")
        enroll = {u: emb[u] for u in ex_utts[0::2]}
        test = {u: emb[u] for u in ex_utts[1::2]}
        targets = [(f"spk{s:04d}-u0", f"spk{s:04d}-u1") for s in range(EXTRACT_SPK)]
        other = rng.permutation(EXTRACT_SPK)
        nontargets = [(f"spk{s:04d}-u0", f"spk{o:04d}-u1") for s, o in enumerate(other)
                      if o != s]
        trials = targets + nontargets
        scores = cosine_scores(enroll, test, trials, E.mean(axis=0))
        eer = compute_eer(scores, [1] * len(targets) + [0] * len(nontargets))
        check(np.isfinite(scores).all() and 0.0 <= eer <= 1.0, f"EER {eer}")

        host_rate = _crops_per_s(torch, host_loader)
        reader_us = _reader_us(src)
        cache_rate = _crops_per_s(torch, cache_loader)
        batch_bytes = TRAIN_B * 40 * TRAIN_T * 4 + TRAIN_B * 8
        emit({"phase": "corpus", "speakers": SPK, "utterances": len(data["utt2spk"]),
              "train_utterances": len(train_dir.utts), "cv_utterances": len(cv_dir.utts),
              "frames": frames, "ark_bytes": os.path.getsize(os.path.join(root, "feats.ark")),
              "write_seconds": write_s, "native_reader": True, "launches": launches,
              "path_seconds": path_s,
              "host_loader": {"crops_per_s": host_rate, "reader_us": reader_us, **host_row,
                              "bytes_to_card_per_batch": batch_bytes,
                              "bytes_to_card_epoch": batch_bytes * host_row["steps"]},
              "device_cache": {"crops_per_s": cache_rate, **cache_row,
                               "build_seconds": build_s, "cache_bytes": cache.nbytes,
                               "bytes_to_card_setup": cache.nbytes,
                               "bytes_to_card_per_batch": TRAIN_B * 8,
                               "crop_check": crops},
              "extraction": {"utterances": len(ex_utts), "seconds": extract_s,
                             "utterances_per_s": len(ex_utts) / extract_s,
                             "code_bytes": code_bytes, "table_bytes": table_bytes,
                             "f32_feature_bytes": f32_bytes,
                             "quantized_vs_f32_rel": q_rel, "eer": eer,
                             "n_trials": len(trials)},
              "card": smi_line})
    return launches


RECIPE_WAVS = 512       # stage 1's synthetic 6-s wavs
RECIPE_WAV_SPK = 128
TEST_SPK = 256          # the test side: other speakers, 4 utterances each
TEST_UTTS = 4
TRIAL_TEST_SPK = 26     # speakers whose u1–u3 are trial test sides (~20k trials)
COHORT_SUBSET = 2048
RECIPE_PRINT_FREQ = 8


class _Stamped:
    """A stdout stand-in for the recipe's prints: keeps every line with the
    host time it was written at."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, text):
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def flush(self):
        pass


def _run_main(argv, log):
    """recipes.run.main(argv) with its prints kept in `log` (a _Stamped);
    returns the stage durations in s, by stage, from the stage headers."""
    import contextlib

    from pkr_tpu_torch.recipes.run import main as recipe_main

    start = len(log.lines)
    with contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        rc = recipe_main(argv)
        t_end = time.perf_counter()
    check(rc == 0, f"main({argv}) returned {rc}")
    heads = [(t, int(line.split()[2].rstrip(":"))) for t, line in log.lines[start:]
             if line.startswith("== stage ")]
    marks = [t for t, _ in heads] + [t_end]
    stages = {}
    for (t, stage), nxt in zip(heads, marks[1:]):
        stages[stage] = stages.get(stage, 0.0) + (nxt - t)
    stages["total"] = t_end - t0
    return stages


def _jsonl(path):
    return [json.loads(line) for line in open(path)] if os.path.exists(path) else []


def _train_speed(records):
    """ms/step and examples/s of one run from its step records (logged after a
    synchronize every RECIPE_PRINT_FREQ steps): the median of the windows
    between records, the first window (cuDNN's first calls) left out."""
    stamps = [r["t"] for r in records if "step" in r]
    windows = [1e3 * (b - a) / RECIPE_PRINT_FREQ for a, b in zip(stamps, stamps[1:])]
    check(len(windows) >= 2, f"too few step records to time: {len(stamps)}")
    ms = float(np.median(windows))
    return {"ms_per_step": ms, "window_ms": windows, "examples_per_s": TRAIN_B * 1e3 / ms,
            "steps_logged": [r["step"] for r in records if "step" in r]}


def _check_scores(exp, n_trials, backend):
    rows = [line.split() for line in open(os.path.join(exp, "scores.txt"))]
    check(len(rows) == n_trials and all(len(r) == 3 for r in rows),
          f"{backend}: scores.txt has {len(rows)} rows for {n_trials} trials")
    scores = np.array([float(r[2]) for r in rows])
    check(np.isfinite(scores).all(), f"{backend}: non-finite scores")
    res = json.load(open(os.path.join(exp, "results.json")))
    vals = [res["eer"], res["min_dcf_p0.01"], res["min_dcf_p0.001"]]
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals),
          f"{backend}: results {res}")
    return res


def phase_recipe(torch, smi_line):
    """The recipe CLI, python -m pkr_tpu_torch.recipes.run, through its main
    on the card (no --device: the default is the card).  The recipe's own
    prints are kept, and written to stderr if the phase fails."""
    import tempfile

    log = _Stamped()
    with tempfile.TemporaryDirectory(prefix="pkr_recipe_") as root:
        try:
            return _recipe_runs(torch, smi_line, root, log)
        except BaseException:
            sys.stderr.write("\n".join(line for _, line in log.lines[-200:]) + "\n")
            raise


def _recipe_runs(torch, smi_line, root, log):
    import dataclasses

    from pkr_tpu_torch.eval.scoring import cohort_topk_stats
    from pkr_tpu_torch.io import DataDir, kaldi_ark, load_text_vec_ark
    from pkr_tpu_torch.io.wav import write_wav
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.recipes import voxceleb
    from pkr_tpu_torch.recipes.presets import PRESETS
    from pkr_tpu_torch.recipes.run import build_model
    from pkr_tpu_torch.train import restore_checkpoint, save_checkpoint

    dev = torch.device("cuda")
    j = os.path.join
    # --- inputs, made before the main path ---
    wav_root = j(root, "wavs")
    os.makedirs(wav_root)
    wavs, _ = make_wavs(RECIPE_WAVS, seed=3)
    utt2spk, wav_scp = {}, {}
    for i in range(RECIPE_WAVS):
        spk = f"w{i % RECIPE_WAV_SPK:03d}"
        utt = f"{spk}-{i // RECIPE_WAV_SPK}"
        path = j(wav_root, f"{utt}.wav")
        write_wav(path, wavs[i])
        utt2spk[utt], wav_scp[utt] = spk, path
    del wavs
    wav_data = j(root, "wav_data")
    DataDir({"utt2spk": utt2spk, "wav.scp": wav_scp}).make_spk2utt().save(wav_data)

    corpus = j(root, "corpus")
    os.makedirs(corpus)
    t0 = time.perf_counter()
    data, frames = write_corpus(corpus, split=False)
    test_corpus = j(root, "test_corpus")
    os.makedirs(test_corpus)
    test, _ = write_corpus(test_corpus, seed=7, n_spk=TEST_SPK, per_spk=TEST_UTTS,
                           prefix="tst", split=False)
    write_s = time.perf_counter() - t0
    # the layout stage 1 would have left: feats.scp + utt2num_frames under
    # <exp>/feats (and feats_test), utt2spk in the data dirs
    data_dir, test_dir = j(root, "data"), j(root, "data_test")
    DataDir({"utt2spk": data["utt2spk"]}).make_spk2utt().save(data_dir)
    DataDir({"utt2spk": test["utt2spk"]}).make_spk2utt().save(test_dir)
    exp_sm, exp_aam = j(root, "exp_softmax"), j(root, "exp_aam")
    for exp in (exp_sm, exp_aam):
        DataDir({"feats.scp": data["feats.scp"],
                 "utt2num_frames": data["utt2num_frames"]}).save(j(exp, "feats"))
    DataDir({"feats.scp": test["feats.scp"]}).save(j(exp_aam, "feats_test"))
    # trials: make_trials' full cross of the enroll speakers (each one's u0)
    # and the u1–u3 of TRIAL_TEST_SPK speakers; the enroll key is the u0
    t_u2s = test["utt2spk"]
    enroll = DataDir({"utt2spk": {u: s for u, s in t_u2s.items() if u.endswith("-u0")}})
    probe = DataDir({"utt2spk": {u: s for u, s in t_u2s.items() if not u.endswith("-u0")
                                 and int(s[3:]) < TRIAL_TEST_SPK}})
    trials = [(f"{e}-u0", t, lab) for e, t, lab in
              voxceleb.make_trials(enroll, probe, "rude")]
    trials_path = j(root, "trials")
    voxceleb.write_trials(trials_path, trials)
    n_target = sum(lab == "target" for _, _, lab in trials)
    check(0 < n_target < len(trials), f"{n_target} targets in {len(trials)} trials")

    sm = PRESETS["softmax_plda"]()
    sm = dataclasses.replace(sm, train=dataclasses.replace(
        sm.train, epochs=1, batch_size=TRAIN_B, device_cache=True,
        print_freq=RECIPE_PRINT_FREQ))
    aam = PRESETS["aam_v2"]()
    aam = dataclasses.replace(
        aam, train=dataclasses.replace(aam.train, epochs=1, batch_size=TRAIN_B,
                                       device_cache=True, flash_aam=True,
                                       pretrained=j(exp_sm, "checkpoints"),
                                       print_freq=RECIPE_PRINT_FREQ),
        eval=dataclasses.replace(aam.eval, cohort_subset=COHORT_SUBSET))
    resume = dataclasses.replace(aam, train=dataclasses.replace(aam.train, epochs=2,
                                                                resume=True))
    cfgs = {}
    for name, cfg in (("softmax", sm), ("aam", aam), ("resume", resume)):
        cfgs[name] = j(root, f"{name}.json")
        with open(cfgs[name], "w") as f:
            f.write(cfg.to_json())
    common = ["--data-dir", data_dir, "--test-data-dir", test_dir, "--trials", trials_path]
    jsonl_sm, jsonl_aam = j(exp_sm, "train_metrics.jsonl"), j(exp_aam, "train_metrics.jsonl")

    # --- the main path, with every kernel count at 0 just before it ---
    fa.flash_aam_fwd.launches = 0
    fa.flash_aam_bwd.launches = 0
    t_path = time.perf_counter()
    st1 = _run_main(["--preset", "aam_v2", "--stage", "0", "--stop-stage", "1",
                     "--data-dir", wav_data, "--exp-dir", j(root, "exp_wav")], log)
    st_sm = _run_main(["--config", cfgs["softmax"], "--stage", "2", "--stop-stage", "3",
                       "--exp-dir", exp_sm] + common, log)
    n_sm = len(_jsonl(jsonl_sm))
    st_aam = _run_main(["--config", cfgs["aam"], "--stage", "2", "--stop-stage", "6",
                        "--exp-dir", exp_aam] + common, log)
    warm = [line for _, line in log.lines if line.startswith("warm start:")]
    n_aam = len(_jsonl(jsonl_aam))
    res = {"snorm": _check_scores(exp_aam, len(trials), "snorm")}
    st_resume = _run_main(["--config", cfgs["resume"], "--stage", "3", "--stop-stage", "3",
                           "--exp-dir", exp_aam] + common, log)
    latest_after_resume = open(j(exp_aam, "checkpoints", "latest")).read()
    st_score = {}
    for backend in ("plda", "cosine"):
        st_score[backend] = _run_main(["--config", cfgs["resume"], "--stage", "6",
                                       "--stop-stage", "6", "--backend", backend,
                                       "--exp-dir", exp_aam] + common, log)
        res[backend] = _check_scores(exp_aam, len(trials), backend)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                "flash_aam_bwd": fa.flash_aam_bwd.launches}
    # --- end of the main path ---

    check(launches["flash_aam_fwd"] > 0 and launches["flash_aam_bwd"] > 0,
          f"the recipe path launched {launches}")
    feat_dir = j(root, "exp_wav", "feats")
    nf = dict(line.split() for line in open(j(feat_dir, "utt2num_frames")))
    check(sorted(nf) == sorted(utt2spk) and all(int(v) > 0 for v in nf.values()),
          "stage 1 left utterances out or kept no frame")
    first = kaldi_ark.read_mat(dict(line.split(None, 1) for line in
                                    open(j(feat_dir, "feats.scp")))[sorted(nf)[0]].strip())
    check(first.shape[1] == 40 and np.isfinite(first).all(), f"stage 1 features {first.shape}")
    stage1_bytes = sum(os.path.getsize(j(feat_dir, f)) for f in ("feats.ark", "vad.ark"))

    records_sm, records_aam = _jsonl(jsonl_sm), _jsonl(jsonl_aam)
    losses = [r["loss"] for r in records_sm + records_aam if "loss" in r]
    check(len(losses) > 0 and np.isfinite(losses).all(), "non-finite loss in train_metrics")
    cv_epochs = [r["epoch"] for r in records_aam if "CV" in r["msg"]]
    check(cv_epochs == [0, 1], f"the AAM runs validated epochs {cv_epochs} (the resume must "
                               "run epoch 1 only)")
    check(latest_after_resume == "ckpt_2", f"latest after the resume: {latest_after_resume}")
    # 'latest' always; 'best' once a cv top-1 beat the running best (0 at
    # the start, as in pkr_tpu)
    cv_acc1 = {}
    for tag, exp, records in (("softmax", exp_sm, records_sm), ("aam", exp_aam, records_aam)):
        cv_acc1[tag] = [r["acc1"] for r in records if "CV" in r["msg"]]
        check(os.path.exists(j(exp, "checkpoints", "latest")), f"{exp}: no latest")
        check(os.path.exists(j(exp, "checkpoints", "best")) == (max(cv_acc1[tag]) > 0),
              f"{exp}: 'best' does not follow the cv top-1 {cv_acc1[tag]}")
    # pkr_tpu's warm-start rule for softmax → AAM: every trunk and fc1
    # variable loads; the subtrees params/bn1, params/last and
    # batch_stats/bn1 are skipped, once each
    model = build_model(aam.model, SPK, dev)
    want = [k for k in model.state_dict() if k.startswith(("res.", "fc1."))
            and not k.endswith("num_batches_tracked")]
    check(warm == [f"warm start: loaded {len(want)} tensors, skipped 3"],
          f"warm start printed {warm}, pkr_tpu's rule gives {len(want)} loaded, 3 skipped")

    # checkpoint save and restore at the flagship's size (off the path)
    ck_dir = j(root, "ck_timing")
    t0 = time.perf_counter()
    state = restore_checkpoint(j(exp_aam, "checkpoints"), model)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    save_checkpoint(ck_dir, model, state, sync=True)
    save_ms = 1e3 * (time.perf_counter() - t0)
    ck_bytes = os.path.getsize(j(ck_dir, "ckpt_2", "state.pt"))
    # the best copy on the card's data: a re-save of the epoch with is_best
    # goes to ckpt_2.v1, 'latest' names it, 'best' copies it and restores
    t0 = time.perf_counter()
    save_checkpoint(ck_dir, model, state, is_best=True)
    save_best_ms = 1e3 * (time.perf_counter() - t0)
    check(open(j(ck_dir, "latest")).read() == "ckpt_2.v1", "latest after the best save")
    best_state = restore_checkpoint(ck_dir, model, which="best")
    check(best_state is not None and int(best_state.step) == int(state.step)
          and best_state.epoch == state.epoch, "the 'best' copy does not restore")

    # cohort statistics of the test set against 7325 means (the trained
    # class weight rows), on the card
    test_vecs = load_text_vec_ark(j(exp_aam, "test.iv"))
    means = model.last.weight.detach().cpu().numpy()
    topk_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        stats = cohort_topk_stats(test_vecs, means, 300)
        topk_ms.append(1e3 * (time.perf_counter() - t0))
    check(len(stats) == TEST_SPK * TEST_UTTS and
          all(np.isfinite(v).all() for v in stats.values()), "cohort statistics")

    n_cohort = len(load_text_vec_ark(j(exp_aam, "train.iv")))
    check(n_cohort == COHORT_SUBSET, f"cohort extraction of {n_cohort} utterances")
    n_extract = n_cohort + TEST_SPK * TEST_UTTS
    speed = {"softmax": _train_speed(records_sm[:n_sm]),
             "aam": _train_speed(records_aam[:n_aam]),
             "aam_resume": _train_speed(records_aam[n_aam:])}
    emit({"phase": "recipe", "launches": launches, "path_seconds": path_s,
          "corpus": {"speakers": SPK, "utterances": len(data["utt2spk"]), "frames": frames,
                     "test_utterances": len(t_u2s), "write_seconds": write_s},
          "stage1": {"wavs": RECIPE_WAVS, "seconds": st1.get(1),
                     "utterances_per_s": RECIPE_WAVS / st1[1], "bytes_written": stage1_bytes},
          "stage_seconds": {"softmax": st_sm, "aam": st_aam, "aam_resume": st_resume,
                            "score_plda": st_score["plda"],
                            "score_cosine": st_score["cosine"]},
          "train": speed, "cv_acc1": cv_acc1, "warm_start": warm[0],
          "checkpoint": {"save_ms": save_ms, "save_best_ms": save_best_ms,
                         "restore_ms": restore_ms, "bytes": ck_bytes},
          "extraction": {"utterances": n_extract, "seconds": st_aam[4],
                         "utterances_per_s": n_extract / st_aam[4]},
          "cohort_topk_ms": topk_ms, "cohort_topk_shape": [len(test_vecs), len(means)],
          "run_score_seconds": {"snorm": st_aam[6], "plda": st_score["plda"][6],
                                "cosine": st_score["cosine"][6]},
          "n_trials": len(trials), "n_target": n_target, "results": res,
          "card": smi_line})
    return launches


def _kernel_entry(name, source, replaces, launches, rows, main_row, err_keys):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(max(r[k] for k in err_keys) for r in rows),
            "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "bound_tc_ms": main_row["bound_tc_ms"],
            "library_ms": main_row["library_ms"],
            "shape": {"B": main_row["B"], "C": main_row["C"], "D": main_row["D"]},
            "ok": True}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA "
              "card and never falls back to the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import pkr_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    try:
        smi_line = phase_env(torch)
        phase_build()
        rows, bwd_rows = phase_kernel(torch, smi_line)
        launches = phase_slice(torch, smi_line)
        train_launches = phase_train(torch, smi_line)
        corpus_launches = phase_corpus(torch, smi_line)
        recipe_launches = phase_recipe(torch, smi_line)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    # each kernel's time at its main path's shape: the slice's eval batch for
    # the forward, the train step's for the backward
    kernels = [
        _kernel_entry("flash_aam_fwd", "pkr_tpu_torch/csrc/flash_aam_fwd.cu",
                      "pkr_tpu/ops/flash_aam.py:53",
                      {"slice": launches["flash_aam_fwd"],
                       "train": train_launches["flash_aam_fwd"],
                       "corpus": corpus_launches["flash_aam_fwd"],
                       "recipe": recipe_launches["flash_aam_fwd"]},
                      rows, rows[0], ("max_abs_err_lse", "max_abs_err_zy")),
        _kernel_entry("flash_aam_bwd", "pkr_tpu_torch/csrc/flash_aam_bwd.cu",
                      "pkr_tpu/ops/flash_aam.py:197",
                      {"train": train_launches["flash_aam_bwd"],
                       "corpus": corpus_launches["flash_aam_bwd"],
                       "recipe": recipe_launches["flash_aam_bwd"]},
                      bwd_rows, bwd_rows[0], ("max_abs_err_de", "max_abs_err_dw"))]
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
