#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pkr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(`python3 chip_smoke.py --deep-times ROOT` instead times both kernels at
their deep shapes, D = 300, 512, 1024 (twice), 2304, 4096 and 4608 (twice),
from the pkr_tpu_torch of the checkout at ROOT, and prints a digest of each
kernel's SASS in the libraries it built: run in turns on two checkouts in
one call, it compares them on one card, and the digests show which kernels
the two builds compile alike.)

Phases, one JSON line each:
  env     the card's name, count and power limit (nvidia-smi);
  build   nvcc builds every kernel of the paths from csrc/, one nvcc per
          source, all at once (seconds, ptxas registers, shared memory and
          spills, and the tensor-core HMMA instructions cuobjdump finds in
          each: both kernels run on the tensor cores, so neither may have
          none; the backward's wide, cluster and passes routes and the
          forward's cluster and passes routes may not spill);
  kernel  the clusters of each cluster route that the card holds at once
          and its blocks an SM, at D = 1024, 2048, 2304, 3001 and 4096
          (clusters of 4, 8, 9, 12 and 16 blocks; at least one each), and of
          both passes routes at D = 4608, 6001 and 8192 (two depth passes of
          9, 12 and 16 blocks); each kernel against its plain
          PyTorch version on the card, at the
          shapes of the paths and beyond: D = 256; the deep D = 512, 300 and
          301 (4-byte copies), which the forward takes through its cluster
          route and the backward through its wide route; D = 1024, 777
          (4-byte copies, a ragged last slice), 2048 (a cluster of 8), 2304
          (9, every slice full), 3001 (12, 4-byte copies, a last slice of
          185 columns) and 4096 (16), the cluster route of both; D = 4608
          (also at 256 x 7325), 4097 (a last slice of one column), 6001
          (4-byte copies), 8192 and 8193 (three depth passes), the passes
          route of both; the forward twice for the
          same bits at every deep D; a gradient row by row, each row within
          1e-3 of its own norm, with planted faults the check must reject;
          the backward also with every target p ≈ 0.993 against the plain
          version in f64 at D = 256, 512 and 1024, at D = 37, with labels
          off the shard at D = 256, 300 and 1024, and twice for the same
          bits at D = 256 and every deep D), with its time, the plain
          version's time, a dense library yardstick's time and two roofline
          bounds (f32 CUDA cores; 3×TF32 tensor cores); then the two kernels
          against each other: with one class the backward's gradients are
          exactly 0 iff both formed the same cosine bits
          (check_consistency, D = 256, 37, 512, 300, 301, 1024, 777, 2048,
          2304, 3001, 4096, 4097, 4608, 6001, 8192 and 8193); and one flash and one
          dense ResNet-34 train step of a 512-, a 1024-, a 4096- and a
          4608-wide embedding agree, every forward launch of each path on
          the forward's cluster route (its passes route at 4608) and every
          backward launch on its route (wide, cluster, cluster in clusters
          of 16, passes), with both steps' ms and the flash step's device
          ms and kernel share; the phase within 150 s;
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
  augment waveform augmentation on the card (launching neither kernel), at
          the recipe's pool sizes with synthetic audio made in memory from a
          seed: noise, music and speech pools of 349 12-s recordings each
          (pool_shard_mb 256), 4096 one-second RIRs in 64 rooms plus the
          delta row, 64 six-second point noises and isotropic noises; one
          128 x 6-s batch per kind (clean, noise, music, babble, reverb
          RIR-only as run.sh:109-110, reverb composed with room-convolved
          noises at 40 noises a minute) and a mixed draw.  Gates: clean rows
          bit-identical; noise and music rows at their plan's SNR within
          0.01 dB; delta-RIR rows equal to the signal within 1e-5 of its
          peak; RIR-only rows keep their energy within 1e-4; 8 rows per kind
          equal to the port's same code on the CPU, with the same plans,
          within 1e-4 of their peak; a 12-s bucket makes the tile LRU evict
          within its 2 GiB budget; a set_pool swap drops the kind's tiles.
          Then the recipe with augmentation: prep augment --speed over the
          recipe phase's 512 wavs (3072 utterances), a MUSAN tree and a
          RIRS_NOISES tree written as wavs, and main --stage 0 --stop-stage
          1 --musan-dir --rir-dir on the card with 5-recording pool shards
          rotating every 256 rows.  Gates: every utterance has features,
          every augmented copy's differ from its source's, the speed copies'
          frame counts follow n/0.9 and n/1.1, the rotation record shows a
          rotation and no error.  Prints device, wall, plan-draw and host
          ms per batch and kind, augmented utterances/s, the pools' and tiles' bytes on the
          card, and stage-1 utterances/s beside the recipe phase's clean
          rate;
  zoo     the rest of the model zoo (se_resnet34, thin_resnet34,
          resnet50/101/152, densenet62/115/121/169/201/161): each serves
          one bf16 batch of 128 six-second utterances through make_embed_fn
          with seeded random weights (device and wall ms, peak memory,
          parameters; finite embeddings); densenet121 at the train phase's
          width (B=256 x 200 frames, 7325 speakers, bf16 trunk) takes 8
          flash steps on one batch (the loss must fall), one epoch of
          train_and_validate, then extract_embeddings -> cosine_scores ->
          EER; se_resnet34 takes 5 flash steps; a softmax -> AAM warm start
          of densenet121 through save_checkpoint/load_pretrained must load
          what pkr_tpu's rule loads (all but the heads).  Then one flash and
          one dense densenet121 step agree as in the train phase; for
          se_resnet34 and densenet121 in f32, a bucketed batch equals each
          row's exact-length embedding within 1e-4 of its norm, and the card
          equals the CPU within 5e-4 of the largest entry; ms/step,
          examples/s, conv-MFU (convolution FLOPs counted by forward hooks
          on nn.Conv2d) and a step's device ms and busy share of both; both
          kernels launched; the phase within 150 s;
  parallel the port's parallelism (parallel/, the mesh paths of the train
          step, the flash head, the cache, checkpoints): NCCL at world 1 —
          the train phase's flash step (ResNet-34, B=256 x 200, 7325
          speakers, bf16) through make_train_step(mesh=make_mesh()) equals
          the meshless step bit for bit after 2 steps under deterministic
          cuDNN (the meshless step twice is the control), with both
          ms/step; then two ranks on the one card over gloo (NCCL refuses
          two ranks on one device), each a process: (a) the class-sharded
          flash head at B=256 x C=131072 x D=256 over a 1 x 2 mesh against
          the one-process head on the whole weight (loss within 1e-4,
          top-1/top-5 equal, dê and the gathered dW row by row within 1e-3
          of their norms), both kernels launched on each rank; (b) two f32
          ResNet-34 flash steps at a global B=256 (128 a rank, global-batch
          BatchNorm; the trunk's β at 3, see _par_model) against one
          process at B=256 (parameters at rtol 1e-3 / atol 1e-5, momentum
          and running statistics within 1e-3 of their tensor's largest
          entry, the ranks bit-identical); (c) one epoch
          of ShardedCacheLoader through the bf16 flash step on a synthetic
          corpus of 512 speakers x 2 utterances (a cut of the corpus
          phase's 7325), each rank's crops from its own shard; (d)
          dryrun_multichip(2); the phase within 150 s;
  kernels every kernel with its launches on the paths and its errors (the
          backward's also with a `deep` record of its times at 256 × 7325 ×
          512), then one entry for each deeper route: the backward's wide
          route (timed at 256 × 7325 × 512), each cluster route (timed at
          100 × 7001 × 1024, with a `deep` record at 256 × 7325 × 1024 and
          `shapes` at 100 × 7001 × 2304 and 256 × 7325 × 4096), each passes
          route (timed at 100 × 7001 × 4608, launched on the 4608-wide train
          path; the forward's with a `deep` record at 256 × 7325 × 4608).
Then the card's nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any failed check exits non-zero before the last line.  Without a CUDA card,
or outside a checkout, it fails at once and prints no result.
"""

import copy
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


def profiled_calls(tag, iters):
    """Calls to trace for a timed row: the plain version launches ~174
    kernels a call, whose trace takes seconds to read back, and is timed
    only for reference, so at most 10 of its calls; the others all."""
    return min(iters, 10) if tag == "plain" else iters


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
    # the backward's route for 256 < D <= 512 holds a 32 x 512 accumulator a
    # block in registers, its cluster route (512 < D <= 4096) and its passes
    # route beyond a 32 x 256 slice in the 128 registers of two blocks an
    # SM, and the forward's cluster route (256 < D <= 4096) and its passes
    # route beyond (a pair's reads of a whole pass in flight) run two blocks
    # an SM too: none may spill (each cluster kernel has a 16- and a
    # 4-byte-copy instantiation, the cluster kernels each in two exchanges:
    # up to the portable cluster size and past it)
    for lib, kernel, n in (("flash_aam_bwd", "bwd_wide_kernel", 2),
                           ("flash_aam_bwd", "bwd_cluster_kernel", 4),
                           ("flash_aam_bwd", "bwd_passes_kernel", 2),
                           ("flash_aam_fwd", "fwd_cluster_kernel", 4),
                           ("flash_aam_fwd", "fwd_passes_kernel", 2)):
        ptxas = _native.BUILD_INFO[lib]["ptxas"]
        found = {k: v for k, v in ptxas.items() if kernel in k}
        check(len(found) == n, f"ptxas reported {len(found)} {kernel} instantiations, not {n}")
        for k, v in found.items():
            check(v.get("spill_bytes") == 0, f"{k} spills: {v}")


# target cosine of the confident case, by D: every target p ≈ 0.993 at
# C = 7325.  The non-target logits s·cos spread as s/√D, so they sum to
# about (C − 1)·exp(s²/2D), and the target logit s·phi(cos) must be
# ln(0.993/0.007) above that sum's log: cos = 0.68 at D = 256, 0.654 at
# D = 512, 0.642 at D = 1024
CONFIDENT_COS = {256: 0.68, 512: 0.654, 1024: 0.642}


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


# every kernel of the forward's library (the passes route's norms kernel
# included), and the chunked route of an older checkout's, which
# --deep-times times
FWD_KERNELS = ("fwd_tiles_kernel", "fwd_cluster_kernel", "fwd_passes_kernel", "fwd_norms_kernel",
               "fwd_chunks_kernel", "merge_kernel")


def check_flash_case(torch, name, B, C, D, seed, saturated=False, timed=True, repeat=False,
                     iters=None):
    """flash_aam_fwd against flash_aam_fwd_plain: lse and zy within 5e-4,
    the loss within 2e-4, top-1 and top-5 equal but on rows whose rank gap
    is under 1e-4; `repeat` also checks that a second call gives the same
    bits.  `timed` adds the kernel's, the plain version's and the dense
    library yardstick's times, with both bounds (over `iters` calls, by
    default as many as take about as long as 2e11 B·C·D units)."""
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
    if repeat:
        again = fa.flash_aam_fwd(e_hat, w, labels, zt)
        row["same_bits_twice"] = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        check(row["same_bits_twice"], f"{name}: two calls gave different bits")
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

        iters = iters or max(3, min(50, int(2e11 / (B * C * D))))
        timed_fns = (("kernel", lambda: fa.flash_aam_fwd(e_hat, w, labels, zt),
                      FWD_KERNELS),
                     ("plain", lambda: fa.flash_aam_fwd_plain(e_hat, w, labels, zt), None),
                     ("library", dense, None))
        for tag, fn, only in timed_fns:
            row[f"{tag}_ms"], row[f"{tag}_device_kernels_per_call"], top = device_ms(
                torch, fn, profiled_calls(tag, iters), only)
            row[f"{tag}_call_ms"] = call_ms(torch, fn, iters)
            if tag == "kernel":  # the tile kernel and the merge, ms each per call
                row["kernel_ms_by_launch"] = top
        check(row["kernel_ms"] is not None, f"{name}: the trace shows no kernel time")
        row["bound_ms"], row["bound_by"], row["bound_tc_ms"] = flash_bound(B, C, D)
    emit(row)
    return row


# every kernel of the backward's library (bwd_<route>_kernel and
# bwd_de_sum_kernel), the routes of an older checkout's that --deep-times
# times included
BWD_KERNELS = ("bwd_",)
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
                         confident=False, repeat=False, iters=None):
    """flash_aam_bwd against flash_aam_bwd_plain, on dê and on dW: every row
    within ROW_TOL of its own norm (row_rel_err), and max|Δ| ≤
    1e-3·max|ref| + 1e-6 over the tensor (the kernel and cuBLAS sum in
    different orders, and dz/dcos magnifies cosine rounding near cos = ±1).
    Planted faults in the kernel's output must fail the row check.

    `confident` puts every target p near 0.993, where a = p − 1 cancels and
    s·Δcos/(1 − p) magnifies any rounding of a cosine ~4000×: there the f32
    plain version is itself ~3e-3 off, so the kernel is held to the plain
    version run in f64 (the f32 plain version's own row error is reported).
    `repeat` also checks that a second call gives the same bits; `iters`
    sets the timed calls (check_flash_case)."""
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

        iters = iters or max(3, min(30, int(1e11 / (B * C * D))))
        for tag, fn, only in (
                ("kernel", lambda: fa.flash_aam_bwd(e_hat, w, labels, lse, g), BWD_KERNELS),
                ("plain", lambda: fa.flash_aam_bwd_plain(e_hat, w, labels, lse, g), None),
                ("library", dense_bwd, None)):
            row[f"{tag}_ms"], row[f"{tag}_device_kernels_per_call"], top = device_ms(
                torch, fn, profiled_calls(tag, iters), only)
            row[f"{tag}_call_ms"] = call_ms(torch, fn, iters)
            if tag == "kernel":  # each of the route's kernels, ms per call
                row["kernel_ms_by_launch"] = top
        check(row["kernel_ms"] is not None, f"{name}: the trace shows no kernel time")
        row["bound_ms"], row["bound_by"], row["bound_tc_ms"] = flash_bwd_bound(B, C, D)
    emit(row)
    return row


OFF_SHARD = {"minus_c": (-1,), "plus_c": (1,), "mixed": (-1, 1, 2, -3)}


def check_offshard_case(torch, name, B, C, D, seed, how):
    """Both kernels with every label outside [0, C): the labels a
    class-sharded head hands a shard for rows whose target lies on another
    (shifted by −C, by +C, or a mix of −3C..+2C, OFF_SHARD).  No column is a
    target, so each row keeps its whole non-target gradient, as in the TPU
    kernel, which masks by column only.  The forward against its plain
    version: zy exactly 0, lse and mx within 5e-4, cnt (counted against zt,
    the owner's pivot: here the in-range target's) apart only by classes
    within 1e-4 of zt.  The backward: dê and dW row by row within ROW_TOL
    of their own norm and within 1e-3 of the largest entry (+1e-6); a
    backward that took a negative label for a padded row would zero the
    rows of the −C and mixed cases, which planted_faults' zeroed rows
    stand for."""
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.ops.aam import cosine_logits

    emb, w, labels = _flash_inputs(torch, B, C, D, seed)
    shifts = torch.tensor(OFF_SHARD[how], device=labels.device)
    off = labels + C * shifts.repeat(B // len(shifts) + 1)[:B]
    e_hat, _ = fa._normalize(emb)
    zt = fa._margined_target_z(e_hat, w, labels, 0.2, 30.0)
    got = fa.flash_aam_fwd(e_hat, w, off, zt)
    torch.cuda.synchronize()
    ref = fa.flash_aam_fwd_plain(e_hat, w, off, zt)
    near = ((cosine_logits(e_hat, w) * 30.0 - zt[:, None]).abs() < 1e-4).sum(1)
    row = {"phase": "kernel", "kernel": "both", "case": f"offshard_{how}_{name}", "B": B,
           "C": C, "D": D, "label_range": [int(off.min()), int(off.max())],
           "zy_zero": bool(not got[1].any() and not ref[1].any()),
           "max_abs_err_lse": float((got[0] - ref[0]).abs().max()),
           "max_abs_err_mx": float((got[2] - ref[2]).abs().max()),
           "cnt_rows_apart": int((got[3] != ref[3]).sum()),
           "tol": {"lse_mx": 5e-4, "cnt": "classes within 1e-4 of zt",
                   "row_rel": ROW_TOL, "max_abs": "1e-3*max|ref| + 1e-6"}}
    check(bool(((off < 0) | (off >= C)).all()), f"{name}: a label lies inside [0, C)")
    check(row["zy_zero"], f"{name} {how}: a target column was found")
    check(row["max_abs_err_lse"] <= 5e-4 and row["max_abs_err_mx"] <= 5e-4,
          f"{name} {how}: lse/mx error {row['max_abs_err_lse']}, {row['max_abs_err_mx']}")
    check(bool(((got[3] - ref[3]).abs() <= near).all()),
          f"{name} {how}: rank counts differ beyond near-ties")
    g = torch.full((B,), 1.0 / B, device=emb.device)
    bgot = fa.flash_aam_bwd(e_hat, w, off, ref[0], g)
    torch.cuda.synchronize()
    bref = fa.flash_aam_bwd_plain(e_hat, w, off, ref[0], g)
    for tag, gt, r in (("de", bgot[0], bref[0]), ("dw", bgot[1], bref[1])):
        err, scale = float((gt - r).abs().max()), float(r.abs().max())
        rel = row_rel_err(torch, gt, r)
        row[f"max_abs_err_{tag}"], row[f"row_rel_err_{tag}"] = err, rel
        check(bool(torch.isfinite(gt).all()), f"{name} {how}: non-finite {tag}")
        check(rel <= ROW_TOL, f"{name} {how}: {tag} row error {rel} (a row the kernel "
                              f"dropped has error 1)")
        check(err <= 1e-3 * scale + 1e-6, f"{name} {how}: {tag} error {err} vs {scale}")
        # every class and every example has a gradient of its own
        check(bool((r.abs().amax(dim=1) > 0).all()), f"{name} {how}: a zero {tag} row")
        faults = planted_faults(torch, gt, r, labels[:1] if tag == "dw" else None)
        row[f"planted_{tag}"] = {k: v[0] for k, v in faults.items()}
        for k, (f_rel, _) in faults.items():
            check(f_rel > ROW_TOL, f"{name} {how}: the row check missed the planted {k}")
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


KERNEL_BUDGET_S = 150.0
# the cluster routes' depths past the portable cluster size (8): clusters
# of 9, 12 and 16 blocks
NONPORTABLE_D = (2304, 3001, 4096)
# both kernels' passes routes (D > 4096): two depth passes of clusters of
# 9, 12 and 16 blocks
PASSES_D = (4608, 6001, 8192)


def resident_clusters(torch, smi_line):
    """The clusters of each cluster and passes route that the card holds at
    once, and its blocks an SM, at D = 1024 and 2048 (clusters of 4 and 8),
    at NONPORTABLE_D (9, 12 and 16) and at PASSES_D (passes of 9, 12 and 16
    blocks), with the depth passes: the launch refuses a cluster that the
    card cannot hold, so each must be at least 1."""
    from pkr_tpu_torch.ops import flash_aam as fa

    by_d = {}
    with torch.cuda.device(0):
        for D in (1024, 2048) + NONPORTABLE_D + PASSES_D:
            rec = {}
            for kernel, short in ((fa._KERNEL, "fwd"), (fa._BWD_KERNEL, "bwd")):
                for query in ("cluster_size", "passes", "clusters", "blocks_per_sm"):
                    rec[f"{short}_{query}"] = fa._query(kernel, f"{kernel}_{query}", D)
            by_d[D] = rec
    emit({"phase": "kernel", "kernel": "resident_clusters", "by_D": by_d,
          "sms": torch.cuda.get_device_properties(0).multi_processor_count, "card": smi_line})
    for D, rec in by_d.items():
        want = (1, -(-D // 256)) if D <= 4096 else fa.passes_geometry(D)
        for short in ("fwd", "bwd"):
            check((rec[f"{short}_passes"], rec[f"{short}_cluster_size"]) == want,
                  f"D = {D}: passes and cluster sizes {rec}")
            check(rec[f"{short}_clusters"] >= 1 and rec[f"{short}_blocks_per_sm"] == 2,
                  f"D = {D}: the card holds no cluster of {want[1]} at two blocks an SM: {rec}")
        check(fa.fwd_geometry(D)[1:] == want, f"D = {D}: fwd_geometry {fa.fwd_geometry(D)}")
    return by_d


def phase_kernel(torch, smi_line):
    t0 = time.perf_counter()
    # D > 256 (the forward's cluster route to 4096 and its passes route
    # beyond; the backward's wide route up to 512, its cluster route to 4096
    # and its passes route beyond): the 512-wide embedding at the train
    # batch, a ragged 100 x 7001 x 300, and D = 301, whose rows take 4-byte
    # copies; 4-byte copies and a ragged last slice at 777, the 1024-wide
    # embedding, a cluster of 8 at 2048; past the portable size clusters of
    # 9 at 2304 (every slice full), of 12 at 3001 (4-byte copies, a last
    # slice of 185 columns) and of 16 at 4096; beyond it both passes routes
    # at 4608 (two passes of 9 blocks), timed against the library at 100 x
    # 7001 and 256 x 7325, at 4097 (a last slice of one column), 6001 (12
    # blocks, 4-byte copies, a ragged last slice), 8192 (16) and 8193
    # (three passes of 11); every deep case twice for the same bits
    clusters = resident_clusters(torch, smi_line)
    cases = [("slice_eval", BATCH, SPK, 256, True), ("path_b256", 256, SPK, 256, True),
             ("path_b1024", 1024, SPK, 256, True), ("scale_c131072", 256, 131072, 256, True),
             ("ragged", 100, 7001, 256, False), ("path_b256_d512", 256, SPK, 512, True),
             ("ragged_d300", 100, 7001, 300, True), ("ragged_d301", 100, 7001, 301, False),
             ("ragged_d777", 100, 7001, 777, False), ("ragged_d1024", 100, 7001, 1024, True),
             ("train_b256_d1024", TRAIN_B, SPK, 1024, True), ("b64_d2048", 64, 7001, 2048, False),
             ("ragged_d2304", 100, 7001, 2304, True), ("ragged_d3001", 100, 7001, 3001, False),
             ("b256_d4096", TRAIN_B, SPK, 4096, True), ("ragged_d4608", 100, 7001, 4608, True),
             ("b256_d4608", TRAIN_B, SPK, 4608, True), ("ragged_d4097", 100, 7001, 4097, False),
             ("ragged_d6001", 100, 7001, 6001, False), ("b64_d8192", 64, 7001, 8192, False),
             ("b64_d8193", 64, 7001, 8193, False)]
    rows = [check_flash_case(torch, name, B, C, D, seed=i, timed=timed, repeat=D > 256)
            for i, (name, B, C, D, timed) in enumerate(cases)]
    rows.append(check_flash_case(torch, "saturated", 4, 300, 256, seed=9, saturated=True,
                                 timed=False))
    bwd_cases = [("train_b256", TRAIN_B, SPK, 256, True), ("path_b1024", 1024, SPK, 256, True),
                 ("scale_c131072", 256, 131072, 256, True), ("ragged", 100, 7001, 256, True),
                 ("train_b256_d512", TRAIN_B, SPK, 512, True),
                 ("ragged_d300", 100, 7001, 300, True), ("ragged_d301", 100, 7001, 301, False),
                 # the cluster route (512 < D <= 4096): 4-byte copies and a
                 # ragged last slice at 777, a cluster of 8 at 2048, of 9 at
                 # 2304, of 12 at 3001 (4-byte copies, a ragged last slice)
                 # and of 16 at 4096; beyond it the passes route, timed
                 # against the library at 4608, two passes of 9 blocks, and
                 # at 4097 (a last slice of one column), 6001 (12 blocks,
                 # 4-byte copies, a ragged last slice), 8192 (16) and 8193
                 # (three passes of 11, two output groups)
                 ("ragged_d1024", 100, 7001, 1024, True), ("ragged_d777", 100, 7001, 777, False),
                 ("train_b256_d1024", TRAIN_B, SPK, 1024, True),
                 ("b64_d2048", 64, 7001, 2048, False), ("ragged_d2304", 100, 7001, 2304, True),
                 ("ragged_d3001", 100, 7001, 3001, False), ("b256_d4096", TRAIN_B, SPK, 4096, True),
                 ("ragged_d4608", 100, 7001, 4608, True), ("ragged_d4097", 100, 7001, 4097, False),
                 ("ragged_d6001", 100, 7001, 6001, False), ("b64_d8192", 64, 7001, 8192, False),
                 ("b64_d8193", 64, 7001, 8193, False)]
    bwd_rows = [check_flash_bwd_case(torch, name, B, C, D, seed=20 + i, timed=timed,
                                     repeat=(i == 0 or D > 256))
                for i, (name, B, C, D, timed) in enumerate(bwd_cases)]
    bwd_rows.append(check_flash_bwd_case(torch, "saturated", 4, 300, 256, seed=29,
                                         saturated=True, timed=False))
    for name, D, seed in (("confident", 256, 30), ("confident_d512", 512, 32),
                          ("confident_d1024", 1024, 33)):
        bwd_rows.append(check_flash_bwd_case(torch, name, TRAIN_B, SPK, D, seed=seed,
                                             timed=False, confident=True))
    bwd_rows.append(check_flash_bwd_case(torch, "ragged_depth", 100, 7001, 37, seed=31,
                                         timed=False))
    # labels off the shard (the class-sharded head's), at the train batch and
    # on the deep path
    for i, how in enumerate(OFF_SHARD):
        check_offshard_case(torch, "b256", TRAIN_B, SPK, 256, 50 + i, how)
    check_offshard_case(torch, "ragged_d300", 100, 7001, 300, 53, "minus_c")
    check_offshard_case(torch, "ragged_d1024", 100, 7001, 1024, 54, "mixed")
    # D = 4097 has no exact construction (consistency_inputs): the Gaussian
    # case alone
    for i, (B, D) in enumerate(((256, 256), (100, 37), (256, 512), (100, 300), (100, 301),
                                (100, 1024), (100, 777), (64, 2048), (100, 2304), (64, 3001),
                                (64, 4096), (64, 4608), (64, 4097), (64, 6001), (64, 8192),
                                (64, 8193))):
        for exact in (True, False) if D != 4097 else (False,):
            check_consistency(torch, B, D, seed=40 + i, exact=exact)
    wide_launches = {D: check_wide_train(torch, smi_line, D) for D in WIDE_D}
    phase_s = time.perf_counter() - t0
    emit({"phase": "kernel", "kernel": "all", "phase_s": phase_s, "card": smi_line})
    check(phase_s <= KERNEL_BUDGET_S, f"the kernel phase took {phase_s:.1f} s "
                                      f"(budget {KERNEL_BUDGET_S} s)")
    return rows, bwd_rows, wide_launches, clusters


WIDE_B = 128
# the embedding widths of the kernel phase's train steps
WIDE_D = (512, 1024, 4096, 4608)


def check_wide_train(torch, smi_line, D):
    """A D-wide embedding (SpeakerModel(emb_dim=D); the forward's cluster
    route up to D = 4096 and its passes route at 4608, the backward's wide
    route at D = 512, its cluster route at 1024 and 4096, in clusters of 4
    and of 16, and its passes route at 4608, two passes of 9 blocks): one
    flash step and one dense step from the same weights agree
    (flash_dense_agree), and every launch of each kernel on the path takes
    that route; then both steps' ms (_median_step_ms) and the flash step's
    device ms with its kernels' share."""
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.train import cosine_epoch_lr, create_train_state, make_train_step

    dev = torch.device("cuda")
    torch.manual_seed(3)
    model = SpeakerModel(SPK, 40, "mean+std", "AAM", trunk="resnet34", emb_dim=D,
                         dtype=torch.bfloat16, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((WIDE_B, 40, TRAIN_T), generator=gen, device=dev)
    y = torch.randint(0, SPK, (WIDE_B,), generator=gen, device=dev)
    lr = cosine_epoch_lr(0.1, 10)(0)
    steps = {"flash": make_train_step(model, flash_aam=True), "dense": make_train_step(model)}

    fwd_route = "cluster" if D <= 4096 else "passes"
    route = "wide" if D <= 512 else "cluster" if D <= 4096 else "passes"
    # --- the D-wide path, with the kernel counts at 0 just before it ---
    fa.flash_aam_fwd.launches = 0
    fa.flash_aam_fwd.route_launches = dict.fromkeys(fa.flash_aam_fwd.route_launches, 0)
    fa.flash_aam_bwd.launches = 0
    fa.flash_aam_bwd.route_launches = dict.fromkeys(fa.flash_aam_bwd.route_launches, 0)
    agree = flash_dense_agree(torch, model, init, steps["flash"], steps["dense"], x, y, lr)
    speed = {}
    for tag, step in steps.items():
        model.load_state_dict(init)
        st, _ = step(create_train_state(model), x, y, lr)  # warm-up
        ms, windows, _ = _median_step_ms(torch, step, st, x, y, lr)
        speed[tag] = {"ms_per_step": ms, "window_ms": windows,
                      "examples_per_s": WIDE_B * 1e3 / ms}
    torch.cuda.synchronize()
    launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                "flash_aam_fwd_routes": dict(fa.flash_aam_fwd.route_launches),
                "flash_aam_bwd": fa.flash_aam_bwd.launches,
                "flash_aam_bwd_routes": dict(fa.flash_aam_bwd.route_launches)}
    # --- end of the D-wide path ---
    check(launches["flash_aam_fwd_routes"][fwd_route] > 0 and
          launches["flash_aam_fwd"] == launches["flash_aam_fwd_routes"][fwd_route],
          f"the {D}-wide train path did not run the forward's {fwd_route} route alone: "
          f"{launches}")
    check(launches["flash_aam_bwd_routes"][route] > 0 and
          launches["flash_aam_bwd"] == launches["flash_aam_bwd_routes"][route],
          f"the {D}-wide train path did not run the backward's {route} route alone: {launches}")
    model.load_state_dict(init)
    st = create_train_state(model)
    flash = speed["flash"]
    flash["device_ms"] = device_ms(torch, lambda: steps["flash"](st, x, y, lr), 2)[0]
    flash["flash_kernels_ms"] = device_ms(torch, lambda: steps["flash"](st, x, y, lr), 2,
                                          only=BWD_KERNELS + FWD_KERNELS)[0]
    check(flash["device_ms"] is not None and flash["flash_kernels_ms"] is not None,
          f"the {D}-wide flash step's trace shows no device time")
    flash["flash_kernels_share"] = flash["flash_kernels_ms"] / flash["device_ms"]
    emit({"phase": "kernel", "kernel": "train_step", "case": f"emb_dim_{D}", "B": WIDE_B,
          "C": SPK, "D": D, "launches": launches, "agree": agree, "speed": speed,
          "card": smi_line})
    return launches


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


def write_wav_data(root):
    """The recipe's stage-1 input: a data dir of RECIPE_WAVS synthetic 6-s
    wavs of RECIPE_WAV_SPK speakers under root/wav_data; returns (its path,
    utt2spk)."""
    from pkr_tpu_torch.io import DataDir
    from pkr_tpu_torch.io.wav import write_wav

    wav_root = os.path.join(root, "wavs")
    os.makedirs(wav_root)
    wavs, _ = make_wavs(RECIPE_WAVS, seed=3)
    utt2spk, wav_scp = {}, {}
    for i in range(RECIPE_WAVS):
        spk = f"w{i % RECIPE_WAV_SPK:03d}"
        utt = f"{spk}-{i // RECIPE_WAV_SPK}"
        path = os.path.join(wav_root, f"{utt}.wav")
        write_wav(path, wavs[i])
        utt2spk[utt], wav_scp[utt] = spk, path
    wav_data = os.path.join(root, "wav_data")
    DataDir({"utt2spk": utt2spk, "wav.scp": wav_scp}).make_spk2utt().save(wav_data)
    return wav_data, utt2spk


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
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.recipes import voxceleb
    from pkr_tpu_torch.recipes.presets import PRESETS
    from pkr_tpu_torch.recipes.run import build_model
    from pkr_tpu_torch.train import restore_checkpoint, save_checkpoint

    dev = torch.device("cuda")
    j = os.path.join
    # --- inputs, made before the main path ---
    wav_data, utt2spk = write_wav_data(root)

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
    return launches, RECIPE_WAVS / st1[1]


# --- phase augment ----------------------------------------------------------

AUG_B = 128
AUG_POOL_L = int(12 * RATE)                   # DataConfig.pool_len_sec = 12
AUG_POOL_K = (256 << 20) // (AUG_POOL_L * 4)  # pool_shard_mb = 256: 349 recordings
AUG_RIRS = 4096                               # ReverbPlanner's max_rirs
AUG_ROOMS = 64                                # over two sets, 64 RIRs a room
AUG_RVB_NOISES = 64                           # 6-s point noises, half foreground
AUG_ISO_ROOMS = 4                             # rooms with an isotropic noise
AUG_CHECK_ROWS = 8                            # rows held against the CPU
AUG_LONG = 2 * N_SAMPLES                      # the second bucket length (12 s)
AUG_SNR_DB = 0.01
AUG_RUNS = ("clean", "noise", "music", "babble", "reverb_rir", "reverb_composed", "mixed")
MUSAN_RECORDINGS = 12
RIRS_PER_SET = 32
AUG_SHARD_MB = 4            # 5 12-s recordings a shard: fewer than a kind has
AUG_ROTATE_ROWS = 256


def _aug_pools(rng):
    """MUSAN-sized pools made in memory, AUG_POOL_K recordings a kind, 4-12 s
    long, zero-padded to 12 s: white noise; music as two harmonic tones;
    speech as a syllable-modulated 'voice' plus breath noise."""
    K, L = AUG_POOL_K, AUG_POOL_L
    t = (np.arange(L, dtype=np.float32) / RATE)[None, :]
    pools = {}
    for kind in ("noise", "music", "speech"):
        lens = rng.integers(L // 3, L + 1, size=K)
        if kind == "noise":
            mats = rng.standard_normal((K, L), dtype=np.float32) * 600
        else:
            f0 = rng.uniform(80, 400, size=(K, 1)).astype(np.float32)
            mats = np.sin(2 * np.pi * f0 * t) * 1500
            if kind == "music":
                mats += np.sin(2 * np.pi * 1.5 * f0 * t) * 800
            else:
                mats *= 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t)
            mats += rng.standard_normal((K, L), dtype=np.float32) * 100
        mats *= np.arange(L)[None, :] < lens[:, None]
        pools[kind] = (mats, lens)
    return pools


def _aug_rirs(rng):
    """AUG_RIRS one-second RIRs in AUG_ROOMS rooms (each room its decay
    time), each a direct-path peak of 1 at a random delay and a decaying
    noise tail below it, some shorter than the padded second; then the
    trailing delta row, as AugmentPools.attach_rir_set appends it."""
    K, L = AUG_RIRS, RATE
    room = np.arange(K) // (K // AUG_ROOMS)
    tau = (0.02 + 0.15 * room / AUG_ROOMS) * RATE
    delay = rng.integers(8, 400, size=K)
    lens = rng.integers(L // 2, L + 1, size=K)
    ar = np.arange(L)[None, :]
    tail = np.clip(0.3 * rng.standard_normal((K, L), dtype=np.float32), -0.9, 0.9)
    mats = (tail * np.exp(-np.maximum(ar - delay[:, None], 0) / tau[:, None])
            * (ar > delay[:, None]) * (ar < lens[:, None])).astype(np.float32)
    mats[np.arange(K), delay] = 1.0
    delta = np.zeros((1, L), np.float32)
    delta[0, 0] = 1.0
    return (np.concatenate([mats, delta]), np.concatenate([lens, [1]]).astype(np.int64),
            room)


def _aug_planners(room):
    """The RIR-only planner of the recipe (run.sh:109-110: every utterance
    reverberated, no noise) and a composed one: point-source noises
    room-convolved, isotropic noises in AUG_ISO_ROOMS rooms, fg/bg SNR
    cycles, speech reverberated 3 times in 4 so that some rows stay dry
    (the delta RIR).  40 noises a minute give a 6-s utterance up to 4 (at
    the default of 1 it draws none)."""
    from pkr_tpu_torch.recipes import rir as rr

    def entries():
        out = []
        for name, rooms in (("small", range(AUG_ROOMS // 2)),
                            ("medium", range(AUG_ROOMS // 2, AUG_ROOMS))):
            cur = [rr.RirEntry(f"{name}{i:05d}", f"room{room[i]:02d}", "")
                   for i in range(len(room)) if room[i] in rooms]
            out += rr.smooth_probabilities(cur, target_sum=0.5)
        return out

    point = rr.smooth_probabilities(
        [rr.NoiseEntry(f"pn{i:02d}", "point-source", "",
                       bg_fg_type="foreground" if i % 2 else "background")
         for i in range(AUG_RVB_NOISES)])
    iso = {f"room{r:02d}": rr.smooth_probabilities(
        [rr.NoiseEntry(f"iso{r:02d}", "isotropic", "", room_linkage=f"room{r:02d}")])
        for r in range(AUG_ISO_ROOMS)}
    plain = rr.ReverbPlanner(entries(), seed=1)
    composed = rr.ReverbPlanner(entries(), point, iso, foreground_snrs=(20, 10, 15, 5, 0),
                                background_snrs=(20, 10, 15, 5, 0),
                                speech_rvb_probability=0.75,
                                pointsource_noise_addition_probability=0.5,
                                isotropic_noise_addition_probability=0.5,
                                max_noises_per_minute=40, seed=2)
    return plain, composed


def _replay_plan(cpu_aug, state, kinds, lengths):
    """The plan a call drew: the CPU twin takes the card augmenter's rng and
    planner as they were before the call and draws the same codes and plan
    (WavAugmenter.__call__'s draw order)."""
    cpu_aug.rng, cpu_aug.reverb_planner = copy.deepcopy(state)
    names = cpu_aug.kinds()
    if kinds is None:
        draw = cpu_aug.rng.integers(0, len(names) + 1, size=len(lengths))
        codes = np.where(draw == len(names), 0, draw + 1).astype(np.int32)
    else:
        codes = np.asarray([names.index(k) + 1 if k in names else 0 for k in kinds], np.int32)
    return names, codes, cpu_aug._draw_plan(codes, names, lengths)


def _host_split(torch, aug, fn, iters):
    """Mean ms of one call's plan draws (`_draw_plan`, the planner's draws
    included) and of its whole host side (until the call returns, its
    launches queued), over `iters` calls each started on an idle card."""
    plan, host = [], []
    draw = aug._draw_plan

    def timed(*args):
        t0 = time.perf_counter()
        out = draw(*args)
        plan.append(time.perf_counter() - t0)
        return out

    aug._draw_plan = timed
    try:
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    finally:
        del aug._draw_plan
    return 1e3 * sum(plan) / iters, 1e3 * sum(host) / iters


def _check_tiles(torch, aug):
    budget = aug.tile_budget_bytes
    held = sum(t.numel() * t.element_size() for t in aug._tiled.values())
    check(aug._tiled_bytes == held <= budget
          and all(t.device.type == aug.device.type for t in aug._tiled.values()),
          f"tiles: counted {aug._tiled_bytes} B, held {held} B, budget {budget} B")
    return held


def _aug_gates(torch, name, x, out, lengths, names, codes, plan):
    """The run's gates; returns the rows checked per gate."""
    xs = x.double().cpu().numpy()
    os_ = out.double().cpu().numpy()
    check(np.isfinite(os_).all(), f"{name}: non-finite rows")
    counts = {"clean": 0, "snr": 0, "rir_energy": 0, "delta": 0, "noisy": 0}
    src, _, snrs, _, _, _, n_src = plan
    for r in range(len(codes)):
        ln = int(lengths[r])
        check(not os_[r, ln:].any(), f"{name}: row {r} has samples past its length")
        kind = "none" if codes[r] == 0 else names[codes[r] - 1]
        if kind == "none":
            check(torch.equal(out[r], x[r]), f"{name}: clean row {r} changed")
            counts["clean"] += 1
        elif kind in ("noise", "music"):
            added = os_[r, :ln] - xs[r, :ln]
            snr = 10 * np.log10((xs[r, :ln] ** 2).sum() / (added ** 2).sum())
            check(abs(snr - snrs[r, 0]) <= AUG_SNR_DB,
                  f"{name}: row {r} at {snr:.5f} dB, its plan says {snrs[r, 0]}")
            counts["snr"] += 1
        elif kind == "reverb" and n_src[r] > 1:
            counts["noisy"] += 1  # reverb with RIR-set noises: no closed form
        elif kind == "reverb":
            peak = np.abs(xs[r]).max()
            if src[r, 0] == AUG_RIRS:  # the delta RIR
                err = np.abs(os_[r] - xs[r]).max()
                check(err <= 1e-5 * peak, f"{name}: delta row {r} off by {err / peak}")
                counts["delta"] += 1
            else:
                ratio = (os_[r, :ln] ** 2).sum() / (xs[r, :ln] ** 2).sum()
                check(abs(ratio - 1) <= 1e-4, f"{name}: row {r} wet/dry energy {ratio}")
                counts["rir_energy"] += 1
    return counts


def _cpu_rows(torch, name, aug, cpu_aug, x, lengths, kinds):
    """AUG_CHECK_ROWS rows on the card and through the port's same code on
    the CPU with the same plans: each row within 1e-4 of its peak."""
    k = AUG_CHECK_ROWS
    kinds = None if kinds is None else kinds[:k]
    state = copy.deepcopy((aug.rng, aug.reverb_planner))
    card = aug(x[:k], lengths[:k], kinds=kinds, device_out=True).cpu().numpy()
    cpu_aug.rng, cpu_aug.reverb_planner = state
    cpu = cpu_aug(x[:k].cpu().numpy(), lengths[:k], kinds=kinds)
    worst = 0.0
    for r in range(k):
        peak = max(float(np.abs(cpu[r]).max()), 1e-30)
        worst = max(worst, float(np.abs(card[r] - cpu[r]).max()) / peak)
    check(worst <= 1e-4, f"{name}: card vs CPU rows off by {worst} of their peak")
    return worst


def phase_augment(torch, smi_line, clean_stage1_per_s):
    """Waveform augmentation on the card at the recipe's pool sizes, then
    the recipe's stage 1 with augmentation pools; the recipe's prints are
    written to stderr if the phase fails.  Launches neither flash kernel."""
    import tempfile

    log = _Stamped()
    mixing = _augmenter_runs(torch, smi_line)
    with tempfile.TemporaryDirectory(prefix="pkr_augment_") as root:
        try:
            recipe = _augmented_recipe(torch, smi_line, root, log)
        except BaseException:
            sys.stderr.write("\n".join(line for _, line in log.lines[-200:]) + "\n")
            raise
    recipe["clean_stage1_utterances_per_s"] = clean_stage1_per_s
    emit({"phase": "augment", "augmenter": mixing, "recipe": recipe, "card": smi_line})


def _augmenter_runs(torch, smi_line):
    from pkr_tpu_torch.data.augment import WavAugmenter

    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    pools = _aug_pools(rng)
    rirs, rir_lens, room = _aug_rirs(rng)
    plain, composed = _aug_planners(room)
    rvb_lens = rng.integers(N_SAMPLES // 6, N_SAMPLES + 1, size=len(composed.noise_entries))
    rvb = rng.standard_normal((len(rvb_lens), N_SAMPLES), dtype=np.float32) * 800
    rvb *= np.arange(N_SAMPLES)[None, :] < rvb_lens[:, None]
    wavs, _ = make_wavs(AUG_B, seed=4)
    lengths = rng.integers(3 * N_SAMPLES // 4, N_SAMPLES + 1, size=AUG_B)
    wavs *= np.arange(N_SAMPLES)[None, :] < lengths[:, None]
    make_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mixers = {"aug": WavAugmenter(noise=pools["noise"], music=pools["music"],
                                  speech=pools["speech"], rirs=(rirs, rir_lens),
                                  reverb_planner=plain, seed=0),
              "composed": WavAugmenter(rirs=(rirs, rir_lens), rvb_noise=(rvb, rvb_lens),
                                       reverb_planner=composed, seed=1)}
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    pool_bytes = torch.cuda.memory_allocated() - mem0
    # the port's same code on the CPU, over the same numpy pools; each check
    # hands it the card augmenter's rng and planner as a call found them
    twins = {"aug": WavAugmenter(noise=pools["noise"], music=pools["music"],
                                 speech=pools["speech"], rirs=(rirs, rir_lens), device="cpu"),
             "composed": WavAugmenter(rirs=(rirs, rir_lens), rvb_noise=(rvb, rvb_lens),
                                      device="cpu")}
    x = torch.as_tensor(wavs).cuda()
    check(mixers["aug"].kinds() == ["noise", "music", "babble", "reverb"]
          and mixers["composed"].kinds() == ["reverb"], "augmenter kinds")

    runs = {}
    for name in AUG_RUNS:
        key = "composed" if name == "reverb_composed" else "aug"
        aug, twin = mixers[key], twins[key]
        kind = {"reverb_rir": "reverb", "reverb_composed": "reverb"}.get(name, name)
        kinds = (None if name == "mixed" else
                 ["none" if kind == "clean" or r % 8 == 7 else kind for r in range(AUG_B)])
        state = copy.deepcopy((aug.rng, aug.reverb_planner))
        t0 = time.perf_counter()
        out = aug(x, lengths, kinds=kinds, device_out=True)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        names, codes, plan = _replay_plan(twin, state, kinds, lengths)
        counts = _aug_gates(torch, name, x, out, lengths, names, codes, plan)
        cpu_err = _cpu_rows(torch, name, aug, twin, x, lengths, kinds)
        fn = lambda: aug(x, lengths, kinds=kinds, device_out=True)  # noqa: E731
        dev_ms, n_act, top = device_ms(torch, fn, 3)
        wall = call_ms(torch, fn, 5, warmup=1)
        plan_ms, host_ms = _host_split(torch, aug, fn, 5)
        n_aug = int((codes != 0).sum())
        runs[name] = {"device_ms": dev_ms, "wall_ms": wall, "plan_ms": plan_ms,
                      "host_ms": host_ms, "first_call_ms": first_ms,
                      "activities": n_act, "top": top, "rows": AUG_B,
                      "augmented_rows": n_aug,
                      "augmented_utterances_per_s": 1e3 * n_aug / wall,
                      "rows_per_s": 1e3 * AUG_B / wall,
                      "checked": counts, "cpu_max_rel_err": cpu_err}
        _check_tiles(torch, aug)
    check(runs["noise"]["checked"]["snr"] > 0 and runs["music"]["checked"]["snr"] > 0
          and runs["reverb_rir"]["checked"]["rir_energy"] > 0
          and runs["reverb_composed"]["checked"]["delta"] > 0
          and runs["reverb_composed"]["checked"]["noisy"] > 0
          and runs["clean"]["checked"]["clean"] == AUG_B
          and sum(runs["mixed"]["checked"].values()) > 0,
          f"a gate saw no row: {[(k, v['checked']) for k, v in runs.items()]}")

    # a second bucket length: the byte-accounted LRU evicts 6-s tiles
    aug = mixers["aug"]
    tiles_6s = _check_tiles(torch, aug)
    keys_6s = list(aug._tiled)
    x12 = torch.cat([x, x], dim=1)
    lengths12 = lengths + N_SAMPLES
    t0 = time.perf_counter()
    out12 = aug(x12, lengths12, device_out=True)
    torch.cuda.synchronize()
    long_ms = 1e3 * (time.perf_counter() - t0)
    check(bool(torch.isfinite(out12).all()), "12-s bucket: non-finite rows")
    tiles_12s = _check_tiles(torch, aug)
    keys_12s = list(aug._tiled)
    evicted = [k for k in keys_6s if k not in keys_12s]
    check(len(evicted) > 0 and any(k[1] == AUG_LONG for k in aug._tiled),
          f"no eviction at n = {AUG_LONG}: {list(aug._tiled)}")
    # a shard swap drops the kind's tiles; the next noise batch tiles anew
    before = aug._tiled_bytes
    noise_tiles = [k for k in aug._tiled if k[0] == "noise"]
    aug.set_pool("noise", pools["music"])
    check(not any(k[0] == "noise" for k in aug._tiled)
          and aug._tiled_bytes == before - sum(aug._tile_cost("noise", k[1])
                                               for k in noise_tiles),
          "set_pool kept the kind's tiles")
    _check_tiles(torch, aug)
    aug(x, lengths, kinds=["noise"] * AUG_B, device_out=True)
    torch.cuda.synchronize()
    check(("noise", N_SAMPLES) in aug._tiled, "no noise tile after the swap")
    _check_tiles(torch, aug)
    return {"pool": {"K": AUG_POOL_K, "L": AUG_POOL_L, "rirs": AUG_RIRS + 1,
                     "rvb_noises": len(rvb_lens), "make_seconds": make_s,
                     "upload_seconds": upload_s, "bytes_on_card": pool_bytes},
            "tiles": {"bytes_6s": tiles_6s, "bytes_after_12s": tiles_12s,
                      "budget": aug.tile_budget_bytes, "evicted": evicted,
                      "after_12s": [list(k) for k in keys_12s],
                      "batch_12s_first_call_ms": long_ms,
                      "noise_tiles_dropped_by_set_pool": [list(k) for k in noise_tiles]},
            "composed_cap_hits": composed.cap_hits, "runs": runs,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def _write_musan(root, rng):
    """A MUSAN-style tree of MUSAN_RECORDINGS 8-14 s recordings a kind;
    music/ has an ANNOTATIONS file marking one vocal track, which
    make_musan leaves out."""
    from pkr_tpu_torch.io.wav import write_wav

    for kind in ("noise", "music", "speech"):
        d = os.path.join(root, kind, "synth")
        os.makedirs(d)
        for i in range(MUSAN_RECORDINGS):
            n = int(rng.integers(8 * RATE, 14 * RATE))
            write_wav(os.path.join(d, f"{kind}-synth-{i:04d}.wav"),
                      rng.standard_normal(n) * (300 + 100 * i))
    with open(os.path.join(root, "music", "synth", "ANNOTATIONS"), "w") as f:
        f.write("music-synth-0000 pop Y singer\nmusic-synth-0001 jazz N band\n")


def _write_rirs_noises(root, rng):
    """A RIRS_NOISES-style tree: simulated_rirs/{smallroom,mediumroom} with
    RIRS_PER_SET one-second RIR wavs each over four rooms, and their
    rir_list files (paths relative to the tree's parent, as the corpus has
    them)."""
    from pkr_tpu_torch.io.wav import write_wav

    base = os.path.basename(root)
    for set_i, name in enumerate(("smallroom", "mediumroom")):
        lines = []
        for i in range(RIRS_PER_SET):
            room = f"Room{4 * set_i + i % 4:03d}"
            rel = f"{base}/simulated_rirs/{name}/{room}/{name}-{i:05d}.wav"
            os.makedirs(os.path.dirname(os.path.join(os.path.dirname(root), rel)),
                        exist_ok=True)
            d = int(rng.integers(8, 300))
            t = np.arange(RATE)
            rir = np.clip(0.3 * rng.standard_normal(RATE), -0.9, 0.9) * np.exp(
                -np.maximum(t - d, 0) / ((0.05 + 0.1 * set_i) * RATE)) * (t > d)
            rir[d] = 1.0
            write_wav(os.path.join(os.path.dirname(root), rel), rir * 8000)
            lines.append(f"--rir-id {name}-{i:05d} --room-id {name}-{room} {rel}")
        with open(os.path.join(root, "simulated_rirs", name, "rir_list"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _augmented_recipe(torch, smi_line, root, log):
    import dataclasses

    from pkr_tpu_torch.io import DataDir, kaldi_ark
    from pkr_tpu_torch.recipes.presets import PRESETS
    from pkr_tpu_torch.recipes.voxceleb import make_musan

    j = os.path.join
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    wav_data, utt2spk = write_wav_data(root)
    musan, rirs = j(root, "musan"), j(root, "RIRS_NOISES")
    _write_musan(musan, rng)
    _write_rirs_noises(rirs, rng)
    check({k: dd.num_utts for k, dd in make_musan(musan).items()}
          == {"music": MUSAN_RECORDINGS - 1, "speech": MUSAN_RECORDINGS,
              "noise": MUSAN_RECORDINGS}, "make_musan did not skip the vocal track")
    aug_dir = j(root, "wav_data_aug")
    prep = subprocess.run([sys.executable, "-m", "pkr_tpu_torch.recipes.prep", "augment",
                           "--speed", wav_data, aug_dir], cwd=ROOT, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    check(prep.returncode == 0, f"prep augment: {prep.stderr[-2000:]}")
    dd = DataDir.load(aug_dir)
    n_utts = 6 * RECIPE_WAVS
    check(dd.num_utts == n_utts, f"prep augment gave {dd.num_utts} utterances")
    cfg = PRESETS["aam_v2"]()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, pool_shard_mb=AUG_SHARD_MB, pool_rotate_rows=AUG_ROTATE_ROWS))
    check(cfg.data.augment and (AUG_SHARD_MB << 20) // (int(cfg.data.pool_len_sec * RATE) * 4)
          < MUSAN_RECORDINGS - 1, "the config would not rotate its shards")
    cfg_path = j(root, "aug.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    write_s = time.perf_counter() - t0

    exp = j(root, "exp_aug")
    t0 = time.perf_counter()
    st = _run_main(["--config", cfg_path, "--stage", "0", "--stop-stage", "1",
                    "--data-dir", aug_dir, "--exp-dir", exp, "--musan-dir", musan,
                    "--rir-dir", rirs], log)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0

    feat_dir = j(exp, "feats")
    feats = dict(kaldi_ark.read_mat_scp(j(feat_dir, "feats.scp")))
    check(sorted(feats) == sorted(dd.utts)
          and all(len(m) > 0 and np.isfinite(m).all() for m in feats.values()),
          "stage 1 left utterances out, kept no frame or wrote non-finite values")
    n_aug = 0
    for utt, kind in dd["utt2aug"].items():
        if kind != "none":
            clean = feats[utt.rsplit("-", 1)[0]]
            n = min(len(clean), len(feats[utt]))
            diff = float(np.abs(feats[utt][:n] - clean[:n]).max())
            check(diff > 0.01, f"{utt}: features equal its clean source's ({diff})")
            n_aug += 1
    check(n_aug == n_utts // 2, f"{n_aug} augmented copies")
    vad = {u: len(v) for u, v in kaldi_ark.read_vec_flt_scp(j(feat_dir, "vad.scp"))}
    for utt in utt2spk:
        for f in (0.9, 1.1):
            got, want = vad[f"sp{f}-{utt}"], vad[utt] / f
            check(abs(got - want) <= 2, f"sp{f}-{utt}: {got} frames, n/{f} = {want:.1f}")
    rec = _jsonl(j(feat_dir, "stage1_metrics.jsonl"))
    check(len(rec) == 1 and rec[0]["pool_rotations_done"] >= 1
          and rec[0]["pool_rotation_errors"] == 0, f"stage-1 rotation record {rec}")
    return {"utterances": n_utts, "augmented": n_aug, "musan_recordings": MUSAN_RECORDINGS,
            "rirs": 2 * RIRS_PER_SET, "write_seconds": write_s, "path_seconds": path_s,
            "stage1_seconds": st.get(1), "stage1_utterances_per_s": n_utts / st[1],
            "rotation": rec[0]}


ZOO_TRUNKS = ("se_resnet34", "thin_resnet34", "resnet50", "resnet101", "resnet152",
              "densenet62", "densenet115", "densenet121", "densenet169", "densenet201",
              "densenet161")
ZOO_GATED = ("se_resnet34", "densenet121")  # bucket and card-vs-CPU gates, f32
ZOO_BUDGET_S = 150.0
ZOO_STEPS = 8        # densenet121 flash steps on one batch: the loss must fall
ZOO_SE_STEPS = 5     # se_resnet34 flash steps
# on one fixed batch both trunks' losses fall steadily at this rate (at the
# train phase's 0.1 they drop once, then climb back toward the start)
ZOO_LR = 0.01
BUCKET_LENGTHS = (600, 537, 411, 350, 288, 200, 150, 97)


def _zoo_model(torch, trunk, loss, dtype, seed, device="cuda"):
    from pkr_tpu_torch.models import SpeakerModel

    return SpeakerModel(SPK, 40, "mean+std", loss, trunk=trunk, dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(seed))


def conv_flops(torch, model, x):
    """Forward convolution FLOPs of one embed call, counted by forward hooks
    on every nn.Conv2d: 2 · output elements · cin/groups · kh · kw."""
    total = [0]

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model.embed(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _zoo_train_speed(torch, model, step, x, y, lr, smi_line):
    """ms/step (median of 3 windows of 4 steps, after one warm-up step),
    examples/s and conv-MFU of a train step, from a fresh state; then the
    step's device ms (torch.profiler), its device activities and the busy
    share device / wall."""
    from pkr_tpu_torch.train import create_train_state

    flops = 3.0 * conv_flops(torch, model, x[:2]) * x.shape[0] / 2  # fwd + bwd ≈ 3 × fwd
    st = create_train_state(model)
    st, _ = step(st, x, y, lr)
    ms, windows, _ = _median_step_ms(torch, step, st, x, y, lr)
    dev_ms, n_act, top = device_ms(torch, lambda: step(st, x, y, lr), 2)
    return {"ms_per_step": ms, "window_ms": windows, "examples_per_s": x.shape[0] * 1e3 / ms,
            "device_ms": dev_ms, "activities": n_act,
            "busy": None if dev_ms is None else dev_ms / ms, "top": top[:3],
            "conv_flops_per_step": flops,
            "conv_mfu_bf16": flops / (ms * 1e-3) / PEAK_BF16_FLOPS, "card": smi_line}


def _bucket_gate(torch, model32, x):
    """A bucketed f32 batch (rows of BUCKET_LENGTHS zero-padded to 600
    frames, with their mask) embeds as each row does at its exact length:
    the largest row error relative to the row's norm."""
    n = len(BUCKET_LENGTHS)
    xb = torch.zeros((n, 40, x.shape[2]), device=x.device)
    mb = torch.zeros((n, x.shape[2]), dtype=torch.bool, device=x.device)
    for i, t in enumerate(BUCKET_LENGTHS):
        xb[i, :, :t] = x[i, :, :t].float()
        mb[i, :t] = True
    with torch.no_grad():
        bucketed = model32.embed(xb, mb)
        exact = torch.cat([model32.embed(xb[i:i + 1, :, :t])
                           for i, t in enumerate(BUCKET_LENGTHS)])
    return float(((bucketed - exact).norm(dim=1) / exact.norm(dim=1)).max())


def phase_zoo(torch, smi_line):
    """The rest of the model zoo on the card: every trunk serves a batch;
    densenet121 trains (flash head), cv, extracts and scores; se_resnet34
    trains; a softmax → AAM warm start of densenet121."""
    import io
    import tempfile

    from pkr_tpu_torch.eval import compute_eer, cosine_scores, extract_embeddings, make_embed_fn
    from pkr_tpu_torch.frontend import wav_to_train_feats
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.train import (create_train_state, load_pretrained, make_train_step,
                                     save_checkpoint, train_and_validate)
    from pkr_tpu_torch.utils import ProgressLogger

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    wavs, freqs = make_wavs(BATCH)
    lengths = np.full((BATCH,), N_SAMPLES, np.int64)
    feats, mask, _ = wav_to_train_feats(wavs, lengths,
                                        torch.Generator(device=dev).manual_seed(0))
    x_serve = feats.permute(0, 2, 1).contiguous()  # (B, F, T)
    keys = [f"utt{i:03d}" for i in range(BATCH)]
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((TRAIN_B, 40, TRAIN_T), generator=gen, device=dev)
    y = torch.randint(0, SPK, (TRAIN_B,), generator=gen, device=dev)
    x_cv = torch.randn((TRAIN_B, 40, TRAIN_T), generator=gen, device=dev)
    lr = ZOO_LR

    # --- the main path, with every kernel count at 0 just before it ---
    fa.flash_aam_fwd.launches = 0
    fa.flash_aam_bwd.launches = 0
    t0 = time.perf_counter()
    serving, gated = {}, {}
    for i, trunk in enumerate(ZOO_TRUNKS):  # one bf16 batch each, then its times
        model = _zoo_model(torch, trunk, "AAM", torch.bfloat16, 100 + i)
        embed = make_embed_fn(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        e = embed(x_serve, mask)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        check(tuple(e.shape) == (BATCH, 256) and bool(torch.isfinite(e).all()),
              f"{trunk}: embeddings {tuple(e.shape)} not finite")
        dev_ms, n_act, top = device_ms(torch, lambda: embed(x_serve, mask), 2)
        serving[trunk] = {
            "device_ms": dev_ms, "wall_ms": call_ms(torch, lambda: embed(x_serve, mask), 3,
                                                    warmup=1),
            "first_call_s": first_s, "activities": n_act, "top": top[:3],
            "params": sum(p.numel() for p in model.parameters()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        if trunk in ZOO_GATED:
            gated[trunk] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        del model, embed, e

    model = _zoo_model(torch, "densenet121", "AAM", torch.bfloat16, 7)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    flash_step = make_train_step(model, flash_aam=True)
    dense_step = make_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model)
    losses = []
    for _ in range(ZOO_STEPS):  # one fixed batch: the loss must fall
        state, m = flash_step(state, x, y, lr)
        losses.append(m["loss"])
    cv = []
    state = train_and_validate(
        model, state, _Loader([(x, y)] * 3), _Loader([(x_cv, y)]), epochs=1, lr0=lr,
        flash_aam=True, logger=ProgressLogger(io.StringIO()),
        on_epoch_end=lambda s, e, mt: cv.append(mt))
    half = BATCH // 2
    emb = extract_embeddings(model, [(keys[:half], x_serve[:half], mask[:half]),
                                     (keys[half:], x_serve[half:], mask[half:])])
    enroll = {k: emb[k] for k in keys[:16]}
    test = {k: emb[k] for k in keys[16:32]}
    trials = [(a, b) for a in enroll for b in test]
    trial_labels = [int(abs(freqs[int(a[3:])] - freqs[int(b[3:])]) < 20.0) for a, b in trials]
    scores = cosine_scores(enroll, test, trials, np.mean(np.stack(list(emb.values())), 0))
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated() / 2**30

    se = _zoo_model(torch, "se_resnet34", "AAM", torch.bfloat16, 8)
    se_step = make_train_step(se, flash_aam=True)
    se_state = create_train_state(se)
    se_losses = []
    for _ in range(ZOO_SE_STEPS):
        se_state, m = se_step(se_state, x, y, lr)
        se_losses.append(m["loss"])

    soft = _zoo_model(torch, "densenet121", "softmax", torch.bfloat16, 9)
    aam = _zoo_model(torch, "densenet121", "AAM", torch.bfloat16, 10)
    aam_before = {k: v.clone() for k, v in aam.state_dict().items()}
    with tempfile.TemporaryDirectory(prefix="pkr_zoo_") as root:
        save_checkpoint(root, soft, create_train_state(soft), sync=True)
        loaded = load_pretrained(root, aam, which="latest", verbose=False)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                "flash_aam_bwd": fa.flash_aam_bwd.launches}
    # --- end of the main path ---

    check(launches["flash_aam_fwd"] > 0, "the zoo never launched flash_aam_fwd")
    check(launches["flash_aam_bwd"] > 0, "the zoo never launched flash_aam_bwd")
    losses = [float(v) for v in losses]
    se_losses = [float(v) for v in se_losses]
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"densenet121: the loss did not fall: {losses}")
    check(np.isfinite(se_losses).all() and se_losses[-1] < se_losses[0],
          f"se_resnet34: the loss did not fall: {se_losses}")
    check(int(state.step) == ZOO_STEPS + 3 and len(cv) == 1 and np.isfinite(cv[0]["loss"]),
          f"densenet121 epoch: step {int(state.step)}, cv {cv}")
    E = np.stack([emb[k] for k in keys])
    check(E.shape == (BATCH, 256) and np.isfinite(E).all(), "densenet121 extraction")
    check(0 < sum(trial_labels) < len(trial_labels), "trials need both labels")
    eer = compute_eer(scores, trial_labels)
    check(np.isfinite(scores).all() and 0.0 <= eer <= 1.0, f"densenet121 EER {eer}")

    # pkr_tpu's warm start loads every variable whose path is in both models
    # with one shape: softmax → AAM, all but the heads (softmax bn1 and
    # last/kernel; the AAM weight aam_weight, also last.weight here)
    src_names = set(soft.state_dict())
    want = sorted(k for k in aam.state_dict() if k in src_names
                  and not k.endswith("num_batches_tracked") and not k.startswith("last."))
    check(sorted(loaded) == want, f"warm start loaded {len(loaded)} tensors, "
                                  f"pkr_tpu's rule {len(want)}")
    soft_sd, aam_sd = soft.state_dict(), aam.state_dict()
    check(all(torch.equal(aam_sd[k], soft_sd[k]) for k in want), "warm start values")
    check(torch.equal(aam_sd["last.weight"], aam_before["last.weight"]),
          "the softmax classifier was copied into the AAM weight")

    agree = flash_dense_agree(torch, model, init, flash_step, dense_step, x, y, lr)
    gates = {}
    for trunk, sd in gated.items():
        m32 = _zoo_model(torch, trunk, "AAM", torch.float32, 0)
        m32.load_state_dict(sd)
        bucket = _bucket_gate(torch, m32, x_serve)
        check(bucket <= 1e-4, f"{trunk}: bucketed vs exact-length rel err {bucket}")
        m_cpu = _zoo_model(torch, trunk, "AAM", torch.float32, 0, device="cpu")
        m_cpu.load_state_dict(sd)
        with torch.no_grad():
            e_gpu = m32.embed(x_serve[:2].float(), mask[:2]).cpu()
            e_cpu = m_cpu.embed(x_serve[:2].float().cpu(), mask[:2].cpu())
        rel = float((e_gpu - e_cpu).abs().max() / e_cpu.abs().max())
        check(rel <= 5e-4, f"{trunk}: f32 embedding card vs CPU rel err {rel}")
        gates[trunk] = {"bucket_row_rel": bucket, "f32_card_vs_cpu_rel": rel}

    speed = {"densenet121": _zoo_train_speed(torch, model, flash_step, x, y, lr, smi_line),
             "se_resnet34": _zoo_train_speed(torch, se, se_step, x, y, lr, smi_line)}
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= ZOO_BUDGET_S, f"the zoo phase took {phase_s:.1f} s "
                                   f"(budget {ZOO_BUDGET_S} s)")
    emit({"phase": "zoo", "batch": BATCH, "frames": int(x_serve.shape[2]),
          "launches": launches, "path_seconds": path_s, "phase_seconds": phase_s,
          "serving": serving, "gates": gates,
          "densenet121": {"flash_losses": losses, "cv": cv[0], "eer": eer,
                          "n_trials": len(trials), "agree": agree, "peak_mem_gb": train_peak},
          "se_resnet34": {"flash_losses": se_losses},
          "warm_start": {"loaded": len(loaded), "rule": len(want)},
          "train_speed": speed, "card": smi_line})
    return launches


PAR = {"device": "cuda", "B": TRAIN_B, "T": TRAIN_T, "spk": SPK,
       "C": 131072,         # the class-sharded head's speakers, two shards of 65536
       "cache_spk": 512,    # the sharded cache's corpus: 512 speakers x 2 utterances
       "trunk": "resnet34"}
PAR_DP_STEPS = 2      # data-parallel steps held against one process
PAR_BUDGET_S = 150.0


def _sync(torch, cfg):
    if cfg["device"] == "cuda":
        torch.cuda.synchronize()


def _par_head_inputs(torch, cfg):
    """(emb (B, 256), W (C, 256), labels) on the device, from a seed:
    embeddings half-way to their class row, labels over the whole range
    (both class shards)."""
    rng = np.random.default_rng(60)
    w = rng.standard_normal((cfg["C"], 256), dtype=np.float32)
    labels = rng.integers(0, cfg["C"], cfg["B"])
    emb = 0.5 * w[labels] + rng.standard_normal((cfg["B"], 256), dtype=np.float32)
    return tuple(torch.from_numpy(v).to(cfg["device"]) for v in (emb, w, labels))


def _par_dp_inputs(cfg):
    """The data-parallel check's batches (B x 40 x T), from a seed, on the
    host."""
    rng = np.random.default_rng(61)
    return [(rng.standard_normal((cfg["B"], 40, cfg["T"]), dtype=np.float32),
             rng.integers(0, cfg["spk"], cfg["B"])) for _ in range(PAR_DP_STEPS)]


def _par_model(torch, cfg, dtype, beta=None):
    """The flagship model from a seed; ``beta`` sets every trunk BatchNorm's
    β.  The data-parallel check starts them at 3: at a random start with
    β = 0 about half of the ReLU inputs sit at 0, where rounding picks the
    branch, and two summation orders part by more than any bound could
    tell from a fault (tests/test_torch_train.py's ResNet-34 case shifts β
    the same way)."""
    from pkr_tpu_torch.models import BatchNorm, SpeakerModel

    model = SpeakerModel(cfg["spk"], 40, "mean+std", "AAM", trunk=cfg["trunk"], dtype=dtype,
                         device=cfg["device"], generator=torch.Generator().manual_seed(62))
    if beta is not None:
        with torch.no_grad():
            for mod in model.res.modules():
                if isinstance(mod, BatchNorm):
                    mod.bias.fill_(beta)
    return model


def _host_state(torch, model, state):
    """Host copies of the model's state dict and the momentum."""
    return ({k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()},
            {k: v.detach().to("cpu", copy=True) for k, v in state.momentum.items()})


def _sync_ms(torch, cfg, fn, iters):
    """Mean wall ms of `iters` calls of fn, each ended by a synchronize."""
    _sync(torch, cfg)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _sync(torch, cfg)
    return 1e3 * (time.perf_counter() - t0) / iters


def _parallel_rank(corpus_root, cfg):
    """One of two ranks on the one card (gloo): (a) the class-sharded head
    on a 1 x 2 mesh, (b) two f32 ResNet-34 steps on a 2 x 1 mesh (B/2 rows
    a rank), (c) one epoch of ShardedCacheLoader through the bf16 flash
    step on the same mesh.  Every kernel count is 0 just before and read
    just after."""
    import torch

    from pkr_tpu_torch.data import ShardedCacheLoader, ShardedDeviceFeatureCache
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.parallel import gather_rows, make_mesh
    from pkr_tpu_torch.parallel.distributed import process_index
    from pkr_tpu_torch.train import create_train_state, make_train_step

    B, T, C = cfg["B"], cfg["T"], cfg["C"]
    out = {"rank": process_index()}
    emb, w, labels = _par_head_inputs(torch, cfg)
    dp = _par_dp_inputs(cfg)
    mesh_m, mesh_d = make_mesh(1, 2), make_mesh(2, 1)
    fa.flash_aam_fwd.launches = 0
    fa.flash_aam_bwd.launches = 0
    t0 = time.perf_counter()

    # (a) the class-sharded head
    rows = C // 2
    w_shard = w[mesh_m.model_index * rows:(mesh_m.model_index + 1) * rows].clone()
    fn = fa.make_flash_aam_sharded(mesh_m, C, with_acc=True)

    def head():
        e = emb.clone().requires_grad_(True)
        ws = w_shard.clone().requires_grad_(True)
        loss, acc1, acc5 = fn(e, ws, labels)
        return (loss, acc1, acc5) + torch.autograd.grad(loss, (e, ws))

    loss, acc1, acc5, de, dw = head()
    dw_full = gather_rows(dw, mesh_m, C)
    out["head"] = {"loss": float(loss.detach()), "acc1": float(acc1), "acc5": float(acc5),
                   "launches": [fa.flash_aam_fwd.launches, fa.flash_aam_bwd.launches]}
    if out["rank"] == 0:
        out["head"]["de"], out["head"]["dw"] = de.cpu(), dw_full.cpu()
    del dw_full

    # (b) data parallelism, f32 trunk: B/2 rows a rank
    model = _par_model(torch, cfg, torch.float32, beta=3.0)
    state = create_train_state(model)
    step = make_train_step(model, flash_aam=True, device=cfg["device"], mesh=mesh_d)
    half = slice(mesh_d.data_index * B // 2, (mesh_d.data_index + 1) * B // 2)
    losses = []
    for x, y in dp:
        state, m = step(state, x[half], y[half], 0.1)
        losses.append(float(m["loss"]))
    sd, mom = _host_state(torch, model, state)
    out["dp"] = {"losses": losses, "sd": sd, "momentum": mom, "step": int(state.step)}
    x0, y0 = (torch.from_numpy(v[half]).to(cfg["device"]) for v in dp[0])
    out["dp"]["ms_per_step"] = _sync_ms(torch, cfg, lambda: step(state, x0, y0, 0.1), 3)
    del model, state, step

    # (c) one epoch from the sharded cache, bf16 trunk
    scp = os.path.join(corpus_root, "feats.scp")
    u2id = {u: int(v) for u, v in (l.split() for l in
                                   open(os.path.join(corpus_root, "utt2spkid")))}
    t1 = time.perf_counter()
    cache = ShardedDeviceFeatureCache.from_scp(scp, u2id, mesh_d, device=cfg["device"])
    build_s = time.perf_counter() - t1
    loader = ShardedCacheLoader(cache, B, T, seed=0)
    mine = set(int(v) for v in cache.labels_per_shard[mesh_d.data_index])
    model = _par_model(torch, cfg, torch.bfloat16)
    state = create_train_state(model)
    step = make_train_step(model, flash_aam=True, device=cfg["device"], mesh=mesh_d)
    cache_losses, n_rows = [], 0
    _sync(torch, cfg)
    t1 = time.perf_counter()
    for x, y in loader.epoch(0):
        check(tuple(x.shape) == (B // 2, 40, T) and x.device.type == cfg["device"],
              f"a sharded-cache batch of {tuple(x.shape)} on {x.device}")
        check(set(y.tolist()) <= mine, "a sharded-cache label from another shard")
        state, m = step(state, x, y, 0.1)
        cache_losses.append(m["loss"])
        n_rows += x.shape[0]
    _sync(torch, cfg)
    epoch_s = time.perf_counter() - t1
    out["cache"] = {"batches": len(cache_losses), "rows": n_rows,
                    "losses": [float(v) for v in cache_losses],
                    "shard_utts": int(cache.n_utts[mesh_d.data_index]),
                    "shard_bytes": cache.nbytes_per_shard, "build_s": build_s,
                    "epoch_s": epoch_s,
                    "ms_per_step": 1e3 * epoch_s / max(1, len(cache_losses))}
    out["path_s"] = time.perf_counter() - t0
    out["launches"] = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                       "flash_aam_bwd": fa.flash_aam_bwd.launches}
    out["head"]["ms"] = _sync_ms(torch, cfg, head, 3)  # after the counts were read
    return out


def _state_diff(torch, a, b):
    """max |a − b| over every tensor of two {name: tensor} dicts."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _par_world1(torch, cfg):
    """NCCL (gloo off the card), world 1: the flagship flash step (bf16
    trunk) through make_train_step(mesh=make_mesh()) against the meshless
    step, two steps each from the same weights under deterministic cuDNN
    (the meshless step twice is the control); then both steps' ms/step
    with default cuDNN."""
    import torch.distributed as dist

    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.parallel import make_mesh
    from pkr_tpu_torch.parallel.distributed import _free_port, initialize, shutdown
    from pkr_tpu_torch.train import create_train_state, make_train_step

    dev = cfg["device"]
    os.environ["LOCAL_RANK"] = "0"
    check(initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=dev), "no group formed")
    try:
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        want = "nccl" if dev == "cuda" else "gloo"
        check(dist.get_backend() == want and float(one) == 1.0, f"{want} all_reduce")
        model = _par_model(torch, cfg, torch.bfloat16)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        gen = torch.Generator(device=dev).manual_seed(63)
        x = torch.randn((cfg["B"], 40, cfg["T"]), generator=gen, device=dev)
        y = torch.randint(0, cfg["spk"], (cfg["B"],), generator=gen, device=dev)
        mesh = make_mesh()
        steps = {"mesh": make_train_step(model, flash_aam=True, device=dev, mesh=mesh),
                 "meshless": make_train_step(model, flash_aam=True, device=dev)}
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        runs, launches = {}, {}
        try:
            for tag in ("meshless", "mesh", "meshless_again"):
                model.load_state_dict(init)
                st = create_train_state(model)
                if tag == "mesh":  # the main path of this part: counts from 0
                    fa.flash_aam_fwd.launches = fa.flash_aam_bwd.launches = 0
                for _ in range(2):
                    st, m = steps[tag.replace("_again", "")](st, x, y, 0.1)
                if tag == "mesh":
                    _sync(torch, cfg)
                    launches = {"flash_aam_fwd": fa.flash_aam_fwd.launches,
                                "flash_aam_bwd": fa.flash_aam_bwd.launches}
                runs[tag] = _host_state(torch, model, st)
        finally:
            torch.backends.cudnn.deterministic = det
        control = max(_state_diff(torch, runs["meshless"][i], runs["meshless_again"][i])
                      for i in (0, 1))
        diff = max(_state_diff(torch, runs["mesh"][i], runs["meshless"][i]) for i in (0, 1))
        speed = {}
        for tag, step in steps.items():
            model.load_state_dict(init)
            st, _ = step(create_train_state(model), x, y, 0.1)
            _sync(torch, cfg)
            times = []
            for _ in range(3):
                times.append(_sync_ms(torch, cfg, lambda: step(st, x, y, 0.1), 4))
            speed[tag] = float(np.median(times))
        row = {"mesh": mesh.shape, "backend": dist.get_backend(),
               "max_abs_diff_mesh_vs_meshless": diff, "control_meshless_twice": control,
               "ms_per_step": speed, "launches": launches, "tol": "bitwise, as the control"}
        check(diff <= control, f"world-1 mesh step vs meshless: {diff} (control {control})")
        check(min(launches.values()) >= 1, f"the world-1 mesh step launched {launches}")
        return row
    finally:
        shutdown()


def phase_parallel(torch, smi_line, cfg=PAR):
    """The port's parallelism on the one card (see the docstring): NCCL at
    world 1; two gloo ranks on the card for the class-sharded head, data
    parallelism and the sharded cache; dryrun_multichip(2).  ``cfg`` sets
    the device and the sizes (the defaults are the card's and the
    flagship's)."""
    import tempfile

    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.parallel.distributed import spawn
    from pkr_tpu_torch.parallel.dryrun import dryrun_multichip
    from pkr_tpu_torch.train import create_train_state, make_train_step

    dev = cfg["device"]
    t_phase = time.perf_counter()
    world1 = _par_world1(torch, cfg)

    # the one-process references, before the ranks start
    emb, w, labels = _par_head_inputs(torch, cfg)
    e = emb.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    loss, acc1, acc5 = fa.flash_aam_loss_acc(e, wt, labels)
    de_ref, dw_ref = (g.cpu() for g in torch.autograd.grad(loss, (e, wt)))
    head_ref = {"loss": float(loss.detach()), "acc1": float(acc1), "acc5": float(acc5)}
    del emb, w, e, wt
    model = _par_model(torch, cfg, torch.float32, beta=3.0)
    state = create_train_state(model)
    step = make_train_step(model, flash_aam=True, device=dev)
    ref_losses = []
    for x, y in _par_dp_inputs(cfg):
        state, m = step(state, x, y, 0.1)
        ref_losses.append(float(m["loss"]))
    sd_ref, mom_ref = _host_state(torch, model, state)
    x0, y0 = (torch.from_numpy(v).to(dev) for v in _par_dp_inputs(cfg)[0])
    ref_ms = _sync_ms(torch, cfg, lambda: step(state, x0, y0, 0.1), 3)
    del model, state, step, x0, y0
    if dev == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="pkr_parallel_") as root:
        write_corpus(root, seed=4, n_spk=cfg["cache_spk"], split=False)
        t0 = time.perf_counter()
        ranks = spawn(_parallel_rank, 2, args=(root, cfg), device=dev, backend="gloo",
                      timeout=PAR_BUDGET_S)
        spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=dev, backend="gloo", timeout=PAR_BUDGET_S)
    dry_s = time.perf_counter() - t0

    # (a) the class-sharded head against the one-process head
    got = ranks[0]["head"]
    head = {"loss_abs_err": abs(got["loss"] - head_ref["loss"]),
            "acc": [got["acc1"], got["acc5"]], "acc_ref": [head_ref["acc1"], head_ref["acc5"]],
            "row_rel_err_de": row_rel_err(torch, got["de"], de_ref),
            "row_rel_err_dw": row_rel_err(torch, got["dw"], dw_ref),
            "max_abs_err_de": float((got["de"] - de_ref).abs().max()),
            "max_abs_err_dw": float((got["dw"] - dw_ref).abs().max()),
            "launches_by_rank": [r["head"]["launches"] for r in ranks],
            "ms_by_rank": [r["head"]["ms"] for r in ranks],
            "tol": {"loss": 1e-4, "acc": "equal", "row_rel": ROW_TOL,
                    "max_abs": "1e-3*max|ref| + 1e-6"}}
    check(head["loss_abs_err"] <= 1e-4, f"class-sharded head loss {head}")
    check(head["acc"] == head["acc_ref"], f"class-sharded head top-1/top-5 {head}")
    for tag, r in (("de", de_ref), ("dw", dw_ref)):
        check(head[f"row_rel_err_{tag}"] <= ROW_TOL, f"class-sharded {tag}: {head}")
        check(head[f"max_abs_err_{tag}"] <= 1e-3 * float(r.abs().max()) + 1e-6,
              f"class-sharded {tag}: {head}")
    for r in ranks:
        check(min(r["head"]["launches"]) >= 1, f"rank {r['rank']}: a kernel never launched "
                                               f"in the class-sharded head")
        check(min(r["launches"].values()) >= 1, f"rank {r['rank']}: {r['launches']}")
    # (b) two data-parallel steps against one process: parameters at rtol
    # 1e-3 / atol 1e-5, momentum and BatchNorm statistics within 1e-3 of
    # their tensor's largest entry (+1e-6), the ranks bit-identical
    dp = {"losses": ranks[0]["dp"]["losses"], "losses_ref": ref_losses,
          "ms_per_step_2_ranks": [r["dp"]["ms_per_step"] for r in ranks],
          "ms_per_step_1_process": ref_ms, "worst_over_bound": {}}
    check(np.allclose(dp["losses"], ref_losses, rtol=2e-4, atol=2e-4), f"dp losses {dp}")
    for part, ref in (("sd", sd_ref), ("momentum", mom_ref)):
        got_d = ranks[0]["dp"][part]
        check(_state_diff(torch, got_d, ranks[1]["dp"][part]) == 0.0,
              f"the two ranks' {part} differ")
        worst = 0.0
        for k, r in ref.items():
            if k.endswith("num_batches_tracked"):
                check(torch.equal(got_d[k], r), k)
                continue
            d = (got_d[k] - r).abs()
            if part == "sd" and ".running_" not in k:
                bound = 1e-5 + 1e-3 * r.abs()
            else:
                bound = torch.full_like(r, 1e-3 * float(r.abs().max()) + 1e-6)
            worst = max(worst, float((d / bound).max()))
            check(bool((d <= bound).all()), f"dp {part} {k}: {float(d.max())}")
        dp["worst_over_bound"][part] = worst
    # (c) the sharded cache's epoch
    cache = [r["cache"] for r in ranks]
    check(all(c["batches"] >= 1 and np.isfinite(c["losses"]).all() for c in cache),
          f"sharded cache epoch {cache}")
    check(len({c["batches"] for c in cache}) == 1, "the ranks' epochs differ in length")
    check(sum(c["shard_utts"] for c in cache) == cfg["cache_spk"] * CORPUS_UTTS_PER_SPK,
          "the shards do not hold the corpus once")
    launches = {k: sum(r["launches"][k] for r in ranks) + world1["launches"][k]
                for k in ("flash_aam_fwd", "flash_aam_bwd")}
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "parallel", "world1": world1, "head": head, "dp": dp, "cache": cache,
          "dryrun": dry, "launches": launches,
          "launches_by_rank": [r["launches"] for r in ranks],
          "rank_path_s": [r["path_s"] for r in ranks], "spawn_s": spawn_s,
          "dryrun_s": dry_s, "phase_s": phase_s, "card": smi_line})
    check(phase_s <= PAR_BUDGET_S, f"the parallel phase took {phase_s:.1f} s")
    return launches


# both kernels' deep shapes that PERF.md tracks, timed by --deep-times:
# below the portable cluster size, past it, the widest cluster, and the
# depth passes past it
DEEP_TIMED = (("b256_d512", TRAIN_B, SPK, 512), ("ragged_d300", 100, 7001, 300),
              ("ragged_d1024", 100, 7001, 1024), ("b256_d1024", TRAIN_B, SPK, 1024),
              ("ragged_d2304", 100, 7001, 2304), ("b256_d4096", TRAIN_B, SPK, 4096),
              ("ragged_d4608", 100, 7001, 4608), ("b256_d4608", TRAIN_B, SPK, 4608))


def _timing(row):
    return {k: row[k] for k in ("kernel_ms", "kernel_call_ms", "kernel_ms_by_launch",
                                "plain_ms", "plain_call_ms", "library_ms", "library_call_ms",
                                "bound_ms", "bound_tc_ms")}


def sass_digests(lib):
    """{kernel: the first 16 hex digits of the SHA-256 of its SASS} of a
    built library (cuobjdump -sass, each function's text from its
    `Function :` line to the next, every run of blanks made one: cuobjdump
    pads its columns to the widest line of the whole library): two builds
    of one kernel compile alike where the digests are equal."""
    import hashlib
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr[-2000:]}")
    by_name, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            # the anonymous namespace's id hashes the source file: dropped,
            # so that two builds name a kernel alike
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__",
                          line.split("Function :", 1)[1].strip())
            by_name[name] = []
        elif name is not None:
            by_name[name].append(" ".join(line.split()))
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
            for k, v in sorted(by_name.items())}


def deep_times(torch, smi_line, root):
    """Both kernels at DEEP_TIMED, each held against its plain version and
    timed (check_flash_case, check_flash_bwd_case), from the pkr_tpu_torch
    of the checkout at `root`, with the route each launch took, after the
    SASS digests of both libraries (sass_digests): `python3 chip_smoke.py
    --deep-times ROOT`, run in turns on two checkouts in one call, compares
    them on one card."""
    from pkr_tpu_torch.ops import _native
    from pkr_tpu_torch.ops import flash_aam as fa

    _native.build_all(KERNELS)
    emit({"deep_times": "sass", "root": root,
          "digests": {name: sass_digests(_native.build(name)) for name in KERNELS}})
    for i, (name, B, C, D) in enumerate(DEEP_TIMED):
        fwd = check_flash_case(torch, f"deep_times_{name}", B, C, D, seed=70 + i)
        bwd = check_flash_bwd_case(torch, f"deep_times_{name}", B, C, D, seed=80 + i)
        emit({"deep_times": name, "root": root, "card": smi_line, "B": B, "C": C, "D": D,
              "fwd": {"route": fa._route(fa._KERNEL, D), **_timing(fwd)},
              "bwd": {"route": fa._route(fa._BWD_KERNEL, D), **_timing(bwd)}})


def _kernel_entry(name, source, replaces, launches, rows, main_row, err_keys, deep_row=None,
                  more_rows=()):
    """One kernel's record for the kernels line, timed at main_row's shape;
    `deep_row` adds a `deep` record of the same times at its shape, and
    `more_rows` one record each under `shapes`."""
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": sum(launches.values()), "launches_by_path": launches,
             "max_abs_err": max(max(r[k] for k in err_keys) for r in rows),
             "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
             "bound_tc_ms": main_row["bound_tc_ms"],
             "library_ms": main_row["library_ms"],
             "shape": {"B": main_row["B"], "C": main_row["C"], "D": main_row["D"]},
             "ok": True}

    def record(row):
        return {"B": row["B"], "C": row["C"], "D": row["D"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
                "bound_ms": row["bound_ms"], "bound_tc_ms": row["bound_tc_ms"]}

    if deep_row is not None:
        entry["deep"] = record(deep_row)
    if more_rows:
        entry["shapes"] = [record(r) for r in more_rows]
    return entry


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
    args = sys.argv[1:]
    timing_root = None
    if args:
        if args[0] != "--deep-times" or len(args) > 2:
            print("usage: chip_smoke.py [--deep-times [ROOT]]", file=sys.stderr)
            return 2
        timing_root = os.path.abspath(args[1] if len(args) > 1 else ROOT)
    sys.path.insert(0, timing_root or ROOT)
    try:
        import pkr_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    if timing_root is not None:
        try:
            deep_times(torch, phase_env(torch), timing_root)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        return 0
    try:
        smi_line = phase_env(torch)
        phase_build()
        rows, bwd_rows, wide_launches, _ = phase_kernel(torch, smi_line)
        launches = phase_slice(torch, smi_line)
        train_launches = phase_train(torch, smi_line)
        corpus_launches = phase_corpus(torch, smi_line)
        recipe_launches, clean_stage1_per_s = phase_recipe(torch, smi_line)
        phase_augment(torch, smi_line, clean_stage1_per_s)
        zoo_launches = phase_zoo(torch, smi_line)
        parallel_launches = phase_parallel(torch, smi_line)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    # each kernel's time at its main path's shape: the slice's eval batch for
    # the forward, the train step's for the backward; then one entry for each
    # deeper route, with the launches of the wide paths by route
    def by_route(kernel, route, widths):
        return {f"train_d{D}": wide_launches[D][f"{kernel}_routes"][route] for D in widths}

    def timed(rows_, case):
        return next(r for r in rows_ if r["case"] == case)

    fwd_src, fwd_tpu = "pkr_tpu_torch/csrc/flash_aam_fwd.cu", "pkr_tpu/ops/flash_aam.py:53"
    bwd_src, bwd_tpu = "pkr_tpu_torch/csrc/flash_aam_bwd.cu", "pkr_tpu/ops/flash_aam.py:197"
    fwd_errs, bwd_errs = ("max_abs_err_lse", "max_abs_err_zy"), ("max_abs_err_de",
                                                                   "max_abs_err_dw")
    kernels = [
        _kernel_entry("flash_aam_fwd", fwd_src, fwd_tpu,
                      {"slice": launches["flash_aam_fwd"],
                       "train": train_launches["flash_aam_fwd"],
                       **{f"train_d{D}": wide_launches[D]["flash_aam_fwd"]
                          for D in wide_launches},
                       "corpus": corpus_launches["flash_aam_fwd"],
                       "recipe": recipe_launches["flash_aam_fwd"],
                       "zoo": zoo_launches["flash_aam_fwd"],
                       "parallel": parallel_launches["flash_aam_fwd"]},
                      rows, rows[0], fwd_errs),
        _kernel_entry("flash_aam_bwd", bwd_src, bwd_tpu,
                      {"train": train_launches["flash_aam_bwd"],
                       **{f"train_d{D}": wide_launches[D]["flash_aam_bwd"]
                          for D in wide_launches},
                       "corpus": corpus_launches["flash_aam_bwd"],
                       "recipe": recipe_launches["flash_aam_bwd"],
                       "zoo": zoo_launches["flash_aam_bwd"],
                       "parallel": parallel_launches["flash_aam_bwd"]},
                      bwd_rows, bwd_rows[0], bwd_errs,
                      deep_row=timed(bwd_rows, "train_b256_d512")),
        # the forward's cluster route (256 < D <= 4096), timed at 100 x
        # 7001 x 1024 and launched on the 512-, 1024- and 4096-wide train
        # paths; past the portable cluster size at 2304 and 4096
        _kernel_entry("fwd_cluster_kernel", fwd_src, fwd_tpu,
                      by_route("flash_aam_fwd", "cluster", (512, 1024, 4096)),
                      [r for r in rows if 256 < r["D"] <= 4096], timed(rows, "ragged_d1024"),
                      fwd_errs, deep_row=timed(rows, "train_b256_d1024"),
                      more_rows=[timed(rows, "ragged_d2304"), timed(rows, "b256_d4096")]),
        # the forward's passes route (D > 4096) with its norms kernel, timed
        # at 100 x 7001 x 4608 and 256 x 7325 x 4608 and launched on the
        # 4608-wide train path
        _kernel_entry("fwd_passes_kernel", fwd_src, fwd_tpu,
                      by_route("flash_aam_fwd", "passes", (4608,)),
                      [r for r in rows if r["D"] > 4096], timed(rows, "ragged_d4608"), fwd_errs,
                      deep_row=timed(rows, "b256_d4608")),
        # the backward's wide route (256 < D <= 512), timed at 256 x 7325 x
        # 512 and launched on the 512-wide train path
        _kernel_entry("bwd_wide_kernel", bwd_src, bwd_tpu,
                      by_route("flash_aam_bwd", "wide", (512,)),
                      [r for r in bwd_rows if 256 < r["D"] <= 512],
                      timed(bwd_rows, "train_b256_d512"), bwd_errs,
                      more_rows=[timed(bwd_rows, "ragged_d300")]),
        # the backward's cluster route (512 < D <= 4096), timed at 100 x
        # 7001 x 1024 and launched on the 1024- and 4096-wide train paths;
        # past the portable cluster size at 2304 and 4096
        _kernel_entry("bwd_cluster_kernel", bwd_src, bwd_tpu,
                      by_route("flash_aam_bwd", "cluster", (1024, 4096)),
                      [r for r in bwd_rows if 512 < r["D"] <= 4096],
                      timed(bwd_rows, "ragged_d1024"), bwd_errs,
                      deep_row=timed(bwd_rows, "train_b256_d1024"),
                      more_rows=[timed(bwd_rows, "ragged_d2304"), timed(bwd_rows, "b256_d4096")]),
        # the backward's passes route (D > 4096), timed at 100 x 7001 x
        # 4608 and launched on the 4608-wide train path
        _kernel_entry("bwd_passes_kernel", bwd_src, bwd_tpu,
                      by_route("flash_aam_bwd", "passes", (4608,)),
                      [r for r in bwd_rows if r["D"] > 4096], timed(bwd_rows, "ragged_d4608"),
                      bwd_errs)]
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
