"""A dry run of the sharded training step over n ranks on tiny shapes.

Port of ``__graft_entry__.dryrun_multichip``: one full train step over an
(n/n_model) × n_model mesh (data parallelism × the classifier's class
shards; n_model = 2 where n is even and at least 4), each rank a process:

- a dense-head step with every parameter whole,
- the flash head's step with the AAM weight class-sharded over ``model``
  (16 speakers),
- where n_model > 1, the flash head's other regime: 7325 speakers do not
  divide a 2-way model axis, so the weight stays whole on every rank,
- a step on a batch drawn from the sharded feature cache (each rank's crops
  from its own shard).

``dryrun_multichip(n, device="cpu")`` runs it on the CPU over gloo; the
default is the card, over NCCL (one card a rank), unless ``backend`` names
another (gloo for several ranks on one card).

    python -m pkr_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np
import torch

from pkr_tpu_torch.device import DeviceLike, resolve_device

SPK = 16
REPLICATED_SPK = 7325
FEAT_DIM, FRAMES = 40, 32


def _model(spk_num: int, device: torch.device):
    from pkr_tpu_torch.models import SpeakerModel

    return SpeakerModel(spk_num, FEAT_DIM, "mean+std", "AAM", trunk="tiny_resnet",
                        dtype=torch.float32, device=device,
                        generator=torch.Generator().manual_seed(0))


def _rank_step(n_devices: int, device: str) -> Dict[str, float]:
    """The dry run on one rank (inside a group of ``n_devices`` ranks)."""
    from pkr_tpu_torch.data import ShardedCacheLoader, ShardedDeviceFeatureCache
    from pkr_tpu_torch.parallel import make_mesh, shard_params
    from pkr_tpu_torch.train import create_train_state, make_train_step

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model)
    batch = 2 * n_devices
    b_local = batch // mesh.n_data
    rows = slice(mesh.data_index * b_local, (mesh.data_index + 1) * b_local)
    feats = np.random.default_rng(0).standard_normal((batch, FEAT_DIM, FRAMES))
    feats = torch.from_numpy(feats.astype(np.float32))[rows]
    labels = torch.from_numpy(np.arange(batch) % SPK)[rows]
    out = {"n_data": mesh.n_data, "n_model": mesh.n_model}

    model = _model(SPK, dev)
    state = create_train_state(model)
    step = make_train_step(model, device=dev, mesh=mesh)
    state, metrics = step(state, feats, labels, 0.1)
    out["loss"] = float(metrics["loss"])

    # the flash head, its weight class-sharded over 'model' where the rule
    # splits it (16 % n_model == 0)
    shard_params(model, mesh, state)
    flash_step = make_train_step(model, flash_aam=True, device=dev, mesh=mesh)
    state, fmetrics = flash_step(state, feats, labels, 0.1)
    out["flash_sharded"] = float(fmetrics["loss"])
    out["aam_rows"] = int(model.last.weight.shape[0])

    if n_model > 1:
        # 7325 % 2 != 0: the rule keeps the weight whole on every rank
        model_r = _model(REPLICATED_SPK, dev)
        state_r = create_train_state(model_r)
        if shard_params(model_r, mesh, state_r):
            raise RuntimeError("a 7325-class weight was split over a 2-way model axis")
        labels_r = torch.from_numpy((np.arange(batch) * 911) % REPLICATED_SPK)[rows]
        repl_step = make_train_step(model_r, flash_aam=True, device=dev, mesh=mesh)
        _, rmetrics = repl_step(state_r, feats, labels_r, 0.1)
        out["flash_replicated"] = float(rmetrics["loss"])

    # the data plane: each rank's crops from its own cache shard
    rng = np.random.default_rng(3)
    mats = {f"u{i:02d}": rng.standard_normal((40, 40)).astype(np.float32)
            for i in range(2 * mesh.n_data)}
    labs = {u: i % SPK for i, u in enumerate(sorted(mats))}
    cache = ShardedDeviceFeatureCache.build(mats, labs, mesh, device=dev)
    loader = ShardedCacheLoader(cache, 2 * mesh.n_data, chunk=FRAMES, seed=0)
    cf, cl = next(iter(loader.epoch(0)))
    _, cmetrics = flash_step(state, cf, cl, 0.1)
    out["cache_step"] = float(cmetrics["loss"])
    for k in ("loss", "flash_sharded", "flash_replicated", "cache_step"):
        if k in out and not np.isfinite(out[k]):
            raise RuntimeError(f"dryrun: non-finite {k} {out[k]}")
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     backend: Optional[str] = None, timeout: float = 600.0
                     ) -> Dict[str, float]:
    """Spawn ``n_devices`` ranks, run the sharded train steps (see the
    module's docstring) and return rank 0's losses; every rank's must be
    finite and equal."""
    from pkr_tpu_torch.parallel.distributed import spawn

    dev = str(resolve_device(device))
    results = spawn(_rank_step, n_devices, args=(n_devices, dev), device=dev,
                    backend=backend, timeout=timeout)
    for r, res in enumerate(results):
        if res != results[0]:
            raise RuntimeError(f"dryrun: rank {r} gave {res}, rank 0 {results[0]}")
    res = results[0]
    repl = (f"{res['flash_replicated']:.4f}" if "flash_replicated" in res
            else "skipped(model=1)")
    print(f"dryrun_multichip({n_devices}): mesh={{'data': {res['n_data']}, "
          f"'model': {res['n_model']}}} loss={res['loss']:.4f} "
          f"flash_sharded[{SPK}/{res['n_model']}]={res['flash_sharded']:.4f} "
          f"flash_replicated[{REPLICATED_SPK}%{res['n_model']}!=0]={repl} "
          f"cache_step={res['cache_step']:.4f} OK", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
