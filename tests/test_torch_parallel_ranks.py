"""The ranks' side of tests/test_torch_parallel.py: module-level functions
that ``pkr_tpu_torch.parallel.distributed.spawn`` runs in each process of a
gloo group on the CPU.  They import neither JAX nor pkr_tpu, so a spawned
rank starts in seconds; this file holds no test."""

import numpy as np
import torch


def _local_rows(n_rows: int, index: int, count: int) -> slice:
    per = n_rows // count
    return slice(index * per, (index + 1) * per)


def head_rank(cases, n_data, n_model):
    """For each case (name, emb (B, D), w (C, D), labels (B,)): this rank's
    loss, top-1, top-5, dE rows and dW rows from make_flash_aam_sharded on
    an n_data x n_model mesh, the weight in the regime the rule picks, and
    how many times each kernel wrapper ran."""
    from pkr_tpu_torch.ops import flash_aam as fa
    from pkr_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data, n_model)
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index}
    for name, emb, w, labels in cases:
        C = w.shape[0]
        sharded = C % n_model == 0
        rows = _local_rows(emb.shape[0], mesh.data_index, n_data)
        cls = _local_rows(C, mesh.model_index, n_model) if sharded else slice(0, C)
        e = torch.from_numpy(emb[rows]).requires_grad_(True)
        wt = torch.from_numpy(w[cls]).requires_grad_(True)
        fn = fa.make_flash_aam_sharded(mesh, C, 0.2, 30.0, tile=16, with_acc=True)
        fwd0, bwd0 = fa.flash_aam_fwd.launches, fa.flash_aam_bwd.launches
        loss, acc1, acc5 = fn(e, wt, torch.from_numpy(labels[rows]))
        de, dw = torch.autograd.grad(loss, (e, wt))
        out[name] = {"loss": float(loss.detach()), "acc1": float(acc1), "acc5": float(acc5),
                     "rows": (rows.start, rows.stop), "cls": (cls.start, cls.stop),
                     "de": de.numpy(), "dw": dw.numpy(), "sharded": sharded}
    return out


def train_rank(runs, n_data):
    """For each run (name, state dict, momentum, flash, batches, lr, nan_rank)
    of a tiny f32 AAM model: its steps over a 1-rank-a-data-shard mesh, each
    rank taking its rows of every global batch (rank ``nan_rank`` with an
    inf in its features' first value, where it is not None).  Returns each
    run's final state dict, momentum, step and metrics."""
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.parallel import make_mesh
    from pkr_tpu_torch.train import TrainState, make_train_step

    mesh = make_mesh(n_data, 1)
    out = {}
    for name, sd, momentum, flash, data, lr, nan_rank, cfg in runs:
        model = SpeakerModel(cfg["spk"], cfg["feat"], loss=cfg["loss"],
                             trunk="tiny_resnet", dtype=torch.float32, device="cpu")
        model.load_state_dict(sd, strict=True)
        state = TrainState({k: v.clone() for k, v in momentum.items()},
                           torch.tensor(cfg["step"], dtype=torch.int64))
        step = make_train_step(model, flash_aam=flash, device="cpu", mesh=mesh)
        metrics = []
        for x, y in data:
            rows = _local_rows(x.shape[0], mesh.data_index, n_data)
            x = x[rows].copy()
            if nan_rank == mesh.data_index:
                x[0, 0, 0] = np.inf
            state, m = step(state, x, y[rows], lr)
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"sd": {k: v.clone() for k, v in model.state_dict().items()},
                     "momentum": {k: v.clone() for k, v in state.momentum.items()},
                     "step": int(state.step), "metrics": metrics}
    return out


def checkpoint_rank(whole_dir, out_dir, x, y, cfg):
    """On a 1 x 2 mesh: restore the one-process checkpoint in ``whole_dir``
    into a whole model, cut its AAM weight and momentum to this rank's class
    rows (shard_params), take one flash step, and save to ``out_dir`` from
    every rank.  Returns this rank's rows before and after the step."""
    from pkr_tpu_torch.models import SpeakerModel
    from pkr_tpu_torch.parallel import make_mesh, shard_params
    from pkr_tpu_torch.train import make_train_step, restore_checkpoint, save_checkpoint

    mesh = make_mesh(1, 2)
    model = SpeakerModel(cfg["spk"], cfg["feat"], loss="AAM", trunk="tiny_resnet",
                         dtype=torch.float32, device="cpu")
    state = restore_checkpoint(whole_dir, model)
    spec = shard_params(model, mesh, state)
    restored = (model.last.weight.detach().clone(), state.momentum["last.weight"].clone())
    step = make_train_step(model, flash_aam=True, device="cpu", mesh=mesh)
    state, _ = step(state, x, y, 0.05)
    state.epoch = 1
    save_checkpoint(out_dir, model, state, sync=True, mesh=mesh)
    return {"spec": spec, "model_index": mesh.model_index, "restored": restored,
            "weight": model.last.weight.detach().clone(),
            "momentum": state.momentum["last.weight"].clone(),
            "sd": {k: v.clone() for k, v in model.state_dict().items()}}
