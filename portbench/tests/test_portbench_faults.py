"""A run with the timed path broken underneath comes out not correct.

On the CPU, at a tiny size (tiny_resnet, B = 8, the program in float32,
where a sound run reads ~1e-6), each cell's driver runs a whole run
(set-up, window, reference, comparison against the cell's own limits)
past the harness's look for a card.  The sound run is correct; each fault
the cell can have is not: for training a step that leaves its state
unchanged, half of the batch left out (the mean over the rest), the
loss altered where it is produced, the AAM weight's gradient dropped, and
the AAM weight's or fc1's update skipped; for extraction an embedding altered
and half of the batch's embeddings left out.  (One chip: no exchange
between chips to leave out.)"""

import json

import pytest
import torch

from portbench import manifest
from portbench.run import Ctx

BENCH = json.loads((manifest.HERE.parent / "BENCHMARK.json").read_text())
TRAIN_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("train")]
EMBED_CELLS = [w["name"] for w in BENCH["workloads"] if w["traffic"].startswith("wav")]


def _tiny(cell_name, **traffic):
    cell = manifest.resolve(BENCH, cell_name)
    cfg = dict(cell.config, trunk="tiny_resnet", n_spk=64, dtype="float32",
               corpus={"speakers": 32, "utts_per_speaker": 2, "frames": [300, 500]})
    return cell, cfg, dict(cell.traffic, **traffic)


def _unchanged(step, model):
    def broken(state, x, y, lr):
        keep = {k: v.detach().clone() for k, v in model.state_dict().items()}
        mom = {k: v.clone() for k, v in state.momentum.items()}
        state, met = step(state, x, y, lr)
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(keep[k])
            for k, v in state.momentum.items():
                v.copy_(mom[k])
        return state, met
    return broken


def _half(step, model):
    return lambda state, x, y, lr: step(state, x[: len(y) // 2], y[: len(y) // 2], lr)


def _head_dw_zero(step, model):
    """The AAM weight's gradient comes out as zero (a backward that drops dW)."""
    model.last.weight.register_hook(torch.zeros_like)
    return step


def _head_frozen(step, model):
    """The AAM weight's update is skipped: it and its momentum stay as they were."""
    def broken(state, x, y, lr):
        w = model.last.weight.detach().clone()
        mom = state.momentum["last.weight"].clone()
        state, met = step(state, x, y, lr)
        with torch.no_grad():
            model.last.weight.copy_(w)
            state.momentum["last.weight"].copy_(mom)
        return state, met
    return broken


def _fc1_frozen(step, model):
    """fc1's update is skipped: its weight and bias keep their values."""
    def broken(state, x, y, lr):
        keep = {n: p.detach().clone() for n, p in model.fc1.named_parameters()}
        state, met = step(state, x, y, lr)
        with torch.no_grad():
            for n, p in model.fc1.named_parameters():
                p.copy_(keep[n])
        return state, met
    return broken


def _altered_loss(step, model):
    def broken(state, x, y, lr):
        state, met = step(state, x, y, lr)
        return state, dict(met, loss=met["loss"] * 1.2)
    return broken


@pytest.mark.parametrize("cell_name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [None, _unchanged, _half, _altered_loss, _head_dw_zero,
                                   _head_frozen, _fc1_frozen],
                         ids=["sound", "unchanged", "half_batch", "altered_loss", "head_dw_zero",
                              "head_frozen", "fc1_frozen"])
def test_train_faults(cell_name, fault):
    cell, cfg, tr = _tiny(cell_name, batch=8, warmup_steps=1, trace_after=10 ** 9)
    hooks = {} if fault is None else {"step": fault}
    ctx = Ctx(cell.name, cfg, tr, 2 ** 31 + 3, 0.3, False, torch.device("cpu"), cell.limits,
              hooks=hooks)
    out = cell.driver.run(ctx)
    assert out["correct"] is (fault is None), out["checks"]


def _altered_emb(embed):
    def broken(feats, mask):
        e = embed(feats, mask).clone()
        e[0] *= 3.0
        return e
    return broken


def _half_emb(embed):
    return lambda feats, mask: embed(feats, mask)[: feats.shape[0] // 2]


@pytest.mark.parametrize("cell_name", EMBED_CELLS)
@pytest.mark.parametrize("fault", [None, _altered_emb, _half_emb],
                         ids=["sound", "altered_embedding", "half_batch"])
def test_embed_faults(cell_name, fault):
    cell, cfg, tr = _tiny(cell_name, batch=4, seconds_per_utt=1.0, pool_batches=2,
                          check_span=2, trace_after=10 ** 9)
    hooks = {} if fault is None else {"embed": fault}
    ctx = Ctx(cell.name, cfg, tr, 2 ** 31 + 4, 2.0, False, torch.device("cpu"), cell.limits,
              hooks=hooks)
    out = cell.driver.run(ctx)
    assert out["correct"] is (fault is None), out["checks"]


def test_flash_spans_recorded_or_the_run_fails():
    """The flash head's spans come from rebinding the program's name for
    it: a stretch that records none (the step no longer calls that name)
    raises instead of leaving the flash rooflines silent."""
    import pkr_tpu_torch.train.loop as loop
    from portbench.trace import Spans

    drv = manifest.load_module(manifest.driver_path("train"), "pb_train_flash_spans")
    spans = drv._FlashSpans(Spans(torch.device("cpu")))
    with pytest.raises(RuntimeError, match="flash_fwd"):
        spans.check()
    gen = torch.Generator().manual_seed(5)
    e = torch.randn(4, 256, generator=gen, requires_grad=True)
    w = torch.randn(64, 256, generator=gen, requires_grad=True)
    y = torch.randint(0, 64, (4,), generator=gen)
    with spans:
        loss, _, _ = loop.flash_aam_loss_acc(e, w, y, 0.2, 30.0)
    assert loop.flash_aam_loss_acc is spans.orig
    loss.backward()
    spans.check()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
