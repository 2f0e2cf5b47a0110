"""Port NaN guard, mode switch and epoch loop against pkr_tpu on the CPU.

The helpers (both packages started from one flax TrainState, the seeded
batches, the state comparison and its tolerances) are those of
test_torch_train.py.
"""

import io
import os

import numpy as np
import pytest
import torch

from pkr_tpu.train.loop import train_and_validate as jax_train_and_validate
from pkr_tpu.utils.logging import ProgressLogger as JaxProgressLogger
from pkr_tpu_torch.eval import make_embed_fn
from pkr_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    train_and_validate,
)
from pkr_tpu_torch.utils import ProgressLogger

from test_torch_train import (
    B,
    LOSS_TOL,
    LR,
    T,
    assert_state_matches,
    batches,
    make_pair,
    port_from,
    run_jax,
)


@pytest.mark.parametrize("flash", [False, True])
def test_nan_guard_commits_nothing(flash):
    """An inf in the features gives a non-finite loss: params, momentum and
    the BatchNorm running statistics keep their values; the step advances."""
    fm, jstate, _, _ = make_pair("AAM-v1", seed=2)
    jstate, _ = run_jax(fm, jstate, batches(1, seed=5), False)  # nonzero momentum
    tm, tstate = port_from(jstate, "AAM-v1")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    mom_before = {k: v.clone() for k, v in tstate.momentum.items()}
    (x, y), = batches(1, seed=6)
    x[0, 0, 0] = np.inf
    step = make_train_step(tm, flash_aam=flash, device="cpu")
    tstate, m = step(tstate, x, y, LR)
    assert not np.isfinite(float(m["loss"]))
    for k, v in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.isfinite(v).all(), k
            assert torch.equal(v, before[k]), k
    for k, v in tstate.momentum.items():
        assert torch.equal(v, mom_before[k]), k
    assert int(tstate.step) == 2
    (x, y), = batches(1, seed=6)  # a finite batch commits again
    tstate, m = step(tstate, x, y, LR)
    assert np.isfinite(float(m["loss"])) and int(tstate.step) == 3
    assert not torch.equal(tm.last.weight, before["last.weight"])
    assert not torch.equal(tm.bn1.running_var, before["bn1.running_var"])


def test_steps_set_their_own_mode():
    """cv runs with the running statistics and training with batch statistics,
    whichever step ran last."""
    _, _, tm, tstate = make_pair("AAM-v1", seed=3)
    train_step = make_train_step(tm, device="cpu")
    eval_step = make_eval_step(tm, device="cpu")
    (x, y), = batches(1, seed=8)
    tstate, _ = train_step(tstate, x, y, LR)
    assert tm.training
    got = eval_step(x, y)
    assert not tm.training
    with torch.no_grad():
        ref = tm(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(got["loss"]) / B
               - float(torch.nn.functional.cross_entropy(ref, torch.from_numpy(y)))) < 1e-6
    tracked = int(tm.bn1.num_batches_tracked)
    tstate, _ = train_step(tstate, x, y, LR)  # right after cv: train mode again
    assert tm.training and int(tm.bn1.num_batches_tracked) == tracked + 1


class ListLoader:
    """In-memory loader: epoch e yields its own seeded batches."""

    def __init__(self, n, seed):
        self.n, self.seed = n, seed

    def epoch(self, epoch):
        return batches(self.n, self.seed + 100 * epoch)


@pytest.mark.parametrize("flash", [False, True])
def test_train_and_validate_matches_pkr_tpu(flash):
    fm, jstate, tm, tstate = make_pair("AAM", seed=4)
    train, cv = ListLoader(3, 11), ListLoader(2, 12)
    j_epochs, t_epochs = [], []
    jstate = jax_train_and_validate(
        fm, jstate, train, cv, epochs=2, lr0=LR, print_freq=2, flash_aam=flash,
        logger=JaxProgressLogger(io.StringIO()),
        on_epoch_end=lambda s, e, m: j_epochs.append((e, m)))
    tstate = train_and_validate(
        tm, tstate, train, cv, epochs=2, lr0=LR, print_freq=2, flash_aam=flash,
        logger=ProgressLogger(io.StringIO()), device="cpu",
        on_epoch_end=lambda s, e, m: t_epochs.append((e, m)))
    assert [e for e, _ in t_epochs] == [e for e, _ in j_epochs] == [0, 1]
    for (_, got), (_, ref) in zip(t_epochs, j_epochs):
        np.testing.assert_allclose(got["loss"], ref["loss"], **LOSS_TOL)
        for k in ("acc1", "acc5", "is_best"):
            assert got[k] == ref[k], (k, got, ref)
    assert tstate.epoch == int(jstate.epoch) == 2
    np.testing.assert_allclose(tstate.best_acc1, float(jstate.best_acc1), rtol=1e-6)
    assert_state_matches(jstate, tm, tstate)


def test_train_and_validate_hooks_and_profile(tmp_path):
    """save_every_steps calls its hook, and the profile window writes a
    torch.profiler trace (steps 5 .. 5 + profile_steps of the first epoch)."""
    _, _, tm, tstate = make_pair("AAM", seed=5)
    saved = []
    tstate = train_and_validate(
        tm, create_train_state(tm), ListLoader(7, 13), ListLoader(1, 14), epochs=1,
        lr0=0.1, logger=ProgressLogger(io.StringIO()), device="cpu",
        save_every_steps=3, on_step_save=lambda s: saved.append(int(s.step)),
        profile_dir=str(tmp_path / "prof"), profile_steps=1)
    assert saved == [3, 6]
    assert int(tstate.step) == 7 and tstate.epoch == 1
    assert [f for f in os.listdir(tmp_path / "prof") if f.endswith(".json")]


def test_embed_fn_runs_in_eval_mode_after_a_train_step():
    """An embed function built before training still embeds with the running
    statistics after a train step has put the model in train mode."""
    _, _, tm, tstate = make_pair("AAM", seed=6)
    embed = make_embed_fn(tm, device="cpu")
    (x, y), = batches(1, seed=9)
    mask = np.ones((B, T), bool)
    make_train_step(tm, device="cpu")(tstate, x, y, LR)
    got = embed(x, mask)
    assert not tm.training
    with torch.no_grad():
        ref = tm.embed(torch.from_numpy(x), torch.from_numpy(mask))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
