"""Port train step (pkr_tpu_torch.train) against pkr_tpu.train on the CPU.

Both packages start from the same state: the flax model's TrainState is
carried across by convert.train_state_from_flax (params, batch_stats and the
optax momentum trace), and the same numpy batches go through
pkr_tpu.train.loop.make_train_step and the port's make_train_step.  The JAX
flash head runs its Pallas kernels in interpret mode.  The NaN guard, the
mode switch and the epoch loop are in test_torch_train_loop.py, which
imports the helpers of this file.  Tolerances:

- losses at rtol=atol=2e-4, the bar of tests/test_engine_parity.py;
- parameters at rtol 1e-3, atol 1e-5, as that test;
- BatchNorm running statistics and the momentum trace at rtol 1e-4, with
  an atol of 1e-4 times the largest entry of their tensor (plus 1e-6): a
  gradient is a sum over the batch and the map, and the two frameworks' f32
  convolutions sum in different orders, which moves each entry by ~1e-6 of
  its tensor's scale per step (up to ~2e-5 after 5 steps in the first
  layers) — more than 1e-4 of the entries that are small against that
  scale.  fc1.bias under a bn1 head has a gradient of zero up to rounding.

The data avoid ReLU inputs within ~1e-6 of zero, where the two frameworks
may take different branches and the gradients part by a few percent.
"""


import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from pkr_tpu.models import SpeakerModel as FlaxSpeakerModel
from pkr_tpu.train.loop import make_train_step as jax_make_train_step
from pkr_tpu.train.state import cosine_epoch_lr as jax_cosine_epoch_lr
from pkr_tpu.train.state import create_train_state as jax_create_train_state
from pkr_tpu_torch.convert import train_state_from_flax
from pkr_tpu_torch.models import BatchNorm, SpeakerModel, commit_batch_stats
from pkr_tpu_torch.train import cosine_epoch_lr, make_train_step

SPK, F, T, B = 12, 8, 16, 8
# a rate at which the tiny model's loss stays level over the run: at 0.05 it
# climbs, and a ReLU after bn1 that flips sign in one framework and not the
# other then turns ~1e-6 noise into a 1e-3 difference of fc1 (AAM-v1)
LR = 0.01
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)


def make_pair(loss, seed=0, trunk="tiny_resnet", spk=SPK, feat=F, frames=T):
    """A flax model with its TrainState, and the port's model and TrainState
    carried over from it."""
    fm = FlaxSpeakerModel(spk_num=spk, feat_dim=feat, trunk=trunk, loss=loss,
                          dtype=jnp.float32)
    jstate = jax_create_train_state(fm, jax.random.key(seed), jnp.zeros((2, feat, frames)),
                                    jnp.zeros((2,), jnp.int32))
    tm, tstate = port_from(jstate, loss, trunk, spk, feat)
    return fm, jstate, tm, tstate


def port_from(jstate, loss, trunk="tiny_resnet", spk=SPK, feat=F):
    sd, tstate = train_state_from_flax(jax.tree.map(np.asarray, jstate))
    tm = SpeakerModel(spk, feat, loss=loss, trunk=trunk, dtype=torch.float32,
                      device="cpu")
    tm.load_state_dict(sd, strict=True)
    return tm, tstate


def batches(n, seed, b=B, spk=SPK, feat=F, frames=T):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, feat, frames)).astype(np.float32),
             rng.integers(0, spk, b)) for _ in range(n)]


def run_jax(fm, jstate, data, flash, lr=LR):
    _, jstep = jax_make_train_step(fm, flash_aam=flash, flash_interpret=True)
    metrics = []
    for x, y in data:
        jstate, m = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(lr, jnp.float32))
        metrics.append({k: float(v) for k, v in m.items()})
    return jstate, metrics


def run_port(tm, tstate, data, flash, lr=LR):
    step = make_train_step(tm, flash_aam=flash, device="cpu")
    metrics = []
    for x, y in data:
        tstate, m = step(tstate, x, y, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    return tstate, metrics


def stat_tol(ref, atol=1e-4):
    return dict(rtol=1e-4, atol=atol * float(ref.abs().max()) + 1e-6)


def assert_state_matches(jstate, tm, tstate, stat_atol=1e-4):
    """The port's weights, BN statistics, momentum and step against the flax
    state, compared in the port's layout; ``stat_atol`` is the statistics'
    and the momentum's atol as a fraction of their tensor's largest entry."""
    sd_ref, ts_ref = train_state_from_flax(jax.tree.map(np.asarray, jstate))
    got = tm.state_dict()
    assert sorted(got) == sorted(sd_ref)
    for k, ref in sd_ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = stat_tol(ref, stat_atol) if ".running_" in k else PARAM_TOL
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), **tol, err_msg=k)
    assert sorted(tstate.momentum) == sorted(ts_ref.momentum)
    for k, ref in ts_ref.momentum.items():
        np.testing.assert_allclose(tstate.momentum[k].numpy(), ref.numpy(),
                                   **stat_tol(ref, stat_atol), err_msg=f"momentum {k}")
    assert int(tstate.step) == int(ts_ref.step)


def assert_metrics_match(jm, tm_):
    np.testing.assert_allclose([m["loss"] for m in tm_], [m["loss"] for m in jm],
                               **LOSS_TOL)
    for k in ("acc1", "acc5"):
        assert [m[k] for m in tm_] == [m[k] for m in jm], k


HEADS = [("AAM", False), ("AAM-v1", False), ("softmax", False), ("AAM", True),
         ("AAM-v1", True)]


@pytest.mark.parametrize("loss,flash", HEADS)
def test_five_steps_match_pkr_tpu(loss, flash):
    fm, jstate, tm, tstate = make_pair(loss)
    data = batches(5, seed=7)
    jstate, jm = run_jax(fm, jstate, data, flash)
    tstate, tmm = run_port(tm, tstate, data, flash)
    assert_metrics_match(jm, tmm)
    assert_state_matches(jstate, tm, tstate)


def _shift_trunk_bn_bias(jstate, beta):
    """Every trunk BatchNorm's β set to ``beta``."""
    def shift(path, v):
        key = jax.tree_util.keystr(path)
        if "_trunk" in key and "BatchNorm" in key and key.endswith("['bias']"):
            return jnp.full_like(v, beta)
        return v

    return jstate.replace(params=jax.tree_util.tree_map_with_path(shift, jstate.params))


@pytest.mark.parametrize("flash", [False, True])
def test_resnet34_two_steps_match_pkr_tpu(flash):
    """The flagship trunk, ResNet-34 in f32, at B = 4, F = 40, T = 32 and 50
    speakers: two train steps at lr 1e-3 from the same weights (the flash
    head against pkr_tpu's Pallas kernels in interpret mode): the losses,
    every parameter and the step at the bounds above, the momentum and the
    BatchNorm statistics at rtol 1e-4 with an atol of 1e-3 of their
    tensor's largest entry (+1e-6).

    That atol is pkr_tpu's own accuracy at this depth: against the same
    step evaluated in f64, pkr_tpu's f32 gradients on this CPU are off by
    up to 4e-4 of their tensor's largest entry (median ~7e-5), the port's by
    at most 6e-6.  Each trunk BatchNorm's β starts at 3 instead of 0 in both
    packages: with β = 0 a run of this size has a few of its ~2.4 M ReLU
    inputs within f32 rounding of zero, where either package — and f64 —
    may take the other branch and move a layer's gradient by 5–15 %."""
    spk, feat, frames, b = 50, 40, 32, 4
    fm, jstate, _, _ = make_pair("AAM", seed=0, trunk="resnet34", spk=spk, feat=feat,
                                 frames=frames)
    jstate = _shift_trunk_bn_bias(jstate, 3.0)
    tm, tstate = port_from(jstate, "AAM", "resnet34", spk, feat)
    data = batches(2, seed=100, b=b, spk=spk, feat=feat, frames=frames)
    jstate, jm = run_jax(fm, jstate, data, flash, lr=1e-3)
    tstate, tmm = run_port(tm, tstate, data, flash, lr=1e-3)
    assert_metrics_match(jm, tmm)
    assert_state_matches(jstate, tm, tstate, stat_atol=1e-3)


@pytest.mark.parametrize("loss,flash", [("AAM", False), ("AAM-v1", True)])
def test_mid_training_start_matches_pkr_tpu(loss, flash):
    """pkr_tpu trains 3 steps alone; its TrainState (weights, BN statistics,
    momentum, step) is carried across and both go on for 5 steps."""
    fm, jstate, _, _ = make_pair(loss, seed=1)
    jstate, _ = run_jax(fm, jstate, batches(3, seed=5), flash)
    jstate = jstate.replace(epoch=jnp.asarray(2, jnp.int32),
                            best_acc1=jnp.asarray(0.25, jnp.float32))
    tm, tstate = port_from(jstate, loss)
    assert (int(tstate.step), tstate.epoch, tstate.best_acc1) == (3, 2, 0.25)
    assert all(float(v.abs().max()) > 0 for v in tstate.momentum.values())
    data = batches(5, seed=6)
    jstate, jm = run_jax(fm, jstate, data, flash)
    tstate, tmm = run_port(tm, tstate, data, flash)
    assert_metrics_match(jm, tmm)
    assert_state_matches(jstate, tm, tstate)


@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (7, 5)])
def test_batchnorm_matches_flax(shape):
    """Train mode normalizes with the biased batch variance; the committed
    running_var folds in the biased variance too (torch's BatchNorm would
    fold in the unbiased one), as flax's batch_stats after one step."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    C = shape[1]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    mean0 = rng.standard_normal(C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    x_nhwc = np.moveaxis(x, 1, -1)  # flax keeps channels last
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y_ref, upd = bn.apply(variables, jnp.asarray(x_nhwc), use_running_average=False,
                          mutable=["batch_stats"])

    tbn = BatchNorm(C)
    tbn.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias),
                         "running_mean": torch.tensor(mean0),
                         "running_var": torch.tensor(var0),
                         "num_batches_tracked": torch.tensor(0)})
    tbn.train()
    y = tbn(torch.from_numpy(x))
    np.testing.assert_array_equal(tbn.running_mean.numpy(), mean0)  # only staged
    commit_batch_stats(tbn, torch.tensor(True))
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-7)
    axes = tuple(i for i in range(x.ndim) if i != 1)
    biased = 0.9 * var0 + 0.1 * x.var(axis=axes)
    unbiased = 0.9 * var0 + 0.1 * x.var(axis=axes, ddof=1)
    np.testing.assert_allclose(tbn.running_var.numpy(), biased, rtol=1e-5)
    assert np.abs(tbn.running_var.numpy() - unbiased).min() > 1e-3
    assert int(tbn.num_batches_tracked) == 1
    tbn.eval()  # eval mode: the running statistics, nothing staged
    ref_eval = bn.apply({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                        jnp.asarray(x_nhwc), use_running_average=True)
    with torch.no_grad():
        y_eval = tbn(torch.from_numpy(x))
    assert tbn.staged is None
    np.testing.assert_allclose(np.moveaxis(y_eval.numpy(), 1, -1), np.asarray(ref_eval),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 4), (1, 3, 1, 1)])
def test_batchnorm_one_value_per_channel_matches_flax(shape):
    """Train mode with one value per channel (a batch of one embedding):
    flax takes the value as its mean with variance 0, so the output is β,
    no gradient reaches the input or γ, and the running statistics fold in
    (value, 0).  torch's own batch_norm refuses such an input."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    C = shape[1]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    mean0 = rng.standard_normal(C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y_ref, upd = bn.apply(variables, jnp.asarray(np.moveaxis(x, 1, -1)),
                          use_running_average=False, mutable=["batch_stats"])

    tbn = BatchNorm(C)
    tbn.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias),
                         "running_mean": torch.tensor(mean0),
                         "running_var": torch.tensor(var0),
                         "num_batches_tracked": torch.tensor(0)})
    tbn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tbn(xt)
    np.testing.assert_array_equal(np.moveaxis(y.detach().numpy(), 1, -1), np.asarray(y_ref))
    np.testing.assert_array_equal(y.detach().numpy().reshape(C), bias)
    y.sum().backward()
    assert float(xt.grad.abs().max()) == 0.0 and float(tbn.weight.grad.abs().max()) == 0.0
    np.testing.assert_array_equal(tbn.bias.grad.numpy(), np.ones(C, np.float32))
    commit_batch_stats(tbn, torch.tensor(True))
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbn.running_var.numpy(), 0.9 * var0, rtol=1e-6)


def test_cosine_epoch_lr_matches_pkr_tpu():
    for lr0, epochs, lr_final in ((0.1, 8, 0.0), (0.2, 5, 1e-4)):
        ref = jax_cosine_epoch_lr(lr0, epochs, lr_final)
        got = cosine_epoch_lr(lr0, epochs, lr_final)
        for epoch in range(epochs + 3):  # past the end the schedule holds lr_final
            np.testing.assert_allclose(got(epoch), float(ref(epoch)), rtol=1e-6, atol=1e-9)
