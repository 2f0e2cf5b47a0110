"""The trunk's memory layout per device (``pkr_tpu_torch/models/layout.py``)
on the CPU.

The card's layout is forced here through the function that picks it,
``layout.memory_format_for``, so the CPU runs the channels_last path the
card runs: the same model gives the same embeddings and the same f32 train
steps in both layouts, each parameter, its gradient and its momentum share
strides, and the counter ``trunk.channels_last`` says the layout engaged.
Left alone, the CPU keeps every model contiguous.  Tolerances are
tests/test_torch_train.py's: the two layouts' f32 convolutions sum in
different orders.  Embeddings within 1e-5 of their largest entry.  This
file imports neither JAX nor pkr_tpu.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from pkr_tpu_torch.eval import make_embed_fn
from pkr_tpu_torch.models import SpeakerModel, layout, memory_format_for
from pkr_tpu_torch.models.resnet import BatchNorm
from pkr_tpu_torch.train import TrainState, create_train_state, make_eval_step, make_train_step
from pkr_tpu_torch.train import loop
from pkr_tpu_torch.utils import trace

SPK, F, T = 12, 8, 16
CL = torch.channels_last
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_torch_train.py's bars
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)


def stat_tol(ref, atol=1e-4):
    return dict(rtol=1e-4, atol=atol * float(ref.abs().max()) + 1e-6)


def batches(n, seed, b=8):
    """At least 8 a batch: the CPU's oneDNN backward of a channels_last 1x1
    stride-2 convolution (a downsample) crashes the process at a batch of 2
    or 4 (PyTorch 2.13); the card runs cuDNN's."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, F, T)).astype(np.float32), rng.integers(0, SPK, b))
            for _ in range(n)]


@contextlib.contextmanager
def channels_last_on_cpu():
    """Hold the card's layout on the CPU: every model put on a device meanwhile
    takes channels_last, as on a CUDA device."""
    orig = layout.memory_format_for
    layout.memory_format_for = lambda device: CL
    try:
        yield
    finally:
        layout.memory_format_for = orig


def build(trunk="tiny_resnet", loss="AAM", feat=F, seed=0):
    return SpeakerModel(SPK, feat, loss=loss, trunk=trunk, dtype=torch.float32,
                        device="cpu", generator=torch.Generator().manual_seed(seed))


def pair(trunk="tiny_resnet", loss="AAM", feat=F):
    """One model's weights in the CPU's layout and in the card's."""
    plain = build(trunk, loss, feat)
    with channels_last_on_cpu():
        cl = build(trunk, loss, feat)
    return plain, cl


def conv_weights(model):
    return {k: p for k, p in model.named_parameters() if p.ndim == 4}


def is_channels_last(t):
    return t.is_contiguous(memory_format=CL) and not t.is_contiguous()


def test_the_layout_follows_the_device():
    assert memory_format_for(torch.device("cuda")) == CL
    assert memory_format_for("cuda:1") == CL
    assert memory_format_for("cpu") == memory_format_for(torch.device("cpu")) \
        == torch.contiguous_format
    model = build()
    make_train_step(model, device="cpu")
    make_eval_step(model, device="cpu")
    make_embed_fn(model, device="cpu")
    assert model.res.memory_format == torch.contiguous_format
    assert all(p.is_contiguous() for p in model.parameters())
    plain, cl = pair()
    assert cl.res.memory_format == CL
    assert all(is_channels_last(p) for k, p in conv_weights(cl).items()
               if p.shape[1] > 1 and p.shape[2] > 1), "a 3x3 weight with C > 1 is unambiguous"
    # the stem's C = 1 weight is both layouts in memory: its strides say which
    assert cl.res.conv1.weight.stride() == (9, 1, 3, 1)
    assert plain.res.conv1.weight.stride() == (9, 9, 3, 1)
    # a CUDA model put back on the CPU returns to the CPU's layout
    make_eval_step(cl, device="cpu")
    assert cl.res.memory_format == torch.contiguous_format
    assert all(p.is_contiguous() for p in cl.parameters())


def test_state_dict_and_momentum_across_layouts():
    plain, cl = pair()
    a, b = plain.state_dict(), cl.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)
    with channels_last_on_cpu():
        moved = create_train_state(plain).to("cpu")  # TrainState.to takes the layout
    for k, p in conv_weights(cl).items():
        assert moved.momentum[k].stride() == p.stride(), k
    back = TrainState(moved.momentum, moved.step).to("cpu")
    assert all(v.is_contiguous() for v in back.momentum.values())


@pytest.mark.parametrize("trunk,feat", [("tiny_resnet", F), ("se_resnet34", F),
                                        ("thin_resnet34", F), ("densenet62", 32)])
def test_embeddings_agree_across_layouts(trunk, feat):
    plain, cl = pair(trunk, feat=feat)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, feat, 48)).astype(np.float32))
    mask = torch.ones((4, 48), dtype=torch.bool)
    mask[1, 30:] = False
    mask[3, 17:] = False
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(is_channels_last(out)) if (
            isinstance(out, torch.Tensor) and out.ndim == 4 and min(out.shape[1:]) > 1)
        else None) for m in cl.res.modules()]
    with torch.no_grad():
        for m in (None, mask):
            want = plain.embed(x, m)
            got = cl.embed(x, m)
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
    for h in hooks:
        h.remove()
    assert seen and all(seen), "every map of the trunk stays channels_last"


def _steps(model, data, flash, staged):
    """Three train steps, and the staged BatchNorm statistics of a train-mode
    forward of the first batch before them."""
    step = make_train_step(model, flash_aam=flash, device="cpu")
    state = create_train_state(model)
    model.train()
    with torch.no_grad():
        model.head_input(torch.from_numpy(data[0][0]))
    staged.update({n: tuple(s.clone() for s in m.staged) for n, m in model.named_modules()
                   if isinstance(m, BatchNorm)})
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.staged = None
    losses = []
    for x, y in data:
        state, met = step(state, x, y, 0.01)
        losses.append(float(met["loss"]))
    return state, losses


@pytest.mark.parametrize("flash", [False, True])
def test_train_steps_agree_across_layouts(flash):
    """The dense AAM head, and the flash head through its plain path."""
    data = batches(3, seed=11)
    plain, cl = pair()
    staged_a, staged_b = {}, {}
    state_a, losses_a = _steps(plain, data, flash, staged_a)
    with channels_last_on_cpu():
        state_b, losses_b = _steps(cl, data, flash, staged_b)
    assert cl.res.memory_format == CL and plain.res.memory_format == torch.contiguous_format
    np.testing.assert_allclose(losses_b, losses_a, **LOSS_TOL)
    for k in staged_a:
        for got, want in zip(staged_b[k], staged_a[k]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **stat_tol(want), err_msg=k)
    a, b = plain.state_dict(), cl.state_dict()
    for k, want in a.items():
        tol = stat_tol(want) if ".running_" in k else PARAM_TOL
        np.testing.assert_allclose(b[k].numpy(), want.numpy(), **tol, err_msg=k)
    for k, want in state_a.momentum.items():
        np.testing.assert_allclose(state_b.momentum[k].numpy(), want.numpy(),
                                   **stat_tol(want), err_msg=f"momentum {k}")


def test_params_grads_and_momentum_share_strides(monkeypatch):
    seen = []
    real = loop.sgd_step

    def spy(params, grads, bufs, *args, **kwargs):
        seen.append([(p.stride(), g.stride(), b.stride()) for p, g, b in zip(params, grads, bufs)])
        return real(params, grads, bufs, *args, **kwargs)

    monkeypatch.setattr(loop, "sgd_step", spy)
    with channels_last_on_cpu():
        model = build()
        step = make_train_step(model, device="cpu")
        state = create_train_state(model)
        for x, y in batches(2, seed=12):
            state, _ = step(state, x, y, 0.01)
    assert len(seen) == 2
    for strides in seen:
        assert all(p == g == b for p, g, b in strides)
    assert any(is_channels_last(p) for p in model.parameters())


def test_the_gradient_reduce_keeps_each_layout(monkeypatch):
    """The mesh's flat all_reduce gives each gradient back in its own
    strides (a channels_last one stays channels_last)."""
    monkeypatch.setattr(loop.dist, "all_reduce", lambda t, group=None: t.mul_(2.0))
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn((6, 4, 3, 3), generator=g).contiguous(memory_format=CL),
             torch.randn((5,), generator=g),
             torch.randn((6, 1, 3, 3), generator=g).to(memory_format=CL),
             torch.randn((3, 7), generator=g).t(),  # not dense in its own order: copied
             torch.randn((2, 3, 4, 5), generator=g)]
    out = loop._reduce_grads(grads, types.SimpleNamespace(data_group=object()))
    for got, want in zip(out, grads):
        torch.testing.assert_close(got, 2.0 * want, rtol=0, atol=0)
    assert [o.stride() for o in out[:3]] == [t.stride() for t in grads[:3]]
    assert out[4].stride() == grads[4].stride()


def test_the_layout_counter():
    plain, cl = pair()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, F, T)).astype(np.float32))
    trace.reset()
    with torch.no_grad():
        cl.embed(x)
    assert "trunk.channels_last" not in trace.summary()["counters"]  # off: nothing
    with trace.tracing(), torch.no_grad():
        cl.embed(x)
        cl.embed(x)
        assert trace.summary()["counters"]["trunk.channels_last"] == 2
        plain.embed(x)
    assert trace.summary()["counters"]["trunk.channels_last"] == 2  # a contiguous call adds 0
    trace.reset()
    with channels_last_on_cpu(), trace.tracing():
        step = make_train_step(cl, device="cpu")
        state = create_train_state(cl)
        for xb, yb in batches(3, seed=13):
            state, _ = step(state, xb, yb, 0.01)
        embed = make_embed_fn(cl, device="cpu")
        embed(x, torch.ones((2, T), dtype=torch.bool))
    s = trace.summary()
    assert s["spans"]["step.forward"]["n"] == 3 and s["spans"]["extract.embed"]["n"] == 1
    assert s["counters"]["trunk.channels_last"] == 3 + 1
    trace.reset()
