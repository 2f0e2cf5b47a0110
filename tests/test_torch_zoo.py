"""The port's model zoo (SE, thin and bottleneck ResNets, the DenseNets)
against pkr_tpu.models on the CPU.

The flax side runs at f32 with random BatchNorm statistics (the DenseNet's
final_norm too) and its variables are carried over by
convert.state_dict_from_flax; the inputs come from a numpy seed.  Outputs
are held at rtol=atol=5e-4, the bar of tests/test_torch_model.py: the two
frameworks' convolutions sum in different orders.

- module parity: SEGate with and without a mask, BasicBlock with the SE
  gate, Bottleneck strided and not, ThinResNet, DenseLayer, Transition and
  a tiny DenseNet;
- SpeakerModel embeddings (with and without a mask) and logits for
  se_resnet34, thin_resnet34, resnet50 and densenet62;
- bucket-padding invariance for se_resnet34 and densenet62, as
  tests/test_models.py holds pkr_tpu to it;
- every trunk name of pkr_tpu: its flax tree (shapes only) loads strictly
  through state_dict_from_flax, with equal parameter counts, and the warm
  start's pkr_tpu path of each port tensor is a path of that tree;
- pkr_tpu's importer takes every tensor of the port's se_resnet34 and
  resnet50 state dicts;
- two f32 train steps of se_resnet34 and densenet62 with the dense and the
  flash head against pkr_tpu's make_train_step, within
  tests/test_torch_train.py's bounds.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pkr_tpu.models import SpeakerModel as FlaxSpeakerModel
from pkr_tpu.models import densenet as jdensenet
from pkr_tpu.models import resnet as jresnet
from pkr_tpu.models.speaker_model import TRUNKS as JAX_TRUNKS
from pkr_tpu.train.checkpoint import import_torch_checkpoint as jax_import
from pkr_tpu.train.state import TrainState as JaxTrainState
from pkr_tpu.train.state import make_optimizer
from pkr_tpu_torch.convert import state_dict_from_flax
from pkr_tpu_torch.models import SpeakerModel, densenet, resnet
from pkr_tpu_torch.train.checkpoint import _reference_key

from test_torch_train import (_shift_trunk_bn_bias, assert_metrics_match,
                              assert_state_matches, batches, port_from, run_jax, run_port)

TOL = dict(rtol=5e-4, atol=5e-4)
ALL_TRUNKS = sorted(JAX_TRUNKS) + sorted(jdensenet.DENSENETS)


def _is_bn(name):
    return name.startswith("BatchNorm") or name in ("bn1", "final_norm")


def randomize_bn(tree, rng, bn=False):
    """Non-trivial BN scale/bias/mean/var in every BatchNorm, final_norm
    included, so the inference BN path matters."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize_bn(v, rng, bn or _is_bn(k))
            continue
        a = np.asarray(v, np.float32)
        if k == "mean":
            a = (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        elif k == "var":
            a = rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        elif bn and k == "scale":
            a = rng.uniform(0.7, 1.3, a.shape).astype(np.float32)
        elif bn and k == "bias":
            a = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        out[k] = a
    return out


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _port_module(port, variables, path, prefix, densenet_tree=False):
    """Load a flax module's variables into the port's module: the tree is
    placed at ``path`` under the speaker model's ``_trunk`` so
    state_dict_from_flax names it, and ``prefix`` is cut off the names."""
    wrapped = {}
    for coll, tree in variables.items():
        node = dict(tree)
        for p in reversed(path):
            node = {p: node}
        if densenet_tree and coll == "params":
            node["final_norm"] = {"scale": np.ones(1), "bias": np.zeros(1)}
        wrapped[coll] = {"_trunk": node}
    sd = {k[len(prefix):]: v for k, v in state_dict_from_flax(wrapped).items()
          if k.startswith(prefix)}
    port.load_state_dict(sd, strict=True)
    return port.eval()


def random_variables(module, *args, seed=0, **kw):
    """A flax module's variables drawn with numpy at the shapes of its tree
    (``jax.eval_shape``: no init is compiled): convolution and dense
    kernels at the He / LeCun scale of their init, random BatchNorms."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']") or key.endswith("['aam_weight']"):
            fan = (np.prod(s.shape[:2]) * s.shape[3] / 2 if len(s.shape) == 4
                   else s.shape[0])
            return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return {k: randomize_bn(v, rng) for k, v in variables.items()}


def _jit_apply(module):
    """The flax module's apply in eval mode, jitted (eager flax compiles op
    by op)."""
    return jax.jit(functools.partial(module.apply, train=False))


def _n_valid(B, T):
    return np.array([T, T - 5, T // 2][:B], np.int32)


@pytest.mark.parametrize("masked", [False, True])
def test_se_gate_matches(masked):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 9, 32)).astype(np.float32)  # (B, F, T, C)
    nv = _n_valid(3, 9) if masked else None
    fm = jresnet.SEGate(32, dtype=jnp.float32)
    variables = random_variables(fm, jnp.asarray(x))
    ref = jax.jit(fm.apply)(variables, jnp.asarray(x), None if nv is None else jnp.asarray(nv))
    port = _port_module(resnet.SEGate(32), variables, ("layer1_0", "SEGate_0"),
                        "res.layer1.0.se.")
    with torch.no_grad():
        got = port(_nchw(x), None if nv is None else torch.from_numpy(nv).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize("block,stride,cin,cout", [
    ("basic_se", 1, 32, 32), ("basic_se", 2, 16, 32),
    ("bottleneck", 1, 32, 32), ("bottleneck", 2, 16, 32), ("bottleneck", 1, 16, 32)])
def test_blocks_match(block, stride, cin, cout):
    rng = np.random.default_rng(1)
    B, Fq, T = 3, 6, 11
    x = rng.standard_normal((B, Fq, T, cin)).astype(np.float32)
    nv = _n_valid(B, T)
    if block == "basic_se":
        fm = jresnet.BasicBlock(cout, (stride, stride), True, jnp.float32)
        port = resnet.BasicBlock(cin, cout, stride, use_se=True)
    else:
        fm = jresnet.Bottleneck(cout, (stride, stride), False, jnp.float32)
        port = resnet.Bottleneck(cin, cout, stride)
    variables = random_variables(fm, jnp.asarray(x), train=False)
    port = _port_module(port, variables, ("layer1_0",), "res.layer1.0.")
    apply = _jit_apply(fm)
    for mk in (None, nv):
        ref = apply(variables, jnp.asarray(x), n_valid=None if mk is None else jnp.asarray(mk))
        with torch.no_grad():
            got = port(_nchw(x), None if mk is None else torch.from_numpy(mk).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                                   **TOL)


def test_bottleneck_refuses_se():
    with pytest.raises(ValueError, match="SE"):
        resnet.Bottleneck(8, 8, use_se=True)


def test_thin_resnet_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16, 40)).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([40, 33, 17])[:, None]
    fm = jresnet.ThinResNet([1, 2, 1, 1], dtype=jnp.float32)
    variables = random_variables(fm, jnp.asarray(x))
    port = _port_module(resnet.ThinResNet([1, 2, 1, 1]), variables, (), "res.")
    apply = _jit_apply(fm)
    for mk in (None, mask):
        ref = apply(variables, jnp.asarray(x), mask=None if mk is None else jnp.asarray(mk))
        with torch.no_grad():
            got = port(torch.from_numpy(x), None if mk is None else torch.from_numpy(mk))
        assert got.dtype == torch.float32 and got.ndim == 3
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 2, 1), **TOL)


def test_dense_layer_and_transition_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 6, 11, 12)).astype(np.float32)
    nv = _n_valid(3, 11)
    fm = jdensenet.DenseLayer(4, 4, jnp.float32)
    variables = random_variables(fm, jnp.asarray(x), train=False)
    port = _port_module(densenet.DenseLayer(12, 4, 4), variables, ("block2_layer3",),
                        "res.features.denseblock2.denselayer3.", densenet_tree=True)
    apply = _jit_apply(fm)
    for mk in (None, nv):
        ref = apply(variables, jnp.asarray(x), n_valid=None if mk is None else jnp.asarray(mk))
        with torch.no_grad():
            got = port(_nchw(x), None if mk is None else torch.from_numpy(mk).long())
        assert got.shape == (3, 16, 6, 11)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                                   **TOL)

    fm = jdensenet.Transition(6, jnp.float32)
    variables = random_variables(fm, jnp.asarray(x), seed=1, train=False)
    port = _port_module(densenet.Transition(12, 6), variables, ("transition1",),
                        "res.features.transition1.", densenet_tree=True)
    ref = _jit_apply(fm)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (3, 6, 3, 5)  # VALID 2x2 pool: floor-div-2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), **TOL)


def test_tiny_densenet_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, 45)).astype(np.float32)
    mask = np.arange(45)[None, :] < np.array([45, 38, 19])[:, None]
    kw = dict(growth_rate=4, block_config=(1, 2, 1, 1), num_init_features=8)
    fm = jdensenet.DenseNet(**kw, dtype=jnp.float32)
    variables = random_variables(fm, jnp.asarray(x))
    port = _port_module(densenet.DenseNet(**kw), variables, (), "res.")
    apply = _jit_apply(fm)
    for mk in (None, mask):
        ref = apply(variables, jnp.asarray(x), mask=None if mk is None else jnp.asarray(mk))
        with torch.no_grad():
            got = port(torch.from_numpy(x), None if mk is None else torch.from_numpy(mk))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 2, 1), **TOL)
    n = torch.tensor([45, 38, 19, 1, 0])
    assert port.valid_out_frames(n).tolist() == [
        int(v) for v in fm.valid_out_frames(jnp.asarray(n.numpy()))]


def make_pair(trunk, loss="AAM", feat_dim=16, spk=10, T=48, seed=0):
    fm = FlaxSpeakerModel(spk_num=spk, feat_dim=feat_dim, trunk=trunk, loss=loss,
                          dtype=jnp.float32)
    variables = random_variables(fm, jnp.zeros((1, feat_dim, T)), seed=seed, train=False)
    tm = SpeakerModel(spk, feat_dim, loss=loss, trunk=trunk, dtype=torch.float32,
                      device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return fm, variables, tm


def jax_train_state(trunk, loss, spk, feat, frames, seed=0):
    """A flax model and a pkr_tpu TrainState from random_variables."""
    fm = FlaxSpeakerModel(spk_num=spk, feat_dim=feat, trunk=trunk, loss=loss,
                          dtype=jnp.float32)
    v = jax.tree.map(jnp.asarray, random_variables(fm, jnp.zeros((1, feat, frames)),
                                                   seed=seed, train=False))
    return fm, JaxTrainState(params=v["params"], batch_stats=v["batch_stats"],
                             opt_state=make_optimizer().init(v["params"]),
                             epoch=jnp.zeros((), jnp.int32), step=jnp.zeros((), jnp.int32),
                             best_acc1=jnp.zeros((), jnp.float32))


ZOO = [("se_resnet34", 40), ("thin_resnet34", 48), ("resnet50", 32), ("densenet62", 64)]


@pytest.mark.parametrize("trunk,T", ZOO)
def test_speaker_model_matches(trunk, T):
    fm, variables, tm = make_pair(trunk, "AAM", T=T)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16, T)).astype(np.float32)
    mask = np.ones((3, T), bool)
    mask[1, T - 7:] = False
    mask[2, T // 2:] = False
    embed = jax.jit(functools.partial(fm.apply, method=FlaxSpeakerModel.embed))
    for mk in (None, mask):
        ref = embed(variables, jnp.asarray(x), None if mk is None else jnp.asarray(mk))
        with torch.no_grad():
            got = tm.embed(torch.from_numpy(x), None if mk is None else torch.from_numpy(mk))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    labels = np.array([1, 4, 9])
    ref = jax.jit(fm.apply)(variables, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("trunk", ["se_resnet34", "densenet62"])
def test_masked_embedding_invariant_to_bucket_padding(trunk):
    """The same utterance embeds identically whatever bucket it lands in
    (tests/test_models.py's case for pkr_tpu): the SE squeeze and the pooled
    statistics of a (B, C, T') trunk exclude padded time columns."""
    torch.manual_seed(0)
    model = SpeakerModel(4, 16, trunk=trunk, loss="AAM", dtype=torch.float32,
                         device="cpu")
    rng = np.random.default_rng(11)
    T = 64
    x = rng.standard_normal((1, 16, T)).astype(np.float32)

    def emb(pad_to):
        xp = np.zeros((1, 16, pad_to), np.float32)
        xp[:, :, :T] = x
        mask = np.arange(pad_to)[None, :] < T
        with torch.no_grad():
            return model.embed(torch.from_numpy(xp), torch.from_numpy(mask)).numpy()

    e64, e96, e160 = emb(64), emb(96), emb(160)
    np.testing.assert_allclose(e96, e64, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(e160, e64, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("trunk", ALL_TRUNKS)
def test_every_trunk_loads_its_flax_tree_strictly(trunk):
    fm = FlaxSpeakerModel(spk_num=7, feat_dim=40, trunk=trunk, loss="softmax")
    shapes = jax.eval_shape(lambda: fm.init(jax.random.key(0), jnp.zeros((1, 40, 32)),
                                            train=False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = SpeakerModel(7, 40, loss="softmax", trunk=trunk, device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_flax
    # the warm start keys each tensor by its pkr_tpu path: exactly the tree's
    paths = {_reference_key(k, "softmax", trunk) for k in tm.state_dict()} - {None}
    assert paths == {tuple(p.key for p in path)
                     for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("trunk", ["se_resnet34", "resnet50"])
def test_pkr_tpu_importer_takes_every_tensor(trunk):
    fm, _, tm = make_pair(trunk, "AAM", T=32)
    template = random_variables(fm, jnp.zeros((1, 16, 32)), seed=9, train=False)
    back = state_dict_from_flax(jax_import(tm.state_dict(), template, verbose=False))
    for k, v in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


def test_unknown_trunk_raises_value_error():
    with pytest.raises(ValueError, match="densenet121.*se_resnet34|se_resnet34.*densenet121"):
        SpeakerModel(4, 16, trunk="resnet9000", device="cpu")


@pytest.mark.parametrize("trunk,flash", [("se_resnet34", False), ("se_resnet34", True),
                                         ("densenet62", False), ("densenet62", True)])
def test_two_train_steps_match_pkr_tpu(trunk, flash):
    """Two f32 train steps at B = 4, F = 16, T = 32 and 20 speakers, lr
    1e-3, from the same weights (the flash head against pkr_tpu's Pallas
    kernels in interpret mode): the losses, every parameter, the BatchNorm
    statistics and the momentum at tests/test_torch_train.py's ResNet-34
    bounds (statistics and momentum at rtol 1e-4 with an atol of 1e-3 of
    their tensor's largest entry, + 1e-6), for the reason given there: at
    this depth pkr_tpu's f32 gradients on the CPU are off an f64 evaluation
    by up to ~4e-4 of their tensor's scale.  As there, each trunk
    BatchNorm's β starts at 3 in both packages, which keeps the ReLU inputs
    after it away from zero, where either package may take the other
    branch."""
    spk, feat, frames, b = 20, 16, 32, 4
    fm, jstate = jax_train_state(trunk, "AAM", spk, feat, frames)
    jstate = _shift_trunk_bn_bias(jstate, 3.0)
    tm, tstate = port_from(jstate, "AAM", trunk, spk, feat)
    data = batches(2, seed=100, b=b, spk=spk, feat=feat, frames=frames)
    jstate, jm = run_jax(fm, jstate, data, flash, lr=1e-3)
    tstate, tmm = run_port(tm, tstate, data, flash, lr=1e-3)
    assert_metrics_match(jm, tmm)
    assert_state_matches(jstate, tm, tstate, stat_atol=1e-3)
