"""The port's checkpoints (pkr_tpu_torch.train.checkpoint) on the CPU.

- The layout and its semantics: save and restore, 'latest' and 'best', a
  re-save of an epoch into ckpt_<e>.v<k>, keep_last pruning, a legacy
  bare-epoch marker, a missing target, and a failed save re-raised.
- A pkr_tpu TrainState after two steps, carried over with
  convert.train_state_from_flax, saved and restored by the port: one more
  step in each package agrees within tests/test_torch_train.py's bounds.
- The warm starts against pkr_tpu's: from a checkpoint (softmax → AAM and
  AAM-v1, AAM → AAM at the same and at another speaker count, AAM →
  softmax) through load_pretrained and pkr_tpu's load_pretrained_variables,
  and from a reference .pth through both import_torch_checkpoint: the same
  weights exactly, the same printed messages and counts, and a softmax
  classifier never copied into the AAM weight.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from pkr_tpu.train.checkpoint import import_torch_checkpoint as jax_import
from pkr_tpu.train.checkpoint import load_pretrained_variables
from pkr_tpu.train.checkpoint import save_checkpoint as jax_save
from pkr_tpu_torch.convert import state_dict_from_flax
from pkr_tpu_torch.models import SpeakerModel
from pkr_tpu_torch.train import (create_train_state, import_torch_checkpoint,
                                 load_pretrained, restore_checkpoint, save_checkpoint,
                                 wait_for_checkpoints)

from test_torch_train import (F, assert_metrics_match, assert_state_matches, batches,
                              make_pair, port_from, run_jax, run_port)


def tiny(loss="AAM", spk=5, seed=0):
    return SpeakerModel(spk, F, loss=loss, trunk="tiny_resnet", dtype=torch.float32,
                        device="cpu", generator=torch.Generator().manual_seed(seed))


def weights(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def same(model, sd):
    return all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


def test_save_restore_best_versions_and_pruning(tmp_path):
    path = tmp_path / "ckpt"
    model = tiny()
    state = create_train_state(model)
    saved = {}
    for epoch in (1, 2, 3):
        with torch.no_grad():
            model.fc1.bias.fill_(float(epoch))
        state.epoch, state.best_acc1 = epoch, 0.1 * epoch
        state.step += 10
        save_checkpoint(str(path), model, state, is_best=(epoch == 2))
        saved[epoch] = weights(model)
    wait_for_checkpoints()
    assert (path / "latest").read_text() == "ckpt_3"
    assert sorted(p.name for p in path.iterdir()) == ["best", "ckpt_1", "ckpt_2", "ckpt_3",
                                                      "latest"]

    fresh = tiny(seed=1)
    got = restore_checkpoint(str(path), fresh, create_train_state(fresh))
    assert same(fresh, saved[3])
    assert (int(got.step), got.epoch, got.best_acc1) == (30, 3, pytest.approx(0.3))
    assert got.step.dtype == torch.int64 and sorted(got.momentum) == sorted(state.momentum)
    got = restore_checkpoint(str(path), fresh, which="best")
    assert same(fresh, saved[2]) and got.epoch == 2
    restore_checkpoint(str(path), fresh, which="1")
    assert same(fresh, saved[1])

    # a re-save of epoch 3 goes to a versioned dir; the epoch resolves to it
    with torch.no_grad():
        model.fc1.bias.fill_(33.0)
    save_checkpoint(str(path), model, state, sync=True)
    assert (path / "latest").read_text() == "ckpt_3.v1"
    restore_checkpoint(str(path), fresh, which="3")
    assert float(fresh.fc1.bias.detach()[0]) == 33.0

    # keep_last=2: the two newest ckpt_* dirs stay, and best
    state.epoch = 4
    save_checkpoint(str(path), model, state, keep_last=2)
    wait_for_checkpoints()
    assert sorted(p.name for p in path.iterdir()) == ["best", "ckpt_3.v1", "ckpt_4", "latest"]

    (path / "latest").write_text("4")  # a legacy bare-epoch marker
    assert restore_checkpoint(str(path), fresh).epoch == 4
    assert restore_checkpoint(str(path), fresh, which="9") is None
    assert restore_checkpoint(str(tmp_path / "none"), fresh) is None
    with pytest.raises(ValueError, match="momentum"):
        restore_checkpoint(str(path), fresh, create_train_state(tiny("softmax")))


def test_failed_save_is_reraised(tmp_path):
    path = tmp_path / "ckpt"
    model = tiny()
    state = create_train_state(model)
    (path / "latest").mkdir(parents=True)  # the marker cannot be written
    save_checkpoint(str(path), model, state)  # returns: the write runs behind
    with pytest.raises(IsADirectoryError):
        wait_for_checkpoints()
    wait_for_checkpoints()  # reported once
    state.epoch = 1
    with pytest.raises(IsADirectoryError):  # is_best waits, so it raises here
        save_checkpoint(str(path), model, state, is_best=True)
    assert (path / "ckpt_0" / "state.pt").exists()  # the data itself committed


@pytest.mark.parametrize("flash", [False, True])
def test_pkr_tpu_state_round_trip_then_one_step(tmp_path, flash):
    fm, jstate, _, _ = make_pair("AAM-v1", seed=3)
    jstate, _ = run_jax(fm, jstate, batches(2, seed=21), flash)
    jstate = jstate.replace(epoch=jstate.epoch + 1, best_acc1=jstate.best_acc1 + 0.5)
    tm, tstate = port_from(jstate, "AAM-v1")
    save_checkpoint(str(tmp_path), tm, tstate, sync=True)
    fresh = SpeakerModel(12, F, loss="AAM-v1", trunk="tiny_resnet", dtype=torch.float32,
                         device="cpu")
    restored = restore_checkpoint(str(tmp_path), fresh, create_train_state(fresh))
    assert (int(restored.step), restored.epoch, restored.best_acc1) == (2, 1, 0.5)
    data = batches(1, seed=22)
    jstate, jm = run_jax(fm, jstate, data, flash)
    restored, tmm = run_port(fresh, restored, data, flash)
    assert_metrics_match(jm, tmm)
    assert_state_matches(jstate, fresh, restored)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("src,dst", [(("softmax", 12), ("AAM", 12)),
                                     (("softmax", 12), ("AAM-v1", 12)),
                                     (("AAM", 12), ("AAM", 12)),
                                     (("AAM", 12), ("AAM", 10)),
                                     (("AAM", 12), ("softmax", 12))])
def test_warm_start_loads_what_pkr_tpu_loads(tmp_path, src, dst):
    (src_loss, src_spk), (dst_loss, dst_spk) = src, dst
    _, jsrc, tsrc, tsrc_state = make_pair(src_loss, seed=4, spk=src_spk)
    jax_save(str(tmp_path / "jax"), jsrc, sync=True)
    save_checkpoint(str(tmp_path / "port"), tsrc, tsrc_state, sync=True)
    _, jdst, tdst, _ = make_pair(dst_loss, seed=5, spk=dst_spk)
    before = weights(tdst)

    variables = {"params": jdst.params, "batch_stats": jdst.batch_stats}
    ref, ref_lines = _printed(load_pretrained_variables, str(tmp_path / "jax"), variables)
    loaded, lines = _printed(load_pretrained, str(tmp_path / "port"), tdst)
    assert lines[-1] == ref_lines[-1]  # 'warm start: loaded N tensors, skipped M'
    assert sorted(lines) == sorted(ref_lines)
    want = state_dict_from_flax(ref)
    got = tdst.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    assert ref_lines[-1].startswith(f"warm start: loaded {len(loaded)} tensors")
    if src_loss == "softmax" and dst_loss != "softmax":
        assert torch.equal(got["last.weight"], before["last.weight"])  # not the classifier
        assert "last.weight" not in loaded and "fc1.weight" in loaded
        assert ("bn1.weight" in loaded) == (dst_loss == "AAM-v1")

    # nothing resolves: the model is left alone, silently
    assert _printed(load_pretrained, str(tmp_path / "none"), tdst) == ([], [])


def test_pth_import_matches_pkr_tpu():
    _, _, tsrc, _ = make_pair("softmax", seed=6)
    sd = {("module." + k if i % 2 else k): v for i, (k, v) in
          enumerate(tsrc.state_dict().items())}
    sd["res.layer9.0.conv1.weight"] = torch.zeros(3)
    sd["res.extra"] = torch.zeros(3)
    sd["fc1.bias"] = torch.zeros(5)  # wrong length
    for dst_loss in ("AAM", "softmax"):
        _, jdst, tdst, _ = make_pair(dst_loss, seed=7)
        variables = {"params": jdst.params, "batch_stats": jdst.batch_stats}
        ref, ref_lines = _printed(jax_import, sd, variables)
        loaded, lines = _printed(import_torch_checkpoint, sd, tdst)
        assert lines == ref_lines
        assert "Wrong parameter length: fc1.bias, model: (256,), loaded: (5,)" in lines
        want = state_dict_from_flax(ref)
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(tdst.state_dict()[k], v), k
        # the reference's .pth classifier is the AAM weight's (C, D) layout
        np.testing.assert_array_equal(tdst.last.weight.detach().numpy(),
                                      tsrc.last.weight.detach().numpy())
        assert "last.weight" in loaded and len(lines) == len(ref_lines)
