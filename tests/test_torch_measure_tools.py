"""The port's measuring tools (pkr_tpu_torch.tools.bench_stage1,
.train_roofline) against tools/bench_stage1.py and tools/train_roofline.py,
on the CPU.

- bench_stage1: the corpus, pools and RIR tree equal the JAX tool's (wav
  samples array-equal, pool arrays equal); a tiny run prints its three rows,
  the worker sweep and the JSON line;
- train_roofline: conv_layers() is the JAX tool's list; its FLOPs (with
  fc1 and the head) × 3 × 256 are bench.py's resnet34_train_flops; forward
  hooks on the port's resnet34 at a batch of 2 give the same per-layer
  FLOPs in the same order; one conv pass's and one BatchNorm's floor by
  hand; --no-measure prints its JSON line without a card, and a
  measurement without a card raises.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pkr_tpu.io.wav import read_wav as jax_read_wav
from pkr_tpu_torch.io.wav import read_wav
from pkr_tpu_torch.tools import bench_stage1 as bs
from pkr_tpu_torch.tools import train_roofline as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wavs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".wav"))


def test_bench_stage1_data_matches_jax_tool(tmp_path):
    tool = _load("tools/bench_stage1.py", "jax_tool_bench_stage1")
    ref_dd, ref_clean = tool.build_corpus(str(tmp_path / "jax"), 10, 0.5)
    got_dd, got_clean = bs.build_corpus(str(tmp_path / "port"), 10, 0.5)
    assert got_dd["utt2spk"] == ref_dd["utt2spk"]
    ref_tree, ref_nl = tool.build_rir_tree(str(tmp_path / "jax"))
    got_tree, got_nl = bs.build_rir_tree(str(tmp_path / "port"))
    assert open(got_nl).read() == open(ref_nl).read()
    names = _wavs(str(tmp_path / "jax"))
    assert _wavs(str(tmp_path / "port")) == names and len(names) == 10 + 12 + 2
    for rel in names:
        a, _ = read_wav(str(tmp_path / "port" / rel))
        b, _ = jax_read_wav(str(tmp_path / "jax" / rel))
        np.testing.assert_array_equal(a, b, err_msg=rel)
    ref, got = tool.build_pools(), bs.build_pools(device="cpu")
    assert sorted(got.pools) == sorted(ref.pools)
    for kind in ref.pools:
        for a, b in zip(got.pools[kind], ref.pools[kind]):
            np.testing.assert_array_equal(a, b, err_msg=kind)
    for a, b in zip(got.rirs, ref.rirs):
        np.testing.assert_array_equal(a, b)


def test_bench_stage1_tiny_run_on_the_cpu(tmp_path, capsys):
    assert bs.main(["--utts", "4", "--sec", "1.0", "--out", str(tmp_path),
                    "--encode-workers", "1", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["clean", "aug", "rir"]
    assert [ln.split(":")[0] for ln in lines[3:5]] == ["encode_workers=1", "encode_workers=2"]
    out = json.loads(lines[-1])
    assert out["card"] == "cpu" and out["device"] == "cpu"
    rows = out["bench_stage1"]["rows"]
    assert {k: v["utts"] for k, v in rows.items()} == {"clean": 4, "aug": 8, "rir": 8}
    assert all(v["utts_per_s"] > 0 for v in rows.values())
    assert [w["workers"] for w in out["bench_stage1"]["encode_workers"]] == [1, 2]


def test_conv_layers_match_jax_tool():
    ref = _load("tools/train_roofline.py", "jax_tool_train_roofline").conv_layers()
    assert tr.conv_layers() == ref and len(ref) == 36


def test_train_flops_equal_bench_formula():
    """conv_layers() × 3 × 256 with fc1 and the 7325-class head is bench.py's
    resnet34_train_flops(256, 40, 200) (which counts those two matmuls too),
    and the copy of it in chip_smoke.py."""
    bench = _load("bench.py", "bench_for_flops")
    smoke = _load("chip_smoke.py", "chip_smoke_for_flops")
    conv = 3 * 256 * sum(f for f, _, _ in tr.conv_layers())
    linear = 3 * 256 * sum(f for f, _, _ in tr.linear_layers())
    assert conv + linear == bench.resnet34_train_flops(256, 40, 200)
    assert tr.train_flops() == bench.resnet34_train_flops(256, 40, 200)
    assert tr.train_flops() == smoke.resnet34_train_flops(256, 40, 200)


def test_hooked_conv_flops_match_conv_layers():
    """Forward hooks on every nn.Conv2d of the port's resnet34 at a batch of
    2 × 40 × 200: per-example FLOPs from each output's shape, in the order
    the forward runs them, equal conv_geometry()'s, name by name."""
    from pkr_tpu_torch.models import SpeakerModel

    model = SpeakerModel(7325, 40, "mean+std", "AAM", trunk="resnet34",
                         dtype=torch.float32, device="cpu")
    names = {m: n for n, m in model.named_modules()}
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((names[m], i[0].shape, 2.0 * m.kernel_size[0]
                                     * m.kernel_size[1] * m.in_channels * m.out_channels
                                     * o.shape[2] * o.shape[3] * o.shape[0])))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model.embed(torch.zeros(2, 40, 200))
    finally:
        for h in hooks:
            h.remove()
    geo = tr.conv_geometry()
    assert [n for n, _, _ in seen] == [c.name for c in geo]
    assert [f * 256 / 2 for _, _, f in seen] == [256 * c.flops for c in geo]
    assert [tuple(s[1:]) for _, s, _ in seen] == [(c.c_in, c.h_in, c.w_in) for c in geo]


def test_floors_by_hand():
    """layer1.0.conv1's forward: 2·9·32·32·40·200·256 FLOPs (0.0381 ms at
    989 TFLOP/s) against reading x and w and writing y in bf16, 262,162,432
    bytes (0.0783 ms at 3.35 TB/s): bound by bytes.  The stem's BatchNorm
    forward reads and writes 256·32·40·200 bf16 values."""
    items = {it.name: it for it in tr.conv_items()}
    fwd = items["res.layer1.0.conv1.fwd"]
    assert fwd.flops == 2 * 9 * 32 * 32 * 40 * 200 * 256
    x = y = 256 * 32 * 40 * 200 * 2
    assert fwd.nbytes == x + 32 * 32 * 9 * 2 + y == 262_162_432
    assert fwd.bound_by == "bytes"
    assert fwd.ms == pytest.approx(1e3 * 262_162_432 / 3.35e12, rel=1e-12)
    assert items["res.layer1.0.conv1.wgrad"].nbytes == x + y + 32 * 32 * 9 * 4
    assert "res.conv1.dgrad" not in items  # the features need no gradient
    assert len(items) == 3 * 36 - 1
    model = tr.build_model("cpu")
    rec = tr.census(model, batch=2)
    rest = {it.name: it for it in tr.rest_items(rec, 4.0 * sum(
        p.numel() for p in model.parameters()))}
    bn = rest["bn1.fwd"]
    assert rec["bn"][0][0] == "bn1" and rec["bn"][0][1][1] == torch.bfloat16
    assert bn.nbytes == 256 * 32 * 40 * 200 * (2 + 2)
    assert rest["bn1.bwd"].nbytes == 256 * 32 * 40 * 200 * 2 * 3
    assert len(rec["bn"]) == 1 + 2 * 16 + 3 and len(rec["block"]) == 16


def test_no_measure_prints_json_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tr.main(["--no-measure"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["floor_ms"]) == set(tr.BUCKETS) and out["floor_ms"]["layout"] == 0.0
    assert out["floor_step_ms"] == pytest.approx(sum(out["floor_ms"].values()))
    assert out["conv_passes"] == 107 and out["card"] == "not measured"
    assert out["train_flops"] == tr.train_flops()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.main([])
