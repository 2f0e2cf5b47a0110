"""The result line has its fixed keys, ``checks`` last, and a run
without a card prints no result and exits non-zero."""

import json

import pytest

from portbench import manifest, run

BENCH = json.loads((manifest.HERE.parent / "BENCHMARK.json").read_text())


def _out(trace):
    return {"correct": True, "attempted": 10, "failed": 0,
            "e2e": {"train_examples_per_s": 1.0, "train_step_ms_p95": 2.0, "setup_s": 3.0,
                    "not_a_metric_of_the_cell": 4.0},
            "records": {"kind": "train", "untraced_step_ms": [100.0], "train_flops": 3.48e12,
                        "loader_ms": [0.5],
                        "trace": {"busy_s": 0.9, "window_s": 1.0,
                                  "by_name_s": {"bn_fw_tr_1C11_kernel": 0.3, "gemm": 0.6}},
                        "trace_steps": 6},
            "checks": [["loss_gap", 0.001, 0.01]],
            "breakdown": {"device_ops": [["gemm", 0.6]], "idle_gaps": [["aten::copy_", 0.1]]}
            if trace else None}


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(trace):
    cell = manifest.resolve(BENCH, "r34_aam7325.train")
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 1}
    line = run.result_line(cell, _out(trace), trace, dev)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["checks"] == {"loss_gap": {"value": 0.001, "limit": 0.01}}
    if trace:
        assert set(line["metrics"]) == {"train_mfu", "loader_ms.train", "bn_ms.train",
                                        "idle_share.train"}
        assert line["metrics"]["idle_share.train"]["unit"] == "%"
    else:
        assert set(line["metrics"]) == {"train_examples_per_s", "train_step_ms_p95", "setup_s"}
    json.dumps(line)


def test_line_is_strict_json_when_a_reading_is_inf():
    cell = manifest.resolve(BENCH, "r34_aam7325.train")
    out = dict(_out(False), correct=False, checks=[["crops_gap", float("inf"), 0.0]])
    line = run.result_line(cell, out, False, {})
    assert line["checks"]["crops_gap"]["value"] > 1e300
    json.dumps(line, allow_nan=False)


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "r34_aam7325.train", "--seed", str(2 ** 31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "pkr_tpu_torch_like", types.ModuleType("x"))
    assert "pkr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("y"))
    assert "jaxlib" in run.forbidden_modules()
