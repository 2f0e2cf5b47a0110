"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and new entries, and the harness finds them by name with no
file that was there edited."""

import hashlib
import json
import shutil

from portbench import manifest

ROOT = manifest.HERE.parent


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_cell_and_metric(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(pb)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((pb / "configs" / "resnet34_aam_v2.json").read_text())
    cfg.update(name="resnet18_aam_v2", trunk="resnet18")
    (pb / "configs" / "resnet18_aam_v2.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "train_cache_b256.json").read_text())
    mix.update(batch=128)
    (pb / "traffic" / "train_cache_b128.json").write_text(json.dumps(mix))
    (pb / "layer_metrics" / "steps_seen.train.py").write_text(
        "def read(records):\n    ms = records.get('step_ms')\n    return len(ms) if ms else None\n")
    (pb / "limits" / "r18_aam7325.train_b128.json").write_text(json.dumps({"checks": {"loss_gap": 1}}))
    bench["configs"].append({"name": "resnet18_aam_v2", "source": "https://example.org/r18",
                             "file": "portbench/configs/resnet18_aam_v2.json", "reduced": [],
                             "why": "a second trunk"})
    bench["workloads"].append({"name": "r18_aam7325.train_b128", "config": "resnet18_aam_v2",
                               "traffic": "train_cache_b128", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_examples_per_s",
                               "workloads": ["r18_aam7325.train_b128"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "r34_aam7325.train" in m["workloads"]:
            m["workloads"].append("r18_aam7325.train_b128")

    cell = manifest.resolve(bench, "r18_aam7325.train_b128", root=pb)
    assert cell.config["trunk"] == "resnet18" and cell.traffic["batch"] == 128
    assert cell.driver.__file__ == str(pb / "drivers" / "train.py")
    assert cell.limits == {"checks": {"loss_gap": 1}}
    assert {m["name"] for m in cell.per_layer} == {"steps_seen.train"}
    assert {m["name"] for m in cell.end_to_end} == {"train_examples_per_s", "train_step_ms_p95",
                                                    "setup_s"}
    got = manifest.read_layer_metrics(cell.per_layer, {"kind": "train", "step_ms": [1.0, 2.0],
                                                       "untraced_step_ms": [1.0],
                                                       "train_flops": 1e9}, root=pb)
    assert got["steps_seen.train"] == {"value": 2.0, "unit": "steps"}
    assert "bn_ms.train" not in got  # its reader found nothing to read
    old = manifest.resolve(bench, "r34_aam7325.train", root=pb)
    assert "steps_seen.train" not in {m["name"] for m in old.per_layer}
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
