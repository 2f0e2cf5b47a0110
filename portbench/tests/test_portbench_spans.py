"""The readers of the per-layer metrics on the program's own spans and
counters (``portbench/spans.py``): None on an empty summary, on the other
cell's records and on a program without the tracer; the mean a train step
or an embed batch on a planted summary."""

import sys

import pytest

from portbench import manifest, spans

TRAIN = {"kind": "train"}
EMBED = {"kind": "embed"}


def planted():
    """Four train steps and two embed batches, the h2d ring holding the
    last four of its eight occurrences."""
    return {"spans": {
        "step.forward": {"n": 4, "host_ms": [1.0] * 4, "device_ms": [30.0, 31.0, 32.0, 33.0]},
        "step.backward": {"n": 4, "host_ms": [1.0] * 4, "device_ms": [50.0] * 4},
        "step.update": {"n": 4, "host_ms": [1.0] * 4, "device_ms": [10.0, 12.0, 10.0, 12.0]},
        "step.bn_commit": {"n": 4, "host_ms": [1.0] * 4, "device_ms": [4.0] * 4},
        "h2d": {"n": 8, "host_ms": [1.0, 2.0, 3.0, 2.0], "device_ms": [0.1] * 4},
        "extract.embed": {"n": 2, "host_ms": [5.0] * 2, "device_ms": [20.0, 22.0]},
    }, "counters": {"h2d.bytes": 100_033_088, "h2d.pageable_bytes": 100_033_088}}


CASES = [  # reader, records, value on planted()
    ("fwd_ms.train", TRAIN, 31.5),
    ("bwd_ms.train", TRAIN, 50.0),
    ("update_ms.train", TRAIN, 11.0),
    ("bn_commit_ms.train", TRAIN, 4.0),
    ("h2d_host_ms.train", TRAIN, 4.0),  # 8 copies of 2 ms over 4 steps
    ("h2d_host_ms.embed", EMBED, 8.0),  # 8 copies of 2 ms over 2 batches
    ("h2d_mb.embed", EMBED, 50.016544),
    ("trunk_ms.embed", EMBED, 21.0),
]


def reader(name):
    return manifest.load_module(manifest.reader_path(name), "test_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,records,value", CASES, ids=[c[0] for c in CASES])
def test_reader_on_a_planted_summary(name, records, value):
    r = reader(name)
    assert r.read(records, planted()) == pytest.approx(value, rel=1e-12)
    other = EMBED if records is TRAIN else TRAIN
    assert r.read(other, planted()) is None  # the other cell's records


@pytest.mark.parametrize("name,records,value", CASES, ids=[c[0] for c in CASES])
def test_reader_finds_nothing(name, records, value, monkeypatch):
    r = reader(name)
    assert r.read(records, {"spans": {}, "counters": {}}) is None
    unitless = planted()
    del unitless["spans"][spans.TRAIN_UNIT if records is TRAIN else spans.EMBED_UNIT]
    assert r.read(records, unitless) is None
    monkeypatch.setitem(sys.modules, "pkr_tpu_torch.utils.trace", None)  # a program without it
    assert spans.program_summary() is None
    assert r.read(records) is None


def test_the_entries_name_their_readers():
    bench = manifest.load_json(manifest.HERE.parent / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, records, _ in CASES:
        m = entries[name]
        cell = "r34_aam7325.train" if records is TRAIN else "r34_aam7325.embed6s"
        assert m["workloads"] == [cell]
        assert m["source"] == ("program_counter" if name == "h2d_mb.embed" else "program_span")
        assert manifest.reader_path(name).exists()


def test_the_program_s_tracer_feeds_the_train_cell_s_readers():
    """A run's own summary, through the manifest as ``run.py`` reads it."""
    from pkr_tpu_torch.utils import trace

    cell = manifest.resolve(manifest.load_json(manifest.HERE.parent / "BENCHMARK.json"),
                            "r34_aam7325.train")
    trace.reset()
    try:
        with trace.tracing():
            for _ in range(3):
                for name in ("step.forward", "step.backward", "h2d"):
                    with trace.span(name):
                        pass
        got = manifest.read_layer_metrics(cell.per_layer, {"kind": "train"})
    finally:
        trace.reset()
    assert {"fwd_ms.train", "bwd_ms.train", "h2d_host_ms.train"} <= set(got)
    assert "update_ms.train" not in got and "bn_ms.train" not in got  # nothing to read
    assert all(v["unit"] == "ms" and v["value"] >= 0.0 for v in got.values())
