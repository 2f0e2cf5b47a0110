"""The port's tracer (``pkr_tpu_torch/utils/trace.py``) on the CPU: off
unless a profiler records or ``tracing()`` holds it on, the train step's
phases as host ranges in the profiler's trace, the ring's bound, the
host-to-device accounting and the profiler window's files."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pkr_tpu_torch.data.device_cache import DeviceCacheLoader, DeviceFeatureCache
from pkr_tpu_torch.data.sampler import BalancedRepetitionSampler
from pkr_tpu_torch.device import as_device_tensor, count_h2d
from pkr_tpu_torch.eval import make_embed_fn
from pkr_tpu_torch.frontend import wav_to_train_feats
from pkr_tpu_torch.models import SpeakerModel
from pkr_tpu_torch.train import create_train_state, make_train_step
from pkr_tpu_torch.utils import trace
from pkr_tpu_torch.utils import logging as port_logging

F, B, T = 16, 4, 32
STEP_SPANS = ["step.forward", "step.backward", "step.update", "step.bn_commit"]


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.reset()
    yield
    trace.reset()


class FakeEvent:
    """Stands in for ``torch.cuda.Event`` on the CPU: counts how many were
    made and times by the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_cuda_events(monkeypatch):
    """The tracer's device path on the CPU: CUDA counts as initialized and
    its events are FakeEvents (patched only around the tracer's use)."""
    FakeEvent.made = 0
    monkeypatch.setattr(trace.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(trace.torch.cuda, "Event", FakeEvent)
    return FakeEvent


def tiny_step(flash=False, seed=0):
    torch.manual_seed(seed)
    model = SpeakerModel(4, F, loss="AAM", trunk="tiny_resnet", dtype=torch.float32,
                         device="cpu")
    step = make_train_step(model, flash_aam=flash, device="cpu")
    state = create_train_state(model)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, F, T)).astype(np.float32)
    y = np.arange(B) % 4
    return lambda: step(state, x, y, 0.05)


def pkr_ranges(prof):
    """The profiler's ``pkr.*`` events, by start."""
    evs = [e for e in prof.events() if e.name.startswith("pkr.")]
    return sorted(evs, key=lambda e: e.time_range.start)


def test_off_a_train_step_records_nothing_and_makes_no_event(fake_cuda_events):
    run = tiny_step()
    assert not trace.enabled()
    assert trace.span("step.forward") is trace.NOOP
    run()
    trace.count("h2d.bytes", 8)
    assert trace.summary() == {"spans": {}, "counters": {}}
    assert fake_cuda_events.made == 0


@pytest.mark.parametrize("flash", [False, True])
def test_profiler_records_the_step_phases_in_order(flash):
    run = tiny_step(flash)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        run()
    assert not trace.enabled()
    run()  # off again: adds nothing
    spans = trace.summary()["spans"]
    heads = ["flash.fwd", "flash.bwd"] if flash else []
    assert sorted(spans) == sorted(STEP_SPANS + heads)
    assert all(s["n"] == 1 and len(s["host_ms"]) == len(s["device_ms"]) == 1
               for s in spans.values())
    assert all(s["device_ms"] == s["host_ms"] for s in spans.values())  # no card
    ranges = pkr_ranges(prof)
    names = [e.name[4:] for e in ranges]
    expect = (["step.forward", "flash.fwd", "step.backward", "flash.bwd"] if flash
              else ["step.forward", "step.backward"]) + ["step.update", "step.bn_commit"]
    assert names == expect
    for e in ranges:
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation
    at = {e.name[4:]: e.time_range for e in ranges}
    assert at["step.update"].start <= at["step.bn_commit"].start
    assert at["step.bn_commit"].end <= at["step.update"].end
    assert at["step.forward"].end <= at["step.backward"].start
    assert at["step.backward"].end <= at["step.update"].start
    if flash:
        assert at["step.forward"].start <= at["flash.fwd"].start
        assert at["flash.fwd"].end <= at["step.forward"].end
        assert at["step.backward"].start <= at["flash.bwd"].start
        assert at["flash.bwd"].end <= at["step.backward"].end


def test_tracing_turns_the_tracer_on_without_a_profiler():
    assert not trace.enabled()
    with trace.tracing():
        with trace.tracing():
            assert trace.enabled()
        assert trace.enabled()
        with trace.span("a"):
            with trace.span("b"):
                pass
        trace.count("c", 3)
        trace.count("c", 4)
    assert not trace.enabled()
    with trace.span("a"):
        trace.count("c", 100)
    s = trace.summary()
    assert {k: v["n"] for k, v in s["spans"].items()} == {"a": 1, "b": 1}
    assert s["spans"]["a"]["host_ms"][0] >= s["spans"]["b"]["host_ms"][0] >= 0.0
    assert s["counters"] == {"c": 7}
    trace.reset()
    assert trace.summary() == {"spans": {}, "counters": {}}


def test_the_ring_bounds_the_records_and_recycles_events(fake_cuda_events):
    n = trace.RING + 5
    with trace.tracing():
        for _ in range(n):
            with trace.span("x"):
                pass
    s = trace.summary()["spans"]["x"]
    assert s["n"] == n
    assert len(s["host_ms"]) == len(s["device_ms"]) == trace.RING
    assert all(ms >= 0.0 for ms in s["device_ms"])
    # two events a span until the ring is full, then the evicted ones again
    assert fake_cuda_events.made == 2 * trace.RING + 2
    trace.reset()
    with trace.tracing(), trace.span("y"):
        pass
    assert fake_cuda_events.made == 2 * trace.RING + 2  # reset gave them back


def test_h2d_accounting_counts_host_bytes_to_a_card():
    t = torch.zeros((3, 5), dtype=torch.float32)
    with trace.tracing():
        assert count_h2d(t, torch.device("cuda")) == 60
        assert count_h2d(torch.zeros(7, dtype=torch.int64), "cuda") == 56
        assert count_h2d(t, torch.device("cpu")) == 0  # no copy to a card
        as_device_tensor(np.zeros((2, 2), np.float32), torch.device("cpu"))
    assert count_h2d(t, torch.device("cuda")) == 60  # off: counted nowhere
    s = trace.summary()
    assert s["counters"] == {"h2d.bytes": 116, "h2d.pageable_bytes": 116}
    assert "h2d" not in s["spans"]  # a copy within the host is no h2d span


def test_loader_frontend_and_embed_spans():
    rng = np.random.default_rng(1)
    mats = {f"u{i}": rng.standard_normal((40 + 7 * i, F)).astype(np.float32) for i in range(8)}
    utts = list(mats)
    labels = {u: i % 4 for i, u in enumerate(utts)}
    cache = DeviceFeatureCache.build(mats, labels, device="cpu")
    loader = DeviceCacheLoader(cache, BalancedRepetitionSampler(utts, [labels[u] for u in utts]),
                               B, chunk=T, seed=3, device="cpu")
    torch.manual_seed(0)
    model = SpeakerModel(4, 40, trunk="tiny_resnet", dtype=torch.float32, device="cpu")
    embed = make_embed_fn(model, device="cpu")
    wav = (rng.standard_normal((2, 8000)) * 1000).astype(np.float32)
    with trace.tracing():
        n = 0
        for _ in loader.epoch(0):
            n += 1  # each batch's span has closed by the time it is yielded
            assert trace.summary()["spans"]["loader.batch"]["n"] == n
        feats, mask, _ = wav_to_train_feats(wav, np.array([8000, 6000]), device="cpu")
        embed(feats.permute(0, 2, 1).contiguous(), mask)
    spans = trace.summary()["spans"]
    assert n > 0 and spans["loader.batch"]["n"] == n
    assert spans["frontend"]["n"] == 1 and spans["extract.embed"]["n"] == 1


def test_profile_trace_writes_the_trace_and_its_summary(tmp_path):
    assert port_logging.profile_trace is trace.profile_trace
    trace.reset()
    with trace.tracing(), trace.span("before"):
        pass  # a window starts from nothing
    out = tmp_path / "prof"
    with trace.profile_trace(str(out)) as prof:
        assert prof is not None and trace.enabled()
        with trace.span("inside"):
            trace.count("n", 2)
    files = sorted(os.listdir(out))
    assert [f.split("_")[0] for f in files] == ["spans", "trace"]
    assert files[0][len("spans"):] == files[1][len("trace"):]
    got = json.loads((out / files[0]).read_text())
    assert got["spans"]["inside"]["n"] == 1 and "before" not in got["spans"]
    assert got["counters"] == {"n": 2}
    assert json.loads((out / files[1]).read_text())  # the Chrome trace
    with trace.profile_trace(None) as none:
        assert none is None
