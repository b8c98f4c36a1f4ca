"""The step clock (``geomx_tpu_torch/utils/profiler.py``): one record a
training step with its spans' host time, booked to the step and slot
that made the work, flagged under ``torch.profiler``, bounded, and read
by the benchmark's four step readers; and the program's own dc byte and
step counters against the benchmark's recorder."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.models import MLP
from geomx_tpu_torch.ops.flash_attention import fused_attention
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.parallel import collectives
from geomx_tpu_torch.telemetry.registry import get_registry
from geomx_tpu_torch.topology import DC_AXIS
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.utils.profiler import (STEP_SPAN, StepClock, span,
                                            step_clock, step_records)
from gxbench import harness, training
from gxbench.tests.tiny import ENCODER, tiny_cell

SEED = 2 ** 33 + 17
STEP_SPANS = {STEP_SPAN, "train/forward_backward", "train/forward",
              "train/backward", "train/stack", "train/sync_grads",
              "train/optimizer", "train/sync_model_state", "train/metrics"}
# the span names the benchmark's traced run reads
BENCH_SPANS = ("train/forward_backward", "train/sync_grads",
               "train/optimizer", "bsc/select_pack", "bsc/scatter_add",
               "attention/forward", "attention/backward")


def records_of(step):
    return [r for r in step_records() if r.fn == step.clock_fn]


@pytest.fixture(scope="module")
def encoder():
    """The CPU-sized encoder cell's Trainer, state and feed."""
    return training.build(tiny_cell(ENCODER), SEED, "cpu")


def _steps(start, n):
    for _ in range(n):
        x, y = start.feed.next()
        start.state, metrics = start.trainer.train_step(start.state, x, y)
    return metrics


def _mlp_trainer(mesh=None):
    cfg = GeoConfig(num_parties=2, workers_per_party=2, precision="fp32")
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return Trainer(MLP(hidden=(16,)), HiPSTopology(2, 2), sgd(0.1),
                   config=cfg, **kw)


def _mlp_batch(trainer):
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (32, 8, 8, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 32).astype(np.int32)
    state = trainer.init_state(seed=0, sample_input=x[:2])
    xb, yb = next(iter(trainer.make_loader(x, y, 4, seed=0).epoch(0)))
    return state, xb, yb


def test_one_record_a_step_with_its_spans(encoder):
    step = encoder.trainer.train_step
    before = len(records_of(step))
    _steps(encoder, 2)
    recs = records_of(step)[before:]
    assert len(recs) == 2
    for r in recs:
        assert STEP_SPANS | {"attention/forward", "attention/backward",
                             "bsc/select_pack", "bsc/scatter_add"} \
            <= set(r.host_ns), sorted(r.host_ns)
        assert r.slot is None and not r.profiled
        assert r.device_ms is None  # no events on the CPU
        h = r.host_ns
        assert r.wall_ns >= h[STEP_SPAN] >= h["train/forward_backward"] \
            >= h["train/forward"] + h["train/backward"] > 0
        assert h[STEP_SPAN] > h["train/sync_grads"] > h["bsc/select_pack"]


def test_repeated_spans_are_summed():
    clock = step_clock()
    rec = clock.open(clock.new_fn(), torch.device("cpu"))
    try:
        for _ in range(3):
            with span("test/repeat"):
                time.sleep(0.01)
        with span("test/once"):
            pass
    finally:
        clock.close(rec)
    assert rec.host_ns["test/repeat"] >= 3 * 10_000_000
    assert rec.host_ns["test/once"] < 10_000_000
    assert rec.wall_ns >= rec.host_ns["test/repeat"]
    # outside any step a span books nowhere
    with span("test/outside"):
        pass
    assert "test/outside" not in rec.host_ns


def test_a_backward_on_another_thread_is_booked_to_its_slot():
    """The card runs a backward node on its autograd thread: the
    attention's backward span counts for the mesh slot (and so the step)
    whose forward made it.  A helper thread runs the backward here."""
    mesh = HiPSTopology(2, 2).build_mesh(["cpu"] * 4, timeout_s=20.0)
    clock = step_clock()
    fn = clock.new_fn()

    def slot_step(seed):
        rec = clock.open(fn, torch.device("cpu"))
        try:
            q = torch.randn(1, 16, 2, 8, generator=torch.Generator()
                            .manual_seed(seed), requires_grad=True)
            out = fused_attention(q, q, q)
            done = []
            t = threading.Thread(target=lambda: done.append(
                torch.autograd.grad(out.sum(), q)))
            t.start()
            t.join(30)
            assert done, "the backward thread did not finish"
        finally:
            clock.close(rec)
        return rec

    recs = collectives.run_on_mesh(slot_step, mesh, [(i,) for i in
                                                     range(mesh.size)])
    assert [r.slot for r in recs] == [mesh.coords(i)
                                      for i in range(mesh.size)]
    for r in recs:
        assert set(r.host_ns) == {"attention/backward"}


def test_records_under_the_profiler_are_flagged(encoder):
    step = encoder.trainer.train_step
    before = len(records_of(step))
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(encoder, 1)
    _steps(encoder, 1)
    assert [r.profiled for r in records_of(step)[before:]] == [True, False]


def test_the_ring_keeps_the_newest_records_a_slot():
    clock = StepClock(ring=3)
    fn = clock.new_fn()
    opened = []
    for _ in range(5):
        rec = clock.open(fn, torch.device("cpu"))
        clock.close(rec)
        opened.append(rec)
    assert clock.records() == opened[-3:]


def test_slots_keep_their_own_records_under_thread_switches():
    """Eight slot threads open, fill and close records at once, the
    interpreter switching threads every microsecond: each slot's ring
    holds its own records alone, each with its own span."""
    mesh = HiPSTopology(2, 4).build_mesh(["cpu"] * 8, timeout_s=20.0)
    clock = step_clock()
    fn = clock.new_fn()

    def slot_steps():
        name = "test/slot" + "".join(map(str, collectives.current_slot()
                                         .coords))
        for _ in range(200):
            rec = clock.open(fn, torch.device("cpu"))
            with span(name):
                pass
            clock.close(rec)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        collectives.run_on_mesh(slot_steps, mesh, [()] * mesh.size)
    finally:
        sys.setswitchinterval(switch)
    recs = [r for r in step_records() if r.fn == fn]
    assert len(recs) == 200 * mesh.size
    for r in recs:
        assert list(r.host_ns) == ["test/slot" + "".join(map(str, r.slot))]


def test_one_record_set_a_slot_on_a_cpu_mesh():
    mesh = HiPSTopology(2, 2).build_mesh(["cpu"] * 4, timeout_s=20.0)
    trainer = _mlp_trainer(mesh)
    state, xb, yb = _mlp_batch(trainer)
    for _ in range(2):
        state, _ = trainer.train_step(state, xb, yb)
    recs = records_of(trainer.train_step)
    slots = [mesh.coords(i) for i in range(mesh.size)]
    assert sorted(r.slot for r in recs) == sorted(slots * 2)
    for r in recs:
        assert STEP_SPANS <= set(r.host_ns), sorted(r.host_ns)


def test_the_step_function_id_changes_on_a_membership_swap():
    trainer = _mlp_trainer()
    state, xb, yb = _mlp_batch(trainer)
    full = trainer.train_step
    state, _ = trainer.train_step(state, xb, yb)
    state = trainer.apply_membership(state, (True, False))
    degraded = trainer.train_step
    state, _ = trainer.train_step(state, xb, yb)
    assert degraded.clock_fn > full.clock_fn
    assert len(records_of(full)) == len(records_of(degraded)) == 1


def test_the_benchmarks_spans_stay_one_range_a_call(encoder, monkeypatch):
    """Under ``torch.profiler`` each span name the traced run reads is
    there, one user annotation a call: the phases once a step, the
    attention once a layer and replica each way, the Bi-Sparse pair once
    a sparse bucket."""
    calls = {}
    enter = span.__enter__

    def counted(self):
        calls[self.name] = calls.get(self.name, 0) + 1
        return enter(self)

    monkeypatch.setattr(span, "__enter__", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(encoder, 1)
    ranges, annotations = {}, set()
    for ev in prof.events():
        ranges[ev.name] = ranges.get(ev.name, 0) + 1
        if ev.is_user_annotation:
            annotations.add(ev.name)
    assert ranges == {**ranges, **calls}
    # the device trace books a kernel to the innermost user annotation:
    # the clock's own spans are host ranges, so the phases keep theirs
    assert set(BENCH_SPANS) <= annotations
    assert not annotations & {STEP_SPAN, "train/forward", "train/backward",
                              "train/stack", "train/metrics"}
    cell = tiny_cell(ENCODER)
    attention = cell.config["num_layers"] * np.prod(
        cell.workload["topology"])
    assert {n: ranges[n] for n in BENCH_SPANS} == {
        "train/forward_backward": 1, "train/sync_grads": 1,
        "train/optimizer": 1, "bsc/select_pack": ranges["bsc/threshold"],
        "bsc/scatter_add": ranges["bsc/threshold"],
        "attention/forward": attention, "attention/backward": attention}
    assert 0 < ranges["bsc/threshold"] <= len(encoder.layout.bucket_sizes)
    assert ranges[STEP_SPAN] == 1


def test_the_four_readers_read_the_tiny_encoder_cell():
    result, _ = harness.execute(tiny_cell(ENCODER), SEED, 0.5, True, "cpu",
                                time.perf_counter())
    assert result["correct"]
    metrics = result["metrics"]
    host = metrics["step_host_ms"]["value"]
    assert 0 < metrics["fwd_bwd_host_ms"]["value"] < host
    # no device events on the CPU: no device time, no headroom
    assert "step_device_ms" not in metrics
    assert "host_headroom_share" not in metrics


def test_the_program_counts_the_dc_bytes_the_recorder_counts(encoder):
    """``geomx_dc_wire_bytes_total`` and ``geomx_train_steps_total`` are
    counted by the program as it runs: the byte counter's delta is the
    benchmark recorder's count exactly."""
    reg = get_registry()
    wire = reg.counter(collectives.DC_WIRE_BYTES)
    steps = reg.counter("geomx_train_steps_total")
    wire0, steps0 = wire._solo().value, steps._solo().value
    recorder = training.DcBytes(DC_AXIS)
    prev = collectives.set_recorder(recorder)
    try:
        _steps(encoder, 3)
    finally:
        collectives.set_recorder(prev)
    assert recorder.bytes > 0
    assert wire._solo().value - wire0 == recorder.bytes
    assert steps._solo().value - steps0 == 3
