"""On the card: the program's step clock at the encoder cell.  A step
issues its work without one synchronizing call, so the clock's host time
is issue time, not a wait; its two events give a device time; and the
program's dc byte counter is the benchmark recorder's count at the full
cell.  Skips without an NVIDIA GPU; run it there with
``python -m pytest -p no:cacheprovider gxbench/tests -m cuda``."""

from __future__ import annotations

import pytest

from gxbench import training
from gxbench.cell import load_cell
from gxbench.tests.tiny import ENCODER, tiny_cell

SEED = 2 ** 33 + 29


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels")
    return torch.device("cuda", 0)


def _step(start):
    x, y = start.feed.next()
    start.state, metrics = start.trainer.train_step(start.state, x, y)
    return metrics


@pytest.mark.cuda
def test_a_step_makes_no_synchronizing_call(cuda):
    import torch

    from geomx_tpu_torch.utils.profiler import step_records
    start = training.build(tiny_cell(ENCODER), SEED, cuda)
    for _ in range(2):  # the extension, the kernels' first calls
        float(_step(start)["loss"])
    x, y = start.feed.next()
    torch.cuda.synchronize(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.state, metrics = start.trainer.train_step(start.state, x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    float(metrics["loss"])
    rec = [r for r in step_records()
           if r.fn == start.trainer.train_step.clock_fn][-1]
    assert rec.device_ms is not None and rec.device_ms > 0
    assert rec.host_ns["train/train_step"] > 0


@pytest.mark.cuda
def test_the_program_counts_the_cells_dc_bytes(cuda):
    from geomx_tpu_torch.parallel import collectives
    from geomx_tpu_torch.telemetry.registry import get_registry
    from geomx_tpu_torch.topology import DC_AXIS
    start = training.build(load_cell(ENCODER), SEED, cuda)
    float(_step(start)["loss"])
    wire = get_registry().counter(collectives.DC_WIRE_BYTES)
    before = wire._solo().value
    recorder = training.DcBytes(DC_AXIS)
    prev = collectives.set_recorder(recorder)
    try:
        for _ in range(3):
            float(_step(start)["loss"])
    finally:
        collectives.set_recorder(prev)
    print(f"dc bytes a step: program {(wire._solo().value - before) / 3}, "
          f"recorder {recorder.bytes / 3}")
    assert wire._solo().value - before == recorder.bytes > 0
