"""One run of a training cell: set-up, the measured window, the traced
stretch, and the comparison with the reference.

Set-up builds one Trainer from the workload (``recipe.py``) on weights the
benchmark drew (``inputs.py``), and drives it through its first steps
with the window's own call (``Trainer.train_step``) and feed, reading the
loss once a step as the port's examples do.  Those steps warm up every
shape the window runs and are the steps the reference follows: their
losses, the gradient the optimizer got at the first (from its state after
it) and the running statistics after it, and the change of the weights
after the last are kept.  The same
Trainer and state then run the window: steps for ``--seconds`` on the
host clock, each on a new batch.  With ``--trace 1`` a fixed number of
further steps run under ``torch.profiler``.  Once the window has closed
and the device's peak memory is read, the program's state is freed and
the reference follows the first steps (``reference/hips.py``).

A recorder in the program's collectives slot counts, for the whole run,
the bytes of one replica's block of every collective over the ``dc``
axis: what one party puts on the WAN tier.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch.profiler import record_function

from gxbench import compare, faults, inputs, recipe
from gxbench.reference import hips
from gxbench.reference.layout import Layout
from gxbench.trace import WINDOW_SPAN, Trace


class DcBytes:
    """The recorder: bytes of one replica's block of each dc collective."""

    def __init__(self, dc_axis: str):
        self.dc_axis = dc_axis
        self.bytes = 0

    def __call__(self, op, axis, x, lead, extras=()):
        if axis == self.dc_axis:
            self.bytes += math.prod(x.shape[lead:]) * x.element_size()


@dataclass
class Outcome:
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    samples_per_step: int = 0
    step_s: List[float] = field(default_factory=list)
    failed: int = 0
    dc_bytes: int = 0
    trace: Optional[Trace] = None
    memory_peak_bytes: int = 0
    readings: dict = field(default_factory=dict)

    @property
    def samples_per_s(self) -> float:
        return self.steps * self.samples_per_step / self.window_s


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_first_grad(opt_state, workload: dict, layout: Layout):
    """The gradient the optimizer got at the first step, by leaf
    ``[P, W, ...]``, from its state after that step."""
    opt = workload["optimizer"]
    if opt["kind"] == "sgd":
        buf, scale = opt_state["trace"], 1.0
    else:
        buf, scale = opt_state["mu"], 1.0 / (1.0 - opt.get("b1", 0.9))
    if isinstance(buf, (list, tuple)):        # the fused apply's buckets
        buf = layout.unflatten(list(buf))
    return {k: v * scale for k, v in buf.items()}


def check_param_layout(model, specs) -> None:
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    want = {name: tuple(shape) for name, shape, _, _ in specs}
    if got != want:
        raise ValueError(f"the program's leaves {sorted(got.items())} are "
                         f"not the reference's {sorted(want.items())}")


@dataclass
class Start:
    """What the benchmark hands the program, and the program built on it."""

    params0: dict        # the initial weights
    state0: dict         # the initial running statistics
    layout: Layout       # the dc tier's buckets, recomputed
    trainer: object = None
    state: object = None
    feed: object = None


def inputs_for(cell, seed: int, device) -> Start:
    specs = cell.reference.param_specs(cell.config)
    return Start(params0=inputs.make_tree(specs, seed, "weights", device),
                 state0=inputs.make_tree(
                     cell.reference.state_specs(cell.config), seed, "state",
                     device),
                 layout=Layout({n: s for n, s, _, _ in specs},
                               cell.workload["bucket_bytes"]),
                 feed=inputs.Feed(cell.workload, seed, device))


def build(cell, seed: int, device) -> Start:
    """The Trainer and its state on the benchmark's weights, and the feed."""
    start = inputs_for(cell, seed, device)
    model = cell.family.program_model(cell.config)
    check_param_layout(model, cell.reference.param_specs(cell.config))
    start.trainer = recipe.make_trainer(model, cell.workload, device)
    start.state = start.trainer.init_state(params=start.params0,
                                           model_state=start.state0)
    return start


def check_steps(step, start: Start, workload):
    """The first steps: ``(state, snapshot, batches)``."""
    snap = {"loss": []}
    batches = []
    state = start.state
    for s in range(workload["check_steps"]):
        x, y = start.feed.next()
        batches.append((x, y))
        state, metrics = step(state, x, y)
        snap["loss"].append(float(metrics["loss"]))
        if s == 0:
            snap["first_grad"] = compare.replica_norms(program_first_grad(
                state.opt_state, workload, start.layout))
            snap["state"] = {k: v.detach().clone()
                             for k, v in state.model_state.items()}
    snap["change"] = compare.replica_norms(
        {k: state.params[k] - start.params0[k] for k in start.params0})
    return state, snap, batches


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault: Optional[str] = None) -> Outcome:
    from geomx_tpu_torch.parallel import collectives
    from geomx_tpu_torch.topology import DC_AXIS

    out = Outcome()
    wl = cell.workload
    P, W = wl["topology"]
    out.samples_per_step = P * W * wl["batch_per_replica"]
    counter = DcBytes(DC_AXIS)
    prev = collectives.set_recorder(counter)
    try:
        start = build(cell, seed, device)
        feed = start.feed
        with faults.planted(fault, start.trainer.train_step) as step:
            state, snap, batches = check_steps(step, start, wl)
            _sync(device)
            out.setup_s = time.perf_counter() - t0

            counter.bytes = 0
            t_start = last = time.perf_counter()
            while True:
                x, y = feed.next()
                state, metrics = step(state, x, y)
                loss = float(metrics["loss"])
                now = time.perf_counter()
                out.step_s.append(now - last)
                last = now
                out.steps += 1
                out.failed += not math.isfinite(loss)
                if now - t_start >= seconds:
                    break
            _sync(device)
            out.window_s = time.perf_counter() - t_start
            out.dc_bytes = counter.bytes

            if trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.device(device).type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                n = wl["profile_steps"]
                with profile(activities=acts) as prof:
                    with record_function(WINDOW_SPAN):
                        for _ in range(n):
                            with record_function("gxbench/feed"):
                                x, y = feed.next()
                            state, metrics = step(state, x, y)
                            with record_function("gxbench/loss_read"):
                                float(metrics["loss"])
                        _sync(device)
                out.trace = Trace.from_profiler(prof, n)
                del prof
        if torch.device(device).type == "cuda":
            out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    finally:
        collectives.set_recorder(prev)
    # the program's state goes before the reference runs
    start.trainer = start.state = start.feed = None
    del state, step, metrics, feed, x, y
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = hips.reference_steps(cell.reference, cell.config, wl,
                               start.params0, batches, "fp32", start.state0)
    out.readings = compare.readings(snap, ref)
    return out
