"""Faults planted in the timed path, to show that ``correct`` comes out
false when the step is broken underneath (the tests and
``calibrate.py`` use them; a benchmark run never does).

- ``unchanged``: the step returns the state it was given (its metrics
  are the real step's);
- ``half_batch``: the step sees only the first half of every replica's
  batch, its mean taken over that half;
- ``no_exchange``: every collective over the dc axis (between parties)
  returns the party's own contribution alone, as if nothing came from
  the others;
- ``no_grad_exchange``: the same of the dc tier's gradient exchange
  alone (Bi-Sparse's all-gather of the parties' pairs), while the dc
  means of the loss, the metrics and the running statistics stay whole.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "no_exchange",
          "no_grad_exchange")


@contextlib.contextmanager
def planted(fault, step):
    """``step`` with ``fault`` planted (None: as it is)."""
    if fault is None:
        yield step
    elif fault == "unchanged":
        yield lambda state, x, y: (state, step(state, x, y)[1])
    elif fault == "half_batch":
        def half(state, x, y):
            b = x.shape[2] // 2
            return step(state, x[:, :, :b], y[:, :, :b])
        yield half
    elif fault in ("no_exchange", "no_grad_exchange"):
        from geomx_tpu_torch.parallel import collectives as c
        psum, gather = c._psum, c._all_gather

        def own_psum(x, axis_name):
            if fault == "no_grad_exchange" or axis_name != c.DC_AXIS:
                return psum(x, axis_name)
            return x

        def own_gather(x, axis_name, tiled=False):
            out = gather(x, axis_name, tiled)
            if axis_name != c.DC_AXIS:
                return out
            P = x.shape[0]
            keep = [[float(p == q) for q in range(P)] for p in range(P)]
            mask = x.new_tensor(keep).view((P, 1, P) + (1,) * (x.dim() - 2))
            out = out.reshape(out.shape[:2] + (P,) + x.shape[2:]) * mask
            return out.flatten(2, 3) if tiled else out

        c._psum, c._all_gather = own_psum, own_gather
        try:
            yield step
        finally:
            c._psum, c._all_gather = psum, gather
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
