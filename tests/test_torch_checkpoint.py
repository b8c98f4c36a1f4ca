"""Port checkpoints: the atomic write and the JAX package's envelope, a
bit-exact resume in the port (FSA with BSC, the pipelined sync with its
in-flight buffer, ZeRO on the same topology, the fused Adam), the ZeRO
re-shard 2x4 -> 2x2 against the JAX package's ``reshard_zero_state`` on
the same host arrays, and the GEOMX_ZERO mismatch error.

Tolerance: none.  A resumed run must give the uninterrupted run's bits,
and the re-shard must give the JAX function's arrays exactly.  Inputs
are seeded numpy arrays; the model is the port's MLP on 8x8x3 images,
as the JAX package's ZeRO checkpoint tests use.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.train.state import TrainState as JaxState
from geomx_tpu.train.zero import reshard_zero_state as jax_reshard
from geomx_tpu.utils.checkpoint import load_checkpoint as jax_load
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.ops.optim import fused_optimizer
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.train.zero import reshard_zero_state
from geomx_tpu_torch.utils import atomicio
from geomx_tpu_torch.utils.checkpoint import (load_checkpoint,
                                              save_checkpoint, to_host)

torch.set_num_threads(2)

P_ = 2


def _data(steps, nw, seed=0, same_per_worker=False):
    rng = np.random.RandomState(seed)
    w = 1 if same_per_worker else nw
    x = (rng.rand(steps, P_, w, 2, 8, 8, 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, size=(steps, P_, w, 2)).astype(np.int64)
    if same_per_worker:
        # identical per-worker batches: the two-tier mean is then
        # invariant to the worker count
        x = np.broadcast_to(x, (steps, P_, nw, 2, 8, 8, 3)).copy()
        y = np.broadcast_to(y, (steps, P_, nw, 2)).copy()
    return x, y


def _trainer(nw=4, tx=None, **fields):
    cfg = GeoConfig(num_parties=P_, workers_per_party=nw, precision="fp32",
                    **fields)
    return Trainer(get_model("mlp"), HiPSTopology(P_, nw),
                   tx or sgd(0.1, momentum=0.9), config=cfg, device="cpu")


def _run(tr, st, xs, ys, drain=False):
    for x, y in zip(xs, ys):
        st, _ = tr.train_step(st, torch.from_numpy(x), torch.from_numpy(y))
    return tr.drain_pipeline(st) if drain else st


def _equal_trees(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _equal_trees(u, v, f"{path}[{i}]")
    else:
        assert a == b, path


def test_atomic_write_envelope_and_meta(tmp_path):
    tr = _trainer(zero=True)
    xs, ys = _data(1, 4)
    st = tr.init_state(sample_input=xs[0, 0, 0])
    path = tr.save_checkpoint(str(tmp_path / "ck"), st, step=3)
    assert path == str(tmp_path / "ck" / "step_3.ckpt")
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.startswith(".atomic_")]
    raw = open(path, "rb").read()
    # numpy and pickle alone read it: no torch tensor, no class of ours
    assert b"torch" not in raw and b"geomx_tpu_torch" not in raw
    obj = pickle.loads(raw)
    assert obj["__geomx_ckpt__"] == 1
    assert obj["meta"] == {"zero": True, "num_parties": 2,
                           "workers_per_party": 4} == tr.checkpoint_meta()
    assert set(obj["tree"]) == {"step", "params", "opt_state",
                                "model_state", "sync_state"}
    assert isinstance(obj["tree"]["params"]["Dense_0.kernel"], np.ndarray)
    # the JAX package's loader reads the envelope too
    tree, meta = jax_load(path, with_meta=True)
    assert meta == obj["meta"]
    np.testing.assert_array_equal(tree["params"]["Dense_0.kernel"],
                                  st.params["Dense_0.kernel"].numpy())
    # a meta-less save is the bare tree; a failed write leaves nothing
    bare = save_checkpoint(str(tmp_path / "bare"), {"a": torch.ones(2)})
    assert pickle.loads(open(bare, "rb").read())["a"].tolist() == [1, 1]
    with pytest.raises(ZeroDivisionError):
        with atomicio.atomic_replace(str(tmp_path / "x.bin")) as f:
            f.write(b"partial")
            1 / 0
    assert not (tmp_path / "x.bin").exists()
    assert [p.name for p in tmp_path.iterdir()
            if p.name.startswith(".atomic_")] == []


@pytest.mark.parametrize("case", ["fsa_bsc", "pipelined_bsc",
                                  "zero_pipelined", "fused_adam_bsc"])
def test_resume_is_bit_exact(tmp_path, case):
    fields = {"fsa_bsc": dict(compression="bsc,0.01"),
              "pipelined_bsc": dict(compression="bsc,0.01",
                                    pipeline_depth=1),
              "zero_pipelined": dict(zero=True, pipeline_depth=1),
              "fused_adam_bsc": dict(compression="bsc,0.01",
                                     fused_optim=True)}[case]
    tx = fused_optimizer("adam", learning_rate=0.01) \
        if case == "fused_adam_bsc" else None
    drain = "pipelined" in case
    xs, ys = _data(6, 4)
    tr = _trainer(tx=tx, **fields)
    st = _run(tr, tr.init_state(sample_input=xs[0, 0, 0]), xs[:3], ys[:3])
    path = tr.save_checkpoint(str(tmp_path / "mid"), st)
    full = _run(tr, st, xs[3:], ys[3:], drain=drain)

    tr2 = _trainer(tx=tx, **fields)
    template = tr2.init_state(seed=5, sample_input=xs[0, 0, 0])
    st2 = tr2.load_checkpoint(path, template)
    _equal_trees(dataclasses.asdict(st2), dataclasses.asdict(st))
    resumed = _run(tr2, st2, xs[3:], ys[3:], drain=drain)
    _equal_trees(dataclasses.asdict(resumed), dataclasses.asdict(full))


def _to_jax_state(fields):
    """A port state dict with numpy leaves as the JAX TrainState."""
    return JaxState(**fields)


def test_zero_reshard_2x4_to_2x2_matches_jax(tmp_path):
    xs4, ys4 = _data(6, 4, same_per_worker=True)
    xs2, ys2 = xs4[:, :, :2].copy(), ys4[:, :, :2].copy()
    tr4 = _trainer(4, zero=True, pipeline_depth=1)
    st = _run(tr4, tr4.init_state(sample_input=xs4[0, 0, 0]), xs4[:3],
              ys4[:3])
    path = tr4.save_checkpoint(str(tmp_path / "mid"), st)
    full = _run(tr4, st, xs4[3:], ys4[3:], drain=True)

    tr2 = _trainer(2, zero=True, pipeline_depth=1)
    template = tr2.init_state(sample_input=xs2[0, 0, 0])
    st2 = tr2.load_checkpoint(path, template)
    # the JAX package's re-shard of the same host arrays onto the same
    # template gives the same arrays
    host = load_checkpoint(path)
    tmpl = to_host(template)
    want = jax_reshard(_to_jax_state(host),
                       _to_jax_state(jax.tree.map(jnp.asarray, tmpl)),
                       None)
    got = to_host(reshard_zero_state(host, template))
    for f in ("params", "opt_state", "model_state", "sync_state"):
        gl = jax.tree.leaves(got[f])
        wl = jax.tree.leaves(getattr(want, f))
        assert len(gl) == len(wl), f
        assert gl or f == "model_state", f     # the MLP has no BatchNorm
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    _equal_trees(to_host(st2), got)
    # and the resumed 2x2 run lands on the 2x4 run's params
    resumed = _run(tr2, st2, xs2[3:], ys2[3:], drain=True)
    for k in full.params:
        assert torch.equal(resumed.params[k][0, 0], full.params[k][0, 0]), k


def test_zero_checkpoint_keeps_every_worker_shard(tmp_path):
    # the saved ZeRO state keeps the full [P, W] axes: every worker's
    # shard of the optimizer state and of the in-flight dc buffers
    xs, ys = _data(2, 4)
    tr = _trainer(4, zero=True, pipeline_depth=1)
    st = _run(tr, tr.init_state(sample_input=xs[0, 0, 0]), xs, ys)
    host = load_checkpoint(tr.save_checkpoint(str(tmp_path / "z"), st))
    trace = host["opt_state"]["trace"][0]
    assert trace.shape[:2] == (2, 4)
    assert not np.array_equal(trace[0, 0], trace[0, 1])
    _equal_trees(host, to_host(st))


def test_zero_mismatch_rejected(tmp_path):
    xs, _ = _data(1, 4)
    tr_z, tr_r = _trainer(zero=True), _trainer(zero=False)
    st = tr_z.init_state(sample_input=xs[0, 0, 0])
    tmpl = tr_r.init_state(sample_input=xs[0, 0, 0])
    path = tr_z.save_checkpoint(str(tmp_path / "z"), st)
    with pytest.raises(ValueError, match="GEOMX_ZERO"):
        tr_r.load_checkpoint(path, tmpl)
    path_r = tr_r.save_checkpoint(str(tmp_path / "r"), tmpl)
    with pytest.raises(ValueError, match="GEOMX_ZERO"):
        tr_z.load_checkpoint(path_r, st)
    # another configuration's state does not fit the template
    other = _trainer(zero=False, compression="bsc,0.01")
    with pytest.raises(ValueError, match="structure mismatch"):
        other.load_checkpoint(path_r, other.init_state(
            sample_input=xs[0, 0, 0]))
