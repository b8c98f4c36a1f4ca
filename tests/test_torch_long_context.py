"""The port's long-context example against the JAX package's.

- The needle task: the port's ``make_needle_data``/``with_positions``
  equal the JAX example's (examples/long_context.py) bit for bit.
- The port's ``examples/long_context.main("ulysses")`` on the CPU at
  tests/test_long_context.py's example settings (3 epochs, L 96, 1 x 2
  replicas x sp 2) learns the task: last test accuracy above 0.5, that
  file's bar.
- ``SeqClassifier`` in bf16 against flax's in bf16 on converted weights,
  for sp_mode None, ring and Ulysses: logits to atol 0.05 (bf16 keeps 8
  mantissa bits and the two packages round at different points inside
  each layer; the logits here are of order 1).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from geomx_tpu.models.seq_classifier import SeqClassifier as FlaxSeq
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu_torch.data import make_needle_data, with_positions
from geomx_tpu_torch.examples import long_context
from geomx_tpu_torch.models import SeqClassifier
from geomx_tpu_torch.models.convert import load_flax
from geomx_tpu_torch.train.step import sp_chunks

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_long_context_example",
        os.path.join(ROOT, "examples", "long_context.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,seq_len,seed", [(4096, 256, 0), (512, 256, 1),
                                            (64, 96, 3)])
def test_needle_data_matches_the_jax_example(n, seq_len, seed):
    ref = _jax_example()
    x, y = make_needle_data(n, seq_len, seed=seed)
    rx, ry = ref.make_needle_data(n, seq_len, seed=seed)
    for a, b in ((x, rx), (y, ry), (with_positions(x),
                                    ref.with_positions(rx))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_example_converges(monkeypatch):
    """The port's example learns the needle task on the CPU at the JAX
    test's settings (tests/test_long_context.py test_example_converges)."""
    for k, v in dict(GEOMX_EPOCHS="3", GEOMX_SEQ_LEN="96",
                     GEOMX_NUM_PARTIES="1", GEOMX_WORKERS_PER_PARTY="2",
                     GEOMX_SP_DEGREE="2").items():
        monkeypatch.setenv(k, v)
    acc = long_context.main("ulysses", device="cpu")
    assert acc > 0.5, f"needle task should be learnable, got {acc}"


def test_example_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        long_context.main("ring")


L = 64
MK = dict(vocab=64, max_len=L, dim=32, num_heads=4, num_layers=2,
          num_classes=4)


def _flax_bf16_params():
    model = FlaxSeq(dtype=jnp.bfloat16, **MK)
    x = np.zeros((2, L, 2), np.int32)
    p = jax.jit(lambda r: model.init(r, x))(jax.random.PRNGKey(0))
    # random LayerNorm scales/biases, so the unit init hides nothing
    rng = np.random.RandomState(1)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), p["params"])


@pytest.mark.parametrize("mode,S", [(None, 1), ("ring", 2), ("ulysses", 2)])
def test_bf16_logits_match_flax(mode, S):
    params = _flax_bf16_params()
    rng = np.random.RandomState(2)
    tok = rng.randint(4, 64, size=(4, L)).astype(np.int32)
    x = with_positions(tok)
    fm = FlaxSeq(sp_mode=mode, dtype=jnp.bfloat16, **MK)

    def apply(p, xl):
        return fm.apply({"params": p}, xl).astype(jnp.float32)

    if mode is None:
        ref = jax.jit(apply)(params, x)
    else:
        mesh = Mesh(np.asarray(jax.devices()[:S]), axis_names=("sp",))
        ref = jax.jit(shard_map_compat(apply, mesh,
                                       in_specs=(P(), P(None, "sp")),
                                       out_specs=P()))(params, x)
    model = SeqClassifier(sp_mode=mode, dtype=torch.bfloat16, **MK)
    load_flax(model, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = model(xt if mode is None else sp_chunks(xt, S))
    assert got.dtype == torch.float32
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1       # the logits are not all ~0
    np.testing.assert_allclose(got.numpy(), ref, atol=0.05)
