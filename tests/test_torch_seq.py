"""Port parity: the long-context SeqClassifier and its sp training step
(geomx_tpu_torch vs the flax model and the JAX Trainer).

- The parameter tree of ``get_model("transformer")`` is flax's, names,
  shapes and count.
- Logits and gradients on converted weights, fp32, for sp_mode None,
  "ring" and "ulysses": the JAX sp modes run under ``shard_map`` on the
  conftest's virtual devices (their gradients psum'd over sp, as the JAX
  step does); the port runs one replica's sp shards in one graph.  Logits
  to atol 2e-5, gradients to atol 2e-5 / rtol 1e-4: the packages sum the
  attention tiles, the LayerNorm statistics and the pooled means in
  different orders (the LayerNorm variance is flax's ``E[x^2] - E[x]^2``
  in both).
- Three Trainer steps on [1, 2] x sp 2 against the JAX Trainer at
  tests/test_long_context.py's sizes: losses to rtol 2e-4 and params to
  2e-3, as that file holds the JAX sp run against its un-sharded run.
- The port's sp run against its own un-sharded run, at the same
  tolerances.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from geomx_tpu.models.seq_classifier import SeqClassifier as FlaxSeq
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.sync import FSA as JaxFSA
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import HiPSTopology
from geomx_tpu_torch.models import SeqClassifier, get_model
from geomx_tpu_torch.models.convert import from_flax, load_flax
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.sync import FSA
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.train.step import sp_chunks
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

BATCH, L, STEPS = 8, 64, 3
MK = dict(vocab=64, max_len=L, dim=32, num_heads=4, num_layers=2,
          num_classes=4)


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(4, 64, size=(n, L)).astype(np.int32)
    y = rng.randint(0, 4, size=(n,)).astype(np.int32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), x.shape)
    return np.stack([x, pos], axis=-1), y


@functools.lru_cache(maxsize=None)
def _flax_params(seed=0):
    model = FlaxSeq(**MK)
    x, _ = _data(2)
    p = jax.jit(lambda r: model.init(r, x))(jax.random.PRNGKey(seed))
    # random LayerNorm scales/biases, so the unit init hides nothing
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), p["params"])


def test_transformer_matches_flax_tree():
    fm = FlaxSeq()
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))
    ref = from_nested(jax.tree.map(lambda a: tuple(a.shape),
                                   shapes["params"]))
    model = get_model("transformer")
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == ref
    assert sum(int(np.prod(s)) for s in got.values()) == 378_762
    assert model.param_names() == sorted(ref, key=lambda s: s.split("."))
    assert model.sp_mode is None and model.dtype == torch.float32
    for name in ("seq", "seq_classifier"):
        assert isinstance(get_model(name), SeqClassifier)


def _jax_logits_grads(mode, params, x, y, S):
    model = FlaxSeq(sp_mode=mode, **MK)

    def loss(p, xl, yl):
        logits = model.apply({"params": p}, xl)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yl)
        return ce.mean(), logits

    if mode is None:
        (_, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, x, y)
        return np.asarray(logits), g

    def f(p, xl, yl):
        (_, logits), g = jax.value_and_grad(loss, has_aux=True)(p, xl, yl)
        return logits, jax.lax.psum(g, "sp")   # the JAX step's sp psum

    mesh = Mesh(np.asarray(jax.devices()[:S]), axis_names=("sp",))
    fn = shard_map_compat(f, mesh, in_specs=(P(), P(None, "sp"), P()),
                          out_specs=(P(), P()))
    logits, g = jax.jit(fn)(params, x, y)
    return np.asarray(logits), g


@pytest.mark.parametrize("mode,S", [(None, 1), ("ring", 2), ("ring", 4),
                                    ("ulysses", 2)])
def test_logits_and_gradients_match_flax(mode, S):
    params = _flax_params()
    x, y = _data(4, seed=1)
    jl, jg = _jax_logits_grads(mode, params, x, y, S)
    model = SeqClassifier(sp_mode=mode, **MK)
    load_flax(model, params)
    xt = torch.from_numpy(x)
    logits = model(xt if mode is None else sp_chunks(xt, S))
    np.testing.assert_allclose(logits.detach().numpy(), jl, atol=2e-5)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).long()).backward()
    ref = from_nested(jax.tree.map(np.asarray, jg))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k], atol=2e-5,
                                   rtol=1e-4, err_msg=k)


def _jax_train(mode, parties, workers, sp):
    topo = JaxTopology(num_parties=parties, workers_per_party=workers,
                       sp_degree=sp)
    trainer = JaxTrainer(FlaxSeq(sp_mode=mode, **MK), topo, optax.sgd(0.1),
                         sync=JaxFSA(), donate=False,
                         single_device_model=FlaxSeq(sp_mode=None, **MK))
    x, y = _data(BATCH * STEPS)
    state = trainer.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], state.params)
    local_b = BATCH // (parties * workers)
    xs = topo.seq_batch_sharding(trainer.mesh)
    ys = topo.batch_sharding(trainer.mesh)
    losses = []
    for s in range(STEPS):
        xb = x[s * BATCH:(s + 1) * BATCH].reshape(parties, workers, local_b,
                                                  L, 2)
        yb = y[s * BATCH:(s + 1) * BATCH].reshape(parties, workers, local_b)
        state, metrics = trainer.train_step(
            state, jax.device_put(xb, xs), jax.device_put(yb, ys))
        losses.append(float(metrics["loss"]))
    params = from_nested(jax.tree.map(lambda a: np.asarray(a[0, 0]),
                                      state.params))
    return p0, losses, params


def _port_train(mode, parties, workers, sp, p0):
    trainer = Trainer(SeqClassifier(sp_mode=mode, **MK),
                      HiPSTopology(parties, workers, sp_degree=sp), sgd(0.1),
                      sync=FSA(), device="cpu",
                      single_device_model=SeqClassifier(**MK))
    state = trainer.init_state(params=from_flax(p0)[0])
    x, y = _data(BATCH * STEPS)
    local_b = BATCH // (parties * workers)
    losses = []
    for s in range(STEPS):
        xb = torch.from_numpy(x[s * BATCH:(s + 1) * BATCH].reshape(
            parties, workers, local_b, L, 2))
        yb = torch.from_numpy(y[s * BATCH:(s + 1) * BATCH].reshape(
            parties, workers, local_b)).long()
        state, metrics = trainer.train_step(state, xb, yb)
        losses.append(float(metrics["loss"]))
    for k, v in state.params.items():
        assert torch.equal(v, v[:1, :1].expand_as(v)), k
    return losses, {k: v[0, 0].numpy() for k, v in state.params.items()}, \
        trainer, state


def test_head_dim_192_logits_and_gradients_match_flax():
    """A head dim above 128 (dim 384, 2 heads, 1 layer, L = 32) on the
    CPU, where the attention takes its plain route: logits and gradients
    against the flax model at test_logits_and_gradients_match_flax's
    tolerances.  The kernels' wide route at such head dims is checked on
    the card by tests/test_torch_cuda.py
    test_seq_classifier_head_dim_256_trains_on_the_card."""
    mk = dict(vocab=64, max_len=32, dim=384, num_heads=2, num_layers=1,
              num_classes=4)
    model = FlaxSeq(**mk)
    rng = np.random.RandomState(3)
    x = rng.randint(4, 64, size=(4, 32)).astype(np.int32)
    x = np.stack([x, np.broadcast_to(np.arange(32, dtype=np.int32),
                                     x.shape)], axis=-1)
    y = rng.randint(0, 4, size=(4,)).astype(np.int32)
    p = jax.jit(lambda r: model.init(r, x[:2]))(jax.random.PRNGKey(3))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), p["params"])

    def loss(p, xl, yl):
        logits = model.apply({"params": p}, xl)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yl)
        return ce.mean(), logits

    (_, jl), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, x, y)
    tm = SeqClassifier(**mk)
    load_flax(tm, params)
    logits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=2e-5)
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).long()).backward()
    ref = from_nested(jax.tree.map(np.asarray, jg))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k], atol=2e-5,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_trainer_steps_match_jax(mode):
    p0, jlosses, jparams = _jax_train(mode, 1, 2, 2)
    losses, params, trainer, state = _port_train(mode, 1, 2, 2, p0)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4, atol=2e-4)
    assert sorted(params) == sorted(jparams)
    for k in params:
        np.testing.assert_allclose(params[k], jparams[k], rtol=2e-3,
                                   atol=2e-3, err_msg=k)
    # evaluation runs the un-meshed twin on [N, L, 2]
    x, y = _data(16, seed=2)
    acc = trainer.evaluate(state, x, y, batch_size=8)
    assert 0.0 <= acc <= 1.0


def test_sp_run_matches_unsharded_run():
    p0 = jax.tree.map(np.asarray, _flax_params())
    base, base_p, _, _ = _port_train(None, 1, 2, 1, p0)
    for mode in ("ring", "ulysses"):
        losses, params, _, _ = _port_train(mode, 1, 2, 2, p0)
        np.testing.assert_allclose(losses, base, rtol=2e-4, atol=2e-4)
        for k in params:
            np.testing.assert_allclose(params[k], base_p[k], rtol=2e-3,
                                       atol=2e-3, err_msg=k)


def test_sp_chunks_and_warning():
    x = torch.arange(2 * 8 * 2).view(2, 8, 2)
    c = sp_chunks(x, 4)
    assert c.shape == (4, 2, 2, 2)
    assert torch.equal(c[1, 0], x[0, 2:4])
    with pytest.raises(ValueError):
        sp_chunks(x, 3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        Trainer(SeqClassifier(**MK), HiPSTopology(1, 2, sp_degree=2),
                sgd(0.1), device="cpu")
    assert any("sp_mode" in str(m.message) for m in w)
    with pytest.raises(ValueError):
        HiPSTopology(1, 1, sp_degree=0)
    assert HiPSTopology(2, 2, sp_degree=2).replica_shape == (2, 2)


def test_needle_data_is_the_examples():
    """The port's copy of examples/long_context.py's needle task gives the
    example's arrays for the same seed."""
    import importlib.util
    import os

    from geomx_tpu_torch.data import make_needle_data, with_positions

    spec = importlib.util.spec_from_file_location(
        "long_context_example",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "examples", "long_context.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for n, L, seed in ((64, 256, 0), (10, 96, 1)):
        x, y = make_needle_data(n, L, seed=seed)
        rx, ry = mod.make_needle_data(n, L, seed=seed)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
        np.testing.assert_array_equal(with_positions(x),
                                      mod.with_positions(rx))
