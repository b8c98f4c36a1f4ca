"""Port parity: Adam, the fused optimizer apply and its kernels' plain
versions (geomx_tpu_torch vs geomx_tpu, on the CPU).

- The plain versions of ``fused_sgd_momentum`` / ``fused_adam`` against
  the Pallas kernels in interpret mode: moments bit-equal on dyadic
  inputs (signed powers of two, so every product is exact and XLA's FMA
  contraction on the CPU rounds as the port's separate ops do); params
  to rtol 1e-6 / atol 1e-8 on Gaussian inputs (the JAX kernels' own
  bound, ops/optim_pallas.py:28-32); the bf16 copy equal to
  ``p'.to(bfloat16)``.
- Adam's bias corrections equal JAX's fp32 values bit for bit for
  t = 1..1000.
- ``fused_apply`` against the JAX ``fused_apply`` over two buckets, one
  with an odd tail, from a mid-run state carried across by the
  converter, over 3 steps: rtol 1e-6 (one FMA rounding a step), moments
  with an atol of 1e-6 of their largest magnitude (cancellation).
- The port's Adam against ``optax.adam`` per leaf: moments bit-equal on
  dyadic inputs, params to rtol 1e-6.
- Three fp32 training steps of a small ResNet with the fused apply, port
  vs JAX Trainer: losses to rtol 1e-4, as in test_torch_train.py.
- Fused vs unfused in the port over 3 steps: parameter gap < 1e-5
  (tests/test_optim_pallas.py's bound).
- Every name of the factory (``get_optimizer``), Adam's ``eps_root`` and
  ``warmup_cosine_decay_schedule`` (with Nesterov SGD and Adam), five
  steps against the JAX factory's optax optimizer on a small tree with
  [2, 2] replica axes (optax runs each replica's slice): params to
  rtol 2e-6 of each coordinate plus 1e-6 (``rsqrt``/``sqrt`` round
  differently in XLA and PyTorch; LAMB's norms sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import FILTERS, STAGES, dyadic

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas as jo
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax, opt_state_from_optax
from geomx_tpu_torch.ops import optim as po
from geomx_tpu_torch.optim import adam, get_optimizer, sgd
from geomx_tpu_torch.optim.adam import bias_correction
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

SIZES = [1, 1000, 32_768, 272_512, 300_000]
ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _gauss(rng, n, scale=1.0):
    return (rng.randn(n) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np(*xs):
    return [np.asarray(x) for x in xs]


def test_bias_corrections_match_jax_fp32():
    t = np.arange(1, 1001)
    for b in (0.9, 0.999):
        # what fused_apply and optax.scale_by_adam compute on the device
        fused = np.asarray(jax.jit(lambda c: 1.0 - b ** c.astype(
            jnp.float32))(jnp.asarray(t, jnp.int32)))
        chain = np.asarray(jax.jit(lambda c: 1 - b ** c)(
            jnp.asarray(t, jnp.int32)))
        port = np.array([bias_correction(b, c) for c in t], np.float32)
        np.testing.assert_array_equal(port, fused, err_msg=str(b))
        np.testing.assert_array_equal(port, chain, err_msg=str(b))


@pytest.mark.parametrize("n", SIZES)
def test_sgd_momentum_plain_matches_pallas(n):
    rng = np.random.RandomState(n % 1000)
    kw = dict(lr=0.1, momentum=0.9)
    for kind in ("dyadic", "gauss"):
        if kind == "dyadic":
            p, g, m = (dyadic(rng, (n,)) for _ in range(3))
        else:
            p, g, m = _gauss(rng, n), _gauss(rng, n, 1e-2), \
                _gauss(rng, n, 1e-2)
        jp, jm, jc = _np(*jo.fused_sgd_momentum(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
            cast_dtype=jnp.bfloat16, interpret=True, **kw))
        pp, pm, pc = po.fused_sgd_momentum(*_t(p, g, m),
                                           cast_dtype=torch.bfloat16, **kw)
        if kind == "dyadic":
            np.testing.assert_array_equal(pm.numpy(), jm)
        np.testing.assert_allclose(pm.numpy(), jm, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(pp.numpy(), jp, rtol=1e-6, atol=1e-8)
        assert pc.dtype == torch.bfloat16
        assert torch.equal(pc, pp.to(torch.bfloat16))


@pytest.mark.parametrize("n", SIZES)
def test_adam_plain_matches_pallas(n):
    rng = np.random.RandomState(n % 1000 + 1)
    bc1, bc2 = bias_correction(0.9, 7), bias_correction(0.999, 7)
    for kind in ("dyadic", "gauss"):
        if kind == "dyadic":
            p, g, m = (dyadic(rng, (n,)) for _ in range(3))
            v = np.abs(dyadic(rng, (n,)))
        else:
            p, g = _gauss(rng, n), _gauss(rng, n, 1e-2)
            m, v = _gauss(rng, n, 1e-3), np.abs(_gauss(rng, n, 1e-4))
        jp, jm, jv, jc = _np(*jo.fused_adam(
            *(jnp.asarray(a) for a in (p, g, m, v)), jnp.float32(bc1),
            jnp.float32(bc2), cast_dtype=jnp.bfloat16, interpret=True,
            **ADAM))
        pp, pm, pv, pc = po.fused_adam(*_t(p, g, m, v), bc1, bc2,
                                       cast_dtype=torch.bfloat16, **ADAM)
        if kind == "dyadic":
            np.testing.assert_array_equal(pm.numpy(), jm)
            np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_allclose(pm.numpy(), jm, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(pv.numpy(), jv, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(pp.numpy(), jp, rtol=1e-6, atol=1e-8)
        assert torch.equal(pc, pp.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_fused_apply_from_converted_state_matches_jax(kind):
    """Two buckets (one with an odd tail); the JAX state after two steps
    (non-zero moments, count 2) crosses over by the converter, then both
    packages run 3 more steps."""
    rng = np.random.RandomState(3)
    sizes = (4096, 1037)
    jfo = jo.fused_optimizer(kind, learning_rate=0.05)
    pfo = po.fused_optimizer(kind, learning_rate=0.05)
    jp = [jnp.asarray(_gauss(rng, n)) for n in sizes]
    js = jfo.init(jp)

    def grads():
        return [_gauss(rng, n, 1e-2) for n in sizes]

    for _ in range(2):
        jp, js = jo.fused_apply(jfo.spec, jp, [jnp.asarray(g)
                                               for g in grads()], js,
                                interpret=True)
    ps = us = opt_state_from_optax(jax.device_get(js))
    if kind == "adam":
        assert ps["count"] == 2 and float(ps["nu"][1].abs().max()) > 0
    pp = up = _t(*jax.device_get(jp))
    for _ in range(3):
        gs = grads()
        jp, js = jo.fused_apply(jfo.spec, jp, [jnp.asarray(g) for g in gs],
                                js, interpret=True)
        pp, ps = po.fused_apply(pfo.spec, pp, _t(*gs), ps)
        up, us = po.unfused_apply(pfo, up, _t(*gs), us)
    # on the CPU the fused apply runs the per-leaf optimizer's ops
    for a, b in zip(pp, up):
        assert torch.equal(a, b)
    want = opt_state_from_optax(jax.device_get(js))
    assert want.keys() == ps.keys()
    for key in want:
        if key == "count":
            assert ps[key] == want[key] == 5
            continue
        for a, b in zip(ps[key], want[key]):
            # cancellation in m' = momentum*m + g: the FMA rounding shows
            # relative to the moment's scale, not to each element
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(b.abs().max()),
                                       err_msg=key)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-8)


def test_port_adam_matches_optax_per_leaf():
    rng = np.random.RandomState(5)
    shapes = {"a": {"kernel": (3, 3, 4, 8), "bias": (8,)}, "b": {"w": (33,)}}
    leaves = jax.tree.map(lambda s: dyadic(rng, s), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    tx = optax.adam(0.01)
    st = tx.init(leaves)
    mid = (st[0]._replace(
        count=jnp.asarray(4, jnp.int32),
        mu=jax.tree.map(lambda a: dyadic(rng, a.shape), leaves),
        nu=jax.tree.map(lambda a: np.abs(dyadic(rng, a.shape)), leaves)),
        ) + tuple(st[1:])
    grads = jax.tree.map(lambda a: dyadic(rng, a.shape), leaves)

    @jax.jit
    def jstep(p, g, s):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jp, js = jax.device_get(jstep(leaves, grads, mid))
    port = get_optimizer("adam", 0.01)
    flat = lambda tree: {k: torch.from_numpy(np.array(v))  # noqa: E731
                         for k, v in from_nested(tree).items()}
    pp, ps = port.update(flat(grads), opt_state_from_optax(
        jax.device_get(mid)), flat(leaves))
    want = opt_state_from_optax(js)
    assert ps["count"] == want["count"] == 5
    for k in want["mu"]:
        np.testing.assert_array_equal(ps["mu"][k].numpy(),
                                      want["mu"][k].numpy(), err_msg=k)
        np.testing.assert_array_equal(ps["nu"][k].numpy(),
                                      want["nu"][k].numpy(), err_msg=k)
    for k, v in from_nested(jp).items():
        np.testing.assert_allclose(pp[k].numpy(), v, rtol=1e-6, atol=1e-8)


def test_get_optimizer_names():
    assert isinstance(get_optimizer("adam", 0.01), type(adam(0.01)))
    assert get_optimizer("momentum", 0.1).momentum == 0.9
    assert get_optimizer("sgd", 0.1).momentum is None
    # the rest of the factory builds optax's chains
    assert len(get_optimizer("rmsprop").transforms) == 3
    assert get_optimizer("nag", 0.1).nesterov
    with pytest.raises(ValueError):
        get_optimizer("nope")


def _batches(seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    return x, y


@pytest.mark.parametrize("kind,spec", [("sgd", "bsc,0.01,select=sampled"),
                                       ("adam", "2bit,0.5")])
def test_three_fused_fp32_steps_track_jax_trainer(topo2x4, mesh2x4, kind,
                                                  spec):
    x, y = _batches()
    lr = 0.1 if kind == "sgd" else 0.01
    cfg = dict(num_parties=2, workers_per_party=4, compression=spec,
               precision="fp32", fused_optim=True)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo2x4, jo.fused_optimizer(kind, learning_rate=lr),
                    config=JaxConfig(**cfg), mesh=mesh2x4, donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 4), po.fused_optimizer(kind,
                                                        learning_rate=lr),
                 config=GeoConfig(**cfg), device="cpu")
    pst = pt.init_state(params=from_flax(p0, s0)[0],
                        model_state=from_flax(p0, s0)[1])
    plosses = []
    for xb, yb in pt.make_loader(x, y, 8, seed=0).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"{kind} {spec}: losses port {plosses} jax {jlosses}")
    assert len(jlosses) == len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    # the optimizer state lives on the bucket layout in both packages
    want = opt_state_from_optax(jax.device_get(jst.opt_state))
    got = pst.opt_state
    key = "trace" if kind == "sgd" else "mu"
    assert [t.shape for t in got[key]] == [t.shape for t in want[key]]
    if kind == "adam":
        assert got["count"] == want["count"] == 3


@pytest.mark.parametrize("kind,spec", [("sgd", "bsc,0.01"),
                                       ("adam", "2bit,0.5")])
def test_port_fused_matches_unfused(kind, spec):
    x, y = _batches(12)
    lr = 0.05 if kind == "sgd" else 0.01
    params = {}
    for fused in (True, False):
        cfg = GeoConfig(num_parties=2, workers_per_party=4, compression=spec,
                        precision="fp32", fused_optim=fused)
        t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                    HiPSTopology(2, 4),
                    po.fused_optimizer(kind, learning_rate=lr), config=cfg,
                    device="cpu")
        st = t.init_state(seed=0)
        if fused:
            assert isinstance(st.opt_state[
                "trace" if kind == "sgd" else "mu"], list)
        for xb, yb in t.make_loader(x, y, 8, seed=0).epoch(0):
            st, _ = t.train_step(st, xb, yb)
        params[fused] = st.params
    gap = max(float((params[True][k] - params[False][k]).abs().max())
              for k in params[False])
    assert gap < 1e-5, gap


def test_fused_error_paths():
    topo = HiPSTopology(2, 4)
    model = ResNet(STAGES, FILTERS, dtype=torch.float32)
    cfg = dict(num_parties=2, workers_per_party=4, compression="bsc,0.01",
               fused_optim=True)
    with pytest.raises(ValueError, match="fused_optimizer"):
        Trainer(model, topo, sgd(0.1, momentum=0.9),
                config=GeoConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="bucketed"):
        Trainer(model, topo, po.fused_optimizer("sgd", learning_rate=0.1),
                config=GeoConfig(**dict(cfg, bucket_bytes=0)), device="cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        po.fused_optimizer("rmsprop", learning_rate=0.1)
    fo = po.fused_optimizer("sgd", learning_rate=0.1)
    st = fo.init([torch.zeros(8)])
    with pytest.raises(ValueError, match="different bucket list"):
        po.fused_apply(fo.spec, [torch.zeros(8)] * 2, [torch.zeros(8)] * 2,
                       st)
    with pytest.raises(ValueError, match="unknown spec kind"):
        po.fused_apply(po.FusedOptimSpec("lamb", 0.1), [torch.zeros(8)],
                       [torch.zeros(8)], st)
    assert po.fused_spec_of(sgd(0.1)) is None
    assert po.fused_spec_of(fo) == fo.spec
    assert po.fused_optim_enabled(GeoConfig(fused_optim=True))
    assert not po.fused_optim_enabled(GeoConfig())


_FACTORY = ["adam", "adamw", "sgd", "momentum", "nag", "rmsprop", "adagrad",
            "adadelta", "adamax", "nadam", "lamb", "dcasgd"]


def _warmup_cosine(port):
    from geomx_tpu_torch.optim import warmup_cosine_decay_schedule
    args = (0.01, 0.1, 2, 5, 0.005)
    return warmup_cosine_decay_schedule(*args) if port else \
        optax.schedules.warmup_cosine_decay_schedule(*args)


@pytest.mark.parametrize("name,kw,schedule", [
    *[(n, {}, False) for n in _FACTORY],
    ("adam", {"eps_root": 1e-8}, False),
    ("nag", {}, True), ("adam", {}, True)])
def test_factory_tracks_optax_five_steps(name, kw, schedule):
    from geomx_tpu.optim import get_optimizer as jax_get_optimizer
    rng = np.random.RandomState(0)
    P, W = 2, 2
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=(P, W) + s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=(P, W) + s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = get_optimizer(name, _warmup_cosine(True) if schedule else 0.01,
                       **kw)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = tx.init(pp)
    for g in grads:
        pp, st = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                           st, pp)
    for p in range(P):
        for w in range(W):
            jt = jax_get_optimizer(
                name, _warmup_cosine(False) if schedule else 0.01, **kw)
            jp = {k: jnp.asarray(v[p, w]) for k, v in params.items()}
            js = jt.init(jp)
            for g in grads:
                u, js = jt.update({k: jnp.asarray(v[p, w])
                                   for k, v in g.items()}, js, jp)
                jp = optax.apply_updates(jp, u)
            for k in shapes:
                np.testing.assert_allclose(pp[k][p, w].numpy(),
                                           np.asarray(jp[k]), rtol=2e-6,
                                           atol=1e-6, err_msg=f"{k} {p} {w}")
