"""Port parity of the rest of the model zoo: GeoCNN, MLP, AlexNet and
ResNet-20's space-to-depth variant (geomx_tpu_torch vs the flax models
on converted weights), at 28x28x1 and 32x32x3.

Tolerances: fp32 logits and gradients to rtol 1e-5 with an atol of 1e-5
times the largest magnitude of the reference (the two packages sum the
convolutions and dot products in different orders); bf16 logits to atol
0.1, the ResNet tests' bf16 tolerance (8 mantissa bits, rounded at
different points inside each layer).  Parameter names and counts must
equal flax's ``eval_shape`` exactly.  Inputs are made with numpy from a
seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from geomx_tpu.models import AlexNet as FlaxAlexNet
from geomx_tpu.models import GeoCNN as FlaxCNN
from geomx_tpu.models import MLP as FlaxMLP
from geomx_tpu.models import get_model as jax_get_model
from geomx_tpu.models.resnet import ResNet20 as FlaxResNet20
from geomx_tpu.models.resnet import space_to_depth as jax_s2d
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.models.convert import load_flax
from geomx_tpu_torch.models.resnet import space_to_depth
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

SHAPES = [(28, 28, 1), (32, 32, 3)]
# name -> (flax constructor by dtype, the port's zoo name and precision)
FLAX = {
    "cnn": lambda dt: FlaxCNN(dtype=None if dt == jnp.float32 else dt),
    "mlp": lambda dt: FlaxMLP(dtype=dt),
    "alexnet": lambda dt: FlaxAlexNet(dtype=dt),
    "resnet20_s2d": lambda dt: FlaxResNet20(dtype=dt, space_to_depth=True,
                                            mxu_shortcuts=True),
}


def _port(name, dtype):
    if name == "cnn" and dtype == "fp32":
        return get_model("cnn")          # flax's promotion: fp32
    return get_model(name, precision=dtype)


@functools.lru_cache(maxsize=None)
def _flax(name, dtype, shape):
    """(flax module, params, batch_stats) as numpy trees, with random
    BatchNorm statistics and scales so that zero inits hide nothing."""
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    fm = FLAX[name](jdt)
    variables = jax.jit(lambda r: fm.init(
        r, jnp.zeros((1,) + shape), train=False))(jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.05, a.shape)
                          .astype(np.float32), variables["params"])
    stats = jax.tree.map(lambda a: np.abs(a + rng.normal(0, 0.1, a.shape))
                         .astype(np.float32),
                         variables.get("batch_stats", {}))
    return fm, params, stats


def _inputs(shape, b=4, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (b,) + shape).astype(np.float32)
    y = rng.randint(0, 10, b).astype(np.int32)
    return x, y


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("name,shape,n", [
    ("cnn", (28, 28, 1), 449_098), ("cnn", (32, 32, 3), 572_778),
    ("mlp", (28, 28, 1), 235_146), ("alexnet", (32, 32, 3), 6_976_842),
    ("resnet20_s2d", (32, 32, 3), 281_450),
    ("resnet20_s2d", (28, 28, 1), 274_154)])
def test_zoo_names_and_counts_match_flax_eval_shape(name, shape, n):
    fm = jax_get_model(name)
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape), train=False))
    ref = from_nested(jax.tree.map(lambda a: tuple(a.shape),
                                   shapes["params"]))
    model = get_model(name)
    model.build(shape)
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == ref
    assert sum(int(np.prod(s)) for s in got.values()) == n
    if name == "resnet20_s2d" and shape == (32, 32, 3):
        assert len(got) == 65
    # a model sized by the input refuses to run before it is built
    if name in ("cnn", "mlp", "alexnet"):
        with pytest.raises(RuntimeError, match="build"):
            get_model(name)(torch.zeros((1,) + shape))


def _flax_run(fm, params, stats, x, y):
    """(train-mode logits, fp32 cross-entropy gradients) of the flax
    model."""
    has_stats = bool(jax.tree.leaves(stats))

    def loss(p):
        variables = {"params": p, **({"batch_stats": stats}
                                     if has_stats else {})}
        if has_stats:
            logits, _ = fm.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
        else:
            logits = fm.apply(variables, x, train=True)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y).mean()
        return ce, logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return np.asarray(logits, np.float32), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(FLAX))
def test_fp32_logits_and_gradients_match_flax(name, shape):
    fm, params, stats = _flax(name, "fp32", shape)
    x, y = _inputs(shape)
    ref_logits, ref_grads = _flax_run(fm, params, stats, x, y)
    model = _port(name, "fp32")
    model.build(shape)
    load_flax(model, params, stats)
    logits = model(torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32
    F.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    _close(logits.detach().numpy(), ref_logits)
    ref = from_nested(ref_grads)
    for k, p in model.named_parameters():
        _close(p.grad.numpy(), ref[k])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(FLAX))
def test_bf16_logits_match_flax(name, shape):
    fm, params, stats = _flax(name, "bf16", shape)
    x, _ = _inputs(shape)
    has_stats = bool(jax.tree.leaves(stats))
    ref = jax.jit(lambda p, x: fm.apply(
        {"params": p, **({"batch_stats": stats} if has_stats else {})},
        x, train=False))(params, x)
    model = _port(name, "bf16")
    model.build(shape)
    load_flax(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               atol=0.1)


@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (1, 8, 8, 16)])
def test_space_to_depth_matches_jax_order(shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(
        space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jax_s2d(jnp.asarray(x))))


def test_build_resizes_from_the_sample():
    """The stem follows the sample's channels; a block of resnet20_s2d
    whose input has odd H takes the strided projection, as flax does."""
    m = get_model("resnet20_s2d")
    assert m.Conv_0.kernel.shape == (3, 3, 12, 16)
    assert m.BasicBlock_6.s2d_shortcut
    m.build((28, 28, 1))
    assert m.Conv_0.kernel.shape == (3, 3, 4, 16)
    assert m.BasicBlock_3.s2d_shortcut and not m.BasicBlock_6.s2d_shortcut
    assert m.BasicBlock_6.Conv_2.stride == 2
    cnn = get_model("cnn")
    cnn.build((28, 28, 1))
    assert cnn.Dense_0.kernel.shape == (1568, 256)
    cnn.build((32, 32, 3))
    assert cnn.Dense_0.kernel.shape == (2048, 256)
