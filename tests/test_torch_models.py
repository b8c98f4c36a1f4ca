"""Port parity: ResNet forward, BatchNorm statistics and gradients
(geomx_tpu_torch vs the flax model on converted weights).

Tolerances: fp32 logits and statistics to atol 2e-4 — the two packages
sum convolutions and BatchNorm reductions in different orders, and the
logits carry about 1e-6 relative error per layer; bf16 to atol 0.1 on
logits (bf16 keeps 8 mantissa bits and the two packages round at
different points inside each convolution).  Inputs are NHWC images
made with numpy, at 16x16 (the stride-2 SAME convolutions pad (0, 1))
and 15x15 (they pad (1, 1)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu_torch.models import ResNet, get_model
from geomx_tpu_torch.models.convert import from_flax, load_flax
from geomx_tpu_torch.models.resnet import same_padding
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

STAGES, FILTERS = (1, 1, 1), (8, 16, 32)


@functools.lru_cache(maxsize=None)
def flax_model(dtype, hw, seed=0):
    """(flax module, params, batch_stats) as numpy trees — shared by the
    tests, which only read them."""
    model = FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS, dtype=dtype)
    variables = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, hw, hw, 3)), train=False))(jax.random.PRNGKey(seed))
    variables = jax.tree.map(np.asarray, variables)
    # random BN scales/biases/statistics, so zero-init scales hide nothing
    rng = np.random.RandomState(seed + 1)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.1, a.shape)
                          .astype(np.float32), variables["params"])
    stats = jax.tree.map(lambda a: np.abs(a + rng.normal(0, 0.1, a.shape))
                         .astype(np.float32), variables["batch_stats"])
    return model, params, stats


def port_model(dtype, params, stats):
    model = ResNet(STAGES, FILTERS, dtype=dtype)
    load_flax(model, params, stats)
    return model


def images(hw, b=8, seed=3):
    x = np.random.RandomState(seed).uniform(0, 1, (b, hw, hw, 3))
    return x.astype(np.float32)


@pytest.mark.parametrize("hw", [16, 15])
def test_fp32_logits_and_batch_stats_match_flax(hw):
    fm, params, stats = flax_model(jnp.float32, hw)
    x = images(hw)
    logits, new_vars = jax.jit(lambda p, s, x: fm.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, x)
    eval_logits = jax.jit(lambda p, s, x: fm.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x)

    pm = port_model(torch.float32, params, stats)
    with torch.no_grad():
        got_eval = pm(torch.from_numpy(x), train=False)
        got = pm(torch.from_numpy(x), train=True)  # updates pm's buffers
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=2e-4)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(eval_logits),
                               atol=2e-4)
    ref_stats = from_nested(jax.tree.map(np.asarray,
                                         new_vars["batch_stats"]))
    buffers = dict(pm.named_buffers())
    assert sorted(buffers) == sorted(ref_stats)
    for k, ref in ref_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), ref, atol=2e-4,
                                   err_msg=k)


def test_bf16_logits_match_flax():
    fm, params, stats = flax_model(jnp.bfloat16, 16)
    x = images(16)
    logits, _ = jax.jit(lambda p, s, x: fm.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, x)
    pm = port_model(torch.bfloat16, params, stats)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32  # the head computes in fp32
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=0.1)


def test_fp32_gradients_match_flax():
    """Cross-entropy gradients of every parameter, atol 1e-4."""
    import optax

    fm, params, stats = flax_model(jnp.float32, 16)
    x = images(16)
    y = np.arange(8) % 10

    def loss(p):
        logits, _ = fm.apply({"params": p, "batch_stats": stats}, x,
                             train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    ref = from_nested(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    pm = port_model(torch.float32, params, stats)
    logits = pm(torch.from_numpy(x), train=True)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k], atol=1e-4,
                                   err_msg=k)


def test_converted_weights_in_functional_form():
    """The Trainer's per-replica path (functional_call with converted
    flat dicts) gives the module's own output."""
    fm, params, stats = flax_model(jnp.float32, 16)
    p, s = from_flax(params, stats)
    pm = port_model(torch.float32, params, stats)
    x = torch.from_numpy(images(16))
    with torch.no_grad():
        a = functional_call(pm, {**p, **s}, (x,), {"train": False})
        b = pm(x, train=False)
    assert torch.equal(a, b)


def test_same_padding_follows_xla():
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(15, 3, 2) == (1, 1)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)


def test_get_model_resnet20_matches_flax_tree():
    fm = FlaxResNet(stage_sizes=(3, 3, 3), stage_filters=(16, 32, 64))
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    ref = from_nested(jax.tree.map(lambda a: tuple(a.shape),
                                   shapes["params"]))
    model = get_model("resnet20")
    assert model.dtype == torch.bfloat16
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == ref
    assert sum(int(np.prod(s)) for s in got.values()) == 272_474
    # the second BatchNorm of each block starts at zero scale
    assert not model.BasicBlock_0.BatchNorm_1.scale.any()
    with pytest.raises(NotImplementedError):
        get_model("cnn")
