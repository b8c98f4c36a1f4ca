"""Port parity: the attention kernels' plain versions, the flash autograd,
the ring hop and the sp attentions (geomx_tpu_torch vs geomx_tpu).

The JAX side runs the Pallas kernels in interpret mode (as the JAX
package's own tests do) and ring/Ulysses under ``shard_map`` on the
conftest's virtual CPU devices; the port runs on CPU tensors, so its
wrappers take the plain versions.  Inputs come from numpy with a seed.

Tolerances (fp32): forward outputs and logsumexp to atol 5e-6 / rtol
1e-5, gradients and the hop's carries to atol 2e-5 / rtol 1e-5 — the
two packages sum the tiles' products in different orders, and the
backward subtracts ``delta`` from ``dO V^T``, which cancels digits.
bf16 inputs: the outputs round to bf16 in both, one bf16 ulp (atol
1e-2 at these magnitudes) apart at most.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from geomx_tpu.parallel import _fused_block as jfb
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.parallel.ring_attention import ring_attention as jring
from geomx_tpu.parallel.ulysses import ulysses_attention as julysses
from geomx_tpu_torch.ops import flash_attention as fa
from geomx_tpu_torch.ops import ring_hop
from geomx_tpu_torch.parallel import _fused_block as fb
from geomx_tpu_torch.parallel.collectives import (all_to_all_sp, pmean_sp,
                                                  ppermute_sp)
from geomx_tpu_torch.parallel.ring_attention import (full_attention_reference,
                                                     ring_attention)
from geomx_tpu_torch.parallel.ulysses import ulysses_attention

# geomx_tpu.ops re-exports a function of the module's name
jfa = importlib.import_module("geomx_tpu.ops.flash_attention")

torch.set_num_threads(2)

FWD = dict(atol=5e-6, rtol=1e-5)
BWD = dict(atol=2e-5, rtol=1e-5)

# the JAX flash tests' shapes (tests/test_flash_attention.py:19-25)
SHAPES = [((2, 64, 4, 32), False), ((2, 64, 4, 32), True),
          ((1, 100, 2, 16), True), ((2, 128, 4, 64), False),
          ((1, 16, 1, 8), True)]


def _rand(rng, shape, n=3):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_forward_plain_matches_pallas(shape, causal):
    q, k, v = _rand(np.random.RandomState(0), shape)
    jo, jl = jfa.flash_attention_with_lse(q, k, v, causal=causal, block_q=32,
                                          block_k=32, interpret=True)
    out, lse = fa.flash_attention_with_lse(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **FWD)
    nolse = fa.flash_attention(*_t(q, k, v), causal=causal)
    assert torch.equal(nolse, out)


@pytest.mark.parametrize("shape,causal", [
    ((2, 64, 4, 32), False), ((2, 64, 4, 32), True),
    ((1, 100, 2, 16), True), ((1, 96, 2, 16), True), ((1, 16, 1, 8), False)])
def test_backward_plain_matches_pallas(shape, causal):
    rng = np.random.RandomState(12)
    q, k, v, g = _rand(rng, shape, 4)
    jo, jl = jfa.flash_attention_with_lse(q, k, v, causal=causal, block_q=32,
                                          block_k=32, interpret=True)
    jdq, jdk, jdv = jfa.flash_attention_bwd(q, k, v, jo, jl, g, causal=causal,
                                            block_q=32, block_k=32,
                                            interpret=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    delta = fa.attention_delta(out, tg)
    np.testing.assert_allclose(
        delta.numpy(), np.asarray(jnp.sum(g * np.asarray(jo), -1)
                                  .transpose(0, 2, 1)), **BWD)
    dq = fa.flash_dq(tq, tk, tv, tg, lse, delta, causal)
    dk, dv = fa.flash_dkv(tq, tk, tv, tg, lse, delta, causal)
    for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **BWD)


def test_bf16_inputs_accumulate_in_f32():
    q, k, v = _rand(np.random.RandomState(2), (1, 64, 2, 32))
    bq, bk, bv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, _ = jfa.flash_attention_with_lse(bq, bk, bv, block_q=32, block_k=32,
                                         interpret=True)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jo, np.float32), atol=1e-2)
    # the backward of bf16 inputs: fp32 gradients, to bf16 tolerance
    g = np.random.RandomState(3).normal(size=q.shape).astype(np.float32)
    jl = jfa.flash_attention_with_lse(bq, bk, bv, block_q=32, block_k=32,
                                      interpret=True)[1]
    jg = jfa.flash_attention_bwd(bq, bk, bv, jo, jl,
                                 jnp.asarray(g, jnp.bfloat16), block_q=32,
                                 block_k=32, interpret=True)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    got = fa.flash_attention_bwd(tq, tk, tv, out, lse, tg)
    for a, b in zip(got, jg):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-2)


def test_fully_masked_rows_are_zero_not_nan():
    """The JAX test's case (tests/test_flash_attention.py:83-92), and
    rows with no key at all (``Lk = 0``): zeros, never NaN."""
    q, k, v = _rand(np.random.RandomState(4), (1, 20, 1, 8))
    jo, jl = jfa.flash_attention_with_lse(q, k, v, causal=True, block_q=16,
                                          block_k=16, interpret=True)
    out, lse = fa.flash_attention_with_lse(*_t(q, k, v), causal=True)
    assert not torch.isnan(out).any()
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **FWD)
    # no key for any row: every row fully masked -> 0 and lse ~ -1e30
    tq, tk, tv = _t(q, k[:, :0], v[:, :0])
    out0, lse0 = fa.flash_attention_with_lse(tq, tk, tv)
    assert torch.equal(out0, torch.zeros_like(out0))
    assert bool((lse0 <= -1e29).all())


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_autograd_matches_jax_vjp(causal):
    rng = np.random.RandomState(3)
    q, k, v, g = _rand(rng, (1, 32, 2, 16), 4)

    def f(q, k, v):
        return jfa.fused_attention(q, k, v, causal, True)

    jo, vjp = jax.vjp(f, q, k, v)
    jg = vjp(jnp.asarray(g))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.fused_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **FWD)
    out.backward(torch.from_numpy(g))
    for t, ref in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **BWD)
    # the dense path (GEOMX_FLASH_ATTN=0) gives the same gradients
    dq = [t.grad.clone() for t in (tq, tk, tv)]
    for t in (tq, tk, tv):
        t.grad = None
    fa._dense(tq, tk, tv, causal).backward(torch.from_numpy(g))
    for t, ref in zip((tq, tk, tv), dq):
        np.testing.assert_allclose(t.grad.numpy(), ref.numpy(), **BWD)


def test_fused_attention_switch_and_lse_only_for_gradients(monkeypatch):
    q, k, v = _t(*_rand(np.random.RandomState(5), (1, 16, 1, 8)))
    calls = []
    real = fa.flash_attention_with_lse

    def spy(*a, **kw):
        calls.append(kw.get("with_lse", True))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_with_lse", spy)
    with torch.no_grad():
        fa.fused_attention(q, k, v)
    fa.fused_attention(q.requires_grad_(), k, v)
    assert calls == [False, True]
    monkeypatch.setenv("GEOMX_FLASH_ATTN", "0")
    assert not fa.fused_attention_supported()
    out = fa.fused_attention(q, k, v)
    assert len(calls) == 2
    np.testing.assert_allclose(out.detach().numpy(),
                               full_attention_reference(q, k, v).detach()
                               .numpy(), **FWD)


def _hop_inputs(rng, shape, hops_done):
    B, L, H, D = shape
    q, k, v = _rand(rng, shape)
    if hops_done == 0:
        m = np.full((B, H, L), -np.inf, np.float32)
        l_acc = np.zeros((B, H, L), np.float32)
        o = np.zeros(shape, np.float32)
    else:
        m = rng.normal(size=(B, H, L)).astype(np.float32)
        l_acc = rng.uniform(0.5, 3.0, size=(B, H, L)).astype(np.float32)
        o = rng.normal(size=shape).astype(np.float32)
    return q, k, v, m, l_acc, o


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("hops_done", [0, 1])
def test_hop_plain_and_vjp_match_pallas(hops_done, diag):
    rng = np.random.RandomState(6 + hops_done)
    shape = (2, 32, 2, 16)
    args = _hop_inputs(rng, shape, hops_done)
    scale = 1.0 / np.sqrt(16)

    def f(*a):
        return jfb.fused_block(*a, scale, diag, 16, True)

    jout, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in jout]
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    targs = [t.requires_grad_() for t in _t(*args)]
    out = fb.fused_block(*targs, scale, diag, 16)
    for got, ref in zip(out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **BWD)
    torch.autograd.backward(out, _t(*cots))
    for t, ref in zip(targs, jg):
        ref = np.asarray(ref)
        if hops_done == 0 and t is targs[3]:
            continue  # d/dm at m = -inf: 0 in both, compared below
        np.testing.assert_allclose(t.grad.numpy(), ref, **BWD)
    assert torch.isfinite(targs[3].grad).all()


def test_hop_raises_on_untiled_lengths():
    args = _t(*_hop_inputs(np.random.RandomState(8), (1, 24, 1, 8), 1))
    with pytest.raises(ValueError):
        ring_hop.hop(*args, 0.3, False, block=16)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), axis_names=("sp",))


def _jax_sp(fn, q, k, v, n, causal):
    spec = P(None, "sp", None, None)

    def f(ql, kl, vl):
        return fn(ql, kl, vl, "sp", causal=causal)

    return np.asarray(jax.jit(shard_map_compat(
        f, _mesh(n), in_specs=(spec, spec, spec), out_specs=spec))(q, k, v))


def _shards(x, S):
    """[B, L, ...] -> the port's sp layout [S, B, L/S, ...]."""
    B, L = x.shape[:2]
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(B, S, L // S, *x.shape[2:]).swapaxes(0, 1)))


def _unshard(t):
    S, B, Ls = t.shape[:3]
    return t.detach().transpose(0, 1).reshape(B, S * Ls, *t.shape[3:]).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [2, 4])
def test_ring_matches_jax_shard_map(S, causal):
    rng = np.random.RandomState(0)
    q, k, v = _rand(rng, (2, 64, 2, 16))
    ref = _jax_sp(jring, q, k, v, S, causal)
    for use_fused in (None, False):   # the fused hop's plain version; _block
        out = ring_attention(*(_shards(x, S) for x in (q, k, v)), causal,
                             use_fused=use_fused)
        np.testing.assert_allclose(_unshard(out), ref, **BWD)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [2, 4])
def test_ulysses_matches_jax_shard_map(S, causal):
    rng = np.random.RandomState(1)
    q, k, v = _rand(rng, (2, 64, 4, 16))
    ref = _jax_sp(julysses, q, k, v, S, causal)
    for use_fused in (None, False):  # flash plain versions; streaming
        out = ulysses_attention(*(_shards(x, S) for x in (q, k, v)), causal,
                                use_fused=use_fused)
        np.testing.assert_allclose(_unshard(out), ref, **BWD)


def test_ring_gradients_match_jax():
    rng = np.random.RandomState(9)
    q, k, v = _rand(rng, (1, 32, 2, 8))
    S = 2
    spec = P(None, "sp", None, None)

    def loss(q, k, v):
        out = shard_map_compat(
            lambda a, b, c: jring(a, b, c, "sp", causal=True), _mesh(S),
            in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)
        return jnp.sum(out * out)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (_shards(x, S).requires_grad_() for x in (q, k, v))
    out = ring_attention(tq, tk, tv, causal=True)
    (out * out).sum().backward()
    for t, ref in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(_unshard(t.grad), np.asarray(ref), **BWD)


@pytest.mark.parametrize("S", [2, 4])
def test_sp_collectives_match_jax(S):
    rng = np.random.RandomState(10)
    x = rng.normal(size=(2, 8, 4, 3)).astype(np.float32)  # [B, L, H, D]
    spec = P(None, "sp", None, None)

    def run(f, out_spec=spec):
        return np.asarray(jax.jit(shard_map_compat(
            f, _mesh(S), in_specs=(spec,), out_specs=out_spec))(x))

    perm = [(i, (i + 1) % S) for i in range(S)]
    ref = run(lambda a: jax.lax.ppermute(a, "sp", perm))
    np.testing.assert_array_equal(_unshard(ppermute_sp(_shards(x, S))), ref)
    a2a = run(lambda a: jax.lax.all_to_all(a, "sp", split_axis=2,
                                           concat_axis=1, tiled=True),
              P(None, None, "sp", None))
    got = all_to_all_sp(_shards(x, S), split_dim=-2, concat_dim=-3)
    # shard s holds heads [s H/S, (s + 1) H/S) of the whole sequence
    np.testing.assert_array_equal(
        torch.cat(list(got), dim=-2).numpy(), a2a)
    back = all_to_all_sp(got, split_dim=-3, concat_dim=-2)
    np.testing.assert_array_equal(_unshard(back), x)
    mean = run(lambda a: jax.lax.pmean(a, "sp"))
    got = pmean_sp(_shards(x, S))
    np.testing.assert_allclose(_unshard(got), mean, atol=1e-6)
