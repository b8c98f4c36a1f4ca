"""Port parity: 2-bit quantize/dequantize and the FSA sync with bucketed
"2bit" (geomx_tpu_torch vs geomx_tpu, on the CPU).

- The plain versions of ``quantize_2bit`` / ``dequantize_2bit`` against
  the Pallas kernels in interpret mode: packed words, residuals and
  dequantized values bit-equal (no multiply, so nothing contracts), at
  sizes around the 2048-element row and past 256 rows (a grid of more
  than one step), thresholds 0.5 and 0.3, and an all-negative input that
  sets every word's sign bit.
- The party sum: the parts add in party order, as the JAX compressor's
  ``sum(parts[1:], parts[0])`` does, bit for bit at a threshold that is
  not a power of two.
- The FSA sync with bucketed "2bit,0.5" on the conftest [2, 4] mesh
  against the JAX FSA with ``TwoBitCompressor(use_pallas=True,
  pallas_interpret=True)``: output and residuals bit-equal over 3 steps
  from a residual state carried across by the converter.  Gradients
  are multiples of 1/64 below 8, identical across a party's workers, so
  every worker mean is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_train import small_flax_params

from geomx_tpu.compression.twobit import TwoBitCompressor as JaxTwoBit
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.ops import twobit_pallas as jt
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.train.state import replicate_tree as jax_replicate
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.compression import TwoBitCompressor, get_compressor
from geomx_tpu_torch.models.convert import buckets_from_jax, from_flax
from geomx_tpu_torch.ops import twobit as pt
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.train.state import replicate_tree
from geomx_tpu_torch.tree import from_nested, leaf_names

torch.set_num_threads(2)

SIZES = [1, 2047, 2048, 2049, 272_512, 600_000]


@pytest.mark.parametrize("thr", [0.5, 0.3])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_dequantize_plain_match_pallas(n, thr):
    rng = np.random.RandomState(n % 997)
    g = rng.normal(0, 0.6, n).astype(np.float32)
    r = rng.normal(0, 0.1, n).astype(np.float32)
    jw, jr = jt.quantize_2bit(jnp.asarray(g), jnp.asarray(r), thr,
                              interpret=True)
    pw, pr = pt.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r), thr)
    assert pw.dtype == torch.int32 and pw.shape == (pt.num_words(n),)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    jd = jt.dequantize_2bit(jw, n, thr, interpret=True)
    pd = pt.dequantize_2bit(pw, n, thr)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    # codes really vary: some +thr, some -thr, some 0
    assert {-np.float32(thr), 0, np.float32(thr)} >= set(np.unique(pd))
    if n > 2048:
        assert len(np.unique(pd)) == 3


@pytest.mark.parametrize("thr", [0.5, 0.3])
@pytest.mark.parametrize("n", [4093, 4094, 4095])
def test_quantize_replica_rows_plain_match_pallas(n, thr):
    """``[2, 4, n]`` rows at n % 4 != 0 (the card kernel's element-wise
    branch): each row of the port's plain version against the Pallas
    kernel on that row alone.  Tolerance: none."""
    rng = np.random.RandomState(n)
    g = rng.normal(0, 0.6, (2, 4, n)).astype(np.float32)
    r = rng.normal(0, 0.1, (2, 4, n)).astype(np.float32)
    pw, pr = pt.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r), thr)
    assert pw.shape == (2, 4, pt.num_words(n)) and pr.shape == (2, 4, n)
    for b in range(2):
        for w in range(4):
            jw, jr = jt.quantize_2bit(jnp.asarray(g[b, w]),
                                      jnp.asarray(r[b, w]), thr,
                                      interpret=True)
            np.testing.assert_array_equal(pw[b, w].numpy(), np.asarray(jw))
            np.testing.assert_array_equal(pr[b, w].numpy(), np.asarray(jr))


def test_all_negative_input_sets_every_sign_bit():
    n = 4096 + 77
    g = np.full(n, -1.0, np.float32)
    r = np.zeros(n, np.float32)
    jw, jr = jt.quantize_2bit(jnp.asarray(g), jnp.asarray(r), 0.5,
                              interpret=True)
    pw, pr = pt.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r), 0.5)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    full = pw[:256]  # the two complete rows: every code 2
    assert (full == np.int32(np.uint32(0xAAAAAAAA).view(np.int32))).all()
    assert (pw < 0).sum() >= 256
    np.testing.assert_array_equal(
        pt.dequantize_2bit(pw, n, 0.5).numpy(),
        np.asarray(jt.dequantize_2bit(jw, n, 0.5, interpret=True)))


@pytest.mark.parametrize("parties", [2, 3])
def test_party_sum_in_order_matches_jax(parties):
    n, thr = 5000, 0.3
    rng = np.random.RandomState(parties)
    words, jparts = [], []
    for _ in range(parties):
        g = rng.normal(0, 0.6, n).astype(np.float32)
        w, _ = jt.quantize_2bit(jnp.asarray(g), jnp.zeros(n), thr,
                                interpret=True)
        words.append(np.asarray(w))
        jparts.append(jt.dequantize_2bit(w, n, thr, interpret=True))
    want = np.asarray(sum(jparts[1:], jparts[0]))
    got = pt.dequantize_2bit(torch.from_numpy(np.stack(words))[None], n,
                             thr, summed=True)
    assert got.shape == (1, n)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_twobit_threshold_must_be_positive():
    for bad in ("2bit,0", "2bit,-0.5", "2bit,threshold=0"):
        with pytest.raises(ValueError, match="greater than 0"):
            get_compressor(bad)
    with pytest.raises(ValueError, match="greater than 0"):
        TwoBitCompressor(-1.0)
    with pytest.raises(ValueError, match="greater than 0"):
        pt.quantize_2bit(torch.zeros(4), torch.zeros(4), 0.0)


def _grid(rng, shape):
    """Multiples of 1/64 in (-8, 8): worker means and 2-bit sums exact."""
    return (rng.randint(-512, 512, shape) / 64.0).astype(np.float32)


@pytest.mark.parametrize("bucket_bytes", [4 * 1024 * 1024, 16 * 1024])
def test_fsa_bucketed_twobit_sync_bit_equal(topo2x4, mesh2x4, bucket_bytes):
    params = small_flax_params()
    rng = np.random.RandomState(9)
    steps = [jax.tree.map(
        lambda a: np.repeat(np.stack([_grid(rng, a.shape)
                                      for _ in range(2)])[:, None], 4,
                            axis=1), params) for _ in range(4)]
    cfg = dict(num_parties=2, workers_per_party=4, compression="2bit,0.5",
               bucket_bytes=bucket_bytes)
    jsync = jax_sync(JaxConfig(**cfg), compressor=JaxTwoBit(
        0.5, use_pallas=True, pallas_interpret=True)).bind_topology(topo2x4)
    jstate = jax_replicate(jsync.init_state(params), topo2x4, mesh2x4)
    spec = P(DC_AXIS, WORKER_AXIS)

    def device_sync(g, st):
        sq = jax.tree.map(lambda a: a[0, 0], (g, st))
        out, st2 = jsync.sync_grads(sq[0], None, sq[1], jnp.int32(0))
        return jax.tree.map(lambda a: a[None, None], (out, st2))

    fn = jax.jit(shard_map_compat(device_sync, mesh2x4,
                                  in_specs=(spec, spec),
                                  out_specs=(spec, spec)))
    # one JAX step first: the port starts from its residuals
    _, jstate = fn(steps[0], jstate)

    topo = HiPSTopology(2, 4)
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(topo)
    pparams = replicate_tree(from_flax(params)[0], topo, "cpu")
    pstate = psync.init_state(pparams)
    pstate["dc_comp"] = buckets_from_jax(jax.device_get(jstate["dc_comp"]))
    comp = psync.dc_compressor
    assert [r.shape for r in pstate["dc_comp"]] == \
        [(2, 4, n) for n in comp.zero_bucketer(
            [pparams[k] for k in leaf_names(pparams)]).bucket_sizes]
    for step, grads in enumerate(steps[1:]):
        jout, jstate = fn(grads, jstate)
        pgrads = {k: torch.from_numpy(v)
                  for k, v in from_nested(grads).items()}
        pout, pstate = psync.sync_grads(pgrads, pparams, pstate, step)
        ref = from_nested(jax.tree.map(np.asarray, jout))
        assert leaf_names(pout) == leaf_names(ref)
        for k in ref:
            np.testing.assert_array_equal(pout[k].numpy(), ref[k],
                                          err_msg=f"step {step} {k}")
        for pr, jr in zip(pstate["dc_comp"], jstate["dc_comp"]):
            np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    # the wire carried codes, and its size is the Pallas format's
    wire = comp.inner.last_wire
    assert wire.shape[:3] == (2, 4, 2) and bool((wire != 0).any())
    assert 4 * pt.num_words(272_512) == JaxTwoBit(
        0.5, use_pallas=True).wire_bytes_leaf(jnp.zeros(272_512)) == \
        4 * 17_152
