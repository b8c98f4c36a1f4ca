"""The port's KVStore against the JAX package's.

Every case of tests/test_store.py, run through the JAX store and the
port's store (on the CPU) on the same numpy inputs and compared: bit for
bit where the store only aggregates (dense sums, row-sparse scatter-adds,
the compressed cross-party hop), within rtol 1e-6 where an optimizer
applies.  The BSC hop's gradients are signed powers of two for two
rounds: XLA on the CPU contracts the momentum ``u * 0.9 + g`` into an
FMA and the port rounds after the multiply, which agree while ``u`` is a
power of two.  Save/load round-trips within the port (a JAX file holds
optax classes the port never imports).  Two more cases pin where the
port follows the JAX package on purpose: ``create("dist_async")`` is the
synchronous store, and a distributed store without a topology takes it
from ``GeoConfig.from_env()``.
"""

import types

import numpy as np
import optax
import pytest
import torch

from geomx_tpu.store import create as jax_create
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu_torch import optim as port_optim
from geomx_tpu_torch.store import KVStore, create
from geomx_tpu_torch.topology import HiPSTopology
from geomx_tpu_torch.tree import state_map
from geomx_tpu_torch.utils.checkpoint import to_host


def _port_create(name="local", topology=None):
    return create(name, topology, device="cpu")


JAX = types.SimpleNamespace(
    create=jax_create, Topology=JaxTopology, sgd=optax.sgd, adam=optax.adam,
    adamw=optax.adamw)
PORT = types.SimpleNamespace(
    create=_port_create, Topology=HiPSTopology, sgd=port_optim.sgd,
    adam=port_optim.adam, adamw=port_optim.alias.adamw)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])


def host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def both(fn):
    """``fn`` run through each package, results as numpy."""
    def run(P):
        out = fn(P)
        return {k: host(v) for k, v in out.items()}
    return run(JAX), run(PORT)


def assert_bits(ref, out):
    assert set(ref) == set(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype and ref[k].shape == out[k].shape
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def assert_close(ref, out, rtol=1e-6):
    assert set(ref) == set(out)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=rtol, atol=0,
                                   err_msg=k)


def pow2(rng, shape):
    """Signed powers of two and zeros: ``0.9 * u`` stays exact."""
    x = np.ldexp(1.0, -rng.randint(0, 10, shape)).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], shape).astype(np.float32)
    x[rng.rand(*shape) < 0.2] = 0.0
    return x


def test_local_init_push_pull():
    def fn(P):
        kv = P.create("local")
        kv.init(0, np.ones((4,), np.float32))
        first = host(kv.pull(0)).copy()
        # push without optimizer = aggregation (local tier semantics)
        kv.push(0, np.full((4,), 2.0, np.float32))
        return {"first": first, "after": kv.pull(0)}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["after"], 2.0)
    assert_bits(ref, out)


def test_multi_device_push_sums():
    rng = np.random.RandomState(0)
    parts = [rng.randn(3).astype(np.float32) for _ in range(3)]

    def fn(P):
        kv = P.create("local")
        kv.init("w", np.zeros((3,), np.float32))
        kv.push("w", [np.ones((3,), np.float32),
                      np.full((3,), 2.0, np.float32)])
        ones = host(kv.pull("w")).copy()
        kv.push("w", parts)
        return {"ones": ones, "gauss": kv.pull("w")}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["ones"], 3.0)
    assert_bits(ref, out)


@BOTH
def test_push_uninitialized_raises(P):
    kv = P.create("local")
    with pytest.raises(KeyError):
        kv.push("nope", np.zeros(2))
    with pytest.raises(KeyError):
        kv.pull("nope")
    kv.init("a", np.zeros(2))
    with pytest.raises(ValueError):
        kv.init("a", np.zeros(2))


def test_hier_push_aggregates_two_tiers():
    rng = np.random.RandomState(1)
    gauss = rng.randn(2, 4, 5).astype(np.float32)

    def fn(P):
        topo = P.Topology(num_parties=2, workers_per_party=2)
        kv = P.create("hips", topology=topo)
        assert (kv.num_all_workers, kv.num_workers) == (4, 2)
        assert kv.rank == 0 and kv.is_master_worker
        kv.init(0, np.zeros((5,), np.float32))
        kv.push(0, np.ones((2, 2, 5), np.float32))  # [parties, workers, dim]
        ones = host(kv.pull(0)).copy()
        kv.barrier()
        kv4 = P.create("hips", topology=P.Topology(2, 4))
        kv4.init(0, np.zeros((5,), np.float32))
        kv4.push(0, gauss)
        return {"ones": ones, "gauss": kv4.pull(0)}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["ones"], 4.0)
    assert_bits(ref, out)
    with pytest.raises(ValueError, match="incompatible"):
        kv = _port_create("hips", HiPSTopology(2, 2))
        kv.init(0, np.zeros((5,), np.float32))
        kv.push(0, np.ones((3, 5), np.float32))


def test_set_optimizer_turns_push_into_update():
    def fn(P):
        kv = P.create("local")
        kv.init("w", np.zeros((4,), np.float32))
        kv.set_optimizer(P.sgd(0.1))
        kv.push("w", np.ones((4,), np.float32))
        one = host(kv.pull("w")).copy()
        kv.push("w", np.ones((4,), np.float32))
        return {"one": one, "two": kv.pull("w")}
    ref, out = both(fn)
    np.testing.assert_allclose(out["one"], -0.1, rtol=1e-6)
    np.testing.assert_allclose(out["two"], -0.2, rtol=1e-6)
    assert_close(ref, out)


def test_set_gradient_compression_reference_kwargs():
    def fn(P):
        kv = P.create("dist_sync", topology=P.Topology(2, 1))
        kv.init(0, np.zeros((4096,), np.float32))
        kv.set_gradient_compression({"type": "bsc", "threshold": 0.01})
        g = np.zeros((2, 1, 4096), np.float32)
        g[0, 0, 7] = 10.0
        g[1, 0, 13] = -8.0
        kv.push(0, g)
        with pytest.raises(ValueError):
            kv.set_gradient_compression({"type": "wat"})
        return {"out": kv.pull(0)}
    ref, out = both(fn)
    o = out["out"]
    assert o[7] == 10.0 and o[13] == -8.0
    # sparsified: only top-ratio coordinates survive
    assert (o != 0).sum() <= 2 * int(np.ceil(4096 * 0.01))
    assert_bits(ref, out)


# the compressor on the cross-party hop, [2, 2] over three keys (one
# under BSC's min_sparse_size, so it goes dense), several rounds
SHAPES = {"big": (64, 80), "mid": (2048,), "small": (300,)}
HOPS = [({"type": "bsc", "threshold": 0.01}, 2),
        ({"type": "bsc", "threshold": 0.05}, 2),
        ({"type": "2bit", "threshold": 0.5}, 4),
        ({"type": "2bit", "threshold": 0.25}, 4),
        ({"type": "fp16"}, 2),
        ({"type": "mpq", "threshold": 0.01, "size_lower_bound": 1000}, 2)]


@pytest.mark.parametrize("params,rounds", HOPS,
                         ids=[f"{h[0]['type']}-{i}" for i, h in
                              enumerate(HOPS)])
def test_compressed_hop_bit_equal(params, rounds):
    """The per-party compressor with one error-feedback state a party:
    every round's pulls bit-equal to the JAX store's."""
    rng = np.random.RandomState(3)
    pushes = []
    for _ in range(rounds):
        push = {}
        for key, shape in SHAPES.items():
            if params["type"] in ("bsc", "mpq"):
                # a party's workers push the same powers of two: the
                # worker sum is exact and u stays a power of two
                g = pow2(rng, (2, 1) + shape)
                push[key] = np.repeat(g, 2, axis=1) / 2
            else:
                push[key] = rng.randn(2, 2, *shape).astype(np.float32)
        pushes.append(push)

    def fn(P):
        kv = P.create("hips", topology=P.Topology(2, 2))
        for key, shape in SHAPES.items():
            kv.init(key, np.zeros(shape, np.float32))
        kv.set_gradient_compression(params)
        out = {}
        for r, push in enumerate(pushes):
            for key in SHAPES:
                kv.push(key, push[key])
                out[f"{key}@{r}"] = host(kv.pull(key)).copy()
        return out
    ref, out = both(fn)
    assert_bits(ref, out)
    if params["type"] == "bsc":     # the hop really sparsified
        assert (out["big@0"] != 0).sum() <= 2 * int(np.ceil(5120 * 0.05))


def test_updater_hook():
    def fn(P):
        kv = P.create("local")
        kv.init("w", np.ones((2,), np.float32))
        kv._set_updater(lambda key, grad, weight: weight - 0.5 * grad)
        kv.push("w", np.ones((2,), np.float32))
        return {"w": kv.pull("w")}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["w"], 0.5)
    assert_bits(ref, out)


def test_optimizer_state_save_load(tmp_path):
    """Round trip within the port: the same state and the same gradient
    give the same Adam update; the updates track the JAX store's."""
    kv = _port_create("local")
    kv.init("w", np.zeros((4,), np.float32))
    kv.set_optimizer(port_optim.adam(0.1))
    kv.push("w", np.ones((4,), np.float32))
    f = str(tmp_path / "opt.states")
    kv.save_optimizer_states(f)
    kv2 = _port_create("local")
    kv2.init("w", np.zeros((4,), np.float32))
    kv2.set_optimizer(port_optim.adam(0.1))
    kv2.load_optimizer_states(f)
    # the loaded state is the saved one, bit for bit
    saved, loaded = to_host(kv._opt_state), to_host(kv2._opt_state)
    state_map(lambda a, b: np.testing.assert_array_equal(a, b), saved,
              loaded)
    w_kv, w_kv2 = host(kv.pull("w")).copy(), host(kv2.pull("w")).copy()
    kv.push("w", np.ones((4,), np.float32))
    kv2.push("w", np.ones((4,), np.float32))
    # same optimizer state + same grad -> same Adam update delta (the
    # weights differ, so the deltas round differently)
    d1 = host(kv.pull("w")) - w_kv
    d2 = host(kv2.pull("w")) - w_kv2
    np.testing.assert_allclose(d1, d2, rtol=1e-6)

    jkv = jax_create("local")
    jkv.init("w", np.zeros((4,), np.float32))
    jkv.set_optimizer(optax.adam(0.1))
    jkv.push("w", np.ones((4,), np.float32))
    w0 = np.asarray(jkv.pull("w"))
    jkv.push("w", np.ones((4,), np.float32))
    np.testing.assert_allclose(d1, np.asarray(jkv.pull("w")) - w0,
                               rtol=1e-6)


def test_multigps_partition_parity():
    from geomx_tpu.parallel.multigps import partition as jax_partition
    from geomx_tpu_torch.parallel.multigps import HASH_PRIME, partition
    sizes = [100, 2_000_000, 500]
    placements = partition(sizes, num_servers=4, bigarray_bound=1_000_000)
    ref = jax_partition(sizes, num_servers=4, bigarray_bound=1_000_000)
    assert placements[0].split is False
    assert placements[0].server == (0 * HASH_PRIME) % 4
    assert placements[2].server == (2 * HASH_PRIME) % 4
    assert placements[1].split is True
    for p, r in zip(placements, ref):
        assert (p.split, p.server) == (r.split, r.server)
        assert list(p.shard_bounds or []) == list(r.shard_bounds or [])


def test_pull_fills_out_array():
    def fn(P):
        kv = P.create("local")
        kv.init("w", np.arange(4, dtype=np.float32))
        buf = np.zeros((4,), np.float32)
        ret = kv.pull("w", out=buf)
        assert ret is buf
        with pytest.raises(TypeError):
            kv.pull("w", out=[0, 0, 0, 0])
        return {"buf": buf}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["buf"], np.arange(4))
    assert_bits(ref, out)
    # the port also fills a tensor
    kv = _port_create("local")
    kv.init("w", np.arange(4, dtype=np.float32))
    t = torch.zeros(4)
    assert kv.pull("w", out=t) is t
    np.testing.assert_array_equal(t.numpy(), np.arange(4))


def test_mixed_sync_dcasgd_opt_in():
    from geomx_tpu.config import GeoConfig as JaxConfig
    from geomx_tpu.sync import get_sync_algorithm as jax_sync
    from geomx_tpu_torch.config import GeoConfig
    from geomx_tpu_torch.sync import get_sync_algorithm
    for Cfg, get in ((JaxConfig, jax_sync), (GeoConfig, get_sync_algorithm)):
        plain = get(Cfg(sync_mode="dist_async"))
        assert plain.dcasgd_lambda == 0.0
        comp = get(Cfg(sync_mode="dist_async", dcasgd=True))
        assert comp.dcasgd_lambda == pytest.approx(0.04)


def test_row_sparse_push_pull():
    rng = np.random.RandomState(4)
    gauss = [rng.randn(3, 3).astype(np.float32) for _ in range(2)]

    def fn(P):
        kv = P.create("local")
        kv.init("emb", np.zeros((6, 3), np.float32))
        # two workers touch overlapping rows: duplicates accumulate
        kv.push_row_sparse(
            "emb", [np.array([0, 2]), np.array([2, 5])],
            [np.ones((2, 3), np.float32), 2 * np.ones((2, 3), np.float32)])
        ints = host(kv.pull("emb")).copy()
        rows = host(kv.row_sparse_pull("emb", np.array([2, 0]))).copy()
        kv.push_row_sparse("emb", [np.array([1, 4, 1]),
                                   np.array([4, 0, 3])], gauss)
        return {"ints": ints, "rows": rows, "gauss": kv.pull("emb")}
    ref, out = both(fn)
    got = out["ints"]
    np.testing.assert_array_equal(got[0], 1.0)
    np.testing.assert_array_equal(got[2], 3.0)   # 1 + 2
    np.testing.assert_array_equal(got[5], 2.0)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(out["rows"][0], 3.0)
    np.testing.assert_array_equal(out["rows"][1], 1.0)
    assert_bits(ref, out)


def test_row_sparse_push_with_optimizer():
    def fn(P):
        kv = P.create("local")
        kv.init("emb", np.ones((4, 2), np.float32))
        kv.set_optimizer(P.sgd(0.5))
        kv.push_row_sparse("emb", np.array([1, 3]),
                           np.ones((2, 2), np.float32))
        return {"emb": kv.pull("emb")}
    ref, out = both(fn)
    np.testing.assert_allclose(out["emb"][1], 0.5)   # 1 - 0.5*1
    np.testing.assert_array_equal(out["emb"][0], 1.0)  # untouched
    assert_close(ref, out)


def test_row_sparse_lazy_update_leaves_untouched_rows_alone():
    """Stateful/decaying optimizers must not move untouched rows — the
    reference's lazy row_sparse update semantics."""
    def fn(P):
        kv = P.create("local")
        kv.init("emb", np.ones((4, 2), np.float32))
        kv.set_optimizer(P.adamw(0.1, weight_decay=0.1))
        kv.push_row_sparse("emb", np.array([1]), np.ones((1, 2), np.float32))
        got1 = host(kv.pull("emb")).copy()
        # a second push touching a DIFFERENT row must not apply stale
        # momentum to the previously-touched row
        kv.push_row_sparse("emb", np.array([2]), np.ones((1, 2), np.float32))
        with pytest.raises(ValueError, match="row_id lists"):
            kv.push_row_sparse("emb", [np.array([0]), np.array([1])],
                               [np.ones((1, 2), np.float32)])
        return {"got1": got1, "got2": kv.pull("emb")}
    ref, out = both(fn)
    got1, got2 = out["got1"], out["got2"]
    np.testing.assert_array_equal(got1[0], 1.0)   # no weight decay leaked
    assert got1[1, 0] < 1.0                       # touched row updated
    np.testing.assert_array_equal(got2[1], got1[1])
    assert got2[2, 0] < 1.0
    assert_close(ref, out)


def test_row_sparse_aggregation_preserves_untouched_rows():
    def fn(P):
        kv = P.create("local")
        kv.init("emb", np.full((3, 2), 5.0, np.float32))
        kv.push_row_sparse("emb", np.array([1]), np.ones((1, 2), np.float32))
        kv.push_row_sparse("emb", np.array([2]), np.ones((1, 2), np.float32))
        return {"emb": kv.pull("emb")}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["emb"][0], 5.0)  # untouched
    np.testing.assert_array_equal(out["emb"][1:], 6.0)
    assert_bits(ref, out)


def test_dist_async_is_the_sync_store():
    """``create("dist_async")`` returns the synchronous store in both
    packages (VERDICT.md weak #4, mirrored on purpose): a push is merged
    before the next pull, as in ``dist_sync``."""
    def fn(P):
        kv = P.create("dist_async", topology=P.Topology(2, 2))
        assert kv.kind == "dist_async"
        kv.init("w", np.zeros((3,), np.float32))
        kv.push("w", np.ones((2, 2, 3), np.float32))
        return {"w": kv.pull("w")}
    ref, out = both(fn)
    np.testing.assert_array_equal(out["w"], 4.0)
    assert_bits(ref, out)
    kv = _port_create("dist_async", HiPSTopology(2, 2))
    assert type(kv) is KVStore


def test_dist_store_topology_from_the_environment(monkeypatch):
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    monkeypatch.setenv("GEOMX_WORKERS_PER_PARTY", "3")
    kv = _port_create("dist_sync")
    assert (kv.topology.num_parties, kv.topology.workers_per_party) == (2, 3)
    assert _port_create("local").topology == HiPSTopology(1, 1)
    with pytest.raises(ValueError, match="Unknown kvstore"):
        _port_create("bogus")


def test_store_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create("local")
    assert create("local", device="cpu").device == torch.device("cpu")
