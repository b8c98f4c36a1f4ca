"""The port's package rules: no JAX at run time, explicit devices, the
configuration surface and the compression spec grammar shared with
geomx_tpu."""

import ast
import os

import pytest
import torch

from geomx_tpu.compression import get_compressor as jax_get_compressor
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu_torch import GeoConfig, HiPSTopology, resolve_device
from geomx_tpu_torch.compression import (BiSparseCompressor,
                                         BucketedCompressor, FP16Compressor,
                                         MPQCompressor, NoCompressor,
                                         TwoBitCompressor, get_compressor)
from geomx_tpu_torch.sync import FSA, get_sync_algorithm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "geomx_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "geomx_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tools", "torch_profile_step.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax_or_reference():
    # the step profiler imports chip_smoke and the port: neither may pull
    # in JAX
    sources = list(_port_sources())
    assert len(sources) > 20
    for path in sources:
        bad = set(_imported_roots(path)) & set(BANNED)
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_entry_points_need_an_explicit_cpu_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_config_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    monkeypatch.setenv("GEOMX_COMPRESSION", "bsc,0.01")
    monkeypatch.setenv("GEOMX_BUCKET_BYTES", "65536")
    monkeypatch.setenv("GEOMX_PRECISION", "bf16")
    monkeypatch.setenv("GEOMX_2BIT_THRESHOLD", "0.25")
    monkeypatch.setenv("GEOMX_FUSED_OPTIM", "1")
    port, ref = GeoConfig.from_env(), JaxConfig.from_env()
    for field in ("num_parties", "workers_per_party", "sync_mode",
                  "compression", "bucket_bytes", "precision",
                  "twobit_threshold", "fused_optim"):
        assert getattr(port, field) == getattr(ref, field), field


def test_compression_spec_grammar():
    c = get_compressor("bsc,0.02,min_sparse_size=2048")
    r = jax_get_compressor("bsc,0.02,min_sparse_size=2048,select=sampled")
    assert isinstance(c, BiSparseCompressor)
    assert (c.ratio, c.min_sparse_size, c.select) == \
        (r.ratio, r.min_sparse_size, r.select)
    assert c.k_for(272_474) == r.k_for(272_474) == 5450
    assert isinstance(get_compressor("none"), NoCompressor)
    assert isinstance(get_compressor(None), NoCompressor)
    for bad in ("bsc,0.01,nope=1", "bsc,ratio=0.1,0.2", "zip"):
        with pytest.raises(ValueError):
            get_compressor(bad)
    two, ref2 = get_compressor("2bit,0.5"), jax_get_compressor("2bit,0.5")
    assert isinstance(two, TwoBitCompressor)
    assert two.threshold == ref2.threshold == 0.5
    assert get_compressor("2bit,threshold=0.3").threshold == 0.3
    # the modes ported with the compressed-domain aggregation construct
    # as the JAX package's do
    for spec, cls in (("fp16", FP16Compressor),
                      ("mpq,0.01,1000", MPQCompressor),
                      ("bsc,0.01,select=exact", BiSparseCompressor),
                      ("2bit,0.5,sparse_agg=1", TwoBitCompressor)):
        port, ref = get_compressor(spec), jax_get_compressor(spec)
        assert isinstance(port, cls) and type(ref).__name__ == cls.__name__
        assert getattr(port, "sparse_agg", None) == \
            getattr(ref, "sparse_agg", None)
    assert get_compressor("mpq,0.01,1000").size_lower_bound == 1000
    assert get_compressor("bsc,0.01,select=exact").select == "exact"
    # what stays unported still raises: bsc's kernel switch (the port
    # picks kernels by device)
    with pytest.raises(ValueError, match="fused"):
        get_compressor("bsc,0.01,fused=1")


def test_fsa_buckets_the_dc_tier_by_default(monkeypatch):
    cfg = GeoConfig(num_parties=2, workers_per_party=4,
                    compression="bsc,0.01")
    sync = get_sync_algorithm(cfg).bind_topology(HiPSTopology(2, 4))
    assert isinstance(sync, FSA)
    assert isinstance(sync.dc_compressor, BucketedCompressor)
    assert sync.dc_compressor.bucket_bytes == 4 * 1024 * 1024
    assert isinstance(sync.dc_compressor.inner, BiSparseCompressor)
    off = get_sync_algorithm(GeoConfig(compression="bsc,0.01",
                                       bucket_bytes=0))
    assert isinstance(off.dc_compressor, BiSparseCompressor)
    # HFA is ported and gets the same bucketed dc-tier default
    hfa = get_sync_algorithm(GeoConfig(sync_mode="hfa"))
    assert type(hfa).__name__ == "HFA"
    assert isinstance(hfa.dc_compressor, BucketedCompressor)
    with pytest.raises(ValueError, match="Unknown sync mode"):
        get_sync_algorithm(GeoConfig(sync_mode="esync"))
    # a dead party binds (the survivor mean); HFA refuses one
    assert sync.bind_membership((True, False)).num_live == 1
    with pytest.raises(ValueError, match="does not support"):
        hfa.bind_topology(HiPSTopology(2, 4)).bind_membership((True, False))
