"""Port parity: the Graft Auditor (geomx_tpu_torch/analysis/) against the
JAX package's (geomx_tpu/analysis/).

The JAX auditor reads jaxprs; the port's records a program by running it
(``analysis/record.py``).  On the CPU, at the JAX suite's sizes (the MLP
on [2, 1], 4 images a replica, made with numpy from seed 0):

- *Signature parity*: for each green configuration of
  ``tests/test_analysis.py`` the port's recorded collective signature
  equals the JAX ``collective_signature`` of the traced step, entry for
  entry (none differs; the sp metric pmean the JAX step adds at
  ``sp_degree > 1`` is outside these configurations);
- *Green configurations* audit to zero findings in both packages;
- *Corpus*: every ported entry is flagged with the JAX entry's rule id
  and severity, and ``NOT_PORTABLE`` names exactly what is left out;
- *Boundary wiring*: ``audit_cross_party`` equality and divergence; the
  Trainer audits membership swaps (its signatures equal to the JAX
  Trainer's), raises ``AuditError`` before a divergent swap, re-arms at
  a depth switch, records nothing with the audit off, and leaves the
  step's state and metrics bit-equal.

Every comparison here is exact.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.analysis import (NOT_PORTABLE, RENAMED, AuditContext,
                                      AuditError, CollectiveConsistencyPass,
                                      Finding, PurityPass,
                                      audit_compressed_path,
                                      audit_cross_party, audit_dtype_flow,
                                      audit_enabled, audit_severity_gate,
                                      audit_wire_accounting,
                                      collective_signature,
                                      diff_collective_signatures, enforce,
                                      record_program, summarize,
                                      walk_program)
from geomx_tpu_torch.analysis import hlo
from geomx_tpu_torch.analysis.corpus import CORPUS
from geomx_tpu_torch.analysis.passes import collective_wire_bytes
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.parallel import collectives
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.train import Trainer

GREEN_CONFIGS = (
    ("vanilla", {"compression": "none"}),
    ("bsc", {"compression": "bsc,0.05,min_sparse_size=16"}),
    ("bsc_sparseagg",
     {"compression": "bsc,0.05,min_sparse_size=16,sparse_agg=1"}),
    ("mpq", {"compression": "mpq,0.05"}),
    ("pipelined", {"compression": "none", "pipeline_depth": 1}),
    ("degraded", {"compression": "none", "_membership": (True, False)}),
)
BSC = "bsc,0.05,min_sparse_size=16"


def _batch():
    rng = np.random.RandomState(0)
    x = (rng.rand(2, 1, 4, 8, 8, 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, size=(2, 1, 4)).astype(np.int32)
    return x, y


def _fit_data():
    rng = np.random.RandomState(0)
    xs = (rng.rand(16, 8, 8, 3) * 255).astype(np.uint8)
    ys = rng.randint(0, 10, size=(16,)).astype(np.int32)
    return xs, ys


def _port_trainer(overrides, **cfg_fields):
    overrides = dict(overrides)
    membership = overrides.pop("_membership", None)
    cfg = GeoConfig(num_parties=2, workers_per_party=1, **overrides,
                    **cfg_fields)
    tr = Trainer(get_model("mlp", num_classes=10), HiPSTopology(2, 1),
                 sgd(0.1), config=cfg, device="cpu")
    x, y = _batch()
    state = tr.init_state(seed=0, sample_input=x[0, 0, :2])
    if membership is not None:
        state = tr.apply_membership(state, membership)
    return tr, state, torch.from_numpy(x), torch.from_numpy(y).long()


def _jax_trainer(overrides, audit=False, **cfg_fields):
    import jax
    import optax

    from geomx_tpu.config import GeoConfig as JaxConfig
    from geomx_tpu.models import get_model as jax_model
    from geomx_tpu.sync import get_sync_algorithm
    from geomx_tpu.topology import HiPSTopology as JaxTopology
    from geomx_tpu.train import Trainer as JaxTrainer

    overrides = dict(overrides)
    membership = overrides.pop("_membership", None)
    topo = JaxTopology(num_parties=2, workers_per_party=1)
    cfg = JaxConfig(num_parties=2, workers_per_party=1, audit=audit,
                    **overrides, **cfg_fields)
    tr = JaxTrainer(jax_model("mlp", num_classes=10), topo, optax.sgd(0.1),
                    sync=get_sync_algorithm(cfg), config=cfg, donate=False)
    x, y = _batch()
    state = tr.init_state(jax.random.PRNGKey(0), x[0, 0, :2])
    if membership is not None:
        state = tr.apply_membership(state, membership)
    sharding = topo.batch_sharding(tr.mesh)
    return tr, state, jax.device_put(x, sharding), \
        jax.device_put(y, sharding)


def _jax_signature(tr, state, xb, yb):
    import jax

    from geomx_tpu.analysis import collective_signature as jax_sig
    return jax_sig(jax.make_jaxpr(tr.train_step)(state, xb, yb))


def _dc(sync):
    return getattr(sync, "dc_compressor", None) or getattr(
        getattr(sync, "inner", None), "dc_compressor", None)


# --------------------------------------------------------------------------
# the recorder and the framework
# --------------------------------------------------------------------------

def test_collectives_call_the_recorder_with_jax_primitive_names():
    """Every collective calls the slot once, under the primitive its JAX
    function traces to, with the per-replica operand; pmax is recorded
    but stays out of the signature, as in the JAX package."""
    x = torch.zeros((2, 2, 8))

    def body(v):
        collectives.pmean(v, DC_AXIS)
        collectives.hier_pmean(v)
        collectives.psum_scatter(v, WORKER_AXIS)
        collectives.all_gather(v, DC_AXIS, tiled=True)
        collectives.all_to_all(v.view(2, 2, 2, 4), DC_AXIS)
        collectives.pmax(v, DC_AXIS)
        s = torch.zeros((2, 2, 8))                 # [S=2, 2, 8]
        collectives.ppermute_sp(s)
        collectives.pmean_sp(s)
        collectives.all_to_all_sp(s, 1, 0)

    rec = record_program(body, x)
    got = [(e.primitive, e.axes, e.operands[0], e.axis_size, e.extras)
           for e in rec.collectives()]
    f8 = ((8,), "float32")
    assert got == [
        ("psum", ("dc",), f8, 2, ()),
        ("psum", ("worker",), f8, 2, ()),
        ("psum", ("dc",), f8, 2, ()),
        ("reduce_scatter", ("worker",), f8, 2, ()),
        ("all_gather", ("dc",), f8, 2, ()),
        ("all_to_all", ("dc",), ((2, 4), "float32"), 2, ()),
        ("pmax", ("dc",), f8, 2, ()),
        ("ppermute", ("sp",), ((2, 8), "float32"), 2,
         (("perm", ((0, 1), (1, 0))),)),
        ("psum", ("sp",), ((2, 8), "float32"), 2, ()),
        ("all_to_all", ("sp",), ((2, 8), "float32"), 2, ()),
    ]
    assert "pmax" not in [s[0] for s in collective_signature(rec)]
    assert len(collective_signature(rec)) == len(got) - 1
    # the slot is empty again after the recording
    assert collectives.set_recorder(None) is None


def test_walk_order_scopes_and_sources_are_stable():
    from torch.profiler import record_function

    def prog(v):
        with record_function("outer"):
            with record_function("inner"):
                w = v * 2.0
            return collectives.psum(w, DC_AXIS)

    x = torch.zeros((2, 1, 4))
    rec = record_program(prog, x)
    sites = [(s.kind, s.primitive, s.path) for s in walk_program(rec)]
    assert ("aten", "mul", "outer/inner") in sites
    assert ("collective", "psum", "outer") in sites
    psum = [s for s in rec.events if s.kind == "collective"][0]
    assert os.path.basename(psum.source().split(":")[0]) == \
        "test_torch_analysis.py"
    assert [s.index for s in rec.events] == list(range(len(rec.events)))
    rec2 = record_program(prog, x)
    assert sites == [(s.kind, s.primitive, s.path)
                     for s in walk_program(rec2)]
    assert rec.ops() == rec2.ops()


def test_finding_severity_gate_and_enforce():
    ferr = Finding("GX-X-001", "error", "boom")
    fwarn = Finding("GX-X-002", "warning", "meh")
    assert enforce([fwarn], "error") == [fwarn]
    with pytest.raises(AuditError) as ei:
        enforce([fwarn, ferr], "error")
    assert "GX-X-001" in str(ei.value)
    assert ei.value.findings == [fwarn, ferr]
    with pytest.raises(AuditError):
        enforce([fwarn], "warning")
    assert summarize([ferr, fwarn, ferr]) == {"GX-X-001": 2, "GX-X-002": 1}
    with pytest.raises(ValueError):
        Finding("GX-X-003", "fatal", "bad severity")
    # the same messages as the JAX package's
    from geomx_tpu.analysis import AuditError as JaxAuditError
    from geomx_tpu.analysis import Finding as JaxFinding
    jf = [JaxFinding("GX-X-002", "warning", "meh"),
          JaxFinding("GX-X-001", "error", "boom")]
    assert str(JaxAuditError(jf, "error")) == str(AuditError(
        [fwarn, ferr], "error"))


def test_audit_gate_parses_like_jax(monkeypatch):
    from geomx_tpu.analysis import audit_enabled as jax_enabled
    from geomx_tpu.analysis import audit_severity_gate as jax_gate
    monkeypatch.delenv("GEOMX_AUDIT", raising=False)
    monkeypatch.delenv("GEOMX_AUDIT_SEVERITY", raising=False)
    assert audit_enabled() is jax_enabled() is False
    assert audit_enabled(GeoConfig(audit=True)) is True
    monkeypatch.setenv("GEOMX_AUDIT", "1")
    assert audit_enabled() is jax_enabled() is True
    monkeypatch.setenv("GEOMX_AUDIT_SEVERITY", "warning")
    assert audit_severity_gate() == jax_gate() == "warning"
    monkeypatch.setenv("GEOMX_AUDIT_SEVERITY", "fatal")
    with pytest.raises(ValueError):
        audit_severity_gate()


def test_diff_names_first_divergent_position():
    x = torch.zeros((2, 1, 64))

    def a(v):
        return collectives.psum(v, DC_AXIS)

    def b(v):
        return collectives.psum(v, DC_AXIS) + collectives.psum(v * 2,
                                                               DC_AXIS)

    findings = diff_collective_signatures(
        {"p0": collective_signature(record_program(a, x)),
         "p1": collective_signature(record_program(b, x))})
    assert len(findings) == 1
    f = findings[0]
    assert f.rule_id == "GX-COLLECTIVE-001" and f.severity == "error"
    assert f.detail["position"] == 1
    assert "p1" in f.message and "deadlock" in f.message
    # a record, a signature and builders all coexist
    rec = record_program(a, x)
    assert audit_cross_party({"r": rec, "s": collective_signature(rec),
                              "f": lambda: record_program(a, x)}) == []
    assert audit_cross_party({"a": 64, "b": 64}, build=lambda n:
                             record_program(a, torch.zeros((2, 1, n)))) == []


def test_collective_wire_bytes_matches_jax_per_chip_and_payload():
    """The scatter family's per-chip conventions on the same program as
    the JAX test: psum counts its operand once, the reduce-scatter
    (N-1)/N of its operand, the all_gather its shard N-1 times."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from geomx_tpu.analysis.passes import \
        collective_wire_bytes as jax_bytes
    from geomx_tpu.parallel.collectives import shard_map_compat

    n_axis, n = 4, 1024
    mesh = Mesh(np.array(jax.devices()[:n_axis]), ("w",))

    def trace(body):
        fn = shard_map_compat(body, mesh, in_specs=(P("w"),),
                              out_specs=P("w"))
        return jax.make_jaxpr(fn)(jnp.zeros((n_axis, n), jnp.float32))

    def j_scatter_gather(v):
        sh = lax.psum_scatter(v[0].reshape(n_axis, n // n_axis), "w",
                              scatter_dimension=0)
        return lax.all_gather(sh, "w").reshape(1, n)

    def p_scatter_gather(v):
        sh = collectives.psum_scatter(v, DC_AXIS)
        return collectives.all_gather(sh, DC_AXIS, tiled=True)

    x = torch.zeros((n_axis, 1, n))
    for conv in ("per_chip", "payload"):
        assert collective_wire_bytes(
            record_program(lambda v: collectives.psum(v, DC_AXIS), x),
            convention=conv) == jax_bytes(
                trace(lambda v: lax.psum(v, "w")), convention=conv) == 4 * n
        assert collective_wire_bytes(record_program(p_scatter_gather, x),
                                     convention=conv) == \
            jax_bytes(trace(j_scatter_gather), convention=conv)
    assert collective_wire_bytes(record_program(p_scatter_gather, x)) == \
        int(4 * n * (n_axis - 1) / n_axis + 4 * (n // n_axis) * (n_axis - 1))


def test_wire_audit_keeps_honest_gather_compressors_clean_at_n4():
    from geomx_tpu_torch.compression import get_compressor
    params = {"w": torch.zeros((4096,))}
    for spec in ("fp16", "bsc,0.01", "2bit"):
        findings = audit_wire_accounting(get_compressor(spec), params,
                                         num_parties=4)
        assert findings == [], (spec, [f.message for f in findings])
    lie = next(e for e in CORPUS if e.name == "scatter_wire_lie").run()
    assert {f.rule_id for f in lie} == {"GX-DTYPE-002"}


def test_green_bf16_compute_path_is_leak_free():
    w = torch.zeros((32, 32), dtype=torch.bfloat16)
    assert audit_dtype_flow(lambda x: (x @ w) @ w,
                            torch.zeros((4, 32), dtype=torch.bfloat16)) == []


def test_purity_post_collective_counts_only_after_last_collective():
    """Two buckets: bucket 1's select chain (its dense EF-reset scatter
    included) runs after bucket 0's gather; only what follows the last
    collective counts, and the single final decompress is allowed."""
    from geomx_tpu_torch.compression import BucketedCompressor
    from geomx_tpu_torch.compression.bisparse import BiSparseCompressor

    comp = BucketedCompressor(
        BiSparseCompressor(ratio=0.05, select="exact", min_sparse_size=1,
                           sparse_agg=False),
        bucket_bytes=16 * 1024)
    params = [torch.zeros((4000,)), torch.zeros((3800,))]
    assert len(comp.init_state(
        {str(i): p.expand(2, 1, -1) for i, p in enumerate(params)})) == 2
    findings = audit_compressed_path(comp, params)
    assert findings == [], [f.format() for f in findings]


def test_purity_flags_second_densify_after_final_collective():
    n, k = 4096, 64

    def bad(vals, idx):
        g = collectives.all_gather(vals, DC_AXIS)   # compressed wire
        gi = collectives.all_gather(idx, DC_AXIS)
        out = torch.zeros((2, 1, n))
        for p in range(2):                          # per-party densify
            ok = gi[:, :, p] >= 0
            out = out + torch.zeros((2, 1, n)).scatter_add(
                -1, torch.where(ok, gi[:, :, p], 0),
                torch.where(ok, g[:, :, p], 0.0))
        return out

    rec = record_program(bad, torch.zeros((2, 1, k)),
                         torch.zeros((2, 1, k), dtype=torch.int64))
    findings = PurityPass().run(rec, AuditContext(
        dense_bytes=4 * n, extras={"replicas": 2}))
    assert findings and all(f.rule_id == "GX-PURITY-001"
                            for f in findings)
    assert any("after the final collective" in f.message
               for f in findings)
    clean = PurityPass().run(rec, AuditContext(
        dense_bytes=4 * n,
        extras={"replicas": 2, "allowed_dense_after_collective": 2}))
    assert clean == []


def test_op_counts_and_verdict_contracts():
    """hlo.py's contracts on the CPU (both routes are the plain versions
    here): the plain sampled select materializes its cumsums, scatter
    and gather; a verdict removes dense ops only when the fused side has
    none; without a kernel launch the removal assertion fails."""
    from geomx_tpu_torch.ops.sampled_topk import sampled_threshold_select
    v = torch.randn((2, 1, 4096), generator=torch.Generator().manual_seed(0))
    counts = hlo.materialization_counts(
        lambda a: sampled_threshold_select(a, a.abs(), 41), v)
    assert counts["cumsum"] == 2 and counts["scatter"] == 1 \
        and counts["gather"] == 1
    assert counts["total"] == sum(c for k, c in counts.items()
                                  if k in hlo.MATERIALIZING_OPS)
    assert counts["kernel_launches"] == 0
    verdict = hlo.compare_paths(
        lambda a: sampled_threshold_select(a, a.abs(), 41),
        lambda a: a * 2.0, v, dense_ops=("cumsum", "scatter"))
    assert verdict["dense_intermediates_removed"]
    assert verdict["dense_unfused"] == 3 and verdict["dense_fused"] == 0
    with pytest.raises(AssertionError, match="kernel launch"):
        hlo.assert_dense_intermediates_removed(verdict)
    hlo.assert_ops_absent(lambda a: a * 2.0, v, ops=("scatter",))
    with pytest.raises(AssertionError, match="ABSENT"):
        hlo.assert_ops_absent(lambda a: torch.cumsum(a, -1), v,
                              ops=("cumsum",))


# --------------------------------------------------------------------------
# the green configurations: signature parity and zero findings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,overrides", GREEN_CONFIGS,
                         ids=[n for n, _ in GREEN_CONFIGS])
def test_green_signature_equals_jax(name, overrides):
    """The recorded step's collective signature equals the JAX
    signature of the traced step, entry for entry."""
    tr, state, xb, yb = _port_trainer(overrides)
    port = collective_signature(record_program(tr.train_step, state, xb,
                                               yb))
    jax_sig = _jax_signature(*_jax_trainer(overrides))
    assert len(port) == len(jax_sig) >= 3
    for i, (p, j) in enumerate(zip(port, jax_sig)):
        assert p == j, (i, p, j)


@pytest.mark.parametrize("name,overrides", GREEN_CONFIGS,
                         ids=[n for n, _ in GREEN_CONFIGS])
def test_green_configs_audit_clean_in_both(name, overrides):
    import jax

    from geomx_tpu.analysis import AuditContext as JaxContext
    from geomx_tpu.analysis import CollectiveConsistencyPass as JaxPass
    from geomx_tpu.analysis import audit_compressed_path as jax_purity
    from geomx_tpu.analysis import audit_wire_accounting as jax_wire

    tr, state, xb, yb = _port_trainer(overrides)
    rec = record_program(tr.train_step, state, xb, yb)
    findings = CollectiveConsistencyPass().run(rec, AuditContext())
    params = {k: v[0, 0] for k, v in state.params.items()}
    dc = _dc(tr.sync)
    if dc is not None:
        findings += audit_wire_accounting(dc, params)
        findings += audit_compressed_path(dc, params)
    assert findings == [], [f.format() for f in findings]
    jt, jst, jx, jy = _jax_trainer(overrides)
    jfind = JaxPass().run(jax.make_jaxpr(jt.train_step)(jst, jx, jy),
                          JaxContext())
    jparams = jax.tree.map(lambda a: a[0, 0], jst.params)
    jdc = _dc(jt.sync)
    if jdc is not None:
        jfind += jax_wire(jdc, jparams) + jax_purity(jdc, jparams)
    assert jfind == []


# --------------------------------------------------------------------------
# the corpus and what the port leaves out
# --------------------------------------------------------------------------

@pytest.mark.parametrize("entry", CORPUS, ids=[e.name for e in CORPUS])
def test_corpus_flagged_with_the_jax_rule(entry):
    from geomx_tpu.analysis.corpus import CORPUS as JAX_CORPUS
    findings = entry.run()
    rules = {f.rule_id for f in findings}
    assert rules == {entry.expected_rule}, \
        [f.format() for f in findings]
    assert {f.severity for f in findings} == {"error"}
    assert all(f.message for f in findings)
    jax_entry = next(e for e in JAX_CORPUS if e.name == entry.name)
    jfind = jax_entry.run()
    assert jax_entry.expected_rule == entry.expected_rule
    assert {f.rule_id for f in jfind} == rules
    assert {f.severity for f in jfind} == {"error"}


def test_run_corpus_keeps_its_record_shape():
    from geomx_tpu_torch.analysis.corpus import run_corpus
    out = run_corpus()
    assert sorted(out) == sorted(e.name for e in CORPUS)
    for rec in out.values():
        assert sorted(rec) == ["expected_rule", "finding_count",
                               "finding_rules", "flagged"]
        assert rec["flagged"] and rec["finding_rules"] == \
            [rec["expected_rule"]]


def _public(module):
    """Names a module defines itself: its functions, classes and
    upper-case constants."""
    out = set()
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        if getattr(obj, "__module__", None) == module.__name__ or \
                (name.isupper() and not callable(obj)):
            out.add(name)
    return out


def test_not_portable_names_exactly_what_is_left_out():
    """Every public name of each JAX analysis module, every corpus entry
    and every rule id has its port counterpart (under its own name or
    its ``RENAMED`` one) or stands in ``NOT_PORTABLE``; nothing in
    ``NOT_PORTABLE`` exists in the port."""
    import importlib

    import geomx_tpu.analysis as jax_analysis
    from geomx_tpu.analysis.corpus import CORPUS as JAX_CORPUS

    port_names = set()
    missing = set()
    for mod in ("core", "passes", "hlo", "corpus"):
        jmod = importlib.import_module(f"geomx_tpu.analysis.{mod}")
        pmod = importlib.import_module(f"geomx_tpu_torch.analysis.{mod}")
        from geomx_tpu_torch.analysis import record
        here = _public(pmod) | _public(record)
        port_names |= here
        for name in _public(jmod):
            if name not in here and RENAMED.get(name) not in here:
                missing.add(name)
    import geomx_tpu.analysis.passes as jax_passes
    import geomx_tpu_torch.analysis.passes as port_passes
    rule = r"GX-[A-Z]+-\d{3}"
    # the port's rule list ends where its docstring names what it leaves
    port_doc = port_passes.__doc__.split("``GX-DONATE-001``/")[0]
    missing |= set(re.findall(rule, jax_passes.__doc__)) - \
        set(re.findall(rule, port_doc))
    missing |= {e.name for e in JAX_CORPUS} - {e.name for e in CORPUS}
    missing |= {"axis_index_groups"}  # the consistency pass's warning
    assert missing == set(NOT_PORTABLE), (
        sorted(missing - set(NOT_PORTABLE)),
        sorted(set(NOT_PORTABLE) - missing))
    assert not set(NOT_PORTABLE) & port_names
    # the package exports the JAX package's names, renamed where listed
    import geomx_tpu_torch.analysis as port_analysis
    for name in jax_analysis.__all__:
        assert name in NOT_PORTABLE or \
            RENAMED.get(name, name) in port_analysis.__all__, name
    assert "NOT_PORTABLE" in port_analysis.__all__


def test_graftlint_finds_nothing_in_the_port():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    try:
        import graftlint
    finally:
        sys.path.pop(0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings, _waivers = graftlint.lint_paths(
        [os.path.join(root, "geomx_tpu_torch")])
    assert findings == [], [str(f) for f in findings]


# --------------------------------------------------------------------------
# cross-party and the Trainer boundary
# --------------------------------------------------------------------------

def test_audit_cross_party_equality_and_injected_divergence():
    def sig_for(spec):
        tr, state, xb, yb = _port_trainer({"compression": spec})
        return collective_signature(record_program(tr.train_step, state,
                                                   xb, yb))

    bsc0, bsc1 = sig_for(BSC), sig_for(BSC)
    assert audit_cross_party({"party0": bsc0, "party1": bsc1}) == []
    findings = audit_cross_party({"party0": bsc0,
                                  "party1": sig_for("none")})
    assert len(findings) == 1
    assert findings[0].rule_id == "GX-COLLECTIVE-001"
    assert findings[0].detail["parties"] == ["party0", "party1"]


def _fit_port(audit_env, monkeypatch, **fields):
    if audit_env:
        monkeypatch.setenv("GEOMX_AUDIT", "1")
    else:
        monkeypatch.delenv("GEOMX_AUDIT", raising=False)
    tr, state, _x, _y = _port_trainer({"compression": BSC}, **fields)
    xs, ys = _fit_data()
    loader = tr.make_loader(xs, ys.astype(np.int64), batch_size=8)
    state, _ = tr.fit(state, loader, epochs=1, log_fn=lambda s: None)
    return tr, state


def _fit_jax(**fields):
    tr, state, _x, _y = _jax_trainer({"compression": BSC}, audit=True,
                                     **fields)
    xs, ys = _fit_data()
    loader = tr.make_loader(xs, ys, batch_size=8)
    state, _ = tr.fit(state, loader, epochs=1)
    return tr, state


def test_trainer_membership_swap_audits_clean_like_jax(monkeypatch):
    """GEOMX_AUDIT=1: fit arms the auditor, the swaps audit clean, and the
    signature cache holds the JAX Trainer's keys with its signatures."""
    tr, state = _fit_port(True, monkeypatch)
    assert tr._audit and tr._audit_args is not None
    state = tr.apply_membership(state, (True, False))
    state = tr.apply_membership(state, (True, True))
    assert tr.sync.live_parties is None
    jt, jst = _fit_jax()
    jst = jt.apply_membership(jst, (True, False))
    jst = jt.apply_membership(jst, (True, True))
    assert set(tr._audit_sigs) == set(jt._audit_sigs) == \
        {None, (True, False)}
    for key in jt._audit_sigs:
        assert tr._audit_sigs[key][0] == jt._audit_sigs[key][0], key
        assert tr._audit_sigs[key][1] == jt._audit_sigs[key][1] == []
    assert len(tr.audit_record_ms) == 2


def test_trainer_membership_divergence_raises_before_the_swap(monkeypatch):
    tr, state = _fit_port(True, monkeypatch)
    active_step = tr.train_step
    ref_sig, ref_findings = tr._audit_sigs[None]
    tr._audit_sigs[None] = (ref_sig[:-1], ref_findings)
    with pytest.raises(AuditError) as ei:
        tr.apply_membership(state, (True, False))
    assert any(f.rule_id == "GX-COLLECTIVE-002"
               for f in ei.value.findings)
    assert tr.train_step is active_step  # no swap happened
    assert tr.sync.live_parties is None and tr._membership is None
    # the active step still runs on every party
    x, y = _batch()
    _state, metrics = tr.train_step(state, torch.from_numpy(x),
                                    torch.from_numpy(y).long())
    assert float(metrics["num_live_parties"]) == 2.0


def test_trainer_audit_off_records_nothing(monkeypatch):
    def poison(fn):
        raise AssertionError("the recorder slot was set with the audit off")

    tr, state = _fit_port(False, monkeypatch, control=True)
    assert tr._audit is False
    monkeypatch.setattr(collectives, "set_recorder", poison)
    from geomx_tpu_torch.control import Decision
    state = tr.apply_membership(state, (True, False))
    state = tr.apply_membership(state, (True, True))
    state = tr.apply_control(state, Decision(step=0, kind="depth", value=1,
                                             prev=0, reason="r"))
    assert tr._audit_args is None and tr._audit_sigs == {}
    assert tr.audit_record_ms == []


def test_audited_steps_are_bit_equal_to_unaudited(monkeypatch):
    """The same fit, swap and steps with the audit on and off: every
    state tensor and metric the same bits."""
    def run(audit):
        tr, state = _fit_port(audit, monkeypatch)
        x, y = _batch()
        x, y = torch.from_numpy(x), torch.from_numpy(y).long()
        state = tr.apply_membership(state, (True, False))
        state, m1 = tr.train_step(state, x, y)
        state = tr.apply_membership(state, (True, True))
        state, m2 = tr.train_step(state, x, y)
        return tr, state, (m1, m2)

    t_on, s_on, m_on = run(True)
    t_off, s_off, m_off = run(False)
    assert t_on.audit_record_ms and not t_off.audit_record_ms

    def leaves(tree):
        out = []
        collect = (lambda x: out.append(x) or x)
        from geomx_tpu_torch.tree import state_map
        state_map(collect, tree)
        return [t for t in out if isinstance(t, torch.Tensor)]

    for field in ("params", "opt_state", "model_state", "sync_state"):
        a, b = leaves(getattr(s_on, field)), leaves(getattr(s_off, field))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y), field
    for ma, mb in zip(m_on, m_off):
        for k in ("loss", "accuracy", "num_live_parties"):
            assert torch.equal(ma[k], mb[k]), k


def test_depth_switch_rearms_on_the_jax_signature(monkeypatch):
    """A depth switch 0 -> 1 -> 0 under the audit re-arms the reference
    on each new step: one cache entry, the JAX Trainer's signature."""
    from geomx_tpu.control import Decision as JaxDecision
    from geomx_tpu_torch.control import Decision

    tr, state = _fit_port(True, monkeypatch, control=True)
    jt, jst = _fit_jax(control=True)
    for depth in (1, 0):
        state = tr.apply_control(state, Decision(
            step=0, kind="depth", value=depth, prev=1 - depth, reason="r"))
        jst = jt.apply_control(jst, JaxDecision(
            step=0, kind="depth", value=depth, prev=1 - depth, reason="r"))
        assert tr.control_depth() == depth
        assert list(tr._audit_sigs) == list(jt._audit_sigs) == [None]
        assert tr._audit_sigs[None][0] == jt._audit_sigs[None][0], depth
    assert len(tr.audit_record_ms) == 3
    # a swap after the re-arm diffs against the new reference, clean
    state = tr.apply_membership(state, (True, False))
