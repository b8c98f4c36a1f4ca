"""Port parity: sequence parallelism on a ``[P, W, S]`` device mesh
(geomx_tpu_torch's sp mesh slots against the stacked sp step and the JAX
sp Trainer on the conftest's virtual devices).

On the mesh each sp slot runs one sequence chunk, as a JAX sp device
does: the ring's rotations and Ulysses' all-to-alls meet the other
shards' slots, the slot's backward runs segment by segment around them
(``collectives.SpTape``), and the step psums the gradients over sp.  The
stacked port runs one replica's shards in one autograd graph, so the two
sum the shards' contributions in different orders: losses to rtol/atol
2e-4 and params to 2e-3, the tolerances of ``tests/test_torch_seq.py``.
The attention alone (no optimizer step between) is held to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_mesh import TIMEOUT_S
from test_torch_seq import BATCH, MK, STEPS, L, _data, _jax_train

from geomx_tpu_torch import HiPSTopology
from geomx_tpu_torch.models import SeqClassifier
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.parallel import collectives as pc
from geomx_tpu_torch.parallel.ring_attention import ring_attention
from geomx_tpu_torch.parallel.ulysses import ulysses_attention
from geomx_tpu_torch.sync import FSA
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS, PlacedTree
from geomx_tpu_torch.train import Trainer

torch.set_num_threads(2)

SHAPE = (2, 2, 2)  # [P, W] x sp S


def sp_mesh(shape=SHAPE):
    return HiPSTopology(*shape).build_mesh(["cpu"] * int(np.prod(shape)),
                                           timeout_s=TIMEOUT_S)


def _trainer(mode, mesh=None, shape=SHAPE):
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return Trainer(SeqClassifier(sp_mode=mode, **MK), HiPSTopology(*shape),
                   sgd(0.1), sync=FSA(),
                   single_device_model=SeqClassifier(**MK), **kw)


def _batches(shape=SHAPE):
    P_, W_ = shape[:2]
    x, y = _data(BATCH * STEPS)
    b = BATCH // (P_ * W_)
    return [(torch.from_numpy(x[s * BATCH:(s + 1) * BATCH]
                              .reshape(P_, W_, b, L, 2)),
             torch.from_numpy(y[s * BATCH:(s + 1) * BATCH]
                              .reshape(P_, W_, b)).long())
            for s in range(STEPS)]


def _replicated_over_sp(mesh, state) -> None:
    """Every sp slot of a (p, w) holds the same state bits."""
    for p, w, s, _ in mesh.slot_coords():
        for k, v in state.slot(p, w, s).params.items():
            assert torch.equal(v, state.slot(p, w, 0).params[k]), (p, w, s, k)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_meshed_sp_steps_match_stacked(mode):
    """Three steps on [2, 2] x sp 2 (8 slots, a slot one 32-token chunk)
    against the stacked sp step from one seed and the same batches:
    losses within 2e-4, every slot's params within 2e-3, the params the
    same bits in the two sp slots of a replica, and the accuracy the
    stacked one's."""
    st, mt = _trainer(mode), _trainer(mode, sp_mesh())
    ss, ms = st.init_state(seed=0), mt.init_state(seed=0)
    assert isinstance(ms, PlacedTree) and len(ms.slots) == 8
    for xb, yb in _batches():
        ss, sm = st.train_step(ss, xb, yb)
        ms, mm = mt.train_step(ms, xb, yb)
        np.testing.assert_allclose(float(mm["loss"]), float(sm["loss"]),
                                   rtol=2e-4, atol=2e-4)
        assert float(mm["accuracy"]) == float(sm["accuracy"])
        _replicated_over_sp(mt.mesh, ms)
    for p, w, s, _ in mt.mesh.slot_coords():
        for k, v in ms.slot(p, w, s).params.items():
            np.testing.assert_allclose(v[0, 0].numpy(), ss.params[k][p, w]
                                       .numpy(), rtol=2e-3, atol=2e-3,
                                       err_msg=f"({p}, {w}, {s}) {k}")


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_meshed_sp_trainer_matches_jax(mode):
    """Three steps on [2, 2] x sp 2 from the JAX sp Trainer's weights on
    the conftest's 8 virtual devices: losses within 2e-4 and params within
    2e-3 (``test_torch_seq.py`` test_sp_trainer_steps_match_jax)."""
    p0, jlosses, jparams = _jax_train(mode, *SHAPE)
    mt = _trainer(mode, sp_mesh())
    ms = mt.init_state(params=from_flax(p0)[0])
    losses = []
    for xb, yb in _batches():
        ms, mm = mt.train_step(ms, xb, yb)
        losses.append(float(mm["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4, atol=2e-4)
    got = mt.mesh.gather(ms).params
    assert sorted(got) == sorted(jparams)
    for k in got:
        np.testing.assert_allclose(got[k][0, 0].numpy(), jparams[k],
                                   rtol=2e-3, atol=2e-3, err_msg=k)
    x, y = _data(16, seed=2)
    assert 0.0 <= mt.evaluate(ms, x, y, batch_size=8) <= 1.0


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_no_rendezvous_inside_a_backward(mode, monkeypatch):
    """The guard of the sp backward: every slot collective of a meshed sp
    step, the backward's cotangent exchanges included, runs outside any
    autograd graph task (on the card a backward node runs on the device's
    autograd thread, where a wait would stall every other slot)."""
    calls = []
    inner = pc.MeshSlot.collective

    def guarded(self, fn, x, *args, sp=False):
        calls.append((sp, torch._C._current_graph_task_id()))
        return inner(self, fn, x, *args, sp=sp)
    monkeypatch.setattr(pc.MeshSlot, "collective", guarded)
    mt = _trainer(mode, sp_mesh())
    ms = mt.init_state(seed=0)
    xb, yb = _batches()[0]
    mt.train_step(ms, xb, yb)
    assert sum(sp for sp, _ in calls) > 8 * 4  # the exchanges and their
    assert {task for _, task in calls} == {-1}  # transposes, every slot


def _attention_inputs(S, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (S, 2, 8, 4, 8)  # [S, B, L/S, H, D]
    return [torch.randn(shape, generator=g) for _ in range(4)]


@pytest.mark.parametrize("mode,causal", [("ring", False), ("ring", True),
                                         ("ulysses", False),
                                         ("ulysses", True)])
def test_slot_attention_and_its_gradient_match_stacked(mode, causal):
    """The attention on a [1, 1] x sp 4 mesh, a shard a slot (the ring
    picking the diagonal, full or skipped hop from the slot's sp index):
    the output and the gradients of q, k and v through the taped
    exchanges within 1e-5 of the stacked function's on the same
    shards."""
    attn = ring_attention if mode == "ring" else ulysses_attention
    S = 4
    q, k, v, w = _attention_inputs(S, 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn(*leaves, causal=causal)
    (out * w).sum().backward()
    mesh = sp_mesh((1, 1, S))

    def program(qs, ks, vs, ws):
        ins = [t.clone().requires_grad_() for t in (qs, ks, vs)]
        with pc.sp_tape() as tape:
            o = attn(*ins, causal=causal)
            grads = tape.grad((o * ws).sum(), ins)
        return o.detach(), grads
    args = [tuple(t[s:s + 1] for t in (q, k, v, w)) for s in range(S)]
    outs = pc.run_on_mesh(program, mesh, args)
    np.testing.assert_allclose(torch.cat([o for o, _ in outs]).numpy(),
                               out.detach().numpy(), atol=1e-5, rtol=1e-5)
    for i, leaf in enumerate(leaves):
        got = torch.cat([g[i] for _, g in outs])
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=str(i))


def test_a_slot_exchange_with_a_gradient_needs_the_tape():
    """An sp exchange that carries a gradient in a slot without a tape
    raises instead of dropping the gradient."""
    mesh = sp_mesh((1, 1, 2))
    x = torch.ones(2, 3)

    def program(xs):
        return pc.ppermute_sp(xs.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="sp tape"):
        pc.run_on_mesh(program, mesh, [(x[:1],), (x[1:],)])


def test_sp_mesh_places_chunks_and_reduces_within_planes():
    """On [2, 2] x sp 2: a token batch placed with its sequence dim gives
    slot (p, w, s) chunk s of replica (p, w) and gathers back; state
    replicates over sp and gathers from sp slot 0; a dc or worker
    collective reduces within each sp plane (the stacked function on that
    plane's stack) and an sp one within each (p, w); the device-cached
    loader places the same chunks."""
    mesh = sp_mesh()
    xb, yb = _batches()[0]
    placed = mesh.place(xb, seq_dim=3)
    for p, w, s, _ in mesh.slot_coords():
        assert torch.equal(placed.slot(p, w, s)[0, 0],
                           xb[p, w, :, s * 32:(s + 1) * 32])
    assert torch.equal(mesh.gather(placed), xb)
    ys = mesh.place(yb)
    assert all(torch.equal(ys.slot(p, w, 1), ys.slot(p, w, 0))
               for p, w, _, _ in mesh.slot_coords())
    assert torch.equal(mesh.gather(ys), yb)

    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randint(-9, 9, (2, 2, 2, 3)).astype(np.float32))

    def program(block):
        return (pc.psum(block, DC_AXIS), pc.pmax(block, WORKER_AXIS),
                pc.psum_sp(block[0]))
    # slot (p, w, s) holds a[p, w, s]
    args = [(a[p:p + 1, w:w + 1, s],) for p, w, s, _ in mesh.slot_coords()]
    outs = pc.run_on_mesh(program, mesh, args)
    for i, (p, w, s, _) in enumerate(mesh.slot_coords()):
        plane = a[:, :, s]
        assert torch.equal(outs[i][0][0, 0], pc.psum(plane, DC_AXIS)[p, w])
        assert torch.equal(outs[i][1][0, 0],
                           pc.pmax(plane, WORKER_AXIS)[p, w])
        assert torch.equal(outs[i][2][0], a[p, w].sum(0))

    t = _trainer("ring", mesh)
    x, y = _data(BATCH * STEPS)
    loader = t.make_loader(x, y, BATCH // 4, seed=0, device_cache=True)
    host = list(_trainer("ring").make_loader(x, y, BATCH // 4,
                                             seed=0).epoch(0))
    for (mx, my), (hx, hy) in zip(loader.epoch(0), host):
        assert isinstance(mx, PlacedTree) and mx.seq_dim == 3
        for i, (p, w, s, _) in enumerate(mesh.slot_coords()):
            assert torch.equal(mx.slots[i], mesh.place(hx, seq_dim=3)
                               .slots[i])
        assert torch.equal(mesh.gather(mx), hx)
        assert torch.equal(mesh.gather(my), hy)


def test_sp_mesh_fit_scans_a_device_cached_epoch():
    """fit(scan_epochs=True) on the sp mesh from the device-cached loader
    gives the per-step loop's losses and state bits on the same mesh."""
    x, y = _data(BATCH * STEPS)
    a, b = _trainer("ulysses", sp_mesh()), _trainer("ulysses", sp_mesh())
    sa, sb = a.init_state(seed=1), b.init_state(seed=1)
    sa, ra = a.fit(sa, a.make_loader(x, y, 2, seed=0, device_cache=True),
                   epochs=1, log_every=1, scan_epochs=True,
                   log_fn=lambda s: None)
    losses = []
    for xb, yb in b.make_loader(x, y, 2, seed=0).epoch(0):
        sb, m = b.train_step(sb, xb, yb)
        losses.append(float(m["loss"]))
    assert ra[0]["loss"] == pytest.approx(np.mean(losses), rel=1e-6)
    ga, gb = a.mesh.gather(sa), b.mesh.gather(sb)
    for k in ga.params:
        assert torch.equal(ga.params[k], gb.params[k]), k
    assert jax.device_count() == 8  # the conftest's mesh, for the JAX test
