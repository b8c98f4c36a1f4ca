"""Port parity of the user-facing layer: ``metric.py`` against the JAX
package's on the same arrays, the ``Module`` API (fit, predict, score,
save and load), three GeoCNN ``Trainer`` steps under ``bsc,0.01`` with
the examples' Adam(0.01) against the JAX ``Trainer``, and the ``examples.cnn_bsc`` entry point
on the CPU.

Tolerances: the metrics to 1e-12 (the same float64 sums); the GeoCNN
losses to rtol 1e-4, as the other Trainer parity tests; a reloaded
``Module`` predicts the same bits.  Inputs are seeded numpy arrays.
"""

import re

import jax
import numpy as np
import optax
import pytest
import torch

from geomx_tpu import metric as jax_metric
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models import get_model as jax_get_model
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology, metric
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.module import Module
from geomx_tpu_torch.optim import adam
from geomx_tpu_torch.train import Trainer

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["acc", "top_k_accuracy", "f1", "mae",
                                  "mse", "rmse", "ce",
                                  ("acc", "ce", "f1")])
def test_metrics_match_jax(name):
    rng = np.random.RandomState(0)
    kw = {"top_k": 3} if name == "top_k_accuracy" else {}
    port, ref = metric.create(name, **kw), jax_metric.create(name, **kw)
    for _ in range(3):
        if name in ("mae", "mse", "rmse"):
            labels = rng.normal(size=(8, 3)).astype(np.float32)
            preds = rng.normal(size=(8, 3)).astype(np.float32)
        else:
            k = 2 if name == "f1" or isinstance(name, tuple) else 10
            labels = rng.randint(0, k, 8)
            preds = rng.dirichlet(np.ones(k), 8).astype(np.float32)
        # the port takes tensors as well as arrays
        port.update(torch.from_numpy(np.asarray(labels)),
                    torch.from_numpy(preds))
        ref.update(labels, preds)
    got, want = port.get(), ref.get()
    assert np.allclose(np.asarray(got[1], np.float64),
                       np.asarray(want[1], np.float64), rtol=0, atol=1e-12)
    assert got[0] == want[0]
    port.reset()
    assert port.get_name_value()[0][0] in (want[0], want[0][0])


_PROTOS = np.random.RandomState(42).uniform(
    0, 255, size=(10, 16, 16, 3)).astype(np.float32)


def _data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n).astype(np.int32)
    x = np.clip(_PROTOS[y] + rng.normal(0, 32, (n, 16, 16, 3)),
                0, 255).astype(np.uint8)
    return x, y


def test_module_fit_score_predict_checkpoint(tmp_path):
    topo = HiPSTopology(2, 2)
    cfg = GeoConfig(num_parties=2, workers_per_party=2)
    mod = Module("mlp", topology=topo, config=cfg, optimizer="adam",
                 optimizer_params={"learning_rate": 3e-3}, device="cpu")
    x, y = _data()
    xt, yt = _data(64, seed=1)
    with pytest.raises(RuntimeError, match="bind"):
        mod.get_params()
    mod.fit((x, y), eval_data=(xt, yt), num_epoch=2, batch_size=16,
            verbose=False)
    pairs = dict(mod.score((xt, yt), ["acc", "ce"]))
    assert pairs["accuracy"] > 0.5
    assert np.isfinite(pairs["cross-entropy"])
    logits = mod.predict(xt[:8])
    assert logits.shape == (8, 10) and logits.dtype == np.float32
    assert mod.get_params()["Dense_0.kernel"].shape == (768, 256)

    prefix = str(tmp_path / "model")
    path = mod.save_checkpoint(prefix, epoch=2)
    assert path.endswith("model-0002.ckpt")
    mod2 = Module("mlp", topology=topo, config=cfg, device="cpu")
    mod2.load_checkpoint(prefix, epoch=2, sample_input=x[:2])
    np.testing.assert_array_equal(mod2.predict(xt[:8]), logits)

    seen = []
    mod.fit((x, y), num_epoch=1, batch_size=16, verbose=False,
            epoch_end_callback=lambda e, m: seen.append(e))
    assert seen == [0]


def test_three_geocnn_bsc_steps_track_jax_trainer(topo2x4, mesh2x4):
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (96, 28, 28, 1)).astype(np.uint8)
    y = rng.randint(0, 10, 96).astype(np.int32)
    # the sampled selection in both packages (the JAX package's default
    # off the TPU is the exact top-k; the port's is the sampled scan)
    cfg = dict(num_parties=2, workers_per_party=4,
               compression="bsc,0.01,select=sampled")
    jt = JaxTrainer(jax_get_model("cnn"), topo2x4, optax.adam(0.01),
                    config=JaxConfig(**cfg), mesh=mesh2x4, donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 4).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    pt = Trainer(get_model("cnn"), HiPSTopology(2, 4), adam(0.01),
                 config=GeoConfig(**cfg), device="cpu")
    pst = pt.init_state(params=from_flax(p0)[0], sample_input=x[:2])
    assert sum(v[0, 0].numel() for v in pst.params.values()) == 449_098
    plosses = []
    for xb, yb in pt.make_loader(x, y, 4).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    assert len(plosses) == len(jlosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    for k, v in pst.params.items():
        assert torch.equal(v, v[:1, :1].expand_as(v)), k


def test_cnn_bsc_entry_point_runs_on_the_cpu(monkeypatch, capsys):
    from geomx_tpu_torch.examples import cnn_bsc
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    monkeypatch.setenv("GEOMX_WORKERS_PER_PARTY", "2")
    state, trainer = cnn_bsc.main(["-c", "-d", "synthetic", "-ep", "1",
                                   "-bs", "256"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("Start training on 4 workers (2 parties x 2), "
                      "sync=fsa, compression=bsc,0.01, dgt=0.")
    pat = re.compile(r"^\[Time \d+\.\d{3}\]\[Epoch 0\]\[Iteration (\d+)\] "
                     r"Test Acc (\d\.\d{4})$")
    its = [int(pat.match(line).group(1)) for line in out[1:]]
    assert its == [1, 2, 3, 4]
    assert trainer.device.type == "cpu" and state.step == 4
    with pytest.raises(SystemExit):
        cnn_bsc.main(["-d", "nope"])
