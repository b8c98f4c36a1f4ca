"""The port's process-per-role launcher and ``examples/dist_ps.py``
against the JAX package's: the same job on the CPU gives the same model
within 5e-5, the other sync modes run, and an unported knob is refused
with its ROADMAP item."""

import os
import subprocess
import sys

import numpy as np
import pytest

from geomx_tpu_torch.utils.net import free_port_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 240  # seconds a launch may take here (a run takes ~10)


def _launch(cmd_prefix, example, tmp, parties, workers, **env_extra):
    gport, lport, sport = free_port_blocks(2, parties, 1)
    env = dict(os.environ)
    env.update({"GEOMX_EPOCHS": "1", "GEOMX_BATCH": "64",
                "GEOMX_SYNC_MODE": "fsa", "GEOMX_PS_GLOBAL_PORT": str(gport),
                "GEOMX_PS_PORT": str(lport),
                "GEOMX_SCHEDULER_PORT": str(sport),
                "GEOMX_SAVE_PARAMS": str(tmp), "JAX_PLATFORMS": "cpu"})
    env.update(env_extra)
    proc = subprocess.run(
        cmd_prefix + ["--num-parties", str(parties), "--workers-per-party",
                      str(workers), "--server-start-delay", "0.5", "--"]
        + example, cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=LIMIT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return proc


def _models(tmp, parties, workers):
    out = {}
    for p in range(parties):
        for w in range(workers):
            with np.load(os.path.join(tmp, f"worker_p{p}w{w}.npz")) as z:
                out[(p, w)] = {k: z[k] for k in z.files}
    return out


PORT_LAUNCH = [sys.executable, "-m", "geomx_tpu_torch.launch"]
PORT_EXAMPLE = [sys.executable, "-m", "geomx_tpu_torch.examples.dist_ps",
                "-c"]


def test_port_job_matches_jax_job(tmp_path):
    tp, tj = tmp_path / "port", tmp_path / "jax"
    tp.mkdir()
    tj.mkdir()
    proc = _launch(PORT_LAUNCH, PORT_EXAMPLE, tp, 2, 1)
    assert "[launch] exit codes" in proc.stderr
    assert proc.stdout.count("device cpu") == 2
    _launch([sys.executable, os.path.join(ROOT, "scripts", "launch.py")],
            [sys.executable, os.path.join(ROOT, "examples", "dist_ps.py")],
            tj, 2, 1)
    port, ref = _models(tp, 2, 1), _models(tj, 2, 1)
    for k in ("w", "b"):
        # sync mode: every worker pulled one model
        np.testing.assert_array_equal(port[(0, 0)][k], port[(1, 0)][k])
        np.testing.assert_allclose(port[(0, 0)][k], ref[(0, 0)][k],
                                   rtol=0, atol=5e-5)


@pytest.mark.parametrize("mode,extra", [
    ("mixed", {"GEOMX_USE_SCHEDULER": "1"}),
    ("hfa", {"GEOMX_HFA_K1": "4", "GEOMX_HFA_K2": "2"}),
])
def test_port_job_other_sync_modes(tmp_path, mode, extra):
    proc = _launch(PORT_LAUNCH, PORT_EXAMPLE, tmp_path, 2, 1,
                   GEOMX_SYNC_MODE=mode, **extra)
    assert proc.stdout.count("epoch 0 train_acc") == 2
    models = _models(tmp_path, 2, 1)
    for m in models.values():
        assert all(np.isfinite(v).all() for v in m.values())


def test_unported_knob_is_refused_with_its_item(tmp_path):
    """A scheduler role under GEOMX_FLEETSCOPE refuses it naming its item
    ("Telemetry"); the metrics endpoints and durability are ported, so
    GEOMX_METRICS_PORT and GEOMX_DURABLE_DIR are no longer refused."""
    env = dict(os.environ, GEOMX_ROLE="scheduler", GEOMX_FLEETSCOPE="1",
               GEOMX_METRICS_PORT="0", GEOMX_DURABLE_DIR=str(tmp_path))
    proc = subprocess.run(PORT_EXAMPLE, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr
    assert "Telemetry" in proc.stderr
