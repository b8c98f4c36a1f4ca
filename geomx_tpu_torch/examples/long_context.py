"""Long-context training demo: sequence-parallel attention through Trainer
(port of examples/long_context.py).

A tiny transformer classifier trains on a needle-in-a-haystack token task
with its attention sharded over the sp axis — ring attention (K/V blocks
rotating around the axis, one ``fused_block`` hop kernel a hop) or
Ulysses (all-to-all sequence<->head re-sharding around the flash
kernels) — composed under HiPS hierarchical data parallelism on a
``[dc, worker, sp]`` topology.  The same model widths, optimizer,
synchronization, data and defaults as the JAX example:

  python -m geomx_tpu_torch.examples.long_context [-c] [ring|ulysses]

Env: GEOMX_SP_MODE (ring|ulysses), GEOMX_SP_DEGREE, GEOMX_NUM_PARTIES,
GEOMX_WORKERS_PER_PARTY, GEOMX_SEQ_LEN, GEOMX_EPOCHS.

It runs on the card unless ``-c`` (or ``main(device="cpu")``) asks for
the CPU, as the port's ``examples/cnn.py`` does.  The JAX example's
``GEOMX_PLATFORM`` switch is not copied: it exists to keep JAX off the
TPU, and the port picks its device explicitly.  The weights come from
the port's initializers drawn with seed 0 (the JAX example's come from
``jax.random.PRNGKey(0)``; the draws differ).
"""

import os
import sys


def main(sp_mode=None, device=None, log_fn=None):
    """Train at the environment's settings; returns the last epoch's
    test accuracy.  ``log_fn`` receives each epoch's record (a JSON
    line); by default it is printed."""
    from geomx_tpu_torch.data import make_needle_data, with_positions
    from geomx_tpu_torch.models import SeqClassifier
    from geomx_tpu_torch.optim import adam
    from geomx_tpu_torch.sync import FSA
    from geomx_tpu_torch.topology import HiPSTopology
    from geomx_tpu_torch.train import Trainer

    sp_mode = sp_mode or os.environ.get("GEOMX_SP_MODE", "ring")
    parties = int(os.environ.get("GEOMX_NUM_PARTIES", "2"))
    workers = int(os.environ.get("GEOMX_WORKERS_PER_PARTY", "2"))
    sp = int(os.environ.get("GEOMX_SP_DEGREE", "2"))
    seq_len = int(os.environ.get("GEOMX_SEQ_LEN", "256"))
    epochs = int(os.environ.get("GEOMX_EPOCHS", "6"))
    batch = 16 * parties * workers  # local_b=16 per (party, worker)

    topo = HiPSTopology(num_parties=parties, workers_per_party=workers,
                        sp_degree=sp)
    mk = dict(vocab=256, max_len=seq_len, dim=64, num_heads=4,
              num_layers=2, num_classes=10)
    trainer = Trainer(
        SeqClassifier(sp_mode=sp_mode, **mk), topo, adam(1e-3),
        sync=FSA(), device=device,
        single_device_model=SeqClassifier(sp_mode=None, **mk))

    x, y = make_needle_data(4096, seq_len)
    xt, yt = make_needle_data(512, seq_len, seed=1)
    local_b = batch // (parties * workers)

    # the loader shards the sequence dim over the sp axis on an sp
    # topology; fit evaluates at each epoch end
    loader = trainer.make_loader(with_positions(x), y, local_b)
    state = trainer.init_state(seed=0)

    print(f"[long-context] {sp_mode} attention on "
          f"{parties}x{workers}x{sp} replicas on {trainer.device}, "
          f"L={seq_len} ({seq_len // sp}/shard), "
          f"{loader.steps_per_epoch} steps/epoch", flush=True)
    state, hist = trainer.fit(
        state, loader, epochs=epochs,
        eval_data=(with_positions(xt), yt),
        log_fn=log_fn or (lambda s: print(f"[long-context] {s}",
                                          flush=True)))
    return hist[-1]["test_acc"]


if __name__ == "__main__":
    args = sys.argv[1:]
    cpu = "-c" in args
    modes = [a for a in args if a != "-c"]
    final = main(modes[0] if modes else None,
                 device="cpu" if cpu else None)
    print(f"[long-context] final test_acc {final:.3f}", flush=True)
