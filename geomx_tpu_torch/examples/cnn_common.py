"""Shared driver of the demo CNN variants (port of examples/cnn_common.py,
the shared structure of the reference's cnn_*.py family).

``run(argv=...)`` parses ``argv`` (default: the command line), so a
caller can drive an entry point in-process; ``on_step(iteration,
metrics)``, when given, sees every step's metrics.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence


def run(extra_args=(), config_fn=lambda a: {}, sync_default: str = "fsa",
        argv: Optional[Sequence[str]] = None,
        on_step: Optional[Callable] = None):
    """Train ``--model`` with Adam under the ``GEOMX_*`` configuration
    and print the test accuracy every ``--eval-every`` iterations (1 by
    default).  Returns ``(state, trainer)``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-lr", "--learning-rate", type=float, default=0.01)
    parser.add_argument("-bs", "--batch-size", type=int, default=32)
    parser.add_argument("-ep", "--epoch", type=int, default=5)
    parser.add_argument("-sc", "--split-by-class", action="store_true")
    parser.add_argument("-c", "--cpu", action="store_true",
                        help="run on the CPU (default: the GPU)")
    parser.add_argument("-d", "--dataset", default="mnist",
                        choices=["mnist", "fashion-mnist", "cifar10",
                                 "synthetic"])
    parser.add_argument("--model", default="cnn")
    parser.add_argument("--augment", action="store_true",
                        help="random-crop + flip augmentation "
                             "(the CIFAR training recipe)")
    for flags_short, flags_long, typ, default in extra_args:
        parser.add_argument(flags_short, flags_long, type=typ,
                            default=default)
    args = parser.parse_args(argv)

    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.optim import get_optimizer
    from geomx_tpu_torch.sync import get_sync_algorithm
    from geomx_tpu_torch.train import Trainer

    overrides = dict(config_fn(args))
    overrides.setdefault("sync_mode", sync_default)
    cfg = GeoConfig.from_env(**overrides)
    topo = HiPSTopology(cfg.num_parties, cfg.workers_per_party)
    data = load_dataset(args.dataset, root=cfg.data_dir)

    trainer = Trainer(get_model(args.model), topo,
                      get_optimizer("adam", learning_rate=args.learning_rate),
                      sync=get_sync_algorithm(cfg), config=cfg,
                      device="cpu" if args.cpu else None)
    state = trainer.init_state(seed=0, sample_input=data["train_x"][:2])
    loader = trainer.make_loader(data["train_x"], data["train_y"],
                                 args.batch_size,
                                 split_by_class=args.split_by_class,
                                 augment=args.augment)

    print(f"Start training on {topo.total_workers} workers "
          f"({topo.num_parties} parties x {topo.workers_per_party}), "
          f"sync={cfg.sync_mode}, compression={cfg.compression}, "
          f"dgt={cfg.enable_dgt}.", flush=True)
    begin, it = time.time(), 0
    eval_every = getattr(args, "eval_every", 1)
    for epoch in range(args.epoch):
        for xb, yb in loader.epoch(epoch, prefetch=cfg.prefetch):
            state, metrics = trainer.train_step(state, xb, yb)
            float(metrics["loss"])  # one host wait a step, as the JAX demo
            it += 1
            if on_step is not None:
                on_step(it, metrics)
            if it % eval_every == 0:
                acc = trainer.evaluate(state, data["test_x"], data["test_y"])
                print("[Time %.3f][Epoch %d][Iteration %d] Test Acc %.4f"
                      % (time.time() - begin, epoch, it, acc), flush=True)
    return state, trainer
