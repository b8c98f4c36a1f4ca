"""Loss trajectories of the JAX package and the PyTorch port, side by side,
on the CPU (a script, not a pytest module: a full-width run takes minutes).

    python tests/torch_jax_trajectory.py [--batch 32] [--steps 32] [--bf16]

Both packages train the flagship configuration — ResNet-20 on HiPS
[2, 4], FSA with bucketed "bsc,0.01" (sampled selection), sgd(0.1,
momentum=0.9), the synthetic CIFAR-shaped set — from the same flax
initial weights and the same batches (the port starts from the converted
JAX weights; its loader yields the JAX loader's bytes).  Prints one line
a step: step, JAX loss, port loss, relative difference.
"""

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from geomx_tpu import HiPSTopology as JaxTopology  # noqa: E402
from geomx_tpu.config import GeoConfig as JaxConfig  # noqa: E402
from geomx_tpu.data import load_dataset  # noqa: E402
from geomx_tpu.models.resnet import ResNet as FlaxResNet  # noqa: E402
from geomx_tpu.train import Trainer as JaxTrainer  # noqa: E402
from geomx_tpu_torch import GeoConfig, HiPSTopology  # noqa: E402
from geomx_tpu_torch.models import ResNet  # noqa: E402
from geomx_tpu_torch.models.convert import from_flax  # noqa: E402
from geomx_tpu_torch.optim import sgd  # noqa: E402
from geomx_tpu_torch.train import Trainer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32,
                    help="images a replica a step")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (default fp32)")
    args = ap.parse_args(argv)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if args.bf16 \
        else (jnp.float32, torch.float32)
    data = load_dataset("synthetic",
                        synthetic_train_n=8 * args.batch * args.steps)
    cfg = dict(num_parties=2, workers_per_party=4,
               compression="bsc,0.01,select=sampled", precision="fp32")

    jt = JaxTrainer(FlaxResNet((3, 3, 3), (16, 32, 64), dtype=jdt),
                    JaxTopology(2, 4), optax.sgd(0.1, momentum=0.9),
                    config=JaxConfig(**cfg), donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), data["train_x"][:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    t0 = time.time()
    jlosses = []
    for xb, yb in jt.make_loader(data["train_x"], data["train_y"],
                                 args.batch, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))
    print(f"jax: {time.time() - t0:.1f} s", flush=True)

    pt = Trainer(ResNet((3, 3, 3), (16, 32, 64), dtype=tdt),
                 HiPSTopology(2, 4), sgd(0.1, momentum=0.9),
                 config=GeoConfig(**cfg), device="cpu")
    params, stats = from_flax(p0, s0)
    pst = pt.init_state(params=params, model_state=stats)
    t0 = time.time()
    plosses = []
    for xb, yb in pt.make_loader(data["train_x"], data["train_y"],
                                 args.batch, seed=0).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"port: {time.time() - t0:.1f} s", flush=True)
    print("step jax port rel_diff")
    for i, (a, b) in enumerate(zip(jlosses, plosses)):
        print(i, a, b, abs(a - b) / abs(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
