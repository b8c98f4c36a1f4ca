"""Loss trajectories of the JAX package and the PyTorch port, side by side,
on the CPU (a script, not a pytest module: a full-width run takes minutes).

    python tests/torch_jax_trajectory.py [--path P] [--batch 32] [--steps 32] [--bf16]

Both packages train one path of chip_smoke.py — by default the flagship
configuration: ResNet-20 on HiPS [2, 4], FSA with bucketed "bsc,0.01"
(sampled selection), sgd(0.1, momentum=0.9); --path sparse_agg runs
[4, 2] with the owner-routed merge; mixed_dcasgd MixedSync with DCASGD
(pull every 2 steps) and the fused Adam(0.01); hfa_dgt HFA (K1 4, K2
2) over DGT (k 0.8, 3 channels) with Adam(0.01); pipelined_fsa the
flagship with GEOMX_PIPELINE_DEPTH=1; zero_sgd the flagship with
GEOMX_ZERO=1; zero_pipelined_adam ZeRO with the fused Adam(0.01) and
the pipeline; multigps_bsc the flagship with GEOMX_MULTI_GPS=1 at
bigarray_bound 1000 — on the synthetic CIFAR-shaped set, from the same flax
initial weights and the same batches (the port starts from the converted
JAX weights; its loader yields the JAX loader's bytes).  --path seq_ring
runs examples/long_context.py's defaults instead: SeqClassifier with
ring attention on HiPS [2, 2] x sp 2, L = 256, adam(1e-3), FSA, the
needle task, --batch sequences a replica (16 there).  --path cnn_bsc
runs examples/cnn_bsc.py's configuration: GeoCNN on the MNIST-shaped
synthetic set (28x28x1), adam(0.01), "bsc,0.01" (sampled selection) on
[2, 4]; --path alexnet_fused_adam get_model("alexnet") on the
CIFAR-shaped set with the fused Adam(0.01) and "bsc,0.01" on [2, 4]
(the port's device-cached batches without augmentation are the host
loader's bytes, so both packages read the host loader here).  Prints one
line a step: step, JAX loss, port loss, relative difference.
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
from geomx_tpu.models import get_model as jax_get_model  # noqa: E402
from geomx_tpu.models.resnet import ResNet as FlaxResNet  # noqa: E402
from geomx_tpu.ops import optim_pallas  # noqa: E402
from geomx_tpu.models.seq_classifier import \
    SeqClassifier as FlaxSeq  # noqa: E402
from geomx_tpu.sync import FSA as JaxFSA  # noqa: E402
from geomx_tpu.train import Trainer as JaxTrainer  # noqa: E402
from geomx_tpu_torch import GeoConfig, HiPSTopology  # noqa: E402
from geomx_tpu_torch.data import (make_needle_data,  # noqa: E402
                                   with_positions)
from geomx_tpu_torch.models import ResNet, SeqClassifier  # noqa: E402
from geomx_tpu_torch.models import get_model  # noqa: E402
from geomx_tpu_torch.models.convert import from_flax  # noqa: E402
from geomx_tpu_torch.ops import optim  # noqa: E402
from geomx_tpu_torch.optim import adam, sgd  # noqa: E402
from geomx_tpu_torch.sync import FSA  # noqa: E402
from geomx_tpu_torch.train import Trainer  # noqa: E402

# path -> (compression, fused, JAX optimizer, port optimizer, [P, W],
# the GeoConfig overrides of chip_smoke.py's PATHS)
PATHS = {
    "flagship": ("bsc,0.01,select=sampled", False,
                 lambda: optax.sgd(0.1, momentum=0.9),
                 lambda: sgd(0.1, momentum=0.9), (2, 4), {}),
    "fused_sgd": ("bsc,0.01,select=sampled", True,
                  lambda: optim_pallas.fused_optimizer(
                      "sgd", learning_rate=0.1, momentum=0.9),
                  lambda: optim.fused_optimizer(
                      "sgd", learning_rate=0.1, momentum=0.9), (2, 4), {}),
    "twobit_adam": ("2bit,0.5", True,
                    lambda: optim_pallas.fused_optimizer(
                        "adam", learning_rate=0.01),
                    lambda: optim.fused_optimizer(
                        "adam", learning_rate=0.01), (2, 4), {}),
    "sparse_agg": ("bsc,0.01,select=sampled,sparse_agg=1", True,
                   lambda: optim_pallas.fused_optimizer(
                       "sgd", learning_rate=0.1, momentum=0.9),
                   lambda: optim.fused_optimizer(
                       "sgd", learning_rate=0.1, momentum=0.9), (4, 2), {}),
    "mixed_dcasgd": ("bsc,0.01,select=sampled", True,
                     lambda: optim_pallas.fused_optimizer(
                         "adam", learning_rate=0.01),
                     lambda: optim.fused_optimizer(
                         "adam", learning_rate=0.01), (2, 4),
                     dict(sync_mode="mixed", dcasgd=True,
                          dcasgd_lambda=0.04, mixed_pull_interval=2)),
    "hfa_dgt": ("bsc,0.01,select=sampled", False,
                lambda: optax.adam(0.01), lambda: adam(0.01), (2, 4),
                dict(sync_mode="hfa", hfa_k1=4, hfa_k2=2, enable_dgt=2,
                     dgt_k=0.8, udp_channel_num=3, dgt_block_size=4096,
                     dgt_contri_alpha=0.3)),
    "pipelined_fsa": ("bsc,0.01,select=sampled", False,
                      lambda: optax.sgd(0.1, momentum=0.9),
                      lambda: sgd(0.1, momentum=0.9), (2, 4),
                      dict(pipeline_depth=1)),
    "zero_sgd": ("bsc,0.01,select=sampled", False,
                 lambda: optax.sgd(0.1, momentum=0.9),
                 lambda: sgd(0.1, momentum=0.9), (2, 4), dict(zero=True)),
    "zero_pipelined_adam": ("bsc,0.01,select=sampled", True,
                            lambda: optim_pallas.fused_optimizer(
                                "adam", learning_rate=0.01),
                            lambda: optim.fused_optimizer(
                                "adam", learning_rate=0.01), (2, 4),
                            dict(zero=True, pipeline_depth=1)),
    "multigps_bsc": ("bsc,0.01,select=sampled", False,
                     lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: sgd(0.1, momentum=0.9), (2, 4),
                     dict(multi_gps=True, bigarray_bound=1000)),
}


# the zoo paths of chip_smoke.py: path -> (model, dataset, compression,
# fused, JAX optimizer, port optimizer, [P, W])
ZOO_PATHS = {
    "cnn_bsc": ("cnn", "mnist", "bsc,0.01,select=sampled", False,
                lambda: optax.adam(0.01), lambda: adam(0.01), (2, 4)),
    "alexnet_fused_adam": ("alexnet", "synthetic", "bsc,0.01,select=sampled",
                           True, lambda: optim_pallas.fused_optimizer(
                               "adam", learning_rate=0.01),
                           lambda: optim.fused_optimizer(
                               "adam", learning_rate=0.01), (2, 4)),
}


def zoo_losses(path: str, batch: int, steps: int, bf16: bool):
    """(JAX losses, port losses) of a zoo path, from the same initial
    weights and batches."""
    name, dataset, spec, fused, jax_tx, port_tx, (P, W) = ZOO_PATHS[path]
    precision = "bf16" if bf16 else "fp32"
    data = load_dataset(dataset, synthetic_train_n=P * W * batch * steps)
    cfg = dict(num_parties=P, workers_per_party=W, compression=spec,
               precision=precision, fused_optim=fused)
    jt = JaxTrainer(jax_get_model(name, precision=precision),
                    JaxTopology(P, W), jax_tx(), config=JaxConfig(**cfg),
                    donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), data["train_x"][:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    t0 = time.time()
    jlosses = []
    for xb, yb in jt.make_loader(data["train_x"], data["train_y"],
                                 batch).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))
    print(f"jax: {time.time() - t0:.1f} s", flush=True)
    pt = Trainer(get_model(name, precision=precision), HiPSTopology(P, W),
                 port_tx(), config=GeoConfig(**cfg), device="cpu")
    pst = pt.init_state(params=from_flax(p0)[0],
                        sample_input=data["train_x"][:2])
    t0 = time.time()
    plosses = []
    for xb, yb in pt.make_loader(data["train_x"], data["train_y"],
                                 batch).epoch(0, prefetch=0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"port: {time.time() - t0:.1f} s", flush=True)
    return jlosses, plosses


# examples/long_context.py's model at its default sequence length
SEQ_MK = dict(vocab=256, max_len=256, dim=64, num_heads=4, num_layers=2,
              num_classes=10)


def seq_ring_losses(batch: int, steps: int):
    """(JAX losses, port losses) of the seq_ring path, from the same
    initial weights and batches."""
    P, W, S, L = 2, 2, 2, 256
    x, y = make_needle_data(P * W * batch * steps, L)
    x3 = with_positions(x)
    jt = JaxTrainer(FlaxSeq(sp_mode="ring", **SEQ_MK),
                    JaxTopology(P, W, sp_degree=S), optax.adam(1e-3),
                    sync=JaxFSA(), donate=False,
                    single_device_model=FlaxSeq(**SEQ_MK))
    jst = jt.init_state(jax.random.PRNGKey(0), x3[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    t0 = time.time()
    jlosses = []
    for xb, yb in jt.make_loader(x3, y, batch).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))
    print(f"jax: {time.time() - t0:.1f} s", flush=True)
    pt = Trainer(SeqClassifier(sp_mode="ring", **SEQ_MK),
                 HiPSTopology(P, W, sp_degree=S), adam(1e-3), sync=FSA(),
                 device="cpu", single_device_model=SeqClassifier(**SEQ_MK))
    pst = pt.init_state(params=from_flax(p0)[0])
    t0 = time.time()
    plosses = []
    for xb, yb in pt.make_loader(x3, y, batch).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"port: {time.time() - t0:.1f} s", flush=True)
    return jlosses, plosses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(PATHS) + ["seq_ring"]
                    + sorted(ZOO_PATHS),
                    default="flagship")
    ap.add_argument("--batch", type=int, default=32,
                    help="images a replica a step")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (default fp32)")
    args = ap.parse_args(argv)
    if args.path == "seq_ring":
        report(*seq_ring_losses(args.batch, args.steps))
        return 0
    if args.path in ZOO_PATHS:
        report(*zoo_losses(args.path, args.batch, args.steps, args.bf16))
        return 0
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if args.bf16 \
        else (jnp.float32, torch.float32)
    data = load_dataset("synthetic",
                        synthetic_train_n=8 * args.batch * args.steps)
    spec, fused, jax_tx, port_tx, (P, W), extra = PATHS[args.path]
    cfg = dict(num_parties=P, workers_per_party=W, compression=spec,
               precision="fp32", fused_optim=fused, **extra)

    jt = JaxTrainer(FlaxResNet((3, 3, 3), (16, 32, 64), dtype=jdt),
                    JaxTopology(P, W), jax_tx(),
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
                 HiPSTopology(P, W), port_tx(),
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
    report(jlosses, plosses)
    return 0


def report(jlosses, plosses) -> None:
    print("step jax port rel_diff")
    for i, (a, b) in enumerate(zip(jlosses, plosses)):
        print(i, a, b, abs(a - b) / abs(a))
    for name, ls in (("jax", jlosses), ("port", plosses)):
        if len(ls) >= 16:
            print(f"{name}: mean loss steps 1-8 {np.mean(ls[:8]):.4f}, "
                  f"steps 9-16 {np.mean(ls[8:16]):.4f}")


if __name__ == "__main__":
    sys.exit(main())
