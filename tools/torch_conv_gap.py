#!/usr/bin/env python3
"""Card against CPU: one replica's fp32 gradients of the zoo models at
their initial weights, with cuDNN's convolutions and with PyTorch's
direct ones (``torch.backends.cudnn.enabled = False``: im2col and one
GEMM, no transform of the input).

    python3 tools/torch_conv_gap.py [--out F]

For each zoo configuration of chip_smoke.py's reference phase
(``cnn_bsc``, ``alexnet_fused_adam``, ``cnn_mpq``, ``resnet20_s2d_nag``,
``mlp_lamb``), the
first batch of replica (0, 0) at chip_smoke.py's reference batch (8 a
replica), TF32 off, reports:

- the largest gradient difference over the leaf's largest magnitude,
  card against CPU, for the convolution kernels and the other leaves;
- the gradient coordinates that are exactly 0 on the CPU and not on
  the card;
- the pre-activations of every convolution (before its ReLU) where the
  card and the CPU disagree on the sign that the ReLU reads (> 0 or
  not).

Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CONFIGS = ("cnn_bsc", "alexnet_fused_adam", "cnn_mpq", "resnet20_s2d_nag",
           "mlp_lamb")


def replica_pass(torch, path: str, device: str):
    """Replica (0, 0)'s gradients (on the CPU) and its convolutions'
    outputs (on the CPU), at the initial weights on the first batch."""
    from chip_smoke import make_trainer, path_data
    from geomx_tpu_torch.models.layers import BiasConv
    from geomx_tpu_torch.tree import leaf_names

    x = path_data(path, 512)
    t = make_trainer(path, device=device, precision="fp32")
    st = t.init_state(seed=0, sample_input=x["train_x"][:2])
    xb, yb = next(iter(t.make_loader(x["train_x"], x["train_y"],
                                     8).epoch(0, prefetch=0)))
    names = leaf_names(st.params)
    leaves = {k: st.params[k][0, 0].detach().clone().requires_grad_()
              for k in names}
    ms = {k: v[0, 0] for k, v in st.model_state.items()}
    outs = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: outs.append(out.detach().cpu()))
        for m in t.model.modules() if isinstance(m, BiasConv)]
    try:
        loss, _ = t.loss_fn(leaves, ms, xb[0, 0], yb[0, 0])
        g = torch.autograd.grad(loss, [leaves[k] for k in names])
    finally:
        for h in hooks:
            h.remove()
    return {k: v.cpu() for k, v in zip(names, g)}, outs


def gaps(cpu, card) -> dict:
    """Largest difference over the largest magnitude, per kind of leaf."""
    rel = {k: ((card[k] - g).abs().max()
               / g.abs().max().clamp_min(1e-30)).item()
           for k, g in cpu.items()}
    conv = [v for k, v in rel.items() if "Conv" in k and k.endswith("kernel")]
    other = [v for k, v in rel.items()
             if not ("Conv" in k and k.endswith("kernel"))]
    return dict(conv_kernels=max(conv, default=None),
                other_leaves=max(other, default=None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the report to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_conv_gap: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"card": card, "configs": {}}
    for path in CONFIGS:
        cpu_g, cpu_o = replica_pass(torch, path, "cpu")
        row = {"cpu_zero_grads": sum(int((g == 0).sum())
                                     for g in cpu_g.values()),
               "preactivations": sum(o.numel() for o in cpu_o)}
        for label, cudnn_on in (("cudnn", True), ("direct", False)):
            torch.backends.cudnn.enabled = cudnn_on
            try:
                g, o = replica_pass(torch, path, "cuda")
            finally:
                torch.backends.cudnn.enabled = True
            row[label] = dict(
                gaps(cpu_g, g),
                relu_sign_flips=sum(int(((a > 0) != (b > 0)).sum())
                                    for a, b in zip(cpu_o, o)),
                grad_nonzero_where_cpu_zero=sum(
                    int(((cpu_g[k] == 0) & (g[k] != 0)).sum())
                    for k in cpu_g))
        report["configs"][path] = row
        print(f"{path}: {json.dumps(row)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
