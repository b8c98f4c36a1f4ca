"""Kernels of the port's training paths (port of geomx_tpu/ops).

Each wrapper launches a hand-written CUDA kernel for Hopper
(``geomx_tpu_torch/csrc``) on CUDA tensors and runs its plain PyTorch
version on CPU tensors; none falls back from one to the other.  Each
wrapper counts its kernel launches in a ``launches`` attribute, so a
run can show that its main path went through the kernels.

``KERNELS`` maps each ported TPU kernel's name to its wrapper.
"""

from geomx_tpu_torch.ops import bsc, bucket, merge, optim, twobit

KERNELS = {
    "fused_flatten": bucket.flatten,
    "fused_unflatten": bucket.unflatten,
    "bsc_select_pack": bsc.select_pack,
    "bsc_scatter_add": bsc.scatter_add,
    "fused_sgd_momentum": optim.fused_sgd_momentum,
    "fused_adam": optim.fused_adam,
    "quantize_2bit": twobit.quantize_2bit,
    "dequantize_2bit": twobit.dequantize_2bit,
    "merge_sorted_pairs": merge.merge_sorted_pairs,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
