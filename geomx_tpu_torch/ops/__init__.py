"""Kernels of the port's main path (port of geomx_tpu/ops).

Each wrapper launches a hand-written CUDA kernel for Hopper
(``geomx_tpu_torch/csrc``) on CUDA tensors and runs its plain PyTorch
version on CPU tensors; none falls back from one to the other.  Each
wrapper counts its kernel launches in a ``launches`` attribute, so a
run can show that its main path went through the kernels.

``KERNELS`` maps each ported TPU kernel's name to its wrapper.
"""

from geomx_tpu_torch.ops import bsc, bucket

KERNELS = {
    "fused_flatten": bucket.flatten,
    "fused_unflatten": bucket.unflatten,
    "bsc_select_pack": bsc.select_pack,
    "bsc_scatter_add": bsc.scatter_add,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
