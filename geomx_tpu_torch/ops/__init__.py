"""Kernels of the port's training paths (port of geomx_tpu/ops).

Each wrapper launches a hand-written CUDA kernel for Hopper
(``geomx_tpu_torch/csrc``) on CUDA tensors and runs its plain PyTorch
version on CPU tensors; none falls back from one to the other.  Each
wrapper counts its kernel launches in a ``launches`` attribute, so a
run can show that its main path went through the kernels; inside a mesh
slot the wrappers of the meshed paths (kernels 1-6) also count into the
slot's own tally (:func:`slot_launch_counts`).

``KERNELS`` maps each ported TPU kernel's name to its wrapper;
``VARIANTS`` maps a kernel variant to the counter of its launches, which
its kernel's count includes (the forward without the logsumexp).
"""

from geomx_tpu_torch.ops import (_launches, bsc, bucket, flash_attention,
                                 merge, optim, ring_hop, twobit)

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
    "flash_attention_fwd": flash_attention.flash_attention_with_lse,
    "flash_attention_dq": flash_attention.flash_dq,
    "flash_attention_dkv": flash_attention.flash_dkv,
    "fused_block": ring_hop.hop,
}

VARIANTS = {
    "flash_attention_fwd_nolse": flash_attention.flash_attention,
}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *VARIANTS.values()):
        fn.launches = 0
    _launches.reset_slots()


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def variant_launch_counts() -> dict:
    return {name: fn.launches for name, fn in VARIANTS.items()}


def slot_launch_counts() -> dict:
    """``{(p, w): {name: launches}}``: each mesh slot's launches since
    the last :func:`reset_launch_counts`, every kernel named."""
    names = {fn: name for name, fn in KERNELS.items()}
    return {slot: {name: tally.get(fn, 0) for fn, name in names.items()}
            for slot, tally in sorted(_launches.by_slot().items())}
