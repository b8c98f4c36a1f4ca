"""The CIFAR ResNets of He et al. 2016 (arXiv:1512.03385, section 4.2) in
plain PyTorch, float32.

Three stages of ``n`` basic blocks (two 3x3 convolutions, each followed by
batch normalization, the first by a ReLU; the sum with the shortcut and a
ReLU), 16, 32 and 64 filters, a stride of 2 at the first block of the
second and third stages, global average pooling and a dense head.  Where a
block changes the shape, its shortcut is a 1x1 convolution of the block's
stride and a batch normalization (the configuration lists this under
``assumed``: the paper's CIFAR nets use zero-padded identity shortcuts).

The leaf names and layouts are the ones the benchmark hands the program:
convolution kernels ``[kh, kw, in, out]``, dense kernels ``[in, out]``.
Convolutions pad as XLA's ``SAME`` does (at stride 2 on an even input:
none before, one after).  Batch normalization in training mode uses the
batch's mean and biased variance and the configuration's epsilon.  The
input is uint8 ``[B, H, W, C]`` scaled to ``[0, 1]``; the loss is the mean
softmax cross-entropy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gxbench.reference import precision



def _blocks(cfg):
    """(index, in filters, filters, stride, projected) for every block."""
    cin = cfg["stage_filters"][0]
    i = 0
    for stage, (n, f) in enumerate(zip(cfg["stage_sizes"],
                                       cfg["stage_filters"])):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            yield i, cin, f, stride, cin != f or stride != 1
            cin = f
            i += 1


def param_specs(cfg):
    """``(name, shape, init, fan_in)`` of every trainable leaf."""
    c = cfg["image_shape"][2]
    f0 = cfg["stage_filters"][0]
    specs = [("Conv_0.kernel", (3, 3, c, f0), "he", 9 * c)]
    specs += _bn("BatchNorm_0", f0)
    for i, cin, f, _, proj in _blocks(cfg):
        p = f"BasicBlock_{i}"
        specs.append((f"{p}.Conv_0.kernel", (3, 3, cin, f), "he", 9 * cin))
        specs += _bn(f"{p}.BatchNorm_0", f)
        specs.append((f"{p}.Conv_1.kernel", (3, 3, f, f), "he", 9 * f))
        specs += _bn(f"{p}.BatchNorm_1", f)
        if proj:
            specs.append((f"{p}.Conv_2.kernel", (1, 1, cin, f), "he", cin))
            specs += _bn(f"{p}.BatchNorm_2", f)
    fl = cfg["stage_filters"][-1]
    specs += [("Dense_0.kernel", (fl, cfg["num_classes"]), "lecun", fl),
              ("Dense_0.bias", (cfg["num_classes"],), "zeros", 0)]
    return specs


def _bn(prefix, f):
    return [(f"{prefix}.scale", (f,), "ones", 0),
            (f"{prefix}.bias", (f,), "zeros", 0)]


def state_specs(cfg):
    """The running statistics of every batch normalization (the model
    state the program carries; training-mode outputs never read them)."""
    out = []
    for name, shape, _, _ in param_specs(cfg):
        if "BatchNorm_" in name and name.endswith(".scale"):
            stem = name[:-len(".scale")]
            out += [(f"{stem}.mean", shape, "zeros", 0),
                    (f"{stem}.var", shape, "ones", 0)]
    return out


def _same_pad(x, k, stride):
    pads = []
    for size in (x.shape[3], x.shape[2]):          # W first, as F.pad wants
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv(p, name, x, stride, mode):
    w = p[name]
    k = w.shape[0]
    return precision.conv2d(_same_pad(x, k, stride), w.permute(3, 2, 0, 1),
                            mode, stride=stride)


def _bn_train(p, prefix, x, stats, eps):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    stats[f"{prefix}.mean"] = mean.detach().flatten()
    stats[f"{prefix}.var"] = var.detach().flatten()
    shape = (1, -1, 1, 1)
    return (x - mean) * torch.rsqrt(var + eps) * p[f"{prefix}.scale"] \
        .view(shape) + p[f"{prefix}.bias"].view(shape)


def logits(p, x, cfg, mode: str = "fp32", stats=None):
    """The logits; ``stats`` (a dict) receives each batch normalization's
    batch mean and biased variance by the running statistic's name."""
    stats = {} if stats is None else stats

    def bn(prefix, h):
        return _bn_train(p, prefix, h, stats, cfg["bn_epsilon"])

    h = (x.float() / 255.0).permute(0, 3, 1, 2)
    h = torch.relu(bn("BatchNorm_0", _conv(p, "Conv_0.kernel", h, 1, mode)))
    for i, _, _, stride, proj in _blocks(cfg):
        q = f"BasicBlock_{i}"
        y = torch.relu(bn(f"{q}.BatchNorm_0",
                          _conv(p, f"{q}.Conv_0.kernel", h, stride, mode)))
        y = bn(f"{q}.BatchNorm_1", _conv(p, f"{q}.Conv_1.kernel", y, 1, mode))
        if proj:
            h = bn(f"{q}.BatchNorm_2",
                   _conv(p, f"{q}.Conv_2.kernel", h, stride, mode))
        h = torch.relu(y + h)
    pooled = h.mean(dim=(2, 3))
    # the head is float32 in the configuration: no mode applies to it
    return pooled @ p["Dense_0.kernel"] + p["Dense_0.bias"]


def loss_and_grads(params, x, y, cfg, mode: str = "fp32"):
    """One replica's mean loss, its gradient by leaf and its batch
    statistics (``logits``)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    stats = {}
    with precision.arithmetic(mode):
        loss = F.cross_entropy(logits(leaves, x, cfg, mode, stats),
                               y.long())
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads)), stats
