"""A pre-LayerNorm Transformer encoder classifier in plain PyTorch, float32:
the Long Range Arena text model's shape (Tay et al. 2021,
arXiv:2011.04006) as GeoMX's sequence classifier builds it.

Token and learned position embeddings summed; ``num_layers`` blocks of
``h + attn(ln(h))`` and ``h + mlp(ln(h))`` (full softmax attention over
``num_heads`` heads of ``dim / num_heads``, scaled by the head size's
inverse square root; an MLP of ``mlp_dim`` with the tanh GELU); a final
LayerNorm, the mean over positions (the configuration lists this under
``assumed``: LRA pools a CLS token), a dense head and the mean softmax
cross-entropy.  LayerNorm's epsilon is 1e-6.  Leaf layouts are the ones
the benchmark hands the program: ``qkv`` ``[dim, 3, heads, head_dim]``
(q, k, v along its second dim), ``proj`` ``[heads * head_dim, dim]``,
dense kernels ``[in, out]``.

Attention is computed whole, ``softmax(QK^T)V``, a few sequences at a
time so that the score matrices fit beside each other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gxbench.reference import precision

EPS = 1e-6


def param_specs(cfg):
    """``(name, shape, init, fan_in)`` of every trainable leaf."""
    d, h = cfg["dim"], cfg["num_heads"]
    hd, m = d // h, cfg["mlp_dim"]
    specs = [("tok_embed.embedding", (cfg["vocab"], d), "embed", 0),
             ("pos_embed.embedding", (cfg["max_len"], d), "embed", 0)]
    for i in range(cfg["num_layers"]):
        specs += _ln(f"ln_a{i}", d) + _ln(f"ln_m{i}", d)
        specs += [(f"attn{i}.qkv.kernel", (d, 3, h, hd), "lecun", d),
                  (f"attn{i}.proj.kernel", (h * hd, d), "lecun", h * hd),
                  (f"mlp_in{i}.kernel", (d, m), "lecun", d),
                  (f"mlp_in{i}.bias", (m,), "zeros", 0),
                  (f"mlp_out{i}.kernel", (m, d), "lecun", m),
                  (f"mlp_out{i}.bias", (d,), "zeros", 0)]
    specs += _ln("ln_f", d)
    specs += [("head.kernel", (d, cfg["num_classes"]), "lecun", d),
              ("head.bias", (cfg["num_classes"],), "zeros", 0)]
    return specs


def _ln(prefix, d):
    return [(f"{prefix}.scale", (d,), "ones", 0),
            (f"{prefix}.bias", (d,), "zeros", 0)]


def state_specs(cfg):
    return []


def _layer_norm(p, prefix, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.scale"],
                        p[f"{prefix}.bias"], EPS)


def _dense(p, prefix, x, mode):
    w = p[f"{prefix}.kernel"]
    y = precision.matmul(x, w.reshape(w.shape[0], -1), mode)
    if f"{prefix}.bias" in p:
        y = y + p[f"{prefix}.bias"]
    return y


def logits(p, tokens, cfg, mode: str = "fp32"):
    B, L = tokens.shape
    H = cfg["num_heads"]
    hd = cfg["dim"] // H
    pos = torch.arange(L, device=tokens.device)
    h = F.embedding(tokens.long(), p["tok_embed.embedding"]) \
        + F.embedding(pos, p["pos_embed.embedding"])[None]
    for i in range(cfg["num_layers"]):
        a = _layer_norm(p, f"ln_a{i}", h)
        qkv = _dense(p, f"attn{i}.qkv", a, mode).view(B, L, 3, H, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        s = precision.matmul(q, k.transpose(-1, -2), mode) * hd ** -0.5
        o = precision.matmul(torch.softmax(s, dim=-1), v, mode)
        h = h + _dense(p, f"attn{i}.proj",
                       o.transpose(1, 2).reshape(B, L, H * hd), mode)
        m = _dense(p, f"mlp_in{i}", _layer_norm(p, f"ln_m{i}", h), mode)
        h = h + _dense(p, f"mlp_out{i}", F.gelu(m, approximate="tanh"),
                       mode)
    pooled = _layer_norm(p, "ln_f", h).mean(dim=1)
    # the head is float32 in the configuration: no mode applies to it
    return pooled @ p["head.kernel"] + p["head.bias"]


def loss_and_grads(params, x, y, cfg, mode: str = "fp32", chunk: int = 2):
    """One replica's mean loss over its ``B`` sequences, its gradient by
    leaf (``chunk`` sequences at a time) and its batch statistics (none:
    the encoder keeps no running state)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    names = list(leaves)
    B = x.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    grads = [torch.zeros_like(leaves[k]) for k in names]
    with precision.arithmetic(mode):
        for s in range(0, B, chunk):
            loss = F.cross_entropy(logits(leaves, x[s:s + chunk], cfg, mode),
                                   y[s:s + chunk].long(),
                                   reduction="sum") / B
            for acc, g in zip(grads, torch.autograd.grad(
                    loss, [leaves[k] for k in names])):
                acc += g
            total += loss.detach()
    return total, dict(zip(names, grads)), {}
