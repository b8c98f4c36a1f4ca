"""The LRA text encoder's forward operations a sequence of ``max_len``
tokens: per layer the q/k/v projection 2 L D 3D, attention 4 L^2 D
(Q K^T and P V over all heads), the output projection 2 L D^2 and the
MLP 2 (2 L D M); the head 2 D C (94,489,281,536 at L 4,096, D 256,
M 1,024, 4 layers, 2 classes)."""


def forward_flops_per_sample(cfg):
    L, D, M = cfg["max_len"], cfg["dim"], cfg["mlp_dim"]
    layer = 2 * L * D * 3 * D + 4 * L * L * D + 2 * L * D * D \
        + 2 * 2 * L * D * M
    return cfg["num_layers"] * layer + 2 * D * cfg["num_classes"]
