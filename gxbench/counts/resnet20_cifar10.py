"""ResNet-20 (CIFAR, n = 3) forward operations an image, from the
configuration's stages, widths and image shape: the 3x3 convolutions,
the 1x1 projection shortcuts and the dense head (81,626,368 at 32x32x3
with 16, 32, 64 filters)."""


def forward_flops_per_sample(cfg):
    h, w, c = cfg["image_shape"]
    filters = cfg["stage_filters"]
    flops = 2 * 9 * c * filters[0] * h * w            # the stem
    cin = filters[0]
    for stage, (n, f) in enumerate(zip(cfg["stage_sizes"], filters)):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            h, w = -(-h // stride), -(-w // stride)
            flops += 2 * 9 * cin * f * h * w + 2 * 9 * f * f * h * w
            if cin != f or stride != 1:
                flops += 2 * cin * f * h * w          # the projection
            cin = f
    return flops + 2 * cin * cfg["num_classes"]
