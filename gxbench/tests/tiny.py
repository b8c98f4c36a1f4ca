"""The benchmark's cells cut to a size a CPU test can hold: the same
families, readers, metrics and limits, with fewer and narrower layers,
smaller batches and buckets."""

from __future__ import annotations

import dataclasses

from gxbench.cell import load_cell

RESNET = "resnet20.hips_bsc.b1024"
ENCODER = "lra_text.hips_bsc.l4096"

SHRINK = {
    RESNET: (dict(stage_sizes=[1, 1, 1], stage_filters=[8, 16, 32],
                  image_shape=[8, 8, 3]),
             dict(topology=[2, 2], batch_per_replica=16, bucket_bytes=16384,
                  dc_compression="bsc,0.05", profile_steps=2,
                  data={"x": {"sample_shape": [8, 8, 3]}})),
    ENCODER: (dict(vocab=64, max_len=64, dim=32, num_heads=2, num_layers=2,
                   mlp_dim=128),
              dict(topology=[2, 2], batch_per_replica=4, bucket_bytes=16384,
                   dc_compression="bsc,0.05", profile_steps=2,
                   data={"x": {"sample_shape": [64], "high": 64}})),
}


def tiny_cell(name: str):
    """The cell ``name`` cut to its ``SHRINK`` sizes (a data part's keys
    over the cell's own)."""
    cell = load_cell(name)
    cfg, wl = SHRINK[name]
    data = {k: {**v, **wl.get("data", {}).get(k, {})}
            for k, v in cell.workload["data"].items()}
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               workload={**cell.workload, **wl,
                                         "data": data})
