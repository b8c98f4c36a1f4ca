"""The Trainer of a workload (copied from ``chip_smoke.py``'s
``make_trainer``, lines 627-658 at the commit that added this file, and
cut to what the workload files state).

The optimizer: the port's fused Adam (``fused_optimizer``, with
``GeoConfig(fused_optim=True)``) or its per-leaf SGD with momentum; the
sync algorithm and the dc-tier compressor by their GeoConfig names; the
topology ``[P, W]`` stacked on one device.
"""

from __future__ import annotations


def make_trainer(model, workload: dict, device):
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.ops.optim import fused_optimizer
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    P, W = workload["topology"]
    opt = workload["optimizer"]
    kind, lr, fused = opt["kind"], opt["learning_rate"], opt["fused"]
    if (kind, fused) == ("adam", True):
        tx = fused_optimizer("adam", learning_rate=lr, b1=opt["b1"],
                             b2=opt["b2"], eps=opt["eps"])
    elif (kind, fused) == ("sgd", False):
        tx = sgd(lr, momentum=opt["momentum"])
    else:
        raise ValueError(f"no recipe for {kind!r} with fused={fused}")
    cfg = GeoConfig(num_parties=P, workers_per_party=W,
                    sync_mode=workload["sync"],
                    compression=workload["dc_compression"],
                    bucket_bytes=workload["bucket_bytes"],
                    fused_optim=fused)
    return Trainer(model, HiPSTopology(P, W), tx, config=cfg, device=device)
