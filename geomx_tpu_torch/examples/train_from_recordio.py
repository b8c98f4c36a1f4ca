"""Train from a packed RecordIO dataset — the reference's data path (port
of examples/train_from_recordio.py).

1. pack the demo dataset into one .rec file (+ .idx) with
   ``recordio_writer`` (byte-identical to the JAX package's writer);
2. give every (party, worker) slot its own ``ImageRecordIter`` shard
   (part_index = global worker rank, num_parts = total workers — the
   reference's SplitSampler semantics at the file level);
3. stack the per-worker batches into the [parties, workers, b, ...]
   global batch and run the hierarchical train step.

Run: python -m geomx_tpu_torch.examples.train_from_recordio [-c]
(GEOMX_NUM_PARTIES, GEOMX_WORKERS_PER_PARTY, GEOMX_EPOCHS, GEOMX_BATCH).
"""

import argparse
import os
import tempfile

import numpy as np
import torch


def pack_dataset(path: str, n: int = 2048):
    from geomx_tpu_torch.data import load_dataset
    from geomx_tpu_torch.data.recordio import pack_labelled, recordio_writer

    data = load_dataset("synthetic", synthetic_train_n=n)
    with recordio_writer(path) as w:
        for img, lab in zip(data["train_x"], data["train_y"]):
            w.write(pack_labelled(float(lab), img))
    return data


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cpu", action="store_true",
                        help="run on the CPU (default: the GPU)")
    args = parser.parse_args(argv)

    from geomx_tpu_torch import HiPSTopology
    from geomx_tpu_torch.data.record_iter import ImageRecordIter
    from geomx_tpu_torch.models import get_model
    from geomx_tpu_torch.optim import adam
    from geomx_tpu_torch.sync import FSA
    from geomx_tpu_torch.train import Trainer

    parties = int(os.environ.get("GEOMX_NUM_PARTIES", "2"))
    workers = int(os.environ.get("GEOMX_WORKERS_PER_PARTY", "4"))
    epochs = int(os.environ.get("GEOMX_EPOCHS", "2"))
    local_b = int(os.environ.get("GEOMX_BATCH", "16"))

    topo = HiPSTopology(num_parties=parties, workers_per_party=workers)
    trainer = Trainer(get_model("cnn"), topo, adam(3e-3), sync=FSA(),
                      device="cpu" if args.cpu else None)
    dev = trainer.device

    with tempfile.TemporaryDirectory() as td:
        rec = os.path.join(td, "train.rec")
        data = pack_dataset(rec)
        print(f"[recordio] packed {rec} (native=False)", flush=True)

        total = topo.total_workers
        iters = [ImageRecordIter(rec, local_b, part_index=r,
                                 num_parts=total, seed=1)
                 for r in range(total)]
        steps = min(it.steps_per_epoch for it in iters)
        state = trainer.init_state(seed=0,
                                   sample_input=data["train_x"][:2])
        print(f"[recordio] {parties}x{workers} replicas, {steps} "
              f"steps/epoch, {total} file shards", flush=True)
        for ep in range(epochs):
            eps = [it.epoch(ep) for it in iters]
            for _ in range(steps):
                batches = [next(e) for e in eps]
                xb = np.stack([b[0] for b in batches]).reshape(
                    (parties, workers, local_b) + batches[0][0].shape[1:])
                yb = np.stack([b[1] for b in batches]).reshape(
                    (parties, workers, local_b))
                state, metrics = trainer.train_step(
                    state, torch.as_tensor(xb, device=dev),
                    torch.as_tensor(yb.astype(np.int64), device=dev))
            acc = trainer.evaluate(state, data["test_x"], data["test_y"])
            print(f"[recordio] epoch {ep} loss "
                  f"{float(metrics['loss']):.4f} test_acc {acc:.3f}",
                  flush=True)
        for it in iters:
            it.close()
    print(f"[recordio] final test_acc {acc:.3f}", flush=True)
    return acc


if __name__ == "__main__":
    main()
