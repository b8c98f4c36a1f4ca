"""Dataset loading (port of geomx_tpu/data/datasets.py, CIFAR-10 and the
synthetic set): CIFAR-10 from local files when present, else the same
deterministic class-conditional synthetic set as the JAX package, so both
packages train on byte-identical data for the same seed.

CIFAR-10 is picked up under ``root`` in the python pickle batches or the
binary ``.bin`` format.  MNIST and FashionMNIST are not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

DATASETS = ("cifar10", "synthetic")

_SHAPES = {
    "cifar10": (32, 32, 3),
    "synthetic": (32, 32, 3),
}


def _load_cifar10(root: str):
    pydir = os.path.join(root, "cifar-10-batches-py")
    if os.path.isdir(pydir):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(pydir, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(np.asarray(d[b"labels"], np.int32))
        with open(os.path.join(pydir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xtest = d[b"data"]
        ytest = np.asarray(d[b"labels"], np.int32)

        def to_nhwc(a):
            return np.asarray(a, np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

        return (to_nhwc(np.concatenate(xs)), np.concatenate(ys),
                to_nhwc(xtest), ytest)
    bindir = os.path.join(root, "cifar-10-batches-bin")
    if os.path.isdir(bindir):
        def read_bin(paths):
            recs = []
            for p in paths:
                raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
                recs.append(raw)
            raw = np.concatenate(recs)
            y = raw[:, 0].astype(np.int32)
            x = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x, y
        train_files = [os.path.join(bindir, f"data_batch_{i}.bin") for i in range(1, 6)]
        if all(os.path.exists(p) for p in train_files):
            xs, ys = read_bin(train_files)
            xt, yt = read_bin([os.path.join(bindir, "test_batch.bin")])
            return xs, ys, xt, yt
    return None


def _synthetic(shape: Tuple[int, int, int], num_classes: int = 10,
               train_n: int = 4096, test_n: int = 1024, seed: int = 42):
    """Class-conditional Gaussian images: prototype[class] + noise."""
    rng = np.random.RandomState(seed)
    protos = rng.uniform(0, 255, size=(num_classes,) + shape).astype(np.float32)

    def make(n, seed2):
        r = np.random.RandomState(seed2)
        y = r.randint(0, num_classes, size=n).astype(np.int32)
        noise = r.normal(0, 64.0, size=(n,) + shape).astype(np.float32)
        x = np.clip(protos[y] + noise, 0, 255).astype(np.uint8)
        return x, y

    xs, ys = make(train_n, seed)
    xt, yt = make(test_n, seed + 1)
    return xs, ys, xt, yt


def load_dataset(name: str = "cifar10", root: str = "data",
                 synthetic_fallback: bool = True,
                 synthetic_train_n: int = 4096):
    """Returns dict(train_x[u8 NHWC], train_y[i32], test_x, test_y, synthetic).

    Normalization to [0,1] floats happens in the loader/step, keeping the
    host->device transfer at 1 byte/pixel.
    """
    name = name.lower()
    if name in ("mnist", "fashion-mnist"):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md Queue 1, "
            "item 3 'Data')")
    if name not in DATASETS:
        raise ValueError(f"Unknown dataset {name!r}; options: {DATASETS}")
    shape = _SHAPES[name]
    loaded = None
    if name == "cifar10":
        loaded = _load_cifar10(os.path.join(root, name)) or _load_cifar10(root)
    synthetic = loaded is None
    if synthetic:
        if name != "synthetic" and not synthetic_fallback:
            raise FileNotFoundError(f"No local data for {name} under {root}")
        loaded = _synthetic(shape, train_n=synthetic_train_n)
    xs, ys, xt, yt = loaded
    return {"train_x": xs, "train_y": ys, "test_x": xt, "test_y": yt,
            "synthetic": synthetic, "shape": shape}
