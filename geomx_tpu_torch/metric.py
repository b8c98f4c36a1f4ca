"""Evaluation metrics — the ``mx.metric`` surface (port of
geomx_tpu/metric.py).

Reference: python/mxnet/metric.py — EvalMetric base (update/get/reset,
name-value pairs), the standard classification/regression metrics, a
composite container, and a ``create`` factory.  These run on host numpy:
``update`` takes numpy arrays or tensors (on any device; a tensor is
copied to the host once), keeping the training step free of
data-dependent work.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class EvalMetric:
    """Base metric: running (sum, count) with update/get/reset
    (reference python/mxnet/metric.py EvalMetric)."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.sum_metric = 0.0
        self.num_inst = 0

    def update(self, labels, preds) -> None:
        raise NotImplementedError

    def get(self) -> Tuple[str, float]:
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        return [(name, value)]


class Accuracy(EvalMetric):
    def __init__(self, name: str = "accuracy"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        labels, preds = _to_np(labels), _to_np(preds)
        if preds.ndim == labels.ndim + 1:
            preds = np.argmax(preds, axis=-1)
        self.sum_metric += float((preds.astype(np.int64) ==
                                  labels.astype(np.int64)).sum())
        self.num_inst += labels.size


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k: int = 1, name: Optional[str] = None):
        self.top_k = int(top_k)
        super().__init__(name or f"top_k_accuracy_{top_k}")

    def update(self, labels, preds) -> None:
        labels, preds = _to_np(labels), _to_np(preds)
        topk = np.argsort(preds, axis=-1)[..., -self.top_k:]
        hit = (topk == labels[..., None]).any(axis=-1)
        self.sum_metric += float(hit.sum())
        self.num_inst += labels.size


class F1(EvalMetric):
    """Binary F1 over {0,1} labels; predictions are class scores or
    hard labels (reference metric.py F1)."""

    def __init__(self, name: str = "f1"):
        super().__init__(name)

    def reset(self) -> None:
        super().reset()
        self.tp = self.fp = self.fn = 0

    def update(self, labels, preds) -> None:
        labels, preds = _to_np(labels), _to_np(preds)
        if preds.ndim == labels.ndim + 1:
            preds = np.argmax(preds, axis=-1)
        preds = preds.astype(np.int64)
        labels = labels.astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())
        self.num_inst = 1  # get() reports the ratio directly

    def get(self) -> Tuple[str, float]:
        prec = self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0
        rec = self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return self.name, f1


class MAE(EvalMetric):
    def __init__(self, name: str = "mae"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        labels, preds = _to_np(labels), _to_np(preds)
        self.sum_metric += float(np.abs(labels - preds).sum())
        self.num_inst += labels.size


class MSE(EvalMetric):
    def __init__(self, name: str = "mse"):
        super().__init__(name)

    def update(self, labels, preds) -> None:
        labels, preds = _to_np(labels), _to_np(preds)
        self.sum_metric += float(((labels - preds) ** 2).sum())
        self.num_inst += labels.size


class RMSE(MSE):
    def __init__(self, name: str = "rmse"):
        super().__init__(name)

    def get(self) -> Tuple[str, float]:
        name, mse = super().get()
        return name, float(np.sqrt(mse))


class CrossEntropy(EvalMetric):
    """Mean negative log-likelihood of the true class; preds are
    probabilities [..., num_classes] (reference metric.py CrossEntropy)."""

    def __init__(self, eps: float = 1e-12, name: str = "cross-entropy"):
        self.eps = eps
        super().__init__(name)

    def update(self, labels, preds) -> None:
        labels, preds = _to_np(labels), _to_np(preds)
        labels = labels.astype(np.int64).reshape(-1)
        p = preds.reshape(len(labels), -1)[np.arange(len(labels)), labels]
        self.sum_metric += float(-np.log(np.maximum(p, self.eps)).sum())
        self.num_inst += len(labels)


class CompositeEvalMetric(EvalMetric):
    """Bundle of metrics updated together (reference CompositeEvalMetric)."""

    def __init__(self, metrics: Optional[Sequence[EvalMetric]] = None,
                 name: str = "composite"):
        self.metrics: List[EvalMetric] = list(metrics or [])
        super().__init__(name)

    def add(self, metric: "EvalMetric") -> None:
        self.metrics.append(metric)

    def reset(self) -> None:
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds) -> None:
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values

    def get_name_value(self):
        return [m.get() for m in self.metrics]


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy,
    "top_k_accuracy": TopKAccuracy, "top_k_acc": TopKAccuracy,
    "f1": F1,
    "mae": MAE, "mse": MSE, "rmse": RMSE,
    "ce": CrossEntropy, "cross-entropy": CrossEntropy,
}


def create(metric: Union[str, Callable, Sequence], **kwargs) -> EvalMetric:
    """Factory mirroring mx.metric.create: a name, a list of names (->
    composite), or an EvalMetric instance passes through."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        return CompositeEvalMetric([create(m) for m in metric], **kwargs)
    name = str(metric).lower()
    if name not in _REGISTRY:
        raise ValueError(f"Unknown metric {metric!r}; "
                         f"options: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
