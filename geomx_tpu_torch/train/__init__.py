"""Training: state, step and the fit-path Trainer."""

from geomx_tpu_torch.train.state import TrainState
from geomx_tpu_torch.train.trainer import Trainer

__all__ = ["TrainState", "Trainer"]
