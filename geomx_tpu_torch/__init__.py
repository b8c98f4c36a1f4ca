"""geomx_tpu_torch — the PyTorch/CUDA port of geomx_tpu.

Same module names as the JAX package, PyTorch idiom inside: models are
``nn.Module``s, state is dictionaries of tensors, randomness comes from
explicit ``torch.Generator``s, and every entry point takes a ``device``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise.

The two-tier HiPS topology ``[P, W]`` runs in one process on one card:
every state tensor carries leading ``[P, W]`` replica axes, exactly as
the JAX state does, and the collectives are reductions over those axes
(``parallel/collectives.py``).  The Pallas kernels of the training
paths (bucket flatten/unflatten, BSC select/pack and scatter-add, the
fused SGD-momentum and Adam apply, 2-bit quantize/dequantize) are
hand-written CUDA C++ for Hopper under ``csrc/``.

This package never imports ``jax`` or ``geomx_tpu``: it has to import on
a GPU host without JAX.  Only the parity tests import both.
"""

from geomx_tpu_torch.config import GeoConfig
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.topology import HiPSTopology

# the distribution's version (pyproject.toml), which the JAX package
# reports as geomx_tpu.__version__; the health documents and the
# scheduler's build-info gauge carry it
__version__ = "0.1.0"

__all__ = ["GeoConfig", "HiPSTopology", "resolve_device", "__version__"]
