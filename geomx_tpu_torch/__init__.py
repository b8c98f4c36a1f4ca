"""geomx_tpu_torch — the PyTorch/CUDA port of geomx_tpu.

Same module names as the JAX package, PyTorch idiom inside: models are
``nn.Module``s, state is dictionaries of tensors, randomness comes from
explicit ``torch.Generator``s, and every entry point takes a ``device``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise.

The two-tier HiPS topology ``[P, W]`` runs in one process on one card:
every state tensor carries leading ``[P, W]`` replica axes, exactly as
the JAX state does, and the collectives are reductions over those axes
(``parallel/collectives.py``).  The four Pallas kernels of the main
path (bucket flatten/unflatten, BSC select/pack and scatter-add) are
hand-written CUDA C++ for Hopper under ``csrc/``.

This package never imports ``jax`` or ``geomx_tpu``: it has to import on
a GPU host without JAX.  Only the parity tests import both.
"""

from geomx_tpu_torch.config import GeoConfig
from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.topology import HiPSTopology

__all__ = ["GeoConfig", "HiPSTopology", "resolve_device"]
