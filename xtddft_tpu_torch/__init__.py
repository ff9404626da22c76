"""xtddft_tpu_torch — the PyTorch/CUDA port of xtddft_tpu for NVIDIA Hopper.

Same subpackage layout as the JAX package, so each module's counterpart is
found under the same name:

- ``chem``, ``ints``, ``grids``  host numpy: molecules, basis sets,
  McMurchie-Davidson integrals (native engine built from source), Becke grids
- ``xc``        LDA/GGA energy densities in torch; fxc via ``torch.func``
- ``scf``       integral/grid environment, ``MeanField`` and checkpoints
- ``response``  the reference state and the density-fitted X-TDA sigma
- ``solver``    block Davidson with V/AV on the device
- ``props``     oscillator/rotatory strengths and <dS^2>
- ``methods``   user-facing drivers (``XTDA``)
- ``kernels``   hand-written CUDA kernels with their plain torch versions

This package never imports JAX or ``xtddft_tpu``.
"""

from xtddft_tpu_torch import config as _config

_config.initialize()

__version__ = "0.1.0"
