"""Relativistic spin-orbit layer: sfX2C decoupling, SO-DKH1 SOMF Vso
integrals, Zeeman integrals, and SOC state interaction.

Counterpart of the JAX package's `soc/` (the reference's
`x2c_hamiltonian/`).
"""

from xtddft_tpu_torch.soc.x2c import get_p, sfx2c1e, uncontract
from xtddft_tpu_torch.soc.somf import build_vso

__all__ = ["sfx2c1e", "uncontract", "get_p", "build_vso"]
