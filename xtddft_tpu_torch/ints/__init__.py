from xtddft_tpu_torch.ints.shell import BasisLayout, build_layout
from xtddft_tpu_torch.ints.one_electron import (
    overlap,
    kinetic,
    nuclear_attraction,
    dipole,
    ip_overlap,
    angular_momentum,
)
from xtddft_tpu_torch.ints.two_electron import eri_3c, eri_2c

__all__ = [
    "BasisLayout",
    "build_layout",
    "overlap",
    "kinetic",
    "nuclear_attraction",
    "dipole",
    "ip_overlap",
    "angular_momentum",
    "eri_3c",
    "eri_2c",
]
