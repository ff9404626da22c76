from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.chem import elements

__all__ = ["Molecule", "elements"]
