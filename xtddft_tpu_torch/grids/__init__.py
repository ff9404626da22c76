from xtddft_tpu_torch.grids.becke import MolecularGrid, build_grid
from xtddft_tpu_torch.grids.eval_ao import eval_ao

__all__ = ["MolecularGrid", "build_grid", "eval_ao"]
