"""Rebuild a converged MeanField from a checkpoint of the JAX package.

Reads the ``save_mf`` format of `xtddft_tpu/scf/checkpoint.py` (orbitals,
occupations, converged Fock matrices, molecule spec); the Env (integrals,
grids, DF tensors) is rebuilt lazily from the molecule spec on the given
device.
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.scf.driver import MeanField
from xtddft_tpu_torch.scf.env import Env
from xtddft_tpu_torch.xc import registry as xc_registry

__all__ = ["load_mf"]


def load_mf(path: str, df: bool | None = None,
            device: torch.device | str | None = None,
            dtype: torch.dtype | None = None) -> MeanField:
    """df: override the Env's density-fitting mode (the port's J/K is DF
    only, so a checkpoint of an in-core SCF is loaded with df=True)."""
    z = np.load(path, allow_pickle=False)
    mol = Molecule(
        symbols=tuple(str(s) for s in z["symbols"]),
        coords=np.asarray(z["coords"], dtype=np.float64),
        charge=int(z["charge"]),
        spin=int(z["spin"]),
        basis=str(z["basis"]),
    )
    use_df = bool(z["df"]) if df is None else df
    aux_mode = str(z["aux_mode"]) if "aux_mode" in z.files else "full"
    env = Env(mol, grid_level=int(z["grid_level"]), df=use_df,
              aux_beta=float(z["aux_beta"]), aux_mode=aux_mode,
              x2c=bool(z["x2c"]), device=device, dtype=dtype)
    v_ext = None
    if "v_ext" in z.files and z["v_ext"].size:
        v_ext = np.asarray(z["v_ext"], dtype=np.float64)
    xc_name = str(z["xc"])
    return MeanField(
        mol=mol,
        env=env,
        kind=str(z["kind"]),
        xc=xc_registry.resolve(xc_name) if xc_name else None,
        mo_coeff=np.asarray(z["mo_coeff"]),
        mo_energy=np.asarray(z["mo_energy"]),
        mo_occ=np.asarray(z["mo_occ"]),
        e_tot=float(z["e_tot"]),
        converged=bool(z["converged"]),
        fock_a=np.asarray(z["fock_a"]),
        fock_b=np.asarray(z["fock_b"]),
        v_ext=v_ext,
    )
