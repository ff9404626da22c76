"""Simplified TDA (sTDA): monopole-approximation X-TDA (sX-TDA) and UTDA
(sU-TDA), the counterpart of the JAX package's `stda/`; `STDA` is the
reference's `OSsTDA`.  Its Coulomb-type coupling blocks run on K4
(`kernels/stda_coupling.py`)."""

from xtddft_tpu_torch.stda.core import gamma_jk, lowdin_charges
from xtddft_tpu_torch.stda.diagnostics import (match_states, save_scan_csv, subspace_overlap,
                                               truncation_scan)
from xtddft_tpu_torch.stda.driver import STDA

__all__ = ["STDA", "gamma_jk", "lowdin_charges", "subspace_overlap",
           "match_states", "truncation_scan", "save_scan_csv"]
