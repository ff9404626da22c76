from xtddft_tpu_torch.scf.driver import (
    SCF,
    MeanField,
    RHF,
    UHF,
    ROHF,
    RKS,
    UKS,
    ROKS,
)

__all__ = ["SCF", "MeanField", "RHF", "UHF", "ROHF", "RKS", "UKS", "ROKS"]
