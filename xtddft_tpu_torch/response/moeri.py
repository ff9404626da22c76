"""MO-basis ERI transforms (the JAX package's `response/moeri.py`)."""

from __future__ import annotations

import numpy as np
import torch


def mo_eri(eri_ao: torch.Tensor, c1, c2, c3, c4) -> torch.Tensor:
    """(c1 c2 | c3 c4) in chemists' notation from the AO tensor (pq|rs), on
    its device and in its dtype; the coefficients may be numpy or tensors.

    The four quarter transforms run smallest target dimension first, so the
    largest intermediate is no bigger than nao^3 * min(nmo_i), as in the JAX
    package; each is one matrix product over the transformed index.
    """
    cs = [torch.as_tensor(np.asarray(c) if not torch.is_tensor(c) else c,
                          dtype=eri_ao.dtype, device=eri_ao.device) for c in (c1, c2, c3, c4)]
    order = np.argsort([c.shape[1] for c in cs], kind="stable")
    t = eri_ao
    for pos in order:
        # move axis ``pos`` last, contract it with its coefficients, move back
        t = torch.movedim(torch.movedim(t, int(pos), -1) @ cs[pos], -1, int(pos))
    return t.contiguous()
