"""Even-tempered uncontracted basis generator ("etb").

The environment carries no tabulated basis data beyond the light
elements, and nothing can be fetched (zero egress), so heavy-element
work (the reference's As-atom SOC pipeline,
`x2c_hamiltonian/test_SOCSI.py:130-147`, runs
cc-pVDZ from PySC F's library) uses a self-generated even-tempered
basis instead: per angular momentum occupied in the atom, a geometric
exponent progression alpha_k = alpha_max / beta^k spanning
[alpha_min, alpha_max], fully uncontracted.

Ranges follow hydrogenic scaling of the innermost orbital per l
(alpha_max ~ c_l Z^2 with a steep-function margin for X2C) down to a
fixed diffuse floor.  Quality is validated in tests against known
numerical atomic ROHF limits (O, Cl, As) — DZ-to-TZ quality at
beta=2.3.  This is an honest engineering substitute, not cc-pVDZ;
tracked in GAPS.md.
"""

from __future__ import annotations

import numpy as np

__all__ = ["etb_element_basis", "ETB_BETA"]

ETB_BETA = 2.3

# aufbau order (n, l) with capacities 2(2l+1)
_AUFBAU = [
    (1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (4, 0), (3, 2), (4, 1),
    (5, 0), (4, 2), (5, 1), (6, 0), (4, 3), (5, 2), (6, 1), (7, 0),
    (5, 3), (6, 2), (7, 1),
]


def _occupied_ls(z: int) -> dict[int, int]:
    """{l: number of occupied (n,l) sub-shells} by aufbau filling."""
    remaining = z
    out: dict[int, int] = {}
    for n, l in _AUFBAU:
        if remaining <= 0:
            break
        cap = 2 * (2 * l + 1)
        out[l] = out.get(l, 0) + 1
        remaining -= cap
    return out


# alpha_max = _C_HI[l] * Z^2 (steep margin for the X2C small component on
# s/p); alpha_min floors chosen at typical valence-diffuse coverage.
_C_HI = {0: 60.0, 1: 4.0, 2: 0.4, 3: 0.2}
_A_LO = {0: 0.035, 1: 0.03, 2: 0.1, 3: 0.25}


def etb_element_basis(z: int, beta: float = ETB_BETA):
    """[(l_label, [(exp, 1.0)])] uncontracted shells for atomic number z."""
    occ = _occupied_ls(z)
    labels = "SPDFG"
    out = []
    for l, nsub in sorted(occ.items()):
        amax = _C_HI[l] * z * z
        amin = _A_LO[l]
        if z <= 2 and l == 0:
            amax = 100.0
        n = int(np.ceil(np.log(amax / amin) / np.log(beta))) + 1
        exps = amax / beta ** np.arange(n)
        for e in exps:
            out.append((labels[l], [(float(e), 1.0)]))
    # one polarization shell set: a few mid-valence exponents at l_occ+1
    lpol = max(occ) + 1
    if lpol <= 4:
        for e in (2.2, 0.7):
            out.append((labels[lpol], [(float(e * (1.0 + 0.02 * z)), 1.0)]))
    return out
