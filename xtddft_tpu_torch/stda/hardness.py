"""Per-element chemical hardness data for the simplified TDA gamma kernels.

Values are the Grimme group's stda hardness parameters (eV), the same table
the reference vendors (`xtddft/sTDA/eta.py:2-106`; provenance: ORCA / the
public grimme-lab/std2 `stda.f` sources, cited at
`xtddft/sTDA/os_sTDA.py:416-417`).  Stored flat by atomic number Z=1..103.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.chem import elements

# fmt: off
_ETA_EV = (
    # Z = 1..10 (H..Ne)
    6.429954422, 12.54491189, 2.374586656, 3.496763353, 4.619008972,
    5.740978922, 6.862466529, 7.985435701, 9.106475372, 10.2303405,
    # Z = 11..18 (Na..Ar)
    2.44414136, 3.014651383, 3.584907074, 4.1551309, 4.725803974,
    5.295979241, 5.866186484, 6.436618714,
    # Z = 19..36 (K..Kr)
    2.327317836, 2.758723814, 2.858192114, 2.957830043, 3.057341006,
    3.156725429, 3.256382723, 3.355931405, 3.455609117, 3.555013313,
    3.654418348, 3.754160145, 4.185519793, 4.616627246, 5.066214507,
    5.479496097, 5.911099645, 6.341846768,
    # Z = 37..54 (Rb..Xe)
    2.120458257, 2.537370048, 2.633546898, 2.729752893, 2.825973886,
    2.922129604, 3.018370878, 3.114598177, 3.21075628, 3.306947448,
    3.403194857, 3.499376139, 3.916369246, 4.333233219, 4.750078786,
    5.166979327, 5.583887102, 6.00089733,
    # Z = 55..86 (Cs..Rn)
    0.682915024, 0.920094684, 1.157088786, 1.3942757, 1.631473173,
    1.868438998, 2.105657793, 2.342664642, 2.579814982, 2.817026423,
    3.054036533, 3.291169231, 3.528297161, 3.765524929, 4.002554703,
    4.239478341, 4.476583021, 4.706522449, 4.950846694, 5.187931172,
    5.425607621, 5.661914431, 5.90004292, 6.136714532, 6.374129977,
    6.610265613, 1.704348581, 1.941352612, 2.17849151, 2.415812106,
    2.652778084, 2.889955457,
    # Z = 87..103 (Fr..Lr)
    0.988252988, 1.281949997, 1.349725038, 1.417525738, 1.936856752,
    2.230557605, 2.524120496, 3.043612848, 3.416867526, 3.404984444,
    3.924419968, 4.218081328, 4.511592632, 4.805092895, 5.098981621,
    5.392605462, 5.460698793,
)
# fmt: on


def eta_ev(symbol: str) -> float:
    """Chemical hardness (eV) for an element symbol."""
    z = elements.charge_of(symbol)
    if not 1 <= z <= len(_ETA_EV):
        raise ValueError(f"no hardness parameter for element {symbol!r}")
    return _ETA_EV[z - 1]


def eta_per_atom(symbols) -> np.ndarray:
    """(natm,) hardness array in eV for a molecule's atom list."""
    return np.array([eta_ev(s) for s in symbols], dtype=np.float64)
