"""STO-3G extension: Li/B/Ne and the second row (Na-Ar).

FIDELITY NOTE (no offline basis tables in this environment):
- universal 1s and 2sp 3-Gaussian expansions: exact canonical values
  (validated: extracting them from the first-row tables and refitting by
  overlap maximization reproduces them to 7 digits, `tools/fit_sto3g.py`)
- universal 3sp expansion: fitted here by the same overlap-maximization
  construction (shared s/p exponents, fit quality 0.9998 per shell)
- zeta exponents: first-row values (Li, B, Ne) are the published standard
  molecular exponents; second-row 1s from the linear Z-trend of the known
  first-row values, 2sp/3sp from Slater's rules.  Expect tens of mHa
  deviation from true STO-3G atomic energies — adequate for structure and
  method demonstrations, flagged for replacement when real tables are
  available (see GAPS.md).
"""

# canonical universal expansions (zeta = 1)
_U1S = [(2.2276606, 0.1543290), (0.4057712, 0.5353281), (0.1098175, 0.4446345)]
_U2SP = [
    (0.9942008, -0.0999672, 0.1559163),
    (0.2310313, 0.3995128, 0.6076837),
    (0.0751386, 0.7001155, 0.3919574),
]
# fitted universal 3sp (tools/fit_sto3g.py)
_U3SP = [
    (0.4238476, -0.2532129, 0.0304856),
    (0.1231184, 0.3696615, 0.6501941),
    (0.0489928, 0.7938765, 0.3897869),
]

# (zeta_1s, zeta_2sp, zeta_3sp or None)
_ZETA = {
    "Li": (2.69, 0.80, None),
    "B": (4.68, 1.45, None),
    "Ne": (9.64, 2.88, None),
    # second row: 1s linear trend 0.9933*Z - 0.293; 2sp/3sp Slater rules
    "Na": (10.63, 3.425, 0.836),
    "Mg": (11.63, 3.925, 1.100),
    "Al": (12.62, 4.425, 1.350),
    "Si": (13.61, 4.925, 1.583),
    "P": (14.61, 5.425, 1.700),
    "S": (15.60, 5.925, 1.817),
    "Cl": (16.59, 6.425, 2.033),
    "Ar": (17.58, 6.925, 2.150),
}


def _shells(sym):
    z1, z2, z3 = _ZETA[sym]
    out = [
        ("S", [(a * z1 * z1, c) for a, c in _U1S]),
        ("S", [(a * z2 * z2, c) for a, c, _ in _U2SP]),
        ("P", [(a * z2 * z2, c) for a, _, c in _U2SP]),
    ]
    if z3 is not None:
        out.append(("S", [(a * z3 * z3, c) for a, c, _ in _U3SP]))
        out.append(("P", [(a * z3 * z3, c) for a, _, c in _U3SP]))
    return out


BASIS = {sym: _shells(sym) for sym in _ZETA}
