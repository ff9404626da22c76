"""STO-3G basis, generated from the universal STO-NG expansion.

STO-3G expands each Slater orbital (zeta=1) in 3 Gaussians with universal
exponents/coefficients (Hehre, Stewart, Pople, JCP 51, 2657 (1969)); element
basis sets scale the universal exponents by zeta**2 with the published
per-element Slater exponents.  Generating from the universal tables
reproduces the standard tabulated STO-3G sets to full precision.
"""

# universal expansions: l-shell -> (exponents(zeta=1), coefficients)
_EXP_1S = (2.227660584, 0.405771156, 0.109818036)
_C_1S = (0.154328967, 0.535328142, 0.444634542)

_EXP_2SP = (0.994203122, 0.231031272, 0.075138929)
_C_2S = (-0.099967229, 0.399512826, 0.700115469)
_C_2P = (0.155916275, 0.607683719, 0.391957393)

# Slater exponents (zeta1s, zeta2sp) per element, Pople's standard values
_ZETA = {
    "H": (1.24,),
    "He": (1.69,),
    "Li": (2.69, 0.80),
    "Be": (3.68, 1.15),
    "B": (4.68, 1.45),
    "C": (5.67, 1.72),
    "N": (6.67, 1.95),
    "O": (7.66, 2.25),
    "F": (8.65, 2.55),
    "Ne": (9.64, 2.88),
}


def _scale(exps, zeta):
    return tuple(e * zeta * zeta for e in exps)


def _build():
    table = {}
    for sym, zetas in _ZETA.items():
        shells = []
        e1 = _scale(_EXP_1S, zetas[0])
        shells.append(("S", [(e, c) for e, c in zip(e1, _C_1S)]))
        if len(zetas) > 1:
            e2 = _scale(_EXP_2SP, zetas[1])
            shells.append(("S", [(e, c) for e, c in zip(e2, _C_2S)]))
            shells.append(("P", [(e, c) for e, c in zip(e2, _C_2P)]))
        table[sym] = shells
    return table


BASIS = _build()
