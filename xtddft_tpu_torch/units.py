"""Physical constants and unit conversions.

Follows the ORCA-convention constants used by the reference
(`xtddft/utils/unit.py:4-24`) so printed excitation tables
are directly comparable.
"""

# atomic-unit speed of light
C_AU = 137.03599967994

# ORCA conventions (the reference prints eV with these)
HA2EV = 27.2113834
BOHR = 0.5291772083  # Angstrom per bohr
ANG2BOHR = 1.0 / BOHR
CGS2AU = 1.0 / (235.7220 * 2)  # rotatory strength au -> 1e-40 cgs

EV_X_NM = 1239.842  # E[eV] * lambda[nm]
EV2CM_1 = 8065.545  # eV -> cm^-1

AU2DEBYE = 2.541765
