"""Element data: symbols and nuclear charges."""

SYMBOLS = [
    "X",  # ghost
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
]

Z_BY_SYMBOL = {s: z for z, s in enumerate(SYMBOLS)}
# case-insensitive lookup
Z_BY_SYMBOL.update({s.upper(): z for z, s in enumerate(SYMBOLS)})
Z_BY_SYMBOL.update({s.lower(): z for z, s in enumerate(SYMBOLS)})


def charge_of(symbol: str) -> int:
    try:
        return Z_BY_SYMBOL[symbol]
    except KeyError as exc:  # pragma: no cover
        raise ValueError(f"unknown element symbol {symbol!r}") from exc


def symbol_of(z: int) -> str:
    return SYMBOLS[z]
