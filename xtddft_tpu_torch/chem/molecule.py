"""Molecule container.

Replaces the reference's implicit dependence on ``pyscf.gto.Mole``
(`xtddft/TDA.py:289-299` constructs molecules with
``gto.M(atom=..., basis=..., spin=...)``).  A :class:`Molecule` is an
immutable value object: atoms + coordinates (stored in bohr), charge and
spin (2S = n_alpha - n_beta), and a basis-set name.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from xtddft_tpu_torch import units
from xtddft_tpu_torch.chem import elements


def _parse_atom_spec(atom) -> tuple[list[str], np.ndarray]:
    """Parse 'N 0 0 0; N 0 0 1.1' strings or [(sym, (x,y,z)), ...] lists."""
    symbols: list[str] = []
    coords: list[list[float]] = []
    if isinstance(atom, str):
        entries = [seg.strip() for seg in atom.replace("\n", ";").split(";")]
        for entry in entries:
            if not entry:
                continue
            parts = entry.split()
            symbols.append(parts[0])
            coords.append([float(x) for x in parts[1:4]])
    else:
        for sym, xyz in atom:
            symbols.append(sym)
            coords.append([float(x) for x in xyz])
    return symbols, np.asarray(coords, dtype=np.float64).reshape(-1, 3)


@dataclasses.dataclass(frozen=True)
class Molecule:
    symbols: tuple[str, ...]
    coords: np.ndarray  # (natm, 3) in bohr
    charge: int = 0
    spin: int = 0  # 2S = n_alpha - n_beta
    basis: str = "sto-3g"

    @classmethod
    def from_atoms(
        cls,
        atom,
        basis: str = "sto-3g",
        charge: int = 0,
        spin: int = 0,
        unit: str = "angstrom",
    ) -> "Molecule":
        symbols, coords = _parse_atom_spec(atom)
        if unit.lower() in ("angstrom", "a", "ang"):
            coords = coords * units.ANG2BOHR
        elif unit.lower() in ("bohr", "b", "au"):
            pass
        else:
            raise ValueError(f"unknown unit {unit!r}")
        return cls(
            symbols=tuple(symbols),
            coords=coords,
            charge=charge,
            spin=spin,
            basis=basis,
        )

    # -- basic derived quantities ------------------------------------------
    @property
    def natm(self) -> int:
        return len(self.symbols)

    @property
    def charges(self) -> np.ndarray:
        return np.array([elements.charge_of(s) for s in self.symbols], dtype=np.float64)

    @property
    def nelectron(self) -> int:
        return int(round(self.charges.sum())) - self.charge

    @property
    def nalpha(self) -> int:
        nelec = self.nelectron
        if (nelec + self.spin) % 2:
            raise ValueError(
                f"electron count {nelec} inconsistent with spin (2S) {self.spin}"
            )
        return (nelec + self.spin) // 2

    @property
    def nbeta(self) -> int:
        return self.nelectron - self.nalpha

    def energy_nuc(self) -> float:
        z = self.charges
        r = self.coords
        e = 0.0
        for i in range(self.natm):
            for j in range(i):
                e += z[i] * z[j] / np.linalg.norm(r[i] - r[j])
        return float(e)

    def charge_center(self) -> np.ndarray:
        z = self.charges
        return (z[:, None] * self.coords).sum(axis=0) / z.sum()

    def with_(self, **kwargs) -> "Molecule":
        return dataclasses.replace(self, **kwargs)

    def __hash__(self):
        return hash(
            (
                self.symbols,
                self.coords.tobytes(),
                self.charge,
                self.spin,
                self.basis,
            )
        )

    def __eq__(self, other):
        return (
            isinstance(other, Molecule)
            and self.symbols == other.symbols
            and np.array_equal(self.coords, other.coords)
            and (self.charge, self.spin, self.basis)
            == (other.charge, other.spin, other.basis)
        )
