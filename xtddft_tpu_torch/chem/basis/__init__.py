"""Gaussian basis-set registry.

The reference obtains all basis data from PySCF's bundled libraries
(`pyscf.gto.M(basis='cc-pvdz')`); this framework embeds its own tables.

A basis entry for an element is a list of ``(l_label, [(exp, c1[, c2...]), ...])``
tuples; general contractions are expressed by multiple coefficient columns.
"""

from __future__ import annotations

import numpy as np

from xtddft_tpu_torch.chem.basis import (
    data_sto3g,
    data_sto3g_ext,
    data_631g,
    data_ccpvdz,
    data_augccpvtz,
)

# merge the derived Li/B/Ne + second-row extension into STO-3G
_STO3G = dict(data_sto3g.BASIS)
_STO3G.update(data_sto3g_ext.BASIS)

L_LABELS = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4}

_REGISTRY = {
    "sto-3g": _STO3G,
    "sto3g": _STO3G,
    "6-31g": data_631g.BASIS,
    "631g": data_631g.BASIS,
    "cc-pvdz": data_ccpvdz.BASIS,
    "ccpvdz": data_ccpvdz.BASIS,
    "aug-cc-pvtz": data_augccpvtz.BASIS,
    "augccpvtz": data_augccpvtz.BASIS,
}

try:  # generated by tools/make_ano_basis.py (ANO contractions of etb)
    from xtddft_tpu_torch.chem.basis import data_anodz

    _REGISTRY["ano-dz"] = data_anodz.ANO_DZ
    _REGISTRY["anodz"] = data_anodz.ANO_DZ
except ImportError:  # pragma: no cover - data file not generated yet
    pass

try:  # generated by tools/make_dzp_basis.py (ano-dz trimmed to DZ+P)
    from xtddft_tpu_torch.chem.basis import data_dzp

    _REGISTRY["dzp"] = data_dzp.DZP
except ImportError:  # pragma: no cover - data file not generated yet
    pass


def normalize_name(name: str) -> str:
    return name.strip().lower().replace("_", "-")


def get_element_basis(basis_name: str, symbol: str):
    """Return [(l, exps(np, nprim), coefs(np, nprim, nctr))] for an element.

    Splits general contractions into per-column segmented shells (each shell
    carries one contraction) so downstream integral code only ever sees
    segmented contractions.
    """
    name = normalize_name(basis_name)
    if name == "etb":
        # generated even-tempered basis (heavy elements / X2C work);
        # see chem/basis/even_tempered.py
        from xtddft_tpu_torch.chem.basis.even_tempered import etb_element_basis
        from xtddft_tpu_torch.chem.elements import charge_of as atomic_number

        table = {symbol.capitalize(): etb_element_basis(atomic_number(symbol))}
        _REGISTRY.setdefault("etb", {}).update(table)
        table = _REGISTRY["etb"]
    try:
        table = _REGISTRY[name]
    except KeyError as exc:
        raise ValueError(
            f"basis {basis_name!r} not available; known: {sorted(set(_REGISTRY))}"
        ) from exc
    sym = symbol.capitalize()
    if sym not in table:
        raise ValueError(f"basis {basis_name!r} has no data for element {symbol!r}")
    shells = []
    for l_label, rows in table[sym]:
        l = L_LABELS[l_label.upper()]
        arr = np.asarray(rows, dtype=np.float64)
        exps = arr[:, 0]
        coef_cols = arr[:, 1:]
        for col in range(coef_cols.shape[1]):
            coefs = coef_cols[:, col]
            mask = coefs != 0.0
            shells.append((l, exps[mask].copy(), coefs[mask].copy()))
    return shells


def register(name: str, table: dict) -> None:
    """Register a user-provided basis table (NWChem-style dict)."""
    _REGISTRY[normalize_name(name)] = table
