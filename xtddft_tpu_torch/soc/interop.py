"""External-package interop for SOC matrices.

Counterpart of the JAX package's `soc/interop.py`.  The reference can
consume spin-orbit matrices exported by the BDF program ("fso(MO)" text
files, `x2c_hamiltonian/utils/fso_utils.py:13-49`) so its SI driver can be
driven by integrals from a different quantum-chemistry stack.  Same
capability here: the reader returns the (ncomp, nbas, nbas) operator ready
for `soc.si.SIDriver`.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["read_fso_file", "space_dims"]


def read_fso_file(filename: str) -> dict:
    """Read a BDF-format fso(MO) file.

    Header line: ``iop=<i> ncomp=<n> nbas=<nb>``; body: ncomp*nbas^2
    Fortran-ordered floats, one per line.  iop=0 stores (ncomp, nbas,
    nbas); any other iop stores (nbas, nbas, ncomp) — returned
    normalized to (ncomp, nbas, nbas).
    """
    with open(filename) as f:
        header = f.readline().strip()
        m = re.match(r"iop=\s*(\d+)\s+ncomp=\s*(\d+)\s+nbas=\s*(\d+)", header)
        if m is None:
            raise ValueError(f"not a BDF fso header: {header!r}")
        iop, ncomp, nbas = (int(m.group(k)) for k in (1, 2, 3))
        data = np.array([float(ln) for ln in f if ln.strip()])
    if data.size != ncomp * nbas * nbas:
        raise ValueError(
            f"fso payload has {data.size} values, expected {ncomp * nbas ** 2}"
        )
    if iop == 0:
        mat = data.reshape(ncomp, nbas, nbas, order="F")
    else:
        mat = np.moveaxis(data.reshape(nbas, nbas, ncomp, order="F"), -1, 0)
    return {"iop": iop, "ncomp": ncomp, "nbas": nbas, "matrix": mat}


def space_dims(nelectron: int, nao: int, S: float):
    """(norb, nc, no, nv) and the three orbital slices for total spin S
    (the reference's `read_ns`, `fso_utils.py:3-11`)."""
    smax = int(round(2 * S))
    nc = (nelectron - smax) // 2
    no = smax
    nv = nao - nc - no
    assert nc + no + nv == nao
    return (
        nao, nc, no, nv,
        slice(0, nc), slice(nc, nc + no), slice(nc + no, nao),
    )
