"""Symmetry-resolved occupation selection for non-aufbau references.

PySCF pins excited SCF configurations through ``irrep_nelec``
(``mol.symmetry=True; mf.irrep_nelec = {'A1': (4, 2), 'B1': (1, 1),
'B2': (1, 1)}``: the FH 3Sigma reference of the XSF-TDA goldens).  The
SCF here holds non-aufbau states by maximum-overlap (MOM) tracking of an
explicit orbital index list instead (`scf/driver.py kernel(occ=...)`),
which is positional and easy to get wrong.  A copy of the JAX package's
`scf/occupations.py` (host numpy).

`occ_from_irreps` bridges the two: given an aufbau-converged mean field
and the reference-style ``{irrep: (n_alpha, n_beta)}`` spec, it labels
the MOs with `chem/symmetry.mo_irreps`, symmetry-adapts any
frame-misaligned orbital pairs (a linear molecule's detected x/y axes
are arbitrary: a converged 3Pi state's pi pair can sit at 45 degrees to
them, characters +-0.707), and returns both the
(alpha_indices, beta_indices) pair and the adapted coefficient matrix
for ``kernel(occ=..., init=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["occ_from_irreps"]


def occ_from_irreps(mf, irrep_nelec: dict, strict: float = 0.05):
    """((alpha_indices, beta_indices), init) for ``SCF.kernel(occ=...,
    init=...)`` from a per-irrep electron count.

    mf:  an aufbau-converged restricted/RO mean field whose orbitals
         define the index space.
    irrep_nelec: ``{label: (n_alpha, n_beta)}`` (an int means paired,
         pyscf convention).  Labels are Mulliken labels of the detected
         point group (`chem/symmetry.analyze`); the counts must sum to
         (nalpha, nbeta).

    Within each irrep the energetically lowest MOs are selected —
    pyscf's irrep_nelec semantics; MOM then holds the configuration
    through the SCF iterations.  ``init`` is ``mf.mo_coeff`` with any
    symmetry-broken orbital clusters rotated into the detected frame
    (a unitary mix within the cluster — a valid SCF starting guess
    whose labels are clean).
    """
    from xtddft_tpu_torch.chem import symmetry

    C = np.array(np.asarray(mf.mo_coeff), dtype=np.float64)
    if C.ndim != 2:
        raise NotImplementedError(
            "occ_from_irreps covers restricted/RO references (one MO set)")
    env = mf.env
    S = env.S.detach().to("cpu", torch.float64).numpy()
    info = symmetry.analyze(mf.mol)
    e_mo = np.asarray(mf.mo_energy)

    def _labels(Cm):
        return symmetry.mo_irreps(env.layout, S, Cm, info, strict=strict,
                                  mo_energy=e_mo)

    labels, _ = _labels(C)
    if "?" in labels:
        # frame-misaligned clusters: consecutive '?' MOs span a
        # reducible block (e.g. a linear molecule's pi pair at 45
        # degrees to the detected x/y axes).  Jointly diagonalize the
        # group reps over each cluster — the same adaptation mo_irreps
        # applies to energy-degenerate clusters, here as an explicit
        # unitary fix-up of the starting guess.
        names = [n for n, _, _, _ in info.ops if n != "E"]
        Us = {n: symmetry.ao_representation(env.layout, info, k)
              for k, (n, _, _, _) in enumerate(info.ops) if n != "E"}
        i = 0
        nmo = C.shape[1]
        while i < nmo:
            if labels[i] != "?":
                i += 1
                continue
            j = i
            while j < nmo and labels[j] == "?":
                j += 1
            blk = C[:, i:j]
            acc = np.zeros((j - i, j - i))
            for t, n in enumerate(names):
                B = blk.T @ S @ Us[n] @ blk
                acc += (1.7 ** t) * 0.5 * (B + B.T)
            _, W = np.linalg.eigh(acc)
            C[:, i:j] = blk @ W
            i = j
        labels, _ = _labels(C)

    available = sorted(set(labels))
    occ_a: list[int] = []
    occ_b: list[int] = []
    for irr, n in irrep_nelec.items():
        na_i, nb_i = (n, n) if np.isscalar(n) else (int(n[0]), int(n[1]))
        idx = [i for i, lbl in enumerate(labels) if lbl == irr]
        if len(idx) < max(na_i, nb_i):
            raise ValueError(
                f"irrep {irr!r}: requested ({na_i}, {nb_i}) electrons but "
                f"only {len(idx)} MOs carry that label (available labels: "
                f"{available})")
        occ_a.extend(idx[:na_i])
        occ_b.extend(idx[:nb_i])
    na, nb = mf.mol.nalpha, mf.mol.nbeta
    if len(occ_a) != na or len(occ_b) != nb:
        raise ValueError(
            f"irrep_nelec sums to ({len(occ_a)}, {len(occ_b)}) electrons; "
            f"the molecule has ({na}, {nb})")
    return (sorted(occ_a), sorted(occ_b)), C
