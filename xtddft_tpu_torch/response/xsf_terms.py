"""XSF-TDA spin-adaptation (dA) terms over the fitted B tensor or the in-core ERIs.

Counterpart of the JAX package's `response/xsf_terms.py` for dense B and
exact ERIs.  The blockwise dA couplings need small MO ERI tensors, each
with at least two open-shell indices, built once per operator from B
(`delta_a_tensors_from_df`) or from the in-core ERIs
(`delta_a_tensors_from_eri`), and ~30 small contractions per sigma build.  All of it is plain torch (matrix products
and einsums); none of it is a hand-written kernel yet.
"""

from __future__ import annotations

import numpy as np
import torch

# The largest B panel copied per aux chunk.  Only a V x V panel exceeds it at
# the sizes in use: at nv = 920 in f32 (3.4 MB per aux index) e_VVOC takes 79
# aux indices per chunk, 26 chunks of naux = 2000; every other panel is whole.
PANEL_BUDGET_BYTES = 1 << 28


def delta_a_tensors_from_df(B: torch.Tensor, nc: int, no: int, SA: int) -> dict:
    """MO tensors (pq|rs) = sum_P B[P,p,q] B[P,r,s] of the dA terms, in B's
    dtype on B's device.  Each is accumulated over aux chunks, so that no
    (naux, p, q) panel is copied whole: the V x V panel of ``e_VVOC`` would
    be naux*nv*nv elements (GBs at nmo = 1000)."""
    naux = B.shape[0]
    C, O, V = slice(0, nc), slice(nc, nc + no), slice(nc + no, None)

    def _m(s1, s2, s3, s4):
        X, Y = B[:, s1, s2], B[:, s3, s4]
        shape = (*X.shape[1:], *Y.shape[1:])
        per_aux = max(1, X[0].numel() * B.element_size())
        chunk = max(1, min(naux, PANEL_BUDGET_BYTES // per_aux))
        out = torch.zeros((X[0].numel(), Y[0].numel()), dtype=B.dtype, device=B.device)
        for p0 in range(0, naux, chunk):
            out.addmm_(X[p0:p0 + chunk].reshape(-1, out.shape[0]).T,
                       Y[p0:p0 + chunk].reshape(-1, out.shape[1]))
        return out.reshape(shape)

    t = {
        "e_OCCO": _m(O, C, C, O),
        "e_VOOV": _m(V, O, O, V),
    }
    if SA > 1:
        t["e_VOCC"] = _m(V, O, C, C)
        t["e_VVOC"] = _m(V, V, O, C)
        t["e_OCOV"] = _m(O, C, O, V)
        t["e_OVOC"] = _m(O, V, O, C)
    if SA > 2:
        t["e_VOOC"] = _m(V, O, O, C)
        t["e_OOOC"] = _m(O, O, O, C)
        t["e_VOOO"] = _m(V, O, O, O)
    return t


def delta_a_tensors_from_eri(ref, SA: int) -> dict:
    """The same MO tensors from the in-core ERIs, on the Env's device (JAX
    `response/xsf_terms.py:16`)."""
    from xtddft_tpu_torch.response.moeri import mo_eri

    nc, no = ref.nc, ref.no
    mo = ref.env.tensor(ref.mo_a)
    C, O, V = mo[:, :nc], mo[:, nc:nc + no], mo[:, nc + no:]
    eri = ref.env.eri
    t = {
        "e_OCCO": mo_eri(eri, O, C, C, O),
        "e_VOOV": mo_eri(eri, V, O, O, V),
    }
    if SA > 1:
        t["e_VOCC"] = mo_eri(eri, V, O, C, C)
        t["e_VVOC"] = mo_eri(eri, V, V, O, C)
        t["e_OCOV"] = mo_eri(eri, O, C, O, V)
        t["e_OVOC"] = mo_eri(eri, O, V, O, C)
    if SA > 2:
        t["e_VOOC"] = mo_eri(eri, V, O, O, C)
        t["e_OOOC"] = mo_eri(eri, O, O, O, C)
        t["e_VOOO"] = mo_eri(eri, V, O, O, O)
    return t


def delta_a_fock_blocks(fock_hf_a, fock_hf_b, nc: int, no: int, dtype, device) -> dict:
    """HF-Fock-pair ingredients of dA."""
    C, O, V = slice(0, nc), slice(nc, nc + no), slice(nc + no, None)
    fahf = torch.as_tensor(np.asarray(fock_hf_a), dtype=dtype, device=device)
    fbhf = torch.as_tensor(np.asarray(fock_hf_b), dtype=dtype, device=device)
    fockS = 0.5 * (fbhf - fahf)
    return {
        "fS_C": fockS[C, C],
        "fS_V": fockS[V, V],
        "fS_CV": fockS[C, V],
        "fbhf_VO": fbhf[V, O],
        "fahf_CO": fahf[C, O],
        "fahf_OC": fahf[O, C],
        "fbhf_CO": fbhf[C, O],
        "fahf_OV": fahf[O, V],
    }


def apply_delta_a(T, si: float, SA: int, foo: float, zcv, zco, zov, zoo):
    """(dcv, dco, dov, doo) spin-adaptation couplings applied to the z
    blocks; T holds the tensors from `delta_a_tensors_*` +
    `delta_a_fock_blocks`."""
    no = zoo.shape[-1]
    c1 = float(np.sqrt(1.0 + 1.0 / (2 * si)) - 1.0)
    c2 = float(np.sqrt(2 * si / (2 * si - 1)) - 1.0)
    c3 = float(1.0 / np.sqrt(2 * si * (2 * si - 1)))
    factor = float(np.sqrt((2 * si + 1) / (2 * si - 1)))
    eye_o = torch.eye(no, dtype=zoo.dtype, device=zoo.device)

    dcv = (
        torch.einsum("ab,xib->xia", T["fS_V"], zcv)
        + torch.einsum("ji,xja->xia", T["fS_C"], zcv)
    ) / si
    dco = (
        torch.einsum("ji,xju->xiu", T["fS_C"], zco) * 2.0 / (2 * si - 1)
        - torch.einsum("uijv,xjv->xiu", T["e_OCCO"], zco) / (2 * si - 1)
    )
    dov = (
        torch.einsum("ab,xub->xua", T["fS_V"], zov) * 2.0 / (2 * si - 1)
        - torch.einsum("auvb,xvb->xua", T["e_VOOV"], zov) / (2 * si - 1)
    )
    doo = torch.zeros_like(zoo)
    if SA > 1:
        dcv = dcv + c1 * (
            torch.einsum("av,xiv->xia", T["fbhf_VO"], zco)
            - torch.einsum("avji,xjv->xia", T["e_VOCC"], zco)
        )
        dco = dco + c1 * (
            torch.einsum("av,xia->xiv", T["fbhf_VO"], zcv)
            - torch.einsum("avji,xia->xjv", T["e_VOCC"], zcv)
        )
        dcv = dcv + c1 * (
            -torch.einsum("iv,xva->xia", T["fahf_CO"], zov)
            - torch.einsum("abvi,xvb->xia", T["e_VVOC"], zov)
        )
        dov = dov + c1 * (
            -torch.einsum("iv,xia->xva", T["fahf_CO"], zcv)
            - torch.einsum("abvi,xib->xva", T["e_VVOC"], zcv)
        )
        dco = dco + (1.0 / (2 * si - 1)) * (
            torch.einsum("uivb,xvb->xiu", T["e_OCOV"], zov)
            - torch.einsum("ubvi,xvb->xiu", T["e_OVOC"], zov)
        )
        dov = dov + (1.0 / (2 * si - 1)) * (
            torch.einsum("uivb,xiu->xvb", T["e_OCOV"], zco)
            - torch.einsum("ubvi,xiu->xvb", T["e_OVOC"], zco)
        )
    if SA > 2:
        dcv = dcv + foo * (
            -(factor - 1.0) * torch.einsum("avwi,xwv->xia", T["e_VOOC"], zoo)
            + (factor / si) * torch.einsum("ia,xww->xia", T["fS_CV"], zoo)
        )
        doo = doo + foo * (
            -(factor - 1.0) * torch.einsum("avwi,xia->xwv", T["e_VOOC"], zcv)
            + (factor / si)
            * torch.einsum("ia,xia,wv->xwv", T["fS_CV"], zcv, eye_o)
        )
        dco = dco + foo * (
            c2 * (
                -torch.einsum("wi,xwu->xiu", T["fahf_OC"], zoo)
                - torch.einsum("uvwi,xwv->xiu", T["e_OOOC"], zoo)
            )
            + c3 * torch.einsum("iu,xww->xiu", T["fbhf_CO"], zoo)
        )
        doo = doo + foo * (
            c2 * (
                -torch.einsum("wi,xiv->xwv", T["fahf_OC"], zco)
                - torch.einsum("uvwi,xiu->xwv", T["e_OOOC"], zco)
            )
            + c3 * torch.einsum("iu,xiu,wv->xwv", T["fbhf_CO"], zco, eye_o)
        )
        dov = dov + foo * (
            c2 * (
                torch.einsum("av,xuv->xua", T["fbhf_VO"], zoo)
                - torch.einsum("avwu,xwv->xua", T["e_VOOO"], zoo)
            )
            - c3 * torch.einsum("ua,xww->xua", T["fahf_OV"], zoo)
        )
        doo = doo + foo * (
            c2 * (
                torch.einsum("av,xwa->xwv", T["fbhf_VO"], zov)
                - torch.einsum("avwu,xua->xwv", T["e_VOOO"], zov)
            )
            - c3 * torch.einsum("ua,xua,wv->xwv", T["fahf_OV"], zov, eye_o)
        )
    return dcv, dco, dov, doo
