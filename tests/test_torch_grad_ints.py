"""The port's differentiable integrals (`ints/diffints.py`) and K5's plain path.

- diffints' S, T, V, ERIs (and erf-attenuated ERIs) and the pVp block at the
  reference geometry against the port's host engine, to 1e-12 of the largest
  entry;
- their vjps in the coordinates, with cotangents drawn from the seed of
  `tests/data/golden_torch_grad.json`, against the JAX package's
  `ints/jaxints.make_integral_fn` (the golden's integral legs, made by
  `tools/grad_golden.py`: a JAX vjp through every ERI class takes minutes
  on the CPU), to 1e-10 of the largest entry;
- `eri_of_coords`' backward on CPU tensors (K5's plain version) against the
  JAX package's host contraction `grad/analytic._grad_eri_contract`;
- K5's tables (`kernels/eri_grad.GradPlan`), contracted by a numpy copy of
  the CUDA kernel's loops, against the plain version.

All on STO-3G (and OH/6-31G for pVp); one thread.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from xtddft_tpu_torch.chem import Molecule
from xtddft_tpu_torch.ints import build_layout, kinetic, nuclear_attraction, overlap
from xtddft_tpu_torch.ints import diffints as D
from xtddft_tpu_torch.ints import mcmurchie as md
from xtddft_tpu_torch.ints.soc_ints import _nherm, nuclear_deriv2
from xtddft_tpu_torch.ints.two_electron import eri_full
from xtddft_tpu_torch.kernels import eri_grad as K5


GOLDEN = json.loads((pathlib.Path(__file__).parent / "data" / "golden_torch_grad.json")
                    .read_text())
H2O = "O 0 0 0; H 0 0 0.96; H 0.93 0 -0.25"
HCL = "Cl 0 0 0; H 0 0 1.29"
INT_TOL = 1e-12  # of the largest entry: the same recursions, other summation orders
VJP_RTOL = 1e-10


def _layout(atoms, basis="sto-3g", spin=0):
    return build_layout(Molecule.from_atoms(atoms, basis=basis, spin=spin))


def _coords(layout, requires_grad=False):
    return torch.tensor(layout.mol.coords, dtype=torch.float64, requires_grad=requires_grad)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("atoms,omega", [(H2O, 0.0), (HCL, 0.33)], ids=["h2o", "hcl"])
def test_integrals_match_host_engine(atoms, omega):
    lay = _layout(atoms)
    with torch.no_grad():
        out = D.make_integral_fn(lay, omega_lr=omega)(_coords(lay))
    refs = {"S": overlap(lay), "T": kinetic(lay), "V": nuclear_attraction(lay),
            "eri": eri_full(lay)}
    if omega:
        refs["eri_lr"] = eri_full(lay, omega=omega)
    for k, ref in refs.items():
        _close(out[k].numpy(), ref, INT_TOL)


def test_pvp_matches_host_engine():
    lay = _layout("O 0 0 0; H 0 0 0.98", basis="6-31g", spin=1)
    c = _coords(lay)
    charges = np.asarray(lay.mol.charges, dtype=np.float64)
    W = c.new_zeros((lay.nao, lay.nao))
    with torch.no_grad():
        for pc in D._pair_classes(lay):
            W = D._scatter2(W, pc, D._pvp(pc, c, charges))
    _close(W.numpy(), nuclear_deriv2(lay)[0], INT_TOL)


@pytest.mark.parametrize("case", ["ints_h2o", "ints_hcl"])
def test_integral_vjps_match_jax(case):
    """Each integral's vjp in the coordinates (one seeded cotangent each, in
    the golden's order) against the JAX package's."""
    gold = GOLDEN["cases"][case]
    lay = _layout(gold["atoms"])
    n = lay.nao
    omega = gold["omega_lr"]
    rng = np.random.default_rng(GOLDEN["seed"])
    keys = ["S", "T", "V", "eri"] + (["eri_lr"] if omega > 0 else [])
    cts = {k: rng.standard_normal((n, n) if len(k) == 1 else (n,) * 4) for k in keys}
    c = _coords(lay, requires_grad=True)
    out = D.make_integral_fn(lay, omega_lr=omega)(c)
    for k in keys:
        g = torch.autograd.grad(out[k], c, torch.as_tensor(cts[k]), retain_graph=True)[0]
        _close(g.numpy(), gold["vjp"][k], VJP_RTOL)


def test_boys_derivative_is_the_next_order():
    x = torch.tensor([0.0, 1e-9, 0.2, 3.0, 40.0], dtype=torch.float64, requires_grad=True)
    F = D.boys_t(4, x)
    g = torch.autograd.grad(F[2].sum(), x)[0]
    assert torch.allclose(g, -D.boys_t(4, x.detach())[3], rtol=0, atol=1e-15)


def test_eri_plain_backward_matches_jax_contraction():
    """eri_of_coords' backward on CPU tensors (the autograd vjp of diffints'
    ERIs) equals four times JAX's single-position host contraction of the
    8-fold symmetric Gamma."""
    from xtddft_tpu.grad.analytic import _grad_eri_contract
    from xtddft_tpu.ints import build_layout as jax_layout
    from xtddft_tpu.chem import Molecule as JaxMolecule

    lay = _layout(H2O)
    G = torch.as_tensor(np.random.default_rng(3).standard_normal((lay.nao,) * 4))
    c = _coords(lay, requires_grad=True)
    eri = K5.eri_of_coords(c, lay)
    assert torch.allclose(eri.detach(), torch.as_tensor(eri_full(lay)), rtol=0, atol=1e-14)
    g = torch.autograd.grad(eri, c, G)[0].numpy()
    want = 4.0 * _grad_eri_contract(jax_layout(JaxMolecule.from_atoms(H2O, basis="sto-3g")),
                                    K5.symmetrize8(G).numpy())
    _close(g, want, 1e-12)


def _emulate(p, Gc):
    """The CUDA kernel's loops in numpy on a plan's tables: per (ordered bra
    pair, unordered ket pair), Gamma folded into each ket primitive's
    expansion, R of every primitive quartet (the host engine's recursion),
    the three derivative expansions contracted; -4 times the sum per atom."""
    nh = 220
    hsum = p.htab.numpy()[4 * nh:].reshape(56, 35)
    bra_pP, bra_tab, ket_pP, ket_tab = (t.numpy() for t in (p.bra_pP, p.bra_tab, p.ket_pP,
                                                            p.ket_tab))
    g = np.zeros((p.natm, 3))
    for la, lb, oa, ob, atom, bp0, bnp, bt0 in p.bra_rows:
        nca, ncb = (la + 1) * (la + 2) // 2, (lb + 1) * (lb + 2) // 2
        nab, nh1 = nca * ncb, _nherm(la + lb + 1)
        Hb = bra_tab[bt0:bt0 + bnp * 3 * nab * nh1].reshape(bnp, 3, nab, nh1)
        for lc, ld, oc, od, fac, kp0, knp, kt0 in p.ket_rows:
            ncc, ncd_ = (lc + 1) * (lc + 2) // 2, (ld + 1) * (ld + 2) // 2
            ncd, nh2, L = ncc * ncd_, _nherm(lc + ld), la + lb + 1 + lc + ld
            Gb = fac * Gc[oa:oa + nca, ob:ob + ncb, oc:oc + ncc, od:od + ncd_].reshape(nab, ncd)
            Hk = ket_tab[kt0:kt0 + knp * ncd * nh2].reshape(knp, ncd, nh2)
            Kt = np.einsum("ac,jch->jah", Gb, Hk)
            P, Q = bra_pP[bp0:bp0 + bnp], ket_pP[kp0:kp0 + knp]
            pp, qq = np.meshgrid(P[:, 0], Q[:, 0], indexing="ij")
            PQ = (P[:, None, 1:] - Q[None, :, 1:]).reshape(-1, 3)
            al = (pp * qq / (pp + qq)).reshape(-1)
            pref = (2 * np.pi ** 2.5 / (pp * qq * np.sqrt(pp + qq))).reshape(-1)
            R = (md.hermite_coulomb(L, al, PQ) * pref).reshape(-1, bnp, knp)
            Rg = R[hsum[:nh1, :nh2]]  # (nh1, nh2, i, j)
            g[atom] += np.einsum("ixab,jah,bhij->x", Hb, Kt, Rg)
    return -4.0 * g


def test_k5_tables_contracted_as_the_kernel_does():
    lay = _layout(H2O)
    G = K5.symmetrize8(torch.as_tensor(np.random.default_rng(5).standard_normal((lay.nao,) * 4)))
    p = K5.GradPlan(lay, "cpu")
    assert p.nc == 7 and p.bra_rows.shape[0] == 25 and p.ket_rows.shape[0] == 15
    got = _emulate(p, K5.to_cart(p, G).numpy())
    _close(got, K5.eri_grad_plain(lay, G).numpy(), 1e-12)


def test_k5_refuses_f_shells_and_odd_gamma():
    with pytest.raises(NotImplementedError):
        K5.GradPlan(_layout("Be 0 0 0; Be 0 0 2.4", basis="aug-cc-pvtz"), "cpu")
    lay = _layout(H2O)
    with pytest.raises(ValueError):
        K5.eri_grad(lay, torch.zeros((lay.nao,) * 3, dtype=torch.float64))
    before = K5.launches
    K5.eri_grad(lay, torch.zeros((lay.nao,) * 4, dtype=torch.float64))
    assert K5.launches == before  # CPU tensors: the plain version, no launch
