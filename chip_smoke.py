"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, report.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises; the script exits non-zero and prints no result):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   no CUDA device is a failure;
1. build the native integral engine and the CUDA kernels K1-K5 from the
   checkout's sources, all at once, with the seconds each build took;
2. each kernel against its plain torch version at the main path's shapes
   (TTM/STO-3G and the nmo=1000 bench operator; K2 and K3 on one 4096-point
   chunk and on the span of one jvp group, which the sigma passes them in
   one launch), f64 and f32, with median CUDA-event times of both and the
   card's bound for the same work (``response/flops.py``) and, where one
   PyTorch call computes the same function (the exchange-only and value-only
   modes: a single einsum), that call's time as ``library_ms``; K1 also at its
   edge cases (nocc above 256, nvir below one tile, one trial vector); then
   the spin-flip modes (exchange-only K1, value-only and four-component K2
   and K3 on overlapping o/v ranges, one case with the virtual side on a
   second tensor and table) at the flip shapes of TTM and of the bench width;
   then the SCF's AO modes at the TTM shapes and, in f64, at TTM/dzp (K1 on
   two density matrices with o0 = v0 = 0 and nocc = nvir = nao, K2
   hermitian, K3 with the AO table on both sides, the whole grid in one
   launch), with ``library_ms`` the single einsum of the exchange and of the
   density (four rows, and the value row alone).  K1 sums in a fixed order
   in every mode; K2 and K3 run the AO modes in their fixed summation order,
   as the SCF runs them, with the atomic order timed beside, and the
   response shapes in the atomic order, with the fixed order timed beside
   (its cost).  Every fixed-order launch is made twice and must repeat
   bitwise.  The
   X-TDA shapes include TTM/dzp's alpha block in f64 (nz 20, naux 3990, nmo
   598; K2 and K3 on a 12-chunk jvp group).  K2 hermitian and K3 on the AO
   table also run at phase 9's shapes: the in-core sigma's stack on CH2O+
   (10 symmetrized transition matrices, 38 AO, 100,738 points) and the
   benzene SCF's pair (114 AO, 294,480 points).  K3's ``library_ms`` is the
   single einsum over its per-point 4x4 weights (main, four-component flip
   and AO modes);
3. the main path: X-TDA on the TTM radical (182 AO, ROKS/B3LYP, density
   fitted) through ``XTDA(load_mf(...), backend="df").kernel()`` in f64,
   gated against ``tests/data/golden_ttm.json``; every kernel must have
   launched in this run;
4. the bench-shape operator (nmo=1000, naux=2000, 49152 grid points, f32):
   one 20-vector sigma build against the plain path, then a 20-root solve;
5. the flip leg on the same TTM reference, f64: ``XSFTDA(ref, SA=0)`` and
   ``SFTDA(ref, extype="up")``, 10 roots each, gated against
   ``tests/data/golden_ttm_flip.json``; every kernel must have launched;
6. the flip leg at the bench width, f32: one ``xsf_sigma_df(SA=3)`` build
   against the plain path, seconds per build with the share of the
   spin-adaptation terms, then a 10-root solve;
7. the SCF on the Env of phase 3 (its grid and fitted tensors), f64: TTM
   ``ROKS(Molecule(ttm_vacuum), xc="b3lyp", grid_level=1, df=True).kernel()``
   from the GWH guess, gated against ``tests/data/ttm_ckpt.npz`` (the JAX
   package's DF SCF: energy and occupied orbital energies), with cycles,
   seconds and the kernel launches per cycle (every kernel must have
   launched on each Fock build), then once more with the device
   synchronized at each stage for the split of a cycle (the functional's
   share is the ``xc`` stage less phase 2's K3 time in AO mode); then
   ``XTDA(mf, nstates=10, backend="df")`` on that mean field, gated against
   ``golden_ttm.json`` like phase 3.  Both SCFs must take the same cycles
   and give the bitwise-same energy (the Fock build sums in a fixed order);
8. production scale, TTM/dzp (598 AO, naux 3990), f64, on one Env:
   ``load_mf`` of ``tests/data/ttm_dzp_ckpt.npz``, then ``XTDA(nstates=20)``
   and ``XSFTDA(SA=0)`` (10 roots, the flip golden's own arguments), each
   gated against the JAX package's own f64 solve of the same checkpoint (the
   ``DZP_JAX_*`` constants) with the goldens' deviations and TTM's E-pair
   splittings printed beside them; then the energy and orbital gradient of
   the checkpoint's own density under the port's Fock build, the ROKS SCF
   from ``geometries.ttm_vacuum`` and the STO-3G checkpoint projected to
   dzp (gated against the JAX host engine's energy of that density and the
   checkpoint's occupied orbital energies), and ``XTDA(nstates=5)`` on its
   mean field.  The set-up line gives each host step's seconds and the
   host's core count; every kernel must launch in every leg;
9. the small-molecule flow, f64, through the public API with ``df=None``
   (in-core below 121 AO) and ``backend="auto"`` (dense), each leg gated
   as tests/test_golden.py gates the JAX package (constants copied from it):
   N2 cc-pVDZ ``TDA``; CH2O+ cc-pVDZ ``XTDA`` (dense, then ``incore`` and
   ``df`` on the same mean field) and ``UTDA``; FH 6-31G, the aufbau ROKS
   energy, the 3Sigma state through ``occ_from_irreps`` and MOM,
   ``XSFTDA`` (ALDA0, multicollinear, ``use_davidson``) and the UKS USF
   leg; Be aug-cc-pVTZ ``XSFTDA``; benzene cc-pVDZ (114 AO, 294,480 grid
   points, the largest size the ladder keeps in-core and dense) ``TDA``
   singlet and triplet and ``UTDA``, whose roots must be the lowest ten of
   theirs.  Each leg prints its ERI and grid build seconds, its SCF cycles
   and stage seconds, each response's route and seconds, and the kernels'
   launches; K2 and K3 must launch in every leg;
10. the functionals at TTM's full width (182 AO, grid 1, DF, f64) on phase
   3's Env: ``ROKS(ttm_vacuum, xc="tpssh")`` and ``xc="camb3lyp"`` (its
   long range on the erf-attenuated fit at omega = 0.33) from the orbitals
   of ``tests/data/ttm_ckpt.npz``, then ``XTDA(nstates=10)`` and
   ``XSFTDA(SA=0, nstates=10)`` (method 1 for TPSSh, 0 for CAM-B3LYP),
   each gated against ``tests/data/golden_ttm_<xc>.json`` (the JAX
   package's own runs of the same calls: SCF energy within 1e-6 Ha and
   occupied orbital energies within 1e-5 Ha, roots within 1e-4 eV, flip
   <dS^2> within 1e-3; the JAX package could not solve TPSSh's
   multicollinear flip at this size on its CPU host, so that leg is
   gated on convergence and launches alone), with cycles, seconds per cycle by stage, solve
   seconds and the launches of every leg; K2's tau row and K3's tau term
   (TPSSh) and K1's exchange-only long-range pass (CAM-B3LYP) must launch
   in every leg; the multicollinear kernel at 187,644 points is timed on
   its own.  Phase 2 holds the same tau modes against their plain
   versions at the TTM shapes (the X-TDA span, the flip-down block's five
   components, the SCF's AO modes) and on the in-core sigma's CH2O+ stack,
   f64 to 1e-12 and f32 to 1e-5, with ``library_ms`` the single einsum of
   the tau row alone (K2) and over the per-point weights with W_yy +=
   dwt / 2 (K3).  Phase 10 runs after phase 7;
11. TDHF/RPA and sTDA at TTM's full width on phase 3's Reference, f64:
   ``XTDHF(nstates=10, backend="df")`` (the paired DF sigma, whose B half is
   K1's RPA exchange mode, and the paired Davidson with its stability
   re-check) gated against ``tests/data/golden_ttm_xtdhf.json`` (roots within
   1e-4 eV, |osc| within 1e-4, <dS^2> within 1e-3, the pencil's residuals
   from fresh matvecs within 1e-6, the RPA mode launched in every pair
   build), with its cycles, pair builds and seconds, the one-off seconds of
   the aligned ov copies its operator made (``rpa_aligned_s``), and the
   Thouless comparison with phase 3's X-TDA roots (printed, not gated); then
   ``STDA(nstates=10)`` (sX-TDA, its Coulomb blocks on K4) gated against
   ``golden_ttm_stda.json`` (the active space and the selected counts per
   block exactly, roots, osc and <dS^2> within 1e-6), with the seconds of
   each stage.  Its closed-shell leg runs in phase 9 on the N2 mean field:
   ``TDHF`` singlet and triplet, dense and DF (within 5e-3 eV), and
   ``UTDHF``, whose roots must be the lowest of the union of the two (5e-6
   Ha); phase 9's CH2O+ leg also runs ``STDA(spinadapt=False)`` (sU-TDA),
   gated as tests/test_golden.py gates the JAX package.  Phase 2 holds K1's
   RPA mode (both contraction orders: TTM's blocks, f64 and f32, and the
   bench's and TTM/dzp's alpha blocks, 20 vectors, on the aligned ov copy,
   whose own time is ``aligned_ms``; ``library_ms`` the single einsum over
   the ov block) and K4 (TTM's selection and final-A blocks and the
   diagonal, f64, on device index lists; ``kernel_ms`` the kernel alone,
   ``call_ms`` the call with host lists; ``library_ms`` the single einsum
   over gathered tables) against their plain versions.  Phase 11 runs
   after phase 10;
12. SCF internal stability and the SOC state interaction, f64 (after phase
   11): ``internal_stability(mf, backend="df")`` on phase 3's TTM mean field
   (6,301 rotation pairs; every Hessian action one Fock build of K1 in AO
   mode with the Coulomb GEMM, K2 hermitian, the functional's jvp and K3)
   with its three lowest eigenvalues against the JAX golden of
   ``tools/stability_soc_golden.py`` (``tests/data/golden_stability_soc.json``,
   1e-6 Ha), its cycles, actions, seconds per action, launches per action
   and peak memory; the stretched-H2 UHF saddle of tests/test_stability.py
   detected and left by ``stable_scf`` on both backends; then the As atom
   (ano-dz, sfX2C-ROKS/BHandHLYP, grid 2: ``SCF(..., x2c=True)``, the
   stability check (``auto``: DF), ``run_soc_si(mf, nstates=20,
   sf_method=2)``, whose SO two-electron term runs a class of quartets at a
   time on the card) against ``golden_as_socsi.json`` (its levels within
   0.1 cm^-1; the SCF energy within 1e-6 Ha of the JAX package's at this
   commit, which the same tool stores: the golden's own is stale by 2.4e-6
   Ha, ROADMAP fault 3.4) and the structure
   assertions of tests/test_soc_si.py, and the O atom's 3P term (STO-3G
   ROHF, 8 states) against the JAX levels (0.01 cm^-1), with the seconds of
   every stage (x2c core Hamiltonian, SCF, stability, each response, the 1e
   and 2e parts of Vso, SI) and the kernels' launches per stage.

13. analytic excited-state nuclear gradients, f64 (after phase 12), on
   CH2O+/cc-pVDZ (38 AO, d shells) at the geometry of
   ``tests/data/golden_ch2o_grad.json``: ROHF, then
   ``ExcitedGradients(mf, "xcis").kernel(0)`` (its states from the dense
   X-TDA driver, the Z-vector by CG on torch.func Hessian actions, one
   reverse pass over the coordinates whose ERI derivative is K5
   `eri_grad`) against the golden's analytic gradient (1e-6 Ha/bohr) and
   its 24-point central differences (1e-5, tests/test_grad_analytic.py's
   gate), its excitation energy (1e-4 eV) and translational invariance
   (1e-9); ``hf_gradient`` (its two-electron term one K5 call) against
   ``scf_gradient`` (1e-8); then ROKS/B3LYP at grid level 1 (its SCF on K2
   hermitian and K3) and its X-TDA state 0's analytic gradient against the
   port's own central differences (h = 1e-3 bohr, ``XTDA`` with the auto
   backend) over the symmetry-unique nonzero components (C z, O z, H1 x,
   H1 z; 2e-5 Ha/bohr).  Each gradient's stages (states, Z-vector
   right-hand side, CG iterations and seconds, the reverse pass) and peak
   memory are printed; K5 must launch in every gradient, K2 and K3 in the
   ROKS SCF.  Phase 2 holds K5 against its plain version (the autograd vjp
   of `ints/diffints.py`'s ERIs) on a seeded 8-fold symmetric Gamma at this
   basis (relative 1e-12, bitwise repeatable) with its times and bound.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  ``--out`` also writes every number to a
JSON file.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
F64_RTOL = 1e-11  # summation order differs from the plain version's
F32_RTOL = 1e-4
AO_RTOL = {"float64": 1e-12, "float32": 1e-5}  # the SCF's AO modes
TTM_GATE_EV = 5e-3  # the JAX DF path's own gate (tests/test_production.py)
SCF_GATE_HA = 1e-6  # TTM SCF energy against the JAX package's checkpoint
SCF_GATE_EPS_HA = 1e-5  # occupied orbital energies against it
# TTM/dzp (phase 8).  The goldens `golden_ttm_dzp*.json` and the stored
# e_tot of `ttm_dzp_ckpt.npz` come from the JAX package's mixed-precision
# production chain and are off the f64 DF operators (2.7-34 meV, 5e-5 Ha;
# TTM's D3 E pairs split by 4-17 meV in the goldens); they are printed, not
# gated.  The references instead: the JAX package's own f64 solve of the
# checkpoint, with the eigensolve of its DF drivers on its f64 X-TDA and
# XSF-TDA operators built on the host (`tools/ttm_dzp_ckpt_energy.py
# --solve`: roots in eV and the flip roots' <dS^2>), and the JAX host
# engine's energy of the checkpoint's density (the same run)
DZP_JAX_XTDA_EV = (
    2.493866335695523, 2.4947596334974476, 2.7333894812217863, 2.75117264466977,
    2.7514196252286487, 2.975365461290274, 3.534517250579991, 3.53483549264867,
    3.6532052618479813, 3.653225178921182, 3.7423195307368675, 3.742425347256728,
    3.826892874126782, 3.844602993641153, 3.920372347458342, 3.9204770591770863,
    3.9529553584399495, 3.9530748489699428, 3.967599961120482, 4.006207887011033,
)
DZP_JAX_XSF_EV = (
    2.3704744966592144, 2.3715599491004884, 2.6399184301523806, 2.652679245686194,
    2.6529959324296044, 2.8642980862106064, 3.2766252624137104, 3.2766805327957664,
    3.608756936802308, 3.6088008257894404,
)
DZP_JAX_XSF_DS2 = (
    0.0630150878278252, 0.06297461297139843, 0.059059304116762884, 0.06377323958381083,
    0.06375434632987974, 0.08115833559137343, 0.18184941497373333, 0.18201003239329974,
    0.047402001104889964, 0.047398436115701624,
)
DZP_JAX_E_OF_CKPT_DENSITY = -4868.533560419979
DZP_GATE_EV = 1e-4
DZP_GATE_DS2 = 1e-3
# X-TDA on the port's own SCF mean field (another mean field than the
# checkpoint's) against the roots of the checkpoint's: the JAX DF path's
# gate at 598 AO (tests/test_production.py)
DZP_SCF_XTDA_GATE_EV = 2e-3
# at dzp the kept fit metric spans a condition number of 2.1e14, so the
# few-ulp differences between two builds of the integral engine (the
# 2-center metric, the 3-center integrals) move the fitted energy: the port
# puts the checkpoint's density 5.7e-6 Ha below the JAX host engine
# (`tools/ttm_dzp_ckpt_energy.py --compare-fit` evaluates the JAX engine
# with the port's metric, then with its metric and j3c); about three times that
DZP_SCF_GATE_HA = 2e-5
# the dzp checkpoint was accepted by the JAX device engine at |g| ~ 1.8e-5,
# so its orbital energies carry that error
DZP_SCF_GATE_EPS_HA = 1e-4


def _log(*args):
    print(*args, flush=True)


def _sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timed calls after one warm-up call."""
    fn()
    _sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        _sync()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 5) -> float:
    """The device time of one call of ``fn``: the kernels' own time under
    torch.profiler over ``reps`` calls after one warm-up, divided by reps,
    without the host's gaps between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
    return total / 1e3 / reps


def _df_launch_counts() -> dict:
    """The launches of the kernels of every DF sigma and Fock build (K1-K3),
    which the TDA, flip and SCF phases require of each of their runs (K4
    runs in sTDA alone)."""
    from xtddft_tpu_torch import kernels

    return {m.NAME: m.launches for m in kernels.DF_MODULES}


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((x - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}


def phase1() -> dict:
    """Every build at once: the native engine and one nvcc per kernel source."""
    from concurrent.futures import ThreadPoolExecutor

    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.buildlib import BUILD_SECONDS
    from xtddft_tpu_torch.ints import native

    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(native.load), pool.submit(kernels.build_all)]:
            f.result()
    _log("phase 1 builds (s):", json.dumps(BUILD_SECONDS))
    return dict(BUILD_SECONDS)


# (label, nz, naux, nmo, ((nocc, nvir) of the alpha and beta blocks), the
# grid chunks of one jvp group, the span K2 and K3 take in one launch, the
# dtypes checked)
F64_ONLY = (torch.float64,)
BOTH = (torch.float64, torch.float32)
MAIN_SHAPES = (
    ("ttm", 10, 4412, 182, ((137, 45), (136, 46)), 23, BOTH),
    ("bench", 20, 2000, 1000, ((80, 920), (78, 922)), 12, BOTH),
    ("dzp", 20, 3990, 598, ((137, 461), (136, 462)), 12, F64_ONLY),
)
# K1's RPA exchange (the B half of a TDHF sigma) at these shapes' spin blocks,
# with RPA_NZ trial vectors: TTM's two, the bench's 80 x 920 block, TTM/dzp's
# alpha block
RPA_SPINS = {"ttm": "ab", "bench": "a", "dzp": "a"}
RPA_NZ = 20
# K1 edge cases, checked but not timed: (label, nz, naux, nmo, nocc, nvir)
K1_EDGES = (
    ("nocc300_odd_naux", 4, 257, 340, 300, 40),
    ("nvir_below_tile", 3, 100, 60, 50, 10),
    ("nz1", 1, 96, 120, 30, 90),
)


# spin-flip shapes: (label, nz, naux, nmo, n_o, v0, n_v, grid points of one
# span, second tensor and table on the virtual side); o = [0, n_o),
# v = [v0, v0 + n_v)
FLIP_SHAPES = (
    ("ttm_down", 10, 4412, 182, 137, 136, 46, 187644, False),
    ("ttm_up", 10, 4412, 182, 136, 137, 45, 187644, True),
    ("bench_down", 10, 2000, 1000, 80, 78, 922, 49152, False),
)


def _check(checks, rec, kern, plain, timed, flops=None, nbytes=None, library=None, twin=None,
           library_of=None):
    """Hold kern() against plain() (relative to max |plain|); time both
    and add the bound when ``timed``.  ``library``: one PyTorch call that
    computes the same function (a single multi-operand einsum), where there
    is one: held against plain() and timed for ``library_ms``; the port
    never calls it.  None where the function has two outputs or is a sum of
    products.  ``rec["fixed_order"]``: kern sums in a fixed order, so a
    second launch must repeat the first bitwise.  ``twin``: the same kernel
    in its other summation order, held against plain() too; the fixed-order
    one of the two is launched twice and must repeat bitwise; ``twin_ms`` is
    its time and ``fixed_order_cost`` the fixed order's time over the atomic
    order's, less one.  ``library_of``: the part of plain()'s output that
    ``library`` computes (K2's tau row alone), where it is not all of it."""
    got = kern()
    _sync()
    want = plain()
    _sync()
    rec["max_abs_err"], rec["rel_err"] = rel_err(got, want)
    other = None
    if twin is not None:
        other = twin()
        rec["twin_rel_err"] = rel_err(other, want)[1]
    if rec.get("fixed_order") or twin is not None:
        fixed, again = (got, kern()) if rec.get("fixed_order") else (other, twin())
        rec["fixed_repeats_bitwise"] = bool(torch.equal(fixed, again))
        del fixed, again
    del got, other
    if library is not None:
        rec["library_rel_err"] = rel_err(library(), want if library_of is None
                                         else library_of(want))[1]
    del want
    if timed:
        from xtddft_tpu_torch.response.flops import bound_ms

        rec["ms"] = time_ms(kern)
        rec["plain_ms"] = time_ms(plain)  # the cuBLAS einsum route of the JAX code
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, rec["dtype"])
        rec["library_ms"] = None if library is None else time_ms(library)
        if twin is not None:
            rec["twin_ms"] = time_ms(twin)
            fixed_ms, atomic_ms = ((rec["ms"], rec["twin_ms"]) if rec["fixed_order"]
                                   else (rec["twin_ms"], rec["ms"]))
            rec["fixed_order_cost"] = fixed_ms / atomic_ms - 1.0
    _log("phase 2", json.dumps(rec))
    if not rec["rel_err"] <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']} disagrees with its plain version: {rec}")
    if not rec.get("library_rel_err", 0.0) <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']}: the library call computes another function: {rec}")
    if twin is not None and not rec["twin_rel_err"] <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']}: its other summation order disagrees: {rec}")
    if not rec.get("fixed_repeats_bitwise", True):
        raise AssertionError(f"{rec['kernel']}: two fixed-order launches differ: {rec}")
    checks.append(rec)


def _k3_weights(dwv, dwg, dwt=None):
    """K3's per-point 4x4 weights W[x, c, d, g]: W00 = dwv, W0y = Wy0 = dwg_y
    (and Wyy = dwt / 2 with the tau term), so that one einsum
    ``"cgo,xcdg,dgv->xov"`` over the tables computes K3; built outside the
    timed call."""
    nz, pts = dwv.shape
    W = torch.zeros((nz, 4, 4, pts), dtype=dwv.dtype, device=dwv.device)
    W[:, 0, 0] = dwv
    W[:, 0, 1:] = dwg
    W[:, 1:, 0] = dwg
    if dwt is not None:
        for y in (1, 2, 3):
            W[:, y, y] = 0.5 * dwt
    return W


def _k2_selection(dtype):
    """M[c, d, e] with rho1[x, c, g] = sum M[c, d, e] po_d[g, o] z[x, o, v]
    pv_e[g, v]: the value row (d = e = 0) and the gradient rows (po_y pv_0 +
    po_0 pv_y), so that one einsum ``"cde,dgo,xov,egv->xcg"`` computes K2's
    four rows; built outside the timed call."""
    M = torch.zeros((4, 4, 4), dtype=dtype, device="cuda")
    M[0, 0, 0] = 1.0
    for y in (1, 2, 3):
        M[y, y, 0] = M[y, 0, y] = 1.0
    return M


def _tau_row(a, z, b, mask=None):
    """K2's tau row alone as one einsum, 1/2 sum_y sum_ov z a_y b_y (times
    the mask): a (3, g, nocc) and b (3, g, nvir) the gradient rows of the
    tables."""
    if mask is None:
        return 0.5 * torch.einsum("xov,ygv,ygo->xg", z, b, a)
    return 0.5 * torch.einsum("xov,ygv,ygo,g->xg", z, b, a, mask)


def _rpa_check(checks, rec, B, no, nv, g):
    """K1's RPA exchange on the (no, nv) block of B against its plain version
    (the JAX einsum pair on B), timed, on the aligned copy of the block that
    the paired sigma makes once per operator (made here outside the timed
    call, its time ``aligned_ms``), with ``library_ms`` the single einsum
    over the ov block whose operands are ordered for the cheaper
    contraction (z with the B factor that the kernel's first stage takes)."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.response import flops as fl

    z = torch.randn((RPA_NZ, no, nv), generator=g, device="cuda", dtype=B.dtype)
    Bov = B[:, :no, no:no + nv]
    R = k1.rpa_aligned(B, 0, no, no, nv)
    spec = "xjb,Pib,Pja->xia" if k1.rpa_order(no, nv) == k1.RPA_OV else "xjb,Pja,Pib->xia"
    r = rec(k1.NAME, mode="rpa_exchange", nz=RPA_NZ, fixed_order=True,
            order="ov" if k1.rpa_order(no, nv) == k1.RPA_OV else "vo",
            aligned_ms=time_ms(lambda: k1.rpa_aligned(B, 0, no, no, nv)))
    _check(checks, r, lambda: k1.rpa_exchange(B, z, 0, no, aligned=R),
           lambda: k1.rpa_exchange_plain(B, z, 0, no), True,
           fl.rpa_exchange_flops(B.shape[0], RPA_NZ, no, nv),
           fl.rpa_exchange_bytes(B.shape[0], RPA_NZ, no, nv, B.element_size()),
           library=lambda: torch.einsum(spec, z, Bov, Bov))
    del z, Bov, R
    torch.cuda.empty_cache()


def _stda_checks(checks, g):
    """K4 at the TTM sX-TDA shapes, f64: random tables of TTM's active space
    (34 atoms; alpha 73 occupied x 45 virtual, beta 72 x 46) and CSF lists of
    the sizes its selection gives (`golden_ttm_stda.json`): the P-CSF rows
    against the N-CSF columns of each spin block (the perturbative
    selection's coupling), the final A's diagonal blocks, and the diagonal
    mode over every CSF.  The lists are device `CSFList`s made outside the
    timed call, as `stda.core` makes them once per CSF set.  ``kernel_ms``
    is the kernel alone (its device time under the profiler, `device_ms`),
    subtracting into a preallocated block as `coupling_matrix` runs it (the
    diagonal: into its output); ``ms`` the call (CUDA events, so the host's
    share between launches too); ``call_ms`` the call with the lists'
    upload and check from host arrays (what each call did before the lists
    stayed on the card).  ``library_ms`` is the
    single einsum over the two gathered (atoms, rows, columns) tensors,
    gathered outside the timed call."""
    from xtddft_tpu_torch.kernels import stda_coupling as k4
    from xtddft_tpu_torch.response import flops as fl

    golden = json.loads((ROOT / "tests/data/golden_ttm_stda.json").read_text())
    act = golden["active"]
    natm, nc, no, nv = 34, act["nc"], act["no"], act["nv"]
    rng = np.random.default_rng(11)
    for spin, (nocc, nvir, blocks) in zip("ab", ((nc + no, nv, ("cva", "ova")),
                                                  (nc, no + nv, ("cob", "cvb")))):
        gt = torch.randn((natm, nocc, nocc), generator=g, device="cuda", dtype=torch.float64)
        qv = torch.randn((natm, nvir, nvir), generator=g, device="cuda", dtype=torch.float64)
        o_all, v_all = (a.ravel() for a in np.indices((nocc, nvir)))
        order = rng.permutation(o_all.size)
        npcsf = sum(golden["pcsf"][b] for b in blocks)
        nfinal = sum(golden["final"][b] for b in blocks)
        p, n = np.sort(order[:npcsf]), np.sort(order[npcsf:])
        f = np.sort(order[:nfinal])

        def dev(idx):
            return k4.csf_list(o_all[idx], v_all[idx], nocc, nvir, "cuda")

        for shape, rows, cols in (("ttm_stda_selection", p, n), ("ttm_stda_final", f, f)):
            lr, lc = dev(rows), dev(cols)
            idx = [torch.as_tensor(i, device="cuda") for i in (o_all[rows], o_all[cols],
                                                                v_all[rows], v_all[cols])]
            go = gt[:, idx[0]][:, :, idx[1]]
            qg = qv[:, idx[2]][:, :, idx[3]]
            buf = torch.zeros((len(rows), len(cols)), dtype=torch.float64, device="cuda")
            r = {"kernel": k4.NAME, "shape": shape, "spin": spin, "dtype": "float64",
                 "natm": natm, "nocc": nocc, "nvir": nvir, "nrow": len(rows),
                 "ncol": len(cols), "rtol": F64_RTOL, "fixed_order": True,
                 "kernel_ms": device_ms(lambda: k4.j_block(gt, qv, lr, lc, out=buf)),
                 "call_ms": time_ms(lambda: k4.j_block(gt, qv, dev(rows), dev(cols)))}
            _check(checks, r, lambda: k4.j_block(gt, qv, lr, lc),
                   lambda: k4.j_block_plain(gt, qv, lr, lc), True,
                   fl.stda_j_flops(len(rows), len(cols), natm),
                   fl.stda_j_bytes(len(rows), len(cols), natm, nocc, nvir, 8),
                   library=lambda: torch.einsum("Arq,Arq->rq", go, qg))
            del go, qg, buf
        la = dev(np.arange(o_all.size))
        r = {"kernel": k4.NAME, "shape": "ttm_stda_diagonal", "spin": spin, "dtype": "float64",
             "mode": "diagonal", "natm": natm, "nocc": nocc, "nvir": nvir, "nrow": o_all.size,
             "rtol": F64_RTOL, "fixed_order": True,
             "kernel_ms": device_ms(lambda: k4.j_diagonal(gt, qv, la)),
             "call_ms": time_ms(lambda: k4.j_diagonal(gt, qv, dev(np.arange(o_all.size))))}
        od = torch.as_tensor(o_all, device="cuda")
        vd = torch.as_tensor(v_all, device="cuda")
        gd, qd = gt[:, od, od], qv[:, vd, vd]
        _check(checks, r, lambda: k4.j_diagonal(gt, qv, la),
               lambda: k4.j_diagonal_plain(gt, qv, la), True,
               fl.stda_j_flops(o_all.size, 1, natm),
               fl.stda_j_bytes(o_all.size, 1, natm, nocc, nvir, 8, diagonal=True),
               library=lambda: torch.einsum("Ap,Ap->p", gd, qd))
        del gt, qv, gd, qd
    torch.cuda.empty_cache()


def phase2() -> dict:
    """Each kernel against its plain version, f64 and f32, TTM and bench
    shapes, both spin blocks (times and bounds at the alpha block); K2 and
    K3 on one chunk and on the span of one jvp group; the spin-flip modes at
    the flip shapes; K1 at its edge cases."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
    from xtddft_tpu_torch.response import flops as fl

    g = torch.Generator("cuda").manual_seed(1234)
    checks = []
    gc = 4096
    ch2o_table = _ch2o_table()
    for dtype in (torch.float64, torch.float32):
        tol = F64_RTOL if dtype == torch.float64 else F32_RTOL
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        for label, nz, naux, nmo, blocks, nspan, dtypes in MAIN_SHAPES:
            if dtype not in dtypes:
                continue
            G = torch.randn((naux, nmo, 8), generator=g, device="cuda", dtype=dtype)
            B = torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5
            del G
            span = nspan * gc
            # grid points as the sigma sees them: strided views of a padded table
            phi_all = torch.randn((4, gc + span, nmo), generator=g, device="cuda",
                                  dtype=dtype) / nmo ** 0.5
            phi = phi_all[:, gc:2 * gc]
            phi_span = phi_all[:, gc:gc + span]
            mask_span = (torch.rand(span, generator=g, device="cuda") > 0.05).to(dtype)
            for spin, (no, nv) in zip("ab", blocks):
                z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
                dwv = torch.randn((nz, span), generator=g, device="cuda", dtype=dtype)
                dwg = torch.randn((nz, 3, span), generator=g, device="cuda", dtype=dtype)
                out = torch.zeros((nz, no, nv), device="cuda", dtype=dtype)
                timed = spin == "a"

                def rec(name, **kw):
                    return {"kernel": name, "shape": label, "spin": spin, "dtype": dname,
                            "nz": nz, "naux": naux, "nmo": nmo, "nocc": no, "nvir": nv,
                            "rtol": tol, "fixed_order": False, **kw}

                # K1 sums in its fixed order on every path; K2 and K3 in the
                # sigma's order (atomics), their fixed-order twins timed beside
                _check(checks, rec(k1.NAME, fixed_order=True),
                       lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, z, 0, no)]),
                       lambda: torch.cat([x.flatten() for x in
                                          k1.df_exchange_plain(B, z, 0, no)]),
                       timed, fl.df_exchange_flops(naux, nz, no, nv),
                       fl.df_exchange_bytes(naux, nz, no, nv, isz))
                if spin in RPA_SPINS.get(label, ""):
                    _rpa_check(checks, rec, B, no, nv, g)
                M = _k2_selection(dtype)
                for pts, ph in ((gc, phi), (span, phi_span)):
                    mk = mask_span[:pts]
                    _check(checks, rec(k2.NAME, gc=pts),
                           lambda: k2.grid_rho1(ph, z, 0, no, mk),
                           lambda: k2.grid_rho1_plain(ph, z, 0, no, mk),
                           timed, fl.grid_rho1_flops(nz, no, nv, pts),
                           fl.grid_rho1_bytes(nz, no, nv, pts, isz),
                           library=(lambda: torch.einsum("cde,dgo,xov,egv,g->xcg", M,
                                                         ph[:, :, :no], z,
                                                         ph[:, :, no:no + nv], mk))
                           if timed else None,
                           twin=(lambda: k2.grid_rho1(ph, z, 0, no, mk, fixed_order=True))
                           if timed else None)
                one_chunk = (gc, phi, dwv[:, :gc].contiguous(), dwg[..., :gc].contiguous())
                for pts, ph, dv, dg in (one_chunk, (span, phi_span, dwv, dwg)):
                    W = _k3_weights(dv, dg) if timed else None
                    _check(checks, rec(k3.NAME, gc=pts),
                           lambda: k3.grid_back(dv, dg, ph, 0, no, out.zero_()).clone(),
                           lambda: k3.grid_back_plain(dv, dg, ph, 0, no, out.zero_()).clone(),
                           timed, fl.grid_back_flops(nz, no, nv, pts),
                           fl.grid_back_bytes(nz, no, nv, pts, isz),
                           library=(lambda: torch.einsum("cgo,xcdg,dgv->xov", ph[:, :, :no], W,
                                                         ph[:, :, no:no + nv]))
                           if timed else None,
                           twin=(lambda: k3.grid_back(dv, dg, ph, 0, no, out.zero_(),
                                                      fixed_order=True).clone())
                           if timed else None)
                    del W
                if label == "ttm" and timed:
                    # the meta-GGA modes on the jvp group's span, as the
                    # TPSSh X-TDA sigma launches them: K2 with its tau row
                    # (library: the tau row alone), K3 with its tau term
                    dwt = torch.randn((nz, span), generator=g, device="cuda", dtype=dtype)
                    pa, pb = phi_span[1:4, :, :no], phi_span[1:4, :, no:no + nv]
                    _check(checks, rec(k2.NAME, gc=span, mode="tau", rtol=AO_RTOL[dname]),
                           lambda: k2.grid_rho1(phi_span, z, 0, no, mask_span, ncomp=5),
                           lambda: k2.grid_rho1_plain(phi_span, z, 0, no, mask_span, ncomp=5),
                           True, fl.grid_rho1_flops(nz, no, nv, span, 5),
                           fl.grid_rho1_bytes(nz, no, nv, span, isz, 5),
                           library=lambda: _tau_row(pa, z, pb, mask_span),
                           library_of=lambda w: w[:, 4],
                           twin=lambda: k2.grid_rho1(phi_span, z, 0, no, mask_span, ncomp=5,
                                                     fixed_order=True))
                    W = _k3_weights(dwv, dwg, dwt)
                    _check(checks, rec(k3.NAME, gc=span, mode="tau", rtol=AO_RTOL[dname]),
                           lambda: k3.grid_back(dwv, dwg, phi_span, 0, no, out.zero_(),
                                                dwt=dwt).clone(),
                           lambda: k3.grid_back_plain(dwv, dwg, phi_span, 0, no, out.zero_(),
                                                      dwt=dwt).clone(),
                           True, fl.grid_back_flops(nz, no, nv, span, 5),
                           fl.grid_back_bytes(nz, no, nv, span, isz, 5),
                           library=lambda: torch.einsum("cgo,xcdg,dgv->xov",
                                                        phi_span[:, :, :no], W,
                                                        phi_span[:, :, no:no + nv]),
                           twin=lambda: k3.grid_back(dwv, dwg, phi_span, 0, no, out.zero_(),
                                                     fixed_order=True, dwt=dwt).clone())
                    del W, dwt, pa, pb
            del B, phi_all, phi, phi_span, mask_span
            torch.cuda.empty_cache()
        for label, nz, naux, nmo, n_o, v0, n_v, npts, two in FLIP_SHAPES:
            def sym_b():
                G = torch.randn((naux, nmo, 8), generator=g, device="cuda", dtype=dtype)
                return torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5

            def table():
                return torch.randn((4, npts, nmo), generator=g, device="cuda",
                                   dtype=dtype) / nmo ** 0.5

            B, Bv = sym_b(), (sym_b() if two else None)
            z = torch.randn((nz, n_o, n_v), generator=g, device="cuda", dtype=dtype)
            o, v = slice(0, n_o), slice(v0, v0 + n_v)

            def rec(name, mode):
                return {"kernel": name, "shape": label, "mode": mode, "dtype": dname, "nz": nz,
                        "naux": naux, "nmo": nmo, "nocc": n_o, "v0": v0, "nvir": n_v,
                        "two_tables": two, "rtol": tol}

            _check(checks, {**rec(k1.NAME, "exchange_only"), "fixed_order": True},
                   lambda: k1.df_exchange(B, z, 0, v0, B_vir=Bv, with_t=False)[1],
                   lambda: k1.df_exchange_plain(B, z, 0, v0, B_vir=Bv, with_t=False)[1],
                   True, fl.df_exchange_flops(naux, nz, n_o, n_v, with_t=False),
                   fl.df_exchange_bytes(naux, nz, n_o, n_v, isz, with_t=False),
                   # operands in the order of the cheap pairwise path
                   library=lambda: torch.einsum("Pab,xjb,Pji->xia",
                                                (B if Bv is None else Bv)[:, v, v], z,
                                                B[:, o, o]))
            del B, Bv
            phi, phi_v = table(), (table() if two else None)
            wv = torch.randn((nz, 4, npts), generator=g, device="cuda", dtype=dtype)
            dwv, dwg = wv[:, 0].contiguous(), wv[:, 1:4].contiguous()
            del wv
            out = torch.zeros((nz, n_o, n_v), device="cuda", dtype=dtype)
            pv = phi if phi_v is None else phi_v
            # the value-only modes are one three-operand einsum each; K3's
            # four-component mode one over its per-point weights
            W, M4 = _k3_weights(dwv, dwg), _k2_selection(dtype)
            libs = {1: (lambda: torch.einsum("xov,gv,go->xg", z, pv[0][:, v],
                                             phi[0][:, o])[:, None],
                        lambda: torch.einsum("xg,go,gv->xov", dwv, phi[0][:, o], pv[0][:, v])),
                    4: (lambda: torch.einsum("cde,dgo,xov,egv->xcg", M4, phi[:, :, o], z,
                                             pv[:, :, v]),
                        lambda: torch.einsum("cgo,xcdg,dgv->xov", phi[:, :, o], W,
                                             pv[:, :, v]))}
            for ncomp, mode in ((1, "value_only"), (4, "four_component")):
                dg = dwg if ncomp == 4 else None
                lib2, lib3 = libs[ncomp]
                _check(checks, {**rec(k2.NAME, mode), "gc": npts},
                       lambda: k2.grid_rho1(phi, z, 0, v0, None, phi_v=phi_v, ncomp=ncomp),
                       lambda: k2.grid_rho1_plain(phi, z, 0, v0, None, phi_v=phi_v,
                                                  ncomp=ncomp),
                       True, fl.grid_rho1_flops(nz, n_o, n_v, npts, ncomp),
                       fl.grid_rho1_bytes(nz, n_o, n_v, npts, isz, ncomp, masked=False),
                       library=lib2)
                _check(checks, {**rec(k3.NAME, mode), "gc": npts},
                       lambda: k3.grid_back(dwv, dg, phi, 0, v0, out.zero_(),
                                            phi_v=phi_v).clone(),
                       lambda: k3.grid_back_plain(dwv, dg, phi, 0, v0, out.zero_(),
                                                  phi_v=phi_v).clone(),
                       True, fl.grid_back_flops(nz, n_o, n_v, npts, ncomp),
                       fl.grid_back_bytes(nz, n_o, n_v, npts, isz, ncomp), library=lib3)
            if label == "ttm_down":
                # the multicollinear kernel of a meta-GGA: five components
                del W
                dwt = torch.randn((nz, npts), generator=g, device="cuda", dtype=dtype)
                W = _k3_weights(dwv, dwg, dwt)
                tau = {**rec(k2.NAME, "five_component"), "gc": npts, "rtol": AO_RTOL[dname]}
                _check(checks, tau,
                       lambda: k2.grid_rho1(phi, z, 0, v0, None, phi_v=phi_v, ncomp=5),
                       lambda: k2.grid_rho1_plain(phi, z, 0, v0, None, phi_v=phi_v, ncomp=5),
                       True, fl.grid_rho1_flops(nz, n_o, n_v, npts, 5),
                       fl.grid_rho1_bytes(nz, n_o, n_v, npts, isz, 5, masked=False),
                       library=lambda: _tau_row(phi[1:4][:, :, o], z, pv[1:4][:, :, v]),
                       library_of=lambda w: w[:, 4])
                _check(checks, {**rec(k3.NAME, "five_component"), "gc": npts,
                                "rtol": AO_RTOL[dname]},
                       lambda: k3.grid_back(dwv, dwg, phi, 0, v0, out.zero_(), phi_v=phi_v,
                                            dwt=dwt).clone(),
                       lambda: k3.grid_back_plain(dwv, dwg, phi, 0, v0, out.zero_(),
                                                  phi_v=phi_v, dwt=dwt).clone(),
                       True, fl.grid_back_flops(nz, n_o, n_v, npts, 5),
                       fl.grid_back_bytes(nz, n_o, n_v, npts, isz, 5),
                       library=lambda: torch.einsum("cgo,xcdg,dgv->xov", phi[:, :, o], W,
                                                    pv[:, :, v]))
                del dwt
            del phi, phi_v, pv, dwv, dwg, out, libs, W, M4
            torch.cuda.empty_cache()
        for shape in AO_SHAPES:
            if dtype in shape[-1]:
                _ao_checks(checks, g, dtype, *shape[:-1])
        for shape in SMALL_AO_SHAPES:
            _ao_checks(checks, g, dtype, *shape,
                       table=ch2o_table if shape[0] == "ch2o_sigma" else None)
        for label, nz, naux, nmo, no, nv in K1_EDGES:
            B = torch.randn((naux, nmo, nmo), generator=g, device="cuda", dtype=dtype)
            z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
            # o and v blocks at offsets, as the beta block of a sigma reads them
            o0, v0 = nmo - no - nv, nmo - nv
            _check(checks, {"kernel": k1.NAME, "shape": label, "spin": "a", "dtype": dname,
                            "nz": nz, "naux": naux, "nmo": nmo, "nocc": no, "nvir": nv,
                            "rtol": tol, "fixed_order": True},
                   lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, z, o0, v0)]),
                   lambda: torch.cat([x.flatten() for x in k1.df_exchange_plain(B, z, o0, v0)]),
                   False)
    del ch2o_table
    torch.cuda.empty_cache()
    _stda_checks(checks, g)
    _k5_check(checks)
    return {"checks": checks}


# the SCF's AO modes: (label, nao, naux, grid points, dtypes), two density
# matrices; TTM/STO-3G and TTM/dzp
AO_SHAPES = (("ttm_ao", 182, 4412, 187644, BOTH), ("dzp_ao", 598, 3990, 187644, F64_ONLY))
# phase 9's AO modes, K2 hermitian and K3 alone (label, nao, naux None,
# grid points, nz, transition matrices): the in-core sigma's stack on
# CH2O+/cc-pVDZ at grid 3 (its X-TDA block of 5 vectors, alpha and beta:
# non-symmetric matrices, symmetrized for K2; on the molecule's own AO table
# and K2 mask, `_ch2o_table`), and the SCF's pair on benzene/cc-pVDZ at grid
# 3 (294,480 points), the largest in-core size, whole grid in one launch
SMALL_AO_SHAPES = (("ch2o_sigma", 38, None, 100738, 10, True),
                   ("benzene_scf", 114, None, 294480, 2, False))
# the shapes whose AO modes also run with the meta-GGA tau row and term: the
# TTM SCF's and the in-core sigma's stack on CH2O+
TAU_AO_SHAPES = ("ttm_ao", "ch2o_sigma")
# the JAX functions each kernel computes in the SCF's Fock build
SCF_REPLACES = {"df_exchange": "xtddft_tpu/scf/env.py:244",
                "grid_rho1": "xtddft_tpu/xc/interface.py:53",
                "grid_back": "xtddft_tpu/xc/interface.py:112"}


def _ch2o_table():
    """CH2O+/cc-pVDZ at grid 3 as phase 9 builds it: the AO table (f64), and
    as 0/1 the `_sanitize` mask of its core-Hamiltonian guess density, the
    kind of mask that `fxc_v1mat` hands K2."""
    from xtddft_tpu_torch.chem import Molecule, geometries as G
    from xtddft_tpu_torch.scf.env import Env
    from xtddft_tpu_torch.xc.interface import _sanitize, cache_rho

    mol = Molecule.from_atoms(G.ch2o_vacuum, basis="cc-pvdz", charge=1, spin=1)
    env = Env(mol, grid_level=3, device="cuda", dtype=torch.float64)
    s, U = torch.linalg.eigh(env.S)
    X = U * s.rsqrt()
    C = X @ torch.linalg.eigh(X.T @ env.hcore @ X)[1]
    r, gr = cache_rho(env.ao, torch.stack([C[:, :n] @ C[:, :n].T
                                           for n in (mol.nalpha, mol.nbeta)]))
    mask = _sanitize(env.grid_weights, (r[0], r[1], gr[0], gr[1]))[2]
    return env.ao, mask.to(torch.float64)


def _ao_checks(checks, g, dtype, label, nao, naux, npts, nz=2, nonsym=False, table=None):
    """The SCF's Fock build on the kernels, in their fixed summation order
    as the SCF runs them, K2 and K3 each beside its atomic order: K1 in AO mode (t
    and K of two density matrices; timed and held against the single
    einsum on K, and checked untimed on (t, K); skipped when ``naux`` is
    None), K2 hermitian (four rows, and the value row alone, each against
    its single einsum), K3 with the AO table on both sides (against the
    single einsum over its per-point weights).  ``nonsym``: nz
    non-symmetric transition matrices, symmetrized as the in-core
    response symmetrizes them.  ``table``: (AO table, K2 mask) of a
    molecule, in place of a random table; then also the in-core sigma's
    own modes in its atomic order, each beside its fixed-order twin: K2
    masked (`fxc_v1mat`) and K3's value term on the AO table
    (`sf_v1mat`)."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
    from xtddft_tpu_torch.response import flops as fl

    from xtddft_tpu_torch.xc.interface import symmetrize

    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    if nonsym:
        dms = symmetrize(torch.randn((nz, nao, nao), generator=g, device="cuda",
                                     dtype=dtype) / nao)
    else:
        c = torch.randn((nz, nao, 60), generator=g, device="cuda", dtype=dtype) / 60 ** 0.5
        dms = c @ c.transpose(1, 2)  # symmetric, one per spin
        del c

    def rec(name, mode, **kw):
        return {"kernel": name, "shape": label, "mode": mode, "dtype": dname, "nz": nz,
                "nao": nao, "naux": naux, "rtol": AO_RTOL[dname], "fixed_order": True, **kw}

    if naux is not None:
        G = torch.randn((naux, nao, 8), generator=g, device="cuda", dtype=dtype)
        B = torch.bmm(G, G.transpose(1, 2)) / (naux * nao * 8) ** 0.5
        del G
        _check(checks, rec(k1.NAME, "ao"), lambda: k1.df_exchange(B, dms, 0, 0)[1],
               lambda: k1.df_exchange_plain(B, dms, 0, 0)[1], True,
               fl.df_exchange_flops(naux, nz, nao, nao),
               fl.df_exchange_bytes(naux, nz, nao, nao, isz),
               library=lambda: torch.einsum("Pmr,xrs,Psn->xmn", B, dms, B))
        _check(checks, rec(k1.NAME, "ao_with_t"),
               lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, dms, 0, 0)]),
               lambda: torch.cat([x.flatten() for x in k1.df_exchange_plain(B, dms, 0, 0)]),
               False)
        del B
        torch.cuda.empty_cache()
    if table is None:
        ao = torch.randn((4, npts, nao), generator=g, device="cuda", dtype=dtype) / nao ** 0.5
        mask = None
    else:
        ao, mask = (t.to(dtype) for t in table)
        assert ao.shape == (4, npts, nao), ao.shape
    wv = torch.randn((nz, 4, npts), generator=g, device="cuda", dtype=dtype)
    dwv, dwg = wv[:, 0].contiguous(), wv[:, 1:4].contiguous()
    del wv
    nbytes = fl.grid_ao_bytes(nz, nao, npts, isz)
    # for a symmetric D the gradient rows are 2 sum grad(phi) D phi
    rows = torch.tensor([1.0, 2.0, 2.0, 2.0], device="cuda", dtype=dtype)
    _check(checks, rec(k2.NAME, "hermi", gc=npts),
           lambda: k2.grid_rho1(ao, dms, 0, 0, hermi=True, fixed_order=True),
           lambda: k2.grid_rho1_plain(ao, dms, 0, 0, hermi=True), True,
           fl.grid_ao_flops(nz, nao, npts), nbytes,
           library=lambda: torch.einsum("c,cgi,xij,gj->xcg", rows, ao, dms, ao[0]),
           twin=lambda: k2.grid_rho1(ao, dms, 0, 0, hermi=True))
    _check(checks, rec(k2.NAME, "hermi_value_only", gc=npts),
           lambda: k2.grid_rho1(ao, dms, 0, 0, ncomp=1, hermi=True, fixed_order=True),
           lambda: k2.grid_rho1_plain(ao, dms, 0, 0, ncomp=1, hermi=True), True,
           fl.grid_rho1_flops(nz, nao, nao, npts, 1),
           fl.grid_rho1_bytes(nz, nao, nao, npts, isz, 1, masked=False),
           library=lambda: torch.einsum("gi,xij,gj->xg", ao[0], dms, ao[0])[:, None],
           twin=lambda: k2.grid_rho1(ao, dms, 0, 0, ncomp=1, hermi=True))
    out = torch.zeros((nz, nao, nao), device="cuda", dtype=dtype)
    W = _k3_weights(dwv, dwg)
    _check(checks, rec(k3.NAME, "ao", gc=npts),
           lambda: k3.grid_back(dwv, dwg, ao, 0, 0, out.zero_(), fixed_order=True).clone(),
           lambda: k3.grid_back_plain(dwv, dwg, ao, 0, 0, out.zero_()).clone(), True,
           fl.grid_ao_flops(nz, nao, npts), nbytes,
           library=lambda: torch.einsum("cgi,xcdg,dgj->xij", ao, W, ao),
           twin=lambda: k3.grid_back(dwv, dwg, ao, 0, 0, out.zero_()).clone())
    if label in TAU_AO_SHAPES:
        # the meta-GGA modes: the SCF's (fixed order, the atomic order beside)
        # or, on a molecule's table with its mask, the in-core sigma's
        # (`fxc_v1mat` with a 6-tuple: atomic, the fixed order beside)
        dwt = torch.randn((nz, npts), generator=g, device="cuda", dtype=dtype)
        Wt = _k3_weights(dwv, dwg, dwt)
        fixed = mask is None
        _check(checks, rec(k2.NAME, "hermi_tau", gc=npts, fixed_order=fixed),
               lambda: k2.grid_rho1(ao, dms, 0, 0, mask, ncomp=5, hermi=True, fixed_order=fixed),
               lambda: k2.grid_rho1_plain(ao, dms, 0, 0, mask, ncomp=5, hermi=True), True,
               fl.grid_ao_flops(nz, nao, npts, tau=True),
               fl.grid_ao_bytes(nz, nao, npts, isz, 5, masked=not fixed),
               library=lambda: _tau_row(ao[1:4], dms, ao[1:4], mask),
               library_of=lambda w: w[:, 4],
               twin=lambda: k2.grid_rho1(ao, dms, 0, 0, mask, ncomp=5, hermi=True,
                                         fixed_order=not fixed))
        _check(checks, rec(k3.NAME, "ao_tau", gc=npts, fixed_order=fixed),
               lambda: k3.grid_back(dwv, dwg, ao, 0, 0, out.zero_(), fixed_order=fixed,
                                    dwt=dwt).clone(),
               lambda: k3.grid_back_plain(dwv, dwg, ao, 0, 0, out.zero_(), dwt=dwt).clone(),
               True, fl.grid_ao_flops(nz, nao, npts, tau=True),
               fl.grid_ao_bytes(nz, nao, npts, isz, 5),
               library=lambda: torch.einsum("cgi,xcdg,dgj->xij", ao, Wt, ao),
               twin=lambda: k3.grid_back(dwv, dwg, ao, 0, 0, out.zero_(), fixed_order=not fixed,
                                         dwt=dwt).clone())
        del dwt, Wt
    if mask is not None:
        _check(checks, rec(k2.NAME, "hermi_masked", gc=npts, fixed_order=False,
                           masked_share=float(1.0 - mask.mean())),
               lambda: k2.grid_rho1(ao, dms, 0, 0, mask, hermi=True),
               lambda: k2.grid_rho1_plain(ao, dms, 0, 0, mask, hermi=True), True,
               fl.grid_ao_flops(nz, nao, npts), fl.grid_ao_bytes(nz, nao, npts, isz, masked=True),
               library=lambda: torch.einsum("c,cgi,xij,gj,g->xcg", rows, ao, dms, ao[0], mask),
               twin=lambda: k2.grid_rho1(ao, dms, 0, 0, mask, hermi=True, fixed_order=True))
        _check(checks, rec(k3.NAME, "ao_value_only", gc=npts, fixed_order=False),
               lambda: k3.grid_back(dwv, None, ao, 0, 0, out.zero_()).clone(),
               lambda: k3.grid_back_plain(dwv, None, ao, 0, 0, out.zero_()).clone(), True,
               fl.grid_ao_value_flops(nz, nao, npts), fl.grid_ao_bytes(nz, nao, npts, isz, 1),
               library=lambda: torch.einsum("xg,gi,gj->xij", dwv, ao[0], ao[0]),
               twin=lambda: k3.grid_back(dwv, None, ao, 0, 0, out.zero_(),
                                         fixed_order=True).clone())
    del ao, mask, dwv, dwg, out, dms, W
    torch.cuda.empty_cache()


def _first_fxc_jvp():
    """The first torch.func transform of a process loads its decompositions
    and imports (~10 s); pay that in the set-up, not in the timed solve."""
    from xtddft_tpu_torch.xc import interface, registry

    respond = interface.make_fxc_jvp(registry.resolve("b3lyp"))
    r = torch.ones(8, device="cuda", dtype=torch.float64)
    g = torch.zeros((3, 8), device="cuda", dtype=torch.float64)
    torch.func.vmap(lambda d: respond(r, (r, r, g, g), d))((r[None], r[None], g[None], g[None]))


def phase3():
    """The main path: TTM X-TDA, f64, through the public entry point.
    Returns (record, the Reference) for the flip leg to reuse."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.scf.checkpoint import load_mf

    golden = json.loads((ROOT / "tests/data/golden_ttm.json").read_text())
    e_ref = np.asarray(golden["xtda_e_ev"])
    t = {}
    t0 = time.perf_counter()
    mf = load_mf(str(ROOT / "tests/data/ttm_ckpt.npz"), df=True, device="cuda",
                 dtype=torch.float64)
    env = mf.env
    steps = (
        ("grid", lambda: env.grid),
        ("eval_ao", lambda: env.ao),
        ("j3c", env.df_j3c_host),
        ("metric", env.df_isqrt_host),
        ("one_electron_props", lambda: (env.dip, env.ipovlp, env.rxp)),
        ("make_reference", lambda: make_reference(mf)),
        ("torch_func_first_use", _first_fxc_jvp),
    )
    for name, step in steps:
        s = time.perf_counter()
        out = step()
        _sync()
        t[name] = time.perf_counter() - s
        if name == "make_reference":
            ref = out
    t["host_setup"] = time.perf_counter() - t0
    dims = {"nao": env.nao, "naux": env.aux_layout.nao, "ngrid": int(env.grid.size),
            "nc": ref.nc, "no": ref.no, "nv": ref.nv}
    _log("phase 3 setup", json.dumps({**dims, **t}))

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    res = XTDA(ref, nstates=10, backend="df").kernel()
    _sync()
    t["solve"] = time.perf_counter() - s
    launches = _df_launch_counts()
    dev = float(np.abs(res.e_eV - e_ref[: len(res.e_eV)]).max())
    rec = {**dims, **t, "launches": launches, "cycles": res.cycles,
           "nroots": len(res.e), "converged": res.converged, "max_dev_ev": dev,
           "e_ev": res.e_eV.tolist(), "osc": res.osc.tolist(), "ds2": res.ds2.tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    _log("phase 3 solve", json.dumps(rec))
    if not (res.converged and len(res.e) == 10):
        raise AssertionError(f"TTM X-TDA: not 10/10 roots converged: {rec}")
    if not dev < TTM_GATE_EV:
        raise AssertionError(f"TTM X-TDA deviates from golden_ttm.json by {dev} eV")
    if not (np.all(res.osc >= -1e-12) and np.all(np.isfinite(res.ds2))):
        raise AssertionError(f"TTM X-TDA: negative osc or non-finite ds2: {rec}")
    idle = [k for k, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return rec, ref


def phase7(mf0, e_phase3, k3_ms) -> dict:
    """The SCF of the port on the Env of phase 3's mean field ``mf0`` (the
    checkpoint's), f64, from the GWH guess, then X-TDA on its mean field;
    both through the public entry points.  Also the energy of the
    checkpoint's own density by the port's Fock build, which tells a
    difference of densities from one of the energy expression.
    ``k3_ms``: phase 2's time of K3 in AO mode, f64, which the ``xc``
    stage (the functional and K3) holds once a cycle."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule, geometries
    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.response.flops import scf_veff_flops
    from xtddft_tpu_torch.scf import ROKS

    golden = json.loads((ROOT / "tests/data/golden_ttm.json").read_text())
    ckpt = np.load(ROOT / "tests/data/ttm_ckpt.npz")
    env = mf0.env
    mol = Molecule.from_atoms(geometries.ttm_vacuum, basis="sto-3g", spin=1)
    if mol != env.mol:
        raise AssertionError("ttm_vacuum is not the molecule of tests/data/ttm_ckpt.npz")
    scf = ROKS(mol, xc="b3lyp", grid_level=1, df=True, env=env)
    kernels.reset_launch_counts()
    s = time.perf_counter()
    mf = scf.kernel()
    _sync()
    wall = time.perf_counter() - s
    launches = _df_launch_counts()
    occ = np.asarray(ckpt["mo_occ"]) > 0
    d_e = mf.e_tot - float(ckpt["e_tot"])
    d_eps = float(np.abs(mf.mo_energy[occ] - np.asarray(ckpt["mo_energy"])[occ]).max())
    n = scf.cycles
    # the same SCF again, the device synchronized at each stage of a Fock
    # build, for the split of a cycle; the Fock build sums in a fixed order,
    # so it must take the same cycles to the bitwise-same energy (at 4814 Ha
    # the energy test of 1e-11 Ha sits at the rounding of those sums)
    scf.profile = True
    s = time.perf_counter()
    mf_prof = scf.kernel()
    _sync()
    wall_profiled = time.perf_counter() - s
    n_prof = scf.cycles
    stages = dict(scf.stage_seconds)
    k3_s = k3_ms / 1e3 * n_prof
    fl = scf_veff_flops(env.aux_layout.nao, env.nao, int(env.grid.size))
    d0 = mf0.make_rdm1()
    e2 = scf._veff_and_exc(d0[0], d0[1])[2]
    e_of_ckpt_density = (float(np.einsum("pq,qp->", env.hcore.cpu().numpy(), d0[0] + d0[1]))
                         + e2 + mol.energy_nuc())
    rec = {"cycles": n, "converged": mf.converged, "scf_s": wall, "s_per_cycle": wall / n,
           "scf_profiled_s": wall_profiled, "cycles_profiled": n_prof,
           "e_tot_profiled_minus_e_tot_ha": mf_prof.e_tot - mf.e_tot,
           "stage_s_per_cycle": {k: v / n_prof for k, v in stages.items()},
           "functional_s_per_cycle": (stages["xc"] - k3_s) / n_prof,
           "k3_s_per_cycle": k3_s / n_prof,
           "launches": launches, "launches_per_cycle": {k: v / n for k, v in launches.items()},
           "e_tot": mf.e_tot, "de_vs_ckpt_ha": d_e,
           "de_vs_golden_e_scf_ha": mf.e_tot - float(golden["e_scf"]),
           "max_deps_occ_ha": d_eps, "flops_per_cycle": fl["total"],
           "kernel_tflops": fl["total"] / (stages["jk"] + stages["rho"] + k3_s)
                            * n_prof / 1e12,
           "e_of_ckpt_density_minus_ckpt_e_tot_ha": e_of_ckpt_density - float(ckpt["e_tot"]),
           "e_tot_minus_e_of_ckpt_density_ha": mf.e_tot - e_of_ckpt_density}
    _log("phase 7 scf", json.dumps(rec))
    if not mf.converged:
        raise AssertionError(f"TTM SCF did not converge: {rec}")
    if not abs(d_e) <= SCF_GATE_HA:
        raise AssertionError(f"TTM SCF energy off the checkpoint's by {d_e} Ha")
    if not d_eps <= SCF_GATE_EPS_HA:
        raise AssertionError(f"TTM SCF occupied orbital energies off by {d_eps} Ha")
    short = [k for k, v in launches.items() if v < n]
    if short:
        raise AssertionError(f"kernels not launched on every Fock build: {short} {launches}")
    if not (n_prof == n and mf_prof.e_tot == mf.e_tot):
        raise AssertionError(f"a second SCF on the same input took {n_prof} cycles to "
                             f"{mf_prof.e_tot!r} Ha, the first {n} to {mf.e_tot!r} Ha")

    e_ref = np.asarray(golden["xtda_e_ev"])
    kernels.reset_launch_counts()
    s = time.perf_counter()
    res = XTDA(mf, nstates=10, backend="df").kernel()
    _sync()
    xt = {"solve_s": time.perf_counter() - s, "launches": _df_launch_counts(),
          "cycles": res.cycles, "nroots": len(res.e), "converged": res.converged,
          "max_dev_ev": float(np.abs(res.e_eV - e_ref[: len(res.e_eV)]).max()),
          "max_dev_vs_phase3_ev": float(np.abs(res.e_eV - np.asarray(e_phase3)).max()),
          "e_ev": res.e_eV.tolist()}
    _log("phase 7 xtda", json.dumps(xt))
    if not (res.converged and len(res.e) == 10):
        raise AssertionError(f"X-TDA on the port's SCF: not 10/10 roots converged: {xt}")
    if not xt["max_dev_ev"] < TTM_GATE_EV:
        raise AssertionError(f"X-TDA on the port's SCF deviates from golden_ttm.json: {xt}")
    idle = [k for k, v in xt["launches"].items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the SCF's X-TDA: {idle}")
    rec["xtda"] = xt
    return rec


# phase 10: the functionals at TTM's full width, against the JAX package's
# goldens (`tools/ttm_functional_golden.py`): (xc, XSF-TDA method)
FUNCTIONAL_LEGS = (("tpssh", 1), ("camb3lyp", 0))
FUNCTIONAL_GATE_EV = 1e-4
FUNCTIONAL_GATE_DS2 = 1e-3


def _functional_solve(name, run, want_ev, want_ds2=None, nroots: int = 10) -> dict:
    """One response solve of phase 10: wall, cycles, launches (and those of
    the modes counted apart) and the gates against the golden; with no
    golden roots (``want_ev`` None) the roots and <dS^2> are printed, and
    only convergence and the launches gated."""
    from xtddft_tpu_torch import kernels

    kernels.reset_launch_counts()
    s = time.perf_counter()
    res = run()
    _sync()
    r = {"solve_s": time.perf_counter() - s, "cycles": res.cycles, "nroots": len(res.e),
         "converged": res.converged, "solver": res.solver,
         "launches": _df_launch_counts(), "mode_launches": kernels.mode_launch_counts()}
    r["k1_launches_per_cycle"] = r["launches"]["df_exchange"] / max(res.cycles, 1)
    order = np.argsort(res.e_eV)
    e = res.e_eV[order]
    r["e_ev"] = e.tolist()
    if res.ds2 is not None:
        r["ds2"] = np.asarray(res.ds2)[order].tolist()
    failed = []
    if want_ev is not None:
        nroots = len(want_ev)
        r["max_dev_ev"] = float(np.abs(e - np.sort(np.asarray(want_ev))[:len(e)]).max())
        if not r["max_dev_ev"] <= FUNCTIONAL_GATE_EV:
            failed.append(f"roots off the golden by {r['max_dev_ev']} eV")
    if want_ds2 is not None:
        want2 = np.asarray(want_ds2)[np.argsort(want_ev)][:len(e)]
        r["max_dev_ds2"] = float(np.abs(np.asarray(r["ds2"]) - want2).max())
        if not r["max_dev_ds2"] <= FUNCTIONAL_GATE_DS2:
            failed.append(f"<dS^2> off the golden by {r['max_dev_ds2']}")
    _log(f"phase 10 {name}", json.dumps(r))
    if not (res.converged and len(res.e) == nroots):
        failed.append(f"not {nroots}/{nroots} roots converged")
    idle = [k for k, n in r["launches"].items() if n <= 0]
    if idle:
        failed.append(f"kernels not launched: {idle}")
    if failed:
        raise AssertionError(f"phase 10 {name}: {failed}")
    return r


def phase10(env) -> dict:
    """The meta-GGA and range-separated functionals at TTM's full width (182
    AO, grid 1, density fitted, f64) on phase 3's Env: for TPSSh and for
    CAM-B3LYP (whose long-range exchange adds the erf-attenuated fit at
    omega = 0.33), ``ROKS(ttm_vacuum, xc, grid_level=1, df=True)`` from the
    orbitals of ``tests/data/ttm_ckpt.npz``, then ``XTDA(nstates=10)`` and
    ``XSFTDA(SA=0, nstates=10)`` (method 1, the multicollinear kernel, for
    TPSSh; 0 for CAM-B3LYP) on its mean field, each gated against the JAX
    package's golden of the same calls where it has one (the TPSSh flip leg
    has none: `golden_ttm_tpssh.json` says why; its roots and <dS^2> are
    printed, its convergence and launches gated).  TPSSh must launch K2's tau row and
    K3's tau term in every leg, CAM-B3LYP the exchange-only K1 pass of its
    long range; the multicollinear kernel at TTM's 187,644 points is timed
    on its own."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule, geometries
    from xtddft_tpu_torch.methods.drivers import XSFTDA, XTDA
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.response.sigma import _rho0
    from xtddft_tpu_torch.scf import ROKS
    from xtddft_tpu_torch.xc.mcol import sf_kernel_mcol

    ckpt = np.load(ROOT / "tests/data/ttm_ckpt.npz")
    mol = Molecule.from_atoms(geometries.ttm_vacuum, basis="sto-3g", spin=1)
    out = {}
    for xc, method in FUNCTIONAL_LEGS:
        golden = json.loads((ROOT / f"tests/data/golden_ttm_{xc}.json").read_text())
        if golden["xsf_method"] != method:
            raise AssertionError(f"golden_ttm_{xc}.json solved XSF-TDA method "
                                 f"{golden['xsf_method']}, not {method}")
        rec = {}
        if xc == "camb3lyp":
            s = time.perf_counter()
            env.df_B(0.33)
            _sync()
            rec["lr_fit_s"] = time.perf_counter() - s
        scf = ROKS(mol, xc=xc, grid_level=1, df=True, env=env)
        scf.profile = True
        kernels.reset_launch_counts()
        s = time.perf_counter()
        mf = scf.kernel(init=np.asarray(ckpt["mo_coeff"]))
        _sync()
        wall = time.perf_counter() - s
        n = scf.cycles
        occ = np.asarray(mf.mo_occ) > 0
        rec.update({
            "cycles": n, "converged": mf.converged, "scf_s": wall, "s_per_cycle": wall / n,
            "stage_s_per_cycle": {k: v / n for k, v in scf.stage_seconds.items()},
            "launches": _df_launch_counts(), "mode_launches": kernels.mode_launch_counts(),
            "e_tot": mf.e_tot, "de_vs_golden_ha": mf.e_tot - golden["e_scf"],
            "max_deps_occ_ha": float(np.abs(np.asarray(mf.mo_energy)[occ]
                                            - np.asarray(golden["mo_energy_occ"])).max())})
        rec["launches_per_cycle"] = {k: v / n for k, v in rec["launches"].items()}
        _log(f"phase 10 {xc} scf", json.dumps(rec))
        failed = []
        if not mf.converged:
            failed.append("the SCF did not converge")
        if not abs(rec["de_vs_golden_ha"]) <= SCF_GATE_HA:
            failed.append(f"e_tot off the golden by {rec['de_vs_golden_ha']} Ha")
        if not rec["max_deps_occ_ha"] <= SCF_GATE_EPS_HA:
            failed.append(f"occupied orbital energies off by {rec['max_deps_occ_ha']} Ha")
        short = [k for k, v in rec["launches"].items() if v < n]
        if short:
            failed.append(f"kernels not launched on every Fock build: {short}")
        if failed:
            raise AssertionError(f"phase 10 {xc} SCF: {failed}")
        ref = make_reference(mf)
        if xc == "tpssh":
            rho0 = _rho0(ref)
            s = time.perf_counter()
            sf_kernel_mcol(ref.spec, env.grid_weights, rho0)
            _sync()
            rec["sf_kernel_mcol_s"] = time.perf_counter() - s
            rec["ngrid"] = int(env.grid_weights.shape[0])
            del rho0
        rec["xtda"] = _functional_solve(f"{xc} xtda", lambda: XTDA(ref, nstates=10,
                                                                  backend="df").kernel(),
                                        golden["xtda_e_ev"])
        rec["xsf"] = _functional_solve(
            f"{xc} xsf", lambda: XSFTDA(ref, SA=0, method=method, nstates=10,
                                        backend="df").kernel(),
            golden["xsf_e_ev"], golden["xsf_ds2"])
        # the modes that the functional needs must have launched in every leg
        need = (("grid_rho1.tau", "grid_back.tau") if xc == "tpssh"
                else ("df_exchange.exchange_only",))
        for leg in (rec, rec["xtda"], rec["xsf"]):
            idle = [k for k in need if leg["mode_launches"][k] <= 0]
            if idle:
                raise AssertionError(f"phase 10 {xc}: modes not launched: {idle}")
        if xc == "camb3lyp" and not rec["xtda"]["mode_launches"]["df_exchange.exchange_only"] \
                == rec["xtda"]["launches"]["df_exchange"] // 2:
            raise AssertionError(f"phase 10 camb3lyp X-TDA: the long-range K1 pass is not one "
                                 f"of two K1 launches: {rec['xtda']['launches']}")
        out[xc] = rec
        del scf, mf, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


TDHF_GATE_EV = 1e-4  # TTM X-TDHF roots against golden_ttm_xtdhf.json
TDHF_GATE_OSC = 1e-4
TDHF_GATE_DS2 = 1e-3
TDHF_RESIDUAL = 1e-6  # the pencil's residuals, fresh f64 matvecs
STDA_GATE = 1e-6  # TTM sX-TDA roots (eV), osc and <dS^2> against golden_ttm_stda.json


def _pencil_residuals(ref, res) -> list:
    """max(|(A+B)(X+Y) - w(X-Y)|, |(A-B)(X-Y) - w(X+Y)|) of each X-TDHF root,
    from fresh f64 matvecs of a newly built paired operator on the driver's
    (blocked) vectors, put back in the operator's natural layout."""
    from xtddft_tpu_torch.response.sigma_df import build_df_data, xtda_sigma_df

    op = xtda_sigma_df(build_df_data(ref), spin_adapt=True, with_b=True)
    perm = op.to_blocked(np.arange(op.dim, dtype=np.float64)[:, None])[:, 0].astype(np.int64)
    xpy, xmy = np.empty_like(res.v), np.empty_like(res.v_xmy)
    xpy[perm], xmy[perm] = res.v, res.v_xmy
    w = torch.as_tensor(res.e, device=op.device)
    x, y = torch.as_tensor(xpy.T, device=op.device), torch.as_tensor(xmy.T, device=op.device)
    ap, bp = op.matvec(x)
    am, bm = op.matvec(y)
    rp = torch.linalg.norm(ap + bp - w[:, None] * y, dim=1)
    rm = torch.linalg.norm(am - bm - w[:, None] * x, dim=1)
    return torch.maximum(rp, rm).cpu().tolist()


def phase11(ref, xtda_e_ev) -> dict:
    """TDHF/RPA and sTDA at TTM's full width on phase 3's Reference (its Env,
    grid and fits): ``XTDHF(nstates=10, backend="df")``, f64, gated against
    ``tests/data/golden_ttm_xtdhf.json`` (converged, the stability re-check
    passed, roots within TDHF_GATE_EV, |osc| and <dS^2> within theirs, the
    pencil's residuals from fresh matvecs within TDHF_RESIDUAL, K1's RPA
    exchange launched in every pair build: one per spin beside the two
    exchange launches of the A half), with the Thouless comparison against
    phase 3's X-TDA roots printed; then ``STDA(nstates=10)`` (sX-TDA) gated
    against ``golden_ttm_stda.json``: the same active space and selected
    counts per block, roots, osc and <dS^2> within STDA_GATE, K4 launched."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.methods.drivers import XTDHF
    from xtddft_tpu_torch.stda import STDA

    out = {}
    gx = json.loads((ROOT / "tests/data/golden_ttm_xtdhf.json").read_text())
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    res = XTDHF(ref, nstates=10, backend="df").kernel()
    _sync()
    wall = time.perf_counter() - s
    launches, modes = kernels.launch_counts(), kernels.mode_launch_counts()
    n_rpa = modes["df_exchange.rpa_exchange"]
    e = res.e_eV
    rec = {"solve_s": wall, "cycles": res.cycles, "pair_builds": n_rpa // 2,
           "rpa_aligned_s": (res.setup_s or {}).get("rpa_aligned_s"),
           "solver": res.solver, "converged": res.converged, "launches": launches,
           "mode_launches": modes, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "e_ev": e.tolist(), "osc": res.osc.tolist(), "ds2": res.ds2.tolist(),
           "max_dev_ev": float(np.abs(e - np.asarray(gx["e_ev"])).max()),
           "max_dev_osc": float(np.abs(res.osc - np.asarray(gx["osc"])).max()),
           "max_dev_ds2": float(np.abs(res.ds2 - np.asarray(gx["ds2"])).max()),
           "thouless_rpa_minus_tda_ev": (e - np.asarray(xtda_e_ev)[:len(e)]).tolist()}
    rec["residuals"] = _pencil_residuals(ref, res)
    _log("phase 11 xtdhf", json.dumps(rec))
    _log(f"phase 11 xtdhf: {res.cycles} cycles, {rec['pair_builds']} pair builds, "
         f"{wall:.2f} s (of it the aligned ov copies' set-up {rec['rpa_aligned_s']} s); "
         f"RPA - X-TDA (Thouless, not gated) eV: "
         f"{np.round(rec['thouless_rpa_minus_tda_ev'], 5).tolist()}")
    failed = []
    if not (res.converged and len(e) == 10 and res.solver == "rpa-davidson+stabcheck"):
        failed.append(f"not 10/10 converged through the stability re-check ({res.solver})")
    for k, gate in (("max_dev_ev", TDHF_GATE_EV), ("max_dev_osc", TDHF_GATE_OSC),
                    ("max_dev_ds2", TDHF_GATE_DS2)):
        if not rec[k] <= gate:
            failed.append(f"{k} {rec[k]} above {gate}")
    if not max(rec["residuals"]) <= TDHF_RESIDUAL:
        failed.append(f"pencil residuals {max(rec['residuals'])} above {TDHF_RESIDUAL}")
    if rec["rpa_aligned_s"] is None:
        failed.append("the paired sigma made no aligned ov copies")
    if not (n_rpa > 0 and 2 * n_rpa == launches["df_exchange"]):
        failed.append(f"K1's RPA exchange not in every pair build: {n_rpa} of "
                      f"{launches['df_exchange']} K1 launches")
    idle = [k for k in ("grid_rho1", "grid_back") if launches[k] <= 0]
    if idle:
        failed.append(f"kernels not launched: {idle}")
    if failed:
        raise AssertionError(f"phase 11 TTM X-TDHF: {failed}")
    out["xtdhf"] = rec

    gs = json.loads((ROOT / "tests/data/golden_ttm_stda.json").read_text())
    kernels.reset_launch_counts()
    s = time.perf_counter()
    drv = STDA(ref, nstates=10)
    res = drv.kernel()
    _sync()
    wall = time.perf_counter() - s
    act = drv.act
    rec = {"solve_s": wall, "timings": drv.timings, "selection": drv.selection,
           "active": {"lo": act.lo, "hi": act.hi, "nc": act.nc, "no": act.no, "nv": act.nv},
           "launches": kernels.launch_counts(), "mode_launches": kernels.mode_launch_counts(),
           "e_ev": res.e_eV.tolist(), "osc": res.osc.tolist(), "ds2": res.ds2.tolist(),
           "max_dev_ev": float(np.abs(res.e_eV - np.asarray(gs["e_ev"])).max()),
           "max_dev_osc": float(np.abs(res.osc - np.asarray(gs["osc"])).max()),
           "max_dev_ds2": float(np.abs(res.ds2 - np.asarray(gs["ds2"])).max())}
    _log("phase 11 stda", json.dumps(rec))
    _log("phase 11 stda stages (s): "
         + ", ".join(f"{k} {v:.3f}" for k, v in drv.timings.items()))
    failed = []
    if rec["active"] != gs["active"]:
        failed.append(f"active space {rec['active']} != {gs['active']}")
    for k in ("pcsf", "final", "dim", "dim_full"):
        if drv.selection[k] != gs[k]:
            failed.append(f"selection {k} {drv.selection[k]} != {gs[k]}")
    for k in ("max_dev_ev", "max_dev_osc", "max_dev_ds2"):
        if not rec[k] <= STDA_GATE:
            failed.append(f"{k} {rec[k]} above {STDA_GATE}")
    if rec["launches"]["stda_coupling"] <= 0:
        failed.append("K4 not launched")
    if failed:
        raise AssertionError(f"phase 11 TTM sX-TDA: {failed}")
    out["stda"] = rec
    return out


# phase 12: SCF internal stability and the SOC-SI pipeline.  The TTM Hessian's
# three lowest eigenvalues and the O atom's SOC levels are the JAX package's
# own CPU runs (`tools/stability_soc_golden.py`); the As leg's golden is the
# JAX run of `tools/run_as_socsi.py` (`golden_as_socsi.json`)
STAB_GATE_HA = 1e-6
H2_SADDLE_W = -1e-3  # tests/test_stability.py: the saddle's lowest eigenvalue
H2_ESCAPE_HA = 1e-4  # and the drop of the energy when stable_scf leaves it
H2_DF_DENSE_W = 5e-3  # the DF and dense backends' lowest eigenvalues apart
AS_SCF_GATE_HA = 1e-6
AS_ESO_GATE_CM = 0.1
O_ESO_GATE_CM = 0.01


def _as_structure(e) -> list:
    """The As spectrum's structure (tests/test_soc_si.py:84-108, the
    constants copied): the 4S_3/2 ground quartet, sorted levels, the 2D
    term's J = 3/2 quartet and J = 5/2 sextet, their splitting and position,
    and the regression anchor e[4].  Returns what failed."""
    failed = []
    if not np.all(np.abs(e[:4]) < 20.0):
        failed.append(f"4S ground quartet spread {e[:4]}")
    if not np.all(np.diff(e) > -1e-6):
        failed.append("levels not sorted")
    d32, d52 = e[4:8], e[8:14]
    if not (np.ptp(d32) < 5.0 and np.ptp(d52) < 5.0):
        failed.append(f"J degeneracies: ptp {np.ptp(d32)}, {np.ptp(d52)}")
    split = d52.mean() - d32.mean()
    if not 150.0 < split < 500.0:
        failed.append(f"2D splitting {split}")
    if not 8000.0 < d32.mean() < 12000.0:
        failed.append(f"2D position {d32.mean()}")
    if not abs(e[4] - 9743.9) <= 1.0:
        failed.append(f"e[4] {e[4]} not within 1.0 of 9743.9")
    return failed


def _o_structure(si) -> list:
    """The O atom's 3P multiplet (tests/test_soc_si.py:41-80, the constants
    copied): nine levels, inverted J = 2, 1, 0, the Lande ratio, a hermitian
    Heff and physical oscillator strengths.  Returns what failed."""
    from xtddft_tpu_torch import units

    r = si.result
    e = (r.eso - r.eso[0]) * units.HA2EV * units.EV2CM_1
    low = e[e < 5000]
    failed = []
    if len(low) != 9:
        return [f"{len(low)} levels of the 3P manifold, not 9"]
    j2, j1, j0 = low[:5], low[5:8], low[8]
    if not (j2.max() - j2.min() < 25.0 and j1.max() - j1.min() < 25.0):
        failed.append("J = 2 or J = 1 not quasi-degenerate")
    d21, d10 = j1.mean() - j2.mean(), j0 - j1.mean()
    if not (d21 > 0 and d10 > 0 and abs(d21 / d10 - 2.0) <= 0.35 * 2.0):
        failed.append(f"Lande intervals {d21}, {d10}")
    if not 50.0 < j0 < 400.0:
        failed.append(f"3P spread {j0}")
    if not np.abs(r.hso - r.hso.T.conjugate()).max() < 1e-12:
        failed.append("Heff not hermitian")
    fs = [si.osc_strength(0, j) for j in range(1, min(12, si.dim))]
    if not all(f > -1e-10 for f in fs):
        failed.append(f"negative oscillator strengths {fs}")
    return failed


def _stability_leg(mf) -> dict:
    """`internal_stability(mf, backend="df")` with its Davidson record, the
    kernels' launches over the run and in one Hessian action on its own,
    the seconds of one action and the peak memory."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.scf import stability

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    last = {}
    stable, w_min, _ = stability.internal_stability(mf, backend="df", record=last)
    _sync()
    wall = time.perf_counter() - s
    rec = {"s": wall, "stable": stable, "w_min": w_min, "w": last["w"].tolist(),
           "converged": [bool(c) for c in last["converged"]], "cycles": last["cycles"],
           "hessian_actions": last["hessian_actions"], "vectors": last["vectors"],
           "launches": _df_launch_counts(), "mode_launches": kernels.mode_launch_counts(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    # one action on its own: its launches and its seconds
    hvp, hdiag, _ = stability.df_hessian_operator(mf)
    xs = torch.as_tensor(np.random.default_rng(0).normal(size=(3, hdiag.shape[0])),
                         device="cuda", dtype=torch.float64)
    hvp(xs)
    _sync()
    kernels.reset_launch_counts()
    s = time.perf_counter()
    hvp(xs)
    _sync()
    rec["action_s"] = time.perf_counter() - s
    rec["action_launches"] = _df_launch_counts()
    return rec


def _h2_saddle() -> dict:
    """tests/test_stability.py's stretched-H2 UHF saddle on the card: the
    in-core SCF and the dense backend, then the DF SCF with both backends."""
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.scf import RHF
    from xtddft_tpu_torch.scf.driver import SCF
    from xtddft_tpu_torch.scf.stability import internal_stability, stable_scf

    mol = Molecule.from_atoms("H 0 0 0; H 0 0 2.2", basis="sto-3g")
    seed = np.stack([RHF(mol, device="cuda").kernel().mo_coeff] * 2)
    rec, failed = {}, []
    for route, df, backends in (("incore", False, ("dense",)), ("df", True, ("dense", "df"))):
        scf_u = SCF(mol, "uhf", df=df, device="cuda")
        mf_sym = scf_u.kernel(init=seed)
        for backend in backends:
            stable, w, _ = internal_stability(mf_sym, backend=backend)
            mf_bs = stable_scf(scf_u, init=seed, backend=backend)
            after = internal_stability(mf_bs, backend=backend)
            r = {"w_min": w, "e_sym": mf_sym.e_tot, "e_bs": mf_bs.e_tot,
                 "drop_ha": mf_sym.e_tot - mf_bs.e_tot, "w_min_after": after[1]}
            rec[f"{route}_{backend}"] = r
            if stable or not w < H2_SADDLE_W:
                failed.append(f"{route}/{backend}: saddle not detected (w_min {w})")
            if not (r["drop_ha"] > H2_ESCAPE_HA and after[0]):
                failed.append(f"{route}/{backend}: not escaped {r}")
    gap = abs(rec["df_dense"]["w_min"] - rec["df_df"]["w_min"])
    rec["df_vs_dense_w"] = gap
    if not gap < H2_DF_DENSE_W:
        failed.append(f"DF and dense w_min {gap} apart")
    _log("phase 12 h2", json.dumps(rec))
    if failed:
        raise AssertionError(f"phase 12 H2 saddle: {failed}")
    return rec


def _soc_leg(name, mf, nstates, scf_s, hcore_s, scf_launches, **kw) -> dict:
    """Stability (``auto``) and `run_soc_si` on ``mf``, with the seconds and
    kernel launches of every stage (``scf_launches``: the SCF's, hcore
    included)."""
    from xtddft_tpu_torch import kernels, units
    from xtddft_tpu_torch.scf import stability
    from xtddft_tpu_torch.soc.pipeline import run_soc_si

    kernels.reset_launch_counts()
    s = time.perf_counter()
    stable, w_min, _ = stability.internal_stability(mf)
    stab_s = time.perf_counter() - s
    stab_launches = kernels.launch_counts()
    si = run_soc_si(mf, nstates=nstates, **kw)
    _sync()
    eso = np.asarray(si.result.eso)
    rec = {"nao": mf.env.nao, "e_scf": mf.e_tot, "converged": mf.converged,
           "stable": stable, "w_min": w_min,
           "seconds": {"x2c_hcore": hcore_s, "scf": scf_s, "stability": stab_s,
                       **{k: v["s"] for k, v in si.legs.items()},
                       **{f"vso_{k}": v for k, v in si.vso_seconds.items()}},
           "launches": {"scf": scf_launches, "stability": stab_launches,
                        **{k: v["launches"] for k, v in si.legs.items()}},
           "dim": si.dim, "eso": eso.tolist(),
           "eso_cm": ((eso - eso[0]) * units.HA2EV * units.EV2CM_1).tolist()}
    _log(f"phase 12 {name}", json.dumps(rec))
    _log(f"phase 12 {name} stages (s): "
         + ", ".join(f"{k} {v:.3f}" for k, v in rec["seconds"].items()))
    return rec, si


def _ttm_stability(mf, gold) -> dict:
    """Leg (a): the TTM mean field's DF stability against the JAX golden."""
    rec = _stability_leg(mf)
    want = np.asarray(gold["w"])
    rec["w_golden"] = want.tolist()
    rec["max_dev_ha"] = float(np.abs(np.asarray(rec["w"]) - want).max())
    _log("phase 12 ttm stability", json.dumps(rec))
    _log(f"phase 12 ttm stability: {rec['cycles']} Davidson cycles, "
         f"{rec['hessian_actions']} Hessian actions ({rec['vectors']} vectors), "
         f"{rec['s']:.2f} s, {rec['action_s']:.3f} s per action, launches per action "
         f"{rec['action_launches']}, peak {rec['peak_mem_gb']:.2f} GB")
    failed = []
    # the JAX host Davidson ends this run on its stall test with no root
    # below the residual 1e-5 (the golden's "converged"), as the port's does
    if not rec["max_dev_ha"] <= STAB_GATE_HA:
        failed.append(f"eigenvalues {rec['max_dev_ha']} Ha from the JAX golden")
    for k, n in rec["launches"].items():
        # one launch each per action, and the reference Fock build's
        if n < rec["hessian_actions"] + 1 or rec["action_launches"][k] < 1:
            failed.append(f"{k}: {n} launches over {rec['hessian_actions']} actions")
    if failed:
        raise AssertionError(f"phase 12 TTM stability: {failed}")
    return rec


def _as_leg(fresh) -> dict:
    """Leg (c), the As atom: the sfX2C-ROKS/BHandHLYP SCF, its stability
    (printed, not gated) and SOC-SI against `golden_as_socsi.json`.  The
    SCF energy is gated on ``fresh``, the JAX package's energy at this
    commit (`tools/stability_soc_golden.py --leg as_scf`): the golden's own
    ``e_scf`` is 2.4e-6 Ha above it (ROADMAP fault 3.4) and is printed."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.scf.driver import SCF

    ga = json.loads((ROOT / "tests/data/golden_as_socsi.json").read_text())
    scf = SCF(Molecule.from_atoms("As 0 0 0", basis="ano-dz", spin=3), "roks",
              xc="bhandhlyp", grid_level=2, x2c=True, device="cuda")
    kernels.reset_launch_counts()
    s = time.perf_counter()
    scf.env.hcore
    s1 = time.perf_counter()
    mf = scf.kernel()
    _sync()
    rec, _ = _soc_leg("as", mf, 20, time.perf_counter() - s1, s1 - s,
                      kernels.launch_counts(), sf_method=2)
    e = np.asarray(rec["eso_cm"])[:len(ga["eso_cm"])]
    rec["dev_scf_ha"] = mf.e_tot - fresh["e_scf"]
    rec["dev_scf_golden_ha"] = mf.e_tot - ga["e_scf"]
    rec["dev_eso_cm"] = (e - np.asarray(ga["eso_cm"])).tolist()
    _log(f"phase 12 as: E - JAX E {rec['dev_scf_ha']:.3e} Ha (- the golden's stored e_scf "
         f"{rec['dev_scf_golden_ha']:.3e}), levels - golden (cm^-1) "
         f"{np.round(rec['dev_eso_cm'], 4).tolist()}, stability w_min {rec['w_min']:.6e}")
    failed = _as_structure(e)
    if not (mf.converged and abs(rec["dev_scf_ha"]) <= AS_SCF_GATE_HA):
        failed.append(f"SCF {mf.e_tot} vs the JAX package's {fresh['e_scf']}")
    if not np.abs(rec["dev_eso_cm"]).max() <= AS_ESO_GATE_CM:
        failed.append(f"levels {np.abs(rec['dev_eso_cm']).max()} cm^-1 from the golden")
    if failed:
        raise AssertionError(f"phase 12 As SOC-SI: {failed}")
    return rec


def _o_leg(gold) -> dict:
    """Leg (c), the O atom: ROHF/STO-3G and SOC-SI (8 states per manifold)
    against the JAX run's levels and tests/test_soc_si.py's gates."""
    from xtddft_tpu_torch import kernels, units
    from xtddft_tpu_torch.chem import Molecule
    from xtddft_tpu_torch.scf import ROHF

    kernels.reset_launch_counts()
    s = time.perf_counter()
    mf = ROHF(Molecule.from_atoms("O 0 0 0", basis="sto-3g", spin=2), device="cuda").kernel()
    rec, si = _soc_leg("o", mf, 8, time.perf_counter() - s, 0.0, kernels.launch_counts(),
                       cal_osc=True)
    rec["max_dev_cm"] = float(np.abs(np.asarray(rec["eso"]) - np.asarray(gold["eso"])).max()
                              * units.HA2EV * units.EV2CM_1)
    failed = _o_structure(si)
    if not rec["max_dev_cm"] <= O_ESO_GATE_CM:
        failed.append(f"levels {rec['max_dev_cm']} cm^-1 from the JAX run")
    if failed:
        raise AssertionError(f"phase 12 O SOC-SI: {failed}")
    return rec


def phase12(mf_ttm) -> dict:
    """SCF internal stability and the SOC-SI pipeline, f64, three legs:
    (a) `internal_stability(backend="df")` on phase 3's TTM mean field (182
    AO, naux 4412, 187,644 points), its three lowest Hessian eigenvalues
    against the JAX golden within STAB_GATE_HA, K1, K2 and K3 launched in
    every Hessian action; (b) the stretched-H2 UHF saddle on both backends,
    detected and escaped by `stable_scf`; (c) SOC-SI: the As atom (ano-dz,
    sfX2C-ROKS/BHandHLYP, grid 2, 20 states per manifold) with its
    stability printed, against `golden_as_socsi.json`, then the O atom's
    3P term (STO-3G ROHF, 8 states) against the JAX levels."""
    gold = json.loads((ROOT / "tests/data/golden_stability_soc.json").read_text())
    return {"ttm_stability": _ttm_stability(mf_ttm, gold["ttm_stability"]),
            "h2": _h2_saddle(), "as": _as_leg(gold["as_scf"]), "o": _o_leg(gold["o_socsi"])}


# phase 13: analytic excited-state gradients at CH2O+/cc-pVDZ.  The golden is
# the JAX package's X-CIS state-0 gradient and its 24-point central
# differences (tests/test_grad_analytic.py:301-325)
CH2O_GRAD_GOLDEN = ROOT / "tests" / "data" / "golden_ch2o_grad.json"
K5_RTOL = 1e-12
GRAD_GATE_ANALYTIC = 1e-6  # Ha/bohr, against the JAX analytic gradient
GRAD_GATE_FD = 1e-5  # against the golden's central differences (the JAX slow test's gate)
GRAD_GATE_EV = 1e-4
GRAD_GATE_TRANSL = 1e-9
GRAD_GATE_HF = 1e-8  # hf_gradient against scf_gradient
GRAD_GATE_DFT_FD = 2e-5  # tests/test_grad_analytic.py:144
DFT_FD_COMPONENTS = ((0, 2), (1, 2), (2, 0), (2, 2))  # C z, O z, H1 x, H1 z


def _ch2o_mol(gold):
    from xtddft_tpu_torch.chem import Molecule

    return Molecule.from_atoms(gold["geometry"], basis="cc-pvdz", charge=1, spin=1)


def _k5_check(checks):
    """K5 against its plain version at CH2O+/cc-pVDZ on a seeded 8-fold
    symmetric Gamma: relative error, a second launch bitwise, the call's
    CUDA-event time (its host tables included) and the kernel's alone
    (``kernel_ms``, tables made), the plain version's (one call: it takes
    seconds), and the bound from the kernel's operation count on this
    basis and Gamma's bytes.  No single PyTorch call computes it."""
    from xtddft_tpu_torch.ints import build_layout
    from xtddft_tpu_torch.kernels import eri_grad as k5
    from xtddft_tpu_torch.response.flops import bound_ms

    lay = build_layout(_ch2o_mol(json.loads(CH2O_GRAD_GOLDEN.read_text())))
    rng = np.random.default_rng(13)
    G = k5.symmetrize8(torch.as_tensor(rng.standard_normal((lay.nao,) * 4), device="cuda"))
    got = k5.eri_grad(lay, G)
    again = k5.eri_grad(lay, G)
    _sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = k5.eri_grad_plain(lay, G)
    b.record()
    _sync()
    p = k5.GradPlan(lay, G.device)
    Gc = k5.to_cart(p, G)
    rec = {"kernel": k5.NAME, "shape": "ch2o_ccpvdz", "dtype": "float64", "nao": lay.nao,
           "ncart": p.nc, "bra_pairs": int(p.bra_rows.shape[0]),
           "ket_pairs": int(p.ket_rows.shape[0]), "flops": p.flops, "rtol": K5_RTOL,
           "fixed_order": True, "fixed_repeats_bitwise": bool(torch.equal(got, again)),
           "plain_ms": a.elapsed_time(b), "ms": time_ms(lambda: k5.eri_grad(lay, G)),
           "kernel_ms": time_ms(lambda: k5.launch(p, Gc)), "library_ms": None}
    rec["max_abs_err"], rec["rel_err"] = rel_err(got, want)
    rec["bound_ms"], rec["bound_by"] = bound_ms(p.flops, p.nbytes(lay.nao), "float64")
    rec["transl_invariance"] = float(got.sum(0).abs().max())
    _log("phase 2", json.dumps(rec))
    if not rec["rel_err"] <= K5_RTOL:
        raise AssertionError(f"eri_grad disagrees with its plain version: {rec}")
    if not rec["fixed_repeats_bitwise"]:
        raise AssertionError(f"eri_grad: two launches differ: {rec}")
    checks.append(rec)


def _gradient_run(name, eg, k5_ms, state=0):
    """One analytic gradient with its stages, launches and peak memory (its
    own: above what earlier phases hold); ``k5_ms``: phase 2's time of K5's
    launch at this basis, printed beside the stages."""
    from xtddft_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s = time.perf_counter()
    g, w = eg.kernel(state)
    _sync()
    rec = {"xdim": eg.xdim, "rotation_pairs": eg.nk, "seconds": time.perf_counter() - s,
           **eg.stats, "launches": kernels.launch_counts(),
           "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9, "omega": w,
           "grad": g.tolist(), "transl_invariance": float(np.abs(g.sum(axis=0)).max())}
    _log(f"phase 13 {name}", json.dumps(rec))
    _log(f"phase 13 {name} stages (s): states {rec['states_s']:.2f}, z-vector rhs "
         f"{rec['zvector_rhs_s']:.2f}, cg {rec['cg_iterations']} iterations "
         f"{rec['zvector_cg_s']:.2f}, reverse pass {rec['phi_grad_s']:.2f} (K5 "
         f"{k5_ms:.2f} ms of it, phase 2); peak {rec['peak_gb']:.2f} GB")
    return rec, g, w


def _ch2o_hf_leg(gold, k5_ms) -> dict:
    """CH2O+ ROHF X-CIS state 0 against the golden; hf_gradient against
    scf_gradient."""
    from xtddft_tpu_torch import kernels, units
    from xtddft_tpu_torch.grad import ExcitedGradients, hf_gradient, scf_gradient
    from xtddft_tpu_torch.scf import ROHF

    s = time.perf_counter()
    mf = ROHF(_ch2o_mol(gold), device="cuda").kernel()
    _sync()
    rec = {"scf_s": time.perf_counter() - s, "e_scf": mf.e_tot, "converged": mf.converged,
           "dev_e_scf_golden_ha": mf.e_tot - gold["e_scf"]}
    xc, g, w = _gradient_run("hf xcis", ExcitedGradients(mf, "xcis"), k5_ms)
    rec["xcis"] = xc
    rec["launches"] = xc["launches"]
    rec["e0_eV"] = w * units.HA2EV
    rec["dev_analytic"] = float(np.abs(g - np.asarray(gold["grad_analytic"])).max())
    rec["dev_fd"] = float(np.abs(g - np.asarray(gold["grad_fd_h2e-3bohr"])).max())
    rec["dev_e0_eV"] = rec["e0_eV"] - gold["e0_eV"]
    for label, fn in (("hf_gradient", hf_gradient), ("scf_gradient", scf_gradient)):
        kernels.reset_launch_counts()
        s = time.perf_counter()
        rec[label] = fn(mf)
        _sync()
        rec[f"{label}_s"] = time.perf_counter() - s
        rec[f"launches_{label}"] = kernels.launch_counts()
    rec["dev_hf_vs_scf_gradient"] = float(np.abs(rec["hf_gradient"] - rec["scf_gradient"]).max())
    rec["hf_gradient"], rec["scf_gradient"] = (rec["hf_gradient"].tolist(),
                                               rec["scf_gradient"].tolist())
    _log("phase 13 hf", json.dumps({k: v for k, v in rec.items() if k != "xcis"}))
    _log(f"phase 13 hf: X-CIS - JAX analytic {rec['dev_analytic']:.3e}, - JAX FD "
         f"{rec['dev_fd']:.3e} Ha/bohr, e0 - golden {rec['dev_e0_eV']:.2e} eV, E_scf - golden "
         f"{rec['dev_e_scf_golden_ha']:.2e} Ha; hf_gradient - scf_gradient "
         f"{rec['dev_hf_vs_scf_gradient']:.2e}")
    failed = []
    if not mf.converged:
        failed.append("SCF not converged")
    if not rec["dev_analytic"] <= GRAD_GATE_ANALYTIC:
        failed.append(f"{rec['dev_analytic']} Ha/bohr from the JAX analytic gradient")
    if not rec["dev_fd"] <= GRAD_GATE_FD:
        failed.append(f"{rec['dev_fd']} Ha/bohr from the golden's central differences")
    if not abs(rec["dev_e0_eV"]) <= GRAD_GATE_EV:
        failed.append(f"e0 {rec['e0_eV']} eV vs {gold['e0_eV']}")
    if not xc["transl_invariance"] <= GRAD_GATE_TRANSL:
        failed.append(f"translational invariance {xc['transl_invariance']}")
    if not rec["dev_hf_vs_scf_gradient"] <= GRAD_GATE_HF:
        failed.append(f"hf_gradient vs scf_gradient {rec['dev_hf_vs_scf_gradient']}")
    for label, n in (("xcis", xc["launches"]), ("hf_gradient", rec["launches_hf_gradient"]),
                     ("scf_gradient", rec["launches_scf_gradient"])):
        if n["eri_grad"] < 1:
            failed.append(f"K5 not launched in the {label} gradient")
    if failed:
        raise AssertionError(f"phase 13 CH2O+ ROHF: {failed}")
    return rec


def _ch2o_dft_leg(gold, k5_ms) -> dict:
    """CH2O+ ROKS/B3LYP (grid 1) X-TDA state 0: the analytic gradient against
    the port's central differences on the symmetry-unique components."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.grad import ExcitedGradients, fd_excited_gradient
    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.scf import ROKS

    kernels.reset_launch_counts()
    s = time.perf_counter()
    mf = ROKS(_ch2o_mol(gold), xc="b3lyp", grid_level=1, device="cuda").kernel()
    _sync()
    rec = {"scf_s": time.perf_counter() - s, "e_scf": mf.e_tot, "converged": mf.converged,
           "scf_launches": kernels.launch_counts()}
    xt, g, w = _gradient_run("dft xtda", ExcitedGradients(mf, "xcis"), k5_ms)
    rec["xtda"] = xt
    rec["launches"] = xt["launches"]
    s = time.perf_counter()
    gf = fd_excited_gradient(mf, lambda m: XTDA(m, nstates=1, backend="auto"), state=0, h=1e-3,
                             components=DFT_FD_COMPONENTS)
    rec["fd_s"] = time.perf_counter() - s
    rec["fd"] = {f"{a},{x}": float(gf[a, x]) for a, x in DFT_FD_COMPONENTS}
    rec["dev_fd"] = max(abs(float(g[a, x] - gf[a, x])) for a, x in DFT_FD_COMPONENTS)
    _log("phase 13 dft", json.dumps({k: v for k, v in rec.items() if k != "xtda"}))
    _log(f"phase 13 dft: X-TDA analytic - FD {rec['dev_fd']:.3e} Ha/bohr over "
         f"{len(DFT_FD_COMPONENTS)} components, |sum_A g_A| {xt['transl_invariance']:.2e}, "
         f"FD {rec['fd_s']:.1f} s")
    failed = []
    if not mf.converged:
        failed.append("SCF not converged")
    if not rec["dev_fd"] <= GRAD_GATE_DFT_FD:
        failed.append(f"{rec['dev_fd']} Ha/bohr from the central differences")
    if rec["launches"]["eri_grad"] < 1:
        failed.append("K5 not launched in the gradient")
    idle = [k for k in ("grid_rho1", "grid_back") if rec["scf_launches"][k] < 1]
    if idle:
        failed.append(f"not launched in the ROKS SCF: {idle}")
    if failed:
        raise AssertionError(f"phase 13 CH2O+ ROKS: {failed}")
    return rec


def phase13(k5_ms: float) -> dict:
    """Analytic excited-state gradients at CH2O+/cc-pVDZ: the ROHF X-CIS leg
    against the JAX golden, the ROKS/B3LYP X-TDA leg against the port's
    central differences (``k5_ms``: phase 2's K5 time at this basis)."""
    gold = json.loads(CH2O_GRAD_GOLDEN.read_text())
    return {"hf": _ch2o_hf_leg(gold, k5_ms), "dft": _ch2o_dft_leg(gold, k5_ms)}


def _roks_gradient(scf, mf, va, vb):
    """|g| of the Roothaan Fock of the potentials (va, vb) at mf's density,
    the SCF's own convergence measure (`scf/driver.py`)."""
    from xtddft_tpu_torch.scf.driver import _sym_orth

    env = scf.env
    S = env.S.cpu().numpy()
    h = env.hcore.cpu().numpy()
    da, db = mf.make_rdm1()
    f = scf._roothaan_fock(h + va, h + vb, db, da - db, S)
    X = _sym_orth(S)
    return float(np.linalg.norm(X.T @ (f @ (da + db) @ S - S @ (da + db) @ f) @ X))


def _pair_splits(e_ev, pairs):
    """e[i + 1] - e[i] for the doubly degenerate (E) pairs (i, i + 1) of TTM's
    D3 symmetry."""
    return [float(e_ev[i + 1] - e_ev[i]) for i in pairs]


def _solve_leg(name, run, want, golden, nroots, flops_per_build, failed, gate_ev=None):
    """One response solve of phase 8: wall, cycles, builds/s, TFLOP/s and
    launches; the gates: every root converged, the sorted roots within
    ``gate_ev`` (default ``DZP_GATE_EV``) of ``want[0]`` (the JAX package's
    f64 solve, `tools/ttm_dzp_ckpt_energy.py --solve`) and <dS^2> within
    ``DZP_GATE_DS2`` of ``want[1]`` where given, osc >= 0.  ``golden``:
    (energies, <dS^2> or None) of the JAX golden, printed beside the port's
    with the splittings of the E pairs, which D3 symmetry makes degenerate.
    A failed gate goes into ``failed``, which phase 8 raises on once every
    leg has printed."""
    from xtddft_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    res = run()
    _sync()
    wall = time.perf_counter() - s
    launches = _df_launch_counts()
    order = np.argsort(res.e_eV)
    e = res.e_eV[order]
    dev = e - np.sort(np.asarray(want[0]))[:nroots]
    g = np.sort(np.asarray(golden[0]))[:nroots]
    # the E pairs: neighbours within 2 meV in the port's spectrum
    pairs = [i for i in range(len(e) - 1) if e[i + 1] - e[i] < 2e-3]
    r = {"solve_s": wall, "cycles": res.cycles, "nroots": len(res.e),
         "converged": res.converged, "max_dev_ev": float(np.abs(dev).max()),
         "builds_per_s": res.cycles / wall,
         "tflops": flops_per_build * res.cycles / wall / 1e12,
         "flops_per_build": flops_per_build, "launches": launches,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "e_ev": e.tolist(),
         "dev_ev": dev.tolist(), "golden_dev_ev": (e - g).tolist(),
         "max_golden_dev_ev": float(np.abs(e - g).max()),
         "e_pair_splits_ev": _pair_splits(e, pairs),
         "golden_e_pair_splits_ev": _pair_splits(g, pairs)}
    if res.osc is not None:
        r["osc_min"] = float(np.min(res.osc))
    if want[1] is not None:
        ds2 = np.asarray(res.ds2)[order]
        r["ds2"] = ds2.tolist()
        r["max_dev_ds2"] = float(np.abs(ds2 - np.asarray(want[1])[np.argsort(want[0])]).max())
        r["max_golden_dev_ds2"] = float(np.abs(
            ds2 - np.asarray(golden[1])[np.argsort(golden[0])]).max())
    _log(f"phase 8 {name}", json.dumps(r))
    if not (res.converged and len(res.e) == nroots):
        failed.append(f"TTM/dzp {name}: not {nroots}/{nroots} roots converged")
    if not r["max_dev_ev"] < (DZP_GATE_EV if gate_ev is None else gate_ev):
        failed.append(f"TTM/dzp {name} deviates from the JAX f64 solve by "
                      f"{r['max_dev_ev']} eV")
    if res.osc is not None and not np.all(res.osc >= -1e-12):
        failed.append(f"TTM/dzp {name}: negative oscillator strength {r['osc_min']}")
    if want[1] is not None and not r["max_dev_ds2"] < DZP_GATE_DS2:
        failed.append(f"TTM/dzp {name}: <dS^2> off by {r['max_dev_ds2']}")
    idle = [k for k, n in launches.items() if n <= 0]
    if idle:
        failed.append(f"kernels not launched on the dzp {name} path: {idle}")
    return r, res


def phase8(ref_small, rec: dict, vectors: pathlib.Path | None = None) -> dict:
    """Production scale: TTM/dzp (598 AO), f64, through the public entry
    points on one Env (``ref_small``: phase 3's STO-3G Reference, whose
    orbitals start the SCF).  The response from the checkpoint (X-TDA, 20
    roots; XSF-TDA SA=0, 10 roots), then the ROKS SCF from the STO-3G
    checkpoint projected to dzp and X-TDA on its mean field; the gates are
    listed with the ``DZP_*``
    constants.  Fills ``rec`` leg by leg (so that a failed
    gate leaves the numbers before it) and returns it; ``vectors``: also
    write the two response legs' roots and eigenvectors (blocked layout)
    there, for `tools/ttm_dzp_ckpt_energy.py --rayleigh`."""
    import os

    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule, geometries
    from xtddft_tpu_torch.methods.drivers import XSFTDA, XTDA
    from xtddft_tpu_torch.response.flops import matvec_flops, scf_veff_flops, sf_matvec_flops
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.response.sigma_df import build_df_data
    from xtddft_tpu_torch.scf import ROKS
    from xtddft_tpu_torch.scf.checkpoint import load_mf
    from xtddft_tpu_torch.scf.project import project_mo

    golden = json.loads((ROOT / "tests/data/golden_ttm_dzp.json").read_text())
    golden_xsf = json.loads((ROOT / "tests/data/golden_ttm_dzp_xsf.json").read_text())
    ckpt_path = ROOT / "tests/data/ttm_dzp_ckpt.npz"
    ckpt = np.load(ckpt_path)
    t = {"host_cores": os.cpu_count()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf0 = load_mf(str(ckpt_path), df=True, device="cuda", dtype=torch.float64)
    env, small = mf0.env, ref_small.env
    held = {}
    steps = (
        ("grid", lambda: env.grid),
        ("eval_ao", lambda: env.ao),
        ("j3c", env.df_j3c_host),
        ("metric", env.df_isqrt_host),
        ("dressing", env.df_B),
        ("one_electron", lambda: (env.S, env.hcore)),
        ("one_electron_props", lambda: (env.dip, env.ipovlp, env.rxp)),
        ("make_reference", lambda: held.setdefault("ref", make_reference(mf0))),
        ("build_df_data", lambda: build_df_data(held["ref"])),
    )
    for name, step in steps:
        s = time.perf_counter()
        step()
        _sync()
        t[name] = time.perf_counter() - s
    t["host_setup"] = time.perf_counter() - t0
    ref = held.pop("ref")
    naux, ngrid = env.aux_layout.nao, int(env.grid.size)
    dims = {"nao": env.nao, "naux": naux, "ngrid": ngrid, "nc": ref.nc, "no": ref.no,
            "nv": ref.nv, "j3c_released": not env._df_j3c_cache,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    _log("phase 8 setup", json.dumps({**dims, **t}))
    rec.update(dims, setup_s=t)
    failed = []
    # the checkpoint's own density under the port's Fock build
    mol = Molecule.from_atoms(geometries.ttm_vacuum, basis="dzp", spin=1)
    if mol != env.mol:
        raise AssertionError("ttm_vacuum is not the molecule of tests/data/ttm_dzp_ckpt.npz")
    scf = ROKS(mol, xc="b3lyp", grid_level=1, df=True, aux_mode="jk", env=env)
    d0 = mf0.make_rdm1()
    va, vb, e2 = scf._veff_and_exc(d0[0], d0[1])
    e_ckpt_density = (float(np.einsum("pq,qp->", env.hcore.cpu().numpy(), d0[0] + d0[1]))
                      + e2 + mol.energy_nuc())
    g_ckpt = _roks_gradient(scf, mf0, va, vb)
    rec["ckpt_density"] = {"e_minus_ckpt_e_tot_ha": e_ckpt_density - float(ckpt["e_tot"]),
                           "e_minus_jax_host_ha": e_ckpt_density - DZP_JAX_E_OF_CKPT_DENSITY,
                           "gnorm": g_ckpt}
    _log("phase 8 checkpoint density", json.dumps(rec["ckpt_density"]))

    n_o, n_v = ref.nc + ref.no, ref.no + ref.nv
    rec["xtda"], res_x = _solve_leg(
        "xtda", lambda: XTDA(ref, nstates=20, backend="df").kernel(),
        (DZP_JAX_XTDA_EV, None), (golden["e_refined_ev"], None), 20,
        matvec_flops(ref.nc, ref.no, ref.nv, naux, ngrid, 20), failed)
    # the flip golden's own arguments (bench.py's production flip leg)
    rec["xsf"], res_f = _solve_leg(
        "xsf", lambda: XSFTDA(ref, SA=int(golden_xsf["SA"]), backend="df").kernel(
            nstates=10, foo=1.0, fglobal=float(golden_xsf["fglobal"]), remove=True),
        (DZP_JAX_XSF_EV, DZP_JAX_XSF_DS2), (golden_xsf["e_refined_ev"], golden_xsf["ds2"]), 10,
        sf_matvec_flops(n_o, n_v, naux, ngrid, 10), failed)
    if vectors is not None:
        np.savez(vectors, xtda_e=res_x.e, xtda_v=res_x.v, xsf_e=res_f.e, xsf_v=res_f.v,
                 xsf_ds2=res_f.ds2)
    del res_x, res_f

    # the SCF from the STO-3G solution projected to dzp
    S = env.S.cpu().numpy()
    s = time.perf_counter()
    init = project_mo(ref_small.mf.mo_coeff, small.layout, env.layout, s_big=S)
    t_project = time.perf_counter() - s
    # synchronized at each stage of a Fock build: the split of a cycle (a
    # dzp cycle is long beside the synchronizations)
    scf.profile = True
    kernels.reset_launch_counts()
    s = time.perf_counter()
    mf = scf.kernel(init=init)
    _sync()
    wall = time.perf_counter() - s
    launches = _df_launch_counts()
    n = scf.cycles
    occ = np.asarray(ckpt["mo_occ"]) > 0
    d_e = mf.e_tot - float(ckpt["e_tot"])
    d_eps = float(np.abs(mf.mo_energy[occ] - np.asarray(ckpt["mo_energy"])[occ]).max())
    stages = {k: v / n for k, v in scf.stage_seconds.items()}
    fl = scf_veff_flops(naux, env.nao, ngrid)
    sc = {"cycles": n, "converged": mf.converged, "scf_s": wall, "s_per_cycle": wall / n,
          "stage_s_per_cycle": stages, "k1_share_of_cycle": stages["jk"] / (wall / n),
          "project_s": t_project, "launches": launches,
          "e_tot": mf.e_tot, "de_vs_ckpt_ha": d_e,
          "de_vs_jax_host_ha": mf.e_tot - DZP_JAX_E_OF_CKPT_DENSITY, "max_deps_occ_ha": d_eps,
          "flops_per_cycle": fl, "k1_tflops": fl["k1"] / stages["jk"] / 1e12,
          "e_tot_minus_e_of_ckpt_density_ha": mf.e_tot - e_ckpt_density}
    _log("phase 8 scf", json.dumps(sc))
    if not mf.converged:
        failed.append(f"TTM/dzp SCF did not converge in {n} cycles")
    if not abs(sc["de_vs_jax_host_ha"]) <= DZP_SCF_GATE_HA:
        failed.append(f"TTM/dzp SCF energy off the JAX host engine's value by "
                      f"{sc['de_vs_jax_host_ha']} Ha")
    if not mf.e_tot <= e_ckpt_density:
        failed.append(f"TTM/dzp SCF energy above that of the checkpoint's density by "
                      f"{sc['e_tot_minus_e_of_ckpt_density_ha']} Ha")
    if not d_eps <= DZP_SCF_GATE_EPS_HA:
        failed.append(f"TTM/dzp SCF occupied orbital energies off by {d_eps} Ha")
    short = [k for k, v in launches.items() if v < n]
    if short:
        failed.append(f"kernels not launched on every dzp Fock build: {short} {launches}")
    rec["scf"] = sc
    # on a mean field re-converged under the port's own Fock build: the
    # roots of the checkpoint's within 2e-3 eV (DZP_SCF_XTDA_GATE_EV)
    rec["scf_xtda"], res = _solve_leg(
        "scf_xtda", lambda: XTDA(mf, nstates=5, backend="df").kernel(),
        (DZP_JAX_XTDA_EV[:5], None), (golden["e_refined_ev"], None), 5,
        matvec_flops(ref.nc, ref.no, ref.nv, naux, ngrid, 5), failed, gate_ev=DZP_SCF_XTDA_GATE_EV)
    rec["scf_xtda"]["max_dev_vs_ckpt_xtda_ev"] = float(
        np.abs(res.e_eV - np.asarray(rec["xtda"]["e_ev"][:5])).max())
    if failed:
        raise AssertionError("phase 8 (TTM/dzp): " + "; ".join(failed))
    return rec


def _plain_matvec(op, z):
    """op.matvec(z) with every kernel of the sigma swapped for its plain version."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
    from xtddft_tpu_torch.response import sigma_df

    swapped = {"df_exchange": k1.df_exchange_plain, "grid_rho1": k2.grid_rho1_plain,
               "grid_back": k3.grid_back_plain}
    saved = {n: getattr(sigma_df, n) for n in swapped}
    try:
        for n, f in swapped.items():
            setattr(sigma_df, n, f)
        want = op.matvec(z)
        _sync()
    finally:
        for n, f in saved.items():
            setattr(sigma_df, n, f)
    return want


def phase4():
    """Bench-shape synthetic operator, f32: sigma check and 20-root solve.
    Returns (record, the DFData) for the flip leg to reuse."""
    from xtddft_tpu_torch.response import sigma_df
    from xtddft_tpu_torch.response.flops import matvec_flops
    from xtddft_tpu_torch.solver.davidson import davidson

    nmo, nc, no, naux, ngrid, nroots = 1000, 78, 2, 2000, 49152, 20
    nv = nmo - nc - no
    g = torch.Generator("cuda").manual_seed(0)
    s = time.perf_counter()
    data = sigma_df.synthetic_df_data(nmo=nmo, nc=nc, no=no, naux=naux, ngrid=ngrid,
                                      xc="bhandhlyp", generator=g, device="cuda",
                                      dtype=torch.float32)
    op = sigma_df.xtda_sigma_df(data)
    _sync()
    t_build = time.perf_counter() - s

    z = torch.randn((nroots, op.dim), generator=g, device="cuda", dtype=torch.float32)
    z = z / z.norm(dim=1, keepdim=True)
    got = op.matvec(z)
    _sync()
    err, rel = rel_err(got, _plain_matvec(op, z))
    _log("phase 4 sigma", json.dumps({"max_abs_err": err, "rel_err": rel,
                                      "rtol": F32_RTOL, "t_data_s": t_build}))
    if not rel <= F32_RTOL:
        raise AssertionError(f"bench sigma: kernels vs plain rel {rel}")

    x0 = op.init_guess(nroots)
    nb = x0.shape[0]
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    e, _, conv, info = davidson(op.matvec, op.hdiag, nroots=nroots, init_guess=x0,
                                tol=1e-3, max_space_factor=8, device=op.device,
                                dtype=op.dtype)
    _sync()
    wall = time.perf_counter() - s
    cycles = info["cycles"]
    flops = matvec_flops(nc, no, nv, naux, ngrid, nb)
    rec = {"wall_s": wall, "cycles": cycles, "nb": nb, "nconv": int(conv.sum()),
           "nroots": nroots, "builds_per_s": cycles / wall,
           "tflops": flops * cycles / wall / 1e12, "flops_per_build": flops,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "e": e.tolist()}
    _log("phase 4 solve", json.dumps(rec))
    if not (conv.sum() == nroots and np.all(np.isfinite(e)) and np.all(np.diff(e) >= 0)):
        raise AssertionError(f"bench solve: {rec}")
    return rec, data


def phase5(ref) -> dict:
    """The flip leg on the TTM reference of phase 3, f64, through the public
    entry points: XSF-TDA (SA=0: TTM is a doublet) and SF-TDA flip-up."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.methods.drivers import SFTDA, XSFTDA

    golden = json.loads((ROOT / "tests/data/golden_ttm_flip.json").read_text())
    runs = (
        ("xsf", lambda: XSFTDA(ref, nstates=10, SA=0, method=0, backend="df").kernel(),
         golden["xsf_e_ev"], golden["xsf_ds2"]),
        ("sfup", lambda: SFTDA(ref, nstates=10, extype="up", method=0, backend="df").kernel(),
         golden["sfup_e_ev"], None),
    )
    rec = {}
    for name, run, e_ref, ds2_ref in runs:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        s = time.perf_counter()
        res = run()
        _sync()
        wall = time.perf_counter() - s
        launches = _df_launch_counts()
        # the golden has near-degenerate pairs: compare sorted energies, not vectors
        order = np.argsort(res.e_eV)
        dev = float(np.abs(res.e_eV[order] - np.sort(e_ref)).max())
        r = {"solve_s": wall, "cycles": res.cycles, "nroots": len(res.e),
             "converged": res.converged, "max_dev_ev": dev, "launches": launches,
             "e_ev": res.e_eV.tolist(),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if ds2_ref is not None:
            r["ds2"] = res.ds2.tolist()
            r["max_dev_ds2"] = float(np.abs(
                res.ds2[order] - np.asarray(ds2_ref)[np.argsort(e_ref)]).max())
        _log(f"phase 5 {name}", json.dumps(r))
        if not (res.converged and len(res.e) == 10):
            raise AssertionError(f"TTM {name}: not 10/10 roots converged: {r}")
        if not dev < TTM_GATE_EV:
            raise AssertionError(f"TTM {name} deviates from golden_ttm_flip.json by {dev} eV")
        if ds2_ref is not None and not r["max_dev_ds2"] < 1e-3:
            raise AssertionError(f"TTM {name}: <dS^2> off by {r['max_dev_ds2']}")
        idle = [k for k, n in launches.items() if n <= 0]
        if idle:
            raise AssertionError(f"kernels not launched on the {name} path: {idle}")
        rec[name] = r
    rec["launches"] = {k: rec["xsf"]["launches"][k] + rec["sfup"]["launches"][k]
                       for k in rec["xsf"]["launches"]}
    return rec


def phase6(data) -> dict:
    """The flip leg at the bench width, f32, on the DFData of phase 4:
    ``xsf_sigma_df(SA=3, remove=True, method=0)`` against the plain path,
    seconds per build and the spin-adaptation (dA) share, a 10-root solve."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.response import sigma_df, xsf_terms
    from xtddft_tpu_torch.response.flops import sf_matvec_flops
    from xtddft_tpu_torch.solver.davidson import davidson

    nroots = 10
    n_o, n_v = data.nc + data.no, data.no + data.nv
    naux, ngrid = data.B.shape[0], data.grid_w.shape[0]
    s = time.perf_counter()
    xsf_terms.delta_a_tensors_from_df(data.B, data.nc, data.no, 3)
    _sync()
    t_da_tensors = time.perf_counter() - s
    s = time.perf_counter()
    op = sigma_df.xsf_sigma_df(data, SA=3, remove=True, method=0)
    _sync()
    t_op = time.perf_counter() - s
    op_sa0 = sigma_df.xsf_sigma_df(data, SA=0, remove=True, method=0)

    g = torch.Generator("cuda").manual_seed(6)
    z = torch.randn((nroots, op.dim), generator=g, device="cuda", dtype=torch.float32)
    z = z / z.norm(dim=1, keepdim=True)
    kernels.reset_launch_counts()
    got = op.matvec(z)
    _sync()
    launches = _df_launch_counts()
    err, rel = rel_err(got, _plain_matvec(op, z))
    build_ms = time_ms(lambda: op.matvec(z))
    build_sa0_ms = time_ms(lambda: op_sa0.matvec(z))
    sig = {"max_abs_err": err, "rel_err": rel, "rtol": F32_RTOL, "dim": op.dim,
           "launches_per_build": launches, "build_ms": build_ms,
           "build_without_dA_ms": build_sa0_ms,
           "dA_share": (build_ms - build_sa0_ms) / build_ms,
           "dA_tensors_s": t_da_tensors, "operator_s": t_op}
    _log("phase 6 sigma", json.dumps(sig))
    if not rel <= F32_RTOL:
        raise AssertionError(f"bench flip sigma: kernels vs plain rel {rel}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"bench flip sigma: kernels not launched: {launches}")
    del op_sa0, got

    x0 = op.init_guess(nroots)
    nb = x0.shape[0]
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    e, _, conv, info = davidson(op.matvec, op.hdiag, nroots=nroots, init_guess=x0,
                                tol=1e-3, max_space_factor=8, pick_positive=False,
                                device=op.device, dtype=op.dtype)
    _sync()
    wall = time.perf_counter() - s
    cycles = info["cycles"]
    flops = sf_matvec_flops(n_o, n_v, naux, ngrid, nb)
    rec = {**sig, "wall_s": wall, "cycles": cycles, "nb": nb, "nconv": int(conv.sum()),
           "nroots": nroots, "builds_per_s": cycles / wall,
           "tflops": flops * cycles / wall / 1e12, "flops_per_build": flops,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "e": e.tolist()}
    _log("phase 6 solve", json.dumps(rec))
    if not (conv.sum() == nroots and np.all(np.isfinite(e)) and np.all(np.diff(e) >= 0)):
        raise AssertionError(f"bench flip solve: {rec}")
    return rec


# phase 9: the small-molecule flow.  The JAX package is not installed on the
# card's host, so the gates are constants copied from tests/test_golden.py,
# with its tolerances (the reference notebooks' stored outputs)
N2_TDA_EV = (9.0614, 9.1420, 9.1420)  # example/TDA.ipynb cell 2
N2_GATE_EV = 2e-3
CH2O_XTDA_EV = (3.8634, 5.3476, 5.7484, 6.6386, 7.9075)  # example/TDA.ipynb cell 6
CH2O_UTDA_EV = (3.9889, 5.4592, 5.8050)  # example/TDA.ipynb cell 4
CH2O_GATE_EV = 0.02
# sU-TDA on the UKS CH2O+ (example/sTDA.ipynb cell 2), gated as
# tests/test_golden.py gates the JAX package: the CAS window and the P-CSF
# counts exactly, the roots to 0.1 eV (S-CSF couplings sit within 6% of the
# threshold and flip with the grid scheme)
CH2O_SUTDA_EV = (4.1201, 5.2932, 5.9722)
CH2O_SUTDA_GATE_EV = 0.1
CH2O_SUTDA_ACTIVE = (5, 1, 9)
CH2O_SUTDA_PCSF = {"cva": 2, "ova": 1, "cob": 3, "cvb": 2}
# N2 TDHF/RPA (phase 11's closed-shell leg, on phase 9's N2 mean field): the
# DF route against dense Casida (the JAX DF tests' gate, the fit error), and
# UTDHF against the union of the singlet and triplet roots (tests/test_tdhf.py)
N2_TDHF_DF_GATE_EV = 5e-3
N2_UTDHF_UNION_GATE_HA = 5e-6
INCORE_VS_DENSE_EV = 1e-6  # the same matrix, Davidson at 1e-7 against eigh
DF_VS_INCORE_EV = 2e-3  # a DF response on an in-core mean field (tests/test_df.py:135)
FH_E_SCF_HA = -100.038593827451  # example/'spin up.ipynb' cell 1, the aufbau 3Pi state
FH_E_GATE_HA = 5e-5
FH_SIGMA_IRREPS = {"A1": (4, 2), "B1": (1, 1), "B2": (1, 1)}  # the 3Sigma state
FH_XSF_ALDA0_EV = (-12.09424, -2.16162, -2.16162, 2.94771)  # example/XSF_TDA.ipynb cell 2
FH_XSF_MCOL_EV = (-12.16628, -2.57263, -2.57263, 3.04828)  # cell 3
FH_USF_EV = (-11.79723, -2.28512, -2.28512, 0.61990)  # cell 6
FH_GATE_EV = 5e-3
FH_PI_PAIR_EV = 1e-4
# Be aug-cc-pVTZ XSF-TDA: the JAX package's own f64 dense roots on its
# transcription of the basis (tests/test_golden.py:128-131)
BE_XSF_EV = (-2.56973318, 1.99570962, 2.09599853, 2.09776155, 3.70486163,
             4.05152929, 4.07001792, 4.07045315, 4.15750166, 4.15993487)
BE_GATE_EV = 0.01
# benzene: on a closed-shell reference the unrestricted matrix splits
# exactly into the singlet and triplet blocks
UNION_GATE_EV = 1e-8


class _Leg:
    """One leg of phase 9: its record, the kernel launches over the whole
    leg, and the gates that failed."""

    def __init__(self, name):
        from xtddft_tpu_torch import kernels

        self.name, self.rec, self.failed = name, {}, []
        kernels.reset_launch_counts()
        self.t0 = time.perf_counter()

    def gate(self, ok: bool, what: str) -> None:
        if not ok:
            self.failed.append(what)

    def env(self, scf) -> None:
        """Build the SCF's Env ahead of its first cycle, timed by part: the
        grid and the AO table, the ERIs (host engine and upload), the
        exchange-ordered copy; ``df=None`` must have picked in-core."""
        env = scf.env
        s = time.perf_counter()
        env.grid_weights, env.ao
        torch.cuda.synchronize()
        t_grid = time.perf_counter() - s
        s = time.perf_counter()
        env.eri
        torch.cuda.synchronize()
        t_eri = time.perf_counter() - s
        s = time.perf_counter()
        env.eri_k()
        torch.cuda.synchronize()
        self.rec.setdefault("env", []).append({
            "nao": env.nao, "npts": int(env.grid.size), "df": env.df, "grid_s": t_grid,
            "eri_s": t_eri, "eri_k_s": time.perf_counter() - s,
            "eri_gb": env.eri.numel() * env.eri.element_size() / 1e9})
        self.gate(not env.df, f"{env.nao} AO: df=None did not pick the in-core route")

    def scf(self, label, scf, **kw):
        """The SCF with its stages timed (``SCF.profile``)."""
        scf.profile = True
        s = time.perf_counter()
        mf = scf.kernel(**kw)
        torch.cuda.synchronize()
        self.rec[label] = {"cycles": scf.cycles, "converged": mf.converged, "e_tot": mf.e_tot,
                           "scf_s": time.perf_counter() - s,
                           "stage_s": dict(scf.stage_seconds)}
        self.gate(mf.converged, f"{label}: the SCF did not converge")
        return mf

    def solve(self, label, run):
        """A response through its driver: route, seconds and roots."""
        s = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        self.rec[label] = {"route": res.solver, "solve_s": time.perf_counter() - s,
                           "cycles": res.cycles, "converged": res.converged,
                           "e_ev": res.e_eV.tolist()}
        self.gate(res.converged, f"{label}: not converged")
        return res

    def near(self, label, got, want, tol) -> float:
        dev = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        self.rec.setdefault("dev_ev", {})[label] = dev
        self.gate(dev < tol, f"{label}: max deviation {dev} eV, gate {tol}")
        return dev

    def close(self, **extras) -> dict:
        """Read the leg's seconds and launches, then run ``extras`` (name ->
        callable, timings outside the leg's own work) into the record."""
        from xtddft_tpu_torch import kernels

        torch.cuda.synchronize()
        self.rec["leg_s"] = time.perf_counter() - self.t0
        self.rec["launches"] = launches = kernels.launch_counts()
        for key, fn in extras.items():
            self.rec[key] = fn()
        self.gate(launches["grid_rho1"] > 0 and launches["grid_back"] > 0,
                  f"K2 and K3 must launch in every leg with a functional: {launches}")
        tag = f"phase 9 {self.name}"
        for e in self.rec.get("env", []):
            _log(f"{tag} env: {e['nao']} AO, {e['npts']} grid points, df {e['df']}; grid + AO "
                 f"table {e['grid_s']:.3f} s, ERIs {e['eri_s']:.3f} s ({e['eri_gb']:.3f} GB), "
                 f"exchange-ordered copy {e['eri_k_s']:.4f} s")
        for key, r in self.rec.items():
            if isinstance(r, dict) and "cycles" in r and "stage_s" in r:
                stages = ", ".join(f"{k} {v:.4f}" for k, v in r["stage_s"].items())
                _log(f"{tag} scf {key}: {r['cycles']} cycles, {r['scf_s']:.3f} s ({stages})")
            elif isinstance(r, dict) and "route" in r:
                _log(f"{tag} {key}: route {r['route']}, {r['solve_s']:.3f} s, "
                     f"cycles {r['cycles']}")
        _log(f"{tag} launches: K2 {launches['grid_rho1']}, K3 {launches['grid_back']}, "
             f"K1 {launches['df_exchange']}; leg {self.rec['leg_s']:.2f} s")
        _log(tag, json.dumps(self.rec))
        if self.failed:
            raise AssertionError(f"phase 9 {self.name}: {self.failed}")
        return self.rec


def _dense_routes_ms(ref) -> dict:
    """CUDA-event ms of the plain-PyTorch routes of the dense backend at a
    closed-shell reference (no kernel of their own; the JAX package runs
    them as einsums): the in-core J and K of two density matrices (one
    product each with the ERI matrix and its exchange-ordered copy), the
    quarter transforms of (ov|ov), the per-point Hessian, the pair-feature
    GEMMs of the three fxc blocks, and eigh of the TDA and UTDA
    matrices."""
    from xtddft_tpu_torch.response import dense
    from xtddft_tpu_torch.response.fxc_tensor import fxc_blocks, weighted_hessian
    from xtddft_tpu_torch.response.moeri import mo_eri
    from xtddft_tpu_torch.response.sigma import _rho0

    env = ref.env
    o, v = env.tensor(ref.orbo_a), env.tensor(ref.orbv_a)
    dms = env.tensor(np.stack([ref.orbo_a @ ref.orbo_a.T] * 2))
    rho0 = _rho0(ref)
    A = dense.tda_singlet_dense(ref)
    U = dense.utda_dense(ref)
    out = {"dim_tda": A.shape[0], "dim_utda": U.shape[0],
           "jk": time_ms(lambda: env.get_jk(dms)),
           "mo_eri_ovov": time_ms(lambda: mo_eri(env.eri, o, v, o, v)),
           "hessian": time_ms(lambda: weighted_hessian(ref.spec, env.grid_weights, rho0), 1),
           "fxc_blocks": time_ms(lambda: fxc_blocks(ref.spec, env.ao, env.grid_weights, rho0,
                                                    (o, v), (o, v), same=True), 1),
           "eigh_tda": time_ms(lambda: torch.linalg.eigh(A)),
           "eigh_utda": time_ms(lambda: torch.linalg.eigh(U)),
           "tda_singlet_dense": time_ms(lambda: dense.tda_singlet_dense(ref), 1)}
    nov = A.shape[0]
    out["fxc_gemm_tflop"] = 3 * 2.0 * nov * nov * 4 * int(env.grid.size) / 1e12
    return out


def _incore_sigma_ms(ref, nvec: int = 5) -> dict:
    """CUDA-event ms of one in-core X-TDA sigma build of ``nvec`` vectors and
    of its parts: J and K of the 2 nvec transition matrices (one product each
    with the ERI matrices), and the XC term `fxc_v1mat` (K2, the jvp, K3)."""
    from xtddft_tpu_torch.response.sigma import _rho0, xtda_sigma_operator
    from xtddft_tpu_torch.xc.interface import fxc_v1mat

    env = ref.env
    op = xtda_sigma_operator(ref)
    g = torch.Generator(device=env.device).manual_seed(9)
    z = torch.randn((nvec, op.dim), generator=g, device=env.device, dtype=env.dtype)
    d = torch.randn((nvec, 2, env.nao, env.nao), generator=g, device=env.device,
                    dtype=env.dtype)
    rho0 = _rho0(ref)
    return {"nvec": nvec, "build": time_ms(lambda: op.matvec(z)),
            "j": time_ms(lambda: env.incore_j(d[:, 0] + d[:, 1])),
            "k": time_ms(lambda: env.incore_k(d.reshape(-1, env.nao, env.nao))),
            "fxc_v1mat": time_ms(lambda: fxc_v1mat(ref.spec, env.ao, env.grid_weights, rho0, d))}


def phase9() -> dict:
    """The small-molecule flow through the public API, ``df=None`` (in-core
    below 121 AO) and ``backend="auto"`` (dense), f64, each leg gated as
    tests/test_golden.py gates the JAX package."""
    from xtddft_tpu_torch.chem import Molecule, geometries as G
    from xtddft_tpu_torch.kernels import stda_coupling
    from xtddft_tpu_torch.methods.drivers import TDA, TDHF, UTDA, UTDHF, XSFTDA, XTDA
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.scf import RKS, ROKS, UKS
    from xtddft_tpu_torch.scf.occupations import occ_from_irreps
    from xtddft_tpu_torch.stda import STDA

    out = {}
    leg = _Leg("n2")
    scf = RKS(Molecule.from_atoms(G.n2, basis="cc-pvdz"), xc="b3lyp", grid_level=3,
              device="cuda")
    leg.env(scf)
    mf = leg.scf("rks", scf)
    r = leg.solve("tda", lambda: TDA(mf, nstates=3).kernel())
    leg.gate(r.solver == "dense", "N2 TDA: not the dense route")
    leg.near("tda", r.e_eV, N2_TDA_EV, N2_GATE_EV)
    # phase 11's closed-shell leg: TDHF/RPA on this mean field
    rpa = {}
    for singlet in (True, False):
        tag = "tdhf_singlet" if singlet else "tdhf_triplet"
        for backend in ("dense", "df"):
            rpa[tag, backend] = leg.solve(f"{tag}_{backend}", lambda: TDHF(
                mf, nstates=5, singlet=singlet, backend=backend).kernel())
        leg.near(f"{tag}_df_vs_dense", rpa[tag, "df"].e_eV, rpa[tag, "dense"].e_eV,
                 N2_TDHF_DF_GATE_EV)
    u = leg.solve("utdhf", lambda: UTDHF(mf, nstates=8).kernel())
    union = np.sort(np.concatenate([rpa["tdhf_singlet", "dense"].e,
                                    rpa["tdhf_triplet", "dense"].e]))[:8]
    leg.near("utdhf_vs_union_ha", u.e, union, N2_UTDHF_UNION_GATE_HA)
    leg.gate(rpa["tdhf_singlet", "df"].solver == "rpa-davidson+stabcheck",
             "N2 TDHF df: not the paired Davidson with its stability re-check")
    out["n2"] = leg.close()
    leg = _Leg("ch2o")
    mol = Molecule.from_atoms(G.ch2o_vacuum, basis="cc-pvdz", charge=1, spin=1)
    scf = ROKS(mol, xc="b3lyp", grid_level=3, device="cuda")
    leg.env(scf)
    mf = leg.scf("roks", scf)
    dense = leg.solve("xtda", lambda: XTDA(mf, nstates=5).kernel())
    leg.gate(dense.solver == "dense", "CH2O+ X-TDA: auto did not pick the dense route")
    leg.near("xtda", dense.e_eV, CH2O_XTDA_EV, CH2O_GATE_EV)
    incore = leg.solve("xtda_incore", lambda: XTDA(mf, nstates=5, backend="incore").kernel())
    leg.near("incore_vs_dense", incore.e_eV, dense.e_eV, INCORE_VS_DENSE_EV)
    df = leg.solve("xtda_df", lambda: XTDA(mf, nstates=5, backend="df").kernel())
    leg.near("df_vs_incore", df.e_eV, incore.e_eV, DF_VS_INCORE_EV)
    mfu = leg.scf("uks", UKS(mol, xc="b3lyp", env=scf.env))
    r = leg.solve("utda", lambda: UTDA(mfu, nstates=3).kernel())
    leg.near("utda", r.e_eV, CH2O_UTDA_EV, CH2O_GATE_EV)
    st = STDA(mfu, spinadapt=False, nstates=3, select_with_fock=False)
    r = leg.solve("sutda", st.kernel)
    leg.near("sutda", r.e_eV, CH2O_SUTDA_EV, CH2O_SUTDA_GATE_EV)
    leg.rec["sutda"].update(active=(st.act.nc, st.act.no, st.act.nv),
                            pcsf=st.selection["pcsf"], timings=st.timings)
    leg.gate((st.act.nc, st.act.no, st.act.nv) == CH2O_SUTDA_ACTIVE,
             f"CH2O+ sU-TDA active space {(st.act.nc, st.act.no, st.act.nv)}")
    leg.gate(st.selection["pcsf"] == CH2O_SUTDA_PCSF,
             f"CH2O+ sU-TDA P-CSF counts {st.selection['pcsf']}")
    leg.gate(stda_coupling.launches > 0, "CH2O+ sU-TDA: K4 not launched")
    out["ch2o"] = leg.close(sigma_ms=lambda: _incore_sigma_ms(make_reference(mf)))
    leg = _Leg("fh")
    mol = Molecule.from_atoms(G.fh, basis="6-31g", spin=2)
    scf = ROKS(mol, xc="bhandhlyp", grid_level=3, device="cuda")
    leg.env(scf)
    mf_pi = leg.scf("roks_aufbau", scf)
    d_e = mf_pi.e_tot - FH_E_SCF_HA
    leg.rec["roks_aufbau"]["de_vs_golden_ha"] = d_e
    leg.gate(abs(d_e) < FH_E_GATE_HA, f"FH aufbau ROKS energy off by {d_e} Ha")
    occ, init = occ_from_irreps(mf_pi, FH_SIGMA_IRREPS)
    mf = leg.scf("roks_sigma", ROKS(mol, xc="bhandhlyp", env=scf.env), occ=occ, init=init)
    a0 = leg.solve("xsf_alda0", lambda: XSFTDA(mf, nstates=4, method=0).kernel())
    leg.near("xsf_alda0", a0.e_eV, FH_XSF_ALDA0_EV, FH_GATE_EV)
    mc = leg.solve("xsf_mcol", lambda: XSFTDA(mf, nstates=4, method=1).kernel())
    leg.near("xsf_mcol", mc.e_eV, FH_XSF_MCOL_EV, FH_GATE_EV)
    leg.near("xsf_mcol_pi_pair", mc.e_eV[1], mc.e_eV[2], FH_PI_PAIR_EV)
    dv = leg.solve("xsf_davidson", lambda: XSFTDA(mf, nstates=4, method=0,
                                                  use_davidson=True).kernel())
    leg.gate(dv.solver == "incore", "use_davidson did not pick the in-core route")
    leg.near("xsf_davidson_vs_dense", dv.e_eV, a0.e_eV, INCORE_VS_DENSE_EV)
    mf0 = leg.scf("uks_aufbau", UKS(mol, xc="bhandhlyp", env=scf.env))
    mfu = leg.scf("uks_sigma", UKS(mol, xc="bhandhlyp", env=scf.env),
                  occ=([0, 1, 2, 3, 4, 5], [0, 1, 3, 4]), init=mf0.mo_coeff)
    r = leg.solve("usf", lambda: XSFTDA(mfu, nstates=4, SA=0, method=0).kernel(remove=False))
    leg.near("usf", r.e_eV, FH_USF_EV, FH_GATE_EV)
    out["fh"] = leg.close()
    leg = _Leg("be")
    scf = ROKS(Molecule.from_atoms("Be 0 0 0", basis="aug-cc-pvtz", spin=2),
               xc="bhandhlyp", grid_level=3, device="cuda")
    leg.env(scf)
    mf = leg.scf("roks", scf)
    r = leg.solve("xsf", lambda: XSFTDA(mf, nstates=10).kernel())
    leg.near("xsf", r.e_eV, BE_XSF_EV, BE_GATE_EV)
    out["be"] = leg.close()
    leg = _Leg("benzene")
    # the library gives benzene's coordinates in bohr (C-C 2.638, C-H 2.053)
    scf = RKS(Molecule.from_atoms(G.benzene, basis="cc-pvdz", unit="bohr"), xc="b3lyp",
              grid_level=3, device="cuda")
    leg.env(scf)
    mf = leg.scf("rks", scf)
    sg = leg.solve("tda_singlet", lambda: TDA(mf, nstates=10).kernel())
    tr = leg.solve("tda_triplet", lambda: TDA(mf, nstates=10, singlet=False).kernel())
    u = leg.solve("utda", lambda: UTDA(mf, nstates=10).kernel())
    leg.gate({sg.solver, tr.solver, u.solver} == {"dense"}, "benzene: not the dense route")
    union = np.sort(np.concatenate([sg.e_eV, tr.e_eV]))[:10]
    # UTDA carries the whole occupied and virtual Fock blocks, TDA their
    # diagonal (both as the JAX builders): the SCF's last Fock off the
    # diagonal in its own orbitals is what separates the two
    ref = make_reference(mf)
    f = ref.fock_a_mo
    no_ = ref.nc
    leg.rec["fock_offdiag_max_ha"] = max(
        float(np.abs(blk - np.diag(np.diag(blk))).max())
        for blk in (f[:no_, :no_], f[no_:, no_:]))
    leg.near("utda_vs_tda_union", u.e_eV, union, UNION_GATE_EV)
    out["benzene"] = leg.close(routes_ms=lambda: _dense_routes_ms(ref))
    return out


def _run_phases(record: dict, t_start: float, out: str | None = None) -> None:
    """Phases 0-13 into ``record``, in the order that lets the later ones
    reuse what the earlier built; the seconds since the start after each."""
    def done(name):
        _log(f"{name} done at {time.perf_counter() - t_start:.1f} s")

    record["card"] = phase0()
    record["builds_s"] = phase1()
    done("phase 1")
    record["kernels"] = phase2()
    done("phase 2")
    record["ttm"], ref = phase3()
    done("phase 3")
    record["ttm_flip"] = phase5(ref)
    done("phase 5")
    k3_ao = [c for c in record["kernels"]["checks"] if c["kernel"] == "grid_back"
             and c["shape"] == "ttm_ao" and c["dtype"] == "float64"][0]
    record["scf"] = phase7(ref.mf, record["ttm"]["e_ev"], k3_ao["ms"])
    done("phase 7")
    record["functionals"] = phase10(ref.mf.env)
    done("phase 10")
    record["tdhf"] = phase11(ref, record["ttm"]["e_ev"])
    done("phase 11")
    record["stability_soc"] = phase12(ref.mf)
    done("phase 12")
    k5 = [c for c in record["kernels"]["checks"] if c["kernel"] == "eri_grad"][0]
    record["gradients"] = phase13(k5["kernel_ms"])
    done("phase 13")
    vectors = None if out is None else pathlib.Path(out).with_name(
        pathlib.Path(out).stem + "_dzp_vectors.npz")
    if vectors is not None:
        vectors.parent.mkdir(parents=True, exist_ok=True)
    phase8(ref, record.setdefault("dzp", {}), vectors)
    done("phase 8")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    record["bench"], data = phase4()
    done("phase 4")
    record["bench_flip"] = phase6(data)
    done("phase 6")
    del data
    gc.collect()
    torch.cuda.empty_cache()
    record["small"] = phase9()
    done("phase 9")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    record = {}
    try:
        _run_phases(record, t_start, args.out)
    finally:
        if args.out:  # every number so far, also when a phase failed
            pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    card = record["card"]

    from xtddft_tpu_torch import kernels

    entries = []
    checks = record["kernels"]["checks"]
    p12 = record["stability_soc"]
    for m in kernels.DF_MODULES:
        # the main path's own shape: TTM, f64, alpha block; K2 and K3 on a jvp
        # group's span
        main_check = [c for c in record["kernels"]["checks"]
                      if c["kernel"] == m.NAME and c["shape"] == "ttm"
                      and c["dtype"] == "float64" and c.get("spin") == "a"
                      and "mode" not in c][-1]
        # the flip mode that phase 5 runs (exchange-only, value-only), where
        # one library call computes the function
        flip_check = [c for c in record["kernels"]["checks"]
                      if c["kernel"] == m.NAME and c["shape"] == "ttm_down"
                      and c["dtype"] == "float64"
                      and c["mode"] in ("exchange_only", "value_only")][-1]
        # the SCF's AO mode (phase 7's Fock build), f64
        ao_check = [c for c in record["kernels"]["checks"]
                    if c["kernel"] == m.NAME and c["shape"] == "ttm_ao"
                    and c["dtype"] == "float64" and c["mode"] in ("ao", "hermi")][0]
        # the production shapes, f64: the dzp X-TDA alpha block (K2 and K3 on
        # a jvp group's span) and the dzp SCF's AO mode
        dzp_check = [c for c in record["kernels"]["checks"]
                     if c["kernel"] == m.NAME and c["shape"] == "dzp" and c.get("spin") == "a"
                     and "mode" not in c][-1]
        dzp_ao_check = [c for c in record["kernels"]["checks"]
                        if c["kernel"] == m.NAME and c["shape"] == "dzp_ao"
                        and c["mode"] in ("ao", "hermi")][0]
        dzp = record["dzp"]
        # phase 9's shapes: the benzene SCF pair (K2 hermitian, K3 AO; K1 has
        # no in-core mode)
        small_check = ([c for c in record["kernels"]["checks"]
                        if c["kernel"] == m.NAME and c["shape"] == "benzene_scf"
                        and c["dtype"] == "float64" and c["mode"] in ("ao", "hermi")] or [{}])[0]
        # the in-core sigma's own modes on CH2O+, f64: K2 masked, K3's value
        # term on the AO table (K1 has no in-core mode)
        sigma_check = ([c for c in record["kernels"]["checks"]
                        if c["kernel"] == m.NAME and c["shape"] == "ch2o_sigma"
                        and c["dtype"] == "float64"
                        and c["mode"] in ("hermi_masked", "ao_value_only")] or [{}])[0]
        # the meta-GGA modes, f64 (K2's tau row, K3's tau term; K1 has none):
        # on the X-TDA span, the flip-down block's five components, the
        # SCF's AO mode and the in-core sigma's masked stack
        def tau_check(shape, modes):
            return ([c for c in record["kernels"]["checks"]
                     if c["kernel"] == m.NAME and c["shape"] == shape
                     and c["dtype"] == "float64" and c.get("mode") in modes] or [{}])[0]

        tau = {"": tau_check("ttm", ("tau",)),
               "flip_": tau_check("ttm_down", ("five_component",)),
               "scf_": tau_check("ttm_ao", ("hermi_tau", "ao_tau")),
               "incore_": tau_check("ch2o_sigma", ("hermi_tau", "ao_tau"))}
        fn = record["functionals"]
        entries.append({
            "name": m.NAME, "route": m.ROUTE, "source": m.SOURCE, "replaces": m.REPLACES,
            "launches": record["ttm"]["launches"][m.NAME],
            "launches_flip": record["ttm_flip"]["launches"][m.NAME],
            **{k: main_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            **{f"flip_{k}": flip_check[k] for k in ("ms", "plain_ms", "bound_ms",
                                                    "library_ms")},
            "scf_replaces": SCF_REPLACES[m.NAME],
            "launches_scf": record["scf"]["launches"][m.NAME],
            "launches_scf_xtda": record["scf"]["xtda"]["launches"][m.NAME],
            **{f"scf_{k}": ao_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")},
            # null where the kernel has no atomic order (K1)
            "scf_fixed_order_cost": ao_check.get("fixed_order_cost"),
            "fixed_order_cost": main_check.get("fixed_order_cost"),
            "launches_dzp_xtda": dzp["xtda"]["launches"][m.NAME],
            "launches_dzp_xsf": dzp["xsf"]["launches"][m.NAME],
            "launches_dzp_scf": dzp["scf"]["launches"][m.NAME],
            "launches_dzp_scf_xtda": dzp["scf_xtda"]["launches"][m.NAME],
            **{f"dzp_{k}": dzp_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
            **{f"dzp_scf_{k}": dzp_ao_check[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                         "bound_ms", "bound_by", "library_ms")},
            "launches_small": {leg: r["launches"][m.NAME] for leg, r in record["small"].items()},
            **{f"benzene_scf_{k}": small_check.get(k) for k in ("max_abs_err", "ms", "plain_ms",
                                                                "bound_ms", "library_ms")},
            **{f"incore_sigma_{k}": sigma_check.get(k) for k in ("mode", "max_abs_err", "ms",
                                                                 "plain_ms", "bound_ms",
                                                                 "library_ms")},
            **{f"tau_{p}{k}": c.get(k) for p, c in tau.items()
               for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                         "fixed_order_cost")},
            # phase 10: per functional, the SCF and its two solves
            "launches_functionals": {f"{xc}_{leg}": (r if leg == "scf" else r[leg])[
                "launches"][m.NAME] for xc, r in fn.items() for leg in ("scf", "xtda", "xsf")},
            "mode_launches_functionals": {
                f"{xc}_{leg}": {k: v for k, v in (r if leg == "scf" else r[leg])[
                    "mode_launches"].items() if k.startswith(m.NAME + ".")}
                for xc, r in fn.items() for leg in ("scf", "xtda", "xsf")},
            # phase 11: the TTM X-TDHF solve
            "launches_xtdhf": record["tdhf"]["xtdhf"]["launches"][m.NAME],
            # phase 12: the TTM stability run and one of its Hessian actions,
            # and the As leg's SCF, stability and each SOC-SI stage
            "launches_stability": p12["ttm_stability"]["launches"][m.NAME],
            "launches_per_hessian_action": p12["ttm_stability"]["action_launches"][m.NAME],
            "launches_socsi_as": {leg: n[m.NAME] for leg, n in p12["as"]["launches"].items()},
            # phase 13: the CH2O+ ROKS SCF of the DFT gradient leg
            "launches_grad_dft_scf": record["gradients"]["dft"]["scf_launches"][m.NAME],
        })
    # K1's RPA exchange mode (phase 11's B half), at the TTM alpha block
    # (nz 20, f64), the bench block (f32) and TTM/dzp's alpha block (f64)
    k1_entry = entries[0]
    k1_entry["launches_rpa_exchange"] = record["tdhf"]["xtdhf"]["mode_launches"][
        "df_exchange.rpa_exchange"]
    for prefix, shape, dname in (("rpa_", "ttm", "float64"), ("rpa_bench_", "bench", "float32"),
                                 ("rpa_dzp_", "dzp", "float64")):
        c = [c for c in checks if c["kernel"] == "df_exchange" and c.get("mode") == "rpa_exchange"
             and c["shape"] == shape and c["dtype"] == dname and c["spin"] == "a"][0]
        k1_entry.update({f"{prefix}{k}": c[k] for k in ("order", "max_abs_err", "ms",
                                                          "plain_ms", "bound_ms", "bound_by",
                                                          "library_ms", "aligned_ms")})
    k1_entry["rpa_aligned_setup_s"] = record["tdhf"]["xtdhf"]["rpa_aligned_s"]
    # K4: the main path's own shape is the final A's alpha block of TTM's
    # sX-TDA (phase 11); the selection's coupling block and the diagonal beside
    from xtddft_tpu_torch.kernels import stda_coupling as k4

    def k4_check(shape):
        return [c for c in checks if c["kernel"] == k4.NAME and c["shape"] == shape
                and c["spin"] == "a"][0]

    main_check = k4_check("ttm_stda_final")
    entries.append({
        "name": k4.NAME, "route": k4.ROUTE, "source": k4.SOURCE, "replaces": k4.REPLACES,
        "launches": record["tdhf"]["stda"]["launches"][k4.NAME],
        "launches_diagonal": record["tdhf"]["stda"]["mode_launches"][f"{k4.NAME}.diagonal"],
        **{k: main_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "kernel_ms", "call_ms")},
        **{f"selection_{k}": k4_check("ttm_stda_selection")[k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "kernel_ms", "call_ms")},
        **{f"diagonal_{k}": k4_check("ttm_stda_diagonal")[k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "kernel_ms", "call_ms")},
        "launches_ch2o_sutda": record["small"]["ch2o"]["launches"][k4.NAME],
    })
    # K5: phase 2's check at CH2O+/cc-pVDZ; its launches in phase 13's
    # gradients (the ROHF X-CIS gradient is the main path's)
    from xtddft_tpu_torch.kernels import eri_grad as k5

    k5c = [c for c in checks if c["kernel"] == k5.NAME][0]
    p13 = record["gradients"]
    entries.append({
        "name": k5.NAME, "route": k5.ROUTE, "source": k5.SOURCE, "replaces": k5.REPLACES,
        "launches": p13["hf"]["launches"][k5.NAME],
        **{k: k5c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "kernel_ms")},
        "launches_hf_gradient": p13["hf"]["launches_hf_gradient"][k5.NAME],
        "launches_scf_gradient": p13["hf"]["launches_scf_gradient"][k5.NAME],
        "launches_dft_gradient": p13["dft"]["launches"][k5.NAME],
    })
    record["total_s"] = time.perf_counter() - t_start
    _log("total seconds", record["total_s"])
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(card["nvidia_smi"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
