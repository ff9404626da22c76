"""ctypes bindings for the native integral engine (xtddft_native/md_eri.cpp).

The engine is compiled from source at first use (`buildlib.build_library`,
``g++ -O3 -fopenmp``) into the gitignored ``build/`` directory; the
committed ``libmd_eri.so`` is never loaded, because it was built for the
CPU it was made on.  If the build fails, this raises.  Conventions match
the JAX package's engine bit for bit (same Hermite recursions, cart2sph
matrices shipped from Python).
"""

from __future__ import annotations

import ctypes

import numpy as np

from xtddft_tpu_torch.buildlib import REPO, build_library
from xtddft_tpu_torch.ints.shell import BasisLayout, cart2sph

SOURCE = REPO / "xtddft_native" / "md_eri.cpp"
_LIB = None


def load():
    """Build (once per source hash) and load the engine."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build_library(
        "md_eri", [SOURCE],
        ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"])
    lib = ctypes.CDLL(str(path))
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    lp = ctypes.POINTER(ctypes.c_long)
    lib.md_eri_3c.argtypes = [
        ctypes.c_int, ip, ip, ip, dp, dp, dp, ip, ctypes.c_int,
        ctypes.c_int, ip, ip, ip, dp, dp, dp, ip, ctypes.c_int, dp, lp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.md_eri_2c.argtypes = [
        ctypes.c_int, ip, ip, ip, dp, dp, dp, ip, ctypes.c_int, dp, lp, dp,
        ctypes.c_double,
    ]
    lib.md_eri_full.argtypes = [
        ctypes.c_int, ip, ip, ip, dp, dp, dp, ip, ctypes.c_int, dp, lp, dp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    _LIB = lib
    return lib


def _pack(layout: BasisLayout):
    shells = layout.shells
    ls = np.array([s.l for s in shells], dtype=np.int32)
    nprim = np.array([len(s.exps) for s in shells], dtype=np.int32)
    prim_off = np.concatenate([[0], np.cumsum(nprim)[:-1]]).astype(np.int32)
    exps = np.concatenate([s.exps for s in shells]).astype(np.float64)
    coefs = np.concatenate([s.coefs for s in shells]).astype(np.float64)
    centers = np.ascontiguousarray(
        np.array([s.center for s in shells], dtype=np.float64)
    )
    ao_off = np.array([s.ao_offset for s in shells], dtype=np.int32)
    return ls, nprim, prim_off, exps, coefs, centers, ao_off


def _c2s_pack():
    mats = [np.ascontiguousarray(cart2sph(l)) for l in range(5)]
    flat = np.concatenate([m.ravel() for m in mats])
    off = np.concatenate([[0], np.cumsum([m.size for m in mats])[:-1]]).astype(
        np.int64
    )
    return flat, off


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def eri_3c_native(layout: BasisLayout, aux: BasisLayout,
                  omega: float = 0.0, prim_eps: float = 1e-15,
                  schwarz_eps: float = 1e-14) -> np.ndarray:
    lib = load()
    ls, nprim, prim_off, exps, coefs, centers, ao_off = _pack(layout)
    lsx, nprimx, prim_offx, expsx, coefsx, centersx, ao_offx = _pack(aux)
    c2s_flat, c2s_off = _c2s_pack()
    nao = layout.nao
    out = np.zeros((aux.nao, nao, nao))
    lib.md_eri_3c(
        len(ls), _ptr(ls, ctypes.c_int), _ptr(nprim, ctypes.c_int),
        _ptr(prim_off, ctypes.c_int), _ptr(exps, ctypes.c_double),
        _ptr(coefs, ctypes.c_double), _ptr(centers, ctypes.c_double),
        _ptr(ao_off, ctypes.c_int), nao,
        len(lsx), _ptr(lsx, ctypes.c_int), _ptr(nprimx, ctypes.c_int),
        _ptr(prim_offx, ctypes.c_int), _ptr(expsx, ctypes.c_double),
        _ptr(coefsx, ctypes.c_double), _ptr(centersx, ctypes.c_double),
        _ptr(ao_offx, ctypes.c_int), aux.nao,
        _ptr(c2s_flat, ctypes.c_double), _ptr(c2s_off, ctypes.c_long),
        _ptr(out, ctypes.c_double), float(omega), float(prim_eps),
        float(schwarz_eps),
    )
    return out


def eri_2c_native(aux: BasisLayout, omega: float = 0.0) -> np.ndarray:
    lib = load()
    lsx, nprimx, prim_offx, expsx, coefsx, centersx, ao_offx = _pack(aux)
    c2s_flat, c2s_off = _c2s_pack()
    out = np.zeros((aux.nao, aux.nao))
    lib.md_eri_2c(
        len(lsx), _ptr(lsx, ctypes.c_int), _ptr(nprimx, ctypes.c_int),
        _ptr(prim_offx, ctypes.c_int), _ptr(expsx, ctypes.c_double),
        _ptr(coefsx, ctypes.c_double), _ptr(centersx, ctypes.c_double),
        _ptr(ao_offx, ctypes.c_int), aux.nao,
        _ptr(c2s_flat, ctypes.c_double), _ptr(c2s_off, ctypes.c_long),
        _ptr(out, ctypes.c_double), float(omega),
    )
    return out


def eri_full_native(layout: BasisLayout, omega: float = 0.0,
                    prim_eps: float = 1e-15,
                    schwarz_eps: float = 1e-14) -> np.ndarray:
    lib = load()
    ls, nprim, prim_off, exps, coefs, centers, ao_off = _pack(layout)
    c2s_flat, c2s_off = _c2s_pack()
    nao = layout.nao
    out = np.zeros((nao, nao, nao, nao))
    lib.md_eri_full(
        len(ls), _ptr(ls, ctypes.c_int), _ptr(nprim, ctypes.c_int),
        _ptr(prim_off, ctypes.c_int), _ptr(exps, ctypes.c_double),
        _ptr(coefs, ctypes.c_double), _ptr(centers, ctypes.c_double),
        _ptr(ao_off, ctypes.c_int), nao, _ptr(c2s_flat, ctypes.c_double),
        _ptr(c2s_off, ctypes.c_long), _ptr(out, ctypes.c_double),
        float(omega), float(prim_eps), float(schwarz_eps),
    )
    return out
