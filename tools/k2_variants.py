"""Where K2 `grid_rho1` spends its time, on a GPU: the kernel as built, and
copies of it with parts of the tile epilogue switched off.

    python3 tools/k2_variants.py [--out PATH]

Builds `xtddft_tpu_torch/csrc/grid_rho1.cu` four times into
``build/k2_variants/`` (one nvcc each, all at once): as it is (``base``),
with the epilogue skipped after the GEMM (``no_epilogue``: the accumulators
are kept live, the output stays zero), with the epilogue's 16-byte table
copies skipped (``no_table_copy``: it reads whatever shared memory holds;
every shape below takes 16-byte copies) and, in f64, without the tile
core's row permutation (``no_row_perm``: plain fragment loads, the
epilogue's groups are then the wrong rows).  Then, at
the main path's K2 shapes (TTM/STO-3G and the nmo=1000 bench operator, X-TDA
span and chunk, the flip value-only modes), it calls each build through the
port's wrapper and prints, per build and shape, the device time of each GEMM
instantiation (``NE``: the epilogue's table components) from
``torch.profiler``, averaged over 10 calls, the host-clock time per call, and
the error of ``base`` against the plain version.  The variants compute
nothing useful: they only bound what the parts they drop cost.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (name, [(source file, text of it, its replacement), ...])
_SKIP_EPILOGUE = ("    {\n      T t = T(0);\n"
                  "      for (int k = 0; k < Core::ACC; ++k) t += acc[k];\n"
                  "      if (t == T(-1.2345e300)) out[threadIdx.x] = t;\n      return;\n    }\n")
_TABLE_COPY = "    if (vecE) {\n#pragma unroll\n      for (int it = 0; it < BN * W / NT; ++it) {"
_PERM_ASSERT = '    static_assert(PERM, "f64 groups need the row permutation (Core\'s PERM_)");\n'
_K2_CORE = "gt::Core<T, 16, 1, 3, gt::NMAJOR, true>"
VARIANTS = (
    ("base", []),
    ("no_epilogue", [("grid_rho1.cu", "    T* red = smem + BN * LDT;\n",
                      _SKIP_EPILOGUE + "    T* red = smem + BN * LDT;\n")]),
    ("no_table_copy", [("grid_rho1.cu", _TABLE_COPY,
                        "    if (false) {\n    } else" + _TABLE_COPY[3:])]),
    ("no_row_perm", [("grid_rho1.cu", _K2_CORE, _K2_CORE.replace("true", "false")),
                     ("gemm_tile.cuh", _PERM_ASSERT, "")]),
)

# (label, dtype, nz, nmo, nocc, v0, nvir, points, ncomp, masked); o0 = 0
CASES = (
    ("ttm_xtda_span", torch.float64, 10, 182, 137, 137, 45, 23 * 4096, 4, True),
    ("ttm_xtda_chunk", torch.float64, 10, 182, 137, 137, 45, 4096, 4, True),
    ("bench_xtda_span_f32", torch.float32, 20, 1000, 80, 80, 920, 12 * 4096, 4, True),
    ("bench_xtda_chunk_f64", torch.float64, 20, 1000, 80, 80, 920, 4096, 4, True),
    ("ttm_down_value", torch.float64, 10, 182, 137, 136, 46, 187644, 1, False),
    ("bench_down_value_f32", torch.float32, 10, 1000, 80, 78, 922, 49152, 1, False),
    ("bench_down_value_f64", torch.float64, 10, 1000, 80, 78, 922, 49152, 1, False),
)


def build() -> dict:
    from xtddft_tpu_torch.kernels import _cuda, grid_rho1 as k2

    out = ROOT / "build" / "k2_variants"
    procs = {}
    for name, edits in VARIANTS:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in ("grid_rho1.cu", "gemm_tile.cuh"):
            src = (_cuda.CSRC / f).read_text()
            for target, old, new in edits:
                if target == f:
                    if old not in src:
                        raise SystemExit(f"k2_variants: {name}: {f} no longer has the text to "
                                         "replace")
                    src = src.replace(old, new)
            (d / f).write_text(src)
        lib = d / "libgrid_rho1.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(d / "grid_rho1.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k2_variants: building {name} failed:\n{log[-3000:]}")
        L = ctypes.CDLL(str(lib))
        for sfx in ("f32", "f64"):
            fn = getattr(L, f"grid_rho1_{sfx}")
            fn.argtypes = k2._ARGS
            fn.restype = ctypes.c_int
        L.xk_error_string.argtypes = [ctypes.c_int]
        L.xk_error_string.restype = ctypes.c_char_p
        libs[name] = L
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: needs a CUDA device")
    from xtddft_tpu_torch.kernels import _cuda, grid_rho1 as k2

    libs = build()
    g = torch.Generator("cuda").manual_seed(0)
    recs = []
    for label, dt, nz, nmo, nocc, v0, nvir, npts, ncomp, masked in CASES:
        phi = torch.randn((4, npts, nmo), generator=g, device="cuda", dtype=dt) / nmo ** 0.5
        z = torch.randn((nz, nocc, nvir), generator=g, device="cuda", dtype=dt)
        mask = (torch.rand(npts, generator=g, device="cuda") > 0.05).to(dt) if masked else None
        want = k2.grid_rho1_plain(phi, z, 0, v0, mask, None, ncomp)
        for name, lib in libs.items():
            _cuda._LIBS[k2.NAME] = lib

            def call():
                return k2.grid_rho1(phi, z, 0, v0, mask, None, ncomp)

            err = float((call() - want).abs().max() / want.abs().max())
            call()
            torch.cuda.synchronize()
            n = 10
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / n * 1e3
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
            gemm = {}
            for e in prof.key_averages():
                m = re.search(r"Rho1Gemm<gt::Core<[^>]*>,\s*(\d+)\s*>", e.key)
                t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                if m and t > 0:
                    gemm[f"NE{m.group(1)}"] = gemm.get(f"NE{m.group(1)}", 0.0) + t / n / 1e3
            rec = {"shape": label, "variant": name, "device_ms": gemm,
                   "device_total_ms": sum(gemm.values()), "host_ms_per_call": host_ms,
                   "rel_err": err if name == "base" else None}
            print(json.dumps(rec), flush=True)
            recs.append(rec)
        del phi, z, mask, want
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
