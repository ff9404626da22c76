// K3 `grid_back`: back-projection of a weighted grid response to (occ, vir).
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.back`
// (:525-534) and the back-projection of the spin-flip sigmas (:861-863,
// :873-878, :1113-1132), which compute over grid points g, with
// po_c = phi_o[c, g, o0 + .] and pv_c = phi_v[c, g, v0 + .] (phi_v is phi_o's
// table for a spin-conserving block, the other spin's for a spin-flip block
// of a UKS reference; the o and v ranges of a flip block may overlap):
//
//   F_0[x, g, o] = dwv[x, g] po_0[g, o] + sum_y dwg[x, y, g] po_y[g, o]
//   F_y[x, g, o] = dwg[x, y, g] po_0[g, o]                           (y = 1..3)
//   r[x, o, v]   = sum_c sum_g F_c[x, g, o] pv_c[g, v]
//
// NC = 4 is that (GGA fxc, multicollinear SF kernel); NC = 1 keeps the value
// component alone, r = sum_g dwv po_0 pv_0 (the ALDA0 SF kernel), a quarter
// of the multiply-adds.  With a fifth weight row dwt (meta-GGA, TAU: the
// tau term of `sigma_df.py:531-533`, the flip `:1131-1133` and the AO table's
// `xc/interface.py:112-121`) the gradient factors become
//
//   F_y[x, g, o] = dwg[x, y, g] po_0[g, o] + 1/2 dwt[x, g] po_y[g, o],
//
// which adds 1/2 sum_g dwt sum_y po_y pv_y at 3 FMAs per row and point in
// the transform; K stays 4 x the points.
//
// Bound on an H100: flops.  A GGA back-projection needs only
// r = sum_g [po_0[g, o], E] [G; pv_0[g, v]] per vector, with
// E = sum_y dwg_y po_y[g, o] and G = dwv pv_0[g, v] + sum_y dwg_y pv_y[g, v]:
// about 4*nz*nocc*nvir per grid point (`response/flops.py`; 2.5e10 per
// 4096-point chunk at the bench shape, 0.37 ms at 67 TFLOP/s; 1.06e9 at
// TTM/STO-3G, 0.016 ms); the value-only form needs 2*nz*nocc*nvir; the phi
// chunk (4*gc*nmo) is 0.02 ms of bytes at the bench shape in f32.  The
// NC = 4 design below contracts over 4 components (K = 4*npts, x-independent
// pv operand shared by every vector), twice that minimum; the K = 2*npts form
// needs both operands per vector.  NC = 1 does the minimum, and so does
// NC = 4 with the tau term, whose own least is the four-component sum
// (8*nz*nocc*nvir per point).
//
// Design: one GEMM on the tile core of `gemm_tile.cuh` with M = nz*nocc
// (rows (x, o)), N = nvir and K = NC components x the points of the span:
// each pipeline stage holds, for BK points (8 with NC = 4, 32 with NC = 1:
// the same stage size), the NC po_c[g, o] tiles of the block's rows, the NC
// pv_c[g, v] tiles of its columns and the dwv/dwg values of the few vectors
// x its rows touch.  Once a stage has landed the block rewrites the po
// tiles in place into F_0..F_3 (7 FMAs per row and point, against 4*BN FMAs
// of use), so F never reaches device memory (it would be 4*nz*npts*nocc
// elements, GBs for one jvp group).  A sigma calls it once per point span;
// the point range is split across blocks (atomics into ``out``) when the
// (x, o) x v tiles alone cannot fill the card, as at TTM (nvir 45 is one
// N tile, so F is built once per point); in the fixed-order mode (a
// workspace W given) each split writes its tile to its own slice of W and
// the slices are added to ``out`` in split order, so that the same inputs
// give the bitwise-same sum on every launch (one split stores directly:
// one add per element).  Each table is read in 16-byte
// runs along the orbital index where its strides allow (rows padded per
// vector, columns from an aligned start, see GridBack); else one element at
// a time.
//
// Layout: dwv (nz, gc), dwg (nz, 3, gc; null selects NC = 1) and dwt (nz,
// gc; null: no tau term; only with dwg) contiguous;
// phi_o, phi_v any strided (>= NC, gc, nmo) views (strides oc, og, om and vc,
// vg, vm); out (nz, nocc, nvir) contiguous, accumulated; W (null: atomics)
// holds wcap elements, at least one slice of nz*nocc*nvir.  Launches on the
// caller's stream, allocates nothing, returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

// Rows m = x * noccp + o (o < noccp; rows with o >= nocc are zero), so
// that with noccp a multiple of the vector width a 16-byte run of rows
// never crosses from one trial vector to the next; columns n = shift + v
// start at the aligned column v0 - shift (columns n < shift, padding or
// live occupied columns of the table, are computed and dropped).
template <class Core, int NC, bool TAU>
struct GridBack {
  using T = typename Core::Elem;
  static constexpr bool kReduce = true, kTransform = true, kTile = false;
  static constexpr int BK = Core::BK;
  static constexpr int ND = NC + (TAU ? 1 : 0);  // weight rows: dwv, dwg, dwt
  static_assert(!TAU || NC == 4, "the tau term goes with the gradient term");
  int M, N, nkt, nq, extra;
  const T* dwv;
  const T* dwg;
  const T* dwt;
  const T* phio;
  int64_t oc, og, om;
  const T* phiv;
  int64_t vc, vg, vm;
  int gc, nz, nocc, noccp, nvir, o0, v0, shift;
  int NX;  // vectors x one row tile can touch
  bool veco, vecv;
  T* out;
  T* W;  // this launch's slices of the workspace (null: atomics into out)

  // stage: A slices [c][k][m] (po_c[g, o], rewritten into F_c), B slices
  // [c][k][n] (pv_c[g, v]), then dw[(c * BK + k) * NX + xi] for the ND
  // weight rows
  __device__ void load(T* stage, int, int kt, int m0, int n0) const {
    const int g0 = kt * BK, gc_ = gc, nz_ = nz, nocc_ = nocc, noccp_ = noccp, N_ = N;
    const int64_t og_ = og, om_ = om, vg_ = vg, vm_ = vm;
    const int oo = o0, va = v0 - shift;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const T* po = phio + c * oc;
      const T* pv = phiv + c * vc;
      Core::template copy<gt::KMAJOR, Core::BM, Core::LDA>(
          stage + c * Core::A_SLICE, veco, phio, [&](int r, int k, int w) -> gt::Run<T> {
            const int m = m0 + r, g = g0 + k;
            const int x = m / noccp_, o = m - x * noccp_;
            return {po + (int64_t)g * og_ + (int64_t)(oo + o) * om_,
                    g < gc_ && x < nz_ ? max(0, min(w, nocc_ - o)) : 0};
          });
      Core::template copy<gt::KMAJOR, Core::BN, Core::LDB>(
          stage + Core::A_ELEMS + c * Core::B_SLICE, vecv, phiv,
          [&](int r, int k, int w) -> gt::Run<T> {
            const int n = n0 + r, g = g0 + k;
            return {pv + (int64_t)g * vg_ + (int64_t)(va + n) * vm_,
                    g < gc_ ? max(0, min(w, N_ - n)) : 0};
          });
    }
    T* dw = stage + Core::AB_ELEMS;
    const int x0 = m0 / noccp_;
    for (int i = threadIdx.x; i < ND * BK * NX; i += Core::NT) {
      const int k = i % BK, rest = i / BK;
      const int c = rest % ND, xi = rest / ND;
      const int x = x0 + xi, g = g0 + k;
      const bool ok = x < nz_ && g < gc_;
      const T* src = c == 0   ? dwv + (int64_t)x * gc_ + g
                     : c == 4 ? dwt + (int64_t)x * gc_ + g
                              : dwg + ((int64_t)x * 3 + c - 1) * gc_ + g;
      gt::cp_async_elem(dw + (c * BK + k) * NX + xi, ok ? src : dwv, ok);
    }
  }

  __device__ void transform(T* stage, int, int, int m0) const {
    const T* dw = stage + Core::AB_ELEMS;
    const int x0 = m0 / noccp;
    for (int i = threadIdx.x; i < BK * Core::BM; i += Core::NT) {
      const int k = i / Core::BM, r = i - k * Core::BM;
      const int m = m0 + r;
      if (m >= M) continue;  // zero-filled rows stay zero
      const int xi = m / noccp - x0;
      T* f = stage + k * Core::LDA + r;
      if constexpr (NC == 1) {
        f[0] *= dw[k * NX + xi];
      } else {
        constexpr int S = Core::A_SLICE;
        const T p0 = f[0], p1 = f[S], p2 = f[2 * S], p3 = f[3 * S];
        const T d0 = dw[k * NX + xi], d1 = dw[(BK + k) * NX + xi];
        const T d2 = dw[(2 * BK + k) * NX + xi], d3 = dw[(3 * BK + k) * NX + xi];
        f[0] = d0 * p0 + d1 * p1 + d2 * p2 + d3 * p3;
        if constexpr (TAU) {
          const T h = T(0.5) * dw[(4 * BK + k) * NX + xi];
          f[S] = d1 * p0 + h * p1;
          f[2 * S] = d2 * p0 + h * p2;
          f[3 * S] = d3 * p0 + h * p3;
        } else {
          f[S] = d1 * p0;
          f[2 * S] = d2 * p0;
          f[3 * S] = d3 * p0;
        }
      }
    }
  }

  __device__ void store(int, int m, int n, T v) const {
    const int x = m / noccp, o = m - x * noccp;
    if (o >= nocc || n < shift) return;
    const int64_t i = ((int64_t)x * nocc + o) * nvir + n - shift;
    if (W != nullptr)
      W[blockIdx.y * (int64_t)nz * nocc * nvir + i] = v;
    else
      atomicAdd(&out[i], v);
  }
};

template <typename T, int NC, bool TAU>
int launch_nc(const T* dwv, const T* dwg, const T* dwt, const T* phio, long long oc, long long og,
              long long om, const T* phiv, long long vc, long long vg, long long vm, int gc,
              int nz, int nocc, int nvir, int o0, int v0, T* out, T* W, int64_t wcap,
              void* stream) {
  // the same stage size in both modes: NC slices of 32 / NC points
  using Core = gt::Core<T, 32 / NC, NC, 3>;
  constexpr int V = Core::VEC;
  // 16-byte runs along the orbital index of each table
  const bool veco = om == 1 && o0 % V == 0 && gt::aligned16(phio, {og, oc});
  const bool vecv = vm == 1 && gt::aligned16(phiv, {vg, vc});
  const int noccp = veco ? (nocc + V - 1) / V * V : nocc;
  const int shift = vecv ? v0 % V : 0;
  const int nx = std::min(nz, (Core::BM - 1) / noccp + 2);
  using P = GridBack<Core, NC, TAU>;
  const int extra = (P::ND * Core::BK * nx + V - 1) / V * V;  // keeps each stage 16-byte aligned
  const P p{nz * noccp, shift + nvir, (gc + Core::BK - 1) / Core::BK, 1, extra,
            dwv, dwg, dwt, phio, oc, og, om, phiv, vc, vg, vm, gc, nz, nocc, noccp,
            nvir, o0, v0, shift, nx, veco, vecv, out, nullptr};
  return (int)gt::launch_fixed<Core>(p, W, wcap, (int64_t)nz * nocc * nvir, out,
                                     reinterpret_cast<cudaStream_t>(stream));
}

template <typename T>
int launch(const T* dwv, const T* dwg, const T* dwt, const T* phio, long long oc, long long og,
           long long om, const T* phiv, long long vc, long long vg, long long vm, int gc, int nz,
           int nocc, int nvir, int o0, int v0, T* out, T* W, long long wcap, void* stream) {
  if (nz <= 0 || nocc <= 0 || nvir <= 0 || gc <= 0 || (dwt != nullptr && dwg == nullptr) ||
      (W != nullptr && wcap < (int64_t)nz * nocc * nvir))
    return (int)cudaErrorInvalidValue;
  // a null dwg is the value-only mode, a null dwt the one without tau
  if (dwt != nullptr)
    return launch_nc<T, 4, true>(dwv, dwg, dwt, phio, oc, og, om, phiv, vc, vg, vm, gc, nz, nocc,
                                 nvir, o0, v0, out, W, wcap, stream);
  if (dwg != nullptr)
    return launch_nc<T, 4, false>(dwv, dwg, dwt, phio, oc, og, om, phiv, vc, vg, vm, gc, nz, nocc,
                                  nvir, o0, v0, out, W, wcap, stream);
  return launch_nc<T, 1, false>(dwv, dwg, dwt, phio, oc, og, om, phiv, vc, vg, vm, gc, nz, nocc,
                                nvir, o0, v0, out, W, wcap, stream);
}

}  // namespace

extern "C" {

int grid_back_f64(const double* dwv, const double* dwg, const double* dwt, const double* phio,
                  long long oc, long long og, long long om, const double* phiv, long long vc,
                  long long vg, long long vm, int gc, int nz, int nocc, int nvir, int o0, int v0,
                  double* out, double* W, long long wcap, void* stream) {
  return launch<double>(dwv, dwg, dwt, phio, oc, og, om, phiv, vc, vg, vm, gc, nz, nocc, nvir,
                        o0, v0, out, W, wcap, stream);
}

int grid_back_f32(const float* dwv, const float* dwg, const float* dwt, const float* phio,
                  long long oc, long long og, long long om, const float* phiv, long long vc,
                  long long vg, long long vm, int gc, int nz, int nocc, int nvir, int o0, int v0,
                  float* out, float* W, long long wcap, void* stream) {
  return launch<float>(dwv, dwg, dwt, phio, oc, og, om, phiv, vc, vg, vm, gc, nz, nocc, nvir,
                       o0, v0, out, W, wcap, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
