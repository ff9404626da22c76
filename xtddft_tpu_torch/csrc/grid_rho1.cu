// K2 `grid_rho1`: transition density, and optionally its gradient, on a span
// of grid points.
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.rho1`
// (:495-508) and the transition density of the spin-flip sigmas (:857-867,
// :1105-1120), which compute with po_c = phi_o[c, g, o0 + .] and
// pv_c = phi_v[c, g, v0 + .] (c = value, d/dx, d/dy, d/dz of the MOs on the
// grid; phi_v is phi_o's table for a spin-conserving block, the other spin's
// for a spin-flip block of a UKS reference; the o and v ranges may overlap):
//
//   rho1[x, 0, g] = sum_ov z[x, o, v] po_0[g, o] pv_0[g, v]
//   rho1[x, y, g] = sum_ov z[x, o, v] (po_y[g, o] pv_0[g, v] + po_0[g, o] pv_y[g, v])
//
// masked to zero where the ground-state density is negligible (no mask: the
// spin-flip kernel that multiplies rho1 next is itself zero there).  NC = 4
// gives all four rows (GGA, multicollinear SF kernel); NC = 1 the value row
// alone (the ALDA0 SF kernel); NC = 5 adds the meta-GGA row (`sigma_df.py:
// 505-507`, the flip `:1121-1124`), the transition kinetic-energy density
//
//   rho1[x, 4, g] = 1/2 sum_y sum_ov z[x, o, v] po_y[g, o] pv_y[g, v].
//
// The hermitian mode computes the SCF's density on the grid
// (`xtddft_tpu/xc/interface.py:53` `cache_rho`): one table on both sides,
// o0 = v0, nocc = nvir, and z symmetric (density matrices in the AO
// basis).  Then sum_v u pv_y = sum_o tmp po_y, so the tmp GEMM alone gives
// every row: rho1_0 = sum_o tmp po_0 and rho1_y = 2 sum_o tmp po_y, one
// GEMM where the general mode runs two.  The caller vouches for the
// symmetry of z; nothing here checks it.
//
// Bound on an H100: flops, the GGA minimum of `response/flops.py`:
//   tmp[x, o, g] = sum_v z[x, o, v] pv_0[g, v]   (2*nz*nocc*nvir per point)
//   u[x, v, g]   = sum_o z[x, o, v] po_0[g, o]   (the same)
// give every row, rho1_0 = sum_o tmp po_0, rho1_y = sum_o tmp po_y +
// sum_v u pv_y, with a few multiply-adds per orbital besides (2.5e10 per
// 4096-point chunk at the bench shape, 0.37 ms at 67 TFLOP/s); the value
// row alone needs one of them and its dot with the table.  The JAX code
// materializes tmp[x, g, o] and tmp2[x, y, g, o] in device memory; here
// nothing of size nz*npts*norb leaves the chip.
//
// Design: the two GEMMs on the tile core of `gemm_tile.cuh`, each with its
// contraction against the MO table in a tile epilogue:
//   - tmp: M = rows (x, o), N = the points of the span, K = v, B = pv_0 read
//     along its rows (n-major in shared memory); epilogue: rho1[x, c, g] +=
//     sum_o tmp[x, o, g] po_c[g, o] for the gradient rows c = 1..3;
//   - u: M = rows (x, v), N = points, K = o, B = po_0; epilogue:
//     rho1[x, c, g] += sum_v u[x, v, g] pv_c[g, v], c = 1..3;
//   - the value row c = 0 rides with the GEMM of fewer rows (u when nvir <
//     nocc, as at TTM; tmp at the bench width), since the epilogue's cost
//     goes with M; the value row alone is that one GEMM.
//   - the tau row (NC = 5): three more GEMMs tmp_y = z . pv_y on the A
//     operand of tmp (M = rows (x, o), K = v, B = pv_y), each with a
//     one-component epilogue rho1[x, 4, g] += 1/2 sum_o tmp_y po_y: 6 more
//     multiply-adds per (x, o, v) and point, the least the row needs (the
//     GGA minimum's 4*nz*nocc*nvir flops per point become 10).  In the
//     hermitian mode the same three run on the AO table (D . phi_y, dotted
//     with phi_y).
// An epilogue streams one component at a time: it copies the table tile
// T_c[g, orbital of row] of its BN points and BM rows into shared memory,
// sums C * T_c over groups of rows (`dot_groups`: a thread's 4 rows in f32,
// a lane pair's 8 in f64, which the core's row permutation makes
// consecutive), then each thread walks the groups of one point,
// adding the sum of each trial vector's rows into the zeroed output with
// one atomic (times the mask) when the vector changes; tiles of the other
// rows and splits of the k range add likewise.  The next component's copy
// flies during the walk.  In the fixed-order mode (a workspace W given) the
// walk stores each sum in its own slot instead, one per split, vector and
// half row tile (64 or 32 rows) the vector spans, and a second kernel adds
// the slots in a fixed order: the same inputs then give the bitwise-same
// density on every launch (the SCF's energy test sits at the rounding of
// these sums).
// The rows of each trial vector are padded to a multiple of the group (R),
// so that no group and no 16-byte run crosses two vectors, and start at a
// shifted orbital (the shift zero rows of A), so that the table's runs
// along the orbital index start aligned; the same shift on k lets B's runs
// start aligned.  The wrapper lays z out as both A operands (k-major, one
// zero-padded copy each, small beside the tables).  Where a table's
// strides rule out 16-byte runs (f32 with nmo 182), its copies go one
// element at a time.  With K short (TTM: 46 for tmp, 137 for u) a block
// runs a few k steps, then up to four epilogue components, each a copy
// round trip and two barriers, and at TTM f64 the epilogue takes about
// twice as long as the GEMM on the H100 (PERF.md); its table tile is read
// once per row tile, so once per trial vector.
//
// Layout: phi_o and phi_v are any strided (>= min(NC, 4), gc, nmo) views (strides
// oc, og, om and vc, vg, vm); za (for tmp and tau, else null) is [sv + nvir][nz *
// ra] with za[sv + v][x * ra + so + o] = z[x, o, v] and zeros elsewhere; zb
// (for u, else null) is [so + nocc][nz * rb] with zb[so + o][x * rb + sv +
// v] = z[x, o, v]; ra >= so + nocc and rb >= sv + nvir are multiples of the
// row group (4 in f32, 8 in f64), so <= o0 and sv <= v0 the shifts; vu puts
// the value row on u; hermi selects the hermitian mode (za alone, phio ==
// phiv); mask (gc,) holds 0/1 in the working type, or is null; out (nz, NC,
// gc) is accumulated (the caller zeroes it); W (null: atomics) holds wcap
// elements, at least one split's slots.  Launches on the caller's stream,
// allocates nothing, returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

// One of the two GEMMs.  Row m = x * R + i of A stands for orbital i of
// the epilogue's table from E (rows i >= nrow are zero, as are the leading
// shift rows, whose orbitals the table holds all the same); k for column k
// of B's table row from Bt.  Accumulator row p of a tile holds row
// m0 + Core::perm(p), and the table tile's row p is that row's orbital.
template <class Core, int NE>
struct Rho1Gemm {
  using T = typename Core::Elem;
  static constexpr bool kReduce = true, kTransform = false, kTile = true;
  static constexpr int BM = Core::BM, BN = Core::BN, NT = Core::NT, V = Core::VEC;
  static constexpr int RG = Core::RG, NG = Core::NG;
  static constexpr int LDT = BM + V;                    // table tile [n][LDT]
  static constexpr int LDR = BN + 64 / (int)sizeof(T);  // group sums [q][LDR]
  // shared memory of the epilogue, over the stages' (which the GEMM no
  // longer reads): one table tile and the group sums.  A second table tile
  // (f64, whose blocks have room for it) to copy the next component into
  // during the whole of this one's work, or the next tile's first component
  // during the GEMM, ran no faster on the H100 (PERF.md).
  static constexpr int EPI = BN * LDT + NG * LDR;
  static_assert(NT == 2 * BN && NG % 2 == 0, "two threads per point in the walk");
  static_assert(NT % BM == 0, "a thread copies table entries of one row");
  int M, N, nkt, nq, extra, epi;
  const T* A;  // [K][lda]
  int lda, K;
  const T* Bt;  // B(k, n) = Bt[n * bg + k * bk]
  int64_t bg, bk;
  const T* E;  // table c of the epilogue at E[c * ec + n * eg + i * em]
  int64_t ec, eg, em;
  int R, nrow, nz, ncomp, c0;  // output rows c0 .. c0 + NE - 1 of ncomp
  T gf;                        // factor of the gradient rows (2 in the hermitian mode)
  bool vecA, vecB, vecE;
  const T* mask;
  T* out;
  T* W;   // fixed-order slots [split][x][J][NE][N] (null: atomics into out)
  int J;  // slots per vector: the half row tiles it can span

  __device__ void load(T* stage, int, int kt, int m0, int n0) const {
    const int k0 = kt * Core::BK, M_ = M, N_ = N, K_ = K, lda_ = lda;
    const T* A_ = A;
    const T* B_ = Bt;
    const int64_t bg_ = bg, bk_ = bk;
    Core::template copy<gt::KMAJOR, BM, Core::LDA>(
        stage, vecA, A_, [&](int r, int k, int w) -> gt::Run<T> {
          const int m = m0 + r, kk = k0 + k;
          return {A_ + (int64_t)kk * lda_ + m, kk < K_ ? max(0, min(w, M_ - m)) : 0};
        });
    Core::template copy<gt::NMAJOR, BN, Core::LDB>(
        stage + Core::A_ELEMS, vecB, B_, [&](int r, int k, int w) -> gt::Run<T> {
          const int n = n0 + r, kk = k0 + k;
          return {B_ + (int64_t)n * bg_ + (int64_t)kk * bk_,
                  n < N_ ? max(0, min(w, K_ - kk)) : 0};
        });
  }

  // T_c[n][p] = E_c[n0 + n, orbital of tile row p], zero past the real rows.
  // Every copy of a thread falls on one tile row p (and run), whose orbital
  // i and real length cnt (0: no real orbital) the caller worked out; the
  // threads of a warp read consecutive runs, as in Core::copy.
  __device__ void load_table(T* ts, int c, int n0, int p, int i, int cnt) const {
    const T* src = E + c * ec + (int64_t)i * em;
    const int64_t eg_ = eg;
    const int N_ = N;
    constexpr int W = BM / V;  // 16-byte runs per table row
    if (vecE) {
#pragma unroll
      for (int it = 0; it < BN * W / NT; ++it) {
        const int n = (threadIdx.x + it * NT) / W;
        const int k = n0 + n < N_ ? cnt : 0;
        gt::cp_async_16(ts + n * LDT + p, k > 0 ? src + (n0 + n) * eg_ : E, k);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < BN * BM / NT; ++it) {
        const int n = (threadIdx.x + it * NT) / BM;
        const int k = n0 + n < N_ ? cnt : 0;
        gt::cp_async_elem(ts + n * LDT + p, k > 0 ? src + (n0 + n) * eg_ : E, k);
      }
    }
    gt::cp_async_commit();
  }

  // the thread's table row (a run of V rows, or one row): its tile row p,
  // its orbital i and its real length cnt
  __device__ void table_row(int m0, int& p, int& i, int& cnt) const {
    const int r = vecE ? threadIdx.x % (BM / V) * V : threadIdx.x % BM;  // logical
    p = Core::perm(r);
    const int m = m0 + r, x = m / R;
    i = m - x * R;
    cnt = x < nz ? max(0, min(vecE ? V : 1, nrow - i)) : 0;
  }

  __device__ void finish(const T (&acc)[Core::ACC], T* smem, int m0, int n0) const {
    T* red = smem + BN * LDT;
    int p, i, cnt;
    table_row(m0, p, i, cnt);
    // the walk: thread (n, half) sums groups half * NG/2 .. of point n0 + n;
    // vectors change every R / RG groups, first after nb of them
    constexpr int QH = NG / 2;
    const int n = threadIdx.x % BN, half = threadIdx.x / BN;
    const bool live = n0 + n < N;
    const T mk = live && mask != nullptr ? mask[n0 + n] : T(1);
    const int gpv = R / RG, q0 = m0 / RG + half * QH;
    const int x0 = q0 / gpv, nb0 = (x0 + 1) * gpv - q0;
    load_table(smem, 0, n0, p, i, cnt);
#pragma unroll 1
    for (int c = 0; c < NE; ++c) {
      gt::cp_async_wait<0>();
      __syncthreads();  // T_c landed; the last walk no longer reads red
      Core::template dot_groups<LDT>(acc, smem, [&](int q, int cc, T s) { red[q * LDR + cc] = s; });
      __syncthreads();  // red complete; the table tile free
      if (c + 1 < NE) load_table(smem, c + 1, n0, p, i, cnt);
      if (!live) continue;
      T* o = out + (int64_t)(c0 + c) * N + n0 + n;
      const int64_t xs = (int64_t)ncomp * N;
      const T f = c0 + c > 0 ? mk * gf : mk;
      // the sum of vector x's rows in this half tile (hs: the half tile's
      // index over all rows; a vector's slots start at its first)
      const int hs = q0 / QH;
      auto put = [&](int x, T v) {
        if (x >= nz) return;
        if (W != nullptr)
          W[(((int64_t)(blockIdx.y * nz + x) * J + hs - x * gpv / QH) * NE + c) * N + n0 + n] = v;
        else
          atomicAdd(o + x * xs, v);
      };
      int x = x0, nb = nb0;
      T s = T(0);
#pragma unroll
      for (int j = 0; j < QH; ++j) {
        if (j == nb) {
          put(x, s * f);
          ++x;
          nb += gpv;
          s = T(0);
        }
        s += red[(half * QH + j) * LDR + n];
      }
      put(x, s * f);
    }
  }
};

// out[x, c0 + c, n] += the sum over splits s and slots j < cnt(x) of
// W[s][x][j][c][n], in that order, for the cnt(x) half row tiles vector x
// spans: the fixed-order sum of the walks' slots
template <typename T>
__global__ void __launch_bounds__(256)
    sum_slots_kernel(const T* __restrict__ W, int ns, int nz, int J, int ne, int N, int gpv,
                     int qh, int ncomp, int c0, T* __restrict__ out) {
  const int64_t total = (int64_t)nz * ne * N;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int n = (int)(e % N);
    const int r = (int)(e / N), c = r % ne, x = r / ne;
    const int first = x * gpv / qh, cnt = ((x + 1) * gpv - 1) / qh - first + 1;
    T s = T(0);
    for (int k = 0; k < ns; ++k)
      for (int j = 0; j < cnt; ++j) s += W[(((int64_t)(k * nz + x) * J + j) * ne + c) * N + n];
    out[((int64_t)x * ncomp + c0 + c) * N + n] += s;
  }
}

template <typename T, int NE>
cudaError_t launch_gemm(const T* A, int lda, int K, int M, int N, const T* Bt, int64_t bg,
                        int64_t bk, const T* E, int64_t ec, int64_t eg, int64_t em, int R,
                        int nrow, int nz, int ncomp, int c0, T gf, const T* mask, T* out, T* W,
                        int64_t wcap, cudaStream_t stream) {
  using Core = gt::Core<T, 16, 1, 3, gt::NMAJOR, true>;
  using P = Rho1Gemm<Core, NE>;
  constexpr int QH = Core::NG / 2;
  // 16-byte runs: A along its rows, B along k, the table along the orbitals
  const bool vecA = gt::aligned16(A, {lda});
  const bool vecB = bk == 1 && gt::aligned16(Bt, {bg});
  const bool vecE = em == 1 && gt::aligned16(E, {eg, ec});
  const int gpv = R / Core::RG, J = (gpv - 1) / QH + 2;
  const int64_t slots = (int64_t)nz * J * NE * N;  // one split's
  const P p{M, N, (K + Core::BK - 1) / Core::BK, 1, 0, P::EPI, A, lda, K, Bt, bg, bk, E, ec, eg,
            em, R, nrow, nz, ncomp, c0, gf, vecA, vecB, vecE, mask, out, W, J};
  gt::Split sp;
  cudaError_t err = gt::plan<Core>(p, W != nullptr ? wcap / slots : 65535, sp);
  if (err == cudaSuccess) err = gt::run<Core>(p, sp, stream);
  if (err != cudaSuccess || W == nullptr) return err;
  const int64_t blocks = std::min<int64_t>(((int64_t)nz * NE * N + 255) / 256, 65535);
  sum_slots_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(W, (int)sp.split, nz, J, NE, N, gpv,
                                                            QH, ncomp, c0, out);
  return cudaGetLastError();
}

// the GEMM of one A operand, its epilogue over ne = 1, 3 or 4 table components
template <typename T>
cudaError_t launch_side(int ne, const T* A, int lda, int K, const T* Bt, int64_t bg, int64_t bk,
                        const T* E, int64_t ec, int64_t eg, int64_t em, int R, int nrow, int gc,
                        int nz, int ncomp, int c0, T gf, const T* mask, T* out, T* W,
                        int64_t wcap, cudaStream_t stream) {
  const int M = nz * R;
  if (ne == 1)
    return launch_gemm<T, 1>(A, lda, K, M, gc, Bt, bg, bk, E, ec, eg, em, R, nrow, nz, ncomp, c0,
                             gf, mask, out, W, wcap, stream);
  if (ne == 3)
    return launch_gemm<T, 3>(A, lda, K, M, gc, Bt, bg, bk, E, ec, eg, em, R, nrow, nz, ncomp, c0,
                             gf, mask, out, W, wcap, stream);
  return launch_gemm<T, 4>(A, lda, K, M, gc, Bt, bg, bk, E, ec, eg, em, R, nrow, nz, ncomp, c0,
                           gf, mask, out, W, wcap, stream);
}

// One GEMM per operand given: za gives tmp (rows x * ra + i <-> po_c[.,
// o0 - so + i], k over the columns v0 - sv .. of pv_0), zb gives u (rows
// x * rb + i <-> pv_c[., v0 - sv + i], k over the columns o0 - so .. of
// po_0).  The value row rides with u when vu, else with tmp; the gradient
// rows with both.  The hermitian mode (one table, o0 == v0, nocc == nvir,
// z symmetric) runs tmp alone over every row, its gradient rows doubled.
// ncomp = 5 then runs tmp_y = za . pv_y for y = 1..3 into row 4, each with
// po_y in its epilogue and the factor 1/2 (in both modes).
template <typename T>
int launch(const T* phio, long long oc, long long og, long long om, const T* phiv, long long vc,
           long long vg, long long vm, int gc, const T* za, int ra, const T* zb, int rb, int so,
           int sv, int nz, int nocc, int nvir, int o0, int v0, int ncomp, int vu, int hermi,
           const T* mask, T* out, T* W, long long wcap, void* stream) {
  constexpr int RG = gt::Core<T, 16, 1, 3, gt::NMAJOR, true>::RG;
  const int ng = ncomp < 4 ? ncomp : 4;  // the value and gradient rows
  const bool tmp = hermi || ng == 4 || !vu, u = !hermi && (ng == 4 || vu);
  if (nz <= 0 || nocc <= 0 || nvir <= 0 || gc <= 0 ||
      (ncomp != 1 && ncomp != 4 && ncomp != 5) ||
      (hermi && (vu || phio != phiv || o0 != v0 || nocc != nvir)) ||
      so < 0 || so > o0 || sv < 0 || sv > v0 ||
      (tmp && (za == nullptr || ra % RG != 0 || ra < so + nocc)) ||
      (u && (zb == nullptr || rb % RG != 0 || rb < sv + nvir)) ||
      (int64_t)nz * std::max(tmp ? ra : 0, u ? rb : 0) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const T* po = phio + (o0 - so) * om;
  const T* pv = phiv + (v0 - sv) * vm;
  cudaError_t err = cudaSuccess;
  if (tmp) {
    const int y0 = vu ? 1 : 0;  // the first table component of the epilogue
    err = launch_side<T>(ng - y0, za, nz * ra, sv + nvir, pv, vg, vm, po + y0 * oc, oc, og, om,
                         ra, so + nocc, gc, nz, ncomp, y0, T(hermi ? 2 : 1), mask, out, W, wcap,
                         st);
  }
  if (u && err == cudaSuccess) {
    const int y0 = vu ? 0 : 1;
    err = launch_side<T>(ng - y0, zb, nz * rb, so + nocc, po, og, om, pv + y0 * vc, vc, vg, vm,
                         rb, sv + nvir, gc, nz, ncomp, y0, T(1), mask, out, W, wcap, st);
  }
  // the tau row: tmp_y = za . pv_y, dotted with po_y, times 1/2
  for (int y = 1; ncomp == 5 && y <= 3 && err == cudaSuccess; ++y)
    err = launch_side<T>(1, za, nz * ra, sv + nvir, pv + y * vc, vg, vm, po + y * oc, oc, og, om,
                         ra, so + nocc, gc, nz, ncomp, 4, T(0.5), mask, out, W, wcap, st);
  return (int)err;
}

}  // namespace

extern "C" {

int grid_rho1_f64(const double* phio, long long oc, long long og, long long om,
                  const double* phiv, long long vc, long long vg, long long vm, int gc,
                  const double* za, int ra, const double* zb, int rb, int so, int sv, int nz,
                  int nocc, int nvir, int o0, int v0, int ncomp, int vu, int hermi,
                  const double* mask, double* out, double* W, long long wcap, void* stream) {
  return launch<double>(phio, oc, og, om, phiv, vc, vg, vm, gc, za, ra, zb, rb, so, sv, nz, nocc,
                        nvir, o0, v0, ncomp, vu, hermi, mask, out, W, wcap, stream);
}

int grid_rho1_f32(const float* phio, long long oc, long long og, long long om, const float* phiv,
                  long long vc, long long vg, long long vm, int gc, const float* za, int ra,
                  const float* zb, int rb, int so, int sv, int nz, int nocc, int nvir, int o0,
                  int v0, int ncomp, int vu, int hermi, const float* mask, float* out,
                  float* W, long long wcap, void* stream) {
  return launch<float>(phio, oc, og, om, phiv, vc, vg, vm, gc, za, ra, zb, rb, so, sv, nz, nocc,
                       nvir, o0, v0, ncomp, vu, hermi, mask, out, W, wcap, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
