// K1 `df_exchange`: density-fitted exchange of a sigma build for one block of
// trial vectors.
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._jk` (:399-433)
// and the spin-flip exchange `sf_sigma_df._k` (:821) / `xsf_sigma_df._k`
// (:1066), whose aux-chunked einsums compute, for trial vectors z[x, j, b]:
//
//   t[x, P]    = sum_jb B[P, o0+j, v0+b] z[x, j, b]             (Coulomb; optional)
//   T[P,j,x,a] = sum_b  z[x, j, b] Bv[P, v0+a, v0+b]            (half-transform)
//   K[x, i, a] = sum_Pj B[P, o0+j, o0+i] T[P, j, x, a]
//
// Bv is B itself for a spin-conserving block.  A spin-flip block pairs the
// occupied orbitals of one spin with the virtuals of the other: Bv is then
// the other spin's MO transform (UKS, flip-up), its o and v ranges may
// overlap (flip-down on a restricted-open reference: o = [0, nc+no),
// v = [nc, nmo)), and it has no Coulomb term (t == nullptr skips that kernel).
//
// Bound on an H100: flops, 2*naux*nz*nocc*nvir*(nvir+nocc+1) (5.9e12 at the
// bench shape, 88 ms at 67 TFLOP/s in f32 FMA or f64 DMMA; 9.9e10 at
// TTM/STO-3G, 1.5 ms); the o/v blocks of B are 7.4 GB (f32, bench) and
// 0.95 GB (f64, TTM), 2.2 and 0.28 ms at 3.35 TB/s.
//
// Design: two GEMMs on the tile core of `gemm_tile.cuh` through a T buffer
// in device memory, one aux chunk at a time (the wrapper sizes the chunk
// from a byte budget and allocates T):
//   - stage A, the half-transform: M = nz*nocc (the trial vectors are
//     folded into M, so each B_vv[P] tile is read once per M tile, not once
//     per vector), N = K = nvir, one output per P.  A is z transposed by the
//     wrapper ([b][x*nocc + j]), B is B_vv read along its rows (n-major in
//     shared memory), both in 16-byte runs: k starts at the aligned column
//     v0 - shift of B and z's first shift rows are zero.  The epilogue
//     writes T in the [P, j, x*nvir + a] layout (rows padded to 16 bytes)
//     that stage B reads;
//   - stage B: M = nocc, N = nz*nvir, K = (P, j) over the chunk, so B_oo is
//     read once per N tile; split-K fills the card when M*N is small
//     (TTM: 137 x 450): each split writes its partial K to its own slice of
//     the workspace W and the slices are added to K in split order after
//     each chunk, so a launch sums in the same order every time; with one
//     split each block adds its tile into K directly (one add per element
//     and chunk, the chunks in stream order);
//   - t[x, P], 2*nz*naux*nocc*nvir flops: a reduction kernel in which a
//     block owns 4 aux indices and 8 vectors.
// The T round trip costs 2*chunk*nocc*nz*nvir elements per chunk (~24 GB
// and ~7 ms in f32 at the bench shape, against its 88 ms flop bound).
// Where B's strides rule out 16-byte runs (f32 with nmo not a multiple of
// 4, as TTM/STO-3G's 182), its copies go one element at a time.
//
// Layout: B and Bv are any strided (naux, nmo, nmo) views (strides sP, sp,
// sq and vP, vp, vq in elements); z is contiguous (nz, nocc, nvir) and zT its transpose as
// above (ld columns, shift leading zero rows); t (nz, naux) is written
// unless null;
// K (nz, nocc, nvir) is accumulated (the caller zeroes it); Tb holds
// chunk*nocc rows of np elements; W holds wcap elements, at least one
// slice of nz*nocc*nvir.  Launches on the caller's stream, allocates
// nothing, returns the first CUDA error.  The Coulomb t kernel and stage A
// store each element once, so t and K are bitwise repeatable.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

// ---- t[x, P] ---------------------------------------------------------------

constexpr int T_NT = 256, T_PB = 4, T_XG = 8;

template <typename T>
__global__ void __launch_bounds__(T_NT)
coulomb_t_kernel(const T* __restrict__ B, int64_t sP, int64_t sp, int64_t sq, int naux,
                 const T* __restrict__ z, int nz, int nocc, int nvir, int o0, int v0,
                 T* __restrict__ t) {
  const int P0 = blockIdx.x * T_PB, x0 = blockIdx.y * T_XG;
  const int nov = nocc * nvir;
  T s[T_PB][T_XG];
#pragma unroll
  for (int p = 0; p < T_PB; ++p)
#pragma unroll
    for (int x = 0; x < T_XG; ++x) s[p][x] = T(0);
  for (int idx = threadIdx.x; idx < nov; idx += T_NT) {
    const int j = idx / nvir;
    const int64_t off = (int64_t)(o0 + j) * sp + (int64_t)(v0 + idx - j * nvir) * sq;
    T bv[T_PB];
#pragma unroll
    for (int p = 0; p < T_PB; ++p) bv[p] = P0 + p < naux ? B[(int64_t)(P0 + p) * sP + off] : T(0);
#pragma unroll
    for (int x = 0; x < T_XG; ++x) {
      const T zv = x0 + x < nz ? z[(int64_t)(x0 + x) * nov + idx] : T(0);
#pragma unroll
      for (int p = 0; p < T_PB; ++p) s[p][x] += bv[p] * zv;
    }
  }
  __shared__ T red[T_PB * T_XG][T_NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < T_PB; ++p)
#pragma unroll
    for (int x = 0; x < T_XG; ++x) {
      T v = s[p][x];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[p * T_XG + x][warp] = v;
    }
  __syncthreads();
  if (threadIdx.x < T_PB * T_XG) {
    const int p = threadIdx.x / T_XG, x = threadIdx.x % T_XG;
    if (P0 + p < naux && x0 + x < nz) {
      T tot = T(0);
      for (int w = 0; w < T_NT / 32; ++w) tot += red[threadIdx.x][w];
      t[(int64_t)(x0 + x) * naux + P0 + p] = tot;
    }
  }
}

// ---- the two GEMM stages -----------------------------------------------------

template <typename T>
struct Args {
  const T* B;  // occupied side (and the ov block of t)
  int64_t sP, sp, sq;
  const T* Bv;  // virtual side of the half-transform
  int64_t vP, vp, vq;
  int naux;
  const T* z;
  const T* zT;  // z as [shift + b][m = x*nocc + j], ld columns, zero padded
  int ldz, shift;
  int nz, nocc, nvir, o0, v0;
  T* t;
  T* K;
  T* Tb;  // [q][j][n = x*nvir + a], row stride np
  int np;
  T* W;  // the split partials' workspace, wcap elements
  int64_t wcap;
};

// stage A: T[q, j, x, a] = sum_b z[x, j, b] B[P0+q, v0+a, v0+b], m = x*nocc + j.
// k runs over the columns v0 - shift .. v0 + nvir of Bv, so that its rows'
// 16-byte runs start aligned; zT's first shift rows are zero, so the
// columns before v0 (finite values of the same tensor: padding of the
// virtual block, or live occupied columns when the ranges overlap) add
// nothing.
template <class Core>
struct HalfTransform {
  using T = typename Core::Elem;
  static constexpr bool kReduce = false, kTransform = false, kTile = false;
  int M, N, nkt, nq, extra;
  Args<T> a;
  int P0;
  bool vecB;

  __device__ void load(T* stage, int q, int kt, int m0, int n0) const {
    const int k0 = kt * Core::BK, M_ = M, nvir = a.nvir, kend = a.shift + a.nvir;
    const int ldz = a.ldz;
    const T* zT = a.zT;
    const T* Bq = a.Bv + (int64_t)(P0 + q) * a.vP + (int64_t)(a.v0 - a.shift) * a.vq;
    const int64_t sp = a.vp, sq = a.vq;
    const int v0 = a.v0;
    Core::template copy<gt::KMAJOR, Core::BM, Core::LDA>(
        stage, true, zT, [&](int r, int k, int w) -> gt::Run<T> {
          const int m = m0 + r, kk = k0 + k;
          return {zT + (int64_t)kk * ldz + m, kk < kend ? max(0, min(w, M_ - m)) : 0};
        });
    Core::template copy<gt::NMAJOR, Core::BN, Core::LDB>(
        stage + Core::A_ELEMS, vecB, a.Bv, [&](int r, int k, int w) -> gt::Run<T> {
          const int n = n0 + r, kk = k0 + k;
          return {Bq + (int64_t)(v0 + n) * sp + (int64_t)kk * sq,
                  n < nvir ? max(0, min(w, kend - kk)) : 0};
        });
  }

  __device__ void store(int q, int m, int n, T v) const {
    const int x = m / a.nocc, j = m - x * a.nocc;
    a.Tb[((int64_t)q * a.nocc + j) * a.np + (int64_t)x * a.nvir + n] = v;
  }
};

// stage B: K[x, i, a] += sum_{q, j} B[P0+q, o0+j, o0+i] T[q, j, x, a], n = x*nvir + a
template <class Core>
struct ExchangeBack {
  using T = typename Core::Elem;
  static constexpr bool kReduce = true, kTransform = false, kTile = false;
  int M, N, nkt, nq, extra;
  Args<T> a;
  int P0;
  bool vecA;
  T* W;  // this launch's slices of the workspace (null: one split, into K)

  __device__ void load(T* stage, int q, int kt, int m0, int n0) const {
    const int k0 = kt * Core::BK, nocc = a.nocc, o0 = a.o0, N_ = N, np = a.np;
    const T* BP = a.B + (int64_t)(P0 + q) * a.sP;
    const T* Tq = a.Tb + (int64_t)q * nocc * np;
    const int64_t sp = a.sp, sq = a.sq;
    Core::template copy<gt::KMAJOR, Core::BM, Core::LDA>(
        stage, vecA, a.B, [&](int r, int k, int w) -> gt::Run<T> {
          const int i = m0 + r, j = k0 + k;
          return {BP + (int64_t)(o0 + j) * sp + (int64_t)(o0 + i) * sq,
                  j < nocc ? max(0, min(w, nocc - i)) : 0};
        });
    Core::template copy<gt::KMAJOR, Core::BN, Core::LDB>(
        stage + Core::A_ELEMS, true, a.Tb, [&](int r, int k, int w) -> gt::Run<T> {
          const int n = n0 + r, j = k0 + k;
          return {Tq + (int64_t)j * np + n, j < nocc ? max(0, min(w, N_ - n)) : 0};
        });
  }

  __device__ void store(int, int m, int n, T v) const {
    const int x = n / a.nvir, c = n - x * a.nvir;
    const int64_t i = ((int64_t)x * a.nocc + m) * a.nvir + c;
    if (W != nullptr)
      W[blockIdx.y * (int64_t)M * N + i] = v;
    else
      a.K[i] += v;  // the block owns this element
  }
};

template <typename T>
int launch(const Args<T>& g, int chunk, void* stream_ptr) {
  constexpr int V = 16 / sizeof(T);
  if (g.nz <= 0 || g.nocc <= 0 || g.nvir <= 0 || g.naux <= 0 || chunk <= 0 ||
      g.shift < 0 || g.shift > g.v0 || g.ldz % V != 0 || g.np % V != 0 ||
      g.ldz < g.nz * g.nocc || g.np < g.nz * g.nvir ||
      !gt::aligned16(g.zT, {}) || !gt::aligned16(g.Tb, {}))
    return (int)cudaErrorInvalidValue;
  const int64_t kel = (int64_t)g.nz * g.nocc * g.nvir;  // one slice of W
  if (g.W == nullptr || g.wcap < kel) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
  if (g.t != nullptr) {
    const dim3 tgrid((g.naux + T_PB - 1) / T_PB, (g.nz + T_XG - 1) / T_XG);
    coulomb_t_kernel<T><<<tgrid, T_NT, 0, stream>>>(g.B, g.sP, g.sp, g.sq, g.naux, g.z, g.nz,
                                                    g.nocc, g.nvir, g.o0, g.v0, g.t);
    err = cudaGetLastError();
  }
  using CoreA = gt::Core<T, 16, 1, 3, gt::NMAJOR>;
  using CoreB = gt::Core<T, 16, 1, 3, gt::KMAJOR>;
  // 16-byte runs along a row of Bv: k contiguous, rows and aux slices
  // aligned, and the first column v0 - shift on a run boundary
  const bool vec_vv = g.vq == 1 && (g.v0 - g.shift) % V == 0 &&
                      gt::aligned16(g.Bv, {g.vp, g.vP});
  // along a column of B_oo: i contiguous
  const bool vec_oo = g.sq == 1 && g.o0 % V == 0 && gt::aligned16(g.B, {g.sp, g.sP});
  const int kv = (g.shift + g.nvir + CoreA::BK - 1) / CoreA::BK;
  const int ko = (g.nocc + CoreB::BK - 1) / CoreB::BK;
  for (int P0 = 0; P0 < g.naux && err == cudaSuccess; P0 += chunk) {
    const int nq = std::min(chunk, g.naux - P0);
    const HalfTransform<CoreA> pa{g.nz * g.nocc, g.nvir, kv, nq, 0, g, P0, vec_vv};
    err = gt::launch<CoreA>(pa, stream);
    if (err != cudaSuccess) break;
    const ExchangeBack<CoreB> pb{g.nocc, g.nz * g.nvir, ko, nq, 0, g, P0, vec_oo, nullptr};
    err = gt::launch_fixed<CoreB>(pb, g.W, g.wcap, kel, g.K, stream);
  }
  return (int)err;
}

}  // namespace

extern "C" {

int df_exchange_f64(const double* B, long long sP, long long sp, long long sq, const double* Bv,
                    long long vP, long long vp, long long vq, int naux, const double* z,
                    const double* zT, int ldz, int shift, int nz, int nocc, int nvir, int o0,
                    int v0, double* t, double* K, double* Tb, int np, int chunk, double* W,
                    long long wcap, void* stream) {
  return launch<double>({B, sP, sp, sq, Bv, vP, vp, vq, naux, z, zT, ldz, shift, nz, nocc, nvir,
                         o0, v0, t, K, Tb, np, W, wcap},
                        chunk, stream);
}

int df_exchange_f32(const float* B, long long sP, long long sp, long long sq, const float* Bv,
                    long long vP, long long vp, long long vq, int naux, const float* z,
                    const float* zT, int ldz, int shift, int nz, int nocc, int nvir, int o0,
                    int v0, float* t, float* K, float* Tb, int np, int chunk, float* W,
                    long long wcap, void* stream) {
  return launch<float>({B, sP, sp, sq, Bv, vP, vp, vq, naux, z, zT, ldz, shift, nz, nocc, nvir,
                        o0, v0, t, K, Tb, np, W, wcap},
                       chunk, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
