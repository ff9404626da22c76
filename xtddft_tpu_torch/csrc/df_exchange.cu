// K1 `df_exchange`: density-fitted exchange of the X-TDA sigma for one spin block.
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._jk` (:399-433),
// whose aux-chunked einsums compute, for trial vectors z[x, j, b]:
//
//   t[x, P]    = sum_jb B[P, o0+j, v0+b] z[x, j, b]
//   T[x,P,j,a] = sum_b  B[P, v0+a, v0+b] z[x, j, b]            (half-transform)
//   K[x, i, a] = sum_Pj B[P, o0+j, o0+i] T[x, P, j, a]
//
// What bounds it on an H100: flops.  T and K cost 2*naux*nocc*nvir*(nvir+nocc)
// per vector and dominate the sigma build (bench shape: 1.2e13 flops per
// 20-vector build), while B (8 GB in f32 at the bench shape) is streamed
// once per trial vector, mostly out of the 50 MB L2 because the
// trial-vector index is the fastest-varying block index.  The JAX code
// bounds the T intermediate by aux chunking through HBM; here T never
// reaches device memory: one block owns (vector x, a tile of TN virtuals,
// a range of aux indices P), builds the (nocc x TN) T tile of each P in
// shared memory and contracts it with B_oo[P] straight away, keeping its K
// tile in registers across its P range.  Blocks that share an (x, a tile)
// add their K into the zeroed output with atomics; t[x, P] is computed by
// exactly one block.
//
// Each thread holds an RM x CN register tile (rows ty + 16 r, columns
// tx + 16 c) of T and of K, so one shared-memory load feeds RM or CN FMAs;
// RM = ceil(nocc / 16) is a template parameter (one instantiation per
// value up to 16, so nocc <= 256) and the b and j loops stop at the last
// real index.  Plain FMAs, no tensor cores (wgmma/TMA are later work);
// the shared-memory loads of the z and B_oo values still bound the inner
// loops at small RM (times in PERF.md).
//
// Layout: B is any strided (naux, nmo, nmo) view (strides sP, sp, sq in
// elements); z is contiguous (nz, nocc, nvir); t (nz, naux) is written,
// K (nz, nocc, nvir) is accumulated (the caller zeroes it).  Launches on
// the caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TX = 16;      // column groups: a thread owns columns a0 + tx + TX*c
constexpr int TY = 16;      // row groups: a thread owns rows ty + TY*r
constexpr int NTHREADS = TX * TY;
constexpr int BK = 32;      // contraction chunk over b in the T phase
constexpr int JK = 32;      // contraction chunk over j in the K phase
constexpr int RM_MAX = 16;  // rows per thread: nocc <= TY * RM_MAX

// columns per thread: 4 in f32; 3 in f64, whose values take two registers
// (one 48-wide tile then covers the 45-46 virtuals of TTM/STO-3G)
template <typename T> struct Cols { static constexpr int value = 4; };
template <> struct Cols<double> { static constexpr int value = 3; };

template <typename T>
struct Args {
  const T* B;
  int64_t sP, sp, sq;
  int naux;
  const T* z;
  int nz, nocc, nvir, o0, v0;
  T* t;
  T* K;
};

template <typename T, int RM>
struct Tile {
  static constexpr int CN = Cols<T>::value;
  static constexpr int TN = TX * CN;  // virtual columns per block
  static constexpr int MP = TY * RM;  // occupied rows, padded
  static constexpr int LDT = TN + 1;  // row strides, padded against bank conflicts
  static constexpr int LDZ = MP + 1;
  static constexpr int LDB = TN + 1;
  // Ts, then the larger of the T phase's (Zs, Bs) and the K phase's Os
  static constexpr size_t SMEM_ELEMS =
      (size_t)MP * LDT + (BK * (LDZ + LDB) > JK * MP ? BK * (LDZ + LDB) : JK * MP);
};

template <typename T, int RM>
__global__ void __launch_bounds__(NTHREADS)
df_exchange_kernel(const Args<T> g, int p_per_block, int ntile) {
  using G = Tile<T, RM>;
  constexpr int CN = G::CN, TN = G::TN, MP = G::MP;
  constexpr int LDT = G::LDT, LDZ = G::LDZ, LDB = G::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ts = reinterpret_cast<T*>(smem_raw);  // [MP][LDT]  T tile of one P
  T* U = Ts + MP * LDT;                    // phase-shared region:
  T* Zs = U;                               //   T phase: [BK][LDZ] z chunk, transposed
  T* Bs = Zs + BK * LDZ;                   //            [BK][LDB] B_vv chunk, transposed
  T* Os = U;                               //   K phase: [JK][MP]  B_oo rows
  __shared__ T red[NTHREADS / 32];

  const int nocc = g.nocc, nvir = g.nvir, o0 = g.o0, v0 = g.v0;
  const int64_t sp = g.sp, sq = g.sq;
  const int x = blockIdx.x;
  const int tile = blockIdx.y;
  const int a0 = tile * TN;
  const int P0 = blockIdx.z * p_per_block;
  const int P1 = min(g.naux, P0 + p_per_block);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* zx = g.z + (int64_t)x * nocc * nvir;

  T kacc[RM][CN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < CN; ++c) kacc[r][c] = T(0);

  for (int P = P0; P < P1; ++P) {
    const T* BP = g.B + (int64_t)P * g.sP;

    // Coulomb intermediate t[x, P], by the one block whose tile is P % ntile
    if (tile == P % ntile) {
      T s = T(0);
      for (int idx = threadIdx.x; idx < nocc * nvir; idx += NTHREADS) {
        const int j = idx / nvir;
        const int b = idx - j * nvir;
        s += BP[(int64_t)(o0 + j) * sp + (int64_t)(v0 + b) * sq] * zx[idx];
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        T tot = T(0);
        for (int w = 0; w < NTHREADS / 32; ++w) tot += red[w];
        g.t[(int64_t)x * g.naux + P] = tot;
      }
      // red is rewritten only after the __syncthreads of the T phase below
    }

    // T[j, a] = sum_b z[x, j, b] B[P, v0+a, v0+b] for this block's a tile
    T tacc[RM][CN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) tacc[r][c] = T(0);
    for (int b0 = 0; b0 < nvir; b0 += BK) {
      const int kn = min(BK, nvir - b0);
      for (int idx = threadIdx.x; idx < MP * BK; idx += NTHREADS) {
        const int j = idx / BK;
        const int k = idx - j * BK;
        Zs[k * LDZ + j] = (j < nocc && k < kn) ? zx[(int64_t)j * nvir + b0 + k] : T(0);
      }
      for (int idx = threadIdx.x; idx < TN * BK; idx += NTHREADS) {
        const int aa = idx / BK;
        const int k = idx - aa * BK;
        const int a = a0 + aa;
        Bs[k * LDB + aa] = (a < nvir && k < kn)
                               ? BP[(int64_t)(v0 + a) * sp + (int64_t)(v0 + b0 + k) * sq]
                               : T(0);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        T zr[RM], bc[CN];
#pragma unroll
        for (int r = 0; r < RM; ++r) zr[r] = Zs[k * LDZ + ty + TY * r];
#pragma unroll
        for (int c = 0; c < CN; ++c) bc[c] = Bs[k * LDB + tx + TX * c];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < CN; ++c) tacc[r][c] += zr[r] * bc[c];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) Ts[(ty + TY * r) * LDT + tx + TX * c] = tacc[r][c];

    // K[i, a] += sum_j B[P, o0+j, o0+i] T[j, a]
    for (int j0 = 0; j0 < nocc; j0 += JK) {
      const int jn = min(JK, nocc - j0);
      for (int idx = threadIdx.x; idx < jn * MP; idx += NTHREADS) {
        const int jj = idx / MP;
        const int i = idx - jj * MP;
        Os[jj * MP + i] =
            i < nocc ? BP[(int64_t)(o0 + j0 + jj) * sp + (int64_t)(o0 + i) * sq] : T(0);
      }
      __syncthreads();  // on the first chunk this also publishes Ts
      for (int jj = 0; jj < jn; ++jj) {
        T orow[RM], tv[CN];
#pragma unroll
        for (int r = 0; r < RM; ++r) orow[r] = Os[jj * MP + ty + TY * r];
#pragma unroll
        for (int c = 0; c < CN; ++c) tv[c] = Ts[(j0 + jj) * LDT + tx + TX * c];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < CN; ++c) kacc[r][c] += orow[r] * tv[c];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = ty + TY * r;
    if (i >= nocc) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int a = a0 + tx + TX * c;
      if (a < nvir) atomicAdd(&g.K[((int64_t)x * nocc + i) * nvir + a], kacc[r][c]);
    }
  }
}

template <typename T, int RM>
cudaError_t launch_rm(const Args<T>& args, cudaStream_t stream) {
  using G = Tile<T, RM>;
  const int ntile = (args.nvir + G::TN - 1) / G::TN;
  const size_t smem = sizeof(T) * G::SMEM_ELEMS;
  const auto kern = df_exchange_kernel<T, RM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, nsm = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS, smem);
  if (err != cudaSuccess) return err;
  // split the aux range so that about two waves of blocks fill the card
  const int64_t base = (int64_t)args.nz * ntile;
  const int64_t target = 2 * (int64_t)std::max(per_sm, 1) * nsm;
  int nsplit = (int)std::min<int64_t>(args.naux, std::max<int64_t>(1, (target + base - 1) / base));
  const int p_per_block = (args.naux + nsplit - 1) / nsplit;
  nsplit = (args.naux + p_per_block - 1) / p_per_block;
  dim3 grid(args.nz, ntile, nsplit);
  kern<<<grid, NTHREADS, smem, stream>>>(args, p_per_block, ntile);
  return cudaGetLastError();
}

// launch_rm<T, rm> for the runtime rm in [R, RM_MAX]
template <typename T, int R = 1>
cudaError_t dispatch(int rm, const Args<T>& args, cudaStream_t stream) {
  if constexpr (R > RM_MAX) {
    return cudaErrorInvalidValue;  // nocc > 256: the wrapper refuses it first
  } else {
    if (rm == R) return launch_rm<T, R>(args, stream);
    return dispatch<T, R + 1>(rm, args, stream);
  }
}

template <typename T>
int launch(const T* B, long long sP, long long sp, long long sq, int naux,
           const T* z, int nz, int nocc, int nvir, int o0, int v0, T* t, T* K,
           void* stream) {
  if (nz <= 0 || nocc <= 0 || nvir <= 0 || naux <= 0) return (int)cudaErrorInvalidValue;
  const Args<T> args{B, sP, sp, sq, naux, z, nz, nocc, nvir, o0, v0, t, K};
  return (int)dispatch<T>((nocc + TY - 1) / TY, args, reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int df_exchange_f64(const double* B, long long sP, long long sp, long long sq, int naux,
                    const double* z, int nz, int nocc, int nvir, int o0, int v0,
                    double* t, double* K, void* stream) {
  return launch<double>(B, sP, sp, sq, naux, z, nz, nocc, nvir, o0, v0, t, K, stream);
}

int df_exchange_f32(const float* B, long long sP, long long sp, long long sq, int naux,
                    const float* z, int nz, int nocc, int nvir, int o0, int v0,
                    float* t, float* K, void* stream) {
  return launch<float>(B, sP, sp, sq, naux, z, nz, nocc, nvir, o0, v0, t, K, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
