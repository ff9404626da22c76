// The TMA-fed GEMM core of K1's RPA exchange mode (`df_exchange.cu`).
//
// One thread block computes, for work items (an output tile of BM x BN and
// a split of its k steps),
//
//   C[m, n] = sum_k A[m, k] B[k, n]
//
// where both operands are 2-D row-strided tensors in device memory read
// through TMA descriptors (`cp.async.bulk.tensor`), either both with k
// contiguous (KMAJOR: A as [m][k], B as [n][k]) or both with m and n
// contiguous (MNMAJOR: A as [k][m], B as [k][n]).  A problem's epilogue
// (`df_exchange.cu`) says where each element of C goes.
//
// - Warp roles: NCW consumer warps multiply; one producer warp, one lane of
//   it, keeps a ring of STAGES shared-memory stages filled by TMA.  Each
//   stage has a "full" mbarrier (the producer's arrive with the stage's
//   byte count; the copies complete it) and an "empty" one (one arrive per
//   consumer warp once it has read the stage).  Blocks are persistent: a
//   block walks items blockIdx.x, blockIdx.x + gridDim.x, ..., and the
//   producer runs ahead into the next item while the consumers store the
//   last one.
// - Tiles: k steps of 128 bytes (BK = 16 f64, 32 f32), BN = 128 and BM =
//   128 or 64.  TMA writes each box with the 128-byte swizzle (the 16-byte
//   chunk index of a 128-byte row XORed with the row index mod 8), so that
//   the consumers' loads spread over the banks; a KMAJOR operand is one box
//   of R rows x 128 bytes, an MNMAJOR one R / (128 bytes) boxes of BK rows,
//   each 1024-byte aligned as the swizzle requires.  Out-of-range boxes are
//   zero-filled by the hardware, so ragged edges need no masks in the main
//   loop; only the epilogue checks m < M and n < N.
// - f64: the DMMA tensor cores through `mma.sync.m16n8k8.f64` (`wgmma` has
//   no f64 form).  8 warps of 2 x 4, each a (BM / 2) x 32 sub-tile of
//   m16n8k8 tiles.  The fragment rows and columns a lane reads are a fixed
//   permutation of the tile's (`perm_m`, `perm_n`), chosen per layout so
//   that every 64-bit fragment load hits 16 distinct 8-byte banks in each
//   half-warp (two wavefronts, the least for 256 bytes); the epilogue
//   applies the same permutation, so C is unchanged.
// - f32: full-precision FMA (TF32 would keep ~3 digits), 256 threads in a
//   16 x 16 grid, each with a (BM / 16) x 8 register tile fed by 16-byte
//   shared loads.
// - Each output element of an item is summed over its k steps in order and
//   stored once, so a launch is bitwise repeatable; split partials go to
//   their own workspace slices (the problem's epilogue).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace tg {

enum Major { KMAJOR = 0, MNMAJOR = 1 };

constexpr int NCW = 8;              // consumer warps
constexpr int NT = (NCW + 1) * 32;  // and one producer warp
constexpr int BN = 128;
constexpr int STAGES = 5;

// ---- PTX ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void dmma_16808(double (&c)[4], const double (&a)[4],
                                           const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// ---- the swizzled tile layout ---------------------------------------------------

// the byte offset of element (r, k) of an operand tile (r its row, m or n,
// within the tile; k its step-local contraction index)
template <typename T, int MAJ>
__device__ __forceinline__ int swz(int r, int k) {
  constexpr int ES = sizeof(T), EPC = 128 / ES, BK = EPC;
  if constexpr (MAJ == KMAJOR) {
    const int b = k * ES;
    return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
  } else {
    const int b = (r & (EPC - 1)) * ES;
    return (r / EPC) * (BK * 128) + k * 128 + ((((b >> 4) ^ k) & 7) << 4) + (b & 15);
  }
}

// f64: the tile row that fragment row p (< 16) of an m16 tile reads, and
// the tile column (< 32) that column c (< 8) of a warp's n8 tile j reads
template <int MAJ>
__device__ __forceinline__ int perm_m(int p) {
  return MAJ == KMAJOR ? 2 * (p & 7) + (p >> 3)
                       : (p & 1) + 8 * ((p >> 1) & 1) + 2 * ((p >> 2) & 1) + 4 * (p >> 3);
}

template <int MAJ>
__device__ __forceinline__ int perm_n(int j, int c) {
  return MAJ == KMAJOR ? 8 * j + 2 * (c & 3) + (c >> 2)
                       : (c & 1) + 8 * ((c >> 1) & 1) + 2 * (c >> 2) + 4 * (j & 1) + 16 * (j >> 1);
}

// ---- consumers ------------------------------------------------------------------

template <typename T, int BM>
struct Acc;

template <int BM>
struct Acc<double, BM> {
  static constexpr int MI = BM / 32;  // m16 tiles of a warp
  double c[MI][4][4];
};

template <int BM>
struct Acc<float, BM> {
  static constexpr int RM = BM / 16;  // rows of a thread
  float c[RM][8];
};

template <int BM>
__device__ __forceinline__ void zero(Acc<double, BM>& acc) {
#pragma unroll
  for (int i = 0; i < Acc<double, BM>::MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[i][j][e] = 0.0;
}

template <int BM>
__device__ __forceinline__ void zero(Acc<float, BM>& acc) {
#pragma unroll
  for (int i = 0; i < Acc<float, BM>::RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc.c[i][j] = 0.0f;
}

__device__ __forceinline__ float4 lds4(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += the stage's A tile (As) times its B tile (Bs)
template <int BM, int MAJ>
__device__ __forceinline__ void multiply(const unsigned char* As, const unsigned char* Bs,
                                         Acc<double, BM>& acc) {
  constexpr int MI = Acc<double, BM>::MI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp & 1) * 16 * MI, cb = (warp >> 1) * 32;
#pragma unroll
  for (int k0 = 0; k0 < 16; k0 += 8) {
    double b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        b[j][e] = *reinterpret_cast<const double*>(
            Bs + swz<double, MAJ>(cb + perm_n<MAJ>(j, g), k0 + t + 4 * e));
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      double a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = *reinterpret_cast<const double*>(
            As + swz<double, MAJ>(rb + 16 * i + perm_m<MAJ>(g + 8 * (e & 1)), k0 + t + 4 * (e >> 1)));
#pragma unroll
      for (int j = 0; j < 4; ++j) dmma_16808(acc.c[i][j], a, b[j]);
    }
  }
}

template <int BM>
__device__ __forceinline__ int row_f32(int i) {
  const int ty = threadIdx.x >> 4;
  return BM == 128 ? 4 * ty + (i & 3) + 64 * (i >> 2) : 4 * ty + i;
}

template <int MAJ>
__device__ __forceinline__ int col_f32(int j) {
  const int tx = threadIdx.x & 15;
  return MAJ == MNMAJOR ? 4 * tx + (j & 3) + 64 * (j >> 2) : tx + 16 * j;
}

// f32: the swizzle's XOR is taken out of the inner loops, so that the
// loads are a base register plus an immediate and the issue slots go to
// FMAs.  Each k step is walked in a fixed order (KMAJOR: by 16-byte chunk;
// MNMAJOR: k mod 8 outer, k / 8 inner).
template <int BM, int MAJ>
__device__ __forceinline__ void multiply(const unsigned char* As, const unsigned char* Bs,
                                         Acc<float, BM>& acc) {
  constexpr int RM = Acc<float, BM>::RM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if constexpr (MAJ == MNMAJOR) {
    // rows 4ty.. (+ 64) and columns 4tx.. (+ 64) of 16 bytes: box m / 32,
    // 16-byte chunk (m % 32) / 4 of row k, XORed with k % 8
    const int wa = ty & 7, wb = tx & 7;
    const unsigned char* a0 = As + (ty >> 3) * 4096;
    const unsigned char* b0 = Bs + (tx >> 3) * 4096;
#pragma unroll
    for (int k7 = 0; k7 < 8; ++k7) {
      const unsigned char* pa = a0 + 128 * k7 + ((wa ^ k7) << 4);
      const unsigned char* pb = b0 + 128 * k7 + ((wb ^ k7) << 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a[RM], b[8];
#pragma unroll
        for (int h = 0; h < RM / 4; ++h) {
          const float4 v = lds4(pa + 1024 * kk + 8192 * h);
          a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = lds4(pb + 1024 * kk + 8192 * h);
          b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc.c[i][j] = fmaf(a[i], b[j], acc.c[i][j]);
      }
    }
  } else {
    // row r of A at r * 128, its chunk c at (c ^ (r % 8)) * 16; for the
    // thread's rows r % 8 = 4 (ty % 2) + i % 4, so the XOR is a constant
    // c ^ (i % 4) with bit 2 flipped by ty % 2: one of two bases (pp, pm)
    // plus an immediate.  Column n = tx + 16 j of B: n % 8 = tx % 8 for
    // every j, one XOR per chunk.
    const int b4 = (ty & 1) * 64;
    const unsigned char* pp = As + 512 * ty + b4;
    const unsigned char* pm = As + 512 * ty - b4;
    const unsigned char* bt = Bs + 128 * tx;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float4 a[RM], b[8];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int u = c ^ (i & 3);
        const int rc = BM == 128 ? ((i & 3) + 64 * (i >> 2)) * 128 : i * 128;
        a[i] = lds4(((u & 4) ? pm : pp) + rc + (u << 4));
      }
      const unsigned char* pb = bt + ((c ^ (tx & 7)) << 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = lds4(pb + 2048 * j);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = acc.c[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc.c[i][j] = s;
        }
    }
  }
}

// The epilogue: every accumulator of the tile at (m0, n0) with m < M and
// n < N goes to p.put(p.row(m) + p.col(n), split, value).  A destination
// offset is a sum of a row part and a column part, so that the thread
// works out its (few) rows and columns once, not once per element.
template <int BM, int MAJ, class Prob>
__device__ __forceinline__ void store(const Acc<double, BM>& acc, const Prob& p, int M, int N,
                                      int m0, int n0, int s) {
  constexpr int MI = Acc<double, BM>::MI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = m0 + (warp & 1) * 16 * MI, cb = n0 + (warp >> 1) * 32;
  int64_t ro[MI][2], co[4][2];
  bool rok[MI][2], cok[4][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = rb + 16 * i + perm_m<MAJ>(g + 8 * h);
      rok[i][h] = m < M;
      ro[i][h] = rok[i][h] ? p.row(m) : 0;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = cb + perm_n<MAJ>(j, 2 * t + e);
      cok[j][e] = n < N;
      co[j][e] = cok[j][e] ? p.col(n) : 0;
    }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (rok[i][e >> 1] && cok[j][e & 1])
          p.put(ro[i][e >> 1] + co[j][e & 1], s, acc.c[i][j][e]);
}

template <int BM, int MAJ, class Prob>
__device__ __forceinline__ void store(const Acc<float, BM>& acc, const Prob& p, int M, int N,
                                      int m0, int n0, int s) {
  constexpr int RM = Acc<float, BM>::RM;
  int64_t ro[RM], co[8];
  bool rok[RM], cok[8];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + row_f32<BM>(i);
    rok[i] = m < M;
    ro[i] = rok[i] ? p.row(m) : 0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + col_f32<MAJ>(j);
    cok[j] = n < N;
    co[j] = cok[j] ? p.col(n) : 0;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (rok[i] && cok[j]) p.put(ro[i] + co[j], s, acc.c[i][j]);
}

// ---- the kernel -----------------------------------------------------------------

// How a launch cuts its work and where its operands sit: A's tile (m0, k)
// is read at rows a_roff + m0 and contraction a_koff + k of its
// descriptor, B's likewise.  Prob provides T, MAJ, and the epilogue's
// row(m), col(n) (int64 offsets, for m < M and n < N) and
// put(row(m) + col(n), split, value).
struct Work {
  int M, N, nks;           // extents; k steps of 128 bytes
  int tm, tn, split, per;  // m and n tiles, splits of the k steps, steps per split
  int a_roff, a_koff, b_roff, b_koff;
};

template <typename T, int MAJ, int R>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, unsigned char* dst,
                                          uint64_t* bar, int r0, int k, int roff, int koff) {
  constexpr int EPC = 128 / sizeof(T), BK = EPC;
  if constexpr (MAJ == KMAJOR) {
    tma_load_2d(dst, map, bar, koff + k, roff + r0);
  } else {
#pragma unroll
    for (int c = 0; c < R / EPC; ++c)
      tma_load_2d(dst + c * BK * 128, map, bar, roff + r0 + c * EPC, koff + k);
  }
}

template <int BM>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * 128 + 2 * STAGES * 8 + 1024;  // + barriers, + alignment
}

template <int BM, class Prob>
__global__ void __launch_bounds__(NT, 1)
    tma_gemm_kernel(const __grid_constant__ CUtensorMap da, const __grid_constant__ CUtensorMap db,
                    const Work w, const Prob p) {
  using T = typename Prob::T;
  constexpr int MAJ = Prob::MAJ, BK = 128 / sizeof(T);
  constexpr int A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  extern __shared__ unsigned char tg_smem[];
  const uint32_t base = smem_u32(tg_smem);
  unsigned char* smem = tg_smem + ((1024 - (base & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = w.tm * w.tn * w.split;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  if (warp == NCW) {  // the producer
    if (lane == 0) {
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int mt = it % w.tm, nt = (it / w.tm) % w.tn, s = it / (w.tm * w.tn);
        const int k1 = min(w.nks, (s + 1) * w.per);
        for (int ks = s * w.per; ks < k1; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          load_tile<T, MAJ, BM>(&da, st, &full[stage], mt * BM, ks * BK, w.a_roff, w.a_koff);
          load_tile<T, MAJ, BN>(&db, st + A_BYTES, &full[stage], nt * BN, ks * BK, w.b_roff,
                                w.b_koff);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }
  Acc<T, BM> acc;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int mt = it % w.tm, nt = (it / w.tm) % w.tn, s = it / (w.tm * w.tn);
    const int k1 = min(w.nks, (s + 1) * w.per);
    zero(acc);
    for (int ks = s * w.per; ks < k1; ++ks) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * STAGE_BYTES;
      multiply<BM, MAJ>(st, st + A_BYTES, acc);
      // the stage was read through the generic proxy and TMA rewrites it
      // through the async proxy: order the reads first
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    store<BM, MAJ>(acc, p, w.M, w.N, mt * BM, nt * BN, s);
  }
}

// ---- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, through the runtime, so that nothing
// links against the driver library; null where the driver has none
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// A descriptor of a row-strided 2-D tensor: `outer` rows of `inner`
// elements, ld elements apart; boxes of box_inner x box_outer with the
// 128-byte swizzle (box_inner * sizeof(T) must be 128), zero-filled outside
template <typename T>
cudaError_t encode(CUtensorMap* map, const T* base, int64_t inner, int64_t outer, int64_t ld,
                   int box_inner, int box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * (int64_t)sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t es[2] = {1, 1};
  const CUresult r =
      fn(map, sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
         const_cast<T*>(base), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// resident blocks of one instantiation on the whole card, its shared-memory
// attribute set once per device
template <int BM, class Prob>
cudaError_t slots(int64_t& out) {
  static thread_local int dev_seen = -1;
  static thread_local int64_t n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    const auto kern = tma_gemm_kernel<BM, Prob>;
    int nsm = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BM>());
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem_bytes<BM>());
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    n = (int64_t)per_sm * nsm;
    dev_seen = dev;
  }
  out = n;
  return cudaSuccess;
}

// Plan a launch: tiles of BM x BN; with max_split > 1 the k steps are cut
// into the splits (at most max_split, each of at least 8 steps) that give
// the fewest steps on the busiest block, the smallest such count within 2%.
// The plan depends on the shapes and the device alone.
template <int BM, class Prob>
cudaError_t plan(Work& w, int64_t max_split) {
  int64_t nslot = 0;
  cudaError_t err = slots<BM, Prob>(nslot);
  if (err != cudaSuccess) return err;
  const int64_t tm = (w.M + BM - 1) / BM, tn = (w.N + BN - 1) / BN, tiles = tm * tn;
  int64_t split = 1, best = -1;
  const int64_t most = std::max<int64_t>(1, std::min<int64_t>(max_split, w.nks / 8));
  for (int64_t s = 1; s <= most; ++s) {
    const int64_t per = (w.nks + s - 1) / s, eff = (w.nks + per - 1) / per;
    const int64_t cost = (tiles * eff + nslot - 1) / nslot * per;
    if (best < 0 || cost * 50 < best * 49) best = cost, split = eff;
  }
  if (tiles * split > 0x7fffffff) return cudaErrorInvalidValue;
  w.tm = (int)tm, w.tn = (int)tn, w.split = (int)split, w.per = (int)((w.nks + split - 1) / split);
  return cudaSuccess;
}

// a planned launch on a persistent grid: at most one block per resident slot
template <int BM, class Prob>
cudaError_t launch(const CUtensorMap& da, const CUtensorMap& db, const Work& w, const Prob& p,
                   cudaStream_t stream) {
  int64_t nslot = 0;
  const cudaError_t err = slots<BM, Prob>(nslot);
  if (err != cudaSuccess) return err;
  const int64_t grid = std::min<int64_t>((int64_t)w.tm * w.tn * w.split, nslot);
  tma_gemm_kernel<BM, Prob><<<(unsigned)grid, NT, smem_bytes<BM>(), stream>>>(da, db, w, p);
  return cudaGetLastError();
}

}  // namespace tg
