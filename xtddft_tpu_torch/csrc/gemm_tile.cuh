// The GEMM tile core shared by K1 `df_exchange`, K2 `grid_rho1` and K3
// `grid_back`.
//
// One thread block computes a BM x BN tile of
//
//   C[m, n] (+)= sum_q sum_s sum_k A_s(q)[m, k] B_s(q)[k, n]
//
// where q walks a batch (the aux index of K1), s < NS walks slices that
// share one pipeline stage (the four grid components of K3) and k walks
// the contraction in steps of BK.  A problem type (see `df_exchange.cu`,
// `grid_back.cu`) says where each element of A and B lives and what the
// epilogue does with C; the core owns the pipeline, the shared-memory
// layout and the inner product.
//
// - Copies: global -> shared through `cp.async` into a ring of STAGES
//   buffers, so the copies of step i + STAGES - 1 fly while step i is
//   multiplied.  Where the operand's contiguous direction is aligned, each
//   thread copies 16 bytes at a time, with zero fill past a ragged edge
//   (src-size below 16); else one element at a time.  16-byte copies matter:
//   with element copies only, the first version of this core spent about as
//   long copying as multiplying (PERF.md).  The problem gives element
//   strides, so strided views (the o/v blocks of B, a grid chunk of the MO
//   table) need no copies.
// - Shared layout: A is stored k-major ([k][m]); B either k-major ([k][n],
//   when n is its contiguous direction in device memory) or n-major
//   ([n][k], when k is), so that a 16-byte copy lands on 16 contiguous
//   bytes.  Pads keep the copies and the fragment loads free of bank
//   conflicts.
// - f32: full-precision FMA (TF32 would keep ~3 digits).  A 128 x 128 tile,
//   256 threads, each with an 8 x 8 register tile fed by vector shared
//   loads: 64 FMAs per 4 of them (128-bit for A and k-major B, 64-bit for
//   n-major B).
// - f64: the DMMA tensor cores through `mma.sync.m16n8k8.f64`.  A 64 x 64
//   tile, 2 x 2 warps of 32 x 32 (2 x 4 mma tiles each), accumulators in
//   registers.
// - Why not `wgmma`: it has no f64 form, and the f32 path must stay FMA
//   (its only f32 input type is TF32).  Why not TMA: K3's A rows are a
//   gather (the occupied orbitals of each trial vector) and K1's operands
//   come in both orientations; `cp.async` takes them all.
// - Split-K: a launch may cut the step range of one output tile across
//   blocks; such problems add their tile into a zeroed output with atomics.
// - Tile epilogues: a problem may take the whole accumulator tile at once
//   (kTile) instead of one element at a time; `dot_groups` contracts it
//   with a table tile in shared memory over groups of RG rows (K2 reduces
//   C over the orbital index of its rows that way).  In f32 a group is the
//   thread's own 4 rows; in f64 it is the 8 rows of a lane pair, which a
//   row permutation (`perm`) makes consecutive, so that a group costs one
//   shuffle, not one per element.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace gt {

enum Layout { KMAJOR = 0, NMAJOR = 1 };

// ---- cp.async -------------------------------------------------------------

// one element, or nothing (zero fill) when n == 0
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = n > 0 ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  }
}

// 16 bytes of which the first n elements are read and the rest zero-filled
template <typename T>
__device__ __forceinline__ void cp_async_16(T* dst, const T* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = n * static_cast<int>(sizeof(T));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// what a problem's src(r, k, w) returns: the address of the run of w
// elements from (r, k) along the contiguous direction, and how many of
// them are real (0..w; the rest is zero-filled)
template <typename T>
struct Run {
  const T* p;
  int n;
};

// ---- tile configurations ----------------------------------------------------

template <typename T>
struct Cfg;

template <>
struct Cfg<float> {
  static constexpr int BM = 128, BN = 128, NT = 256;
  static constexpr int PAD = 4;   // k-major rows: (4k + r) % 32 spreads element copies
  static constexpr int PADK = 4;  // n-major rows of BK + 4: a quarter warp's 16-byte
                                  // loads of 8 rows hit 8 distinct bank quads
  static constexpr int KRUN = 8;  // k run of one warp's element copies, n-major
};

template <>
struct Cfg<double> {
  static constexpr int BM = 64, BN = 64, NT = 128;
  static constexpr int PAD = 8;   // (16k + 2r) % 32: a fragment load is two wavefronts
  static constexpr int PADK = 4;  // (8r + 2k) % 32: likewise for n-major B
  static constexpr int KRUN = 4;
};

// PERM_ (f64 only; K2): the tile's accumulator row p holds row perm(p) of
// the A tile (see perm), so that a lane pair holds 8 consecutive rows.
template <typename T, int BK_, int NS_, int STAGES_, int BL_ = KMAJOR, bool PERM_ = false>
struct Core {
  using Elem = T;
  using C = Cfg<T>;
  static constexpr int BM = C::BM, BN = C::BN, NT = C::NT, BK = BK_, NS = NS_;
  static constexpr int STAGES = STAGES_, BL = BL_;
  static constexpr bool PERM = PERM_ && sizeof(T) == 8;
  static constexpr int VEC = 16 / sizeof(T);
  // PERM: (16k + 2r') % 32 over the permuted fragment rows r', two
  // wavefronts a fragment load as without it
  static constexpr int LDA = BM + (PERM ? 2 : C::PAD);
  static constexpr int LDB = BL == KMAJOR ? BN + C::PAD : BK + C::PADK;
  static constexpr int A_SLICE = BK * LDA;
  static constexpr int B_SLICE = BL == KMAJOR ? BK * LDB : BN * LDB;
  static constexpr int A_ELEMS = NS * A_SLICE;  // A slices, then B slices, then
  static constexpr int AB_ELEMS = A_ELEMS + NS * B_SLICE;  // the problem's extra
  static_assert(BK % 8 == 0 && BK % C::KRUN == 0, "BK");
  static_assert(A_SLICE % VEC == 0 && B_SLICE % VEC == 0, "16-byte slices");

  // the thread's share of the C tile
  static constexpr int ACC = sizeof(T) == 4 ? 64 : BM / 2;
  // dot_groups: the logical rows of group q are RG * q .. RG * q + RG - 1
  static constexpr int RG = sizeof(T) == 4 ? 4 : 8, NG = BM / RG;

  // the row of A (and of the problem's epilogue tables) that accumulator
  // row p of the tile holds.  PERM: within each 32 rows, p = 8h + g (the
  // h-th row of lane group g) holds 8(g / 2) + 2h + g % 2, so a lane pair
  // (g, g + 1) holds 8 consecutive rows of A; perm is its own inverse.  A
  // is copied in its own order and its f64 fragments are loaded through
  // perm; copying it permuted instead made K2's f64 GEMMs up to 1.6x slower
  // on the H100 (PERF.md).  Else the identity.
  static __device__ __forceinline__ int perm(int p) {
    if constexpr (PERM) {
      const int h = (p >> 3) & 3, g = p & 7;
      return (p & ~31) | (8 * (g >> 1) + 2 * h + (g & 1));
    } else {
      return p;
    }
  }

  // Copy a ROWS x BK operand tile stored with layout L (KMAJOR:
  // dst[k * LD + r], the rows are contiguous in device memory; NMAJOR:
  // dst[r * LD + k], k is).  src(r, k, w) gives the Run of w elements from
  // (r, k) along that contiguous direction.  vec: 16-byte runs (the problem
  // has checked their alignment); else one element per copy.  A run with
  // no real element reads nothing; `any` stands in for its address.
  template <int L, int ROWS, int LD, class Src>
  static __device__ __forceinline__ void copy(T* dst, bool vec, const T* any, Src src) {
    if (vec) {
      constexpr int NV = ROWS * BK / VEC;
      static_assert(NV % NT == 0, "vector copy trip count");
#pragma unroll
      for (int it = 0; it < NV / NT; ++it) {
        const int i = threadIdx.x + it * NT;
        int r, k;
        if constexpr (L == KMAJOR) {
          r = (i % (ROWS / VEC)) * VEC;
          k = i / (ROWS / VEC);
        } else {
          k = (i % (BK / VEC)) * VEC;
          r = i / (BK / VEC);
        }
        const Run<T> s = src(r, k, VEC);
        cp_async_16(dst + (L == KMAJOR ? k * LD + r : r * LD + k), s.n > 0 ? s.p : any, s.n);
      }
    } else {
      constexpr int KR = C::KRUN;
      static_assert(ROWS * BK % NT == 0, "copy trip count");
#pragma unroll
      for (int it = 0; it < ROWS * BK / NT; ++it) {
        const int i = threadIdx.x + it * NT;
        int r, k;
        if constexpr (L == KMAJOR) {
          r = i % ROWS;
          k = i / ROWS;
        } else {
          const int rest = i / KR;
          r = rest % ROWS;
          k = i % KR + (rest / ROWS) * KR;
        }
        const Run<T> s = src(r, k, 1);
        cp_async_elem(dst + (L == KMAJOR ? k * LD + r : r * LD + k), s.n > 0 ? s.p : any, s.n);
      }
    }
  }

  static __device__ __forceinline__ void zero(T (&acc)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = T(0);
  }

  // acc += A_s B_s for every slice s of one stage
  static __device__ __forceinline__ void multiply(const T* stage, T (&acc)[ACC]);

  // fn(r, c, value) for every accumulator, r < BM and c < BN tile-local
  template <class Fn>
  static __device__ __forceinline__ void for_each(const T (&acc)[ACC], Fn fn);

  // fn(q, c, sum over the physical rows p of group q of C[p, c] w[c * LDW + p])
  // for every (q, c) of the tile, each from exactly one thread, where group q
  // holds the rows p with perm(p) / RG == q.  w is a [BN][LDW] tile in
  // shared memory (LDW a multiple of the vector width).  Every thread of the
  // block must call it: f64 sums a group across a lane pair with a shuffle.
  template <int LDW, class Fn>
  static __device__ __forceinline__ void dot_groups(const T (&acc)[ACC], const T* w, Fn fn);
};

namespace detail {

// f32: thread (tx, ty) of a 16 x 16 grid owns rows {4ty..4ty+3, 64+4ty..}
// and columns {4tx..4tx+3, 64+4tx..} (k-major B) or {tx + 16j} (n-major
// B); acc[8 * i + j].
template <int BK, int NS, int LDA, int LDB, int A_SLICE, int B_SLICE, int A_ELEMS, int BL>
__device__ __forceinline__ void fma_8x8(const float* stage, float (&acc)[64]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float* As = stage + s * A_SLICE;
    const float* Bs = stage + A_ELEMS + s * B_SLICE;
    // n-major B is read two k at a time (8-byte loads): at four (16-byte
    // loads) the extra live registers made the half-transform spill more
    // and run slower on the H100 (PERF.md)
    constexpr int KP = BL == NMAJOR ? 2 : 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += KP) {
      float bq[8][KP];
      if constexpr (BL == NMAJOR) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(Bs + (tx + 16 * j) * LDB + k4);
          bq[j][0] = v.x, bq[j][1] = v.y;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const int k = k4 + kk;
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDA + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(As + k * LDA + 64 + 4 * ty);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[8];
        if constexpr (BL == NMAJOR) {
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = bq[j][kk];
        } else {
          const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LDB + 4 * tx);
          const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * LDB + 64 + 4 * tx);
          b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
          b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[8 * i + j] = fmaf(a[i], b[j], acc[8 * i + j]);
      }
    }
  }
}

__device__ __forceinline__ void dmma_16808(double* c, const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// f64: warp w owns the MI*16 x 32 sub-tile (wm, wn) = (w % 2, w / 2) as
// MI x 4 m16n8k8 tiles.  Lane (g, t) = (lane / 4, lane % 4) holds
// A[g + 8(e%2)][t + 4(e/2)] (e < 4), B[t + 4e][g] (e < 2), and of mma tile
// (i, j) the C entries at row 16(MI wm + i) + g + 8(e/2), column
// 32wn + 8j + 2t + e%2: acc[4 * (4i + j) + e].
// PERM (MI = 2): accumulator row 16(MI wm + i) + g + 8(e/2) = 32 wm + 8h + g
// (h = 2i + e/2) reads A row 32 wm + 8(g/2) + g%2 + 2h (`Core::perm`).
template <int MI, int BK, int NS, int LDA, int LDB, int A_SLICE, int B_SLICE, int A_ELEMS,
          int BL, bool PERM>
__device__ __forceinline__ void dmma_warp(const double* stage, double (&acc)[16 * MI]) {
  static_assert(!PERM || MI == 2, "a warp's rows are one 32-row block of the permutation");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rm = 16 * MI * (w & 1) + (PERM ? 8 * (g >> 1) + (g & 1) : g);
  const int rn = 32 * (w >> 1) + g;
  constexpr int RI = PERM ? 4 : 16, RE = PERM ? 2 : 8;  // row steps of i and e % 2
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const double* As = stage + s * A_SLICE;
    const double* Bs = stage + A_ELEMS + s * B_SLICE;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      double a[MI][4], b[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[i][e] = As[(k0 + t + 4 * (e >> 1)) * LDA + rm + RI * i + RE * (e & 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + t + 4 * e, c = rn + 8 * j;
          b[j][e] = BL == KMAJOR ? Bs[k * LDB + c] : Bs[c * LDB + k];
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma_16808(&acc[4 * (4 * i + j)], a[i], b[j]);
    }
  }
}

}  // namespace detail

template <typename T_, int BK_, int NS_, int ST_, int BL_, bool PM_>
__device__ __forceinline__ void Core<T_, BK_, NS_, ST_, BL_, PM_>::multiply(const T_* stage,
                                                                            T_ (&acc)[ACC]) {
  if constexpr (sizeof(T_) == 4) {
    detail::fma_8x8<BK, NS, LDA, LDB, A_SLICE, B_SLICE, A_ELEMS, BL>(stage, acc);
  } else {
    detail::dmma_warp<BM / 32, BK, NS, LDA, LDB, A_SLICE, B_SLICE, A_ELEMS, BL, PERM>(stage, acc);
  }
}

template <typename T_, int BK_, int NS_, int ST_, int BL_, bool PM_>
template <class Fn>
__device__ __forceinline__ void Core<T_, BK_, NS_, ST_, BL_, PM_>::for_each(const T_ (&acc)[ACC],
                                                                            Fn fn) {
  if constexpr (sizeof(T_) == 4) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        fn(4 * ty + (i & 3) + 64 * (i >> 2),
           BL == KMAJOR ? 4 * tx + (j & 3) + 64 * (j >> 2) : tx + 16 * j, acc[8 * i + j]);
  } else {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fn(BM / 2 * (w & 1) + 16 * i + g + 8 * (e >> 1),
             32 * (w >> 1) + 8 * j + 2 * t + (e & 1), acc[4 * (4 * i + j) + e]);
  }
}

template <typename T_, int BK_, int NS_, int ST_, int BL_, bool PM_>
template <int LDW, class Fn>
__device__ __forceinline__ void Core<T_, BK_, NS_, ST_, BL_, PM_>::dot_groups(
    const T_ (&acc)[ACC], const T_* w, Fn fn) {
  static_assert(LDW % VEC == 0, "vector loads of w");
  if constexpr (sizeof(T_) == 4) {
    // the thread's rows 4ty..4ty+3 and 64+4ty..: groups ty and 16 + ty
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = BL == KMAJOR ? 4 * tx + (j & 3) + 64 * (j >> 2) : tx + 16 * j;
        const float4 v = *reinterpret_cast<const float4*>(w + c * LDW + 4 * ty + 64 * h);
        const float* a = acc + 32 * h + j;
        fn(ty + 16 * h, c, a[0] * v.x + a[8] * v.y + a[16] * v.z + a[24] * v.w);
      }
  } else {
    // the thread's rows base + 8h + g (h = 2i + e / 2) are 4 of its group's
    // 8; lane (4g + t) ^ 4 holds the other 4
    static_assert(PERM, "f64 groups need the row permutation (Core's PERM_)");
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, base = BM / 2 * (wp & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = 32 * (wp >> 1) + 8 * j + 2 * t + e1;
        T_ s = T_(0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            s += acc[4 * (4 * i + j) + 2 * e2 + e1] * w[c * LDW + base + 16 * i + 8 * e2 + g];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        if ((g & 1) == 0) fn(base / 8 + (g >> 1), c, s);
      }
  }
}

// ---- the block's main loop ---------------------------------------------------
//
// A problem type Prob provides
//   using T; static constexpr bool kReduce (sum over q into one tile) and
//   kTransform (rewrite a stage in place once it has landed);
//   int M, N, nkt (k steps per q), nq; int extra (elements per stage
//   after the A and B slices);
//   load(stage, q, kt, m0, n0): issue the cp.async copies of one step;
//   transform(stage, q, kt, m0): the in-place rewrite (kTransform only);
//   store(q, m, n, v): the epilogue of one element (m < M, n < N);
//   kTile (with kReduce): the epilogue takes the whole tile instead,
//   finish(acc, smem, m0, n0) once the block's steps are summed, with the
//   block's shared memory, at least `epi` elements of it.
//
// The block owns the output tile (m0, n0) and the steps [s0, s1) of the
// flattened (q, kt) range.  Without kReduce, [s0, s1) holds whole q's
// and each q's tile is stored when its last step is multiplied.

template <class Core, class Prob>
__device__ __forceinline__ void run_tile(const Prob& p, int m0, int n0, int s0, int s1) {
  using T = typename Prob::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = Core::AB_ELEMS + p.extra;
  const int nsteps = s1 - s0;
  auto stage = [&](int i) { return smem + (i % Core::STAGES) * stage_elems; };
  auto issue = [&](int i) {
    if (i < nsteps) {
      const int s = s0 + i;
      p.load(stage(i), s / p.nkt, s % p.nkt, m0, n0);
    }
    cp_async_commit();  // an empty group keeps the wait counts uniform
  };

  T acc[Core::ACC];
  Core::zero(acc);
#pragma unroll
  for (int i = 0; i < Core::STAGES - 1; ++i) issue(i);
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<Core::STAGES - 2>();
    __syncthreads();  // step i landed for all; step i - 1 is no longer read
    const int s = s0 + i;
    const int q = s / p.nkt, kt = s % p.nkt;
    if constexpr (Prob::kTransform) {
      p.transform(stage(i), q, kt, m0);
      __syncthreads();
    }
    issue(i + Core::STAGES - 1);
    Core::multiply(stage(i), acc);
    if constexpr (!Prob::kReduce) {
      if (kt == p.nkt - 1) {
        Core::for_each(acc, [&](int r, int c, T v) {
          if (m0 + r < p.M && n0 + c < p.N) p.store(q, m0 + r, n0 + c, v);
        });
        Core::zero(acc);
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (Prob::kTile) {
    __syncthreads();  // the last stage is no longer read
    p.finish(acc, smem, m0, n0);
  } else if constexpr (Prob::kReduce) {
    Core::for_each(acc, [&](int r, int c, T v) {
      if (m0 + r < p.M && n0 + c < p.N) p.store(0, m0 + r, n0 + c, v);
    });
  }
}

// blockIdx.x: output tile (m tiles fastest, so the blocks that share a B
// tile run together); blockIdx.y: the split of the step range.
// f32 asks for two blocks per SM (at most 128 registers a thread); left
// alone the compiler takes ~250 registers and one block of 8 warps, which
// ran slower on the H100 (PERF.md).  f64 fits three to four blocks as it is.
template <class Core, class Prob>
__global__ void __launch_bounds__(Core::NT, sizeof(typename Core::Elem) == 4 ? 2 : 1)
    gemm_kernel(const Prob p, int steps_per_block) {
  const int mt = (p.M + Core::BM - 1) / Core::BM;
  const int m0 = (blockIdx.x % mt) * Core::BM;
  const int n0 = (blockIdx.x / mt) * Core::BN;
  const int total = p.nq * p.nkt;
  const int s0 = blockIdx.y * steps_per_block;
  const int s1 = min(total, s0 + steps_per_block);
  if (s0 < s1) run_tile<Core>(p, m0, n0, s0, s1);
}

// Launch Prob on the core: one block per output tile and split; the
// splits are chosen so that about two waves of blocks fill the card
// (fewer for problems with many tiles).  A problem without kReduce is
// split on q boundaries only.
// The shared-memory attribute and the resident blocks per SM are set and
// asked once per instantiation, device and shared-memory size (K3's size
// moves with the vectors a row tile touches), not before every launch.
template <class Core, class Prob>
cudaError_t launch(const Prob& p, cudaStream_t stream) {
  const auto kern = gemm_kernel<Core, Prob>;
  size_t elems = (size_t)Core::STAGES * (Core::AB_ELEMS + p.extra);
  if constexpr (Prob::kTile) elems = std::max(elems, (size_t)p.epi);
  const size_t smem = sizeof(typename Prob::T) * elems;
  struct Fit {
    int dev = -1;
    size_t smem = 0;
    int64_t blocks = 0;  // resident blocks on the whole card
  };
  static thread_local Fit fit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (fit.dev != dev || fit.smem != smem) {
    int nsm = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, Core::NT, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    fit = {dev, smem, (int64_t)per_sm * nsm};
  }
  const int64_t tiles =
      (int64_t)((p.M + Core::BM - 1) / Core::BM) * ((p.N + Core::BN - 1) / Core::BN);
  const int64_t target = 2 * fit.blocks;
  const int64_t unit = Prob::kReduce ? 1 : p.nkt;  // steps per indivisible piece
  const int64_t pieces = (int64_t)p.nq * p.nkt / unit;
  int64_t split = (target + tiles - 1) / tiles;
  // each split of a reduction keeps at least 4 steps of work
  if (Prob::kReduce) split = std::min<int64_t>(split, std::max<int64_t>(1, pieces / 4));
  split = std::max<int64_t>(1, std::min<int64_t>(split, std::min<int64_t>(pieces, 65535)));
  const int64_t per = (pieces + split - 1) / split * unit;
  split = ((int64_t)p.nq * p.nkt + per - 1) / per;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, (unsigned)split), Core::NT, smem, stream>>>(p, (int)per);
  return cudaGetLastError();
}

// 16-byte runs are safe when every run starts on a 16-byte boundary: a
// base pointer on one and each stride that moves a run start a multiple
// of the vector width
template <typename T>
inline bool aligned16(const T* base, std::initializer_list<int64_t> strides) {
  constexpr int64_t V = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  for (int64_t s : strides)
    if (s % V != 0) return false;
  return true;
}

}  // namespace gt
