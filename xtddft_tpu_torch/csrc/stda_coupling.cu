// K4 `stda_coupling`: the Coulomb-type coupling block of the simplified TDA.
//
// Replaces `xtddft_tpu/stda/core.py` `_j_block` (:294-311) and the
// Coulomb diagonal of `csf_diagonal` (:323), which compute, for CSF lists
// (o_row[p], v_row[p]) and (o_col[q], v_col[q]) of one spin,
//
//   J[p, q] = sum_A g[A, o_row[p], o_col[q]] * qv[A, v_row[p], v_col[q]]
//
// with g = gamma_J . q_oo (natm, nocc, nocc) and qv = q_vv (natm, nvir,
// nvir), the monopole charges, and the diagonal J[p] = the same with the
// row lists on both sides.  The JAX code gathers both (A, rows, columns)
// tensors, 2048 rows at a time; at TTM's selection (P-CSF rows x N-CSF
// columns of 6,597 CSFs, 34 atoms) each gather is up to 3.7 GB.
//
// Bound on an H100: the output write, 8 bytes and 2*natm flops per element
// (at TTM's final A, 3063^2 elements: 75 MB, 0.022 ms at 3.35 TB/s); the two
// tables are small (1.4 and 0.6 MB at TTM's active space) and stay in L2.
//
// What bounds it in practice is not that write but the gathered reads of
// qv: each element reads natm qv values at its own (row, column) pair, and
// a 32 x 32 tile meets each qv pair once, so qv is reused across tiles
// only, through L2 (at TTM's final A ~0.63 GB of L2 reads, which the
// kernel's 0.085 ms on the H100 move at ~7.4 TB/s; PERF.md).
//
// Design: a block owns a TR x TC tile of J and stages its four index lists
// in shared memory; each thread computes TR / RY rows of one column, walking
// A in the tables' own (A, row, column) layout through the read-only path.
// For one A a warp reads one g row at the column indices of 32 consecutive
// CSFs (mostly one occupied index, so mostly one address) and one qv row at
// their virtual indices (mostly consecutive), so the loads coalesce or
// broadcast; the tiles of a block row share their g and qv rows in L1.
// Staging each block's qv rows in shared memory instead (a 32 x 256 tile,
// so that qv crosses L2 once per 256 columns) measured about 3x slower on
// the H100 (PERF.md): its 92 KB a block left two blocks an SM to hide the
// latency of the gathered g loads; serving a thread's rows that share an
// occupied index with one g load changed nothing (the g loads broadcast
// within a warp and hit L1).  The diagonal is a flat loop, one
// element a thread.  Each element is summed over A in order and stored
// once: J is bitwise repeatable.
//
// Layout: g (natm, nocc, nocc) and qv (natm, nvir, nvir) contiguous; the
// index lists int32 on the device, made and range-checked once per CSF set
// by the wrapper (`csf_list`), so a call uploads nothing; J (nrow, ncol)
// with row stride ldj, or (nrow,) when diagonal.  With `sub` the block is
// subtracted from J in place (J is then a spin block of the coupling matrix
// M, which `coupling_matrix` would otherwise subtract in a second pass),
// else stored.  Launches on the caller's stream, allocates nothing,
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32, RY = 8, TR = 32, NT = TC * RY;

template <typename T>
__global__ void __launch_bounds__(NT)
j_block_kernel(const T* __restrict__ g, const T* __restrict__ qv, int natm, int nocc, int nvir,
               const int* __restrict__ o_row, const int* __restrict__ v_row, int nrow,
               const int* __restrict__ o_col, const int* __restrict__ v_col, int ncol,
               T* __restrict__ J, int64_t ldj, int sub) {
  __shared__ int sor[TR], svr[TR], soc[TC], svc[TC];
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;
  if (threadIdx.x < TR) {
    const int r = r0 + threadIdx.x;
    sor[threadIdx.x] = r < nrow ? o_row[r] : 0;
    svr[threadIdx.x] = r < nrow ? v_row[r] : 0;
  } else if (threadIdx.x < TR + TC) {
    const int c = c0 + threadIdx.x - TR;
    soc[threadIdx.x - TR] = c < ncol ? o_col[c] : 0;
    svc[threadIdx.x - TR] = c < ncol ? v_col[c] : 0;
  }
  __syncthreads();
  const int c = c0 + tx;
  if (c >= ncol) return;
  const int64_t oo = (int64_t)nocc * nocc, vv = (int64_t)nvir * nvir;
  const int oc = soc[tx], vc = svc[tx];
  T acc[TR / RY];
  const T* gp[TR / RY];
  const T* qp[TR / RY];
#pragma unroll
  for (int k = 0; k < TR / RY; ++k) {
    const int r = ty + RY * k;
    acc[k] = T(0);
    gp[k] = g + (int64_t)sor[r] * nocc + oc;
    qp[k] = qv + (int64_t)svr[r] * nvir + vc;
  }
#pragma unroll 4
  for (int A = 0; A < natm; ++A) {
#pragma unroll
    for (int k = 0; k < TR / RY; ++k)
      acc[k] += __ldg(gp[k] + A * oo) * __ldg(qp[k] + A * vv);
  }
#pragma unroll
  for (int k = 0; k < TR / RY; ++k) {
    const int r = r0 + ty + RY * k;
    if (r < nrow) {
      T* out = J + (int64_t)r * ldj + c;
      *out = sub ? *out - acc[k] : acc[k];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
j_diag_kernel(const T* __restrict__ g, const T* __restrict__ qv, int natm, int nocc, int nvir,
              const int* __restrict__ o, const int* __restrict__ v, int n, T* __restrict__ J) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t oo = (int64_t)nocc * nocc, vv = (int64_t)nvir * nvir;
  const T* gp = g + (int64_t)o[p] * (nocc + 1);
  const T* qp = qv + (int64_t)v[p] * (nvir + 1);
  T acc = T(0);
#pragma unroll 4
  for (int A = 0; A < natm; ++A) acc += __ldg(gp + A * oo) * __ldg(qp + A * vv);
  J[p] = acc;
}

template <typename T>
int launch(const T* g, const T* qv, int natm, int nocc, int nvir, const int* o_row,
           const int* v_row, int nrow, const int* o_col, const int* v_col, int ncol, T* J,
           long long ldj, int sub, int diagonal, void* stream_ptr) {
  if (natm <= 0 || nocc <= 0 || nvir <= 0 || nrow <= 0 || (!diagonal && ncol <= 0) ||
      (!diagonal && (ldj < ncol || (nrow + TR - 1) / TR > 65535)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (diagonal) {
    j_diag_kernel<T><<<(nrow + 255) / 256, 256, 0, stream>>>(g, qv, natm, nocc, nvir, o_row,
                                                              v_row, nrow, J);
  } else {
    const dim3 grid((ncol + TC - 1) / TC, (nrow + TR - 1) / TR);
    j_block_kernel<T><<<grid, NT, 0, stream>>>(g, qv, natm, nocc, nvir, o_row, v_row, nrow,
                                               o_col, v_col, ncol, J, ldj, sub);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stda_coupling_f64(const double* g, const double* qv, int natm, int nocc, int nvir,
                      const int* o_row, const int* v_row, int nrow, const int* o_col,
                      const int* v_col, int ncol, double* J, long long ldj, int sub,
                      int diagonal, void* stream) {
  return launch<double>(g, qv, natm, nocc, nvir, o_row, v_row, nrow, o_col, v_col, ncol, J, ldj,
                        sub, diagonal, stream);
}

int stda_coupling_f32(const float* g, const float* qv, int natm, int nocc, int nvir,
                      const int* o_row, const int* v_row, int nrow, const int* o_col,
                      const int* v_col, int ncol, float* J, long long ldj, int sub,
                      int diagonal, void* stream) {
  return launch<float>(g, qv, natm, nocc, nvir, o_row, v_row, nrow, o_col, v_col, ncol, J, ldj,
                       sub, diagonal, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
