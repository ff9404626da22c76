// K3 `grid_back`: back-projection of the weighted fxc response to (occ, vir).
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.back`
// (:525-534), which computes on one grid chunk, with phi_c = phi[c, g, :]:
//
//   A[x, g, o]   = dwv[x, g] phi_0[g, o0+o] + sum_y dwg[x, y, g] phi_y[g, o0+o]
//   C_y[x, g, o] = dwg[x, y, g] phi_0[g, o0+o]
//   r[x, o, v]   = sum_g A[x,g,o] phi_0[g, v0+v] + sum_y sum_g C_y[x,g,o] phi_y[g, v0+v]
//
// What bounds it on an H100: flops (2*4*nocc*nvir per vector and point).
// The JAX code materializes tmp[x, g, o] and tmp2[x, y, g, o] in HBM; here
// the combined factors A and C_y of each 16-point grid tile are formed in
// shared memory and consumed at once.  One block owns (vector x, a 32 x 32
// (occ, vir) tile, a range of grid points) and keeps its tile of r in
// registers; grid ranges are split across blocks only when there are too
// few tiles to fill the card, and every block adds into ``out`` with
// atomics, so the caller accumulates chunk after chunk in one tensor.
// Simple first version: plain FMAs, no tensor cores; the factors are
// rebuilt for every (occ, vir) tile, which is what costs it at nmo=1000
// (times in PERF.md).
//
// Layout: dwv (nz, gc) and dwg (nz, 3, gc) contiguous; phi any strided
// (4, gc, nmo) view (strides sc, sg, sm); out (nz, nocc, nvir) contiguous,
// accumulated.  Launches on the caller's stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TV = 32;     // virtual columns per block, one per lane
constexpr int TO = 32;     // occupied rows per block
constexpr int NWARP = 8;   // a thread owns rows warp + NWARP*r, r < TO/NWARP
constexpr int RO = TO / NWARP;
constexpr int GK = 16;     // grid points per shared-memory tile

template <typename T>
__global__ void __launch_bounds__(NWARP * 32)
grid_back_kernel(const T* __restrict__ dwv, const T* __restrict__ dwg,
                 const T* __restrict__ phi, int64_t sc, int64_t sg, int64_t sm, int gc,
                 int nocc, int nvir, int o0, int v0, int nvt, int g_per_block,
                 T* __restrict__ out) {
  __shared__ T Dw[4][GK];          // dwv, dwg_x, dwg_y, dwg_z of the tile
  __shared__ T F[4][GK][TO];       // phi_c[g, o], then the factors A, C_x, C_y, C_z
  __shared__ T Pv[4][GK][TV];      // phi_c[g, v]

  const int x = blockIdx.x;
  const int ot = (blockIdx.y / nvt) * TO;
  const int vt = (blockIdx.y % nvt) * TV;
  const int gbeg = blockIdx.z * g_per_block;
  const int gend = min(gc, gbeg + g_per_block);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  T acc[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r) acc[r] = T(0);

  for (int gb = gbeg; gb < gend; gb += GK) {
    for (int idx = threadIdx.x; idx < 4 * GK; idx += blockDim.x) {
      const int q = idx / GK;
      const int gg = idx - q * GK;
      const int g = gb + gg;
      T val = T(0);
      if (g < gend)
        val = q == 0 ? dwv[(int64_t)x * gc + g] : dwg[((int64_t)x * 3 + q - 1) * gc + g];
      Dw[q][gg] = val;
    }
    for (int idx = threadIdx.x; idx < 4 * GK * TO; idx += blockDim.x) {
      const int c = idx / (GK * TO);
      const int rem = idx - c * (GK * TO);
      const int gg = rem / TO;
      const int k = rem - gg * TO;
      const int g = gb + gg;
      const int o = ot + k;
      const int v = vt + k;
      const int64_t rowoff = (int64_t)c * sc + (int64_t)g * sg;
      F[c][gg][k] = (g < gend && o < nocc) ? phi[rowoff + (int64_t)(o0 + o) * sm] : T(0);
      Pv[c][gg][k] = (g < gend && v < nvir) ? phi[rowoff + (int64_t)(v0 + v) * sm] : T(0);
    }
    __syncthreads();
    // combined factors, formed in place: each (g, o) entry by one thread
    for (int idx = threadIdx.x; idx < GK * TO; idx += blockDim.x) {
      const int gg = idx / TO;
      const int k = idx - gg * TO;
      const T p0 = F[0][gg][k];
      const T p1 = F[1][gg][k];
      const T p2 = F[2][gg][k];
      const T p3 = F[3][gg][k];
      F[0][gg][k] = Dw[0][gg] * p0 + Dw[1][gg] * p1 + Dw[2][gg] * p2 + Dw[3][gg] * p3;
      F[1][gg][k] = Dw[1][gg] * p0;
      F[2][gg][k] = Dw[2][gg] * p0;
      F[3][gg][k] = Dw[3][gg] * p0;
    }
    __syncthreads();
#pragma unroll 4
    for (int gg = 0; gg < GK; ++gg) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T pv = Pv[c][gg][lane];
#pragma unroll
        for (int r = 0; r < RO; ++r) acc[r] += F[c][gg][warp + NWARP * r] * pv;
      }
    }
    __syncthreads();
  }

  const int v = vt + lane;
  if (v < nvir) {
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const int o = ot + warp + NWARP * r;
      if (o < nocc) atomicAdd(&out[((int64_t)x * nocc + o) * nvir + v], acc[r]);
    }
  }
}

template <typename T>
int launch(const T* dwv, const T* dwg, const T* phi, long long sc, long long sg,
           long long sm, int gc, int nz, int nocc, int nvir, int o0, int v0, T* out,
           void* stream) {
  if (nz <= 0 || nocc <= 0 || nvir <= 0 || gc <= 0) return (int)cudaErrorInvalidValue;
  const int nvt = (nvir + TV - 1) / TV;
  const int not_ = (nocc + TO - 1) / TO;
  const int64_t tiles = (int64_t)nz * nvt * not_;
  // split the grid range only when the (x, o, v) tiles alone leave SMs idle
  int nsplit = (int)std::max<int64_t>(1, (1056 + tiles - 1) / tiles);
  nsplit = std::min(nsplit, (gc + GK - 1) / GK);
  int g_per_block = (gc + nsplit - 1) / nsplit;
  g_per_block = (g_per_block + GK - 1) / GK * GK;
  nsplit = (gc + g_per_block - 1) / g_per_block;
  dim3 grid(nz, not_ * nvt, nsplit);
  grid_back_kernel<T><<<grid, NWARP * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      dwv, dwg, phi, sc, sg, sm, gc, nocc, nvir, o0, v0, nvt, g_per_block, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grid_back_f64(const double* dwv, const double* dwg, const double* phi, long long sc,
                  long long sg, long long sm, int gc, int nz, int nocc, int nvir, int o0,
                  int v0, double* out, void* stream) {
  return launch<double>(dwv, dwg, phi, sc, sg, sm, gc, nz, nocc, nvir, o0, v0, out, stream);
}

int grid_back_f32(const float* dwv, const float* dwg, const float* phi, long long sc,
                  long long sg, long long sm, int gc, int nz, int nocc, int nvir, int o0,
                  int v0, float* out, void* stream) {
  return launch<float>(dwv, dwg, phi, sc, sg, sm, gc, nz, nocc, nvir, o0, v0, out, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
