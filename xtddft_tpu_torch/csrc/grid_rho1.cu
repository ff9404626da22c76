// K2 `grid_rho1`: transition density and its gradient on one grid chunk.
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.rho1`
// (:495-508), which computes with phi_c = phi[c, g, :] (c = value, d/dx,
// d/dy, d/dz of the MOs on the grid):
//
//   s_c[x, g, o] = sum_v z[x, o, v] phi_c[g, v0+v]
//   rho1[x, 0, g]   = sum_o s_0[x,g,o] phi_0[g, o0+o]
//   rho1[x, y, g]   = sum_o s_0[x,g,o] phi_y[g, o0+o] + s_y[x,g,o] phi_0[g, o0+o]
//
// masked to zero where the ground-state density is negligible.
//
// What bounds it on an H100: flops (2*4*nocc*nvir per vector and point)
// and the reads of phi (4 x gc x nmo per vector).  The JAX code
// materializes tmp[x, g, o] and tmp2[x, y, g, o] in HBM; here s_c stays in
// registers.  One block owns (vector x, 32 grid points, 32 occupied rows):
// it streams 32-wide chunks of v through shared memory, accumulates
// s_c for its rows in registers, then contracts with phi(o) and reduces
// across its warps; blocks of the other occupied tiles add into the zeroed
// output with atomics.  Simple first version: plain FMAs, no tensor cores;
// it re-reads the phi chunk once per (vector, occupied tile), which is what
// costs it at nmo=1000 (times in PERF.md).
//
// Layout: phi is any strided (4, gc, nmo) view (strides sc, sg, sm); z is
// contiguous (nz, nocc, nvir); mask (gc,) holds 0/1 in the working type;
// out (nz, 4, gc) is accumulated (the caller zeroes it).  Launches on the
// caller's stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TG = 32;     // grid points per block, one per lane
constexpr int TO = 32;     // occupied rows per block
constexpr int NWARP = 8;   // a thread owns rows warp + NWARP*r, r < TO/NWARP
constexpr int RO = TO / NWARP;
constexpr int VK = 32;     // contraction chunk over v

template <typename T>
__global__ void __launch_bounds__(NWARP * 32)
grid_rho1_kernel(const T* __restrict__ phi, int64_t sc, int64_t sg, int64_t sm, int gc,
                 const T* __restrict__ z, int nocc, int nvir, int o0, int v0,
                 const T* __restrict__ mask, T* __restrict__ out) {
  __shared__ T Zs[TO][VK + 1];       // z chunk [o][k]; reused for the warp reduction
  __shared__ T Ps[4][VK][TG + 1];    // phi_c[g, v] chunk as [c][k][g]; reused for phi_c[g, o]

  const int x = blockIdx.x;
  const int g0 = blockIdx.y * TG;
  const int ot = blockIdx.z * TO;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* zx = z + (int64_t)x * nocc * nvir;

  T acc[4][RO];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < RO; ++r) acc[c][r] = T(0);

  for (int vb = 0; vb < nvir; vb += VK) {
    for (int idx = threadIdx.x; idx < TO * VK; idx += blockDim.x) {
      const int oo = idx / VK;
      const int k = idx - oo * VK;
      const int o = ot + oo;
      const int v = vb + k;
      Zs[oo][k] = (o < nocc && v < nvir) ? zx[(int64_t)o * nvir + v] : T(0);
    }
    for (int idx = threadIdx.x; idx < 4 * TG * VK; idx += blockDim.x) {
      const int c = idx / (TG * VK);
      const int rem = idx - c * (TG * VK);
      const int gg = rem / VK;
      const int k = rem - gg * VK;
      const int g = g0 + gg;
      const int v = vb + k;
      Ps[c][k][gg] = (g < gc && v < nvir)
                         ? phi[(int64_t)c * sc + (int64_t)g * sg + (int64_t)(v0 + v) * sm]
                         : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < VK; ++k) {
      T zr[RO];
#pragma unroll
      for (int r = 0; r < RO; ++r) zr[r] = Zs[warp + NWARP * r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T p = Ps[c][k][lane];
#pragma unroll
        for (int r = 0; r < RO; ++r) acc[c][r] += zr[r] * p;
      }
    }
    __syncthreads();
  }

  // phi_c[g, o0+o] for this block's rows, into the Ps buffer as [c][oo][g]
  for (int idx = threadIdx.x; idx < 4 * TG * TO; idx += blockDim.x) {
    const int c = idx / (TG * TO);
    const int rem = idx - c * (TG * TO);
    const int gg = rem / TO;
    const int oo = rem - gg * TO;
    const int g = g0 + gg;
    const int o = ot + oo;
    Ps[c][oo][gg] = (g < gc && o < nocc)
                        ? phi[(int64_t)c * sc + (int64_t)g * sg + (int64_t)(o0 + o) * sm]
                        : T(0);
  }
  __syncthreads();

  T part[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int oo = warp + NWARP * r;
    const T p0 = Ps[0][oo][lane];
    part[0] += acc[0][r] * p0;
#pragma unroll
    for (int y = 1; y < 4; ++y) part[y] += acc[0][r] * Ps[y][oo][lane] + acc[y][r] * p0;
  }

  // reduce the NWARP partial sums of each point through shared memory
  T* red = &Zs[0][0];  // NWARP * 4 * TG <= TO * (VK + 1) elements
#pragma unroll
  for (int q = 0; q < 4; ++q) red[(warp * 4 + q) * TG + lane] = part[q];
  __syncthreads();
  if (warp == 0 && g0 + lane < gc) {
    const T m = mask[g0 + lane];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      T s = T(0);
      for (int w = 0; w < NWARP; ++w) s += red[(w * 4 + q) * TG + lane];
      atomicAdd(&out[((int64_t)x * 4 + q) * gc + g0 + lane], s * m);
    }
  }
}

template <typename T>
int launch(const T* phi, long long sc, long long sg, long long sm, int gc,
           const T* z, int nz, int nocc, int nvir, int o0, int v0,
           const T* mask, T* out, void* stream) {
  if (nz <= 0 || nocc <= 0 || nvir <= 0 || gc <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid(nz, (gc + TG - 1) / TG, (nocc + TO - 1) / TO);
  grid_rho1_kernel<T><<<grid, NWARP * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      phi, sc, sg, sm, gc, z, nocc, nvir, o0, v0, mask, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grid_rho1_f64(const double* phi, long long sc, long long sg, long long sm, int gc,
                  const double* z, int nz, int nocc, int nvir, int o0, int v0,
                  const double* mask, double* out, void* stream) {
  return launch<double>(phi, sc, sg, sm, gc, z, nz, nocc, nvir, o0, v0, mask, out, stream);
}

int grid_rho1_f32(const float* phi, long long sc, long long sg, long long sm, int gc,
                  const float* z, int nz, int nocc, int nvir, int o0, int v0,
                  const float* mask, float* out, void* stream) {
  return launch<float>(phi, sc, sg, sm, gc, z, nz, nocc, nvir, o0, v0, mask, out, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
