// K2 `grid_rho1`: transition density, and optionally its gradient, on a span
// of grid points.
//
// Replaces `xtddft_tpu/response/sigma_df.py` `xtda_sigma_df._fxc.rho1`
// (:495-508) and the transition density of the spin-flip sigmas (:857-867,
// :1105-1120), which compute with po_c = phi_o[c, g, o0 + .] and
// pv_c = phi_v[c, g, v0 + .] (c = value, d/dx, d/dy, d/dz of the MOs on the
// grid; phi_v is phi_o's table for a spin-conserving block, the other spin's
// for a spin-flip block of a UKS reference):
//
//   s_c[x, g, o] = sum_v z[x, o, v] pv_c[g, v]
//   rho1[x, 0, g]   = sum_o s_0[x,g,o] po_0[g, o]
//   rho1[x, y, g]   = sum_o s_0[x,g,o] po_y[g, o] + s_y[x,g,o] po_0[g, o]
//
// masked to zero where the ground-state density is negligible (no mask: the
// spin-flip kernel that multiplies rho1 next is itself zero there).  NC = 4
// gives all four rows (GGA, multicollinear SF kernel); NC = 1 the value row
// alone (the ALDA0 SF kernel), a quarter of the multiply-adds.
//
// What bounds it on an H100: flops, at least 2*2*nocc*nvir per vector and
// point with the gradient (`response/flops.py`: tmp = z pv_0 and u = z^T po_0
// give every gradient term; this kernel forms all four s_c, twice that),
// 2*nocc*nvir without, and the reads of phi.  The JAX code
// materializes tmp[x, g, o] and tmp2[x, y, g, o] in HBM; here s_c stays in
// registers.  One block owns (vector x, 32 grid points, 32 occupied rows):
// it streams 32-wide chunks of v through shared memory, accumulates
// s_c for its rows in registers, then contracts with phi(o) and reduces
// across its warps; blocks of the other occupied tiles add into the zeroed
// output with atomics.  Simple first version: plain FMAs, no tensor cores;
// it re-reads the phi chunk once per (vector, occupied tile), which is what
// costs it at nmo=1000 (times in PERF.md).
//
// Layout: phi_o and phi_v are any strided (>= NC, gc, nmo) views (strides
// oc, og, om and vc, vg, vm); z is contiguous (nz, nocc, nvir); mask (gc,)
// holds 0/1 in the working type, or is null; out (nz, NC, gc) is
// accumulated (the caller zeroes it).  Launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TG = 32;     // grid points per block, one per lane
constexpr int TO = 32;     // occupied rows per block
constexpr int NWARP = 8;   // a thread owns rows warp + NWARP*r, r < TO/NWARP
constexpr int RO = TO / NWARP;
constexpr int VK = 32;     // contraction chunk over v

template <typename T, int NC>
__global__ void __launch_bounds__(NWARP * 32)
grid_rho1_kernel(const T* __restrict__ phio, int64_t oc, int64_t og, int64_t om,
                 const T* __restrict__ phiv, int64_t vc, int64_t vg, int64_t vm, int gc,
                 const T* __restrict__ z, int nocc, int nvir, int o0, int v0,
                 const T* __restrict__ mask, T* __restrict__ out) {
  __shared__ T Zs[TO][VK + 1];       // z chunk [o][k]; reused for the warp reduction
  __shared__ T Ps[NC][VK][TG + 1];   // pv_c[g, v] chunk as [c][k][g]; reused for po_c[g, o]

  const int x = blockIdx.x;
  const int g0 = blockIdx.y * TG;
  const int ot = blockIdx.z * TO;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* zx = z + (int64_t)x * nocc * nvir;

  T acc[NC][RO];
#pragma unroll
  for (int c = 0; c < NC; ++c)
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
    for (int idx = threadIdx.x; idx < NC * TG * VK; idx += blockDim.x) {
      const int c = idx / (TG * VK);
      const int rem = idx - c * (TG * VK);
      const int gg = rem / VK;
      const int k = rem - gg * VK;
      const int g = g0 + gg;
      const int v = vb + k;
      Ps[c][k][gg] = (g < gc && v < nvir)
                         ? phiv[(int64_t)c * vc + (int64_t)g * vg + (int64_t)(v0 + v) * vm]
                         : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < VK; ++k) {
      T zr[RO];
#pragma unroll
      for (int r = 0; r < RO; ++r) zr[r] = Zs[warp + NWARP * r][k];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const T p = Ps[c][k][lane];
#pragma unroll
        for (int r = 0; r < RO; ++r) acc[c][r] += zr[r] * p;
      }
    }
    __syncthreads();
  }

  // po_c[g, o0+o] for this block's rows, into the Ps buffer as [c][oo][g]
  for (int idx = threadIdx.x; idx < NC * TG * TO; idx += blockDim.x) {
    const int c = idx / (TG * TO);
    const int rem = idx - c * (TG * TO);
    const int gg = rem / TO;
    const int oo = rem - gg * TO;
    const int g = g0 + gg;
    const int o = ot + oo;
    Ps[c][oo][gg] = (g < gc && o < nocc)
                        ? phio[(int64_t)c * oc + (int64_t)g * og + (int64_t)(o0 + o) * om]
                        : T(0);
  }
  __syncthreads();

  T part[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) part[q] = T(0);
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int oo = warp + NWARP * r;
    const T p0 = Ps[0][oo][lane];
    part[0] += acc[0][r] * p0;
#pragma unroll
    for (int y = 1; y < NC; ++y) part[y] += acc[0][r] * Ps[y][oo][lane] + acc[y][r] * p0;
  }

  // reduce the NWARP partial sums of each point through shared memory
  T* red = &Zs[0][0];  // NWARP * NC * TG <= TO * (VK + 1) elements
#pragma unroll
  for (int q = 0; q < NC; ++q) red[(warp * NC + q) * TG + lane] = part[q];
  __syncthreads();
  if (warp == 0 && g0 + lane < gc) {
    const T m = mask != nullptr ? mask[g0 + lane] : T(1);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      T s = T(0);
      for (int w = 0; w < NWARP; ++w) s += red[(w * NC + q) * TG + lane];
      atomicAdd(&out[((int64_t)x * NC + q) * gc + g0 + lane], s * m);
    }
  }
}

template <typename T>
int launch(const T* phio, long long oc, long long og, long long om, const T* phiv,
           long long vc, long long vg, long long vm, int gc, const T* z, int nz, int nocc,
           int nvir, int o0, int v0, int ncomp, const T* mask, T* out, void* stream) {
  if (nz <= 0 || nocc <= 0 || nvir <= 0 || gc <= 0 || (ncomp != 1 && ncomp != 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nz, (gc + TG - 1) / TG, (nocc + TO - 1) / TO);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (ncomp == 4)
    grid_rho1_kernel<T, 4><<<grid, NWARP * 32, 0, st>>>(phio, oc, og, om, phiv, vc, vg, vm, gc,
                                                        z, nocc, nvir, o0, v0, mask, out);
  else
    grid_rho1_kernel<T, 1><<<grid, NWARP * 32, 0, st>>>(phio, oc, og, om, phiv, vc, vg, vm, gc,
                                                        z, nocc, nvir, o0, v0, mask, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grid_rho1_f64(const double* phio, long long oc, long long og, long long om,
                  const double* phiv, long long vc, long long vg, long long vm, int gc,
                  const double* z, int nz, int nocc, int nvir, int o0, int v0, int ncomp,
                  const double* mask, double* out, void* stream) {
  return launch<double>(phio, oc, og, om, phiv, vc, vg, vm, gc, z, nz, nocc, nvir, o0, v0,
                        ncomp, mask, out, stream);
}

int grid_rho1_f32(const float* phio, long long oc, long long og, long long om,
                  const float* phiv, long long vc, long long vg, long long vm, int gc,
                  const float* z, int nz, int nocc, int nvir, int o0, int v0, int ncomp,
                  const float* mask, float* out, void* stream) {
  return launch<float>(phio, oc, og, om, phiv, vc, vg, vm, gc, z, nz, nocc, nvir, o0, v0,
                       ncomp, mask, out, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
