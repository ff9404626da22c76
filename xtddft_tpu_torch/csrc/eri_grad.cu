// K5 `eri_grad`: the ERI-derivative contraction of the nuclear gradient.
//
// Replaces the backward pass through `xtddft_tpu/ints/jaxints.py:589`
// `_eri_block` (the vjp of `make_integral_fn`'s ERIs, whose cotangent is
// the nao^4 tensor Gamma) and `xtddft_tpu/grad/analytic.py:27`
// `_grad_eri_contract`, a host loop over shell quartets.  Both compute
//
//   g[A, x] = sum_pqrs Gamma_pqrs d(pq|rs)/dA_x
//
// over the spherical AO basis.  The wrapper (`kernels/eri_grad.py`) makes
// Gamma 8-fold symmetric (only that part meets the integrals' symmetry) and
// Cartesian (Gc = T Gamma T^T on each index, T the block-diagonal
// cart->sph map).  With Gamma symmetric the four derivative positions give
// the same sum, so
//
//   g[A, x] = -4 sum_{a on A} sum_{b, (c<=d)} f_cd sum Gc (d_x a b | c d)
//
// with d_x the electron-coordinate derivative of the first bra function
// (d/dA = -d/dr), f_cd = 2 for c < d and 1 for c = d (the ket pair's
// mirror), over every ordered bra shell pair and every unordered ket pair.
//
// McMurchie-Davidson: the bra derivative pair comes as its Hermite
// expansion of order la+lb+1 (the l+-1 E tables of
// `ints/mcmurchie.py make_shell_pair_deriv`), the ket pair as its plain
// one of order lc+ld with the parity (-1)^(t+u+v) folded in, both
// contraction-weighted, per primitive pair, built by the wrapper.  A block
// owns one bra shell pair and a chunk of ket pairs.  For each ket pair it
// stages the Gamma block in shared memory, then for each ket primitive j
// folds Gamma into the ket expansion, Kt[ab][h2] = sum_cd Gc[ab][cd]
// Hk_j[cd][h2], and for each bra primitive i builds the Hermite Coulomb
// integrals R_{tuv} (L = la+lb+lc+ld+1 <= 9: the Boys function by series
// or, for large arguments, erf and upward recursion, then the downward
// recursion in n in two shared buffers) and adds
// sum_{ab,h1} Hb^x_i[ab][h1] sum_h2 Kt[ab][h2] R[h1+h2] for the three x.
// No derivative integral is written to global memory.  `omega` > 0 takes
// the erf(omega r)/r kernel (F_n(T) -> s^(n+1/2) F_n(s T)).
//
// Summation order: each thread walks a fixed set of (ab, h1) entries in
// order, the block sums its threads by a fixed tree into one partial per
// (bra pair, ket chunk), and a second kernel sums the partials of each atom
// in order: the result repeats bitwise.
//
// Shells up to d (l <= 2): the bra expansion reaches order 5 (56 Hermite
// functions), the ket order 4 (35), R order 9 (220); the wrapper refuses
// f and higher.  Launches on the caller's stream, allocates nothing,
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int MAXL = 9;
constexpr int NHMAX = 220;   // Hermite functions of order <= 9
constexpr int NH2MAX = 35;   // order <= 4 (a d-d ket pair)
constexpr int NABMAX = 36;   // Cartesian pairs of a d-d shell pair
constexpr int PAIR_INTS = 8;
constexpr double BOYS_SERIES_MAX = 35.0;

__host__ __device__ inline int nherm(int L) { return (L + 1) * (L + 2) * (L + 3) / 6; }
__host__ __device__ inline int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// F_m(t), m = 0..mmax, scaled by `scale`
template <typename T>
__device__ void boys(int mmax, T t, T scale, T* F) {
  const T e = exp(-t);
  if (t <= T(BOYS_SERIES_MAX)) {
    // F_M(t) = e^-t sum_k (2t)^k / ((2M+1)(2M+3)...(2M+2k+1)), then down
    T term = T(1) / T(2 * mmax + 1), sum = term;
    for (int k = 1; k < 400; ++k) {
      term *= T(2) * t / T(2 * mmax + 2 * k + 1);
      sum += term;
      if (term < sum * T(1e-17)) break;
    }
    T f = e * sum;
    F[mmax] = f;
    for (int m = mmax - 1; m >= 0; --m) {
      f = (T(2) * t * f + e) / T(2 * m + 1);
      F[m] = f;
    }
  } else {
    // large t: F_0 by erf, the upward recursion is stable for t > mmax
    const T st = sqrt(t);
    T f = T(0.88622692545275801365) * erf(st) / st;  // sqrt(pi)/2
    F[0] = f;
    for (int m = 0; m < mmax; ++m) {
      f = (T(2 * m + 1) * f - e) / (T(2) * t);
      F[m + 1] = f;
    }
  }
  for (int m = 0; m <= mmax; ++m) F[m] *= scale;
}

// htab: axis[NHMAX] prev[NHMAX] prev2[NHMAX] coef[NHMAX] hsum[56 * NH2MAX]
// (the recursion of `soc_ints._herm_recursion(9)` and the combined index
// of `two_electron._comb_index(5, 4)`, both in `herm_indices(9)` order)
template <typename T>
__global__ void __launch_bounds__(NT)
eri_grad_kernel(const T* __restrict__ G, int nc, const int* __restrict__ bra,
                const T* __restrict__ bra_pP, const T* __restrict__ bra_tab,
                const int* __restrict__ ket, int nket, const T* __restrict__ ket_pP,
                const T* __restrict__ ket_tab, const int* __restrict__ htab, T omega, int kc,
                T* __restrict__ partial) {
  __shared__ T sG[NABMAX * NABMAX];
  __shared__ T sK[NABMAX * NH2MAX];
  __shared__ T sR[2][NHMAX];
  __shared__ T sF[MAXL + 1];
  __shared__ T sPQ[3];
  __shared__ T red[3][NT];
  const int* axis = htab;
  const int* prev = htab + NHMAX;
  const int* prev2 = htab + 2 * NHMAX;
  const int* coef = htab + 3 * NHMAX;
  const int* hsum = htab + 4 * NHMAX;

  const int tid = threadIdx.x;
  const int* B = bra + PAIR_INTS * blockIdx.x;
  const int la = B[0], lb = B[1], offa = B[2], offb = B[3];
  const int bprim0 = B[5], bnprim = B[6];
  const int64_t btab0 = B[7];
  const int ncb = ncart(lb), nab = ncart(la) * ncb;
  const int Lb = la + lb + 1, nh1 = nherm(Lb);
  const int nbt = nab * nh1;
  const int64_t n2 = (int64_t)nc * nc;

  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  const int k_end = min(nket, (int)(blockIdx.y + 1) * kc);
  for (int kp = blockIdx.y * kc; kp < k_end; ++kp) {
    const int* K = ket + PAIR_INTS * kp;
    const int lc = K[0], ld = K[1], offc = K[2], offd = K[3];
    const T fac = T(K[4]);
    const int kprim0 = K[5], knprim = K[6];
    const int64_t ktab0 = K[7];
    const int ncdd = ncart(ld), ncd = ncart(lc) * ncdd;
    const int Lk = lc + ld, nh2 = nherm(Lk), L = Lb + Lk;

    __syncthreads();  // the previous pair is done with sG, sK
    for (int e = tid; e < nab * ncd; e += NT) {
      const int ab = e / ncd, cd = e - ab * ncd;
      const int ia = ab / ncb, ib = ab - ia * ncb;
      const int ic = cd / ncdd, id = cd - ic * ncdd;
      sG[e] = fac * G[((int64_t)(offa + ia) * nc + offb + ib) * n2 +
                      (int64_t)(offc + ic) * nc + offd + id];
    }
    __syncthreads();
    for (int j = 0; j < knprim; ++j) {
      const T* Hk = ket_tab + ktab0 + (int64_t)j * ncd * nh2;
      for (int e = tid; e < nab * nh2; e += NT) {
        const int ab = e / nh2, h2 = e - ab * nh2;
        T s = T(0);
        for (int cd = 0; cd < ncd; ++cd) s += sG[ab * ncd + cd] * Hk[cd * nh2 + h2];
        sK[e] = s;
      }
      const T* Qp = ket_pP + 4 * (int64_t)(kprim0 + j);
      const T q = Qp[0];
      for (int i = 0; i < bnprim; ++i) {
        const T* Pp = bra_pP + 4 * (int64_t)(bprim0 + i);
        if (tid == 0) {
          const T p = Pp[0];
          const T alpha = p * q / (p + q);
          const T x = Pp[1] - Qp[1], y = Pp[2] - Qp[2], z = Pp[3] - Qp[3];
          sPQ[0] = x;
          sPQ[1] = y;
          sPQ[2] = z;
          const T t = alpha * (x * x + y * y + z * z);
          // 2 pi^(5/2) / (p q sqrt(p + q))
          const T pref = T(34.986836655249725693) / (p * q * sqrt(p + q));
          T F[MAXL + 1];
          if (omega > T(0)) {
            const T s = omega * omega / (omega * omega + alpha);
            boys(L, s * t, pref * sqrt(s), F);
            T sn = T(1);
            for (int n = 0; n <= L; ++n) {
              F[n] *= sn;
              sn *= s;
            }
          } else {
            boys(L, t, pref, F);
          }
          T m2a = T(1);
          for (int n = 0; n <= L; ++n) {
            sF[n] = F[n] * m2a;
            m2a *= T(-2) * alpha;
          }
          sR[0][0] = sF[L];
        }
        __syncthreads();
        int cur = 0;
        for (int m = L - 1; m >= 0; --m) {
          const int nhm = nherm(L - m), nxt = cur ^ 1;
          for (int h = tid; h < nhm; h += NT) {
            T v;
            if (h == 0) {
              v = sF[m];
            } else {
              v = sPQ[axis[h]] * sR[cur][prev[h]];
              if (coef[h]) v += T(coef[h]) * sR[cur][prev2[h]];
            }
            sR[nxt][h] = v;
          }
          __syncthreads();
          cur = nxt;
        }
        const T* Hb = bra_tab + btab0 + (int64_t)i * 3 * nbt;
        const T* R = sR[cur];
        for (int e = tid; e < nbt; e += NT) {
          const int ab = e / nh1, h1 = e - ab * nh1;
          const T* kt = sK + ab * nh2;
          const int* hs = hsum + h1 * NH2MAX;
          T t = T(0);
          for (int h2 = 0; h2 < nh2; ++h2) t += kt[h2] * R[hs[h2]];
          acc0 += Hb[e] * t;
          acc1 += Hb[nbt + e] * t;
          acc2 += Hb[2 * nbt + e] * t;
        }
        __syncthreads();  // before the next primitive rewrites sF, sR
      }
    }
  }
  red[0][tid] = acc0;
  red[1][tid] = acc1;
  red[2][tid] = acc2;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[0][tid] += red[0][tid + w];
      red[1][tid] += red[1][tid + w];
      red[2][tid] += red[2][tid + w];
    }
    __syncthreads();
  }
  if (tid < 3) partial[((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * 3 + tid] = red[tid][0];
}

// g[A, x] = scale * sum over the bra pairs of atom A (in order) and their
// ket chunks (in order) of the partials
template <typename T>
__global__ void eri_grad_reduce(const T* __restrict__ partial, int nbra, int nchunk,
                                const int* __restrict__ bra, int natm, T scale,
                                T* __restrict__ g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= natm * 3) return;
  const int A = t / 3, x = t - 3 * A;
  T s = T(0);
  for (int bp = 0; bp < nbra; ++bp) {
    if (bra[PAIR_INTS * bp + 4] != A) continue;
    for (int c = 0; c < nchunk; ++c) s += partial[((int64_t)bp * nchunk + c) * 3 + x];
  }
  g[t] = scale * s;
}

template <typename T>
int launch(const T* G, int nc, const int* bra, int nbra, const T* bra_pP, const T* bra_tab,
           const int* ket, int nket, const T* ket_pP, const T* ket_tab, const int* htab,
           double omega, int kc, T* partial, int natm, T* g, void* stream_ptr) {
  if (nc <= 0 || nbra <= 0 || nket <= 0 || kc <= 0 || natm <= 0) return (int)cudaErrorInvalidValue;
  const int nchunk = (nket + kc - 1) / kc;
  if (nchunk > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  eri_grad_kernel<T><<<dim3(nbra, nchunk), NT, 0, stream>>>(
      G, nc, bra, bra_pP, bra_tab, ket, nket, ket_pP, ket_tab, htab, T(omega), kc, partial);
  eri_grad_reduce<T><<<(natm * 3 + 127) / 128, 128, 0, stream>>>(partial, nbra, nchunk, bra,
                                                                   natm, T(-4), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int eri_grad_f64(const double* G, int nc, const int* bra, int nbra, const double* bra_pP,
                 const double* bra_tab, const int* ket, int nket, const double* ket_pP,
                 const double* ket_tab, const int* htab, double omega, int kc, double* partial,
                 int natm, double* g, void* stream) {
  return launch<double>(G, nc, bra, nbra, bra_pP, bra_tab, ket, nket, ket_pP, ket_tab, htab,
                        omega, kc, partial, natm, g, stream);
}

int eri_grad_f32(const float* G, int nc, const int* bra, int nbra, const float* bra_pP,
                 const float* bra_tab, const int* ket, int nket, const float* ket_pP,
                 const float* ket_tab, const int* htab, double omega, int kc, float* partial,
                 int natm, float* g, void* stream) {
  return launch<float>(G, nc, bra, nbra, bra_pP, bra_tab, ket, nket, ket_pP, ket_tab, htab,
                       omega, kc, partial, natm, g, stream);
}

const char* xk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
