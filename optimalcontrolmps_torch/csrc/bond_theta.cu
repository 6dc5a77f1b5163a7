// Two-site theta of a TEBD bond update for Hopper (sm_90a), complex64 and
// complex128 from one template.
//
// Replaces the Pallas TPU kernel optimalcontrolmps_tpu/ops/pallas_kernels.py
// _kernel (launched by fused_bond_theta, pallas_call at :86). Its plain
// PyTorch twin is bond_theta_reference in optimalcontrolmps_torch/ops/
// bond_theta.py, with the same algebra:
//
//   theta[b, l*p+P, Q*chi+r] = sum_{p',q} G[P*p+Q, p'*p+q]
//                              * sum_m Ai[b,l,p',m] Aj[b,m,q,r]
//
// Ai, Aj: (B, chi, p, chi); G: (p^2, p^2); theta: (B, chi*p, p*chi); all
// contiguous. Torch's complex storage is interleaved (re, im), so the kernel
// reads it as float2 / double2 (the TPU kernel split it into real pairs only
// because Mosaic has no complex types).
//
// What bounds it on this card, per batch element: 8 (chi^3 p^2 + p^4 chi^2)
// real operations against (2 chi^2 p + chi^2 p^2) complex elements moved
// (inputs read once, theta written once). At chi=25, p=5 in complex128 that
// is 6.25 MFLOP and 350 KB, so the TEBD engine's batches of a few dozen
// elements are bound by the launch, not by the card. At chi=128, p=8 in
// complex64 it is 1.61 GFLOP against 10 MB: compute-bound, ~24 us per
// element at the data sheet's 67 TFLOP/s fp32.
//
// Design (right and simple first; speed is later work):
//   * one block per (batch element b, left index l). The block owns the p
//     output rows l*p .. l*p+p-1 of theta, a contiguous run of p*p*chi
//     elements, so B*chi blocks keep many SMs busy even at small B;
//   * stage 1, T_l[p', (q,r)] = sum_m Ai[b,l,p',m] Aj[b,m,(q,r)]: the p x chi
//     slice Ai[b,l] and tiles of TM rows of Aj[b] sit in shared memory; each
//     thread owns a strided set of T_l's elements and accumulates them in
//     shared memory across the tiles;
//   * stage 2, theta rows = G (p^2 x p^2) x T_l viewed as (p^2 x chi): G
//     sits in shared memory; consecutive threads write consecutive elements;
//   * IEEE FMAs on the CUDA cores in the input's own precision: no TF32, no
//     fast math, no tensor cores.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM_MAX = 16;                 // rows of Aj per shared tile
constexpr size_t SMEM_LIMIT = 232448;      // per block, after opting in

template <typename R>
struct Complex;
template <>
struct Complex<float> {
  using T = float2;
};
template <>
struct Complex<double> {
  using T = double2;
};

__device__ __forceinline__ float fmar(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmar(double a, double b, double c) {
  return fma(a, b, c);
}

// acc + a * b in complex arithmetic
template <typename T>
__device__ __forceinline__ T cmac(T acc, T a, T b) {
  acc.x = fmar(a.x, b.x, acc.x);
  acc.x = fmar(-a.y, b.y, acc.x);
  acc.y = fmar(a.x, b.y, acc.y);
  acc.y = fmar(a.y, b.x, acc.y);
  return acc;
}

// Shared memory in elements: G, the Ai slice, T_l, one Aj tile.
size_t smem_elems(int chi, int p, int tm) {
  const size_t pp = (size_t)p * p;
  const size_t pc = (size_t)p * chi;
  return pp * pp + pc + pp * chi + (size_t)tm * pc;
}

template <typename R>
__global__ void __launch_bounds__(THREADS)
    bond_theta_kernel(const typename Complex<R>::T* __restrict__ Ai,
                      const typename Complex<R>::T* __restrict__ Aj,
                      const typename Complex<R>::T* __restrict__ G,
                      typename Complex<R>::T* __restrict__ theta, int chi,
                      int p, int tm) {
  using T = typename Complex<R>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pp = p * p;
  const int pc = p * chi;   // one row of Aj[b]: (q, r)
  const int nT = p * pc;    // elements of T_l and of the block's theta rows
  T* sG = reinterpret_cast<T*>(smem_raw);  // (pp, pp)
  T* sA = sG + pp * pp;                    // Ai[b, l]: (p, chi)
  T* sT = sA + pc;                         // T_l: (p, p*chi)
  T* sJ = sT + nT;                         // Aj[b, m0:m0+tm]: (tm, p*chi)

  const size_t blk = blockIdx.x;  // = b * chi + l
  const size_t b = blk / chi;
  const T* Ab = Ai + blk * pc;    // Ai[b, l, :, :]
  const T* Jb = Aj + b * chi * pc;
  T zero;
  zero.x = 0;
  zero.y = 0;

  for (int e = threadIdx.x; e < pp * pp; e += THREADS) sG[e] = G[e];
  for (int e = threadIdx.x; e < pc; e += THREADS) sA[e] = Ab[e];
  for (int e = threadIdx.x; e < nT; e += THREADS) sT[e] = zero;

  // stage 1: T_l = Ai[b, l] (p x chi) x Aj[b] (chi x p*chi), tile by tile
  for (int m0 = 0; m0 < chi; m0 += tm) {
    const int mt = min(tm, chi - m0);
    __syncthreads();  // the previous tile is consumed; first pass: loads
    for (int e = threadIdx.x; e < mt * pc; e += THREADS)
      sJ[e] = Jb[(size_t)m0 * pc + e];
    __syncthreads();
    for (int o = threadIdx.x; o < nT; o += THREADS) {
      const int pr = o / pc;
      const int col = o - pr * pc;
      const T* a = sA + pr * chi + m0;
      T acc = sT[o];
      for (int mm = 0; mm < mt; ++mm) acc = cmac(acc, a[mm], sJ[mm * pc + col]);
      sT[o] = acc;
    }
  }
  __syncthreads();

  // stage 2: theta[b, l*p+P, Q*chi+r] = sum_k G[P*p+Q, k] T_l[k*chi + r]
  T* out = theta + blk * nT;
  for (int o = threadIdx.x; o < nT; o += THREADS) {
    const int pq = o / chi;
    const int r = o - pq * chi;
    const T* g = sG + pq * pp;
    T acc = zero;
    for (int k = 0; k < pp; ++k) acc = cmac(acc, g[k], sT[k * chi + r]);
    out[o] = acc;
  }
}

template <typename R>
int launch(const void* Ai, const void* Aj, const void* G, void* theta, int B,
           int chi, int p, void* stream) {
  using T = typename Complex<R>::T;
  if (B < 1 || chi < 1 || p < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * chi > 2147483647LL) return (int)cudaErrorInvalidValue;
  int tm = chi < TM_MAX ? chi : TM_MAX;
  while (tm > 1 && smem_elems(chi, p, tm) * sizeof(T) > SMEM_LIMIT) --tm;
  const size_t smem = smem_elems(chi, p, tm) * sizeof(T);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      bond_theta_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  bond_theta_kernel<R><<<(unsigned)(B * chi), THREADS, smem,
                         (cudaStream_t)stream>>>(
      (const T*)Ai, (const T*)Aj, (const T*)G, (T*)theta, chi, p, tm);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. All pointers are device pointers to
// contiguous interleaved complex arrays: Ai, Aj (B, chi, p, chi), G (p*p,
// p*p), theta (B, chi*p, p*chi). They launch on `stream` and return
// cudaGetLastError() (or a refusal code when the shapes do not fit).
extern "C" int bond_theta_c64(const void* Ai, const void* Aj, const void* G,
                              void* theta, int B, int chi, int p,
                              void* stream) {
  return launch<float>(Ai, Aj, G, theta, B, chi, p, stream);
}

extern "C" int bond_theta_c128(const void* Ai, const void* Aj, const void* G,
                               void* theta, int B, int chi, int p,
                               void* stream) {
  return launch<double>(Ai, Aj, G, theta, B, chi, p, stream);
}
