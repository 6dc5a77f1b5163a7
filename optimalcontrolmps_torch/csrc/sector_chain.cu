// Fused sector Trotter chain for Hopper (sm_90a): forward and reversible
// backward, each one kernel launch for the whole (B, N_t) control batch.
//
// Replaces the two Pallas TPU kernels of optimalcontrolmps_tpu/ops/
// pallas_sector.py:
//   fwd_kernel <- _fwd_kernel (launched by _pallas_fwd, pallas_call at :223)
//   bwd_kernel <- _bwd_kernel (launched by _pallas_bwd, pallas_call at :252)
// Their plain PyTorch twins are chain_final_scan and scan_bwd in
// optimalcontrolmps_torch/ops/sector_chain.py; the algebra is the same.
//
// Forward, row form, per batch row b (R(phi) rotates the (re, im) pair):
//   h_0 = R(coef_q * u[b,0] * nn1) psi_0,            coef_q = -dt/4
//   h_i = R(coef_h * u[b,i] * nn1) (h_{i-1} W^T),    coef_h = -dt/2
// Backward, i = N_t-1 .. 1, with g the cotangent of (hr, hi):
//   du[b,i] = coef_h * sum_n nn1_n (g_im h_re - g_re h_im)
//   h, g <- R(-phi_i) h, R(-phi_i) g;   h, g <- h W^H, g W^H
// and du[b,0] with coef_q. The chain is unitary, so the backward pass
// rebuilds h_{i-1} from h_i and stores no trajectory.
//
// What bounds it on this card: fp32 FMA throughput. Each step is 4 real
// (R x 128) x (128 x 128) products forward (one complex GEMV per row) and 8
// backward, against HBM traffic of only the controls and the end states.
// The design keeps everything the time loop touches on chip:
//   * one block owns R = 32 batch rows for all N_t steps (B = 4096 gives
//     128 blocks for 132 SMs); time is a loop inside the block;
//   * W (split into Wr, Wi) sits in dynamic shared memory, 128 KiB, laid out
//     so that the 32 threads of a warp read 32 consecutive columns;
//   * the state tile sits in shared memory as [n][R] (row stride R+4, which
//     keeps the 16-byte stores conflict-free) and is read as float4
//     broadcasts; each thread owns one column k and 16 rows, and keeps its
//     16 complex outputs in registers, so one tile buffer and two barriers
//     per step suffice;
//   * products are IEEE fp32 FMAs on the CUDA cores (no TF32, no fast
//     math); the phase uses sincosf, not __sincosf.
// Tensor-core paths (mma/wgmma with 3xTF32 splits) and TMA are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int N = 128;                   // padded sector width (ns_p)
constexpr int R = 32;                    // batch rows per block
constexpr int RS = R + 4;                // row stride of the [n][R] tiles
constexpr int RPT = 16;                  // rows per thread
constexpr int GROUPS = R / RPT;          // row groups per block
constexpr int THREADS = N * GROUPS;      // 256
constexpr int WARPS_PER_GROUP = N / 32;  // 4

constexpr size_t FWD_SMEM = sizeof(float) * (2 * N * N + 2 * N * RS);
constexpr size_t BWD_SMEM =
    sizeof(float) * (2 * N * N + 4 * N * RS + WARPS_PER_GROUP * R);

// Copy W (row-major, n x n) into shared memory; transposed for the forward
// product x W^T, as is for the backward product x W^H.
__device__ __forceinline__ void load_w(float* sWr, float* sWi,
                                       const float* __restrict__ Wr,
                                       const float* __restrict__ Wi,
                                       bool transpose) {
  for (int e = threadIdx.x; e < N * N; e += THREADS) {
    const int row = e / N, col = e % N;
    const int dst = transpose ? col * N + row : e;
    sWr[dst] = Wr[e];
    sWi[dst] = Wi[e];
  }
}

__device__ __forceinline__ void publish(float* tile, const float* v, int k,
                                        int rg) {
#pragma unroll
  for (int r = 0; r < RPT; r += 4)
    *reinterpret_cast<float4*>(&tile[k * RS + rg * RPT + r]) =
        make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
}

__device__ __forceinline__ float control(const float* __restrict__ u_bt,
                                         int b, int B, int n_t, int i) {
  return b < B ? u_bt[(size_t)b * n_t + i] : 0.f;
}

// Sum part[r] over the 128 columns of each row; column k lives in thread
// k of the row group. Lane 0 of each warp leaves its partial in sRed.
__device__ __forceinline__ void row_partials(const float* part, float* sRed,
                                             int k, int rg) {
  const int lane = k % 32, wq = k / 32;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float v = part[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) sRed[wq * R + rg * RPT + r] = v;
  }
}

// After a barrier: threads 0..R-1 finish the row sums and store du.
__device__ __forceinline__ void store_du(const float* sRed, float coef,
                                         float* __restrict__ du_bt, int B,
                                         int n_t, int i) {
  const int t = threadIdx.x;
  if (t < R) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS_PER_GROUP; ++w) s += sRed[w * R + t];
    const int b = blockIdx.x * R + t;
    if (b < B) du_bt[(size_t)b * n_t + i] = coef * s;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const float* __restrict__ Wr, const float* __restrict__ Wi,
               const float* __restrict__ nn1, const float* __restrict__ u_bt,
               const float* __restrict__ h0r, const float* __restrict__ h0i,
               float* __restrict__ hTr, float* __restrict__ hTi, int B,
               int n_t, float coef_q, float coef_h) {
  extern __shared__ __align__(16) float smem[];
  float* sWr = smem;           // sW[j * N + k] = W[k][j]
  float* sWi = sWr + N * N;
  float* sHr = sWi + N * N;    // state tile, sH[j * RS + row]
  float* sHi = sHr + N * RS;

  const int k = threadIdx.x % N;
  const int rg = threadIdx.x / N;
  const int b0 = blockIdx.x * R + rg * RPT;
  load_w(sWr, sWi, Wr, Wi, true);

  const float nk = nn1[k];
  float hr[RPT], hi[RPT];
  {
    const float xr = h0r[k], xi = h0i[k];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float s, c;
      sincosf(coef_q * (control(u_bt, b0 + r, B, n_t, 0) * nk), &s, &c);
      hr[r] = c * xr - s * xi;
      hi[r] = c * xi + s * xr;
    }
  }

  for (int i = 1; i < n_t; ++i) {
    publish(sHr, hr, k, rg);
    publish(sHi, hi, k, rg);
    __syncthreads();
    float ar[RPT], ai[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) ar[r] = ai[r] = 0.f;
#pragma unroll 2
    for (int j = 0; j < N; ++j) {
      const float wr = sWr[j * N + k], wi = sWi[j * N + k];
      const float* xr_row = &sHr[j * RS + rg * RPT];
      const float* xi_row = &sHi[j * RS + rg * RPT];
#pragma unroll
      for (int r = 0; r < RPT; r += 4) {
        const float4 xr = *reinterpret_cast<const float4*>(xr_row + r);
        const float4 xi = *reinterpret_cast<const float4*>(xi_row + r);
        const float xrv[4] = {xr.x, xr.y, xr.z, xr.w};
        const float xiv[4] = {xi.x, xi.y, xi.z, xi.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ar[r + q] = fmaf(xrv[q], wr, ar[r + q]);
          ar[r + q] = fmaf(-xiv[q], wi, ar[r + q]);
          ai[r + q] = fmaf(xrv[q], wi, ai[r + q]);
          ai[r + q] = fmaf(xiv[q], wr, ai[r + q]);
        }
      }
    }
    __syncthreads();  // the tile is rewritten at the top of the next step
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float s, c;
      sincosf(coef_h * (control(u_bt, b0 + r, B, n_t, i) * nk), &s, &c);
      hr[r] = c * ar[r] - s * ai[r];
      hi[r] = c * ai[r] + s * ar[r];
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int b = b0 + r;
    if (b < B) {
      hTr[(size_t)b * N + k] = hr[r];
      hTi[(size_t)b * N + k] = hi[r];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const float* __restrict__ Wr, const float* __restrict__ Wi,
               const float* __restrict__ nn1, const float* __restrict__ u_bt,
               const float* __restrict__ hTr, const float* __restrict__ hTi,
               const float* __restrict__ gTr, const float* __restrict__ gTi,
               float* __restrict__ du_bt, int B, int n_t, float coef_q,
               float coef_h) {
  extern __shared__ __align__(16) float smem[];
  float* sWr = smem;           // sW[j * N + k] = W[j][k]
  float* sWi = sWr + N * N;
  float* sHr = sWi + N * N;    // tiles sX[j * RS + row]
  float* sHi = sHr + N * RS;
  float* sGr = sHi + N * RS;
  float* sGi = sGr + N * RS;
  float* sRed = sGi + N * RS;  // [WARPS_PER_GROUP][R] row partials

  const int k = threadIdx.x % N;
  const int rg = threadIdx.x / N;
  const int b0 = blockIdx.x * R + rg * RPT;
  load_w(sWr, sWi, Wr, Wi, false);

  const float nk = nn1[k];
  float hr[RPT], hi[RPT], gr[RPT], gi[RPT], part[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int b = b0 + r;
    const size_t o = (size_t)b * N + k;
    hr[r] = b < B ? hTr[o] : 0.f;
    hi[r] = b < B ? hTi[o] : 0.f;
    gr[r] = b < B ? gTr[o] : 0.f;
    gi[r] = b < B ? gTi[o] : 0.f;
  }

  for (int i = n_t - 1; i >= 1; --i) {
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      part[r] = nk * (gi[r] * hr[r] - gr[r] * hi[r]);
    row_partials(part, sRed, k, rg);
    // R(-phi_i) on h and g, in registers, then publish
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float s, c;
      sincosf(coef_h * (control(u_bt, b0 + r, B, n_t, i) * nk), &s, &c);
      const float ar = c * hr[r] + s * hi[r];
      const float ai = c * hi[r] - s * hr[r];
      const float br = c * gr[r] + s * gi[r];
      const float bi = c * gi[r] - s * gr[r];
      hr[r] = ar;
      hi[r] = ai;
      gr[r] = br;
      gi[r] = bi;
    }
    publish(sHr, hr, k, rg);
    publish(sHi, hi, k, rg);
    publish(sGr, gr, k, rg);
    publish(sGi, gi, k, rg);
    __syncthreads();
    store_du(sRed, coef_h, du_bt, B, n_t, i);
#pragma unroll
    for (int r = 0; r < RPT; ++r) hr[r] = hi[r] = gr[r] = gi[r] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float wr = sWr[j * N + k], wi = sWi[j * N + k];
      const int o = j * RS + rg * RPT;
#pragma unroll
      for (int r = 0; r < RPT; r += 4) {
        const float4 xr = *reinterpret_cast<const float4*>(&sHr[o + r]);
        const float4 xi = *reinterpret_cast<const float4*>(&sHi[o + r]);
        const float4 yr = *reinterpret_cast<const float4*>(&sGr[o + r]);
        const float4 yi = *reinterpret_cast<const float4*>(&sGi[o + r]);
        const float xrv[4] = {xr.x, xr.y, xr.z, xr.w};
        const float xiv[4] = {xi.x, xi.y, xi.z, xi.w};
        const float yrv[4] = {yr.x, yr.y, yr.z, yr.w};
        const float yiv[4] = {yi.x, yi.y, yi.z, yi.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // x W^H: re = xr Wr + xi Wi, im = xi Wr - xr Wi
          hr[r + q] = fmaf(xrv[q], wr, hr[r + q]);
          hr[r + q] = fmaf(xiv[q], wi, hr[r + q]);
          hi[r + q] = fmaf(xiv[q], wr, hi[r + q]);
          hi[r + q] = fmaf(-xrv[q], wi, hi[r + q]);
          gr[r + q] = fmaf(yrv[q], wr, gr[r + q]);
          gr[r + q] = fmaf(yiv[q], wi, gr[r + q]);
          gi[r + q] = fmaf(yiv[q], wr, gi[r + q]);
          gi[r + q] = fmaf(-yrv[q], wi, gi[r + q]);
        }
      }
    }
    __syncthreads();  // tiles and sRed are rewritten in the next step
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r)
    part[r] = nk * (gi[r] * hr[r] - gr[r] * hi[r]);
  row_partials(part, sRed, k, rg);
  __syncthreads();
  store_du(sRed, coef_q, du_bt, B, n_t, 0);
}

}  // namespace

// C entry points, bound with ctypes. All pointers are device pointers to
// contiguous float32 arrays: W (n, n) row-major, nn1 (n,), u_bt and du_bt
// (B, n_t), h0 (n,), hT and gT (B, n), with n = 128. They launch on
// `stream` and return cudaGetLastError().
extern "C" int sector_chain_fwd(const void* Wr, const void* Wi,
                                const void* nn1, const void* u_bt,
                                const void* h0r, const void* h0i, void* hTr,
                                void* hTi, int B, int n_t, float coef_q,
                                float coef_h, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  fwd_kernel<<<(B + R - 1) / R, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)Wr, (const float*)Wi, (const float*)nn1,
      (const float*)u_bt, (const float*)h0r, (const float*)h0i, (float*)hTr,
      (float*)hTi, B, n_t, coef_q, coef_h);
  return (int)cudaGetLastError();
}

extern "C" int sector_chain_bwd(const void* Wr, const void* Wi,
                                const void* nn1, const void* u_bt,
                                const void* hTr, const void* hTi,
                                const void* gTr, const void* gTi, void* du_bt,
                                int B, int n_t, float coef_q, float coef_h,
                                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  bwd_kernel<<<(B + R - 1) / R, THREADS, BWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)Wr, (const float*)Wi, (const float*)nn1,
      (const float*)u_bt, (const float*)hTr, (const float*)hTi,
      (const float*)gTr, (const float*)gTi, (float*)du_bt, B, n_t, coef_q,
      coef_h);
  return (int)cudaGetLastError();
}
