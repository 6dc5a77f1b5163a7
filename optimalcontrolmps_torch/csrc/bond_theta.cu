// Two-site theta of a TEBD bond update for Hopper (sm_90a), complex64 and
// complex128 from one template.
//
// Replaces the Pallas TPU kernel optimalcontrolmps_tpu/ops/pallas_kernels.py
// _kernel (:30, launched by fused_bond_theta, pallas_call at :86). Its plain
// PyTorch twin is bond_theta_reference in optimalcontrolmps_torch/ops/
// bond_theta.py, with the same algebra:
//
//   theta[b, l*p+P, Q*chi+r] = sum_{p',q} G[P*p+Q, p'*p+q]
//                              * sum_m Ai[b,l,p',m] Aj[b,m,q,r]
//
// Ai, Aj: (B, chi, p, chi) with contiguous inner dimensions and any batch
// stride (an `unbind` view of an MPS batch is taken as it is); G: (p^2, p^2)
// and theta: (B, chi*p, p*chi), contiguous. Torch's complex storage is
// interleaved (re, im), so the kernel reads it as float2 / double2.
//
// What bounds it, per batch element: 8 (chi^3 p^2 + p^4 chi^2) real
// operations against (2 chi^2 p + chi^2 p^2) complex elements moved (inputs
// read once, theta written once). On an H100 (3.35 TB/s; 67 TFLOP/s fp32 on
// the CUDA cores, 67 TFLOP/s fp64 only through the DMMA tensor cores):
//   * (4, 25, 5) complex128, the MPS driver's bond: 25 MFLOP and 1.4 MB,
//     0.42 us by bytes, far under one launch. Latency bounds it: the launch,
//     the chain of global loads inside a block, and how many threads share
//     the work; and, per call, the host's enqueue;
//   * (8, 128, 8) complex64, a reference-scale bond: 12.9 GFLOP against
//     84 MB, so the fp32 FMA rate (0.19 ms);
//   * (1, 200, 8) and (2, 128, 8) complex128: the fp64 rate (0.081 and
//     0.048 ms). This kernel runs fp64 on the CUDA cores (34 TFLOP/s), so it
//     is capped at 50% of that bound.
//
// Design: two complex GEMMs fused in one block.
//   * A block owns Lt left indices l and Rt right indices r of one batch
//     element, with all of p and q: a stage-1 tile of (Lt*p) x (p*Rt) <= BM
//     x BM. Each Aj element is read from L2 about chi/Lt times, not chi.
//   * Stage 1, T[(l,p'), (q,r)] = sum_m Ai[b,l,p',m] Aj[b,m,q,r]: K = chi is
//     streamed through shared memory in chunks of KC, double-buffered with
//     cp.async and zero-filled past the ragged edge. Each thread keeps a
//     TM x TN complex register tile of T: a K step is TM + TN shared loads
//     for TM*TN complex FMAs, and nothing is read back from shared memory.
//   * Stage 2 writes T to shared memory once, regrouped as (p'q) x (l r),
//     over stage 1's B buffers, and applies G as a (p^2 x p^2) x
//     (p^2 x Lt*Rt) product into registers, G's K chunks double-buffered
//     through the A buffers. Consecutive threads store consecutive r.
//   * Shared memory depends on p and the tile, not on chi: at most 226 KB
//     (p <= 2) and 162 KB for 3 <= p <= 10, under the 227 KB a block can
//     have. The wrapper's plan (`_plan` in ops/bond_theta.py) picks Lt and
//     the tile, and refuses only p >= 21 (complex128) or 30 (complex64).
//   * Two tiles, 256 threads each: BM = 64 with 4 x 4 complex per thread,
//     and BM = 32 with 2 x 2 where the wide grid would leave SMs idle, as
//     at the main path's shape (100 blocks there, against 36).
//   * IEEE FMAs on the CUDA cores in the input's own precision: no TF32, no
//     fast math, no tensor cores.
//   * Launch: the opt-in to more than 48 KB of dynamic shared memory is
//     made once per instantiation and device, not on every call.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr size_t SMEM_LIMIT = 232448;  // per block, after opting in
constexpr int KC = 16;                 // K chunk, both stages
constexpr int MAX_DEVICES = 64;

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

// one element global -> shared, asynchronously; zero-filled when !valid
// (src-size 0 reads nothing, so src only has to be a valid address)
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory in elements: two A buffers (BM x (KC+1), padded against
// bank conflicts), then two B buffers (KC x BM) for stage 1, which stage 2
// overlays with T (m2r x n2s: p^2 rows rounded up to whole K chunks, the
// rows past p^2 zero).
template <int BM>
struct Layout {
  static constexpr int LDA = KC + 1;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = KC * BM;
  static size_t elems(int p, int lt, int rt) {
    const size_t t = (size_t)m2r(p) * n2s(lt, rt);
    const size_t b = 2 * (size_t)B_ELEMS;
    return 2 * (size_t)A_ELEMS + (b > t ? b : t);
  }
  __host__ __device__ static int m2r(int p) {
    return (p * p + KC - 1) / KC * KC;
  }
  // T's row length: Lt*Rt rounded up to whole BM-wide tiles of stage 2
  __host__ __device__ static int n2s(int lt, int rt) {
    return (lt * rt + BM - 1) / BM * BM;
  }
};

// sA[i][kk] = src[i*ld + k0 + kk] for i < nrows and k0 + kk < ncols, else
// 0: a chunk of K of a row-major matrix. Each thread copies column ka of
// rows ia, ia + THREADS/KC, ...
template <typename T, int BM, int THREADS>
__device__ __forceinline__ void load_a(T* sA, const T* src, int ld, int k0,
                                       int nrows, int ncols, int ka, int ia) {
  constexpr int STEP = THREADS / KC, REPS = BM * KC / THREADS;
  const bool k_ok = k0 + ka < ncols;
#pragma unroll
  for (int s = 0; s < REPS; ++s) {
    const int i = ia + s * STEP;
    const bool ok = k_ok && i < nrows;
    cp_async(sA + i * Layout<BM>::LDA + ka,
             ok ? src + (size_t)i * ld + k0 + ka : src, ok);
  }
}

// sB[k][jb] = Aj[b, m0 + k, q, r0 + r] for column jb = q*rt + r: each
// thread copies column jb of rows kb, kb + THREADS/BM, ... A column past
// the tile (col_ok false) may point outside Aj, so it reads from `base`.
template <typename T, int BM, int THREADS>
__device__ __forceinline__ void load_b(T* sB, const T* col, const T* base,
                                       int pc, int m0, int chi, bool col_ok,
                                       int jb, int kb) {
  constexpr int STEP = THREADS / BM, REPS = KC * BM / THREADS;
#pragma unroll
  for (int s = 0; s < REPS; ++s) {
    const int k = kb + s * STEP;
    const bool ok = col_ok && m0 + k < chi;
    cp_async(sB + k * BM + jb, ok ? col + (size_t)(m0 + k) * pc : base, ok);
  }
}

// acc += a (this thread's rows ty + i*TY of a BM x KC chunk) times
// b (KC rows of stride ldb, this thread's columns tx + j*TX)
template <typename T, int BM, int TM, int TN>
__device__ __forceinline__ void mma_chunk(T (&acc)[TM][TN], const T* a,
                                          const T* b, int ldb, int ty,
                                          int tx) {
  constexpr int TY = BM / TM, TX = BM / TN;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    T av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = a[(ty + i * TY) * Layout<BM>::LDA + k];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * ldb + tx + j * TX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = cmac(acc[i][j], av[i], bv[j]);
  }
}

// One block: a stage-1 tile BM x BM of T, a TM x TN complex register tile
// per thread (rows ty + i*TY, columns tx + j*TX).
template <typename R, int BM, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BM / TN))
    bond_theta_kernel(const typename Complex<R>::T* __restrict__ Ai,
                      const typename Complex<R>::T* __restrict__ Aj,
                      const typename Complex<R>::T* __restrict__ G,
                      typename Complex<R>::T* __restrict__ theta, int chi,
                      int p, long long sAi, long long sAj, int lt, int rt,
                      int nlt, int nrt) {
  using T = typename Complex<R>::T;
  using L = Layout<BM>;
  constexpr int TY = BM / TM, TX = BM / TN, THREADS = TY * TX;
  static_assert(THREADS % KC == 0 && THREADS % BM == 0, "loader mapping");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [2][BM][KC+1]
  T* sB = sA + 2 * L::A_ELEMS;             // [2][KC][BM]
  T* sT = sB;                              // [m2r][n2s], after stage 1
  const int n2s = L::n2s(lt, rt), m2r = L::m2r(p);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  long long blk = blockIdx.x;
  const int rb = (int)(blk % nrt);
  blk /= nrt;
  const int lb = (int)(blk % nlt);
  const long long b = blk / nlt;
  const int l0 = lb * lt, r0 = rb * rt;
  const int pc = p * chi;
  const int rows = lt * p;   // stage-1 rows in use: (l, p')
  const int cols = p * rt;   // stage-1 columns in use: (q, r)
  T zero;
  zero.x = 0;
  zero.y = 0;

  // loader roles, fixed per thread
  const int ka = tid % KC, ia = tid / KC;
  const int jb = tid % BM, kb = tid / BM;
  const int qb = jb / rt, rr = jb - (jb / rt) * rt;
  const bool col_ok = jb < cols && r0 + rr < chi;
  // A tile: rows l0*p .. of Ai[b] seen as a (chi*p, chi) matrix
  const T* Ab = Ai + b * sAi + (size_t)l0 * pc;
  const int a_rows = min(rows, (chi - l0) * p);
  const T* Jcol = Aj + b * sAj + (size_t)qb * chi + r0 + rr;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = zero;

  // stage 1: T = Ai[b, l0:l0+lt] (rows x chi) x Aj[b][:, :, r0:r0+rt]
  const int nk = (chi + KC - 1) / KC;
  load_a<T, BM, THREADS>(sA, Ab, chi, 0, a_rows, chi, ka, ia);
  load_b<T, BM, THREADS>(sB, Jcol, Aj, pc, 0, chi, col_ok, jb, kb);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int nb = (kt + 1) & 1;
      load_a<T, BM, THREADS>(sA + nb * L::A_ELEMS, Ab, chi, (kt + 1) * KC,
                             a_rows, chi, ka, ia);
      load_b<T, BM, THREADS>(sB + nb * L::B_ELEMS, Jcol, Aj, pc,
                             (kt + 1) * KC, chi, col_ok, jb, kb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_chunk<T, BM, TM, TN>(acc, sA + (kt & 1) * L::A_ELEMS,
                             sB + (kt & 1) * L::B_ELEMS, BM, ty, tx);
    __syncthreads();  // the buffers are refilled, or become T, next
  }

  // regroup: T[(l, p'), (q, r)] -> sT[p'*p + q][l*rt + r]; zero the rows
  // past p^2 that stage 2's last K chunk reads
  const int m2 = p * p, n2 = lt * rt;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tx + j * TX;
      if (row < rows && col < cols) {
        const int l = row / p, pr = row - (row / p) * p;
        const int q = col / rt, r = col - (col / rt) * rt;
        sT[(pr * p + q) * n2s + l * rt + r] = acc[i][j];
      }
    }
  }
  for (int e = m2 * n2s + tid; e < m2r * n2s; e += THREADS) sT[e] = zero;
  __syncthreads();

  // stage 2: out[(P,Q), (l,r)] = sum_k G[(P,Q), k] sT[k][(l,r)], in tiles
  // of BM rows of G by BM columns; G's K chunks go through the A buffers,
  // double-buffered like stage 1
  const int nk2 = m2r / KC;
  T* out = theta + b * (long long)pc * pc;
  for (int mt0 = 0; mt0 < m2; mt0 += BM) {
    const T* Gm = G + (size_t)mt0 * m2;
    for (int nt0 = 0; nt0 < n2; nt0 += BM) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = zero;
      load_a<T, BM, THREADS>(sA, Gm, m2, 0, m2 - mt0, m2, ka, ia);
      cp_async_commit();
      for (int kt = 0; kt < nk2; ++kt) {
        if (kt + 1 < nk2) {
          load_a<T, BM, THREADS>(sA + ((kt + 1) & 1) * L::A_ELEMS, Gm, m2,
                                 (kt + 1) * KC, m2 - mt0, m2, ka, ia);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        mma_chunk<T, BM, TM, TN>(acc, sA + (kt & 1) * L::A_ELEMS,
                                 sT + (size_t)kt * KC * n2s + nt0, n2s, ty,
                                 tx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int pq = mt0 + ty + i * TY;
        const int P = pq / p, Q = pq - (pq / p) * p;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = nt0 + tx + j * TX;
          const int l = n / rt, r = n - (n / rt) * rt;
          if (pq < m2 && n < n2 && l0 + l < chi && r0 + r < chi)
            out[(size_t)((l0 + l) * p + P) * pc + Q * chi + r0 + r] =
                acc[i][j];
        }
      }
    }
  }
}

// the largest dynamic shared memory opted into so far, per device
template <typename R, int BM, int TM, int TN>
int opted_in[MAX_DEVICES];

template <typename R, int BM, int TM, int TN>
int launch(const void* Ai, const void* Aj, const void* G, void* theta, int B,
           int chi, int p, long long sAi, long long sAj, int lt, int rt,
           void* stream) {
  using T = typename Complex<R>::T;
  if (B < 1 || chi < 1 || p < 1 || lt < 1 || rt < 1 || lt * p > BM ||
      rt * p > BM || sAi < 0 || sAj < 0)
    return (int)cudaErrorInvalidValue;
  const long long nlt = (chi + lt - 1) / lt, nrt = (chi + rt - 1) / rt;
  if (nlt * nrt * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<BM>::elems(p, lt, rt) * sizeof(T);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto kernel = bond_theta_kernel<R, BM, TM, TN>;
  if ((int)smem > opted_in<R, BM, TM, TN>[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in<R, BM, TM, TN>[dev] = (int)smem;
  }
  kernel<<<(unsigned)(nlt * nrt * B), (BM / TM) * (BM / TN), smem,
           (cudaStream_t)stream>>>((const T*)Ai, (const T*)Aj, (const T*)G,
                                   (T*)theta, chi, p, sAi, sAj, lt, rt,
                                   (int)nlt, (int)nrt);
  return (int)cudaGetLastError();
}

// tile 64: 4 x 4 complex per thread; tile 32: 2 x 2, for grids too small
// to fill the card. 256 threads either way.
template <typename R>
int dispatch(const void* Ai, const void* Aj, const void* G, void* theta,
             int B, int chi, int p, long long sAi, long long sAj, int tile,
             int lt, int rt, void* stream) {
  if (tile == 64)
    return launch<R, 64, 4, 4>(Ai, Aj, G, theta, B, chi, p, sAi, sAj, lt, rt,
                               stream);
  if (tile == 32)
    return launch<R, 32, 2, 2>(Ai, Aj, G, theta, B, chi, p, sAi, sAj, lt, rt,
                               stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes. Pointers are device pointers to
// interleaved complex arrays: Ai, Aj (B, chi, p, chi) with contiguous inner
// dimensions and batch strides sAi, sAj (in elements); G (p*p, p*p) and
// theta (B, chi*p, p*chi) contiguous. The plan (tile = 64 or 32, lt, rt)
// comes from the wrapper. They launch on `stream` and return
// cudaGetLastError(), or a refusal code for a plan that does not fit.
extern "C" int bond_theta_c64(const void* Ai, const void* Aj, const void* G,
                              void* theta, int B, int chi, int p,
                              long long sAi, long long sAj, int tile, int lt,
                              int rt, void* stream) {
  return dispatch<float>(Ai, Aj, G, theta, B, chi, p, sAi, sAj, tile, lt, rt,
                         stream);
}

extern "C" int bond_theta_c128(const void* Ai, const void* Aj, const void* G,
                               void* theta, int B, int chi, int p,
                               long long sAi, long long sAj, int tile, int lt,
                               int rt, void* stream) {
  return dispatch<double>(Ai, Aj, G, theta, B, chi, p, sAi, sAj, tile, lt, rt,
                          stream);
}
