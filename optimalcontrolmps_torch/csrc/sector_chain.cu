// Fused sector Trotter chain for Hopper (sm_90a): forward and reversible
// backward, each one kernel launch for the whole (B, N_t) control batch,
// with the chain's products on the tensor cores in 3xTF32.
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
// What bounds it on this card: the products. Each step is 4 real
// (128 x 128) x (128 x R) products forward and 8 backward, against HBM
// traffic of only the controls and the end states. The TPU kernels run
// them on the MXU at the multi-pass float32 precision that
// optimalcontrolmps_tpu/ops/precision.py enforces; Hopper's counterpart is
// the 3xTF32 split on the tensor cores (495 TFLOP/s TF32, 165 TFLOP/s of
// fp32-grade work, against 67 TFLOP/s of fp32 FMAs on the CUDA cores):
//   * each operand x becomes big = tf32(x) and small = tf32(x - big), both
//     by cvt.rna.tf32.f32 (round to nearest), and a product is
//     small*big + big*small + big*big with fp32 accumulation. Single-pass
//     TF32 is never used: it misses the forward gate by ~900x;
//   * the tensor cores accumulate with truncation: one accumulator chained
//     over the 16 k-slices read 6.3e-5 from the fp32 twin on an H100 after
//     201 steps, three times the forward gate. So each 8-deep k-slice
//     starts from a zero accumulator (small passes first, the big pass
//     last) and its sum is added into fp32 registers on the CUDA cores,
//     which round to nearest (5.2e-6);
//   * route: wgmma (m64nNk8, TF32), the full-rate one, as D = W . X^T: the
//     128 states are M (two warp groups of 64; each warp's 16 rows are an
//     m-tile) and K (16 k-slices), a block's R = 8 NT batch rows are N.
//     W is the constant A operand, from registers; the state tile is B,
//     from shared memory through a descriptor. One block owns its rows for
//     all N_t steps, so W is read once per step per block. Each k-slice is
//     one wgmma group of 12 products; while it runs, the next slice's W
//     fragments are loaded and split and (forward) the previous slice's
//     sums are added. (mma.sync m16n8k8 with the same arithmetic took
//     1.86 / 3.62 ms at (4096, 201) on an H100, against 1.29 / 2.73 here.)
//     The imm-scale-a of wgmma gives -Wi for free;
//   * shared memory is the first constraint: Wr, Wi in fp32 take 128 KiB,
//     and their TF32 low parts would take another 128 KiB of the 227 KB a
//     block gets. W is held in fp32, in A-fragment order (one 16-byte load
//     per thread per fragment), and split into registers as it is loaded:
//     three operations per element per step against 2 x 6 x N / 8
//     products of 64 x 8 x 8 per fragment. The state tile is written split
//     (big, small; re, im: four K-major tiles, NT x 16 KiB) by its
//     producer, once per step;
//   * the backward's h and g share one tile: h's product, then g's, four
//     barriers per step instead of two tiles (the second would not fit).
//     It holds h and g in registers besides the product, so it adds each
//     slice's sums after the slice (one accumulator buffer), which keeps
//     it within 255 registers without spills;
//   * the phase: nn1 takes few distinct values (6 in the flagship sector),
//     so a block builds a table of the distinct values from its input and
//     computes sincosf once per (distinct value, row, step) instead of per
//     (state, row, step); above D_MAX distinct values it takes sincosf per
//     element. sincosf, not __sincosf, either way;
//   * filling the card: NT (1, 2 or 4) is picked per launch so that the
//     ceil(B / 8) n-tiles spread over all SMs (B = 4096: 512 n-tiles, 4 per
//     block, 128 blocks; no split of 8-row tiles does better than 4 per SM
//     on 132 SMs). Ragged batches are masked (rows >= B run on u = 0 and
//     are not stored);
//   * the 7 padded states of the flagship's 121 lie inside the last m-tile
//     and k-slice, so the tile grid does no extra tile for them; their
//     outputs are what the twin gives (W is the identity there).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int N = 128;               // padded sector width (ns_p)
constexpr int MT = N / 16;           // m-tiles = warps (two warp groups)
constexpr int KT = N / 8;            // k-slices
constexpr int THREADS = 32 * MT;     // 256
constexpr int D_MAX = 16;            // distinct nn1 values the table holds
constexpr int W_PART = MT * KT * 32; // float4 fragments per real part of W

template <int NT>
struct Layout {
  static constexpr int R = 8 * NT;  // batch rows per block (wgmma's N)
  static constexpr int TILE = N * R;  // floats per state tile (of four)
  // floats: W (2 parts), the state tiles, the phase table (float2; two in
  // the backward), the rows' controls (two), nn1, the distinct values, the
  // backward's row partials of du; ints: slots, ranks, counts
  static constexpr size_t FWD_SMEM =
      sizeof(float) * (8 * W_PART + 4 * TILE + 2 * D_MAX * R + R + N + D_MAX) +
      sizeof(int) * (2 * N + 4);
  static constexpr size_t BWD_SMEM =
      sizeof(float) * (8 * W_PART + 4 * TILE + 4 * D_MAX * R + 2 * R + N +
                       D_MAX + MT * R) +
      sizeof(int) * (2 * N + 4);
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32; x - big is exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d (+)= SA A . B: wgmma m64nNk8 TF32 (N = 8 NT) of a warp group. A from
// registers: warp w's rows 16 w + gid (+8), cols tig (+4), as in the load_w
// fragments; B from shared memory through a descriptor (K-major, no
// swizzle); d the fp32 accumulator, element (row 16 w + gid + 8 (q >> 1),
// col 8 j + 2 tig + (q & 1)) in d[4 j + q]; scale_d = 0 starts from zero.
template <int NT, int SA>
struct Wgmma;

template <int SA>
struct Wgmma<1, SA> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, %10, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(SA));
  }
};

template <int SA>
struct Wgmma<2, SA> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, %14, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(SA));
  }
};

template <int SA>
struct Wgmma<4, SA> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, %22, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(SA));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// keep the compiler from moving register reads or writes across a wait
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}
// shared-memory writes of the generic proxy, visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// matrix descriptor, no swizzle: start, leading (K) and stride (N) byte
// offsets between core matrices of 8 rows x 16 bytes
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// W (row-major n x n) into shared memory as A fragments: A[m][k] = W[m][k]
// (forward, x W^T) or W[k][m] (backward, x W^H). Fragment (mt, kt) of lane
// (gid, tig) holds A[16mt + gid (+8)][8kt + tig (+4)] as
// {a0, a1, a2, a3} = rows (gid, gid+8) x cols (tig, tig+4), col-major.
__device__ __forceinline__ void load_w(float* sW, const float* __restrict__ Wr,
                                       const float* __restrict__ Wi,
                                       bool transpose) {
  for (int e = threadIdx.x; e < N * N; e += THREADS) {
    const int row = e / N, col = e % N;
    const int m = transpose ? col : row, k = transpose ? row : col;
    const int rr = m & 15, cc = k & 7;
    const int dst = (((m >> 4) * KT + (k >> 3)) * 32 + (rr & 7) * 4 +
                     (cc & 3)) * 4 + (rr >> 3) + 2 * (cc >> 2);
    sW[dst] = Wr[e];
    sW[4 * W_PART + dst] = Wi[e];
  }
}

// The state tile: four K-major tiles (re big, re small, im big, im small)
// of 128 states x R rows, each in core matrices of 8 rows x 4 states
// (16 bytes per row): core matrix (k-slice kt, half h, row block j) at
// ((2 kt + h) R / 8 + j) 128 bytes. B[state][row] = x[row][state].
template <int R>
__device__ __forceinline__ void put(float* sX, int s, int l, float vr,
                                    float vi) {
  const int o = ((2 * (s >> 3) + ((s >> 2) & 1)) * (R / 8) + (l >> 3)) * 32 +
                (l & 7) * 4 + (s & 3);
  uint32_t b, sm;
  split(vr, b, sm);
  sX[o] = __uint_as_float(b);
  sX[N * R + o] = __uint_as_float(sm);
  split(vi, b, sm);
  sX[2 * N * R + o] = __uint_as_float(b);
  sX[3 * N * R + o] = __uint_as_float(sm);
}

// W's fragments of k-slice kt for the warp's m-tile, split:
// a[0] = A0 big, a[1] = A0 small, a[2] = A1 big, a[3] = A1 small
__device__ __forceinline__ void load_split(uint32_t (&a)[4][4],
                                           const float4* w0p,
                                           const float4* w1p, int kt,
                                           int lane) {
  const float4 w0 = w0p[kt * 32 + lane];
  const float4 w1 = w1p[kt * 32 + lane];
  const float w0v[4] = {w0.x, w0.y, w0.z, w0.w};
  const float w1v[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    split(w0v[q], a[0][q], a[1][q]);
    split(w1v[q], a[2][q], a[3][q]);
  }
}

// D = A0 . X + (-)A1 . X' for the warp group's 64 states (the warp's m-tile
// mt is 16 of them) and the block's R = 8 NT rows:
//   forward  (A = W):   dr = Wr xr - Wi xi,    di = Wi xr + Wr xi
//   backward (A = W^T): dr = Wr^T xr + Wi^T xi, di = Wr^T xi - Wi^T xr
// Each k-slice: six products per output from a zero accumulator (the small
// passes of both terms, then their big passes) as one wgmma group, whose
// sums go into dr / di in fp32. While a slice's group runs, the next
// slice's A is split and, with two accumulator buffers (BUF = 2), the
// previous slice's sums are added; with one (BUF = 1, fewer registers),
// they are added after the group.
template <int NT, bool FWD, int BUF>
__device__ __forceinline__ void product(const float* sW, const float* sX,
                                        int mt, int lane, float (&dr)[NT][4],
                                        float (&di)[NT][4]) {
  constexpr int R = 8 * NT;
  constexpr int SR = FWD ? -1 : 1;  // the sign of A1 in dr
  constexpr int SI = FWD ? 1 : -1;  // the sign of A1 in di
  constexpr uint32_t TILE_B = sizeof(float) * Layout<NT>::TILE;
  constexpr uint32_t KSTEP = 2 * (R / 8) * 128;  // bytes per k-slice
  const float4* w0p = reinterpret_cast<const float4*>(sW) + mt * KT * 32;
  const float4* w1p = w0p + W_PART;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(sX));
  uint64_t dx[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    dx[t] = descriptor(base + t * TILE_B, (R / 8) * 128, 128);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) dr[nt][q] = di[nt][q] = 0.f;
  float acc[BUF][2][4 * NT];
  uint32_t a[2][4][4];
  auto add = [&](float (&x)[2][4 * NT]) {
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) {
      pin(x[0][e]);
      pin(x[1][e]);
      dr[e >> 2][e & 3] += x[0][e];
      di[e >> 2][e & 3] += x[1][e];
    }
  };
  load_split(a[0], w0p, w1p, 0, lane);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt % BUF, ab = kt & 1;
    const uint64_t off = (uint64_t)((kt * KSTEP) >> 4);
    const uint64_t xrb = dx[0] + off, xrs = dx[1] + off;
    const uint64_t xib = dx[2] + off, xis = dx[3] + off;
    wgmma_fence();
    Wgmma<NT, 1>::run(acc[c][0], a[ab][1], xrb, 0);
    Wgmma<NT, SR>::run(acc[c][0], a[ab][3], xib, 1);
    Wgmma<NT, 1>::run(acc[c][0], a[ab][0], xrs, 1);
    Wgmma<NT, SR>::run(acc[c][0], a[ab][2], xis, 1);
    Wgmma<NT, 1>::run(acc[c][0], a[ab][0], xrb, 1);
    Wgmma<NT, SR>::run(acc[c][0], a[ab][2], xib, 1);
    Wgmma<NT, 1>::run(acc[c][1], a[ab][1], xib, 0);
    Wgmma<NT, SI>::run(acc[c][1], a[ab][3], xrb, 1);
    Wgmma<NT, 1>::run(acc[c][1], a[ab][0], xis, 1);
    Wgmma<NT, SI>::run(acc[c][1], a[ab][2], xrs, 1);
    Wgmma<NT, 1>::run(acc[c][1], a[ab][0], xib, 1);
    Wgmma<NT, SI>::run(acc[c][1], a[ab][2], xrb, 1);
    wgmma_commit();
    if (BUF == 2 && kt > 0) {
      wgmma_wait<1>();  // slice kt - 1 is done: its registers are free
      add(acc[(kt + 1) % BUF]);
    }
    if (kt + 1 < KT) {
      // the other A buffer fed slice kt - 1, which is done: keep its
      // registers live up to here, so that the next split cannot take them
      // while that slice may still read them
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int q = 0; q < 4; ++q) pin(a[ab ^ 1][v][q]);
      load_split(a[ab ^ 1], w0p, w1p, kt + 1, lane);
    }
    if (BUF == 1) {
      wgmma_wait<0>();
      add(acc[0]);
    }
  }
  if (BUF == 2) {
    wgmma_wait<0>();
    add(acc[(KT - 1) % BUF]);
  }
}

// Per block: sSlot[s] = index of nn1[s] among the distinct values, which
// go to sVal (when there are at most D_MAX). Returns the count of distinct
// values. Values compare by ==, so a NaN is its own value.
__device__ int phase_slots(const float* __restrict__ nn1, float* sNN1,
                           int* sSlot, int* sRank, int* sCnt, float* sVal) {
  const int t = threadIdx.x;
  if (t < N) sNN1[t] = nn1[t];
  __syncthreads();
  int first = t;
  bool rep = false;
  unsigned bal = 0;
  if (t < N) {
    const float v = sNN1[t];
    for (int j = 0; j < t; ++j)
      if (sNN1[j] == v) {
        first = j;
        break;
      }
    rep = first == t;
    bal = __ballot_sync(0xffffffffu, rep);
    if ((t & 31) == 0) sCnt[t >> 5] = __popc(bal);
  }
  __syncthreads();
  const int ndist = sCnt[0] + sCnt[1] + sCnt[2] + sCnt[3];
  if (t < N) {
    int rank = __popc(bal & ((1u << (t & 31)) - 1u));
    for (int w = 0; w < (t >> 5); ++w) rank += sCnt[w];
    sRank[t] = rank;
    if (rep && rank < D_MAX) sVal[rank] = sNN1[t];
  }
  __syncthreads();
  if (t < N) sSlot[t] = sRank[first];
  __syncthreads();
  return ndist;
}

// The rows' controls at step i for this thread's two phase entries
// e = threadIdx.x + k THREADS (row e % R); issued before the step's product
// so that their latency hides behind it.
template <int R>
__device__ __forceinline__ void load_u(float (&up)[2],
                                       const float* __restrict__ u_bt, int B,
                                       int n_t, int i) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int b = blockIdx.x * R + (threadIdx.x + k * THREADS) % R;
    up[k] = b < B ? u_bt[(size_t)b * n_t + i] : 0.f;
  }
}

// The phase of a step for the block's R rows: the rows' controls sU[row],
// and, when the distinct values fit, the table
// sTab[d][row] = (cos, sin)(coef * (u[row] * val_d)). ndist * R <= 2 THREADS.
template <int R>
__device__ __forceinline__ void fill_phase(float2* sTab, float* sU,
                                           const float* sVal, int ndist,
                                           const float (&up)[2], float coef) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = threadIdx.x + k * THREADS;
    if (e < R) sU[e] = up[k];
    if (ndist <= D_MAX && e < ndist * R) {
      float s, c;
      sincosf(coef * (up[k] * sVal[e / R]), &s, &c);
      sTab[e] = make_float2(c, s);
    }
  }
}

// (cos, sin) of state s (slot, nn1 value nk) for rows l and l + 1 (l even)
template <int R>
__device__ __forceinline__ float4 phase_at(const float2* sTab, const float* sU,
                                           bool table, int slot, float nk,
                                           int l, float coef) {
  if (table) return *reinterpret_cast<const float4*>(&sTab[slot * R + l]);
  float s0, c0, s1, c1;
  sincosf(coef * (sU[l] * nk), &s0, &c0);
  sincosf(coef * (sU[l + 1] * nk), &s1, &c1);
  return make_float4(c0, s0, c1, s1);
}

// The C fragment's element q of n-tile nt: state 16 mt + gid + 8 (q >> 1),
// row 8 nt + 2 tig + (q & 1).

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const float* __restrict__ Wr, const float* __restrict__ Wi,
               const float* __restrict__ nn1, const float* __restrict__ u_bt,
               const float* __restrict__ h0r, const float* __restrict__ h0i,
               float* __restrict__ hTr, float* __restrict__ hTi, int B,
               int n_t, float coef_q, float coef_h) {
  constexpr int R = Layout<NT>::R;
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;                                   // 8 W_PART floats
  float* sX = sW + 8 * W_PART;                        // 4 TILE floats
  float2* sTab = reinterpret_cast<float2*>(sX + 4 * Layout<NT>::TILE);
  float* sU = reinterpret_cast<float*>(sTab + D_MAX * R);
  float* sNN1 = sU + R;
  float* sVal = sNN1 + N;
  int* sSlot = reinterpret_cast<int*>(sVal + D_MAX);
  int* sRank = sSlot + N;
  int* sCnt = sRank + N;

  const int lane = threadIdx.x & 31, mt = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int s0 = mt * 16 + (lane >> 2), s1 = s0 + 8;
  const int b0 = blockIdx.x * R;
  float up[2];
  load_u<R>(up, u_bt, B, n_t, 0);
  load_w(sW, Wr, Wi, false);
  const int ndist = phase_slots(nn1, sNN1, sSlot, sRank, sCnt, sVal);
  const bool table = ndist <= D_MAX;
  const float nk0 = sNN1[s0], nk1 = sNN1[s1];
  const int slot0 = sSlot[s0], slot1 = sSlot[s1];

  // h_0 = R(coef_q u_0 nn1) psi_0: the tile for step 1, or the output
  fill_phase<R>(sTab, sU, sVal, ndist, up, coef_q);
  __syncthreads();
  for (int e = threadIdx.x; e < N * R; e += THREADS) {
    const int s = e % N, l = e / N;
    float c, sn;
    if (table) {
      const float2 cs = sTab[sSlot[s] * R + l];
      c = cs.x;
      sn = cs.y;
    } else {
      sincosf(coef_q * (sU[l] * sNN1[s]), &sn, &c);
    }
    const float xr = h0r[s], xi = h0i[s];
    const float hr = c * xr - sn * xi, hi = c * xi + sn * xr;
    if (n_t > 1) {
      put<R>(sX, s, l, hr, hi);
    } else if (b0 + l < B) {
      hTr[(size_t)(b0 + l) * N + s] = hr;
      hTi[(size_t)(b0 + l) * N + s] = hi;
    }
  }
  fence_async_smem();
  __syncthreads();

  float dr[NT][4], di[NT][4];
  for (int i = 1; i < n_t; ++i) {
    load_u<R>(up, u_bt, B, n_t, i);
    product<NT, true, 2>(sW, sX, mt, lane, dr, di);
    fill_phase<R>(sTab, sU, sVal, ndist, up, coef_h);
    __syncthreads();  // the tile is read; the phase is in
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int l = nt * 8 + 2 * tig;
      const float4 p0 = phase_at<R>(sTab, sU, table, slot0, nk0, l, coef_h);
      const float4 p1 = phase_at<R>(sTab, sU, table, slot1, nk1, l, coef_h);
      const float cq[4] = {p0.x, p0.z, p1.x, p1.z};
      const float sq[4] = {p0.y, p0.w, p1.y, p1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ar = dr[nt][q], ai = di[nt][q];
        dr[nt][q] = cq[q] * ar - sq[q] * ai;
        di[nt][q] = cq[q] * ai + sq[q] * ar;
      }
      if (i < n_t - 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          put<R>(sX, (q >> 1) ? s1 : s0, l + (q & 1), dr[nt][q],
              di[nt][q]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int b = b0 + l + (q & 1), s = (q >> 1) ? s1 : s0;
          if (b < B) {
            hTr[(size_t)b * N + s] = dr[nt][q];
            hTi[(size_t)b * N + s] = di[nt][q];
          }
        }
      }
    }
    fence_async_smem();
    __syncthreads();  // the tile for step i + 1 is in
  }
}

// du partial of the warp's 16 states for rows l, l + 1 of each n-tile,
// summed over the warp's gid and left in sRed[mt][row].
template <int NT>
__device__ __forceinline__ void row_partials(
    const float (&hr)[NT][4], const float (&hi)[NT][4],
    const float (&gr)[NT][4], const float (&gi)[NT][4], float nk0,
    float nk1, float* sRed, int mt, int lane) {
  constexpr int R = Layout<NT>::R;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float p[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      p[c] = nk0 * (gi[nt][c] * hr[nt][c] - gr[nt][c] * hi[nt][c]) +
             nk1 * (gi[nt][c + 2] * hr[nt][c + 2] - gr[nt][c + 2] * hi[nt][c + 2]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        p[c] += __shfl_xor_sync(0xffffffffu, p[c], off);
    }
    if (lane < 4) {
      sRed[mt * R + nt * 8 + 2 * lane] = p[0];
      sRed[mt * R + nt * 8 + 2 * lane + 1] = p[1];
    }
  }
}

template <int R>
__device__ __forceinline__ void store_du(const float* sRed, float coef,
                                         float* __restrict__ du_bt, int B,
                                         int n_t, int i) {
  const int t = threadIdx.x;
  if (t < R) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MT; ++w) s += sRed[w * R + t];
    const int b = blockIdx.x * R + t;
    if (b < B) du_bt[(size_t)b * n_t + i] = coef * s;
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const float* __restrict__ Wr, const float* __restrict__ Wi,
               const float* __restrict__ nn1, const float* __restrict__ u_bt,
               const float* __restrict__ hTr, const float* __restrict__ hTi,
               const float* __restrict__ gTr, const float* __restrict__ gTi,
               float* __restrict__ du_bt, int B, int n_t, float coef_q,
               float coef_h) {
  constexpr int R = Layout<NT>::R;
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;
  float* sX = sW + 8 * W_PART;
  float2* sTab = reinterpret_cast<float2*>(sX + 4 * Layout<NT>::TILE);
  float* sU = reinterpret_cast<float*>(sTab + 2 * D_MAX * R);  // 2 R
  float* sNN1 = sU + 2 * R;
  float* sVal = sNN1 + N;
  float* sRed = sVal + D_MAX;                                  // MT x R
  int* sSlot = reinterpret_cast<int*>(sRed + MT * R);
  int* sRank = sSlot + N;
  int* sCnt = sRank + N;

  const int lane = threadIdx.x & 31, mt = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int s0 = mt * 16 + (lane >> 2), s1 = s0 + 8;
  const int b0 = blockIdx.x * R;
  float up[2];
  load_u<R>(up, u_bt, B, n_t, n_t - 1);
  load_w(sW, Wr, Wi, true);
  const int ndist = phase_slots(nn1, sNN1, sSlot, sRank, sCnt, sVal);
  const bool table = ndist <= D_MAX;
  const float nk0 = sNN1[s0], nk1 = sNN1[s1];
  const int slot0 = sSlot[s0], slot1 = sSlot[s1];

  float hr[NT][4], hi[NT][4], gr[NT][4], gi[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + nt * 8 + 2 * tig + (q & 1);
      const size_t o = (size_t)b * N + ((q >> 1) ? s1 : s0);
      hr[nt][q] = b < B ? hTr[o] : 0.f;
      hi[nt][q] = b < B ? hTi[o] : 0.f;
      gr[nt][q] = b < B ? gTr[o] : 0.f;
      gi[nt][q] = b < B ? gTi[o] : 0.f;
    }
  if (n_t > 1)
    fill_phase<R>(sTab + ((n_t - 1) & 1) * D_MAX * R, sU + ((n_t - 1) & 1) * R,
                  sVal, ndist, up, coef_h);
  __syncthreads();

  for (int i = n_t - 1; i >= 1; --i) {
    const float2* tab = sTab + (i & 1) * D_MAX * R;
    const float* su = sU + (i & 1) * R;
    row_partials<NT>(hr, hi, gr, gi, nk0, nk1, sRed, mt, lane);
    // R(-phi_i) on h and g, then h to the tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int l = nt * 8 + 2 * tig;
      const float4 p0 = phase_at<R>(tab, su, table, slot0, nk0, l, coef_h);
      const float4 p1 = phase_at<R>(tab, su, table, slot1, nk1, l, coef_h);
      const float cq[4] = {p0.x, p0.z, p1.x, p1.z};
      const float sq[4] = {p0.y, p0.w, p1.y, p1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float c = cq[q], s = sq[q];
        const float ar = c * hr[nt][q] + s * hi[nt][q];
        const float ai = c * hi[nt][q] - s * hr[nt][q];
        const float br = c * gr[nt][q] + s * gi[nt][q];
        const float bi = c * gi[nt][q] - s * gr[nt][q];
        hr[nt][q] = ar;
        hi[nt][q] = ai;
        gr[nt][q] = br;
        gi[nt][q] = bi;
        put<R>(sX, (q >> 1) ? s1 : s0, l + (q & 1), ar, ai);
      }
    }
    fence_async_smem();
    __syncthreads();  // the h tile and the row partials are in
    store_du<R>(sRed, coef_h, du_bt, B, n_t, i);
    if (i > 1) load_u<R>(up, u_bt, B, n_t, i - 1);
    product<NT, false, 1>(sW, sX, mt, lane, hr, hi);
    // the phase of step i - 1 into the other buffer
    if (i > 1)
      fill_phase<R>(sTab + ((i - 1) & 1) * D_MAX * R, sU + ((i - 1) & 1) * R,
                    sVal, ndist, up, coef_h);
    __syncthreads();  // the h tile is read
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int l = nt * 8 + 2 * tig;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        put<R>(sX, (q >> 1) ? s1 : s0, l + (q & 1), gr[nt][q], gi[nt][q]);
    }
    fence_async_smem();
    __syncthreads();  // the g tile is in
    product<NT, false, 1>(sW, sX, mt, lane, gr, gi);
    __syncthreads();  // the g tile, sRed and this step's phase are read
  }

  row_partials<NT>(hr, hi, gr, gi, nk0, nk1, sRed, mt, lane);
  __syncthreads();
  store_du<R>(sRed, coef_q, du_bt, B, n_t, 0);
}

// n-tiles per block (1, 2 or 4): the fewest that put every n-tile of the
// batch on the card's SMs in one wave, at most 4
int pick_nt(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (B + 7) / 8;
  const int nt = (tiles + sms - 1) / sms;
  return nt <= 2 ? nt : 4;
}

template <int NT>
int launch_fwd(const void* Wr, const void* Wi, const void* nn1,
               const void* u_bt, const void* h0r, const void* h0i, void* hTr,
               void* hTi, int B, int n_t, float coef_q, float coef_h,
               cudaStream_t stream) {
  constexpr size_t smem = Layout<NT>::FWD_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int R = Layout<NT>::R;
  fwd_kernel<NT><<<(B + R - 1) / R, THREADS, smem, stream>>>(
      (const float*)Wr, (const float*)Wi, (const float*)nn1,
      (const float*)u_bt, (const float*)h0r, (const float*)h0i, (float*)hTr,
      (float*)hTi, B, n_t, coef_q, coef_h);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_bwd(const void* Wr, const void* Wi, const void* nn1,
               const void* u_bt, const void* hTr, const void* hTi,
               const void* gTr, const void* gTi, void* du_bt, int B, int n_t,
               float coef_q, float coef_h, cudaStream_t stream) {
  constexpr size_t smem = Layout<NT>::BWD_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int R = Layout<NT>::R;
  bwd_kernel<NT><<<(B + R - 1) / R, THREADS, smem, stream>>>(
      (const float*)Wr, (const float*)Wi, (const float*)nn1,
      (const float*)u_bt, (const float*)hTr, (const float*)hTi,
      (const float*)gTr, (const float*)gTi, (float*)du_bt, B, n_t, coef_q,
      coef_h);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_nt(B)) {
    case 1: return launch_fwd<1>(Wr, Wi, nn1, u_bt, h0r, h0i, hTr, hTi, B,
                                 n_t, coef_q, coef_h, st);
    case 2: return launch_fwd<2>(Wr, Wi, nn1, u_bt, h0r, h0i, hTr, hTi, B,
                                 n_t, coef_q, coef_h, st);
    default: return launch_fwd<4>(Wr, Wi, nn1, u_bt, h0r, h0i, hTr, hTi, B,
                                  n_t, coef_q, coef_h, st);
  }
}

extern "C" int sector_chain_bwd(const void* Wr, const void* Wi,
                                const void* nn1, const void* u_bt,
                                const void* hTr, const void* hTi,
                                const void* gTr, const void* gTi, void* du_bt,
                                int B, int n_t, float coef_q, float coef_h,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_nt(B)) {
    case 1: return launch_bwd<1>(Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi,
                                 du_bt, B, n_t, coef_q, coef_h, st);
    case 2: return launch_bwd<2>(Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi,
                                 du_bt, B, n_t, coef_q, coef_h, st);
    default: return launch_bwd<4>(Wr, Wi, nn1, u_bt, hTr, hTi, gTr, gTi,
                                  du_bt, B, n_t, coef_q, coef_h, st);
  }
}
