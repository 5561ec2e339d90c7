// K7 affinity_tiles: the tiles of the R-Net affinity matrix, reduced to
// max / first-argmax partials without ever storing the matrix.
//
// For one sample b, T = I @ M (P, D) and U (P, D), f32, and the exists mask
// e (P,):
//   A[p, q]   = tanh(T[p] . U[q])                       p: item rows, q: user columns
//   row half  (final):   rowmax[p]  = max_q  where(e[q], A[p, q], -1e30)
//                        amax_i[p]  = the first q reaching it
//   col half (partial):  for each 128-row tile r of p:
//                        colpart[r, q] = max_{p in r} where(e[p], A[p, q], -1e30)
//                        colidx[r, q]  = the first p reaching it
// K8 (affinity_finish.cu) combines the column partials over r.  "First"
// and "max" follow torch.argmax / torch.amax: NaN beats every number and
// propagates, and a tie goes to the lowest index.  Under that total order
// the merge of two candidates does not depend on the order of merging, so
// the result is the same on every run.
//
// Replaces the two TPU kernels of umpr_tpu/ops/attention_pallas.py that
// compute the same function with the same residual contract:
//   B9  _tiled_forward / _tiled_kernel (pallas_call at :415), the column-
//       tiled flash-style kernel that umpr_tpu/ops/attention.py routes to
//       above 4 GiB of (B, P, P) f32, and
//   B10 _forward / _fwd_kernel (pallas_call at :167), the whole-P x P-tile
//       kernel taken with use_pallas=True.
// T = I @ M stays a torch.matmul outside, as the JAX package leaves it to
// XLA.  Not carried over: the TPU's online softmax across column tiles
// (K8 has the final maxima, so its softmax is exact in two passes), the
// 128-lane padding of P and D, and the _tile_q VMEM budget.
//
// What bounds it on an H100: operations.  At B=64, P=8192, D=128 the
// products are 2*B*P^2*D = 1.10e12 FLOP, 16.4 ms at the 67 TFLOP/s of
// the CUDA cores; as 3xTF32 on the tensor cores (f32 accuracy, see
// tf32x3.cuh) 3.3e12 TF32 FLOP, 6.7 ms at 495 TFLOP/s.  Beside them come
// B*P^2 = 4.3e9 accurate tanhf and the masked compare-selects; T and U are
// 537 MB together and the partials 273 MB, under 0.3 ms of HBM.
//
// Design (D <= 128: the reference's D = 2H = 128 and every narrower
// gru_size): one block of two warpgroups per (128-row tile, sample) walks
// the column tiles of 64 in order.
//   - Each warpgroup owns 64 rows.  T's rows are the wgmma A operand (T is
//     (P, D) row-major: K-major, as TF32 wgmma requires), split once into
//     TF32 big/small and held for the whole walk in registers (128 per
//     thread at D=128), so a tile's whole depth goes to the tensor cores as
//     one group of wgmmas behind one fence (splitting per k-step, with a
//     fence and a wait each, was 10-15% slower on an H100).  U's column
//     tile is B, also K-major as it lies.  Each k-step is three wgmma
//     m64n64k8 (small x big, big x small into one accumulator, big x big
//     into another, added in f32 at the end: the tensor core's accumulation
//     rounds more coarsely than an f32 add, so the two chains err apart, as
//     in K1).
//   - U's column tiles stream through a three-stage ring in shared memory
//     (64 KB a stage at D=128), two tiles ahead: 16-byte cp.async copies by
//     all threads straight into wgmma's B-tile layout (zero-filled past P
//     and D); each thread then splits the floats it copied, in place, into
//     the big and small tiles.  One barrier a tile hands the ring over.
//   - Ping-pong: warpgroup 0 runs tile c's products and then its epilogue,
//     warpgroup 1 first the epilogue of tile c - 1 (its accumulators wait
//     across the barrier) and then tile c's products, so that one
//     warpgroup's epilogue runs while the other's products hold the tensor
//     cores.
//   - The epilogue runs on the accumulator fragments: tanhf (the accurate
//     one: tanh.approx would miss the 1e-5 gates); each candidate becomes a
//     64-bit key, the value's bits made monotone (NaN above all, -0 as +0)
//     over the complement of its index, so that better() is one unsigned
//     max.  A row's best over its thread's 16 columns, then the quad's 4
//     lanes (shuffles), joins running row maxima in registers; a column's
//     best over the thread's two rows is reduced over the warp's 8 row
//     groups by a butterfly that halves the columns each lane holds at each
//     step (14 exchanges for 16 columns, not 48), then over the 8 warps
//     through a 4-slot ring in shared memory, read two tiles later, into
//     one partial per (row tile, column).  The matrix never reaches device
//     memory.
// Measured on an H100 (PERF.md), it is bound by neither: the products and
// the ring take about half its time, tanhf a sixth, the rest of the
// epilogue a third; registers (T's 128, the accumulators' 64) leave no room
// for wider tiles or a second accumulator pair.
// Past D = 128, where T's fragments do not fit the registers, a CUDA-core
// kernel (affinity_tiles_simt: 128 x 128 tiles, a shared-memory SGEMM with
// depth steps of 16, 8 x 8 outputs per thread, two blocks per SM) takes
// any D.  Both reduce under the same total order, so the bits of a launch
// depend only on its inputs.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BR = 128;  // rows p per block
constexpr int BC = 128;  // columns q per column tile
constexpr int BK = 16;   // depth per shared-memory stage
constexpr int TX = 16;   // column lanes
constexpr int TY = 16;   // row lanes
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int PAD = 4;   // keeps rows 16-byte aligned, halves store conflicts
constexpr int MIN_BLOCKS = 2;  // per SM: caps registers at 128 (no spills), so
                               // one block's loads overlap the other's products
constexpr float NEG_INF = -1e30f;  // the mask value of ops/masking.py

// does candidate (v, i) beat (cv, ci)?  NaN first, then the larger value,
// then the lower index: a total order, so merging is order-free
__device__ __forceinline__ bool better(float v, int i, float cv, int ci) {
  const bool n = v != v, cn = cv != cv;
  if (n != cn) return n;
  if (!n && v != cv) return v > cv;
  return i < ci;
}

__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// this thread's i-th row and j-th column within a tile
__device__ __forceinline__ int row_of(int ty, int i) { return (i / 4) * 64 + ty * 4 + (i % 4); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j / 4) * 64 + tx * 4 + (j % 4); }

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
affinity_tiles_simt(const float* __restrict__ T, const float* __restrict__ U,
                      const uint8_t* __restrict__ exists, float* __restrict__ col_val,
                      int* __restrict__ col_idx, float* __restrict__ row_val,
                      int* __restrict__ row_idx, int P, int D) {
  __shared__ __align__(16) float Ts[BK][BR + PAD];  // T rows of the block, depth-major
  __shared__ __align__(16) float Us[BK][BC + PAD];  // U rows of the column tile
  __shared__ float cbuf_v[WARPS][BC];               // per-warp column partials
  __shared__ int cbuf_i[WARPS][BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX, warp = tid / 32;
  const int rt = blockIdx.x, b = blockIdx.y, R = gridDim.x;
  const int row0 = rt * BR;
  const float* Tb = T + (size_t)b * P * D;
  const float* Ub = U + (size_t)b * P * D;

  bool row_in[TM], row_ex[TM];
  float rbest_v[TM];
  int rbest_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = row0 + row_of(ty, i);
    row_in[i] = p < P;
    row_ex[i] = row_in[i] && exists[p];
    rbest_v[i] = -INFINITY;  // empty: loses to every candidate
    rbest_i[i] = INT_MAX;
  }

  for (int col0 = 0; col0 < P; col0 += BC) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = tid; e < BR * BK; e += THREADS) {
        const int r = e / BK, c = e % BK, k = k0 + c;
        const int p = row0 + r, q = col0 + r;
        Ts[c][r] = (p < P && k < D) ? Tb[(size_t)p * D + k] : 0.f;
        Us[c][r] = (q < P && k < D) ? Ub[(size_t)q * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Ts[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Ts[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Us[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Us[kk][64 + tx * 4]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    bool col_in[TN], col_ex[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = col0 + col_of(tx, j);
      col_in[j] = q < P;
      col_ex[j] = col_in[j] && exists[q];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = tanhf(acc[i][j]);

    // row half: each row's best over this tile's existing columns, across
    // the 16 column lanes of the half-warp, into the running maxima
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = -INFINITY;
      int ix = INT_MAX;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (col_in[j]) merge(v, ix, col_ex[j] ? acc[i][j] : NEG_INF, col0 + col_of(tx, j));
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        merge(v, ix, ov, oi);
      }
      merge(rbest_v[i], rbest_i[i], v, ix);
    }

    // column half: each column's best over the block's existing rows; the
    // two row lanes of a warp by shuffle, the eight warps in shared memory
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float v = -INFINITY;
      int ix = INT_MAX;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (row_in[i]) merge(v, ix, row_ex[i] ? acc[i][j] : NEG_INF, row0 + row_of(ty, i));
      const float ov = __shfl_xor_sync(0xffffffffu, v, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, 16);
      merge(v, ix, ov, oi);
      if (ty % 2 == 0) {
        cbuf_v[warp][col_of(tx, j)] = v;
        cbuf_i[warp][col_of(tx, j)] = ix;
      }
    }
    __syncthreads();
    if (tid < BC && col0 + tid < P) {
      float v = cbuf_v[0][tid];
      int ix = cbuf_i[0][tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) merge(v, ix, cbuf_v[w][tid], cbuf_i[w][tid]);
      const size_t o = ((size_t)b * R + rt) * P + col0 + tid;
      col_val[o] = v;
      col_idx[o] = ix;
    }
    // the next tile's first __syncthreads orders these reads of cbuf
    // before its writes
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (!row_in[i]) continue;
      const size_t o = (size_t)b * P + row0 + row_of(ty, i);
      row_val[o] = rbest_v[i];
      row_idx[o] = rbest_i[i];
    }
  }
}

// ---- the wgmma kernel (D <= 128)

using namespace tf32x3;

constexpr int WBC = 64;                  // columns per tile (wgmma n)
constexpr int KSM = 16;                  // k-steps at most: D <= 128
constexpr int STAGES = 3;                // U tiles in the ring: this one and two ahead
constexpr int WTHREADS = 256;            // two warpgroups of 64 rows
constexpr int CT = WBC * 8;              // floats of one k-step's U tile (big or small)
constexpr int CWARPS = WTHREADS / 32;    // column partials per tile, one per warp
constexpr int SLOTS = 4;                 // column-partial ring: tile c's is read at c + 2

size_t wgmma_smem(int D) {
  const size_t ks = (D + 7) / 8;
  return STAGES * ks * 2 * CT * sizeof(float) + (size_t)SLOTS * CWARPS * WBC * sizeof(uint64_t) +
         SLOTS * WBC;  // the tiles' exists bytes
}

// the float offset, in a stage, of the 4 k (k % 4 == 0) of column q
__device__ __forceinline__ int stage_offset(int q, int k) {
  return (k >> 3) * 2 * CT + (q >> 3) * 64 + ((k >> 2) & 1) * 32 + (q & 7) * 4;
}

// a candidate as an unsigned key whose order is better()'s: the value's
// bits made monotone (NaN above every number, -0 as +0) over ~index
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v + 0.f);
  return v != v ? 0xFFFFFFFFu : (u & 0x80000000u ? ~u : u | 0x80000000u);
}
__device__ __forceinline__ uint64_t make_key(uint32_t ord, int i) {
  return (static_cast<uint64_t>(ord) << 32) | static_cast<uint32_t>(~i);
}
__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) { return a > b ? a : b; }
__device__ __forceinline__ float key_value(uint64_t k) {
  const uint32_t u = static_cast<uint32_t>(k >> 32);
  return u == 0xFFFFFFFFu ? __uint_as_float(0x7FFFFFFFu)
                          : __uint_as_float(u & 0x80000000u ? u & 0x7FFFFFFFu : ~u);
}
__device__ __forceinline__ int key_index(uint64_t k) { return ~static_cast<int>(k & 0xFFFFFFFFu); }
__device__ __forceinline__ uint64_t shfl_xor64(uint64_t k, int off) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, static_cast<uint32_t>(k), off);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, static_cast<uint32_t>(k >> 32), off);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// one step of the column butterfly: of the 2N columns a lane holds, it
// keeps the half `upper` selects and sends the other to lane ^ off, whose
// half it receives
template <int N>
__device__ __forceinline__ void butterfly(uint64_t (&col)[WBC / 4], bool upper, int off) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t keep = upper ? col[i + N] : col[i];
    const uint64_t send = upper ? col[i] : col[i + N];
    col[i] = kmax(keep, shfl_xor64(send, off));
  }
}

struct Walk {
  const float* Ub;
  const uint8_t* exists;
  float* ring;
  int P, D, KS, stage_floats, tid;
  bool vec;

  // copies of column tile c into its stage, each thread its own 16 bytes;
  // item it of a warp: lane -> column 8 (it % 8) + lane % 8, float4 chunk
  // 4 (it / 8) + lane / 8 of the padded row.  Returns the exists byte of
  // the tile's column tid (threads below WBC; 0 past P), which the caller
  // stores into the tile's slot once it is free.
  __device__ __forceinline__ uint8_t copy(int c) const {
    float* st = ring + (c % STAGES) * stage_floats;
    const int K4 = 2 * KS, items = 8 * ((K4 + 3) / 4);
    const int lane = tid % 32;
    for (int it = tid / 32; it < items; it += CWARPS) {
      const int q = (it % 8) * 8 + (lane & 7), kc = (it / 8) * 4 + (lane >> 3);
      if (kc >= K4) continue;
      const int k = kc * 4, p = c * WBC + q;
      float* dst = st + stage_offset(q, k);
      const float* src = Ub + (size_t)p * D + k;
      if (vec) {
        const bool ok = p < P && k < D;
        cp_async16_zfill(dst, ok ? src : Ub, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = p < P && k + e < D;
          cp_async4_zfill(dst + e, ok ? src + e : Ub, ok ? 4 : 0);
        }
      }
    }
    const int q = c * WBC + tid;
    return tid < WBC && q < P ? exists[q] : 0;
  }

  // this thread's copies of tile c, landed, split in place into big/small
  __device__ __forceinline__ void split_tile(int c) const {
    float* st = ring + (c % STAGES) * stage_floats;
    const int K4 = 2 * KS, items = 8 * ((K4 + 3) / 4);
    const int lane = tid % 32;
    for (int it = tid / 32; it < items; it += CWARPS) {
      const int q = (it % 8) * 8 + (lane & 7), kc = (it / 8) * 4 + (lane >> 3);
      if (kc >= K4) continue;
      float4* big = reinterpret_cast<float4*>(st + stage_offset(q, kc * 4));
      const float4 v = *big;
      uint32_t h[4], l[4];
      split(v.x, h[0], l[0]);
      split(v.y, h[1], l[1]);
      split(v.z, h[2], l[2]);
      split(v.w, h[3], l[3]);
      *big = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                         __uint_as_float(h[3]));
      big[CT / 4] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  }
};

__global__ void __launch_bounds__(WTHREADS, 1)
affinity_tiles_wgmma(const float* __restrict__ T, const float* __restrict__ U,
                     const uint8_t* __restrict__ exists, float* __restrict__ col_val,
                     int* __restrict__ col_idx, float* __restrict__ row_val,
                     int* __restrict__ row_idx, int P, int D, bool vec) {
  extern __shared__ float4 smem4[];
  const int KS = (D + 7) / 8;
  const int stage_floats = KS * 2 * CT;
  float* ring = reinterpret_cast<float*>(smem4);  // [STAGES][KS][big, small][CT]
  uint64_t* cb = reinterpret_cast<uint64_t*>(ring + STAGES * stage_floats);  // [SLOTS][CWARPS][WBC]
  uint8_t* exs = reinterpret_cast<uint8_t*>(cb + SLOTS * CWARPS * WBC);       // [SLOTS][WBC]
  const int tid = threadIdx.x;
  const int rt = blockIdx.x, b = blockIdx.y, R = gridDim.x;
  const int row0 = rt * BR;
  const float* Tb = T + (size_t)b * P * D;
  const int n_tiles = (P + WBC - 1) / WBC;
  const Walk walk{U + (size_t)b * P * D, exists, ring, P, D, KS, stage_floats, tid, vec};

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int cw = wg * 4 + warp;  // this warp's slot among a tile's column partials
  int prow[2];
  prow[0] = row0 + wg * 64 + warp * 16 + gid;  // this thread's rows
  prow[1] = prow[0] + 8;
  bool row_in[2], row_ex[2];
  uint64_t rbest[2] = {0, 0};  // 0: below every key, loses to every candidate
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_in[h] = prow[h] < P;
    row_ex[h] = row_in[h] && exists[prow[h]];
  }
  const uint32_t neg_ord = ordered(NEG_INF);
  // T's A fragments for the whole walk, split once into TF32 big and
  // small; zeros past P and D
  uint32_t tah[KSM][4], tal[KSM][4];
#pragma unroll
  for (int ks = 0; ks < KSM; ++ks) {
    const int k0 = ks * 8 + tig, k1 = k0 + 4;
    split(row_in[0] && k0 < D ? Tb[(size_t)prow[0] * D + k0] : 0.f, tah[ks][0], tal[ks][0]);
    split(row_in[1] && k0 < D ? Tb[(size_t)prow[1] * D + k0] : 0.f, tah[ks][1], tal[ks][1]);
    split(row_in[0] && k1 < D ? Tb[(size_t)prow[0] * D + k1] : 0.f, tah[ks][2], tal[ks][2]);
    split(row_in[1] && k1 < D ? Tb[(size_t)prow[1] * D + k1] : 0.f, tah[ks][3], tal[ks][3]);
  }
  float hi[WBC / 2], lo[WBC / 2];  // big*big; the two small cross terms

  // tile c's products: the whole depth as one group of wgmmas, A never
  // rewritten, so one fence (for the accumulators the epilogue touched)
  auto products = [&](int c) {
    const float* st = ring + (c % STAGES) * stage_floats;
    // the epilogue's last writes of the accumulators stay before the fence
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSM; ++ks) {
      if (ks < KS) {
        const float* tb = st + ks * 2 * CT;
        const int add = ks > 0;
        Wgmma<WBC>::run(lo, tal[ks], b_desc(tb), add);
        Wgmma<WBC>::run(hi, tah[ks], b_desc(tb), add);
        Wgmma<WBC>::run(lo, tah[ks], b_desc(tb + CT), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(hi);
    fence_regs(lo);
  };

  // tile c's epilogue on the accumulators: row maxima, column partial
  auto epilogue = [&](int c) {
    const int col0 = c * WBC;
    // this thread's 16 columns: q = col0 + 8 j + 2 tig + e, accumulator
    // 4 j + 2 h + e for row h
    const uint8_t* ex = exs + (c % SLOTS) * WBC;
    uint32_t in_mask = 0, ex_mask = 0;
#pragma unroll
    for (int j = 0; j < WBC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * tig + e;
        in_mask |= static_cast<uint32_t>(ql < P - col0) << (2 * j + e);
        ex_mask |= static_cast<uint32_t>(ex[ql] != 0) << (2 * j + e);
      }
    // the candidates' ordered bits, in place of the accumulators
#pragma unroll
    for (int i = 0; i < WBC / 2; ++i) hi[i] = __uint_as_float(ordered(tanhf(hi[i] + lo[i])));
    auto ord = [&](int i) { return __float_as_uint(hi[i]); };

    // row half: over the tile's existing columns, then the quad's lanes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint64_t k[WBC / 8];
#pragma unroll
      for (int j = 0; j < WBC / 8; ++j) {
        uint64_t two[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = 2 * j + e;
          two[e] = in_mask >> bit & 1
                       ? make_key(ex_mask >> bit & 1 ? ord(4 * j + 2 * h + e) : neg_ord,
                                  col0 + 8 * j + 2 * tig + e)
                       : 0;
        }
        k[j] = kmax(two[0], two[1]);
      }
#pragma unroll
      for (int w = WBC / 16; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) k[j] = kmax(k[j], k[j + w]);
      k[0] = kmax(k[0], shfl_xor64(k[0], 1));
      k[0] = kmax(k[0], shfl_xor64(k[0], 2));
      rbest[h] = kmax(rbest[h], k[0]);
    }

    // column half: over the thread's two rows, then the warp's 8 row
    // groups by a halving butterfly (lane keeps the half its gid bit
    // selects), then the 8 warps through the slot ring
    uint64_t col[WBC / 4];  // column 8 (i / 2) + 2 tig + i % 2
#pragma unroll
    for (int i = 0; i < WBC / 4; ++i) {
      const int j = i / 2, e = i % 2;
      const uint64_t k0 = row_in[0] ? make_key(row_ex[0] ? ord(4 * j + e) : neg_ord, prow[0]) : 0;
      const uint64_t k8 = row_in[1] ? make_key(row_ex[1] ? ord(4 * j + 2 + e) : neg_ord, prow[1]) : 0;
      col[i] = kmax(k0, k8);
    }
    butterfly<8>(col, gid & 1, 4);
    butterfly<4>(col, gid >> 1 & 1, 8);
    butterfly<2>(col, gid >> 2 & 1, 16);
    // the first of the two columns this lane now holds
    const int base = (gid & 1) * 8 + (gid >> 1 & 1) * 4 + (gid >> 2 & 1) * 2;
    uint64_t* slot = cb + ((c % SLOTS) * CWARPS + cw) * WBC;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = base + i;
      slot[8 * (idx / 2) + 2 * tig + idx % 2] = col[i];
    }
  };

  // tile c's column partials, both warpgroups' slots written: one column
  // per thread of the first warp of each warpgroup
  auto finish_columns = [&](int c) {
    if (tid % 128 >= 32) return;
    const int q = wg * 32 + tid % 32;
    if (c * WBC + q >= P) return;
    const uint64_t* slot = cb + (c % SLOTS) * CWARPS * WBC;
    uint64_t k = slot[q];
#pragma unroll
    for (int w = 1; w < CWARPS; ++w) k = kmax(k, slot[w * WBC + q]);
    const size_t o = ((size_t)b * R + rt) * P + c * WBC + q;
    col_val[o] = key_value(k);
    col_idx[o] = key_index(k);
  };

  // prologue: tiles 0 and 1 copied, tile 0 split
  uint8_t ex_ahead = walk.copy(0);
  if (tid < WBC) exs[tid] = ex_ahead;
  cp_async_commit();
  if (n_tiles > 1) {
    ex_ahead = walk.copy(1);
    if (tid < WBC) exs[WBC + tid] = ex_ahead;
  }
  cp_async_commit();
  cp_async_wait<1>();
  walk.split_tile(0);
  fence_proxy_async();

  for (int c = 0; c <= n_tiles; ++c) {
    // tile c is split by everyone; tile c - 1's products are done (its
    // stage is free) and its partials written by warpgroup 0, tile c - 2's
    // by both
    __syncthreads();
    if (c >= 2) finish_columns(c - 2);
    if (c + 2 < n_tiles) ex_ahead = walk.copy(c + 2);
    cp_async_commit();
    if (wg == 0) {
      if (c < n_tiles) {
        products(c);
        epilogue(c);
      }
    } else {
      if (c >= 1) epilogue(c - 1);
      if (c < n_tiles) products(c);
    }
    if (c + 1 < n_tiles) {
      cp_async_wait<1>();  // this thread's copies of tile c + 1 have landed
      walk.split_tile(c + 1);
      fence_proxy_async();  // the split tile visible to wgmma
    }
    // tile c + 2's exists bytes, into the slot tile c - 2's epilogues are
    // done with
    if (c + 2 < n_tiles && tid < WBC) exs[((c + 2) % SLOTS) * WBC + tid] = ex_ahead;
  }
  cp_async_wait<0>();
  __syncthreads();  // warpgroup 1's partials of the last tile
  finish_columns(n_tiles - 1);

  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!row_in[h]) continue;
      const size_t o = (size_t)b * P + prow[h];
      row_val[o] = key_value(rbest[h]);
      row_idx[o] = key_index(rbest[h]);
    }
  }
}

}  // namespace

// T, U (B, P, D) f32, exists (P,) uint8 0/1 -> col_val, col_idx (B, R, P)
// with R = ceil(P / 128), row_val, row_idx (B, P); f32 / int32, contiguous,
// on the device.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int affinity_tiles(const float* T, const float* U, const uint8_t* exists,
                              float* col_val, int* col_idx, float* row_val, int* row_idx,
                              int B, int P, int D, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (D <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P + BR - 1) / BR, B);
  if (D <= KSM * 8) {
    const size_t smem = wgmma_smem(D);
    cudaError_t err = cudaFuncSetAttribute(
        affinity_tiles_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 16-byte copies of U's rows: D a multiple of 4 and U 16-byte aligned
    const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(U) & 15) == 0;
    affinity_tiles_wgmma<<<grid, WTHREADS, smem, s>>>(T, U, exists, col_val, col_idx, row_val,
                                                      row_idx, P, D, vec);
    return static_cast<int>(cudaGetLastError());
  }
  affinity_tiles_simt<<<grid, THREADS, 0, s>>>(T, U, exists, col_val, col_idx, row_val,
                                               row_idx, P, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
