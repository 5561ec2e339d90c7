// K2 bigru_recurrence: the masked bidirectional GRU recurrence.
//
// For each sentence row n with length len_n (>= 1) and each direction d:
//   fwd (d=0) runs t = 0 .. L-1, bwd (d=1) runs t = L-1 .. 0; step t is
//   valid when t < len_n, so the bwd state starts at the row's own last
//   token.  With xg_t = xg[n, t, d*3H:(d+1)*3H] and W = w_hh[d] (H, 3H):
//     hg = h @ W + b_hh[d]
//     r = sigmoid(xg_r + hg_r), z = sigmoid(xg_z + hg_z)
//     c = tanh(xg_n + r * hg_n)             (b_hn inside the reset gate)
//     h' = (1 - z) * c + z * h
//   A valid step stores h' into y and carries it; an invalid step stores 0
//   and leaves h frozen.  y (N, L, 2H) is in true time: fwd in columns
//   [0, H), bwd in [H, 2H).
//
// Replaces two TPU kernels of umpr_tpu/ops/gru_pallas.py:
//   B1 _pallas_forward / _fwd_kernel (pallas_call at :205) with
//      emit_hs=False: the recurrence, run there over a combined time axis
//      with the bwd lanes in reversed time, and
//   B6 _pallas_gru_outputs / _gru_out_kernel (pallas_call at :463), which
//      turned that combined-time output back into true time.  Here each
//      step stores straight into its true-time slot, so y is already B6's
//      y_sent and y_pos is a free view of it.
//
// Design: one block per (16-row tile, direction), the tiles cut from the
// rows ordered by length (row_order.cuh, shared with K3: a one-block
// counting sort, longest first), so a tile's rows share about one length.
// The TPU's sequential grid axis over time becomes a loop inside the block
// that stops at the tile's longest row; later positions are stored as
// zeros.  A row's steps compute the same in any tile and slot: the fwd
// runs t = 0 .. len-1, the bwd state stays 0 until t = len-1, and each sum
// has a fixed order, so the bits do not depend on the order within a
// length, which the sort's atomics vary.
//
// Up to H = 128 (bigru_recurrence_kernel, f32) the block keeps that direction's
// W_hh in shared memory (48 KB at H = 64), copied in 16-byte vectors, as
// [k][gate][unit], and the tile's state transposed, h^T[k][16 rows] (rows
// padded to 20 floats against bank conflicts on its stores),
// double-buffered: one barrier a step.  A thread owns TU hidden units x 4
// rows x the 3 gates (tile_shape: one unit up to H = 64, 256 threads;
// two past it): per k TU floats of W per gate and a 16-byte broadcast of
// h feed 12 TU FMAs.  Each thread keeps its own rows' state in registers
// and issues the next step's xg loads before the barrier and the product.
// The steps' effects, each taken back out of this design on an H100
// (chip_smoke.py --steps; PERF.md section 6): the row order matters most
// (1.7x at the long-history shape); fewer, larger register tiles (2 units
// x 8 rows, 64 threads) lost more to the block's longer critical path than
// they saved in shared-memory reads.
//
// What bounds it on an H100: at the UMPR-R shapes (N=2560, L=20, H=64,
// lengths uniform in 1..20) it reads xg only at valid steps (about 41 MB),
// writes 26.2 MB of y and does 1.3 GFLOP of f32 FMA at those lengths: ~20
// us of HBM traffic and about as much f32 arithmetic at 67 TFLOP/s.  A
// tile's steps are sequential, so the longest tiles (20 steps of 16 x 64 x
// 192 FMAs) set a floor of their own; sorted, the tiles that end early
// free their SMs for the rest.  In practice each step's shared-memory
// reads (4 per 12 FMAs) and the issue slots of the few warps an SM holds
// bound it.  f32 tensor-core (mma) steps are later work; bf16 takes them
// (below).
//
// bf16 IO (bigru_recurrence_bf16, --compute_dtype bfloat16): xg, W_hh,
// b_hh and y in bf16, the carried state and the gate math in f32, and the
// state rounded to bf16 only as the operand of h @ W_hh, as the TPU
// kernel's bf16 path does (_fwd_step: dot(h.astype(bf16), W) with f32
// accumulation, then + b).  That product is exactly a bf16 tensor-core
// product, so up to H = 128 bf16 runs a kernel of its own,
// bigru_recurrence_bf16_kernel (below), on mma.sync m16n8k16; past H =
// 128 the wide kernel takes bf16 as it takes f32.
//
// Any H: the shared-memory kernels take H <= 128 (W_hh fits: 192 KB at
// H = 128 in f32); past that a wide kernel (below) keeps W_hh in L2 and
// lets each thread own whole hidden units of all 16 rows, as the JAX
// package's bigru_scan takes any gru_size.

#include <cstdint>

#include "row_order.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using row_order::load_tile;
using tf32x3::bf16;
using tf32x3::io_from;
using tf32x3::is_bf16;
using tf32x3::ld;
using tf32x3::round_to;

// two neighbouring elements of xg (8-byte aligned)
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

constexpr int ROWS = 16;         // sentence rows per block
constexpr int HS = ROWS + 4;     // floats per k of the state h^T (16 rows, padded)
constexpr int MAX_SMEM_H = 128;  // the largest H of the shared-memory kernel
constexpr int MAX_THREADS = 256;  // of the shared-memory kernel

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// The shared-memory kernel's register tile: a thread owns TU hidden units
// x TR rows x the 3 gates; HP = H rounded up to TU.  One unit a thread
// where 4 H threads fit the block (H <= 64), else two.
struct Tile {
  int TU, TR;
};
Tile tile_shape(int H) { return 4 * H <= MAX_THREADS ? Tile{1, 4} : Tile{2, 4}; }

__host__ __device__ int padded_h(int H, int TU) { return (H + TU - 1) / TU * TU; }

// floats of W_hh in shared memory, [k][gate][HP], rounded up to 4 so that
// the state after it is 16-byte aligned
__host__ __device__ int w_floats(int H, int TU) { return (3 * H * padded_h(H, TU) + 3) & ~3; }

size_t smem_bytes(int H, Tile t) {
  return ((size_t)w_floats(H, t.TU) + (size_t)2 * padded_h(H, t.TU) * HS) * sizeof(float);
}

int smem_threads(int H, Tile t) { return padded_h(H, t.TU) / t.TU * (ROWS / t.TR); }

template <int TU, int TR>
__global__ void __launch_bounds__(MAX_THREADS)
bigru_recurrence_kernel(const float* __restrict__ xg, const int* __restrict__ lengths,
                        const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                        const int* __restrict__ order, float* __restrict__ y, int N, int L,
                        int H) {
  extern __shared__ float4 smem4[];
  __shared__ int row_s[ROWS], len_s[ROWS];

  const int d = blockIdx.y;  // 0: fwd, 1: bwd
  const int G = 3 * H, HP = padded_h(H, TU);
  float* w_s = reinterpret_cast<float*>(smem4);  // [k][gate][HP]: this direction's W_hh
  float* h_s = w_s + w_floats(H, TU);            // [2][HP][HS]: h^T, double-buffered
  const int tid = threadIdx.x;
  const int ju = tid % (HP / TU), grp = tid / (HP / TU);
  const int j0 = TU * ju;    // units j0 .. j0 + TU - 1; those >= H are padding
  const bool vec = HP == H;  // xg and y rows hold whole TU-float vectors
  const int r0 = grp * TR;   // this thread's tile rows r0 .. r0 + TR - 1

  // W_hh[d]: [k][3H] is [k][gate][H]; 16-byte copies where H % 4 == 0,
  // else an element at a time
  const float* W = w_hh + (size_t)d * H * G;
  if (H % 4 == 0) {
    const float4* src = reinterpret_cast<const float4*>(W);
    for (int i = tid; i < H * G / 4; i += blockDim.x) smem4[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < 3 * H * HP; i += blockDim.x) {
      const int j = i % HP;
      w_s[i] = j < H ? W[(size_t)(i / HP) * H + j] : 0.f;
    }
  }
  for (int i = tid; i < HP * HS; i += blockDim.x) h_s[i] = 0.f;  // buffer 0: h = 0
  for (int r = tid; r < ROWS; r += blockDim.x)  // fewer threads than rows at H < 4
    load_tile(order, lengths, blockIdx.x * ROWS + r, N, L, row_s[r], len_s[r]);
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) maxlen = max(maxlen, len_s[r]);

  float b[3][TU];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int u = 0; u < TU; ++u) b[gt][u] = j0 + u < H ? b_hh[d * G + gt * H + j0 + u] : 0.f;
  int row[TR], len[TR];
  float h[TR][TU];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    row[i] = row_s[r0 + i];  // -1 past N
    len[i] = len_s[r0 + i];  // 0 past N: never valid
#pragma unroll
    for (int u = 0; u < TU; ++u) h[i][u] = 0.f;
  }
  const size_t y_stride = 2 * (size_t)H;
  const size_t xg_stride = 6 * (size_t)H;
  auto store_y = [&](int i, int t, const float (&v)[TU]) {
    float* o = y + ((size_t)row[i] * L + t) * y_stride + d * H + j0;
    if constexpr (TU == 2) {
      if (vec) {
        *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        return;
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (j0 + u < H) o[u] = v[u];
  };

  // positions past the tile's longest row: exact zeros
  const float zero[TU] = {};
  for (int t = maxlen; t < L; ++t)
#pragma unroll
    for (int i = 0; i < TR; ++i)
      if (row[i] >= 0) store_y(i, t, zero);

  // a step's xg for this thread's rows and units, loaded ahead
  float x[TR][3][TU];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int u = 0; u < TU; ++u) x[i][gt][u] = 0.f;
      if (t >= len[i]) continue;
      const float* p = xg + ((size_t)row[i] * L + t) * xg_stride + d * G + j0;
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        if constexpr (TU == 2) {
          if (vec) {
            load_pair(p + gt * H, x[i][gt][0], x[i][gt][1]);
            continue;
          }
        }
#pragma unroll
        for (int u = 0; u < TU; ++u)
          if (j0 + u < H) x[i][gt][u] = p[gt * H + u];
      }
    }
  };
  if (maxlen > 0) fetch(d == 0 ? 0 : maxlen - 1);

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? s : maxlen - 1 - s;
    const float* hc = h_s + (s & 1) * HP * HS;  // h^T before the step
    float* hn = h_s + ((s + 1) & 1) * HP * HS;  // after it

    // hg = b + h @ W for TR rows x TU units x 3 gates
    float acc[TR][3][TU];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int u = 0; u < TU; ++u) acc[i][gt][u] = b[gt][u];
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      float w[3][TU];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const float* wp = w_s + (k * 3 + gt) * HP + j0;
        if constexpr (TU == 2) {
          const float2 v = *reinterpret_cast<const float2*>(wp);
          w[gt][0] = v.x;
          w[gt][1] = v.y;
        } else {
          w[gt][0] = *wp;
        }
      }
#pragma unroll
      for (int q = 0; q < TR / 4; ++q) {
        const float4 h4 = *reinterpret_cast<const float4*>(hc + k * HS + r0 + 4 * q);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int gt = 0; gt < 3; ++gt)
#pragma unroll
            for (int u = 0; u < TU; ++u)
              acc[4 * q + a][gt][u] = fmaf(hv[a], w[gt][u], acc[4 * q + a][gt][u]);
      }
    }

    // the gates: a valid step stores h' and carries it, an invalid one
    // stores 0 and leaves h frozen
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const bool valid = t < len[i];
      float out[TU];
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        if (valid) {
          const float r = sigmoid(x[i][0][u] + acc[i][0][u]);
          const float z = sigmoid(x[i][1][u] + acc[i][1][u]);
          const float c = tanhf(x[i][2][u] + r * acc[i][2][u]);
          h[i][u] = (1.f - z) * c + z * h[i][u];
        }
        out[u] = valid ? h[i][u] : 0.f;
      }
      if (row[i] >= 0) store_y(i, t, out);
    }
    // the state as the next product's operand
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int q = 0; q < TR / 4; ++q)
        *reinterpret_cast<float4*>(hn + (j0 + u) * HS + r0 + 4 * q) =
            make_float4(h[4 * q][u], h[4 * q + 1][u], h[4 * q + 2][u], h[4 * q + 3][u]);
    if (s + 1 < maxlen) fetch(d == 0 ? t + 1 : t - 1);
    __syncthreads();  // the new state is complete; every read of the old one done
  }
}

// ---- bf16 up to H = 128: bigru_recurrence_bf16_kernel, h @ W_hh on bf16
// mma.sync m16n8k16
//
// The walk is the f32 kernel's: one block per (16-row tile, direction),
// the tiles cut from the rows by length, the loop stopping at the tile's
// longest row.  Warp w owns hidden units 16 w .. 16 w + 15 of all three
// gates and all 16 rows (HP / 16 warps; HP: H rounded up to 16, the units
// past H zero in W_hh and in the state).  A step:
//   - hg = round(h) W_hh: m16n8k16 over HP / 16 k-steps into 6 n8 tiles
//     (r, z, n of the warp's 16 units), A from the state tile by ldmatrix,
//     B from W_hh by ldmatrix.trans.  Each k-step's mma starts from zero
//     and is added to hg in f32, and b_hh is added to the product's sum
//     last, as the TPU kernel adds it after the dot;
//   - the previous step's y leaves from its state tile as 16-byte pieces
//     of whole rows (zeros at rows whose step was not valid);
//   - the gates in the accumulator layout: lane (g, t) holds rows g, g + 8
//     x units 16 w + 2t (+1) and 16 w + 8 + 2t (+1), its f32 state for
//     those 8 (row, unit) pairs in registers, and xg for them loaded a step
//     ahead as 4-byte pairs where H is even; the new state goes, rounded
//     to bf16, into the other state tile;
//   - one barrier.
// Shared memory, bf16: W_hh[d] as [HP][WS], each gate's block padded to
// HP units (ws[k][gate HP + u] = W[k][gate H + u]), and two state tiles
// [16][SS]; WS = 3 HP + 8, SS = HP + 8: rows 16 bytes apart mod 128, so
// ldmatrix's 8 rows of a matrix fall on distinct banks.  A state tile is
// rewritten two steps after it was written, past the next barrier, and
// its y is read before that barrier.  A row's arithmetic is the same in
// any slot of any tile: an mma's output row depends on its own A row.
//
// What bounds it on an H100: at the UMPR-R shapes the bytes (xg at the
// valid steps and y, ~34 MB in bf16: ~10 us) and the product (1.3 GFLOP
// of bf16 tensor-core work, ~1.3 us at 989 TFLOP/s).  In
// practice each step's chain (ldmatrix, the mma, about 60 instructions of
// gate math per (row, unit), the barrier) and the issue slots of the few
// warps an SM holds set the pace, so registers matter: each k-step's mma
// from zero lets the compiler keep all 24 products of a step in flight
// (172 registers at H = 64), and the block is held to three an SM at H
// <= 64 (164), two past it.  The choices, each taken back out on an H100
// 80GB HBM3 at 700 W (chip_smoke.py --steps, K2_BF16_STEPS; PERF.md
// section 6): the product on the CUDA cores takes 2-3.5x the time;
// without the register cap the kernel is as fast in the one wave of the
// UMPR-R shape and 34-35% slower at the long-history shape; W_hh's
// fragments held in registers (218 at H = 64, no cap) are 25-32% slower
// at H = 128 and at the long-history shape; xg loaded at its step, not a
// step ahead, costs 8-54%; the mma's own accumulation chained through the
// k-steps (108 registers) is 22% faster at the long-history shape but
// puts 11-18% more values past one bf16 ulp of the plain version.

// the bf16 kernel's layout at HP = 16 KH (see above)
template <int KH>
struct Bf16Shape {
  static constexpr int HP = 16 * KH, WS = 3 * HP + 8, SS = HP + 8;
  static constexpr int threads = 2 * HP;  // a warp per 16 units
  static constexpr size_t smem = ((size_t)HP * WS + (size_t)2 * ROWS * SS) * sizeof(bf16);
};

// xg by (row, step) in pairs of units: one 4-byte load where `pairs` (H
// even, xg 4-byte aligned), else two 2-byte ones
__device__ __forceinline__ uint32_t xg_pair(const bf16* p, bool lo, bool hi, bool pairs) {
  if (pairs) return lo ? *reinterpret_cast<const uint32_t*>(p) : 0u;
  return (lo ? wgmma_bf16::bits(p[0]) : 0u) | (hi ? wgmma_bf16::bits(p[1]) : 0u) << 16;
}

// pairs: xg read 4 bytes at a time (H even, aligned); w_vec: W_hh copied
// 16 bytes at a time (H % 16 == 0, aligned); vec: y stored 16 bytes at a
// time (H % 8 == 0, aligned)
template <int KH>
__global__ void __launch_bounds__(32 * KH, KH <= 4 ? 3 : 2)
bigru_recurrence_bf16_kernel(const bf16* __restrict__ xg, const int* __restrict__ lengths,
                             const bf16* __restrict__ w_hh, const bf16* __restrict__ b_hh,
                             const int* __restrict__ order, bf16* __restrict__ y, int N, int L,
                             int H, int pairs, int w_vec, int vec) {
  using namespace wgmma_bf16;
  constexpr int HP = Bf16Shape<KH>::HP, WS = Bf16Shape<KH>::WS, SS = Bf16Shape<KH>::SS;
  extern __shared__ uint4 smem16[];
  __shared__ int row_s[ROWS], len_s[ROWS];
  bf16* ws = reinterpret_cast<bf16*>(smem16);  // [HP][WS]: W_hh[d], gate blocks of HP units
  bf16* hb = ws + HP * WS;                     // [2][ROWS][SS]: the state, rounded
  const int d = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  // ldmatrix: this lane's row of matrix mat
  const int mat = lane / 8, mr = lane % 8;
  const int u0 = 16 * warp, G = 3 * H;
  const bf16 zero = __float2bfloat16(0.f);

  const bf16* W = w_hh + (size_t)d * H * G;
  if (w_vec) {  // HP == H: a row of W is a row of ws
    const int P = G / 8;
    for (int k = tid; k < H * P; k += blockDim.x) {
      const int i = k / P, c = k - i * P;
      *reinterpret_cast<uint4*>(ws + i * WS + 8 * c) =
          __ldg(reinterpret_cast<const uint4*>(W + (size_t)i * G) + c);
    }
  } else {
    for (int r = warp; r < 3 * HP; r += blockDim.x / 32) {
      const int i = r / 3, gate = r - 3 * i;
      for (int u = lane; u < HP; u += 32)
        ws[i * WS + gate * HP + u] = i < H && u < H ? W[(size_t)i * G + gate * H + u] : zero;
    }
  }
  for (int i = tid; i < 2 * ROWS * SS / 8; i += blockDim.x)  // h = 0
    reinterpret_cast<uint4*>(hb)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < ROWS) load_tile(order, lengths, blockIdx.x * ROWS + tid, N, L, row_s[tid], len_s[tid]);
  __syncthreads();
  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) maxlen = max(maxlen, len_s[r]);

  int row[2], len[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    row[q] = row_s[gq + 8 * q];  // -1 past N
    len[q] = len_s[gq + 8 * q];  // 0 past N: never valid
  }
  bool ok[2][2];  // unit u0 + 8 h + 2 tq + e < H
  float b[3][2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = u0 + 8 * h + 2 * tq + e;
      ok[h][e] = u < H;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        b[gate][h][e] = ok[h][e] ? ld(b_hh[d * G + gate * H + u]) : 0.f;
    }
  const size_t xs = 6 * (size_t)H, ys = 2 * (size_t)H;

  // step t's y of the tile's rows from a state tile, zeros at the rows
  // whose step t is not valid (all where `zeros`): 16-byte pieces of
  // whole rows where `vec`, else an element at a time
  auto emit = [&](int t, const bf16* tile, bool zeros) {
    if (vec) {
      const int P = H / 8;
      for (int k = tid; k < ROWS * P; k += blockDim.x) {
        const int r = k / P, c = k - r * P;
        if (row_s[r] < 0) continue;
        *reinterpret_cast<uint4*>(y + ((size_t)row_s[r] * L + t) * ys + d * H + 8 * c) =
            !zeros && t < len_s[r] ? *reinterpret_cast<const uint4*>(tile + r * SS + 8 * c)
                                   : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int k = tid; k < ROWS * H; k += blockDim.x) {
        const int r = k / H, u = k - r * H;
        if (row_s[r] < 0) continue;
        y[((size_t)row_s[r] * L + t) * ys + d * H + u] =
            !zeros && t < len_s[r] ? tile[r * SS + u] : zero;
      }
    }
  };

  // steps no row of the tile reaches: exact zeros
  for (int t = maxlen; t < L; ++t) emit(t, hb, true);

  // step t's xg at the lane's (row, unit) pairs, 3 gates
  uint32_t xin[2][3][2];
  auto fetch = [&](int t) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = t < len[q];
        const bf16* p = xg + ((size_t)(live ? row[q] : 0) * L + t) * xs + d * G + u0 + 8 * h +
                        2 * tq;
        const bool lo = live && ok[h][0], hi = live && ok[h][1];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) xin[q][gate][h] = xg_pair(p + gate * H, lo, hi, pairs);
      }
  };

  float st[2][2][2] = {};  // the f32 state at (row q, units of h, e)
  if (maxlen > 0) fetch(d == 0 ? 0 : maxlen - 1);  // the first step's xg

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? s : maxlen - 1 - s;
    const bf16* hc = hb + (s & 1) * ROWS * SS;  // round(h) before the step
    bf16* hn = hb + ((s + 1) & 1) * ROWS * SS;  // after it

    // hg = round(h) W_hh: 6 n8 tiles (gate, half) of the warp's units
    float hg[3][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, hc + (8 * (mat & 1) + mr) * SS + 16 * kk + 8 * (mat >> 1));
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        uint32_t w4[4];  // b0, b1 of the warp's two n8 tiles
        ldsm_x4_trans(w4, ws + (16 * kk + 8 * (mat & 1) + mr) * WS + gate * HP + u0 +
                              8 * (mat >> 1));
        float p0[4] = {}, p1[4] = {};
        mma_bf16(p0, a, w4[0], w4[1]);
        mma_bf16(p1, a, w4[2], w4[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hg[gate][0][i] += p0[i];
          hg[gate][1][i] += p1[i];
        }
      }
    }
    if (s > 0) emit(d == 0 ? t - 1 : t + 1, hc, false);  // the step before, from its tile

    // the gates at valid steps (an invalid one leaves the state frozen);
    // the state, rounded, into the next tile
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (t >= len[q] || !ok[h][e]) continue;
          const float x_r = e ? hi_f(xin[q][0][h]) : lo_f(xin[q][0][h]);
          const float x_z = e ? hi_f(xin[q][1][h]) : lo_f(xin[q][1][h]);
          const float x_n = e ? hi_f(xin[q][2][h]) : lo_f(xin[q][2][h]);
          const float hg_r = hg[0][h][2 * q + e] + b[0][h][e];
          const float hg_z = hg[1][h][2 * q + e] + b[1][h][e];
          const float hg_n = hg[2][h][2 * q + e] + b[2][h][e];
          const float r = sigmoid(x_r + hg_r);
          const float z = sigmoid(x_z + hg_z);
          const float c = tanhf(x_n + r * hg_n);
          st[q][h][e] = (1.f - z) * c + z * st[q][h][e];
        }
        *reinterpret_cast<uint32_t*>(hn + (gq + 8 * q) * SS + u0 + 8 * h + 2 * tq) =
            round_pair(st[q][h][0], st[q][h][1]);
      }
    if (s + 1 < maxlen) fetch(d == 0 ? t + 1 : t - 1);  // the next step's, ahead
    __syncthreads();  // the new state tile is complete; every read of the old one done
  }
  if (maxlen > 0) emit(d == 0 ? maxlen - 1 : 0, hb + (maxlen & 1) * ROWS * SS, false);
}

template <int KH>
int launch_bf16_kh(const bf16* xg, const int* lengths, const bf16* w_hh, const bf16* b_hh,
                   const int* order, bf16* y, int N, int L, int H, dim3 grid,
                   cudaStream_t s) {
  using sh = Bf16Shape<KH>;
  const auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const int pairs = H % 2 == 0 && (bits(xg) & 3) == 0;
  const int w_vec = H % 16 == 0 && (bits(w_hh) & 15) == 0;
  const int vec = H % 8 == 0 && (bits(y) & 15) == 0;
  const cudaError_t err = cudaFuncSetAttribute(bigru_recurrence_bf16_kernel<KH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)sh::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_recurrence_bf16_kernel<KH><<<grid, sh::threads, sh::smem, s>>>(
      xg, lengths, w_hh, b_hh, order, y, N, L, H, pairs, w_vec, vec);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 kernel at H <= 128, instantiated on HP / 16
int launch_bf16(const bf16* xg, const int* lengths, const bf16* w_hh, const bf16* b_hh,
                const int* order, bf16* y, int N, int L, int H, dim3 grid, cudaStream_t s) {
  switch ((H + 15) / 16) {
    case 1: return launch_bf16_kh<1>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 2: return launch_bf16_kh<2>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 3: return launch_bf16_kh<3>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 4: return launch_bf16_kh<4>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 5: return launch_bf16_kh<5>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 6: return launch_bf16_kh<6>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 7: return launch_bf16_kh<7>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    case 8: return launch_bf16_kh<8>(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the wide kernel (H > 128, past the shared-memory kernel's W_hh):
// 256 threads own the hidden units j = tid, tid + 256, ... of all 16 rows
// of the tile, so each W_hh element read feeds 16 rows' FMAs.  Its tiles
// keep the rows' own order: given the row order it ran slower on an H100
// at H = 256 (PERF.md section 6).  W_hh (3H^2 f32, 786 KB per direction at H = 256)
// is read from global memory, where both directions' 1.5 MB stay in L2;
// neighbouring threads read neighbouring units, so the reads are
// coalesced.  The state is double-buffered, transposed (h[k][row], so a
// k's 16 rows are four 16-byte loads), in shared memory, or in a global
// scratch buffer where 2 x 16 x H floats exceed it (H > 1814); one barrier
// per step.

constexpr int WTHREADS = 256;
// a block's shared memory on Hopper (227 KB), less the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 256;

size_t wide_state_bytes(int H) { return (size_t)2 * ROWS * H * sizeof(float); }

template <class T>
__global__ void __launch_bounds__(WTHREADS)
bigru_recurrence_wide(const T* __restrict__ xg, const int* __restrict__ lengths,
                      const T* __restrict__ w_hh, const T* __restrict__ b_hh, T* __restrict__ y,
                      float* __restrict__ scratch, int N, int L, int H) {
  extern __shared__ float4 smem4[];
  __shared__ int len_s[ROWS];
  __shared__ int maxlen_s;
  const int d = blockIdx.y;
  const int G = 3 * H;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  float* state = scratch == nullptr
                     ? reinterpret_cast<float*>(smem4)
                     : scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * ROWS * H;
  const T* W = w_hh + (size_t)d * H * G;

  for (int i = tid; i < ROWS * H; i += WTHREADS) state[i] = 0.f;
  if (tid < ROWS) {
    const int n = row0 + tid;
    len_s[tid] = n < N ? min(lengths[n], L) : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < ROWS; ++r) m = max(m, len_s[r]);
    maxlen_s = m;
  }
  __syncthreads();
  const int maxlen = maxlen_s;
  const size_t y_stride = 2 * (size_t)H;
  const size_t xg_stride = 6 * (size_t)H;

  // positions past the tile's longest row: exact zeros
  for (int t = maxlen; t < L; ++t)
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int n = row0 + i / H;
      if (n < N) y[((size_t)n * L + t) * y_stride + d * H + i % H] = io_from<T>(0.f);
    }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? s : maxlen - 1 - s;
    const float* hc = state + (s & 1) * ROWS * H;  // h[k][row] before the step
    float* hn = state + ((s + 1) & 1) * ROWS * H;  // after it
    for (int j = tid; j < H; j += WTHREADS) {
      float a_r[ROWS], a_z[ROWS], a_n[ROWS];
      const float b_r = ld(b_hh[d * G + j]), b_z = ld(b_hh[d * G + H + j]);
      const float b_n = ld(b_hh[d * G + 2 * H + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        a_r[r] = b_r;
        a_z[r] = b_z;
        a_n[r] = b_n;
      }
      for (int k = 0; k < H; ++k) {
        const float w_r = ld(__ldg(W + (size_t)k * G + j));
        const float w_z = ld(__ldg(W + (size_t)k * G + H + j));
        const float w_n = ld(__ldg(W + (size_t)k * G + 2 * H + j));
        const float4* h4 = reinterpret_cast<const float4*>(hc + k * ROWS);
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) {
          const float4 h = h4[q];
          // the operand (bf16: rounded; the state stays f32)
          const float hv[4] = {round_to<T>(h.x), round_to<T>(h.y), round_to<T>(h.z),
                               round_to<T>(h.w)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a_r[4 * q + e] = fmaf(hv[e], w_r, a_r[4 * q + e]);
            a_z[4 * q + e] = fmaf(hv[e], w_z, a_z[4 * q + e]);
            a_n[4 * q + e] = fmaf(hv[e], w_n, a_n[4 * q + e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int n = row0 + r;
        const float h_prev = hc[j * ROWS + r];
        const bool valid = t < len_s[r];
        float h_new = h_prev;
        if (valid) {
          const T* x = xg + ((size_t)n * L + t) * xg_stride + d * G;
          const float rg = sigmoid(ld(x[j]) + a_r[r]);
          const float z = sigmoid(ld(x[H + j]) + a_z[r]);
          const float c = tanhf(ld(x[2 * H + j]) + rg * a_n[r]);
          h_new = (1.f - z) * c + z * h_prev;
        }
        hn[j * ROWS + r] = h_new;
        if (n < N) y[((size_t)n * L + t) * y_stride + d * H + j] = io_from<T>(valid ? h_new : 0.f);
      }
    }
    __syncthreads();  // the new state is complete, and every read of the old one done
  }
}

template <class T>
int run(const T* xg, const int* lengths, const T* w_hh, const T* b_hh, T* y, int* order,
        float* scratch, int N, int L, int H, void* stream) {
  if (N == 0 || L == 0) return 0;
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + ROWS - 1) / ROWS, 2);
  if (H <= MAX_SMEM_H) {
    const int o = row_order::launch(lengths, order, N, L, s);
    if (o != 0) return o;
    if constexpr (is_bf16<T>) {
      return launch_bf16(xg, lengths, w_hh, b_hh, order, y, N, L, H, grid, s);
    } else {
      const Tile t = tile_shape(H);
      auto kernel = t.TU == 1 ? bigru_recurrence_kernel<1, 4> : bigru_recurrence_kernel<2, 4>;
      const size_t smem = smem_bytes(H, t);
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, smem_threads(H, t), smem, s>>>(xg, lengths, w_hh, b_hh, order, y, N, L, H);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const bool shared = wide_state_bytes(H) <= SMEM_LIMIT;
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared ? wide_state_bytes(H) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_recurrence_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_recurrence_wide<T><<<grid, WTHREADS, smem, s>>>(xg, lengths, w_hh, b_hh, y,
                                                        shared ? nullptr : scratch, N, L, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xg (N, L, 6H), lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H),
// y (N, L, 2H): contiguous, on the device, f32 (bigru_recurrence) or bf16
// (bigru_recurrence_bf16); any H >= 1.  Scratch: order (N,) int32, the
// rows by length (H <= 128); scratch, 2 x ceil(N/16) x 2 x 16 x H floats
// where bigru_recurrence_scratch says so, else unused (may be null).
// Launches the row order and the recurrence (H <= 128), or the wide
// kernel, on `stream`; returns the first failure's cudaError_t.
extern "C" int bigru_recurrence(const float* xg, const int* lengths, const float* w_hh,
                                const float* b_hh, float* y, int* order, float* scratch, int N,
                                int L, int H, void* stream) {
  return run(xg, lengths, w_hh, b_hh, y, order, scratch, N, L, H, stream);
}

extern "C" int bigru_recurrence_bf16(const bf16* xg, const int* lengths, const bf16* w_hh,
                                     const bf16* b_hh, bf16* y, int* order, float* scratch,
                                     int N, int L, int H, void* stream) {
  return run(xg, lengths, w_hh, b_hh, y, order, scratch, N, L, H, stream);
}

// floats of the scratch the wide kernel needs at (N, H): 0 where its state
// fits the shared memory (and for H <= 128, the shared-memory kernel)
extern "C" long long bigru_recurrence_scratch(int N, int H) {
  if (H <= MAX_SMEM_H || wide_state_bytes(H) <= SMEM_LIMIT) return 0;
  return (long long)((N + ROWS - 1) / ROWS) * 2 * 2 * ROWS * H;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
