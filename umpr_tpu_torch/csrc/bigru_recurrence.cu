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
// Up to H = 128 (bigru_recurrence_kernel) the block keeps that direction's
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
// bound it.  Tensor-core (mma) steps are later work.
//
// Any H: this shared-memory kernel takes H <= 128 (W_hh fits: 192 KB at
// H = 128); past that a wide kernel (below) keeps W_hh in L2 and lets each
// thread own whole hidden units of all 16 rows, as the JAX package's
// bigru_scan takes any gru_size.

#include "row_order.cuh"

namespace {

using row_order::load_tile;

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

  // W_hh[d]: [k][3H] is [k][gate][H]; 16-byte copies where H % 4 == 0
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
            const float2 v = *reinterpret_cast<const float2*>(p + gt * H);
            x[i][gt][0] = v.x;
            x[i][gt][1] = v.y;
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

__global__ void __launch_bounds__(WTHREADS)
bigru_recurrence_wide(const float* __restrict__ xg, const int* __restrict__ lengths,
                      const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                      float* __restrict__ y, float* __restrict__ scratch, int N, int L, int H) {
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
  const float* W = w_hh + (size_t)d * H * G;

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
      if (n < N) y[((size_t)n * L + t) * y_stride + d * H + i % H] = 0.f;
    }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? s : maxlen - 1 - s;
    const float* hc = state + (s & 1) * ROWS * H;  // h[k][row] before the step
    float* hn = state + ((s + 1) & 1) * ROWS * H;  // after it
    for (int j = tid; j < H; j += WTHREADS) {
      float a_r[ROWS], a_z[ROWS], a_n[ROWS];
      const float b_r = b_hh[d * G + j], b_z = b_hh[d * G + H + j], b_n = b_hh[d * G + 2 * H + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        a_r[r] = b_r;
        a_z[r] = b_z;
        a_n[r] = b_n;
      }
      for (int k = 0; k < H; ++k) {
        const float w_r = __ldg(W + (size_t)k * G + j);
        const float w_z = __ldg(W + (size_t)k * G + H + j);
        const float w_n = __ldg(W + (size_t)k * G + 2 * H + j);
        const float4* h4 = reinterpret_cast<const float4*>(hc + k * ROWS);
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) {
          const float4 h = h4[q];
          const float hv[4] = {h.x, h.y, h.z, h.w};
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
          const float* x = xg + ((size_t)n * L + t) * xg_stride + d * G;
          const float rg = sigmoid(x[j] + a_r[r]);
          const float z = sigmoid(x[H + j] + a_z[r]);
          const float c = tanhf(x[2 * H + j] + rg * a_n[r]);
          h_new = (1.f - z) * c + z * h_prev;
        }
        hn[j * ROWS + r] = h_new;
        if (n < N) y[((size_t)n * L + t) * y_stride + d * H + j] = valid ? h_new : 0.f;
      }
    }
    __syncthreads();  // the new state is complete, and every read of the old one done
  }
}

}  // namespace

// xg (N, L, 6H), lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H),
// y (N, L, 2H): contiguous, on the device; any H >= 1.  Scratch: order
// (N,) int32, the rows by length (H <= 128); scratch, 2 x ceil(N/16) x 2 x
// 16 x H floats where bigru_recurrence_scratch says so, else unused (may
// be null).  Launches the row order and the recurrence (H <= 128), or the
// wide kernel, on `stream`; returns the first failure's cudaError_t.
extern "C" int bigru_recurrence(const float* xg, const int* lengths, const float* w_hh,
                                const float* b_hh, float* y, int* order, float* scratch, int N,
                                int L, int H, void* stream) {
  if (N == 0 || L == 0) return 0;
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + ROWS - 1) / ROWS, 2);
  if (H <= MAX_SMEM_H) {
    const int o = row_order::launch(lengths, order, N, L, s);
    if (o != 0) return o;
    const Tile t = tile_shape(H);
    auto kernel = t.TU == 1 ? bigru_recurrence_kernel<1, 4> : bigru_recurrence_kernel<2, 4>;
    const size_t smem = smem_bytes(H, t);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, smem_threads(H, t), smem, s>>>(xg, lengths, w_hh, b_hh, order, y, N, L, H);
    return static_cast<int>(cudaGetLastError());
  }
  const bool shared = wide_state_bytes(H) <= SMEM_LIMIT;
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared ? wide_state_bytes(H) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_recurrence_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_recurrence_wide<<<grid, WTHREADS, smem, s>>>(xg, lengths, w_hh, b_hh, y,
                                                     shared ? nullptr : scratch, N, L, H);
  return static_cast<int>(cudaGetLastError());
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
