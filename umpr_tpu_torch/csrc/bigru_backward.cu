// K3 bigru_backward: the reverse sweep of the masked bidirectional GRU.
//
// For each sentence row n with length len_n (>= 1) and each direction d,
// the steps run in the reverse of that direction's forward order: fwd
// t = L-1 .. 0, bwd t = 0 .. L-1.  g is d loss / d (state after step t).
// At a valid step (t < len_n), with W = w_hh[d] (H, 3H) and h_prev the
// state before the step:
//   g += dy_sent[n, t, d] + dy_pos[n, t, d]        (the two cotangents)
//   hg = h_prev @ W + b_hh[d];  r, z from xg + hg;  n = tanh(xg_n + r*hg_n)
//   dn = g (1-z)(1-n^2);  dz = g (h_prev - n) z (1-z);  dr = dn hg_n r (1-r)
//   dxg[n, t, d] = [dr | dz | dn]                  (true time)
//   ghh = [dr | dz | dn r];  g = g z + ghh @ W^T
//   dW_hh[d] += h_prev^T ghh;  db_hh[d] += ghh
// An invalid step writes dxg = 0 and passes g through.
//
// h_prev needs no saved state tensor: K2 stores y in true time with exact
// zeros past each length, so h_prev is y_f[t-1] (fwd) or y_b[t+1] (bwd),
// and 0 at the sequence's start; at the bwd's first valid step t = len-1
// that is y_b[len] = 0.
//
// Replaces two TPU kernels of umpr_tpu/ops/gru_pallas.py:
//   B2 _pallas_backward / _bwd_kernel (pallas_call at :698), the reverse
//      sweep over the combined time axis, which read the states from the
//      forward's extra hs output (emit_hs=True), and
//   B7 _pallas_gru_dy / _gru_dy_kernel (pallas_call at :501), which summed
//      the y_pos and y_sent cotangents and re-flipped the bwd lanes into
//      combined time.  Here the sum is this kernel's load: each cotangent
//      is read by address from its own tensor, in true time.
//
// Design: one block per (16-row tile, direction), like K2; the TPU's
// sequential grid axis over time becomes the loop inside the block.  W_hh
// sits in shared memory with its rows padded to 3H+1 floats, so both
// products are free of bank conflicts: h_prev @ W reads a row of W across
// the warp, ghh @ W^T a column.  Thread (j, grp) owns hidden unit j of 4
// rows, and for dW_hh the rows k = grp + 4q and the columns j, H+j, 2H+j:
// 3H/4 accumulators in registers over the whole sweep.  The tile's h_prev
// and ghh go through shared memory once per step (three barriers).  dW_hh
// and db_hh leave as one partial per tile, summed afterwards in a fixed
// order: no float atomics, the same bits on every run.
//
// What bounds it on an H100: at the UMPR-R shapes (N=2560, L=20, H=64,
// lengths uniform in 1..20, about 27,600 valid steps per direction) it
// reads xg, y and both cotangents only at valid steps (~85 MB), writes dxg
// in full (78.6 MB) and does three (H x 3H) products per valid step and
// direction, ~4.1 GFLOP of f32 FMA: ~49 us of HBM traffic against ~61 us
// at 67 TFLOP/s, so operations bound it.  In practice the dependent steps,
// the barriers and the shared-memory reads bound it; spreading the rows
// over 320 blocks overlaps those latencies.  Tensor cores (wgmma) and
// keeping W_hh in registers are later work.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;            // sentence rows per block
constexpr int RPT = 4;              // rows per thread
constexpr int GROUPS = ROWS / RPT;  // row groups; block = GROUPS * H threads

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <int H>
__global__ void __launch_bounds__(GROUPS * H)
bigru_backward_kernel(const float* __restrict__ xg, const float* __restrict__ y,
                      const float* __restrict__ dy_sent, const float* __restrict__ dy_pos,
                      const int* __restrict__ lengths, const float* __restrict__ w_hh,
                      const float* __restrict__ b_hh, float* __restrict__ dxg,
                      float* __restrict__ dw_part, float* __restrict__ db_part,
                      int N, int L) {
  constexpr int G = 3 * H;         // gates of one direction
  constexpr int WS = G + 1;        // padded row stride of W in shared memory
  constexpr int KPT = H / GROUPS;  // dW_hh rows per thread
  extern __shared__ float smem[];
  float* w_s = smem;              // (H, WS): this direction's W_hh
  float* hp_s = w_s + H * WS;     // (ROWS, H): h_prev of the step
  float* gh_s = hp_s + ROWS * H;  // (ROWS, G): ghh of the step
  __shared__ int len_s[ROWS];
  __shared__ int maxlen_s;

  const int d = blockIdx.y;  // 0: fwd, 1: bwd
  const int tid = threadIdx.x;
  const int j = tid % H;    // hidden unit
  const int grp = tid / H;  // row group
  const int row0 = blockIdx.x * ROWS;

  const float* w_src = w_hh + (size_t)d * H * G;
  for (int i = tid; i < H * G; i += blockDim.x) w_s[(i / G) * WS + i % G] = w_src[i];
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

  const float b_r = b_hh[d * G + j];
  const float b_z = b_hh[d * G + H + j];
  const float b_n = b_hh[d * G + 2 * H + j];
  int row[RPT], len[RPT];
  float g[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    row[i] = row0 + grp + i * GROUPS;
    len[i] = len_s[grp + i * GROUPS];  // 0 for rows past N: never valid
    g[i] = 0.f;
  }
  float acc[KPT][3];
#pragma unroll
  for (int q = 0; q < KPT; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.f;
  float db_acc[3] = {0.f, 0.f, 0.f};
  const size_t y_stride = 2 * (size_t)H;
  const size_t xg_stride = 6 * (size_t)H;

  // steps no row of the tile reaches: dxg = 0
  for (int t = maxlen; t < L; ++t)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (row[i] < N) {
        float* o = dxg + ((size_t)row[i] * L + t) * xg_stride + d * G;
        o[j] = o[H + j] = o[2 * H + j] = 0.f;
      }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? maxlen - 1 - s : s;
    const int tp = d == 0 ? t - 1 : t + 1;  // where y holds h_prev
    const bool has_prev = tp >= 0 && tp < L;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float hp = 0.f;
      if (t < len[i] && has_prev) hp = y[((size_t)row[i] * L + tp) * y_stride + d * H + j];
      hp_s[(grp + i * GROUPS) * H + j] = hp;
    }
    __syncthreads();  // h_prev of every row is in shared memory

    // the forward's gate pre-activations, recomputed: hg = h_prev @ W + b
    float a_r[RPT], a_z[RPT], a_n[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a_r[i] = b_r;
      a_z[i] = b_z;
      a_n[i] = b_n;
    }
    for (int k = 0; k < H; ++k) {
      const float w_r = w_s[k * WS + j];
      const float w_z = w_s[k * WS + H + j];
      const float w_n = w_s[k * WS + 2 * H + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float hk = hp_s[(grp + i * GROUPS) * H + k];
        a_r[i] = fmaf(hk, w_r, a_r[i]);
        a_z[i] = fmaf(hk, w_z, a_z[i]);
        a_n[i] = fmaf(hk, w_n, a_n[i]);
      }
    }

    float gz[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float dr = 0.f, dz = 0.f, dn = 0.f, dhn = 0.f;
      gz[i] = 0.f;
      if (t < len[i]) {
        const size_t at = (size_t)row[i] * L + t;
        const float* x = xg + at * xg_stride + d * G;
        const float r = sigmoid(x[j] + a_r[i]);
        const float z = sigmoid(x[H + j] + a_z[i]);
        const float n = tanhf(x[2 * H + j] + r * a_n[i]);
        const size_t o = at * y_stride + d * H + j;
        g[i] += dy_sent[o] + dy_pos[o];
        const float hp = hp_s[(grp + i * GROUPS) * H + j];
        dn = g[i] * (1.f - z) * (1.f - n * n);
        dz = g[i] * (hp - n) * z * (1.f - z);
        dr = dn * a_n[i] * r * (1.f - r);
        dhn = dn * r;
        gz[i] = g[i] * z;
      }
      if (row[i] < N) {
        float* o = dxg + ((size_t)row[i] * L + t) * xg_stride + d * G;
        o[j] = dr;
        o[H + j] = dz;
        o[2 * H + j] = dn;
      }
      float* gh = gh_s + (grp + i * GROUPS) * G;
      gh[j] = dr;
      gh[H + j] = dz;
      gh[2 * H + j] = dhn;
      db_acc[0] += dr;
      db_acc[1] += dz;
      db_acc[2] += dhn;
    }
    __syncthreads();  // ghh of every row is in shared memory

    // g = g z + ghh @ W^T at valid steps (a column of W across the warp)
    for (int c = 0; c < G; ++c) {
      const float w = w_s[j * WS + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) gz[i] = fmaf(gh_s[(grp + i * GROUPS) * G + c], w, gz[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (t < len[i]) g[i] = gz[i];

    // dW_hh += h_prev^T ghh over the tile's rows (invalid rows hold zeros)
    for (int r = 0; r < ROWS; ++r) {
      const float g0 = gh_s[r * G + j];
      const float g1 = gh_s[r * G + H + j];
      const float g2 = gh_s[r * G + 2 * H + j];
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const float hk = hp_s[r * H + grp + q * GROUPS];
        acc[q][0] = fmaf(hk, g0, acc[q][0]);
        acc[q][1] = fmaf(hk, g1, acc[q][1]);
        acc[q][2] = fmaf(hk, g2, acc[q][2]);
      }
    }
    __syncthreads();  // every read of this step's h_prev and ghh is done
  }

  const size_t part = (size_t)blockIdx.x * 2 + d;
  float* dw = dw_part + part * H * G;
#pragma unroll
  for (int q = 0; q < KPT; ++q) {
    const int k = grp + q * GROUPS;
    dw[k * G + j] = acc[q][0];
    dw[k * G + H + j] = acc[q][1];
    dw[k * G + 2 * H + j] = acc[q][2];
  }
  // db_hh: the row groups' sums, added in a fixed order
  float* red = gh_s;  // (GROUPS, G); the sweep's last barrier freed it
  red[grp * G + j] = db_acc[0];
  red[grp * G + H + j] = db_acc[1];
  red[grp * G + 2 * H + j] = db_acc[2];
  __syncthreads();
  if (grp == 0)
    for (int gate = 0; gate < 3; ++gate) {
      float sum = 0.f;
      for (int r = 0; r < GROUPS; ++r) sum += red[r * G + gate * H + j];
      db_part[part * G + gate * H + j] = sum;
    }
}

template <int H>
int launch(const float* xg, const float* y, const float* dy_sent, const float* dy_pos,
           const int* lengths, const float* w_hh, const float* b_hh, float* dxg,
           float* dw_part, float* db_part, int N, int L, cudaStream_t stream) {
  const size_t smem = (size_t)(H * (3 * H + 1) + ROWS * H + ROWS * 3 * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_backward_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + ROWS - 1) / ROWS, 2);
  bigru_backward_kernel<H><<<grid, GROUPS * H, smem, stream>>>(
      xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xg (N, L, 6H), y (N, L, 2H), dy_sent and dy_pos (N, L, 2H) by address,
// lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H) -> dxg (N, L, 6H),
// dw_part (ceil(N/16), 2, H, 3H), db_part (ceil(N/16), 2, 3H): f32,
// contiguous, on the device.  H is 32, 64, 96 or 128.  Launches on
// `stream`; returns the cudaError_t.
extern "C" int bigru_backward(const float* xg, const float* y, const float* dy_sent,
                              const float* dy_pos, const int* lengths, const float* w_hh,
                              const float* b_hh, float* dxg, float* dw_part,
                              float* db_part, int N, int L, int H, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32: return launch<32>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    case 64: return launch<64>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    case 96: return launch<96>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    case 128: return launch<128>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
