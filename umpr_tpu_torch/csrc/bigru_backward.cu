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
//
// Any H: the shared-memory kernel above is compiled for H in {32, 64, 96,
// 128}.  Every other H (gru_size 8, 100, 256, ...) takes a wide route of
// two kernels.  Past H = 128, W_hh no longer fits a block's shared memory
// (786 KB per direction at H = 256), a 4H-thread block passes 512 threads,
// and 3H/4 dW_hh accumulators per thread would spill.  So:
//   - the sweep keeps W_hh (and its transpose, for ghh @ W^T, so that both
//     products read it coalesced) in global memory, where both directions
//     stay in L2; 256 threads own the hidden units j = tid, tid + 256, ...
//     of all 16 rows, so each W_hh element read feeds 16 rows' FMAs; the
//     tile's h_prev, ghh and the carried g sit in shared memory (or a
//     global scratch buffer past H = 725), transposed so that a k's 16
//     rows are four 16-byte loads; two barriers per step;
//   - it takes dW_hh / db_hh out of the sweep: dxg already holds dr and
//     dz, and the sweep also writes dn * r (ghn), so ghh = [dr | dz | dn r]
//     is in device memory, and h_prev is y shifted by one step;
//   - a second kernel of the same entry point reduces dW_hh = sum h_prev^T
//     ghh and db_hh = sum ghh over a fixed split of the N*L rows into
//     chunks (a function of the row count alone, ops/gru_cuda.py
//     bwd_chunks): one 64 x 64 tile of one chunk per block, 4 x 4 outputs
//     per thread, in row order, one partial per chunk, which the wrapper
//     sums in a fixed order.  No float atomics: the same bits every run.

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

constexpr int WTHREADS = 256;  // threads of the wide sweep
// a block's shared memory on Hopper (227 KB), less the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 256;

// h_prev (H x 16), ghh (3H x 16), g (H x 16): transposed, k-major
size_t wide_state_bytes(int H) { return (size_t)5 * H * ROWS * sizeof(float); }

__global__ void __launch_bounds__(WTHREADS)
bigru_backward_wide(const float* __restrict__ xg, const float* __restrict__ y,
                    const float* __restrict__ dy_sent, const float* __restrict__ dy_pos,
                    const int* __restrict__ lengths, const float* __restrict__ w_hh,
                    const float* __restrict__ w_hh_t, const float* __restrict__ b_hh,
                    float* __restrict__ dxg, float* __restrict__ ghn,
                    float* __restrict__ scratch, int N, int L, int H) {
  extern __shared__ float4 smem4[];
  __shared__ int len_s[ROWS];
  __shared__ int maxlen_s;
  const int d = blockIdx.y;
  const int G = 3 * H;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  float* hp_s = scratch == nullptr
                    ? reinterpret_cast<float*>(smem4)
                    : scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 5 * H * ROWS;
  float* gh_s = hp_s + H * ROWS;  // [c][row]
  float* g_s = gh_s + G * ROWS;   // [j][row]: only unit j's owner reads or writes it
  const float* W = w_hh + (size_t)d * H * G;     // (H, 3H)
  const float* WT = w_hh_t + (size_t)d * G * H;  // (3H, H)

  for (int i = tid; i < H * ROWS; i += WTHREADS) g_s[i] = 0.f;
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

  // steps no row of the tile reaches: dxg = 0, dn r = 0
  for (int t = maxlen; t < L; ++t)
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int n = row0 + i / H, j = i % H;
      if (n >= N) continue;
      const size_t at = (size_t)n * L + t;
      float* o = dxg + at * xg_stride + d * G;
      o[j] = o[H + j] = o[2 * H + j] = 0.f;
      ghn[at * y_stride + d * H + j] = 0.f;
    }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? maxlen - 1 - s : s;
    const int tp = d == 0 ? t - 1 : t + 1;  // where y holds h_prev
    const bool has_prev = tp >= 0 && tp < L;
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int r = i / H, k = i % H;
      hp_s[k * ROWS + r] = t < len_s[r] && has_prev
                               ? y[((size_t)(row0 + r) * L + tp) * y_stride + d * H + k]
                               : 0.f;
    }
    __syncthreads();  // h_prev of every row; every read of the last ghh done

    for (int j = tid; j < H; j += WTHREADS) {
      // the forward's gate pre-activations, recomputed: hg = h_prev @ W + b
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
        const float4* h4 = reinterpret_cast<const float4*>(hp_s + k * ROWS);
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
        float dr = 0.f, dz = 0.f, dn = 0.f, dhn = 0.f;
        float g = g_s[j * ROWS + r];
        if (t < len_s[r]) {
          const size_t at = (size_t)n * L + t;
          const float* x = xg + at * xg_stride + d * G;
          const float rg = sigmoid(x[j] + a_r[r]);
          const float z = sigmoid(x[H + j] + a_z[r]);
          const float nn = tanhf(x[2 * H + j] + rg * a_n[r]);
          const size_t o = at * y_stride + d * H + j;
          g += dy_sent[o] + dy_pos[o];
          const float hp = hp_s[j * ROWS + r];
          dn = g * (1.f - z) * (1.f - nn * nn);
          dz = g * (hp - nn) * z * (1.f - z);
          dr = dn * a_n[r] * rg * (1.f - rg);
          dhn = dn * rg;
          g = g * z;  // ghh @ W^T is added below
        }
        if (n < N) {
          const size_t at = (size_t)n * L + t;
          float* o = dxg + at * xg_stride + d * G;
          o[j] = dr;
          o[H + j] = dz;
          o[2 * H + j] = dn;
          ghn[at * y_stride + d * H + j] = dhn;
        }
        gh_s[j * ROWS + r] = dr;
        gh_s[(H + j) * ROWS + r] = dz;
        gh_s[(2 * H + j) * ROWS + r] = dhn;
        g_s[j * ROWS + r] = g;
      }
    }
    __syncthreads();  // ghh of every row

    // g = g z + ghh @ W^T at valid steps (W^T's rows: coalesced over j)
    for (int j = tid; j < H; j += WTHREADS) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int c = 0; c < G; ++c) {
        const float w = __ldg(WT + (size_t)c * H + j);
        const float4* g4 = reinterpret_cast<const float4*>(gh_s + c * ROWS);
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) {
          const float4 v = g4[q];
          acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (t < len_s[r]) g_s[j * ROWS + r] += acc[r];
    }
    // the next step's first barrier orders these reads of gh_s before its
    // writes, and its h_prev writes come after this step's last reads
  }
}

// dW_hh / db_hh partials of the wide route: block (c tile, k tile, 2 *
// chunk + d) sums h_prev^T ghh over its chunk's rows, 16 rows per stage
constexpr int RT = 64;  // a tile's k rows and c columns
constexpr int RK = 16;  // rows per stage
constexpr int RTHREADS = 256;

__global__ void __launch_bounds__(RTHREADS)
bigru_backward_dw(const float* __restrict__ y, const float* __restrict__ dxg,
                  const float* __restrict__ ghn, const int* __restrict__ lengths,
                  float* __restrict__ dw_part, float* __restrict__ db_part, int N, int L,
                  int H, int chunk_rows) {
  __shared__ float hs[RK][RT];  // h_prev rows, k
  __shared__ float gs[RK][RT];  // ghh rows, c
  const int G = 3 * H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * RT, k0 = blockIdx.y * RT;
  const int d = blockIdx.z & 1, chunk = blockIdx.z >> 1;
  const int m0 = chunk * chunk_rows;
  const int m_end = min(m0 + chunk_rows, N * L);
  const bool with_db = blockIdx.y == 0 && ty == 0;
  float acc[4][4] = {};
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  for (int mb = m0; mb < m_end; mb += RK) {
    for (int e = tid; e < RK * RT; e += RTHREADS) {
      const int mm = e / RT, kk = e % RT, m = mb + mm;
      float hv = 0.f, gv = 0.f;
      if (m < m_end) {
        const int n = m / L, t = m % L;
        const int tp = d == 0 ? t - 1 : t + 1;
        const int k = k0 + kk, c = c0 + kk;
        if (k < H && tp >= 0 && tp < L && t < __ldg(lengths + n))
          hv = y[((size_t)n * L + tp) * 2 * H + d * H + k];
        if (c < 2 * H)
          gv = dxg[(size_t)m * 6 * H + d * G + c];
        else if (c < G)
          gv = ghn[(size_t)m * 2 * H + d * H + c - 2 * H];
      }
      hs[mm][kk] = hv;
      gs[mm][kk] = gv;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < RK; ++mm) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[mm][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs[mm][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (with_db)
#pragma unroll
        for (int j = 0; j < 4; ++j) db[j] += b[j];
    }
    __syncthreads();
  }
  const size_t part = (size_t)chunk * 2 + d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < G) dw_part[(part * H + k) * G + c] = acc[i][j];
    }
  }
  if (with_db)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < G) db_part[part * G + c] = db[j];
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
// lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H) -> dxg (N, L, 6H) and
// the dW_hh (parts, 2, H, 3H), db_hh (parts, 2, 3H) partials: f32,
// contiguous, on the device, any H >= 1.  H in {32, 64, 96, 128}: the
// shared-memory kernel, one partial per 16-row tile (parts = ceil(N/16));
// w_hh_t, ghn, scratch and chunk_rows are unused.  Any other H: the wide
// route, one partial per chunk of chunk_rows of the N*L rows; w_hh_t is
// w_hh transposed (2, 3H, H), ghn (N, L, 2H) its dn * r buffer, scratch
// bigru_backward_scratch(N, H) floats (may be null where that is 0).
// Launches on `stream`; returns the cudaError_t.
extern "C" int bigru_backward(const float* xg, const float* y, const float* dy_sent,
                              const float* dy_pos, const int* lengths, const float* w_hh,
                              const float* w_hh_t, const float* b_hh, float* dxg,
                              float* ghn, float* scratch, float* dw_part, float* db_part,
                              int N, int L, int H, int chunk_rows, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32: return launch<32>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    case 64: return launch<64>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    case 96: return launch<96>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    case 128: return launch<128>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, dxg, dw_part, db_part, N, L, s);
    default: break;
  }
  if (H <= 0 || L == 0 || chunk_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = wide_state_bytes(H) <= SMEM_LIMIT;
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared ? wide_state_bytes(H) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_backward_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_backward_wide<<<dim3((N + ROWS - 1) / ROWS, 2), WTHREADS, smem, s>>>(
      xg, y, dy_sent, dy_pos, lengths, w_hh, w_hh_t, b_hh, dxg, ghn,
      shared ? nullptr : scratch, N, L, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long M = (long long)N * L;
  const int chunks = (int)((M + chunk_rows - 1) / chunk_rows);
  bigru_backward_dw<<<dim3((3 * H + RT - 1) / RT, (H + RT - 1) / RT, 2 * chunks), RTHREADS, 0,
                      s>>>(y, dxg, ghn, lengths, dw_part, db_part, N, L, H, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

// floats of the scratch the wide sweep needs at (N, H): 0 where its state
// fits the shared memory, and for the shared-memory kernel's H
extern "C" long long bigru_backward_scratch(int N, int H) {
  if (H == 32 || H == 64 || H == 96 || H == 128 || wide_state_bytes(H) <= SMEM_LIMIT) return 0;
  return (long long)((N + ROWS - 1) / ROWS) * 2 * 5 * H * ROWS;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
