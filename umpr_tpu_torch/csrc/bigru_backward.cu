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
//      combined time.  Here the sum is the sweep's load: each cotangent is
//      read by address from its own tensor, in true time.
//
// Design.  The TPU kernel does all three (H x 3H) products of a step
// inside its sequential sweep.  Only ghh @ W^T depends on the carried
// gradient: h_prev comes from y, known before the sweep starts, and dW_hh
// is a sum over every row.  So one launch of the entry point runs three
// passes, and only the middle one is sequential:
//   (a) hg pass: Z_d = y_d @ W_hh[d] over all N*L rows and both
//       directions, 3xTF32 wgmma (bigru_backward_hg.cuh: K1's design,
//       with row strides, 64 columns a block, the big*big chain restarted
//       every 2 k-steps into an f32 sum, any H in depth chunks of 128).
//       Z goes into dxg's own buffer: in each direction the sweep reads Z at step
//       tp (where y holds h_prev) before it writes dxg at step t, the same
//       thread reads and writes an element's (row, unit), and no later
//       step reads Z at t.  The sweep reads Z only where h_prev can be
//       nonzero (0 <= tp < len); elsewhere hg = b_hh.
//   (b) sweep: the gates, dxg and ghn = dn r (the third part of ghh), and
//       g = g z + ghh @ W^T, the only product left in it; no dW
//       accumulators.  One block per (16-row tile, direction), the tiles
//       cut from the rows ordered by length (row_order.cuh, shared with
//       K2), the TPU's sequential grid axis as the loop inside the block,
//       stopping at the tile's longest row.  Up to H = 128 (bigru_backward_sweep): W_hh
//       sits in shared memory in blocks of 4 hidden units, [c][4 units],
//       the blocks padded to 4 floats mod 32 (a quarter warp's 16-byte
//       loads on distinct banks); ghh goes through shared memory
//       transposed, [c][16 rows].  A thread of the product owns an 8-row x
//       4-unit register tile of one of KS slices of the 3H-deep sum: per c
//       two 16-byte loads of ghh (broadcasts) and one of W feed 32 FMAs,
//       where the TPU-shaped kernel this replaces made 0.8 FMAs a load
//       (4-row tiles in one slice at H = 125 .. 128, where 8-row ones do
//       not fit).  The next step's loads are issued before this step's
//       product, so they land while it runs.  The KS slice sums go to shared memory and the owner of (row, unit)
//       adds them in slice order.  Two barriers a step: ghh written; slice
//       sums written.  Past H = 128, where W_hh (192 KB a direction at
//       H = 128) no longer fits beside the state, bigru_backward_wide keeps
//       W_hh^T in L2 and the tile's state in shared memory (global scratch
//       past H = 725), as before, without its hg product.
//   (c) dW pass: dW_hh[d] = sum h_prev^T [dr | dz | dn r] and db_hh[d] =
//       sum [dr | dz | dn r], 3xTF32 wgmma over a fixed split of the N*L
//       rows into chunks (ops/gru_cuda.py bwd_chunks, a function of N*L
//       alone), then a kernel that sums the partials in chunk order
//       (bigru_backward_dw.cuh: K4's design).  h_prev is y at the shifted
//       row (m - 1 fwd, m + 1 bwd), masked to zero at each direction's
//       first step: without the mask y_f[n-1, L-1] would meet ghh[n, 0].
// No float atomics anywhere: the same bits on every run.
//
// What bounds it on an H100: at the UMPR-R shapes (N=2560, L=20, H=64,
// lengths uniform in 1..20, about 27,600 valid steps per direction) the
// function must read xg, h_prev and both cotangents at the valid steps
// (~85 MB) and write dxg (78.6 MB): ~49 us of HBM traffic.  Its products
// are 4.1 GFLOP of f32 FMA (~61 us at 67 TFLOP/s on the CUDA cores); as
// here, two of them are 3xTF32 on the tensor cores (~17 us at 495
// TFLOP/s) and one, the sweep's, f32 (~20 us): the bytes bound it.  The
// passes move more than the floor: Z is written (78.6 MB) and read back at
// the valid steps, ghn (26 MB) and dxg are read again by the dW pass.  On
// an H100 80GB HBM3 at 700 W (chip_smoke.py) the hg pass, sweep and dW
// pass take about 0.07, 0.12 and 0.10 ms here: the sweep is bound by the
// latency of its steps (loads, two barriers), the passes by their waits
// per tile or stage, none by its bytes (PERF.md section 6).

#include <climits>

#include "bigru_backward_dw.cuh"
#include "bigru_backward_hg.cuh"
#include "row_order.cuh"

namespace {

using row_order::load_tile;

constexpr int ROWS = 16;  // sentence rows per sweep block
// a block's shared memory on Hopper (227 KB), less the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 256;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// ---- (b) the sweep up to H = 128

// The product's register tile: TR rows x 4 units over one of KS slices of
// the 3H-deep sum; threads = (16 / TR) * (HP / 4) * KS <= 256, a multiple
// of HP.  HP: H rounded up to 4; BS: floats of one 4-unit block of W (12 H
// padded to 4 mod 32); GP: the row stride of ghh^T (16, or 20 where that
// fits: its stores then meet 4 to a bank, not 16).  8-row tiles where
// they fit (32 FMAs to each 16-byte load of W, the load that has no
// broadcast), else 4-row tiles in one slice (H = 125 .. 128); KS = 0
// where nothing fits.
struct SweepShape {
  int HP, TR, KS, BS, GP, threads;
  size_t smem;
};

constexpr int GPS[2] = {ROWS + 4, ROWS};

SweepShape sweep_shape(int H) {
  SweepShape s{};
  s.HP = (H + 3) & ~3;
  s.BS = 12 * H + ((4 - 12 * H % 32) % 32 + 32) % 32;
  const int shapes[][2] = {{8, 16}, {8, 8}, {8, 4}, {8, 2}, {4, 1}};  // (TR, KS)
  for (const auto& tk : shapes) {
    const int threads = ROWS / tk[0] * s.HP / 4 * tk[1];
    if (threads > 256) continue;
    for (const int gp : GPS) {
      const size_t floats =
          (size_t)(s.HP / 4) * s.BS + (size_t)3 * H * gp + (size_t)tk[1] * ROWS * s.HP;
      if (floats * sizeof(float) <= SMEM_LIMIT) {
        s.TR = tk[0];
        s.KS = tk[1];
        s.GP = gp;
        s.threads = threads;
        s.smem = floats * sizeof(float);
        return s;
      }
    }
  }
  return s;
}

template <int TR, int KS>
__global__ void __launch_bounds__(256)
bigru_backward_sweep(const float* __restrict__ xg, const float* __restrict__ y,
                     const float* __restrict__ dy_sent, const float* __restrict__ dy_pos,
                     const int* __restrict__ lengths, const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh, const int* __restrict__ order,
                     float* __restrict__ dxg, float* __restrict__ ghn, int N, int L, int H,
                     int BS, int GP) {
  constexpr int GROUPS = KS * 4 / TR;  // threads / HP
  constexpr int RPT = ROWS / GROUPS;   // rows per thread in the gate phase
  extern __shared__ float4 smem4[];
  __shared__ int row_s[ROWS], len_s[ROWS];
  __shared__ int maxlen_s;
  const int HP = (H + 3) & ~3, G = 3 * H;
  float* wq = reinterpret_cast<float*>(smem4);  // [HP / 4][BS]: W[4 jb + u][c] at 4 c + u
  float* gh = wq + (HP / 4) * BS;               // [3H][GP]: ghh^T
  float* part = gh + G * GP;                    // [KS][ROWS][HP]: the slices' sums
  const int d = blockIdx.y;  // 0: fwd, 1: bwd
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;

  // W_hh[d] into its 4-unit blocks: a warp per block, a lane per c, one
  // 16-byte store of the 4 units (an element at a time, with a division
  // per element, this took 19 us a block)
  const float* W = w_hh + (size_t)d * H * G;
  const int warps = blockDim.x / 32;  // whole warps (200 threads at H = 100: 6)
  for (int jb = tid / 32; tid < warps * 32 && jb < HP / 4; jb += warps)
    for (int c = tid % 32; c < G; c += 32) {
      float w4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w4[u] = 4 * jb + u < H ? W[(size_t)(4 * jb + u) * G + c] : 0.f;
      *reinterpret_cast<float4*>(wq + jb * BS + 4 * c) = make_float4(w4[0], w4[1], w4[2], w4[3]);
    }
  if (tid < ROWS) load_tile(order, lengths, row0 + tid, N, L, row_s[tid], len_s[tid]);
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < ROWS; ++r) m = max(m, len_s[r]);
    maxlen_s = m;
  }
  __syncthreads();
  const int maxlen = maxlen_s;

  // the gate phase: thread (j, grp) owns unit j of rows grp + GROUPS i
  const int j = tid % HP, grp = tid / HP;
  const bool unit = j < H;
  // the product: thread (pb, pa, ps) owns units 4 pb .. + 3 of rows
  // TR pa .. + TR - 1 over slice ps of c
  const int pb = tid % (HP / 4), pa = (tid / (HP / 4)) % (ROWS / TR);
  const int ps = tid / (HP / 4 * (ROWS / TR));
  const int cs = (G + KS - 1) / KS;
  const int c_begin = min(G, ps * cs), c_end = min(G, c_begin + cs);

  const float b_r = unit ? b_hh[d * G + j] : 0.f;
  const float b_z = unit ? b_hh[d * G + H + j] : 0.f;
  const float b_n = unit ? b_hh[d * G + 2 * H + j] : 0.f;
  int row[RPT], len[RPT];
  float g[RPT], gz[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    row[i] = row_s[grp + GROUPS * i];  // -1 past N
    len[i] = len_s[grp + GROUPS * i];  // 0 past N: never valid
    g[i] = gz[i] = 0.f;
  }
  const size_t y_stride = 2 * (size_t)H;
  const size_t xg_stride = 6 * (size_t)H;

  // steps no row of the tile reaches: dxg = 0, dn r = 0
  if (unit)
    for (int t = maxlen; t < L; ++t)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (row[i] >= 0) {
          const size_t at = (size_t)row[i] * L + t;
          float* o = dxg + at * xg_stride + d * G;
          o[j] = o[H + j] = o[2 * H + j] = 0.f;
          ghn[at * y_stride + d * H + j] = 0.f;
        }

  // a step's loads per row: xg's three gates, Z's (0 where h_prev = 0),
  // h_prev, the two cotangents.  Up to 8 rows a thread, the next
  // step's loads are issued before this step's product, so they land
  // while it runs (they never meet this step's stores: Z is read at tp,
  // dxg written at t, and tp is never an earlier step's t)
  constexpr bool AHEAD = RPT <= 8;
  float in[RPT][9];
  auto fetch = [&](int t) {
    const int tp = d == 0 ? t - 1 : t + 1;  // where y holds h_prev
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int k = 0; k < 9; ++k) in[i][k] = 0.f;
      if (!unit || t >= len[i]) continue;
      const size_t at = (size_t)row[i] * L + t;
      const float* x = xg + at * xg_stride + d * G;
      in[i][0] = x[j];
      in[i][1] = x[H + j];
      in[i][2] = x[2 * H + j];
      const size_t o = at * y_stride + d * H + j;
      in[i][7] = dy_sent[o];
      in[i][8] = dy_pos[o];
      if (tp >= 0 && tp < len[i]) {  // else h_prev = 0: hg = b
        const size_t ap = (size_t)row[i] * L + tp;
        const float* z = dxg + ap * xg_stride + d * G;  // the hg pass's Z
        in[i][3] = z[j];
        in[i][4] = z[H + j];
        in[i][5] = z[2 * H + j];
        in[i][6] = y[ap * y_stride + d * H + j];
      }
    }
  };
  if (AHEAD && maxlen > 0) fetch(d == 0 ? maxlen - 1 : 0);

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? maxlen - 1 - s : s;
    if (!AHEAD) fetch(t);
    if (unit) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float dr = 0.f, dz = 0.f, dn = 0.f, dhn = 0.f;
        if (t < len[i]) {
          const float hg_r = in[i][3] + b_r, hg_z = in[i][4] + b_z, hg_n = in[i][5] + b_n;
          const float r = sigmoid(in[i][0] + hg_r);
          const float zg = sigmoid(in[i][1] + hg_z);
          const float n = tanhf(in[i][2] + r * hg_n);
          g[i] += in[i][7] + in[i][8];
          dn = g[i] * (1.f - zg) * (1.f - n * n);
          dz = g[i] * (in[i][6] - n) * zg * (1.f - zg);
          dr = dn * hg_n * r * (1.f - r);
          dhn = dn * r;
          gz[i] = g[i] * zg;
        }
        if (row[i] >= 0) {
          const size_t at = (size_t)row[i] * L + t;
          float* o = dxg + at * xg_stride + d * G;
          o[j] = dr;
          o[H + j] = dz;
          o[2 * H + j] = dn;
          ghn[at * y_stride + d * H + j] = dhn;
        }
        const int rr = grp + GROUPS * i;
        gh[j * GP + rr] = dr;
        gh[(H + j) * GP + rr] = dz;
        gh[(2 * H + j) * GP + rr] = dhn;
      }
    }
    if (AHEAD && s + 1 < maxlen) fetch(d == 0 ? t - 1 : t + 1);
    __syncthreads();  // ghh of every row; every read of the last slice sums done

    // this thread's slice of ghh @ W^T: per c, TR / 4 16-byte loads of ghh
    // (broadcasts) and one of W feed 4 TR FMAs
    {
      float acc[TR][4];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[a][u] = 0.f;
      const float4* wv = reinterpret_cast<const float4*>(wq + pb * BS);
      const float* hv = gh + TR * pa;
#pragma unroll 4
      for (int c = c_begin; c < c_end; ++c) {
        const float4 w4 = wv[c];
#pragma unroll
        for (int q = 0; q < TR / 4; ++q) {
          const float4 h4 = *reinterpret_cast<const float4*>(hv + c * GP + 4 * q);
          const float hr[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[4 * q + a][0] = fmaf(hr[a], w4.x, acc[4 * q + a][0]);
            acc[4 * q + a][1] = fmaf(hr[a], w4.y, acc[4 * q + a][1]);
            acc[4 * q + a][2] = fmaf(hr[a], w4.z, acc[4 * q + a][2]);
            acc[4 * q + a][3] = fmaf(hr[a], w4.w, acc[4 * q + a][3]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < TR; ++a)
        *reinterpret_cast<float4*>(part + (ps * ROWS + TR * pa + a) * HP + 4 * pb) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    __syncthreads();  // the slice sums; every read of this step's ghh done

    // g = g z + ghh @ W^T at valid steps, the slices added in order
    if (unit) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int rr = grp + GROUPS * i;
        float sum = part[rr * HP + j];
#pragma unroll
        for (int q = 1; q < KS; ++q) sum += part[(q * ROWS + rr) * HP + j];
        if (t < len[i]) g[i] = gz[i] + sum;
      }
    }
  }
}

// ---- (b) the sweep past H = 128: W_hh^T in L2

constexpr int WTHREADS = 256;  // threads of the wide sweep

// h_prev (H x 16), ghh (3H x 16), g (H x 16): transposed, k-major
size_t wide_state_bytes(int H) { return (size_t)5 * H * ROWS * sizeof(float); }

__global__ void __launch_bounds__(WTHREADS)
bigru_backward_wide(const float* __restrict__ xg, const float* __restrict__ y,
                    const float* __restrict__ dy_sent, const float* __restrict__ dy_pos,
                    const int* __restrict__ lengths, const float* __restrict__ w_hh_t,
                    const float* __restrict__ b_hh, const int* __restrict__ order,
                    float* __restrict__ dxg, float* __restrict__ ghn,
                    float* __restrict__ scratch, int N, int L, int H) {
  extern __shared__ float4 smem4[];
  __shared__ int row_s[ROWS], len_s[ROWS];
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
  const float* WT = w_hh_t + (size_t)d * G * H;  // (3H, H)

  for (int i = tid; i < H * ROWS; i += WTHREADS) g_s[i] = 0.f;
  if (tid < ROWS) load_tile(order, lengths, row0 + tid, N, L, row_s[tid], len_s[tid]);
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
      const int n = row_s[i / H], j = i % H;
      if (n < 0) continue;
      const size_t at = (size_t)n * L + t;
      float* o = dxg + at * xg_stride + d * G;
      o[j] = o[H + j] = o[2 * H + j] = 0.f;
      ghn[at * y_stride + d * H + j] = 0.f;
    }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? maxlen - 1 - s : s;
    const int tp = d == 0 ? t - 1 : t + 1;  // where y holds h_prev
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int r = i / H, k = i % H;
      hp_s[k * ROWS + r] = t < len_s[r] && tp >= 0 && tp < len_s[r]
                               ? y[((size_t)row_s[r] * L + tp) * y_stride + d * H + k]
                               : 0.f;
    }
    __syncthreads();  // h_prev of every row; every read of the last ghh done

    for (int j = tid; j < H; j += WTHREADS) {
      const float b_r = b_hh[d * G + j], b_z = b_hh[d * G + H + j], b_n = b_hh[d * G + 2 * H + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int n = row_s[r];
        float dr = 0.f, dz = 0.f, dn = 0.f, dhn = 0.f;
        float g = g_s[j * ROWS + r];
        if (t < len_s[r]) {
          float hg_r = b_r, hg_z = b_z, hg_n = b_n;
          if (tp >= 0 && tp < len_s[r]) {  // else h_prev = 0: hg = b
            const float* z = dxg + ((size_t)n * L + tp) * xg_stride + d * G;  // the hg pass's Z
            hg_r = z[j] + b_r;
            hg_z = z[H + j] + b_z;
            hg_n = z[2 * H + j] + b_n;
          }
          const size_t at = (size_t)n * L + t;
          const float* x = xg + at * xg_stride + d * G;
          const float rg = sigmoid(x[j] + hg_r);
          const float z = sigmoid(x[H + j] + hg_z);
          const float nn = tanhf(x[2 * H + j] + rg * hg_n);
          const size_t o = at * y_stride + d * H + j;
          g += dy_sent[o] + dy_pos[o];
          const float hp = hp_s[j * ROWS + r];
          dn = g * (1.f - z) * (1.f - nn * nn);
          dz = g * (hp - nn) * z * (1.f - z);
          dr = dn * hg_n * rg * (1.f - rg);
          dhn = dn * rg;
          g = g * z;  // ghh @ W^T is added below
        }
        if (n >= 0) {
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

    // g = g z + ghh @ W^T at valid steps (W^T's rows: coalesced over j;
    // unrolled, so that eight of its L2 loads are in flight at once: one
    // at a time, their latency set the wide sweep's pace)
    for (int j = tid; j < H; j += WTHREADS) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
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

}  // namespace

// xg (N, L, 6H), y (N, L, 2H), dy_sent and dy_pos (N, L, 2H) by address,
// lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H) -> dxg (N, L, 6H), dw
// (2, H, 3H) and db (2, 3H): f32, contiguous, on the device, any H >= 1.
// Scratch: ghn (N, L, 2H); order (N,) int32; the partials dw_part
// (chunks, 2, H, 3H) and db_part (chunks, 2, 3H), chunks = ceil(N*L /
// chunk_rows) (1 when N*L = 0), chunk_rows a positive multiple of 32; past
// H = 128, w_hh_t = w_hh transposed (2, 3H, H) and scratch
// bigru_backward_scratch(N, H) floats (may be null where that is 0), else
// both unused.  Launches the hg pass, the row order, the sweep and the dW
// pass (two kernels) on `stream`; returns the first failure's
// cudaError_t.
extern "C" int bigru_backward(const float* xg, const float* y, const float* dy_sent,
                              const float* dy_pos, const int* lengths, const float* w_hh,
                              const float* w_hh_t, const float* b_hh, float* dxg, float* ghn,
                              int* order, float* scratch, float* dw_part, float* db_part,
                              float* dw, float* db, int N, int L, int H, int chunk_rows,
                              void* stream) {
  if (H <= 0 || N < 0 || L < 0 || (long long)N * L > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * L;
  cudaError_t err;
  if (M > 0) {
    // (a) Z_d = y_d @ W_hh[d] into dxg's direction halves
    const int e = hg::launch(y, w_hh, dxg, M, H, s);
    if (e != 0) return e;
    // (b) the sweep, its rows longest first (row_order.cuh)
    const int o = row_order::launch(lengths, order, N, L, s);
    if (o != 0) return o;
    const SweepShape sh = sweep_shape(H);
    const dim3 grid((N + ROWS - 1) / ROWS, 2);
    if (sh.KS > 0) {
      auto kernel = bigru_backward_sweep<4, 1>;
      switch (sh.KS) {
        case 16: kernel = bigru_backward_sweep<8, 16>; break;
        case 8: kernel = bigru_backward_sweep<8, 8>; break;
        case 4: kernel = bigru_backward_sweep<8, 4>; break;
        case 2: kernel = bigru_backward_sweep<8, 2>; break;
        default: break;
      }
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sh.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, sh.threads, sh.smem, s>>>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, order,
                                               dxg, ghn, N, L, H, sh.BS, sh.GP);
    } else {
      const bool shared = wide_state_bytes(H) <= SMEM_LIMIT;
      if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = shared ? wide_state_bytes(H) : 0;
      err = cudaFuncSetAttribute(bigru_backward_wide,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      bigru_backward_wide<<<grid, WTHREADS, smem, s>>>(xg, y, dy_sent, dy_pos, lengths, w_hh_t,
                                                       b_hh, order, dxg, ghn,
                                                       shared ? nullptr : scratch, N, L, H);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // (c) dW_hh, db_hh over the rows' chunks, then their fixed-order sum
  return dw::launch(y, dxg, ghn, dw_part, db_part, dw, db, M, L, H, chunk_rows, s);
}

// floats of the scratch the wide sweep needs at (N, H): 0 up to H = 128
// (the shared-memory sweep) and where its state fits the shared memory
extern "C" long long bigru_backward_scratch(int N, int H) {
  if (sweep_shape(H).KS > 0 || wide_state_bytes(H) <= SMEM_LIMIT) return 0;
  return (long long)((N + ROWS - 1) / ROWS) * 2 * 5 * H * ROWS;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
