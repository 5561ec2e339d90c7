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
// bf16 IO (bigru_backward_bf16, --compute_dtype bfloat16; the TPU
// kernel's bf16 path, _bwd_kernel and _gru_dy_kernel): xg, y, the
// cotangents, W_hh and b_hh in bf16, dxg out in bf16, the gate math, g and
// the dW / db sums in f32.  The rounding points are the TPU kernels'
// (gru_pallas.py:641-679): the two cotangents' sum is rounded to bf16 (B7
// adds them in bf16); h_prev is y's bf16 value, as the TPU's bf16 hs; hg
// = h_prev W_hh takes bf16 operands and an f32 sum, plus b; ghh is
// rounded to bf16 as the operand of both products (g z + ghh W^T and
// h_prev^T ghh), while db sums it unrounded; dxg is rounded on store.
// Up to H = 128 the sweep is its own kernel, bigru_backward_bf16_sweep
// (below): both products of a step, hg = h_prev W_hh and ghh W^T, on bf16
// mma.sync m16n8k16 with f32 accumulators, the products the TPU kernel
// takes (a bf16 product is exact, the sums f32), so there is no hg pass
// and no Z: the pass's 78.6 MB f32 write and its read-back at the valid
// steps are gone at the UMPR-R shapes.  The sweep leaves the unrounded [dr
// | dz] in an f32 buffer of its own (zbuf, in dxg's layout) for the dW
// pass, which reads no bf16 dxg.  Past H = 128 the hg pass writes Z into
// zbuf first and bigru_backward_wide reads it, as for f32.
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
// per tile or stage, none by its bytes (PERF.md section 6).  In bf16 the
// function's floor is half of it, ~24 us.  The bf16 sweep writes 118 MB
// there (dxg in bf16, [dr | dz] and dn r in f32 for the dW pass, zeros
// past each length included) and reads ~41 MB, ~47 us of HBM traffic; it
// takes about 0.12 ms and the dW pass 0.07 on that card.

#include <climits>
#include <cstdint>

#include "bigru_backward_dw.cuh"
#include "bigru_backward_hg.cuh"
#include "row_order.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using row_order::load_tile;
using tf32x3::bf16;
using tf32x3::cp_async16_zfill;
using tf32x3::cp_async4_zfill;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::io_from;
using tf32x3::is_bf16;
using tf32x3::ld;
using tf32x3::round_to;

constexpr int ROWS = 16;  // sentence rows per sweep block
constexpr int SWEEP_MAX_H = 128;  // the shared-memory sweeps' H (ops/gru_cuda.py BWD_SWEEP_MAX_H)
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

// f32 IO only (launch_sweep's float overload; bf16 takes
// bigru_backward_bf16_sweep).  zbuf: the hg pass's Z, which is dxg
// itself.  (No __restrict__ on dxg and zbuf: they alias.)
template <int TR, int KS, class T>
__global__ void __launch_bounds__(256)
bigru_backward_sweep(const T* __restrict__ xg, const T* __restrict__ y,
                     const T* __restrict__ dy_sent, const T* __restrict__ dy_pos,
                     const int* __restrict__ lengths, const T* __restrict__ w_hh,
                     const T* __restrict__ b_hh, const int* __restrict__ order, T* dxg,
                     float* zbuf, float* __restrict__ ghn, int N, int L, int H, int BS, int GP) {
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
  const T* W = w_hh + (size_t)d * H * G;
  const int warps = blockDim.x / 32;  // whole warps (200 threads at H = 100: 6)
  for (int jb = tid / 32; tid < warps * 32 && jb < HP / 4; jb += warps)
    for (int c = tid % 32; c < G; c += 32) {
      float w4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w4[u] = 4 * jb + u < H ? ld(W[(size_t)(4 * jb + u) * G + c]) : 0.f;
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

  const float b_r = unit ? ld(b_hh[d * G + j]) : 0.f;
  const float b_z = unit ? ld(b_hh[d * G + H + j]) : 0.f;
  const float b_n = unit ? ld(b_hh[d * G + 2 * H + j]) : 0.f;
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

  // a step's outputs: dxg and dn r in ghn
  auto store = [&](size_t at, float dr, float dz, float dn, float dhn) {
    T* o = dxg + at * xg_stride + d * G;
    o[j] = io_from<T>(dr);
    o[H + j] = io_from<T>(dz);
    o[2 * H + j] = io_from<T>(dn);
    ghn[at * y_stride + d * H + j] = dhn;
  };

  // steps no row of the tile reaches: dxg = 0, dn r = 0
  if (unit)
    for (int t = maxlen; t < L; ++t)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (row[i] >= 0) store((size_t)row[i] * L + t, 0.f, 0.f, 0.f, 0.f);

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
      const T* x = xg + at * xg_stride + d * G;
      in[i][0] = ld(x[j]);
      in[i][1] = ld(x[H + j]);
      in[i][2] = ld(x[2 * H + j]);
      const size_t o = at * y_stride + d * H + j;
      in[i][7] = ld(dy_sent[o]);
      in[i][8] = ld(dy_pos[o]);
      if (tp >= 0 && tp < len[i]) {  // else h_prev = 0: hg = b
        const size_t ap = (size_t)row[i] * L + tp;
        const float* z = zbuf + ap * xg_stride + d * G;  // the hg pass's Z
        in[i][3] = z[j];
        in[i][4] = z[H + j];
        in[i][5] = z[2 * H + j];
        in[i][6] = ld(y[ap * y_stride + d * H + j]);
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
          g[i] += round_to<T>(in[i][7] + in[i][8]);
          dn = g[i] * (1.f - zg) * (1.f - n * n);
          dz = g[i] * (in[i][6] - n) * zg * (1.f - zg);
          dr = dn * hg_n * r * (1.f - r);
          dhn = dn * r;
          gz[i] = g[i] * zg;
        }
        if (row[i] >= 0) store((size_t)row[i] * L + t, dr, dz, dn, dhn);
        // ghh as the product's operand (bf16: rounded)
        const int rr = grp + GROUPS * i;
        gh[j * GP + rr] = round_to<T>(dr);
        gh[(H + j) * GP + rr] = round_to<T>(dz);
        gh[(2 * H + j) * GP + rr] = round_to<T>(dhn);
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

// ---- (b) the bf16 sweep up to H = 128: both products on bf16 mma.sync,
// the hg product fused
//
// One block per (16-row tile, direction), warp w owning hidden units 16 w
// .. 16 w + 15 of all 16 rows (HP / 16 warps; HP: H rounded up to 16, the
// units past H zero).  Shared memory, bf16: W_hh[d] as [HP][WS], each
// gate's block padded to HP units (ws[i][gate HP + u] = W[i][gate H + u]);
// two ghh tiles [16][GS] (dr | dz | dn r | dn, each HP) and two h_prev
// tiles [16][HS]; f32, two output tiles [16][OS] (dr | dz | dn r).  WS = 3
// HP + 8, GS = 4 HP + 8, HS = HP + 8: rows 16 bytes apart mod 128, so
// ldmatrix's 8 rows of a matrix fall on distinct banks.  A step:
//   - the next step's h_prev tile (y at tp, zero where h_prev = 0) goes
//     into the other buffer by cp.async;
//   - hg = h_prev W (+ b): m16n8k16 over HP / 16 k-steps into 6 n8 tiles
//     (r, z, n of the warp's 16 units), A from the h_prev tile, B from
//     W_hh by ldmatrix.trans; its A fragment of the warp's own k-step is
//     the lane's h_prev for dz (the accumulator layout of two n8 tiles is
//     the A layout of one k16 step);
//   - the gates in that layout: lane (g, t) holds rows g, g + 8 x units
//     16 w + 2t (+1) and 16 w + 8 + 2t (+1), so xg and the cotangents
//     load as 4-byte pairs where H is even; ghh and dn rounded to bf16
//     into this step's ghh tile, [dr | dz | dn r] into its output tile;
//   - the next step's xg and cotangents are loaded into registers;
//   - one barrier (cp.async done; ghh of every warp);
//   - g = g z + ghh W^T: m16n8k16 over 3 HP / 16 k-steps into the 2 n8
//     tiles of the warp's units, A from the ghh tile, B from W_hh's rows
//     (k-contiguous) by ldmatrix; g z is added to the product's sum last;
//   - the step's outputs go out of the staged tiles (ghh with dn, bf16;
//     [dr | dz | dn r], f32) as 16-byte pieces of whole rows, a warp's
//     lanes on consecutive pieces.
// Each k-step's mma starts from zero and is added to its sum in f32: the
// tensor core's own accumulation rounds more coarsely than an f32 add (see
// tf32x3.cuh mma3_add).  Its error, carried along the recurrence, flips
// ghh's bf16 roundings.  With the sum started at g z (every add then
// rounds at g's magnitude) the dxg values past one bf16 ulp of the plain
// version exceeded a card test's share (H = 128, rows of full length);
// chip_smoke.py --steps counts them for that and for the accumulators
// chained.  Stored from the lanes' registers (4- or 8-byte pieces of 8
// rows a warp store), the outputs took a fifth of the sweep's time more.
// Two tiles each of ghh, h_prev and outputs make one barrier a step
// enough: a tile is rewritten two steps after it was written, past the
// next barrier.
// Every row's arithmetic is the same in any slot of any tile.
struct Bf16Sweep {
  int HP, WS, GS, HS, OS, threads;
  size_t smem;
};

__host__ __device__ inline Bf16Sweep bf16_sweep_shape(int H) {
  Bf16Sweep s{};
  s.HP = (H + 15) & ~15;
  s.WS = 3 * s.HP + 8;
  s.GS = 4 * s.HP + 8;
  s.HS = s.HP + 8;
  s.OS = 3 * s.HP + (8 - 3 * s.HP % 32 + 32) % 32;  // 8 mod 32: float2 writes on distinct banks
  s.threads = 2 * s.HP;  // a warp per 16 units
  s.smem = ((size_t)s.HP * s.WS + (size_t)2 * ROWS * (s.GS + s.HS)) * sizeof(bf16) +
           (size_t)2 * ROWS * s.OS * sizeof(float);
  return s;
}

// xg, dy_sent, dy_pos by (row, step) in pairs of units: one 4-byte load
// where `pairs` (H even, the tensors 4-byte aligned), else two 2-byte ones
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool lo, bool hi, bool pairs) {
  if (pairs) return lo ? *reinterpret_cast<const uint32_t*>(p) : 0u;
  return (lo ? wgmma_bf16::bits(p[0]) : 0u) | (hi ? wgmma_bf16::bits(p[1]) : 0u) << 16;
}

// hp_piece: bf16 a copy of an h_prev tile row takes (8: 16-byte cp.async,
// H % 8 == 0 and y 16-byte aligned; 2: 4-byte cp.async; 1: plain copies);
// w_vec: W_hh copied 16 bytes at a time (H % 16 == 0, aligned); vec: the
// outputs stored 16 bytes at a time (H % 8 == 0, aligned).  No bound on
// the blocks an SM: squeezed to 168 registers for three 4-warp blocks an
// SM, the sweep took 8% longer than at two (a step of chip_smoke.py
// --steps, since removed; PERF.md section 6)
__global__ void __launch_bounds__(256)
bigru_backward_bf16_sweep(const bf16* __restrict__ xg, const bf16* __restrict__ y,
                          const bf16* __restrict__ dy_sent, const bf16* __restrict__ dy_pos,
                          const int* __restrict__ lengths, const bf16* __restrict__ w_hh,
                          const bf16* __restrict__ b_hh, const int* __restrict__ order,
                          bf16* __restrict__ dxg, float* __restrict__ zbuf,
                          float* __restrict__ ghn, int N, int L, int H, int pairs, int hp_piece,
                          int w_vec, int vec) {
  using namespace wgmma_bf16;
  extern __shared__ uint4 smem16[];
  __shared__ int row_s[ROWS], len_s[ROWS];
  const Bf16Sweep sh = bf16_sweep_shape(H);
  const int HP = sh.HP, WS = sh.WS, GS = sh.GS, HS = sh.HS, OS = sh.OS, G = 3 * H, KH = HP / 16;
  bf16* ws = reinterpret_cast<bf16*>(smem16);  // [HP][WS]: W_hh[d], gate blocks of HP units
  bf16* gh = ws + HP * WS;                     // [2][ROWS][GS]: dr | dz | dn r | dn, bf16
  bf16* hb = gh + 2 * ROWS * GS;               // [2][ROWS][HS]: h_prev
  float* ob = reinterpret_cast<float*>(hb + 2 * ROWS * HS);  // [2][ROWS][OS]: dr | dz | dn r
  const int d = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  // ldmatrix: this lane's row of matrix mat
  const int mat = lane / 8, mr = lane % 8;
  const int u0 = 16 * warp;
  const bf16 zero = __float2bfloat16(0.f);

  const bf16* W = w_hh + (size_t)d * H * G;
  if (w_vec) {  // HP == H: a row of W is a row of ws
    const int P = G / 8;
#pragma unroll 4
    for (int k = tid; k < H * P; k += blockDim.x) {
      const int i = k / P, c = k - i * P;
      *reinterpret_cast<uint4*>(ws + i * WS + 8 * c) =
          __ldg(reinterpret_cast<const uint4*>(W + (size_t)i * G) + c);
    }
  } else {
    for (int r = warp; r < 3 * HP; r += blockDim.x / 32) {
      const int i = r / 3, gate = r - 3 * i;
#pragma unroll 4
      for (int u = lane; u < HP; u += 32)
        ws[i * WS + gate * HP + u] = i < H && u < H ? W[(size_t)i * G + gate * H + u] : zero;
    }
  }
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

  // step t's outputs of the tile's rows, from buffer buf of the ghh tile
  // (dxg: [dr | dz] and dn, bf16) and of the output tile ([dr | dz] for
  // zbuf, dn r for ghn, f32), or zeros: warp w takes rows w, w + warps,
  // ..., its lanes consecutive pieces of each row's three spans, 16 bytes
  // a piece where `vec`, else an element
  auto emit = [&](int t, int buf, bool zeros) {
    const bf16* gt = gh + buf * ROWS * GS;
    const float* ot = ob + buf * ROWS * OS;
    for (int r = warp; r < ROWS; r += blockDim.x / 32) {
      if (row_s[r] < 0) continue;
      const size_t at = (size_t)row_s[r] * L + t;
      bf16* xo = dxg + at * xs + d * G;
      float* zo = zbuf + at * xs + d * G;
      float* go = ghn + at * ys + d * H;
      const bf16* gr = gt + r * GS;
      const float* orow = ot + r * OS;
      if (vec) {  // pieces: dxg H / 8 a gate, zbuf H / 4 a gate, ghn H / 4
        const int PX = H / 8, PQ = H / 4;
        for (int c = lane; c < 3 * PX + 3 * PQ; c += 32) {
          if (c < 3 * PX) {
            const int gate = c >= 2 * PX ? 2 : c >= PX ? 1 : 0;
            const int u = 8 * (c - gate * PX);
            *reinterpret_cast<uint4*>(xo + gate * H + u) =
                zeros ? make_uint4(0u, 0u, 0u, 0u)
                      : *reinterpret_cast<const uint4*>(gr + (gate == 2 ? 3 : gate) * HP + u);
          } else {
            const int k = c - 3 * PX, gate = k >= 2 * PQ ? 2 : k >= PQ ? 1 : 0;
            const int u = 4 * (k - gate * PQ);
            float* o = gate == 2 ? go + u : zo + gate * H + u;
            *reinterpret_cast<float4*>(o) =
                zeros ? make_float4(0.f, 0.f, 0.f, 0.f)
                      : *reinterpret_cast<const float4*>(orow + gate * HP + u);
          }
        }
      } else {
        for (int c = lane; c < 6 * H; c += 32) {
          const int k = c % (3 * H), gate = k >= 2 * H ? 2 : k >= H ? 1 : 0, u = k - gate * H;
          if (c < 3 * H)
            xo[k] = zeros ? zero : gr[(gate == 2 ? 3 : gate) * HP + u];
          else
            (gate == 2 ? go[u] : zo[k]) = zeros ? 0.f : orow[gate * HP + u];
        }
      }
    }
  };

  // steps no row of the tile reaches: dxg = 0, dn r = 0
  for (int t = maxlen; t < L; ++t) emit(t, 0, true);

  // step t's h_prev tile into buffer buf: y at tp for the rows where it
  // is the state before a valid step, zeros elsewhere (and past H)
  auto fetch_hp = [&](int t, int buf) {
    const int tp = d == 0 ? t - 1 : t + 1;
    bf16* tile = hb + buf * ROWS * HS;
    const int per = HP / hp_piece;
    for (int k = tid; k < ROWS * per; k += blockDim.x) {
      const int r = k / per, u = (k - r * per) * hp_piece;
      const bool live = t < len_s[r] && tp >= 0 && tp < len_s[r] && u < H;
      const bf16* src = live ? y + ((size_t)row_s[r] * L + tp) * ys + d * H + u : y;
      bf16* dst = tile + r * HS + u;
      if (hp_piece == 8)
        cp_async16_zfill(dst, src, live ? 16 : 0);
      else if (hp_piece == 2)
        cp_async4_zfill(dst, src, live ? 4 : 0);
      else
        *dst = live ? *src : zero;
    }
    cp_async_commit();
  };
  // step t's xg and cotangents at the lane's (row, unit) pairs
  uint32_t xin[2][3][2], dys[2][2], dyp[2][2];
  auto fetch = [&](int t) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = t < len[q];
        const size_t at = (size_t)(live ? row[q] : 0) * L + t;
        const int u = u0 + 8 * h + 2 * tq;
        const bool lo = live && ok[h][0], hi = live && ok[h][1];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          xin[q][gate][h] = ld_pair(xg + at * xs + d * G + gate * H + u, lo, hi, pairs);
        dys[q][h] = ld_pair(dy_sent + at * ys + d * H + u, lo, hi, pairs);
        dyp[q][h] = ld_pair(dy_pos + at * ys + d * H + u, lo, hi, pairs);
      }
  };

  float g[2][2][2] = {};  // d loss / d state at (row q, units of h, e)
  if (maxlen > 0) {
    fetch_hp(d == 0 ? maxlen - 1 : 0, 0);
    fetch(d == 0 ? maxlen - 1 : 0);
  }
  cp_async_wait<0>();
  __syncthreads();  // W_hh, the first h_prev tile

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? maxlen - 1 - s : s;
    const int tn = d == 0 ? t - 1 : t + 1;  // the next step
    if (s + 1 < maxlen) fetch_hp(tn, (s + 1) & 1);

    // hg = h_prev W_hh: 6 n8 tiles (gate, h) of the warp's units
    float hg[3][2][4] = {};
    uint32_t own[4] = {};  // h_prev at the lane's (row, unit) pairs
    const bf16* hpt = hb + (s & 1) * ROWS * HS;
#pragma unroll 2
    for (int kk = 0; kk < KH; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, hpt + (8 * (mat & 1) + mr) * HS + 16 * kk + 8 * (mat >> 1));
      if (kk == warp) {
#pragma unroll
        for (int i = 0; i < 4; ++i) own[i] = a[i];
      }
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        uint32_t w4[4];
        ldsm_x4_trans(w4, ws + (16 * kk + 8 * (mat & 1) + mr) * WS + gate * HP + u0 + 8 * (mat >> 1));
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

    // the gates; ghh rounded into this step's tile
    bf16* ght = gh + (s & 1) * ROWS * GS;
    float gz[2][2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dr[2] = {}, dz[2] = {}, dn[2] = {}, dhn[2] = {};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          gz[q][h][e] = 0.f;
          if (t >= len[q]) continue;
          const float hp = e ? hi_f(own[q + 2 * h]) : lo_f(own[q + 2 * h]);
          const float x_r = e ? hi_f(xin[q][0][h]) : lo_f(xin[q][0][h]);
          const float x_z = e ? hi_f(xin[q][1][h]) : lo_f(xin[q][1][h]);
          const float x_n = e ? hi_f(xin[q][2][h]) : lo_f(xin[q][2][h]);
          const float dy = e ? hi_f(dys[q][h]) + hi_f(dyp[q][h]) : lo_f(dys[q][h]) + lo_f(dyp[q][h]);
          const float hg_r = hg[0][h][2 * q + e] + b[0][h][e];
          const float hg_z = hg[1][h][2 * q + e] + b[1][h][e];
          const float hg_n = hg[2][h][2 * q + e] + b[2][h][e];
          const float r = sigmoid(x_r + hg_r);
          const float zg = sigmoid(x_z + hg_z);
          const float n = tanhf(x_n + r * hg_n);
          g[q][h][e] += round_to<bf16>(dy);
          dn[e] = g[q][h][e] * (1.f - zg) * (1.f - n * n);
          dz[e] = g[q][h][e] * (hp - n) * zg * (1.f - zg);
          dr[e] = dn[e] * hg_n * r * (1.f - r);
          dhn[e] = dn[e] * r;
          gz[q][h][e] = g[q][h][e] * zg;
        }
        const int at = (gq + 8 * q) * GS + u0 + 8 * h + 2 * tq;
        *reinterpret_cast<uint32_t*>(ght + at) = round_pair(dr[0], dr[1]);
        *reinterpret_cast<uint32_t*>(ght + at + HP) = round_pair(dz[0], dz[1]);
        *reinterpret_cast<uint32_t*>(ght + at + 2 * HP) = round_pair(dhn[0], dhn[1]);
        *reinterpret_cast<uint32_t*>(ght + at + 3 * HP) = round_pair(dn[0], dn[1]);
        float* o = ob + (s & 1) * ROWS * OS + (gq + 8 * q) * OS + u0 + 8 * h + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2(dr[0], dr[1]);
        *reinterpret_cast<float2*>(o + HP) = make_float2(dz[0], dz[1]);
        *reinterpret_cast<float2*>(o + 2 * HP) = make_float2(dhn[0], dhn[1]);
      }
    if (s + 1 < maxlen) fetch(tn);
    cp_async_wait<0>();
    __syncthreads();  // ghh of every warp; the next h_prev tile

    // g = g z + ghh W_hh^T at valid steps, g z added to the product's sum
    float acc[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < 3 * KH; ++kk) {
      uint32_t a[4], w4[4];
      ldsm_x4(a, ght + (8 * (mat & 1) + mr) * GS + 16 * kk + 8 * (mat >> 1));
      ldsm_x4(w4, ws + (u0 + 8 * (mat >> 1) + mr) * WS + 16 * kk + 8 * (mat & 1));
      float p0[4] = {}, p1[4] = {};
      mma_bf16(p0, a, w4[0], w4[1]);
      mma_bf16(p1, a, w4[2], w4[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[0][i] += p0[i];
        acc[1][i] += p1[i];
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t < len[q]) g[q][h][e] = gz[q][h][e] + acc[h][2 * q + e];
    emit(t, s & 1, false);
  }
}

// ---- (b) the sweep past H = 128: W_hh^T in L2

constexpr int WTHREADS = 256;  // threads of the wide sweep

// h_prev (H x 16), ghh (3H x 16), g (H x 16): transposed, k-major
size_t wide_state_bytes(int H) { return (size_t)5 * H * ROWS * sizeof(float); }

template <class T>
__global__ void __launch_bounds__(WTHREADS)
bigru_backward_wide(const T* __restrict__ xg, const T* __restrict__ y,
                    const T* __restrict__ dy_sent, const T* __restrict__ dy_pos,
                    const int* __restrict__ lengths, const T* __restrict__ w_hh_t,
                    const T* __restrict__ b_hh, const int* __restrict__ order, T* dxg,
                    float* zbuf, float* __restrict__ ghn, float* __restrict__ scratch, int N,
                    int L, int H) {
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
  const T* WT = w_hh_t + (size_t)d * G * H;  // (3H, H)

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

  // a step's outputs of unit j: dxg (rounded to T), for bf16 the
  // unrounded [dr | dz] in zbuf, and dn r in ghn
  auto store = [&](size_t at, int j, float dr, float dz, float dn, float dhn) {
    T* o = dxg + at * xg_stride + d * G;
    o[j] = io_from<T>(dr);
    o[H + j] = io_from<T>(dz);
    o[2 * H + j] = io_from<T>(dn);
    if constexpr (is_bf16<T>) {
      float* zo = zbuf + at * xg_stride + d * G;
      zo[j] = dr;
      zo[H + j] = dz;
    }
    ghn[at * y_stride + d * H + j] = dhn;
  };

  // steps no row of the tile reaches: dxg = 0, dn r = 0
  for (int t = maxlen; t < L; ++t)
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int n = row_s[i / H];
      if (n >= 0) store((size_t)n * L + t, i % H, 0.f, 0.f, 0.f, 0.f);
    }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? maxlen - 1 - s : s;
    const int tp = d == 0 ? t - 1 : t + 1;  // where y holds h_prev
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int r = i / H, k = i % H;
      hp_s[k * ROWS + r] = t < len_s[r] && tp >= 0 && tp < len_s[r]
                               ? ld(y[((size_t)row_s[r] * L + tp) * y_stride + d * H + k])
                               : 0.f;
    }
    __syncthreads();  // h_prev of every row; every read of the last ghh done

    for (int j = tid; j < H; j += WTHREADS) {
      const float b_r = ld(b_hh[d * G + j]), b_z = ld(b_hh[d * G + H + j]);
      const float b_n = ld(b_hh[d * G + 2 * H + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int n = row_s[r];
        float dr = 0.f, dz = 0.f, dn = 0.f, dhn = 0.f;
        float g = g_s[j * ROWS + r];
        if (t < len_s[r]) {
          float hg_r = b_r, hg_z = b_z, hg_n = b_n;
          if (tp >= 0 && tp < len_s[r]) {  // else h_prev = 0: hg = b
            const float* z = zbuf + ((size_t)n * L + tp) * xg_stride + d * G;  // the hg pass's Z
            hg_r = z[j] + b_r;
            hg_z = z[H + j] + b_z;
            hg_n = z[2 * H + j] + b_n;
          }
          const size_t at = (size_t)n * L + t;
          const T* x = xg + at * xg_stride + d * G;
          const float rg = sigmoid(ld(x[j]) + hg_r);
          const float z = sigmoid(ld(x[H + j]) + hg_z);
          const float nn = tanhf(ld(x[2 * H + j]) + rg * hg_n);
          const size_t o = at * y_stride + d * H + j;
          g += round_to<T>(ld(dy_sent[o]) + ld(dy_pos[o]));
          const float hp = hp_s[j * ROWS + r];
          dn = g * (1.f - z) * (1.f - nn * nn);
          dz = g * (hp - nn) * z * (1.f - z);
          dr = dn * hg_n * rg * (1.f - rg);
          dhn = dn * rg;
          g = g * z;  // ghh @ W^T is added below
        }
        if (n >= 0) store((size_t)n * L + t, j, dr, dz, dn, dhn);
        // ghh as the product's operand (bf16: rounded)
        gh_s[j * ROWS + r] = round_to<T>(dr);
        gh_s[(H + j) * ROWS + r] = round_to<T>(dz);
        gh_s[(2 * H + j) * ROWS + r] = round_to<T>(dhn);
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
        const float w = ld(__ldg(WT + (size_t)c * H + j));
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

// (b) up to H = 128, f32: the CUDA-core product, hg from the hg pass's Z
int launch_sweep(const float* xg, const float* y, const float* dy_sent, const float* dy_pos,
                 const int* lengths, const float* w_hh, const float* b_hh, const int* order,
                 float* dxg, float* zbuf, float* ghn, int N, int L, int H, dim3 grid,
                 cudaStream_t s) {
  const SweepShape sh = sweep_shape(H);
  auto kernel = bigru_backward_sweep<4, 1, float>;
  switch (sh.KS) {
    case 16: kernel = bigru_backward_sweep<8, 16, float>; break;
    case 8: kernel = bigru_backward_sweep<8, 8, float>; break;
    case 4: kernel = bigru_backward_sweep<8, 4, float>; break;
    case 2: kernel = bigru_backward_sweep<8, 2, float>; break;
    default: break;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, sh.threads, sh.smem, s>>>(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, order,
                                           dxg, zbuf, ghn, N, L, H, sh.BS, sh.GP);
  return 0;
}

// (b) up to H = 128, bf16: both products on mma.sync, hg in the sweep
int launch_sweep(const bf16* xg, const bf16* y, const bf16* dy_sent, const bf16* dy_pos,
                 const int* lengths, const bf16* w_hh, const bf16* b_hh, const int* order,
                 bf16* dxg, float* zbuf, float* ghn, int N, int L, int H, dim3 grid,
                 cudaStream_t s) {
  const Bf16Sweep b = bf16_sweep_shape(H);
  const auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const int pairs = H % 2 == 0 && ((bits(xg) | bits(y) | bits(dy_sent) | bits(dy_pos)) & 3) == 0;
  const int hp_piece = H % 8 == 0 && (bits(y) & 15) == 0 ? 8 : pairs ? 2 : 1;
  const int w_vec = H % 16 == 0 && (bits(w_hh) & 15) == 0;
  const int vec = H % 8 == 0 && ((bits(dxg) | bits(zbuf) | bits(ghn)) & 15) == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      bigru_backward_bf16_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_backward_bf16_sweep<<<grid, b.threads, b.smem, s>>>(xg, y, dy_sent, dy_pos, lengths,
                                                            w_hh, b_hh, order, dxg, zbuf, ghn, N,
                                                            L, H, pairs, hp_piece, w_vec, vec);
  return 0;
}

template <class T>
int run(const T* xg, const T* y, const T* dy_sent, const T* dy_pos, const int* lengths,
        const T* w_hh, const T* w_hh_t, const T* b_hh, T* dxg, float* zbuf, float* ghn,
        int* order, float* scratch, float* dw_part, float* db_part, float* dw, float* db, int N,
        int L, int H, int chunk_rows, void* stream) {
  if (H <= 0 || N < 0 || L < 0 || (long long)N * L > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = N * L;
  cudaError_t err;
  if (M > 0) {
    // (a) Z_d = y_d @ W_hh[d] into zbuf's direction halves, but where the
    // bf16 sweep computes hg itself
    if (!is_bf16<T> || H > SWEEP_MAX_H) {
      const int e = hg::launch(y, w_hh, zbuf, M, H, s);
      if (e != 0) return e;
    }
    // (b) the sweep, its rows longest first (row_order.cuh)
    const int o = row_order::launch(lengths, order, N, L, s);
    if (o != 0) return o;
    const dim3 grid((N + ROWS - 1) / ROWS, 2);
    if (H <= SWEEP_MAX_H) {
      const int e = launch_sweep(xg, y, dy_sent, dy_pos, lengths, w_hh, b_hh, order, dxg, zbuf,
                                 ghn, N, L, H, grid, s);
      if (e != 0) return e;
    } else {
      const bool shared = wide_state_bytes(H) <= SMEM_LIMIT;
      if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = shared ? wide_state_bytes(H) : 0;
      err = cudaFuncSetAttribute(bigru_backward_wide<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      bigru_backward_wide<T><<<grid, WTHREADS, smem, s>>>(xg, y, dy_sent, dy_pos, lengths,
                                                          w_hh_t, b_hh, order, dxg, zbuf, ghn,
                                                          shared ? nullptr : scratch, N, L, H);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // (c) dW_hh, db_hh over the rows' chunks, then their fixed-order sum
  return dw::launch(y, zbuf, ghn, dw_part, db_part, dw, db, M, L, H, chunk_rows, s);
}

}  // namespace

// xg (N, L, 6H), y (N, L, 2H), dy_sent and dy_pos (N, L, 2H) by address,
// lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H) -> dxg (N, L, 6H), dw
// (2, H, 3H) and db (2, 3H): contiguous, on the device, any H >= 1; f32
// (bigru_backward) or, but for dw and db (f32), bf16
// (bigru_backward_bf16).  Scratch: zbuf (N, L, 6H) f32, dxg itself for
// f32; ghn (N, L, 2H) f32; order (N,) int32; the partials dw_part (chunks,
// 2, H, 3H) and db_part (chunks, 2, 3H), chunks = ceil(N*L / chunk_rows)
// (1 when N*L = 0), chunk_rows a positive multiple of 32; past H = 128,
// w_hh_t = w_hh transposed (2, 3H, H) and scratch
// bigru_backward_scratch(N, H) floats (may be null where that is 0), else
// both unused.  Launches the hg pass, the row order, the sweep and the dW
// pass (two kernels) on `stream`; returns the first failure's
// cudaError_t.
extern "C" int bigru_backward(const float* xg, const float* y, const float* dy_sent,
                              const float* dy_pos, const int* lengths, const float* w_hh,
                              const float* w_hh_t, const float* b_hh, float* dxg, float* zbuf,
                              float* ghn, int* order, float* scratch, float* dw_part,
                              float* db_part, float* dw, float* db, int N, int L, int H,
                              int chunk_rows, void* stream) {
  return run(xg, y, dy_sent, dy_pos, lengths, w_hh, w_hh_t, b_hh, dxg, zbuf, ghn, order, scratch,
             dw_part, db_part, dw, db, N, L, H, chunk_rows, stream);
}

extern "C" int bigru_backward_bf16(const bf16* xg, const bf16* y, const bf16* dy_sent,
                                   const bf16* dy_pos, const int* lengths, const bf16* w_hh,
                                   const bf16* w_hh_t, const bf16* b_hh, bf16* dxg, float* zbuf,
                                   float* ghn, int* order, float* scratch, float* dw_part,
                                   float* db_part, float* dw, float* db, int N, int L, int H,
                                   int chunk_rows, void* stream) {
  return run(xg, y, dy_sent, dy_pos, lengths, w_hh, w_hh_t, b_hh, dxg, zbuf, ghn, order, scratch,
             dw_part, db_part, dw, db, N, L, H, chunk_rows, stream);
}

// floats of the scratch the wide sweep needs at (N, H): 0 up to H = 128
// (the shared-memory sweep) and where its state fits the shared memory
extern "C" long long bigru_backward_scratch(int N, int H) {
  if (H <= SWEEP_MAX_H || wide_state_bytes(H) <= SMEM_LIMIT) return 0;
  return (long long)((N + ROWS - 1) / ROWS) * 2 * 5 * H * ROWS;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
