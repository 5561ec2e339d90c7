// K3's dW pass: dW_hh[d] (H, 3H) = sum_m h_prev[m]^T ghh[m] and db_hh[d]
// (3H) = sum_m ghh[m] over the N*L rows m = n L + t, ghh = [dr | dz | dn r]
// (dr, dz from dxg, dn r from ghn) and h_prev the row m - 1 (fwd) or m + 1
// (bwd) of y_d, zero at the direction's first step (t = 0 fwd, t = L - 1
// bwd), where the shifted row belongs to another sentence.  3xTF32 on the
// tensor cores (see tf32x3.cuh), then a fixed-order sum of the partials.
//
// Built from K4's design (gru_input_proj_bwd.cu, whose header says what
// bounds it): a fixed split of the rows into chunks (ops/gru_cuda.py
// bwd_chunks, a function of N*L alone); block (column tile of 3H, E tile
// of H + e_tiles * d, chunk) streams its chunk through a three-stage
// cp.async ring of 32-row stages, ghh's 128 columns as A (dW^T = ghh^T
// h_prev, two warpgroups of 64) and h_prev's 64 columns as the B tile,
// split once per stage; big*big and the cross terms in two wgmma chains
// over the chunk (capped at 1,216 rows, as K4's); db from the A fragments
// in f32 adds.  What differs: the rows come from two tensors and a
// shifted, masked third; both directions run in one grid; a warpgroup
// whose 64 rows of dW^T lie past 3H (the second half of 3H = 192's last
// tile) skips its products.  The reduce kernel sums the partials in chunk
// order.  No float atomics: the same bits on every run.  bf16 IO: y (and
// its stage tiles) is bf16, ghh stays the sweep's unrounded f32; the
// product rounds ghh to bf16 (the TPU kernel's dot of ghh.astype(bf16))
// and takes one TF32 wgmma a k-step, db sums the unrounded ghh.

#pragma once

#include <type_traits>

#include "tf32x3.cuh"

namespace dw {

using namespace tf32x3;

constexpr int THREADS = 256;  // 2 warpgroups
constexpr int BG = 128;       // columns of ghh (rows of dW^T) per block: 64 per warpgroup
constexpr int EW = 64;        // columns of h_prev per block (wgmma n: 64, or 56 for a last tile)
constexpr int STEP = 32;      // rows per stage (ops/gru_cuda.py PROJ_BWD_STEP)
constexpr int STAGES = 3;
constexpr int GS = BG + 8;    // ghh stage row stride, in floats
constexpr int XT = EW * 8;    // floats of one k-step's h_prev tile (big or small)
constexpr int XB = STEP / 8 * 2 * XT;  // floats of one stage's split h_prev
template <class T>
constexpr size_t SMEM =
    ((size_t)2 * XB + (size_t)STAGES * STEP * GS) * sizeof(float) + (size_t)STAGES * STEP * EW * sizeof(T);
constexpr int MAX_CHUNKS = 65535;  // grid z: 79.7 million rows at 1,216 a chunk

// Chunk blockIdx.z of direction d into its partials dw_part [chunk][d][H]
// [3H] and db_part [chunk][d][3H], this block's column tile (blockIdx.x)
// and E tile e_tile: N = 8 * (column groups of H), 64 or 56.  The
// partials' addresses are formed only at the end (live across the stages
// they would hold registers).
template <int N, class T>
__device__ __forceinline__ void reduce_chunk(const T* __restrict__ y,
                                             const float* __restrict__ dxg,
                                             const float* __restrict__ ghn,
                                             float* __restrict__ dw_part,
                                             float* __restrict__ db_part, int M, int L, int H,
                                             int rows_per_chunk, int d, int e_tile, bool vec_g,
                                             bool vec_y, float* smem) {
  constexpr int NG = N / 8;
  constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte copy of y
  const int G = 3 * H;
  y += d * H;        // row stride 2H
  dxg += d * G;      // row stride 6H: [dr | dz] in its first 2H columns
  ghn += d * H;      // row stride 2H
  const int shift = d == 0 ? -1 : 1;  // h_prev's row
  const int first = d == 0 ? 0 : L - 1;  // the step whose h_prev is 0
  float* xb = smem;                         // [2][STEP / 8][big, small][XT]
  float* gs = xb + 2 * XB;                  // [STAGES][STEP][GS]
  T* xs = reinterpret_cast<T*>(gs + STAGES * STEP * GS);  // [STAGES][STEP][EW]
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int g0 = blockIdx.x * BG;
  const int e0 = e_tile * EW;
  const int chunk = blockIdx.z;
  const bool active = g0 + wg * 64 < G;
  const int m_begin = min(M, chunk * rows_per_chunk);
  const int m_end = min(M, m_begin + rows_per_chunk);
  const int n_stages = (m_end - m_begin + STEP - 1) / STEP;
  // a stage's rows of ghh (this tile's BG columns), QG floats a copy (2H %
  // 4 == 0 when QG = 4: a group of 4 lies wholly in dxg's [dr | dz] or in
  // ghn), and of h_prev (EW columns), QY elements a copy (16 bytes, or
  // one element: 4-byte cp.async for f32, a plain copy for bf16)
  auto copy = [&](auto qg_, auto qy_, int s) {
    constexpr int QG = decltype(qg_)::value, QY = decltype(qy_)::value;
    const int m0 = m_begin + s * STEP, rows = min(STEP, m_end - m0);
    float* gd = gs + (s % STAGES) * STEP * GS;
    for (int i = tid; i < rows * (BG / QG); i += THREADS) {
      const int r = i / (BG / QG), c = QG * (i % (BG / QG)), gc = g0 + c;
      if (gc >= G) continue;
      const size_t m = (size_t)m0 + r;
      const float* src = gc < 2 * H ? dxg + m * 6 * H + gc : ghn + m * 2 * H + (gc - 2 * H);
      if (QG == 4)
        cp_async16(gd + r * GS + c, src);
      else
        cp_async4(gd + r * GS + c, src);
    }
    T* xd = xs + (s % STAGES) * STEP * EW;
    const int ew = min(EW, H - e0);
    for (int i = tid; i < rows * (EW / QY); i += THREADS) {
      const int r = i / (EW / QY), c = QY * (i % (EW / QY));
      const int p = m0 + r + shift;
      if (c >= ew || p < 0 || p >= M) continue;  // rows out of range are masked below
      const T* src = y + (size_t)p * 2 * H + e0 + c;
      if constexpr (QY > 1)
        cp_async16(xd + r * EW + c, src);
      else if constexpr (is_bf16<T>)
        xd[r * EW + c] = *src;
      else
        cp_async4(xd + r * EW + c, src);
    }
  };
  auto load = [&](int s) {
    using std::integral_constant;
    if (vec_y && vec_g)
      copy(integral_constant<int, 4>(), integral_constant<int, PER>(), s);
    else if (vec_g)
      copy(integral_constant<int, 4>(), integral_constant<int, 1>(), s);
    else
      copy(integral_constant<int, 1>(), integral_constant<int, 1>(), s);
  };

  // lo (the two small cross terms) and hi (big*big) over the whole chunk:
  // two chains the tensor core runs side by side, never waited for but to
  // reuse a register set or a buffer
  float lo[N / 2], hi[N / 2];
  if constexpr (is_bf16<T>) {  // no cross terms: lo stays 0
#pragma unroll
    for (int i = 0; i < N / 2; ++i) lo[i] = 0.f;
  }
  // db of this thread's rows g, g + 8 over its fragments' rows of ghh,
  // summed from the A fragments in plain f32 adds, in a fixed order
  float db_acc[2] = {0.f, 0.f};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();  // stage s has landed ...
    __syncthreads();  // ... for every thread's part; every thread is done with stage s - 1
    if (s + STAGES - 1 < n_stages) load(s + STAGES - 1);  // into stage s - 1's buffers
    cp_async_commit();

    const int m0 = m_begin + s * STEP;
    const int rows = min(STEP, m_end - m0);
    const float* gt = gs + (s % STAGES) * STEP * GS;
    // the stage rows m0 + k at the direction's first step: one modulo a stage
    uint32_t masked = 0;
    for (int k = (first - m0 % L + L) % L; k < STEP; k += L) masked |= 1u << k;
    // h_prev, the B operand both warpgroups share, split once into its big
    // and small tiles (two buffers: stage s - 1's may still be read); zeros
    // on rows past the chunk, masked rows and columns past H.  Item i: the
    // 4 stage rows 4 j .. 4 j + 3 of column n, one 16-byte store per part.
    float* xbs = xb + (s & 1) * XB;
    const T* xt = xs + (s % STAGES) * STEP * EW;
    for (int i = tid; i < STEP / 4 * N; i += THREADS) {
      const int n = i % N, j = i / N;
      const bool in = e0 + n < H;
      uint32_t big[4], small[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * j + r;
        split(in && k < rows && !(masked >> k & 1u) ? ld(xt[k * EW + n]) : 0.f, big[r], small[r]);
      }
      float* tb = xbs + (j >> 1) * 2 * XT + b_offset(n, (4 * j) & 7);
      *reinterpret_cast<uint4*>(tb) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(tb + XT) = make_uint4(small[0], small[1], small[2], small[3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (!active) continue;  // this warpgroup's 64 rows of dW^T lie past 3H

    // A = ghh^T: A[g][k] = ghh[k][g], this thread's rows g, g + 8; two
    // register sets, so that step ks + 1 is split while step ks runs
    const float* ga = gt + wg * 64 + warp * 16 + gid;
    auto split_a = [&](int ks, uint32_t(&ah)[4], uint32_t(&al)[4]) {
      const int k0 = ks * 8 + tig, k1 = k0 + 4;
      const bool v0 = k0 < rows, v1 = k1 < rows;
      const float a0 = v0 ? ga[k0 * GS] : 0.f, a1 = v0 ? ga[k0 * GS + 8] : 0.f;
      const float a2 = v1 ? ga[k1 * GS] : 0.f, a3 = v1 ? ga[k1 * GS + 8] : 0.f;
      db_acc[0] += a0;  // db of rows g, g + 8: this lane's k, in order
      db_acc[0] += a2;
      db_acc[1] += a1;
      db_acc[1] += a3;
      // the product's operand: bf16 rounds ghh, db keeps it unrounded
      split(round_to<T>(a0), ah[0], al[0]);
      split(round_to<T>(a1), ah[1], al[1]);
      split(round_to<T>(a2), ah[2], al[2]);
      split(round_to<T>(a3), ah[3], al[3]);
    };
    auto issue = [&](int ks, const uint32_t(&ah)[4], const uint32_t(&al)[4]) {
      const float* tb = xbs + ks * 2 * XT;
      const int add = s > 0 || ks > 0;
      wgmma_fence();
      if constexpr (!is_bf16<T>) Wgmma<N>::run(lo, al, b_desc(tb), add);
      Wgmma<N>::run(hi, ah, b_desc(tb), add);
      if constexpr (!is_bf16<T>) Wgmma<N>::run(lo, ah, b_desc(tb + XT), 1);
      wgmma_commit();
    };
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    wgmma_wait<1>();  // the last stage's step 2 is done with set 0
    split_a(0, ah0, al0);
#pragma unroll
    for (int ks = 0; ks < STEP / 8; ks += 2) {
      issue(ks, ah0, al0);
      wgmma_wait<1>();  // step ks - 1 is done with set 1
      split_a(ks + 1, ah1, al1);
      issue(ks + 1, ah1, al1);
      if (ks + 2 < STEP / 8) {
        wgmma_wait<1>();  // step ks is done with set 0
        split_a(ks + 2, ah0, al0);
      }
    }
    // the last steps stay in flight while the next stage is loaded and split
    // (its split pass writes the other h_prev buffer)
  }
  wgmma_wait<0>();
  fence_regs(lo);
  fence_regs(hi);
  float sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = active && n_stages > 0 ? lo[i] + hi[i] : 0.f;
  cp_async_wait<0>();

  // dW^T (g, e) -> dW [e][g]
  const size_t part = (size_t)chunk * 2 + d;
  float* dw = dw_part + part * H * G;
  float* db = db_part + part * G;
  const int g = g0 + wg * 64 + warp * 16 + gid;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int e = e0 + j * 8 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = g + 8 * (r >> 1), er = e + (r & 1);
      if (gr < G && er < H) dw[(size_t)er * G + gr] = sum[4 * j + r];
    }
  }
  // db: the four lanes of a row group hold the k residues 0-3 (+4) of
  // every step; a butterfly adds them in the same order in every lane
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = db_acc[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (e_tile == 0 && tig == 0 && g + 8 * h < G) db[g + 8 * h] = v;
  }
}

// vec_g: 16-byte copies of ghh (H % 4 == 0, dxg and ghn 16-byte
// aligned); vec_y: of y (16 bytes' elements divide H, y 16-byte aligned)
template <class T>
__global__ void __launch_bounds__(THREADS, 2)
bigru_backward_dw(const T* __restrict__ y, const float* __restrict__ dxg,
                  const float* __restrict__ ghn, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int M, int L, int H, int rows_per_chunk,
                  int e_tiles, bool vec_g, bool vec_y) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = blockIdx.y / e_tiles, e_tile = blockIdx.y % e_tiles;
  if (H - e_tile * EW > 56)
    reduce_chunk<64>(y, dxg, ghn, dw_part, db_part, M, L, H, rows_per_chunk, d, e_tile, vec_g,
                     vec_y, smem);
  else
    reduce_chunk<56>(y, dxg, ghn, dw_part, db_part, M, L, H, rows_per_chunk, d, e_tile, vec_g,
                     vec_y, smem);
}

// dw (n) = the sum over chunks of dw_part[c] (n floats each), db (G)
// likewise.  Four lanes share an entry: lane j sums the chunks j, j + 4,
// ... in order, and a butterfly adds the four sums as (s0 + s1) + (s2 +
// s3), a fixed order.  (K4's reduce kernel.)
constexpr int REDUCE_LANES = 4;

__global__ void __launch_bounds__(THREADS)
bigru_backward_reduce(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                      float* __restrict__ dw, float* __restrict__ db, int chunks, int EG,
                      int G) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int i = t / REDUCE_LANES, j = t % REDUCE_LANES;
  const float* src = dw_part + i;
  float* dst = dw + i;
  size_t stride = EG;
  if (i >= EG) src = db_part + (i - EG), dst = db + (i - EG), stride = G;
  float sum = 0.f;
  if (i < EG + G) {
#pragma unroll 8
    for (int c = j; c < chunks; c += REDUCE_LANES) sum += src[c * stride];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (i < EG + G && j == 0) *dst = sum;
}

// Both kernels on `stream`: y (M, 2H) in T, dxg (M, 6H), ghn (M, 2H) -> dw
// (2, H, 3H), db (2, 3H) through the partials dw_part (chunks, 2, H, 3H)
// and db_part (chunks, 2, 3H), chunks = ceil(M / rows_per_chunk) (1 when
// M = 0), rows_per_chunk a positive multiple of STEP.  Returns the first
// failure's cudaError_t (0 = success).
template <class T>
int launch(const T* y, const float* dxg, const float* ghn, float* dw_part, float* db_part,
           float* dw, float* db, int M, int L, int H, int rows_per_chunk, cudaStream_t s) {
  if (rows_per_chunk <= 0 || rows_per_chunk % STEP != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = M > 0 ? (M + rows_per_chunk - 1) / rows_per_chunk : 1;
  if (chunks > MAX_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bigru_backward_dw<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM<T>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 3 * H, e_tiles = (H + EW - 1) / EW;
  const bool vec_g = H % 4 == 0 && ((reinterpret_cast<uintptr_t>(dxg) |
                                     reinterpret_cast<uintptr_t>(ghn)) & 15) == 0;
  const bool vec_y = H % (16 / sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  bigru_backward_dw<T><<<dim3((G + BG - 1) / BG, 2 * e_tiles, chunks), THREADS, SMEM<T>, s>>>(
      y, dxg, ghn, dw_part, db_part, M, L, H, rows_per_chunk, e_tiles, vec_g, vec_y);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int EG = 2 * H * G, PG = 2 * G;
  const long long n = (long long)(EG + PG) * REDUCE_LANES;
  bigru_backward_reduce<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      dw_part, db_part, dw, db, chunks, EG, PG);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dw
