// K3's hg pass: Z_d = y_d @ W_hh[d] for both directions over all N*L rows,
// 3xTF32 on the tensor cores (see tf32x3.cuh), built from K1's design
// (gru_input_proj.cu: persistent blocks of two warpgroups, W's column
// slice split once into shared memory, x tiles through a two-stage
// cp.async ring, A fragments split in registers, wgmma).  What differs:
//   - x is y_d: rows of H floats at stride 2H, copied row by row; Z goes
//     into dxg's direction half (row stride 6H); blockIdx.z is the
//     direction;
//   - 64 columns a block (wgmma n64; 3H = 192 is three tiles at H = 64);
//   - the big*big chain restarts every 2 k-steps and each piece is added
//     to an f32 sum: the tensor core's accumulation rounds more coarsely
//     than an f32 add, and K1's whole-depth chains, 13 k-steps at H = 100,
//     put 8.5e-5 into dxg on the card, past its 1e-5 gate.  The small cross
//     terms stay in one chain: their sum is 2^-11 of the product's;
//   - depth in chunks of at most KC = 128 (one launch each, in order, each
//     adding its product to Z in f32), so W's slice and the ring fit the
//     shared memory at any H.
// Each output element is computed by one thread in a fixed order, so the
// bits do not depend on the grid or on the run.

#pragma once

#include <algorithm>

#include "tf32x3.cuh"

namespace hg {

using namespace tf32x3;

constexpr int WG = 128;    // threads of a warpgroup
constexpr int WGS = 2;     // warpgroups per block, each walking its own row tiles
constexpr int BM = 64;     // rows of a warpgroup's tile
constexpr int BN = 64;     // columns of a block (wgmma n)
constexpr int WT = BN * 8;  // floats of one k-step's W tile (big or small)
constexpr int KC = 128;    // the depth of one launch

inline size_t smem_bytes(int K) {
  return ((size_t)(K + 7) / 8 * 2 * WT + (size_t)WGS * 2 * BM * K) * sizeof(float);
}

// the A fragment of k-step ks (columns 8 ks + tig, + 4) of rows p0, p8 of
// an x tile in shared memory, split; zeros past K
__device__ __forceinline__ void split_a(const float* p0, const float* p8, int ks, int K, int tig,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int k0 = ks * 8 + tig, k1 = k0 + 4;
  const bool v0 = k0 < K, v1 = k1 < K;
  split(v0 ? p0[k0] : 0.f, ah[0], al[0]);
  split(v0 ? p8[k0] : 0.f, ah[1], al[1]);
  split(v1 ? p0[k1] : 0.f, ah[2], al[2]);
  split(v1 ? p8[k1] : 0.f, ah[3], al[3]);
}

// out[m][n] (+)= sum_k x[m][k] w[k][n] over this launch's K (<= KC) of
// direction blockIdx.z: x at row stride lda (+ z * x_z), w (K, N) at row
// stride N (+ z * w_z), out at row stride ldo (+ z * out_z).  add: add to out (a later depth chunk).
// vec: 16-byte copies of x (x 16-byte aligned, K, lda and x_z multiples of
// 4); pairs: 8-byte stores of out (N, ldo and out_z even).
__global__ void __launch_bounds__(WG * WGS, 1)
bigru_backward_hg(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N, int lda, int ldo,
                  long long x_z, long long w_z, long long out_z, bool add, bool vec,
                  bool pairs) {
  extern __shared__ float4 smem4[];
  x += blockIdx.z * x_z;
  w += blockIdx.z * w_z;
  out += blockIdx.z * out_z;
  const int KS = (K + 7) / 8;
  float* wt = reinterpret_cast<float*>(smem4);  // [KS][big, small][WT]
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, gid = lane >> 2, tig = lane & 3;
  float* ring = wt + KS * 2 * WT + wg * 2 * BM * K;  // this warpgroup's [2][BM * K]
  const int col0 = blockIdx.x * BN;
  const int walkers = gridDim.y * WGS;
  const int m_tiles = (M + BM - 1) / BM;

  // a tile's rows of x into the ring (row stride K)
  auto copy_tile = [&](float* dst, int tile) {
    const float* src = x + (size_t)tile * BM * lda;
    const int rows = min(BM, M - tile * BM);
    if (vec) {
      const int k4 = K >> 2;
      for (int i = t; i < rows * k4; i += WG) {
        const int r = i / k4, c = 4 * (i % k4);
        cp_async16(dst + r * K + c, src + (size_t)r * lda + c);
      }
    } else {
      for (int i = t; i < rows * K; i += WG) {
        const int r = i / K, c = i % K;
        cp_async4(dst + r * K + c, src + (size_t)r * lda + c);
      }
    }
  };

  // the first x tile's copy goes out before W is read
  int tile = blockIdx.y * WGS + wg;
  if (tile < m_tiles) copy_tile(ring, tile);
  cp_async_commit();

  // W's column slice, split once into its big and small B tiles; zeros
  // past K and past N.  Lane (kq, nr) of item i: k = 8 ks + 4 kh + kq,
  // n = 8 ng + nr.
  for (int i = tid; i < KS * 2 * (BN / 8) * 32; i += WG * WGS) {
    const int l = i & 31, ng = (i >> 5) % (BN / 8), kh = (i >> 5) / (BN / 8) % 2;
    const int ks = (i >> 5) / (BN / 4);
    const int k = ks * 8 + kh * 4 + (l & 3), n = ng * 8 + (l >> 2);
    uint32_t big, small;
    split(k < K && col0 + n < N ? w[(size_t)k * N + col0 + n] : 0.f, big, small);
    float* tb = wt + ks * 2 * WT + b_offset(n, k & 7);
    tb[0] = __uint_as_float(big);
    tb[WT] = __uint_as_float(small);
  }
  fence_proxy_async();
  __syncthreads();

  const int r0 = warp * 16 + gid;  // this thread's rows of a tile: r0, r0 + 8
  for (int it = 0; tile < m_tiles; ++it, tile += walkers) {
    cp_async_wait<0>();  // this tile's copy has landed ...
    named_barrier(1 + wg, WG);  // ... for the warpgroup; it is done with the last tile
    const int next = tile + walkers;  // into the buffer the last tile used
    if (next < m_tiles) copy_tile(ring + ((it + 1) & 1) * BM * K, next);
    cp_async_commit();

    // rows past M hold stale values: they reach only their own outputs,
    // which are not stored
    const float* p0 = ring + (it & 1) * BM * K + r0 * K;
    const float* p8 = p0 + 8 * K;
    // hi: big*big of a pair of k-steps, added to sum in f32; lo: the two
    // small cross terms over the whole depth
    float hi[BN / 2], lo[BN / 2], sum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = lo[i] = 0.f;
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    auto issue = [&](int ks, const uint32_t(&ah)[4], const uint32_t(&al)[4]) {
      const float* tb = wt + ks * 2 * WT;
      wgmma_fence();
      Wgmma<BN>::run(lo, al, b_desc(tb), 1);
      Wgmma<BN>::run(hi, ah, b_desc(tb), ks & 1);
      Wgmma<BN>::run(lo, ah, b_desc(tb + WT), 1);
      wgmma_commit();
    };
    split_a(p0, p8, 0, K, tig, ah0, al0);
    for (int ks = 0; ks < KS; ks += 2) {
      issue(ks, ah0, al0);
      split_a(p0, p8, ks + 1, K, tig, ah1, al1);  // set 1's last step was waited for
      if (ks + 1 < KS) issue(ks + 1, ah1, al1);
      wgmma_wait<0>();  // the pair is done: hi holds its big*big, sets 0 and 1 are free
      fence_regs(hi);
      fence_regs(lo);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += hi[i];
      split_a(p0, p8, ks + 2, K, tig, ah0, al0);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * BM + r0 + 8 * h;
      if (r >= M) continue;
      float* row = out + (size_t)r * ldo + col0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + 2 * tig;
        float o0 = sum[4 * j + 2 * h] + lo[4 * j + 2 * h];
        float o1 = sum[4 * j + 2 * h + 1] + lo[4 * j + 2 * h + 1];
        if (pairs) {  // c even, so col0 + c < N implies col0 + c + 1 < N
          if (col0 + c < N) {
            float2* p = reinterpret_cast<float2*>(row + c);
            if (add) {
              const float2 v = *p;
              o0 = v.x + o0;
              o1 = v.y + o1;
            }
            *p = make_float2(o0, o1);
          }
        } else {
          if (col0 + c < N) row[c] = add ? row[c] + o0 : o0;
          if (col0 + c + 1 < N) row[c + 1] = add ? row[c + 1] + o1 : o1;
        }
      }
    }
  }
  cp_async_wait<0>();  // the last committed group is empty; leave none behind
}

// Z_d = y_d @ W_hh[d], d = 0, 1: y (M, 2H), w_hh (2, H, 3H), z in dxg's
// layout (M, 6H).  One launch per depth chunk of KC, on `stream`; returns
// the first failure's cudaError_t (0 = success).
inline int launch(const float* y, const float* w_hh, float* z, int M, int H,
                  cudaStream_t stream) {
  if (M == 0) return 0;
  const int G = 3 * H, K = std::min(H, KC);
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_backward_hg, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bigru_backward_hg, WG * WGS,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int col_tiles = (G + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  // blocks per column tile and direction; each walks WGS row tiles at once
  const int walkers = std::max(1, std::min((m_tiles + WGS - 1) / WGS,
                                           (std::max(per_sm, 1) * sms + 2 * col_tiles - 1) /
                                               (2 * col_tiles)));
  const bool vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const bool pairs = G % 2 == 0 && (reinterpret_cast<uintptr_t>(z) & 7) == 0;
  for (int k0 = 0; k0 < H; k0 += KC) {
    const int kc = std::min(KC, H - k0);
    bigru_backward_hg<<<dim3(col_tiles, walkers, 2), WG * WGS, smem, stream>>>(
        y + k0, w_hh + (size_t)k0 * G, z, M, kc, G, 2 * H, 6 * H, H, (long long)H * G, G,
        k0 > 0, vec && kc % 4 == 0, pairs);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace hg
