// K9 gru_input_proj_dx: the bi-GRU's input gradient.
//
//   dx (M, E) = dxg (M, 6H) @ W_ih^T,   W_ih = [W_ih_fwd | W_ih_bwd] (E, 6H)
//
// M = N*L sentence-row tokens in true time; dxg is K3's output (both
// directions' gate gradients side by side, zeros at invalid steps) and
// W_ih the packed projection of BiGRU.kernel_operands.  Both directions
// projected the same x, so one product over all 6H columns sums their
// contributions.  f32 in, f32 out, f32-accurate products (3xTF32, see
// tf32x3.cuh) with f32 accumulation.
//
// Replaces the emit_dxc=True branch of the TPU kernel B4,
// umpr_tpu/ops/gru_pallas.py _pallas_project_bwd / _proj_bwd_kernel
// (pallas_call at :394): dxc = dxg @ W^T over the stacked [x | x
// time-flipped | pad] stream, which the wrapper then un-flipped.  Here dxg
// and dx are in true time, so there is no flip and no 128-lane padding.
// It is a kernel of its own: K4 (gru_input_proj_bwd.cu), which takes the
// other half of B4, splits over rows to reduce dW_ih, while this product
// is row-parallel with nothing to reduce across blocks.
//
// What bounds it on an H100: at the UMPR-R shapes (M=51,200, 6H=384,
// E=50) it reads dxg (78.6 MB) and writes dx (10.2 MB): 26.5 us of HBM
// traffic at 3.35 TB/s.  The products, 2*M*6H*E = 1.97 GFLOP, would take
// 29 us on the CUDA cores at 67 TFLOP/s; as 3xTF32 on wgmma (n padded to
// 56) they are 6.6 GFLOP of TF32, 13 us at 495 TFLOP/s.  So it is K1's
// design transposed, bound by its dxg reads:
//   - persistent blocks, one per SM, of two warpgroups; block (c, j) keeps
//     column tile c of dx (E padded to n = 56 or 64, else tiles of 128)
//     and each warpgroup walks its own 64-row tiles (no grid cap on M);
//   - B is W_ih's slice, whose rows are K-major already (6H contiguous):
//     loaded once per block, split into TF32 big and small parts, as
//     wgmma's B tiles in shared memory (172 KB at 6H = 384, n = 56);
//   - A is dxg, loaded by its own thread straight from global memory, each
//     element once: the depth is taken in chunks of 16 columns (two
//     k-steps), a lane loads one float4 of a chunk per row (the quad's four
//     lanes read one row's 64 contiguous bytes), and k is permuted inside
//     the chunk to match (W's tiles likewise); 6 chunks are in flight
//     ahead of the one on the tensor core, the next tile's first ones
//     issued before this tile's stores (and the first tile's before W is
//     read);
//   - the depth (6H, any value: columns past it zeroed by selects) is a
//     loop over k-steps of 8, each three wgmma m64nNk8: the two small
//     cross terms into one f32 accumulator, big*big into another, so the
//     tensor core's coarse accumulation errs along each chain's own terms;
//   - the epilogue adds the two in f32 and stores 8-byte pairs.
// Where the W slice does not fit the shared memory (6H past 512 at E <= 56,
// 448 at E <= 64, 224 past that: gru_size 100 and 256 among them), a
// kernel on mma.sync reads its fragments of both operands from global
// memory (L2), any shape, each k-step's 3xTF32 sum added to its
// accumulator in f32.  Each output element is one thread's sum in a fixed
// order: the bits do not depend on the grid or on the run.
//
// bf16 IO (gru_input_proj_dx_bf16, --compute_dtype bfloat16): dxg, W_ih
// and dx bf16, with the TPU kernel's three rounding points
// (gru_pallas.py:366-368, :822-826, :842; the wide route's :893-897
// rounds alike): each direction's product dxg_d @ W_d^T, summed in f32
// over its own 3H columns, is rounded to bf16; the two are added in bf16
// (one rounding).  So one f32 accumulator per direction, not one over all
// 6H.  At the UMPR-R shapes it reads 39.3 MB (dxg) and writes 5.1 MB: 13.3
// us at 3.35 TB/s, against 2.0 GFLOP of bf16 products (2 us at 989
// TFLOP/s).  So the kernel exists to keep dxg's stream in flight
// (gru_input_proj_dx_bf16_wgmma):
//   - persistent blocks, one per SM, of three warpgroups (two left dxg's
//     reads too little in flight: 0.0302 ms against 0.0284 at the UMPR-R
//     shape, 0.2171 against 0.1701 at E = 300 on an H100, chip_smoke.py
//     --steps),
//     each walking its own 64-row tiles, as few blocks as give every
//     warpgroup the same number of tiles; block (c, j) keeps dx's column
//     tile c (E padded to n = 56 or 64, column tiles of 64 past E = 64);
//   - W_ih's slice resident as wgmma's K-major B tiles, one set per
//     direction, each direction's k from 0 (zeros past 3H, so a k16 step
//     never mixes the directions, at any H): the rows of w (E, 6H) are
//     K-major already, so each 16-byte piece of a tile is a cp.async of
//     one row's 8 k (4-byte pieces where 6H % 8 != 0, 2-byte loads at
//     odd H); 43 KB at 6H = 384, n = 56;
//   - dxg's rows through a 3-stage cp.async ring per warpgroup (two
//     chunks in flight), a chunk 64 rows x 64 columns of one direction,
//     copied in the largest unit the row starts allow (16 bytes where H %
//     8 == 0, at odd H 4-byte pieces from each row's aligned start,
//     copy_rows in wgmma_bf16.cuh), rows 144 bytes apart in shared memory;
//   - A by ldmatrix.x4 (2-byte halves at odd H), columns past 3H zeroed by
//     selects; wgmma m64n56k16 or m64n64k16 into that direction's f32
//     accumulator, a chunk's four k16 steps issued as one group with no
//     branch among them (a wgmma in a branch makes ptxas serialise them
//     all: 0.0304 ms on an H100);
//   - the epilogue rounds each accumulator, adds the two and rounds, and
//     stages the tile: where one column tile covers E its rows are one
//     contiguous span of dx (64 E bf16 at a 16-byte aligned offset),
//     written as 16-byte stores; else 16-byte row pieces where E % 8 ==
//     0, 2-byte stores otherwise.
// Where W's slice and the rings do not fit the shared memory (3H past 544
// at E <= 56, 464 past it), an mma.sync kernel (m16n8k16): blocks of 8
// warps, each warp 16 rows x 64 columns for both directions (two
// accumulators of 8 n8 groups), a 128-row tile per block, walked
// grid-stride; W's fragments for the block's 64 columns laid out once in
// shared memory in the order the lanes read them, or read from global
// memory (L2) past 3H = 896; dxg's fragments 4-byte pairs straight from
// global memory, one k-step loaded ahead.  Each output is one thread's
// sum in a fixed order in every kernel: the same bits on every run.

#include <algorithm>

#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace tf32x3;
using wgmma_bf16::mma_bf16;

constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on Hopper (227 KB)

constexpr int WG = 128;  // threads of a warpgroup
constexpr int WGS = 2;   // warpgroups per block, each walking its own row tiles
constexpr int BM = 64;   // rows of a warpgroup's tile
constexpr int PFC_NARROW = 6;  // 16-column chunks of dxg loaded ahead (n <= 64)
constexpr int PFC_WIDE = 4;    // the same at n = 128 (fewer free registers)

// W's split slice: two k-steps per 16-column chunk of the depth
size_t wide_smem(int G, int bn) { return (size_t)(G + 15) / 16 * 2 * 2 * bn * 8 * sizeof(float); }

// The depth is taken in chunks of 16 columns, each two k-steps.  A thread
// loads one float4 of a chunk per row (columns 16 c + 4 tig .. + 3), so k
// is permuted within the chunk: slot kk (0..7) of step s reads column
// 16 c + 4 (kk % 4) + 2 s + kk / 4, and W's B tiles are laid out the same.

// row p's float4 of chunk c for lane tig; zeros past G
__device__ __forceinline__ float4 load_chunk(const float* p, int c, int G, int tig, bool vec) {
  const int k = c * 16 + 4 * tig;
  if (vec && k < G) return __ldcs(reinterpret_cast<const float4*>(p + k));
  return make_float4(k < G ? __ldcs(p + k) : 0.f, k + 1 < G ? __ldcs(p + k + 1) : 0.f,
                     k + 2 < G ? __ldcs(p + k + 2) : 0.f, k + 3 < G ? __ldcs(p + k + 3) : 0.f);
}

__device__ __forceinline__ void split4(float a, float b, float c, float d, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(a, ah[0], al[0]);
  split(b, ah[1], al[1]);
  split(c, ah[2], al[2]);
  split(d, ah[3], al[3]);
}

template <int BN>
__global__ void __launch_bounds__(WG * WGS, 1)
gru_input_proj_dx_wgmma(const float* __restrict__ dxg, const float* __restrict__ w,
                        float* __restrict__ dx, int M, int G, int E, bool vec) {
  constexpr int WT = BN * 8;  // floats of one k-step's W tile (big or small)
  extern __shared__ float4 smem4[];
  const int NC = (G + 15) / 16;  // chunks of the depth
  float* wt = reinterpret_cast<float*>(smem4);  // [2 NC][big, small][WT]
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, gid = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * BN;
  const int walkers = gridDim.y * WGS;
  const int m_tiles = (M + BM - 1) / BM;

  constexpr int PFC = BN <= 64 ? PFC_NARROW : PFC_WIDE;
  const int r0 = warp * 16 + gid;  // this thread's rows of a tile: r0, r0 + 8
  // rows past M read row M - 1: their outputs are not stored
  auto rows = [&](int tile, const float*& p0, const float*& p8) {
    p0 = dxg + (size_t)min(tile * BM + r0, M - 1) * G;
    p8 = dxg + (size_t)min(tile * BM + r0 + 8, M - 1) * G;
  };
  // the first tile's first chunks go out before W is read
  int tile = blockIdx.y * WGS + wg;
  const float *p0, *p8;
  rows(min(tile, m_tiles - 1), p0, p8);
  float4 v0[PFC], v8[PFC];
#pragma unroll
  for (int u = 0; u < PFC; ++u) {
    v0[u] = load_chunk(p0, u, G, tig, vec);
    v8[u] = load_chunk(p8, u, G, tig, vec);
  }

  // W's slice, split once: B element (n, slot kk) of step ks = W_ih[col0 +
  // n][the permuted column of (ks, kk)]; zeros past G and past E.  Item i reads
  // the float4 m of chunk c of row n (neighbouring threads, neighbouring
  // float4s of a row), whose element j goes to step 2 c + j / 2, slot m +
  // 4 (j % 2); WB of them in flight per thread.
  const bool vec_w = vec && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  constexpr int WB = 8;  // float4s of W in flight per thread
  const int items = BN * NC * 4;
  for (int base = tid; base < items; base += WB * WG * WGS) {
    float4 wv[WB];
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int i = base + u * WG * WGS;
      const int m = i % 4, c = i / 4 % NC, n = i / (4 * NC);
      const int k = c * 16 + 4 * m;
      const float* src = w + (size_t)(col0 + n) * G + k;
      wv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < items && col0 + n < E) {
        if (vec_w && k < G) {
          wv[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          wv[u].x = k < G ? src[0] : 0.f;
          wv[u].y = k + 1 < G ? src[1] : 0.f;
          wv[u].z = k + 2 < G ? src[2] : 0.f;
          wv[u].w = k + 3 < G ? src[3] : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int i = base + u * WG * WGS;
      if (i >= items) continue;
      const int m = i % 4, c = i / 4 % NC, n = i / (4 * NC);
      const float e4[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t big, small;
        split(e4[j], big, small);
        float* tb = wt + (2 * c + j / 2) * 2 * WT + b_offset(n, m + 4 * (j % 2));
        tb[0] = __uint_as_float(big);
        tb[WT] = __uint_as_float(small);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();

  for (; tile < m_tiles; tile += walkers) {
    rows(tile, p0, p8);
    // hi sums big*big, lo the two small cross terms
    float hi[BN / 2], lo[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hi[i] = lo[i] = 0.f;
    fence_regs(hi);  // the zeros stay before the first fence
    fence_regs(lo);
    // two A register sets, one per chunk (its two k-steps): a set is
    // rewritten only once the chunk that read it is done (wgmma_wait<1>
    // after the next chunk is issued); one fence per chunk
    uint32_t ah[2][2][4], al[2][2][4];
    for (int c0 = 0; c0 < NC; c0 += PFC) {
#pragma unroll
      for (int u = 0; u < PFC; ++u) {
        const int c = c0 + u, set = u & 1;  // PFC is even: c0 + u has u's parity
        if (c < NC) {
          split4(v0[u].x, v8[u].x, v0[u].y, v8[u].y, ah[set][0], al[set][0]);
          split4(v0[u].z, v8[u].z, v0[u].w, v8[u].w, ah[set][1], al[set][1]);
          v0[u] = load_chunk(p0, c + PFC, G, tig, vec);
          v8[u] = load_chunk(p8, c + PFC, G, tig, vec);
          wgmma_fence();
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            const float* tb = wt + (2 * c + st) * 2 * WT;
            Wgmma<BN>::run(lo, al[set][st], b_desc(tb), 1);
            Wgmma<BN>::run(hi, ah[set][st], b_desc(tb), 1);
            Wgmma<BN>::run(lo, ah[set][st], b_desc(tb + WT), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(hi);
    fence_regs(lo);
    // the next tile's first chunks go out before this one's stores
    const float *n0, *n8;
    rows(min(tile + walkers, m_tiles - 1), n0, n8);
#pragma unroll
    for (int u = 0; u < PFC; ++u) {
      v0[u] = load_chunk(n0, u, G, tig, vec);
      v8[u] = load_chunk(n8, u, G, tig, vec);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * BM + r0 + 8 * h;
      if (r >= M) continue;
      float* row = dx + (size_t)r * E + col0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + 2 * tig;
        const float o0 = hi[4 * j + 2 * h] + lo[4 * j + 2 * h];
        const float o1 = hi[4 * j + 2 * h + 1] + lo[4 * j + 2 * h + 1];
        if ((E & 1) == 0) {  // c even, so col0 + c < E implies col0 + c + 1 < E
          if (col0 + c < E) *reinterpret_cast<float2*>(row + c) = make_float2(o0, o1);
        } else {
          if (col0 + c < E) row[c] = o0;
          if (col0 + c + 1 < E) row[c + 1] = o1;
        }
      }
    }
  }
}

// ---- the deep kernel (any shape): fragments of both operands straight
// from global memory (L2), mma.sync 3xTF32, 64 x 64 tiles, 4 x 2 warps of
// 16 rows x 32 columns

constexpr int THREADS = 256;
constexpr int DBM = 64, DBN = 64;

__global__ void __launch_bounds__(THREADS)
gru_input_proj_dx_deep(const float* __restrict__ dxg, const float* __restrict__ w,
                       float* __restrict__ dx, int M, int G, int E, bool) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * DBN + wn * 32;  // this warp's 4 column groups of 8
  const int m_tiles = (M + DBM - 1) / DBM;
  for (int tile = blockIdx.y; tile < m_tiles; tile += gridDim.y) {
    const int r0 = tile * DBM + wm * 16 + gid, r8 = r0 + 8;
    // rows past M read row 0: their outputs are not stored
    const float* p0 = dxg + (size_t)(r0 < M ? r0 : 0) * G;
    const float* p8 = dxg + (size_t)(r8 < M ? r8 : 0) * G;
    float acc[4][4] = {};
    for (int ks = 0; ks < (G + 7) / 8; ++ks) {
      const int k0 = ks * 8 + tig, k1 = k0 + 4;
      const bool v0 = k0 < G, v1 = k1 < G;
      uint32_t ah[4], al[4];
      split(v0 ? p0[k0] : 0.f, ah[0], al[0]);
      split(v0 ? p8[k0] : 0.f, ah[1], al[1]);
      split(v1 ? p0[k1] : 0.f, ah[2], al[2]);
      split(v1 ? p8[k1] : 0.f, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 8 * j + gid;  // B (k, n) = W_ih[n][k]
        uint32_t b0h, b0l, b1h, b1l;
        split(n < E && v0 ? w[(size_t)n * G + k0] : 0.f, b0h, b0l);
        split(n < E && v1 ? w[(size_t)n * G + k1] : 0.f, b1h, b1l);
        mma3_add(acc[j], ah, al, b0h, b1h, b0l, b1l);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r8 : r0;
        if (r >= M) continue;
        if (c < E) dx[(size_t)r * E + c] = acc[j][2 * h];
        if (c + 1 < E) dx[(size_t)r * E + c + 1] = acc[j][2 * h + 1];
      }
    }
  }
}

template <class Kernel>
int launch(Kernel kernel, int threads, size_t smem, int bm, int bn, int per_block,
           const float* dxg, const float* w, float* dx, int M, int G, int E,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int col_tiles = (E + bn - 1) / bn;
  const int m_tiles = (M + bm - 1) / bm;
  const int resident = std::max(per_sm, 1) * sms;
  // blocks per column tile; each block walks `per_block` row tiles at once
  const int walkers = std::max(1, std::min((m_tiles + per_block - 1) / per_block,
                                           (resident + col_tiles - 1) / col_tiles));
  // float4 loads of dxg's rows: G a multiple of 4 and dxg 16-byte aligned
  const bool vec = G % 4 == 0 && (reinterpret_cast<uintptr_t>(dxg) & 15) == 0;
  kernel<<<dim3(col_tiles, walkers), threads, smem, stream>>>(dxg, w, dx, M, G, E, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 IO: bf16 mma.sync, one f32 accumulator per direction (bf16 is
// tf32x3.cuh's alias of __nv_bfloat16)

constexpr int B16_WARPS = 8;             // warps per block, each 16 rows
constexpr int B16_BM = 16 * B16_WARPS;   // rows of a block's tile
constexpr int B16_NG = 8;                // n8 column groups per block: 64 columns
constexpr int B16_BN = 8 * B16_NG;

// shared memory of W's fragments: 2 directions x KS k-steps x NG groups x
// 32 lanes x 8 bytes
size_t bf16_smem(int K3) { return (size_t)2 * ((K3 + 15) / 16) * B16_NG * 32 * 8; }

// two bf16 at p[k], p[k + 1] as one 32-bit register (p[k] in the low
// half), zeros past K; one 4-byte load when `pair` (p + k 4-byte aligned
// for every even k, K even)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int k, int K, bool pair) {
  if (pair) return k < K ? *reinterpret_cast<const uint32_t*>(p + k) : 0u;
  const uint32_t lo = k < K ? __bfloat16_as_ushort(p[k]) : 0u;
  const uint32_t hi = k + 1 < K ? __bfloat16_as_ushort(p[k + 1]) : 0u;
  return lo | hi << 16;
}

// lane's B fragment of (direction d, k-step ks, group j): W_ih[n][3H d + k]
// for n = col0 + 8 j + g and k = 16 ks + 2t (+1, +8, +9)
__device__ __forceinline__ uint2 w_frag(const bf16* w, int G, int K3, int E, int col0, int d,
                                        int ks, int j, int lane, bool pair) {
  const int n = col0 + 8 * j + (lane >> 2);
  const int k0 = ks * 16 + 2 * (lane & 3);
  if (n >= E) return make_uint2(0u, 0u);
  const bf16* row = w + (size_t)n * G + (size_t)K3 * d;
  return make_uint2(ld_pair(row, k0, K3, pair), ld_pair(row, k0 + 8, K3, pair));
}

template <bool SMEM>
__global__ void __launch_bounds__(32 * B16_WARPS)
gru_input_proj_dx_bf16_mma(const bf16* __restrict__ dxg, const bf16* __restrict__ w,
                           bf16* __restrict__ dx, int M, int G, int E, bool pair) {
  extern __shared__ uint2 wf[];  // [d][ks][j][lane]
  const int K3 = G / 2, KS = (K3 + 15) / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * B16_BN;
  const int groups = min(B16_NG, (E - col0 + 7) / 8);  // n8 groups with a column < E
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < 2 * KS * B16_NG * 32; i += blockDim.x) {
      const int l = i & 31, j = (i >> 5) % B16_NG, ks = (i >> 5) / B16_NG % KS;
      const int d = (i >> 5) / B16_NG / KS;
      wf[i] = w_frag(w, G, K3, E, col0, d, ks, j, l, pair);
    }
    __syncthreads();
  }
  const int m_tiles = (M + B16_BM - 1) / B16_BM;
  for (int tile = blockIdx.y; tile < m_tiles; tile += gridDim.y) {
    const int r0 = tile * B16_BM + warp * 16 + gid, r8 = r0 + 8;
    // rows past M read row M - 1: their outputs are not stored
    const bf16* p0 = dxg + (size_t)min(r0, M - 1) * G;
    const bf16* p8 = dxg + (size_t)min(r8, M - 1) * G;
    float acc[2][B16_NG][4] = {};
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const bf16* q0 = p0 + (size_t)K3 * d;
      const bf16* q8 = p8 + (size_t)K3 * d;
      auto load_a = [&](int ks, uint32_t (&a)[4]) {
        const int k = ks * 16 + 2 * tig;
        a[0] = ld_pair(q0, k, K3, pair);
        a[1] = ld_pair(q8, k, K3, pair);
        a[2] = ld_pair(q0, k + 8, K3, pair);
        a[3] = ld_pair(q8, k + 8, K3, pair);
      };
      uint32_t a[4], next[4];
      load_a(0, a);
      for (int ks = 0; ks < KS; ++ks) {
        if (ks + 1 < KS) load_a(ks + 1, next);  // one k-step ahead
#pragma unroll
        for (int j = 0; j < B16_NG; ++j) {
          if (j < groups) {
            const uint2 b = SMEM ? wf[((d * KS + ks) * B16_NG + j) * 32 + lane]
                                 : w_frag(w, G, K3, E, col0, d, ks, j, lane, pair);
            mma_bf16(acc[d][j], a, b.x, b.y);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = next[u];
      }
    }
    // each direction's sum rounded to bf16, then the bf16 add (one rounding)
#pragma unroll
    for (int j = 0; j < B16_NG; ++j) {
      const int c = col0 + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r8 : r0;
        if (r >= M || c >= E) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = __bfloat162float(__float2bfloat16_rn(acc[0][j][2 * h + e])) +
                 __bfloat162float(__float2bfloat16_rn(acc[1][j][2 * h + e]));
        bf16* out = dx + (size_t)r * E + c;
        if ((E & 1) == 0) {  // c even, so c < E implies c + 1 < E
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(o[0], o[1]);
        } else {
          out[0] = __float2bfloat16_rn(o[0]);
          if (c + 1 < E) out[1] = __float2bfloat16_rn(o[1]);
        }
      }
    }
  }
}

// ---- bf16 IO on native bf16 wgmma (see the header): W's slice resident,
// dxg's rows streamed in chunks of one direction's columns

constexpr int D_KC = 64;               // dxg columns a chunk: 4 k16 steps of one direction
constexpr int D_KSC = D_KC / 16;
constexpr int D_XS = D_KC + 8;         // a chunk's row stride in shared memory (144 bytes)
constexpr int D_STAGES = 3;            // chunks in a warpgroup's ring: two in flight
constexpr int D_WGS = 3;               // warpgroups a block, each walking its own row tiles

// W's tiles (2 directions x KS3 k16 steps x BN columns x 16 k), both
// warpgroups' rings and staging tiles (64 rows of BN + 8)
size_t wgmma_smem(int bn, int K3) {
  return ((size_t)2 * ((K3 + 15) / 16) * bn * 16 +
          (size_t)D_WGS * (D_STAGES * BM * D_XS + BM * (bn + 8))) * sizeof(bf16);
}

template <int BN, int U>
__global__ void __launch_bounds__(WG * D_WGS, 1)
gru_input_proj_dx_bf16_wgmma(const bf16* __restrict__ dxg, const bf16* __restrict__ w,
                             bf16* __restrict__ dx, int M, int G, int E, int wu) {
  using namespace wgmma_bf16;
  constexpr int WT = BN * 16;  // bf16 of one k16 step's W tile
  extern __shared__ float4 smem4[];
  const int K3 = G / 2, KS3 = (K3 + 15) / 16, NC3 = (K3 + D_KC - 1) / D_KC;
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, tig = lane & 3;
  bf16* wt = reinterpret_cast<bf16*>(smem4);  // [2][KS3][WT]
  bf16* ring = wt + 2 * KS3 * WT + wg * D_STAGES * BM * D_XS;  // [D_STAGES][BM][D_XS]
  bf16* stage = wt + 2 * KS3 * WT + D_WGS * D_STAGES * BM * D_XS + wg * BM * (BN + 8);
  const int col0 = blockIdx.x * BN;
  const int walkers = gridDim.y * D_WGS;
  const int m_tiles = (M + BM - 1) / BM;
  const int first = blockIdx.y * D_WGS + wg;

  // chunk g of this warpgroup's walk: chunk g % NC3 of direction g / NC3 %
  // 2's columns of row tile first + g / (2 NC3) walkers, into ring stage g
  // % D_STAGES; one commit group a chunk, empty past the last tile
  auto fetch = [&](int g) {
    const int tile = first + g / (2 * NC3) * walkers, d = g / NC3 % 2, c = g % NC3;
    if (tile < m_tiles)
      copy_rows<U, D_KC>(ring + g % D_STAGES * BM * D_XS, D_XS,
                         dxg + (size_t)tile * BM * G + d * K3 + c * D_KC, G,
                         min(BM, M - tile * BM), min(D_KC, K3 - c * D_KC), t, WG);
    cp_async_commit();
  };
  // the first chunks go out before W is read
  for (int g = 0; g < D_STAGES - 1; ++g) fetch(g);

  // W's slice: B (k, n) of direction d = w[col0 + n][3H d + k], whose rows
  // are K-major already.  Item i is n's 8 k of one k half of one k16 step:
  // one 16-byte piece of the tile, copied whole (wu = 16: w, G and 3H
  // 16-byte aligned) or as 4-byte copies (wu = 4), else 2-byte loads;
  // zeros past 3H and past E.
  for (int i = tid; i < 2 * KS3 * BN * 2; i += WG * D_WGS) {
    const int h = i & 1, n = (i >> 1) % BN, ds = (i >> 1) / BN;  // ds = d KS3 + s
    const int d = ds / KS3, k0 = ds % KS3 * 16 + 8 * h;
    bf16* dst = wt + ds * WT + tile_offset(n, 8 * h);
    const bf16* src = w + (size_t)(col0 + n) * G + d * K3 + k0;
    const int valid = col0 + n < E ? max(0, min(8, K3 - k0)) : 0;  // k of the piece inside 3H
    if (wu == 16) {
      cp_async_zfill<16>(dst, valid ? src : w, 2 * valid);
    } else if (wu == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async_zfill<4>(dst + 2 * q, 2 * q < valid ? src + 2 * q : w,
                          max(0, min(4, 2 * (valid - 2 * q))));
    } else {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = pack(2 * q < valid ? bits(src[2 * q]) : 0u,
                    2 * q + 1 < valid ? bits(src[2 * q + 1]) : 0u);
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();  // W's pieces (and the first chunks) have landed ...
  fence_proxy_async();  // ... for wgmma
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows of a tile: r0, r0 + 8
  int g = 0;                               // the next chunk to take from the ring
  for (int tile = first; tile < m_tiles; tile += walkers) {
    // rows past M hold stale values: they reach only their own outputs,
    // which are not stored
    const uintptr_t row0 = (reinterpret_cast<uintptr_t>(dxg) >> 1) + (size_t)(tile * BM + r0) * G;
    float acc0[BN / 2], acc1[BN / 2];
    // one direction's product: KS3 k16 steps over its 3H columns into acc
    auto direction = [&](auto& acc, int d) {
      const int sh0 = U == 2 ? (int)((row0 + d * K3) & 1) : 0;
      const int sh8 = U == 2 ? (int)((row0 + 8 * (size_t)G + d * K3) & 1) : 0;
      // one wgmma group a chunk, issued whole: steps past 3H read A's
      // zeros (the selects past 3H) against the direction's last W tile,
      // so no wgmma sits in a branch (ptxas serialises those); the A
      // registers are rewritten only once the group before is done, while
      // its products run beside this chunk's wait, barrier and copies
      uint32_t a[D_KSC][4];
      for (int c = 0; c < NC3; ++c) {
        cp_async_wait<D_STAGES - 2>();  // chunk g has landed ...
        named_barrier(1 + wg, WG);      // ... for the warpgroup, which has read chunk g - 1
        fetch(g + D_STAGES - 1);        // into chunk g - 1's stage
        const bf16* chunk = ring + g % D_STAGES * BM * D_XS;
        ++g;
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < D_KSC; ++j)
          chunk_a<U>(a[j], chunk, D_XS, 16 * j, K3 - c * D_KC, warp, lane, sh0, sh8);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < D_KSC; ++j)
          WgmmaBf16<BN>::run(acc, a[j], desc(wt + (d * KS3 + min(c * D_KSC + j, KS3 - 1)) * WT),
                             c * D_KSC + j > 0);
        wgmma_commit();
      }
    };
    direction(acc0, 0);
    direction(acc1, 1);
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    // each direction's sum rounded to bf16, then the bf16 add (one
    // rounding), into the staging tile: the whole 64 x E tile, row stride
    // E, where one column tile covers E (its rows are then one contiguous
    // span of dx), else 64 x BN at row stride BN + 8
    const int ew = min(BN, E - col0);  // columns of this tile
    const int ss = gridDim.x == 1 ? E : BN + 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float o0 = round_to<bf16>(acc0[i]) + round_to<bf16>(acc1[i]);
        const float o1 = round_to<bf16>(acc0[i + 1]) + round_to<bf16>(acc1[i + 1]);
        bf16* p = stage + (r0 + 8 * h) * ss + c;
        if (c + 1 < ew && ss % 2 == 0) {
          *reinterpret_cast<uint32_t*>(p) = round_pair(o0, o1);
        } else {
          if (c < ew) p[0] = __float2bfloat16_rn(o0);
          if (c + 1 < ew) p[1] = __float2bfloat16_rn(o1);
        }
      }
    }
    named_barrier(1 + wg, WG);  // the tile is staged
    const int rows = min(BM, M - tile * BM);
    const bool a16 = (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
    if (gridDim.x == 1) {
      // rows * E contiguous bf16 from dx + 64 tile E (a 16-byte aligned
      // offset): 16-byte stores, the tail 2 bytes at a time
      bf16* dst = dx + (size_t)tile * BM * E;
      const int n = rows * E, nv = a16 ? n / 8 : 0;
      for (int i = t; i < nv; i += WG)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(stage)[i];
      for (int i = 8 * nv + t; i < n; i += WG) dst[i] = stage[i];
    } else {
      bf16* dst = dx + (size_t)tile * BM * E + col0;
      if (a16 && E % 8 == 0) {  // 16-byte row pieces (col0 and ew multiples of 8)
        for (int i = t; i < rows * (BN / 8); i += WG) {
          const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
          if (c < ew)
            *reinterpret_cast<uint4*>(dst + (size_t)r * E + c) =
                *reinterpret_cast<const uint4*>(stage + r * ss + c);
        }
      } else {
        for (int i = t; i < rows * BN; i += WG) {
          const int r = i / BN, c = i % BN;
          if (c < ew) dst[(size_t)r * E + c] = stage[r * ss + c];
        }
      }
    }
  }
  cp_async_wait<0>();  // the groups left are empty; leave none behind
}

// the largest unit (16, 8, 4 bytes; 2: none) that a pointer p and the
// byte offsets `off` are all aligned to
int unit(const void* p, uintptr_t off) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | off;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

template <int BN, int U>
int launch_wgmma(const bf16* dxg, const bf16* w, bf16* dx, int M, int G, int E,
                 cudaStream_t stream) {
  const auto kernel = gru_input_proj_dx_bf16_wgmma<BN, U>;
  const size_t smem = wgmma_smem(BN, G / 2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG * D_WGS, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int col_tiles = (E + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  // blocks per column tile, each walking two row tiles at once
  // blocks per column tile, each walking two row tiles at once, as few as
  // give every warpgroup the same number of tiles (no wave of stragglers)
  const int per_col = std::max(1, (std::max(per_sm, 1) * sms + col_tiles - 1) / col_tiles);
  const int each = (m_tiles + per_col * D_WGS - 1) / (per_col * D_WGS);
  const int walkers = std::max(1, (m_tiles + each * D_WGS - 1) / (each * D_WGS));
  // W's 16-byte pieces: w, its rows (2G bytes) and the bwd half (6H bytes)
  // 16-byte aligned; 4-byte copies where they are 4-byte aligned
  const int wu = unit(w, (uintptr_t)(2 * G) | (uintptr_t)G);
  kernel<<<dim3(col_tiles, walkers), WG * D_WGS, smem, stream>>>(dxg, w, dx, M, G, E,
                                                                wu == 8 ? 4 : wu);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int run_wgmma(const bf16* dxg, const bf16* w, bf16* dx, int M, int G, int E, cudaStream_t s) {
  // dxg's chunk row starts: its address, its rows (2G bytes), the bwd
  // half's offset (6H = G bytes) and the chunk offsets (128 bytes)
  switch (unit(dxg, (uintptr_t)(2 * G) | (uintptr_t)G)) {
    case 16: return launch_wgmma<BN, 16>(dxg, w, dx, M, G, E, s);
    case 8: return launch_wgmma<BN, 8>(dxg, w, dx, M, G, E, s);
    case 4: return launch_wgmma<BN, 4>(dxg, w, dx, M, G, E, s);
    default: return launch_wgmma<BN, 2>(dxg, w, dx, M, G, E, s);
  }
}

template <class Kernel>
int launch_bf16(Kernel kernel, size_t smem, const bf16* dxg, const bf16* w, bf16* dx, int M,
                int G, int E, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  const int threads = 32 * B16_WARPS;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int col_tiles = (E + B16_BN - 1) / B16_BN;
  const int m_tiles = (M + B16_BM - 1) / B16_BM;
  const int walkers = std::max(1, std::min(m_tiles, (std::max(per_sm, 1) * sms + col_tiles - 1) /
                                                        col_tiles));
  // 4-byte pairs: every direction's columns start at an even element (3H
  // even, so H even) and both pointers are 4-byte aligned
  const bool pair = (G / 2) % 2 == 0 && (reinterpret_cast<uintptr_t>(dxg) & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(w) & 3) == 0;
  kernel<<<dim3(col_tiles, walkers), threads, smem, stream>>>(dxg, w, dx, M, G, E, pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dxg (M, G), w (E, G), dx (M, E): f32, contiguous, on the device.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int gru_input_proj_dx(const float* dxg, const float* w, float* dx, int M, int G,
                                 int E, void* stream) {
  if (M == 0 || E == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 56 && wide_smem(G, 56) <= SMEM_LIMIT)
    return launch(gru_input_proj_dx_wgmma<56>, WG * WGS, wide_smem(G, 56), BM, 56, WGS, dxg,
                  w, dx, M, G, E, s);
  if (E <= 64 && wide_smem(G, 64) <= SMEM_LIMIT)
    return launch(gru_input_proj_dx_wgmma<64>, WG * WGS, wide_smem(G, 64), BM, 64, WGS, dxg,
                  w, dx, M, G, E, s);
  if (E > 64 && wide_smem(G, 128) <= SMEM_LIMIT)
    return launch(gru_input_proj_dx_wgmma<128>, WG * WGS, wide_smem(G, 128), BM, 128, WGS,
                  dxg, w, dx, M, G, E, s);
  return launch(gru_input_proj_dx_deep, THREADS, 0, DBM, DBN, 1, dxg, w, dx, M, G, E, s);
}

// dxg (M, G), w (E, G), dx (M, E): bf16, contiguous, on the device; G =
// 6H even.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int gru_input_proj_dx_bf16(const bf16* dxg, const bf16* w, bf16* dx, int M, int G,
                                      int E, void* stream) {
  if (M == 0 || E == 0) return 0;
  if (G % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = E <= 56 ? 56 : 64;
  if (wgmma_smem(bn, G / 2) <= SMEM_LIMIT)
    return bn == 56 ? run_wgmma<56>(dxg, w, dx, M, G, E, s) : run_wgmma<64>(dxg, w, dx, M, G, E, s);
  if (bf16_smem(G / 2) <= SMEM_LIMIT)
    return launch_bf16(gru_input_proj_dx_bf16_mma<true>, bf16_smem(G / 2), dxg, w, dx, M, G, E,
                       s);
  return launch_bf16(gru_input_proj_dx_bf16_mma<false>, 0, dxg, w, dx, M, G, E, s);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
