// K1 gru_input_proj: the bi-GRU input projection for both directions.
//
//   xg (M, 6H) = x (M, E) @ [W_ih_fwd | W_ih_bwd] (E, 6H) + [b_ih_fwd | b_ih_bwd]
//
// M = N*L sentence-row tokens in true time; gate order per direction is
// [r | z | n].  f32 in, f32 out, f32-accurate products (3xTF32, see
// tf32x3.cuh; for 112 < E <= 352 three-part bf16 splits, below) with f32
// accumulation.  The bf16 variant
// (gru_input_proj_bf16, --compute_dtype bfloat16) reads bf16 x, W and b,
// accumulates in f32 and rounds xg to bf16 as the JAX package does:
// once, on store, up to E = 64 (the TPU kernel's bf16 IO,
// _proj_fwd_kernel), and past it also the product before the bias is
// added (_build_xg); up to E = 544 its products are native bf16 wgmma
// (wgmma_bf16.cuh), see "bf16 IO" below.
//
// Replaces two TPU kernels of umpr_tpu/ops/gru_pallas.py:
//   B3 _pallas_project_fwd / _proj_fwd_kernel (pallas_call at :319), the
//      projection itself, whose f32 products run at Precision.HIGHEST, and
//   B5 _pallas_stack_pad / _stack_pad_kernel (pallas_call at :541), which
//      built the stacked [x | x time-flipped | 0-pad] (N, L*128) input
//      stream so one TPU matmul could feed both directions.
// Here x is read once, in true time, for both directions: the backward
// direction's reversed order is K2's loop order, so no stacked or flipped
// copy of x exists.  The TPU's 128-lane padding and interleaved gate layout
// are not reproduced.
//
// What bounds it on an H100: at the UMPR-R shapes (M=51,200, E=50, 6H=384)
// it reads 10.2 MB, writes 78.6 MB (xg) and does 2.0 GFLOP: 26.5 us of HBM
// traffic at 3.35 TB/s.  On the CUDA cores the products alone would take
// 29 us at the 67 TFLOP/s f32 peak.  As 3xTF32 they are 6.6 GFLOP of TF32
// (depth padded to 56): 13 us at wgmma's 495 TFLOP/s, about twice that
// with mma.sync, which reaches about half of wgmma's TF32 rate on Hopper.
// So the products run as wgmma and the kernel streams, bound by its xg
// stores:
//   - persistent blocks, one per SM, of two warpgroups; block (c, j) keeps
//     column tile c (128 columns) of W, and each warpgroup walks its own
//     64-row tiles (no grid cap on M, no block-wide barrier in the loop);
//   - W's column slice is loaded once per block, split into TF32 big and
//     small parts, as the K-major B tiles of wgmma in shared memory;
//   - a row tile of x is one contiguous span of 64*E floats, copied with
//     16-byte cp.async into the warpgroup's two-stage ring: the next tile's
//     copy overlaps this tile's products and stores.  The shared copy keeps
//     x's own row stride E (a 16-byte copy cannot pad rows of 200 bytes);
//   - each thread loads its A fragment from the x tile and splits it in
//     registers; the depth is a loop over k-steps of 8 (any E), columns
//     past E zeroed by selects, W's by zero fill; two register sets let
//     step ks + 1 be split while step ks runs on the tensor core;
//   - wgmma m64n128k8 TF32, three per k-step: the two small cross terms
//     into one f32 accumulator, big*big into another (the tensor core's
//     accumulation, coarser than an f32 add, then errs at 7 steps, not 21);
//   - the epilogue adds the two and the bias in f32 and stores 8-byte
//     pairs: the 4 lanes of a row group write one whole 32-byte sector.
//     (Staging the tile in shared memory and writing whole rows, by
//     threads or as bulk copies, measured no faster on the card.)
// Past E = 112 (GloVe's 200 and 300, word2vec's and fastText's 300) W's
// 128-column slice, split, no longer fits beside the x tiles (311 KB alone
// at E = 300).  At (51,200, 300, 384) the f32-accurate products cost
// 0.072 ms on the tensor cores (35.4 GFLOP of TF32 at 495 TFLOP/s, or as
// many bf16 products at 989), against 0.042 ms of HBM traffic (x 61 MB,
// xg 79 MB), so the kernel past it keeps the products on wgmma and
// streams x.  Its products are split bf16, not 3xTF32: each f32 value is
// the sum of three bf16 parts (8 + 8 + 8 bits, each the rest rounded),
// and six products (p1 q1 and the five down to 2^-18 of it: p1 q2, p2 q1,
// p2 q2, p1 q3, p3 q1) are f32-accurate.  Six bf16 wgmmas m64n128k16 a
// k16 step take the tensor-core time of 3xTF32's three m64n128k8 for each
// of its two k8 steps, and x's parts take 6 bytes an element in shared
// memory, 3xTF32's 8: the same kernel on 3xTF32 measured 12% slower at
// E = 300 on an H100 (chip_smoke.py --steps).  It keeps every value
// within 1e-5 + 1e-5 |xg| of the f64 product, where cuBLAS's f32 product
// does not (chip_smoke.py k1_f32_widths and --turns count all three).  A
// chunk's products start from zero and are added to an f32 sum once they
// are done: the tensor core's accumulation, coarser than an f32 add,
// chained over a tile put values past 1e-5.
// 112 < E <= 352: gru_input_proj_xt, the product transposed, xg^T = W^T
// x^T, so that x is read by 3 column tiles (6H = 384), not 6, and the
// wgmma is m64n128k16:
//   - a block holds 128 columns of W (two warpgroups of m64) as f32, laid
//     out as each thread's A fragments (two 16-byte loads a k16 step, 156
//     KB at E = 300), split into its parts in registers each chunk;
//   - it walks x tiles of 128 rows, the depth in chunks of 32 columns: each
//     thread loads 16 floats of one row a chunk ahead (float4 where E % 4
//     == 0 and x is 16-byte aligned, else single floats; zeros past E and
//     M), splits them and stores the parts as K-major bf16 B tiles, into
//     the buffer the chunk before last read, while this chunk's products
//     run (two buffers of 24 KB);
//   - a chunk's two k16 steps, six wgmmas each, go as one group with no
//     branch among them (steps past E multiply B's zeros with W's last
//     fragments): a wgmma in a branch makes ptxas serialise every one;
//   - the accumulators hold xg^T: the 8 lanes of a quad row write 8
//     neighbouring columns of an xg row (32 bytes a store instruction).
//   Where the time goes (chip_smoke.py --steps, E = 300): its products
//   alone take 0.13 ms, 55% of the tensor cores' rate: each chunk waits
//   for its group before adding it in f32, and keeping a group in flight
//   across chunks (two accumulators, or the next A split ahead) measured
//   slower.
// Past E = 352, where W's f32 slice outgrows the shared memory, a plain
// mma.sync kernel on 32 x 32 tiles takes over, and past E = 452,
// where its W slice and x ring outgrow the shared memory too, a kernel that
// reads its fragments from global memory (any E).  Each output element is
// computed by one thread in a fixed order, so the bits do not depend on the
// grid (the SM count) or on the run.
//
// bf16 IO.  At the UMPR-R shapes it reads 5.1 MB (x), writes 39.3 MB (xg)
// and does 2.0 GFLOP of bf16 products: 13.3 us at 3.35 TB/s against 2 us
// at 989 TFLOP/s, so it is bound by its xg stores even more than f32 is.
// Rounding: the JAX package takes its Pallas projection only while 2E
// fits one 128-lane tile (gru_pallas.py:95, :132), whose bf16 xg is the
// f32 sum plus the bias rounded once; past E = 64 it takes _build_xg
// (:556-573), XLA's bf16 x @ w (the f32 sum rounded), then the bias add
// (rounded again).  Every bf16 epilogue here rounds as the JAX package
// does at its E (xg_value, ROUND_ONCE_MAX_E).
// Up to E = 256 (gru_input_proj_bf16_wgmma, the largest E whose W tiles,
// x ring and store staging fit the shared memory) the design is the f32
// kernel's persistent walk with three changes:
//   - products: wgmma m64n128k16 bf16 with an f32 accumulator, one per
//     k-step of 16 (E = 50 pads to 64: four steps); W's column slice sits
//     in shared memory as bf16 K-major tiles (16 KB at E = 50);
//   - A straight from the x tile: a row of x is E bf16 (100 bytes at
//     E = 50, no 16-byte multiple, so no TMA map or canonical wgmma layout
//     takes it as it lands), but a 64-row tile is one contiguous span, and
//     at even E each lane reads its fragment as 32-bit (k, k + 1) pairs;
//     odd E reads 2-byte halves.  Columns past E are zeroed by selects;
//   - the epilogue adds the f32 bias, rounds to bf16 and stages the
//     warpgroup's 64 x 128 tile in shared memory (rows 272 bytes apart:
//     the quads' 4-byte writes hit 32 distinct banks); the warpgroup then
//     writes whole 256-byte row pieces as 16-byte stores (a per-lane bf16
//     pair would fill half a 32-byte sector per instruction), or 2-byte
//     stores where 6H is no multiple of 8 (H = 17: 6H = 102).
// W's slice is read as 16-byte rows of 8 columns and transposed in
// registers (load_w_tiles) where 6H % 8 == 0, else as 2-byte loads.
// 256 < E <= 544 (word2vec's and GloVe's 300 among them):
// gru_input_proj_bf16_stream.  Whole x tiles no longer fit beside W's
// slice (266,752 bytes at E = 300), and of the ways to make room this
// keeps W resident and streams x's depth:
//   - W's 128-column slice stays in shared memory (E = 544: 139 KB), read
//     once a block; streaming it too would read it again from L2 for
//     every row tile (2x x's bytes at E = 300), and a single x buffer
//     (which fits only to E = 384) or one warpgroup a block would leave
//     no copy in flight beside the products;
//   - each warpgroup's x tile arrives as chunks of 64 columns x 64 rows
//     through a 3-stage cp.async ring (two chunks in flight, the next
//     tile's first ones during this tile's epilogue), each row's piece
//     copied in the largest unit its start allows: 16 bytes at E % 8 ==
//     0, 8 at E % 4 == 0 (E = 300: 600-byte rows), 4 at even E; at odd E
//     4-byte pieces from each row's 4-byte aligned start, the row's data
//     then one element in where it starts at an odd address (copy_rows);
//   - A by ldmatrix.x4 from the chunk (rows 144 bytes apart: conflict
//     free), columns past E zeroed by selects; 2-byte halves at odd E;
//   - wgmma m64n128k16, f32 accumulators, a chunk's four k16 steps
//     issued as one group with no branch among them (the steps past E
//     multiply A's zeros with W's last tile): a wgmma in a branch makes
//     ptxas serialise every one (0.0836 ms against 0.0725 at E = 300 on
//     an H100, chip_smoke.py --steps); then the staged 16-byte epilogue
//     above.
// Each output is one thread's accumulator summed over k in order, so the
// bits do not depend on the grid or the run.  Past E = 544 the mma.sync
// and deep kernels above take bf16 too: each k-step one TF32 product of
// the widened bf16 values (exact in TF32).

#include <algorithm>

#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace tf32x3;

constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on Hopper (227 KB)

// ---- the wgmma kernel (E <= 112): two warpgroups per block, one block per SM

constexpr int WG = 128;    // threads of a warpgroup
constexpr int WGS = 2;     // warpgroups per block, each walking its own row tiles
constexpr int BM = 64;     // rows of a warpgroup's tile
constexpr int BN = 128;    // columns of a block (wgmma n)
constexpr int WT = BN * 8;  // floats of one k-step's W tile (big or small)

size_t wide_smem(int K) {
  return ((size_t)(K + 7) / 8 * 2 * WT + BN + (size_t)WGS * 2 * BM * K) * sizeof(float);
}

// the A fragment of k-step ks (columns 8 ks + tig, + 4) of rows p0, p8 of
// an x tile in shared memory, split; zeros past K
template <class T>
__device__ __forceinline__ void split_a(const T* p0, const T* p8, int ks, int K, int tig,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int k0 = ks * 8 + tig, k1 = k0 + 4;
  const bool v0 = k0 < K, v1 = k1 < K;
  split(v0 ? ld(p0[k0]) : 0.f, ah[0], al[0]);
  split(v0 ? ld(p8[k0]) : 0.f, ah[1], al[1]);
  split(v1 ? ld(p0[k1]) : 0.f, ah[2], al[2]);
  split(v1 ? ld(p8[k1]) : 0.f, ah[3], al[3]);
}

__global__ void __launch_bounds__(WG * WGS, 1)
gru_input_proj_wgmma(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out, int M, int K, int N,
                     bool vec, bool) {
  extern __shared__ float4 smem4[];
  const int KS = (K + 7) / 8;
  float* wt = reinterpret_cast<float*>(smem4);  // [KS][big, small][WT]
  float* bias = wt + KS * 2 * WT;                 // [BN]
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, gid = lane >> 2, tig = lane & 3;
  float* ring = bias + BN + wg * 2 * BM * K;  // this warpgroup's [2][BM * K]
  const int col0 = blockIdx.x * BN;
  const int walkers = gridDim.y * WGS;
  const int m_tiles = (M + BM - 1) / BM;

  // the first x tile's copy goes out before W is read
  int tile = blockIdx.y * WGS + wg;
  if (tile < m_tiles)
    copy_span(ring, x + (size_t)tile * BM * K, min(BM, M - tile * BM) * K, vec, t, WG);
  cp_async_commit();

  // W's column slice, split once into its big and small B tiles; zeros
  // past K and past N.  Lane (kq, nr) of item i: k = 8 ks + 4 kh + kq,
  // n = 8 ng + nr.
  for (int i = tid; i < KS * 2 * (BN / 8) * 32; i += WG * WGS) {
    const int l = i & 31, ng = (i >> 5) % (BN / 8), kh = (i >> 5) / (BN / 8) % 2;
    const int ks = (i >> 5) / (BN / 4);
    const int k = ks * 8 + kh * 4 + (l & 3), n = ng * 8 + (l >> 2);
    uint32_t big, small;
    split(k < K && col0 + n < N ? ld(w[(size_t)k * N + col0 + n]) : 0.f, big, small);
    float* tb = wt + ks * 2 * WT + b_offset(n, k & 7);
    tb[0] = __uint_as_float(big);
    tb[WT] = __uint_as_float(small);
  }
  if (tid < BN) bias[tid] = col0 + tid < N ? ld(b[col0 + tid]) : 0.f;
  fence_proxy_async();
  __syncthreads();

  const int r0 = warp * 16 + gid;  // this thread's rows of a tile: r0, r0 + 8
  for (int it = 0; tile < m_tiles; ++it, tile += walkers) {
    cp_async_wait<0>();  // this tile's copy has landed ...
    named_barrier(1 + wg, WG);  // ... for the warpgroup; it is done with the last tile
    const int next = tile + walkers;  // into the buffer the last tile used
    if (next < m_tiles)
      copy_span(ring + ((it + 1) & 1) * BM * K, x + (size_t)next * BM * K,
                min(BM, M - next * BM) * K, vec, t, WG);
    cp_async_commit();

    // rows past M hold stale values: they reach only their own outputs,
    // which are not stored
    const float* p0 = ring + (it & 1) * BM * K + r0 * K;
    const float* p8 = p0 + 8 * K;
    // hi sums big*big, lo the two small cross terms: the tensor core's
    // accumulation error then follows the 7 big*big steps only
    float hi[BN / 2], lo[BN / 2];
    if (KS == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hi[i] = lo[i] = 0.f;
    }
    // two A register sets: step ks + 1's fragment is split while step ks
    // runs; a set is rewritten only once the step that read it is done
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    auto issue = [&](int ks, const uint32_t(&ah)[4], const uint32_t(&al)[4]) {
      const float* tb = wt + ks * 2 * WT;
      const int add = ks > 0;
      wgmma_fence();
      Wgmma<BN>::run(lo, al, b_desc(tb), add);
      Wgmma<BN>::run(hi, ah, b_desc(tb), add);
      Wgmma<BN>::run(lo, ah, b_desc(tb + WT), 1);
      wgmma_commit();
    };
    split_a(p0, p8, 0, K, tig, ah0, al0);
    for (int ks = 0; ks < KS; ks += 2) {
      issue(ks, ah0, al0);
      wgmma_wait<1>();  // step ks - 1 is done with set 1
      split_a(p0, p8, ks + 1, K, tig, ah1, al1);
      if (ks + 1 < KS) {
        issue(ks + 1, ah1, al1);
        wgmma_wait<1>();  // step ks is done with set 0
        split_a(p0, p8, ks + 2, K, tig, ah0, al0);
      }
    }
    wgmma_wait<0>();
    fence_regs(hi);
    fence_regs(lo);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * BM + r0 + 8 * h;
      if (r >= M) continue;
      float* row = out + (size_t)r * N + col0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + 2 * tig;
        const float o0 = hi[4 * j + 2 * h] + lo[4 * j + 2 * h] + bias[c];
        const float o1 = hi[4 * j + 2 * h + 1] + lo[4 * j + 2 * h + 1] + bias[c + 1];
        if ((N & 1) == 0) {  // c even, so col0 + c < N implies col0 + c + 1 < N
          if (col0 + c < N) store_pair(row + c, o0, o1);
        } else {
          if (col0 + c < N) row[c] = o0;
          if (col0 + c + 1 < N) row[c + 1] = o1;
        }
      }
    }
  }
  cp_async_wait<0>();  // the last committed group is empty; leave none behind
}

// ---- the bf16 wgmma kernel (bf16 IO, E <= 256): the f32 kernel's walk
// with native bf16 products and a staged epilogue (see the header)

constexpr int B16_WT = BN * 16;   // bf16 of one k16 step's W tile
constexpr int B16_SST = BN + 8;   // staging row stride, bf16 (272 bytes)

// The JAX package's bf16 xg (umpr_tpu/ops/gru_pallas.py:95 _MXU_LANES,
// :132 _proj_mode): up to E = 64 its Pallas projection rounds the f32 sum
// plus the bias once; past it _build_xg (:556-573) rounds x @ w to bf16,
// adds the bias and rounds the sum again.  Every bf16 epilogue below
// takes `twice` = (E > ROUND_ONCE_MAX_E); gru_cuda.PROJ_ROUND_ONCE_MAX_E
// is the plain version's.
constexpr int ROUND_ONCE_MAX_E = 64;

// an xg value before it is rounded on store: the f32 sum (for bf16 IO
// first rounded to bf16 where `twice`) plus the f32 bias
template <class T>
__device__ __forceinline__ float xg_value(float sum, float bias, bool twice) {
  if constexpr (is_bf16<T>) {
    if (twice) sum = round_to<bf16>(sum);
  }
  return sum + bias;
}

// One 32-bit word of a uint4 (i = 0..3, uniform or not: selects)
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// W's column slice [col0, col0 + BN) as K-major bf16 tiles, one per k16
// step (tile_offset), zeros past K and past N; `threads` threads from
// tid.  Where N % 8 == 0 and w is 16-byte aligned an item is an 8 x 8
// block (8 rows k of 8 columns n): eight 16-byte row loads, transposed in
// registers by byte permutes into eight 16-byte column stores (8 k of one
// n, as the tile holds them); the 8 lanes of a quarter warp store their
// columns in the orders j ^ q, q = 0..7, so each store instruction hits 8
// distinct 16-byte bank groups.  Otherwise column n's 8 k of one k half
// as 2-byte loads, one 16-byte store.  Every block reads the same slice
// at once, so block b starts at item b * threads (wrapping): the SMs'
// first reads spread over the slice's L2 lines.
__device__ void load_w_tiles(bf16* wt, const bf16* w, int col0, int K, int N, int KS, int tid,
                             int threads) {
  using namespace wgmma_bf16;
  const int rot = blockIdx.y * threads;  // a multiple of 16: quarter warps keep their columns
  if (N % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int items = KS * 2 * (BN / 8);
    for (int i0 = tid; i0 < items; i0 += threads) {
      const int i = (i0 + rot) % items;
      const int g = i % (BN / 8), kb = i / (BN / 8), n = col0 + 8 * g;
      uint4 r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = 8 * kb + u;
        r[u] = k < K && n < N ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + n))
                              : make_uint4(0u, 0u, 0u, 0u);
      }
      bf16* dst = wt + (kb >> 1) * B16_WT + tile_offset(8 * g, (kb & 1) * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j ^ (g & 7);  // this store's column of the block
        const uint32_t sel = c & 1 ? 0x7632u : 0x5410u;  // the high or low halves
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = __byte_perm(word(r[2 * q], c >> 1), word(r[2 * q + 1], c >> 1), sel);
        *reinterpret_cast<uint4*>(dst + tile_offset(c, 0)) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    return;
  }
  for (int i0 = tid; i0 < KS * 2 * BN; i0 += threads) {
    const int i = (i0 + rot) % (KS * 2 * BN);
    const int n = i % BN, k0 = (i / BN) * 8;  // k0 = 16 ks + 8 kh
    const bool in = col0 + n < N;
    uint32_t q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 2 * u;
      q[u] = pack(in && k < K ? bits(w[(size_t)k * N + col0 + n]) : 0u,
                  in && k + 1 < K ? bits(w[(size_t)(k + 1) * N + col0 + n]) : 0u);
    }
    *reinterpret_cast<uint4*>(wt + (k0 / 16) * B16_WT + tile_offset(n, k0 & 15)) =
        make_uint4(q[0], q[1], q[2], q[3]);
  }
}

size_t bf16_smem(int K) {
  return (size_t)(K + 15) / 16 * B16_WT * sizeof(bf16) + BN * sizeof(float) +
         ((size_t)WGS * BM * B16_SST + (size_t)WGS * 2 * BM * K) * sizeof(bf16);
}

// the 32-bit A register of row p's columns k, k + 1 (k even); zeros past
// K.  PAIR (K even): one aligned 4-byte load, since k < K then implies
// k + 1 < K
template <bool PAIR>
__device__ __forceinline__ uint32_t a_pair(const bf16* p, int k, int K) {
  if constexpr (PAIR) {
    return k < K ? *reinterpret_cast<const uint32_t*>(p + k) : 0u;
  } else {
    return wgmma_bf16::pack(k < K ? wgmma_bf16::bits(p[k]) : 0u,
                            k + 1 < K ? wgmma_bf16::bits(p[k + 1]) : 0u);
  }
}

// The bf16 epilogue of a warpgroup's 64 x 128 tile: xg_value's sums,
// rounded, into its staging tile; then, once the warpgroup has staged
// them, whole row pieces of the tile as 16-byte stores.
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const float* bias,
                                           bf16* stage, bf16* out, int tile, int M, int N,
                                           int col0, int r0, int tig, int t, int wg,
                                           bool twice) {
  using wgmma_bf16::round_pair;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(stage + r0 * B16_SST + c) =
        round_pair(xg_value<bf16>(acc[4 * j], bias[c], twice),
                   xg_value<bf16>(acc[4 * j + 1], bias[c + 1], twice));
    *reinterpret_cast<uint32_t*>(stage + (r0 + 8) * B16_SST + c) =
        round_pair(xg_value<bf16>(acc[4 * j + 2], bias[c], twice),
                   xg_value<bf16>(acc[4 * j + 3], bias[c + 1], twice));
  }
  named_barrier(1 + wg, WG);  // the tile is staged
  const int rows = min(BM, M - tile * BM);
  bf16* dst = out + (size_t)tile * BM * N + col0;
  // 16-byte row pieces need out 16-byte aligned and rows of a multiple of
  // 8 bf16 (col0 is a multiple of 128): then a piece lies wholly inside
  // or past N
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0 && N % 8 == 0) {
    for (int i = t; i < rows * (BN / 8); i += WG) {
      const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
      if (col0 + c < N)
        *reinterpret_cast<uint4*>(dst + (size_t)r * N + c) =
            *reinterpret_cast<const uint4*>(stage + r * B16_SST + c);
    }
  } else {
    for (int i = t; i < rows * BN; i += WG) {
      const int r = i / BN, c = i % BN;
      if (col0 + c < N) dst[(size_t)r * N + c] = stage[r * B16_SST + c];
    }
  }
}

template <bool PAIR>
__global__ void __launch_bounds__(WG * WGS, 2)
gru_input_proj_bf16_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const bf16* __restrict__ b, bf16* __restrict__ out, int M, int K,
                          int N, bool vec, bool twice) {
  using namespace wgmma_bf16;
  extern __shared__ float4 smem4[];
  const int KS = (K + 15) / 16;
  bf16* wt = reinterpret_cast<bf16*>(smem4);                 // [KS][B16_WT]
  float* bias = reinterpret_cast<float*>(wt + KS * B16_WT);  // [BN]
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, gid = lane >> 2, tig = lane & 3;
  bf16* stage = reinterpret_cast<bf16*>(bias + BN) + wg * BM * B16_SST;  // [BM][B16_SST]
  bf16* ring = reinterpret_cast<bf16*>(bias + BN) + WGS * BM * B16_SST +
               wg * 2 * BM * K;  // this warpgroup's [2][BM * K]
  const int col0 = blockIdx.x * BN;
  const int walkers = gridDim.y * WGS;
  const int m_tiles = (M + BM - 1) / BM;

  int tile = blockIdx.y * WGS + wg;
  if (tile < m_tiles)
    copy_span(ring, x + (size_t)tile * BM * K, min(BM, M - tile * BM) * K, vec, t, WG);
  cp_async_commit();

  load_w_tiles(wt, w, col0, K, N, KS, tid, WG * WGS);
  if (tid < BN) bias[tid] = col0 + tid < N ? __bfloat162float(b[col0 + tid]) : 0.f;
  fence_proxy_async();
  __syncthreads();

  const int r0 = warp * 16 + gid;  // this thread's rows of a tile: r0, r0 + 8
  for (int it = 0; tile < m_tiles; ++it, tile += walkers) {
    cp_async_wait<0>();  // this tile's copy has landed ...
    named_barrier(1 + wg, WG);  // ... for the warpgroup; it is done with the last tile
    const int next = tile + walkers;  // into the buffer the last tile used
    if (next < m_tiles)
      copy_span(ring + ((it + 1) & 1) * BM * K, x + (size_t)next * BM * K,
                min(BM, M - next * BM) * K, vec, t, WG);
    cp_async_commit();

    // rows past M hold stale values: they reach only their own outputs,
    // which are not stored
    const bf16* p0 = ring + (it & 1) * BM * K + r0 * K;
    const bf16* p8 = p0 + 8 * K;
    float acc[BN / 2];
    if (KS == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    // two A register sets: wgmma reads them asynchronously, so a set is
    // rewritten only once the step that read it is done
    uint32_t a0[4], a1[4];
    auto load_a = [&](int ks, uint32_t(&a)[4]) {
      const int k = ks * 16 + 2 * tig;
      a[0] = a_pair<PAIR>(p0, k, K);
      a[1] = a_pair<PAIR>(p8, k, K);
      a[2] = a_pair<PAIR>(p0, k + 8, K);
      a[3] = a_pair<PAIR>(p8, k + 8, K);
    };
    auto issue = [&](int ks, const uint32_t(&a)[4]) {
      wgmma_fence();
      WgmmaBf16<BN>::run(acc, a, desc(wt + ks * B16_WT), ks > 0);
      wgmma_commit();
    };
    load_a(0, a0);
    for (int ks = 0; ks < KS; ks += 2) {
      issue(ks, a0);
      wgmma_wait<1>();  // step ks - 1 is done with set 1
      load_a(ks + 1, a1);
      if (ks + 1 < KS) {
        issue(ks + 1, a1);
        wgmma_wait<1>();  // step ks is done with set 0
        load_a(ks + 2, a0);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    store_tile(acc, bias, stage, out, tile, M, N, col0, r0, tig, t, wg, twice);
  }
  cp_async_wait<0>();  // the last committed group is empty; leave none behind
}

// ---- the bf16 streaming kernel (bf16 IO, 256 < E <= 544): W's slice
// resident, x's depth streamed in chunks (see the header)

constexpr int KC = 64;        // x columns a chunk: 4 k16 steps
constexpr int KSC = KC / 16;
constexpr int XS = KC + 8;    // a chunk's row stride in shared memory, bf16 (144 bytes)
constexpr int STAGES = 3;     // chunks in a warpgroup's ring: two in flight
constexpr int S_WGS = 2;      // warpgroups a block, each walking its own row tiles

size_t stream_smem(int K) {
  return (size_t)(K + 15) / 16 * B16_WT * sizeof(bf16) + BN * sizeof(float) +
         (size_t)S_WGS * (BM * B16_SST + STAGES * BM * XS) * sizeof(bf16);
}

template <int U>
__global__ void __launch_bounds__(WG * S_WGS, 1)
gru_input_proj_bf16_stream(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const bf16* __restrict__ b, bf16* __restrict__ out, int M, int K,
                           int N, bool, bool twice) {
  using namespace wgmma_bf16;
  extern __shared__ float4 smem4[];
  const int KS = (K + 15) / 16, NC = (K + KC - 1) / KC;
  bf16* wt = reinterpret_cast<bf16*>(smem4);                 // [KS][B16_WT]
  float* bias = reinterpret_cast<float*>(wt + KS * B16_WT);  // [BN]
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, tig = lane & 3;
  bf16* stage = reinterpret_cast<bf16*>(bias + BN) + wg * BM * B16_SST;  // [BM][B16_SST]
  bf16* ring = reinterpret_cast<bf16*>(bias + BN) + S_WGS * BM * B16_SST +
               wg * STAGES * BM * XS;  // this warpgroup's [STAGES][BM][XS]
  const int col0 = blockIdx.x * BN;
  const int walkers = gridDim.y * S_WGS;
  const int m_tiles = (M + BM - 1) / BM;
  const int first = blockIdx.y * S_WGS + wg;

  // chunk g of this warpgroup's walk: depth chunk g % NC of its row tile
  // first + (g / NC) walkers, into ring stage g % STAGES; one commit group
  // a chunk, empty past the last tile
  auto fetch = [&](int g) {
    const int tile = first + g / NC * walkers, c = g % NC;
    if (tile < m_tiles)
      copy_rows<U, KC>(ring + g % STAGES * BM * XS, XS, x + (size_t)tile * BM * K + c * KC, K,
                       min(BM, M - tile * BM), min(KC, K - c * KC), t, WG);
    cp_async_commit();
  };
  // the first chunks go out before W is read
  for (int g = 0; g < STAGES - 1; ++g) fetch(g);
  load_w_tiles(wt, w, col0, K, N, KS, tid, WG * S_WGS);
  if (tid < BN) bias[tid] = col0 + tid < N ? __bfloat162float(b[col0 + tid]) : 0.f;
  fence_proxy_async();
  __syncthreads();

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows of a tile: r0, r0 + 8
  int g = 0;                               // the next chunk to take from the ring
  for (int tile = first; tile < m_tiles; tile += walkers) {
    // rows past M hold stale values: they reach only their own outputs,
    // which are not stored
    const uintptr_t row0 = (reinterpret_cast<uintptr_t>(x) >> 1) + (size_t)(tile * BM + r0) * K;
    const int sh0 = U == 2 ? (int)(row0 & 1) : 0, sh8 = U == 2 ? (int)((row0 + 8 * K) & 1) : 0;
    float acc[BN / 2];
    // one wgmma group a chunk, issued whole: steps past KS read A's zeros
    // (the selects past K) against W's last tile, so no wgmma sits in a
    // branch (ptxas serialises those); the A registers are rewritten only
    // once the group before is done, while its products run beside this
    // chunk's wait, barrier and copies
    uint32_t a[KSC][4];
    for (int c = 0; c < NC; ++c) {
      cp_async_wait<STAGES - 2>();  // chunk g has landed ...
      named_barrier(1 + wg, WG);    // ... for the warpgroup, which has read chunk g - 1
      fetch(g + STAGES - 1);        // into chunk g - 1's stage
      const bf16* chunk = ring + g % STAGES * BM * XS;
      ++g;
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < KSC; ++j)
        chunk_a<U>(a[j], chunk, XS, 16 * j, K - c * KC, warp, lane, sh0, sh8);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < KSC; ++j)
        WgmmaBf16<BN>::run(acc, a[j], desc(wt + min(c * KSC + j, KS - 1) * B16_WT),
                           c * KSC + j > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    store_tile(acc, bias, stage, out, tile, M, N, col0, r0, tig, t, wg, twice);
  }
  cp_async_wait<0>();  // the groups left are empty; leave none behind
}

// ---- the f32 transposed kernel (112 < E <= 352): xg^T = W^T x^T, W's
// 128-column slice resident as f32 A fragments, x's depth split into bf16
// B tiles (see the header)

// v0, v1 = their three bf16 parts summed, exactly (each part the rest
// rounded to nearest), as bf16 pairs (v0 in the low halves)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& p1, uint32_t& p2,
                                       uint32_t& p3) {
  using namespace wgmma_bf16;
  p1 = round_pair(v0, v1);
  v0 -= lo_f(p1);
  v1 -= hi_f(p1);
  p2 = round_pair(v0, v1);
  p3 = round_pair(v0 - lo_f(p2), v1 - hi_f(p2));
}

constexpr int X_BM = 128;                    // columns of 6H a block: two warpgroups of m64
constexpr int X_BX = 128;                    // x rows a tile (wgmma n)
constexpr int X_KC = 32;                     // x columns a chunk: 2 k16 steps
constexpr int X_BT = X_BX * 16;              // bf16 of one k16 step's B tile (one part)
constexpr int X_BUF = X_KC / 16 * 3 * X_BT;  // bf16 of a chunk's B tiles [k16 step][part]
constexpr int X_THREADS = 2 * WG;

size_t xt_smem(int K) {
  return (size_t)(K + 15) / 16 * X_THREADS * 8 * sizeof(float) +
         2 * (size_t)X_BUF * sizeof(bf16) + X_BM * sizeof(float);
}

template <bool VEC>
__global__ void __launch_bounds__(X_THREADS, 1)
gru_input_proj_xt(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ out, int M, int K, int N,
                  bool, bool) {
  using namespace wgmma_bf16;
  extern __shared__ float4 smem4[];
  const int KS = (K + 15) / 16, NC = (K + X_KC - 1) / X_KC;
  float* wf = reinterpret_cast<float*>(smem4);                            // [KS][X_THREADS][8]
  bf16* bt = reinterpret_cast<bf16*>(wf + (size_t)KS * X_THREADS * 8);  // [2][X_BUF]
  float* bias = reinterpret_cast<float*>(bt + 2 * X_BUF);                // [X_BM]
  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32, gid = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * X_BM;
  const int m_tiles = (M + X_BX - 1) / X_BX;
  // this block's chunks: NC for each of its x tiles blockIdx.y + i gridDim.y
  const int chunks = (m_tiles - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y * NC;

  // W's slice as each thread's A fragments (WgmmaBf16's layout), f32, in
  // register order: float 2 q + e of k16 step s holds m = gid + 8 (q & 1),
  // k = 16 s + 2 tig + 8 (q >> 1) + e of its warp's 16 rows of W^T.  Read
  // in rows of w (consecutive threads, consecutive columns); zeros past K
  // and past N.
#pragma unroll 4
  for (int i = tid; i < KS * 16 * X_BM; i += X_THREADS) {
    const int m = i % X_BM, k = i / X_BM, mw = m % 64, kk = k % 16;
    const int owner = m / 64 * WG + mw / 16 * 32 + mw % 8 * 4 + kk % 8 / 2;
    const int q = mw % 16 / 8 + 2 * (kk / 8);
    wf[((size_t)(k / 16) * X_THREADS + owner) * 8 + 2 * q + kk % 2] =
        k < K && col0 + m < N ? w[(size_t)k * N + col0 + m] : 0.f;
  }
  if (tid < X_BM) bias[tid] = col0 + tid < N ? b[col0 + tid] : 0.f;

  // chunk g: depth chunk g % NC of x tile blockIdx.y + (g / NC) gridDim.y.
  // This thread loads 16 columns of one row (one k16 step; zeros past K,
  // past M and past the block's chunks) a chunk ahead, and stores their
  // three bf16 parts as that row's pieces of the step's K-major B tiles.
  const int xr = tid >> 1, xh = tid & 1;
  float4 xv[4];
  auto load = [&](int g) {
    const int r = (blockIdx.y + g / NC * gridDim.y) * X_BX + xr, k0 = g % NC * X_KC + 16 * xh;
    const bool in = g < chunks && r < M;
    const float* p = x + (size_t)(in ? r : 0) * K + k0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (VEC) {  // K % 4 == 0: a float4 lies wholly inside or past K
        xv[q] = in && k0 + 4 * q < K ? __ldg(reinterpret_cast<const float4*>(p) + q)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int k = k0 + 4 * q;
        xv[q] = make_float4(in && k < K ? p[4 * q] : 0.f, in && k + 1 < K ? p[4 * q + 1] : 0.f,
                            in && k + 2 < K ? p[4 * q + 2] : 0.f,
                            in && k + 3 < K ? p[4 * q + 3] : 0.f);
      }
    }
  };
  auto store = [&](int g) {
    bf16* dst = bt + (g & 1) * X_BUF + xh * 3 * X_BT;
    uint32_t p1[8], p2[8], p3[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      split3(xv[q].x, xv[q].y, p1[2 * q], p2[2 * q], p3[2 * q]);
      split3(xv[q].z, xv[q].w, p1[2 * q + 1], p2[2 * q + 1], p3[2 * q + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = tile_offset(xr, 8 * h);
      *reinterpret_cast<uint4*>(dst + at) =
          make_uint4(p1[4 * h], p1[4 * h + 1], p1[4 * h + 2], p1[4 * h + 3]);
      *reinterpret_cast<uint4*>(dst + X_BT + at) =
          make_uint4(p2[4 * h], p2[4 * h + 1], p2[4 * h + 2], p2[4 * h + 3]);
      *reinterpret_cast<uint4*>(dst + 2 * X_BT + at) =
          make_uint4(p3[4 * h], p3[4 * h + 1], p3[4 * h + 2], p3[4 * h + 3]);
    }
  };
  load(0);
  store(0);
  load(1);
  fence_proxy_async();
  __syncthreads();

  const int cA = wg * 64 + warp * 16 + gid;  // this thread's columns of the slice: cA, cA + 8
  float acc[X_BX / 2], sum[X_BX / 2];
  for (int g = 0; g < chunks; ++g) {
    const int c = g % NC;
    // the chunk's products, from zero into acc: per k16 step the five
    // smaller ones, then the largest; steps past KS read W's last
    // fragments against B's zeros, so no wgmma sits in a branch
    uint32_t a1[2][4], a2[2][4], a3[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4* f = reinterpret_cast<const float4*>(
          wf + ((size_t)min(2 * c + j, KS - 1) * X_THREADS + tid) * 8);
      const float4 lo4 = f[0], hi4 = f[1];
      split3(lo4.x, lo4.y, a1[j][0], a2[j][0], a3[j][0]);
      split3(lo4.z, lo4.w, a1[j][1], a2[j][1], a3[j][1]);
      split3(hi4.x, hi4.y, a1[j][2], a2[j][2], a3[j][2]);
      split3(hi4.z, hi4.w, a1[j][3], a2[j][3], a3[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* q1 = bt + (g & 1) * X_BUF + j * 3 * X_BT;
      const bf16* q2 = q1 + X_BT;
      const bf16* q3 = q2 + X_BT;
      WgmmaBf16<X_BX>::run(acc, a3[j], desc(q1), j > 0);
      WgmmaBf16<X_BX>::run(acc, a1[j], desc(q3), 1);
      WgmmaBf16<X_BX>::run(acc, a2[j], desc(q2), 1);
      WgmmaBf16<X_BX>::run(acc, a2[j], desc(q1), 1);
      WgmmaBf16<X_BX>::run(acc, a1[j], desc(q2), 1);
      WgmmaBf16<X_BX>::run(acc, a1[j], desc(q1), 1);
    }
    wgmma_commit();
    // the next chunk's B tiles while these products run (both warpgroups'
    // groups g - 1 read that buffer: done before the last barrier), and the
    // one after's loads
    if (g + 1 < chunks) {
      store(g + 1);
      load(g + 2);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // the chunk's sum, added in f32 (the tensor core's accumulation, chained
    // over the chunks of a tile, put values past 1e-5 of the f64 product)
#pragma unroll
    for (int i = 0; i < X_BX / 2; ++i) sum[i] = (c == 0 ? 0.f : sum[i]) + acc[i];
    if (c == NC - 1) {
      // xg (row n, column m) = sum of D[m][n] + bias[m]: per n8 group j,
      // rows 8 j + 2 tig (+1) of the tile; the 8 lanes of a tig write 8
      // neighbouring columns of a row (32 bytes)
      const int tile = blockIdx.y + g / NC * gridDim.y;
#pragma unroll
      for (int j = 0; j < X_BX / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = tile * X_BX + 8 * j + 2 * tig + e;
          if (r >= M) continue;
          float* row = out + (size_t)r * N + col0;
          if (col0 + cA < N) row[cA] = sum[4 * j + e] + bias[cA];
          if (col0 + cA + 8 < N) row[cA + 8] = sum[4 * j + 2 + e] + bias[cA + 8];
        }
      }
    }
    fence_proxy_async();  // the next chunk's B tiles, to the tensor cores ...
    __syncthreads();      // ... once every thread stored its part and read this chunk's
  }
}

// ---- the mma.sync kernel (f32 352 < E <= 452, bf16 past 544): 32 x 32 tiles

constexpr int THREADS = 256;  // 8 warps: 2 x 4 warps of 16 x 8
constexpr int NBM = 32, NBN = 32;

template <class T>
size_t narrow_smem(int K) {
  return (size_t)(K + 7) / 8 * (NBN / 8) * 32 * sizeof(uint4) + 2 * (size_t)NBM * K * sizeof(T);
}

// acc += a * b over one 8-deep step: 3xTF32 for f32; one TF32 product for
// bf16, whose small parts are 0
template <class T>
__device__ __forceinline__ void mma_step(float (&acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint32_t b0h, uint32_t b1h,
                                         uint32_t b0l, uint32_t b1l) {
  if constexpr (is_bf16<T>) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma(t, ah, b0h, b1h);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] += t[r];
  } else {
    mma3_add(acc, ah, al, b0h, b1h, b0l, b1l);
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
gru_input_proj_mma(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                   T* __restrict__ out, int M, int K, int N, bool vec, bool twice) {
  constexpr int NT = NBN / 8;
  extern __shared__ uint4 smem[];
  const int KS = (K + 7) / 8;
  uint4* wf = smem;                                   // [KS][NT][32]
  T* ring = reinterpret_cast<T*>(wf + KS * NT * 32);  // [2][NBM * K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / NT, wn = warp % NT;
  const int col0 = blockIdx.x * NBN;
  const int walkers = gridDim.y;
  const int m_tiles = (M + NBM - 1) / NBM;

  int tile = blockIdx.y;
  if (tile < m_tiles)
    copy_span(ring, x + (size_t)tile * NBM * K, min(NBM, M - tile * NBM) * K, vec, tid, THREADS);
  cp_async_commit();
  // W's column slice, split once: lane's (b0, b1) big and small parts of
  // fragment (k-step ks, column tile nt); zeros past K and past N
  for (int i = tid; i < KS * NT * 32; i += THREADS) {
    const int l = i & 31, nt = (i >> 5) % NT, ks = (i >> 5) / NT;
    const int n = col0 + nt * 8 + (l >> 2);
    const int k0 = ks * 8 + (l & 3), k1 = k0 + 4;
    uint32_t b0h, b0l, b1h, b1l;
    split(n < N && k0 < K ? ld(w[(size_t)k0 * N + n]) : 0.f, b0h, b0l);
    split(n < N && k1 < K ? ld(w[(size_t)k1 * N + n]) : 0.f, b1h, b1l);
    wf[i] = make_uint4(b0h, b1h, b0l, b1l);
  }
  const int c = col0 + wn * 8 + 2 * tig;
  const float bias0 = c < N ? ld(b[c]) : 0.f, bias1 = c + 1 < N ? ld(b[c + 1]) : 0.f;

  for (int it = 0; tile < m_tiles; ++it, tile += walkers) {
    cp_async_wait<0>();
    __syncthreads();
    const int next = tile + walkers;
    if (next < m_tiles)
      copy_span(ring + ((it + 1) & 1) * NBM * K, x + (size_t)next * NBM * K,
                min(NBM, M - next * NBM) * K, vec, tid, THREADS);
    cp_async_commit();
    const T* p0 = ring + (it & 1) * NBM * K + (wm * 16 + gid) * K;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      split_a(p0, p0 + 8 * K, ks, K, tig, ah, al);
      const uint4 f = wf[(ks * NT + wn) * 32 + lane];
      mma_step<T>(acc, ah, al, f.x, f.y, f.z, f.w);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile * NBM + wm * 16 + gid + 8 * h;
      if (r >= M) continue;
      if (c < N) out[(size_t)r * N + c] = io_from<T>(xg_value<T>(acc[2 * h], bias0, twice));
      if (c + 1 < N)
        out[(size_t)r * N + c + 1] = io_from<T>(xg_value<T>(acc[2 * h + 1], bias1, twice));
    }
  }
  cp_async_wait<0>();
}

// ---- the deep kernel (E > 452, past the mma.sync kernel's shared memory):
// fragments straight from global memory (L2), no shared memory, so any E;
// 64 x 64 tiles, 4 x 2 warps of 16 rows x 32 columns

constexpr int DBM = 64, DBN = 64;

template <class T>
__global__ void __launch_bounds__(THREADS)
gru_input_proj_deep(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                    T* __restrict__ out, int M, int K, int N, bool, bool twice) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * DBN + wn * 32;  // this warp's 4 column groups of 8
  const int m_tiles = (M + DBM - 1) / DBM;
  for (int tile = blockIdx.y; tile < m_tiles; tile += gridDim.y) {
    const int r0 = tile * DBM + wm * 16 + gid, r8 = r0 + 8;
    // rows past M read row 0 (zero rows would do as well): their outputs
    // are not stored
    const T* p0 = x + (size_t)(r0 < M ? r0 : 0) * K;
    const T* p8 = x + (size_t)(r8 < M ? r8 : 0) * K;
    float acc[4][4] = {};
    for (int ks = 0; ks < (K + 7) / 8; ++ks) {
      const int k0 = ks * 8 + tig, k1 = k0 + 4;
      const bool v0 = k0 < K, v1 = k1 < K;
      uint32_t ah[4], al[4];
      split(v0 ? ld(p0[k0]) : 0.f, ah[0], al[0]);
      split(v0 ? ld(p8[k0]) : 0.f, ah[1], al[1]);
      split(v1 ? ld(p0[k1]) : 0.f, ah[2], al[2]);
      split(v1 ? ld(p8[k1]) : 0.f, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 8 * j + gid;
        uint32_t b0h, b0l, b1h, b1l;
        split(n < N && v0 ? ld(w[(size_t)k0 * N + n]) : 0.f, b0h, b0l);
        split(n < N && v1 ? ld(w[(size_t)k1 * N + n]) : 0.f, b1h, b1l);
        mma_step<T>(acc[j], ah, al, b0h, b1h, b0l, b1l);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r8 : r0;
        if (r >= M) continue;
        if (c < N) out[(size_t)r * N + c] = io_from<T>(xg_value<T>(acc[j][2 * h], ld(b[c]), twice));
        if (c + 1 < N)
          out[(size_t)r * N + c + 1] =
              io_from<T>(xg_value<T>(acc[j][2 * h + 1], ld(b[c + 1]), twice));
      }
    }
  }
}

template <class Kernel, class T>
int launch(Kernel kernel, int threads, size_t smem, int bm, int bn, int per_block, const T* x,
           const T* w, const T* b, T* out, int M, int K, int N, cudaStream_t stream,
           bool twice = false) {
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
  const int col_tiles = (N + bn - 1) / bn;
  const int m_tiles = (M + bm - 1) / bm;
  const int resident = std::max(per_sm, 1) * sms;
  // blocks per column tile; each block walks `per_block` row tiles at once
  const int walkers = std::max(1, std::min((m_tiles + per_block - 1) / per_block,
                                           (resident + col_tiles - 1) / col_tiles));
  // 16-byte copies need x 16-byte aligned; each tile starts bm*K elements
  // (4 bm K or 2 bm K bytes, bm a multiple of 32) further on
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  kernel<<<dim3(col_tiles, walkers), threads, smem, stream>>>(x, w, b, out, M, K, N, vec,
                                                              twice);
  return static_cast<int>(cudaGetLastError());
}

// the mma.sync kernel, or past its shared memory the deep one
template <class T>
int run_narrow(const T* x, const T* w, const T* b, T* out, int M, int K, int N, cudaStream_t s,
               bool twice) {
  if (narrow_smem<T>(K) <= SMEM_LIMIT)
    return launch(gru_input_proj_mma<T>, THREADS, narrow_smem<T>(K), NBM, NBN, 1, x, w, b, out,
                  M, K, N, s, twice);
  return launch(gru_input_proj_deep<T>, THREADS, 0, DBM, DBN, 1, x, w, b, out, M, K, N, s,
                twice);
}

// the largest unit (16, 8, 4 bytes; 2: none) that every chunk's row start
// of x is aligned to: x's address, its row stride 2K and the chunk offsets
// (multiples of 2 KC = 128 bytes)
int stream_unit(const bf16* x, int K) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | (uintptr_t)(2 * K);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2;
}

template <int U>
int run_stream(const bf16* x, const bf16* w, const bf16* b, bf16* out, int M, int K, int N,
               cudaStream_t s, bool twice) {
  return launch(gru_input_proj_bf16_stream<U>, WG * S_WGS, stream_smem(K), BM, BN, S_WGS, x, w,
                b, out, M, K, N, s, twice);
}

int run(const float* x, const float* w, const float* b, float* out, int M, int K, int N,
        void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide_smem(K) <= SMEM_LIMIT)
    return launch(gru_input_proj_wgmma, WG * WGS, wide_smem(K), BM, BN, WGS, x, w, b, out, M, K,
                  N, s);
  if (xt_smem(K) <= SMEM_LIMIT) {
    if (K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
      return launch(gru_input_proj_xt<true>, X_THREADS, xt_smem(K), X_BX, X_BM, 1, x, w, b, out,
                    M, K, N, s);
    return launch(gru_input_proj_xt<false>, X_THREADS, xt_smem(K), X_BX, X_BM, 1, x, w, b, out,
                  M, K, N, s);
  }
  return run_narrow(x, w, b, out, M, K, N, s, false);
}

int run(const bf16* x, const bf16* w, const bf16* b, bf16* out, int M, int K, int N,
        void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool twice = K > ROUND_ONCE_MAX_E;
  if (bf16_smem(K) <= SMEM_LIMIT) {
    if (K % 2 == 0)
      return launch(gru_input_proj_bf16_wgmma<true>, WG * WGS, bf16_smem(K), BM, BN, WGS, x, w,
                    b, out, M, K, N, s, twice);
    return launch(gru_input_proj_bf16_wgmma<false>, WG * WGS, bf16_smem(K), BM, BN, WGS, x, w, b,
                  out, M, K, N, s, twice);
  }
  if (stream_smem(K) <= SMEM_LIMIT) {
    switch (stream_unit(x, K)) {
      case 16: return run_stream<16>(x, w, b, out, M, K, N, s, twice);
      case 8: return run_stream<8>(x, w, b, out, M, K, N, s, twice);
      case 4: return run_stream<4>(x, w, b, out, M, K, N, s, twice);
      default: return run_stream<2>(x, w, b, out, M, K, N, s, twice);
    }
  }
  return run_narrow(x, w, b, out, M, K, N, s, twice);
}

}  // namespace

// x (M, K), w (K, N), b (N,), out (M, N): contiguous, on the device; f32
// (gru_input_proj) or bf16 (gru_input_proj_bf16).  Launches on `stream`
// and returns the launch's cudaError_t (0 = success).
extern "C" int gru_input_proj(const float* x, const float* w, const float* b, float* out,
                              int M, int K, int N, void* stream) {
  return run(x, w, b, out, M, K, N, stream);
}

extern "C" int gru_input_proj_bf16(const bf16* x, const bf16* w, const bf16* b, bf16* out,
                                   int M, int K, int N, void* stream) {
  return run(x, w, b, out, M, K, N, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
