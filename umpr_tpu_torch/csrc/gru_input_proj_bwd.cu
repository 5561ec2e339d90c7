// K4 gru_input_proj_bwd: the weight gradients of K1's input projection.
//
//   dW_ih (E, 6H) = x^T (E, M) @ dxg (M, 6H),   db_ih (6H) = sum_m dxg[m]
//
// M = N*L sentence-row tokens.  dxg comes from K3 in true time for both
// directions, and K1 read x in true time for both, so x is used as it is:
// nothing is stacked or flipped.  f32 in, f32 out, f32-accurate products
// (3xTF32, see tf32x3.cuh) with f32 accumulation.
//
// Replaces the TPU kernel B4 of umpr_tpu/ops/gru_pallas.py,
// _pallas_project_bwd / _proj_bwd_kernel (pallas_call at :394), with
// emit_dxc=False: the GloVe table is frozen, so no input gradient is made.
// The TPU accumulated dW over a sequential grid in VMEM scratch, its f32
// products at Precision.HIGHEST.  Here the rows are split into a fixed
// number of chunks (split-K): block (column tile, E tile, chunk) reduces
// its chunk into one dW and one db partial, and a second kernel of the
// same entry point sums the partials in chunk order (no float atomics, the
// same bits on every run).  The chunk count is the wrapper's function of
// M alone (ops/gru_cuda.py proj_bwd_chunks), so the bits do not depend on
// the card either.
//
// What bounds it on an H100: at the UMPR-R shapes (M=51,200, E=50,
// 6H=384) it reads 88.9 MB (x 10.2 MB, dxg 78.6 MB) and does 2.0 GFLOP:
// 26.5 us of HBM traffic, against 29 us for the products at the 67 TFLOP/s
// f32 peak of the CUDA cores.  As 3xTF32 on wgmma the products are under
// the byte floor, so the design streams dxg once:
//   - the product is oriented as dW^T (6H, E) = dxg^T x, so E is the
//     wgmma's n-side and is padded only to a multiple of 8 (n56 at E = 50;
//     E tiles of 64 past that, one block each); a block is two warpgroups,
//     64 columns of 6H each, so 128 per block;
//   - each block streams its chunk's rows of dxg (its 128 columns) and x
//     through a three-stage cp.async ring of 32-row stages; the dxg stage
//     rows are padded to 136 floats, so the A fragment loads' four rows land
//     8 banks apart (no conflicts); each dxg element is read once from HBM
//     (x is read by the 3 column-tile blocks of a chunk, which run side by
//     side and share it in L2); x's stage rows are one contiguous span up
//     to E = 384, and past that, where the span outgrows the shared memory,
//     only the block's 64 columns of each row (any E);
//   - A (dxg^T) is loaded and split in registers by its own thread; x, the
//     B operand both warpgroups share, is split once per stage into the
//     K-major big and small tiles wgmma reads (TF32 takes no other), four
//     rows to a 16-byte store, in two buffers: a stage's products run on
//     the tensor core while the next stage is loaded and split;
//   - rows past the chunk's end, and x's columns past E, are zeroed by
//     selects, never by multiplying (as _proj_bwd_kernel does);
//   - the wgmmas (3 per k-step) go to two accumulators, the small cross
//     terms and big*big, so two chains run side by side; each chain runs
//     over the whole chunk and the two are added in f32 at its end.  The
//     tensor core's accumulation rounds more coarsely than an f32 add, so
//     the error grows with the chain's length: the cap on a chunk's rows
//     (ops/gru_cuda.py PROJ_BWD_MAX_ROWS, 1,216 rows = 152 k-steps) is what
//     bounds it (flushing each stage into an f32 sum spilled registers);
//   - db comes from the same A fragments, in plain f32 adds in a fixed
//     order, and a butterfly over the 4 lanes of a row group.
// The reduce kernel sums the partials (6.5 MB at 51,200 rows, 85 chunks),
// four lanes to an entry.
//
// bf16 IO (gru_input_proj_bwd_bf16, --compute_dtype bfloat16): x and dxg
// bf16, dW and db f32 sums of the bf16 values, as the TPU kernel's bf16
// path accumulates in f32.  At the UMPR-R shapes it reads 44.4 MB: 13.3 us
// at 3.35 TB/s, against 2.0 GFLOP of bf16 products (2 us at 989 TFLOP/s).
// Its own kernel (gru_input_proj_bwd_bf16_kernel), the same split-K over
// chunks and the same reduce kernel, with:
//   - native bf16 wgmma m64nNk16 (wgmma_bf16.cuh) with one f32
//     accumulator per chunk: a bf16 product is exact in f32, so there is
//     no split and no second chain.  A k-step takes 16 rows, so a chain is
//     rows/16 steps, half as long as f32's rows/8 over the same rows: the
//     chunks may be twice as long under the same chain length
//     (ops/gru_cuda.py PROJ_BWD_BF16_MAX_ROWS, 2,432 rows = 152 steps).
//     The chunk count stays f32's (about 88, 80 of 640 rows at 51,200):
//     fewer, longer chunks cut the partials' traffic but left SMs idle,
//     and the blocks of 80 chunks x 3 column tiles run as one wave of two
//     an SM (ops/gru_cuda.py has the times).  Summing 4 chunks' partials
//     in a thread block cluster (distributed shared memory) cut the
//     reduce kernel's time by a third but slowed this kernel by 70%
//     (PERF.md section 6), so each chunk writes its own;
//   - stages of 64 rows in flight: dxg's rows (its 128 columns) by 16-byte
//     cp.async into rows 136 bf16 apart, the rows past the chunk's end
//     zero-filled by the copy; x's rows as one span (rows of E bf16, 100
//     bytes at E = 50, which no wgmma layout takes as they land);
//   - A = dxg^T straight from the stage: ldmatrix .trans hands each lane
//     its fragment of the transpose, four 8x8 matrices a k-step, the 16-
//     byte rows of one matrix in 8 distinct bank groups (272-byte stride);
//     db sums the same registers in f32, in a fixed order;
//   - B = x, re-laid once per stage (by all threads, behind the barrier
//     the stage needs anyway) into the K-major tiles wgmma reads: eight
//     rows of one column to a 16-byte store, zeros by selects past the
//     chunk's rows and past E; two buffers, so the products of one stage
//     run while the next is re-laid.
// Two blocks an SM (each 128 registers a thread, no spills) is what sets
// the stages: up to E = 64 (one E tile) x's rows are copied whole, with
// four stages in flight up to E = 52 and two past it (four stages fit two
// blocks an SM up to E = 58 on paper, but at 58 they took 11% longer than
// three); past E = 64 each block copies only its E tile of x, as the f32
// kernel does (any E), with two stages: whole rows there are copied by
// every E tile's block, and more stages leave room for one block an SM
// (chip_smoke.py --steps, K4_STEPS; PERF.md section 6).  An E tile's rows
// at E % 8 != 0 are copied 2 bytes at a time, a stage's loads all issued
// before its first store.

#include <algorithm>
#include <cstdint>

#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 256;  // 2 warpgroups
constexpr int BG = 128;       // columns of dxg (rows of dW^T) per block: 64 per warpgroup
constexpr int EW = 64;        // columns of E per block (wgmma n: 64, or 56 for a last tile)
constexpr int STEP = 32;      // rows per stage (ops/gru_cuda.py PROJ_BWD_STEP)
constexpr int STAGES = 3;
constexpr int GS = BG + 8;    // dxg stage row stride, in floats
constexpr int XT = EW * 8;    // floats of one k-step's x tile (big or small)
constexpr int XB = STEP / 8 * 2 * XT;  // floats of one stage's split x

constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on Hopper (227 KB)

// a stage's x rows are copied whole (one contiguous span, row stride E)
// where that fits, else as the block's EW columns only (row stride EW)
size_t smem_bytes(int x_stride) {
  return ((size_t)2 * XB + (size_t)STAGES * STEP * (GS + x_stride)) * sizeof(float);
}

// A block's partials: dW^T (g, e) of this thread's accumulator -> the dW
// partial [chunk][e][g]; db of its rows g, g + 8: the four lanes of a row
// group hold the k residues of every step, and a butterfly adds them in the
// same order in every lane.
template <int N>
__device__ __forceinline__ void store_partials(const float (&sum)[N / 2], const float (&db_acc)[2],
                                               float* __restrict__ dw_part,
                                               float* __restrict__ db_part, int E, int G, int g,
                                               int e0, int tig, int chunk) {
  float* dw = dw_part + (size_t)chunk * E * G;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int e = e0 + j * 8 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = g + 8 * (r >> 1), er = e + (r & 1);
      if (gr < G && er < E) dw[(size_t)er * G + gr] = sum[4 * j + r];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = db_acc[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (blockIdx.y == 0 && tig == 0 && g + 8 * h < G) db_part[(size_t)chunk * G + g + 8 * h] = v;
  }
}

// the block's stages: N = 8 * (column groups of E), 64 or 56
template <int N>
__device__ __forceinline__ void reduce_chunk(const float* __restrict__ x,
                                             const float* __restrict__ dxg,
                                             float* __restrict__ dw_part,
                                             float* __restrict__ db_part, int M, int E, int G,
                                             int rows_per_chunk, int XS, bool vec_x,
                                             bool vec_g, float* smem) {
  constexpr int PER = 4;  // floats of a 16-byte copy
  float* xb = smem;                   // [2][STEP / 8][big, small][XT]
  float* gs = xb + 2 * XB;            // [STAGES][STEP][GS]
  float* xs = gs + STAGES * STEP * GS;  // [STAGES][STEP * XS]
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int g0 = blockIdx.x * BG;
  const int e0 = blockIdx.y * EW;
  const int chunk = blockIdx.z;
  const int m_begin = min(M, chunk * rows_per_chunk);
  const int m_end = min(M, m_begin + rows_per_chunk);
  const int n_stages = (m_end - m_begin + STEP - 1) / STEP;

  auto load = [&](int s) {
    const int m0 = m_begin + s * STEP;
    const int rows = min(STEP, m_end - m0);
    float* gd = gs + (s % STAGES) * STEP * GS;
    const float* src = dxg + (size_t)m0 * G + g0;
    if (vec_g) {  // G % PER == 0: a 16-byte group is wholly inside or past G
      for (int i = tid; i < rows * (BG / PER); i += THREADS) {
        const int r = i / (BG / PER), c = PER * (i % (BG / PER));
        if (g0 + c < G) cp_async16(gd + r * GS + c, src + (size_t)r * G + c);
      }
    } else {
      for (int i = tid; i < rows * BG; i += THREADS) {
        const int r = i / BG, c = i % BG;
        if (g0 + c >= G) continue;
        cp_async4(gd + r * GS + c, src + (size_t)r * G + c);
      }
    }
    float* xd = xs + (s % STAGES) * STEP * XS;
    if (XS == E) {
      copy_span(xd, x + (size_t)m0 * E, rows * E, vec_x, tid, THREADS);
    } else {  // columns e0 .. e0 + EW of each row; vec_x: E % PER == 0
      const int ew = min(EW, E - e0);
      const float* src = x + (size_t)m0 * E + e0;
      const int q = vec_x ? PER : 1;
      for (int i = tid; i < rows * (EW / q); i += THREADS) {
        const int r = i / (EW / q), c = q * (i % (EW / q));
        if (c >= ew) continue;
        if (vec_x)
          cp_async16(xd + r * EW + c, src + (size_t)r * E + c);
        else
          cp_async4(xd + r * EW + c, src + (size_t)r * E + c);
      }
    }
  };

  // lo (the two small cross terms) and hi (big*big) over the whole chunk:
  // two chains the tensor core runs side by side, never waited for but to
  // reuse a register set or a buffer
  float lo[N / 2], hi[N / 2];
  // db of this thread's rows g, g + 8 over its fragments' rows of dxg,
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

    const int rows = min(STEP, m_end - (m_begin + s * STEP));
    const float* gt = gs + (s % STAGES) * STEP * GS;
    // x, the B operand both warpgroups share, split once into its big and
    // small tiles (two buffers: stage s - 1's may still be read); zeros on
    // rows past the chunk and columns past E.  Item i: the 4 stage rows
    // 4 q .. 4 q + 3 of column n, one 16-byte store per part.
    float* xbs = xb + (s & 1) * XB;
    const float* xt = xs + (s % STAGES) * STEP * XS + (XS == E ? e0 : 0);
    for (int i = tid; i < STEP / 4 * N; i += THREADS) {
      const int n = i % N, q = i / N;
      const bool in = e0 + n < E;
      uint32_t big[4], small[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(in && 4 * q + r < rows ? xt[(4 * q + r) * XS + n] : 0.f, big[r], small[r]);
      float* tb = xbs + (q >> 1) * 2 * XT + b_offset(n, (4 * q) & 7);
      *reinterpret_cast<uint4*>(tb) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(tb + XT) = make_uint4(small[0], small[1], small[2], small[3]);
    }
    fence_proxy_async();
    __syncthreads();

    // A = dxg^T: A[g][k] = dxg[k][g], this thread's rows g, g + 8; two
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
      split(a0, ah[0], al[0]);
      split(a1, ah[1], al[1]);
      split(a2, ah[2], al[2]);
      split(a3, ah[3], al[3]);
    };
    auto issue = [&](int ks, const uint32_t(&ah)[4], const uint32_t(&al)[4]) {
      const float* tb = xbs + ks * 2 * XT;
      const int add = s > 0 || ks > 0;
      wgmma_fence();
      Wgmma<N>::run(lo, al, b_desc(tb), add);
      Wgmma<N>::run(hi, ah, b_desc(tb), add);
      Wgmma<N>::run(lo, ah, b_desc(tb + XT), 1);
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
    // (its split pass writes the other x buffer)
  }
  wgmma_wait<0>();
  fence_regs(lo);
  fence_regs(hi);
  float sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = n_stages > 0 ? lo[i] + hi[i] : 0.f;
  cp_async_wait<0>();

  store_partials<N>(sum, db_acc, dw_part, db_part, E, G, g0 + wg * 64 + warp * 16 + gid, e0,
                    tig, chunk);
}

__global__ void __launch_bounds__(THREADS, 2)
gru_input_proj_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dxg,
                          float* __restrict__ dw_part, float* __restrict__ db_part, int M,
                          int E, int G, int rows_per_chunk, int XS, bool vec_x, bool vec_g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (E - (int)blockIdx.y * EW > 56)
    reduce_chunk<64>(x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x, vec_g, smem);
  else
    reduce_chunk<56>(x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x, vec_g, smem);
}

// ---- bf16 IO: native bf16 wgmma (see the header)

constexpr int B16_STEP = 64;   // rows per stage (ops/gru_cuda.py PROJ_BWD_BF16_STEP)
constexpr int B16_STAGES = 4;  // stages in flight up to B16_FOUR_STAGES_MAX_E
constexpr int B16_FEW_STAGES = 2;  // stages in flight past it
constexpr int B16_FOUR_STAGES_MAX_E = 52;  // two blocks an SM, 4 KB to spare (see the header)
constexpr int B16_GS = BG + 8;  // dxg stage row stride, in bf16 (272 bytes)
constexpr int B16_XT = EW * 16;  // bf16 of one k16 step's x tile
constexpr int B16_XB = B16_STEP / 16 * B16_XT;  // bf16 of one stage's x tiles

template <int STAGES>
size_t bf16_smem(int x_stride) {
  return ((size_t)2 * B16_XB + (size_t)STAGES * B16_STEP * (B16_GS + x_stride)) * sizeof(bf16);
}

template <int N, int STAGES>
__device__ __forceinline__ void reduce_chunk_bf16(const bf16* __restrict__ x,
                                                  const bf16* __restrict__ dxg,
                                                  float* __restrict__ dw_part,
                                                  float* __restrict__ db_part, int M, int E,
                                                  int G, int rows_per_chunk, int XS, bool vec_x,
                                                  bool vec_g, bf16* smem) {
  using namespace wgmma_bf16;
  bf16* xb = smem;                                  // [2][B16_XB], K-major x tiles
  bf16* gs = xb + 2 * B16_XB;                  // [STAGES][B16_STEP][B16_GS]
  bf16* xs = gs + STAGES * B16_STEP * B16_GS;  // [STAGES][B16_STEP * XS]
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int g0 = blockIdx.x * BG;
  const int e0 = blockIdx.y * EW;
  const int chunk = blockIdx.z;
  const int m_begin = min(M, chunk * rows_per_chunk);
  const int m_end = min(M, m_begin + rows_per_chunk);
  const int n_stages = (m_end - m_begin + B16_STEP - 1) / B16_STEP;

  auto load = [&](int s) {
    const int m0 = m_begin + s * B16_STEP;
    const int rows = min(B16_STEP, m_end - m0);
    bf16* gd = gs + (s % STAGES) * B16_STEP * B16_GS;
    const bf16* src = dxg + (size_t)m0 * G + g0;
    // rows past the chunk's end are zero-filled: A's zeros by the copy,
    // never by multiplying, and db adds exact zeros
    if (vec_g) {  // G % 8 == 0: a 16-byte group is wholly inside or past G
      for (int i = tid; i < B16_STEP * (BG / 8); i += THREADS) {
        const int r = i / (BG / 8), c = 8 * (i % (BG / 8));
        if (g0 + c >= G) continue;
        if (r < rows)
          cp_async16(gd + r * B16_GS + c, src + (size_t)r * G + c);
        else
          cp_async16_zfill(gd + r * B16_GS + c, src, 0);
      }
    } else {  // no 2-byte cp.async: plain copies, ordered by the stage's barrier
      for (int i = tid; i < B16_STEP * BG; i += THREADS) {
        const int r = i / BG, c = i % BG;
        if (g0 + c < G)
          gd[r * B16_GS + c] = r < rows ? src[(size_t)r * G + c] : __float2bfloat16(0.f);
      }
    }
    bf16* xd = xs + (s % STAGES) * B16_STEP * XS;
    if (XS == E) {
      copy_span(xd, x + (size_t)m0 * E, rows * E, vec_x, tid, THREADS);
    } else if (vec_x) {  // columns e0 .. e0 + EW of each row, E % 8 == 0
      const int ew = min(EW, E - e0);
      const bf16* xsrc = x + (size_t)m0 * E + e0;
      for (int i = tid; i < rows * (EW / 8); i += THREADS) {
        const int r = i / (EW / 8), c = 8 * (i % (EW / 8));
        if (c < ew) cp_async16(xd + r * EW + c, xsrc + (size_t)r * E + c);
      }
    } else {  // the same 2 bytes at a time: every load issued before the
              // first store, so that their latencies overlap
      constexpr int PER_THREAD = B16_STEP * EW / THREADS;
      const int ew = min(EW, E - e0);
      const bf16* xsrc = x + (size_t)m0 * E + e0;
      bf16 v[PER_THREAD];
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) {
        const int i = tid + j * THREADS, r = i / EW, c = i % EW;
        v[j] = r < rows && c < ew ? xsrc[(size_t)r * E + c] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j) xd[tid + j * THREADS] = v[j];
    }
  };

  // one f32 chain over the whole chunk, never waited for but to reuse a
  // register set or a buffer
  float acc[N / 2];
  // db of this thread's rows g, g + 8, summed from the A fragments in
  // plain f32 adds, in a fixed order
  float db_acc[2] = {0.f, 0.f};
  // this lane's ldmatrix row: matrix lane / 8 is (k 0-7 | 8-15) x (g 0-7 | 8-15)
  const int mi = lane >> 3;
  const int la = ((lane & 7) + 8 * (mi >> 1)) * B16_GS + wg * 64 + warp * 16 + 8 * (mi & 1);

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

    const int rows = min(B16_STEP, m_end - (m_begin + s * B16_STEP));
    // x, the B operand both warpgroups share, re-laid once into K-major
    // tiles (two buffers: stage s - 1's may still be read); zeros on rows
    // past the chunk and columns past E.  Item i: the 8 stage rows
    // 8 q .. 8 q + 7 of column n, one 16-byte store.
    bf16* xbs = xb + (s & 1) * B16_XB;
    const bf16* xt = xs + (s % STAGES) * B16_STEP * XS + (XS == E ? e0 : 0);
    for (int i = tid; i < B16_STEP / 8 * N; i += THREADS) {
      const int n = i % N, q = i / N;
      const bool in = e0 + n < E;
      uint32_t p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 8 * q + 2 * u;
        p[u] = pack(in && r < rows ? bits(xt[r * XS + n]) : 0u,
                    in && r + 1 < rows ? bits(xt[(r + 1) * XS + n]) : 0u);
      }
      *reinterpret_cast<uint4*>(xbs + (q >> 1) * B16_XT + tile_offset(n, (q & 1) * 8)) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
    fence_proxy_async();
    __syncthreads();

    const bf16* ga = gs + (s % STAGES) * B16_STEP * B16_GS + la;
    auto load_a = [&](int ks, uint32_t(&a)[4]) {
      ldsm_x4_trans(a, ga + ks * 16 * B16_GS);
      db_acc[0] += lo_f(a[0]);  // row g: k = 2t, 2t + 1, 2t + 8, 2t + 9, in order
      db_acc[0] += hi_f(a[0]);
      db_acc[0] += lo_f(a[2]);
      db_acc[0] += hi_f(a[2]);
      db_acc[1] += lo_f(a[1]);  // row g + 8
      db_acc[1] += hi_f(a[1]);
      db_acc[1] += lo_f(a[3]);
      db_acc[1] += hi_f(a[3]);
    };
    auto issue = [&](int ks, const uint32_t(&a)[4]) {
      wgmma_fence();
      WgmmaBf16<N>::run(acc, a, desc(xbs + ks * B16_XT), s > 0 || ks > 0);
      wgmma_commit();
    };
    uint32_t a0[4], a1[4];
    wgmma_wait<1>();  // the last stage's step 2 is done with set 0
    load_a(0, a0);
#pragma unroll
    for (int ks = 0; ks < B16_STEP / 16; ks += 2) {
      issue(ks, a0);
      wgmma_wait<1>();  // step ks - 1 is done with set 1
      load_a(ks + 1, a1);
      issue(ks + 1, a1);
      if (ks + 2 < B16_STEP / 16) {
        wgmma_wait<1>();  // step ks is done with set 0
        load_a(ks + 2, a0);
      }
    }
    // the last steps stay in flight while the next stage is loaded and
    // re-laid (into the other x buffer)
  }
  wgmma_wait<0>();
  fence_regs(acc);
  float sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = n_stages > 0 ? acc[i] : 0.f;
  cp_async_wait<0>();
  store_partials<N>(sum, db_acc, dw_part, db_part, E, G, g0 + wg * 64 + warp * 16 + gid, e0,
                    tig, chunk);
}

template <int STAGES>
__global__ void __launch_bounds__(THREADS, 2)
gru_input_proj_bwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dxg,
                               float* __restrict__ dw_part, float* __restrict__ db_part, int M,
                               int E, int G, int rows_per_chunk, int XS, bool vec_x,
                               bool vec_g) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  if (E - (int)blockIdx.y * EW > 56)
    reduce_chunk_bf16<64, STAGES>(x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x,
                                  vec_g, smem);
  else
    reduce_chunk_bf16<56, STAGES>(x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x,
                                  vec_g, smem);
}

// dw (E, G) = the sum over chunks of dw_part[c], db (G) likewise.  Four
// lanes share an entry: lane j sums the chunks j, j + 4, ... in order, and
// a butterfly adds the four sums as (s0 + s1) + (s2 + s3), a fixed order.
constexpr int REDUCE_LANES = 4;

__global__ void __launch_bounds__(THREADS)
gru_input_proj_bwd_reduce(const float* __restrict__ dw_part, const float* __restrict__ db_part,
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

// the main kernel over (column tile, E tile, chunk), with x's stage rows
// XS apart (E: whole rows, EW: the block's E tile) in `smem` bytes of
// shared memory, then the reduce kernel
template <class T, class Kernel>
int launch(Kernel kernel, int XS, size_t smem, int step, const T* x, const T* dxg,
           float* dw_part, float* db_part, float* dw, float* db, int M, int E, int G,
           int rows_per_chunk, void* stream) {
  if (G == 0) return 0;
  if (rows_per_chunk <= 0 || rows_per_chunk % step != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int PER = 16 / sizeof(T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = M > 0 ? (M + rows_per_chunk - 1) / rows_per_chunk : 1;
  const int e_tiles = std::max(1, (E + EW - 1) / EW);
  // 16-byte copies: x's stages start at multiples of 32 rows (32*E
  // elements, a multiple of 16 bytes); an E tile's rows start at multiples
  // of E (plus e0, a multiple of 64)
  const bool vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (XS == E || E % PER == 0);
  const bool vec_g = (reinterpret_cast<uintptr_t>(dxg) & 15) == 0 && G % PER == 0;
  kernel<<<dim3((G + BG - 1) / BG, e_tiles, chunks), THREADS, smem, s>>>(
      x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x, vec_g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n = (E * G + G) * REDUCE_LANES;
  gru_input_proj_bwd_reduce<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      dw_part, db_part, dw, db, chunks, E * G, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, E), dxg (M, G) -> dw (E, G), db (G) f32: contiguous, on the
// device; x and dxg f32 (gru_input_proj_bwd) or bf16
// (gru_input_proj_bwd_bf16).  dw_part (chunks, E, G) and db_part (chunks,
// G) are f32 scratch, with chunks = ceil(M / rows_per_chunk) (1 when M =
// 0) and rows_per_chunk a positive multiple of 32 (f32) or 64 (bf16:
// ops/gru_cuda.py proj_bwd_chunks, proj_bwd_bf16_chunks).  Launches two kernels
// on `stream` and returns the first failure's cudaError_t (0 = success).
extern "C" int gru_input_proj_bwd(const float* x, const float* dxg, float* dw_part,
                                  float* db_part, float* dw, float* db, int M, int E, int G,
                                  int rows_per_chunk, void* stream) {
  // whole x rows where they fit (up to E = 384); past that each block
  // copies its E tile
  const int XS = smem_bytes(E) <= SMEM_LIMIT ? E : EW;
  return launch(gru_input_proj_bwd_kernel, XS, smem_bytes(XS), STEP, x, dxg, dw_part, db_part,
                dw, db, M, E, G, rows_per_chunk, stream);
}

extern "C" int gru_input_proj_bwd_bf16(const bf16* x, const bf16* dxg, float* dw_part,
                                       float* db_part, float* dw, float* db, int M, int E, int G,
                                       int rows_per_chunk, void* stream) {
  // up to E = 64 whole x rows, four stages in flight up to E = 52 and two
  // past it; past E = 64 each block's E tile of x, two stages
  if (E <= B16_FOUR_STAGES_MAX_E)
    return launch(gru_input_proj_bwd_bf16_kernel<B16_STAGES>, E, bf16_smem<B16_STAGES>(E),
                  B16_STEP, x, dxg, dw_part, db_part, dw, db, M, E, G, rows_per_chunk, stream);
  const int XS = E <= EW ? E : EW;
  return launch(gru_input_proj_bwd_bf16_kernel<B16_FEW_STAGES>, XS,
                bf16_smem<B16_FEW_STAGES>(XS), B16_STEP, x, dxg, dw_part, db_part, dw, db, M, E,
                G, rows_per_chunk, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
