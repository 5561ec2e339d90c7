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
// are read as bf16 (and staged as bf16), dW and db are f32 sums, as the
// TPU kernel's bf16 path accumulates in f32; a bf16 value is exact in
// TF32, so each k-step is one TF32 wgmma (big*big) with no rounding.

#include <algorithm>

#include "tf32x3.cuh"

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

// a stage's x rows are copied whole (one contiguous span, row stride E)
// where that fits, else as the block's EW columns only (row stride EW)
template <class T>
size_t smem_bytes(int x_stride) {
  return (size_t)2 * XB * sizeof(float) + (size_t)STAGES * STEP * (GS + x_stride) * sizeof(T);
}

// the block's stages: N = 8 * (column groups of E), 64 or 56
template <int N, class T>
__device__ __forceinline__ void reduce_chunk(const T* __restrict__ x, const T* __restrict__ dxg,
                                             float* __restrict__ dw_part,
                                             float* __restrict__ db_part, int M, int E, int G,
                                             int rows_per_chunk, int XS, bool vec_x,
                                             bool vec_g, float* smem) {
  constexpr int NG = N / 8;
  constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte copy
  float* xb = smem;                               // [2][STEP / 8][big, small][XT]
  T* gs = reinterpret_cast<T*>(xb + 2 * XB);      // [STAGES][STEP][GS]
  T* xs = gs + STAGES * STEP * GS;                // [STAGES][STEP * XS]
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
    T* gd = gs + (s % STAGES) * STEP * GS;
    const T* src = dxg + (size_t)m0 * G + g0;
    if (vec_g) {  // G % PER == 0: a 16-byte group is wholly inside or past G
      for (int i = tid; i < rows * (BG / PER); i += THREADS) {
        const int r = i / (BG / PER), c = PER * (i % (BG / PER));
        if (g0 + c < G) cp_async16(gd + r * GS + c, src + (size_t)r * G + c);
      }
    } else {
      for (int i = tid; i < rows * BG; i += THREADS) {
        const int r = i / BG, c = i % BG;
        if (g0 + c >= G) continue;
        if constexpr (is_bf16<T>)
          gd[r * GS + c] = src[(size_t)r * G + c];  // no 2-byte cp.async
        else
          cp_async4(gd + r * GS + c, src + (size_t)r * G + c);
      }
    }
    T* xd = xs + (s % STAGES) * STEP * XS;
    if (XS == E) {
      copy_span(xd, x + (size_t)m0 * E, rows * E, vec_x, tid, THREADS);
    } else {  // columns e0 .. e0 + EW of each row; vec_x: E % PER == 0
      const int ew = min(EW, E - e0);
      const T* src = x + (size_t)m0 * E + e0;
      const int q = vec_x ? PER : 1;
      for (int i = tid; i < rows * (EW / q); i += THREADS) {
        const int r = i / (EW / q), c = q * (i % (EW / q));
        if (c >= ew) continue;
        if (vec_x)
          cp_async16(xd + r * EW + c, src + (size_t)r * E + c);
        else if constexpr (is_bf16<T>)
          xd[r * EW + c] = src[(size_t)r * E + c];
        else
          cp_async4(xd + r * EW + c, src + (size_t)r * E + c);
      }
    }
  };

  // lo (the two small cross terms) and hi (big*big) over the whole chunk:
  // two chains the tensor core runs side by side, never waited for but to
  // reuse a register set or a buffer
  float lo[N / 2], hi[N / 2];
  if constexpr (is_bf16<T>) {  // no cross terms: lo stays 0
#pragma unroll
    for (int i = 0; i < N / 2; ++i) lo[i] = 0.f;
  }
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
    const T* gt = gs + (s % STAGES) * STEP * GS;
    // x, the B operand both warpgroups share, split once into its big and
    // small tiles (two buffers: stage s - 1's may still be read); zeros on
    // rows past the chunk and columns past E.  Item i: the 4 stage rows
    // 4 q .. 4 q + 3 of column n, one 16-byte store per part.
    float* xbs = xb + (s & 1) * XB;
    const T* xt = xs + (s % STAGES) * STEP * XS + (XS == E ? e0 : 0);
    for (int i = tid; i < STEP / 4 * N; i += THREADS) {
      const int n = i % N, q = i / N;
      const bool in = e0 + n < E;
      uint32_t big[4], small[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(in && 4 * q + r < rows ? ld(xt[(4 * q + r) * XS + n]) : 0.f, big[r], small[r]);
      float* tb = xbs + (q >> 1) * 2 * XT + b_offset(n, (4 * q) & 7);
      *reinterpret_cast<uint4*>(tb) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(tb + XT) = make_uint4(small[0], small[1], small[2], small[3]);
    }
    fence_proxy_async();
    __syncthreads();

    // A = dxg^T: A[g][k] = dxg[k][g], this thread's rows g, g + 8; two
    // register sets, so that step ks + 1 is split while step ks runs
    const T* ga = gt + wg * 64 + warp * 16 + gid;
    auto split_a = [&](int ks, uint32_t(&ah)[4], uint32_t(&al)[4]) {
      const int k0 = ks * 8 + tig, k1 = k0 + 4;
      const bool v0 = k0 < rows, v1 = k1 < rows;
      const float a0 = v0 ? ld(ga[k0 * GS]) : 0.f, a1 = v0 ? ld(ga[k0 * GS + 8]) : 0.f;
      const float a2 = v1 ? ld(ga[k1 * GS]) : 0.f, a3 = v1 ? ld(ga[k1 * GS + 8]) : 0.f;
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
    // (its split pass writes the other x buffer)
  }
  wgmma_wait<0>();
  fence_regs(lo);
  fence_regs(hi);
  float sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = n_stages > 0 ? lo[i] + hi[i] : 0.f;
  cp_async_wait<0>();

  // dW^T (g, e) -> dW partial [chunk][e][g]
  float* dw = dw_part + (size_t)chunk * E * G;
  const int g = g0 + wg * 64 + warp * 16 + gid;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int e = e0 + j * 8 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = g + 8 * (r >> 1), er = e + (r & 1);
      if (gr < G && er < E) dw[(size_t)er * G + gr] = sum[4 * j + r];
    }
  }
  // db: the four lanes of a row group hold the k residues 0-3 (+4) of
  // every step; a butterfly adds them in the same order in every lane
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = db_acc[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (blockIdx.y == 0 && tig == 0 && g + 8 * h < G) db_part[(size_t)chunk * G + g + 8 * h] = v;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
gru_input_proj_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dxg,
                          float* __restrict__ dw_part, float* __restrict__ db_part, int M,
                          int E, int G, int rows_per_chunk, int XS, bool vec_x, bool vec_g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (E - (int)blockIdx.y * EW > 56)
    reduce_chunk<64>(x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x, vec_g, smem);
  else
    reduce_chunk<56>(x, dxg, dw_part, db_part, M, E, G, rows_per_chunk, XS, vec_x, vec_g, smem);
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

template <class T>
int run(const T* x, const T* dxg, float* dw_part, float* db_part, float* dw, float* db, int M,
        int E, int G, int rows_per_chunk, void* stream) {
  if (G == 0) return 0;
  if (rows_per_chunk <= 0 || rows_per_chunk % STEP != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int PER = 16 / sizeof(T);
  // whole x rows where they fit (f32: up to E = 384); past that each block
  // copies its E tile
  const int XS = smem_bytes<T>(E) <= 232448 ? E : EW;
  const size_t smem = smem_bytes<T>(XS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      gru_input_proj_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = M > 0 ? (M + rows_per_chunk - 1) / rows_per_chunk : 1;
  const int e_tiles = std::max(1, (E + EW - 1) / EW);
  // 16-byte copies: x's stages start at multiples of 32 rows (32*E
  // elements, a multiple of 16 bytes); an E tile's rows start at multiples
  // of E (plus e0, a multiple of 64)
  const bool vec_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (XS == E || E % PER == 0);
  const bool vec_g = (reinterpret_cast<uintptr_t>(dxg) & 15) == 0 && G % PER == 0;
  gru_input_proj_bwd_kernel<T><<<dim3((G + BG - 1) / BG, e_tiles, chunks), THREADS, smem, s>>>(
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
// 0) and rows_per_chunk a positive multiple of 32.  Launches two kernels
// on `stream` and returns the first failure's cudaError_t (0 = success).
extern "C" int gru_input_proj_bwd(const float* x, const float* dxg, float* dw_part,
                                  float* db_part, float* dw, float* db, int M, int E, int G,
                                  int rows_per_chunk, void* stream) {
  return run(x, dxg, dw_part, db_part, dw, db, M, E, G, rows_per_chunk, stream);
}

extern "C" int gru_input_proj_bwd_bf16(const bf16* x, const bf16* dxg, float* dw_part,
                                       float* db_part, float* dw, float* db, int M, int E, int G,
                                       int rows_per_chunk, void* stream) {
  return run(x, dxg, dw_part, db_part, dw, db, M, E, G, rows_per_chunk, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
