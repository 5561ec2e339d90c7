// K8 affinity_finish: the R-Net affinity attention from K7's partials.
//
// Per sample b, from K7 (affinity_tiles.cu): the column partials
// col_val/col_idx (R, P), one per 128-row tile, and the final row maxima
// row_val (P,); the exists mask e (P,); U = gru_u and I = gru_i (P, D):
//   colmax[q], amax_u[q] = the best of col_val[r, q] over r (NaN first, then
//                          the larger value, then the lower index: the
//                          first argmax row of the whole column)
//   soft_u = masked_softmax(colmax, e)   soft_i = masked_softmax(row_val, e)
//   atte_u = soft_u^T U                  atte_i = soft_i^T I
// masked_softmax is ops/masking.py's: masked scores become -1e30, the max
// is taken over all P (NaN propagates), exp(s - max) is kept only where e,
// and divided by its sum.
//
// Replaces, with K7, the TPU kernels B9 (_tiled_forward, pallas_call at
// umpr_tpu/ops/attention_pallas.py:415) and B10 (_forward, :167).  B9 ran
// an online softmax across its column tiles and rescaled su outside the
// kernel; here the maxima are final before any exp, so both softmaxes are
// exact, in two passes over the (P,) scores.  atte_i is part of the kernel
// (B9 left it to one XLA matmul).
//
// What bounds it on an H100: bytes.  At B=64, P=8192, D=128 it reads the
// partials (268 MB), row_val, U and I (537 MB) once and writes (B, P)
// vectors: about 0.25 ms at 3.35 TB/s, against 0.3 GFLOP.
//
// Design: one thread block cluster of CLUSTER blocks of THREADS threads
// per sample (Hopper's clusters: the blocks of one cluster run at once and
// read each other's shared memory), so B = 64 samples are 512 blocks on
// 132 SMs, where one block per sample left half the SMs idle and kept too
// few loads in flight; at B = 8 they are 64 blocks, and 512 threads a
// block rather than 256 keep enough loads in flight there (PERF.md section
// 6, chip_smoke.py --steps).  Rank c owns positions [c P / CLUSTER,
// (c + 1) P / CLUSTER):
//   (a) it merges its columns' partials (loads issued MERGE_AHEAD tiles at
//       a time, compared in tile order; `better` is a total order, so the
//       merge gives the plain version's bits) into colmax / amax_u, and
//       takes both scores' masked maxima over its positions;
//   (b) cluster barrier; every block folds the CLUSTER maxima in rank
//       order (NaN propagates), so all hold the final maxima;
//   (c) it stages ex = e ? exp(s - max) : 0 of its positions in shared
//       memory (WIN at a time) and sums them; then a warp per position adds
//       ex * U[p] and ex * I[p] to its lanes' columns, reading whole rows
//       as 16-byte vectors, several rows in flight; masked positions are
//       not skipped (0 * NaN must stay NaN, as in the plain version's
//       einsum); the sums of ex and the block's column sums are kept in
//       shared memory;
//   (d) cluster barrier; every block adds the CLUSTER sums of ex in rank
//       order and writes soft = ex / sum for its positions; rank c adds
//       the CLUSTER blocks' column sums of its share of the D columns in
//       rank order and writes atte = that / sum; a last cluster barrier
//       keeps every block's shared memory alive until all reads are done.
// No atomics; every sum has a fixed order (lanes' values in turn, warps in
// warp order, ranks in rank order) and CLUSTER is fixed, so the result is
// the same bits on every run and every card.  A rank with no positions
// (P < CLUSTER) contributes -inf to the maxima and 0 to the sums.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // blocks per sample: the portable cluster size
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DCHUNK = 128;      // columns of D per attend pass: a float4 per lane
constexpr int MERGE_AHEAD = 8;   // column partials loaded before they are compared
constexpr int WIN = 2048;        // positions whose exps are staged in shared memory at once
constexpr float NEG_INF = -1e30f;
// a block's shared memory on Hopper (227 KB), less the static arrays
constexpr size_t SMEM_LIMIT = 232448 - (2 * WARPS * DCHUNK + 2 * WIN) * 4 - 1024;

__device__ __forceinline__ bool better(float v, int i, float cv, int ci) {
  const bool n = v != v, cn = cv != cv;
  if (n != cn) return n;
  if (!n && v != cv) return v > cv;
  return i < ci;
}

// max that returns NaN when either side is NaN (torch.amax's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
affinity_finish_kernel(const float* __restrict__ col_val, const int* __restrict__ col_idx,
                       const float* __restrict__ row_val, const uint8_t* __restrict__ exists,
                       const float* __restrict__ U, const float* __restrict__ I,
                       float* __restrict__ soft_u, float* __restrict__ soft_i,
                       float* __restrict__ atte_u, float* __restrict__ atte_i,
                       float* __restrict__ colmax, int* __restrict__ amax_u, int R, int P,
                       int D) {
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);  // [2][D]: this block's sums of ex U, ex I
  __shared__ float wpart[2][WARPS][DCHUNK];        // the warps' column sums of one pass
  __shared__ float ex_s[2][WIN];                   // exp(s - max) of a window of positions
  __shared__ float2 red[WARPS];
  __shared__ float stat[4];  // this block's max u, max i, sum u, sum i: the cluster reads them
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const int lo = (int)((long long)c * P / CLUSTER);
  const int hi = (int)((long long)(c + 1) * P / CLUSTER);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t bp = (size_t)b * P;

  // (a) the column merge and this block's masked maxima
  float mu = -INFINITY, mi = -INFINITY;
  for (int q = lo + tid; q < hi; q += THREADS) {
    const float* cv = col_val + (size_t)b * R * P + q;
    const int* ci = col_idx + (size_t)b * R * P + q;
    float v = cv[0];
    int ix = ci[0];
    for (int r = 1; r < R; r += MERGE_AHEAD) {
      float ov[MERGE_AHEAD];
      int oi[MERGE_AHEAD];
#pragma unroll
      for (int k = 0; k < MERGE_AHEAD; ++k)
        if (r + k < R) {
          ov[k] = cv[(size_t)(r + k) * P];
          oi[k] = ci[(size_t)(r + k) * P];
        }
#pragma unroll
      for (int k = 0; k < MERGE_AHEAD; ++k)
        if (r + k < R && better(ov[k], oi[k], v, ix)) {
          v = ov[k];
          ix = oi[k];
        }
    }
    colmax[bp + q] = v;
    amax_u[bp + q] = ix;
    const bool e = exists[q];
    mu = max_nan(mu, e ? v : NEG_INF);
    mi = max_nan(mi, e ? row_val[bp + q] : NEG_INF);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mu = max_nan(mu, __shfl_down_sync(0xffffffffu, mu, off));
    mi = max_nan(mi, __shfl_down_sync(0xffffffffu, mi, off));
  }
  if (lane == 0) red[warp] = make_float2(mu, mi);
  __syncthreads();
  if (tid == 0) {
    float2 m = red[0];
    for (int w = 1; w < WARPS; ++w)
      m = make_float2(max_nan(m.x, red[w].x), max_nan(m.y, red[w].y));
    stat[0] = m.x;
    stat[1] = m.y;
  }
  cluster.sync();  // colmax of every position and every rank's maxima are written

  // (b) the final maxima, folded in rank order
  float gu = -INFINITY, gi = -INFINITY;
  for (int k = 0; k < CLUSTER; ++k) {
    const float* st = cluster.map_shared_rank(stat, k);
    gu = max_nan(gu, st[0]);
    gi = max_nan(gi, st[1]);
  }

  // (c) ex = e ? exp(s - max) : 0 for this block's positions, a window
  // of WIN at a time staged in shared memory, with their sums; then ex^T U
  // and ex^T I over the window: warp w takes the window's positions w,
  // w + WARPS, ...; lane l the columns 4 l .. 4 l + 3 of each DCHUNK-wide
  // pass over D
  float su = 0.f, si = 0.f;
  for (int w0 = lo; w0 < hi; w0 += WIN) {
    const int wn = min(WIN, hi - w0);
    for (int j = tid; j < wn; j += THREADS) {
      const bool e = exists[w0 + j];
      const float eu = e ? expf(colmax[bp + w0 + j] - gu) : 0.f;
      const float ei = e ? expf(row_val[bp + w0 + j] - gi) : 0.f;
      ex_s[0][j] = eu;
      ex_s[1][j] = ei;
      su += eu;
      si += ei;
    }
    __syncthreads();
    for (int d0 = 0; d0 < D; d0 += DCHUNK) {
      const int dl = d0 + 4 * lane;
      float au[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};
      const float* urow = U + (bp + w0) * D + dl;
      const float* irow = I + (bp + w0) * D + dl;
      if (D % 4 == 0) {  // whole rows of 16-byte vectors
        if (dl < D) {
#pragma unroll 4
          for (int j = warp; j < wn; j += WARPS) {
            const float eu = ex_s[0][j], ei = ex_s[1][j];
            const float4 u4 = __ldg(reinterpret_cast<const float4*>(urow + (size_t)j * D));
            const float4 i4 = __ldg(reinterpret_cast<const float4*>(irow + (size_t)j * D));
            au[0] = fmaf(eu, u4.x, au[0]);
            au[1] = fmaf(eu, u4.y, au[1]);
            au[2] = fmaf(eu, u4.z, au[2]);
            au[3] = fmaf(eu, u4.w, au[3]);
            ai[0] = fmaf(ei, i4.x, ai[0]);
            ai[1] = fmaf(ei, i4.y, ai[1]);
            ai[2] = fmaf(ei, i4.z, ai[2]);
            ai[3] = fmaf(ei, i4.w, ai[3]);
          }
        }
      } else {
        for (int j = warp; j < wn; j += WARPS) {
          const float eu = ex_s[0][j], ei = ex_s[1][j];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (dl + k < D) {
              au[k] = fmaf(eu, __ldg(urow + (size_t)j * D + k), au[k]);
              ai[k] = fmaf(ei, __ldg(irow + (size_t)j * D + k), ai[k]);
            }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wpart[0][warp][4 * lane + k] = au[k];
        wpart[1][warp][4 * lane + k] = ai[k];
      }
      __syncthreads();
      {  // the warps' column sums in warp order, added to the earlier
         // windows': threads 0-127 U's, 128-255 I's
        const int which = tid / DCHUNK, col = tid % DCHUNK;
        if (tid < 2 * DCHUNK && d0 + col < D) {
          float t = wpart[which][0][col];
          for (int w = 1; w < WARPS; ++w) t += wpart[which][w][col];
          float* o = part + which * D + d0 + col;
          *o = w0 == lo ? t : *o + t;
        }
      }
      __syncthreads();  // wpart and ex_s are free for the next pass
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    su += __shfl_down_sync(0xffffffffu, su, off);
    si += __shfl_down_sync(0xffffffffu, si, off);
  }
  if (lane == 0) red[warp] = make_float2(su, si);
  __syncthreads();
  if (tid == 0) {
    float2 t = red[0];
    for (int w = 1; w < WARPS; ++w) t = make_float2(t.x + red[w].x, t.y + red[w].y);
    stat[2] = t.x;
    stat[3] = t.y;
  }
  if (lo == hi)  // no position: no column sums either
    for (int i = tid; i < 2 * D; i += THREADS) part[i] = 0.f;
  cluster.sync();  // every rank's sums and column sums are written

  // (d) the final sums in rank order; soft for this block's positions, atte
  // for its share of the columns
  float lu = 0.f, li = 0.f;
  for (int k = 0; k < CLUSTER; ++k) {
    const float* st = cluster.map_shared_rank(stat, k);
    lu += st[2];
    li += st[3];
  }
  for (int q = lo + tid; q < hi; q += THREADS) {
    const bool e = exists[q];
    soft_u[bp + q] = (e ? expf(colmax[bp + q] - gu) : 0.f) / lu;
    soft_i[bp + q] = (e ? expf(row_val[bp + q] - gi) : 0.f) / li;
  }
  const int c_lo = (int)((long long)c * D / CLUSTER);
  const int c_hi = (int)((long long)(c + 1) * D / CLUSTER);
  const int n = c_hi - c_lo;
  for (int i = tid; i < 2 * n; i += THREADS) {
    const int which = i / n, col = c_lo + i % n;
    float t = 0.f;
    for (int k = 0; k < CLUSTER; ++k) t += cluster.map_shared_rank(part, k)[which * D + col];
    (which == 0 ? atte_u : atte_i)[(size_t)b * D + col] = t / (which == 0 ? lu : li);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

}  // namespace

// col_val, col_idx (B, R, P), row_val (B, P), exists (P,) uint8 0/1, U, I
// (B, P, D) -> soft_u, soft_i, colmax (B, P) f32, amax_u (B, P) int32,
// atte_u, atte_i (B, D) f32; contiguous, on the device.  Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int affinity_finish(const float* col_val, const int* col_idx, const float* row_val,
                               const uint8_t* exists, const float* U, const float* I,
                               float* soft_u, float* soft_i, float* atte_u, float* atte_i,
                               float* colmax, int* amax_u, int B, int R, int P, int D,
                               void* stream) {
  if (B == 0 || P == 0) return 0;
  const size_t smem = 2 * (size_t)D * sizeof(float);
  if (R <= 0 || D <= 0 || (long long)B * CLUSTER > INT_MAX || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      affinity_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  affinity_finish_kernel<<<B * CLUSTER, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      col_val, col_idx, row_val, exists, U, I, soft_u, soft_i, atte_u, atte_i, colmax, amax_u,
      R, P, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
