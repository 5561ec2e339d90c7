// The sentence rows of the bi-GRU recurrences, longest first: K2's forward
// recurrence (bigru_recurrence.cu) and K3's reverse sweep
// (bigru_backward.cu) both walk 16-row tiles of `order`.  A block's loop
// runs to its tile's longest row, so with rows in their own order every
// tile runs about L steps (19.4 of 20 at lengths uniform in 1 .. 20);
// sorted, a tile's 16 rows share about one length and its loop runs that
// many steps.
//
// A counting sort in one block, by length bucket (bucket L - length, so the
// longest come first), positions taken by shared-memory integer atomics:
// the order within a bucket varies from run to run.  No result does, as
// long as each kernel computes a row's steps the same whatever rows share
// its tile and whatever slot it has: its arithmetic depends on its own
// length only, never on the tile's longest.

#pragma once

#include <cuda_runtime.h>

namespace row_order {

// a block's shared memory on Hopper (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

__global__ void __launch_bounds__(1024)
bigru_row_order(const int* __restrict__ lengths, int* __restrict__ order, int N, int L) {
  extern __shared__ int cursor[];  // [L + 1]: bucket L - length
  for (int b = threadIdx.x; b <= L; b += blockDim.x) cursor[b] = 0;
  __syncthreads();
  auto bucket = [&](int n) { return L - max(0, min(lengths[n], L)); };
  for (int n = threadIdx.x; n < N; n += blockDim.x) atomicAdd(&cursor[bucket(n)], 1);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int b = 0, start = 0; b <= L; ++b) {
      const int count = cursor[b];
      cursor[b] = start;
      start += count;
    }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) order[atomicAdd(&cursor[bucket(n)], 1)] = n;
}

// a tile's row k: its sentence row (-1 past N) and length (0 past N)
__device__ __forceinline__ void load_tile(const int* __restrict__ order,
                                          const int* __restrict__ lengths, int k, int N, int L,
                                          int& row, int& len) {
  row = k < N ? order[k] : -1;
  len = row >= 0 ? min(lengths[row], L) : 0;
}

// order (N,) <- the rows 0 .. N-1 by length, longest first; on `stream`;
// returns the cudaError_t
inline int launch(const int* lengths, int* order, int N, int L, cudaStream_t stream) {
  const size_t buckets = (size_t)(L + 1) * sizeof(int);
  if (buckets > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_row_order, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)buckets);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_row_order<<<1, 1024, buckets, stream>>>(lengths, order, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_order
