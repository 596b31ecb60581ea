// Unique-row scatter for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/microbench_scatter.py:_pallas_kernel (the
// winner-table scatter of fusion: zero an HW-row table, then
// table[idx[i]] = val[i], rows with idx >= HW dropped), batched and with C
// columns. Contract of the plain PyTorch version
// (gradslam_torch/ops/scatter.py):
//   out = fill (or a copy of an existing buffer), then
//   out[b, dest[b, m], :] = values[b, m, :]   for 0 <= dest[b, m] < size;
//   every other destination is dropped. Destinations inside the table are
//   unique in each batch row, so no two threads write one element: there
//   are no atomics and the result is deterministic.
//
// Design. Two passes on the caller's stream: (1) the table is filled with
// the fill value's bit pattern, or copied from the source buffer with
// cudaMemcpyAsync; (2) one thread per (row, column) element of `values`
// (grid.y the batch row, grid.x its M * C elements, 32-bit index math)
// reads its row's destination and writes the element when it lies inside
// the table. Elements are moved as 4- or 8-byte words (f32, i32, i64), and
// dest is int32 or int64. Dropped rows are skipped in the kernel, so the
// plain version's (size + M)-row trash buffer and its slice-and-copy are
// not needed.
//
// What bounds it on this card: bytes. The function must read dest once,
// read the values of the rows that land in the table (a dropped row's values
// are never read), and write the table once (for the copy form, also read
// the buffer rows that no value overwrites); there is no arithmetic to speak
// of. At the microbenchmark's shape (655,360 int32 indices, 307,200 of them
// inside a 307,200-row f32 table) that is about 5.1 MB, about 1.5 us at
// 3.35 TB/s, so the two launches' latency dominates.
// The writes land at scattered rows: each 4-byte store may cost a 32-byte
// sector, so the achieved rate sits well under the card's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
fill_kernel(Word* __restrict__ out, size_t n, Word value) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    out[i] = value;
  }
}

template <typename Word, typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(Word* __restrict__ out,            // (B, size, C)
               const Index* __restrict__ dest,    // (B, M)
               const Word* __restrict__ values,   // (B, M, C)
               int M, int C, long long size) {
  // blockIdx.y is the batch row; x walks its M * C elements
  const int per_batch = M * C;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= per_batch) return;
  const size_t b = blockIdx.y;
  const int m = i / C;
  const long long d = static_cast<long long>(dest[b * M + m]);
  if (d >= 0 && d < size) {
    out[(b * size + d) * C + (i - m * C)] = values[b * per_batch + i];
  }
}

int blocks_for(size_t n) {
  const size_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename Word>
int launch(void* out, const void* src, unsigned long long fill_bits, const void* dest,
           int dest_bytes, const void* values, long long B, long long M, long long C,
           long long size, cudaStream_t stream) {
  const size_t table = static_cast<size_t>(B) * size * C;
  if (table > 0) {
    if (src != nullptr) {
      cudaError_t err = cudaMemcpyAsync(out, src, table * sizeof(Word),
                                        cudaMemcpyDeviceToDevice, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      fill_kernel<Word><<<blocks_for(table), kThreads, 0, stream>>>(
          static_cast<Word*>(out), table, static_cast<Word>(fill_bits));
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const long long per_batch = M * C;
  if (B == 0 || per_batch == 0 || size == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((per_batch + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  if (dest_bytes == 8) {
    scatter_kernel<Word, int64_t><<<grid, kThreads, 0, stream>>>(
        static_cast<Word*>(out), static_cast<const int64_t*>(dest),
        static_cast<const Word*>(values), static_cast<int>(M), static_cast<int>(C), size);
  } else {
    scatter_kernel<Word, int32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<Word*>(out), static_cast<const int32_t*>(dest),
        static_cast<const Word*>(values), static_cast<int>(M), static_cast<int>(C), size);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Fills `out` (B, size, C) with `fill_bits` (the fill value's bit pattern in
// the low `elem_bytes` bytes), or copies it from `src` when `src` is not
// null, then scatters `values` (B, M, C) to the rows `dest` (B, M) names.
// `elem_bytes` is 4 or 8, `dest_bytes` 4 or 8. Pointers are device
// pointers, all on `stream`. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue (1) for an element or index width it does not take.
extern "C" int gradslam_scatter_rows(void* out, const void* src, unsigned long long fill_bits,
                                     const void* dest, int dest_bytes, const void* values,
                                     int elem_bytes, long long B, long long M, long long C,
                                     long long size, void* stream) {
  // one batch row's M * C elements are indexed in int, the batch on grid.y
  if ((dest_bytes != 4 && dest_bytes != 8) || B < 0 || B > 65535 || M < 0 || C < 0 ||
      size < 0 || M * C >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return launch<uint32_t>(out, src, fill_bits, dest, dest_bytes, values, B, M, C, size, s);
  }
  if (elem_bytes == 8) {
    return launch<unsigned long long>(out, src, fill_bits, dest, dest_bytes, values, B, M, C,
                                      size, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
