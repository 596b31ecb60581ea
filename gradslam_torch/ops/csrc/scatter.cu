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
// What bounds it on this card: bytes. The function must read dest once,
// read the values of the rows that land in the table (a dropped row's values
// are never read), and write the table once (for the copy form, also read
// the buffer rows that no value overwrites); there is no arithmetic to speak
// of. At the paths' small shapes that is under 3 us at 3.35 TB/s, so launch
// latency and the dependency between the two passes set the time; at the
// ICPSLAM append (a 27.6 MB buffer copied) the bytes do.
//
// Design, one point for each thing that held the first version back:
// 1. The one dependency, fill or copy then scatter, is hidden with
//    programmatic dependent launch: `scatter_fill_copy` lets the next grid
//    launch as soon as each of its blocks starts
//    (griddepcontrol.launch_dependents), and `scatter_rows`, launched with
//    cudaLaunchAttributeProgrammaticStreamSerialization, loads its
//    destination and row (the bulk of its reads, which do not depend on the
//    table) into registers, then waits for the fill or copy to complete and
//    be visible (griddepcontrol.wait), and only then stores. The order of
//    the stores after the fill is the grid-wide order the wait gives. Both
//    kernels go on the caller's stream; the entry point allocates nothing
//    and never synchronises, so a call can be captured in a CUDA graph.
// 2. One thread a destination row over the flattened B * M rows: dest is
//    read once a row, the batch row is one division a row (none an
//    element), and the row moves in the widest word its byte width and the
//    pointers allow (16, 8 or 4 bytes; the wrapper's `word_bytes` picks it),
//    so a C=8 float32 row is two 16-byte stores. No grid.y: B is not capped.
// 3. The fill and the copy move 16-byte words (the fill's 4- or 8-byte
//    pattern replicated across the vector), the ragged tail in element
//    words; the copy is this kernel, not the runtime's memcpy, so the
//    dependency is kernel to kernel and the profile counts it as ours. The
//    copy streams (evict-first loads and stores, four loads in flight a
//    thread): on the H100 plain loads and stores copied the ICPSLAM map
//    buffers slower than the runtime's memcpy, streaming ones faster
//    (PERF.md). The fill keeps plain stores, so the table stays in L2 for
//    the row stores.
// 4. The host path is in the wrapper (scatter_cuda.py): one validation
//    pass, the fill's bits from numpy, one ctypes call bound once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Fill/copy blocks: 4 an SM of the H100's 132 keep every block resident at
// once (so the dependents launch at once) and leave half of each SM's
// threads to the scatter's blocks, which load their rows meanwhile.
constexpr int kFillBlocks = 132 * 4;
// 16-byte words a copy thread loads before it stores them.
constexpr int kUnroll = 4;
// Row words a thread holds in registers across the wait; a wider row loads
// the rest after it.
constexpr int kHeld = 8;

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ uint4 splat(uint32_t v) { return make_uint4(v, v, v, v); }

__device__ __forceinline__ uint4 splat(unsigned long long v) {
  const uint32_t lo = static_cast<uint32_t>(v), hi = static_cast<uint32_t>(v >> 32);
  return make_uint4(lo, hi, lo, hi);  // little-endian: the low half first
}

// out[i] = src[i] (or the fill) for i < n, with a grid stride: the first
// `nvec` 16-byte words as vectors, then elements nvec * 16 / sizeof(Elem)
// to n one at a time. nvec is 0 unless out and src are 16-byte aligned.
template <typename Elem>
__device__ __forceinline__ void fill_copy(Elem* __restrict__ out, const Elem* __restrict__ src,
                                          size_t n, size_t nvec, Elem value) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint4* o4 = reinterpret_cast<uint4*>(out);
  if (src == nullptr) {
    // plain stores: the table stays in L2 for the row stores that follow
    const uint4 v4 = splat(value);
    for (size_t i = t; i < nvec; i += stride) o4[i] = v4;
  } else {
    // streaming loads and stores (evict first): a buffer of up to 27.6 MB
    // passes through L2 once
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    size_t i = t;
    for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(s4 + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) __stcs(o4 + i + u * stride, v[u]);
    }
    for (; i < nvec; i += stride) __stcs(o4 + i, __ldcs(s4 + i));
  }
  for (size_t i = nvec * (16 / sizeof(Elem)) + t; i < n; i += stride) {
    out[i] = src == nullptr ? value : src[i];
  }
}

// One row's destination and, when it lands in the table, its first kHeld
// words.
template <typename Word, typename Index>
__device__ __forceinline__ long long load_row(const Index* __restrict__ dest,
                                              const Word* __restrict__ values, int r, int words,
                                              long long size, Word (&held)[kHeld]) {
  const long long d = static_cast<long long>(dest[r]);
  if (d >= 0 && d < size) {
    const Word* v = values + static_cast<size_t>(r) * words;
#pragma unroll
    for (int w = 0; w < kHeld; ++w) {
      if (w < words) held[w] = v[w];
    }
  }
  return d;
}

template <typename Word>
__device__ __forceinline__ void store_row(Word* __restrict__ out, const Word* __restrict__ values,
                                          int r, int M, int words, long long size, long long d,
                                          const Word (&held)[kHeld]) {
  const size_t b = static_cast<unsigned>(r) / static_cast<unsigned>(M);  // one division a row
  Word* o = out + (b * size + d) * words;
#pragma unroll
  for (int w = 0; w < kHeld; ++w) {
    if (w < words) o[w] = held[w];
  }
  const Word* v = values + static_cast<size_t>(r) * words;
  for (int w = kHeld; w < words; ++w) o[w] = v[w];
}

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
scatter_fill_copy(Elem* __restrict__ out, const Elem* __restrict__ src, size_t n, size_t nvec,
                  Elem value) {
  launch_dependents();  // the scatter's blocks may start loading now
  fill_copy(out, src, n, nvec, value);
}

// Thread r moves row r of the flattened (B * M) rows: values (B * M, words)
// to out row b * size + dest[r] (b = r / M), dropped unless 0 <= dest < size.
template <typename Word, typename Index>
__global__ void __launch_bounds__(kThreads)
scatter_rows(Word* __restrict__ out, const Index* __restrict__ dest,
             const Word* __restrict__ values, int rows, int M, int words, long long size) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Word held[kHeld];
  const long long d = r < rows ? load_row(dest, values, static_cast<int>(r), words, size, held)
                               : -1;
  // Every thread waits, so this grid never completes before the fill or
  // copy it follows: later work on the stream finds the whole table.
  wait_for_prerequisite_grid();  // the fill or copy is complete and visible
  if (d < 0 || d >= size) return;
  store_row(out, values, static_cast<int>(r), M, words, size, d, held);
}

template <typename Elem>
cudaError_t launch_fill_copy(void* out, const void* src, size_t n, size_t nvec, Elem value,
                             cudaStream_t stream) {
  const size_t tail = n - nvec * (16 / sizeof(Elem));
  const size_t work = nvec > tail ? nvec : tail;
  const size_t blocks = (work + kThreads - 1) / kThreads;
  scatter_fill_copy<Elem><<<static_cast<unsigned>(blocks < kFillBlocks ? blocks : kFillBlocks),
                            kThreads, 0, stream>>>(
      static_cast<Elem*>(out), static_cast<const Elem*>(src), n, nvec, value);
  return cudaGetLastError();
}

template <typename Word, typename Index>
cudaError_t launch_rows(void* out, const void* dest, const void* values, int rows, int M,
                        int words, long long size, bool after_fill, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((static_cast<long long>(rows) + kThreads - 1) /
                                           kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = after_fill ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, scatter_rows<Word, Index>, static_cast<Word*>(out),
      static_cast<const Index*>(dest), static_cast<const Word*>(values), rows, M, words, size);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename Elem, typename Word, typename Index>
cudaError_t launch(void* out, const void* src, Elem value, size_t n, size_t nvec,
                   const void* dest, const void* values, int rows, int M, int words,
                   long long size, cudaStream_t stream) {
  if (n > 0) {
    const cudaError_t err = launch_fill_copy<Elem>(out, src, n, nvec, value, stream);
    if (err != cudaSuccess) return err;
  }
  if (rows == 0 || words == 0 || size == 0) return cudaSuccess;
  return launch_rows<Word, Index>(out, dest, values, rows, M, words, size, n > 0, stream);
}

template <typename Elem, typename Word>
cudaError_t by_index(int dest_bytes, void* out, const void* src, Elem value, size_t n,
                     size_t nvec, const void* dest, const void* values, int rows, int M,
                     int words, long long size, cudaStream_t stream) {
  if (dest_bytes == 8) {
    return launch<Elem, Word, int64_t>(out, src, value, n, nvec, dest, values, rows, M, words,
                                       size, stream);
  }
  return launch<Elem, Word, int32_t>(out, src, value, n, nvec, dest, values, rows, M, words,
                                     size, stream);
}

template <typename Elem>
cudaError_t by_word(int word_bytes, int dest_bytes, void* out, const void* src, Elem value,
                    size_t n, size_t nvec, const void* dest, const void* values, int rows, int M,
                    int words, long long size, cudaStream_t stream) {
  if (word_bytes == 16) {
    return by_index<Elem, uint4>(dest_bytes, out, src, value, n, nvec, dest, values, rows, M,
                                 words, size, stream);
  }
  if (word_bytes == 8) {
    return by_index<Elem, uint2>(dest_bytes, out, src, value, n, nvec, dest, values, rows, M,
                                 words, size, stream);
  }
  return by_index<Elem, uint32_t>(dest_bytes, out, src, value, n, nvec, dest, values, rows, M,
                                  words, size, stream);
}

}  // namespace

// Fills the `table_elems` elements of `out` with `fill_bits` (the fill
// value's bit pattern in the low `elem_bytes` bytes), or copies them from
// `src` when `src` is not null, the first `vec_words` 16-byte words as
// vectors (0 unless out and src are 16-byte aligned); then writes the `rows`
// rows of `values` (each `words` words of `word_bytes` bytes) to the rows of
// `out` that `dest` (int32 or int64, `dest_bytes`) names: row r goes to
// table row (r / M) * size + dest[r] when 0 <= dest[r] < size. Pointers are
// device pointers, all on `stream`. Returns 0 on success, the launch's
// cudaError otherwise, or cudaErrorInvalidValue (1) for arguments it does
// not take.
extern "C" int gradslam_scatter_rows(void* out, const void* src, unsigned long long fill_bits,
                                     int elem_bytes, long long table_elems, long long vec_words,
                                     const void* dest, int dest_bytes, const void* values,
                                     int word_bytes, int rows, int M, int words, long long size,
                                     void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || (dest_bytes != 4 && dest_bytes != 8) ||
      (word_bytes != 4 && word_bytes != 8 && word_bytes != 16) || word_bytes < elem_bytes ||
      table_elems < 0 || vec_words < 0 || vec_words * 16 > table_elems * elem_bytes ||
      rows < 0 || M < 0 || (rows > 0 && M == 0) || words < 0 || size < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = static_cast<size_t>(table_elems), nvec = static_cast<size_t>(vec_words);
  if (elem_bytes == 4) {
    return static_cast<int>(by_word<uint32_t>(word_bytes, dest_bytes, out, src,
                                              static_cast<uint32_t>(fill_bits), n, nvec, dest,
                                              values, rows, M, words, size, s));
  }
  return static_cast<int>(by_word<unsigned long long>(word_bytes, dest_bytes, out, src,
                                                      fill_bits, n, nvec, dest, values, rows, M,
                                                      words, size, s));
}
