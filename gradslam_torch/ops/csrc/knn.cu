// Brute-force 1-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel gradslam_tpu/ops/knn_pallas.py:_knn_kernel. For
// every source point it returns the squared distance and the int32 index of
// the nearest valid target, with the contract of the plain PyTorch version
// (gradslam_torch/ops/knn.py:nn_points):
//   d2 = |s|^2 + (|t|^2 + penalty) - 2 s.t   (expanded form, float32 FMA)
//   masked targets are zeroed and carry a +1e30 penalty;
//   ties go to the smallest index; the result is clamped to >= 0.
// Per pair, operation for operation:
//   s2 = fmaf(sz, sz, fmaf(sy, sy, sx * sx))   (and the same for |t|^2)
//   cross = fmaf(sz, tz, fmaf(sy, ty, sx * tx))
//   d = fmaf(-2, cross, s2 + (t2 + penalty))
// and the result is the lexicographic minimum of {(1e30, 0)} U {(d_j, j)}
// (a strict-< walk over ascending j from (1e30, 0); a NaN d never wins),
// clamped at 0. Every design choice below keeps that arithmetic and that
// rule, so the output is bit-identical to a single thread's strict-< walk.
//
// What bounds it on this card: float32 issue. Each pair needs FMUL, two
// FFMA (cross term), FADD and FFMA (distance) and one FMNMX: 6 lane
// instructions, 8 flops. It reads O(N + M) bytes. No tensor cores: the cross
// term cancels against |s|^2 + |t|^2, a TF32 or bf16 cross term flips indices
// (bf16 flipped 38% of them on the TPU), and a 3xTF32 split would not round
// as the FMA chain does, so the bit-identical result would be lost.
//
// Design, one launch sequence from the C entry point:
// 1. knn1_targets (prologue): each target once, as the float4
//    (x, y, z, |t|^2 + penalty) with masked rows zeroed, into scratch
//    (B, Mpad, 4); Mpad rounds M up to a whole chunk with rows
//    (0, 0, 0, +inf), whose d is +inf and never wins. (Building the float4
//    in every search block instead was no faster; PERF.md.)
// 2. knn1_search, grid (row blocks, S, B): the targets are cut into S
//    contiguous splits, so the grid fills the card even when N is small.
//    A block holds kR sources a thread in registers (one shared-memory read
//    of a target serves kR pairs) and streams its split through a
//    double-buffered ring of shared-memory tiles, filled by 16-byte
//    cp.async from the prologue's array while the previous tile computes.
//    Min-then-recover, as the TPU kernel does: the inner loop keeps only a
//    running fminf per source; after each chunk of kChunk targets, the chunk
//    is recorded when the running min dropped strictly. The recorded chunk
//    is the first one that reaches the split's minimum, so the first index
//    in it whose d equals the minimum is the strict-< walk's index. The
//    block writes the partial (min, chunk) to scratch (B, S, N).
// 3. knn1_merge, one warp a source: takes the S partials in ascending
//    split order with strict < from (1e30, none), so ties across split
//    boundaries go to the earlier split, then computes the one winning
//    chunk again, a target a lane, with the same instructions to recover
//    the index (they round alike in both kernels: no fast-math, explicit
//    fmaf), and clamps.
// The wrapper (gradslam_torch/ops/knn_cuda.py:split_plan) picks S.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // threads of a search block
constexpr int kR = 4;                  // sources a thread
constexpr int kRows = kThreads * kR;   // sources a search block
constexpr int kChunk = 32;             // targets between two checks of the running min
constexpr int kTile = 256;             // targets a shared-memory stage (4 KB)
constexpr int kMergeWarps = 8;         // sources a merge block, one warp each
constexpr float kInf = 1e30f;
static_assert(kChunk == 32, "the merge recovers a chunk with one warp, a target a lane");

__device__ __forceinline__ float pair_d2(float sx, float sy, float sz, float s2,
                                         float4 v) {
  const float cross = fmaf(sz, v.z, fmaf(sy, v.y, sx * v.x));
  return fmaf(-2.f, cross, s2 + v.w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The targets as the search reads them; rows past M pad the last chunk.
__global__ void knn1_targets(const float* __restrict__ tgt,     // (B, M, 3)
                             const uint8_t* __restrict__ mask,  // (B, M) or null
                             float4* __restrict__ t4,           // (B, Mpad)
                             int M, int Mpad) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= Mpad) return;
  float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
  if (m < M) {
    const float* t = tgt + (static_cast<size_t>(b) * M + m) * 3;
    const bool ok = mask == nullptr || mask[static_cast<size_t>(b) * M + m] != 0;
    // masked rows are zeroed before use: NaN padding stays out of d2
    v.x = ok ? t[0] : 0.f;
    v.y = ok ? t[1] : 0.f;
    v.z = ok ? t[2] : 0.f;
    const float t2 = fmaf(v.z, v.z, fmaf(v.y, v.y, v.x * v.x));
    v.w = ok ? t2 : t2 + kInf;
  }
  t4[static_cast<size_t>(b) * Mpad + m] = v;
}

__global__ void __launch_bounds__(kThreads)
knn1_search(const float* __restrict__ src,  // (B, N, 3)
            const float4* __restrict__ t4,  // (B, Mpad), from knn1_targets
            float* __restrict__ part_d,     // (B, S, N)
            int32_t* __restrict__ part_c,   // (B, S, N)
            int N, int Mpad, int per) {
  __shared__ __align__(16) float4 tile[2][kTile];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int S = gridDim.y;
  const int row0 = blockIdx.x * kRows;
  const int start = s * per;
  const int stop = min(start + per, Mpad);

  float sx[kR], sy[kR], sz[kR], s2[kR], best[kR];
  int chunk[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = row0 + r * kThreads + threadIdx.x;
    sx[r] = sy[r] = sz[r] = 0.f;
    if (n < N) {
      const float* p = src + (static_cast<size_t>(b) * N + n) * 3;
      sx[r] = p[0];
      sy[r] = p[1];
      sz[r] = p[2];
    }
    s2[r] = fmaf(sz[r], sz[r], fmaf(sy[r], sy[r], sx[r] * sx[r]));
    best[r] = kInf;
    chunk[r] = -1;
  }

  const float4* tb = t4 + static_cast<size_t>(b) * Mpad;
  auto stage = [&](int base, float4* dst) {
    const int count = min(kTile, stop - base);
    for (int j = threadIdx.x; j < count; j += kThreads) cp_async16(dst + j, tb + base + j);
    cp_async_commit();
  };

  if (start < stop) stage(start, tile[0]);
  for (int base = start, k = 0; base < stop; base += kTile, ++k) {
    const bool more = base + kTile < stop;
    if (more) {
      stage(base + kTile, tile[(k + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tl = tile[k & 1];
    const int count = min(kTile, stop - base);  // a whole number of chunks
    for (int c = 0; c < count; c += kChunk) {
      float prev[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) prev[r] = best[r];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4 v = tl[c + j];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          best[r] = fminf(best[r], pair_d2(sx[r], sy[r], sz[r], s2[r], v));
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) chunk[r] = best[r] < prev[r] ? base + c : chunk[r];
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = row0 + r * kThreads + threadIdx.x;
    if (n < N) {
      const size_t o = (static_cast<size_t>(b) * S + s) * N + n;
      part_d[o] = best[r];
      part_c[o] = chunk[r];
    }
  }
}

// One warp a source: lane l walks splits l, l + 32, ... in ascending order
// with strict <, and a lexicographic (d, split) reduction over the lanes
// keeps the earliest split among equal minima. Lane j then computes the
// winning chunk's target j with the search's instructions; the first lane
// whose d equals the minimum names the index.
__global__ void __launch_bounds__(kMergeWarps * 32)
knn1_merge(const float* __restrict__ src, const float4* __restrict__ t4,
           const float* __restrict__ part_d, const int32_t* __restrict__ part_c,
           float* __restrict__ dists,  // (B, N)
           int32_t* __restrict__ idx,  // (B, N)
           int N, int Mpad, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp
  float best = kInf;
  int split = -1, chunk = -1;
  for (int s = lane; s < S; s += 32) {
    const size_t o = (static_cast<size_t>(b) * S + s) * N + n;
    const float d = part_d[o];
    if (d < best) {
      best = d;
      split = s;
      chunk = part_c[o];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float d = __shfl_xor_sync(0xffffffffu, best, off);
    const int s = __shfl_xor_sync(0xffffffffu, split, off);
    const int c = __shfl_xor_sync(0xffffffffu, chunk, off);
    if (d < best || (d == best && s < split)) {
      best = d;
      split = s;
      chunk = c;
    }
  }
  int found = 0;
  if (chunk >= 0) {  // the same on every lane
    const float* p = src + (static_cast<size_t>(b) * N + n) * 3;
    const float sx = p[0], sy = p[1], sz = p[2];
    const float s2 = fmaf(sz, sz, fmaf(sy, sy, sx * sx));
    const float d = pair_d2(sx, sy, sz, s2, t4[static_cast<size_t>(b) * Mpad + chunk + lane]);
    found = chunk + __ffs(__ballot_sync(0xffffffffu, d == best)) - 1;
  }
  if (lane == 0) {
    const size_t o = static_cast<size_t>(b) * N + n;
    dists[o] = fmaxf(best, 0.f);
    idx[o] = found;
  }
}

cudaError_t launch(const float* src, const float* tgt, const uint8_t* mask, float* dists,
                   int32_t* idx, int B, int N, int M, int S, int per, char* scratch,
                   cudaStream_t stream) {
  const int Mpad = (M + kChunk - 1) / kChunk * kChunk;
  float4* t4 = reinterpret_cast<float4*>(scratch);
  float* part_d = reinterpret_cast<float*>(t4 + static_cast<size_t>(B) * Mpad);
  int32_t* part_c = reinterpret_cast<int32_t*>(part_d + static_cast<size_t>(B) * S * N);
  if (Mpad > 0) {
    knn1_targets<<<dim3((Mpad + 255) / 256, B), 256, 0, stream>>>(tgt, mask, t4, M, Mpad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  knn1_search<<<dim3((N + kRows - 1) / kRows, S, B), kThreads, 0, stream>>>(
      src, t4, part_d, part_c, N, Mpad, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn1_merge<<<dim3((N + kMergeWarps - 1) / kMergeWarps, B), kMergeWarps * 32, 0, stream>>>(
      src, t4, part_d, part_c, dists, idx, N, Mpad, S);
  return cudaGetLastError();
}

}  // namespace

// Launches the prologue, the search and the merge on `stream` and returns
// cudaGetLastError() (0 on success). `mask` may be null. Pointers are device
// pointers. The targets are cut into `S` splits of `per` rows (a multiple of
// the chunk, 32), covering M. `scratch` holds, 16-byte aligned, B * Mpad
// float4 targets (Mpad = M rounded up to the chunk), then B * S * N float
// partial minima and as many int32 chunk starts.
extern "C" int gradslam_knn1(const void* src, const void* tgt, const void* mask,
                             void* dists, void* idx, int B, int N, int M, int S,
                             int per, void* scratch, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (S < 1 || per < kChunk || per % kChunk != 0 ||
      static_cast<long long>(S) * per < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const uint8_t*>(mask), static_cast<float*>(dists),
      static_cast<int32_t*>(idx), B, N, M, S, per, static_cast<char*>(scratch),
      static_cast<cudaStream_t>(stream)));
}

// Search blocks that one SM holds at once (the split plan keeps the grid
// within one such wave); 0 on error.
extern "C" int gradslam_knn1_resident_blocks() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn1_search, kThreads, 0) !=
      cudaSuccess) {
    return 0;
  }
  return blocks;
}
