// Brute-force 1-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel gradslam_tpu/ops/knn_pallas.py:_knn_kernel. For
// every source point it returns the squared distance and the int32 index of
// the nearest valid target, with the contract of the plain PyTorch version
// (gradslam_torch/ops/knn.py:nn_points):
//   d2 = |s|^2 + (|t|^2 + penalty) - 2 s.t   (expanded form, float32 FMA)
//   masked targets are zeroed and carry a +1e30 penalty;
//   ties go to the smallest index; the result is clamped to >= 0.
//
// Design. One thread per source point, 256 threads a block, grid
// (ceil(N / 256), B). Targets stream through shared memory in tiles of 1024
// float4 (x, y, z, |t|^2 + penalty), 16 KB a tile; every thread of the block
// reads each target by broadcast. Each thread keeps its running
// (best_d, best_i) in registers and walks the targets in ascending order,
// taking a target only on a strictly smaller d2: that is the smallest-index
// tie-break with no second pass.
//
// What bounds it on this card: float32 FMA issue, about 8 flops per
// (source, target) pair (three FMAs for the cross term, one for the distance,
// the compare and two selects); it reads O(N + M) bytes from device memory.
// No TF32 and no tensor cores: the cross term cancels against |s|^2 + |t|^2,
// and a reduced-precision cross term flips indices (bf16 flipped 38% of them
// on the TPU). Known weakness: at the tracked slice's N = 19,200 the grid
// has 75 blocks, fewer than the card's 132 SMs; splitting the targets across
// blocks and reducing in a second pass is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kInf = 1e30f;

__global__ void __launch_bounds__(kThreads)
knn1_kernel(const float* __restrict__ src,     // (B, N, 3)
            const float* __restrict__ tgt,     // (B, M, 3)
            const uint8_t* __restrict__ mask,  // (B, M) or null
            float* __restrict__ dists,         // (B, N)
            int32_t* __restrict__ idx,         // (B, N)
            int N, int M) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;

  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (live) {
    const float* s = src + (static_cast<size_t>(b) * N + n) * 3;
    sx = s[0];
    sy = s[1];
    sz = s[2];
  }
  const float s2 = fmaf(sz, sz, fmaf(sy, sy, sx * sx));
  const float* t = tgt + static_cast<size_t>(b) * M * 3;
  const uint8_t* mk = mask ? mask + static_cast<size_t>(b) * M : nullptr;

  float best_d = kInf;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    const int count = min(kTile, M - base);
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const int m = base + j;
      const bool ok = mk == nullptr || mk[m] != 0;
      // masked rows are zeroed before use: NaN padding stays out of d2
      const float x = ok ? t[3 * m] : 0.f;
      const float y = ok ? t[3 * m + 1] : 0.f;
      const float z = ok ? t[3 * m + 2] : 0.f;
      const float t2 = fmaf(z, z, fmaf(y, y, x * x));
      tile[j] = make_float4(x, y, z, ok ? t2 : t2 + kInf);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const float4 v = tile[j];
      const float cross = fmaf(sz, v.z, fmaf(sy, v.y, sx * v.x));
      const float d = fmaf(-2.f, cross, s2 + v.w);
      if (d < best_d) {
        best_d = d;
        best_i = base + j;
      }
    }
    __syncthreads();
  }
  if (live) {
    const size_t o = static_cast<size_t>(b) * N + n;
    dists[o] = fmaxf(best_d, 0.f);
    idx[o] = best_i;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). `mask` may be null. Pointers are device pointers.
extern "C" int gradslam_knn1(const void* src, const void* tgt, const void* mask,
                             void* dists, void* idx, int B, int N, int M,
                             void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  knn1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const uint8_t*>(mask), static_cast<float*>(dists),
      static_cast<int32_t*>(idx), N, M);
  return static_cast<int>(cudaGetLastError());
}
