// Best-window similarity for Hopper (sm_90a).
//
// Replaces the Pallas kernel operator_tpu/ops/similarity.py:85
// (_best_window_kernel, launched by _best_window_pallas).  Same function:
// for windows [W, D] and patterns [P, D] (L2-normalised rows, f32 or bf16),
// each pattern's largest float32 dot product over all W windows and the
// SMALLEST window index that reaches it (jnp.argmax's first match).  The
// [W, P] score matrix never reaches device memory.
//
// Layouts (all contiguous, 16-byte aligned, D a multiple of 8):
//   windows  [W, D]  f32 or bf16
//   patterns [P, D]  same dtype
//   scores   [P]     f32    best_idx [P] int32
//   partial scores / indices [S, P] (scratch, only when S > 1)
//
// Design.  The TPU grid walks window blocks in order and carries the
// running max/argmax from one grid step to the next in VMEM; CUDA blocks
// run in no order, so the windows are cut into S shares, each share is
// reduced by its own blocks (pass 1) and the S partials are merged by a
// second, small kernel (pass 2).
//
// Pass 1: grid (ceil(P / 32), S), 256 threads.  A block owns 32 patterns
// and walks its share of the windows in tiles of 64 rows, in increasing
// order.  Each (tile, 64-column chunk of D) step stages the tile's window
// rows and the block's pattern rows in shared memory as f32 (the next
// step's 16-byte loads are in flight while this one is computed) and each
// thread accumulates a 4 x 2 block of dot products with FMAs on the CUDA
// cores: f32 throughout, no TF32, so the scores are those of a float32
// matrix product.  After a tile's last chunk the thread folds its four
// windows into a running (best, index) per pattern, replacing only on a
// strictly greater score, so it keeps the first match among its windows;
// at the end the 16 threads that share a pattern are merged with the tie
// broken to the smaller index.  Every dot product sums d = 0 .. D-1 in
// the same order, whatever the row's place in a tile or share, so equal
// window rows score bit-identically and the first-match rule holds
// exactly.  Pass 2 (S > 1 only): one warp per pattern; each lane takes
// every 32nd share, and the lanes are merged by warp shuffles, with the
// same rule: larger score, then smaller index.  The rule does not depend
// on the order of the merge, and each partial is its share's first best
// window, so the result is the first best window of all W.
// Deterministic; no atomics.
//
// A warp whose 8 window rows of a tile all lie past the share's end skips
// the arithmetic: with W = 1 (incident recall: one query against the
// stored incidents) one warp of eight computes.
//
// What bounds it.  At the analysis shape (W = 4,096 windows, P = 19
// patterns, D = 384) the least time is the read of the window matrix,
// (W + P) * D * 4 bytes at 3.35 TB/s, about 1.9 us; at a library of
// P = 1,024 patterns it is the 2 * W * P * D float32 operations at the
// CUDA cores' 67 TFLOP/s, about 48 us.  This first version reaches
// neither: the products run on a simple register-blocked FMA loop, each
// share re-reads its pattern rows once per window tile (from L2), and a
// pattern tile is padded to 32 rows.  Tensor cores are not an option
// without changing the scores (TF32 keeps 10 mantissa bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "flash_common.cuh"

namespace optorch {
namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 32;   // patterns per block
constexpr int kTileW = 64;   // window rows per tile
constexpr int kChunk = 64;   // columns of D per step
constexpr int kRowsW = 4;    // window rows per thread
constexpr int kRowsP = 2;    // patterns per thread
constexpr int kLanesP = kTileP / kRowsP;  // 16 threads across the patterns
constexpr int kLanesW = kTileW / kRowsW;  // 16 threads across the windows
constexpr int kLd = kChunk + 4;  // padded row: float4-aligned, no bank conflicts
static_assert(kLanesP * kLanesW == kThreads, "thread layout");

template <typename T>
struct Stage {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kVecsPerRow = kChunk / kVec;
  static constexpr int kWindowVecs = kTileW * kVecsPerRow;
  static constexpr int kVecs = (kTileW + kTileP) * kVecsPerRow;
  static constexpr int kLoads = kVecs / kThreads;
  static_assert(kVecs % kThreads == 0, "whole loads per thread");
};

// (s, idx) becomes (s2, i2) when that is the larger score or, on an equal
// score, the earlier window.
__device__ __forceinline__ void take_better(float& s, int& idx, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < idx)) {
    s = s2;
    idx = i2;
  }
}

// This thread's 16-byte loads of one step: window rows [w0, w0 + 64) and
// the block's pattern rows, columns [k0, k0 + 64).  Rows past their end and
// columns past D read as zeros (D is a multiple of 8, so a 16-byte vector is
// either wholly inside D or wholly past it).
template <typename T>
__device__ __forceinline__ void load_step(uint4 (&reg)[Stage<T>::kLoads],
                                          const T* __restrict__ windows,
                                          const T* __restrict__ patterns,
                                          int w0, int w_end, int p0, int P,
                                          int k0, int D) {
  using St = Stage<T>;
#pragma unroll
  for (int i = 0; i < St::kLoads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const bool is_window = v < St::kWindowVecs;
    const int u = is_window ? v : v - St::kWindowVecs;
    const int r = u / St::kVecsPerRow;
    const int d = k0 + (u - r * St::kVecsPerRow) * St::kVec;
    const int row = (is_window ? w0 : p0) + r;
    const bool live = d < D && (is_window ? row < w_end : row < P);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (live) {
      const T* src = (is_window ? windows : patterns) + static_cast<size_t>(row) * D + d;
      x = *reinterpret_cast<const uint4*>(src);
    }
    reg[i] = x;
  }
}

// Convert the loaded step to f32 into shared memory.
template <typename T>
__device__ __forceinline__ void store_step(const uint4 (&reg)[Stage<T>::kLoads],
                                           float* w_s, float* p_s) {
  using St = Stage<T>;
#pragma unroll
  for (int i = 0; i < St::kLoads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const bool is_window = v < St::kWindowVecs;
    const int u = is_window ? v : v - St::kWindowVecs;
    const int r = u / St::kVecsPerRow;
    const int c = (u - r * St::kVecsPerRow) * St::kVec;
    float f[St::kVec];
    unpack(reg[i], f, T());
    float* dst = (is_window ? w_s : p_s) + r * kLd + c;
#pragma unroll
    for (int e = 0; e < St::kVec; e += 4) {
      *reinterpret_cast<float4*>(dst + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
best_window_pass1(const T* __restrict__ windows, const T* __restrict__ patterns,
                  float* __restrict__ part_scores, int* __restrict__ part_idx,
                  int W, int P, int D, int tiles_per_share) {
  __shared__ __align__(16) float w_s[kTileW * kLd];
  __shared__ __align__(16) float p_s[kTileP * kLd];
  __shared__ float red_s[kLanesW][kTileP];
  __shared__ int red_i[kLanesW][kTileP];

  const int p0 = blockIdx.x * kTileP;
  const int share = blockIdx.y;
  const int w_begin = share * tiles_per_share * kTileW;
  const int w_end = min(W, w_begin + tiles_per_share * kTileW);
  const int tiles = (w_end - w_begin + kTileW - 1) / kTileW;
  const int chunks = (D + kChunk - 1) / kChunk;
  const int steps = tiles * chunks;

  // pattern column tp + 16 j, window row tw + 16 i of the tile: a warp
  // covers two window lanes and all 16 pattern lanes
  const int tp = threadIdx.x % kLanesP;
  const int tw = threadIdx.x / kLanesP;
  const int warp_tw0 = (threadIdx.x / 32) * (32 / kLanesP);

  float best[kRowsP];
  int best_idx[kRowsP];
#pragma unroll
  for (int j = 0; j < kRowsP; ++j) {
    best[j] = -INFINITY;
    best_idx[j] = INT_MAX;
  }
  float acc[kRowsW][kRowsP];
#pragma unroll
  for (int i = 0; i < kRowsW; ++i)
#pragma unroll
    for (int j = 0; j < kRowsP; ++j) acc[i][j] = 0.0f;

  uint4 reg[Stage<T>::kLoads];
  load_step<T>(reg, windows, patterns, w_begin, w_end, p0, P, 0, D);

  for (int step = 0; step < steps; ++step) {
    const int tile = step / chunks;
    const int chunk = step - tile * chunks;
    const int w0 = w_begin + tile * kTileW;
    __syncthreads();  // the previous step's rows are no longer read
    store_step<T>(reg, w_s, p_s);
    __syncthreads();
    if (step + 1 < steps) {
      const int next_tile = (step + 1) / chunks;
      const int next_chunk = step + 1 - next_tile * chunks;
      load_step<T>(reg, windows, patterns, w_begin + next_tile * kTileW, w_end, p0,
                   P, next_chunk * kChunk, D);
    }
    // warp-uniform: this warp's lowest window row is past the share's end
    if (w0 + warp_tw0 >= w_end) continue;

#pragma unroll 4
    for (int k = 0; k < kChunk; k += 4) {
      float4 pv[kRowsP];
      float4 wv[kRowsW];
#pragma unroll
      for (int j = 0; j < kRowsP; ++j) {
        pv[j] = *reinterpret_cast<const float4*>(p_s + (tp + kLanesP * j) * kLd + k);
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
        wv[i] = *reinterpret_cast<const float4*>(w_s + (tw + kLanesW * i) * kLd + k);
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
#pragma unroll
        for (int j = 0; j < kRowsP; ++j) {
          float a = acc[i][j];
          a = fmaf(wv[i].x, pv[j].x, a);
          a = fmaf(wv[i].y, pv[j].y, a);
          a = fmaf(wv[i].z, pv[j].z, a);
          a = fmaf(wv[i].w, pv[j].w, a);
          acc[i][j] = a;
        }
      }
    }

    if (chunk == chunks - 1) {
      // the tile's dot products are complete: fold them in, in window order
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
        const int w = w0 + tw + kLanesW * i;
#pragma unroll
        for (int j = 0; j < kRowsP; ++j) {
          if (w < w_end && acc[i][j] > best[j]) {
            best[j] = acc[i][j];
            best_idx[j] = w;
          }
          acc[i][j] = 0.0f;
        }
      }
    }
  }

  // merge the 16 window lanes of each pattern: larger score, then smaller index
#pragma unroll
  for (int j = 0; j < kRowsP; ++j) {
    red_s[tw][tp + kLanesP * j] = best[j];
    red_i[tw][tp + kLanesP * j] = best_idx[j];
  }
  __syncthreads();
  if (threadIdx.x < kTileP && p0 + threadIdx.x < P) {
    const int c = threadIdx.x;
    float s = red_s[0][c];
    int idx = red_i[0][c];
    for (int t = 1; t < kLanesW; ++t) take_better(s, idx, red_s[t][c], red_i[t][c]);
    const size_t out = static_cast<size_t>(share) * P + p0 + c;
    part_scores[out] = s;
    part_idx[out] = idx;
  }
}

constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
best_window_merge(const float* __restrict__ part_scores, const int* __restrict__ part_idx,
                  float* __restrict__ scores, int* __restrict__ best_idx, int P, int S) {
  const int p = (blockIdx.x * kMergeThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // warp-uniform
  float s = -INFINITY;
  int idx = INT_MAX;
  for (int share = lane; share < S; share += 32) {
    const size_t at = static_cast<size_t>(share) * P + p;
    take_better(s, idx, part_scores[at], part_idx[at]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, s, offset);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, offset);
    take_better(s, idx, s2, i2);
  }
  if (lane == 0) {
    scores[p] = s;
    best_idx[p] = idx;
  }
}

template <typename T>
cudaError_t launch(const void* windows, const void* patterns, float* scores,
                   int* best_idx, float* part_scores, int* part_idx, int W, int P,
                   int D, int tiles_per_share, cudaStream_t stream) {
  const int w_tiles = (W + kTileW - 1) / kTileW;
  const int S = (w_tiles + tiles_per_share - 1) / tiles_per_share;
  const dim3 grid((P + kTileP - 1) / kTileP, S);
  // one share: pass 1 writes the result itself
  float* out_s = S == 1 ? scores : part_scores;
  int* out_i = S == 1 ? best_idx : part_idx;
  best_window_pass1<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(windows), static_cast<const T*>(patterns), out_s, out_i,
      W, P, D, tiles_per_share);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const int warps_per_block = kMergeThreads / 32;
  best_window_merge<<<(P + warps_per_block - 1) / warps_per_block, kMergeThreads, 0, stream>>>(
      part_scores, part_idx, scores, best_idx, P, S);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/similarity.py).
// dtype: 0 = float32, 1 = bfloat16.  The windows are cut into shares of
// tiles_per_share tiles of 64 rows; with more than one share the caller
// passes partial buffers of [S, P] floats and ints, S = ceil(ceil(W / 64) /
// tiles_per_share), else they may be null.  Returns the launch status
// (cudaGetLastError), 0 on success.
extern "C" int best_window_launch(const void* windows, const void* patterns,
                                  void* scores, void* best_idx, void* part_scores,
                                  void* part_idx, int W, int P, int D,
                                  int tiles_per_share, int dtype, void* stream) {
  if (W <= 0 || P <= 0 || D <= 0 || D % 8 != 0 || tiles_per_share <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  int* bi = static_cast<int*>(best_idx);
  float* ps = static_cast<float*>(part_scores);
  int* pi = static_cast<int*>(part_idx);
  cudaError_t err;
  if (dtype == 0) {
    err = optorch::launch<float>(windows, patterns, sc, bi, ps, pi, W, P, D,
                                 tiles_per_share, s);
  } else if (dtype == 1) {
    err = optorch::launch<__nv_bfloat16>(windows, patterns, sc, bi, ps, pi, W, P, D,
                                         tiles_per_share, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
