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
//   partial scores / indices [S, P] and counters [ceil(P / TP)] int32
//   zeros (scratch, only when S > 1)
//
// The invariant everything rests on: within one call every (window,
// pattern) dot product sums d = 0 .. D-1 in one fixed order, whatever the
// window's place in a tile or share, so equal window rows score
// bit-identically and "first index of the best score" is exact.  f32
// stays on the CUDA cores (FMA): TF32 would change the scores.  The
// caller picks one layout per call (ops/similarity.py plan):
//
// Tiled layout (configs 1-6), for W > 8.  The TPU grid walks window blocks
// in order and carries the running max/argmax from step to step; CUDA
// blocks run in no order, so the windows are cut into S shares of share_w
// rows, and block (pattern tile, share) reduces its share in tiles of TW
// window rows, in increasing order.  The block's TP pattern rows are
// copied into shared memory once, by cp.async, every column of D (each
// KC columns beside the first tile's copies of the same columns), and stay
// resident for the whole walk.  The window rows stream through a
// ring of kStages stages of KC columns, also by 16-byte cp.async, the
// ring running on across tile edges, so kStages - 1 copies are in flight
// while one stage is computed: a tile costs about one memory latency, not
// one per column step.  A thread holds an RW x RP register tile of dot
// products; a warp is 8 pattern lanes x 4 window lanes, so its 16-byte
// shared loads touch 8 and 4 distinct rows, padded onto distinct banks.
// A 16-byte shared load costs four cycles of the SM's shared-memory port
// whatever it reads, against 4 * RW * RP FMAs, so the register tile sets
// what bounds the loop.  Small libraries (configs 1-4: 8, 16, 24 or 32
// patterns, so the analysis path's 19 take 24, not 32) take an 8 x RP tile
// of 32 windows per warp, and the eight warps share out the columns of
// each stage, 8 each: at the end of a tile each warp's partial sums go to
// shared memory and are added in warp order, and a warp a pattern folds
// the tile's 32 windows, a lane a window, into the pattern's running best.
// Large libraries take an 8 x 8 tile per thread, where the shared port
// and the FMAs balance, over 256 windows and 64 patterns (config 5, rows
// of at most 2 KB), or an 8 x 2 tile over 128 windows and 32 patterns
// (config 6, wider rows, whose resident patterns would not fit), all
// warps on all columns; each thread folds its windows in window order,
// and the window lanes are merged at the end with the tie broken to the
// smaller index.  Either way
// a window's running best is replaced only on a strictly greater score,
// so the first match is kept, and each (window, pattern) sum runs over
// the columns in one order: by column within a warp's share of each
// stage, stages in order, warps' partials in warp order.
//
// One launch.  With one share the block writes its result.  Otherwise it
// writes its share's partial, and the last block of its pattern tile to
// finish (a ticket from the tile's counter, taken after the partial is
// made visible) merges the S partials, one warp per pattern, each lane
// taking every 32nd share, lanes merged by shuffles, by the same rule:
// larger score, then smaller index.  The rule does not depend on the order
// of the merge and each partial is its share's first best window, so the
// result is the first best window of all W, whichever block merges; the
// merging block resets the counter to 0 for the next launch.
// Deterministic; no atomics in the arithmetic.
//
// Rows layout (config 0), for W <= 8 (incident recall: one query against
// the stored incidents).  One warp per pattern, all eight warps of a block
// computing: the windows are staged in shared memory, each lane takes
// every 32nd 16-byte vector of the pattern row and sums its columns in
// order, and a butterfly of shuffles adds the 32 lane sums (each pair is
// added in the same order on both lanes, so every lane holds the same
// bits; every window goes through the same tree).  No shares, no merge.
//
// What bounds it.  At the analysis shape (W = 4,096 windows, P = 19
// patterns, D = 384) the least time is the read of the window matrix,
// (W + P) * D * 4 bytes at 3.35 TB/s, about 1.9 us; at a library of
// P = 1,024 patterns it is the 2 * W * P * D float32 operations at the
// CUDA cores' 67 TFLOP/s, about 48 us; at recall (1 x 2,048) the read of
// the pattern matrix, about 0.9 us.  Short calls are bound by latency:
// one copy of the rows in flight, then the merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "flash_common.cuh"

namespace optorch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsMaxW = 8;  // the rows layout takes at most 8 windows
constexpr int kMaxSmem = 227 * 1024;

// (s, idx) becomes (s2, i2) when that is the larger score or, on an equal
// score, the earlier window.
__device__ __forceinline__ void take_better(float& s, int& idx, float s2, int i2) {
  if (s2 > s || (s2 == s && i2 < idx)) {
    s = s2;
    idx = i2;
  }
}

// four consecutive elements of a shared row, as floats (bf16 -> f32 exact)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Each pattern tile's S partials merged by the last block to finish:
// warp w takes patterns w, w + 8, ... of the tile, each lane a batch of
// shares of every one of them, all the batch's loads in flight at once.
template <int kTileP>
__device__ __forceinline__ void merge_shares(const float* part_scores, const int* part_idx,
                                             float* scores, int* best_idx, int p0, int P,
                                             int S) {
  constexpr int kPer = (kTileP + kWarps - 1) / kWarps;  // patterns a warp
  constexpr int kBatch = kPer > 4 ? 4 : 8;              // shares a lane a batch
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float s[kPer];
  int idx[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    s[k] = -INFINITY;
    idx[k] = INT_MAX;
  }
  for (int share0 = lane; share0 < S; share0 += 32 * kBatch) {
    float s2[kPer][kBatch];
    int i2[kPer][kBatch];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = min(p0 + warp + kWarps * k, P - 1);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const size_t at = static_cast<size_t>(min(share0 + 32 * j, S - 1)) * P + p;
        s2[k][j] = __ldcg(part_scores + at);
        i2[k][j] = __ldcg(part_idx + at);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (share0 + 32 * j < S) take_better(s[k], idx[k], s2[k][j], i2[k][j]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = warp + kWarps * k;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float s3 = __shfl_xor_sync(0xffffffffu, s[k], offset);
      const int i3 = __shfl_xor_sync(0xffffffffu, idx[k], offset);
      take_better(s[k], idx[k], s3, i3);
    }
    if (lane == 0 && c < kTileP && p0 + c < P) {
      scores[p0 + c] = s[k];
      best_idx[p0 + c] = idx[k];
    }
  }
}

// ---------------------------------------------------------------------------
// tiled layout
// ---------------------------------------------------------------------------

// WK groups of warps share out the columns of each ring stage (each group
// KC / WK of them); in a group, WP warps across the patterns and the rest
// across the windows; RP patterns and RW windows a thread; KC columns a
// ring stage, kStages stages.
template <typename T, int WK, int WP, int RP, int RW, int KC, int kStages>
struct Tiled {
  static constexpr int kGroupWarps = kWarps / WK;
  static constexpr int kLanesP = 8 * WP;
  static constexpr int kLanesW = 4 * (kGroupWarps / WP);
  static constexpr int kTileP = kLanesP * RP;
  static constexpr int kTileW = kLanesW * RW;
  static constexpr int kSlice = KC / WK;       // a group's columns of a stage
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kPad = kVec;            // 16 bytes a row: distinct banks
  static constexpr int kLdW = KC + kPad;
  static constexpr int kChunkVecs = KC / kVec;
  // the end-of-tile exchange: WK > 1, each group's partial dot products
  // [WK][kTileW][kTileP]; WK == 1, the window lanes' (best, index)
  static constexpr int kLdRed = kTileP + 1;  // a lane a window: distinct banks
  static constexpr int kRedFloats = WK > 1 ? WK * kTileW * kLdRed : 2 * kLanesW * kTileP;
  static constexpr int kFoldP = (kTileP + kWarps - 1) / kWarps;  // patterns a warp folds
  static constexpr size_t kStaticBytes = sizeof(float) * kRedFloats + 16;
  static_assert(kLanesP * kLanesW * WK == kThreads, "thread layout");
  static_assert(KC % kVec == 0 && kSlice % 4 == 0, "ring stage width");
  static_assert(WK == 1 || (kTileW == 32 && kFoldP <= RP),
                "a column-split tile folds one window a lane into RP running bests");

  static __host__ __device__ int ld_p(int D) { return (D + KC - 1) / KC * KC + kPad; }
  static __host__ size_t smem_bytes(int D) {
    return sizeof(T) * (static_cast<size_t>(kTileP) * ld_p(D) + kStages * kTileW * kLdW);
  }
};

template <typename T, int WK, int WP, int RP, int RW, int KC, int kStages>
__global__ void __launch_bounds__(kThreads)
best_window_tiled(const T* __restrict__ windows, const T* __restrict__ patterns,
                  float* __restrict__ scores, int* __restrict__ best_idx,
                  float* __restrict__ part_scores, int* __restrict__ part_idx,
                  int* __restrict__ counters, int W, int P, int D, int share_w, int S) {
  using L = Tiled<T, WK, WP, RP, RW, KC, kStages>;
  constexpr int kTileP = L::kTileP;
  constexpr int kTileW = L::kTileW;
  constexpr int kLanesP = L::kLanesP;
  constexpr int kLanesW = L::kLanesW;
  constexpr int kLdW = L::kLdW;
  __shared__ __align__(16) float red[L::kRedFloats];
  __shared__ int last_s;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int ld_p = L::ld_p(D);
  T* p_s = reinterpret_cast<T*>(smem_raw);  // [kTileP][ld_p], resident
  T* ring = p_s + kTileP * ld_p;            // [kStages][kTileW][kLdW]

  const int p0 = blockIdx.x * kTileP;
  const int share = blockIdx.y;
  const int w_begin = share * share_w;
  const int w_end = min(W, w_begin + share_w);
  const int tiles = (w_end - w_begin + kTileW - 1) / kTileW;
  const int chunks = (D + KC - 1) / KC;
  const int steps = tiles * chunks;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / L::kGroupWarps;  // this warp's columns of a stage
  const int in_group = warp % L::kGroupWarps;
  const int tp = (in_group % WP) * 8 + lane % 8;
  const int tw = (in_group / WP) * 4 + lane / 8;
  const int warp_tw0 = (in_group / WP) * 4;

  // ring stage `step % kStages` <- window rows of tile step / chunks,
  // columns of chunk step % chunks.  The first tile's steps also bring the
  // pattern rows' columns of their chunk, which then stay resident: the
  // first step waits for one chunk of the patterns, not all of them.
  // Columns past D and rows past P are zeros.
  auto load_step = [&](int step) {
    const int tile = step / chunks;
    const int k0 = (step - tile * chunks) * KC;
    const int w0 = w_begin + tile * kTileW;
    if (tile == 0) {
      for (int v = threadIdx.x; v < kTileP * L::kChunkVecs; v += kThreads) {
        const int r = v / L::kChunkVecs;
        const int c = k0 + (v - r * L::kChunkVecs) * L::kVec;
        const bool ok = p0 + r < P && c < D;
        cp_async_16(p_s + r * ld_p + c,
                    ok ? patterns + static_cast<size_t>(p0 + r) * D + c : patterns, ok);
      }
    }
    T* dst = ring + (step % kStages) * kTileW * kLdW;
    for (int v = threadIdx.x; v < kTileW * L::kChunkVecs; v += kThreads) {
      const int r = v / L::kChunkVecs;
      const int c = (v - r * L::kChunkVecs) * L::kVec;
      const bool ok = w0 + r < w_end && k0 + c < D;
      cp_async_16(dst + r * kLdW + c, ok ? windows + static_cast<size_t>(w0 + r) * D + k0 + c : windows, ok);
    }
  };
  if (steps > 0) load_step(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  float best[RP];
  int best_i[RP];
  float acc[RW][RP];
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    best[j] = -INFINITY;
    best_i[j] = INT_MAX;
#pragma unroll
    for (int i = 0; i < RW; ++i) acc[i][j] = 0.0f;
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `step` have landed
    __syncthreads();               // everyone's have; step - 1's stage is free
    if (step + kStages - 1 < steps) load_step(step + kStages - 1);
    cp_async_commit();
    const int tile = step / chunks;
    const int chunk = step - tile * chunks;
    const int w0 = w_begin + tile * kTileW;
    // warp-uniform: this warp's lowest window row is past the share's end
    // (WK > 1: one row of warps covers the tile, never past the end)
    if (WK == 1 && w0 + warp_tw0 >= w_end) continue;

    const T* w_stage = ring + (step % kStages) * kTileW * kLdW + group * L::kSlice;
    const T* p_chunk = p_s + chunk * KC + group * L::kSlice;
#pragma unroll 4
    for (int k = 0; k < L::kSlice; k += 4) {
      float4 pv[RP];
      float4 wv[RW];
#pragma unroll
      for (int j = 0; j < RP; ++j) pv[j] = load4(p_chunk + (tp + kLanesP * j) * ld_p + k);
#pragma unroll
      for (int i = 0; i < RW; ++i) wv[i] = load4(w_stage + (tw + kLanesW * i) * kLdW + k);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          float a = acc[i][j];
          a = fmaf(wv[i].x, pv[j].x, a);
          a = fmaf(wv[i].y, pv[j].y, a);
          a = fmaf(wv[i].z, pv[j].z, a);
          a = fmaf(wv[i].w, pv[j].w, a);
          acc[i][j] = a;
        }
      }
    }
    if (chunk != chunks - 1) continue;

    // the tile's dot products are complete
    if constexpr (WK == 1) {
      // fold them in, in window order
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int w = w0 + tw + kLanesW * i;
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          if (w < w_end && acc[i][j] > best[j]) {
            best[j] = acc[i][j];
            best_i[j] = w;
          }
          acc[i][j] = 0.0f;
        }
      }
    } else {
      // each group's partial sums to shared memory; then warp w folds
      // patterns w, w + 8, ...: lane n adds window n's partials in group
      // order, and the warp takes the tile's first best by shuffles into
      // the running best, which every lane of the warp holds
      float (*part)[kTileW][L::kLdRed] = reinterpret_cast<float (*)[kTileW][L::kLdRed]>(red);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
#pragma unroll
        for (int j = 0; j < RP; ++j) {
          part[group][tw + kLanesW * i][tp + kLanesP * j] = acc[i][j];
          acc[i][j] = 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < L::kFoldP; ++k) {
        const int c = warp + kWarps * k;
        if (c >= kTileP) break;  // warp-uniform
        float sum = part[0][lane][c];
#pragma unroll
        for (int g = 1; g < WK; ++g) sum += part[g][lane][c];
        const bool live = w0 + lane < w_end;
        float v = live ? sum : -INFINITY;
        int vi = live ? w0 + lane : INT_MAX;
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) {
          const float v2 = __shfl_xor_sync(0xffffffffu, v, offset);
          const int i2 = __shfl_xor_sync(0xffffffffu, vi, offset);
          take_better(v, vi, v2, i2);
        }
        take_better(best[k], best_i[k], v, vi);
      }
    }
  }
  cp_async_wait<0>();

  float s = -INFINITY;
  int idx = INT_MAX;
  if constexpr (WK == 1) {
    // merge the window lanes of each pattern: larger score, then smaller index
    float* red_s = red;
    int* red_i = reinterpret_cast<int*>(red + kLanesW * kTileP);
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      red_s[tw * kTileP + tp + kLanesP * j] = best[j];
      red_i[tw * kTileP + tp + kLanesP * j] = best_i[j];
    }
    __syncthreads();
    if (threadIdx.x < kTileP) {
      const int c = threadIdx.x;
      s = red_s[c];
      idx = red_i[c];
      for (int t = 1; t < kLanesW; ++t) take_better(s, idx, red_s[t * kTileP + c], red_i[t * kTileP + c]);
    }
  } else {
    // lane 0 of warp w holds patterns w, w + 8, ...: hand them to thread c
    float* fin_s = red;
    int* fin_i = reinterpret_cast<int*>(red + kTileP);
    __syncthreads();  // the last fold's reads of red are done
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < L::kFoldP; ++k) {
        const int c = warp + kWarps * k;
        if (c < kTileP) {
          fin_s[c] = best[k];
          fin_i[c] = best_i[k];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < kTileP) {
      s = fin_s[threadIdx.x];
      idx = fin_i[threadIdx.x];
    }
  }
  if (threadIdx.x < kTileP && p0 + threadIdx.x < P) {
    const int c = threadIdx.x;
    if (S == 1) {
      scores[p0 + c] = s;
      best_idx[p0 + c] = idx;
    } else {
      const size_t out = static_cast<size_t>(share) * P + p0 + c;
      part_scores[out] = s;
      part_idx[out] = idx;
    }
  }
  if (S == 1) return;
  // the last block of this pattern tile to finish merges the shares
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(counters + blockIdx.x, 1) == S - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge_shares<kTileP>(part_scores, part_idx, scores, best_idx, p0, P, S);
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// rows layout: W <= 8, one warp per pattern
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
best_window_rows(const T* __restrict__ windows, const T* __restrict__ patterns,
                 float* __restrict__ scores, int* __restrict__ best_idx, int W, int P, int D) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // [W][D]
  const int n = W * D / kVec;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    cp_async_16(w_s + v * kVec, windows + static_cast<size_t>(v) * kVec, true);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * kWarps + warp;
  const int vecs = D / kVec;
  const T* row = patterns + static_cast<size_t>(min(p, P - 1)) * D;
  // this lane's first pattern vector flies while the windows land
  uint4 first = make_uint4(0u, 0u, 0u, 0u);
  if (lane < vecs) first = __ldg(reinterpret_cast<const uint4*>(row) + lane);
  cp_async_wait<0>();
  __syncthreads();
  if (p >= P) return;  // warp-uniform

  float part[kRowsMaxW];
#pragma unroll
  for (int w = 0; w < kRowsMaxW; ++w) part[w] = 0.0f;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 raw = v == lane ? first : __ldg(reinterpret_cast<const uint4*>(row) + v);
    float pf[kVec];
    unpack(raw, pf, T());
#pragma unroll
    for (int w = 0; w < kRowsMaxW; ++w) {
      if (w < W) {
        const T* wr = w_s + w * D + v * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 x = load4(wr + e);
          part[w] = fmaf(pf[e], x.x, part[w]);
          part[w] = fmaf(pf[e + 1], x.y, part[w]);
          part[w] = fmaf(pf[e + 2], x.z, part[w]);
          part[w] = fmaf(pf[e + 3], x.w, part[w]);
        }
      }
    }
  }
  float best = -INFINITY;
  int idx = INT_MAX;
#pragma unroll
  for (int w = 0; w < kRowsMaxW; ++w) {
    if (w < W) {
      const float total = lanes_sum<32>(part[w]);  // the same bits on every lane
      if (total > best) {
        best = total;
        idx = w;
      }
    }
  }
  if (lane == 0) {
    scores[p] = best;
    best_idx[p] = idx;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int WK, int WP, int RP, int RW, int KC, int kStages>
cudaError_t launch_tiled(const void* windows, const void* patterns, float* scores,
                         int* best_idx, float* part_scores, int* part_idx, int* counters,
                         int W, int P, int D, int share_w, int S, cudaStream_t stream) {
  using L = Tiled<T, WK, WP, RP, RW, KC, kStages>;
  auto* kernel = best_window_tiled<T, WK, WP, RP, RW, KC, kStages>;
  const size_t smem_bytes = L::smem_bytes(D);
  // the static exchange arrays count against the same 48 KB that a block
  // gets without asking
  if (smem_bytes + L::kStaticBytes > 48 * 1024) {
    if (smem_bytes + L::kStaticBytes > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((P + L::kTileP - 1) / L::kTileP, S);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(windows), static_cast<const T*>(patterns), scores, best_idx,
      part_scores, part_idx, counters, W, P, D, share_w, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* windows, const void* patterns, float* scores,
                        int* best_idx, int W, int P, int D, cudaStream_t stream) {
  const size_t smem_bytes = sizeof(T) * static_cast<size_t>(W) * D;
  if (W > kRowsMaxW || smem_bytes > 48 * 1024) return cudaErrorInvalidValue;
  best_window_rows<T><<<(P + kWarps - 1) / kWarps, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(windows), static_cast<const T*>(patterns), scores, best_idx, W,
      P, D);
  return cudaGetLastError();
}

// config -> layout; the table best_window_geometry exports
template <typename T>
cudaError_t launch(int config, const void* windows, const void* patterns, float* scores,
                   int* best_idx, float* ps, int* pi, int* counters, int W, int P, int D,
                   int share_w, int S, cudaStream_t stream) {
  switch (config) {
    case 0:
      return S == 1 ? launch_rows<T>(windows, patterns, scores, best_idx, W, P, D, stream)
                    : cudaErrorInvalidValue;
    case 1:
      return launch_tiled<T, 8, 1, 1, 8, 64, 4>(windows, patterns, scores, best_idx, ps, pi,
                                             counters, W, P, D, share_w, S, stream);
    case 2:
      return launch_tiled<T, 8, 1, 2, 8, 64, 4>(windows, patterns, scores, best_idx, ps, pi,
                                             counters, W, P, D, share_w, S, stream);
    case 3:
      return launch_tiled<T, 8, 1, 3, 8, 64, 4>(windows, patterns, scores, best_idx, ps, pi,
                                             counters, W, P, D, share_w, S, stream);
    case 4:
      return launch_tiled<T, 8, 1, 4, 8, 64, 4>(windows, patterns, scores, best_idx, ps, pi,
                                             counters, W, P, D, share_w, S, stream);
    case 5:
      return launch_tiled<T, 1, 1, 8, 8, 16, 3>(windows, patterns, scores, best_idx, ps, pi,
                                             counters, W, P, D, share_w, S, stream);
    case 6:
      return launch_tiled<T, 1, 2, 2, 8, 32, 3>(windows, patterns, scores, best_idx, ps, pi,
                                             counters, W, P, D, share_w, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

constexpr int kConfigs = 7;

template <typename T, int WK, int WP, int RP, int RW, int KC, int kStages>
void geometry_of(int* tile_p, int* tile_w) {
  using L = Tiled<T, WK, WP, RP, RW, KC, kStages>;
  *tile_p = L::kTileP;
  *tile_w = L::kTileW;
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/similarity.py).
// dtype: 0 = float32, 1 = bfloat16.  config picks the layout (0: rows,
// W <= 8; 1-6: tiled, see best_window_geometry).  The windows are cut into
// S shares of share_w rows (S = ceil(W / share_w)); with S > 1 the caller
// passes partial buffers of [S, P] floats and ints and ceil(P / TP) int32
// counters that are zero (the merging blocks leave them zero, so they may
// be reused by the next launch on the same stream), else they may be null.
// Returns the launch status (cudaGetLastError), 0 on success.
extern "C" int best_window_launch(const void* windows, const void* patterns,
                                  void* scores, void* best_idx, void* part_scores,
                                  void* part_idx, void* counters, int W, int P, int D,
                                  int config, int share_w, int S, int dtype, void* stream) {
  if (W <= 0 || P <= 0 || D <= 0 || D % 8 != 0 || share_w <= 0 || S <= 0 ||
      (W + share_w - 1) / share_w != S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S > 1 && (part_scores == nullptr || part_idx == nullptr || counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  int* bi = static_cast<int*>(best_idx);
  float* ps = static_cast<float*>(part_scores);
  int* pi = static_cast<int*>(part_idx);
  int* ct = static_cast<int*>(counters);
  cudaError_t err;
  if (dtype == 0) {
    err = optorch::launch<float>(config, windows, patterns, sc, bi, ps, pi, ct, W, P, D,
                                 share_w, S, s);
  } else if (dtype == 1) {
    err = optorch::launch<__nv_bfloat16>(config, windows, patterns, sc, bi, ps, pi, ct, W,
                                         P, D, share_w, S, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Each layout's (patterns per block, window rows per tile), config 0 .. 6,
// into tile_p[7] and tile_w[7] (config 0, the rows layout: 8 patterns a
// block, at most 8 windows): the one source of the caller's plan and
// scratch shape.  ops/similarity.py holds its copy against these once,
// when it binds the library.
extern "C" int best_window_geometry(int* tile_p, int* tile_w) {
  using optorch::geometry_of;
  tile_p[0] = optorch::kWarps;
  tile_w[0] = optorch::kRowsMaxW;
  geometry_of<float, 8, 1, 1, 8, 64, 4>(tile_p + 1, tile_w + 1);
  geometry_of<float, 8, 1, 2, 8, 64, 4>(tile_p + 2, tile_w + 2);
  geometry_of<float, 8, 1, 3, 8, 64, 4>(tile_p + 3, tile_w + 3);
  geometry_of<float, 8, 1, 4, 8, 64, 4>(tile_p + 4, tile_w + 4);
  geometry_of<float, 1, 1, 8, 8, 16, 3>(tile_p + 5, tile_w + 5);
  geometry_of<float, 1, 2, 2, 8, 32, 3>(tile_p + 6, tile_w + 6);
  return optorch::kConfigs;
}
