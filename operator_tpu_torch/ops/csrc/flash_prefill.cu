// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel operator_tpu/ops/flash_prefill.py:78
// (_flash_prefill_kernel, launched by _flash_prefill_pallas).  Same
// function: a right-padded prefill bucket self-attends, token i of row b at
// position i over keys j with j <= i (causal), j < lengths[b] (validity) and,
// with a sliding window, j > i - window.  GQA with G = QH / KH query heads
// per KV head; scale D^-0.5; float32 online softmax (flash_common.cuh);
// output in q's dtype.  Padded query tokens (i >= lengths[b]) are computed
// under the same mask, as the plain version computes them: they attend over
// the row's valid keys, and a token the window leaves with no key at all
// comes out as the plain version's uniform softmax, the mean of V over all
// T positions.
//
// Layouts (all contiguous):
//   q       [B, T, QH, D]  bf16 or f32
//   k, v    [B, T, KH, D]  same dtype as q, read in place (the head-major
//                          copy the Pallas wrapper makes exists for Mosaic)
//   lengths [B] int32
//   out     [B, T, QH * D] same dtype as q
//
// Two kernels, chosen by dtype (not a fallback: each dtype has one):
//
// bf16 -> flash_prefill_tc_kernel, on the tensor cores.  Grid
// (ceil(T*G / 128), KH, B), the last (longest) tiles first: one block of 8
// warps per (row, KV head, 128 flash rows), a flash row being (query
// token, q head within the GQA group), so with G = 8 a tile holds 16
// tokens.  The block copies its queries and then K and V, 64 keys a stage,
// as bf16 into padded shared memory with 16-byte cp.async, three stages in
// flight; each warp keeps its 16 query rows as mma A fragments and, per
// stage, computes S = Q.K^T with mma.sync.m16n8k16 (bf16 in, f32 out,
// ldmatrix from shared memory), scales and masks the fragments (only the
// stages that cross the causal diagonal, the length or the window pay for
// the mask), folds them into each row's online softmax in base 2
// (update_state_log2: the four lanes of a quad share a row), rounds P to
// bf16 in registers and adds P.V with mma.sync (V through ldmatrix.trans).
// That walk is flash_common.cuh's TcBlock, shared with the ragged kernel;
// this file keeps the span, the addresses, the mask and the output.
//
// f32 -> flash_prefill_kernel, on the CUDA cores: 64 flash rows a
// block, K and V widened into shared memory 32 keys at a time, FMA scores
// and P.V with two threads per row.  TF32 tensor cores would miss the f32
// tolerance and the card-vs-CPU greedy parity of the f32 engines.
//
// Both walk only the keys a tile needs: a tile stops at min(lengths[b],
// its last token + 1) and, with a window, starts at the stage holding its
// first token - window + 1.  Skipped keys are masked for every row of the
// tile, and a masked key is exact to skip: before the row's first live key
// it would be wiped by the rescale (alpha = exp(-1e30 - m) == 0), after it
// it enters with probability 0.  The one exception is a row with no live
// key (a padded token past lengths[b] + window - 1, or lengths[b] <= 0):
// the plain version gives it the mean of V over all T positions, so a tile
// holding such a row walks all T keys, and positions past T (the tail of
// the last stage when T is not a multiple of it) score -inf, which
// contributes nothing even to a fully masked row.
//
// What bounds it.  The function reads q, k and v once and writes out once:
// B * T * (2 * QH + 2 * KH) * D * itemsize bytes; it does 4 * D * QH flops
// for every (query, live key) pair, some B * T^2 * QH * D * 2 for long rows.
// At T = 2048 the two bounds are about equal.  The bf16 kernel re-reads a
// row's keys from L2 once per 128-row tile (half as often as 64-row tiles);
// wgmma over a 64-row warpgroup tile with TMA loads, and a persistent grid,
// are the known next steps.

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace optorch {
namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 2;                   // threads per flash row
constexpr int kBlockM = kThreads / kLanes;  // flash rows per block (64)
constexpr int kBlockN = 32;                 // keys per chunk
constexpr int kKeysPerLane = kBlockN / kLanes;

template <int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(float);
  static constexpr int kVecsPerRow = D / kVec;
  static constexpr int kChunkVecs = kBlockN * kVecsPerRow;
  static constexpr int kLoadsPerThread = (kChunkVecs + kThreads - 1) / kThreads;
  // shared rows padded by 4 floats: float4-aligned, and the 16 query rows
  // a warp reads at once fall on different banks
  static constexpr int kLd = D + 4;
  static constexpr int kLdP = kBlockN + 4;
  static constexpr int kDimsPerLane = D / kLanes;
  static constexpr int kSharedFloats =
      kBlockM * kLd + 2 * kBlockN * kLd + kBlockM * kLdP;
  static_assert(D % (4 * kLanes) == 0 && D % kVec == 0, "unsupported head dim");
};

// This thread's 16-byte loads of one chunk of K and V (keys start ..
// start + kBlockN of row b, head h); keys at or past kv_end read as zeros.
template <int D>
__device__ __forceinline__ void load_chunk(
    uint4 (&k_reg)[Tile<D>::kLoadsPerThread],
    uint4 (&v_reg)[Tile<D>::kLoadsPerThread], const float* __restrict__ k_row0,
    const float* __restrict__ v_row0, int start, int kv_end, int KH) {
  using Tl = Tile<D>;
#pragma unroll
  for (int i = 0; i < Tl::kLoadsPerThread; ++i) {
    const int vec = threadIdx.x + i * kThreads;
    const int n = vec / Tl::kVecsPerRow;
    const int c = vec - n * Tl::kVecsPerRow;
    const int t = start + n;
    uint4 kz = make_uint4(0u, 0u, 0u, 0u);
    uint4 vz = kz;
    if (vec < Tl::kChunkVecs && t < kv_end) {
      const size_t off = static_cast<size_t>(t) * KH * D + c * Tl::kVec;
      kz = *reinterpret_cast<const uint4*>(k_row0 + off);
      vz = *reinterpret_cast<const uint4*>(v_row0 + off);
    }
    k_reg[i] = kz;
    v_reg[i] = vz;
  }
}

template <int D>
__device__ __forceinline__ void store_chunk(
    const uint4 (&k_reg)[Tile<D>::kLoadsPerThread],
    const uint4 (&v_reg)[Tile<D>::kLoadsPerThread], float* k_s, float* v_s) {
  using Tl = Tile<D>;
#pragma unroll
  for (int i = 0; i < Tl::kLoadsPerThread; ++i) {
    const int vec = threadIdx.x + i * kThreads;
    if (vec < Tl::kChunkVecs) {
      const int n = vec / Tl::kVecsPerRow;
      const int c = vec - n * Tl::kVecsPerRow;
      float kf[Tl::kVec];
      float vf[Tl::kVec];
      unpack(k_reg[i], kf, 0.0f);
      unpack(v_reg[i], vf, 0.0f);
      float* k_dst = k_s + n * Tl::kLd + c * Tl::kVec;
      float* v_dst = v_s + n * Tl::kLd + c * Tl::kVec;
#pragma unroll
      for (int e = 0; e < Tl::kVec; e += 4) {
        *reinterpret_cast<float4*>(k_dst + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(v_dst + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lengths,
                     float* __restrict__ out, int T_len, int QH, int KH, int window,
                     float scale) {
  using Tl = Tile<D>;
  constexpr int kLd = Tl::kLd;
  constexpr int kLdP = Tl::kLdP;
  constexpr int kDimsPerLane = Tl::kDimsPerLane;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = QH / KH;
  const int rows_total = T_len * G;
  const int row0 = blockIdx.z * kBlockM;
  const int tok0 = row0 / G;
  const int tok_last = min((row0 + kBlockM - 1) / G, T_len - 1);
  const int length = lengths[b];

  // keys this tile walks (see the header): all T when a row of the tile
  // has no live key, else the live span of its rows
  int kv_begin = 0;
  int kv_end = T_len;
  const bool unmasked_rows =
      length > 0 && (window <= 0 || tok_last < length + window - 1);
  if (unmasked_rows) {
    kv_end = min(length, tok_last + 1);
    if (window > 0) {
      kv_begin = max(tok0 - window + 1, 0);
      kv_begin -= kv_begin % kBlockN;
    }
  }
  const float* k_row0 = k + (static_cast<size_t>(b) * T_len * KH + h) * D;
  const float* v_row0 = v + (static_cast<size_t>(b) * T_len * KH + h) * D;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kBlockM][kLd]
  float* k_s = q_s + kBlockM * kLd;  // [kBlockN][kLd]
  float* v_s = k_s + kBlockN * kLd;  // [kBlockN][kLd]
  float* p_s = v_s + kBlockN * kLd;  // [kBlockM][kLdP]

  uint4 k_reg[Tl::kLoadsPerThread];
  uint4 v_reg[Tl::kLoadsPerThread];
  load_chunk<D>(k_reg, v_reg, k_row0, v_row0, kv_begin, kv_end, KH);

  // stage the tile's queries (rows past the bucket's end read as zeros)
  for (int vec = threadIdx.x; vec < kBlockM * Tl::kVecsPerRow; vec += kThreads) {
    const int r = vec / Tl::kVecsPerRow;
    const int c = vec - r * Tl::kVecsPerRow;
    const int fr = row0 + r;
    float qf[Tl::kVec];
    if (fr < rows_total) {
      const int tok = fr / G;
      const int head = h * G + (fr - tok * G);
      const float* src =
          q + ((static_cast<size_t>(b) * T_len + tok) * QH + head) * D + c * Tl::kVec;
      unpack(*reinterpret_cast<const uint4*>(src), qf, 0.0f);
    } else {
#pragma unroll
      for (int e = 0; e < Tl::kVec; ++e) qf[e] = 0.0f;
    }
    float* dst = q_s + r * kLd + c * Tl::kVec;
#pragma unroll
    for (int e = 0; e < Tl::kVec; e += 4) {
      *reinterpret_cast<float4*>(dst + e) = make_float4(qf[e], qf[e + 1], qf[e + 2], qf[e + 3]);
    }
  }

  const int my_row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int q_pos = (row0 + my_row) / G;
  // a warp whose 16 flash rows all lie past the bucket's end skips the
  // arithmetic and only helps stage K and V (warp-uniform)
  constexpr int kRowsPerWarp = 32 / kLanes;
  const bool warp_live = row0 + (threadIdx.x / 32) * kRowsPerWarp < rows_total;

  SoftmaxState st = init_state();
  float acc[kDimsPerLane];
#pragma unroll
  for (int c = 0; c < kDimsPerLane; ++c) acc[c] = 0.0f;

  for (int start = kv_begin; start < kv_end; start += kBlockN) {
    __syncthreads();  // the previous chunk's K/V/P are no longer read
    store_chunk<D>(k_reg, v_reg, k_s, v_s);
    __syncthreads();
    if (start + kBlockN < kv_end) {
      load_chunk<D>(k_reg, v_reg, k_row0, v_row0, start + kBlockN, kv_end, KH);
    }
    if (!warp_live) continue;

    float s[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[i] = 0.0f;
    const float* q_row = q_s + my_row * kLd;
    const float* k_lane = k_s + lane * kKeysPerLane * kLd;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_row + d);
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(k_lane + i * kLd + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int t = start + lane * kKeysPerLane + i;
      bool live = t <= q_pos && t < length;
      if (window > 0) live = live && t > q_pos - window;
      s[i] = t >= T_len ? -INFINITY : (live ? s[i] * scale : kNegInf);
    }

    const float alpha = update_state<kKeysPerLane, kLanes>(st, s);
    float* p_row = p_s + my_row * kLdP;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; i += 4) {
      *reinterpret_cast<float4*>(p_row + lane * kKeysPerLane + i) =
          make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
    }
    __syncwarp();  // both lanes of the row live in this warp

#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[c] *= alpha;
    const float* v_lane = v_s + lane * kDimsPerLane;
#pragma unroll 2
    for (int n = 0; n < kBlockN; n += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_row + n);
      const float pn[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* v_row = v_lane + (n + j) * kLd;
#pragma unroll
        for (int c = 0; c < kDimsPerLane; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + c);
          acc[c] = fmaf(pn[j], vv.x, acc[c]);
          acc[c + 1] = fmaf(pn[j], vv.y, acc[c + 1]);
          acc[c + 2] = fmaf(pn[j], vv.z, acc[c + 2]);
          acc[c + 3] = fmaf(pn[j], vv.w, acc[c + 3]);
        }
      }
    }
  }

  const int fr = row0 + my_row;
  if (fr < rows_total) {
    const int head = h * G + (fr - q_pos * G);
    float* dst = out + ((static_cast<size_t>(b) * T_len + q_pos) * QH + head) * D +
             lane * kDimsPerLane;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dst[c] = finalize(st, acc[c]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, int B, int T_len, int QH, int KH, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem_bytes = sizeof(float) * Tile<D>::kSharedFloats;
  auto* kernel = flash_prefill_kernel<D>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const int G = QH / KH;
  const dim3 grid(B, KH, (T_len * G + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(out), T_len, QH, KH, window,
      scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dim_f32(int D, const void* q, const void* k, const void* v,
                         const void* lengths, void* out, int B, int T_len, int QH,
                         int KH, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    case 32:
      return launch<32>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    case 64:
      return launch<64>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;  // 128 flash rows a tile

// Two blocks an SM up to D = 64 (at most 128 registers a thread; 129
// without the bound left room for one block of 8 warps); at D = 128 the
// fragments alone take 128 registers, so one.
template <int D>
__global__ void __launch_bounds__(TcBlock<D, kTcWarps>::kThreads, D <= 64 ? 2 : 1)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ lengths,
                        bf16* __restrict__ out, int T_len, int QH, int KH, int window,
                        float scale_log2) {
  using Blk = TcBlock<D, kTcWarps>;

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = QH / KH;
  const int rows_total = T_len * G;
  const int row0 = tile * Blk::kRows;
  const int tok0 = row0 / G;
  const int tok_last = min((row0 + Blk::kRows - 1) / G, T_len - 1);
  const int length = lengths[b];

  // keys this tile walks (see the header)
  int kv_begin = 0;
  int kv_end = T_len;
  if (length > 0 && (window <= 0 || tok_last < length + window - 1)) {
    kv_end = min(length, tok_last + 1);
    if (window > 0) {
      kv_begin = max(tok0 - window + 1, 0);
      kv_begin -= kv_begin % kTcKeys;
    }
  }
  const size_t kv_stride = static_cast<size_t>(KH) * D;  // between tokens
  const size_t head0 = (static_cast<size_t>(b) * T_len * KH + h) * D;
  // flash row fr of this (row, KV head): token fr / G, q head h * G + fr % G
  auto row_offset = [&](int fr) {
    const int tok = fr / G;
    return ((static_cast<size_t>(b) * T_len + tok) * QH + h * G + (fr - tok * G)) * D;
  };
  const int pos_a = (row0 + Blk::row(0)) / G;  // this lane's two tokens
  const int pos_b = (row0 + Blk::row(1)) / G;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename Blk::Warp wt;
  const bool warp_live = Blk::walk(
      wt, smem_raw, k + head0, v + head0, kv_begin, kv_end, rows_total - row0, scale_log2,
      [&](int r) { return q + row_offset(row0 + r); },
      [&](int t) { return static_cast<size_t>(t) * kv_stride; },
      // the stages crossing the causal diagonal, the length, the bucket's
      // end or the window's start
      [&](int start) {
        return start + kTcKeys - 1 > tok0 || start + kTcKeys > length ||
               start + kTcKeys > T_len || (window > 0 && start <= tok_last - window);
      },
      [&](float x, int t, int half) {
        const int pos = half ? pos_b : pos_a;
        bool live = t <= pos && t < length;
        if (window > 0) live = live && t > pos - window;
        return t >= T_len ? -INFINITY : (live ? x : kNegInf);
      });
  if (!warp_live) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = row0 + Blk::row(half);
    if (fr < rows_total) wt.store_bf16(half, out + row_offset(fr), threadIdx.x & 31);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* lengths,
                      void* out, int B, int T_len, int QH, int KH, int window, float scale,
                      cudaStream_t stream) {
  using Blk = TcBlock<D, kTcWarps>;
  const size_t smem_bytes = Blk::kSmemBytes;
  auto* kernel = flash_prefill_tc_kernel<D>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const int G = QH / KH;
  const dim3 grid((T_len * G + Blk::kRows - 1) / Blk::kRows, KH, B);
  kernel<<<grid, Blk::kThreads, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), T_len, QH, KH, window,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch_dim_tc(int D, const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int B, int T_len, int QH, int KH,
                            int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_tc<16>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    case 32:
      return launch_tc<32>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    case 64:
      return launch_tc<64>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    case 128:
      return launch_tc<128>(q, k, v, lengths, out, B, T_len, QH, KH, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/flash_prefill.py).
// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel).  window <= 0 means no sliding window.
// scale is the score scale, D^-0.5, computed by the caller.  Returns the
// launch status (cudaGetLastError), 0 on success.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int T_len,
                                    int QH, int KH, int D, int window, float scale,
                                    int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || KH <= 0 || QH % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = optorch::dispatch_dim_f32(D, q, k, v, lengths, out, B, T_len, QH, KH,
                                       window, scale, s);
  } else if (dtype == 1) {
    err = optorch::dispatch_dim_tc(D, q, k, v, lengths, out, B, T_len, QH, KH, window,
                                   scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
