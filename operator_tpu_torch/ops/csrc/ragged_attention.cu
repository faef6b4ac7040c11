// Ragged mixed-phase paged attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel operator_tpu/ops/ragged_attention.py:114
// (_ragged_attn_kernel, launched by _ragged_attention_pallas).  Same
// function: row b's q_count[b] query tokens sit at positions
// kv_len[b] - q_count[b] + i and attend causally (plus an optional sliding
// window, plus the kv_len bound) over that row's pages, reached through
// page_table; GQA with G = QH / KH query heads per KV head; scale D^-0.5;
// float32 online softmax (flash_common.cuh); output in q's dtype.  Rows with
// q_count == 0 do no work, and padding rows i >= q_count[b] are don't-care
// (they may be left unwritten: the mixed step gathers only valid rows).
//
// Layouts (all contiguous):
//   q        [B, C, QH, D]            bf16 or f32
//   k_pages  [num_pages, page, KH, D] same dtype as q (one layer)
//   v_pages  likewise
//   page_table [B, pages_per_seq] int32, kv_len [B] int32, q_count [B] int32
//   out      [B, C, QH, D]            same dtype as q
//
// Design.  Grid (B, KH, ceil(C*G / BM)): one block takes one batch row, one
// KV head and a tile of BM "flash rows", a flash row being (query token,
// q head within the GQA group) — so the G = 8 heads of a decode row
// (C = 1) already fill 8 rows of a tile.  The block reads its own kv_len,
// q_count and page ids (no scalar prefetch on this card), stages the
// tile's queries once and then walks the KV positions in chunks of BN
// tokens: each chunk's K and V rows are gathered through the page table
// into shared memory (converted to float), scored with FMAs, folded into
// the running (m, l) state kept in registers, and multiplied into the
// float accumulator, also in registers.  Two threads share a flash row
// (LANES = 2): each owns half of the chunk's scores and half of the
// row's D accumulator columns.  A warp whose 16 flash rows are all past
// the row's last live query skips the arithmetic: a decode row (G = 8
// live rows of 64) then costs one warp's work per chunk, not four.
//
// Only live KV is walked: a tile starts at the first position its
// earliest query can see (window) and stops after the last position its
// latest live query can see (causal bound, never past kv_len).  Skipping
// the positions before the window is exact because they would enter the
// state before any live key and be wiped out by the first rescale (alpha
// == 0); skipping those after the causal bound is exact because they would
// enter with probability exp(-1e30 - m) == 0.
//
// What bounds it.  At serving shapes the kernel is a read of the live KV:
// sum_b min(kv_len_b, window) * KH * D * 2 (K and V) * 2 bytes, plus the q
// rows it reads and the out rows it writes, against 3.35 TB/s.  This
// first version does not reach that bound: the scores and P.V run on the
// CUDA cores in float32, and a prefill row's tiles each re-read the row's
// KV (from L2, mostly).  wgmma, TMA page loads, a cp.async double buffer and
// split-KV for long decode rows are the known next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace optorch {
namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 2;                   // threads per flash row
constexpr int kBlockM = kThreads / kLanes;  // flash rows per block (64)
constexpr int kBlockN = 32;                 // KV positions per chunk
constexpr int kKeysPerLane = kBlockN / kLanes;

template <typename T, int D>
struct Tile {
  // global memory is read 16 bytes per thread per load
  static constexpr int kVec = 16 / sizeof(T);
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

// Issue this thread's 16-byte loads of one chunk of K and V rows (KV
// positions start .. start + kBlockN, gathered through the page table);
// positions at or past kv_end read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_chunk(
    uint4 (&k_reg)[Tile<T, D>::kLoadsPerThread],
    uint4 (&v_reg)[Tile<T, D>::kLoadsPerThread], const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table, int start,
    int kv_end, int page_size, int KH, int h) {
  using Tl = Tile<T, D>;
#pragma unroll
  for (int i = 0; i < Tl::kLoadsPerThread; ++i) {
    const int vec = threadIdx.x + i * kThreads;
    const int n = vec / Tl::kVecsPerRow;
    const int c = vec - n * Tl::kVecsPerRow;
    const int t = start + n;
    uint4 kz = make_uint4(0u, 0u, 0u, 0u);
    uint4 vz = kz;
    if (vec < Tl::kChunkVecs && t < kv_end) {
      const int page_idx = t / page_size;
      const int slot = t - page_idx * page_size;
      const size_t off =
          ((static_cast<size_t>(table[page_idx]) * page_size + slot) * KH + h) * D +
          c * Tl::kVec;
      kz = *reinterpret_cast<const uint4*>(k_pages + off);
      vz = *reinterpret_cast<const uint4*>(v_pages + off);
    }
    k_reg[i] = kz;
    v_reg[i] = vz;
  }
}

// Convert the loaded chunk to float into shared memory.
template <typename T, int D>
__device__ __forceinline__ void store_chunk(
    const uint4 (&k_reg)[Tile<T, D>::kLoadsPerThread],
    const uint4 (&v_reg)[Tile<T, D>::kLoadsPerThread], float* k_s, float* v_s) {
  using Tl = Tile<T, D>;
#pragma unroll
  for (int i = 0; i < Tl::kLoadsPerThread; ++i) {
    const int vec = threadIdx.x + i * kThreads;
    if (vec < Tl::kChunkVecs) {
      const int n = vec / Tl::kVecsPerRow;
      const int c = vec - n * Tl::kVecsPerRow;
      float kf[Tl::kVec];
      float vf[Tl::kVec];
      unpack(k_reg[i], kf, T());
      unpack(v_reg[i], vf, T());
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ q_count, T* __restrict__ out,
                        int C, int QH, int KH, int page_size, int pages_per_seq,
                        int window, float scale) {
  using Tl = Tile<T, D>;
  constexpr int kLd = Tl::kLd;
  constexpr int kLdP = Tl::kLdP;
  constexpr int kDimsPerLane = Tl::kDimsPerLane;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = QH / KH;
  const int rows_total = C * G;
  const int row0 = blockIdx.z * kBlockM;
  const int count = q_count[b];
  const int tok0 = row0 / G;
  if (count <= 0 || tok0 >= count) return;  // no live query in this tile

  const int seq_len = kv_len[b];
  const int q_base = seq_len - count;  // absolute position of query token 0
  const int tok_last = min((row0 + kBlockM - 1) / G, count - 1);
  const int kv_end = min(seq_len, q_base + tok_last + 1);
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(q_base + tok0 - window + 1, 0);
    kv_begin -= kv_begin % kBlockN;
  }
  const int* table = page_table + static_cast<size_t>(b) * pages_per_seq;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kBlockM][kLd]
  float* k_s = q_s + kBlockM * kLd;  // [kBlockN][kLd]
  float* v_s = k_s + kBlockN * kLd;  // [kBlockN][kLd]
  float* p_s = v_s + kBlockN * kLd;  // [kBlockM][kLdP]

  // first KV chunk in flight while the queries are staged
  uint4 k_reg[Tl::kLoadsPerThread];
  uint4 v_reg[Tl::kLoadsPerThread];
  load_chunk<T, D>(k_reg, v_reg, k_pages, v_pages, table, kv_begin, kv_end,
                   page_size, KH, h);

  // stage the tile's queries (rows past the tile's end read as zeros)
  for (int vec = threadIdx.x; vec < kBlockM * Tl::kVecsPerRow; vec += kThreads) {
    const int r = vec / Tl::kVecsPerRow;
    const int c = vec - r * Tl::kVecsPerRow;
    const int fr = row0 + r;
    float qf[Tl::kVec];
    if (fr < rows_total) {
      const int tok = fr / G;
      const int head = h * G + (fr - tok * G);
      const T* src =
          q + ((static_cast<size_t>(b) * C + tok) * QH + head) * D + c * Tl::kVec;
      unpack(*reinterpret_cast<const uint4*>(src), qf, T());
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
  const int my_tok = (row0 + my_row) / G;
  const int q_pos = q_base + my_tok;
  // A warp whose flash rows all lie past the last live query (a decode
  // row fills only G of the tile's rows) skips the arithmetic and only
  // helps stage K and V.  Warp-uniform, so the shuffles stay whole.
  constexpr int kRowsPerWarp = 32 / kLanes;
  const bool warp_live = row0 + (threadIdx.x / 32) * kRowsPerWarp < count * G;

  SoftmaxState st = init_state();
  float acc[kDimsPerLane];
#pragma unroll
  for (int k = 0; k < kDimsPerLane; ++k) acc[k] = 0.0f;

  for (int start = kv_begin; start < kv_end; start += kBlockN) {
    __syncthreads();  // the previous chunk's K/V/P are no longer read
    store_chunk<T, D>(k_reg, v_reg, k_s, v_s);
    __syncthreads();
    if (start + kBlockN < kv_end) {
      // the next chunk's loads fly while this one is computed
      load_chunk<T, D>(k_reg, v_reg, k_pages, v_pages, table, start + kBlockN,
                       kv_end, page_size, KH, h);
    }
    if (!warp_live) continue;

    // this lane's kKeysPerLane scores of its flash row
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
      bool live = (t <= q_pos) && (t < kv_end);
      if (window > 0) live = live && (t > q_pos - window);
      s[i] = live ? s[i] * scale : kNegInf;
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
    for (int k = 0; k < kDimsPerLane; ++k) acc[k] *= alpha;
    const float* v_lane = v_s + lane * kDimsPerLane;
#pragma unroll 2
    for (int n = 0; n < kBlockN; n += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_row + n);
      const float pn[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* v_row = v_lane + (n + j) * kLd;
#pragma unroll
        for (int k = 0; k < kDimsPerLane; k += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + k);
          acc[k] = fmaf(pn[j], vv.x, acc[k]);
          acc[k + 1] = fmaf(pn[j], vv.y, acc[k + 1]);
          acc[k + 2] = fmaf(pn[j], vv.z, acc[k + 2]);
          acc[k + 3] = fmaf(pn[j], vv.w, acc[k + 3]);
        }
      }
    }
  }

  const int fr = row0 + my_row;
  if (fr < rows_total && my_tok < count) {
    const int head = h * G + (fr - my_tok * G);
    T* dst = out + ((static_cast<size_t>(b) * C + my_tok) * QH + head) * D +
             lane * kDimsPerLane;
#pragma unroll
    for (int k = 0; k < kDimsPerLane; ++k) dst[k] = from_float<T>(finalize(st, acc[k]));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* kv_len,
                   const void* q_count, void* out, int B, int C, int QH, int KH,
                   int page_size, int pages_per_seq, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem_bytes = sizeof(float) * Tile<T, D>::kSharedFloats;
  auto* kernel = ragged_attention_kernel<T, D>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const int G = QH / KH;
  const dim3 grid(B, KH, (C * G + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_count),
      static_cast<T*>(out), C, QH, KH, page_size, pages_per_seq, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k_pages,
                         const void* v_pages, const void* page_table,
                         const void* kv_len, const void* q_count, void* out,
                         int B, int C, int QH, int KH, int page_size,
                         int pages_per_seq, int window, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                           B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                           B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                           B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                            B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/ragged_attention.py).
// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// scale is the score scale, D^-0.5, computed by the caller.  Returns the launch status (cudaGetLastError), 0 on success.
extern "C" int ragged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, const void* q_count, void* out,
    int B, int C, int QH, int KH, int D, int page_size, int pages_per_seq,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || KH <= 0 || QH % KH != 0 || page_size <= 0 ||
      pages_per_seq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = optorch::dispatch_dim<float>(D, q, k_pages, v_pages, page_table, kv_len,
                                       q_count, out, B, C, QH, KH, page_size,
                                       pages_per_seq, window, scale, s);
  } else if (dtype == 1) {
    err = optorch::dispatch_dim<__nv_bfloat16>(D, q, k_pages, v_pages, page_table,
                                               kv_len, q_count, out, B, C, QH, KH,
                                               page_size, pages_per_seq, window, scale,
                                               s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
