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
// Two kernels, chosen by dtype (not a fallback: each dtype has one):
//
// bf16 -> ragged_attention_tc_kernel, on the tensor cores, with split-KV.
// A tile is 64 "flash rows", a flash row being (query token, q head within
// the GQA group), so the G = 8 heads of a decode row fill 8 rows of tile 0.
// Four warps own 16 rows each.  The block reads its own kv_len, q_count and
// page ids (no scalar prefetch on this card), copies its queries and then
// gathers K and V through the page table as bf16 into padded shared memory
// with 16-byte cp.async (one head's slice of a page row is D bf16, KH * D
// apart from the next position's), 64 positions a stage, three stages in
// flight.  Each live warp computes S = Q.K^T with mma.sync.m16n8k16 (dead
// rows of a decode or verify tile are zero queries whose results are never
// written), masks only the stages that cross the causal diagonal, kv_len or
// the window's start, folds the fragments into the online softmax in base
// 2, rounds P to bf16 in registers and adds P.V with mma.sync.  A warp
// whose rows are all past the last live query only helps load.  That walk
// is flash_common.cuh's TcBlock, shared with the prefill kernel; this file
// keeps the spans, the page-table addresses, the mask and the outputs.
//
// Split-KV.  Tile 0 holds every decode and verify row's queries, and its
// key span is the whole live cache of the row: a chain of up to
// pages_per_seq * page_size / 64 dependent stages in one block.  So tile 0
// is cut into n_splits spans of split_keys positions (a multiple of the
// stage), each walked by its own block, which writes its (m, l, acc)
// partial to f32 scratch; ragged_merge_kernel then combines each row's
// partials in split order (deterministic, no atomics).  Tiles 1 .. (prefill
// chunks longer than 64 / G tokens) are walked whole.  The plan (n_splits,
// split_keys, the scratch) comes from the caller and depends on shapes
// only: the mixed step never reads kv_len on the host.
//
// f32 -> ragged_attention_kernel, on the CUDA cores: grid (B, KH,
// ceil(C*G / 64)), K and V widened to float in shared memory 32 positions
// a chunk, FMA scores and P.V with two threads per flash row, no split.
// TF32 tensor cores would miss the f32 tolerance and the card-vs-CPU greedy
// parity of the f32 engines.
//
// Only live KV is walked: a tile starts at the first position its
// earliest query can see (window) and stops after the last position its
// latest live query can see (causal bound, never past kv_len).  Skipping
// the positions before the window is exact because they would enter the
// state before any live key and be wiped out by the first rescale (alpha
// == 0); skipping those after the causal bound is exact because they would
// enter with probability exp(-1e30 - m) == 0.  A split whose keys are all
// masked for a row carries m = -1e30 with l > 0 (each masked key folds in
// exp(0)); the merge weights it by exp2(-1e30 - m_max) == 0 for a row with
// a live key anywhere, exactly as the one-block walk's rescale would.
//
// What bounds it.  At serving shapes the kernel is a read of the live KV:
// sum_b min(kv_len_b, window) * KH * D * 2 (K and V) * 2 bytes, plus the q
// rows it reads and the out rows it writes, against 3.35 TB/s.  Still open:
// wgmma and TMA page loads, a persistent grid, splitting the prefill tiles.

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

template <int D>
struct Tile {
  // global memory is read 16 bytes per thread per load
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

// Issue this thread's 16-byte loads of one chunk of K and V rows (KV
// positions start .. start + kBlockN, gathered through the page table);
// positions at or past kv_end read as zeros.
template <int D>
__device__ __forceinline__ void load_chunk(
    uint4 (&k_reg)[Tile<D>::kLoadsPerThread],
    uint4 (&v_reg)[Tile<D>::kLoadsPerThread], const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ table, int start,
    int kv_end, int page_size, int KH, int h) {
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
ragged_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                        const float* __restrict__ v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ q_count, float* __restrict__ out,
                        int C, int QH, int KH, int page_size, int pages_per_seq,
                        int window, float scale) {
  using Tl = Tile<D>;
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
  load_chunk<D>(k_reg, v_reg, k_pages, v_pages, table, kv_begin, kv_end,
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
      const float* src =
          q + ((static_cast<size_t>(b) * C + tok) * QH + head) * D + c * Tl::kVec;
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
    store_chunk<D>(k_reg, v_reg, k_s, v_s);
    __syncthreads();
    if (start + kBlockN < kv_end) {
      // the next chunk's loads fly while this one is computed
      load_chunk<D>(k_reg, v_reg, k_pages, v_pages, table, start + kBlockN,
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
    float* dst = out + ((static_cast<size_t>(b) * C + my_tok) * QH + head) * D +
             lane * kDimsPerLane;
#pragma unroll
    for (int k = 0; k < kDimsPerLane; ++k) dst[k] = finalize(st, acc[k]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* kv_len,
                   const void* q_count, void* out, int B, int C, int QH, int KH,
                   int page_size, int pages_per_seq, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem_bytes = sizeof(float) * Tile<D>::kSharedFloats;
  auto* kernel = ragged_attention_kernel<D>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const int G = QH / KH;
  const dim3 grid(B, KH, (C * G + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_count),
      static_cast<float*>(out), C, QH, KH, page_size, pages_per_seq, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dim_f32(int D, const void* q, const void* k_pages,
                         const void* v_pages, const void* page_table,
                         const void* kv_len, const void* q_count, void* out,
                         int B, int C, int QH, int KH, int page_size,
                         int pages_per_seq, int window, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                           B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    case 32:
      return launch<32>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                           B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    case 64:
      return launch<64>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                           B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    case 128:
      return launch<128>(q, k_pages, v_pages, page_table, kv_len, q_count, out,
                            B, C, QH, KH, page_size, pages_per_seq, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, split-KV
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcBlockM = kTcWarps * 16;  // flash rows per tile (64)
constexpr int kMaxSplits = 16;
constexpr int kMergeThreads = 128;

// The KV positions [begin, end) a tile of tokens tok0 .. tok_last walks
// (begin aligned down to a stage); the split blocks and the merge both
// derive their spans from it.
struct Span {
  int begin;
  int end;
};

__device__ __forceinline__ Span tile_span(int seq_len, int count, int tok0, int tok_last,
                                          int window) {
  const int q_base = seq_len - count;
  Span span;
  span.end = min(seq_len, q_base + tok_last + 1);
  span.begin = 0;
  if (window > 0) {
    span.begin = max(q_base + tok0 - window + 1, 0);
    span.begin -= span.begin % kTcKeys;
  }
  return span;
}

// Work item blockIdx.x of (row b = blockIdx.z, KV head h = blockIdx.y):
// with n_splits > 1, items 0 .. n_tiles - 2 are tiles 1 .. n_tiles - 1
// (walked whole, written to out) and the last n_splits items are the
// splits of tile 0 (each writes its (m, l, acc) partial for the merge);
// with n_splits == 1 item i is tile i, written to out.
template <int D>
__global__ void __launch_bounds__(TcBlock<D, kTcWarps>::kThreads)
ragged_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                           const bf16* __restrict__ v_pages,
                           const int* __restrict__ page_table,
                           const int* __restrict__ kv_len,
                           const int* __restrict__ q_count, bf16* __restrict__ out,
                           float* __restrict__ part_acc, float* __restrict__ part_ml,
                           int C, int QH, int KH, int page_size, int pages_per_seq,
                           int window, int n_splits, int split_keys, float scale_log2) {
  using Blk = TcBlock<D, kTcWarps>;
  static_assert(Blk::kRows == kTcBlockM, "the merge and the scratch assume 64-row tiles");

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = QH / KH;
  const int rows_total = C * G;
  const int n_tiles = (rows_total + kTcBlockM - 1) / kTcBlockM;
  int tile = blockIdx.x;
  int split = -1;
  if (n_splits > 1) {
    if (tile >= n_tiles - 1) {
      split = tile - (n_tiles - 1);
      tile = 0;
    } else {
      tile += 1;
    }
  }
  const int count = q_count[b];
  const int seq_len = kv_len[b];  // read beside count: one latency, not two
  const int row0 = tile * kTcBlockM;
  const int tok0 = row0 / G;
  if (count <= 0 || tok0 >= count) return;  // no live query in this tile

  const int q_base = seq_len - count;  // absolute position of query token 0
  const int tok_last = min((row0 + kTcBlockM - 1) / G, count - 1);
  const Span span = tile_span(seq_len, count, tok0, tok_last, window);
  int kv_begin = span.begin;
  int kv_end = span.end;
  if (split >= 0) {
    kv_begin = max(kv_begin, split * split_keys);
    if (split + 1 < n_splits) kv_end = min(kv_end, (split + 1) * split_keys);
    if (kv_end <= kv_begin) return;  // the merge skips this split
  }
  const int* table = page_table + static_cast<size_t>(b) * pages_per_seq;
  const int live_rows = min(count * G, rows_total);
  // flash row fr of this (row, KV head): token fr / G, q head h * G + fr % G
  auto row_offset = [&](int fr) {
    const int tok = fr / G;
    return ((static_cast<size_t>(b) * C + tok) * QH + h * G + (fr - tok * G)) * D;
  };
  const int pos_a = q_base + (row0 + Blk::row(0)) / G;  // this lane's two positions
  const int pos_b = q_base + (row0 + Blk::row(1)) / G;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename Blk::Warp wt;
  const bool warp_live = Blk::walk(
      wt, smem_raw, k_pages, v_pages, kv_begin, kv_end, live_rows - row0, scale_log2,
      [&](int r) { return q + row_offset(row0 + r); },
      // through the page table: one head's slice of a page row is D bf16,
      // KH * D apart from the next position's
      [&](int t) {
        const int page_idx = t / page_size;
        const int slot = t - page_idx * page_size;
        return ((static_cast<size_t>(table[page_idx]) * page_size + slot) * KH + h) * D;
      },
      // the stages crossing kv_end, the causal diagonal or the window's start
      [&](int start) {
        return start + kTcKeys > kv_end || start + kTcKeys - 1 > q_base + tok0 ||
               (window > 0 && start <= q_base + tok_last - window);
      },
      [&](float x, int t, int half) {
        const int pos = half ? pos_b : pos_a;
        bool live = t <= pos && t < kv_end;
        if (window > 0) live = live && t > pos - window;
        return live ? x : kNegInf;
      });
  if (!warp_live) return;

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int fr = row0 + Blk::row(half);
    if (fr >= live_rows) continue;
    if (split >= 0) {
      const size_t slot =
          ((static_cast<size_t>(b) * KH + h) * n_splits + split) * kTcBlockM + fr;
      wt.store_partial(half, part_acc + slot * D, part_ml + slot * 2, lane);
    } else {
      wt.store_bf16(half, out + row_offset(fr), lane);
    }
  }
}

// Combine tile 0's split partials of (row b = blockIdx.y, KV head h =
// blockIdx.x) in split order, by flash_common.cuh's merge_partials (the
// arithmetic the paged decode kernel shares): each split weighted by
// exp2(m_s - m_max).  Deterministic: no atomics, a fixed order.
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
ragged_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    const int* __restrict__ kv_len, const int* __restrict__ q_count,
                    bf16* __restrict__ out, int C, int QH, int KH, int window,
                    int n_splits, int split_keys) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int count = q_count[b];
  const int seq_len = kv_len[b];
  if (count <= 0) return;
  const int G = QH / KH;
  const int rows = min(min(count * G, C * G), kTcBlockM);
  const int tok_last = min((kTcBlockM - 1) / G, count - 1);
  const Span span = tile_span(seq_len, count, 0, tok_last, window);
  const int s_lo = span.begin / split_keys;
  const int s_hi =
      span.end > span.begin ? min((span.end - 1) / split_keys, n_splits - 1) : s_lo - 1;
  const size_t base = (static_cast<size_t>(b) * KH + h) * n_splits * kTcBlockM;
  merge_partials<D, kTcBlockM, kMaxSplits, kMergeThreads, false>(
      part_acc + base * D, part_ml + base * 2, s_lo, s_hi, rows,
      [&](int r, int d, float4 acc, float, float l) {
        const int tok = r / G;
        const int head = h * G + (r - tok * G);
        store_bf16x4(out + ((static_cast<size_t>(b) * C + tok) * QH + head) * D + d, acc, l);
      });
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k_pages, const void* v_pages,
                      const void* page_table, const void* kv_len, const void* q_count,
                      void* out, void* part_acc, void* part_ml, int B, int C, int QH,
                      int KH, int page_size, int pages_per_seq, int window, int n_splits,
                      int split_keys, float scale, cudaStream_t stream) {
  using Blk = TcBlock<D, kTcWarps>;
  const size_t smem_bytes = Blk::kSmemBytes;
  auto* kernel = ragged_attention_tc_kernel<D>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const int G = QH / KH;
  const int n_tiles = (C * G + kTcBlockM - 1) / kTcBlockM;
  const int n_work = n_splits > 1 ? n_tiles - 1 + n_splits : n_tiles;
  kernel<<<dim3(n_work, KH, B), Blk::kThreads, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_count),
      static_cast<bf16*>(out), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      C, QH, KH, page_size, pages_per_seq, window, n_splits, split_keys, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  ragged_merge_kernel<D><<<dim3(KH, B), kMergeThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(kv_len), static_cast<const int*>(q_count),
      static_cast<bf16*>(out), C, QH, KH, window, n_splits, split_keys);
  return cudaGetLastError();
}

cudaError_t dispatch_dim_tc(int D, const void* q, const void* k_pages, const void* v_pages,
                            const void* page_table, const void* kv_len, const void* q_count,
                            void* out, void* part_acc, void* part_ml, int B, int C, int QH,
                            int KH, int page_size, int pages_per_seq, int window,
                            int n_splits, int split_keys, float scale, cudaStream_t stream) {
#define OPTORCH_RAGGED_TC(DIM)                                                           \
  launch_tc<DIM>(q, k_pages, v_pages, page_table, kv_len, q_count, out, part_acc,       \
                 part_ml, B, C, QH, KH, page_size, pages_per_seq, window, n_splits,     \
                 split_keys, scale, stream)
  switch (D) {
    case 16:
      return OPTORCH_RAGGED_TC(16);
    case 32:
      return OPTORCH_RAGGED_TC(32);
    case 64:
      return OPTORCH_RAGGED_TC(64);
    case 128:
      return OPTORCH_RAGGED_TC(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef OPTORCH_RAGGED_TC
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/ragged_attention.py).
// dtype: 0 = float32 (the CUDA-core kernel, n_splits must be 1), 1 =
// bfloat16 (the tensor-core kernel).  window <= 0 means no sliding window.
// scale is the score scale, D^-0.5, computed by the caller.  n_splits and
// split_keys are the caller's launch plan (a function of shapes only);
// with n_splits > 1, part_acc [B, KH, n_splits, 64, D] and part_ml
// [B, KH, n_splits, 64, 2] are f32 scratch the caller allocated.  Returns
// the launch status (cudaGetLastError), 0 on success.
extern "C" int ragged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, const void* q_count, void* out,
    void* part_acc, void* part_ml, int B, int C, int QH, int KH, int D, int page_size,
    int pages_per_seq, int window, int n_splits, int split_keys, float scale, int dtype,
    void* stream) {
  if (B <= 0 || C <= 0 || KH <= 0 || QH % KH != 0 || page_size <= 0 ||
      pages_per_seq <= 0 || n_splits < 1 || n_splits > optorch::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_splits > 1 && (dtype != 1 || split_keys <= 0 ||
                       split_keys % optorch::kTcKeys != 0 || part_acc == nullptr ||
                       part_ml == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = optorch::dispatch_dim_f32(D, q, k_pages, v_pages, page_table, kv_len,
                                       q_count, out, B, C, QH, KH, page_size,
                                       pages_per_seq, window, scale, s);
  } else if (dtype == 1) {
    err = optorch::dispatch_dim_tc(D, q, k_pages, v_pages, page_table, kv_len, q_count,
                                   out, part_acc, part_ml, B, C, QH, KH, page_size,
                                   pages_per_seq, window, n_splits, split_keys, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tensor-core kernel's split geometry, the one source of the caller's
// scratch shape: flash rows per tile, KV positions per stage (split_keys
// must be a multiple), most splits.  ops/ragged_attention.py holds its
// launch plan's copy against these once, when it binds the library.
extern "C" void ragged_attention_tc_geometry(int* tile_rows, int* stage_keys, int* max_splits) {
  *tile_rows = optorch::kTcBlockM;
  *stage_keys = optorch::kTcKeys;
  *max_splits = optorch::kMaxSplits;
}
