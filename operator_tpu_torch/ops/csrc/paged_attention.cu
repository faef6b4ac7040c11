// Paged decode attention for Hopper (sm_90a).
//
// Replaces both Pallas decode kernels of operator_tpu/ops/paged_attention.py:
// _paged_attn_kernel (v1, :191, grid (B, pages_per_seq), dead pages skipped)
// and _paged_attn_kernel_v2 (v2, :252, in-kernel double-buffered walk of the
// live pages).  The two compute one function and differ only in how the TPU
// moves pages, so one CUDA source serves both selector values.  Row b's
// single query token (RoPE applied) attends over positions [0, lengths[b])
// of its pages, reached through page_table; lengths already counts the
// current token.  With a sliding window only positions >= lengths[b] -
// window are live.  GQA with G = QH / KH query heads per KV head; scale
// D^-0.5; float32 online softmax (flash_common.cuh); output in q's dtype.
//
// Layouts (all contiguous):
//   q          [B, QH, D]               bf16 or f32
//   k_pages    [num_pages, page, KH, D] same dtype as q (one layer)
//   v_pages    likewise
//   page_table [B, pages_per_seq] int32, lengths [B] int32
//   out        [B, QH, D]               same dtype as q
//
// Two kernels, chosen by dtype (not a fallback: each dtype has one):
//
// bf16 -> paged_decode_tc_kernel, on the tensor cores, with split-KV.  Grid
// (KH, B, n_splits), four warps a block: split s of row b walks positions
// [s * split_keys, (s + 1) * split_keys) clipped to the row's live span
// (the window's start aligned down to a stage, lengths[b]), so a long row
// is walked by up to n_splits blocks side by side instead of one block in
// series.  The plan (n_splits, split_keys, the scratch) comes from the
// caller and depends on shapes only: the call never reads lengths on the
// host.  A split with no live key returns at once.  Inside the block the
// keys, not the query rows, are shared out: warp w walks stages w, w + 4,
// ... of the split (64 positions each; at the plan's 256-position splits
// one stage a warp), so the four stages of a split run side by side.  The
// G query heads of KV head h are rows 0 .. G-1 of a 16-row
// mma.sync.m16n8k16 tile (flash_common.cuh's WarpTile; rows past G are
// zero queries, computed and never written, and the A fragments are read
// straight from device memory); each lane gathers two positions' K and V
// rows through the page table, one table read a position, as bf16 by
// 16-byte cp.async into the warp's padded shared rows (one head's slice of
// a page row is D bf16, KH * D apart from the next position's).  The
// first stage's page ids are read beside the row's length, so a block's
// chain before its copies is one memory latency, not two.  Scores are folded in base 2 with the -1e30 mask on
// the stages before the window's start or across the span's end only; P
// goes to bf16 in registers for P.V.  The warps' (m, l, acc) partials are
// then merged in warp order, and the split's result either written (a row
// whose live span lies in one split) or kept as the split's partial in f32
// scratch; the split then takes a ticket from the (row, head)'s counter,
// and the last to finish merges the row's splits in split order and resets
// the counter to 0.  Both merges are merge_partials (flash_common.cuh, the
// arithmetic K1's merge kernel runs: each part weighted by
// exp2(m_j - m_max), so a part whose keys are all masked for the row drops
// out as the one-block rescale would drop it).  Deterministic: the merge
// orders are fixed, whichever block merges; one launch, no second pass.
// Half of the tile's 16 rows are idle (G <= 8), which costs nothing that
// matters: the kernel is bound by the latency of its page loads and by
// bytes, not by the tensor cores.
//
// f32 -> paged_decode_kernel, on the CUDA cores, no split: grid (B, KH),
// one block per (row, KV head) packing its G query heads (padded to kG =
// 8 with zero queries), eight warps splitting the row's live positions in
// chunks of 32; lane n loads position start + n's K and V rows together,
// scores its K row against the G queries (in shared memory as floats) and
// parks its V row in the warp's shared staging rows; the warp folds the G
// score columns into its running (m, l) through shuffles, then each lane
// accumulates D / 32 output columns of every head over the staged V rows.
// The warps' (m, l, acc) states are merged in shared memory at the end.
// TF32 tensor cores would miss the f32 tolerance and the card-vs-CPU greedy
// parity of the f32 engines.  A float32 row of D = 128 holds 64 16-byte
// loads in flight per lane and spills.
//
// Only live KV is walked.  Masked positions inside the walk score -1e30; a
// warp or split whose keys were all masked ends with m = -1e30 and is
// wiped in its merge by exp(-1e30 - M) == 0, exactly as a fully masked
// block is wiped by the next live block's rescale.  A released slot's
// all-zero table row points at trash page 0 with lengths 1 and reads
// finite garbage, as on the TPU.
//
// What bounds it.  A decode step reads the live KV once:
// sum_b min(lengths_b, window) * KH * D * 2 (K and V) * itemsize bytes,
// against 3.35 TB/s; the arithmetic (4 * keys * QH * D flops) is far below
// the card's rate.  Still open: TMA page loads and wgmma, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace optorch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;  // KV positions a warp takes at once, one per lane

template <int D, int kG>
struct Smem {
  static constexpr int kLdV = D + 4;               // staged V row (floats), padded
  static constexpr int kQ = kG * D;                // q_s  [kG][D]
  static constexpr int kP = kWarps * kChunk * kG;  // p_s  [warp][n][g]
  static constexpr int kM = kWarps * kG;           // m_s, l_s [warp][g]
  // v_s [warp][n][kLdV] during the walk; acc_s [warp][g][D] in the merge
  static constexpr int kV = kWarps * kChunk * kLdV;
  static_assert(kWarps * kG * D <= kV, "the merge must fit the staging rows");
  static constexpr int kFloats = kQ + kP + 2 * kM + kV;
};

template <int D, int kG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out, int QH,
                    int KH, int page_size, int pages_per_seq, int window,
                    float scale) {
  using S = Smem<D, kG>;
  constexpr int kVec = 4;  // floats per 16-byte load
  constexpr int kVecs = D / kVec;               // 16-byte loads per K or V row
  constexpr int kDimsPerLane = (D + 31) / 32;  // D = 16: lanes 16..31 idle in P.V
  static_assert(D % kVec == 0, "unsupported head dim");

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = QH / KH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int seq_len = lengths[b];
  // positions past the table never exist (the plain version's positions
  // stop at pages_per_seq * page_size too)
  const int end = min(seq_len, pages_per_seq * page_size);
  const int window_lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int begin = (window_lo / page_size) * page_size;
  const int* table = page_table + static_cast<size_t>(b) * pages_per_seq;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* p_s = q_s + S::kQ;
  float* m_s = p_s + S::kP;
  float* l_s = m_s + S::kM;
  float* v_s = l_s + S::kM;
  float* acc_s = v_s;  // the staging rows, reused once the walk is over

  for (int i = threadIdx.x; i < S::kQ; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    q_s[i] = g < G ? q[(static_cast<size_t>(b) * QH + h * G + g) * D + d] : 0.0f;
  }
  __syncthreads();

  SoftmaxState st[kG];
  float acc[kG][kDimsPerLane];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    st[g] = init_state();
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) acc[g][j] = 0.0f;
  }
  const int my_dim = lane * kDimsPerLane;
  const bool dim_lane = my_dim < D;
  float* p_w = p_s + warp * kChunk * kG;
  float* v_w = v_s + warp * kChunk * S::kLdV;

  for (int start = begin + warp * kChunk; start < end; start += kWarps * kChunk) {
    const int t = start + lane;
    // this lane's K and V rows, all 2 * kVecs loads in flight at once
    uint4 k_raw[kVecs];
    uint4 v_raw[kVecs];
    if (t < end) {
      const int page_idx = t / page_size;
      const int slot = t - page_idx * page_size;
      const size_t off =
          ((static_cast<size_t>(table[page_idx]) * page_size + slot) * KH + h) * D;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        k_raw[i] = *reinterpret_cast<const uint4*>(k_pages + off + i * kVec);
        v_raw[i] = *reinterpret_cast<const uint4*>(v_pages + off + i * kVec);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) k_raw[i] = v_raw[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float kf[kVec];
      unpack(k_raw[i], kf, 0.0f);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + g * D + i * kVec + e);
          s[g] = fmaf(qv.x, kf[e], s[g]);
          s[g] = fmaf(qv.y, kf[e + 1], s[g]);
          s[g] = fmaf(qv.z, kf[e + 2], s[g]);
          s[g] = fmaf(qv.w, kf[e + 3], s[g]);
        }
      }
      float vf[kVec];
      unpack(v_raw[i], vf, 0.0f);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(v_w + lane * S::kLdV + i * kVec + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    const bool live = t < end && t >= window_lo;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float sg[1] = {live ? s[g] * scale : kNegInf};
      const float alpha = update_state<1, 32>(st[g], sg);
      p_w[lane * kG + g] = sg[0];
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) acc[g][j] *= alpha;
    }
    __syncwarp();

    // P.V: this lane's output columns of every head over the chunk's rows
    if (dim_lane) {
      const int n_rows = min(kChunk, end - start);
      for (int n = 0; n < n_rows; ++n) {
        const float* v_n = v_w + n * S::kLdV + my_dim;
        const float* p_n = p_w + n * kG;
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float p = p_n[g];
#pragma unroll
          for (int j = 0; j < kDimsPerLane; ++j) acc[g][j] = fmaf(p, v_n[j], acc[g][j]);
        }
      }
    }
    __syncwarp();  // p_w and v_w are rewritten by the next chunk
  }
  __syncthreads();  // every warp is done with its staging rows

  // merge the warps' states
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m_s[warp * kG + g] = st[g].m;
      l_s[warp * kG + g] = st[g].l;
    }
  }
  if (dim_lane) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) {
        acc_s[(warp * kG + g) * D + my_dim + j] = acc[g][j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    SoftmaxState total = init_state();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total.m = fmaxf(total.m, m_s[w * kG + g]);
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w * kG + g] - total.m);
      total.l += f * l_s[w * kG + g];
      a += f * acc_s[(w * kG + g) * D + d];
    }
    out[(static_cast<size_t>(b) * QH + h * G + g) * D + d] =
        finalize(total, a);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k_pages, const void* v_pages,
                       const void* page_table, const void* lengths, void* out, int B,
                       int QH, int KH, int page_size, int pages_per_seq, int window,
                       float scale, cudaStream_t stream) {
  constexpr int kG = 8;
  const size_t smem_bytes = sizeof(float) * Smem<D, kG>::kFloats;
  auto* kernel = paged_decode_kernel<D, kG>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KH);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out), QH, KH, page_size,
      pages_per_seq, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, split-KV, the merge in the same launch
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kSplitRows = 8;  // partial rows a split keeps: the largest group
constexpr int kMaxSplits = 16;  // splits a row's span may be cut into
constexpr int kTcWarps = 4;     // warps a block, each walking its own stages
constexpr int kTcThreads = 32 * kTcWarps;

template <int D>
struct Decode {
  using Warp = WarpTile<D, kTcKeys>;
  static constexpr int kLd = Warp::kLd;     // shared row stride, bf16
  static constexpr int kChunks = D / 8;     // 16-byte chunks a row
  static constexpr int kStage = kTcKeys * kLd;  // one stage of K (or V)
  // per warp K and V of one stage; after the walk the warps' partials
  // [warp][kSplitRows][D] f32 and (m, l) reuse them.  At D = 64, 72 KB:
  // three blocks an SM.
  static constexpr size_t kSmemBytes = sizeof(bf16) * kTcWarps * 2 * kStage;
  static_assert(sizeof(float) * kTcWarps * kSplitRows * (D + 2) <= kSmemBytes,
                "the warps' partials must fit the stages");
};

// Block (KV head h = blockIdx.x, row b = blockIdx.y, split = blockIdx.z).
template <int D>
__global__ void __launch_bounds__(kTcThreads)
paged_decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                       const bf16* __restrict__ v_pages, const int* __restrict__ page_table,
                       const int* __restrict__ lengths, bf16* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int* __restrict__ counters, int QH, int KH, int page_size,
                       int pages_per_seq, int window, int n_splits, int split_keys,
                       float scale_log2) {
  using Dc = Decode<D>;
  constexpr int kLd = Dc::kLd;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = QH / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* table = page_table + static_cast<size_t>(b) * pages_per_seq;

  // The page ids of this warp's first stage as it stands without a window
  // (it starts at the split's start) are read beside the row's length, not
  // after it: one memory latency fewer before the first copies.
  const int first_start = (n_splits > 1 ? split * split_keys : 0) + warp * kTcKeys;
  int first_page[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    first_page[half] =
        table[min((first_start + lane + 32 * half) / page_size, pages_per_seq - 1)];
  }
  const int seq_len = lengths[b];
  // positions past the table never exist (the plain version's positions
  // stop at pages_per_seq * page_size too)
  const int end = min(seq_len, pages_per_seq * page_size);
  const int window_lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int begin = window_lo - window_lo % kTcKeys;
  // the splits holding live keys, s_lo .. s_hi; a row with none (length 0)
  // is one empty split, which writes zeros
  int s_lo = 0;
  int s_hi = 0;
  int kv_begin = begin;
  int kv_end = end;
  if (n_splits > 1) {
    s_lo = min(min(begin, end) / split_keys, n_splits - 1);
    s_hi = end > begin ? min((end - 1) / split_keys, n_splits - 1) : s_lo;
    if (split < s_lo || split > s_hi) return;  // no live key: out at once
    kv_begin = max(begin, split * split_keys);
    kv_end = min(end, (split + 1) * split_keys);
  }
  const size_t q_row0 = (static_cast<size_t>(b) * QH + h * G) * D;  // == out's

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw) + warp * 2 * Dc::kStage;  // this warp's
  bf16* v_s = k_s + Dc::kStage;

  // Warp w walks stages w, w + 4, ... of the split, 64 positions each:
  // lane n gathers positions start + n and start + 32 + n through the page
  // table (one table read a position) into the warp's own K and V rows.
  auto load_stage = [&](int start) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = lane + 32 * half;
      const int t = start + n;
      const bool ok = t < kv_end;
      size_t off = 0;
      if (ok) {
        const int page_idx = t / page_size;
        const int slot = t - page_idx * page_size;
        const int page = start == first_start ? first_page[half] : table[page_idx];
        off = ((static_cast<size_t>(page) * page_size + slot) * KH + h) * D;
      }
#pragma unroll
      for (int c = 0; c < Dc::kChunks; ++c) {
        cp_async_16(k_s + n * kLd + c * 8, k_pages + off + c * 8, ok);
        cp_async_16(v_s + n * kLd + c * 8, v_pages + off + c * 8, ok);
      }
    }
    cp_async_commit();
  };
  typename Dc::Warp wt;
  wt.init();
  int start = kv_begin + warp * kTcKeys;
  if (start < kv_end) {
    load_stage(start);
    // the G query heads are rows 0 .. G-1 of the 16-row tile (the rest
    // zero), read while the stage is in flight
    wt.load_q_rows(q + q_row0, G, lane);
    cp_async_wait<0>();
  }
  while (start < kv_end) {
    __syncwarp();  // the stage's copies of every lane have landed
    wt.scores(k_s, lane);
    // one branch for the whole stage: masked only before the window's
    // start or across the span's end
    if (start < window_lo || start + kTcKeys > kv_end) {
#pragma unroll
      for (int j = 0; j < Dc::Warp::kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = start + j * 8 + (lane & 3) * 2 + (e & 1);
          wt.s[j][e] = t >= window_lo && t < kv_end ? wt.s[j][e] * scale_log2 : kNegInf;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < Dc::Warp::kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) wt.s[j][e] *= scale_log2;
      }
    }
    wt.softmax();
    wt.accumulate(v_s, lane);
    start += kTcWarps * kTcKeys;
    if (start < kv_end) {
      __syncwarp();  // every lane is done with the stage before it is refilled
      load_stage(start);
      cp_async_wait<0>();
    }
  }
  __syncthreads();  // every warp is done with its stage: the partials reuse them

  // The warps' partials (rows 0 .. G-1 are fragment half 0's rows lane / 4)
  // to shared memory, then merged in warp order: a warp that walked no
  // stage holds m = -1e30, l = 0 and drops out.
  float* wacc = reinterpret_cast<float*>(smem_raw);      // [warp][kSplitRows][D]
  float* wml = wacc + kTcWarps * kSplitRows * D;           // [warp][kSplitRows][2]
  const int r = lane >> 2;
  if (r < G) {
    wt.store_partial(0, wacc + (warp * kSplitRows + r) * D, wml + (warp * kSplitRows + r) * 2,
                     lane);
  }
  __syncthreads();
  // the row's only split writes its result; otherwise the split's partial
  const bool whole = s_lo == s_hi;
  const size_t base = (static_cast<size_t>(b) * KH + h) * n_splits * kSplitRows;
  float* my_acc = part_acc + (base + static_cast<size_t>(split) * kSplitRows) * D;
  float* my_ml = part_ml + (base + static_cast<size_t>(split) * kSplitRows) * 2;
  merge_partials<D, kSplitRows, kTcWarps, kTcThreads, false>(
      wacc, wml, 0, kTcWarps - 1, G, [&](int row, int d, float4 acc, float m, float l) {
        if (whole) {
          store_bf16x4(out + q_row0 + static_cast<size_t>(row) * D + d, acc, l);
        } else {
          *reinterpret_cast<float4*>(my_acc + row * D + d) = acc;
          if (d == 0) *reinterpret_cast<float2*>(my_ml + row * 2) = make_float2(m, l);
        }
      });
  if (whole) return;
  // The last split block of (b, h) to finish merges the splits: the
  // partials are made visible before the ticket is taken, and read
  // through L2 after.
  __threadfence();
  __syncthreads();
  __shared__ int last_s;
  if (threadIdx.x == 0) last_s = atomicAdd(counters + b * KH + h, 1) == s_hi - s_lo;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge_partials<D, kSplitRows, kMaxSplits, kTcThreads, true>(
      part_acc + base * D, part_ml + base * 2, s_lo, s_hi, G,
      [&](int row, int d, float4 acc, float, float l) {
        store_bf16x4(out + q_row0 + static_cast<size_t>(row) * D + d, acc, l);
      });
  if (threadIdx.x == 0) counters[b * KH + h] = 0;  // ready for the next launch
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k_pages, const void* v_pages,
                      const void* page_table, const void* lengths, void* out,
                      void* part_acc, void* part_ml, void* counters, int B, int QH, int KH,
                      int page_size, int pages_per_seq, int window, int n_splits,
                      int split_keys, float scale, cudaStream_t stream) {
  const size_t smem_bytes = Decode<D>::kSmemBytes;
  auto* kernel = paged_decode_tc_kernel<D>;
  if (smem_bytes > 46 * 1024) {  // 2 KB of the 48 for the merges' static arrays
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(KH, B, n_splits), kTcThreads, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), QH, KH, page_size, pages_per_seq, window, n_splits,
      split_keys, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/paged_attention.py).
// dtype: 0 = float32 (the CUDA-core kernel, n_splits must be 1), 1 =
// bfloat16 (the tensor-core kernel).  window <= 0 means no sliding window.
// scale is the score scale, D^-0.5, computed by the caller.  n_splits and
// split_keys are the caller's split plan (a function of shapes only);
// with n_splits > 1, part_acc [B, KH, n_splits, 8, D] and part_ml
// [B, KH, n_splits, 8, 2] are f32 scratch and counters [B * KH] int32
// zeros that the caller allocated (the merging block leaves them zero, so
// they may be reused by the next launch on the same stream).  Returns the
// launch status (cudaGetLastError), 0 on success.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* lengths, void* out, void* part_acc,
                                      void* part_ml, void* counters, int B, int QH,
                                      int KH, int D, int page_size, int pages_per_seq,
                                      int window, int n_splits, int split_keys,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || QH % KH != 0 || QH / KH > optorch::kSplitRows ||
      page_size <= 0 || pages_per_seq <= 0 || n_splits < 1 ||
      n_splits > optorch::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_splits > 1 &&
      (dtype != 1 || split_keys <= 0 || split_keys % optorch::kTcKeys != 0 ||
       static_cast<long long>(n_splits) * split_keys <
           static_cast<long long>(pages_per_seq) * page_size ||
       part_acc == nullptr || part_ml == nullptr || counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OPTORCH_PAGED(DIM)                                                                   \
  (dtype == 0 ? optorch::launch_f32<DIM>(q, k_pages, v_pages, page_table, lengths, out, B, QH, \
                                         KH, page_size, pages_per_seq, window, scale, s)    \
              : optorch::launch_tc<DIM>(q, k_pages, v_pages, page_table, lengths, out,      \
                                        part_acc, part_ml, counters, B, QH, KH, page_size,  \
                                        pages_per_seq, window, n_splits, split_keys, scale, \
                                        s))
  cudaError_t err;
  if (dtype != 0 && dtype != 1) {
    err = cudaErrorInvalidValue;
  } else if (D == 16) {
    err = OPTORCH_PAGED(16);
  } else if (D == 64) {
    err = OPTORCH_PAGED(64);
  } else if (D == 128) {
    err = OPTORCH_PAGED(128);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef OPTORCH_PAGED
  return static_cast<int>(err);
}

// The tensor-core kernel's split geometry, the one source of the caller's
// scratch shape: partial rows a split keeps, KV positions per stage
// (split_keys must be a multiple), most splits.  ops/paged_attention.py
// holds its split plan's copy against these once, when it binds the
// library.
extern "C" void paged_attention_tc_geometry(int* split_rows, int* stage_keys,
                                            int* max_splits) {
  *split_rows = optorch::kSplitRows;
  *stage_keys = optorch::kTcKeys;
  *max_splits = optorch::kMaxSplits;
}
