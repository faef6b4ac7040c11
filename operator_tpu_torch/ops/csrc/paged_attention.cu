// Paged decode attention for Hopper (sm_90a).
//
// Replaces both Pallas decode kernels of operator_tpu/ops/paged_attention.py:
// _paged_attn_kernel (v1, :191, grid (B, pages_per_seq), dead pages skipped)
// and _paged_attn_kernel_v2 (v2, :252, in-kernel double-buffered walk of the
// live pages).  The two compute one function and differ only in how the TPU
// moves pages, so one kernel serves both selector values.  Row b's single
// query token (RoPE applied) attends over positions [0, lengths[b]) of its
// pages, reached through page_table; lengths already counts the current
// token.  With a sliding window only positions >= lengths[b] - window are
// live.  GQA with G = QH / KH query heads per KV head; scale D^-0.5; float32
// online softmax (flash_common.cuh); output in q's dtype.
//
// Layouts (all contiguous):
//   q          [B, QH, D]               bf16 or f32
//   k_pages    [num_pages, page, KH, D] same dtype as q (one layer)
//   v_pages    likewise
//   page_table [B, pages_per_seq] int32, lengths [B] int32
//   out        [B, QH, D]               same dtype as q
//
// Design.  Grid (B, KH): one block per (row, KV head) packs that head's G
// query heads (8 for tinyllama), so each K and V row it reads serves all G
// heads.  The block's eight warps split the row's live positions in chunks
// of 32, warp w taking chunks w, w + 8, ...: lane n issues the 16-byte
// loads of position start + n's K row and V row together (one memory
// latency per chunk, not one per V row), scores its K row against the G
// queries (kept in shared memory as floats, read by broadcast), and
// parks its V row in the warp's shared staging rows; the warp folds the G
// score columns into its own running (m, l) through shuffles, and the P.V
// product turns the layout around: each lane accumulates D / 32 output
// columns of every head over the chunk's staged V rows.  After the walk
// the warps' (m, l, acc) states are merged in shared memory (reusing the
// staging rows): M = max m_w, L = sum l_w exp(m_w - M), acc = sum acc_w
// exp(m_w - M), out = acc / max(L, 1e-30).
//
// Only live KV is walked: positions [first, lengths[b]) with first = 0, or
// with a window the start of the page holding lengths[b] - window.  Masked
// positions inside the walk score -1e30; a warp whose chunks were all
// masked ends with m = -1e30 and its state is wiped in the merge by
// exp(-1e30 - M) == 0, exactly as a fully masked block is wiped by the
// next live block's rescale.  A released slot's all-zero table row points
// at trash page 0 with lengths 1 and reads finite garbage, as on the TPU.
// Head groups are padded to kG = 8 (the largest group of the port's
// models) with zero queries, which are computed and never written.
//
// What bounds it.  A decode step reads the live KV once:
// sum_b min(lengths_b, window) * KH * D * 2 (K and V) * itemsize bytes,
// against 3.35 TB/s; the arithmetic (4 * keys * QH * D flops) is far below
// the card's rate.  This version runs the scores and P.V on the CUDA cores
// in float32 with one block per (row, KV head), so a batch of few long
// rows occupies few SMs and each warp walks its chunks one memory latency
// at a time; split-KV across blocks, a cp.async/TMA double buffer of pages
// and the tensor cores are the known next steps.  A float32 row of D = 128
// holds 64 16-byte loads in flight per lane and spills; bf16, the serving
// type, does not.

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

template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out, int QH,
                    int KH, int page_size, int pages_per_seq, int window,
                    float scale) {
  using S = Smem<D, kG>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = D / kVec;               // 16-byte loads per K or V row
  constexpr int kDimsPerLane = (D + 31) / 32;  // D = 16: lanes 16..31 idle in P.V
  static_assert(D % kVec == 0 && D % 4 == 0, "unsupported head dim");

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
    q_s[i] = g < G ? to_float<T>(q[(static_cast<size_t>(b) * QH + h * G + g) * D + d])
                   : 0.0f;
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
      unpack(k_raw[i], kf, T());
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
      unpack(v_raw[i], vf, T());
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
        from_float<T>(finalize(total, a));
  }
}

template <typename T, int D, int kG>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths, void* out, int B,
                   int QH, int KH, int page_size, int pages_per_seq, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem_bytes = sizeof(float) * Smem<D, kG>::kFloats;
  auto* kernel = paged_decode_kernel<T, D, kG>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KH);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), QH, KH, page_size,
      pages_per_seq, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(int G, const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* lengths, void* out, int B, int QH, int KH,
                           int page_size, int pages_per_seq, int window,
                           float scale, cudaStream_t stream) {
  if (G <= 8) {
    return launch<T, D, 8>(q, k_pages, v_pages, page_table, lengths, out, B, QH,
                           KH, page_size, pages_per_seq, window, scale, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(int D, int G, const void* q, const void* k_pages,
                         const void* v_pages, const void* page_table,
                         const void* lengths, void* out, int B, int QH, int KH,
                         int page_size, int pages_per_seq, int window, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_group<T, 16>(G, q, k_pages, v_pages, page_table, lengths, out,
                                   B, QH, KH, page_size, pages_per_seq, window,
                                   scale, stream);
    case 64:
      return dispatch_group<T, 64>(G, q, k_pages, v_pages, page_table, lengths, out,
                                   B, QH, KH, page_size, pages_per_seq, window,
                                   scale, stream);
    case 128:
      return dispatch_group<T, 128>(G, q, k_pages, v_pages, page_table, lengths,
                                    out, B, QH, KH, page_size, pages_per_seq,
                                    window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace optorch

// Plain C entry point, bound with ctypes (ops/paged_attention.py).
// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// scale is the score scale, D^-0.5, computed by the caller.  Returns the
// launch status (cudaGetLastError), 0 on success.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* lengths, void* out, int B, int QH,
                                      int KH, int D, int page_size,
                                      int pages_per_seq, int window, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || QH % KH != 0 || page_size <= 0 || pages_per_seq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = QH / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = optorch::dispatch_dim<float>(D, G, q, k_pages, v_pages, page_table,
                                       lengths, out, B, QH, KH, page_size,
                                       pages_per_seq, window, scale, s);
  } else if (dtype == 1) {
    err = optorch::dispatch_dim<__nv_bfloat16>(D, G, q, k_pages, v_pages,
                                               page_table, lengths, out, B, QH, KH,
                                               page_size, pages_per_seq, window,
                                               scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
