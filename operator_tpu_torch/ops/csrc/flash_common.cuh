// Shared online-softmax state for the port's flash-style attention kernels.
//
// The CUDA counterpart of operator_tpu/ops/_flash_common.py: every kernel
// that keeps a running (max, denominator, accumulator) per query row folds
// its score blocks in through these helpers, so a numerics change (the
// masking constant, the rescale, the denominator guard) cannot drift
// between kernels.  The constants are the JAX package's:
//
//   NEG_INF = -1e30 (not -inf): a fully masked block folds in as exp(0)
//     contributions that the first live block's rescale wipes out
//     (alpha = exp(-1e30 - m) == 0), exactly as the Pallas kernels do;
//   finalize = acc / max(l, 1e-30): a row that attended nothing is zeros.
//
// A flash row's state may be split over LANES neighbouring threads of one
// warp (each holding a share of the row's scores and of its accumulator);
// the reductions below run across those lanes with warp shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace optorch {

constexpr float kNegInf = -1e30f;
constexpr float kDenomFloor = 1e-30f;

// 16 bytes of T, as read by one vector load -> 16 / sizeof(T) floats
// (bf16 -> f32 is exact: the bf16 bits are the float's high half).
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[4], float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&out)[8], __nv_bfloat16) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(w[j] << 16);
    out[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Running state of one flash row.
struct SoftmaxState {
  float m;  // running max
  float l;  // running denominator
};

__device__ __forceinline__ SoftmaxState init_state() {
  SoftmaxState st;
  st.m = kNegInf;
  st.l = 0.0f;
  return st;
}

// Max / sum across the LANES neighbouring lanes that share one row
// (LANES is a power of two, at most 32).
template <int LANES>
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int offset = LANES / 2; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  }
  return x;
}

template <int LANES>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int offset = LANES / 2; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

// Fold one masked score block into the row's state.  ``s`` holds this
// lane's N scores (masked entries already kNegInf); on return it holds the
// probabilities p = exp(s - m_new).  Returns alpha = exp(m_old - m_new),
// the factor the caller applies to its accumulator before adding p @ V.
template <int N, int LANES>
__device__ __forceinline__ float update_state(SoftmaxState& st, float (&s)[N]) {
  float block_max = s[0];
#pragma unroll
  for (int i = 1; i < N; ++i) block_max = fmaxf(block_max, s[i]);
  block_max = lanes_max<LANES>(block_max);
  const float m_new = fmaxf(st.m, block_max);
  const float alpha = expf(st.m - m_new);
  float block_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = expf(s[i] - m_new);
    block_sum += s[i];
  }
  block_sum = lanes_sum<LANES>(block_sum);
  st.l = alpha * st.l + block_sum;
  st.m = m_new;
  return alpha;
}

// update_state in base 2, for the tensor-core kernels: the scores arrive
// multiplied by scale * log2(e), so exp2f stands for expf (one MUFU
// instruction) and m is kept in the same units.  Masked entries are the
// same kNegInf, so a fully masked block still folds in exp2(0) = 1 per key
// and the first live block's alpha = exp2(-1e30 - m) == 0 wipes it.
template <int N, int LANES>
__device__ __forceinline__ float update_state_log2(SoftmaxState& st, float (&s)[N]) {
  float block_max = s[0];
#pragma unroll
  for (int i = 1; i < N; ++i) block_max = fmaxf(block_max, s[i]);
  block_max = lanes_max<LANES>(block_max);
  const float m_new = fmaxf(st.m, block_max);
  const float alpha = exp2f(st.m - m_new);
  float block_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = exp2f(s[i] - m_new);
    block_sum += s[i];
  }
  block_sum = lanes_sum<LANES>(block_sum);
  st.l = alpha * st.l + block_sum;
  st.m = m_new;
  return alpha;
}

// acc / max(l, eps): rows that attended nothing come out as zeros.
__device__ __forceinline__ float finalize(const SoftmaxState& st, float acc) {
  return acc / fmaxf(st.l, kDenomFloor);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core building blocks (sm_80+ mma.sync, used on sm_90a)
// ---------------------------------------------------------------------------
//
// One warp owns a 16-row slice of a flash tile.  In the m16n8k16 fragment
// layout lane l holds rows (l / 4) and (l / 4 + 8) of every 16 x 8
// accumulator, columns 2 * (l % 4) and +1, so a row is spread over the 4
// lanes of a quad: lanes_max<4> / lanes_sum<4> reduce it.  K and V tiles sit
// in shared memory as bf16 rows of D + kSmemPad elements; the pad of 16
// bytes puts the 8 rows an ldmatrix phase reads on distinct banks for every
// D in {16, 32, 64, 128}.

constexpr int kSmemPad = 8;  // bf16 elements

// 16-byte global -> shared copy through cp.async.cg (L2 only); with
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned int (&r)[4], const void* smem) {
  const unsigned int addr = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned int (&r)[4], const void* smem) {
  const unsigned int addr = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const unsigned int (&a)[4],
                                               unsigned int b0, unsigned int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), rounded
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&v);
}

// A warp's slice of a flash tile: 16 query rows against a block of
// kKeys (a multiple of 16) keys at head dim D, all fragments in registers.
template <int D, int kKeys>
struct WarpTile {
  static constexpr int kLd = D + kSmemPad;  // shared row stride, bf16 elements
  static constexpr int kKSteps = D / 16;    // Q.K^T depth steps
  static constexpr int kKeyTiles = kKeys / 8;
  static constexpr int kDimTiles = D / 8;
  static_assert(D % 16 == 0 && kKeys % 16 == 0, "tile shape");

  unsigned int q[kKSteps][4];  // the 16 x D query slice, A fragments
  float s[kKeyTiles][4];       // scores, then probabilities
  float o[kDimTiles][4];       // unnormalised output rows
  SoftmaxState row[2];         // rows lane / 4 and lane / 4 + 8

  __device__ __forceinline__ void init() {
    row[0] = init_state();
    row[1] = init_state();
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  }

  // q_s: the warp's 16 query rows (bf16, stride kLd)
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q_s, int lane) {
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(q[kk], q_s + r * kLd + kk * 16 + c);
  }

  // The query slice straight from device memory, for a tile whose live
  // rows are at most 8 (a decode row's G heads): rows 0 .. rows - 1 at
  // q_rows + r * D, the rest zero.  In the A fragment lane l holds row
  // l / 4 (registers 0 and 2) and row l / 4 + 8 (1 and 3, zero here),
  // columns 2 * (l % 4) and +1, and those + 8.
  __device__ __forceinline__ void load_q_rows(const __nv_bfloat16* q_rows, int rows, int lane) {
    const int r = lane >> 2;
    const bool live = r < rows;
    const __nv_bfloat16* src = q_rows + (live ? r : 0) * D + (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      q[kk][0] = live ? *reinterpret_cast<const unsigned int*>(src + kk * 16) : 0u;
      q[kk][2] = live ? *reinterpret_cast<const unsigned int*>(src + kk * 16 + 8) : 0u;
      q[kk][1] = q[kk][3] = 0u;
    }
  }

  // s = Q . K^T over the block's keys (k_s: kKeys rows of stride kLd)
  __device__ __forceinline__ void scores(const __nv_bfloat16* k_s, int lane) {
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const int r = (lane & 7) + (lane >> 4) * 8;
    const int c = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kKeyTiles / 2; ++n2) {
        unsigned int b[4];
        ldmatrix_x4(b, k_s + (n2 * 16 + r) * kLd + kk * 16 + c);
        mma_bf16_16816(s[2 * n2], q[kk], b[0], b[1]);
        mma_bf16_16816(s[2 * n2 + 1], q[kk], b[2], b[3]);
      }
    }
  }

  // Fold the (scaled, masked) scores into both rows' states, rescale the
  // output rows and leave the probabilities in s.
  __device__ __forceinline__ void softmax() {
    float a[2 * kKeyTiles];
    float b[2 * kKeyTiles];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      a[2 * j] = s[j][0];
      a[2 * j + 1] = s[j][1];
      b[2 * j] = s[j][2];
      b[2 * j + 1] = s[j][3];
    }
    const float alpha_a = update_state_log2<2 * kKeyTiles, 4>(row[0], a);
    const float alpha_b = update_state_log2<2 * kKeyTiles, 4>(row[1], b);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = a[2 * j];
      s[j][1] = a[2 * j + 1];
      s[j][2] = b[2 * j];
      s[j][3] = b[2 * j + 1];
    }
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      o[j][0] *= alpha_a;
      o[j][1] *= alpha_a;
      o[j][2] *= alpha_b;
      o[j][3] *= alpha_b;
    }
  }

  // o += P . V: P rounded to bf16 in registers (the C fragments of two
  // neighbouring key tiles are the A fragment of one 16-key step), V
  // read transposed by ldmatrix (v_s: kKeys rows of stride kLd)
  __device__ __forceinline__ void accumulate(const __nv_bfloat16* v_s, int lane) {
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      unsigned int p[4];
      p[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      p[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      p[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < kDimTiles / 2; ++n2) {
        unsigned int b[4];
        ldmatrix_x4_trans(b, v_s + (kk * 16 + r) * kLd + n2 * 16 + c);
        mma_bf16_16816(o[2 * n2], p, b[0], b[1]);
        mma_bf16_16816(o[2 * n2 + 1], p, b[2], b[3]);
      }
    }
  }

  // Row `half` (0: lane / 4, 1: lane / 4 + 8) normalised and rounded to
  // bf16; dst is the row's D output elements.
  __device__ __forceinline__ void store_bf16(int half, __nv_bfloat16* dst, int lane) const {
    dst += (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      *reinterpret_cast<unsigned int*>(dst + j * 8) =
          pack_bf16x2(finalize(row[half], o[j][2 * half]), finalize(row[half], o[j][2 * half + 1]));
    }
  }

  // Row `half`'s partial for a split-KV merge, in f32: (m, l) to ml[0..1]
  // (m in base 2; written by one lane of the quad) and the unnormalised
  // output to acc, the row's D floats.
  __device__ __forceinline__ void store_partial(int half, float* acc, float* ml, int lane) const {
    if ((lane & 3) == 0) *reinterpret_cast<float2*>(ml) = make_float2(row[half].m, row[half].l);
    acc += (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      *reinterpret_cast<float2*>(acc + j * 8) = make_float2(o[j][2 * half], o[j][2 * half + 1]);
    }
  }
};

// ---------------------------------------------------------------------------
// One block's walk of a bf16 flash tile, shared by the ragged (K1) and
// prefill (K4) tensor-core kernels
// ---------------------------------------------------------------------------
//
// kWarps warps own 16 flash rows each.  The block copies its queries and
// then K and V, kTcKeys positions a stage, as bf16 into padded shared
// memory with 16-byte cp.async, kTcStages stages in flight.  Per stage each
// live warp computes S = Q.K^T, scales the fragments by scale * log2(e),
// masks them when the stage needs it (block-uniform, so the other stages
// skip the per-element compare), folds them into the online softmax and
// adds P.V.  The kernels differ only in where a query row and a KV position
// live and in the mask, which they pass in; each keeps its own span
// arithmetic and its own output (WarpTile::store_bf16 / store_partial).

constexpr int kTcKeys = 64;   // KV positions per stage
constexpr int kTcStages = 3;  // stages in shared memory
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int kWarps>
struct TcBlock {
  using Warp = WarpTile<D, kTcKeys>;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kWarps * 16;  // flash rows per tile
  static constexpr int kLd = Warp::kLd;
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * kLd * (kRows + 2 * kTcStages * kTcKeys);

  // this lane's tile-relative flash row of fragment half 0 or 1
  static __device__ __forceinline__ int row(int half) {
    return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + half * 8;
  }

  // Walk KV positions [kv_begin, kv_end) into wt, with smem the kernel's
  // kSmemBytes of dynamic shared memory.  The tile's first `live` rows
  // (at least one) have queries; the others are zero and never written.
  //   q_row(r)          row r's D query elements (r < live)
  //   kv_off(t)         offset of position t's D elements in k and in v
  //                     (kv_begin <= t < kv_end)
  //   need_mask(start)  whether the stage from `start` needs the mask
  //   mask(x, t, half)  the scaled score x of position t for this lane's
  //                     row `half`: x, kNegInf or -INFINITY
  // Positions past kv_end are zero-filled.  Returns whether this warp
  // holds live rows (warp-uniform): one that does not only helps load.
  template <class QRow, class KvOff, class NeedMask, class Mask>
  static __device__ __forceinline__ bool walk(Warp& wt, unsigned char* smem,
                                              const __nv_bfloat16* k, const __nv_bfloat16* v,
                                              int kv_begin, int kv_end, int live,
                                              float scale_log2, QRow q_row, KvOff kv_off,
                                              NeedMask need_mask, Mask mask) {
    using bf16 = __nv_bfloat16;
    bf16* q_s = reinterpret_cast<bf16*>(smem);    // [kRows][kLd]
    bf16* k_s = q_s + kRows * kLd;                // [kTcStages][kTcKeys][kLd]
    bf16* v_s = k_s + kTcStages * kTcKeys * kLd;  // likewise
    const int n_stages = max(kv_end - kv_begin + kTcKeys - 1, 0) / kTcKeys;

    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      cp_async_16(q_s + r * kLd + c * 8, q_row(r < live ? r : 0) + c * 8, r < live);
    }
    auto load_stage = [&](int stage, int start) {
      bf16* ks = k_s + stage * kTcKeys * kLd;
      bf16* vs = v_s + stage * kTcKeys * kLd;
      for (int i = threadIdx.x; i < kTcKeys * kChunks; i += kThreads) {
        const int n = i / kChunks;
        const int c = i - n * kChunks;
        const int t = start + n;
        const bool ok = t < kv_end;
        const size_t off = (ok ? kv_off(t) : 0) + c * 8;
        cp_async_16(ks + n * kLd + c * 8, k + off, ok);
        cp_async_16(vs + n * kLd + c * 8, v + off, ok);
      }
    };
    if (n_stages > 0) load_stage(0, kv_begin);
    cp_async_commit();  // group 0: the queries and stage 0
    if (n_stages > 1) load_stage(1, kv_begin + kTcKeys);
    cp_async_commit();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const bool warp_live = warp * 16 < live;
    wt.init();
    for (int it = 0; it < n_stages; ++it) {
      cp_async_wait<1>();  // this thread's copies of stage `it` have landed
      __syncthreads();     // everyone's have, and stage it - 1 is no longer read
      if (it + 2 < n_stages) load_stage((it + 2) % kTcStages, kv_begin + (it + 2) * kTcKeys);
      cp_async_commit();
      if (!warp_live) continue;
      if (it == 0) wt.load_q(q_s + warp * 16 * kLd, lane);
      const int stage = it % kTcStages;
      const int start = kv_begin + it * kTcKeys;
      wt.scores(k_s + stage * kTcKeys * kLd, lane);
      // one branch for the whole stage: whatever the mask derives from
      // the lane's rows (their positions, a division) is computed once
      // in it, not once per score
      if (need_mask(start)) {
#pragma unroll
        for (int j = 0; j < Warp::kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            wt.s[j][e] = mask(wt.s[j][e] * scale_log2, start + j * 8 + (lane & 3) * 2 + (e & 1),
                              e >> 1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < Warp::kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) wt.s[j][e] *= scale_log2;
        }
      }
      wt.softmax();
      wt.accumulate(v_s + stage * kTcKeys * kLd, lane);
    }
    cp_async_wait<0>();
    return warp_live;
  }
};

// ---------------------------------------------------------------------------
// The split-KV merge, shared by the ragged (K1) and paged decode (K2/K3)
// tensor-core kernels
// ---------------------------------------------------------------------------
//
// Parts j = lo .. hi of a row's key span were each walked on their own
// (a split by a block, a stage run by a warp), each leaving its partial
// (m in base 2, l) and unnormalised acc in f32: row r of part j at
// ml[(j * kRows + r) * 2] and acc[(j * kRows + r) * D] (the caller offsets
// both pointers to its (row, KV head)).  Each part is weighted by
// exp2(m_j - m_max), exactly the rescale a one-block walk would apply, so
// a part whose keys are all masked for a row (m_j = -1e30, l_j > 0) drops
// out of a row with a live key anywhere.  The parts are summed in order:
// deterministic, no atomics.  The block's kThreads threads combine rows
// 0 .. rows - 1 and hand each four columns to emit(r, d, acc, m_max, l):
// store_bf16x4 normalises and writes them, or the caller keeps the merged
// partial.  kViaL2: the parts were written by other blocks of the same
// launch, so they are read through L2 (__ldcg), never from a stale L1
// line; otherwise (shared memory, or an earlier launch) by plain loads.
// The loops over parts run to the fixed kMaxParts, unrolled, with the dead
// ones predicated off, so each thread's loads are all in flight together
// instead of one latency per part.
template <bool kViaL2>
__device__ __forceinline__ float2 load_part2(const float* p) {
  if constexpr (kViaL2) return __ldcg(reinterpret_cast<const float2*>(p));
  return *reinterpret_cast<const float2*>(p);
}

template <bool kViaL2>
__device__ __forceinline__ float4 load_part4(const float* p) {
  if constexpr (kViaL2) return __ldcg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

template <int D, int kRows, int kMaxParts, int kThreads, bool kViaL2, class Emit>
__device__ __forceinline__ void merge_partials(const float* __restrict__ acc_in,
                                               const float* __restrict__ ml_in, int lo, int hi,
                                               int rows, Emit emit) {
  __shared__ float w_s[kRows][kMaxParts];
  __shared__ float m_s[kRows];
  __shared__ float l_s[kRows];
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float2 ml[kMaxParts];
    float m_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxParts; ++j) {
      ml[j] = make_float2(kNegInf, 0.0f);
      if (lo + j <= hi) ml[j] = load_part2<kViaL2>(ml_in + ((lo + j) * kRows + r) * 2);
      m_max = fmaxf(m_max, ml[j].x);
    }
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxParts; ++j) {
      if (lo + j <= hi) {
        const float w = exp2f(ml[j].x - m_max);
        w_s[r][j] = w;
        l += w * ml[j].y;
      }
    }
    m_s[r] = m_max;
    l_s[r] = l;
  }
  __syncthreads();
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int d = (i - r * kVecs) * 4;
    float4 part[kMaxParts];
#pragma unroll
    for (int j = 0; j < kMaxParts; ++j) {
      if (lo + j <= hi) part[j] = load_part4<kViaL2>(acc_in + ((lo + j) * kRows + r) * D + d);
    }
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kMaxParts; ++j) {
      if (lo + j <= hi) {
        const float w = w_s[r][j];
        acc.x += w * part[j].x;
        acc.y += w * part[j].y;
        acc.z += w * part[j].z;
        acc.w += w * part[j].w;
      }
    }
    emit(r, d, acc, m_s[r], l_s[r]);
  }
}

// four merged columns normalised (acc / max(l, 1e-30)) and rounded to bf16
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 acc, float l) {
  SoftmaxState st;
  st.m = 0.0f;
  st.l = l;
  uint2 packed;
  packed.x = pack_bf16x2(finalize(st, acc.x), finalize(st, acc.y));
  packed.y = pack_bf16x2(finalize(st, acc.z), finalize(st, acc.w));
  *reinterpret_cast<uint2*>(dst) = packed;
}

}  // namespace optorch
