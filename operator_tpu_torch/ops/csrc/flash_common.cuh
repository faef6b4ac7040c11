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

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// acc / max(l, eps): rows that attended nothing come out as zeros.
__device__ __forceinline__ float finalize(const SoftmaxState& st, float acc) {
  return acc / fmaxf(st.l, kDenomFloor);
}

}  // namespace optorch
