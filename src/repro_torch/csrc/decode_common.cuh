// What the two decode-attention kernels share (flash_decode.cu,
// flash_decode_int8.cu): the T-piece size, conversions, warp reductions,
// and the pass that merges the pieces' softmax states.
//
// Both split the T axis into CHUNK-row pieces, one block per
// (kv head, sequence, piece), and write each piece's online-softmax state
// (m, l, unnormalised acc) to f32 scratch: m_part / l_part [B][H][n_split]
// and acc_part [B][H][n_split][D], n_split = ceil(T / CHUNK).
// decode_merge then combines the pieces below lengths[b].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;          // rows per piece (kernels/*.py CHUNK)
constexpr int MERGE_THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (H, B); block MERGE_THREADS.  Merges the pieces below lengths[b]:
// out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s.
// A sequence with lengths[b] <= 0 has no piece and gets 0 (so does
// kernels/ref.py; the Pallas kernels average V over all T rows there).
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge(const float* __restrict__ m_part,
             const float* __restrict__ l_part,
             const float* __restrict__ acc_part,
             const int32_t* __restrict__ lengths, T* __restrict__ out,
             int t_len, int n_heads, int head_dim, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(max(lengths[b], 0), t_len);
  const int pieces = (len + CHUNK - 1) / CHUNK;
  const int64_t row = static_cast<int64_t>(b) * n_heads + h;
  const float* m = m_part + row * n_split;
  const float* l = l_part + row * n_split;
  float mx = NEG_INF;
  for (int s = 0; s < pieces; ++s) mx = fmaxf(mx, m[s]);
  float denom = 0.f;
  for (int s = 0; s < pieces; ++s) denom += l[s] * expf(m[s] - mx);
  const float inv = 1.f / fmaxf(denom, 1e-30f);
  for (int d = threadIdx.x; d < head_dim; d += MERGE_THREADS) {
    float o = 0.f;
    for (int s = 0; s < pieces; ++s)
      o += acc_part[(row * n_split + s) * head_dim + d] * expf(m[s] - mx);
    store(out + row * head_dim + d, o * inv);
  }
}

}  // namespace
