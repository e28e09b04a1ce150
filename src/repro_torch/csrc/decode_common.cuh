// What the two decode-attention kernels share (flash_decode.cu,
// flash_decode_int8.cu): conversions, warp reductions, the -inf stand-in
// of an online softmax, the cp.async helpers of their per-warp rings,
// base-2 exponentials, the lanes that read one row, and the end of a
// piece: its warps' states combined in warp order, then written out
// directly (one piece) or to scratch, where the last block of the
// (sequence, kv head) to finish merges the pieces in piece order; either
// also writes the softmax state lse where asked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MERGE_ITEMS = 4;     // outputs a thread merges at once
constexpr int MERGE_UNROLL = 8;    // pieces of each it loads at once

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

// Lanes that read one row of `segs` segments: the next power of two, at
// most 32 (a lane then takes segments lane, lane + 32, ...).
__host__ __device__ __forceinline__ int lanes_per_row(int segs) {
  int l = 1;
  while (l < segs && l < 32) l <<= 1;
  return l;
}

// Copies N = 4, 8 or 16 bytes from global to shared memory, asynchronously;
// pred false fills the N bytes with zeros and reads nothing.  16 bytes go
// through L2 only (.cg); 4 and 8, which .cg does not take, through L1.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(d), "l"(src), "n"(N), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22; subnormal results
// flush to 0, which is what -inf rows want): the row loop's exponentials
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The end of a piece, for a block of THREADS threads whose warps have each
// left their softmax state in their own region of `smem` (warp w at
// smem + w * warp_bytes: acc [G][D], then m [G], then l [G], f32, base 2).
// The warps' states are combined in warp order.  A (sequence, kv head)
// whose valid rows fit one piece writes out = acc / l directly.  Otherwise
// the piece's (m, l, acc) go to scratch `part` (m [B][H][n_split], l the
// same, acc [B][H][n_split][D]) and the block takes a ticket; the last
// block of the (sequence, kv head) to finish merges the pieces in piece
// order, its loads batched (MERGE_ITEMS outputs x MERGE_UNROLL pieces a
// thread), and resets the ticket to 0.  No float atomics: two runs give
// the same bits.  Reuses smem for the merge's weights: each warp region
// must hold (G * MAX_SPLIT + G) * 4 / (THREADS / 32) + 16 bytes.  `out`
// points at the (sequence, first head of the group) row of the output, of
// the input's type or float.  Where `lse` (the same row of a (B, H) f32
// array) is not null, the block that writes out also writes each head's
// lse = ln sum_t exp(s_t) = (M + log2 L) ln 2 (M, L of the whole valid
// length, base 2); out is the same either way.
template <int THREADS, int MAX_SPLIT, typename T>
__device__ __forceinline__ void finish_piece(
    unsigned char* smem, int warp_bytes, T* out, float* part,
    int32_t* tickets, int n_seq, int H, int n_kv, int G, int D, int b,
    int kh, int split, int pieces, int n_split, float* lse = nullptr) {
  constexpr int N_WARPS = THREADS / 32;
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t hs0 = (static_cast<int64_t>(b) * H
                       + static_cast<int64_t>(kh) * G) * n_split;
  const int64_t bhs = static_cast<int64_t>(n_seq) * H * n_split;
  float* m_part = part;
  float* l_part = m_part + bhs;
  float* acc_part = l_part + bhs;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    float M = NEG_INF;
    for (int w = 0; w < N_WARPS; ++w) {
      const float* wsw =
          reinterpret_cast<const float*>(smem + w * warp_bytes);
      M = fmaxf(M, wsw[G * D + g]);
    }
    float L = 0.f, A = 0.f;
    for (int w = 0; w < N_WARPS; ++w) {
      const float* wsw =
          reinterpret_cast<const float*>(smem + w * warp_bytes);
      const float c = exp2f(wsw[G * D + g] - M);
      L += wsw[G * D + G + g] * c;
      A += wsw[g * D + d] * c;
    }
    if (pieces == 1) {
      store(out + i, A / L);
      if (lse != nullptr && d == 0) lse[g] = (M + log2f(L)) * LN2;
    } else {
      const int64_t hs = hs0 + static_cast<int64_t>(g) * n_split + split;
      acc_part[hs * D + d] = A;
      if (d == 0) {
        m_part[hs] = M;
        l_part[hs] = L;
      }
    }
  }
  if (pieces == 1) return;

  // the last block of this (sequence, kv head) to finish merges the pieces
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int32_t* ticket = tickets + static_cast<int64_t>(b) * n_kv + kh;
    const int done = atomicAdd(ticket, 1);
    last_block = done == pieces - 1;
    if (last_block) *ticket = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // the weights w[g][s] = 2^(m_s - M_g), M_g = max_s m_s, and 1 / L_g,
  // L_g = sum_s l_s w[g][s]: a warp per head, its lanes over the pieces
  float* wgt = reinterpret_cast<float*>(smem);
  float* inv = wgt + G * pieces;
  for (int g = warp; g < G; g += N_WARPS) {
    const int64_t h = hs0 + static_cast<int64_t>(g) * n_split;
    float ms[MAX_SPLIT / 32], ls[MAX_SPLIT / 32];
    float M = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT / 32; ++j) {
      const int s = lane + 32 * j;
      ms[j] = s < pieces ? __ldcg(m_part + h + s) : NEG_INF;
      ls[j] = s < pieces ? __ldcg(l_part + h + s) : 0.f;
      M = fmaxf(M, ms[j]);
    }
    M = warp_max(M);
    float L = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLIT / 32; ++j) {
      const int s = lane + 32 * j;
      const float w = exp2f(ms[j] - M);
      if (s < pieces) wgt[g * pieces + s] = w;
      L += ls[j] * w;
    }
    L = warp_sum(L);
    if (lane == 0) inv[g] = 1.f / L;
    if (lane == 0 && lse != nullptr) lse[g] = (M + log2f(L)) * LN2;
  }
  __syncthreads();
  // out = sum_s w[g][s] acc_s / L_g in piece order; a thread takes
  // MERGE_ITEMS outputs and loads MERGE_UNROLL pieces of each at once
  for (int i0 = tid; i0 < G * D; i0 += MERGE_ITEMS * THREADS) {
    float o[MERGE_ITEMS] = {};
    for (int s0 = 0; s0 < pieces; s0 += MERGE_UNROLL) {
      float a[MERGE_ITEMS][MERGE_UNROLL];
#pragma unroll
      for (int j = 0; j < MERGE_ITEMS; ++j) {
        const int i = min(i0 + j * THREADS, G * D - 1);
        const int g = i / D, d = i - g * D;
        const int64_t h = hs0 + static_cast<int64_t>(g) * n_split;
#pragma unroll
        for (int u = 0; u < MERGE_UNROLL; ++u)
          a[j][u] = __ldcg(acc_part + (h + min(s0 + u, pieces - 1)) * D + d);
      }
#pragma unroll
      for (int j = 0; j < MERGE_ITEMS; ++j) {
        const int g = min(i0 + j * THREADS, G * D - 1) / D;
#pragma unroll
        for (int u = 0; u < MERGE_UNROLL; ++u)
          if (s0 + u < pieces) o[j] += a[j][u] * wgt[g * pieces + s0 + u];
      }
    }
#pragma unroll
    for (int j = 0; j < MERGE_ITEMS; ++j) {
      const int i = i0 + j * THREADS;
      if (i < G * D) store(out + i, o[j] * inv[i / D]);
    }
  }
}

}  // namespace
