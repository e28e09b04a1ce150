// flash_decode: GQA decode attention, one query per sequence, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (`flash_decode`, body `_flash_decode_kernel`): out[b, h] = softmax over
// t < lengths[b] of (q[b, h] . k[b, t, h / G]) / sqrt(D), times v.
//
// Bound on an H100: bytes.  The valid K and V rows are read once,
// sum_b lengths[b] * K * D * 2 * sizeof(T), plus q and out, over 3.35 TB/s;
// the arithmetic is ~4 flops per K/V element read, far below the ~295
// flop/byte ridge of the card.  What the design does about it:
//   * the G = H / K query heads of a group share every K/V row a block
//     reads, as the TPU kernel's tile of G heads did, so K/V stream from
//     memory once per group, not once per head;
//   * the TPU walked the KV blocks of a sequence in order on one core; here
//     the T axis is split into CHUNK-token pieces, one block per
//     (kv head, sequence, piece), so a batch of 16 sequences still puts
//     hundreds of blocks on the 132 SMs.  Each block keeps an online
//     softmax (m, l, acc) in f32 shared memory over its piece, and a second
//     kernel merges the pieces' states.  Pieces at or past lengths[b] exit
//     at once, so the bytes moved follow the valid length, which is also
//     what the bound counts;
//   * a warp keeps ROWS K rows, a thread V_ROWS V values, in flight, so a
//     block is not one memory latency per row.
// Not yet done (later work): 16-byte vector loads, TMA / wgmma, a
// persistent schedule.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/flash_decode.py).

#include "decode_common.cuh"

namespace {

constexpr int BLOCK_T = 64;   // K/V rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int N_WARPS = THREADS / 32;
constexpr int ROWS = 4;       // K rows a warp loads before reducing
constexpr int V_ROWS = 16;    // V values a thread loads before accumulating
constexpr int MAX_D = 256;    // head_dim limit (8 values per lane in phase 1)
constexpr int MAX_G = 16;     // query heads per kv head

// Pass 1.  grid (K, B, n_split); block THREADS.  GB >= G is the head count
// the register arrays are sized for.  Shared memory, all f32:
//   q_s [G][D] (pre-scaled by 1/sqrt(D)), acc_s [G][D], p_s [G][BLOCK_T],
//   m_s, l_s, c_s [G] (running max, running sum, this tile's correction).
// Writes each piece's (m, l, unnormalised acc) to the f32 scratch
// m_part / l_part [B][H][n_split] and acc_part [B][H][n_split][D].
template <typename T, int GB>
__global__ void __launch_bounds__(THREADS)
flash_decode_part(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const int32_t* __restrict__ lengths,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ acc_part, int t_len, int n_heads,
                  int group, int head_dim, int n_split, int64_t q_sb,
                  int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
                  int64_t v_sb, int64_t v_st, int64_t v_sh, float scale) {
  extern __shared__ float smem[];
  const int G = group, D = head_dim;
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* p_s = acc_s + G * D;
  float* m_s = p_s + G * BLOCK_T;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // lengths past the cache mean "all of it" (the reference's t < lengths)
  const int len = min(max(lengths[b], 0), t_len);
  const int c0 = split * CHUNK;
  if (c0 >= len) return;  // the merge reads only pieces below len
  const int c1 = min(c0 + CHUNK, len);

  const T* qb = q + b * q_sb + static_cast<int64_t>(kh) * G * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(qb[g * q_sh + d]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = c0; t0 < c1; t0 += BLOCK_T) {
    const int n_t = min(BLOCK_T, c1 - t0);

    // 1. scores: a warp takes ROWS consecutive K rows, lanes across D; the
    //    rows are loaded together, then dotted with all G query heads
    for (int jb = warp * ROWS; jb < n_t; jb += N_WARPS * ROWS) {
      float kv[ROWS][MAX_D / 32];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const T* kr = kb + static_cast<int64_t>(t0 + jb + r) * k_st;
#pragma unroll
        for (int i = 0; i < MAX_D / 32; ++i) {
          const int d = lane + 32 * i;
          kv[r][i] = (jb + r < n_t && d < D) ? to_f32(kr[d]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        float s[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          s[r] = 0.f;
#pragma unroll
          for (int i = 0; i < MAX_D / 32; ++i) {
            const int d = lane + 32 * i;
            if (d < D) s[r] += q_s[g * D + d] * kv[r][i];
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r] = warp_sum(s[r]);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (jb + r < n_t) p_s[g * BLOCK_T + jb + r] = s[r];
        }
      }
    }
    __syncthreads();

    // 2. online softmax: one warp per query head
    for (int g = warp; g < G; g += N_WARPS) {
      float* pg = p_s + g * BLOCK_T;
      float mx = NEG_INF;
      for (int j = lane; j < n_t; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n_t; j += 32) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p @ V: threads across D, V_ROWS values loaded
    //    together, each V row read once for all G heads
    for (int d = tid; d < D; d += THREADS) {
      float a[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g)
        a[g] = g < G ? acc_s[g * D + d] * c_s[g] : 0.f;
      for (int j0 = 0; j0 < n_t; j0 += V_ROWS) {
        float vv[V_ROWS];
#pragma unroll
        for (int u = 0; u < V_ROWS; ++u)
          vv[u] = j0 + u < n_t
              ? to_f32(vb[static_cast<int64_t>(t0 + j0 + u) * v_st + d])
              : 0.f;
#pragma unroll
        for (int u = 0; u < V_ROWS; ++u) {
          if (j0 + u >= n_t) break;
#pragma unroll
          for (int g = 0; g < GB; ++g)
            if (g < G) a[g] += p_s[g * BLOCK_T + j0 + u] * vv[u];
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G) acc_s[g * D + d] = a[g];
    }
    __syncthreads();
  }

  const int64_t row0 = static_cast<int64_t>(b) * n_heads
      + static_cast<int64_t>(kh) * G;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    acc_part[((row0 + g) * n_split + split) * D + d] = acc_s[i];
  }
  for (int g = tid; g < G; g += THREADS) {
    m_part[(row0 + g) * n_split + split] = m_s[g];
    l_part[(row0 + g) * n_split + split] = l_s[g];
  }
}

template <typename T, int GB>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* m_part, void* l_part, void* acc_part, int B,
           int T_len, int H, int K, int D, int n_split, int64_t q_sb,
           int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
           int64_t v_sb, int64_t v_st, int64_t v_sh, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) * (2 * G * D + G * BLOCK_T + 3 * G);
  flash_decode_part<T, GB><<<dim3(K, B, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), T_len, H, G, D, n_split, q_sb, q_sh,
      k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge<T><<<dim3(H, B), MERGE_THREADS, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), T_len, H,
      D, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_g(int G, const void* q, const void* k, const void* v,
             const void* lengths, void* out, void* m_part, void* l_part,
             void* acc_part, int B, int T_len, int H, int K, int D,
             int n_split, int64_t q_sb, int64_t q_sh, int64_t k_sb,
             int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
             int64_t v_sh, cudaStream_t s) {
#define FD_LAUNCH(GB)                                                        \
  return launch<T, GB>(q, k, v, lengths, out, m_part, l_part, acc_part, B,  \
                       T_len, H, K, D, n_split, q_sb, q_sh, k_sb, k_st,     \
                       k_sh, v_sb, v_st, v_sh, s)
  if (G <= 1) FD_LAUNCH(1);
  if (G <= 2) FD_LAUNCH(2);
  if (G <= 4) FD_LAUNCH(4);
  if (G <= 8) FD_LAUNCH(8);
  FD_LAUNCH(16);
#undef FD_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (0 on success); -1 for arguments outside what the kernel takes.
// Strides are in elements; the last dimension of q, k, v must be
// contiguous and out is a contiguous (B, H, D) buffer.  m_part, l_part
// (B, H, n_split) and acc_part (B, H, n_split, D) are f32 scratch with
// n_split = ceil(T / CHUNK).
int flash_decode_launch(int dtype, const void* q, const void* k,
                        const void* v, const void* lengths, void* out,
                        void* m_part, void* l_part, void* acc_part, int B,
                        int T_len, int H, int K, int D, int n_split,
                        int64_t q_sb, int64_t q_sh, int64_t k_sb,
                        int64_t k_st, int64_t k_sh, int64_t v_sb,
                        int64_t v_st, int64_t v_sh, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || K < 1 || H % K != 0 ||
      H / K > MAX_G || D < 1 || D > MAX_D ||
      n_split != (T_len + CHUNK - 1) / CHUNK || n_split > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (dtype == 0)
    return launch_g<float>(G, q, k, v, lengths, out, m_part, l_part,
                           acc_part, B, T_len, H, K, D, n_split, q_sb, q_sh,
                           k_sb, k_st, k_sh, v_sb, v_st, v_sh, s);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(G, q, k, v, lengths, out, m_part, l_part,
                                   acc_part, B, T_len, H, K, D, n_split,
                                   q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                                   v_sh, s);
  return -1;
}

}  // extern "C"
