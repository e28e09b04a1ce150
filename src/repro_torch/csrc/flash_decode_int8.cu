// flash_decode_int8: GQA decode attention over an int8 K/V cache, for
// Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode_int8.py
// (`flash_decode_int8`, body `_kernel`): out[b, h] = softmax over
// t < lengths[b] of q[b, h] . (kq[b, t, h / G] * ks[b, t, h / G]) / sqrt(D),
// times vq[b, t, h / G] * vs[b, t, h / G].  kq, vq are int8 codes, ks, vs
// one f32 scale per (token, kv head) (kernels/flash_decode_int8.py
// quantize_kv); f32 arithmetic, output in q's dtype.
//
// Bound on an H100: bytes.  The valid rows are read once, as int8:
// sum_b lengths[b] * K * (2 * D + 8) bytes (codes of K and V plus their two
// f32 scales; 264 B per token and kv head at D = 128, against 512 in bf16),
// plus q and out, over 3.35 TB/s.  The work is 4 * H * D operations per
// valid token, ~8 per byte at G = 4, D = 128, far below the card's ~295
// ridge.  What the design does about it:
//   * dequantization stays out of device memory: the codes are loaded as
//     int8 and widened in registers.  The per-row scale factors out of both
//     products exactly, q . (kq_t ks_t) = ks_t (q . kq_t) and
//     p_t (vq_t vs_t) = (p_t vs_t) vq_t, so it costs one multiply per row
//     and head, not one per element;
//   * the structure of csrc/flash_decode.cu: the G = H / K query heads of a
//     group share every row a block reads; T is split into CHUNK-row
//     pieces, one block per (kv head, sequence, piece), each with an online
//     softmax in f32, and decode_merge (decode_common.cuh) combines them.
//     Pieces at or past lengths[b] exit at once, so the bytes moved follow
//     the valid length, which is what the bound counts;
//   * K rows arrive as 16-byte loads, D / 16 lanes a row (8 at D = 128),
//     a warp keeping 4 loads a lane in flight; V rows as 4-byte loads, a
//     thread keeping V_ROWS of them in flight and its (G x 4) sums in
//     registers for the whole piece.
// Not yet done (later work): TMA / cp.async double buffering, wgmma, a
// persistent schedule.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/flash_decode_int8.py).

#include "decode_common.cuh"

namespace {

constexpr int BLOCK_T = 64;   // rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int N_WARPS = THREADS / 32;
constexpr int K_LOADS = 4;    // 16-byte K loads a lane keeps in flight
constexpr int V_ROWS = 8;     // 4-byte V loads a thread keeps in flight
constexpr int MAX_D = 256;    // head_dim limit (16 segments of 16 bytes)
constexpr int MAX_G = 16;     // query heads per kv head

// the four int8 codes of a 32-bit word, widened to f32
__device__ __forceinline__ void widen4(int w, float* f) {
  f[0] = static_cast<float>(static_cast<signed char>(w));
  f[1] = static_cast<float>(static_cast<signed char>(w >> 8));
  f[2] = static_cast<float>(static_cast<signed char>(w >> 16));
  f[3] = static_cast<float>(static_cast<signed char>(w >> 24));
}

// Lanes that read one K row of D / 16 segments of 16 bytes: a power of two
// at least D / 16, so the lanes of a row reduce by shuffles.
__host__ __device__ __forceinline__ int lanes_per_row(int D) {
  const int S = D / 16;
  return S <= 1 ? 1 : S <= 2 ? 2 : S <= 4 ? 4 : S <= 8 ? 8 : 16;
}

// Element strides of the inputs (int8 strides are also byte strides).
struct Strides {
  int64_t q_sb, q_sh;
  int64_t k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t ks_sb, ks_st, ks_sh, vs_sb, vs_st, vs_sh;
};

// Pass 1.  grid (K, B, n_split); block THREADS.  GB >= G is the head count
// the register arrays are sized for.  D is a multiple of 16 and every K/V
// row starts on a 16-byte boundary (the wrapper checks both).
// Shared memory, all f32:
//   q_s [G][DP]   q pre-scaled by 1/sqrt(D), zero past D; DP = 16 * LPR,
//   p_s [G][BLOCK_T]  scores, then p_t * vs_t of the tile,
//   vs_s [BLOCK_T]    the tile's V scales,
//   m_s, l_s, c_s [G] running max, running sum, this tile's correction,
//   acc_s [G][D]      the row groups' V sums, added in a fixed order.
template <typename T, int GB>
__global__ void __launch_bounds__(THREADS)
flash_decode_int8_part(const T* __restrict__ q,
                       const int8_t* __restrict__ kq,
                       const int8_t* __restrict__ vq,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ m_part,
                       float* __restrict__ l_part,
                       float* __restrict__ acc_part, int t_len, int n_heads,
                       int group, int head_dim, int n_split, Strides st,
                       float scale) {
  extern __shared__ float smem[];
  const int G = group, D = head_dim;
  // K scores: a row is S 16-byte segments, read by LPR >= S lanes; a warp
  // reads RPW rows at once
  const int S = D / 16;
  const int LPR = lanes_per_row(D);
  const int RPW = 32 / LPR;
  const int DP = 16 * LPR;
  // V sums: a thread owns 4 consecutive d of every n_rg-th row
  const int NQ = D / 4;
  const int n_rg = THREADS / NQ;

  float* q_s = smem;
  float* p_s = q_s + G * DP;
  float* vs_s = p_s + G * BLOCK_T;
  float* m_s = vs_s + BLOCK_T;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  float* acc_s = c_s + G;

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

  const T* qb = q + b * st.q_sb + static_cast<int64_t>(kh) * G * st.q_sh;
  const int8_t* kb = kq + b * st.k_sb + kh * st.k_sh;
  const int8_t* vb = vq + b * st.v_sb + kh * st.v_sh;
  const float* ksb = ks + b * st.ks_sb + kh * st.ks_sh;
  const float* vsb = vs + b * st.vs_sb + kh * st.vs_sh;

  for (int i = tid; i < G * DP; i += THREADS) {
    const int g = i / DP, d = i - g * DP;
    q_s[i] = d < D ? to_f32(qb[g * st.q_sh + d]) * scale : 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const int seg = lane % LPR, rsub = lane / LPR;
  const int quad = tid % NQ, rg = tid / NQ;
  float acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  __syncthreads();

  for (int t0 = c0; t0 < c1; t0 += BLOCK_T) {
    const int n_t = min(BLOCK_T, c1 - t0);

    // 1. scores: every lane loads K_LOADS 16-byte segments of K_LOADS rows
    //    (and the row's two scales on its first lane) before any use; the
    //    rows are dotted with all G query heads
    for (int jb = 0; jb < n_t; jb += N_WARPS * RPW * K_LOADS) {
      int4 kw[K_LOADS];
      float ksr[K_LOADS], vsr[K_LOADS];
#pragma unroll
      for (int r = 0; r < K_LOADS; ++r) {
        const int j = jb + (r * N_WARPS + warp) * RPW + rsub;
        const int64_t t = t0 + j;
        kw[r] = j < n_t && seg < S
            ? *reinterpret_cast<const int4*>(kb + t * st.k_st + seg * 16)
            : make_int4(0, 0, 0, 0);
        const bool first = j < n_t && seg == 0;
        ksr[r] = first ? ksb[t * st.ks_st] : 0.f;
        vsr[r] = first ? vsb[t * st.vs_st] : 0.f;
      }
      float kf[K_LOADS][16];
#pragma unroll
      for (int r = 0; r < K_LOADS; ++r) {
        widen4(kw[r].x, kf[r]);
        widen4(kw[r].y, kf[r] + 4);
        widen4(kw[r].z, kf[r] + 8);
        widen4(kw[r].w, kf[r] + 12);
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        const float4* qg =
            reinterpret_cast<const float4*>(q_s + g * DP + seg * 16);
        float qv[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = qg[i];
          qv[4 * i] = x.x;
          qv[4 * i + 1] = x.y;
          qv[4 * i + 2] = x.z;
          qv[4 * i + 3] = x.w;
        }
        float s[K_LOADS];
#pragma unroll
        for (int r = 0; r < K_LOADS; ++r) {
          s[r] = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) s[r] += qv[i] * kf[r][i];
        }
        // lanes of one row are LPR neighbours: xor below LPR stays inside
        for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int r = 0; r < K_LOADS; ++r)
            s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
        }
        if (seg == 0) {
#pragma unroll
          for (int r = 0; r < K_LOADS; ++r) {
            const int j = jb + (r * N_WARPS + warp) * RPW + rsub;
            if (j < n_t) p_s[g * BLOCK_T + j] = s[r] * ksr[r];
          }
        }
      }
      if (seg == 0) {
#pragma unroll
        for (int r = 0; r < K_LOADS; ++r) {
          const int j = jb + (r * N_WARPS + warp) * RPW + rsub;
          if (j < n_t) vs_s[j] = vsr[r];
        }
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per query head; p_t is summed unscaled
    //    and stored times vs_t, the V row's scale
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
        pg[j] = p * vs_s[j];
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

    // 3. acc = acc * corr + (p vs) @ vq: a thread takes 4 consecutive d of
    //    the rows rg, rg + n_rg, ...; each V row is read once for all G
    //    heads
    if (rg < n_rg) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        const float corr = c_s[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
      }
      for (int j0 = rg; j0 < n_t; j0 += n_rg * V_ROWS) {
        int vw[V_ROWS];
#pragma unroll
        for (int u = 0; u < V_ROWS; ++u) {
          const int j = j0 + u * n_rg;
          vw[u] = j < n_t
              ? *reinterpret_cast<const int*>(
                    vb + static_cast<int64_t>(t0 + j) * st.v_st + quad * 4)
              : 0;
        }
#pragma unroll
        for (int u = 0; u < V_ROWS; ++u) {
          const int j = j0 + u * n_rg;
          if (j >= n_t) break;
          float v[4];
          widen4(vw[u], v);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g >= G) break;
            const float p = p_s[g * BLOCK_T + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] += p * v[e];
          }
        }
      }
    }
    __syncthreads();
  }

  // the row groups' sums into acc_s, one group after another: a fixed order,
  // so the output does not change from run to run
  for (int r = 0; r < n_rg; ++r) {
    if (rg == r) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* a = acc_s + g * D + quad * 4 + e;
          *a = r == 0 ? acc[g][e] : *a + acc[g][e];
        }
      }
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
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* lengths, void* out, void* m_part,
           void* l_part, void* acc_part, int B, int T_len, int H, int K,
           int D, int n_split, const Strides& st, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem = sizeof(float) *
      (G * 16 * lanes_per_row(D) + G * BLOCK_T + BLOCK_T + 3 * G + G * D);
  flash_decode_int8_part<T, GB>
      <<<dim3(K, B, n_split), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const int8_t*>(kq),
          static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
          static_cast<const float*>(vs),
          static_cast<const int32_t*>(lengths),
          static_cast<float*>(m_part), static_cast<float*>(l_part),
          static_cast<float*>(acc_part), T_len, H, G, D, n_split, st,
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
int launch_g(int G, const void* q, const void* kq, const void* vq,
             const void* ks, const void* vs, const void* lengths, void* out,
             void* m_part, void* l_part, void* acc_part, int B, int T_len,
             int H, int K, int D, int n_split, const Strides& st,
             cudaStream_t s) {
#define FD8_LAUNCH(GB)                                                       \
  return launch<T, GB>(q, kq, vq, ks, vs, lengths, out, m_part, l_part,     \
                       acc_part, B, T_len, H, K, D, n_split, st, s)
  if (G <= 1) FD8_LAUNCH(1);
  if (G <= 2) FD8_LAUNCH(2);
  if (G <= 4) FD8_LAUNCH(4);
  if (G <= 8) FD8_LAUNCH(8);
  FD8_LAUNCH(16);
#undef FD8_LAUNCH
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launches (0 on success); -1 for arguments outside what
// the kernel takes.  strides: 14 element strides, in the order of Strides
// (q: batch, head; kq, vq: batch, token, kv head; ks, vs: the same); the
// last dimension of q, kq, vq is contiguous, D a multiple of 16 and every
// K/V row 16-byte aligned.  out is a contiguous (B, H, D) buffer; m_part,
// l_part (B, H, n_split) and acc_part (B, H, n_split, D) are f32 scratch
// with n_split = ceil(T / CHUNK).
int flash_decode_int8_launch(int dtype, const void* q, const void* kq,
                             const void* vq, const void* ks, const void* vs,
                             const void* lengths, void* out, void* m_part,
                             void* l_part, void* acc_part, int B, int T_len,
                             int H, int K, int D, int n_split,
                             const int64_t* strides, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || K < 1 || H % K != 0 ||
      H / K > MAX_G || D < 16 || D > MAX_D || D % 16 != 0 ||
      n_split != (T_len + CHUNK - 1) / CHUNK || n_split > 65535)
    return -1;
  const Strides st{strides[0],  strides[1],  strides[2],  strides[3],
                   strides[4],  strides[5],  strides[6],  strides[7],
                   strides[8],  strides[9],  strides[10], strides[11],
                   strides[12], strides[13]};
  for (int i = 2; i < 8; ++i)
    if (strides[i] % 16 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (dtype == 0)
    return launch_g<float>(G, q, kq, vq, ks, vs, lengths, out, m_part,
                           l_part, acc_part, B, T_len, H, K, D, n_split, st,
                           s);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(G, q, kq, vq, ks, vs, lengths, out,
                                   m_part, l_part, acc_part, B, T_len, H, K,
                                   D, n_split, st, s);
  return -1;
}

}  // extern "C"
