// flash_decode: GQA decode attention, one query per sequence, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:61
// (`flash_decode`, body `_flash_decode_kernel`): out[b, h] = softmax over
// t < min(lengths[b], T) of (q[b, h] . k[b, t, h / G]) / sqrt(D), times
// v[b, t, h / G]; f32 arithmetic, output in q's dtype, a zero row where
// lengths[b] <= 0.  On request the output in f32 with the softmax state
// lse[b, h] = ln sum_t exp(s_t) (-inf where lengths[b] <= 0), with which
// outputs over disjoint pieces of T merge into the output over their
// union (kernels/ops.py merge_decode: a KV cache whose sequence is
// sharded over ranks).
//
// Bound on an H100: bytes.  The valid K and V rows are read once,
// sum_b min(lengths[b], T) * K * D * 2 * sizeof(T), plus q and out, over
// 3.35 TB/s.  The work is 4 * G operations per K/V element read (~1 flop
// per byte at G = 4 in bf16), far below the card's ~295 flop/byte ridge.
// What the design does about it:
//   * pieces sized by occupancy: the wrapper (kernels/flash_decode.py
//     `plan`) cuts T into as few pieces of a multiple of 64 rows as give
//     the grid at least 2 blocks per SM, at most 512 rows a piece and 256
//     pieces a sequence.  Pieces at or past lengths[b] exit at once, so
//     the bytes moved follow the valid length, as the bound does.  The
//     grid is (K, B, n_split), piece-major: every sequence's first piece,
//     always valid, is dispatched first and the pieces most likely past
//     the length last, which spreads the work of ragged lengths evenly
//     over the SMs.  Four blocks fit an SM (32 KB of ring each; ~120
//     registers a thread at G = 4 in bf16, nvcc -Xptxas -v);
//   * one online softmax per warp: a block's 4 warps take the piece's
//     tiles in turn, each with its own (m, l, acc) in registers, and no
//     __syncthreads inside the row loop.  The warps' states are combined
//     once, at the end, in shared memory, in warp order;
//   * 16-byte loads through a cp.async ring: a K or V row is D / VEC
//     segments of 16 bytes (VEC = 8 bf16 or 4 f32), read by LPR lanes (the
//     next power of two), RPI = 32 / LPR rows at once.  Every lane copies
//     its own segments of a tile (RS row steps of K and of V) into its
//     warp's STAGES-deep ring and later reads back exactly those bytes, so
//     cp.async.wait_group alone orders the ring: no barrier at all.  A
//     warp keeps its next 4 KB tile in flight while it computes one (two
//     at its start), so four blocks keep 64-128 KB in flight on an SM,
//     where ~18 KB per SM covers the memory latency at full bandwidth.
//     TMA was not taken: a kv head's rows are strided by K * D and a tile
//     here is 4 KB, which a per-lane cp.async covers without a tensor map
//     or mbarrier;
//   * short reductions: a row's dot product is summed across its LPR lanes
//     only (4 shuffle steps at D = 128 in bf16), and the G <= 16 query heads
//     of a group share every row a lane holds.  Each lane's V sums (G x
//     its segments) stay in registers for the whole piece;
//   * no tensor cores: at G = 4 (llama) or G = 1 (zamba2) a 64-row wgmma
//     tile would be 94-98 % padding for ~1 flop per byte;
//   * one launch: a (sequence, kv head) whose valid rows fit in one piece
//     writes out directly.  Otherwise each piece writes its (m, l, acc) to
//     f32 scratch and takes a ticket; the last block of the (sequence, kv
//     head) to finish merges the pieces in piece order, its loads batched
//     (MERGE_ITEMS outputs x MERGE_UNROLL pieces a thread), and resets the
//     ticket to 0 (decode_common.cuh finish_piece, shared with
//     flash_decode_int8.cu).  No float atomics: two runs give the same bits;
//   * a narrow path: where K or V cannot be read as 16-byte segments
//     (D % VEC != 0, a base off 16 bytes or a stride off VEC elements; the
//     wrapper's `wide_path` is the rule, checked here again), each lane
//     loads single elements into the same ring, synchronously.
// Softmax exponents are taken base 2 (q pre-scaled by log2(e) / sqrt(D)).
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/flash_decode.py).

#include <algorithm>

#include "decode_common.cuh"

namespace {

constexpr int THREADS = 128;       // 4 warps
constexpr int N_WARPS = THREADS / 32;
constexpr int STAGES = 2;          // tiles in a warp's ring
constexpr int RS = 4;              // row steps per tile (RS * RPI rows)
constexpr int MAX_D = 256;         // head_dim limit
constexpr int MAX_G = 16;          // query heads per kv head
constexpr int MAX_SPLIT = 256;     // pieces per sequence (kernels MAX_SPLIT)
constexpr int NARROW_NSEG = MAX_D / 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* out;
  float* lse;         // (B, H) or null; where set, out is f32 (else T)
  float* part;        // m [B][H][n_split], l [B][H][n_split], acc [..][D]
  int32_t* tickets;   // [B][K], all 0 between launches
  int t_len, n_heads, n_kv, group, head_dim, piece, n_split, warp_bytes;
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;        // log2(e) / sqrt(D)
};

// VEC elements of a segment in shared memory, widened to f32
template <int VEC>
__device__ __forceinline__ void seg_f32(const float* p, float* f) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = x.x;
      f[4 * i + 1] = x.y;
      f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = p[e];
  }
}
template <int VEC>
__device__ __forceinline__ void seg_f32(const __nv_bfloat16* p, float* f) {
  if constexpr (VEC == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], 4);
      const float2 t = __bfloat1622float2(h);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = __bfloat162float(p[e]);
  }
}

// grid (K, B, n_split); block THREADS.  GB >= G sizes the register arrays;
// WIDE picks 16-byte segments (VEC = 16 / sizeof(T)) or single elements
// (VEC = 1); NSEG segments a lane holds per row.  Dynamic shared memory:
// N_WARPS regions of warp_bytes (a warp's ring, later its final state and
// the merge's weights), then q_s [G][DP] f32, DP = LPR * NSEG * VEC.
template <typename T, int GB, bool WIDE, int NSEG>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const Params p) {
  constexpr int VEC = WIDE ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int EPL = NSEG * VEC;             // elements a lane holds a row
  constexpr int RING = 2 * RS * NSEG * 32 * VEC;  // elements a stage holds
  extern __shared__ __align__(16) unsigned char smem[];

  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = p.group, D = p.head_dim, H = p.n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lengths past the cache mean "all of it" (the reference's t < lengths)
  const int len = min(max(p.lengths[b], 0), p.t_len);
  const int pieces = (len + p.piece - 1) / p.piece;
  const int64_t row = static_cast<int64_t>(b) * H
      + static_cast<int64_t>(kh) * G;
  T* out = static_cast<T*>(p.out) + row * D;
  float* out32 = static_cast<float*>(p.out) + row * D;
  float* lse = p.lse != nullptr ? p.lse + row : nullptr;
  if (len == 0) {  // nothing to attend to: block 0 writes the zero rows
    if (split == 0) {
      for (int i = tid; i < G * D; i += THREADS) {
        if (lse != nullptr) store(out32 + i, 0.f);
        else store(out + i, 0.f);
      }
      if (lse != nullptr)  // -inf
        for (int g = tid; g < G; g += THREADS)
          lse[g] = __uint_as_float(0xff800000u);
    }
    return;
  }
  if (split >= pieces) return;
  const int c0 = split * p.piece;
  const int c1 = min(c0 + p.piece, len);

  const int SEGS = D / VEC;
  const int LPR = lanes_per_row(SEGS);
  const int RPI = 32 / LPR;
  const int DP = LPR * NSEG * VEC;
  const int R = RS * RPI;                     // rows per tile
  const int sl = lane % LPR, rsub = lane / LPR;

  float* q_s = reinterpret_cast<float*>(smem + N_WARPS * p.warp_bytes);
  T* ring = reinterpret_cast<T*>(smem + warp * p.warp_bytes);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  // this lane's segments of a row: element offset and whether it is in D
  int seg_off[NSEG];
  bool seg_in[NSEG];
#pragma unroll
  for (int j = 0; j < NSEG; ++j) {
    const int s = sl + j * LPR;
    seg_in[j] = s < SEGS;
    seg_off[j] = seg_in[j] ? s * VEC : 0;
  }

  // Copies this lane's segments of the tile at row t0 into ring stage st;
  // rows at or past c1 and segments past D are zero-filled (nothing read).
  auto load_tile = [&](int st, int t0) {
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int row = t0 + i * RPI + rsub;
      const bool ok = row < c1;
      const int64_t r = ok ? row : c0;
#pragma unroll
      for (int j = 0; j < NSEG; ++j) {
        T* dk = ring + st * RING + ((i * NSEG + j) * 32 + lane) * VEC;
        T* dv = dk + RS * NSEG * 32 * VEC;
        const T* sk = kb + r * p.k_st + seg_off[j];
        const T* sv = vb + r * p.v_st + seg_off[j];
        const bool on = ok && seg_in[j];
        if constexpr (WIDE) {
          cp_async<16>(dk, sk, on);
          cp_async<16>(dv, sv, on);
        } else {
          *dk = on ? *sk : T(0.f);
          *dv = on ? *sv : T(0.f);
        }
      }
    }
  };

  float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // Online softmax over the tile in stage st, rows t0 .. t0 + R - 1.
  auto compute_tile = [&](int st, int t0) {
    const T* tk = ring + st * RING;
    const T* tv = tk + RS * NSEG * 32 * VEC;
    float s[GB][RS];
    {
      float kf[RS][EPL];
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < NSEG; ++j)
          seg_f32<VEC>(tk + ((i * NSEG + j) * 32 + lane) * VEC,
                       &kf[i][j * VEC]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        float qv[EPL];
#pragma unroll
        for (int j = 0; j < NSEG; ++j)
          seg_f32<VEC>(q_s + g * DP + (sl + j * LPR) * VEC, &qv[j * VEC]);
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) x += qv[e] * kf[i][e];
          s[g][i] = x;
        }
      }
    }
    // a row's lanes are LPR neighbours: xor below LPR stays inside the row
    for (int o = LPR >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int i = 0; i < RS; ++i)
          s[g][i] += __shfl_xor_sync(0xffffffffu, s[g][i], o);
      }
    }
    bool valid[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) valid[i] = t0 + i * RPI + rsub < c1;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < RS; ++i)
        if (valid[i]) mx = fmaxf(mx, s[g][i]);
      for (int o = LPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);  // row t0 is valid: mx is finite
      const float corr = fast_exp2(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        s[g][i] = valid[i] ? fast_exp2(s[g][i] - m_new) : 0.f;
        sum += s[g][i];
      }
      m[g] = m_new;
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      if (t0 + i * RPI >= c1) break;        // the same for the whole warp
      float vf[EPL];
#pragma unroll
      for (int j = 0; j < NSEG; ++j)
        seg_f32<VEC>(tv + ((i * NSEG + j) * 32 + lane) * VEC, &vf[j * VEC]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += s[g][i] * vf[e];
      }
    }
  };

  // warp w takes tiles w, w + N_WARPS, ...; STAGES - 1 tiles ahead in flight
  const int n_tiles = (c1 - c0 + R - 1) / R;
  const int mine = n_tiles > warp ? (n_tiles - warp + N_WARPS - 1) / N_WARPS
                                  : 0;
  auto tile_row = [&](int t) { return c0 + (warp + t * N_WARPS) * R; };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < mine) load_tile(t, tile_row(t));
    cp_async_commit();
  }
  // q, pre-scaled, while the first tiles are on their way
  {
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb
        + static_cast<int64_t>(kh) * G * p.q_sh;
    for (int i = tid; i < G * DP; i += THREADS) {
      const int g = i / DP, d = i - g * DP;
      q_s[i] = d < D ? to_f32(qb[g * p.q_sh + d]) * p.scale : 0.f;
    }
  }
  __syncthreads();
  for (int t = 0; t < mine; ++t) {
    const int ahead = t + STAGES - 1;
    if (ahead < mine) load_tile(ahead % STAGES, tile_row(ahead));
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    compute_tile(t % STAGES, tile_row(t));
  }
  cp_async_wait<0>();

  // the row groups of a warp hold the same heads and d: add them up
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  __syncwarp();
  // this warp's state into its own region: acc [G][D], m [G], l [G]
  float* ws = reinterpret_cast<float*>(smem + warp * p.warp_bytes);
  if (rsub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < NSEG; ++j)
        if (seg_in[j])
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            ws[g * D + seg_off[j] + e] = acc[g][j * VEC + e];
      if (lane == 0) {
        ws[G * D + g] = m[g];
        ws[G * D + G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the warps' states combined in warp order; one piece: out directly,
  // else the ticketed merge in piece order
  if (lse != nullptr)
    finish_piece<THREADS, MAX_SPLIT>(smem, p.warp_bytes, out32, p.part,
                                     p.tickets, gridDim.y, H, p.n_kv, G, D,
                                     b, kh, split, pieces, p.n_split, lse);
  else
    finish_piece<THREADS, MAX_SPLIT>(smem, p.warp_bytes, out, p.part,
                                     p.tickets, gridDim.y, H, p.n_kv, G, D,
                                     b, kh, split, pieces, p.n_split, lse);
}

template <typename T, int GB, bool WIDE, int NSEG>
int launch(Params p, int B, cudaStream_t stream) {
  constexpr int VEC = WIDE ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int G = p.group, D = p.head_dim;
  const int lpr = lanes_per_row(D / VEC);
  const int ring = STAGES * 2 * RS * NSEG * 32 * VEC
      * static_cast<int>(sizeof(T));
  const int state = (G * D + 2 * G) * 4;
  const int merge = (G * MAX_SPLIT + G) * 4 / N_WARPS + 16;
  p.warp_bytes = (std::max({ring, state, merge}) + 15) / 16 * 16;
  const size_t smem = static_cast<size_t>(N_WARPS) * p.warp_bytes
      + static_cast<size_t>(G) * lpr * NSEG * VEC * 4;
  auto kernel = flash_decode_kernel<T, GB, WIDE, NSEG>;
  static size_t allowed = 48 * 1024;  // dynamic shared memory set so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kernel<<<dim3(p.n_kv, B, p.n_split), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WIDE, int NSEG>
int launch_g(const Params& p, int B, cudaStream_t s) {
  const int G = p.group;
  if (G <= 1) return launch<T, 1, WIDE, NSEG>(p, B, s);
  if (G <= 2) return launch<T, 2, WIDE, NSEG>(p, B, s);
  if (G <= 4) return launch<T, 4, WIDE, NSEG>(p, B, s);
  if (G <= 8) return launch<T, 8, WIDE, NSEG>(p, B, s);
  return launch<T, 16, WIDE, NSEG>(p, B, s);
}

template <typename T>
int launch_t(const Params& p, int B, bool wide, cudaStream_t s) {
  if (!wide) return launch_g<T, false, NARROW_NSEG>(p, B, s);
  constexpr int VEC = 16 / sizeof(T);
  if (p.head_dim / VEC <= 32) return launch_g<T, true, 1>(p, B, s);
  return launch_g<T, true, 2>(p, B, s);  // f32 rows of 33-64 segments
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  wide: 1 for the 16-byte path (D a
// multiple of VEC = 16 / sizeof(T), k and v on 16-byte boundaries with
// strides that are multiples of VEC), 0 for the narrow one.  Returns the
// cudaError_t of the launch (0 on success); -1 for arguments outside what
// the kernel takes.  strides: q batch, head; k batch, token, head; v the
// same (elements; the last dimension of q, k, v is contiguous).  out is a
// contiguous (B, H, D) buffer of q's dtype, or of float32 where lse is
// not null: then a contiguous (B, H) float32 buffer.  T is cut
// into n_split = ceil(T / piece) pieces; where n_split > 1, part is f32
// scratch of B * H * n_split * (D + 2) and tickets B * K int32 zeros
// (left zero by every launch).
int flash_decode_launch(int dtype, int wide, const void* q, const void* k,
                        const void* v, const void* lengths, void* out,
                        void* lse, void* part, void* tickets,
                        int B, int T_len, int H, int K, int D, int piece,
                        int n_split, const int64_t* strides, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || K < 1 || K > 65535 || H % K != 0
      || H / K > MAX_G || D < 1 || D > MAX_D || piece < 1
      || n_split != (T_len + piece - 1) / piece || n_split > MAX_SPLIT
      || (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (wide) {
    const int vec = dtype == 0 ? 4 : 8;
    if (D % vec != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0
        || reinterpret_cast<uintptr_t>(v) % 16 != 0)
      return -1;
    for (int i = 2; i < 8; ++i)
      if (strides[i] % vec != 0) return -1;
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int32_t*>(tickets);
  p.t_len = T_len;
  p.n_heads = H;
  p.n_kv = K;
  p.group = H / K;
  p.head_dim = D;
  p.piece = piece;
  p.n_split = n_split;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_st = strides[3];
  p.k_sh = strides[4];
  p.v_sb = strides[5];
  p.v_st = strides[6];
  p.v_sh = strides[7];
  p.scale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(p, B, wide != 0, s);
  return launch_t<__nv_bfloat16>(p, B, wide != 0, s);
}

}  // extern "C"
