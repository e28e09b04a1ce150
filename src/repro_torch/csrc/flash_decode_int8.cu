// flash_decode_int8: GQA decode attention over an int8 K/V cache, for
// Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode_int8.py:73
// (`flash_decode_int8`, body `_kernel`): out[b, h] = softmax over
// t < min(lengths[b], T) of q[b, h] . (kq[b, t, h / G] * ks[b, t, h / G])
// / sqrt(D), times vq[b, t, h / G] * vs[b, t, h / G].  kq, vq are int8
// codes, ks, vs one f32 scale per (token, kv head) (kernels/
// flash_decode_int8.py quantize_kv); f32 arithmetic, output in q's dtype,
// a zero row where lengths[b] <= 0.
//
// Bound on an H100: bytes.  The valid rows are read once, as int8:
// sum_b min(lengths[b], T) * K * (2 * D + 8) bytes (the codes of K and V
// and their two f32 scales: 264 B per token and kv head at D = 128, against
// 512 in bf16; chip_smoke.py int8_bound), plus q and out, over 3.35 TB/s.
// The work is 4 * G operations per code read (~4 per byte at G = 4): far
// below the tensor cores' ridge, but a code costs as many instructions as
// a bf16 element at half its bytes, so issue slots, not the f32 pipe, are
// what the design saves.  What it does about it (the layout is
// csrc/flash_decode.cu's):
//   * pieces sized by occupancy: the wrapper (kernels/flash_decode_int8.py,
//     through flash_decode.plan with its own MAX_PIECE: an int8 row is
//     half a bf16 row's bytes) cuts T into as few pieces of a multiple of
//     64 rows as give the grid at least 2 blocks per SM.  The grid is
//     (K, B, n_split), piece-major; pieces at or past lengths[b] exit at
//     once, so the bytes moved follow the valid length;
//   * one online softmax per warp, base 2 (q pre-scaled by
//     log2(e) / sqrt(D)): a block's 4 warps take the piece's 16-row tiles
//     in turn, each with its own (m, l, acc) in registers, no
//     __syncthreads in the row loop, the warps' states combined once, in
//     warp order.  The G heads' maxima are reduced together and a warp
//     rescales its sums only when a tile raises one (a warp-uniform
//     branch; corr = 2^0 = 1 for the others, so the bits are those of
//     rescaling every tile);
//   * a per-warp cp.async ring, STAGES tiles deep: every lane copies its own
//     CPL-byte code segments of the tile's K and V rows and reads back
//     exactly those bytes; the tile's scales, ks and vs of its R rows, are
//     copied 4 bytes a lane (one copy a lane at R = 16), so a __syncwarp
//     after cp.async.wait_group (and one before a stage is refilled) orders
//     them for the other lanes of the warp;
//   * lanes by group size: a lane holds CPL codes of a row, 16 (one 16-byte
//     copy) for G <= 4, 8 for G = 8 and 4 for G = 16, so that its V sums,
//     G x CPL f32, stay at 64 registers (128 only at G = 16, D > 128).
//     D / CPL lanes read a row (the next power of two; 8 at D = 128, G = 4),
//     so a row's dot product takes 3 shuffle steps, not bf16's 4.  q sits in
//     shared memory laid out so a lane's 16-byte reads lie beside its row
//     neighbours' (no bank conflict), or in registers where G x CPL <= 32;
//   * few instructions besides the work: per-lane pointers advanced by a
//     fixed step per tile and compile-time offsets into the ring and q, the
//     shuffle steps unrolled, and every loop over the bucket's GB heads
//     (q zero for heads past G, whose sums are never written), so no
//     per-head test runs in the row loop;
//   * the scales factored out of both products, exactly: q . (kq_t ks_t) =
//     ks_t (q . kq_t) and p_t (vq_t vs_t) = (p_t vs_t) vq_t, one multiply
//     per row and head each, not one per code;
//   * exact widening at full rate: XOR a word of four codes with
//     0x80808080 (one lop3), then per code one prmt builds the float bits
//     0x4B0000uu = 2^23 + u and one FADD of -(2^23 + 128) gives the code,
//     exactly, for all 256 codes.  cvt from int8 runs at 16 per clock per
//     SM against the FADD's 128;
//   * no tensor cores: at G = 4 (llama) or G = 1 (zamba2) an mma tile would
//     be mostly padding;
//   * one launch: a (sequence, kv head) whose valid rows fit in one piece
//     writes out directly; otherwise the last block to finish merges the
//     pieces in piece order through the f32 workspace and resets its ticket
//     (decode_common.cuh finish_piece).  No float atomics: two runs give
//     the same bits.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/flash_decode_int8.py).

#include <algorithm>

#include "decode_common.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps
constexpr int N_WARPS = THREADS / 32;
constexpr int STAGES = 2;      // tiles in a warp's ring
constexpr int MAX_D = 256;     // head_dim limit, a multiple of 16
constexpr int MAX_G = 16;      // query heads per kv head
constexpr int MAX_SPLIT = 256; // pieces per sequence (kernels MAX_SPLIT)

struct Params {
  const void* q;
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  const int32_t* lengths;
  void* out;
  float* part;        // m [B][H][n_split], l [B][H][n_split], acc [..][D]
  int32_t* tickets;   // [B][K], all 0 between launches
  int t_len, n_heads, n_kv, group, head_dim, piece, n_split, warp_bytes;
  int64_t q_sb, q_sh;                      // elements
  int64_t k_sb, k_st, k_sh, v_sb, v_st, v_sh;  // bytes (int8)
  int64_t ks_sb, ks_st, ks_sh, vs_sb, vs_st, vs_sh;  // elements (f32)
  float scale;        // log2(e) / sqrt(D)
};

// A lane's share of a tile: GB >= G heads, CPL codes a segment, NSEG
// segments a row.  RS row steps a tile (RS * 32 / LPR rows: 16 at D = 80
// and 128), 1 where the lane's V sums GB x EPL take 128 registers (G = 16
// at D > 128, the one case); QREG keeps q in registers for the whole piece
// where it fits beside the V sums.
template <int GB, int CPL, int NSEG>
struct Layout {
  static constexpr int EPL = CPL * NSEG;           // codes a lane holds a row
  static constexpr int RS = GB * EPL >= 128 ? 1 : 4;
  static constexpr bool QREG = GB * EPL <= 32;
  // blocks an SM must hold (__launch_bounds__).  At G = 4 ptxas then takes
  // 168 registers, 3 blocks an SM, with no spill; a cap at 3 blocks (168)
  // spills, and one at 4 (128) spills more and runs slower.
  static constexpr int MIN_BLOCKS = GB <= 4 ? 2 : 1;
  static constexpr int CODES = RS * NSEG * 32 * CPL;  // K (or V) bytes a stage
  static constexpr int SCALES = 32 * RS * 4;          // ks (or vs) bytes
  static constexpr int STAGE = 2 * CODES + 2 * SCALES;
};

// The four int8 codes of a 32-bit word, widened to f32 exactly: u = code
// + 128 as an unsigned byte (the XOR), 0x4B0000uu is 2^23 + u, and
// 2^23 + u - (2^23 + 128) = code with no rounding (integers below 2^24).
__device__ __forceinline__ void widen4(unsigned w, float* f) {
  const unsigned x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - 8388736.f;
}

// CPL codes of a segment in shared memory, widened to f32
template <int CPL>
__device__ __forceinline__ void seg_codes(const unsigned char* p, float* f) {
  if constexpr (CPL == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    widen4(x.x, f);
    widen4(x.y, f + 4);
    widen4(x.z, f + 8);
    widen4(x.w, f + 12);
  } else if constexpr (CPL == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    widen4(x.x, f);
    widen4(x.y, f + 4);
  } else {
    widen4(*reinterpret_cast<const unsigned*>(p), f);
  }
}

// 4 floats of shared memory, 16-byte aligned
__device__ __forceinline__ void load_f32x4(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

// grid (K, B, n_split); block THREADS.  Dynamic shared memory: N_WARPS
// regions of warp_bytes (a warp's ring, later its final state and the
// merge's weights), then q_s.  D is a multiple of 16 and every K/V row
// starts on a 16-byte boundary (the wrapper checks both, and the C entry
// again).  The row loop runs over all GB heads of the bucket (q is zero for
// heads past G, whose sums are never written) and keeps its addresses in
// per-lane pointers and compile-time offsets, so its instructions are the
// copies, the widening, the products and the softmax.
template <typename T, int GB, int CPL, int NSEG>
__global__ void __launch_bounds__(THREADS, Layout<GB, CPL, NSEG>::MIN_BLOCKS)
flash_decode_int8_kernel(const Params p) {
  using L = Layout<GB, CPL, NSEG>;
  constexpr int EPL = L::EPL, RS = L::RS;
  constexpr int SP = 32 * NSEG;    // q_s slots of a head's 4 codes
  extern __shared__ __align__(16) unsigned char smem[];

  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = p.group, D = p.head_dim, H = p.n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lengths past the cache mean "all of it" (the reference's t < lengths)
  const int len = min(max(p.lengths[b], 0), p.t_len);
  const int pieces = (len + p.piece - 1) / p.piece;
  T* out = static_cast<T*>(p.out)
      + (static_cast<int64_t>(b) * H + static_cast<int64_t>(kh) * G) * D;
  if (len == 0) {  // nothing to attend to: block 0 writes the zero rows
    if (split == 0)
      for (int i = tid; i < G * D; i += THREADS) store(out + i, 0.f);
    return;
  }
  if (split >= pieces) return;
  const int c0 = split * p.piece;
  const int c1 = min(c0 + p.piece, len);

  // a row is SEGS segments of CPL codes, read by LPR lanes (NSEG > 1 only
  // where LPR = 32), RPI rows at once, R rows a tile
  const int SEGS = D / CPL;
  const int LPR = lanes_per_row(SEGS);
  const int RPI = 32 / LPR;
  const int R = RS * RPI;
  const int sl = lane % LPR, rsub = lane / LPR;

  // q_s [GB][CPL / 4][SP][4]: codes e .. e + 3 of segment s of head g, q
  // pre-scaled, zero past D and for heads past G.  A lane reads its
  // segments' slots at fixed offsets from q_lane, beside its row
  // neighbours' (no bank conflict).
  float* q_s = reinterpret_cast<float*>(smem + N_WARPS * p.warp_bytes);
  const float* q_lane = q_s + sl * 4;
  unsigned char* ring = smem + warp * p.warp_bytes;
  bool seg_in[NSEG];
  int seg_off[NSEG];
#pragma unroll
  for (int j = 0; j < NSEG; ++j) {
    seg_in[j] = sl + j * 32 < SEGS;
    seg_off[j] = seg_in[j] ? (sl + j * 32) * CPL : 0;
  }

  // The warp's tiles are rows t0 = c0 + (warp + t N_WARPS) R, t = 0, 1, ...
  // Per-lane pointers at row c0 + warp R + rsub of the codes (segment 0)
  // and of this lane's scale copy (c = lane: ks of row c, or vs of row
  // c - R), advanced by a tile step after every load; rows at or past c1
  // copy nothing from row c0 of this lane's segment, a valid address.
  const int64_t k_row = p.k_st, v_row = p.v_st;
  const int8_t* k0 = p.kq + b * p.k_sb + kh * p.k_sh
      + static_cast<int64_t>(c0) * k_row + seg_off[0];
  const int8_t* v0 = p.vq + b * p.v_sb + kh * p.v_sh
      + static_cast<int64_t>(c0) * v_row + seg_off[0];
  const int first = warp * R + rsub;        // row of the first tile - c0
  const int8_t* kp = k0 + first * k_row;
  const int8_t* vp = v0 + first * v_row;
  const bool is_v = lane >= R;              // lanes 2 R .. 31 copy nothing
  const int sc_row = is_v ? lane - R : lane;
  const int64_t sc_st = is_v ? p.vs_st : p.ks_st;
  const float* sc0 = (is_v ? p.vs + b * p.vs_sb + kh * p.vs_sh
                           : p.ks + b * p.ks_sb + kh * p.ks_sh)
      + static_cast<int64_t>(c0) * sc_st;
  const float* scp = sc0 + static_cast<int64_t>(warp * R + sc_row) * sc_st;
  const int sc_slot = (is_v ? 32 * RS : 0) + sc_row;
  int next_row = c0 + warp * R;             // t0 of the next tile to load
  const int tile_step = N_WARPS * R;

  // Copies the next tile (rows next_row ..) into ring stage st: this lane's
  // code segments of its RS rows, and its share of the tile's scales (ks
  // of row c to slot c, vs of row c to slot 32 RS + c; lane l takes
  // c = l, and where 2 R > 32, l + 32, ...).
  auto load_tile = [&](int st) {
    unsigned char* base = ring + st * L::STAGE + lane * CPL;
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const bool ok = next_row + i * RPI + rsub < c1;
      const int64_t dk = static_cast<int64_t>(i * RPI) * k_row;
      const int64_t dv = static_cast<int64_t>(i * RPI) * v_row;
#pragma unroll
      for (int j = 0; j < NSEG; ++j) {
        const int off = (j == 0) ? 0 : seg_off[j] - seg_off[0];
        const bool on = ok && seg_in[j];
        cp_async<CPL>(base + (i * NSEG + j) * 32 * CPL,
                      (on ? kp + dk : k0) + off, on);
        cp_async<CPL>(base + L::CODES + (i * NSEG + j) * 32 * CPL,
                      (on ? vp + dv : v0) + off, on);
      }
    }
    float* sc = reinterpret_cast<float*>(ring + st * L::STAGE
                                         + 2 * L::CODES);
    if (lane < 2 * R) {
      const bool ok = next_row + sc_row < c1;
      cp_async<4>(sc + sc_slot, ok ? scp : sc0, ok);
    }
    for (int c = lane + 32; c < 2 * R; c += 32) {   // R > 16: small D
      const bool v = c >= R;
      const int row = v ? c - R : c;
      const bool ok = next_row + row < c1;
      const float* src = (v ? p.vs + b * p.vs_sb + kh * p.vs_sh
                            : p.ks + b * p.ks_sb + kh * p.ks_sh)
          + static_cast<int64_t>(ok ? next_row + row : c0)
          * (v ? p.vs_st : p.ks_st);
      cp_async<4>(sc + (v ? 32 * RS : 0) + row, src, ok);
    }
    kp += tile_step * k_row;
    vp += tile_step * v_row;
    scp += tile_step * sc_st;
    next_row += tile_step;
  };

  float m[GB], l[GB], acc[GB][EPL];
  float qr[L::QREG ? GB : 1][L::QREG ? EPL : 1];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  // q slot of codes e .. e + 3 of this lane's segment j of head g
  auto q_at = [&](int g, int j, int e) {
    return q_lane + ((g * (CPL / 4) + e / 4) * SP + j * 32) * 4;
  };

  // Online softmax over the tile in stage st, rows t0 .. t0 + R - 1.
  auto compute_tile = [&](int st, int t0) {
    const unsigned char* tk = ring + st * L::STAGE + lane * CPL;
    const float* tsc =
        reinterpret_cast<const float*>(ring + st * L::STAGE + 2 * L::CODES)
        + rsub;
    float ksr[RS], vsr[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      ksr[i] = tsc[i * RPI];
      vsr[i] = tsc[32 * RS + i * RPI];
    }
    // one row step's codes live at a time; q from registers or, 4 floats
    // at a time, from q_s
    float s[GB][RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      float kf[EPL];
#pragma unroll
      for (int j = 0; j < NSEG; ++j)
        seg_codes<CPL>(tk + (i * NSEG + j) * 32 * CPL, &kf[j * CPL]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; e += 4) {
          float qv[4];
          if constexpr (L::QREG) {
#pragma unroll
            for (int u = 0; u < 4; ++u) qv[u] = qr[g][e + u];
          } else {
            load_f32x4(q_at(g, e / CPL, e % CPL), qv);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) x += qv[u] * kf[e + u];
        }
        s[g][i] = x;
      }
    }
    // a row's lanes are LPR neighbours: xor below LPR stays inside the row
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o >= LPR) continue;               // the same for the whole warp
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int i = 0; i < RS; ++i)
          s[g][i] += __shfl_xor_sync(0xffffffffu, s[g][i], o);
    }
    bool valid[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) valid[i] = t0 + i * RPI + rsub < c1;
    float mx[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      mx[g] = NEG_INF;
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        s[g][i] *= ksr[i];                  // q . kq_t, times ks_t
        if (valid[i]) mx[g] = fmaxf(mx[g], s[g][i]);
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o < LPR) continue;                // the same for the whole warp
#pragma unroll
      for (int g = 0; g < GB; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    }
    bool raised = false;
#pragma unroll
    for (int g = 0; g < GB; ++g) raised |= mx[g] > m[g];
    if (raised) {                           // the same for the whole warp
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);
        const float corr = fast_exp2(m[g] - m_new);   // 1 where not raised
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const float pt = valid[i] ? fast_exp2(s[g][i] - m[g]) : 0.f;
        l[g] += pt;
        s[g][i] = pt * vsr[i];              // p_t times vs_t
      }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      if (t0 + i * RPI >= c1) break;        // the same for the whole warp
      float vf[EPL];
#pragma unroll
      for (int j = 0; j < NSEG; ++j)
        seg_codes<CPL>(tk + L::CODES + (i * NSEG + j) * 32 * CPL,
                       &vf[j * CPL]);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += s[g][i] * vf[e];
    }
  };

  // warp w takes tiles w, w + N_WARPS, ...; STAGES - 1 tiles ahead in flight
  const int n_tiles = (c1 - c0 + R - 1) / R;
  const int mine = n_tiles > warp ? (n_tiles - warp + N_WARPS - 1) / N_WARPS
                                  : 0;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < mine) load_tile(t);
    cp_async_commit();
  }
  // q, pre-scaled, while the first tiles are on their way
  {
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb
        + static_cast<int64_t>(kh) * G * p.q_sh;
    for (int i = tid; i < GB * (CPL / 4) * SP; i += THREADS) {
      const int g = i / ((CPL / 4) * SP);
      const int e4 = i / SP % (CPL / 4), seg = i % SP;
      const int d = seg * CPL + e4 * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < G && d < D) {
        const T* qd = qb + g * p.q_sh + d;
        x = make_float4(to_f32(qd[0]) * p.scale, to_f32(qd[1]) * p.scale,
                        to_f32(qd[2]) * p.scale, to_f32(qd[3]) * p.scale);
      }
      reinterpret_cast<float4*>(q_s)[i] = x;
    }
  }
  __syncthreads();
  if constexpr (L::QREG) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < EPL; e += 4)
        load_f32x4(q_at(g, e / CPL, e % CPL), &qr[g][e]);
  }
  for (int t = 0; t < mine; ++t) {
    __syncwarp();      // every lane is done reading the stage it refills
    if (t + STAGES - 1 < mine) load_tile((t + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();      // the scales other lanes copied are in
    compute_tile(t % STAGES, c0 + (warp + t * N_WARPS) * R);
  }
  cp_async_wait<0>();

  // the row groups of a warp hold the same heads and d: add them up
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < LPR) continue;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
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
          for (int e = 0; e < CPL; ++e)
            ws[g * D + seg_off[j] + e] = acc[g][j * CPL + e];
      if (lane == 0) {
        ws[G * D + g] = m[g];
        ws[G * D + G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the warps' states combined in warp order; one piece: out directly,
  // else the ticketed merge in piece order
  finish_piece<THREADS, MAX_SPLIT>(smem, p.warp_bytes, out, p.part,
                                   p.tickets, gridDim.y, H, p.n_kv, G, D, b,
                                   kh, split, pieces, p.n_split);
}

template <typename T, int GB, int CPL, int NSEG>
int launch(Params p, int B, cudaStream_t stream) {
  using L = Layout<GB, CPL, NSEG>;
  const int G = p.group, D = p.head_dim;
  const int ring = STAGES * L::STAGE;
  const int state = (G * D + 2 * G) * 4;
  const int merge = (G * MAX_SPLIT + G) * 4 / N_WARPS + 16;
  p.warp_bytes = (std::max({ring, state, merge}) + 15) / 16 * 16;
  const size_t smem = static_cast<size_t>(N_WARPS) * p.warp_bytes
      + static_cast<size_t>(GB) * CPL * 32 * NSEG * 4;
  auto kernel = flash_decode_int8_kernel<T, GB, CPL, NSEG>;
  // dynamic shared memory opted in so far: from the first launch on, as
  // the default 48 KB also holds the static 16 bytes of finish_piece
  static size_t allowed = 0;
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

// codes a lane holds a row by group size: its V sums, G x CPL x NSEG f32,
// stay at 64 registers (128 only at G = 16 with D > 128)
template <typename T>
int launch_t(const Params& p, int B, cudaStream_t s) {
  const int G = p.group;
  if (G <= 1) return launch<T, 1, 16, 1>(p, B, s);
  if (G <= 2) return launch<T, 2, 16, 1>(p, B, s);
  if (G <= 4) return launch<T, 4, 16, 1>(p, B, s);
  if (G <= 8) return launch<T, 8, 8, 1>(p, B, s);
  if (p.head_dim <= 128) return launch<T, 16, 4, 1>(p, B, s);
  return launch<T, 16, 4, 2>(p, B, s);
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success); -1 for arguments outside what
// the kernel takes.  strides: 14 element strides (int8 strides are byte
// strides): q batch, head; kq batch, token, kv head; vq the same; ks
// batch, token, kv head; vs the same.  The last dimension of q, kq, vq is
// contiguous, D a multiple of 16 and every K/V row 16-byte aligned.  out is
// a contiguous (B, H, D) buffer.  T is cut into n_split = ceil(T / piece)
// pieces; where n_split > 1, part is f32 scratch of B * H * n_split *
// (D + 2) and tickets B * K int32 zeros (left zero by every launch).
int flash_decode_int8_launch(int dtype, const void* q, const void* kq,
                             const void* vq, const void* ks, const void* vs,
                             const void* lengths, void* out, void* part,
                             void* tickets, int B, int T_len, int H, int K,
                             int D, int piece, int n_split,
                             const int64_t* strides, void* stream) {
  if (B < 1 || B > 65535 || T_len < 1 || K < 1 || K > 65535 || H % K != 0
      || H / K > MAX_G || D < 16 || D > MAX_D || D % 16 != 0 || piece < 1
      || n_split != (T_len + piece - 1) / piece || n_split > MAX_SPLIT
      || (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (reinterpret_cast<uintptr_t>(kq) % 16 != 0
      || reinterpret_cast<uintptr_t>(vq) % 16 != 0)
    return -1;
  for (int i = 2; i < 8; ++i)
    if (strides[i] % 16 != 0) return -1;
  Params p{};
  p.q = q;
  p.kq = static_cast<const int8_t*>(kq);
  p.vq = static_cast<const int8_t*>(vq);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
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
  p.ks_sb = strides[8];
  p.ks_st = strides[9];
  p.ks_sh = strides[10];
  p.vs_sb = strides[11];
  p.vs_st = strides[12];
  p.vs_sh = strides[13];
  p.scale = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(p, B, s);
  return launch_t<__nv_bfloat16>(p, B, s);
}

}  // extern "C"
