// wkv6: the RWKV6 (Finch) chunked recurrence, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (`wkv6`, body
// `_wkv_kernel`).  From a zero state, per head h, with per-channel decay
// w_t in (0, 1] and bonus u:
//   out_t   = r_t (state_{t-1} + diag(u) k_t^T v_t)
//   state_t = diag(w_t) state_{t-1} + k_t^T v_t
// in chunks of LC = 64 tokens.  Per chunk, with lw = log(max(w, 1e-30))
// (the Pallas kernel's floor), cw its inclusive prefix sum over the chunk
// and cx the exclusive one (cx_t = cw_{t-1}):
//   att[t][s] = sum_d r_t[d] k_s[d] exp(cx_t[d] - cw_s[d])   for s < t
//   y_t       = (r_t exp(cx_t)) . S_in + sum_s att[t][s] v_s
//               + (sum_d r_t[d] u[d] k_t[d]) v_t
//   S_out     = diag(exp(cw_last)) S_in + S_loc,
//   S_loc     = sum_s (k_s exp(cw_last - cw_s))^T v_s
// where S_in is the state entering the chunk.
//
// Bound on an H100: bytes.  r, k, v, w are read once and y written once
// (about 41 MB at S ~ 1000, H 32, hd 64, f32: 0.012 ms at 3.35 TB/s)
// against 5 hd^2 f32 operations per (token, head) of the one-step
// recurrence (0.66 GFLOP: 0.010 ms at 67 TFLOP/s).  Neither is near at
// the served prompts: what holds the kernel is parallelism and latency
// (one block per (head, batch) walking the chunks would be 32 blocks on
// 132 SMs whatever S) and the exponentials of the pairwise decay.  What
// the design does about it:
//   * chunks in parallel across blocks (the GPU chunked-linear-attention
//     decomposition), in one launch or three:
//       1. `wkv6_chunk` state blocks, one per (batch, head, chunk): S_loc,
//          exp(cw_last) and the chunk's cw into a workspace;
//       2. `wkv6_pass`, one thread per (batch, head, 4 state elements):
//          walks the chunks in order, S_in(c) = dec(c-1) S_in(c-1) +
//          S_loc(c-1), writing each chunk's S_in over its S_loc and the
//          last state to the output: serial in the chunks, parallel over
//          everything else;
//       3. `wkv6_chunk` output blocks, one per (batch, head, chunk, 16-row
//          tile of y), reading cw and S_in.
//     A one-chunk call (9 of the 16 served prompts) needs no S_in: one
//     launch holds its state blocks (writing the final state) and its
//     output blocks, 32 heads x (1 + up to 4) blocks;
//   * work sized to the valid rows: an output block of tile i reads rows
//     [0, 16 (i + 1)) of its chunk, so a 4-token prompt does one 16 x 16
//     tile, and tiles past S exit at once;
//   * overflow-safe sub-chunk factoring: with c_i = cw at the last row of
//     sub-chunk i - 1, for t in tile i and s in an earlier sub-chunk,
//     exp(cx_t - cw_s) = exp(cx_t - c_i) exp(c_i - cw_s), both exponents
//     <= 0 since cw does not increase.  Neither factor overflows, and one
//     underflows only where the exact product does.  The off-diagonal
//     16 x 16 blocks of att are plain products of the two scaled
//     operands; only the diagonal block keeps the exact pairwise
//     exponentials (120 pairs x hd, a quarter of the chunk's pairs or
//     fewer), taken before the exp.  The whole chunk is never factored:
//     at w = 1e-30 two tokens already pass e^88;
//   * every load of a block is issued into registers before any is stored
//     to shared memory, so they are in flight together: 16-byte loads where
//     every base and row stride is 16-byte aligned and hd % 4 == 0 (the
//     wrapper's `wide_path`), single elements otherwise;
//   * the products (S_loc, att's off-diagonal blocks, y) on the tensor
//     cores as 3xTF32 (mma.sync m16n8k8, each operand split into TF32 high
//     and low parts: about f32 accuracy; plain TF32 keeps about three
//     decimal digits, short of the rtol 1e-3 the JAX package holds wkv6
//     to), the decays in f32 on the CUDA cores.
// Each block handles one chunk, so nothing crosses chunks inside a block
// and no copy ring is needed.  Sums take fixed orders and no float atomics
// are used: two runs are bit-identical.  The ragged tail masks by index:
// rows past S read as r = k = v = 0 and w = 1 (lw = 0), which is what the
// Pallas kernel's padding computes, and nothing is padded in device
// memory.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/wkv6.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using scan::THREADS;
using scan::TILE;

constexpr int LC = 64;          // chunk length (the Pallas DEFAULT_CHUNK)
constexpr int NT = LC / TILE;   // tiles (sub-chunks) per chunk
constexpr int MAX_HD = 64;      // head_dim limit
constexpr int LD = 68;          // [t][d] rows read as mma fragments (4 mod 32)
constexpr int LDX = 72;         // [k][n] rows read as mma fragments (8 mod 32)
constexpr int LDT = 24;         // rows of att^T, [s][t] (24 mod 32)
constexpr int N_PAIRS = TILE * (TILE - 1) / 2;  // s < t in a 16 x 16 block
constexpr int KMAX = LC + MAX_HD;               // rows of the y product
static_assert(2 * N_PAIRS <= THREADS, "two threads per diagonal pair");
static_assert(MAX_HD == 8 * THREADS / 32, "a warp per 8 columns of y");

// state block shared memory, in floats
constexpr int SB_K = 0;                        // k, then k decayed [LC][LDX]
constexpr int SB_CW = SB_K + LC * LDX;         // lw, then cw [LC][LDX]
constexpr int SB_V = SB_CW + LC * LDX;         // v [LC][LDX]
constexpr int SB_TOT = SB_V + LC * LDX;        // scan totals [THREADS]
constexpr int SB_FLOATS = SB_TOT + THREADS;

// output block shared memory, in floats: 3 blocks an SM
constexpr int YB_K = 0;                        // k; rows < t0 scaled [LC][LD]
constexpr int YB_CW = YB_K + LC * LD;          // lw, then cw [LC][LD]
constexpr int YB_SIN = YB_K;                   // then S_in [MAX_HD][LDX]
constexpr int YB_R = YB_CW + LC * LD;          // r of the tile [TILE][LD]
constexpr int YB_RQ = YB_R + TILE * LD;        // r exp(cx - c_i) [TILE][LD]
constexpr int YB_AT = YB_RQ + TILE * LD;       // [KMAX][LDT]
constexpr int YB_TOT = YB_AT;                  // scan totals, before AT
constexpr int YB_V = YB_AT + KMAX * LDT;       // v [LC][LDX]
constexpr int YB_U = YB_V + LC * LDX;          // u [MAX_HD]
constexpr int YB_BO = YB_U + MAX_HD;           // bonus [TILE]
constexpr int YB_FLOATS = YB_BO + TILE;
static_assert(MAX_HD * LDX <= 2 * LC * LD, "S_in fits where k and cw were");
static_assert(KMAX * LDT >= THREADS, "the scan totals fit in AT");
static_assert(YB_FLOATS * sizeof(float) <= (233472 - 3 * 1024) / 3,
              "three output blocks an SM");

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  float* y;
  float* fin;
  float* st;    // per-chunk S_loc, then S_in: (B, H, nc, hd, hd)
  float* dec;   // per-chunk exp(cw_last): (B, H, nc, hd)
  float* cwb;   // per-chunk cw: (B, H, nc, LC, hd)
  int S, H, hd;
  int nc;       // chunks
  int nt;       // y tiles per chunk, min(NT, ceil(S / TILE))
  int wide;     // 16-byte loads of r, k, v, w
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// In place, inclusive prefix sum down rows [0, rows) of the MAX_HD
// columns of a[t * ld + col], by the whole block: thread (segment, column)
// sums its segment of rows, then adds the earlier segments' totals, taken
// in order (so the sums are fixed, and a column whose entries are <= 0
// does not increase).  Starts and ends with a block barrier.
__device__ void scan_rows(float* a, int ld, int rows, float* tot) {
  __syncthreads();
  constexpr int NSEG = THREADS / MAX_HD;
  const int ch = threadIdx.x % MAX_HD, seg = threadIdx.x / MAX_HD;
  const int len = (rows + NSEG - 1) / NSEG;
  const int r0 = seg * len, r1 = min(rows, r0 + len);
  float run = 0.f;
  for (int t = r0; t < r1; ++t) {
    run += a[t * ld + ch];
    a[t * ld + ch] = run;
  }
  tot[seg * MAX_HD + ch] = run;
  __syncthreads();
  float off = 0.f;
  for (int s = 0; s < seg; ++s) off += tot[s * MAX_HD + ch];
  for (int t = r0; t < r1; ++t) a[t * ld + ch] = off + a[t * ld + ch];
  __syncthreads();
}

// S_loc of chunk c (the whole (hd, hd) state) and exp(cw_last).  A
// one-chunk call writes its S_loc as the final state.
__device__ void state_block(const Args& a, int blk, float* smem) {
  const int c = blk % a.nc;
  blk /= a.nc;
  const int h = blk % a.H, b = blk / a.H;
  const int tid = threadIdx.x;
  const int c0 = c * LC, n = min(LC, a.S - c0);
  const int hd = a.hd;
  const int64_t rs = static_cast<int64_t>(a.H) * hd;
  const int64_t base = (static_cast<int64_t>(b) * a.S + c0) * rs
      + static_cast<int64_t>(h) * hd;
  float* kd = smem + SB_K;
  float* cw = smem + SB_CW;
  float* vs = smem + SB_V;
  constexpr int IT = LC * MAX_HD / 4 / THREADS;
  {
    float4 rk[IT], rw[IT], rv[IT];
    scan::fetch(rk, a.k + base, rs, n, n, MAX_HD, hd, a.wide);
    scan::fetch<IT, true>(rw, a.w + base, rs, n, n, MAX_HD, hd, a.wide);
    scan::fetch(rv, a.v + base, rs, n, n, MAX_HD, hd, a.wide);
    scan::put<false>(rk, kd, LDX, n, MAX_HD);
    scan::put<false>(rw, cw, LDX, n, MAX_HD);
    scan::put<false>(rv, vs, LDX, n, MAX_HD);
  }
  scan_rows(cw, LDX, n, smem + SB_TOT);
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  if (a.nc > 1) {  // cw for the output blocks
    float* dst = a.cwb + (bh * a.nc + c) * LC * hd;
    for (int e = tid * 4; e < n * MAX_HD; e += THREADS * 4) {
      const int s = e / MAX_HD, d = e - s * MAX_HD;
      if (d < hd)
        scan::store4(dst + s * hd, d, hd,
                     *reinterpret_cast<const float4*>(cw + s * LDX + d),
                     hd % 4 == 0);
    }
  }
  const float* last = cw + (n - 1) * LDX;
  for (int i = tid; i < n * MAX_HD; i += THREADS) {
    const int s = i / MAX_HD, d = i - s * MAX_HD;
    kd[s * LDX + d] *= __expf(last[d] - cw[s * LDX + d]);  // exponent <= 0
  }
  __syncthreads();

  // S_loc[d][e] = sum_s kd[s][d] v[s][e]: warp w takes rows d of
  // 16 (w % 4) and columns e of 32 (w / 4)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4] = {};
  scan::mma_rows<4>(kd, LDX, m0, vs, LDX, n0, n, acc);
  const int64_t hd2 = static_cast<int64_t>(hd) * hd;
  float* out = a.nc == 1 ? a.fin + bh * hd2 : a.st + (bh * a.nc + c) * hd2;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = m0 + g + 8 * (r >> 1), e = n0 + 8 * j + 2 * qd + (r & 1);
      if (d < hd && e < hd) out[d * hd + e] = acc[j][r];
    }
  if (a.nc > 1 && tid < hd)
    a.dec[(bh * a.nc + c) * hd + tid] = expf(last[tid]);
}

// The pair (tb, sa), sa < tb < TILE, numbered p = tb (tb - 1) / 2 + sa.
__device__ __forceinline__ void pair_of(int p, int& tb, int& sa) {
  tb = 1;
  while ((tb + 1) * tb / 2 <= p) ++tb;
  sa = p - tb * (tb - 1) / 2;
}

// y rows [t0, t0 + 16) of chunk c, t0 = 16 i, as one product
//   y = [att | r exp(cx)] . [v ; S_in]
// over the chunk's rows s < rv and (past the first chunk) the state's
// rows d < hd; the bonus sits on att's diagonal.
__device__ void y_block(const Args& a, int blk, float* smem) {
  const int i = blk % a.nt;
  blk /= a.nt;
  const int c = blk % a.nc;
  blk /= a.nc;
  const int h = blk % a.H, b = blk / a.H;
  const int tid = threadIdx.x;
  const int c0 = c * LC, n = min(LC, a.S - c0);
  const int t0 = i * TILE;
  if (t0 >= n) return;  // a tile past S (the last chunk): uniform exit
  const int rt = t0 + TILE;         // rows read and scanned
  const int rv = min(rt, n);        // of which valid
  const int hd = a.hd;
  const int64_t rs = static_cast<int64_t>(a.H) * hd;
  const int64_t base = (static_cast<int64_t>(b) * a.S + c0) * rs
      + static_cast<int64_t>(h) * hd;
  const int64_t bh = static_cast<int64_t>(b) * a.H + h;
  float* ks = smem + YB_K;
  float* cw = smem + YB_CW;
  float* rr = smem + YB_R;
  float* rq = smem + YB_RQ;
  float* at = smem + YB_AT;   // [k][t]: att^T for k < rv, then (r exp(cx))^T
  float* vs = smem + YB_V;
  float* bo = smem + YB_BO;

  constexpr int IT = LC * MAX_HD / 4 / THREADS;
  float4 rs_[IT];   // S_in, held until k and cw are spent
  {  // every load of the block in flight together
    float4 rk[IT], rw[IT], rv_[IT], rr_[1];
    scan::fetch(rk, a.k + base, rs, rt, rv, MAX_HD, hd, a.wide);
    if (a.nc > 1)  // cw from the state blocks
      scan::fetch(rw, a.cwb + (bh * a.nc + c) * LC * hd, hd, rt, rv, MAX_HD,
                  hd, hd % 4 == 0);
    else
      scan::fetch<IT, true>(rw, a.w + base, rs, rt, rv, MAX_HD, hd, a.wide);
    scan::fetch(rv_, a.v + base, rs, rv, rv, MAX_HD, hd, a.wide);
    scan::fetch(rr_, a.r + base + t0 * rs, rs, TILE, rv - t0, MAX_HD, hd,
                a.wide);
    if (c > 0)
      scan::fetch(rs_, a.st + (bh * a.nc + c) * hd * hd, hd, hd, hd, MAX_HD,
                  hd, hd % 4 == 0);
    const float uv = tid < hd ? a.u[static_cast<int64_t>(h) * hd + tid]
                              : 0.f;
    scan::put<false>(rk, ks, LD, rt, MAX_HD);
    scan::put<false>(rw, cw, LD, rt, MAX_HD);
    scan::put<false>(rv_, vs, LDX, rv, MAX_HD);
    scan::put<false>(rr_, rr, LD, TILE, MAX_HD);
    if (tid < MAX_HD) smem[YB_U + tid] = uv;
  }
  if (a.nc == 1)
    scan_rows(cw, LD, rt, smem + YB_TOT);
  else
    __syncthreads();

  // c_i = cw at row t0 - 1; every exponent below is <= 0
  for (int e = tid; e < TILE * MAX_HD; e += THREADS) {
    const int tl = e / MAX_HD, d = e - tl * MAX_HD;
    const int t = t0 + tl;
    const float cx = t > 0 ? cw[(t - 1) * LD + d] : 0.f;
    if (i > 0) rq[tl * LD + d] = rr[tl * LD + d]
        * __expf(cx - cw[(t0 - 1) * LD + d]);
    if (c > 0 && d < hd) at[(rv + d) * LDT + tl] = rr[tl * LD + d]
        * __expf(cx);
  }
  for (int e = tid; e < t0 * MAX_HD; e += THREADS) {  // k exp(c_i - cw)
    const int s = e / MAX_HD, d = e - s * MAX_HD;
    ks[s * LD + d] *= __expf(cw[(t0 - 1) * LD + d] - cw[s * LD + d]);
  }
  {  // the bonus: sum_d r_t u k_t, two rows a warp
    const int lane = tid & 31, warp = tid >> 5;
    for (int tl = warp; tl < TILE; tl += THREADS / 32) {
      float part = 0.f;
      for (int d = lane; d < MAX_HD; d += 32)
        part += rr[tl * LD + d] * smem[YB_U + d] * ks[(t0 + tl) * LD + d];
      part = warp_sum(part);
      if (lane == 0) bo[tl] = part;
    }
  }
  {  // the diagonal block from the exact pairwise exponentials
    const int p = tid >> 1, half = tid & 1;
    int tb = 0, sa = 0;
    float part = 0.f;
    if (p < N_PAIRS) {
      pair_of(p, tb, sa);
      const float* rt_ = rr + tb * LD;
      const float* kt = ks + (t0 + sa) * LD;
      const float* cxt = cw + (t0 + tb - 1) * LD;
      const float* cws = cw + (t0 + sa) * LD;
      for (int d = half; d < MAX_HD; d += 2)
        part += rt_[d] * kt[d] * __expf(cxt[d] - cws[d]);  // exponent <= 0
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (p < N_PAIRS && half == 0 && t0 + sa < rv)
      at[(t0 + sa) * LDT + tb] = part;
  }
  __syncthreads();

  {  // off-diagonal sub-blocks: att[t][s] = rq_t . kk_s for s < t0, warp w
     // taking s in [8 w, 8 w + 8); the rest of the diagonal block: the
     // bonus on it, zero above it
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
    if (warp < 2 * i) {
      float acc[1][4] = {};
      scan::mma_rows<1, false, true>(rq, LD, 0, ks, LD, 8 * warp, MAX_HD, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        at[(8 * warp + 2 * qd + (r & 1)) * LDT + g + 8 * (r >> 1)] = acc[0][r];
    }
    const int tl = tid >> 4, sx = tid & 15;
    if (sx >= tl && t0 + sx < rv)
      at[(t0 + sx) * LDT + tl] = sx == tl ? bo[tl] : 0.f;
  }
  __syncthreads();

  float* sin = smem + YB_SIN;
  if (c > 0) {
    scan::put<false>(rs_, sin, LDX, hd, MAX_HD);
    __syncthreads();
  }

  // y tile: warp w takes columns e in [8 w, 8 w + 8)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  float acc[1][4] = {};
  scan::mma_rows<1>(at, LDT, 0, vs, LDX, 8 * warp, rv, acc);
  if (c > 0)
    scan::mma_rows<1>(at + rv * LDT, LDT, 0, sin, LDX, 8 * warp, hd, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + g + 8 * (r >> 1), e = 8 * warp + 2 * qd + (r & 1);
    if (t < n && e < hd) a.y[base + t * rs + e] = acc[0][r];
  }
}

// Blocks [0, n_state) are state blocks (if STATE), the rest output blocks
// (if OUT).
template <bool STATE, bool OUT>
__global__ void __launch_bounds__(THREADS, OUT && !STATE ? 3 : 1)
wkv6_chunk(Args a, int n_state) {
  extern __shared__ __align__(16) float smem[];
  const int blk = blockIdx.x;
  if (STATE && blk < n_state)
    state_block(a, blk, smem);
  else if (OUT)
    y_block(a, blk - (STATE ? n_state : 0), smem);
}

// One thread per (batch, head, VEC state elements of one row d): S_in of
// every chunk over its S_loc, in chunk order, and the state after the last
// chunk to fin.
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 8;   // chunks whose loads are issued together

template <int VEC>
__global__ void __launch_bounds__(PASS_THREADS)
wkv6_pass(float* __restrict__ st, const float* __restrict__ dec,
          float* __restrict__ fin, int64_t n_elem, int nc, int hd) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * PASS_THREADS
                     + threadIdx.x) * VEC;
  if (i >= n_elem) return;
  const int64_t hd2 = static_cast<int64_t>(hd) * hd;
  const int64_t bh = i / hd2;
  const int e = static_cast<int>(i - bh * hd2);
  float* p = st + bh * nc * hd2 + e;
  const float* q = dec + bh * nc * hd + e / hd;
  float run[VEC] = {};
  for (int c = 0; c < nc; c += PASS_BATCH) {
    float loc[PASS_BATCH][VEC], dk[PASS_BATCH];
#pragma unroll
    for (int j = 0; j < PASS_BATCH; ++j)
      if (c + j < nc) {
        const float* src = p + (c + j) * hd2;
        if constexpr (VEC == 4) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          loc[j][0] = f.x;
          loc[j][1] = f.y;
          loc[j][2] = f.z;
          loc[j][3] = f.w;
        } else {
          loc[j][0] = src[0];
        }
        dk[j] = q[(c + j) * hd];
      }
#pragma unroll
    for (int j = 0; j < PASS_BATCH; ++j)
      if (c + j < nc) {
        float* dst = p + (c + j) * hd2;
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(run[0], run[1], run[2], run[3]);
        else
          dst[0] = run[0];
#pragma unroll
        for (int v = 0; v < VEC; ++v) run[v] = dk[j] * run[v] + loc[j][v];
      }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) fin[i + v] = run[v];
}

template <bool STATE, bool OUT>
cudaError_t launch_chunk(const Args& a, int64_t n_state, int64_t n_y,
                         cudaStream_t s) {
  const int bytes = (OUT ? YB_FLOATS : SB_FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk<STATE, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  wkv6_chunk<STATE, OUT><<<static_cast<unsigned>((STATE ? n_state : 0)
                                                 + (OUT ? n_y : 0)),
                           THREADS, bytes, s>>>(a,
                                                static_cast<int>(n_state));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace a call needs: per-chunk states and decays when the
// call has more than one chunk, else none.
int64_t wkv6_workspace(int B, int S, int H, int hd) {
  const int64_t nc = (S + LC - 1) / LC;
  return nc > 1 ? static_cast<int64_t>(B) * H * nc * (hd * hd + hd + LC * hd)
                : 0;
}

// r, k, v, w and y are contiguous (B, S, H, hd) buffers, u a contiguous
// (H, hd) one, fin a contiguous (B, H, hd, hd) one, ws a 16-byte aligned
// buffer of ws_floats >= wkv6_workspace(...) floats.  `wide` asks for
// 16-byte loads; it is honoured only where hd % 4 == 0 and r, k, v, w are
// 16-byte aligned.  Returns the cudaError_t of the attribute calls and the
// launches (0 on success); -1 for arguments outside what the kernel takes.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, void* fin, void* ws,
                int64_t ws_floats, int B, int S, int H, int hd, int wide,
                void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > MAX_HD) return -1;
  const int nc = (S + LC - 1) / LC;
  const int nt = min(NT, (S + TILE - 1) / TILE);
  const int64_t n_state = static_cast<int64_t>(B) * H * nc;
  const int64_t n_y = n_state * nt;
  if (n_state + n_y > 0x7fffffff || ws_floats < wkv6_workspace(B, S, H, hd)
      || (nc > 1 && (ws == nullptr || !scan::aligned16(ws))))
    return -1;
  const bool wide_ok = hd % 4 == 0 && scan::aligned16(r)
      && scan::aligned16(k) && scan::aligned16(v) && scan::aligned16(w);
  float* wsf = static_cast<float*>(ws);
  const int64_t n_st = nc > 1 ? n_state * hd * hd : 0;
  Args a{static_cast<const float*>(r), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(w),
         static_cast<const float*>(u), static_cast<float*>(y),
         static_cast<float*>(fin), wsf, wsf ? wsf + n_st : nullptr,
         wsf ? wsf + n_st + n_state * hd : nullptr, S, H, hd, nc, nt,
         wide && wide_ok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 1)  // no S_in: state and output blocks in one launch
    return static_cast<int>(launch_chunk<true, true>(a, n_state, n_y, s));
  cudaError_t err = launch_chunk<true, false>(a, n_state, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_elem = static_cast<int64_t>(B) * H * hd * hd;
  const int vec = hd % 4 == 0 ? 4 : 1;   // float4 rows where they align
  const unsigned grid = static_cast<unsigned>(
      (n_elem / vec + PASS_THREADS - 1) / PASS_THREADS);
  if (vec == 4)
    wkv6_pass<4><<<grid, PASS_THREADS, 0, s>>>(
        wsf, a.dec, static_cast<float*>(fin), n_elem, nc, hd);
  else
    wkv6_pass<1><<<grid, PASS_THREADS, 0, s>>>(
        wsf, a.dec, static_cast<float*>(fin), n_elem, nc, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_chunk<false, true>(a, 0, n_y, s));
}

}  // extern "C"
