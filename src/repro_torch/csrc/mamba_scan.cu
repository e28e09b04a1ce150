// mamba_scan: the Mamba2 chunked SSD scan, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (`mamba_scan`, body `_mamba_kernel`).  From a zero state, per head h:
//   state_t = exp(lA_t) state_{t-1} + xt_t (x) B_t,   y_t = state_t . C_t,
// in chunks of LC = 128 tokens.  Per chunk, with cs the inclusive prefix
// sum of lA over the chunk and S_in the state entering it:
//   att[q][t] = (C_q . B_t) exp(cs_q - cs_t)      for t <= q, else 0
//   y_q       = sum_t att[q][t] xt_t + exp(cs_q) C_q . S_in
//   S_out     = exp(cs_last) S_in + S_loc,
//   S_loc     = sum_t exp(cs_last - cs_t) xt_t (x) B_t
// The exponent is masked before exp: above the diagonal cs_q - cs_t is
// positive and would overflow.
//
// Bound on an H100: operations, at the serve path's shapes (S ~ 1000,
// nh 80, hd = ds = 64): the one-step recurrence needs about 5 hd ds f32
// operations per (token, head), 1.6 GFLOP (0.025 ms at 67 TFLOP/s),
// against about 42 MB of inputs and outputs (0.013 ms).  At the served
// prompts, 12 of 16 of them one chunk, parallelism and latency hold it
// more than either: one block per (head, batch) walking the chunks would
// be 80 blocks on 132 SMs whatever S.  What the design does about it:
//   * chunks in parallel across blocks (the GPU SSD decomposition the
//     Pallas kernel adapted), in two or three launches:
//       1. `mamba_prep`: CB blocks, one per (batch, chunk, 16-row tile of
//          q), write B . C^T of the chunk to a workspace once for every
//          head (zamba2's B and C are one group shared by its 80 heads);
//          state blocks, one per (batch, head, chunk), write S_loc and
//          exp(cs_last), or, for a one-chunk call, the final state;
//       2. `mamba_pass` (past one chunk), one thread per (batch, head,
//          4 state elements): walks the chunks in order, S_in(c) =
//          dec(c-1) S_in(c-1) + S_loc(c-1), writing each chunk's S_in over
//          its S_loc and the last state to the output: serial in the
//          chunks, parallel over everything else;
//       3. `mamba_out`: output blocks, 16 rows of y a block for a
//          one-chunk call (many small blocks: 80 heads x up to 8 tiles)
//          and 64 rows past one chunk (x, B . C^T and S_in read once for
//          64 rows): y = att . x + diag(exp(cs)) (C . S_in^T), every
//          operand stored in shared memory as it lies in device memory
//          (a transposing store costs more than the product it feeds);
//   * work sized to the valid rows: a block of rows [q0, q0 + R) reads and
//     multiplies columns t < min(q0 + R, n) of att only (each warp only
//     up to its own last row), so a 4-token prompt computes one 16 x 16
//     tile, and tiles past S exit at once;
//   * the decay factored at 16-row group boundaries: for q in group g and
//     t in an earlier group, with c_g = cs at the row before g,
//     exp(cs_q - cs_t) = exp(cs_q - c_g) exp(c_g - cs_t), both exponents
//     <= 0 (cs does not increase), so neither factor overflows; the two
//     factors scale the product's columns (as its A fragments load) and
//     its output rows, and only the diagonal 16 x 16 blocks of att take
//     exact exponentials (masked before the exp).  exp(cs_q) of the
//     inter-chunk term scales output rows too, so no pass over att or C
//     is needed for it;
//   * every load of a block is issued into registers before any is stored
//     to shared memory, so they are in flight together: 16-byte loads of
//     xt, B and C where every base and stride is a multiple of 16 bytes
//     and hd, ds % 4 == 0 (the wrapper's `wide_path`: the model's B and C
//     are strided views of one projection), single elements otherwise;
//   * the products on the tensor cores as 3xTF32 (mma.sync m16n8k8, each
//     operand split into TF32 high and low parts: about f32 accuracy,
//     which plain TF32 would not give), the decays and masks in f32 on the
//     CUDA cores.
// Each block handles one chunk, so no copy ring is needed.  Sums take
// fixed orders and no float atomics are used: two runs are bit-identical.
// The ragged tail masks by index: rows past S load as zero (lA as 0),
// which is what the Pallas kernel's zero padding computes, and nothing is
// padded in device memory.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/mamba_scan.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using scan::THREADS;
using scan::TILE;

constexpr int LC = 128;         // chunk length (the Pallas DEFAULT_CHUNK)
constexpr int NT = LC / TILE;   // tiles per chunk
constexpr int MAX_HD = 64;      // head_dim limit
constexpr int MAX_DS = 64;      // state size limit
constexpr int LDS = MAX_DS + 1;   // padded rows of B and C in a CB block
constexpr int LDX = 72;           // [k][n] rows of mma operands (8 mod 32)
constexpr int LDR = 68;           // [n][k] rows of mma operands (4 mod 32)
constexpr int KMAX = LC + MAX_DS; // rows of the y product

// CB block shared memory, in floats
constexpr int CB_C = 0;                         // C of the tile [TILE][LDS]
constexpr int CB_B = CB_C + TILE * LDS;         // B [LC][LDS]
constexpr int CB_FLOATS = CB_B + LC * LDS;
// state block
constexpr int SB_X = 0;                         // x [LC][LDX]
constexpr int SB_B = SB_X + LC * LDX;           // B [LC][LDX]
constexpr int SB_CS = SB_B + LC * LDX;          // cs [LC]
constexpr int SB_FLOATS = SB_CS + LC;
// output block of ROWS rows: AT [KMAX][lda(ROWS)], BK [KMAX][LDX], cs
// [LC], the column factors [ROWS / TILE][LC] and the row factors [ROWS]
__host__ __device__ constexpr int lda(int rows) {
  return rows == TILE ? 24 : LDX;   // 24 or 8 mod 32
}
__host__ __device__ constexpr int yb_floats(int rows) {
  return KMAX * lda(rows) + KMAX * LDX + LC + rows / TILE * LC + rows;
}
static_assert(MAX_DS * 24 >= TILE * LDR && MAX_DS * LDX >= MAX_HD * LDR,
              "C and S_in fit in the rows after att and x");
static_assert(yb_floats(64) * sizeof(float) <= 232448 / 2 - 1024,
              "two 64-row output blocks an SM");

struct Args {
  const float* xt;
  const float* bm;
  const float* cm;
  const float* la;
  float* y;
  float* fin;
  float* cbt;   // B . C^T per (batch, chunk), [t][q]: (B, nc, LC, LC)
  float* st;    // per-chunk S_loc, then S_in: (B, nh, nc, hd, ds)
  float* dec;   // per-chunk exp(cs_last): (B, nh, nc)
  int S, nh, hd, ds;
  int nc;       // chunks
  int nt;       // tiles per chunk, min(NT, ceil(S / TILE))
  int wide;     // 16-byte loads of xt, Bm, Cm
  int64_t x_sb, x_st, x_sh, b_sb, b_st, c_sb, c_st, a_sb, a_st, a_sh;
};

// Warp 0: cs[t] = inclusive prefix sum of lA over rows [0, n) of the
// chunk (4 rows a lane, then a shuffle scan), rows past n adding 0.
__device__ __forceinline__ void scan_la(float* cs, const float* ab,
                                        int64_t a_st, int n) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  float part[LC / 32];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < LC / 32; ++j) {
    const int t = tid * (LC / 32) + j;
    sum += t < n ? ab[t * a_st] : 0.f;
    part[j] = sum;
  }
  float incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (tid >= o) incl += up;
  }
#pragma unroll
  for (int j = 0; j < LC / 32; ++j)
    cs[tid * (LC / 32) + j] = incl - sum + part[j];
}

// CBT[t][q] = C_q . B_t for q in tile i, t < 16 (i + 1): once per (batch,
// chunk), for every head.
__device__ void cb_block(const Args& a, int blk, float* smem) {
  const int i = blk % a.nt;
  blk /= a.nt;
  const int c = blk % a.nc, b = blk / a.nc;
  const int c0 = c * LC, n = min(LC, a.S - c0);
  const int t0 = i * TILE;
  if (t0 >= n) return;
  const int rt = t0 + TILE, rv = min(rt, n);
  float* cs_ = smem + CB_C;
  float* bs = smem + CB_B;
  {
    float4 rc[1], rb[LC * MAX_DS / 4 / THREADS];
    scan::fetch(rc, a.cm + b * a.c_sb + (c0 + t0) * a.c_st, a.c_st, TILE,
                rv - t0, MAX_DS, a.ds, a.wide);
    scan::fetch(rb, a.bm + b * a.b_sb + c0 * a.b_st, a.b_st, rt, rv, MAX_DS,
                a.ds, a.wide);
    scan::put<false>(rc, cs_, LDS, TILE, MAX_DS);
    scan::put<false>(rb, bs, LDS, rt, MAX_DS);
  }
  __syncthreads();
  const int tq = threadIdx.x & 15, tt = threadIdx.x >> 4;
  float acc[NT];
#pragma unroll
  for (int m = 0; m < NT; ++m) acc[m] = 0.f;
  for (int s = 0; s < a.ds; ++s) {
    const float cv = cs_[tq * LDS + s];
#pragma unroll
    for (int m = 0; m < NT; ++m)
      if (m <= i) acc[m] += cv * bs[(tt + 16 * m) * LDS + s];
  }
  float* out = a.cbt + (static_cast<int64_t>(b) * a.nc + c) * LC * LC + t0
      + tq;
#pragma unroll
  for (int m = 0; m < NT; ++m)
    if (m <= i) out[(tt + 16 * m) * LC] = acc[m];
}

// S_loc[p][s] = sum_t exp(cs_last - cs_t) x_t[p] B_t[s] of chunk c, and
// exp(cs_last), [p][s] like the final state, which a one-chunk call
// writes directly.
__device__ void state_block(const Args& a, int blk, float* smem) {
  const int c = blk % a.nc;
  blk /= a.nc;
  const int h = blk % a.nh, b = blk / a.nh;
  const int c0 = c * LC, n = min(LC, a.S - c0);
  const int tid = threadIdx.x;
  const int hd = a.hd, ds = a.ds;
  float* xs = smem + SB_X;
  float* bs = smem + SB_B;
  float* cs = smem + SB_CS;
  {
    constexpr int IT = LC * MAX_HD / 4 / THREADS;
    float4 rx[IT], rb[IT];
    scan::fetch(rx, a.xt + b * a.x_sb + c0 * a.x_st + h * a.x_sh, a.x_st, n,
                n, MAX_HD, hd, a.wide);
    scan::fetch(rb, a.bm + b * a.b_sb + c0 * a.b_st, a.b_st, n, n, MAX_DS,
                ds, a.wide);
    scan_la(cs, a.la + b * a.a_sb + c0 * a.a_st + h * a.a_sh, a.a_st, n);
    scan::put<false>(rx, xs, LDX, n, MAX_HD);
    scan::put<false>(rb, bs, LDX, n, MAX_DS);
  }
  __syncthreads();
  const float cl = cs[n - 1];
  __syncthreads();  // every thread has read cs[n - 1]
  for (int t = tid; t < n; t += THREADS) cs[t] = __expf(cl - cs[t]);
  __syncthreads();

  // S_loc[p][s]: warp w takes rows p of 16 (w % 4) and columns s of
  // 32 (w / 4)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float d[4][4] = {};
  scan::mma_rows<4>(xs, LDX, m0, bs, LDX, n0, n, d, cs);  // x_t exp(cl - cs_t)
  const int64_t bh = static_cast<int64_t>(b) * a.nh + h;
  const int64_t n_el = static_cast<int64_t>(hd) * ds;
  float* out = a.nc == 1 ? a.fin + bh * n_el : a.st + (bh * a.nc + c) * n_el;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = m0 + g + 8 * (r >> 1), s = n0 + 8 * j + 2 * qd + (r & 1);
      if (p < hd && s < ds) out[p * ds + s] = d[j][r];
    }
  if (a.nc > 1 && tid == 0) a.dec[bh * a.nc + c] = expf(cl);
}

// y rows [q0, q0 + ROWS) of chunk c for head h:
//   y = att . x + diag(exp(cs)) (C . S_in^T)
// over the chunk's rows t < ka (those at or below the tile's last row)
// and, past the first chunk, the state's rows s < ds.  ROWS = 16 (a
// one-chunk call: many small blocks, warp w takes columns p of 8 w) or
// 64 (longer calls: each block reads x, C . B^T and S_in once for 64
// rows; warp w takes rows q of 16 (w % 4) and columns p of 32 (w / 4)).
template <int ROWS>
__device__ void y_block(const Args& a, int blk, float* smem) {
  constexpr int LDA = lda(ROWS);
  constexpr int NJ = ROWS == TILE ? 1 : 4;   // 8-column mma tiles a warp
  const int NR = ROWS == TILE ? a.nt : LC / ROWS;   // tiles per chunk
  const int i = blk % NR;
  blk /= NR;
  const int c = blk % a.nc;
  blk /= a.nc;
  const int h = blk % a.nh, b = blk / a.nh;
  const int c0 = c * LC, n = min(LC, a.S - c0);
  const int q0 = i * ROWS;
  if (q0 >= n) return;
  const int ka = min(q0 + ROWS, n);   // att columns t <= q, valid
  const int tid = threadIdx.x;
  const int hd = a.hd, ds = a.ds;
  const int64_t bh = static_cast<int64_t>(b) * a.nh + h;
  float* at = smem;                   // [t][q]: CB^T, then C as [q][s]
  float* bk = at + KMAX * LDA;        // [t][p]: x, then S_in as [p][s]
  float* cs = bk + KMAX * LDX;
  float* vf = cs + LC;                // [group][t]: exp(c_g - cs_t)
  float* uf = vf + ROWS / TILE * LC;  // [q]: exp(cs_q - c_g)

  {  // every load of the block in flight together
    float4 rx[LC * MAX_HD / 4 / THREADS], rs[MAX_DS * MAX_HD / 4 / THREADS];
    float4 rcb[LC * ROWS / 4 / THREADS], rc[ROWS * MAX_DS / 4 / THREADS];
    scan::fetch(rx, a.xt + b * a.x_sb + c0 * a.x_st + h * a.x_sh, a.x_st,
                ka, ka, MAX_HD, hd, a.wide);
    scan::fetch(rcb, a.cbt + (static_cast<int64_t>(b) * a.nc + c) * LC * LC
                + q0, LC, ka, ka, ROWS, ROWS, true);
    if (c > 0) {
      scan::fetch(rs, a.st + (bh * a.nc + c) * hd * ds, ds, hd, hd, MAX_DS,
                  ds, ds % 4 == 0);
      scan::fetch(rc, a.cm + b * a.c_sb + (c0 + q0) * a.c_st, a.c_st, ROWS,
                  ka - q0, MAX_DS, ds, a.wide);
    }
    scan_la(cs, a.la + b * a.a_sb + c0 * a.a_st + h * a.a_sh, a.a_st, ka);
    scan::put<false>(rx, bk, LDX, ka, MAX_HD);
    scan::put<false>(rcb, at, LDA, ka, ROWS);
    if (c > 0) {
      scan::put<false>(rs, bk + ka * LDX, LDR, hd, MAX_DS);  // [p][s]
      scan::put<false>(rc, at + ka * LDA, LDR, ROWS, MAX_DS);  // [q][s]
    }
  }
  __syncthreads();
  // att[q][t] = CB exp(cs_q - cs_t), t <= q.  For q in 16-row group g
  // and t in an earlier group, with c_g = cs at the row before g:
  // exp(cs_q - cs_t) = exp(cs_q - c_g) exp(c_g - cs_t), both exponents
  // <= 0 (cs does not increase), so neither factor overflows; the
  // factors scale the product's columns and rows instead of att.  Only
  // the diagonal 16 x 16 blocks take exact exponentials, masked first.
  const int g0 = q0 / TILE;
  for (int e = tid; e < ROWS / TILE * LC; e += THREADS) {
    const int gl = e / LC, t = e - gl * LC, gg = g0 + gl;
    if (t < TILE * gg) vf[e] = __expf(cs[TILE * gg - 1] - cs[t]);
  }
  for (int ql = tid; ql < ROWS; ql += THREADS) {
    const int q = q0 + ql, gg = q / TILE;
    uf[ql] = gg > 0 ? __expf(cs[q] - cs[TILE * gg - 1]) : 1.f;
  }
  for (int e = tid; e < ROWS * TILE; e += THREADS) {
    const int ql = e / TILE, tl = e - ql * TILE;
    const int q = q0 + ql, t = q / TILE * TILE + tl;
    if (t < ka) {
      float* x = at + t * LDA + ql;
      *x = t <= q ? *x * __expf(cs[q] - cs[t]) : 0.f;
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int m0 = ROWS == TILE ? 0 : 16 * (warp & 3);
  const int n0 = ROWS == TILE ? 8 * warp : 32 * (warp >> 2);
  // the warp's rows are group gg: the earlier groups' columns scaled by
  // exp(c_g - cs_t) (rows by exp(cs_q - c_g) at the end), the diagonal
  // block, then C . S_in (rows by exp(cs_q) at the end)
  const int gl = m0 / TILE, gg = g0 + gl, t1 = TILE * gg;
  float d[NJ][4] = {}, f[NJ][4] = {}, e[NJ][4] = {};
  scan::mma_rows<NJ>(at, LDA, m0, bk, LDX, n0, min(t1, ka), f, vf + gl * LC);
  scan::mma_rows<NJ>(at + t1 * LDA, LDA, m0, bk + t1 * LDX, LDX, n0,
                     min(TILE, ka - t1), d);
  if (c > 0)
    scan::mma_rows<NJ, false, true>(at + ka * LDA, LDR, m0, bk + ka * LDX,
                                    LDR, n0, ds, e);
  const int qa = q0 + m0 + g, qb = qa + 8;
  const float ua = uf[m0 + g], ub = uf[m0 + g + 8];
  const float ea = c > 0 ? __expf(cs[qa]) : 0.f;
  const float eb = c > 0 ? __expf(cs[qb]) : 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = r < 2 ? qa : qb;
      const int p = n0 + 8 * j + 2 * qd + (r & 1);
      if (q < n && p < hd)
        a.y[((static_cast<int64_t>(b) * a.S + c0 + q) * a.nh + h) * hd + p]
            = (r < 2 ? ua : ub) * f[j][r] + d[j][r]
            + (r < 2 ? ea : eb) * e[j][r];
    }
}

// Blocks [0, n_cb) are CB blocks, the rest state blocks.
__global__ void __launch_bounds__(THREADS)
mamba_prep(Args a, int n_cb) {
  extern __shared__ __align__(16) float smem[];
  if (static_cast<int>(blockIdx.x) < n_cb)
    cb_block(a, blockIdx.x, smem);
  else
    state_block(a, blockIdx.x - n_cb, smem);
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS, ROWS == TILE ? 3 : 2)
mamba_out(Args a) {
  extern __shared__ __align__(16) float smem[];
  y_block<ROWS>(a, blockIdx.x, smem);
}

// One thread per (batch, head, VEC state elements): S_in of every chunk
// over its S_loc, in chunk order, and the state after the last chunk to
// fin.
constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 8;   // chunks whose loads are issued together

template <int VEC>
__global__ void __launch_bounds__(PASS_THREADS)
mamba_pass(float* __restrict__ st, const float* __restrict__ dec,
           float* __restrict__ fin, int64_t n_total, int nc, int n_el) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * PASS_THREADS
                     + threadIdx.x) * VEC;
  if (i >= n_total) return;
  const int64_t bh = i / n_el;
  const int e = static_cast<int>(i - bh * n_el);
  float* p = st + bh * nc * n_el + e;
  const float* q = dec + bh * nc;
  float run[VEC] = {};
  for (int c = 0; c < nc; c += PASS_BATCH) {
    float loc[PASS_BATCH][VEC], dk[PASS_BATCH];
#pragma unroll
    for (int j = 0; j < PASS_BATCH; ++j)
      if (c + j < nc) {
        const float* src = p + static_cast<int64_t>(c + j) * n_el;
        if constexpr (VEC == 4) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          loc[j][0] = f.x;
          loc[j][1] = f.y;
          loc[j][2] = f.z;
          loc[j][3] = f.w;
        } else {
          loc[j][0] = src[0];
        }
        dk[j] = q[c + j];
      }
#pragma unroll
    for (int j = 0; j < PASS_BATCH; ++j)
      if (c + j < nc) {
        float* dst = p + static_cast<int64_t>(c + j) * n_el;
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

cudaError_t launch_prep(const Args& a, int64_t n_cb, int64_t n_state,
                        cudaStream_t s) {
  const int bytes = (CB_FLOATS > SB_FLOATS ? CB_FLOATS : SB_FLOATS)
      * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_prep, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  mamba_prep<<<static_cast<unsigned>(n_cb + n_state), THREADS, bytes, s>>>(
      a, static_cast<int>(n_cb));
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_out(const Args& a, int64_t n_blocks, cudaStream_t s) {
  const int bytes = yb_floats(ROWS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_out<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  mamba_out<ROWS><<<static_cast<unsigned>(n_blocks), THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace a call needs: B . C^T per (batch, chunk), and the
// per-chunk states and decays when the call has more than one chunk.
int64_t mamba_scan_workspace(int B, int S, int nh, int hd, int ds) {
  const int64_t nc = (S + LC - 1) / LC;
  return static_cast<int64_t>(B) * nc * LC * LC
      + (nc > 1 ? static_cast<int64_t>(B) * nh * nc * (hd * ds + 1) : 0);
}

// Strides are in elements (x_sb x_st x_sh b_sb b_st c_sb c_st a_sb a_st
// a_sh); the last dimension of xt, Bm and Cm must be contiguous.  y is a
// contiguous (B, S, nh, hd) buffer, fin a contiguous (B, nh, hd, ds) one,
// ws a 16-byte aligned buffer of ws_floats >= mamba_scan_workspace()
// floats.  `wide` asks for 16-byte loads of xt, Bm and Cm; it is honoured
// only where their bases and strides are multiples of 16 bytes and hd and
// ds of 4.  Returns the cudaError_t of the attribute calls and the launches
// (0 on success); -1 for arguments outside what the kernel takes.
int mamba_scan_launch(const void* xt, const void* bm, const void* cm,
                      const void* la, void* y, void* fin, void* ws,
                      int64_t ws_floats, int B, int S, int nh, int hd,
                      int ds, const int64_t* strides, int wide,
                      void* stream) {
  if (B < 1 || S < 1 || nh < 1 || hd < 1 || hd > MAX_HD || ds < 1 ||
      ds > MAX_DS || ws == nullptr || !scan::aligned16(ws))
    return -1;
  const int nc = (S + LC - 1) / LC;
  const int nt = min(NT, (S + TILE - 1) / TILE);
  const int64_t n_cb = static_cast<int64_t>(B) * nc * nt;
  const int64_t n_state = static_cast<int64_t>(B) * nh * nc;
  const int64_t n_y = n_state * nt;
  if (n_cb + n_state + n_y > 0x7fffffff
      || ws_floats < mamba_scan_workspace(B, S, nh, hd, ds))
    return -1;
  const int64_t* sd = strides;
  bool wide_ok = hd % 4 == 0 && ds % 4 == 0 && scan::aligned16(xt)
      && scan::aligned16(bm) && scan::aligned16(cm);
  for (int j = 0; j < 7; ++j) wide_ok = wide_ok && sd[j] % 4 == 0;
  float* wsf = static_cast<float*>(ws);
  const int64_t n_cbf = static_cast<int64_t>(B) * nc * LC * LC;
  const int64_t n_st = nc > 1 ? n_state * hd * ds : 0;
  Args a{static_cast<const float*>(xt), static_cast<const float*>(bm),
         static_cast<const float*>(cm), static_cast<const float*>(la),
         static_cast<float*>(y), static_cast<float*>(fin), wsf, wsf + n_cbf,
         wsf + n_cbf + n_st, S, nh, hd, ds, nc, nt, wide && wide_ok,
         sd[0], sd[1], sd[2], sd[3], sd[4], sd[5], sd[6], sd[7], sd[8],
         sd[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prep(a, n_cb, n_state, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc == 1)  // no S_in: the state blocks wrote the final state
    return static_cast<int>(launch_out<TILE>(a, n_y, s));
  const int64_t n_total = static_cast<int64_t>(B) * nh * hd * ds;
  const int vec = hd * ds % 4 == 0 ? 4 : 1;   // float4 where they align
  const unsigned grid = static_cast<unsigned>(
      (n_total / vec + PASS_THREADS - 1) / PASS_THREADS);
  if (vec == 4)
    mamba_pass<4><<<grid, PASS_THREADS, 0, s>>>(
        a.st, a.dec, static_cast<float*>(fin), n_total, nc, hd * ds);
  else
    mamba_pass<1><<<grid, PASS_THREADS, 0, s>>>(
        a.st, a.dec, static_cast<float*>(fin), n_total, nc, hd * ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_out<64>(a, n_state * (LC / 64), s));
}

}  // extern "C"
