// mamba_scan: the Mamba2 chunked SSD scan, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (`mamba_scan`, body `_mamba_kernel`).  From a zero state, per head h:
//   state_t = exp(lA_t) state_{t-1} + xt_t (x) B_t,   y_t = state_t . C_t,
// computed chunk by chunk (LC = 128 tokens).  Per chunk, with cs the
// inclusive prefix sum of lA over the chunk:
//   att[q][t] = (C_q . B_t) exp(cs_q - cs_t)      for t <= q, else 0
//   y_q       = sum_t att[q][t] xt_t + exp(cs_q) C_q . state
//   state    <- exp(cs_last) state + sum_t exp(cs_last - cs_t) xt_t (x) B_t
// The exponent is masked before exp: above the diagonal cs_q - cs_t is
// positive and would overflow.
//
// Bound on an H100: operations, at the serve path's shapes (S ~ 1000,
// nh 80, hd = ds = 64): the one-step recurrence needs about 5 hd ds f32
// operations per (token, head), 1.6 GFLOP, against about 42 MB of inputs
// and outputs (the chunked form here does more: it trades those steps for
// products over the chunk).  The products are f32 on the CUDA cores
// (TF32 tensor cores would not hold the f32 tolerance).  What the design
// does about it:
//   * the TPU grid walked the chunks of a (batch, head) in order, carrying
//     the state in VMEM; here one block per (head, batch) walks its chunks
//     in a loop and keeps the (ds, hd) state in shared memory, so nothing
//     but the inputs and y crosses device memory;
//   * the chunk's operands live in shared memory (215.5 KB, above the 48 KB
//     default, so the launch opts in with cudaFuncSetAttribute): x, B and
//     its transpose, C transposed, the 128 x 128 att tile (transposed) and
//     the state.  Transposed tiles have a padded row (LC + 1) so that
//     writing them, and the strided reads of the products, hit distinct
//     banks;
//   * the four products are register-tiled on a 16 x 16 thread grid, each
//     thread holding an 8 x 8, 8 x 4 or 4 x 4 tile with rows and columns
//     strided by 16, so a warp's loads of one operand row are 16
//     consecutive floats (no bank conflicts) or a broadcast;
//   * the ragged tail masks by index: rows past S load as zero (lA as 0),
//     which is what the Pallas kernel's zero padding computes, and nothing
//     is padded in device memory.
// One block per (head, batch) gives 80 blocks at B = 1 on 132 SMs, one
// block per SM (shared memory): the first version is far from its bound.
// Not yet done (later work): splitting the chunk walk across blocks with a
// second pass for the state (as the GPU SSD algorithm does), TF32 or 3xTF32
// tensor-core products, cp.async / TMA double buffering.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/mamba_scan.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LC = 128;        // chunk length (the Pallas DEFAULT_CHUNK)
constexpr int MAX_HD = 64;     // head_dim limit
constexpr int MAX_DS = 64;     // state size limit
constexpr int THREADS = 256;   // a 16 x 16 grid over output tiles
constexpr int LDT = LC + 1;    // padded row of the transposed tiles

// shared memory, in floats
constexpr int OFF_X = 0;                          // x   [LC][MAX_HD]
constexpr int OFF_B = OFF_X + LC * MAX_HD;        // B   [LC][MAX_DS]
constexpr int OFF_BT = OFF_B + LC * MAX_DS;       // B^T [MAX_DS][LDT]
constexpr int OFF_CT = OFF_BT + MAX_DS * LDT;     // C^T [MAX_DS][LDT]
constexpr int OFF_AT = OFF_CT + MAX_DS * LDT;     // att^T [LC][LDT]: [t][q]
constexpr int OFF_ST = OFF_AT + LC * LDT;         // state^T [MAX_DS][MAX_HD]
constexpr int OFF_CS = OFF_ST + MAX_DS * MAX_HD;  // cs [LC]
constexpr int OFF_EC = OFF_CS + LC;               // exp(cs) [LC]
constexpr int OFF_DC = OFF_EC + LC;               // exp(cs_last - cs) [LC]
constexpr int SMEM_FLOATS = OFF_DC + LC;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "above the H100's 227 KB per block");

// grid (nh, B); block THREADS.  xt[b, t, h, p] at b*x_sb + t*x_st +
// h*x_sh + p, Bm/Cm[b, t, s] at b*_sb + t*_st + s, lA[b, t, h] at
// b*a_sb + t*a_st + h*a_sh.  y is a contiguous (B, S, nh, hd) buffer and
// fin a contiguous (B, nh, hd, ds) one.
__global__ void __launch_bounds__(THREADS, 1)
mamba_scan_kernel(const float* __restrict__ xt, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ la,
                  float* __restrict__ y, float* __restrict__ fin, int S,
                  int nh, int hd, int ds, int64_t x_sb, int64_t x_st,
                  int64_t x_sh, int64_t b_sb, int64_t b_st, int64_t c_sb,
                  int64_t c_st, int64_t a_sb, int64_t a_st, int64_t a_sh) {
  extern __shared__ float smem[];
  float* xs = smem + OFF_X;
  float* bs = smem + OFF_B;
  float* bt = smem + OFF_BT;
  float* ct = smem + OFF_CT;
  float* at = smem + OFF_AT;
  float* st = smem + OFF_ST;
  float* cs = smem + OFF_CS;
  float* ec = smem + OFF_EC;
  float* dc = smem + OFF_DC;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* xb = xt + b * x_sb + h * x_sh;
  const float* bb = bm + b * b_sb;
  const float* cb = cm + b * c_sb;
  const float* ab = la + b * a_sb + h * a_sh;
  const int64_t y_row = static_cast<int64_t>(nh) * hd;
  float* yb = y + (static_cast<int64_t>(b) * S * nh + h) * hd;

  for (int i = tid; i < MAX_DS * MAX_HD; i += THREADS) st[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += LC) {
    const int n = min(LC, S - c0);
    __syncthreads();  // the previous chunk's readers are done

    // 1. load the chunk; rows past S are zero
    for (int i = tid; i < LC * MAX_HD; i += THREADS) {
      const int t = i / MAX_HD, p = i - t * MAX_HD;
      xs[i] = (t < n && p < hd) ? xb[(c0 + t) * x_st + p] : 0.f;
    }
    for (int i = tid; i < LC * MAX_DS; i += THREADS) {
      const int t = i / MAX_DS, s = i - t * MAX_DS;
      float bv = 0.f, cv = 0.f;
      if (t < n && s < ds) {
        bv = bb[(c0 + t) * b_st + s];
        cv = cb[(c0 + t) * c_st + s];
      }
      bs[i] = bv;
      bt[s * LDT + t] = bv;
      ct[s * LDT + t] = cv;
    }
    // inclusive prefix sum of lA over the chunk: warp 0, 4 rows a lane
    if (tid < 32) {
      float part[LC / 32];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < LC / 32; ++j) {
        const int t = tid * (LC / 32) + j;
        sum += t < n ? ab[(c0 + t) * a_st] : 0.f;
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
    __syncthreads();
    const float cl = cs[LC - 1];  // = cs[n - 1]: padded rows add lA = 0
    for (int t = tid; t < LC; t += THREADS) {
      ec[t] = expf(cs[t]);
      dc[t] = expf(cl - cs[t]);
    }

    // 2. att[q][t] = (C_q . B_t) exp(cs_q - cs_t), t <= q; stored [t][q]
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float a[8], v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ct[s * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = bt[s * LDT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * v[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = tx + 16 * j;
          // mask before exp: above the diagonal the exponent is positive
          at[t * LDT + q] = t <= q ? acc[i][j] * expf(cs[q] - cs[t]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. y_q = exp(cs_q) C_q . state + sum_t att[q][t] x_t
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float a[8], v[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ct[s * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = st[s * MAX_HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * v[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = ec[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      for (int t = 0; t < n; ++t) {
        float a[8], v[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = at[t * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = xs[t * MAX_HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * v[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = ty + 16 * i;
        if (q >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < hd) yb[(c0 + q) * y_row + p] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // 4. state[s][p] <- exp(cs_last) state + sum_t dc_t B_t[s] x_t[p]
    {
      const float e = expf(cl);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = st[(ty + 16 * i) * MAX_HD + tx + 16 * j] * e;
      for (int t = 0; t < n; ++t) {
        const float d = dc[t];
        float a[4], v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = bs[t * MAX_DS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = xs[t * MAX_HD + tx + 16 * j] * d;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * v[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st[(ty + 16 * i) * MAX_HD + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();

  float* fb = fin + (static_cast<int64_t>(b) * nh + h) * hd * ds;
  for (int i = tid; i < hd * ds; i += THREADS) {
    const int p = i / ds, s = i - p * ds;
    fb[i] = st[s * MAX_HD + p];
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the attribute call and the launch (0 on
// success); -1 for arguments outside what the kernel takes.  Strides are
// in elements; the last dimension of xt, Bm and Cm must be contiguous.
int mamba_scan_launch(const void* xt, const void* bm, const void* cm,
                      const void* la, void* y, void* fin, int B, int S,
                      int nh, int hd, int ds, int64_t x_sb, int64_t x_st,
                      int64_t x_sh, int64_t b_sb, int64_t b_st, int64_t c_sb,
                      int64_t c_st, int64_t a_sb, int64_t a_st, int64_t a_sh,
                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || nh < 1 || hd < 1 || hd > MAX_HD ||
      ds < 1 || ds > MAX_DS)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_scan_kernel<<<dim3(nh, B), THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xt), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(la),
      static_cast<float*>(y), static_cast<float*>(fin), S, nh, hd, ds, x_sb,
      x_st, x_sh, b_sb, b_st, c_sb, c_st, a_sb, a_st, a_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
