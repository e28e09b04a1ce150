// wkv6: the RWKV6 (Finch) chunked recurrence, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (`wkv6`, body
// `_wkv_kernel`).  From a zero state, per head h, with per-channel decay
// w_t in (0, 1] and bonus u:
//   out_t   = r_t (state_{t-1} + diag(u) k_t^T v_t)
//   state_t = diag(w_t) state_{t-1} + k_t^T v_t
// computed chunk by chunk (LC = 64 tokens).  Per chunk, with
// lw = log(max(w, 1e-30)) (the Pallas kernel's floor), cw its inclusive
// prefix sum over the chunk and cx the exclusive one (cx_t = cw_{t-1}):
//   att[t][s] = sum_d r_t[d] k_s[d] exp(cx_t[d] - cw_s[d])   for s < t
//   y_t       = (r_t exp(cx_t)) . state + sum_s att[t][s] v_s
//               + (sum_d r_t[d] u[d] k_t[d]) v_t
//   state    <- diag(exp(cw_last)) state + sum_s (k_s exp(cw_last - cw_s))^T v_s
// Every exponent is <= 0: the pairwise decay is taken exactly, element by
// element, before the exp, and never factored as exp(cx_t) exp(-cw_s),
// which overflows f32 once a chunk's decay passes e^-88 (the fault of
// src/repro/models/ssm.py's wkv6_chunk_scan at w ~ 0.05).  Neither is the
// (LC, LC, hd) tensor of exponents materialised (1 MB at 64^3): each
// thread forms its own att entries on the fly.
//
// Bound on an H100: bytes.  r, k, v, w are read once and y written once
// (about 41 MB at S ~ 1000, H 32, hd 64, f32) against the 5 hd^2 f32
// operations per (token, head) of the one-step recurrence, 0.66 GFLOP.
// What the design does about it:
//   * the TPU grid walked the chunks of a (batch, head) in order, carrying
//     the (hd, hd) state in VMEM; here one block per (head, batch) walks
//     its chunks in a loop with the state in shared memory (16 KB), so
//     device memory sees only the inputs, y and the final state;
//   * the chunk's r, k, v, the two prefix sums, r exp(cx) transposed, att
//     transposed and the state sit in shared memory (130 KB, so the launch
//     opts in above 48 KB with cudaFuncSetAttribute); rows padded to 65
//     floats keep the strided reads and the transposing writes on
//     distinct banks;
//   * the products are register-tiled on a 16 x 16 thread grid (4 x 4
//     tiles, rows and columns strided by 16);
//   * the ragged tail masks by index: rows past S load as r = k = v = 0 and
//     w = 1, which is what the Pallas kernel's padding computes, and
//     nothing is padded in device memory.
// One block per (head, batch) is 32 blocks at B = 1 on 132 SMs, and the
// LC^2 hd / 2 exps of att dominate each chunk: the first version is far
// from its bound.  Not yet done (later work): splitting the sequence
// across blocks with a second pass over the chunk states, sub-chunk
// factoring where the decay allows it, vector loads.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (src/repro_torch/kernels/wkv6.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LC = 64;         // chunk length (the Pallas DEFAULT_CHUNK)
constexpr int MAX_HD = 64;     // head_dim limit
constexpr int THREADS = 256;   // a 16 x 16 grid over output tiles
constexpr int LD = MAX_HD + 1; // padded [t][d] rows
constexpr int LDT = LC + 1;    // padded rows of the transposed tiles

// shared memory, in floats
constexpr int OFF_R = 0;                        // r [LC][LD]
constexpr int OFF_K = OFF_R + LC * LD;          // k [LC][LD], then k decayed
constexpr int OFF_V = OFF_K + LC * LD;          // v [LC][MAX_HD]
constexpr int OFF_CW = OFF_V + LC * MAX_HD;     // lw, then cw [LC][LD]
constexpr int OFF_CX = OFF_CW + LC * LD;        // cx [LC][LD]
constexpr int OFF_RD = OFF_CX + LC * LD;        // (r exp(cx))^T [MAX_HD][LDT]
constexpr int OFF_AT = OFF_RD + MAX_HD * LDT;   // att^T [LC][LDT]: [s][t]
constexpr int OFF_ST = OFF_AT + LC * LDT;       // state [MAX_HD][MAX_HD]
constexpr int OFF_BO = OFF_ST + MAX_HD * MAX_HD;  // bonus [LC]
constexpr int OFF_CL = OFF_BO + LC;             // cw_last [MAX_HD]
constexpr int SMEM_FLOATS = OFF_CL + MAX_HD;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "above the H100's 227 KB per block");

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (H, B); block THREADS.  r, k, v, w and y are contiguous
// (B, S, H, hd) buffers, u a contiguous (H, hd) one, fin a contiguous
// (B, H, hd, hd) one.
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y,
            float* __restrict__ fin, int S, int H, int hd) {
  extern __shared__ float smem[];
  float* rs = smem + OFF_R;
  float* ks = smem + OFF_K;
  float* vs = smem + OFF_V;
  float* cw = smem + OFF_CW;
  float* cx = smem + OFF_CX;
  float* rd = smem + OFF_RD;
  float* at = smem + OFF_AT;
  float* st = smem + OFF_ST;
  float* bonus = smem + OFF_BO;
  float* cl = smem + OFF_CL;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = static_cast<int64_t>(H) * hd;  // stride of t
  const int64_t base = static_cast<int64_t>(b) * S * row
      + static_cast<int64_t>(h) * hd;
  const float* uh = u + static_cast<int64_t>(h) * hd;

  for (int i = tid; i < MAX_HD * MAX_HD; i += THREADS) st[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += LC) {
    const int n = min(LC, S - c0);
    __syncthreads();  // the previous chunk's readers are done

    // 1. load the chunk; rows past S are r = k = v = 0, w = 1
    for (int i = tid; i < LC * MAX_HD; i += THREADS) {
      const int t = i / MAX_HD, d = i - t * MAX_HD;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 1.f;
      if (t < n && d < hd) {
        const int64_t o = base + (c0 + t) * row + d;
        rv = r[o];
        kv = k[o];
        vv = v[o];
        wv = w[o];
      }
      rs[t * LD + d] = rv;
      ks[t * LD + d] = kv;
      vs[t * MAX_HD + d] = vv;
      cw[t * LD + d] = logf(fmaxf(wv, 1e-30f));
    }
    __syncthreads();

    // 2. per-channel prefix sums of log w: cx exclusive, cw inclusive
    if (tid < MAX_HD) {
      float run = 0.f;
      for (int t = 0; t < LC; ++t) {
        const float lw = cw[t * LD + tid];
        cx[t * LD + tid] = run;
        run += lw;
        cw[t * LD + tid] = run;
      }
      cl[tid] = run;
    }
    __syncthreads();

    // 3. r exp(cx) transposed; the bonus; att transposed
    for (int i = tid; i < LC * MAX_HD; i += THREADS) {
      const int t = i / MAX_HD, d = i - t * MAX_HD;
      rd[d * LDT + t] = rs[t * LD + d] * expf(cx[t * LD + d]);
    }
    for (int t = warp; t < LC; t += THREADS / 32) {
      float part = 0.f;
      for (int d = lane; d < hd; d += 32)
        part += rs[t * LD + d] * uh[d] * ks[t * LD + d];
      part = warp_sum(part);
      if (lane == 0) bonus[t] = part;
    }
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float rr[4], xx[4], kk[4], ww[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = rs[(ty + 16 * i) * LD + d];
          xx[i] = cx[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kk[j] = ks[(tx + 16 * j) * LD + d];
          ww[j] = cw[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // strictly past tokens only, masked before the exp
            if (tx + 16 * j < ty + 16 * i)
              acc[i][j] += rr[i] * kk[j] * expf(xx[i] - ww[j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          at[(tx + 16 * j) * LDT + ty + 16 * i] = acc[i][j];
    }
    __syncthreads();

    // 4. k decayed to the chunk's end (for step 5), and
    //    y_t = (r_t exp(cx_t)) . state + sum_s att[t][s] v_s + bonus_t v_t
    for (int i = tid; i < LC * MAX_HD; i += THREADS) {
      const int s = i / MAX_HD, d = i - s * MAX_HD;
      ks[s * LD + d] *= expf(cl[d] - cw[s * LD + d]);
    }
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = bonus[ty + 16 * i]
              * vs[(ty + 16 * i) * MAX_HD + tx + 16 * j];
      for (int d = 0; d < hd; ++d) {
        float a[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = rd[d * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = st[d * MAX_HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * e[j];
      }
      for (int s = 0; s < n; ++s) {
        float a[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = at[s * LDT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = vs[s * MAX_HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * e[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = tx + 16 * j;
          if (e < hd) y[base + (c0 + t) * row + e] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // 5. state[d][e] <- exp(cw_last[d]) state + sum_s kdec_s[d] v_s[e]
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cl[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = st[(ty + 16 * i) * MAX_HD + tx + 16 * j] * e;
      }
      for (int s = 0; s < n; ++s) {
        float a[4], e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ks[s * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = vs[s * MAX_HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * e[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          st[(ty + 16 * i) * MAX_HD + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();

  float* fb = fin + (static_cast<int64_t>(b) * H + h) * hd * hd;
  for (int i = tid; i < hd * hd; i += THREADS) {
    const int d = i / hd, e = i - d * hd;
    fb[i] = st[d * MAX_HD + e];
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the attribute call and the launch (0 on
// success); -1 for arguments outside what the kernel takes.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, void* fin, int B, int S, int H,
                int hd, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || hd < 1 || hd > MAX_HD)
    return -1;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<<<dim3(H, B), THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(fin), S, H, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
