// Helpers shared by the chunked scans (mamba_scan.cu, wkv6.cu): staged
// row loads, and f32 products on the tensor cores (3xTF32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr int THREADS = 256;   // every scan block: 8 warps
constexpr int TILE = 16;       // rows of an output tile (one mma row tile)

// Item j of this thread's share of a rows x ncols block of an operand
// (ncols a multiple of 4), as one float4: row t, columns c..c+3.  All of a
// block's operand loads are issued into registers first and only then
// stored to shared memory, so they are in flight together.  Rows >= valid
// and columns >= lim read as 0; `wide` takes 16-byte loads (the caller
// has checked alignment), otherwise single elements; LOGW stores
// log(max(x, 1e-30)) of the elements read (the padding stays 0).
template <int IT, bool LOGW = false>
__device__ __forceinline__ void fetch(float4 (&r)[IT], const float* src,
                                      int64_t rs, int rows, int valid,
                                      int ncols, int lim, bool wide) {
  const int q4 = ncols >> 2;
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int t = i / q4, c = (i - t * q4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < rows * q4 && t < valid && c < lim) {
      const float* p = src + t * rs + c;
      if (wide) {
        x = *reinterpret_cast<const float4*>(p);
      } else {
        x.x = p[0];
        if (c + 1 < lim) x.y = p[1];
        if (c + 2 < lim) x.z = p[2];
        if (c + 3 < lim) x.w = p[3];
      }
      if (LOGW) {  // wkv6's decay: log(max(w, 1e-30)); padding stays 0
        x.x = logf(fmaxf(x.x, 1e-30f));
        x.y = c + 1 < lim ? logf(fmaxf(x.y, 1e-30f)) : 0.f;
        x.z = c + 2 < lim ? logf(fmaxf(x.z, 1e-30f)) : 0.f;
        x.w = c + 3 < lim ? logf(fmaxf(x.w, 1e-30f)) : 0.f;
      }
    }
    r[j] = x;
  }
}

// The items of `fetch` into dst[t * ld + c] (TRANSPOSE: dst[c * ld + t]).
template <bool TRANSPOSE, int IT>
__device__ __forceinline__ void put(const float4 (&r)[IT], float* dst,
                                    int ld, int rows, int ncols) {
  const int q4 = ncols >> 2;
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i >= rows * q4) continue;
    const int t = i / q4, c = (i - t * q4) * 4;
    const float x[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (TRANSPOSE)
        dst[(c + k) * ld + t] = x[k];
      else
        dst[t * ld + c + k] = x[k];
    }
  }
}

// The f32 products run on the tensor cores as 3xTF32: each operand is
// split into a TF32 high part (its top 19 bits) and the remainder, and
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi (the a_lo b_lo term, near
// 2^-20 relative, is dropped), accumulated in f32.  The tensor cores read
// a TF32 operand's top 19 bits, so the remainder loses at most 2^-10 of
// itself, again about 2^-20 of the operand.  That keeps close to the
// accuracy of an f32 product on the CUDA cores, where plain TF32 (about
// three decimal digits) could not hold the scans' tolerances.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += A B for one warp, A 16 x K (rows m0..), B K x 8 NJ (columns
// n0..), k >= K reading as 0.  A_T: A is stored transposed, element
// (m, k) at A[k * lda + m]; else at A[m * lda + k].  B_T: B is stored
// transposed, (k, n) at B[n * ldb + k]; else at B[k * ldb + n].
// `kscale`, where given, multiplies A's column k by kscale[k].  Fragment
// j of lane (g = lane / 4, q = lane % 4) holds rows m0 + g (d[j][0],
// d[j][1]) and m0 + g + 8 (d[j][2], d[j][3]), columns n0 + 8 j + 2 q and
// + 1.  Strides of 8 or 24 mod 32 (4 mod 32 where the 4 lanes of a row
// read consecutive k) keep a warp's fragment loads on distinct banks.
template <int NJ, bool A_T = true, bool B_T = false>
__device__ __forceinline__ void mma_rows(const float* A, int lda, int m0,
                                         const float* B, int ldb, int n0,
                                         int K, float (&d)[NJ][4],
                                         const float* kscale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  auto at = [&](int m, int k) {
    return A_T ? A[k * lda + m] : A[m * lda + k];
  };
  auto bt = [&](int k, int n) {
    return B_T ? B[n * ldb + k] : B[k * ldb + n];
  };
  // independent accumulators, so that the mma of one step need not wait
  // for the last: hi * hi apart from the two corrections, and with one
  // 8-column tile a warp, even and odd steps apart too
  constexpr int U = NJ == 1 ? 2 : 1;
  float dm[U][NJ][4] = {}, dc[U][NJ][4] = {};
  for (int k00 = 0; k00 < K; k00 += 8 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k0 = k00 + 8 * u;
      if (k0 >= K) break;
      const int ka = k0 + q, kb = ka + 4;
      const bool va = ka < K, vb = kb < K;
      const float sa = kscale && va ? kscale[ka] : 1.f;
      const float sb = kscale && vb ? kscale[kb] : 1.f;
      const float av[4] = {va ? at(m0 + g, ka) * sa : 0.f,
                           va ? at(m0 + g + 8, ka) * sa : 0.f,
                           vb ? at(m0 + g, kb) * sb : 0.f,
                           vb ? at(m0 + g + 8, kb) * sb : 0.f};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + 8 * j + g;
        const float bv[2] = {va ? bt(ka, n) : 0.f, vb ? bt(kb, n) : 0.f};
        uint32_t bh[2], bl[2];
        split_tf32(bv[0], bh[0], bl[0]);
        split_tf32(bv[1], bh[1], bl[1]);
        mma_tf32(dc[u][j], al, bh);
        mma_tf32(dc[u][j], ah, bl);
        mma_tf32(dm[u][j], ah, bh);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float sm = 0.f, sc = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sm += dm[u][j][r];
        sc += dc[u][j][r];
      }
      d[j][r] += sm + sc;
    }
}

// Four consecutive outputs to row `dst` from column e, those below lim.
__device__ __forceinline__ void store4(float* dst, int e, int lim,
                                       float4 v, bool wide) {
  if (wide && e + 3 < lim) {
    *reinterpret_cast<float4*>(dst + e) = v;
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k < lim) dst[e + k] = x[k];
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace scan
