// The gate product of the decoder probes (matmul_probe.cu, microbench.cu): 32 rows of
// bf16 activations times a bf16 weight matrix (K, 4U), for the 32 columns one block
// owns, with f32 accumulation. Block j owns columns q*U + 8j + i, q < 4 (the four gates
// of units 8j .. 8j+7), i < 8: whole units, so an LSTM's cell update stays in the block.
//
// The activations are staged in shared memory transposed, xT[k][row] (64 bytes a k), so
// that the threads of a warp, which share k, read their rows without bank conflicts.
// Thread tid takes column group q = tid % 4 (a 16-byte load of 8 bf16 weights), rows
// 4*rb .. 4*rb+3 with rb = (tid / 4) % 8, and the K-slice ks = tid / 32 of K/8 rows of
// the weights; its 32 sums meet the other slices' in red[ks][row][col], and
// gate_combine adds the 8 slices in slice order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gate {

constexpr int NT = 256;     // threads a block
constexpr int ROWS = 32;    // activation rows (the batch)
constexpr int COLS = 32;    // columns a block owns
constexpr int SLICES = 8;   // K-slices

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// xT[k0 + c][r] = src[r * ld + c] for c < width, r < ROWS (16-byte loads; width and ld
// multiples of 8).
__device__ __forceinline__ void stage(__nv_bfloat16* xT, const __nv_bfloat16* src,
                                      int ld, int k0, int width) {
  const int n8 = width / 8;
  for (int i = threadIdx.x; i < ROWS * n8; i += NT) {
    const int r = i / n8, c = (i % n8) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int m = 0; m < 8; ++m) xT[(size_t)(k0 + c + m) * ROWS + r] = e[m];
  }
}

// xT[k0 + c][r] = 0 for c < width.
__device__ __forceinline__ void stage_zero(__nv_bfloat16* xT, int k0, int width) {
  for (int i = threadIdx.x; i < ROWS * width; i += NT)
    xT[(size_t)k0 * ROWS + i] = __float2bfloat16(0.f);
}

// Partial sums of the product xT (K x 32 rows) by the block's columns of w (K, N),
// N = 4U, into red[(ks * ROWS + row) * COLS + col], col = 8q + i. K % 64 == 0.
__device__ __forceinline__ void product(const __nv_bfloat16* xT,
                                        const __nv_bfloat16* __restrict__ w, int K, int U,
                                        float* red) {
  const int tid = threadIdx.x, q = tid & 3, rb = (tid >> 2) & 7, ks = tid >> 5;
  const int kn = K / SLICES, N = 4 * U;
  const __nv_bfloat16* wc = w + (size_t)q * U + 8 * blockIdx.x;
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
#pragma unroll 4
  for (int k = ks * kn; k < (ks + 1) * kn; ++k) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wc + (size_t)k * N));
    const uint2 xv = *reinterpret_cast<const uint2*>(xT + (size_t)k * ROWS + 4 * rb);
    const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wv);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    float wf[8], xf[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float2 f = __bfloat1622float2(wp[m]);
      wf[2 * m] = f.x;
      wf[2 * m + 1] = f.y;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float2 f = __bfloat1622float2(xp[m]);
      xf[2 * m] = f.x;
      xf[2 * m + 1] = f.y;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(xf[r], wf[i], acc[r][i]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      red[(ks * ROWS + 4 * rb + r) * COLS + 8 * q + i] = acc[r][i];
}

// z[row * COLS + col] = the sum of the 8 slices of red: in slice order (split 1), as
// two halves of 4 slices (split 2), or as four pairs added in order (split 4).
__device__ __forceinline__ void combine(const float* red, float* z, int split) {
  for (int o = threadIdx.x; o < ROWS * COLS; o += NT) {
    float s[SLICES];
#pragma unroll
    for (int ks = 0; ks < SLICES; ++ks) s[ks] = red[ks * ROWS * COLS + o];
    float v;
    if (split == 2) {
      v = (((s[0] + s[1]) + s[2]) + s[3]) + (((s[4] + s[5]) + s[6]) + s[7]);
    } else if (split == 4) {
      v = (((s[0] + s[1]) + (s[2] + s[3])) + (s[4] + s[5])) + (s[6] + s[7]);
    } else {
      v = s[0];
#pragma unroll
      for (int ks = 1; ks < SLICES; ++ks) v += s[ks];
    }
    z[o] = v;
  }
}

}  // namespace gate
