// B12: random bits drawn inside a kernel, Gumbel noise and a wide arg-max, on Hopper.
//
// Replaces the Pallas TPU kernel of scripts/dev_prng_probe.py:16-41 (`fn`, the
// pl.pallas_call at :32), which seeds the TPU's own generator, draws B x Q 32-bit
// values, makes Gumbel noise of them and takes each row's arg-max of scores + noise.
// The TPU's bits are not available here: the bits are Philox4x32-10 (Salmon et al.
// 2011) with the AR kernel's big-vocab keying, key = the 64-bit seed, counter =
// (class / 4, 0, 0, row), word class % 4 (csrc/wavenet_ar.cu draws them so at step 0;
// the rounds are copied here, not shared, so that each source stands alone). The
// transform is the script's: u = ((bits >> 9) | 0x3F800000) as a float, minus 1;
// g = -log(-log(u + 1e-9) + 1e-9), in f32 with the full-precision logf.
//
// Design. Pass 1: one block of 1024 threads per row. A thread walks groups of 4
// classes (one Philox block a group; consecutive threads on consecutive groups, so a
// warp reads 512 contiguous bytes of scores), keeps the largest score with its lowest
// class, and the sum, max and min of g; a warp-shuffle and a shared-memory reduction
// give the row's arg-max (the first class on a tie, as jnp.argmax) and its partial
// stats. Pass 2: one warp combines the B rows' partial stats into the mean (summed in
// double), max and min of g.
//
// What bounds it. The scores are read once: 4 B x Q bytes, 2.1 MB at B=8 (0.63 us at
// 3.35 TB/s). A class costs a quarter of a Philox block (10 rounds of two 32-bit
// multiplies) and two logf: about 34 f32-rate operations, 17.8 M at B=8 (0.27 us at 67
// TFLOP/s). So bytes bound it on paper; with one block a row, B=8 runs on 8 of 132 SMs,
// and their issue rate, not the memory, sets the time of this first design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(u + 1e-9f) + 1e-9f);
}

// Is (v, id) a better arg-max candidate than (bv, bid): a larger score, or the same
// score at a lower class.
__device__ __forceinline__ bool better(float v, int id, float bv, int bid) {
  return v > bv || (v == bv && id < bid);
}

__global__ void __launch_bounds__(NT) prng_argmax_kernel(
    const float* __restrict__ scores, float* __restrict__ ids,
    float* __restrict__ partial, int Q, uint32_t k0, uint32_t k1) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = scores + (size_t)b * Q;
  float bv = -INFINITY, gsum = 0.f, gmax = -INFINITY, gmin = INFINITY;
  int bid = 0x7FFFFFFF;
  const int n4 = (Q + 3) / 4;
  for (int c4 = tid; c4 < n4; c4 += NT) {
    uint32_t bits[4];
    philox4x32_10((uint32_t)c4, 0u, 0u, (uint32_t)b, k0, k1, bits);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * c4 + i;
      if (c < Q) {
        const float g = gumbel_from_bits(bits[i]);
        gsum += g;
        gmax = fmaxf(gmax, g);
        gmin = fminf(gmin, g);
        const float v = row[c] + g;
        if (better(v, c, bv, bid)) { bv = v; bid = c; }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int id = __shfl_xor_sync(0xffffffffu, bid, off);
    if (better(v, id, bv, bid)) { bv = v; bid = id; }
    gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
    gmin = fminf(gmin, __shfl_xor_sync(0xffffffffu, gmin, off));
  }
  __shared__ float s_v[32], s_sum[32], s_max[32], s_min[32];
  __shared__ int s_id[32];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_v[warp] = bv; s_id[warp] = bid;
    s_sum[warp] = gsum; s_max[warp] = gmax; s_min[warp] = gmin;
  }
  __syncthreads();
  if (warp == 0) {
    bv = s_v[lane]; bid = s_id[lane];
    gsum = s_sum[lane]; gmax = s_max[lane]; gmin = s_min[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, off);
      const int id = __shfl_xor_sync(0xffffffffu, bid, off);
      if (better(v, id, bv, bid)) { bv = v; bid = id; }
      gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
      gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
      gmin = fminf(gmin, __shfl_xor_sync(0xffffffffu, gmin, off));
    }
    if (lane == 0) {
      ids[b] = (float)bid;
      partial[3 * b] = gsum;
      partial[3 * b + 1] = gmax;
      partial[3 * b + 2] = gmin;
    }
  }
}

// One warp: the stats row (mean, max, min of g over B x Q, then five zeros).
__global__ void prng_stats_kernel(const float* __restrict__ partial,
                                  float* __restrict__ stats, int B, long long n) {
  const int lane = threadIdx.x;
  double sum = 0.0;
  float gmax = -INFINITY, gmin = INFINITY;
  for (int b = lane; b < B; b += 32) {
    sum += partial[3 * b];
    gmax = fmaxf(gmax, partial[3 * b + 1]);
    gmin = fminf(gmin, partial[3 * b + 2]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
    gmin = fminf(gmin, __shfl_xor_sync(0xffffffffu, gmin, off));
  }
  if (lane < 8) stats[lane] = lane == 0 ? (float)(sum / (double)n)
                              : lane == 1 ? gmax : lane == 2 ? gmin : 0.f;
}

}  // namespace

// scores (B, Q) f32; ids (B, 1) f32; stats (1, 8) f32; partial (B, 3) f32 scratch.
// Returns a cudaError_t (0: launched).
extern "C" int probe_prng(const float* scores, float* ids, float* stats, float* partial,
                          long long B, long long Q, long long seed_lo, long long seed_hi,
                          cudaStream_t stream) {
  if (B <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  prng_argmax_kernel<<<(unsigned)B, NT, 0, stream>>>(scores, ids, partial, (int)Q,
                                                    (uint32_t)seed_lo, (uint32_t)seed_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prng_stats_kernel<<<1, 32, 0, stream>>>(partial, stats, (int)B, B * Q);
  return (int)cudaGetLastError();
}
