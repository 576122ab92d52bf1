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
// Design. Each row runs on a thread-block cluster of C CTAs (16, or 8 where the card
// keeps fewer than B clusters of 16 resident), so that B=8 spreads over 64-128 SMs, not
// 8. CTA r of a row takes the Philox blocks [r n4 / C, (r+1) n4 / C) of its n4 =
// ceil(Q/4) groups of 4 classes: a thread a group at a time (one group at Q = 65,536 and
// C = 16), consecutive threads on consecutive groups, the scores read as 16-byte vectors
// where Q is a multiple of 4.
// The ids do not depend on C: the keying and the transform are the class's own. A
// thread keeps its largest score with its lowest class, and the sum, max and min of g
// over its classes in order; a fixed shuffle tree and the warps in order give the CTA's.
// The CTAs' partials go to rank 0 through distributed shared memory, merged in rank
// order (the first class on a tie, as jnp.argmax), which writes the row's id and its
// partial stats (the sum in double). The last row to finish (a fence and an arrival
// counter, reset by it for the next launch) sums the rows' partials in row order into
// the stats row. Every sum has a fixed order: the same bits on every run.
//
// What bounds it. The scores are read once: 4 B x Q bytes, 2.1 MB at B=8 (0.63 us at
// 3.35 TB/s). A class costs a quarter of a Philox block (10 rounds of two 32-bit
// multiplies) and two logf: about 34 f32-rate operations, 17.8 M at B=8 (0.27 us at 67
// TFLOP/s). So bytes bound it on paper; a launch, the cluster's barrier and the merge
// are the floor of a call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;  // threads a CTA: a Philox block a thread at B=8, Q = 65,536
constexpr int MAX_C = 16;

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

// What a thread, a warp, a CTA or a row has seen: the best (score, class) and the sum,
// max and min of g.
struct Part {
  float bv;
  int bid;
  float sum, gmax, gmin;
};

__device__ __forceinline__ void merge(Part& x, const Part& y) {
  if (better(y.bv, y.bid, x.bv, x.bid)) {
    x.bv = y.bv;
    x.bid = y.bid;
  }
  x.sum += y.sum;
  x.gmax = fmaxf(x.gmax, y.gmax);
  x.gmin = fminf(x.gmin, y.gmin);
}

__device__ __forceinline__ Part warp_merge(Part x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Part y;
    y.bv = __shfl_xor_sync(0xffffffffu, x.bv, off);
    y.bid = __shfl_xor_sync(0xffffffffu, x.bid, off);
    y.sum = __shfl_xor_sync(0xffffffffu, x.sum, off);
    y.gmax = __shfl_xor_sync(0xffffffffu, x.gmax, off);
    y.gmin = __shfl_xor_sync(0xffffffffu, x.gmin, off);
    merge(x, y);
  }
  return x;
}

// the 4 classes 4 c4 .. 4 c4 + 3 of a row: the noise, and the scores where present
__device__ __forceinline__ void group(const float* __restrict__ row, int c4, int Q, int row_id,
                                      bool vec, uint32_t k0, uint32_t k1, Part& p) {
  uint32_t bits[4];
  philox4x32_10((uint32_t)c4, 0u, 0u, (uint32_t)row_id, k0, k1, bits);
  float s[4];
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + c4);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = 4 * c4 + i < Q ? __ldg(row + 4 * c4 + i) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * c4 + i;
    if (c < Q) {
      const float g = gumbel_from_bits(bits[i]);
      p.sum += g;
      p.gmax = fmaxf(p.gmax, g);
      p.gmin = fminf(p.gmin, g);
      const float v = s[i] + g;
      if (better(v, c, p.bv, p.bid)) { p.bv = v; p.bid = c; }
    }
  }
}

__global__ void __launch_bounds__(NT) prng_argmax_kernel(
    const float* __restrict__ scores, float* __restrict__ ids, float* __restrict__ stats,
    double* __restrict__ partial, unsigned int* __restrict__ arrived, int B, int Q,
    uint32_t k0, uint32_t k1) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ Part s_warp[NT / 32];
  __shared__ Part s_cta;
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row_id = blockIdx.x / C, tid = threadIdx.x;
  const float* row = scores + (size_t)row_id * Q;
  const int n4 = (Q + 3) / 4;
  const int g0 = (int)((long long)rank * n4 / C), g1 = (int)((long long)(rank + 1) * n4 / C);
  const bool vec = Q % 4 == 0 && (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  Part p = {-INFINITY, 0x7FFFFFFF, 0.f, -INFINITY, INFINITY};
  for (int c4 = g0 + tid; c4 < g1; c4 += NT) group(row, c4, Q, row_id, vec, k0, k1, p);
  p = warp_merge(p);
  if (tid % 32 == 0) s_warp[tid / 32] = p;
  __syncthreads();
  if (tid == 0) {  // the warps in order
    Part c = s_warp[0];
    for (int w = 1; w < NT / 32; ++w) merge(c, s_warp[w]);
    s_cta = c;
  }
  cluster.sync();  // every CTA's partial is in its shared memory
  if (rank == 0 && tid == 0) {
    Part r = s_cta;
    double sum = (double)r.sum;
    for (int q = 1; q < C; ++q) {  // rank order
      const Part y = *cluster.map_shared_rank(&s_cta, q);
      sum += (double)y.sum;
      merge(r, y);
    }
    ids[row_id] = (float)r.bid;
    partial[3 * row_id] = sum;
    partial[3 * row_id + 1] = (double)r.gmax;
    partial[3 * row_id + 2] = (double)r.gmin;
    __threadfence();
    if (atomicAdd(arrived, 1u) == (unsigned int)B - 1) {  // the last row: the stats row
      __threadfence();
      const volatile double* pv = partial;
      double total = 0.0, gmax = -INFINITY, gmin = INFINITY;
      for (int b = 0; b < B; ++b) {
        total += pv[3 * b];
        gmax = fmax(gmax, pv[3 * b + 1]);
        gmin = fmin(gmin, pv[3 * b + 2]);
      }
      stats[0] = (float)(total / ((double)B * Q));
      stats[1] = (float)gmax;
      stats[2] = (float)gmin;
      for (int i = 3; i < 8; ++i) stats[i] = 0.f;
      *arrived = 0u;  // for the next launch
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

cudaLaunchConfig_t config(int B, int C, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the CTAs a row: 16 where the card keeps at least B clusters of 16 resident, else 8
int cluster_for(int B) {
  static int cached_b = -1, cached_c = 8;
  if (B == cached_b) return cached_c;
  int c = 8;
  if (cudaFuncSetAttribute(prng_argmax_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(1, MAX_C, nullptr, &attr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, prng_argmax_kernel, &cfg) == cudaSuccess
        && clusters >= B)
      c = MAX_C;
  }
  cudaGetLastError();  // a refusal leaves 8
  cached_b = B;
  cached_c = c;
  return c;
}

}  // namespace

// scores (B, Q) f32; ids (B, 1) f32; stats (1, 8) f32; partial (B, 3) f64 scratch;
// arrived: one unsigned int, zero before the first launch (each launch leaves it zero).
// `launches` launches back to back (a timing loop without the host's call in it).
// Returns a cudaError_t (0: launched).
extern "C" int probe_prng(const float* scores, float* ids, float* stats, double* partial,
                          unsigned int* arrived, long long B, long long Q, long long seed_lo,
                          long long seed_hi, long long launches, cudaStream_t stream) {
  if (B <= 0 || Q <= 0 || Q > (1LL << 30) || launches <= 0) return (int)cudaErrorInvalidValue;
  const int C = cluster_for((int)B);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config((int)B, C, stream, &attr);
  for (long long i = 0; i < launches; ++i) {
    cudaError_t err = cudaLaunchKernelEx(&cfg, prng_argmax_kernel, scores, ids, stats, partial,
                                         arrived, (int)B, (int)Q, (uint32_t)seed_lo,
                                         (uint32_t)seed_hi);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The CTAs a row that a launch at batch B takes (cluster_for).
extern "C" int probe_prng_cluster(long long B) { return B > 0 ? cluster_for((int)B) : 0; }
