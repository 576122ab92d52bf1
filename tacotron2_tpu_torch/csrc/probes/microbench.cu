// B11: the Tacotron decoder step's pieces in a loop of T steps, on Hopper.
//
// Replaces the Pallas TPU kernel of scripts/dev_pallas_microbench.py:33-113 (`build`,
// the pl.pallas_call at :99): two LSTMs (gate order i, g, f, o, +1 on the forget gate,
// the gates rounded to bf16 after the f32 product, the cell math in bf16), then for
// `attlite` a softmax of bf16(h2 @ qk) against the first D rows of the flattened keys and
// the context, or for `att` the location-sensitive attention (location features from the
// accumulated alignments, e = sum_D tanh(keys + pq + pl), a masked softmax, the
// alignments added to the state, the context), for 32 rows, T steps inside one launch.
// tacotron2_tpu_torch/probes/microbench.py says what each variant computes.
//
// Design. One persistent cooperative launch of U/8 blocks (128 at U = 1,024), all
// co-resident (checked: the launch fails with the numbers). Block j owns units 8j ..
// 8j+7 of both LSTMs, so it computes their four gate columns each (gate_matmul.cuh) and
// updates their cells in place; h1 and h2 are double-buffered in global memory (step t
// reads [t % 2], writes [(t+1) % 2]), since every block reads all of them. A grid
// barrier follows each LSTM and the attention. The attention runs one block a row
// (blocks 0..31; the others wait at the barrier): pq with the row's h2, the location
// features, the energies, the softmax, the state, the context.
//
// What bounds it. A step's two gate products are 32 x (1,792 + 2,048) x 4,096 = 503 M
// multiply-adds (1.02 us at the bf16 tensor-core peak); g1 and g2 (31.5 MB) stay in the
// 50 MB L2, and from HBM they cost 9.4 us once a launch. The attention is 17 M more
// (pq, the location features by lk). This first kernel runs its multiply-adds in f32
// on the CUDA cores, and pays two or three grid barriers a step: tensor-core mma, and
// fewer barriers, are left for later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gate_matmul.cuh"

namespace cg = cooperative_groups;

namespace {

enum Variant { LSTM, ATTLITE, ATT };
using gate::COLS;
using gate::NT;
using gate::ROWS;
using gate::bf16r;

constexpr int T_IN = 128, E = 512, D = 128, F = 32, KLOC = 31;
constexpr int SW = T_IN + 128;  // state row width; alignments at [64, 64 + T_IN)

struct Args {
  const __nv_bfloat16 *g1, *g2, *qk, *lk, *keys;
  const float *values, *mask;
  __nv_bfloat16 *c1, *h1, *c2, *h2, *ctx;  // h1, h2: (2, 32, U)
  float *state, *out;
  int U, T, variant;
};

// bf16 sigmoid as the script computes it: each op rounded, one / (one + exp(-x))
__device__ __forceinline__ float sig16(float x) {
  return bf16r(1.f / bf16r(1.f + bf16r(expf(-x))));
}

// One LSTM for the block's units: gates from xT (K rows staged) by w, cell c in place,
// h into hn. Every thread takes one (row, unit).
__device__ __forceinline__ void lstm(const __nv_bfloat16* xT, const __nv_bfloat16* w, int K,
                                     int U, float* red, float* z, __nv_bfloat16* c,
                                     __nv_bfloat16* hn) {
  gate::product(xT, w, K, U, red);
  __syncthreads();
  gate::combine(red, z, 1);
  __syncthreads();
  const int r = threadIdx.x / 8, i = threadIdx.x % 8;
  const size_t n = (size_t)r * U + 8 * blockIdx.x + i;
  const float zi = bf16r(z[r * COLS + i]), zg = bf16r(z[r * COLS + 8 + i]);
  const float zf = bf16r(z[r * COLS + 16 + i]), zo = bf16r(z[r * COLS + 24 + i]);
  const float cold = __bfloat162float(c[n]);
  const float a = bf16r(sig16(bf16r(zf + 1.f)) * cold);
  const float b = bf16r(sig16(zi) * bf16r(tanhf(zg)));
  const float cn = bf16r(a + b);
  c[n] = __float2bfloat16(cn);
  hn[n] = __float2bfloat16(sig16(zo) * bf16r(tanhf(cn)));
}

// Block-wide max or sum of v over NT threads (scratch: 32 floats).
__device__ __forceinline__ float block_reduce(float v, float* scratch, bool is_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int k = 1; k < NT / 32; ++k) v = is_max ? fmaxf(v, scratch[k]) : v + scratch[k];
  return v;
}

// The attention of row b (one block), after both LSTMs of the step; f: D + 2*T_IN +
// F*D + 32 floats of shared memory.
__device__ void attention(const Args& a, const __nv_bfloat16* h2, int b, float* f) {
  float* pq = f;                 // D
  float* e = pq + D;             // T_IN
  float* fcb = e + T_IN;         // T_IN
  float* lk = fcb + T_IN;        // F x D
  float* scratch = lk + F * D;   // 32
  const int tid = threadIdx.x, U = a.U;
  const __nv_bfloat16* x2 = h2 + (size_t)b * U;
  for (int d = tid; d < D; d += NT) {
    float p = 0.f;
    for (int u = 0; u < U; ++u)
      p = fmaf(__bfloat162float(x2[u]), __bfloat162float(a.qk[(size_t)u * D + d]), p);
    pq[d] = p;
  }
  float* st = a.state + (size_t)b * SW;
  if (a.variant == ATT) {
    for (int i = tid; i < F * D; i += NT) lk[i] = __bfloat162float(a.lk[i]);
    for (int t = tid; t < T_IN; t += NT) {
      float fc = 0.f;
      for (int j = 0; j < KLOC; ++j) fc = __fadd_rn(fc, __fmul_rn(st[64 - 15 + j + t], 0.01f));
      fcb[t] = bf16r(fc);
    }
    __syncthreads();
    // e[t] = sum_d tanh(keys + pq + pl): two threads a t, 64 d each
    const int t = tid / 2, d0 = (tid % 2) * (D / 2);
    const __nv_bfloat16* kr = a.keys + ((size_t)b * T_IN + t) * D;
    float s = 0.f;
    for (int d = d0; d < d0 + D / 2; ++d) {
      float pl = 0.f;
      for (int ff = 0; ff < F; ++ff) pl = fmaf(fcb[t], lk[ff * D + d], pl);
      s += tanhf((__bfloat162float(kr[d]) + pq[d]) + pl);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (tid % 2 == 0) e[t] = a.mask[(size_t)b * T_IN + t] > 0.f ? s : -1e9f;
  } else {
    __syncthreads();
    // e[t] = bf16(pq) @ keys.reshape(-1, T_in)[:D]: rows of sequence 0's flat keys
    for (int t = tid; t < T_IN; t += NT) {
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        s = fmaf(bf16r(pq[d]), __bfloat162float(a.keys[(size_t)d * T_IN + t]), s);
      e[t] = s;
    }
  }
  __syncthreads();
  const float ev = tid < T_IN ? e[tid] : -INFINITY;
  const float emax = block_reduce(ev, scratch, true);
  const float ex = tid < T_IN ? expf(ev - emax) : 0.f;
  const float sum = block_reduce(ex, scratch, false);
  if (tid < T_IN) {
    const float al = ex / sum;
    e[tid] = al;
    if (a.variant == ATT) st[64 + tid] = st[64 + tid] + al;
  }
  __syncthreads();
  for (int c = tid; c < E; c += NT) {
    float s = 0.f;
    for (int t = 0; t < T_IN; ++t)
      s = fmaf(e[t], a.values[((size_t)b * T_IN + t) * E + c], s);
    a.ctx[(size_t)b * E + c] = __float2bfloat16(s);
  }
}

__global__ void __launch_bounds__(NT) microbench_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.U, IN1 = 256 + E + U, IN2 = 2 * U, KMAX = max(IN1, IN2);
  __nv_bfloat16* xT = reinterpret_cast<__nv_bfloat16*>(smem);              // KMAX x 32
  float* red = reinterpret_cast<float*>(smem + (size_t)KMAX * ROWS * 2);   // 8 x 32 x 32
  float* z = red + gate::SLICES * ROWS * COLS;                             // 32 x 32
  const size_t hsz = (size_t)ROWS * U;
  for (int t = 0; t < a.T; ++t) {
    __nv_bfloat16* h1c = a.h1 + (size_t)(t & 1) * hsz;
    __nv_bfloat16* h1n = a.h1 + (size_t)((t + 1) & 1) * hsz;
    __nv_bfloat16* h2c = a.h2 + (size_t)(t & 1) * hsz;
    __nv_bfloat16* h2n = a.h2 + (size_t)((t + 1) & 1) * hsz;
    // LSTM 1 on x0 = [zeros(32, 256), ctx, h1]
    gate::stage_zero(xT, 0, 256);
    gate::stage(xT, a.ctx, E, 256, E);
    gate::stage(xT, h1c, U, 256 + E, U);
    __syncthreads();
    lstm(xT, a.g1, IN1, U, red, z, a.c1, h1n);
    grid.sync();
    // LSTM 2 on [h1', h2]
    gate::stage(xT, h1n, U, 0, U);
    gate::stage(xT, h2c, U, U, U);
    __syncthreads();
    lstm(xT, a.g2, IN2, U, red, z, a.c2, h2n);
    grid.sync();
    if (a.variant != LSTM) {
      if (blockIdx.x < ROWS) attention(a, h2n, blockIdx.x, reinterpret_cast<float*>(smem));
      grid.sync();
    }
  }
  const __nv_bfloat16* h2f = a.h2 + (size_t)(a.T & 1) * hsz;
  for (int i = threadIdx.x; i < ROWS * 8; i += NT) {
    const size_t n = (size_t)(i / 8) * U + 8 * blockIdx.x + i % 8;
    a.out[n] = __bfloat162float(h2f[n]);
  }
}

}  // namespace

// g1 (256+512+U, 4U), g2 (2U, 4U), qk (U, 128), lk (32, 128), keys (32, 128, 128) bf16;
// values (32, 128, 512), mask (32, 128) f32; the state, updated in place: c1, c2 (32, U),
// h1, h2 (2, 32, U; [0] the start), ctx (32, 512) bf16, state (32, 256) f32; out (32, U)
// f32; U a multiple of 64, at least 256 (a block for each attention row); info (2 ints,
// host memory): blocks a SM and SMs, written when U/8 blocks cannot be co-resident.
// Returns a cudaError_t (0: launched).
extern "C" int probe_microbench(const __nv_bfloat16* g1, const __nv_bfloat16* g2,
                                const __nv_bfloat16* qk, const __nv_bfloat16* lk,
                                const __nv_bfloat16* keys, const float* values,
                                const float* mask, __nv_bfloat16* c1, __nv_bfloat16* h1,
                                __nv_bfloat16* c2, __nv_bfloat16* h2, __nv_bfloat16* ctx,
                                float* state, float* out, long long U, long long T,
                                long long variant, int* info, cudaStream_t stream) {
  if (U % 64 || U < 256 || U > 1024 || T < 0 || variant < 0 || variant > ATT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(U > 256 + E ? 2 * U : 256 + E + U) * ROWS * 2
                      + sizeof(float) * (gate::SLICES * ROWS * COLS + ROWS * COLS);
  cudaError_t err = cudaFuncSetAttribute(
      microbench_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, per_sm = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, microbench_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(U / 8);
  if ((long long)per_sm * sms < blocks) {
    info[0] = per_sm;
    info[1] = sms;
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Args a{g1, g2, qk, lk, keys, values, mask, c1, h1, c2, h2, ctx, state, out,
         (int)U, (int)T, (int)variant};
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)microbench_kernel, dim3(blocks), dim3(NT),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
