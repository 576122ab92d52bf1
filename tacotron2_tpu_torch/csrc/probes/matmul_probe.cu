// B10: the Tacotron decoder's LSTM gate matmul in a loop of T steps, on Hopper.
//
// Replaces the Pallas TPU kernel of scripts/dev_pallas_matmul_probe.py:27-81 (`build`,
// the pl.pallas_call at :72): x (32, IN1) bf16 times w (IN1, 4U) bf16, f32 accumulation,
// T steps inside one launch, in seven variants (indep, dep_f32, dep_bf16, dep_T, ksplit,
// k4split, nsplit; tacotron2_tpu_torch/probes/matmul_probe.py says what each computes).
//
// Design. One persistent cooperative launch of U/8 blocks (128 at U = 1,024), all
// co-resident (the wrapper's launch checks the occupancy and fails with the numbers).
// Block j owns the columns q*U + 8j + i (gate_matmul.cuh), so the update of x[:, 8j ..
// 8j+7], nsplit's product of columns c and 2U+c included, needs no other block's
// product. x lives in global memory twice: step t reads buffer t % 2 into shared
// memory (transposed), computes its 32 columns of the product, writes its 8 columns of
// the next x into buffer (t+1) % 2, and the grid barrier (cooperative_groups
// this_grid().sync()) lets the next step read them. `indep` has no dependency: x is
// staged once and no barrier runs. The whole (32, 4U) product is computed every step
// (the TPU kernel's work) and the last one is written out. dep_T reads the transposed
// copy wt (4U, IN1): a warp covers the block's 32 columns, a thread one column and a
// K-slice, with 16-byte loads along k.
//
// What bounds it. A step is 32 x 1,792 x 4,096 = 235 M multiply-adds: 0.475 us at the
// bf16 tensor-core peak, while w (14.7 MB, read once a launch) is 4.4 us of HBM time for
// the whole loop. This first kernel does its multiply-adds in f32 on the CUDA cores (67
// TFLOP/s: 7 us a step at best) and pays a grid barrier a step; tensor-core mma
// (wgmma) over the staged x is the way to the bound, left for later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gate_matmul.cuh"

namespace cg = cooperative_groups;

namespace {

enum Variant { INDEP, DEP_F32, DEP_BF16, DEP_T, KSPLIT, K4SPLIT, NSPLIT };
using gate::COLS;
using gate::NT;
using gate::ROWS;
using gate::bf16r;

// dep_T's product: the block's 32 columns of wt (4U, IN1) rows, 16-byte loads along k.
// Thread tid: column col = tid % 32 (q = col / 8, i = col % 8), K-slice ks = tid / 32.
__device__ __forceinline__ void product_t(const __nv_bfloat16* xT,
                                          const __nv_bfloat16* __restrict__ wt, int K, int U,
                                          float* red) {
  const int tid = threadIdx.x, col = tid & 31, ks = tid >> 5;
  const int kn = K / gate::SLICES;
  const __nv_bfloat16* wr = wt + (size_t)((col / 8) * U + 8 * blockIdx.x + col % 8) * K;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int k = ks * kn; k < (ks + 1) * kn; k += 8) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wr + k));
    const __nv_bfloat16* we = reinterpret_cast<const __nv_bfloat16*>(&wv);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float wf = __bfloat162float(we[m]);
      const __nv_bfloat16* xk = xT + (size_t)(k + m) * ROWS;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(__bfloat162float(xk[r]), wf, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) red[(ks * ROWS + r) * COLS + col] = acc[r];
}

__global__ void __launch_bounds__(NT) matmul_probe_kernel(
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ wt,
    __nv_bfloat16* xs, float* __restrict__ out, float* __restrict__ prod, int U, int IN1,
    int T, int variant) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xT = reinterpret_cast<__nv_bfloat16*>(smem);            // IN1 x 32
  float* red = reinterpret_cast<float*>(smem + (size_t)IN1 * ROWS * 2);  // 8 x 32 x 32
  float* z = red + gate::SLICES * ROWS * COLS;                           // 32 x 32
  float* acc = z + ROWS * COLS;                                          // 32 x 8 (indep)
  const int tid = threadIdx.x, j = blockIdx.x;
  const size_t xsz = (size_t)ROWS * IN1;

  // x = 0.01 in both buffers, striped over the grid; indep's sums start at zero
  const __nv_bfloat16 init = __float2bfloat16(0.01f);
  for (size_t i = (size_t)j * NT + tid; i < 2 * xsz; i += (size_t)gridDim.x * NT) xs[i] = init;
  for (int i = tid; i < ROWS * 8; i += NT) acc[i] = 0.f;
  grid.sync();

  const int split = variant == KSPLIT ? 2 : variant == K4SPLIT ? 4 : 1;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* xc = xs + (size_t)(t & 1) * xsz;
    __nv_bfloat16* xn = xs + (size_t)((t + 1) & 1) * xsz;
    if (variant != INDEP || t == 0) gate::stage(xT, xc, IN1, 0, IN1);
    __syncthreads();
    if (variant == DEP_T)
      product_t(xT, wt, IN1, U, red);
    else
      gate::product(xT, w, IN1, U, red);
    __syncthreads();
    gate::combine(red, z, split);
    __syncthreads();
    // the update of the block's 8 columns of x[:, :U] (of indep's sums), one a thread
    {
      const int r = tid / 8, i = tid % 8, c = 8 * j + i;
      const float zc = z[r * COLS + i];
      if (variant == INDEP) {
        acc[tid] += zc;
      } else {
        float v;
        if (variant == DEP_BF16)
          v = tanhf(bf16r(zc));
        else if (variant == NSPLIT)
          v = tanhf(zc * z[r * COLS + 16 + i]);
        else
          v = tanhf(zc);
        xn[(size_t)r * IN1 + c] = __float2bfloat16(v);
      }
    }
    if (t == T - 1) {  // the last step's whole product
      for (int o = tid; o < ROWS * COLS; o += NT) {
        const int r = o / COLS, col = o % COLS;
        const float v = z[o];
        prod[(size_t)r * 4 * U + (col / 8) * U + 8 * j + col % 8] =
            variant == DEP_BF16 ? bf16r(v) : v;
      }
    }
    if (variant != INDEP) grid.sync();
  }
  // the output: x[:, :U] (indep: the sums) padded with zeros to (32, 4U)
  const __nv_bfloat16* xf = xs + (size_t)(T & 1) * xsz;
  for (int o = tid; o < ROWS * COLS; o += NT) {
    const int r = o / COLS, col = o % COLS, q = col / 8, i = col % 8;
    float v = 0.f;
    if (q == 0)
      v = variant == INDEP ? acc[r * 8 + i] : __bfloat162float(xf[(size_t)r * IN1 + 8 * j + i]);
    out[(size_t)r * 4 * U + q * U + 8 * j + i] = v;
  }
}

}  // namespace

// w (IN1, 4U), wt (4U, IN1) bf16; xs (2, 32, IN1) bf16 scratch; out, prod (32, 4U) f32;
// info (2 ints, host memory): blocks a SM and SMs, written when U/8 blocks cannot be
// co-resident. Returns a cudaError_t (0: launched).
extern "C" int probe_matmul(const __nv_bfloat16* w, const __nv_bfloat16* wt,
                            __nv_bfloat16* xs, float* out, float* prod, long long U,
                            long long IN1, long long T, long long variant, int* info,
                            cudaStream_t stream) {
  if (U % 8 || IN1 % 64 || IN1 < U || T < 1 || variant < 0 || variant > NSPLIT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)IN1 * ROWS * 2
                      + sizeof(float) * (gate::SLICES * ROWS * COLS + ROWS * COLS + ROWS * 8);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, per_sm = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matmul_probe_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(U / 8);
  if ((long long)per_sm * sms < blocks) {
    info[0] = per_sm;
    info[1] = sms;
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  int u = (int)U, in1 = (int)IN1, steps = (int)T, v = (int)variant;
  void* args[] = {(void*)&w, (void*)&wt, (void*)&xs, (void*)&out, (void*)&prod,
                  (void*)&u, (void*)&in1, (void*)&steps, (void*)&v};
  err = cudaLaunchCooperativeKernel((const void*)matmul_probe_kernel, dim3(blocks), dim3(NT),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
