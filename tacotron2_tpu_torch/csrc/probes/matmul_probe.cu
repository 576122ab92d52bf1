// B10: the Tacotron decoder's LSTM gate matmul in a loop of T steps, on Hopper's tensor
// cores.
//
// Replaces the Pallas TPU kernel of scripts/dev_pallas_matmul_probe.py:27-81 (`build`,
// the pl.pallas_call at :72): x (32, IN1) bf16 times w (IN1, 4U) bf16, f32 accumulation,
// T steps inside one launch, in seven variants (indep, dep_f32, dep_bf16, dep_T, ksplit,
// k4split, nsplit; tacotron2_tpu_torch/probes/matmul_probe.py says what each computes).
//
// Design. One persistent cooperative launch of U/8 blocks of 256 threads (128 at U =
// 1,024), all co-resident (the wrapper's launch checks the occupancy and fails with the
// numbers). Block j owns the columns q*U + 8j + i (q < 4, i < 8: the four gates of units
// 8j .. 8j+7), so the update of x[:, 8j .. 8j+7], nsplit's product of columns c and
// 2U+c included, needs no other block's product.
//  - The weights stay on chip for the whole launch: at its start each block loads its
//    32 columns of w (of the transposed copy wt for dep_T), IN1 x 32 bf16 = 112 KB at
//    IN1 = 1,792, once, into shared memory laid out as the B fragments of
//    mma.sync.m16n8k16 (fragment (k-tile, gate, lane): k rows 16kt + 2(lane % 4) + {0, 1,
//    8, 9} of column gate*U + 8j + lane / 4; tests/test_torch_cluster.py holds this
//    layout to the mma's B operand), one conflict-free 8-byte shared load a fragment.
//  - The product runs on the tensor cores in bf16 with f32 accumulation: warp w takes
//    rows 16 (w % 2) .. +15 and gate w / 2 over the whole K, an mma a k-tile, into four
//    accumulators: the k-tiles in turn (ksplit: two halves of two, added half by half;
//    k4split: four quarters, added in order), summed at the end.
//  - x comes from global memory each step: it lives there twice (step t reads buffer
//    t % 2; each block writes its 8 columns of the next x into buffer (t+1) % 2), and the
//    block stages all of it (32 x IN1 bf16, rows padded by 16 bytes so that ldmatrix
//    meets no bank conflict) next to the weights with cp.async, in four K-quarters of
//    one commit group each; the warps start on a quarter's k-tiles (A fragments read
//    with ldmatrix) as soon as it has landed, while the later quarters are in flight.
//    The step's product (32 x 32 f32) then takes the staged x's place for the update.
//  - The grid barrier (cooperative_groups this_grid().sync()) after each dependent
//    step lets the next step read the new x. `indep` has no dependency: it computes
//    the same product every step and runs no grid barrier.
// The whole (32, 4U) product is computed every step (the TPU kernel's work) and the
// last one is written out.
//
// What bounds it. A step is 32 x 1,792 x 4,096 = 235 M multiply-adds: 0.475 us at the
// bf16 tensor-core peak, while w (14.7 MB, read once a launch) is 4.4 us of HBM time for
// the whole loop. What a step pays here is latency: staging x (112 KB a block from L2,
// the k-tiles of a quarter overlapping the copies of the next), 112 k-tiles of ldmatrix
// + mma a warp (four chains), and the grid barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Variant { INDEP, DEP_F32, DEP_BF16, DEP_T, KSPLIT, K4SPLIT, NSPLIT };
constexpr int NT = 256;    // threads a block: 8 warps, one 16 x 8 tile of the product each
constexpr int ROWS = 32;   // activation rows (the batch)
constexpr int COLS = 32;   // columns a block owns
constexpr int XPAD = 8;    // bf16 of padding after each staged row of x

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The B fragment (k-tile kt, gate q, lane) of block j's columns: rows 16kt + 2(lane % 4)
// + {0, 1} and + {8, 9} of column q*U + 8j + lane / 4, of w (IN1, 4U) or wt (4U, IN1).
__device__ __forceinline__ uint2 load_fragment(const __nv_bfloat16* w,
                                               const __nv_bfloat16* wt, bool transposed,
                                               int K, int U, int kt, int q, int lane) {
  const int col = q * U + 8 * blockIdx.x + lane / 4, k0 = 16 * kt + 2 * (lane % 4);
  auto at = [&](int k) {
    return transposed ? wt[(size_t)col * K + k] : w[(size_t)k * 4 * U + col];
  };
  return make_uint2(pack2(at(k0), at(k0 + 1)), pack2(at(k0 + 8), at(k0 + 9)));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the A fragment of a 16 x 16 tile of x in shared memory: lane l gives the address of
// row l % 16, columns (l / 16) * 8 .. +7
__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// wait until at most n (0 to 3) of this thread's commit groups are still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// d[slot] += A B, the slot warp-uniform
__device__ __forceinline__ void mma_slot(float d[4][4], int slot, const uint32_t a[4],
                                         uint2 b) {
  switch (slot) {
    case 0: mma_bf16(d[0], a, b); break;
    case 1: mma_bf16(d[1], a, b); break;
    case 2: mma_bf16(d[2], a, b); break;
    default: mma_bf16(d[3], a, b); break;
  }
}

__global__ void __launch_bounds__(NT, 1) matmul_probe_kernel(
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ wt,
    __nv_bfloat16* xs, float* __restrict__ out, float* __restrict__ prod, int U, int IN1,
    int T, int variant) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int KT = IN1 / 16, LD = IN1 + XPAD;
  uint2* wf = reinterpret_cast<uint2*>(smem);  // (KT, 4, 32) B fragments
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(smem + (size_t)KT * 4 * 32 * 8);
  float* z = reinterpret_cast<float*>(xsm);  // (32, 32) the step's product, over x
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, j = blockIdx.x;
  const int mt = warp % 2, q = warp / 2;
  const size_t xsz = (size_t)ROWS * IN1;

  // the block's columns of w (of wt for dep_T), once a launch, as B fragments
  for (int i = tid; i < KT * 4 * 32; i += NT)
    wf[i] = load_fragment(w, wt, variant == DEP_T, IN1, U, i / 128, (i / 32) % 4, i % 32);
  // x = 0.01 in both buffers, striped over the grid
  const __nv_bfloat16 init = __float2bfloat16(0.01f);
  for (size_t i = (size_t)j * NT + tid; i < 2 * xsz; i += (size_t)gridDim.x * NT) xs[i] = init;
  float sum = 0.f;  // indep: this thread's element x[r][8j + i] of the summed products
  grid.sync();

  const int split = variant == KSPLIT ? 2 : variant == K4SPLIT ? 4 : 1;
  const __nv_bfloat16* arow = xsm + (size_t)(16 * mt + lane % 16) * LD + (lane / 16) * 8;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* xc = xs + (size_t)(t & 1) * xsz;
    __nv_bfloat16* xn = xs + (size_t)((t + 1) & 1) * xsz;
    // stage x in K-quarters, one commit group each: 16 bytes (8 columns) a copy
    const int n8 = IN1 / 32, KQ = IN1 / 4;
    for (int c = 0; c < 4; ++c) {
      for (int i = tid; i < ROWS * n8; i += NT) {
        const int r = i / n8, col = c * KQ + (i % n8) * 8;
        cp_async16(xsm + (size_t)r * LD + col, xc + (size_t)r * IN1 + col);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // the warp's 16 x 8 tile over K, on the tensor cores, each quarter as soon as it
    // has landed (the later quarters still in flight)
    // four accumulators: the k-tiles in turn (ksplit: two halves of two chains each,
    // k4split: four quarters of one chain each)
    float d[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[s][e] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cp_async_wait_pending(3 - c);
      __syncthreads();  // every thread's copies of quarter c
#pragma unroll 4
      for (int kt = c * (KT / 4); kt < (c + 1) * (KT / 4); ++kt) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + 16 * kt);
        const int slot = split == 1 ? kt % 4
                         : split == 2 ? 2 * (kt >= KT / 2) + kt % 2
                                      : c;
        mma_slot(d, slot, a, wf[(kt * 4 + q) * 32 + lane]);
      }
    }
    float zz[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      zz[e] = split == 4 ? ((d[0][e] + d[1][e]) + d[2][e]) + d[3][e]
                         : (d[0][e] + d[1][e]) + (d[2][e] + d[3][e]);
    __syncthreads();  // every warp done with the staged x: z takes its place
    {
      const int r = 16 * mt + lane / 4, c = 8 * q + 2 * (lane % 4);
      z[r * COLS + c] = zz[0];
      z[r * COLS + c + 1] = zz[1];
      z[(r + 8) * COLS + c] = zz[2];
      z[(r + 8) * COLS + c + 1] = zz[3];
    }
    __syncthreads();
    // the update of the block's 8 columns of x[:, :U] (of indep's sums), one a thread
    {
      const int r = tid / 8, i = tid % 8, c = 8 * j + i;
      const float zc = z[r * COLS + i];
      if (variant == INDEP) {
        sum += zc;
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
    __syncthreads();  // z read: the next step's x may take its place
    if (variant != INDEP) grid.sync();
  }
  // the output: x[:, :U] (indep: the sums) padded with zeros to (32, 4U)
  const __nv_bfloat16* xf = xs + (size_t)(T & 1) * xsz;
  for (int o = tid; o < ROWS * COLS; o += NT) {
    const int r = o / COLS, col = o % COLS, g = col / 8, i = col % 8;
    if (g == 0 && variant == INDEP) continue;  // this thread's sum, below
    out[(size_t)r * 4 * U + g * U + 8 * j + i] =
        g == 0 ? __bfloat162float(xf[(size_t)r * IN1 + 8 * j + i]) : 0.f;
  }
  if (variant == INDEP) out[(size_t)(tid / 8) * 4 * U + 8 * j + tid % 8] = sum;
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
  const size_t smem = (size_t)(IN1 / 16) * 4 * 32 * 8 + (size_t)ROWS * (IN1 + XPAD) * 2;
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
