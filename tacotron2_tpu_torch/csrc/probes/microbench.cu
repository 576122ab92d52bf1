// B11: the Tacotron decoder step's pieces in a loop of T steps, on Hopper's tensor cores.
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
// Design. One persistent launch of U/8 CTAs of 256 threads in clusters of CL = 2 (U/16
// clusters, 64 at U = 1,024), all co-resident (the wrapper checks the occupancy first: the
// card keeps 30 clusters of 4 at this shared memory, too few, and 66 of 2). A grid
// barrier of our own (an arrival counter in global memory) separates the dependent
// stages, three a step: LSTM 1 -> LSTM 2 -> attention -> the next LSTM 1 (two for
// `lstm`). Each barrier is split: a CTA arrives, runs work whose inputs are already
// there, then waits.
//  - The LSTM products run on the tensor cores (mma.sync.m16n8k16, bf16 operands, f32
//    accumulation). Cluster c owns units 16c .. 16c+15: the 64 gate columns q U + 16c + i
//    (q < 4, i < 16) of both LSTMs. Its two CTAs split each product's K (a K-split): CTA
//    r multiplies a half of every segment of the input, [zeros | ctx | h1] and [h1' | h2],
//    for all 64 columns (warp w: rows 16 (w % 2) .., gate w / 2, two 8-column tiles), and
//    sends each 32 x 8-unit partial to the CTA that owns those units (unit group g: rank
//    g) through distributed shared memory; the owner adds the halves in rank order,
//    rounds z to bf16 and updates its 8 units' cells (held in registers for the whole
//    launch). So x is staged a half a CTA: each line of it is read by U/16 CTAs, not U/8.
//  - Weights. g1 + g2 are 31.5 MB at U = 1,024, more than the card's shared memory. Each
//    CTA keeps as mma B fragments, for the whole launch: its half of g2's columns of the
//    cluster (128 KB) and of g1's ctx rows (32 KB), the products on the chain. Its part of
//    g1's zeros and h1 rows (80 KB) it writes once, at the start, into a global scratch in
//    fragment order (its own slice, contiguous) and streams back each step with cp.async,
//    SLOT_KT k-tiles a slot, NSLOT slots in flight, off the chain (below). The zero rows
//    of x0 are multiplied as the script multiplies them, from zero A fragments in
//    registers, not staged.
//  - Off the chain. LSTM 2's h2 rows (h2 of the step before) run between LSTM 1's arrival
//    at its barrier and the wait, and the next step's LSTM 1 zeros and h1 rows between
//    LSTM 2's arrival and its wait, each into its own accumulators; the chain's k-tiles
//    are added to those in a fixed order (zeros, h1, then ctx; h2, then h1').
//  - The attention, spread over the grid: the cluster gathers its 16 units of h2' in every
//    CTA (distributed shared memory), and CTA r multiplies them by their 16 rows of qk,
//    columns 64r .. 64r+63, into a fixed slot of pq partials (one a cluster) before the
//    barrier; cluster c then takes rows c, c + U/16, ... (at U = 1,024 clusters 32-63 have
//    no row), its CTA r the encoder steps 64r .. 64r+63: pq summed over the slots in
//    cluster order; `att`: the location feature of each step from the state (f32, as the
//    script adds), the location features by lk on the tensor cores (the feature in all F
//    columns of A, as the script repeats it), e = sum_D tanh(keys + pq + pl) (a warp's 64
//    d by shuffles, then the two warps in order); `attlite`: e = bf16(pq) @ keys[0] on the
//    tensor cores; the cluster exchanges its e through distributed shared memory, every CTA
//    takes the same softmax (one warp, fixed order), writes its steps' alignments into the
//    state and a half of the context (the script's elementwise sum over T_in, in f32 on
//    the CUDA cores as the TPU kernel sums it on its vector unit: values are f32).
//
// What bounds it. A step's two gate products are 32 x (1,792 + 2,048) x 4,096 = 503 M
// multiply-adds (1.02 us at the bf16 tensor-core peak); the attention adds 21 M. What a
// step pays here is latency: three grid barriers, three or four cluster barriers,
// staging each half of x from L2, the chain's k-tiles (16 of LSTM 1 and 32 of LSTM 2 at
// U = 1,024, two mma each a warp), and g1's streamed rows where they do not fit under a
// barrier's wait.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Variant { LSTM, ATTLITE, ATT };
constexpr int NT = 256;          // threads a CTA: 8 warps
constexpr int ROWS = 32;         // the batch
constexpr int CL = 2;            // CTAs a cluster: the K-split
constexpr int UPC = 8 * CL;      // units a cluster
constexpr int NTL = 4 * CL;      // 8-column tiles a CTA multiplies: gate q, unit group g
constexpr int FRAG_KT = NTL * 32;  // B fragments (uint2) of a k-tile of a CTA
constexpr int KT_BYTES = FRAG_KT * 8;
constexpr int ZK = 16 / CL, CK = 32 / CL;  // k-tiles of x0's zeros and of its ctx a CTA
constexpr int XPAD = 8;          // bf16 of padding after each staged row (ldmatrix: no conflicts)
constexpr int SLOT_KT = 4;       // k-tiles of g1's streamed rows a slot
constexpr int NSLOT = 3;         // slots in flight
static_assert(NSLOT == 3, "lstm1_streamed's cp.async.wait_group counts NSLOT - 1");
constexpr int HGW = UPC + XPAD;  // a row of the cluster's gathered h2'
constexpr int T_IN = 128, E = 512, D = 128, KLOC = 31;
constexpr int SW = T_IN + 128;   // state row width; alignments at [64, 64 + T_IN)
constexpr int DPC = D / CL;      // pq columns a CTA
constexpr int TPC = T_IN / CL;   // encoder steps a CTA in the attention
constexpr int MTA = TPC / 16;    // their m-tiles
constexpr int WGA = 8 / MTA;     // warps an m-tile of the location features
constexpr int NPW = 16 / WGA;    // ... and the D-tiles each of them takes
constexpr int ECOLS = E / CL;    // context columns a CTA
constexpr int CSL = NT / (ECOLS / 4);  // step slices of the context

struct Args {
  const __nv_bfloat16 *g1, *g2, *qk, *lk, *keys;
  const float *values, *mask;
  __nv_bfloat16 *c1, *h1, *c2, *h2, *ctx;  // h1, h2: (2, 32, U)
  float *state, *out;
  uint2* w1s;      // (U/8, ZK + U/(16 CL), FRAG_KT) g1's streamed B fragments, written here
  float* pqs;      // (U/UPC, 32, D) the clusters' pq partials
  unsigned* bar;   // the grid barrier's arrivals, 0 at the launch
  int U, T, variant;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16 sigmoid as the script computes it: each op rounded, one / (one + exp(-x))
__device__ __forceinline__ float sig16(float x) {
  return bf16r(1.f / bf16r(1.f + bf16r(expf(-x))));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// The B fragment of mma.sync.m16n8k16 for `lane` of the 16 x 8 tile of w (row-major,
// leading dimension ld) at rows k0 .., columns col0 ..: rows k0 + 2 (lane % 4) + {0, 1}
// and + {8, 9} of column col0 + lane / 4.
__device__ __forceinline__ uint2 fragment(const __nv_bfloat16* w, int ld, int k0, int col0,
                                          int lane) {
  const int k = k0 + 2 * (lane % 4);
  const __nv_bfloat16* p = w + (size_t)k * ld + col0 + lane / 4;
  return make_uint2(pack2(p[0], p[ld]), pack2(p[8 * (size_t)ld], p[9 * (size_t)ld]));
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the A fragment of a 16 x 16 tile in shared memory: lane l gives the address of row
// l % 16, columns (l / 16) * 8 .. +7
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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The grid barrier, split. Arrive: every thread's writes before it, then one arrival.
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
  }
}

// Wait until `target` arrivals; a barrier that some CTA never reaches (it cannot happen
// while every CTA is resident, which the wrapper checks) traps after about 10 s instead
// of hanging the card.
__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    unsigned v;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
      if (v >= target) break;
      if (clock64() - t0 > 20000000000LL) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// 32 rows x `width` bf16 columns of src (leading dimension ld) into columns dcol .. of xs
// (rows of ldx), 16-byte cp.async copies; width a multiple of 8.
__device__ __forceinline__ void stage(__nv_bfloat16* xs, int ldx, int dcol,
                                      const __nv_bfloat16* src, int ld, int width) {
  const int n8 = width / 8;
  for (int i = threadIdx.x; i < ROWS * n8; i += NT) {
    const int r = i / n8, c = (i % n8) * 8;
    cp_async16(xs + (size_t)r * ldx + dcol + c, src + (size_t)r * ld + c);
  }
}

// The warp's A fragment of k-tile kt of the staged x (rows 16 mt ..).
__device__ __forceinline__ void a_tile(uint32_t a[4], const __nv_bfloat16* xs, int ldx,
                                       int kt, int mt, int lane) {
  ldmatrix_x4(a, xs + (size_t)(16 * mt + lane % 16) * ldx + (lane / 16) * 8 + 16 * kt);
}

// d[g] += A B for the warp's tiles: gate q, unit groups g < CL (tile q CL + g) of the B
// fragments wf of one k-tile
__device__ __forceinline__ void mma_gates(float d[CL][4], const uint32_t a[4],
                                          const uint2* wf, int q, int lane) {
#pragma unroll
  for (int g = 0; g < CL; ++g) mma_bf16(d[g], a, wf[(q * CL + g) * 32 + lane]);
}

// d += the staged x's k-tiles [0, n) (from column 16 x0 on) times the B fragments wf
__device__ __forceinline__ void mma_tiles(float d[CL][4], const __nv_bfloat16* xs, int ldx,
                                          int x0, const uint2* wf, int n, int mt, int q,
                                          int lane) {
#pragma unroll 2
  for (int kt = 0; kt < n; ++kt) {
    uint32_t a[4];
    a_tile(a, xs, ldx, x0 + kt, mt, lane);
    mma_gates(d, a, wf + (size_t)kt * FRAG_KT, q, lane);
  }
}

__device__ __forceinline__ void zero(float d[CL][4]) {
#pragma unroll
  for (int g = 0; g < CL; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[g][e] = 0.f;
}

// The partials d (rows 16 mt .., gate q, unit groups g < CL) into part[rank][row][8q + ..]
// of the CTA that owns unit group g (rank g), through distributed shared memory.
__device__ __forceinline__ void send_partials(cg::cluster_group& cluster, float* part,
                                              const float d[CL][4], int rank, int mt,
                                              int q, int lane) {
  const int row = 16 * mt + lane / 4, col = 8 * q + 2 * (lane % 4);
#pragma unroll
  for (int g = 0; g < CL; ++g) {
    float* p = cluster.map_shared_rank(part, g) + (size_t)rank * ROWS * 32;
    *reinterpret_cast<float2*>(p + row * 32 + col) = make_float2(d[g][0], d[g][1]);
    *reinterpret_cast<float2*>(p + (row + 8) * 32 + col) = make_float2(d[g][2], d[g][3]);
  }
}

// The LSTM cell of (row, unit i of the CTA's 8) from the CL partials of its gates (added
// in rank order, rounded to bf16): c updated in place, h returned (bf16-rounded).
__device__ __forceinline__ float cell(const float* part, int row, int i, float& c) {
  float z[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* p = part + row * 32 + 8 * q + i;
    float s = p[0];
#pragma unroll
    for (int r = 1; r < CL; ++r) s += p[r * ROWS * 32];
    z[q] = bf16r(s);
  }
  const float a = bf16r(sig16(bf16r(z[2] + 1.f)) * c);
  const float b = bf16r(sig16(z[0]) * bf16r(tanhf(z[1])));
  c = bf16r(a + b);
  return bf16r(sig16(z[3]) * bf16r(tanhf(c)));
}

__global__ void __launch_bounds__(NT, 1) microbench_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = a.U, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mt = warp % 2, q = warp / 2, gid = lane / 4, tig = lane % 4;
  const int rank = (int)cluster.block_rank(), c = blockIdx.x / CL, NC = U / UPC;
  const int RPC = (ROWS + NC - 1) / NC;  // attention rows a cluster, at most
  const int KQ = U / CL;                 // columns of h1 or h2 staged a CTA
  const int HK = KQ / 16;                // ... their k-tiles
  const int KT1 = ZK + HK;               // g1's streamed k-tiles a CTA (zeros, h1)
  const int LDX = (KQ > 256 ? KQ : 256) + XPAD;  // a staged row
  const int N4 = 4 * U;

  uint2* W2 = reinterpret_cast<uint2*>(smem);          // (2 HK, FRAG_KT): h1' then h2
  uint2* W1C = W2 + (size_t)2 * HK * FRAG_KT;          // (CK, FRAG_KT) g1's ctx rows
  uint2* RING = W1C + (size_t)CK * FRAG_KT;            // (NSLOT, SLOT_KT, FRAG_KT)
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(RING + (size_t)NSLOT * SLOT_KT * FRAG_KT);
  float* PART = reinterpret_cast<float*>(X + (size_t)ROWS * LDX);  // (CL, 32, 32)
  __nv_bfloat16* HG = reinterpret_cast<__nv_bfloat16*>(PART + CL * ROWS * 32);  // (32, HGW)
  float* EALL = reinterpret_cast<float*>(HG + ROWS * HGW);  // (RPC, T_IN) exchanged e
  // the attention's own scratch, over X (X is free from this CTA's wait at LSTM 2's
  // barrier to its arrival at the attention's)
  float* PQ = reinterpret_cast<float*>(X);  // (D)
  float* FC = PQ + D;                       // (TPC) location features of the CTA's steps
  float* EP = FC + TPC;                     // (WGA, TPC) e over each warp's D-tiles
  float* AL = EP + WGA * TPC;               // (T_IN) alignments
  float* CP = AL + T_IN;                    // (CSL, ECOLS) context partials

  // the global k-tile of local k-tile i: LSTM 1 streamed (zeros, then h1), LSTM 1 ctx,
  // LSTM 2 (h1', then h2)
  auto kt1s = [&](int i) { return i < ZK ? ZK * rank + i : 48 + HK * rank + i - ZK; };
  auto kt1c = [&](int i) { return 16 + CK * rank + i; };
  auto kt2 = [&](int i) { return i < HK ? HK * rank + i : U / 16 + HK * rank + i - HK; };
  // the first column of tile n: gate n / CL, unit group n % CL of the cluster
  auto col0 = [&](int n) { return (n / CL) * U + UPC * c + 8 * (n % CL); };

  // --- once: the B fragments (resident and streamed), the attention's in registers ---
  uint2* w1s = a.w1s + (size_t)blockIdx.x * KT1 * FRAG_KT;
  for (int i = tid; i < 2 * HK * FRAG_KT; i += NT)
    W2[i] = fragment(a.g2, N4, 16 * kt2(i / FRAG_KT), col0(i % FRAG_KT / 32), i % 32);
  for (int i = tid; i < CK * FRAG_KT; i += NT)
    W1C[i] = fragment(a.g1, N4, 16 * kt1c(i / FRAG_KT), col0(i % FRAG_KT / 32), i % 32);
  for (int i = tid; i < KT1 * FRAG_KT; i += NT)
    w1s[i] = fragment(a.g1, N4, 16 * kt1s(i / FRAG_KT), col0(i % FRAG_KT / 32), i % 32);
  // pq: qk's rows of the cluster's units, columns DPC r + 8 (2 q + j): 2 tiles a warp
  uint2 qkf[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    qkf[j] = fragment(a.qk, D, UPC * c, DPC * rank + 8 * (2 * q + j), lane);
  // att: lk (F x D), D-tiles NPW (warp / MTA) + j, k-tiles 0, 1: af[2j + kt]; attlite: the
  // first D rows of the flattened keys (D x T_in), steps TPC r + 8 warp ..: 8 k-tiles
  const int mta = warp % MTA, wga = warp / MTA;
  uint2 af[2 * NPW];
#pragma unroll
  for (int i = 0; i < 2 * NPW; ++i) {
    af[i] = make_uint2(0u, 0u);
    if (a.variant == ATT)
      af[i] = fragment(a.lk, D, 16 * (i % 2), 8 * (NPW * wga + i / 2), lane);
    else if (a.variant == ATTLITE && i < 8 && warp < TPC / 8)
      af[i] = fragment(a.keys, T_IN, 16 * i, TPC * rank + 8 * warp, lane);
  }
  // this thread's (row, unit): its cells in registers for the whole launch
  const int crow = tid / 8, ci = tid % 8, cu = UPC * c + 8 * rank + ci;
  float c1 = __bfloat162float(a.c1[(size_t)crow * U + cu]);
  float c2 = __bfloat162float(a.c2[(size_t)crow * U + cu]);
  float hlast = __bfloat162float(a.h2[(size_t)crow * U + cu]);
  const size_t hsz = (size_t)ROWS * U;
  __threadfence();  // the streamed fragments, before cp.async reads them back
  __syncthreads();

  // g1's streamed k-tiles into d: the zeros' from zero A fragments, the h1 quarter's from
  // X; SLOT_KT k-tiles a slot, NSLOT slots in flight, one commit group each (empty past
  // the last), after X's group
  auto lstm1_streamed = [&](float d[CL][4], const __nv_bfloat16* h1x) {
    constexpr int SLOT = SLOT_KT * FRAG_KT;  // uint2 a slot: two 16-byte copies a thread
    stage(X, LDX, 0, h1x + KQ * rank, U, KQ);
    cp_commit();
    auto fill = [&](int s, int j) {
      for (int i = 2 * tid; i < SLOT; i += 2 * NT)
        cp_async16(RING + (size_t)s * SLOT + i, w1s + (size_t)j * SLOT + i);
    };
    const int nslots = KT1 / SLOT_KT;
    for (int s = 0; s < NSLOT; ++s) {
      if (s < nslots) fill(s, s);
      cp_commit();
    }
    for (int j = 0; j < nslots; ++j) {
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");  // NSLOT - 1 in flight
      __syncthreads();
      const uint2* wf = RING + (size_t)(j % NSLOT) * SLOT;
#pragma unroll
      for (int kk = 0; kk < SLOT_KT; ++kk) {
        const int i = j * SLOT_KT + kk;
        uint32_t ax[4] = {0u, 0u, 0u, 0u};  // x0's zero rows
        if (i >= ZK) a_tile(ax, X, LDX, i - ZK, mt, lane);
        mma_gates(d, ax, wf + (size_t)kk * FRAG_KT, q, lane);
      }
      __syncthreads();  // every warp done with the slot
      if (j + NSLOT < nslots) fill(j % NSLOT, j + NSLOT);
      cp_commit();
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  };

  float d1[CL][4], d2[CL][4];
  zero(d1);
  lstm1_streamed(d1, a.h1);  // step 0's, from the start's h1
  unsigned arrivals = 0;
  const unsigned nb = gridDim.x;

  for (int t = 0; t < a.T; ++t) {
    __nv_bfloat16* h1n = a.h1 + (size_t)((t + 1) & 1) * hsz;
    const __nv_bfloat16* h2c = a.h2 + (size_t)(t & 1) * hsz;
    __nv_bfloat16* h2n = a.h2 + (size_t)((t + 1) & 1) * hsz;

    // --- LSTM 1 on the chain: the ctx half's k-tiles, then the cells ---
    stage(X, LDX, 0, a.ctx + 16 * CK * rank, E, 16 * CK);
    cp_commit();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    mma_tiles(d1, X, LDX, 0, W1C, CK, mt, q, lane);
    send_partials(cluster, PART, d1, rank, mt, q, lane);
    cluster_sync();
    {
      const float h = cell(PART, crow, ci, c1);
      h1n[(size_t)crow * U + cu] = __float2bfloat16(h);
    }
    grid_arrive(a.bar);
    arrivals += nb;
    // off the chain: LSTM 2's h2 half (h2 of the step before)
    zero(d2);
    stage(X, LDX, 0, h2c + KQ * rank, U, KQ);
    cp_commit();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    mma_tiles(d2, X, LDX, 0, W2 + (size_t)HK * FRAG_KT, HK, mt, q, lane);
    grid_wait(a.bar, arrivals);

    // --- LSTM 2 on the chain: the h1' half, then the cells ---
    stage(X, LDX, 0, h1n + KQ * rank, U, KQ);
    cp_commit();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    mma_tiles(d2, X, LDX, 0, W2, HK, mt, q, lane);
    send_partials(cluster, PART, d2, rank, mt, q, lane);
    cluster_sync();
    {
      const float h = cell(PART, crow, ci, c2);
      hlast = h;
      h2n[(size_t)crow * U + cu] = __float2bfloat16(h);
      if (a.variant != LSTM)  // the cluster's h2' into every CTA of it
        for (int p = 0; p < CL; ++p)
          cluster.map_shared_rank(HG, p)[crow * HGW + 8 * rank + ci] = __float2bfloat16(h);
    }
    if (a.variant != LSTM) {
      cluster_sync();
      // pq partial: the cluster's 16 units x their rows of qk, columns DPC r + 8 (2q + j)
      uint32_t ah[4];
      a_tile(ah, HG, HGW, 0, mt, lane);
      float* slot = a.pqs + (size_t)c * ROWS * D;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float dq[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(dq, ah, qkf[j]);
        const int row = 16 * mt + gid, col = DPC * rank + 8 * (2 * q + j) + 2 * tig;
        *reinterpret_cast<float2*>(slot + row * D + col) = make_float2(dq[0], dq[1]);
        *reinterpret_cast<float2*>(slot + (row + 8) * D + col) = make_float2(dq[2], dq[3]);
      }
    }
    grid_arrive(a.bar);
    arrivals += nb;
    // off the chain: the next step's streamed LSTM 1 k-tiles, from h1' of this step
    zero(d1);
    if (t + 1 < a.T) lstm1_streamed(d1, h1n);
    grid_wait(a.bar, arrivals);
    if (a.variant == LSTM) continue;

    // --- the attention: cluster c's rows, CTA r's steps TPC r .. ---
    for (int rr = 0; rr < RPC && c + NC * rr < ROWS; ++rr) {
      const int b = c + NC * rr, t0 = TPC * rank;
      if (tid < D) {  // pq, the clusters' slots in order
        float s = 0.f;
        for (int cc = 0; cc < NC; ++cc) s += a.pqs[((size_t)cc * ROWS + b) * D + tid];
        PQ[tid] = s;
      }
      float* st = a.state + (size_t)b * SW;
      if (a.variant == ATT && tid < TPC) {
        float fc = 0.f;
        for (int j = 0; j < KLOC; ++j)
          fc = __fadd_rn(fc, __fmul_rn(st[64 - 15 + j + t0 + tid], 0.01f));
        FC[tid] = bf16r(fc);
      }
      __syncthreads();
      float e = 0.f;  // this CTA's e of step t0 + tid (tid < TPC)
      if (a.variant == ATT) {
        // pl = [fc ... fc] (the CTA's steps x F) @ lk on the tensor cores: rows 16 mta ..,
        // D-tiles NPW wga + j; then tanh((keys + pq) + pl) summed over the warp's D-tiles
        float s0 = 0.f, s1 = 0.f;
        const int tr = 16 * mta + gid;
        const uint32_t lo = pack2f(FC[tr], FC[tr]), hi = pack2f(FC[tr + 8], FC[tr + 8]);
        const uint32_t fa[4] = {lo, hi, lo, hi};
        const __nv_bfloat16* k0 = a.keys + ((size_t)b * T_IN + t0 + tr) * D;
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          float dl[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(dl, fa, af[2 * j]);
          mma_bf16(dl, fa, af[2 * j + 1]);
          const int d = 8 * (NPW * wga + j) + 2 * tig;
          const float2 ka = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k0 + d));
          const float2 kb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(k0 + 8 * D + d));
          s0 += tanhf((ka.x + PQ[d]) + dl[0]) + tanhf((ka.y + PQ[d + 1]) + dl[1]);
          s1 += tanhf((kb.x + PQ[d]) + dl[2]) + tanhf((kb.y + PQ[d + 1]) + dl[3]);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (tig == 0) {
          EP[wga * TPC + tr] = s0;
          EP[wga * TPC + tr + 8] = s1;
        }
        __syncthreads();
        if (tid < TPC) {
          e = EP[tid];
#pragma unroll
          for (int w = 1; w < WGA; ++w) e += EP[w * TPC + tid];
          if (!(a.mask[(size_t)b * T_IN + t0 + tid] > 0.f)) e = -1e9f;
        }
      } else {
        // e = bf16(pq) (row 0 of A; rows 1-15 zero) @ keys[0] as (D, T_in): warp w takes
        // steps t0 + 8w .., the 8 k-tiles of D
        if (warp < TPC / 8) {
          float de[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 8; ++kt) {
            const int d = 16 * kt + 2 * tig;
            const uint32_t r0 = gid == 0 ? pack2f(PQ[d], PQ[d + 1]) : 0u;
            const uint32_t r8 = gid == 0 ? pack2f(PQ[d + 8], PQ[d + 9]) : 0u;
            const uint32_t fa[4] = {r0, 0u, r8, 0u};
            mma_bf16(de, fa, af[kt]);
          }
          if (gid == 0) {
            EP[8 * warp + 2 * tig] = de[0];
            EP[8 * warp + 2 * tig + 1] = de[1];
          }
        }
        __syncthreads();
        if (tid < TPC) e = EP[tid];
      }
      if (tid < TPC)  // this CTA's e into every CTA of the cluster
        for (int p = 0; p < CL; ++p) cluster.map_shared_rank(EALL, p)[rr * T_IN + t0 + tid] = e;
      cluster_sync();
      if (warp == 0) {  // the softmax over all T_in steps, the same in every CTA
        const float* ea = EALL + rr * T_IN;
        float v[4], m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = ea[lane + 32 * j];
          m = fmaxf(m, v[j]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = expf(v[j] - m);
          s += v[j];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
#pragma unroll
        for (int j = 0; j < 4; ++j) AL[lane + 32 * j] = v[j] / s;
      }
      __syncthreads();
      if (a.variant == ATT && tid < TPC) st[64 + t0 + tid] = st[64 + t0 + tid] + AL[t0 + tid];
      {
        // the context's columns ECOLS r ..: 4 a thread over T_IN / CSL steps, CSL step
        // slices added in order
        constexpr int NG = ECOLS / 4, TS = T_IN / CSL;
        const int grp = tid % NG, sl = tid / NG, col = ECOLS * rank + 4 * grp;
        const float* vb = a.values + ((size_t)b * T_IN + TS * sl) * E + col;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
        for (int j = 0; j < TS; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(vb + (size_t)j * E);
          const float al = AL[TS * sl + j];
          acc.x = fmaf(al, v.x, acc.x);
          acc.y = fmaf(al, v.y, acc.y);
          acc.z = fmaf(al, v.z, acc.z);
          acc.w = fmaf(al, v.w, acc.w);
        }
        *reinterpret_cast<float4*>(CP + sl * ECOLS + 4 * grp) = acc;
        __syncthreads();
        for (int i = tid; i < ECOLS; i += NT) {
          float s = CP[i];
          for (int k = 1; k < CSL; ++k) s += CP[k * ECOLS + i];
          a.ctx[(size_t)b * E + ECOLS * rank + i] = __float2bfloat16(s);
        }
        __syncthreads();
      }
    }
    grid_arrive(a.bar);
    arrivals += nb;
    grid_wait(a.bar, arrivals);
  }
  a.c1[(size_t)crow * U + cu] = __float2bfloat16(c1);
  a.c2[(size_t)crow * U + cu] = __float2bfloat16(c2);
  a.out[(size_t)crow * U + cu] = hlast;
  cluster_sync();  // no CTA leaves while a peer may still write its shared memory
}

size_t smem_bytes(int U) {
  const int KQ = U / CL, HK = KQ / 16, NC = U / UPC;
  const size_t frags = ((size_t)2 * HK + CK + NSLOT * SLOT_KT) * KT_BYTES;
  const size_t x = (size_t)ROWS * ((KQ > 256 ? KQ : 256) + XPAD) * 2;
  return frags + x + (size_t)CL * ROWS * 32 * 4 + (size_t)ROWS * HGW * 2
         + (size_t)((ROWS + NC - 1) / NC) * T_IN * 4;
}

}  // namespace

// g1 (256+512+U, 4U), g2 (2U, 4U), qk (U, 128), lk (32, 128), keys (32, 128, 128) bf16;
// values (32, 128, 512), mask (32, 128) f32; the state, updated in place: c1, c2 (32, U),
// h1, h2 (2, 32, U; [0] the start), ctx (32, 512) bf16, state (32, 256) f32; out (32, U)
// f32; scratch: w1s ((U/8) (8 + U/32) 256 x 8 bytes), pqs ((U/16) 32 128 f32), bar (one
// u32, zero); U = 256, 512 or 1,024. info (2 ints, host memory): clusters of CL the card
// keeps resident and the clusters needed, written when they are too few. Returns a
// cudaError_t (0: launched).
extern "C" int probe_microbench(const __nv_bfloat16* g1, const __nv_bfloat16* g2,
                                const __nv_bfloat16* qk, const __nv_bfloat16* lk,
                                const __nv_bfloat16* keys, const float* values,
                                const float* mask, __nv_bfloat16* c1, __nv_bfloat16* h1,
                                __nv_bfloat16* c2, __nv_bfloat16* h2, __nv_bfloat16* ctx,
                                float* state, float* out, void* w1s, float* pqs,
                                unsigned* bar, long long U, long long T, long long variant,
                                int* info, cudaStream_t stream) {
  if ((U != 256 && U != 512 && U != 1024) || T < 0 || variant < 0 || variant > ATT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes((int)U);
  cudaError_t err = cudaFuncSetAttribute(
      microbench_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(U / 8));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, microbench_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < U / UPC) {  // the grid barrier needs every CTA resident
    info[0] = clusters;
    info[1] = (int)(U / UPC);
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Args a{g1, g2, qk, lk, keys, values, mask, c1, h1, c2, h2, ctx, state, out,
         static_cast<uint2*>(w1s), pqs, bar, (int)U, (int)T, (int)variant};
  err = cudaLaunchKernelEx(&cfg, microbench_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
