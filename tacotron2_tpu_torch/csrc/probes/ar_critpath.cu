// B9: the WaveNet AR layer stack's step alone, two chains and four GLU forms, on Hopper.
//
// Replaces the Pallas TPU kernel of scripts/dev_pallas_ar_critpath.py:90-205 (`build`,
// the pl.pallas_call at :197): L layers of dilated causal taps (K taps, dilation
// 2**(i % (L/2)), one f32 ring buffer of (K-1)*d slots a layer), T steps inside one
// launch, `prev` = h * 1e-4 + skips * 1e-6 fed back; the chain `base` (per layer
// [taps | h] @ w_tap -> GLU -> @ w_os: two dependent matvecs) or `fused` (the past
// taps' products and the conditioning first, then per layer z_{l-1} @ w_fused +
// h_{l-2} @ w_cur, one matvec on the dependency chain, with z_{l-1} @ w_out and @ w_skip
// beside it), and for `fused` the GLU forms of the script (plain, bf16 transcendentals,
// tanh-sigmoid, tanh of the whole gate vector, that rounded to bf16 and combined in
// bf16). The activations that feed a matvec are rounded to bf16, f32 accumulation,
// as there; tacotron2_tpu_torch/probes/ar_critpath.py is the plain version.
//
// Design. One thread-block cluster of C = R/8 CTAs (16 at the script's R=128, a
// non-portable size) runs 8 rows of the batch (ceil(B/8) clusters; missing rows are
// zero columns that nothing reads back), and every product runs on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 sums) with the weights as the A operand (16 output
// columns) and the 8 rows as n: each weight is read once a step for all rows.
//  - Work split. CTA r owns the gate pairs 8r .. 8r+7 (one M-tile: the tanh half's 8
//    columns over the sigmoid half's, so that one lane holds both halves of its GLU),
//    and the residual and skip columns 8r .. 8r+7 (one M-tile of w_os, or of w_out over
//    w_skip); so it also owns those columns of h and of the skip sum, and `prev`.
//  - A step is a fixed schedule of phases, each ended by one cluster barrier
//    (barrier.cluster arrive.release / wait.acquire): `fused` L+1 a step (phase p: the
//    gates of layer p; the residual and skip of layer p-1; the last one makes `prev`),
//    `base` 2L (the gates of layer l, then its residual and skip). The wrapper
//    (probes/ar_critpath.py, `schedule`) writes the table of phases; this kernel
//    follows it. In a phase the gate warp runs its product from the exchanged inputs
//    of the phase before, the GLU, and writes its 8 columns of bf16 z into every CTA
//    (distributed shared memory, double-buffered by phase parity); the residual warp
//    runs its product, adds into h and the skip sum (registers), writes h into the
//    ring and its 8 columns of bf16 h into every CTA. Then the cluster meets.
//  - Off the chain. The past taps' product of the layer whose gates come next (the
//    conditioning row its start) runs on the gate warp between its arrival and its
//    wait, on taps that the loader warps staged two phases before (cp.async, f32, in
//    four buffers), so it costs no barrier of its own.
//  - Weights. The wrapper packs each CTA's tiles once per inputs, fragment-ordered
//    (a lane's 8 bf16 of an A fragment in 16 bytes), in the order the phases read
//    them. The loader warps stream each phase's block (at most 20 KB) into a ring of
//    four shared-memory slots two phases ahead with 16-byte cp.async; the products
//    read shared memory only.
//  - A sum's order is fixed (the k-tiles in order, on two accumulators: even and odd
//    tiles), so two runs give the same bits; it is not the plain version's order.
//
// What bounds it. A row-step is 2.6 M (`base`) or 3.1 M (`fused`) multiply-adds, 42-50
// MFLOP a step at B=8: 0.04-0.05 us at the bf16 tensor-core peak; the weights, read once
// a launch, are 1.6-1.9 us of HBM time. On the card the chain's latency sets the pace:
// L+1 (fused) or 2L (base) cluster barriers a step, each after a product of 8-16
// dependent k-tiles and a write into 16 peers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;             // 4 warps: gate, residual, two loaders
constexpr int LOADER0 = 64;         // the loaders' first thread
constexpr int ROWS = 8;             // batch rows a cluster (the mma's n)
constexpr int TILE_BYTES = 512;     // a 16 x 16 bf16 A tile: 32 lanes x 16 bytes
constexpr int SLOTS = 4;            // weight slots and tap buffers
constexpr int MAX_TILES = 64;       // tiles a phase block, at most (a slot's size)
constexpr int MAX_C = 16;
constexpr int REC = 11;             // ints a phase record (probes/ar_critpath.py RECORD)
constexpr int MAX_PHASES = 160;
enum Chain { BASE, FUSED };
enum Glu { PLAIN_GLU, BF16_GLU, TANHSIG, TANHFOLD, TF_BF16O };
// the fields of a phase record, in the wrapper's order
enum Field { GATE_LAYER, GATE_Z_TILES, GATE_H_TILES, OS_LAYER, OS_LAST, CONSTS_LAYER,
             CONSTS_NEXT_STEP, RING_LAYER, HB_SEND, TILE_OFF, TILE_COUNT };

struct Args {
  const uint4* tiles;  // (clusters' CTAs C, total tiles, 32 lanes) 16-byte A fragments
  const int* table;    // (PH, REC) the phases of a step
  const float* cond;   // (B, L*G)
  float* rings;        // (B, slots * R)
  float* out;          // (B, R)
  int L, R, G, K, T, B, slots, PH, total_tiles, slot_tiles;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The ring slot of a tap m steps back at step t, in a window of win slots.
__device__ __forceinline__ int tap_slot(int t, int win, int m) {
  return (t + win - m) % win;
}

__device__ __forceinline__ float sigmoid16(float x) {  // one / (one + exp(-x)), in bf16
  return bf16r(1.f / bf16r(1.f + bf16r(expf(-x))));
}

// The GLU of gate halves (za, zg), rounded to bf16 (the next matvec's input).
template <int GLU>
__device__ __forceinline__ float glu(float za, float zg) {
  if constexpr (GLU == PLAIN_GLU) {
    return bf16r(tanhf(za) * (1.f / (1.f + expf(-zg))));
  } else if constexpr (GLU == BF16_GLU) {
    return bf16r(bf16r(tanhf(bf16r(za))) * sigmoid16(bf16r(zg)));
  } else if constexpr (GLU == TANHSIG) {
    return bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(0.5f * zg)));
  } else if constexpr (GLU == TANHFOLD) {
    return bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(zg)));
  } else {  // TF_BF16O
    const float tg = bf16r(tanhf(zg));
    return bf16r(bf16r(tanhf(za)) * bf16r(0.5f + bf16r(0.5f * tg)));
  }
}

__device__ __forceinline__ void mma16816(float c[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The B fragment of k-tile kt of the bf16 rows x[n][k] (row stride ld elements): rows k
// 16 kt + 2 (lane % 4) + {0, 1} and + 8, column n = lane / 4 (ldmatrix, lanes 0-15 give
// the row addresses).
__device__ __forceinline__ void b_frag(const __nv_bfloat16* x, int ld, int kt, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* p = x + (lane % 8) * ld + 16 * kt + 8 * ((lane / 8) % 2);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(p)));
}

// ... of the f32 rows x[n][k], rounded to bf16 here (the staged taps)
__device__ __forceinline__ void b_frag_f32(const float* x, int ld, int kt, int lane,
                                           uint32_t& b0, uint32_t& b1) {
  const float* p = x + (lane / 4) * ld + 16 * kt + 2 * (lane % 4);
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(lo.x, lo.y);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(hi.x, hi.y);
  b0 = *reinterpret_cast<const uint32_t*>(&l2);
  b1 = *reinterpret_cast<const uint32_t*>(&h2);
}

// c += the product of `n` A tiles at a (fragment-ordered, a lane's 16 bytes apart) with
// the B fragments of k-tiles 0 .. n - 1 of x (bf16, stride ld), even tiles into c, odd
// ones into d (the caller adds d to c)
__device__ __forceinline__ void product(float c[4], float d[4], const uint4* a, int n,
                                        const __nv_bfloat16* x, int ld, int lane) {
  uint32_t b0, b1;
  int i = 0;
  for (; i + 1 < n; i += 2) {
    b_frag(x, ld, i, lane, b0, b1);
    mma16816(c, a[i * 32 + lane], b0, b1);
    b_frag(x, ld, i + 1, lane, b0, b1);
    mma16816(d, a[(i + 1) * 32 + lane], b0, b1);
  }
  if (i < n) {
    b_frag(x, ld, i, lane, b0, b1);
    mma16816(c, a[i * 32 + lane], b0, b1);
  }
}

// ... of f32 x (the staged taps, rounded to bf16 here); n even
__device__ __forceinline__ void product_f32(float c[4], float d[4], const uint4* a, int n,
                                            const float* x, int ld, int lane) {
  uint32_t b0, b1;
  for (int i = 0; i < n; i += 2) {
    b_frag_f32(x, ld, i, lane, b0, b1);
    mma16816(c, a[i * 32 + lane], b0, b1);
    b_frag_f32(x, ld, i + 1, lane, b0, b1);
    mma16816(d, a[(i + 1) * 32 + lane], b0, b1);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A lane's two values v0 (row n0 = 2 (lane % 4)) and v1 (row n0 + 1) of column 8 r + m
// (m = lane / 4) into column pairs at x[n][8 r + m'] in every CTA of the cluster, as
// bf16: lanes of even m write (m, m + 1) of row n0, odd m (m - 1, m) of row n0 + 1, one
// 32-bit store a peer.
__device__ __forceinline__ void send(cg::cluster_group& cluster, __nv_bfloat16* x, int ld,
                                     int r, float v0, float v1, int lane, int C) {
  const float o0 = __shfl_xor_sync(0xffffffffu, v0, 4);
  const float o1 = __shfl_xor_sync(0xffffffffu, v1, 4);
  const int m = lane / 4, n0 = 2 * (lane % 4);
  const bool even = m % 2 == 0;
  const __nv_bfloat162 w = even ? __floats2bfloat162_rn(v0, o0) : __floats2bfloat162_rn(o1, v1);
  const int off = (even ? n0 : n0 + 1) * ld + 8 * r + (even ? m : m - 1);
  const uint32_t word = *reinterpret_cast<const uint32_t*>(&w);
  for (int q = 0; q < C; ++q)
    *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(x + off, q)) = word;
}

template <int CHAIN, int GLU>
__global__ void __launch_bounds__(NT) critpath_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char sm_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int L = a.L, R = a.R, G = a.G, K = a.K, half = G / 2, PH = a.PH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x / C * ROWS, nb = min(ROWS, a.B - b0);
  const int XZ = half + 8, XH = R + 8, TS = (K - 1) * R + 8;  // padded row strides
  const int ST = a.slot_tiles;
  // shared memory: the weight slots, the tap buffers, the exchanged z and h (two
  // parities each), the conditioning of the owned columns, the phase table, the rings'
  // layout
  uint4* wslot = reinterpret_cast<uint4*>(sm_raw);  // SLOTS x ST x 32
  float* taps = reinterpret_cast<float*>(wslot + SLOTS * ST * 32);  // SLOTS x 8 x TS
  __nv_bfloat16* xz = reinterpret_cast<__nv_bfloat16*>(taps + SLOTS * ROWS * TS);  // 2x8xXZ
  __nv_bfloat16* xh = xz + 2 * ROWS * XZ;                                          // 2x8xXH
  float* condS = reinterpret_cast<float*>(xh + 2 * ROWS * XH);  // (L, 16, 8)
  int* table = reinterpret_cast<int*>(condS + L * 16 * ROWS);   // (PH, REC)
  int* win = table + PH * REC;                                  // (L)
  int* dil = win + L;                                           // (L)
  int* off = dil + L;                                           // (L)

  for (int i = tid; i < PH * REC; i += NT) table[i] = a.table[i];
  if (tid == 0) {
    int o = 0;
    for (int l = 0; l < L; ++l) {
      dil[l] = 1 << (l % (L / 2));
      win[l] = (K - 1) * dil[l];
      off[l] = o;
      o += win[l];
    }
  }
  // the owned columns' conditioning: M-tile row m is gate column 8 r + m (m < 8) or
  // half + 8 r + m - 8
  for (int i = tid; i < L * 16 * ROWS; i += NT) {
    const int l = i / (16 * ROWS), m = i / ROWS % 16, n = i % ROWS;
    const int col = m < 8 ? 8 * r + m : half + 8 * r + m - 8;
    condS[i] = n < nb ? a.cond[(size_t)(b0 + n) * L * G + l * G + col] : 0.f;
  }
  // every tap buffer and exchange row zero (the rows past nb stay so; step 0's taps are
  // the zeroed rings' and are not staged)
  for (int i = tid; i < SLOTS * ROWS * TS; i += NT) taps[i] = 0.f;
  for (int i = tid; i < 2 * ROWS * (XZ + XH); i += NT) xz[i] = __float2bfloat16(0.f);
  // this CTA's share of the cluster's rows' rings, zeroed
  const size_t ring_row = (size_t)a.slots * R;
  for (size_t i = (size_t)r * NT + tid; i < (size_t)nb * ring_row; i += (size_t)C * NT)
    a.rings[(size_t)b0 * ring_row + i] = 0.f;
  const uint4* my_tiles = a.tiles + (size_t)r * a.total_tiles * 32;
  cluster_arrive();  // every CTA's buffers zeroed (and running) before a peer writes them
  cluster_wait();

  // the loader's copies of phase q's weight block into slot s
  auto load_weights = [&](int q, int s) {
    const int* rec = table + q * REC;
    const uint4* src = my_tiles + (size_t)rec[TILE_OFF] * 32;
    uint4* dst = wslot + (size_t)s * ST * 32;
    for (int i = tid - LOADER0; i < rec[TILE_COUNT] * 32; i += NT - LOADER0)
      cp_async16(dst + i, src + i);
  };
  // ... of the past taps that the consts of phase q (of step tq) read, into buffer s
  auto load_taps = [&](int q, int tq, int s) {
    const int* rec = table + q * REC;
    const int l = rec[CONSTS_LAYER];
    if (l < 0) return;
    const int ts = tq + rec[CONSTS_NEXT_STEP], chunks = R / 4;
    for (int i = tid - LOADER0; i < nb * (K - 1) * chunks; i += NT - LOADER0) {
      const int n = i / ((K - 1) * chunks), j = i / chunks % (K - 1), c = i % chunks;
      const int slot = tap_slot(ts, win[l], (K - 1 - j) * dil[l]);
      cp_async16(taps + ((size_t)s * ROWS + n) * TS + j * R + 4 * c,
                 a.rings + (size_t)(b0 + n) * ring_row + ((size_t)off[l] + slot) * R + 4 * c);
    }
  };
  auto commit = []() { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  // the residual warp's columns: h and the skip sum of column 8 r + lane / 4 at rows n0,
  // n0 + 1; the gate warp's consts (the next gates' accumulator start), a lane's 4 values
  // of a (16, 8) tile at i: (m + 8 (i / 2), n0 + i % 2)
  const int m = lane / 4, n0 = 2 * (lane % 4);
  auto at = [&](int i) { return (m + 8 * (i / 2)) * ROWS + n0 + i % 2; };
  float hv[2] = {0.01f, 0.01f}, sk[2] = {0.f, 0.f}, cst[4];
  for (int i = 0; i < 4; ++i) cst[i] = condS[at(i)];  // layer 0's
  if (warp == 1) send(cluster, xh + ROWS * XH, XH, r, hv[0], hv[1], lane, C);  // parity 1
  if (warp >= 2) {
    load_weights(0, 0);
    commit();
    load_weights(1 % PH, 1);
    commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  cluster_arrive();  // the rings zeroed, h_0 sent, the first block in
  cluster_wait();

  for (int t = 0; t < a.T; ++t) {
    for (int p = 0; p < PH; ++p) {
      const long long g = (long long)t * PH + p;
      const int* rec = table + p * REC;
      const uint4* slot = wslot + (size_t)(g % SLOTS) * ST * 32;
      const __nv_bfloat16* zin = xz + ((g + 1) & 1) * ROWS * XZ;  // the phase before's
      const __nv_bfloat16* hin = xh + ((g + 1) & 1) * ROWS * XH;
      const int gl = rec[GATE_LAYER], zt = rec[GATE_Z_TILES], ht = rec[GATE_H_TILES];
      const int gate_tiles = gl >= 0 ? zt + ht : 0;
      if (warp == 0) {
        if (gl >= 0) {
          float c[4] = {cst[0], cst[1], cst[2], cst[3]}, d[4] = {0.f, 0.f, 0.f, 0.f};
          product(c, d, slot, zt, zin, XZ, lane);
          float e[4] = {0.f, 0.f, 0.f, 0.f}, f[4] = {0.f, 0.f, 0.f, 0.f};
          product(e, f, slot + zt * 32, ht, hin, XH, lane);
          float z[2];
          for (int i = 0; i < 2; ++i)
            z[i] = glu<GLU>((c[i] + d[i]) + (e[i] + f[i]),
                            (c[2 + i] + d[2 + i]) + (e[2 + i] + f[2 + i]));
          send(cluster, xz + (g & 1) * ROWS * XZ, XZ, r, z[0], z[1], lane, C);
        }
        cluster_arrive();
        const int cl = rec[CONSTS_LAYER];
        if (cl >= 0) {  // the next gates' start: cond + bf16(past taps) @ w_tap[cl][:(K-1)R]
          float c[4], d[4] = {0.f, 0.f, 0.f, 0.f};
          for (int i = 0; i < 4; ++i) c[i] = condS[cl * 16 * ROWS + at(i)];
          const uint4* pa = slot + (gate_tiles + (rec[OS_LAYER] >= 0 ? half / 16 : 0)) * 32;
          product_f32(c, d, pa, (K - 1) * R / 16, taps + (size_t)(g % SLOTS) * ROWS * TS,
                      TS, lane);
          for (int i = 0; i < 4; ++i) cst[i] = c[i] + d[i];
        }
        cluster_wait();
      } else if (warp == 1) {
        if (rec[OS_LAYER] >= 0) {
          float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
          product(c, d, slot + gate_tiles * 32, half / 16, zin, XZ, lane);
          for (int i = 0; i < 2; ++i) {
            hv[i] += c[i] + d[i];
            sk[i] += c[2 + i] + d[2 + i];
          }
          if (rec[OS_LAST]) {  // prev = h * 1e-4 + skips[:R] * 1e-6, the next step's h
            for (int i = 0; i < 2; ++i) {
              hv[i] = __fadd_rn(__fmul_rn(hv[i], 1e-4f), __fmul_rn(sk[i], 1e-6f));
              sk[i] = 0.f;
            }
          }
        }
        const int rl = rec[RING_LAYER];
        if (rl >= 0)
          for (int i = 0; i < 2; ++i)
            if (n0 + i < nb)
              a.rings[(size_t)(b0 + n0 + i) * ring_row + ((size_t)off[rl] + t % win[rl]) * R
                      + 8 * r + m] = hv[i];
        if (rec[HB_SEND]) send(cluster, xh + (g & 1) * ROWS * XH, XH, r, hv[0], hv[1], lane, C);
        cluster_arrive();
        cluster_wait();
      } else {
        // two phases ahead: the taps of phase p+2's consts, then its weight block; by
        // this phase's end, all but those two groups are in (the next phase's)
        const int q = (p + 2) % PH, tq = t + (p + 2) / PH;
        load_taps(q, tq, (int)((g + 2) % SLOTS));
        commit();
        load_weights(q, (int)((g + 2) % SLOTS));
        commit();
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
        cluster_arrive();
        cluster_wait();
      }
    }
  }
  if (warp == 1)
    for (int i = 0; i < 2; ++i)
      if (n0 + i < nb) a.out[(size_t)(b0 + n0 + i) * R + 8 * r + m] = hv[i];
  if (warp >= 2) asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster_arrive();  // no CTA leaves while a peer may still read or write its memory
  cluster_wait();
}

size_t smem_bytes(int L, int R, int G, int K, int PH, int slot_tiles) {
  const int XZ = G / 2 + 8, XH = R + 8, TS = (K - 1) * R + 8;
  return (size_t)SLOTS * slot_tiles * TILE_BYTES + sizeof(float) * SLOTS * ROWS * TS
         + 2 * (2 * ROWS * (XZ + XH)) + sizeof(float) * L * 16 * ROWS
         + sizeof(int) * (PH * REC + 3 * L);
}

template <int CHAIN, int GLU>
int launch(const Args& a, int C, cudaStream_t stream) {
  auto kern = critpath_kernel<CHAIN, GLU>;
  const size_t smem = smem_bytes(a.L, a.R, a.G, a.K, a.PH, a.slot_tiles);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.B + ROWS - 1) / ROWS * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// tiles: the wrapper's packing of the weights (C = R/8 CTAs x total_tiles x 512 bytes,
// fragment-ordered, `probes/ar_critpath.py` pack); table (PH, 11) int32, the phases of a
// step (`schedule`), its blocks at most slot_tiles tiles; cond (B, L*G) f32; rings
// (B, slots*R) f32 scratch; out (B, R) f32;
// chain 0 base, 1 fused; glu 0-4 (plain, bf16, tanh-sigmoid, tanhfold, tanhfold with a
// bf16 combine; base takes the plain GLU only). Takes L even and at least 4, K >= 2,
// R = S = G/2 = 8 C for a cluster of C in 2 .. 16 CTAs, at most MAX_TILES tiles a phase.
// Returns a cudaError_t.
extern "C" int probe_ar_critpath(const void* tiles, const int* table, const float* cond,
                                 float* rings, float* out, long long L, long long R,
                                 long long G, long long S, long long K, long long B,
                                 long long T, long long chain, long long glu, long long PH,
                                 long long total_tiles, long long slot_tiles,
                                 cudaStream_t stream) {
  const long long C = R / 8;
  if (L < 4 || L % 2 || K < 2 || B < 1 || T < 0 || R % 8 || C < 2 || C > MAX_C
      || S != R || G != 2 * R || PH < 1 || PH > MAX_PHASES || total_tiles < 1
      || (chain == BASE && glu != 0) || (chain == FUSED ? PH != L + 1 : PH != 2 * L)
      || slot_tiles < 1 || slot_tiles > MAX_TILES || (K - 1) * R % 32)
    return (int)cudaErrorInvalidValue;
  long long slots = 0;
  for (int li = 0; li < L; ++li) slots += (K - 1) << (li % (L / 2));
  Args a{static_cast<const uint4*>(tiles), table, cond, rings, out, (int)L, (int)R, (int)G,
         (int)K, (int)T, (int)B, (int)slots, (int)PH, (int)total_tiles, (int)slot_tiles};
  if (chain == BASE) return launch<BASE, PLAIN_GLU>(a, (int)C, stream);
  switch (glu) {
    case PLAIN_GLU: return launch<FUSED, PLAIN_GLU>(a, (int)C, stream);
    case BF16_GLU: return launch<FUSED, BF16_GLU>(a, (int)C, stream);
    case TANHSIG: return launch<FUSED, TANHSIG>(a, (int)C, stream);
    case TANHFOLD: return launch<FUSED, TANHFOLD>(a, (int)C, stream);
    case TF_BF16O: return launch<FUSED, TF_BF16O>(a, (int)C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
