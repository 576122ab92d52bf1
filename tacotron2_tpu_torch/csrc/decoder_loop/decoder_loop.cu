// The teacher-forced Tacotron decoder's forward recurrence on Hopper: all T steps of the
// fused decoder's forward in one persistent launch (tacotron2_tpu_torch/ops/decoder_vjp.py,
// `decoder_fwd_loop`, where `loop_applies` holds: bf16, the folded location tier, every
// step on its teacher frame, the widths below, B <= 32).
//
// It replaces, where it runs, the step loop of the port's lstm_cell_fwd and attention_fwd
// (csrc/decoder/decoder_step.cu) with the library products between them, and so the XLA
// fusions of the JAX package's fused decoder that those two kernels stand for
// (tacotron2_tpu/ops/fused_decoder.py: `_lstm_fwd` with the zoneout mix, :122-127 and
// :356-364; `_att_align` and the new state, :215-228 and :367-368; the step `_step_fwd`,
// :341-385, and its scan in `_forward`, :388-416). The prenet runs before the launch, once
// over every step (its input is the teacher frames), and the frame and stop projection
// after it, once over the T * B rows: no step feeds its frame back.
//
// One step, in the port's bf16 rounding (`_recurrence` in decoder_vjp.py, its plain
// version `_decoder_fwd_loop_plain`): z1 = bf16(bf16([p2, ctx, h1] @ g1^T) + g1_b), the
// product accumulated in f32 and rounded once; the LSTM cell with the +1 forget bias, the
// sigmoid rounded op by op as JAX lowers it (models/precision.py), zoneout with the step's
// keep-gates or its expectation a * new + b * old; z2 on [x1, h2] and the cell again;
// pq = bf16(x2 @ q_w^T); pl = bf16(bf16(state) @ loc_n), the location conv folded into the
// location layer; u = ((keys + pq) + (pl + pl_b)) + b_a in f32, e = sum_D v_a tanh(u),
// NEG_INF where the mask is not > 0, the softmax (or the smoothing's normalised sigmoid),
// the new state (+ the alignments where they cumulate); ctx = bf16(bf16(align) @ values) in
// f32. Built with --fmad=false: no product and sum contracted into one rounding that the
// plain version does not make.
//
// What bounds it on an H100. A step's products are 2 x (B (1,792 + 2,048) 4,096 + B U D +
// B T_in^2 D + B T_in E) operations: at B=32, T_in=100, 1.10 GFLOP, 1.11 us at the bf16
// tensor cores' 989 TFLOP/s; its bytes (the residuals it writes, about 1 MB a step at
// B=32, and the weights once) 0.3 us at 3.35 TB/s. So it is bound by operations, at about
// 1.1 us a step. What a step pays here is latency: the recurrence is a chain of five
// dependent stages, each a few small products spread over the grid, and a grid barrier
// after each (about 1.5-2 us of wait where the stage's work is even over the CTAs).
//
// Design. One cooperative launch of G = U / 8 = 128 CTAs of 256 threads, all resident (the
// entry checks the occupancy: its grid barrier, an arrival counter in global memory that
// the caller zeroes, needs every CTA), five grid barriers a step:
//  1. LSTM 1. CTA c owns units 8c .. 8c+7: the 4 x 8 gate columns q U + 8c + i of both
//     LSTMs, whose c and h it keeps in registers (a thread a (row, unit)) for the whole
//     launch. The gate products run on the tensor cores (mma.sync.m16n8k16, bf16 operands,
//     f32 accumulation; the rows padded to 16 or 32 with zeros, so B=1 runs one m-tile):
//     warp w takes both m-tiles of every 8th k-pair (32 columns) from w on, the CTA adds
//     the warps' partials in warp order, rounds, adds the bias and runs the cells. Each
//     lane reads 16 bytes of a row at a time, the rows' and the weights' columns dealt to
//     the mma's k slots in the same order (`wpair`, `apair`), and a warp issues the loads of
//     a few k-pairs before their products. The weights: all of g2's columns of the CTA
//     (128 KB) and g1's h1 rows (64 KB) sit in shared memory in that fragment order for the
//     whole launch, packed at its start (they change at every train step); g1's p2 and ctx
//     rows stream from L2 (48 KB a CTA a step). The rows come from L2 (ld.global.cg: other
//     CTAs wrote them since the last barrier).
//  2. LSTM 2 on [x1, h2], the same way.
//  3. pq: 16 CTAs, one 8-column tile of D each, the K of 1,024 split over the warps.
//  4. The energies, split by input step over the grid, so that each input step's D
//     columns of loc_n (T_in, T_in D) are read once a decoder step: CTA c takes input
//     steps c, c + 128, ..: pl^T of all rows for that step on the tensor cores (A the
//     step's D rows of loc_n transposed, `loc_nt`, whose T_in columns are contiguous; B the
//     state's rows, staged once a step in shared memory as bf16 fragments for all the
//     warps, which read the same ones; K the T_in input steps), then each row's sum over
//     D of v_a tanh(u).
//  5. The softmax, the new state and the context: G / B CTAs a row (4 at B=32, 128 at
//     B=1), each normalising the row's energies (the same sums in each) and forming
//     E / (G / B) of its context columns, SL slices of the input steps summed in order.
// A row's results are the same at any B. Scratch the caller allocates: the zoned h of both
// LSTMs and the state in two slots each (a step reads one and writes the other), x1, pq and
// the energies, and the barrier.
//
// Plain C entry point (loaded with ctypes): `ptrs` holds the device pointers in the order
// of the enum below (null for an absent optional input or for the residuals when none are
// saved), `ints` T, B, T_in, smoothing, cumulate, `mix` zoneout's (a, b) of c1, h1, c2, h2;
// the launch goes on `stream`; returns its cudaError_t (0: launched) and, where the card
// keeps too few CTAs resident, writes those it keeps and those needed into info[0..1].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads a CTA: 8 warps
constexpr int NW = NT / 32;
// the widths the kernel is built for: the default hparams' and the paper profile's
constexpr int U = 1024, P = 256, E = 512, D = 128;
constexpr int UPC = 8;        // units a CTA
constexpr int G = U / UPC;    // CTAs
constexpr int K1 = P + E + U, K2 = 2 * U;
// k-pairs: 32 columns, two k-tiles of 16, which a lane reads 8 columns at a time
constexpr int KP_P = P / 32, KP_E = E / 32, KP_U = U / 32;
constexpr int KP1 = K1 / 32, KP2 = K2 / 32;
constexpr int MAX_B = 32;       // two m-tiles; the partials' shared memory sets it
constexpr int MAX_T_IN = 192;   // a thread an input step in the softmax
constexpr int FRAG = 4 * 32;    // B fragments (uint4) of one k-pair of the CTA's 4 gate tiles
// k-pairs whose loads a warp issues before their products: BATCH of x2 and q_w's rows for
// pq, RES_BATCH of the rows whose weights sit in shared memory (4 of those spill registers:
// 47 us a step at B=32 against 34 with 2, H100 80GB HBM3, 700 W)
constexpr int BATCH = 4, RES_BATCH = 2;
constexpr int SL = 8;           // the context's slices of the input steps: NT / SL column groups
constexpr size_t W2_BYTES = (size_t)KP2 * FRAG * 16;    // g2's columns of the CTA: 128 KB
constexpr size_t W1H_BYTES = (size_t)KP_U * FRAG * 16;  // g1's h1 rows of them: 64 KB
// the warps' partials of 32 rows x 32 columns (32 KB), which the energies' and the
// softmax's scratch share: the barrier between two stages parts their uses
constexpr size_t RED_FLOATS = (size_t)NW * MAX_B * 32;
constexpr size_t SMEM = W2_BYTES + W1H_BYTES + RED_FLOATS * 4;
constexpr float NEG_INF = -4294967296.0f;  // -2**32 + 1 in float32 (attention.py)
constexpr unsigned FULL = 0xffffffffu;

enum Ptr {
  P_P2, P_KEYS, P_VALUES, P_MASK, P_G1, P_G1B, P_G2, P_G2B, P_QW, P_LOCNT, P_PLB, P_VA, P_BA,
  P_KEEP_C1, P_KEEP_H1, P_KEEP_C2, P_KEEP_H2,
  P_ALIGNS, P_X2, P_CTX,
  P_Z1, P_Z2, P_X1, P_C1P, P_H1P, P_C2P, P_H2P, P_STATE, P_PQ,
  P_H1C, P_H2C, P_X1B, P_PQB, P_EB, P_STB, P_BAR, P_PROF, N_PTRS
};

struct Args {
  // inputs: p2 (T, B, P), keys (B, T_in, D), values (B, T_in, E) f32, mask (B, T_in) f32 or
  // null, g1 (4U, K1), g1_b (4U), g2 (4U, K2), g2_b, q_w (D, U), loc_nt (T_in D, TP):
  // loc_nt[j D + d][k] = loc_n[k][j D + d], zero for k >= T_in (TP: T_in rounded up to
  // 32), pl_b, v_a, b_a (D) f32, the keep-gates (T, B, U) bool of c1, h1, c2, h2 or null
  const bf16 *p2, *keys, *g1, *g1_b, *g2, *g2_b, *q_w, *loc_nt;
  const float *values, *mask, *pl_b, *v_a, *b_a;
  const uint8_t* keep[4];
  float mix[4][2];
  // outputs: aligns (T, B, T_in) f32, x2 (T, B, U), ctx (T, B, E)
  float* aligns;
  bf16 *x2, *ctx;
  // residuals, or all null: z1, z2 (T, B, 4U), x1, c1p, h1p, c2p, h2p (T, B, U), state
  // (T, B, T_in) f32 (the state each step read), pq (T, B, D)
  bf16 *z1, *z2, *x1, *c1p, *h1p, *c2p, *h2p, *pq;
  float* state;
  // scratch: h1c, h2c (2, B, U), x1b (B, U), pqb (B, D), eb (B, T_in) f32, stb (2, B, TP)
  // f32 zeroed, bar (one u32, zero)
  bf16 *h1c, *h2c, *x1b, *pqb;
  float *eb, *stb;
  unsigned* bar;
  // a build with -DT2_PROFILE: (G, 2, STAGES) u64, each CTA's %globaltimer ns of each
  // stage's work (from the barrier before it to its arrival at its own) and of its wait
  unsigned long long* prof;
  int T, B, T_in, smoothing, cumulate;
};

constexpr int STAGES = 5;  // LSTM 1, LSTM 2, pq, the energies, the softmax and context

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// x rounded to bf16, held in f32
__device__ __forceinline__ float rd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// the bf16 sigmoid as JAX lowers it, each op rounded: 1 / (exp(-x) + 1) (__frcp_rn: the
// reciprocal correctly rounded, as the division is)
__device__ __forceinline__ float sig(float x) { return rd(__frcp_rn(rd(rd(expf(-x)) + 1.0f))); }

__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The k-pair order. mma.m16n8k16 sums 16 products whatever their order, so the columns of
// a k-pair (32 of them) are dealt to the k slots as 16-byte loads give them: lane (g, t)
// of a warp reads columns 8t .. 8t+7 of its rows; 8t, 8t+1 and 8t+2, 8t+3 are its slots
// 2t, 2t+1 and 2t+8, 2t+9 of the pair's first k-tile, 8t+4 .. 8t+7 those of the second.
// The A operand (the rows) and the B operand (a weight's rows, as a torch Linear keeps
// them) take the same order, so each product sums the same terms.

template <bool CG>
__device__ __forceinline__ uint4 ld16(const void* p) {
  return CG ? __ldcg(reinterpret_cast<const uint4*>(p)) : __ldg(reinterpret_cast<const uint4*>(p));
}

// The B fragments of the k-pair at columns c0 .. of w (N, ld) row-major for the 8 output
// columns n0 ..: x, y the first k-tile's b0, b1, z, w the second's.
__device__ __forceinline__ uint4 wpair(const bf16* w, int ld, int n0, int c0, int lane) {
  return ld16<false>(w + (size_t)(n0 + lane / 4) * ld + c0 + 8 * (lane % 4));
}

// The A fragments a[k-tile][4] of the k-pair at columns c0 .. of x (rows of ld bf16) for
// the m-tile mt: rows past B read as zeros. CG: x was written in this launch.
template <bool CG>
__device__ __forceinline__ void apair(uint32_t a[2][4], const bf16* x, int ld, int B, int mt,
                                      int c0, int lane) {
  const int r0 = 16 * mt + lane / 4, r1 = r0 + 8, c = c0 + 8 * (lane % 4);
  uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
  if (r0 < B) v0 = ld16<CG>(x + (size_t)r0 * ld + c);
  if (r1 < B) v1 = ld16<CG>(x + (size_t)r1 * ld + c);
  a[0][0] = v0.x;
  a[0][1] = v1.x;
  a[0][2] = v0.y;
  a[0][3] = v1.y;
  a[1][0] = v0.z;
  a[1][1] = v1.z;
  a[1][2] = v0.w;
  a[1][3] = v1.w;
}

// d += the k-pair's two products of the A fragments a and the B fragments b
__device__ __forceinline__ void mma_pair(float d[4], const uint32_t a[2][4], uint4 b) {
  mma(d, a[0], make_uint2(b.x, b.y));
  mma(d, a[1], make_uint2(b.z, b.w));
}

// d[m][q] += the k-pairs kp0 + warp, kp0 + warp + NW, .. below kp1 of x (its columns from
// k-pair kp0 on; its m-tiles m < MT) times the B fragments wf(kp, q) of the 4 gate tiles.
// The loads of the rows of NB k-pairs are issued before their products, so that they are
// in flight together, and with PRE those of the weights too (streamed from L2; else
// shared memory's, read at their product).
template <bool CG, bool PRE, int NB, typename WF>
__device__ __forceinline__ void segment(float d[2][4][4], const bf16* x, int ld, int B, int MT,
                                        int kp0, int kp1, int warp, int lane, WF wf) {
  for (int kb = kp0 + warp; kb < kp1; kb += NB * NW) {
    uint32_t af[NB][2][2][4];
    uint4 bw[PRE ? NB : 1][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int kp = kb + i * NW;
      if (kp < kp1) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (m < MT) apair<CG>(af[i][m], x, ld, B, m, 32 * (kp - kp0), lane);
        if (PRE)
#pragma unroll
          for (int q = 0; q < 4; ++q) bw[PRE ? i : 0][q] = wf(kp, q);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int kp = kb + i * NW;
      if (kp < kp1)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 b = PRE ? bw[PRE ? i : 0][q] : wf(kp, q);
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT) mma_pair(d[m][q], af[i][m], b);
        }
    }
  }
}

// The grid barrier: every thread's writes before it, one arrival a CTA, then wait for all
// of this barrier's. A barrier that some CTA never reaches (it cannot happen while every
// CTA is resident, which the entry checks) traps after about 10 s instead of hanging.
// With -DT2_PROFILE thread 0 adds the stage's work and wait to `times` (work, then wait,
// STAGES each; times[2 STAGES] the last release).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target,
                                          unsigned long long* times, int stage) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
#ifdef T2_PROFILE
    const unsigned long long arrived = globaltimer();
    times[stage] += arrived - times[2 * STAGES];
#endif
    __threadfence();
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    unsigned v;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
      if (v >= target) break;
      if (clock64() - t0 > 20000000000LL) __trap();
    }
    __threadfence();
#ifdef T2_PROFILE
    times[2 * STAGES] = globaltimer();
    times[STAGES + stage] += times[2 * STAGES] - arrived;
#endif
  }
  __syncthreads();
}

// The max (or sum) of every thread's v over the CTA, the same in every thread.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red may still be read from the reduction before
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < NW; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// The warp's partial sums d of its m-tiles' 4 gate tiles (tile q: columns 8q ..) into
// red[warp][row][32].
__device__ __forceinline__ void put_partials(float* red, const float d[2][4][4], int MT,
                                             int warp, int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m >= MT) break;
    const int row = 16 * m + lane / 4, col = 2 * (lane % 4);
    float* r = red + ((size_t)warp * MAX_B + row) * 32;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r[8 * q + col] = d[m][q][0];
      r[8 * q + col + 1] = d[m][q][1];
      r[8 * 32 + 8 * q + col] = d[m][q][2];
      r[8 * 32 + 8 * q + col + 1] = d[m][q][3];
    }
  }
}

// The gates i, g, f, o of (row, unit i of the CTA's 8): the warps' partials added in order,
// rounded, the rounded bias added and rounded again.
__device__ __forceinline__ void gate_values(float z[4], const float* red, int row, int i,
                                            const bf16* bias, int u) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = red[(size_t)row * 32 + 8 * q + i];
#pragma unroll
    for (int k = 1; k < NW; ++k) s += red[((size_t)k * MAX_B + row) * 32 + 8 * q + i];
    z[q] = rd(rd(s) + ldf(bias + q * U + u));
  }
}

// The LSTM cell on the gates z with the zoneout of c and h in place (the keep-gates kc, kh
// 0 or 1, or -1 for the expectation (ac, bc), (ah, bh)); hn the step's output h_new.
__device__ __forceinline__ void lstm_cell(const float z[4], float& c, float& h, float& hn,
                                          int kc, int kh, const float mc[2], const float mh[2]) {
  const float si = sig(z[0]), tg = rd(tanhf(z[1]));
  const float sf = sig(rd(z[2] + 1.0f));
  const float so = sig(z[3]);
  const float cn = rd(rd(sf * c) + rd(si * tg));
  hn = rd(so * rd(tanhf(cn)));
  c = kc >= 0 ? (kc ? cn : c) : rd(rd(mc[0] * cn) + rd(mc[1] * c));
  h = kh >= 0 ? (kh ? hn : h) : rd(rd(mh[0] * hn) + rd(mh[1] * h));
}

__device__ __forceinline__ int keep_of(const uint8_t* keep, size_t i) {
  return keep ? (int)keep[i] : -1;
}

__global__ void __launch_bounds__(NT, 1) decoder_fwd_loop_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* W2 = reinterpret_cast<uint4*>(smem);       // (KP2, 4, 32)
  uint4* W1H = W2 + (size_t)KP2 * FRAG;             // (KP_U, 4, 32)
  float* RED = reinterpret_cast<float*>(W1H + (size_t)KP_U * FRAG);
  float* KQ = RED;                         // stage 4: keys + pq of the input step (B, D)
  float* EP = RED + MAX_B * D;             // ... each warp's sums over its d (NW, MAX_B)
  uint4* SB = reinterpret_cast<uint4*>(EP + NW * MAX_B);  // ... the state's B fragments
  float* AL = RED;                         // stage 5: the row's alignments, bf16-rounded
  float4* CP = reinterpret_cast<float4*>(RED + 256);  // ... the context's partials (NT)
  __shared__ float red[NW];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cta = blockIdx.x, B = a.B, T_in = a.T_in;
  const int MT = B > 16 ? 2 : 1;            // m-tiles of the rows, each warp takes all
  const int TP = (T_in + 31) / 32 * 32;     // the state's rows, padded to k-pairs
  const int u0 = UPC * cta;
  const uint8_t* keep_h1 = a.keep[1];

  // --- once a launch: the resident B fragments ---
  for (int i = tid; i < KP2 * FRAG; i += NT)
    W2[i] = wpair(a.g2, K2, (i % FRAG / 32) * U + u0, 32 * (i / FRAG), i % 32);
  for (int i = tid; i < KP_U * FRAG; i += NT)
    W1H[i] = wpair(a.g1, K1, (i % FRAG / 32) * U + u0, 32 * (KP_P + KP_E + i / FRAG), i % 32);
  __syncthreads();

  // this thread's (row, unit) of the cells, their zoned c and h in registers
  const int crow = tid / UPC, ci = tid % UPC, cu = u0 + ci;
  const bool cell = crow < B;
  float c1 = 0.f, h1 = 0.f, c2 = 0.f, h2 = 0.f;
  const size_t BU = (size_t)B * U, BTP = (size_t)B * TP;
  // the softmax's CTAs a row, and the context columns of each (a multiple of 4)
  const int NCH = G / B, CW = 4 * ((E / 4 + NCH - 1) / NCH);
  unsigned target = 0;
  unsigned long long times[2 * STAGES + 1] = {};
#ifdef T2_PROFILE
  times[2 * STAGES] = globaltimer();
#endif

  for (int t = 0; t < a.T; ++t) {
    const int cur = t & 1, prev = cur ^ 1;
    const size_t tb = (size_t)t * B;

    // --- 1. LSTM 1 on [p2, ctx, h1]: at t = 0 the context and h1 are zero ---
    {
      float d[2][4][4] = {};
      const bf16* p2 = a.p2 + tb * P;
      const bf16* ctx = t ? a.ctx + (tb - B) * E : a.ctx;
      const bf16* hp = a.h1c + prev * BU;
      auto streamed = [&](int kp, int q) { return wpair(a.g1, K1, q * U + u0, 32 * kp, lane); };
      auto resident = [&](int kp, int q) {
        return W1H[((kp - KP_P - KP_E) * 4 + q) * 32 + lane];
      };
      segment<false, true, 1>(d, p2, P, B, MT, 0, KP_P, warp, lane, streamed);
      if (t) {
        segment<true, true, 2>(d, ctx, E, B, MT, KP_P, KP_P + KP_E, warp, lane, streamed);
        segment<true, false, RES_BATCH>(d, hp, U, B, MT, KP_P + KP_E, KP1, warp, lane, resident);
      }
      put_partials(RED, d, MT, warp, lane);
      __syncthreads();
      if (cell) {
        float z[4], hn;
        gate_values(z, RED, crow, ci, a.g1_b, cu);
        const size_t i = (tb + crow) * U + cu;
        lstm_cell(z, c1, h1, hn, keep_of(a.keep[0], i), keep_of(keep_h1, i), a.mix[0], a.mix[1]);
        a.h1c[cur * BU + (size_t)crow * U + cu] = __float2bfloat16_rn(h1);
        a.x1b[(size_t)crow * U + cu] = __float2bfloat16_rn(hn);
        if (a.z1) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a.z1[(tb + crow) * 4 * U + q * U + cu] = __float2bfloat16_rn(z[q]);
          a.x1[i] = __float2bfloat16_rn(hn);
          a.c1p[i] = __float2bfloat16_rn(c1);
          a.h1p[i] = __float2bfloat16_rn(h1);
        }
      }
    }
    grid_sync(a.bar, target, times, 0);

    // --- 2. LSTM 2 on [x1, h2]: at t = 0 h2 is zero ---
    {
      float d[2][4][4] = {};
      const bf16* hp = a.h2c + prev * BU;
      auto resident = [&](int kp, int q) { return W2[(kp * 4 + q) * 32 + lane]; };
      segment<true, false, RES_BATCH>(d, a.x1b, U, B, MT, 0, KP_U, warp, lane, resident);
      if (t) segment<true, false, RES_BATCH>(d, hp, U, B, MT, KP_U, KP2, warp, lane, resident);
      put_partials(RED, d, MT, warp, lane);
      __syncthreads();
      if (cell) {
        float z[4], hn;
        gate_values(z, RED, crow, ci, a.g2_b, cu);
        const size_t i = (tb + crow) * U + cu;
        lstm_cell(z, c2, h2, hn, keep_of(a.keep[2], i), keep_of(a.keep[3], i), a.mix[2], a.mix[3]);
        a.h2c[cur * BU + (size_t)crow * U + cu] = __float2bfloat16_rn(h2);
        a.x2[i] = __float2bfloat16_rn(hn);
        if (a.z2) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a.z2[(tb + crow) * 4 * U + q * U + cu] = __float2bfloat16_rn(z[q]);
          a.c2p[i] = __float2bfloat16_rn(c2);
          a.h2p[i] = __float2bfloat16_rn(h2);
        }
      }
    }
    grid_sync(a.bar, target, times, 1);

    // --- 3. pq = bf16(x2 @ q_w^T): CTA c < D / 8 the columns 8c .. 8c+7 ---
    if (cta < D / 8) {
      float d[2][4] = {};
      const bf16* x2 = a.x2 + tb * U;
      for (int kb = warp; kb < KP_U; kb += BATCH * NW) {  // KP_U: BATCH NW
        uint32_t af[BATCH][2][2][4];
        uint4 bw[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int kp = kb + i * NW;
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT) apair<true>(af[i][m], x2, U, B, m, 32 * kp, lane);
          bw[i] = wpair(a.q_w, U, 8 * cta, 32 * kp, lane);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i)
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < MT) mma_pair(d[m], af[i][m], bw[i]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m >= MT) break;
        float* r = RED + ((size_t)warp * MAX_B + 16 * m + gid) * 8 + 2 * tig;
        r[0] = d[m][0];
        r[1] = d[m][1];
        r[64] = d[m][2];
        r[65] = d[m][3];
      }
      __syncthreads();
      if (tid < B * 8) {
        const int row = tid / 8, col = tid % 8;
        float s = RED[row * 8 + col];
#pragma unroll
        for (int k = 1; k < NW; ++k) s += RED[((size_t)k * MAX_B + row) * 8 + col];
        const bf16 v = __float2bfloat16_rn(s);
        a.pqb[(size_t)row * D + 8 * cta + col] = v;
        if (a.pq) a.pq[(tb + row) * D + 8 * cta + col] = v;
      }
    }
    grid_sync(a.bar, target, times, 2);

    // --- 4. the energies of input steps cta, cta + G, ..: pl^T (D, B) of the step on the
    // tensor cores, A its D rows of loc_nt, B the state's rows; warp w the d 16w .. ---
    const float* st = a.stb + prev * BTP;  // the state the step reads
    const int KPI = TP / 32, NTB = (B + 7) / 8;
    if (cta < T_in) {
      // the state's rows as the B fragments of the k-pairs (KPI, 4 n-tiles, 32 lanes),
      // rounded to bf16, once for all the CTA's input steps and warps
      for (int i = tid; i < KPI * 4 * 32; i += NT) {
        const int n = i / 32 % 4, l = i % 32, r = 8 * n + l / 4;
        const int c = 32 * (i / 128) + 8 * (l % 4);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < B) {
          const float4 s0 = __ldcg(reinterpret_cast<const float4*>(st + r * TP + c));
          const float4 s1 = __ldcg(reinterpret_cast<const float4*>(st + r * TP + c + 4));
          v = make_uint4(pack2(s0.x, s0.y), pack2(s0.z, s0.w), pack2(s1.x, s1.y),
                         pack2(s1.z, s1.w));
        }
        SB[i] = v;
      }
      __syncthreads();
    }
    for (int j = cta; j < T_in; j += G) {
      for (int i = tid; i < B * D / 8; i += NT) {  // 8 columns a thread
        const int r = i / (D / 8), c = 8 * (i % (D / 8));
        const uint4 kv = ld16<false>(a.keys + ((size_t)r * T_in + j) * D + c);
        const uint4 qv = ld16<true>(a.pqb + (size_t)r * D + c);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
        const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 kf = __bfloat1622float2(k2[h]), qf = __bfloat1622float2(q2[h]);
          KQ[r * D + c + 2 * h] = kf.x + qf.x;
          KQ[r * D + c + 2 * h + 1] = kf.y + qf.y;
        }
      }
      float acc[4][4] = {};  // n-tile n: the rows 8n ..
      const bf16* lt = a.loc_nt + ((size_t)j * D + 16 * warp) * TP;
      for (int kb = 0; kb < KPI; kb += 2) {
        uint32_t af[2][2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (kb + i < KPI) apair<false>(af[i], lt, TP, 16, 0, 32 * (kb + i), lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (kb + i < KPI)
#pragma unroll
            for (int n = 0; n < 4; ++n)
              if (n < NTB) mma_pair(acc[n], af[i], SB[((kb + i) * 4 + n) * 32 + lane]);
      }
      __syncthreads();  // KQ
      // v_a tanh(u) of this lane's d = 16w + gid (+ 8) and rows 8n + 2 tig (+ 1), summed
      // over the d of the warp's lanes, then over the warps in order
      float s[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * n + 2 * tig + e;
          float v = 0.f;
          if (n < NTB && r < B) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int dd = 16 * warp + gid + 8 * h;
              const float pl = rd(acc[n][2 * h + e]) + a.pl_b[dd];
              const float u = (KQ[r * D + dd] + pl) + a.b_a[dd];
              v += a.v_a[dd] * tanhf(u);
            }
          }
          s[n][e] = v;
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) s[n][e] += __shfl_xor_sync(FULL, s[n][e], o);
      if (gid == 0)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) EP[warp * MAX_B + 8 * n + 2 * tig + e] = s[n][e];
      __syncthreads();
      if (tid < B) {
        float e = EP[tid];
        for (int w = 1; w < NW; ++w) e += EP[w * MAX_B + tid];
        if (a.mask && !(a.mask[(size_t)tid * T_in + j] > 0.0f)) e = NEG_INF;
        a.eb[(size_t)tid * T_in + j] = e;
      }
      __syncthreads();
    }
    grid_sync(a.bar, target, times, 3);

    // --- 5. the softmax, the new state and the context: NCH CTAs a row ---
    if (cta < B * NCH) {
      const int b = cta / NCH, ch = cta % NCH;
      const bool in = tid < T_in;
      const float ev = in ? __ldcg(a.eb + (size_t)b * T_in + tid) : 0.f;
      const float mx = a.smoothing ? 0.f : block_reduce<true>(in ? ev : -INFINITY, red);
      const float ex = in ? (a.smoothing ? 1.0f / (1.0f + expf(-ev)) : expf(ev - mx)) : 0.f;
      const float sum = block_reduce<false>(ex, red);
      if (in) {
        const float al = ex / sum;
        AL[tid] = rd(al);
        if (ch == 0) {
          const size_t i = (size_t)b * TP + tid, o = (tb + b) * T_in + tid;
          const float old = __ldcg(st + i);
          const float nw = a.cumulate ? al + old : al;
          a.aligns[o] = al;
          a.stb[cur * BTP + i] = nw;
          if (a.state) a.state[o] = old;
        }
      }
      __syncthreads();
      // the context's columns ch CW ..: 4 a thread over one of SL slices of the input
      // steps, the slices' sums then added in order (the same order whatever B is)
      const int ng = CW / 4, TS = (T_in + SL - 1) / SL;
      const int grp = tid % ng, sl = tid / ng, col = ch * CW + 4 * grp;
      if (sl < SL) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < E) {
          const float* v = a.values + (size_t)b * T_in * E + col;
          const int j1 = min(T_in, (sl + 1) * TS);
#pragma unroll 4
          for (int j = sl * TS; j < j1; ++j) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(v + (size_t)j * E));
            const float al = AL[j];
            s.x += al * x.x;
            s.y += al * x.y;
            s.z += al * x.z;
            s.w += al * x.w;
          }
        }
        CP[sl * ng + grp] = s;
      }
      __syncthreads();
      if (tid < CW && ch * CW + tid < E) {
        const float* cp = reinterpret_cast<const float*>(CP);
        float s = cp[tid];
        for (int k = 1; k < SL; ++k) s += cp[k * CW + tid];
        a.ctx[(tb + b) * E + ch * CW + tid] = __float2bfloat16_rn(s);
      }
    }
    grid_sync(a.bar, target, times, 4);
  }
#ifdef T2_PROFILE
  if (tid == 0 && a.prof)
    for (int i = 0; i < 2 * STAGES; ++i) a.prof[(size_t)cta * 2 * STAGES + i] = times[i];
#endif
}

}  // namespace

extern "C" int t2_decoder_fwd_loop(void* const* p, const int* n, const float* mix, int* info,
                                   void* stream) {
  Args a;
  a.p2 = (const bf16*)p[P_P2];
  a.keys = (const bf16*)p[P_KEYS];
  a.values = (const float*)p[P_VALUES];
  a.mask = (const float*)p[P_MASK];
  a.g1 = (const bf16*)p[P_G1];
  a.g1_b = (const bf16*)p[P_G1B];
  a.g2 = (const bf16*)p[P_G2];
  a.g2_b = (const bf16*)p[P_G2B];
  a.q_w = (const bf16*)p[P_QW];
  a.loc_nt = (const bf16*)p[P_LOCNT];
  a.pl_b = (const float*)p[P_PLB];
  a.v_a = (const float*)p[P_VA];
  a.b_a = (const float*)p[P_BA];
  for (int g = 0; g < 4; ++g) {
    a.keep[g] = (const uint8_t*)p[P_KEEP_C1 + g];
    a.mix[g][0] = mix[2 * g];
    a.mix[g][1] = mix[2 * g + 1];
  }
  a.aligns = (float*)p[P_ALIGNS];
  a.x2 = (bf16*)p[P_X2];
  a.ctx = (bf16*)p[P_CTX];
  a.z1 = (bf16*)p[P_Z1];
  a.z2 = (bf16*)p[P_Z2];
  a.x1 = (bf16*)p[P_X1];
  a.c1p = (bf16*)p[P_C1P];
  a.h1p = (bf16*)p[P_H1P];
  a.c2p = (bf16*)p[P_C2P];
  a.h2p = (bf16*)p[P_H2P];
  a.state = (float*)p[P_STATE];
  a.pq = (bf16*)p[P_PQ];
  a.h1c = (bf16*)p[P_H1C];
  a.h2c = (bf16*)p[P_H2C];
  a.x1b = (bf16*)p[P_X1B];
  a.pqb = (bf16*)p[P_PQB];
  a.eb = (float*)p[P_EB];
  a.stb = (float*)p[P_STB];
  a.bar = (unsigned*)p[P_BAR];
  a.prof = (unsigned long long*)p[P_PROF];
  a.T = n[0];
  a.B = n[1];
  a.T_in = n[2];
  a.smoothing = n[3];
  a.cumulate = n[4];
  if (a.T < 0 || a.B < 1 || a.B > MAX_B || a.T_in < 1 || a.T_in > MAX_T_IN)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_fwd_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_fwd_loop_kernel, NT, SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < G) {  // the grid barrier needs every CTA resident
    info[0] = per_sm * sms;
    info[1] = G;
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)decoder_fwd_loop_kernel, dim3(G), dim3(NT), args,
                                    SMEM, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
