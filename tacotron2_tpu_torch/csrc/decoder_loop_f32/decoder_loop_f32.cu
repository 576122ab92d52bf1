// The teacher-forced Tacotron decoder's forward recurrence on Hopper in float32: all T steps
// of the fused decoder's forward in one persistent launch, the location conv inside it
// (tacotron2_tpu_torch/ops/decoder_vjp.py, `decoder_fwd_loop` at float32, where
// `loop_applies` holds: float32, the conv location tier, every step on its teacher
// frame, the widths below, B <= 32, T_in <= 256).
//
// It replaces, where it runs, the step loop of the port's lstm_cell_fwd and attention_fwd
// (csrc/decoder/decoder_step.cu) at float32 with the library products and the location conv
// between them, and so the XLA fusions of the JAX package's fused decoder that those two
// kernels stand for (tacotron2_tpu/ops/fused_decoder.py: `_lstm_fwd` with the zoneout mix,
// :122-127 and :356-364; `_loc_features`, `_loc_pl`, `_att_align` and the new state,
// :195-228 and :367-368; the step `_step_fwd`, :341-385, and its scan in `_forward`,
// :388-416). GTA (the synthesizer's model computes in float32) and training at
// compute_dtype=float32 run it. The prenet runs before the launch, once over every step,
// and the frame and stop projection after it, once over the T * B rows.
//
// One step, at float32 (`_recurrence` in decoder_vjp.py, its plain version
// `_decoder_fwd_loop_plain`): z1 = [p2, ctx, h1] @ g1^T + g1_b; the LSTM cell with the +1
// forget bias; zoneout with the step's keep-gates or its expectation (1 - rate) new +
// rate old; z2 on [x1, h2] and the cell again; pq = x2 @ q_w^T; the location features
// f = the SAME conv of the state with the K taps of each filter, plus loc_b (even K
// too: (K - 1) / 2 taps before the position); pl = f @ l_w^T; u = ((keys + pq) + pl) + b_a,
// e = sum_D v_a tanh(u), NEG_INF where the mask is not > 0; the softmax (or the smoothing's
// normalised sigmoid), the new state (+ the alignments where they cumulate); ctx =
// align @ values. Built with --fmad=false: the elementwise math rounds op by op, as the
// plain version's separate operations do; the dot products fuse where they say so.
//
// What bounds it on an H100. A step's products are 2 B ((1,792 + 2,048) 4,096 + U D +
// T_in (K F + F D + E)) operations: at B=32, T_in=100, 1.05 GFLOP, 15.6 us at the f32
// CUDA cores' 67 TFLOP/s (6.4 us as 3xTF32 at the tensor cores' 495 TFLOP/s: three
// products a term). Its weights are 63 MB in f32, and the card's shared memory 30 MB: at
// B=1 the weights that cannot stay on chip, at least 33 MB a step, take 9.9 us at
// 3.35 TB/s. What a step pays beyond that is latency and the L2: a chain of five dependent
// stages, a grid barrier after each, and every CTA reading all rows of the LSTMs' inputs.
//
// Design. One cooperative launch of G = U / 8 = 128 CTAs of 256 threads, all resident (the
// entry checks the occupancy: its grid barrier, an arrival counter in global memory that
// the caller zeroes, needs every CTA), five grid barriers a step:
//  1. LSTM 1. CTA c owns units 8c .. 8c+7: the 4 x 8 gate columns q U + 8c + i of both
//     LSTMs, whose c and h it keeps in registers (a thread a (row, unit)) for the whole
//     launch. The gate products run on the tensor cores as 3xTF32 (mma.sync.m16n8k8.tf32,
//     each operand split into hi = tf32(x) and lo = tf32(x - hi), the terms lo hi, hi lo
//     and hi hi: f32-accurate, where one TF32 pass keeps about 3 digits; each k-quad's six
//     products summed from zero and added to the warp's sums on the CUDA cores, rounded;
//     the rows padded to 16 or 32 with zeros, so B=1 runs one m-tile): warp w takes both
//     m-tiles of every 8th k-quad (16 columns: two k-tiles of 8) from w on, the CTA adds
//     the warps' partials in warp order, adds the bias and runs the cells. Each lane reads
//     16 bytes of a row at a time, the rows' and the weights' columns dealt to the mma's k
//     slots in the same order (`wquad`, `aquad`), and a warp starts the loads of NB
//     k-quads before their products. The weights: g2's h2 columns of the CTA (128 KB) sit
//     in shared memory in that fragment order for the whole launch, packed at its start;
//     g1 (224 KB a CTA) and g2's x1 columns (128 KB) stream from L2 every step (the 63 MB
//     of f32 weights do not fit the card's shared memory). The rows come from L2
//     (ld.global.cg: other CTAs wrote them since the last barrier).
//  2. LSTM 2 on [x1, h2], the same way.
//  3. pq over the grid: 16 tiles of 8 columns of D x 8 K-chunks of 128, one CTA each, a
//     k-quad a warp (on 16 CTAs, the K of 1,024 split over their warps, the slowest CTA
//     read 6.1 us a step at B=32, the others waiting); the energies' stage adds the
//     chunks in order.
//  4. The energies, split by input step over the grid (CTA c takes input steps c, c + 128),
//     the location conv inside: each input step's K taps of every row's state (zeros past
//     its ends) staged in shared memory, f (B, F) of the step on the CUDA cores (loc_w
//     transposed in shared memory for the launch), pl (B, D) from f and l_w (transposed in
//     shared memory), then each row's sum over D of v_a tanh(u), its warps' sums in order.
//  5. The softmax, the new state and the context: G / B CTAs a row (4 at B=32, 128 at
//     B=1), each normalising the row's energies (the same sums in each) and forming
//     E / (G / B) of its context columns, SL slices of the input steps summed in order.
// A row's results are the same at any B. Scratch the caller allocates: the zoned h of both
// LSTMs and the state in two slots each (a step reads one and writes the other), x1, pq and
// the energies, and the barrier.
//
// Plain C entry point (loaded with ctypes): `ptrs` holds the device pointers in the order
// of the enum below (null for an absent optional input or for the residuals when none are
// saved), `ints` T, B, T_in, K, smoothing, cumulate, `mix` zoneout's (a, b) of c1, h1, c2,
// h2; the launch goes on `stream`; returns its cudaError_t (0: launched) and, where the
// card keeps too few CTAs resident, writes those it keeps and those needed into info[0..1].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a CTA: 8 warps
constexpr int NW = NT / 32;
// the widths the kernel is built for: the default hparams' and the paper profile's
constexpr int U = 1024, P = 256, E = 512, D = 128;
constexpr int F = 32;           // the location conv's filters
constexpr int UPC = 8;          // units a CTA
constexpr int G = U / UPC;      // CTAs
constexpr int K1 = P + E + U, K2 = 2 * U;
// k-quads: 16 columns, two k-tiles of 8, which a lane reads 4 columns at a time
constexpr int KQ_P = P / 16, KQ_E = E / 16, KQ_U = U / 16;
constexpr int KQ1 = K1 / 16, KQ2 = K2 / 16;
constexpr int MAX_B = 32;       // two m-tiles; the partials' shared memory sets it
constexpr int MAX_T_IN = 256;   // a thread an input step in the softmax
constexpr int MAX_K = 64;       // the location conv's taps, staged a row
constexpr int FRAG = 4 * 32;    // B fragments (uint4) of one k-quad of the CTA's 4 gate tiles
constexpr int PQ_CHUNKS = G / (D / 8);  // pq's K-chunks: 8 of 128 columns, a k-quad a warp
static_assert(PQ_CHUNKS * NW * 16 == U, "pq's K-chunks take a k-quad a warp");
constexpr int SL = 8;           // the context's slices of the input steps: NT / SL column groups
constexpr size_t WR_BYTES = (size_t)KQ_U * FRAG * 16;  // g2's h2 columns of the CTA: 128 KB
// the warps' partials of 32 rows x 32 columns (32 KB), which the energies' and the
// softmax's scratch share: the barrier between two stages parts their uses
constexpr size_t RED_FLOATS = (size_t)NW * MAX_B * 32;
constexpr size_t LOC_FLOATS = (size_t)MAX_K * F + (size_t)F * D;  // loc_w^T, l_w^T: 24 KB
constexpr size_t SMEM = WR_BYTES + (RED_FLOATS + LOC_FLOATS) * 4;
constexpr float NEG_INF = -4294967296.0f;  // -2**32 + 1 in float32 (attention.py)
constexpr unsigned FULL = 0xffffffffu;

enum Ptr {
  P_P2, P_KEYS, P_VALUES, P_MASK, P_G1_W, P_G1_B, P_G2_W, P_G2_B, P_Q_W, P_LOC_W, P_LOC_B,
  P_L_W, P_V_A, P_B_A, P_KEEP_C1, P_KEEP_H1, P_KEEP_C2, P_KEEP_H2,
  P_ALIGNS, P_X2, P_CTX,
  P_Z1, P_Z2, P_X1, P_C1P, P_H1P, P_C2P, P_H2P, P_STATE, P_PQ,
  P_H1C, P_H2C, P_X1B, P_PQB, P_EB, P_STB, P_BAR, P_PROF, N_PTRS
};

struct Args {
  // inputs, f32: p2 (T, B, P), keys (B, T_in, D), values (B, T_in, E), mask (B, T_in) or
  // null, g1 (4U, K1), g1_b (4U), g2 (4U, K2), g2_b, q_w (D, U), loc_w (F, 1, K), loc_b (F),
  // l_w (D, F), v_a, b_a (D); the keep-gates (T, B, U) bool of c1, h1, c2, h2 or null
  const float *p2, *keys, *values, *mask, *g1, *g1_b, *g2, *g2_b, *q_w, *loc_w, *loc_b, *l_w,
      *v_a, *b_a;
  const uint8_t* keep[4];
  float mix[4][2];
  // outputs: aligns (T, B, T_in), x2 (T, B, U), ctx (T, B, E)
  float *aligns, *x2, *ctx;
  // residuals, or all null: z1, z2 (T, B, 4U), x1, c1p, h1p, c2p, h2p (T, B, U), state
  // (T, B, T_in) (the state each step read), pq (T, B, D)
  float *z1, *z2, *x1, *c1p, *h1p, *c2p, *h2p, *state, *pq;
  // scratch: h1c, h2c (2, B, U), x1b (B, U), pqb (PQ_CHUNKS, B, D), eb (B, T_in), stb
  // (2, B, T_in) zeroed, bar (one u32, zero)
  float *h1c, *h2c, *x1b, *pqb, *eb, *stb;
  unsigned* bar;
  // a build with -DT2_PROFILE: (G, 2, STAGES) u64, each CTA's %globaltimer ns of each
  // stage's work (from the barrier before it to its arrival at its own) and of its wait
  unsigned long long* prof;
  int T, B, T_in, K, smoothing, cumulate;
};

constexpr int STAGES = 5;  // LSTM 1, LSTM 2, pq, the energies, the softmax and context

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float sig(float x) { return 1.0f / (1.0f + expf(-x)); }

// x as TF32 (round to nearest, ties away: cvt.rna), held in a 32-bit register
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (to about 2**-22 of x): hi its TF32 rounding, lo that of the rest
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k-quad order. mma.m16n8k8 sums 8 products whatever their order, so the columns of a
// k-quad (16 of them) are dealt to the k slots as 16-byte loads give them: lane (g, t) of
// a warp reads columns 4t .. 4t+3 of its rows; 4t and 4t+1 are its slots t and t+4 of the
// quad's first k-tile, 4t+2 and 4t+3 those of the second. The A operand (the rows) and the
// B operand (a weight's rows, as a torch Linear keeps them) take the same order, so each
// product sums the same terms.

template <bool CG>
__device__ __forceinline__ uint4 ld16(const void* p) {
  return CG ? __ldcg(reinterpret_cast<const uint4*>(p)) : __ldg(reinterpret_cast<const uint4*>(p));
}

// The B fragments of the k-quad at columns c0 .. of w (N, ld) row-major for the 8 output
// columns n0 ..: x, y the first k-tile's b0, b1, z, w the second's.
__device__ __forceinline__ uint4 wquad(const float* w, int ld, int n0, int c0, int lane) {
  return ld16<false>(w + (size_t)(n0 + lane / 4) * ld + c0 + 4 * (lane % 4));
}

// The rows r0 = 16 mt + g and r0 + 8 of x (rows of ld floats) at the lane's columns of the
// k-quad at c0: rows past B read as zeros. CG: x was written in this launch.
template <bool CG>
__device__ __forceinline__ void aquad(uint4 v[2], const float* x, int ld, int B, int mt, int c0,
                                      int lane) {
  const int r0 = 16 * mt + lane / 4, r1 = r0 + 8, c = c0 + 4 * (lane % 4);
  v[0] = v[1] = make_uint4(0u, 0u, 0u, 0u);
  if (r0 < B) v[0] = ld16<CG>(x + (size_t)r0 * ld + c);
  if (r1 < B) v[1] = ld16<CG>(x + (size_t)r1 * ld + c);
}

// d += the k-quad's two products of the rows v (as aquad loads them) and the B fragments
// b, each as 3xTF32: lo hi + hi lo + hi hi
__device__ __forceinline__ void mma_quad(float d[4], const uint32_t ah[2][4],
                                         const uint32_t al[2][4], const uint32_t bh[4],
                                         const uint32_t bl[4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    mma(d, al[k], bh[2 * k], bh[2 * k + 1]);
    mma(d, ah[k], bl[2 * k], bl[2 * k + 1]);
    mma(d, ah[k], bh[2 * k], bh[2 * k + 1]);
  }
}

// the A fragments a[k-tile][4] (hi and lo) of the rows v
__device__ __forceinline__ void split_a(uint32_t ah[2][4], uint32_t al[2][4], const uint4 v[2]) {
  const uint32_t x[2][4] = {{v[0].x, v[1].x, v[0].y, v[1].y}, {v[0].z, v[1].z, v[0].w, v[1].w}};
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(x[k][i]), ah[k][i], al[k][i]);
}

__device__ __forceinline__ void split_b(uint32_t bh[4], uint32_t bl[4], uint4 b) {
  split(__uint_as_float(b.x), bh[0], bl[0]);
  split(__uint_as_float(b.y), bh[1], bl[1]);
  split(__uint_as_float(b.z), bh[2], bl[2]);
  split(__uint_as_float(b.w), bh[3], bl[3]);
}

// d[m][q] += the k-quads kq0 + warp, kq0 + warp + NW, .. below kq1 of x (its columns from
// k-quad kq0 on; its m-tiles m < MT) times the B fragments wf(kq, q) of the 4 gate tiles.
// The loads of the rows of NB k-quads are started
// before their products, so that they are in flight together, and with PRE those of the
// weights too (streamed from L2; else shared memory's, read at their product). Each
// k-quad's six products are summed from zero on the tensor cores, then added to d on the
// CUDA cores: the tensor cores' sum truncates, so a long chain of them through d drifts
// (one chain of 84 per warp read 4e-6 of the gates' largest entry from the plain
// version's, H100 80GB HBM3, 700 W), where a chain of six and a rounded add do not.
// NB = 2 k-quads. The kernel is built once for each number of m-tiles (its registers are
// the build's largest need: one build for both spilled at 255); 4 at one m-tile read the
// same at B=1 (53.1 against 53.2 us a step), 8 spilled (109.9), H100 80GB HBM3, 700 W.
constexpr int NB = 2;

__device__ __forceinline__ void add_quad(float d[4], const uint32_t ah[2][4],
                                         const uint32_t al[2][4], const uint32_t bh[4],
                                         const uint32_t bl[4]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_quad(s, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

template <int MT, bool CG, bool PRE, typename WF>
__device__ __forceinline__ void segment(float d[2][4][4], const float* x, int ld, int B, int kq0,
                                        int kq1, int warp, int lane, WF wf) {
  for (int kb = kq0 + warp; kb < kq1; kb += NB * NW) {
    uint4 av[NB][MT][2];
    uint4 bw[PRE ? NB : 1][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int kq = kb + i * NW;
      if (kq < kq1) {
#pragma unroll
        for (int m = 0; m < MT; ++m) aquad<CG>(av[i][m], x, ld, B, m, 16 * (kq - kq0), lane);
        if (PRE)
#pragma unroll
          for (int q = 0; q < 4; ++q) bw[PRE ? i : 0][q] = wf(kq, q);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int kq = kb + i * NW;
      if (kq < kq1)
#pragma unroll
        for (int m = 0; m < MT; ++m) {  // an m-tile at a time: the B fragments split again
          uint32_t ah[2][4], al[2][4];
          split_a(ah, al, av[i][m]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t bh[4], bl[4];
            split_b(bh, bl, PRE ? bw[PRE ? i : 0][q] : wf(kq, q));
            add_quad(d[m][q], ah, al, bh, bl);
          }
        }
    }
  }
}

// The gate products of LSTM 1 (on [p2, ctx, h1], g1 streamed: at t = 0 the context and h1
// are zero) and LSTM 2 (on [x1, h2]: g2's x1 columns streamed, its h2 columns resident;
// at t = 0 h2 is zero) at MT m-tiles of the rows
template <int MT>
__device__ __forceinline__ void lstm1_products(float d[2][4][4], const float* g1, const float* p2,
                                               const float* ctx, const float* h1, int t, int B,
                                               int u0, int warp, int lane) {
  auto w = [&](int kq, int q) { return wquad(g1, K1, q * U + u0, 16 * kq, lane); };
  segment<MT, false, true>(d, p2, P, B, 0, KQ_P, warp, lane, w);
  if (t) {
    segment<MT, true, true>(d, ctx, E, B, KQ_P, KQ_P + KQ_E, warp, lane, w);
    segment<MT, true, true>(d, h1, U, B, KQ_P + KQ_E, KQ1, warp, lane, w);
  }
}

template <int MT>
__device__ __forceinline__ void lstm2_products(float d[2][4][4], const float* g2, const uint4* WR,
                                               const float* x1, const float* h2, int t, int B,
                                               int u0, int warp, int lane) {
  auto streamed = [&](int kq, int q) { return wquad(g2, K2, q * U + u0, 16 * kq, lane); };
  auto resident = [&](int kq, int q) { return WR[((kq - KQ_U) * 4 + q) * 32 + lane]; };
  segment<MT, true, true>(d, x1, U, B, 0, KQ_U, warp, lane, streamed);
  if (t) segment<MT, true, false>(d, h2, U, B, KQ_U, KQ2, warp, lane, resident);
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
// then the bias.
__device__ __forceinline__ void gate_values(float z[4], const float* red, int row, int i,
                                            const float* bias, int u) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = red[(size_t)row * 32 + 8 * q + i];
#pragma unroll
    for (int k = 1; k < NW; ++k) s += red[((size_t)k * MAX_B + row) * 32 + 8 * q + i];
    z[q] = s + __ldg(bias + q * U + u);
  }
}

// The LSTM cell on the gates z with the zoneout of c and h in place (the keep-gates kc, kh
// 0 or 1, or -1 for the expectation (ac, bc), (ah, bh)); hn the step's output h_new.
__device__ __forceinline__ void lstm_cell(const float z[4], float& c, float& h, float& hn,
                                          int kc, int kh, const float mc[2], const float mh[2]) {
  const float si = sig(z[0]), tg = tanhf(z[1]);
  const float sf = sig(z[2] + 1.0f);
  const float so = sig(z[3]);
  const float cn = sf * c + si * tg;
  hn = so * tanhf(cn);
  c = kc >= 0 ? (kc ? cn : c) : mc[0] * cn + mc[1] * c;
  h = kh >= 0 ? (kh ? hn : h) : mh[0] * hn + mh[1] * h;
}

__device__ __forceinline__ int keep_of(const uint8_t* keep, size_t i) {
  return keep ? (int)keep[i] : -1;
}

// MT: the m-tiles of the rows, each warp takes all (1 for B <= 16, 2 for B <= 32)
template <int MT>
__global__ void __launch_bounds__(NT, 1) decoder_fwd_loop_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* WR = reinterpret_cast<uint4*>(smem);           // (KQ_U, 4, 32)
  float* RED = reinterpret_cast<float*>(WR + (size_t)KQ_U * FRAG);
  float* LWK = RED + RED_FLOATS;           // loc_w^T (K, F)
  float* LWT = LWK + MAX_K * F;            // l_w^T (F, D)
  float* KQ = RED;                         // stage 4: keys + pq of the input step (B, D)
  float* WIN = KQ + MAX_B * D;             // ... each row's K taps of the state (B, MAX_K)
  float* FT = WIN + MAX_B * MAX_K;         // ... the location features (B, F)
  float* EP = FT + MAX_B * F;              // ... each row's sums of 4 warps' d (4, MAX_B)
  float* AL = RED;                         // stage 5: the row's alignments
  float4* CP = reinterpret_cast<float4*>(RED + 256);  // ... the context's partials (NT)
  __shared__ float red[NW];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cta = blockIdx.x, B = a.B, T_in = a.T_in, K = a.K;
  const int pad_lo = (K - 1) / 2;           // SAME: the taps before the position
  const int u0 = UPC * cta;
  const uint8_t* keep_h1 = a.keep[1];

  // --- once a launch: the resident B fragments and the location weights, transposed ---
  for (int i = tid; i < KQ_U * FRAG; i += NT)
    WR[i] = wquad(a.g2, K2, (i % FRAG / 32) * U + u0, 16 * (KQ_U + i / FRAG), i % 32);
  for (int i = tid; i < F * K; i += NT) LWK[(i % K) * F + i / K] = __ldg(a.loc_w + i);
  for (int i = tid; i < D * F; i += NT) LWT[(i % F) * D + i / F] = __ldg(a.l_w + i);
  __syncthreads();

  // this thread's (row, unit) of the cells, their zoned c and h in registers
  const int crow = tid / UPC, ci = tid % UPC, cu = u0 + ci;
  const bool cell = crow < B;
  float c1 = 0.f, h1 = 0.f, c2 = 0.f, h2 = 0.f;
  const size_t BU = (size_t)B * U, BT = (size_t)B * T_in;
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

    // --- 1. LSTM 1 on [p2, ctx, h1] ---
    {
      float d[2][4][4] = {};
      const float* p2 = a.p2 + tb * P;
      const float* ctx = t ? a.ctx + (tb - B) * E : a.ctx;
      const float* hp = a.h1c + prev * BU;
      lstm1_products<MT>(d, a.g1, p2, ctx, hp, t, B, u0, warp, lane);
      put_partials(RED, d, MT, warp, lane);
      __syncthreads();
      if (cell) {
        float z[4], hn;
        gate_values(z, RED, crow, ci, a.g1_b, cu);
        const size_t i = (tb + crow) * U + cu;
        lstm_cell(z, c1, h1, hn, keep_of(a.keep[0], i), keep_of(keep_h1, i), a.mix[0], a.mix[1]);
        a.h1c[cur * BU + (size_t)crow * U + cu] = h1;
        a.x1b[(size_t)crow * U + cu] = hn;
        if (a.z1) {
#pragma unroll
          for (int q = 0; q < 4; ++q) __stcs(a.z1 + (tb + crow) * 4 * U + q * U + cu, z[q]);
          __stcs(a.x1 + i, hn);
          __stcs(a.c1p + i, c1);
          __stcs(a.h1p + i, h1);
        }
      }
    }
    grid_sync(a.bar, target, times, 0);

    // --- 2. LSTM 2 on [x1, h2] ---
    {
      float d[2][4][4] = {};
      const float* hp = a.h2c + prev * BU;
      lstm2_products<MT>(d, a.g2, WR, a.x1b, hp, t, B, u0, warp, lane);
      put_partials(RED, d, MT, warp, lane);
      __syncthreads();
      if (cell) {
        float z[4], hn;
        gate_values(z, RED, crow, ci, a.g2_b, cu);
        const size_t i = (tb + crow) * U + cu;
        lstm_cell(z, c2, h2, hn, keep_of(a.keep[2], i), keep_of(a.keep[3], i), a.mix[2], a.mix[3]);
        a.h2c[cur * BU + (size_t)crow * U + cu] = h2;
        a.x2[i] = hn;
        if (a.z2) {
#pragma unroll
          for (int q = 0; q < 4; ++q) __stcs(a.z2 + (tb + crow) * 4 * U + q * U + cu, z[q]);
          __stcs(a.c2p + i, c2);
          __stcs(a.h2p + i, h2);
        }
      }
    }
    grid_sync(a.bar, target, times, 1);

    // --- 3. pq = x2 @ q_w^T over the grid: CTA c the columns 8 (c % 16) .. of the K-chunk
    // c / 16 (a k-quad a warp), the warps' sums in order into the chunk's slot of pqb ---
    {
      const int tile = cta % (D / 8), chunk = cta / (D / 8), kq = chunk * NW + warp;
      float d[2][4] = {};
      uint4 av[2][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) aquad<true>(av[m], a.x2 + tb * U, U, B, m, 16 * kq, lane);
      uint32_t bh[4], bl[4];
      split_b(bh, bl, wquad(a.q_w, U, 8 * tile, 16 * kq, lane));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ah[2][4], al[2][4];
        split_a(ah, al, av[m]);
        add_quad(d[m], ah, al, bh, bl);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
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
        a.pqb[((size_t)chunk * B + row) * D + 8 * tile + col] = s;
      }
    }
    grid_sync(a.bar, target, times, 2);

    // --- 4. the energies of input steps cta, cta + G, ..: the location conv of the state
    // at the step, its projection, and each row's sum of v_a tanh(u) ---
    const float* st = a.stb + prev * BT;  // the state the step reads
    for (int j = cta; j < T_in; j += G) {
      for (int i = tid; i < B * D; i += NT) {  // pq: the K-chunks' sums added in order
        float q = __ldcg(a.pqb + i);
#pragma unroll
        for (int c = 1; c < PQ_CHUNKS; ++c) q += __ldcg(a.pqb + (size_t)c * B * D + i);
        KQ[i] = __ldg(a.keys + ((size_t)(i / D) * T_in + j) * D + i % D) + q;
        if (j == 0 && a.pq) __stcs(a.pq + tb * D + i, q);
      }
      for (int i = tid; i < B * K; i += NT) {
        const int r = i / K, k = i % K, s = j + k - pad_lo;
        WIN[r * MAX_K + k] = s >= 0 && s < T_in ? __ldcg(st + (size_t)r * T_in + s) : 0.f;
      }
      __syncthreads();
      // f: filter `lane` of rows warp, warp + NW, ..
      for (int r = warp; r < B; r += NW) {
        float s = 0.f;
        for (int k = 0; k < K; ++k) s = fmaf(WIN[r * MAX_K + k], LWK[k * F + lane], s);
        FT[r * F + lane] = s + __ldg(a.loc_b + lane);
      }
      __syncthreads();
      // pl and v_a tanh(u) of d = tid % D and rows tid / D, + 2, ..; summed over the d of
      // the warp's lanes, then over the row's 4 warps in order
      {
        const int dd = tid % D, half = tid / D;
        const float va = __ldg(a.v_a + dd), ba = __ldg(a.b_a + dd);
        float pl[MAX_B / 2];
#pragma unroll
        for (int i = 0; i < MAX_B / 2; ++i) pl[i] = 0.f;
        for (int fi = 0; fi < F; ++fi) {
          const float w = LWT[fi * D + dd];
#pragma unroll
          for (int i = 0; i < MAX_B / 2; ++i)
            if (half + 2 * i < B) pl[i] = fmaf(FT[(half + 2 * i) * F + fi], w, pl[i]);
        }
#pragma unroll
        for (int i = 0; i < MAX_B / 2; ++i) {
          const int r = half + 2 * i;
          if (r >= B) break;  // the same r in every lane of the warp
          const float u = (KQ[r * D + dd] + pl[i]) + ba;
          float v = va * tanhf(u);
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
          if (lane == 0) EP[(warp % 4) * MAX_B + r] = v;
        }
      }
      __syncthreads();
      if (tid < B) {
        float e = EP[tid];
        for (int w = 1; w < 4; ++w) e += EP[w * MAX_B + tid];
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
        AL[tid] = al;
        if (ch == 0) {
          const size_t i = (size_t)b * T_in + tid, o = (tb + b) * T_in + tid;
          const float old = __ldcg(st + i);
          const float nw = a.cumulate ? al + old : al;
          a.aligns[o] = al;
          a.stb[cur * BT + i] = nw;
          if (a.state) __stcs(a.state + o, old);
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
            s.x = fmaf(al, x.x, s.x);
            s.y = fmaf(al, x.y, s.y);
            s.z = fmaf(al, x.z, s.z);
            s.w = fmaf(al, x.w, s.w);
          }
        }
        CP[sl * ng + grp] = s;
      }
      __syncthreads();
      if (tid < CW && ch * CW + tid < E) {
        const float* cp = reinterpret_cast<const float*>(CP);
        float s = cp[tid];
        for (int k = 1; k < SL; ++k) s += cp[k * CW + tid];
        a.ctx[(tb + b) * E + ch * CW + tid] = s;
      }
    }
    grid_sync(a.bar, target, times, 4);
  }
#ifdef T2_PROFILE
  if (tid == 0 && a.prof)
    for (int i = 0; i < 2 * STAGES; ++i) a.prof[(size_t)cta * 2 * STAGES + i] = times[i];
#endif
}

// The launch of the build for MT m-tiles: its shared memory, the occupancy check, the
// cooperative launch.
template <int MT>
cudaError_t launch(Args& a, int* info, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decoder_fwd_loop_f32_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_fwd_loop_f32_kernel<MT>,
                                                      NT, SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < G) {  // the grid barrier needs every CTA resident
    info[0] = per_sm * sms;
    info[1] = G;
    return cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)decoder_fwd_loop_f32_kernel<MT>, dim3(G),
                                    dim3(NT), args, SMEM, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int t2_decoder_fwd_loop_f32(void* const* p, const int* n, const float* mix, int* info,
                                       void* stream) {
  Args a;
  a.p2 = (const float*)p[P_P2];
  a.keys = (const float*)p[P_KEYS];
  a.values = (const float*)p[P_VALUES];
  a.mask = (const float*)p[P_MASK];
  a.g1 = (const float*)p[P_G1_W];
  a.g1_b = (const float*)p[P_G1_B];
  a.g2 = (const float*)p[P_G2_W];
  a.g2_b = (const float*)p[P_G2_B];
  a.q_w = (const float*)p[P_Q_W];
  a.loc_w = (const float*)p[P_LOC_W];
  a.loc_b = (const float*)p[P_LOC_B];
  a.l_w = (const float*)p[P_L_W];
  a.v_a = (const float*)p[P_V_A];
  a.b_a = (const float*)p[P_B_A];
  for (int g = 0; g < 4; ++g) {
    a.keep[g] = (const uint8_t*)p[P_KEEP_C1 + g];
    a.mix[g][0] = mix[2 * g];
    a.mix[g][1] = mix[2 * g + 1];
  }
  a.aligns = (float*)p[P_ALIGNS];
  a.x2 = (float*)p[P_X2];
  a.ctx = (float*)p[P_CTX];
  a.z1 = (float*)p[P_Z1];
  a.z2 = (float*)p[P_Z2];
  a.x1 = (float*)p[P_X1];
  a.c1p = (float*)p[P_C1P];
  a.h1p = (float*)p[P_H1P];
  a.c2p = (float*)p[P_C2P];
  a.h2p = (float*)p[P_H2P];
  a.state = (float*)p[P_STATE];
  a.pq = (float*)p[P_PQ];
  a.h1c = (float*)p[P_H1C];
  a.h2c = (float*)p[P_H2C];
  a.x1b = (float*)p[P_X1B];
  a.pqb = (float*)p[P_PQB];
  a.eb = (float*)p[P_EB];
  a.stb = (float*)p[P_STB];
  a.bar = (unsigned*)p[P_BAR];
  a.prof = (unsigned long long*)p[P_PROF];
  a.T = n[0];
  a.B = n[1];
  a.T_in = n[2];
  a.K = n[3];
  a.smoothing = n[4];
  a.cumulate = n[5];
  if (a.T < 0 || a.B < 1 || a.B > MAX_B || a.T_in < 1 || a.T_in > MAX_T_IN || a.K < 1 ||
      a.K > MAX_K)
    return (int)cudaErrorInvalidValue;
  return (int)(a.B > 16 ? launch<2>(a, info, (cudaStream_t)stream)
                        : launch<1>(a, info, (cudaStream_t)stream));
}
