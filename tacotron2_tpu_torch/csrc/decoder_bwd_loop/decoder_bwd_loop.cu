// The teacher-forced Tacotron decoder's reverse recurrence on Hopper: all T steps of the
// fused decoder's backward loop in one persistent launch (tacotron2_tpu_torch/ops/
// decoder_vjp.py, `decoder_bwd_loop`, where `loop_applies` holds: bf16, the folded
// location tier, every step on its teacher frame, the widths below, B <= 32).
//
// It replaces, where it runs, the step loop of the port's attention_bwd and two
// lstm_cell_bwd (csrc/decoder/decoder_step.cu) with the library products between them, and
// so the XLA fusions of the JAX package's fused decoder that those kernels stand for
// (tacotron2_tpu/ops/fused_decoder.py: `_bwd_rule`'s `step_bwd` and its reverse scan,
// :494-571, with `_att_bwd`, :257-338, and `_lstm_bwd`, :130-150). Its arithmetic is the
// port's `_backward` (`_reverse_step` in decoder_vjp.py, its plain version
// `_decoder_bwd_loop_plain`), which keeps the state's gradient that the JAX rule drops
// without cumulative weights. No step reads its own frame, so the frame and stop
// projections' gradient dproj runs before the launch, once over the T * B rows, and the
// prenet's (dz1 @ g1's prenet columns) after it; the deferred weight gradients, dvalues
// and dteacher stay after it too.
//
// One reverse step t, in the port's bf16 rounding: dctx_total = bf16(dproj[U:] + dctx),
// dalign = values . dctx_total in f32; the energies recomputed from the state the step read
// (pl = bf16(bf16(state) @ loc_n), u = ((keys + pq) + (pl + pl_b)) + b_a, e = sum_D v_a
// tanh u, NEG_INF off the mask); the softmax's (or the smoothing's) backward of dal =
// (dalign + ga) + dstate, de, and du = (de v_a)(1 - tanh^2 u); dkeys += du, dva += de tanh
// u, dpq = sum_j du (dba += it), df = bf16(bf16(du) @ l_w), dl += bf16(du)^T f (f the
// location features of the rounded state, K taps rounded where `_loc_features` rounds),
// the state's gradient bf16(du) @ loc_n^T (added to the carried one where the alignments
// cumulate); LSTM 2's backward (decoder_step.cu's lstm_cell_bwd arithmetic) on dproj[:U]
// + bf16(bf16(dpq) @ q_w); din2 = bf16(dz2 @ g2); LSTM 1's backward on din2[:U]; din1 =
// bf16(dz1 @ g1) past the prenet's columns: the carried dctx and dh1. Built with
// --fmad=false: no product and sum contracted into one rounding that the plain version
// does not make.
//
// What bounds it on an H100. A step's products are about 2 B (4U 2U + 4U (U + E) + 2 T_in^2
// D + 2 T_in D F + D U) operations, ~1.2 GFLOP at B=32 and T_in=100: 1.2 us at the bf16
// tensor cores' 989 TFLOP/s, beside 2 B T_in (E + F K) f32 operations off them (0.1 us at
// 67 TFLOP/s). Its bytes (the residuals it reads and the gradients it writes, about 1 MB
// a step at B=32) take 0.3 us at 3.35 TB/s. So it is bound by operations, at about 1.3
// us a step. What a step pays here is latency: a chain of six dependent stages, each a
// few small products or sums spread over the grid, with a grid barrier after each.
//
// Design: the forward loop's (csrc/decoder_loop/decoder_loop.cu). One cooperative launch of
// G = U / 8 = 128 CTAs of 256 threads, all resident (the entry checks the occupancy: its
// grid barrier, an arrival counter that the caller zeroes, needs every CTA). CTA c owns
// units 8c .. 8c+7 of both LSTMs: the gradients dh and dc of both cells sit in registers
// for the whole launch, a thread a (row, unit); dctx and the state's gradient in scratch.
// Its products run on the tensor cores (mma.sync.m16n8k16, bf16 operands, f32
// accumulation, the rows padded to 16 or 32 with zeros), the k-pair order and the warps'
// split of K those of the forward loop. Resident in shared memory for the launch, packed at
// its start in fragment order: g2's 16 columns of the CTA (its units' dx1 and dh2, 128 KB)
// and g1's 8 h1 columns (64 KB); g1's 4 context columns of the CTA stream from a
// fragment-ordered copy in global memory that each CTA writes at the start (32 KB a CTA a
// step from L2), since the warps' partials need the rest of shared memory. Six stages a
// step, a grid barrier after each:
//  1. dalign: the warps of the grid spread over the (row, input step) pairs, each warp
//     forming its row's dctx_total; then the energies of the CTA's input steps c, c + 128:
//     pl^T (D, B) on the tensor cores from loc_nt (the forward's split by input step), tanh
//     u kept in registers for stage 2.
//  2. Every CTA with an input step recomputes each row's softmax statistics and sum of dal
//     align in one pass (a running max and sums rescaled as it grows, 8 to 32 lanes a row
//     as B leaves room), then for its input steps: du in registers (dkeys and dva summed
//     in place: dkeys in global memory, an element a thread; dva a partial of the CTA), du
//     f32 to scratch for dpq, the location features f from the state's taps and loc_w
//     staged in shared memory, dl += du^T f (mma, its A fragments the du registers), df =
//     du @ l_w (mma), and this input step's part of the state's gradient, du @ loc_n^T
//     (mma, loc_n's rows the B fragments) to scratch.
//  3. The sums over the input steps: dpq (and dba, its f32 sums, held by one thread a (row,
//     d) for the launch) by D tiles, the state's gradient by 32 input steps.
//  4. LSTM 2's backward for the CTA's units, dhb = dpq @ q_w on the tensor cores (each
//     cell's residuals loaded before the product, as in stage 5).
//  5. din2's 16 columns of the CTA (K = 4U, every CTA's dz2), then LSTM 1's backward on
//     them with no barrier between.
//  6. din1's h1 and context columns of the CTA: the carried dh1 and dctx.
// Every accumulator sums in a fixed order: dkeys an element a thread in step order, dva and
// dl per-CTA partials and dba one thread's, the CTAs' partials added in CTA order after the
// last step. No atomics but the barrier's: two launches on the same inputs are bit-identical.
//
// Plain C entry point (loaded with ctypes): `ptrs` holds the device pointers in the order
// of the enum below (null for an absent mask or keep-gate), `ints` T, B, T_in, the location
// conv's width K, smoothing, cumulate, `keep` zoneout's expectation keep (JAX's 1 - rate in
// bf16) of c1, h1, c2, h2; the launch goes on `stream`; returns its cudaError_t (0:
// launched) and, where the card keeps too few CTAs resident, writes those it keeps and
// those needed into info[0..1].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads a CTA: 8 warps
constexpr int NW = NT / 32;
// the widths the kernel is built for: the default hparams' and the paper profile's
constexpr int U = 1024, P = 256, E = 512, D = 128, F = 32;
constexpr int UPC = 8;        // units a CTA
constexpr int G = U / UPC;    // CTAs
constexpr int EPC = E / G;    // context columns a CTA: 4
constexpr int K1 = P + E + U, K2 = 2 * U, KZ = 4 * U;  // g1's and g2's inputs, the gates
constexpr int KPZ = KZ / 32;  // k-pairs of the gates' gradients
constexpr int MAX_B = 32;       // two m-tiles
constexpr int MAX_T_IN = 192;   // six input steps a lane in the row statistics
constexpr int JPC = (MAX_T_IN + G - 1) / G;  // input steps a CTA
// k-pairs whose row loads a warp issues before their products in stages 5 and 6 (4 of them
// spill registers: 65.5 us a step at B=32 against 54.1 with 2, H100 80GB HBM3, 700 W)
constexpr int RES_BATCH = 2;
constexpr int DS = D + 8;       // the rounded du's row in shared memory (bf16), padded
constexpr int FLD = MAX_B + 8;  // the features' row (a filter's rows b, bf16), padded
constexpr size_t W2_BYTES = (size_t)KPZ * 2 * 32 * 16;  // g2's 16 columns of the CTA: 128 KB
constexpr size_t W1H_BYTES = (size_t)KPZ * 32 * 16;     // g1's 8 h1 columns of them: 64 KB
// the stages' scratch (the barrier between two stages parts their uses): stage 1's state
// fragments, keys + pq and the warps' energy sums; stage 2's row statistics, du and the
// features; stages 5 and 6's warps' partials (32 rows x 16 columns); at the start, g1's
// context columns being packed
constexpr size_t SCR_BYTES = 32768;
constexpr size_t SB_OFF = 0, KQ_OFF = 12288, EP_OFF = KQ_OFF + MAX_B * D * 4;
constexpr size_t DUB_OFF = 1024, FS_OFF = DUB_OFF + MAX_B * DS * 2;
constexpr int MAX_K = 64;      // the location conv's widest kernel
constexpr int KLD = MAX_K + 1; // the rows of its taps in shared memory (f32), odd
constexpr size_t SW_OFF = FS_OFF + F * FLD * 2, LW_OFF = SW_OFF + MAX_B * KLD * 4;
constexpr size_t SMEM = W2_BYTES + W1H_BYTES + SCR_BYTES;
constexpr float NEG_INF = -4294967296.0f;  // -2**32 + 1 in float32 (attention.py)
constexpr unsigned FULL = 0xffffffffu;
static_assert(EP_OFF + NW * MAX_B * 4 <= SCR_BYTES && LW_OFF + F * KLD * 4 <= SCR_BYTES
              && (size_t)NW * MAX_B * 16 * 4 <= SCR_BYTES && (size_t)KPZ * 16 * 16 <= SCR_BYTES,
              "the stages' scratch");

enum Ptr {
  P_KEYS, P_VALUES, P_MASK, P_DPROJ, P_GA, P_Z1, P_Z2, P_C1P, P_C2P, P_STATE, P_PQ,
  P_G1_W, P_G2_W, P_Q_W, P_LOC_NT, P_LOC_N, P_PL_B, P_V_A, P_B_A, P_LOC_W, P_LOC_B, P_L_W,
  P_KEEP_C1, P_KEEP_H1, P_KEEP_C2, P_KEEP_H2,
  P_DZ1, P_DZ2, P_DPQ, P_DCTX_TOTAL, P_DF, P_DKEYS, P_DVA, P_DBA, P_DL,
  P_DCTX, P_DSTATE, P_DALIGN, P_EB, P_DUS, P_DSP, P_DPQB, P_G1C, P_DVAP, P_DLP, P_BAR,
  P_PROF, N_PTRS
};

struct Args {
  // inputs: keys (B, T_in, D), values (B, T_in, E) f32, mask (B, T_in) f32 or null, dproj
  // (T, B, U + E), ga (T, B, T_in) f32 the alignments' gradient; the forward's residuals
  // z1, z2 (T, B, 4U), c1p, c2p (T, B, U), state (T, B, T_in) f32, pq (T, B, D); g1 (4U,
  // K1), g2 (4U, K2), q_w (D, U), loc_nt (T_in D, TP) (the forward loop's: loc_nt[j D +
  // d][k] = loc_n[k][j D + d], zero for k >= T_in), loc_n (T_in, T_in D), pl_b, v_a, b_a
  // (D) f32, loc_w (F, 1, K), loc_b (F), l_w (D, F); the keep-gates (T, B, U) bool of c1,
  // h1, c2, h2 or null
  const bf16 *keys, *dproj, *z1, *z2, *c1p, *c2p, *pq, *g1, *g2, *q_w, *loc_nt, *loc_n;
  const bf16 *loc_w, *loc_b, *l_w;
  const float *values, *mask, *ga, *state, *pl_b, *v_a, *b_a;
  const uint8_t* keep[4];
  float a[4];
  // outputs: dz1, dz2 (T, B, 4U), dpq (T, B, D), dctx_total (T, B, E), df (T, B T_in, F);
  // dkeys (B, T_in, D) f32 zeroed, dva, dba (B, D) f32, dl (D, F) f32
  bf16 *dz1, *dz2, *dpq, *dctx_total, *df;
  float *dkeys, *dva, *dba, *dl;
  // scratch: dctx (B, E) f32 and dstate (B, TP) f32 zeroed, the carried gradients;
  // dalign, eb (B, T_in) f32; dus (B, T_in, D) f32 the step's du; dsp (T_in, B, TP) f32
  // each input step's part of the state's gradient; dpqb (B, D); g1c (G, KPZ, 16) uint4,
  // g1's context columns of each CTA as B fragments; dvap (G, B, D), dlp (G, D, F) f32 the
  // CTAs' partials; bar (one u32, zero)
  float *dctx, *dstate, *dalign, *eb, *dus, *dsp, *dvap, *dlp;
  bf16* dpqb;
  uint4* g1c;
  unsigned* bar;
  // a build with -DT2_PROFILE: (G, 2, STAGES) u64, each CTA's %globaltimer ns of each
  // stage's work (from the barrier before it to its arrival at its own) and of its wait
  unsigned long long* prof;
  int T, B, T_in, K, smoothing, cumulate;
};

// dalign and the energies, the normalisation's backward and the location path, the sums
// over the input steps, LSTM 2, din2 and LSTM 1, din1
constexpr int STAGES = 6;

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The k-pair order, the forward loop's: a k-pair is 32 columns, two k-tiles of 16; lane (g,
// t) reads columns 8t .. 8t+7 of its rows, 8t, 8t+1 and 8t+2, 8t+3 its slots 2t, 2t+1 and
// 2t+8, 2t+9 of the pair's first k-tile, 8t+4 .. 8t+7 those of the second. The A operand
// (the rows) and the B operand (a weight's columns, packed in that order) take the same
// order, so each product sums the same terms.

template <bool CG>
__device__ __forceinline__ uint4 ld16(const void* p) {
  return CG ? __ldcg(reinterpret_cast<const uint4*>(p)) : __ldg(reinterpret_cast<const uint4*>(p));
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

// d[m][q] += the k-pairs kp0 + warp, kp0 + warp + NW, .. below kp1 of x (its m-tiles m <
// MT) times the B fragments wf(kp, q) of NQ column tiles. The loads of the rows of NB
// k-pairs are issued before their products, and with PRE those of the weights too.
template <bool CG, bool PRE, int NB, int NQ, typename WF>
__device__ __forceinline__ void segment(float d[2][NQ][4], const bf16* x, int ld, int B, int MT,
                                        int kp0, int kp1, int warp, int lane, WF wf) {
  for (int kb = kp0 + warp; kb < kp1; kb += NB * NW) {
    uint32_t af[NB][2][2][4];
    uint4 bw[PRE ? NB : 1][NQ];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int kp = kb + i * NW;
      if (kp < kp1) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (m < MT) apair<CG>(af[i][m], x, ld, B, m, 32 * (kp - kp0), lane);
        if (PRE)
#pragma unroll
          for (int q = 0; q < NQ; ++q) bw[PRE ? i : 0][q] = wf(kp, q);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int kp = kb + i * NW;
      if (kp < kp1)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
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
// STAGES each; times[2 STAGES] the last release); stage -1 is not timed.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target,
                                          unsigned long long* times, int stage) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
#ifdef T2_PROFILE
    const unsigned long long arrived = globaltimer();
    if (stage >= 0) times[stage] += arrived - times[2 * STAGES];
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
    if (stage >= 0) times[STAGES + stage] += times[2 * STAGES] - arrived;
#endif
  }
  __syncthreads();
}

// The warp's partial sums d of its m-tiles' NQ column tiles into red[warp][row][8 NQ].
template <int NQ>
__device__ __forceinline__ void put_partials(float* red, const float d[2][NQ][4], int MT,
                                             int warp, int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m >= MT) break;
    const int row = 16 * m + lane / 4, col = 2 * (lane % 4);
    float* r = red + ((size_t)warp * MAX_B + row) * 8 * NQ;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      r[8 * q + col] = d[m][q][0];
      r[8 * q + col + 1] = d[m][q][1];
      r[8 * 8 * NQ + 8 * q + col] = d[m][q][2];
      r[8 * 8 * NQ + 8 * q + col + 1] = d[m][q][3];
    }
  }
}

// The product's column col of row `row`: the warps' partials (16 columns) added in warp
// order, rounded to bf16.
__device__ __forceinline__ float column(const float* red, int row, int col) {
  float s = red[(size_t)row * 16 + col];
#pragma unroll
  for (int k = 1; k < NW; ++k) s += red[((size_t)k * MAX_B + row) * 16 + col];
  return rd(s);
}

__device__ __forceinline__ int keep_of(const uint8_t* keep, size_t i) {
  return keep ? (int)keep[i] : -1;
}

// The LSTM cell's backward with its zoneout bypasses, decoder_step.cu's lstm_cell_bwd in
// bf16: from the gates z (rounded) and c_prev, the step output's gradient ds (rounded) and
// the carried dh and dc of the zoned h and c, the keep-gates kc, kh 0 or 1 (-1: the
// expectation keeps ac, ah). Writes the gates' gradients dz (i, g, f, o) and the h bypass
// (1 - ah) dh, and turns dc into c_prev's gradient.
__device__ __forceinline__ void lstm_cell_bwd(const float z[4], float cp, float ds, float dh,
                                              float& dc, int kc, int kh, float a_c, float a_h,
                                              float dz[4], float& bypass) {
  const float ac = kc >= 0 ? (kc ? 1.0f : 0.0f) : a_c;
  const float ah = kh >= 0 ? (kh ? 1.0f : 0.0f) : a_h;
  const float dhn = ds + ah * dh;
  const float si = sig(z[0]), tg = rd(tanhf(z[1]));
  const float sf = sig(rd(z[2] + 1.0f));
  const float so = sig(z[3]);
  const float cn = rd(rd(sf * cp) + rd(si * tg));
  const float tc = rd(tanhf(cn));
  const float dcn = dhn * so * rd(1.0f - rd(tc * tc)) + ac * dc;
  dz[3] = dhn * tc * so * rd(1.0f - so);
  dz[2] = dcn * cp * sf * rd(1.0f - sf);
  dz[0] = dcn * tg * si * rd(1.0f - si);
  dz[1] = dcn * si * rd(1.0f - rd(tg * tg));
  dc = dcn * sf + (1.0f - ac) * dc;
  bypass = (1.0f - ah) * dh;
}

__global__ void __launch_bounds__(NT, 1) decoder_bwd_loop_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* W2 = reinterpret_cast<uint4*>(smem);     // (KPZ, 2, 32): g2's columns u0.., U + u0..
  uint4* W1H = W2 + (size_t)KPZ * 2 * 32;         // (KPZ, 32): g1's h1 columns u0..
  unsigned char* scr = reinterpret_cast<unsigned char*>(W1H + (size_t)KPZ * 32);
  __shared__ uint4 QWF[D / 32 * 32];  // q_w's columns u0.. as B fragments (4 k-pairs)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cta = blockIdx.x, B = a.B, T_in = a.T_in, K = a.K;
  const int MT = B > 16 ? 2 : 1;            // m-tiles of the rows
  const int NTB = (B + 7) / 8;              // n-tiles of the rows
  const int TP = (T_in + 31) / 32 * 32, KPI = TP / 32;
  const int pad = (K - 1) / 2;              // the location conv's SAME padding before
  const int u0 = UPC * cta;

  // --- once a launch: the B fragments, g2's and g1's h1 columns resident, g1's context
  // columns to global memory, q_w's columns; l_w's for df in registers ---
  {
    bf16* w2 = reinterpret_cast<bf16*>(W2);
    bf16* w1 = reinterpret_cast<bf16*>(W1H);
    bf16* gc = reinterpret_cast<bf16*>(scr);
    // the value (k, column n of 8) goes to k-pair k / 32, lane 4 n + k % 32 / 8, slot k % 8
    for (int i = tid; i < KZ * 2; i += NT) {
      const int k = i / 2, q = i % 2;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.g2 + (size_t)k * K2 + q * U + u0));
      const bf16* vb = reinterpret_cast<const bf16*>(&v);
      const size_t o = ((size_t)(k / 32) * 2 + q) * 32 + k % 32 / 8;
#pragma unroll
      for (int n = 0; n < 8; ++n) w2[(o + 4 * n) * 8 + k % 8] = vb[n];
    }
    for (int k = tid; k < KZ; k += NT) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.g1 + (size_t)k * K1 + P + E + u0));
      const bf16* vb = reinterpret_cast<const bf16*>(&v);
      const size_t o = (size_t)(k / 32) * 32 + k % 32 / 8;
#pragma unroll
      for (int n = 0; n < 8; ++n) w1[(o + 4 * n) * 8 + k % 8] = vb[n];
      // the context columns: 4 of them, each lane (g, t) reading column g % 4's (16 a k-pair)
      const uint2 c = __ldg(reinterpret_cast<const uint2*>(a.g1 + (size_t)k * K1 + P + EPC * cta));
      const bf16* cb = reinterpret_cast<const bf16*>(&c);
      const size_t oc = (size_t)(k / 32) * 16 + k % 32 / 8;
#pragma unroll
      for (int n = 0; n < EPC; ++n) gc[(oc + 4 * n) * 8 + k % 8] = cb[n];
    }
    for (int i = tid; i < D / 32 * 32; i += NT) {
      const int kp = i / 32, l = i % 32;
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16* q = a.q_w + (size_t)(32 * kp + 8 * (l % 4) + 2 * e) * U + u0 + l / 4;
        h[e] = (uint32_t)__bfloat16_as_ushort(q[0]) | ((uint32_t)__bfloat16_as_ushort(q[U]) << 16);
      }
      QWF[i] = make_uint4(h[0], h[1], h[2], h[3]);
    }
    __syncthreads();
    uint4* g1c = a.g1c + (size_t)cta * KPZ * 16;
    for (int i = tid; i < KPZ * 16; i += NT) g1c[i] = reinterpret_cast<const uint4*>(scr)[i];
  }
  // l_w's B fragments of df: warp w the filters 8 (w % 4) .., k = d
  uint32_t lwf[D / 16][2];
  {
    const int c = 8 * (warp % 4) + gid;
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      const int d0 = 16 * kt + 2 * tig;
      lwf[kt][0] = (uint32_t)__bfloat16_as_ushort(a.l_w[d0 * F + c])
                   | ((uint32_t)__bfloat16_as_ushort(a.l_w[(d0 + 1) * F + c]) << 16);
      lwf[kt][1] = (uint32_t)__bfloat16_as_ushort(a.l_w[(d0 + 8) * F + c])
                   | ((uint32_t)__bfloat16_as_ushort(a.l_w[(d0 + 9) * F + c]) << 16);
    }
  }
  __syncthreads();

  // this thread's (row, unit) of the cells, the gradients of their zoned h and c in
  // registers, and the h bypasses from one stage to the next
  const int crow = tid / UPC, ci = tid % UPC, cu = u0 + ci;
  const bool cell = crow < B;
  float dh1 = 0.f, dc1 = 0.f, dh2 = 0.f, dc2 = 0.f, byp1 = 0.f, byp2 = 0.f;
  // this thread's d = 16 warp + gid (+ 8) and rows 8 n + 2 tig (+ 1) of the CTA's input
  // steps: tanh(u) from stage 1 to 2; dva's partial; dl's partial (d, the filters 8 n +
  // 2 tig (+ 1)); dba of stage 3's (row, d)
  float th[JPC][4][4];
  float dva_p[4][4] = {}, dl_p[4][4] = {};
  float dba_r = 0.f;
  const size_t BU = (size_t)B * U;
  unsigned target = 0;
  unsigned long long times[2 * STAGES + 1] = {};
#ifdef T2_PROFILE
  times[2 * STAGES] = globaltimer();
#endif

  for (int t = a.T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    const float* st = a.state + tb * T_in;  // the state the step read

    // --- 1. dalign = values . dctx_total: warp gw of the grid the row gw / WPR, its
    // input steps gw % WPR, + WPR, ..; each lane 16 of the E columns ---
    {
      const int WPR = G * NW / B, gw = cta * NW + warp, b = gw / WPR, jw = gw % WPR;
      if (b < B && jw < T_in) {
        float dct[16];
        const bf16* dp = a.dproj + (tb + b) * (U + E) + U;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 4 * lane + 128 * i;
          const float4 x = __ldcg(reinterpret_cast<const float4*>(a.dctx + (size_t)b * E + col));
          const uint2 p = __ldg(reinterpret_cast<const uint2*>(dp + col));
          const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.x));
          const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.y));
          dct[4 * i] = rd(p0.x + x.x);
          dct[4 * i + 1] = rd(p0.y + x.y);
          dct[4 * i + 2] = rd(p1.x + x.z);
          dct[4 * i + 3] = rd(p1.y + x.w);
          if (jw == 0)
            *reinterpret_cast<uint2*>(a.dctx_total + (tb + b) * E + col) =
                make_uint2(pack2(dct[4 * i], dct[4 * i + 1]), pack2(dct[4 * i + 2], dct[4 * i + 3]));
        }
        for (int j0 = jw; j0 < T_in; j0 += 2 * WPR) {  // two input steps' loads in flight
          const int j1 = j0 + WPR < T_in ? j0 + WPR : j0;
          float4 x[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[h][i] = __ldg(reinterpret_cast<const float4*>(
                  a.values + ((size_t)b * T_in + (h ? j1 : j0)) * E + 4 * lane + 128 * i));
          float s[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[h] += x[h][i].x * dct[4 * i];
              s[h] += x[h][i].y * dct[4 * i + 1];
              s[h] += x[h][i].z * dct[4 * i + 2];
              s[h] += x[h][i].w * dct[4 * i + 3];
            }
            for (int o = 16; o > 0; o >>= 1) s[h] += __shfl_xor_sync(FULL, s[h], o);
          }
          if (lane == 0) {
            a.dalign[(size_t)b * T_in + j0] = s[0];
            a.dalign[(size_t)b * T_in + j1] = s[1];
          }
        }
      }
    }
    // ... then the energies of input steps cta, cta + G: pl^T (D, B) of the step on the
    // tensor cores, A its D rows of loc_nt, B the state's rows; warp w the d 16w .. ---
    {
      uint4* SB = reinterpret_cast<uint4*>(scr + SB_OFF);
      float* KQ = reinterpret_cast<float*>(scr + KQ_OFF);
      float* EP = reinterpret_cast<float*>(scr + EP_OFF);
      if (cta < T_in) {
        // the state's rows as the B fragments of the k-pairs (KPI, 4 n-tiles, 32 lanes),
        // rounded to bf16, once for the CTA's input steps and warps
        for (int i = tid; i < KPI * 4 * 32; i += NT) {
          const int n = i / 32 % 4, l = i % 32, r = 8 * n + l / 4;
          const int c = 32 * (i / 128) + 8 * (l % 4);
          float s[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s[e] = (r < B && c + e < T_in) ? __ldg(st + (size_t)r * T_in + c + e) : 0.f;
          SB[i] = make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]), pack2(s[4], s[5]),
                             pack2(s[6], s[7]));
        }
        __syncthreads();
      }
#pragma unroll
      for (int jj = 0; jj < JPC; ++jj) {
        const int j = cta + jj * G;
        if (j >= T_in) break;
        for (int i = tid; i < B * D / 8; i += NT) {  // 8 columns a thread
          const int r = i / (D / 8), c = 8 * (i % (D / 8));
          const uint4 kv = ld16<false>(a.keys + ((size_t)r * T_in + j) * D + c);
          const uint4 qv = ld16<false>(a.pq + (tb + r) * D + c);
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
        // over the d of the warp's lanes, then over the warps in order; tanh(u) kept
        float s[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * n + 2 * tig + e;
            float v = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float tu = 0.f;
              if (n < NTB && r < B) {
                const int dd = 16 * warp + gid + 8 * h;
                const float pl = rd(acc[n][2 * h + e]) + a.pl_b[dd];
                const float u = (KQ[r * D + dd] + pl) + a.b_a[dd];
                tu = tanhf(u);
                v += a.v_a[dd] * tu;
              }
              th[jj][n][2 * h + e] = tu;
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
    }
    grid_sync(a.bar, target, times, 0);

    // --- 2. the normalisation's backward and the location path of the CTA's input steps
    if (cta < T_in) {
      float* DE = reinterpret_cast<float*>(scr);  // (JPC, MAX_B) the energies' gradient
      bf16* DUB = reinterpret_cast<bf16*>(scr + DUB_OFF);  // (MAX_B, DS) du rounded
      bf16* FS = reinterpret_cast<bf16*>(scr + FS_OFF);    // (F, FLD) the features
      // each row's statistics in one pass: warp w the rows RPW w .., 32 / RPW lanes a row
      // (RPW = 1, 2 or 4 as B needs), lane l of them the input steps l, l + 32 / RPW, ..:
      // the softmax's running max m, its sum S of
      // exp(e - m) and Q of dal exp(e - m), rescaled as m grows (the smoothing's sigmoids
      // as they are), then the row's lanes' combined; dal = (dalign + ga) + dstate. Then the
      // energies' gradient of the CTA's input steps, de = (dal - Q / S) exp(e - m) / S (the
      // smoothing's (dal - Q / S) / S sig (1 - sig)), zero off the mask and past B
      {
        const int RPW = B > 16 ? 4 : B > 8 ? 2 : 1, LPR = 32 / RPW;
        const int r = RPW * warp + lane / LPR, l8 = lane % LPR;
        const size_t row = (size_t)r * T_in, grow = tb * T_in + row, srow = (size_t)r * TP;
        float m = -INFINITY, S = 0.f, Q = 0.f;
        if (r < B) {
          for (int j0 = l8; j0 < T_in; j0 += 4 * LPR) {
            float ev[4], dv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = j0 + LPR * i;
              ev[i] = dv[i] = 0.f;
              if (j < T_in) {
                ev[i] = __ldcg(a.eb + row + j);
                dv[i] = (__ldcg(a.dalign + row + j) + __ldg(a.ga + grow + j))
                        + __ldcg(a.dstate + srow + j);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (j0 + LPR * i >= T_in) break;
              float x;
              if (a.smoothing) {
                x = 1.0f / (1.0f + expf(-ev[i]));
              } else {
                if (ev[i] > m) {
                  const float c = expf(m - ev[i]);
                  S *= c;
                  Q *= c;
                  m = ev[i];
                }
                x = expf(ev[i] - m);
              }
              S += x;
              Q += dv[i] * x;
            }
          }
        }
        for (int o = 1; o < LPR; o <<= 1) {
          const float m2 = __shfl_xor_sync(FULL, m, o), S2 = __shfl_xor_sync(FULL, S, o);
          const float Q2 = __shfl_xor_sync(FULL, Q, o);
          if (a.smoothing) {
            S += S2;
            Q += Q2;
          } else {
            const float M = fmaxf(m, m2);
            const float c1 = M == -INFINITY ? 0.f : expf(m - M);
            const float c2 = M == -INFINITY ? 0.f : expf(m2 - M);
            S = S * c1 + S2 * c2;
            Q = Q * c1 + Q2 * c2;
            m = M;
          }
        }
        if (l8 < JPC) {
          const int j = cta + l8 * G;
          float g = 0.f;
          if (r < B && j < T_in && !(a.mask && !(a.mask[row + j] > 0.0f))) {
            const float e = __ldcg(a.eb + row + j), s = Q / S;
            const float dal = (__ldcg(a.dalign + row + j) + __ldg(a.ga + grow + j))
                              + __ldcg(a.dstate + srow + j);
            if (a.smoothing) {
              const float sg = 1.0f / (1.0f + expf(-e));
              g = (dal - s) / S * sg * (1.0f - sg);
            } else {
              g = (dal - s) * (expf(e - m) / S);
            }
          }
          DE[l8 * MAX_B + r] = g;
        }
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < JPC; ++jj) {
        const int j = cta + jj * G;
        if (j >= T_in) break;
        // du = (de v_a)(1 - tanh^2 u) of this thread's d and rows: dkeys (its sums so far
        // loaded first, before any store) and the partials
        float du[4][4], sum[4][4];
        const float va[2] = {a.v_a[16 * warp + gid], a.v_a[16 * warp + gid + 8]};
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = 8 * n + 2 * tig + (c & 1), dd = 16 * warp + gid + 8 * (c >> 1);
            sum[n][c] = n < NTB && r < B ? a.dkeys[((size_t)r * T_in + j) * D + dd] : 0.f;
          }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = 8 * n + 2 * tig + (c & 1), dd = 16 * warp + gid + 8 * (c >> 1);
            float g = 0.f;
            if (n < NTB && r < B) {
              const float de = DE[jj * MAX_B + r], tu = th[jj][n][c];
              g = (de * va[c >> 1]) * (1.0f - tu * tu);
              const size_t o = ((size_t)r * T_in + j) * D + dd;
              a.dkeys[o] = sum[n][c] + g;
              a.dus[o] = g;
              dva_p[n][c] += de * tu;
            }
            du[n][c] = g;
            DUB[r * DS + dd] = __float2bfloat16_rn(g);
          }
        // the location features f[b][c] = bf16(bf16(sum_k bf16(state)[b][j + k - pad]
        // loc_w[c][k]) + loc_b[c]), zero past B, from the taps of the rounded state's
        // window and loc_w staged in shared memory
        float* SW = reinterpret_cast<float*>(scr + SW_OFF);  // (MAX_B, KLD)
        float* LW = reinterpret_cast<float*>(scr + LW_OFF);  // (F, KLD)
        for (int i = tid; i < B * K; i += NT) {
          const int b = i / K, k = i % K, src = j + k - pad;
          SW[b * KLD + k] = (src >= 0 && src < T_in) ? rd(__ldg(st + (size_t)b * T_in + src)) : 0.f;
        }
        for (int i = tid; i < F * K; i += NT) LW[i / K * KLD + i % K] = ldf(a.loc_w + i);
        __syncthreads();
        for (int i = tid; i < F * MAX_B; i += NT) {
          const int c = i / MAX_B, b = i % MAX_B;
          float v = 0.f;
          if (b < B) {
            float s = 0.f;
#pragma unroll 8
            for (int k = 0; k < K; ++k) s += SW[b * KLD + k] * LW[c * KLD + k];
            v = rd(rd(s) + ldf(a.loc_b + c));
          }
          FS[c * FLD + b] = __float2bfloat16_rn(v);
        }
        __syncthreads();
        // dl += du^T f: warp w the d 16w .., the 4 filter tiles, k = the rows (A: du)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          if (kt >= MT) break;
          const uint32_t af[4] = {pack2(du[2 * kt][0], du[2 * kt][1]), pack2(du[2 * kt][2], du[2 * kt][3]),
                                  pack2(du[2 * kt + 1][0], du[2 * kt + 1][1]),
                                  pack2(du[2 * kt + 1][2], du[2 * kt + 1][3])};
#pragma unroll
          for (int nt = 0; nt < F / 8; ++nt) {
            const bf16* fr = FS + (8 * nt + gid) * FLD + 16 * kt + 2 * tig;
            mma(dl_p[nt], af, make_uint2(ld32(fr), ld32(fr + 8)));
          }
        }
        // df = bf16(du @ l_w): warp w the rows 16 (w / 4) .., the filters 8 (w % 4) ..
        if (warp / 4 < MT) {
          const int m0 = 16 * (warp / 4);
          float acc[4] = {};
#pragma unroll
          for (int kt = 0; kt < D / 16; ++kt) {
            const bf16* x0 = DUB + (m0 + gid) * DS + 16 * kt + 2 * tig;
            const uint32_t af[4] = {ld32(x0), ld32(x0 + 8 * DS), ld32(x0 + 8), ld32(x0 + 8 * DS + 8)};
            mma(acc, af, make_uint2(lwf[kt][0], lwf[kt][1]));
          }
          const int r = m0 + gid, c = 8 * (warp % 4) + 2 * tig;
          if (r < B)
            *reinterpret_cast<uint32_t*>(a.df + ((tb + r) * T_in + j) * F + c) = pack2(acc[0], acc[1]);
          if (r + 8 < B)
            *reinterpret_cast<uint32_t*>(a.df + ((tb + r + 8) * T_in + j) * F + c) =
                pack2(acc[2], acc[3]);
        }
        // this input step's part of the state's gradient, dsp[j][b][k] = sum_d bf16(du)[b][d]
        // loc_n[k][j D + d]: warp w the n-tiles (k) w, w + NW, ..
        for (int nt = warp; nt < TP / 8; nt += NW) {
          const int k = 8 * nt + gid;
          uint32_t bw[D / 16][2];
#pragma unroll
          for (int kt = 0; kt < D / 16; ++kt) {
            const bf16* ln = a.loc_n + (size_t)k * T_in * D + (size_t)j * D + 16 * kt + 2 * tig;
            bw[kt][0] = k < T_in ? ld32(ln) : 0u;
            bw[kt][1] = k < T_in ? ld32(ln + 8) : 0u;
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (m >= MT) break;
            float acc[4] = {};
#pragma unroll
            for (int kt = 0; kt < D / 16; ++kt) {
              const bf16* x0 = DUB + (16 * m + gid) * DS + 16 * kt + 2 * tig;
              const uint32_t af[4] = {ld32(x0), ld32(x0 + 8 * DS), ld32(x0 + 8), ld32(x0 + 8 * DS + 8)};
              mma(acc, af, make_uint2(bw[kt][0], bw[kt][1]));
            }
            const int r = 16 * m + gid, kk = 8 * nt + 2 * tig;
            if (r < B)
              *reinterpret_cast<float2*>(a.dsp + ((size_t)j * B + r) * TP + kk) =
                  make_float2(acc[0], acc[1]);
            if (r + 8 < B)
              *reinterpret_cast<float2*>(a.dsp + ((size_t)j * B + r + 8) * TP + kk) =
                  make_float2(acc[2], acc[3]);
          }
        }
        __syncthreads();  // DUB and FS, again for the next input step
      }
    }
    grid_sync(a.bar, target, times, 1);

    // --- 3. the sums over the input steps, warp w the input steps w, w + NW, .., added
    // in warp order: dpq (CTA c < 4B the row c / 4, d = 32 (c % 4) + lane), then the
    // state's gradient (the row and 32 input steps k a pair, over the grid) ---
    {
      float* PS = reinterpret_cast<float*>(scr);  // (NW, 32)
      if (cta < 4 * B) {
        const int b = cta / 4, d = 32 * (cta % 4) + lane;
        float s = 0.f;
        for (int j = warp; j < T_in; j += NW) s += __ldcg(a.dus + ((size_t)b * T_in + j) * D + d);
        PS[warp * 32 + lane] = s;
        __syncthreads();
        if (warp == 0) {
          float v = PS[lane];
          for (int w = 1; w < NW; ++w) v += PS[w * 32 + lane];
          const bf16 r = __float2bfloat16_rn(v);
          a.dpq[(tb + b) * D + d] = r;
          a.dpqb[(size_t)b * D + d] = r;
          dba_r += v;
        }
        __syncthreads();
      }
      for (int p = cta; p < B * KPI; p += G) {
        const int b = p / KPI, k = 32 * (p % KPI) + lane;
        float s = 0.f;
        for (int j = warp; j < T_in; j += NW) s += __ldcg(a.dsp + ((size_t)j * B + b) * TP + k);
        PS[warp * 32 + lane] = s;
        __syncthreads();
        if (warp == 0 && k < T_in) {
          float v = PS[lane];
          for (int w = 1; w < NW; ++w) v += PS[w * 32 + lane];
          const size_t i = (size_t)b * TP + k;
          a.dstate[i] = a.cumulate ? __ldcg(a.dstate + i) + v : v;
        }
        __syncthreads();
      }
    }
    grid_sync(a.bar, target, times, 2);

    // --- 4. LSTM 2's backward: dhb = bf16(dpq @ q_w) of the CTA's units (warp m the
    // m-tile m), then the cells on dproj[:U] + dhb ---
    {
      float* DHB = reinterpret_cast<float*>(scr);  // (MAX_B, 8)
      // the cell's inputs of this step, loaded before the product
      const size_t i = (tb + crow) * U + cu, zr = (tb + crow) * 4 * U + cu;
      float z[4] = {}, cp = 0.f, dha = 0.f;
      int kc = -1, kh = -1;
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = ldf(a.z2 + zr + q * U);
        cp = t ? ldf(a.c2p + i - BU) : 0.f;
        dha = ldf(a.dproj + (tb + crow) * (U + E) + cu);
        kc = keep_of(a.keep[2], i);
        kh = keep_of(a.keep[3], i);
      }
      if (warp < MT) {
        float acc[4] = {};
#pragma unroll
        for (int kp = 0; kp < D / 32; ++kp) {
          uint32_t af[2][4];
          apair<true>(af, a.dpqb, D, B, warp, 32 * kp, lane);
          mma_pair(acc, af, QWF[kp * 32 + lane]);
        }
        const int r = 16 * warp + gid, c = 2 * tig;
        DHB[r * 8 + c] = rd(acc[0]);
        DHB[r * 8 + c + 1] = rd(acc[1]);
        DHB[(r + 8) * 8 + c] = rd(acc[2]);
        DHB[(r + 8) * 8 + c + 1] = rd(acc[3]);
      }
      __syncthreads();
      if (cell) {
        float dz[4];
        const float ds = rd(dha + DHB[crow * 8 + ci]);
        lstm_cell_bwd(z, cp, ds, dh2, dc2, kc, kh, a.a[2], a.a[3], dz, byp2);
#pragma unroll
        for (int q = 0; q < 4; ++q) a.dz2[zr + q * U] = __float2bfloat16_rn(dz[q]);
      }
    }
    grid_sync(a.bar, target, times, 3);

    // --- 5. din2's columns of the CTA (its units' dx1, then their dh2) over every CTA's
    // dz2, then LSTM 1's backward on dx1 ---
    {
      float* RED = reinterpret_cast<float*>(scr);
      // the cell's inputs of this step, loaded before the product
      const size_t i = (tb + crow) * U + cu, zr = (tb + crow) * 4 * U + cu;
      float z[4] = {}, cp = 0.f;
      int kc = -1, kh = -1;
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = ldf(a.z1 + zr + q * U);
        cp = t ? ldf(a.c1p + i - BU) : 0.f;
        kc = keep_of(a.keep[0], i);
        kh = keep_of(a.keep[1], i);
      }
      float d[2][2][4] = {};
      auto resident = [&](int kp, int q) { return W2[(kp * 2 + q) * 32 + lane]; };
      segment<true, false, RES_BATCH, 2>(d, a.dz2 + tb * KZ, KZ, B, MT, 0, KPZ, warp, lane,
                                         resident);
      put_partials<2>(RED, d, MT, warp, lane);
      __syncthreads();
      if (cell) {
        dh2 = column(RED, crow, 8 + ci) + byp2;
        float dz[4];
        lstm_cell_bwd(z, cp, column(RED, crow, ci), dh1, dc1, kc, kh, a.a[0], a.a[1], dz, byp1);
#pragma unroll
        for (int q = 0; q < 4; ++q) a.dz1[zr + q * U] = __float2bfloat16_rn(dz[q]);
      }
    }
    grid_sync(a.bar, target, times, 4);

    // --- 6. din1's columns of the CTA: its units' dh1 (g1 resident), its 4 context
    // columns (g1 streamed; lanes g >= 4 read column g % 4 again) ---
    {
      float* RED = reinterpret_cast<float*>(scr);
      float d[2][2][4] = {};
      const uint4* g1c = a.g1c + (size_t)cta * KPZ * 16;
      auto wf = [&](int kp, int q) {
        return q == 0 ? W1H[kp * 32 + lane] : __ldcg(g1c + kp * 16 + (gid % EPC) * 4 + tig);
      };
      segment<true, true, RES_BATCH, 2>(d, a.dz1 + tb * KZ, KZ, B, MT, 0, KPZ, warp, lane, wf);
      put_partials<2>(RED, d, MT, warp, lane);
      __syncthreads();
      if (cell) {
        dh1 = column(RED, crow, ci) + byp1;
        if (ci < EPC) a.dctx[(size_t)crow * E + EPC * cta + ci] = column(RED, crow, 8 + ci);
      }
    }
    grid_sync(a.bar, target, times, 5);
  }

  // --- after the last step: the CTAs' partials of dva and dl, summed in CTA order; dba
  // by the threads that held it ---
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 8 * n + 2 * tig + (c & 1), dd = 16 * warp + gid + 8 * (c >> 1);
      if (r < B) a.dvap[((size_t)cta * B + r) * D + dd] = dva_p[n][c];
      a.dlp[((size_t)cta * D + dd) * F + 8 * n + 2 * tig + (c & 1)] = dl_p[n][c];
    }
  if (warp == 0 && cta < 4 * B) a.dba[(size_t)(cta / 4) * D + 32 * (cta % 4) + lane] = dba_r;
  grid_sync(a.bar, target, times, -1);
  for (int i = cta * NT + tid; i < B * D + D * F; i += G * NT) {
    float s = 0.f;
    if (i < B * D) {
      for (int c = 0; c < G; ++c) s += __ldcg(a.dvap + (size_t)c * B * D + i);
      a.dva[i] = s;
    } else {
      const int o = i - B * D;
      for (int c = 0; c < G; ++c) s += __ldcg(a.dlp + (size_t)c * D * F + o);
      a.dl[o] = s;
    }
  }
#ifdef T2_PROFILE
  if (tid == 0 && a.prof)
    for (int i = 0; i < 2 * STAGES; ++i) a.prof[(size_t)cta * 2 * STAGES + i] = times[i];
#endif
}

}  // namespace

extern "C" int t2_decoder_bwd_loop(void* const* p, const int* n, const float* keep, int* info,
                                   void* stream) {
  Args a;
  a.keys = (const bf16*)p[P_KEYS];
  a.values = (const float*)p[P_VALUES];
  a.mask = (const float*)p[P_MASK];
  a.dproj = (const bf16*)p[P_DPROJ];
  a.ga = (const float*)p[P_GA];
  a.z1 = (const bf16*)p[P_Z1];
  a.z2 = (const bf16*)p[P_Z2];
  a.c1p = (const bf16*)p[P_C1P];
  a.c2p = (const bf16*)p[P_C2P];
  a.state = (const float*)p[P_STATE];
  a.pq = (const bf16*)p[P_PQ];
  a.g1 = (const bf16*)p[P_G1_W];
  a.g2 = (const bf16*)p[P_G2_W];
  a.q_w = (const bf16*)p[P_Q_W];
  a.loc_nt = (const bf16*)p[P_LOC_NT];
  a.loc_n = (const bf16*)p[P_LOC_N];
  a.pl_b = (const float*)p[P_PL_B];
  a.v_a = (const float*)p[P_V_A];
  a.b_a = (const float*)p[P_B_A];
  a.loc_w = (const bf16*)p[P_LOC_W];
  a.loc_b = (const bf16*)p[P_LOC_B];
  a.l_w = (const bf16*)p[P_L_W];
  for (int g = 0; g < 4; ++g) {
    a.keep[g] = (const uint8_t*)p[P_KEEP_C1 + g];
    a.a[g] = keep[g];
  }
  a.dz1 = (bf16*)p[P_DZ1];
  a.dz2 = (bf16*)p[P_DZ2];
  a.dpq = (bf16*)p[P_DPQ];
  a.dctx_total = (bf16*)p[P_DCTX_TOTAL];
  a.df = (bf16*)p[P_DF];
  a.dkeys = (float*)p[P_DKEYS];
  a.dva = (float*)p[P_DVA];
  a.dba = (float*)p[P_DBA];
  a.dl = (float*)p[P_DL];
  a.dctx = (float*)p[P_DCTX];
  a.dstate = (float*)p[P_DSTATE];
  a.dalign = (float*)p[P_DALIGN];
  a.eb = (float*)p[P_EB];
  a.dus = (float*)p[P_DUS];
  a.dsp = (float*)p[P_DSP];
  a.dpqb = (bf16*)p[P_DPQB];
  a.g1c = (uint4*)p[P_G1C];
  a.dvap = (float*)p[P_DVAP];
  a.dlp = (float*)p[P_DLP];
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
  cudaError_t err = cudaFuncSetAttribute(
      decoder_bwd_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_bwd_loop_kernel, NT, SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < G) {  // the grid barrier needs every CTA resident
    info[0] = per_sm * sms;
    info[1] = G;
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)decoder_bwd_loop_kernel, dim3(G), dim3(NT), args,
                                    SMEM, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
