// The teacher-forced Tacotron decoder's reverse recurrence on Hopper in float32: all T steps
// of the fused decoder's backward loop in one persistent launch, the location conv and its
// transpose inside it (tacotron2_tpu_torch/ops/decoder_vjp.py, `decoder_bwd_loop` at float32,
// where `loop_applies` holds: float32, the conv location tier, every step on its
// teacher frame, the widths below, B <= 32, T_in <= 256).
//
// It replaces, where it runs, the step loop of the port's attention_bwd and two
// lstm_cell_bwd (csrc/decoder/decoder_step.cu) at float32 with the library products and
// the location conv's transpose between them, and so the XLA fusions of the JAX package's
// fused decoder that those kernels stand for (tacotron2_tpu/ops/fused_decoder.py:
// `_bwd_rule`'s `step_bwd` and its reverse scan, :494-571, with `_att_bwd` and its conv
// tier, :257-338 (the conv transpose and the kernel gradient at :315-337), and `_lstm_bwd`
// with the (1 - a) bypasses, :130-150). Training at compute_dtype=float32 runs it. Its
// arithmetic is the port's `_reverse_step` (its plain version `_decoder_bwd_loop_plain`),
// which keeps the state's gradient that the JAX rule drops without cumulative weights. No
// step reads its own frame, so the frame and stop projections' gradient dproj runs before
// the launch, once over the T * B rows, and the prenet's after it, with the deferred weight
// gradients, the location conv's kernel and bias gradients, dvalues and dteacher.
//
// One reverse step t, at float32: dctx_total = dproj[U:] + dctx, dalign = values .
// dctx_total; the energies recomputed from the state the step read: f = the SAME conv of
// the state with the K taps of each filter, plus loc_b ((K - 1) / 2 taps before the
// position, even K too), pl = f @ l_w^T, u = ((keys + pq) + pl) + b_a, e = sum_D v_a tanh u,
// NEG_INF where the mask is not > 0; dal = (dalign + ga) + dstate, the softmax's (or the
// smoothing's) backward de, zero off the mask, du = (de v_a)(1 - tanh^2 u); dkeys += du,
// dva += sum_j de tanh u, dpq = sum_j du (dba += it), dl += du^T f, df = du @ l_w; the
// state's gradient the conv's transpose of df (the correlation with the flipped kernel,
// padded as the forward's SAME padding mirrored), added to the carried one where the
// alignments cumulate, else in its place; LSTM 2's backward on dproj[:U] + dpq @ q_w with
// the carried dh2, dc2 and the step's keep-gates or zoneout's expectation; din2 = dz2 @ g2;
// LSTM 1's backward on din2[:U]; din1 = dz1 @ g1 past the prenet's columns: the carried
// dctx and dh1. Built with --fmad=false: the elementwise math rounds op by op, as the plain
// version's separate operations do; the dot products fuse where they say so.
//
// What bounds it on an H100. A step's products are 2 B (4U 2U + 4U (E + U) + D U) on the
// tensor cores and 2 B T_in (E + 2 K F + 3 F D) on the CUDA cores: at B=32 and T_in=100 about
// 1.0 GFLOP (the two gate-gradient products 0.94 of it), 15 us at the f32 CUDA cores' 67
// TFLOP/s or 6.2 us as 3xTF32 at the tensor cores' 495 TFLOP/s (three products a term).
// The weights it reads a step are 56 MB in f32 (g2's 16 columns and g1's 12 of each CTA:
// 448 KB), and the card's shared memory holds about 29 MB: the 27 MB or more that cannot
// stay on chip take 8 us a step at 3.35 TB/s, whatever the batch. What a step pays beyond
// that is latency and the L2: a chain of six dependent stages, a grid barrier after each,
// every CTA reading all rows of dz2 and dz1.
//
// Design: the bf16 reverse loop's (csrc/decoder_bwd_loop/decoder_bwd_loop.cu) with the
// float32 forward loop's arithmetic (csrc/decoder_loop_f32/decoder_loop_f32.cu). One cooperative launch of G = U / 8 = 128
// CTAs of 256 threads, all resident (the entry checks the occupancy: its grid barrier, an
// arrival counter that the caller zeroes, needs every CTA). CTA c owns units 8c .. 8c+7 of
// both LSTMs: the gradients dh and dc of both cells sit in registers for the whole launch,
// a thread a (row, unit); dctx and the state's gradient in scratch. The gate products run
// on the tensor cores as 3xTF32 (mma.sync.m16n8k8.tf32, each operand split into hi =
// tf32(x) and lo = tf32(x - hi), the terms lo hi, hi lo and hi hi), each k-quad's six
// products summed from zero and added to the warp's sums on the CUDA cores (the tensor
// cores' sum truncates: one chain through the accumulator read 4e-6 of the plain version
// in the float32 forward loop), the rows padded to 16 or 32 with zeros; a build for each number of m-tiles. The
// weights: g2's 8 h2 columns of the CTA (128 KB) sit in shared memory in fragment order
// for the whole launch, packed at its start; g2's 8 x1 columns, g1's 8 h1 columns and its
// 4 context columns (320 KB a CTA, 41 MB a step) stream from fragment-ordered copies in
// global memory that each CTA writes at the start: the warps load them from L2 into
// registers, NB k-quads ahead with the rows. Staging them instead in a ring in shared
// memory with cp.async, issued before the grid barriers, read no faster (104.3 against
// 93.4-93.8 us a step at B=32, 52.7 against 52.7-52.8 at B=1, H100 80GB HBM3, 700 W):
// the rows' loads, NB k-quads ahead, set the pace. The
// attention's sums run on the CUDA cores in float32. Six stages a step, a grid barrier
// after each:
//  1. dalign: the warps of the grid spread over the (row, input step) pairs, each warp
//     forming its row's dctx_total; then the energies of the CTA's input steps c, c + 128:
//     the state's K taps of each row staged in shared memory, f (B, F) from them and loc_w
//     (transposed in shared memory for the launch; f kept for stage 2), pl and u of a
//     thread's d and 16 rows from f and l_w (transposed), tanh u kept in registers, each
//     row's sum over D of v_a tanh u, its warps' sums in order.
//  2. Every CTA with an input step recomputes each row's softmax statistics and sum of dal
//     align in one pass (a running max and sums rescaled as it grows), then for its input
//     steps: du (dkeys summed in place, an element a thread; dva and dl partials of the
//     thread in registers), du to scratch for dpq and to shared memory, and df = du @ l_w
//     (the output, which stage 3 reads).
//  3. The sums: dpq (and dba, its sums, held by one thread a (row, d) for the launch) by
//     D tiles over the input steps; the state's gradient by (row, 32 positions) over the
//     grid, each position's K taps of df (other CTAs wrote them before the barrier) and
//     loc_w.
//  4. LSTM 2's backward for the CTA's units, dhb = dpq @ q_w (a k-quad a warp).
//  5. din2's 16 columns of the CTA (K = 4U, every CTA's dz2), then LSTM 1's backward on
//     them with no barrier between.
//  6. din1's h1 and context columns of the CTA: the carried dh1 and dctx.
// Every accumulator sums in a fixed order: dkeys an element a thread in step order, dva and
// dl per-thread partials and dba one thread's, the CTAs' partials added in CTA order after
// the last step. No atomics but the barrier's: two launches on the same inputs are
// bit-identical.
//
// Plain C entry point (loaded with ctypes): `ptrs` holds the device pointers in the order
// of the enum below (null for an absent mask or keep-gate), `ints` T, B, T_in, the location
// conv's width K, smoothing, cumulate, `keep` zoneout's expectation keep (JAX's 1 - rate)
// of c1, h1, c2, h2; the launch goes on `stream`; returns its cudaError_t (0: launched)
// and, where the card keeps too few CTAs resident, writes those it keeps and those needed
// into info[0..1].

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
constexpr int EPC = E / G;      // context columns a CTA: 4
constexpr int K1 = P + E + U, K2 = 2 * U, KZ = 4 * U;  // g1's and g2's inputs, the gates
// k-quads: 16 columns, two k-tiles of 8, which a lane reads 4 columns at a time
constexpr int KQZ = KZ / 16;    // of the gates' gradients: 256
constexpr int KQW = KQZ / NW;   // ... a warp: 32
constexpr int KQD = D / 16;     // of dpq: 8, a k-quad a warp
static_assert(KQD == NW, "dhb takes a k-quad a warp");
constexpr int MAX_B = 32;       // two m-tiles
constexpr int MAX_T_IN = 256;   // two input steps a CTA
constexpr int JPC = (MAX_T_IN + G - 1) / G;
constexpr int MAX_K = 64;       // the location conv's taps, staged a row
constexpr int RPT = MAX_B / 2;  // rows a thread in the attention's stages (a d, every 2nd row)
// l_w^T's row in shared memory: lanes of consecutive d, or of consecutive filters reading
// 16 bytes each, hit no bank twice in a phase
constexpr int LWD = D + 4;
constexpr int WIN_ROWS = 32 + MAX_K - 1;  // stage 3's window of df rows for 32 positions
// k-quads in flight a warp: NB of the rows' and the streamed weights' loads before their
// products
constexpr int NB = 2;
static_assert(KQW % NB == 0, "the k-quads of a warp");
constexpr size_t WR_BYTES = (size_t)KQZ * 32 * 16;           // g2's h2 columns: 128 KB
constexpr size_t LWK_FLOATS = (size_t)MAX_K * F;             // loc_w^T (K, F)
constexpr size_t LWT_FLOATS = (size_t)F * LWD;               // l_w^T (F, D + 4)
constexpr size_t QWF_BYTES = (size_t)KQD * 32 * 16;          // q_w's columns: 4 KB
constexpr size_t FT_FLOATS = (size_t)JPC * MAX_B * F;        // f of the input steps
// the stages' scratch (a barrier between two stages parts their uses): stage 1's keys + pq,
// the state's taps and the warps' energy sums; stage 2's energies' gradient and du; stage
// 3's partials and window of df; stages 4-6's warps' partials (32 rows x 16 columns)
constexpr size_t KQ_OFF = 0, WIN_OFF = KQ_OFF + MAX_B * D, EP_OFF = WIN_OFF + MAX_B * MAX_K;
constexpr size_t SCR_FLOATS = EP_OFF + 4 * MAX_B;
constexpr size_t DU_OFF = JPC * MAX_B, DFW_OFF = NW * 32;
static_assert(DU_OFF + MAX_B * D <= SCR_FLOATS && DFW_OFF + WIN_ROWS * F <= SCR_FLOATS
              && (size_t)NW * MAX_B * 16 <= SCR_FLOATS, "the stages' scratch");
constexpr size_t SMEM = WR_BYTES + QWF_BYTES
                        + (LWK_FLOATS + LWT_FLOATS + FT_FLOATS + SCR_FLOATS) * 4;
constexpr float NEG_INF = -4294967296.0f;  // -2**32 + 1 in float32 (attention.py)
constexpr unsigned FULL = 0xffffffffu;

enum Ptr {
  P_KEYS, P_VALUES, P_MASK, P_DPROJ, P_GA, P_Z1, P_Z2, P_C1P, P_C2P, P_STATE, P_PQ,
  P_G1_W, P_G2_W, P_Q_W, P_LOC_W, P_LOC_B, P_L_W, P_V_A, P_B_A,
  P_KEEP_C1, P_KEEP_H1, P_KEEP_C2, P_KEEP_H2,
  P_DZ1, P_DZ2, P_DPQ, P_DCTX_TOTAL, P_DF, P_DKEYS, P_DVA, P_DBA, P_DL,
  P_DCTX, P_DSTATE, P_DALIGN, P_EB, P_DUS, P_G2X, P_G1H, P_G1C, P_DVAP, P_DLP, P_BAR,
  P_PROF, N_PTRS
};

struct Args {
  // inputs, f32: keys (B, T_in, D), values (B, T_in, E), mask (B, T_in) or null, dproj (T,
  // B, U + E), ga (T, B, T_in) the alignments' gradient; the forward's residuals z1, z2 (T,
  // B, 4U), c1p, c2p (T, B, U), state (T, B, T_in), pq (T, B, D); g1 (4U, K1), g2 (4U, K2),
  // q_w (D, U), loc_w (F, 1, K), loc_b (F), l_w (D, F), v_a, b_a (D); the keep-gates (T, B,
  // U) bool of c1, h1, c2, h2 or null
  const float *keys, *values, *mask, *dproj, *ga, *z1, *z2, *c1p, *c2p, *state, *pq;
  const float *g1, *g2, *q_w, *loc_w, *loc_b, *l_w, *v_a, *b_a;
  const uint8_t* keep[4];
  float a[4];
  // outputs, f32: dz1, dz2 (T, B, 4U), dpq (T, B, D), dctx_total (T, B, E), df (T, B T_in,
  // F); dkeys (B, T_in, D) zeroed, dva, dba (B, D), dl (D, F)
  float *dz1, *dz2, *dpq, *dctx_total, *df, *dkeys, *dva, *dba, *dl;
  // scratch: dctx (B, E) and dstate (B, T_in) zeroed, the carried gradients; dalign, eb (B,
  // T_in); dus (B, T_in, D) the step's du; g2x, g1h (G, KQZ, 32) and g1c (G, KQZ, 16) uint4,
  // the CTAs' streamed columns as B fragments (g2's x1, g1's h1 and context columns); dvap
  // (G, B, D), dlp (G, 2, D, F) the CTAs' partials; bar (one u32, zero)
  float *dctx, *dstate, *dalign, *eb, *dus, *dvap, *dlp;
  uint4 *g2x, *g1h, *g1c;
  unsigned* bar;
  // a build with -DT2_PROFILE: (G, 2, STAGES) u64, each CTA's %globaltimer ns of each
  // stage's work (from the barrier before it to its arrival at its own) and of its wait
  unsigned long long* prof;
  int T, B, T_in, K, smoothing, cumulate;
};

// dalign and the energies, the normalisation's backward and the location path, the sums
// and the conv's transpose, LSTM 2, din2 and LSTM 1, din1
constexpr int STAGES = 6;

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

// The k-quad order, the float32 forward loop's. mma.m16n8k8 sums 8 products whatever their order, so the columns
// of a k-quad (16 of them) are dealt to the k slots as 16-byte loads give them: lane (g, t)
// of a warp reads columns 4t .. 4t+3 of its rows; 4t and 4t+1 are its slots t and t+4 of
// the quad's first k-tile, 4t+2 and 4t+3 those of the second. The A operand (the rows) and
// the B operand (a weight's columns, packed in that order) take the same order, so each
// product sums the same terms.

// The rows r0 = 16 mt + g and r0 + 8 of x (rows of ld floats, written in this launch) at the
// lane's columns of the k-quad at c0: rows past B read as zeros.
__device__ __forceinline__ void aquad(uint4 v[2], const float* x, int ld, int B, int mt, int c0,
                                      int lane) {
  const int r0 = 16 * mt + lane / 4, r1 = r0 + 8, c = c0 + 4 * (lane % 4);
  v[0] = v[1] = make_uint4(0u, 0u, 0u, 0u);
  if (r0 < B) v[0] = __ldcg(reinterpret_cast<const uint4*>(x + (size_t)r0 * ld + c));
  if (r1 < B) v[1] = __ldcg(reinterpret_cast<const uint4*>(x + (size_t)r1 * ld + c));
}

// d += the k-quad's two products of the rows (hi ah, lo al) and the B fragments (bh, bl),
// each as 3xTF32: lo hi + hi lo + hi hi
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

// d[m][q] += the k-quad's products of the rows av (MT m-tiles) and the B fragments b[q] of 2
// column tiles: each k-quad's six products summed from zero on the tensor cores, then added
// to d on the CUDA cores
template <int MT>
__device__ __forceinline__ void add_quads(float d[2][2][4], const uint4 av[MT][2], const uint4 b[2]) {
  uint32_t bh[2][4], bl[2][4];
  split_b(bh[0], bl[0], b[0]);
  split_b(bh[1], bl[1], b[1]);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t ah[2][4], al[2][4];
    split_a(ah, al, av[m]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      mma_quad(s, ah, al, bh[q], bl[q]);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[m][q][i] += s[i];
    }
  }
}

// The B fragment (uint4) of lane `lane` of the k-quad kq of w's columns col0 + g (w (KZ, ld)
// row-major: the gate gradients' rows; g < ng columns, lanes past them read column g % ng)
__device__ __forceinline__ uint4 wfrag(const float* w, int ld, int col0, int ng, int kq, int lane) {
  const float* p = w + (size_t)(16 * kq + 4 * (lane % 4)) * ld + col0 + (lane / 4) % ng;
  return make_uint4(__float_as_uint(__ldg(p)), __float_as_uint(__ldg(p + ld)),
                    __float_as_uint(__ldg(p + 2 * ld)), __float_as_uint(__ldg(p + 3 * ld)));
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

// The warp's partial sums d of its m-tiles' 2 column tiles into red[warp][row][16].
template <int MT>
__device__ __forceinline__ void put_partials(float* red, const float d[2][2][4], int warp,
                                             int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = 16 * m + lane / 4, col = 2 * (lane % 4);
    float* r = red + ((size_t)warp * MAX_B + row) * 16;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      r[8 * q + col] = d[m][q][0];
      r[8 * q + col + 1] = d[m][q][1];
      r[8 * 16 + 8 * q + col] = d[m][q][2];
      r[8 * 16 + 8 * q + col + 1] = d[m][q][3];
    }
  }
}

// The product's column col of row `row`: the warps' partials (16 columns) added in warp order.
__device__ __forceinline__ float column(const float* red, int row, int col) {
  float s = red[(size_t)row * 16 + col];
#pragma unroll
  for (int k = 1; k < NW; ++k) s += red[((size_t)k * MAX_B + row) * 16 + col];
  return s;
}

__device__ __forceinline__ int keep_of(const uint8_t* keep, size_t i) {
  return keep ? (int)keep[i] : -1;
}

// The LSTM cell's backward with its zoneout bypasses (`_lstm_cell_bwd_plain` in f32): from
// the gates z and c_prev, the step output's gradient ds and the carried dh and dc of the
// zoned h and c, the keep-gates kc, kh 0 or 1 (-1: the expectation keeps a_c, a_h). Writes
// the gates' gradients dz (i, g, f, o) and the h bypass (1 - ah) dh, and turns dc into
// c_prev's gradient.
__device__ __forceinline__ void lstm_cell_bwd(const float z[4], float cp, float ds, float dh,
                                              float& dc, int kc, int kh, float a_c, float a_h,
                                              float dz[4], float& bypass) {
  const float ac = kc >= 0 ? (kc ? 1.0f : 0.0f) : a_c;
  const float ah = kh >= 0 ? (kh ? 1.0f : 0.0f) : a_h;
  const float dhn = ds + ah * dh;
  const float si = sig(z[0]), tg = tanhf(z[1]);
  const float sf = sig(z[2] + 1.0f);
  const float so = sig(z[3]);
  const float cn = sf * cp + si * tg;
  const float tc = tanhf(cn);
  const float dcn = dhn * so * (1.0f - tc * tc) + ac * dc;
  dz[3] = dhn * tc * so * (1.0f - so);
  dz[2] = dcn * cp * sf * (1.0f - sf);
  dz[0] = dcn * tg * si * (1.0f - si);
  dz[1] = dcn * si * (1.0f - tg * tg);
  dc = dcn * sf + (1.0f - ac) * dc;
  bypass = (1.0f - ah) * dh;
}

// MT: the m-tiles of the rows, each warp takes all (1 for B <= 16, 2 for B <= 32)
template <int MT>
__global__ void __launch_bounds__(NT, 1) decoder_bwd_loop_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* WR = reinterpret_cast<uint4*>(smem);                // (KQZ, 32): g2's h2 columns
  uint4* QWF = WR + (size_t)KQZ * 32;                        // (KQD, 32): q_w's columns
  float* LWK = reinterpret_cast<float*>(QWF + (size_t)KQD * 32);  // loc_w^T (K, F)
  float* LWT = LWK + LWK_FLOATS;                             // l_w^T (F, D + 4)
  float* FT = LWT + LWT_FLOATS;                              // f (JPC, MAX_B, F)
  float* SCR = FT + FT_FLOATS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cta = blockIdx.x, B = a.B, T_in = a.T_in, K = a.K;
  const int pad = (K - 1) / 2;              // the location conv's SAME padding before
  const int u0 = UPC * cta;
  // this CTA's streamed columns as B fragments
  uint4* g2x = a.g2x + (size_t)cta * KQZ * 32;
  uint4* g1h = a.g1h + (size_t)cta * KQZ * 32;
  uint4* g1c = a.g1c + (size_t)cta * KQZ * 16;

  // --- once a launch: the B fragments, g2's h2 columns resident, its x1 columns and g1's
  // h1 and context columns to global memory, q_w's columns; loc_w and l_w transposed ---
  for (int i = tid; i < KQZ * 32; i += NT) {
    const int kq = i / 32, l = i % 32;
    WR[i] = wfrag(a.g2, K2, U + u0, 8, kq, l);
    g2x[i] = wfrag(a.g2, K2, u0, 8, kq, l);
    g1h[i] = wfrag(a.g1, K1, P + E + u0, 8, kq, l);
    if (l < 16) g1c[kq * 16 + l] = wfrag(a.g1, K1, P + EPC * cta, EPC, kq, l);  // 4 columns
  }
  for (int i = tid; i < KQD * 32; i += NT) QWF[i] = wfrag(a.q_w, U, u0, 8, i / 32, i % 32);
  for (int i = tid; i < F * K; i += NT) LWK[(i % K) * F + i / K] = __ldg(a.loc_w + i);
  for (int i = tid; i < D * F; i += NT) LWT[(i % F) * LWD + i / F] = __ldg(a.l_w + i);
  __threadfence();
  __syncthreads();


  // this thread's (row, unit) of the cells, the gradients of their zoned h and c in
  // registers, and the h bypasses from one stage to the next
  const int crow = tid / UPC, ci = tid % UPC, cu = u0 + ci;
  const bool cell = crow < B;
  float dh1 = 0.f, dc1 = 0.f, dh2 = 0.f, dc2 = 0.f, byp1 = 0.f, byp2 = 0.f;
  // this thread's d and rows half + 2i of the attention's stages: tanh(u) from stage 1 to 2;
  // dva's partial (d, the rows), dl's (d, the filters); dba of stage 3's (row, d)
  const int dd = tid % D, half = tid / D;
  float th[JPC][RPT];
  float dva_p[RPT], dl_p[F];
#pragma unroll
  for (int i = 0; i < RPT; ++i) dva_p[i] = 0.f;
#pragma unroll
  for (int c = 0; c < F; ++c) dl_p[c] = 0.f;
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
        const float* dp = a.dproj + (tb + b) * (U + E) + U;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 4 * lane + 128 * i;
          const float4 x = __ldcg(reinterpret_cast<const float4*>(a.dctx + (size_t)b * E + col));
          const float4 p = __ldg(reinterpret_cast<const float4*>(dp + col));
          dct[4 * i] = p.x + x.x;
          dct[4 * i + 1] = p.y + x.y;
          dct[4 * i + 2] = p.z + x.z;
          dct[4 * i + 3] = p.w + x.w;
          if (jw == 0)
            *reinterpret_cast<float4*>(a.dctx_total + (tb + b) * E + col) =
                make_float4(dct[4 * i], dct[4 * i + 1], dct[4 * i + 2], dct[4 * i + 3]);
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
              s[h] = fmaf(x[h][i].x, dct[4 * i], s[h]);
              s[h] = fmaf(x[h][i].y, dct[4 * i + 1], s[h]);
              s[h] = fmaf(x[h][i].z, dct[4 * i + 2], s[h]);
              s[h] = fmaf(x[h][i].w, dct[4 * i + 3], s[h]);
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
    // ... then the energies of input steps cta, cta + G: the location conv of the state
    // the step read, its projection, and each row's sum of v_a tanh(u) ---
    {
      float* KQ = SCR + KQ_OFF;    // keys + pq of the input step (B, D)
      float* WIN = SCR + WIN_OFF;  // each row's K taps of the state (B, MAX_K)
      float* EP = SCR + EP_OFF;    // each row's sums of 4 warps' d (4, MAX_B)
#pragma unroll
      for (int jj = 0; jj < JPC; ++jj) {
        const int j = cta + jj * G;
        if (j >= T_in) break;
        for (int i = tid; i < B * D / 4; i += NT) {  // 4 columns a thread
          const int r = i / (D / 4), c = 4 * (i % (D / 4));
          const float4 kv = __ldg(reinterpret_cast<const float4*>(a.keys + ((size_t)r * T_in + j) * D + c));
          const float4 qv = __ldg(reinterpret_cast<const float4*>(a.pq + (tb + r) * D + c));
          *reinterpret_cast<float4*>(KQ + r * D + c) =
              make_float4(kv.x + qv.x, kv.y + qv.y, kv.z + qv.z, kv.w + qv.w);
        }
        for (int i = tid; i < B * K; i += NT) {
          const int r = i / K, k = i % K, s = j + k - pad;
          WIN[r * MAX_K + k] = s >= 0 && s < T_in ? __ldg(st + (size_t)r * T_in + s) : 0.f;
        }
        __syncthreads();
        // f: filter `lane` of rows warp, warp + NW, ..
        float* ft = FT + jj * MAX_B * F;
        for (int r = warp; r < B; r += NW) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s = fmaf(WIN[r * MAX_K + k], LWK[k * F + lane], s);
          ft[r * F + lane] = s + __ldg(a.loc_b + lane);
        }
        __syncthreads();
        // pl and v_a tanh(u) of d = dd and rows half + 2i; summed over the d of the warp's
        // lanes, then over the row's 4 warps in order
        {
          const float va = __ldg(a.v_a + dd), ba = __ldg(a.b_a + dd);
          float pl[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) pl[i] = 0.f;
          for (int f4 = 0; f4 < F / 4; ++f4) {  // 4 filters at a time, in order
            const float w[4] = {LWT[(4 * f4) * LWD + dd], LWT[(4 * f4 + 1) * LWD + dd],
                                LWT[(4 * f4 + 2) * LWD + dd], LWT[(4 * f4 + 3) * LWD + dd]};
#pragma unroll
            for (int i = 0; i < RPT; ++i)
              if (half + 2 * i < B) {
                const float4 x = reinterpret_cast<const float4*>(ft + (half + 2 * i) * F)[f4];
                pl[i] = fmaf(x.x, w[0], pl[i]);
                pl[i] = fmaf(x.y, w[1], pl[i]);
                pl[i] = fmaf(x.z, w[2], pl[i]);
                pl[i] = fmaf(x.w, w[3], pl[i]);
              }
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = half + 2 * i;
            if (r >= B) break;  // the same r in every lane of the warp
            const float tu = tanhf((KQ[r * D + dd] + pl[i]) + ba);
            th[jj][i] = tu;
            float v = va * tu;
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
    }
    grid_sync(a.bar, target, times, 0);

    // --- 2. the normalisation's backward and the location path of the CTA's input steps
    if (cta < T_in) {
      float* DE = SCR;           // (JPC, MAX_B) the energies' gradient
      float* DU = SCR + DU_OFF;  // (MAX_B, D) du of the input step
      // dkeys' sums so far of this thread's (row, input step, d), loaded before the
      // statistics' pass (one round trip, not one a row)
      float ks[JPC][RPT];
#pragma unroll
      for (int jj = 0; jj < JPC; ++jj)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int j = cta + jj * G, r = half + 2 * i;
          ks[jj][i] = j < T_in && r < B ? a.dkeys[((size_t)r * T_in + j) * D + dd] : 0.f;
        }
      // each row's statistics in one pass: warp w the rows RPW w .., 32 / RPW lanes a row
      // (RPW = 1, 2 or 4 as B needs), lane l of them the input steps l, l + 32 / RPW, ..:
      // the softmax's running max m, its sum S of exp(e - m) and Q of dal exp(e - m),
      // rescaled as m grows (the smoothing's sigmoids as they are), then the row's lanes'
      // combined; dal = (dalign + ga) + dstate. Then the energies' gradient of the CTA's
      // input steps, de = (dal - Q / S) exp(e - m) / S (the smoothing's (dal - Q / S) / S
      // sig (1 - sig)), zero off the mask and past B
      {
        const int RPW = B > 16 ? 4 : B > 8 ? 2 : 1, LPR = 32 / RPW;
        const int r = RPW * warp + lane / LPR, l8 = lane % LPR;
        const size_t row = (size_t)r * T_in, grow = tb * T_in + row;
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
                        + __ldcg(a.dstate + row + j);
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
        if (l8 < JPC && r < MAX_B) {
          const int j = cta + l8 * G;
          float g = 0.f;
          if (r < B && j < T_in && !(a.mask && !(a.mask[row + j] > 0.0f))) {
            const float e = __ldcg(a.eb + row + j), s = Q / S;
            const float dal = (__ldcg(a.dalign + row + j) + __ldg(a.ga + grow + j))
                              + __ldcg(a.dstate + row + j);
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
      const float va = __ldg(a.v_a + dd);
#pragma unroll
      for (int jj = 0; jj < JPC; ++jj) {
        const int j = cta + jj * G;
        if (j >= T_in) break;
        const float* ft = FT + jj * MAX_B * F;
        // du = (de v_a)(1 - tanh^2 u) of this thread's d and rows: dkeys, dva's and dl's
        // partials
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = half + 2 * i;
          if (r >= B) break;
          const float de = DE[jj * MAX_B + r], tu = th[jj][i];
          const float g = (de * va) * (1.0f - tu * tu);
          const size_t o = ((size_t)r * T_in + j) * D + dd;
          a.dkeys[o] = ks[jj][i] + g;
          a.dus[o] = g;
          DU[r * D + dd] = g;
          dva_p[i] = fmaf(de, tu, dva_p[i]);
          const float4* f4 = reinterpret_cast<const float4*>(ft + r * F);
#pragma unroll
          for (int c = 0; c < F / 4; ++c) {
            const float4 x = f4[c];
            dl_p[4 * c] = fmaf(g, x.x, dl_p[4 * c]);
            dl_p[4 * c + 1] = fmaf(g, x.y, dl_p[4 * c + 1]);
            dl_p[4 * c + 2] = fmaf(g, x.z, dl_p[4 * c + 2]);
            dl_p[4 * c + 3] = fmaf(g, x.w, dl_p[4 * c + 3]);
          }
        }
        __syncthreads();
        // df = du @ l_w: filter `lane` of rows warp, warp + NW, .., 4 d at a time in order
        for (int r = warp; r < B; r += NW) {
          const float4* du4 = reinterpret_cast<const float4*>(DU + r * D);
          const float4* lw4 = reinterpret_cast<const float4*>(LWT + lane * LWD);
          float s = 0.f;
#pragma unroll 8
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 x = du4[d4], w = lw4[d4];
            s = fmaf(x.x, w.x, s);
            s = fmaf(x.y, w.y, s);
            s = fmaf(x.z, w.z, s);
            s = fmaf(x.w, w.w, s);
          }
          a.df[((tb + r) * T_in + j) * F + lane] = s;
        }
        __syncthreads();  // DU, again for the next input step
      }
    }
    grid_sync(a.bar, target, times, 1);

    // --- 3. the sums over the input steps, warp w the input steps w, w + NW, .., added
    // in warp order: dpq (CTA c < 4B the row c / 4, d = 32 (c % 4) + lane); then the
    // state's gradient, the conv's transpose of df: position s takes df's rows s - k + pad
    // of tap k, the (row, 32 positions) a pair over the grid ---
    {
      float* PS = SCR;  // (NW, 32)
      float4* DFW = reinterpret_cast<float4*>(SCR + DFW_OFF);  // (WIN_ROWS, F / 4)
      const float4* LWK4 = reinterpret_cast<const float4*>(LWK);
      if (cta < 4 * B) {
        const int b = cta / 4, d = 32 * (cta % 4) + lane;
        float s = 0.f;
        for (int j = warp; j < T_in; j += NW) s += __ldcg(a.dus + ((size_t)b * T_in + j) * D + d);
        PS[warp * 32 + lane] = s;
        __syncthreads();
        if (warp == 0) {
          float v = PS[lane];
          for (int w = 1; w < NW; ++w) v += PS[w * 32 + lane];
          a.dpq[(tb + b) * D + d] = v;
          dba_r += v;
        }
      }
      const int NCH = (T_in + 31) / 32;
      for (int p = cta; p < B * NCH; p += G) {
        const int b = p / NCH, s0 = 32 * (p % NCH), j0 = s0 + pad - (K - 1);
        __syncthreads();  // PS and DFW's last use
        for (int i = tid; i < (32 + K - 1) * (F / 4); i += NT) {
          const int j = j0 + i / (F / 4);
          DFW[i] = j >= 0 && j < T_in
                       ? __ldcg(reinterpret_cast<const float4*>(a.df + ((tb + b) * T_in + j) * F) + i % (F / 4))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
        // position s0 + tid / 8, the filters 4 (tid % 8) ..; the 8 lanes' sums combined
        const int i = tid / 8, q = tid % 8, s = s0 + i;
        float acc = 0.f;
        for (int k = 0; k < K; ++k) {
          const float4 x = DFW[(i - k + K - 1) * (F / 4) + q];
          const float4 w = LWK4[k * (F / 4) + q];
          acc = fmaf(x.x, w.x, acc);
          acc = fmaf(x.y, w.y, acc);
          acc = fmaf(x.z, w.z, acc);
          acc = fmaf(x.w, w.w, acc);
        }
        for (int o = 1; o < 8; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
        if (q == 0 && s < T_in) {
          const size_t o = (size_t)b * T_in + s;
          a.dstate[o] = a.cumulate ? __ldcg(a.dstate + o) + acc : acc;
        }
      }
    }
    grid_sync(a.bar, target, times, 2);

    // --- 4. LSTM 2's backward: dhb = dpq @ q_w of the CTA's units (warp w the k-quad w,
    // both m-tiles), then the cells on dproj[:U] + dhb ---
    {
      float* PR = SCR;  // (NW, MAX_B, 16), columns 0 .. 7
      // the cell's inputs of this step, loaded before the product
      const size_t i = (tb + crow) * U + cu, zr = (tb + crow) * 4 * U + cu;
      float z[4] = {}, cp = 0.f, dha = 0.f;
      int kc = -1, kh = -1;
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = __ldg(a.z2 + zr + q * U);
        cp = t ? __ldg(a.c2p + i - BU) : 0.f;
        dha = __ldg(a.dproj + (tb + crow) * (U + E) + cu);
        kc = keep_of(a.keep[2], i);
        kh = keep_of(a.keep[3], i);
      }
      {
        float d[2][2][4] = {};
        uint4 av[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m) aquad(av[m], a.dpq + tb * D, D, B, m, 16 * warp, lane);
        const uint4 b[2] = {QWF[warp * 32 + lane], make_uint4(0u, 0u, 0u, 0u)};
        add_quads<MT>(d, av, b);
        put_partials<MT>(PR, d, warp, lane);
      }
      __syncthreads();
      if (cell) {
        float dz[4];
        lstm_cell_bwd(z, cp, dha + column(PR, crow, ci), dh2, dc2, kc, kh, a.a[2], a.a[3], dz,
                      byp2);
#pragma unroll
        for (int q = 0; q < 4; ++q) a.dz2[zr + q * U] = dz[q];
      }
    }
    grid_sync(a.bar, target, times, 3);

    // --- 5. din2's columns of the CTA (its units' dx1: tile 0, streamed; then their dh2:
    // tile 1, resident) over every CTA's dz2, then LSTM 1's backward on dx1 ---
    {
      float* RED = SCR;
      // the cell's inputs of this step, loaded before the product
      const size_t i = (tb + crow) * U + cu, zr = (tb + crow) * 4 * U + cu;
      float z[4] = {}, cp = 0.f;
      int kc = -1, kh = -1;
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) z[q] = __ldg(a.z1 + zr + q * U);
        cp = t ? __ldg(a.c1p + i - BU) : 0.f;
        kc = keep_of(a.keep[0], i);
        kh = keep_of(a.keep[1], i);
      }
      float d[2][2][4] = {};
      const float* x = a.dz2 + tb * KZ;
      for (int i0 = 0; i0 < KQW; i0 += NB) {
        uint4 av[NB][MT][2];
        uint4 bw[NB];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int kq = warp + NW * (i0 + n);
#pragma unroll
          for (int m = 0; m < MT; ++m) aquad(av[n][m], x, KZ, B, m, 16 * kq, lane);
          bw[n] = __ldcg(g2x + (size_t)kq * 32 + lane);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int kq = warp + NW * (i0 + n);
          const uint4 b[2] = {bw[n], WR[kq * 32 + lane]};
          add_quads<MT>(d, av[n], b);
        }
      }
      put_partials<MT>(RED, d, warp, lane);
      __syncthreads();
      if (cell) {
        dh2 = column(RED, crow, 8 + ci) + byp2;
        float dz[4];
        lstm_cell_bwd(z, cp, column(RED, crow, ci), dh1, dc1, kc, kh, a.a[0], a.a[1], dz, byp1);
#pragma unroll
        for (int q = 0; q < 4; ++q) a.dz1[zr + q * U] = dz[q];
      }
    }
    grid_sync(a.bar, target, times, 4);

    // --- 6. din1's columns of the CTA: its units' dh1 (tile 0), its 4 context columns
    // (tile 1; lanes g >= 4 read column g % 4 again), both streamed ---
    {
      float* RED = SCR;
      float d[2][2][4] = {};
      const float* x = a.dz1 + tb * KZ;
      for (int i0 = 0; i0 < KQW; i0 += NB) {
        uint4 av[NB][MT][2];
        uint4 bw[NB][2];
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int kq = warp + NW * (i0 + n);
#pragma unroll
          for (int m = 0; m < MT; ++m) aquad(av[n][m], x, KZ, B, m, 16 * kq, lane);
          bw[n][0] = __ldcg(g1h + (size_t)kq * 32 + lane);
          bw[n][1] = __ldcg(g1c + (size_t)kq * 16 + (gid % EPC) * 4 + tig);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const uint4 b[2] = {bw[n][0], bw[n][1]};
          add_quads<MT>(d, av[n], b);
        }
      }
      put_partials<MT>(RED, d, warp, lane);
      __syncthreads();
      if (cell) {
        dh1 = column(RED, crow, ci) + byp1;
        if (ci < EPC) a.dctx[(size_t)crow * E + EPC * cta + ci] = column(RED, crow, 8 + ci);
      }
    }
    grid_sync(a.bar, target, times, 5);
  }

  // --- after the last step: the CTAs' partials of dva and dl, summed in CTA order (dl's
  // two halves of the rows in order); dba by the threads that held it ---
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = half + 2 * i;
    if (r < B) a.dvap[((size_t)cta * B + r) * D + dd] = dva_p[i];
  }
  float* dlp = a.dlp + ((size_t)cta * 2 + half) * D * F + (size_t)dd * F;
#pragma unroll
  for (int c = 0; c < F; ++c) dlp[c] = dl_p[c];
  if (warp == 0 && cta < 4 * B) a.dba[(size_t)(cta / 4) * D + 32 * (cta % 4) + lane] = dba_r;
  grid_sync(a.bar, target, times, -1);
  for (int i = cta * NT + tid; i < B * D + D * F; i += G * NT) {
    float s = 0.f;
    if (i < B * D) {
      for (int c = 0; c < G; ++c) s += __ldcg(a.dvap + (size_t)c * B * D + i);
      a.dva[i] = s;
    } else {
      const int o = i - B * D;
      for (int c = 0; c < 2 * G; ++c) s += __ldcg(a.dlp + (size_t)c * D * F + o);
      a.dl[o] = s;
    }
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
  cudaError_t err = cudaFuncSetAttribute(decoder_bwd_loop_f32_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_bwd_loop_f32_kernel<MT>,
                                                      NT, SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < G) {  // the grid barrier needs every CTA resident
    info[0] = per_sm * sms;
    info[1] = G;
    return cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)decoder_bwd_loop_f32_kernel<MT>, dim3(G),
                                    dim3(NT), args, SMEM, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int t2_decoder_bwd_loop_f32(void* const* p, const int* n, const float* keep,
                                       int* info, void* stream) {
  Args a;
  a.keys = (const float*)p[P_KEYS];
  a.values = (const float*)p[P_VALUES];
  a.mask = (const float*)p[P_MASK];
  a.dproj = (const float*)p[P_DPROJ];
  a.ga = (const float*)p[P_GA];
  a.z1 = (const float*)p[P_Z1];
  a.z2 = (const float*)p[P_Z2];
  a.c1p = (const float*)p[P_C1P];
  a.c2p = (const float*)p[P_C2P];
  a.state = (const float*)p[P_STATE];
  a.pq = (const float*)p[P_PQ];
  a.g1 = (const float*)p[P_G1_W];
  a.g2 = (const float*)p[P_G2_W];
  a.q_w = (const float*)p[P_Q_W];
  a.loc_w = (const float*)p[P_LOC_W];
  a.loc_b = (const float*)p[P_LOC_B];
  a.l_w = (const float*)p[P_L_W];
  a.v_a = (const float*)p[P_V_A];
  a.b_a = (const float*)p[P_B_A];
  for (int g = 0; g < 4; ++g) {
    a.keep[g] = (const uint8_t*)p[P_KEEP_C1 + g];
    a.a[g] = keep[g];
  }
  a.dz1 = (float*)p[P_DZ1];
  a.dz2 = (float*)p[P_DZ2];
  a.dpq = (float*)p[P_DPQ];
  a.dctx_total = (float*)p[P_DCTX_TOTAL];
  a.df = (float*)p[P_DF];
  a.dkeys = (float*)p[P_DKEYS];
  a.dva = (float*)p[P_DVA];
  a.dba = (float*)p[P_DBA];
  a.dl = (float*)p[P_DL];
  a.dctx = (float*)p[P_DCTX];
  a.dstate = (float*)p[P_DSTATE];
  a.dalign = (float*)p[P_DALIGN];
  a.eb = (float*)p[P_EB];
  a.dus = (float*)p[P_DUS];
  a.g2x = (uint4*)p[P_G2X];
  a.g1h = (uint4*)p[P_G1H];
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
  return (int)(a.B > 16 ? launch<2>(a, info, (cudaStream_t)stream)
                        : launch<1>(a, info, (cudaStream_t)stream));
}
