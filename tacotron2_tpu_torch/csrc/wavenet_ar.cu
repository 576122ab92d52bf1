// WaveNet autoregressive generation on Hopper: the whole sample loop in one launch, one
// thread-block cluster of N CTAs a sequence.
//
// Replaces tacotron2_tpu/ops/pallas/wavenet_ar.py:generate_ar (the Pallas TPU kernel),
// in these variants: scalar input with a Gaussian head (out_channels == 2) or a
// mixture-of-logistics head (out_channels == 3*nr), or one-hot input with a categorical
// head over Q <= 1024 classes (Gumbel-max from pre-sampled noise), or the big-vocab
// categorical head over up to 65,536 classes (bf16 first conv and last head layer,
// Gumbel noise drawn inside the kernel from a counter-based generator, or greedy:
// wavenet_ar.py:67-74, 414-448); for both categorical heads, optionally, the
// natural-eval NLL of given class ids y_eval computed in place from each step's logits
// (wavenet_ar.py:470-481) in place of the params; the fused critical
// path (wavenet_fused_ar=True) or the plain chain of two serial matvecs per layer; head
// and chain are template parameters, so each pair compiles on its own; local
// conditioning, with or without a global conditioning row g_cond (B, L*G);
// a fresh call (zero ring buffers, h = first_b) or a streamed continuation that takes
// the ring buffers, the next-step h and the absolute step offset t_base from the
// previous call (the TPU kernel's state_in / return_state, wavenet_ar.py:249-271,
// 504-511) and hands h back at the end; the rings are updated in place.
//
// The step (f32 accumulation; activations rounded to bf16 where the TPU kernel casts
// them, so that the plain PyTorch version, ops/wavenet_ar.py generate_ar_reference,
// computes the same function):
//   1. the conditioning row  bf16(c_t) @ w_cond + b_cond (+ g_cond[b], the speaker's
//      bias, wavenet_ar.py:299-300, 314-315), rounded to bf16 where the TPU kernel keeps
//      a bf16 per-chunk slab (padded batch <= 16 rows; the wrapper passes round_cond);
//   2. per layer l: consts = b_tap (+ b_fused) + cond_l + bf16(past taps) @ w_tap[l][:past];
//   3. the fused chain  z_l = GLU(z_{l-1} @ w_fused[l] + rho bf16(h_{l-1}) @ w_cur[l]
//      + consts) with the residual/skip 1x1 of layer l-1 beside it; or the plain chain
//      (wavenet_ar.py:342-361)  z_l = GLU(bf16(h) @ w_cur[l] + consts), then
//      bf16(z_l) @ w_os[l] + b_os: two dependent matvecs a layer;
//   4. the head  relu -> 1x1 -> relu -> 1x1 (the last 1x1 in f32; bf16 for the big head);
//   5. the sample: Gaussian  clip(mean + exp(max(logs, log_scale_min)) * eps, -1, 1);
//      MoL (wavenet_ar.py:455-464)  the mixture of largest logit + Gumbel noise, ties
//      averaged, then clip(mean + exp(max(logs, log_scale_min)) * logistic, -1, 1);
//      categorical (wavenet_ar.py:425-448)  the class of largest logit + Gumbel noise,
//      the first on ties, written as a float;
//   6. the feedback  h = sample * first_w + first_b;  categorical: the bf16-rounded row
//      first_w[class] + first_b (each of c tied classes weighs bf16(1/c)); a fresh
//      categorical call starts from the f32 row of class Q/2 (silence; the big head
//      reads it from its bf16 first_w).
//
// Design. A sequence runs on a cluster of N CTAs (grid B*N), N in {1, 2, 4, 8, 16}, chosen
// by the wrapper (ops/wavenet_ar.py cluster_size): the largest N of which the card keeps
// at least B clusters resident (cudaOccupancyMaxActiveClusters, wavenet_ar_occupancy
// below), else 1; N = 1 is the one-SM-a-sequence layout of a large batch. A CTA takes an
// SM of its own (it asks for at least 117 KB of shared memory) and threads_for threads:
// 1,024 on one or two CTAs, 256 on eight or sixteen, where a CTA has little work and idle
// warps would only take issue slots from the chain; 512 in the SMALL layout below.
//  - The outputs are split over the cluster, never K: CTA r owns the gate pairs (n,
//    n + G/2) for n in [r G/(2N), (r+1) G/(2N)) of every layer, so it runs its GLU
//    itself, the residual columns [r R/N, (r+1) R/N), the skip columns [r S/N, (r+1)
//    S/N), and the matching columns of the conditioning row.
//  - Off the chain, at the start of each step, every CTA stages all layers' past taps
//    from the rings (each written at an earlier step) and computes, for its columns of
//    every layer, the conditioning row and the past-tap product into consts.
//  - On the chain, after each layer, every CTA writes its slice of z and of rho bf16(h)
//    into every peer's shared memory (distributed shared memory, double-buffered by
//    layer parity) and the cluster meets at one barrier (barrier.cluster arrive.release
//    / wait.acquire): one exchange a layer in the fused chain, two in the plain one.
//    Each CTA then runs the next layer's matvecs over the whole K from its own copy,
//    the matvecs of a layer side by side on different threads.
//  - Where a CTA's slice of a layer's chain weights is whole 16-byte rows and two
//    slices fit (wpre: N >= 4 at the defaults, 16 at the paper width), the next layer's
//    slice is staged with cp.async into the other of two slots in shared memory while
//    this layer runs, so the chain's matvecs read shared memory, not L2.
//  - A large batch (one or two CTAs a sequence) at the defaults' widths, with any head
//    but the big one (small_layout: where it was measured faster), runs an instantiation
//    of its own (SMALL): 512 threads of up to 128 registers, where 1,024 threads at 64
//    spill (in 9 of the 12 general instantiations) and every SM streams all its chain
//    weights from L2 each step; a cluster of one meets at block barriers, not
//    barrier.cluster, and writes its own shared memory directly. Compiled apart, it
//    leaves the other clusters' code as it was. At the paper width (768 KB of chain
//    weights a CTA and layer at N = 1) 512 threads were too few to keep the loads in
//    flight, and the big head's class scan on 512 threads was slower: both stay on 1,024.
//  - In the SMALL layout a cluster of two may run two sequences (NQ = 2; the wrapper's
//    cluster_layout takes it on the fused chain where a cluster of one would be the
//    choice, as at B=132, and it was measured faster there): each CTA
//    owns half the columns, as at N = 2, and computes them for both sequences from each
//    weight it loads (two accumulators a column, job_run_seqs), so that every SM streams
//    half the layer weights a step where a cluster of one streams them all. Each
//    sequence keeps its own copy of the per-sequence shared memory (consts, taps,
//    activations, partial sums: the region up to the end of red, SQ floats, repeated),
//    its own ring, inputs and outputs; both exchange at the same barriers. The last
//    cluster of an odd batch runs its one sequence alone (np = 1). Each sequence sums in
//    its own K-slice order, so the outputs are the same bits as one sequence a cluster.
//    This code sits in `if constexpr (SMALL)` branches beside the other layouts' code,
//    which stays as it was.
//  - The skip sum meets the same way, then the head's first 1x1 (split by columns).
//    The Gaussian, MoL and small categorical heads run in every CTA on the same values
//    (every CTA draws the same sample and feedback; rank 0 writes the outputs). The big
//    head splits its classes over the cluster in blocks of 256; each CTA's (largest
//    score, first class, tie count) meets the others' in every CTA through distributed
//    shared memory, merged in rank order (exact in any order); tied classes' bits too,
//    and every CTA feeds back their rows in class order. Philox stays keyed by (class,
//    step, sequence), so ids do not depend on N.
//
// A fixed sum order. Each output column's sum is split into a fixed number of K-slices
// (KS_CHAIN for the chain and the head, KS_START for the step's start), slice ks summing
// rows ks, ks + KS, ... in order, the slices then added in slice order, whatever N is
// and whichever thread runs a slice. The NLL's log-sum-exp is merged within fixed
// blocks of classes (a lane's classes in order, then a fixed shuffle tree), then over
// the blocks in order. So audio, params, NLL, state and ids are bit-identical across N.
//
// State. The rings are one (B, ring_floats) f32 tensor, layer l's (k-1)*dilation slots
// of R floats each; CTA r writes its residual columns of each layer's input into the
// ring after that layer's barrier, and reads the whole tap rows (plain loads, not
// __ldg: a peer wrote them at an earlier step, ordered by the cluster barriers). Rank
// 0 writes h_out.
//
// Where the data lives. The packed bf16 weights (7.4 MB at the default L=20, R=128,
// G=256, S=128; 33.6 MB at the paper profile's L=24, R=256, G=512, S=256) stay in global
// memory, which the 50 MB L2 holds across steps; a CTA reads its own slice of them each
// step (about 3.9 MB / N on the chain at the defaults). Taps (bf16), consts, the
// exchanged activations, the partial sums and the weight slots live in shared memory
// (at most 215 KB: N = 1 at the paper width).
//
// What bounds it. A step's arithmetic is about 3.7 M multiply-adds at the defaults
// (0.0148 us of tensor-core time at B=2): the step is bound by latency, the chain of 20
// dependent layers, each a round of loads, a block barrier and a cluster exchange.
// Spreading a sequence over N SMs cuts each layer's work per SM by N and brings N SMs'
// load slots to it; what stays on the chain is, a layer, a few shared-memory rounds, one
// block barrier and one cluster barrier, and at the step's start the off-chain work
// (staging the taps, the conditioning row, the past taps), which still sits on the
// step's timeline (probes/ar_split.py measures the split). Computing the next step's
// consts on idle threads during this step, and tensor-core mma over batched rows, are
// left for later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT_MAX = 1024;   // threads per CTA, at most (threads_for)
constexpr int SMALL_NT = 512;  // ... in the SMALL layout (small_layout)
constexpr int UNROLL = 4;      // weight loads in flight per thread and row slice
constexpr int KS_CHAIN = 32;   // K-slices of each chain and head matvec column
constexpr int KS_START = 16;   // ... of each conditioning-row and past-tap column
constexpr int MAX_CLUSTER = 16;
constexpr float SQRT_HALF = 0.70710678118654752f;
// out_channels == 2; 3*nr; Q <= 1024 classes; Q classes, noise drawn in the kernel
enum Head { GAUSSIAN, MOL, CATEGORICAL, CATEGORICAL_BIG };
enum Chain { FUSED, PLAIN };  // wavenet_fused_ar on; off

struct Args {
  const float* c_up;       // (B, T, cin)
  const float* noise;      // (B, T) Gaussian, (B, T, nr+1) MoL, (B, T, Q) categorical;
                           // unread by the big-vocab head
  const float* first_w;    // (R,); categorical (Q, R); big-vocab (Q, R) bf16
  const float* first_b;    // (R,)
  const __nv_bfloat16* w_tap;    // (L, k*R, G)
  const float* b_tap;            // (L, G)
  const __nv_bfloat16* w_os;     // (L, G/2, R+S)
  const float* b_os;             // (L, R+S)
  const __nv_bfloat16* w_fused;  // (L, G/2, G); null for the plain chain
  const float* b_fused;          // (L, G); null for the plain chain
  const __nv_bfloat16* w_cond;   // (cin, L*G)
  const float* b_cond;           // (L*G,)
  const __nv_bfloat16* w_s1;     // (S, S)
  const float* b_s1;             // (S,)
  const float* w_s2;             // (S, out_ch); big-vocab (S, q_ld) bf16
  const float* b_s2;             // (out_ch,)
  const float* g_cond;           // (B, L*G) global conditioning row, or null
  float* rings;                  // (B, ring_floats): zeroed here, or the carried state
  const float* h_in;             // (B, R) carried next-step h, or null: a fresh call
  float* h_out;                  // (B, R) next-step h after the last step, or null
  float* audio;                  // (B, T); categorical: class ids as floats
  float* params;                 // (B, T, out_ch) or null
  const int* y_eval;             // (B, T) class ids to score, with nll
  float* nll;                    // (B, T) logsumexp(logits) - logits[y_eval], or null
  unsigned int seed_lo, seed_hi;  // the Philox key of the big-vocab head's noise
  int q_ld, greedy;              // columns of the big-vocab w_s2; no noise: arg-max
  long long ring_floats;
  long long t_base;              // absolute step of local step 0
  int T, cin, L, lps, R, G, S, k, out_ch, legacy, residual_legacy, round_cond;
  int N;                         // CTAs a cluster (a sequence)
  int wpre;                      // stage the chain's weights a layer ahead (prefetches)
  float log_scale_min;
  int NQ, B;  // sequences a cluster (2 only in SMALL), of the batch's B
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The split of a step inside the kernel (built with -DT2_PROFILE by probes/ar_split.py):
// thread 0 of CTA 0 adds the %globaltimer nanoseconds since its last mark to slot s of
// g_prof; wavenet_ar_profile reads the slots out. Without T2_PROFILE, nothing.
enum ProfSlot { P_STAGE, P_COND, P_TAPS, P_GATE0, P_LAYER_WORK, P_ARRIVE, P_WAIT,
                P_MATVEC, P_HEAD_SKIP, P_HEAD_S1, P_SAMPLE, P_FEEDBACK, P_SLOTS };
#ifdef T2_PROFILE
__device__ unsigned long long g_prof[P_SLOTS];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF(slot)                                                  \
  do {                                                              \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                      \
      const unsigned long long t_ = now_ns();                       \
      g_prof[slot] += t_ - prof_t;                                  \
      prof_t = t_;                                                  \
    }                                                               \
  } while (0)
#else
#define PROF(slot) \
  do {             \
  } while (0)
#endif

// the CTA's threads (threads_for: fewer on larger clusters, where each CTA has less
// work and idle warps would only take issue slots from the chain)
__device__ __forceinline__ int nt() { return (int)blockDim.x; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// V (8 or 1) consecutive bf16 weights as floats (one 16- or 2-byte load; from shared
// memory with SM, else read-only from global memory)
template <int V, bool SM = false>
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float f[V]) {
  if constexpr (V == 8) {
    const uint4 u = SM ? *reinterpret_cast<const uint4*>(p)
                       : __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
    f[0] = __bfloat162float(p[0]);
  }
}

// One matvec job: the CTA's owned columns times a K of one or two row segments.
// Owned column c (c < nrange * cw) lies in range q = c / cw: layer l = q / rpl (rpl
// ranges a layer), column col0 + (q % rpl) * col_step + c % cw of the layer's matrix,
// which starts w_lstride elements after the previous layer's; its activations
// act_lstride floats after. Segment s: rows [0, rows[s]) of w[s] (leading dimension
// ld[s]) times act[s].
struct Job {
  const __nv_bfloat16* w[2];  // in global memory, or in shared memory with sm
  const void* act[2];  // f32, or bf16 (the taps): job_run's A
  bool sm;
  int ld[2], rows[2], nseg;
  int nrange, cw, rpl, col0, col_step;
  long long w_lstride;
  int act_lstride;
};

__device__ __forceinline__ Job job1(const __nv_bfloat16* w, int ld, int rows,
                                    const void* act, int nrange, int cw, int rpl,
                                    int col0, int col_step, long long w_lstride = 0,
                                    int act_lstride = 0) {
  Job j;
  j.w[0] = w; j.ld[0] = ld; j.rows[0] = rows; j.act[0] = act;
  j.w[1] = nullptr; j.ld[1] = 0; j.rows[1] = 0; j.act[1] = nullptr;
  j.nseg = 1; j.sm = false;
  j.nrange = nrange; j.cw = cw; j.rpl = rpl; j.col0 = col0; j.col_step = col_step;
  j.w_lstride = w_lstride; j.act_lstride = act_lstride;
  return j;
}

// the thread index counted from thread `first` of the CTA: jobs that run side by side
// start at different threads
__device__ __forceinline__ int spread(int first) {
  return (threadIdx.x + nt() - first % nt()) % nt();
}

// One item of a job: column group gi (V columns from owned column clo + gi V) and
// slice ks, into red[ks * cc + gi V ..]: the sum over rows r = ks, ks + KS, ... of each
// segment in turn (in row order) of act[r] * W[r][col(c)].
template <int V, typename A, bool SM>
__device__ __forceinline__ void job_item(const Job& j, int clo, int cc, int gi, int ks,
                                         int KS, float* red) {
  const int c = clo + gi * V;
  const int q = c / j.cw, l = q / j.rpl;
  const int col = j.col0 + (q % j.rpl) * j.col_step + c % j.cw;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int s = 0; s < j.nseg; ++s) {
    const __nv_bfloat16* w = j.w[s] + l * j.w_lstride + col;
    const A* act = static_cast<const A*>(j.act[s]) + l * j.act_lstride;
    const size_t ld = j.ld[s];
    const int rows = j.rows[s];
#pragma unroll UNROLL
    for (int r = ks; r < rows; r += KS) {
      float f[V];
      load_w<V, SM>(w + r * ld, f);
      const float x = to_f(act[r]);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(x, f[v], acc[v]);
    }
  }
  float* out = red + ks * cc + gi * V;
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = acc[v];
}

// Partial sums of owned columns [clo, chi) of job j over KS slices, every item
// (column group, slice) of job_item once: item i on thread first + i (mod the CTA's
// threads). The caller synchronises and adds the KS slices in order (reduce_slices).
template <int V, typename A, bool SM>
__device__ __forceinline__ void job_partials_v(const Job& j, int clo, int chi, int KS,
                                               float* red, int first) {
  const int cc = chi - clo, ng = cc / V, i0 = spread(first);
  if (nt() % ng == 0) {  // a thread keeps its column group: one division, not one an item
    for (int ks = i0 / ng; ks < KS; ks += nt() / ng)
      job_item<V, A, SM>(j, clo, cc, i0 % ng, ks, KS, red);
  } else {
    for (int it = i0; it < ng * KS; it += nt())
      job_item<V, A, SM>(j, clo, cc, it % ng, it / ng, KS, red);
  }
}

// 8 where 8 divides the job's column widths, offsets and strides (16-byte loads, all
// aligned), else 1 (the widths a small test model splits into)
__device__ __forceinline__ int job_width(const Job& j) {
  int m = j.cw | j.col0 | j.col_step | (int)(j.w_lstride & 0xffff) | j.ld[0]
          | (j.nseg > 1 ? j.ld[1] : 0);
  return (m & 7) == 0 ? 8 : 1;
}

// job_partials_v at the job's width, with activations of type A (the taps are bf16), the
// weights in shared memory with SM (the staged chain: 16-byte rows); returns the thread
// after its last item, where a job that runs beside it may start. Each call site
// names its A and SM, so that it inlines only the widths it can meet.
template <typename A, bool SM = false>
__device__ __forceinline__ int job_run(const Job& j, int clo, int chi, int KS, float* red,
                                       int first = 0) {
  const int V = SM ? 8 : job_width(j);
  if (V == 8)
    job_partials_v<8, A, SM>(j, clo, chi, KS, red, first);
  else
    job_partials_v<1, A, false>(j, clo, chi, KS, red, first);
  return first + (chi - clo) / V * KS;
}

// a chain job, on the staged slot or on global memory
__device__ __forceinline__ int chain_run(const Job& j, int clo, int chi, float* red,
                                         int first = 0) {
  return j.sm ? job_run<float, true>(j, clo, chi, KS_CHAIN, red, first)
              : job_run<float>(j, clo, chi, KS_CHAIN, red, first);
}

// SMALL: job_item for NQ sequences from each weight row loaded (16-byte column groups,
// weights in global memory): sequence e's activations lie e sq floats after sequence
// 0's (2 e sq bf16 taps), its partial sums e sq floats after red; each sequence sums its
// rows in the order job_item does for one. Two sequences keep U loads in flight.
template <int NQ, typename A, int U>
__device__ __forceinline__ void job_item_seqs(const Job& j, int l, int col, int cc, int gi,
                                              int ks, int KS, float* red, int sq) {
  const int asq = sq * (int)(sizeof(float) / sizeof(A));
  float acc[NQ][8];
#pragma unroll
  for (int e = 0; e < NQ; ++e)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[e][v] = 0.f;
  for (int s = 0; s < j.nseg; ++s) {
    const __nv_bfloat16* w = j.w[s] + l * j.w_lstride + col;
    const A* act = static_cast<const A*>(j.act[s]) + l * j.act_lstride;
    const size_t ld = j.ld[s];
    const int rows = j.rows[s];
#pragma unroll(NQ == 2 ? U : UNROLL)
    for (int r = ks; r < rows; r += KS) {
      float f[8];
      load_w<8>(w + r * ld, f);
#pragma unroll
      for (int e = 0; e < NQ; ++e) {
        const float x = to_f(act[e * asq + r]);
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[e][v] = fmaf(x, f[v], acc[e][v]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < NQ; ++e) {
    float* out = red + e * sq + ks * cc + gi * 8;
#pragma unroll
    for (int v = 0; v < 8; ++v) out[v] = acc[e][v];
  }
}

template <int NQ, typename A, int U>
__device__ __forceinline__ void job_partials_seqs(const Job& j, int clo, int chi, int KS,
                                                  float* red, int first, int sq) {
  const int cc = chi - clo, ng = cc / 8, i0 = spread(first);
  // an item's layer and column (job_item's, by shifts and masks: small_layout's widths
  // make every range width a power of two and give a layer one or two ranges)
  auto at = [&](int gi, int& l, int& col) {
    const int c = clo + gi * 8, q = c >> (__ffs(j.cw) - 1);
    l = q >> (j.rpl - 1);
    col = j.col0 + (q & (j.rpl - 1)) * j.col_step + (c & (j.cw - 1));
  };
  int l, col;
  if (nt() % ng == 0) {  // a thread keeps its column group: its column once
    at(i0 % ng, l, col);
    for (int ks = i0 / ng; ks < KS; ks += nt() / ng)
      job_item_seqs<NQ, A, U>(j, l, col, cc, i0 % ng, ks, KS, red, sq);
  } else {
    for (int it = i0; it < ng * KS; it += nt()) {
      at(it % ng, l, col);
      job_item_seqs<NQ, A, U>(j, l, col, cc, it % ng, it / ng, KS, red, sq);
    }
  }
}

// job_run of np (1 or 2) sequences, sq floats apart (SMALL: small_layout's widths are
// whole 16-byte column groups, and its chain weights are never staged)
template <typename A, int U>
__device__ __forceinline__ int job_run_seqs(const Job& j, int clo, int chi, int KS, float* red,
                                            int first, int np, int sq) {
  if (np == 2)
    job_partials_seqs<2, A, U>(j, clo, chi, KS, red, first, sq);
  else
    job_partials_seqs<1, A, U>(j, clo, chi, KS, red, first, 0);
  return first + (chi - clo) / 8 * KS;
}

// the sum of column c's KS slices, in slice order (the loads all issued first)
template <int KS>
__device__ __forceinline__ float reduce_slices(const float* red, int cc, int c) {
  float v[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) v[ks] = red[ks * cc + c];
  float s = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) s += v[ks];
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// rows [0, rows) of the bf16 matrix at w (leading dimension ld), the columns of nrange
// ranges of cw (range q at col0 + q col_step), into rows of dld at column dcol of dst
// in shared memory: 16-byte cp.async copies, threads from `first` on; returns the
// thread after the last copy
__device__ __forceinline__ int stage_cols(__nv_bfloat16* dst, int dld, int dcol,
                                          const __nv_bfloat16* w, int ld, int rows,
                                          int nrange, int cw, int col0, int col_step,
                                          int first) {
  const int per_row = nrange * cw / 8, i0 = spread(first);
  if (nt() % per_row == 0) {  // a thread keeps its 16-byte column: its offsets once
    const int c = (i0 % per_row) * 8, q = c / cw;
    const __nv_bfloat16* src = w + col0 + q * col_step + c % cw;
    for (int r = i0 / per_row; r < rows; r += nt() / per_row)
      cp_async16(dst + r * dld + dcol + c, src + (size_t)r * ld);
  } else {
    for (int i = i0; i < rows * per_row; i += nt()) {
      const int r = i / per_row, c = (i % per_row) * 8, q = c / cw;
      cp_async16(dst + r * dld + dcol + c, w + (size_t)r * ld + col0 + q * col_step + c % cw);
    }
  }
  return first + rows * per_row;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// --- the big-vocab head's noise: Philox4x32-10 (Salmon et al. 2011) ---
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

// 23 random mantissa bits -> u in [0, 1) -> Gumbel noise, all in f32
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return -logf(-logf(u + 1e-9f) + 1e-9f);
}

// Logits lg and scores sc (logit + noise, or the logit when greedy) of the 8 classes of
// group g, classes 8g .. 8g+7: o (S) @ w2[:, 8g .. 8g+7] + b_s2 in f32. Columns past Q
// (the padding of w2) get the logit of their zero weights; the caller skips them.
__device__ __forceinline__ void big_vocab_scores(const Args& a, const __nv_bfloat16* w2,
                                                 const float* o, int g, int b,
                                                 unsigned long long t_abs,
                                                 float lg[8], float sc[8]) {
  const size_t ld = a.q_ld;
  const __nv_bfloat16* w = w2 + (size_t)g * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) lg[i] = 0.f;
#pragma unroll UNROLL
  for (int s = 0; s < a.S; ++s) {
    float f[8];
    load_w<8>(w + s * ld, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) lg[i] = fmaf(o[s], f[i], lg[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = g * 8 + i;
    lg[i] += c < a.out_ch ? a.b_s2[c] : 0.f;
    sc[i] = lg[i];
  }
  if (!a.greedy) {
#pragma unroll
    for (int half8 = 0; half8 < 2; ++half8) {
      uint32_t bits[4];
      philox4x32_10((uint32_t)(2 * g + half8), (uint32_t)t_abs, (uint32_t)(t_abs >> 32),
                    (uint32_t)b, a.seed_lo, a.seed_hi, bits);
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[4 * half8 + i] += gumbel_from_bits(bits[i]);
    }
  }
}

// The largest score a thread (then the CTA, then the cluster) has seen, its lowest
// class, and how many classes tie it: merged exactly in any order.
struct Best {
  float v;
  int first, count;
};

__device__ __forceinline__ Best best_merge(Best x, Best y) {
  if (y.v > x.v) return y;
  if (y.v == x.v) {
    x.first = min(x.first, y.first);
    x.count += y.count;
  }
  return x;
}

__device__ __forceinline__ Best warp_best(Best x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best y;
    y.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    y.first = __shfl_xor_sync(0xffffffffu, x.first, off);
    y.count = __shfl_xor_sync(0xffffffffu, x.count, off);
    x = best_merge(x, y);
  }
  return x;
}

// CTA-wide best_merge; every thread calls, thread 0 gets the result. scratch: 96
// words of shared memory.
__device__ __forceinline__ Best block_best(Best x, float* scratch) {
  int* si = reinterpret_cast<int*>(scratch);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = warp_best(x);
  if (lane == 0) {
    scratch[warp] = x.v;
    si[32 + warp] = x.first;
    si[64 + warp] = x.count;
  }
  __syncthreads();
  if (warp == 0) {
    const bool w = lane < nt() / 32;
    x.v = w ? scratch[lane] : -INFINITY;
    x.first = w ? si[32 + lane] : INT_MAX;
    x.count = w ? si[64 + lane] : 0;
    x = warp_best(x);
  }
  return x;
}

// Two partial log-sum-exps (max m, sum s of exp(x - m)) into one.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * (m == mm ? 1.f : expf(m - mm)) + s2 * (m2 == mm ? 1.f : expf(m2 - mm));
  m = mm;
}

__device__ __forceinline__ void warp_lse(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
}

// Shared-memory floats of a CTA's partial sums: the chain's three matvecs (gate,
// residual, skip) side by side, and at least 8,192 (the chunks of the step's start).
__host__ __device__ __forceinline__ int red_floats(int R, int G, int S, int N) {
  const int chain = KS_CHAIN * (G / N + R / N + S / N);
  return chain > 8192 ? chain : 8192;
}

// v into element idx of `local` (a shared-memory array) in every CTA of the cluster; in
// the SMALL instantiation a cluster of one writes its own shared memory directly
template <bool SMALL>
__device__ __forceinline__ void share(cg::cluster_group& cluster, float* local, int idx,
                                      float v, int N) {
  if constexpr (SMALL) {
    if (N == 1) {
      local[idx] = v;
      return;
    }
  }
  for (int q = 0; q < N; ++q) cluster.map_shared_rank(local, q)[idx] = v;
}

// The GLU of the CTA's unit c (gate pair n0 + c, half + n0 + c) of a layer from its
// consts and the partial sums of its chain matvec, shared as z into every CTA's zb.
template <bool SMALL>
__device__ __forceinline__ void glu_unit(cg::cluster_group& cluster, const float* lconsts,
                                         const float* red_b, float* zb, int c, int hN,
                                         int n0, int N) {
  const float za = lconsts[c] + reduce_slices<KS_CHAIN>(red_b, 2 * hN, c);
  const float zg = lconsts[hN + c] + reduce_slices<KS_CHAIN>(red_b, 2 * hN, hN + c);
  share<SMALL>(cluster, zb, n0 + c, bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(0.5f * zg))), N);
}

// the CTA's residual columns [r0, r0 + RN) of a layer's input h into slot `slot` of
// that layer's ring
__device__ __forceinline__ void write_ring(float* ring, const float* h, int slot, int R,
                                           int r0, int RN) {
  for (int c = threadIdx.x; c < RN; c += nt()) ring[slot * R + r0 + c] = h[r0 + c];
}

// write_ring of np sequences, their rings rs floats apart, their h sq (SMALL)
__device__ __forceinline__ void write_ring_seqs(float* ring, const float* h, int slot, int R,
                                                int r0, int RN, int np, long long rs, int sq) {
  for (int i = threadIdx.x; i < np * RN; i += nt())
    ring[i / RN * rs + slot * R + r0 + i % RN] = h[i / RN * sq + r0 + i % RN];
}

// SMALL: the instantiation of small_layout (512 threads, 128 registers), compiled apart
// so that what it changes leaves the other layouts' code as it is (at 1,024 threads the
// kernel runs at 64 registers and spills, and a change to shared code moves every
// instantiation's spills): a cluster of one meets at block barriers and writes its own
// shared memory.
// SMALL asks for one CTA an SM (up to 128 registers; without it ptxas held the
// categorical plain chain to 64 and spilled); the other layouts ask for nothing more, so
// their code stays as it was.
template <int HEAD, int CHAIN, bool NLL, bool SMALL>
__global__ void __launch_bounds__(SMALL ? SMALL_NT : NT_MAX, SMALL ? 1 : 0)
    wavenet_ar_kernel(Args a) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, N = a.N;
  // the cluster's barrier (a block barrier on a cluster of one, in SMALL)
  auto arrive = [&]() {
    if (!SMALL || N > 1) cluster_arrive();
  };
  auto wait = [&]() {
    if (!SMALL || N > 1)
      cluster_wait();
    else
      __syncthreads();
  };
  auto barrier = [&]() {
    arrive();
    wait();
  };
  // b: the cluster's first sequence; SMALL: np of its NQ sequences present (the second
  // is absent in the last cluster of an odd batch)
  const int rank = (int)cluster.block_rank(), b = blockIdx.x / N * (SMALL ? a.NQ : 1);
  const int np = SMALL ? min(a.NQ, a.B - b) : 1;
  // SMALL, two sequences: weight loads in flight a thread (fewer on the plain chain, whose
  // instantiations spill at 4)
  constexpr int U2 = CHAIN == FUSED ? UNROLL : 2;
  const int R = a.R, G = a.G, S = a.S, L = a.L, k = a.k, cin = a.cin;
  const int half = G / 2, past = (k - 1) * R, LG = L * G, RS = R + S;
  const int hN = half / N, RN = R / N, SN = S / N, CG = 2 * hN;
  const int n0 = rank * hN, r0 = rank * RN, s0 = rank * SN;
  const int XW = R + half;
  // the first threads of the skip and GLU columns in a layer's work: whole warps after
  // the residual columns
  const int w_skip = ((SMALL ? np : 1) * RN + 31) / 32 * 32;
  const int w_glu = w_skip + ((SMALL ? np : 1) * SN + 31) / 32 * 32;
  const float rho = a.residual_legacy ? SQRT_HALF : 1.f;

  float* consts = smem;                 // (L, CG) the owned gate columns' step constants
  // (L, past) every layer's past taps, in bf16
  __nv_bfloat16* taps = reinterpret_cast<__nv_bfloat16*>(consts + L * CG);
  float* xc = consts + L * CG + L * past / 2;  // (cin) bf16-rounded c_t
  float* h = xc + cin;                  // (R) f32 h: the CTA's columns on the chain
  float* X = h + R;                     // 2 x [hb (R) | zb (G/2)]: the exchanged inputs
  float* skips = X + 2 * XW;            // (SN) the CTA's skip sums
  float* O = skips + SN;                // (S) bf16 relu(skip sum), exchanged
  float* P = O + S;                     // (S) the head's last input, exchanged
  // (L, RN + SN) the CTA's columns of b_os, residual then skip; on a cluster of one,
  // where they would take 48 KB at the paper width, read from global memory instead
  const bool sbos = N > 1;
  float* bos = P + S;
  float* bs1 = bos + (sbos ? L * (RN + SN) : 0);  // (SN) the CTA's columns of b_s1
  float* sample_s = bs1 + SN;  // (8) the sample; categorical: id, max, ties, logit[y_eval]
  float* merge = sample_s + 8;          // (MAX_CLUSTER, 8) the big head's partials
  float* blk_lse = merge + MAX_CLUSTER * 8;  // (256, 2) the big head's log-sum-exps a block
  float* scr = blk_lse + 512;           // (96) scratch of block_best
  int* ring_off = reinterpret_cast<int*>(scr + 96);  // (L) float offsets
  int* win = ring_off + L;                             // (L) slots per ring
  int* base = win + L;  // (L) t_base mod win: local step t uses slot (base + t) mod win
  float* red = reinterpret_cast<float*>(base + L);
  const int n_red = red_floats(R, G, S, N);
  float* red_b = red;                        // gate partials (KS_CHAIN, CG)
  float* red_r = red_b + KS_CHAIN * CG;      // residual partials (KS_CHAIN, RN)
  float* red_s = red_r + KS_CHAIN * RN;      // skip partials (KS_CHAIN, SN)
  // SMALL: the per-sequence floats (all up to the end of red); sequence e's copy of
  // consts, taps, xc, h, X, skips, O, P, sample_s and red lies e SQ floats on
  const int SQ = SMALL ? (int)(red + n_red - smem) : 0;
  const long long RF = a.ring_floats;
  // with wpre, two slots of the chain's weights, each a layer's gate rows (CG columns:
  // w_cur, then w_fused in the fused chain) and 1x1 rows (RN + SN columns)
  const int WS = (R + half) * CG + half * (RN + SN);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(red + n_red) + 15) & ~(uintptr_t)15);  // 16-byte rows
  int ws = 0;  // the slots used so far: slot ws & 1 holds the current layer's weights

  float* ring = a.rings + (size_t)b * a.ring_floats;
  if (tid == 0) {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      win[l] = (k - 1) * (1 << (l % a.lps));
      ring_off[l] = off;
      base[l] = (int)(a.t_base % win[l]);
      off += win[l] * R;
    }
  }
  auto bos_at = [&](int l, int c) {
    return sbos ? bos[l * (RN + SN) + c] : a.b_os[l * RS + (c < RN ? r0 + c : R + s0 + c - RN)];
  };
  if (sbos)
    for (int i = tid; i < L * (RN + SN); i += nt()) {
      const int l = i / (RN + SN), c = i % (RN + SN);
      bos[i] = a.b_os[l * RS + (c < RN ? r0 + c : R + s0 + c - RN)];
    }

  // The chain's weights of layer li (fused: layer li+1's gates, layer li's 1x1s; plain:
  // layer li's both) into slot `buf`, one commit group (prefetches); and the chain's
  // jobs, on the current slot with wpre, else on global memory.
  auto stage_slot = [&](int li, int buf) {
    __nv_bfloat16* d = wbuf + buf * WS;
    const int gl = CHAIN == FUSED ? li + 1 : li;
    int first = 0;
    if (gl < L) {
      first = stage_cols(d, CG, 0, a.w_tap + (size_t)gl * k * R * G + (size_t)past * G, G,
                         R, 2, hN, n0, half, first);
      if (CHAIN == FUSED)
        first = stage_cols(d + R * CG, CG, 0, a.w_fused + (size_t)gl * half * G, G, half, 2,
                           hN, n0, half, first);
    }
    const __nv_bfloat16* wos = a.w_os + (size_t)li * half * RS;
    first = stage_cols(d + (R + half) * CG, RN + SN, 0, wos, RS, half, 1, RN, r0, 0, first);
    stage_cols(d + (R + half) * CG, RN + SN, RN, wos, RS, half, 1, SN, R + s0, 0, first);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto gate_job = [&](int gl, const float* act) {
    const __nv_bfloat16* slot = wbuf + (ws & 1) * WS;
    Job j = a.wpre ? job1(slot, CG, R, act, 2, hN, 2, 0, hN)
                   : job1(a.w_tap + (size_t)gl * k * R * G + (size_t)past * G, G, R, act, 2,
                          hN, 2, n0, half);
    if (CHAIN == FUSED) {
      j.w[1] = a.wpre ? slot + R * CG : a.w_fused + (size_t)gl * half * G;
      j.ld[1] = a.wpre ? CG : G;
      j.rows[1] = half;
      j.act[1] = act + R;
      j.nseg = 2;
    }
    j.sm = a.wpre;
    return j;
  };
  auto os_job = [&](int li, bool skip, const float* zb) {
    const __nv_bfloat16* slot = wbuf + (ws & 1) * WS + (R + half) * CG;
    Job j = a.wpre ? job1(slot, RN + SN, half, zb, 1, skip ? SN : RN, 1, skip ? RN : 0, 0)
                   : job1(a.w_os + (size_t)li * half * RS, RS, half, zb, 1, skip ? SN : RN, 1,
                          skip ? R + s0 : r0, 0);
    j.sm = a.wpre;
    return j;
  };
  if (a.wpre) stage_slot(0, 0);
  for (int s = tid; s < SN; s += nt()) bs1[s] = a.b_s1[s0 + s];
  if constexpr (SMALL) {
  if (a.h_in == nullptr) {
    const long long lo = a.ring_floats * rank / N, hi = a.ring_floats * (rank + 1) / N;
    for (int e = 0; e < np; ++e)
      for (long long i = lo + tid; i < hi; i += nt()) ring[e * RF + i] = 0.f;
    for (int i = tid; i < np * R; i += nt()) {
      const int r = i % R;
      if constexpr (HEAD == CATEGORICAL)  // silence: the f32 row of class Q/2
        h[i / R * SQ + r] = a.first_w[(size_t)(a.out_ch / 2) * R + r] + a.first_b[r];
      else
        h[i / R * SQ + r] = a.first_b[r];
    }
  } else {
    for (int i = tid; i < np * R; i += nt()) h[i / R * SQ + i % R] = a.h_in[(size_t)b * R + i];
  }
  } else {
  if (a.h_in == nullptr) {
    const long long lo = a.ring_floats * rank / N, hi = a.ring_floats * (rank + 1) / N;
    for (long long i = lo + tid; i < hi; i += nt()) ring[i] = 0.f;
    for (int r = tid; r < R; r += nt()) {
      if constexpr (HEAD == CATEGORICAL)  // silence: the f32 row of class Q/2
        h[r] = a.first_w[(size_t)(a.out_ch / 2) * R + r] + a.first_b[r];
      else if constexpr (HEAD == CATEGORICAL_BIG)  // ... read from the bf16 first_w
        h[r] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                   a.first_w)[(size_t)(a.out_ch / 2) * R + r]) + a.first_b[r];
      else
        h[r] = a.first_b[r];
    }
  } else {
    for (int r = tid; r < R; r += nt()) h[r] = a.h_in[(size_t)b * R + r];
  }
  }
  __syncthreads();
  barrier();  // the zeroed rings, before any CTA reads a tap
#ifdef T2_PROFILE
  unsigned long long prof_t = now_ns();
#endif

  const int chunk = n_red / KS_START / 8 * 8;  // columns a pass of the step's start
  for (int t = 0; t < a.T; ++t) {
    // --- the step's inputs: c_t, every layer's past taps, layer 0's input h ---
    if constexpr (SMALL) {
    for (int i = tid; i < np * cin; i += nt())
      xc[i / cin * SQ + i % cin] = bf16r(a.c_up[((size_t)(b + i / cin) * a.T + t) * cin + i % cin]);
    for (int row = tid / 32; row < np * L * (k - 1); row += nt() / 32) {  // a warp a tap row
      const int q = row / (L * (k - 1)), l = row % (L * (k - 1)) / (k - 1), j = row % (k - 1);
      const int w = win[l], m = (k - 1 - j) * (w / (k - 1));
      const float* src = ring + q * RF + ring_off[l] + ((base[l] + t + w - m) % w) * R;
      __nv_bfloat16* dst = taps + 2 * q * SQ + l * past + j * R;
#pragma unroll 4
      for (int r = tid % 32; r < R; r += 32) dst[r] = __float2bfloat16(src[r]);
    }
    for (int i = tid; i < np * R; i += nt()) X[i / R * SQ + i % R] = bf16r(h[i / R * SQ + i % R]);
    for (int i = tid; i < np * SN; i += nt()) skips[i / SN * SQ + i % SN] = 0.f;
    } else {
    const float* ct = a.c_up + ((size_t)b * a.T + t) * cin;
    for (int i = tid; i < cin; i += nt()) xc[i] = bf16r(ct[i]);
    for (int row = tid / 32; row < L * (k - 1); row += nt() / 32) {  // a warp a tap row
      const int l = row / (k - 1), j = row % (k - 1);
      const int w = win[l], m = (k - 1 - j) * (w / (k - 1));
      const float* src = ring + ring_off[l] + ((base[l] + t + w - m) % w) * R;
      __nv_bfloat16* dst = taps + l * past + j * R;
#pragma unroll 4
      for (int r = tid % 32; r < R; r += 32) dst[r] = __float2bfloat16(src[r]);
    }
    for (int r = tid; r < R; r += nt()) X[r] = bf16r(h[r]);
    for (int s = tid; s < SN; s += nt()) skips[s] = 0.f;
    }
    __syncthreads();
    PROF(P_STAGE);

    // --- 1-2. off the chain: consts = b_tap (+ b_fused) + cond + past taps @ w_tap ---
    {
      const Job cond = job1(a.w_cond, LG, cin, xc, 2 * L, hN, 2, n0, half, G, 0);
      for (int clo = 0; clo < L * CG; clo += chunk) {
        const int chi = min(L * CG, clo + chunk);
        if constexpr (SMALL) {
        job_run_seqs<float, U2>(cond, clo, chi, KS_START, red, 0, np, SQ);
        __syncthreads();
        for (int i = tid; i < np * (chi - clo); i += nt()) {
          const int e = i / (chi - clo), c = clo + i % (chi - clo);
          const int q = c / hN, g = (q / 2) * G + n0 + (q % 2) * half + c % hN;
          float v = reduce_slices<KS_START>(red + e * SQ, chi - clo, c - clo) + a.b_cond[g];
          if (a.g_cond != nullptr) v += a.g_cond[(size_t)(b + e) * LG + g];
          v = a.round_cond ? bf16r(v) : v;
          const float bias = CHAIN == FUSED ? a.b_tap[g] + a.b_fused[g] : a.b_tap[g];
          consts[e * SQ + c] = bias + v;
        }
        } else {
        job_run<float>(cond, clo, chi, KS_START, red);
        __syncthreads();
        for (int c = clo + tid; c < chi; c += nt()) {
          const int q = c / hN, g = (q / 2) * G + n0 + (q % 2) * half + c % hN;
          float v = reduce_slices<KS_START>(red, chi - clo, c - clo) + a.b_cond[g];
          if (a.g_cond != nullptr) v += a.g_cond[(size_t)b * LG + g];
          v = a.round_cond ? bf16r(v) : v;
          const float bias = CHAIN == FUSED ? a.b_tap[g] + a.b_fused[g] : a.b_tap[g];
          consts[c] = bias + v;
        }
        }
        __syncthreads();
      }
      PROF(P_COND);
      const Job tap = job1(a.w_tap, G, past, taps, 2 * L, hN, 2, n0, half,
                           (long long)k * R * G, past);
      for (int clo = 0; clo < L * CG; clo += chunk) {
        const int chi = min(L * CG, clo + chunk);
        if constexpr (SMALL) {
        job_run_seqs<__nv_bfloat16, U2>(tap, clo, chi, KS_START, red, 0, np, SQ);
        __syncthreads();
        for (int i = tid; i < np * (chi - clo); i += nt()) {
          const int e = i / (chi - clo), c = clo + i % (chi - clo);
          consts[e * SQ + c] += reduce_slices<KS_START>(red + e * SQ, chi - clo, c - clo);
        }
        } else {
        job_run<__nv_bfloat16>(tap, clo, chi, KS_START, red);
        __syncthreads();
        for (int c = clo + tid; c < chi; c += nt())
          consts[c] += reduce_slices<KS_START>(red, chi - clo, c - clo);
        }
        __syncthreads();
      }
      PROF(P_TAPS);
    }

    if constexpr (CHAIN == FUSED) {
      // --- layer 0's gates: bf16(h) @ w_cur[0] ---
      if constexpr (SMALL) {
      job_run_seqs<float, U2>(job1(a.w_tap + (size_t)past * G, G, R, X, 2, hN, 2, n0, half), 0,
                          CG, KS_CHAIN, red_b, 0, np, SQ);
      } else {
      job_run<float>(job1(a.w_tap + (size_t)past * G, G, R, X, 2, hN, 2, n0, half), 0, CG,
                     KS_CHAIN, red_b);
      }
      __syncthreads();
      PROF(P_GATE0);

      // --- 3. the layer stack: one exchange and cluster barrier a layer ---
      for (int li = 0; li < L; ++li) {
        float* Xp = X + ((li + 1) & 1) * XW;
        // the next layer's weights (after the last, the next step's first) into the other
        // slot, while this layer runs
        if (a.wpre) stage_slot(li + 1 < L ? li + 1 : 0, (ws + 1) & 1);
        // h, the input of layer li (its residual partials in red_r), as rho bf16(h) for
        // layer li+1's gates; the skip of layer li-1
        // (the residual, skip and GLU columns on warps of their own: no branch between
        // them inside a warp)
        if constexpr (SMALL) {
        for (int i = tid; i < np * RN; i += nt()) {
          const int e = i / RN, c = i % RN, col = r0 + c;
          float hc = h[e * SQ + col];
          if (li > 0) {
            hc = (hc + bos_at(li - 1, c) + reduce_slices<KS_CHAIN>(red_r + e * SQ, RN, c)) * rho;
            h[e * SQ + col] = hc;
          }
          share<SMALL>(cluster, Xp + e * SQ, col, bf16r(hc) * rho, N);
        }
        if (li > 0)
          for (int i = spread(w_skip); i < np * SN; i += nt()) {
            const int e = i / SN, s = i % SN;
            float sk = skips[e * SQ + s] + bos_at(li - 1, RN + s)
                       + reduce_slices<KS_CHAIN>(red_s + e * SQ, SN, s);
            if (a.legacy && li - 1 > 0) sk *= SQRT_HALF;
            skips[e * SQ + s] = sk;
          }
        for (int i = spread(w_glu); i < np * hN; i += nt())
          glu_unit<SMALL>(cluster, consts + i / hN * SQ + li * CG, red_b + i / hN * SQ,
                          Xp + i / hN * SQ + R, i % hN, hN, n0, N);
        } else {
        for (int c = tid; c < RN; c += nt()) {
          const int col = r0 + c;
          float hc = h[col];
          if (li > 0) {
            hc = (hc + bos_at(li - 1, c) + reduce_slices<KS_CHAIN>(red_r, RN, c)) * rho;
            h[col] = hc;
          }
          share<SMALL>(cluster, Xp, col, bf16r(hc) * rho, N);
        }
        if (li > 0)
          for (int s = spread(w_skip); s < SN; s += nt()) {
            float sk = skips[s] + bos_at(li - 1, RN + s) + reduce_slices<KS_CHAIN>(red_s, SN, s);
            if (a.legacy && li - 1 > 0) sk *= SQRT_HALF;
            skips[s] = sk;
          }
        for (int c = spread(w_glu); c < hN; c += nt())
          glu_unit<SMALL>(cluster, consts + li * CG, red_b, Xp + R, c, hN, n0, N);
        }
        // this layer's slot is in (the barrier below shows it to every thread)
        if (a.wpre) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        PROF(P_LAYER_WORK);
        arrive();
        PROF(P_ARRIVE);
        wait();
        PROF(P_WAIT);
        if constexpr (SMALL) {
        write_ring_seqs(ring + ring_off[li], h, (base[li] + t) % win[li], R, r0, RN, np, RF, SQ);
        int first = 0;  // the jobs side by side, as below, np sequences each
        if (li + 1 < L) {
          first = job_run_seqs<float, U2>(gate_job(li + 1, Xp), 0, CG, KS_CHAIN, red_b, 0, np, SQ);
          first = job_run_seqs<float, U2>(os_job(li, false, Xp + R), 0, RN, KS_CHAIN, red_r, first,
                                      np, SQ);
        }
        job_run_seqs<float, U2>(os_job(li, true, Xp + R), 0, SN, KS_CHAIN, red_s, first, np, SQ);
        } else {
        write_ring(ring + ring_off[li], h, (base[li] + t) % win[li], R, r0, RN);

        int first = 0;  // the jobs side by side, each from its own threads
        if (li + 1 < L) {
          // gates of layer li+1: [rho bf16(h) | z] @ [w_cur[li+1] ; w_fused[li+1]], and
          // the residual 1x1 of layer li
          first = chain_run(gate_job(li + 1, Xp), 0, CG, red_b);
          first = chain_run(os_job(li, false, Xp + R), 0, RN, red_r, first);
        }
        // skip 1x1 of layer li
        chain_run(os_job(li, true, Xp + R), 0, SN, red_s, first);
        }
        __syncthreads();
        ++ws;
        PROF(P_MATVEC);
      }
    } else {
      // --- 3. the layer stack, plain chain: two exchanges a layer ---
      for (int li = 0; li < L; ++li) {
        float* Xp = X + ((li + 1) & 1) * XW;
        if (a.wpre) stage_slot(li + 1 < L ? li + 1 : 0, (ws + 1) & 1);
        if constexpr (SMALL) {
        for (int i = tid; i < np * RN; i += nt()) {
          const int e = i / RN, c = i % RN, col = r0 + c;
          float hc = h[e * SQ + col];
          if (li > 0) {
            hc = (bos_at(li - 1, c) + reduce_slices<KS_CHAIN>(red_r + e * SQ, RN, c) + hc) * rho;
            h[e * SQ + col] = hc;
          }
          share<SMALL>(cluster, Xp + e * SQ, col, bf16r(hc), N);
        }
        if (li > 0)
          for (int i = spread(w_skip); i < np * SN; i += nt()) {
            const int e = i / SN, s = i % SN;
            float sk = skips[e * SQ + s] + bos_at(li - 1, RN + s)
                       + reduce_slices<KS_CHAIN>(red_s + e * SQ, SN, s);
            if (a.legacy && li - 1 > 0) sk *= SQRT_HALF;
            skips[e * SQ + s] = sk;
          }
        } else {
        for (int c = tid; c < RN; c += nt()) {
          const int col = r0 + c;
          float hc = h[col];
          if (li > 0) {
            hc = (bos_at(li - 1, c) + reduce_slices<KS_CHAIN>(red_r, RN, c) + hc) * rho;
            h[col] = hc;
          }
          share<SMALL>(cluster, Xp, col, bf16r(hc), N);
        }
        if (li > 0)
          for (int s = spread(w_skip); s < SN; s += nt()) {
            float sk = skips[s] + bos_at(li - 1, RN + s) + reduce_slices<KS_CHAIN>(red_s, SN, s);
            if (a.legacy && li - 1 > 0) sk *= SQRT_HALF;
            skips[s] = sk;
          }
        }
        if (a.wpre) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        PROF(P_LAYER_WORK);
        arrive();
        PROF(P_ARRIVE);
        wait();
        PROF(P_WAIT);
        if constexpr (SMALL) {
        write_ring_seqs(ring + ring_off[li], h, (base[li] + t) % win[li], R, r0, RN, np, RF,
                        SQ);
        job_run_seqs<float, U2>(gate_job(li, Xp), 0, CG, KS_CHAIN, red_b, 0, np, SQ);
        __syncthreads();
        PROF(P_MATVEC);
        for (int i = tid; i < np * hN; i += nt())
          glu_unit<SMALL>(cluster, consts + i / hN * SQ + li * CG, red_b + i / hN * SQ,
                          Xp + i / hN * SQ + R, i % hN, hN, n0, N);
        } else {
        write_ring(ring + ring_off[li], h, (base[li] + t) % win[li], R, r0, RN);  // layer li's input
        // gates of layer li: bf16(h) @ w_cur[li]
        chain_run(gate_job(li, Xp), 0, CG, red_b);
        __syncthreads();
        PROF(P_MATVEC);
        for (int c = tid; c < hN; c += nt())
          glu_unit<SMALL>(cluster, consts + li * CG, red_b, Xp + R, c, hN, n0, N);
        }
        PROF(P_LAYER_WORK);
        arrive();
        PROF(P_ARRIVE);
        wait();
        PROF(P_WAIT);
        // residual and skip 1x1s of layer li: z @ w_os[li]; the last layer's skip only
        if constexpr (SMALL) {
        const int first = li + 1 < L ? job_run_seqs<float, U2>(os_job(li, false, Xp + R), 0, RN,
                                                           KS_CHAIN, red_r, 0, np, SQ) : 0;
        job_run_seqs<float, U2>(os_job(li, true, Xp + R), 0, SN, KS_CHAIN, red_s, first, np, SQ);
        } else {
        const int first = li + 1 < L ? chain_run(os_job(li, false, Xp + R), 0, RN, red_r) : 0;
        chain_run(os_job(li, true, Xp + R), 0, SN, red_s, first);
        }
        __syncthreads();
        ++ws;
        PROF(P_MATVEC);
      }
    }

    // --- 4. head: skip sum -> relu -> 1x1 -> relu (exchanged), then the last 1x1 ---
    if constexpr (SMALL) {
    for (int i = tid; i < np * SN; i += nt()) {
      const int e = i / SN, s = i % SN;
      float sk = skips[e * SQ + s] + bos_at(L - 1, RN + s)
                 + reduce_slices<KS_CHAIN>(red_s + e * SQ, SN, s);
      if (a.legacy && L > 1) sk *= SQRT_HALF;
      share<SMALL>(cluster, O + e * SQ, s0 + s, bf16r(fmaxf(sk, 0.f)), N);
    }
    } else {
    for (int s = tid; s < SN; s += nt()) {
      float sk = skips[s] + bos_at(L - 1, RN + s)
                 + reduce_slices<KS_CHAIN>(red_s, SN, s);
      if (a.legacy && L > 1) sk *= SQRT_HALF;
      share<SMALL>(cluster, O, s0 + s, bf16r(fmaxf(sk, 0.f)), N);
    }
    }
    barrier();
    PROF(P_HEAD_SKIP);
    if constexpr (SMALL) {
    job_run_seqs<float, U2>(job1(a.w_s1, S, S, O, 1, SN, 1, s0, 0), 0, SN, KS_CHAIN, red, 0, np,
                        SQ);
    __syncthreads();
    for (int i = tid; i < np * SN; i += nt()) {
      const int e = i / SN, s = i % SN;
      share<SMALL>(cluster, P + e * SQ, s0 + s,
                   fmaxf(bs1[s] + reduce_slices<KS_CHAIN>(red + e * SQ, SN, s), 0.f), N);
    }
    } else {
    job_run<float>(job1(a.w_s1, S, S, O, 1, SN, 1, s0, 0), 0, SN, KS_CHAIN, red);
    __syncthreads();
    for (int s = tid; s < SN; s += nt()) {
      const float v = fmaxf(bs1[s] + reduce_slices<KS_CHAIN>(red, SN, s), 0.f);
      // the big-vocab head's input is bf16
      share<SMALL>(cluster, P, s0 + s, HEAD == CATEGORICAL_BIG ? bf16r(v) : v, N);
    }
    }
    barrier();
    PROF(P_HEAD_S1);

    // --- 5. the sample: every CTA draws the same one (the big head: from its classes
    // and the others' partials); rank 0 writes the outputs ---
    const size_t bt = (size_t)b * a.T + t;
    const bool out0 = rank == 0;
    if constexpr (HEAD == GAUSSIAN) {
      if constexpr (SMALL) {
      const int e = tid / 32, lane = tid % 32;
      if (e < np) {  // one warp a sequence
        float p0 = 0.f, p1 = 0.f;
        for (int s = lane; s < S; s += 32) {
          p0 = fmaf(P[e * SQ + s], a.w_s2[2 * s], p0);
          p1 = fmaf(P[e * SQ + s], a.w_s2[2 * s + 1], p1);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          p0 += __shfl_xor_sync(0xffffffffu, p0, off);
          p1 += __shfl_xor_sync(0xffffffffu, p1, off);
        }
        if (lane == 0) {
          const size_t be = bt + (size_t)e * a.T;
          p0 += a.b_s2[0];
          p1 += a.b_s2[1];
          const float logs = fmaxf(p1, a.log_scale_min);
          const float x = fminf(fmaxf(p0 + expf(logs) * a.noise[be], -1.f), 1.f);
          if (out0) {
            a.audio[be] = x;
            if (a.params != nullptr) {
              a.params[2 * be] = p0;
              a.params[2 * be + 1] = p1;
            }
          }
          sample_s[e * SQ] = x;
        }
      }
      } else {
      if (tid < 32) {  // one warp
        float p0 = 0.f, p1 = 0.f;
        for (int s = tid; s < S; s += 32) {
          p0 = fmaf(P[s], a.w_s2[2 * s], p0);
          p1 = fmaf(P[s], a.w_s2[2 * s + 1], p1);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          p0 += __shfl_xor_sync(0xffffffffu, p0, off);
          p1 += __shfl_xor_sync(0xffffffffu, p1, off);
        }
        if (tid == 0) {
          p0 += a.b_s2[0];
          p1 += a.b_s2[1];
          const float logs = fmaxf(p1, a.log_scale_min);
          const float x = fminf(fmaxf(p0 + expf(logs) * a.noise[bt], -1.f), 1.f);
          if (out0) {
            a.audio[bt] = x;
            if (a.params != nullptr) {
              a.params[2 * bt] = p0;
              a.params[2 * bt + 1] = p1;
            }
          }
          sample_s[0] = x;
        }
      }
      }
    } else if constexpr (HEAD == MOL) {
      // MoL: the out_ch head outputs P @ w_s2 + b_s2 in f32, one warp per column, into red
      if constexpr (SMALL) {
      const int warp = tid / 32, lane = tid % 32, oc = a.out_ch, nr = oc / 3;
      for (int wj = warp; wj < np * oc; wj += nt() / 32) {
        const int e = wj / oc, j = wj % oc;
        float p = 0.f;
        for (int s = lane; s < S; s += 32) p = fmaf(P[e * SQ + s], a.w_s2[(size_t)s * oc + j], p);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) {
          p += a.b_s2[j];
          red[e * SQ + j] = p;
          if (out0 && a.params != nullptr) a.params[(bt + (size_t)e * a.T) * oc + j] = p;
        }
      }
      __syncthreads();
      if (lane == 0 && warp < np) {  // a warp's first thread a sequence, as above
        const float* lg = red + warp * SQ;
        const size_t be = bt + (size_t)warp * a.T;
        const float* nz = a.noise + be * (nr + 1);
        float kmax = lg[0] + nz[1];
        for (int i = 1; i < nr; ++i) kmax = fmaxf(kmax, lg[i] + nz[1 + i]);
        float count = 0.f;
        for (int i = 0; i < nr; ++i) count += lg[i] + nz[1 + i] >= kmax ? 1.f : 0.f;
        const float w = 1.f / count;
        float mean = 0.f, ls = 0.f;
        for (int i = 0; i < nr; ++i) {
          if (lg[i] + nz[1 + i] >= kmax) {
            mean += lg[nr + i] * w;
            ls += lg[2 * nr + i] * w;
          }
        }
        const float logs = fmaxf(ls, a.log_scale_min);
        const float x = fminf(fmaxf(mean + expf(logs) * nz[0], -1.f), 1.f);
        if (out0) a.audio[be] = x;
        sample_s[warp * SQ] = x;
      }
      } else {
      const int warp = tid / 32, lane = tid % 32, oc = a.out_ch, nr = oc / 3;
      for (int j = warp; j < oc; j += nt() / 32) {
        float p = 0.f;
        for (int s = lane; s < S; s += 32) p = fmaf(P[s], a.w_s2[(size_t)s * oc + j], p);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) {
          p += a.b_s2[j];
          red[j] = p;
          if (out0 && a.params != nullptr) a.params[bt * oc + j] = p;
        }
      }
      __syncthreads();
      if (tid == 0) {
        // the mixture of largest logit + Gumbel; tied mixtures each weigh 1/count
        const float* nz = a.noise + bt * (nr + 1);
        float kmax = red[0] + nz[1];
        for (int i = 1; i < nr; ++i) kmax = fmaxf(kmax, red[i] + nz[1 + i]);
        float count = 0.f;
        for (int i = 0; i < nr; ++i) count += red[i] + nz[1 + i] >= kmax ? 1.f : 0.f;
        const float w = 1.f / count;
        float mean = 0.f, ls = 0.f;
        for (int i = 0; i < nr; ++i) {
          if (red[i] + nz[1 + i] >= kmax) {
            mean += red[nr + i] * w;
            ls += red[2 * nr + i] * w;
          }
        }
        const float logs = fmaxf(ls, a.log_scale_min);
        const float x = fminf(fmaxf(mean + expf(logs) * nz[0], -1.f), 1.f);
        if (out0) a.audio[bt] = x;
        sample_s[0] = x;
      }
      }
    } else if constexpr (HEAD == CATEGORICAL) {
      // categorical: Q logits P @ w_s2 + b_s2 in f32, a class a thread in turn (the CTA
      // reads each row of the (S, Q) w_s2 coalesced); logit + Gumbel noise into red
      // (the logits themselves into red[Q + c], for the NLL)
      if constexpr (SMALL) {
      const int Q = a.out_ch;
      for (int i = tid; i < np * Q; i += nt()) {
        const int e = i / Q, c = i % Q;
        const size_t be = bt + (size_t)e * a.T;
        float p = 0.f;
        for (int s = 0; s < S; ++s) p = fmaf(P[e * SQ + s], a.w_s2[(size_t)s * Q + c], p);
        p += a.b_s2[c];
        if (out0 && a.params != nullptr) a.params[be * Q + c] = p;
        red[e * SQ + c] = p + a.noise[be * Q + c];
        if constexpr (NLL) red[e * SQ + Q + c] = p;
      }
      __syncthreads();
      // as below, warp e for sequence e: its scores at sc, its logits at sc + Q
      const int e = tid / 32, lane = tid % 32;
      const float* sc = red + e * SQ;
      const size_t be = bt + (size_t)e * a.T;
      if constexpr (NLL) {
        if (e < np) {
          float lm = -INFINITY, ls = 0.f;
          for (int c = lane; c < Q; c += 32) lse_merge(lm, ls, sc[Q + c], 1.f);
          warp_lse(lm, ls);
          if (lane == 0 && out0) a.nll[be] = lm + logf(ls) - sc[Q + a.y_eval[be]];
        }
      }
      if (e < np) {
        float m = -INFINITY;
        for (int j = lane; j < Q; j += 32) m = fmaxf(m, sc[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        int count = 0, first = Q;
        for (int j = lane; j < Q; j += 32) {
          if (sc[j] >= m) {
            ++count;
            first = min(first, j);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          count += __shfl_xor_sync(0xffffffffu, count, off);
          first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
        }
        if (lane == 0) {
          if (count == 0) first = 0;
          if (out0) a.audio[be] = (float)first;
          sample_s[e * SQ] = (float)first;
          sample_s[e * SQ + 1] = m;
          sample_s[e * SQ + 2] = (float)count;
        }
      }
      } else {
      const int Q = a.out_ch;
      for (int c = tid; c < Q; c += nt()) {
        float p = 0.f;
        for (int s = 0; s < S; ++s) p = fmaf(P[s], a.w_s2[(size_t)s * Q + c], p);
        p += a.b_s2[c];
        if (out0 && a.params != nullptr) a.params[bt * Q + c] = p;
        red[c] = p + a.noise[bt * Q + c];
        if constexpr (NLL) red[Q + c] = p;
      }
      __syncthreads();
      if constexpr (NLL) {
        // logsumexp(logits) - logits[y] (wavenet_ar.py:470-481), in one warp in class
        // order, whatever the CTA's threads
        if (tid < 32) {
          float lm = -INFINITY, ls = 0.f;
          for (int c = tid; c < Q; c += 32) lse_merge(lm, ls, red[Q + c], 1.f);
          warp_lse(lm, ls);
          if (tid == 0 && out0) a.nll[bt] = lm + logf(ls) - red[Q + a.y_eval[bt]];
        }
      }
      if (tid < 32) {  // one warp: the largest score, how many classes tie it, the first
        float m = -INFINITY;
        for (int j = tid; j < Q; j += 32) m = fmaxf(m, red[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        int count = 0, first = Q;
        for (int j = tid; j < Q; j += 32) {
          if (red[j] >= m) {
            ++count;
            first = min(first, j);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          count += __shfl_xor_sync(0xffffffffu, count, off);
          first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
        }
        if (tid == 0) {
          if (count == 0) first = 0;  // every score NaN: stay inside first_w
          if (out0) a.audio[bt] = (float)first;
          sample_s[0] = (float)first;
          sample_s[1] = m;
          sample_s[2] = (float)count;
        }
      }
      }
    } else {
      // big-vocab categorical: no score is stored. Classes go in blocks of 256 (32 groups
      // of 8, 16-byte loads of the bf16 w_s2); CTA r scores blocks [b0, b1), a warp a
      // block at a time, lane l its group 32 b + l. The NLL's log-sum-exp is merged
      // within each block (each lane over its classes in order, then a fixed shuffle
      // tree), the blocks' pairs shared into every CTA and merged in block order there:
      // the same sums whatever N and the CTA's threads are.
      const int Q = a.out_ch, ngrp = a.q_ld / 8, nblk = (ngrp + 31) / 32;
      const int b0 = rank * nblk / N, b1 = (rank + 1) * nblk / N;
      const int warp = tid / 32, lane = tid % 32;
      const unsigned long long t_abs = (unsigned long long)a.t_base + t;
      const __nv_bfloat16* w2 = reinterpret_cast<const __nv_bfloat16*>(a.w_s2);
      Best best = {-INFINITY, Q, 0};
      int y = -1;
      if constexpr (NLL) y = a.y_eval[bt];
      for (int blk = b0 + warp; blk < b1; blk += nt() / 32) {
        const int g = 32 * blk + lane;
        float lm = -INFINITY, ls = 0.f;
        if (g < ngrp) {  // the ragged last groups too
          float lg[8], sc[8];
          big_vocab_scores(a, w2, P, g, b, t_abs, lg, sc);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = g * 8 + i;
            if (c < Q) {
              if constexpr (NLL) {
                lse_merge(lm, ls, lg[i], 1.f);
                if (c == y) sample_s[3] = lg[i];
              }
              if (sc[i] > best.v) {
                best.v = sc[i];
                best.first = c;
                best.count = 1;
              } else if (sc[i] == best.v) {
                ++best.count;
              }
            }
          }
        }
        if constexpr (NLL) {
          warp_lse(lm, ls);
          if (lane == 0) {
            share<SMALL>(cluster, blk_lse, 2 * blk, lm, N);
            share<SMALL>(cluster, blk_lse, 2 * blk + 1, ls, N);
          }
        }
      }
      best = block_best(best, scr);
      if (tid == 0) {  // this CTA's partials into every CTA's merge row `rank`
        const bool has_y = NLL && y >= 256 * b0 && y < 256 * b1;
        const float part[5] = {best.v, __int_as_float(best.first), __int_as_float(best.count),
                               has_y ? sample_s[3] : 0.f, has_y ? 1.f : 0.f};
        for (int i = 0; i < 5; ++i) share<SMALL>(cluster, merge, rank * 8 + i, part[i], N);
      }
      barrier();
      if (tid < 32) {  // merged in rank and block order: the same in every CTA
        float m = -INFINITY, s = 0.f;
        if constexpr (NLL) {
          for (int q = tid; q < nblk; q += 32) lse_merge(m, s, blk_lse[2 * q], blk_lse[2 * q + 1]);
          warp_lse(m, s);
        }
        if (tid == 0) {
          Best all = {-INFINITY, Q, 0};
          float ly = 0.f;
          for (int q = 0; q < N; ++q) {
            const float* p = merge + q * 8;
            all = best_merge(all, Best{p[0], __float_as_int(p[1]), __float_as_int(p[2])});
            if (p[4] != 0.f) ly = p[3];
          }
          if (all.count == 0) all.first = 0;  // every score NaN: stay inside first_w
          if (out0) {
            a.audio[bt] = (float)all.first;
            if constexpr (NLL) a.nll[bt] = m + logf(s) - ly;
          }
          sample_s[0] = (float)all.first;
          sample_s[1] = all.v;
          sample_s[2] = (float)all.count;
        }
      }
    }
    __syncthreads();
    PROF(P_SAMPLE);

    // --- 6. feedback through the first 1x1 conv, the whole h in every CTA ---
    if constexpr (HEAD == CATEGORICAL) {
      // bf16(one-hot / count) @ bf16(first_w) + first_b over the classes that tie the
      // maximum (wavenet_ar.py:441-448); one class, as good as always: its bf16 row
      if constexpr (SMALL) {
      for (int i = tid; i < np * R; i += nt()) {
        const int e = i / R, r = i % R;
        const float* ss = sample_s + e * SQ;
        const float m = ss[1], count = ss[2];
        float acc;
        if (count == 1.f) {  // the id's bf16 row
          acc = bf16r(a.first_w[(size_t)ss[0] * R + r]);
        } else {
          const float w = bf16r(1.f / count);
          acc = 0.f;
          for (int j = 0; j < a.out_ch; ++j)
            if (red[e * SQ + j] >= m) acc = fmaf(w, bf16r(a.first_w[(size_t)j * R + r]), acc);
        }
        h[e * SQ + r] = acc + a.first_b[r];
      }
      } else {
      const int id = (int)sample_s[0];
      const float m = sample_s[1], count = sample_s[2];
      for (int r = tid; r < R; r += nt()) {
        float acc;
        if (count == 1.f) {
          acc = bf16r(a.first_w[(size_t)id * R + r]);
        } else {
          const float w = bf16r(1.f / count);
          acc = 0.f;
          for (int j = 0; j < a.out_ch; ++j)
            if (red[j] >= m) acc = fmaf(w, bf16r(a.first_w[(size_t)j * R + r]), acc);
        }
        h[r] = acc + a.first_b[r];
      }
      }
    } else if constexpr (HEAD == CATEGORICAL_BIG) {
      // the same feedback from the bf16 first_w; on a tie (rare, and seen alike by every
      // CTA) a second pass marks each CTA's tied classes in a bit mask over red, shared
      // into every CTA, and the tied rows add up in class order
      const int Q = a.out_ch, id = (int)sample_s[0];
      const float m = sample_s[1], count = sample_s[2];
      const __nv_bfloat16* fw = reinterpret_cast<const __nv_bfloat16*>(a.first_w);
      unsigned int* tied = reinterpret_cast<unsigned int*>(red);
      const int words = (Q + 31) / 32, nw = (a.q_ld + 31) / 32;
      if (count > 1.f) {
        const int nblk = (a.q_ld / 8 + 31) / 32;
        const int w0 = 8 * (rank * nblk / N), w1 = min(8 * ((rank + 1) * nblk / N), nw);
        const int g0 = 4 * w0, g1 = min(4 * w1, a.q_ld / 8);
        for (int i = w0 + tid; i < w1; i += nt()) tied[i] = 0u;
        __syncthreads();
        const __nv_bfloat16* w2 = reinterpret_cast<const __nv_bfloat16*>(a.w_s2);
        for (int g = g0 + tid; g < g1; g += nt()) {
          float lg[8], sc[8];
          big_vocab_scores(a, w2, P, g, b, (unsigned long long)a.t_base + t, lg, sc);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = g * 8 + i;
            if (c < Q && sc[i] >= m) atomicOr(&tied[c / 32], 1u << (c % 32));
          }
        }
        __syncthreads();
        for (int i = w0 + tid; i < w1; i += nt())
          share<SMALL>(cluster, red, i, __uint_as_float(tied[i]), N);
        barrier();
      }
      for (int r = tid; r < R; r += nt()) {
        float acc;
        if (count <= 1.f) {
          acc = __bfloat162float(fw[(size_t)id * R + r]);
        } else {
          const float w = bf16r(1.f / count);
          acc = 0.f;
          for (int i = 0; i < words; ++i) {
            for (unsigned int bits = tied[i]; bits != 0u; bits &= bits - 1u) {
              const int j = i * 32 + __ffs(bits) - 1;
              acc = fmaf(w, __bfloat162float(fw[(size_t)j * R + r]), acc);
            }
          }
        }
        h[r] = acc + a.first_b[r];
      }
    } else {
      if constexpr (SMALL) {
      for (int i = tid; i < np * R; i += nt())
        h[i / R * SQ + i % R] = fmaf(sample_s[i / R * SQ], a.first_w[i % R], a.first_b[i % R]);
      } else {
      const float x = sample_s[0];
      for (int r = tid; r < R; r += nt()) h[r] = fmaf(x, a.first_w[r], a.first_b[r]);
      }
    }
    __syncthreads();
    PROF(P_FEEDBACK);
  }
  if (a.wpre) asm volatile("cp.async.wait_all;\n" ::: "memory");  // the unused last slot
  if (a.h_out != nullptr && rank == 0)
    if constexpr (SMALL) {
    for (int i = tid; i < np * R; i += nt()) a.h_out[(size_t)b * R + i] = h[i / R * SQ + i % R];
    } else {
    for (int r = tid; r < R; r += nt()) a.h_out[(size_t)b * R + r] = h[r];
    }
  barrier();  // no CTA leaves while a peer may still write its shared memory
}

constexpr size_t SMEM_MAX = 232448;  // a CTA's shared memory on Hopper (227 KB)

size_t smem_bytes(int cin, int L, int R, int G, int S, int k, int N, bool wpre) {
  const size_t floats = (size_t)L * G / N + (size_t)L * (k - 1) * R / 2 + cin + R
                        + 2 * ((size_t)R + G / 2) + S / N + 2 * (size_t)S
                        + (N > 1 ? (size_t)L * (R / N + S / N) : 0) + S / N + 8
                        + MAX_CLUSTER * 8 + 512 + 96 + 3 * (size_t)L
                        + red_floats(R, G, S, N);
  const size_t slots = wpre ? 2 * ((size_t)(R + G / 2) * (G / N) + (G / 2) * (R / N + S / N))
                            : 0;  // bf16, after up to 12 bytes that align them to 16
  return floats * sizeof(float) + (wpre ? 16 + slots * 2 : 0);
}

// Whether a cluster of N stages the chain's weights a layer ahead (wpre): where each
// CTA's slice is whole 16-byte rows and two slices fit beside the rest.
bool prefetches(int cin, int L, int R, int G, int S, int k, int N) {
  return (G / 2 / N) % 8 == 0 && (R / N) % 8 == 0 && (S / N) % 8 == 0
         && smem_bytes(cin, L, R, G, S, k, N, true) <= SMEM_MAX;
}

// What a launch asks for: at least 117 KB, so that no two CTAs share an SM (the design
// gives each CTA an SM's load slots and L2 bandwidth; clusters then count SMs). The SMALL
// layout (`small`) never stages the chain's weights and runs NQ sequences a cluster: NQ
// copies of its per-sequence floats.
size_t launch_smem_bytes(int cin, int L, int R, int G, int S, int k, int N, int NQ,
                         bool small) {
  const size_t bytes =
      small ? NQ * smem_bytes(cin, L, R, G, S, k, N, false)
            : smem_bytes(cin, L, R, G, S, k, N, prefetches(cin, L, R, G, S, k, N));
  return bytes > 117 * 1024 ? bytes : 117 * 1024;
}

// Whether a cluster of N runs the SMALL layout: one or two CTAs a sequence at the
// defaults' widths (R, G, S) = (128, 256, 128), with any head but the big one. That is
// where it was measured faster (probes/ar_split.py, an H100 SXM at 700 W, B=66 and 132,
// us a step against 1,024 threads): the Gaussian head on either chain, MoL and the small
// categorical head with and without the NLL 16-26% faster (B=132: 209.7 against 243.3);
// the big head with the NLL slower (B=132: 577.3 against 488.9-493.5), its class scan on
// half the threads; the paper width, N = 1 and 2, slower on 512 threads.
bool small_layout(int head, int R, int G, int S, int N) {
  return N <= 2 && head != CATEGORICAL_BIG && R == 128 && G == 256 && S == 128;
}

// Whether a cluster of N may run two sequences: N = 2 in the SMALL layout, where the
// chain's weights are not staged (cluster_layout in ops/wavenet_ar.py picks it).
bool pairs(int cin, int L, int R, int G, int S, int k, int head, int N) {
  return N == 2 && small_layout(head, R, G, S, N) && !prefetches(cin, L, R, G, S, k, N);
}

// threads a CTA on a cluster of N: 512 in the SMALL layout, else 1,024 for one or two
// CTAs a sequence, 512 for four, 256 for eight or sixteen; the outputs do not depend on it
int threads_for(bool small, int N) {
  return small ? SMALL_NT : N <= 2 ? 1024 : N == 4 ? 512 : 256;
}

// whether a cluster of N CTAs can split these widths (every CTA an equal, nonempty
// slice of the gate pairs, residual and skip columns)
bool splits(int R, int G, int S, int N) {
  return N >= 1 && N <= MAX_CLUSTER && (G / 2) % N == 0 && R % N == 0 && S % N == 0;
}

template <int HEAD, int CHAIN, bool NLL, bool SMALL>
cudaError_t configure(int N, size_t smem) {
  auto kern = wavenet_ar_kernel<HEAD, CHAIN, NLL, SMALL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && N > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// the launch configuration of B clusters of N CTAs (attr: its one attribute)
cudaLaunchConfig_t cluster_config(int B, int N, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * N);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = N;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int HEAD, int CHAIN, bool NLL, bool SMALL>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = launch_smem_bytes(a.cin, a.L, a.R, a.G, a.S, a.k, a.N, a.NQ, SMALL);
  cudaError_t err = configure<HEAD, CHAIN, NLL, SMALL>(a.N, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;  // a cluster every NQ sequences
  const cudaLaunchConfig_t cfg = cluster_config((B + a.NQ - 1) / a.NQ, a.N,
                                                threads_for(SMALL, a.N), smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, wavenet_ar_kernel<HEAD, CHAIN, NLL, SMALL>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of N CTAs the card keeps resident at once (0: none fits)
template <int HEAD, int CHAIN, bool NLL, bool SMALL>
int occupancy(int N, int threads, size_t smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, N, threads, smem, nullptr, &attr);
  int clusters = 0;
  if (configure<HEAD, CHAIN, NLL, SMALL>(N, smem) != cudaSuccess
      || cudaOccupancyMaxActiveClusters(&clusters,
                                        wavenet_ar_kernel<HEAD, CHAIN, NLL, SMALL>, &cfg)
             != cudaSuccess) {
    cudaGetLastError();  // clear the refusal: the caller reads 0
    return 0;
  }
  return clusters;
}

// the instantiation of (head, fused, nll, small), handed to F as template arguments;
// the big head has no SMALL one (small_layout)
template <template <int, int, bool, bool> class F, typename... T>
int dispatch(int head, bool fused, bool nll, bool small, T... args) {
#define T2_CHAIN(H, NL)                                                          \
  return fused ? (small ? F<H, FUSED, NL, true>::run(args...)                   \
                        : F<H, FUSED, NL, false>::run(args...))                 \
               : (small ? F<H, PLAIN, NL, true>::run(args...)                   \
                        : F<H, PLAIN, NL, false>::run(args...))
#define T2_GENERAL(H, NL)                                                        \
  return fused ? F<H, FUSED, NL, false>::run(args...) : F<H, PLAIN, NL, false>::run(args...)
  switch (head) {
    case GAUSSIAN: T2_CHAIN(GAUSSIAN, false);
    case MOL: T2_CHAIN(MOL, false);
    case CATEGORICAL:
      if (nll) T2_CHAIN(CATEGORICAL, true);
      T2_CHAIN(CATEGORICAL, false);
    default:
      if (nll) T2_GENERAL(CATEGORICAL_BIG, true);
      T2_GENERAL(CATEGORICAL_BIG, false);
  }
#undef T2_GENERAL
#undef T2_CHAIN
}

template <int H, int C, bool NL, bool SM>
struct Launch {
  static int run(const Args& a, int B, cudaStream_t s) { return launch<H, C, NL, SM>(a, B, s); }
};

template <int H, int C, bool NL, bool SM>
struct Occupancy {
  static int run(int N, int threads, size_t smem) {
    return occupancy<H, C, NL, SM>(N, threads, smem);
  }
};

}  // namespace

#ifdef T2_PROFILE
// the split's P_SLOTS sums (ns) into out, then zeroed
extern "C" int wavenet_ar_profile(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err == cudaSuccess) {
    const unsigned long long zero[P_SLOTS] = {};
    err = cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));
  }
  return (int)err;
}
#endif

// Clusters of N = 1, 2, 4, 8, 16 CTAs that the card keeps resident at once for the
// instantiation (head, fused, nll) at these widths, into occ[0..4], and clusters of 2
// running two sequences each (at their shared-memory size) into occ[5]; 0 where N does
// not split the widths, two sequences are not admitted (pairs) or the shared memory
// does not fit (a refusal reads as 0). Returns 0.
extern "C" int wavenet_ar_occupancy(int cin, int L, int R, int G, int S, int k, int head,
                                    int fused, int nll, int* occ) {
  for (int i = 0; i < 6; ++i) {
    const int N = i < 5 ? 1 << i : 2, NQ = i < 5 ? 1 : 2;
    const bool ok = splits(R, G, S, N) && (NQ == 1 || pairs(cin, L, R, G, S, k, head, N));
    occ[i] = ok ? dispatch<Occupancy>(head, fused != 0, nll != 0,
                                      small_layout(head, R, G, S, N), N,
                                      threads_for(small_layout(head, R, G, S, N), N),
                                      launch_smem_bytes(cin, L, R, G, S, k, N, NQ,
                                                        small_layout(head, R, G, S, N)))
                : 0;
  }
  return 0;
}

// Plain C entry point (loaded with ctypes). All pointers are device pointers; the
// launch goes on `stream`. `head` (0 Gaussian, out_ch == 2; 1 MoL, out_ch == 3*nr; 2
// categorical, out_ch classes, at most one a thread; 3 big-vocab categorical, out_ch
// <= 65,536 classes, bf16 first_w and w_s2 of q_ld columns, noise from `seed` or
// `greedy`, no params) and `fused` (the fused critical path, or the plain chain, which
// takes null w_fused and b_fused) pick the instantiation; g_cond may be null. y_eval
// and nll, given together and only to a categorical head without params, ask for the
// in-kernel NLL. `cluster`: the CTAs a cluster (1, 2, 4, 8 or 16; it must split G/2,
// R and S); `sequences`: the sequences a cluster, 1, or 2 where `pairs` admits it.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int wavenet_ar(
    const void* c_up, const void* noise, const void* first_w, const void* first_b,
    const void* w_tap, const void* b_tap, const void* w_os, const void* b_os,
    const void* w_fused, const void* b_fused, const void* w_cond, const void* b_cond,
    const void* w_s1, const void* b_s1, const void* w_s2, const void* b_s2,
    const void* g_cond, void* rings, const void* h_in, void* h_out, void* audio, void* params,
    const void* y_eval, void* nll, long long ring_floats, long long t_base,
    unsigned long long seed, int B, int T, int cin, int L,
    int layers_per_stack, int R, int G, int S, int k, int out_ch, int head, int fused,
    int legacy, int residual_legacy, int round_cond, int q_ld, int greedy, int cluster,
    int sequences, float log_scale_min, void* stream) {
  const bool head_ok =
      head == GAUSSIAN      ? out_ch == 2
      : head == MOL         ? out_ch >= 3 && out_ch % 3 == 0
      : head == CATEGORICAL ? out_ch >= 2 && out_ch <= NT_MAX
                            : head == CATEGORICAL_BIG && out_ch >= 2 && out_ch <= 65536
                                  && q_ld >= out_ch && q_ld % 8 == 0
                                  && (q_ld + 31) / 32 <= red_floats(R, G, S, cluster)
                                  && params == nullptr;
  const bool nll_ok = (y_eval == nullptr) == (nll == nullptr)
                      && (nll == nullptr || ((head == CATEGORICAL || head == CATEGORICAL_BIG)
                                             && params == nullptr));
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  const bool nq_ok = sequences == 1
                     || (sequences == 2 && pairs(cin, L, R, G, S, k, head, cluster));
  if (!nll_ok || !pow2 || !nq_ok || !splits(R, G, S, cluster) || B <= 0 || T <= 0 || cin <= 0
      || L <= 0 || layers_per_stack <= 0 || k < 2 || G % 8 != 0 || R % 8 != 0
      || S % 8 != 0 || t_base < 0 || !head_ok
      || (fused && (w_fused == nullptr || b_fused == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.c_up = static_cast<const float*>(c_up);
  a.noise = static_cast<const float*>(noise);
  a.first_w = static_cast<const float*>(first_w);
  a.first_b = static_cast<const float*>(first_b);
  a.w_tap = static_cast<const __nv_bfloat16*>(w_tap);
  a.b_tap = static_cast<const float*>(b_tap);
  a.w_os = static_cast<const __nv_bfloat16*>(w_os);
  a.b_os = static_cast<const float*>(b_os);
  a.w_fused = static_cast<const __nv_bfloat16*>(w_fused);
  a.b_fused = static_cast<const float*>(b_fused);
  a.w_cond = static_cast<const __nv_bfloat16*>(w_cond);
  a.b_cond = static_cast<const float*>(b_cond);
  a.w_s1 = static_cast<const __nv_bfloat16*>(w_s1);
  a.b_s1 = static_cast<const float*>(b_s1);
  a.w_s2 = static_cast<const float*>(w_s2);
  a.b_s2 = static_cast<const float*>(b_s2);
  a.g_cond = static_cast<const float*>(g_cond);
  a.rings = static_cast<float*>(rings);
  a.h_in = static_cast<const float*>(h_in);
  a.h_out = static_cast<float*>(h_out);
  a.audio = static_cast<float*>(audio);
  a.params = static_cast<float*>(params);
  a.y_eval = static_cast<const int*>(y_eval);
  a.nll = static_cast<float*>(nll);
  a.seed_lo = (unsigned int)seed;
  a.seed_hi = (unsigned int)(seed >> 32);
  a.q_ld = q_ld;
  a.greedy = greedy;
  a.ring_floats = ring_floats;
  a.t_base = t_base;
  a.T = T; a.cin = cin; a.L = L; a.lps = layers_per_stack; a.R = R; a.G = G; a.S = S;
  a.k = k; a.out_ch = out_ch; a.legacy = legacy; a.residual_legacy = residual_legacy;
  a.round_cond = round_cond;
  a.N = cluster;
  a.wpre = prefetches(cin, L, R, G, S, k, cluster);
  a.log_scale_min = log_scale_min;
  a.NQ = sequences;
  a.B = B;
  return dispatch<Launch>(head, fused != 0, y_eval != nullptr,
                          small_layout(head, R, G, S, cluster), a, B,
                          static_cast<cudaStream_t>(stream));
}
