// WaveNet autoregressive generation on Hopper: the whole sample loop in one launch.
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
// Design. One thread block per sequence (grid = B), NT = 1024 threads. Blocks never talk
// to each other. Each block runs all T steps; per step, with __syncthreads() between
// dependent stages and f32 accumulation:
//   1. the conditioning row  bf16(c_t) @ w_cond + b_cond (+ g_cond[b], the speaker's
//      bias, wavenet_ar.py:299-300, 314-315),  rounded to bf16 where the TPU kernel keeps
//      a bf16 per-chunk slab (padded batch <= 16 rows; the wrapper passes round_cond)
//      and f32 where it does not; g_cond joins before that rounding, as it does there;
//   2. per layer l: consts = b_tap + b_fused + cond_l + bf16(past taps) @ w_tap[l][:past];
//   3. the fused chain  z_l = GLU(z_{l-1} @ w_fused[l] + sqrt(1/2) h_{l-1} @ w_cur[l]
//      + consts)  with the residual/skip 1x1 of layer l-1 computed beside it;
//      The plain chain (wavenet_ar.py:342-361) runs instead, per layer,
//      z_l = GLU([bf16 taps | bf16 h] @ w_tap[l] + b_tap + cond_l), then
//      bf16(z_l) @ w_os[l] + b_os for the residual and the skip: two dependent matvecs
//      and four barriers a layer where the fused chain has one and two; it reads no
//      w_fused. The layer's input h goes into its ring after its taps were read.
//      Measured on an H100 SXM (700 W) at the default sizes, B=2: 185.4 us/step with
//      the Gaussian head against 179.4-180.2 for the fused chain, but 179.7 against
//      184.2 with the categorical head: the chains differ by less than the
//      instantiations do, since the fused chain trades its barriers for G/2 more
//      weight rows a layer;
//   4. the head  relu -> 1x1 -> relu -> 1x1 (the last 1x1 in f32);
//   5. the sample: Gaussian  clip(mean + exp(max(logs, log_scale_min)) * eps, -1, 1);
//      MoL (wavenet_ar.py:455-464)  the mixture of largest logit + Gumbel noise, ties
//      averaged, then clip(mean + exp(max(logs, log_scale_min)) * logistic, -1, 1);
//      categorical (wavenet_ar.py:425-448)  the class of largest logit + Gumbel noise,
//      the first on ties, written as a float;
//   6. the feedback  h = sample * first_w + first_b;  categorical: the bf16-rounded row
//      first_w[class] + first_b (each of c tied classes weighs bf16(1/c)); a fresh
//      categorical call starts from the f32 row of class Q/2 (silence).
// The big-vocab head. Q logits of 4 bytes do not fit a block's shared memory at
// Q = 65,536, so no score is stored: a thread walks groups of 8 neighbouring classes
// (16-byte loads of the bf16 (S, Q) w_s2, consecutive threads on consecutive groups, so
// a warp reads 512 contiguous bytes of each row), keeps a running (largest score, its
// first class, how many classes tie it) and, for the NLL, a running (max, scaled sum) of
// the un-noised logits; the block then reduces both. Only when more than one class ties
// the maximum does a second pass recompute the scores (logits and noise are functions
// of the step alone) to mark the tied classes in a bit mask, whose bf16 first-conv rows
// are averaged in class order. The head's input is rounded to bf16 (wavenet_ar.py:414)
// and a fresh call starts from the bf16 first-conv row of class Q/2. w_s2 has q_ld >= Q
// columns, a multiple of 8 (the wrapper pads with zeros), so every row starts on a
// 16-byte boundary whatever Q is. At Q = 65,536 and S = 128 the head reads 16.8 MB a
// step (inside the L2 with the 7.4 MB of layer weights) and does 8.4 M multiply-adds.
// The noise. Philox4x32-10 written out below: key = the wrapper's 64-bit seed, counter
// = (class / 4, absolute step t_base + t (64 bits), sequence); word class % 4 of the
// output gives 23 mantissa bits, u = bits as a float in [1, 2) minus 1, and the Gumbel
// value -log(-log(u + 1e-9) + 1e-9) in f32 (the TPU kernel's transform,
// wavenet_ar.py:433-440). The absolute step in the counter makes a state-carried
// stream that keeps its seed bit-identical to one call, and lets the plain PyTorch
// version compute the same bits.
// The activations that feed a matmul are rounded to bf16 at the same places the TPU
// kernel casts them, so the plain PyTorch version (ops/wavenet_ar.py
// generate_ar_reference) and this kernel compute the same function.
//
// Where the data lives. The packed weights (bf16, 3.70 M values = 7.4 MB at the default
// L=20, R=128, G=256, S=128) stay in global memory, which the 50 MB L2 holds across
// steps. The per-layer ring buffers ((k-1)*dilation slots of R floats, 523,776 floats =
// 2.1 MB per sequence) are an f32 scratch tensor the wrapper allocates. h, z, the skip
// sum, the conditioning row and the matmul partial sums live in shared memory (~90 KB).
//
// What bounds it. Every step reads all 7.4 MB of weights once per block and does about
// 3.7 M multiply-adds, so a step is bound by the L2 -> SM bandwidth of the one SM that
// runs the sequence (shared memory holds about 3% of the weights). The design answers
// with wide loads and many of them in flight: a warp reads a full 512-byte weight row as
// 16-byte vectors (8 bf16 columns per thread), and the 32 warps split the rows of each
// matmul between them; partial sums meet in shared memory. Measured on an H100 SXM
// (700 W): one SM streams about 239 GB/s from L2, a floor of ~31 us/step for this
// traffic, while a step takes ~178 us: the loads of each layer are drained at its
// barriers, so load latency, not bandwidth, sets the pace of this first design.
// Sharing weight reads across sequences (tensor-core mma over batched rows), clusters
// with distributed shared memory, and fp8 weights are left for later work.
//
// At the paper profile's widths (L=24 in 4 stacks, R=256, G=512, S=256, MoL-30) the
// same design holds: 16.78 M bf16 weight values (33.6 MB, inside the 50 MB L2), 64
// column groups and 16 row slices per G-wide matvec, so a thread walks 64 weight rows
// per layer where it walks 16 at the defaults, and 122 KB of shared memory. The MoL
// head adds 30 f32 columns of S, one warp per column, and the choice of mixture in
// one thread: small next to the layer stack.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 1024 threads: measured on an H100 SXM (700 W), 179 us/step at the default sizes
// against 223 us with 512 threads and 356 us with 256; unrolling further did not help.
constexpr int NT = 1024;  // threads per block
constexpr int UNROLL = 4;  // weight loads in flight per thread and row slice
constexpr int COLS = 8;   // bf16 columns per 16-byte load
constexpr int RED = NT * COLS;  // floats in one partial-sum buffer
constexpr float SQRT_HALF = 0.70710678118654752f;
// out_channels == 2; 3*nr; Q <= NT classes; Q classes, noise drawn in the kernel
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
  float log_scale_min;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void fma8(float acc[COLS], float a, uint4 w) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    acc[2 * i] = fmaf(a, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(a, f.y, acc[2 * i + 1]);
  }
}

// One operand of a block matvec: rows [0, rows) of a bf16 matrix with leading
// dimension ld, times act[0, rows) from shared memory.
struct Seg {
  const __nv_bfloat16* w;
  int ld;
  int rows;
  const float* act;
};

// Partial sums of out[n] = sum over segments of act . W[:, n], n in [0, N).
// Thread tid owns column group g = tid % (N/8) and row slice ks = tid / (N/8)
// (rows ks, ks + KS, ...), KS = NT / (N/8); it writes red[ks*N + 8g .. 8g+7].
// The caller synchronises and sums the KS slices. Needs N % 8 == 0, NT % (N/8) == 0.
__device__ __forceinline__ void matvec_partial(const Seg* segs, int nseg, int N,
                                               float* red) {
  const int ng = N / COLS;
  const int ks_n = NT / ng;
  const int g = threadIdx.x % ng;
  const int ks = threadIdx.x / ng;
  float acc[COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) acc[i] = 0.f;
  for (int s = 0; s < nseg; ++s) {
    const __nv_bfloat16* w = segs[s].w + g * COLS;
    const size_t ld = segs[s].ld;
    const float* act = segs[s].act;
    const int rows = segs[s].rows;
#pragma unroll UNROLL
    for (int r = ks; r < rows; r += ks_n) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w + r * ld));
      fma8(acc, act[r], wv);
    }
  }
  float* out = red + ks * N + g * COLS;
#pragma unroll
  for (int i = 0; i < COLS; ++i) out[i] = acc[i];
}

__device__ __forceinline__ float reduce_slices(const float* red, int N, int n) {
  const int ks_n = NT / (N / COLS);
  float s = 0.f;
  for (int ks = 0; ks < ks_n; ++ks) s += red[ks * N + n];
  return s;
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
                                                 float lg[COLS], float sc[COLS]) {
  const size_t ld = a.q_ld;
  const __nv_bfloat16* w = w2 + (size_t)g * COLS;
#pragma unroll
  for (int i = 0; i < COLS; ++i) lg[i] = 0.f;
#pragma unroll UNROLL
  for (int s = 0; s < a.S; ++s)
    fma8(lg, o[s], __ldg(reinterpret_cast<const uint4*>(w + s * ld)));
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const int c = g * COLS + i;
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

// The largest score a thread (then the block) has seen, its lowest class, and how many
// classes tie it.
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

// Block-wide best_merge; every thread calls, thread 0 gets the result. scratch: 96
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
    x.v = scratch[lane];
    x.first = si[32 + lane];
    x.count = si[64 + lane];
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

// Block-wide log-sum-exp of the threads' partial (m, s); every thread calls, thread 0
// gets max + log(sum). scratch: 64 floats of shared memory.
__device__ __forceinline__ float block_lse(float m, float s, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_lse(m, s);
  if (lane == 0) {
    scratch[warp] = m;
    scratch[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = scratch[lane];
    s = scratch[32 + lane];
    warp_lse(m, s);
  }
  return m + logf(s);
}

template <int HEAD, int CHAIN, bool NLL>
__global__ void __launch_bounds__(NT) wavenet_ar_kernel(Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int R = a.R, G = a.G, S = a.S, L = a.L, k = a.k, cin = a.cin;
  const int half = G / 2, past = (k - 1) * R, LG = L * G, RS = R + S;
  const float rho = a.residual_legacy ? SQRT_HALF : 1.f;

  float* cond = smem;                   // (L*G)  bf16-rounded conditioning row
  float* act = cond + LG;               // [taps (past) | h (R) | z (G/2)], bf16-rounded
  float* taps = act;
  float* hb = act + past;
  float* zb = act + past + R;
  float* red_a = act + past + R + half;  // residual/skip and head partial sums
  float* red_b = red_a + RED;            // gate partial sums
  float* h = red_b + RED;                // (R) f32 input of the current layer
  float* skips = h + R;                  // (S)
  float* xc = skips + S;                 // (cin) bf16-rounded c_t
  float* o = xc + cin;                   // (S)
  float* sample_s = o + S;  // (4) the sample; categorical: id, max, ties, logit[y_eval]
  int* ring_off = reinterpret_cast<int*>(sample_s + 4);  // (L) float offsets
  int* win = ring_off + L;                                // (L) slots per ring
  int* base = win + L;  // (L) t_base mod win: local step t uses slot (base + t) mod win

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
  if (a.h_in == nullptr) {
    for (long long i = tid; i < a.ring_floats; i += NT) ring[i] = 0.f;
    for (int r = tid; r < R; r += NT) {
      if constexpr (HEAD == CATEGORICAL)  // silence: the f32 row of class Q/2
        h[r] = a.first_w[(size_t)(a.out_ch / 2) * R + r] + a.first_b[r];
      else if constexpr (HEAD == CATEGORICAL_BIG)  // ... read from the bf16 first_w
        h[r] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                   a.first_w)[(size_t)(a.out_ch / 2) * R + r]) + a.first_b[r];
      else
        h[r] = a.first_b[r];
    }
  } else {
    for (int r = tid; r < R; r += NT) h[r] = a.h_in[(size_t)b * R + r];
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    // --- the step's inputs: c_t, layer 0's taps and input, a cleared skip sum ---
    const float* ct = a.c_up + ((size_t)b * a.T + t) * cin;
    for (int i = tid; i < cin; i += NT) xc[i] = bf16r(ct[i]);
    for (int i = tid; i < past; i += NT) {
      const int j = i / R, r = i % R;
      const int w0 = win[0], m = (k - 1 - j) * (w0 / (k - 1));
      taps[i] = bf16r(ring[ring_off[0] + ((base[0] + t + w0 - m) % w0) * R + r]);
    }
    for (int r = tid; r < R; r += NT) hb[r] = bf16r(h[r]);
    for (int s = tid; s < S; s += NT) skips[s] = 0.f;
    __syncthreads();

    // --- 1. conditioning row for every layer: (cin) @ (cin, L*G) ---
    for (int g = tid; g < LG / COLS; g += NT) {
      float acc[COLS];
#pragma unroll
      for (int q = 0; q < COLS; ++q) acc[q] = 0.f;
      const __nv_bfloat16* w = a.w_cond + g * COLS;
#pragma unroll UNROLL
      for (int i = 0; i < cin; ++i)
        fma8(acc, xc[i], __ldg(reinterpret_cast<const uint4*>(w + (size_t)i * LG)));
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        float v = acc[q] + a.b_cond[g * COLS + q];
        if (a.g_cond != nullptr) v += a.g_cond[(size_t)b * LG + g * COLS + q];
        cond[g * COLS + q] = a.round_cond ? bf16r(v) : v;
      }
    }
    __syncthreads();

    if constexpr (CHAIN == FUSED) {
      // --- layer 0 gates: [taps | h] @ w_tap[0] ---
      {
        Seg segs[1] = {{a.w_tap, G, past + R, act}};
        matvec_partial(segs, 1, G, red_b);
      }
      __syncthreads();

      // --- 2-3. the layer stack ---
      for (int li = 0; li < L; ++li) {
        // residual and skip outputs of layer li-1 (partials in red_a); h becomes the
        // input of layer li and goes into its ring (its taps were staged already)
        const int slot = (base[li] + t) % win[li];
        for (int c = tid; c < RS; c += NT) {
          if (c < R) {
            float hc = h[c];
            if (li > 0) {
              hc = (hc + a.b_os[(li - 1) * RS + c] + reduce_slices(red_a, RS, c)) * rho;
              h[c] = hc;
            }
            ring[ring_off[li] + slot * R + c] = hc;
            hb[c] = bf16r(hc) * rho;  // h term of layer li+1's fused gates
          } else if (li > 0) {
            const int s = c - R;
            float sk = skips[s] + a.b_os[(li - 1) * RS + c] + reduce_slices(red_a, RS, c);
            if (a.legacy && li - 1 > 0) sk *= SQRT_HALF;
            skips[s] = sk;
          }
        }
        // GLU of layer li (gate partials in red_b)
        for (int n = tid; n < half; n += NT) {
          const int base = li * G;
          const float za = a.b_tap[base + n] + a.b_fused[base + n] + cond[base + n]
                           + reduce_slices(red_b, G, n);
          const float zg = a.b_tap[base + n + half] + a.b_fused[base + n + half]
                           + cond[base + n + half] + reduce_slices(red_b, G, n + half);
          zb[n] = bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(0.5f * zg)));
        }
        // taps of layer li+1 (its ring is not written before the step's layer li+1)
        if (li + 1 < L) {
          const int w1 = win[li + 1], d1 = w1 / (k - 1);
          for (int i = tid; i < past; i += NT) {
            const int j = i / R, r = i % R;
            const int m = (k - 1 - j) * d1;
            taps[i] = bf16r(ring[ring_off[li + 1] + ((base[li + 1] + t + w1 - m) % w1) * R + r]);
          }
        }
        __syncthreads();

        if (li + 1 < L) {
          // gates of layer li+1: [taps | rho*h | z] @ [w_tap[li+1] ; w_fused[li+1]]
          Seg gate[2] = {{a.w_tap + (size_t)(li + 1) * k * R * G, G, past + R, act},
                         {a.w_fused + (size_t)(li + 1) * half * G, G, half, zb}};
          matvec_partial(gate, 2, G, red_b);
          // residual and skip 1x1s of layer li: z @ w_os[li]
          Seg os[1] = {{a.w_os + (size_t)li * half * RS, RS, half, zb}};
          matvec_partial(os, 1, RS, red_a);
        } else {
          // last layer: only its skip output is used
          Seg os[1] = {{a.w_os + (size_t)li * half * RS + R, RS, half, zb}};
          matvec_partial(os, 1, S, red_a);
        }
        __syncthreads();
      }
    } else {
      // --- 2-3. the layer stack, plain chain: two dependent matvecs a layer ---
      for (int li = 0; li < L; ++li) {
        // residual and skip outputs of layer li-1 (partials in red_a); h becomes the
        // input of layer li and goes into its ring (its taps were staged already)
        const int slot = (base[li] + t) % win[li];
        for (int c = tid; c < RS; c += NT) {
          if (c < R) {
            float hc = h[c];
            if (li > 0) {
              hc = (a.b_os[(li - 1) * RS + c] + reduce_slices(red_a, RS, c) + hc) * rho;
              h[c] = hc;
            }
            ring[ring_off[li] + slot * R + c] = hc;
            hb[c] = bf16r(hc);
          } else if (li > 0) {
            const int s = c - R;
            float sk = skips[s] + a.b_os[(li - 1) * RS + c] + reduce_slices(red_a, RS, c);
            if (a.legacy && li - 1 > 0) sk *= SQRT_HALF;
            skips[s] = sk;
          }
        }
        __syncthreads();
        // gates of layer li: [taps | h] @ w_tap[li]
        {
          Seg gate[1] = {{a.w_tap + (size_t)li * k * R * G, G, past + R, act}};
          matvec_partial(gate, 1, G, red_b);
        }
        __syncthreads();
        // GLU of layer li
        for (int n = tid; n < half; n += NT) {
          const int base = li * G;
          const float za = reduce_slices(red_b, G, n) + a.b_tap[base + n] + cond[base + n];
          const float zg = reduce_slices(red_b, G, n + half) + a.b_tap[base + n + half]
                           + cond[base + n + half];
          zb[n] = bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(0.5f * zg)));
        }
        // taps of layer li+1 (its ring is not written before the step's layer li+1)
        if (li + 1 < L) {
          const int w1 = win[li + 1], d1 = w1 / (k - 1);
          for (int i = tid; i < past; i += NT) {
            const int j = i / R, r = i % R;
            const int m = (k - 1 - j) * d1;
            taps[i] = bf16r(ring[ring_off[li + 1] + ((base[li + 1] + t + w1 - m) % w1) * R + r]);
          }
        }
        __syncthreads();
        // residual and skip 1x1s of layer li: z @ w_os[li]; the last layer's skip only
        if (li + 1 < L) {
          Seg os[1] = {{a.w_os + (size_t)li * half * RS, RS, half, zb}};
          matvec_partial(os, 1, RS, red_a);
        } else {
          Seg os[1] = {{a.w_os + (size_t)li * half * RS + R, RS, half, zb}};
          matvec_partial(os, 1, S, red_a);
        }
        __syncthreads();
      }
    }

    // --- 4. head: skip sum -> relu -> 1x1 -> relu -> 1x1 ---
    for (int s = tid; s < S; s += NT) {
      float sk = skips[s] + a.b_os[(L - 1) * RS + R + s] + reduce_slices(red_a, S, s);
      if (a.legacy && L > 1) sk *= SQRT_HALF;
      o[s] = bf16r(fmaxf(sk, 0.f));
    }
    __syncthreads();
    {
      Seg s1[1] = {{a.w_s1, S, S, o}};
      matvec_partial(s1, 1, S, red_a);
    }
    __syncthreads();
    for (int s = tid; s < S; s += NT) {
      const float v = fmaxf(a.b_s1[s] + reduce_slices(red_a, S, s), 0.f);
      if constexpr (HEAD == CATEGORICAL_BIG)
        skips[s] = bf16r(v);  // the big-vocab head's input is bf16
      else
        skips[s] = v;
    }
    __syncthreads();

    // --- 5. the sample ---
    if constexpr (HEAD == GAUSSIAN) {
      if (tid < 32) {  // one warp
        float p0 = 0.f, p1 = 0.f;
        for (int s = tid; s < S; s += 32) {
          p0 = fmaf(skips[s], a.w_s2[2 * s], p0);
          p1 = fmaf(skips[s], a.w_s2[2 * s + 1], p1);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          p0 += __shfl_xor_sync(0xffffffffu, p0, off);
          p1 += __shfl_xor_sync(0xffffffffu, p1, off);
        }
        if (tid == 0) {
          p0 += a.b_s2[0];
          p1 += a.b_s2[1];
          const size_t bt = (size_t)b * a.T + t;
          const float logs = fmaxf(p1, a.log_scale_min);
          const float x = fminf(fmaxf(p0 + expf(logs) * a.noise[bt], -1.f), 1.f);
          a.audio[bt] = x;
          if (a.params != nullptr) {
            a.params[2 * bt] = p0;
            a.params[2 * bt + 1] = p1;
          }
          sample_s[0] = x;
        }
      }
    } else if constexpr (HEAD == MOL) {
      // MoL: the out_ch head outputs o @ w_s2 + b_s2 in f32, one warp per column, into
      // red_a (its partial sums were reduced above; the next step writes it again)
      const int warp = tid / 32, lane = tid % 32, oc = a.out_ch, nr = oc / 3;
      const size_t bt = (size_t)b * a.T + t;
      for (int j = warp; j < oc; j += NT / 32) {
        float p = 0.f;
        for (int s = lane; s < S; s += 32)
          p = fmaf(skips[s], a.w_s2[(size_t)s * oc + j], p);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) {
          p += a.b_s2[j];
          red_a[j] = p;
          if (a.params != nullptr) a.params[bt * oc + j] = p;
        }
      }
      __syncthreads();
      if (tid == 0) {
        // the mixture of largest logit + Gumbel; tied mixtures each weigh 1/count
        const float* nz = a.noise + bt * (nr + 1);
        float kmax = red_a[0] + nz[1];
        for (int i = 1; i < nr; ++i) kmax = fmaxf(kmax, red_a[i] + nz[1 + i]);
        float count = 0.f;
        for (int i = 0; i < nr; ++i) count += red_a[i] + nz[1 + i] >= kmax ? 1.f : 0.f;
        const float w = 1.f / count;
        float mean = 0.f, ls = 0.f;
        for (int i = 0; i < nr; ++i) {
          if (red_a[i] + nz[1 + i] >= kmax) {
            mean += red_a[nr + i] * w;
            ls += red_a[2 * nr + i] * w;
          }
        }
        const float logs = fmaxf(ls, a.log_scale_min);
        const float x = fminf(fmaxf(mean + expf(logs) * nz[0], -1.f), 1.f);
        a.audio[bt] = x;
        sample_s[0] = x;
      }
    } else if constexpr (HEAD == CATEGORICAL) {
      // categorical: Q logits o @ w_s2 + b_s2 in f32, one class a thread (the block
      // reads each row of the (S, Q) w_s2 coalesced); logit + Gumbel noise into red_a
      const int Q = a.out_ch;
      const size_t bt = (size_t)b * a.T + t;
      float logit = -INFINITY;  // the thread's un-noised logit, for the NLL
      if (tid < Q) {
        float p = 0.f;
        for (int s = 0; s < S; ++s) p = fmaf(skips[s], a.w_s2[(size_t)s * Q + tid], p);
        p += a.b_s2[tid];
        if (a.params != nullptr) a.params[bt * Q + tid] = p;
        red_a[tid] = p + a.noise[bt * Q + tid];
        if constexpr (NLL) logit = p;
      }
      if constexpr (NLL) {
        // logsumexp(logits) - logits[y] (wavenet_ar.py:470-481); red_b is free here
        if (tid == a.y_eval[bt]) sample_s[3] = logit;
        const float lse = block_lse(logit, tid < Q ? 1.f : 0.f, red_b);
        if (tid == 0) a.nll[bt] = lse - sample_s[3];
      }
      __syncthreads();
      if (tid < 32) {  // one warp: the largest score, how many classes tie it, the first
        float m = -INFINITY;
        for (int j = tid; j < Q; j += 32) m = fmaxf(m, red_a[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        int count = 0, first = Q;
        for (int j = tid; j < Q; j += 32) {
          if (red_a[j] >= m) {
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
          a.audio[bt] = (float)first;
          sample_s[0] = (float)first;
          sample_s[1] = m;
          sample_s[2] = (float)count;
        }
      }
    } else {
      // big-vocab categorical: no score is stored (see the note at the top)
      const int Q = a.out_ch;
      const size_t bt = (size_t)b * a.T + t;
      const unsigned long long t_abs = (unsigned long long)a.t_base + t;
      const __nv_bfloat16* w2 = reinterpret_cast<const __nv_bfloat16*>(a.w_s2);
      Best best = {-INFINITY, Q, 0};
      float lm = -INFINITY, ls = 0.f;
      int y = -1;
      if constexpr (NLL) y = a.y_eval[bt];
      for (int g = tid; g < a.q_ld / COLS; g += NT) {  // the ragged last groups too
        float lg[COLS], sc[COLS];
        big_vocab_scores(a, w2, skips, g, b, t_abs, lg, sc);
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int c = g * COLS + i;
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
      float lse = 0.f;
      if constexpr (NLL) lse = block_lse(lm, ls, red_b + 128);
      best = block_best(best, red_b);
      if (tid == 0) {
        if (best.count == 0) best.first = 0;  // every score NaN: stay inside first_w
        a.audio[bt] = (float)best.first;
        sample_s[0] = (float)best.first;
        sample_s[1] = best.v;
        sample_s[2] = (float)best.count;
        if constexpr (NLL) a.nll[bt] = lse - sample_s[3];
      }
    }
    __syncthreads();

    // --- 6. feedback through the first 1x1 conv ---
    if constexpr (HEAD == CATEGORICAL) {
      // bf16(one-hot / count) @ bf16(first_w) + first_b over the classes that tie the
      // maximum (wavenet_ar.py:441-448); one class, as good as always: its bf16 row
      const int id = (int)sample_s[0];
      const float m = sample_s[1], count = sample_s[2];
      for (int r = tid; r < R; r += NT) {
        float acc;
        if (count == 1.f) {
          acc = bf16r(a.first_w[(size_t)id * R + r]);
        } else {
          const float w = bf16r(1.f / count);
          acc = 0.f;
          for (int j = 0; j < a.out_ch; ++j)
            if (red_a[j] >= m) acc = fmaf(w, bf16r(a.first_w[(size_t)j * R + r]), acc);
        }
        h[r] = acc + a.first_b[r];
      }
    } else if constexpr (HEAD == CATEGORICAL_BIG) {
      // the same feedback from the bf16 first_w; on a tie (rare) a second pass marks
      // the tied classes in a bit mask over red_a, and their rows add up in class order
      const int Q = a.out_ch, id = (int)sample_s[0];
      const float m = sample_s[1], count = sample_s[2];
      const __nv_bfloat16* fw = reinterpret_cast<const __nv_bfloat16*>(a.first_w);
      unsigned int* tied = reinterpret_cast<unsigned int*>(red_a);
      const int words = (Q + 31) / 32;
      if (count > 1.f) {
        for (int i = tid; i < words; i += NT) tied[i] = 0u;
        __syncthreads();
        const __nv_bfloat16* w2 = reinterpret_cast<const __nv_bfloat16*>(a.w_s2);
        for (int g = tid; g < a.q_ld / COLS; g += NT) {
          float lg[COLS], sc[COLS];
          big_vocab_scores(a, w2, skips, g, b, (unsigned long long)a.t_base + t, lg, sc);
#pragma unroll
          for (int i = 0; i < COLS; ++i) {
            const int c = g * COLS + i;
            if (c < Q && sc[i] >= m) atomicOr(&tied[c / 32], 1u << (c % 32));
          }
        }
        __syncthreads();
      }
      for (int r = tid; r < R; r += NT) {
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
      const float x = sample_s[0];
      for (int r = tid; r < R; r += NT) h[r] = fmaf(x, a.first_w[r], a.first_b[r]);
    }
    __syncthreads();
  }
  if (a.h_out != nullptr)
    for (int r = tid; r < R; r += NT) a.h_out[(size_t)b * R + r] = h[r];
}

size_t smem_bytes(int cin, int L, int R, int G, int S, int k) {
  const size_t floats = (size_t)L * G + (size_t)(k - 1) * R + R + G / 2 + 2 * RED
                        + R + S + cin + S + 4;
  return floats * sizeof(float) + 3 * (size_t)L * sizeof(int);
}

bool tiles(int n) {  // N/8 column groups must divide the block
  return n > 0 && n % COLS == 0 && NT % (n / COLS) == 0;
}

template <int HEAD, int CHAIN, bool NLL>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.cin, a.L, a.R, a.G, a.S, a.k);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_ar_kernel<HEAD, CHAIN, NLL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wavenet_ar_kernel<HEAD, CHAIN, NLL><<<B, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HEAD, bool NLL = false>
int launch_chain(const Args& a, int B, bool fused, cudaStream_t stream) {
  return fused ? launch<HEAD, FUSED, NLL>(a, B, stream)
               : launch<HEAD, PLAIN, NLL>(a, B, stream);
}

// the categorical heads, with the in-kernel NLL when a.nll is given
template <int HEAD>
int launch_categorical(const Args& a, int B, bool fused, cudaStream_t stream) {
  return a.nll != nullptr ? launch_chain<HEAD, true>(a, B, fused, stream)
                          : launch_chain<HEAD, false>(a, B, fused, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers; the
// launch goes on `stream`. `head` (0 Gaussian, out_ch == 2; 1 MoL, out_ch == 3*nr; 2
// categorical, out_ch classes, at most one a thread; 3 big-vocab categorical, out_ch
// <= 65,536 classes, bf16 first_w and w_s2 of q_ld columns, noise from `seed` or
// `greedy`, no params) and `fused` (the fused critical path, or the plain chain, which
// takes null w_fused and b_fused) pick the instantiation; g_cond may be null. y_eval
// and nll, given together and only to a categorical head without params, ask for the
// in-kernel NLL. Returns the cudaError_t of the launch (0 on success).
extern "C" int wavenet_ar(
    const void* c_up, const void* noise, const void* first_w, const void* first_b,
    const void* w_tap, const void* b_tap, const void* w_os, const void* b_os,
    const void* w_fused, const void* b_fused, const void* w_cond, const void* b_cond,
    const void* w_s1, const void* b_s1, const void* w_s2, const void* b_s2,
    const void* g_cond, void* rings, const void* h_in, void* h_out, void* audio, void* params,
    const void* y_eval, void* nll, long long ring_floats, long long t_base,
    unsigned long long seed, int B, int T, int cin, int L,
    int layers_per_stack, int R, int G, int S, int k, int out_ch, int head, int fused,
    int legacy, int residual_legacy, int round_cond, int q_ld, int greedy,
    float log_scale_min, void* stream) {
  const bool head_ok =
      head == GAUSSIAN      ? out_ch == 2
      : head == MOL         ? out_ch >= 3 && out_ch % 3 == 0
      : head == CATEGORICAL ? out_ch >= 2 && out_ch <= NT
                            : head == CATEGORICAL_BIG && out_ch >= 2 && out_ch <= 65536
                                  && q_ld >= out_ch && q_ld % COLS == 0 && q_ld <= 32 * RED
                                  && params == nullptr;
  const bool nll_ok = (y_eval == nullptr) == (nll == nullptr)
                      && (nll == nullptr || ((head == CATEGORICAL || head == CATEGORICAL_BIG)
                                             && params == nullptr));
  if (!nll_ok || B <= 0 || T <= 0 || cin <= 0 || L <= 0 || layers_per_stack <= 0 || k < 2
      || G % 2 != 0 || R % COLS != 0 || !tiles(G) || !tiles(R + S) || !tiles(S)
      || t_base < 0 || !head_ok || (fused && (w_fused == nullptr || b_fused == nullptr)))
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
  a.log_scale_min = log_scale_min;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head == GAUSSIAN      ? launch_chain<GAUSSIAN>(a, B, fused, s)
         : head == MOL         ? launch_chain<MOL>(a, B, fused, s)
         : head == CATEGORICAL ? launch_categorical<CATEGORICAL>(a, B, fused, s)
                               : launch_categorical<CATEGORICAL_BIG>(a, B, fused, s);
}
