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
// Design. As csrc/wavenet_ar.cu, so that `base` and `fused` read as the layer-stack
// share of that kernel's step: one block of 1024 threads a row of the batch for all T
// steps; the weights stay in global memory, which the L2 holds across steps (5.2 MB for
// `base`, 6.2 MB for `fused` at L=20, R=128, G=256); a warp reads 512-byte weight rows as
// 16-byte vectors, thread tid owning column group tid % (N/8) and rows tid / (N/8)
// apart; partial sums meet in shared memory; __syncthreads between dependent stages.
// The ring buffers (2.1 MB a row) are a scratch tensor in global memory, zeroed here.
// A layer's tap j = 0 reads the slot that this step writes ((K-1)*d = the window): it
// is read before it is written, in both chains.
//
// What bounds it. A row-step is 2.6 M (`base`) or 3.1 M (`fused`) multiply-adds, 42-50
// MFLOP a step at B=8: 0.04-0.05 us at the bf16 tensor-core peak; the weights, read once
// a launch, are 1.6-1.9 us of HBM time. Each block reads all its weights from L2 every
// step through one SM, and its loads are drained at every barrier (two or three a layer),
// so, as in wavenet_ar.cu, load latency sets the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int UNROLL = 4;
constexpr int COLS = 8;
constexpr int RED = NT * COLS;  // floats in one partial-sum buffer
constexpr int MAX_L = 64;
enum Chain { BASE, FUSED };
enum Glu { PLAIN_GLU, BF16_GLU, TANHSIG, TANHFOLD, TF_BF16O };

struct Args {
  const __nv_bfloat16 *w_tap, *w_os, *w_fused, *w_cur, *w_out, *w_skip;
  const float* cond;  // (B, L*G)
  float* rings;       // (B, slots * R)
  float* out;         // (B, R)
  int L, R, G, S, K, T, slots;
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

struct Seg {
  const __nv_bfloat16* w;
  int ld;
  int rows;
  const float* act;
};

// Partial sums of out[n] = sum over segments of act . W[:, n], n < N, into red
// (wavenet_ar.cu's mapping); the caller synchronises and sums the slices.
__device__ __forceinline__ void matvec_partial(const Seg* segs, int nseg, int N, float* red) {
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

template <int CHAIN, int GLU>
__global__ void __launch_bounds__(NT) critpath_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, R = a.R, G = a.G, S = a.S, K = a.K, half = G / 2, RS = R + S;
  const int tid = threadIdx.x, b = blockIdx.x;
  float* red_a = sm;                    // RED
  float* red_b = red_a + RED;           // RED
  float* red_c = red_b + RED;           // RED
  float* h = red_c + RED;               // R
  float* skips = h + R;                 // S
  float* act = skips + S;               // K*R
  float* zb = act + K * R;              // half
  float* consts = zb + half;            // L*G (fused)
  __shared__ int win[MAX_L], dil[MAX_L], off[MAX_L];
  if (tid == 0) {
    int o = 0;
    for (int li = 0; li < L; ++li) {
      dil[li] = 1 << (li % (L / 2));
      win[li] = (K - 1) * dil[li];
      off[li] = o;
      o += win[li];
    }
  }
  float* ring = a.rings + (size_t)b * a.slots * R;
  for (size_t i = tid; i < (size_t)a.slots * R; i += NT) ring[i] = 0.f;
  for (int c = tid; c < R; c += NT) h[c] = 0.01f;
  const float* cond = a.cond + (size_t)b * L * G;
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    for (int s = tid; s < S; s += NT) skips[s] = 0.f;
    if constexpr (CHAIN == BASE) {
      for (int li = 0; li < L; ++li) {
        // [taps | h] in bf16; h into the ring after its slot's tap was read
        float* rg = ring + (size_t)off[li] * R;
        for (int c = tid; c < R; c += NT) {
          for (int j = 0; j < K - 1; ++j) {
            const int slot = tap_slot(t, win[li], (K - 1 - j) * dil[li]);
            act[j * R + c] = bf16r(rg[(size_t)slot * R + c]);
          }
          act[(K - 1) * R + c] = bf16r(h[c]);
          rg[(size_t)(t % win[li]) * R + c] = h[c];
        }
        __syncthreads();
        Seg gate_seg[1] = {{a.w_tap + (size_t)li * K * R * G, G, K * R, act}};
        matvec_partial(gate_seg, 1, G, red_b);
        __syncthreads();
        for (int n = tid; n < half; n += NT)
          zb[n] = glu<GLU>(reduce_slices(red_b, G, n) + cond[li * G + n],
                           reduce_slices(red_b, G, n + half) + cond[li * G + n + half]);
        __syncthreads();
        Seg os[1] = {{a.w_os + (size_t)li * half * RS, RS, half, zb}};
        matvec_partial(os, 1, RS, red_a);
        __syncthreads();
        for (int c = tid; c < RS; c += NT) {
          const float y = reduce_slices(red_a, RS, c);
          if (c < R)
            h[c] += y;
          else
            skips[c - R] += y;
        }
        __syncthreads();
      }
    } else {
      // the past taps' products and the conditioning of every layer, up front
      for (int li = 0; li < L; ++li) {
        const float* rg = ring + (size_t)off[li] * R;
        for (int i = tid; i < (K - 1) * R; i += NT) {
          const int j = i / R, c = i % R;
          act[i] = bf16r(rg[(size_t)tap_slot(t, win[li], (K - 1 - j) * dil[li]) * R + c]);
        }
        __syncthreads();
        Seg past[1] = {{a.w_tap + (size_t)li * K * R * G, G, (K - 1) * R, act}};
        matvec_partial(past, 1, G, red_b);
        __syncthreads();
        for (int n = tid; n < G; n += NT)
          consts[li * G + n] = reduce_slices(red_b, G, n) + cond[li * G + n];
      }
      // layer 0: its gate matvec is the chain's first; h0 into its ring
      for (int c = tid; c < R; c += NT) {
        act[c] = bf16r(h[c]);
        ring[((size_t)off[0] + t % win[0]) * R + c] = h[c];
      }
      __syncthreads();
      {
        Seg cur[1] = {{a.w_cur, G, R, act}};
        matvec_partial(cur, 1, G, red_b);
      }
      __syncthreads();
      for (int n = tid; n < half; n += NT)
        zb[n] = glu<GLU>(reduce_slices(red_b, G, n) + consts[n],
                         reduce_slices(red_b, G, n + half) + consts[n + half]);
      __syncthreads();
      for (int li = 1; li < L; ++li) {
        // act holds bf16(h_{l-1}) of the layer before: the off-path term's input
        Seg gates[2] = {{a.w_fused + (size_t)li * half * G, G, half, zb},
                        {a.w_cur + (size_t)li * R * G, G, R, act}};
        matvec_partial(gates, 2, G, red_b);
        Seg dh[1] = {{a.w_out + (size_t)(li - 1) * half * R, R, half, zb}};
        matvec_partial(dh, 1, R, red_a);
        Seg sk[1] = {{a.w_skip + (size_t)(li - 1) * half * S, S, half, zb}};
        matvec_partial(sk, 1, S, red_c);
        __syncthreads();
        for (int c = tid; c < R; c += NT) {
          const float hc = h[c] + reduce_slices(red_a, R, c);
          h[c] = hc;
          act[c] = bf16r(hc);
          ring[((size_t)off[li] + t % win[li]) * R + c] = hc;
        }
        for (int s = tid; s < S; s += NT) skips[s] += reduce_slices(red_c, S, s);
        for (int n = tid; n < half; n += NT)
          zb[n] = glu<GLU>(reduce_slices(red_b, G, n) + consts[li * G + n],
                           reduce_slices(red_b, G, n + half) + consts[li * G + n + half]);
        __syncthreads();
      }
      Seg dh[1] = {{a.w_out + (size_t)(L - 1) * half * R, R, half, zb}};
      matvec_partial(dh, 1, R, red_a);
      Seg sk[1] = {{a.w_skip + (size_t)(L - 1) * half * S, S, half, zb}};
      matvec_partial(sk, 1, S, red_c);
      __syncthreads();
      for (int c = tid; c < R; c += NT) h[c] += reduce_slices(red_a, R, c);
      for (int s = tid; s < S; s += NT) skips[s] += reduce_slices(red_c, S, s);
      __syncthreads();
    }
    // prev = h * 1e-4 + skips[:R] * 1e-6, the next step's h
    for (int c = tid; c < R; c += NT)
      h[c] = __fadd_rn(__fmul_rn(h[c], 1e-4f), __fmul_rn(skips[c], 1e-6f));
    __syncthreads();
  }
  for (int c = tid; c < R; c += NT) a.out[(size_t)b * R + c] = h[c];
}

template <int CHAIN, int GLU>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * RED + a.R + a.S + a.K * a.R + a.G / 2
                                       + (CHAIN == FUSED ? a.L * a.G : 0));
  cudaError_t err = cudaFuncSetAttribute(critpath_kernel<CHAIN, GLU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  critpath_kernel<CHAIN, GLU><<<B, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// w_tap (L, K*R, G), w_os (L, G/2, R+S), w_fused (L, G/2, G), w_cur (L, R, G),
// w_out (L, G/2, R), w_skip (L, G/2, S) bf16; cond (B, L*G) f32; rings (B, slots*R) f32
// scratch; out (B, R) f32; chain 0 base, 1 fused; glu 0-4 (plain, bf16, tanh-sigmoid,
// tanhfold, tanhfold with a bf16 combine; base takes the plain GLU only). Needs L even
// and at most 64, N/8 dividing 1024 for N in G, R, S, R+S. Returns a cudaError_t.
extern "C" int probe_ar_critpath(const __nv_bfloat16* w_tap, const __nv_bfloat16* w_os,
                                 const __nv_bfloat16* w_fused, const __nv_bfloat16* w_cur,
                                 const __nv_bfloat16* w_out, const __nv_bfloat16* w_skip,
                                 const float* cond, float* rings, float* out, long long L,
                                 long long R, long long G, long long S, long long K,
                                 long long B, long long T, long long chain, long long glu,
                                 cudaStream_t stream) {
  if (L < 2 || L % 2 || L > MAX_L || K < 2 || B < 1 || T < 0 || (chain == BASE && glu != 0))
    return (int)cudaErrorInvalidValue;
  long long slots = 0;
  for (int li = 0; li < L; ++li) slots += (K - 1) << (li % (L / 2));
  Args a{w_tap, w_os, w_fused, w_cur, w_out, w_skip, cond, rings, out,
         (int)L, (int)R, (int)G, (int)S, (int)K, (int)T, (int)slots};
  if (chain == BASE) return launch<BASE, PLAIN_GLU>(a, (int)B, stream);
  switch (glu) {
    case PLAIN_GLU: return launch<FUSED, PLAIN_GLU>(a, (int)B, stream);
    case BF16_GLU: return launch<FUSED, BF16_GLU>(a, (int)B, stream);
    case TANHSIG: return launch<FUSED, TANHSIG>(a, (int)B, stream);
    case TANHFOLD: return launch<FUSED, TANHFOLD>(a, (int)B, stream);
    case TF_BF16O: return launch<FUSED, TF_BF16O>(a, (int)B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
