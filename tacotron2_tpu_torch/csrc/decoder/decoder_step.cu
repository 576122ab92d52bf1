// The Tacotron decoder step's elementwise stages and row reductions on Hopper: the four
// hand-written kernels of the teacher-forced decoder with its hand-written backward
// (tacotron2_tpu_torch/ops/decoder_vjp.py, FusedDecoderScan).
//
// They replace the XLA fusions that the JAX package's fused decoder leaves to the TPU's
// compiler (tacotron2_tpu/ops/fused_decoder.py, no Pallas kernel of its own):
//   lstm_cell_fwd   `_lstm_fwd` with the zoneout mix of `_step_fwd` (:122-127, :356-364)
//   lstm_cell_bwd   `_lstm_bwd` with the (1 - a) bypasses of `_bwd_rule` (:130-150, :522-539)
//   attention_fwd   `_att_align` and the new state (:215-228, :367-368)
//   attention_bwd   the normalisation and energy backward of `_att_bwd` (:275-301)
// The products around them (prenet, gates, query, location layer, context, projections
// and the deferred weight gradients) stay library products, as JAX leaves them to XLA.
//
// Rounding. Each kernel computes the function of its plain PyTorch version in
// decoder_vjp.py in the same order: in float32 every operation in f32; in bfloat16
// (the T = __nv_bfloat16 instantiation) every value the plain version holds in bf16 is
// rounded to bf16 where that version rounds it (rd<T>), every other value in f32, as
// torch computes a bf16 op in f32 and rounds its result. The sigmoid is torch's in f32
// and JAX's 1 / (1 + exp(-x)), each step rounded, in bf16 (models/precision.py). This
// file is built with --fmad=false, so that a product and a sum are never contracted into
// one rounding that the plain version does not make.
//
// Bounds. All four move a few MB a call (at the default trainer B=32, U=1,024, D=128,
// T_in=100: 0.4-1.3 MB for the LSTM cell, 1.7-9.8 MB for the attention) and do a few
// flops a byte: bound by the bytes, about 0.1-3 us at 3.35 TB/s, against launch costs of
// a few us. The design is the simple one: the LSTM cell one thread an element (b, u); the
// attention one CTA of 1,024 threads a row b, a warp an input step for the D-sum of the
// energy, the T_in softmax in shared memory, and in the backward a thread a column d and
// every eighth input step (coalesced along D), whose partial sums of dpq, dva and dba the
// CTA adds in a fixed order, without atomics. A CTA of 128 threads left the loads of
// its few warps in a chain of latencies: 25-50 us a call.
// attention_bwd adds its row's du into the f32 dkeys accumulator and its row's partial
// sums into the (B, D) dva and dba accumulators in place; the rows are summed after the
// decoder's reverse loop.
//
// Plain C entry points (loaded with ctypes); every pointer is a device pointer, a null
// one stands for an absent optional input; the launch goes on `stream` and the entry
// returns its cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -4294967296.0f;  // -2**32 + 1 in float32 (attention.py)
// the attention's CTA: 32 warps, so that a row's input steps take few turns of the
// energy's warp loop; the backward's column sums run in ATT_GROUPS groups of ATT_COLS
// columns, each group over every ATT_GROUPS-th input step
constexpr int ATT_THREADS = 1024;
constexpr int ATT_COLS = 128;
constexpr int ATT_GROUPS = ATT_THREADS / ATT_COLS;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T> __device__ __forceinline__ float ld(const T* p, long i);
template <> __device__ __forceinline__ float ld<float>(const float* p, long i) { return p[i]; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

template <typename T> __device__ __forceinline__ void st(T* p, long i, float x);
template <> __device__ __forceinline__ void st<float>(float* p, long i, float x) { p[i] = x; }
template <> __device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// x rounded to T, held in f32
template <typename T> __device__ __forceinline__ float rd(float x);
template <> __device__ __forceinline__ float rd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ float sig(float x);
template <> __device__ __forceinline__ float sig<float>(float x) { return 1.0f / (1.0f + expf(-x)); }
template <> __device__ __forceinline__ float sig<__nv_bfloat16>(float x) {
  return rd<__nv_bfloat16>(1.0f / rd<__nv_bfloat16>(rd<__nv_bfloat16>(expf(-x)) + 1.0f));
}

// The gate nonlinearity of one element: the sigmoids of i, f + 1 and o, tanh g, and the
// new cell c_new (the forget bias 1.0 of ZoneoutLSTMCell).
template <typename T> struct Gates {
  float si, tg, sf, so, cn;
  __device__ __forceinline__ Gates(const T* zr, int U, int u, float cp) {
    const float i = ld(zr, u), g = ld(zr, U + u), f = ld(zr, 2 * U + u), o = ld(zr, 3 * U + u);
    si = sig<T>(i);
    tg = rd<T>(tanhf(g));
    sf = sig<T>(rd<T>(f + 1.0f));
    so = sig<T>(o);
    cn = rd<T>(rd<T>(sf * cp) + rd<T>(si * tg));
  }
};

template <typename T>
__global__ void lstm_cell_fwd_kernel(const T* __restrict__ z, const T* __restrict__ c_prev,
                                     const T* __restrict__ h_prev, const uint8_t* keep_c,
                                     const uint8_t* keep_h, float a_c, float b_c, float a_h,
                                     float b_h, T* c_post, T* h_post, T* h_new, int B, int U) {
  const long n = (long)B * U;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const int b = (int)(idx / U), u = (int)(idx % U);
    const float cp = ld(c_prev, idx), hp = ld(h_prev, idx);
    const Gates<T> gt(z + (long)b * 4 * U, U, u, cp);
    const float hn = rd<T>(gt.so * rd<T>(tanhf(gt.cn)));
    // zoneout: the keep-gate's choice, or the expectation a * new + b * old
    const float cz = keep_c ? (keep_c[idx] ? gt.cn : cp) : rd<T>(rd<T>(a_c * gt.cn) + rd<T>(b_c * cp));
    const float hz = keep_h ? (keep_h[idx] ? hn : hp) : rd<T>(rd<T>(a_h * hn) + rd<T>(b_h * hp));
    st(c_post, idx, cz);
    st(h_post, idx, hz);
    st(h_new, idx, hn);
  }
}

template <typename T>
__global__ void lstm_cell_bwd_kernel(const T* __restrict__ z, const T* __restrict__ c_prev,
                                     const T* dha, long lda, const T* dhb, const float* dh,
                                     const float* dc, const uint8_t* keep_c,
                                     const uint8_t* keep_h, float a_c, float a_h, T* dz,
                                     float* dc_next, float* dh_bypass, int B, int U) {
  const long n = (long)B * U;
  for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const int b = (int)(idx / U), u = (int)(idx % U);
    float ds = ld(dha, (long)b * lda + u);
    if (dhb) ds = rd<T>(ds + ld(dhb, idx));
    const float ac = keep_c ? (keep_c[idx] ? 1.0f : 0.0f) : a_c;
    const float ah = keep_h ? (keep_h[idx] ? 1.0f : 0.0f) : a_h;
    const float dhv = dh[idx], dcv = dc[idx];
    const float dhn = ds + ah * dhv;
    const float cp = ld(c_prev, idx);
    const Gates<T> gt(z + (long)b * 4 * U, U, u, cp);
    const float tc = rd<T>(tanhf(gt.cn));
    const float dcn = dhn * gt.so * rd<T>(1.0f - rd<T>(tc * tc)) + ac * dcv;
    const float d_o = dhn * tc * gt.so * rd<T>(1.0f - gt.so);
    const float d_f = dcn * cp * gt.sf * rd<T>(1.0f - gt.sf);
    const float d_i = dcn * gt.tg * gt.si * rd<T>(1.0f - gt.si);
    const float d_g = dcn * gt.si * rd<T>(1.0f - rd<T>(gt.tg * gt.tg));
    T* dzr = dz + (long)b * 4 * U;
    st(dzr, u, d_i);
    st(dzr, U + u, d_g);
    st(dzr, 2 * U + u, d_f);
    st(dzr, 3 * U + u, d_o);
    dc_next[idx] = dcn * gt.sf + (1.0f - ac) * dcv;
    dh_bypass[idx] = (1.0f - ah) * dhv;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The sum (or max) of every thread's v over the block, returned to every thread.
template <bool MAX> __device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : (MAX ? neg_inf() : 0.0f);
  return MAX ? warp_max(r) : warp_sum(r);
}

// u = ((keys + pq) + (pl [+ pl_b])) + b_a at (b, t, d), f32
template <typename T>
__device__ __forceinline__ float energy_arg(const T* keys, const T* pq, const T* pl,
                                            const float* pl_b, const float* b_a, long row,
                                            long brow, int d) {
  float loc = ld(pl, row + d);
  if (pl_b) loc += pl_b[d];
  return ((ld(keys, row + d) + ld(pq, brow + d)) + loc) + b_a[d];
}

// e[t] = sum_d v_a[d] tanh(u[b, t, d]), NEG_INF where the mask is not > 0: a warp a step
template <typename T>
__device__ void energies(const T* keys, const T* pq, const T* pl, const float* pl_b,
                         const float* b_a, const float* v_a, const float* mask, int b,
                         int T_in, int D, float* e) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  for (int t = warp; t < T_in; t += nw) {
    const long row = ((long)b * T_in + t) * D;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32)
      s += v_a[d] * tanhf(energy_arg(keys, pq, pl, pl_b, b_a, row, (long)b * D, d));
    s = warp_sum(s);
    if (lane == 0) e[t] = (mask && !(mask[(long)b * T_in + t] > 0.0f)) ? NEG_INF : s;
  }
  __syncthreads();
}

// e[t] -> the alignment's numerators (softmax: exp(e - max); smoothing: sigmoid(e)) in
// place; returns their sum
__device__ float normalizer(float* e, int T_in, int smoothing, float* red) {
  float mx = 0.0f;
  if (!smoothing) {
    float m = neg_inf();
    for (int t = threadIdx.x; t < T_in; t += blockDim.x) m = fmaxf(m, e[t]);
    mx = block_reduce<true>(m, red);
  }
  float s = 0.0f;
  for (int t = threadIdx.x; t < T_in; t += blockDim.x) {
    const float x = smoothing ? 1.0f / (1.0f + expf(-e[t])) : expf(e[t] - mx);
    e[t] = x;
    s += x;
  }
  return block_reduce<false>(s, red);
}

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attention_fwd_kernel(const T* keys, const T* pq, const T* pl, const float* pl_b,
                     const float* b_a, const float* v_a, const float* mask,
                     const float* state, float* align, float* new_state, float* align_r,
                     int T_in, int D, int smoothing, int cumulate) {
  extern __shared__ float e[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  energies(keys, pq, pl, pl_b, b_a, v_a, mask, b, T_in, D, e);
  const float sum = normalizer(e, T_in, smoothing, red);
  for (int t = threadIdx.x; t < T_in; t += blockDim.x) {
    const long i = (long)b * T_in + t;
    const float a = e[t] / sum;
    align[i] = a;
    new_state[i] = cumulate ? a + state[i] : a;
    if (align_r) align_r[i] = rd<T>(a);
  }
}

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bwd_kernel(const T* keys, const T* pq, const T* pl, const float* pl_b,
                     const float* b_a, const float* v_a, const float* mask,
                     const float* dalign, const float* ga, const float* dstate,
                     float* dkeys_acc, float* dva_acc, float* dba_acc, T* du, T* dpq,
                     int T_in, int D, int smoothing) {
  extern __shared__ float sm[];
  float* e = sm;          // the energies, then the alignment's numerators
  float* de = sm + T_in;  // the energies' gradient
  __shared__ float red[32];
  const int b = blockIdx.x;
  energies(keys, pq, pl, pl_b, b_a, v_a, mask, b, T_in, D, e);
  const float sum = normalizer(e, T_in, smoothing, red);
  // the alignment's gradient: the context's, the output's and (cumulating) the next
  // state's; then s = sum_t dalign * align
  float s = 0.0f;
  for (int t = threadIdx.x; t < T_in; t += blockDim.x) {
    const long i = (long)b * T_in + t;
    float da = dalign[i] + ga[i];
    if (dstate) da = da + dstate[i];
    de[t] = da;
    s += da * (e[t] / sum);
  }
  s = block_reduce<false>(s, red);
  for (int t = threadIdx.x; t < T_in; t += blockDim.x) {
    float g;
    if (smoothing) {
      const float sg = e[t];
      g = (de[t] - s) / sum * sg * (1.0f - sg);
    } else {
      g = (de[t] - s) * (e[t] / sum);
    }
    de[t] = (mask && !(mask[(long)b * T_in + t] > 0.0f)) ? 0.0f : g;
  }
  __syncthreads();
  // du = (de v_a) (1 - tanh(u)^2): a thread a column d and every ATT_GROUPS-th input
  // step; then each column's sums over its groups, in group order
  __shared__ float part[2][ATT_GROUPS][ATT_COLS];
  const long brow = (long)b * D;
  const int col = threadIdx.x % ATT_COLS, grp = threadIdx.x / ATT_COLS;
  for (int d0 = 0; d0 < D; d0 += ATT_COLS) {
    const int d = d0 + col;
    float sdu = 0.0f, sva = 0.0f;
    if (d < D) {
      const float va = v_a[d];
      for (int t = grp; t < T_in; t += ATT_GROUPS) {
        const long row = ((long)b * T_in + t) * D;
        const float th = tanhf(energy_arg(keys, pq, pl, pl_b, b_a, row, brow, d));
        const float g = de[t] * va * (1.0f - th * th);
        st(du, row + d, g);
        dkeys_acc[row + d] += g;
        sdu += g;
        sva += de[t] * th;
      }
    }
    part[0][grp][col] = sdu;
    part[1][grp][col] = sva;
    __syncthreads();
    if (grp == 0 && d < D) {
      for (int g = 1; g < ATT_GROUPS; ++g) {
        sdu += part[0][g][col];
        sva += part[1][g][col];
      }
      st(dpq, brow + d, sdu);
      dva_acc[brow + d] += sva;
      dba_acc[brow + d] += sdu;
    }
    __syncthreads();
  }
}

int grid_for(long n, int threads) {
  const long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 4096 ? blocks : 4096);
}

}  // namespace

extern "C" int t2_lstm_cell_fwd(const void* z, const void* c_prev, const void* h_prev,
                                const void* keep_c, const void* keep_h, float a_c, float b_c,
                                float a_h, float b_h, void* c_post, void* h_post, void* h_new,
                                int B, int U, int bf16, void* stream) {
  const int threads = 256, grid = grid_for((long)B * U, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *kc = (const uint8_t*)keep_c, *kh = (const uint8_t*)keep_h;
  if (bf16) {
    using T = __nv_bfloat16;
    lstm_cell_fwd_kernel<T><<<grid, threads, 0, s>>>(
        (const T*)z, (const T*)c_prev, (const T*)h_prev, kc, kh, a_c, b_c, a_h, b_h,
        (T*)c_post, (T*)h_post, (T*)h_new, B, U);
  } else {
    lstm_cell_fwd_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)z, (const float*)c_prev, (const float*)h_prev, kc, kh, a_c, b_c, a_h,
        b_h, (float*)c_post, (float*)h_post, (float*)h_new, B, U);
  }
  return (int)cudaGetLastError();
}

extern "C" int t2_lstm_cell_bwd(const void* z, const void* c_prev, const void* dha, long long lda,
                                const void* dhb, const void* dh, const void* dc,
                                const void* keep_c, const void* keep_h, float a_c, float a_h,
                                void* dz, void* dc_next, void* dh_bypass, int B, int U,
                                int bf16, void* stream) {
  const int threads = 256, grid = grid_for((long)B * U, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *kc = (const uint8_t*)keep_c, *kh = (const uint8_t*)keep_h;
  if (bf16) {
    using T = __nv_bfloat16;
    lstm_cell_bwd_kernel<T><<<grid, threads, 0, s>>>(
        (const T*)z, (const T*)c_prev, (const T*)dha, (long)lda, (const T*)dhb,
        (const float*)dh, (const float*)dc, kc, kh, a_c, a_h, (T*)dz, (float*)dc_next,
        (float*)dh_bypass, B, U);
  } else {
    lstm_cell_bwd_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)z, (const float*)c_prev, (const float*)dha, (long)lda,
        (const float*)dhb, (const float*)dh, (const float*)dc, kc, kh, a_c, a_h,
        (float*)dz, (float*)dc_next, (float*)dh_bypass, B, U);
  }
  return (int)cudaGetLastError();
}

extern "C" int t2_attention_fwd(const void* keys, const void* pq, const void* pl,
                                const void* pl_b, const void* b_a, const void* v_a,
                                const void* mask, const void* state, void* align,
                                void* new_state, void* align_r, int B, int T_in, int D,
                                int smoothing, int cumulate, int bf16, void* stream) {
  const size_t smem = sizeof(float) * T_in;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    attention_fwd_kernel<T><<<B, ATT_THREADS, smem, s>>>(
        (const T*)keys, (const T*)pq, (const T*)pl, (const float*)pl_b, (const float*)b_a,
        (const float*)v_a, (const float*)mask, (const float*)state, (float*)align,
        (float*)new_state, (float*)align_r, T_in, D, smoothing, cumulate);
  } else {
    attention_fwd_kernel<float><<<B, ATT_THREADS, smem, s>>>(
        (const float*)keys, (const float*)pq, (const float*)pl, (const float*)pl_b,
        (const float*)b_a, (const float*)v_a, (const float*)mask, (const float*)state,
        (float*)align, (float*)new_state, (float*)align_r, T_in, D, smoothing, cumulate);
  }
  return (int)cudaGetLastError();
}

extern "C" int t2_attention_bwd(const void* keys, const void* pq, const void* pl,
                                const void* pl_b, const void* b_a, const void* v_a,
                                const void* mask, const void* dalign, const void* ga,
                                const void* dstate, void* dkeys_acc, void* dva_acc,
                                void* dba_acc, void* du, void* dpq, int B, int T_in, int D,
                                int smoothing, int bf16, void* stream) {
  const size_t smem = sizeof(float) * 2 * T_in;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    attention_bwd_kernel<T><<<B, ATT_THREADS, smem, s>>>(
        (const T*)keys, (const T*)pq, (const T*)pl, (const float*)pl_b, (const float*)b_a,
        (const float*)v_a, (const float*)mask, (const float*)dalign, (const float*)ga,
        (const float*)dstate, (float*)dkeys_acc, (float*)dva_acc, (float*)dba_acc, (T*)du,
        (T*)dpq, T_in, D, smoothing);
  } else {
    attention_bwd_kernel<float><<<B, ATT_THREADS, smem, s>>>(
        (const float*)keys, (const float*)pq, (const float*)pl, (const float*)pl_b,
        (const float*)b_a, (const float*)v_a, (const float*)mask, (const float*)dalign,
        (const float*)ga, (const float*)dstate, (float*)dkeys_acc, (float*)dva_acc,
        (float*)dba_acc, (float*)du, (float*)dpq, T_in, D, smoothing);
  }
  return (int)cudaGetLastError();
}
