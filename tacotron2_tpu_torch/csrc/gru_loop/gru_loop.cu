// The CBHG's bidirectional GRU recurrence on Hopper: all T steps of both directions in one
// persistent launch forward (gru_fwd_loop) and one in reverse (gru_bwd_loop), in float32 and
// in bfloat16 (tacotron2_tpu_torch/ops/gru_scan.py, `gru_fwd_loop` and `gru_bwd_loop`, where
// `gru_loop_applies`: H = 128 units on the card).
//
// It replaces no Pallas kernel. It stands for the XLA loop that the JAX package compiles from
// the CBHG's `jax.lax.scan` over flax's GRUCell (tacotron2_tpu/models/tacotron/modules.py:
// 278-317, `run`: the input-side product hoisted out of the scan at :289-296, the body one
// (B, H) @ (H, 3H) product and the gates at :298-307) and for XLA's reverse scan of its
// autodiff. The port ran it as a Python loop of 512 steps a direction at the trainer's frames.
//
// A forward step at sequence position p (p = t, or for a reversed direction p = len - 1 - t
// within the row's lengths[b] and p = t on its padding), with hh = h W_hh^T (B, 3H):
//   r = sigmoid(ip_r + hh_r), z = sigmoid(ip_z + hh_z), hn = hh_n + b_hn,
//   n = tanh(ip_n + r hn), h' = (1 - z) n + z h, h <- h' where mask[b, t] > 0, else h,
//   out[b, p] = h mask[b, t]
// (flax's GRUCell: the hidden-side bias b_hn inside r's product, the other biases in ip). In
// bfloat16 every op rounds to bf16 where the plain version's bf16 op rounds: the product
// (float32 sums, rounded once, as cuBLAS's), each sum and product of the step, and the
// sigmoid step by step, 1 / (1 + exp(-x)) (models/precision.sigmoid, JAX's). Built with
// --fmad=false: the elementwise math rounds op by op; the dot products fuse where they say so.
// With `save` the forward writes the residuals the reverse kernel reads, at the position p:
// r, z, n, hn and the state before the step, hp, in the state's dtype (each a value the step
// formed in that dtype: the copies are exact).
//
// A reverse step from the output's gradient dout and the carried gradient dh of the state,
// in float32 in both dtypes (the residuals widened): g = dh + dout m; the state's gradient
// through the step, dhp = g where m > 0 (else 0, and g passes to the state before it);
// dn = dhp (1 - z), dz = dhp (hp - n), da_n = dn (1 - n^2), da_z = dz z (1 - z),
// da_r = da_n hn r (1 - r); dip = (da_r, da_z, da_n), the hidden gate gradients
// dg = (da_r, da_z, da_n r); dh <- dhp z (or g) + dg W_hh. dip is rounded once to the state's
// dtype, dg stays float32: the wrapper forms dW_hh = dg^T hp and db_hn = sum dg_n after the
// launch, each one product or sum over the B T rows in float32.
//
// What bounds it on an H100. A step's product is 2 B 3H H operations a direction: at B = 32 x
// 512 steps, both directions, 3.2 GFLOP, 48 us at the f32 CUDA cores' 67 TFLOP/s; its bytes
// (ip, the outputs, with the residuals) are about 150 MB in float32, 45 us at 3.35 TB/s. What
// a step pays is latency: each step waits on the one before, and reads all of W_hh from shared
// memory (192 KB in float32 at 128 bytes a clock, 0.8 us; 96 KB in bf16).
//
// Design. Each batch row and each direction is independent, and a direction's W_hh (3H x H,
// 192 KB in float32, 96 KB in bf16) fits in one CTA's shared memory: one CTA per (direction,
// row), 3H = 384 threads, W_hh resident for the whole launch, no grid barrier and nothing
// exchanged between CTAs. Forward: thread j owns gate column j; W_hh sits in shared memory as
// 16-byte vectors of V consecutive k (V = 4 float32 or 8 bf16) ordered [k / V][j], so that a
// warp's 32 columns read 512 consecutive bytes; the state h (float32, exact in either dtype)
// is read as broadcast vectors. Thread j forms hh_j and its gate (r, z, or hn), r and z go
// through shared memory to the n threads, which form n and the new h; two barriers a step.
// Each thread's ip of the step after next is loaded while the step runs (it does not depend on
// the recurrence). Reverse: the unit threads form the step's gate gradients into shared
// memory; thread (k, part) sums dg_j W_hh[j][k] over its third of the gate columns, W_hh in
// shared memory as vectors of V consecutive j ordered [j / V][k]; the unit threads add the
// three partials to the state's gradient; two barriers a step; each step's residuals are
// loaded two steps ahead.
//
// Planted faults for the smoke run's checks (chip_smoke.GRU_MUTANTS), each behind one macro:
// GRU_FAULT_RESET_BEFORE (b_hn added outside r's product), GRU_FAULT_Z_SWAPPED (z and 1 - z
// swapped), GRU_FAULT_MASK_IGNORED (the state not frozen, the output not zeroed on padding),
// GRU_FAULT_WHOLE_ROW_REVERSED (the reversed direction read over the whole row, not within
// lengths), GRU_FAULT_SIGMOID_ROUNDED_ONCE (bf16's sigmoid rounded once),
// GRU_FAULT_CARRY_DROPPED (the reverse kernel's dh z carry dropped) and
// GRU_FAULT_BWD_MASK_IGNORED (the reverse kernel's mask ignored).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 128;       // units of a direction: the build's only width
constexpr int G = 3 * H;     // gate columns r, z, n: the threads of a CTA
constexpr int MAX_DIRS = 2;  // directions of one launch

// the pointers of each entry, in the order of the wrapper's names (ops/gru_scan.py)
enum FwdPtr {
  FWD_IP0, FWD_IP1, FWD_W0, FWD_W1, FWD_B0, FWD_B1, FWD_MASK, FWD_LENGTHS, FWD_OUT, FWD_RES0,
  FWD_RES1, N_FWD_PTRS
};
enum BwdPtr {
  BWD_DOUT, BWD_RES0, BWD_RES1, BWD_W0, BWD_W1, BWD_MASK, BWD_LENGTHS, BWD_DIP0, BWD_DIP1,
  BWD_DG0, BWD_DG1, N_BWD_PTRS
};
// the planes of a direction's residuals (N_RES, B, T, H)
enum Res { R_R, R_Z, R_N, R_HN, R_HP, N_RES };

struct Args {
  const void* ip[MAX_DIRS];    // (B, T, 3H) the hoisted input projection of each direction
  const void* w[MAX_DIRS];     // (3H, H) W_hh of each direction, the nn.Linear layout
  const void* bhn[MAX_DIRS];   // (H,) b_hn
  const void* dout;            // (B, T, D H) the output's gradient (reverse)
  const float* mask;           // (B, T)
  const int* lengths;          // (B,) or null where no direction is reversed
  void* out;                   // (B, T, D H) both directions side by side (forward)
  void* res[MAX_DIRS];         // (N_RES, B, T, H) or null (forward without residuals)
  void* dip[MAX_DIRS];         // (B, T, 3H) in the state's dtype (reverse)
  float* dg[MAX_DIRS];         // (B, T, 3H) float32 (reverse)
  int B, T, D;
  int rev[MAX_DIRS];
};

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ void st(T* p, float x);
template <> __device__ __forceinline__ void st<float>(float* p, float x) { *p = x; }
template <> __device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x rounded to T, as the plain version's op in T rounds its result
template <typename T> __device__ __forceinline__ float rd(float x);
template <> __device__ __forceinline__ float rd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// torch.sigmoid at float32; models/precision.sigmoid in bf16, each step rounded
template <typename T> __device__ __forceinline__ float sig(float x);
template <> __device__ __forceinline__ float sig<float>(float x) {
  return 1.0f / (1.0f + expf(-x));
}
template <> __device__ __forceinline__ float sig<__nv_bfloat16>(float x) {
#ifdef GRU_FAULT_SIGMOID_ROUNDED_ONCE
  return rd<__nv_bfloat16>(1.0f / (1.0f + expf(-x)));
#else
  return rd<__nv_bfloat16>(1.0f / rd<__nv_bfloat16>(rd<__nv_bfloat16>(expf(-x)) + 1.0f));
#endif
}

// acc + sum over the V values of the 16-byte vector w times x[0 .. V-1] (float32, in order)
template <typename T> __device__ __forceinline__ float dot(float acc, uint4 w, const float* x);
template <> __device__ __forceinline__ float dot<float>(float acc, uint4 w, const float* x) {
  const float4 v = *reinterpret_cast<const float4*>(x);
  acc = __fmaf_rn(v.x, __uint_as_float(w.x), acc);
  acc = __fmaf_rn(v.y, __uint_as_float(w.y), acc);
  acc = __fmaf_rn(v.z, __uint_as_float(w.z), acc);
  return __fmaf_rn(v.w, __uint_as_float(w.w), acc);
}
template <> __device__ __forceinline__ float dot<__nv_bfloat16>(float acc, uint4 w,
                                                                 const float* x) {
  const float4 lo = *reinterpret_cast<const float4*>(x);
  const float4 hi = *reinterpret_cast<const float4*>(x + 4);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
  float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  acc = __fmaf_rn(lo.x, a.x, acc);
  acc = __fmaf_rn(lo.y, a.y, acc);
  acc = __fmaf_rn(lo.z, b.x, acc);
  acc = __fmaf_rn(lo.w, b.y, acc);
  a = __bfloat1622float2(p[2]);
  b = __bfloat1622float2(p[3]);
  acc = __fmaf_rn(hi.x, a.x, acc);
  acc = __fmaf_rn(hi.y, a.y, acc);
  acc = __fmaf_rn(hi.z, b.x, acc);
  return __fmaf_rn(hi.w, b.y, acc);
}

// the sequence position of step t of a direction: reversed within the row's length
__device__ __forceinline__ int position(int t, int len, int T, bool rev) {
#ifdef GRU_FAULT_WHOLE_ROW_REVERSED
  return rev ? T - 1 - t : t;
#else
  return rev && t < len ? len - 1 - t : t;
#endif
}

// 16-byte vectors of V values: 4 float32, 8 bf16
template <typename T> __host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

template <typename T> constexpr size_t fwd_smem() {
  return sizeof(uint4) * (H / vec<T>()) * G + sizeof(float) * 3 * H;
}
template <typename T> constexpr size_t bwd_smem() {
  return sizeof(uint4) * (G / vec<T>()) * H + sizeof(float) * (G + 3 * H);
}

template <typename T>
__global__ void __launch_bounds__(G, 1) gru_fwd_loop_kernel(Args a) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* Ws = reinterpret_cast<uint4*>(smem);          // [H / V][G]: W[j][qV .. qV + V - 1]
  float* hs = reinterpret_cast<float*>(Ws + (H / V) * G);  // [H] the state
  float* rs = hs + H;                                   // [H] the step's r
  float* zs = rs + H;                                   // [H] the step's z

  const int j = threadIdx.x, u = j % H, gate = j / H;  // gate 0 r, 1 z, 2 n
  const int d = blockIdx.x / a.B, b = blockIdx.x % a.B, Tn = a.T;
  const T* W = static_cast<const T*>(a.w[d]);
#pragma unroll 4
  for (int q = 0; q < H / V; ++q)
    Ws[q * G + j] = *reinterpret_cast<const uint4*>(W + (size_t)j * H + q * V);
  if (j < H) hs[j] = 0.0f;
  const float bhn = gate == 2 ? ld(static_cast<const T*>(a.bhn[d]) + u) : 0.0f;
  const bool rev = a.rev[d];
  const int len = a.lengths ? a.lengths[b] : Tn;
  const T* ip = static_cast<const T*>(a.ip[d]) + (size_t)b * Tn * G + j;
  const float* mask = a.mask + (size_t)b * Tn;
  T* out = static_cast<T*>(a.out) + (size_t)b * Tn * a.D * H + d * H + u;
  T* res = static_cast<T*>(a.res[d]);
  const size_t plane = (size_t)a.B * Tn * H;
  T* rrow = res ? res + (size_t)b * Tn * H + u : nullptr;
  __syncthreads();

  // the step's ip and mask, and the next step's, in registers; the one after next in flight
  float ip0 = ld(ip + (size_t)position(0, len, Tn, rev) * G), m0 = mask[0];
  float ip1 = 0.0f, m1 = 0.0f;
  if (Tn > 1) {
    ip1 = ld(ip + (size_t)position(1, len, Tn, rev) * G);
    m1 = mask[1];
  }
  for (int t = 0; t < Tn; ++t) {
    float ip2 = 0.0f, m2 = 0.0f;
    if (t + 2 < Tn) {
      ip2 = ld(ip + (size_t)position(t + 2, len, Tn, rev) * G);
      m2 = mask[t + 2];
    }
    const int p = position(t, len, Tn, rev);
    float acc = 0.0f;
#pragma unroll 8
    for (int q = 0; q < H / V; ++q) acc = dot<T>(acc, Ws[q * G + j], hs + q * V);
    const float hh = rd<T>(acc);
    T* r_at = rrow ? rrow + (size_t)p * H : nullptr;
    float hn = 0.0f;
    if (gate == 0) {
      const float r = sig<T>(rd<T>(ip0 + hh));
      rs[u] = r;
      if (r_at) st(r_at + R_R * plane, r);
    } else if (gate == 1) {
      const float z = sig<T>(rd<T>(ip0 + hh));
      zs[u] = z;
      if (r_at) st(r_at + R_Z * plane, z);
    } else {
#ifdef GRU_FAULT_RESET_BEFORE
      hn = hh;
#else
      hn = rd<T>(hh + bhn);
#endif
      if (r_at) st(r_at + R_HN * plane, hn);
    }
    __syncthreads();
    if (gate == 2) {
      const float r = rs[u], z = zs[u], h = hs[u];
#ifdef GRU_FAULT_RESET_BEFORE
      const float n = rd<T>(tanhf(rd<T>(rd<T>(ip0 + rd<T>(r * hn)) + bhn)));
#else
      const float n = rd<T>(tanhf(rd<T>(ip0 + rd<T>(r * hn))));
#endif
#ifdef GRU_FAULT_Z_SWAPPED
      const float hp = rd<T>(rd<T>(z * n) + rd<T>(rd<T>(1.0f - z) * h));
#else
      const float hp = rd<T>(rd<T>(rd<T>(1.0f - z) * n) + rd<T>(z * h));
#endif
#ifdef GRU_FAULT_MASK_IGNORED
      const float hnew = hp;
      st(out + (size_t)p * a.D * H, hnew);
#else
      const float hnew = m0 > 0.0f ? hp : h;
      st(out + (size_t)p * a.D * H, hnew * m0);
#endif
      if (r_at) {
        st(r_at + R_N * plane, n);
        st(r_at + R_HP * plane, h);
      }
      hs[u] = hnew;
    }
    __syncthreads();
    ip0 = ip1;
    ip1 = ip2;
    m0 = m1;
    m1 = m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(G, 1) gru_bwd_loop_kernel(Args a) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* Ws = reinterpret_cast<uint4*>(smem);              // [G / V][H]: W[qV .. qV + V - 1][k]
  float* dgs = reinterpret_cast<float*>(Ws + (G / V) * H);  // [G] the step's dg
  float* part = dgs + G;                                    // [3][H] thirds of dg W_hh

  const int tid = threadIdx.x, k = tid % H, third = tid / H;
  const int d = blockIdx.x / a.B, b = blockIdx.x % a.B, Tn = a.T;
  const T* W = static_cast<const T*>(a.w[d]);
  for (int i = tid; i < (G / V) * H; i += G) {
    const int q = i / H, kk = i % H;
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int c = 0; c < V; ++c) e[c] = W[(size_t)(q * V + c) * H + kk];
    Ws[i] = v;
  }
  const bool rev = a.rev[d];
  const int len = a.lengths ? a.lengths[b] : Tn;
  const bool unit = tid < H;  // the unit threads, u = tid
  const float* mask = a.mask + (size_t)b * Tn;
  const T* dout = static_cast<const T*>(a.dout) + (size_t)b * Tn * a.D * H + d * H + k;
  const size_t plane = (size_t)a.B * Tn * H;
  const T* res = static_cast<const T*>(a.res[d]) + (size_t)b * Tn * H + k;
  T* dip = static_cast<T*>(a.dip[d]) + (size_t)b * Tn * G + k;
  float* dg = a.dg[d] + (size_t)b * Tn * G + k;
  __syncthreads();

  // a step's inputs of a unit thread: dout, the mask and the five residuals
  struct In {
    float dout, m, r[N_RES];
  };
  auto load = [&](int t) {
    In x;
    const int p = position(t, len, Tn, rev);
    x.dout = ld(dout + (size_t)p * a.D * H);
    x.m = mask[t];
#pragma unroll
    for (int c = 0; c < N_RES; ++c) x.r[c] = ld(res + c * plane + (size_t)p * H);
    return x;
  };
  In in0{}, in1{};
  if (unit) {
    in0 = load(Tn - 1);
    if (Tn > 1) in1 = load(Tn - 2);
  }
  float dh = 0.0f;  // the carried gradient of the state (unit threads)
  for (int t = Tn - 1; t >= 0; --t) {
    float direct = 0.0f;
    if (unit) {
      In in2{};
      if (t >= 2) in2 = load(t - 2);
      const int p = position(t, len, Tn, rev);
      const float r = in0.r[R_R], z = in0.r[R_Z], n = in0.r[R_N], hn = in0.r[R_HN],
                  hp = in0.r[R_HP];
      const float g = dh + in0.dout * in0.m;
#ifdef GRU_FAULT_BWD_MASK_IGNORED
      const float dhp = dh + in0.dout;
#else
      const float dhp = in0.m > 0.0f ? g : 0.0f;
      direct = in0.m > 0.0f ? 0.0f : g;
#endif
      const float dn = dhp * (1.0f - z);
      const float dz = dhp * (hp - n);
#ifndef GRU_FAULT_CARRY_DROPPED
      direct = direct + dhp * z;
#endif
      const float dan = dn * (1.0f - n * n);
      const float dhn = dan * r;
      const float daz = dz * (z * (1.0f - z));
      const float dar = (dan * hn) * (r * (1.0f - r));
      dgs[k] = dar;
      dgs[H + k] = daz;
      dgs[2 * H + k] = dhn;
      const size_t o = (size_t)p * G;
      st(dip + o, dar);
      st(dip + o + H, daz);
      st(dip + o + 2 * H, dan);
      dg[o] = dar;
      dg[o + H] = daz;
      dg[o + 2 * H] = dhn;
      in0 = in1;
      in1 = in2;
    }
    __syncthreads();
    float acc = 0.0f;
#pragma unroll 8
    for (int q = third * (H / V); q < (third + 1) * (H / V); ++q)
      acc = dot<T>(acc, Ws[q * H + k], dgs + q * V);
    part[third * H + k] = acc;
    __syncthreads();
    if (unit) dh = ((direct + part[k]) + part[H + k]) + part[2 * H + k];
  }
}

template <typename T>
cudaError_t launch(Args& a, bool forward, cudaStream_t stream) {
  const void* kernel = forward ? (const void*)gru_fwd_loop_kernel<T>
                               : (const void*)gru_bwd_loop_kernel<T>;
  const size_t smem = forward ? fwd_smem<T>() : bwd_smem<T>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (forward)
    gru_fwd_loop_kernel<T><<<a.D * a.B, G, smem, stream>>>(a);
  else
    gru_bwd_loop_kernel<T><<<a.D * a.B, G, smem, stream>>>(a);
  return cudaGetLastError();
}

// n: B, T, D, rev0, rev1, bf16
bool dims(Args& a, const int* n) {
  a.B = n[0];
  a.T = n[1];
  a.D = n[2];
  a.rev[0] = n[3];
  a.rev[1] = n[4];
  return a.B >= 1 && a.T >= 1 && a.D >= 1 && a.D <= MAX_DIRS &&
         (long long)a.B * a.D <= 0x7fffffffLL;
}

}  // namespace

// The forward recurrence of n[2] directions over (B, T) = (n[0], n[1]); n[3], n[4] whether
// each direction is reversed within lengths; n[5] bf16. Residuals where FWD_RES0 is not null.
extern "C" int t2_gru_fwd_loop(void* const* p, const int* n, void* stream) {
  Args a = {};
  if (!dims(a, n)) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.D; ++d) {
    a.ip[d] = p[FWD_IP0 + d];
    a.w[d] = p[FWD_W0 + d];
    a.bhn[d] = p[FWD_B0 + d];
    a.res[d] = p[FWD_RES0 + d];
  }
  a.mask = static_cast<const float*>(p[FWD_MASK]);
  a.lengths = static_cast<const int*>(p[FWD_LENGTHS]);
  a.out = p[FWD_OUT];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(n[5] ? launch<__nv_bfloat16>(a, true, s) : launch<float>(a, true, s));
}

// The reverse recurrence, with n as t2_gru_fwd_loop's.
extern "C" int t2_gru_bwd_loop(void* const* p, const int* n, void* stream) {
  Args a = {};
  if (!dims(a, n)) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.D; ++d) {
    a.res[d] = p[BWD_RES0 + d];
    a.w[d] = p[BWD_W0 + d];
    a.dip[d] = p[BWD_DIP0 + d];
    a.dg[d] = static_cast<float*>(p[BWD_DG0 + d]);
  }
  a.dout = p[BWD_DOUT];
  a.mask = static_cast<const float*>(p[BWD_MASK]);
  a.lengths = static_cast<const int*>(p[BWD_LENGTHS]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(n[5] ? launch<__nv_bfloat16>(a, false, s) : launch<float>(a, false, s));
}
