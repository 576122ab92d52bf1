// The encoder's bidirectional zoneout-LSTM recurrence on Hopper: all T steps of both
// directions in one persistent launch forward (lstm_fwd_loop) and one in reverse
// (lstm_bwd_loop), the state in float32, W_hh and the hoisted input half xp in float32 or
// bfloat16 (tacotron2_tpu_torch/ops/lstm_scan.py, `lstm_fwd_loop` and `lstm_bwd_loop`, where
// `lstm_loop_applies`: U = 256 units, a float32 recurrence, on the card).
//
// It replaces no Pallas kernel. It stands for the XLA loop that the JAX package compiles from
// the encoder's `jax.lax.scan` (tacotron2_tpu/models/tacotron/modules.py:136-206, `run`: the
// input half of the gate product hoisted out of the scan at :166-170, the body one
// (B, U) @ (U, 4U) product and the gates at :176-197) and for XLA's reverse scan of its
// autodiff. The port ran it as a Python loop of T_in eager steps a direction.
//
// A forward step t of a direction, m = t < len (the row's lengths[b]), with z = xp[t] + h W_hh
// (the gates i, g, f, o, each U wide; xp in the direction's step order: a reversed
// direction's is the input half of its reversed sequence, as the JAX scan hoists it):
//   sf = sigmoid(f + 1), si = sigmoid(i), tg = tanh(g), c_new = sf c + si tg,
//   so = sigmoid(o), tc = tanh(c_new), h_new = so tc,
//   zoneout: training c_z = kc[t] ? c_new : c, h_z = kh[t] ? h_new : h (the keep-masks read
//   at the direction's own step t, not at p); synthesis c_z = (1 - zc) c_new + zc c,
//   h_z = (1 - zh) h_new + zh h; then the hold c <- m ? c_z : c, h <- m ? h_z : h, and
//   out[b, p] = h_new m (h_new, not the zoned h) at the sequence position p = t, or for a
//   reversed direction p = len - 1 - t within the row's length and p = t on its padding.
// Every op is float32 in both storage dtypes (xp and W_hh widen exactly), rounded where the
// plain version's op rounds: built with --fmad=false, the elementwise math rounds op by op;
// the dot products fuse where they say so. torch.sigmoid at float32 is 1 / (1 + exp(-x)).
// With `res` the forward writes the residuals the reverse kernel reads, at the step t,
// float32: si, tg, sf, so, the state c before the step, tc and the state h before the step.
//
// A reverse step from the output's gradient dout[b, p] and the carried gradients dc, dh of
// the state after the step, float32, op for op as autograd computes the step loop's gradient
// on the CPU (the plain version, ops/lstm_scan._lstm_step_loop_bwd): g_c = m ? dc : 0; zoneout
// passes dc_z = kc ? g_c : 0 (or g_c (1 - zc)) to c_new and dc_d = (m ? 0 : dc) + (kc ? 0 :
// g_c) (or + g_c zc) to the state before, likewise dh; dh_new = dout m + dh_z, dc_new = dc_z +
// (dh_new so) (1 - tc^2); dz = (((dc_new tg) (1 - si)) si, (dc_new si) (1 - tg^2),
// ((dc_new c) (1 - sf)) sf, ((dh_new tc) (1 - so)) so), each 1 - y^2 one fused multiply-add
// (autograd's tanh_backward); dc <- dc_d + dc_new sf, dh <- dh_d + dz W_hh^T. dz is float32,
// xp's gradient, at the step t; the wrapper forms dW_hh = h_prev^T dz after the launch.
//
// What bounds it on an H100. A step's product is 2 B 4U U operations a direction: at B = 32,
// both directions, 33.6 MFLOP, 0.20 us as float32-accurate 3xTF32 products on the tensor
// cores' 495 TFLOP/s (0.50 us on the f32 CUDA cores' 67 TFLOP/s, where this kernel sums
// them); its bytes (xp, the outputs, with the residuals) are about 1.2 MB a step in float32,
// 0.36 us at 3.35 TB/s. What a step pays is latency: each step waits on the one before, its
// h crosses the cluster, and the cluster meets once a step.
//
// Design. W_hh (U x 4U) is 1 MiB in float32 and 512 KiB in bf16, over the 227 KB a CTA may
// hold, so each (direction, group of R rows) runs on a cluster of N = 8 CTAs, and CTA q holds
// the i, g, f and o columns of units [qU/N, (q+1)U/N): 4U/N = 128 columns x U rows of W_hh,
// resident in shared memory for the whole launch (128 KB in float32, 64 KB in bf16). Each
// CTA forms c and h of its own units, so c never leaves it; only h moves: each unit thread
// writes its h into every CTA's copy of the state through distributed shared memory,
// double-buffered, and the cluster meets once a step at one barrier. A forward step: thread
// (column j, quarter kq of k) sums h[kq U/4 .. (kq+1) U/4) W_hh[., j] for the R rows (W_hh in
// shared memory as 16-byte vectors of V consecutive k ordered [k / V][j], V = 4 float32 or 8
// bf16, so that a warp's 32 columns read 512 consecutive bytes; the state read as broadcast
// vectors); the quarters meet in shared memory, summed in order; the unit thread (row, unit)
// forms the step. A reverse step: the unit threads write the step's dz into shared memory;
// thread (k, half of the CTA's columns) sums dz_j W_hh[k][j] over its 64 columns (W_hh as
// vectors of V consecutive columns ordered [j / V][k]), and writes the partial sum into the
// shared memory of the CTA that owns unit k, one slot a (CTA, half); after the barrier the
// unit thread adds its 2N slots in a fixed order: two launches agree bit for bit. The
// clusters of a launch (D ceil(B / R)) need no grid barrier between them; the wrapper takes
// the fewest rows R of ROWS at which cudaOccupancyMaxActiveClusters keeps every cluster of the
// launch resident (t2_lstm_loop_occupancy).
//
// Shared memory a CTA: forward (U / V) 128 x 16 bytes of W_hh + 4 (2 R U + 4 R 128) bytes of
// state and quarter sums: 160 KB in float32 and 96 KB in bf16 at R = 8, 136 and 72 at R = 2;
// reverse the same W_hh + 4 (R 128 + 2 x 16 R 32) bytes of dz and slots: 164 and 100 KB at
// R = 8. 512 threads.
//
// Planted faults for the smoke run's checks (chip_smoke.LSTM_MUTANTS), each behind one macro:
// LSTM_FAULT_FORGET_BIAS_DROPPED (sigmoid(f), not sigmoid(f + 1)), LSTM_FAULT_GATES_SWAPPED
// (gates f and i swapped), LSTM_FAULT_KEEPS_SWAPPED (the c and h keep-masks swapped),
// LSTM_FAULT_KEEPS_AT_POSITION (the reversed direction's keep-masks read at the sequence
// position, not at the scan step), LSTM_FAULT_HOLD_IGNORED (the padding hold ignored),
// LSTM_FAULT_ZONED_OUTPUT (the zoned h written as the output), LSTM_FAULT_STALE_PEER (a peer's
// h read from the other buffer of the double buffer: the step before last, as it is being
// refilled), LSTM_FAULT_CARRY_DROPPED (the reverse kernel's dc sf carry dropped),
// LSTM_FAULT_BWD_KEEPS_SWAPPED (the reverse kernel's c and h keep-masks swapped) and
// LSTM_FAULT_BWD_SLOT_DROPPED (the reverse kernel's last partial of dh W_hh^T dropped).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 256;           // units of a direction: the build's only width
constexpr int G = 4 * U;         // gate columns i, g, f, o
constexpr int N = 8;             // CTAs a cluster
constexpr int UC = U / N;        // units a CTA
constexpr int GC = 4 * UC;       // gate columns a CTA
constexpr int THREADS = 512;
constexpr int KQ = THREADS / GC;  // forward: quarters of k a column
constexpr int KS = U / KQ;        // forward: k a quarter
constexpr int JH = THREADS / U;   // reverse: halves of the CTA's columns a k
constexpr int JS = GC / JH;       // reverse: columns a half
constexpr int SLOTS = N * JH;     // reverse: partial sums of dh W_hh^T a unit
constexpr int MAX_DIRS = 2;       // directions of one launch
constexpr int MAX_ROWS = 8;       // the most rows a cluster runs (ROWS: 1, 2, 4, 8)

// the pointers of each entry, in the order of the wrapper's names (ops/lstm_scan.py)
enum FwdPtr {
  FWD_XP0, FWD_XP1, FWD_W0, FWD_W1, FWD_LENGTHS, FWD_KC0, FWD_KH0, FWD_KC1, FWD_KH1, FWD_OUT,
  FWD_RES0, FWD_RES1, N_FWD_PTRS
};
enum BwdPtr {
  BWD_DOUT, BWD_RES0, BWD_RES1, BWD_W0, BWD_W1, BWD_LENGTHS, BWD_KC0, BWD_KH0, BWD_KC1,
  BWD_KH1, BWD_DZ0, BWD_DZ1, N_BWD_PTRS
};
// the planes of a direction's residuals (N_RES, B, T, U)
enum Res { R_SI, R_TG, R_SF, R_SO, R_C, R_TC, R_H, N_RES };

struct Args {
  const void* xp[MAX_DIRS];        // (B, T, 4U) the hoisted input half of each direction
  const void* w[MAX_DIRS];         // (U, 4U) W_hh of each direction: z = xp + h W_hh
  const int* lengths;              // (B,)
  const uint8_t* kc[MAX_DIRS];     // (T, B, U) the keep-masks of training, or null
  const uint8_t* kh[MAX_DIRS];
  float rate[MAX_DIRS][4];         // 1 - zc, zc, 1 - zh, zh of each direction
  const float* dout;               // (B, T, D U) the output's gradient (reverse)
  float* out;                      // (B, T, D U) both directions side by side (forward)
  float* res[MAX_DIRS];            // (N_RES, B, T, U) or null (forward without residuals)
  float* dz[MAX_DIRS];             // (B, T, 4U) (reverse)
  int B, T, D, R;
  int rev[MAX_DIRS];
};

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// torch.sigmoid at float32
__device__ __forceinline__ float sig(float x) { return 1.0f / (1.0f + expf(-x)); }

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
__device__ __forceinline__ int position(int t, int len, bool rev) {
  return rev && t < len ? len - 1 - t : t;
}

// the step at which a direction reads its keep-masks: its own scan step
__device__ __forceinline__ int keep_step(int t, int len, bool rev) {
#ifdef LSTM_FAULT_KEEPS_AT_POSITION
  return position(t, len, rev);
#else
  return t;
#endif
}

// the W_hh column of CTA `rank`'s local gate column lc: gate lc / UC of unit rank UC + lc % UC
__device__ __forceinline__ int gate_col(int lc, int rank) {
  return (lc / UC) * U + rank * UC + lc % UC;
}

// 16-byte vectors of V values: 4 float32, 8 bf16
template <typename T> __host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

template <typename T, int R> constexpr size_t fwd_smem() {
  return sizeof(uint4) * (U / vec<T>()) * GC + sizeof(float) * (2 * R * U + KQ * R * GC);
}
template <typename T, int R> constexpr size_t bwd_smem() {
  return sizeof(uint4) * (GC / vec<T>()) * U + sizeof(float) * (R * GC + 2 * SLOTS * R * UC);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS, 1) lstm_fwd_loop_kernel(Args a) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* Ws = reinterpret_cast<uint4*>(smem);                // [U / V][GC]
  float* hbuf = reinterpret_cast<float*>(Ws + (U / V) * GC);  // [2][R][U] the state h
  float* part = hbuf + 2 * R * U;                             // [KQ][R][GC] quarter sums

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int groups = (a.B + R - 1) / R, cid = blockIdx.x / N, Tn = a.T;
  const int d = cid / groups, b0 = (cid % groups) * R;
  const T* W = static_cast<const T*>(a.w[d]);
  for (int i = tid; i < (U / V) * GC; i += THREADS) {
    const int kv = i / GC, lc = i % GC;
    const T* col = W + (size_t)kv * V * G + gate_col(lc, rank);
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int c = 0; c < V; ++c) e[c] = col[(size_t)c * G];
    Ws[i] = v;
  }
  for (int i = tid; i < 2 * R * U; i += THREADS) hbuf[i] = 0.0f;

  // the unit thread (row r, unit u) of the step's elementwise math
  const int r = tid / UC, uu = tid % UC, u = rank * UC + uu, b = b0 + r;
  const bool unit = tid < R * UC && b < a.B;
  const bool rev = a.rev[d];
  const int len = unit ? min(max(a.lengths[b], 0), Tn) : 0;
  const T* xp = static_cast<const T*>(a.xp[d]) + (size_t)b * Tn * G + u;  // step order
  const uint8_t* kc = a.kc[d];
  const uint8_t* kh = a.kh[d];
#ifdef LSTM_FAULT_KEEPS_SWAPPED
  kc = a.kh[d];
  kh = a.kc[d];
#endif
  const float rc0 = a.rate[d][0], rc1 = a.rate[d][1], rh0 = a.rate[d][2], rh1 = a.rate[d][3];
  float* out = a.out + (size_t)b * Tn * a.D * U + d * U + u;
  float* res = a.res[d];
  const size_t plane = (size_t)a.B * Tn * U;
  float* rrow = res ? res + (size_t)b * Tn * U + u : nullptr;

  // a step's inputs of a unit thread: the four gates' xp and the two keep-masks
  struct In {
    float xp[4];
    bool kc, kh;
  };
  auto load = [&](int t) {
    In x;
    const size_t o = (size_t)t * G;
#pragma unroll
    for (int g = 0; g < 4; ++g) x.xp[g] = ld(xp + o + g * U);
    const size_t k = ((size_t)keep_step(t, len, rev) * a.B + b) * U + u;
    x.kc = kc ? kc[k] != 0 : false;
    x.kh = kh ? kh[k] != 0 : false;
    return x;
  };
  In in{};
  if (unit) in = load(0);
  float c = 0.0f, h = 0.0f;  // the unit thread's state
  const int lc = tid % GC, kq = tid / GC;  // the product's thread: column, quarter of k
  cluster_sync();  // W_hh and the state ready in every CTA before any peer writes

  for (int t = 0; t < Tn; ++t) {
    const float* hcur = hbuf + (t & 1) * R * U;
    float acc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc[rr] = 0.0f;
#pragma unroll 4
    for (int q = 0; q < KS / V; ++q) {
      const int kv = kq * (KS / V) + q;
      const uint4 w = Ws[kv * GC + lc];
#ifdef LSTM_FAULT_STALE_PEER
      const float* hsrc = (kv * V) / UC != rank ? hbuf + ((t + 1) & 1) * R * U : hcur;
#else
      const float* hsrc = hcur;
#endif
#pragma unroll
      for (int rr = 0; rr < R; ++rr) acc[rr] = dot<T>(acc[rr], w, hsrc + rr * U + kv * V);
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) part[(kq * R + rr) * GC + lc] = acc[rr];
    __syncthreads();
    if (unit) {
      In nx{};
      if (t + 1 < Tn) nx = load(t + 1);
      const int p = position(t, len, rev);
      const float m = t < len ? 1.0f : 0.0f;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* s = part + r * GC + g * UC + uu;
        float mm = s[0];
#pragma unroll
        for (int k = 1; k < KQ; ++k) mm = mm + s[k * R * GC];
        z[g] = in.xp[g] + mm;
      }
#ifdef LSTM_FAULT_GATES_SWAPPED
      const float zi = z[2], zf = z[0];
#else
      const float zi = z[0], zf = z[2];
#endif
#ifdef LSTM_FAULT_FORGET_BIAS_DROPPED
      const float sf = sig(zf);
#else
      const float sf = sig(zf + 1.0f);
#endif
      const float si = sig(zi), tg = tanhf(z[1]);
      const float c_new = sf * c + si * tg;
      const float so = sig(z[3]);
      const float tc = tanhf(c_new);
      const float h_new = so * tc;
      if (rrow) {
        float* at = rrow + (size_t)t * U;
        at[R_SI * plane] = si;
        at[R_TG * plane] = tg;
        at[R_SF * plane] = sf;
        at[R_SO * plane] = so;
        at[R_C * plane] = c;
        at[R_TC * plane] = tc;
        at[R_H * plane] = h;
      }
      const float cz = kc ? (in.kc ? c_new : c) : rc0 * c_new + rc1 * c;
      const float hz = kh ? (in.kh ? h_new : h) : rh0 * h_new + rh1 * h;
#ifdef LSTM_FAULT_HOLD_IGNORED
      c = cz;
      h = hz;
#else
      c = m > 0.0f ? cz : c;
      h = m > 0.0f ? hz : h;
#endif
#ifdef LSTM_FAULT_ZONED_OUTPUT
      out[(size_t)p * a.D * U] = h * m;
#else
      out[(size_t)p * a.D * U] = h_new * m;
#endif
      if (t + 1 < Tn) {
        float* hnext = hbuf + ((t + 1) & 1) * R * U + r * U + u;
#pragma unroll
        for (int q = 0; q < N; ++q) *cluster.map_shared_rank(hnext, q) = h;
      }
      in = nx;
    }
    if (t + 1 == Tn) break;  // no peer writes after the last barrier: each CTA may leave
    cluster_sync();
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_loop_kernel(Args a) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* Wt = reinterpret_cast<uint4*>(smem);                // [GC / V][U]
  float* dzs = reinterpret_cast<float*>(Wt + (GC / V) * U);  // [R][GC] the step's dz
  float* slots = dzs + R * GC;                               // [2][SLOTS][R][UC]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int groups = (a.B + R - 1) / R, cid = blockIdx.x / N, Tn = a.T;
  const int d = cid / groups, b0 = (cid % groups) * R;
  const T* W = static_cast<const T*>(a.w[d]);
  for (int i = tid; i < (GC / V) * U; i += THREADS) {
    const int jv = i / U, k = i % U;
    Wt[i] = *reinterpret_cast<const uint4*>(W + (size_t)k * G + gate_col(jv * V, rank));
  }
  for (int i = tid; i < R * GC; i += THREADS) dzs[i] = 0.0f;

  const int r = tid / UC, uu = tid % UC, u = rank * UC + uu, b = b0 + r;
  const bool unit = tid < R * UC && b < a.B;
  const bool rev = a.rev[d];
  const int len = unit ? min(max(a.lengths[b], 0), Tn) : 0;
  const uint8_t* kc = a.kc[d];
  const uint8_t* kh = a.kh[d];
#ifdef LSTM_FAULT_BWD_KEEPS_SWAPPED
  kc = a.kh[d];
  kh = a.kc[d];
#endif
  const float rc0 = a.rate[d][0], rc1 = a.rate[d][1], rh0 = a.rate[d][2], rh1 = a.rate[d][3];
  const float* dout = a.dout + (size_t)b * Tn * a.D * U + d * U + u;
  const size_t plane = (size_t)a.B * Tn * U;
  const float* res = a.res[d] + (size_t)b * Tn * U + u;
  float* dz = a.dz[d] + (size_t)b * Tn * G + u;

  // a step's inputs of a unit thread: dout, the residuals but h and the keep-masks
  struct In {
    float dout, r[R_H];
    bool kc, kh;
  };
  auto load = [&](int t) {
    In x;
    x.dout = dout[(size_t)position(t, len, rev) * a.D * U];
#pragma unroll
    for (int c = 0; c < R_H; ++c) x.r[c] = res[c * plane + (size_t)t * U];
    const size_t k = ((size_t)keep_step(t, len, rev) * a.B + b) * U + u;
    x.kc = kc ? kc[k] != 0 : false;
    x.kh = kh ? kh[k] != 0 : false;
    return x;
  };
  In in{};
  if (unit) in = load(Tn - 1);
  float dc = 0.0f, dhd = 0.0f;  // the carried gradient of c, the direct part of h's
  const int k = tid % U, jh = tid / U;  // the product's thread: unit k, half of the columns
  cluster_sync();

  for (int t = Tn - 1; t >= 0; --t) {
    if (unit) {
      In nx{};
      if (t > 0) nx = load(t - 1);
      float dh = dhd;  // the gradient of the state h after step t
      if (t + 1 < Tn) {
        const float* s = slots + ((t + 1) & 1) * SLOTS * R * UC + r * UC + uu;
        float mm = s[0];
#ifdef LSTM_FAULT_BWD_SLOT_DROPPED
        for (int q = 1; q < SLOTS - 1; ++q) mm = mm + s[q * R * UC];
#else
#pragma unroll
        for (int q = 1; q < SLOTS; ++q) mm = mm + s[q * R * UC];
#endif
        dh = dhd + mm;
      }
      const float m = t < len ? 1.0f : 0.0f;
      const bool on = m > 0.0f;
      const float gc = on ? dc : 0.0f, gh = on ? dh : 0.0f;
      float dcz, dcd, dhz;
      if (kc) {
        dcz = in.kc ? gc : 0.0f;
        dcd = (on ? 0.0f : dc) + (in.kc ? 0.0f : gc);
        dhz = in.kh ? gh : 0.0f;
        dhd = (on ? 0.0f : dh) + (in.kh ? 0.0f : gh);
      } else {
        dcz = gc * rc0;
        dcd = (on ? 0.0f : dc) + gc * rc1;
        dhz = gh * rh0;
        dhd = (on ? 0.0f : dh) + gh * rh1;
      }
      const float si = in.r[R_SI], tg = in.r[R_TG], sf = in.r[R_SF], so = in.r[R_SO],
                  cp = in.r[R_C], tc = in.r[R_TC];
      const float dhn = in.dout * m + dhz;
      const float dcn = dcz + (dhn * so) * __fmaf_rn(-tc, tc, 1.0f);
      const float dzi = ((dcn * tg) * (1.0f - si)) * si;
      const float dzg = (dcn * si) * __fmaf_rn(-tg, tg, 1.0f);
      const float dzf = ((dcn * cp) * (1.0f - sf)) * sf;
      const float dzo = ((dhn * tc) * (1.0f - so)) * so;
#ifdef LSTM_FAULT_CARRY_DROPPED
      dc = dcd;
#else
      dc = dcd + dcn * sf;
#endif
      float* row = dzs + r * GC + uu;
      row[0] = dzi;
      row[UC] = dzg;
      row[2 * UC] = dzf;
      row[3 * UC] = dzo;
      float* at = dz + (size_t)t * G;
      at[0] = dzi;
      at[U] = dzg;
      at[2 * U] = dzf;
      at[3 * U] = dzo;
      in = nx;
    }
    if (t == 0) break;  // the gradient of the initial state is not wanted
    __syncthreads();
    float acc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) acc[rr] = 0.0f;
#pragma unroll 4
    for (int q = 0; q < JS / V; ++q) {
      const int jv = jh * (JS / V) + q;
      const uint4 w = Wt[jv * U + k];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) acc[rr] = dot<T>(acc[rr], w, dzs + rr * GC + jv * V);
    }
    float* dst = cluster.map_shared_rank(slots + (t & 1) * SLOTS * R * UC, k / UC)
                 + (rank * JH + jh) * R * UC + k % UC;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) dst[rr * UC] = acc[rr];
    cluster_sync();
  }
}

cudaLaunchConfig_t cluster_config(int clusters, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * N);
  cfg.blockDim = dim3(THREADS);
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

template <typename T, int R>
cudaError_t launch_rows(const Args& a, bool forward, cudaStream_t stream) {
  const void* kernel = forward ? (const void*)lstm_fwd_loop_kernel<T, R>
                               : (const void*)lstm_bwd_loop_kernel<T, R>;
  const size_t smem = forward ? fwd_smem<T, R>() : bwd_smem<T, R>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(a.D * ((a.B + R - 1) / R), smem, stream, &attr);
  err = forward ? cudaLaunchKernelEx(&cfg, lstm_fwd_loop_kernel<T, R>, a)
                : cudaLaunchKernelEx(&cfg, lstm_bwd_loop_kernel<T, R>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, bool forward, cudaStream_t stream) {
  switch (a.R) {
    case 1: return launch_rows<T, 1>(a, forward, stream);
    case 2: return launch_rows<T, 2>(a, forward, stream);
    case 4: return launch_rows<T, 4>(a, forward, stream);
    case MAX_ROWS: return launch_rows<T, MAX_ROWS>(a, forward, stream);
    default: return cudaErrorInvalidValue;
  }
}

// clusters of N CTAs the card keeps resident at once (0: none fits)
template <typename T, int R>
int occupancy_rows(bool forward) {
  const void* kernel = forward ? (const void*)lstm_fwd_loop_kernel<T, R>
                               : (const void*)lstm_bwd_loop_kernel<T, R>;
  const size_t smem = forward ? fwd_smem<T, R>() : bwd_smem<T, R>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

template <typename T>
int occupancy(int R, bool forward) {
  switch (R) {
    case 1: return occupancy_rows<T, 1>(forward);
    case 2: return occupancy_rows<T, 2>(forward);
    case 4: return occupancy_rows<T, 4>(forward);
    case MAX_ROWS: return occupancy_rows<T, MAX_ROWS>(forward);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// n: B, T, D, rev0, rev1, bf16, R, then the rates' bits (1 - zc, zc, 1 - zh, zh) of each
// of MAX_DIRS directions
bool dims(Args& a, const int* n) {
  a.B = n[0];
  a.T = n[1];
  a.D = n[2];
  a.rev[0] = n[3];
  a.rev[1] = n[4];
  a.R = n[6];
  for (int d = 0; d < MAX_DIRS; ++d)
    memcpy(a.rate[d], n + 7 + 4 * d, sizeof(a.rate[d]));
  return a.B >= 1 && a.T >= 1 && a.D >= 1 && a.D <= MAX_DIRS && a.R >= 1 && a.R <= MAX_ROWS
         && (long long)a.D * ((a.B + a.R - 1) / a.R) * N <= 0x7fffffffLL;
}

}  // namespace

// The forward recurrence of n[2] directions over (B, T) = (n[0], n[1]); n[3], n[4] whether
// each direction is reversed within lengths; n[5] bf16 W_hh and xp; n[6] rows a cluster;
// n[7 ..] the zoneout rates. Training's keep-masks where FWD_KC0 is not null, residuals where
// FWD_RES0 is not null.
extern "C" int t2_lstm_fwd_loop(void* const* p, const int* n, void* stream) {
  Args a = {};
  if (!dims(a, n)) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.D; ++d) {
    a.xp[d] = p[FWD_XP0 + d];
    a.w[d] = p[FWD_W0 + d];
    a.kc[d] = static_cast<const uint8_t*>(p[FWD_KC0 + 2 * d]);
    a.kh[d] = static_cast<const uint8_t*>(p[FWD_KH0 + 2 * d]);
    a.res[d] = static_cast<float*>(p[FWD_RES0 + d]);
  }
  a.lengths = static_cast<const int*>(p[FWD_LENGTHS]);
  a.out = static_cast<float*>(p[FWD_OUT]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(n[5] ? launch<__nv_bfloat16>(a, true, s) : launch<float>(a, true, s));
}

// The reverse recurrence, with n as t2_lstm_fwd_loop's.
extern "C" int t2_lstm_bwd_loop(void* const* p, const int* n, void* stream) {
  Args a = {};
  if (!dims(a, n)) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.D; ++d) {
    a.res[d] = static_cast<float*>(p[BWD_RES0 + d]);
    a.w[d] = p[BWD_W0 + d];
    a.kc[d] = static_cast<const uint8_t*>(p[BWD_KC0 + 2 * d]);
    a.kh[d] = static_cast<const uint8_t*>(p[BWD_KH0 + 2 * d]);
    a.dz[d] = static_cast<float*>(p[BWD_DZ0 + d]);
  }
  a.dout = static_cast<const float*>(p[BWD_DOUT]);
  a.lengths = static_cast<const int*>(p[BWD_LENGTHS]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(n[5] ? launch<__nv_bfloat16>(a, false, s) : launch<float>(a, false, s));
}

// Clusters of N CTAs of the kernel (forward or reverse; bf16 or float32 W_hh; R rows a
// cluster) that the card keeps resident at once, or minus the CUDA error.
extern "C" int t2_lstm_loop_occupancy(int R, int bf16, int forward) {
  return bf16 ? occupancy<__nv_bfloat16>(R, forward != 0) : occupancy<float>(R, forward != 0);
}
