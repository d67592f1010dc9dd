// Fused EGNN pairwise block for Hopper (sm_90a): kernels K3, K4, K5.
//
// Replaces the Pallas TPU kernels of tfep_tpu/ops/pallas/egnn.py:
// _forward_kernel (K3), _jvp_kernel (K4) and _jvp_bwd_kernel (K5). The
// plain PyTorch versions, the autograd Function and the derivation of K5
// are in tfep_tpu_torch/ops/egnn.py; this file follows
// pairwise_jvp_backward_reference there line by line.
//
// All three are bound by operations: per pair, three (F, D)/(F, F)
// matrix-vector products (six with the tangent, eighteen in K5) against a
// few hundred bytes of input, in float32 SIMT (no tensor cores).
//
// K3 and K4, egnn_fwd_kernel<T, kTangent>: one thread per pair and one warp
// per receiver row. The lane that owns a pair runs its whole chain on its
// own row of the warp's shared memory, so the chain has no barrier. The
// products are register-tiled: the weights are stored transposed, and for
// each k a lane takes its own operand (and tangent) and broadcasts 64
// weights in 16 loads of 16 bytes, for 64 multiply-adds (128 in K4). Those
// broadcasts, about one float per clock per SM, are what bounds the
// products: about 25% of the f32 peak in K3, 50% in K4.
//
// K5, egnn_kernel<T>: one block per frame b walks the receiver rows i and,
// inside a row, tiles of PT senders j (PT = 32, 16, 8 or 4, the largest
// that fits). Between two __syncthreads() every thread loops over its
// share of one phase's work, and all state that crosses a barrier lives in
// shared memory (or, when shared memory is too small, in device memory
// through the same pointers). The phases between the products run on all
// threads, each sum in an order fixed by the code: a sum over a pair's
// features (or k) takes 256 / PT threads per pair, each over a fixed
// subset of the row rotated by the pair, so that the lanes of a warp read
// distinct banks (pair_partials), then one thread per pair combines them
// (pair_sums); elementwise work and the sums over pairs per feature take
// 256 / F threads per column, each over a fixed run of pairs
// (column_runs), combined in the next phase (column_sum). The cutoff's
// switching terms (cos and sin of the distance) are computed once per pair,
// at the tile's start. Each tile runs nine products: three of the
// K4 recompute (mm_abt), three cotangents (mm_ab2), three weight gradients
// (mm_atb2). They are register-tiled where the widths they walk are
// multiples of 4 and, for mm_abt and mm_ab2, the weights sit in shared
// memory: a thread owns 2 pairs by 4 output columns, for the primal and
// the tangent, or a 4 x 4 block of a weight gradient, and walks the inner
// dimension 4 elements at a time in 16-byte loads, each of which feeds 8
// multiply-adds in float32 (4 in float64); each output keeps the scalar
// path's order of summation. The weight rows in shared memory are then
// padded to K + 4 elements (weight_ld): they start on 16 bytes, and the 8
// lanes of a quarter-warp that read 8 consecutive rows hit distinct banks
// (float32, K a multiple of 8). Otherwise (a width not a multiple of 4, or
// the weights in device memory) a product takes the scalar path: each
// thread computes PM = 4 pairs of one output column, so one load of a
// weight serves four pairs, on weight rows padded by one element, so the 32
// threads of a warp read 32 different banks. Each helper picks its path at
// its top, from the widths. The eleven weight gradients are summed per
// block (one frame) into `partials`, then reduce_partials sums them over
// the frames in a fixed order. Per-frame gradients (a_i, a_j, dist and
// their tangents) are written by the block that owns the
// frame, with no atomics.
//
// C interface (bound with ctypes): egnn_k3/k4/k5(dtype, device, inputs,
// outputs, scratch, B, n, F, D, r_cutoff, stream) return 0, a CUDA error
// code, or -1 when no block configuration fits on the card;
// egnn_fwd_info and egnn_k5_info report the launch configurations.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int PM = 4;  // pairs per thread in a product
constexpr int TP = 2;  // pairs per thread in a register-tiled K5 product
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ void d_sincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void d_sincos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ double d_tanh(double x) { return tanh(x); }

template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + d_exp(-x));
}

template <typename T>
struct Args {
  // Inputs: the 14 primals, the 3 tangents (K4, K5), the 4 cotangents (K5).
  const T *a_i, *a_j, *dist, *mu, *lg, *w_e, *b1, *w_m2, *b_m2, *w_att,
      *b_att, *w_x1, *b_x1, *w_x2;
  const T *da_i, *da_j, *dd;
  const T *g_nm, *g_mag, *g_dnm, *g_dmag;
  // Outputs of K3 (nm, mag) and K4 (also dnm, dmag).
  T *nm, *mag, *dnm, *dmag;
  // Outputs of K5: per-frame gradients, and the weight-gradient sums of
  // each block (B x n_weight_elements).
  T *g_a_i, *g_a_j, *g_dist, *g_da_i, *g_da_j, *g_dd, *partials;
  int B, n, F, D, pt;
  T rc;
  int w_smem, g_smem;  // weights / gradient sums in shared memory
};

// =========================================================================
// K3 and K4: egnn_fwd_kernel<T, kTangent>
// =========================================================================

// Output columns a lane accumulates at once in a product (with as many
// more for the tangent in K4): 64 in float32, 32 in float64.
template <typename T>
__host__ __device__ constexpr int fwd_chunk() {
  return 64 * 4 / (int)sizeof(T);
}

// Most warps per block: K4's 128 accumulators need up to 255 registers a
// thread, so 8 warps; K3 at most 168, so 12.
template <bool kTangent>
__host__ __device__ constexpr int fwd_max_warps() {
  return kTangent ? 8 : 12;
}

// Shared memory of the forward kernel, in elements of T: the transposed
// weights, zero-padded to ldt columns (a multiple of the chunk), and the
// small vectors, once per block; then one slice per warp with a buffer X
// of 32 rows (and its tangent) of an odd stride, so that the 32 lanes,
// each reading its own row, hit 32 different banks; a second buffer Y
// where F > chunk (a product whose outputs span several chunks cannot
// overwrite its input; with one chunk the epilogue runs after the last
// read, and Y is X); and the row's message sums.
struct FwdLayout {
  int ldt, stride;
  int wet, wm2t, wx1t, mu, gam, b1, bm2, watt, bx1, wx2, batt;
  int warp0, per_warp, x, y, x2, y2, nm, dnm, total;
  __host__ __device__ FwdLayout(int F, int D, int chunk, bool tangent,
                                int warps) {
    ldt = (F + chunk - 1) / chunk * chunk;
    stride = F | 1;
    int at = 0;
    auto take = [&at](int size) {
      int start = at;
      at += (size + 3) & ~3;  // keep every array 16-byte aligned
      return start;
    };
    wet = take(D * ldt);
    wm2t = take(F * ldt);
    wx1t = take(F * ldt);
    mu = take(D);
    gam = take(D);
    b1 = take(F);
    bm2 = take(F);
    watt = take(F);
    bx1 = take(F);
    wx2 = take(F);
    batt = take(1);
    warp0 = at;
    at = 0;
    x = take(32 * stride);
    x2 = take(tangent ? 32 * stride : 0);
    y = F <= chunk ? x : take(32 * stride);
    y2 = F <= chunk ? x2 : take(tangent ? 32 * stride : 0);
    nm = take(F);
    dnm = take(tangent ? F : 0);
    per_warp = at;
    total = warp0 + warps * per_warp;
  }
};

// 16 bytes of shared memory as one load (a broadcast when every lane of
// the warp reads the same address).
__device__ __forceinline__ void load16(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double (&w)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  w[0] = v.x;
  w[1] = v.y;
}

// C columns of one lane's row of a product: acc[c] = sum_k a_k Wt[k][c]
// (a W^T, with Wt = W^T in shared memory, offset to the chunk's first
// column), and acc2 the same of the tangent a2 on the same weight loads.
// act(k, a_k, a2_k) gives the lane's operands (from its own row, or
// computed); the C weights come as 16-byte broadcasts, for 2C multiply-
// adds per k. The caller's epilogue loops over c fully unrolled, so acc
// and acc2 stay in registers.
template <typename T, int C, bool kTwo, typename Act>
__device__ __forceinline__ void chunk_product(int K, int ldt, Act act,
                                              const T* Wt, T (&acc)[C],
                                              T (&acc2)[C]) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = acc2[c] = T(0);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    T x, x2 = T(0);
    act(k, x, x2);
    const T* w = Wt + k * ldt;
#pragma unroll
    for (int c = 0; c < C; c += V) {
      T wv[V];
      load16(w + c, wv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[c + v] += x * wv[v];
        if constexpr (kTwo) acc2[c + v] += x2 * wv[v];
      }
    }
  }
}

// One warp per receiver row (b, i), lane p owning the pair (i, j0 + p) of
// each tile of 32 senders: its radial expansion, the three products of its
// row, the SiLUs, the attention and the magnitude, with their tangents
// (kTangent: K4; else K3). The tile's a_j rows are staged into the warp's
// buffer by coalesced asynchronous copies; past them, a lane reads and
// writes only its own rows, so the chain needs no barrier; the message sums
// over the tile's senders read the other lanes' rows, between two
// __syncwarp(). Each lane sums its own features over the senders in order,
// so every row writes nm (and dnm) once, with no atomics. The blocks are persistent:
// the weights are loaded once per block, then each warp walks the rows
// (b, i) with a stride of all the grid's warps.
template <typename T, bool kTangent>
__global__ void __launch_bounds__(fwd_max_warps<kTangent>() * 32)
egnn_fwd_kernel(Args<T> a) {
  constexpr int C = fwd_chunk<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n = a.n, F = a.F, D = a.D;
  const int tid = threadIdx.x, nt = blockDim.x, warps = nt / 32;
  const FwdLayout L(F, D, C, kTangent, warps);
  const int ldt = L.ldt, S = L.stride;

  // Wt[k][f] = W[f][k] for f < F, zero for F <= f < ldt.
  T* WeT = sm + L.wet;
  T* Wm2T = sm + L.wm2t;
  T* Wx1T = sm + L.wx1t;
  for (int e = tid; e < D * ldt; e += nt) {
    const int k = e / ldt, f = e % ldt;
    WeT[e] = f < F ? a.w_e[f * D + k] : T(0);
  }
  for (int e = tid; e < F * ldt; e += nt) {
    const int k = e / ldt, f = e % ldt;
    Wm2T[e] = f < F ? a.w_m2[f * F + k] : T(0);
    Wx1T[e] = f < F ? a.w_x1[f * F + k] : T(0);
  }
  T* s_mu = sm + L.mu;
  T* s_gam = sm + L.gam;
  T* s_b1 = sm + L.b1;
  T* s_bm2 = sm + L.bm2;
  T* s_watt = sm + L.watt;
  T* s_bx1 = sm + L.bx1;
  T* s_wx2 = sm + L.wx2;
  for (int k = tid; k < D; k += nt) {
    s_mu[k] = a.mu[k];
    s_gam[k] = d_exp(a.lg[k]);
  }
  for (int f = tid; f < F; f += nt) {
    s_b1[f] = a.b1[f];
    s_bm2[f] = a.b_m2[f];
    s_watt[f] = a.w_att[f];
    s_bx1[f] = a.b_x1[f];
    s_wx2[f] = a.w_x2[f];
  }
  const T batt = a.b_att[0];
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32;
  T* slice = sm + L.warp0 + warp * L.per_warp;
  T* X = slice + L.x;        // a_j, (s,) ms, then msg
  T* X2 = slice + L.x2;      // their tangents
  T* nmacc = slice + L.nm;   // the row's message sums (lane f % 32 owns f)
  T* dnmacc = slice + L.dnm;
  T* xr = X + lane * S;      // this lane's rows
  T* x2r = X2 + lane * S;
  T* yr = slice + L.y + lane * S;   // s and its tangent (X if F <= C)
  T* y2r = slice + L.y2 + lane * S;
  const T rc = a.rc;
  const T c = T(kPi) / rc;
  const int rows = a.B * n;

  for (int r = blockIdx.x * warps + warp; r < rows;
       r += gridDim.x * warps) {
    const int i = r % n;
    const size_t frame = (size_t)(r - i) * F;  // node (b, 0)
    const size_t pairs = (size_t)r * n;        // pair (b, i, 0)
    const T* ai = a.a_i + (size_t)r * F;
    const T* dai = kTangent ? a.da_i + (size_t)r * F : nullptr;
    for (int f = lane; f < F; f += 32) {
      nmacc[f] = T(0);
      if (kTangent) dnmacc[f] = T(0);
    }
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < n;
      const T d = valid ? a.dist[pairs + j] : T(1);
      T dd = T(0);
      if constexpr (kTangent) dd = valid ? a.dd[pairs + j] : T(0);
      const T mk = (valid && i != j && d <= rc) ? T(1) : T(0);
      const bool inside = d <= rc;
      const T Sw = inside ? T(0.5) * d_cos(c * d) + T(0.5) : T(0);
      const T S1 = inside ? T(-0.5) * c * d_sin(c * d) : T(0);
      const int np = n - j0 < 32 ? n - j0 : 32;  // senders in the tile
      // The previous tile's message sums have read every lane's X.
      __syncwarp();
      // The tile's a_j (and da_j) rows, contiguous in memory, into X (and
      // X2): a row at a time along f, coalesced; zero past the row's end.
      const size_t node0 = frame + (size_t)j0 * F;
      for (int p = 0; p < 32; ++p) {
        for (int f = lane; f < F; f += 32) {
          if (p < np) {
            __pipeline_memcpy_async(X + p * S + f, a.a_j + node0 + p * F + f,
                                    sizeof(T));
            if constexpr (kTangent)
              __pipeline_memcpy_async(X2 + p * S + f,
                                      a.da_j + node0 + p * F + f, sizeof(T));
          } else {
            X[p * S + f] = T(0);
            if constexpr (kTangent) X2[p * S + f] = T(0);
          }
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();

      // pre = a_i + a_j + W_e emb + b1, s = silu(pre); and tangents. The
      // radial expansion emb (and its tangent, d emb/d dist times dd) is
      // computed in the product, one k at a time.
      auto radial = [&](int k, T& x, T& x2) {
        const T rk = d - s_mu[k];
        const T g = s_gam[k];
        const T G = d_exp(-g * rk * rk);
        x = G * Sw;
        if constexpr (kTangent) x2 = G * (S1 - T(2) * g * rk * Sw) * dd;
      };
      for (int f0 = 0; f0 < F; f0 += C) {
        T acc[C], dacc[C];
        chunk_product<T, C, kTangent>(D, ldt, radial, WeT + f0, acc, dacc);
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int f = f0 + cc;
          if (f < F) {
            const T v = acc[cc] + ai[f] + xr[f] + s_b1[f];
            const T sg = sigmoid(v);
            yr[f] = v * sg;
            if constexpr (kTangent) {
              const T dv = dacc[cc] + dai[f] + x2r[f];
              y2r[f] = sg * (T(1) + v * (T(1) - sg)) * dv;
            }
          }
        }
      }

      // ms = silu(W_m2 s + b_m2), and the attention logit w_att . ms.
      auto s_row = [&](int k, T& x, T& x2) {
        x = yr[k];
        if constexpr (kTangent) x2 = y2r[k];
      };
      T v = batt, dv = T(0);
      for (int f0 = 0; f0 < F; f0 += C) {
        T acc[C], dacc[C];
        chunk_product<T, C, kTangent>(F, ldt, s_row, Wm2T + f0, acc, dacc);
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int f = f0 + cc;
          if (f < F) {
            const T m = acc[cc] + s_bm2[f];
            const T sg = sigmoid(m);
            const T ms = m * sg;
            xr[f] = ms;
            v += ms * s_watt[f];
            if constexpr (kTangent) {
              const T dms = sg * (T(1) + m * (T(1) - sg)) * dacc[cc];
              x2r[f] = dms;
              dv += dms * s_watt[f];
            }
          }
        }
      }
      const T att = sigmoid(v);
      const T datt = att * (T(1) - att) * dv;

      // Masked messages, in place.
      for (int f = 0; f < F; ++f) {
        const T ms = xr[f];
        if constexpr (kTangent) x2r[f] = (x2r[f] * att + ms * datt) * mk;
        xr[f] = ms * att * mk;
      }
      __syncwarp();
      // Their sums over the tile's senders, each lane its own features.
      for (int f = lane; f < F; f += 32) {
        T sum = T(0), dsum = T(0);
        for (int p = 0; p < np; ++p) {
          sum += X[p * S + f];
          if constexpr (kTangent) dsum += X2[p * S + f];
        }
        nmacc[f] += sum;
        if constexpr (kTangent) dnmacc[f] += dsum;
      }

      // Magnitude: t = tanh(w_x2 . silu(W_x1 msg + b_x1)), q its tangent's
      // logit.
      auto msg_row = [&](int k, T& x, T& x2) {
        x = xr[k];
        if constexpr (kTangent) x2 = x2r[k];
      };
      T u = T(0), q = T(0);
      for (int f0 = 0; f0 < F; f0 += C) {
        T acc[C], dacc[C];
        chunk_product<T, C, kTangent>(F, ldt, msg_row, Wx1T + f0, acc, dacc);
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int f = f0 + cc;
          if (f < F) {
            const T z = acc[cc] + s_bx1[f];
            const T sg = sigmoid(z);
            u += z * sg * s_wx2[f];
            if constexpr (kTangent)
              q += sg * (T(1) + z * (T(1) - sg)) * dacc[cc] * s_wx2[f];
          }
        }
      }
      if (valid) {
        const T t = d_tanh(u);
        a.mag[pairs + j] = t * mk;
        if constexpr (kTangent) a.dmag[pairs + j] = (T(1) - t * t) * q * mk;
      }
    }
    for (int f = lane; f < F; f += 32) {
      a.nm[(size_t)r * F + f] = nmacc[f];
      if (kTangent) a.dnm[(size_t)r * F + f] = dnmacc[f];
    }
  }
}

// =========================================================================
// K5: egnn_kernel<T>, the VJP of K4
// =========================================================================

// Offsets of the weight gradients inside one block's sums, in argument
// order: mu, log_gammas, w_e, b1, w_m2, b_m2, w_att, b_att, w_x1, b_x1, w_x2.
struct GradOffsets {
  int mu, lg, w_e, b1, w_m2, b_m2, w_att, b_att, w_x1, b_x1, w_x2, total;
  __host__ __device__ GradOffsets(int F, int D) {
    mu = 0;
    lg = mu + D;
    w_e = lg + D;
    b1 = w_e + F * D;
    w_m2 = b1 + F;
    b_m2 = w_m2 + F * F;
    w_att = b_m2 + F;
    b_att = w_att + F;
    w_x1 = b_att + 1;
    b_x1 = w_x1 + F * F;
    w_x2 = b_x1 + F;
    total = w_x2 + F;
  }
};

// Leading dimension of a K5 weight matrix with rows of K elements in shared
// memory. K + 4 where K is a multiple of 4: rows start on 16 bytes for the
// register-tiled products, and in float32 the 8 lanes of a quarter-warp
// that read 8 consecutive rows hit distinct groups of 4 banks (where K is a
// multiple of 8; two rows share a group otherwise). Else K + 1: the 32
// lanes of the scalar products, reading 32 rows, hit 32 banks.
__host__ __device__ constexpr int weight_ld(int K) {
  return K % 4 ? K + 1 : K + 4;
}

// Whether a product over weights W with rows of K elements, leading
// dimension ldw, takes the register-tiled path: W padded in shared memory
// by weight_ld (weights in device memory have ldw == K).
__device__ __forceinline__ bool tiled_weights(int K, int ldw) {
  return K % 4 == 0 && ldw == weight_ld(K);
}

// K5's shared-memory layout, in elements of T; the host sizes the launch
// with the same arithmetic.
struct Layout {
  int we, wm2, wx1;                             // padded weights (w_smem)
  int mu, gam, b1, bm2, watt, bx1, wx2, batt;   // small vectors
  int gacc;                                     // gradient sums (g_smem)
  int emb, demb;                                // [PT][D]
  int pre, dpre, s, ds, m1, dm1, ms, dms, msg, dmsg, z1, dz1;  // [PT][F]
  int sc;                                       // per-pair scalars
  int red, red_ld;                              // kRed partial-sum slots
  int total;
  static constexpr int kScalars = 15;
  static constexpr int kRed = 4;
  __host__ __device__ Layout(int F, int D, int pt, int w_smem, int g_smem) {
    int at = 0;
    auto take = [&at](int size) {
      int start = at;
      at += (size + 3) & ~3;  // keep every array 16-byte aligned
      return start;
    };
    we = take(w_smem ? F * weight_ld(D) : 0);
    wm2 = take(w_smem ? F * weight_ld(F) : 0);
    wx1 = take(w_smem ? F * weight_ld(F) : 0);
    mu = take(D);
    gam = take(D);
    b1 = take(F);
    bm2 = take(F);
    watt = take(F);
    bx1 = take(F);
    wx2 = take(F);
    batt = take(1);
    gacc = take(g_smem ? GradOffsets(F, D).total : 0);
    emb = take(pt * D);
    demb = take(pt * D);
    pre = take(pt * F);
    dpre = take(pt * F);
    s = take(pt * F);
    ds = take(pt * F);
    m1 = take(pt * F);
    dm1 = take(pt * F);
    ms = take(pt * F);
    dms = take(pt * F);
    msg = take(pt * F);
    dmsg = take(pt * F);
    z1 = take(pt * F);
    dz1 = take(pt * F);
    sc = take(kScalars * pt);
    red_ld = kThreads > F ? kThreads : F;  // partials of a phase's sum
    red_ld = red_ld > D ? red_ld : D;
    red = take(kRed * red_ld);
    total = at;
  }
};

// Four consecutive elements of shared memory, 16-byte aligned: one 16-byte
// load in float32, two in float64.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int h = 0; h < 4; h += V) {
    T w[V];
    load16(p + h, w);
#pragma unroll
    for (int q = 0; q < V; ++q) v[h + q] = w[q];
  }
}

// mm_abt register-tiled, for N and K multiples of 4 and W padded in shared
// memory: each thread owns TP pairs by the 4 columns f = g + c N/4, for A
// and A2. Per 4 k, 16-byte loads of its 4 weight rows W[f][k..] and of
// A[p][k..], A2[p][k..] (broadcasts) feed 64 multiply-adds. The lanes take
// consecutive g, so a quarter-warp reads 8 consecutive rows, which
// weight_ld puts in distinct bank groups. Each output sums over k in order,
// as the scalar path does.
template <typename T, typename Epi>
__device__ __forceinline__ void mm_abt_tiled(int pt, int N, int K, const T* A,
                                             const T* A2, const T* W, int ldw,
                                             Epi epi) {
  const int ng = N / 4;
  const int items = (pt / TP) * ng;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int g = idx % ng;
    const int p0 = (idx / ng) * TP;
    T acc[TP][4], acc2[TP][4];
#pragma unroll
    for (int m = 0; m < TP; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = acc2[m][c] = T(0);
    for (int k = 0; k < K; k += 4) {
      T a[TP][4], a2[TP][4];
#pragma unroll
      for (int m = 0; m < TP; ++m) {
        load4(A + (p0 + m) * K + k, a[m]);
        load4(A2 + (p0 + m) * K + k, a2[m]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T w[4];
        load4(W + (g + c * ng) * ldw + k, w);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int m = 0; m < TP; ++m) {
            acc[m][c] += a[m][q] * w[q];
            acc2[m][c] += a2[m][q] * w[q];
          }
      }
    }
#pragma unroll
    for (int m = 0; m < TP; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        epi(p0 + m, g + c * ng, acc[m][c], acc2[m][c]);
  }
}

// out(p, f) for p < pt, f < N: acc = sum_k A[p][k] W[f][k] (A W^T), and
// acc2 the same product of A2 (the tangent) on the same weight loads;
// epi(p, f, acc, acc2) consumes them.
template <typename T, typename Epi>
__device__ __forceinline__ void mm_abt(int pt, int N, int K, const T* A,
                                       const T* A2, const T* W, int ldw,
                                       Epi epi) {
  if (tiled_weights(K, ldw) && N % 4 == 0) {
    mm_abt_tiled<T>(pt, N, K, A, A2, W, ldw, epi);
    return;
  }
  const int items = (pt / PM) * N;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int f = idx % N;
    const int p0 = (idx / N) * PM;
    T acc[PM], acc2[PM];
    for (int m = 0; m < PM; ++m) acc[m] = acc2[m] = T(0);
    const T* w = W + f * ldw;
    for (int k = 0; k < K; ++k) {
      const T wk = w[k];
      for (int m = 0; m < PM; ++m) {
        acc[m] += A[(p0 + m) * K + k] * wk;
        acc2[m] += A2[(p0 + m) * K + k] * wk;
      }
    }
    for (int m = 0; m < PM; ++m) epi(p0 + m, f, acc[m], acc2[m]);
  }
}

// mm_ab2 register-tiled, for K and N multiples of 4 and W padded in shared
// memory: each thread owns TP pairs by 4 consecutive columns k0.., for A and
// A2. Per 4 f, four 16-byte loads of W[f][k0..] (consecutive across lanes)
// and 2 TP of A[p][f..], A2[p][f..] (broadcasts) feed 64 multiply-adds.
// Each output sums over f in order, as the scalar path does.
template <typename T, typename Epi>
__device__ __forceinline__ void mm_ab2_tiled(int pt, int K, int N, const T* A,
                                             const T* A2, const T* W, int ldw,
                                             Epi epi) {
  const int kb = K / 4;
  const int items = (pt / TP) * kb;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int k0 = (idx % kb) * 4;
    const int p0 = (idx / kb) * TP;
    T acc[TP][4], acc2[TP][4];
#pragma unroll
    for (int m = 0; m < TP; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = acc2[m][c] = T(0);
    for (int f = 0; f < N; f += 4) {
      T a[TP][4], a2[TP][4];
#pragma unroll
      for (int m = 0; m < TP; ++m) {
        load4(A + (p0 + m) * N + f, a[m]);
        load4(A2 + (p0 + m) * N + f, a2[m]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        T w[4];
        load4(W + (f + q) * ldw + k0, w);
#pragma unroll
        for (int m = 0; m < TP; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][c] += a[m][q] * w[c];
            acc2[m][c] += a2[m][q] * w[c];
          }
      }
    }
#pragma unroll
    for (int m = 0; m < TP; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) epi(p0 + m, k0 + c, acc[m][c], acc2[m][c]);
  }
}

// out(p, k) for p < pt, k < K: acc = sum_f A[p][f] W[f][k] (A W), twice.
template <typename T, typename Epi>
__device__ __forceinline__ void mm_ab2(int pt, int K, int N, const T* A,
                                       const T* A2, const T* W, int ldw,
                                       Epi epi) {
  if (tiled_weights(K, ldw) && N % 4 == 0) {
    mm_ab2_tiled<T>(pt, K, N, A, A2, W, ldw, epi);
    return;
  }
  const int items = (pt / PM) * K;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int k = idx % K;
    const int p0 = (idx / K) * PM;
    T acc[PM], acc2[PM];
    for (int m = 0; m < PM; ++m) acc[m] = acc2[m] = T(0);
    for (int f = 0; f < N; ++f) {
      const T wk = W[f * ldw + k];
      for (int m = 0; m < PM; ++m) {
        acc[m] += A[(p0 + m) * N + f] * wk;
        acc2[m] += A2[(p0 + m) * N + f] * wk;
      }
    }
    for (int m = 0; m < PM; ++m) epi(p0 + m, k, acc[m], acc2[m]);
  }
}

// mm_atb2 register-tiled, for N and K multiples of 4: each thread owns a
// 4 x 4 block of G (rows f0.., columns k0..); per pair, 16-byte loads of
// A1[p][f0..], A2[p][f0..], B1[p][k0..] and B2[p][k0..] feed 32
// multiply-adds. The lanes of a warp share f0 and take consecutive k0, so
// the A loads are broadcasts. Each output sums over p in order, as the
// scalar path does.
template <typename T>
__device__ __forceinline__ void mm_atb2_tiled(int pt, int N, int K,
                                              const T* A1, const T* B1,
                                              const T* A2, const T* B2,
                                              T* G) {
  const int kb = K / 4;
  const int items = (N / 4) * kb;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int k0 = (idx % kb) * 4;
    const int f0 = (idx / kb) * 4;
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
    for (int p = 0; p < pt; ++p) {
      T a1[4], a2[4], b1[4], b2[4];
      load4(A1 + p * N + f0, a1);
      load4(A2 + p * N + f0, a2);
      load4(B1 + p * K + k0, b1);
      load4(B2 + p * K + k0, b2);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += a1[r] * b1[c] + a2[r] * b2[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) G[(f0 + r) * K + k0 + c] += acc[r][c];
  }
}

// G[f][k] += sum_p A1[p][f] B1[p][k] + A2[p][f] B2[p][k] for f < N, k < K
// (A^T B, the weight gradients); each thread owns PM rows of one column.
template <typename T>
__device__ __forceinline__ void mm_atb2(int pt, int N, int K, const T* A1,
                                        const T* B1, const T* A2,
                                        const T* B2, T* G) {
  if (N % 4 == 0 && K % 4 == 0) {
    mm_atb2_tiled<T>(pt, N, K, A1, B1, A2, B2, G);
    return;
  }
  const int items = (N / PM) * K;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int k = idx % K;
    const int f0 = (idx / K) * PM;
    T acc[PM];
    for (int m = 0; m < PM; ++m) acc[m] = T(0);
    for (int p = 0; p < pt; ++p) {
      const T b1 = B1[p * K + k];
      const T b2 = B2[p * K + k];
      for (int m = 0; m < PM; ++m)
        acc[m] += A1[p * N + f0 + m] * b1 + A2[p * N + f0 + m] * b2;
    }
    for (int m = 0; m < PM; ++m) G[(f0 + m) * K + k] += acc[m];
  }
  // Rows beyond the last multiple of PM.
  const int rest = N % PM;
  for (int idx = threadIdx.x; idx < rest * K; idx += blockDim.x) {
    const int k = idx % K;
    const int f = N - rest + idx / K;
    T acc = T(0);
    for (int p = 0; p < pt; ++p)
      acc += A1[p * N + f] * B1[p * K + k] + A2[p * N + f] * B2[p * K + k];
    G[f * K + k] += acc;
  }
}

// Sums over each pair's row of `len` elements (features, or k), on all
// threads: nt / pt threads per pair, thread (p, h) = (tid % pt, tid / pt)
// taking the elements g = h, h + nt/pt, ... in order, rotated by the pair
// (f = g + p max(1, 32/pt), modulo len), so that the lanes of a warp,
// which hold consecutive pairs, read distinct banks of the rows (float32,
// len a multiple of 32; at most a few lanes share a bank otherwise).
// term(p, f, acc) adds element (p, f)'s Q terms; the partials go to
// red[q * ld + h * pt + p], and pair_sums combines them after a barrier.
template <typename T, int Q, typename Term>
__device__ __forceinline__ void pair_partials(int pt, int len, T* red,
                                              int ld, Term term) {
  const int tpp = blockDim.x / pt;
  const int p = threadIdx.x % pt, h = threadIdx.x / pt;
  const int rot = p * (pt < 32 ? 32 / pt : 1) % len;
  T acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = T(0);
  for (int g = h; g < len; g += tpp) {
    const int f = g + rot < len ? g + rot : g + rot - len;
    term(p, f, acc);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) red[q * ld + h * pt + p] = acc[q];
}

// Pair p's Q sums from pair_partials, over h in order.
template <typename T, int Q>
__device__ __forceinline__ void pair_sums(int pt, const T* red, int ld,
                                          int p, T (&sum)[Q]) {
  const int tpp = blockDim.x / pt;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    sum[q] = T(0);
    for (int h = 0; h < tpp; ++h) sum[q] += red[q * ld + h * pt + p];
  }
}

// Work over a tile's elements by columns (features, or k), on all
// threads: runs = max(1, nt / cols) threads per column, thread idx taking
// column c = idx % cols and the pairs p0 <= p < p1 of run idx / cols, in
// order (the lanes of a warp take consecutive columns: distinct banks).
// body(idx, c, p0, p1); a sum over pairs per column stores its partial at
// red[q * ld + idx], and column_sum combines them after a barrier.
template <typename Body>
__device__ __forceinline__ void column_runs(int pt, int cols, Body body) {
  const int nt = blockDim.x;
  const int runs = cols < nt ? nt / cols : 1;
  const int len = (pt + runs - 1) / runs;
  for (int idx = threadIdx.x; idx < runs * cols; idx += nt) {
    const int start = idx / cols * len;
    const int p0 = start < pt ? start : pt;
    const int p1 = start + len < pt ? start + len : pt;
    body(idx, idx % cols, p0, p1);
  }
}

// Column c's sum from column_runs, over the runs in order.
template <typename T>
__device__ __forceinline__ T column_sum(int cols, const T* red, int c) {
  const int runs = cols < (int)blockDim.x ? blockDim.x / cols : 1;
  T sum = T(0);
  for (int r = 0; r < runs; ++r) sum += red[r * cols + c];
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
egnn_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int n = a.n, F = a.F, D = a.D, pt = a.pt;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L(F, D, pt, a.w_smem, a.g_smem);
  const GradOffsets GO(F, D);
  const T rc = a.rc;
  const T c = T(kPi) / rc;

  // Weights: padded copies in shared memory, or device memory as given.
  const T *We = a.w_e, *Wm2 = a.w_m2, *Wx1 = a.w_x1;
  int ldwe = D, ldwm2 = F, ldwx1 = F;
  if (a.w_smem) {
    for (int e = tid; e < F * D; e += nt)
      sm[L.we + (e / D) * weight_ld(D) + e % D] = a.w_e[e];
    for (int e = tid; e < F * F; e += nt) {
      sm[L.wm2 + (e / F) * weight_ld(F) + e % F] = a.w_m2[e];
      sm[L.wx1 + (e / F) * weight_ld(F) + e % F] = a.w_x1[e];
    }
    We = sm + L.we;
    Wm2 = sm + L.wm2;
    Wx1 = sm + L.wx1;
    ldwe = weight_ld(D);
    ldwm2 = ldwx1 = weight_ld(F);
  }
  T* s_mu = sm + L.mu;
  T* s_gam = sm + L.gam;
  T* s_b1 = sm + L.b1;
  T* s_bm2 = sm + L.bm2;
  T* s_watt = sm + L.watt;
  T* s_bx1 = sm + L.bx1;
  T* s_wx2 = sm + L.wx2;
  for (int k = tid; k < D; k += nt) {
    s_mu[k] = a.mu[k];
    s_gam[k] = d_exp(a.lg[k]);
  }
  for (int f = tid; f < F; f += nt) {
    s_b1[f] = a.b1[f];
    s_bm2[f] = a.b_m2[f];
    s_watt[f] = a.w_att[f];
    s_bx1[f] = a.b_x1[f];
    s_wx2[f] = a.w_x2[f];
  }
  const T batt = a.b_att[0];

  // Per-pair tile arrays and scalars.
  T* emb = sm + L.emb;
  T* demb = sm + L.demb;
  T* pre = sm + L.pre;
  T* dpre = sm + L.dpre;
  T* s = sm + L.s;
  T* ds = sm + L.ds;
  T* m1 = sm + L.m1;
  T* dm1 = sm + L.dm1;
  T* ms = sm + L.ms;
  T* dms = sm + L.dms;
  T* msg = sm + L.msg;
  T* dmsg = sm + L.dmsg;
  T* z1 = sm + L.z1;
  T* dz1 = sm + L.dz1;
  T* sd = sm + L.sc;           // distance
  T* sdd = sd + pt;            // its tangent
  T* smask = sdd + pt;         // mask (0 or 1; 0 beyond the row's end)
  T* satt = smask + pt;        // attention
  T* sdv = satt + pt;          // tangent of the attention logit
  T* sdatt = sdv + pt;         // tangent of the attention
  T* st = sdatt + pt;          // tanh of the magnitude logit
  T* sq = st + pt;             // tangent of the magnitude logit
  T* sgq = sq + pt;            // K5: cotangent of q
  T* sgu = sgq + pt;           // K5: cotangent of the magnitude logit
  T* sgdv = sgu + pt;          // K5: cotangent of dv
  T* sgv = sgdv + pt;          // K5: cotangent of the attention logit
  T* sS = sgv + pt;            // cutoff switch S(d) = (cos(c d) + 1) / 2
  T* sS1 = sS + pt;            // S'(d)
  T* sS2 = sS1 + pt;           // S''(d)
  T* red = sm + L.red;         // partial sums
  const int ld = L.red_ld;

  // Zero this frame's accumulated outputs and the gradient sums.
  const size_t node0 = (size_t)b * n * F;
  const size_t pair0 = (size_t)b * n * n;
  T* gacc = nullptr;
  {
    gacc = a.g_smem ? sm + L.gacc : a.partials + (size_t)b * GO.total;
    for (int e = tid; e < GO.total; e += nt) gacc[e] = T(0);
    for (int e = tid; e < n * F; e += nt) {
      a.g_a_i[node0 + e] = T(0);
      a.g_a_j[node0 + e] = T(0);
      a.g_da_i[node0 + e] = T(0);
      a.g_da_j[node0 + e] = T(0);
    }
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    for (int j0 = 0; j0 < n; j0 += pt) {
      // ---- the forward (and tangent) chain of one tile -------------------
      for (int p = tid; p < pt; p += nt) {
        const int j = j0 + p;
        const bool valid = j < n;
        const T d = valid ? a.dist[pair0 + i * n + j] : T(1);
        sd[p] = d;
        smask[p] = (valid && i != j && d <= rc) ? T(1) : T(0);
        sdd[p] = valid ? a.dd[pair0 + i * n + j] : T(0);
        const bool inside = d <= rc;
        T sn, cs;
        d_sincos(c * d, &sn, &cs);
        sS[p] = inside ? T(0.5) * cs + T(0.5) : T(0);
        sS1[p] = inside ? T(-0.5) * c * sn : T(0);
        sS2[p] = inside ? T(-0.5) * c * c * cs : T(0);
      }
      __syncthreads();

      // Radial expansion (and its tangent, d emb/d dist times dd), on the
      // pair's switching terms.
      for (int e = tid; e < pt * D; e += nt) {
        const int p = e / D, k = e % D;
        const T r = sd[p] - s_mu[k];
        const T g = s_gam[k];
        const T G = d_exp(-g * r * r);
        const T S = sS[p];
        emb[e] = G * S;
        demb[e] = G * (sS1[p] - T(2) * g * r * S) * sdd[p];
      }
      __syncthreads();

      // pre = a_i + a_j + W_e emb + b1, s = silu(pre); and tangents.
      {
        auto epi = [&](int p, int f, T acc, T dacc) {
          const int j = j0 + p;
          const bool valid = j < n;
          const T v = acc + a.a_i[node0 + i * F + f] +
                      (valid ? a.a_j[node0 + j * F + f] : T(0)) + s_b1[f];
          const T sg = sigmoid(v);
          s[p * F + f] = v * sg;
          pre[p * F + f] = v;
          {
            const T dv = dacc + a.da_i[node0 + i * F + f] +
                         (valid ? a.da_j[node0 + j * F + f] : T(0));
            ds[p * F + f] = sg * (T(1) + v * (T(1) - sg)) * dv;
            dpre[p * F + f] = dv;
          }
        };
        mm_abt<T>(pt, F, D, emb, demb, We, ldwe, epi);
      }
      __syncthreads();

      // m1 = W_m2 s + b_m2, ms = silu(m1); and tangents.
      {
        auto epi = [&](int p, int f, T acc, T dacc) {
          const T v = acc + s_bm2[f];
          const T sg = sigmoid(v);
          ms[p * F + f] = v * sg;
          m1[p * F + f] = v;
          {
            dms[p * F + f] = sg * (T(1) + v * (T(1) - sg)) * dacc;
            dm1[p * F + f] = dacc;
          }
        };
        mm_abt<T>(pt, F, F, s, ds, Wm2, ldwm2, epi);
      }
      __syncthreads();

      // Attention per pair: its logit and tangent summed over the features
      // on all threads, then combined per pair.
      pair_partials<T, 2>(pt, F, red, ld, [&](int p, int f, T(&acc)[2]) {
        acc[0] += ms[p * F + f] * s_watt[f];
        acc[1] += dms[p * F + f] * s_watt[f];
      });
      __syncthreads();
      for (int p = tid; p < pt; p += nt) {
        T sum[2];
        pair_sums<T, 2>(pt, red, ld, p, sum);
        const T v = batt + sum[0], dv = sum[1];
        const T att = sigmoid(v);
        satt[p] = att;
        {
          sdv[p] = dv;
          sdatt[p] = att * (T(1) - att) * dv;
        }
      }
      __syncthreads();

      // Masked messages.
      for (int e = tid; e < pt * F; e += nt) {
        const int p = e / F;
        const T mk = smask[p], att = satt[p];
        msg[e] = ms[e] * att * mk;
        dmsg[e] = (dms[e] * att + ms[e] * sdatt[p]) * mk;
      }
      __syncthreads();

      // z1 = W_x1 msg + b_x1; and its tangent.
      {
        auto epi = [&](int p, int f, T acc, T dacc) {
          z1[p * F + f] = acc + s_bx1[f];
          dz1[p * F + f] = dacc;
        };
        mm_abt<T>(pt, F, F, msg, dmsg, Wx1, ldwx1, epi);
      }
      __syncthreads();

      // Magnitudes: t = tanh(w_x2 . silu(z1)), q its tangent's logit;
      // summed over the features on all threads, then combined per pair.
      pair_partials<T, 2>(pt, F, red, ld, [&](int p, int f, T(&acc)[2]) {
        const T z = z1[p * F + f];
        const T sg = sigmoid(z);
        acc[0] += z * sg * s_wx2[f];
        acc[1] += sg * (T(1) + z * (T(1) - sg)) * dz1[p * F + f] * s_wx2[f];
      });
      __syncthreads();
      for (int p = tid; p < pt; p += nt) {
        T sum[2];
        pair_sums<T, 2>(pt, red, ld, p, sum);
        st[p] = d_tanh(sum[0]);
        sq[p] = sum[1];
      }
      __syncthreads();
      {
        // ---- K5: the VJP of the tile's chain --------------------------------
        // Cotangents of q and of the magnitude logit u.
        for (int p = tid; p < pt; p += nt) {
          const int j = j0 + p;
          const bool valid = j < n;
          const T gm = valid ? a.g_mag[pair0 + i * n + j] : T(0);
          const T gdm = valid ? a.g_dmag[pair0 + i * n + j] : T(0);
          const T mk = smask[p], t = st[p];
          sgq[p] = gdm * mk * (T(1) - t * t);
          const T gt = gdm * mk * sq[p] * (T(-2) * t) + gm * mk;
          sgu[p] = gt * (T(1) - t * t);
        }
        __syncthreads();

        // z1, dz1 -> their cotangents (in place); sums for w_x2 and b_x1
        // over each column's runs of pairs, combined in the next phase.
        column_runs(pt, F, [&](int idx, int f, int p0, int p1) {
          const T w = s_wx2[f];
          T gw = T(0), gb = T(0);
          for (int p = p0; p < p1; ++p) {
            const T z = z1[p * F + f];
            const T dz = dz1[p * F + f];
            const T sg = sigmoid(z);
            const T s1 = sg * (T(1) + z * (T(1) - sg));
            const T s2 = sg * (T(1) - sg) * (T(2) + z * (T(1) - T(2) * sg));
            const T gq = sgq[p], gu = sgu[p];
            gw += gq * s1 * dz + gu * z * sg;
            const T gz = gq * w * dz * s2 + gu * w * s1;
            gb += gz;
            z1[p * F + f] = gz;
            dz1[p * F + f] = gq * w * s1;
          }
          red[idx] = gw;
          red[ld + idx] = gb;
        });
        __syncthreads();

        // grad W_x1 += gdz1^T dmsg + gz1^T msg; the sums for w_x2, b_x1.
        for (int e = tid; e < 2 * F; e += nt) {
          const int q = e / F, f = e % F;
          gacc[(q ? GO.b_x1 : GO.w_x2) + f] += column_sum(F, red + q * ld, f);
        }
        mm_atb2<T>(pt, F, F, dz1, dmsg, z1, msg, gacc + GO.w_x1);
        __syncthreads();

        // Cotangents of msg and dmsg (into msg, dmsg).
        {
          auto epi = [&](int p, int g, T acc, T dacc) {
            msg[p * F + g] = a.g_nm[node0 + i * F + g] + acc;
            dmsg[p * F + g] = a.g_dnm[node0 + i * F + g] + dacc;
          };
          mm_ab2<T>(pt, F, F, z1, dz1, Wx1, ldwx1, epi);
        }
        __syncthreads();

        // Cotangents of the attention logit v and its tangent dv: sums over
        // the features on all threads, then combined per pair.
        pair_partials<T, 2>(pt, F, red, ld, [&](int p, int f, T(&acc)[2]) {
          const int e = p * F + f;
          acc[0] += dmsg[e] * ms[e];
          acc[1] += dmsg[e] * dms[e] + msg[e] * ms[e];
        });
        __syncthreads();
        for (int p = tid; p < pt; p += nt) {
          T sum[2];
          pair_sums<T, 2>(pt, red, ld, p, sum);
          const T mk = smask[p], att = satt[p];
          const T sa = att * (T(1) - att);
          const T gdatt = sum[0] * mk;
          const T gatt = sum[1] * mk;
          sgdv[p] = gdatt * sa;
          sgv[p] = gdatt * sa * (T(1) - T(2) * att) * sdv[p] + gatt * sa;
        }
        __syncthreads();

        // Sums for w_att and b_att; m1, dm1 -> their cotangents (in place),
        // and their sums for b_m2; over each column's runs of pairs (b_att
        // on column 0's), combined in the next phase.
        column_runs(pt, F, [&](int idx, int f, int p0, int p1) {
          const T watt = s_watt[f];
          T gw = T(0), gbm = T(0), gba = T(0);
          for (int p = p0; p < p1; ++p) {
            const int e = p * F + f;
            gw += sgdv[p] * dms[e] + sgv[p] * ms[e];
            gba += sgv[p];
            const T mk = smask[p], att = satt[p];
            const T gdms = mk * att * dmsg[e] + sgdv[p] * watt;
            const T gms = mk * (sdatt[p] * dmsg[e] + att * msg[e]) +
                          sgv[p] * watt;
            const T m = m1[e];
            const T sg = sigmoid(m);
            const T s1 = sg * (T(1) + m * (T(1) - sg));
            const T s2 = sg * (T(1) - sg) * (T(2) + m * (T(1) - T(2) * sg));
            const T gm = gdms * dm1[e] * s2 + gms * s1;
            m1[e] = gm;
            dm1[e] = gdms * s1;
            gbm += gm;
          }
          red[idx] = gw;
          red[ld + idx] = gbm;
          if (f == 0) red[2 * ld + idx] = gba;
        });
        __syncthreads();

        // grad W_m2 += gdm1^T ds + gm1^T s; the sums for w_att, b_att, b_m2.
        for (int e = tid; e <= 2 * F; e += nt) {
          const int q = e / F, f = e % F;
          gacc[(q == 0 ? GO.w_att : q == 1 ? GO.b_m2 : GO.b_att) + f] +=
              column_sum(F, red + q * ld, f);
        }
        mm_atb2<T>(pt, F, F, dm1, ds, m1, s, gacc + GO.w_m2);
        __syncthreads();

        // Cotangents of s, ds, then of pre, dpre (into s, ds).
        {
          auto epi = [&](int p, int f, T gs, T gds) {
            const T v = pre[p * F + f];
            const T sg = sigmoid(v);
            const T s1 = sg * (T(1) + v * (T(1) - sg));
            const T s2 = sg * (T(1) - sg) * (T(2) + v * (T(1) - T(2) * sg));
            s[p * F + f] = gds * dpre[p * F + f] * s2 + gs * s1;
            ds[p * F + f] = gds * s1;
          };
          mm_ab2<T>(pt, F, F, m1, dm1, Wm2, ldwm2, epi);
        }
        __syncthreads();

        // Sums into b1, a_i, da_i (this row), a_j, da_j (the tile's senders);
        // grad W_e += gdpre^T demb + gpre^T emb.
        // Each column's runs of pairs, the sums combined in the next phase;
        // the senders' sums in device memory four pairs at a time, every
        // load before any store, so that the loads overlap.
        column_runs(pt, F, [&](int idx, int f, int p0, int p1) {
          T gp = T(0), gdp = T(0);
          for (int p4 = p0; p4 < p1; p4 += 4) {
            T aj[4], daj[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int p = p4 + u;
              const size_t at = node0 + (size_t)(j0 + p) * F + f;
              const bool sender = p < p1 && j0 + p < n;
              aj[u] = sender ? a.g_a_j[at] : T(0);
              daj[u] = sender ? a.g_da_j[at] : T(0);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int p = p4 + u;
              if (p < p1) {
                const int e = p * F + f;
                gp += s[e];
                gdp += ds[e];
                if (j0 + p < n) {
                  const size_t at = node0 + (size_t)(j0 + p) * F + f;
                  a.g_a_j[at] = aj[u] + s[e];
                  a.g_da_j[at] = daj[u] + ds[e];
                }
              }
            }
          }
          red[idx] = gp;
          red[ld + idx] = gdp;
        });
        mm_atb2<T>(pt, F, D, ds, demb, s, emb, gacc + GO.w_e);
        __syncthreads();

        // Cotangents of emb and demb (into emb, demb); the sums for b1,
        // a_i, da_i.
        for (int e = tid; e < 2 * F; e += nt) {
          const int q = e / F, f = e % F;
          T* g = q ? a.g_da_i : a.g_a_i;
          const size_t at = node0 + i * F + f;
          const T old = g[at];
          const T gp = column_sum(F, red + q * ld, f);
          if (q == 0) gacc[GO.b1 + f] += gp;
          g[at] = old + gp;
        }
        {
          auto epi = [&](int p, int k, T gemb, T gdemb) {
            emb[p * D + k] = gemb;
            demb[p * D + k] = gdemb;
          };
          mm_ab2<T>(pt, D, F, s, ds, We, ldwe, epi);
        }
        __syncthreads();

        // The radial chain: sums for mu and log_gammas per k, and each
        // (pair, k) term of the distance and tangent gradients; over each
        // column's runs of pairs, on the pairs' switching terms, the sums
        // combined in the next phase.
        column_runs(pt, D, [&](int idx, int k, int p0, int p1) {
          const T g = s_gam[k], mu = s_mu[k];
          T gmu = T(0), glg = T(0);
          for (int p = p0; p < p1; ++p) {
            const T r = sd[p] - mu;
            const T G = d_exp(-g * r * r);
            const T S = sS[p], S1 = sS1[p], S2 = sS2[p];
            const T ep = G * (S1 - T(2) * g * r * S);
            const T gemb = emb[p * D + k], gdemb = demb[p * D + k];
            const T gep = gdemb * sdd[p];
            const T dep_dd = G * (S2 - T(4) * g * r * S1 +
                                  (T(4) * g * g * r * r - T(2) * g) * S);
            const T dep_dmu = G * (T(2) * g * r * S1 -
                                   T(4) * g * g * r * r * S + T(2) * g * S);
            const T dep_dlg = g * G * (-r * r * S1 +
                                       T(2) * g * r * r * r * S -
                                       T(2) * r * S);
            gmu += gemb * T(2) * g * r * G * S + gep * dep_dmu;
            glg += gemb * (-g * r * r * G * S) + gep * dep_dlg;
            emb[p * D + k] = gemb * ep + gep * dep_dd;
            demb[p * D + k] = gdemb * ep;
          }
          red[idx] = gmu;
          red[ld + idx] = glg;
        });
        __syncthreads();

        // Distance gradients: sums over k on all threads, then combined
        // per pair; the sums for mu and log_gammas.
        for (int e = tid; e < 2 * D; e += nt) {
          const int q = e / D, k = e % D;
          gacc[(q ? GO.lg : GO.mu) + k] += column_sum(D, red + q * ld, k);
        }
        T* red2 = red + 2 * ld;
        pair_partials<T, 2>(pt, D, red2, ld, [&](int p, int k, T(&acc)[2]) {
          acc[0] += emb[p * D + k];
          acc[1] += demb[p * D + k];
        });
        __syncthreads();
        for (int p = tid; p < pt; p += nt) {
          const int j = j0 + p;
          if (j < n) {
            T sum[2];
            pair_sums<T, 2>(pt, red2, ld, p, sum);
            a.g_dist[pair0 + i * n + j] = sum[0];
            a.g_dd[pair0 + i * n + j] = sum[1];
          }
        }
        __syncthreads();
      }
    }
  }

  if (a.g_smem) {
    T* out = a.partials + (size_t)b * GO.total;
    for (int e = tid; e < GO.total; e += nt) out[e] = gacc[e];
  }
}

// out[e] = sum over the frames of partials[b][e], in frame order.
template <typename T>
__global__ void reduce_partials(const T* partials, T* out, int B, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  T acc = T(0);
  for (int b = 0; b < B; ++b) acc += partials[(size_t)b * total + e];
  out[e] = acc;
}

// Binds the C interface's pointers: the 14 primals, then (K4, K5) the
// tangents of a_i, a_j, dist, then (K5) the four cotangents; the outputs
// nm, mag (K3), then dnm, dmag (K4), or K5's six per-frame gradients and
// the weight gradients.
template <typename T>
Args<T> bind(const void* const* in, void* const* out, void* scratch,
             int n_in, int B, int n, int F, int D, double rc) {
  Args<T> a = {};
  const T* const* x = reinterpret_cast<const T* const*>(in);
  T* const* y = reinterpret_cast<T* const*>(out);
  a.a_i = x[0]; a.a_j = x[1]; a.dist = x[2]; a.mu = x[3]; a.lg = x[4];
  a.w_e = x[5]; a.b1 = x[6]; a.w_m2 = x[7]; a.b_m2 = x[8]; a.w_att = x[9];
  a.b_att = x[10]; a.w_x1 = x[11]; a.b_x1 = x[12]; a.w_x2 = x[13];
  if (n_in > 14) { a.da_i = x[14]; a.da_j = x[15]; a.dd = x[16]; }
  if (n_in > 17) {
    a.g_nm = x[17]; a.g_mag = x[18]; a.g_dnm = x[19]; a.g_dmag = x[20];
    a.g_a_i = y[0]; a.g_a_j = y[1]; a.g_dist = y[2];
    a.g_da_i = y[3]; a.g_da_j = y[4]; a.g_dd = y[5];
    a.partials = static_cast<T*>(scratch);
  } else {
    a.nm = y[0]; a.mag = y[1];
    if (n_in > 14) { a.dnm = y[2]; a.dmag = y[3]; }
  }
  a.B = B; a.n = n; a.F = F; a.D = D; a.rc = T(rc);
  return a;
}

// The forward kernel's launch: the most warps per block (up to
// fwd_max_warps) whose shared memory fits, the blocks per SM that
// occupancy allows, and a persistent grid of at most SMs x that.
struct FwdConfig {
  int warps, blocks_per_sm, sms, grid;
  size_t bytes;
};

template <typename T, bool kTangent>
int configure_fwd(int device, int rows, int F, int D, FwdConfig& cfg) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&cfg.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  cfg.warps = 0;
  for (int w = fwd_max_warps<kTangent>(); w >= 1 && !cfg.warps; --w) {
    const FwdLayout L(F, D, fwd_chunk<T>(), kTangent, w);
    cfg.bytes = sizeof(T) * (size_t)L.total;
    if (cfg.bytes <= (size_t)limit) cfg.warps = w;
  }
  if (!cfg.warps) return -1;
  err = cudaFuncSetAttribute(egnn_fwd_kernel<T, kTangent>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cfg.bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &cfg.blocks_per_sm, egnn_fwd_kernel<T, kTangent>, cfg.warps * 32,
      cfg.bytes);
  if (err != cudaSuccess) return err;
  if (cfg.blocks_per_sm < 1) return -1;
  const int wanted = (rows + cfg.warps - 1) / cfg.warps;
  const int resident = cfg.sms * cfg.blocks_per_sm;
  cfg.grid = wanted < resident ? wanted : resident;
  return 0;
}

template <typename T, bool kTangent>
int launch_fwd(int device, const void* const* in, void* const* out, int B,
               int n, int F, int D, double rc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args<T> a = bind<T>(in, out, nullptr, kTangent ? 17 : 14, B, n, F,
                            D, rc);
  FwdConfig cfg;
  const int status = configure_fwd<T, kTangent>(device, B * n, F, D, cfg);
  if (status != 0) return status;
  egnn_fwd_kernel<T, kTangent><<<cfg.grid, cfg.warps * 32, cfg.bytes,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// K5: the largest configuration that fits: every tile size with weights
// and gradient sums in shared memory first, then without them.
template <typename T>
int configure(int device, int F, int D, Args<T>& a, size_t& bytes) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int placements[3][2] = {{1, 1}, {1, 0}, {0, 0}};
  for (const auto& place : placements) {
    for (int pt = 32; pt >= PM; pt /= 2) {
      const Layout L(F, D, pt, place[0], place[1]);
      bytes = sizeof(T) * (size_t)L.total;
      if (bytes <= (size_t)limit) {
        a.pt = pt;
        a.w_smem = place[0];
        a.g_smem = place[1];
        return 0;
      }
    }
  }
  return -1;
}

template <typename T>
int launch_k5(int device, const void* const* in, void* const* out,
              void* scratch, int B, int n, int F, int D, double rc,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args<T> a = bind<T>(in, out, scratch, 21, B, n, F, D, rc);
  size_t bytes = 0;
  const int status = configure<T>(device, F, D, a, bytes);
  if (status != 0) return status;
  err = cudaFuncSetAttribute(egnn_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  egnn_kernel<T><<<B, kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = GradOffsets(F, D).total;
  reduce_partials<T><<<(total + 255) / 256, 256, 0, s>>>(
      a.partials, reinterpret_cast<T* const*>(out)[6], B, total);
  return cudaGetLastError();
}

template <bool kTangent>
int fwd_info(int dtype, int device, int rows, int F, int D, int* info) {
  FwdConfig cfg;
  const int status =
      dtype == 0 ? configure_fwd<float, kTangent>(device, rows, F, D, cfg)
                 : configure_fwd<double, kTangent>(device, rows, F, D, cfg);
  if (status != 0) return status;
  info[0] = cfg.warps;
  info[1] = cfg.blocks_per_sm;
  info[2] = (int)cfg.bytes;
  info[3] = cfg.grid;
  return 0;
}

template <typename T>
int k5_info(int device, int F, int D, int* info) {
  Args<T> a = {};
  size_t bytes = 0;
  const int status = configure<T>(device, F, D, a, bytes);
  if (status != 0) return status;
  info[0] = a.pt;
  info[1] = a.w_smem;
  info[2] = a.g_smem;
  info[3] = (int)bytes;
  return 0;
}

}  // namespace

extern "C" {

int egnn_k3(int dtype, int device, const void* const* in, void* const* out,
            void* scratch, int B, int n, int F, int D, double rc,
            void* stream) {
  if (dtype == 0)
    return launch_fwd<float, false>(device, in, out, B, n, F, D, rc, stream);
  return launch_fwd<double, false>(device, in, out, B, n, F, D, rc, stream);
}

int egnn_k4(int dtype, int device, const void* const* in, void* const* out,
            void* scratch, int B, int n, int F, int D, double rc,
            void* stream) {
  if (dtype == 0)
    return launch_fwd<float, true>(device, in, out, B, n, F, D, rc, stream);
  return launch_fwd<double, true>(device, in, out, B, n, F, D, rc, stream);
}

int egnn_k5(int dtype, int device, const void* const* in, void* const* out,
            void* scratch, int B, int n, int F, int D, double rc,
            void* stream) {
  if (dtype == 0)
    return launch_k5<float>(device, in, out, scratch, B, n, F, D, rc,
                            stream);
  return launch_k5<double>(device, in, out, scratch, B, n, F, D, rc, stream);
}

// The forward kernel's launch for B * n rows (K4 if tangent, else K3):
// info = {warps per block, blocks per SM, shared-memory bytes per block,
// grid}.
int egnn_fwd_info(int dtype, int tangent, int device, int rows, int F, int D,
                  int* info) {
  if (tangent) return fwd_info<true>(dtype, device, rows, F, D, info);
  return fwd_info<false>(dtype, device, rows, F, D, info);
}

// K5's launch for widths F, D: info = {sender tile pt, weights in shared
// memory, gradient sums in shared memory, shared-memory bytes per block}.
int egnn_k5_info(int dtype, int device, int F, int D, int* info) {
  if (dtype == 0) return k5_info<float>(device, F, D, info);
  return k5_info<double>(device, F, D, info);
}

const char* egnn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
