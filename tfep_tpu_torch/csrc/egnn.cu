// Fused EGNN pairwise block for Hopper (sm_90a): kernels K3, K4, K5.
//
// Replaces the Pallas TPU kernels of tfep_tpu/ops/pallas/egnn.py:
// _forward_kernel (K3), _jvp_kernel (K4) and _jvp_bwd_kernel (K5). The
// plain PyTorch versions, the autograd Function and the derivation of K5
// are in tfep_tpu_torch/ops/egnn.py; this file follows
// pairwise_jvp_backward_reference there line by line.
//
// One block per frame b walks the receiver rows i and, inside a row, tiles
// of PT senders j (PT = 32, 16, 8 or 4, the largest that fits). Between
// two __syncthreads() every thread loops over its share of one phase's
// work, and all state that crosses a barrier lives in shared memory (or,
// when shared memory is too small, in device memory through the same
// pointers). Products: each thread computes PM = 4 pairs of one output
// column, so one load of a weight serves four pairs; the weight matrices
// are stored with rows padded by one element, so the 32 threads of a warp
// read 32 different banks.
//
// K5's eleven weight gradients are summed per block (one frame) into
// `partials`, then reduce_partials sums them over the frames in a fixed
// order. Per-frame gradients (a_i, a_j, dist and their tangents) are
// written by the block that owns the frame, with no atomics.
//
// C interface (bound with ctypes): egnn_k3/k4/k5(dtype, device, inputs,
// outputs, scratch, B, n, F, D, r_cutoff, stream) return 0, a CUDA error
// code, or -1 when no block configuration fits in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int PM = 4;  // pairs per thread in a product
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double d_tanh(double x) { return tanh(x); }

template <typename T>
__device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + d_exp(-x));
}

// Kernel modes: K3 primal, K4 primal and tangent, K5 VJP of K4.
enum Mode { kK3 = 0, kK4 = 1, kK5 = 2 };

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

// Shared-memory layout, in elements of T; the host sizes the launch with
// the same arithmetic.
struct Layout {
  int we, wm2, wx1;                             // padded weights (w_smem)
  int mu, gam, b1, bm2, watt, bx1, wx2, batt;   // small vectors
  int gacc;                                     // gradient sums (g_smem)
  int emb, demb;                                // [PT][D]
  int pre, dpre, s, ds, m1, dm1, ms, dms, msg, dmsg, z1, dz1;  // [PT][F]
  int sc;                                       // per-pair scalars
  int total;
  static constexpr int kScalars = 12;
  __host__ __device__ Layout(int mode, int F, int D, int pt, int w_smem,
                             int g_smem) {
    int at = 0;
    auto take = [&at](int size) {
      int start = at;
      at += (size + 3) & ~3;  // keep every array 16-byte aligned
      return start;
    };
    we = take(w_smem ? F * (D + 1) : 0);
    wm2 = take(w_smem ? F * (F + 1) : 0);
    wx1 = take(w_smem ? F * (F + 1) : 0);
    mu = take(D);
    gam = take(D);
    b1 = take(F);
    bm2 = take(F);
    watt = take(F);
    bx1 = take(F);
    wx2 = take(F);
    batt = take(1);
    gacc = take(mode == kK5 && g_smem ? GradOffsets(F, D).total : 0);
    const bool tangent = mode != kK3;
    emb = take(pt * D);
    demb = take(tangent ? pt * D : 0);
    pre = take(mode == kK5 ? pt * F : 0);
    dpre = take(mode == kK5 ? pt * F : 0);
    s = take(pt * F);
    ds = take(tangent ? pt * F : 0);
    m1 = take(mode == kK5 ? pt * F : 0);
    dm1 = take(mode == kK5 ? pt * F : 0);
    ms = take(pt * F);
    dms = take(tangent ? pt * F : 0);
    msg = take(pt * F);
    dmsg = take(tangent ? pt * F : 0);
    z1 = take(pt * F);
    dz1 = take(tangent ? pt * F : 0);
    sc = take(kScalars * pt);
    total = at;
  }
};

// out(p, f) for p < pt, f < N: acc = sum_k A[p][k] W[f][k] (A W^T), and
// with A2 the same product of A2 (the tangent) on the same weight loads;
// epi(p, f, acc, acc2) consumes them.
template <typename T, bool kTwo, typename Epi>
__device__ __forceinline__ void mm_abt(int pt, int N, int K, const T* A,
                                       const T* A2, const T* W, int ldw,
                                       Epi epi) {
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
        if (kTwo) acc2[m] += A2[(p0 + m) * K + k] * wk;
      }
    }
    for (int m = 0; m < PM; ++m) epi(p0 + m, f, acc[m], acc2[m]);
  }
}

// out(p, k) for p < pt, k < K: acc = sum_f A[p][f] W[f][k] (A W), twice.
template <typename T, typename Epi>
__device__ __forceinline__ void mm_ab2(int pt, int K, int N, const T* A,
                                       const T* A2, const T* W, int ldw,
                                       Epi epi) {
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

// G[f][k] += sum_p A1[p][f] B1[p][k] + A2[p][f] B2[p][k] for f < N, k < K
// (A^T B, the weight gradients); each thread owns PM rows of one column.
template <typename T>
__device__ __forceinline__ void mm_atb2(int pt, int N, int K, const T* A1,
                                        const T* B1, const T* A2,
                                        const T* B2, T* G) {
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

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
egnn_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int n = a.n, F = a.F, D = a.D, pt = a.pt;
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr bool tangent = kMode != kK3;
  const Layout L(kMode, F, D, pt, a.w_smem, a.g_smem);
  const GradOffsets GO(F, D);
  const T rc = a.rc;
  const T c = T(kPi) / rc;

  // Weights: padded copies in shared memory, or device memory as given.
  const T *We = a.w_e, *Wm2 = a.w_m2, *Wx1 = a.w_x1;
  int ldwe = D, ldwm2 = F, ldwx1 = F;
  if (a.w_smem) {
    for (int e = tid; e < F * D; e += nt)
      sm[L.we + (e / D) * (D + 1) + e % D] = a.w_e[e];
    for (int e = tid; e < F * F; e += nt) {
      sm[L.wm2 + (e / F) * (F + 1) + e % F] = a.w_m2[e];
      sm[L.wx1 + (e / F) * (F + 1) + e % F] = a.w_x1[e];
    }
    We = sm + L.we;
    Wm2 = sm + L.wm2;
    Wx1 = sm + L.wx1;
    ldwe = D + 1;
    ldwm2 = ldwx1 = F + 1;
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

  // Zero this frame's accumulated outputs and the gradient sums.
  const size_t node0 = (size_t)b * n * F;
  const size_t pair0 = (size_t)b * n * n;
  T* gacc = nullptr;
  if (kMode == kK5) {
    gacc = a.g_smem ? sm + L.gacc : a.partials + (size_t)b * GO.total;
    for (int e = tid; e < GO.total; e += nt) gacc[e] = T(0);
    for (int e = tid; e < n * F; e += nt) {
      a.g_a_i[node0 + e] = T(0);
      a.g_a_j[node0 + e] = T(0);
      a.g_da_i[node0 + e] = T(0);
      a.g_da_j[node0 + e] = T(0);
    }
  } else {
    for (int e = tid; e < n * F; e += nt) {
      a.nm[node0 + e] = T(0);
      if (tangent) a.dnm[node0 + e] = T(0);
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
        if (tangent) sdd[p] = valid ? a.dd[pair0 + i * n + j] : T(0);
      }
      __syncthreads();

      // Radial expansion (and its tangent, d emb/d dist times dd).
      for (int e = tid; e < pt * D; e += nt) {
        const int p = e / D, k = e % D;
        const T d = sd[p];
        const T r = d - s_mu[k];
        const T g = s_gam[k];
        const T G = d_exp(-g * r * r);
        const bool inside = d <= rc;
        const T S = inside ? T(0.5) * d_cos(c * d) + T(0.5) : T(0);
        emb[e] = G * S;
        if (tangent) {
          const T S1 = inside ? T(-0.5) * c * d_sin(c * d) : T(0);
          demb[e] = G * (S1 - T(2) * g * r * S) * sdd[p];
        }
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
          if (kMode == kK5) pre[p * F + f] = v;
          if (tangent) {
            const T dv = dacc + a.da_i[node0 + i * F + f] +
                         (valid ? a.da_j[node0 + j * F + f] : T(0));
            ds[p * F + f] = sg * (T(1) + v * (T(1) - sg)) * dv;
            if (kMode == kK5) dpre[p * F + f] = dv;
          }
        };
        mm_abt<T, tangent>(pt, F, D, emb, demb, We, ldwe, epi);
      }
      __syncthreads();

      // m1 = W_m2 s + b_m2, ms = silu(m1); and tangents.
      {
        auto epi = [&](int p, int f, T acc, T dacc) {
          const T v = acc + s_bm2[f];
          const T sg = sigmoid(v);
          ms[p * F + f] = v * sg;
          if (kMode == kK5) m1[p * F + f] = v;
          if (tangent) {
            dms[p * F + f] = sg * (T(1) + v * (T(1) - sg)) * dacc;
            if (kMode == kK5) dm1[p * F + f] = dacc;
          }
        };
        mm_abt<T, tangent>(pt, F, F, s, ds, Wm2, ldwm2, epi);
      }
      __syncthreads();

      // Attention per pair.
      for (int p = tid; p < pt; p += nt) {
        T v = batt, dv = T(0);
        for (int f = 0; f < F; ++f) {
          v += ms[p * F + f] * s_watt[f];
          if (tangent) dv += dms[p * F + f] * s_watt[f];
        }
        const T att = sigmoid(v);
        satt[p] = att;
        if (tangent) {
          sdv[p] = dv;
          sdatt[p] = att * (T(1) - att) * dv;
        }
      }
      __syncthreads();

      // Masked messages, and (K3, K4) their sum over the tile's senders.
      for (int f = tid; f < F; f += nt) {
        T sum = T(0), dsum = T(0);
        for (int p = 0; p < pt; ++p) {
          const T mk = smask[p];
          const T m = ms[p * F + f] * satt[p] * mk;
          msg[p * F + f] = m;
          sum += m;
          if (tangent) {
            const T dm =
                (dms[p * F + f] * satt[p] + ms[p * F + f] * sdatt[p]) * mk;
            dmsg[p * F + f] = dm;
            dsum += dm;
          }
        }
        if (kMode != kK5) {
          a.nm[node0 + i * F + f] += sum;
          if (tangent) a.dnm[node0 + i * F + f] += dsum;
        }
      }
      __syncthreads();

      // z1 = W_x1 msg + b_x1; and its tangent.
      {
        auto epi = [&](int p, int f, T acc, T dacc) {
          z1[p * F + f] = acc + s_bx1[f];
          if (tangent) dz1[p * F + f] = dacc;
        };
        mm_abt<T, tangent>(pt, F, F, msg, dmsg, Wx1, ldwx1, epi);
      }
      __syncthreads();

      // Magnitudes: t = tanh(w_x2 . silu(z1)), q its tangent's logit.
      for (int p = tid; p < pt; p += nt) {
        T u = T(0), q = T(0);
        for (int f = 0; f < F; ++f) {
          const T z = z1[p * F + f];
          const T sg = sigmoid(z);
          u += z * sg * s_wx2[f];
          if (tangent)
            q += sg * (T(1) + z * (T(1) - sg)) * dz1[p * F + f] * s_wx2[f];
        }
        const T t = d_tanh(u);
        st[p] = t;
        sq[p] = q;
        const int j = j0 + p;
        if (kMode != kK5 && j < n) {
          a.mag[pair0 + i * n + j] = t * smask[p];
          if (tangent)
            a.dmag[pair0 + i * n + j] = (T(1) - t * t) * q * smask[p];
        }
      }
      __syncthreads();
      if constexpr (kMode == kK5) {
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

        // z1, dz1 -> their cotangents (in place); sums for w_x2 and b_x1.
        for (int f = tid; f < F; f += nt) {
          const T w = s_wx2[f];
          T gw = T(0), gb = T(0);
          for (int p = 0; p < pt; ++p) {
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
          gacc[GO.w_x2 + f] += gw;
          gacc[GO.b_x1 + f] += gb;
        }
        __syncthreads();

        // grad W_x1 += gdz1^T dmsg + gz1^T msg.
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

        // Cotangents of the attention logit v and its tangent dv.
        for (int p = tid; p < pt; p += nt) {
          T gdatt = T(0), gatt = T(0);
          for (int f = 0; f < F; ++f) {
            const T gdm = dmsg[p * F + f], gm = msg[p * F + f];
            gdatt += gdm * ms[p * F + f];
            gatt += gdm * dms[p * F + f] + gm * ms[p * F + f];
          }
          const T mk = smask[p], att = satt[p];
          const T sa = att * (T(1) - att);
          gdatt *= mk;
          gatt *= mk;
          sgdv[p] = gdatt * sa;
          sgv[p] = gdatt * sa * (T(1) - T(2) * att) * sdv[p] + gatt * sa;
        }
        __syncthreads();

        // Sums for w_att and b_att; m1, dm1 -> their cotangents (in place).
        for (int f = tid; f <= F; f += nt) {
          T acc = T(0);
          for (int p = 0; p < pt; ++p)
            acc += f < F ? sgdv[p] * dms[p * F + f] + sgv[p] * ms[p * F + f]
                         : sgv[p];
          gacc[f < F ? GO.w_att + f : GO.b_att] += acc;
        }
        for (int e = tid; e < pt * F; e += nt) {
          const int p = e / F, f = e % F;
          const T mk = smask[p], att = satt[p];
          const T gdms = mk * att * dmsg[e] + sgdv[p] * s_watt[f];
          const T gms = mk * (sdatt[p] * dmsg[e] + att * msg[e]) +
                        sgv[p] * s_watt[f];
          const T m = m1[e];
          const T sg = sigmoid(m);
          const T s1 = sg * (T(1) + m * (T(1) - sg));
          const T s2 = sg * (T(1) - sg) * (T(2) + m * (T(1) - T(2) * sg));
          m1[e] = gdms * dm1[e] * s2 + gms * s1;
          dm1[e] = gdms * s1;
        }
        __syncthreads();

        // grad W_m2 += gdm1^T ds + gm1^T s; grad b_m2.
        mm_atb2<T>(pt, F, F, dm1, ds, m1, s, gacc + GO.w_m2);
        for (int f = tid; f < F; f += nt) {
          T acc = T(0);
          for (int p = 0; p < pt; ++p) acc += m1[p * F + f];
          gacc[GO.b_m2 + f] += acc;
        }
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
        for (int f = tid; f < F; f += nt) {
          T gp = T(0), gdp = T(0);
          for (int p = 0; p < pt; ++p) {
            gp += s[p * F + f];
            gdp += ds[p * F + f];
          }
          gacc[GO.b1 + f] += gp;
          a.g_a_i[node0 + i * F + f] += gp;
          a.g_da_i[node0 + i * F + f] += gdp;
        }
        for (int e = tid; e < pt * F; e += nt) {
          const int p = e / F, f = e % F;
          const int j = j0 + p;
          if (j < n) {
            a.g_a_j[node0 + j * F + f] += s[e];
            a.g_da_j[node0 + j * F + f] += ds[e];
          }
        }
        mm_atb2<T>(pt, F, D, ds, demb, s, emb, gacc + GO.w_e);
        __syncthreads();

        // Cotangents of emb and demb (into emb, demb).
        {
          auto epi = [&](int p, int k, T gemb, T gdemb) {
            emb[p * D + k] = gemb;
            demb[p * D + k] = gdemb;
          };
          mm_ab2<T>(pt, D, F, s, ds, We, ldwe, epi);
        }
        __syncthreads();

        // The radial chain: sums for mu and log_gammas per k, and each
        // (pair, k) term of the distance and tangent gradients.
        for (int k = tid; k < D; k += nt) {
          const T g = s_gam[k];
          T gmu = T(0), glg = T(0);
          for (int p = 0; p < pt; ++p) {
            const T d = sd[p];
            const T r = d - s_mu[k];
            const T G = d_exp(-g * r * r);
            const bool inside = d <= rc;
            const T cs = d_cos(c * d);
            const T S = inside ? T(0.5) * cs + T(0.5) : T(0);
            const T S1 = inside ? T(-0.5) * c * d_sin(c * d) : T(0);
            const T S2 = inside ? T(-0.5) * c * c * cs : T(0);
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
          gacc[GO.mu + k] += gmu;
          gacc[GO.lg + k] += glg;
        }
        __syncthreads();

        for (int p = tid; p < pt; p += nt) {
          const int j = j0 + p;
          if (j < n) {
            T gd = T(0), gdd = T(0);
            for (int k = 0; k < D; ++k) {
              gd += emb[p * D + k];
              gdd += demb[p * D + k];
            }
            a.g_dist[pair0 + i * n + j] = gd;
            a.g_dd[pair0 + i * n + j] = gdd;
          }
        }
        __syncthreads();
      }
    }
  }

  if (kMode == kK5 && a.g_smem) {
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

// The largest configuration that fits: every tile size with weights and
// gradient sums in shared memory first, then without them.
template <typename T>
int configure(int mode, int device, int F, int D, Args<T>& a,
              size_t& bytes) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int placements[3][2] = {{1, 1}, {1, 0}, {0, 0}};
  for (const auto& place : placements) {
    for (int pt = 32; pt >= PM; pt /= 2) {
      const Layout L(mode, F, D, pt, place[0], place[1]);
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

template <typename T, int kMode>
int launch(int device, const void* const* in, void* const* out,
           void* scratch, int B, int n, int F, int D, double rc,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args<T> a = {};
  const T* const* x = reinterpret_cast<const T* const*>(in);
  T* const* y = reinterpret_cast<T* const*>(out);
  a.a_i = x[0]; a.a_j = x[1]; a.dist = x[2]; a.mu = x[3]; a.lg = x[4];
  a.w_e = x[5]; a.b1 = x[6]; a.w_m2 = x[7]; a.b_m2 = x[8]; a.w_att = x[9];
  a.b_att = x[10]; a.w_x1 = x[11]; a.b_x1 = x[12]; a.w_x2 = x[13];
  if (kMode != kK3) { a.da_i = x[14]; a.da_j = x[15]; a.dd = x[16]; }
  if (kMode == kK5) {
    a.g_nm = x[17]; a.g_mag = x[18]; a.g_dnm = x[19]; a.g_dmag = x[20];
    a.g_a_i = y[0]; a.g_a_j = y[1]; a.g_dist = y[2];
    a.g_da_i = y[3]; a.g_da_j = y[4]; a.g_dd = y[5];
    a.partials = static_cast<T*>(scratch);
  } else {
    a.nm = y[0]; a.mag = y[1];
    if (kMode == kK4) { a.dnm = y[2]; a.dmag = y[3]; }
  }
  a.B = B; a.n = n; a.F = F; a.D = D; a.rc = T(rc);
  size_t bytes = 0;
  const int status = configure<T>(kMode, device, F, D, a, bytes);
  if (status != 0) return status;
  err = cudaFuncSetAttribute(egnn_kernel<T, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  egnn_kernel<T, kMode><<<B, kThreads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (kMode == kK5) {
    const int total = GradOffsets(F, D).total;
    reduce_partials<T><<<(total + 255) / 256, 256, 0, s>>>(
        a.partials, y[6], B, total);
    err = cudaGetLastError();
  }
  return err;
}

template <int kMode>
int dispatch(int dtype, int device, const void* const* in, void* const* out,
             void* scratch, int B, int n, int F, int D, double rc,
             void* stream) {
  if (dtype == 0)
    return launch<float, kMode>(device, in, out, scratch, B, n, F, D, rc,
                                stream);
  return launch<double, kMode>(device, in, out, scratch, B, n, F, D, rc,
                               stream);
}

}  // namespace

extern "C" {

int egnn_k3(int dtype, int device, const void* const* in, void* const* out,
            void* scratch, int B, int n, int F, int D, double rc,
            void* stream) {
  return dispatch<kK3>(dtype, device, in, out, scratch, B, n, F, D, rc,
                       stream);
}

int egnn_k4(int dtype, int device, const void* const* in, void* const* out,
            void* scratch, int B, int n, int F, int D, double rc,
            void* stream) {
  return dispatch<kK4>(dtype, device, in, out, scratch, B, n, F, D, rc,
                       stream);
}

int egnn_k5(int dtype, int device, const void* const* in, void* const* out,
            void* scratch, int B, int n, int F, int D, double rc,
            void* stream) {
  return dispatch<kK5>(dtype, device, in, out, scratch, B, n, F, D, rc,
                       stream);
}

const char* egnn_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
