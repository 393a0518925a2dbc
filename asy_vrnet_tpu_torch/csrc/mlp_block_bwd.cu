// Backward of the MLP half of a ClusterBlock, fused (fc1 rematerialised):
//   z1 = xn @ w1 + b1,  h = GELU(z1),  y = h @ w2 + b2,  xn = (x - mu) * rstd
//   dz1 = (g @ w2^T) * GELU'(z1),  dxn = dz1 @ w1^T,
//   dW1 = xn^T dz1,  db1 = sum dz1,  dW2 = h^T g,  db2 = sum g,
// plus per-sample sum(dxn) and sum(dxn * xn), taken from the f32 dxn before
// it is rounded, which the GroupNorm input gradient needs.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/block_pallas.py::_mlp_bwd_pallas
// (kernel _mlp_bwd_kernel), reached through the custom VJP of
// fused_mlp_block_pre.  GN affine and LayerScale are folded into the weights
// by the caller, which also unfolds the weight gradients.  Both paths below
// have a variant (template flag kZ1, ASY_MLP_BWD_RESIDUALS=1) that loads the
// forward's stored z1 (mlp_block.cu, rounded to the working type, bias
// included) instead of forming it with the fc1 product, as the TPU kernel
// does with its z_ref; GELU and GELU' then take the stored value.  The other
// four products stay.
//
// What bounds it on the H100: 8*C*hid flops per token (four products of
// the forward's size) against 6*C bytes of bf16 traffic (x and g in, dxn
// out): 170..850 flop/byte at the nano shapes, so the least time is set by
// the tensor-core rate at the wide shapes and by bytes at stages 0-1.
//
// Two paths, chosen from the shapes (the caller sizes `part` to match).
// bf16 with C a multiple of 16 (up to 160), hid a multiple of 32 and H*W a
// multiple of 128, the main path, runs all five products (z1, g @ w2^T,
// dz1 @ w1^T, both weight gradients) on tensor cores (mma.sync m16n8k16,
// f32 accumulation): one block per 128 tokens of a sample, 8 warps of 16
// tokens, hidden slices of 32.  Per slice a warp forms z1 and g @ w2^T from
// fragments loaded straight from x and g and the slice's weights staged in
// shared memory, turns them into dz1 and GELU(z1) in registers, uses dz1 as
// the A-fragments of its dxn product (accumulated in shared memory across
// slices) and stores dz1 and GELU(z1) transposed, so that the block's
// weight-gradient tiles (K = its 128 tokens) read every fragment with one
// 32-bit load from the transposed x and g tiles staged once.  Every other
// case (f32, other widths) runs the FMA path below on CUDA cores.
//
// FMA path.  One block per chunk of TT tokens of one sample (TT*C <= 16384,
// chosen by the caller), looping over the hidden width in slices of 32:
// the slice's w1 columns and w2 rows are staged in shared memory, then the
// chunk is swept in sub-tiles of 32 tokens that recompute z1 and g @ w2^T,
// form dz1 and GELU(z1) (rounded to the working type where the TPU kernel
// casts them), add dz1 @ w1^T into the chunk's f32 dxn held in shared memory,
// and accumulate the slice's dW1, dW2 and db1 in shared memory with one
// owner thread per element.  After each slice the block writes its slice of
// the weight-gradient partials into its own row of `part`; after the last,
// it rounds and stores dxn and writes its db2 and GroupNorm sums.  The
// caller reduces the rows with one torch sum: no float atomics, so two runs
// give the same bits.
//
// part row: [dW1 (C*hid) | dW2 (hid*C) | db1 (hid) | db2 (C) | s1 | s2].
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 32;       // tokens per sub-tile
constexpr int kHid = 32;       // hidden units per slice
constexpr int kWP = kHid + 1;  // padded row of the staged slices

__device__ __forceinline__ void gelu_and_grad(float z, float& act, float& grad) {
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752f));
  act = z * cdf;
  grad = cdf + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

struct Lay {  // offsets in floats
  size_t dx, xs, gs, w1s, w2s, dz, hs, dw1, dw2, db1, red, red2, floats;
};

inline Lay layout(int TT, int C) {
  Lay L;
  size_t o = 0;
  L.dx = o;   o += (size_t)TT * C;
  L.xs = o;   o += (size_t)kSub * C;
  L.gs = o;   o += (size_t)kSub * C;
  L.w1s = o;  o += (size_t)C * kWP;
  L.w2s = o;  o += (size_t)C * kWP;
  L.dz = o;   o += (size_t)kSub * kWP;
  L.hs = o;   o += (size_t)kSub * kWP;
  L.dw1 = o;  o += (size_t)C * kHid;
  L.dw2 = o;  o += (size_t)kHid * C;
  L.db1 = o;  o += (size_t)(kThreads / kHid) * kHid;
  L.red = o;  o += 2 * (kThreads / 32);
  L.red2 = o; o += std::max(kThreads, C);
  L.floats = o;
  return L;
}

template <typename T, bool kZ1>
__global__ void __launch_bounds__(kThreads)
mlp_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                     const float* __restrict__ stats, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ z1, T* __restrict__ dxn,
                     float* __restrict__ part, int HW, int C, int hid, int chunks, int TT,
                     Lay L) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* dx = sm + L.dx;    // [TT][C] f32 dxn of the chunk
  float* xs = sm + L.xs;    // [kSub][C] rounded xn
  float* gs = sm + L.gs;    // [kSub][C] g
  float* w1s = sm + L.w1s;  // [C][kWP] w1[:, slice]
  float* w2s = sm + L.w2s;  // [C][kWP] w2[slice, :]^T
  float* dz = sm + L.dz;    // [kSub][kWP] rounded dz1
  float* hs = sm + L.hs;    // [kSub][kWP] rounded GELU(z1)
  float* dw1 = sm + L.dw1;  // [C][kHid] slice of dW1
  float* dw2 = sm + L.dw2;  // [kHid][C] slice of dW2
  float* db1 = sm + L.db1;  // [token groups][kHid] slice of db1
  float* red = sm + L.red;
  float* red2 = sm + L.red2;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / chunks, k = blockIdx.x % chunks;
  const int n0 = k * TT, nt = min(TT, HW - n0);
  const size_t base = ((size_t)b * HW + n0) * C;
  const float mu = stats[2 * b], rstd = stats[2 * b + 1];
  float* row = part + (size_t)blockIdx.x * ((size_t)2 * C * hid + hid + C + 2);
  const size_t l1 = (size_t)C * hid;
  constexpr int kGroups = kThreads / kHid;

  for (int e = tid; e < TT * C; e += kThreads) dx[e] = 0.f;
  for (int j0 = 0; j0 < hid; j0 += kHid) {
    const int hc = min(kHid, hid - j0);
    __syncthreads();  // the previous slice's partials are written out
    for (int e = tid; e < C * kHid; e += kThreads) {
      const int c = e / kHid, j = e % kHid;
      w1s[c * kWP + j] = j < hc ? to_f<T>(w1[(size_t)c * hid + j0 + j]) : 0.f;
      dw1[e] = 0.f;
    }
    for (int e = tid; e < kHid * C; e += kThreads) {
      const int j = e / C, c = e % C;
      w2s[c * kWP + j] = j < hc ? to_f<T>(w2[(size_t)(j0 + j) * C + c]) : 0.f;
      dw2[e] = 0.f;
    }
    for (int e = tid; e < kGroups * kHid; e += kThreads) db1[e] = 0.f;
    for (int s0 = 0; s0 < nt; s0 += kSub) {
      const int ns = min(kSub, nt - s0);
      __syncthreads();  // staged slice ready; previous sub-tile consumed
      for (int e = tid; e < kSub * C; e += kThreads) {
        const bool ok = e / C < ns;
        const size_t o = base + (size_t)s0 * C + e;
        xs[e] = ok ? rnd<T>((to_f<T>(x[o]) - mu) * rstd) : 0.f;
        gs[e] = ok ? to_f<T>(gout[o]) : 0.f;
      }
      __syncthreads();
      // z1 (kZ1: loaded) and dh = g @ w2^T of the slice; thread (tg, j) owns
      // tokens tg + 8q
      {
        const int j = tid % kHid, tg = tid / kHid;
        float z[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = 0; c < C; ++c) {
          const float wa = w1s[c * kWP + j], wb = w2s[c * kWP + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int t = tg + kGroups * q;
            if (!kZ1) z[q] = fmaf(xs[t * C + c], wa, z[q]);
            dh[q] = fmaf(gs[t * C + c], wb, dh[q]);
          }
        }
        float sdz = 0.f;
        const float bias = j < hc ? b1[j0 + j] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = tg + kGroups * q;
          float act = 0.f, grad = 0.f;
          if (j < hc && t < ns) {
            const float zq = kZ1 ? to_f<T>(z1[((size_t)b * HW + n0 + s0 + t) * hid + j0 + j])
                                 : z[q] + bias;
            gelu_and_grad(zq, act, grad);
          }
          const float d = dh[q] * grad;
          dz[t * kWP + j] = rnd<T>(d);
          hs[t * kWP + j] = rnd<T>(act);
          sdz += d;
        }
        db1[tg * kHid + j] += sdz;
      }
      __syncthreads();
      // dxn += dz1 @ w1^T; thread (tq, c) owns tokens 4*tq .. 4*tq + 3
      for (int e = tid; e < (kSub / 4) * C; e += kThreads) {
        const int c = e % C, tq = e / C;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < kHid; ++j) {
          const float w = w1s[c * kWP + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(dz[(4 * tq + q) * kWP + j], w, acc[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 4 * tq + q;
          if (t < ns) dx[(s0 + t) * C + c] += acc[q];
        }
      }
      // dW1 += xn^T dz1 and dW2 += GELU(z1)^T g over the sub-tile
      for (int e = tid; e < C * kHid; e += kThreads) {
        const int c = e / kHid, j = e % kHid;
        float a = dw1[e];
        for (int t = 0; t < ns; ++t) a = fmaf(xs[t * C + c], dz[t * kWP + j], a);
        dw1[e] = a;
      }
      for (int e = tid; e < kHid * C; e += kThreads) {
        const int j = e / C, c = e % C;
        float a = dw2[e];
        for (int t = 0; t < ns; ++t) a = fmaf(hs[t * kWP + j], gs[t * C + c], a);
        dw2[e] = a;
      }
    }
    __syncthreads();
    for (int e = tid; e < C * hc; e += kThreads) {
      const int c = e / hc, j = e % hc;
      row[(size_t)c * hid + j0 + j] = dw1[c * kHid + j];
    }
    for (int e = tid; e < hc * C; e += kThreads) {
      const int j = e / C, c = e % C;
      row[l1 + (size_t)(j0 + j) * C + c] = dw2[j * C + c];
    }
    for (int j = tid; j < hc; j += kThreads) {
      float a = 0.f;
      for (int tg = 0; tg < kGroups; ++tg) a += db1[tg * kHid + j];
      row[2 * l1 + j0 + j] = a;
    }
  }
  __syncthreads();

  // dxn out (rounded once), GroupNorm sums from the f32 values, db2
  float s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < nt * C; e += kThreads) {
    const float v = dx[e];
    dxn[base + e] = asy::from_f<T>(v);
    s1 += v;
    s2 = fmaf(v, (to_f<T>(x[base + e]) - mu) * rstd, s2);
  }
  const int nq = max(1, kThreads / C);
  for (int e = tid; e < nq * C; e += kThreads) {
    const int c = e % C, tq = e / C;
    float a = 0.f;
    for (int t = tq; t < nt; t += nq) a += to_f<T>(gout[base + (size_t)t * C + c]);
    red2[e] = a;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  const int warps = kThreads / 32;
  if ((tid & 31) == 0) {
    red[tid >> 5] = s1;
    red[warps + (tid >> 5)] = s2;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float a = 0.f;
    for (int tq = 0; tq < nq; ++tq) a += red2[tq * C + c];
    row[2 * l1 + hid + c] = a;
  }
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += red[w];
      q += red[warps + w];
    }
    row[2 * l1 + hid + C] = a;
    row[2 * l1 + hid + C + 1] = q;
  }
}

template <typename T, bool kZ1>
int launch(const void* x, const void* g, const float* stats, const void* w1,
           const float* b1, const void* w2, const void* z1, void* dxn, float* part, int B,
           int HW, int C, int hid, int chunks, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || hid <= 0 || chunks <= 0 || chunks > HW)
    return (int)cudaErrorInvalidValue;
  const int TT = (HW + chunks - 1) / chunks;
  const Lay L = layout(TT, C);
  const size_t bytes = L.floats * sizeof(float);
  cudaError_t e = asy::set_smem(mlp_block_bwd_kernel<T, kZ1>, bytes);
  if (e != cudaSuccess) return (int)e;
  mlp_block_bwd_kernel<T, kZ1><<<B * chunks, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, stats, (const T*)w1, b1, (const T*)w2, (const T*)z1,
      (T*)dxn, part, HW, C, hid, chunks, TT, L);
  return (int)cudaGetLastError();
}

// ---- tensor-core path (bf16; C % 16 == 0, C <= kMaxC, hid % kTHid == 0,
// HW % kTTok == 0): one block per kTTok tokens of one sample, 8 warps of 16
// tokens, mma.sync m16n8k16 with f32 accumulation for all five products ----
constexpr int kTWarps = 8;
constexpr int kTTok = 16 * kTWarps;  // tokens per block
constexpr int kTHid = 32;            // hidden units per slice
constexpr int kTS = kTTok + 8;       // padded token rows of the transposed tiles
constexpr int kMaxC = 160;
constexpr int kGroup = 5;            // channel tiles per dxn accumulator group

typedef __nv_bfloat16 bf16;

// Fragments as common.cuh lays them out; A row-major and B stored n-major
// (k contiguous), so every fragment register is one 32-bit load.
using asy::mma16816;
using asy::pack_bf16;
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

inline size_t mma_smem_bytes(int C) {
  return sizeof(bf16) * ((size_t)2 * C * kTS + 2 * kTHid * (C + 8) + (size_t)C * (kTHid + 8) +
                         2 * kTHid * kTS) +
         sizeof(float) * ((size_t)kTTok * C + kTWarps * kTHid + 2 * kTWarps);
}

template <bool kZ1>
__global__ void __launch_bounds__(kTWarps * 32)
mlp_block_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
                         const float* __restrict__ stats, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const bf16* __restrict__ z1, bf16* __restrict__ dxn,
                         float* __restrict__ part, int HW, int C, int hid, int chunks) {
  extern __shared__ float4 smem4[];
  const int sc = C + 8, sh = kTHid + 8;
  bf16* xT = reinterpret_cast<bf16*>(smem4);  // [C][kTS] rounded xn, transposed
  bf16* gT = xT + C * kTS;                    // [C][kTS] g, transposed
  bf16* w1t = gT + C * kTS;                   // [kTHid][sc] w1[:, slice]^T
  bf16* w2r = w1t + kTHid * sc;               // [kTHid][sc] w2[slice, :]
  bf16* w1n = w2r + kTHid * sc;               // [C][sh] w1[:, slice]
  bf16* dzT = w1n + C * sh;                   // [kTHid][kTS] rounded dz1, transposed
  bf16* hT = dzT + kTHid * kTS;               // [kTHid][kTS] rounded GELU(z1), transposed
  float* dx = reinterpret_cast<float*>(hT + kTHid * kTS);  // [kTTok][C] f32 dxn
  float* db1s = dx + kTTok * C;               // [kTWarps][kTHid]
  float* red = db1s + kTWarps * kTHid;        // [2][kTWarps]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / chunks;
  const size_t tok0 = (size_t)b * HW + (size_t)(blockIdx.x % chunks) * kTTok;
  const float mu = stats[2 * b], rstd = stats[2 * b + 1];
  float* row = part + (size_t)blockIdx.x * ((size_t)2 * C * hid + hid + C + 2);
  const size_t l1 = (size_t)C * hid;
  const int r0 = warp * 16;  // the warp's first token in the block
  const int ctiles = C / 8;

  for (int e = tid; e < kTTok * C; e += kTWarps * 32) {
    const int tt = e / C, c = e % C;
    const size_t o = tok0 * C + e;
    xT[c * kTS + tt] = __float2bfloat16_rn((__bfloat162float(x[o]) - mu) * rstd);
    gT[c * kTS + tt] = gout[o];
    dx[e] = 0.f;
  }
  auto norm_pair = [&](size_t o) -> uint32_t {  // rounded xn at (token, c..c+1)
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + o);
    return pack_bf16((__bfloat162float(v.x) - mu) * rstd, (__bfloat162float(v.y) - mu) * rstd);
  };

  for (int j0 = 0; j0 < hid; j0 += kTHid) {
    __syncthreads();  // the previous slice's shared tiles are consumed
    for (int e = tid; e < C * kTHid; e += kTWarps * 32) {
      const int c = e / kTHid, j = e % kTHid;
      const bf16 v = w1[(size_t)c * hid + j0 + j];
      w1t[j * sc + c] = v;
      w1n[c * sh + j] = v;
    }
    for (int e = tid; e < kTHid * C; e += kTWarps * 32) {
      const int j = e / C, c = e % C;
      w2r[j * sc + c] = w2[(size_t)(j0 + j) * C + c];
    }
    __syncthreads();

    // z1 = xn @ w1 (kZ1: loaded below) and dh = g @ w2^T for the warp's 16 tokens
    float z[4][4] = {}, dh[4][4] = {};
    const size_t ra = (tok0 + r0 + g) * C, rb = ra + 8 * (size_t)C;
    for (int kk = 0; kk < C / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t xa[4] = {norm_pair(ra + c), norm_pair(rb + c), norm_pair(ra + c + 8),
                              norm_pair(rb + c + 8)};
      const uint32_t ga[4] = {ld32(gout + ra + c), ld32(gout + rb + c), ld32(gout + ra + c + 8),
                              ld32(gout + rb + c + 8)};
#pragma unroll
      for (int nt = 0; nt < kTHid / 8; ++nt) {
        if (!kZ1) {
          const bf16* bp = w1t + (nt * 8 + g) * sc + c;
          mma16816(z[nt], xa, ld32(bp), ld32(bp + 8));
        }
        const bf16* bq = w2r + (nt * 8 + g) * sc + c;
        mma16816(dh[nt], ga, ld32(bq), ld32(bq + 8));
      }
    }
    if (kZ1) {  // the stored z1 (bias included) in the accumulator layout
#pragma unroll
      for (int nt = 0; nt < kTHid / 8; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              z1 + (tok0 + r0 + g + 8 * h) * hid + j0 + nt * 8 + 2 * t);
          z[nt][2 * h] = __bfloat162float(v.x);
          z[nt][2 * h + 1] = __bfloat162float(v.y);
        }
      }
    }
    // dz1 = dh * GELU'(z1 + b1): A-fragments for dxn, dz1^T and GELU^T to
    // shared memory for the weight gradients, column sums for db1
    uint32_t da[2][4];
#pragma unroll
    for (int nt = 0; nt < kTHid / 8; ++nt) {
      float d[4], a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // (row g | g+8) x (col 2t | 2t+1)
        const int j = nt * 8 + 2 * t + (i & 1);
        float grad;
        gelu_and_grad(kZ1 ? z[nt][i] : z[nt][i] + b1[j0 + j], a[i], grad);
        d[i] = dh[nt][i] * grad;
        const int tt = r0 + g + (i >> 1) * 8;
        dzT[j * kTS + tt] = __float2bfloat16_rn(d[i]);
        hT[j * kTS + tt] = __float2bfloat16_rn(a[i]);
      }
      da[nt / 2][2 * (nt % 2)] = pack_bf16(d[0], d[1]);
      da[nt / 2][2 * (nt % 2) + 1] = pack_bf16(d[2], d[3]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float s = d[h2] + d[2 + h2];
        for (int off = 4; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (g == 0) db1s[warp * kTHid + nt * 8 + 2 * t + h2] = s;
      }
    }
    // dxn += dz1 @ w1[:, slice]^T, kGroup channel tiles at a time
    for (int nc0 = 0; nc0 < ctiles; nc0 += kGroup) {
      float y[kGroup][4] = {};
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (nc0 + u < ctiles) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const bf16* bp = w1n + ((nc0 + u) * 8 + g) * sh + ks * 16 + 2 * t;
            mma16816(y[u], da[ks], ld32(bp), ld32(bp + 8));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (nc0 + u < ctiles) {
          const int c = (nc0 + u) * 8 + 2 * t;
          float* p = dx + (r0 + g) * C + c;
          p[0] += y[u][0];
          p[1] += y[u][1];
          p[8 * C] += y[u][2];
          p[8 * C + 1] += y[u][3];
        }
      }
    }
    __syncthreads();  // dz1^T, GELU^T and the db1 sums are complete

    // dW1[:, slice] = xn^T dz1 over the block's tokens, one 16x8 tile per warp step
    for (int tile = warp; tile < (C / 16) * (kTHid / 8); tile += kTWarps) {
      const int m0 = (tile / (kTHid / 8)) * 16, n0 = (tile % (kTHid / 8)) * 8;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < kTTok / 16; ++kk) {
        const int k0 = kk * 16 + 2 * t;
        const bf16* ap = xT + (m0 + g) * kTS + k0;
        const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * kTS), ld32(ap + 8), ld32(ap + 8 * kTS + 8)};
        const bf16* bp = dzT + (n0 + g) * kTS + k0;
        mma16816(acc, a, ld32(bp), ld32(bp + 8));
      }
      float* p = row + (size_t)(m0 + g) * hid + j0 + n0 + 2 * t;
      p[0] = acc[0];
      p[1] = acc[1];
      p[8 * (size_t)hid] = acc[2];
      p[8 * (size_t)hid + 1] = acc[3];
    }
    // dW2[slice, :] = GELU(z1)^T g
    for (int tile = warp; tile < (kTHid / 16) * ctiles; tile += kTWarps) {
      const int m0 = (tile / ctiles) * 16, n0 = (tile % ctiles) * 8;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < kTTok / 16; ++kk) {
        const int k0 = kk * 16 + 2 * t;
        const bf16* ap = hT + (m0 + g) * kTS + k0;
        const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * kTS), ld32(ap + 8), ld32(ap + 8 * kTS + 8)};
        const bf16* bp = gT + (n0 + g) * kTS + k0;
        mma16816(acc, a, ld32(bp), ld32(bp + 8));
      }
      float* p = row + l1 + (size_t)(j0 + m0 + g) * C + n0 + 2 * t;
      p[0] = acc[0];
      p[1] = acc[1];
      p[8 * C] = acc[2];
      p[8 * C + 1] = acc[3];
    }
    for (int j = tid; j < kTHid; j += kTWarps * 32) {
      float s = 0.f;
      for (int w = 0; w < kTWarps; ++w) s += db1s[w * kTHid + j];
      row[2 * l1 + j0 + j] = s;
    }
  }
  __syncthreads();

  // dxn out (rounded once), GroupNorm sums from the f32 values, db2
  float s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < kTTok * C; e += kTWarps * 32) {
    const float v = dx[e];
    const size_t o = tok0 * C + e;
    dxn[o] = __float2bfloat16_rn(v);
    s1 += v;
    s2 = fmaf(v, (__bfloat162float(x[o]) - mu) * rstd, s2);
  }
  for (int c = tid; c < C; c += kTWarps * 32) {
    float a = 0.f;
    for (int tt = 0; tt < kTTok; ++tt) a += __bfloat162float(gT[c * kTS + tt]);
    row[2 * l1 + hid + c] = a;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    red[warp] = s1;
    red[kTWarps + warp] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < kTWarps; ++w) {
      a += red[w];
      q += red[kTWarps + w];
    }
    row[2 * l1 + hid + C] = a;
    row[2 * l1 + hid + C + 1] = q;
  }
}

bool mma_path(int HW, int C, int hid) {
  return C % 16 == 0 && C <= kMaxC && hid % kTHid == 0 && HW % kTTok == 0;
}

template <bool kZ1>
int launch_mma(const void* x, const void* g, const float* stats, const void* w1,
               const float* b1, const void* w2, const void* z1, void* dxn, float* part,
               int B, int HW, int C, int hid, int chunks, void* stream) {
  if (B <= 0 || chunks != HW / kTTok) return (int)cudaErrorInvalidValue;
  const size_t bytes = mma_smem_bytes(C);
  cudaError_t e = asy::set_smem(mlp_block_bwd_mma_kernel<kZ1>, bytes);
  if (e != cudaSuccess) return (int)e;
  mlp_block_bwd_mma_kernel<kZ1><<<B * chunks, kTWarps * 32, bytes, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)g, stats, (const bf16*)w1, b1, (const bf16*)w2,
      (const bf16*)z1, (bf16*)dxn, part, HW, C, hid, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma(const void* x, const void* g, const float* stats, const void* w1,
               const float* b1, const void* w2, const void* z1, void* dxn, float* part,
               int B, int HW, int C, int hid, int chunks, void* stream) {
  return z1 != nullptr
             ? launch<T, true>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid, chunks,
                               stream)
             : launch<T, false>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid, chunks,
                                stream);
}

}  // namespace

extern "C" {

// z1 (B*HW, hid) in the working type: the forward's stored pre-GELU
// activations, or null (fc1 recomputed)
int mlp_block_bwd_bf16(const void* x, const void* g, const float* stats,
                       const void* w1, const float* b1, const void* w2, const void* z1,
                       void* dxn, float* part, int B, int HW, int C, int hid, int chunks,
                       void* stream) {
  if (mma_path(HW, C, hid))
    return z1 != nullptr
               ? launch_mma<true>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid,
                                  chunks, stream)
               : launch_mma<false>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid,
                                   chunks, stream);
  return launch_fma<__nv_bfloat16>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid,
                                   chunks, stream);
}

int mlp_block_bwd_f32(const void* x, const void* g, const float* stats,
                      const void* w1, const float* b1, const void* w2, const void* z1,
                      void* dxn, float* part, int B, int HW, int C, int hid, int chunks,
                      void* stream) {
  return launch_fma<float>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid, chunks,
                           stream);
}

}  // extern "C"
