// MLP half of a ClusterBlock, fused:  out = x + fc2(GELU(fc1((x - mu) * rstd)))
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/block_pallas.py::_mlp_block_pallas
// (kernel _mlp_block_kernel), reached through fused_mlp_block_pre.  The GN
// affine and LayerScale are folded into w1/b1 and w2/b2 by the caller; the
// per-sample GroupNorm statistics (mean, rstd) come in pre-reduced.
//
// What bounds it on the H100: 4*C*hid flops per token against 4*C bytes of
// bf16 traffic (x in, out back), i.e. hid = 128..640 flop/byte, around the
// bf16 tensor-core ridge (~295 flop/byte): the least time is set by bytes
// where hid < 295 (nano stages 0-1, p3) and by operations above.  Unfused,
// the (tokens x hid) hidden plane would cross device memory twice.  In
// practice a warp's chain of dependent mma.sync is the limit: 16 tokens
// through every hidden unit is ~C*hid/64 products one after another.
//
// Three paths.  bf16 with C a multiple of 16 (up to 160), hid a multiple of
// 8 and 16-byte aligned operands, the main path, runs on tensor cores
// (mma.sync m16n8k16, f32 accumulation; mlp_block_mma_kernel below).  Its
// accumulators are sized to C (a template on C/8), so registers follow the
// width; a CTA of 4 warps takes 64, 32 or 16 tokens, chosen by the caller
// from the token count so that the grid covers the card where the tokens
// allow, and below 64 tokens its warps split the hidden units and add their
// partial fc2 sums in a fixed order; the weight slices are double-buffered
// with cp.async.  bf16 at 160 < C <= 640 (same other conditions) runs on
// tensor cores too, in a CTA of 16 warps over 128 tokens (up to C = 320) or
// 64 whose fc2 output channels are split over the warps, so that no thread
// holds more than 80 accumulators (mlp_block_mma_kernel_wide128 and
// mlp_block_mma_kernel_wide below).  Everything else (f32, other widths)
// runs as f32 FMA on CUDA cores: one block per 32 tokens keeps the
// normalised tile, the f32 output accumulators and the hidden slice in
// shared memory, with 4-token x 4-channel register reuse (float4 shared
// loads).
//
// Train variant (template flag kZ1, ASY_MLP_BWD_RESIDUALS=1): the kernel also
// writes the pre-GELU z1 = xn @ w1 + b1, rounded to the working type, as
// (tokens, hid) rows, the residual the TPU kernel stores (_mlp_block_kernel's
// res_ref) and the backward (mlp_block_bwd.cu) then reads instead of
// recomputing fc1.  It adds tokens * hid * 2 bytes of writes (bf16); the
// output is the same bits as without it.
//
// Numerics mirror the TPU kernel: the normalised input and the GELU output
// are rounded to the working type (bf16) before each product, products
// accumulate in f32, and the residual sum is rounded once.  GELU is the exact
// erf form (CUDA erff); the TPU kernel uses an Abramowitz-Stegun polynomial
// (|error| <= 1.5e-7), far below bf16 resolution.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTokens = 32;   // tokens per block
constexpr int kHidden = 32;   // hidden slice per iteration

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
}

// Shared memory (floats): xs[kTokens][C] normalised input, ys[kTokens][C]
// accumulators, w1s[C][kHidden], w2s[kHidden][C], hs[kTokens][kHidden].
template <typename T, bool kZ1>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                 const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 T* __restrict__ out, T* __restrict__ z1, int ntok, int hw, int C, int hid) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ys = xs + kTokens * C;
  float* w1s = ys + kTokens * C;
  float* w2s = w1s + C * kHidden;
  float* hs = w2s + kHidden * C;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTokens;
  const int nt = min(kTokens, ntok - t0);

  for (int e = tid; e < kTokens * C; e += kThreads) {
    const int t = e / C;
    float v = 0.f;
    if (t < nt) {
      const int tok = t0 + t;
      const int b = tok / hw;
      v = asy::rnd<T>((asy::to_f<T>(x[(size_t)t0 * C + e]) - stats[2 * b]) *
                      stats[2 * b + 1]);
    }
    xs[e] = v;
    ys[e] = 0.f;
  }

  const int C4 = C / 4;
  for (int j0 = 0; j0 < hid; j0 += kHidden) {
    const int hc = min(kHidden, hid - j0);
    __syncthreads();  // previous slice fully consumed (and xs ready)
    for (int e = tid; e < C * kHidden; e += kThreads) {
      const int c = e / kHidden, j = e % kHidden;
      w1s[e] = j < hc ? asy::to_f<T>(w1[(size_t)c * hid + j0 + j]) : 0.f;
    }
    for (int e = tid; e < kHidden * C; e += kThreads) {
      const int j = e / C, c = e % C;
      w2s[e] = j < hc ? asy::to_f<T>(w2[(size_t)(j0 + j) * C + c]) : 0.f;
    }
    __syncthreads();
    // z = xs @ w1s + b1 -> GELU -> hs; thread (tg, j) owns tokens tg + 8k
    {
      const int j = tid % kHidden, tg = tid / kHidden;  // 8 token groups
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c4 = 0; c4 < C4; ++c4) {
        const float w0 = w1s[(4 * c4 + 0) * kHidden + j];
        const float wa = w1s[(4 * c4 + 1) * kHidden + j];
        const float wb = w1s[(4 * c4 + 2) * kHidden + j];
        const float wc = w1s[(4 * c4 + 3) * kHidden + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 xv = reinterpret_cast<const float4*>(xs + (tg + 8 * k) * C)[c4];
          acc[k] = fmaf(xv.x, w0, fmaf(xv.y, wa, fmaf(xv.z, wb, fmaf(xv.w, wc, acc[k]))));
        }
      }
      const float bias = j < hc ? b1[j0 + j] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tg + 8 * k;
        hs[t * kHidden + j] = j < hc ? asy::rnd<T>(gelu_erf(acc[k] + bias)) : 0.f;
        if (kZ1 && j < hc && t < nt)
          z1[(size_t)(t0 + t) * hid + j0 + j] = asy::from_f<T>(acc[k] + bias);
      }
    }
    __syncthreads();
    // ys += hs @ w2s; thread (tg, c) owns tokens 4*tg .. 4*tg+3
    for (int e = tid; e < (kTokens / 4) * C; e += kThreads) {
      const int c = e % C, tg = e / C;
      float acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = ys[(4 * tg + k) * C + c];
      for (int j4 = 0; j4 < kHidden / 4; ++j4) {
        const float w0 = w2s[(4 * j4 + 0) * C + c];
        const float wa = w2s[(4 * j4 + 1) * C + c];
        const float wb = w2s[(4 * j4 + 2) * C + c];
        const float wc = w2s[(4 * j4 + 3) * C + c];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 hv = reinterpret_cast<const float4*>(hs + (4 * tg + k) * kHidden)[j4];
          acc[k] = fmaf(hv.x, w0, fmaf(hv.y, wa, fmaf(hv.z, wb, fmaf(hv.w, wc, acc[k]))));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) ys[(4 * tg + k) * C + c] = acc[k];
    }
  }
  __syncthreads();
  for (int e = tid; e < nt * C; e += kThreads) {
    const int c = e % C;
    const size_t g = (size_t)t0 * C + e;
    out[g] = asy::from_f<T>(asy::to_f<T>(x[g]) + (ys[e] + b2[c]));
  }
}

template <typename T, bool kZ1>
int launch(const void* x, const float* stats, const void* w1, const float* b1,
           const void* w2, const float* b2, void* out, void* z1, int B, int HW, int C,
           int hid, void* stream) {
  if (C % 4 || B <= 0 || HW <= 0 || hid <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(2 * kTokens * C + 2 * C * kHidden +
                                               kTokens * kHidden);
  cudaError_t e = asy::set_smem(mlp_block_kernel<T, kZ1>, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntok = B * HW;
  const int grid = (ntok + kTokens - 1) / kTokens;
  mlp_block_kernel<T, kZ1><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, stats, (const T*)w1, b1, (const T*)w2, b2, (T*)out, (T*)z1, ntok, HW,
      C, hid);
  return (int)cudaGetLastError();
}

// ---- tensor-core path (bf16, C % 16 == 0, C <= kMaxC, hid % 8 == 0) ----
constexpr int kWarps = 4;       // per CTA
constexpr int kSlice = 64;      // hidden units staged per slice
constexpr int kMaxC = 160;
constexpr int kS1 = kSlice + 8;  // W1 slice row stride (bf16): ldmatrix rows on distinct banks

// Shared memory of one slice buffer (bf16 elements): W1 rows [C][kS1]
// (columns j0 .. j0 + kSlice of each channel's row), W2 rows [kSlice][C + 8].
__host__ __device__ constexpr int slice_elems(int C) { return C * kS1 + kSlice * (C + 8); }

// kNC: the accumulators' n-tiles (C/8 at most kNC), so that registers
// follow the width.  A CTA takes `tokens` = 16 * MT tokens (MT m-tiles) and
// splits each hidden slice over HS = 4 / MT warps: warp w owns m-tile w % MT
// and the slice's hidden units [w / MT * 64 / HS, ...), 32 at a time (16
// with HS = 4).  It
// keeps its tokens' normalised A-fragments in registers and turns the first
// product's accumulators (after bias, GELU and the bf16 round) directly
// into the second product's A-fragment, so the hidden activations never
// leave registers.  The W1/W2 slices are staged with cp.async, two buffers:
// slice s + 1 loads while slice s multiplies, one barrier a slice; B
// fragments come from the row-major slices by ldmatrix.trans.  The HS
// partial fc2 sums of a token are added in warp order through shared
// memory (with HS = 1 the sum is the one warp's, the order of a single
// hidden loop).
template <int kNC, bool kZ1>
__global__ void __launch_bounds__(kWarps * 32, kNC <= 10 ? 4 : 1)
mlp_block_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ stats,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                     __nv_bfloat16* __restrict__ z1, int ntok, int hw, int C, int hid,
                     int tokens) {
  using asy::mma16816;
  using asy::pack_bf16;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int s2 = C + 8, per = slice_elems(C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int MT = tokens / 16, HS = kWarps / MT, part = kSlice / HS;
  const int mt = warp % MT, hs = warp / MT;
  const int t0 = blockIdx.x * tokens;
  const int rows[2] = {t0 + mt * 16 + g, t0 + mt * 16 + g + 8};
  const int slices = (hid + kSlice - 1) / kSlice;
  // stage slice s into buffer s % 2: 16-byte copies, hidden units past hid
  // zero filled (hid % 8 == 0: a copy is all in or all out)
  auto stage = [&](int s) {
    __nv_bfloat16* w1s = buf + (s % 2) * per;
    __nv_bfloat16* w2s = w1s + C * kS1;
    const int j0 = s * kSlice;
    for (int e = threadIdx.x; e < C * (kSlice / 8); e += blockDim.x) {
      const int c = e / (kSlice / 8), j = (e % (kSlice / 8)) * 8;
      const bool ok = j0 + j < hid;
      asy::cp_async<16>(w1s + c * kS1 + j, w1 + (ok ? (size_t)c * hid + j0 + j : 0), ok);
    }
    for (int e = threadIdx.x; e < kSlice * (C / 8); e += blockDim.x) {
      const int j = e / (C / 8), c = (e % (C / 8)) * 8;
      const bool ok = j0 + j < hid;
      asy::cp_async<16>(w2s + j * s2 + c, w2 + (ok ? (size_t)(j0 + j) * C + c : 0), ok);
    }
    asy::cp_async_commit();
  };
  stage(0);

  float mu[2], rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = rows[i] < ntok ? rows[i] / hw : 0;
    mu[i] = stats[2 * b];
    rs[i] = stats[2 * b + 1];
  }
  auto norm_pair = [&](int i, int c) -> uint32_t {  // xn at (rows[i], c..c+1)
    if (rows[i] >= ntok) return 0u;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        x + (size_t)rows[i] * C + c);
    return pack_bf16((__bfloat162float(v.x) - mu[i]) * rs[i],
                     (__bfloat162float(v.y) - mu[i]) * rs[i]);
  };
  const int ksteps = C / 16, ntiles = C / 8;
  uint32_t xa[kNC / 2][4];
#pragma unroll
  for (int kk = 0; kk < kNC / 2; ++kk) {
    if (kk < ksteps) {
      const int c = kk * 16 + 2 * t;
      xa[kk][0] = norm_pair(0, c);
      xa[kk][1] = norm_pair(1, c);
      xa[kk][2] = norm_pair(0, c + 8);
      xa[kk][3] = norm_pair(1, c + 8);
    }
  }
  float y[kNC][4];
#pragma unroll
  for (int nc = 0; nc < kNC; ++nc) y[nc][0] = y[nc][1] = y[nc][2] = y[nc][3] = 0.f;

  for (int s = 0; s < slices; ++s) {
    asy::cp_async_wait<0>();
    __syncthreads();  // slice s staged; every warp is done with slice s - 1
    if (s + 1 < slices) stage(s + 1);
    const __nv_bfloat16* w1s = buf + (s % 2) * per;
    const __nv_bfloat16* w2s = w1s + C * kS1;
    // kN n-tiles (8 hidden units each) of the first product at a time: 4
    // where the warp owns 32 or more of the slice (independent accumulator
    // chains for the tensor cores' latency), else 2
    auto step = [&](int h, auto n_tag) {
      constexpr int kN = decltype(n_tag)::value;
      float z[kN][4] = {};
#pragma unroll
      for (int kk = 0; kk < kNC / 2; ++kk) {
        if (kk < ksteps) {
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            uint32_t b0, b1v;
            asy::ldmatrix_b(b0, b1v, w1s + kk * 16 * kS1 + h + n * 8, kS1);
            mma16816(z[n], xa[kk], b0, b1v);
          }
        }
      }
      // bias + GELU + bf16 round: accumulator tiles (2ks, 2ks+1) become the
      // A-fragment of hidden k-step ks
      uint32_t ha[kN / 2][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int j = s * kSlice + h + n * 8 + 2 * t;
        const float c0 = j < hid ? b1[j] : 0.f, c1 = j + 1 < hid ? b1[j + 1] : 0.f;
        ha[n / 2][2 * (n % 2)] = pack_bf16(gelu_erf(z[n][0] + c0), gelu_erf(z[n][1] + c1));
        ha[n / 2][2 * (n % 2) + 1] = pack_bf16(gelu_erf(z[n][2] + c0), gelu_erf(z[n][3] + c1));
        if (kZ1 && j < hid) {  // hid % 8 == 0: j and j + 1 are both in range
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (rows[i] < ntok)
              *reinterpret_cast<uint32_t*>(z1 + (size_t)rows[i] * hid + j) =
                  pack_bf16(z[n][2 * i] + c0, z[n][2 * i + 1] + c1);
          }
        }
      }
#pragma unroll
      for (int nc = 0; nc < kNC; ++nc) {
        if (nc < ntiles) {
#pragma unroll
          for (int ks = 0; ks < kN / 2; ++ks) {
            uint32_t b0, b1v;
            asy::ldmatrix_b(b0, b1v, w2s + (h + ks * 16) * s2 + nc * 8, s2);
            mma16816(y[nc], ha[ks], b0, b1v);
          }
        }
      }
    };
    if (part >= 32) {
      for (int h = hs * part; h < (hs + 1) * part; h += 32)
        step(h, std::integral_constant<int, 4>{});
    } else {
      step(hs * part, std::integral_constant<int, 2>{});
    }
  }
  // the warps' fc2 partials [warp][16][C] (f32) over the slice buffers
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int nc = 0; nc < kNC; ++nc) {
    if (nc < ntiles) {
      const int c = nc * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(red + ((size_t)warp * 16 + g + 8 * i) * C + c) =
            make_float2(y[nc][2 * i], y[nc][2 * i + 1]);
    }
  }
  __syncthreads();
  // out = x + (sum of the partials in warp order + b2), rounded once
  for (int e = threadIdx.x; e < tokens * (C / 2); e += blockDim.x) {
    const int r = e / (C / 2), c = 2 * (e % (C / 2)), row = t0 + r;
    if (row >= ntok) continue;
    const int m = r / 16, rr = r % 16;
    float2 v = *reinterpret_cast<const float2*>(red + ((size_t)m * 16 + rr) * C + c);
    for (int k = 1; k < HS; ++k) {
      const float2 p = *reinterpret_cast<const float2*>(
          red + ((size_t)(k * MT + m) * 16 + rr) * C + c);
      v.x += p.x;
      v.y += p.y;
    }
    const size_t o = (size_t)row * C + c;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + o);
    *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(__bfloat162float(xv.x) + (v.x + b2[c]),
                                                      __bfloat162float(xv.y) + (v.y + b2[c + 1]));
  }
}

// the accumulator width of C's instantiation: the smallest kNC >= C / 8
template <bool kZ1> struct MmaKernel {
  using Fn = decltype(&mlp_block_mma_kernel<2, kZ1>);
  static Fn pick(int C) {
    const int nc = C / 8;
    return nc <= 2    ? mlp_block_mma_kernel<2, kZ1>
           : nc <= 4  ? mlp_block_mma_kernel<4, kZ1>
           : nc <= 8  ? mlp_block_mma_kernel<8, kZ1>
           : nc <= 10 ? mlp_block_mma_kernel<10, kZ1>
           : nc <= 16 ? mlp_block_mma_kernel<16, kZ1>
                      : mlp_block_mma_kernel<20, kZ1>;
  }
};

inline bool mma_shape(int C, int hid) { return C % 16 == 0 && C <= kMaxC && hid % 8 == 0; }
// two slice buffers (they also hold the warps' partials: 4 * 16 * C floats)
inline size_t mma_smem(int C) { return 2 * sizeof(__nv_bfloat16) * (size_t)slice_elems(C); }
inline bool mma_tokens(int tokens) { return tokens == 16 || tokens == 32 || tokens == 64; }

// tokens per CTA: 16, 32 or 64
template <bool kZ1>
int launch_mma(const void* x, const float* stats, const void* w1, const float* b1,
               const void* w2, const float* b2, void* out, void* z1, int B, int HW, int C,
               int hid, int tokens, void* stream) {
  if (!mma_tokens(tokens)) return (int)cudaErrorInvalidValue;
  const auto kernel = MmaKernel<kZ1>::pick(C);
  const size_t smem = mma_smem(C);
  cudaError_t e = asy::set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntok = B * HW;
  const int grid = (ntok + tokens - 1) / tokens;
  kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, stats, (const __nv_bfloat16*)w1, b1,
      (const __nv_bfloat16*)w2, b2, (__nv_bfloat16*)out, (__nv_bfloat16*)z1, ntok, HW, C,
      hid, tokens);
  return (int)cudaGetLastError();
}

// ---- wide tensor-core paths (bf16, 160 < C <= 640, C % 16 == 0, hid % 8 == 0) ----
// fc2's C output channels of a token are split over the warps of a CTA of 16
// warps (512 threads, one CTA an SM), so that no thread holds more than 80
// accumulators; the hidden units go by in slices whose weights load with
// cp.async.  Two kernels:
//   up to C = 320 (kWide128MaxC), mlp_block_mma_kernel_wide128: 128 tokens a
//     CTA, slices of 64 units; each warp takes fc1 of a 32-token x 16-unit
//     tile over all of C, in k-step order, then + b1, GELU, the bf16 round
//     (and z1) in its registers; fc2 of slice s and fc1 of slice s + 1 run
//     in one phase, two barriers a slice;
//   wider, mlp_block_mma_kernel_wide: 64 tokens a CTA (xn of 128 would not
//     fit in shared memory), slices of 32, fc1 over 4 channel quarters
//     whose f32 partials are added in quarter order, three barriers a
//     slice.
// fc2 accumulates hidden tile @ W2 slice in registers, slice by slice, so
// each output has one owner and one summation order.  The 128-token kernel
// reads each weight once for twice the tokens and spends a barrier a slice
// less: 149-165 TFLOP/s at C = 256 and 320 on an H100 (batch 256), where a
// 64-token kernel of 8 warps, two CTAs an SM, read 103-120; past C = 320
// only the 64-token kernel fits.
constexpr int kWideMaxC = 640;
constexpr int kWide128MaxC = 320;            // the 128-token kernel's widest C
constexpr int kQuarters = 4;                 // the 64-token kernel's fc1 quarters
constexpr int kW64 = 16, kS64 = 32;          // its warps and slice
constexpr int kW128 = 16, kS128 = 64;        // the 128-token kernel's

namespace wide {

__device__ __forceinline__ void stage_xn(__nv_bfloat16* xs, const __nv_bfloat16* x,
                                         const float* stats, int t0, int tokens, int ntok,
                                         int hw, int C) {
  // xn = rnd((x - mu) * rstd), 8 channels a step; rows past ntok are zero
  for (int e = threadIdx.x; e < tokens * (C / 8); e += blockDim.x) {
    const int r = e / (C / 8), c = (e % (C / 8)) * 8, row = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < ntok) {
      const int b = row / hw;
      const float mu = stats[2 * b], rs = stats[2 * b + 1];
      const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * C + c);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&in[k]);
        o[k] = asy::pack_bf16((__bfloat162float(h.x) - mu) * rs,
                              (__bfloat162float(h.y) - mu) * rs);
      }
      v = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(xs + r * (C + 8) + c) = v;
  }
}

// Slice s of W1 (C rows of kS units, row stride kS + 8) or of W2 (kS rows of
// C, row stride C + 8) into shared memory, 16 bytes a copy, units past hid
// zero filled; the caller commits
template <int kS>
__device__ __forceinline__ void stage_w1(__nv_bfloat16* dst, const __nv_bfloat16* w1, int s,
                                         int C, int hid) {
  const int j0 = s * kS;
  for (int e = threadIdx.x; e < C * (kS / 8); e += blockDim.x) {
    const int c = e / (kS / 8), j = (e % (kS / 8)) * 8;
    const bool ok = j0 + j < hid;
    asy::cp_async<16>(dst + c * (kS + 8) + j, w1 + (ok ? (size_t)c * hid + j0 + j : 0), ok);
  }
}
template <int kS>
__device__ __forceinline__ void stage_w2(__nv_bfloat16* dst, const __nv_bfloat16* w2, int s,
                                         int C, int hid) {
  const int j0 = s * kS;
  for (int e = threadIdx.x; e < kS * (C / 8); e += blockDim.x) {
    const int j = e / (C / 8), c = (e % (C / 8)) * 8;
    const bool ok = j0 + j < hid;
    asy::cp_async<16>(dst + j * (C + 8) + c, w2 + (ok ? (size_t)(j0 + j) * C + c : 0), ok);
  }
}

// out = x + (y + b2), rounded once, for the n-tiles [n_lo, n_lo + cnt) of
// tokens [t0 + 32 mh, +32)
template <int kNW>
__device__ __forceinline__ void store_out(const float (&y)[2][kNW][4], const __nv_bfloat16* x,
                                          const float* b2, __nv_bfloat16* out, int t0, int mh,
                                          int n_lo, int cnt, int ntok, int C) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int n = 0; n < kNW; ++n) {
      if (n < cnt) {
        const int c = (n_lo + n) * 8 + 2 * t;
        const float c0 = b2[c], c1 = b2[c + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = t0 + 32 * mh + 16 * i + g + 8 * hh;
          if (row < ntok) {
            const size_t o = (size_t)row * C + c;
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + o);
            *reinterpret_cast<uint32_t*>(out + o) =
                asy::pack_bf16(__bfloat162float(xv.x) + (y[i][n][2 * hh] + c0),
                               __bfloat162float(xv.y) + (y[i][n][2 * hh + 1] + c1));
          }
        }
      }
    }
  }
}

}  // namespace wide

// The 128-token kernel's shared memory: xn [128][C + 8], the W1 slice
// [C][kS128 + 8], the W2 slice [kS128][C + 8], the hidden tile [128][kS128 + 8]
inline size_t wide128_smem(int C) {
  return ((size_t)128 * (C + 8) + (size_t)C * (kS128 + 8) + (size_t)kS128 * (C + 8) +
          (size_t)128 * (kS128 + 8)) * 2;
}

template <int kNW, bool kZ1>
__global__ void __launch_bounds__(kW128 * 32, 1)
mlp_block_mma_kernel_wide128(const __nv_bfloat16* __restrict__ x,
                             const float* __restrict__ stats,
                             const __nv_bfloat16* __restrict__ w1,
                             const float* __restrict__ b1,
                             const __nv_bfloat16* __restrict__ w2,
                             const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                             __nv_bfloat16* __restrict__ z1, int ntok, int hw, int C, int hid) {
  using asy::mma16816;
  using asy::pack_bf16;
  constexpr int kT = 128, kS = kS128, kS1 = kS + 8;
  constexpr int kM = kT / 32;                // 32-token tiles
  constexpr int kGroups = kW128 / kM;        // fc2's out-channel groups
  static_assert(kM * (kS / 16) == kW128, "fc1: one 32 x 16 tile a warp");
  extern __shared__ float4 smem4[];
  const int SX = C + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* w1s = xs + (size_t)kT * SX;
  __nv_bfloat16* w2s = w1s + (size_t)C * kS1;
  __nv_bfloat16* hs = w2s + (size_t)kS * SX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int t0 = blockIdx.x * kT;
  const int slices = (hid + kS - 1) / kS;
  // fc1: tokens [32 mp, +32), units [16 np, +16) of the slice; fc2: tokens
  // [32 mp, +32), n-tiles [n_lo, n_lo + cnt) of the C / 8
  const int mp = warp % kM, np = warp / kM, ntiles = C / 8;
  const int n_lo = np * ntiles / kGroups, cnt = (np + 1) * ntiles / kGroups - n_lo;

  float z[2][2][4];
  auto fc1 = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) z[i][n][0] = z[i][n][1] = z[i][n][2] = z[i][n][3] = 0.f;
#pragma unroll 1  // unrolled, the k-steps' fragments crowd fc2's 80 accumulators
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[2][4], b[2][2];
      asy::ldmatrix_a(a[0], xs + (32 * mp) * SX + kk * 16, SX);
      asy::ldmatrix_a(a[1], xs + (32 * mp + 16) * SX + kk * 16, SX);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        asy::ldmatrix_b(b[n][0], b[n][1], w1s + kk * 16 * kS1 + 16 * np + 8 * n, kS1);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma16816(z[i][n], a[i], b[n][0], b[n][1]);
    }
  };
  // + b1, GELU, bf16 of this warp's tile of slice s into the hidden tile (z1 before GELU)
  auto gelu = [&](int s) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = 16 * np + 8 * n + 2 * t, j = s * kS + c;
      // hid % 8 == 0: j and j + 1 are both in range or out
      const float2 bias = j < hid ? make_float2(b1[j], b1[j + 1]) : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 32 * mp + 16 * i + g + 8 * hh;
          uint32_t h = 0u;
          if (j < hid) {
            const float za = z[i][n][2 * hh] + bias.x, zb = z[i][n][2 * hh + 1] + bias.y;
            h = pack_bf16(gelu_erf(za), gelu_erf(zb));
            if (kZ1 && t0 + r < ntok)
              *reinterpret_cast<uint32_t*>(z1 + (size_t)(t0 + r) * hid + j) = pack_bf16(za, zb);
          }
          *reinterpret_cast<uint32_t*>(hs + r * kS1 + c) = h;
        }
      }
    }
  };
  float y[2][kNW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNW; ++n) y[i][n][0] = y[i][n][1] = y[i][n][2] = y[i][n][3] = 0.f;
  auto fc2 = [&]() {
#pragma unroll
    for (int ks = 0; ks < kS / 16; ++ks) {
      uint32_t a[2][4];
      asy::ldmatrix_a(a[0], hs + (32 * mp) * kS1 + ks * 16, kS1);
      asy::ldmatrix_a(a[1], hs + (32 * mp + 16) * kS1 + ks * 16, kS1);
#pragma unroll
      for (int n = 0; n < kNW; ++n) {
        if (n < cnt) {
          uint32_t b0, b1v;
          asy::ldmatrix_b(b0, b1v, w2s + ks * 16 * SX + (n_lo + n) * 8, SX);
          mma16816(y[0][n], a[0], b0, b1v);
          mma16816(y[1][n], a[1], b0, b1v);
        }
      }
    }
  };

  // slice 0's fc1 and GELU; then per slice s: fc2 of s and fc1 of s + 1,
  // barrier, the loads of W1 s + 2 and W2 s + 1, GELU of s + 1, barrier
  wide::stage_w1<kS>(w1s, w1, 0, C, hid);
  asy::cp_async_commit();
  wide::stage_xn(xs, x, stats, t0, kT, ntok, hw, C);
  asy::cp_async_wait<0>();
  __syncthreads();
  fc1();
  __syncthreads();  // W1 slice 0 read
  if (slices > 1) wide::stage_w1<kS>(w1s, w1, 1, C, hid);
  wide::stage_w2<kS>(w2s, w2, 0, C, hid);
  asy::cp_async_commit();
  gelu(0);
  for (int s = 0; s < slices; ++s) {
    asy::cp_async_wait<0>();
    __syncthreads();  // hidden tile s, W2 slice s and W1 slice s + 1 in place
    fc2();
    if (s + 1 < slices) fc1();
    __syncthreads();  // the hidden tile and both slices read
    if (s + 2 < slices) wide::stage_w1<kS>(w1s, w1, s + 2, C, hid);
    if (s + 1 < slices) wide::stage_w2<kS>(w2s, w2, s + 1, C, hid);
    asy::cp_async_commit();
    if (s + 1 < slices) gelu(s + 1);
  }
  wide::store_out<kNW>(y, x, b2, out, t0, mp, n_lo, cnt, ntok, C);
}

constexpr int kWideTokens = 64;

struct WideSmem {  // byte offsets, each 16-byte aligned
  size_t xs, w1s, w2s, hs, red, bytes;
};

// slices of kS units (row strides kS + 8) with nb1 W1 and nb2 W2 buffers
__host__ __device__ inline WideSmem wide_smem(int C, int kS, int nb1, int nb2) {
  const size_t s1 = kS + 8;
  WideSmem s;
  s.xs = 0;                                                // [64][C + 8] bf16 xn
  s.w1s = s.xs + (size_t)kWideTokens * (C + 8) * 2;        // [nb1][C][kS + 8] bf16
  s.w2s = s.w1s + (size_t)nb1 * C * s1 * 2;                // [nb2][kS][C + 8] bf16
  s.hs = s.w2s + (size_t)nb2 * kS * (C + 8) * 2;           // [64][kS + 8] bf16
  s.red = s.hs + (size_t)kWideTokens * s1 * 2;             // [4][64][kS + 8] f32
  s.bytes = s.red + (size_t)kQuarters * kWideTokens * s1 * 4;
  return s;
}

// The 64-token kernel: its normalised input (rounded to bf16) is staged
// once; per slice of kS64 units, fc1 splits over the warps as 4 channel
// quarters x tiles of 32 tokens x 16 units, the quarters' f32 partials go
// through shared memory and are added in quarter order, then + b1, GELU and
// the bf16 round give the hidden tile (and z1); fc2's out-channel group w /
// 2 (of 8, at most kNW n-tiles each) of tokens [32 (w % 2), +32)
// accumulates hidden tile @ W2 slice.  The weight slices load each into one
// of nb1 (W1) or nb2 (W2) buffers, as many as shared memory holds: a
// double-buffered slice loads a whole slice ahead, a single W2 slice while
// fc1 runs, a single W1 slice while the GELU and fc2 run.  Three barriers a
// slice (221,696 bytes at C = 640).
template <int kNW, bool kZ1>
__global__ void __launch_bounds__(kW64 * 32, 1)
mlp_block_mma_kernel_wide(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ stats,
                          const __nv_bfloat16* __restrict__ w1,
                          const float* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ w2,
                          const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                          __nv_bfloat16* __restrict__ z1, int ntok, int hw, int C, int hid,
                          int nb1, int nb2) {
  using asy::mma16816;
  using asy::pack_bf16;
  constexpr int kW = kW64, kS = kS64;
  constexpr int kS1 = kS + 8;                      // W1 slice, hidden tile, partial row strides
  constexpr int kTiles = 2 * (kS / 16);            // fc1's 32 x 16 tiles of a quarter
  static_assert(kQuarters * kTiles == kW, "fc1: one tile of one quarter a warp");
  constexpr int kGroups = kW / 2;                  // fc2's out-channel groups
  constexpr int kEpi = kWideTokens * kS / 2 / (kW * 32);  // GELU pairs a thread
  extern __shared__ float4 smem4[];
  const WideSmem L = wide_smem(C, kS, nb1, nb2);
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sb + L.xs);
  __nv_bfloat16* w1b = reinterpret_cast<__nv_bfloat16*>(sb + L.w1s);
  __nv_bfloat16* w2b = reinterpret_cast<__nv_bfloat16*>(sb + L.w2s);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(sb + L.hs);
  float* red = reinterpret_cast<float*>(sb + L.red);
  const int SX = C + 8, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int t0 = blockIdx.x * kWideTokens;
  const int slices = (hid + kS - 1) / kS;
  // fc1: channel quarter q, tokens [32 mp, +32), units [16 np, +16) of the slice
  const int q = warp / kTiles, mp = warp % 2, np = (warp % kTiles) / 2;
  const int ksteps = C / 16, k_lo = q * ksteps / kQuarters, k_hi = (q + 1) * ksteps / kQuarters;
  // fc2: tokens [32 mh, +32), n-tiles [n_lo, n_lo + cnt) of the C / 8
  const int mh = warp % 2, grp = warp / 2, ntiles = C / 8;
  const int n_lo = grp * ntiles / kGroups, cnt = (grp + 1) * ntiles / kGroups - n_lo;
  auto w1s = [&](int s) { return w1b + (size_t)(s % nb1) * C * kS1; };
  auto w2s = [&](int s) { return w2b + (size_t)(s % nb2) * kS * SX; };

  auto stage_w1 = [&](int s) { wide::stage_w1<kS>(w1s(s), w1, s, C, hid); };
  auto stage_w2 = [&](int s) { wide::stage_w2<kS>(w2s(s), w2, s, C, hid); };
  stage_w1(0);
  if (nb2 == 2) stage_w2(0);
  asy::cp_async_commit();
  wide::stage_xn(xs, x, stats, t0, kWideTokens, ntok, hw, C);

  float y[2][kNW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNW; ++n) y[i][n][0] = y[i][n][1] = y[i][n][2] = y[i][n][3] = 0.f;

  // the epilogue's elements of this thread: rows er + (64 / kEpi) k, units ec, ec + 1
  const int er = tid / (kS / 2), ec = 2 * (tid % (kS / 2));
  for (int s = 0; s < slices; ++s) {
    asy::cp_async_wait<0>();
    __syncthreads();  // slice s's weights and xn in place; fc2 of slice s - 1 done
    if (nb2 == 2) {
      if (s + 1 < slices) stage_w2(s + 1);
    } else {
      stage_w2(s);
    }
    asy::cp_async_commit();
    if (nb1 == 2 && s + 1 < slices) stage_w1(s + 1);
    asy::cp_async_commit();
    const int j = s * kS + ec;  // hid % 8 == 0: j and j + 1 are both in range or out
    const float2 bias = j < hid ? make_float2(b1[j], b1[j + 1]) : make_float2(0.f, 0.f);
    {
      const __nv_bfloat16* w1t = w1s(s);
      float z[2][2][4] = {};
#pragma unroll 2
      for (int kk = k_lo; kk < k_hi; ++kk) {
        uint32_t a[2][4], b[2][2];
        asy::ldmatrix_a(a[0], xs + (32 * mp) * SX + kk * 16, SX);
        asy::ldmatrix_a(a[1], xs + (32 * mp + 16) * SX + kk * 16, SX);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          asy::ldmatrix_b(b[n][0], b[n][1], w1t + kk * 16 * kS1 + 16 * np + 8 * n, kS1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n) mma16816(z[i][n], a[i], b[n][0], b[n][1]);
      }
      float* rq = red + (size_t)q * kWideTokens * kS1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int r = 32 * mp + 16 * i + g, c = 16 * np + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(rq + r * kS1 + c) = make_float2(z[i][n][0], z[i][n][1]);
          *reinterpret_cast<float2*>(rq + (r + 8) * kS1 + c) =
              make_float2(z[i][n][2], z[i][n][3]);
        }
      }
    }
    __syncthreads();  // the partials in red; slice s's W1 buffer free
    if (nb1 == 1 && s + 1 < slices) stage_w1(s + 1);
    asy::cp_async_commit();
    // the quarters in order, + b1, GELU, bf16: the hidden tile (z1 before GELU)
#pragma unroll
    for (int k = 0; k < kEpi; ++k) {
      const int r = er + k * (kWideTokens / kEpi);
      float2 v = *reinterpret_cast<const float2*>(red + r * kS1 + ec);
#pragma unroll
      for (int u = 1; u < kQuarters; ++u) {
        const float2 p =
            *reinterpret_cast<const float2*>(red + ((size_t)u * kWideTokens + r) * kS1 + ec);
        v.x += p.x;
        v.y += p.y;
      }
      uint32_t h = 0u;
      if (j < hid) {
        const float za = v.x + bias.x, zb = v.y + bias.y;
        h = pack_bf16(gelu_erf(za), gelu_erf(zb));
        if (kZ1 && t0 + r < ntok)
          *reinterpret_cast<uint32_t*>(z1 + (size_t)(t0 + r) * hid + j) = pack_bf16(za, zb);
      }
      *reinterpret_cast<uint32_t*>(hs + r * kS1 + ec) = h;
    }
    if (nb2 == 1) asy::cp_async_wait<2>();  // W2 slice s (the groups after it may be in flight)
    __syncthreads();                         // the hidden tile and W2 slice s in place
    const __nv_bfloat16* w2t = w2s(s);
#pragma unroll
    for (int ks = 0; ks < kS / 16; ++ks) {
      uint32_t a[2][4];
      asy::ldmatrix_a(a[0], hs + (32 * mh) * kS1 + ks * 16, kS1);
      asy::ldmatrix_a(a[1], hs + (32 * mh + 16) * kS1 + ks * 16, kS1);
#pragma unroll
      for (int n = 0; n < kNW; ++n) {
        if (n < cnt) {
          uint32_t b0, b1v;
          asy::ldmatrix_b(b0, b1v, w2t + ks * 16 * SX + (n_lo + n) * 8, SX);
          mma16816(y[0][n], a[0], b0, b1v);
          mma16816(y[1][n], a[1], b0, b1v);
        }
      }
    }
  }
  wide::store_out<kNW>(y, x, b2, out, t0, mh, n_lo, cnt, ntok, C);
}

// The 64-token kernel at width C (kNW, the n-tiles a warp may own, at least
// C / 8 over the 8 fc2 groups) with the most slice buffers (W1 first) whose
// layout fits the card's shared memory
template <bool kZ1> struct Wide64 {
  using Fn = decltype(&mlp_block_mma_kernel_wide<8, kZ1>);
  Fn fn;
  int nb1, nb2;
  size_t smem;
  explicit Wide64(int C) {
    fn = (C / 8 + 7) / 8 <= 8 ? mlp_block_mma_kernel_wide<8, kZ1>
                              : mlp_block_mma_kernel_wide<10, kZ1>;
    size_t optin = 0, per_sm = 0;
    asy::smem_limits(&optin, &per_sm);
    // the SM's memory, less the 1 KB the card reserves for a CTA
    const size_t room = std::min(optin, per_sm - 1024);
    const int opts[3][2] = {{2, 2}, {2, 1}, {1, 1}};
    for (const auto& o : opts) {
      nb1 = o[0];
      nb2 = o[1];
      if (wide_smem(C, kS64, nb1, nb2).bytes <= room) break;
    }
    smem = wide_smem(C, kS64, nb1, nb2).bytes;
  }
};

// The 128-token kernel at width C (kNW: C / 8 over its 4 fc2 groups)
template <bool kZ1> struct Wide128 {
  using Fn = decltype(&mlp_block_mma_kernel_wide128<8, kZ1>);
  Fn fn;
  size_t smem;
  explicit Wide128(int C)
      : fn((C / 8 + 3) / 4 <= 8 ? mlp_block_mma_kernel_wide128<8, kZ1>
                                : mlp_block_mma_kernel_wide128<10, kZ1>),
        smem(wide128_smem(C)) {}
};

inline bool wide_shape(int C, int hid) {
  return C % 16 == 0 && C > kMaxC && C <= kWideMaxC && hid % 8 == 0;
}

// tokens a CTA of the wide kernel at width C
inline int wide_tokens(int C) { return C <= kWide128MaxC ? 128 : kWideTokens; }

template <bool kZ1>
int launch_wide(const void* x, const float* stats, const void* w1, const float* b1,
                const void* w2, const float* b2, void* out, void* z1, int B, int HW, int C,
                int hid, void* stream) {
  const int ntok = B * HW, tokens = wide_tokens(C);
  const int grid = (ntok + tokens - 1) / tokens;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto *w1b = (const __nv_bfloat16*)w1, *w2b = (const __nv_bfloat16*)w2;
  auto* ob = (__nv_bfloat16*)out;
  auto* zb = (__nv_bfloat16*)z1;
  cudaError_t e;
  if (tokens == 128) {
    const Wide128<kZ1> k(C);
    e = asy::set_smem(k.fn, k.smem);
    if (e != cudaSuccess) return (int)e;
    k.fn<<<grid, kW128 * 32, k.smem, (cudaStream_t)stream>>>(xb, stats, w1b, b1, w2b, b2, ob,
                                                             zb, ntok, HW, C, hid);
  } else {
    const Wide64<kZ1> k(C);
    e = asy::set_smem(k.fn, k.smem);
    if (e != cudaSuccess) return (int)e;
    k.fn<<<grid, kW64 * 32, k.smem, (cudaStream_t)stream>>>(xb, stats, w1b, b1, w2b, b2, ob,
                                                            zb, ntok, HW, C, hid, k.nb1, k.nb2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z1 may be null (inference, or training without the z1 residual).  tokens:
// tokens per CTA of the tensor-core path (16, 32 or 64), which runs exactly
// when C % 16 == 0, C <= 160, hid % 8 == 0 and the operands are 16-byte
// aligned; 128 (C <= 320) or 64 for the wide tensor-core path, which runs at
// 160 < C <= 640 under the same other conditions; 0 for the CUDA-core path,
// which runs otherwise.  A `tokens` that names another path is refused: it picks the
// geometry, never the path.
int mlp_block_bf16(const void* x, const float* stats, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, void* z1,
                   int B, int HW, int C, int hid, int tokens, void* stream) {
  if (B <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = asy::copy_bytes({(size_t)x, (size_t)w1, (size_t)w2, (size_t)out,
                                        (size_t)z1}) == 16;
  if (wide_shape(C, hid) && aligned) {
    if (tokens != wide_tokens(C)) return (int)cudaErrorInvalidValue;
    return z1 != nullptr
               ? launch_wide<true>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid, stream)
               : launch_wide<false>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid, stream);
  }
  const bool mma = mma_shape(C, hid) && aligned;
  if (mma != (tokens > 0)) return (int)cudaErrorInvalidValue;
  if (mma) {
    return z1 != nullptr ? launch_mma<true>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid,
                                            tokens, stream)
                         : launch_mma<false>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C,
                                             hid, tokens, stream);
  }
  return z1 != nullptr
             ? launch<__nv_bfloat16, true>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid,
                                           stream)
             : launch<__nv_bfloat16, false>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid,
                                            stream);
}

int mlp_block_f32(const void* x, const float* stats, const void* w1,
                  const float* b1, const void* w2, const float* b2, void* out, void* z1,
                  int B, int HW, int C, int hid, int tokens, void* stream) {
  if (tokens != 0) return (int)cudaErrorInvalidValue;
  return z1 != nullptr
             ? launch<float, true>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid, stream)
             : launch<float, false>(x, stats, w1, b1, w2, b2, out, z1, B, HW, C, hid, stream);
}

// The tensor-core kernel at width C with `tokens` per CTA (past C = 160 the
// wide one, with wide_tokens(C)): out = [dynamic shared memory bytes, CTAs
// per SM, registers per thread]
int mlp_block_info(int C, int tokens, int* out) {
  auto fill = [&](auto kernel, size_t smem, int threads) {
    cudaError_t e = asy::set_smem(kernel, smem);
    int per_sm = 0;
    cudaFuncAttributes attr = {};
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    out[0] = (int)smem;
    out[1] = per_sm;
    out[2] = attr.numRegs;
    return 0;
  };
  if (wide_shape(C, 8)) {
    if (tokens != wide_tokens(C)) return (int)cudaErrorInvalidValue;
    if (tokens == 128) {
      const Wide128<false> k(C);
      return fill(k.fn, k.smem, kW128 * 32);
    }
    const Wide64<false> k(C);
    return fill(k.fn, k.smem, kW64 * 32);
  }
  if (!mma_shape(C, 8) || !mma_tokens(tokens)) return (int)cudaErrorInvalidValue;
  return fill(MmaKernel<false>::pick(C), mma_smem(C), kWarps * 32);
}

}  // extern "C"
