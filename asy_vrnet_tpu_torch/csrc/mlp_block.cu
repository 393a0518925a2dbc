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
// Two paths.  bf16 with C a multiple of 16 (up to 160), hid a multiple of 8
// and 16-byte aligned operands, the main path, runs on tensor cores
// (mma.sync m16n8k16, f32 accumulation; mlp_block_mma_kernel below).  Its
// accumulators are sized to C (a template on C/8), so registers follow the
// width; a CTA of 4 warps takes 64, 32 or 16 tokens, chosen by the caller
// from the token count so that the grid covers the card where the tokens
// allow, and below 64 tokens its warps split the hidden units and add their
// partial fc2 sums in a fixed order; the weight slices are double-buffered
// with cp.async.  Everything else (f32, other widths) runs as f32 FMA on
// CUDA cores: one block per 32 tokens keeps the normalised tile, the f32
// output accumulators and the hidden slice in shared memory, with 4-token x
// 4-channel register reuse (float4 shared loads).
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

}  // namespace

extern "C" {

// z1 may be null (inference, or training without the z1 residual).  tokens:
// tokens per CTA of the tensor-core path (16, 32 or 64), which runs exactly
// when C % 16 == 0, C <= 160, hid % 8 == 0 and the operands are 16-byte
// aligned; 0 for the CUDA-core path, which runs otherwise.  A `tokens` that
// names the other path is refused: it picks the geometry, never the path.
int mlp_block_bf16(const void* x, const float* stats, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, void* z1,
                   int B, int HW, int C, int hid, int tokens, void* stream) {
  if (B <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  const bool mma = mma_shape(C, hid) && asy::copy_bytes({(size_t)x, (size_t)w1, (size_t)w2,
                                                         (size_t)out, (size_t)z1}) == 16;
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

// The tensor-core kernel at width C with `tokens` per CTA: out = [dynamic
// shared memory bytes, CTAs per SM, registers per thread]
int mlp_block_info(int C, int tokens, int* out) {
  if (!mma_shape(C, 8) || !mma_tokens(tokens)) return (int)cudaErrorInvalidValue;
  const auto kernel = MmaKernel<false>::pick(C);
  const size_t smem = mma_smem(C);
  cudaError_t e = asy::set_smem(kernel, smem);
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)smem;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  return 0;
}

}  // extern "C"
