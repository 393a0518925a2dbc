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
// where hid < 295 (nano stages 0-1, p3) and by operations above.  Unfused, the (tokens x hid)
// hidden plane would cross device memory twice.  Design: loop over the
// hidden width in 32-wide slices (weights stream from L2 per slice), so the
// hidden activations never reach device memory.
//
// Two paths.  bf16 with C a multiple of 16 (up to 160), hid a multiple of 8
// and 16-byte aligned weights, the main path, runs
// on tensor cores (mma.sync m16n8k16, f32 accumulation): each warp owns 16
// tokens, keeps their normalised A-fragments in registers for the whole
// hidden loop, and turns the first product's accumulators (after bias, GELU
// and the bf16 round) directly into the second product's A-fragments, so the
// hidden slice never leaves registers; W1/W2 slices of 64 hidden units are
// staged transposed in shared memory, rows padded so the B-fragment loads
// are conflict-free.  Everything else (f32, other widths) runs as f32 FMA on
// CUDA cores: one block per 32 tokens keeps the normalised tile, the f32
// output accumulators and the hidden slice in shared memory, with 4-token x
// 4-channel register reuse (float4 shared loads).
//
// Numerics mirror the TPU kernel: the normalised input and the GELU output
// are rounded to the working type (bf16) before each product, products
// accumulate in f32, and the residual sum is rounded once.  GELU is the exact
// erf form (CUDA erff); the TPU kernel uses an Abramowitz-Stegun polynomial
// (|error| <= 1.5e-7), far below bf16 resolution.
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                 const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 T* __restrict__ out, int ntok, int hw, int C, int hid) {
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
      for (int k = 0; k < 4; ++k)
        hs[(tg + 8 * k) * kHidden + j] = j < hc ? asy::rnd<T>(gelu_erf(acc[k] + bias)) : 0.f;
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

template <typename T>
int launch(const void* x, const float* stats, const void* w1, const float* b1,
           const void* w2, const float* b2, void* out, int B, int HW, int C,
           int hid, void* stream) {
  if (C % 4 || B <= 0 || HW <= 0 || hid <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(2 * kTokens * C + 2 * C * kHidden +
                                               kTokens * kHidden);
  cudaError_t e = asy::set_smem(mlp_block_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntok = B * HW;
  const int grid = (ntok + kTokens - 1) / kTokens;
  mlp_block_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, stats, (const T*)w1, b1, (const T*)w2, b2, (T*)out, ntok, HW,
      C, hid);
  return (int)cudaGetLastError();
}

// ---- tensor-core path (bf16, C % 16 == 0, C <= kMaxC) ----
constexpr int kWarps = 4;
constexpr int kMmaTokens = 16 * kWarps;  // tokens per block
constexpr int kMmaHidden = 64;           // hidden slice per iteration
constexpr int kMaxC = 160;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout (PTX m16n8k16): lane = 4*g + t.  A regs {0,1,2,3} hold
// (row g, k 2t..2t+1), (row g+8, same k), (row g, k+8), (row g+8, k+8);
// B regs {0,1} hold (k 2t..2t+1, n g) and (k+8, n g); C/D hold (row g,
// n 2t..2t+1) and (row g+8, same n).
__global__ void __launch_bounds__(kWarps * 32)
mlp_block_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ stats,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                     int ntok, int hw, int C, int hid) {
  extern __shared__ float4 smem4[];
  const int s1 = C + 8, s2 = kMmaHidden + 8;  // padded rows (bf16 elements)
  __nv_bfloat16* w1t = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kMmaHidden][s1]
  __nv_bfloat16* w2t = w1t + kMmaHidden * s1;                     // [C][s2]
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kMmaTokens + (threadIdx.x / 32) * 16;
  const int rows[2] = {r0 + g, r0 + g + 8};
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
  uint32_t xa[kMaxC / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxC / 16; ++kk) {
    if (kk < ksteps) {
      const int c = kk * 16 + 2 * t;
      xa[kk][0] = norm_pair(0, c);
      xa[kk][1] = norm_pair(1, c);
      xa[kk][2] = norm_pair(0, c + 8);
      xa[kk][3] = norm_pair(1, c + 8);
    }
  }
  float y[kMaxC / 8][4];
#pragma unroll
  for (int nc = 0; nc < kMaxC / 8; ++nc) y[nc][0] = y[nc][1] = y[nc][2] = y[nc][3] = 0.f;

  for (int j0 = 0; j0 < hid; j0 += kMmaHidden) {
    __syncthreads();  // previous slice fully consumed
    // 16-byte loads: 8 hidden units of one W1 row, 8 channels of one W2 row
    for (int e = threadIdx.x; e < C * (kMmaHidden / 8); e += kWarps * 32) {
      const int c = e / (kMmaHidden / 8), j = (e % (kMmaHidden / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + j < hid) v = *reinterpret_cast<const uint4*>(w1 + (size_t)c * hid + j0 + j);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) w1t[(j + q) * s1 + c] = pv[q];
    }
    for (int e = threadIdx.x; e < kMmaHidden * (C / 8); e += kWarps * 32) {
      const int j = e / (C / 8), c = (e % (C / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + j < hid) v = *reinterpret_cast<const uint4*>(w2 + (size_t)(j0 + j) * C + c);
      const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) w2t[(c + q) * s2 + j] = pv[q];
    }
    __syncthreads();
    float z[kMmaHidden / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kMaxC / 16; ++kk) {
      if (kk < ksteps) {
#pragma unroll
        for (int nt = 0; nt < kMmaHidden / 8; ++nt) {
          const __nv_bfloat16* bp = w1t + (nt * 8 + g) * s1 + kk * 16 + 2 * t;
          mma16816(z[nt], xa[kk], ld32(bp), ld32(bp + 8));
        }
      }
    }
    // bias + GELU + bf16 round: accumulator tiles (2ks, 2ks+1) become the
    // A-fragment of hidden k-step ks
    uint32_t ha[kMmaHidden / 16][4];
#pragma unroll
    for (int ks = 0; ks < kMmaHidden / 16; ++ks) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int nt = 2 * ks + h2, j = j0 + nt * 8 + 2 * t;
        const float c0 = j < hid ? b1[j] : 0.f, c1 = j + 1 < hid ? b1[j + 1] : 0.f;
        ha[ks][2 * h2] = pack_bf16(gelu_erf(z[nt][0] + c0), gelu_erf(z[nt][1] + c1));
        ha[ks][2 * h2 + 1] = pack_bf16(gelu_erf(z[nt][2] + c0), gelu_erf(z[nt][3] + c1));
      }
    }
#pragma unroll
    for (int nc = 0; nc < kMaxC / 8; ++nc) {
      if (nc < ntiles) {
#pragma unroll
        for (int ks = 0; ks < kMmaHidden / 16; ++ks) {
          const __nv_bfloat16* bp = w2t + (nc * 8 + g) * s2 + ks * 16 + 2 * t;
          mma16816(y[nc], ha[ks], ld32(bp), ld32(bp + 8));
        }
      }
    }
  }
  // out = x + (y + b2), rounded once
#pragma unroll
  for (int nc = 0; nc < kMaxC / 8; ++nc) {
    if (nc < ntiles) {
      const int c = nc * 8 + 2 * t;
      const float c0 = b2[c], c1 = b2[c + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] < ntok) {
          const size_t o = (size_t)rows[i] * C + c;
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(x + o);
          *reinterpret_cast<uint32_t*>(out + o) =
              pack_bf16(__bfloat162float(v.x) + (y[nc][2 * i] + c0),
                        __bfloat162float(v.y) + (y[nc][2 * i + 1] + c1));
        }
      }
    }
  }
}

int launch_mma(const void* x, const float* stats, const void* w1, const float* b1,
               const void* w2, const float* b2, void* out, int B, int HW, int C,
               int hid, void* stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t)(kMmaHidden * (C + 8) + C * (kMmaHidden + 8));
  cudaError_t e = asy::set_smem(mlp_block_mma_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntok = B * HW;
  const int grid = (ntok + kMmaTokens - 1) / kMmaTokens;
  mlp_block_mma_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, stats, (const __nv_bfloat16*)w1, b1,
      (const __nv_bfloat16*)w2, b2, (__nv_bfloat16*)out, ntok, HW, C, hid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mlp_block_bf16(const void* x, const float* stats, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out,
                   int B, int HW, int C, int hid, void* stream) {
  const bool aligned = ((uintptr_t)w1 | (uintptr_t)w2) % 16 == 0;
  if (C % 16 == 0 && C <= kMaxC && hid % 8 == 0 && aligned && B > 0 && HW > 0)
    return launch_mma(x, stats, w1, b1, w2, b2, out, B, HW, C, hid, stream);
  return launch<__nv_bfloat16>(x, stats, w1, b1, w2, b2, out, B, HW, C, hid, stream);
}

int mlp_block_f32(const void* x, const float* stats, const void* w1,
                  const float* b1, const void* w2, const float* b2, void* out,
                  int B, int HW, int C, int hid, void* stream) {
  return launch<float>(x, stats, w1, b1, w2, b2, out, B, HW, C, hid, stream);
}

}  // extern "C"
