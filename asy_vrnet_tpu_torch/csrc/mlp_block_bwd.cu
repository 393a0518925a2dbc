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
// multiple of 64, the main path, runs all five products (z1, g @ w2^T,
// dz1 @ w1^T, both weight gradients) on tensor cores (mma.sync m16n8k16,
// f32 accumulation) in thread-block clusters.  Every other case (f32,
// other widths) runs the FMA path below on CUDA cores.
//
// Cluster path.  The tokens are cut into tiles of 64 (never across a
// sample); cluster i of ncl takes tiles i, i + ncl, ... in order (a static
// assignment: the same bits on every run).  Its cs CTAs split the hidden
// width: rank r owns the 32-unit slices [r*S/cs, (r+1)*S/cs) of the S =
// hid/32, whose w1 columns, w2 rows and b1 stay in its shared memory for
// the whole launch.  Per tile (x and g staged by cp.async, the next tile's
// copy in flight while this one is computed; x normalised and rounded in
// place), each CTA of 16 warps (4 token groups of 16 x 4 quarters of a
// slice, one CTA an SM: its warps hide each other's latency):
//   1. forms z1 (kZ1: loads it) and g @ w2^T for its slices from ldmatrix
//      fragments of the staged tiles, GELU and GELU' in registers, and
//      stores dz1 and GELU(z1), rounded, token-major in shared memory; the
//      column sums of dz1 go to per-token-group db1 sums;
//   2. multiplies dz1 by its w1 columns: its share of dxn (64 x C, f32)
//      into an exchange buffer;
//   3. adds xn^T dz1 and GELU(z1)^T g (ldmatrix .trans of the same tiles)
//      into its dW1[:, own] and dW2[own, :] tiles, which stay in the
//      warps' registers across all the cluster's tiles;
//   4. after a cluster barrier, sums dxn over the ranks in rank order for
//      its 64/cs rows through distributed shared memory, rounds and stores
//      them, and takes the GroupNorm sums from the f32 values and db2 from
//      g.  The barrier is split (arrive after 2, wait before 4; arrive after
//      4, wait before the next tile's 2), so that 3 and the next tile's 1
//      overlap the slowest rank.
// At the end each cluster writes one row of `part`: [dW1 | dW2 | db1 | db2
// | per-sample GroupNorm sums (B x 2)], each rank its weight columns, rank
// 0 the sums over the ranks in rank order.  The tile, cs and ncl are
// chosen in mlp_block_bwd_geometry.h (`pick`); the caller reduces the
// ncl rows with one torch sum: no float atomics.  So the weight gradients
// cross device memory once per cluster, not once per 128 tokens, and a
// narrow grid (stage 3: 64 tiles) still gives the card ncl*cs CTAs.
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
// FMA part row: [dW1 (C*hid) | dW2 (hid*C) | db1 (hid) | db2 (C) | s1 | s2].
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "mlp_block_bwd_geometry.h"

namespace cg = cooperative_groups;

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

// ---- cluster path (bf16 tensor cores; see the header) ----
// Its geometry (which shapes take it, the shared-memory layout, the hidden
// split and the token tiles) is in mlp_block_bwd_geometry.h.
using namespace k5geo;
constexpr int kCGroup = 5;              // channel tiles per dxn accumulator group

typedef __nv_bfloat16 bf16;
using asy::ldmatrix_a;
using asy::ldmatrix_at;
using asy::ldmatrix_b;
using asy::ldmatrix_bt;
using asy::mma16816;
using asy::pack_bf16;

struct CGeo {  // own_max: a rank's hidden units, at most; T: tokens per tile
  int B, HW, C, hid, cs, ncl, tiles, slices, own_max, T;
};

// The cluster barrier in two halves (cs > 1): arrive after writing what
// peers will read, wait before reading theirs or overwriting one's own.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kT tokens a tile: kT/16 token groups of 16, each slice's 32 hidden units
// split over the kP = 16 / (kT/16) warps of a group, kHW units each
template <bool kZ1, int kAcc, int kT>
__global__ void __launch_bounds__(kCThreads, 1)
mlp_block_bwd_cluster_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
                             const float* __restrict__ stats, const bf16* __restrict__ w1,
                             const float* __restrict__ b1, const bf16* __restrict__ w2,
                             const bf16* __restrict__ z1, bf16* __restrict__ dxn,
                             float* __restrict__ part, CGeo g, CLay L) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  const int C = g.C, hid = g.hid, cs = g.cs;
  const int SC = C + 8, SO = g.own_max + 8;
  bf16* xt0 = reinterpret_cast<bf16*>(sb + L.xt);
  bf16* gt0 = reinterpret_cast<bf16*>(sb + L.gt);
  bf16* w1s = reinterpret_cast<bf16*>(sb + L.w1s);
  bf16* w2s = reinterpret_cast<bf16*>(sb + L.w2s);
  bf16* dzb = reinterpret_cast<bf16*>(sb + L.dzb);
  bf16* hb = reinterpret_cast<bf16*>(sb + L.hb);
  float* xch = reinterpret_cast<float*>(sb + L.xch);
  bf16* xraw = reinterpret_cast<bf16*>(sb + L.xraw);
  float* b1s = reinterpret_cast<float*>(sb + L.b1s);
  float* db1s = reinterpret_cast<float*>(sb + L.db1s);
  float* red = reinterpret_cast<float*>(sb + L.red);
  float* gsum = reinterpret_cast<float*>(sb + L.gsum);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  constexpr int kG = kT / 16, kP = kCWarps / kG, kHW = kCHid / kP, kNT = kHW / 8;
  const int tg = warp % kG, hq = warp / kG;  // the warp's 16 tokens and part of a slice
  const int rank = cs > 1 ? (int)cluster.block_rank() : 0, cid = blockIdx.x / cs;
  const int s0 = first_slice(rank, g.slices, cs);
  const int own = (first_slice(rank + 1, g.slices, cs) - s0) * kCHid;
  const int j0 = s0 * kCHid;           // the rank's first hidden unit
  const int C8 = C / 8, O8 = own / 8;
  auto arrive = [&]() {
    if (cs > 1) cluster_arrive();
  };
  auto wait = [&]() {
    if (cs > 1)
      cluster_wait();
    else
      __syncthreads();
  };

  // the rank's weights (with the first tile below, one cp.async group)
  for (int e = tid; e < C * O8; e += kCThreads) {
    const int c = e / O8, u = e % O8;
    asy::cp_async<16>(w1s + c * SO + u * 8, w1 + (size_t)c * hid + j0 + u * 8, true);
  }
  for (int e = tid; e < own * C8; e += kCThreads) {
    const int jj = e / C8, u = e % C8;
    asy::cp_async<16>(w2s + jj * SC + u * 8, w2 + (size_t)(j0 + jj) * C + u * 8, true);
  }
  for (int jj = tid; jj < own; jj += kCThreads) b1s[jj] = b1[j0 + jj];
  for (int e = tid; e < kG * g.own_max; e += kCThreads) db1s[e] = 0.f;
  for (int e = tid; e < 2 * g.B; e += kCThreads) gsum[e] = 0.f;
  // thread 0 adds a tile's per-warp GroupNorm sums, in warp order, into its
  // sample's (after a barrier: the warps wrote them at the tile's end)
  auto fold = [&](int tile, int parity) {
    const float* rd = red + parity * kCWarps * 2;
    float a = 0.f, q = 0.f;
    for (int w = 0; w < kCWarps; ++w) {
      a += rd[2 * w];
      q += rd[2 * w + 1];
    }
    const int b = (int)((size_t)tile * kT / g.HW);
    gsum[2 * b] += a;
    gsum[2 * b + 1] += q;
  };

  // stages token tile `tile` into buffer `buf` (x raw, converted after the wait)
  auto stage_tile = [&](int tile, int buf) {
    const size_t base = (size_t)tile * kT * C;
    bf16* xb = xt0 + buf * kT * SC;
    bf16* gb = gt0 + buf * kT * SC;
    for (int e = tid; e < kT * C8; e += kCThreads) {
      const int row = e / C8, u = e % C8;
      asy::cp_async<16>(xb + row * SC + u * 8, x + base + (size_t)row * C + u * 8, true);
      asy::cp_async<16>(gb + row * SC + u * 8, gout + base + (size_t)row * C + u * 8, true);
    }
  };

  float acc[kAcc][4];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int n1 = (C / 16) * O8, n2 = (own / 16) * C8;  // dW1 and dW2 tiles
  const int r0 = rank * kT / cs, r1 = (rank + 1) * kT / cs;  // the rank's rows
  // db2 over the rank's rows: thread (class k, chunk u) sums channels 8u ..
  // 8u + 7 of rows r0 + k, r0 + k + nk, ... in registers across the tiles
  const int nk = min(kCThreads / C8, rank_rows(kT, cs)), dk = tid / C8, du = tid % C8;
  float db2[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  stage_tile(cid, 0);
  asy::cp_async_commit();
  float2 st = *reinterpret_cast<const float2*>(stats + 2 * ((size_t)cid * kT / g.HW));
  int it = 0;
  for (int tile = cid; tile < g.tiles; tile += g.ncl, ++it) {
    const int buf = it & 1;
    bf16* xb = xt0 + buf * kT * SC;
    bf16* gb = gt0 + buf * kT * SC;
    bf16* xr = xraw + buf * rank_rows(kT, cs) * SC;
    const size_t tok0 = (size_t)tile * kT;
    const float mu = st.x, rstd = st.y;
    asy::cp_async_wait<0>();  // this tile (the only copy in flight)
    // xn = rnd((x - mu) * rstd) in place, on the chunks this thread copied;
    // the rank's rows also raw (the GroupNorm sums take the unrounded xn)
    for (int e = tid; e < kT * C8; e += kCThreads) {
      const int row = e / C8;
      uint4* p = reinterpret_cast<uint4*>(xb + row * SC + (e % C8) * 8);
      uint4 u = *p;
      if (row >= r0 && row < r1)
        *reinterpret_cast<uint4*>(xr + (row - r0) * SC + (e % C8) * 8) = u;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
        w[k] = pack_bf16((__low2float(v) - mu) * rstd, (__high2float(v) - mu) * rstd);
      }
      *p = u;
    }
    __syncthreads();  // every thread is past the last tile: its buffers are free
    if (it > 0 && tid == 0) fold(tile - g.ncl, buf ^ 1);
    if (tile + g.ncl < g.tiles) {  // the next tile's copy and statistics, in flight
      stage_tile(tile + g.ncl, buf ^ 1);
      asy::cp_async_commit();
      st = *reinterpret_cast<const float2*>(stats + 2 * ((tok0 + (size_t)g.ncl * kT) / g.HW));
    }

    // per slice: z1 (kZ1: loaded) and dh = g @ w2^T for the warp's 16 tokens
    // x 8 hidden units, then dz1 = dh * GELU'(z1) and GELU(z1), rounded, to
    // dzb and hb; the column sums of dz1 into db1s
    for (int jj0 = 0; jj0 < own; jj0 += kCHid) {
      const int jw = jj0 + hq * kHW;  // the warp's first local hidden unit
      float z[kNT][4] = {}, dh[kNT][4] = {};
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t xa[4], ga[4], b0, bb;
        ldmatrix_a(ga, gb + (tg * 16) * SC + kk * 16, SC);
        if (!kZ1) ldmatrix_a(xa, xb + (tg * 16) * SC + kk * 16, SC);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          ldmatrix_bt(b0, bb, w2s + (jw + nt * 8) * SC + kk * 16, SC);
          mma16816(dh[nt], ga, b0, bb);
          if (!kZ1) {
            ldmatrix_b(b0, bb, w1s + (kk * 16) * SO + jw + nt * 8, SO);
            mma16816(z[nt], xa, b0, bb);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int jl = jw + nt * 8 + 2 * tq;  // local column of this lane's pair
        float d[4], a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // (row gq | gq+8) x (col jl | jl+1)
          float zz, grad;
          if (kZ1) {
            const size_t o = (tok0 + tg * 16 + gq + 8 * (i >> 1)) * hid + j0 + jl + (i & 1);
            zz = __bfloat162float(z1[o]);
          } else {
            zz = z[nt][i] + b1s[jl + (i & 1)];
          }
          gelu_and_grad(zz, a[i], grad);
          d[i] = dh[nt][i] * grad;
        }
        const int ra = tg * 16 + gq;
        *reinterpret_cast<uint32_t*>(dzb + ra * SO + jl) = pack_bf16(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(dzb + (ra + 8) * SO + jl) = pack_bf16(d[2], d[3]);
        *reinterpret_cast<uint32_t*>(hb + ra * SO + jl) = pack_bf16(a[0], a[1]);
        *reinterpret_cast<uint32_t*>(hb + (ra + 8) * SO + jl) = pack_bf16(a[2], a[3]);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float sm = d[h2] + d[2 + h2];
          for (int off = 4; off < 32; off <<= 1) sm += __shfl_xor_sync(0xffffffffu, sm, off);
          if (gq == 0) db1s[tg * g.own_max + jl + h2] += sm;
        }
      }
    }
    __syncthreads();  // dzb, hb complete
    if (it > 0) wait();  // the peers have read the last tile's xch

    // dxn partial = dz1 @ w1[:, own]^T: the warp's 16 tokens x the channel
    // tiles hq, hq + kP, ..., kCGroup of them at a time, into xch
    for (int n0 = hq; n0 < C8; n0 += kP * kCGroup) {
      float y[kCGroup][4] = {};
      for (int kk = 0; kk < own / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_a(a, dzb + (tg * 16) * SO + kk * 16, SO);
#pragma unroll
        for (int u = 0; u < kCGroup; ++u) {
          if (n0 + kP * u < C8) {
            uint32_t b0, bb;
            ldmatrix_bt(b0, bb, w1s + ((n0 + kP * u) * 8) * SO + kk * 16, SO);
            mma16816(y[u], a, b0, bb);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCGroup; ++u) {
        if (n0 + kP * u < C8) {
          float* p = xch + (tg * 16 + gq) * SC + (n0 + kP * u) * 8 + 2 * tq;
          *reinterpret_cast<float2*>(p) = make_float2(y[u][0], y[u][1]);
          *reinterpret_cast<float2*>(p + 8 * SC) = make_float2(y[u][2], y[u][3]);
        }
      }
    }
    arrive();  // this rank's dxn partial is in its xch
    // dW1[:, own] += xn^T dz1, dW2[own, :] += GELU(z1)^T g over the tile's
    // tokens (while the peers finish their partials); warp w keeps tiles w,
    // w + 16, ... in registers across tiles
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = warp + kCWarps * i;
      if (idx < n1) {
        const int m0 = (idx / O8) * 16, c0 = (idx % O8) * 8;
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          uint32_t a[4], b0, bb;
          ldmatrix_at(a, xb + (kk * 16) * SC + m0, SC);
          ldmatrix_b(b0, bb, dzb + (kk * 16) * SO + c0, SO);
          mma16816(acc[i], a, b0, bb);
        }
      } else if (idx < n1 + n2) {
        const int id2 = idx - n1, m0 = (id2 / C8) * 16, c0 = (id2 % C8) * 8;
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          uint32_t a[4], b0, bb;
          ldmatrix_at(a, hb + (kk * 16) * SO + m0, SO);
          ldmatrix_b(b0, bb, gb + (kk * 16) * SC + c0, SC);
          mma16816(acc[i], a, b0, bb);
        }
      }
    }
    // db2 over the rank's rows (the last read of this tile's buffers: the
    // next prefetch into them follows the barrier below)
    if (dk < nk) {
      for (int row = r0 + dk; row < r1; row += nk) {
        const uint4 u = *reinterpret_cast<const uint4*>(gb + row * SC + du * 8);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
          db2[2 * k] += __low2float(v);
          db2[2 * k + 1] += __high2float(v);
        }
      }
    }
    wait();  // every rank's dxn partial is in its xch

    // this rank's rows: dxn summed over the ranks in order, rounded once;
    // the GroupNorm sums from the f32 values; db2
    float s1 = 0.f, s2 = 0.f;
    for (int e = tid; e < (r1 - r0) * (C / 4); e += kCThreads) {
      const int row = r0 + e / (C / 4), c = (e % (C / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p0 = 0; p0 < cs; p0 += 8) {  // 8 remote loads in flight, added in order
        float4 u[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int p = p0 + k;
          const float* src = p == rank ? xch : cluster.map_shared_rank(xch, p < cs ? p : rank);
          u[k] = *reinterpret_cast<const float4*>(src + row * SC + c);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (p0 + k < cs) {
            v.x += u[k].x;
            v.y += u[k].y;
            v.z += u[k].z;
            v.w += u[k].w;
          }
        }
      }
      const size_t o = (tok0 + row) * C + c;
      const uint2 xv = *reinterpret_cast<const uint2*>(xr + (row - r0) * SC + c);
      const __nv_bfloat162 xa = *reinterpret_cast<const __nv_bfloat162*>(&xv.x);
      const __nv_bfloat162 xc = *reinterpret_cast<const __nv_bfloat162*>(&xv.y);
      uint2 out;
      out.x = pack_bf16(v.x, v.y);
      out.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(dxn + o) = out;
      s1 += v.x + v.y + v.z + v.w;
      s2 = fmaf(v.x, (__low2float(xa) - mu) * rstd, s2);
      s2 = fmaf(v.y, (__high2float(xa) - mu) * rstd, s2);
      s2 = fmaf(v.z, (__low2float(xc) - mu) * rstd, s2);
      s2 = fmaf(v.w, (__high2float(xc) - mu) * rstd, s2);
    }
    arrive();  // done reading the peers' xch
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      float* rd = red + buf * kCWarps * 2;
      rd[2 * warp] = s1;
      rd[2 * warp + 1] = s2;
    }
  }
  wait();          // every rank is done with its peers' xch
  __syncthreads();  // and every warp has written its last GroupNorm sums
  if (it > 0 && tid == 0) fold(cid + (it - 1) * g.ncl, (it - 1) & 1);

  // the cluster's row: [dW1 (C x hid) | dW2 (hid x C) | db1 (hid) | db2 (C) |
  // the GroupNorm sums (B x 2)]; each rank writes its columns, rank 0 the sums
  float* row = part + (size_t)cid * ((size_t)2 * C * hid + hid + C + 2 * g.B);
  const size_t l1 = (size_t)C * hid;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = warp + kCWarps * i;
    if (idx < n1) {
      const int m0 = (idx / O8) * 16, c0 = (idx % O8) * 8;
      float* p = row + (size_t)(m0 + gq) * hid + j0 + c0 + 2 * tq;
      p[0] = acc[i][0];
      p[1] = acc[i][1];
      p[8 * (size_t)hid] = acc[i][2];
      p[8 * (size_t)hid + 1] = acc[i][3];
    } else if (idx < n1 + n2) {
      const int id2 = idx - n1, m0 = (id2 / C8) * 16, c0 = (id2 % C8) * 8;
      float* p = row + l1 + (size_t)(j0 + m0 + gq) * C + c0 + 2 * tq;
      p[0] = acc[i][0];
      p[1] = acc[i][1];
      p[8 * C] = acc[i][2];
      p[8 * C + 1] = acc[i][3];
    }
  }
  for (int jj = tid; jj < own; jj += kCThreads) {
    const float* d = db1s + jj;
    float a = 0.f;
    for (int k = 0; k < kG; ++k) a += d[k * g.own_max];
    row[2 * l1 + j0 + jj] = a;
  }
  // db2: the classes' sums, added in class order (xch is free by now), into
  // db2s; then rank 0 adds the ranks' db2s and GroupNorm sums in rank order
  float* dbs = xch;                              // [nk][C]
  float* db2s = reinterpret_cast<float*>(dzb);   // [C]
  if (dk < nk)
#pragma unroll
    for (int k = 0; k < 8; ++k) dbs[dk * C + du * 8 + k] = db2[k];
  __syncthreads();
  for (int c = tid; c < C; c += kCThreads) {
    float a = 0.f;
    for (int k = 0; k < nk; ++k) a += dbs[k * C + c];
    db2s[c] = a;
  }
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (rank == 0) {
    for (int e = tid; e < C + 2 * g.B; e += kCThreads) {
      float a = 0.f;
      for (int p = 0; p < cs; ++p) {
        const float* src = e < C ? db2s : gsum;
        if (p != 0) src = cluster.map_shared_rank(src, p);
        a += src[e < C ? e : e - C];
      }
      row[2 * l1 + hid + e] = a;
    }
  }
  if (cs > 1) {  // no rank leaves while rank 0 reads its sums
    cluster_arrive();
    cluster_wait();
  }
}

template <int kAcc>
struct ClusterKernel {
  static const void* pick(bool z1, int T) {
    if (T == 128)
      return z1 ? (const void*)mlp_block_bwd_cluster_kernel<true, kAcc, 128>
                : (const void*)mlp_block_bwd_cluster_kernel<false, kAcc, 128>;
    return z1 ? (const void*)mlp_block_bwd_cluster_kernel<true, kAcc, 64>
              : (const void*)mlp_block_bwd_cluster_kernel<false, kAcc, 64>;
  }
};

// the instantiation for `acc` weight-gradient tiles per warp and T tokens a tile
inline const void* cluster_kernel(int acc, bool z1, int T) {
  if (acc <= 4) return ClusterKernel<4>::pick(z1, T);
  if (acc <= 8) return ClusterKernel<8>::pick(z1, T);
  if (acc <= 16) return ClusterKernel<16>::pick(z1, T);
  return ClusterKernel<32>::pick(z1, T);
}

// A launch geometry as the caller passes it (`pick` chooses one): T 64 or
// 128 dividing H*W, 1 <= cs <= min(kCMaxCluster, slices), 1 <= ncl <= tiles,
// and a rank's weight-gradient tiles and shared memory must fit.
inline int make_cgeo(CGeo& g, int B, int HW, int C, int hid, int cs, int ncl, int T) {
  if (B <= 0 || !cluster_shape(HW, C, hid) || (T != 64 && T != 128) || HW % T)
    return (int)cudaErrorInvalidValue;
  const int slices = hid / kCHid, tiles = B * HW / T;
  if (cs < 1 || cs > std::min(kCMaxCluster, slices) || ncl < 1 || ncl > tiles ||
      !fits(C, slices, cs, T, B))
    return (int)cudaErrorInvalidValue;
  g = CGeo{B, HW, C, hid, cs, ncl, tiles, slices, own_max(slices, cs), T};
  return 0;
}

// Clusters of cs CTAs of `kernel` with `smem` bytes each that the card holds
// at once, in *n
cudaError_t active_clusters(const void* kernel, int cs, size_t smem, int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

int launch_cluster(const void* x, const void* g, const float* stats, const void* w1,
                   const float* b1, const void* w2, const void* z1, void* dxn, float* part,
                   int B, int HW, int C, int hid, int cs, int ncl, int T, void* stream) {
  CGeo cg_;
  int err = make_cgeo(cg_, B, HW, C, hid, cs, ncl, T);
  if (err) return err;
  for (const void* p : {x, g, w1, w2, z1, (const void*)dxn})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const CLay L = clayout(C, cg_.own_max, cs, T, B);
  const void* kernel = cluster_kernel(acc_tiles(C, cg_.own_max), z1 != nullptr, T);
  cudaError_t e = asy::set_smem(kernel, L.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncl * cs, 1, 1);
  cfg.blockDim = dim3(kCThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1;  // a single-CTA "cluster" launches as a plain grid
  void* args[] = {(void*)&x, (void*)&g, (void*)&stats, (void*)&w1, (void*)&b1, (void*)&w2,
                  (void*)&z1, (void*)&dxn, (void*)&part, (void*)&cg_, (void*)&L};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
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
// activations, or null (fc1 recomputed).  cs = 0: the FMA path with
// `chunks` blocks per sample, `part` (B*chunks, 2*C*hid + hid + C + 2);
// cs > 0: the cluster path, cs CTAs a cluster, ncl clusters and T tokens a
// tile, `part` (ncl, 2*C*hid + hid + C + 2*B).  A launch whose cs names the
// path its shape does not take is refused.
int mlp_block_bwd_bf16(const void* x, const void* g, const float* stats,
                       const void* w1, const float* b1, const void* w2, const void* z1,
                       void* dxn, float* part, int B, int HW, int C, int hid, int chunks,
                       int cs, int ncl, int T, void* stream) {
  if (cluster_shape(HW, C, hid) != (cs > 0)) return (int)cudaErrorInvalidValue;
  if (cs > 0)
    return launch_cluster(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid, cs, ncl, T,
                          stream);
  return launch_fma<__nv_bfloat16>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid,
                                   chunks, stream);
}

int mlp_block_bwd_f32(const void* x, const void* g, const float* stats,
                      const void* w1, const float* b1, const void* w2, const void* z1,
                      void* dxn, float* part, int B, int HW, int C, int hid, int chunks,
                      int cs, int ncl, int T, void* stream) {
  if (cs != 0) return (int)cudaErrorInvalidValue;
  return launch_fma<float>(x, g, stats, w1, b1, w2, z1, dxn, part, B, HW, C, hid, chunks,
                           stream);
}

// The cluster path's launch for B samples of HW tokens on the current card
// (`pick`, with the clusters it holds at once): out = [cs, ncl, T], cs = 0
// where a bf16 launch of this shape takes the FMA path.
int mlp_block_bwd_geometry(int B, int HW, int C, int hid, int* out) {
  if (B <= 0 || HW <= 0 || C <= 0 || hid <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  k5geo::Pick p = k5geo::pick(B, HW, C, hid, sms, 0);
  if (p.cs > 1) {  // no second wave of clusters
    const void* kernel = cluster_kernel(p.acc, false, p.T);
    int n = 0;
    e = asy::set_smem(kernel, p.smem);
    if (e == cudaSuccess) e = active_clusters(kernel, p.cs, p.smem, &n);
    if (e != cudaSuccess) return (int)e;
    p = k5geo::pick(B, HW, C, hid, sms, n);
  }
  out[0] = p.cs;
  out[1] = p.ncl;
  out[2] = p.T;
  return 0;
}

// The kernel a launch takes (esz: 2 for bf16, 4 for f32; z1: the z1
// variant; chunks or cs, ncl as the launch gets them): out = [dynamic
// shared memory bytes, CTAs per SM, registers per thread, threads per CTA,
// clusters the card holds at once (cluster path; 0 on the FMA path)]
int mlp_block_bwd_info(int esz, int B, int HW, int C, int hid, int chunks, int cs, int ncl,
                       int T, int z1, int* out) {
  if (B <= 0 || HW <= 0 || C <= 0 || hid <= 0 || (esz != 2 && esz != 4))
    return (int)cudaErrorInvalidValue;
  const void* kernel;
  size_t smem;
  int threads, clusters = 0;
  cudaError_t e = cudaSuccess;
  if (cs > 0) {
    CGeo cg_;
    int err = make_cgeo(cg_, B, HW, C, hid, cs, ncl, T);
    if (err || esz != 2) return err ? err : (int)cudaErrorInvalidValue;
    kernel = cluster_kernel(acc_tiles(C, cg_.own_max), z1 != 0, T);
    smem = clayout(C, cg_.own_max, cs, T, B).bytes;
    threads = kCThreads;
    e = asy::set_smem(kernel, smem);
    if (e == cudaSuccess && cs > 1) e = active_clusters(kernel, cs, smem, &clusters);
  } else {
    if (chunks <= 0) return (int)cudaErrorInvalidValue;
    const int TT = (HW + chunks - 1) / chunks;
    smem = layout(TT, C).floats * sizeof(float);
    threads = kThreads;
    if (esz == 2)
      kernel = z1 ? (const void*)mlp_block_bwd_kernel<__nv_bfloat16, true>
                  : (const void*)mlp_block_bwd_kernel<__nv_bfloat16, false>;
    else
      kernel = z1 ? (const void*)mlp_block_bwd_kernel<float, true>
                  : (const void*)mlp_block_bwd_kernel<float, false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)smem;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = threads;
  out[4] = clusters;
  return 0;
}

}  // extern "C"
