// Launch geometry of the MLP backward's cluster path (mlp_block_bwd.cu): the
// one statement of which shapes take it, how its shared memory is laid out,
// how the hidden width is split over a cluster's ranks and how the tokens are
// cut into tiles and dealt to clusters.  Plain C++ with no CUDA header, so
// that a host compiler alone can build it (the CPU tests do, to check the
// choice at every shape without a card); the kernel and its launch read the
// same functions.
#pragma once

#include <algorithm>
#include <cstddef>

#ifdef __CUDACC__
#define K5_HD __host__ __device__
#else
#define K5_HD
#endif

namespace k5geo {

constexpr int kCThreads = 512;          // 16 warps
constexpr int kCWarps = kCThreads / 32;
constexpr int kCT = 64;                 // tokens per tile, at least (64 or 128)
constexpr int kCHid = 32;               // hidden units per slice
constexpr int kCMaxC = 160;
constexpr int kCWideC = 96;             // up to this width, tiles of 128 where they fit
constexpr int kCMaxCluster = 8;         // one CTA an SM: a GPC of 16 SMs holds two clusters of 8
constexpr int kCMaxAcc = 32;            // weight-gradient tiles per warp, at most
constexpr int kCRankWork = 4096;        // C x hidden units a rank aims at (16 floats a thread)
constexpr size_t kCMaxSmem = 232448;    // bytes of shared memory an H100 block may opt into

struct CLay {  // byte offsets
  size_t xt, gt, w1s, w2s, dzb, hb, xch, xraw, b1s, db1s, red, gsum, bytes;
};

inline size_t al16(size_t v) { return (v + 15) / 16 * 16; }

// rows of a tile of T tokens whose dxn rank 0 (the widest share) sums
K5_HD inline int rank_rows(int T, int cs) { return (T + cs - 1) / cs; }

// the first of the S = hid/32 slices that rank r of cs owns: rank r owns
// [first_slice(r), first_slice(r + 1)), shares that differ by one at most
K5_HD inline int first_slice(int r, int slices, int cs) { return r * slices / cs; }

inline CLay clayout(int C, int own_max, int cs, int T, int B) {
  const size_t sc = C + 8, so = own_max + 8;
  CLay L;
  size_t o = 0;
  L.xt = o;   o += al16(2 * T * sc * 2);         // [2][T][C+8] bf16, xn after staging
  L.gt = o;   o += al16(2 * T * sc * 2);         // [2][T][C+8] bf16
  L.w1s = o;  o += al16((size_t)C * so * 2);     // [C][own+8] w1[:, own]
  L.w2s = o;  o += al16((size_t)own_max * sc * 2);  // [own][C+8] w2[own, :]
  L.dzb = o;  o += al16(T * so * 2);             // [T][own+8] rounded dz1
  L.hb = o;   o += al16(T * so * 2);             // [T][own+8] rounded GELU(z1)
  L.xch = o;  o += al16(T * sc * 4);             // [T][C+8] f32 dxn partial
  L.xraw = o; o += al16((size_t)2 * rank_rows(T, cs) * sc * 2);  // [2][rows] the rank's raw x
  L.b1s = o;  o += al16((size_t)own_max * 4);
  L.db1s = o; o += al16((size_t)(T / 16) * own_max * 4);  // [token group][own]
  L.red = o;  o += al16(2 * kCWarps * 2 * 4);    // [tile parity][warp][s1, s2]
  L.gsum = o; o += al16((size_t)B * 2 * 4);      // [sample][s1, s2] of this CTA's rows
  L.bytes = o;
  return L;
}

// weight-gradient tiles (16 x 8) per warp for C channels and `own` hidden
// units: dW1[:, own] and dW2[own, :] have C*own/128 each
inline int acc_tiles(int C, int own) { return (2 * (C / 16) * (own / 8) + kCWarps - 1) / kCWarps; }

// A rank's hidden units, at most, with `slices` slices over cs ranks
inline int own_max(int slices, int cs) { return (slices + cs - 1) / cs * kCHid; }

// Whether the cs-CTA clusters' ranks fit: weight-gradient tiles in
// registers, the block in shared memory
inline bool fits(int C, int slices, int cs, int T, int B) {
  const int own = own_max(slices, cs);
  return acc_tiles(C, own) <= kCMaxAcc && clayout(C, own, cs, T, B).bytes <= kCMaxSmem;
}

// Whether a bf16 launch takes the cluster path: C % 16 == 0 up to kCMaxC,
// hid % kCHid == 0, H*W % kCT == 0, and split over kCMaxCluster ranks (or
// all its slices) a rank fits.
inline bool cluster_shape(int HW, int C, int hid) {
  if (C % 16 || C > kCMaxC || hid % kCHid || HW % kCT || hid <= 0) return false;
  const int slices = hid / kCHid;
  return fits(C, slices, std::min(kCMaxCluster, slices), kCT, 1);
}

struct Pick {  // cs = 0: the FMA path
  int cs, ncl, T, tiles, own_max, acc;
  size_t smem;
};

// The cluster path's launch for B samples of HW tokens on a card of `sms`
// SMs.  cs CTAs a cluster split the S = hid/32 slices: the smallest divisor
// of S (every rank owns as many) that brings a rank's C x hidden units down
// to kCRankWork, else the largest divisor up to kCMaxCluster; where a rank
// would not fit, min(kCMaxCluster, S) (uneven shares).  T tokens a tile:
// 128 where C <= kCWideC, H*W allows it and it fits (twice the work between
// the same barriers), else 64.  ncl clusters take the tiles in turn (tile i
// to cluster i mod ncl): one CTA an SM, no SM left without one where the
// tiles allow, and no more than the card holds at once (`max_active`, 0
// where not known).
inline Pick pick(int B, int HW, int C, int hid, int sms, int max_active) {
  Pick p = {};
  if (B <= 0 || sms <= 0 || !cluster_shape(HW, C, hid)) return p;
  const int slices = hid / kCHid;
  int cs = 1;
  for (int d = 1; d <= std::min(kCMaxCluster, slices); ++d) {
    if (slices % d) continue;
    cs = d;
    if (C * (slices / d) * kCHid <= kCRankWork) break;
  }
  if (!fits(C, slices, cs, kCT, B)) cs = std::min(kCMaxCluster, slices);
  p.cs = cs;
  p.own_max = own_max(slices, cs);
  p.acc = acc_tiles(C, p.own_max);
  p.T = C <= kCWideC && HW % (2 * kCT) == 0 && fits(C, slices, cs, 2 * kCT, B) ? 2 * kCT : kCT;
  p.tiles = B * HW / p.T;
  p.ncl = std::min(p.tiles, sms / cs);
  if (max_active > 0) p.ncl = std::min(p.ncl, max_active);
  p.ncl = std::max(1, p.ncl);
  p.smem = clayout(C, p.own_max, cs, p.T, B).bytes;
  return p;
}

}  // namespace k5geo
