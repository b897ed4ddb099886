// SPH pair kernels of the step, for Hopper (sm_90a).
//
// Replaces the nine Pallas kernels of tpgsd/sph/pallas_ops.py that the
// step runs in summation and in continuity density mode.  Up to 64 slots
// per cell (the two-tier spill layout, and the single tier in the self
// role):
//   density_pairs    <- _density_kernel_packed, _density_kernel_packed_cross
//   accel_pairs      <- _accel_kernel_packed,   _accel_kernel_packed_cross
//   accel_drho_pairs <- _accel_drho_kernel_packed,
//                       _accel_drho_kernel_packed_cross
// Past 64 slots (the single tier at a worst-cell-proof capacity):
//   density_wide     <- _density_kernel
//   accel_wide       <- _accel_kernel
//   accel_drho_wide  <- _accel_drho_kernel
// accel_pairs and accel_drho_pairs are the two instances of one template
// (accel_pairs_kernel<kPer, kDrho>): the second adds the drho/dt sum; so
// are accel_wide and accel_drho_wide (accel_wide_kernel<kDrho>).  Every
// kernel evaluates a pair through the same two functions (density_pair,
// momentum_pair).
// A self pass and a cross pass differ only in which tier holds the centres
// and which holds the neighbours, so one kernel serves both: the caller
// passes the centre tier and the neighbour tier.
//
// Layout: SoA planes [F, C, K] (C cells, x-major; K slots per cell) and a
// bool live mask [C, K].  Neighbour-cell validity comes from the cell's
// (ix, iy, iz), so no neighbour table is read.
//
// Design: one warp per cell, four cells (a z-run that shares most of its
// 27 neighbours in L1/L2) per CTA.  Each lane owns centre slot `lane`, and
// `lane + 32` when K > 32 (K <= 64), and keeps their sums in registers.
// Each neighbour cell's fields are staged once per warp in shared memory
// and read back as broadcasts.  What bounds it on the H100 is the pair
// arithmetic (about 30 f32 operations per pair in accel_pairs, one sqrt,
// one approximate divide; accel_drho_pairs adds about 10 and, with
// delta-SPH diffusion on, one exact divide) and the re-reads of each
// neighbour cell by its 27 neighbours,
// which L2 (50 MB) absorbs.  The occupancy skips of the TPU kernels carry
// over as warp votes: a cell with no live centre writes zeros at once, a
// neighbour cell with no live slot is skipped, and a dead neighbour slot
// is skipped uniformly across the warp.  Pairs beyond the support radius
// are skipped; their kernel weight is zero.
//
//
// The wide kernels: a cell list sized for its worst cell (K = 128 where a
// 2h cell holds 18-30 particles) is filled from slot 0, so most of a
// cell's slots are dead.  Nothing of the TPU kernels' layout (128-lane
// padding, DMA windows, [B, Kp, Kp] pair matrices, the factorised MXU
// reduction) carries over.  One warp still owns a cell, but walks its
// slots in groups of 32: a centre group with no live slot writes zeros
// and is done after one vote; each neighbour cell is read in chunks of 32
// slots, a chunk with no live slot costs one mask byte per lane and one
// ballot, and a live chunk is staged in shared memory and its live slots
// alone are visited (the ballot's set bits).  Shared memory per warp is
// one 32-slot chunk whatever K is, and a lane holds one centre's sums,
// so registers and shared memory do not grow with K.  The masks may be
// anything, prefix or not.  What bounds these kernels is what bounds the
// others: the pair arithmetic of every live pair of the 27-cell block.
//
// Sums are f32 FMAs in registers; no tensor cores, no TF32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // cells per CTA
constexpr int kMaxK = 64;         // slots per cell the kernels take
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kWendlandC2 = 0, kCubicSpline = 1 };

struct Geometry {
  int nx, ny, nz, k;
};

// Cubic spline W(r) with sigma (tpgsd/sph/kernels.py CubicSpline.w).
__device__ __forceinline__ float cubic_w(float r, float h, float sigma) {
  const float q = r / h;
  float w = 0.f;
  if (q < 1.f) {
    w = 1.f - 1.5f * (q * q) + 0.75f * (q * q * q);
  } else if (q < 2.f) {
    const float s = 2.f - q;
    w = 0.25f * (s * s * s);
  }
  return sigma * w;
}

// -(1/r) dW/dr of the cubic spline (tpgsd/sph/kernels.py dw_over_r).
__device__ __forceinline__ float cubic_neg_dwr(float r, float h, float sigma) {
  const float q = r / h;
  float g = 0.f;
  if (q < 1.f) {
    g = -3.f + 2.25f * q;
  } else if (q < 2.f) {
    const float s = 2.f - q;
    g = -0.75f * (s * s) / fmaxf(q, 1e-12f);
  }
  return -(sigma * g / (h * h));
}

__device__ __forceinline__ void cell_coords(int cell, const Geometry& g,
                                            int& ix, int& iy, int& iz) {
  iz = cell % g.nz;
  const int t = cell / g.nz;
  iy = t % g.ny;
  ix = t / g.ny;
}

// One pair's term of the density sum: m * W'(r) added to acc (nothing
// beyond the support).
__device__ __forceinline__ void density_pair(
    float cx, float cy, float cz, float yx, float yy, float yz, float m,
    int kind, float inv2h, float invh2, float h, float sigma, float supp2,
    float& acc) {
  const float ddx = cx - yx;
  const float ddy = cy - yy;
  const float ddz = cz - yz;
  const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
  if (r2 >= supp2) return;
  const float r = sqrtf(r2);
  float wv;
  if (kind == kWendlandC2) {
    const float t = fmaxf(1.f - inv2h * r, 0.f);
    const float t2 = t * t;
    wv = (t2 * t2) * (invh2 * r + 1.f);
  } else {
    wv = cubic_w(r, h, sigma);
  }
  acc = fmaf(m, wv, acc);
}

// rho_i = mfold * m_i * sum_{27 cells} sum_j m_j W'(r_ij), where W' is
// t^4 (2q+1) for WendlandC2 (sigma folded into mfold) and the full cubic
// spline W for kind 1 (mfold is then the mass).
template <int kPer>  // centre slots per lane: 1 (K <= 32) or 2 (K <= 64)
__global__ void __launch_bounds__(32 * kWarps)
density_pairs_kernel(const float* __restrict__ xc,
                     const uint8_t* __restrict__ mc,
                     const float* __restrict__ xn,
                     const uint8_t* __restrict__ mn,
                     float* __restrict__ out, Geometry g, int kind,
                     float inv2h, float invh2, float mfold, float h,
                     float sigma, float supp2) {
  __shared__ float s_x[kWarps][3][kMaxK];
  __shared__ float s_m[kWarps][kMaxK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncell = g.nx * g.ny * g.nz;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncell) return;  // warp-uniform
  const int K = g.k;
  const long long plane = (long long)ncell * K;
  const long long base = (long long)cell * K;

  float cx[kPer], cy[kPer], cz[kPer], cm[kPer], acc[kPer];
  bool live = false;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int slot = lane + 32 * s;
    const bool ok = slot < K;
    cm[s] = ok ? (float)mc[base + slot] : 0.f;
    cx[s] = ok ? xc[base + slot] : 0.f;
    cy[s] = ok ? xc[plane + base + slot] : 0.f;
    cz[s] = ok ? xc[2 * plane + base + slot] : 0.f;
    acc[s] = 0.f;
    live |= cm[s] != 0.f;
  }
  if (__any_sync(kFull, live)) {
    int ix, iy, iz;
    cell_coords(cell, g, ix, iy, iz);
    for (int dx = -1; dx <= 1; ++dx) {
      const int jx = ix + dx;
      if (jx < 0 || jx >= g.nx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int jy = iy + dy;
        if (jy < 0 || jy >= g.ny) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int jz = iz + dz;
          if (jz < 0 || jz >= g.nz) continue;
          const long long nb = ((long long)(jx * g.ny + jy) * g.nz + jz) * K;
          bool nlive = false;
          for (int slot = lane; slot < K; slot += 32) {
            const float m = (float)mn[nb + slot];
            s_m[warp][slot] = m;
            s_x[warp][0][slot] = xn[nb + slot];
            s_x[warp][1][slot] = xn[plane + nb + slot];
            s_x[warp][2][slot] = xn[2 * plane + nb + slot];
            nlive |= m != 0.f;
          }
          if (!__any_sync(kFull, nlive)) continue;  // empty neighbour cell
          __syncwarp();
          for (int j = 0; j < K; ++j) {
            const float m = s_m[warp][j];
            if (m == 0.f) continue;  // uniform across the warp
            const float yx = s_x[warp][0][j];
            const float yy = s_x[warp][1][j];
            const float yz = s_x[warp][2][j];
#pragma unroll
            for (int s = 0; s < kPer; ++s) {
              density_pair(cx[s], cy[s], cz[s], yx, yy, yz, m, kind, inv2h,
                           invh2, h, sigma, supp2, acc[s]);
            }
          }
          __syncwarp();  // staging of the next cell overwrites s_x/s_m
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int slot = lane + 32 * s;
    if (slot < K) out[base + slot] = cm[s] != 0.f ? mfold * acc[s] * cm[s] : 0.f;
  }
}

// Planes of one staged neighbour cell in the momentum kernels.
enum Plane { kX, kY, kZ, kVx, kVy, kVz, kRho, kPt, kMask, kPlanes };

// Stage one neighbour cell (slots nb .. nb + K of every plane) into this
// warp's shared-memory planes; returns whether this lane saw a live slot.
// Dead slots stage only their mask.
__device__ __forceinline__ bool stage_cell(
    float (*s)[kMaxK], const float* __restrict__ xn,
    const float* __restrict__ vn, const float* __restrict__ rhon,
    const float* __restrict__ ptn, const uint8_t* __restrict__ mn,
    long long nb, long long plane, int K, int lane) {
  bool nlive = false;
  for (int slot = lane; slot < K; slot += 32) {
    const long long j = nb + slot;
    const float m = (float)mn[j];
    s[kMask][slot] = m;
    nlive |= m != 0.f;
    if (m != 0.f) {
      s[kX][slot] = xn[j];
      s[kY][slot] = xn[plane + j];
      s[kZ][slot] = xn[2 * plane + j];
      s[kVx][slot] = vn[j];
      s[kVy][slot] = vn[plane + j];
      s[kVz][slot] = vn[2 * plane + j];
      s[kRho][slot] = rhon[j];
      s[kPt][slot] = ptn[j];
    }
  }
  return nlive;
}

// g(r) of the momentum kernels: t^3 with t = max(1 - r/(2h), 0) for
// WendlandC2 (its constant is folded by the caller), -dW/dr / r for the
// cubic spline.
__device__ __forceinline__ float grad_weight(int kind, float r, float inv2h,
                                             float h, float sigma) {
  if (kind == kWendlandC2) {
    const float t = fmaxf(1.f - inv2h * r, 0.f);
    return t * t * t;
  }
  return cubic_neg_dwr(r, h, sigma);
}

// Momentum pass, and with kDrho the fused momentum + continuity pass
// (one template, so the 3-output instance pays nothing for the 4th sum):
//   a_i = m_i * sum_j m_j (pt_i + pt_j + cv min(v_ij.x_ij, 0) /
//         ((r^2 + h2eps)(rho_i + rho_j))) * g(r) * (x_i - x_j)
// with pt = cfold p / rho^2 pre-scaled by the caller, g = t^3 for
// WendlandC2 (its constant folded into cfold) and g = -dW/dr / r for the
// cubic spline; and, with kDrho,
//   drho_i/dt = adrho * m_i * sum_j m_j g(r) * (v_ij.x_ij
//               + ddfold (rho_i - rho_n) r^2 / (rho_n (r^2 + eta2)))
// with rho_n = max(rho_j, rho_floor), adrho = -cfold (mass times the
// kernel-gradient constant, applied once to the reduced sum) and ddfold =
// 2 delta h c0 (delta-SPH diffusion; 0 turns the term off and nothing of
// it is evaluated).  v_ij.x_ij comes from explicit differences.  The
// viscosity divide is approximate (__fdividef); the diffusion term takes
// ONE exact IEEE divide of the product (numerator ddfold (rho_i - rho_n)
// r^2 over rho_n (r^2 + eta2)), so drho meets its plain version at 1e-5
// where the TPU kernel's three approximate reciprocals cost it 1.5e-3.
// The self pair adds exactly 0 to every sum (x_ij = 0, r^2 = 0; h2eps and
// eta2 keep the denominators positive), so i == j is not special-cased.
// Output SoA [3, C, K] (acc_x, acc_y, acc_z), or [4, C, K] with drho/dt
// as the fourth plane; zero on dead centre slots.
struct DrhoFolds {
  float adrho, ddfold, eta2, rho_floor;
};

// Fields of one particle of the momentum pass.
struct Particle {
  float x, y, z, vx, vy, vz, rho, pt;
};

// One pair's terms of the momentum sums (and of drho/dt with kDrho), for
// centre c and neighbour y of live-mask value m (nothing beyond the
// support).
template <bool kDrho>
__device__ __forceinline__ void momentum_pair(
    const Particle& c, const Particle& y, float m, int kind, float inv2h,
    float h, float sigma, float h2eps, float cv, float supp2,
    const DrhoFolds& f, float& ax, float& ay, float& az, float& dr) {
  const float ddx = c.x - y.x;
  const float ddy = c.y - y.y;
  const float ddz = c.z - y.z;
  const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
  if (r2 >= supp2) return;
  const float r = sqrtf(r2);
  const float gr = grad_weight(kind, r, inv2h, h, sigma);
  const float vdotx =
      (c.vx - y.vx) * ddx + (c.vy - y.vy) * ddy + (c.vz - y.vz) * ddz;
  const float den = (r2 + h2eps) * (c.rho + y.rho);
  const float visc = __fdividef(cv * fminf(vdotx, 0.f), den);
  const float scale = (c.pt + y.pt + visc) * gr * m;
  ax = fmaf(scale, ddx, ax);
  ay = fmaf(scale, ddy, ay);
  az = fmaf(scale, ddz, az);
  if constexpr (kDrho) {
    float bracket = vdotx;
    if (f.ddfold != 0.f) {  // uniform: delta-SPH diffusion on
      const float rn = fmaxf(y.rho, f.rho_floor);
      bracket += (f.ddfold * (c.rho - rn) * r2) / (rn * (r2 + f.eta2));
    }
    dr = fmaf(gr * m, bracket, dr);
  }
}

template <int kPer,    // centre slots per lane: 1 (K <= 32) or 2 (K <= 64)
          bool kDrho>  // also sum drho/dt (accel_drho_pairs)
__global__ void __launch_bounds__(32 * kWarps)
accel_pairs_kernel(const float* __restrict__ xc, const float* __restrict__ vc,
                   const float* __restrict__ rhoc,
                   const float* __restrict__ ptc,
                   const uint8_t* __restrict__ mc,
                   const float* __restrict__ xn, const float* __restrict__ vn,
                   const float* __restrict__ rhon,
                   const float* __restrict__ ptn,
                   const uint8_t* __restrict__ mn, float* __restrict__ out,
                   Geometry g, int kind, float inv2h, float h, float sigma,
                   float h2eps, float cv, float supp2, DrhoFolds f) {
  __shared__ float s_f[kWarps][kPlanes][kMaxK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncell = g.nx * g.ny * g.nz;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncell) return;  // warp-uniform
  const int K = g.k;
  const long long plane = (long long)ncell * K;
  const long long base = (long long)cell * K;

  Particle c[kPer];
  float cm[kPer], ax[kPer], ay[kPer], az[kPer], dr[kPer];
  bool live = false;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int slot = lane + 32 * s;
    const bool ok = slot < K;
    const long long i = base + slot;
    cm[s] = ok ? (float)mc[i] : 0.f;
    c[s].x = ok ? xc[i] : 0.f;
    c[s].y = ok ? xc[plane + i] : 0.f;
    c[s].z = ok ? xc[2 * plane + i] : 0.f;
    c[s].vx = ok ? vc[i] : 0.f;
    c[s].vy = ok ? vc[plane + i] : 0.f;
    c[s].vz = ok ? vc[2 * plane + i] : 0.f;
    c[s].rho = ok ? rhoc[i] : 1.f;
    c[s].pt = ok ? ptc[i] : 0.f;
    ax[s] = ay[s] = az[s] = dr[s] = 0.f;
    live |= cm[s] != 0.f;
  }
  if (__any_sync(kFull, live)) {
    int ix, iy, iz;
    cell_coords(cell, g, ix, iy, iz);
    for (int dx = -1; dx <= 1; ++dx) {
      const int jx = ix + dx;
      if (jx < 0 || jx >= g.nx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int jy = iy + dy;
        if (jy < 0 || jy >= g.ny) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int jz = iz + dz;
          if (jz < 0 || jz >= g.nz) continue;
          const long long nb = ((long long)(jx * g.ny + jy) * g.nz + jz) * K;
          const bool nlive =
              stage_cell(s_f[warp], xn, vn, rhon, ptn, mn, nb, plane, K, lane);
          if (!__any_sync(kFull, nlive)) continue;  // empty neighbour cell
          __syncwarp();
          for (int j = 0; j < K; ++j) {
            const float m = s_f[warp][kMask][j];
            if (m == 0.f) continue;  // uniform across the warp
            const Particle y{s_f[warp][kX][j],  s_f[warp][kY][j],
                             s_f[warp][kZ][j],  s_f[warp][kVx][j],
                             s_f[warp][kVy][j], s_f[warp][kVz][j],
                             s_f[warp][kRho][j], s_f[warp][kPt][j]};
#pragma unroll
            for (int s = 0; s < kPer; ++s) {
              momentum_pair<kDrho>(c[s], y, m, kind, inv2h, h, sigma, h2eps,
                                   cv, supp2, f, ax[s], ay[s], az[s], dr[s]);
            }
          }
          __syncwarp();  // staging of the next cell overwrites s_f
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int slot = lane + 32 * s;
    if (slot < K) {
      const bool on = cm[s] != 0.f;
      out[base + slot] = on ? ax[s] * cm[s] : 0.f;
      out[plane + base + slot] = on ? ay[s] * cm[s] : 0.f;
      out[2 * plane + base + slot] = on ? az[s] * cm[s] : 0.f;
      if constexpr (kDrho) {
        out[3 * plane + base + slot] = on ? f.adrho * dr[s] * cm[s] : 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide kernels (K > 64): see the note at the top.
// ---------------------------------------------------------------------------

constexpr int kChunk = 32;  // slots per centre group and per staged chunk

// Visit the 27 neighbour cells of `cell` in chunks of kChunk slots:
// `chunk(nb, m, bits)` is called warp-uniformly for every chunk with a live
// slot, with the chunk's first slot index nb (into a [C, K] plane), whether
// this lane's slot is live (false past slot K) and the warp's live lanes.
template <typename Chunk>
__device__ __forceinline__ void for_live_chunks(
    int cell, const Geometry& g, const uint8_t* __restrict__ mn, int lane,
    Chunk chunk) {
  int ix, iy, iz;
  cell_coords(cell, g, ix, iy, iz);
  for (int dx = -1; dx <= 1; ++dx) {
    const int jx = ix + dx;
    if (jx < 0 || jx >= g.nx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int jy = iy + dy;
      if (jy < 0 || jy >= g.ny) continue;
      for (int dz = -1; dz <= 1; ++dz) {
        const int jz = iz + dz;
        if (jz < 0 || jz >= g.nz) continue;
        const long long nb = ((long long)(jx * g.ny + jy) * g.nz + jz) * g.k;
        for (int n0 = 0; n0 < g.k; n0 += kChunk) {
          const bool m = n0 + lane < g.k && mn[nb + n0 + lane] != 0;
          const unsigned bits = __ballot_sync(kFull, m);
          if (bits != 0u) chunk(nb + n0, m, bits);
        }
      }
    }
  }
}

// density_wide: the sum of density_pairs_kernel for any K.
__global__ void __launch_bounds__(32 * kWarps)
density_wide_kernel(const float* __restrict__ xc,
                    const uint8_t* __restrict__ mc,
                    const float* __restrict__ xn,
                    const uint8_t* __restrict__ mn, float* __restrict__ out,
                    Geometry g, int kind, float inv2h, float invh2,
                    float mfold, float h, float sigma, float supp2) {
  __shared__ float s_x[kWarps][3][kChunk];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncell = g.nx * g.ny * g.nz;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncell) return;  // warp-uniform
  const long long plane = (long long)ncell * g.k;
  const long long base = (long long)cell * g.k;

  for (int c0 = 0; c0 < g.k; c0 += kChunk) {  // centre groups
    const bool ok = c0 + lane < g.k;
    const long long i = base + c0 + lane;
    const bool live = ok && mc[i] != 0;
    float acc = 0.f;
    if (__any_sync(kFull, live)) {
      const float cx = live ? xc[i] : 0.f;
      const float cy = live ? xc[plane + i] : 0.f;
      const float cz = live ? xc[2 * plane + i] : 0.f;
      for_live_chunks(cell, g, mn, lane,
                      [&](long long nb, bool m, unsigned bits) {
        __syncwarp();  // the previous chunk has been read
        if (m) {
          s_x[warp][0][lane] = xn[nb + lane];
          s_x[warp][1][lane] = xn[plane + nb + lane];
          s_x[warp][2][lane] = xn[2 * plane + nb + lane];
        }
        __syncwarp();
        for (; bits != 0u; bits &= bits - 1u) {
          const int j = __ffs(bits) - 1;
          density_pair(cx, cy, cz, s_x[warp][0][j], s_x[warp][1][j],
                       s_x[warp][2][j], 1.f, kind, inv2h, invh2, h, sigma,
                       supp2, acc);
        }
      });
    }
    if (ok) out[i] = live ? mfold * acc : 0.f;
  }
}

// accel_wide (kDrho = false) and accel_drho_wide (kDrho = true): the sums
// of accel_pairs_kernel for any K; output as there.
template <bool kDrho>
__global__ void __launch_bounds__(32 * kWarps)
accel_wide_kernel(const float* __restrict__ xc, const float* __restrict__ vc,
                  const float* __restrict__ rhoc,
                  const float* __restrict__ ptc,
                  const uint8_t* __restrict__ mc,
                  const float* __restrict__ xn, const float* __restrict__ vn,
                  const float* __restrict__ rhon,
                  const float* __restrict__ ptn,
                  const uint8_t* __restrict__ mn, float* __restrict__ out,
                  Geometry g, int kind, float inv2h, float h, float sigma,
                  float h2eps, float cv, float supp2, DrhoFolds f) {
  __shared__ float s_f[kWarps][kMask][kChunk];  // the planes before kMask

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncell = g.nx * g.ny * g.nz;
  const int cell = blockIdx.x * kWarps + warp;
  if (cell >= ncell) return;  // warp-uniform
  const long long plane = (long long)ncell * g.k;
  const long long base = (long long)cell * g.k;

  for (int c0 = 0; c0 < g.k; c0 += kChunk) {  // centre groups
    const bool ok = c0 + lane < g.k;
    const long long i = base + c0 + lane;
    const bool live = ok && mc[i] != 0;
    float ax = 0.f, ay = 0.f, az = 0.f, dr = 0.f;
    if (__any_sync(kFull, live)) {
      Particle c{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f};
      if (live) {
        c = Particle{xc[i], xc[plane + i], xc[2 * plane + i],
                     vc[i], vc[plane + i], vc[2 * plane + i],
                     rhoc[i], ptc[i]};
      }
      for_live_chunks(cell, g, mn, lane,
                      [&](long long nb, bool m, unsigned bits) {
        __syncwarp();  // the previous chunk has been read
        if (m) {
          const long long j = nb + lane;
          s_f[warp][kX][lane] = xn[j];
          s_f[warp][kY][lane] = xn[plane + j];
          s_f[warp][kZ][lane] = xn[2 * plane + j];
          s_f[warp][kVx][lane] = vn[j];
          s_f[warp][kVy][lane] = vn[plane + j];
          s_f[warp][kVz][lane] = vn[2 * plane + j];
          s_f[warp][kRho][lane] = rhon[j];
          s_f[warp][kPt][lane] = ptn[j];
        }
        __syncwarp();
        for (; bits != 0u; bits &= bits - 1u) {
          const int j = __ffs(bits) - 1;
          const Particle y{s_f[warp][kX][j],  s_f[warp][kY][j],
                           s_f[warp][kZ][j],  s_f[warp][kVx][j],
                           s_f[warp][kVy][j], s_f[warp][kVz][j],
                           s_f[warp][kRho][j], s_f[warp][kPt][j]};
          momentum_pair<kDrho>(c, y, 1.f, kind, inv2h, h, sigma, h2eps, cv,
                               supp2, f, ax, ay, az, dr);
        }
      });
    }
    if (ok) {
      out[i] = live ? ax : 0.f;
      out[plane + i] = live ? ay : 0.f;
      out[2 * plane + i] = live ? az : 0.f;
      if constexpr (kDrho) out[3 * plane + i] = live ? f.adrho * dr : 0.f;
    }
  }
}

inline int launch_blocks(int ncell) { return (ncell + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

// Each entry point launches on `stream`, never synchronises, and returns
// cudaGetLastError() (0 = launched).  Shapes and dtypes are checked by the
// Python wrapper (tpgsd_torch/sph/ops.py).

int tpgsd_density_pairs(const float* xc, const uint8_t* mc, const float* xn,
                        const uint8_t* mn, float* out, int nx, int ny, int nz,
                        int k, int kind, float inv2h, float invh2,
                        float mfold, float h, float sigma, float supp2,
                        void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const Geometry g{nx, ny, nz, k};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 32) {
    density_pairs_kernel<1><<<launch_blocks(ncell), 32 * kWarps, 0, st>>>(
        xc, mc, xn, mn, out, g, kind, inv2h, invh2, mfold, h, sigma, supp2);
  } else {
    density_pairs_kernel<2><<<launch_blocks(ncell), 32 * kWarps, 0, st>>>(
        xc, mc, xn, mn, out, g, kind, inv2h, invh2, mfold, h, sigma, supp2);
  }
  return (int)cudaGetLastError();
}

// n_out = 3: accel_pairs, out [3, C, K]; the four drho folds are unused.
// n_out = 4: accel_drho_pairs, out [4, C, K] with drho/dt as plane 3.
int tpgsd_accel_pairs(const float* xc, const float* vc, const float* rhoc,
                      const float* ptc, const uint8_t* mc, const float* xn,
                      const float* vn, const float* rhon, const float* ptn,
                      const uint8_t* mn, float* out, int n_out, int nx,
                      int ny, int nz, int k, int kind, float inv2h, float h,
                      float sigma, float h2eps, float cv, float supp2,
                      float adrho, float ddfold, float eta2, float rho_floor,
                      void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || k > kMaxK || (n_out != 3 && n_out != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{nx, ny, nz, k};
  const DrhoFolds f{adrho, ddfold, eta2, rho_floor};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* kernel = accel_pairs_kernel<1, false>;
  if (n_out == 4) {
    kernel = k <= 32 ? accel_pairs_kernel<1, true> : accel_pairs_kernel<2, true>;
  } else if (k > 32) {
    kernel = accel_pairs_kernel<2, false>;
  }
  kernel<<<launch_blocks(ncell), 32 * kWarps, 0, st>>>(
      xc, vc, rhoc, ptc, mc, xn, vn, rhon, ptn, mn, out, g, kind, inv2h, h,
      sigma, h2eps, cv, supp2, f);
  return (int)cudaGetLastError();
}

// The wide kernels: arguments as tpgsd_density_pairs and tpgsd_accel_pairs,
// any k >= 1 (the Python wrapper sends k > 64 here).
int tpgsd_density_wide(const float* xc, const uint8_t* mc, const float* xn,
                       const uint8_t* mn, float* out, int nx, int ny, int nz,
                       int k, int kind, float inv2h, float invh2, float mfold,
                       float h, float sigma, float supp2, void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const Geometry g{nx, ny, nz, k};
  density_wide_kernel<<<launch_blocks(ncell), 32 * kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xc, mc, xn, mn, out, g, kind, inv2h, invh2, mfold, h, sigma, supp2);
  return (int)cudaGetLastError();
}

int tpgsd_accel_wide(const float* xc, const float* vc, const float* rhoc,
                     const float* ptc, const uint8_t* mc, const float* xn,
                     const float* vn, const float* rhon, const float* ptn,
                     const uint8_t* mn, float* out, int n_out, int nx, int ny,
                     int nz, int k, int kind, float inv2h, float h,
                     float sigma, float h2eps, float cv, float supp2,
                     float adrho, float ddfold, float eta2, float rho_floor,
                     void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || (n_out != 3 && n_out != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{nx, ny, nz, k};
  const DrhoFolds f{adrho, ddfold, eta2, rho_floor};
  auto* kernel = n_out == 4 ? accel_wide_kernel<true> : accel_wide_kernel<false>;
  kernel<<<launch_blocks(ncell), 32 * kWarps, 0,
           static_cast<cudaStream_t>(stream)>>>(
      xc, vc, rhoc, ptc, mc, xn, vn, rhon, ptn, mn, out, g, kind, inv2h, h,
      sigma, h2eps, cv, supp2, f);
  return (int)cudaGetLastError();
}

const char* tpgsd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
