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
//   density_wide     <- _density_kernel      (density_pairs_kernel<true>)
//   accel_wide       <- _accel_kernel        (accel_pairs_kernel<false, true>)
//   accel_drho_wide  <- _accel_drho_kernel   (accel_pairs_kernel<true, true>)
// Every role is an instance of one of two templates, density_pairs_kernel
// <kWide> and accel_pairs_kernel<kDrho, kWide, kExtra>: kDrho adds the
// drho/dt sum, kWide takes capacities past 64 slots.  Both are one tile
// walk (walk_tile) and evaluate a pair through the same two functions
// (density_pair, momentum_pair).
//
// Four more pair passes run as jnp code in the reference (tpgsd/sph/
// step.py), not as Pallas kernels; they are instances of the same walk:
//   XSPH             <- _xsph_blocks: accel_pairs_kernel<kDrho, kWide,
//                       kXsph>, 3 more sums of momentum_pair, so the
//                       correction rides the momentum launch
//   energy           <- _energy_blocks: accel_pairs_kernel<false, kWide,
//                       kEnergy>, du/dt from the very pair scale that the
//                       acceleration sums (the conjugacy holds in the
//                       kernel too); the acceleration sums are dead code
//   st_normals       <- _st_normals_blocks: st_normals_kernel<kWide>, one
//                       staged float4 (x, y, z, rho), density-like
//   st_force         <- _st_force_blocks, _cohesion_c: st_force_kernel
//                       <kWide>, two staged float4s (x, n, rho); its
//                       curvature term has no kernel weight, so every
//                       candidate of the 27 cells is a pair, as in the
//                       reference
// They cost what a walk with the same staging costs: normals about a
// density pass, the force a density walk with two float4s and a divide a
// candidate, XSPH a few FMAs and one approximate divide a pair in the
// momentum pass.
// A self pass and a cross pass differ only in which tier holds the centres
// and which holds the neighbours, so one kernel serves both: the caller
// passes the centre tier and the neighbour tier.
//
// Layout: SoA planes [F, C, K] (C cells, x-major; K slots per cell) and a
// bool live mask [C, K], any mask (prefix or not).  Neighbour-cell
// validity comes from the cell's (ix, iy, iz), so no neighbour table is
// read.
//
// What bounds the tile kernels on the H100: in the self roles the pair
// arithmetic (about 19 f32 operations a pair within the support in
// density_pairs, 38 in accel_pairs, 48 in accel_drho_pairs, each with one
// sqrt and the momentum ones with an approximate divide), in the cross
// roles against a sparse or empty tier the bytes of the two masks and the
// zeros written.  Tensor cores do not apply: every pair term passes
// through a branch on the support radius, a sqrt and a divide, and no
// product of two matrices appears.
//
// Their design is a tile of live centres.  One CTA of 128 threads owns T
// consecutive cell ids [c0, c0 + T) (T <= 16, chosen by the caller; the
// last tile is ragged):
//  1. The CTA ranks the live slots of its T K centre slots (warp ballots
//     and a block prefix) into a shared list and writes zeros to the dead
//     ones.  Thread t owns live centre t and keeps its fields and sums in
//     registers, so every lane that evaluates a pair holds a centre, not
//     only the live slots of one cell; a tile past 128 live centres takes
//     further rounds of 128.  The list holds 1024 centres, every centre
//     slot of a tile up to 64 slots a cell; past them (kWide) it is a
//     ring, and before each round the CTA ranks further chunks of 128
//     slots while one fits, so neither the list nor the registers grow
//     with K.
//  2. For each of the 9 (dx, dy) offsets, the cells any centre of the tile
//     can need form the id range [c0 + off - 1, c0 + off + T] (off =
//     dx ny nz + dy nz), clipped to [0, C): T + 2 cells, contiguous in
//     every plane, for any grid (nz = 1, tiles that straddle a row, ghost
//     grids).  The CTA counts the range's live slots and, unless there are
//     none (then the range is skipped), stages them once, compacted in
//     cell and slot order as float4s (one for density, two for momentum:
//     a neighbour is one or two vector loads), with a start table indexed
//     by the position in the range; each staged cell serves every centre
//     of the tile that needs it.  The staging buffer holds (T + 2)
//     min(K, 64) particles, a budget of live slots, not of slots: past 64
//     slots a cell list sized for its worst cell (K = 128 where a 2h cell
//     holds 18-30 particles) is mostly dead, and a range of T + 2 such
//     cells holds far fewer live particles than the budget.  There
//     (kWide) a range past the budget (a dense cloud at a large K) is
//     staged and walked in pieces of at most the budget, in cell and slot
//     order, the scan of a cell stops at its last live slot, and the
//     counts read four mask bytes a lane.
//  3. Each centre walks one contiguous span of the staged range per
//     offset (cells p - 1 .. p + 1 of its own position p, trimmed at the z
//     ends by its iz, skipped whole when ix + dx or iy + dy leaves the
//     grid), piece by piece: every candidate is a live particle, and no
//     dead slot is tested.  Pairs beyond the support are skipped; their
//     kernel weight is zero.  About 15% of the candidates of the 27 cells
//     lie within the support, so nearly every candidate has some lane of
//     the warp within it: the momentum kernels first test up to 32
//     candidates into a bit mask and then evaluate the set bits, so that
//     the lanes evaluate their pairs together; the density pair is too
//     cheap for that to pay.  Neighbours are visited in cell, then slot
//     order, in every piece layout.
// Shared memory is the staged float4s (dynamic; at most 36.9 KB, momentum
// at T = 16, the same at K = 1024 as at K = 64) and about 2.2 KB of
// counts, start table and centre list.  Staging is synchronous: other CTAs
// of the SM (8 or more at 64 registers) hide its loads, and double-
// buffering the raw ranges with cp.async measured slower.
// Nothing of the TPU kernels' layout (128-lane padding, DMA windows,
// [B, Kp, Kp] pair matrices, the factorised MXU reduction) carries over.
//
// Sums are f32 FMAs in registers; no tensor cores, no TF32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // warps per CTA
constexpr int kMaxK = 64;  // slots per cell of the two-tier kernels
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

// ---------------------------------------------------------------------------
// The tile walk: see the note at the top.
// ---------------------------------------------------------------------------

constexpr int kThreads = 32 * kWarps;  // threads per CTA, centres per round
constexpr int kMaxTile = 16;           // cells per tile
constexpr int kMaxRange = kMaxTile + 2;  // cells per staged id range
constexpr int kMaxWideK = 1024;  // slots per cell the kWide tiles take
// entries of the centre list: every centre slot of a tile up to 64 slots
// a cell, a ring past it
constexpr int kList = kMaxTile * kMaxK;
// CTAs an SM must hold (__launch_bounds__), which caps the registers a
// thread: at 64 the momentum kernels do not spill (the compiler's own
// choice of 48 spilled 16-20 bytes); at 42 the density kernel takes 40
// and runs 3% faster than at its own choice of 45, but its kWide instance
// spills 16 bytes there: at 51 it takes 48 and runs faster than at 42 or
// at 64 (56 registers).
constexpr int kTilesPerSM = 8;
constexpr int kDensityTilesPerSM = 12;
constexpr int kDensityWideTilesPerSM = 10;
// the passes the reference runs in jnp: at 64 registers a thread, as the
// momentum kernels, but for the kWide XSPH instances, which spill 4-8 bytes
// there and take 7 CTAs an SM (72 registers)
constexpr int kXsphTilesPerSM = 8;
constexpr int kXsphWideTilesPerSM = 7;
constexpr int kNormalsTilesPerSM = 8;
constexpr int kForceTilesPerSM = 8;

// Shared memory of a tile walk besides the staged planes (those are
// dynamic: their size follows T and min(K, 64)).
struct TileShared {
  int count[kMaxRange];      // live slots of each cell of the range
  int start[kMaxRange + 1];  // where each cell's slots begin in the range
  int wsum[2][kWarps];       // live centres per warp, double-buffered
  int16_t list[kList];       // listed centre i (its slot in the tile) at
                             // i % kList
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// Particles one staged piece holds: (T + 2) min(K, 64), so a launch at
// K <= 64 stages every range whole, as many particles as its T + 2 cells
// have slots, and shared memory stops growing with K past 64.
__host__ __device__ __forceinline__ int stage_cap(int T, int K) {
  return (T + 2) * (K < kMaxK ? K : kMaxK);
}

// Step 1, one chunk of kThreads centre slots: rank the live slots of
// slots s0 .. s0 + kThreads - 1 of the tile (mask row `mc`, `nslots`
// slots) into the list behind the `n` centres listed before, in slot
// order; `dead(s)` is called for every dead slot.  Returns the new count
// (the same in every thread).  `parity` alternates between successive
// chunks, so one barrier a chunk keeps the warp sums apart.
template <typename Dead>
__device__ __forceinline__ int list_centres(const uint8_t* __restrict__ mc,
                                            int s0, int nslots, int n,
                                            int parity, TileShared& sh,
                                            Dead dead) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = s0 + threadIdx.x;
  const bool ok = s < nslots;
  const bool live = ok && mc[s] != 0;
  if (ok && !live) dead(s);
  const unsigned bits = __ballot_sync(kFull, live);
  if (lane == 0) sh.wsum[parity][warp] = __popc(bits);
  __syncthreads();
  int before = n;
  for (int w = 0; w < warp; ++w) before += sh.wsum[parity][w];
  if (live) {
    sh.list[(before + __popc(bits & lanes_below(lane))) & (kList - 1)] =
        (int16_t)s;
  }
  for (int w = 0; w < kWarps; ++w) n += sh.wsum[parity][w];
  return n;
}

// Step 2a: the live-slot count of each of the `np` cells lo .. lo + np - 1
// (zero for a cell outside [0, ncell)), one warp per cell.  Past 64 slots
// (kWide) a lane reads four mask bytes where the rows are word-aligned.
// Returns whether this warp counted a live slot.
template <bool kWide>
__device__ __forceinline__ bool count_range(const uint8_t* __restrict__ mn,
                                            int lo, int np, int ncell, int K,
                                            int* count) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool words =
      kWide && (K & 3) == 0 && (reinterpret_cast<uintptr_t>(mn) & 3) == 0;
  bool any = false;
  for (int p = warp; p < np; p += kWarps) {
    const int cell = lo + p;
    int n = 0;
    if (cell >= 0 && cell < ncell) {  // warp-uniform
      const uint8_t* m = mn + (long long)cell * K;
      if (words) {
        const uint32_t* m4 = reinterpret_cast<const uint32_t*>(m);
        int c = 0;
        for (int w = lane; w < K / 4; w += 32) {
          c += __popc(__vcmpne4(m4[w], 0u)) >> 3;
        }
        n = __reduce_add_sync(kFull, c);
      } else {
        for (int s = lane; s - lane < K; s += 32) {
          n += __popc(__ballot_sync(kFull, s < K && m[s] != 0));
        }
      }
    }
    if (lane == 0) count[p] = n;
    any |= n != 0;
  }
  return any;
}

// Step 2b: the start table of the counted range.  Every warp scans the
// np <= 18 counts itself and returns the range's live total; lane p holds
// in `excl` where cell p's slots begin (lane np: the total), and warp 0
// writes the table.
__device__ __forceinline__ int range_starts(int np, TileShared& sh,
                                            int& excl) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = lane < np ? sh.count[lane] : 0;
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  excl = incl - n;
  if (warp == 0 && lane <= np) sh.start[lane] = excl;
  return __shfl_sync(kFull, excl, np);
}

// Step 2c: stage the live slots [q0, q1) of the range (in cell and slot
// order; q1 - q0 <= cap): a particle is kV float4s, element e of them
// plane e of the neighbour tier (src[e], a [C, K] plane; 0 past kF
// planes), vector v of live slot q at s4[v * cap + q - q0].  `excl` is
// range_starts'.  Up to 64 slots the range is staged whole (q0 = 0, q1 =
// its total).  Past them (kWide) it may be a piece: a cell outside it is
// not read, and a cell's scan ends at its last live slot of the piece,
// so a cell list sized for its worst cell is not read past its live
// slots when its mask is a prefix.
template <int kF, bool kWide>
__device__ __forceinline__ void stage_range(
    const float* const (&src)[kF], const uint8_t* __restrict__ mn, int lo,
    int np, int ncell, int K, int excl, int q0, int q1, float4* s4,
    int cap) {
  constexpr int kV = (kF + 3) / 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int p = warp; p < np; p += kWarps) {
    int q = __shfl_sync(kFull, excl, p);
    int end = q1;
    if constexpr (kWide) {
      end = min(__shfl_sync(kFull, excl, p + 1), q1);
      if (q >= end || end <= q0) continue;  // warp-uniform
    } else if (lo + p < 0 || lo + p >= ncell) {
      continue;
    }
    const long long row = (long long)(lo + p) * K;
    for (int s = lane; s - lane < K && (!kWide || q < end); s += 32) {
      const bool live = s < K && mn[row + s] != 0;
      const unsigned bits = __ballot_sync(kFull, live);
      const int dst = q + __popc(bits & lanes_below(lane)) - q0;
      if (live && (!kWide || (dst >= 0 && dst < end - q0))) {
        float e[4 * kV];
#pragma unroll
        for (int f = 0; f < 4 * kV; ++f) {
          e[f] = f < kF ? src[f < kF ? f : 0][row + s] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          s4[v * cap + dst] =
              make_float4(e[4 * v], e[4 * v + 1], e[4 * v + 2], e[4 * v + 3]);
        }
      }
      q += __popc(bits);
    }
  }
}

// Step 3 for one centre over the staged candidates [b, e) (in cell, then
// slot order): `pair(j)` for every j that `near(j)`.  With kMasked a span
// is tested in groups of up to 32 candidates into a bit mask before any
// pair is evaluated, so the lanes of a warp evaluate their pairs together
// instead of each candidate within the support of any lane costing the
// whole warp a pair; that pays where a pair costs much more than its test
// (the momentum kernels), not in the density kernel, which calls pair(j)
// on every candidate.
template <bool kMasked, typename Near, typename Pair>
__device__ __forceinline__ void walk_span(int b, int e, Near near,
                                          Pair pair) {
  if constexpr (kMasked) {
    for (int j0 = b; j0 < e; j0 += 32) {
      const int m = min(32, e - j0);
      unsigned hits = 0u;
      for (int i = 0; i < m; ++i) hits |= (unsigned)near(j0 + i) << i;
      for (; hits != 0u; hits &= hits - 1u) pair(j0 + __ffs(hits) - 1);
    }
  } else {
    for (int j = b; j < e; ++j) pair(j);
  }
}

// Steps 1-3 for the tile [c0, c0 + T): rounds of kThreads live centres.
// Thread t of a round owns centre r0 + t of the list and calls `load(s)`
// with its slot s in the tile, `pair(j)` for every staged neighbour j of
// its 27 cells that `near(j)` (in cell, then slot order), and `store(s)`;
// `dead(s)` is called for every dead centre slot.  Up to 64 slots a cell
// the whole tile is ranked first (at most kList slots) and every range is
// staged whole.  Past them (kWide) the list is a ring: before each round
// the CTA ranks further chunks while a chunk fits behind the unread
// centres, so the list holds at most kList centres whatever K is; and a
// range with more live slots than `stage_cap` is staged and walked in
// pieces of at most that many, in order, so the order of the sums does
// not change.  kWide (with the word counts and the staging scan that
// stops at a cell's last live slot) is a compile-time choice, made from K
// at the launch: the K <= 64 roles measured 3-32% slower with it, mostly
// through the registers it takes.
template <int kF, bool kMasked, bool kWide, typename Dead, typename Load,
          typename Near, typename Pair, typename Store>
__device__ __forceinline__ void walk_tile(
    const float* const (&src)[kF], const uint8_t* __restrict__ mc,
    const uint8_t* __restrict__ mn, const Geometry& g, int c0, int T,
    float4* s4, TileShared& sh, Dead dead, Load load, Near near, Pair pair,
    Store store) {
  const int ncell = g.nx * g.ny * g.nz;
  const int np = T + 2;
  const int cap = stage_cap(T, g.k);
  const int nslots = min(T, ncell - c0) * g.k;
  const uint8_t* mt = mc + (long long)c0 * g.k;
  int n = 0;       // centres listed
  int ranked = 0;  // centre slots ranked
  if constexpr (!kWide) {
    for (; ranked < nslots; ranked += kThreads) {
      n = list_centres(mt, ranked, nslots, n, (ranked / kThreads) & 1, sh,
                       dead);
    }
    __syncthreads();
  }
  for (int r0 = 0;; r0 += kThreads) {
    if constexpr (kWide) {
      while (ranked < nslots && n - r0 <= kList - kThreads) {  // uniform
        n = list_centres(mt, ranked, nslots, n, (ranked / kThreads) & 1,
                         sh, dead);
        ranked += kThreads;
      }
      if (r0 >= n) break;
      __syncthreads();  // the round's centres are listed
    } else {
      if (r0 >= n) break;
    }
    const int t = r0 + (int)threadIdx.x;
    const bool has = t < n;
    const int s = has ? sh.list[t & (kList - 1)] : 0;
    const int cell = c0 + s / g.k;
    int ix, iy, iz;
    cell_coords(cell, g, ix, iy, iz);
    const int p = cell - c0 + 1;  // the centre's cell in every range
    const int b_at = iz > 0 ? p - 1 : p;
    const int e_at = iz < g.nz - 1 ? p + 2 : p + 1;
    if (has) load(s);
    for (int r = 0; r < 9; ++r) {  // r = 3 (dx + 1) + (dy + 1)
      const int dx = r / 3 - 1;
      const int dy = r % 3 - 1;
      const int lo = c0 + (dx * g.ny + dy) * g.nz - 1;
      // the previous range's walk ends before any warp passes this
      // barrier, so restaging cannot overwrite what is being read; a range
      // without a live slot (a cross role against a sparse tier) is
      // neither staged nor walked
      if (!__syncthreads_or(
              count_range<kWide>(mn, lo, np, ncell, g.k, sh.count))) {
        continue;
      }
      int excl;
      const int total = range_starts(np, sh, excl);
      const int jx = ix + dx;
      const int jy = iy + dy;
      const bool walks = has && jx >= 0 && jx < g.nx && jy >= 0 && jy < g.ny;
      if constexpr (kWide) {
        for (int q0 = 0; q0 < total; q0 += cap) {  // uniform
          if (q0 > 0) __syncthreads();  // the previous piece is walked
          const int q1 = min(q0 + cap, total);
          stage_range<kF, true>(src, mn, lo, np, ncell, g.k, excl, q0, q1,
                                s4, cap);
          __syncthreads();
          if (walks) {
            walk_span<kMasked>(max(sh.start[b_at], q0) - q0,
                               min(sh.start[e_at], q1) - q0, near, pair);
          }
        }
      } else {
        stage_range<kF, false>(src, mn, lo, np, ncell, g.k, excl, 0, total,
                               s4, cap);
        __syncthreads();
        if (walks) {
          walk_span<kMasked>(sh.start[b_at], sh.start[e_at], near, pair);
        }
      }
    }
    if (has) store(s);
  }
}

// Dynamic shared memory of a tile launch: the staged float4s of
// stage_cap(T, K) particles (at most 36.9 KB, momentum at T = 16, the same
// at any K past 64; within the 48 KB a launch takes without opting in).
inline size_t tile_smem(int kF, int T, int K) {
  return (size_t)(kF + 3) / 4 * stage_cap(T, K) * sizeof(float4);
}

// r^2 between a centre and staged position p, as the pair functions take
// it.
__device__ __forceinline__ float sep2(float cx, float cy, float cz,
                                      const float4& p) {
  const float ddx = cx - p.x;
  const float ddy = cy - p.y;
  const float ddz = cz - p.z;
  return ddx * ddx + ddy * ddy + ddz * ddz;
}

// rho_i = mfold * sum_{27 cells} sum_j W'(r_ij) over live j, where W' is
// t^4 (2q+1) for WendlandC2 (sigma folded into mfold) and the full cubic
// spline W for kind 1 (mfold is then the mass).  One CTA a tile of T
// cells; zero on dead centre slots.  kWide: past 64 slots a cell
// (density_wide).
template <bool kWide>
__global__ void __launch_bounds__(
    kThreads, kWide ? kDensityWideTilesPerSM : kDensityTilesPerSM)
density_pairs_kernel(const float* __restrict__ xc,
                     const uint8_t* __restrict__ mc,
                     const float* __restrict__ xn,
                     const uint8_t* __restrict__ mn,
                     float* __restrict__ out, Geometry g, int T, int kind,
                     float inv2h, float invh2, float mfold, float h,
                     float sigma, float supp2) {
  extern __shared__ float4 s4[];
  __shared__ TileShared sh;
  constexpr int kF = 3;
  const int ncell = g.nx * g.ny * g.nz;
  const int c0 = blockIdx.x * T;
  const long long plane = (long long)ncell * g.k;
  const long long base = (long long)c0 * g.k;
  const float* const src[kF] = {xn, xn + plane, xn + 2 * plane};
  float cx, cy, cz, acc;
  walk_tile<kF, false, kWide>(
      src, mc, mn, g, c0, T, s4, sh,
      [&](int s) { out[base + s] = 0.f; },
      [&](int s) {
        cx = xc[base + s];
        cy = xc[plane + base + s];
        cz = xc[2 * plane + base + s];
        acc = 0.f;
      },
      [&](int) { return true; },
      [&](int j) {
        const float4 y = s4[j];
        density_pair(cx, cy, cz, y.x, y.y, y.z, 1.f, kind, inv2h, invh2, h,
                     sigma, supp2, acc);
      },
      [&](int s) { out[base + s] = mfold * acc; });
}

// Planes of one staged neighbour cell in the momentum kernels.
enum Plane { kX, kY, kZ, kVx, kVy, kVz, kRho, kPt, kMask };

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
//
// kExtra = kXsph appends the XSPH drift correction (_xsph_blocks)
//   dv_i = xfold * m_i * sum_j m_j W'(r) / (rho_i + rho_j) * (v_j - v_i)
// (note the sign), W' = W / sigma from the t that g(r) forms, xfold =
// 2 m sigma: 3 more planes after the acceleration (and drho/dt).  The
// acceleration and drho/dt planes are the kPlain instance's, bit for bit.
// kExtra = kEnergy writes only the internal-energy rate (_energy_blocks)
//   du_i/dt = -1/2 m_i * sum_j m_j scale_ij (v_ij.x_ij),
// scale_ij the acceleration's pair scale: [C, K].
enum Extra { kPlain = 0, kXsph = 1, kEnergy = 2 };

struct MomentumFolds {
  float adrho, ddfold, eta2, rho_floor;  // drho/dt (kDrho)
  float xfold;                           // XSPH (kXsph)
};

// Fields of one particle of the momentum pass.
struct Particle {
  float x, y, z, vx, vy, vz, rho, pt;
};

// One pair's terms of the momentum sums (and of drho/dt with kDrho, and
// of `e` with kExtra), for centre c and neighbour y of live-mask value m
// (nothing beyond the support).
template <bool kDrho, int kExtra>
__device__ __forceinline__ void momentum_pair(
    const Particle& c, const Particle& y, float m, int kind, float inv2h,
    float h, float sigma, float h2eps, float cv, float supp2,
    const MomentumFolds& f, float& ax, float& ay, float& az, float& dr,
    float (&e)[3]) {
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
  if constexpr (kExtra == kEnergy) {
    e[0] = fmaf(scale, vdotx, e[0]);
  }
  if constexpr (kExtra == kXsph) {
    float w;
    if (kind == kWendlandC2) {  // t^4 (2q + 1), 2q = 4 inv2h r
      const float t = fmaxf(1.f - inv2h * r, 0.f);
      const float t2 = t * t;
      w = (t2 * t2) * fmaf(4.f * inv2h, r, 1.f);
    } else {
      w = cubic_w(r, h, 1.f);
    }
    const float cw = __fdividef(w * m, c.rho + y.rho);
    e[0] = fmaf(cw, y.vx - c.vx, e[0]);
    e[1] = fmaf(cw, y.vy - c.vy, e[1]);
    e[2] = fmaf(cw, y.vz - c.vz, e[2]);
  }
}

// Output planes of an accel_pairs_kernel instance.
template <bool kDrho, int kExtra>
__host__ __device__ constexpr int momentum_planes() {
  return kExtra == kEnergy ? 1
                           : 3 + (kDrho ? 1 : 0) + (kExtra == kXsph ? 3 : 0);
}

// kDrho: also sum drho/dt (accel_drho_pairs); kWide: past 64 slots a cell
// (accel_wide, accel_drho_wide); kExtra: the XSPH sums or the energy rate
// instead of the acceleration.
template <bool kDrho, bool kWide, int kExtra>
__global__ void __launch_bounds__(
    kThreads, kExtra != kXsph ? kTilesPerSM
                              : kWide ? kXsphWideTilesPerSM : kXsphTilesPerSM)
accel_pairs_kernel(const float* __restrict__ xc, const float* __restrict__ vc,
                   const float* __restrict__ rhoc,
                   const float* __restrict__ ptc,
                   const uint8_t* __restrict__ mc,
                   const float* __restrict__ xn, const float* __restrict__ vn,
                   const float* __restrict__ rhon,
                   const float* __restrict__ ptn,
                   const uint8_t* __restrict__ mn, float* __restrict__ out,
                   Geometry g, int T, int kind, float inv2h, float h,
                   float sigma, float h2eps, float cv, float supp2,
                   MomentumFolds f) {
  extern __shared__ float4 s4[];
  __shared__ TileShared sh;
  constexpr int kF = kMask;  // the planes before kMask, two float4s
  constexpr int kOut = momentum_planes<kDrho, kExtra>();
  const int ncell = g.nx * g.ny * g.nz;
  const int c0 = blockIdx.x * T;
  const int cap = stage_cap(T, g.k);
  const long long plane = (long long)ncell * g.k;
  const long long base = (long long)c0 * g.k;
  const float* const src[kF] = {xn, xn + plane, xn + 2 * plane,
                                vn, vn + plane, vn + 2 * plane,
                                rhon, ptn};
  Particle c;
  float ax, ay, az, dr;
  float e[3];
  walk_tile<kF, true, kWide>(
      src, mc, mn, g, c0, T, s4, sh,
      [&](int s) {
#pragma unroll
        for (int o = 0; o < kOut; ++o) out[o * plane + base + s] = 0.f;
      },
      [&](int s) {
        const long long i = base + s;
        c = Particle{xc[i], xc[plane + i], xc[2 * plane + i],
                     vc[i], vc[plane + i], vc[2 * plane + i],
                     rhoc[i], ptc[i]};
        ax = ay = az = dr = 0.f;
        e[0] = e[1] = e[2] = 0.f;
      },
      [&](int j) { return sep2(c.x, c.y, c.z, s4[j]) < supp2; },
      [&](int j) {
        const float4 a = s4[j];        // x, y, z, vx
        const float4 b = s4[cap + j];  // vy, vz, rho, pt
        const Particle y{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        momentum_pair<kDrho, kExtra>(c, y, 1.f, kind, inv2h, h, sigma, h2eps,
                                     cv, supp2, f, ax, ay, az, dr, e);
      },
      [&](int s) {
        const long long i = base + s;
        if constexpr (kExtra == kEnergy) {
          out[i] = -0.5f * e[0];
        } else {
          out[i] = ax;
          out[plane + i] = ay;
          out[2 * plane + i] = az;
          if constexpr (kDrho) out[3 * plane + i] = f.adrho * dr;
          if constexpr (kExtra == kXsph) {
            constexpr int o = kDrho ? 4 : 3;
            out[o * plane + i] = f.xfold * e[0];
            out[(o + 1) * plane + i] = f.xfold * e[1];
            out[(o + 2) * plane + i] = f.xfold * e[2];
          }
        }
      });
}

// Akinci surface normals (_st_normals_blocks):
//   n_i = nfold * m_i * sum_j m_j g(r) / rho_j (x_i - x_j),
// g(r) as in the momentum kernels and nfold = -hs cfold (hs the kernel
// support), i.e. hs sum_j (m / rho_j) dW/dr / r (x_i - x_j).  One staged
// float4 (x, y, z, rho) a neighbour, every candidate walked as in
// density_pairs (the approximate divide by rho_j is the only cost past a
// density pair's); zero on dead centre slots.  The self pair adds exactly
// 0 (x_ij = 0).
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kNormalsTilesPerSM)
st_normals_kernel(const float* __restrict__ xc,
                  const uint8_t* __restrict__ mc,
                  const float* __restrict__ xn,
                  const float* __restrict__ rhon,
                  const uint8_t* __restrict__ mn, float* __restrict__ out,
                  Geometry g, int T, int kind, float inv2h, float h,
                  float sigma, float supp2, float nfold) {
  extern __shared__ float4 s4[];
  __shared__ TileShared sh;
  constexpr int kF = 4;
  const int ncell = g.nx * g.ny * g.nz;
  const int c0 = blockIdx.x * T;
  const long long plane = (long long)ncell * g.k;
  const long long base = (long long)c0 * g.k;
  const float* const src[kF] = {xn, xn + plane, xn + 2 * plane, rhon};
  float cx, cy, cz, nx, ny, nz;
  walk_tile<kF, false, kWide>(
      src, mc, mn, g, c0, T, s4, sh,
      [&](int s) {
#pragma unroll
        for (int o = 0; o < 3; ++o) out[o * plane + base + s] = 0.f;
      },
      [&](int s) {
        cx = xc[base + s];
        cy = xc[plane + base + s];
        cz = xc[2 * plane + base + s];
        nx = ny = nz = 0.f;
      },
      [&](int) { return true; },
      [&](int j) {
        const float4 y = s4[j];  // x, y, z, rho
        const float ddx = cx - y.x;
        const float ddy = cy - y.y;
        const float ddz = cz - y.z;
        const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
        if (r2 >= supp2) return;
        const float q = __fdividef(
            grad_weight(kind, sqrtf(r2), inv2h, h, sigma), y.w);
        nx = fmaf(q, ddx, nx);
        ny = fmaf(q, ddy, ny);
        nz = fmaf(q, ddz, nz);
      },
      [&](int s) {
        out[base + s] = nfold * nx;
        out[plane + base + s] = nfold * ny;
        out[2 * plane + base + s] = nfold * nz;
      });
}

// Fields of one particle of the surface-tension force pass.
struct StParticle {
  float x, y, z, nx, ny, nz, rho;
};

// Akinci surface-tension force (_st_force_blocks with _cohesion_c):
//   a_i = m_i sum_j m_j kfold / (rho_i + rho_j)
//         * (cohfold F(u) / max(r, 1e-12) (x_i - x_j) + (n_i - n_j))
// with u = r / hs, F the cohesion spline in units of hs^6 (((1 - u) u)^3
// past u = 1/2, 2 ((1 - u) u)^3 - 1/64 below, 0 past the support),
// cohfold = 32 m / (pi hs^3) and kfold = -2 gamma rho0.  The reference's
// 32 / (pi hs^9) (about 3e15 at the 1M dam break's hs) and its hs^6
// factors are folded on the host, so no intermediate leaves the float32
// range at any h.  The curvature term n_i - n_j carries no kernel weight:
// the reference sums it over every live neighbour of the 27 cells, within
// the support or not, so this walk visits every candidate (as density
// does) and evaluates the cohesion spline only within the support.  The
// self pair adds exactly 0 (x_ij = 0 through the max(r, 1e-12) divisor,
// n_i - n_i = 0).  Two staged float4s (x, y, z, nx | ny, nz, rho); zero on
// dead centre slots.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kForceTilesPerSM)
st_force_kernel(const float* __restrict__ xc, const float* __restrict__ nc,
                const float* __restrict__ rhoc,
                const uint8_t* __restrict__ mc,
                const float* __restrict__ xn, const float* __restrict__ nn,
                const float* __restrict__ rhon,
                const uint8_t* __restrict__ mn, float* __restrict__ out,
                Geometry g, int T, float supp2, float inv_hs, float cohfold,
                float kfold) {
  extern __shared__ float4 s4[];
  __shared__ TileShared sh;
  constexpr int kF = 7;
  const int ncell = g.nx * g.ny * g.nz;
  const int c0 = blockIdx.x * T;
  const int cap = stage_cap(T, g.k);
  const long long plane = (long long)ncell * g.k;
  const long long base = (long long)c0 * g.k;
  const float* const src[kF] = {xn, xn + plane, xn + 2 * plane,
                                nn, nn + plane, nn + 2 * plane, rhon};
  StParticle c;
  float ax, ay, az;
  walk_tile<kF, false, kWide>(
      src, mc, mn, g, c0, T, s4, sh,
      [&](int s) {
#pragma unroll
        for (int o = 0; o < 3; ++o) out[o * plane + base + s] = 0.f;
      },
      [&](int s) {
        const long long i = base + s;
        c = StParticle{xc[i], xc[plane + i], xc[2 * plane + i],
                       nc[i], nc[plane + i], nc[2 * plane + i], rhoc[i]};
        ax = ay = az = 0.f;
      },
      [&](int) { return true; },
      [&](int j) {
        const float4 a = s4[j];        // x, y, z, nx
        const float4 b = s4[cap + j];  // ny, nz, rho, 0
        const float ddx = c.x - a.x;
        const float ddy = c.y - a.y;
        const float ddz = c.z - a.z;
        const float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
        float coh = 0.f;  // the cohesion spline is 0 past the support
        if (r2 < supp2) {
          const float r = sqrtf(r2);
          const float u = r * inv_hs;
          const float hr = fmaxf(1.f - u, 0.f) * u;
          const float core = hr * hr * hr;
          const float spline = u > 0.5f ? (u <= 1.f ? core : 0.f)
                                        : fmaf(2.f, core, -1.f / 64.f);
          coh = cohfold * spline / fmaxf(r, 1e-12f);
        }
        const float kij = kfold / (c.rho + b.z);
        ax = fmaf(kij, fmaf(coh, ddx, c.nx - a.w), ax);
        ay = fmaf(kij, fmaf(coh, ddy, c.ny - b.x), ay);
        az = fmaf(kij, fmaf(coh, ddz, c.nz - b.y), az);
      },
      [&](int s) {
        const long long i = base + s;
        out[i] = ax;
        out[plane + i] = ay;
        out[2 * plane + i] = az;
      });
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, never synchronises, and returns
// cudaGetLastError() (0 = launched).  Shapes and dtypes are checked by the
// Python wrapper (tpgsd_torch/sph/ops.py).

// `tile` is T, the cells per CTA (1 .. 16).  Any k up to 1024: the
// two-tier roles and the single tier past 64 slots (density_wide).
int tpgsd_density_pairs(const float* xc, const uint8_t* mc, const float* xn,
                        const uint8_t* mn, float* out, int nx, int ny, int nz,
                        int k, int tile, int kind, float inv2h, float invh2,
                        float mfold, float h, float sigma, float supp2,
                        void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || k > kMaxWideK || tile < 1 ||
      tile > kMaxTile) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{nx, ny, nz, k};
  auto* kernel =
      k > kMaxK ? density_pairs_kernel<true> : density_pairs_kernel<false>;
  kernel<<<(ncell + tile - 1) / tile, kThreads, tile_smem(3, tile, k),
           static_cast<cudaStream_t>(stream)>>>(
      xc, mc, xn, mn, out, g, tile, kind, inv2h, invh2, mfold, h, sigma,
      supp2);
  return (int)cudaGetLastError();
}

// n_out = 3: accel_pairs, out [3, C, K]; the four drho folds are unused.
// n_out = 4: accel_drho_pairs, out [4, C, K] with drho/dt as plane 3.
// n_out = 6, 7: the same with the XSPH correction (xfold) as the last 3
// planes.  n_out = 1: the internal-energy rate, out [C, K].
// Any k up to 1024: one kernel serves the two-tier roles and the single
// tier past 64 slots (accel_wide, accel_drho_wide, ..._wide).
int tpgsd_accel_pairs(const float* xc, const float* vc, const float* rhoc,
                      const float* ptc, const uint8_t* mc, const float* xn,
                      const float* vn, const float* rhon, const float* ptn,
                      const uint8_t* mn, float* out, int n_out, int nx,
                      int ny, int nz, int k, int tile, int kind, float inv2h,
                      float h, float sigma, float h2eps, float cv,
                      float supp2, float adrho, float ddfold, float eta2,
                      float rho_floor, float xfold, void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || k > kMaxWideK || tile < 1 ||
      tile > kMaxTile) {
    return (int)cudaErrorInvalidValue;
  }
  const bool wide = k > kMaxK;
  decltype(&accel_pairs_kernel<false, false, kPlain>) kernel;
  switch (n_out) {
    case 1:
      kernel = wide ? accel_pairs_kernel<false, true, kEnergy>
                    : accel_pairs_kernel<false, false, kEnergy>;
      break;
    case 3:
      kernel = wide ? accel_pairs_kernel<false, true, kPlain>
                    : accel_pairs_kernel<false, false, kPlain>;
      break;
    case 4:
      kernel = wide ? accel_pairs_kernel<true, true, kPlain>
                    : accel_pairs_kernel<true, false, kPlain>;
      break;
    case 6:
      kernel = wide ? accel_pairs_kernel<false, true, kXsph>
                    : accel_pairs_kernel<false, false, kXsph>;
      break;
    case 7:
      kernel = wide ? accel_pairs_kernel<true, true, kXsph>
                    : accel_pairs_kernel<true, false, kXsph>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const Geometry g{nx, ny, nz, k};
  const MomentumFolds f{adrho, ddfold, eta2, rho_floor, xfold};
  kernel<<<(ncell + tile - 1) / tile, kThreads, tile_smem(kMask, tile, k),
           static_cast<cudaStream_t>(stream)>>>(
      xc, vc, rhoc, ptc, mc, xn, vn, rhon, ptn, mn, out, g, tile, kind,
      inv2h, h, sigma, h2eps, cv, supp2, f);
  return (int)cudaGetLastError();
}

// Akinci surface normals, out [3, C, K]; any k up to 1024.
int tpgsd_st_normals(const float* xc, const uint8_t* mc, const float* xn,
                     const float* rhon, const uint8_t* mn, float* out, int nx,
                     int ny, int nz, int k, int tile, int kind, float inv2h,
                     float h, float sigma, float supp2, float nfold,
                     void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || k > kMaxWideK || tile < 1 ||
      tile > kMaxTile) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{nx, ny, nz, k};
  auto* kernel = k > kMaxK ? st_normals_kernel<true> : st_normals_kernel<false>;
  kernel<<<(ncell + tile - 1) / tile, kThreads, tile_smem(4, tile, k),
           static_cast<cudaStream_t>(stream)>>>(
      xc, mc, xn, rhon, mn, out, g, tile, kind, inv2h, h, sigma, supp2,
      nfold);
  return (int)cudaGetLastError();
}

// Akinci surface-tension force, out [3, C, K]; any k up to 1024.
int tpgsd_st_force(const float* xc, const float* nc, const float* rhoc,
                   const uint8_t* mc, const float* xn, const float* nn,
                   const float* rhon, const uint8_t* mn, float* out, int nx,
                   int ny, int nz, int k, int tile, float supp2,
                   float inv_hs, float cohfold, float kfold, void* stream) {
  const int ncell = nx * ny * nz;
  if (ncell <= 0 || k <= 0 || k > kMaxWideK || tile < 1 ||
      tile > kMaxTile) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{nx, ny, nz, k};
  auto* kernel = k > kMaxK ? st_force_kernel<true> : st_force_kernel<false>;
  kernel<<<(ncell + tile - 1) / tile, kThreads, tile_smem(7, tile, k),
           static_cast<cudaStream_t>(stream)>>>(
      xc, nc, rhoc, mc, xn, nn, rhon, mn, out, g, tile, supp2, inv_hs,
      cohfold, kfold);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory one tile launch asks for: `accel` 0 for
// tpgsd_density_pairs and tpgsd_st_normals (one staged float4 a
// particle), 1 for tpgsd_accel_pairs (any n_out) and tpgsd_st_force (two).
long long tpgsd_tile_smem(int accel, int tile, int k) {
  return (long long)tile_smem(accel ? kMask : 3, tile, k);
}

const char* tpgsd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
