// Per-slot results of the pair passes to particle rows, for Hopper (sm_90a).
//
// The pair passes leave their results per slot of the dense cell layout:
// one [E, K] plane a column (acc x/y/z, drho/dt, the XSPH correction, the
// density and the pressure, du/dt) and a tier (slots < K, and with the
// spill layout slots K .. 2K - 1).  A step needs them per particle, in
// the particle order of its state.  slot_rows_kernel moves them there in
// one pass: thread i takes sorted row r (i, or in a slab's window p0 + i),
// reads the row's cell and slot, picks the tier by the slot, reads each
// column from that tier's plane and writes row order[r] of the [n, F]
// output, so the inverse permutation is the write's own index.  A row
// whose slot lies past the tiers (a particle dropped by the cell list, or
// a dead slot of a decomposed step) gets the fill row (rho0 in a density
// column, 0 elsewhere), as the sentinel row of the dense layout gave it.
// A slab's window stops at the slab's last row (p1, the next slab's
// first): its threads past p1 write no particle row, since those rows are
// the later slabs' own.  With `win` the rows are also written in window
// order (a slab's frame rows), the fill row past p1.
//
// The cell of a row is its cell id on the grid the cells were built on,
// placed into the planes' grid: the same grid (the global step), the core
// block of an extended grid (one ghost layer on each decomposed axis) or
// a slab's extended range (cell ids of the whole domain less the range's
// first cell), clamped into the planes.
//
// The kernel copies bytes; it computes no value.  Reads of a tier's planes
// follow the sorted order, so consecutive rows read consecutive slots;
// the writes scatter a row of F floats.  24 + 8 F bytes a row written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kRowThreads = 256;

struct Columns {
  const float* tier[2][kMaxCols];  // a [E, K] plane a column and a tier
  float fill[kMaxCols];            // the row of a dropped or dead slot
};

struct CellMap {
  long long plane_in;   // ny nz of the grid of the cell ids
  long long nz_in;
  long long plane_ext;  // ny nz of the planes' grid
  long long nz_ext;
  long long offset;     // the planes' cell of cell id 0
  long long n_ext;      // cells of the planes
  int same;             // both grids share ny and nz: a cell id moves by offset
};

__device__ __forceinline__ long long planes_cell(long long c,
                                                 const CellMap& m) {
  long long e = c;
  if (!m.same) {
    const long long ix = c / m.plane_in;
    const long long rem = c - ix * m.plane_in;
    const long long iy = rem / m.nz_in;
    e = ix * m.plane_ext + iy * m.nz_ext + (rem - iy * m.nz_in);
  }
  e += m.offset;
  return e < 0 ? 0 : (e >= m.n_ext ? m.n_ext - 1 : e);
}

__global__ void __launch_bounds__(kRowThreads)
    slot_rows_kernel(const int64_t* __restrict__ cid,
                     const int64_t* __restrict__ slot,
                     const int64_t* __restrict__ order,
                     const int64_t* __restrict__ row0,
                     const int64_t* __restrict__ row1, long long n_rows,
                     long long n, const Columns cols, int n_cols, int k,
                     int n_tiers, const CellMap map, float* __restrict__ out,
                     float* __restrict__ win) {
  const long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= n_rows) return;
  float* wdst = win != nullptr ? win + i * n_cols : nullptr;
  long long r = i;
  if (row0 != nullptr) {
    r += *row0;
    const long long end = *row1 < n ? *row1 : n;
    if (r >= end) {  // a later slab's row, or past the last
      if (wdst != nullptr) {
        for (int j = 0; j < n_cols; ++j) wdst[j] = cols.fill[j];
      }
      return;
    }
  }
  const long long kt = (long long)k * n_tiers;
  const long long s = slot[r];
  const bool dropped = s >= kt;
  const long long sc = s < 0 ? 0 : (dropped ? kt - 1 : s);
  const int t = sc >= k;
  const long long at = planes_cell(cid[r], map) * k + (sc - t * k);
  float* dst = out + order[r] * n_cols;
  for (int j = 0; j < n_cols; ++j) {
    const float v = dropped ? cols.fill[j] : __ldg(cols.tier[t][j] + at);
    dst[j] = v;
    if (wdst != nullptr) wdst[j] = v;
  }
}

}  // namespace

extern "C" {

// Rows `row0 + i` (row0 a device int64, or null for 0), i < n_rows, of
// the sorted order, those before `row1` (a device int64, with row0) and
// n; `out` [n, n_cols] in particle order, `win` [n_rows, n_cols] in
// window order (the fill row past row1) or null.  `tier_a`/`tier_b`
// hold n_cols plane pointers each (tier_b unused with one tier), `fill`
// n_cols floats; the cell map as CellMap's fields.  Launches on `stream`,
// never synchronises, returns cudaGetLastError() (0 = launched).
int tpgsd_slot_rows(const int64_t* cid, const int64_t* slot,
                    const int64_t* order, const int64_t* row0,
                    const int64_t* row1, long long n_rows, long long n,
                    const float* const* tier_a,
                    const float* const* tier_b, const float* fill, int n_cols,
                    int k, int n_tiers, long long plane_in, long long nz_in,
                    long long plane_ext, long long nz_ext, long long offset,
                    long long n_ext, float* out, float* win, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || k < 1 || n_tiers < 1 ||
      n_tiers > 2 || n_rows < 0 || n < 0 || n_ext < 1 || plane_in < 1 ||
      nz_in < 1 || plane_ext < 1 || nz_ext < 1 ||
      (row0 == nullptr) != (row1 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return 0;
  Columns cols{};
  for (int j = 0; j < n_cols; ++j) {
    cols.tier[0][j] = tier_a[j];
    cols.tier[1][j] = n_tiers == 2 ? tier_b[j] : tier_a[j];
    cols.fill[j] = fill[j];
  }
  const CellMap map{plane_in, nz_in, plane_ext, nz_ext, offset, n_ext,
                    plane_in == plane_ext && nz_in == nz_ext};
  const long long blocks = (n_rows + kRowThreads - 1) / kRowThreads;
  slot_rows_kernel<<<(unsigned)blocks, kRowThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      cid, slot, order, row0, row1, n_rows, n, cols, n_cols, k, n_tiers, map,
      out, win);
  return (int)cudaGetLastError();
}

}  // extern "C"
