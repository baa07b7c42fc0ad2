// Fused-iteration stencil tile kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/stencil.py::stencil_pallas (K1,
// one grid) and src/repro/kernels/pipeline.py::stencil_pallas_batched (K2,
// the batch folded into the kernel grid).  Both launch this one kernel: K1
// with gridDim.z == 1, K2 with gridDim.z == B, so the two agree bitwise.
//
// kernels/cuda_build.py generates two files per lowered spec.  The
// translation unit defines, before including this file:
//   SASA_N_IN        number of floating spec inputs (the windows staged in
//                    shared memory)
//   SASA_ITER        index of the iterate input among them
//   SASA_N_HALO      number of streamed int32 halo-index maps (0, or one
//                    per real axis: a bucketed replicate spec)
//   SASA_N_LOCAL     number of `local` stages
//   SASA_NDIM        number of real axes (the last SASA_NDIM of 3)
//   SASA_STRIP       cells of a strip (2-D and 3-D; see "Stage walk")
//   SASA_RADIUS      the spec's radius r (sum of its stage radii)
//   SASA_FRAME       width of the zero frame around every window (the
//                    largest stage radius for a streamed spec, else 0)
//   SASA_BOUNDARY    0 zero, 1 constant, 2 replicate, 3 periodic
//   SASA_BVALUE      the constant boundary value (float literal)
//   SASA_STORE_BF16  1 when every array is bfloat16, else 0 (float32)
// and "spec_body.cuh", included below, holds the spec's expressions, one
// specialisation per stage (locals, then output):
//   sasa_stage<k>    the stage at one cell, reading taps through sasa_tap
//   sasa_strip<k>    2-D and 3-D: the stage at the SASA_STRIP cells of a
//                    strip, its tap columns loaded into registers first
//   SASA_STAGE_CALLS the statements running every stage of one iteration,
//                    SASA_STAGE(k, tail_k, destination) for each k, where
//                    tail_k is the sum of the radii of the stages after k
//                    (kernels/tiling.py::stage_regions at s = 1)
//
// Geometry.  Every axis is tiled (a 4096-column f32 row is 16 KB and the
// window needs several arrays, which 227 KB of shared memory cannot hold
// whole).  A block owns an interior tile plus a halo of h = s * r cells on
// every side of every real axis: its window.  A 2-D spec is run as
// (1, R, C).  Each input window is loaded once, then s fused iterations run
// in shared memory and the tile is written back.
//
// Shrinking trapezoid.  Stage k of iteration j (0-based) computes only the
// tile dilated by e(j, k) = (s - 1 - j) * r + tail_k cells on every real
// axis: the cells that later stages still read.  Any stage that reads the
// result of stage k (a later stage of iteration j, or, for the output
// stage, every stage of iteration j + 1) has a dilation of at most
// e(j, k) - r_reader, so every tap of a computed cell lands on a computed
// cell of its producer; the last stage of the last iteration computes the
// tile.  Since e(j, k) + r_k <= s * r = h, no tap leaves the window, so a
// tap is the cell's flat index plus a constant offset, with no bounds
// check.  Cells outside a stage's region keep stale values that no later
// stage reads.  The values of the computed cells are the ones a full-window
// update would give (the plain version, blockops.fused_iterations_on_block,
// computes full windows): same taps, same expression, same order.  This is
// the closed form of kernels/tiling.py::stage_regions, which the round
// plan (kernels/tiling.py::round_plan) sums for the launch's counters and
// the ranker (core/model.py::predict_gpu) to price the work.
//
// Stage walk.  In 2-D and 3-D a stage's region is cut into strips: a
// column at fixed coordinates on the inner axes (x in 2-D, y and x in
// 3-D) and SASA_STRIP consecutive cells along the outermost real axis (y
// in 2-D, z in 3-D).  The block's threads take (strip, column) pairs in
// turn, adjacent lanes adjacent x, so a warp's shared loads are one
// contiguous row.  For each distinct (buffer, inner-axis offset) of the
// stage's taps, a whole strip loads the SASA_STRIP cells of that column
// plus its tap span along the walk axis into registers, once, and each tap
// of a cell reads a register: a JACOBI2D update loads 3 + 2 / SASA_STRIP
// values where it has 5 taps, HEAT3D 5 + 2 / SASA_STRIP of 7.  The strip
// is computed one operation at a time over all its cells (each cell's
// operations in its own order), so the cells' operations interleave
// freely; the results are then stored one row stride apart.  The strip
// left at the region's end when its extent is no multiple of SASA_STRIP
// is shorter, and runs its cells one by one through sasa_stage.  An edge
// block tests the inner coordinates of a column once and bounds the walk
// coordinate before the strip.  Every cell of the region, and no other,
// is computed with the same expression, taps and order of operations as
// a cell-by-cell walk.  1-D specs walk the region cell by cell
// (sasa_walk): a strip along x would put a warp's lanes SASA_STRIP floats
// apart in shared memory.
//
// Boundary rule.  A block loads its input windows in one of three ways.
// (1) One tensor copy a window: in a launch of a 2-D or 3-D float32 spec
// without halo-index maps, of radius 1 or more, whose grid rows and x
// tiles are a multiple of 4 cells,
// whose copy box (the window, its rows at the pitch) spans at most 256
// cells an axis and whose inputs lie 16-byte aligned
// (kernels/tiling.py::round_plan and tma_windows count the windows, the
// launch decides), thread 0 issues one cp.async.bulk.tensor per window
// through a 4-D tensor map (x, y, z, batch) the launch encodes, and every
// thread waits on one mbarrier for the bytes.  The copy computes every
// address, negative ones on an edge too, and fills every cell outside the
// grid with zeros: the zero rule; in an edge block, constant then writes
// the boundary value and replicate copies the clamped in-grid cell to the
// cells outside the window's in-grid box.  A box starts on a 16-byte unit
// of the grid's row, so it starts up to 3 cells before the window and a
// short pass fills the row ends past it (sasa_load_tma).  Every block
// loads so, but a periodic edge block.
// (2) Periodic edge blocks, and every block of a launch that cannot take
// the copy, copy the window's in-grid box (an interior block's whole
// window) row by row with cp.async, 16, 8 or 4 bytes as the rows'
// alignment allows, then give every cell outside it the rule: zero/
// constant the boundary value, replicate the clamped in-grid cell (copied
// in shared memory), periodic the wrapped grid cell (a 4-byte cp.async
// each).  (3) bfloat16 specs, and edge blocks of specs with halo-index
// maps, load one cell at a time with the rule folded into the index
// (zero/constant: a select, replicate: clamp, periodic: wrap); interior
// blocks of specs with halo-index maps copy rows as in (2).  Interior
// blocks, whose whole window lies inside the grid, run no per-cell grid
// test, fixup pass or barrier after a stage.  They are 85-86% of the
// blocks of JACOBI2D 9720x1024 on 64x64 and 128x64 tiles, and none of
// HEAT3D 9720x32x32 on 16x8x32 tiles, whose window overhangs the 32-cell
// row on both sides.  After each stage of an edge block, zero/constant
// cells outside the grid take the boundary value and replicate cells copy
// the clamped in-grid cell.  That cell lies between the cell and the tile
// on every axis, hence inside the region (tiles start inside the grid).
//
// Streamed halo-index maps (bucketed replicate serving).  Each map holds,
// per cell, the grid coordinate along its axis that the cell copies from:
// identity on the request's real region, a clamp onto its last real cell
// on the bucket's padding belt (an all-zero map for a batch filler).  The
// maps are never staged: on entry every thread folds the map values of
// its window cells into a per-(entry, tile) minimum and maximum of the
// block-local target clamp(map - origin, 0, win - 1) (shared-memory
// atomicMin/atomicMax over the whole window, as the plain version reduces
// over all window axes).  Then, on every floating input window after the
// load and on every stage's region after the stage, one pass per axis in
// axis order copies the cell at `lo` into the cells below it and the cell
// at `hi` into the cells above it (blockops.streamed_halo_fixup), before
// the replicate rule.  A pass that changes no cell of the region is
// skipped with its barrier.  When [lo, hi] misses the tile on an axis (a
// tile past the request's real region: lo/hi clamp to the window edge),
// the output copies a cell the trapezoid never computes; such a block
// computes the whole window on that axis at every stage, and taps there
// may leave the window: they read the zero frame of SASA_FRAME cells that
// surrounds every window, as the plain version's zero padding.  Clamp maps
// are fixed points of both fixups, so `lo`/`hi` hold for every stage of
// every fused iteration.  Per-entry maps ride the same blockIdx.z * cells
// batch stride as the data, so K2 stays bitwise equal to K1 per entry.
// Wrap-index maps (bucketed periodic serving) are consumed between rounds
// by the host-side round loop and never reach this kernel.
//
// Bound on this card.  One round reads every input window and writes the
// tile once; keeping s iterations in shared memory divides the HBM traffic
// per iteration by s, at the cost of the trapezoid's redundant updates
// (for a T x T tile, sum_k (T + 2k r)^2 / (s T^2) per useful update).  At
// s = 1 the kernel is bound by HBM bytes.  The tensor copy moves a window
// with one instruction: no thread spends registers or instructions on its
// addresses, its alignment or its zero cells, and a row of any alignment
// moves at the copy engine's rate (row copies fall to 4 or 8 bytes where
// a window's rows start off a 16-byte boundary, as every HEAT3D edge
// block's and the 2-D s = 1 windows' do).  At depth the kernel is bound by
// the instructions it issues per cell update: shared loads, index
// arithmetic, the edge test and the arithmetic of the stage.  The strip
// walk keeps the first three to a fraction of a cell's taps (the stage's
// arithmetic stays; a division by a constant is a reciprocal with one
// correction, kernels/division.py); the ranker prices the updates of the
// regions above.
//
// Numerics: every value lives in shared memory as float; each stage
// computes in float with one rounding per operation (built with
// -fmad=false; a division is RN(x / d), by IEEE division or, for a
// constant d, a sequence bitwise equal to it) and rounds to the storage
// type where the stage writes.  Tensor cores do not apply: a banded
// matrix product in TF32, or any reordering of a stage's sums, would change the rounding,
// and the contract is one float32 rounding per operation, bitwise equal
// between K1 and K2 and across kernel revisions.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

#if SASA_STORE_BF16
typedef __nv_bfloat16 sasa_store_t;
#else
typedef float sasa_store_t;
#endif

#define SASA_NBUF (SASA_N_IN + SASA_N_LOCAL + 1)
#define SASA_THREADS 256

struct SasaGeom {
  int n[3];      // grid extent per axis (a padded leading axis has 1)
  int tile[3];   // interior tile extent per axis
  int ntile[3];  // tiles per axis
  int win[3];    // window extent per axis: tile + 2 * halo
  int halo[3];   // halo per axis: s * radius on real axes, 0 on padding
  int st[3];     // shared-memory strides of a framed window (st[2] == 1)
  int wcells;    // floats from one framed window to the next
  int s;         // fused iterations in this round
  int tma;       // 1 where the launch loads windows by tensor copies
  int lead;      // floats before a window's first cell in its buffer
  long long cells;  // cells of one grid (batch stride)
};

struct SasaPtrs {
  const sasa_store_t* in[SASA_N_IN];
  const int32_t* map[SASA_N_HALO > 0 ? SASA_N_HALO : 1];
  sasa_store_t* out;
};

// One tensor map per floating input, for the tensor copy (unset where the
// launch does not take it).
struct SasaMaps {
  CUtensorMap in[SASA_N_IN];
};

// The cells one stage updates: a box of window coordinates.
struct SasaBox {
  int lo[3];
  int ext[3];
};

__device__ __forceinline__ float sasa_load(const float* p) { return *p; }
__device__ __forceinline__ float sasa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void sasa_put(float* p, float v) { *p = v; }
__device__ __forceinline__ void sasa_put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Round a float to the storage type and back (a stage writes its dtype).
__device__ __forceinline__ float sasa_round(float v, float*) { return v; }
__device__ __forceinline__ float sasa_round(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// NaN-propagating max/min, as torch.maximum / jnp.maximum.
__device__ __forceinline__ float sasa_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float sasa_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// Tap at a constant offset from the cell at flat shared-memory index c.
// No bounds check: the trapezoid keeps every tap inside the window, or
// inside the zero frame (see the head comment).
template <int OZ, int OY, int OX>
__device__ __forceinline__ float sasa_tap(const float* b, int c,
                                          const SasaGeom& g) {
  return b[c + OZ * g.st[0] + OY * g.st[1] + OX];
}

// The cell at a constant offset from the cell at flat index c.
template <int OZ, int OY, int OX>
__device__ __forceinline__ const float* sasa_at(const float* b, int c,
                                                const SasaGeom& g) {
  return b + c + OZ * g.st[0] + OY * g.st[1] + OX;
}

// Loads the L cells of a column, w floats apart from p, into registers.
// No bounds check: the trapezoid keeps every tap inside the window, or
// inside the zero frame (see the head comment).
template <int L>
__device__ __forceinline__ void sasa_column(float (&t)[L], const float* p,
                                            int w) {
#pragma unroll
  for (int i = 0; i < L; ++i) t[i] = p[i * w];
}

// Flat shared-memory index of window cell (z, y, x).
__device__ __forceinline__ int sasa_cell(const SasaGeom& g, int z, int y,
                                         int x) {
  return (z + (SASA_NDIM == 3 ? SASA_FRAME : 0)) * g.st[0] +
         (y + (SASA_NDIM >= 2 ? SASA_FRAME : 0)) * g.st[1] + x + SASA_FRAME;
}

__device__ __forceinline__ int sasa_fold(int i, int n) {
  if ((unsigned)i < (unsigned)n) return i;
#if SASA_BOUNDARY == 3
  return ((i % n) + n) % n;
#else
  return i < 0 ? 0 : n - 1;
#endif
}

__device__ __forceinline__ bool sasa_in_grid(int gz, int gy, int gx,
                                             const SasaGeom& g) {
  return gz >= 0 && gz < g.n[0] && gy >= 0 && gy < g.n[1] && gx >= 0 &&
         gx < g.n[2];
}

__device__ __forceinline__ int sasa_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Calls f(z, y, x, c) for every cell of an ez x ey x ex box this thread
// owns, with c = c0 + z * st0 + y * st1 + x kept by increments.  The box
// is walked as one flat index over the block's threads, so a row narrower
// than a warp does not leave most of a warp idle.
template <typename F>
__device__ __forceinline__ void sasa_walk(int ez, int ey, int ex, int c0,
                                          int st0, int st1, F f) {
  const int total = ez * ey * ex;
  int i = threadIdx.x;
  if (i >= total) return;
  const int dx = SASA_THREADS % ex, dq = SASA_THREADS / ex;
  int x = i % ex;
  int q = i / ex;
  int y = q % ey;
  int z = q / ey;
  int c = c0 + z * st0 + y * st1 + x;
  const int dc = dq * st1 + dx, wrap_x = st1 - ex, wrap_y = st0 - ey * st1;
#pragma unroll 2
  for (; i < total; i += SASA_THREADS) {
    f(z, y, x, c);
    x += dx;
    y += dq;
    c += dc;
    if (x >= ex) {
      x -= ex;
      ++y;
      c += wrap_x;
    }
    // With fewer than 3 real axes ez == 1, and y passes ey only past the
    // end of the box.
    if (SASA_NDIM == 3) {
      while (y >= ey) {
        y -= ey;
        ++z;
        c += wrap_y;
      }
    }
  }
}

// Calls f(z, y, x) for every cell of an ez x ey x ex box this thread owns.
template <typename F>
__device__ __forceinline__ void sasa_for_box(int ez, int ey, int ex, F f) {
  sasa_walk(ez, ey, ex, 0, 0, 0, [&](int z, int y, int x, int) { f(z, y, x); });
}

// Calls f(z, y, x, c) for every cell of a box of window coordinates:
// window coordinates and flat shared-memory index.
template <typename F>
__device__ __forceinline__ void sasa_for_region(const SasaBox& b,
                                                const SasaGeom& g, F f) {
  sasa_walk(b.ext[0], b.ext[1], b.ext[2],
            sasa_cell(g, b.lo[0], b.lo[1], b.lo[2]), g.st[0], g.st[1],
            [&](int z, int y, int x, int c) {
              f(b.lo[0] + z, b.lo[1] + y, b.lo[2] + x, c);
            });
}

// Calls f(first, y, x, c) for every strip of a box this thread owns: the
// column at box coordinates (y, x) on the inner axes (y is 0 in 2-D) and
// the cells from `first` on along the walk axis (2-D: y, 3-D: z), the
// first at flat index c.  The (strip, column) pairs are walked as one
// flat index over the block's threads, x fastest, so adjacent lanes take
// adjacent columns.
template <typename F>
__device__ __forceinline__ void sasa_for_strips(const SasaBox& b,
                                                const SasaGeom& g, F f) {
  constexpr int W = 3 - SASA_NDIM;
  const int ex = b.ext[2], ey = SASA_NDIM == 3 ? b.ext[1] : 1;
  const int total = (b.ext[W] + SASA_STRIP - 1) / SASA_STRIP * ey * ex;
  int i = threadIdx.x;
  if (i >= total) return;
  const int c0 = sasa_cell(g, b.lo[0], b.lo[1], b.lo[2]);
  const int step = SASA_STRIP * g.st[W], st1 = g.st[1];
  const int dx = SASA_THREADS % ex, dq = SASA_THREADS / ex;
  int x = i % ex;
  const int q = i / ex;
  int y = q % ey;
  int k = q / ey;
#pragma unroll 1
  for (; i < total; i += SASA_THREADS) {
    f(k * SASA_STRIP, y, x, c0 + k * step + y * st1 + x);
    x += dx;
    int dy = dq;
    if (x >= ex) {
      x -= ex;
      ++dy;
    }
    if (SASA_NDIM == 3) {
      y += dy;
      while (y >= ey) {
        y -= ey;
        ++k;
      }
    } else {
      k += dy;
    }
  }
}

// The whole window as a box.
__device__ __forceinline__ SasaBox sasa_window(const SasaGeom& g) {
  SasaBox b;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    b.lo[d] = 0;
    b.ext[d] = g.win[d];
  }
  return b;
}

// The region of a stage with dilation e: the tile dilated by e on every
// real axis, or the whole window on an axis marked `full`.
__device__ __forceinline__ SasaBox sasa_region(const SasaGeom& g,
                                               const bool* full, int e) {
  SasaBox b;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int ed = d >= 3 - SASA_NDIM ? e : 0;
    b.lo[d] = full[d] ? 0 : g.halo[d] - ed;
    b.ext[d] = full[d] ? g.win[d] : g.tile[d] + 2 * ed;
  }
  return b;
}

// The spec's stages, generated from its expression trees.
template <int K>
__device__ float sasa_stage(const float* const* env, int c,
                            const SasaGeom& g);
template <int K>
struct sasa_strip;
#include "spec_body.cuh"

// Re-impose the boundary rule on the out-of-grid cells of a box of one
// stage output (blockops.boundary_fixup), in edge blocks.  zero/constant
// are written inline by the stage loop; replicate copies the clamped
// in-grid cell; periodic keeps its wrapped data.  Ends with a barrier.
__device__ __forceinline__ void sasa_replicate_fixup(float* dst,
                                                     const SasaBox& box,
                                                     const int* org,
                                                     const SasaGeom& g) {
  sasa_for_region(box, g, [&](int z, int y, int x, int c) {
    const int gz = org[0] + z, gy = org[1] + y, gx = org[2] + x;
    if (!sasa_in_grid(gz, gy, gx, g)) {
      const int tz = sasa_clamp(sasa_clamp(gz, 0, g.n[0] - 1) - org[0], 0,
                                g.win[0] - 1);
      const int ty = sasa_clamp(sasa_clamp(gy, 0, g.n[1] - 1) - org[1], 0,
                                g.win[1] - 1);
      const int tx = sasa_clamp(sasa_clamp(gx, 0, g.n[2] - 1) - org[2], 0,
                                g.win[2] - 1);
      dst[c] = dst[sasa_cell(g, tz, ty, tx)];
    }
  });
  __syncthreads();
}

// One axis pass of the streamed belt over a box of `nb` windows starting
// at `dst` (`stride` floats apart): cells below lo[ax] copy the cell at
// lo[ax] on that axis, cells above hi[ax] the cell at hi[ax].  The cells
// read are never written in the same pass.  A pass that would change no
// cell of the box is skipped with its barrier (the test is block-uniform).
template <int AX>
__device__ __forceinline__ void sasa_streamed_axis(float* dst, int nb,
                                                   int stride,
                                                   const SasaBox& box,
                                                   const int* lo,
                                                   const int* hi,
                                                   const SasaGeom& g) {
  const int l = lo[AX], h = hi[AX];
  if (l <= box.lo[AX] && h >= box.lo[AX] + box.ext[AX] - 1) return;
  sasa_for_region(box, g, [&](int z, int y, int x, int c) {
    const int w = AX == 0 ? z : (AX == 1 ? y : x);
    if (w >= l && w <= h) return;
    const int t = w < l ? l : h;
    const int src = c + (t - w) * g.st[AX];
    for (int i = 0; i < nb; ++i) dst[i * stride + c] = dst[i * stride + src];
  });
  __syncthreads();
}

// The streamed belt on every real axis, in axis order (a no-op without
// halo-index maps).
__device__ __forceinline__ void sasa_streamed_fixup(float* dst, int nb,
                                                    int stride,
                                                    const SasaBox& box,
                                                    const int* lo,
                                                    const int* hi,
                                                    const SasaGeom& g) {
#if SASA_N_HALO > 0
  if (SASA_N_HALO >= 3) sasa_streamed_axis<0>(dst, nb, stride, box, lo, hi, g);
  if (SASA_N_HALO >= 2) sasa_streamed_axis<1>(dst, nb, stride, box, lo, hi, g);
  sasa_streamed_axis<2>(dst, nb, stride, box, lo, hi, g);
#endif
}

// One stage over its region into dst, then its boundary rule: the
// streamed belt first (bucket specs), then, in edge blocks, the
// bucket-level rule.  zero/constant write the boundary value on
// out-of-grid cells directly (the reference computes them and then
// masks: the same result).
template <int K, bool INTERIOR>
__device__ __forceinline__ void sasa_run_stage(float* dst,
                                               const float* const* env,
                                               const SasaBox& box,
                                               const int* org,
                                               const SasaGeom& g,
                                               const int* lo,
                                               const int* hi) {
#if SASA_NDIM == 1
  sasa_for_region(box, g, [&](int z, int y, int x, int c) {
    float v;
    if (!INTERIOR && SASA_BOUNDARY <= 1 &&
        !sasa_in_grid(org[0] + z, org[1] + y, org[2] + x, g)) {
      v = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
    } else {
      v = sasa_round(sasa_stage<K>(env, c, g), (sasa_store_t*)nullptr);
    }
    dst[c] = v;
  });
#else
  // The strip walk (see "Stage walk").  A whole strip runs sasa_strip,
  // its tap columns in registers; the short strip at the region's end
  // runs its cells one by one.
  constexpr int W = 3 - SASA_NDIM;
  const int w = g.st[W], ext = box.ext[W];
  sasa_for_strips(box, g, [&](int first, int y, int x, int c) {
    // Zero/constant edge blocks: the column's inner coordinates in the
    // grid, and the strip's cells [rlo, rhi) inside it on the walk axis.
    bool col_in = true;
    int rlo = 0, rhi = SASA_STRIP;
    if (!INTERIOR && SASA_BOUNDARY <= 1) {
      const int gx = org[2] + box.lo[2] + x;
      col_in = gx >= 0 && gx < g.n[2];
      if (SASA_NDIM == 3) {
        const int gy = org[1] + box.lo[1] + y;
        col_in = col_in && gy >= 0 && gy < g.n[1];
      }
      const int gw = org[W] + box.lo[W] + first;
      rlo = -gw;
      rhi = g.n[W] - gw;
    }
    const float bval = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
    if (ext - first >= SASA_STRIP) {
      float v[SASA_STRIP];
      sasa_strip<K>::run(env, c, w, g, v);
      if (col_in && rlo <= 0 && rhi >= SASA_STRIP) {
#pragma unroll
        for (int r = 0; r < SASA_STRIP; ++r)
          dst[c + r * w] = sasa_round(v[r], (sasa_store_t*)nullptr);
      } else {
#pragma unroll
        for (int r = 0; r < SASA_STRIP; ++r)
          dst[c + r * w] = (col_in && r >= rlo && r < rhi)
                               ? sasa_round(v[r], (sasa_store_t*)nullptr)
                               : bval;
      }
    } else {
#pragma unroll 1
      for (int r = 0; r < ext - first; ++r) {
        const int cr = c + r * w;
        dst[cr] = (col_in && r >= rlo && r < rhi)
                      ? sasa_round(sasa_stage<K>(env, cr, g),
                                   (sasa_store_t*)nullptr)
                      : bval;
      }
    }
  });
#endif
  __syncthreads();
  sasa_streamed_fixup(dst, 1, 0, box, lo, hi, g);
  if (!INTERIOR && SASA_BOUNDARY == 2) sasa_replicate_fixup(dst, box, org, g);
}

// cp.async copies into shared memory (the plain copy is the host pass's
// reading of the same code; the kernel is only ever built for sm_90a).
__device__ __forceinline__ void sasa_cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void sasa_cp_async16(float* dst,
                                                const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}
__device__ __forceinline__ void sasa_cp_async8(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  for (int i = 0; i < 2; ++i) dst[i] = src[i];
#endif
}
__device__ __forceinline__ void sasa_cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

#if !SASA_STORE_BF16
// Copies V floats with one cp.async (16, 8 or 4 bytes).
template <int V>
__device__ __forceinline__ void sasa_cp_async(float* dst, const float* src) {
  if (V == 4)
    sasa_cp_async16(dst, src);
  else if (V == 2)
    sasa_cp_async8(dst, src);
  else
    sasa_cp_async4(dst, src);
}

// Copies the box `in` of window coordinates of every input window, whose
// first cell is grid cell `first`, row by row with cp.async, V floats a
// copy.  Offsets from `first` fit in 32 bits (checked by the launch).
template <int V>
__device__ __forceinline__ void sasa_copy_box(const SasaPtrs& p,
                                              const SasaGeom& g,
                                              float* const* buf,
                                              const SasaBox& in,
                                              long long first) {
  const int plane = g.n[1] * g.n[2];
  sasa_for_box(in.ext[0], in.ext[1], in.ext[2] / V, [&](int z, int y, int q) {
    const int src = z * plane + y * g.n[2] + V * q;
    const int c = sasa_cell(g, in.lo[0] + z, in.lo[1] + y, in.lo[2] + V * q);
#pragma unroll
    for (int i = 0; i < SASA_N_IN; ++i)
      sasa_cp_async<V>(buf[i] + c, p.in[i] + first + src);
  });
}

// Copies the box `in` of every input window as sasa_copy_box does, with
// the widest copy every row's alignment allows.  Issues the copies only:
// the caller waits for them.
__device__ __forceinline__ void sasa_copy_rows(const SasaPtrs& p,
                                               const SasaGeom& g,
                                               float* const* buf,
                                               const SasaBox& in,
                                               long long first) {
  // Every row's first cell is aligned when the first row's is and the row
  // strides (grid and shared) keep the alignment; all windows share their
  // alignment (buffers lie a multiple of 128 bytes apart).
  const uintptr_t s0 =
      (uintptr_t)(buf[0] + sasa_cell(g, in.lo[0], in.lo[1], in.lo[2]));
  bool a16 = g.n[2] % 4 == 0 && in.ext[2] % 4 == 0 && g.st[1] % 4 == 0 &&
             (s0 & 15) == 0;
  bool a8 = g.n[2] % 2 == 0 && in.ext[2] % 2 == 0 && g.st[1] % 2 == 0 &&
            (s0 & 7) == 0;
#pragma unroll
  for (int i = 0; i < SASA_N_IN; ++i) {
    a16 = a16 && ((uintptr_t)(p.in[i] + first) & 15) == 0;
    a8 = a8 && ((uintptr_t)(p.in[i] + first) & 7) == 0;
  }
  if (a16)
    sasa_copy_box<4>(p, g, buf, in, first);
  else if (a8)
    sasa_copy_box<2>(p, g, buf, in, first);
  else
    sasa_copy_box<1>(p, g, buf, in, first);
}
#endif

#if !SASA_STORE_BF16 && SASA_N_HALO == 0
// Calls f(z, y, x, c) for every window cell outside the box `in`: per real
// axis the slabs below and above it, spanning `in` on the axes before and
// the whole window on the axes after.
template <typename F>
__device__ __forceinline__ void sasa_for_outside(const SasaBox& in,
                                                 const SasaGeom& g, F f) {
#pragma unroll
  for (int d = 3 - SASA_NDIM; d < 3; ++d) {
#pragma unroll
    for (int above = 0; above < 2; ++above) {
      SasaBox b;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b.lo[a] = a < d ? in.lo[a] : 0;
        b.ext[a] = a < d ? in.ext[a] : g.win[a];
      }
      b.lo[d] = above ? in.lo[d] + in.ext[d] : 0;
      b.ext[d] = above ? g.win[d] - b.lo[d] : in.lo[d];
      sasa_for_region(b, g, f);
    }
  }
}

// The window's in-grid box, in window coordinates.
__device__ __forceinline__ SasaBox sasa_in_box(const SasaGeom& g,
                                               const int* org) {
  SasaBox in;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    in.lo[d] = org[d] < 0 ? -org[d] : 0;
    const int end = g.n[d] - org[d];
    in.ext[d] = (end < g.win[d] ? end : g.win[d]) - in.lo[d];
  }
  return in;
}

// Gives every window cell outside the in-grid box `in` the boundary rule:
// zero/constant the boundary value, replicate the clamped in-grid cell
// (whose copy has landed).  Not for the periodic rule.
__device__ __forceinline__ void sasa_fill_outside(const SasaBox& in,
                                                  const SasaGeom& g,
                                                  float* const* buf) {
  sasa_for_outside(in, g, [&](int z, int y, int x, int c) {
    if (SASA_BOUNDARY <= 1) {
#pragma unroll
      for (int i = 0; i < SASA_N_IN; ++i)
        buf[i][c] = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
    } else {
      const int t = sasa_cell(
          g, sasa_clamp(z, in.lo[0], in.lo[0] + in.ext[0] - 1),
          sasa_clamp(y, in.lo[1], in.lo[1] + in.ext[1] - 1),
          sasa_clamp(x, in.lo[2], in.lo[2] + in.ext[2] - 1));
#pragma unroll
      for (int i = 0; i < SASA_N_IN; ++i) buf[i][c] = buf[i][t];
    }
  });
}

// Load every input window by row copies: the window's in-grid box (the
// whole window in an interior block), then the boundary rule on the cells
// outside it.  Equal, cell for cell, to the per-cell load with the rule
// folded into the index.
__device__ __forceinline__ void sasa_load_box(const SasaPtrs& p,
                                              const SasaGeom& g,
                                              float* const* buf,
                                              const int* org,
                                              long long base) {
  const SasaBox in = sasa_in_box(g, org);
  const long long first =
      base + ((long long)(org[0] + in.lo[0]) * g.n[1] + org[1] + in.lo[1]) *
                 g.n[2] + org[2] + in.lo[2];
  sasa_copy_rows(p, g, buf, in, first);
#if SASA_BOUNDARY <= 1
  sasa_fill_outside(in, g, buf);
  sasa_cp_async_wait_all();
#elif SASA_BOUNDARY == 2
  // The clamped cell lies in `in`: wait for its copy.
  sasa_cp_async_wait_all();
  __syncthreads();
  sasa_fill_outside(in, g, buf);
#else
  sasa_for_outside(in, g, [&](int z, int y, int x, int c) {
    const long long src =
        ((long long)sasa_fold(org[0] + z, g.n[0]) * g.n[1] +
         sasa_fold(org[1] + y, g.n[1])) * g.n[2] +
        sasa_fold(org[2] + x, g.n[2]);
#pragma unroll
    for (int i = 0; i < SASA_N_IN; ++i)
      sasa_cp_async4(buf[i] + c, p.in[i] + base + src);
  });
  sasa_cp_async_wait_all();
#endif
}

// Load every input window by one tensor copy each (sm_90): thread 0 arms
// the mbarrier `bar` with the boxes' bytes and issues the copies in batch
// entry blockIdx.z; every thread waits for the barrier's first phase.
// The copy starts a box on a 16-byte unit of the grid's row only, so the
// box starts g.lead cells before the window, at the 128-byte aligned
// start of the window's buffer, and spans a row at the pitch (st[1]).
// The last win[2] + lead - st[1] cells of each window row (at most 3) lie
// past the box, where the next row's (the next buffer's) first lead
// cells, which hold no window cell, share their shared memory; the last
// buffer's last row, whose tail would pass the allocation, is never read
// or written (see `bar` in sasa_tile_body).  Once the copy has landed, a
// tail's grid cell is copied by cp.async and a cell outside the grid
// takes the zero/constant value.  Cells outside the grid arrive as zeros;
// in an edge block, constant and replicate then impose their rule on
// them.
template <bool INTERIOR>
__device__ __forceinline__ void sasa_load_tma(const SasaPtrs& p,
                                              const SasaMaps& tm,
                                              const SasaGeom& g,
                                              float* const* buf,
                                              uint64_t* bar, const int* org,
                                              long long base) {
#ifdef __CUDA_ARCH__
  const unsigned mb = (unsigned)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // A box is win[0] x win[1] rows at the pitch: st[0] * win[0] cells.
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
        "r"(SASA_N_IN * g.st[0] * g.win[0] * (int)sizeof(float))
        : "memory");
#pragma unroll
    for (int i = 0; i < SASA_N_IN; ++i)
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
          ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
          ::"r"((unsigned)__cvta_generic_to_shared(buf[i] - g.lead)),
          "l"(reinterpret_cast<uint64_t>(&tm.in[i])), "r"(org[2] - g.lead),
          "r"(org[1]), "r"(org[0]), "r"((int)blockIdx.z), "r"(mb)
          : "memory");
  }
  // No thread polls the barrier before thread 0 has set it up.
  __syncthreads();
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb)
        : "memory");
#endif
  // The row tails, once the copy has written the cells they share.
  const int tail = g.win[2] + g.lead - g.st[1];
  if (tail > 0) {
    sasa_for_box(g.win[0], g.win[1], tail, [&](int z, int y, int q) {
      const int x = g.win[2] - tail + q;
      const int gz = org[0] + z, gy = org[1] + y, gx = org[2] + x;
      const int c = sasa_cell(g, z, y, x);
      if (INTERIOR || sasa_in_grid(gz, gy, gx, g)) {
        const long long src = base + ((long long)gz * g.n[1] + gy) * g.n[2] + gx;
#pragma unroll
        for (int i = 0; i < SASA_N_IN; ++i)
          sasa_cp_async4(buf[i] + c, p.in[i] + src);
      } else if (SASA_BOUNDARY <= 1) {
#pragma unroll
        for (int i = 0; i < SASA_N_IN; ++i)
          buf[i][c] = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
      }
    });
    sasa_cp_async_wait_all();
  }
#if SASA_BOUNDARY == 1
  if (!INTERIOR) sasa_fill_outside(sasa_in_box(g, org), g, buf);
#elif SASA_BOUNDARY == 2
  // The clamped cell may be a row tail another thread copied.
  if (!INTERIOR) {
    __syncthreads();
    sasa_fill_outside(sasa_in_box(g, org), g, buf);
  }
#endif
}
#endif

// Load every input window (see "Boundary rule"): by tensor copies where
// the launch takes them (periodic edge blocks excepted), else by row
// copies of the in-grid box (sasa_load_box) for float32 specs without
// halo-index maps; interior blocks of other float32 specs copy rows too;
// other blocks fold the boundary rule into the index of every cell.
template <bool INTERIOR>
__device__ __forceinline__ void sasa_load_windows(const SasaPtrs& p,
                                                  const SasaGeom& g,
                                                  const SasaMaps& tm,
                                                  float* const* buf,
                                                  uint64_t* bar,
                                                  const int* org,
                                                  long long base) {
#if !SASA_STORE_BF16 && SASA_N_HALO == 0
  if (g.tma && (INTERIOR || SASA_BOUNDARY != 3))
    sasa_load_tma<INTERIOR>(p, tm, g, buf, bar, org, base);
  else
    sasa_load_box(p, g, buf, org, base);
#else
#if !SASA_STORE_BF16
  if (INTERIOR) {
    // Offsets relative to the window's first cell fit in 32 bits (checked
    // by the launch).
    sasa_copy_rows(p, g, buf, sasa_window(g),
                   base + ((long long)org[0] * g.n[1] + org[1]) * g.n[2] +
                       org[2]);
    sasa_cp_async_wait_all();
    return;
  }
#endif
  sasa_for_region(sasa_window(g), g, [&](int z, int y, int x, int c) {
    const int gz = org[0] + z, gy = org[1] + y, gx = org[2] + x;
    const bool in = INTERIOR || sasa_in_grid(gz, gy, gx, g);
    const long long src =
        ((long long)sasa_fold(gz, g.n[0]) * g.n[1] + sasa_fold(gy, g.n[1])) *
            g.n[2] + sasa_fold(gx, g.n[2]);
#pragma unroll
    for (int i = 0; i < SASA_N_IN; ++i) {
      float v = sasa_load(p.in[i] + base + src);
      if (SASA_BOUNDARY <= 1 && !in)
        v = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
      buf[i][c] = v;
    }
  });
#endif
}

template <bool INTERIOR>
__device__ __forceinline__ void sasa_tile_body(const SasaPtrs& p,
                                               const SasaGeom& g,
                                               const SasaMaps& tm,
                                               float* smem, const int* tc,
                                               const int* org,
                                               long long base) {
  float* buf[SASA_NBUF];
#pragma unroll
  for (int i = 0; i < SASA_NBUF; ++i) buf[i] = smem + i * g.wcells + g.lead;
  // The tensor copy's mbarrier: 16 bytes into the last buffer, inside the
  // first row (outermost coordinate 0) of the window that iterations
  // write, which no stage reads or writes: in 2-D and 3-D with a radius
  // r >= 1 every stage's region, and the taps that read it, start r cells
  // into the window (the row tails of the buffer before it reach 12 bytes
  // in at most; see sasa_load_tma).
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem + (SASA_NBUF - 1) * g.wcells + 4);
  // After the windows: the per-(entry, tile) belt bounds per kernel axis.
  int* lo = reinterpret_cast<int*>(smem + SASA_NBUF * g.wcells);
  int* hi = lo + 3;
  bool full[3] = {false, false, false};
#if SASA_FRAME > 0
  // The zero frame (and, harmlessly, every window) starts at 0.
  for (int i = threadIdx.x; i < SASA_NBUF * g.wcells; i += SASA_THREADS)
    smem[i] = 0.0f;
#endif
#if SASA_N_HALO > 0
  if (threadIdx.x == 0) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = INT_MAX;
      hi[d] = INT_MIN;
    }
  }
#endif
#if SASA_FRAME > 0 || SASA_N_HALO > 0
  __syncthreads();
#endif

  sasa_load_windows<INTERIOR>(p, g, tm, buf, bar, org, base);
#if SASA_N_HALO > 0
  // Belt bounds: min and max over the whole window of each map's
  // block-local target (the maps as loaded, with the same fold).
  {
    int tlo[SASA_N_HALO], thi[SASA_N_HALO];
    for (int k = 0; k < SASA_N_HALO; ++k) {
      tlo[k] = INT_MAX;
      thi[k] = INT_MIN;
    }
    sasa_for_region(sasa_window(g), g, [&](int z, int y, int x, int) {
      const int gz = org[0] + z, gy = org[1] + y, gx = org[2] + x;
      const long long src =
          ((long long)sasa_fold(gz, g.n[0]) * g.n[1] + sasa_fold(gy, g.n[1])) *
              g.n[2] + sasa_fold(gx, g.n[2]);
      for (int k = 0; k < SASA_N_HALO; ++k) {
        const int ax = 3 - SASA_N_HALO + k;
        const int t =
            sasa_clamp(p.map[k][base + src] - org[ax], 0, g.win[ax] - 1);
        tlo[k] = t < tlo[k] ? t : tlo[k];
        thi[k] = t > thi[k] ? t : thi[k];
      }
    });
    for (int k = 0; k < SASA_N_HALO; ++k) {
      const int ax = 3 - SASA_N_HALO + k;
      if (tlo[k] != INT_MAX) {
        atomicMin(&lo[ax], tlo[k]);
        atomicMax(&hi[ax], thi[k]);
      }
    }
  }
#endif
  __syncthreads();
#if SASA_N_HALO > 0
  // An axis whose [lo, hi] misses the tile: the output copies a cell
  // outside the trapezoid, so every stage computes the whole window there.
#pragma unroll
  for (int d = 3 - SASA_N_HALO; d < 3; ++d)
    full[d] = lo[d] > g.halo[d] + g.tile[d] - 1 || hi[d] < g.halo[d];
  // Streamed belt on every input window, then (edge blocks, replicate) the
  // bucket rule, as the plain version re-imposes both on entry.
  sasa_streamed_fixup(buf[0], SASA_N_IN, g.wcells, sasa_window(g), lo, hi, g);
  if (!INTERIOR && SASA_BOUNDARY == 2) {
    for (int i = 0; i < SASA_N_IN; ++i)
      sasa_for_region(sasa_window(g), g, [&](int z, int y, int x, int c) {
        const int gz = org[0] + z, gy = org[1] + y, gx = org[2] + x;
        if (!sasa_in_grid(gz, gy, gx, g)) {
          const int tz = sasa_clamp(sasa_clamp(gz, 0, g.n[0] - 1) - org[0],
                                    0, g.win[0] - 1);
          const int ty = sasa_clamp(sasa_clamp(gy, 0, g.n[1] - 1) - org[1],
                                    0, g.win[1] - 1);
          const int tx = sasa_clamp(sasa_clamp(gx, 0, g.n[2] - 1) - org[2],
                                    0, g.win[2] - 1);
          buf[i][c] = buf[i][sasa_cell(g, tz, ty, tx)];
        }
      });
    __syncthreads();
  }
#endif

  float* cur = buf[SASA_ITER];
  float* nxt = buf[SASA_NBUF - 1];
  for (int it = 0; it < g.s; ++it) {
    const float* env[SASA_NBUF];
#pragma unroll
    for (int i = 0; i < SASA_NBUF; ++i) env[i] = buf[i];
    env[SASA_ITER] = cur;
    env[SASA_NBUF - 1] = nxt;
    const int e_it = (g.s - 1 - it) * SASA_RADIUS;
#define SASA_STAGE(K, TAIL, DST)                                        \
  sasa_run_stage<K, INTERIOR>(DST, env, sasa_region(g, full, e_it + (TAIL)), \
                              org, g, lo, hi);
    SASA_STAGE_CALLS
#undef SASA_STAGE
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // Write the tile (the last stage's region).
  sasa_for_box(g.tile[0], g.tile[1], g.tile[2], [&](int z, int y, int x) {
    const int gz = tc[0] * g.tile[0] + z;
    const int gy = tc[1] * g.tile[1] + y;
    const int gx = tc[2] * g.tile[2] + x;
    if (INTERIOR || (gz < g.n[0] && gy < g.n[1] && gx < g.n[2])) {
      const int c = sasa_cell(g, z + g.halo[0], y + g.halo[1], x + g.halo[2]);
      sasa_put(p.out + base + ((long long)gz * g.n[1] + gy) * g.n[2] + gx,
               cur[c]);
    }
  });
}

__global__ void __launch_bounds__(SASA_THREADS)
sasa_tile_kernel(SasaPtrs p, SasaGeom g, const __grid_constant__ SasaMaps tm) {
  // 128-byte aligned: a tensor copy's destination.
  extern __shared__ __align__(128) float sasa_smem[];
  int t = blockIdx.x;
  int tc[3];
  tc[2] = t % g.ntile[2]; t /= g.ntile[2];
  tc[1] = t % g.ntile[1]; t /= g.ntile[1];
  tc[0] = t;
  int org[3];
  bool interior = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    org[d] = tc[d] * g.tile[d] - g.halo[d];
    interior = interior && org[d] >= 0 && org[d] + g.win[d] <= g.n[d];
  }
  const long long base = (long long)blockIdx.z * g.cells;
  if (interior)
    sasa_tile_body<true>(p, g, tm, sasa_smem, tc, org, base);
  else
    sasa_tile_body<false>(p, g, tm, sasa_smem, tc, org, base);
}

#if !SASA_STORE_BF16 && SASA_N_HALO == 0
// cuTensorMapEncodeTiled, asked of the driver through the runtime, so the
// library links nothing beyond the runtime; null where the driver lacks it.
typedef CUresult (*SasaEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static SasaEncodeTiled sasa_encode_tiled() {
  static SasaEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<SasaEncodeTiled>(f);
  }
  return fn;
}

// The tensor map of each floating input: the batch of grids as a 4-D
// float32 tensor (x, y, z, batch), a box of the window with its rows at
// the pitch, cells outside the tensor read as zeros.  Returns false where
// the driver refuses one.
static bool sasa_encode_maps(SasaMaps& tm, const unsigned long long* ins,
                             const SasaGeom& g, int B) {
  const SasaEncodeTiled encode = sasa_encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g.n[2], (cuuint64_t)g.n[1],
                              (cuuint64_t)g.n[0], (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)g.n[2] * sizeof(float),
                                 (cuuint64_t)g.n[1] * g.n[2] * sizeof(float),
                                 (cuuint64_t)g.cells * sizeof(float)};
  const cuuint32_t box[4] = {(cuuint32_t)g.st[1], (cuuint32_t)g.win[1],
                             (cuuint32_t)g.win[0], 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < SASA_N_IN; ++i)
    if (encode(&tm.in[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
               reinterpret_cast<void*>(ins[i]), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  return true;
}
#endif

// Plain C entry point, bound with ctypes.
//   ins   host array of SASA_N_IN device pointers (floating inputs)
//   maps  host array of SASA_N_HALO device pointers (int32 halo-index
//         maps, (B,) + grid each, in axis order); ignored when 0
//   out   device pointer of the output, (B,) + grid
//   geom  host array of 13 ints: B, n0, n1, n2, t0, t1, t2, h0, h1, h2, s,
//         dynamic shared-memory bytes, 1 to load windows by tensor copies
//         (a 2-D or 3-D float32 spec without halo-index maps, radius >= 1,
//         n2 % 4 == 0, t2 % 4 == 0 or one tile on x, every box axis at
//         most 256 cells, inputs 16-byte aligned) else 0
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue where a tensor map cannot be encoded.
extern "C" int sasa_launch(const unsigned long long* ins,
                           const unsigned long long* maps, void* out,
                           const int* geom, void* stream) {
  SasaPtrs p;
  for (int i = 0; i < SASA_N_IN; ++i)
    p.in[i] = reinterpret_cast<const sasa_store_t*>(ins[i]);
  p.map[0] = nullptr;
  for (int k = 0; k < SASA_N_HALO; ++k)
    p.map[k] = reinterpret_cast<const int32_t*>(maps[k]);
  p.out = reinterpret_cast<sasa_store_t*>(out);
  SasaGeom g;
  const int B = geom[0];
  long long cells = 1;
  long long tiles = 1;
  int framed[3];
  for (int d = 0; d < 3; ++d) {
    g.n[d] = geom[1 + d];
    g.tile[d] = geom[4 + d];
    g.halo[d] = geom[7 + d];
    g.ntile[d] = (g.n[d] + g.tile[d] - 1) / g.tile[d];
    g.win[d] = g.tile[d] + 2 * g.halo[d];
    framed[d] = g.win[d] + (d >= 3 - SASA_NDIM ? 2 * SASA_FRAME : 0);
    cells *= g.n[d];
    tiles *= g.ntile[d];
  }
  // Without a frame a row is a whole number of 16-byte units (a tensor
  // copy's box row), and every window starts on a 128-byte boundary
  // (kernels/tiling.py::round_plan lays out the same).
  g.st[2] = 1;
  g.st[1] = SASA_FRAME == 0 ? (framed[2] + 3) / 4 * 4 : framed[2];
  g.st[0] = framed[1] * g.st[1];
  g.wcells = (framed[0] * g.st[0] + 31) / 32 * 32;
  g.s = geom[10];
  g.cells = cells;
  g.tma = geom[12];
  // A launch that takes the tensor copy starts every box on a 16-byte unit
  // of the grid's row: lead cells before the window, whose origin on x is
  // -halo[2] modulo 4 in every block (the launch's tiles span a multiple
  // of 4 cells on x, or the whole row).
  g.lead = g.tma ? (4 - g.halo[2] % 4) % 4 : 0;
  const int smem = geom[11];
  SasaMaps tm{};
#if !SASA_STORE_BF16 && SASA_N_HALO == 0
  if (g.tma && !sasa_encode_maps(tm, ins, g, B))
    return (int)cudaErrorInvalidValue;
#else
  if (g.tma) return (int)cudaErrorInvalidValue;
#endif
  cudaError_t err = cudaFuncSetAttribute(
      sasa_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(SASA_THREADS, 1, 1);
  dim3 grid((unsigned)tiles, 1, (unsigned)B);
  sasa_tile_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(p, g, tm);
  return (int)cudaGetLastError();
}
