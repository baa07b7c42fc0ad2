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
//   SASA_BOUNDARY    0 zero, 1 constant, 2 replicate, 3 periodic
//   SASA_BVALUE      the constant boundary value (float literal)
//   SASA_STORE_BF16  1 when every array is bfloat16, else 0 (float32)
// and "spec_body.cuh", included below, holds the spec's expressions:
//   sasa_stage<k>    one __device__ specialisation per stage (locals, then
//                    output), reading taps through sasa_tap
//   SASA_STAGE_CALLS the statements running every stage of one iteration,
//                    sasa_run_stage<k>(destination, env, org, g, lo, hi)
//                    for each k
//
// Geometry.  Every axis is tiled (the TPU block kept whole columns
// resident; a 4096-column f32 row is 16 KB and the window needs several
// arrays, which 227 KB of shared memory cannot hold).  A block owns an
// interior tile plus a halo of h = s * radius cells on every side of every
// real axis.  The grid is handled as 3-D: a 2-D spec is (1, R, C).  The
// window of every input is loaded once with the boundary rule folded into
// the index arithmetic (zero/constant: a select, replicate: clamp,
// periodic: wrap), then s fused iterations run in shared memory and the
// interior is written back.  Cells within h of the window edge go stale
// (taps outside the window read 0), which is the trapezoid argument of
// src/repro/kernels/blockops.py, applied to every axis as the reference
// applies it to rows.
//
// Bound on this card: HBM bytes.  One round reads every input window
// (tile + 2h per axis) and writes the tile once; the design keeps all s
// iterations of a round in shared memory, so HBM traffic per iteration
// falls by ~s at the cost of recomputing the halo trapezoid.
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
// load and on every stage output after the stage, one pass per axis in
// axis order, with a barrier between axes, copies the cell at `lo` into
// the cells below it and the cell at `hi` into the cells above it
// (blockops.streamed_halo_fixup), before the replicate rule.  Clamp maps
// are fixed points of both fixups, so `lo`/`hi` hold for every stage of
// every fused iteration.  Per-entry maps ride the same blockIdx.z * cells
// batch stride as the data, so K2 stays bitwise equal to K1 per entry.
// Wrap-index maps (bucketed periodic serving) are consumed between rounds
// by the host-side round loop and never reach this kernel.
//
// Numerics: every value lives in shared memory as float; each stage
// computes in float with one rounding per operation (built with
// -fmad=false and IEEE division) and rounds to the storage type where the
// stage writes.

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
#define SASA_THREADS_X 32
#define SASA_THREADS_Y 8

struct SasaGeom {
  int n[3];      // grid extent per axis (a padded leading axis has 1)
  int tile[3];   // interior tile extent per axis
  int ntile[3];  // tiles per axis
  int win[3];    // window extent per axis: tile + 2 * halo
  int halo[3];   // halo per axis: s * radius on real axes, 0 on padding
  int s;         // fused iterations in this round
  long long cells;  // cells of one grid (batch stride)
};

struct SasaPtrs {
  const sasa_store_t* in[SASA_N_IN];
  const int32_t* map[SASA_N_HALO > 0 ? SASA_N_HALO : 1];
  sasa_store_t* out;
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

// Tap at a constant offset from window cell (z, y, x); 0 outside the
// window (the block-edge zero padding of blockops._block_stage).
template <int OZ, int OY, int OX>
__device__ __forceinline__ float sasa_tap(const float* b, int z, int y, int x,
                                          const SasaGeom& g) {
  const int qz = z + OZ, qy = y + OY, qx = x + OX;
  if (qz < 0 || qz >= g.win[0] || qy < 0 || qy >= g.win[1] || qx < 0 ||
      qx >= g.win[2])
    return 0.0f;
  return b[(qz * g.win[1] + qy) * g.win[2] + qx];
}

__device__ __forceinline__ int sasa_fold(int i, int n) {
#if SASA_BOUNDARY == 3
  return ((i % n) + n) % n;
#else
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
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

// Calls f(z, y, x, c, gz, gy, gx) for every window cell this thread owns:
// window coordinates, flat window index and grid coordinates.
template <typename F>
__device__ __forceinline__ void sasa_for_window(const SasaGeom& g,
                                                const int* org, F f) {
  for (int z = 0; z < g.win[0]; ++z)
    for (int y = threadIdx.y; y < g.win[1]; y += SASA_THREADS_Y)
      for (int x = threadIdx.x; x < g.win[2]; x += SASA_THREADS_X)
        f(z, y, x, (z * g.win[1] + y) * g.win[2] + x, org[0] + z,
          org[1] + y, org[2] + x);
}

// The spec's stages, generated from its expression trees.
template <int K>
__device__ float sasa_stage(const float* const* env, int z, int y, int x,
                            const SasaGeom& g);
#include "spec_body.cuh"

// Re-impose the boundary rule on the out-of-grid cells of one stage
// output (blockops.boundary_fixup).  zero/constant are written inline by
// the stage loop; replicate copies the clamped in-grid cell, which the
// window always holds because tiles start inside the grid; periodic keeps
// its wrapped data.
__device__ __forceinline__ void sasa_replicate_fixup(float* dst,
                                                     const int* org,
                                                     const SasaGeom& g) {
  sasa_for_window(g, org, [&](int, int, int, int c, int gz, int gy, int gx) {
    if (!sasa_in_grid(gz, gy, gx, g)) {
      const int tz = sasa_clamp(sasa_clamp(gz, 0, g.n[0] - 1) - org[0], 0,
                                g.win[0] - 1);
      const int ty = sasa_clamp(sasa_clamp(gy, 0, g.n[1] - 1) - org[1], 0,
                                g.win[1] - 1);
      const int tx = sasa_clamp(sasa_clamp(gx, 0, g.n[2] - 1) - org[2], 0,
                                g.win[2] - 1);
      dst[c] = dst[(tz * g.win[1] + ty) * g.win[2] + tx];
    }
  });
}

// One axis pass of the streamed belt over `nb` windows starting at `dst`
// (`stride` floats apart): window cells below lo[ax] copy the cell at
// lo[ax] on that axis, cells above hi[ax] the cell at hi[ax].  The cells
// read are never written in the same pass.  Ends with a barrier.
template <int AX>
__device__ __forceinline__ void sasa_streamed_axis(float* dst, int nb,
                                                   int stride, const int* lo,
                                                   const int* hi,
                                                   const int* org,
                                                   const SasaGeom& g) {
  const int l = lo[AX], h = hi[AX];
  sasa_for_window(g, org, [&](int z, int y, int x, int c, int, int, int) {
    const int w = AX == 0 ? z : (AX == 1 ? y : x);
    if (w >= l && w <= h) return;
    const int t = w < l ? l : h;
    const int src = AX == 0 ? (t * g.win[1] + y) * g.win[2] + x
                  : AX == 1 ? (z * g.win[1] + t) * g.win[2] + x
                            : (z * g.win[1] + y) * g.win[2] + t;
    for (int i = 0; i < nb; ++i) dst[i * stride + c] = dst[i * stride + src];
  });
  __syncthreads();
}

// The streamed belt on every real axis, in axis order (a no-op without
// halo-index maps).  Each axis pass ends with a barrier.
__device__ __forceinline__ void sasa_streamed_fixup(float* dst, int nb,
                                                    int stride,
                                                    const int* lo,
                                                    const int* hi,
                                                    const int* org,
                                                    const SasaGeom& g) {
#if SASA_N_HALO > 0
  if (SASA_N_HALO >= 3) sasa_streamed_axis<0>(dst, nb, stride, lo, hi, org, g);
  if (SASA_N_HALO >= 2) sasa_streamed_axis<1>(dst, nb, stride, lo, hi, org, g);
  sasa_streamed_axis<2>(dst, nb, stride, lo, hi, org, g);
#endif
}

// One stage over the whole window into dst, then its boundary rule:
// the streamed belt first (bucket specs), then the bucket-level rule.
// zero/constant write the boundary value on out-of-grid cells directly
// (the reference computes them and then masks: the same result).
template <int K>
__device__ __forceinline__ void sasa_run_stage(float* dst,
                                               const float* const* env,
                                               const int* org,
                                               const SasaGeom& g,
                                               const int* lo,
                                               const int* hi) {
  sasa_for_window(g, org, [&](int z, int y, int x, int c, int gz, int gy,
                              int gx) {
    float v;
    if (SASA_BOUNDARY <= 1 && !sasa_in_grid(gz, gy, gx, g)) {
      v = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
    } else {
      v = sasa_round(sasa_stage<K>(env, z, y, x, g), (sasa_store_t*)nullptr);
    }
    dst[c] = v;
  });
  __syncthreads();
  sasa_streamed_fixup(dst, 1, 0, lo, hi, org, g);
  if (SASA_BOUNDARY == 2) {
    sasa_replicate_fixup(dst, org, g);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SASA_THREADS_X * SASA_THREADS_Y)
sasa_tile_kernel(SasaPtrs p, SasaGeom g) {
  extern __shared__ float sasa_smem[];
  const int wcells = g.win[0] * g.win[1] * g.win[2];
  float* buf[SASA_NBUF];
#pragma unroll
  for (int i = 0; i < SASA_NBUF; ++i) buf[i] = sasa_smem + i * wcells;
  // Per-(entry, tile) belt bounds per kernel axis, after the windows.
  int* lo = reinterpret_cast<int*>(sasa_smem + SASA_NBUF * wcells);
  int* hi = lo + 3;
#if SASA_N_HALO > 0
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = INT_MAX;
      hi[d] = INT_MIN;
    }
  }
  __syncthreads();
#endif

  int t = blockIdx.x;
  int tc[3];
  tc[2] = t % g.ntile[2]; t /= g.ntile[2];
  tc[1] = t % g.ntile[1]; t /= g.ntile[1];
  tc[0] = t;
  int org[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) org[d] = tc[d] * g.tile[d] - g.halo[d];
  const long long base = (long long)blockIdx.z * g.cells;

  // Load every input window with the boundary rule folded in.
  sasa_for_window(g, org, [&](int, int, int, int c, int gz, int gy, int gx) {
    const bool in = sasa_in_grid(gz, gy, gx, g);
    const long long src =
        ((long long)sasa_fold(gz, g.n[0]) * g.n[1] + sasa_fold(gy, g.n[1])) *
            g.n[2] + sasa_fold(gx, g.n[2]);
    for (int i = 0; i < SASA_N_IN; ++i) {
      float v = sasa_load(p.in[i] + base + src);
      if (SASA_BOUNDARY <= 1 && !in)
        v = (SASA_BOUNDARY == 0) ? 0.0f : SASA_BVALUE;
      buf[i][c] = v;
    }
  });
#if SASA_N_HALO > 0
  // Belt bounds: min and max over the whole window of each map's
  // block-local target (the maps as loaded, with the same fold).
  {
    int tlo[SASA_N_HALO], thi[SASA_N_HALO];
    for (int k = 0; k < SASA_N_HALO; ++k) {
      tlo[k] = INT_MAX;
      thi[k] = INT_MIN;
    }
    sasa_for_window(g, org, [&](int, int, int, int, int gz, int gy,
                                int gx) {
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
  // Streamed belt on every input window, then (replicate) the bucket rule,
  // as the plain version re-imposes both on entry.
#if SASA_N_HALO > 0
  sasa_streamed_fixup(buf[0], SASA_N_IN, wcells, lo, hi, org, g);
  if (SASA_BOUNDARY == 2) {
    for (int i = 0; i < SASA_N_IN; ++i) sasa_replicate_fixup(buf[i], org, g);
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
    SASA_STAGE_CALLS
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // Write the interior tile.
  for (int z = 0; z < g.tile[0]; ++z)
    for (int y = threadIdx.y; y < g.tile[1]; y += SASA_THREADS_Y)
      for (int x = threadIdx.x; x < g.tile[2]; x += SASA_THREADS_X) {
        const int gz = tc[0] * g.tile[0] + z;
        const int gy = tc[1] * g.tile[1] + y;
        const int gx = tc[2] * g.tile[2] + x;
        if (gz < g.n[0] && gy < g.n[1] && gx < g.n[2]) {
          const int c = ((z + g.halo[0]) * g.win[1] + y + g.halo[1]) *
                            g.win[2] + x + g.halo[2];
          sasa_put(p.out + base + ((long long)gz * g.n[1] + gy) * g.n[2] + gx,
                   cur[c]);
        }
      }
}

// Plain C entry point, bound with ctypes.
//   ins   host array of SASA_N_IN device pointers (floating inputs)
//   maps  host array of SASA_N_HALO device pointers (int32 halo-index
//         maps, (B,) + grid each, in axis order); ignored when 0
//   out   device pointer of the output, (B,) + grid
//   geom  host array of 12 ints: B, n0, n1, n2, t0, t1, t2, h0, h1, h2, s,
//         dynamic shared-memory bytes
// Returns cudaGetLastError() after the launch (0 on success).
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
  for (int d = 0; d < 3; ++d) {
    g.n[d] = geom[1 + d];
    g.tile[d] = geom[4 + d];
    g.halo[d] = geom[7 + d];
    g.ntile[d] = (g.n[d] + g.tile[d] - 1) / g.tile[d];
    g.win[d] = g.tile[d] + 2 * g.halo[d];
    cells *= g.n[d];
    tiles *= g.ntile[d];
  }
  g.s = geom[10];
  g.cells = cells;
  const int smem = geom[11];
  cudaError_t err = cudaFuncSetAttribute(
      sasa_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(SASA_THREADS_X, SASA_THREADS_Y, 1);
  dim3 grid((unsigned)tiles, 1, (unsigned)B);
  sasa_tile_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(p, g);
  return (int)cudaGetLastError();
}
