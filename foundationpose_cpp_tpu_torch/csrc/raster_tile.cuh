// The nearest-face pass over one 32x32 pixel tile, shared by the render
// kernel (csrc/render.cu) and the full-frame rasterizer (csrc/rasterize.cu).
//
// Contract of ops/rasterize.py: a pixel center is covered by a face when its
// three edge values share a sign and do not sum to 0, and its z/w lies in
// [-1, 1]; the nearest z/w wins, the lowest face id on equal z/w. Every plane
// and the division use the round-to-nearest intrinsics in the plain version's
// evaluation order, so FMA contraction cannot move a pixel across an edge.
//
// Inputs per (view, face), from the PyTorch prepass: 15 plane coefficients
// (a0, a1, a2, z, w; each c_fx, c_fy, c_1) and an inclusive pixel bbox
// (x0, x1, y0, y1), empty (x0 > x1) for faces that are culled or padding.
// The block of NTHREAD threads walks the view's faces in batches of BATCH:
// each thread tests one face's bbox against the tile and appends survivors
// to a shared list, which all threads then test against their pixels. A
// thread owns ROWS pixels of one column, so one face's coefficients read
// from shared memory serve ROWS pixel tests.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace raster_tile {

constexpr int TILE = 32;
constexpr int NTHREAD = 256;
constexpr int ROWS = TILE * TILE / NTHREAD;  // pixels per thread, one column
constexpr int BATCH = NTHREAD;               // faces tested per staging round

__device__ __forceinline__ float plane(float cx, float cy, float c1, float fx, float fy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cx, fx), __fmul_rn(cy, fy)), c1);
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// The winners of one thread's ROWS pixels: pixel k is (x, ty0 + ly + k *
// (NTHREAD / TILE)); best_id is -1 where no face covers it, and a0..a2 are
// the winner's edge values at the pixel center.
struct Winners {
  int x, ly;
  float best_zw[ROWS], a0[ROWS], a1[ROWS], a2[ROWS];
  int best_id[ROWS];
};

// Every thread of the block must call this (it synchronizes the block).
__device__ __forceinline__ Winners nearest_faces(const float* __restrict__ coeffs,
                                                 const int4* __restrict__ bbox, int n, int F,
                                                 int H, int W) {
  __shared__ float sc[15][BATCH];
  __shared__ int sid[BATCH];
  __shared__ int count;

  const int tx0 = blockIdx.x * TILE;
  const int ty0 = blockIdx.y * TILE;
  Winners r;
  r.x = tx0 + threadIdx.x % TILE;
  r.ly = threadIdx.x / TILE;
  const float fx = __fsub_rn(__fdiv_rn((float)(2 * r.x + 1), (float)W), 1.0f);
  float fy[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = ty0 + r.ly + k * (NTHREAD / TILE);
    fy[k] = __fsub_rn(__fdiv_rn((float)(2 * y + 1), (float)H), 1.0f);
    r.best_zw[k] = INFINITY;
    r.best_id[k] = -1;
    r.a0[k] = r.a1[k] = r.a2[k] = 0.0f;
  }

  for (int base = 0; base < F; base += BATCH) {
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    const int f = base + threadIdx.x;
    if (f < F) {
      const int4 bb = bbox[(size_t)n * F + f];  // x0, x1, y0, y1 (inclusive)
      if (bb.x <= bb.y && bb.x < tx0 + TILE && bb.y >= tx0 && bb.z < ty0 + TILE &&
          bb.w >= ty0) {
        const int slot = atomicAdd(&count, 1);
        const float* c = coeffs + ((size_t)n * F + f) * 15;
#pragma unroll
        for (int q = 0; q < 15; ++q) sc[q][slot] = c[q];
        sid[slot] = f;
      }
    }
    __syncthreads();
    const int cnt = count;
    for (int i = 0; i < cnt; ++i) {
      float c[15];
#pragma unroll
      for (int q = 0; q < 15; ++q) c[q] = sc[q][i];
      const int fid = sid[i];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const float a0 = plane(c[0], c[1], c[2], fx, fy[k]);
        const float a1 = plane(c[3], c[4], c[5], fx, fy[k]);
        const float a2 = plane(c[6], c[7], c[8], fx, fy[k]);
        const bool pos = a0 >= 0.0f && a1 >= 0.0f && a2 >= 0.0f;
        const bool neg = a0 <= 0.0f && a1 <= 0.0f && a2 <= 0.0f;
        if (!(pos || neg) || __fadd_rn(__fadd_rn(a0, a1), a2) == 0.0f) continue;
        const float zw = __fdiv_rn(plane(c[9], c[10], c[11], fx, fy[k]),
                                   plane(c[12], c[13], c[14], fx, fy[k]));
        if (!(zw >= -1.0f && zw <= 1.0f)) continue;
        if (zw < r.best_zw[k] || (zw == r.best_zw[k] && fid < r.best_id[k])) {
          r.best_zw[k] = zw;
          r.best_id[k] = fid;
          r.a0[k] = a0;
          r.a1[k] = a1;
          r.a2[k] = a2;
        }
      }
    }
    __syncthreads();  // the list is consumed before the next round refills it
  }
  return r;
}

}  // namespace raster_tile
