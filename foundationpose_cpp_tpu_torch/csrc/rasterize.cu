// The full-frame rasterizer for N views, one CUDA kernel for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_raster_kernel`, launched by
// `rasterize_tpu` in foundationpose_cpp_tpu/ops/rasterize_pallas.py, and the
// XLA pass after it that resolves the winner's id and barycentrics.
// Plain version: ops/rasterize.py `rasterize` (named rasterize_tiled_plain
// in ops/rasterize_tiled.py).
//
// What it computes, per view n and pixel (x, y) in raster rows (no flip):
// the nearest face whose edge functions at the pixel center all share a sign
// (and do not sum to 0) with z/w in [-1, 1], the lowest face id on equal z/w,
// and writes (b0, b1, z/w, id + 1) with b0, b1 = a0 / sum, a1 / sum clamped
// to [0, 1]; background pixels are exactly zero. Faces behind the camera or
// invalid (padding rows) have an empty bbox and are never staged. Every edge,
// z and w plane and the division use the round-to-nearest intrinsics in the
// plain version's evaluation order, so FMA contraction cannot move a pixel
// across an edge and the ids match the plain version exactly.
//
// The per-(view, face) inputs come from a prepass in PyTorch
// (ops/rasterize_tiled.py): the 15 plane coefficients and the conservative
// pixel bbox that the render kernel (csrc/render.cu) uses too.
//
// What bounds it on the H100: at one 480x640 view the output (16 bytes a
// pixel, 4.9 MB) takes about 1.5 us at 3.35 TB/s, and the tests the data
// needs (each visible face against the pixel centers of its own bbox, about
// 20 f32 operations each) less at 67 TFLOP/s: bytes-bound, and at N = 1 far
// below a launch's own cost.
//
// What the design does about it: one block per (view, 32x32 tile), so a
// 480x640 frame is 300 blocks and any h, w go through (partial tiles are
// masked at the store). The block runs the nearest-face pass that the
// render kernel runs (raster_tile.cuh: faces staged through shared memory
// after a bbox test against the tile, 4 pixels a thread). The winner's edge
// values stay in registers, so its barycentrics need no second pass.

#include <cuda_runtime.h>
#include <math.h>

#include "raster_tile.cuh"

namespace {

using raster_tile::clamp01;
using raster_tile::NTHREAD;
using raster_tile::ROWS;
using raster_tile::TILE;

__global__ void __launch_bounds__(NTHREAD)
rasterize_kernel(const float* __restrict__ coeffs, const int4* __restrict__ bbox,
                 float4* __restrict__ out, int F, int H, int W) {
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TILE;
  const raster_tile::Winners win = raster_tile::nearest_faces(coeffs, bbox, n, F, H, W);
  const int x = win.x;
  const int ly = win.ly;

  if (x >= W) return;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = ty0 + ly + k * (NTHREAD / TILE);
    if (y >= H) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (win.best_id[k] >= 0) {
      const float iw = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(win.a0[k], win.a1[k]), win.a2[k]));
      v.x = clamp01(__fmul_rn(win.a0[k], iw));
      v.y = clamp01(__fmul_rn(win.a1[k], iw));
      v.z = fminf(fmaxf(win.best_zw[k], -1.0f), 1.0f);
      v.w = (float)(win.best_id[k] + 1);
    }
    out[((size_t)n * H + y) * W + x] = v;
  }
}

}  // namespace

extern "C" int fp_rasterize(const void* coeffs, const void* bbox, void* out, int N, int F,
                            int H, int W, void* stream) {
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
  rasterize_kernel<<<grid, NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const int4*>(bbox),
      static_cast<float4*>(out), F, H, W);
  return (int)cudaGetLastError();
}
