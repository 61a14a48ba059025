// The render branch for N views, one CUDA kernel for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_fused_kernel`, launched by
// `render_views_fused` in foundationpose_cpp_tpu/ops/render_fused.py.
// Plain version: render_views_plain in ops/render.py, i.e. the exact unfused
// render_branch of the JAX package (pipeline/renderer.py:269-297).
//
// What it computes, per view n and crop pixel: the nearest face under the
// pixel center (the coverage rule and lowest-id tie break of
// ops/rasterize.py), its clamped barycentrics, the interpolated camera-frame
// xyz, Lambert term and uv of its corners, a bilinear-wrap texture fetch,
// the shaded and clamped color, and the xyz thresholded and downscaled by
// diameter/2; written as (rgb | xyz) to the vertically flipped row of an
// (N, H, W, 6) f32 image. Background pixels are exactly zero. Arithmetic uses
// the round-to-nearest intrinsics in the plain version's order, so the FMA
// contraction nvcc would do cannot move a pixel across a face edge.
//
// The per-(view, face) inputs come from a prepass in PyTorch (ops/render.py):
// 15 edge/z/w plane coefficients, a conservative pixel bbox (empty for culled
// faces), and the 6 vertex attributes per (view, vertex).
//
// What bounds it on the H100: writing the output, 6 floats per pixel (155 MB
// at 252 views of 160x160, about 0.05 ms at 3.35 TB/s). The tests the data
// needs (each face against the pixel centers of its own bbox, about 20 f32
// operations each) take less at the 67 TFLOP/s f32 rate of the CUDA cores.
// This design does far more tests than that: every pixel of a 32x32 tile
// against every face whose bbox meets the tile, back faces included, so on
// a dense mesh (6016 faces) the tests, not the bytes, set its time.
//
// What the design does about it: one block per (view, 32x32 tile) runs the
// nearest-face pass of raster_tile.cuh (256 threads, each owning 4 pixels of
// one column; faces staged through shared memory in batches of 256 after a
// bbox test against the tile). Depth is kept as a full f32 with an int face
// id (no packed keys), and only the winner's attributes and texels are
// fetched.

#include <cuda_runtime.h>
#include <math.h>

#include "raster_tile.cuh"

namespace {

using raster_tile::clamp01;
using raster_tile::NTHREAD;
using raster_tile::ROWS;
using raster_tile::TILE;

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

__global__ void __launch_bounds__(NTHREAD)
render_kernel(const float* __restrict__ coeffs, const int4* __restrict__ bbox,
              const float* __restrict__ attrs, const int* __restrict__ faces,
              const float* __restrict__ tex, const float* __restrict__ trans,
              float* __restrict__ out, int F, int V, int H, int W, int Th, int Tw,
              float ds, float min_depth, float max_depth, float w_ambient,
              float w_diffuse) {
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TILE;
  // phase 1: nearest covering face per pixel, lowest id on equal depth
  const raster_tile::Winners win = raster_tile::nearest_faces(coeffs, bbox, n, F, H, W);
  const int x = win.x;
  const int ly = win.ly;

  // phase 2: the winner's attributes, texture, shading and xyz; flipped row
  if (x >= W) return;
  const float* t = trans + (size_t)n * 3;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = ty0 + ly + k * (NTHREAD / TILE);
    if (y >= H) continue;
    float* o = out + (((size_t)n * H + (H - 1 - y)) * W + x) * 6;
    if (win.best_id[k] < 0) {
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) o[ch] = 0.0f;
      continue;
    }
    const float iw = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(win.a0[k], win.a1[k]), win.a2[k]));
    const float b0 = clamp01(__fmul_rn(win.a0[k], iw));
    const float b1 = clamp01(__fmul_rn(win.a1[k], iw));
    const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
    const int* fv = faces + (size_t)win.best_id[k] * 3;
    const float* A0 = attrs + ((size_t)n * V + fv[0]) * 6;
    const float* A1 = attrs + ((size_t)n * V + fv[1]) * 6;
    const float* A2 = attrs + ((size_t)n * V + fv[2]) * 6;
    float val[6];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
      val[ch] = __fadd_rn(__fadd_rn(__fmul_rn(b0, A0[ch]), __fmul_rn(b1, A1[ch])),
                          __fmul_rn(b2, A2[ch]));
    }

    // bilinear texture fetch with wrap (texture.cu:131-179)
    const float mu = __fsub_rn(__fmul_rn(val[4], (float)Tw), 0.5f);
    const float mv = __fsub_rn(__fmul_rn(val[5], (float)Th), 0.5f);
    const float iu0f = floorf(mu);
    const float iv0f = floorf(mv);
    const float fu = __fsub_rn(mu, iu0f);
    const float fvv = __fsub_rn(mv, iv0f);
    const int iu0 = (int)iu0f;
    const int iv0 = (int)iv0f;
    const int u0 = wrap(iu0, Tw), u1 = wrap(iu0 + 1, Tw);
    const int v0 = wrap(iv0, Th), v1 = wrap(iv0 + 1, Th);
    const float w00 = __fmul_rn(__fsub_rn(1.0f, fu), __fsub_rn(1.0f, fvv));
    const float w10 = __fmul_rn(fu, __fsub_rn(1.0f, fvv));
    const float w01 = __fmul_rn(__fsub_rn(1.0f, fu), fvv);
    const float w11 = __fmul_rn(fu, fvv);
    const float* t00 = tex + ((size_t)v0 * Tw + u0) * 3;
    const float* t10 = tex + ((size_t)v0 * Tw + u1) * 3;
    const float* t01 = tex + ((size_t)v1 * Tw + u0) * 3;
    const float* t11 = tex + ((size_t)v1 * Tw + u1) * 3;
    const float lit = __fadd_rn(w_ambient, __fmul_rn(val[3], w_diffuse));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float col = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(t00[ch], w00), __fmul_rn(t10[ch], w10)),
                    __fmul_rn(t01[ch], w01)),
          __fmul_rn(t11[ch], w11));
      o[ch] = clamp01(__fmul_rn(col, lit));
    }

    // threshold and downscale (render.cu:61-118): per coordinate
    const bool invalid = val[2] < min_depth;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float s = __fdiv_rn(__fsub_rn(val[ch], t[ch]), ds);
      o[3 + ch] = (invalid || fabsf(s) > max_depth) ? 0.0f : s;
    }
  }
}

}  // namespace

extern "C" int fp_render_views(const void* coeffs, const void* bbox, const void* attrs,
                               const void* faces, const void* tex, const void* trans,
                               void* out, int N, int F, int V, int H, int W, int Th, int Tw,
                               float ds, float min_depth, float max_depth, float w_ambient,
                               float w_diffuse, void* stream) {
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
  render_kernel<<<grid, NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const int4*>(bbox),
      static_cast<const float*>(attrs), static_cast<const int*>(faces),
      static_cast<const float*>(tex), static_cast<const float*>(trans),
      static_cast<float*>(out), F, V, H, W, Th, Tw, ds, min_depth, max_depth, w_ambient,
      w_diffuse);
  return (int)cudaGetLastError();
}
