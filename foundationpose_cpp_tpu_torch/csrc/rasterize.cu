// The full-frame rasterizer for N views, one CUDA kernel for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_raster_kernel`, launched by
// `rasterize_tpu` in foundationpose_cpp_tpu/ops/rasterize_pallas.py, and the
// XLA pass after it that resolves the winner's id and barycentrics.
// Plain version: ops/rasterize.py `rasterize` (named rasterize_tiled_plain
// in ops/rasterize_tiled.py); rasterize_scatter_plain there walks this
// kernel's algorithm in PyTorch.
//
// What it computes, per view n and pixel (x, y) in raster rows (no flip):
// the nearest face whose edge functions at the pixel center all share a sign
// (and do not sum to 0) with z/w in [-1, 1], the lowest face id on equal z/w,
// and writes (b0, b1, z/w, id + 1) with b0, b1 = a0 / sum, a1 / sum clamped
// to [0, 1]; background pixels are exactly zero. Faces with a vertex at
// w <= 0 or a degenerate edge system never win.
//
// What bounds it on the H100: at one 480x640 view the output (16 bytes a
// pixel, 4.9 MB) takes about 1.5 us at 3.35 TB/s, and the tests the data
// needs (each visible face against the pixel centers of its own bbox, about
// 20 f32 operations each) less at 67 TFLOP/s: bytes-bound, and at N = 1 far
// below a launch's own cost.
//
// What the design does about it: it takes the clip coordinates as they are
// and builds every face's plane coefficients and pixel bbox itself, so the
// wrapper is one launch. A block owns one region of one view (a 480x640
// frame is 80 blocks of 64x64; any h, w go through, a ragged region neither
// tests nor stores past the image) and scatters the view's faces into a
// depth buffer of 64-bit keys in shared memory (raster_tile.cuh: each face
// walks the pixel centers of its own bbox; small faces one to a thread, large
// ones by the whole block). The resolve decodes each pixel's winner,
// re-evaluates its edge values for the barycentrics and stores one float4.
//
// -D switches, for tools/raster_region_sweep.py: RASTER_REGION_W and
// RASTER_REGION_H (the region), and those of raster_tile.cuh.

#include <cuda_runtime.h>
#include <math.h>

#include "raster_tile.cuh"

#ifndef RASTER_REGION_W
#define RASTER_REGION_W 64
#endif
#ifndef RASTER_REGION_H
#define RASTER_REGION_H 64
#endif

namespace {

using raster_tile::clamp01;
using raster_tile::NTHREAD;

constexpr int RW = RASTER_REGION_W;
constexpr int RH = RASTER_REGION_H;
using Shared = raster_tile::Shared<RW, RH>;

__global__ void __launch_bounds__(NTHREAD)
rasterize_kernel(const float4* __restrict__ clip, const int* __restrict__ faces,
                 const float* __restrict__ coeffs, float4* __restrict__ out, int V, int F, int H,
                 int W) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(shared_raw);
  const int n = blockIdx.z;
  const int rx0 = blockIdx.x * RW, ry0 = blockIdx.y * RH;
  const raster_tile::View view{clip + (size_t)n * V, 1, faces,
                               coeffs == nullptr ? nullptr : coeffs + (size_t)n * F * 15,
                               F, H, W};
  raster_tile::scatter_faces<RW, RH>(sh, view, rx0, ry0);

#ifndef RASTER_ABLATE_NORESOLVE
  for (int p = threadIdx.x; p < RW * RH; p += NTHREAD) {
    const int lx = p % RW, ly = p / RW;
    const int x = rx0 + lx, y = ry0 + ly;
    if (x >= W || y >= H) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const long long key = sh.keys[p];
    if (key != raster_tile::EMPTY_KEY) {
      const int fid = raster_tile::key_face(key);
      const raster_tile::Corners k = raster_tile::load_corners(view, fid);
      float a[3];
      raster_tile::winner_edge_values(view, fid, k, sh.fx[lx], sh.fy[ly], a);
      const float iw = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(a[0], a[1]), a[2]));
      v.x = clamp01(__fmul_rn(a[0], iw));
      v.y = clamp01(__fmul_rn(a[1], iw));
      v.z = raster_tile::key_depth(key);  // in [-1, 1] by the coverage rule
      v.w = (float)(fid + 1);
    }
    out[((size_t)n * H + y) * W + x] = v;
  }
#endif
}

}  // namespace

// clip (N, V, 4) f32, faces (F, 3) int32, out (N, H, W, 4) f32. coeffs is
// null, or (N, F, 15) plane coefficients that take the place of the ones
// the kernel builds (a check of the scatter and the resolve alone).
extern "C" int fp_rasterize(const void* clip, const void* faces, const void* coeffs, void* out,
                            int N, int V, int F, int H, int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rasterize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Shared));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + RW - 1) / RW, (H + RH - 1) / RH, N);
  rasterize_kernel<<<grid, NTHREAD, sizeof(Shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(clip), static_cast<const int*>(faces),
      static_cast<const float*>(coeffs), static_cast<float4*>(out), V, F, H, W);
  return (int)cudaGetLastError();
}

// (region_w, region_h, threads, small_face, shared bytes a block) of this
// build.
extern "C" void fp_rasterize_config(int* out) {
  out[0] = RW;
  out[1] = RH;
  out[2] = NTHREAD;
  out[3] = raster_tile::SMALL_FACE;
  out[4] = (int)sizeof(Shared);
}
