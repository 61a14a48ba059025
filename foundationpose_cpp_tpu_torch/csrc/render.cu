// The render branch for N views, two CUDA kernels for Hopper (sm_90a).
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
// (N, H, W, 6) f32 image. Background pixels are exactly zero.
//
// What bounds it on the H100: writing the output, 6 floats per pixel (155 MB
// at 252 views of 160x160, about 0.05 ms at 3.35 TB/s). The tests the data
// needs (each face against the pixel centers of its own bbox, about 20 f32
// operations each) take less at the 67 TFLOP/s f32 rate of the CUDA cores.
//
// What the design does about it: it takes the mesh, the poses and the clip
// matrices as they are, so no tensor of size (views, faces) is ever written.
// vertex_kernel writes per (view, vertex) the clip coordinates and the
// camera-frame xyz and Lambert term (8 floats, 24 MB at 252 views of 3010
// vertices, which stays in the 50 MB L2). render_kernel gives a block one
// region of one view: it scatters the view's faces into a depth buffer of
// 64-bit keys in shared memory (raster_tile.cuh: each face walks the pixel
// centers of its own bbox, so the tests done are little more than those
// needed; small faces one to a thread, large ones by the whole block), then
// resolves: each pixel decodes its winner, re-evaluates its edge values and
// fetches only that face's attributes and texels. Neighbouring threads take
// neighbouring pixels of a row, so the stores are contiguous.
//
// Every block walks all faces of its view, so a large region sets each face
// up fewer times: with many views a block takes a whole 160x160 crop (200 KB
// of keys, one block of 1024 threads an SM). With few views (Track renders
// one) that would leave most SMs idle, so a launch whose large regions are
// fewer than FEW_BLOCKS takes 32x32 regions instead.
//
// -D switches, for tools/raster_region_sweep.py: RASTER_REGION_W and
// RASTER_REGION_H (the region of a launch with many views),
// RASTER_FEW_REGION_W and RASTER_FEW_REGION_H (with few), RASTER_FEW_BLOCKS,
// and those of raster_tile.cuh.

#include <cuda_runtime.h>
#include <math.h>

#include "raster_tile.cuh"

#ifndef RASTER_REGION_W
#define RASTER_REGION_W 160
#endif
#ifndef RASTER_REGION_H
#define RASTER_REGION_H 160
#endif
#ifndef RASTER_FEW_REGION_W
#define RASTER_FEW_REGION_W 32
#endif
#ifndef RASTER_FEW_REGION_H
#define RASTER_FEW_REGION_H 32
#endif
#ifndef RASTER_FEW_BLOCKS
#define RASTER_FEW_BLOCKS 132
#endif

namespace {

using raster_tile::clamp01;
using raster_tile::NTHREAD;

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// A mesh table's row per view (int32): its mesh's first vertex and vertex
// count in the concatenated vertices, normals and texcoords, its first face
// and face count in the concatenated faces, its first texel and texture
// height and width in the concatenated texels, and the view's first slot in
// the verts scratch (ops/render.py ViewTable).
constexpr int TABLE_COLS = 8;
constexpr int COL_VERTEX_FIRST = 0, COL_VERTEX_COUNT = 1, COL_FACE_FIRST = 2,
              COL_FACE_COUNT = 3, COL_TEXEL_FIRST = 4, COL_TEX_H = 5, COL_TEX_W = 6,
              COL_SCRATCH_FIRST = 7;

// m[0] x + m[1] y + m[2] z, accumulated as a matrix product's inner loop
__device__ __forceinline__ float rotate_row(const float* m, float x, float y, float z) {
  return __fmaf_rn(m[2], z, __fmaf_rn(m[1], y, __fmul_rn(m[0], x)));
}

// Per (view, vertex): clip = clip_mat (v, 1); xyz = pose (v, 1); the Lambert
// term clamp(-n_z / |n|, 0, 1) of the rotated normal. verts holds
// (clip.xyzw | xyz, lambert) as two float4. With TABLE a launch of
// (vertex blocks, N) walks each view's own mesh: row n of the table gives the
// mesh's first vertex in the concatenated vertices and its vertex count, and
// the view's first slot in verts.
template <bool TABLE>
__global__ void vertex_kernel(const float* __restrict__ vertices,
                              const float* __restrict__ normals,
                              const float* __restrict__ poses,
                              const float* __restrict__ clip_mat, float4* __restrict__ verts,
                              int N, int V, const int* __restrict__ table) {
  int n, vi;
  long long slot;
  if constexpr (TABLE) {
    const int* row = table + (size_t)blockIdx.y * TABLE_COLS;
    const int local = blockIdx.x * blockDim.x + threadIdx.x;
    if (local >= row[COL_VERTEX_COUNT]) return;
    n = blockIdx.y;
    vi = row[COL_VERTEX_FIRST] + local;
    slot = (long long)row[COL_SCRATCH_FIRST] + local;
  } else {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)N * V) return;
    n = (int)(i / V);
    vi = (int)(i % V);
    slot = i;
  }
  const float* P = poses + (size_t)n * 16;
  const float* M = clip_mat + (size_t)n * 16;
  const float x = vertices[3 * vi], y = vertices[3 * vi + 1], z = vertices[3 * vi + 2];
  float4 clip, cam;
  clip.x = __fadd_rn(rotate_row(M, x, y, z), M[3]);
  clip.y = __fadd_rn(rotate_row(M + 4, x, y, z), M[7]);
  clip.z = __fadd_rn(rotate_row(M + 8, x, y, z), M[11]);
  clip.w = __fadd_rn(rotate_row(M + 12, x, y, z), M[15]);
  cam.x = __fadd_rn(rotate_row(P, x, y, z), P[3]);
  cam.y = __fadd_rn(rotate_row(P + 4, x, y, z), P[7]);
  cam.z = __fadd_rn(rotate_row(P + 8, x, y, z), P[11]);
  const float nx = normals[3 * vi], ny = normals[3 * vi + 1], nz = normals[3 * vi + 2];
  const float tx = rotate_row(P, nx, ny, nz);
  const float ty = rotate_row(P + 4, nx, ny, nz);
  const float tz = rotate_row(P + 8, nx, ny, nz);
  const float norm = sqrtf(__fmaf_rn(tz, tz, __fmaf_rn(ty, ty, __fmul_rn(tx, tx))));
  cam.w = norm == 0.0f ? 0.0f : clamp01(__fdiv_rn(-tz, fmaxf(norm, 1e-30f)));
  verts[2 * slot] = clip;
  verts[2 * slot + 1] = cam;
}

// With TABLE, row n of the table selects view n's mesh out of the
// concatenated faces, texcoords and texels, and its scratch vertices; its
// diameter is diameters[n], whose half is the one-mesh launch's ds (halving
// an f32 is exact), and F, Th, Tw and ds are read there.
template <int RW, int RH, bool TABLE>
__global__ void __launch_bounds__(NTHREAD)
render_kernel(const float4* __restrict__ verts, const float* __restrict__ coeffs,
              const float* __restrict__ texcoords, const int* __restrict__ faces,
              const float* __restrict__ tex, const float* __restrict__ poses,
              float* __restrict__ out, int F, int V, int H, int W, int Th, int Tw, float ds,
              float min_depth, float max_depth, float w_ambient, float w_diffuse,
              const int* __restrict__ table, const float* __restrict__ diameters) {
  using Shared = raster_tile::Shared<RW, RH>;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(shared_raw);
  const int n = blockIdx.z;
  const int rx0 = blockIdx.x * RW, ry0 = blockIdx.y * RH;
  const float4* view_verts;
  if constexpr (TABLE) {
    const int* row = table + (size_t)n * TABLE_COLS;
    view_verts = verts + (size_t)row[COL_SCRATCH_FIRST] * 2;
    faces += (size_t)row[COL_FACE_FIRST] * 3;
    texcoords += (size_t)row[COL_VERTEX_FIRST] * 2;
    tex += (size_t)row[COL_TEXEL_FIRST] * 3;
    F = row[COL_FACE_COUNT];
    Th = row[COL_TEX_H];
    Tw = row[COL_TEX_W];
    ds = diameters[n] * 0.5f;
  } else {
    view_verts = verts + (size_t)n * V * 2;
  }
  const raster_tile::View view{view_verts, 2, faces,
                               coeffs == nullptr ? nullptr : coeffs + (size_t)n * F * 15,
                               F, H, W};
  // phase 1: nearest covering face per pixel, lowest id on equal depth
  raster_tile::scatter_faces<RW, RH>(sh, view, rx0, ry0);

#ifndef RASTER_ABLATE_NORESOLVE
  // phase 2: the winner's attributes, texture, shading and xyz; flipped row
  const float t[3] = {poses[(size_t)n * 16 + 3], poses[(size_t)n * 16 + 7],
                      poses[(size_t)n * 16 + 11]};
  for (int p = threadIdx.x; p < RW * RH; p += NTHREAD) {
    const int lx = p % RW, ly = p / RW;
    const int x = rx0 + lx, y = ry0 + ly;
    if (x >= W || y >= H) continue;
    float2* o = reinterpret_cast<float2*>(out + (((size_t)n * H + (H - 1 - y)) * W + x) * 6);
    const long long key = sh.keys[p];
    if (key == raster_tile::EMPTY_KEY) {
      o[0] = o[1] = o[2] = make_float2(0.0f, 0.0f);
      continue;
    }
    const int fid = raster_tile::key_face(key);
    const raster_tile::Corners k = raster_tile::load_corners(view, fid);
    float a[3];
    raster_tile::winner_edge_values(view, fid, k, sh.fx[lx], sh.fy[ly], a);
    const float iw = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(a[0], a[1]), a[2]));
    const float b0 = clamp01(__fmul_rn(a[0], iw));
    const float b1 = clamp01(__fmul_rn(a[1], iw));
    const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
    const float4 c0 = __ldg(view_verts + (size_t)k.i0 * 2 + 1);
    const float4 c1 = __ldg(view_verts + (size_t)k.i1 * 2 + 1);
    const float4 c2 = __ldg(view_verts + (size_t)k.i2 * 2 + 1);
    const float2* uv = reinterpret_cast<const float2*>(texcoords);
    const float2 u0 = __ldg(uv + k.i0), u1 = __ldg(uv + k.i1), u2 = __ldg(uv + k.i2);
    const float A0[6] = {c0.x, c0.y, c0.z, c0.w, u0.x, u0.y};
    const float A1[6] = {c1.x, c1.y, c1.z, c1.w, u1.x, u1.y};
    const float A2[6] = {c2.x, c2.y, c2.z, c2.w, u2.x, u2.y};
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
    const int tu0 = wrap(iu0, Tw), tu1 = wrap(iu0 + 1, Tw);
    const int tv0 = wrap(iv0, Th), tv1 = wrap(iv0 + 1, Th);
    const float w00 = __fmul_rn(__fsub_rn(1.0f, fu), __fsub_rn(1.0f, fvv));
    const float w10 = __fmul_rn(fu, __fsub_rn(1.0f, fvv));
    const float w01 = __fmul_rn(__fsub_rn(1.0f, fu), fvv);
    const float w11 = __fmul_rn(fu, fvv);
    const float* t00 = tex + ((size_t)tv0 * Tw + tu0) * 3;
    const float* t10 = tex + ((size_t)tv0 * Tw + tu1) * 3;
    const float* t01 = tex + ((size_t)tv1 * Tw + tu0) * 3;
    const float* t11 = tex + ((size_t)tv1 * Tw + tu1) * 3;
    const float lit = __fadd_rn(w_ambient, __fmul_rn(val[3], w_diffuse));
    float px[6];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float col = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(t00[ch], w00), __fmul_rn(t10[ch], w10)),
                    __fmul_rn(t01[ch], w01)),
          __fmul_rn(t11[ch], w11));
      px[ch] = clamp01(__fmul_rn(col, lit));
    }

    // threshold and downscale (render.cu:61-118): per coordinate
    const bool invalid = val[2] < min_depth;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float s = __fdiv_rn(__fsub_rn(val[ch], t[ch]), ds);
      px[3 + ch] = (invalid || fabsf(s) > max_depth) ? 0.0f : s;
    }
    o[0] = make_float2(px[0], px[1]);
    o[1] = make_float2(px[2], px[3]);
    o[2] = make_float2(px[4], px[5]);
  }
#endif
}

struct RenderArgs {
  const float4* verts;
  const float* coeffs;
  const float* texcoords;
  const int* faces;
  const float* tex;
  const float* poses;
  float* out;
  int N, F, V, H, W, Th, Tw;
  float ds, min_depth, max_depth, w_ambient, w_diffuse;
  const int* table;  // null: one mesh for every view
  const float* diameters;
};

template <int RW, int RH, bool TABLE>
cudaError_t launch_render(const RenderArgs& a, cudaStream_t stream) {
  const int shared = (int)sizeof(raster_tile::Shared<RW, RH>);
  cudaError_t err = cudaFuncSetAttribute(render_kernel<RW, RH, TABLE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  dim3 grid((a.W + RW - 1) / RW, (a.H + RH - 1) / RH, a.N);
  render_kernel<RW, RH, TABLE><<<grid, NTHREAD, shared, stream>>>(
      a.verts, a.coeffs, a.texcoords, a.faces, a.tex, a.poses, a.out, a.F, a.V, a.H, a.W, a.Th,
      a.Tw, a.ds, a.min_depth, a.max_depth, a.w_ambient, a.w_diffuse, a.table, a.diameters);
  return cudaGetLastError();
}

constexpr int RW = RASTER_REGION_W, RH = RASTER_REGION_H;
constexpr int FEW_RW = RASTER_FEW_REGION_W, FEW_RH = RASTER_FEW_REGION_H;

// The render kernel with many views' regions, or with few (FEW_BLOCKS).
template <bool TABLE>
cudaError_t launch_regions(const RenderArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)a.N * ((a.W + RW - 1) / RW) * ((a.H + RH - 1) / RH);
  if (blocks < RASTER_FEW_BLOCKS) return launch_render<FEW_RW, FEW_RH, TABLE>(a, stream);
  return launch_render<RW, RH, TABLE>(a, stream);
}

}  // namespace

// vertices, normals (V, 3), texcoords (V, 2), faces (F, 3) int32, tex
// (Th, Tw, 3), poses, clip_mat (N, 4, 4), verts (N, V, 8) scratch, out
// (N, H, W, 6). With transform != 0 vertex_kernel fills verts first; with
// 0 the caller has filled it and vertices, normals and clip_mat are not
// read. coeffs is null, or (N, F, 15) plane coefficients that take
// the place of the ones the kernel builds (a check of the scatter and the
// resolve alone).
extern "C" int fp_render_views(const void* vertices, const void* normals, const void* texcoords,
                               const void* faces, const void* tex, const void* poses,
                               const void* clip_mat, void* verts, const void* coeffs,
                               void* out, int N, int F, int V, int H, int W, int Th, int Tw,
                               float ds, float min_depth, float max_depth,
                               float w_ambient, float w_diffuse, int transform, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transform != 0) {
    const long long total = (long long)N * V;
    vertex_kernel<false><<<(unsigned int)((total + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(vertices), static_cast<const float*>(normals),
        static_cast<const float*>(poses), static_cast<const float*>(clip_mat),
        static_cast<float4*>(verts), N, V, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const RenderArgs a{static_cast<const float4*>(verts), static_cast<const float*>(coeffs),
                     static_cast<const float*>(texcoords), static_cast<const int*>(faces),
                     static_cast<const float*>(tex), static_cast<const float*>(poses),
                     static_cast<float*>(out), N, F, V, H, W, Th, Tw,
                     ds, min_depth, max_depth, w_ambient, w_diffuse, nullptr, nullptr};
  return (int)launch_regions<false>(a, s);
}

// N views, each of its own mesh: vertices, normals (sum V, 3), texcoords
// (sum V, 2), faces (sum F, 3) int32 with indices local to their mesh and
// tex (sum Th * Tw, 3) concatenate the meshes; table (N, TABLE_COLS) int32
// selects view n's mesh and its slots in the verts scratch (sum over the
// views of their vertex counts, 8 floats each); diameters (N,) f32; poses,
// clip_mat (N, 4, 4); out (N, H, W, 6). V_max is the largest vertex count
// of a view. Both kernels run, as fp_render_views runs them with
// transform != 0, and each view computes what a one-mesh launch of its mesh
// computes for it.
extern "C" int fp_render_views_table(const void* vertices, const void* normals,
                                     const void* texcoords, const void* faces,
                                     const void* tex, const void* poses, const void* clip_mat,
                                     const void* table, const void* diameters, void* verts,
                                     void* out, int N, int V_max, int H, int W,
                                     float min_depth, float max_depth, float w_ambient,
                                     float w_diffuse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rows = static_cast<const int*>(table);
  vertex_kernel<true><<<dim3((unsigned int)((V_max + 255) / 256), (unsigned int)N), 256, 0, s>>>(
      static_cast<const float*>(vertices), static_cast<const float*>(normals),
      static_cast<const float*>(poses), static_cast<const float*>(clip_mat),
      static_cast<float4*>(verts), N, V_max, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const RenderArgs a{static_cast<const float4*>(verts), nullptr,
                     static_cast<const float*>(texcoords), static_cast<const int*>(faces),
                     static_cast<const float*>(tex), static_cast<const float*>(poses),
                     static_cast<float*>(out), N, 0, 0, H, W, 0, 0,
                     0.0f, min_depth, max_depth, w_ambient, w_diffuse, rows,
                     static_cast<const float*>(diameters)};
  return (int)launch_regions<true>(a, s);
}

// The build's choices, for the smoke run and the sweep tool: (region_w,
// region_h, threads, small_face, shared bytes a block) of a launch with many
// views, then (region_w, region_h, shared bytes) of one with few, then the
// block count below which a launch counts as few.
extern "C" void fp_render_config(int* out) {
  out[0] = RW;
  out[1] = RH;
  out[2] = NTHREAD;
  out[3] = raster_tile::SMALL_FACE;
  out[4] = (int)sizeof(raster_tile::Shared<RW, RH>);
  out[5] = FEW_RW;
  out[6] = FEW_RH;
  out[7] = (int)sizeof(raster_tile::Shared<FEW_RW, FEW_RH>);
  out[8] = RASTER_FEW_BLOCKS;
}
