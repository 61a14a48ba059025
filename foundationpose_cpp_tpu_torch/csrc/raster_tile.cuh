// The nearest-face pass over one region of one view, shared by the render
// kernel (csrc/render.cu) and the full-frame rasterizer (csrc/rasterize.cu):
// faces are scattered into a depth buffer in shared memory.
//
// Contract of ops/rasterize.py: a pixel center is covered by a face when its
// three edge values share a sign and do not sum to 0, and its z/w lies in
// [-1, 1]; the nearest z/w wins, the lowest face id on equal z/w; a face with
// a vertex at w <= 0 or an all-zero edge system is culled whole.
//
// A block owns a region of RW x RH pixels and keeps one 64-bit key a pixel:
// the high word is z/w mapped to an integer that orders as the float does,
// the low word the face id, so atomicMin leaves the nearest face and, on
// equal z/w, the lowest id, in whatever order the faces arrive. The block
// walks the view's faces once, NTHREAD at a time, one face a thread. The
// thread builds the face's pixel bbox (the arithmetic of ops/render.py
// face_pixel_bbox) and, when the bbox meets the region, its 15
// plane coefficients (the arithmetic of ops/rasterize.py edge_coefficients),
// from the three corners' clip coordinates. A face whose bbox holds at most
// SMALL_FACE pixels of the region is tested by its own thread; a larger one
// is staged in shared memory (LIST faces at a time) and the whole block walks
// its pixels together, so a face of thousands of pixels does not serialise on
// one thread. Only the
// pixel centers inside bbox and region are tested. The caller then resolves
// each pixel's key (key_face, winner_edge_values re-evaluate the winner's
// edge values with the same operations, hence the same bits).
//
// Every plane and division uses the round-to-nearest intrinsics in the plain
// version's evaluation order, so the compiler's FMA contraction cannot move a
// pixel across an edge; the cross products use the one fused multiply-add
// that torch.linalg.cross contracts to.
//
// -D switches, for tools/raster_region_sweep.py: RASTER_THREADS,
// RASTER_SMALL_FACE, RASTER_LIST, and the ablations RASTER_ABLATE_NOSETUP (no face is
// walked), RASTER_ABLATE_NOTESTS (faces are set up, no pixel is tested),
// RASTER_ABLATE_NOATOMICS (a plain store takes the atomic's place) and, read
// by the two kernels, RASTER_ABLATE_NORESOLVE.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef RASTER_THREADS
#define RASTER_THREADS 1024
#endif
#ifndef RASTER_SMALL_FACE
#define RASTER_SMALL_FACE 64
#endif
#ifndef RASTER_LIST
#define RASTER_LIST 128
#endif

namespace raster_tile {

constexpr int NTHREAD = RASTER_THREADS;
constexpr int SMALL_FACE = RASTER_SMALL_FACE;
constexpr int LIST = RASTER_LIST;  // large faces staged at a time
constexpr long long EMPTY_KEY = 0x7fffffffffffffffLL;

__device__ __forceinline__ float plane(float cx, float cy, float c1, float fx, float fy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cx, fx), __fmul_rn(cy, fy)), c1);
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// NDC coordinate of pixel i's center; a true division, as pixel_basis takes.
__device__ __forceinline__ float pixel_center(int i, int size) {
  return __fsub_rn(__fdiv_rn((float)(2 * i + 1), (float)size), 1.0f);
}

// z/w and the face id as one key that orders by z/w, then by id. Adding 0
// brings -0.0 to +0.0, which are equal as floats and differ as bits.
__device__ __forceinline__ long long depth_key(float zw, int fid) {
  int s = __float_as_int(__fadd_rn(zw, 0.0f));
  s ^= (s >> 31) & 0x7fffffff;
  return (long long)(((unsigned long long)(unsigned int)s << 32) | (unsigned int)fid);
}

__device__ __forceinline__ float key_depth(long long key) {
  int s = (int)(key >> 32);
  s ^= (s >> 31) & 0x7fffffff;
  return __int_as_float(s);
}

__device__ __forceinline__ int key_face(long long key) {
  return (int)(unsigned int)((unsigned long long)key & 0xffffffffULL);
}

// a * b - c * d as torch.linalg.cross computes it: one product rounded, then
// one fused multiply-add.
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// cross((qx, qy, qw), (rx, ry, rw)): (c_fx, c_fy, c_1) of one edge function
__device__ __forceinline__ void edge_cross(const float4 q, const float4 r, float* c) {
  c[0] = cross_term(q.y, r.w, q.w, r.y);
  c[1] = cross_term(q.w, r.x, q.x, r.w);
  c[2] = cross_term(q.x, r.y, q.y, r.x);
}

// c[0..9): the three edge functions a0, a1, a2 of a face
__device__ __forceinline__ void edge_coefficients(const float4 p0, const float4 p1,
                                                  const float4 p2, float* c) {
  edge_cross(p1, p2, c);
  edge_cross(p2, p0, c + 3);
  edge_cross(p0, p1, c + 6);
}

// c[9..15): the z and w planes, from the edge functions in c[0..9)
__device__ __forceinline__ void depth_coefficients(const float4 p0, const float4 p1,
                                                   const float4 p2, float* c) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[9 + k] = __fadd_rn(__fadd_rn(__fmul_rn(p0.z, c[k]), __fmul_rn(p1.z, c[3 + k])),
                         __fmul_rn(p2.z, c[6 + k]));
    c[12 + k] = __fadd_rn(__fadd_rn(__fmul_rn(p0.w, c[k]), __fmul_rn(p1.w, c[3 + k])),
                          __fmul_rn(p2.w, c[6 + k]));
  }
}

__device__ __forceinline__ float ndc(float a, float w) {
  const float u = __fdiv_rn(a, w);
  return isnan(u) ? 0.0f : u;
}

// Inclusive range of the pixels whose centers lie in the NDC interval
// [lo, hi] widened by BBOX_MARGIN pixels each way, clamped to the image
// (face_pixel_bbox); i0 > i1 when it holds no pixel center.
constexpr float BBOX_MARGIN = 0.0625f;

__device__ __forceinline__ void pixel_range(float lo, float hi, int size, int& i0, int& i1) {
  const float s = (float)size;
  lo = fminf(fmaxf(lo, -2.0f), 2.0f);
  hi = fminf(fmaxf(hi, -2.0f), 2.0f);
  const float p_lo = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(lo, 1.0f), s), 1.0f), 0.5f);
  const float p_hi = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(hi, 1.0f), s), 1.0f), 0.5f);
  i0 = (int)fmaxf(ceilf(__fsub_rn(p_lo, BBOX_MARGIN)), 0.0f);
  i1 = (int)fminf(floorf(__fadd_rn(p_hi, BBOX_MARGIN)), __fsub_rn(s, 1.0f));
}

// One view as the block sees it.
struct View {
  const float4* clip;  // vertex v's clip coordinates at clip[v * vstride]
  int vstride;
  const int* faces;     // (F, 3)
  const float* coeffs;  // (F, 15) coefficients handed in, or null: built here
  int F, H, W;
};

struct Face {
  float c[15];
  int x0, x1, y0, y1;  // bbox clipped to the region, inclusive
};

struct Corners {
  int i0, i1, i2;
  float4 p0, p1, p2;
};

__device__ __forceinline__ Corners load_corners(const View& v, int f) {
  Corners k;
  k.i0 = v.faces[3 * f];
  k.i1 = v.faces[3 * f + 1];
  k.i2 = v.faces[3 * f + 2];
  k.p0 = __ldg(v.clip + (size_t)k.i0 * v.vstride);
  k.p1 = __ldg(v.clip + (size_t)k.i1 * v.vstride);
  k.p2 = __ldg(v.clip + (size_t)k.i2 * v.vstride);
  return k;
}

// Face f's bbox inside the region [rx0, rx1] x [ry0, ry1] and its
// coefficients; false when the face is culled or misses the region.
__device__ __forceinline__ bool setup_face(const View& v, int f, int rx0, int ry0, int rx1,
                                           int ry1, Face& face) {
  const Corners k = load_corners(v, f);
  if (!(k.p0.w > 0.0f && k.p1.w > 0.0f && k.p2.w > 0.0f)) return false;
  const float ux0 = ndc(k.p0.x, k.p0.w), ux1 = ndc(k.p1.x, k.p1.w), ux2 = ndc(k.p2.x, k.p2.w);
  const float uy0 = ndc(k.p0.y, k.p0.w), uy1 = ndc(k.p1.y, k.p1.w), uy2 = ndc(k.p2.y, k.p2.w);
  int x0, x1, y0, y1;
  pixel_range(fminf(fminf(ux0, ux1), ux2), fmaxf(fmaxf(ux0, ux1), ux2), v.W, x0, x1);
  pixel_range(fminf(fminf(uy0, uy1), uy2), fmaxf(fmaxf(uy0, uy1), uy2), v.H, y0, y1);
  face.x0 = max(x0, rx0);
  face.x1 = min(x1, rx1);
  face.y0 = max(y0, ry0);
  face.y1 = min(y1, ry1);
  if (face.x0 > face.x1 || face.y0 > face.y1) return false;
  if (v.coeffs != nullptr) {
#pragma unroll
    for (int q = 0; q < 15; ++q) face.c[q] = v.coeffs[(size_t)f * 15 + q];
  } else {
    edge_coefficients(k.p0, k.p1, k.p2, face.c);
    depth_coefficients(k.p0, k.p1, k.p2, face.c);
  }
  float largest = 0.0f;
  bool is_nan = false;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    largest = fmaxf(largest, fabsf(face.c[q]));
    is_nan = is_nan || isnan(face.c[q]);
  }
  return largest > 0.0f && !is_nan;
}

// The winning face's three edge values at a pixel center, re-evaluated as
// test_pixel evaluated them.
__device__ __forceinline__ void winner_edge_values(const View& v, int f, const Corners& k,
                                                   float fx, float fy, float* a) {
  float c[9];
  if (v.coeffs != nullptr) {
#pragma unroll
    for (int q = 0; q < 9; ++q) c[q] = v.coeffs[(size_t)f * 15 + q];
  } else {
    edge_coefficients(k.p0, k.p1, k.p2, c);
  }
  a[0] = plane(c[0], c[1], c[2], fx, fy);
  a[1] = plane(c[3], c[4], c[5], fx, fy);
  a[2] = plane(c[6], c[7], c[8], fx, fy);
}

__device__ __forceinline__ void test_pixel(const float* c, int fid, float fx, float fy,
                                           long long* slot) {
  const float a0 = plane(c[0], c[1], c[2], fx, fy);
  const float a1 = plane(c[3], c[4], c[5], fx, fy);
  const float a2 = plane(c[6], c[7], c[8], fx, fy);
  const bool pos = a0 >= 0.0f && a1 >= 0.0f && a2 >= 0.0f;
  const bool neg = a0 <= 0.0f && a1 <= 0.0f && a2 <= 0.0f;
  if (!(pos || neg) || __fadd_rn(__fadd_rn(a0, a1), a2) == 0.0f) return;
  const float zw = __fdiv_rn(plane(c[9], c[10], c[11], fx, fy), plane(c[12], c[13], c[14], fx, fy));
  if (!(zw >= -1.0f && zw <= 1.0f)) return;
  const long long key = depth_key(zw, fid);
#ifdef RASTER_ABLATE_NOATOMICS
  *slot = key;
#else
  // keys only fall, so a key that is not below the one read can never win
  if (key < *(volatile long long*)slot) atomicMin(slot, key);
#endif
}

// A block's shared memory: the region's depth buffer, the list of staged
// large faces and the region's pixel-center coordinates.
template <int RW, int RH>
struct Shared {
  long long keys[RW * RH];
  float coef[15][LIST];
  int box[4][LIST];
  int fid[LIST];
  float fx[RW];
  float fy[RH];
  int count;
};

// Fills sh.keys for the region whose first pixel is (rx0, ry0): EMPTY_KEY
// where no face covers the pixel, else depth_key of the winner. Every thread
// of the block must call it (it synchronizes the block); on return every key
// is final and visible to the whole block.
template <int RW, int RH>
__device__ __forceinline__ void scatter_faces(Shared<RW, RH>& sh, const View& v, int rx0,
                                              int ry0) {
  const int tid = threadIdx.x;
  const int rx1 = min(rx0 + RW, v.W) - 1;
  const int ry1 = min(ry0 + RH, v.H) - 1;
  for (int i = tid; i < RW * RH; i += NTHREAD) sh.keys[i] = EMPTY_KEY;
  for (int i = tid; i < RW; i += NTHREAD) sh.fx[i] = pixel_center(rx0 + i, v.W);
  for (int i = tid; i < RH; i += NTHREAD) sh.fy[i] = pixel_center(ry0 + i, v.H);
  if (tid == 0) sh.count = 0;
  __syncthreads();

#ifndef RASTER_ABLATE_NOSETUP
  for (int base = 0; base < v.F; base += NTHREAD) {
    const int f = base + tid;
    Face face;
    bool large = false;  // this thread holds a face that waits for a place in the list
    if (f < v.F && setup_face(v, f, rx0, ry0, rx1, ry1, face)) {
#ifndef RASTER_ABLATE_NOTESTS
      const int area = (face.x1 - face.x0 + 1) * (face.y1 - face.y0 + 1);
      large = area > SMALL_FACE;
      if (!large) {
        // one loop over the bbox's pixels, so that a warp runs as many rounds
        // as its largest bbox has pixels, whatever the bboxes' shapes
        const int lx0 = face.x0 - rx0, lx1 = face.x1 - rx0;
        int lx = lx0, ly = face.y0 - ry0;
        for (int p = 0; p < area; ++p) {
          test_pixel(face.c, f, sh.fx[lx], sh.fy[ly], sh.keys + ly * RW + lx);
          if (++lx > lx1) {
            lx = lx0;
            ++ly;
          }
        }
      }
#else
      if (face.c[0] == 12345.0f) sh.keys[0] = 0;  // keeps the setup alive
#endif
    }
    // Large faces: staged LIST at a time, each walked by the whole block.
    while (__syncthreads_or(large)) {
      if (large) {
        const int slot = atomicAdd(&sh.count, 1);
        if (slot < LIST) {
#pragma unroll
          for (int q = 0; q < 15; ++q) sh.coef[q][slot] = face.c[q];
          sh.box[0][slot] = face.x0;
          sh.box[1][slot] = face.x1;
          sh.box[2][slot] = face.y0;
          sh.box[3][slot] = face.y1;
          sh.fid[slot] = f;
          large = false;
        }
      }
      __syncthreads();  // the list is complete
      const int staged = min(sh.count, LIST);
      for (int i = 0; i < staged; ++i) {
        float c[15];
#pragma unroll
        for (int q = 0; q < 15; ++q) c[q] = sh.coef[q][i];
        const int x0 = sh.box[0][i], y0 = sh.box[2][i];
        const int bw = sh.box[1][i] - x0 + 1;
        const int area = bw * (sh.box[3][i] - y0 + 1);
        const int fid = sh.fid[i];
        for (int p = tid; p < area; p += NTHREAD) {
          const int lx = x0 + p % bw - rx0, ly = y0 + p / bw - ry0;
          test_pixel(c, fid, sh.fx[lx], sh.fy[ly], sh.keys + ly * RW + lx);
        }
      }
      __syncthreads();  // the list is consumed before it is refilled
      if (tid == 0) sh.count = 0;  // ordered before the next add by the loop's barrier
    }
  }
#endif
  __syncthreads();  // every key has landed before the resolve reads it
}

}  // namespace raster_tile
