// The observed crops of N poses, one CUDA kernel for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package warps with gather ops
// (foundationpose_cpp_tpu/ops/warp.py) and thresholds with tensor ops. This
// is the counterpart of the reference's cvcuda::WarpPerspective calls
// (TransfProcess, foundationpose_render.cpp:731-812) and of its
// threshold_and_downscale_pointcloud_kernel and concat_kernel
// (foundationpose_render.cu:61-140). Plain version: crop_observed_plain in
// ops/crop.py, the composition of ops/warp.py and ops/pointcloud.py.
//
// What it computes, per view n and crop pixel (x, y): the inverse of the
// view's crop affine (invert_affine3's closed form), the source point
// (sx, sy) = M^-1 (x, y, 1); the bilinear colour of the (H, W, 3) u8 frame
// there, each of the four corners zero outside the frame, rounded half to
// even, times the f32 of 1/255; the nearest (H, W, 3) f32 xyz sample, zero
// outside; then the threshold: a point is invalid if its z < min_depth, it is
// centred on the pose's translation and scaled by the view's downscale, and
// each coordinate is zeroed where its magnitude exceeds max_depth or the point
// is invalid. It writes (rgb | xyz) to out[n, y, x, 0:6], f32.
//
// Exactness: every product, sum and quotient is a round-to-nearest intrinsic
// in the order of the plain version's tensor ops, so nvcc contracts nothing
// into an FMA and the kernel equals the plain version on the card bit for
// bit, NaN included (a pose at z = 0 gives NaN coordinates: NaN colour, zero
// xyz). A scalar downscale multiplies by its reciprocal, taken in double and
// rounded to f32 by the caller, as PyTorch on the card divides a tensor by a
// CPU scalar; a per-view downscale divides.
//
// What bounds it on the H100: writing the output, 24 bytes a crop pixel
// (154.8 MB at 252 views of 160x160, 0.046 ms at 3.35 TB/s); the frame (0.9 MB
// of u8 RGB, 3.7 MB of xyz at 480x640) stays in the 50 MB L2, and the ~60 f32
// operations a pixel are nothing at the CUDA cores' rate.
//
// What the design does about it: one thread a crop pixel of one view,
// dim3(pixel blocks, N); thread 0 of a block inverts the view's affine and
// reads its translation and downscale once into shared memory. Neighbouring
// threads take neighbouring pixels of a row, so a warp's 32 x 24 bytes of
// output are contiguous. No index, mask or intermediate crop reaches device
// memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREAD = 256;

struct View {
  float inv[6];  // rows 0 and 1 of M^-1
  float t[3];    // the pose's translation
  float scale;   // the reciprocal of a scalar downscale, or the view's downscale
};

// Channel k of a corner of the u8 frame: 0 outside it.
__device__ __forceinline__ float corner(const uint8_t* __restrict__ rgb, float xc, float yc, int h,
                                        int w, int k) {
  const bool inb = xc >= 0.0f && xc < (float)w && yc >= 0.0f && yc < (float)h;
  return inb ? (float)rgb[((long long)(int)yc * w + (int)xc) * 3 + k] : 0.0f;
}

__global__ void __launch_bounds__(NTHREAD) crop_kernel(
    const uint8_t* __restrict__ rgb, const float* __restrict__ xyz,
    const float* __restrict__ tfs, const float* __restrict__ poses,
    const float* __restrict__ downscale, float inv_downscale, float* __restrict__ out,
    int rgb_h, int rgb_w, int xyz_h, int xyz_w, int ch, int cw, float min_depth,
    float max_depth) {
  __shared__ View view;
  const int n = blockIdx.y;
  if (threadIdx.x == 0) {
    // invert_affine3 (geometry/transforms.py), operation by operation
    const float* m = tfs + 9LL * n;
    const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];
    const float det = __fsub_rn(__fmul_rn(a, e), __fmul_rn(b, d));
    const float ia = __fdiv_rn(e, det), ib = __fdiv_rn(-b, det);
    const float id = __fdiv_rn(-d, det), ie = __fdiv_rn(a, det);
    view.inv[0] = ia;
    view.inv[1] = ib;
    view.inv[2] = -__fadd_rn(__fmul_rn(ia, c), __fmul_rn(ib, f));
    view.inv[3] = id;
    view.inv[4] = ie;
    view.inv[5] = -__fadd_rn(__fmul_rn(id, c), __fmul_rn(ie, f));
    const float* p = poses + 16LL * n;
    view.t[0] = p[3];
    view.t[1] = p[7];
    view.t[2] = p[11];
    view.scale = downscale != nullptr ? downscale[n] : inv_downscale;
  }
  __syncthreads();
  const int pix = blockIdx.x * NTHREAD + threadIdx.x;
  if (pix >= ch * cw) return;
  const float x = (float)(pix % cw), y = (float)(pix / cw);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(view.inv[0], x), __fmul_rn(view.inv[1], y)),
                             view.inv[2]);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(view.inv[3], x), __fmul_rn(view.inv[4], y)),
                             view.inv[5]);
  float px[6];

  // bilinear u8 colour (warp_crop_linear_u8)
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
  const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float w00 = __fmul_rn(gx, gy), w10 = __fmul_rn(fx, gy);
  const float w01 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float s = __fadd_rn(__fmul_rn(corner(rgb, x0, y0, rgb_h, rgb_w, k), w00),
                        __fmul_rn(corner(rgb, x1, y0, rgb_h, rgb_w, k), w10));
    s = __fadd_rn(s, __fmul_rn(corner(rgb, x0, y1, rgb_h, rgb_w, k), w01));
    s = __fadd_rn(s, __fmul_rn(corner(rgb, x1, y1, rgb_h, rgb_w, k), w11));
    px[k] = __fmul_rn(rintf(s), (float)(1.0 / 255.0));
  }

  // nearest xyz (warp_crop_nearest_f32), then the threshold
  // (threshold_and_downscale_pointcloud)
  const float xr = rintf(sx), yr = rintf(sy);
  const bool inb = xr >= 0.0f && xr < (float)xyz_w && yr >= 0.0f && yr < (float)xyz_h;
  const float* src = xyz + ((long long)(inb ? (int)yr : 0) * xyz_w + (inb ? (int)xr : 0)) * 3;
  float v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = inb ? src[k] : 0.0f;
  const bool invalid = v[2] < min_depth;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float centred = __fsub_rn(v[k], view.t[k]);
    const float scaled = downscale != nullptr ? __fdiv_rn(centred, view.scale)
                                              : __fmul_rn(centred, view.scale);
    px[3 + k] = (fabsf(scaled) > max_depth || invalid) ? 0.0f : scaled;
  }

  float2* dst = reinterpret_cast<float2*>(out + ((long long)n * ch * cw + pix) * 6);
  dst[0] = make_float2(px[0], px[1]);
  dst[1] = make_float2(px[2], px[3]);
  dst[2] = make_float2(px[4], px[5]);
}

}  // namespace

// rgb (rgb_h, rgb_w, 3) u8, xyz (xyz_h, xyz_w, 3) f32, tfs (N, 3, 3) f32,
// poses (N, 4, 4) f32, downscale (N,) f32 or null (then inv_downscale holds
// the f32 of the number's reciprocal), out (N, ch, cw, 6) f32, all
// contiguous. Returns cudaGetLastError() after the launch (0 when it was
// taken).
extern "C" int fp_crop_observed(const void* rgb, const void* xyz, const void* tfs,
                                const void* poses, const void* downscale, float inv_downscale,
                                void* out, int N, int rgb_h, int rgb_w, int xyz_h, int xyz_w,
                                int ch, int cw, float min_depth, float max_depth, void* stream) {
  const unsigned int blocks = (unsigned int)((ch * cw + NTHREAD - 1) / NTHREAD);
  crop_kernel<<<dim3(blocks, (unsigned int)N), NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<const float*>(xyz),
      static_cast<const float*>(tfs), static_cast<const float*>(poses),
      static_cast<const float*>(downscale), inv_downscale, static_cast<float*>(out), rgb_h,
      rgb_w, xyz_h, xyz_w, ch, cw, min_depth, max_depth);
  return (int)cudaGetLastError();
}
