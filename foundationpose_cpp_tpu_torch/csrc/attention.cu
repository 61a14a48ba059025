// Multi-head attention for Hopper (sm_90a): one kernel body per dtype, two
// layouts (the packed qkv projection and head-split q, k, v).
//
// Replaces: the Pallas TPU kernels `_kernel_packed` (launched by
// `mha_packed_qkv`) and `_kernel` (launched by `mha_whole_head`) in
// foundationpose_cpp_tpu/ops/attention_pallas.py.
// Plain versions: mha_packed_qkv_plain and mha_whole_head_plain in
// ops/attention.py; _core_blockwise_plain there walks this file's two passes
// tile by tile.
//
// What it computes, per (batch b, head h): softmax((q * scale) k^T) v. Where
// head h's rows live is given by element strides (batch, head, token) shared
// by q, k and v, and by the output's own strides:
//   packed (B, T, 3D): q, k, v at column offsets 0, D, 2D of the projection,
//     strides (T*3D, hd, 3D); output (B, T, D), strides (T*D, hd, D);
//   head-split (B, H, T, hd): strides (H*T*hd, T*hd, hd) for all four.
// Numerics follow the Pallas kernels: q is scaled in f32 and cast to k's
// dtype; logits accumulate in f32; the softmax is exact over the whole row
// (max-subtract, exp, multiply by 1/sum); P is cast to v's dtype after it is
// normalised; P.v accumulates in f32 and the output is in q's dtype. So in
// bf16 q and P are rounded to bf16, and in f32 nothing is rounded between the
// steps.
//
// What bounds it on the H100: at the main path's packed shape (B=252, T=400,
// D=512, 4 heads of 128) the function reads 310 MB and writes 103 MB, about
// 0.12 ms at 3.35 TB/s, and needs 82.6 GFLOP, about 0.08 ms at 989 TFLOP/s of
// bf16 tensor-core rate: memory-bound. This design computes q k^T twice (124
// GFLOP, 0.125 ms at the peak rate), level with the byte bound. What it is
// up against in practice: the traffic from L2 into shared memory (each block
// streams its head's k twice and v once; 7.5 TB/s was measured for whole
// 128-byte lines), the tensor cores' rate on 64-key tiles whose two operands
// both come from shared memory, and the exps (two per logit, 16 a clock an
// SM); the last two still run one after the other inside a warpgroup. The
// head-split narrow net of the dataset path (B=252, 4 heads of 16, T=16) is a
// few MB: a launch's cost. In f32 there are no tensor cores to use without
// TF32's rounding: 82.6 GFLOP at 67 TFLOP/s, 1.23 ms.
//
// The bf16 design. A block is 1 or 2 warpgroups (2 for heads wider than 64
// when T and the launch are large enough to fill the card with such blocks); a warpgroup takes 64 query
// rows of one (b, h), 16 rows a warp. The block's q rows (scaled, rounded)
// sit in shared memory; the head's k and v stream through a ring of NSLOT
// shared-memory slots of one 64-key tile each, filled by the Tensor Memory
// Accelerator three slots ahead of the MMAs that read them: one thread asks
// for a tile's boxes through a tensor map over (columns, tokens, planes),
// rows at or past T arrive as zeros, and an mbarrier per slot counts the
// bytes that landed; one __syncthreads a tile hands the slot back. (Copying
// with cp.async from the warps that multiply cost 0.15 of 0.51 ms at the
// main shape: a warp stalls on its copy instructions while the memory system
// takes them.) All tiles are in the tensor cores' 128/64/32-byte swizzled layout,
// which the copy engine writes, so both products run as wgmma.mma_async
// straight from shared memory. Nothing of size T is kept:
//   pass A streams k, computes S = Q K^T (wgmma m64n64k16, q and k K-major,
//     f32 accumulators in registers) and keeps each row's running max m and
//     sum l of exp(s - m) in registers;
//   pass B streams v and k again, from the last tile back (the last tile's S
//     is still in registers, so with T <= 64 nothing is computed twice),
//     recomputes S, forms p = exp(s - m) / l with the final m and l, rounds p
//     to bf16 in registers (S's accumulator fragment is P's A fragment) and
//     feeds the P.V wgmma (A from registers, v N-major through the transpose
//     bit); O stays in registers and is written once, 16 bytes a thread,
//     through the warp's own rows of the q tile.
// Why two passes: FlashAttention's single pass rounds the unnormalised
// exp(s - m) to bf16 and divides at the end. On short rows (T=16, hd=16)
// that lands 1.5x outside the tolerance this kernel is held to against the
// plain version, which normalises before it rounds as the Pallas kernels
// do; only a kernel that knows m and l before the P.V pass can do the same.
// Logits of keys at or past T are set to -inf before the max; query rows at
// or past T are computed on zeros and not stored.
//
// The f32 design, on the CUDA cores: a block of 128 threads takes 64 query
// rows; thread (ty, tx) of a 16 x 8 grid owns rows ty + 16 r (r < 4) of S and
// O, keys tx + 8 i (i < 4) of each 32-key tile and hd / 8 columns of O, so
// that one 16-byte shared-memory load feeds 4 or more FMAs. k and v tiles
// arrive through a ring filled by cp.async, 16 bytes a thread (rows padded by
// 16 bytes against bank conflicts). One pass with the online rescale (nothing is
// rounded between the steps in f32); P crosses between the threads of a row
// through a 64 x 32 shared-memory tile.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Warpgroups (64 query rows each) of the bf16 body's wide block, which takes
// launches that fill the card; small launches take blocks of one warpgroup.
// tools/attention_tile_sweep.py builds and times other values.
#ifndef MHA_WARPGROUPS
#define MHA_WARPGROUPS 2
#endif

constexpr int WIDE = MHA_WARPGROUPS;
constexpr int BN = 64;    // keys per tile (bf16)
constexpr int NSLOT = 4;  // ring slots, one k or v tile each
// The f32 body's shared-memory rows are padded by 16 bytes: a row of hd floats
// is a multiple of 64 bytes, so unpadded rows would start in the same banks;
// with the pad, the 8 rows a quarter-warp's 16-byte loads read at once fall
// in distinct banks for every hd that is a multiple of 16.
constexpr int PAD_F32 = 4;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int F_BM = 64;  // query rows per block (f32)
constexpr int F_BN = 32;  // keys per tile (f32)
constexpr int F_NTHREAD = 128;

static_assert(WIDE >= 1 && WIDE <= 8, "warpgroups of the wide block");

// Where one (b, h) lives: element strides (batch, head, token) shared by q,
// k and v, and the output's own.
struct Layout {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sb, sh, st;
  long long ob, oh, ot;
  // k and v as 3-d tensors (columns, tokens, z) for the bf16 body's tensor
  // maps: head h of batch row b starts at column h * col_per_head of plane
  // b * z_per_batch + h * z_per_head. Packed: W = D columns, z = b.
  // Head-split: W = hd columns, z = b * H + h.
  int map_cols, map_planes;
  int col_per_head, z_per_batch, z_per_head;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is not
// read then, but stays a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's earlier shared-memory writes (st.shared, cp.async)
// visible to the tensor cores' asynchronous reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory: arrivals and landed bytes complete a phase, and
// a waiter names the parity of the phase it waits for.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also tells the barrier how many bytes the copies started
// after it will land.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread asks the Tensor Memory Accelerator for the box at (c0, c1, c2)
// of a 3-d tensor map: the box lands in dst in the map's swizzled layout
// (zeros where it runs past the tensor) and its bytes count at the barrier.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin N registers at this point of the program: the compiler may not move
// their last write below it nor their next read above it (wgmma reads and
// writes registers asynchronously, between its fence and its wait).
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a wgmma operand in a swizzled layout
// (mode 1, 2, 3: rows of 128, 64, 32 bytes). K-major (q, k): sbo is the byte
// stride between groups of 8 rows, lbo is not used. N-major (v, through the
// instruction's transpose bit): sbo between groups of 8 keys, lbo between
// column blocks.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo, int sbo, int mode) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

// d (64 x 64 f32, this thread's 32 values) = or += a (64 x 16 bf16, K-major
// in shared memory) . b (16 x 64 bf16, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N f32) += a (64 x 16 bf16, this thread's 4 registers of the
// fragment) . b (16 x N bf16, N-major in shared memory: the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x by the special-function unit (relative error 2^-22, far inside bf16's
// 2^-9); 2^-inf is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The f32 body's tile copy: start the copy of token rows [r0, r0 + F_BN) of
// one head (HD floats from src + token * st) into dst[F_BN][HD + PAD_F32],
// zeros for rows at or past T. 16 bytes a copy: HD and st are multiples of 4
// floats and src is 16-byte aligned (the wrapper checks).
template <int HD>
__device__ __forceinline__ void load_tile_padded(float* dst, const float* src, int r0, int T,
                                                 long long st) {
  constexpr int PER_ROW = HD / 4;
  constexpr int TOTAL = F_BN * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < TOTAL; i0 += F_NTHREAD) {  // a multiple of 128: hd is one of 16
    const int i = i0 + threadIdx.x;
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    const bool valid = r0 + r < T;
    cp_async_16(dst + r * (HD + PAD_F32) + c, valid ? src + (long long)(r0 + r) * st + c : src,
                valid);
  }
}

// The bf16 body's shared-memory layout of a [ROWS][HD] tile, the swizzled
// one that the copy engine writes and the tensor cores read: the tile is cut
// into column blocks of SWB bytes a row (128, 64 or 32: the widest that
// divides a row of hd bf16), one box of a tensor map each, block cb at byte
// cb * ROWS * SWB, row r of a block at r * SWB, and the 16-byte chunk cc of
// that row at chunk cc ^ (bits 7.. of the row's address), so that the 8 rows
// of one chunk column, which a wgmma reads together, fall in distinct banks.
// The q tile is written in it by plain stores, and the output staged through
// it. Tiles start at multiples of 1024 bytes.
template <int HD>
struct Swizzle {
  static constexpr int BYTES = HD % 64 == 0 ? 128 : (HD % 32 == 0 ? 64 : 32);
  static constexpr int CHUNKS = BYTES / 16;  // chunks per row of a block
  static constexpr int COLS = BYTES / 2;     // elements per row of a block
  static constexpr int MODE = BYTES == 128 ? 1 : (BYTES == 64 ? 2 : 3);  // the descriptor's code
};

// Element offset of 16-byte chunk c (columns 8 c .. 8 c + 7) of row r.
template <int HD, int ROWS>
__device__ __forceinline__ int tile_off(int r, int c) {
  using S = Swizzle<HD>;
  const int cb = c / S::CHUNKS;
  const int cc = c % S::CHUNKS;
  return cb * (ROWS * S::COLS) + r * S::COLS + ((cc ^ ((r * S::BYTES / 128) % S::CHUNKS)) * 8);
}

// Logits of keys at or past T become -inf. Value c of n-tile nt (s[4 nt + c])
// is key key0 + nt * 8 + 2 * (lane % 4) + (c & 1), row lane / 4 + 8 * (c / 2).
__device__ __forceinline__ void mask_keys(float* s, int key0, int T, int lane) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int key = key0 + nt * 8 + 2 * (lane % 4);
    if (key >= T) s[4 * nt] = s[4 * nt + 2] = -INFINITY;
    if (key + 1 >= T) s[4 * nt + 1] = s[4 * nt + 3] = -INFINITY;
  }
}

template <int HD, int NWG>
__global__ void __launch_bounds__(NWG * 128, NWG <= 2 ? 2 : 1)
mha_bf16_kernel(Layout L, int T, float scale, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap) {
  using E = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char smem[];
  using S = Swizzle<HD>;
  constexpr int BM = NWG * 64;
  constexpr int NTHREAD = NWG * 128;
  constexpr int SLOT = BN * HD;
  constexpr int NCH = S::COLS;           // columns of O one P.V wgmma covers: one column block
  E* ring = reinterpret_cast<E*>(smem);  // [NSLOT] tiles of [BN][HD], swizzled
  E* Qs = ring + NSLOT * SLOT;           // [BM][HD], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + BM * HD);  // [NSLOT]: the slot's tile landed

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * L.sb + (long long)h * L.sh;
  const E* q = static_cast<const E*>(L.q) + in_off;
  E* o = static_cast<E*>(L.o) + (long long)b * L.ob + (long long)h * L.oh;
  const int wg = threadIdx.x / 128;  // warpgroup: 64 query rows, 16 a warp
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = wg * 64;                // the warpgroup's first row of the q tile
  const bool active = q0 + row0 < T;       // a warpgroup past T only keeps the barriers

  // The stream of tiles through the ring: k_0 .. k_{n-1} (pass A), then pass B
  // from the last tile back: v_{n-1} (its logits are still in registers from
  // pass A), then k_j, v_j for j = n - 2 .. 0.
  const int n = (T + BN - 1) / BN;
  const int total = 3 * n - 1;
  // Thread 0 starts step s's copy: one box of 64 tokens for each column block
  // of the head, which the copy engine swizzles as it writes; the slot's
  // barrier completes when all their bytes have landed. Step s uses slot
  // s % NSLOT for the (s / NSLOT)-th time, which is the parity to wait for.
  auto start_copy = [&](int s) {
    if (s >= total) return;
    int tile = s;
    bool is_v = false;
    if (s >= n) {
      const int r = s - n;  // 0: v_{n-1}; then pairs k_j, v_j
      is_v = r == 0 || r % 2 == 0;
      tile = r == 0 ? n - 1 : n - 2 - (r - 1) / 2;
    }
    uint64_t* bar = full + s % NSLOT;
    E* dst = ring + (s % NSLOT) * SLOT;
    mbar_expect_bytes(bar, SLOT * (int)sizeof(E));
#pragma unroll
    for (int cb = 0; cb < HD / S::COLS; ++cb)
      tma_load_3d(dst + cb * BN * S::COLS, is_v ? &vmap : &kmap, bar,
                  h * L.col_per_head + cb * S::COLS, tile * BN,
                  b * L.z_per_batch + h * L.z_per_head);
  };
  // Refill the slot that step s - 1 read (every wgmma on it has been waited
  // for once all threads pass the barrier), then wait for step s's tile. The
  // copies are one thread's few instructions, so the warps that multiply
  // never stall on them.
  auto acquire = [&](int s) -> const E* {
    __syncthreads();
    if (threadIdx.x == 0) start_copy(s + NSLOT - 1);
    mbar_wait(full + s % NSLOT, (s / NSLOT) & 1);
    return ring + (s % NSLOT) * SLOT;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < NSLOT; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < NSLOT - 1; ++s) start_copy(s);
  }

  // q tile: scaled in f32 and rounded back to bf16, as the Pallas kernels do;
  // the fence after it and the first acquire's barrier publish it, and the
  // barriers' initial state, to every thread and to the tensor cores
  for (int i = threadIdx.x; i < BM * (HD / 8); i += NTHREAD) {
    const int r = i / (HD / 8);
    const int c = i % (HD / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < T) x = *reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * L.st + c * 8);
    __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(x2[j]);
      x2[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(Qs + tile_off<HD, BM>(r, c)) = x;
  }
  fence_proxy_async();

  // S = Q K^T for the warpgroup's 64 rows and the tile's 64 keys: one wgmma
  // per 16 columns of hd, q and k both K-major (8-row groups 8 * SWB bytes
  // apart); a step of 16 columns is 32 bytes further along the row, or in
  // the next column block
  constexpr int GROUP = 8 * S::BYTES;
  const uint64_t desc_q = wgmma_desc(Qs + row0 * S::COLS, 16, GROUP, S::MODE);
  auto qk_tile = [&](float* s, const E* Ks) {
    const uint64_t desc_k = wgmma_desc(Ks, 16, GROUP, S::MODE);
    pin<BN / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      constexpr int CH = S::CHUNKS;  // descriptor addresses count 16 bytes
      wgmma_ss_n64(s, desc_q + (uint64_t)((2 * kk / CH) * (BM * CH) + 2 * kk % CH),
                   desc_k + (uint64_t)((2 * kk / CH) * (BN * CH) + 2 * kk % CH), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin<BN / 2>(s);
  };

  // This thread's values of S: n-tile nt (8 keys), value c: s[4 nt + c] is row
  // lane / 4 + 8 (c / 2) of the warp's 16, key 8 nt + 2 (lane % 4) + (c & 1)
  float s[BN / 2];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  int step = 0;

  // pass A: running max and sum of exp over all keys (base 2: m is kept
  // times log2 e)
  for (int j = 0; j < n; ++j) {
    const E* Ks = acquire(step++);
    if (!active) continue;
    qk_tile(s, Ks);
    if (j == n - 1) mask_keys(s, j * BN, T, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * LOG2E);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        sum += ex2(fmaf(s[4 * nt + 2 * r], LOG2E, -m_new));
        sum += ex2(fmaf(s[4 * nt + 2 * r + 1], LOG2E, -m_new));
      }
      // the 4 lanes of a row share m, so their partial sums scale alike and
      // are added up once, after the pass
      l[r] = l[r] * ex2(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv_l[r] = 1.0f / sum;
  }

  // pass B, from the last tile back: P = exp(S - m) / l rounded to bf16 in
  // registers, O += P . V
  float acc[HD / 2];  // n-tile nt of O's columns, value c: acc[4 nt + c], rows as in s
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  for (int j = n - 1; j >= 0; --j) {
    if (j < n - 1) {  // only the last tile has keys past T, and pass A masked it
      const E* Ks = acquire(step++);
      if (active) qk_tile(s, Ks);
    }
    const E* Vs = acquire(step++);
    if (!active) continue;
    // S's accumulator fragment is P's A fragment: for keys 16 kk .. 16 kk + 15,
    // a0, a1 are rows g, g + 8 at keys 2t, 2t + 1 and a2, a3 the same 8 keys on
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = 4 * (2 * kk + i / 2) + 2 * (i % 2);
        const int r = i % 2;
        pf[kk][i] = pack_bf16(ex2(fmaf(s[at], LOG2E, -m[r])) * inv_l[r],
                              ex2(fmaf(s[at + 1], LOG2E, -m[r])) * inv_l[r]);
      }
    }
    // v is N-major: one column block a wgmma, 8-key groups 8 * SWB bytes apart
    const uint64_t desc_v = wgmma_desc(Vs, BN * S::BYTES, GROUP, S::MODE);
    pin<BN / 4>(&pf[0][0]);
    pin<HD / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < HD / NCH; ++c)
        wgmma_rs<NCH>(acc + c * (NCH / 2), pf[kk],
                      desc_v + (uint64_t)((c * BN + kk * 16) * S::CHUNKS));
    }
    wgmma_commit();
    wgmma_wait();
    pin<HD / 2>(acc);
  }

  // epilogue: each warp rounds its 16 rows into its own rows of the q tile
  // (no other warp's threads touch them; the warpgroup's wgmmas that read
  // them have been waited for) and writes them out 16 bytes a thread
  if (!active) return;
  const int wrow = row0 + warp * 16;
  {
    const int g = lane / 4;
    const int t2 = 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(Qs + tile_off<HD, BM>(wrow + g, nt) + t2) =
          pack_bf16(acc[4 * nt], acc[4 * nt + 1]);
      *reinterpret_cast<uint32_t*>(Qs + tile_off<HD, BM>(wrow + g + 8, nt) + t2) =
          pack_bf16(acc[4 * nt + 2], acc[4 * nt + 3]);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * (HD / 8); i += 32) {
    const int r = wrow + i / (HD / 8);
    const int c = i % (HD / 8);
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(o + (long long)(q0 + r) * L.ot + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + tile_off<HD, BM>(r, c));
  }
}

// A vector of W floats (W = 2 or 4) loaded in one instruction.
template <int W>
struct FloatVec;
template <>
struct FloatVec<4> {
  using type = float4;
};
template <>
struct FloatVec<2> {
  using type = float2;
};

// The same function in f32 on the CUDA cores, one pass: products and sums in
// f32, nothing rounded between the steps, O rescaled as the running max
// moves and divided by the sum at the end.
template <int HD>
__global__ void __launch_bounds__(F_NTHREAD, 2) mha_f32_kernel(Layout L, int T, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HD + PAD_F32;
  constexpr int SLOT = F_BN * LD;
  constexpr int LDP = F_BN + PAD_F32;
  constexpr int VW = HD % 32 == 0 ? 4 : 2;  // floats per load of v, and per store of O
  constexpr int NG = HD / (8 * VW);         // such groups per thread
  using Vec = typename FloatVec<VW>::type;
  float* ring = reinterpret_cast<float*>(smem);  // [NSLOT][F_BN][LD]
  float* Qs = ring + NSLOT * SLOT;               // [F_BM][LD]
  float* Ps = Qs + F_BM * LD;                    // [F_BM][LDP]

  const int q0 = blockIdx.x * F_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * L.sb + (long long)h * L.sh;
  const float* q = static_cast<const float*>(L.q) + in_off;
  const float* k = static_cast<const float*>(L.k) + in_off;
  const float* v = static_cast<const float*>(L.v) + in_off;
  float* o = static_cast<float*>(L.o) + (long long)b * L.ob + (long long)h * L.oh;
  // rows ty + 16 r: the 4 ty of a warp read consecutive rows, whose padded
  // strides fall in distinct banks. A row's 8 threads are in one warp.
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;

  // the stream of tiles: k_0, v_0, k_1, v_1, ...
  const int n = (T + F_BN - 1) / F_BN;
  const int total = 2 * n;
  auto start_copy = [&](int s) {
    if (s < total)
      load_tile_padded<HD>(ring + (s % NSLOT) * SLOT, s % 2 ? v : k, (s / 2) * F_BN, T, L.st);
    cp_async_commit();
  };
  auto acquire = [&](int s) -> const float* {
    cp_async_wait<NSLOT - 2>();
    __syncthreads();
    start_copy(s + NSLOT - 1);
    return ring + (s % NSLOT) * SLOT;
  };
#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) start_copy(s);

  // q tile, scaled; the first acquire's barrier publishes it
  for (int i = threadIdx.x; i < F_BM * (HD / 4); i += F_NTHREAD) {
    const int r = i / (HD / 4);
    const int c = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < T) x = *reinterpret_cast<const float4*>(q + (long long)(q0 + r) * L.st + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * LD + c) = x;
  }

  float acc[4][NG * VW];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[r][c] = 0.0f;
  }

  int step = 0;
  for (int j = 0; j < n; ++j) {
    const float* Ks = acquire(step++);
    // S: 4 rows x 4 keys a thread, 16 bytes of q and of k a load
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kv[i] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * i) * LD + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[r][i] += qv[r].x * kv[i].x;
          s[r][i] += qv[r].y * kv[i].y;
          s[r][i] += qv[r].z * kv[i].z;
          s[r][i] += qv[r].w * kv[i].w;
        }
      }
    }
    if (j == n - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (j * F_BN + tx + 8 * i >= T) s[0][i] = s[1][i] = s[2][i] = s[3][i] = -INFINITY;
      }
    }
    // online softmax: the tile's unnormalised exp against the running max
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[r][i] - m_new);
        sum += p;
        Ps[(ty + 16 * r) * LDP + tx + 8 * i] = p;
      }
      l[r] = l[r] * alpha + sum;  // a thread's share of the row's sum
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NG * VW; ++c) acc[r][c] *= alpha;
    }
    // a row of P is written and read by the 8 threads of one warp only; the
    // barrier in acquire orders it
    const float* Vs = acquire(step++);
#pragma unroll 2
    for (int kk = 0; kk < F_BN; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * r) * LDP + kk);
#pragma unroll
      for (int key = 0; key < 4; ++key) {
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          const Vec vv =
              *reinterpret_cast<const Vec*>(Vs + (kk + key) * LD + tx * VW + 8 * VW * c);
          const float* ve = reinterpret_cast<const float*>(&vv);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = reinterpret_cast<const float*>(&pv[r])[key];
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[r][c * VW + e] += p * ve[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const float inv = 1.0f / sum;
    const int row = q0 + ty + 16 * r;
    if (row < T) {
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        Vec out;
        float* oe = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int e = 0; e < VW; ++e) oe[e] = acc[r][c * VW + e] * inv;
        *reinterpret_cast<Vec*>(o + (long long)row * L.ot + tx * VW + 8 * VW * c) = out;
      }
    }
  }
}

// libcuda's tensor-map encoder, asked for through the runtime so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// k or v of every head as (columns, tokens, planes) in bf16, read in boxes of
// one swizzled column block by 64 tokens; rows past T read as zeros.
template <int HD>
cudaError_t make_tensor_map(CUtensorMap* map, const void* base, const Layout& L, int T) {
  using S = Swizzle<HD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)L.map_cols, (cuuint64_t)T, (cuuint64_t)L.map_planes};
  const long long plane = L.z_per_head ? L.sh : L.sb;  // elements between planes
  const cuuint64_t strides[2] = {(cuuint64_t)L.st * 2, (cuuint64_t)plane * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)S::COLS, (cuuint32_t)BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = S::BYTES == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : S::BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, int NWG>
cudaError_t launch_bf16(const Layout& L, int B, int H, int T, float scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  cudaError_t err = make_tensor_map<HD>(&kmap, L.k, L, T);
  if (err == cudaSuccess) err = make_tensor_map<HD>(&vmap, L.v, L, T);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(NSLOT * BN + NWG * 64) * HD * sizeof(__nv_bfloat16) +
                      NSLOT * sizeof(uint64_t);
  err = cudaFuncSetAttribute(mha_bf16_kernel<HD, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + NWG * 64 - 1) / (NWG * 64), H, B);
  mha_bf16_kernel<HD, NWG><<<grid, NWG * 128, smem, stream>>>(L, T, scale, kmap, vmap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Layout& L, int B, int H, int T, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(NSLOT * F_BN + F_BM) * (HD + PAD_F32) +
                       (size_t)F_BM * (F_BN + PAD_F32)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mha_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + F_BM - 1) / F_BM, H, B);
  mha_f32_kernel<HD><<<grid, F_NTHREAD, smem, stream>>>(L, T, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Layout& L, int B, int H, int T, float scale, bool f32,
                      cudaStream_t stream) {
  if (f32) return launch_f32<HD>(L, B, H, T, scale, stream);
  // Wide blocks share each k/v tile among more query rows (less traffic from
  // L2), but there are fewer of them: take them when T fills one and they
  // fill the 132 SMs, and only for heads wider than 64, whose tiles are large
  // (at hd = 64 an SM holds three or more one-warpgroup blocks, which measured
  // faster: 0.47 against 0.52 ms at (252, 8, 400, 64)).
  if constexpr (WIDE > 1 && HD > 64) {
    const long long wide_blocks = (long long)B * H * ((T + WIDE * 64 - 1) / (WIDE * 64));
    if (T >= WIDE * 64 && wide_blocks >= 132)
      return launch_bf16<HD, WIDE>(L, B, H, T, scale, stream);
  }
  return launch_bf16<HD, 1>(L, B, H, T, scale, stream);
}

cudaError_t launch(const Layout& L, int B, int H, int T, int hd, float scale, bool f32,
                   cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<16>(L, B, H, T, scale, f32, stream);
    case 32: return launch_hd<32>(L, B, H, T, scale, f32, stream);
    case 48: return launch_hd<48>(L, B, H, T, scale, f32, stream);
    case 64: return launch_hd<64>(L, B, H, T, scale, f32, stream);
    case 80: return launch_hd<80>(L, B, H, T, scale, f32, stream);
    case 96: return launch_hd<96>(L, B, H, T, scale, f32, stream);
    case 112: return launch_hd<112>(L, B, H, T, scale, f32, stream);
    case 128: return launch_hd<128>(L, B, H, T, scale, f32, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (B, T, 3H*hd) packed projection -> (B, T, H*hd); f32 != 0 for float32
// tensors, else bf16.
extern "C" int fp_mha_packed_qkv(const void* qkv, void* out, int B, int T, int H, int hd,
                                 float scale, int f32, void* stream) {
  const long long D = (long long)H * hd;
  const size_t esize = f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  Layout L{base, base + D * esize, base + 2 * D * esize, out,
           T * 3 * D, hd, 3 * D, T * D, hd, D,
           (int)D, B, hd, 1, 0};
  return (int)launch(L, B, H, T, hd, scale, f32 != 0, static_cast<cudaStream_t>(stream));
}

// Head-split (B, H, T, hd) q, k, v -> (B, H, T, hd).
extern "C" int fp_mha_whole_head(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int T, int hd, float scale, int f32, void* stream) {
  const long long sh = (long long)T * hd;
  Layout L{q, k, v, out, H * sh, sh, hd, H * sh, sh, hd, hd, B * H, 0, H, 1};
  return (int)launch(L, B, H, T, hd, scale, f32 != 0, static_cast<cudaStream_t>(stream));
}
