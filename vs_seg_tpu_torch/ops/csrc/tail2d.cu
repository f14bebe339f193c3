// tail2d — one eval (3,3,1) decoder tail per launch, for sm_90a, given the
// attention conv1 output a1 from device memory:
//
//   att    = sigmoid(conv2(a1) + b2)                             Ca -> 1
//   ga, gb = att * xa + xa, att * xb + xb
//   out    = act(conv0(ga || gb) * s + h) + (ga || gb) . wr + br  2Ch -> Cout
//
// every conv (3,3,1), stride 1, same padding: each (n, d) plane is an
// independent 2-D image. Replaces the TPU kernel
// vs_seg_tpu/ops/experimental/pallas_tail2d.py:tail_block (_tail2d_kernel),
// through ops/tail2d.py:tail_block (configuration A's up_1, 32 || 32 -> 32
// with a folded BatchNorm and a PReLU; the up_0 logit head, 16 || 16 -> 2,
// with s = 1, h = the conv bias and an identity act, under
// Routes(tail2d0=True)). As the TPU kernel does, it computes the whole tail
// per tile and recomputes the halos (att and the gated pair on +-1 rows and
// columns, so a1 on +-2) instead of writing ga or gb to device memory; its
// tap-packed Toeplitz matrices and lane rolls are MXU devices and are not
// carried over.
//
// Layout: a1, xa, xb, out NDHWC bf16, Ca and Ch in {8, 16, 24, 32}, Cout
// <= 32, bases 16-byte aligned; att (N, D, H, W) bf16. The wrapper
// (ops/tail2d.py) packs the weights once per weight tensor as wgmma's
// K-major core matrices (ops/conv333.py:pack_weights_gmma): w2 as (chunk,
// kw) 16 x 16 slabs whose column kh holds the bf16 hi term of w2[kh, kw]
// and column 8 + kh the lo term (hi = rn(w), lo = rn(w - hi): about 16
// bits, so att agrees with an f32 conv2; ops/block2d.py:pack_w2_hilo); w0
// as (chunk, tap) 16 x N slabs, the chunks of xa then those of xb; wr one
// 16 x N slab per chunk; N = 8, 16 or 32 (Cout rounded up). The epilogue
// vectors are f32 (null: scale 1, shift 0, slope 1, bias 0), staged once
// per block. Accumulation f32; att in f32 into the gate (written out
// rounded to bf16); the gated pair rounded to bf16 (as the TPU kernel
// rounds it to the working dtype); the output rounded once.
//
// What bounds it on the H100: bytes. At up_1 (8, 64, 192, 192) it must
// read a1, xa and xb (3.62 GB) and write out and att (1.25 GB) against
// 0.77 TFLOP: 1.45 ms. The parent chain (an attgate launch writing ga and
// gb, then a conv333 launch reading them back) moved about 9.7 GB. This
// design reads a1 and the pair once per tile with their halo and keeps
// att and the gated pair in shared memory. At 32 channels one 8-row tile
// stages ~145 KB and the block holds one slot of each input (one block per
// SM), so the loads of a tile do not overlap its MMAs: the staging and the
// compute add up (PERF.md: 3.6-3.8 ms at up_1 on an H100).
//
// Design.
// - Persistent walk over output tiles of TH rows x TW = 64 columns of one
//   (n, d) plane, (w, h) fastest; NWG = 4 warpgroups a block, no producer
//   warp.
// - Every grid of a tile is flat with one row pitch P = 72 positions: a1
//   and the tap partials R (rows from h0 - 2, columns from w0 - 2), the
//   x slot, att and the gated pair (from h0 - 1, w0 - 1). Then a tap (kh,
//   kw) is one flat offset kh * P + kw, and an m64 tile is 64 consecutive
//   flat positions. Positions past the ones a valid output reads are
//   computed and never used, so they are never staged either.
// - a1 (TH + 4 rows x 68 columns) is staged as 8-channel planes of 16-byte
//   positions (a wgmma K-major core matrix is 8 such rows) by 16-byte
//   cp.async copies from every thread (.ca: the pieces of a position share
//   L1 lines), neighbouring lanes on neighbouring pieces of a position;
//   positions outside the image are zero-filled (src-size 0), which is
//   conv2's padding. The next tile's copies are issued once the gate is
//   done (conv2 is then done with a1) and land under conv0.
// - conv2 as tap partials: per a1 m64 tile and 16-channel chunk, three
//   m64n16k16 (one per kw, the A descriptor shifted by kw) give R[kh][v] =
//   sum over kw and the channels of a1[v + kw] * w2[kh, kw] in columns kh
//   (hi) and 8 + kh (lo), summed into f32 arrays in shared memory; att[q]
//   = sigmoid(b2 + R[0][q] + R[1][q + P] + R[2][q + 2 P]). Each a1 value
//   is read by wgmma three times, not nine.
// - The gate, one (position, pair half) a thread, at the (TH + 2) x 66
//   positions conv0 reads: the half's 16-byte pieces loaded from device
//   memory into registers (no copy of x is staged), att from R in f32
//   (written out as bf16 at the tile's own positions), the gated half
//   rounded to bf16 (x <- rn(att * x + x)) and stored into the x slot as
//   8-channel planes. Positions outside the image are stored as zeros,
//   which is conv0's padding (the TPU kernel's _halo_zero); planes past Ch
//   (Ch = 8 or 24) are zeroed once per block.
// - conv0 with A in registers, on one m64 tile per output row (its 64
//   columns): warpgroup wg owns rows wg * R to wg * R + R - 1; per gated row
//   rho, 16-channel chunk and kw it loads one A fragment by ldmatrix (the
//   64 positions from rho * P + kw) and feeds it to the output rows rho -
//   kh, kh = 0..2 (up to three m64nNk16 with w0[kh, kw]), and at kh = kw
//   = 1 to the 1x1 residual, whose accumulators start at br and are added
//   after the act (s = 1 and slope 1 make the head's linear unit). Two A
//   fragments in flight (wgmma.wait_group 1). A is read from shared memory
//   (R + 2) / (3 R) as often as with one descriptor per tap. Stores go
//   from the registers, masked to the image, rounded once.
// - Every wgmma is unconditional (a tile past the end repeats the last
//   tile, whose copy is not stored): a wgmma under a branch on threadIdx is
//   serialized by ptxas. Epilogue constants are held in registers per tile.
// - Results do not depend on the schedule: every output value is summed by
//   one warpgroup in a fixed order.
// Bounds: any N, D, H, W with N*D*ceil(H/TH)*ceil(W/64) < 2^31 tiles and
// H*W*Cout < 2^31.

#include "common.cuh"

namespace {

constexpr int TW = 64;                   // output tile width
constexpr int P = 72;                    // row pitch of every tile grid
constexpr int NWG = 4;                   // warpgroups per block
constexpr int NTHREADS = 128 * NWG;
constexpr int KC = 16;                   // wgmma K (bf16)
constexpr int AW = TW + 4;               // a1 columns staged
constexpr int GW = TW + 2;               // gated (and x) columns staged
constexpr int SMEM_MAX = 232448;         // dynamic shared memory of a block

struct Args {
  const __nv_bfloat16 *a1, *xa, *xb;
  const __nv_bfloat16 *w2, *w0, *wr;       // packed weights
  const float *b2, *s, *h, *al, *br;       // each may be null
  int al_n;                                // 1 or cout slopes
  __nv_bfloat16 *out, *att;
  int Nb, D, H, W, Ca, Ch, cout;
  int th;                                  // tile height: 8 or 16
  int pa, px;                              // 8-channel planes holding a1, x
  int ka, kx;                              // 16-channel chunks of a1, x
  int xr, ma, mo;                          // x rows; m64 tiles of R, out
  int tiles_w, tiles_h, total;
  // shared memory, bytes
  int xplane, apitch, rpitch, off_a, off_r, off_w2, off_w0, off_wr, off_epi;
  int w2_bytes, w0_bytes, wr_bytes;
};

// The block's shared-memory layout (ops/tail2d.py:tail_layout mirrors it):
// the x slot (xa's 2 kx planes, then xb's), a1's 2 ka planes (spare
// positions past the m64 tiles, read by conv2's kw shift into rows no att
// reads), R's three f32 arrays, the weight slabs w2, w0, wr, the epilogue
// vectors (s, h, slope, br; b2). Returns its size in bytes.
static int layout(Args& a, int N) {
  a.mo = a.th;
  a.ma = ((a.th + 3) * P + 66 + 63) / 64;
  a.xr = a.th + 2;
  a.xplane = a.xr * P * 16;              // P * 16 = 9 * 128
  a.apitch = (a.ma * 64 + 8) * 16;
  a.rpitch = a.ma * 64 * 4;
  a.off_a = 2 * 2 * a.kx * a.xplane;
  a.off_r = a.off_a + 2 * a.ka * a.apitch;
  a.w2_bytes = a.ka * 3 * KC * 16 * 2;
  a.w0_bytes = 2 * a.kx * 9 * KC * N * 2;
  a.wr_bytes = 2 * a.kx * KC * N * 2;
  a.off_w2 = a.off_r + 3 * a.rpitch;
  a.off_w0 = a.off_w2 + a.w2_bytes;
  a.off_wr = a.off_w0 + a.w0_bytes;
  a.off_epi = a.off_wr + a.wr_bytes;
  return a.off_epi + (4 * N + 4) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, through L1; `bytes` 0 writes
// zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B from shared memory by
// descriptor (both K-major): d += A B, or d = A B when `add` is 0 (conv2,
// at N = 16).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int add = 1);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                              uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(add));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
__device__ __forceinline__ void wgmma_wait0() { wgmma_wait<0>(); }

// wgmma m64nNk16, bf16 x bf16 -> f32, A from registers (this thread's
// part of the warp's 16 rows, as ldmatrix_x4 leaves it), B from shared
// memory by descriptor (K-major): d += A B, or d = A B when `add` is 0.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int add = 1);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

// Four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8: this thread gets elements (l / 4, 2 (l % 4))
// and (l / 4, 2 (l % 4) + 1) of each (the wgmma / mma A fragment).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make this thread's shared-memory stores visible to the async proxy
// (wgmma); follow it with a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two 8-element K halves) and stride byte offset
// (between 8-row groups), each in 16-byte units. The low word (start, LBO)
// is built apart so that a tap's offset is one 32-bit add: the start field
// holds address / 16 < 2^14 (shared memory < 256 KB), so no sum carries
// out of it.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}
__device__ __forceinline__ uint64_t desc_of(uint32_t lo, uint32_t sbo) {
  return ((uint64_t)(sbo >> 4) << 32) | lo;
}

// This thread's part of an m64 tile's accumulators (the wgmma D fragment
// layout): element e sits in row frag_row(e & 2) = warp * 16 + lane / 4 +
// 8 (e >> 1 & 1), column (e >> 2) * 8 + (lane & 3) * 2 + (e & 1). So a
// thread holds two rows and N / 4 columns, column k = (e >> 2) * 2 + (e & 1)
// of its own.
__device__ __forceinline__ int frag_row(int e) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  return warp * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
}
__device__ __forceinline__ int own_col(int k) {
  return (k >> 1) * 8 + (threadIdx.x & 3) * 2 + (k & 1);
}

// `bytes` (a multiple of 16) from global to shared memory, all threads.
__device__ __forceinline__ void copy16(char* dst, const void* src,
                                       int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += NTHREADS) d[i] = s[i];
}

// `bytes` (a multiple of 16) of shared memory set to zero, all threads.
__device__ __forceinline__ void zero16(char* dst, int bytes) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += NTHREADS)
    d[i] = make_uint4(0, 0, 0, 0);
}

struct Tile {
  int nd, h0, w0;
  __device__ __forceinline__ Tile(int t, const Args& a) {
    const int rest = t / a.tiles_w;
    w0 = (t - rest * a.tiles_w) * TW;
    h0 = (rest % a.tiles_h) * a.th;
    nd = rest / a.tiles_h;
  }
};

// Issue the cp.async copies of column f = j / np of a `rows`-row box of
// image x (c channels, np 16-byte pieces a position) from (h0 + dh, w0 +
// dw) into np planes `pitch` bytes apart from dst: item j (lanes on
// neighbouring pieces of a position) owns piece j % np of its column and
// walks the rows; a position outside the image is zero-filled.
__device__ __forceinline__ void copy_box(uint32_t dst, int pitch,
                                         const __nv_bfloat16* x, int c,
                                         int np, int j, int rows,
                                         const Tile& g, int dh, int dw,
                                         const Args& a) {
  const int f = j / np, pc = j - f * np;
  const int ww = g.w0 + dw + f;
  const bool col = ww >= 0 && ww < a.W;
  const size_t row = (size_t)a.W * c;
  const size_t off = ((size_t)g.nd * a.H * a.W + (col ? ww : 0)) * c + pc * 8;
  dst += pc * pitch + f * 16;
  for (int r = 0, hh = g.h0 + dh; r < rows; ++r, ++hh, dst += P * 16) {
    const bool ok = col && hh >= 0 && hh < a.H;
    cp_async16(dst, x + (ok ? off + hh * row : 0), ok ? 16 : 0);
  }
}

// a1 of tile t: TH + 4 rows from h0 - 2, AW columns from w0 - 2.
__device__ __forceinline__ void copy_a1(int t, uint32_t a1s, const Args& a) {
  const Tile g(t, a);
  for (int j = threadIdx.x; j < AW * a.pa; j += NTHREADS)
    copy_box(a1s, a.apitch, a.a1, a.Ca, a.pa, j, a.th + 4, g, -2, -2, a);
}

// 16 bytes of device memory, through L1.
__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The epilogue vectors, once per block: rows s, h, slope, br of N floats
// (0 past cout), then b2.
__device__ __forceinline__ void load_epi(float* ep, int N, const Args& a) {
  for (int i = threadIdx.x; i < 4 * N + 1; i += NTHREADS) {
    float v;
    if (i < 4 * N) {
      const int row = i / N, co = i - row * N;
      const float* vec[4] = {a.s, a.h, a.al, a.br};
      const float dflt[4] = {1.f, 0.f, 1.f, 0.f};
      v = co >= a.cout ? 0.f
          : vec[row]   ? vec[row][row == 2 && a.al_n == 1 ? 0 : co]
                       : dflt[row];
    } else {
      v = a.b2 ? a.b2[0] : 0.f;
    }
    ep[i] = v;
  }
}

// Row `row` of the table (N floats from `base`) at this thread's N / 4
// accumulator columns.
template <int N>
__device__ __forceinline__ void own_cols(float (&d)[N / 4], const float* ep) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) d[k] = ep[own_col(k)];
}

// N: conv0's width (Cout rounded up); KA, KX: 16-channel chunks of a1 and
// of each pair half; R: output rows a warpgroup owns (TH = R * NWG).
template <int N, int KA, int KX, int R>
__global__ void __launch_bounds__(NTHREADS, 1) tail2d_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, wg = tid >> 7;
  char* xs = smem;
  const uint32_t xs32 = smem_u32(xs);
  const uint32_t a32 = smem_u32(smem + a.off_a);
  float* ep = reinterpret_cast<float*>(smem + a.off_epi);
  float* rs = reinterpret_cast<float*>(smem + a.off_r);
  const int rp = a.rpitch / 4;
  const uint32_t w2s = smem_u32(smem + a.off_w2);
  const uint32_t w0s = smem_u32(smem + a.off_w0);
  const uint32_t wrs = smem_u32(smem + a.off_wr);
  const int apitch = a.apitch, xplane = a.xplane;
  const int rounds_a = (a.ma + NWG - 1) / NWG;
  const bool even = (a.cout & 1) == 0;

  // the weights, the epilogue vectors and the planes past Ca and Ch, once
  // per block; then the first tile's copies
  copy16(smem + a.off_w2, a.w2, a.w2_bytes);
  copy16(smem + a.off_w0, a.w0, a.w0_bytes);
  copy16(smem + a.off_wr, a.wr, a.wr_bytes);
  load_epi(ep, N, a);
  for (int p = a.pa; p < 2 * KA; ++p)
    zero16(smem + a.off_a + p * apitch, apitch);
  for (int in = 0; in < 2; ++in)
    for (int p = a.px; p < 2 * KX; ++p)
      zero16(xs + (in * 2 * KX + p) * xplane, xplane);
  fence_async_smem();
  __syncthreads();
  if (blockIdx.x < a.total) {
    copy_a1(blockIdx.x, a32, a);
    cp_async_commit();
  }
  const float b2 = ep[4 * N];

  for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
    const Tile g(t, a);
    const bool more = t + gridDim.x < a.total;
    // pending: this tile's a1 group; every warpgroup's conv0 MMAs of the
    // last tile are done with the x slot
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();      // a1 staged

    // conv2 as tap partials: R[kh][v] = hi (column kh) + lo (8 + kh)
    {
      const uint32_t dw2 = desc_lo(w2s, 128);
      const int tq = tid & 3;
      for (int round = 0; round < rounds_a; ++round) {
        const int i = round * NWG + wg;
        float acc[8];
        wgmma_fence();
        const uint32_t da = desc_lo(a32 + min(i, a.ma - 1) * 1024, apitch);
#pragma unroll
        for (int c = 0; c < KA; ++c)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            wgmma_ss<16>(acc, desc_of(da + 2 * c * (apitch >> 4) + kw, 128),
                         desc_of(dw2 + (c * 3 + kw) * (KC * 16 * 2 / 16),
                                 256),
                         c | kw);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        if (i >= a.ma || tq >= 2) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int q = i * 64 + frag_row(2 * hr), e = 2 * hr;
          if (tq == 0) {
            rs[q] = acc[e] + acc[e + 4];
            rs[rp + q] = acc[e + 1] + acc[e + 5];
          } else {
            rs[2 * rp + q] = acc[e] + acc[e + 4];
          }
        }
      }
    }
    __syncthreads();      // R complete; conv2's reads of a1 done

    // the gate: at the (TH + 2) x (TW + 2) positions conv0 reads, x read
    // from device memory, att from R (the tile's own written out), the
    // gated pair written to the x slot; zero outside the image
    {
      const int ng = (a.th + 2) * GW;
      __nv_bfloat16* attp = a.att + (size_t)g.nd * a.H * a.W;
      for (int f = tid; f < 2 * ng; f += NTHREADS) {
        const int in = f >= ng, pos = f - in * ng;
        const int r = pos / GW, c = pos - r * GW;
        const int hh = g.h0 - 1 + r, ww = g.w0 - 1 + c;
        const bool inside = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
        const __nv_bfloat16* x =
            (in ? a.xb : a.xa) +
            (inside ? (((size_t)g.nd * a.H + hh) * a.W + ww) * a.Ch : 0);
        uint4 v[2 * KX];
#pragma unroll
        for (int p = 0; p < 2 * KX; ++p)
          v[p] = inside && p < a.px ? ld16(x + p * 8) : make_uint4(0, 0, 0, 0);
        const int q = r * P + c;
        if (inside) {
          const float z = b2 + rs[q] + rs[rp + q + P] + rs[2 * rp + q + 2 * P];
          const float s = 1.f / (1.f + expf(-z));
          if (!in && r >= 1 && r <= a.th && c >= 1 && c <= TW)
            attp[(size_t)hh * a.W + ww] = __float2bfloat16_rn(s);
#pragma unroll
          for (int p = 0; p < 2 * KX; ++p) {
            float e[8];
            unpack8(v[p], e);
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = fmaf(s, e[j], e[j]);
            v[p] = pack8(e);
          }
        }
        char* xq = xs + (in * 2 * KX * (xplane >> 4) + q) * 16;
#pragma unroll
        for (int p = 0; p < 2 * KX; ++p)
          if (p < a.px) *reinterpret_cast<uint4*>(xq + p * xplane) = v[p];
      }
    }
    fence_async_smem();
    __syncthreads();      // the gated pair complete
    // the next tile's a1 copies (conv2 is done with a1)
    if (more) copy_a1(t + gridDim.x, a32, a);
    cp_async_commit();

    // conv0 from the gated pair with A in registers: warpgroup wg owns the
    // output rows r0 to r0 + R - 1, an m64 tile each (the row's 64
    // columns, the gated positions from r * P); per gated row rho of
    // theirs, conv0 chunk k and kw, one A fragment (the 64 positions from
    // rho * P + kw, by ldmatrix) serves the output rows rho - kh, kh =
    // 0..2, with w0[kh, kw], and at kh = kw = 1 the residual, whose
    // accumulators start at br. Then the output, masked to the image.
    {
      const int r0 = wg * R;
      float acc[R][N / 2], racc[R][N / 2];
      {
        float bc[N / 4];
        own_cols<N>(bc, ep + 3 * N);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < N / 2; ++e)
            racc[i][e] = bc[(e >> 2) * 2 + (e & 1)];
      }
      const uint32_t dw0 = desc_lo(w0s, 128), dwr = desc_lo(wrs, 128);
      // this lane's ldmatrix row: matrix m = lane / 8 holds the warp's rows
      // 8 (m & 1) to 8 (m & 1) + 7 of the K half m / 2 (plane 2 c + m / 2)
      const int lane = tid & 31, m = lane >> 3;
      const uint32_t lrow =
          xs32 + (m >> 1) * xplane +
          (((tid >> 5) & 3) * 16 + (m & 1) * 8 + (lane & 7)) * 16;
      uint32_t af[2][4];
#pragma unroll
      for (int rho = 0; rho < R + 2; ++rho)
#pragma unroll
        for (int k = 0; k < 2 * KX; ++k)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int it = (rho * 2 * KX + k) * 3 + kw, b = it & 1;
            // the group of step it - 2 is done with af[b]
            if (it >= 2) wgmma_wait<1>();
            ldmatrix_x4(af[b], lrow +
                                   ((k / KX) * 2 * KX + 2 * (k % KX)) * xplane +
                                   ((r0 + rho) * P + kw) * 16);
            wgmma_fence();
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
              const int i = rho - kh;
              if (i < 0 || i >= R) continue;
              wgmma_rs<N>(acc[i], af[b],
                          desc_of(dw0 + (k * 9 + kh * 3 + kw) *
                                            (KC * N * 2 / 16),
                                  256),
                          kh | k | kw);
              if (kh == 1 && kw == 1)
                wgmma_rs<N>(racc[i], af[b],
                            desc_of(dwr + k * (KC * N * 2 / 16), 256), 1);
            }
            wgmma_commit();
          }
      wgmma_wait<0>();
      float sc[N / 4], hc[N / 4], ac[N / 4];
      own_cols<N>(sc, ep);
      own_cols<N>(hc, ep + N);
      own_cols<N>(ac, ep + 2 * N);
      __nv_bfloat16* out = a.out + (size_t)g.nd * a.H * a.W * a.cout;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        fence_regs(acc[i]);
        fence_regs(racc[i]);
        const int hh = g.h0 + r0 + i;
        if (hh >= a.H) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int ww = g.w0 + frag_row(2 * hr);
          if (ww >= a.W) continue;
          __nv_bfloat16* row = out + ((size_t)hh * a.W + ww) * a.cout;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int e = j * 4 + hr * 2, k2 = j * 2, co = own_col(k2);
            if (co >= a.cout) continue;
            float v0 = acc[i][e] * sc[k2] + hc[k2];
            float v1 = acc[i][e + 1] * sc[k2 + 1] + hc[k2 + 1];
            v0 = (v0 >= 0.f ? v0 : ac[k2] * v0) + racc[i][e];
            v1 = (v1 >= 0.f ? v1 : ac[k2 + 1] * v1) + racc[i][e + 1];
            if (even) {
              *reinterpret_cast<__nv_bfloat162*>(row + co) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              row[co] = __float2bfloat16_rn(v0);
              if (co + 1 < a.cout) row[co + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int N, int KA, int KX, int R>
int launch(Args a, int device, cudaStream_t s) {
  const int smem = layout(a, N);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // blocks per SM the shared memory allows, per device and block size
  static int sms[64] = {0}, occ_smem[64] = {0}, occ_nb[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err;
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(tail2d_kernel<N, KA, KX, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    int nsm = 0;
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[device] = nsm;
  }
  if (occ_smem[device] != smem) {
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, tail2d_kernel<N, KA, KX, R>, NTHREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_smem[device] = smem;
    occ_nb[device] = nb;
  }
  const long long cap = (long long)occ_nb[device] * sms[device];
  const int grid = (int)(a.total < cap ? a.total : cap);
  tail2d_kernel<N, KA, KX, R><<<grid, NTHREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int R>
int launch_n(const Args& a, int device, cudaStream_t s) {
  if (a.ka == 1)
    return a.kx == 1 ? launch<N, 1, 1, R>(a, device, s)
                     : launch<N, 1, 2, R>(a, device, s);
  return a.kx == 1 ? launch<N, 2, 1, R>(a, device, s)
                   : launch<N, 2, 2, R>(a, device, s);
}

}  // namespace

// s, al null with h, br given: the linear unit of the logit head (out =
// conv0 + h + residual + br). th: the tile height, 8 or (cout <= 16) 16.
extern "C" int tail2d_launch(const void* a1, const void* xa, const void* xb,
                             const void* w2, const void* w0, const void* wr,
                             const void* b2, const void* s, const void* h,
                             const void* al, int al_n, const void* br,
                             void* out, void* att, int n, int d, int hgt,
                             int w, int ca, int ch, int cout, int th,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  auto width = [](int c) { return c == 8 || c == 16 || c == 24 || c == 32; };
  if (!a1 || !xa || !xb || !w2 || !w0 || !wr || !out || !att ||
      misaligned(a1) || misaligned(xa) || misaligned(xb) || misaligned(w2) ||
      misaligned(w0) || misaligned(wr) ||
      (reinterpret_cast<uintptr_t>(out) & 3) ||
      (reinterpret_cast<uintptr_t>(att) & 1) || n < 1 || d < 1 || hgt < 1 ||
      w < 1 || !width(ca) || !width(ch) || cout < 1 || cout > 32 ||
      (th != 8 && th != 16) || (th == 16 && cout > 16) ||
      (al_n != 1 && al_n != cout))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.a1 = static_cast<const __nv_bfloat16*>(a1);
  a.xa = static_cast<const __nv_bfloat16*>(xa);
  a.xb = static_cast<const __nv_bfloat16*>(xb);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w0 = static_cast<const __nv_bfloat16*>(w0);
  a.wr = static_cast<const __nv_bfloat16*>(wr);
  a.b2 = static_cast<const float*>(b2);
  a.s = static_cast<const float*>(s);
  a.h = static_cast<const float*>(h);
  a.al = static_cast<const float*>(al);
  a.br = static_cast<const float*>(br);
  a.al_n = al_n;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.att = static_cast<__nv_bfloat16*>(att);
  a.Nb = n;
  a.D = d;
  a.H = hgt;
  a.W = w;
  a.Ca = ca;
  a.Ch = ch;
  a.cout = cout;
  a.th = th;
  a.pa = ca / 8;
  a.px = ch / 8;
  a.ka = (ca + KC - 1) / KC;
  a.kx = (ch + KC - 1) / KC;
  a.tiles_w = (w + TW - 1) / TW;
  a.tiles_h = (hgt + th - 1) / th;
  const long long total = (long long)n * d * a.tiles_h * a.tiles_w;
  if (total > 0x7fffffffLL || (long long)hgt * w * cout > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.total = (int)total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a warpgroup holds R * N / 2 accumulators of conv0 and as many of the
  // residual: TH = 16 (R = 4) at N <= 16 only
  if (cout <= 8)
    return th == 8 ? launch_n<8, 2>(a, device, st)
                   : launch_n<8, 4>(a, device, st);
  if (cout <= 16)
    return th == 8 ? launch_n<16, 2>(a, device, st)
                   : launch_n<16, 4>(a, device, st);
  return launch_n<32, 2>(a, device, st);
}
