// l2block2d — one eval (3,3,1) decoder attention block per launch, for
// sm_90a:
//
//   a1     = relu(conv1(xa || xb) + b1)                         2C -> C
//   att    = sigmoid(conv2(a1) + b2)                             C -> 1
//   ga, gb = att * xa + xa, att * xb + xb
//   out    = act(conv0(ga || gb) * s + h) + (ga || gb) . wr + br  2C -> Cout
//
// every conv (3,3,1), stride 1, same padding: each (n, d) plane is an
// independent 2-D image. Replaces the TPU kernel
// vs_seg_tpu/ops/experimental/pallas_block2d.py:l2_block2d (_l2_2d_kernel),
// through ops/block2d.py:l2_block2d (configuration A's up_0 logit head,
// 16 || 16 -> 2, with s = 1, h = the conv bias and an identity act). As the
// TPU kernel does, it computes the whole block per tile and recomputes the
// halos (a1 on +-2 rows and columns, att and the gated pair on +-1) instead
// of writing a1, ga or gb to device memory; its Toeplitz band matrices and
// (rows, 128) lane views are MXU devices and are not carried over.
//
// Layout: xa, xb, out NDHWC bf16, C <= 16 and Cout <= 16; att (N, D, H, W)
// bf16. The wrapper (ops/block2d.py) packs the weights once per weight
// tensor as wgmma's K-major core matrices (ops/conv333.py:
// pack_weights_gmma): w1 (chunk, tap) 16 x 16 slabs, one chunk per input;
// w2 three 16 x 16 slabs, one per kw, whose column kh holds the bf16 hi
// term of w2[kh, kw] and column 8 + kh the lo term (hi = rn(w), lo =
// rn(w - hi): about 16 bits, so att agrees with an f32 conv2); at Cout <= 2
// (the head) w0 and wr as six 16 x 8 slabs (chunk, kw): column kh * 2 + co
// holds w0[kh, kw, ., co], columns 6 + co of the kw = 1 slabs wr; else w0
// (chunk, tap) 16 x N slabs and wr one slab per chunk, N = 8 or 16 (Cout
// rounded up). The epilogue vectors are f32 (null: scale 1, shift 0, slope
// 1, bias 0), staged once per block. Accumulation f32; a1 and the gated
// pair rounded to bf16 (as the TPU kernel rounds them to the working
// dtype); att in f32 into the gate (written out rounded to bf16); the
// output rounded once.
//
// What bounds it on the H100: bytes. At the up_0 head it must read xa and
// xb (4.83 GB) and write out and att (0.45 GB) against 0.79 TFLOP: 1.58 ms.
// The parent chain of three launches moved about 19.9 GB. This design reads
// xa and xb once per tile with their halo and keeps a1, att and the gated
// pair in shared memory. What sets its time instead (PERF.md: 7.5 ms at
// the up_0 head on an H100, with cycles per 16-row tile by phase) is
// shared memory: the wgmma A operands come from it (m64n16k16 reads 2 KB
// of A for 16 K MACs; conv1, 414 per tile, is recomputed on the halo,
// ~1.3x) and every 16-byte copy of the halo is one request (one x slot
// fills a 183 KB block, so the next tile's copies cannot run under this
// tile's MMAs).
//
// Design.
// - Persistent walk over output tiles of TH rows x TW = 64 columns of one
//   (n, d) plane, (w, h) fastest; NWG = 4 warpgroups a block (2, 3 and 6
//   measured no faster), no producer warp; the m64 tiles of each conv are
//   dealt to them in turn, one per wait.
// - Every grid of a tile is flat with one row pitch P = 72 positions: the x
//   halo (xr rows from h0 - 3, P columns from w0 - 3), a1 and the tap
//   partials R (rows from h0 - 2, columns from w0 - 2), att and the gated
//   pair (from h0 - 1, w0 - 1) and the output (from h0, w0). Then a tap
//   (kh, kw) is one flat offset kh * P + kw in every conv, and an m64 tile
//   is 64 consecutive flat positions: a wgmma A descriptor with SBO = 8
//   positions (128 B) at any tap shift, formed by adding the tap's offset
//   to the tile's descriptor. Columns past the ones a valid output reads
//   are computed and never used.
// - xa and xb are staged once per tile as 8-channel planes of 16-byte
//   positions (a wgmma K-major core matrix is 8 such rows), C % 8 == 0 and
//   bases 16-byte aligned: by 16-byte cp.async copies from every thread,
//   neighbouring lanes on neighbouring 16-byte halves of a position, into a
//   1-2 slot ring; positions outside the image are zero-filled (src-size
//   0), which is conv1's padding; planes past C are zeroed once per block.
//   With two slots the next tile's copies are issued at a tile's start;
//   with one (the plan's 16-row tile) at the head as soon as conv0's
//   partial MMAs are done with the slot. TMA boxes of those planes read
//   16-byte rows at 32-byte strides and delivered ~6.7 GB/s per SM on the
//   H100, which had set the whole kernel's time. Other shapes are loaded
//   by all threads with plain loads. x is never padded or copied in device
//   memory.
// - conv1: 9 taps x 2 chunks (one per input) of m64n16k16 over the a1
//   grid. Epilogue: + b1, relu, a1 set to 0 at positions outside the image
//   (conv2 zero-pads a1; it must not see relu(b1): the TPU kernel's
//   _halo_zero(a1, nb, 2, ...); tested only in tiles at the image's
//   border), rounded to bf16 into a1's two planes, fence.proxy.async.
// - conv2 as tap partials: per a1 m64 tile, three m64n16k16 (one per kw,
//   the A descriptor shifted by kw) give R[kh][v] = sum over kw and the
//   channels of a1[v + kw] * w2[kh, kw] in columns kh (hi) and 8 + kh (lo),
//   summed into f32 arrays in shared memory; att[q] = sigmoid(b2 + R[0][q]
//   + R[1][q + P] + R[2][q + 2 P]). Each a1 value is read by wgmma three
//   times, not nine.
// - The gate, one position a thread: att from R in f32, written out as bf16
//   at the tile's own positions, then ga and gb rounded to bf16 IN PLACE
//   over the staged xa and xb (conv1 has read the whole tile: one barrier).
//   Positions outside the image are skipped: x is zero there, and so is the
//   gated pair (the TPU kernel's _halo_zero(..., 1, ...)).
// - conv0 at Cout <= 2 (the head) as kw-shift partials, as conv2: per m64
//   tile of the gated grid six m64n8k16 (chunk, kw) give Z[v][kh * 2 + co]
//   and the residual Z[v][6 + co] = g[v + 1] . wr, stored in f32 over the
//   dead a1 planes; then one output a thread: out[o] = act(Z[o][co] + Z[o +
//   P][2 + co] + Z[o + 2 P][4 + co]) + Z[o + P][6 + co] + br, rounded once
//   (126 MMAs a 16-row tile instead of 360 per tap at N = 8).
// - conv0 otherwise from the gated pair in place: 9 taps x 2 chunks of
//   m64nNk16; the 1x1 residual reads the pair at the output's own positions
//   as two more K slices, into the same accumulator when the unit is linear
//   with scale 1, else into a second accumulator that starts at br, added
//   after the PReLU. Stores go from the registers, masked to the tile and
//   the image, rounded once.
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
constexpr int N1 = 16;                   // a1's channels, C padded
constexpr int W1_BYTES = 2 * 9 * KC * N1 * 2;
constexpr int W2_BYTES = 3 * KC * 16 * 2;
constexpr int SMEM_MAX = 232448;         // dynamic shared memory of a block

struct Args {
  const __nv_bfloat16 *xa, *xb;
  const __nv_bfloat16 *w1, *w2, *w0, *wr;  // packed weights
  const float *b1, *b2, *s, *h, *al, *br;  // each may be null
  int al_n;                                // 1 or cout slopes
  __nv_bfloat16 *out, *att;
  int Nb, D, H, W, C, cout;
  int th;                                  // tile height (multiple of 8)
  int xr;                                  // staged x rows
  int ma, mo, mg;                          // m64 tiles of a1, output, Z
  int part;                                // Cout <= 2: conv0 as partials
  int planes;                              // 8-channel planes holding x
  int tiles_w, tiles_h, total;
  int stages, vec;                         // vec: staged by cp.async
  // shared memory, bytes
  int xplane, xslot, apitch, rpitch, off_a, off_r, off_w1, off_w2, off_w0,
      off_wr, off_epi;
  int w0_bytes, wr_bytes;
};

// The block's shared-memory layout (ops/block2d.py:l2_layout mirrors it):
// the x slots (planes xa 0-7, xa 8-15, xb 0-7, xb 8-15), a1's two planes
// (two spare positions past the m64 tiles, read by conv2's kw shift into
// rows no att reads; at the head conv0's partials Z reuse them), R's three
// f32 arrays, the four weight slabs, the epilogue vectors (b1; s, h,
// slope, br; b2). Returns its size in bytes.
static int layout(Args& a, int N) {
  a.mo = a.th * P / 64;
  a.ma = ((a.th + 3) * P + 68 + 63) / 64;
  a.xr = (a.ma * 64 + 2 * P + 1 + P - 1) / P;
  a.xplane = a.xr * P * 16;              // P * 16 = 9 * 128
  a.xslot = 4 * a.xplane;
  a.apitch = (a.ma * 64 + 8) * 16;
  a.rpitch = a.ma * 64 * 4;
  a.off_a = a.stages * a.xslot;
  a.off_r = a.off_a + 2 * a.apitch;
  a.off_w1 = a.off_r + 3 * a.rpitch;
  a.off_w2 = a.off_w1 + W1_BYTES;
  a.off_w0 = a.off_w2 + W2_BYTES;
  a.mg = ((a.th + 1) * P + 64 + 63) / 64;
  a.w0_bytes = a.part ? 2 * 3 * KC * 8 * 2 : 2 * 9 * KC * N * 2;
  a.wr_bytes = a.part ? 0 : 2 * KC * N * 2;
  a.off_wr = a.off_w0 + a.w0_bytes;
  a.off_epi = a.off_wr + a.wr_bytes;
  return a.off_epi + (N1 + 4 * N + 4) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, through L1 (on the H100 the
// two 16-byte halves of a position then cost one L2 request: .ca measured
// 9 % faster than .cg at the up_0 head); `bytes` 0 writes zeros.
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
// descriptor (both K-major): d += A B, or d = A B when `add` is 0.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int add = 1);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t da,
                                             uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(add));
}

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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

struct Tile {
  int nd, h0, w0;
  __device__ __forceinline__ Tile(int t, const Args& a) {
    const int rest = t / a.tiles_w;
    w0 = (t - rest * a.tiles_w) * TW;
    h0 = (rest % a.tiles_h) * a.th;
    nd = rest / a.tiles_h;
  }
};

// Issue the cp.async copies of tile t's x halo (C = 8 or 16): thread j <
// 2 P planes owns the 16-byte half hf of column f of input `in` (lanes on
// neighbouring halves) and walks the xr rows; a position outside the image
// is zero-filled. (One item a thread, its row and column recomputed per
// copy, measured 3 % slower at the up_0 head.)
__device__ __forceinline__ void copy_halo(int t, char* slot, const Args& a) {
  const int np = a.planes, j = threadIdx.x;
  if (j >= 2 * P * np) return;
  const Tile g(t, a);
  const int in = j >= P * np, k = j - in * P * np;
  const int f = np == 2 ? k >> 1 : k, hf = k - f * np;
  const int ww = g.w0 - 3 + f;
  const bool col = ww >= 0 && ww < a.W;
  const __nv_bfloat16* x = in ? a.xb : a.xa;
  const size_t pitch = (size_t)a.W * a.C;
  size_t off = ((size_t)g.nd * a.H * a.W + (col ? ww : 0)) * a.C + hf * 8;
  uint32_t dst = smem_u32(slot) + (2 * in + hf) * a.xplane + f * 16;
  for (int r = 0, hh = g.h0 - 3; r < a.xr; ++r, ++hh, dst += P * 16) {
    const bool ok = col && hh >= 0 && hh < a.H;
    cp_async16(dst, x + (ok ? off + hh * pitch : 0), ok ? 16 : 0);
  }
}

// The same halo by all threads with plain loads (shapes the copies cannot
// take).
__device__ __forceinline__ void load_halo(char* slot, const Tile& g,
                                          const Args& a) {
  const int per = a.xr * P * KC;
  for (int i = threadIdx.x; i < 2 * per; i += NTHREADS) {
    const int in = i >= per, j = i - in * per;
    const int f = j / KC, ch = j - f * KC;
    const int r = f / P, hh = g.h0 - 3 + r, ww = g.w0 - 3 + (f - r * P);
    unsigned short v = 0;
    if (ch < a.C && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W) {
      const unsigned short* x =
          reinterpret_cast<const unsigned short*>(in ? a.xb : a.xa);
      v = x[(((size_t)g.nd * a.H + hh) * a.W + ww) * a.C + ch];
    }
    *reinterpret_cast<unsigned short*>(slot + (2 * in + (ch >> 3)) * a.xplane +
                                       f * 16 + (ch & 7) * 2) = v;
  }
}

// The epilogue vectors, once per block: b1 (N1 entries, 0 past C), then
// rows s, h, slope, br of N floats (0 past cout), then b2.
__device__ __forceinline__ void load_epi(float* ep, int N, const Args& a) {
  for (int i = threadIdx.x; i < N1 + 4 * N + 1; i += NTHREADS) {
    float v;
    if (i < N1) {
      v = i < a.C && a.b1 ? a.b1[i] : 0.f;
    } else if (i < N1 + 4 * N) {
      const int row = (i - N1) / N, co = (i - N1) - row * N;
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

// conv1's epilogue of a1's m64 tile i: + b1, relu, rounded to bf16 into
// a1's planes (column j * 8 + c8 in plane j, at byte 2 c8 of a position);
// CHECK: set to 0 where the position lies outside the image (a tile away
// from the image's border has no such position that conv2 reads for an
// att the gate uses).
template <bool CHECK>
__device__ __forceinline__ void store_a1(char* a1, int apitch, int i,
                                         const float (&acc)[8],
                                         const float (&b1)[4], const Tile& g,
                                         const Args& a) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = i * 64 + frag_row(2 * hr);
    bool in = true;
    if constexpr (CHECK) {
      const int r = q / P, hh = g.h0 - 2 + r, ww = g.w0 - 2 + (q - r * P);
      in = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
    }
    char* at = a1 + q * 16 + (threadIdx.x & 3) * 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = j * 4 + hr * 2, k2 = j * 2;
      float v0 = fmaxf(acc[e] + b1[k2], 0.f);
      float v1 = fmaxf(acc[e + 1] + b1[k2 + 1], 0.f);
      if (!in) v0 = v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(at + j * apitch) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// 8 bf16 of a staged position gated in place: x <- rn(att * x + x).
__device__ __forceinline__ void gate8(char* p, float s) {
  uint4* v = reinterpret_cast<uint4*>(p);
  float f[8];
  unpack8(*v, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = fmaf(s, f[e], f[e]);
  *v = pack8(f);
}

template <int N, bool SPLIT, bool PART>
__global__ void __launch_bounds__(NTHREADS, 1)
    l2block2d_kernel(const Args a) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, wg = tid >> 7;
  float* ep = reinterpret_cast<float*>(smem + a.off_epi);
  char* a1 = smem + a.off_a;
  const uint32_t a32 = smem_u32(a1);
  float* rs = reinterpret_cast<float*>(smem + a.off_r);
  const int rp = a.rpitch / 4;
  const uint32_t w1s = smem_u32(smem + a.off_w1);
  const uint32_t w2s = smem_u32(smem + a.off_w2);
  const uint32_t w0s = smem_u32(smem + a.off_w0);
  const uint32_t wrs = smem_u32(smem + a.off_wr);
  const int apitch = a.apitch, xplane = a.xplane;
  const int rounds_a = (a.ma + NWG - 1) / NWG;
  const int rounds_o = (a.mo + NWG - 1) / NWG;
  const bool even = (a.cout & 1) == 0;

  // the weights and the epilogue vectors, once per block
  copy16(smem + a.off_w1, a.w1, W1_BYTES);
  copy16(smem + a.off_w2, a.w2, W2_BYTES);
  copy16(smem + a.off_w0, a.w0, a.w0_bytes);
  copy16(smem + a.off_wr, a.wr, a.wr_bytes);
  load_epi(ep, N, a);
  if (a.vec && a.planes == 1) {
    // C = 8: the planes of channels 8-15 stay zero (the gate skips them)
    for (int s = 0; s < a.stages; ++s)
      for (int i = tid; i < a.xplane / 16; i += NTHREADS) {
        reinterpret_cast<uint4*>(smem + s * a.xslot + a.xplane)[i] =
            make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(smem + s * a.xslot + 3 * a.xplane)[i] =
            make_uint4(0, 0, 0, 0);
      }
  }
  fence_async_smem();
  __syncthreads();
  if (a.vec && a.stages == 2) {
    copy_halo(blockIdx.x, smem, a);
    cp_async_commit();
  }
  const float b2 = ep[N1 + 4 * N];

  // tile k of this block sits in slot k % stages
  for (int k = 0, t = blockIdx.x; t < a.total; ++k, t += gridDim.x) {
    const int slot = k % a.stages;
    char* xs = smem + slot * a.xslot;
    const uint32_t xs32 = smem_u32(xs);
    const Tile g(t, a);
    // the last tile's conv0 has read its x slot (a1 and R were last read
    // before its conv0)
    __syncthreads();
    if (a.vec) {
      if (a.stages == 2) {
        // tile k + 1 into the slot tile k - 1 used; wait for tile k's
        if (t + gridDim.x < a.total)
          copy_halo(t + gridDim.x, smem + (slot ^ 1) * a.xslot, a);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        // with partials, tiles past the first were issued by the last
        // tile once its conv0 MMAs were done with the slot
        if (!PART || k == 0) {
          copy_halo(t, xs, a);
          cp_async_commit();
        }
        cp_async_wait<0>();
      }
    } else {
      load_halo(xs, g, a);
    }
    fence_async_smem();
    __syncthreads();

    // conv1 over the a1 positions, one m64 tile per warpgroup per round.
    // A tap's or a chunk's descriptor is the tile's plus a constant.
    {
      float b1c[4];
      own_cols<16>(b1c, ep);
      const uint32_t dw1 = desc_lo(w1s, 128);
      // every a1 position an att of the gate reads lies in the image
      const bool inner = g.h0 >= 2 && g.h0 + a.th + 2 <= a.H && g.w0 >= 2 &&
                         g.w0 + TW + 2 <= a.W;
      for (int round = 0; round < rounds_a; ++round) {
        const int i = round * NWG + wg;
        float acc[8];
        wgmma_fence();
        const uint32_t da = desc_lo(xs32 + min(i, a.ma - 1) * 1024, xplane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t dj = da + 2 * j * (xplane >> 4);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wgmma_ss<16>(acc, desc_of(dj + (tap / 3) * P + tap % 3, 128),
                         desc_of(dw1 + (j * 9 + tap) * (KC * N1 * 2 / 16),
                                 256),
                         j | tap);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        if (i >= a.ma) continue;
        if (inner)
          store_a1<false>(a1, apitch, i, acc, b1c, g, a);
        else
          store_a1<true>(a1, apitch, i, acc, b1c, g, a);
      }
    }
    fence_async_smem();
    __syncthreads();      // a1 complete; conv1's reads of x done

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
        for (int kw = 0; kw < 3; ++kw)
          wgmma_ss<16>(acc, desc_of(da + kw, 128),
                       desc_of(dw2 + kw * (KC * 16 * 2 / 16), 256), kw);
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
    __syncthreads();      // R complete

    // the gate: att at the (TH + 2) x (TW + 2) positions conv0 reads, the
    // tile's own written out, the pair gated in place
    {
      const int gw = TW + 2, ng = (a.th + 2) * gw;
      __nv_bfloat16* attp = a.att + (size_t)g.nd * a.H * a.W;
      for (int f = tid; f < ng; f += NTHREADS) {
        const int r = f / gw, c = f - r * gw;
        const int hh = g.h0 - 1 + r, ww = g.w0 - 1 + c;
        if (hh < 0 || hh >= a.H || ww < 0 || ww >= a.W) continue;
        const int q = r * P + c;
        const float z = b2 + rs[q] + rs[rp + q + P] + rs[2 * rp + q + 2 * P];
        const float s = 1.f / (1.f + expf(-z));
        if (r >= 1 && r <= a.th && c >= 1 && c <= TW)
          attp[(size_t)hh * a.W + ww] = __float2bfloat16_rn(s);
        char* xq = xs + (q + 2 * P + 2) * 16;
        gate8(xq, s);
        gate8(xq + 2 * xplane, s);
        if (a.planes == 2) {
          gate8(xq + xplane, s);
          gate8(xq + 3 * xplane, s);
        }
      }
    }
    fence_async_smem();
    __syncthreads();      // the gated pair complete

    if constexpr (PART) {
      // Cout <= 2: conv0 and the residual as kw-shift partials over the
      // gated grid, Z[v][kh * 2 + co] = sum over kw and the pair of
      // g[v + kw] w0[kh, kw] and Z[v][6 + co] = g[v + 1] . wr, into the
      // a1 region (a1 is dead); then out[o] = Z[o][co] + Z[o + P][2 + co]
      // + Z[o + 2 P][4 + co] (+ act) + Z[o + P][6 + co] + br
      const uint32_t dw0 = desc_lo(w0s, 128);
      float* z = reinterpret_cast<float*>(a1);
      for (int round = 0; round < (a.mg + NWG - 1) / NWG; ++round) {
        const int i = round * NWG + wg;
        float acc[4];
        wgmma_fence();
        const uint32_t dx =
            desc_lo(xs32 + (min(i, a.mg - 1) * 64 + 2 * P + 2) * 16, xplane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            wgmma_ss<8>(acc, desc_of(dx + 2 * j * (xplane >> 4) + kw, 128),
                        desc_of(dw0 + (j * 3 + kw) * (KC * 8 * 2 / 16), 256),
                        j | kw);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        if (i >= a.mg) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int q = i * 64 + frag_row(2 * hr);
          *reinterpret_cast<float2*>(z + q * 8 + (tid & 3) * 2) =
              make_float2(acc[2 * hr], acc[2 * hr + 1]);
        }
      }
      __syncthreads();    // Z complete: the x slot is free
      if (a.vec && a.stages == 1 && t + gridDim.x < a.total) {
        copy_halo(t + gridDim.x, xs, a);
        cp_async_commit();
      }
      float sc[2], hc[2], ac[2], bc[2];
#pragma unroll
      for (int co = 0; co < 2; ++co) {
        sc[co] = ep[N1 + co];
        hc[co] = ep[N1 + 8 + co];
        ac[co] = ep[N1 + 16 + co];
        bc[co] = ep[N1 + 24 + co];
      }
      __nv_bfloat16* out = a.out + (size_t)g.nd * a.H * a.W * a.cout;
      for (int f = tid; f < a.th * TW; f += NTHREADS) {
        const int r = f / TW, c = f - r * TW;
        const int hh = g.h0 + r, ww = g.w0 + c;
        if (hh >= a.H || ww >= a.W) continue;
        const int o = r * P + c;
        const float2 z0 = *reinterpret_cast<const float2*>(z + o * 8);
        const float2 z1 = *reinterpret_cast<const float2*>(z + (o + P) * 8 + 2);
        const float2 z2 =
            *reinterpret_cast<const float2*>(z + (o + 2 * P) * 8 + 4);
        const float2 zr = *reinterpret_cast<const float2*>(z + (o + P) * 8 + 6);
        float v[2] = {z0.x + z1.x + z2.x, z0.y + z1.y + z2.y};
        const float res[2] = {zr.x, zr.y};
#pragma unroll
        for (int co = 0; co < 2; ++co) {
          if constexpr (SPLIT) {
            v[co] = v[co] * sc[co] + hc[co];
            v[co] = (v[co] >= 0.f ? v[co] : ac[co] * v[co]) + res[co] +
                    bc[co];
          } else {
            v[co] = v[co] + res[co] + (hc[co] + bc[co]);
          }
        }
        __nv_bfloat16* at = out + ((size_t)hh * a.W + ww) * a.cout;
        if (a.cout == 2)
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(v[0], v[1]);
        else
          at[0] = __float2bfloat16_rn(v[0]);
      }
    } else {
      // conv0 from the gated pair, the residual at the output's own
      // positions, then the output, masked to the tile and the image
      float sc[N / 4], hc[N / 4], ac[N / 4], bc[N / 4];
      own_cols<N>(sc, ep + N1);
      own_cols<N>(hc, ep + N1 + N);
      own_cols<N>(ac, ep + N1 + 2 * N);
      own_cols<N>(bc, ep + N1 + 3 * N);
      if constexpr (!SPLIT) {
#pragma unroll
        for (int k = 0; k < N / 4; ++k) hc[k] += bc[k];
      }
      const uint32_t dw0 = desc_lo(w0s, 128), dwr = desc_lo(wrs, 128);
      __nv_bfloat16* out = a.out + (size_t)g.nd * a.H * a.W * a.cout;
      const bool inner = g.h0 + a.th <= a.H && g.w0 + TW <= a.W;
      for (int round = 0; round < rounds_o; ++round) {
        const int i = round * NWG + wg, o0 = min(i, a.mo - 1) * 64;
        float acc[N / 2], racc[N / 2];
        if constexpr (SPLIT) {
#pragma unroll
          for (int e = 0; e < N / 2; ++e)
            racc[e] = bc[(e >> 2) * 2 + (e & 1)];
          fence_regs(racc);
        }
        wgmma_fence();
        const uint32_t dx = desc_lo(xs32 + (o0 + 2 * P + 2) * 16, xplane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wgmma_ss<N>(acc,
                        desc_of(dx + 2 * j * (xplane >> 4) + (tap / 3) * P +
                                    tap % 3,
                                128),
                        desc_of(dw0 + (j * 9 + tap) * (KC * N * 2 / 16), 256),
                        j | tap);
        }
        // the pair at the output position o is the gated position o + P + 1
        const uint32_t dr = desc_lo(xs32 + (o0 + 3 * P + 3) * 16, xplane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if constexpr (SPLIT)
            wgmma_ss<N>(racc, desc_of(dr + 2 * j * (xplane >> 4), 128),
                        desc_of(dwr + j * (KC * N * 2 / 16), 256));
          else
            wgmma_ss<N>(acc, desc_of(dr + 2 * j * (xplane >> 4), 128),
                        desc_of(dwr + j * (KC * N * 2 / 16), 256));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        if constexpr (SPLIT) fence_regs(racc);
        if (i >= a.mo) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int o = i * 64 + frag_row(2 * hr);
          const int r = o / P, c = o - r * P;
          const int hh = g.h0 + r, ww = g.w0 + c;
          if (c >= TW || (!inner && (hh >= a.H || ww >= a.W))) continue;
          __nv_bfloat16* row = out + ((size_t)hh * a.W + ww) * a.cout;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            const int e = j * 4 + hr * 2, k2 = j * 2, co = own_col(k2);
            if (co >= a.cout) continue;
            float v0, v1;
            if constexpr (SPLIT) {
              v0 = acc[e] * sc[k2] + hc[k2];
              v1 = acc[e + 1] * sc[k2 + 1] + hc[k2 + 1];
              v0 = (v0 >= 0.f ? v0 : ac[k2] * v0) + racc[e];
              v1 = (v1 >= 0.f ? v1 : ac[k2 + 1] * v1) + racc[e + 1];
            } else {
              v0 = acc[e] + hc[k2];
              v1 = acc[e + 1] + hc[k2 + 1];
            }
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
}

template <int N, bool SPLIT, bool PART>
int launch(Args a, int device, cudaStream_t s) {
  const int smem = layout(a, N);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // blocks per SM the shared memory allows, per device and block size
  static int sms[64] = {0}, occ_smem[64] = {0}, occ_nb[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err;
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(l2block2d_kernel<N, SPLIT, PART>,
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
        &nb, l2block2d_kernel<N, SPLIT, PART>, NTHREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_smem[device] = smem;
    occ_nb[device] = nb;
  }
  const long long cap = (long long)occ_nb[device] * sms[device];
  const int grid = (int)(a.total < cap ? a.total : cap);
  l2block2d_kernel<N, SPLIT, PART><<<grid, NTHREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s, al null with h, br given: the linear unit of the logit head (out =
// conv0 + h + residual + br). th: the tile height (a multiple of 8, <= 64);
// stages: x ring slots (1, 2).
extern "C" int l2block2d_launch(const void* xa, const void* xb,
                                const void* w1, const void* w2,
                                const void* w0, const void* wr,
                                const void* b1, const void* b2,
                                const void* s, const void* h, const void* al,
                                int al_n, const void* br, void* out,
                                void* att, int n, int d, int hgt, int w,
                                int c, int cout, int th, int stages,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (!xa || !xb || !w1 || !w2 || !w0 || !wr || !out || !att ||
      misaligned(w1) || misaligned(w2) || misaligned(w0) || misaligned(wr) ||
      (reinterpret_cast<uintptr_t>(out) & 3) ||
      (reinterpret_cast<uintptr_t>(att) & 1) || n < 1 || d < 1 || hgt < 1 ||
      w < 1 || c < 1 || c > 16 || cout < 1 || cout > 16 || th < 8 ||
      th > 64 || th % 8 || stages < 1 || stages > 2 ||
      (al_n != 1 && al_n != cout))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.xa = static_cast<const __nv_bfloat16*>(xa);
  a.xb = static_cast<const __nv_bfloat16*>(xb);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.w0 = static_cast<const __nv_bfloat16*>(w0);
  a.wr = static_cast<const __nv_bfloat16*>(wr);
  a.b1 = static_cast<const float*>(b1);
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
  a.C = c;
  a.cout = cout;
  a.th = th;
  a.planes = c > 8 ? 2 : 1;
  a.tiles_w = (w + TW - 1) / TW;
  a.tiles_h = (hgt + th - 1) / th;
  const long long total = (long long)n * d * a.tiles_h * a.tiles_w;
  if (total > 0x7fffffffLL || (long long)hgt * w * cout > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.total = (int)total;
  a.stages = stages;
  // 16-byte copies need 16-byte positions' halves and bases: C % 8
  a.vec = !misaligned(xa) && !misaligned(xb) && c % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool split = s != nullptr || al != nullptr;
  a.part = cout <= 2;
  if (a.part)
    return split ? launch<8, true, true>(a, device, st)
                 : launch<8, false, true>(a, device, st);
  if (cout <= 8)
    return split ? launch<8, true, false>(a, device, st)
                 : launch<8, false, false>(a, device, st);
  return split ? launch<16, true, false>(a, device, st)
               : launch<16, false, false>(a, device, st);
}
