// rublock2d — one eval (3,3,1) encoder ResidualUnit per launch, for sm_90a:
//
//   u0  = prelu(conv0(x) * s0 + h0; a0)                     Cin  -> Cout
//   out = prelu(conv1(u0) * s1 + h1; a1) + (x . wr + br)      Cout -> Cout
//
// every conv (3,3,1), stride 1, same padding: each (n, d) plane is an
// independent 2-D image. Replaces the TPU kernel
// vs_seg_tpu/ops/experimental/pallas_block2d.py:ru_block2d (_ru2d_kernel),
// through ops/block2d.py:ru_block2d (configuration A's down_0, 1 -> 16, and
// down_1, 16 -> 32). As the TPU kernel does, it computes the whole unit per
// tile and recomputes u0's one-row, one-column halo instead of writing u0 to
// device memory; its Toeplitz band matrices and (rows, 128) lane views are
// MXU devices and are not carried over.
//
// Layout: x and out NDHWC bf16, any Cin <= 32 and Cout <= 32. The wrapper
// (ops/block2d.py) packs the weights once per weight tensor as wgmma's
// K-major core matrices (ops/conv333.py:pack_weights_gmma): w0 (chunk, tap)
// 16 x N slabs, or at Cin = 1 one 16 x N slab whose K lane t is tap t =
// kh*3 + kw (lanes 9-15 zero); w1 (chunk, tap) slabs; wr one slab per
// chunk, or at Cin = 1 one slab holding wr in K lane 4 (the centre tap). N
// = 16 or 32 (Cout rounded up). The epilogue vectors are f32 (null: scale
// 1, shift 0, slope 1), staged once per block. Accumulation f32; u0 rounded
// to bf16 (as the TPU kernel rounds it to the working dtype); the output
// rounded once.
//
// What bounds it on the H100: the bound is the output write at down_0
// (2.42 GB of 2.57 moved) and about even between bytes and the tensor rate
// at down_1. In this design the wgmma A operands come from shared memory:
// m64n16k16 reads 2 KB of A for 16 K MACs, which at the tensor cores' peak
// is twice the 128 B/clock shared memory delivers, so at Cout = 16 conv1
// runs at most at half the tensor rate. Measured (PERF.md, ru_block2d), the two
// epilogues, conv1's MMAs and the per-tile loop each take their own share
// of the time with little overlap between them: the instruction stream
// (its issue and its stalls on wgmma waits and shared memory), not DRAM or
// the tensor rate, sets it.
//
// Design.
// - Persistent walk over output tiles of TH rows x TW = 64 columns of one
//   (n, d) plane, (w, h) fastest; as many blocks per SM as the shared
//   memory allows (the occupancy API). Two warpgroups, no producer warp;
//   the m64 tiles of each conv are dealt to them in turn, one per wait.
// - Every grid of a tile is flat with one row pitch P = 72 positions: the x
//   halo (xr rows from h0 - 2, P columns from w0 - 2), u0 (rows from h0 - 1,
//   columns from w0 - 1) and the output (rows from h0, columns from w0).
//   Then a tap (kh, kw) is one flat offset kh * P + kw in every conv, and
//   an m64 tile is 64 consecutive flat positions: a wgmma A descriptor with
//   SBO = 8 positions (128 B) at any tap shift, formed by adding the tap's
//   offset to the tile's descriptor. Columns past the tile's
//   (TW + 2 of u0, TW of out) are computed and never used (12.5 % of conv1,
//   about 30 % of conv0 with its halo rows).
// - x is staged once per tile: by TMA (Cin = 1 with W % 8 == 0, or Cin % 8
//   == 0, base 16-byte aligned) into a 1-2 slot ring (csrc/ring.cuh) that
//   one thread fills, the next tile's box in flight during this tile's
//   math, zero-filled outside the image (conv0's padding); x is never
//   padded or copied in device memory. Other shapes are loaded by all
//   threads with plain loads. Cin = 1 is staged as an image of xr rows x
//   PX = 80 columns from w0 - 8, one box whose rows start on a 16-byte
//   column; Cin > 1 as 8-channel planes of 16-byte positions, one box per
//   plane, channels past Cin zero-filled up to a 16-channel chunk.
// - Cin = 1, tap packing: the 9 taps of each u0 position are packed from
//   the staged image into the K lanes of one 16-lane slice in shared
//   memory (two planes of 16-byte positions), so conv0 is one K step, not
//   9 steps of 15 zero lanes. Cin > 1: 9 taps x Cin/16 chunks of wgmma,
//   the A descriptor offset into the staged halo.
// - Epilogue 0 in f32 from the accumulators: scale, shift, PReLU, then u0
//   set to 0 at positions outside the image (conv1 zero-pads u0; it does not
//   see prelu(h0) of a zero-padded x: the TPU kernel's _halo_zero; tested
//   only in tiles at the image's border), and at channels past Cout;
//   rounded to bf16 into u0's planes (Cout / 8 planes of 16-byte
//   positions), made visible to wgmma (fence.proxy.async).
// - conv1 from the u0 tile: 9 taps x N/16 chunks. The 1x1 residual runs on
//   the staged x at the output's own positions (offset 2 P + 2; at Cin = 1
//   the packed slice's centre-tap lane at offset P + 1) into a second
//   accumulator set that starts at br, added after the PReLU. Stores go
//   from the registers, masked to the tile and the image (16-byte stores
//   after a transpose within each quad of lanes measured no faster).
// - Results do not depend on the schedule: every output value is summed by
//   one warpgroup in a fixed order.
// Bounds: any N, D, H, W with N*D*ceil(H/TH)*ceil(W/64) < 2^31 tiles and
// H*W*Cout < 2^31.

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int TW = 64;                   // output tile width
constexpr int P = 72;                    // row pitch of every tile grid
// Cin = 1: x is staged from column w0 - 8 (16-byte aligned) in rows of PX
// positions, XOFF of them before the halo's first column w0 - 2
constexpr int PX = 80, XOFF = 6;
constexpr int NWG = 2;                   // warpgroups per block
constexpr int NTHREADS = 128 * NWG;
constexpr int NWARPS = NTHREADS / 32;
constexpr int KC = 16;                   // wgmma K (bf16)
constexpr int EPI = 7;                   // epilogue vectors
constexpr int SMEM_MAX = 232448;         // dynamic shared memory of a block

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16 *w0, *w1, *wr;      // packed weights
  const float *s0, *h0, *a0, *s1, *h1, *a1, *br;   // each may be null
  int a0_n, a1_n;                          // 1 or cout slopes
  __nv_bfloat16* out;
  int Nb, D, H, W, cin, cout;
  int th;                                  // tile height (multiple of 8)
  int xr;                                  // staged x rows
  int m0, m1;                              // m64 tiles of u0 / of the output
  int chunks;                              // 16-channel chunks of x; 0: taps packed
  int tiles_w, tiles_h, total;
  int stages, tma;
  // shared memory, bytes
  int xplane, xslot, upitch, off_pk, off_u, off_w0, off_w1, off_wr, off_epi,
      off_bar;
  int w0_bytes, w1_bytes, wr_bytes;
};

static inline int up128(int v) { return (v + 127) / 128 * 128; }

// The block's shared-memory layout (ops/block2d.py:plan mirrors it): the x
// slots, the packed taps (Cin = 1), u0, the three weight slabs, the
// epilogue vectors, the ring's barriers. Returns its size in bytes.
static int layout(Args& a, int N) {
  const bool pack = a.chunks == 0;
  a.xplane = pack ? up128(a.xr * PX * 2) : a.xr * P * 16;  // P * 16 = 9 * 128
  a.xslot = pack ? a.xplane : 2 * a.chunks * a.xplane;
  a.upitch = a.m0 * 64 * 16;
  a.off_pk = a.stages * a.xslot;
  a.off_u = a.off_pk + (pack ? 2 * a.upitch : 0);
  a.w0_bytes = (pack ? 1 : 9 * a.chunks) * KC * N * 2;
  a.w1_bytes = (N / KC) * 9 * KC * N * 2;
  a.wr_bytes = (pack ? 1 : a.chunks) * KC * N * 2;
  a.off_w0 = a.off_u + (N / 8) * a.upitch;
  a.off_w1 = a.off_w0 + a.w0_bytes;
  a.off_wr = a.off_w1 + a.w1_bytes;
  a.off_epi = a.off_wr + a.wr_bytes;
  a.off_bar = a.off_epi + EPI * N * 4;
  return a.off_bar + 2 * a.stages * 8;
}

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B from shared memory by
// descriptor (both K-major): d += A B, or d = A B when `add` is 0.
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

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                              uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(add));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most K committed wgmma groups are pending.
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make this thread's shared-memory stores visible to the async proxy
// (wgmma reads its operands through it); follow it with a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two 8-element K halves) and stride byte offset
// (between 8-row groups), each in 16-byte units.
// The low word (start, LBO) is built apart so that a tap's offset is one
// 32-bit add: the start field holds address / 16 < 2^14 (shared memory <
// 256 KB), so no sum carries out of it.
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

__device__ __forceinline__ float affine_prelu(float v, float s, float h,
                                              float a) {
  v = v * s + h;
  return v >= 0.f ? v : a * v;
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

// The producer: announce and issue the TMA boxes of tile t's x halo.
template <bool PACK>
__device__ __forceinline__ void produce(int t, char* slot, uint64_t* full,
                                        const CUtensorMap* map,
                                        const Args& a) {
  const Tile g(t, a);
  if constexpr (PACK) {
    mbar_expect_tx(full, a.xr * PX * 2);
    tma_load_4d(slot, map, full, 0, g.w0 / 8 - 1, g.h0 - 2, g.nd);
  } else {
    mbar_expect_tx(full, 2 * a.chunks * a.xr * P * 16);
    for (int pl = 0; pl < 2 * a.chunks; ++pl)
      tma_load_4d(slot + pl * a.xplane, map, full, pl * 8, g.w0 - 2,
                  g.h0 - 2, g.nd);
  }
}

// The same halo by all threads with plain loads (shapes TMA cannot map).
template <bool PACK>
__device__ __forceinline__ void load_halo(char* slot, const Tile& g,
                                          const Args& a) {
  const unsigned short* x = reinterpret_cast<const unsigned short*>(a.x);
  if constexpr (PACK) {
    unsigned short* dst = reinterpret_cast<unsigned short*>(slot);
    for (int f = threadIdx.x; f < a.xr * PX; f += NTHREADS) {
      const int r = f / PX, hh = g.h0 - 2 + r, ww = g.w0 - 8 + (f - r * PX);
      unsigned short v = 0;
      if (hh >= 0 && hh < a.H && ww >= 0 && ww < a.W)
        v = x[((size_t)g.nd * a.H + hh) * a.W + ww];
      dst[f] = v;
    }
  } else {
    const int cp = a.chunks * KC;
    for (int i = threadIdx.x; i < a.xr * P * cp; i += NTHREADS) {
      const int f = i / cp, ch = i - f * cp;
      const int r = f / P, hh = g.h0 - 2 + r, ww = g.w0 - 2 + (f - r * P);
      unsigned short v = 0;
      if (ch < a.cin && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W)
        v = x[(((size_t)g.nd * a.H + hh) * a.W + ww) * a.cin + ch];
      *reinterpret_cast<unsigned short*>(slot + (ch >> 3) * a.xplane +
                                         f * 16 + (ch & 7) * 2) = v;
    }
  }
}

// Cin = 1: the 9 taps of u0 position q = (r, c) (staged x at row r + kh,
// column c + kw + XOFF) as K lanes 0-8 of its 16-lane slice: lanes 0-7 in
// the first plane, lane 8 (and 7 zeros) in the second, `pitch` bytes on.
__device__ __forceinline__ void pack_taps(char* pk, const char* slot,
                                          int npos, int pitch) {
  for (int q = threadIdx.x; q < npos; q += NTHREADS) {
    const int r = q / P;
    const unsigned short* xv = reinterpret_cast<const unsigned short*>(slot) +
                               r * PX + (q - r * P) + XOFF;
    uint32_t t[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) t[tap] = xv[(tap / 3) * PX + tap % 3];
    *reinterpret_cast<uint4*>(pk + q * 16) =
        make_uint4(t[0] | t[1] << 16, t[2] | t[3] << 16, t[4] | t[5] << 16,
                   t[6] | t[7] << 16);
    *reinterpret_cast<uint4*>(pk + pitch + q * 16) = make_uint4(t[8], 0, 0, 0);
  }
}

// The epilogue vectors, once per block into a table of EPI rows of N
// floats: s0, h0, a0, s1, h1, a1, br, each 0 past cout (so a padded
// channel's activation is 0).
__device__ __forceinline__ void load_epi(float* ep, int N, const Args& a) {
  const float* vec[EPI] = {a.s0, a.h0, a.a0, a.s1, a.h1, a.a1, a.br};
  const float dflt[EPI] = {1.f, 0.f, 1.f, 1.f, 0.f, 1.f, 0.f};
  for (int i = threadIdx.x; i < EPI * N; i += NTHREADS) {
    const int v = i / N, co = i - v * N;
    const int one = (v == 2 && a.a0_n == 1) || (v == 5 && a.a1_n == 1);
    ep[i] = co >= a.cout ? 0.f
            : vec[v]     ? vec[v][one ? 0 : co]
                         : dflt[v];
  }
}

// Row v of the table at this thread's N / 4 accumulator columns.
template <int N>
__device__ __forceinline__ void own_cols(float (&d)[N / 4], const float* ep,
                                         int v) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) d[k] = ep[v * N + own_col(k)];
}

// Epilogue 0 of u0's m64 tile i: scale, shift, PReLU, rounded to bf16 into
// u0's planes (column j * 8 + c8 in plane j, at byte 2 c8 of a position);
// CHECK: set to 0 where the position lies outside the image (a tile away
// from the image's border has no such position that an output reads).
template <int N, bool CHECK>
__device__ __forceinline__ void store_u0(char* u0, int upitch, int i,
                                         const float (&acc)[N / 2],
                                         const float (&s)[N / 4],
                                         const float (&h)[N / 4],
                                         const float (&al)[N / 4],
                                         const Tile& g, const Args& a) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = i * 64 + frag_row(2 * hr);
    bool in = true;
    if constexpr (CHECK) {
      const int r = q / P, hh = g.h0 - 1 + r, ww = g.w0 - 1 + (q - r * P);
      in = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
    }
    char* at = u0 + q * 16 + (threadIdx.x & 3) * 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int e = j * 4 + hr * 2, k2 = j * 2;
      float v0 = affine_prelu(acc[e], s[k2], h[k2], al[k2]);
      float v1 = affine_prelu(acc[e + 1], s[k2 + 1], h[k2 + 1], al[k2 + 1]);
      if (!in) v0 = v1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(at + j * upitch) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int N, bool PACK>
__global__ void __launch_bounds__(NTHREADS, 2)
    rublock2d_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x, wg = tid >> 7;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.off_bar);
  uint64_t* empty = full + a.stages;
  float* ep = reinterpret_cast<float*>(smem + a.off_epi);
  char* pk = smem + a.off_pk;
  const uint32_t pk32 = smem_u32(pk);
  char* u0 = smem + a.off_u;
  const uint32_t u32 = smem_u32(u0);
  const uint32_t w0s = smem_u32(smem + a.off_w0);
  const uint32_t w1s = smem_u32(smem + a.off_w1);
  const uint32_t wrs = smem_u32(smem + a.off_wr);
  const int upitch = a.upitch;
  // m64 tiles are dealt to the warpgroups in turn, one per round; every
  // wgmma is unconditional (a tile past the end repeats the last tile,
  // whose copy is not stored): a wgmma under a branch on threadIdx is
  // serialized by ptxas. One tile per wait: two in flight, or the next
  // tile's MMAs overlapped with this one's epilogue, measured no faster.
  const int rounds0 = (a.m0 + NWG - 1) / NWG, rounds1 = (a.m1 + NWG - 1) / NWG;
  const bool even = (a.cout & 1) == 0;

  // the weights and the epilogue vectors, once per block
  copy16(smem + a.off_w0, a.w0, a.w0_bytes);
  copy16(smem + a.off_w1, a.w1, a.w1_bytes);
  copy16(smem + a.off_wr, a.wr, a.wr_bytes);
  load_epi(ep, N, a);
  if (a.tma && tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWARPS);
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  if (a.tma && tid == 0) {
    for (int s = 0; s < a.stages - 1; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < a.total) produce<PACK>(t, smem + s * a.xslot, &full[s], &map, a);
    }
  }

  // tile k of this block sits in slot k % stages, its use k / stages
  for (int k = 0, t = blockIdx.x; t < a.total; ++k, t += gridDim.x) {
    const int slot = k % a.stages;
    char* xs = smem + slot * a.xslot;
    const uint32_t xs32 = smem_u32(xs);
    const Tile g(t, a);
    if (a.tma) {
      if (tid == 0) {
        // tile k + stages - 1 reuses the slot of tile k - 1
        const int ahead = t + (a.stages - 1) * gridDim.x;
        if (ahead < a.total) {
          const int ps = (k + a.stages - 1) % a.stages;
          if (k >= 1) mbar_wait(&empty[ps], ((k - 1) / a.stages) & 1);
          produce<PACK>(ahead, smem + ps * a.xslot, &full[ps], &map, a);
        }
      }
      __syncwarp();
      mbar_wait_asm(&full[slot], (k / a.stages) & 1);
      __syncthreads();    // the last tile's reads of the taps and u0 are done
    } else {
      __syncthreads();    // ... and of the x slot
      load_halo<PACK>(xs, g, a);
      fence_async_smem();
      __syncthreads();
    }
    if constexpr (PACK) {
      pack_taps(pk, xs, a.m0 * 64, upitch);
      fence_async_smem();
      __syncthreads();
    }

    // conv0 over the u0 positions, one m64 tile per warpgroup per round. A
    // tap's or a chunk's descriptor is the tile's plus a constant (desc_lo).
    float s0c[N / 4], h0c[N / 4], a0c[N / 4];
    own_cols<N>(s0c, ep, 0);
    own_cols<N>(h0c, ep, 1);
    own_cols<N>(a0c, ep, 2);
    const uint32_t dw0 = desc_lo(w0s, 128);
    // every u0 position a used output reads lies in the image
    const bool inner0 = g.h0 >= 1 && g.h0 + a.th + 1 <= a.H && g.w0 >= 1 &&
                        g.w0 + TW + 1 <= a.W;
    for (int round = 0; round < rounds0; ++round) {
      const int i = round * NWG + wg;
      float acc[N / 2];
      wgmma_fence();
      if constexpr (PACK) {
        wgmma_ss<N>(acc,
                    desc_of(desc_lo(pk32 + min(i, a.m0 - 1) * 1024, upitch),
                            128),
                    desc_of(dw0, 256), 0);
      } else {
        const uint32_t da = desc_lo(xs32 + min(i, a.m0 - 1) * 1024, a.xplane);
        for (int j = 0; j < a.chunks; ++j) {
          const uint32_t dj = da + 2 * j * (a.xplane >> 4);
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            wgmma_ss<N>(acc, desc_of(dj + (tap / 3) * P + tap % 3, 128),
                        desc_of(dw0 + (j * 9 + tap) * (KC * N * 2 / 16), 256),
                        j | tap);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (i >= a.m0) continue;
      if (inner0)
        store_u0<N, false>(u0, upitch, i, acc, s0c, h0c, a0c, g, a);
      else
        store_u0<N, true>(u0, upitch, i, acc, s0c, h0c, a0c, g, a);
    }
    fence_async_smem();
    __syncthreads();

    // conv1 from u0, the residual into its own accumulators (from br, added
    // after the PReLU), then the output, masked to the tile and the image
    float s1c[N / 4], h1c[N / 4], a1c[N / 4], brc[N / 4];
    own_cols<N>(s1c, ep, 3);
    own_cols<N>(h1c, ep, 4);
    own_cols<N>(a1c, ep, 5);
    own_cols<N>(brc, ep, 6);
    const uint32_t dw1 = desc_lo(w1s, 128), dwr = desc_lo(wrs, 128);
    __nv_bfloat16* out = a.out + (size_t)g.nd * a.H * a.W * a.cout;
    const bool inner1 = g.h0 + a.th <= a.H && g.w0 + TW <= a.W;
    for (int round = 0; round < rounds1; ++round) {
      const int i = round * NWG + wg, o0 = min(i, a.m1 - 1) * 64;
      float acc[N / 2], racc[N / 2];
#pragma unroll
      for (int e = 0; e < N / 2; ++e) racc[e] = brc[(e >> 2) * 2 + (e & 1)];
      fence_regs(racc);
      wgmma_fence();
      const uint32_t du = desc_lo(u32 + o0 * 16, upitch);
#pragma unroll
      for (int j = 0; j < N / KC; ++j) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          wgmma_ss<N>(acc,
                      desc_of(du + 2 * j * (upitch >> 4) + (tap / 3) * P +
                                  tap % 3,
                              128),
                      desc_of(dw1 + (j * 9 + tap) * (KC * N * 2 / 16), 256),
                      j | tap);
      }
      if constexpr (PACK) {
        // x at the output position is the centre-tap lane of u0 position
        // o + P + 1; wr sits in that lane of its slab
        wgmma_ss<N>(racc,
                    desc_of(desc_lo(pk32 + (o0 + P + 1) * 16, upitch), 128),
                    desc_of(dwr, 256));
      } else {
        const uint32_t dx = desc_lo(xs32 + (o0 + 2 * P + 2) * 16, a.xplane);
        for (int j = 0; j < a.chunks; ++j)
          wgmma_ss<N>(racc, desc_of(dx + 2 * j * (a.xplane >> 4), 128),
                      desc_of(dwr + j * (KC * N * 2 / 16), 256));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(racc);
      if (i >= a.m1) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int o = i * 64 + frag_row(2 * hr);
        const int r = o / P, c = o - r * P;
        const int hh = g.h0 + r, ww = g.w0 + c;
        if (c >= TW || (!inner1 && (hh >= a.H || ww >= a.W))) continue;
        __nv_bfloat16* row = out + (hh * a.W + ww) * a.cout;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int e = j * 4 + hr * 2, k2 = j * 2, co = own_col(k2);
          if (co >= a.cout) continue;
          const float v0 =
              affine_prelu(acc[e], s1c[k2], h1c[k2], a1c[k2]) + racc[e];
          const float v1 = affine_prelu(acc[e + 1], s1c[k2 + 1], h1c[k2 + 1],
                                        a1c[k2 + 1]) +
                           racc[e + 1];
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
    if (a.tma) {
      // this tile's reads of the x slot are done
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[slot]);
    }
  }
}

// TMA map of x: Cin = 1 as (8, W/8, H, N*D), 8-column groups innermost so
// that every box starts on a 16-byte column (a 3-D (W, H, N*D) map boxed
// from column w0 - 2 faulted on the card: illegal instruction), box (8,
// PX/8, xr, 1); else (C, W, H, N*D), box (8, P, xr, 1): one 8-channel
// plane of the halo.
cudaError_t x_map(CUtensorMap* map, const Args& a) {
  const uint64_t nd = (uint64_t)a.Nb * a.D;
  if (a.chunks == 0) {
    const uint64_t dims[4] = {8, (uint64_t)a.W / 8, (uint64_t)a.H, nd};
    const uint64_t strides[3] = {16, (uint64_t)a.W * 2,
                                 (uint64_t)a.W * a.H * 2};
    const uint32_t box[4] = {8, PX / 8, (uint32_t)a.xr, 1};
    return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.x, dims,
                        strides, box);
  }
  const uint64_t s1 = (uint64_t)a.cin * 2;
  const uint64_t dims[4] = {(uint64_t)a.cin, (uint64_t)a.W, (uint64_t)a.H,
                            nd};
  const uint64_t strides[3] = {s1, s1 * a.W, s1 * a.W * a.H};
  const uint32_t box[4] = {8, P, (uint32_t)a.xr, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.x, dims,
                      strides, box);
}

template <int N, bool PACK>
int launch(Args a, int device, cudaStream_t s) {
  const int smem = layout(a, N);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // blocks per SM the shared memory allows, per device and block size
  static int sms[64] = {0}, occ_smem[64] = {0}, occ_nb[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err;
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(rublock2d_kernel<N, PACK>,
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
        &nb, rublock2d_kernel<N, PACK>, NTHREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    occ_smem[device] = smem;
    occ_nb[device] = nb;
  }
  CUtensorMap map = {};
  if (a.tma) {
    err = x_map(&map, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long cap = (long long)occ_nb[device] * sms[device];
  const int grid = (int)(a.total < cap ? a.total : cap);
  rublock2d_kernel<N, PACK><<<grid, NTHREADS, smem, s>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// th: the tile height (a multiple of 8, <= 64); stages: x ring slots (1, 2)
extern "C" int rublock2d_launch(const void* x, const void* w0, const void* w1,
                                const void* wr, const void* s0,
                                const void* h0, const void* a0, int a0_n,
                                const void* s1, const void* h1,
                                const void* a1, int a1_n, const void* br,
                                void* out, int n, int d, int h, int w,
                                int cin, int cout, int th, int stages,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (!x || !w0 || !w1 || !wr || !out || misaligned(w0) || misaligned(w1) ||
      misaligned(wr) || (reinterpret_cast<uintptr_t>(out) & 3) ||
      n < 1 || d < 1 || h < 1 || w < 1 || cin < 1 || cin > 32 || cout < 1 ||
      cout > 32 || th < 8 || th > 64 || th % 8 || stages < 1 || stages > 2 ||
      (a0_n != 1 && a0_n != cout) || (a1_n != 1 && a1_n != cout))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w0 = static_cast<const __nv_bfloat16*>(w0);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.wr = static_cast<const __nv_bfloat16*>(wr);
  a.s0 = static_cast<const float*>(s0);
  a.h0 = static_cast<const float*>(h0);
  a.a0 = static_cast<const float*>(a0);
  a.s1 = static_cast<const float*>(s1);
  a.h1 = static_cast<const float*>(h1);
  a.a1 = static_cast<const float*>(a1);
  a.br = static_cast<const float*>(br);
  a.a0_n = a0_n;
  a.a1_n = a1_n;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Nb = n;
  a.D = d;
  a.H = h;
  a.W = w;
  a.cin = cin;
  a.cout = cout;
  a.th = th;
  a.chunks = cin == 1 ? 0 : (cin + KC - 1) / KC;
  a.m0 = ((th + 2) * P + 63) / 64;
  a.m1 = th * P / 64;
  a.xr = (a.m0 * 64 + 2 * P + 2 + P - 1) / P;
  a.tiles_w = (w + TW - 1) / TW;
  a.tiles_h = (h + th - 1) / th;
  const long long total = (long long)n * d * a.tiles_h * a.tiles_w;
  if (total > 0x7fffffffLL || (long long)h * w * cout > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.total = (int)total;
  a.stages = stages;
  // TMA needs 16-byte global strides and base: W % 8 at Cin = 1, Cin % 8
  a.tma = !misaligned(x) && (cin == 1 ? w % 8 == 0 : cin % 8 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 16)
    return cin == 1 ? launch<16, true>(a, device, s)
                    : launch<16, false>(a, device, s);
  return cin == 1 ? launch<32, true>(a, device, s)
                  : launch<32, false>(a, device, s);
}
