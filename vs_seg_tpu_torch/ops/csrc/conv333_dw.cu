// conv333_dw — weight and bias gradients of a (3,3,3) stride-1 same-padded
// convolution, for sm_90a:
//
//   dw[kh, kw, kd, ci, co] = sum_{n,d,h,w} x[n, d+kd-1, h+kh-1, w+kw-1, ci]
//                                          * dy[n, d, h, w, co]
//   db[co]                 = sum_{n,d,h,w} dy[n, d, h, w, co]
//
// (x zero outside the volume), in float32, in the JAX (kh, kw, kd, Cin, Cout)
// order. x (N, D, H, W, Cin) and dy (N, D, H, W, Cout) are bf16 NDHWC with
// C % 8 == 0 and 16-byte aligned bases (the wrapper, ops/conv333_dw.py, pads
// other channel counts with zeros in a copy).
//
// Replaces vs_seg_tpu/ops/experimental/pallas_train.py:conv333_dw
// (_dw_kernel), the wgrad half of conv333_train's backward. The TPU kernel
// accumulates 18 (128, 128) Gram blocks over 128-lane Toeplitz views of x and
// reads dw off them afterwards (dw_extract), carrying the sums across a
// sequential grid in VMEM outputs. None of that carries over: the Gram blocks
// exist for the MXU, and CUDA blocks run in no order.
//
// What bounds it on the H100: at the level-2 and level-3 sites of the train
// step (0.07-0.6 M voxels, 48-64 channels) the tensor cores by the bound (27
// Cin MACs per dy value against ~4 bytes read); at level 4 and the bottom (9 k
// and 1 k voxels, 0.5-3 GFLOP, a few µs by the bound) the launch and the
// host. As built, the staging: x and dy go through the ring once per kh
// group, in 16-byte rows, and a variant with no MMAs took 0.20 of the 0.22
// ms at level 2 (PERF.md §6, conv333_dw).
//
// Design.
// - A GEMM on wgmma with K = voxels: for each tap, M = 64 input channels
//   (A = x_tap^T), N = Cout (B = dy, the whole of it up to 64, rounded up to
//   8, 16, 32, 40, 48 or 64; wider Cout is cut into equal N tiles), bf16 in,
//   f32 accumulators in registers. Both operands are read from shared memory
//   MN-major (the transpose immediates of wgmma.mma_async): x and dy are
//   staged as planes of 8-channel groups, one 16-byte row per voxel, so 8
//   voxels of one group are one 8 x 16 B core matrix; LBO is the step along
//   K (the next 8 voxels, 128 B), SBO the step along M or N (the next 8
//   channels, one group plane). A (kh, kw) tap is only the start address of
//   A in the staged halo, as in csrc/conv333.cu. One K step (k16) is one
//   16-voxel row of the TH x 16 output tile.
// - A block is three consumer warpgroups and a producer warpgroup, one
//   thread of which issues the copies; the producer hands its registers to
//   the consumers (setmaxnreg, 152 a consumer thread; 7 % faster at level
//   2 than one producer warp without it). One block per SM. It owns a
//   unit: one kh (the 9 taps (kd, kw)), one slab of at most 64 input
//   channels, one N tile and one split, a contiguous range of the (n, tile
//   column, d) steps in that order. Warpgroup kd holds the three taps kw of
//   its kd (3 x N/2 registers a thread: 96 at N = 64). Slabs and N tiles
//   are balanced (Cin 80 = 2 x 40, Cout 96 = 2 x 48). A slab of 48 or 32
//   channels fills 75 % or 50 % of the M = 64 rows.
// - A TMA ring on mbarriers (csrc/ring.cuh) that walks d: stage q of a
//   column holds x plane q (a (TH+2) x 18 halo, one box per channel group,
//   zero-filled outside the volume by the TMA) and dy plane q - 1 (TH x 16,
//   one box per group). Step d multiplies dy plane d by x planes d - 1, d
//   and d + 1 (warpgroups kd = 0, 1, 2), which lie in stages q - 2, q - 1
//   and q, so each plane of x and dy is staged once per unit and serves
//   three dy planes; a slot is released two stages after it arrived.
//   Planes outside the volume are neither staged nor multiplied. One thread
//   issues every copy; the consumers only wait on barriers and issue wgmma.
// - db: the blocks of kh = 0 and slab 0 sum the staged dy tile on the CUDA
//   cores between issuing the stage's wgmmas and waiting for them, a fixed
//   (column, voxel group) share per thread, then fold the shares in order.
// - One launch, deterministic: with one split every block writes its part
//   of dw and db directly. With more, each unit writes its partial sums,
//   every element once (no atomics on the result), to its split's slice of
//   a float32 workspace; the launch is cooperative (every block resident at
//   once), the blocks meet at a grid barrier (integer atomics), and then
//   all threads sum the splits of every output in split order. The
//   barrier's two counters reset themselves when the last block leaves.
//   The wrapper picks the splits so that the units fill the SMs once.
// Bounds: any N, D, H, W with N * D * tiles < 2^31; the workspace is the
// caller's (nsplit * (27 Cin Cout + Cout) floats).

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int TW = 16, HW = TW + 2;      // output tile width, halo width
constexpr int TH = 8, HH = TH + 2;       // output tile height, halo height
constexpr int NWG = 3;                   // consumer warpgroups, one per kd
constexpr int NCONS = 128 * NWG;         // consumer threads
constexpr int NTHREADS = NCONS + 128;    // and the producer warpgroup
constexpr int NCWARPS = NCONS / 32;
constexpr int STAGES = 5;                // ring slots: 3 in use + 2 ahead
// registers a thread (setmaxnreg): 384 x 152 + 128 x 40 <= 64 K
constexpr int CONSUMER_REGS = 152, PRODUCER_REGS = 40;
constexpr int MAXG = 8;                  // 8-channel groups of an M = 64 slab
constexpr int XG_BYTES = HH * HW * 16;   // one group's halo plane (a TMA box)
constexpr int XG_PITCH = (XG_BYTES + 127) / 128 * 128;
// a slot keeps room for all 8 groups, so A's 64 rows are always inside the
// shared memory (rows past the slab read stale data and are not stored)
constexpr int X_BYTES = MAXG * XG_PITCH;
constexpr int DG_BYTES = TH * TW * 16;   // one group's dy plane (a TMA box)
constexpr int KSTEP = 128;               // LBO: the next 8 voxels along K

template <int N>
struct Cfg {
  static constexpr int SLOT = X_BYTES + (N / 8) * DG_BYTES;
  static constexpr int DBS = NCONS * 2 * 4;          // db shares (floats)
  static constexpr int SMEM = STAGES * SLOT + DBS + 2 * STAGES * 8;
};

struct Maps {
  CUtensorMap x, dy;
};

struct Args {
  float* part;        // (nsplit, ndw + cout) partial sums, or null (1 split)
  float* dw;          // (3, 3, 3, cin, cout)
  float* db;          // (cout)
  unsigned* bar;      // grid barrier: arrivals, departures (zero at launch)
  int N, D, H, W, cin, cout;
  int cs, nslab, nnt;              // slab width, slabs, N tiles
  int tiles_w, tiles_hw, steps;    // steps = N * tiles_hw * D
  int nsplit, groups, units, ndw;  // groups = 3 * nslab * nnt
};

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B MN-major in shared memory
// (the transpose immediates 1, 1), accumulating into d.
template <int N>
__device__ __forceinline__ void wgmma_tt(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tt<8>(float (&d)[4], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<16>(float (&d)[8], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<32>(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<40>(float (&d)[20], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<48>(float (&d)[24], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of an MN-major operand, no swizzle: start
// address, LBO = the step between core matrices along K, SBO = the step
// along M (or N), each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Barrier among the consumer warps only (the producer warpgroup is
// elsewhere).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");
}

// A position in a block's stream of stages: unit, then the split's column
// segments, then the stage q = max(da - 1, 0) .. db of a segment.
struct Walk {
  int unit;                       // >= units: done
  int kh, slab, nt, split;
  int t, t_end;                   // the segment's first step, the split's end
  int n, h0, w0, da, db, q;       // the segment: column, planes [da, db)

  __device__ __forceinline__ void start(int u, const Args& a) {
    unit = u;
    if (u >= a.units) return;
    const int g = u % a.groups;
    split = u / a.groups;
    kh = g % 3;
    slab = (g / 3) % a.nslab;
    nt = g / (3 * a.nslab);
    t = (int)((long long)a.steps * split / a.nsplit);
    t_end = (int)((long long)a.steps * (split + 1) / a.nsplit);
    segment(a);
  }
  __device__ __forceinline__ void segment(const Args& a) {
    const int c = t / a.D;
    da = t - c * a.D;
    db = min(a.D, da + (t_end - t));
    n = c / a.tiles_hw;
    const int hw = c - n * a.tiles_hw;
    h0 = (hw / a.tiles_w) * TH;
    w0 = (hw % a.tiles_w) * TW;
    q = max(da - 1, 0);
  }
  __device__ __forceinline__ bool seg_end() const { return q == db; }
  __device__ __forceinline__ bool unit_end() const {
    return q == db && t + (db - da) >= t_end;
  }
  __device__ __forceinline__ void advance(const Args& a) {
    if (q < db) {
      ++q;
      return;
    }
    t += db - da;
    if (t < t_end)
      segment(a);
    else
      start(unit + gridDim.x, a);
  }
};

// The producer: announce and issue the copies of stage w into `slot`: x
// plane q (when inside the volume) and dy plane q - 1 (when in the segment).
template <int N>
__device__ __forceinline__ void produce(const Walk& w, char* slot,
                                        uint64_t* full, const Maps& maps,
                                        const Args& a) {
  const bool hx = w.q < a.D;
  const bool hdy = w.q - 1 >= w.da;
  const int gx = a.cs / 8;
  mbar_expect_tx(full, (hx ? gx * XG_BYTES : 0) +
                           (hdy ? (N / 8) * DG_BYTES : 0));
  if (hx)
    for (int g = 0; g < gx; ++g)
      tma_load_5d(slot + g * XG_PITCH, &maps.x, full, w.slab * a.cs + g * 8,
                  w.w0 - 1, w.h0 - 1, w.q, w.n);
  if (hdy)
    for (int g = 0; g < N / 8; ++g)
      tma_load_5d(slot + X_BYTES + g * DG_BYTES, &maps.dy, full,
                  w.nt * N + g * 8, w.w0, w.h0, w.q - 1, w.n);
}

// Issue (not wait for) the MMAs of one warpgroup and one step: the three
// taps kw of its (kh, kd) over the TH rows of the tile, 16 voxels a row.
template <int N>
__device__ __forceinline__ void mma_step(uint32_t xs, uint32_t dys, int kh,
                                         float (&acc)[3][N / 2]) {
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) fence_regs(acc[kw]);
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const uint64_t db = gmma_desc(dys + r * TW * 16, KSTEP, DG_BYTES);
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      wgmma_tt<N>(acc[kw],
                  gmma_desc(xs + ((r + kh) * HW + kw) * 16, KSTEP, XG_PITCH),
                  db);
  }
  wgmma_commit();
}

// db: consumer thread t owns output columns (2p, 2p + 1) and the voxels
// v0, v0 + VG, ... of every staged dy tile.
template <int N>
struct DbShare {
  static constexpr int P = N / 2, VG = NCONS / P;
};

template <int N>
__device__ __forceinline__ void db_add(const char* dys, float& s0,
                                       float& s1) {
  constexpr int P = DbShare<N>::P, VG = DbShare<N>::VG;
  const int t = threadIdx.x;
  if (t >= VG * P) return;
  const int co = 2 * (t % P);
  const char* base = dys + (co >> 3) * DG_BYTES + (co & 7) * 2;
  for (int v = t / P; v < TH * TW; v += VG) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(base + v * 16));
    s0 += f.x;
    s1 += f.y;
  }
}

// Fold the threads' db shares in voxel-group order and write columns co0 ..
template <int N>
__device__ __forceinline__ void db_fold(float* dbs, float s0, float s1,
                                        float* out, int co0, int cout) {
  constexpr int P = DbShare<N>::P, VG = DbShare<N>::VG;
  const int t = threadIdx.x;
  if (t < VG * P) {
    dbs[(t / P) * N + 2 * (t % P)] = s0;
    dbs[(t / P) * N + 2 * (t % P) + 1] = s1;
  }
  consumers_sync();
  if (t < N && co0 + t < cout) {
    float s = 0.f;
    for (int v = 0; v < VG; ++v) s += dbs[v * N + t];
    out[co0 + t] = s;
  }
  consumers_sync();
}

// Write a warpgroup's three taps (kh, kw, kd) of the unit to out (dw's
// layout) and zero the accumulators. Element e of an m64 tile: row (input
// channel of the slab) and column (output channel of the N tile), the wgmma
// D fragment layout.
template <int N>
__device__ __forceinline__ void store(float (&acc)[3][N / 2], const Walk& w,
                                      int kd, float* out, const Args& a) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const bool even = (a.cout & 1) == 0;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    float* base = out + (size_t)((w.kh * 3 + kw) * 3 + kd) * a.cin * a.cout;
#pragma unroll
    for (int e = 0; e < N / 2; e += 2) {
      const int m = warp * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
      const int ci = w.slab * a.cs + m;
      const int co = w.nt * N + (e >> 2) * 8 + (lane & 3) * 2;
      if (m < a.cs && ci < a.cin && co < a.cout) {
        float* dst = base + (size_t)ci * a.cout + co;
        if (even) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[kw][e], acc[kw][e + 1]);
        } else {
          dst[0] = acc[kw][e];
          if (co + 1 < a.cout) dst[1] = acc[kw][e + 1];
        }
      }
      acc[kw][e] = 0.f;
      acc[kw][e + 1] = 0.f;
    }
  }
}

// With splits: a grid barrier (every block is resident: the launch is
// cooperative), then the splits of every output summed in split order by
// all threads.
__device__ __forceinline__ void reduce_splits(const Args& a) {
  if (a.part == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&a.bar[0], 1u);
    uint32_t polls = 0;
    while (*reinterpret_cast<volatile unsigned*>(&a.bar[0]) < gridDim.x) {
      if (++polls == (1u << 28)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  const int sp = a.ndw + a.cout;
  for (int i = blockIdx.x * NTHREADS + threadIdx.x; i < sp;
       i += gridDim.x * NTHREADS) {
    float v = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.nsplit; ++s) v += __ldcg(a.part + (size_t)s * sp + i);
    if (i < a.ndw)
      a.dw[i] = v;
    else
      a.db[i - a.ndw] = v;
  }
  __syncthreads();
  // the last block to leave resets the counters for the next launch
  if (threadIdx.x == 0 && atomicAdd(&a.bar[1], 1u) == gridDim.x - 1) {
    atomicExch(&a.bar[0], 0u);
    atomicExch(&a.bar[1], 0u);
  }
}

template <int N>
__global__ void __launch_bounds__(NTHREADS, 1)
    dw_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int SLOT = Cfg<N>::SLOT;
  extern __shared__ __align__(128) char smem[];
  float* dbs = reinterpret_cast<float*>(smem + STAGES * SLOT);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * SLOT + Cfg<N>::DBS);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCWARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, read through a shuffle so that the compiler knows it is
  // the same in every thread of a warp (a wgmma in a branch it takes for
  // divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  // the producer warpgroup gives registers to the consumers (the two
  // branches never meet again)
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS) {
      // stage k fills slot k % STAGES once the consumers have released its
      // use k / STAGES - 1
      Walk w;
      w.start(blockIdx.x, a);
      for (int k = 0; w.unit < a.units; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty[s], (k / STAGES - 1) & 1);
        produce<N>(w, smem + s * SLOT, &full[s], maps, a);
        w.advance(a);
      }
    }
    reduce_splits(a);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int kd = wg;
    const uint32_t base = smem_u32(smem);
    float acc[3][N / 2];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[kw][e] = 0.f;
    float s0 = 0.f, s1 = 0.f;
    Walk w;
    w.start(blockIdx.x, a);
    int rel = 0;                       // the next stage to release
    for (int k = 0; w.unit < a.units; ++k) {
      mbar_wait_asm(&full[k % STAGES], (k / STAGES) & 1);
      const bool db_blk = w.kh == 0 && w.slab == 0;
      if (w.q - 1 >= w.da) {
        // step d = q - 1: dy plane d (this stage) times x plane d + kd - 1
        // (stage k - 2 + kd)
        const int p = w.q - 2 + kd;
        const bool mm = p >= 0 && p < a.D;
        const uint32_t dys = base + (k % STAGES) * SLOT + X_BYTES;
        if (mm)
          mma_step<N>(base + ((k - 2 + kd) % STAGES) * SLOT, dys, w.kh, acc);
        if (db_blk)
          db_add<N>(smem + (k % STAGES) * SLOT + X_BYTES, s0, s1);
        if (mm) {
          wgmma_wait_all();
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) fence_regs(acc[kw]);
        }
      }
      // a stage's x plane serves the two steps after it; at a segment's end
      // every stage still held goes
      const int last = w.seg_end() ? k : k - 2;
      __syncwarp();
      for (; rel <= last; ++rel)
        if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[rel % STAGES]);
      if (w.unit_end()) {
        float* out = a.part ? a.part + (size_t)w.split * (a.ndw + a.cout)
                            : a.dw;
        store<N>(acc, w, kd, out, a);
        if (db_blk) {
          db_fold<N>(dbs, s0, s1, a.part ? out + a.ndw : a.db, w.nt * N,
                     a.cout);
          s0 = s1 = 0.f;
        }
      }
      w.advance(a);
    }
    reduce_splits(a);
  }
}

// TMA map of an NDHWC bf16 tensor of c channels: dims (C, W, H, D, N), box
// (8, bw, bh, 1, 1): one 8-channel group of a plane tile.
cudaError_t plane_map(CUtensorMap* map, const void* t, int c, int bw, int bh,
                      const Args& a) {
  const uint64_t dims[5] = {(uint64_t)c, (uint64_t)a.W, (uint64_t)a.H,
                            (uint64_t)a.D, (uint64_t)a.N};
  const uint64_t s1 = (uint64_t)c * 2;
  const uint64_t strides[4] = {s1, s1 * a.W, s1 * a.W * a.H,
                               s1 * a.W * a.H * a.D};
  const uint32_t box[5] = {8, (uint32_t)bw, (uint32_t)bh, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, t, dims,
                      strides, box);
}

template <int N>
int launch(const void* x, int cx, const void* dy, int cdy, Args a, int grid,
           int device, cudaStream_t s) {
  constexpr int SMEM = Cfg<N>::SMEM;
  // blocks per SM the shared memory allows, asked once per device
  static int per_sm[64] = {0};
  static int sms[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        dw_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int nb = 0, nsm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, dw_kernel<N>,
                                                        NTHREADS, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    sms[device] = nsm;
    per_sm[device] = nb;
  }
  Maps maps;
  cudaError_t err = plane_map(&maps.x, x, cx, HW, HH, a);
  if (err == cudaSuccess) err = plane_map(&maps.dy, dy, cdy, TW, TH, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.part == nullptr) {
    dw_kernel<N><<<grid, NTHREADS, SMEM, s>>>(maps, a);
    return static_cast<int>(cudaGetLastError());
  }
  if (grid > per_sm[device] * sms[device])
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {(void*)&maps, (void*)&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (const void*)dw_kernel<N>, dim3(grid), dim3(NTHREADS), args, SMEM, s));
}

}  // namespace

// x (n, d, h, w, cx) and dy (..., cdy) bf16, of which the first cin and cout
// channels are the conv's; dw (3, 3, 3, cin, cout) and db (cout) f32. The
// plan (ops/conv333_dw.py:plan): slabs of cs input channels, nnt N tiles of
// ntile, nsplit splits, grid blocks. part: (nsplit, 27 cin cout + cout)
// floats and bar two zeroed unsigned counters when nsplit > 1, else null.
extern "C" int conv333_dw_launch(const void* x, int cx, const void* dy,
                                 int cdy, void* part, void* bar, void* dw,
                                 void* db, int n, int d, int h, int w,
                                 int cin, int cout, int cs, int nslab,
                                 int ntile, int nnt, int nsplit, int grid,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_hw =
      (long long)((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  const long long steps = (long long)n * tiles_hw * d;
  const long long units = 3LL * nslab * nnt * nsplit;
  if (n < 1 || d < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 ||
      cx % 8 != 0 || cdy % 8 != 0 || cx < cin || cdy < cout ||
      cs % 8 != 0 || cs < 8 || cs > MAXG * 8 || (long long)cs * nslab < cin ||
      nnt < 1 || (long long)ntile * nnt < cout || nsplit < 1 ||
      nsplit > steps || steps > 0x7fffffffLL || units > 0x7fffffffLL ||
      grid < 1 || grid > units || (nsplit > 1) != (part != nullptr) ||
      (nsplit > 1) != (bar != nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(dy) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.part = static_cast<float*>(part);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.bar = static_cast<unsigned*>(bar);
  a.N = n;
  a.D = d;
  a.H = h;
  a.W = w;
  a.cin = cin;
  a.cout = cout;
  a.cs = cs;
  a.nslab = nslab;
  a.nnt = nnt;
  a.tiles_w = (w + TW - 1) / TW;
  a.tiles_hw = (int)tiles_hw;
  a.steps = (int)steps;
  a.nsplit = nsplit;
  a.groups = 3 * nslab * nnt;
  a.units = (int)units;
  a.ndw = 27 * cin * cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ntile) {
    case 8: return launch<8>(x, cx, dy, cdy, a, grid, device, s);
    case 16: return launch<16>(x, cx, dy, cdy, a, grid, device, s);
    case 32: return launch<32>(x, cx, dy, cdy, a, grid, device, s);
    case 40: return launch<40>(x, cx, dy, cdy, a, grid, device, s);
    case 48: return launch<48>(x, cx, dy, cdy, a, grid, device, s);
    case 64: return launch<64>(x, cx, dy, cdy, a, grid, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
