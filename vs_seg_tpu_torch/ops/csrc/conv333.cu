// conv333 — direct (3,3,kd) same-padded convolution for sm_90a, kd in
// {1, 3}, stride 1 or (at kd = 3, one input, no residual) stride (2,2,2),
// with a fused epilogue and an optional fused 1x1x1 residual.
//
// Replaces the TPU kernel vs_seg_tpu/ops/pallas_conv333.py:conv333
// (_conv_kernel), and through ops/rublock.py and ops/l2block.py the convs of
// vs_seg_tpu/ops/pallas_rublock.py:ru_block and
// vs_seg_tpu/ops/pallas_l2block.py:l2_block. With kd = 1 (the "2.5D" levels
// 0-1) it is, through ops/block2d.py and ops/tail2d.py, the conv of
// vs_seg_tpu/ops/experimental/pallas_block2d.py:l2_block2d and
// pallas_tail2d.py:tail_block, and through ops/train_conv.py the dgrad of
// pallas_train.py:conv333_train. At stride 2, through ops/dsconv.py, it is
// vs_seg_tpu/ops/experimental/pallas_dsconv.py:ds_conv (_ds_kernel), the
// encoder's downsample conv. None of the TPU design (Toeplitz band
// matrices, 64-lane channel padding, (rows, 128) flat views, depth-plane
// rings, tap packing, H/W parity streams) is carried over: those exist for
// the MXU and VMEM.
//
//   out[v, co] = act(sum_{taps, ci} x[S v + tap, ci] * w[tap, ci, co]
//                    * scale[co] + shift[co])         (S = 1 or 2)
//                + (sum_ci r[v, ci] * wr[ci, co] + rbias[co])      (optional)
//   act(y) = y >= 0 ? y : alpha[co] * y     (PReLU; ReLU is alpha = 0,
//                                            identity is alpha = 1)
//
// x may be a pair (xa, xb) standing for its channel concat, and so may the
// residual input r; nothing is concatenated in memory.
//
// The unit (U; ru_unit_kernel, through ops/rublock.py:ru_unit): one eval
// encoder ResidualUnit of vs_seg_tpu/ops/pallas_rublock.py:ru_block in one
// cooperative launch, u0 = conv0(x) and out = conv1(u0) + conv1x1(x), as
// the two launches of ops/rublock.py:ru_chain compute them, bit for bit.
//
// Gated (G; stride 1, through ops/l2block.py:l2_block): every staged input,
// the residual's included, is first gated by an attention map,
//   x'[v, ci] = bf16(fmaf(att[v], x[v, ci], x[v, ci]))    (att f32),
// so out = conv(x') (+ conv1x1(r')) with x' never in device memory: the
// conv0 of vs_seg_tpu/ops/pallas_l2block.py:l2_block (_l2block_kernel stage
// D) on the pair that its stage C gated, the same expression and rounding
// as csrc/attgate.cu's gate.
//
// Layout: activations NDHWC bf16 with C % 8 == 0 and 16-byte aligned bases
// (the wrapper pads other channel counts). The epilogue vectors are f32 and
// read where they lie: scale (Cout) or null (1), shift (Cout) or null (0),
// alpha (1 or Cout values) or null (1: identity), residual bias (Cout) or
// null (0), so a call stages nothing for them. The wrapper
// (ops/conv333.py:pack_weights_gmma) packs the weights once per weight
// tensor as bf16 core matrices, the
// operand layout wgmma reads: (ntiles, chunks, kd, 9 taps, N/8, 2, 8, 8) =
// [N tile][16-channel chunk of the inputs, stacked][depth tap][tap kh*3+kw]
// [8 output channels][8-channel half of the chunk][output channel][input
// channel]; the residual weight (ntiles, rchunks, 1, 1, N/8, 2, 8, 8).
// Accumulation is f32; the output is rounded to bf16 once.
//
// What bounds it on the H100: at the (3,3,3) sites (Cin 32-192, Cout
// 48-96) the tensor cores (27 Cin MACs per output value against ~4 bytes
// moved); at the kd = 1 sites of levels 0-1 (16-32 channels) HBM; at
// stride 2 HBM in principle (8 input voxels read per output), in practice
// the ring: each stage stages a halo that overlaps its neighbours' and
// re-reads the 16 x N slab, ~1 GB from L2 at downsample_2 against 0.51 GB
// of HBM traffic.
//
// Design.
// - Implicit GEMM on wgmma: M = output voxels, N = Cout (the whole of it
//   up to 96, rounded up to 8, 16, 32, 48, 64, 80 or 96; wider Cout is
//   split into equal N tiles), K = (input, 16-channel chunk, kd, kh, kw).
//   A block is two warpgroups and owns a TH (H) x 16 (W) tile of one
//   (n, d) plane, cut into 8 x 8 m64 tiles, MT per warpgroup: MT = 4 (TH =
//   32, M = 512) for N <= 48, MT = 2 (TH = 16, M = 256) above, as far as
//   the registers allow. One K step is m64nNk16 with both operands in
//   shared memory (descriptors, no swizzle): the staged halo keeps each
//   position's two 8-channel halves in two planes of 16-byte rows, so the
//   8 output voxels of one row of an m64 tile are one 8 x 16 B core matrix
//   at any (kh, kw) shift. A tap is only a descriptor start address: LBO =
//   one half plane, SBO = one halo row (18 x 16 B).
// - Persistent tile walk: as many blocks per SM as the shared memory holds
//   (the launcher asks the occupancy API); block b takes tiles b, b + grid,
//   ... with (h, w) fastest, then the N tile, then d, so blocks that read
//   the same input planes run together and the 3x re-read of a plane comes
//   from L2.
// - One flat stream of stages per block: (tile, input, chunk, kd plane),
//   then the residual's chunks (centre tap only); depth planes outside the
//   volume are skipped. A STAGES-slot ring (csrc/ring.cuh) keeps
//   STAGES - 1 stages in flight, filled by one producer thread: per stage
//   two TMA box copies of the (TH+2) x (16+2) x 8-channel halo halves
//   (zero-filled outside the volume by the TMA) and one bulk copy of the 9
//   taps' 16 x N weight slab (a flat piece of the packed weight), all on
//   the slot's `full` mbarrier. The consumers only wait on barriers and
//   issue wgmma, so the next tile's loads overlap this tile's MMAs and its
//   epilogue. Why one producer thread: staging with per-thread cp.async
//   and a __syncthreads per stage took 75 % of the time at down_2 unit0
//   even with no MMA at all; thread-side address arithmetic and barriers,
//   not loads or MMAs, bounded it.
// - Epilogue from the accumulator registers: after the last main stage of
//   a tile, scale/shift -> PReLU (+ rbias) in place; the residual's MMAs
//   then accumulate onto the activated value in the same registers; one
//   bf16 rounding at the store. When the residual's input is the conv's
//   own (the decoder blocks), the residual is fused (F): its centre tap
//   runs on the centre plane's main stages, whose slot also carries the
//   residual's 16 x N slab, into a second accumulator set added after the
//   activation, so its halos are not staged twice (for N <= 48, where both
//   accumulator sets fit in the registers).
// - Sizing: one main stage of an M = 256 block is 2 * 256 * 144 * N FLOP
//   (3.5 MFLOP at N = 48) against a 10.4 KB halo and a 288 N byte weight
//   slab (13.8 KB) read from L2. The slab per stage, not HBM, bounds a
//   small M tile: M = 128 was 1.5x slower than M = 256 at down_2 unit0,
//   and M = 512 (where the accumulators fit) is faster again. Three slots
//   beat four and five: more blocks per SM hide more than a deeper ring.
// - Results do not depend on the schedule: every output value is summed
//   by one block in the stream's fixed order.
// - Stride 2 (S = 2; the ds_conv route, kd = 3): output (n, od, oh, ow)
//   reads input planes 2 od + kd - 1, rows 2 oh + kh - 1 and columns
//   2 ow + kw - 1. The input's TMA map views the same memory (N, D, H, W,
//   C) as (N*D, H, W/2, 2, C) (W even; the wrapper pads an odd W with one
//   zero column, the last output's padding tap): view position q holds
//   input columns 2q (parity 0) and 2q + 1 (parity 1). Input column
//   2 ow + kw - 1 is then parity 1 at q = ow - 1 (kw = 0), parity 0 at
//   q = ow (kw = 1) and parity 1 at q = ow (kw = 2). A stage stages four
//   boxes of (8 ch, 1, 17, 2 TH + 1, 1): both parities' two 8-channel
//   halves over view positions ow0 - 1 .. ow0 + 15 and input rows
//   2 oh0 - 1 .. 2 oh0 + 2 TH - 1; each is a plane of 16-byte rows as at
//   S = 1, so the 8 output voxels of a row of an m64 tile are again one
//   core matrix: a tap is a descriptor start (parity plane, row
//   2 oh + kh, position ow + (kw ? 1 : 0)) with SBO = two halo rows. The
//   parity is a dimension of its own (not channels [C, 2C) of a (W/2, 2C)
//   view) so that a chunk's channels past C are zero-filled by the TMA,
//   as at S = 1. Depth planes outside [0, D) are skipped, never staged,
//   so N and D share a map dimension. The weight slab is the same. TH =
//   16 (MT = 2) or 8 (MT = 1), the wrapper's choice (ops/dsconv.py:plan;
//   8 where 16 leaves SMs idle): TH = 32 does not fit (3 slots of 71 KB
//   halo + slab).
// - Gated (G; conv333_gated_kernel): the MMAs read gated rows, each
//   landed slot gated in place, every 16-byte row of both half planes (8
//   fmaf in f32, one bf16 rounding). The block is warp-specialized, as
//   csrc/conv333_dw.cu: the two consumer warpgroups run the ungated loop
//   unchanged but for the barrier they wait on; a producer warp issues the
//   copies; 7 gating warps (GATERS threads) gate. The producer and gating
//   warps hand registers to the consumers (setmaxnreg, 184 a consumer
//   thread), so the instance takes MT = 3 (TH = 24, which divides the
//   flagship's H of 96, 48 and 24) at every N, where the fused residual's
//   second accumulator set fits beside the first at N = 48 (MT = 4 spilled;
//   MT = 2 was 7-40 % slower), and one block per SM. Its epilogue vectors
//   sit in a table in shared memory, filled once per block (a load per
//   column and tile from global memory cost 5 % at up_2).
//   A gating thread loads the att values of its halo positions (the
//   stage's depth plane, rows h0 - 1 .. h0 + TH, columns w0 - 1 .. w0 + 16;
//   0 outside the volume, where the halo is zero-filled and so is x')
//   with plain loads from the f32 map (19 MB at up_2, L2-resident) before
//   it waits for the slot; a TMA box of the map in the slot (20 f32 wide)
//   faulted on the card. The gate is branch-free (a thread past the last
//   position gates scratch rows in a half plane's padding; out-of-volume
//   att is a select). Barrier protocol of stage k (slot s = k % 3), with a
//   third mbarrier per slot, gated[s] (GATERS arrivals a phase):
//     - producer: wait empty[s] for use k / 3 - 1 (k >= 3); announce and
//       issue stage k's copies on full[s];
//     - each gating thread: load its att values; wait full[s]; gate its
//       rows; fence.proxy.async.shared::cta (its generic-proxy writes
//       become visible to the async proxy, wgmma's); arrive on gated[s];
//     - each consumer thread: wait gated[s]; issue and retire stage k's
//       wgmmas; arrive on empty[s] (one arrival per warp, as ungated).
//   The producer refills slot s only after empty[s], so no generic-proxy
//   write of the gate can meet a TMA write of the next use, and a gating
//   thread gates use u + 1 of a slot only after its full phase u + 1,
//   which follows every consumer's release of use u. What did not work
//   (PERF.md, section 6): the consumers gating the next slot between their
//   wgmma commit and wait, with a __syncthreads or an mbarrier per stage,
//   made ptxas serialize every wgmma of the instance (C7520, "compiler-
//   inserted WG.AR in divergent path"; so did any gate before the loop or
//   the stage walk's advance before the MMAs), 1.9x the ungated time; one
//   gating warpgroup whose thread 0 also produced delayed the copies
//   behind the gate (1.7x).
//   Stage order and wgmma sequence are those of the ungated instance, so the
//   output equals conv333 on an explicitly gated input bit for bit.
// - The unit (U; ru_unit_kernel): the two launches of a ResidualUnit each
//   re-read their 16 x N weight slab from L2 with every stage (41 % of the
//   bytes a stage stages at down_2) because one conv333 block serves any
//   conv of the path. Here the blocks of one launch take roles: blocks
//   0 .. p0 - 1 run conv0's tiles (x -> u0), the others conv1's (u0 ->
//   out, then the residual's centre-plane stages on x), each walking its
//   role's tiles as the ungated instance does ((h, w) fastest, then d,
//   then n, so u0's planes complete in order). Each role loads its packed
//   weights into shared memory once (down_2: 82,944 B for conv0, 124,416 +
//   3,072 B for conv1) and its ring stages only halos; a producer warp
//   beside the two consumer warpgroups issues the copies (288 threads, MT
//   = 4, one block per SM at N = 48). Each consumer warp stores its rows
//   of a tile through shared memory (store_rows). u0 goes from role to
//   role through device memory (L2 at these sizes) plane by plane:
//     - each consumer warp of a conv0 block, after storing its rows of a
//       tile: fence.proxy.async.global, __syncwarp, and its lane 0
//       __threadfence + red.release.gpu add 1 to the counter of the
//       tile's (n, d) plane (a per-warp arrival, so no barrier across the
//       warpgroups sits in the consumer loop);
//     - conv1's producer, before the first copy of a tile from u0 plane
//       d' (d - 1 .. d + 1 inside the volume): ld.acquire.gpu on that
//       plane's counter until it reads NWARPS x tiles per plane, then
//       fence.proxy.async.global, so the TMA (async proxy) reads what the
//       generic-proxy stores wrote.
//   conv0 blocks never wait on another block and conv1 blocks wait only on
//   conv0's planes; the launch is cooperative (every block resident), so
//   the waits end. Stage order, wgmma sequence and epilogue are the
//   ungated instance's (activate's arithmetic from a table in shared
//   memory, as G), so u0 and out equal ru_chain(conv333, ...) bit for bit
//   whatever p0 is. The wrapper zeroes the counters and allocates u0.
//   What a clock64() profile of the roles showed (PERF.md, section 6): the
//   slab was not what bounded a stage. Resident weights took conv0 from
//   1.09 to 1.09 ms and conv1 from 1.49-1.55 to 1.31 ms at down_2; the
//   MMAs of a stage ran at the tensor cores' rate, and the epilogue's
//   4-byte scattered stores held the tensor cores idle for 35-60 % of a
//   block's cycles. The unit stores through shared memory instead
//   (store_rows: 16-byte stores of whole output rows), which took the
//   roles to 0.885 and 1.065 ms; with no store at all they take 0.65 and
//   0.99 ms, the rate at which the producer's TMA boxes of 16-byte rows
//   (two per stage, 34 x 18 rows each) arrive.
//   Where a role's weights do not fit beside the ring (N = 64, 80, 96:
//   down_3, down_4, the bottom), the same launch stages each stage's slab
//   with its halo, as conv333 does (RES false), with conv333's MT.
// Bounds: any N, D, H, W; tiles <= 2^31.

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int TW = 16;                   // output tile width
constexpr int NWG = 2;                   // consumer warpgroups per block
constexpr int NTHREADS = 128 * NWG;
constexpr int NWARPS = NTHREADS / 32;
constexpr int STAGES = 3;                // ring slots
constexpr int KC = 16;                   // input channels per stage (wgmma K)
constexpr int MT4_MAX_N = 48;            // N up to which MT = 4
// the gated instance: its producer warp and gating warps (two warpgroups),
// the registers a thread of them and of a consumer warpgroup takes
// (setmaxnreg: 256 x 184 + 256 x 72 = 64 K), its ring slots and m64 tiles
// per consumer warpgroup
constexpr int GTHREADS = 256;
constexpr int GATERS = GTHREADS - 32;
constexpr int CONS_REGS = 184, GATE_REGS = 72;
constexpr int GSTAGES = 3;
constexpr int GMT = 3;
// output channels (N tiles x N) whose epilogue vectors the gated instance
// keeps in shared memory
constexpr int GEPI = 384;

// m64 tiles per warpgroup of a stride-1 kernel: 4 (TH = 32, M = 512) as far
// as the registers allow
template <int N>
constexpr int mt_s1() {
  return N <= MT4_MAX_N ? 4 : 2;
}

// One kernel instance: N width, fused residual (F), stride S, m64 tiles per
// warpgroup MT, gated (G).
template <int N_, bool F_, int S_, int MT_, bool G_ = false>
struct Cfg {
  static constexpr int N = N_, S = S_, MT = MT_;
  static constexpr bool F = F_, G = G_;
  static_assert(!G || S == 1, "the gate is a stride-1 instance");
  static constexpr int TH = 8 * MT;          // tile height (rows of 2 m64)
  // halo: (TH + 2) rows x 18 positions at S = 1; (2 TH + 1) input rows x
  // 17 positions of the W-pair view at S = 2
  static constexpr int HW = S == 1 ? TW + 2 : TW + 1;
  static constexpr int HH = S == 1 ? TH + 2 : 2 * TH + 1;
  static constexpr int HALF_BYTES = HH * HW * 16;   // an 8-channel half plane
  static constexpr int HALF_PITCH = (HALF_BYTES + 127) / 128 * 128;  // TMA dst
  static constexpr int HALO_BYTES = 2 * S * HALF_PITCH;  // S parities x 2
  static constexpr int WBYTES = 9 * KC * N * 2;    // a main stage's slab
  static constexpr int RBYTES = KC * N * 2;         // a residual slab
  // the gate's scratch row: a half plane's padding
  static_assert(!G || HALF_PITCH - HALF_BYTES >= 32, "no scratch rows");
  // a ring slot: the halo, the main slab and, when the residual is fused
  // into the main stages (F), the residual slab; a multiple of 128 bytes
  static constexpr int SLOT = HALO_BYTES + WBYTES + (F ? RBYTES : 0);
  // ring slots; full and empty barriers per slot, and gated (G); the
  // gated instance's epilogue table (scale, shift, alpha, residual bias)
  static constexpr int ST = G ? GSTAGES : STAGES;
  static constexpr int SMEM =
      ST * SLOT + (G ? 3 : 2) * ST * 8 + (G ? 4 * GEPI * 4 : 0);
};

// The residual accumulators of a fused kernel (a dummy otherwise).
template <class C>
using RAcc = float[C::F ? C::MT : 1][C::F ? C::N / 2 : 1];

// TMA maps of the inputs: x[0], x[1], r[0], r[1] (unused ones zero)
struct Maps {
  CUtensorMap m[4];
};

struct Args {
  int nch[2], rch[2];             // 16-channel chunks of each input
  int nch_all, rch_all;           // ... summed (rch_all 0: no residual)
  int res_stages;                 // residual stages per tile (0 when fused)
  const __nv_bfloat16* wm;        // packed main weight
  const __nv_bfloat16* wr;        // packed residual weight, or null
  const float *scale, *shift, *alpha, *rbias;   // each may be null
  int alpha_n;                    // 1 (one slope) or cout
  __nv_bfloat16* out;             // (N, Do, Ho, Wo, cout)
  const float* att;               // the gate's map (G): (N, D, H, W)
  int Nb, D, H, W, cout, kd;      // input sizes
  int Do, Ho, Wo;                 // output sizes ((X - 1) / S + 1)
  int th, tiles_w, tiles_hw, ntiles, total;   // tile height, tile counts
};

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B from shared memory by
// descriptor (both K-major), accumulating into d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                              uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two 8-element K halves) and stride byte offset
// (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// A position in the block's stream of stages. Divisions happen only when
// the walk moves to the next tile.
template <int S>
struct Walk {
  int tile;                  // >= total: done
  int n, d, h0, w0, nt;      // the tile
  int plo, phi;              // depth taps inside the volume
  int j, p;                  // chunk (over both inputs), depth tap
  bool res;                  // in the residual's chunks

  __device__ __forceinline__ void start(int t, const Args& a) {
    tile = t;
    if (t >= a.total) return;
    const int hw = t % a.tiles_hw;
    int rest = t / a.tiles_hw;
    nt = rest % a.ntiles;
    rest /= a.ntiles;
    d = rest % a.Do;
    n = rest / a.Do;
    h0 = (hw / a.tiles_w) * a.th;
    w0 = (hw % a.tiles_w) * TW;
    // depth tap p reads input plane S d + p - c
    const int c = a.kd / 2;
    plo = max(0, c - S * d);
    phi = min(a.kd - 1, a.D - 1 - S * d + c);
    j = 0;
    p = plo;
    res = false;
  }
  __device__ __forceinline__ bool last_main(const Args& a) const {
    return !res && p == phi && j == a.nch_all - 1;
  }
  __device__ __forceinline__ bool last(const Args& a) const {
    return res ? j == a.res_stages - 1
               : (a.res_stages == 0 && last_main(a));
  }
  __device__ __forceinline__ void advance(const Args& a) {
    if (last(a)) {
      start(tile + gridDim.x, a);
    } else if (res) {
      ++j;
    } else if (p < phi) {
      ++p;
    } else if (j < a.nch_all - 1) {
      p = plo;
      ++j;
    } else {
      res = true;
      j = 0;
    }
  }
};

// The producer: announce and issue the copies of stage w into `slot`.
template <class C>
__device__ __forceinline__ void produce(const Walk<C::S>& w, char* slot,
                                        uint64_t* full, const Maps& maps,
                                        const Args& a) {
  constexpr int N = C::N;
  int xi, c0, dz;
  const __nv_bfloat16* wsrc;
  uint32_t wbytes;
  if (!w.res) {
    xi = w.j < a.nch[0] ? 0 : 1;
    c0 = (w.j - (xi ? a.nch[0] : 0)) * KC;
    dz = C::S * w.d + w.p - a.kd / 2;
    wsrc = a.wm +
           (((size_t)w.nt * a.nch_all + w.j) * a.kd + w.p) * 9 * KC * N;
    wbytes = C::WBYTES;
  } else {
    xi = w.j < a.rch[0] ? 2 : 3;
    c0 = (w.j - (xi == 3 ? a.rch[0] : 0)) * KC;
    dz = w.d;
    wsrc = a.wr + ((size_t)w.nt * a.rch_all + w.j) * KC * N;
    wbytes = KC * N * 2;
  }
  // the fused residual's slab of chunk j rides on the centre plane's stage
  const bool fres = C::F && !w.res && w.p == a.kd / 2;
  mbar_expect_tx(full, 2 * C::S * C::HALF_BYTES + wbytes +
                           (fres ? C::RBYTES : 0));
  const CUtensorMap* m = &maps.m[xi];
  if constexpr (C::S == 1) {
    tma_load_5d(slot, m, full, c0, w.w0 - 1, w.h0 - 1, dz, w.n);
    tma_load_5d(slot + C::HALF_PITCH, m, full, c0 + 8, w.w0 - 1, w.h0 - 1,
                dz, w.n);
  } else {
    // the W-pair view (C, parity, W/2, H, N*D): half plane (parity, half)
    // at slot + (2 parity + half) * HALF_PITCH
    const int nd = w.n * a.D + dz;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_5d(slot + q * C::HALF_PITCH, m, full, c0 + (q & 1) * 8, q >> 1,
                  w.w0 - 1, 2 * w.h0 - 1, nd);
  }
  bulk_load(slot + C::HALO_BYTES, wsrc, wbytes, full);
  if (fres)
    bulk_load(slot + C::HALO_BYTES + C::WBYTES,
              a.wr + ((size_t)w.nt * a.rch_all + w.j) * KC * N, C::RBYTES,
              full);
}

// The gate (G), by gating thread t: positions t, t + GATERS, ... of the
// stage's HH x HW halo, GITER<C> of them, each two
// rows (the two 8-channel half planes) under one att value. gate_att loads
// the att values (0 outside the volume, where the halo is zero-filled)
// before the wait for the slot.
template <class C>
constexpr int GITER = (C::HH * C::HW + GATERS - 1) / GATERS;

template <class C>
__device__ __forceinline__ void gate_att(const Walk<C::S>& w, const Args& a,
                                         int t, float (&s)[GITER<C>]) {
  constexpr int NPOS = C::HH * C::HW;
  const int dz = w.res ? w.d : w.d + w.p - a.kd / 2;
  const float* plane = a.att + ((size_t)w.n * a.D + dz) * a.H * a.W;
#pragma unroll
  for (int it = 0; it < GITER<C>; ++it) {
    const int pos = min(it * GATERS + t, NPOS - 1);
    const int r = pos / C::HW, c = pos - r * C::HW;
    const int h = w.h0 - 1 + r, x = w.w0 - 1 + c;
    const bool in = (unsigned)h < (unsigned)a.H && (unsigned)x < (unsigned)a.W;
    const float v = __ldg(plane + (in ? h * a.W + x : 0));
    s[it] = in ? v : 0.f;
  }
}

// x' = bf16(fmaf(att, x, x)) on thread t's rows of a landed slot, in place
// (a thread past the last position gates two scratch rows in the padding
// of half plane 0); then its writes are made visible to the async proxy.
template <class C>
__device__ __forceinline__ void gate_rows(char* slot, int t,
                                          const float (&s)[GITER<C>]) {
  constexpr int NPOS = C::HH * C::HW;
#pragma unroll
  for (int it = 0; it < GITER<C>; ++it) {
    const int pos = it * GATERS + t;
    char* p = slot + (pos < NPOS ? pos * 16 : C::HALF_BYTES);
    uint4* r0 = reinterpret_cast<uint4*>(p);
    uint4* r1 = reinterpret_cast<uint4*>(p + (pos < NPOS ? C::HALF_PITCH
                                                          : 16));
    float f[8], g[8];
    unpack8(*r0, f);
    unpack8(*r1, g);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      f[e] = fmaf(s[it], f[e], f[e]);
      g[e] = fmaf(s[it], g[e], g[e]);
    }
    *r0 = pack8(f);
    *r1 = pack8(g);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Gate stage w's slot once it has landed (its `full` barrier, parity),
// then arrive on its `gated` barrier.
template <class C>
__device__ __forceinline__ void gate(char* slot, const Walk<C::S>& w,
                                     const Args& a, int t, uint64_t* full,
                                     uint64_t* gated, int parity) {
  float s[GITER<C>];
  gate_att<C>(w, a, t, s);
  mbar_wait(full, parity);
  gate_rows<C>(slot, t, s);
  mbar_arrive(gated);
}

// The MMAs of one stage: 9 taps (main) or the centre tap (residual), MT
// m64 tiles per warpgroup; a fused kernel's centre-plane main stage also
// runs the residual's centre tap into racc. halo and wts: the shared
// addresses of the stage's halo and of its weight slab.
template <class C>
__device__ __forceinline__ void compute_at(bool main, bool fres,
                                           uint32_t halo, uint32_t wts,
                                           float (&acc)[C::MT][C::N / 2],
                                           RAcc<C>& racc) {
  constexpr int N = C::N, MT = C::MT, PITCH = C::HALF_PITCH, HW = C::HW;
  constexpr bool F = C::F;
  constexpr int SBO = C::S * HW * 16;   // the next output row of a tile
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
  if constexpr (F) {
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(racc[m]);
  }
  wgmma_fence();
  if (main) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap - kh * 3;
      const uint64_t db = gmma_desc(wts + tap * KC * N * 2, 128, 256);
      // S = 2: input column 2 ow + kw - 1 is parity 1 at view position
      // ow - 1 (kw 0; halo position ow - ow0), parity 0 at ow (kw 1) and
      // parity 1 at ow (kw 2; halo position ow - ow0 + 1)
      const uint32_t plane = C::S == 1 || kw == 1 ? 0 : 2 * PITCH;
      const int col = C::S == 1 ? kw : (kw ? 1 : 0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int mt = wg * MT + m;
        const int pos = ((mt >> 1) * 8 * C::S + kh) * HW + (mt & 1) * 8 + col;
        wgmma_ss<N>(acc[m], gmma_desc(halo + plane + pos * 16, PITCH, SBO),
                    db);
      }
    }
    if constexpr (F) {
      if (fres) {
        const uint64_t dr = gmma_desc(wts + C::WBYTES, 128, 256);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int mt = wg * MT + m;
          const int pos = ((mt >> 1) * 8 + 1) * HW + (mt & 1) * 8 + 1;
          wgmma_ss<N>(racc[m], gmma_desc(halo + pos * 16, PITCH, SBO), dr);
        }
      }
    }
  } else {
    const uint64_t db = gmma_desc(wts, 128, 256);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = wg * MT + m;
      const int pos = ((mt >> 1) * 8 + 1) * HW + (mt & 1) * 8 + 1;
      wgmma_ss<N>(acc[m], gmma_desc(halo + pos * 16, PITCH, SBO), db);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
  if constexpr (F) {
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(racc[m]);
  }
}

// compute on a ring slot that holds the stage's halo and, after it, its
// weight slab(s)
template <class C>
__device__ __forceinline__ void compute(bool main, bool fres,
                                        const char* slot,
                                        float (&acc)[C::MT][C::N / 2],
                                        RAcc<C>& racc) {
  const uint32_t halo = smem_u32(slot);
  compute_at<C>(main, fres, halo, halo + C::HALO_BYTES, acc, racc);
}

// Accumulator element e of an m64 tile: row (voxel of the tile) and column
// (output channel of the N tile), the wgmma D fragment layout.
__device__ __forceinline__ int frag_row(int e) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  return warp * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int e) {
  return (e >> 2) * 8 + (threadIdx.x & 3) * 2 + (e & 1);
}

// scale/shift -> PReLU (+ residual bias, + a fused residual's sum) in
// place.
template <class C>
__device__ __forceinline__ void activate(float (&acc)[C::MT][C::N / 2],
                                         RAcc<C>& racc, int nt,
                                         const Args& a) {
  constexpr int N = C::N, MT = C::MT;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    // padded columns (co >= cout) read channel cout - 1 and are not stored
    const int co = min(nt * N + frag_col(e), a.cout - 1);
    const float s = a.scale ? __ldg(a.scale + co) : 1.f;
    const float h = a.shift ? __ldg(a.shift + co) : 0.f;
    const float al =
        a.alpha ? __ldg(a.alpha + (a.alpha_n == 1 ? 0 : co)) : 1.f;
    const float rb = a.rbias ? __ldg(a.rbias + co) : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[m][e] * s + h;
      v = v >= 0.f ? v : al * v;
      if constexpr (C::F) {
        v += racc[m][e];
        racc[m][e] = 0.f;
      }
      acc[m][e] = v + rb;
    }
  }
}

// activate, the epilogue vectors read from the gated instance's table in
// shared memory (ep[0..3]: scale, shift, alpha, residual bias per padded
// output channel): the same values, without a global load per column
// and tile.
template <class C>
__device__ __forceinline__ void activate_table(
    float (&acc)[C::MT][C::N / 2], RAcc<C>& racc, int nt, const float* ep) {
  constexpr int N = C::N, MT = C::MT;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int co = nt * N + frag_col(e);
    const float s = ep[co], h = ep[GEPI + co], al = ep[2 * GEPI + co],
                rb = ep[3 * GEPI + co];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[m][e] * s + h;
      v = v >= 0.f ? v : al * v;
      if constexpr (C::F) {
        v += racc[m][e];
        racc[m][e] = 0.f;
      }
      acc[m][e] = v + rb;
    }
  }
}

// Round to bf16 and store the tile's outputs; zero the accumulators.
template <class C>
__device__ __forceinline__ void store(float (&acc)[C::MT][C::N / 2],
                                      const Walk<C::S>& t, const Args& a) {
  constexpr int N = C::N, MT = C::MT;
  const int wg = threadIdx.x >> 7;
  const bool even = (a.cout & 1) == 0;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = wg * MT + m;
#pragma unroll
    for (int e = 0; e < N / 2; e += 2) {
      const int row = frag_row(e);
      const int h = t.h0 + (mt >> 1) * 8 + (row >> 3);
      const int w = t.w0 + (mt & 1) * 8 + (row & 7);
      const int co = t.nt * N + frag_col(e);
      if (h < a.Ho && w < a.Wo && co < a.cout) {
        __nv_bfloat16* dst =
            a.out +
            ((((size_t)t.n * a.Do + t.d) * a.Ho + h) * a.Wo + w) * a.cout +
            co;
        if (even) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[m][e], acc[m][e + 1]);
        } else {
          dst[0] = __float2bfloat16_rn(acc[m][e]);
          if (co + 1 < a.cout) dst[1] = __float2bfloat16_rn(acc[m][e + 1]);
        }
      }
      acc[m][e] = 0.f;
      acc[m][e + 1] = 0.f;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(NTHREADS)
    conv333_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int N = C::N, MT = C::MT, SLOT = C::SLOT;
  constexpr bool F = C::F;
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * SLOT);
  uint64_t* empty = full + STAGES;
  const bool producer = threadIdx.x == 0;
  if (producer) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  float acc[MT][N / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
  RAcc<C> racc;
  if constexpr (F) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) racc[m][e] = 0.f;
  }

  Walk<C::S> prod, cons;
  prod.start(blockIdx.x, a);
  cons = prod;
  if (producer) {
    for (int s = 0; s < STAGES - 1 && prod.tile < a.total; ++s) {
      produce<C>(prod, smem + s * SLOT, &full[s], maps, a);
      prod.advance(a);
    }
  }
  // stage k sits in slot k % STAGES, its use k / STAGES of that slot
  for (int k = 0; cons.tile < a.total; ++k) {
    const int slot = k % STAGES;
    if (producer && prod.tile < a.total) {
      // stage k + STAGES - 1 reuses the slot of stage k - 1
      const int ps = (k + STAGES - 1) % STAGES;
      if (k >= 1) mbar_wait(&empty[ps], ((k - 1) / STAGES) & 1);
      produce<C>(prod, smem + ps * SLOT, &full[ps], maps, a);
      prod.advance(a);
    }
    __syncwarp();
    mbar_wait(&full[slot], (k / STAGES) & 1);
    compute<C>(!cons.res, F && !cons.res && cons.p == a.kd / 2,
               smem + slot * SLOT, acc, racc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
    if (cons.last_main(a)) activate<C>(acc, racc, cons.nt, a);
    if (cons.last(a)) store<C>(acc, cons, a);
    cons.advance(a);
  }
}

// The gated instance (G): the two consumer warpgroups run the ungated
// kernel's loop, waiting on each slot's `gated` barrier instead of `full`;
// threads NTHREADS .. are a producer warp (one thread issues the copies)
// and GATERS gating threads. See the header for the protocol.
template <class C>
__global__ void __launch_bounds__(NTHREADS + GTHREADS, 1)
    conv333_gated_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int N = C::N, MT = C::MT, SLOT = C::SLOT, ST = C::ST;
  constexpr bool F = C::F;
  extern __shared__ __align__(128) char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SLOT);
  uint64_t* empty = full + ST;
  uint64_t* gated = full + 2 * ST;
  float* ep = reinterpret_cast<float*>(gated + ST);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWARPS);
      mbar_init(&gated[s], GATERS);
    }
    mbar_init_fence();
  }
  // the epilogue table, as activate reads the vectors (padded columns
  // take channel cout - 1's values; they are not stored)
  for (int i = threadIdx.x; i < a.ntiles * N; i += blockDim.x) {
    const int co = min(i, a.cout - 1);
    ep[i] = a.scale ? a.scale[co] : 1.f;
    ep[GEPI + i] = a.shift ? a.shift[co] : 0.f;
    ep[2 * GEPI + i] = a.alpha ? a.alpha[a.alpha_n == 1 ? 0 : co] : 1.f;
    ep[3 * GEPI + i] = a.rbias ? a.rbias[co] : 0.f;
  }
  __syncthreads();
  // the warpgroup, read through a shuffle so that the compiler knows it is
  // the same in every thread of a warp (a wgmma in a branch it takes for
  // divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg >= NWG) {
    // the producer and gating warps hand registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GATE_REGS));
    const int t = threadIdx.x - NTHREADS;
    Walk<1> g;
    g.start(blockIdx.x, a);
    if (t < 32) {
      // the producer: stage k into slot k % ST once the consumers have
      // released its use k / ST - 1
      if (t == 0) {
        for (int k = 0; g.tile < a.total; ++k) {
          const int slot = k % ST;
          if (k >= ST) mbar_wait(&empty[slot], ((k - ST) / ST) & 1);
          produce<C>(g, smem + slot * SLOT, &full[slot], maps, a);
          g.advance(a);
        }
      }
    } else {
      for (int k = 0; g.tile < a.total; ++k) {
        const int slot = k % ST;
        gate<C>(smem + slot * SLOT, g, a, t - 32, &full[slot], &gated[slot],
                (k / ST) & 1);
        g.advance(a);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
    float acc[MT][N / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
    RAcc<C> racc;
    if constexpr (F) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) racc[m][e] = 0.f;
    }
    Walk<1> cons;
    cons.start(blockIdx.x, a);
    for (int k = 0; cons.tile < a.total; ++k) {
      const int slot = k % ST;
      mbar_wait(&gated[slot], (k / ST) & 1);
      compute<C>(!cons.res, F && !cons.res && cons.p == a.kd / 2,
                 smem + slot * SLOT, acc, racc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
      if (cons.last_main(a)) activate_table<C>(acc, racc, cons.nt, ep);
      if (cons.last(a)) store<C>(acc, cons, a);
      cons.advance(a);
    }
  }
}

// ---- The encoder ResidualUnit (U): conv0 and conv1 in one launch ----
//
// One Args per role: 0 is conv0 (x -> u0, no residual), 1 is conv1 (u0 ->
// out, + the 1x1 residual of x as separate centre-plane stages). Each
// role's packed weights (one N tile) stay resident in shared memory.
struct Unit {
  Args a[2];
  int wmain[2];        // bytes of each role's packed main weight
  int wres;            // bytes of conv1's packed residual weight
  int wmax;            // the weight region: max(wmain[0], wmain[1] + wres)
  int* cnt;            // (N * D): conv0 warps that stored their rows of a
                       // u0 plane, zeroed by the caller
  int target;          // arrivals that complete a plane: NWARPS x tiles
  int p0;              // blocks 0 .. p0 - 1 run conv0, the others conv1
};

// The unit's threads: one producer warp (its thread 0 issues every copy)
// beside the two consumer warpgroups.
constexpr int UTHREADS = NTHREADS + 32;

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Wait until conv0's warps have stored every row of a u0 plane (its counter
// reads `target`), then order the TMA copies that follow after those
// generic-proxy stores. Traps after ~2^24 polls (a lost arrival surfaces as
// a launch error, not a hung card).
__device__ __forceinline__ void wait_plane(const int* c, int target) {
  uint32_t polls = 0;
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(c)
                 : "memory");
    if (v >= target) break;
    if (++polls == (1u << 24)) __trap();
    __nanosleep(100);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A unit stage's copies: the halo alone (the weights are resident), from
// the main input (map 0: x for conv0, u0 for conv1) or the residual's
// (map 2: x).
template <class C>
__device__ __forceinline__ void produce_halo(const Walk<1>& w, char* slot,
                                             uint64_t* full, const Maps& maps,
                                             const Args& a) {
  const int c0 = w.j * KC;
  const int dz = w.res ? w.d : w.d + w.p - a.kd / 2;
  const CUtensorMap* m = &maps.m[w.res ? 2 : 0];
  mbar_expect_tx(full, 2 * C::HALF_BYTES);
  tma_load_5d(slot, m, full, c0, w.w0 - 1, w.h0 - 1, dz, w.n);
  tma_load_5d(slot + C::HALF_PITCH, m, full, c0 + 8, w.w0 - 1, w.h0 - 1, dz,
              w.n);
}

// The unit's store of a tile (one N tile, cout == N): each consumer warp
// rounds its rows of one m64 tile at a time to bf16 into its staging rows
// in shared memory (16 rows x N), then writes them out 16 bytes a lane,
// whole output rows of consecutive voxels. The 4-byte scattered stores of
// `store` took 35-60 % of a unit block's cycles at down_2 (a clock64()
// profile); the same values in this order took 55-60 % as long.
// Zeroes the accumulators.
template <class C>
__device__ __forceinline__ void store_rows(float (&acc)[C::MT][C::N / 2],
                                           const Walk<1>& t, const Args& a,
                                           char* stg) {
  constexpr int N = C::N, MT = C::MT, CH = N * 2 / 16;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3,
            lane = threadIdx.x & 31;
  __nv_bfloat162* s2 = reinterpret_cast<__nv_bfloat162*>(stg);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = wg * MT + m;
#pragma unroll
    for (int e = 0; e < N / 2; e += 2) {
      // frag_row(e) - 16 * warp: the warp's row of the m64 tile
      const int r = (lane >> 2) + ((e >> 1) & 1) * 8;
      s2[(r * N + frag_col(e)) / 2] =
          __floats2bfloat162_rn(acc[m][e], acc[m][e + 1]);
      acc[m][e] = 0.f;
      acc[m][e + 1] = 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int c = lane; c < 16 * CH; c += 32) {
      const int r = c / CH, q = c - r * CH;
      const int row = warp * 16 + r;
      const int h = t.h0 + (mt >> 1) * 8 + (row >> 3);
      const int w = t.w0 + (mt & 1) * 8 + (row & 7);
      if (h < a.Ho && w < a.Wo)
        *reinterpret_cast<uint4*>(
            a.out + ((((size_t)t.n * a.Do + t.d) * a.Ho + h) * a.Wo + w) *
                        a.cout + q * 8) =
            reinterpret_cast<const uint4*>(stg)[c];
    }
    __syncwarp();
  }
}

// One block of role R (0: conv0, 1: conv1): its resident weights (RES),
// its epilogue table, then the persistent walk over its role's tiles
// (tiles first, first + step, ...), the producer warp ahead of the
// consumers on a ring of ST slots: halos alone (RES), or each halo with
// its stage's weight slab as conv333 stages them (the weights too large
// to stay). conv0's consumer warps each announce their stored rows of a
// tile on the tile's plane counter; conv1's producer waits on the counters
// of the planes a stage reads before it copies their halo.
template <class C, int ST, int R, bool RES>
__device__ __forceinline__ void unit_role(const Maps& maps, const Args& a,
                                          const Unit& u, char* smem,
                                          int first, int step) {
  constexpr int N = C::N, MT = C::MT;
  constexpr int SLOT = RES ? C::HALO_BYTES : C::SLOT;
  // shared memory: the ring, the weights, each consumer warp's staging
  // rows, the epilogue table, the barriers
  char* wreg = smem + ST * SLOT;
  char* stg = wreg + u.wmax;
  float* ep = reinterpret_cast<float*>(stg + NWARPS * 16 * N * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(ep + 4 * GEPI);
  uint64_t* empty = full + ST;
  uint64_t* wbar = empty + ST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWARPS);
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int co = min(i, a.cout - 1);
    ep[i] = a.scale ? a.scale[co] : 1.f;
    ep[GEPI + i] = a.shift ? a.shift[co] : 0.f;
    ep[2 * GEPI + i] = a.alpha ? a.alpha[a.alpha_n == 1 ? 0 : co] : 1.f;
    ep[3 * GEPI + i] = a.rbias ? a.rbias[co] : 0.f;
  }
  __syncthreads();
  // the warpgroup, read through a shuffle so that the compiler knows it is
  // the same in every thread of a warp (a wgmma in a branch it takes for
  // divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg >= NWG) {
    if (threadIdx.x != NTHREADS) return;
    // the producer: the resident weights once, by flat bulk copies of one
    // stage's slab each, on wbar; then every stage's halo (and slab)
    if constexpr (RES) {
      const char* wm = reinterpret_cast<const char*>(a.wm);
      mbar_expect_tx(wbar, u.wmain[R] + (R ? u.wres : 0));
      for (int off = 0; off < u.wmain[R]; off += C::WBYTES)
        bulk_load(wreg + off, wm + off, C::WBYTES, wbar);
      if constexpr (R == 1) {
        const char* wr = reinterpret_cast<const char*>(a.wr);
        for (int off = 0; off < u.wres; off += C::RBYTES)
          bulk_load(wreg + u.wmain[1] + off, wr + off, C::RBYTES, wbar);
      }
    }
    Walk<1> w;
    w.start(first, a);
    int okt = -1;          // the tile whose planes `ok` holds
    unsigned ok = 0;       // bit p: the plane of depth tap p is complete
    for (int k = 0; w.tile < a.total; ++k) {
      const int slot = k % ST;
      if (k >= ST) mbar_wait(&empty[slot], ((k - ST) / ST) & 1);
      if constexpr (R == 1) {
        if (!w.res) {
          if (w.tile != okt) {
            okt = w.tile;
            ok = 0;
          }
          if (!((ok >> w.p) & 1)) {
            wait_plane(u.cnt + (size_t)w.n * a.D + w.d + w.p - a.kd / 2,
                       u.target);
            ok |= 1u << w.p;
          }
        }
      }
      if constexpr (RES)
        produce_halo<C>(w, smem + slot * SLOT, &full[slot], maps, a);
      else
        produce<C>(w, smem + slot * SLOT, &full[slot], maps, a);
      if (w.last(a))
        w.start(w.tile + step, a);
      else
        w.advance(a);
    }
    return;
  }
  float acc[MT][N / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
  RAcc<C> racc;
  const uint32_t ring = smem_u32(smem), wbase = smem_u32(wreg);
  if constexpr (RES) mbar_wait(wbar, 0);
  Walk<1> cons;
  cons.start(first, a);
  for (int k = 0; cons.tile < a.total; ++k) {
    const int slot = k % ST;
    mbar_wait(&full[slot], (k / ST) & 1);
    // the stage's slab in the resident weights: (chunk, depth tap) of the
    // main weight, or the residual's chunk after it; else after its halo
    const uint32_t halo = ring + slot * SLOT;
    const uint32_t wts =
        RES ? wbase + (cons.res ? u.wmain[1] + cons.j * C::RBYTES
                                : (cons.j * a.kd + cons.p) * C::WBYTES)
            : halo + C::HALO_BYTES;
    compute_at<C>(!cons.res, false, halo, wts, acc, racc);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[slot]);
    if (cons.last_main(a)) activate_table<C>(acc, racc, 0, ep);
    if (cons.last(a)) {
      store_rows<C>(acc, cons, a, stg + (threadIdx.x >> 5) * 16 * N * 2);
      if constexpr (R == 0) {
        // this warp's rows of the tile are stored: make them visible to
        // the async proxy (conv1's TMA) and announce them at gpu scope
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        __syncwarp();
        if ((threadIdx.x & 31) == 0) {
          __threadfence();
          red_release_add(u.cnt + (size_t)cons.n * a.D + cons.d, 1);
        }
      }
      cons.start(cons.tile + step, a);
    } else {
      cons.advance(a);
    }
  }
}

// The unit: blocks 0 .. p0 - 1 run conv0's tiles, the others conv1's; one
// cooperative launch, so every block is resident and conv1's waits on
// conv0's planes always end.
template <class C, int ST, bool RES>
__global__ void __launch_bounds__(UTHREADS, 1)
    ru_unit_kernel(const __grid_constant__ Maps m0,
                   const __grid_constant__ Maps m1,
                   const __grid_constant__ Unit u) {
  extern __shared__ __align__(128) char smem[];
  if ((int)blockIdx.x < u.p0)
    unit_role<C, ST, 0, RES>(m0, u.a[0], u, smem, blockIdx.x, u.p0);
  else
    unit_role<C, ST, 1, RES>(m1, u.a[1], u, smem, blockIdx.x - u.p0,
                             gridDim.x - u.p0);
}

// TMA map of one NDHWC bf16 input: one 8-channel half plane of a halo per
// box. S = 1: dims (C, W, H, D, N), box (8, 18, TH + 2, 1, 1). S = 2: the
// W-pair view, dims (C, 2, W/2, H, N*D), box (8, 1, 17, 2 TH + 1, 1).
template <class C>
cudaError_t input_map(CUtensorMap* map, const void* x, int c,
                      const Args& a) {
  const uint64_t s1 = (uint64_t)c * 2;
  if constexpr (C::S == 1) {
    const uint64_t dims[5] = {(uint64_t)c, (uint64_t)a.W, (uint64_t)a.H,
                              (uint64_t)a.D, (uint64_t)a.Nb};
    const uint64_t strides[4] = {s1, s1 * a.W, s1 * a.W * a.H,
                                 s1 * a.W * a.H * a.D};
    const uint32_t box[5] = {8, C::HW, C::HH, 1, 1};
    return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, x, dims,
                        strides, box);
  } else {
    const uint64_t dims[5] = {(uint64_t)c, 2, (uint64_t)a.W / 2,
                              (uint64_t)a.H, (uint64_t)a.Nb * a.D};
    const uint64_t strides[4] = {s1, 2 * s1, s1 * a.W, s1 * a.W * a.H};
    const uint32_t box[5] = {8, 1, C::HW, C::HH, 1};
    return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, x, dims,
                        strides, box);
  }
}

template <class C>
int launch(const void* const* ins, const int* cs, Args a, int device,
           cudaStream_t s) {
  constexpr int SMEM = C::SMEM;
  a.res_stages = C::F ? 0 : a.rch_all;
  // blocks per SM the shared memory allows, asked once per device
  static int per_sm[64] = {0};
  static int sms[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  void (*kernel)(Maps, Args) = conv333_kernel<C>;
  if constexpr (C::G) kernel = conv333_gated_kernel<C>;
  constexpr int THREADS = NTHREADS + (C::G ? GTHREADS : 0);
  if (per_sm[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int nb = 0, nsm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, THREADS,
                                                        SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    sms[device] = nsm;
    per_sm[device] = nb;
  }
  Maps maps = {};
  for (int i = 0; i < 4; ++i) {
    if (!ins[i]) continue;
    const cudaError_t err = input_map<C>(&maps.m[i], ins[i], cs[i], a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.th = C::TH;
  a.tiles_hw = a.tiles_w * ((a.Ho + a.th - 1) / a.th);
  const long long total = (long long)a.Nb * a.Do * a.ntiles * a.tiles_hw;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.total = (int)total;
  const long long cap = (long long)per_sm[device] * sms[device];
  const int grid = (int)(a.total < cap ? a.total : cap);
  kernel<<<grid, THREADS, SMEM, s>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// a fused residual's second accumulator set fits beside the first for
// N <= 48 (at N >= 64 it spilled and was slower than the separate residual
// stages)
template <int N, bool G>
int launch_s1g(bool fused, const void* const* ins, const int* cs,
               const Args& a, int device, cudaStream_t s) {
  constexpr int MT = G ? GMT : mt_s1<N>();
  if constexpr (N <= MT4_MAX_N) {
    if (fused) return launch<Cfg<N, true, 1, MT, G>>(ins, cs, a, device, s);
  }
  return launch<Cfg<N, false, 1, MT, G>>(ins, cs, a, device, s);
}

template <int N>
int launch_s1(bool fused, bool gated, const void* const* ins, const int* cs,
              const Args& a, int device, cudaStream_t s) {
  return gated ? launch_s1g<N, true>(fused, ins, cs, a, device, s)
               : launch_s1g<N, false>(fused, ins, cs, a, device, s);
}

// stride 2: TH = 16 (MT = 2) or 8 (MT = 1)
template <int N>
int launch_s2(int th, const void* const* ins, const int* cs, const Args& a,
              int device, cudaStream_t s) {
  if (th == 8) return launch<Cfg<N, false, 2, 1>>(ins, cs, a, device, s);
  return launch<Cfg<N, false, 2, 2>>(ins, cs, a, device, s);
}

// The unit's dynamic shared memory: the ring, the weight region (wmax 0
// when the slabs are staged), the staging rows, the epilogue table and the
// barriers (full and empty per slot, wbar).
template <class C, int ST, bool RES>
int unit_smem(int wmax) {
  return ST * (RES ? C::HALO_BYTES : C::SLOT) + wmax +
         NWARPS * 16 * C::N * 2 + 4 * GEPI * 4 + (2 * ST + 1) * 8;
}

// The unit at N width C::N with ST ring slots, its weights resident (RES)
// or staged with each stage: a grid of every block the card holds at once
// (cooperative; a refused size or shared-memory request is returned), p0
// of them on conv0. The grid goes to *grid; with x null nothing launches.
template <class C, int ST, bool RES>
int launch_unit(Unit u, const void* x, int cx, const void* u0, int device,
                cudaStream_t s, int* grid_out) {
  void (*kernel)(Maps, Maps, Unit) = ru_unit_kernel<C, ST, RES>;
  const int smem = unit_smem<C, ST, RES>(u.wmax);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0, nsm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, UTHREADS,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = nb * nsm;
  if (grid_out) *grid_out = grid;
  if (!x) return 0;
  if (u.p0 < 0 || u.p0 > grid) return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < 2; ++r) {
    Args& a = u.a[r];
    a.th = C::TH;
    a.tiles_hw = a.tiles_w * ((a.Ho + a.th - 1) / a.th);
    const long long total = (long long)a.Nb * a.Do * a.ntiles * a.tiles_hw;
    if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    a.total = (int)total;
  }
  u.target = NWARPS * u.a[0].tiles_hw * u.a[0].ntiles;
  Maps m0 = {}, m1 = {};
  err = input_map<C>(&m0.m[0], x, cx, u.a[0]);
  if (err == cudaSuccess) err = input_map<C>(&m1.m[0], u0, u.a[0].cout, u.a[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  m1.m[2] = m0.m[0];
  void* args[] = {(void*)&m0, (void*)&m1, (void*)&u};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(grid), dim3(UTHREADS), args, smem, s));
}

}  // namespace

// The encoder ResidualUnit in one cooperative launch (U; see the header):
// x (n, d, h, w, cx) bf16 (cx % 8 == 0, 16-byte aligned); u0 and out (...,
// cout) bf16, u0 scratch for conv0's output; cnt n * d zeroed int32; w0,
// w1, wr packed by pack_weights_gmma with N = cout (one N tile); the
// epilogue vectors f32 as conv333_launch takes them (a0n, a1n: 1 or
// cout slopes), br conv1's residual bias. p0: blocks on conv0, 0 .. the
// grid (every block the card holds at once at one block per SM); 0 runs
// conv1 alone and needs cnt already complete, the grid runs conv0 alone;
// Built for cout = 48 with resident weights and for cout = 64, 80 and 96
// with each stage's slab staged, 3 ring slots each (4 were no faster at
// down_2). grid: if not null, set to the launch's grid (the blocks the card holds
// at once, one role or the other each); with x null only that is done.
extern "C" int ru_unit_launch(const void* x, int cx, void* u0, void* out,
                              void* cnt, const void* w0, const void* w1,
                              const void* wr, const void* s0, const void* h0,
                              const void* a0, int a0n, const void* s1,
                              const void* h1, const void* a1, int a1n,
                              const void* br, int n, int d, int h, int w,
                              int cout, int p0, int device, void* stream,
                              int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cx < 8 || cx % 8 != 0 ||
      (x && (!u0 || !out || !cnt || !w0 || !w1 || !wr || n < 1 || d < 1 ||
             h < 1 || w < 1 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
             (reinterpret_cast<uintptr_t>(u0) & 15) != 0 ||
             (a0n != 1 && a0n != cout) || (a1n != 1 && a1n != cout))))
    return static_cast<int>(cudaErrorInvalidValue);
  Unit u = {};
  for (int r = 0; r < 2; ++r) {
    Args& a = u.a[r];
    a.Nb = n;
    a.D = a.Do = d;
    a.H = a.Ho = h;
    a.W = a.Wo = w;
    a.cout = cout;
    a.kd = 3;
    a.tiles_w = (w + TW - 1) / TW;
    a.ntiles = 1;
    a.att = nullptr;
  }
  const int xch = (cx + KC - 1) / KC, uch = (cout + KC - 1) / KC;
  Args& c0 = u.a[0];
  c0.nch[0] = c0.nch_all = xch;
  c0.wm = static_cast<const __nv_bfloat16*>(w0);
  c0.scale = static_cast<const float*>(s0);
  c0.shift = static_cast<const float*>(h0);
  c0.alpha = static_cast<const float*>(a0);
  c0.alpha_n = a0n;
  c0.out = static_cast<__nv_bfloat16*>(u0);
  Args& c1 = u.a[1];
  c1.nch[0] = c1.nch_all = uch;
  c1.rch[0] = c1.rch_all = c1.res_stages = xch;
  c1.wm = static_cast<const __nv_bfloat16*>(w1);
  c1.wr = static_cast<const __nv_bfloat16*>(wr);
  c1.scale = static_cast<const float*>(s1);
  c1.shift = static_cast<const float*>(h1);
  c1.alpha = static_cast<const float*>(a1);
  c1.alpha_n = a1n;
  c1.rbias = static_cast<const float*>(br);
  c1.out = static_cast<__nv_bfloat16*>(out);
  u.cnt = static_cast<int*>(cnt);
  u.p0 = p0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the weights stay resident at N = 48 (down_2); at 64, 80 and 96 each
  // stage stages its slab
  switch (cout) {
    case 48: {
      using C = Cfg<48, false, 1, mt_s1<48>()>;
      u.wmain[0] = xch * 3 * C::WBYTES;
      u.wmain[1] = uch * 3 * C::WBYTES;
      u.wres = xch * C::RBYTES;
      u.wmax = u.wmain[0] > u.wmain[1] + u.wres ? u.wmain[0]
                                                 : u.wmain[1] + u.wres;
      return launch_unit<C, STAGES, true>(u, x, cx, u0, device, s, grid);
    }
    case 64:
      return launch_unit<Cfg<64, false, 1, mt_s1<64>()>, STAGES, false>(
          u, x, cx, u0, device, s, grid);
    case 80:
      return launch_unit<Cfg<80, false, 1, mt_s1<80>()>, STAGES, false>(
          u, x, cx, u0, device, s, grid);
    case 96:
      return launch_unit<Cfg<96, false, 1, mt_s1<96>()>, STAGES, false>(
          u, x, cx, u0, device, s, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// stride 1 or 2; th: the stride-2 tile height (8 or 16), 0 at stride 1;
// att: the gate's f32 map (N, D, H, W), or null (ungated); stride 1 only
extern "C" int conv333_launch(const void* xa, int ca, const void* xb, int cb,
                              const void* ra, int cra, const void* rb, int crb,
                              const void* wm, const void* wr,
                              const void* scale, const void* shift,
                              const void* alpha, int alpha_n,
                              const void* rbias,
                              void* out, int n, int d, int h, int w, int cout,
                              int ntile, int cop, int kd, int stride, int th,
                              const void* att, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* ins[4] = {xa, xb, ra, rb};
  const int cs[4] = {ca, xb ? cb : 0, ra ? cra : 0, rb ? crb : 0};
  const bool gated = att != nullptr;
  if (gated && (stride != 1 || cop > GEPI))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ntile < 8 || cop % ntile != 0 || cop < cout || (kd != 1 && kd != 3) ||
      !xa || n < 1 || d < 1 || h < 1 || w < 1 || cout < 1 ||
      (wr != nullptr) != (ra != nullptr) || (alpha_n != 1 && alpha_n != cout))
    return static_cast<int>(cudaErrorInvalidValue);
  // stride 2: kd = 3, one input, no residual, an even W (the W-pair view)
  if (stride == 1 ? th != 0
                  : (stride != 2 || kd != 3 || xb || ra || (w & 1) ||
                     (th != 8 && th != 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 4; ++i)
    if (ins[i] && (cs[i] < 8 || cs[i] % 8 != 0 ||
                   (reinterpret_cast<uintptr_t>(ins[i]) & 15) != 0))
      return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.Nb = n;
  a.D = d;
  a.H = h;
  a.W = w;
  a.Do = (d - 1) / stride + 1;
  a.Ho = (h - 1) / stride + 1;
  a.Wo = (w - 1) / stride + 1;
  for (int i = 0; i < 2; ++i) {
    a.nch[i] = (cs[i] + KC - 1) / KC;
    a.rch[i] = (cs[2 + i] + KC - 1) / KC;
  }
  a.nch_all = a.nch[0] + a.nch[1];
  a.rch_all = a.rch[0] + a.rch[1];
  // the decoder blocks pass the conv's own input as the residual's: its
  // centre tap then runs on the main stages' halos
  const bool fused = ra && ra == xa && rb == xb && cs[2] == cs[0] &&
                     cs[3] == cs[1];
  a.wm = static_cast<const __nv_bfloat16*>(wm);
  a.wr = static_cast<const __nv_bfloat16*>(wr);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.alpha = static_cast<const float*>(alpha);
  a.alpha_n = alpha_n;
  a.rbias = static_cast<const float*>(rbias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.att = static_cast<const float*>(att);
  a.cout = cout;
  a.kd = kd;
  a.tiles_w = (a.Wo + TW - 1) / TW;
  a.ntiles = cop / ntile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 2) {
    // the N widths of the downsample sites (48, 64, 80 channels)
    switch (ntile) {
      case 48: return launch_s2<48>(th, ins, cs, a, device, s);
      case 64: return launch_s2<64>(th, ins, cs, a, device, s);
      case 80: return launch_s2<80>(th, ins, cs, a, device, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (ntile) {
    case 8:
      return launch_s1<8>(fused, gated, ins, cs, a, device, s);
    case 16:
      return launch_s1<16>(fused, gated, ins, cs, a, device, s);
    case 32:
      return launch_s1<32>(fused, gated, ins, cs, a, device, s);
    case 48:
      return launch_s1<48>(fused, gated, ins, cs, a, device, s);
    case 64:
      return launch_s1<64>(fused, gated, ins, cs, a, device, s);
    case 80:
      return launch_s1<80>(fused, gated, ins, cs, a, device, s);
    case 96:
      return launch_s1<96>(fused, gated, ins, cs, a, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
