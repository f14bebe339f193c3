// attgate — attention conv2 (Ca -> 1, (3,3,kd) same padding, kd in {1, 3})
// + sigmoid + residual gate on one or two inputs, for sm_90a.
//
// Replaces the middle stage of vs_seg_tpu/ops/pallas_l2block.py:l2_block
// (_l2block_kernel stage C: conv2 + sigmoid + gate), whose convs around it
// run as conv333 launches (ops/l2block.py); the same stage of the kd = 1
// blocks pallas_block2d.py:l2_block2d and pallas_tail2d.py:tail_block
// (ops/block2d.py, ops/tail2d.py); and the whole of
// vs_seg_tpu/ops/experimental/pallas_att.py:fused_attention_gate
// (ops/att.py).
//
//   att[v] = sigmoid(sum_{kd*9 taps, c} a1[v + tap, c] * w2[tap, c] + b2)
//   g0[v, c] = att[v] * x0[v, c] + x0[v, c]
//   g1[v, c] = att[v] * x1[v, c] + x1[v, c]            (when x1 is given)
//
// With no x0 (the att-only mode of ops/l2block.py:att_map) it gates nothing
// and writes the unrounded f32 att instead, beside the bf16 map: the gate
// of l2_block's conv0 then runs in conv333.cu's gated instance on the
// staged halos (fmaf(att, x, x) in f32 on this same att), so the gated pair
// never reaches device memory.
//
// Layout: a1 NDHWC bf16 with Ca channels, Ca % 16 == 0 and Ca <= 256, base
// 16-byte aligned (the wrapper, ops/att.py:launch_attgate, pads other
// channel counts with zeros in a copy, and w2 with them); x0, x1, g0, g1
// NDHWC bf16 with any Cx channels; att (N, D, H, W) bf16, or null when the
// caller drops the map; att32 (N, D, H, W) f32, or null (only with no x0,
// and then required); w2 f32 (kd*9*Ca + 1): the (kd*9, Ca) taps, tap =
// (kd*3+kh)*3+kw, then b2. f32 accumulation; each weight enters the tensor
// cores as two bf16 terms (hi = rn(w), lo = rn(w - hi): about 16 bits, a1
// is bf16 already); an f32 sigmoid and gate on the unrounded att; each
// output rounded to bf16 once. The TPU kernel's "wide" map (att broadcast
// over the channel lanes) is a lane-layout device and is not produced: att
// is compact.
//
// What bounds it on the H100: memory. Per voxel it must read Ca + 2 Cx bf16
// values and write 2 Cx + 1, against 2 kd*9*Ca + 4 Cx flops (up_2: 0.48 flop
// per byte). The design reads a1, x0 and x1 from device memory once and
// writes g0, g1 and att once:
// - A block owns a column of tiles: TH rows x TW columns of one (n) and a
//   run of dc depth planes, and walks the planes in order. One thread (the
//   producer) stages each a1 plane's (TH+2) x (TW+2) x Ca halo once with one
//   TMA box copy (csrc/ring.cuh; zero-filled outside the volume, which is
//   the conv's padding) into a ring of kd + 1 slots on `full` mbarriers, so
//   at kd = 3 plane p is read once for the three output planes that need it,
//   and the copy of plane p + 2 runs while p is computed.
// - The C -> 1 reduction runs on the tensor cores (mma.sync m16n8k16 bf16,
//   f32 accumulators) as tap partials: for each halo position u and tap
//   (kh, kw), Q[u][kh, kw] = sum over the kd planes and Ca channels of
//   a1[u][c] * w2[plane, kh, kw][c], a product of the staged halo (A: 16
//   positions x 16 channels per ldmatrix) with the weights (B: 16 channels
//   x 8 taps, two blocks for the 9 taps, each weight as a hi and a lo bf16
//   term); Q goes to shared memory and out[v] = sum over (kh, kw) of
//   Q[v + (kh, kw)][kh, kw]. Each staged a1 value is read from shared
//   memory once per output plane, not once per tap. Why this scheme: the
//   probes (csrc/mosaic_probe.cu) put the memory-bound group sums within
//   30 % of each other, but the product cases on the tensor cores 1.7-12×
//   ahead of FFMA, and this reduction is a product of kd*9*Ca terms per
//   voxel. On the H100 (PERF.md, attgate) at up_2, lanes owning 8 channels
//   with a segmented shuffle spent 1.6 of 1.8 ms on that arithmetic; an MMA
//   per tap (A re-read per tap) 1.24 of 1.47 ms on shared-memory traffic.
// - att goes to shared memory; the gate then streams the tile's x rows
//   (TW * Cx contiguous values per row) with 16-byte streaming loads, four
//   per thread in flight per input, and 16-byte stores, coalesced across
//   the block; Cx % 8 != 0 or unaligned bases take a scalar path.
// - Tile size is chosen at launch from Ca and kd: the widest TW <= 32 (W
//   cut into equal tiles) and the tallest TH <= 8 whose ring fits two
//   blocks per SM (113 KB), else one (227 KB; in the att-only mode
//   always the largest that fits one); depth is cut into chunks
//   when the columns alone would leave the SMs short of blocks (at kd = 3
//   each chunk reads 2 planes more). The halo rows of an ldmatrix are
//   Ca * 2 bytes apart, so at Ca = 32 and 64 they meet 4- and 8-way bank
//   conflicts (TMA writes them unpadded); the tap partials make those
//   loads 9 times fewer.

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;           // gate: 16-byte loads in flight / thread
constexpr int MT = 4;               // MMA tiles of halo positions per warp
constexpr int MAX_SMEM = 227 * 1024;
constexpr int TWO_PER_SM = 113 * 1024;

struct Args {
  const float* w2;
  const __nv_bfloat16* xa;
  const __nv_bfloat16* xb;
  __nv_bfloat16* ga;
  __nv_bfloat16* gb;
  __nv_bfloat16* att;
  float* att32;                   // unrounded att
  int D, H, W, C, CX;
  int th, tw, tiles_h, tiles_w, dchunks, dc;
  int slot_pitch, slot_bytes, off_w, off_q, off_att, off_bar;
  bool vec_x;
};

struct Layout {
  int th, tw, slot_pitch, slot_bytes, off_w, off_q, off_att, off_bar, smem;
};

Layout layout(int th, int tw, int c, int kd) {
  Layout l;
  l.th = th;
  l.tw = tw;
  // a slot holds the halo's positions rounded up to whole 16-row MMA tiles
  // (the TMA fills the first slot_bytes; rows past them feed only rows of
  // Q that are never read)
  const int pos16 = ((th + 2) * (tw + 2) + 15) / 16 * 16;
  l.slot_bytes = (th + 2) * (tw + 2) * c * 2;
  l.slot_pitch = (pos16 * c * 2 + 127) & ~127;
  l.off_w = (kd + 1) * l.slot_pitch;
  l.off_q = l.off_w + kd * (c / 16) * 2 * 32 * 16;
  l.off_att = l.off_q + pos16 * 9 * 4;
  l.off_bar = l.off_att + (th * tw * 4 + 7) / 8 * 8;
  l.smem = l.off_bar + (kd + 1) * 8;
  return l;
}

// Two bf16 terms of each of two f32 values, packed as bf16x2 (first value
// in the low half): hi = rn(v), lo = rn(v - hi).
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A (16 x 16 bf16, fragments a) * B (16 x 8 bf16, fragments b0, b1)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KD>
__global__ void __launch_bounds__(NTHREADS)
    attgate_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int S = KD + 1;
  const int C = a.C, th = a.th, tw = a.tw, wp = tw + 2;
  float* w_s = reinterpret_cast<float*>(smem + a.off_w);
  float* att_s = reinterpret_cast<float*>(smem + a.off_att);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.off_bar);
  const int tid = threadIdx.x;

  int b = blockIdx.x;
  const int wt = b % a.tiles_w;
  b /= a.tiles_w;
  const int ht = b % a.tiles_h;
  b /= a.tiles_h;
  const int dch = b % a.dchunks;
  const int n = b / a.dchunks;
  const int h0 = ht * th, w0 = wt * tw, z0 = dch * a.dc;
  const int nz = min(a.D, z0 + a.dc) - z0;
  const int nload = nz + KD - 1;      // load q is plane z0 - KD/2 + q

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  // the weights as B fragments (16 channels x 8 taps of one depth plane):
  // per (plane k, 16-channel chunk, tap block nb of 8, lane) the pairs
  // (channel 2t, 2t + 1) and (2t + 8, 2t + 9) of tap nb * 8 + g (zero past
  // tap 8), hi then lo
  const int nch = C / 16;
  uint4* wf_s = reinterpret_cast<uint4*>(w_s);
  for (int i = tid; i < KD * nch * 2 * 32; i += NTHREADS) {
    const int ln = i & 31, blk = i >> 5;
    const int nb = blk & 1, kc = blk >> 1;
    const int k = kc / nch, ch = kc - k * nch;
    const int tap = nb * 8 + (ln >> 2);
    uint32_t hi[2] = {0u, 0u}, lo[2] = {0u, 0u};
    if (tap < 9) {
      const float* src = a.w2 + (k * 9 + tap) * C + ch * 16 + 2 * (ln & 3);
      split_pair(src[0], src[1], hi[0], lo[0]);
      split_pair(src[8], src[9], hi[1], lo[1]);
    }
    wf_s[i] = make_uint4(hi[0], hi[1], lo[0], lo[1]);
  }
  __syncthreads();
  const float b2 = a.w2[KD * 9 * C];

  auto issue = [&](int q) {
    uint64_t* bar = &full[q % S];
    mbar_expect_tx(bar, a.slot_bytes);
    tma_load_5d(smem + (q % S) * a.slot_pitch, &map, bar, 0, w0 - 1, h0 - 1,
                z0 - KD / 2 + q, n);
  };
  if (tid == 0)
    for (int q = 0; q < KD; ++q) issue(q);

  // the reduction on the tensor cores, as tap partials: for every halo
  // position u and tap (kh, kw), Q[u][kh, kw] = sum over the kd planes and
  // Ca channels of a1[plane][u][c] * w2[plane, kh, kw][c]: an MMA of the
  // halo (16 positions x 16 channels per ldmatrix, A) with the weights (16
  // channels x 8 taps, B), accumulated over planes and chunks. Each staged
  // a1 value is read once per plane instead of once per tap. Then out[v] =
  // sum over (kh, kw) of Q[v + (kh, kw)][kh, kw].
  float* q_s = reinterpret_cast<float*>(smem + a.off_q);
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npos = (th + 2) * wp, ntile = (npos + 15) / 16;
  const int rows_h = min(th, a.H - h0), cols = min(tw, a.W - w0);
  const int nx = a.xa ? (a.xb ? 2 : 1) : 0;
  // this lane's ldmatrix row: matrices (rows 0-7, k 0-7), (8-15, 0-7),
  // (0-7, 8-15), (8-15, 8-15) take their row addresses from lanes 0-7,
  // 8-15, 16-23, 24-31
  const int lrow = (lane & 7) + (lane & 8), lk = (lane >> 4) * 8;

  for (int p = 0; p < nz; ++p) {
    const int z = z0 + p;
    // the previous plane's gate is done and slot (p - 1) % S is free
    __syncthreads();
    if (tid == 0 && p + KD < nload) issue(p + KD);
#pragma unroll
    for (int k = 0; k < KD; ++k)
      mbar_wait(&full[(p + k) % S], ((p + k) / S) & 1);

    for (int tile0 = warp; tile0 < ntile; tile0 += NWARPS * MT) {
      float acc[MT][2][4] = {};
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        const uint32_t plane =
            smem_u32(smem + ((p + k) % S) * a.slot_pitch) + (lrow * C + lk) * 2;
        for (int ch = 0; ch < nch; ++ch) {
          const uint4 b0 = wf_s[((k * nch + ch) * 2) * 32 + lane];
          const uint4 b1 = wf_s[((k * nch + ch) * 2 + 1) * 32 + lane];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int tile = tile0 + m * NWARPS;
            if (tile < ntile) {
              uint32_t af[4];
              ldmatrix_x4(af, plane + (tile * 16 * C + ch * 16) * 2);
              mma_bf16(acc[m][0], af, b0.x, b0.y);
              mma_bf16(acc[m][0], af, b0.z, b0.w);
              mma_bf16(acc[m][1], af, b1.x, b1.y);
              mma_bf16(acc[m][1], af, b1.z, b1.w);
            }
          }
        }
      }
      // C fragments: rows g, g + 8 of the tile, taps nb * 8 + 2t, + 1
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int tile = tile0 + m * NWARPS;
        if (tile < ntile) {
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tap = nb * 8 + 2 * t + (e & 1);
              const int u = tile * 16 + g + (e >> 1) * 8;
              if (tap < 9) q_s[u * 9 + tap] = acc[m][nb][e];
            }
        }
      }
    }
    __syncthreads();      // Q is complete

    for (int v = tid; v < th * tw; v += NTHREADS) {
      const int ty = v / tw, tx = v - ty * tw;
      float zv = b2;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          zv += q_s[((ty + kh) * wp + tx + kw) * 9 + kh * 3 + kw];
      const float sv = 1.f / (1.f + expf(-zv));
      att_s[v] = sv;
      if (ty < rows_h && tx < cols) {
        const size_t row = ((size_t)n * a.D + z) * a.H + h0 + ty;
        if (a.att) a.att[row * a.W + w0 + tx] = __float2bfloat16_rn(sv);
        if (a.att32) a.att32[row * a.W + w0 + tx] = sv;
      }
    }
    if (nx == 0) continue;   // att only: the next plane's __syncthreads
                             // keeps Q until every thread has read it
    __syncthreads();      // att_s is complete

    // the gate: rows of cols * CX contiguous values
    const size_t row0 = ((size_t)n * a.D + z) * a.H + h0;
    const int row_elems = cols * a.CX;
    if (a.vec_x) {
      const int cpr = row_elems / 8;
      const int total = rows_h * cpr;
      for (int i0 = tid; i0 < total; i0 += NTHREADS * UNROLL) {
        uint4 va[UNROLL], vb[UNROLL];
        size_t off[UNROLL];
        float s[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + u * NTHREADS;
          if (i < total) {
            const int r = i / cpr, c8 = (i - r * cpr) * 8;
            off[u] = ((row0 + r) * a.W + w0) * a.CX + c8;
            s[u] = att_s[r * tw + c8 / a.CX];
            va[u] = __ldcs(reinterpret_cast<const uint4*>(a.xa + off[u]));
            if (nx == 2)
              vb[u] = __ldcs(reinterpret_cast<const uint4*>(a.xb + off[u]));
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (i0 + u * NTHREADS < total) {
            float f[8];
            unpack8(va[u], f);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = fmaf(s[u], f[e], f[e]);
            *reinterpret_cast<uint4*>(a.ga + off[u]) = pack8(f);
            if (nx == 2) {
              unpack8(vb[u], f);
#pragma unroll
              for (int e = 0; e < 8; ++e) f[e] = fmaf(s[u], f[e], f[e]);
              *reinterpret_cast<uint4*>(a.gb + off[u]) = pack8(f);
            }
          }
        }
      }
    } else {
      const int total = rows_h * row_elems;
      for (int i = tid; i < total; i += NTHREADS) {
        const int r = i / row_elems, e = i - r * row_elems;
        const size_t o = ((row0 + r) * a.W + w0) * a.CX + e;
        const float s = att_s[r * tw + e / a.CX];
        float f = bf2f(a.xa[o]);
        a.ga[o] = __float2bfloat16_rn(fmaf(s, f, f));
        if (nx == 2) {
          f = bf2f(a.xb[o]);
          a.gb[o] = __float2bfloat16_rn(fmaf(s, f, f));
        }
      }
    }
  }
  // every load issued was waited on above: nothing is in flight at exit
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// xb/gb null: one gated input; att null: no attention map is written.
// xa/ga null (the att-only mode; xb, gb null too, cx ignored): att32, the
// unrounded map, is written, else att32 must be null.
extern "C" int attgate_launch(const void* a1, const void* w2, const void* xa,
                              const void* xb, void* ga, void* gb, void* att,
                              void* att32, int n, int d, int h, int w, int ca,
                              int cx, int kd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool att_only = xa == nullptr;
  if (ca < 16 || ca % 16 || ca > 256 || (kd != 1 && kd != 3) || n < 1 ||
      d < 1 || h < 1 || w < 1 || !aligned16(a1) ||
      (xb == nullptr) != (gb == nullptr) ||
      (xa == nullptr) != (ga == nullptr) ||
      (att_only ? (xb != nullptr || att32 == nullptr)
                : (cx < 1 || att32 != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms[64] = {0};
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(attgate_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attgate_kernel<3>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the tile: widest TW, then tallest TH, whose ring fits two blocks per
  // SM, else (and always in the att-only mode, where no gate pass needs a
  // second block beside it: H100, 0.54 against 0.58 ms at up_2) the first
  // that fits one; W is split into equal tiles (W = 48: two of 24, not
  // 32 + 16)
  Layout best = {}, one = {};
  for (int tw0 : {32, 16, 8}) {
    const int nt = (w + tw0 - 1) / tw0;
    const int tw1 = (w + nt - 1) / nt;
    for (int th0 : {8, 4, 2, 1}) {
      const Layout l = layout(th0 < h ? th0 : h, tw1, ca, kd);
      if (!best.smem && l.smem <= TWO_PER_SM) best = l;
      if (!one.smem && l.smem <= MAX_SMEM) one = l;
    }
  }
  if (!best.smem || att_only) best = one;
  if (!best.smem) return static_cast<int>(cudaErrorInvalidValue);

  Args a;
  a.w2 = static_cast<const float*>(w2);
  a.xa = static_cast<const __nv_bfloat16*>(xa);
  a.xb = static_cast<const __nv_bfloat16*>(xb);
  a.ga = static_cast<__nv_bfloat16*>(ga);
  a.gb = static_cast<__nv_bfloat16*>(gb);
  a.att = static_cast<__nv_bfloat16*>(att);
  a.att32 = static_cast<float*>(att32);
  a.D = d;
  a.H = h;
  a.W = w;
  a.C = ca;
  a.CX = cx;
  a.th = best.th;
  a.tw = best.tw;
  a.slot_pitch = best.slot_pitch;
  a.slot_bytes = best.slot_bytes;
  a.off_w = best.off_w;
  a.off_q = best.off_q;
  a.off_att = best.off_att;
  a.off_bar = best.off_bar;
  a.tiles_h = (h + a.th - 1) / a.th;
  a.tiles_w = (w + a.tw - 1) / a.tw;
  a.vec_x = !att_only && cx % 8 == 0 && aligned16(xa) && aligned16(ga) &&
            (xb == nullptr || (aligned16(xb) && aligned16(gb)));
  const void* kernel = kd == 3 ? reinterpret_cast<const void*>(
                                    attgate_kernel<3>)
                              : reinterpret_cast<const void*>(
                                    attgate_kernel<1>);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      NTHREADS, best.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // depth chunks: enough blocks for four waves of the card
  const long long cols = (long long)n * a.tiles_h * a.tiles_w;
  const long long want = 4LL * per_sm * sms[device];
  long long chunks = (want + cols - 1) / cols;
  chunks = chunks < 1 ? 1 : (chunks > d ? d : chunks);
  a.dc = (int)((d + chunks - 1) / chunks);
  a.dchunks = (d + a.dc - 1) / a.dc;
  const long long blocks = cols * a.dchunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  // TMA map of a1: dims (Ca, W, H, D, N), box (Ca, TW + 2, TH + 2, 1, 1)
  CUtensorMap map;
  const uint64_t s1 = (uint64_t)ca * 2;
  const uint64_t dims[5] = {(uint64_t)ca, (uint64_t)w, (uint64_t)h,
                            (uint64_t)d, (uint64_t)n};
  const uint64_t strides[4] = {s1, s1 * w, s1 * w * h, s1 * w * h * d};
  const uint32_t box[5] = {(uint32_t)ca, (uint32_t)(a.tw + 2),
                           (uint32_t)(a.th + 2), 1, 1};
  err = encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, a1, dims,
                     strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kd == 3)
    attgate_kernel<3><<<(unsigned)blocks, NTHREADS, best.smem, s>>>(map, a);
  else
    attgate_kernel<1><<<(unsigned)blocks, NTHREADS, best.smem, s>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}
