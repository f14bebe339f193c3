// conv333 — direct (3,3,kd) stride-1 same-padded convolution for sm_90a,
// kd in {1, 3}, with a fused epilogue and an optional fused 1x1x1 residual.
//
// Replaces the TPU kernel vs_seg_tpu/ops/pallas_conv333.py:conv333
// (_conv_kernel), and through ops/rublock.py and ops/l2block.py the convs of
// vs_seg_tpu/ops/pallas_rublock.py:ru_block and
// vs_seg_tpu/ops/pallas_l2block.py:l2_block. With kd = 1 (the "2.5D" levels
// 0-1) it is, through ops/block2d.py and ops/tail2d.py, the conv of
// vs_seg_tpu/ops/experimental/pallas_block2d.py:ru_block2d/l2_block2d and
// pallas_tail2d.py:tail_block. None of the TPU design (Toeplitz band
// matrices, 64-lane channel padding, (rows, 128) flat views, depth-plane
// rings, tap packing) is carried over: those exist for the MXU and VMEM.
// kd is a runtime argument: the depth loop runs over the weight's kd planes
// (dz = d + kdi - kd/2), so the kd = 3 launches do exactly what they did
// before kd existed.
//
//   out[v, co] = act(sum_{taps, ci} x[v + tap, ci] * w[tap, ci, co] * scale[co]
//                    + shift[co])
//                + (sum_ci r[v, ci] * wr[ci, co] + rbias[co])      (optional)
//   act(y) = y >= 0 ? y : alpha[co] * y     (PReLU; ReLU is alpha = 0,
//                                            identity is alpha = 1)
//
// x may be a pair (xa, xb) standing for its channel concat, and so may the
// residual input r; nothing is concatenated in memory.
//
// Layout: activations NDHWC bf16. Weights are packed by the wrapper
// (ops/conv333.py:pack_weights) as bf16 (9*kd, kp, cop): tap = (kd*3+kh)*3+kw,
// each input's channels zero-padded to a multiple of 16 and stacked along
// kp, Cout zero-padded to cop. The residual weight is bf16 (krp, cop). eps is
// f32 (4, cop): scale, shift, alpha, residual bias. Accumulation is f32;
// the output is rounded to bf16 once, after the whole epilogue.
//
// Design: implicit GEMM on the tensor cores through WMMA (bf16 16x16x16,
// f32 accumulate). One block of 8 warps computes an 8 (H) x 16 (W) tile of
// output voxels of one (n, d) plane for a slice of up to 64 output channels;
// warp i owns output row h0+i (one 16-row M tile) and NFRAG 16-column N
// tiles. The K loop runs over (input, 16-channel chunk, kd); each round
// stages the (8+2) x (16+2) x 16 input halo of plane d+kd-1 and the 9 taps'
// 16 x cout-slice weights in shared memory, then every warp issues 9 taps x
// NFRAG mma. The residual is one more K loop with only the centre tap, into
// separate accumulators, so it is added after the activation.
//
// What bounds it on the H100: at the flagship (3,3,3) shapes (Cin 32-160,
// Cout 48-96) the conv is compute-heavy (27*Cin MACs per output), but this
// first version does not keep the tensor cores fed: each round is load ->
// sync -> compute with no overlap, and the weight slice is re-read from L2
// by every block. Double buffering with cp.async/TMA and wgmma are the next
// steps. At the kd = 1 sites two shapes waste tensor-core work (known costs,
// left for a later change): Cin = 1 at down_0 unit0 pads K to 16 channels,
// 16x the useful MACs (packing the 9 taps into K would fix it), and
// Cout = 2 at the up_0 logit head fills 2 of a 16-wide N tile (8x). Both
// sites are memory-bound anyway (few MACs per byte at 16 channels).
// Bounds: N*D <= 65535 (grid.y), Cout unbounded (grid.z tiles of 64).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 16;            // output W positions per block (WMMA M)
constexpr int TH = 8;             // output H rows per block, one per warp
constexpr int NWARP = TH;
constexpr int NTHREADS = NWARP * 32;
constexpr int KC = 16;            // input channels per staging round (WMMA K)
constexpr int SW = TW + 2;        // staged halo width
constexpr int SH = TH + 2;        // staged halo height
// Shared weight rows are CO_T + WPAD bf16 long: a WMMA B load reads 8 rows
// of 16 B per phase, and with an unpadded 128 B stride (CO_T = 64) all 8
// would start on the same bank.
constexpr int WPAD = 8;

struct Args {
  const __nv_bfloat16* x[2];      // main inputs (pair halves; x[1] may be null)
  int cx[2];                      // their channel counts (0 = absent)
  const __nv_bfloat16* r[2];      // residual inputs (may be null)
  int cr[2];
  const __nv_bfloat16* wm;        // (27, kp, cop)
  const __nv_bfloat16* wr;        // (krp, cop) or null: no residual
  const float* eps;               // (4, cop)
  __nv_bfloat16* out;             // (N, D, H, W, cout)
  int N, D, H, W, cout, cop, kp, tiles_w;
  int kd;                         // depth taps of the weight: 1 or 3
};

// Stage the (SH, SW, KC) halo tile of plane dz, channels [c0, c0+16), zeros
// outside the volume and past C.
__device__ __forceinline__ void stage_x(__nv_bfloat16* in_s,
                                        const __nv_bfloat16* x, int C, int c0,
                                        int n, int dz, int h0, int w0,
                                        const Args& a) {
  const bool vec = (C % 8 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  for (int i = threadIdx.x; i < SH * SW * 2; i += NTHREADS) {
    const int pos = i >> 1, half = i & 1;
    const int hh = pos / SW, ww = pos - hh * SW;
    const int h = h0 - 1 + hh, w = w0 - 1 + ww;
    const int c = c0 + half * 8;
    union {
      uint4 u;
      unsigned short e[8];
    } v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (h >= 0 && h < a.H && w >= 0 && w < a.W && c < C) {
      const __nv_bfloat16* src =
          x + ((((size_t)n * a.D + dz) * a.H + h) * a.W + w) * C + c;
      if (vec) {
        v.u = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < C) v.e[j] = __bfloat16_as_ushort(src[j]);
      }
    }
    *reinterpret_cast<uint4*>(in_s + pos * KC + half * 8) = v.u;
  }
}

// Stage ntaps x (KC, CO_T) weight tiles, rows CO_T + WPAD apart; `base`
// points at [tap 0][k0][co0].
template <int CO_T>
__device__ __forceinline__ void stage_w(__nv_bfloat16* w_s,
                                        const __nv_bfloat16* base, int ntaps,
                                        size_t tap_stride, int cop) {
  constexpr int NV = CO_T / 8;    // 16-byte words per weight row
  for (int i = threadIdx.x; i < ntaps * KC * NV; i += NTHREADS) {
    const int t = i / (KC * NV);
    const int rem = i - t * KC * NV;
    const int k = rem / NV, v = rem - k * NV;
    const uint4* src = reinterpret_cast<const uint4*>(
                           base + t * tap_stride + (size_t)k * cop) + v;
    reinterpret_cast<uint4*>(w_s + (t * KC + k) * (CO_T + WPAD))[v] = *src;
  }
}

template <int NFRAG>
__global__ void __launch_bounds__(NTHREADS) conv333_kernel(Args a) {
  constexpr int CO_T = NFRAG * 16;
  __shared__ __align__(128) __nv_bfloat16 in_s[SH * SW * KC];
  constexpr int LDW = CO_T + WPAD;  // shared weight row stride
  __shared__ __align__(128) __nv_bfloat16 w_s[9 * KC * LDW];
  __shared__ __align__(128) float scr[NWARP][2][256];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = blockIdx.x % a.tiles_w, th = blockIdx.x / a.tiles_w;
  const int w0 = tw * TW, h0 = th * TH;
  const int n = blockIdx.y / a.D, d = blockIdx.y - n * a.D;
  const int co0 = blockIdx.z * CO_T;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG], racc[NFRAG];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) {
    wmma::fill_fragment(acc[j], 0.f);
    wmma::fill_fragment(racc[j], 0.f);
  }
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;

  // ---- main conv: K = (input, 16-channel chunk, kd, kh, kw) -------------
  int kbase = 0;
  for (int xi = 0; xi < 2; ++xi) {
    const int C = a.cx[xi];
    if (C == 0) continue;
    for (int c0 = 0; c0 < C; c0 += KC) {
      for (int kd = 0; kd < a.kd; ++kd) {
        const int dz = d + kd - a.kd / 2;
        if (dz < 0 || dz >= a.D) continue;   // zero plane: contributes nothing
        __syncthreads();
        stage_x(in_s, a.x[xi], C, c0, n, dz, h0, w0, a);
        stage_w<CO_T>(w_s,
                      a.wm + ((size_t)(kd * 9) * a.kp + kbase + c0) * a.cop + co0,
                      9, (size_t)a.kp * a.cop, a.cop);
        __syncthreads();
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            wmma::load_matrix_sync(fa, in_s + ((warp + kh) * SW + kw) * KC, KC);
#pragma unroll
            for (int j = 0; j < NFRAG; ++j) {
              wmma::load_matrix_sync(fb, w_s + (kh * 3 + kw) * KC * LDW + j * 16,
                                     LDW);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        }
      }
    }
    kbase += (C + KC - 1) / KC * KC;
  }

  // ---- fused 1x1x1 residual: centre tap only, separate accumulators ----
  const bool has_res = a.wr != nullptr;
  if (has_res) {
    int rbase = 0;
    for (int xi = 0; xi < 2; ++xi) {
      const int C = a.cr[xi];
      if (C == 0) continue;
      for (int c0 = 0; c0 < C; c0 += KC) {
        __syncthreads();
        stage_x(in_s, a.r[xi], C, c0, n, d, h0, w0, a);
        stage_w<CO_T>(w_s, a.wr + (size_t)(rbase + c0) * a.cop + co0, 1, 0,
                      a.cop);
        __syncthreads();
        wmma::load_matrix_sync(fa, in_s + ((warp + 1) * SW + 1) * KC, KC);
#pragma unroll
        for (int j = 0; j < NFRAG; ++j) {
          wmma::load_matrix_sync(fb, w_s + j * 16, LDW);
          wmma::mma_sync(racc[j], fa, fb, racc[j]);
        }
      }
      rbase += (C + KC - 1) / KC * KC;
    }
  }

  // ---- epilogue: scale/shift -> PReLU -> + residual, one bf16 rounding --
  const float* scale = a.eps;
  const float* shift = a.eps + a.cop;
  const float* alpha = a.eps + 2 * a.cop;
  const float* rbias = a.eps + 3 * a.cop;
  float* s_acc = scr[warp][0];
  float* s_res = scr[warp][1];
  const int m = lane >> 1, nb = (lane & 1) * 8;
  const int h = h0 + warp, w = w0 + m;
  const bool inside = h < a.H && w < a.W;
  const bool vec_out = (a.cout % 8 == 0) &&
                       ((reinterpret_cast<uintptr_t>(a.out) & 15) == 0);
  const size_t vox = (((size_t)n * a.D + d) * a.H + h) * a.W + w;
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) {
    wmma::store_matrix_sync(s_acc, acc[j], 16, wmma::mem_row_major);
    if (has_res) wmma::store_matrix_sync(s_res, racc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int cb = co0 + j * 16 + nb;
    if (inside && cb < a.cout) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int co = cb + e;    // < cop: the packed vectors cover every tile
        float v = s_acc[m * 16 + nb + e] * scale[co] + shift[co];
        v = v >= 0.f ? v : alpha[co] * v;
        if (has_res) v += s_res[m * 16 + nb + e] + rbias[co];
        y[e] = v;
      }
      __nv_bfloat16* dst = a.out + vox * a.cout + cb;
      if (vec_out && cb + 8 <= a.cout) {
        *reinterpret_cast<uint4*>(dst) = pack8(y);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (cb + e < a.cout) dst[e] = __float2bfloat16_rn(y[e]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int conv333_launch(const void* xa, int ca, const void* xb, int cb,
                              const void* ra, int cra, const void* rb, int crb,
                              const void* wm, const void* wr, const void* eps,
                              void* out, int n, int d, int h, int w, int cout,
                              int nfrag, int cop, int kp, int kd, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nfrag < 1 || nfrag > 4 || cop % (nfrag * 16) != 0 || n * d > 65535 ||
      (kd != 1 && kd != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x[0] = static_cast<const __nv_bfloat16*>(xa);
  a.x[1] = static_cast<const __nv_bfloat16*>(xb);
  a.cx[0] = ca;
  a.cx[1] = xb ? cb : 0;
  a.r[0] = static_cast<const __nv_bfloat16*>(ra);
  a.r[1] = static_cast<const __nv_bfloat16*>(rb);
  a.cr[0] = ra ? cra : 0;
  a.cr[1] = rb ? crb : 0;
  a.wm = static_cast<const __nv_bfloat16*>(wm);
  a.wr = static_cast<const __nv_bfloat16*>(wr);
  a.eps = static_cast<const float*>(eps);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.N = n;
  a.D = d;
  a.H = h;
  a.W = w;
  a.cout = cout;
  a.cop = cop;
  a.kp = kp;
  a.kd = kd;
  a.tiles_w = (w + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  dim3 grid(a.tiles_w * tiles_h, n * d, cop / (nfrag * 16));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nfrag) {
    case 1: conv333_kernel<1><<<grid, NTHREADS, 0, s>>>(a); break;
    case 2: conv333_kernel<2><<<grid, NTHREADS, 0, s>>>(a); break;
    case 3: conv333_kernel<3><<<grid, NTHREADS, 0, s>>>(a); break;
    default: conv333_kernel<4><<<grid, NTHREADS, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
