// dsconv — (3,3,3) stride-(2,2,2) convolution with padding 1 for sm_90a, with
// a fused scale/shift + PReLU epilogue: the downsample conv of the encoder.
//
// Replaces the TPU kernel vs_seg_tpu/ops/experimental/pallas_dsconv.py:ds_conv
// (_ds_kernel). None of its design is carried over: the H/W parity streams,
// the strided Toeplitz block matrices (A, B, C) over 64 padded lanes and the
// whole-plane VMEM tiles exist for the MXU and its (8, 128) tiling. Here the
// stride-2 gather is address arithmetic on a shared-memory patch.
//
//   out[n, od, oh, ow, co] = act(sum_{kd,kh,kw,ci}
//       x[n, 2od+kd-1, 2oh+kh-1, 2ow+kw-1, ci] * w[tap, ci, co] * scale[co]
//       + shift[co])
//   act(y) = y >= 0 ? y : alpha[co] * y     (PReLU; ReLU is alpha = 0,
//                                            identity is alpha = 1)
//
// Taps that fall outside the volume read zeros (padding 1 on both sides), so
// any D, H, W is taken: the output is ((D-1)/2+1, (H-1)/2+1, (W-1)/2+1).
//
// Layout: activations NDHWC bf16. Weights are packed by the wrapper
// (ops/conv333.py:pack_weights) as bf16 (27, kp, cop): tap = (kd*3+kh)*3+kw,
// Cin zero-padded to kp (a multiple of 16), Cout to cop. eps is f32 (3, cop):
// scale, shift, alpha. Accumulation is f32; the output is rounded to bf16
// once, after the epilogue.
//
// Design: implicit GEMM on the tensor cores through WMMA (bf16 16x16x16, f32
// accumulate). One block of 8 warps computes an 8 (H) x 16 (W) tile of output
// voxels of one (n, od) plane for a slice of up to 64 output channels; warp i
// owns output row oh0+i (one 16-row M tile) and NFRAG 16-column N tiles. The
// K loop runs over (16-channel chunk, kd); each round stages the input patch
// of plane 2od+kd-1 that the tile's 9 (kh, kw) taps read, (2*8+1) x (2*16+1)
// positions x 16 channels, and the 9 taps' 16 x cout-slice weights. The
// patch is stored with each row split by W parity (the 17 even columns,
// then the 16 odd ones), so the A operand of tap (kh, kw) -- input columns
// 2m+kw for m = 0..15 -- is 16 consecutive 32-byte rows, as in conv333.
//
// What bounds it on the H100: at the flagship sites (Cin = Cout = 48-80) the
// work is 27*Cin MACs per output voxel against 8 input voxels read per
// output, about 0.51 GB and 73 GFLOP at downsample_2 (8 windows): bytes and
// operations are near balance (~0.15 ms vs ~0.07 ms). This first version,
// like conv333, does not keep the tensor cores fed: each round is load ->
// sync -> compute with no overlap, and neighbouring blocks re-read the
// patch rows they share. Double buffering (cp.async/TMA) and wgmma are the
// next steps. Bounds: N*Do <= 65535 (grid.y), Cout unbounded (grid.z tiles
// of up to 64).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 16;            // output W positions per block (WMMA M)
constexpr int TH = 8;             // output H rows per block, one per warp
constexpr int NWARP = TH;
constexpr int NTHREADS = NWARP * 32;
constexpr int KC = 16;            // input channels per staging round (WMMA K)
constexpr int PW = 2 * TW + 1;    // staged patch width (input columns)
constexpr int PH = 2 * TH + 1;    // staged patch height (input rows)
constexpr int NEVEN = TW + 1;     // even patch columns per row (0, 2, .., 32)
// Shared weight rows are CO_T + WPAD bf16 long, against bank conflicts of
// the WMMA B loads (conv333.cu).
constexpr int WPAD = 8;

struct Args {
  const __nv_bfloat16* x;         // (N, D, H, W, C)
  const __nv_bfloat16* wm;        // (27, kp, cop)
  const float* eps;               // (3, cop)
  __nv_bfloat16* out;             // (N, Do, Ho, Wo, cout)
  int N, D, H, W, C;
  int Do, Ho, Wo;
  int cout, cop, kp, tiles_w;
};

// Shared position of patch column ww (0..PW-1) in a patch row: the even
// columns first, then the odd ones.
__device__ __forceinline__ int patch_col(int ww) {
  return (ww & 1) ? NEVEN + (ww >> 1) : (ww >> 1);
}

// Stage the (PH, PW, KC) patch of input plane dz whose top-left input voxel
// is (2*oh0 - 1, 2*ow0 - 1), channels [c0, c0+16); zeros outside the volume
// and past C.
__device__ __forceinline__ void stage_x(__nv_bfloat16* in_s, int c0, int n,
                                        int dz, int oh0, int ow0,
                                        const Args& a) {
  const bool vec = (a.C % 8 == 0) &&
                   ((reinterpret_cast<uintptr_t>(a.x) & 15) == 0);
  const int h_lo = 2 * oh0 - 1, w_lo = 2 * ow0 - 1;
  for (int i = threadIdx.x; i < PH * PW * 2; i += NTHREADS) {
    const int pos = i >> 1, half = i & 1;
    const int hh = pos / PW, ww = pos - hh * PW;
    const int h = h_lo + hh, w = w_lo + ww;
    const int c = c0 + half * 8;
    union {
      uint4 u;
      unsigned short e[8];
    } v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (h >= 0 && h < a.H && w >= 0 && w < a.W && c < a.C) {
      const __nv_bfloat16* src =
          a.x + ((((size_t)n * a.D + dz) * a.H + h) * a.W + w) * a.C + c;
      if (vec) {
        v.u = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < a.C) v.e[j] = __bfloat16_as_ushort(src[j]);
      }
    }
    *reinterpret_cast<uint4*>(in_s + (hh * PW + patch_col(ww)) * KC +
                              half * 8) = v.u;
  }
}

// Stage the 9 (kh, kw) taps' (KC, CO_T) weight tiles of one kd, rows
// CO_T + WPAD apart; `base` points at [tap kd*9][k0][co0].
template <int CO_T>
__device__ __forceinline__ void stage_w(__nv_bfloat16* w_s,
                                        const __nv_bfloat16* base,
                                        size_t tap_stride, int cop) {
  constexpr int NV = CO_T / 8;    // 16-byte words per weight row
  for (int i = threadIdx.x; i < 9 * KC * NV; i += NTHREADS) {
    const int t = i / (KC * NV);
    const int rem = i - t * KC * NV;
    const int k = rem / NV, v = rem - k * NV;
    const uint4* src = reinterpret_cast<const uint4*>(
                           base + t * tap_stride + (size_t)k * cop) + v;
    reinterpret_cast<uint4*>(w_s + (t * KC + k) * (CO_T + WPAD))[v] = *src;
  }
}

template <int NFRAG>
__global__ void __launch_bounds__(NTHREADS) dsconv_kernel(Args a) {
  constexpr int CO_T = NFRAG * 16;
  constexpr int LDW = CO_T + WPAD;  // shared weight row stride
  __shared__ __align__(128) __nv_bfloat16 in_s[PH * PW * KC];
  __shared__ __align__(128) __nv_bfloat16 w_s[9 * KC * LDW];
  __shared__ __align__(128) float scr[NWARP][256];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = blockIdx.x % a.tiles_w, th = blockIdx.x / a.tiles_w;
  const int ow0 = tw * TW, oh0 = th * TH;
  const int n = blockIdx.y / a.Do, od = blockIdx.y - n * a.Do;
  const int co0 = blockIdx.z * CO_T;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFRAG];
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[j], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;

  // ---- K = (16-channel chunk, kd, kh, kw) --------------------------------
  for (int c0 = 0; c0 < a.C; c0 += KC) {
    for (int kd = 0; kd < 3; ++kd) {
      const int dz = 2 * od + kd - 1;
      if (dz < 0 || dz >= a.D) continue;   // zero plane: contributes nothing
      __syncthreads();
      stage_x(in_s, c0, n, dz, oh0, ow0, a);
      stage_w<CO_T>(w_s, a.wm + ((size_t)(kd * 9) * a.kp + c0) * a.cop + co0,
                    (size_t)a.kp * a.cop, a.cop);
      __syncthreads();
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        // patch row of output row oh0+warp, tap kh
        const __nv_bfloat16* row = in_s + (2 * warp + kh) * PW * KC;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          // input columns 2m+kw: even kw -> even columns from m + kw/2,
          // kw = 1 -> odd columns from m
          const int col0 = (kw == 1) ? NEVEN : (kw >> 1);
          wmma::load_matrix_sync(fa, row + col0 * KC, KC);
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

  // ---- epilogue: scale/shift -> PReLU, one bf16 rounding ----------------
  const float* scale = a.eps;
  const float* shift = a.eps + a.cop;
  const float* alpha = a.eps + 2 * a.cop;
  float* s_acc = scr[warp];
  const int m = lane >> 1, nb = (lane & 1) * 8;
  const int oh = oh0 + warp, ow = ow0 + m;
  const bool inside = oh < a.Ho && ow < a.Wo;
  const bool vec_out = (a.cout % 8 == 0) &&
                       ((reinterpret_cast<uintptr_t>(a.out) & 15) == 0);
  const size_t vox = (((size_t)n * a.Do + od) * a.Ho + oh) * a.Wo + ow;
#pragma unroll
  for (int j = 0; j < NFRAG; ++j) {
    wmma::store_matrix_sync(s_acc, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int cb = co0 + j * 16 + nb;
    if (inside && cb < a.cout) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int co = cb + e;    // < cop: the packed vectors cover every tile
        const float v = s_acc[m * 16 + nb + e] * scale[co] + shift[co];
        y[e] = v >= 0.f ? v : alpha[co] * v;
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

extern "C" int dsconv_launch(const void* x, const void* wm, const void* eps,
                             void* out, int n, int d, int h, int w, int c,
                             int cout, int nfrag, int cop, int kp, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dout = (d - 1) / 2 + 1, hout = (h - 1) / 2 + 1,
            wout = (w - 1) / 2 + 1;
  if (nfrag < 1 || nfrag > 4 || cop % (nfrag * 16) != 0 || n * dout > 65535 ||
      kp < c || kp % KC != 0 || d < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wm = static_cast<const __nv_bfloat16*>(wm);
  a.eps = static_cast<const float*>(eps);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.N = n;
  a.D = d;
  a.H = h;
  a.W = w;
  a.C = c;
  a.Do = dout;
  a.Ho = hout;
  a.Wo = wout;
  a.cout = cout;
  a.cop = cop;
  a.kp = kp;
  a.tiles_w = (wout + TW - 1) / TW;
  const int tiles_h = (hout + TH - 1) / TH;
  dim3 grid(a.tiles_w * tiles_h, n * dout, cop / (nfrag * 16));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nfrag) {
    case 1: dsconv_kernel<1><<<grid, NTHREADS, 0, s>>>(a); break;
    case 2: dsconv_kernel<2><<<grid, NTHREADS, 0, s>>>(a); break;
    case 3: dsconv_kernel<3><<<grid, NTHREADS, 0, s>>>(a); break;
    default: dsconv_kernel<4><<<grid, NTHREADS, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
