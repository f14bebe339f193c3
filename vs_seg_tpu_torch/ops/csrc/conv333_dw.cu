// conv333_dw — weight and bias gradients of a (3,3,3) stride-1 same-padded
// convolution, for sm_90a:
//
//   dw[kh, kw, kd, ci, co] = sum_{n,d,h,w} x[n, d+kd-1, h+kh-1, w+kw-1, ci]
//                                          * dy[n, d, h, w, co]
//   db[co]                 = sum_{n,d,h,w} dy[n, d, h, w, co]
//
// (x zero outside the volume), in float32, in the JAX (kh, kw, kd, Cin, Cout)
// order. x (N, D, H, W, Cin) and dy (N, D, H, W, Cout) are bf16 NDHWC.
//
// Replaces vs_seg_tpu/ops/experimental/pallas_train.py:conv333_dw
// (_dw_kernel), the wgrad half of conv333_train's backward. The TPU kernel
// accumulates 18 (128, 128) Gram blocks over 128-lane Toeplitz views of x and
// reads dw off them afterwards (dw_extract), carrying the sums across a
// sequential grid in VMEM outputs. None of that carries over: the Gram blocks
// exist for the MXU, and CUDA blocks run in no order.
//
// Design: an implicit GEMM, M = 27 * Cin (tap, ci), N = Cout, K = voxels, on
// the tensor cores through WMMA (bf16 16x16x16, f32 accumulate). K is cut
// into tiles of 8 (H) x 16 (W) voxels of one (n, d) plane; grid.x splits the
// tiles into `nsplit` contiguous ranges, grid.y runs over 16-channel Cin
// chunks x Cout slices of up to 64. A block of 9 warps stages, per tile, the
// (8+2) x (16+2) x 16 input halo of the three planes d-1, d, d+1 and the
// 8 x 16 x Cout-slice dy tile in shared memory; warp (kd, kh) owns the three
// taps kw = 0..2 for every 16-column N tile and, per tile row, multiplies the
// col-major view of the staged (voxel, channel) x rows -- which is x^T, with
// no transpose -- by the row-major dy rows. Voxels outside the volume are
// staged as zeros in dy, so edge tiles add nothing for them.
//
// Determinism: pass 1 writes each split's partial sums to a float32
// workspace, every element exactly once (no atomics); pass 2 (dw_reduce)
// adds the splits in index order and writes dw and db. Two launches, the
// same result bit for bit on every run.
// Workspace: nsplit * (27 * cip + 1) * cop floats (cip = Cin padded to 16,
// cop = the padded Cout); the wrapper (ops/conv333_dw.py) picks nsplit so it
// stays <= 64 MiB.
//
// What bounds it on the H100: at the flagship sites (Cin, Cout 48-96, 0.6 M
// voxels at L2) the GEMM has ~2.6 k MACs per loaded x element, so it is
// compute-bound in principle; this first version does not overlap the staging
// with the MMAs (load -> sync -> compute), re-stages the x halo once per Cout
// slice, and runs one 288-thread block per SM at NFRAG = 4 (96 accumulator
// registers a thread). cp.async/TMA double buffering and wgmma are the next
// steps. Bounds: nsplit * ny <= 2^31 - 1 and ny <= 65535 blocks.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 16;            // tile W positions (WMMA K)
constexpr int TH = 8;             // tile H rows
constexpr int NWARP = 9;          // warp (kd, kh)
constexpr int NTHREADS = NWARP * 32;
constexpr int KC = 16;            // input channels per block (WMMA M)
constexpr int SW = TW + 2;        // staged halo width
constexpr int SH = TH + 2;        // staged halo height
constexpr int PLANE = SH * SW * KC;
constexpr int DPAD = 8;           // dy row padding (bank spread, as conv333)

struct Args {
  const __nv_bfloat16* x;         // (N, D, H, W, cin)
  const __nv_bfloat16* dy;        // (N, D, H, W, cout)
  float* ws;                      // (nsplit, 27, cip, cop)
  float* dbws;                    // (nsplit, cop)
  int N, D, H, W, cin, cout, cip, cop, nsplit, tiles_w, tiles_h, co_tiles;
  long long ntiles;
};

// Stage the (SH, SW, KC) halo of plane dz, channels [c0, c0+16), zeros
// outside the volume and past cin.
__device__ __forceinline__ void stage_x(__nv_bfloat16* dst, const Args& a,
                                        int n, int dz, int h0, int w0,
                                        int c0) {
  const bool vec = (a.cin % 8 == 0) &&
                   ((reinterpret_cast<uintptr_t>(a.x) & 15) == 0);
  const bool plane_ok = dz >= 0 && dz < a.D;
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
    if (plane_ok && h >= 0 && h < a.H && w >= 0 && w < a.W && c < a.cin) {
      const __nv_bfloat16* src =
          a.x + ((((size_t)n * a.D + dz) * a.H + h) * a.W + w) * a.cin + c;
      if (vec) {
        v.u = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < a.cin) v.e[j] = __bfloat16_as_ushort(src[j]);
      }
    }
    *reinterpret_cast<uint4*>(dst + pos * KC + half * 8) = v.u;
  }
}

// Stage the (TH * TW, CO_T) dy tile of plane d, columns [co0, co0+CO_T),
// rows CO_T + DPAD apart; zeros outside the volume and past cout.
template <int CO_T>
__device__ __forceinline__ void stage_dy(__nv_bfloat16* dst, const Args& a,
                                         int n, int d, int h0, int w0,
                                         int co0) {
  constexpr int NV = CO_T / 8;
  constexpr int LDD = CO_T + DPAD;
  const bool vec = (a.cout % 8 == 0) &&
                   ((reinterpret_cast<uintptr_t>(a.dy) & 15) == 0);
  for (int i = threadIdx.x; i < TH * TW * NV; i += NTHREADS) {
    const int vox = i / NV, q = i - vox * NV;
    const int r = vox / TW, col = vox - r * TW;
    const int h = h0 + r, w = w0 + col;
    const int c = co0 + q * 8;
    union {
      uint4 u;
      unsigned short e[8];
    } v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (h < a.H && w < a.W && c < a.cout) {
      const __nv_bfloat16* src =
          a.dy + ((((size_t)n * a.D + d) * a.H + h) * a.W + w) * a.cout + c;
      if (vec && c + 8 <= a.cout) {
        v.u = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < a.cout) v.e[j] = __bfloat16_as_ushort(src[j]);
      }
    }
    *reinterpret_cast<uint4*>(dst + vox * LDD + q * 8) = v.u;
  }
}

template <int NFRAG>
__global__ void __launch_bounds__(NTHREADS) dw_partial_kernel(Args a) {
  constexpr int CO_T = NFRAG * 16;
  constexpr int LDD = CO_T + DPAD;
  __shared__ __align__(128) __nv_bfloat16 x_s[3 * PLANE];
  __shared__ __align__(128) __nv_bfloat16 dy_s[TH * TW * LDD];

  const int warp = threadIdx.x >> 5;
  const int kd = warp / 3, kh = warp - kd * 3;
  const int s = blockIdx.x;
  const int ci_chunk = blockIdx.y / a.co_tiles;
  const int co_tile = blockIdx.y - ci_chunk * a.co_tiles;
  const int c0 = ci_chunk * KC, co0 = co_tile * CO_T;
  const long long t_begin = a.ntiles * s / a.nsplit;
  const long long t_end = a.ntiles * (s + 1) / a.nsplit;
  const bool do_db = ci_chunk == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][NFRAG];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[kw][j], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[3];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  float dbsum = 0.f;              // thread t < CO_T: column co0 + t

  const int tiles_hw = a.tiles_w * a.tiles_h;
  for (long long t = t_begin; t < t_end; ++t) {
    const int nd = (int)(t / tiles_hw);
    const int rem = (int)(t - (long long)nd * tiles_hw);
    const int th = rem / a.tiles_w, tw = rem - th * a.tiles_w;
    const int n = nd / a.D, d = nd - n * a.D;
    const int h0 = th * TH, w0 = tw * TW;
    __syncthreads();              // the previous tile's reads are done
#pragma unroll
    for (int p = 0; p < 3; ++p)
      stage_x(x_s + p * PLANE, a, n, d + p - 1, h0, w0, c0);
    stage_dy<CO_T>(dy_s, a, n, d, h0, w0, co0);
    __syncthreads();
    if (do_db && threadIdx.x < CO_T) {
      for (int v = 0; v < TH * TW; ++v)
        dbsum += bf2f(dy_s[v * LDD + threadIdx.x]);
    }
    const int dz = d + kd - 1;
    if (dz < 0 || dz >= a.D) continue;   // zero plane: adds nothing
    const __nv_bfloat16* xp = x_s + kd * PLANE;
#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        wmma::load_matrix_sync(fa[kw], xp + ((r + kh) * SW + kw) * KC, KC);
#pragma unroll
      for (int j = 0; j < NFRAG; ++j) {
        wmma::load_matrix_sync(fb, dy_s + r * TW * LDD + j * 16, LDD);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          wmma::mma_sync(acc[kw][j], fa[kw], fb, acc[kw][j]);
      }
    }
  }

  // this split's partial sums: ws[s][tap][c0 + m][co0 + j*16 + n]
  float* base = a.ws + (size_t)s * 27 * a.cip * a.cop;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = (kd * 3 + kh) * 3 + kw;
#pragma unroll
    for (int j = 0; j < NFRAG; ++j)
      wmma::store_matrix_sync(
          base + ((size_t)tap * a.cip + c0) * a.cop + co0 + j * 16,
          acc[kw][j], a.cop, wmma::mem_row_major);
  }
  if (do_db && threadIdx.x < CO_T)
    a.dbws[(size_t)s * a.cop + co0 + threadIdx.x] = dbsum;
}

// Pass 2: dw[kh, kw, kd, ci, co] and db[co], each the sum over the splits in
// index order.
__global__ void __launch_bounds__(256) dw_reduce_kernel(
    const float* __restrict__ ws, const float* __restrict__ dbws,
    float* __restrict__ dw, float* __restrict__ db, int cin, int cout,
    int cip, int cop, int nsplit) {
  const long long ndw = 27LL * cin * cout;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < ndw) {
    const int co = (int)(i % cout);
    const int ci = (int)((i / cout) % cin);
    const int k = (int)(i / ((long long)cout * cin));   // (kh*3 + kw)*3 + kd
    const int kh = k / 9, kw = (k / 3) % 3, kd = k % 3;
    const int tap = (kd * 3 + kh) * 3 + kw;
    const size_t off = ((size_t)tap * cip + ci) * cop + co;
    const size_t stride = (size_t)27 * cip * cop;
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += ws[s * stride + off];
    dw[i] = v;
  } else if (i < ndw + cout) {
    const int co = (int)(i - ndw);
    float v = 0.f;
    for (int s = 0; s < nsplit; ++s) v += dbws[(size_t)s * cop + co];
    db[co] = v;
  }
}

}  // namespace

extern "C" int conv333_dw_launch(const void* x, const void* dy, void* ws,
                                 void* dbws, void* dw, void* db, int n, int d,
                                 int h, int w, int cin, int cout, int nfrag,
                                 int cop, int nsplit, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nfrag < 1 || nfrag > 4 || cop % (nfrag * 16) != 0 || nsplit < 1 ||
      cin < 1 || cout < 1 || cout > cop)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.ws = static_cast<float*>(ws);
  a.dbws = static_cast<float*>(dbws);
  a.N = n;
  a.D = d;
  a.H = h;
  a.W = w;
  a.cin = cin;
  a.cout = cout;
  a.cip = (cin + KC - 1) / KC * KC;
  a.cop = cop;
  a.nsplit = nsplit;
  a.tiles_w = (w + TW - 1) / TW;
  a.tiles_h = (h + TH - 1) / TH;
  a.co_tiles = cop / (nfrag * 16);
  a.ntiles = (long long)n * d * a.tiles_h * a.tiles_w;
  const int ny = (a.cip / KC) * a.co_tiles;
  if (ny > 65535 || nsplit > a.ntiles)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nsplit, ny);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nfrag) {
    case 1: dw_partial_kernel<1><<<grid, NTHREADS, 0, s>>>(a); break;
    case 2: dw_partial_kernel<2><<<grid, NTHREADS, 0, s>>>(a); break;
    case 3: dw_partial_kernel<3><<<grid, NTHREADS, 0, s>>>(a); break;
    default: dw_partial_kernel<4><<<grid, NTHREADS, 0, s>>>(a); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 27LL * cin * cout + cout;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dw_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(dbws),
      static_cast<float*>(dw), static_cast<float*>(db), cin, cout, a.cip, cop,
      nsplit);
  return static_cast<int>(cudaGetLastError());
}
