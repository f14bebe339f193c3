// attgate — attention conv2 (C -> 1, (3,3,3), same padding) + sigmoid +
// residual gate on both halves of a pair, for sm_90a.
//
// Replaces the middle stage of vs_seg_tpu/ops/pallas_l2block.py:l2_block
// (_l2block_kernel stage C: conv2 + sigmoid + gate), whose convs around it
// run as conv333 launches (ops/l2block.py).
//
//   att[v] = sigmoid(sum_{27 taps, c} a1[v + tap, c] * w2[tap, c] + b2)
//   ga[v, c] = att[v] * xa[v, c] + xa[v, c]
//   gb[v, c] = att[v] * xb[v, c] + xb[v, c]
//
// Layout: a1, xa, xb, ga, gb NDHWC bf16 with the same C; att (N, D, H, W)
// bf16; w2 f32 (27*C + 1): the (27, C) taps, tap = (kd*3+kh)*3+kw, then
// b2; f32 accumulation and f32 gate, each output rounded to bf16 once.
//
// Design: one thread per voxel; w2 sits in shared memory (read as a
// broadcast). What bounds it on the H100: memory. Each voxel reads its 27
// neighbours' C channels of a1 (L1/L2 serve the overlap between the
// neighbours of adjacent threads), plus xa and xb once, and writes ga, gb
// and att once; the 2*27*C flops per voxel are small beside that. Bound:
// (27*C + 1)*4 bytes of w2 must fit 48 KB of shared memory (C <= 455).

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS) attgate_kernel(
    const __nv_bfloat16* __restrict__ a1, const float* __restrict__ w2,
    const __nv_bfloat16* __restrict__ xa,
    const __nv_bfloat16* __restrict__ xb, __nv_bfloat16* __restrict__ ga,
    __nv_bfloat16* __restrict__ gb, __nv_bfloat16* __restrict__ att, int N,
    int D, int H, int W, int C, bool vec) {
  extern __shared__ float w_s[];
  for (int i = threadIdx.x; i < 27 * C + 1; i += NTHREADS) w_s[i] = w2[i];
  __syncthreads();
  const float b2 = w_s[27 * C];

  const long long nvox = (long long)N * D * H * W;
  const long long v = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (v >= nvox) return;
  const int w = (int)(v % W);
  long long t = v / W;
  const int h = (int)(t % H);
  t /= H;
  const int d = (int)(t % D);
  const int n = (int)(t / D);

  float acc = 0.f;
  for (int kd = 0; kd < 3; ++kd) {
    const int dz = d + kd - 1;
    if (dz < 0 || dz >= D) continue;
    for (int kh = 0; kh < 3; ++kh) {
      const int hy = h + kh - 1;
      if (hy < 0 || hy >= H) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int wx = w + kw - 1;
        if (wx < 0 || wx >= W) continue;
        const __nv_bfloat16* p =
            a1 + ((((size_t)n * D + dz) * H + hy) * W + wx) * C;
        const float* wt = w_s + ((kd * 3 + kh) * 3 + kw) * C;
        if (vec) {
          for (int c = 0; c < C; c += 8) {
            float f[8];
            unpack8(*reinterpret_cast<const uint4*>(p + c), f);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc = fmaf(f[e], wt[c + e], acc);
          }
        } else {
          for (int c = 0; c < C; ++c) acc = fmaf(bf2f(p[c]), wt[c], acc);
        }
      }
    }
  }
  const float s = 1.f / (1.f + expf(-(acc + b2)));
  att[v] = __float2bfloat16_rn(s);

  const size_t base = (size_t)v * C;
  if (vec) {
    for (int c = 0; c < C; c += 8) {
      float fa[8], fb[8];
      unpack8(*reinterpret_cast<const uint4*>(xa + base + c), fa);
      unpack8(*reinterpret_cast<const uint4*>(xb + base + c), fb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        fa[e] = s * fa[e] + fa[e];
        fb[e] = s * fb[e] + fb[e];
      }
      *reinterpret_cast<uint4*>(ga + base + c) = pack8(fa);
      *reinterpret_cast<uint4*>(gb + base + c) = pack8(fb);
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const float va = bf2f(xa[base + c]), vb = bf2f(xb[base + c]);
      ga[base + c] = __float2bfloat16_rn(s * va + va);
      gb[base + c] = __float2bfloat16_rn(s * vb + vb);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int attgate_launch(const void* a1, const void* w2, const void* xa,
                              const void* xb, void* ga, void* gb, void* att,
                              int n, int d, int h, int w, int c, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ((size_t)27 * c + 1) * sizeof(float);
  if (c < 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 8 == 0 && aligned16(a1) && aligned16(xa) &&
                   aligned16(xb) && aligned16(ga) && aligned16(gb);
  const long long nvox = (long long)n * d * h * w;
  const long long blocks = (nvox + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attgate_kernel<<<(unsigned)blocks, NTHREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const float*>(w2),
      static_cast<const __nv_bfloat16*>(xa),
      static_cast<const __nv_bfloat16*>(xb),
      static_cast<__nv_bfloat16*>(ga), static_cast<__nv_bfloat16*>(gb),
      static_cast<__nv_bfloat16*>(att), n, d, h, w, c, vec);
  return static_cast<int>(cudaGetLastError());
}
