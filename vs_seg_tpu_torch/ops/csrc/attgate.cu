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
// Layout: a1 NDHWC bf16 with Ca channels; x0, x1, g0, g1 NDHWC bf16 with Cx
// channels; att (N, D, H, W) bf16, or null when the caller drops the map;
// w2 f32 (kd*9*Ca + 1): the (kd*9, Ca) taps, tap = (kd*3+kh)*3+kw, then b2.
// f32 accumulation and an f32 gate (the unrounded att), each output rounded
// to bf16 once. The TPU kernel's "wide" map (att broadcast over the channel
// lanes) is a lane-layout device and is not produced: att is compact.
//
// Design: one thread per voxel; w2 sits in shared memory (read as a
// broadcast). What bounds it on the H100: memory. Each voxel reads its
// kd*9 neighbours' Ca channels of a1 (L1/L2 serve the overlap between the
// neighbours of adjacent threads), plus the gated inputs once, and writes
// the gated outputs and att once; the 2*kd*9*Ca flops per voxel are small
// beside that. Bound: (kd*9*Ca + 1)*4 bytes of w2 must fit 48 KB of shared
// memory (Ca <= 455 at kd = 3).

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS) attgate_kernel(
    const __nv_bfloat16* __restrict__ a1, const float* __restrict__ w2,
    const __nv_bfloat16* __restrict__ xa,
    const __nv_bfloat16* __restrict__ xb, __nv_bfloat16* __restrict__ ga,
    __nv_bfloat16* __restrict__ gb, __nv_bfloat16* __restrict__ att, int N,
    int D, int H, int W, int C, int CX, int KD, bool vec_a, bool vec_x) {
  extern __shared__ float w_s[];
  const int ntap = KD * 9 * C;
  for (int i = threadIdx.x; i < ntap + 1; i += NTHREADS) w_s[i] = w2[i];
  __syncthreads();
  const float b2 = w_s[ntap];

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
  for (int kd = 0; kd < KD; ++kd) {
    const int dz = d + kd - KD / 2;
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
        if (vec_a) {
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
  if (att) att[v] = __float2bfloat16_rn(s);

  const size_t base = (size_t)v * CX;
  const int nx = xb ? 2 : 1;
  for (int xi = 0; xi < nx; ++xi) {
    const __nv_bfloat16* x = xi ? xb : xa;
    __nv_bfloat16* g = xi ? gb : ga;
    if (vec_x) {
      for (int c = 0; c < CX; c += 8) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(x + base + c), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = s * f[e] + f[e];
        *reinterpret_cast<uint4*>(g + base + c) = pack8(f);
      }
    } else {
      for (int c = 0; c < CX; ++c) {
        const float f = bf2f(x[base + c]);
        g[base + c] = __float2bfloat16_rn(s * f + f);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// xb/gb null: one gated input; att null: no attention map is written.
extern "C" int attgate_launch(const void* a1, const void* w2, const void* xa,
                              const void* xb, void* ga, void* gb, void* att,
                              int n, int d, int h, int w, int ca, int cx,
                              int kd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ((size_t)kd * 9 * ca + 1) * sizeof(float);
  if (ca < 1 || cx < 1 || (kd != 1 && kd != 3) || smem > 48 * 1024 ||
      (xb == nullptr) != (gb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_a = ca % 8 == 0 && aligned16(a1);
  const bool vec_x = cx % 8 == 0 && aligned16(xa) && aligned16(ga) &&
                     (xb == nullptr || (aligned16(xb) && aligned16(gb)));
  const long long nvox = (long long)n * d * h * w;
  const long long blocks = (nvox + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attgate_kernel<<<(unsigned)blocks, NTHREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const float*>(w2),
      static_cast<const __nv_bfloat16*>(xa),
      static_cast<const __nv_bfloat16*>(xb),
      static_cast<__nv_bfloat16*>(ga), static_cast<__nv_bfloat16*>(gb),
      static_cast<__nv_bfloat16*>(att), n, d, h, w, ca, cx, kd, vec_a,
      vec_x);
  return static_cast<int>(cudaGetLastError());
}
