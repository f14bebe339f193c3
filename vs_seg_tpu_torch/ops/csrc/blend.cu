// blend — Gaussian-blend scatter-accumulate of one batch of sliding windows
// into the whole-volume accumulators, in place, for sm_90a.
//
// Replaces vs_seg_tpu/ops/pallas_blend.py:pallas_blend_scatter
// (_blend_kernel). For each window i in index order:
//   out_acc[s_i + p, :] += pred_i[p, :] * (imp[p] * mask_i)
//   w_acc[s_i + p]      += imp[p] * mask_i
//
// Layout (D-first): out_acc f32 (D, H, W, O), w_acc f32 (D, H, W),
// preds bf16 or f32 (N, RD, RH, RW, O), starts i32 (N, 3) as (d, h, w), mask f32
// (N,), imp f32 (RD, RH, RW).
//
// Design: one thread per output voxel inside the union box of the batch's
// windows (the wrapper computes the box from the host copy of the starts).
// Each thread walks the windows in index order, so overlapping windows add
// in the same order as the JAX reference's sequential loop
// (vs_seg_tpu/infer/sliding_window.py:_scatter_accumulate) with no atomics,
// and the result is deterministic. The products and sums are written with
// __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs: the result is
// the JAX f32 order bit for bit.
//
// What bounds it on the H100: memory. Each voxel's accumulators are read and
// written once per batch, and each covering window's prediction and
// importance value is read once; there is no reuse to stage. Bound: O <= 8
// (the per-thread register accumulator).

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int OMAX = 8;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS) blend_kernel(
    float* __restrict__ out_acc, float* __restrict__ w_acc,
    const T* __restrict__ preds, const int* __restrict__ starts,
    const float* __restrict__ mask, const float* __restrict__ imp, int nwin,
    int D, int H, int W, int O, int RD, int RH, int RW, int bd0, int bh0,
    int bw0, int bd, int bh, int bw) {
  const long long nbox = (long long)bd * bh * bw;
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= nbox) return;
  const int w = bw0 + (int)(t % bw);
  const int h = bh0 + (int)((t / bw) % bh);
  const int d = bd0 + (int)(t / ((long long)bw * bh));
  const size_t vox = ((size_t)d * H + h) * W + w;

  float o[OMAX];
  float ws = 0.f;
  bool touched = false;
  for (int i = 0; i < nwin; ++i) {
    const int ld = d - starts[3 * i], lh = h - starts[3 * i + 1],
              lw = w - starts[3 * i + 2];
    if (ld < 0 || ld >= RD || lh < 0 || lh >= RH || lw < 0 || lw >= RW)
      continue;
    if (!touched) {
#pragma unroll
      for (int c = 0; c < OMAX; ++c)
        if (c < O) o[c] = out_acc[vox * O + c];
      ws = w_acc[vox];
      touched = true;
    }
    const size_t p = ((size_t)ld * RH + lh) * RW + lw;
    const float wt = __fmul_rn(imp[p], mask[i]);
    const T* pr = preds + ((size_t)i * RD * RH * RW + p) * O;
#pragma unroll
    for (int c = 0; c < OMAX; ++c)
      if (c < O) o[c] = __fadd_rn(o[c], __fmul_rn(to_f32(pr[c]), wt));
    ws = __fadd_rn(ws, wt);
  }
  if (!touched) return;
#pragma unroll
  for (int c = 0; c < OMAX; ++c)
    if (c < O) out_acc[vox * O + c] = o[c];
  w_acc[vox] = ws;
}

}  // namespace

extern "C" int blend_launch(void* out_acc, void* w_acc, const void* preds,
                            int preds_f32, const void* starts, const void* mask,
                            const void* imp, int nwin, int d, int h, int w,
                            int o, int rd, int rh, int rw, int bd0, int bh0,
                            int bw0, int bd, int bh, int bw, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (o < 1 || o > OMAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long nbox = (long long)bd * bh * bw;
  if (nbox <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (nbox + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* oa = static_cast<float*>(out_acc);
  float* wa = static_cast<float*>(w_acc);
  const int* st = static_cast<const int*>(starts);
  const float* mk = static_cast<const float*>(mask);
  const float* im = static_cast<const float*>(imp);
  if (preds_f32) {
    blend_kernel<float><<<(unsigned)blocks, NTHREADS, 0, s>>>(
        oa, wa, static_cast<const float*>(preds), st, mk, im, nwin, d, h, w, o,
        rd, rh, rw, bd0, bh0, bw0, bd, bh, bw);
  } else {
    blend_kernel<__nv_bfloat16><<<(unsigned)blocks, NTHREADS, 0, s>>>(
        oa, wa, static_cast<const __nv_bfloat16*>(preds), st, mk, im, nwin, d,
        h, w, o, rd, rh, rw, bd0, bh0, bw0, bd, bh, bw);
  }
  return static_cast<int>(cudaGetLastError());
}
