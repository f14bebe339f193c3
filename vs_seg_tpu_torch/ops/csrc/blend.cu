// blend — Gaussian-blend scatter-accumulate of one batch of sliding windows
// into the whole-volume accumulators, in place, for sm_90a.
//
// Replaces vs_seg_tpu/ops/pallas_blend.py:pallas_blend_scatter
// (_blend_kernel). For each window i in index order:
//   out_acc[s_i + p, :] += pred_i[p, :] * (imp[p] * mask_i)
//   w_acc[s_i + p]      += imp[p] * mask_i
//
// Layout (D-first): out_acc f32 (D, H, W, O), w_acc f32 (D, H, W),
// preds bf16 or f32 (N, RD, RH, RW, O), imp f32 (RD, RH, RW). The window
// table (starts (d, h, w) and mask, at most WMAX windows) is a kernel
// argument: the launcher copies it from host arrays into the argument
// buffer, so a launch makes no host-to-device copy and a CUDA graph that
// captures it keeps the table it was captured with. More windows are
// launched in consecutive chunks of WMAX by the wrapper (ops/blend.py).
//
// Design: each thread owns V voxels along W inside the union box of the
// launch's windows and walks the windows in index order, so overlapping
// windows add in the same order as the JAX reference's sequential loop
// (vs_seg_tpu/infer/sliding_window.py:_scatter_accumulate) with no atomics.
// The products and sums are __fmul_rn/__fadd_rn, so nvcc cannot contract
// them into FMAs: the result is the JAX f32 order bit for bit.
//   * Instance v4 (V = 4, O = 2; every window's w-start, RW and W multiples
//     of 4, 16-byte aligned tensors): a group of 4 voxels never straddles a
//     window edge, so one coverage test serves the group and every access is
//     16 bytes: the bf16 predictions of the group one load (two for f32),
//     out_acc two loads and two stores, w_acc and imp one each.
//   * Instance v1 (V = 1, O <= 8): any other geometry, one voxel a thread.
// Per thread, the coverage tests compare against the argument table (no
// global load); then every load is issued (the accumulators, and each
// covering window's predictions and importance) before the first add, so
// up to WMAX windows' bytes are in flight at once; then the adds run in
// window order. Voxels no window covers are neither read nor written.
//
// What bounds it on the H100: memory. Each voxel's accumulators are read
// and written once per launch and each covering window's prediction read
// once. imp (37.7 MB in the flagship) is read once per covering window,
// ~4.7 times a value; the voxels that read one imp value lie a window
// step apart (16 planes in d, 64 rows in h, 64 columns in w). Rows and
// columns that far apart run close in time anyway; for d the grid walks
// the box's planes in the order d, d + dstep, d + 2 dstep, ... (dstep: the
// d gap between the windows, from the wrapper), so the repeats find imp in
// L2. Every access streams (ld/st .cs, evict first): an L2 evict_last
// policy on imp measured slower (it holds 37.7 MB of the 50 MB L2 against
// the streaming traffic).

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int OMAX = 8;
constexpr int WMAX = 8;

struct WinTable {
  int s[WMAX][3];  // (d, h, w) start of each window
  float m[WMAX];   // mask (0 for a padded batch slot)
};

__device__ __forceinline__ float lo_bf16(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// One window's predictions of a thread's V voxels, as loaded (raw words,
// unpacked only at the add) — channel order is (voxel, channel).
template <typename T, int V>
struct Pred;

template <>
struct Pred<__nv_bfloat16, 4> {  // 4 voxels x 2 channels: one 16-byte load
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int) {
    u = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int j, int c) const {
    const unsigned w = j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
    return c == 0 ? lo_bf16(w) : hi_bf16(w);
  }
};

template <>
struct Pred<float, 4> {  // 4 voxels x 2 channels: two 16-byte loads
  float4 a, b;
  __device__ __forceinline__ void load(const float* p, int) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float get(int j, int c) const {
    const float4& q = j < 2 ? a : b;
    return (j & 1) == 0 ? (c == 0 ? q.x : q.y) : (c == 0 ? q.z : q.w);
  }
};

template <typename T>
struct Pred<T, 1> {  // 1 voxel x O <= OMAX channels
  T v[OMAX];
  __device__ __forceinline__ void load(const T* p, int o) {
#pragma unroll
    for (int c = 0; c < OMAX; ++c)
      if (c < o) v[c] = __ldcs(p + c);
  }
  __device__ __forceinline__ float get(int, int c) const {
    if constexpr (sizeof(T) == 2)
      return __bfloat162float(v[c]);
    else
      return v[c];
  }
};

template <int V>
struct Imp;

template <>
struct Imp<4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

template <>
struct Imp<1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldcs(p); }
  __device__ __forceinline__ float get(int) const { return v; }
};

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS) blend_kernel(
    float* __restrict__ out_acc, float* __restrict__ w_acc,
    const T* __restrict__ preds, const float* __restrict__ imp,
    const WinTable win, int nwin, int H, int W, int O, int RD, int RH,
    int RW, int bd0, int bh0, int bw0, int bd, int bh, int bwg, int dstep) {
  // channel slots: v4 is the O = 2 instance, v1 takes any O <= OMAX
  constexpr int OC = V == 4 ? 2 : OMAX;
  // blockIdx.y is the plane's place q in the walk, blockIdx.x a stretch of
  // its bh x bwg threads (row-major)
  const int t = blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= bh * bwg) return;
  const int w = bw0 + V * (t % bwg);
  const int h = bh0 + t / bwg;
  // plane q of the walk is d = a * dstep + b: b-major, so the planes that
  // read one imp plane run one after another (the first rem values of b
  // have m0 + 1 planes, the others m0)
  const int q = blockIdx.y;
  const int m0 = bd / dstep, rem = bd - m0 * dstep;
  int a, b;
  if (q < rem * (m0 + 1)) {
    b = q / (m0 + 1);
    a = q - b * (m0 + 1);
  } else {
    b = rem + (q - rem * (m0 + 1)) / m0;
    a = q - rem * (m0 + 1) - (b - rem) * m0;
  }
  const int d = bd0 + a * dstep + b;

  // coverage of the group by each window of the argument table
  bool cov[WMAX];
  unsigned pofs[WMAX];  // unsigned: wraps harmlessly where not covered
  bool any = false;
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    const int ld = d - win.s[i][0], lh = h - win.s[i][1],
              lw = w - win.s[i][2];
    cov[i] = i < nwin && (unsigned)ld < (unsigned)RD &&
             (unsigned)lh < (unsigned)RH && (unsigned)lw < (unsigned)RW;
    pofs[i] = ((unsigned)ld * RH + lh) * RW + lw;
    any |= cov[i];
  }
  if (!any) return;

  // every load before the first add
  const size_t vox = ((size_t)d * H + h) * W + w;
  float o[V][OC], ws[V];
  if constexpr (V == 4) {
    const float4* oa = reinterpret_cast<const float4*>(out_acc + vox * 2);
    const float4 a = __ldcs(oa), b = __ldcs(oa + 1);
    const float4 wv = __ldcs(reinterpret_cast<const float4*>(w_acc + vox));
    o[0][0] = a.x; o[0][1] = a.y; o[1][0] = a.z; o[1][1] = a.w;
    o[2][0] = b.x; o[2][1] = b.y; o[3][0] = b.z; o[3][1] = b.w;
    ws[0] = wv.x; ws[1] = wv.y; ws[2] = wv.z; ws[3] = wv.w;
  } else {
#pragma unroll
    for (int c = 0; c < OC; ++c)
      if (c < O) o[0][c] = __ldcs(out_acc + vox * O + c);
    ws[0] = __ldcs(w_acc + vox);
  }
  const size_t win_elems = (size_t)RD * RH * RW;
  Pred<T, V> pr[WMAX];
  Imp<V> im[WMAX];
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    if (cov[i]) {
      pr[i].load(preds + (i * win_elems + pofs[i]) * (V == 4 ? 2 : O), O);
      im[i].load(imp + pofs[i]);
    }
  }

  // the adds, window by window in index order
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    if (!cov[i]) continue;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float wt = __fmul_rn(im[i].get(j), win.m[i]);
#pragma unroll
      for (int c = 0; c < OC; ++c)
        if (c < O)
          o[j][c] = __fadd_rn(o[j][c], __fmul_rn(pr[i].get(j, c), wt));
      ws[j] = __fadd_rn(ws[j], wt);
    }
  }

  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(out_acc + vox * 2),
           make_float4(o[0][0], o[0][1], o[1][0], o[1][1]));
    __stcs(reinterpret_cast<float4*>(out_acc + vox * 2) + 1,
           make_float4(o[2][0], o[2][1], o[3][0], o[3][1]));
    __stcs(reinterpret_cast<float4*>(w_acc + vox),
           make_float4(ws[0], ws[1], ws[2], ws[3]));
  } else {
#pragma unroll
    for (int c = 0; c < OC; ++c)
      if (c < O) __stcs(out_acc + vox * O + c, o[0][c]);
    __stcs(w_acc + vox, ws[0]);
  }
}

template <typename T, int V>
void launch(dim3 blocks, cudaStream_t s, float* oa, float* wa,
            const void* preds, const float* im, const WinTable& win,
            int nwin, int h, int w, int o, int rd, int rh, int rw, int bd0,
            int bh0, int bw0, int bd, int bh, int bw, int dstep) {
  blend_kernel<T, V><<<blocks, NTHREADS, 0, s>>>(
      oa, wa, static_cast<const T*>(preds), im, win, nwin, h, w, o, rd, rh,
      rw, bd0, bh0, bw0, bd, bh, bw / V, dstep);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Windows a launch takes; the wrapper launches more in chunks of this many.
extern "C" int blend_wmax() { return WMAX; }

// starts (nwin, 3) i32 and mask (nwin,) f32 are HOST arrays, read before
// this returns. v4 asks for the 4-voxel instance (the wrapper's choice; the
// geometry it needs is checked here too). preds points at the launch's first
// window. The box (bd0, bh0, bw0) + (bd, bh, bw) is the union of the windows;
// dstep in [1, bd] orders the planes (any value gives the same result).
extern "C" int blend_launch(void* out_acc, void* w_acc, const void* preds,
                            int preds_f32, int v4, const int* starts,
                            const float* mask, const void* imp, int nwin,
                            int d, int h, int w, int o, int rd, int rh, int rw,
                            int bd0, int bh0, int bw0, int bd, int bh, int bw,
                            int dstep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nwin < 1 || nwin > WMAX || o < 1 || o > OMAX || dstep < 1 ||
      dstep > bd || (long long)rd * rh * rw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  WinTable win = {};
  for (int i = 0; i < nwin; ++i) {
    for (int k = 0; k < 3; ++k) win.s[i][k] = starts[3 * i + k];
    win.m[i] = mask[i];
    if (v4 && win.s[i][2] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v4 && (o != 2 || w % 4 || rw % 4 || bw0 % 4 || bw % 4 ||
             !aligned16(out_acc) || !aligned16(w_acc) || !aligned16(preds) ||
             !aligned16(imp)))
    return static_cast<int>(cudaErrorInvalidValue);
  // one grid row of blocks per plane of the box
  const long long nthr = (long long)bh * (bw / (v4 ? 4 : 1));
  if (nthr > 0x7fffffffLL || bd > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((unsigned)((nthr + NTHREADS - 1) / NTHREADS), bd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* oa = static_cast<float*>(out_acc);
  float* wa = static_cast<float*>(w_acc);
  const float* im = static_cast<const float*>(imp);
  if (v4 && preds_f32)
    launch<float, 4>(blocks, s, oa, wa, preds, im, win, nwin, h, w, o, rd,
                     rh, rw, bd0, bh0, bw0, bd, bh, bw, dstep);
  else if (v4)
    launch<__nv_bfloat16, 4>(blocks, s, oa, wa, preds, im, win, nwin, h, w,
                             o, rd, rh, rw, bd0, bh0, bw0, bd, bh, bw, dstep);
  else if (preds_f32)
    launch<float, 1>(blocks, s, oa, wa, preds, im, win, nwin, h, w, o, rd,
                     rh, rw, bd0, bh0, bw0, bd, bh, bw, dstep);
  else
    launch<__nv_bfloat16, 1>(blocks, s, oa, wa, preds, im, win, nwin, h, w,
                             o, rd, rh, rw, bd0, bh0, bw0, bd, bh, bw, dstep);
  return static_cast<int>(cudaGetLastError());
}
