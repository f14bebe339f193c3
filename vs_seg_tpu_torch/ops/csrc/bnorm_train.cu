// bnorm_train — the train-mode BatchNorm -> dropout -> PReLU of a
// Convolution (nn/blocks.py) as two passes forward and two backward, for
// sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm, dropout and
// PReLU to XLA, which fuses them on the TPU. In the port's eager PyTorch
// the same chain ran as some 25 full-tensor passes a site (the f32 copy,
// its square, two means, the scale and shift, the dropout's divide and
// masked_fill, PReLU's clamps, then twice as many in the backward).
//
// Layout: y (the conv's output) is a contiguous (N, D, H, W, C) bf16
// tensor, viewed flat as n elements; element e has channel e % C.
// Every pass walks it in vectors of 8 consecutive elements (16 bytes,
// aligned since the tensor is): thread t of block b takes vectors
// v = b * T + t, then v + G * T, ... (grid stride; G blocks, all resident
// at once, `grid`). The block size T has 8 * T a multiple of C
// (block_threads), so lane j of a thread always holds channel (8 t + j) % C:
// its per-channel parameters and sums stay in registers for the whole walk.
// This file holds the whole launch plan; the wrapper asks bnorm_plan only
// for the rows of scratch a reduction's partial sums take.
// A last vector past n is read as zeros and its lanes past n are not
// written.
//
//   bnorm_stats_kernel       per-block partial sums of y and y^2 per
//                            channel, f32
//   bnorm_sum_kernel         the partials of every block summed in block
//                            order, one block a sum
//   bnorm_finish_kernel      on C-length vectors: mean, var, the running
//                            statistics, rstd and inv, by BatchNorm's
//                            formulas rounded op by op as torch does
//   bnorm_apply_kernel       out = prelu(drop((y - mean) * inv + bias)) in
//                            f32, rounded once to bf16; with
//                            dropout, element e is kept where its word
//                            (torch.randint's int32) is below thresh, and
//                            the keep mask is written at 1 bit an element
//                            (byte v holds vector v, bit j lane j)
//   bnorm_bwd_reduce_kernel  from g, y and the mask, per channel the sums
//                            of gh and gh * (y - mean), where gh is g after
//                            PReLU's and dropout's backward, and the
//                            scalar sum of g * min(z', 0) (the slope's
//                            gradient); partials as the stats'
//   bnorm_bwd_finish_kernel  on C-length vectors: the scale's gradient and
//                            the coefficients c1, c2 from those sums
//   bnorm_bwd_apply_kernel   dy = inv * gh + (c2 * (y - mean) + c1)
//
// The two finishes are one launch each where torch took some ten small
// launches a direction: at ~26 sites a step those launches paced the host
// behind the device.
//
// Every reduction has a fixed order: a thread's sums in walk order, the
// block's per channel in thread order (block_channel_sums), the blocks' in
// block order (bnorm_sum_kernel). No float atomics, so a call is
// bit-reproducible for a given grid. The elementwise arithmetic is
// __fmul_rn / __fadd_rn in the order of the plain twins
// (ops/bnorm_train.py), which torch also rounds op by op: given the same
// statistics, apply and bwd_apply are bit-equal to their twins, and the
// finishes to theirs, torch's ops on the card.
//
// What bounds it on the H100: bytes. A level-0 site of the flagship
// (151 M elements, C = 16) reads y twice and the dropout words once and
// writes the output and the mask in the forward (~1.5 GB with the words,
// ~0.45 ms at 3.35 TB/s), and reads g and y twice and the mask twice and
// writes dy in the backward (~1.55 GB, ~0.46 ms). The design keeps every
// intermediate (the f32 copy, the normalised value, the dropout output,
// the PReLU input) in registers, and the mask at 1 bit an element in place
// of the int32 words and the bool mask autograd kept.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_THREADS = 512;
constexpr int THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr size_t MAX_SHARED = 48 * 1024;

__device__ __forceinline__ void load8(const bf16* __restrict__ p, long long v,
                                      long long n, float* f) {
  if (8 * v + 8 <= n) {
    unpack8(reinterpret_cast<const uint4*>(p)[v], f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long e = 8 * v + j;
      f[j] = e < n ? bf2f(p[e]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store8(bf16* __restrict__ p, long long v,
                                       long long n, const float* f) {
  if (8 * v + 8 <= n) {
    reinterpret_cast<uint4*>(p)[v] = pack8(f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * v + j < n) p[8 * v + j] = __float2bfloat16_rn(f[j]);
  }
}

// The keep bits of vector v: bit j set where word 8 v + j is below thresh
// (lanes past n: 0).
__device__ __forceinline__ unsigned keep_bits(const int* __restrict__ words,
                                              long long v, long long n,
                                              int thresh) {
  unsigned bits = 0;
  if (8 * v + 8 <= n) {
    const int4* q = reinterpret_cast<const int4*>(words) + 2 * v;
    const int4 a = q[0], b = q[1];
    const int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) bits |= unsigned(w[j] < thresh) << j;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long e = 8 * v + j;
      if (e < n && words[e] < thresh) bits |= 1u << j;
    }
  }
  return bits;
}

// The per-channel values of this thread's 8 lanes: lane j holds channel
// (8 t + j) % c at every vector of the walk.
__device__ __forceinline__ void lane_params(const float* __restrict__ src,
                                            int c, float* dst) {
  const int c0 = (8 * static_cast<int>(threadIdx.x)) % c;
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = src[(c0 + j) % c];
}

// The value z' after dropout of one element's z: 0 where dropped, z times
// rkeep (the f32 reciprocal of keep, as torch divides a CUDA tensor by a
// scalar) where kept; z without dropout.
template <bool DROP>
__device__ __forceinline__ float dropped(float z, bool kept, float rkeep) {
  if (!DROP) return z;
  return kept ? __fmul_rn(z, rkeep) : 0.f;
}

// gh = dL/dz of one element from g = dL/d out: PReLU's slope (1 where z' >
// 0, alpha elsewhere), then dropout's mask and rkeep.
template <bool DROP>
__device__ __forceinline__ float grad_z(float g, float zp, bool kept,
                                        float alpha, float rkeep) {
  const float gz = zp > 0.f ? g : __fmul_rn(g, alpha);
  if (!DROP) return gz;
  return kept ? __fmul_rn(gz, rkeep) : 0.f;
}

// One vector's backward inputs: g and y as floats and the keep bits.
// bwd_reduce loads the next vector of its walk before it computes on this
// one, so that its bytes are in flight during the arithmetic (0.36 against
// 0.43 ms at a level-0 site); bwd_apply, whose stores keep bytes in flight
// anyway, measured slower so (0.45 against 0.41) and loads as it goes.
template <bool DROP>
struct BwdIn {
  float g[8], y[8];
  unsigned bits;

  __device__ __forceinline__ void load(const bf16* __restrict__ gp,
                                       const bf16* __restrict__ yp,
                                       const unsigned char* __restrict__ mask,
                                       long long v, long long n) {
    load8(gp, v, n, g);
    load8(yp, v, n, y);
    bits = DROP ? mask[v] : 0xffu;
  }
};

// Sum NQ per-lane quantities over the block's threads per channel, in a
// fixed order, into partials[(q * c + ch) * gridDim.x + blockIdx.x]. Lane j
// of thread t holds element 8 t + j of the block's span of 8 T elements,
// channel (8 t + j) % c; a channel's 8 T / c terms are split into `parts`
// interleaved slices summed side by side, then the slices in order.
// Shared memory: NQ * (8 T + max(T, c)) floats.
template <int NQ>
__device__ void block_channel_sums(const float (&acc)[NQ][8], int c,
                                   float* __restrict__ partials, float* sh) {
  const int t = threadIdx.x, nt = blockDim.x, span = 8 * nt;
  const int parts = nt >= c ? nt / c : 1;
  const int terms = span / c;
  const int wide = nt > c ? nt : c;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) sh[q * span + 8 * t + j] = acc[q][j];
  __syncthreads();
  float* sh2 = sh + NQ * span;
  for (int idx = t; idx < parts * c; idx += nt) {
    const int ch = idx % c, p = idx / c;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float a = 0.f;
      for (int k = p; k < terms; k += parts) a += sh[q * span + ch + k * c];
      sh2[q * wide + idx] = a;
    }
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += nt) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float a = 0.f;
      for (int p = 0; p < parts; ++p) a += sh2[q * wide + p * c + ch];
      partials[static_cast<size_t>(q * c + ch) * gridDim.x + blockIdx.x] = a;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    bnorm_stats_kernel(const bf16* __restrict__ y, long long n, int c,
                       float* __restrict__ partials) {
  extern __shared__ float sh[];
  float acc[2][8] = {};
  const long long nvec = (n + 7) / 8;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += step) {
    float f[8];
    load8(y, v, n, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[0][j] += f[j];
      acc[1][j] = fmaf(f[j], f[j], acc[1][j]);
    }
  }
  block_channel_sums<2>(acc, c, partials, sh);
}

// out[j] = sum over b in block order of partials[j * nblk + b].
__global__ void __launch_bounds__(SUM_THREADS)
    bnorm_sum_kernel(const float* __restrict__ partials, int nblk,
                     float* __restrict__ out) {
  __shared__ float sh[SUM_THREADS];
  const int t = threadIdx.x;
  const float* row = partials + static_cast<size_t>(blockIdx.x) * nblk;
  float a = 0.f;
  for (int b = t; b < nblk; b += SUM_THREADS) a += row[b];
  sh[t] = a;
  __syncthreads();
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = sh[0];
}

// x over the count: where the host gives it, x times rcp, the f32
// reciprocal of the count, as torch divides a CUDA tensor by a Python
// scalar; where the ranks summed it into *count, a true division.
__device__ __forceinline__ float over_count(float x, const float* count,
                                            float rcp) {
  return count != nullptr ? __fdiv_rn(x, *count) : __fmul_rn(x, rcp);
}

// The forward's finish on C-length vectors, one thread a channel:
// nn/layers.py:BatchNorm.forward's formulas, each op rounded as torch
// rounds it on the card (ops/bnorm_train.py:finish_plain). sums: the 2 c
// sums of y and y^2 (of the global batch under a batch-stats group). The
// count: rcp and the unbiased factor from the host where `count` is NULL
// (f32 roundings of its doubles, as torch takes a Python scalar); else
// *count, summed over the ranks, with the factor formed here in f32.
// Writes out = [mean | rstd | inv] (3 c) and updates the running
// statistics in place: (1 - m) * running + m * batch, the unbiased var for
// the batch's.
__global__ void bnorm_finish_kernel(const float* __restrict__ sums,
                                    const float* __restrict__ count,
                                    float rcp, float factor, float decay,
                                    float momentum, float eps,
                                    const float* __restrict__ scale,
                                    float* __restrict__ run_mean,
                                    float* __restrict__ run_var,
                                    float* __restrict__ out, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  if (count != nullptr) {
    const float n = *count;
    factor = __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.f), 1.f));
  }
  const float mean = over_count(sums[ch], count, rcp);
  const float var = __fsub_rn(over_count(sums[c + ch], count, rcp),
                              __fmul_rn(mean, mean));
  run_mean[ch] =
      __fadd_rn(__fmul_rn(run_mean[ch], decay), __fmul_rn(mean, momentum));
  run_var[ch] = __fadd_rn(__fmul_rn(run_var[ch], decay),
                          __fmul_rn(__fmul_rn(var, factor), momentum));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  out[ch] = mean;
  out[c + ch] = rstd;
  out[2 * c + ch] = __fmul_rn(rstd, scale[ch]);
}

// The backward's finish, one thread a channel (bwd_finish_plain): from
// bwd_reduce's sums (2 c + 1) and `total`, their first 2 c summed over the
// ranks (sums itself outside a group), writes out = [dscale | c1 | c2]
// (3 c): dscale = rstd * sum gh (y - mean), c1 = -inv sum gh / n and c2 =
// -inv rstd^2 sum gh (y - mean) / n, the count as in bnorm_finish_kernel
// (rcp the reciprocal of -n).
__global__ void bnorm_bwd_finish_kernel(const float* __restrict__ sums,
                                        const float* __restrict__ total,
                                        const float* __restrict__ count,
                                        float rcp,
                                        const float* __restrict__ rstd,
                                        const float* __restrict__ inv,
                                        float* __restrict__ out, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float r = rstd[ch], iv = inv[ch];
  const float ir2 = __fmul_rn(__fmul_rn(iv, r), r);
  const float neg = count != nullptr ? -*count : 0.f;
  const float s1 = count != nullptr ? __fdiv_rn(iv, neg) : __fmul_rn(iv, rcp);
  const float s2 =
      count != nullptr ? __fdiv_rn(ir2, neg) : __fmul_rn(ir2, rcp);
  out[ch] = __fmul_rn(sums[c + ch], r);
  out[c + ch] = __fmul_rn(total[ch], s1);
  out[2 * c + ch] = __fmul_rn(total[c + ch], s2);
}

template <bool DROP>
__global__ void __launch_bounds__(MAX_THREADS)
    bnorm_apply_kernel(const bf16* __restrict__ y,
                       const int* __restrict__ words, int thresh, float rkeep,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       const float* __restrict__ bias,
                       const float* __restrict__ alpha, long long n, int c,
                       bf16* __restrict__ out,
                       unsigned char* __restrict__ mask) {
  float mu[8], iv[8], bs[8];
  lane_params(mean, c, mu);
  lane_params(inv, c, iv);
  lane_params(bias, c, bs);
  const float a = *alpha;
  const long long nvec = (n + 7) / 8;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += step) {
    float f[8], o[8];
    load8(y, v, n, f);
    const unsigned bits = DROP ? keep_bits(words, v, n, thresh) : 0xffu;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __fsub_rn(f[j], mu[j]);
      const float z = __fadd_rn(__fmul_rn(d, iv[j]), bs[j]);
      const float zp = dropped<DROP>(z, (bits >> j) & 1u, rkeep);
      o[j] = zp > 0.f ? zp : __fmul_rn(a, zp);
    }
    store8(out, v, n, o);
    if (DROP) mask[v] = static_cast<unsigned char>(bits);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(MAX_THREADS)
    bnorm_bwd_reduce_kernel(const bf16* __restrict__ g,
                            const bf16* __restrict__ y,
                            const unsigned char* __restrict__ mask,
                            float rkeep, const float* __restrict__ mean,
                            const float* __restrict__ inv,
                            const float* __restrict__ bias,
                            const float* __restrict__ alpha, long long n,
                            int c, float* __restrict__ partials) {
  extern __shared__ float sh[];
  float mu[8], iv[8], bs[8];
  lane_params(mean, c, mu);
  lane_params(inv, c, iv);
  lane_params(bias, c, bs);
  const float a = *alpha;
  float acc[2][8] = {};
  float slope = 0.f;
  const long long nvec = (n + 7) / 8;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  BwdIn<DROP> in, next;
  if (v < nvec) in.load(g, y, mask, v, n);
  for (; v < nvec; v += step) {
    const bool more = v + step < nvec;
    if (more) next.load(g, y, mask, v + step, n);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool kept = (in.bits >> j) & 1u;
      const float d = __fsub_rn(in.y[j], mu[j]);
      const float z = __fadd_rn(__fmul_rn(d, iv[j]), bs[j]);
      const float zp = dropped<DROP>(z, kept, rkeep);
      const float gh = grad_z<DROP>(in.g[j], zp, kept, a, rkeep);
      acc[0][j] += gh;
      acc[1][j] = fmaf(gh, d, acc[1][j]);
      slope = fmaf(in.g[j], fminf(zp, 0.f), slope);
    }
    if (more) in = next;
  }
  block_channel_sums<2>(acc, c, partials, sh);
  // the slope's sum: a tree over the threads in a fixed order, after the
  // channel sums' shared memory
  const int t = threadIdx.x, nt = blockDim.x;
  float* sh3 = sh + 2 * (8 * nt + (nt > c ? nt : c));
  sh3[t] = slope;
  __syncthreads();
  for (int s = 1; s < nt; s *= 2) {
    if (t % (2 * s) == 0 && t + s < nt) sh3[t] += sh3[t + s];
    __syncthreads();
  }
  if (t == 0)
    partials[static_cast<size_t>(2 * c) * gridDim.x + blockIdx.x] = sh3[0];
}

// At most 64 registers (2 blocks of MAX_THREADS, 4 of 256 on an SM): 0.39
// against 0.41 ms at a level-0 site, bit-equal.
template <bool DROP>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    bnorm_bwd_apply_kernel(const bf16* __restrict__ g,
                           const bf16* __restrict__ y,
                           const unsigned char* __restrict__ mask, float rkeep,
                           const float* __restrict__ mean,
                           const float* __restrict__ inv,
                           const float* __restrict__ bias,
                           const float* __restrict__ alpha,
                           const float* __restrict__ c1,
                           const float* __restrict__ c2, long long n, int c,
                           bf16* __restrict__ dy) {
  float mu[8], iv[8], bs[8], k1[8], k2[8];
  lane_params(mean, c, mu);
  lane_params(inv, c, iv);
  lane_params(bias, c, bs);
  lane_params(c1, c, k1);
  lane_params(c2, c, k2);
  const float a = *alpha;
  const long long nvec = (n + 7) / 8;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += step) {
    BwdIn<DROP> in;
    in.load(g, y, mask, v, n);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool kept = (in.bits >> j) & 1u;
      const float d = __fsub_rn(in.y[j], mu[j]);
      const float z = __fadd_rn(__fmul_rn(d, iv[j]), bs[j]);
      const float zp = dropped<DROP>(z, kept, rkeep);
      const float gh = grad_z<DROP>(in.g[j], zp, kept, a, rkeep);
      o[j] = __fadd_rn(__fmul_rn(iv[j], gh),
                       __fadd_rn(__fmul_rn(k2[j], d), k1[j]));
    }
    store8(dy, v, n, o);
  }
}

// The shared memory of a reduction kernel with nq per-channel quantities
// (and the scalar's T floats where `scalar`).
size_t reduce_shared(int nq, int nt, int c, bool scalar) {
  const int wide = nt > c ? nt : c;
  return sizeof(float) *
         (static_cast<size_t>(nq) * (8 * nt + wide) + (scalar ? nt : 0));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The block size T of every pass over c channels: 8 T a multiple of c, the
// largest multiple of u = c / gcd(c, 8) up to THREADS, or u itself up to
// MAX_THREADS; 0 where c needs more threads, or more shared memory than
// MAX_SHARED in bwd_reduce (which takes the most).
int block_threads(int c) {
  if (c <= 0) return 0;
  int a = c, b = 8;
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int u = c / a;
  if (u > MAX_THREADS) return 0;
  const int nt = u <= THREADS ? (THREADS / u) * u : u;
  return reduce_shared(2, nt, c, true) <= MAX_SHARED ? nt : 0;
}

// The geometry every launcher takes: n > 0 elements of c channels that
// block_threads takes (nt, its block size).
bool geometry_ok(long long n, int c, int nt) {
  return n > 0 && nt > 0 && n % c == 0;
}

// An elementwise pass's grid has no cap beyond residency and its vectors.
constexpr int NO_CAP = 1 << 30;

// The grid of a pass: every block resident at once (a block of the grid
// stride walk that waited for a slot would run its share alone at the
// end), as many as the SMs hold of `kernel` at T threads, no more than the
// walk's vectors need or max_blocks (the partials' rows; bnorm_plan's
// residency bound is never below the grid). The same for a given kernel,
// shape and card, so the sums' order is.
template <typename K>
cudaError_t grid(K kernel, int nt, size_t smem, long long n, int device,
                 int max_blocks, int* nblk) {
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long need = ((n + 7) / 8 + nt - 1) / nt;
  long long g = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (g > need) g = need;
  if (g > max_blocks) g = max_blocks;
  *nblk = static_cast<int>(g);
  return cudaSuccess;
}

// Launch `kernel` on its grid; `sums` > 0: then bnorm_sum_kernel over the
// partials into out.
template <typename K, typename... Args>
int launch(K kernel, int nt, size_t smem, long long n, int device,
           int max_blocks, cudaStream_t s, int sums, const float* partials,
           float* out, Args... args) {
  int nblk = 0;
  cudaError_t err = grid(kernel, nt, smem, n, device, max_blocks, &nblk);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblk, nt, smem, s>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess || sums == 0) return static_cast<int>(err);
  bnorm_sum_kernel<<<sums, SUM_THREADS, 0, s>>>(partials, nblk, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The one number of the plan the caller needs: *rows, the most blocks (rows
// of partial sums) a reduction over c channels takes on `device`: as many
// blocks of block_threads(c) threads as its SMs hold at once.
// cudaErrorInvalidValue where the kernels cannot take c.
extern "C" int bnorm_plan(int c, int device, int* rows) {
  const int nt = block_threads(c);
  if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, threads = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&threads,
                               cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *rows = sms * (threads / nt);
  return static_cast<int>(cudaSuccess);
}

// sums[0 .. c) = sum of y per channel, sums[c .. 2c) = sum of y^2; partials
// holds 2 c * rows floats of scratch (rows: bnorm_plan's).
extern "C" int bnorm_stats_launch(const void* y, long long n, int c, int rows,
                                  float* partials, float* sums, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = block_threads(c);
  if (!geometry_ok(n, c, nt) || rows <= 0 || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(bnorm_stats_kernel, nt, reduce_shared(2, nt, c, false), n,
                device, rows,
                static_cast<cudaStream_t>(stream), 2 * c, partials, sums,
                static_cast<const bf16*>(y), n, c, partials);
}

// out and, where words is not NULL (dropout), mask (ceil(n / 8) bytes).
// mean, inv, bias: c floats; alpha: 1 float; all on the device.
extern "C" int bnorm_apply_launch(const void* y, const int* words, int thresh,
                                  float rkeep, const float* mean,
                                  const float* inv, const float* bias,
                                  const float* alpha, long long n, int c,
                                  void* out, unsigned char* mask, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = block_threads(c);
  if (!geometry_ok(n, c, nt) || !aligned16(y) || !aligned16(out) ||
      (words != nullptr && (!aligned16(words) || mask == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(words ? bnorm_apply_kernel<true> : bnorm_apply_kernel<false>,
                nt, 0, n, device, NO_CAP,
                static_cast<cudaStream_t>(stream), 0, nullptr, nullptr,
                static_cast<const bf16*>(y), words, thresh, rkeep, mean, inv,
                bias, alpha, n, c, static_cast<bf16*>(out), mask);
}

// sums[0 .. c) = sum of gh per channel, sums[c .. 2c) = sum of gh * (y -
// mean), sums[2c] = sum of g * min(z', 0); partials holds (2 c + 1) *
// rows floats of scratch (rows: bnorm_plan's). mask NULL: no dropout.
extern "C" int bnorm_bwd_reduce_launch(const void* g, const void* y,
                                       const unsigned char* mask, float rkeep,
                                       const float* mean, const float* inv,
                                       const float* bias, const float* alpha,
                                       long long n, int c, int rows,
                                       float* partials, float* sums,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = block_threads(c);
  if (!geometry_ok(n, c, nt) || rows <= 0 || !aligned16(g) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(
      mask ? bnorm_bwd_reduce_kernel<true> : bnorm_bwd_reduce_kernel<false>,
      nt, reduce_shared(2, nt, c, true), n, device, rows,
      static_cast<cudaStream_t>(stream),
      2 * c + 1, partials, sums, static_cast<const bf16*>(g),
      static_cast<const bf16*>(y), mask, rkeep, mean, inv, bias, alpha, n, c,
      partials);
}

// The forward's finish (bnorm_finish_kernel); count NULL: rcp and factor
// are the host's. All pointers on the device, c floats each but sums (2 c)
// and out (3 c).
extern "C" int bnorm_finish_launch(const float* sums, const float* count,
                                   float rcp, float factor, float decay,
                                   float momentum, float eps,
                                   const float* scale, float* run_mean,
                                   float* run_var, float* out, int c,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bnorm_finish_kernel<<<(c + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      sums, count, rcp, factor, decay, momentum, eps, scale, run_mean,
      run_var, out, c);
  return static_cast<int>(cudaGetLastError());
}

// The backward's finish (bnorm_bwd_finish_kernel); count NULL: rcp, the
// reciprocal of -n, is the host's. sums 2 c + 1 floats, total 2 c, rstd
// and inv c, out 3 c.
extern "C" int bnorm_bwd_finish_launch(const float* sums, const float* total,
                                       const float* count, float rcp,
                                       const float* rstd, const float* inv,
                                       float* out, int c, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bnorm_bwd_finish_kernel<<<(c + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS,
                            0, static_cast<cudaStream_t>(stream)>>>(
      sums, total, count, rcp, rstd, inv, out, c);
  return static_cast<int>(cudaGetLastError());
}

// dy = inv * gh + (c2 * (y - mean) + c1); mask NULL: no dropout.
extern "C" int bnorm_bwd_apply_launch(const void* g, const void* y,
                                      const unsigned char* mask, float rkeep,
                                      const float* mean, const float* inv,
                                      const float* bias, const float* alpha,
                                      const float* c1, const float* c2,
                                      long long n, int c, void* dy,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = block_threads(c);
  if (!geometry_ok(n, c, nt) || !aligned16(g) || !aligned16(y) ||
      !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(
      mask ? bnorm_bwd_apply_kernel<true> : bnorm_bwd_apply_kernel<false>, nt,
      0, n, device, NO_CAP, static_cast<cudaStream_t>(stream), 0, nullptr,
      nullptr, static_cast<const bf16*>(g), static_cast<const bf16*>(y), mask,
      rkeep, mean, inv, bias, alpha, c1, c2, n, c, static_cast<bf16*>(dy));
}
