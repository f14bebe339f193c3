// mosaic_probe — the nine Mosaic probes of tools/mosaic_probe.py as Hopper
// kernels (sm_90a): the channel-group reduction of the attention kernel and
// its neighbours, each computing what the probe's pallas_call computes (not
// its lane layout), some in several schemes so the card can time them.
//
// Replaces tools/mosaic_probe.py:47-143 (case_reshape3d, case_3dtile,
// case_3droll, case_dotreduce, case_dotbcast, case_repeat,
// case_reshape128, case_reshape3d_pow2, case_narrow). All f32.
//
// - Group sum (reshape3d, 3dtile, reshape128, reshape3d_pow2): a flat array
//   of G groups of cm contiguous values -> G sums. Three schemes:
//     shuffle: a warp lane owns one 16-byte chunk (4 values); a group is
//       L = cm / 4 neighbouring lanes, 32 / L groups per warp, summed by a
//       segmented shfl_down tree (any L <= 32, not only powers of two).
//     smem: a block stages whole groups with 16-byte loads into shared
//       memory at a padded stride (cm + 1 words: conflict-free), then one
//       thread sums one group.
//     mma: the sum as a tensor-core product against the 0/1 group matrix
//       (mma.sync m16n8k8 TF32): the group matrix is made in registers (0
//       and 1 are exact in TF32) and x is split into two TF32 terms (hi +
//       lo), so the sum keeps about 21 bits.
// - Product (dotreduce x @ M, dotbcast a @ M^T): C = A (R x K) B (K x N), B
//   read through strides (M^T is M with its strides swapped). Schemes: mma
//   (m16n8k8 TF32, A and B each split hi + lo, three products: hi*hi +
//   lo*hi + hi*lo; a block of 8 warps splits K for one 16 x 8 tile and sums
//   the warps' tiles in a fixed order) and ffma (one thread per output, f32
//   FMAs in order of k).
// - repeat: out[r, j] = a[r, j / cm], one 16-byte store per thread.
// - 3droll: out = x + roll(x, 1, W) + roll(x, -1, W) (circular), one row
//   (W, C) per block staged in shared memory; the same two f32 adds in the
//   same order as the twin, so bit-equal.
// - narrow: s[r] = sum_c x[r, c]; out = s * g + g, one warp per row (a
//   butterfly), each product and sum rounded separately as in the twin.
//
// What bounds them on the H100: bytes (each is a few MB, read once); at the
// tool's sizes (at most 1.8 MB) launch latency sets the time. They exist to
// time the schemes on the card for csrc/attgate.cu's C -> 1 reduction.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- group sum ----------------------------------------------------------

__global__ void __launch_bounds__(256)
    gsum_shuffle(const float* __restrict__ x, float* __restrict__ out,
                 long long groups, int cm) {
  const int L = cm / 4;             // lanes per group
  const int gpw = 32 / L;           // groups per warp step
  const int lane = threadIdx.x & 31;
  const int gi = lane / L;          // this lane's group within the step
  const int li = lane - gi * L;     // lane within the group
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                         >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long g0 = warp * gpw; g0 < groups; g0 += nwarps * gpw) {
    const long long g = g0 + gi;
    float v = 0.f;
    if (gi < gpw && g < groups) {
      const float4 q = *reinterpret_cast<const float4*>(x + g * cm + li * 4);
      v = (q.x + q.y) + (q.z + q.w);
    }
    for (int off = 1; off < L; off <<= 1) {
      const float o = __shfl_down_sync(FULL, v, off);
      if (li + off < L) v += o;
    }
    if (li == 0 && gi < gpw && g < groups) out[g] = v;
  }
}

__global__ void __launch_bounds__(256)
    gsum_smem(const float* __restrict__ x, float* __restrict__ out,
              long long groups, int cm, int gpb) {
  extern __shared__ float s[];      // gpb groups at stride cm + 1
  const int pitch = cm + 1;
  for (long long g0 = (long long)blockIdx.x * gpb; g0 < groups;
       g0 += (long long)gridDim.x * gpb) {
    const int ng = (int)min((long long)gpb, groups - g0);
    const float4* src = reinterpret_cast<const float4*>(x + g0 * cm);
    for (int i = threadIdx.x; i < ng * cm / 4; i += blockDim.x) {
      const float4 q = src[i];
      const int e = i * 4;
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[((e + k) / cm) * pitch + (e + k) % cm] = v[k];
    }
    __syncthreads();
    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < cm; ++c) acc += s[g * pitch + c];
      out[g0 + g] = acc;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x viewed as (rows, cols) with cols % cm == 0; out (rows, cols / cm). One
// warp per 16-row x 8-group tile; its K range is those 8 groups' 8 * cm
// columns, in steps of 8. Fragments (PTX m16n8k8 .tf32): a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (k =
// t + 4, n = g); c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
// 2t + 1), with g = lane / 4, t = lane % 4.
__global__ void __launch_bounds__(128)
    gsum_mma(const float* __restrict__ x, float* __restrict__ out, int rows,
             int cols, int cm) {
  const int ng = cols / cm;
  const int tiles_n = (ng + 7) / 8;
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (tile >= ((rows + 15) / 16) * tiles_n) return;
  const int r0 = (tile / tiles_n) * 16, n0 = (tile % tiles_n) * 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const int k_end = min(cols, (n0 + 8) * cm);
  auto ld = [&](int r, int k) {
    return (r < rows && k < k_end) ? x[(size_t)r * cols + k] : 0.f;
  };
  for (int k0 = n0 * cm; k0 < k_end; k0 += 8) {
    const float av[4] = {ld(r0 + g, k0 + t), ld(r0 + g + 8, k0 + t),
                         ld(r0 + g, k0 + t + 4), ld(r0 + g + 8, k0 + t + 4)};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = tf32(av[i]);
      lo[i] = tf32(av[i] - __uint_as_float(hi[i]));
    }
    const uint32_t one = __float_as_uint(1.f);
    const uint32_t b[2] = {(k0 + t) / cm == n0 + g ? one : 0u,
                           (k0 + t + 4) / cm == n0 + g ? one : 0u};
    mma_tf32(c, hi, b);
    mma_tf32(c, lo, b);
  }
  const int rr[4] = {r0 + g, r0 + g, r0 + g + 8, r0 + g + 8};
  const int nn[4] = {n0 + 2 * t, n0 + 2 * t + 1, n0 + 2 * t, n0 + 2 * t + 1};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (rr[i] < rows && nn[i] < ng) out[(size_t)rr[i] * ng + nn[i]] = c[i];
}

// ---- product ------------------------------------------------------------

constexpr int MM_WARPS = 8;

// C (R x N) = A (R x K, row-major) * B, B(k, n) = b[k * sbk + n * sbn].
__global__ void __launch_bounds__(MM_WARPS * 32)
    mm_mma(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ c, int R, int K, int N, long long sbk,
           long long sbn) {
  __shared__ float part[MM_WARPS][4][32];
  const int tiles_n = (N + 7) / 8;
  const int r0 = (blockIdx.x / tiles_n) * 16, n0 = (blockIdx.x % tiles_n) * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto lda = [&](int r, int k) {
    return (r < R && k < K) ? a[(size_t)r * K + k] : 0.f;
  };
  auto ldb = [&](int k, int n) {
    return (k < K && n < N) ? b[k * sbk + n * sbn] : 0.f;
  };
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = warp * 8; k0 < K; k0 += MM_WARPS * 8) {
    const float av[4] = {lda(r0 + g, k0 + t), lda(r0 + g + 8, k0 + t),
                         lda(r0 + g, k0 + t + 4),
                         lda(r0 + g + 8, k0 + t + 4)};
    const float bv[2] = {ldb(k0 + t, n0 + g), ldb(k0 + t + 4, n0 + g)};
    uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ah[i] = tf32(av[i]);
      al[i] = tf32(av[i] - __uint_as_float(ah[i]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bh[i] = tf32(bv[i]);
      bl[i] = tf32(bv[i] - __uint_as_float(bh[i]));
    }
    mma_tf32(acc, al, bh);
    mma_tf32(acc, ah, bl);
    mma_tf32(acc, ah, bh);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
      for (int w = 0; w < MM_WARPS; ++w) s += part[w][i][lane];
      const int r = r0 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + 2 * t + (i & 1);
      if (r < R && n < N) c[(size_t)r * N + n] = s;
    }
  }
}

__global__ void __launch_bounds__(256)
    mm_ffma(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int R, int K, int N, long long sbk,
            long long sbn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * N) return;
  const int r = (int)(i / N), n = (int)(i % N);
  const float* ar = a + (size_t)r * K;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(ar[k], b[k * sbk + n * sbn], s);
  c[i] = s;
}

// ---- repeat, roll, narrow -----------------------------------------------

// a (rows, g) -> out (rows, g * cm), cm % 4 == 0.
__global__ void __launch_bounds__(256)
    repeat_kernel(const float* __restrict__ a, float* __restrict__ out,
                  int rows, int g, int cm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = g * cm / 4;          // float4 per output row
  if (i >= (long long)rows * q) return;
  const int r = (int)(i / q), j = (int)(i % q) * 4;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = a[(size_t)r * g + (j + k) / cm];
  reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

// x (rows, w, c) -> out, one row per block, w * c % 4 == 0.
__global__ void __launch_bounds__(256)
    roll_kernel(const float* __restrict__ x, float* __restrict__ out, int w,
                int c) {
  extern __shared__ float s[];
  const int n = w * c;
  const float4* src =
      reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * n);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s)[i] = src[i];
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * n);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = i * 4 + k, wi = e / c, ci = e - wi * c;
      const int wl = wi == 0 ? w - 1 : wi - 1, wr = wi == w - 1 ? 0 : wi + 1;
      v[k] = __fadd_rn(__fadd_rn(s[e], s[wl * c + ci]), s[wr * c + ci]);
    }
    dst[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// x, gt (rows, c) -> out = s * gt + gt, s = sum of x's row.
__global__ void __launch_bounds__(256)
    narrow_kernel(const float* __restrict__ x, const float* __restrict__ gt,
                  float* __restrict__ out, int rows, int c) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* xr = x + (size_t)r * c;
  float v = 0.f;
  for (int i = lane; i < c; i += 32) v += xr[i];
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  for (int i = lane; i < c; i += 32) {
    const float gv = gt[(size_t)r * c + i];
    out[(size_t)r * c + i] = __fadd_rn(__fmul_rn(v, gv), gv);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int blocks_for(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > 65535 * 32 ? 65535 * 32 : b));
}

}  // namespace

// Group sums: scheme 0 shuffle, 1 smem, 2 mma. x is (rows, cols) with
// cols % cm == 0; out (rows, cols / cm).
extern "C" int mp_group_sum(const void* x, void* out, int rows, int cols,
                            int cm, int scheme, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cm < 4 || cm % 4 || cm > 128 || cols % cm || !aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (long long)rows * (cols / cm);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (scheme == 0) {
    const int gpw = 32 / (cm / 4);
    gsum_shuffle<<<blocks_for(groups, 8 * gpw), 256, 0, s>>>(xi, o, groups,
                                                             cm);
  } else if (scheme == 1) {
    int gpb = 8192 / cm;
    gpb = gpb > 256 ? 256 : gpb;
    const size_t smem = (size_t)gpb * (cm + 1) * sizeof(float);
    gsum_smem<<<blocks_for(groups, gpb), 256, smem, s>>>(xi, o, groups, cm,
                                                         gpb);
  } else if (scheme == 2) {
    const int tiles = ((rows + 15) / 16) * ((cols / cm + 7) / 8);
    gsum_mma<<<(tiles + 3) / 4, 128, 0, s>>>(xi, o, rows, cols, cm);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// C (R x N) = A (R x K) B; B(k, n) at b[k * sbk + n * sbn]. Scheme 0 mma,
// 1 ffma.
extern "C" int mp_matmul(const void* a, const void* b, void* c, int R, int K,
                         int N, long long sbk, long long sbn, int scheme,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* cp = static_cast<float*>(c);
  if (scheme == 0) {
    const long long tiles = (long long)((R + 15) / 16) * ((N + 7) / 8);
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    mm_mma<<<(unsigned)tiles, MM_WARPS * 32, 0, s>>>(ap, bp, cp, R, K, N, sbk,
                                                     sbn);
  } else if (scheme == 1) {
    const long long n = (long long)R * N;
    mm_ffma<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ap, bp, cp, R, K, N,
                                                        sbk, sbn);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mp_repeat(const void* a, void* out, int rows, int g, int cm,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || g < 1 || cm < 4 || cm % 4 || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)rows * g * cm / 4;
  repeat_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), rows, g, cm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mp_roll(const void* x, void* out, int rows, int w, int c,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)w * c * sizeof(float);
  if (rows < 1 || w < 1 || c < 1 || (w * c) % 4 || smem > 48 * 1024 ||
      !aligned16(x) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  roll_kernel<<<rows, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), w, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mp_narrow(const void* x, const void* g, void* out, int rows,
                         int c, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  narrow_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(out), rows, c);
  return static_cast<int>(cudaGetLastError());
}
