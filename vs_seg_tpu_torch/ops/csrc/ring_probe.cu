// ring_probe — the asynchronous shared-memory ring of ring.cuh on a toy
// pipeline, checked bit for bit against its plain twin.
//
// Replaces the Mosaic probe tools/ring_probe.py:_kernel, which stages each
// of d planes of (16, 128) f32 once into a 3-slot VMEM ring by DMA and
// writes plane p = 2 x[p] + 2 x[p + 1], the last plane masked to 2 x[d - 1].
// Here one block of 128 threads walks the planes. Thread 0 is the
// producer: plane q goes by one TMA box copy into slot q % 3 on that slot's
// `full` mbarrier, plane p + 2 while plane p is computed from slots p % 3
// and (p + 1) % 3, after the consumers released slot (p - 1) % 3 on its
// `empty` barrier; every slot is reused and two planes are in flight.
// Plane d (past the end) is a box wholly outside the tensor, zero-filled by
// the TMA, which is the mask. Bound: bytes (each plane read once, written
// once); the probe exists to prove the ring on the card, not for speed.

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int ROWS = 16, LANES = 128;
constexpr int PLANE = ROWS * LANES;        // floats per plane
constexpr int SLOTS = 3;
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

__global__ void __launch_bounds__(NTHREADS)
    ring_probe_kernel(const __grid_constant__ CUtensorMap map, float* out,
                      int d) {
  __shared__ __align__(128) float ring[SLOTS][PLANE];
  __shared__ __align__(8) uint64_t full[SLOTS], empty[SLOTS];
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // planes 0..d are loaded, plane d wholly outside the tensor
  auto load = [&](int q) {
    mbar_expect_tx(&full[q % SLOTS], PLANE * sizeof(float));
    tma_load_2d(ring[q % SLOTS], &map, &full[q % SLOTS], 0, q * ROWS);
  };
  if (threadIdx.x == 0) {
    load(0);
    load(1);
  }
  for (int p = 0; p < d; ++p) {
    if (threadIdx.x == 0 && p + 2 <= d) {
      // slot (p + 2) % 3 last held plane p - 1, released in iteration p - 1
      if (p >= 1) mbar_wait(&empty[(p - 1) % SLOTS], ((p - 1) / SLOTS) & 1);
      load(p + 2);
    }
    __syncwarp();
    mbar_wait(&full[p % SLOTS], (p / SLOTS) & 1);
    mbar_wait(&full[(p + 1) % SLOTS], ((p + 1) / SLOTS) & 1);
    const float* a = ring[p % SLOTS];
    const float* b = ring[(p + 1) % SLOTS];
    float* o = out + (size_t)p * PLANE;
    for (int i = threadIdx.x; i < PLANE; i += NTHREADS)
      o[i] = a[i] * 2.0f + b[i] * 2.0f;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[p % SLOTS]);
  }
  // the last planes' copies have all landed (waited above); nothing is left
  // in flight when the block exits
}

}  // namespace

extern "C" int ring_probe_launch(const void* x, void* out, int d, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const uint64_t dims[2] = {LANES, (uint64_t)d * ROWS};
  const uint64_t strides[1] = {LANES * sizeof(float)};
  const uint32_t box[2] = {LANES, ROWS};
  err = encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims,
                     strides, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_probe_kernel<<<1, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}
