// Batched wavefront relaxation: K Jacobi min-plus sweeps of B cost fields.
//
// Replaces rust_robotics_tpu/ops/wavefront_pallas.py::_sweep_kernel (:39).
// A sweep sets every cell of a cost-to-go field d [B, W, H] (H fastest) to
//   min(d[x, y], min over allowed directions i of d[x+dx_i, y+dy_i] + c_i),
// reading only the field as it was before the sweep (Jacobi order). Bit i of
// bits[b, x, y] says whether the move from (x+dx_i, y+dy_i) into (x, y) is
// allowed; the directions are planning/wavefront.py's MOTIONS_8 order, and
// 4-connectivity uses the first four. A direction that is not allowed, or
// whose neighbour lies off the map, offers the sentinel `big`, as the JAX
// sweep's padded shift and mask do. The only arithmetic is one add and one
// min per direction, with no product to contract into an FMA, so the result
// is bitwise that of the plain-PyTorch twin and of the JAX path.
//
// Bound: operations, not bytes. A launch moves the field in and out and one
// byte of bits per cell, but does K sweeps x W*H cells x 8 directions of
// add/select/min on them.
//
// Two variants, one per C entry:
// - resident (the bench shape, 128x128): one block of 1024 threads per map.
//   The field and the bit plane sit in shared memory for all K sweeps; the
//   map's edges are folded into the bits once, as they are loaded, so a
//   sweep reads a neighbour at a fixed offset with no bounds check. Each
//   thread computes the new values of its <= 16 cells into registers,
//   __syncthreads(), writes them back, __syncthreads(). 128x128 in f32 is
//   80 KB of dynamic shared memory (144 KB in f64), above the 48 KB default,
//   so the entry raises the kernel's limit first. With one block per map,
//   bench.py's B=64 fills 64 of the 132 SMs: the first thing a later change
//   would address (for example a cluster of blocks per map).
// - tiled, for maps whose field and bit plane exceed one block's shared
//   memory: one sweep per launch, each block relaxing a 32x32 tile read with
//   its one-cell halo into shared memory, K launches ping-ponging between
//   the output and a scratch buffer so that the last sweep lands in the
//   output.
// Both end with a per-map flag: 1 iff some cell's final value is below its
// value at entry (the JAX while_loop's `any(new < d)`, per map).
//
// C interface (bound with ctypes): wavefront_{resident,tiled}_{f32,f64}
// launch on the given stream, do not synchronise, allocate nothing, and
// return the first CUDA error (cudaGetLastError() after each launch).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // resident: one block per map
constexpr int kPerThread = 16;  // resident: cells per thread, so W*H <= 16384
constexpr int kTile = 32;       // tiled: a block relaxes kTile x kTile cells
constexpr int kRows = 8;        // tiled: threads are kTile (along H) x kRows

// MOTIONS_8 of planning/wavefront.py: (dx, dy) of direction i.
__device__ __forceinline__ int dir_dx(int i) {
  return (i == 0 || i >= 6) ? 1 : (i == 1 || i == 3) ? 0 : -1;
}
__device__ __forceinline__ int dir_dy(int i) {
  return (i == 0 || i == 2) ? 0 : (i == 1 || i == 5 || i == 7) ? 1 : -1;
}

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_resident(const T* __restrict__ d_in, const uint8_t* __restrict__ bits_in,
               T* __restrict__ d_out, uint8_t* __restrict__ changed, int w,
               int h, int k, int ndirs, T straight, T diagonal, T big) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = w * h;
  T* s_d = reinterpret_cast<T*>(smem);
  uint8_t* s_b = smem + static_cast<size_t>(n) * sizeof(T);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;

  // The field, and the bits with the map's edges folded in once: a
  // direction past ndirs or whose neighbour is off the map is cleared, so
  // the sweeps below need neither coordinates nor bounds checks.
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_d[i] = d_in[base + i];
    const int x = i / h, y = i % h;
    unsigned mask = bits_in[base + i];
#pragma unroll
    for (int dir = 0; dir < 8; ++dir) {
      const int nx = x + dir_dx(dir), ny = y + dir_dy(dir);
      if (dir >= ndirs || nx < 0 || nx >= w || ny < 0 || ny >= h) {
        mask &= ~(1u << dir);
      }
    }
    s_b[i] = static_cast<uint8_t>(mask);
  }
  __syncthreads();

  T next[kPerThread];
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cell = threadIdx.x + j * kThreads;
      if (cell < n) {
        const unsigned mask = s_b[cell];
        T best = s_d[cell];
#pragma unroll
        for (int dir = 0; dir < 8; ++dir) {
          const T cand = ((mask >> dir) & 1u)
                             ? s_d[cell + dir_dx(dir) * h + dir_dy(dir)] +
                                   (dir < 4 ? straight : diagonal)
                             : big;
          best = min_of(best, cand);
        }
        next[j] = best;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cell = threadIdx.x + j * kThreads;
      if (cell < n) s_d[cell] = next[j];
    }
    __syncthreads();
  }

  int lower = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const T v = s_d[i];
    lower |= v < d_in[base + i];
    d_out[base + i] = v;
  }
  lower = __syncthreads_or(lower);
  if (threadIdx.x == 0) changed[blockIdx.x] = static_cast<uint8_t>(lower != 0);
}

template <typename T>
__global__ void __launch_bounds__(kTile* kRows)
sweep_tiled(const T* __restrict__ src, const uint8_t* __restrict__ bits,
            T* __restrict__ dst, const T* __restrict__ first,
            uint8_t* __restrict__ changed, int w, int h, int ndirs, T straight,
            T diagonal, T big) {
  __shared__ T tile[kTile + 2][kTile + 2];
  const int64_t base = static_cast<int64_t>(blockIdx.z) * w * h;
  const int x0 = blockIdx.y * kTile, y0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  // the tile and its one-cell halo; cells off the map hold the sentinel
  for (int i = tid; i < (kTile + 2) * (kTile + 2); i += kTile * kRows) {
    const int tx = i / (kTile + 2), ty = i % (kTile + 2);
    const int gx = x0 + tx - 1, gy = y0 + ty - 1;
    tile[tx][ty] = (gx >= 0 && gx < w && gy >= 0 && gy < h)
                       ? src[base + static_cast<int64_t>(gx) * h + gy]
                       : big;
  }
  __syncthreads();

  int lower = 0;
  for (int r = threadIdx.y; r < kTile; r += kRows) {
    const int x = x0 + r, y = y0 + threadIdx.x;
    if (x >= w || y >= h) continue;
    const int64_t at = base + static_cast<int64_t>(x) * h + y;
    const unsigned mask = bits[at];
    T best = tile[r + 1][threadIdx.x + 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < ndirs) {
        const T cand =
            ((mask >> i) & 1u)
                ? tile[r + 1 + dir_dx(i)][threadIdx.x + 1 + dir_dy(i)] +
                      (i < 4 ? straight : diagonal)
                : big;
        best = min_of(best, cand);
      }
    }
    dst[at] = best;
    if (first != nullptr) lower |= best < first[at];
  }
  if (first != nullptr) {
    lower = __syncthreads_or(lower);
    if (lower && tid == 0) changed[blockIdx.z] = 1;
  }
}

template <typename T>
int launch_resident(const void* d_in, const void* bits, void* d_out,
                    void* changed, int b, int w, int h, int k, int ndirs,
                    double straight, double diagonal, double big,
                    void* stream) {
  const int n = w * h;
  if (b <= 0 || w <= 0 || h <= 0 || k < 1 || n > kThreads * kPerThread ||
      (ndirs != 4 && ndirs != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * (sizeof(T) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_resident<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_resident<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d_in), static_cast<const uint8_t*>(bits),
      static_cast<T*>(d_out), static_cast<uint8_t*>(changed), w, h, k, ndirs,
      static_cast<T>(straight), static_cast<T>(diagonal), static_cast<T>(big));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiled(const void* d_in, const void* bits, void* d_out, void* changed,
                 void* scratch, int b, int w, int h, int k, int ndirs,
                 double straight, double diagonal, double big, void* stream) {
  if (b <= 0 || b > 65535 || w <= 0 || h <= 0 || k < 1 ||
      (ndirs != 4 && ndirs != 8) || (k > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kTile - 1) / kTile, (w + kTile - 1) / kTile, b);
  const dim3 block(kTile, kRows);
  const T* src = static_cast<const T*>(d_in);
  for (int sweep = 0; sweep < k; ++sweep) {
    // the last sweep writes d_out; the ones before alternate with scratch
    T* dst = ((k - 1 - sweep) % 2 == 0) ? static_cast<T*>(d_out)
                                        : static_cast<T*>(scratch);
    const T* first = sweep == k - 1 ? static_cast<const T*>(d_in) : nullptr;
    sweep_tiled<T><<<grid, block, 0, s>>>(
        src, static_cast<const uint8_t*>(bits), dst, first,
        static_cast<uint8_t*>(changed), w, h, ndirs, static_cast<T>(straight),
        static_cast<T>(diagonal), static_cast<T>(big));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

#define RESIDENT_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* d_in, const void* bits, void* d_out,        \
                      void* changed, void* /*scratch*/, int b, int w, int h,  \
                      int k, int ndirs, double straight, double diagonal,     \
                      double big, void* stream) {                             \
    return launch_resident<T>(d_in, bits, d_out, changed, b, w, h, k, ndirs, \
                              straight, diagonal, big, stream);               \
  }

#define TILED_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* d_in, const void* bits, void* d_out,        \
                      void* changed, void* scratch, int b, int w, int h,      \
                      int k, int ndirs, double straight, double diagonal,     \
                      double big, void* stream) {                             \
    return launch_tiled<T>(d_in, bits, d_out, changed, scratch, b, w, h, k,   \
                           ndirs, straight, diagonal, big, stream);           \
  }

RESIDENT_ENTRY(wavefront_resident_f32, float)
RESIDENT_ENTRY(wavefront_resident_f64, double)
TILED_ENTRY(wavefront_tiled_f32, float)
TILED_ENTRY(wavefront_tiled_f64, double)
