// Fused systematic resampling + particle gather for B independent filters.
//
// Replaces rust_robotics_tpu/ops/resample_pallas.py::_resample_kernel (:109,
// P <= 1024) and ::_resample_kernel_tiled (:164, P > 1024): one kernel
// computes the function at every P. For row b, with weights w [B, P],
// one stratified uniform u [B] and states [B, D, P]:
//   wn = w / sum(w); neff = 1 / sum(wn^2);
//   cum = inclusive prefix sum of wn; cum = cum / cum[P-1];
//   idx[i] = first j with cum[j] >= (i + u) / P, clipped to P-1;
//   out[c, i] = states[c, idx[i]] for c < D;
// the order of operations of resample_reference (resample_pallas.py:337-341).
// The Pallas kernels' [P, P] one-hot segment matrix, its index channels and
// its 512-wide tiles exist because Mosaic has no dynamic gather; here a
// binary search over the CDF in shared memory and a direct gather replace
// them.
//
// Design: one block of 256 threads per row. The row's weights (4 KB at
// P=1024, 16 KB at P=4096 in f32) are loaded once into shared memory; block
// reductions (warp shuffles, then the eight warp sums in a fixed order) give
// the total and the sum of squares; a block-wide inclusive scan in passes of
// 256 elements (warp shuffle scan plus per-warp carries, each pass starting
// from the last value of the one before) turns them into the CDF. Output
// slot i is owned by thread i mod 256, so idx and out writes coalesce along
// i; the gathered reads stay inside the row's D x P states.
//
// Bound: bytes. Each launch must read weights, u and states and write
// states, idx and neff once; the search adds log2(P) shared-memory reads per
// slot, far below the card's rate per byte.
//
// The block scan sums in another order than torch.cumsum, so an index may
// differ from the plain twin's by one where a position falls on a CDF
// boundary: the same caveat as the JAX kernel's MXU prefix sum
// (resample_pallas.py:40-46). The gathered states are always exactly the
// states at the kernel's own indices.
//
// C interface (bound with ctypes): resample_f32 / resample_f64 launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The sum of v over the block, the same value in every thread.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  __syncthreads();  // s_warp may still be read by a previous use
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  T total = s_warp[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) total += s_warp[i];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const T* __restrict__ weights, const T* __restrict__ u,
                const T* __restrict__ states, T* __restrict__ out_states,
                int32_t* __restrict__ idx_out, T* __restrict__ neff_out, int p,
                int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cum = reinterpret_cast<T*>(smem);
  __shared__ T s_warp[kWarps];
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // total weight
  const T* w = weights + row * p;
  T part = T(0);
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const T v = w[i];
    cum[i] = v;
    part += v;
  }
  const T total = block_sum(part, s_warp);

  // normalised weights and N_eff (each thread rewrites only its own slots)
  T sq = T(0);
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const T v = cum[i] / total;
    cum[i] = v;
    sq += v * v;
  }
  const T sumsq = block_sum(sq, s_warp);
  if (threadIdx.x == 0) neff_out[row] = T(1) / sumsq;

  // inclusive prefix sum, kThreads elements per pass
  T carry = T(0);
  for (int start = 0; start < p; start += kThreads) {
    const int i = start + threadIdx.x;
    T v = i < p ? cum[i] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T up = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += up;
    }
    __syncthreads();  // s_warp free again
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    T offset = carry;
    for (int j = 0; j < warp; ++j) offset += s_warp[j];
    if (i < p) cum[i] = offset + v;
    __syncthreads();
    const int last = (start + kThreads < p ? start + kThreads : p) - 1;
    carry = cum[last];
  }

  // cum /= cum[P-1]
  const T grand = cum[p - 1];
  __syncthreads();  // every thread has read cum[P-1] before it changes
  for (int i = threadIdx.x; i < p; i += kThreads) cum[i] = cum[i] / grand;
  __syncthreads();

  // stratified inverse-CDF draw and gather
  const T ub = u[row];
  const T pt = static_cast<T>(p);
  const T* src = states + row * d * p;
  T* dst = out_states + row * d * p;
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const T pos = (static_cast<T>(i) + ub) / pt;
    int lo = 0, hi = p;  // first j with cum[j] >= pos (searchsorted, left)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] < pos) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int j = lo < p ? lo : p - 1;
    idx_out[row * p + i] = j;
    for (int c = 0; c < d; ++c) dst[c * p + i] = src[c * p + j];
  }
}

template <typename T>
int launch(const void* weights, const void* u, const void* states,
           void* out_states, void* idx, void* neff, long long b, int p, int d,
           void* stream) {
  if (b <= 0 || b > 2147483647LL || p <= 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(p) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      resample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  resample_kernel<T><<<static_cast<unsigned int>(b), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(weights), static_cast<const T*>(u),
      static_cast<const T*>(states), static_cast<T*>(out_states),
      static_cast<int32_t*>(idx), static_cast<T*>(neff), p, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int resample_f32(const void* weights, const void* u,
                            const void* states, void* out_states, void* idx,
                            void* neff, long long b, int p, int d,
                            void* stream) {
  return launch<float>(weights, u, states, out_states, idx, neff, b, p, d,
                       stream);
}

extern "C" int resample_f64(const void* weights, const void* u,
                            const void* states, void* out_states, void* idx,
                            void* neff, long long b, int p, int d,
                            void* stream) {
  return launch<double>(weights, u, states, out_states, idx, neff, b, p, d,
                        stream);
}
