// Blocked right-looking Cholesky factorisation of one SPD matrix.
//
// Replaces rust_robotics_tpu/ops/cholesky_pallas.py::_chol_kernel (:110,
// entries cholesky_pallas :143 and cholesky_solve_pallas :169) and
// ::_chol_large_kernel (:200, entry cholesky_pallas_large :262): both
// compute the same function, and on this card the matrix lives in device
// memory at every n, so one set of kernels serves both. For a [n, n] SPD
// input a it writes the lower factor L [n, n] with the strict upper
// triangle exactly 0, as the JAX entries return it:
//   - the matrix is padded to m, a multiple of kB, with an identity
//     diagonal, so the padded matrix stays SPD (cholesky_pallas.py:152-157);
//   - each pivot p gives inv = 1 / sqrt(max(p, 1e-30)); the column (the
//     pivot included) is scaled by inv (cholesky_pallas.py:74-79). The BA
//     Schur matrix is nearly singular along any gauge the fixed cameras
//     leave free, and this clamp is what the JAX kernel does there.
//   - the caller's matrix is not written: the factorisation runs on a
//     padded copy in the scratch buffer the wrapper allocates.
// The TPU kernel's bf16x3 split products (_dot_hi) and its explicit
// triangular inverse (_tri_inverse) answer Mosaic's f32-dot precision and
// the MXU; here every product is an FP32 (or FP64) fused multiply-add
// written in the kernel, and the panel is a forward substitution.
//
// Design (simple first): for each block step k, two launches.
//   1. panel_kernel: every CTA loads the kB x kB diagonal block into shared
//      memory and factors it, one column per step with one barrier per
//      step (the same instructions on the same data, so every CTA holds the
//      same L_kk bit for bit); CTA 0 stores L_kk in the scratch area of
//      diagonal blocks; then each warp solves rows of the panel,
//      X * L_kk^T = A_ik, by forward substitution with lane l holding
//      columns l and l + 32.
//   2. update_kernel: A22 -= P * P^T on the lower 64 x 64 tiles only, one
//      CTA per tile, P's two row blocks staged through shared memory in
//      chunks of 32 columns, a 4 x 4 register tile of FMAs per thread.
// pad_kernel builds the padded copy first; out_kernel writes L last,
// taking diagonal blocks from the scratch area (the matrix's own diagonal
// blocks still hold their inputs: other CTAs of the same panel launch read
// them) and zeroing the strict upper triangle.
//
// Bound: at the BA's retained size (n = 1200) the n^3 / 3 operations take
// ~9 us at the FP32 peak and the 2 n^2 words ~3.4 us at the memory rate;
// this design is bound by neither but by its serial chain: n / kB steps,
// each a diagonal factor of kB dependent columns plus two launches.
//
// C interface (bound with ctypes): cholesky_f32 / cholesky_f64 launch on
// the given stream, do not synchronise, allocate nothing (the wrapper
// passes `work`, cholesky_work_elements(n) elements), and return the first
// non-zero cudaGetLastError() of their launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;  // block (panel) width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = kB + 1;  // shared-memory row stride
constexpr int kTile = 64;     // trailing-update output tile
constexpr int kChunk = 32;    // columns of P staged per pass
constexpr unsigned kFull = 0xffffffffu;
constexpr int kElementwiseBlocks = 1024;

static_assert(kB == 2 * 32, "the panel solve gives each lane two columns");
static_assert(kB % kChunk == 0 && kTile == kB, "tiles follow the block");

inline int padded(int n) { return (n + kB - 1) / kB * kB; }

// 1 / sqrt(max(p, 1e-30)), NaN passing through as in jnp.maximum
template <typename T>
__device__ __forceinline__ T clamped_rsqrt(T p) {
  const T floor_ = T(1e-30);
  return T(1) / sqrt(p < floor_ ? floor_ : p);
}

template <typename T>
__global__ void pad_kernel(const T* __restrict__ a, T* __restrict__ work, int n,
                           int m) {
  const int64_t total = static_cast<int64_t>(m) * m;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / m), j = static_cast<int>(idx % m);
    work[idx] = (i < n && j < n) ? a[static_cast<int64_t>(i) * n + j]
                                 : (i == j ? T(1) : T(0));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_kernel(T* __restrict__ work, T* __restrict__ diag_out, int m, int k0) {
  __shared__ T L[kB][kPad];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kB * kB; idx += kThreads) {
    const int i = idx / kB, c = idx % kB;
    L[i][c] = work[static_cast<int64_t>(k0 + i) * m + k0 + c];
  }
  __syncthreads();

  // Step j reads the pivot and column j and updates the strictly lower
  // part of columns > j; column j itself is scaled in step j + 1, when no
  // thread reads it any more. One barrier per step.
  T inv_prev = T(0);
  for (int j = 0; j < kB; ++j) {
    const T inv = clamped_rsqrt(L[j][j]);
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int i = idx / kB, c = idx % kB;
      if (c > j && i >= c) L[i][c] -= (L[i][j] * inv) * (L[c][j] * inv);
    }
    if (j > 0) {
      for (int i = j - 1 + tid; i < kB; i += kThreads) L[i][j - 1] *= inv_prev;
    }
    inv_prev = inv;
    __syncthreads();
  }
  if (tid == 0) L[kB - 1][kB - 1] *= inv_prev;
  __syncthreads();

  if (blockIdx.x == 0) {
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      diag_out[idx] = L[idx / kB][idx % kB];
    }
  }

  // panel rows: x * L^T = a, forward substitution, one row per warp at a time
  const int warp = tid / 32, lane = tid % 32;
  const int below = m - (k0 + kB);
  for (int r = blockIdx.x * kWarps + warp; r < below; r += gridDim.x * kWarps) {
    T* row = work + static_cast<int64_t>(k0 + kB + r) * m + k0;
    T x0 = row[lane], x1 = row[lane + 32];
    for (int j = 0; j < kB; ++j) {
      const T own = j < 32 ? x0 : x1;
      const T xj = __shfl_sync(kFull, own, j % 32) / L[j][j];
      if (lane == j % 32) {
        if (j < 32) {
          x0 = xj;
        } else {
          x1 = xj;
        }
      }
      if (lane > j) x0 -= xj * L[lane][j];
      if (lane + 32 > j) x1 -= xj * L[lane + 32][j];
    }
    row[lane] = x0;
    row[lane + 32] = x1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_kernel(T* __restrict__ work, int m, int k0) {
  // lower tile (ti, tj), tj <= ti, of the trailing matrix at h = k0 + kB
  const int t = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int h = k0 + kB;
  const int r0 = h + ti * kTile, c0 = h + tj * kTile;

  __shared__ T As[kChunk][kTile + 1];  // As[kk][r] = P[r0 + r][kc + kk]
  __shared__ T Bs[kChunk][kTile + 1];  // Bs[kk][c] = P[c0 + c][kc + kk]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  }
  for (int kc = 0; kc < kB; kc += kChunk) {
    for (int idx = tid; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk, kk = idx % kChunk;
      As[kk][r] = work[static_cast<int64_t>(r0 + r) * m + k0 + kc + kk];
      Bs[kk][r] = work[static_cast<int64_t>(c0 + r) * m + k0 + kc + kk];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty + 16 * i];
        bv[i] = Bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* out = work + static_cast<int64_t>(r0 + ty + 16 * i) * m + c0;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[tx + 16 * j] -= acc[i][j];
  }
}

template <typename T>
__global__ void out_kernel(const T* __restrict__ work, const T* __restrict__ diag,
                           T* __restrict__ out, int n, int m) {
  const int64_t total = static_cast<int64_t>(n) * n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / n), j = static_cast<int>(idx % n);
    T v = T(0);
    if (i >= j) {
      const int bi = i / kB;
      v = bi == j / kB ? diag[static_cast<int64_t>(bi) * kB * kB + (i % kB) * kB + j % kB]
                       : work[static_cast<int64_t>(i) * m + j];
    }
    out[idx] = v;
  }
}

int elementwise_grid(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kElementwiseBlocks ? blocks : kElementwiseBlocks);
}

template <typename T>
int factor(const void* a, void* work, void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int m = padded(n);
  T* w = static_cast<T*>(work);
  T* diag = w + static_cast<int64_t>(m) * m;  // m / kB blocks of kB x kB
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pad_kernel<T><<<elementwise_grid(static_cast<int64_t>(m) * m), kThreads, 0, s>>>(
      static_cast<const T*>(a), w, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k0 = 0; k0 < m; k0 += kB) {
    const int below = m - k0 - kB;
    const int panel_grid = below > 0 ? (below + kWarps - 1) / kWarps : 1;
    panel_kernel<T><<<panel_grid, kThreads, 0, s>>>(
        w, diag + static_cast<int64_t>(k0 / kB) * kB * kB, m, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = below / kTile;
    if (tiles > 0) {
      update_kernel<T><<<tiles * (tiles + 1) / 2, kThreads, 0, s>>>(w, m, k0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  out_kernel<T><<<elementwise_grid(static_cast<int64_t>(n) * n), kThreads, 0, s>>>(
      w, diag, static_cast<T*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cholesky_block_size() { return kB; }

extern "C" long long cholesky_work_elements(int n) {
  const long long m = padded(n);
  return m * m + m * kB;
}

extern "C" int cholesky_f32(const void* a, void* work, void* out, int n,
                            void* stream) {
  return factor<float>(a, work, out, n, stream);
}

extern "C" int cholesky_f64(const void* a, void* work, void* out, int n,
                            void* stream) {
  return factor<double>(a, work, out, n, stream);
}
