// Blocked right-looking Cholesky factorisation of one SPD matrix.
//
// Replaces rust_robotics_tpu/ops/cholesky_pallas.py::_chol_kernel (:110,
// entries cholesky_pallas :143 and cholesky_solve_pallas :169) and
// ::_chol_large_kernel (:200, entry cholesky_pallas_large :262): both
// compute the same function, and on this card the matrix lives in device
// memory at every n, so one kernel serves both. For a [n, n] SPD input a it
// writes the lower factor L [n, n] with the strict upper triangle exactly
// 0, as the JAX entries return it:
//   - the matrix is padded to m, a multiple of kB, with an identity
//     diagonal, so the padded matrix stays SPD (cholesky_pallas.py:152-157);
//   - each pivot p gives inv = 1 / sqrt(max(p, 1e-30)); the column (the
//     pivot included) is scaled by inv (cholesky_pallas.py:74-79), NaN
//     passing through. The BA Schur matrix is nearly singular along any
//     gauge the fixed cameras leave free, and this clamp is what the JAX
//     kernel does there.
//   - the caller's matrix is not written: the factorisation runs on a
//     padded copy in the scratch buffer the wrapper allocates.
// The TPU kernel's bf16x3 split products (_dot_hi) and its explicit
// triangular inverse (_tri_inverse) answer Mosaic's f32-dot precision and
// the MXU; here every product is an FP32 (or FP64) fused multiply-add
// written in the kernel, and the panel is a forward substitution, the
// backward-stable choice for the nearly singular Schur matrix.
//
// Design: one persistent cooperative launch per factorisation, its phases
// separated by grid-wide barriers (cooperative_groups' grid.sync()). No
// pass builds the padded copy: step 0 reads its operands from a (identity
// on the padding) and writes every lower entry of the copy; the zeros of
// L's strict upper triangle are written while CTA 0 factors the first
// diagonal block. Per block step k:
//   factor   ONE CTA factors the kB x kB diagonal block, in column strips:
//            one warp factors a strip's diagonal sub-block with its rows in
//            registers and the columns passed by shuffles (no barrier on
//            the serial chain of pivots), then the CTA solves the strip's
//            rows below and applies its rank-kSub update (factor_diag). It
//            writes L_kk back over the block, the reciprocals 1 / L_jj
//            beside it, and L_kk's rows into the output;
//   panel    X * L_kk^T = A_ik by forward substitution over all CTAs, each
//            warp kRows rows at once (lane l holds columns l and l + 32),
//            multiplying by the stored reciprocals; rows go to the output
//            as they finish;
//   update   A22 -= P * P^T on the lower 64 x 64 tiles, FP32/FP64 FMAs with
//            P's row blocks staged through shared memory and a 4 x 4
//            register tile per thread, CTAs striding over the tiles.
// Look-ahead: during step k's update, CTA 0 updates tile (0, 0) of the
// trailing matrix -- the next diagonal block -- into shared memory and
// factors it at once, while the other CTAs update the remaining tiles; so
// each block step costs two grid barriers (after the panel and after the
// update) instead of three.
//
// Bound: at the BA's retained size (n = 1200) the n^3 / 3 operations take
// ~9 us at the FP32 peak and the 2 n^2 words ~3.4 us at the memory rate;
// this design is bound by neither but by its serial chain: n / kB steps,
// each a diagonal factor of kB dependent columns, a row substitution of kB
// dependent steps and two grid barriers. At n = 1200 the padded f32 copy
// (5.9 MB) stays in the 50 MB L2 between phases. Registers: one CTA of 256
// threads per SM (the strip factor and the 4 x 4 tiles take ~250), so the
// grid is at most the SM count.
//
// C interface (bound with ctypes): cholesky_f32 / cholesky_f64 launch on
// the given stream, do not synchronise, allocate nothing (the wrapper
// passes `work`, cholesky_work_elements(n) elements), and return the
// cudaError_t of the launch: the grid is sized from the occupancy API so
// that every CTA is resident, and a grid that could not be is refused by
// cudaLaunchCooperativeKernel with an error, never run. cholesky_*_traced
// take a buffer of cholesky_stamp_count(n) int64 slots, which CTA 0 fills
// with %globaltimer readings (ns) at the
// phase boundaries: start, end of the first diagonal factor, after the
// barrier that follows it, then per block step with a panel: L_kk staged
// for the panel, CTA 0's panel rows done, after the panel's barrier, factor
// start, factor end, after the step's last barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 64;  // block (panel) width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = kB + 1;  // shared-memory row stride
constexpr int kTile = 64;     // trailing-update output tile
constexpr int kChunk = 32;    // columns of P staged per pass
constexpr int kRows = 2;      // panel rows a warp solves at once
constexpr int kStaged = kTile * kChunk / kThreads;  // per thread, per operand
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kStampsPerStep = 6;

static_assert(kB == 2 * 32, "the panel solve gives each lane two columns");
static_assert(kB % kChunk == 0 && kTile == kB, "tiles follow the block");
static_assert(kThreads >= kB, "the diagonal factor takes a thread per row");

__host__ __device__ inline int padded(int n) { return (n + kB - 1) / kB * kB; }

// 1 / sqrt(max(p, 1e-30)), NaN passing through as in jnp.maximum. It sits
// on the diagonal factor's serial chain, once per column: the hardware
// reciprocal square root (within 2 ulp in f32, 1 ulp in f64) takes a
// fraction of the IEEE square root and division.
template <typename T>
__device__ __forceinline__ T clamped_rsqrt(T p) {
  const T floor_ = T(1e-30);
  return rsqrt(p < floor_ ? floor_ : p);
}

// Strip width of the diagonal factor: a lane's row of the strip's diagonal
// sub-block in registers. f64 takes half the width: half the registers and
// shuffles per column, for twice as many rank-kSub updates.
template <typename T>
struct Strip {
  static constexpr int kWidth = sizeof(T) == 4 ? 32 : 16;
  static_assert(kB % kWidth == 0 && kWidth <= 32, "one warp factors a strip");
};

// Shared memory, reused by every phase: the diagonal block (factor and
// panel) or P's two staged row blocks (update).
template <typename T>
struct Tiles {
  T As[kChunk][kTile + 1];  // As[kk][r] = P[r0 + r][kc + kk]
  T Bs[kChunk][kTile + 1];  // Bs[kk][c] = P[c0 + c][kc + kk]
};

template <typename T>
union Staging {
  T block[kB][kPad];
  Tiles<T> tiles;
};

template <typename T>
struct Shared {
  Staging<T> u;
  T col[kB];  // the block's pivot rsqrts (factor), its 1 / L_jj (panel)
};

struct Stamps {
  long long* at;  // null: not traced
  __device__ __forceinline__ void mark(int slot) const {
    if (at != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      at[slot] = t;
    }
  }
};

// The padded matrix at (i, j) read from the caller's a: identity on the
// padding. Step 0 reads its operands here, so no pass builds the copy.
template <typename T>
__device__ __forceinline__ T padded_at(const T* __restrict__ a, int n, int i, int j) {
  return (i < n && j < n) ? a[static_cast<int64_t>(i) * n + j] : (i == j ? T(1) : T(0));
}

// Lower factor of the diagonal block at (k0, k0), by one CTA. The block
// comes from sh.u.block (`in_shared`, as the look-ahead leaves it), else
// from a (k0 = 0) or the copy. It is factored in column strips of kSub:
//   - warp 0 factors the strip's kSub x kSub diagonal sub-block, lane i
//     holding row i in registers and every column passing by shuffles, so
//     the serial chain of a column is one shuffle, the rsqrt and three
//     FMAs, with no barrier;
//   - the rows below it in the block: L_ij = (a_ij - sum_k<j L_ik L_jk) *
//     inv_j, one thread per row (inv_j the pivot's clamped rsqrt, as the
//     column algorithm scales, so a clamped pivot gives what the twin does);
//   - the rest of the block takes the strip's rank-kSub update.
// Writes L_kk over the block's lower triangle in `work`, 1 / L_jj into
// rinv[k0 + j] for the panel, and L_kk's rows (zero above the diagonal)
// into `out` where inside n.
template <typename T>
__device__ __forceinline__ void factor_diag(Shared<T>& sh, const T* __restrict__ a,
                                            T* __restrict__ work, T* __restrict__ rinv,
                                            T* __restrict__ out, int n, int m, int k0,
                                            bool in_shared) {
  constexpr int kSub = Strip<T>::kWidth;
  const int tid = threadIdx.x;
  if (!in_shared) {
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int i = idx / kB, c = idx % kB;
      if (c <= i) {
        sh.u.block[i][c] = k0 == 0 ? padded_at(a, n, i, c)
                                   : work[static_cast<int64_t>(k0 + i) * m + k0 + c];
      }
    }
    __syncthreads();
  }
  T* inv_of = sh.col;  // inv_j of each pivot of the block
  for (int o = 0; o < kB; o += kSub) {
    if (tid < 32) {
      // Step j: a_ic -= (L_ij * inv) * a_cj for c > j, a_cj from lane c;
      // only c <= i is ever read again
      const int i = tid;
      T row[kSub];
#pragma unroll
      for (int c = 0; c < kSub; ++c) row[c] = i < kSub && c <= i ? sh.u.block[o + i][o + c] : T(0);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const T a_j = row[j];
        const T inv = clamped_rsqrt(__shfl_sync(kFull, a_j, j));
        const T l = a_j * inv;
        row[j] = l;
        const T t = l * inv;
#pragma unroll
        for (int c = j + 1; c < kSub; ++c) row[c] = fma(-t, __shfl_sync(kFull, a_j, c), row[c]);
        if (i == j) inv_of[o + j] = inv;
      }
      if (i < kSub) {
#pragma unroll
        for (int c = 0; c < kSub; ++c) {
          if (c <= i) sh.u.block[o + i][o + c] = row[c];
        }
      }
    }
    __syncthreads();
    const int lo = o + kSub;  // the rows and columns after the strip
    if (lo < kB) {
      for (int r = lo + tid; r < kB; r += kThreads) {
        T x[kSub];
#pragma unroll
        for (int c = 0; c < kSub; ++c) x[c] = sh.u.block[r][o + c];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          x[j] *= inv_of[o + j];
#pragma unroll
          for (int c = j + 1; c < kSub; ++c) x[c] = fma(-x[j], sh.u.block[o + c][o + j], x[c]);
        }
#pragma unroll
        for (int c = 0; c < kSub; ++c) sh.u.block[r][o + c] = x[c];
      }
      __syncthreads();
      const int w = kB - lo;
      for (int idx = tid; idx < w * w; idx += kThreads) {
        const int r = lo + idx / w, c = lo + idx % w;
        if (c <= r) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < kSub; ++k) acc = fma(sh.u.block[r][o + k], sh.u.block[c][o + k], acc);
          sh.u.block[r][c] -= acc;
        }
      }
      __syncthreads();
    }
  }
  if (tid < kB) rinv[k0 + tid] = T(1) / sh.u.block[tid][tid];
  for (int idx = tid; idx < kB * kB; idx += kThreads) {
    const int i = idx / kB, c = idx % kB;
    const T v = c <= i ? sh.u.block[i][c] : T(0);
    if (c <= i) work[static_cast<int64_t>(k0 + i) * m + k0 + c] = v;
    if (k0 + i < n && k0 + c < n) out[static_cast<int64_t>(k0 + i) * n + k0 + c] = v;
  }
  __syncthreads();
}

// Panel rows below the diagonal block at k0: x * L_kk^T = a by forward
// substitution over the whole grid, each warp solving kRows rows at once
// (independent chains of shuffles and FMAs); the rows of step 0 come from
// a. Stamps: L_kk staged, then CTA 0's rows done.
template <typename T>
__device__ __forceinline__ void panel(Shared<T>& sh, const T* __restrict__ a,
                                      T* __restrict__ work, const T* __restrict__ rinv,
                                      T* __restrict__ out, int n, int m, int k0,
                                      const Stamps& st, int slot) {
  const int below = m - (k0 + kB);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  if (static_cast<int>(blockIdx.x) * kWarps >= below) return;
  // the first rows' loads go out before L_kk is staged
  T x0[kRows], x1[kRows];
  auto load = [&](int base) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int gi = k0 + kB + base + q * stride;
      x0[q] = x1[q] = T(0);
      if (base + q * stride < below) {
        x0[q] = k0 == 0 ? padded_at(a, n, gi, lane) : work[static_cast<int64_t>(gi) * m + k0 + lane];
        x1[q] = k0 == 0 ? padded_at(a, n, gi, lane + 32)
                        : work[static_cast<int64_t>(gi) * m + k0 + lane + 32];
      }
    }
  };
  load(first);
  for (int idx = tid; idx < kB * kB; idx += kThreads) {
    const int i = idx / kB, c = idx % kB;
    if (c <= i) sh.u.block[i][c] = work[static_cast<int64_t>(k0 + i) * m + k0 + c];
  }
  if (tid < kB) sh.col[tid] = rinv[k0 + tid];
  __syncthreads();
  st.mark(slot);
  for (int base = first; base < below; base += kRows * stride) {
    if (base != first) load(base);
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const T r = sh.col[j];
      const T l0 = sh.u.block[lane][j], l1 = sh.u.block[lane + 32][j];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const T own = j < 32 ? x0[q] : x1[q];
        const T xj = __shfl_sync(kFull, own, j % 32) * r;
        if (lane == j % 32) {
          if (j < 32) {
            x0[q] = xj;
          } else {
            x1[q] = xj;
          }
        }
        if (lane > j) x0[q] = fma(-xj, l0, x0[q]);
        if (lane + 32 > j) x1[q] = fma(-xj, l1, x1[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = base + q * stride;
      if (r >= below) break;
      const int gi = k0 + kB + r;
      T* row = work + static_cast<int64_t>(gi) * m + k0;
      row[lane] = x0[q];
      row[lane + 32] = x1[q];
      if (gi < n) {
        T* dst = out + static_cast<int64_t>(gi) * n + k0;
        if (k0 + lane < n) dst[lane] = x0[q];
        if (k0 + lane + 32 < n) dst[lane + 32] = x1[q];
      }
    }
  }
  st.mark(slot + 1);
  __syncthreads();
}

// Lower tile t (row-major over the lower triangle of tiles) of the
// trailing matrix at h = k0 + kB: A -= P_i * P_j^T. A comes from a at step
// 0 and from the copy after; the result goes to the copy, or (`to_shared`)
// into sh.u.block for the diagonal factor that follows.
template <typename T>
__device__ __forceinline__ void update_tile(Shared<T>& sh, const T* __restrict__ a,
                                            T* __restrict__ work, int n, int m, int k0, int t,
                                            bool to_shared) {
  int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int h = k0 + kB;
  const int r0 = h + ti * kTile, c0 = h + tj * kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  T acc[4][4];
  T cur[4][4];  // loaded first, so that its latency hides behind the products
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      cur[i][j] = k0 == 0 ? padded_at(a, n, r, c) : work[static_cast<int64_t>(r) * m + c];
      acc[i][j] = T(0);
    }
  }
  // P's chunks pass through registers: the next chunk's loads are in
  // flight while the current one is multiplied
  T pa[kStaged], pb[kStaged];
  auto fetch = [&](int kc) {
#pragma unroll
    for (int s = 0; s < kStaged; ++s) {
      const int idx = tid + s * kThreads, r = idx / kChunk, kk = idx % kChunk;
      pa[s] = work[static_cast<int64_t>(r0 + r) * m + k0 + kc + kk];
      pb[s] = work[static_cast<int64_t>(c0 + r) * m + k0 + kc + kk];
    }
  };
  fetch(0);
  for (int kc = 0; kc < kB; kc += kChunk) {
#pragma unroll
    for (int s = 0; s < kStaged; ++s) {
      const int idx = tid + s * kThreads, r = idx / kChunk, kk = idx % kChunk;
      sh.u.tiles.As[kk][r] = pa[s];
      sh.u.tiles.Bs[kk][r] = pb[s];
    }
    __syncthreads();
    if (kc + kChunk < kB) fetch(kc + kChunk);
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sh.u.tiles.As[kk][ty + 16 * i];
        bv[i] = sh.u.tiles.Bs[kk][tx + 16 * i];
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (to_shared) {
        sh.u.block[r][c] = cur[i][j] - acc[i][j];
      } else {
        work[static_cast<int64_t>(r0 + r) * m + c0 + c] = cur[i][j] - acc[i][j];
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_persistent(const T* __restrict__ a, T* __restrict__ work, T* __restrict__ out, int n,
                long long* stamps) {
  __shared__ Shared<T> sh;
  cg::grid_group grid = cg::this_grid();
  const Stamps st{stamps};
  const int m = padded(n);
  T* rinv = work + static_cast<int64_t>(m) * m;
  const int tid = threadIdx.x;
  st.mark(0);

  // CTA 0 factors the first diagonal block (from a); meanwhile the others
  // write the zeros of L's strict upper triangle
  if (blockIdx.x == 0) {
    if (gridDim.x == 1) {
      for (int i = 0; i < n; ++i) {
        for (int j = i + 1 + tid; j < n; j += kThreads) out[static_cast<int64_t>(i) * n + j] = T(0);
      }
    }
    factor_diag(sh, a, work, rinv, out, n, m, 0, false);
  } else {
    for (int i = blockIdx.x - 1; i < n; i += gridDim.x - 1) {
      T* orow = out + static_cast<int64_t>(i) * n;
#pragma unroll 4
      for (int j = i + 1 + tid; j < n; j += kThreads) orow[j] = T(0);
    }
  }
  st.mark(1);
  grid.sync();
  st.mark(2);

  int slot = 3;
  for (int k0 = 0; k0 + kB < m; k0 += kB, slot += kStampsPerStep) {
    panel(sh, a, work, rinv, out, n, m, k0, st, slot);
    grid.sync();
    st.mark(slot + 2);
    const int nt = (m - k0 - kB) / kTile;
    const int tiles = nt * (nt + 1) / 2;
    // CTA 0: the next diagonal block, updated into shared memory and
    // factored at once; the others: every other tile
    if (blockIdx.x == 0) {
      update_tile(sh, a, work, n, m, k0, 0, true);
      st.mark(slot + 3);
      factor_diag(sh, a, work, rinv, out, n, m, k0 + kB, true);
      st.mark(slot + 4);
      if (gridDim.x == 1) {
        for (int t = 1; t < tiles; ++t) update_tile(sh, a, work, n, m, k0, t, false);
      }
    } else {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x - 1) {
        update_tile(sh, a, work, n, m, k0, t, false);
      }
    }
    grid.sync();
    st.mark(slot + 5);
  }
}

// CTAs per SM for each kernel and device, from the occupancy API
template <typename T>
int resident_per_sm(int device, int* sms) {
  static int cached_blocks[kMaxDevices];
  static int cached_sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  if (cached_blocks[device] == 0) {
    int blocks = 0, count = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, chol_persistent<T>, kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cached_sms[device] = count;
    cached_blocks[device] = blocks;
  }
  *sms = cached_sms[device];
  return cached_blocks[device];
}

template <typename T>
int factor(const void* a, void* work, void* out, int n, void* stream, long long* stamps) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  const int per_sm = resident_per_sm<T>(device, &sms);
  if (per_sm < 0) return -per_sm;
  // a grid no CTA of which fits cannot run: refuse it
  if (per_sm == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // as many CTAs as the first block step has tiles (CTA 0 takes the
  // diagonal one), or panel rows in warps, and no more than are resident
  const int m = padded(n);
  const int nt = (m - kB) / kTile;
  int useful = nt * (nt + 1) / 2;
  const int panel_ctas = (m - kB + kWarps - 1) / kWarps;
  if (panel_ctas > useful) useful = panel_ctas;
  if (useful < 1) useful = 1;
  const int resident = per_sm * sms;
  const int grid = useful < resident ? useful : resident;

  const T* a_ = static_cast<const T*>(a);
  T* w_ = static_cast<T*>(work);
  T* o_ = static_cast<T*>(out);
  void* args[] = {&a_, &w_, &o_, &n, &stamps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(chol_persistent<T>),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cholesky_block_size() { return kB; }

extern "C" long long cholesky_work_elements(int n) {
  const long long m = padded(n);
  return m * m + m;  // the padded copy, then the reciprocal diagonal
}

extern "C" int cholesky_stamp_count(int n) {
  return 3 + kStampsPerStep * (padded(n) / kB - 1);
}

extern "C" const char* cholesky_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

extern "C" int cholesky_f32(const void* a, void* work, void* out, int n, void* stream) {
  return factor<float>(a, work, out, n, stream, nullptr);
}

extern "C" int cholesky_f64(const void* a, void* work, void* out, int n, void* stream) {
  return factor<double>(a, work, out, n, stream, nullptr);
}

extern "C" int cholesky_f32_traced(const void* a, void* work, void* out, int n, void* stream,
                                   long long* stamps) {
  return factor<float>(a, work, out, n, stream, stamps);
}

extern "C" int cholesky_f64_traced(const void* a, void* work, void* out, int n, void* stream,
                                   long long* stamps) {
  return factor<double>(a, work, out, n, stream, stamps);
}
