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
// its 512-wide tiles exist because Mosaic has no dynamic gather; here marks
// and a running maximum in shared memory and a direct gather replace them.
//
// Bound: bytes. A launch must read the weights, u and the states and write
// the states, idx and neff once: 40 B a particle at D=4 in f32, 80 % of it
// the states. The arithmetic (a few divisions and adds a particle) is far
// below the card's rate per byte, so the design is about keeping the bytes
// moving and each block's chain of dependent steps short:
//
// - Staging. One block per row. Thread 0 starts the row's loads at once:
//   the weights and the D state channels go to shared memory by TMA bulk
//   copies (cp.async.bulk), each counted on its own mbarrier. The scan waits
//   for the weights only, so the states (80 % of the bytes) are in flight
//   while the CDF and the indices are built, not after them; the gather
//   then reads them from shared memory.
// - Branches, chosen by ops/resample.py::_launch_plan and passed in `mode`:
//   kStaged when a row's bytes (P·sizeof(T)) and both input pointers are
//   16-byte aligned, as bulk copies need; kCopied otherwise (P = 1001 f32,
//   P = 257 f32, an offset view): the same staging by 4- or 8-byte
//   cp.async, which also lets the states land during the scan; kDirect when
//   weights, marks and states exceed a block's 227 KB (f64 at D=8, P=4096
//   needs 304 KB): the weights go to shared memory by cp.async, the marks
//   live in the row's idx output and the gather reads the states from
//   global memory.
// - A register scan. Thread t owns the contiguous run [t·run, t·run + run)
//   of the row (run = 4 at P <= 2048, 8 at P = 4096: the plan keeps a block
//   at <= 512 threads, so that two rows of 96 KB share an SM at P = 4096).
//   It reads its run as 16-byte vectors from shared memory and keeps the
//   run's sum and inclusive scan in registers; one warp shuffle scan of the
//   run sums and one pass over the <= 16 warp totals (read in a fixed order
//   by every thread) finish it, with one barrier whatever P is. The scan
//   runs over the raw weights and cum[j] = scan[j] / total, the total being
//   the sum of the warp totals: the twin's wn = w / total, cumsum, then
//   cum / cum[P-1] up to rounding, with a barrier and a pass fewer than
//   finding the total first. N_eff sums (w / total)^2, as the twin does.
// - Marks, not a search. Slot i goes to the first j with cum[j] >= pos_i,
//   so idx[i] is one more than the largest j whose b[j], the first slot
//   with a position above cum[j], is <= i. Each thread computes b[j] for its
//   own particles from the estimate cum[j]·P − u, settled by the positions
//   of its two neighbours in the twin's arithmetic (independent of each
//   other and of the other particles), and marks slot b[j] with j + 1 by a
//   shared-memory atomicMax (zero-weight particles share a slot). A running
//   maximum over the marks (the run's own, a warp shuffle max-scan, the
//   warps before) gives every idx. A binary search for each run's first
//   slot and a forward gallop for the rest were the longest step of a
//   block's dependent path at P = 1024 (clock64 stamps on an H100); the
//   marks put no chain of dependent loads there. Where the CDF never falls
//   the result is exactly the
//   first-crossing index; where the scan's rounding lets it fall by an ulp
//   (zero weights between two threads' runs), it is still an index at
//   which the CDF crosses the position.
// - Stores. A thread writes its run of idx as 16-byte vectors (4 or 2
//   indices a store) where rows are 16-byte aligned, and over its marks.
//   The gather then goes slot by slot across the block: thread t takes
//   slots t, t + threads, ..., so neighbouring threads read neighbouring
//   parents from shared memory and a warp's store is 128 contiguous bytes.
//   Gathering each thread's own run put 4 (run 4) or 8 (run 8) threads of a
//   warp on one bank, and the gather and stores were then a block's longest
//   step at P = 4096 (clock64 stamps on an H100).
// - The launch bound is (1024, 1), which caps registers at 64 as (512, 2)
//   does: with (512, 2) the f32 kernel ran slower at B=8192, P=1024 and at
//   B=2048, P=4096 with the same register counts (a sweep of launch bounds
//   and of blocks per SM on an H100; capping blocks per SM at 3, 4 or 6
//   changed nothing).
//
// The scan sums in another order than torch.cumsum, so an index may differ
// from the plain twin's where a position falls on a CDF boundary: the same
// caveat as the JAX kernel's MXU prefix sum (resample_pallas.py:40-46). The
// gathered states are always exactly the states at the kernel's own indices.
//
// C interface (bound with ctypes): resample_f32 / resample_f64 take the
// launch plan (threads, run, mode, shared bytes, vector stores) and the
// device's index, launch on the given stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() of the launch. The shared-memory
// attribute is set once for each kernel, device and larger size.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;  // the launch bound; the plan launches <= 512
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 8;  // run elements a thread holds in registers at once
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Mode : int { kStaged = 0, kCopied = 1, kDirect = 2 };

// 16-byte loads of T and stores of the int32 indices beside them
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* s, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void store_idx(int32_t* s, const int* v) {
    *reinterpret_cast<int4*>(s) = make_int4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<double> {
  static constexpr int n = 2;
  __device__ static void load(const double* s, double* v) {
    const double2 x = *reinterpret_cast<const double2*>(s);
    v[0] = x.x, v[1] = x.y;
  }
  __device__ static void store_idx(int32_t* s, const int* v) {
    *reinterpret_cast<int2*>(s) = make_int2(v[0], v[1]);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1u)
               : "memory");
}

// thread 0: expect `bytes` on `bar`, then one bulk copy global -> shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_addr(dst)), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// v[0..n) = s[0..n), n <= kChunk; s is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_chunk(const T* s, int n, T* v) {
  constexpr int V = Vec<T>::n;
#pragma unroll
  for (int c = 0; c < kChunk; c += V) {
    if (c + V <= n) {
      Vec<T>::load(s + c, v + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (c + e < n) v[c + e] = s[c + e];
      }
    }
  }
}

// marks[k..k+n) = 0, n <= kChunk; 16-byte stores where `vec`
__device__ __forceinline__ void zero_chunk(int32_t* m, int n, bool vec) {
#pragma unroll
  for (int c = 0; c < kChunk; c += 4) {
    if (vec && c + 4 <= n) {
      *reinterpret_cast<int4*>(m + c) = make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < n) m[c + e] = 0;
      }
    }
  }
}

// m[0..n) = marks[0..n), n <= kChunk; 16-byte loads where `vec`. Marks in
// global memory (GLOBAL) are read past L1: the atomics that wrote them did.
template <bool GLOBAL>
__device__ __forceinline__ void load_marks(const int32_t* marks, int n, bool vec, int* m) {
#pragma unroll
  for (int c = 0; c < kChunk; c += 4) {
    if (vec && c + 4 <= n) {
      const int4* at = reinterpret_cast<const int4*>(marks + c);
      const int4 x = GLOBAL ? __ldcg(at) : *at;
      m[c] = x.x, m[c + 1] = x.y, m[c + 2] = x.z, m[c + 3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[c + e] = c + e < n ? (GLOBAL ? __ldcg(marks + c + e) : marks[c + e]) : 0;
      }
    }
  }
}

// The first output slot i in [0, p] whose position fl(fl(i + u) / p), the
// twin's arithmetic, lies above c. The estimate floor(c·p − u) + 1 is off by
// at most one slot: the roundings of c·p, of − u, of i + u and of the
// division move it by < 0.01 slot for p < 2^16 in f32. So the positions of
// its two neighbours settle it, branch-free.
template <typename T>
__device__ __forceinline__ T position(int i, T ub, T pt, T inv_p, bool pow2) {
  const T a = static_cast<T>(i) + ub;
  return pow2 ? a * inv_p : a / pt;  // equal where P is a power of two
}

template <typename T>
__device__ __forceinline__ int first_slot_above(T c, T ub, T pt, T inv_p, bool pow2, int p) {
  const T x = c * pt - ub;
  const int i = x < T(0) ? 0 : (x >= pt ? p : static_cast<int>(x) + 1);
  const T below = position(max(i - 1, 0), ub, pt, inv_p, pow2);
  const T at = position(min(i, p - 1), ub, pt, inv_p, pow2);
  return i - (i > 0 && below > c) + (i < p && !(at > c));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 1)
resample_kernel(const T* __restrict__ weights, const T* __restrict__ u,
                const T* __restrict__ states, T* __restrict__ out_states,
                int32_t* __restrict__ idx_out, T* __restrict__ neff_out, int p, int d, int run,
                int vec) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];  // weights, states (kStaged)
  __shared__ T s_scan[kMaxWarps], s_sq[kMaxWarps];
  __shared__ int s_max[kMaxWarps];
  // [weights | marks (kStaged, kCopied) | states (kStaged, kCopied)]
  const size_t weight_bytes = (static_cast<size_t>(p) * sizeof(T) + 15) & ~size_t(15);
  const size_t mark_bytes = (static_cast<size_t>(p) * 4 + 15) & ~size_t(15);
  T* s_weights = reinterpret_cast<T*>(smem);
  T* s_states = reinterpret_cast<T*>(smem + weight_bytes + mark_bytes);

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const T* w = weights + row * p;
  const T* src = states + row * d * p;
  T* dst = out_states + row * d * p;
  int32_t* idx_row = idx_out + row * p;
  // kDirect: the row's idx output holds the marks
  int32_t* marks = MODE == kDirect ? idx_row : reinterpret_cast<int32_t*>(smem + weight_bytes);
  const bool marks_vec = MODE != kDirect || (vec && p % 4 == 0);
  const T ub = __ldg(u + row);

  // 1. start the row's loads; wait for the weights only
  if (MODE == kStaged) {
    if (tid == 0) {
      mbar_init(&bars[0]);
      mbar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      bulk_load(s_weights, w, static_cast<uint32_t>(p * sizeof(T)), &bars[0]);
      if (d > 0) bulk_load(s_states, src, static_cast<uint32_t>(d * p * sizeof(T)), &bars[1]);
    }
    __syncthreads();  // the barriers are initialised
    mbar_wait(&bars[0]);
  } else {
    for (int i = tid; i < p; i += blockDim.x) cp_async(s_weights + i, w + i);
    cp_async_commit();
    if (MODE == kCopied) {
      for (int i = tid; i < d * p; i += blockDim.x) cp_async(s_states + i, src + i);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's weights
    __syncthreads();     // everyone's
  }

  // 2. one pass over the run: its sum, its marks zeroed; an inclusive scan
  // of the run sums across the warp; the warp totals
  const int begin = min(tid * run, p), end = min(begin + run, p);
  T run_sum = T(0);
  for (int k = begin; k < end; k += kChunk) {
    const int n = min(kChunk, end - k);
    T v[kChunk];
    load_chunk(s_weights + k, n, v);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      if (e < n) run_sum += v[e];
    }
    zero_chunk(marks + k, n, marks_vec);
  }
  T incl = run_sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();  // A
  T warp_off = T(0), total = T(0);  // the warp totals in order
  for (int i = 0; i < warps; ++i) {
    if (i == warp) warp_off = total;
    total += s_scan[i];
  }

  // 3. the normalised weights' squares; the run's CDF (its offset plus its
  // inclusive scan, over the total) and its marks: particle j takes every
  // slot from b[j - 1], the first whose position lies above cum[j - 1], up
  // to b[j]; so idx[i] is one more than the largest j with b[j] <= i, and
  // particle j marks slot b[j] with j + 1.
  const T pt = static_cast<T>(p), inv_p = T(1) / pt, inv_total = T(1) / total;
  const bool pow2 = (p & (p - 1)) == 0;
  T acc = warp_off + excl, sq = T(0);
  for (int k = begin; k < end; k += kChunk) {
    const int n = min(kChunk, end - k);
    T v[kChunk];
    load_chunk(s_weights + k, n, v);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      if (e < n) {
        const T wn = v[e] * inv_total;
        sq += wn * wn;
        acc += v[e];
        const int b = first_slot_above(acc * inv_total, ub, pt, inv_p, pow2, p);
        if (b < p) atomicMax(marks + b, k + e + 1);
      }
    }
  }
  if (MODE == kCopied) cp_async_wait<0>();  // this thread's states
  __syncthreads();                           // B: every mark and state

  // 4. idx = the running maximum of the marks: the run's own, a warp
  // shuffle scan, the warps before
  int run_max = 0;
  for (int k = begin; k < end; k += kChunk) {
    const int n = min(kChunk, end - k);
    int m[kChunk];
    load_marks<MODE == kDirect>(marks + k, n, marks_vec, m);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      if (e < n) run_max = max(run_max, m[e]);
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) s_sq[warp] = sq;
  int top = run_max;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, top, off);
    if (lane >= off) top = max(top, up);
  }
  int seen = __shfl_up_sync(kFull, top, 1);
  if (lane == 0) seen = 0;
  if (lane == 31) s_max[warp] = top;
  if (MODE == kStaged && d > 0) mbar_wait(&bars[1]);
  __syncthreads();  // C
  for (int i = 0; i < warp; ++i) seen = max(seen, s_max[i]);
  if (tid == 0) {
    T sumsq = s_sq[0];
    for (int i = 1; i < warps; ++i) sumsq += s_sq[i];
    neff_out[row] = T(1) / sumsq;
  }

  // 5. the run's idx: to the output as 16-byte vectors, and (kStaged,
  // kCopied) over its own marks, which no other thread reads
  for (int k = begin; k < end; k += kChunk) {
    const int n = min(kChunk, end - k);
    int jj[kChunk];
    load_marks<MODE == kDirect>(marks + k, n, marks_vec, jj);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      seen = max(seen, jj[e]);
      jj[e] = e < n ? min(seen, p - 1) : 0;
    }
    if (vec && n % V == 0) {
#pragma unroll
      for (int c = 0; c < kChunk; c += V) {
        if (c < n) Vec<T>::store_idx(idx_row + k + c, jj + c);
      }
    } else {
      for (int e = 0; e < n; ++e) idx_row[k + e] = jj[e];
    }
    if (MODE != kDirect) {
      for (int e = 0; e < n; ++e) marks[k + e] = jj[e];
    }
  }
  __syncthreads();  // D: every idx

  // 6. the gather, slot by slot across the block: neighbouring threads take
  // neighbouring slots, so their parents mostly neighbour too (no bank
  // conflicts in shared memory, where a thread's own run of parents put
  // 4 to 8 threads on a bank) and each store is a warp's 128 contiguous
  // bytes
  for (int i = tid; i < p; i += blockDim.x) {
    const int j = MODE == kDirect ? __ldcg(idx_row + i) : marks[i];
    for (int c = 0; c < d; ++c) {
      dst[c * p + i] = MODE == kDirect ? __ldg(src + c * p + j) : s_states[c * p + j];
    }
  }
}

template <typename T, int MODE>
cudaError_t launch_mode(const void* weights, const void* u, const void* states, void* out_states,
                        void* idx, void* neff, long long b, int p, int d, int threads, int run,
                        int smem, int vec, int device, cudaStream_t stream) {
  // the largest dynamic shared size set so far, per device
  static std::atomic<int> set_bytes[kMaxDevices];
  auto kernel = resample_kernel<T, MODE>;
  if (smem > set_bytes[device].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int seen = set_bytes[device].load(std::memory_order_relaxed);
    while (seen < smem && !set_bytes[device].compare_exchange_weak(seen, smem)) {
    }
  }
  kernel<<<static_cast<unsigned int>(b), threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(weights), static_cast<const T*>(u), static_cast<const T*>(states),
      static_cast<T*>(out_states), static_cast<int32_t*>(idx), static_cast<T*>(neff), p, d, run,
      vec);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* weights, const void* u, const void* states, void* out_states, void* idx,
           void* neff, long long b, int p, int d, int threads, int run, int mode, int smem,
           int vec, int device, void* stream) {
  if (b <= 0 || b > 2147483647LL || p <= 0 || d < 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 || run <= 0 || run % 4 || static_cast<long long>(threads) * run < p ||
      smem < 0 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kStaged:
      err = launch_mode<T, kStaged>(weights, u, states, out_states, idx, neff, b, p, d, threads,
                                    run, smem, vec, device, s);
      break;
    case kCopied:
      err = launch_mode<T, kCopied>(weights, u, states, out_states, idx, neff, b, p, d, threads,
                                    run, smem, vec, device, s);
      break;
    case kDirect:
      err = launch_mode<T, kDirect>(weights, u, states, out_states, idx, neff, b, p, d, threads,
                                    run, smem, vec, device, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int resample_f32(const void* weights, const void* u, const void* states,
                            void* out_states, void* idx, void* neff, long long b, int p, int d,
                            int threads, int run, int mode, int smem, int vec, int device,
                            void* stream) {
  return launch<float>(weights, u, states, out_states, idx, neff, b, p, d, threads, run, mode,
                       smem, vec, device, stream);
}

extern "C" int resample_f64(const void* weights, const void* u, const void* states,
                            void* out_states, void* idx, void* neff, long long b, int p, int d,
                            int threads, int run, int mode, int smem, int vec, int device,
                            void* stream) {
  return launch<double>(weights, u, states, out_states, idx, neff, b, p, d, threads, run, mode,
                        smem, vec, device, stream);
}
