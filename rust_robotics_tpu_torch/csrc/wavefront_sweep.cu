// Batched wavefront relaxation: Jacobi min-plus sweeps of B cost fields,
// each map until it converges or reaches a cap, in one launch.
//
// Replaces rust_robotics_tpu/ops/wavefront_pallas.py::_sweep_kernel (:39)
// and the while_loop around it (:153-163). A sweep sets every cell of a
// cost-to-go field d [B, W, H] (H fastest) to
//   min(d[x, y], min over allowed directions i of d[x+dx_i, y+dy_i] + c_i),
// reading only the field as it was before the sweep (Jacobi order). Bit i of
// bits[b, x, y] says whether the move from (x+dx_i, y+dy_i) into (x, y) is
// allowed; the directions are planning/wavefront.py's MOTIONS_8 order, and
// 4-connectivity uses the first four. A direction that is not allowed, or
// whose neighbour lies off the map, offers the sentinel `big`, as the JAX
// sweep's padded shift and mask do. The kernel computes the same value as
//   min(d[x, y], s + straight, g + diagonal),
// s (g) the least of `big` and the allowed straight (diagonal) neighbours:
// two adds a cell instead of eight. Rounding is monotone, so the least of
// v_i + c rounded is min_i v_i + c rounded, and `big` + c rounds to `big`
// (the wrapper checks this of both costs; with 4 directions the diagonal
// cost is +inf, so g adds nothing), so a direction that is not allowed
// still offers exactly `big`. Offering `big` where every direction is
// allowed changes nothing as long as no value exceeds `big` (every v + c is
// then at most `big` + c, which rounds to `big`). Adds and mins only,
// nothing to contract into an FMA: for fields whose values are at most
// `big`, none NaN or -0 (the grid entries hold only 0 and `big`), the result
// is bitwise that of the plain-PyTorch twin and of the JAX path. Above
// `big` it is not: a cell at +inf whose directions are all allowed and
// whose neighbours are all at +inf becomes `big` here and stays +inf there.
//
// Per-map convergence. Each map sweeps until one sweep lowers none of its
// cells, or until it has run `max_sweeps` sweeps; the launch reports, per
// map, the sweeps it ran and whether any cell got cheaper. The JAX loop
// (and the twin's) instead runs blocks of K sweeps over all maps together
// and stops after a block that lowers no cell of any map, or once
// S = K * ceil(max_iters / K) sweeps have run. Given max_sweeps = S both
// give bitwise the same field. A sweep only ever lowers cells (min with the
// cell's own value), so a sweep that lowers nothing leaves the map exactly
// as it was: the map is at its fixed point, and every later sweep leaves it
// there. If map b reaches its fixed point after m sweeps (sweep m + 1 is the
// first to lower nothing), the global loop runs at least m sweeps on it --
// a block that lowers nothing anywhere lowers nothing in map b, so it cannot
// end before sweep m -- or stops at S; so both end at the fixed point when
// m < S, and both run exactly S sweeps otherwise. The same argument makes
// the K-sweep primitive (wavefront_sweeps) this launch with max_sweeps = K:
// a map that stops before K sweeps already holds what K sweeps give, and
// "some cell got cheaper" is "some sweep lowered a cell".
//
// Bound: operations, not bytes. A launch moves the field in and out and one
// byte of bits per cell, but does up to S sweeps x W*H cells x 8 directions
// of work on them (a bit test and a min each, and the adds).
//
// Two variants; the resident one has two bodies; one C entry each:
// - resident (the bench shape, 128x128): one block per map, looping over
//   its own map until it stops; the map's edges are folded into the bits
//   once, as they are loaded, so a sweep reads a neighbour with no bounds
//   check. With one block per map, bench.py's B=64 fills 64 of the 132 SMs.
//   - registers (f32, at most 32 warps of 32 rows x 16 columns: the bench
//     shape): the field in registers, neighbours by warp shuffles and two
//     small halos; one barrier a sweep (relax_registers). Per cell and
//     sweep that is 2 shuffles and a share of the halo, against up to 11
//     shared-memory accesses in the body below.
//   - shared memory (f64, whose 32 field registers a thread would spill,
//     and f32 maps of other shapes): the field and the bit plane in shared
//     memory; each of 1024 threads computes the new values of its <= 16
//     cells into registers; one __syncthreads_or both waits for every read
//     and tells the block whether the sweep lowered a cell; the writes back
//     end with a __syncthreads(). 128x128 in f32 is 80 KB of dynamic shared
//     memory (144 KB in f64), above the 48 KB default, so the entry raises
//     the kernel's limit first.
// - tiled, for maps whose field and bit plane exceed one block's shared
//   memory: one persistent cooperative launch, the grid sized by the
//   occupancy API and capped at the number of (map, 32x32 tile) work items.
//   In every sweep each CTA walks its work items, relaxing a tile read with
//   its one-cell halo into shared memory, and the sweeps are separated by
//   grid barriers (cooperative_groups' grid.sync()). The field ping-pongs
//   between the output and a scratch buffer, the parity chosen so that the
//   cap's last sweep writes the output; the first sweep, which reads the
//   input, writes the output as well, so that a map stopping at any sweep
//   holds its fixed point in the output (both buffers hold it then). The
//   state buffer holds, per map, the last sweep that lowered one of its
//   cells (and the last over all maps): a map is swept while that is the
//   sweep just before, and the grid stops once a sweep lowered nothing
//   anywhere. All writers in a sweep store the same value, so the flags need
//   no clearing and no atomics. A grid the card cannot hold resident is
//   refused by cudaLaunchCooperativeKernel; the entry returns that error.
//
// C interface (bound with ctypes): wavefront_registers_f32 and
// wavefront_{resident,tiled}_{f32,f64} launch on the given stream, do not
// synchronise, allocate nothing, and return the first CUDA error
// (cudaGetLastError() after each launch); wavefront_error_name names one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // resident: one block per map
constexpr int kPerThread = 16;  // resident: cells per thread, so W*H <= 16384
constexpr int kTile = 32;       // tiled: a block relaxes kTile x kTile cells
constexpr int kRows = 8;        // tiled: threads are kTile (along H) x kRows
constexpr int kMaxDevices = 64;
constexpr int kStrip = 16;  // registers body: consecutive x a thread holds
constexpr int kWarps = kThreads / 32;
// registers body halos, at most kWarps (strip, 32-row block) pairs: per
// strip its rows -1 .. 32 * nyb, and per 32-row block its strips' columns
constexpr int kEdgeX = kWarps * 32 + 2 * kWarps;
constexpr int kEdgeY = kWarps * kStrip;

// MOTIONS_8 of planning/wavefront.py: (dx, dy) of direction i.
__device__ __forceinline__ int dir_dx(int i) {
  return (i == 0 || i >= 6) ? 1 : (i == 1 || i == 3) ? 0 : -1;
}
__device__ __forceinline__ int dir_dy(int i) {
  return (i == 0 || i == 2) ? 0 : (i == 1 || i == 5 || i == 7) ? 1 : -1;
}

// one FMNMX (fmin): the least of a and b, neither being NaN
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
relax_resident(const T* __restrict__ d_in, const uint8_t* __restrict__ bits_in,
               T* __restrict__ d_out, uint8_t* __restrict__ changed,
               int* __restrict__ sweeps, int w, int h, int max_sweeps,
               int ndirs, T straight, T diagonal, T big) {
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
  int ran = 0, any = 0;
  while (ran < max_sweeps) {
    int lowered = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cell = threadIdx.x + j * kThreads;
      if (cell < n) {
        const unsigned mask = s_b[cell];
        const T cur = s_d[cell];
        T least[2] = {big, big};  // straight, diagonal
#pragma unroll
        for (int dir = 0; dir < 8; ++dir) {
          if ((mask >> dir) & 1u) {
            least[dir / 4] =
                min_of(least[dir / 4], s_d[cell + dir_dx(dir) * h + dir_dy(dir)]);
          }
        }
        const T best = min_of(cur, min_of(least[0] + straight, least[1] + diagonal));
        next[j] = best;
        lowered |= best < cur;
      }
    }
    // every read of this sweep is done, and the block knows whether it
    // lowered a cell
    lowered = __syncthreads_or(lowered);
    ++ran;
    if (!lowered) break;  // the fixed point: no later sweep changes it
    any = 1;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cell = threadIdx.x + j * kThreads;
      if (cell < n) s_d[cell] = next[j];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += kThreads) d_out[base + i] = s_d[i];
  if (threadIdx.x == 0) {
    changed[blockIdx.x] = static_cast<uint8_t>(any);
    sweeps[blockIdx.x] = ran;
  }
}

// The resident variant's register body (f32): lane <-> y, 32 consecutive
// y per warp, so loads and stores along H stay coalesced; each thread holds
// a strip of kStrip consecutive x of the field in registers and the strip's
// 16 bytes of bits in 4 more. A sweep walks the strip in x: x +- 1 comes from
// the thread's own registers; y +- 1 and the diagonals from lanes +- 1 by
// shuffles. The strip ends' neighbours (x0 - 1, x0 + kStrip) and the warp
// edges' (lanes 0 and 31: y0 - 1, y0 + 32) come from two small halo buffers
// in shared memory, which each sweep writes for the next one: every thread
// its strip's first and last value, lanes 0 and 31 their whole strip. The
// halos are double-buffered by sweep parity, so one __syncthreads_or per
// sweep both orders their writes before the next sweep's reads and tells
// the block whether the sweep lowered a cell. The same adds and mins as the
// shared-memory body, so the same bits. It takes a map of at most kWarps
// (strip, 32-row block) pairs: ceil(h / 32) * ceil(w / kStrip) <= 32.
__global__ void __launch_bounds__(kThreads)
relax_registers(const float* __restrict__ d_in, const uint8_t* __restrict__ bits_in,
                float* __restrict__ d_out, uint8_t* __restrict__ changed,
                int* __restrict__ sweeps, int w, int h, int max_sweeps, int ndirs,
                float straight, float diagonal, float big) {
  // [parity][0: a strip's first column, 1: its last][strip * ystride + y + 1]
  __shared__ float edge_x[2][2][kEdgeX];
  // [parity][0: a warp's lane-0 row, 1: its lane-31 row][yblock * xspan + x]
  __shared__ float edge_y[2][2][kEdgeY];
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nyb = (h + 31) / 32, ns = (w + kStrip - 1) / kStrip;
  const int s = warp / nyb, yb = warp % nyb;
  const int y = yb * 32 + lane, x0 = s * kStrip;
  const int ystride = nyb * 32 + 2, xspan = ns * kStrip;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * w * h;

  // the strip and its bits, the map's edges folded in as in relax_resident;
  // cells past the map's edge hold the sentinel and allow no move
  float v[kStrip];
  uint32_t bw[kStrip / 4];
#pragma unroll
  for (int q = 0; q < kStrip / 4; ++q) bw[q] = 0;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    const int x = x0 + j;
    v[j] = big;
    if (x < w && y < h) {
      v[j] = d_in[base + static_cast<int64_t>(x) * h + y];
      unsigned mask = bits_in[base + static_cast<int64_t>(x) * h + y];
#pragma unroll
      for (int dir = 0; dir < 8; ++dir) {
        const int nx = x + dir_dx(dir), ny = y + dir_dy(dir);
        if (dir >= ndirs || nx < 0 || nx >= w || ny < 0 || ny >= h) {
          mask &= ~(1u << dir);
        }
      }
      bw[j / 4] |= mask << (8 * (j % 4));
    }
  }
  // the halo cells this thread reads: the strips on either side (clamped
  // at the map's edge, where the bits mask them) and the rows just below
  // and above the warp's 32
  const int left = (s > 0 ? s - 1 : 0) * ystride + y;
  const int right = (s + 1 < ns ? s + 1 : s) * ystride + y;
  const int below = (yb > 0 ? yb - 1 : 0) * xspan + x0;
  const int above = (yb + 1 < nyb ? yb + 1 : yb) * xspan + x0;
  const int own_x = s * ystride + y + 1, own_y = yb * xspan + x0;

  int p = 0;
  edge_x[0][0][own_x] = v[0];
  edge_x[0][1][own_x] = v[kStrip - 1];
  if (lane == 0 || lane == 31) {
#pragma unroll
    for (int j = 0; j < kStrip; ++j) edge_y[0][lane == 31][own_y + j] = v[j];
  }
  __syncthreads();

  int ran = 0, any = 0;
  while (ran < max_sweeps) {
    // the warp-edge rows, read through volatile so that the compiler reads
    // each where it is used and does not hoist all 16 into registers
    const volatile float* row_below = &edge_y[p][1][below];
    const volatile float* row_above = &edge_y[p][0][above];
    // a rolling window over x: column j - 1 (prev), j (cur), j + 1 (next),
    // each at y - 1 (up), y (v) and y + 1 (dn); column x0 - 1 from the halo
    float v_prev = edge_x[p][1][left + 1], up_prev = edge_x[p][1][left],
          dn_prev = edge_x[p][1][left + 2];
    float up_cur = __shfl_up_sync(kAll, v[0], 1);
    float dn_cur = __shfl_down_sync(kAll, v[0], 1);
    if (lane == 0) up_cur = row_below[0];
    if (lane == 31) dn_cur = row_above[0];
    int lowered = 0;
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      float v_next, up_next, dn_next;
      if (j + 1 < kStrip) {
        v_next = v[j + 1];
        up_next = __shfl_up_sync(kAll, v_next, 1);
        dn_next = __shfl_down_sync(kAll, v_next, 1);
        if (lane == 0) up_next = row_below[j + 1];
        if (lane == 31) dn_next = row_above[j + 1];
      } else {  // column x0 + kStrip, from the halo
        v_next = edge_x[p][0][right + 1];
        up_next = edge_x[p][0][right];
        dn_next = edge_x[p][0][right + 2];
      }
      const unsigned mask = bw[j / 4] >> (8 * (j % 4));
      const float cur = v[j];
      // MOTIONS_8: the neighbour (x + dx_i, y + dy_i) of direction i
      float st = big, dg = big;
      if (mask & 0x01u) st = min_of(st, v_next);
      if (mask & 0x02u) st = min_of(st, dn_cur);
      if (mask & 0x04u) st = min_of(st, v_prev);
      if (mask & 0x08u) st = min_of(st, up_cur);
      if (mask & 0x10u) dg = min_of(dg, up_prev);
      if (mask & 0x20u) dg = min_of(dg, dn_prev);
      if (mask & 0x40u) dg = min_of(dg, up_next);
      if (mask & 0x80u) dg = min_of(dg, dn_next);
      const float best = min_of(cur, min_of(st + straight, dg + diagonal));
      lowered |= best < cur;
      v[j] = best;  // every lane has shuffled the old v[j] by now
      v_prev = cur;
      up_prev = up_cur;
      dn_prev = dn_cur;
      up_cur = up_next;
      dn_cur = dn_next;
    }
    // the halos of the next sweep, into the other parity
    p ^= 1;
    edge_x[p][0][own_x] = v[0];
    edge_x[p][1][own_x] = v[kStrip - 1];
    if (lane == 0 || lane == 31) {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) edge_y[p][lane == 31][own_y + j] = v[j];
    }
    lowered = __syncthreads_or(lowered);
    ++ran;
    if (!lowered) break;  // the fixed point: no later sweep changes it
    any = 1;
  }

#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    if (x0 + j < w && y < h) d_out[base + static_cast<int64_t>(x0 + j) * h + y] = v[j];
  }
  if (threadIdx.x == 0) {
    changed[blockIdx.x] = static_cast<uint8_t>(any);
    sweeps[blockIdx.x] = ran;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile* kRows)
relax_tiled(const T* __restrict__ d_in, const uint8_t* __restrict__ bits,
            T* out, T* scratch, int* state, uint8_t* __restrict__ changed,
            int* __restrict__ sweeps, int b, int w, int h, int max_sweeps,
            int ndirs, T straight, T diagonal, T big) {
  __shared__ T tile[kTile + 2][kTile + 2];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int tiles_y = (h + kTile - 1) / kTile;
  const int tiles = tiles_y * ((w + kTile - 1) / kTile);
  const int items = b * tiles;
  // state[m]: the last sweep that lowered a cell of map m; state[b]: the
  // last sweep that lowered any cell; -1 for none
  int* last_any = state + b;
  for (int m = blockIdx.x * kTile * kRows + tid; m <= b; m += gridDim.x * kTile * kRows) {
    state[m] = -1;
  }
  grid.sync();

  for (int s = 0; s < max_sweeps; ++s) {
    // the last sweep (s = max_sweeps - 1) writes out; the ones before
    // alternate with scratch; the first reads the input
    T* dst = ((max_sweeps - 1 - s) % 2 == 0) ? out : scratch;
    const T* src = s == 0 ? d_in : (dst == out ? scratch : out);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m = item / tiles, t = item % tiles;
      // map m is swept while its previous sweep lowered a cell; no CTA
      // writes its entry in this sweep unless that holds, so all threads
      // read the same answer
      if (s > 0 && __ldcg(state + m) < s - 1) continue;
      const int64_t base = static_cast<int64_t>(m) * w * h;
      const int x0 = (t / tiles_y) * kTile, y0 = (t % tiles_y) * kTile;
      // the tile and its one-cell halo; cells off the map hold the sentinel
      for (int i = tid; i < (kTile + 2) * (kTile + 2); i += kTile * kRows) {
        const int tx = i / (kTile + 2), ty = i % (kTile + 2);
        const int gx = x0 + tx - 1, gy = y0 + ty - 1;
        tile[tx][ty] = (gx >= 0 && gx < w && gy >= 0 && gy < h)
                           ? __ldcg(src + base + static_cast<int64_t>(gx) * h + gy)
                           : big;
      }
      __syncthreads();

      int lowered = 0;
      for (int r = threadIdx.y; r < kTile; r += kRows) {
        const int x = x0 + r, y = y0 + threadIdx.x;
        if (x >= w || y >= h) continue;
        const int64_t at = base + static_cast<int64_t>(x) * h + y;
        const unsigned mask = bits[at];
        const T cur = tile[r + 1][threadIdx.x + 1];
        T least[2] = {big, big};  // straight, diagonal
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < ndirs && ((mask >> i) & 1u)) {
            least[i / 4] = min_of(least[i / 4],
                                  tile[r + 1 + dir_dx(i)][threadIdx.x + 1 + dir_dy(i)]);
          }
        }
        const T best = min_of(cur, min_of(least[0] + straight, least[1] + diagonal));
        dst[at] = best;
        if (s == 0 && dst != out) out[at] = best;
        lowered |= best < cur;
      }
      // also the barrier before the next item overwrites the tile
      lowered = __syncthreads_or(lowered);
      if (lowered && tid == 0) {
        state[m] = s;
        *last_any = s;
      }
    }
    grid.sync();
    if (__ldcg(last_any) < s) break;  // no map lowered a cell in sweep s
  }

  for (int m = blockIdx.x * kTile * kRows + tid; m < b; m += gridDim.x * kTile * kRows) {
    const int last = state[m];
    changed[m] = static_cast<uint8_t>(last >= 0);
    // the sweeps up to the last that lowered a cell, and the one after it
    sweeps[m] = last + 2 < max_sweeps ? last + 2 : max_sweeps;
  }
}

// The group form (see the top) needs big + c to round to big in T for each
// cost; with 4 directions the diagonal cost becomes +inf, so the empty
// diagonal group adds nothing. False when a cost is too large for that.
template <typename T>
bool group_costs(int ndirs, double straight, double* diagonal, double big) {
  if (ndirs == 4) *diagonal = HUGE_VAL;
  const T b = static_cast<T>(big);
  return b + static_cast<T>(straight) == b &&
         (ndirs == 4 || b + static_cast<T>(*diagonal) == b);
}

template <typename T>
int launch_resident(const void* d_in, const void* bits, void* d_out,
                    void* changed, void* sweeps, int b, int w, int h,
                    int max_sweeps, int ndirs, double straight,
                    double diagonal, double big, void* stream) {
  const int n = w * h;
  if (b <= 0 || w <= 0 || h <= 0 || max_sweeps < 1 ||
      n > kThreads * kPerThread || (ndirs != 4 && ndirs != 8) ||
      !group_costs<T>(ndirs, straight, &diagonal, big)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * (sizeof(T) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      relax_resident<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_resident<T><<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d_in), static_cast<const uint8_t*>(bits),
      static_cast<T*>(d_out), static_cast<uint8_t*>(changed),
      static_cast<int*>(sweeps), w, h, max_sweeps, ndirs,
      static_cast<T>(straight), static_cast<T>(diagonal), static_cast<T>(big));
  return static_cast<int>(cudaGetLastError());
}

int launch_registers(const void* d_in, const void* bits, void* d_out,
                     void* changed, void* sweeps, int b, int w, int h,
                     int max_sweeps, int ndirs, double straight,
                     double diagonal, double big, void* stream) {
  if (b <= 0 || w <= 0 || h <= 0 || max_sweeps < 1 ||
      (ndirs != 4 && ndirs != 8) ||
      !group_costs<float>(ndirs, straight, &diagonal, big)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = static_cast<int64_t>((h + 31) / 32) * ((w + kStrip - 1) / kStrip);
  if (warps > kWarps) return static_cast<int>(cudaErrorInvalidValue);
  relax_registers<<<b, static_cast<int>(32 * warps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_in), static_cast<const uint8_t*>(bits),
      static_cast<float*>(d_out), static_cast<uint8_t*>(changed),
      static_cast<int*>(sweeps), w, h, max_sweeps, ndirs,
      static_cast<float>(straight), static_cast<float>(diagonal), static_cast<float>(big));
  return static_cast<int>(cudaGetLastError());
}

// CTAs of relax_tiled<T> per SM, and the SM count, per device (cached)
template <typename T>
cudaError_t tiled_residency(int device, int* per_sm, int* sms) {
  static int cached_blocks[kMaxDevices];
  static int cached_sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[device] == 0) {
    int blocks = 0, count = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, relax_tiled<T>, kTile * kRows, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached_blocks[device] = blocks;
    cached_sms[device] = count;
  }
  *per_sm = cached_blocks[device];
  *sms = cached_sms[device];
  return cudaSuccess;
}

template <typename T>
int launch_tiled(const void* d_in, const void* bits, void* d_out, void* changed,
                 void* sweeps, void* scratch, void* state, int b, int w, int h,
                 int max_sweeps, int ndirs, double straight, double diagonal,
                 double big, void* stream) {
  const int64_t tiles = static_cast<int64_t>((w + kTile - 1) / kTile) *
                        ((h + kTile - 1) / kTile);
  if (b <= 0 || w <= 0 || h <= 0 || max_sweeps < 1 ||
      (ndirs != 4 && ndirs != 8) || scratch == nullptr || state == nullptr ||
      b * tiles > INT32_MAX || !group_costs<T>(ndirs, straight, &diagonal, big)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = tiled_residency<T>(device, &per_sm, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid no CTA of which fits cannot run: refuse it
  if (per_sm == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int grid = static_cast<int>(b * tiles < resident ? b * tiles : resident);

  const T* in_ = static_cast<const T*>(d_in);
  const uint8_t* bits_ = static_cast<const uint8_t*>(bits);
  T* out_ = static_cast<T*>(d_out);
  T* scratch_ = static_cast<T*>(scratch);
  int* state_ = static_cast<int*>(state);
  uint8_t* changed_ = static_cast<uint8_t*>(changed);
  int* sweeps_ = static_cast<int*>(sweeps);
  T straight_ = static_cast<T>(straight), diagonal_ = static_cast<T>(diagonal),
    big_ = static_cast<T>(big);
  void* args[] = {&in_,    &bits_, &out_, &scratch_, &state_,
                  &changed_, &sweeps_, &b, &w,       &h,
                  &max_sweeps, &ndirs, &straight_, &diagonal_, &big_};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(relax_tiled<T>),
                                    dim3(grid), dim3(kTile, kRows), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* wavefront_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

#define RESIDENT_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* d_in, const void* bits, void* d_out,         \
                      void* changed, void* sweeps, void* /*scratch*/,          \
                      void* /*state*/, int b, int w, int h, int max_sweeps,    \
                      int ndirs, double straight, double diagonal, double big, \
                      void* stream) {                                          \
    return launch_resident<T>(d_in, bits, d_out, changed, sweeps, b, w, h,     \
                              max_sweeps, ndirs, straight, diagonal, big,      \
                              stream);                                         \
  }

#define TILED_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const void* d_in, const void* bits, void* d_out,         \
                      void* changed, void* sweeps, void* scratch, void* state, \
                      int b, int w, int h, int max_sweeps, int ndirs,          \
                      double straight, double diagonal, double big,            \
                      void* stream) {                                          \
    return launch_tiled<T>(d_in, bits, d_out, changed, sweeps, scratch, state, \
                           b, w, h, max_sweeps, ndirs, straight, diagonal,     \
                           big, stream);                                       \
  }

extern "C" int wavefront_registers_f32(const void* d_in, const void* bits, void* d_out,
                                      void* changed, void* sweeps, void* /*scratch*/,
                                      void* /*state*/, int b, int w, int h, int max_sweeps,
                                      int ndirs, double straight, double diagonal,
                                      double big, void* stream) {
  return launch_registers(d_in, bits, d_out, changed, sweeps, b, w, h, max_sweeps, ndirs,
                          straight, diagonal, big, stream);
}

RESIDENT_ENTRY(wavefront_resident_f32, float)
RESIDENT_ENTRY(wavefront_resident_f64, double)
TILED_ENTRY(wavefront_tiled_f32, float)
TILED_ENTRY(wavefront_tiled_f64, double)
