// Fused batched EKF scan for the unicycle + GPS-position model.
//
// Replaces rust_robotics_tpu/ops/ekf_pallas.py::_ekf_tile_kernel: T EKF
// predict+update steps for B independent filters, with each belief (mean[4],
// cov[16]) held in registers for the whole scan, so device memory sees the
// belief once in and once out.
//
// Layout (the JAX kernel's, kept at the Python wrapper): zs, us [T, 2, B];
// mean [4, B]; cov [16, B] row-major 4x4; batch on the fastest axis.
//
// Bound: device-memory bandwidth. At B = 131072, T = 200 in f32 the kernel
// must read 2*T*2*B*4 B of measurements and controls (~419 MB) against
// ~120 flops and 4 sin/cos per step, far below the card's FP32 rate per byte.
// The design does the one thing that matters for that: one thread per
// filter, so at step t neighbouring threads read neighbouring addresses of
// zs[t, :, :] and us[t, :, :] and every stream along B coalesces; nothing
// but the four stream values per step crosses device memory.
//
// The arithmetic follows the JAX kernel operation by operation (ekf.rs
// semantics): F is the identity except F[0,2] and F[1,2], evaluated at the
// PREDICTED yaw; row and column 3 of F P F^T are zero before Q is added, so
// P'[3][3] is exactly q[3]; S is 2x2 with a closed-form inverse. sin/cos use
// the accurate sincos, and the file is built without --use_fast_math.
//
// C interface (bound with ctypes): ekf_scan_f32 / ekf_scan_f64 launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}

__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ekf_scan_kernel(const T* __restrict__ zs, const T* __restrict__ us,
                const T* __restrict__ mean0, const T* __restrict__ cov0,
                T* __restrict__ mean_out, T* __restrict__ cov_out, int steps,
                int64_t b, T dt, T q0, T q1, T q2, T q3, T r0, T r1) {
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= b) return;  // ragged edge of B

  const T zero = T(0);
  const T one = T(1);
  const T q[4] = {q0, q1, q2, q3};

  T m[4];
  T p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = mean0[i * b + lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = cov0[(4 * i + j) * b + lane];
  }

  for (int t = 0; t < steps; ++t) {
    const T* zt = zs + static_cast<int64_t>(t) * 2 * b;
    const T* ut = us + static_cast<int64_t>(t) * 2 * b;
    const T v_u = ut[lane];
    const T om = ut[b + lane];
    const T z0 = zt[lane];
    const T z1 = zt[b + lane];

    // predict mean (ekf.rs:203-212)
    T sin_yaw, cos_yaw;
    sin_cos(m[2], &sin_yaw, &cos_yaw);
    const T x0 = m[0] + dt * v_u * cos_yaw;
    const T x1 = m[1] + dt * v_u * sin_yaw;
    const T x2 = m[2] + dt * om;
    const T x3 = v_u;

    // F evaluated at the PREDICTED state (ekf.rs:318-321)
    T sin_x2, cos_x2;
    sin_cos(x2, &sin_x2, &cos_x2);
    const T f02 = -dt * v_u * sin_x2;
    const T f12 = dt * v_u * cos_x2;

    // A = F P  (rows: 0 += f02 row2; 1 += f12 row2; 3 = 0)
    T a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[0][j] = p[0][j] + f02 * p[2][j];
      a[1][j] = p[1][j] + f12 * p[2][j];
      a[2][j] = p[2][j];
      a[3][j] = zero;
    }
    // P' = A F^T + Q  (cols: 0 += f02 col2; 1 += f12 col2; 3 = 0)
    T pp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pp[i][0] = a[i][0] + f02 * a[i][2];
      pp[i][1] = a[i][1] + f12 * a[i][2];
      pp[i][2] = a[i][2];
      pp[i][3] = zero;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) pp[3][j] = zero;
#pragma unroll
    for (int i = 0; i < 4; ++i) pp[i][i] = pp[i][i] + q[i];

    // update: S = P'[0:2, 0:2] + R, closed-form 2x2 inverse
    const T s00 = pp[0][0] + r0;
    const T s01 = pp[0][1];
    const T s10 = pp[1][0];
    const T s11 = pp[1][1] + r1;
    const T inv_det = one / (s00 * s11 - s01 * s10);
    const T i00 = s11 * inv_det;
    const T i01 = -s01 * inv_det;
    const T i10 = -s10 * inv_det;
    const T i11 = s00 * inv_det;

    // K = P'[:, 0:2] S^-1  ([4, 2])
    T k0[4], k1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k0[i] = pp[i][0] * i00 + pp[i][1] * i10;
      k1[i] = pp[i][0] * i01 + pp[i][1] * i11;
    }
    const T y0 = z0 - x0;
    const T y1 = z1 - x1;
    m[0] = x0 + k0[0] * y0 + k1[0] * y1;
    m[1] = x1 + k0[1] * y0 + k1[1] * y1;
    m[2] = x2 + k0[2] * y0 + k1[2] * y1;
    m[3] = x3 + k0[3] * y0 + k1[3] * y1;

    // P = (I - K H) P' = P' - K P'[0:2, :]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = pp[i][j] - k0[i] * pp[0][j] - k1[i] * pp[1][j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mean_out[i * b + lane] = m[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) cov_out[(4 * i + j) * b + lane] = p[i][j];
  }
}

template <typename T>
int launch(const void* zs, const void* us, const void* mean0, const void* cov0,
           void* mean_out, void* cov_out, int steps, long long b, double dt,
           double q0, double q1, double q2, double q3, double r0, double r1,
           void* stream) {
  if (b <= 0 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (b + kThreads - 1) / kThreads;
  ekf_scan_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(zs), static_cast<const T*>(us),
      static_cast<const T*>(mean0), static_cast<const T*>(cov0),
      static_cast<T*>(mean_out), static_cast<T*>(cov_out), steps,
      static_cast<int64_t>(b), static_cast<T>(dt), static_cast<T>(q0),
      static_cast<T>(q1), static_cast<T>(q2), static_cast<T>(q3),
      static_cast<T>(r0), static_cast<T>(r1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ekf_scan_f32(const void* zs, const void* us, const void* mean0,
                            const void* cov0, void* mean_out, void* cov_out,
                            int steps, long long b, double dt, double q0,
                            double q1, double q2, double q3, double r0,
                            double r1, void* stream) {
  return launch<float>(zs, us, mean0, cov0, mean_out, cov_out, steps, b, dt,
                       q0, q1, q2, q3, r0, r1, stream);
}

extern "C" int ekf_scan_f64(const void* zs, const void* us, const void* mean0,
                            const void* cov0, void* mean_out, void* cov_out,
                            int steps, long long b, double dt, double q0,
                            double q1, double q2, double q3, double r0,
                            double r1, void* stream) {
  return launch<double>(zs, us, mean0, cov0, mean_out, cov_out, steps, b, dt,
                        q0, q1, q2, q3, r0, r1, stream);
}
