// Pines spherical-harmonics gravity recursion, written by hand for Hopper
// (sm_90a). It replaces the Pallas TPU kernel
// nyx_tpu/dynamics/gravity_pallas.py::_pines_kernel and computes the same
// thing from the same packed table (nyx_tpu_torch/dynamics/gravity_pines.py
// ::pack_tables): for body-fixed positions r_bf [B, 3] f32, the
// non-spherical acceleration [B, 3] of a normalized spherical-harmonic
// field, accumulating degrees q in (q_lo, n_steps].
//
// What bounds it on an H100: at B = 10,000 lanes and a 21x21 field it reads
// 120 KB of positions, writes 120 KB of accelerations and reads the 16 KB
// table once per block from L2 (about 0.25 MB of device memory in all), and
// does about 2e8 f32 operations (~40 per order and degree step, 23 x 21 steps
// per lane, counted from the loops below). Both are microseconds of the
// card's bandwidth and f32 rate; 10,000 lanes at 128 threads a block fill
// only 79 of the 132 SMs with four warps each, so the call is bound by
// latency and launch, not by bandwidth or arithmetic. Measured: 0.0565 ms
// per call (NVIDIA H100 80GB HBM3, 700 W power limit; PERF.md).
//
// Design, simple first:
//  - one thread per lane; the ragged edge is masked by i < B, so no lane is
//    padded and none needs a seeded radius;
//  - the packed table [n_steps, 8, W_pad] is staged once per block into
//    shared memory; every thread of a warp reads the same word (broadcast);
//  - the TPU layout (order m on sublanes, batch on lanes, VMEM scratch rows)
//    is not carried over. Each order m is independent along the degree
//    recursion except for the row shift m+1 that the z and w sums read, so
//    the thread walks the orders m = 0..W-1 and, for each, runs the degree
//    recursion of column m and of column m+1 in registers. Column m+1 is
//    recomputed when it becomes column m: twice the row work, but O(1)
//    registers for any field width, where holding whole rows would take
//    4 * W_pad floats per thread. Column m+1 past the field width is zero,
//    as the Pallas kernel's zero row shifted in at the top order;
//  - each order's four sums are kept apart and added after its degree loop,
//    the order of the Pallas kernel's deferred reduction.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pines_kernel(const float* __restrict__ r_bf, const float* __restrict__ tab,
             float* __restrict__ out, int B, int n_steps, int W, int W_pad,
             int q_lo, float mu, float radius, float inv_radius, float diag1) {
  extern __shared__ float s_tab[];  // [n_steps, 8, W_pad]
  const int n_tab = n_steps * 8 * W_pad;
  for (int j = threadIdx.x; j < n_tab; j += blockDim.x) s_tab[j] = tab[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;

  const float x = r_bf[3 * i], y = r_bf[3 * i + 1], z = r_bf[3 * i + 2];
  const float r = sqrtf(x * x + y * y + z * z);
  const float inv_r = 1.0f / r;
  const float s = x * inv_r, t = y * inv_r, u = z * inv_r;
  const float rho = radius * inv_r;
  const float mu_over_r = mu * inv_r;
  const float sqrt3 = 1.7320508075688772f;

  float acc_x = 0.f, acc_y = 0.f, acc_z = 0.f, acc_w = 0.f;
  float rm = 1.f, im = 0.f;    // r_m, i_m: powers of (s + i t)
  float rm1 = 0.f, im1 = 0.f;  // r_{m-1}, i_{m-1} (zero at m = 0)
  for (int m = 0; m < W; ++m) {
    if (m > 0) {
      const float rn = s * rm - t * im;
      const float in = s * im + t * rm;
      rm1 = rm;
      im1 = im;
      rm = rn;
      im = in;
    }
    const bool has_p = m + 1 < W;
    // Legendre rows of degree 0 (one-hot at m = 0) and degree 1
    // ([u sqrt3, diag1, 0, ...]) at columns m and m+1.
    float a_nm2 = (m == 0) ? 1.f : 0.f;
    float a_nm1 = (m == 0) ? u * sqrt3 : ((m == 1) ? diag1 : 0.f);
    float p_nm2 = 0.f;
    float p_nm1 = (m == 0) ? diag1 : 0.f;
    float px = 0.f, py = 0.f, pz = 0.f, pw = 0.f;
    float rho_q = mu_over_r * rho;
    const float mf = static_cast<float>(m);
    for (int k = 0; k < n_steps; ++k) {
      const float* tk = s_tab + k * 8 * W_pad;
      // row n = u b row_{n-1} - c row_{n-2} + diag + offdiag u
      const float a_n = u * tk[m] * a_nm1 - tk[W_pad + m] * a_nm2 +
                        tk[2 * W_pad + m] + tk[3 * W_pad + m] * u;
      float p_n = 0.f;
      if (has_p) {
        const int m1 = m + 1;
        p_n = u * tk[m1] * p_nm1 - tk[W_pad + m1] * p_nm2 +
              tk[2 * W_pad + m1] + tk[3 * W_pad + m1] * u;
      }
      rho_q = rho_q * rho;
      if (k + 1 > q_lo) {
        const float cq = tk[4 * W_pad + m], sq = tk[5 * W_pad + m];
        const float vr01 = tk[6 * W_pad + m], vr11 = tk[7 * W_pad + m];
        const float d = cq * rm + sq * im;
        const float e = cq * rm1 + sq * im1;
        const float f = sq * rm1 - cq * im1;
        const float rr = rho_q * inv_radius;
        px += (rr * mf) * a_nm1 * e;
        py += (rr * mf) * a_nm1 * f;
        pz += (rr * vr01) * p_nm1 * d;
        pw -= (rr * vr11) * p_n * d;
      }
      a_nm2 = a_nm1;
      a_nm1 = a_n;
      p_nm2 = p_nm1;
      p_nm1 = p_n;
    }
    acc_x += px;
    acc_y += py;
    acc_z += pz;
    acc_w += pw;
  }
  out[3 * i] = acc_x + acc_w * s;
  out[3 * i + 1] = acc_y + acc_w * t;
  out[3 * i + 2] = acc_z + acc_w * u;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a launch the device
// refuses (too much shared memory, bad configuration) is reported here.
// The caller checks shapes, types and the shared-memory size first.
extern "C" int pines_accel_f32(const float* r_bf, const float* tab, float* out,
                               int B, int n_steps, int W, int W_pad, int q_lo,
                               float mu, float radius, float inv_radius,
                               float diag1, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_steps) * 8 * W_pad;
  const int blocks = (B + kThreads - 1) / kThreads;
  pines_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r_bf, tab, out, B, n_steps, W, W_pad, q_lo, mu, radius, inv_radius, diag1);
  return static_cast<int>(cudaGetLastError());
}
