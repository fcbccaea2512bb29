// The spacecraft EOM of one RK stage, fused around the Pines launch, written
// by hand for Hopper (sm_90a). It replaces no TPU kernel: the JAX package
// leaves this arithmetic to XLA, which fuses it. In eager PyTorch the same
// EOM is ~418 kernels an evaluation over [B, 9] f64 states: the closed-form
// J2+J3, the IAU Earth rotation, the Sun's Chebyshev pass, the conical
// shadow, SRP, drag and the casts, each reading and writing device memory
// at the full width (dynamics/spacecraft_dyn.py::_core_eom and what it
// calls). Here they are two kernels with the Pines kernel between them:
//
//   eom_pre:  t_rel [B] f64, y [B, 9] f64 -> r_bf [B, 3] f32, the Pines
//             kernel's body-fixed input dcm32 . float(r);
//   (pines_kernel, csrc/pines.cu, unchanged: r_bf -> a_bf [B, 3] f32)
//   eom_post: t_rel, y, a_bf and the Sun's Chebyshev records ->
//             ydot [B, 9] f64 = [v, a, 0, 0, 0].
//
// eom_post recomputes the rotation rather than reading eom_pre's: a few
// dozen operations a lane against a 36-byte round trip through memory.
// Without a field only eom_post runs.
//
// What bounds it on an H100: memory, barely. A lane reads 80 bytes of t and
// y (and 12 of a_bf) and writes 72 (12 for eom_pre): ~0.33 GB an evaluation
// at 2M lanes, ~0.1 ms at 3.35 TB/s; the arithmetic is a few hundred f64
// and f32 operations a lane. So one thread a lane, 256-thread blocks, and a
// block's [256, 9] rows of y and of ydot staged through shared memory so
// that every load and store of device memory is coalesced.
//
// Every operation is the composed path's, in its order and its dtype (f64
// for two-body, J2+J3 and the angles; f32 for the rotation matrix, the Sun,
// the shadow, SRP and drag), built with --fmad=false so that each rounds as
// PyTorch's elementwise kernels do. Where PyTorch rewrites an operation, so
// does this file: a tensor divided by a Python number is a product with the
// number's reciprocal (rounded at the tensor's dtype on the host, passed in
// EomConsts), a number divided by a tensor is the tensor's reciprocal times
// the number, x ** 2 and x ** 3 are x * x and x * x * x, and a sum over the
// last axis of three adds the elements in the order of sum3 below, which is
// PyTorch's reduction order for three elements on the card.
// The host side is nyx_tpu_torch/dynamics/fused_eom.py.

#include <cuda_runtime.h>

#include <cmath>

// Every constant of one evaluation, by value. The layout is mirrored by
// fused_eom.py::_Consts (ctypes); floats are the f32 values PyTorch's
// kernels would use for the same Python numbers.
struct EomConsts {
  double epoch0_tdb;    // TDB seconds past J2000 of t_rel = 0
  double mu;            // the frame's GM, km^3/s^2 (two-body)
  double field_mu;      // the split field's GM and radius, km
  double field_radius;
  double c2_coef;       // -1.5 J2
  double c3_coef;       // -2.5 J3
  double sun_t0;        // the Sun's table start, TDB s
  double dry_mass_kg;
  float sun_intlen;     // record length, s
  float sun_inv_intlen;  // 1 / record length, rounded in f32
  float sun_last_rec;   // n_records - 1
  float srp_phi_over_c;  // flux / c, N/m^2 at 1 AU
  float au_km;
  float sun_radius_km;
  float occ_radius_km;  // the frame centre's radius (the occulter)
  float srp_area_m2;
  float rho;            // constant density, kg/m^3
  float rho0;           // exponential density: rho0 exp(-(alt - r0) / h)
  float r0_m;
  float inv_ref_alt_m;  // 1 / h, rounded in f32
  float drag_radius_km;
  float omega;          // Earth's rotation rate, rad/s
  float drag_area_m2;
  int field;            // 1: split field (J2+J3 here, the rest from a_bf)
  int j3;               // 1 when J3 != 0
  int srp;              // 1: cannonball SRP with the centre's conical shadow
  int drag;             // 0: none, 1: constant density, 2: exponential
  int sun_coeffs;       // Chebyshev coefficients a component (degree + 1)
  int sun_strides[3];   // elements between records, components, coefficients
};

namespace {

constexpr int kThreads = 256;
constexpr int kDim = 9;

constexpr double kD2R = 3.141592653589793 / 180.0;
constexpr double kInvDay = 1.0 / 86400.0;
constexpr double kInvCentury = 1.0 / 36525.0;
constexpr double kInv360 = 1.0 / 360.0;
constexpr double kWdotFrac = 360.9856235 - 360.0;
constexpr float kPiF = 3.14159265358979323846f;
constexpr float kEps = 1e-30f;

// torch.sum over a last axis of three, on the card: the reduction gives its
// two threads elements {0, 2} and {1} and adds the second's to the first's
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  return (x0 + x2) + x1;
}

// torch.clamp / torch.maximum: NaN propagates
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// A block's rows [n, 9] of a row-major f64 array, through shared memory.
__device__ __forceinline__ void load_rows(double* rows, const double* src, int n) {
  for (int k = threadIdx.x; k < n * kDim; k += kThreads) rows[k] = src[k];
}

// cosmic/rotations.py::iau_earth_dcm32_pole: the f64 pole from small-angle
// polynomials, the f64 reduction of the prime meridian (xmath.py::
// linear_angle_deg), then f32 trigonometry and the f32 matrix.
__device__ void earth_rotation(double t_tdb, float m[3][3], double pole[3]) {
  const double d = t_tdb * kInvDay;
  const double T = d * kInvCentury;
  const double a = (T * -0.641) * kD2R;
  const double b = (T * 0.557) * kD2R;
  const double a2 = a * a;
  const double b2 = b * b;
  const double sb = b * (1.0 - b2 * (1.0 / 6.0));
  const double cb = 1.0 - (b2 * 0.5) * (1.0 - b2 * (1.0 / 12.0));
  const double sc = 1.0 - (a2 * 0.5) * (1.0 - a2 * (1.0 / 12.0));
  const double cc = -(a * (1.0 - a2 * (1.0 / 6.0)));
  pole[0] = sb * sc;
  pole[1] = (-sb) * cc;
  pole[2] = cb;

  const double d_i = floor(d);
  const double d_f = d - d_i;
  const double big = d_i * 360.0;
  const double big_mod = big - rint(big * kInv360) * 360.0;
  const double small = ((d_f * 360.0) + (d * kWdotFrac)) + 190.147;
  double w = big_mod + small;
  w = w - rint(w * kInv360) * 360.0;
  const float w32 = static_cast<float>(w * kD2R);
  const float cw = cosf(w32), sw = sinf(w32);

  const float cb32 = static_cast<float>(cb), sb32 = static_cast<float>(sb);
  const float cc32 = static_cast<float>(cc), sc32 = static_cast<float>(sc);
  const float m00 = cc32, m01 = sc32;
  const float m10 = (-cb32) * sc32, m11 = cb32 * cc32, m12 = sb32;
  m[0][0] = cw * m00 + sw * m10;
  m[0][1] = cw * m01 + sw * m11;
  m[0][2] = sw * m12;
  m[1][0] = (-sw) * m00 + cw * m10;
  m[1][1] = (-sw) * m01 + cw * m11;
  m[1][2] = cw * m12;
  m[2][0] = static_cast<float>(pole[0]);
  m[2][1] = static_cast<float>(pole[1]);
  m[2][2] = static_cast<float>(pole[2]);
}

// ephem/almanac.py::EphemTable.position(..., dtype=float32): one f64
// subtraction, then the record, tau and Clenshaw in f32 on the record's
// coefficients cast to f32.
__device__ void sun_position(const double* __restrict__ coeffs, double t_tdb, const EomConsts& c,
                             float out[3]) {
  const float rel = static_cast<float>(t_tdb - c.sun_t0);
  const float rec_f = clampf(floorf(rel * c.sun_inv_intlen), 0.0f, c.sun_last_rec);
  const float tau = ((rel - rec_f * c.sun_intlen) * 2.0f) * c.sun_inv_intlen - 1.0f;
  const int sn = c.sun_strides[2];
  const double* rec =
      coeffs + static_cast<long>(isnan(rec_f) ? 0 : static_cast<int>(rec_f)) * c.sun_strides[0];
  const float x2 = tau * 2.0f;
  for (int k = 0; k < 3; ++k) {
    const double* ck = rec + k * c.sun_strides[1];
    float b1 = 0.0f, b2 = 0.0f;
    for (int n = c.sun_coeffs - 1; n > 0; --n) {
      const float b0 = (static_cast<float>(ck[n * sn]) + x2 * b1) - b2;
      b2 = b1;
      b1 = b0;
    }
    out[k] = (static_cast<float>(ck[0]) + tau * b1) - b2;
  }
}

// cosmic/eclipse.py::_safe_arccos and _safe_sqrt at f32 (their 1 - 1e-12
// and 1e-300 round to 1 and 0 there)
__device__ __forceinline__ float safe_acos(float x) {
  const bool inside = fabsf(x) < 1.0f;
  const float edge = x > 0.0f ? 0.0f : kPiF;
  return inside ? acosf(x) : edge;
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// cosmic/eclipse.py::_apparent_overlap_fraction
__device__ float overlap_fraction(float ang, float r1, float r2) {
  const bool full = r2 >= r1 + 0.0f;
  const bool no_overlap = ang >= r1 + r2;
  const bool contained = ang <= fabsf(r2 - r1);
  const bool partial = !no_overlap && !contained;
  const float d = partial ? clamp_min(ang, kEps) : 1.0f;
  const float d1 = ((d * d + r1 * r1) - r2 * r2) / (d * 2.0f);
  const float d2 = d - d1;
  const float a1 = (r1 * r1) * safe_acos(d1 / clamp_min(r1, kEps)) - d1 * safe_sqrt(r1 * r1 - d1 * d1);
  const float a2 = (r2 * r2) * safe_acos(d2 / clamp_min(r2, kEps)) - d2 * safe_sqrt(r2 * r2 - d2 * d2);
  const float lens = a1 + a2;
  const float sun_area = (kPiF * r1) * r1;
  const float frac_partial = clampf(lens / clamp_min(sun_area, kEps), 0.0f, 1.0f);
  const float frac_contained =
      full ? 1.0f : clampf((r2 * r2) / clamp_min(r1 * r1, kEps), 0.0f, 1.0f);
  return no_overlap ? 0.0f : (contained ? frac_contained : frac_partial);
}

// dynamics/srp.py::SolarPressure.force_per_mass with the frame's centre as
// the only occulter (cosmic/eclipse.py::illumination_factor)
__device__ void srp_accel(const float r[3], const float sun[3], float cr, float mass,
                          const EomConsts& c, float out[3]) {
  float rs[3], ro[3];
  for (int k = 0; k < 3; ++k) {
    rs[k] = sun[k] - r[k];
    ro[k] = -r[k];
  }
  const float d_sun = sqrtf(sum3(rs[0] * rs[0], rs[1] * rs[1], rs[2] * rs[2]));
  const float d_occ = sqrtf(sum3(ro[0] * ro[0], ro[1] * ro[1], ro[2] * ro[2]));
  const float r_sun_app = asinf(clampf((1.0f / d_sun) * c.sun_radius_km, 0.0f, 1.0f));
  const float r_occ_app = asinf(clampf((1.0f / d_occ) * c.occ_radius_km, 0.0f, 1.0f));
  const float cosang = sum3(rs[0] * ro[0], rs[1] * ro[1], rs[2] * ro[2]) / (d_sun * d_occ);
  const float frac = overlap_fraction(safe_acos(cosang), r_sun_app, r_occ_app);
  const float occ = maximum(0.0f, d_occ < d_sun ? frac : 0.0f);
  const float k = 1.0f - occ;
  const float q = (1.0f / d_sun) * c.au_km;
  const float flux = (k * c.srp_phi_over_c) * (q * q);
  const float aom = (1.0f / mass) * c.srp_area_m2;
  const float s = ((cr * aom) * flux) * 1e-3f;
  for (int i = 0; i < 3; ++i) out[i] = s * ((-rs[i]) / d_sun);
}

// dynamics/drag.py::Drag.force_per_mass, constant or exponential density
__device__ void drag_accel(const float r[3], const float v[3], float cd, float mass,
                           const EomConsts& c, float out[3]) {
  float rho = c.rho;
  if (c.drag == 2) {
    const float rmag = sqrtf(sum3(r[0] * r[0], r[1] * r[1], r[2] * r[2]));
    const float alt = rmag - c.drag_radius_km;
    rho = expf(-(alt * 1000.0f - c.r0_m) * c.inv_ref_alt_m) * c.rho0;
  }
  const float vr[3] = {v[0] - (-(r[1] * c.omega)), v[1] - r[0] * c.omega, v[2] - 0.0f};
  const float vmag = sqrtf(sum3(vr[0] * vr[0], vr[1] * vr[1], vr[2] * vr[2]));
  const float aom = (1.0f / mass) * c.drag_area_m2;
  const float s = (((rho * cd) * aom) * -500.0f) * vmag;
  for (int i = 0; i < 3; ++i) out[i] = s * vr[i];
}

__global__ void __launch_bounds__(kThreads)
    eom_pre_kernel(const double* __restrict__ t_rel, const double* __restrict__ y,
                   float* __restrict__ r_bf, int B, EomConsts c) {
  __shared__ double rows[kThreads * kDim];
  const long b0 = static_cast<long>(blockIdx.x) * kThreads;
  const int n = min(kThreads, B - static_cast<int>(b0));
  load_rows(rows, y + b0 * kDim, n);
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= n) return;
  const double* yi = rows + i * kDim;
  float m[3][3];
  double pole[3];
  earth_rotation(t_rel[b0 + i] + c.epoch0_tdb, m, pole);
  const float r0 = static_cast<float>(yi[0]), r1 = static_cast<float>(yi[1]),
              r2 = static_cast<float>(yi[2]);
  float* out = r_bf + (b0 + i) * 3;
  for (int k = 0; k < 3; ++k) out[k] = (m[k][0] * r0 + m[k][1] * r1) + m[k][2] * r2;
}

__global__ void __launch_bounds__(kThreads)
    eom_post_kernel(const double* __restrict__ t_rel, const double* __restrict__ y,
                    const float* __restrict__ a_bf, const double* __restrict__ sun_coeffs,
                    double* __restrict__ ydot, int B, EomConsts c) {
  __shared__ double rows[kThreads * kDim];
  const long b0 = static_cast<long>(blockIdx.x) * kThreads;
  const int n = min(kThreads, B - static_cast<int>(b0));
  load_rows(rows, y + b0 * kDim, n);
  __syncthreads();
  const int i = threadIdx.x;
  if (i < n) {
    double* yi = rows + i * kDim;
    const double t_tdb = t_rel[b0 + i] + c.epoch0_tdb;
    const double r[3] = {yi[0], yi[1], yi[2]};
    const double v[3] = {yi[3], yi[4], yi[5]};

    // two-body (orbital.py::two_body_accel)
    const double rmag = sqrt(sum3(r[0] * r[0], r[1] * r[1], r[2] * r[2]));
    const double rmag2 = rmag * rmag;
    double a[3];
    for (int k = 0; k < 3; ++k) a[k] = ((r[k] / rmag) * -c.mu) / rmag2;

    if (c.field) {  // gravity.py::Harmonics.accel, precision="split"
      float m[3][3];
      double pole[3];
      earth_rotation(t_tdb, m, pole);
      double u[3];
      for (int k = 0; k < 3; ++k) u[k] = r[k] / rmag;
      const double s = sum3(pole[0] * u[0], pole[1] * u[1], pole[2] * u[2]);
      const double q = (1.0 / rmag) * c.field_radius;
      const double rho2 = q * q;
      const double mu_r2 = (1.0 / rmag2) * c.field_mu;
      const double c2 = (mu_r2 * c.c2_coef) * rho2;
      const double e2 = 1.0 - (s * 5.0) * s;
      const double f2 = s * 2.0;
      double low[3];
      for (int k = 0; k < 3; ++k) low[k] = c2 * (e2 * u[k] + f2 * pole[k]);
      if (c.j3) {
        const double c3 = ((mu_r2 * c.c3_coef) * rho2) * q;
        const double e3 = s * 3.0 - ((s * s) * s) * 7.0;
        const double f3 = ((s * s) - 0.2) * 3.0;
        for (int k = 0; k < 3; ++k) low[k] = low[k] + c3 * (e3 * u[k] + f3 * pole[k]);
      }
      const float* ab = a_bf + (b0 + i) * 3;
      const float ab0 = ab[0], ab1 = ab[1], ab2 = ab[2];
      for (int k = 0; k < 3; ++k) {
        const float back = (m[0][k] * ab0 + m[1][k] * ab1) + m[2][k] * ab2;
        a[k] = a[k] + (low[k] + static_cast<double>(back));
      }
    } else {
      for (int k = 0; k < 3; ++k) a[k] = a[k] + 0.0;
    }

    if (c.srp || c.drag) {  // spacecraft_dyn.py: the force models in f32
      const float r32[3] = {static_cast<float>(r[0]), static_cast<float>(r[1]),
                            static_cast<float>(r[2])};
      const float v32[3] = {static_cast<float>(v[0]), static_cast<float>(v[1]),
                            static_cast<float>(v[2])};
      const float mass = static_cast<float>(yi[8] + c.dry_mass_kg);
      float f[3] = {0.0f, 0.0f, 0.0f}, g[3];
      if (c.srp) {
        float sun[3];
        sun_position(sun_coeffs, t_tdb, c, sun);
        srp_accel(r32, sun, static_cast<float>(yi[6]), mass, c, g);
        for (int k = 0; k < 3; ++k) f[k] = f[k] + g[k];
      }
      if (c.drag) {
        drag_accel(r32, v32, static_cast<float>(yi[7]), mass, c, g);
        for (int k = 0; k < 3; ++k) f[k] = f[k] + g[k];
      }
      for (int k = 0; k < 3; ++k) a[k] = a[k] + static_cast<double>(f[k]);
    }

    yi[0] = v[0];
    yi[1] = v[1];
    yi[2] = v[2];
    yi[3] = a[0];
    yi[4] = a[1];
    yi[5] = a[2];
    yi[6] = 0.0;
    yi[7] = 0.0;
    yi[8] = 0.0;
  }
  __syncthreads();
  double* dst = ydot + b0 * kDim;
  for (int k = threadIdx.x; k < n * kDim; k += kThreads) dst[k] = rows[k];
}

int grid(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// Both launch on `stream` and return a cudaError_t (0: launched). The caller
// checks devices, dtypes, shapes and contiguity, and passes B >= 1.
extern "C" int eom_pre_f64(const double* t_rel, const double* y, float* r_bf, int B, EomConsts c,
                           void* stream) {
  eom_pre_kernel<<<grid(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t_rel, y, r_bf, B, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int eom_post_f64(const double* t_rel, const double* y, const float* a_bf,
                            const double* sun_coeffs, double* ydot, int B, EomConsts c,
                            void* stream) {
  eom_post_kernel<<<grid(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t_rel, y, a_bf, sun_coeffs, ydot, B, c);
  return static_cast<int>(cudaGetLastError());
}
