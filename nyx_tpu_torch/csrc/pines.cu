// Pines spherical-harmonics gravity recursion, written by hand for Hopper
// (sm_90a). It replaces the Pallas TPU kernel
// nyx_tpu/dynamics/gravity_pallas.py::_pines_kernel and computes the same
// thing from the same packed table (nyx_tpu_torch/dynamics/gravity_pines.py
// ::pack_tables): for body-fixed positions r_bf [B, 3] f32, the
// non-spherical acceleration [B, 3] of a normalized spherical-harmonic
// field, accumulating degrees q in (q_lo, n_steps].
//
// What bounds it on an H100: arithmetic. At step k only orders m <= k+2 are
// nonzero; each needs 7 f32 operations for its Legendre row and 25 more for
// the four sums. A 21x21 field is ~9e3 operations a lane, a 70x70 one ~8e4,
// against 24 bytes of positions in and out a lane and a table read once per
// block. Built with --fmad=false (the kernel must round as its torch twin
// does), each operation issues alone: ~3.3e13 a second on 132 SMs.
// Tensor cores and wgmma do not apply: the recursion is elementwise along
// each order, with no matrix product anywhere. What keeps it from that bound
// (PERF.md has the shares): a warp steps all 32 columns of a group while
// only the orders m <= k+2 are nonzero (at 21x21, 672 column-steps for 273),
// and each lane also walks the power chain and the order sums alone.
//
// Design:
//  - one warp per lane (the batch element); thread l owns order m = c0 + l
//    of a group of 32 orders starting at c0. Orders are independent along
//    the degree recursion except for the column m+1 that the z and w sums
//    read: it comes from thread l+1 by one shuffle a step. A field wider
//    than 32 columns runs its groups one after the other (the triangle of
//    nonzero orders makes the later ones short); the first column of the
//    next group is computed once more beside each group, by thread 0, for
//    thread 31. Two to four orders a thread (fewer groups, more registers)
//    ran slower at every size tried;
//  - a group joins the recursion only once its lowest order can be nonzero
//    (c0 <= k + 2): a skipped row is exactly zero, so skipping it changes
//    no bit. The degree loop runs in stretches cut where the sums start
//    (k >= q_lo) and where the boundary column turns nonzero, each
//    compiled without those tests;
//  - the powers (s + i t)^m come from the sequential complex product the
//    twin uses, each thread walking the chain to its own orders;
//  - each order keeps its four sums over the degree loop; the warp then adds
//    them in the order m = 0, 1, ..., W-1 through shared memory, the order of
//    the twin's _sum_orders. With every operation the twin's and no FMA
//    contraction the two agree bit for bit;
//  - the table goes into shared memory column-interleaved, [2][steps][cols]
//    of float4: (b, c, diag, offdiag) and (C, S, vr01, vr11) of one column
//    and step are one 16-byte load each, neighbouring threads on
//    neighbouring columns. The transposing copy is cp.async, 4 bytes an
//    element, zero-filled past the table, so a column past the field reads
//    as a zero row and needs no guard;
//  - persistent blocks of `warps` warps (32, so an SM holds 32 warps: the
//    kernel fits the 64-register cap of a 1024-thread block without a
//    spill; blocks of 16 or 24 warps ran slower), as many blocks as fit on
//    the card; lanes are dealt out warp-major over the blocks, so a last
//    partial pass spreads over every SM. The whole table is staged once per
//    block when it fits beside the reduction scratch; otherwise two
//    buffers of `chunk_steps` degree steps stream it, only the current
//    group's columns, so the footprint stays fixed whatever the degree.
//    The block plan is
//    gravity_pines.py::pines_launch_plan, passed in as arguments.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRed = 33;  // one component's row of a warp's reduction scratch
constexpr unsigned kFull = 0xffffffffu;

template <bool B>
struct Flag {  // a compile-time switch passed to a generic lambda
  static constexpr bool on = B;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
pines_kernel(const float* __restrict__ r_bf, const float* __restrict__ tab,
             float* __restrict__ out, int B, int n_steps, int W, int W_pad, int q_lo, float mu,
             float radius, float inv_radius, float diag1, int buffers, int chunk_steps,
             int cols) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const bool whole = buffers == 1;
  const int n_chunks = (n_steps + chunk_steps - 1) / chunk_steps;
  const int part = chunk_steps * cols;  // float4s of one half of a buffer
  float* red = reinterpret_cast<float*>(smem4 + (whole ? 2 : 4) * part) + warp * 4 * kRed;
  const int n_groups = (W + 31) / 32;
  // lane of warp w in pass p: p * per_pass + w * gridDim.x + blockIdx.x. Every
  // block holds a lane in each of its passes (grid <= ceil(B / warps) <= B),
  // and all its warps run the same passes: no thread leaves before a barrier
  const int per_pass = gridDim.x * warps;
  const int n_iter = (B - static_cast<int>(blockIdx.x) + per_pass - 1) / per_pass;
  const int n_loads = whole ? 1 : n_iter * n_groups * n_chunks;

  // load g, by every thread: chunk g % n_chunks of group (g / n_chunks) %
  // n_groups into buffer g & 1, as one cp.async group (empty where the
  // chunk ends before the group's first nonzero row)
  auto stage = [&](int g) {
    if (g < n_loads) {
      const int c = g % n_chunks;
      const int c0 = whole ? 0 : ((g / n_chunks) % n_groups) * 32;
      const int k0 = c * chunk_steps, k1 = min(n_steps, k0 + chunk_steps);
      float* buf = reinterpret_cast<float*>(smem4 + (g & 1) * 2 * part);
      for (int row = warp; c0 <= k1 + 1 && row < (k1 - k0) * 8; row += warps) {
        const int kl = row >> 3, r = row & 7;
        const float* src = tab + static_cast<size_t>((k0 + kl) * 8 + r) * W_pad + c0;
        float* dst = buf + ((r >> 2) * chunk_steps + kl) * cols * 4 + (r & 3);
        for (int col = l; col < cols; col += 32) {
          const bool valid = c0 + col < W_pad;
          cp_async4(dst + 4 * col, valid ? src + col : tab, valid);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  stage(1);
  if (whole) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  const float sqrt3 = 1.7320508075688772f;
  int g = 0;  // loads consumed (streamed)
  for (int it = 0; it < n_iter; ++it) {
    const int lane = it * per_pass + warp * gridDim.x + blockIdx.x;
    const bool active = lane < B;  // warp-uniform
    float s = 0.f, t = 0.f, u = 0.f, rho = 0.f, mu_over_r = 0.f;
    if (active) {
      const float x = r_bf[3 * lane], y = r_bf[3 * lane + 1], z = r_bf[3 * lane + 2];
      const float r = sqrtf(x * x + y * y + z * z);
      const float inv_r = 1.0f / r;
      s = x * inv_r;
      t = y * inv_r;
      u = z * inv_r;
      rho = radius * inv_r;
      mu_over_r = mu * inv_r;
    }
    // (s + i t)^m and (s + i t)^(m-1) of this thread's order m, the chain
    // walked on from one group's order to the next
    float rm = 1.f, im = 0.f, rm1 = 0.f, im1 = 0.f;
    int cm = 0;
    float acc = 0.f;  // thread c < 4: component c summed over the orders so far

    for (int grp = 0; grp < n_groups; ++grp) {
      const int c0 = 32 * grp;
      const int m = c0 + l;
      const int c1 = c0 + 32;  // first column of the next group
      const bool has_next = c1 < W;
      // this thread's column in a buffer (past the field, a zero one), and the next group's first
      const int col = whole ? min(m, cols - 1) : l;
      const int col_next = whole ? c1 : 32;
      const float mf = static_cast<float>(m);
      // Legendre rows of degree 0 (one-hot at m = 0) and degree 1
      // ([u sqrt3, diag1, 0, ...]); n1 is the degree-1 row at m+1
      float a2 = (m == 0) ? 1.f : 0.f;
      float a1 = (m == 0) ? u * sqrt3 : ((m == 1) ? diag1 : 0.f);
      float n1 = (m == 0) ? diag1 : 0.f;
      float px = 0.f, py = 0.f, pz = 0.f, pw = 0.f;
      // past the field (m >= W) the powers stay as they were: finite, they
      // meet only zero coefficients, and those orders' sums are never added
      if (active && m < W) {
        while (cm < m) {
          rm1 = rm;
          im1 = im;
          const float nr = s * rm - t * im;
          const float ni = s * im + t * rm;
          rm = nr;
          im = ni;
          ++cm;
        }
      }
      float e1 = 0.f, e2 = 0.f;  // boundary column c1: rows of degree n-1, n-2
      float rho_q = mu_over_r * rho;

      for (int c = 0; c < n_chunks; ++c) {
        const float4* buf = smem4;
        if (!whole) {
          buf = smem4 + (g & 1) * 2 * part;
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          __syncthreads();  // load g has landed, every thread's part of it
        }
        const int k0 = c * chunk_steps, k1 = min(n_steps, k0 + chunk_steps);
        if (active) {
          // before the group's first nonzero row only rho_q moves; then the
          // steps run in up to three stretches, cut where the degrees start
          // to accumulate (k >= q_lo) and where the boundary column turns
          // nonzero (k >= c1 - 2), each compiled without the tests
          const int kb = min(k1, max(k0, c0 - 2));
          for (int k = k0; k < kb; ++k) rho_q = rho_q * rho;
          const float4* pm = buf + (kb - k0) * cols + col;  // (b, c, diag, offdiag) of m
          const float4* pb = buf + (kb - k0) * cols + col_next;
          auto stretch = [&](auto acc_flag, auto boundary_flag, int ka, int kz) {
            constexpr bool acc_on = decltype(acc_flag)::on;
            constexpr bool boundary = decltype(boundary_flag)::on;
            // not unrolled: unrolled, the step spills at the 64-register cap
#pragma unroll 1
            for (int k = ka; k < kz; ++k, pm += cols, pb += cols) {
              rho_q = rho_q * rho;
              // row n = u b row_{n-1} - c row_{n-2} + diag + offdiag u
              float bn = 0.f;
              if constexpr (boundary) {
                const float4 tb = *pb;
                bn = u * tb.x * e1 - tb.y * e2 + tb.z + tb.w * u;
              }
              const float4 tm = *pm;
              const float an = u * tm.x * a1 - tm.y * a2 + tm.z + tm.w * u;
              // the new row at m+1: from thread l+1, the boundary column for thread 31
              const float pn = __shfl_sync(kFull, l == 0 ? bn : an, (l + 1) & 31);
              if constexpr (acc_on) {
                const float rr = rho_q * inv_radius;
                const float4 ta = pm[part];  // (C, S, vr01, vr11)
                const float d = ta.x * rm + ta.y * im;
                const float e = ta.x * rm1 + ta.y * im1;
                const float f = ta.y * rm1 - ta.x * im1;
                px += (rr * mf) * a1 * e;
                py += (rr * mf) * a1 * f;
                pz += (rr * ta.z) * n1 * d;
                pw -= (rr * ta.w) * pn * d;
              }
              a2 = a1;
              a1 = an;
              n1 = pn;
              if constexpr (boundary) {
                e2 = e1;
                e1 = bn;
              }
            }
          };
          using yes = Flag<true>;
          using no = Flag<false>;
          const int kq = min(k1, max(kb, q_lo));                    // first step that accumulates
          const int kn = has_next ? min(k1, max(kb, c1 - 2)) : k1;  // first nonzero boundary row
          const int lo = min(kq, kn), hi = max(kq, kn);
          stretch(no{}, no{}, kb, lo);
          if (kq <= kn)
            stretch(yes{}, no{}, lo, hi);
          else
            stretch(no{}, yes{}, lo, hi);
          stretch(yes{}, yes{}, hi, k1);
        }
        if (!whole) {
          __syncthreads();  // every warp is done with this buffer
          stage(g + 2);
          ++g;
        }
      }

      if (active) {  // add this group's orders, m ascending, into threads 0..3
        red[l] = px;
        red[kRed + l] = py;
        red[2 * kRed + l] = pz;
        red[3 * kRed + l] = pw;
        __syncwarp();
        if (l < 4) {
          const float* rc = red + l * kRed;
          const int nc = min(32, W - c0);
          for (int i = 0; i < nc; ++i) acc = acc + rc[i];
        }
        __syncwarp();
      }
    }

    if (active) {
      const float aw = __shfl_sync(kFull, acc, 3);
      if (l < 3) {
        const float dir = (l == 0) ? s : ((l == 1) ? t : u);
        out[3 * lane + l] = acc + aw * dir;
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns a cudaError_t: a plan the kernel cannot
// run, or a launch the device refuses, is reported here. The caller checks
// shapes, types and contiguity and passes gravity_pines.py::pines_launch_plan:
// `warps` a block, `buffers` (1: the whole table, staged once; 2: streamed)
// of `chunk_steps` degree steps and `cols` columns, and `smem` bytes of
// dynamic shared memory.
extern "C" int pines_accel_f32(const float* r_bf, const float* tab, float* out, int B, int n_steps,
                               int W, int W_pad, int q_lo, float mu, float radius, float inv_radius,
                               float diag1, int warps, int buffers, int chunk_steps, int cols,
                               int smem, void* stream) {
  const long need = 32L * buffers * chunk_steps * cols + 16L * warps * kRed;
  // whole: every step, every column of the field and a zero one past it;
  // streamed: one group's 32 columns and the first of the next
  const bool shape_ok = (buffers == 1) ? chunk_steps == n_steps && cols > W
                                       : buffers == 2 && chunk_steps >= 1 && cols > 32;
  if (warps < 1 || warps * 32 > kMaxThreads || smem < need || !shape_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks the card holds at once for this plan, found once per device and
  // plan; host threads (the shards of a mesh) launch at once, so the table
  // and the kernel's shared-memory limit, raised to the most any launch on
  // the device asked for, change under a lock
  static std::mutex plans_lock;
  static std::map<std::tuple<int, int, int>, int> resident_of;
  static std::map<int, int> smem_limit;
  int resident = 0;
  {
    std::lock_guard<std::mutex> guard(plans_lock);
    const auto key = std::make_tuple(dev, warps, smem);
    const auto hit = resident_of.find(key);
    if (hit != resident_of.end()) {
      resident = hit->second;
    } else {
      if (smem > smem_limit[dev]) {
        err = cudaFuncSetAttribute(pines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_limit[dev] = smem;
      }
      int n_sm = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pines_kernel, warps * 32, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      resident = resident_of[key] = per_sm * n_sm;
    }
  }
  const int blocks = std::min((B + warps - 1) / warps, resident);
  pines_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      r_bf, tab, out, B, n_steps, W, W_pad, q_lo, mu, radius, inv_radius, diag1, buffers,
      chunk_steps, cols);
  return static_cast<int>(cudaGetLastError());
}
