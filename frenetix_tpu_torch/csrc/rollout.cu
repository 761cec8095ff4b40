// The candidate rollout around K1 (K2): K2a before K1, K2b after it.
//
// Replaces no TPU kernel: the JAX package leaves
// frenetix_tpu/ops/kinematics.py::rollout_candidates to XLA's fusion.  The
// port's plain twin (frenetix_tpu_torch/ops/kinematics.py::
// rollout_candidates_plain, the CPU path of rollout_candidates) runs it as
// ~335 PyTorch elementwise kernels, each temporary written to and read back
// from device memory, and one scan (torch.cummax) for the heading carried
// over standstill steps.  On the card the rollout is three launches:
//
//   K2a  the (M, 13) sampling matrix -> the longitudinal (quartic, or
//        quintic in stopping mode) and lateral quintic coefficients,
//        traj_len, per step s, s', s'' (constant-velocity extension past
//        t1) and d, d', d''; the segment index, the window offset and the
//        factor of each step's table lookup: K1's global rows and lambdas;
//        besides, its last blocks lay the agents' reference tables end to
//        end as K1's (A*R, 5 + K) table.
//   K1   unchanged (csrc/table_interp.cu): the lerp of the table rows.
//   K2b  the Frenet state again from the matrix (recomputing it costs a
//        few hundred operations a step; reading it back would cost 20 bytes
//        a step), K1's five columns -> alpha (wrapped), theta_cl and theta_gl
//        with the standstill carry, kappa_gl, v, a, the yaw-rate and
//        kappa-rate differences, the eleven infeasibility slots, x and y,
//        feasible and valid.
//
// Design: one warp per candidate row, lane = time step.  N + 1 = 31 fits a
// warp; a longer horizon loops over chunks of 32 steps and carries what the
// next chunk needs (the slots' or, the last seen heading, the previous
// step's theta_gl and kappa_gl), so any n_steps works.  The 13 matrix
// columns are loaded by lanes 0-12 and shuffled to the warp.  A row's any()
// is __ballot_sync; torch.diff is __shfl_up_sync; the cummax/gather carry is
// the highest seen lane at or below each lane (a ballot, __clz and a
// shuffle).  Lane t stores element row * (N + 1) + t, so a warp's stores
// are consecutive.
//
// Bytes (float32, per step: K2a writes six fields, the row and the factor,
// 32 B; K1 reads 8 B and writes 4 (5 + K) B; K2b reads K1's five columns,
// 20 B, and writes eight fields, 32 B; per row the matrix twice, the
// coefficients, traj_len and the slots): 120 B a step with K = 2 against the
// 56 B of the Rollout's fourteen (M, N+1) fields, ~2.1x that floor.  Dense
// (34,816 x 31 steps): ~135 MB, 0.040 ms at 3.35 TB/s; floor ~64 MB,
// 0.019 ms.  Operations are a few hundred per step with six
// transcendentals, far below the bytes.
//
// Arithmetic: the twin's operation order, one rounding per operation
// (--fmad=false, no fast math: IEEE division, rint for torch.round, the
// full-precision atan2, cos, tan, sin and fmod).  Where the twin divides a
// tensor by a Python number it runs on the card as a product with the
// reciprocal (PyTorch's CUDA division by a CPU scalar), and so do these
// kernels (1/dt, 1/3, 1e-5); a Python number divided by a tensor is the
// tensor's reciprocal times the number (Tensor.__rtruediv__).  Python
// numbers are rounded to the tensors' type first, as PyTorch does.  So K2
// equals the twin bitwise on the card, as K1 and Q do.

#include <cstdint>

#include <cuda_runtime.h>

// Everything the kernels take; the wrapper fills it (ops/rollout_kernel.py,
// `_Args`, the same fields in the same order).  Strides count elements.  It
// lies outside the unnamed namespace, so the C entries that take it keep
// their external linkage.
struct Args {
  const void* matrix;                // (A * M, 13), contiguous
  const void* ref_s;                 // (A_t, R) arclengths, uniform
  int64_t s_sa, s_sr;
  const void* theta;                 // (A_t, R)
  int64_t th_sa, th_sr;
  const void* kappa;
  int64_t k_sa, k_sr;
  const void* kappa_d;
  int64_t kd_sa, kd_sr;
  const void* xy;                    // (A_t, R, 2)
  int64_t xy_sa, xy_sr, xy_sc;
  const void* extras;                // (A_t, R, K) or null
  int64_t ex_sa, ex_sr, ex_sc;
  const void* x0;                    // (A,) initial orientation
  int64_t x0_sa;
  int64_t n_agents;                  // A: leading rows of the matrix
  int64_t n_rows;                    // M per agent
  int64_t n1;                        // N + 1
  int64_t table_rows;                // R
  int64_t table_agents;              // A_t: A, or 1 for one shared table
  int64_t n_extra;                   // K
  int64_t window;                    // W < R, or 0: the whole table
  double dt, a_max, kappa_max, kappa_dot_max, v_switch, a_max_v_switch;
  // K2a's outputs
  void *s, *s_vel, *s_acc, *d, *d_vel, *d_acc;
  void *coeffs_lon, *coeffs_lat, *traj_len, *gidx, *lam, *table;
  // K1's output, (5 + K, A * M * (N + 1))
  const void* field;
  // K2b's outputs
  void *theta_gl, *theta_cl, *v, *a, *kappa_gl, *kappa_dot, *x, *y;
  void *feasible, *valid, *slots;
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kRowsPerBlock = kThreadsPerBlock / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMatrixCols = 13;
constexpr int kRefCols = 5;          // theta, kappa, kappa_d, x, y
constexpr int kSlots = 11;

__device__ __forceinline__ float floor_(float v) { return floorf(v); }
__device__ __forceinline__ double floor_(double v) { return floor(v); }
__device__ __forceinline__ float rint_(float v) { return rintf(v); }
__device__ __forceinline__ double rint_(double v) { return rint(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float atan2_(float a, float b) { return atan2f(a, b); }
__device__ __forceinline__ double atan2_(double a, double b) { return atan2(a, b); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float tan_(float v) { return tanf(v); }
__device__ __forceinline__ double tan_(double v) { return tan(v); }

// torch.minimum: NaN propagated
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ T position(const T* c, T tau) {
  return c[0] + tau * (c[1] + tau * (c[2] + tau * (c[3] + tau * (c[4] + tau * c[5]))));
}

template <typename T>
__device__ __forceinline__ T velocity(const T* c, T tau) {
  return c[1] + tau * (T(2) * c[2] + tau * (T(3) * c[3] + tau * (T(4) * c[4]
                                                                 + tau * T(5) * c[5])));
}

template <typename T>
__device__ __forceinline__ T acceleration(const T* c, T tau) {
  return T(2) * c[2] + tau * (T(6) * c[3] + tau * (T(12) * c[4] + tau * T(20) * c[5]));
}

// ops/polynomials.py::quartic_coeffs (invT / 3.0 as a product with 1/3)
template <typename T>
__device__ __forceinline__ void quartic(T xs, T vxs, T axs, T vt, T tt, T* c) {
  const T c1 = vt - vxs - axs * tt;
  const T c2 = -axs;
  const T inv = T(1) / tt;
  const T inv2 = inv * inv;
  const T third = T(1) / T(3);
  c[0] = xs;
  c[1] = vxs;
  c[2] = T(0.5) * axs;
  c[3] = c1 * inv2 - c2 * (inv * third);
  c[4] = T(-0.5) * c1 * inv2 * inv + T(0.25) * c2 * inv2;
  c[5] = T(0);
}

// ops/polynomials.py::quintic_coeffs
template <typename T>
__device__ __forceinline__ void quintic(T xs, T vxs, T axs, T xe, T vxe, T axe, T tt,
                                        T* c) {
  const T t2 = tt * tt;
  const T b0 = xe - xs - vxs * tt - T(0.5) * axs * t2;
  const T b1 = vxe - vxs - axs * tt;
  const T b2 = axe - axs;
  const T inv = T(1) / tt;
  const T inv2 = inv * inv;
  const T inv3 = inv2 * inv;
  c[0] = xs;
  c[1] = vxs;
  c[2] = T(0.5) * axs;
  c[3] = T(0.5) * (T(20) * b0 - T(8) * b1 * tt + b2 * t2) * inv3;
  c[4] = T(0.5) * (T(-30) * b0 + T(14) * b1 * tt - T(2) * b2 * t2) * inv3 * inv;
  c[5] = T(0.5) * (T(12) * b0 - T(6) * b1 * tt + b2 * t2) * inv3 * inv2;
}

// One candidate row's polynomials and the per-agent lookup constants, the
// same in every lane of its warp.
template <typename T>
struct Row {
  T lon[6], lat[6];
  T s0, t_end, s_end, v_end, span, len_t;   // len_t = traj_len * dt
  int traj_len;
  // the agent's table: first and last arclength, spacing, window offset
  T s_first, s_last, ds;
  int offset;
};

// Frenet state of one step, as the twin has it after the ṡ zeroing
template <typename T>
struct Step {
  T s, s_vel, s_acc, d, d_vel, d_acc;
  bool neg_svel;                      // ṡ < -eps before the zeroing
  bool in_mask;                       // t < traj_len
};

// The 13 matrix columns of `row` in every lane: lanes 0-12 load, a shuffle
// each hands them out.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ matrix, int64_t row,
                                         int lane, T* m) {
  T mine = T(0);
  if (lane < kMatrixCols) mine = matrix[row * kMatrixCols + lane];
#pragma unroll
  for (int c = 0; c < kMatrixCols; ++c) m[c] = __shfl_sync(kFull, mine, c);
}

template <typename T, bool kLowVel, bool kQuintic>
__device__ __forceinline__ Row<T> plan_row(const Args& p, const T* m, int64_t agent) {
  Row<T> r;
  const T dt = static_cast<T>(p.dt);
  const T inv_dt = T(1) / dt;
  const T t1 = m[1];
  r.s0 = m[2];
  if (kQuintic) {
    quintic<T>(m[2], m[3], m[4], m[5], T(0), m[6], t1, r.lon);
  } else {
    quartic<T>(m[2], m[3], m[4], m[5], t1, r.lon);
  }
  int len = static_cast<int>(rint_(t1 * inv_dt)) + 1;
  const int n1 = static_cast<int>(p.n1);
  len = len < 2 ? 2 : (len > n1 ? n1 : len);
  r.traj_len = len;
  r.t_end = static_cast<T>(len - 1) * dt;
  r.len_t = static_cast<T>(len) * dt;
  r.s_end = position(r.lon, r.t_end);
  r.v_end = velocity(r.lon, r.t_end);
  T lat_t = t1;
  r.span = T(0);
  if (kLowVel) {
    r.span = r.s_end - r.s0;
    lat_t = r.span > T(0) ? r.span : t1;
  }
  quintic<T>(m[7], m[8], m[9], m[10], m[11], m[12], lat_t, r.lat);

  const int64_t ta = p.table_agents == 1 ? 0 : agent;
  const T* ref_s = static_cast<const T*>(p.ref_s) + ta * p.s_sa;
  r.s_first = ref_s[0];
  r.ds = ref_s[p.s_sr] - r.s_first;
  r.s_last = ref_s[(p.table_rows - 1) * p.s_sr];
  r.offset = 0;
  if (p.window > 0) {
    // the window's anchor is s0 of the agent's first row
    const T anchor = static_cast<const T*>(p.matrix)[agent * p.n_rows * kMatrixCols + 2];
    int off = static_cast<int>(floor_(anchor / r.ds)) - static_cast<int>(p.window / 8);
    const int hi = static_cast<int>(p.table_rows - p.window);
    r.offset = off < 0 ? 0 : (off > hi ? hi : off);
  }
  return r;
}

template <typename T, bool kLowVel>
__device__ __forceinline__ Step<T> step_state(const Args& p, const Row<T>& r, int t) {
  const T dt = static_cast<T>(p.dt);
  const T eps = static_cast<T>(1e-5);
  const T tgrid = static_cast<T>(t) * dt;
  Step<T> st;
  st.in_mask = tgrid < r.len_t;
  const T tau = minimum(tgrid, r.t_end);
  if (st.in_mask) {
    st.s = position(r.lon, tau);
    st.s_vel = velocity(r.lon, tau);
    st.s_acc = acceleration(r.lon, tau);
  } else {
    st.s = r.s_end + (tgrid - r.t_end) * r.v_end;
    st.s_vel = r.v_end;
    st.s_acc = T(0);
  }
  T tau_lat = tau;
  if (kLowVel) tau_lat = st.in_mask ? st.s - r.s0 : r.span;
  st.d = position(r.lat, tau_lat);
  st.d_vel = st.in_mask ? velocity(r.lat, tau_lat) : T(0);
  st.d_acc = st.in_mask ? acceleration(r.lat, tau_lat) : T(0);
  st.neg_svel = st.s_vel < -eps;
  if (abs_(st.s_vel) < eps) st.s_vel = T(0);
  return st;
}

// geometry/frenet.py::segment_index and the window of interp_ref_tables:
// the global row (agent offset included) and lambda of one query, and
// whether it lies in the domain (and the window)
template <typename T>
__device__ __forceinline__ bool lookup(const Args& p, const Row<T>& r, int64_t agent, T s,
                                       int32_t* gidx, T* lam) {
  const T q = s / r.ds;
  const int last = static_cast<int>(p.table_rows) - 2;
  int idx = static_cast<int>(floor_(q));
  idx = idx < 0 ? 0 : (idx > last ? last : idx);
  *lam = q - static_cast<T>(idx);
  bool in_dom = (s >= r.s_first) & (s <= r.s_last);
  int row = idx;
  if (p.window > 0) {
    const int w2 = static_cast<int>(p.window) - 2;
    const int local = idx - r.offset;
    in_dom = in_dom & (local >= 0) & (local <= w2);
    row = r.offset + (local < 0 ? 0 : (local > w2 ? w2 : local));
  }
  const int base = p.table_agents == 1 ? 0
                                       : static_cast<int>(agent * p.table_rows);
  *gidx = row + base;
  return in_dom;
}

template <typename T, bool kLowVel, bool kQuintic>
__global__ void __launch_bounds__(kThreadsPerBlock) k2a_kernel(const Args p,
                                                                int64_t row_blocks) {
  if (blockIdx.x >= row_blocks) {
    // K1's table: row (agent, r) = theta, kappa, kappa_d, x, y, extras
    const int64_t i = (static_cast<int64_t>(blockIdx.x) - row_blocks) * kThreadsPerBlock
                      + threadIdx.x;
    if (i >= p.table_agents * p.table_rows) return;
    const int64_t a = i / p.table_rows, rr = i % p.table_rows;
    const int64_t cols = kRefCols + p.n_extra;
    T* out = static_cast<T*>(p.table) + i * cols;
    out[0] = static_cast<const T*>(p.theta)[a * p.th_sa + rr * p.th_sr];
    out[1] = static_cast<const T*>(p.kappa)[a * p.k_sa + rr * p.k_sr];
    out[2] = static_cast<const T*>(p.kappa_d)[a * p.kd_sa + rr * p.kd_sr];
    const T* xy = static_cast<const T*>(p.xy) + a * p.xy_sa + rr * p.xy_sr;
    out[3] = xy[0];
    out[4] = xy[p.xy_sc];
    const T* ex = static_cast<const T*>(p.extras) + a * p.ex_sa + rr * p.ex_sr;
    for (int64_t k = 0; k < p.n_extra; ++k) out[kRefCols + k] = ex[k * p.ex_sc];
    return;
  }
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= p.n_agents * p.n_rows) return;       // whole warps leave together
  const int64_t agent = row / p.n_rows;
  T m[kMatrixCols];
  load_row(static_cast<const T*>(p.matrix), row, lane, m);
  const Row<T> r = plan_row<T, kLowVel, kQuintic>(p, m, agent);
  // lane j < 6 writes lon[j], lane 6 + j lat[j]: picked by an unrolled
  // loop, since an index that depends on the lane would put the row's
  // coefficients in local memory
  T coeff = T(0);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (lane == j) coeff = r.lon[j];
    if (lane == 6 + j) coeff = r.lat[j];
  }
  if (lane < 6) {
    static_cast<T*>(p.coeffs_lon)[row * 6 + lane] = coeff;
  } else if (lane < 12) {
    static_cast<T*>(p.coeffs_lat)[row * 6 + lane - 6] = coeff;
  } else if (lane == 12) {
    static_cast<int32_t*>(p.traj_len)[row] = r.traj_len;
  }
  for (int64_t base = 0; base < p.n1; base += kWarp) {
    const int t = static_cast<int>(base) + lane;
    if (t >= p.n1) break;
    const Step<T> st = step_state<T, kLowVel>(p, r, t);
    const int64_t e = row * p.n1 + t;
    static_cast<T*>(p.s)[e] = st.s;
    static_cast<T*>(p.s_vel)[e] = st.s_vel;
    static_cast<T*>(p.s_acc)[e] = st.s_acc;
    static_cast<T*>(p.d)[e] = st.d;
    static_cast<T*>(p.d_vel)[e] = st.d_vel;
    static_cast<T*>(p.d_acc)[e] = st.d_acc;
    int32_t g;
    T l;
    lookup(p, r, agent, st.s, &g, &l);
    static_cast<int32_t*>(p.gidx)[e] = g;
    static_cast<T*>(p.lam)[e] = l;
  }
}

template <typename T, bool kLowVel, bool kQuintic>
__global__ void __launch_bounds__(kThreadsPerBlock) k2b_kernel(const Args p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= p.n_agents * p.n_rows) return;       // whole warps leave together
  const int64_t agent = row / p.n_rows;
  T m[kMatrixCols];
  load_row(static_cast<const T*>(p.matrix), row, lane, m);
  const Row<T> r = plan_row<T, kLowVel, kQuintic>(p, m, agent);

  const T dt = static_cast<T>(p.dt);
  const T inv_dt = T(1) / dt;
  const T eps = static_cast<T>(1e-5);
  const T kappa_max = static_cast<T>(p.kappa_max);
  const T kappa_dot_max = static_cast<T>(p.kappa_dot_max);
  const T a_max = static_cast<T>(p.a_max);
  const T v_switch = static_cast<T>(p.v_switch);
  const T a_max_v_switch = static_cast<T>(p.a_max_v_switch);
  const T moving_min = static_cast<T>(0.001);
  const T two_pi = static_cast<T>(6.283185307179586);
  const T scale5 = static_cast<T>(1e5);
  const T inv_scale5 = T(1) / scale5;
  const T x0 = kLowVel ? T(0) : static_cast<const T*>(p.x0)[agent * p.x0_sa];
  const int64_t n_query = p.n_agents * p.n_rows * p.n1;
  const T* field = static_cast<const T*>(p.field);

  unsigned slots = 0;                 // bit j: slot j violated at some step
  T held = x0;                        // the last seen step's seeded theta_gl
  T prev_theta = T(0), prev_kappa = T(0);
  for (int64_t base = 0; base < p.n1; base += kWarp) {
    const int t = static_cast<int>(base) + lane;
    const bool live = t < p.n1;
    const Step<T> st = step_state<T, kLowVel>(p, r, live ? t : 0);
    int32_t g;
    T l;
    const bool in_dom = lookup(p, r, agent, st.s, &g, &l);
    const int64_t e = row * p.n1 + (live ? t : 0);
    const T theta_lerp = field[e];
    const T k_r = field[n_query + e];
    const T k_r_d = field[2 * n_query + e];
    const T ref_x = field[3 * n_query + e];
    const T ref_y = field[4 * n_query + e];
    const T alpha = fmod_(theta_lerp, two_pi);

    // Werling A.8
    const bool moving = st.s_vel > moving_min;
    T dp = st.d_vel, dpp = st.d_acc;
    if (!kLowVel) {
      dp = moving ? st.d_vel / st.s_vel : T(0);
      const T ddot = st.d_acc - dp * st.s_acc;
      dpp = moving ? ddot / (st.s_vel * st.s_vel) : T(0);
    }
    const T theta_cl_pt = atan2_(dp, T(1));
    const T theta_gl_pt = theta_cl_pt + alpha;
    T theta_gl = theta_gl_pt, theta_cl = theta_cl_pt;
    if (!kLowVel) {
      // the seeded value at the last step at or before t that moved (step 0
      // always counts), else the carry from the chunks before
      const bool seen = live && (moving || t == 0);
      const T seeded = moving ? theta_gl_pt : x0;
      const unsigned seen_bits = __ballot_sync(kFull, seen);
      const unsigned upto = seen_bits & (lane == kWarp - 1 ? kFull : (2u << lane) - 1u);
      const int src = upto ? kWarp - 1 - __clz(upto) : lane;
      const T from = __shfl_sync(kFull, seeded, src);
      const T hold = upto ? from : held;
      const int last = seen_bits ? kWarp - 1 - __clz(seen_bits) : 0;
      const T last_seeded = __shfl_sync(kFull, seeded, last);
      if (seen_bits) held = last_seeded;
      theta_gl = moving ? theta_gl_pt : hold;
      theta_cl = moving ? theta_cl_pt : theta_gl - alpha;
    }

    const T one_krd = T(1) - k_r * st.d;
    const T cos_t = cos_(theta_cl);
    const T tan_t = tan_(theta_cl);
    const T cos_ratio = cos_t / one_krd;
    const T kappa_gl = (dpp + (k_r * dp + k_r_d * st.d) * tan_t) * cos_t * cos_ratio * cos_ratio
                       + cos_ratio * k_r;
    const T v = st.s_vel * (one_krd / cos_t);
    const T a = st.s_acc * (one_krd / cos_t) + (st.s_vel * st.s_vel / cos_t) * (
        one_krd * tan_t * (kappa_gl * (one_krd / cos_t) - k_r) - (k_r_d * st.d + k_r * dp));

    // [0, diff(.)] along the steps, across chunks
    T up_theta = __shfl_up_sync(kFull, theta_gl, 1);
    T up_kappa = __shfl_up_sync(kFull, kappa_gl, 1);
    if (lane == 0) {
      up_theta = prev_theta;
      up_kappa = prev_kappa;
    }
    prev_theta = __shfl_sync(kFull, theta_gl, kWarp - 1);
    prev_kappa = __shfl_sync(kFull, kappa_gl, kWarp - 1);
    const bool first = t == 0;
    const T yaw = first ? T(0) : (theta_gl - up_theta) * inv_dt;
    const T yaw_r = rint_(yaw * scale5) * inv_scale5;
    const T kappa_diff = first ? T(0) : kappa_gl - up_kappa;
    const T kappa_rate = first ? T(0) : kappa_diff * inv_dt;
    const bool fast = v > v_switch;
    const T a_max_v = fast ? (T(1) / v) * a_max_v_switch : a_max;

    const bool viol[kSlots] = {
        false,
        abs_(st.s_acc) > a_max,
        st.neg_svel,
        !in_dom,
        v < -eps,
        abs_(kappa_gl) > kappa_max,
        abs_(yaw_r) > kappa_max * v,
        abs_(kappa_rate) > kappa_dot_max,
        (a < -a_max) | (a > a_max_v),
        !in_dom,
        st.neg_svel,
    };
#pragma unroll
    for (int j = 1; j < kSlots; ++j) {
      if (__ballot_sync(kFull, live && viol[j])) slots |= 1u << j;
    }
    if (live) {
      static_cast<T*>(p.theta_gl)[e] = theta_gl;
      static_cast<T*>(p.theta_cl)[e] = theta_cl;
      static_cast<T*>(p.v)[e] = v;
      static_cast<T*>(p.a)[e] = a;
      static_cast<T*>(p.kappa_gl)[e] = kappa_gl;
      static_cast<T*>(p.kappa_dot)[e] = kappa_diff;
      static_cast<T*>(p.x)[e] = ref_x - st.d * sin_(theta_lerp);
      static_cast<T*>(p.y)[e] = ref_y + st.d * cos_(theta_lerp);
    }
  }
  const bool feasible = (slots & 0x1feu) == 0;            // slots 1-8
  const bool valid = (slots & ((1u << 10) | (1u << 9))) == 0;
  if (!(feasible && valid)) slots |= 1u;
  if (lane < kSlots) static_cast<bool*>(p.slots)[row * kSlots + lane] = (slots >> lane) & 1u;
  if (lane == 0) {
    static_cast<bool*>(p.feasible)[row] = feasible;
    static_cast<bool*>(p.valid)[row] = valid;
  }
}

int64_t row_blocks(const Args& p) {
  return (p.n_agents * p.n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

template <typename T, bool kLowVel, bool kQuintic>
int launch_k2a(const Args& p, cudaStream_t stream) {
  const int64_t rows = row_blocks(p);
  const int64_t table = (p.table_agents * p.table_rows + kThreadsPerBlock - 1)
                        / kThreadsPerBlock;
  k2a_kernel<T, kLowVel, kQuintic>
      <<<static_cast<unsigned int>(rows + table), kThreadsPerBlock, 0, stream>>>(p, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kLowVel, bool kQuintic>
int launch_k2b(const Args& p, cudaStream_t stream) {
  k2b_kernel<T, kLowVel, kQuintic>
      <<<static_cast<unsigned int>(row_blocks(p)), kThreadsPerBlock, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k2a(const Args* p, int low_vel, int quintic, void* stream) {
  if (p->n_agents * p->n_rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (low_vel) {
    return quintic ? launch_k2a<T, true, true>(*p, s) : launch_k2a<T, true, false>(*p, s);
  }
  return quintic ? launch_k2a<T, false, true>(*p, s) : launch_k2a<T, false, false>(*p, s);
}

template <typename T>
int k2b(const Args* p, int low_vel, int quintic, void* stream) {
  if (p->n_agents * p->n_rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (low_vel) {
    return quintic ? launch_k2b<T, true, true>(*p, s) : launch_k2b<T, true, false>(*p, s);
  }
  return quintic ? launch_k2b<T, false, true>(*p, s) : launch_k2b<T, false, false>(*p, s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each function launches on the
// calling thread's current device, which must own `stream` and the pointers
// (the wrapper makes it current).  It returns the CUDA error code of the
// launch (0 on success) and does not synchronise.
extern "C" {

int rollout_k2a_f32(const Args* p, int low_vel, int quintic, void* stream) {
  return k2a<float>(p, low_vel, quintic, stream);
}

int rollout_k2a_f64(const Args* p, int low_vel, int quintic, void* stream) {
  return k2a<double>(p, low_vel, quintic, stream);
}

int rollout_k2b_f32(const Args* p, int low_vel, int quintic, void* stream) {
  return k2b<float>(p, low_vel, quintic, stream);
}

int rollout_k2b_f64(const Args* p, int low_vel, int quintic, void* stream) {
  return k2b<double>(p, low_vel, quintic, stream);
}

}  // extern "C"
