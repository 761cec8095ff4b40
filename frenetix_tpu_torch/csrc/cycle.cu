// The cycle's stages after the rollout (K3): the cost terms, their weighted
// total, the prediction collisions, the corridor departure and the
// selectable mask, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves frenetix_tpu/ops/costs.py,
// frenetix_tpu/ops/collision.py and the selection of
// frenetix_tpu/planner/core.py::evaluate_cycle to XLA's fusion.  The port's
// plain twin (frenetix_tpu_torch/planner/core.py::cycle_stages_plain, the
// CPU path, over the stage functions of ops/costs.py and ops/collision.py)
// runs them on the card as ~260 PyTorch kernels, each (..., M, N+1) or
// (..., M, O, t) temporary written to device memory and read back.  K3 reads
// K2's Rollout once and writes, per candidate row, the 13 cost terms in
// COST_TERM_ORDER, the total, collides, boundary_step, boundary_harm and
// selectable.  The masked argmin, found and the histogram stay PyTorch.
//
// Bytes, the floor (float32; chip_smoke.py::k3_bytes): the seven fields x,
// y, theta_gl, theta_cl, v, a, d and the two corridor columns read once,
// 36 B a step; per row the six coefficients it needs, three masks and the
// outputs (13 terms, the total, the harm, the step and two flags), 93 B;
// per agent its predictions, obstacles and segments once.  Dense (M =
// 34,816 rows, N + 1 = 31, 4 slots): 42.1 MB, 0.0126 ms at 3.35 TB/s; 8
// agents x 1,024 rows with 16 slots: 10.0 MB, 0.0030 ms.  A block reads its
// agent's predictions again from L2.  Operations are ~80 per (row, step,
// slot), far below the bytes.
//
// Design: one warp per candidate row, lane = time step.  N + 1 = 31 fits a
// warp; a longer horizon loops over chunks of 32 steps and carries the
// previous step's a and theta_cl for the differences, so any n_steps
// works.  A block's eight warps hold rows of one agent.  The block stages
// that agent's prediction window in shared memory: per slot and step the
// mean, the inverse covariance, the cos and sin of the orientation and the
// valid flag, for the 32 obstacle steps its lanes read (ego step t against
// obstacle step t - 1); per slot the half-sizes and the current position;
// per lane segment its start, direction and squared length.  A chunk's
// window is staged anew only where the horizon has more than one chunk;
// otherwise a warp walks several rows of the agent under one staging.
// Each lane loops over the slots in registers.  A row's any() is
// __ballot_sync; its first step off the corridor a ballot and __ffs, and
// the velocity there a shuffle.
//
// Arithmetic.  Each elementwise expression is the twin's, in its order,
// one rounding per operation (--fmad=false, no fast math: IEEE division,
// cosf, sinf, expf, sqrtf); where the twin divides a tensor by a Python
// number it runs on the card as a product with the reciprocal, as here;
// Python numbers are rounded to the tensors' type first, and dt's powers
// are Python's.  So collides, boundary_step, boundary_harm, selectable and
// the closed-form jerk terms equal the twin bitwise.  The sums over steps
// and slots are not torch.sum's: each lane adds its slots in slot order
// and its steps chunk by chunk, and the warp adds its lanes in one
// butterfly (__shfl_xor_sync), the same tree for every row.  torch.sum's
// order depends on the tensor's shape and on the card, so the summed terms
// differ from the twin's by rounding only.  A row's arithmetic depends on
// nothing but the row, never on M, the agents or the launch: batched rows
// equal the rows evaluated alone bitwise, and an invalid slot adds an exact
// zero wherever it sits.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

// Everything the kernel takes; the wrapper fills it (ops/cycle_kernel.py,
// `_Args`, the same fields in the same order).  Strides count elements;
// an agent stride of 0 shares one tensor among all agents.  It lies
// outside the unnamed namespace, so the C entries that take it keep their
// external linkage.
struct Args {
  // the Rollout, (A * M, N + 1) contiguous
  const void *x, *y, *theta_gl, *theta_cl, *v, *a, *d;
  const void *d_lo, *d_hi;           // the corridor columns, or null
  const void *coeffs_lon, *coeffs_lat;   // (A * M, 6)
  const void *feasible, *valid;      // (A * M,) bool
  const void* mask;                  // valid_mask (A, M) bool
  int64_t mask_sa, mask_sm;
  const void* means;                 // (A, O, T, 2)
  int64_t mu_sa, mu_so, mu_st, mu_sc;
  const void* inv_covs;              // (A, O, T, 2, 2)
  int64_t ic_sa, ic_so, ic_st, ic_si, ic_sj;
  const void* orientations;          // (A, O, T)
  int64_t or_sa, or_so, or_st;
  const void* pred_valid;            // (A, O, T) bool
  int64_t pv_sa, pv_so, pv_st;
  const void* lengths;               // (A, O)
  int64_t ln_sa, ln_so;
  const void* widths;                // (A, O)
  int64_t wd_sa, wd_so;
  const void* obstacle_xy;           // (A, O', 2) current positions
  int64_t ox_sa, ox_so, ox_sc;
  const void* obstacle_valid;        // (A, O') bool
  int64_t ov_sa, ov_so;
  const void* lane_segments;         // (A, S, 2, 2)
  int64_t ls_sa, ls_ss, ls_sp, ls_sc;
  const void* lane_valid;            // (A, S) bool
  int64_t lv_sa, lv_ss;
  const void* v_des;                 // (A,) desired velocity
  int64_t vd_sa;
  const void* v_avg;                 // (A,) desired average velocity
  int64_t va_sa;
  const void* weights;               // (A, 13)
  int64_t w_sa, w_sk;
  int64_t n_agents;                  // A
  int64_t n_rows;                    // M per agent
  int64_t n1;                        // N + 1
  int64_t n_slots;                   // O
  int64_t horizon;                   // T
  int64_t n_obstacles;               // O'
  int64_t n_segments;                // S
  double dt, dt2, dt3, dt4, dt5;     // dt and its powers, as Python has them
  double dt_third, half_dt;          // dt / 3.0 and 0.5 * dt
  double wb_rear_axle, half_length, half_width, harm_const, harm_speed;
  // outputs
  void *cost_terms, *cost, *collides, *boundary_step, *boundary_harm, *selectable;
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreadsPerBlock = 256;
constexpr int kWarpsPerBlock = kThreadsPerBlock / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTerms = 13;
// per (slot, step) of the staged window: mean x, y, inverse covariance
// 00, 01, 10, 11, cos and sin of the orientation, valid
constexpr int kStepArrays = 9;
// per slot: half-length, half-width; per current obstacle: x, y, valid;
// per lane segment: a.x, a.y, ab.x, ab.y, clamped |ab|^2, valid
constexpr int kSlotArrays = 2, kObstacleArrays = 3, kSegmentArrays = 6;
// rows of all agents a launch aims to spread over this many blocks
constexpr int64_t kTargetBlocks = 1024;
constexpr int kMaxRowsPerWarp = 8;
// above this a block's dynamic shared memory needs the kernel's opt-in (the
// wrapper refuses more than the card's 227 KB before a launch)
constexpr int64_t kDefaultSharedBytes = 49152;

__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// torch.clamp(v, min=lo): NaN propagated
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) { return v < lo ? lo : v; }

// torch.amin's pairwise step: NaN propagated
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// the sum of every lane's `v`, the same bits in every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

// weight of sample j of a Simpson run of kk samples (ops/costs.py::
// simpson_uniform's `_simpson_odd`): 1, 4, 2, ..., 4, 1; a run of two is
// the trapezoid (weights 1, 1); a run of one adds nothing
__device__ __forceinline__ int simpson_weight(int j, int kk) {
  if (j < 0 || j >= kk || kk < 2) return 0;
  if (kk == 2 || j == 0 || j == kk - 1) return 1;
  return (j & 1) ? 4 : 2;
}

// ops/costs.py::simpson_uniform over the k samples of a row, scipy's
// even='avg': one lane's share of the weighted sums, then the warp's
template <typename T>
struct Simpson {
  T s1 = T(0), s2 = T(0);            // Simpson on [0:k] (odd k) or [0:k-1]; on [1:k]
  T first = T(0), last = T(0);       // y[0] + y[1] and y[k-2] + y[k-1] (even k)

  __device__ __forceinline__ void add(T y, int i, int k) {
    if (k & 1) {
      const int w = simpson_weight(i, k);
      if (w) s1 = s1 + y * static_cast<T>(w);
      return;
    }
    const int w1 = simpson_weight(i, k - 1), w2 = simpson_weight(i - 1, k - 1);
    if (w1) s1 = s1 + y * static_cast<T>(w1);
    if (w2) s2 = s2 + y * static_cast<T>(w2);
    if (i <= 1) first = first + y;
    if (i >= k - 2) last = last + y;
  }

  // `_simpson_odd` of a run of kk samples whose weighted sum is `sum`
  static __device__ __forceinline__ T odd(T sum, int kk, T dx, T dx_third) {
    if (kk >= 3) return sum * dx_third;
    if (kk == 2) return sum * T(0.5) * dx;
    return T(0);
  }

  __device__ __forceinline__ T finish(int k, T dx, T dx_third, T half_dx) const {
    if (k & 1) return odd(warp_sum(s1), k, dx, dx_third);
    const T res1 = odd(warp_sum(s1), k - 1, dx, dx_third) + half_dx * warp_sum(last);
    const T res2 = odd(warp_sum(s2), k - 1, dx, dx_third) + half_dx * warp_sum(first);
    return T(0.5) * (res1 + res2);
  }
};

// ops/polynomials.py::squared_jerk_integral of one row's a3, a4, a5 over
// [0, dt], dt's powers as Python computes them
template <typename T>
__device__ __forceinline__ T jerk_integral(T a3, T a4, T a5, const Args& p) {
  const T t = static_cast<T>(p.dt), t2 = static_cast<T>(p.dt2), t3 = static_cast<T>(p.dt3);
  const T t4 = static_cast<T>(p.dt4), t5 = static_cast<T>(p.dt5);
  return T(36) * a3 * a3 * t + T(144) * a3 * a4 * t2
         + (T(240) * a3 * a5 + T(192) * a4 * a4) * t3 + T(720) * a4 * a5 * t4
         + T(720) * a5 * a5 * t5;
}

// The shared memory of one block, in elements of T
__host__ __device__ __forceinline__ int64_t shared_elements(const Args& p) {
  return kStepArrays * p.n_slots * kWarp + kSlotArrays * p.n_slots
         + kObstacleArrays * p.n_obstacles + kSegmentArrays * p.n_segments;
}

// The window of obstacle steps base - 1 .. base + 30, one per lane of the
// chunk that starts at step `base`; steps outside [0, T) are invalid
template <typename T>
__device__ __forceinline__ void stage_window(const Args& p, int64_t agent, int base,
                                             T* win) {
  const int64_t n_slots = p.n_slots;
  const int64_t plane = n_slots * kWarp;
  for (int64_t i = threadIdx.x; i < plane; i += kThreadsPerBlock) {
    const int64_t o = i / kWarp;
    const int64_t s = base - 1 + (i % kWarp);
    T mx = T(0), my = T(0), i00 = T(0), i01 = T(0), i10 = T(0), i11 = T(0);
    T c = T(0), sn = T(0), ok = T(0);
    if (s >= 0 && s < p.horizon) {
      const T* mu = static_cast<const T*>(p.means) + agent * p.mu_sa + o * p.mu_so
                    + s * p.mu_st;
      mx = mu[0];
      my = mu[p.mu_sc];
      const T* ic = static_cast<const T*>(p.inv_covs) + agent * p.ic_sa + o * p.ic_so
                    + s * p.ic_st;
      i00 = ic[0];
      i01 = ic[p.ic_sj];
      i10 = ic[p.ic_si];
      i11 = ic[p.ic_si + p.ic_sj];
      const T th = static_cast<const T*>(p.orientations)[agent * p.or_sa + o * p.or_so
                                                         + s * p.or_st];
      c = cos_(th);
      sn = sin_(th);
      ok = static_cast<const bool*>(p.pred_valid)[agent * p.pv_sa + o * p.pv_so
                                                  + s * p.pv_st] ? T(1) : T(0);
    }
    win[i] = mx;
    win[plane + i] = my;
    win[2 * plane + i] = i00;
    win[3 * plane + i] = i01;
    win[4 * plane + i] = i10;
    win[5 * plane + i] = i11;
    win[6 * plane + i] = c;
    win[7 * plane + i] = sn;
    win[8 * plane + i] = ok;
  }
}

// What an agent's rows share besides the window: the slots' half-sizes,
// the current obstacles, the lane segments
template <typename T>
__device__ __forceinline__ void stage_agent(const Args& p, int64_t agent, T* slots,
                                            T* obstacles, T* segments) {
  for (int64_t o = threadIdx.x; o < p.n_slots; o += kThreadsPerBlock) {
    // preds.lengths / 2.0: a product with the reciprocal
    slots[o] = static_cast<const T*>(p.lengths)[agent * p.ln_sa + o * p.ln_so] * T(0.5);
    slots[p.n_slots + o] =
        static_cast<const T*>(p.widths)[agent * p.wd_sa + o * p.wd_so] * T(0.5);
  }
  for (int64_t o = threadIdx.x; o < p.n_obstacles; o += kThreadsPerBlock) {
    const T* xy = static_cast<const T*>(p.obstacle_xy) + agent * p.ox_sa + o * p.ox_so;
    obstacles[o] = xy[0];
    obstacles[p.n_obstacles + o] = xy[p.ox_sc];
    obstacles[2 * p.n_obstacles + o] =
        static_cast<const bool*>(p.obstacle_valid)[agent * p.ov_sa + o * p.ov_so] ? T(1)
                                                                                  : T(0);
  }
  const int64_t n_seg = p.n_segments;
  for (int64_t s = threadIdx.x; s < n_seg; s += kThreadsPerBlock) {
    const T* seg = static_cast<const T*>(p.lane_segments) + agent * p.ls_sa + s * p.ls_ss;
    const T ax = seg[0], ay = seg[p.ls_sc];
    const T abx = seg[p.ls_sp] - ax, aby = seg[p.ls_sp + p.ls_sc] - ay;
    segments[s] = ax;
    segments[n_seg + s] = ay;
    segments[2 * n_seg + s] = abx;
    segments[3 * n_seg + s] = aby;
    segments[4 * n_seg + s] = clamp_min(abx * abx + aby * aby, static_cast<T>(1e-9));
    segments[5 * n_seg + s] =
        static_cast<const bool*>(p.lane_valid)[agent * p.lv_sa + s * p.lv_ss] ? T(1) : T(0);
  }
}

// One row's running state over its chunks, per lane
template <typename T>
struct RowState {
  Simpson<T> acc, jerk, orient, path;
  T v_offset = T(0), v_last = T(0);  // Σ|v - v_des| over [N+1 // 2, N); (v_N - v_des)²
  T d_abs = T(0), d_last = T(0);     // Σ|d|; 5|d_N|
  T v_sum = T(0), obstacles = T(0), prediction = T(0), lane = T(0);
  T prev_a = T(0), prev_theta = T(0);  // step base - 1's a and theta_cl
  bool hit = false;                  // a valid slot's box overlaps at some step
  int off_step = -1;                 // first step off the corridor
  T off_v = T(0);                    // the velocity there
};

template <typename T, bool kBoundary>
__device__ __forceinline__ void row_chunk(const Args& p, int64_t agent, int64_t row,
                                          int base, int lane, const T* win,
                                          const T* slots, const T* obstacles,
                                          const T* segments, RowState<T>& rs) {
  const int n1 = static_cast<int>(p.n1);
  const int t = base + lane;
  const bool live = t < n1;
  const int64_t e = row * p.n1 + (live ? t : 0);
  T x = T(0), y = T(0), theta_gl = T(0), theta_cl = T(0), v = T(0), a = T(0), d = T(0);
  if (live) {
    x = static_cast<const T*>(p.x)[e];
    y = static_cast<const T*>(p.y)[e];
    theta_gl = static_cast<const T*>(p.theta_gl)[e];
    theta_cl = static_cast<const T*>(p.theta_cl)[e];
    v = static_cast<const T*>(p.v)[e];
    a = static_cast<const T*>(p.a)[e];
    d = static_cast<const T*>(p.d)[e];
  }
  // torch.diff along the steps, across chunks
  T up_a = __shfl_up_sync(kFull, a, 1);
  T up_theta = __shfl_up_sync(kFull, theta_cl, 1);
  if (lane == 0) {
    up_a = rs.prev_a;
    up_theta = rs.prev_theta;
  }
  rs.prev_a = __shfl_sync(kFull, a, kWarp - 1);
  rs.prev_theta = __shfl_sync(kFull, theta_cl, kWarp - 1);

  const T dt = static_cast<T>(p.dt);
  const T inv_dt = T(1) / dt;
  const T tiny = static_cast<T>(1e-12);
  const int64_t n_slots = p.n_slots, plane = n_slots * kWarp;
  bool off = false;
  if (live) {
    rs.acc.add(a * a, t, n1);
    rs.path.add(v, t, n1);
    if (t >= 1) {
      const T jerk = (a - up_a) * inv_dt;
      rs.jerk.add(jerk * jerk, t - 1, n1 - 1);
      const T dtheta = (theta_cl - up_theta) * inv_dt;
      rs.orient.add(dtheta * dtheta, t - 1, n1 - 1);
    }
    const T v_des = static_cast<const T*>(p.v_des)[agent * p.vd_sa];
    if (t >= n1 / 2 && t <= n1 - 2) rs.v_offset = rs.v_offset + abs_(v - v_des);
    if (t == n1 - 1) {
      const T dv = v - v_des;
      rs.v_last = abs_(dv * dv);
      rs.d_last = T(5) * abs_(d);
    }
    rs.d_abs = rs.d_abs + abs_(d);
    rs.v_sum = rs.v_sum + v;

    // 1/dist² to the current obstacle positions
    for (int64_t o = 0; o < p.n_obstacles; ++o) {
      if (obstacles[2 * p.n_obstacles + o] == T(0)) continue;
      const T dx = x - obstacles[o];
      const T dy = y - obstacles[p.n_obstacles + o];
      rs.obstacles = rs.obstacles + T(1) / clamp_min(dx * dx + dy * dy, tiny);
    }

    // the predictions: ego step t against obstacle step t - 1 (window lane)
    if (n_slots > 0 && t >= 1) {
      const int64_t t_cost = p.horizon - 1 < p.n1 - 1 ? p.horizon - 1 : p.n1 - 1;
      const int64_t t_coll = p.horizon < p.n1 - 1 ? p.horizon : p.n1 - 1;
      const T ac = cos_(theta_gl), as = sin_(theta_gl);
      const T wb = static_cast<T>(p.wb_rear_axle);
      const T cx = x + wb * ac, cy = y + wb * as;
      const T al = static_cast<T>(p.half_length), aw = static_cast<T>(p.half_width);
      for (int64_t o = 0; o < n_slots; ++o) {
        const int64_t w = o * kWarp + lane;
        if (win[8 * plane + w] == T(0)) continue;
        const T mx = win[w], my = win[plane + w];
        if (t <= t_cost) {
          // inverse-Mahalanobis term, ops/costs.py::quadratic_form_2x2
          const T dx = x - mx, dy = y - my;
          const T md2 = dx * (win[2 * plane + w] * dx + win[3 * plane + w] * dy)
                        + dy * (win[4 * plane + w] * dx + win[5 * plane + w] * dy);
          rs.prediction = rs.prediction + T(1) / clamp_min(md2 * md2, tiny);
        }
        if (t <= t_coll && !rs.hit) {
          // ops/collision.py::obb_overlap, ego box a, obstacle box b
          const T dx = mx - cx, dy = my - cy;
          const T bc = win[6 * plane + w], bs = win[7 * plane + w];
          const T bl = slots[o], bw = slots[n_slots + o];
          const T cd = abs_(ac * bc + as * bs);
          const T sd = abs_(as * bc - ac * bs);
          const bool separated = (abs_(dx * ac + dy * as) > al + bl * cd + bw * sd)
                                 | (abs_(dy * ac - dx * as) > aw + bl * sd + bw * cd)
                                 | (abs_(dx * bc + dy * bs) > bl + al * cd + aw * sd)
                                 | (abs_(dy * bc - dx * bs) > bw + al * sd + aw * cd);
          rs.hit = !separated;
        }
      }
    }

    // distance to the nearest valid lane segment, capped at 5
    if (p.n_segments > 0) {
      const int64_t n_seg = p.n_segments;
      T best = static_cast<T>(INFINITY);
      for (int64_t s = 0; s < n_seg; ++s) {
        if (segments[5 * n_seg + s] == T(0)) continue;
        const T ax = segments[s], ay = segments[n_seg + s];
        const T abx = segments[2 * n_seg + s], aby = segments[3 * n_seg + s];
        T u = ((x - ax) * abx + (y - ay) * aby) / segments[4 * n_seg + s];
        u = u < T(0) ? T(0) : u;
        u = u > T(1) ? T(1) : u;
        const T ex = x - (ax + u * abx), ey = y - (ay + u * aby);
        best = minimum(best, ex * ex + ey * ey);
      }
      T dist = sqrt_(best);
      if (dist > T(5)) dist = T(5);
      rs.lane = rs.lane + dist;
    }

    if (kBoundary) {
      // ops/collision.py::road_departure_corridor
      const T sin_t = sin_(theta_cl), cos_t = cos_(theta_cl);
      const T d_center = d + static_cast<T>(p.wb_rear_axle) * sin_t;
      const T ext = static_cast<T>(p.half_length) * abs_(sin_t)
                    + static_cast<T>(p.half_width) * abs_(cos_t);
      off = (d_center - ext < static_cast<const T*>(p.d_lo)[e])
            | (d_center + ext > static_cast<const T*>(p.d_hi)[e]);
    }
  }
  if (kBoundary) {
    const unsigned offs = __ballot_sync(kFull, off);
    if (rs.off_step < 0 && offs) {
      const int src = __ffs(static_cast<int>(offs)) - 1;
      rs.off_step = base + src;
      rs.off_v = __shfl_sync(kFull, v, src);
    }
  }
}

template <typename T, bool kBoundary, bool kCompensated>
__device__ __forceinline__ void row_finish(const Args& p, int64_t agent, int64_t row,
                                           int lane, const RowState<T>& rs) {
  const int n1 = static_cast<int>(p.n1);
  const T dx = static_cast<T>(p.dt);
  const T dx_third = static_cast<T>(p.dt_third), half_dx = static_cast<T>(p.half_dt);
  const T inv_n1 = T(1) / static_cast<T>(p.n1);
  // a3, a4, a5 of both polynomials: lanes 3-5 and 9-11 load, shuffles hand out
  T c = T(0);
  if (lane >= 3 && lane < 6) {
    c = static_cast<const T*>(p.coeffs_lon)[row * 6 + lane];
  } else if (lane >= 9 && lane < 12) {
    c = static_cast<const T*>(p.coeffs_lat)[row * 6 + lane - 6];
  }
  const T lon3 = __shfl_sync(kFull, c, 3), lon4 = __shfl_sync(kFull, c, 4);
  const T lon5 = __shfl_sync(kFull, c, 5), lat3 = __shfl_sync(kFull, c, 9);
  const T lat4 = __shfl_sync(kFull, c, 10), lat5 = __shfl_sync(kFull, c, 11);

  const T v_avg = static_cast<const T*>(p.v_avg)[agent * p.va_sa];
  const T terms[kTerms] = {
      rs.acc.finish(n1, dx, dx_third, half_dx),
      rs.jerk.finish(n1 - 1, dx, dx_third, half_dx),
      jerk_integral(lat3, lat4, lat5, p),
      jerk_integral(lon3, lon4, lon5, p),
      rs.orient.finish(n1 - 1, dx, dx_third, half_dx),
      rs.path.finish(n1, dx, dx_third, half_dx),
      p.n_segments > 0 ? warp_sum(rs.lane) * inv_n1 : T(0),
      warp_sum(rs.v_offset) + warp_sum(rs.v_last),
      abs_(warp_sum(rs.v_sum) * inv_n1 - v_avg),
      (warp_sum(rs.d_abs) + warp_sum(rs.d_last)) * inv_n1,
      warp_sum(rs.obstacles),
      warp_sum(rs.prediction),
      T(0),                            // responsibility: the post-passes add it
  };
  // the weighted total, the K products added in COST_TERM_ORDER
  const T* w = static_cast<const T*>(p.weights) + agent * p.w_sa;
  T s = terms[0] * w[0];
  T comp = T(0);
#pragma unroll
  for (int k = 1; k < kTerms; ++k) {
    const T prod = terms[k] * w[k * p.w_sk];
    if (kCompensated) {
      const T sum = s + prod;
      comp = comp + (abs_(s) >= abs_(prod) ? (s - sum) + prod : (prod - sum) + s);
      s = sum;
    } else {
      s = s + prod;
    }
  }
  if (kCompensated) s = s + comp;

  // lane k < 13 writes term k: an unrolled pick, no lane-indexed array
  T mine = T(0);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    if (lane == k) mine = terms[k];
  }
  if (lane < kTerms) static_cast<T*>(p.cost_terms)[row * kTerms + lane] = mine;

  const bool collides = __any_sync(kFull, rs.hit);
  if (lane == 0) {
    const int64_t r = row - agent * p.n_rows;
    const bool in_mask = static_cast<const bool*>(p.mask)[agent * p.mask_sa + r * p.mask_sm];
    const bool off_road = kBoundary && rs.off_step >= 0;
    T harm = T(0);
    if (off_road) {
      // planner/core.py::_boundary_harm
      const T z = rs.off_v * static_cast<T>(p.harm_speed) + static_cast<T>(p.harm_const);
      harm = T(1) / (exp_(-z) + T(1));
    }
    static_cast<T*>(p.cost)[row] = s;
    static_cast<bool*>(p.collides)[row] = collides;
    static_cast<int32_t*>(p.boundary_step)[row] = off_road ? rs.off_step : -1;
    static_cast<T*>(p.boundary_harm)[row] = harm;
    static_cast<bool*>(p.selectable)[row] =
        static_cast<const bool*>(p.feasible)[row] && static_cast<const bool*>(p.valid)[row]
        && !collides && !off_road && in_mask;
  }
}

template <typename T, bool kBoundary, bool kCompensated>
__global__ void __launch_bounds__(kThreadsPerBlock) k3_kernel(const Args p,
                                                               int64_t blocks_per_agent,
                                                               int rows_per_warp) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* win = reinterpret_cast<T*>(shared_raw);
  T* slots = win + kStepArrays * p.n_slots * kWarp;
  T* obstacles = slots + kSlotArrays * p.n_slots;
  T* segments = obstacles + kObstacleArrays * p.n_obstacles;

  const int64_t agent = blockIdx.x / blocks_per_agent;
  const int64_t first = (blockIdx.x % blocks_per_agent) * kWarpsPerBlock * rows_per_warp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int n_chunks = static_cast<int>((p.n1 + kWarp - 1) / kWarp);

  stage_agent(p, agent, slots, obstacles, segments);
  __syncthreads();
  for (int it = 0; it < rows_per_warp; ++it) {
    const int64_t r = first + static_cast<int64_t>(it) * kWarpsPerBlock + warp;
    const bool active = r < p.n_rows;              // the same in the whole warp
    const int64_t row = agent * p.n_rows + r;
    RowState<T> rs;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      if (p.n_slots > 0 && (n_chunks > 1 || it == 0)) {
        __syncthreads();                           // the last chunk's readers are done
        stage_window(p, agent, chunk * kWarp, win);
        __syncthreads();
      }
      if (active) {
        row_chunk<T, kBoundary>(p, agent, row, chunk * kWarp, lane, win, slots, obstacles,
                                segments, rs);
      }
    }
    if (active) row_finish<T, kBoundary, kCompensated>(p, agent, row, lane, rs);
  }
}

template <typename T, bool kBoundary, bool kCompensated>
int launch(const Args& p, cudaStream_t stream) {
  const int64_t rows = p.n_agents * p.n_rows;
  const int64_t n_chunks = (p.n1 + kWarp - 1) / kWarp;
  int64_t per_warp = rows / (kWarpsPerBlock * kTargetBlocks);
  per_warp = n_chunks > 1 ? 1 : (per_warp < 1 ? 1 : (per_warp > kMaxRowsPerWarp
                                                         ? kMaxRowsPerWarp : per_warp));
  const int64_t rows_per_block = kWarpsPerBlock * per_warp;
  const int64_t blocks_per_agent = (p.n_rows + rows_per_block - 1) / rows_per_block;
  const int64_t bytes = shared_elements(p) * static_cast<int64_t>(sizeof(T));
  auto kernel = k3_kernel<T, kBoundary, kCompensated>;
  if (bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(p.n_agents * blocks_per_agent), kThreadsPerBlock,
           static_cast<size_t>(bytes), stream>>>(p, blocks_per_agent,
                                                 static_cast<int>(per_warp));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k3(const Args* p, int check_boundary, int compensated, void* stream) {
  if (p->n_agents * p->n_rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (check_boundary) {
    return compensated ? launch<T, true, true>(*p, s) : launch<T, true, false>(*p, s);
  }
  return compensated ? launch<T, false, true>(*p, s) : launch<T, false, false>(*p, s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each function launches on the
// calling thread's current device, which must own `stream` and the pointers
// (the wrapper makes it current).  It returns the CUDA error code of the
// launch (0 on success) and does not synchronise.
extern "C" {

int cycle_k3_f32(const Args* p, int check_boundary, int compensated, void* stream) {
  return k3<float>(p, check_boundary, compensated, stream);
}

int cycle_k3_f64(const Args* p, int check_boundary, int compensated, void* stream) {
  return k3<double>(p, check_boundary, compensated, stream);
}

}  // extern "C"
