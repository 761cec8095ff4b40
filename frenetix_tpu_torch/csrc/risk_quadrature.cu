// Collision-probability quadrature of the risk stack (Q), gate first.
//
// Replaces no TPU kernel: the JAX package leaves
// frenetix_tpu/risk/probability.py::collision_probability_fast to XLA.  The
// port's eager twin (frenetix_tpu_torch/risk/probability.py, the CPU path of
// collision_probability_fast) evaluates every (batch, candidate, obstacle,
// step) cell: 3 ego rectangles x 3 obstacle means x 4 corners x 24
// Gauss-Legendre nodes, some 15 elementwise kernels per node, each
// temporary materialised.  For 8 agents x 1,024 candidates x 16 obstacle
// slots x 30 steps that is ~600 GB of device-memory traffic per call, 199 of
// the 208 ms of a risk-aware batched request on an H100, though 97.6-100 %
// of those cells lie beyond the 5 m gate or on an invalid slot, where the
// twin multiplies its result by 0.
//
// Per cell, one thread:
//   (a) slot invalid at the step: write 0;
//   (b) the three mean distances sqrt(dx*dx + dy*dy) as the twin computes
//       them; none <= 5 m (or one is NaN, as torch.amin propagates it):
//       write 0;
//   (c) otherwise price it: the 9 (rectangle, mean) pairs, each the corners
//       (b1,b2), (a1,b2), (b1,a2), (a1,a2) through the bivariate normal CDF
//       (24 nodes added in order), c0 - c1 - c2 + c3 clamped to [0, 1]; the
//       pairs summed in the twin's order, times 1/3.
// The pairs of a block's priced cells are spread over its 256 threads (the
// priced cells are a few % of all, in runs of steps of one candidate and
// obstacle, so one thread per cell would leave most threads of a warp, and
// most warps of a block, idle while a few price), each pair's result kept
// in shared memory until the cell's own thread sums them.  Nothing else
// leaves the registers; the output is written once.
//
// Bound: the bytes of the inputs and the output, each once (21.8 MB at the
// convoy's shape in float32, 6.5 us at 3.35 TB/s), and the priced cells'
// work (864 exp, 216 sqrt, 36 erf and 1,764 divisions per priced cell,
// 19 us at 67 TFLOP/s for the 2.6 % a near-traffic convoy request prices).
// The design does nothing for a cell that cannot be non-zero but read 8
// values and write one, keeps few registers so that many warps hide the
// latency of those reads, and materialises nothing.
//
// Arithmetic: the twin's operation order, one rounding per operation
// (--fmad=false, no fast math: full-precision exp, sqrt, erf and division).
// Where the twin divides a tensor by a Python number it runs on the card as
// a product with the reciprocal (PyTorch's CUDA division by a CPU scalar),
// and so does this kernel (1/3, 1/(2 pi)).  Phi is torch.special.ndtr's
// composite (1 + erf(x * sqrt(1/2))) * 0.5.  The nodes and weights come from
// the wrapper (the twin's own lists) by value, so both use the same numbers.
//
// The per-(obstacle, step) and per-(candidate, step) preparation (the three
// means with the one-step yaw offset, the zero-covariance fallback, sx, sy,
// rho, the three ego rectangle centres) is the wrapper's, in plain PyTorch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int kWarps = kThreadsPerBlock / 32;
constexpr int kNodes = 24;
constexpr int kPairs = 9;                            // rectangle x mean
using Index = uint32_t;

template <typename T>
struct Nodes {
  T x[kNodes];
  T w[kNodes];
};

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
__device__ __forceinline__ float erf_(float v) { return erff(v); }
__device__ __forceinline__ double erf_(double v) { return erf(v); }

// torch.special.ndtr: (1 + erf(x * M_SQRT1_2)) * 0.5
template <typename T>
__device__ __forceinline__ T ndtr(T v) {
  const T t = v * static_cast<T>(0.70710678118654752440);
  return (T(1) + erf_(t)) * T(0.5);
}

// torch.clamp(v, 0, 1), NaN propagated
template <typename T>
__device__ __forceinline__ T clamp01(T v) {
  if (v != v) return v;
  return fmin(fmax(v, T(0)), T(1));
}

// P(lower <= X <= upper) of one (rectangle, mean) pair: the four corners of
// the standardised rectangle through Phi2(x, y, rho) = Phi(x) Phi(y) +
// integral / (2 pi), integral = rho * sum_n w_n exp(-(x^2 - 2 r x y + y^2) /
// (2 (1 - r^2))) / sqrt(1 - r^2), r = rho x_n; nodes and weights in shared
// memory.
template <typename T>
__device__ __forceinline__ T rectangle(T a1, T a2, T b1, T b2, T rho,
                                       const T* __restrict__ gl_x,
                                       const T* __restrict__ gl_w) {
  const T xs[4] = {b1, a1, b1, a1};
  const T ys[4] = {b2, b2, a2, a2};
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 2
  for (int n = 0; n < kNodes; ++n) {
    const T r = rho * gl_x[n];
    const T one_m_r2 = T(1) - r * r;
    const T two_r = T(2) * r;
    const T den = T(2) * one_m_r2;
    const T root = sqrt_(one_m_r2);
    const T w = gl_w[n];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T x = xs[c];
      const T y = ys[c];
      const T q = x * x - two_r * x * y + y * y;
      acc[c] += exp_(-q / den) / root * w;
    }
  }
  const T inv_two_pi = T(1) / static_cast<T>(6.283185307179586);
  const T nb1 = ndtr(b1), na1 = ndtr(a1), nb2 = ndtr(b2), na2 = ndtr(a2);
  const T c0 = nb1 * nb2 + acc[0] * rho * inv_two_pi;
  const T c1 = na1 * nb2 + acc[1] * rho * inv_two_pi;
  const T c2 = nb1 * na2 + acc[2] * rho * inv_two_pi;
  const T c3 = na1 * na2 + acc[3] * rho * inv_two_pi;
  return clamp01(c0 - c1 - c2 + c3);
}

// centres (3, B, M, t, 2), means (3, B, O, t, 2), sx / sy / rho / valid
// (B, O, t), out (B, M, O, t); every cell index and element offset fits in
// 32 bits (the wrapper checks).
template <typename T>
__global__ void __launch_bounds__(kThreadsPerBlock)
risk_quadrature_kernel(const T* __restrict__ centres,
                       const T* __restrict__ means, const T* __restrict__ sx,
                       const T* __restrict__ sy, const T* __restrict__ rho,
                       const bool* __restrict__ valid,
                       T off_x, T off_y, const Nodes<T> gl, Index n_batch,
                       Index n_cand, Index n_obst, Index n_steps,
                       T* __restrict__ out,
                       unsigned long long* __restrict__ useful) {
  __shared__ T gl_x[kNodes], gl_w[kNodes];
  // the block's priced cells by rank, and their pairs' results
  __shared__ int warp_count[kWarps];
  __shared__ Index cell_slot[kThreadsPerBlock], cell_ego[kThreadsPerBlock];
  __shared__ T pair_p[kThreadsPerBlock * kPairs];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      gl_x[n] = gl.x[n];
      gl_w[n] = gl.w[n];
    }
  }

  const Index n_cells = n_batch * n_cand * n_obst * n_steps;
  const Index cell =
      static_cast<Index>(blockIdx.x) * kThreadsPerBlock + threadIdx.x;
  const bool inside = cell < n_cells;

  // (b, m, o, j) of the cell, the step fastest
  Index rest = inside ? cell : Index(0);
  const Index j = rest % n_steps;
  rest /= n_steps;
  const Index o = rest % n_obst;
  rest /= n_obst;
  const Index m = rest % n_cand;
  const Index b = rest / n_cand;
  const Index slot = (b * n_obst + o) * n_steps + j;            // (b, o, j)
  const Index ego = (b * n_cand + m) * n_steps + j;             // (b, m, j)
  const Index rect_stride = n_batch * n_cand * n_steps;         // per rectangle
  const Index mean_stride = n_batch * n_obst * n_steps;         // per mean

  // (a) the slot, (b) the gate
  bool priced = false;
  if (inside && valid[slot]) {
    const T ex = centres[2 * ego], ey = centres[2 * ego + 1];
    bool near = false, nan = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T dx = means[2 * (k * mean_stride + slot)] - ex;
      const T dy = means[2 * (k * mean_stride + slot) + 1] - ey;
      const T d = sqrt_(dx * dx + dy * dy);
      near = near || d <= T(5);
      nan = nan || d != d;
    }
    priced = near && !nan;
  }
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned mask = __ballot_sync(0xffffffffu, priced);
  if (lane == 0) warp_count[warp] = __popc(mask);
  // a barrier for the nodes and the counts too: every thread reaches it
  const int count = __syncthreads_count(priced);
  if (useful != nullptr && threadIdx.x == 0 && count > 0) {
    atomicAdd(useful, static_cast<unsigned long long>(count));
  }

  // (c) the block prices its cells together: task (rank, pair) of its
  // priced cells goes to thread task % 256, so no thread idles while
  // another prices
  T prob = T(0);
  if (count > 0) {                                   // uniform over the block
    int rank = __popc(mask & ((1u << lane) - 1u));
    for (unsigned w = 0; w < warp; ++w) rank += warp_count[w];
    if (priced) {
      cell_slot[rank] = slot;
      cell_ego[rank] = ego;
    }
    __syncthreads();
    for (int task = threadIdx.x; task < kPairs * count;
         task += kThreadsPerBlock) {
      const int which = task / kPairs, pair = task % kPairs;
      const int rr = pair / 3, k = pair % 3;         // _RECT_MEAN_PAIRS order
      const Index s = cell_slot[which];
      const Index c = 2 * (rr * rect_stride + cell_ego[which]);
      const Index q = 2 * (k * mean_stride + s);
      const T cx = centres[c], cy = centres[c + 1];
      const T mx = means[q], my = means[q + 1];
      const T s_x = sx[s], s_y = sy[s];
      const T a1 = (cx - off_x - mx) / s_x;
      const T a2 = (cy - off_y - my) / s_y;
      const T b1 = (cx + off_x - mx) / s_x;
      const T b2 = (cy + off_y - my) / s_y;
      pair_p[task] = rectangle(a1, a2, b1, b2, rho[s], gl_x, gl_w);
    }
    __syncthreads();
    if (priced) {
      const T* p = pair_p + rank * kPairs;
      prob = p[0];
#pragma unroll
      for (int pair = 1; pair < kPairs; ++pair) prob = prob + p[pair];
      prob = prob * (T(1) / T(3));
    }
  }
  if (inside) out[cell] = prob;
}

template <typename T>
int launch(const void* centres, const void* means, const void* sx,
           const void* sy, const void* rho, const void* valid, double off_x,
           double off_y, const double* nodes, long long n_batch,
           long long n_cand, long long n_obst, long long n_steps, void* out,
           void* useful, void* stream) {
  const long long n_cells = n_batch * n_cand * n_obst * n_steps;
  if (n_cells <= 0) return 0;
  Nodes<T> gl;
  for (int n = 0; n < kNodes; ++n) {
    gl.x[n] = static_cast<T>(nodes[n]);
    gl.w[n] = static_cast<T>(nodes[kNodes + n]);
  }
  const long long blocks = (n_cells + kThreadsPerBlock - 1) / kThreadsPerBlock;
  risk_quadrature_kernel<T><<<static_cast<unsigned int>(blocks),
                              kThreadsPerBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(centres), static_cast<const T*>(means),
      static_cast<const T*>(sx), static_cast<const T*>(sy),
      static_cast<const T*>(rho), static_cast<const bool*>(valid),
      static_cast<T>(off_x), static_cast<T>(off_y), gl,
      static_cast<Index>(n_batch), static_cast<Index>(n_cand),
      static_cast<Index>(n_obst), static_cast<Index>(n_steps),
      static_cast<T*>(out), static_cast<unsigned long long*>(useful));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each function launches on the
// calling thread's current device, which must own `stream` and the device
// pointers (the wrapper makes it current); it never changes that device.
// `nodes` is a host array of 48 doubles, the 24 nodes then the 24 weights;
// `useful` is a zeroed int64 on the device, or null to count nothing.  The
// cells plus one block, and the elements of `centres` and of `means`, must
// each be at most 2^32 (32-bit indices).  It returns the CUDA error code of
// the launch (0 on success) and does not synchronise.
extern "C" {

int risk_quadrature_f32(const void* centres, const void* means, const void* sx,
                        const void* sy, const void* rho, const void* valid,
                        double off_x, double off_y, const double* nodes,
                        long long n_batch, long long n_cand, long long n_obst,
                        long long n_steps, void* out, void* useful,
                        void* stream) {
  return launch<float>(centres, means, sx, sy, rho, valid, off_x, off_y, nodes,
                       n_batch, n_cand, n_obst, n_steps, out, useful, stream);
}

int risk_quadrature_f64(const void* centres, const void* means, const void* sx,
                        const void* sy, const void* rho, const void* valid,
                        double off_x, double off_y, const double* nodes,
                        long long n_batch, long long n_cand, long long n_obst,
                        long long n_steps, void* out, void* useful,
                        void* stream) {
  return launch<double>(centres, means, sx, sy, rho, valid, off_x, off_y, nodes,
                        n_batch, n_cand, n_obst, n_steps, out, useful, stream);
}

}  // extern "C"
