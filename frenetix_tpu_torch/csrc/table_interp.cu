// Reference-table interpolation for the replanning cycle (K1), Hopper port.
//
// Replaces the Pallas TPU kernel frenetix_tpu/ops/pallas_interp.py::
// _interp_kernel (launched by interp_tables_pallas).  That kernel kept a
// (W, C) table window resident in VMEM and evaluated a two-hot (BLK, W)
// weight block times the window on the matrix unit.  On Hopper a gather is
// cheap, so each query reads its two table rows directly:
//
//     out[c, p] = (1 - lam[p]) * table[gidx[p], c] + lam[p] * table[gidx[p] + 1, c]
//
// Inputs: the FULL (R, C) row-major table, gidx (P,) int32 global rows
// (window offset + clipped local index, so reading rows gidx and gidx + 1 of
// the full table gives the values the JAX window copy would), lam (P,).
// Output: column-major (C, P), the layout interp_ref_tables consumes.
// Precondition: 0 <= gidx[p] <= R - 2 (the caller clips).
//
// Cost model: bound by memory.  Per query it reads 4 B of index and
// sizeof(T) of lambda and writes C * sizeof(T); the table rows (868 x 7 in
// the dense cycle, ~24 KB in f32) stay in L1/L2.  In f32 with C = 7 that is
// ~36 B/query, ~39 MB for the 1,079,296 queries of one dense cycle.
//
// Design: one thread per query, a loop over the C columns.  Neighbouring
// threads write neighbouring addresses of each output row, so every store is
// coalesced.  The products are evaluated as (1 - lam) * lo + lam * hi in that
// order and the file is compiled with --fmad=false, so no FMA contraction
// happens and the result is bitwise equal to the plain PyTorch twin
// (frenetix_tpu_torch/ops/table_interp.py::interp_rows_plain) on the card.
// The simple design is deliberate: tiling the table into shared memory, or
// fusing the segment-index / window arithmetic into the kernel, is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;

template <typename T>
__global__ void table_interp_kernel(const T* __restrict__ table, int n_cols,
                                    const int32_t* __restrict__ gidx,
                                    const T* __restrict__ lam,
                                    T* __restrict__ out, int64_t n_queries) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_queries) return;
  const int64_t row = gidx[p];
  const T l = lam[p];
  const T w = T(1) - l;
  const T* lo = table + row * n_cols;
  const T* hi = lo + n_cols;
  for (int c = 0; c < n_cols; ++c) {
    out[static_cast<int64_t>(c) * n_queries + p] = w * lo[c] + l * hi[c];
  }
}

// Does nothing: its time on the card is the floor of one launch, below which
// no design of the kernel above can go at small P.
__global__ void empty_kernel() {}

template <typename T>
int launch(const void* table, int n_cols, const void* gidx, const void* lam,
           void* out, int64_t n_queries, void* stream) {
  if (n_queries <= 0) return 0;
  const int64_t blocks =
      (n_queries + kThreadsPerBlock - 1) / kThreadsPerBlock;
  table_interp_kernel<T>
      <<<static_cast<unsigned int>(blocks), kThreadsPerBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(table), n_cols,
          static_cast<const int32_t*>(gidx), static_cast<const T*>(lam),
          static_cast<T*>(out), n_queries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each function launches on the
// calling thread's current device, which must own `stream` and the pointers
// (the wrapper makes it current); it never changes that device.  It returns
// the CUDA error code of the launch (0 on success) and does not synchronise.
extern "C" {

int table_interp_f32(const void* table, int n_cols, const void* gidx,
                     const void* lam, void* out, long long n_queries,
                     void* stream) {
  return launch<float>(table, n_cols, gidx, lam, out, n_queries, stream);
}

int table_interp_f64(const void* table, int n_cols, const void* gidx,
                     const void* lam, void* out, long long n_queries,
                     void* stream) {
  return launch<double>(table, n_cols, gidx, lam, out, n_queries, stream);
}

// One block of one thread that does nothing, for timing the launch floor.
int table_interp_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
