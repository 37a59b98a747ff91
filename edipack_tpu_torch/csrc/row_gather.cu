// Sparse row-gather sector matvec for Hopper (sm_90a): one template for the
// fused normal-sector matvec in f64 (B1) and f32 (B2), the f32 chained power
// steps (B3) and the f32 Kronecker matvec (B4):
//
//   out[d,u] = D(d,u) V[d,u] + sum_e upv[e,u] V[d, upi[e,u]]
//            + sum_e dwv[e,d] V[dwi[e,d], u]     (+ the Jx/Jp runs, blocked)
//
// with (upi, upv) and (dwi, dwv) the ELL tables of the one-spin hop
// factors Hup and Hdw (ops/fused_normal.py:ell_table): for each row the
// column indices and values of its nonzeros, `width` slots per row, the
// empty slots holding value 0 and an index in range; slot-major [e][row].
//
// Replaces the TPU kernels
//   * edipack_tpu/ops/pallas_fused.py:_matvec_ds_kernel (B1) and
//     _matvec_kernel (B2), as fused_normal_matvec_f64 / _f32: V in the
//     column-blocked imp-MSB layout V3[(j*ddp + d)*128 + c] = V[d, j*128 + c]
//     (`Blocked`), the rank-8 diagonal D(d,u) = sum_k a[d,k] b[u,k], and the
//     Jx/Jp runs (rectangle shifts out[dd0+i, du0+j] += val *
//     V[sd0+i, su0+j]). The TPU's B1 carried double-single f32 planes for
//     lack of f64; here it is plain FP64, and B2 full FP32;
//   * pallas_fused.py:_power_kernel (B3), as fused_normal_power_f32: niter
//     chained steps w = rsqrt(ssq) H v, each writing |w| and ssq for the
//     next. The TPU grid carried the sum of squares from one grid step to
//     the next; Hopper blocks run in no order, so a step is B2's pass that
//     scales its outputs by rsqrt(ssq[it]) (read from device memory) and
//     writes one partial sum of squares per block, then a one-block
//     finalize reduces the partials in f64, in a fixed order, into
//     norms[it] and ssq[it+1]: deterministic, no atomics, no host sync;
//   * edipack_tpu/ops/pallas_kron.py:_kernel_fused (B4), as
//     kron_tiles_matvec_f32: V and a dense D row-major (dd, du), unpadded
//     (the kernel masks its own ragged edge), no runs (the non-local terms
//     stay outside the kernel, as in the JAX package).
// The TPU kernels multiply the factors as dense 128x128 MXU tiles.
//
// What bounds it on the card: a hop factor has about 6.5 nonzeros per row
// (at most 12 at config 2's (7,7) sector, 3432 rows), so the function
// needs two operations per nonzero, 0.5 GFLOP, against
// V and W (96 MB each in f64, 48 MB in f32): it is bound by bytes, about
// 0.06 ms (f64) and 0.03 ms (f32) at 3.35 TB/s. Dense tiles run 41 (B1-B3)
// and 165 (B4) GFLOP of FMAs on zeros per call and are bound by that. This
// design does only the nonzero work and spends its effort on the bytes:
//   * one thread block owns `rows` consecutive rows d (up to 4 in f64, 8 in
//     f32: 110 KB) and every column u, and writes each output element once,
//     so there are no atomics and the sum order is fixed (diagonal, up
//     slots, dw slots, runs), as in the plain version, whatever `rows` is;
//   * the block stages its own rows of V in dynamic shared memory (up to
//     227 KB, two blocks per SM at config 2's widths), and the up term
//     gathers V[d, upi[e,u]] from there; each up slot's index and value is
//     read once per block (coalesced along u) and used for all its rows. A
//     sector whose one row does not fit (one-spin dimension above about 29k
//     in f64, 58k in f32) is refused at launch: no sector that fits on the
//     card with a Lanczos basis comes near that;
//   * the dw term reads the source rows V[dwi[e,d], :] from global memory,
//     coalesced along u. The block's dw slots sit in shared memory with each
//     row's count of nonzeros, so the padding slots are skipped by a branch
//     that is uniform across the block. Each source row is read once for
//     every row that hops to it (about 6.5 times), from the 50 MB L2 when
//     those blocks run close in time;
//   * the diagonal (blocked: the rank-8 dot product over the factors'
//     nonzero columns, its row factors in shared memory; B4: dense D), the
//     runs and B3's scale and sum of squares are done in the same pass.
// TMA staging, wider loads and a persistent grid are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;          // threads per block
constexpr int FIN_NT = 256;      // threads of B3's finalize
constexpr int BLK = 128;         // column block of the blocked layout
constexpr int RANK = 8;          // width of the low-rank diagonal factors
constexpr int RUN_FIELDS = 6;    // dd0, sd0, ld, du0, su0, lu
constexpr int SMEM_CAP = 232448; // dynamic shared memory of one block (227 KB)

template <typename T>
struct Args {
  const T* v;
  T* out;
  const int* up_idx;   // (wup, nu)
  const T* up_val;
  const int* dw_idx;   // (wdw, nd)
  const T* dw_val;
  const T* diag_a;     // blocked: (nd, RANK); B4: dense D, laid out as V
  const T* diag_b;     // blocked: (nu, RANK)
  const int* runs_i;   // blocked: (nruns, RUN_FIELDS)
  const T* runs_v;
  int nruns;
  int rank;            // blocked: the diagonal factors' leading nonzero columns
  int wup, wdw;
  int nd, nu;          // rows d and columns u of V (blocked: padded)
  int rows;            // rows of d per block
};

// Offset of V[d, u]: column-blocked or row-major.
template <bool Blocked>
__device__ __forceinline__ size_t off(int d, int u, int nd, int nu) {
  if (Blocked) return ((size_t)(u >> 7) * nd + d) * BLK + (u & (BLK - 1));
  return (size_t)d * nu + u;
}

// Blocked = true: column-blocked V, rank-8 diagonal and runs (B1, B2, B3);
// false: row-major V and a dense D (B4). Power = true (B3): every output is
// scaled by rsqrt(*ssq_in) and the block's sum of squares of its outputs
// goes to partials[blockIdx.x]. The block's rows of V are in shared memory.
template <typename T, int RMAX, bool Blocked, bool Power>
__global__ void __launch_bounds__(NT, 2)
row_gather_kernel(const Args<T> a, const float* ssq_in, float* partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* dwv_s = reinterpret_cast<T*>(smem);                // [RMAX][wdw]
  T* da_s = dwv_s + RMAX * a.wdw;                       // [RMAX][RANK]
  T* xs = da_s + RMAX * RANK;                           // [rows][nu]
  int* dwi_s = reinterpret_cast<int*>(xs + (size_t)a.rows * a.nu);  // [RMAX][wdw]
  int* cnt_s = dwi_s + RMAX * a.wdw;                    // [RMAX]

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * a.rows;
  const int nr = min(a.rows, a.nd - d0);

  for (int i = tid; i < nr * a.wdw; i += NT) {
    const int r = i / a.wdw, e = i - r * a.wdw;
    dwv_s[i] = a.dw_val[(size_t)e * a.nd + d0 + r];
    dwi_s[i] = a.dw_idx[(size_t)e * a.nd + d0 + r];
  }
  if (Blocked)
    for (int i = tid; i < nr * RANK; i += NT)
      da_s[i] = a.diag_a[(size_t)d0 * RANK + i];
  for (int r = 0; r < nr; ++r)
    for (int u = tid; u < a.nu; u += NT)
      xs[(size_t)r * a.nu + u] = __ldg(a.v + off<Blocked>(d0 + r, u, a.nd, a.nu));
  __syncthreads();
  // a row's nonzeros fill its first slots: drop the empty ones at its end
  if (tid < nr) {
    int c = a.wdw;
    while (c > 0 && dwv_s[tid * a.wdw + c - 1] == T(0)) --c;
    cnt_s[tid] = c;
  }
  __syncthreads();

  auto x = [&](int r, int u) -> T { return xs[(size_t)r * a.nu + u]; };
  [[maybe_unused]] float scale = 1.f, ss = 0.f;
  if constexpr (Power) scale = rsqrtf(*ssq_in);

  for (int u = tid; u < a.nu; u += NT) {
    T acc[RMAX];
    // diagonal
    if (Blocked) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
#pragma unroll
      for (int k = 0; k < RANK; ++k) {
        if (k < a.rank) {
          const T bk = __ldg(a.diag_b + (size_t)u * RANK + k);
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            acc[r] = fma(da_s[r * RANK + k], bk, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) acc[r] = r < nr ? acc[r] * x(r, u) : T(0);
    } else {
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        acc[r] = r < nr ? __ldg(a.diag_a + off<Blocked>(d0 + r, u, a.nd, a.nu)) * x(r, u)
                        : T(0);
    }
    // up factor: gathers along the block's own rows
    for (int e = 0; e < a.wup; ++e) {
      const size_t s = (size_t)e * a.nu + u;
      const int c = __ldg(a.up_idx + s);
      const T w = __ldg(a.up_val + s);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < nr) acc[r] = fma(w, x(r, c), acc[r]);
    }
    // dw factor: the rows' nonzeros, each a source row read along u
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < nr) {
        const int n = cnt_s[r];
#pragma unroll 4
        for (int e = 0; e < n; ++e)
          acc[r] = fma(dwv_s[r * a.wdw + e],
                       __ldg(a.v + off<Blocked>(dwi_s[r * a.wdw + e], u, a.nd, a.nu)),
                       acc[r]);
      }
    }
    // Jx/Jp runs
    if (Blocked) {
      for (int n = 0; n < a.nruns; ++n) {
        const int* ri = a.runs_i + n * RUN_FIELDS;
        const int j = u - __ldg(ri + 3);
        if (j >= 0 && j < __ldg(ri + 5)) {
          const int us = __ldg(ri + 4) + j;
          const T rv = __ldg(a.runs_v + n);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            const int i = d0 + r - __ldg(ri + 0);
            if (r < nr && i >= 0 && i < __ldg(ri + 2))
              acc[r] = fma(rv, __ldg(a.v + off<Blocked>(__ldg(ri + 1) + i, us, a.nd, a.nu)),
                           acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < nr) {
        T w = acc[r];
        if constexpr (Power) {
          w *= scale;
          ss = fmaf(w, w, ss);
        }
        a.out[off<Blocked>(d0 + r, u, a.nd, a.nu)] = w;
      }
    }
  }

  if constexpr (Power) {
    // the block's sum of squares, in a fixed order: within each warp, then
    // over the warps (the staged rows are dead, so their memory is reused)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, o);
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < NT / 32; ++w) s += red[w];
      partials[blockIdx.x] = s;
    }
  }
}

// ssq_out = sum of the n block partials (in f64, fixed order), norm_out =
// its square root. One block of FIN_NT threads.
__global__ void __launch_bounds__(FIN_NT, 1)
power_finalize_kernel(const float* partials, int n, float* ssq_out,
                      float* norm_out) {
  __shared__ double red[FIN_NT];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < n; i += FIN_NT) s += partials[i];
  red[tid] = s;
  __syncthreads();
  for (int w = FIN_NT / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    *ssq_out = (float)red[0];
    *norm_out = (float)sqrt(red[0]);
  }
}

// One launch of the row-gather kernel with as many rows a block as fit in
// shared memory (up to 4 in f64 and 8 in f32; the last block may be short);
// the number of blocks goes to *nblocks when it is given.
template <typename T, bool Blocked, bool Power = false>
cudaError_t launch(Args<T> a, cudaStream_t stream,
                   const float* ssq_in = nullptr, float* partials = nullptr,
                   int* nblocks = nullptr) {
  constexpr int RMAX = sizeof(T) == 8 ? 4 : 8;
  const size_t fixed = RMAX * (a.wdw * (sizeof(T) + sizeof(int))
                               + RANK * sizeof(T) + sizeof(int));
  int rows = 0;                  // rows per block whose V fits in shared memory
  for (int r = RMAX; r >= 1 && rows == 0; --r)
    if (fixed + (size_t)r * a.nu * sizeof(T) <= SMEM_CAP) rows = r;
  if (rows == 0) return cudaErrorInvalidConfiguration;  // a row does not fit
  a.rows = rows;
  const int nb = (a.nd + rows - 1) / rows;
  if (nblocks) *nblocks = nb;
  const size_t smem = fixed + (size_t)rows * a.nu * sizeof(T);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      row_gather_kernel<T, RMAX, Blocked, Power>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  if (err != cudaSuccess) return err;
  row_gather_kernel<T, RMAX, Blocked, Power><<<nb, NT, smem, stream>>>(
      a, ssq_in, partials);
  return cudaGetLastError();
}

// The fused matvec's operands on the blocked layout, (ddp, dup) padded; the
// diagonal factors (ddp, 8) and (dup, 8) have their nonzeros in the first
// `rank` columns.
template <typename T>
Args<T> blocked_args(const T* v3, T* w3, const int* up_idx, const T* up_val,
                     int wup, const int* dw_idx, const T* dw_val, int wdw,
                     const T* diag_a, const T* diag_b, int rank,
                     const int* runs_i, const T* runs_v, int nruns, int ddp,
                     int dup) {
  return Args<T>{v3, w3, up_idx, up_val, dw_idx, dw_val, diag_a, diag_b,
                 runs_i, runs_v, nruns, rank, wup, wdw, ddp, dup, 0};
}

}  // namespace

extern "C" {

// B1: W3 = H V3 on the column-blocked layout, in f64.
cudaError_t fused_normal_matvec_f64(const double* v3, double* w3,
                                    const int* up_idx, const double* up_val,
                                    int wup, const int* dw_idx,
                                    const double* dw_val, int wdw,
                                    const double* diag_a, const double* diag_b,
                                    int rank, const int* runs_i,
                                    const double* runs_v, int nruns, int ddp,
                                    int dup, cudaStream_t stream) {
  return launch<double, true>(
      blocked_args(v3, w3, up_idx, up_val, wup, dw_idx, dw_val, wdw, diag_a,
                   diag_b, rank, runs_i, runs_v, nruns, ddp, dup),
      stream);
}

// B2: the same product in f32.
cudaError_t fused_normal_matvec_f32(const float* v3, float* w3,
                                    const int* up_idx, const float* up_val,
                                    int wup, const int* dw_idx,
                                    const float* dw_val, int wdw,
                                    const float* diag_a, const float* diag_b,
                                    int rank, const int* runs_i,
                                    const float* runs_v, int nruns, int ddp,
                                    int dup, cudaStream_t stream) {
  return launch<float, true>(
      blocked_args(v3, w3, up_idx, up_val, wup, dw_idx, dw_val, wdw, diag_a,
                   diag_b, rank, runs_i, runs_v, nruns, ddp, dup),
      stream);
}

// B3: niter chained steps from v3 (left untouched), B2's operands. Step it
// reads v3 (it = 0) or the buffer step it-1 wrote, and writes buf[it % 2];
// the last product is in buf[(niter-1) % 2]. ssq[0] must hold 1 on entry;
// step it writes ssq[it+1] and norms[it]. partials holds ddp floats of
// scratch (one per block of at least one row). 2 * niter launches on one
// stream.
cudaError_t fused_normal_power_f32(const float* v3, float* buf0, float* buf1,
                                   const int* up_idx, const float* up_val,
                                   int wup, const int* dw_idx,
                                   const float* dw_val, int wdw,
                                   const float* diag_a, const float* diag_b,
                                   int rank, const int* runs_i,
                                   const float* runs_v, int nruns, int ddp,
                                   int dup, float* partials,
                                   float* ssq, float* norms, int niter,
                                   cudaStream_t stream) {
  float* bufs[2] = {buf0, buf1};
  for (int it = 0; it < niter; ++it) {
    const float* vin = it == 0 ? v3 : bufs[(it - 1) % 2];
    int nb = 0;
    cudaError_t err = launch<float, true, true>(
        blocked_args(vin, bufs[it % 2], up_idx, up_val, wup, dw_idx, dw_val,
                     wdw, diag_a, diag_b, rank, runs_i, runs_v, nruns, ddp,
                     dup),
        stream, ssq + it, partials, &nb);
    if (err != cudaSuccess) return err;
    power_finalize_kernel<<<1, FIN_NT, 0, stream>>>(partials, nb, ssq + it + 1,
                                                    norms + it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// B4: out = D V + V Hup^T + Hdw V on row-major (dd, du) f32, any dd, du.
cudaError_t kron_tiles_matvec_f32(const float* v, const float* d,
                                  const int* up_idx, const float* up_val,
                                  int wup, const int* dw_idx,
                                  const float* dw_val, int wdw, float* out,
                                  int dd, int du, cudaStream_t stream) {
  Args<float> a{v, out, up_idx, up_val, dw_idx, dw_val, d, nullptr,
                nullptr, nullptr, 0, 0, wup, wdw, dd, du, 0};
  return launch<float, false>(a, stream);
}

const char* fused_normal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
