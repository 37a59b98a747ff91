// Fused f64 normal-sector matvec  W3 = H · V3  for Hopper (sm_90a).
//
// Replaces the TPU kernel edipack_tpu/ops/pallas_fused.py:_matvec_ds_kernel
// (body _column_block_ds). That kernel carried double-single hi/lo f32
// planes because the TPU has no f64; the H100 has native FP64, so this is
// one kernel in plain f64 and the caller needs no merge or polish.
//
// Layout (imp-MSB column-blocked, see ops/fused_normal.py):
//   V3[(j*ddp + d)*128 + c] = V[d, j*128 + c],  j < nbu, d < ddp = nbd*128.
// For output column block j and row d:
//   W[d,c] = (sum_k a[d,k] b[j*128+c,k]) * V3[j*ddp+d, c]                 diag
//          + sum_s sum_e V3[up_src[m]*ddp+d, e] * up_vals[m][e][c]          up
//                         (m over up_ptr[j] .. up_ptr[j+1])
//          + sum_s sum_e dw_vals[m][e][d%128] * V3[j*ddp+dw_src[m]*128+e, c] dw
//                         (m over dw_ptr[d/128] .. dw_ptr[d/128+1])
//          + sum_runs val * V[sd0+d-dd0, su0+u-du0]   for u=j*128+c inside the
//            run's rectangle [dd0,dd0+ld) x [du0,du0+lu)               Jx / Jp
//
// What bounds it on the card: at config 2's (7,7) sector (ddp=dup=3456,
// 27x27 tiles, 6.74 blocks per column on average for each factor) a matvec
// is about 2*ddp*dup*128*(6.74+6.74) = 41 GFLOP of FP64 and reads V3
// (96 MB) about 15 times, about 1.4 GB. At the H100's FP64 rate that is
// compute-bound, so the design keeps the FMA pipes fed:
//   * one thread block owns one 128x128 output tile (row block r, column
//     block j) and writes it once: no atomics, deterministic sums;
//   * each factor block product is a 128x128x128 GEMM staged through
//     shared memory in K-chunks of 16 (33 KB of shared memory, never a
//     whole 128 KB f64 block); the next chunk is fetched into registers
//     while the current one is multiplied;
//   * every thread holds an 8x8 register tile of the output with a stride
//     of 16 rows / 16 columns, so the shared-memory reads are broadcast or
//     conflict-free, and each k-step is 64 FP64 FMAs per 16 loads;
//   * the diagonal and the run shifts are folded into the epilogue.
// FP64 tensor cores (mma / wgmma) and TMA pipelines are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;        // factor block size
constexpr int KC = 16;          // K-chunk staged in shared memory
constexpr int NCH = BLK / KC;   // chunks per block product
constexpr int NT = 256;         // threads per thread block
constexpr int LDA = BLK + 1;    // padded A-chunk row: conflict-free transposed store
constexpr int RANK = 8;         // width of the low-rank diagonal factors
constexpr int RUN_FIELDS = 6;   // dd0, sd0, ld, du0, su0, lu

struct Args {
  const double* v3;
  double* w3;
  const double* up_vals;
  const int* up_src;
  const int* up_ptr;
  const double* dw_vals;
  const int* dw_src;
  const int* dw_ptr;
  const double* diag_a;
  const double* diag_b;
  const int* runs_i;
  const double* runs_v;
  int nruns;
  int ddp;
};

// Fetch K-chunk q of this tile's sequence of block products into registers.
// Products 0..nup-1 are the up factor, nup.. the dw factor.
__device__ __forceinline__ void fetch_chunk(const Args& a, int q, int nup,
                                            int up0, int dw0, int r, int j,
                                            int tid, double (&ra)[8],
                                            double (&rb)[8]) {
  const int g = q / NCH;
  const int k0 = (q % NCH) * KC;
  if (g < nup) {
    const int m = up0 + g;
    const size_t src = (size_t)a.up_src[m];
    // A[row][e] = V3[src*ddp + r*128 + row, k0+e]: read rows, store transposed
    const int e = tid % KC;
    const int row0 = tid / KC;
    const double* base = a.v3 + (src * a.ddp + (size_t)r * BLK) * BLK + k0 + e;
#pragma unroll
    for (int p = 0; p < 8; ++p) ra[p] = __ldg(base + (size_t)(row0 + 16 * p) * BLK);
    // B[e][c] = up_vals[m][k0+e][c]
    const int c = tid % BLK;
    const int e0 = tid / BLK;
    const double* bb = a.up_vals + ((size_t)m * BLK + k0 + e0) * BLK + c;
#pragma unroll
    for (int p = 0; p < 8; ++p) rb[p] = __ldg(bb + (size_t)(2 * p) * BLK);
  } else {
    const int m = dw0 + (g - nup);
    const size_t src = (size_t)a.dw_src[m];
    const int x = tid % BLK;
    const int e0 = tid / BLK;
    // A^T[e][row] = dw_vals[m][k0+e][row]: already k-major
    const double* ab = a.dw_vals + ((size_t)m * BLK + k0 + e0) * BLK + x;
#pragma unroll
    for (int p = 0; p < 8; ++p) ra[p] = __ldg(ab + (size_t)(2 * p) * BLK);
    // B[e][c] = V3[j*ddp + src*128 + k0 + e, c]
    const double* bb =
        a.v3 + ((size_t)j * a.ddp + src * BLK + k0 + e0) * BLK + x;
#pragma unroll
    for (int p = 0; p < 8; ++p) rb[p] = __ldg(bb + (size_t)(2 * p) * BLK);
  }
}

__device__ __forceinline__ void store_chunk(bool up, int tid, const double (&ra)[8],
                                            const double (&rb)[8], double* As,
                                            double* Bs) {
  if (up) {
    const int e = tid % KC;
    const int row0 = tid / KC;
#pragma unroll
    for (int p = 0; p < 8; ++p) As[e * LDA + row0 + 16 * p] = ra[p];
  } else {
    const int x = tid % BLK;
    const int e0 = tid / BLK;
#pragma unroll
    for (int p = 0; p < 8; ++p) As[(e0 + 2 * p) * LDA + x] = ra[p];
  }
  const int c = tid % BLK;
  const int e0 = tid / BLK;
#pragma unroll
  for (int p = 0; p < 8; ++p) Bs[(e0 + 2 * p) * BLK + c] = rb[p];
}

__global__ void __launch_bounds__(NT, 1) fused_normal_kernel(const Args a) {
  __shared__ double As[KC * LDA];   // A chunk, k-major: As[e][row]
  __shared__ double Bs[KC * BLK];   // B chunk: Bs[e][col]

  const int r = blockIdx.x;         // row block of d
  const int j = blockIdx.y;         // column block of u
  const int tid = threadIdx.x;
  const int tx = tid % 16;          // owns columns tx + 16*jj
  const int ty = tid / 16;          // owns rows    ty + 16*i

  const int up0 = a.up_ptr[j];
  const int nup = a.up_ptr[j + 1] - up0;
  const int dw0 = a.dw_ptr[r];
  const int ndw = a.dw_ptr[r + 1] - dw0;
  const int nq = (nup + ndw) * NCH;

  double acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0;

  double ra[8], rb[8];
  if (nq > 0) fetch_chunk(a, 0, nup, up0, dw0, r, j, tid, ra, rb);
  for (int q = 0; q < nq; ++q) {
    __syncthreads();
    store_chunk(q / NCH < nup, tid, ra, rb, As, Bs);
    __syncthreads();
    if (q + 1 < nq) fetch_chunk(a, q + 1, nup, up0, dw0, r, j, tid, ra, rb);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      double bv[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) bv[jj] = Bs[k * BLK + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const double av = As[k * LDA + ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fma(av, bv[jj], acc[i][jj]);
      }
    }
  }

  // ---- epilogue: stage the tile's diagonal factors in shared memory ----
  __syncthreads();
  double* da = As;                  // da[row][k], rows r*128 ..
  double* dbt = Bs;                 // dbt[k][col], cols j*128 ..
  for (int t = tid; t < BLK * RANK; t += NT) {
    da[t] = a.diag_a[(size_t)r * BLK * RANK + t];
    dbt[(t % RANK) * BLK + t / RANK] = a.diag_b[(size_t)j * BLK * RANK + t];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dl = ty + 16 * i;
    const int d = r * BLK + dl;
    double arow[RANK];
#pragma unroll
    for (int k = 0; k < RANK; ++k) arow[k] = da[dl * RANK + k];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = tx + 16 * jj;
      const int u = j * BLK + c;
      double dg = 0.0;
#pragma unroll
      for (int k = 0; k < RANK; ++k) dg = fma(arow[k], dbt[k * BLK + c], dg);
      const size_t o = ((size_t)j * a.ddp + d) * BLK + c;
      double w = fma(dg, __ldg(a.v3 + o), acc[i][jj]);
      for (int n = 0; n < a.nruns; ++n) {
        const int* ri = a.runs_i + n * RUN_FIELDS;
        const int dd = d - ri[0];
        const int du = u - ri[3];
        if (dd >= 0 && dd < ri[2] && du >= 0 && du < ri[5]) {
          const int us = ri[4] + du;
          const int ds = ri[1] + dd;
          w = fma(a.runs_v[n],
                  __ldg(a.v3 + ((size_t)(us / BLK) * a.ddp + ds) * BLK + us % BLK),
                  w);
        }
      }
      a.w3[o] = w;
    }
  }
}

}  // namespace

extern "C" {

cudaError_t fused_normal_matvec_f64(const double* v3, double* w3,
                                    const double* up_vals, const int* up_src,
                                    const int* up_ptr, const double* dw_vals,
                                    const int* dw_src, const int* dw_ptr,
                                    const double* diag_a, const double* diag_b,
                                    const int* runs_i, const double* runs_v,
                                    int nruns, int ddp, int nbu, int nbd,
                                    cudaStream_t stream) {
  Args a{v3, w3, up_vals, up_src, up_ptr, dw_vals, dw_src, dw_ptr,
         diag_a, diag_b, runs_i, runs_v, nruns, ddp};
  fused_normal_kernel<<<dim3(nbd, nbu), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

const char* fused_normal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
