// Fused normal-sector matvec  W3 = H · V3  for Hopper (sm_90a) in f32 (B2),
// and the f32 chained power steps (B3), as dense 128x128 factor tiles.
//
// Replaces the TPU kernels of edipack_tpu/ops/pallas_fused.py:
//   * _matvec_kernel (body _column_block) -> fused_normal_matvec_f32: the
//     product in full FP32 FMA (the TPU kernel's 'default' precision is
//     one bf16 pass; 'highest' is full f32).
//   * _power_kernel -> fused_normal_power_f32: niter chained steps
//     w = H v, v = w / |w| with the normalization folded lazily into the
//     next step. The TPU grid carried the sum of squares from one grid step
//     to the next; Hopper blocks run in no order, so each step is one tile
//     pass that reads scale = rsqrt(ssq[it]) from device memory, writes
//     scale * H V and one partial sum of squares per tile, followed by a
//     one-block finalize that reduces the partials in a fixed order
//     (deterministic, no atomics) into norms[it] and ssq[it + 1]. The two V
//     buffers ping-pong; 2 * niter launches on one stream, no host sync.
// The f64 matvec of the same operator (B1, _matvec_ds_kernel) is the sparse
// row-gather kernel of row_gather.cu; B2 and B3 move to it next.
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
// 27x27 tiles, 6.74 blocks per column on average for each factor) H has
// about 1.7e8 nonzeros, so the function needs 0.5 GFLOP and is bound by
// its bytes: V3 and W3 (48 MB each) and 24 MB of factor blocks, 0.036 ms
// at 3.35 TB/s. The blocks are under 1 % filled (a hop matrix has ~6
// nonzeros per row), but this design multiplies them as dense 128x128
// tiles: 2*ddp*dup*128*(6.74+6.74) = 41 GFLOP per matvec, which bounds the
// kernel by its own FMA work. Within the dense-tile design the FMA pipes
// are kept fed:
//   * one thread block owns one 128x128 output tile (row block r, column
//     block j) and writes it once: no atomics, deterministic sums;
//   * each factor block product is a 128x128x128 GEMM staged through
//     shared memory in K-chunks of 16; the next chunk is fetched into
//     registers while the current one is multiplied;
//   * every thread holds an 8x8 register tile of the output with a stride
//     of 16 rows / 16 columns, so the shared-memory reads are broadcast or
//     conflict-free, and each k-step is 64 FMAs per 16 loads;
//   * the diagonal and the run shifts are folded into the epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;        // factor block size
constexpr int KC = 16;          // K-chunk staged in shared memory
constexpr int NCH = BLK / KC;   // chunks per block product
constexpr int NT = 256;         // threads per thread block
constexpr int LDA = BLK + 1;    // padded A-chunk row: conflict-free transposed store
constexpr int RANK = 8;         // width of the low-rank diagonal factors
constexpr int RUN_FIELDS = 6;   // dd0, sd0, ld, du0, su0, lu

template <typename T>
struct Args {
  const T* v3;
  T* w3;
  const T* up_vals;
  const int* up_src;
  const int* up_ptr;
  const T* dw_vals;
  const int* dw_src;
  const int* dw_ptr;
  const T* diag_a;
  const T* diag_b;
  const int* runs_i;
  const T* runs_v;
  int nruns;
  int ddp;
};

// Fetch K-chunk q of this tile's sequence of block products into registers.
// Products 0..nup-1 are the up factor, nup.. the dw factor.
template <typename T>
__device__ __forceinline__ void fetch_chunk(const Args<T>& a, int q, int nup,
                                            int up0, int dw0, int r, int j,
                                            int tid, T (&ra)[8], T (&rb)[8]) {
  const int g = q / NCH;
  const int k0 = (q % NCH) * KC;
  if (g < nup) {
    const int m = up0 + g;
    const size_t src = (size_t)a.up_src[m];
    // A[row][e] = V3[src*ddp + r*128 + row, k0+e]: read rows, store transposed
    const int e = tid % KC;
    const int row0 = tid / KC;
    const T* base = a.v3 + (src * a.ddp + (size_t)r * BLK) * BLK + k0 + e;
#pragma unroll
    for (int p = 0; p < 8; ++p) ra[p] = __ldg(base + (size_t)(row0 + 16 * p) * BLK);
    // B[e][c] = up_vals[m][k0+e][c]
    const int c = tid % BLK;
    const int e0 = tid / BLK;
    const T* bb = a.up_vals + ((size_t)m * BLK + k0 + e0) * BLK + c;
#pragma unroll
    for (int p = 0; p < 8; ++p) rb[p] = __ldg(bb + (size_t)(2 * p) * BLK);
  } else {
    const int m = dw0 + (g - nup);
    const size_t src = (size_t)a.dw_src[m];
    const int x = tid % BLK;
    const int e0 = tid / BLK;
    // A^T[e][row] = dw_vals[m][k0+e][row]: already k-major
    const T* ab = a.dw_vals + ((size_t)m * BLK + k0 + e0) * BLK + x;
#pragma unroll
    for (int p = 0; p < 8; ++p) ra[p] = __ldg(ab + (size_t)(2 * p) * BLK);
    // B[e][c] = V3[j*ddp + src*128 + k0 + e, c]
    const T* bb = a.v3 + ((size_t)j * a.ddp + src * BLK + k0 + e0) * BLK + x;
#pragma unroll
    for (int p = 0; p < 8; ++p) rb[p] = __ldg(bb + (size_t)(2 * p) * BLK);
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(bool up, int tid, const T (&ra)[8],
                                            const T (&rb)[8], T* As, T* Bs) {
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

// One 128x128 output tile (row block blockIdx.x, column block blockIdx.y):
// hands every output element (its offset in W3 and its value) to `store`.
template <typename T, typename Store>
__device__ __forceinline__ void fused_tile(const Args<T>& a, T* As, T* Bs,
                                           Store store) {
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

  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = T(0);

  T ra[8], rb[8];
  if (nq > 0) fetch_chunk(a, 0, nup, up0, dw0, r, j, tid, ra, rb);
  for (int q = 0; q < nq; ++q) {
    __syncthreads();
    store_chunk(q / NCH < nup, tid, ra, rb, As, Bs);
    __syncthreads();
    if (q + 1 < nq) fetch_chunk(a, q + 1, nup, up0, dw0, r, j, tid, ra, rb);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      T bv[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) bv[jj] = Bs[k * BLK + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const T av = As[k * LDA + ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fma(av, bv[jj], acc[i][jj]);
      }
    }
  }

  // ---- epilogue: stage the tile's diagonal factors in shared memory ----
  __syncthreads();
  T* da = As;                       // da[row][k], rows r*128 ..
  T* dbt = Bs;                      // dbt[k][col], cols j*128 ..
  for (int t = tid; t < BLK * RANK; t += NT) {
    da[t] = a.diag_a[(size_t)r * BLK * RANK + t];
    dbt[(t % RANK) * BLK + t / RANK] = a.diag_b[(size_t)j * BLK * RANK + t];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dl = ty + 16 * i;
    const int d = r * BLK + dl;
    T arow[RANK];
#pragma unroll
    for (int k = 0; k < RANK; ++k) arow[k] = da[dl * RANK + k];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = tx + 16 * jj;
      const int u = j * BLK + c;
      T dg = T(0);
#pragma unroll
      for (int k = 0; k < RANK; ++k) dg = fma(arow[k], dbt[k * BLK + c], dg);
      const size_t o = ((size_t)j * a.ddp + d) * BLK + c;
      T w = fma(dg, __ldg(a.v3 + o), acc[i][jj]);
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
      store(o, w);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) fused_normal_kernel(const Args<T> a) {
  __shared__ T As[KC * LDA];        // A chunk, k-major: As[e][row]
  __shared__ T Bs[KC * BLK];        // B chunk: Bs[e][col]
  fused_tile(a, As, Bs, [&](size_t o, T w) { a.w3[o] = w; });
}

// One power step: W3 = rsqrt(ssq_in[0]) * H V3, and this tile's sum of
// squares of W3 into partials[blockIdx.y * gridDim.x + blockIdx.x].
__global__ void __launch_bounds__(NT, 1)
fused_power_step_kernel(const Args<float> a, const float* ssq_in,
                        float* partials) {
  __shared__ float As[KC * LDA];
  __shared__ float Bs[KC * BLK];
  __shared__ float red[NT];
  const float scale = rsqrtf(*ssq_in);
  float ss = 0.f;
  fused_tile(a, As, Bs, [&](size_t o, float w) {
    w *= scale;
    a.w3[o] = w;
    ss = fmaf(w, w, ss);
  });
  const int tid = threadIdx.x;
  red[tid] = ss;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {   // fixed-order tree: deterministic
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// ssq_out = sum of the n tile partials (in f64, fixed order), norm_out =
// its square root. One block of NT threads.
__global__ void __launch_bounds__(NT, 1)
power_finalize_kernel(const float* partials, int n, float* ssq_out,
                      float* norm_out) {
  __shared__ double red[NT];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < n; i += NT) s += partials[i];
  red[tid] = s;
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) {
    *ssq_out = (float)red[0];
    *norm_out = (float)sqrt(red[0]);
  }
}

template <typename T>
cudaError_t launch_matvec(const T* v3, T* w3, const T* up_vals,
                          const int* up_src, const int* up_ptr,
                          const T* dw_vals, const int* dw_src,
                          const int* dw_ptr, const T* diag_a, const T* diag_b,
                          const int* runs_i, const T* runs_v, int nruns,
                          int ddp, int nbu, int nbd, cudaStream_t stream) {
  Args<T> a{v3, w3, up_vals, up_src, up_ptr, dw_vals, dw_src, dw_ptr,
            diag_a, diag_b, runs_i, runs_v, nruns, ddp};
  fused_normal_kernel<T><<<dim3(nbd, nbu), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t fused_normal_matvec_f32(const float* v3, float* w3,
                                    const float* up_vals, const int* up_src,
                                    const int* up_ptr, const float* dw_vals,
                                    const int* dw_src, const int* dw_ptr,
                                    const float* diag_a, const float* diag_b,
                                    const int* runs_i, const float* runs_v,
                                    int nruns, int ddp, int nbu, int nbd,
                                    cudaStream_t stream) {
  return launch_matvec<float>(v3, w3, up_vals, up_src, up_ptr, dw_vals,
                              dw_src, dw_ptr, diag_a, diag_b, runs_i, runs_v,
                              nruns, ddp, nbu, nbd, stream);
}

// niter chained steps from v3 (left untouched). Step it reads v3 (it = 0) or
// the buffer step it-1 wrote, and writes buf[it % 2]; the last product is in
// buf[(niter-1) % 2]. ssq[0] must hold 1 on entry; step it writes ssq[it+1]
// and norms[it]. partials holds nbd*nbu floats of scratch.
cudaError_t fused_normal_power_f32(const float* v3, float* buf0, float* buf1,
                                   const float* up_vals, const int* up_src,
                                   const int* up_ptr, const float* dw_vals,
                                   const int* dw_src, const int* dw_ptr,
                                   const float* diag_a, const float* diag_b,
                                   const int* runs_i, const float* runs_v,
                                   int nruns, int ddp, int nbu, int nbd,
                                   float* partials, float* ssq, float* norms,
                                   int niter, cudaStream_t stream) {
  float* bufs[2] = {buf0, buf1};
  for (int it = 0; it < niter; ++it) {
    const float* vin = it == 0 ? v3 : bufs[(it - 1) % 2];
    Args<float> a{vin, bufs[it % 2], up_vals, up_src, up_ptr, dw_vals, dw_src,
                  dw_ptr, diag_a, diag_b, runs_i, runs_v, nruns, ddp};
    fused_power_step_kernel<<<dim3(nbd, nbu), NT, 0, stream>>>(a, ssq + it,
                                                               partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    power_finalize_kernel<<<1, NT, 0, stream>>>(partials, nbd * nbu,
                                                ssq + it + 1, norms + it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* fused_normal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
