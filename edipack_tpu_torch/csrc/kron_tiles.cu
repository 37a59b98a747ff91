// Dense-tile Kronecker sector matvec  out = D ⊙ V + V · Hupᵀ + Hdw · V  in
// f32 for Hopper (sm_90a).
//
// Replaces the TPU kernel edipack_tpu/ops/pallas_kron.py:_kernel_fused
// (kron_matvec_pallas / KronPallasMatvec). That kernel ran each 128x128
// output tile as two MXU products on whole VMEM-resident panels (the row
// panel of V times the column panel of Hupᵀ, the row panel of Hdw times
// the column panel of V) and wrote the tile once. A Hopper block holds at
// most 227 KB of shared memory, far from a 3456-long f32 panel pair, so the
// same two products stream through shared memory in K-chunks.
//
// Shapes: V, D (ddp, dup), Hupᵀ (dup, dup), Hdw (ddp, ddp), row-major f32,
// ddp and dup multiples of 128 (the caller zero-pads).
//
// What bounds it on the card: at config 2's (7,7) sector padded to 3456²,
// the operands are 4 × 48 MB and the output 48 MB; the hop factors hold
// ~6 nonzeros per row, so the function needs 0.34 GFLOP and is bound by
// its bytes (0.071 ms at 3.35 TB/s). Like the TPU kernel, this one
// multiplies the factors as dense tiles, 2·3456²·(3456+3456) ≈ 165 GFLOP
// per call, which bounds it by its own FP32 FMA work (2.46 ms at
// 67 TFLOP/s). Within that design the FMA pipes are kept fed as in kernel
// B1 (fused_normal.cu):
//   * one thread block owns one 128x128 output tile (row block r, column
//     block j) and writes it once: no atomics, deterministic sums;
//   * the two GEMMs feed one register accumulator: K-chunks of 16 of the
//     row panel of V times the column panel of Hupᵀ (K = dup), then of the
//     row panel of Hdw times the column panel of V (K = ddp), staged in
//     shared memory with the next chunk fetched into registers while the
//     current one is multiplied;
//   * every thread holds an 8x8 register tile of the output with a stride
//     of 16 rows / 16 columns (64 FMAs per 16 shared-memory loads);
//   * D ⊙ V is added in the epilogue.
// A sparse-aware product and a TMA pipeline are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;        // output tile edge
constexpr int KC = 16;          // K-chunk staged in shared memory
constexpr int NT = 256;         // threads per thread block
constexpr int LDA = BLK + 1;    // padded A-chunk row: conflict-free transposed store

struct Args {
  const float* v;
  const float* d;
  const float* hup_t;
  const float* hdw;
  float* out;
  int ddp;
  int dup;
};

// Fetch K-chunk q of the tile's two products into registers: chunks
// 0..nq1-1 are A = V[rows, k], B = Hupᵀ[k, cols]; the rest A = Hdw[rows, k],
// B = V[k, cols].
__device__ __forceinline__ void fetch_chunk(const Args& a, int q, int nq1,
                                            int r, int j, int tid,
                                            float (&ra)[8], float (&rb)[8]) {
  const bool first = q < nq1;
  const int k0 = (first ? q : q - nq1) * KC;
  const float* amat = first ? a.v : a.hdw;
  const int lda = first ? a.dup : a.ddp;
  const float* bmat = first ? a.hup_t : a.v;
  // A[row][e] = amat[(r*128 + row)*lda + k0 + e]: read rows, store transposed
  const int e = tid % KC;
  const int row0 = tid / KC;
  const float* ab = amat + ((size_t)r * BLK + row0) * lda + k0 + e;
#pragma unroll
  for (int p = 0; p < 8; ++p) ra[p] = __ldg(ab + (size_t)(16 * p) * lda);
  // B[e][c] = bmat[(k0 + e)*dup + j*128 + c]
  const int c = tid % BLK;
  const int e0 = tid / BLK;
  const float* bb = bmat + (size_t)(k0 + e0) * a.dup + (size_t)j * BLK + c;
#pragma unroll
  for (int p = 0; p < 8; ++p) rb[p] = __ldg(bb + (size_t)(2 * p) * a.dup);
}

__global__ void __launch_bounds__(NT, 1) kron_tiles_kernel(const Args a) {
  __shared__ float As[KC * LDA];    // A chunk, k-major: As[e][row]
  __shared__ float Bs[KC * BLK];    // B chunk: Bs[e][col]

  const int r = blockIdx.x;         // row tile of d
  const int j = blockIdx.y;         // column tile of u
  const int tid = threadIdx.x;
  const int tx = tid % 16;          // owns columns tx + 16*jj
  const int ty = tid / 16;          // owns rows    ty + 16*i
  const int nq1 = a.dup / KC;
  const int nq = nq1 + a.ddp / KC;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

  float ra[8], rb[8];
  fetch_chunk(a, 0, nq1, r, j, tid, ra, rb);
  for (int q = 0; q < nq; ++q) {
    __syncthreads();
    {
      const int e = tid % KC;
      const int row0 = tid / KC;
#pragma unroll
      for (int p = 0; p < 8; ++p) As[e * LDA + row0 + 16 * p] = ra[p];
      const int c = tid % BLK;
      const int e0 = tid / BLK;
#pragma unroll
      for (int p = 0; p < 8; ++p) Bs[(e0 + 2 * p) * BLK + c] = rb[p];
    }
    __syncthreads();
    if (q + 1 < nq) fetch_chunk(a, q + 1, nq1, r, j, tid, ra, rb);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float bv[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) bv[jj] = Bs[k * BLK + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = As[k * LDA + ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av, bv[jj], acc[i][jj]);
      }
    }
  }

  // ---- epilogue: D ⊙ V ----
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (size_t)r * BLK + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const size_t o = row * a.dup + (size_t)j * BLK + tx + 16 * jj;
      a.out[o] = fmaf(__ldg(a.d + o), __ldg(a.v + o), acc[i][jj]);
    }
  }
}

}  // namespace

extern "C" {

cudaError_t kron_tiles_matvec_f32(const float* v, const float* d,
                                  const float* hup_t, const float* hdw,
                                  float* out, int ddp, int dup,
                                  cudaStream_t stream) {
  Args a{v, d, hup_t, hdw, out, ddp, dup};
  kron_tiles_kernel<<<dim3(ddp / BLK, dup / BLK), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
