// Tiled RBF Gram matrix, float32:
//   K[i, j] = exp(-gamma max(|x1_i|^2 + |x2_j|^2 - 2 x1_i . x2_j, 0)).
//
// Replaces the TPU kernel src/repro/kernels/gram.py:_kernel (launched by
// rbf_gram_pallas).  The expanded square is clamped at 0 as the reference
// does, in IEEE float32 (no TF32, no tensor cores).
//
// Design.  One thread per output element; a block of 64 x 4 threads covers
// 64 columns of 4 rows.  The block stages its 4 x1 rows and 64 x2 rows, with
// their squared norms, in shared memory, so each point is read from device
// memory once per block; neighbouring threads write neighbouring columns.
//
// Bound.  Bytes: the (M, N) float32 output is written once, against O((M +
// N) d) bytes read and ~(2d + 4) flops and one exp per element; the output
// bytes are the limit.
#include "common.cuh"

namespace {

constexpr int kCols = 64;
constexpr int kRows = 4;
constexpr int kMaxDim = 8;

__global__ void __launch_bounds__(kCols * kRows) rbf_gram_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2, float* __restrict__ out,
    int M, int N, int d, float neg_gamma) {
    __shared__ float s1[kRows][kMaxDim + 1];  // coordinates, then |x|^2
    __shared__ float s2[kCols][kMaxDim + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
    const int tid = ty * kCols + tx;
    if (tid < kRows) {
        const int i = i0 + tid;
        float sq = 0.0f;
        for (int c = 0; c < d; ++c) {
            const float v = i < M ? x1[static_cast<size_t>(i) * d + c] : 0.0f;
            s1[tid][c] = v;
            sq += v * v;
        }
        s1[tid][kMaxDim] = sq;
    } else if (tid >= kCols && tid < 2 * kCols) {
        const int t = tid - kCols, j = j0 + t;
        float sq = 0.0f;
        for (int c = 0; c < d; ++c) {
            const float v = j < N ? x2[static_cast<size_t>(j) * d + c] : 0.0f;
            s2[t][c] = v;
            sq += v * v;
        }
        s2[t][kMaxDim] = sq;
    }
    __syncthreads();
    const int i = i0 + ty, j = j0 + tx;
    if (i >= M || j >= N) return;
    float cross = 0.0f;
    for (int c = 0; c < d; ++c) cross += s1[ty][c] * s2[tx][c];
    const float d2 = fmaxf(s1[ty][kMaxDim] + s2[tx][kMaxDim] - 2.0f * cross, 0.0f);
    out[static_cast<size_t>(i) * N + j] = expf(neg_gamma * d2);
}

}  // namespace

// x1 (M, d), x2 (N, d), out (M, N); float32, contiguous; 1 <= d <= 8.
// Returns the cudaError_t of the launch (0 = success).
REPRO_EXPORT int rbf_gram_launch(const void* x1, const void* x2, void* out, int M, int N,
                                 int d, double gamma, void* stream) {
    if (d < 1 || d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0 || N == 0) return 0;
    dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
    rbf_gram_kernel<<<grid, dim3(kCols, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x1), static_cast<const float*>(x2),
        static_cast<float*>(out), M, N, d, static_cast<float>(-gamma));
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* gram_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
