// Tiled RBF Gram matrix, float32:
//   K[i, j] = exp(-gamma max(|x1_i|^2 + |x2_j|^2 - 2 x1_i . x2_j, 0)).
//
// Replaces the TPU kernel src/repro/kernels/gram.py:_kernel (launched by
// rbf_gram_pallas).  The expanded square is clamped at 0 as the reference
// does, in IEEE float32 (no TF32, no tensor cores, expf and not __expf).
//
// Bound.  Bytes: the (M, N) float32 output is written once, against O((M +
// N) d) bytes read and ~(2d + 4) flops and one exp per element; the output
// bytes are the limit, so the design is about the stores.
//
// Design.  Each thread owns 4 consecutive columns and kRows rows of the
// output: the 4 anchors' coordinates and squared norms sit in its
// registers, each row's coordinates are read by every thread of the warp at
// one address (a broadcast from L1), and each row's 4 results leave as one
// 16-byte streaming store (st.global.cs: the output is written once and
// read by no later kernel here, so it should not evict L2).  A block of
// kThreadsX x kThreadsY threads covers 4 kThreadsX columns by kRows
// kThreadsY rows; a warp's stores are 512 contiguous bytes of one row.  The
// tile, 4 rows x 4 columns a thread and 64 x 4 threads (16 rows x 256
// columns, 16 KB a block), was the fastest of 12 tile shapes (2 to 32 rows
// a thread, 32 to 128 threads across) timed on an H100 at 4096 x 8400,
// d = 2.  No shared memory and no barrier.  Where N is not a multiple of 4 (each row
// then starts off a 16-byte boundary) or the output is not 16-byte
// aligned, every store is scalar; the last columns of a row are scalar
// stores in any case.
#include "common.cuh"

namespace {

constexpr int kMaxDim = 8;
constexpr int kCols = 4;  // columns per thread: one float4
constexpr int kRows = 4;  // rows per thread
constexpr int kThreadsX = 64, kThreadsY = 4;
constexpr int kTileCols = kCols * kThreadsX, kTileRows = kRows * kThreadsY;

template <int D>
__global__ void __launch_bounds__(kThreadsX * kThreadsY) rbf_gram_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2, float* __restrict__ out,
    int M, int N, int tiles_n, bool vec, float neg_gamma) {
    const int tm = blockIdx.x / tiles_n, tn = blockIdx.x - tm * tiles_n;
    const int j = tn * kTileCols + kCols * threadIdx.x;
    const int i0 = tm * kTileRows + kRows * threadIdx.y;
    if (j >= N || i0 >= M) return;
    float b[kCols][D], bsq[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
        float sq = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
            const float v = j + q < N ? __ldg(x2 + static_cast<size_t>(j + q) * D + c) : 0.0f;
            b[q][c] = v;
            sq += v * v;
        }
        bsq[q] = sq;
    }
    const bool full = vec && j + kCols <= N;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i >= M) break;
        float a[D];
        float asq = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
            a[c] = __ldg(x1 + static_cast<size_t>(i) * D + c);
            asq += a[c] * a[c];
        }
        float k[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
            float cross = 0.0f;
#pragma unroll
            for (int c = 0; c < D; ++c) cross += a[c] * b[q][c];
            const float d2 = fmaxf(asq + bsq[q] - 2.0f * cross, 0.0f);
            k[q] = expf(neg_gamma * d2);
        }
        float* row = out + static_cast<size_t>(i) * N + j;
        if (full) {
            __stcs(reinterpret_cast<float4*>(row), make_float4(k[0], k[1], k[2], k[3]));
        } else {
#pragma unroll
            for (int q = 0; q < kCols; ++q)
                if (j + q < N) __stcs(row + q, k[q]);
        }
    }
}

}  // namespace

// x1 (M, d), x2 (N, d), out (M, N); float32, contiguous; 1 <= d <= 8.
// Returns the cudaError_t of the launch (0 = success).  A 1-D grid of (row
// tiles x column tiles).
REPRO_EXPORT int rbf_gram_launch(const void* x1, const void* x2, void* out, int M, int N,
                                 int d, double gamma, void* stream) {
    if (d < 1 || d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0 || N == 0) return 0;
    const int tiles_n = (N + kTileCols - 1) / kTileCols;
    const long long tiles = static_cast<long long>((M + kTileRows - 1) / kTileRows) * tiles_n;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid(static_cast<unsigned>(tiles)), block(kThreadsX, kThreadsY);
    const auto* a = static_cast<const float*>(x1);
    const auto* b = static_cast<const float*>(x2);
    auto* k = static_cast<float*>(out);
    const float neg_gamma = static_cast<float>(-gamma);
    auto* s = static_cast<cudaStream_t>(stream);
#define REPRO_GRAM_CASE(DIM)                                                                \
    case DIM:                                                                               \
        rbf_gram_kernel<DIM><<<grid, block, 0, s>>>(a, b, k, M, N, tiles_n, vec, neg_gamma); \
        break;
    switch (d) {
        REPRO_GRAM_CASE(1) REPRO_GRAM_CASE(2) REPRO_GRAM_CASE(3) REPRO_GRAM_CASE(4)
        REPRO_GRAM_CASE(5) REPRO_GRAM_CASE(6) REPRO_GRAM_CASE(7) REPRO_GRAM_CASE(8)
    }
#undef REPRO_GRAM_CASE
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* gram_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
