// Fused RBF kernel matvec: out[b, q] = sum_j coef[b, j] exp(-gamma |xq_q - a_{b,j}|^2).
//
// Replaces the TPU kernels src/repro/kernels/kernel_matvec.py:_batched_kernel
// (B fields, launched by kernel_matvec_batched_pallas) and :_kernel (B = 1,
// launched by kernel_matvec_pallas).  Distances use the expanded square
// |x|^2 + |a|^2 - 2 x.a clamped at 0, as the reference does, in IEEE float32
// (no TF32, no tensor cores), and the (Q, N) kernel matrix never exists in
// memory.
//
// Design.  Grid (Q / 128, B): one thread per query, its coordinates in
// registers; the block streams the field's anchors through shared memory in
// tiles of kTile (coordinates, |a|^2 and coefficient), every thread reading
// the same anchor at once (a shared-memory broadcast).  Anchors whose
// coefficient is exactly 0 are skipped: with gamma > 0 their term is an exact
// +0, and the conn route's reserved streaming anchors are mostly such zeros.
//
// Bound.  Operations: ~(3d + 4) flops and one exp per (query, non-zero
// anchor) pair, against O((Q + N) d) bytes; the float32 exp is the limit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr int kMaxDim = 8;

__global__ void __launch_bounds__(kThreads) kernel_matvec_kernel(
    const float* __restrict__ xq, const float* __restrict__ anchors,
    const float* __restrict__ coef, float* __restrict__ out, int Q, int N, int d,
    long long anchor_bstride, float neg_gamma) {
    extern __shared__ __align__(16) float smem[];
    float* sa = smem;              // (kTile, d) anchor coordinates
    float* ssq = sa + kTile * d;   // (kTile,) |a|^2
    float* sc = ssq + kTile;       // (kTile,) coefficients
    const int b = blockIdx.y;
    const int q = blockIdx.x * kThreads + threadIdx.x;
    const float* A = anchors + b * anchor_bstride;
    const float* cf = coef + static_cast<size_t>(b) * N;

    float x[kMaxDim];
    float sqx = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxDim; ++c) {
        x[c] = (c < d && q < Q) ? xq[static_cast<size_t>(q) * d + c] : 0.0f;
        if (c < d) sqx += x[c] * x[c];
    }
    float acc = 0.0f;
    for (int j0 = 0; j0 < N; j0 += kTile) {
        const int nt = min(kTile, N - j0);
        __syncthreads();  // the previous tile is consumed
        for (int t = threadIdx.x; t < nt; t += kThreads) {
            float s = 0.0f;
            for (int c = 0; c < d; ++c) {
                const float v = A[static_cast<size_t>(j0 + t) * d + c];
                sa[t * d + c] = v;
                s += v * v;
            }
            ssq[t] = s;
            sc[t] = cf[j0 + t];
        }
        __syncthreads();
        for (int t = 0; t < nt; ++t) {
            const float w = sc[t];
            if (w == 0.0f) continue;  // exact: the term is +0 (gamma > 0)
            float cross = 0.0f;
#pragma unroll
            for (int c = 0; c < kMaxDim; ++c)
                if (c < d) cross += x[c] * sa[t * d + c];
            const float d2 = fmaxf(sqx + ssq[t] - 2.0f * cross, 0.0f);
            acc += expf(neg_gamma * d2) * w;
        }
    }
    if (q < Q) out[static_cast<size_t>(b) * Q + q] = acc;
}

}  // namespace

// xq (Q, d), anchors (B, N, d) with batch stride anchor_bstride elements (0:
// one anchor set shared by all fields), coef (B, N), out (B, Q); float32.
// d <= 8.  Returns the cudaError_t of the launch (0 = success).
REPRO_EXPORT int kernel_matvec_launch(
    const void* xq, const void* anchors, const void* coef, void* out, int Q, int N,
    int d, int B, long long anchor_bstride, double gamma, void* stream) {
    if (d < 1 || d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
    if (Q == 0 || B == 0) return 0;
    const size_t smem = static_cast<size_t>(kTile) * (d + 2) * sizeof(float);
    cudaError_t err = repro::allow_smem(kernel_matvec_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Q + kThreads - 1) / kThreads, B);
    kernel_matvec_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xq), static_cast<const float*>(anchors),
        static_cast<const float*>(coef), static_cast<float*>(out), Q, N, d,
        anchor_bstride, static_cast<float>(-gamma));
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* kernel_matvec_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
