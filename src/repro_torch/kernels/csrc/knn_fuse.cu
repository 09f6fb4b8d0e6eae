// kNN-fusion serving (paper Eq. 19) over the static cell-candidate plan.
//
// Replaces the TPU kernel src/repro/kernels/knn_fuse.py:_knn_fuse_kernel
// (launched by knn_fuse_pallas).  Per query q:
//   candidates  the row of q's grid cell, valid where cell_mask & alive;
//   select      the k nearest valid candidates by squared distance, ties to
//               the lower column (argmin / disable / repeat, as the
//               reference's selection network);
//   evaluate    for each field b and each pick s:
//               f_s(x) = sum_j [nbr_mask] coef[b,s,j] exp(-gamma |x - x_{b,s,j}|^2);
//   average     out[b, q] = mean of f over the valid picks (0 if none).
//
// Design.  The Pallas kernel re-ran the selection for every field; here a
// block of kQ queries selects ONCE per query (one thread each, writing the
// picks to shared memory), then all threads of the block evaluate the
// (query, field) pairs, consecutive threads on consecutive queries of one
// field so the output row is written coalesced.  Selection arithmetic is
// kept unfused (__fmul_rn / __fadd_rn), so the distances, and hence the
// selected sets, are bit-for-bit those of the plain PyTorch version.
// Types: positions/queries T (float or double), anchor storage A (float,
// double or bf16, widened with __bfloat162float), coefficients and output T.
//
// Bound.  Bytes: each evaluation reads a pick's D anchors, mask and
// coefficients (D * (d * sizeof(A) + 1 + sizeof(T)) bytes) for ~D*(3d+4)
// flops; the anchor tables of the picked sensors are the traffic floor and
// stay in L2 across queries of neighbouring cells.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float expo(float v) { return expf(v); }
__device__ __forceinline__ double expo(double v) { return exp(v); }

template <typename T>
__device__ __forceinline__ T sq_dist(const T* x, const T* p, int d) {
    T diff = sub_rn(x[0], p[0]);
    T acc = mul_rn(diff, diff);
    for (int c = 1; c < d; ++c) {
        diff = sub_rn(x[c], p[c]);
        acc = add_rn(acc, mul_rn(diff, diff));
    }
    return acc;
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads) knn_fuse_kernel(
    const T* __restrict__ xq, const int32_t* __restrict__ qcell,
    const int32_t* __restrict__ cells, const uint8_t* __restrict__ cmask,
    const uint8_t* __restrict__ alive, const T* __restrict__ spos,
    const A* __restrict__ nbr_pos, const uint8_t* __restrict__ nbr_mask,
    const T* __restrict__ coef, T* __restrict__ out, int32_t* __restrict__ sel_out,
    int Q, int d, int C, int K, int R, int B, int D, int k, int kQ, T neg_gamma) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int32_t* sel = reinterpret_cast<int32_t*>(smem_raw);  // (kQ, k) picked rows
    int32_t* cnt = sel + kQ * k;                           // (kQ,) valid picks
    const int q0 = blockIdx.x * kQ;

    if (threadIdx.x < kQ) {  // select: one thread per query
        const int t = threadIdx.x, q = q0 + t;
        int n_ok = 0;
        if (q < Q) {
            const T* x = xq + static_cast<size_t>(q) * d;
            const int cid = qcell[q];
            const bool cell_ok = cid >= 0 && cid < C;
            const int32_t* cand = cells + static_cast<size_t>(cell_ok ? cid : 0) * K;
            const uint8_t* cm = cmask + static_cast<size_t>(cell_ok ? cid : 0) * K;
            T last_d = T(0);
            int last_col = -1;
            for (int j = 0; j < k && cell_ok; ++j) {
                T best_d = T(0);
                int best_col = -1;
                for (int col = 0; col < K; ++col) {
                    const int s = cand[col];
                    if (!cm[col] || s < 0 || s >= R || !alive[s]) continue;
                    const T d2 = sq_dist(x, spos + static_cast<size_t>(s) * d, d);
                    // only candidates after the last pick in (distance, column) order
                    if (last_col >= 0 && (d2 < last_d || (d2 == last_d && col <= last_col))) continue;
                    if (best_col < 0 || d2 < best_d) { best_d = d2; best_col = col; }
                }
                if (best_col < 0) break;  // fewer than k valid candidates
                sel[t * k + n_ok++] = cand[best_col];
                last_d = best_d;
                last_col = best_col;
            }
            if (sel_out != nullptr)
                for (int j = 0; j < k; ++j)
                    sel_out[static_cast<size_t>(q) * k + j] = j < n_ok ? sel[t * k + j] : -1;
        }
        cnt[t] = n_ok;
    }
    __syncthreads();

    for (int p = threadIdx.x; p < kQ * B; p += blockDim.x) {  // evaluate
        const int t = p % kQ, b = p / kQ, q = q0 + t;
        if (q >= Q) continue;
        const T* x = xq + static_cast<size_t>(q) * d;
        const int n_ok = cnt[t];
        T acc = T(0);
        for (int j = 0; j < n_ok; ++j) {
            const size_t row = static_cast<size_t>(b) * R + sel[t * k + j];
            const A* anc = nbr_pos + row * D * d;
            const uint8_t* msk = nbr_mask + row * D;
            const T* cf = coef + row * D;
            T f = T(0);
            for (int a = 0; a < D; ++a) {
                if (!msk[a]) continue;
                T dd = T(0);
                for (int c = 0; c < d; ++c) {
                    const T diff = x[c] - static_cast<T>(widen(anc[a * d + c]));
                    dd += diff * diff;
                }
                f += expo(neg_gamma * dd) * cf[a];
            }
            acc += f;
        }
        out[static_cast<size_t>(b) * Q + q] = acc / static_cast<T>(n_ok > 0 ? n_ok : 1);
    }
}

template <typename T, typename A>
int launch(const void* xq, const void* qcell, const void* cells, const void* cmask,
           const void* alive, const void* spos, const void* nbr_pos, const void* nbr_mask,
           const void* coef, void* out, void* sel_out, int Q, int d, int C, int K, int R,
           int B, int D, int k, int kQ, double gamma, cudaStream_t stream) {
    if (Q == 0) return 0;
    const size_t smem = static_cast<size_t>(kQ) * (k + 1) * sizeof(int32_t);
    cudaError_t err = repro::allow_smem(knn_fuse_kernel<T, A>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((Q + kQ - 1) / kQ);
    knn_fuse_kernel<T, A><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(xq), static_cast<const int32_t*>(qcell),
        static_cast<const int32_t*>(cells), static_cast<const uint8_t*>(cmask),
        static_cast<const uint8_t*>(alive), static_cast<const T*>(spos),
        static_cast<const A*>(nbr_pos), static_cast<const uint8_t*>(nbr_mask),
        static_cast<const T*>(coef), static_cast<T*>(out), static_cast<int32_t*>(sel_out),
        Q, d, C, K, R, B, D, k, kQ, static_cast<T>(-gamma));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (queries, positions, coefficients, output): 0 = float32, 1 = float64.
// anchor_dtype (nbr_pos storage): 0 = float32, 1 = float64, 2 = bfloat16.
// sel_out may be null; otherwise (Q, k) int32 picks, -1 past the valid ones.
// block_q queries per block, at most 128.  Returns the cudaError_t (0 = ok).
REPRO_EXPORT int knn_fuse_launch(
    int dtype, int anchor_dtype, const void* xq, const void* qcell, const void* cells,
    const void* cmask, const void* alive, const void* spos, const void* nbr_pos,
    const void* nbr_mask, const void* coef, void* out, void* sel_out, int Q, int d,
    int C, int K, int R, int B, int D, int k, int block_q, double gamma, void* stream) {
    if (block_q < 1 || block_q > kThreads || k < 1 || d < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
#define REPRO_KNN(T, A)                                                                   \
    return launch<T, A>(xq, qcell, cells, cmask, alive, spos, nbr_pos, nbr_mask, coef,   \
                        out, sel_out, Q, d, C, K, R, B, D, k, block_q, gamma, st)
    if (dtype == 0 && anchor_dtype == 0) REPRO_KNN(float, float);
    if (dtype == 0 && anchor_dtype == 1) REPRO_KNN(float, double);
    if (dtype == 0 && anchor_dtype == 2) REPRO_KNN(float, __nv_bfloat16);
    if (dtype == 1 && anchor_dtype == 0) REPRO_KNN(double, float);
    if (dtype == 1 && anchor_dtype == 1) REPRO_KNN(double, double);
    if (dtype == 1 && anchor_dtype == 2) REPRO_KNN(double, __nv_bfloat16);
#undef REPRO_KNN
    return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT const char* knn_fuse_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
