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
// Design.  One warp per query; a block holds block_q warps (queries).
//  * Select.  The lanes walk the cell row (lane l takes columns l, l + 32,
//    ...), compute each valid candidate's squared distance ONCE into shared
//    memory (+inf for an invalid one) and keep the selection arithmetic
//    unfused (__fmul_rn / __fadd_rn / __fsub_rn), so the distances, and
//    hence the selected sets, are bit-for-bit those of the plain PyTorch
//    version.  Each of the k picks is a warp-wide arg-min over (distance,
//    column) pairs compared lexicographically (a lane scans its own columns
//    in order, then a 5-step xor butterfly), the winner's column struck out:
//    torch.argmin's first-minimum rule, so exact ties go to the lower
//    column as in the reference.  The Pallas kernel re-ran the selection for
//    every field; here it runs once per query.
//  * Evaluate.  The warp splits into 32 / G groups of G lanes (G the power
//    of two >= D, at most 32), one field per group at a time; lane l of a
//    group takes anchors l, l + G, ... of every pick's row, so adjacent lanes
//    read adjacent anchors of one (field, pick) row, and the group's sum is
//    an xor-shuffle reduction in a fixed order.
// Types: positions/queries T (float or double), anchor storage A (float,
// double or bf16, widened with __bfloat162float), coefficients and output T.
//
// Bound.  Bytes: each evaluation reads a pick's D anchors, mask and
// coefficients (D * (d * sizeof(A) + 1 + sizeof(T)) bytes) for ~D*(3d+4)
// flops and D exps; the anchor tables of the picked sensors are the traffic
// floor and stay in L2 across queries of neighbouring cells.  At Q = 4096
// the grid is a single wave (4096 warps, ~31 per SM).  The launch and the
// selection (a chain of dependent loads: cell row -> candidate rows) take a
// fixed part of the time, which chip_smoke times alone as selection_ms; the
// evaluation's part grows with B x k, so its cost per term (address
// arithmetic, expf, four loads), not a load chain, sets it at B = 16.
#include "common.cuh"

#include <cuda_bf16.h>

#include <cmath>

namespace {

constexpr int kMaxWarps = 8;  // queries (warps) per block

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
__global__ void __launch_bounds__(32 * kMaxWarps) knn_fuse_kernel(
    const T* __restrict__ xq, const int32_t* __restrict__ qcell,
    const int32_t* __restrict__ cells, const uint8_t* __restrict__ cmask,
    const uint8_t* __restrict__ alive, const T* __restrict__ spos,
    const A* __restrict__ nbr_pos, const uint8_t* __restrict__ nbr_mask,
    const T* __restrict__ coef, T* __restrict__ out, int32_t* __restrict__ sel_out,
    int Q, int d, int C, int K, int R, int B, int D, int k, int G, T neg_gamma) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    T* dist = reinterpret_cast<T*>(smem_raw) + warp * K;  // (warps, K) candidate distances
    int32_t* picks = reinterpret_cast<int32_t*>(reinterpret_cast<T*>(smem_raw) + warps * K)
        + warp * k;  // (warps, k) picked rows
    const int q = blockIdx.x * warps + warp;
    if (q >= Q) return;  // a whole warp: no block barrier follows
    const T* x = xq + static_cast<size_t>(q) * d;
    const T inf = static_cast<T>(INFINITY);

    // select: distances once, then k warp-wide arg-mins over (distance, column)
    int n_ok = 0;
    const int cid = qcell[q];
    if (cid >= 0 && cid < C) {
        const int32_t* cand = cells + static_cast<size_t>(cid) * K;
        const uint8_t* cm = cmask + static_cast<size_t>(cid) * K;
        for (int col = lane; col < K; col += 32) {
            const int s = cand[col];
            const bool ok = cm[col] && s >= 0 && s < R && alive[s];
            dist[col] = ok ? sq_dist(x, spos + static_cast<size_t>(s) * d, d) : inf;
        }
        __syncwarp();
        for (int j = 0; j < k; ++j) {
            T best = inf;
            int best_col = 0x7fffffff;
            for (int col = lane; col < K; col += 32) {  // columns in order: ties keep the first
                const T v = dist[col];
                if (v < best) { best = v; best_col = col; }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const T ov = __shfl_xor_sync(0xffffffffu, best, off);
                const int oc = __shfl_xor_sync(0xffffffffu, best_col, off);
                if (ov < best || (ov == best && oc < best_col)) { best = ov; best_col = oc; }
            }
            if (!(best < inf)) break;  // fewer than k valid candidates (uniform)
            if (lane == 0) picks[j] = cand[best_col];
            if (lane == (best_col & 31)) dist[best_col] = inf;  // struck out
            __syncwarp();
            ++n_ok;
        }
    }
    if (sel_out != nullptr)
        for (int j = lane; j < k; j += 32)
            sel_out[static_cast<size_t>(q) * k + j] = j < n_ok ? picks[j] : -1;

    // evaluate: group g of G lanes takes fields g, g + 32 / G, ...
    const int grp = lane / G, l = lane % G;
    const T denom = static_cast<T>(n_ok > 0 ? n_ok : 1);
    for (int b0 = 0; b0 < B; b0 += 32 / G) {
        const int b = b0 + grp;
        T acc = T(0);
        if (b < B) {
            // mask, coefficient and anchor are loaded together (no load waits
            // on the mask), and the picks' rows are unrolled so their loads
            // are in flight at once
#pragma unroll 4
            for (int j = 0; j < n_ok; ++j) {
                const size_t row = (static_cast<size_t>(b) * R + picks[j]) * D;
                for (int a = l; a < D; a += G) {
                    const bool on = nbr_mask[row + a];
                    const T w = coef[row + a];
                    const A* anc = nbr_pos + (row + a) * d;
                    T dd = T(0);
                    for (int c = 0; c < d; ++c) {
                        const T diff = x[c] - static_cast<T>(widen(anc[c]));
                        dd += diff * diff;
                    }
                    if (on) acc += expo(neg_gamma * dd) * w;
                }
            }
        }
        for (int off = G >> 1; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (l == 0 && b < B) out[static_cast<size_t>(b) * Q + q] = acc / denom;
    }
}

template <typename T, typename A>
int launch(const void* xq, const void* qcell, const void* cells, const void* cmask,
           const void* alive, const void* spos, const void* nbr_pos, const void* nbr_mask,
           const void* coef, void* out, void* sel_out, int Q, int d, int C, int K, int R,
           int B, int D, int k, int kQ, double gamma, cudaStream_t stream) {
    if (Q == 0) return 0;
    const size_t smem = static_cast<size_t>(kQ) * (K * sizeof(T) + k * sizeof(int32_t));
    cudaError_t err = repro::allow_smem(knn_fuse_kernel<T, A>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int G = 1;  // lanes per field in the evaluation: the power of two >= D, at most 32
    while (G < D && G < 32) G <<= 1;
    const unsigned blocks = static_cast<unsigned>((Q + kQ - 1) / kQ);
    knn_fuse_kernel<T, A><<<blocks, 32 * kQ, smem, stream>>>(
        static_cast<const T*>(xq), static_cast<const int32_t*>(qcell),
        static_cast<const int32_t*>(cells), static_cast<const uint8_t*>(cmask),
        static_cast<const uint8_t*>(alive), static_cast<const T*>(spos),
        static_cast<const A*>(nbr_pos), static_cast<const uint8_t*>(nbr_mask),
        static_cast<const T*>(coef), static_cast<T*>(out), static_cast<int32_t*>(sel_out),
        Q, d, C, K, R, B, D, k, G, static_cast<T>(-gamma));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (queries, positions, coefficients, output): 0 = float32, 1 = float64.
// anchor_dtype (nbr_pos storage): 0 = float32, 1 = float64, 2 = bfloat16.
// sel_out may be null; otherwise (Q, k) int32 picks, -1 past the valid ones.
// block_q queries (warps) per block, at most 8.  Returns the cudaError_t (0 = ok).
REPRO_EXPORT int knn_fuse_launch(
    int dtype, int anchor_dtype, const void* xq, const void* qcell, const void* cells,
    const void* cmask, const void* alive, const void* spos, const void* nbr_pos,
    const void* nbr_mask, const void* coef, void* out, void* sel_out, int Q, int d,
    int C, int K, int R, int B, int D, int k, int block_q, double gamma, void* stream) {
    if (block_q < 1 || block_q > kMaxWarps || k < 1 || k > K || d < 1)
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
