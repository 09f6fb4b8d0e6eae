// Fused RBF kernel matvec: out[b, q] = sum_j coef[b, j] exp(-gamma |xq_q - a_{b,j}|^2).
//
// Replaces the TPU kernels src/repro/kernels/kernel_matvec.py:_batched_kernel
// (B fields, launched by kernel_matvec_batched_pallas) and :_kernel (B = 1,
// launched by kernel_matvec_pallas).  Distances use the expanded square
// |x|^2 + |a|^2 - 2 x.a clamped at 0, as the reference does, in IEEE float32
// (no TF32, no tensor cores), and the (Q, N) kernel matrix never exists in
// memory.
//
// Bound.  One exp per (query, non-zero anchor) pair and ~(d + 3) float32
// operations around it: the SFU's 16 exps per SM per clock bound it (4.2e12
// exp/s on 132 SMs at 1.98 GHz).  The exp is ex2.approx.ftz on an argument
// pre-scaled by gamma log2(e): the query carries 2 k x and -k |x|^2, the
// anchor -k |a|^2 (k = gamma log2 e), so a term is
//   e = 2^clamp(-k|x|^2 - k|a|^2 + sum_c (2 k x_c) a_c),
// d FMAs, one add, one clamp and one MUFU op; expf would add ~6 FMA-pipe
// instructions of range reduction per term.  Its error against expf of the
// unscaled argument is a few float32 ulps, far inside the 2e-5 bound.
//
// Design (launch plan: kernels/kernel_matvec.py:launch_plan).
//  * Grid (tiles x cluster, B); a cluster of C CTAs shares one query tile of
//    kThreads x kPer queries (kPer per thread, in registers, so every anchor
//    read from shared memory serves kPer exps) and splits the field's
//    anchor axis between its CTAs.
//  * Zero coefficients are skipped exactly (their term is +0), and the split
//    is balanced by NON-ZERO count, not by index: per window of C x span
//    anchors, CTA r compacts the non-zero indices of its span of the window
//    into shared memory (warp ballots and a prefix over the warps, in index
//    order); after a cluster barrier every CTA reads all C counts and copies
//    ranks [r tot / C, (r + 1) tot / C) of the window's compacted list from
//    the owners' shared memory (distributed shared memory), building its
//    rows (coordinates, -k |a|^2, coefficient) from global memory.  The conn
//    route's field holds 1000 live anchors followed by 7400 zero stream
//    slots; each CTA gets 125 of the live ones, not 1050 raw indices.
//  * Two accumulators per query (even and odd rows) break the dependent
//    sum chain; they are folded into the totals every 64 rows.
//  * The C partial sums of a query are added in a fixed order (rank 0 to
//    C - 1) through distributed shared memory, CTA r writing its 1/C of the
//    tile's outputs: no atomics, so two calls give the same bits.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 8;
constexpr int kMaxCluster = 8;
constexpr int kFold = 64;  // rows summed per block before the block joins the total
constexpr double kLog2e = 1.4426950408889634074;

__device__ __forceinline__ float ex2(float v) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
    return r;
}

// kDp: coordinates padded to 2, 4 or 8 (padded ones are 0 on both sides, so
// they add exact zeros); kPer: queries per thread; kPos: gamma >= 0 (the
// clamp of the square at 0 bounds the scaled argument from above).
template <int kDp, int kPer, bool kPos>
__global__ void __launch_bounds__(kThreads, 4) kernel_matvec_kernel(
    const float* __restrict__ xq, const float* __restrict__ anchors,
    const float* __restrict__ coef, float* __restrict__ out, int Q, int N, int d,
    long long anchor_bstride, float k, int span) {
    // floats per anchor row: kDp coordinates, -k |a|^2 and the coefficient,
    // rounded up to whole float4s
    constexpr int kS = (kDp + 2 + 3) / 4 * 4;
    extern __shared__ __align__(16) float smem[];
    float* rows = smem;                                      // (span, kS) this CTA's share
    float* part = rows + static_cast<size_t>(span) * kS;     // (kPer * kThreads) partial sums
    int* idx = reinterpret_cast<int*>(part + kPer * kThreads);  // (span,) compacted indices
    __shared__ int warp_cnt[kWarps];
    __shared__ int cnt_self;
    __shared__ int cnt_all[kMaxCluster];

    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int q0 = (blockIdx.x / C) * (kPer * kThreads);
    const float* A = anchors + b * anchor_bstride;
    const float* cf = coef + static_cast<size_t>(b) * N;

    // the thread's queries q0 + i * kThreads + tid: 2 k x and -k |x|^2
    float xs[kPer][kDp];
    float nx[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int q = q0 + i * kThreads + tid;
        float sq = 0.0f;
#pragma unroll
        for (int c = 0; c < kDp; ++c) {
            const float v = (c < d && q < Q) ? xq[static_cast<size_t>(q) * d + c] : 0.0f;
            sq = fmaf(v, v, sq);
            xs[i][c] = 2.0f * k * v;
        }
        nx[i] = -k * sq;
    }
    float acc[kPer][2];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i][0] = acc[i][1] = 0.0f;

    const long long window = static_cast<long long>(C) * span;
    for (long long w0 = 0; w0 < N; w0 += window) {
        // 1. compact the non-zero indices of this CTA's span, in index order
        const int per_warp = span / kWarps;  // a multiple of 32
        const long long lo = w0 + static_cast<long long>(rank) * span + warp * per_warp;
        int n_warp = 0;
        for (int t = lane; t < per_warp; t += 32) {
            const long long j = lo + t;
            n_warp += __popc(__ballot_sync(0xffffffffu, j < N && cf[j] != 0.0f));
        }
        if (lane == 0) warp_cnt[warp] = n_warp;
        __syncthreads();
        int off = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            off += w < warp ? warp_cnt[w] : 0;
            total += warp_cnt[w];
        }
        for (int t = lane; t < per_warp; t += 32) {
            const long long j = lo + t;
            const bool nz = j < N && cf[j] != 0.0f;  // exact: the term is +0
            const unsigned m = __ballot_sync(0xffffffffu, nz);
            if (nz) idx[off + __popc(m & ((1u << lane) - 1u))] = static_cast<int>(j);
            off += __popc(m);
        }
        if (tid == 0) cnt_self = total;
        cluster.sync();  // every CTA's list and count are written

        // 2. take ranks [r tot / C, (r + 1) tot / C) of the window's list
        if (tid < C) cnt_all[tid] = *cluster.map_shared_rank(&cnt_self, tid);
        __syncthreads();
        int tot = 0;
        for (int s = 0; s < C; ++s) tot += cnt_all[s];
        const int my_lo = static_cast<int>(static_cast<long long>(rank) * tot / C);
        const int n_mine = static_cast<int>(static_cast<long long>(rank + 1) * tot / C) - my_lo;
        for (int i = tid; i < n_mine; i += kThreads) {
            int g = my_lo + i, s = 0;
            while (g >= cnt_all[s]) g -= cnt_all[s++];
            const int j = *cluster.map_shared_rank(idx + g, s);
            const float* a = A + static_cast<size_t>(j) * d;
            float* row = rows + i * kS;
            float sq = 0.0f;
#pragma unroll
            for (int c = 0; c < kDp; ++c) {
                const float v = c < d ? a[c] : 0.0f;
                sq = fmaf(v, v, sq);
                row[c] = v;
            }
            row[kDp] = -k * sq;
            row[kDp + 1] = cf[j];
        }
        cluster.sync();  // shares copied (lists may be refilled), rows visible

        // 3. evaluate this CTA's share for its queries, two rows at a time, in
        //    blocks of kFold rows whose sums join the totals (the rounding of
        //    a long share grows with its block count, not its row count)
        auto term = [&](const float (&r)[kS], int i) {
            float u = nx[i] + r[kDp];
#pragma unroll
            for (int c = 0; c < kDp; ++c) u = fmaf(xs[i][c], r[c], u);
            u = kPos ? fminf(u, 0.0f) : fmaxf(u, 0.0f);
            return ex2(u) * r[kDp + 1];
        };
        auto load = [&](int t, float (&r)[kS]) {
#pragma unroll
            for (int v = 0; v < kS / 4; ++v) {
                const float4 f = reinterpret_cast<const float4*>(rows + t * kS)[v];
                r[4 * v] = f.x;
                r[4 * v + 1] = f.y;
                r[4 * v + 2] = f.z;
                r[4 * v + 3] = f.w;
            }
        };
        for (int t0 = 0; t0 < n_mine; t0 += kFold) {
            float blk[kPer][2];
#pragma unroll
            for (int i = 0; i < kPer; ++i) blk[i][0] = blk[i][1] = 0.0f;
            const int t1 = min(n_mine, t0 + kFold);
            int t = t0;
            for (; t + 1 < t1; t += 2) {
                float r0[kS], r1[kS];
                load(t, r0);
                load(t + 1, r1);
#pragma unroll
                for (int i = 0; i < kPer; ++i) {
                    blk[i][0] += term(r0, i);
                    blk[i][1] += term(r1, i);
                }
            }
            if (t < t1) {
                float r0[kS];
                load(t, r0);
#pragma unroll
                for (int i = 0; i < kPer; ++i) blk[i][0] += term(r0, i);
            }
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                acc[i][0] += blk[i][0];
                acc[i][1] += blk[i][1];
            }
        }
    }

    // 4. add the cluster's partial sums in rank order; CTA r writes its 1/C
#pragma unroll
    for (int i = 0; i < kPer; ++i) part[i * kThreads + tid] = acc[i][0] + acc[i][1];
    cluster.sync();
    constexpr int kTile = kPer * kThreads;
    const int hi = (rank + 1) * kTile / C;
    for (int t = rank * kTile / C + tid; t < hi; t += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < C; ++r) s += *cluster.map_shared_rank(part + t, r);
        if (q0 + t < Q) out[static_cast<size_t>(b) * Q + q0 + t] = s;
    }
    cluster.sync();  // no CTA leaves while a partner may read its partial sums
}

template <int kDp, int kPer, bool kPos>
int launch(const float* xq, const float* anchors, const float* coef, float* out, int Q, int N,
           int d, int B, long long bstride, float k, int tiles, int cluster, int span,
           size_t smem, cudaStream_t stream) {
    auto kernel = kernel_matvec_kernel<kDp, kPer, kPos>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(tiles * cluster), static_cast<unsigned>(B), 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, xq, anchors, coef, out, Q, N, d, bstride, k, span);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <int kDp, int kPer>
int launch_sign(bool pos, const float* xq, const float* anchors, const float* coef, float* out,
                int Q, int N, int d, int B, long long bstride, float k, int tiles,
                int cluster, int span, size_t smem, cudaStream_t st) {
    if (pos)
        return launch<kDp, kPer, true>(xq, anchors, coef, out, Q, N, d, B, bstride, k, tiles,
                                       cluster, span, smem, st);
    return launch<kDp, kPer, false>(xq, anchors, coef, out, Q, N, d, B, bstride, k, tiles,
                                    cluster, span, smem, st);
}

template <int kDp>
int launch_per(int per, bool pos, const float* xq, const float* anchors, const float* coef,
               float* out, int Q, int N, int d, int B, long long bstride, float k, int tiles,
               int cluster, int span, size_t smem, cudaStream_t st) {
#define REPRO_MATVEC(P)                                                                    \
    return launch_sign<kDp, P>(pos, xq, anchors, coef, out, Q, N, d, B, bstride, k, tiles, \
                               cluster, span, smem, st)
    if (per == 1) REPRO_MATVEC(1);
    if (per == 2) REPRO_MATVEC(2);
    REPRO_MATVEC(4);
#undef REPRO_MATVEC
}

}  // namespace

// xq (Q, d), anchors (B, N, d) with batch stride anchor_bstride elements (0:
// one anchor set shared by all fields), coef (B, N), out (B, Q); float32,
// d <= 8.  The launch plan comes from the wrapper
// (kernels/kernel_matvec.py:launch_plan): per_thread queries per thread
// (1, 2 or 4), tiles query tiles of 128 x per_thread, clusters of `cluster`
// CTAs (at most 8) over the anchor axis, `span` anchors per CTA per window
// (a multiple of 128), padded_dim coordinates per row (2, 4 or 8) and
// `smem` bytes of dynamic shared memory.  Returns the cudaError_t of the
// launch (0 = success).
REPRO_EXPORT int kernel_matvec_launch(
    const void* xq, const void* anchors, const void* coef, void* out, int Q, int N, int d,
    int B, long long anchor_bstride, double gamma, int per_thread, int tiles, int cluster,
    int span, int padded_dim, long long smem, void* stream) {
    const int kS = (padded_dim + 2 + 3) / 4 * 4;
    const long long need = static_cast<long long>(span) * (kS + 1) * 4
        + static_cast<long long>(per_thread) * kThreads * 4;
    if (d < 1 || d > kMaxDim || d > padded_dim ||
        (padded_dim != 2 && padded_dim != 4 && padded_dim != 8) ||
        (per_thread != 1 && per_thread != 2 && per_thread != 4) || cluster < 1 ||
        cluster > kMaxCluster || span < kThreads || span % kThreads != 0 || smem < need ||
        static_cast<long long>(tiles) * per_thread * kThreads < Q || B > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (Q == 0 || B == 0) return 0;
    const float k = static_cast<float>(gamma * kLog2e);
    auto st = static_cast<cudaStream_t>(stream);
    auto x = static_cast<const float*>(xq);
    auto a = static_cast<const float*>(anchors);
    auto c = static_cast<const float*>(coef);
    auto o = static_cast<float*>(out);
    const size_t sm = static_cast<size_t>(smem);
    const bool pos = gamma >= 0.0;
    if (padded_dim == 2)
        return launch_per<2>(per_thread, pos, x, a, c, o, Q, N, d, B, anchor_bstride, k, tiles,
                             cluster, span, sm, st);
    if (padded_dim == 4)
        return launch_per<4>(per_thread, pos, x, a, c, o, Q, N, d, B, anchor_bstride, k, tiles,
                             cluster, span, sm, st);
    return launch_per<8>(per_thread, pos, x, a, c, o, Q, N, d, B, anchor_bstride, k, tiles,
                         cluster, span, sm, st);
}

REPRO_EXPORT const char* kernel_matvec_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
