// The colored SN-Train sweep: n_sweeps x n_colors color steps for all B
// fields in ONE launch (one color step is the same kernel at 1 x 1).
//
// Replaces the TPU kernel src/repro/kernels/color_step.py:_color_step_kernel
// (launched by color_step_pallas once per color).  For each sweep t, each
// color c in order, and each (field b, member m) of color c:
//   rhs_k  = mask_k ? z[b, idx_k] + lambda_s * coef[b, s, k] : 0
//            mask_k = nbr_mask[b, s, k] & live_m & alive_z[idx_k]
//            live_m = color_mask[c, m] & alive_row[s],  s = color_members[c, m]
//   coef'  = (L L^T)^{-1} rhs          (forward + back substitution)
//   z'_k   = sum_j gram[b, s, k, j] coef'_j
//   coef[b, s, :] <- coef'             if live_m
//   z[b, idx_k]   <- z'_k              if live_m & alive_z[idx_k] & deliv[t, s, k]
//
// Design.  Fields never interact, so each field is one thread-block cluster
// (at most 8 CTAs, sized by the wrapper's launch plan) and there is no
// grid-wide barrier.  Member slot p (a warp, or a half-warp when D <= 16) of
// the cluster owns the members m = p + k * (slots per cluster) of every
// color.  The distance-2 coloring makes the slots and rows of one color's
// members disjoint, so the slots update z and coef IN PLACE, and one cluster
// barrier (release/acquire at cluster scope) separates two color steps.  z
// and coef are read and written through L2 (__ldcg / __stcg): another SM of
// the cluster wrote them in an earlier step, and an SM's L1 is not
// coherent.  Everything a member needs but z and its coef row (its row,
// slot ids, gates, lambda, its factor and gram) is fetched two items ahead,
// between the step's arrival at the cluster barrier and its wait, so after
// a barrier the z and coef loads are the ones that wait.  Every thread
// reaches every barrier: no thread returns early.
//
// Per member, lane k of its slot (32 lanes, or 16 when D <= 16: a warp then
// solves two members side by side with width-16 shuffles) owns rows k + 32 j
// (k + 16 j) of the D x D system, with no warp reductions.  Each lane takes
// the reciprocal of its diagonal entry off the dependent chain; the forward
// substitution has lane i form y_i, a shuffle broadcasts it, and every lane
// below does acc = fma(-L[k][i], y_i, acc); the back substitution walks the
// columns the same way, and z' = G coef' broadcasts coef'_j the same way.
// The member's factor and gram are contiguous D x D blocks, staged with one
// linear, coalesced pass of 4- or 8-byte cp.async copies into shared memory
// at an odd row stride (D, or D + 1 when D is even), so the column walks hit
// distinct banks; two buffers per slot hold the next two members.  Gated
// lanes never store: the sentinel slot is never written and stays 0.
//
// Bound.  Per call: the factors and grams once (bytes), then per color step
// one cluster barrier, an L2 round trip for the z gather and 2 D dependent
// shuffles: the sweep is latency-bound by its n_sweeps x n_colors dependent
// steps, not by bytes or operations.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxCluster = 8;
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int kW, int kR>
__global__ void __launch_bounds__(kMaxWarps * 32) color_sweep_kernel(
    T* __restrict__ z, T* __restrict__ coef, const int32_t* __restrict__ nbr_idx,
    const uint8_t* __restrict__ nbr_mask, const T* __restrict__ gram,
    const T* __restrict__ chol, const T* __restrict__ lam,
    const uint8_t* __restrict__ alive_row, const uint8_t* __restrict__ alive_z,
    const int32_t* __restrict__ members, const uint8_t* __restrict__ member_mask,
    const uint8_t* __restrict__ deliv, int NZ, int R, int D, int M, int C, int n_sweeps) {
    constexpr int kPer = 32 / kW;  // members a warp solves side by side
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const int warps = static_cast<int>(blockDim.x) >> 5;
    const int warp = static_cast<int>(threadIdx.x) >> 5, lane = threadIdx.x & 31;
    const int sub = lane / kW, sl = lane % kW;  // this lane's member slot and row
    const int gw = static_cast<int>(cluster.block_rank()) * warps + warp;
    const int stride = static_cast<int>(cluster.num_blocks()) * warps * kPer;
    const size_t field = static_cast<size_t>(blockIdx.y) * R;
    const int ld = D | 1;
    const float inv_d = 1.0f / static_cast<float>(D);
    // elements per staged matrix: D rows at stride ld, 16 bytes of slack for
    // the aligned span, rounded to 16 bytes
    const size_t mat = (static_cast<size_t>(D) * ld * sizeof(T) + 31) / 16 * 16 / sizeof(T);
    T* const wbuf =
        reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp * kPer + sub) * 4 * mat;
    T* const zb = z + static_cast<size_t>(blockIdx.y) * NZ;

    // What an item (sweep t, color c, member m) needs besides z and its coef
    // row, all constant for the call: fetched two items ahead.
    struct Item {
        int s;  // the member's row if it is live, else -1
        T lam;
        int q[kR];    // the lane's slot id if it is in range and alive, else -1
        bool on[kR];  // the lane's rhs gate, less the slot's current z
        bool dl[kR];  // the lane's message is delivered in sweep t
    };
    auto fetch = [&](int t, int c, int m) {
        Item it = {-1};
        if (t >= n_sweeps || m >= M) return it;
        const size_t at = static_cast<size_t>(c) * M + m;
        const int s = members[at];
        if (s < 0 || s >= R || member_mask[at] == 0 || alive_row[s] == 0) return it;
        it.s = s;
        it.lam = lam[s];
        const uint8_t* dv =
            deliv == nullptr ? nullptr : deliv + (static_cast<size_t>(t) * R + s) * D;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
            const int r = sl + kW * j;
            it.q[j] = -1;
            if (r < D) {
                const int q = nbr_idx[static_cast<size_t>(s) * D + r];
                const bool ok = q >= 0 && q < NZ && alive_z[q] != 0;
                it.q[j] = ok ? q : -1;
                it.on[j] = ok && nbr_mask[(field + s) * D + r] != 0;
                it.dl[j] = dv == nullptr || dv[r] != 0;
            }
        }
        return it;
    };
    // Stage row s's factor and gram into buffer `slot` (always one commit
    // group); returns the element offsets of the two blocks in the buffer.
    // Odd D (row stride D): 16-byte copies of the 16-byte-aligned span around
    // each contiguous block, which never leaves the tensor's own 16-byte
    // chunks.  Even D: element copies to row stride D + 1.
    auto stage = [&](int s, int slot) {
        int2 off = make_int2(0, 0);
        if (s >= 0) {
            const T* L = chol + (field + s) * D * D;
            const T* G = gram + (field + s) * D * D;
            T* dL = wbuf + slot * 2 * mat;
            T* dG = dL + mat;
            if (ld == D) {
                const uintptr_t aL = reinterpret_cast<uintptr_t>(L) & 15u;
                const uintptr_t aG = reinterpret_cast<uintptr_t>(G) & 15u;
                off = make_int2(static_cast<int>(aL / sizeof(T)),
                                static_cast<int>(aG / sizeof(T)));
                const int n16 = static_cast<int>((15 + D * D * sizeof(T) + 15) / 16);
                const char* sL = reinterpret_cast<const char*>(L) - aL;
                const char* sG = reinterpret_cast<const char*>(G) - aG;
                const char* endL = reinterpret_cast<const char*>(L + D * D);
                const char* endG = reinterpret_cast<const char*>(G + D * D);
                for (int k = sl; k < n16; k += kW) {
                    if (sL + 16 * k < endL)
                        repro::cp_async<16>(reinterpret_cast<char*>(dL) + 16 * k, sL + 16 * k);
                    if (sG + 16 * k < endG)
                        repro::cp_async<16>(reinterpret_cast<char*>(dG) + 16 * k, sG + 16 * k);
                }
            } else {
                for (int e = sl; e < D * D; e += kW) {
                    const int at = e + static_cast<int>((e + 0.5f) * inv_d);
                    repro::cp_async<sizeof(T)>(dL + at, L + e);
                    repro::cp_async<sizeof(T)>(dG + at, G + e);
                }
            }
        }
        repro::cp_async_commit();
        return off;
    };

    // The warp walks m0 = gw * kPer, m0 + stride, ... of every color of every
    // sweep; slot `sub` takes member m0 + sub.  (pt, pc, pm) is the item two
    // ahead of the one being solved.
    const int first = gw * kPer;
    int pt = 0, pc = 0, pm = first;
    auto advance = [&]() {
        pm += stride;
        if (pm >= M) {
            pm = first;
            if (++pc == C) pc = 0, ++pt;
        }
    };
    Item a = {-1}, b = {-1};  // the next two items to solve
    int2 off0 = make_int2(0, 0), off1 = off0;  // block offsets in buffers 0 and 1
    if (first < M) {
        a = fetch(pt, pc, pm + sub);
        off0 = stage(a.s, 0);
        advance();
        b = fetch(pt, pc, pm + sub);
        off1 = stage(b.s, 1);
        advance();
    }
    int item = 0;
    for (int t = 0; t < n_sweeps; ++t) {
        for (int c = 0; c < C; ++c) {
            if (first >= M) {  // no member of this field for this warp
                cluster.sync();
                continue;
            }
            for (int m0 = first; m0 < M; m0 += stride, ++item) {
                const Item cur = a;
                a = b;
                // the only loads that wait for the previous color step: z at
                // the member's slots, and its coef row (last written by this
                // slot, possibly in the step just before)
                T zq[kR], cf[kR];
#pragma unroll
                for (int j = 0; j < kR; ++j) {
                    const bool lane_on = cur.s >= 0 && sl + kW * j < D;
                    zq[j] = lane_on && cur.on[j] ? __ldcg(zb + cur.q[j]) : T(0);
                    cf[j] = lane_on && cur.on[j]
                                ? __ldcg(coef + (field + cur.s) * D + sl + kW * j)
                                : T(0);
                }
                repro::cp_async_wait<1>();  // this item's copy has landed
                __syncwarp();
                // every lane of the warp takes part in the shuffles; a dead
                // member's lanes compute on whatever their buffer holds and
                // store nothing
                if (__any_sync(kFull, cur.s >= 0)) {
                    const int2 off = (item & 1) ? off1 : off0;
                    const T* Ls = wbuf + (item & 1) * 2 * mat + off.x;
                    const T* Gs = wbuf + (item & 1) * 2 * mat + mat + off.y;
                    T v[kR], rinv[kR];
#pragma unroll
                    for (int j = 0; j < kR; ++j) {
                        const int r = sl + kW * j;
                        v[j] = cur.s >= 0 && r < D && cur.on[j] ? zq[j] + cur.lam * cf[j] : T(0);
                        rinv[j] = cur.s >= 0 && r < D ? T(1) / Ls[r * ld + r] : T(0);
                    }
                    // L y = rhs: lane i%kW forms y_i, every lower row takes it.
#pragma unroll
                    for (int jb = 0; jb < kR; ++jb) {
                        const int lim = min(kW, D - kW * jb);
#pragma unroll 4
                        for (int ii = 0; ii < lim; ++ii) {
                            const int i = kW * jb + ii;
                            const T yi = __shfl_sync(kFull, v[jb] * rinv[jb], ii, kW);
                            if (sl == ii) v[jb] = yi;
#pragma unroll
                            for (int j = jb; j < kR; ++j) {
                                const int r = sl + kW * j;
                                if (r > i && r < D) v[j] = fma(-Ls[r * ld + i], yi, v[j]);
                            }
                        }
                    }
                    // L^T x = y: the same, up the columns of L.
#pragma unroll
                    for (int jb = kR - 1; jb >= 0; --jb) {
                        const int lim = min(kW, D - kW * jb);
#pragma unroll 4
                        for (int ii = lim - 1; ii >= 0; --ii) {
                            const int i = kW * jb + ii;
                            const T xi = __shfl_sync(kFull, v[jb] * rinv[jb], ii, kW);
                            if (sl == ii) v[jb] = xi;
#pragma unroll
                            for (int j = 0; j <= jb; ++j) {
                                const int r = sl + kW * j;
                                if (r < i) v[j] = fma(-Ls[i * ld + r], xi, v[j]);
                            }
                        }
                    }
                    // z' = G x, then the gated in-place writes.
                    T out[kR];
#pragma unroll
                    for (int j = 0; j < kR; ++j) out[j] = T(0);
#pragma unroll
                    for (int jb = 0; jb < kR; ++jb) {
                        const int lim = min(kW, D - kW * jb);
#pragma unroll 4
                        for (int ii = 0; ii < lim; ++ii) {
                            const int i = kW * jb + ii;
                            const T xi = __shfl_sync(kFull, v[jb], ii, kW);
#pragma unroll
                            for (int j = 0; j < kR; ++j) {
                                const int r = sl + kW * j;
                                if (r < D) out[j] = fma(Gs[r * ld + i], xi, out[j]);
                            }
                        }
                    }
                    if (cur.s >= 0) {
#pragma unroll
                        for (int j = 0; j < kR; ++j) {
                            const int r = sl + kW * j;
                            if (r >= D) continue;
                            __stcg(coef + (field + cur.s) * D + r, v[j]);
                            if (cur.q[j] >= 0 && cur.dl[j]) __stcg(zb + cur.q[j], out[j]);
                        }
                    }
                }
                __syncwarp();  // this item's buffer is free for the item two ahead
                // The step's last item arrives at the cluster barrier, fetches
                // and stages the item two ahead while the barrier completes,
                // then waits: every thread reaches every barrier.
                const bool last = m0 + stride >= M;
                if (last) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
                b = fetch(pt, pc, pm + sub);
                if (item & 1)
                    off1 = stage(b.s, 1);
                else
                    off0 = stage(b.s, 0);
                advance();
                if (last) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
            }
        }
    }
    repro::cp_async_wait<0>();
}

template <typename T, int kW, int kR>
int launch(void* z, void* coef, const void* nbr_idx, const void* nbr_mask, const void* gram,
           const void* chol, const void* lam, const void* alive_row, const void* alive_z,
           const void* members, const void* member_mask, const void* deliv, int B, int NZ,
           int R, int D, int M, int C, int n_sweeps, int warps, int cluster, size_t smem,
           cudaStream_t stream) {
    auto kernel = color_sweep_kernel<T, kW, kR>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(B), 1);
    cfg.blockDim = dim3(static_cast<unsigned>(32 * warps), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<T*>(z), static_cast<T*>(coef),
        static_cast<const int32_t*>(nbr_idx), static_cast<const uint8_t*>(nbr_mask),
        static_cast<const T*>(gram), static_cast<const T*>(chol), static_cast<const T*>(lam),
        static_cast<const uint8_t*>(alive_row), static_cast<const uint8_t*>(alive_z),
        static_cast<const int32_t*>(members), static_cast<const uint8_t*>(member_mask),
        static_cast<const uint8_t*>(deliv), NZ, R, D, M, C, n_sweeps);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(int D, void* z, void* coef, const void* nbr_idx, const void* nbr_mask,
                const void* gram, const void* chol, const void* lam, const void* alive_row,
                const void* alive_z, const void* members, const void* member_mask,
                const void* deliv, int B, int NZ, int R, int M, int C, int n_sweeps, int warps,
                int cluster, size_t smem, cudaStream_t st) {
#define REPRO_COLOR_SWEEP(KW, KR)                                                              \
    return launch<T, KW, KR>(z, coef, nbr_idx, nbr_mask, gram, chol, lam, alive_row, alive_z,     \
                         members, member_mask, deliv, B, NZ, R, D, M, C, n_sweeps, warps,     \
                         cluster, smem, st)
    if (D <= 16) REPRO_COLOR_SWEEP(16, 1);
    if (D <= 32) REPRO_COLOR_SWEEP(32, 1);
    if (D <= 64) REPRO_COLOR_SWEEP(32, 2);
    REPRO_COLOR_SWEEP(32, 4);
#undef REPRO_COLOR_SWEEP
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  members / member_mask are (C, M); deliv
// is the (n_sweeps, R, D) delivery mask or null (all delivered).  The launch
// plan (warps per CTA, CTAs per cluster, dynamic shared memory) comes from
// the wrapper (kernels/color_step.py:launch_plan): four matrices of D (D | 1)
// elements and 16 bytes of slack per member slot, two slots per warp when
// D <= 16.  Returns the cudaError_t of
// the launch (0 = success).
REPRO_EXPORT int color_sweep_launch(
    int dtype, void* z, void* coef, const void* nbr_idx, const void* nbr_mask,
    const void* gram, const void* chol, const void* lam, const void* alive_row,
    const void* alive_z, const void* members, const void* member_mask, const void* deliv,
    int B, int NZ, int R, int D, int M, int C, int n_sweeps, int warps, int cluster,
    long long smem, void* stream) {
    const size_t elem = dtype == 0 ? sizeof(float) : sizeof(double);
    const int per = D <= 16 ? 2 : 1;  // members per warp (16 lanes each when D <= 16)
    const size_t need =
        static_cast<size_t>(warps) * per * 4 * ((D * (D | 1) * elem + 31) / 16 * 16);
    if ((dtype != 0 && dtype != 1) || D < 1 || D > 128 || warps < 1 || warps > kMaxWarps ||
        cluster < 1 || cluster > kMaxCluster || smem < 0 ||
        static_cast<size_t>(smem) < need || static_cast<size_t>(smem) > kMaxSmem || B > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || M == 0 || C == 0 || n_sweeps == 0) return 0;
    auto st = static_cast<cudaStream_t>(stream);
    const size_t sm = static_cast<size_t>(smem);
    if (dtype == 0)
        return launch_rows<float>(D, z, coef, nbr_idx, nbr_mask, gram, chol, lam, alive_row,
                                  alive_z, members, member_mask, deliv, B, NZ, R, M, C,
                                  n_sweeps, warps, cluster, sm, st);
    return launch_rows<double>(D, z, coef, nbr_idx, nbr_mask, gram, chol, lam, alive_row,
                               alive_z, members, member_mask, deliv, B, NZ, R, M, C, n_sweeps,
                               warps, cluster, sm, st);
}

REPRO_EXPORT const char* color_step_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
