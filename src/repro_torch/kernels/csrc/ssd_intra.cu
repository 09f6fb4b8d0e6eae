// Mamba2 SSD intra-chunk term, float32 in and out:
//   Y[b, z*cs + l, h, :] = sum_{m <= l} CB[l, m] exp(da[l, h] - da[m, h]) dt[m, h] x[m, h, :]
// with CB = C_chunk B_chunk^T shared by all heads (n_groups = 1).
//
// Replaces the TPU kernel src/repro/kernels/ssd_intra.py:_kernel (launched by
// ssd_intra_pallas).
//
// Arithmetic.  Both products (CB over N, and M (x) over the chunk's rows)
// run on the tensor cores in 3xTF32: each operand a is split into hi =
// tf32(a) and lo = tf32(a - hi) (both by truncation), and a b ~ hi_a hi_b +
// hi_a lo_b + lo_a hi_b with float32 accumulation, which keeps ~20 mantissa
// bits per product (one pass of TF32 keeps 10, ~5e-4 relative, beyond the
// 3e-4 bound at the outputs' sizes).  The instruction is the warp-level
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: it takes A straight from
// registers, where the decay M = CB * exp(da[l] - da[m]) * dt[m] is formed
// and split, so M never goes through shared memory (wgmma would need it
// there, in its swizzled K-major layout, for 64-row tiles).  The decay is
// IEEE float32, with the mask applied before the exp (upper-triangle
// differences are positive and would overflow).
//
// Work layout.  A block of 8 warps owns one (batch x chunk), block_h heads
// and a balanced set of 64-row l-tiles: (p, n_lt - 1 - p), so every block
// does n_lt + 1 64 x 64 M (x) tiles per head (l-tile lt takes m-tiles 0..lt).
// Two blocks of a cluster, on consecutive head groups, share one set of CB
// tiles: each forms every other CB tile of the l-tile on the tensor cores and
// copies its partner's half through distributed shared memory, so CB is
// formed H / (2 block_h) times per chunk.  For M (x) the block runs two heads
// at a time: warp (rw, hw) owns rows 16 rw .. +15 and all P columns of head
// 2 j + hw, so each decay entry is formed by one lane and each k-step issues
// up to 24 independent MMAs.  The C and B slices (64 state columns) and the
// two heads' x tiles (64 rows x P) are double-buffered with cp.async: the
// next slice or m-tile loads while the current one is multiplied.  k-steps
// past the diagonal and past the chunk are skipped.  Rows past the chunk and
// columns past P or N are zero-padded in shared memory.
//
// Bound.  Bytes (~36 MB at the prefill's shape) against 3.35 TB/s, or the
// 3xTF32 tensor-core operations against 495 TFLOP/s, whichever is larger;
// the float32-FMA bound of the previous version no longer applies.  One
// block per SM (145 KB of shared memory at chunk 256): eight warps, so the
// dependent chain of each k-step (fragment loads, exp, split, three MMA
// passes) is what holds it above the bound.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kT = 64;         // rows of an l-tile and of an m-tile
constexpr int kLdCB = kT + 4;  // row stride of a CB tile (conflict-free A fragments)
constexpr int kNS = 64;        // state columns per C / B slice
constexpr int kLdS = kNS + 4;  // row stride of a staged slice
constexpr int kMaxP = 64;
constexpr int kLdX = kMaxP + 8;  // row stride of an x tile (conflict-free B fragments)
constexpr int kThreads = 256;
constexpr int kSlice = 2 * kT * kLdS;           // one staged C slice + B slice
constexpr int kXBuf = kT * kLdX + 2 * kT;       // one head's x tile + its dt and da
constexpr int kXStage = 2 * kXBuf;              // two heads in flight
constexpr int kRegion = 2 * (kXStage > kSlice ? kXStage : kSlice);

// a = hi + lo with hi = a truncated to TF32's 10 mantissa bits and lo = (a -
// hi) truncated the same way: plain bit masks, where cvt.rna.tf32 would
// take the conversion pipe.  The error left is ~2^-20 |a| per operand.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A B[nt] in 3xTF32 for the n-tiles nt < n_on, pass by pass (the
// small terms first), so consecutive products go to different accumulators.
template <int kNT>
__device__ __forceinline__ void mma3(float (&acc)[kNT][4], const float (&a)[4],
                                     const float (&b)[kNT][2], int n_on) {
    uint32_t ah[4], al[4], bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
        split(b[nt][0], bh[nt][0], bl[nt][0]);
        split(b[nt][1], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
        if (nt < n_on) mma(acc[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
        if (nt < n_on) mma(acc[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
        if (nt < n_on) mma(acc[nt], ah, bh[nt][0], bh[nt][1]);
}

// Copy rows [0, 64) x cols [0, cols) of a row-major global tile (row stride
// gstride) into shared memory at row stride ld with cp.async; rows >=
// rows_ok and cols >= cols_ok are written as zeros.  vec: 16-byte copies
// (every 4-column group lies wholly inside or outside cols_ok, and the
// addresses are 16-byte aligned).
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long gstride, int rows_ok, int cols,
                                          int cols_ok, bool vec) {
    if (vec) {
        const int c4 = cols / 4;
        for (int i = threadIdx.x; i < kT * c4; i += kThreads) {
            const int r = i / c4, c = (i % c4) * 4;
            float* d = dst + r * ld + c;
            if (r < rows_ok && c < cols_ok)
                repro::cp_async<16>(d, src + r * gstride + c);
            else
                *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int i = threadIdx.x; i < kT * cols; i += kThreads) {
            const int r = i / cols, c = i % cols;
            float* d = dst + r * ld + c;
            if (r < rows_ok && c < cols_ok)
                repro::cp_async<4>(d, src + r * gstride + c);
            else
                *d = 0.0f;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1) ssd_intra_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ da, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ out, int S, int H, int P, int N,
    int cs, int block_h, int vec_n, int vec_p) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int K = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int n_lt = (cs + kT - 1) / kT;
    const int nc = S / cs;
    const int b = static_cast<int>(blockIdx.z) / nc;
    const int zc = static_cast<int>(blockIdx.z) % nc;
    const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(zc) * cs;
    const int h_begin = static_cast<int>(blockIdx.y) * block_h;
    const int h_end = min(H, h_begin + block_h);  // empty for a padding block
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int rw = warp & 3, cw = warp >> 2, hw = cw;
    const int lr0 = 16 * rw + g, lr1 = lr0 + 8;  // this lane's rows of a tile

    float* sCB = smem;                         // n_lt tiles of kT x kLdCB
    float* region = sCB + n_lt * kT * kLdCB;  // C/B slices, then x tiles

    const int lts[2] = {static_cast<int>(blockIdx.x), n_lt - 1 - static_cast<int>(blockIdx.x)};
    const int n_mine = lts[0] == lts[1] ? 1 : 2;
    for (int which = 0; which < n_mine; ++which) {
        const int lt = lts[which];
        const int l0 = lt * kT;
        const int nl = min(kT, cs - l0);

        // 1. This block's share of the CB tiles of the l-tile (mt % K == rank).
        const int n_slices = (N + kNS - 1) / kNS;
        const int my_tiles = (lt + 1 - rank + K - 1) / K;
        const int iters = my_tiles * n_slices;
        auto stage_cb = [&](int it) {
            if (it < iters) {
                const int mt = rank + K * (it / n_slices);
                const int n0 = (it % n_slices) * kNS;
                float* buf = region + (it & 1) * kSlice;
                const int cols_ok = min(kNS, N - n0);
                load_tile(buf, kLdS, cm + (row0 + l0) * N + n0, N, nl, kNS, cols_ok, vec_n);
                load_tile(buf + kT * kLdS, kLdS, bm + (row0 + mt * kT) * N + n0, N,
                          min(kT, cs - mt * kT), kNS, cols_ok, vec_n);
            }
            repro::cp_async_commit();
        };
        if (n_slices == 0) {  // N = 0: CB is all zeros
            for (int mt = rank; mt <= lt; mt += K)
                for (int i = threadIdx.x; i < kT * kLdCB; i += kThreads)
                    sCB[mt * kT * kLdCB + i] = 0.0f;
        }
        float acc[4][4] = {};
        stage_cb(0);
        for (int it = 0; it < iters; ++it) {
            stage_cb(it + 1);
            repro::cp_async_wait<1>();
            __syncthreads();
            const int mt = rank + K * (it / n_slices);
            const float* sC = region + (it & 1) * kSlice;
            const float* sB = sC + kT * kLdS;
            // n-tiles wholly above the diagonal are skipped (they stay 0)
            const int n_on = mt == lt ? min(4, max(0, (16 * rw + 16 - 32 * cw + 7) / 8)) : 4;
#pragma unroll
            for (int k0 = 0; k0 < kNS; k0 += 8) {
                const float a[4] = {sC[lr0 * kLdS + k0 + tig], sC[lr1 * kLdS + k0 + tig],
                                    sC[lr0 * kLdS + k0 + tig + 4], sC[lr1 * kLdS + k0 + tig + 4]};
                float bv[4][2];
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const float* brow = sB + (32 * cw + 8 * nt + g) * kLdS + k0 + tig;
                    bv[nt][0] = brow[0];
                    bv[nt][1] = brow[4];
                }
                mma3(acc, a, bv, n_on);
            }
            if (it % n_slices == n_slices - 1) {  // the tile is complete
                float* tile = sCB + mt * kT * kLdCB;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    const int c = 32 * cw + 8 * nt + 2 * tig;
                    tile[lr0 * kLdCB + c] = acc[nt][0];
                    tile[lr0 * kLdCB + c + 1] = acc[nt][1];
                    tile[lr1 * kLdCB + c] = acc[nt][2];
                    tile[lr1 * kLdCB + c + 1] = acc[nt][3];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
                }
            }
            __syncthreads();  // the buffer is free for the slice after next
        }
        // 2. The partner's CB tiles, through distributed shared memory.
        if (K > 1) {
            cluster.sync();
            for (int mt = 0; mt <= lt; ++mt) {
                const int owner = mt % K;
                if (owner == rank) continue;
                const float4* src = reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(sCB + mt * kT * kLdCB, owner));
                float4* dst = reinterpret_cast<float4*>(sCB + mt * kT * kLdCB);
                constexpr int kVec = kT * kLdCB / 4, kBatch = (kVec + kThreads - 1) / kThreads;
                float4 v[kBatch];  // every remote load in flight before the first store
#pragma unroll
                for (int j = 0; j < kBatch; ++j) {
                    const int i = threadIdx.x + j * kThreads;
                    if (i < kVec) v[j] = src[i];
                }
#pragma unroll
                for (int j = 0; j < kBatch; ++j) {
                    const int i = threadIdx.x + j * kThreads;
                    if (i < kVec) dst[i] = v[j];
                }
            }
            cluster.sync();  // copies done before any block overwrites its tiles
        }

        // 3. Two heads at a time, one per half of the block: Y = M (x) over
        // the m-tiles at or below the diagonal.  Warp (rw, hw) owns rows
        // 16 rw .. +15 and every column of head 2 j + hw, so each decay entry
        // is formed once.
        const int n_pairs = (max(0, h_end - h_begin) + 1) / 2;
        const int n_iters = n_pairs * (lt + 1);
        auto stage_x = [&](int it) {
            if (it < n_iters) {
                const int h0 = h_begin + 2 * (it / (lt + 1));
                const int m0 = (it % (lt + 1)) * kT;
                const int nm = min(kT, cs - m0);
                float* buf = region + (it & 1) * kXStage;
                const int pc = (P + 7) / 8 * 8;
                for (int hs = 0; hs < 2 && h0 + hs < h_end; ++hs)
                    load_tile(buf + hs * kXBuf, kLdX, x + ((row0 + m0) * H + h0 + hs) * P,
                              static_cast<long long>(H) * P, nm, pc, P, vec_p);
                const int hs = threadIdx.x / (2 * kT), t = threadIdx.x % (2 * kT);
                if (h0 + hs < h_end) {
                    float* sdt = buf + hs * kXBuf + kT * kLdX;
                    const int r = t % kT;
                    const float* src = (t < kT ? dt : da) + (row0 + m0 + r) * H + h0 + hs;
                    if (r < nm)
                        repro::cp_async<4>(sdt + t, src);
                    else
                        sdt[t] = 0.0f;
                }
            }
            repro::cp_async_commit();
        };
        __syncthreads();  // the slices are consumed: the region takes x tiles
        stage_x(0);
        float y[8][4] = {};
        float dl0 = 0.0f, dl1 = 0.0f;
        const int n_on = (P + 7) / 8;  // n-tiles inside P
        for (int it = 0; it < n_iters; ++it) {
            const int h = h_begin + 2 * (it / (lt + 1)) + hw;
            const int mt = it % (lt + 1);
            const int m0 = mt * kT;
            const int nm = min(kT, cs - m0);
            const bool active = h < h_end;
            if (mt == 0 && active) {
                dl0 = lr0 < nl ? da[(row0 + l0 + lr0) * H + h] : 0.0f;
                dl1 = lr1 < nl ? da[(row0 + l0 + lr1) * H + h] : 0.0f;
            }
            stage_x(it + 1);
            repro::cp_async_wait<1>();
            __syncthreads();
            const float* sX = region + (it & 1) * kXStage + hw * kXBuf;
            const float* sdt = sX + kT * kLdX;
            const float* sda = sdt + kT;
            const float* tile = sCB + mt * kT * kLdCB;
            // past k_end every M entry of this warp's rows is 0
            const int k_end = !active ? 0 : mt == lt ? min(nm, 16 * rw + 16) : nm;
#pragma unroll
            for (int k0 = 0; k0 < kT; k0 += 8) {
                if (k0 >= k_end) break;
                float a[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = (i & 1) ? lr1 : lr0;
                    const int m = k0 + tig + ((i & 2) ? 4 : 0);
                    // mask BEFORE exp: only m <= l inside the chunk takes one
                    float v = 0.0f;
                    if (r < nl && m < nm && m0 + m <= l0 + r)
                        v = tile[r * kLdCB + m] * expf(((i & 1) ? dl1 : dl0) - sda[m]) * sdt[m];
                    a[i] = v;
                }
                float bv[8][2];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const float* xcol = sX + (k0 + tig) * kLdX + 8 * nt + g;
                    bv[nt][0] = xcol[0];
                    bv[nt][1] = xcol[4 * kLdX];
                }
                mma3(y, a, bv, n_on);
            }
            if (mt == lt && active) {  // the head's rows are complete
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const int c = 8 * nt + 2 * tig;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int r = (i & 2) ? lr1 : lr0;
                        const int cc = c + (i & 1);
                        if (r < nl && cc < P) out[((row0 + l0 + r) * H + h) * P + cc] = y[nt][i];
                        y[nt][i] = 0.0f;
                    }
                }
            }
            __syncthreads();  // the buffer is free for the tile after next
        }
    }
    repro::cp_async_wait<0>();
    if (K > 1) cluster.sync();  // no block leaves while a partner may read it
}

}  // namespace

// x (B, S, H, P), dt and da_cum (B, S, H), bmat and cmat (B, S, N), out
// (B, S, H, P); float32, contiguous.  S % cs == 0, 1 <= P <= 64, 1 <= cs <=
// 512, block_h >= 1 heads per block.  Returns the cudaError_t of the launch
// (0 = success).
REPRO_EXPORT int ssd_intra_launch(const void* x, const void* dt, const void* da_cum,
                                  const void* bmat, const void* cmat, void* out, int B,
                                  int S, int H, int P, int N, int cs, int block_h,
                                  void* stream) {
    if (P < 1 || P > kMaxP || cs < 1 || cs > 512 || S % cs != 0 || block_h < 1 || N < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || S == 0 || H == 0) return 0;
    const int n_lt = (cs + kT - 1) / kT;
    const int groups = (H + block_h - 1) / block_h;
    const int cluster = groups > 1 ? 2 : 1;
    const long long bz = static_cast<long long>(B) * (S / cs);
    if (bz > 65535 || groups + 1 > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = (static_cast<size_t>(n_lt) * kT * kLdCB + kRegion) * sizeof(float);
    cudaError_t err = repro::allow_smem(ssd_intra_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const int vec_n = N % 4 == 0 && aligned(bmat) && aligned(cmat);
    const int vec_p = P % 4 == 0 && aligned(x);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((n_lt + 1) / 2),
                       static_cast<unsigned>((groups + cluster - 1) / cluster * cluster),
                       static_cast<unsigned>(bz));
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_intra_kernel, static_cast<const float*>(x),
                             static_cast<const float*>(dt), static_cast<const float*>(da_cum),
                             static_cast<const float*>(bmat), static_cast<const float*>(cmat),
                             static_cast<float*>(out), S, H, P, N, cs, block_h, vec_n, vec_p);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* ssd_intra_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
