// Mamba2 SSD intra-chunk term, float32:
//   Y[b, z*cs + l, h, :] = sum_{m <= l} CB[l, m] exp(da[l, h] - da[m, h]) dt[m, h] x[m, h, :]
// with CB = C_chunk B_chunk^T shared by all heads (n_groups = 1).
//
// Replaces the TPU kernel src/repro/kernels/ssd_intra.py:_kernel (launched by
// ssd_intra_pallas).  IEEE float32 FMAs throughout: no TF32, no tensor cores.
//
// Design.  One block of 256 threads per (l-tile of 64 rows, head group, batch
// x chunk).  The block first forms the CB tiles of its l-tile against every
// m-tile at or below the diagonal, staging C and B rows through shared
// memory in slices of 32 state columns, and keeps those tiles in shared
// memory for all the heads of its group.  Then, per head and per m-tile, it
// writes M = CB * exp(da[l] - da[m]) into shared memory, with the upper
// triangle set to 0 before any exp is taken (its differences are positive
// and would overflow), stages V = dt * x, and accumulates M V into a 64 x 64
// register tile: each thread owns rows ty + 16 i and columns tx + 16 j, i, j
// < 4.  m-tiles above the diagonal are skipped.  Rows past the chunk and
// columns past P are padded with zeros in shared memory.
//
// Bound.  Operations: cs^2 / 2 * P FMAs per (batch, chunk, head) for M V and
// cs^2 / 2 * N per (batch, chunk) for CB, against O(S (H P + N)) bytes; the
// float32 FMA rate is the limit.  This version is shared-memory bound: each
// FMA of the inner loop reads half a float from shared memory.
#include "common.cuh"

namespace {

constexpr int kT = 64;           // rows of an l-tile and of an m-tile
constexpr int kLd = kT + 1;      // padded row stride of the CB and M tiles
constexpr int kNS = 32;          // state columns staged per step
constexpr int kLdS = kNS + 1;    // padded row stride of the staged C and B rows
constexpr int kMaxP = 64;        // columns of the register tile
constexpr int kThreads = 256;    // 16 x 16

__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ da, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ out, int S, int H, int P,
    int N, int cs, int block_h) {
    extern __shared__ __align__(16) float smem[];
    const int lt = static_cast<int>(blockIdx.x);
    const int g = static_cast<int>(blockIdx.y);
    const int nc = S / cs;
    const int b = static_cast<int>(blockIdx.z) / nc;
    const int z = static_cast<int>(blockIdx.z) % nc;
    const int l0 = lt * kT;
    const int nl = min(kT, cs - l0);  // rows of this l-tile inside the chunk
    const int n_mt = lt + 1;          // m-tiles at or below the diagonal
    const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(z) * cs;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float* sCB = smem;                  // n_mt x (kT x kLd)
    float* sM = sCB + n_mt * kT * kLd;  // kT x kLd
    float* sV = sM + kT * kLd;          // kT x kMaxP
    float* sDl = sV + kT * kMaxP;       // da of the l rows (kT)
    float* sDm = sDl + kT;              // da of the m rows (kT)
    float* sC = sM;                     // staging, aliases sM / sV: kT x kLdS
    float* sB = sM + kT * kLdS;         // kT x kLdS

    // 1. CB tiles of this l-tile, once for the whole head group.
    for (int mt = 0; mt < n_mt; ++mt) {
        const int m0 = mt * kT;
        const int nm = min(kT, cs - m0);
        float acc[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += kNS) {
            __syncthreads();  // the previous slice is consumed
            for (int i = tid; i < kT * kNS; i += kThreads) {
                const int r = i / kNS, c = i % kNS, n = n0 + c;
                sC[r * kLdS + c] = (r < nl && n < N) ? cm[(row0 + l0 + r) * N + n] : 0.0f;
                sB[r * kLdS + c] = (r < nm && n < N) ? bm[(row0 + m0 + r) * N + n] : 0.0f;
            }
            __syncthreads();
#pragma unroll 4
            for (int c = 0; c < kNS; ++c) {
                float cv[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * kLdS + c];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * kLdS + c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
            }
        }
        float* tile = sCB + mt * kT * kLd;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) tile[(ty + 16 * i) * kLd + tx + 16 * j] = acc[i][j];
    }

    // 2. Per head of the group: M = masked decay * CB, then M (dt x).
    const int h_end = min(H, (g + 1) * block_h);
    for (int h = g * block_h; h < h_end; ++h) {
        float acc[4][4] = {};
        for (int mt = 0; mt < n_mt; ++mt) {
            const int m0 = mt * kT;
            const int nm = min(kT, cs - m0);
            __syncthreads();  // the CB tiles are written, the previous M / V consumed
            if (tid < kT) {
                sDl[tid] = tid < nl ? da[(row0 + l0 + tid) * H + h] : 0.0f;
            } else if (tid < 2 * kT) {
                const int r = tid - kT;
                sDm[r] = r < nm ? da[(row0 + m0 + r) * H + h] : 0.0f;
            }
            for (int i = tid; i < kT * kMaxP; i += kThreads) {
                const int r = i / kMaxP, c = i % kMaxP;
                float v = 0.0f;
                if (r < nm && c < P) {
                    const long long row = row0 + m0 + r;
                    v = dt[row * H + h] * x[(row * H + h) * P + c];
                }
                sV[i] = v;
            }
            __syncthreads();
            const float* tile = sCB + mt * kT * kLd;
            for (int i = tid; i < kT * kT; i += kThreads) {
                const int r = i / kT, c = i % kT;
                // mask BEFORE exp: only m <= l (inside the chunk) takes one
                float v = 0.0f;
                if (r < nl && m0 + c <= l0 + r) v = tile[r * kLd + c] * expf(sDl[r] - sDm[c]);
                sM[r * kLd + c] = v;
            }
            __syncthreads();
            const int m_stop = mt == lt ? nl : nm;  // past it M is 0
            for (int c = 0; c < m_stop; ++c) {
                float mv[4], vv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) mv[i] = sM[(ty + 16 * i) * kLd + c];
#pragma unroll
                for (int j = 0; j < 4; ++j) vv[j] = sV[c * kMaxP + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], vv[j], acc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            if (r >= nl) continue;
            float* o = out + ((row0 + l0 + r) * H + h) * P;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                if (c < P) o[c] = acc[i][j];
            }
        }
    }
}

}  // namespace

// x (B, S, H, P), dt and da_cum (B, S, H), bmat and cmat (B, S, N), out
// (B, S, H, P); float32, contiguous.  S % cs == 0, 1 <= P <= 64, 1 <= cs <=
// 512.  Returns the cudaError_t of the launch (0 = success).
REPRO_EXPORT int ssd_intra_launch(const void* x, const void* dt, const void* da_cum,
                                  const void* bmat, const void* cmat, void* out, int B,
                                  int S, int H, int P, int N, int cs, int block_h,
                                  void* stream) {
    if (P < 1 || P > kMaxP || cs < 1 || cs > 512 || S % cs != 0 || block_h < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || S == 0 || H == 0) return 0;
    const int n_lt = (cs + kT - 1) / kT;
    // the most CB tiles a block keeps: the last l-tile's n_lt
    const size_t smem =
        (static_cast<size_t>(n_lt + 1) * kT * kLd + kT * kMaxP + 2 * kT) * sizeof(float);
    cudaError_t err = repro::allow_smem(ssd_intra_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(n_lt, (H + block_h - 1) / block_h, B * (S / cs));
    ssd_intra_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(da_cum), static_cast<const float*>(bmat),
        static_cast<const float*>(cmat), static_cast<float*>(out), S, H, P, N, cs,
        block_h);
    return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT const char* ssd_intra_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
