// One color step of the colored SN-Train sweep, for all B fields at once.
//
// Replaces the TPU kernel src/repro/kernels/color_step.py:_color_step_kernel
// (launched by color_step_pallas).  For each (field b, member m) of one
// distance-2 color class:
//   rhs_k  = mask_k ? z[b, idx_k] + lambda_s * coef[b, s, k] : 0
//            mask_k = nbr_mask[b, s, k] & live_m & alive_z[idx_k]
//            live_m = member_mask[m] & alive_row[s]
//   coef'  = (L L^T)^{-1} rhs          (forward + back substitution)
//   z'_k   = sum_j gram[b, s, k, j] coef'_j
//   coef[b, s, :] <- coef'             if live_m
//   z[b, idx_k]   <- z'_k              if live_m & alive_z[idx_k] & deliv[s, k]
//
// Design.  One warp per (b, m); the warp's lanes stride over the D lanes of
// the neighborhood (any D), and the two triangular solves run row by row
// with a warp reduction per row, keeping rhs, y and x in shared memory.
// The distance-2 coloring makes the slots and rows of different members of
// one color disjoint, so every warp reads and then writes z and coef IN
// PLACE with no synchronisation (the reference returns new buffers).
// Gated lanes do not store at all: the Pallas kernel redirected them to the
// sentinel slot, where several lanes of a GPU launch would race; here the
// sentinel is never written and stays 0, as in the plan engine.
//
// Bound.  Each (b, m) reads two D x D factors and does ~4 D^2 flops, so a
// launch is bound by bytes (gram + chol dominate); at the benched geometry
// (B = 16, M ~ 50, D ~ 18) that is a few MB per launch, and launch latency
// (one launch per color, ~tens per sweep) dominates its time.  A CUDA graph
// over a whole sweep is the next step.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) color_step_kernel(
    T* __restrict__ z, T* __restrict__ coef,
    const int32_t* __restrict__ nbr_idx, const uint8_t* __restrict__ nbr_mask,
    const T* __restrict__ gram, const T* __restrict__ chol,
    const T* __restrict__ lam, const uint8_t* __restrict__ alive_row,
    const uint8_t* __restrict__ alive_z, const int32_t* __restrict__ members,
    const uint8_t* __restrict__ member_mask, const uint8_t* __restrict__ deliv,
    int B, int NZ, int R, int D, int M) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long pair = static_cast<long long>(blockIdx.x) * kWarps + warp;
    if (pair >= static_cast<long long>(B) * M) return;  // whole warp leaves
    const int b = static_cast<int>(pair / M), m = static_cast<int>(pair % M);

    T* rhs = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 2 * D;
    T* y = rhs + D;
    T* x = rhs;  // the back substitution overwrites rhs, no longer needed

    const int s = members[m];
    if (s < 0 || s >= R) return;  // out-of-range ids are inert, never read
    const bool live = member_mask[m] != 0 && alive_row[s] != 0;
    const size_t row = static_cast<size_t>(b) * R + s;
    const int32_t* idx = nbr_idx + static_cast<size_t>(s) * D;
    const uint8_t* msk = nbr_mask + row * D;
    const T* L = chol + row * D * D;
    const T* G = gram + row * D * D;
    T* zb = z + static_cast<size_t>(b) * NZ;
    T* cb = coef + row * D;
    const T lam_s = lam[s];

    for (int k = lane; k < D; k += 32) {
        const int j = idx[k];
        const bool on = live && j >= 0 && j < NZ && msk[k] != 0 && alive_z[j] != 0;
        rhs[k] = on ? zb[j] + lam_s * cb[k] : T(0);
    }
    __syncwarp();
    for (int i = 0; i < D; ++i) {  // L y = rhs
        T part = T(0);
        for (int j = lane; j < i; j += 32) part += L[static_cast<size_t>(i) * D + j] * y[j];
        part = repro::warp_sum(part);
        if (lane == 0) y[i] = (rhs[i] - part) / L[static_cast<size_t>(i) * D + i];
        __syncwarp();
    }
    for (int i = D - 1; i >= 0; --i) {  // L^T x = y
        T part = T(0);
        for (int j = i + 1 + lane; j < D; j += 32) part += L[static_cast<size_t>(j) * D + i] * x[j];
        part = repro::warp_sum(part);
        if (lane == 0) x[i] = (y[i] - part) / L[static_cast<size_t>(i) * D + i];
        __syncwarp();
    }
    if (!live) return;
    for (int k = lane; k < D; k += 32) {
        T acc = T(0);
        for (int j = 0; j < D; ++j) acc += G[static_cast<size_t>(k) * D + j] * x[j];
        cb[k] = x[k];
        const int j = idx[k];
        const bool send = j >= 0 && j < NZ && alive_z[j] != 0 &&
                          (deliv == nullptr || deliv[static_cast<size_t>(s) * D + k] != 0);
        if (send) zb[j] = acc;
    }
}

template <typename T>
int launch(void* z, void* coef, const void* nbr_idx, const void* nbr_mask,
           const void* gram, const void* chol, const void* lam, const void* alive_row,
           const void* alive_z, const void* members, const void* member_mask,
           const void* deliv, int B, int NZ, int R, int D, int M, cudaStream_t stream) {
    const long long pairs = static_cast<long long>(B) * M;
    if (pairs == 0) return 0;
    const size_t smem = static_cast<size_t>(kWarps) * 2 * D * sizeof(T);
    cudaError_t err = repro::allow_smem(color_step_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
    color_step_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
        static_cast<T*>(z), static_cast<T*>(coef),
        static_cast<const int32_t*>(nbr_idx), static_cast<const uint8_t*>(nbr_mask),
        static_cast<const T*>(gram), static_cast<const T*>(chol),
        static_cast<const T*>(lam), static_cast<const uint8_t*>(alive_row),
        static_cast<const uint8_t*>(alive_z), static_cast<const int32_t*>(members),
        static_cast<const uint8_t*>(member_mask), static_cast<const uint8_t*>(deliv),
        B, NZ, R, D, M);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  deliv may be null (all delivered).
// Returns the cudaError_t of the launch (0 = success).
REPRO_EXPORT int color_step_launch(
    int dtype, void* z, void* coef, const void* nbr_idx, const void* nbr_mask,
    const void* gram, const void* chol, const void* lam, const void* alive_row,
    const void* alive_z, const void* members, const void* member_mask,
    const void* deliv, int B, int NZ, int R, int D, int M, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(z, coef, nbr_idx, nbr_mask, gram, chol, lam, alive_row,
                             alive_z, members, member_mask, deliv, B, NZ, R, D, M, st);
    if (dtype == 1)
        return launch<double>(z, coef, nbr_idx, nbr_mask, gram, chol, lam, alive_row,
                              alive_z, members, member_mask, deliv, B, NZ, R, D, M, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT const char* color_step_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
