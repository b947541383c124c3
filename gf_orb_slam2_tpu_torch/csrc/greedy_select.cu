// Lazier-greedy Max-logDet good-feature selection for Hopper (sm_90a): all
// rounds of one frame's selection in ONE launch.
//
// Replaces the JAX package's device program
// gf_orb_slam2_tpu/selection/good_feature.py:32 `lazier_greedy_select`: one
// XLA program, a `jax.lax.scan` of rounds = ceil(n_select / B) (:84), each a
// batched unrolled-Cholesky logdet over the candidate pool and a `top_k` of
// B = 8. No Pallas kernel existed for it (XLA compiled the scan body itself).
// The port's plain PyTorch version, selection/good_feature.py
// `lazier_greedy_select_ref`, runs each round as a few hundred elementwise
// launches.
//
//   obs [P,D,D] float32, valid [P] bytes, base [D,D] (or null),
//   uniforms [rounds,P] (or null: exact greedy, every candidate scored)
//   -> selected [P] bytes, order [rounds*B] int64 (-1 where no pick)
//
// Each round, in the plain version's order (selection/observability.py
// `logdet_psd` for the score): the candidates (valid, not yet selected); the
// lazier sample (uniform < 1/lazier_factor), all candidates if it is empty;
// per sampled candidate the logdet of cur + obs_p + eps*I -- diagonal scaling
// with s = sqrt(max(diag, eps)), + 1e-5*I, the unrolled Cholesky with pivots
// clamped at 1e-6, + 2*sum(log s) --, every product and sum rounded on its
// own (the build's -fmad=false) and every sum left to right, as the plain
// version writes them out, so the scores equal its scores on the card bit
// for bit; the fallback tier trace - 1e12 in float32 for every candidate
// (max with the logdet, NaN propagating, as torch.maximum); a stable top-B
// (value descending, NaN first as torch.sort puts it, lowest index first
// among equals) made of B block-wide arg-maxima over a unique 64-bit key;
// a pick counts when its value is finite and its slot is within n_select;
// cur += the counted picks' matrices (added left to right, then to cur),
// and `selected` / `order` written.
// Only sampled candidates are factored: the plain version factors every
// slot and masks the unsampled ones away, so the results are the same.
//
// What bounds it on this card: latency. The bytes are small (obs_mats 0.8 MB
// at D = 7 and 2.8 MB at D = 13 for P = 4096: 0.2 / 0.8 us of HBM, and they
// stay in the 50 MB L2 between rounds) and so are the operations (a D = 13
// logdet is ~1,100 flops), but the rounds are a dependent chain: a round's
// scores need the last round's picks, and each round ends in B block-wide
// arg-maxima (two barriers each). `cur` lives in shared memory, the scores
// of the round in dynamic shared memory (4 bytes a slot), the factor of one
// candidate in registers (28 floats at D = 7, 91 at D = 13: 512 and 256
// threads a block keep it out of local memory).
//
// What the one-block design gives up: one SM of 132 reads obs_mats from L2
// every round at that one SM's share of the L2 bandwidth; a multi-block
// score pass with a second top-B pass would spread it. Measured times on an
// H100 and the -Xptxas -v registers and spills are kept in PERF.md.
// D = 7 or 13; B <= 64; P <= MAX_SLOTS.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_BATCH = 64;
constexpr int MAX_SLOTS = 50000;  // dynamic shared memory of the scores: 200 KB
constexpr unsigned FULL = 0xffffffffu;

// logdet(cur + obs + eps*I) as selection/observability.py `logdet_psd`
// computes it, operation for operation (the build's -fmad=false keeps every
// product and sum rounded on its own).
template <int D>
__device__ __forceinline__ float logdet_trial(const float* __restrict__ m, const float* cur,
                                              float eps) {
    float s[D];
    float L[D * (D + 1) / 2];  // packed lower triangle, row i at i*(i+1)/2
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const float tii = cur[i * D + i] + __ldg(m + i * D + i) + eps;
        s[i] = sqrtf(tii < eps ? eps : tii);  // torch.clamp: NaN passes
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float t = cur[i * D + j] + __ldg(m + i * D + j);
            if (i == j) t = t + eps;
            t = t / (s[i] * s[j]);
            if (i == j) t = t + 1e-5f;
            L[i * (i + 1) / 2 + j] = t;
        }
    }
    float ld = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        float acc = L[j * (j + 1) / 2 + j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc = acc - L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
        const float djj = sqrtf(acc < 1e-6f ? 1e-6f : acc);
        ld = ld + 2.0f * logf(djj);
        const float inv = 1.0f / djj;
#pragma unroll
        for (int i = j + 1; i < D; ++i) {
            float a = L[i * (i + 1) / 2 + j];
#pragma unroll
            for (int k = 0; k < j; ++k) a = a - L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
            L[i * (i + 1) / 2 + j] = a * inv;
        }
    }
    float ls = 0.0f;  // the log-scales left to right, as the plain version adds them
#pragma unroll
    for (int i = 0; i < D; ++i) ls = ls + logf(s[i]);
    return ld + 2.0f * ls;
}

template <int D>
__device__ __forceinline__ float trace(const float* __restrict__ m) {
    float tr = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) tr = tr + __ldg(m + i * D + i);
    return tr;
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// A key whose order is torch.sort(descending=True, stable=True)'s: NaN
// first, then by value (-0 == +0), then the lower slot first. Unique per
// slot and never 0.
__device__ __forceinline__ unsigned long long sort_key(float v, int p) {
    unsigned u;
    if (v != v) {
        u = 0xffffffffu;
    } else {
        const unsigned bits = __float_as_uint(v == 0.0f ? 0.0f : v);
        u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
    }
    return ((unsigned long long)u << 32) | (unsigned long long)(0xffffffffu - (unsigned)p);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(FULL, k, off);
        k = o > k ? o : k;
    }
    return k;
}

template <int D, int THREADS>
__global__ void __launch_bounds__(THREADS)
greedy_select_kernel(const float* __restrict__ obs, const unsigned char* __restrict__ valid,
                     const float* __restrict__ base, const float* __restrict__ uniforms,
                     int P, int n_select, int B, int rounds, float inv_l, float eps,
                     unsigned char* __restrict__ selected, long long* __restrict__ order) {
    constexpr int DD = D * D;
    constexpr int WARPS = THREADS / 32;
    extern __shared__ float score[];  // [P]: this round's scores
    __shared__ float cur[DD];
    __shared__ unsigned long long wbest[WARPS];
    __shared__ unsigned long long top[MAX_BATCH];
    __shared__ bool counted[MAX_BATCH];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int p = tid; p < P; p += THREADS) selected[p] = 0;
    for (int i = tid; i < DD; i += THREADS) cur[i] = base ? base[i] : 0.0f;
    __syncthreads();
    for (int k = 0; k < rounds; ++k) {
        const float* u = uniforms ? uniforms + (size_t)k * P : nullptr;
        int any = 0;
        if (u) {
            for (int p = tid; p < P; p += THREADS)
                any |= (valid[p] && !selected[p] && u[p] < inv_l) ? 1 : 0;
        }
        // a round whose sample misses every remaining candidate scores them all
        any = __syncthreads_or(any);
        for (int p = tid; p < P; p += THREADS) {
            float v = -INFINITY;
            if (valid[p] && !selected[p]) {
                const float* m = obs + (size_t)p * DD;
                const float fb = trace<D>(m) - 1e12f;
                const bool sampled = !u || !any || u[p] < inv_l;
                v = sampled ? nan_max(logdet_trial<D>(m, cur, eps), fb) : fb;
            }
            score[p] = v;
        }
        __syncthreads();
        unsigned long long prev = ~0ull;  // the next pick's key is below the last one's
        for (int b = 0; b < B; ++b) {
            unsigned long long best = 0;
            for (int p = tid; p < P; p += THREADS) {
                const unsigned long long key = sort_key(score[p], p);
                if (key < prev && key > best) best = key;
            }
            best = warp_max(best);
            if (lane == 0) wbest[warp] = best;
            __syncthreads();
            if (warp == 0) {
                best = warp_max(lane < WARPS ? wbest[lane] : 0ull);
                if (lane == 0) top[b] = best;
            }
            __syncthreads();
            prev = top[b];
        }
        if (tid < B) {
            const int p = (int)(0xffffffffu - (unsigned)(top[tid] & 0xffffffffu));
            const bool ok = isfinite(score[p]) && k * B + tid < n_select;
            counted[tid] = ok;
            order[(size_t)k * B + tid] = ok ? p : -1;
            if (ok) selected[p] = 1;  // the picks are distinct
        }
        __syncthreads();
        for (int i = tid; i < DD; i += THREADS) {
            float add = 0.0f;
            for (int b = 0; b < B; ++b) {
                if (counted[b]) {
                    const int p = (int)(0xffffffffu - (unsigned)(top[b] & 0xffffffffu));
                    add = add + __ldg(obs + (size_t)p * DD + i);
                }
            }
            cur[i] = cur[i] + add;
        }
        __syncthreads();
    }
}

template <int D, int THREADS>
int launch(const void* obs, const void* valid, const void* base, const void* uniforms, int P,
           int n_select, int B, int rounds, float inv_l, float eps, void* selected, void* order,
           cudaStream_t stream) {
    const size_t smem = (size_t)P * sizeof(float);
    static bool raised = false;  // the opt-in above 48 KB, once per process
    if (smem > 48 * 1024 && !raised) {
        const cudaError_t e = cudaFuncSetAttribute(
            greedy_select_kernel<D, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(MAX_SLOTS * sizeof(float)));
        if (e != cudaSuccess) return (int)e;
        raised = true;
    }
    greedy_select_kernel<D, THREADS><<<1, THREADS, smem, stream>>>(
        (const float*)obs, (const unsigned char*)valid, (const float*)base,
        (const float*)uniforms, P, n_select, B, rounds, inv_l, eps,
        (unsigned char*)selected, (long long*)order);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry: enqueues the selection on `stream` and returns the launch
// status (cudaGetLastError) without synchronizing. Device pointers to
// contiguous data; `base` and `uniforms` may be null; D = 7 or 13,
// 1 <= B <= 64, B <= P <= 50000, rounds * B >= n_select.
extern "C" int greedy_select_launch(const void* obs, const void* valid, const void* base,
                                    const void* uniforms, int P, int D, int n_select, int B,
                                    int rounds, float inv_l, float eps, void* selected,
                                    void* order, void* stream) {
    if (B < 1 || B > MAX_BATCH || P < B || P > MAX_SLOTS) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (D == 7)
        return launch<7, 512>(obs, valid, base, uniforms, P, n_select, B, rounds, inv_l, eps,
                              selected, order, s);
    if (D == 13)
        return launch<13, 256>(obs, valid, base, uniforms, P, n_select, B, rounds, inv_l, eps,
                               selected, order, s);
    return (int)cudaErrorInvalidValue;
}
