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
// among equals) over a unique 64-bit key; a pick counts when its value is
// finite and its slot is within n_select; cur += the counted picks'
// matrices (added left to right, then to cur), and `selected` / `order`
// written. Only sampled candidates are factored: the plain version factors
// every slot and masks the unsampled ones away, so the results are the same.
//
// What bounds it on this card: latency. The bytes are small (obs_mats 0.8 MB
// at D = 7 and 2.8 MB at D = 13 for P = 4096, in the 50 MB L2 between
// rounds) and so are the operations (a D = 13 logdet is ~1,100 flops), but
// the rounds are a dependent chain: a round's scores need the last round's
// picks. A round's time is its chain: the compaction, a logdet's serial
// Cholesky, the top-B, and the barriers between them.
//
// The design (it replaces the first version's one-block design, whose
// every round re-read the diagonals of all P slots from L2 for the fallback
// tier, ran the ~1 in 10 sampled logdets on whichever lane owned the slot
// -- up to 16 one after another in a warp at D = 13 -- and took its top-B
// as B block-wide arg-maxima, two barriers each): the same arithmetic,
// scheduled so that
//  1. the fallback tier is computed once, at entry, as the high half of its
//     sort key, kept in shared memory per slot (0: not a candidate);
//  2. a warp scan compacts the round's sampled candidates into a list in
//     shared memory (one atomic a warp) and prefetches their matrices;
//  3. a short list (<= 64 candidates at D = 7, <= 96 at D = 13; the main
//     path's ~50) is scored by groups of 8 or 16 lanes a candidate, lane r
//     owning row r of the Cholesky factor, each column's entries updated as
//     the column completes -- every entry by the serial loop's operations in
//     its order --, so a round waits for one logdet's column chain; a long
//     one by one lane a candidate;
//  4. a list of <= 128 ranks its keys at once, one a thread; the keys above
//     every unsampled candidate's fallback key are settled, and only places
//     left over (fewer sampled candidates than picks), or every place of a
//     longer list, take warp arg-maxima over the list and the fallback tier;
//  5. cur takes the round's picks at the start of the next round, beside the
//     compaction: three barriers a round instead of 2B + 4.
// The key, the order and every value are the first version's, so the picks
// and `order` are its own, bit for bit, but for one repair: a NaN score at
// slot 0 had the key ~0ull, which the first arg-maximum's open bound ~0ull
// left out, so that slot was never ranked; NaN keys now sit one below
// (key_hi), and the slot takes its place first, as the plain version's sort
// puts it. Shared memory: 13 bytes a slot (the list's key, the fallback
// key, the sampled flag): 53 KB at P = 4096, 208 KB at the cap of 16,384,
// four times the largest pool any path passes.
// What it still gives up: one SM of 132 does the whole selection, and a
// round is still a chain of latencies (~5.8 us at D = 7: the compaction and
// the update of cur, one logdet's serial chain, the ranks and three
// barriers). A thread-block cluster would split the scoring, the only part
// that more SMs could shorten, and only when the list needs more than one
// pass of the block (D = 13: 32 candidates a pass, ~50 sampled a round on
// the main path), at the price of cluster barriers and a DSMEM exchange of
// keys and cur every round; it is not built (PERF.md). Measured times on an
// H100 and the -Xptxas -v registers and spills are kept in PERF.md.
// D = 7 or 13; B <= 64; P <= MAX_SLOTS.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_BATCH = 64;
constexpr int MAX_SLOTS = 16384;  // dynamic shared memory: 13 bytes a slot, 208 KB
constexpr int SMEM_PER_SLOT = 8 + 4 + 1;
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

// The high half of a key whose order is torch.sort(descending=True,
// stable=True)'s: NaN first, then by value (-0 == +0). Never 0, and never
// all ones, so that every key, slot 0's NaN too, lies below the open bound
// ~0ull of the first arg-maximum.
__device__ __forceinline__ unsigned key_hi(float v) {
    if (v != v) return 0xfffffffeu;
    const unsigned bits = __float_as_uint(v == 0.0f ? 0.0f : v);
    return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// The slot's key: the value's high half, then the lower slot first. Unique
// per slot and never 0, so 0 stands for "no key".
__device__ __forceinline__ unsigned long long slot_key(unsigned hi, int p) {
    return ((unsigned long long)hi << 32) | (unsigned long long)(0xffffffffu - (unsigned)p);
}

__device__ __forceinline__ int key_slot(unsigned long long k) {
    return (int)(0xffffffffu - (unsigned)(k & 0xffffffffu));
}

// isfinite of the value a key was made from (false for "no key")
__device__ __forceinline__ bool key_finite(unsigned long long k) {
    const unsigned hi = (unsigned)(k >> 32);
    const unsigned bits = (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
    return k != 0ull && isfinite(__uint_as_float(bits));
}

// The warp's largest key: the largest high half, then the largest low half
// among the lanes that hold it (two redux.sync).
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
    const unsigned hi = __reduce_max_sync(FULL, (unsigned)(k >> 32));
    const unsigned lo = __reduce_max_sync(FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
    return ((unsigned long long)hi << 32) | lo;
}

// logdet_trial<D> of one candidate by a group of G lanes (G >= D): lane r
// of the group owns row r (lanes from D on repeat row D-1): its scale, its
// normalized entries and their Cholesky updates, taken column by column as
// each column completes (right-looking), so every entry subtracts the
// products of the earlier columns in the serial loop's order; the logs come
// after the factor, and every lane adds them in the serial loop's order.
// Every value is logdet_trial's, operation for operation. The whole warp
// calls it.
template <int D, int G>
__device__ __forceinline__ float logdet_group(const float* __restrict__ m, const float* cur,
                                              float eps) {
    const int r = (threadIdx.x & (G - 1)) < D ? (threadIdx.x & (G - 1)) : D - 1;
    float a[D];  // row r: cur + obs, then the normalized entries and their running sums
#pragma unroll
    for (int j = 0; j < D; ++j) a[j] = j <= r ? cur[r * D + j] + __ldg(m + r * D + j) : 0.0f;
    float trr = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) trr = j == r ? a[j] + eps : trr;
    const float sr = sqrtf(trr < eps ? eps : trr);
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const float sj = __shfl_sync(FULL, sr, j, G);
        if (j <= r) {
            float t = a[j];
            if (j == r) t = t + eps;
            t = t / (sr * sj);
            if (j == r) t = t + 1e-5f;
            a[j] = t;
        }
    }
    float drr = 0.0f;  // the factor's diagonal entry of row r
#pragma unroll
    for (int j = 0; j < D; ++j) {
        float inv = 0.0f;
        if (r == j) {
            drr = sqrtf(a[j] < 1e-6f ? 1e-6f : a[j]);
            inv = 1.0f / drr;
        }
        inv = __shfl_sync(FULL, inv, j, G);
        const float Lrj = r > j ? a[j] * inv : 0.0f;
#pragma unroll
        for (int c = j + 1; c < D; ++c) {
            const float Lcj = __shfl_sync(FULL, Lrj, c, G);
            if (c <= r) a[c] = a[c] - Lrj * Lcj;
        }
    }
    const float lg = 2.0f * logf(drr), lsr = logf(sr);
    float ld = 0.0f, ls = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        ld = ld + __shfl_sync(FULL, lg, j, G);
        ls = ls + __shfl_sync(FULL, lsr, j, G);
    }
    return ld + 2.0f * ls;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.L1 [%0];" ::"l"(p));
}

// Lists this round's sampled candidates: sampled[p] for each of this
// thread's slots (p = tid + THREADS*r, the slots it owns from start to end),
// then their slots appended to idx at this thread's place in its warp's
// share of the list lk (a warp scan, one atomic a warp; the list's order is
// irrelevant, every later choice is by unique key) and their matrices
// prefetched to L1 for the scoring. This thread's largest key of an
// unsampled candidate (its fallback tier; 0 if none) goes to tfb[tid], the
// warp's to wfb[warp]. Returns whether this thread listed any.
template <int D, int THREADS>
__device__ __forceinline__ bool compact(const float* __restrict__ obs, const unsigned* fbk,
                                        const float* __restrict__ u, float inv_l, int P,
                                        unsigned char* sampled, unsigned long long* lk,
                                        int* n_list, unsigned long long* tfb,
                                        unsigned long long* wfb) {
    constexpr int BYTES = D * D * 4;
    const int lane = threadIdx.x & 31;
    int cnt = 0;
    unsigned long long fmax = 0ull;
#pragma unroll 4
    for (int p = threadIdx.x; p < P; p += THREADS) {
        const float up = u ? __ldg(u + p) : 0.0f;
        const unsigned f = fbk[p];
        const bool s = f != 0u && (!u || up < inv_l);
        sampled[p] = s ? 1 : 0;
        cnt += s ? 1 : 0;
        const unsigned long long key = f != 0u && !s ? slot_key(f, p) : 0ull;
        fmax = key > fmax ? key : fmax;
    }
    tfb[threadIdx.x] = fmax;
    fmax = warp_max(fmax);
    if (lane == 0) wfb[threadIdx.x >> 5] = fmax;
    int incl = cnt;  // the warp's inclusive scan of the counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
    }
    int pos = 0;
    if (lane == 31 && incl) pos = atomicAdd(n_list, incl);
    pos = __shfl_sync(FULL, pos, 31) + incl - cnt;
    if (cnt) {
        for (int p = threadIdx.x; p < P; p += THREADS) {
            if (sampled[p]) {
                lk[pos++] = slot_key(0u, p);  // the slot, until its score comes
                const char* m = (const char*)(obs + (size_t)p * D * D);
#pragma unroll
                for (int o = 0; o < BYTES; o += 128) prefetch_l1(m + o);
                prefetch_l1(m + BYTES - 1);
            }
        }
    }
    return cnt != 0;
}

// The largest key below `bound` (0 if none) of this lane's listed
// candidates (entries j = lane + 32*r).
__device__ __forceinline__ unsigned long long best_listed(unsigned long long bound, int nl,
                                                          const unsigned long long* lk) {
    unsigned long long best = 0ull;
    for (int j = threadIdx.x & 31; j < nl; j += 32) {
        const unsigned long long key = lk[j];
        if (key < bound && key > best) best = key;
    }
    return best;
}

// The largest fallback key below `bound` (0 if none) among thread t's
// unsampled candidates.
template <int THREADS>
__device__ __forceinline__ unsigned long long thread_fallback(int t, unsigned long long bound,
                                                              const unsigned* fbk,
                                                              const unsigned char* sampled,
                                                              int P) {
    unsigned long long best = 0ull;
    for (int p = t; p < P; p += THREADS) {
        if (fbk[p] != 0u && !sampled[p]) {
            const unsigned long long key = slot_key(fbk[p], p);
            if (key < bound && key > best) best = key;
        }
    }
    return best;
}

template <int D, int THREADS>
__global__ void __launch_bounds__(THREADS)
greedy_select_kernel(const float* __restrict__ obs, const unsigned char* __restrict__ valid,
                     const float* __restrict__ base, const float* __restrict__ uniforms,
                     int P, int n_select, int B, int rounds, float inv_l, float eps,
                     unsigned char* __restrict__ selected, long long* __restrict__ order) {
    constexpr int DD = D * D;
    constexpr int WARPS = THREADS / 32;
    constexpr int G = D <= 8 ? 8 : 16;           // lanes a candidate's logdet, split
    constexpr int CPW = 32 / G;                  // candidates a warp, split
    // longer lists: one lane a candidate (a lane's logdet takes ~1.7x a
    // group's at D = 7 and ~3x at D = 13, so groups win up to one or three
    // passes of the block)
    constexpr int SPLIT_MAX = (D <= 8 ? 1 : 3) * WARPS * CPW;
    constexpr int RANK_MAX = 128;  // longer lists: B warp arg-maxima (ranks cost O(list) a thread)
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long* lk = (unsigned long long*)smem;  // [P] the round's list: its keys
    unsigned* fbk = (unsigned*)(lk + P);                 // [P] fallback key high half; 0: no candidate
    unsigned char* sampled = (unsigned char*)(fbk + P);  // [P] sampled this round
    __shared__ float cur[DD];
    __shared__ unsigned long long tfb[THREADS];     // each thread's largest unsampled fallback key
    __shared__ unsigned long long wfb[WARPS];       // each warp's
    __shared__ unsigned long long ranked[MAX_BATCH];  // the round's top-B keys
    __shared__ unsigned long long top[MAX_BATCH];     // the round's counted picks (0: none)
    __shared__ int n_list;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int p = tid; p < P; p += THREADS) {
        selected[p] = 0;
        fbk[p] = valid[p] ? key_hi(trace<D>(obs + (size_t)p * DD) - 1e12f) : 0u;
    }
    for (int i = tid; i < DD; i += THREADS) cur[i] = base ? base[i] : 0.0f;
    if (tid == 0) n_list = 0;
    __syncthreads();
    for (int k = 0; k < rounds; ++k) {
        const float* u = uniforms ? uniforms + (size_t)k * P : nullptr;
        if (k > 0 && tid < DD) {
            // cur += the last round's counted picks, left to right (before
            // this round's scoring, beside the other threads' compaction)
            float add = 0.0f;
#pragma unroll 8
            for (int b = 0; b < B; ++b) {
                // every load issued, the uncounted ones (slot 0) not added
                const unsigned long long kb = top[b];
                const float v = __ldg(obs + (size_t)(kb ? key_slot(kb) : 0) * DD + tid);
                if (kb) add = add + v;
            }
            cur[tid] = cur[tid] + add;
        }
        const bool any = compact<D, THREADS>(obs, fbk, u, inv_l, P, sampled, lk, &n_list, tfb, wfb);
        if (!__syncthreads_or(any) && u) {
            // a round whose sample misses every remaining candidate scores them all
            compact<D, THREADS>(obs, fbk, nullptr, inv_l, P, sampled, lk, &n_list, tfb, wfb);
            __syncthreads();
        }
        if (u && k + 1 < rounds && lane == 0) {
            // the next round's uniforms of this warp's slots, on their way to L1
            for (int p = warp * 32; p < P; p += THREADS) prefetch_l1(u + P + p);
        }
        const int nl = n_list;  // read by every thread before warp 0 resets it
        if (nl <= SPLIT_MAX) {
            // a group of G lanes a listed candidate, CPW candidates a warp
            for (int j0 = warp * CPW; j0 < nl; j0 += WARPS * CPW) {
                const int j = j0 + lane / G;
                const int p = j < nl ? key_slot(lk[j]) : 0;
                const float* m = obs + (size_t)p * DD;
                const float ld = logdet_group<D, G>(m, cur, eps);
                if (j < nl && (lane & (G - 1)) == 0)
                    lk[j] = slot_key(key_hi(nan_max(ld, trace<D>(m) - 1e12f)), p);
            }
        } else {
            // one lane a listed candidate
            for (int j = tid; j < nl; j += THREADS) {
                const int p = key_slot(lk[j]);
                const float* m = obs + (size_t)p * DD;
                const float fb = trace<D>(m) - 1e12f;
                lk[j] = slot_key(key_hi(nan_max(logdet_trial<D>(m, cur, eps), fb)), p);
            }
        }
        __syncthreads();
        // a short list ranks its keys at once, one a thread; those above
        // every unsampled candidate's fallback key (F) are settled
        bool above = false;
        if (nl <= RANK_MAX && tid < nl) {
            unsigned long long F = 0ull;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) F = wfb[w] > F ? wfb[w] : F;
            const unsigned long long key = lk[tid];
            int rank = 0;
#pragma unroll 4
            for (int j = 0; j < nl; ++j) rank += lk[j] > key ? 1 : 0;
            if (rank < B) ranked[rank] = key;
            above = key > F;
        }
        const int n_above = __syncthreads_count(above);
        if (warp == 0) {
            // the places the ranks did not settle: B warp arg-maxima over the
            // listed keys below them and the fallback tier, each below the
            // last; only the lane whose key was taken looks again (lane l
            // follows the fallback tier of threads l + 32*i, i < WARPS, from tfb)
            const int c = nl <= RANK_MAX ? min(n_above, B) : 0;
            if (c < B) {
                unsigned long long lm = best_listed(c ? ranked[c - 1] : ~0ull, nl, lk);
                unsigned long long fh[WARPS], fm = 0ull;
#pragma unroll
                for (int i = 0; i < WARPS; ++i) {
                    fh[i] = tfb[lane + 32 * i];
                    fm = fh[i] > fm ? fh[i] : fm;
                }
                for (int b = c; b < B; ++b) {
                    const unsigned long long w = warp_max(lm > fm ? lm : fm);
                    if (lane == 0) ranked[b] = w;
                    if (w != 0ull && lm == w) {
                        lm = best_listed(w, nl, lk);
                    } else if (w != 0ull && fm == w) {
                        fm = 0ull;
#pragma unroll
                        for (int i = 0; i < WARPS; ++i) {
                            if (fh[i] == w)
                                fh[i] = thread_fallback<THREADS>(lane + 32 * i, w, fbk, sampled, P);
                            fm = fh[i] > fm ? fh[i] : fm;
                        }
                    }
                }
                __syncwarp();
            }
            // a pick counts when its value is finite and its slot within n_select
            for (int b = lane; b < B; b += 32) {
                const unsigned long long w = ranked[b];
                const bool ok = key_finite(w) && k * B + b < n_select;
                top[b] = ok ? w : 0ull;
                order[(size_t)k * B + b] = ok ? key_slot(w) : -1;
                if (ok) {
                    selected[key_slot(w)] = 1;  // the picks are distinct
                    fbk[key_slot(w)] = 0u;
                }
            }
            if (lane == 0) n_list = 0;
        }
        __syncthreads();
    }
}

template <int D, int THREADS>
int launch(const void* obs, const void* valid, const void* base, const void* uniforms, int P,
           int n_select, int B, int rounds, float inv_l, float eps, void* selected, void* order,
           cudaStream_t stream) {
    const size_t smem = (size_t)P * SMEM_PER_SLOT;
    static bool raised = false;  // the opt-in above 48 KB, once per process
    if (!raised) {
        const cudaError_t e = cudaFuncSetAttribute(
            greedy_select_kernel<D, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MAX_SLOTS * SMEM_PER_SLOT);
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
// 1 <= B <= 64, B <= P <= 16384, rounds * B >= n_select.
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
        return launch<13, 512>(obs, valid, base, uniforms, P, n_select, B, rounds, inv_l, eps,
                               selected, order, s);
    return (int)cudaErrorInvalidValue;
}
