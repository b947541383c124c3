// Masked best-2 Hamming search for Hopper (sm_90a): the form of the Hamming
// kernel that the matching calls use, so the [N,M] matrix is never written.
//
// Replaces, fused into one kernel, the JAX package's TPU kernel
// gf_orb_slam2_tpu/ops/pallas_hamming.py (`_kernel`) and the reduction every
// caller applies to its result (gf_orb_slam2_tpu/matching/hamming.py
// `masked_best2`):
//   a [N,8], b [M,8] 32-bit words, mask [N,M] bytes (non-zero = candidate)
//   -> best_idx [N] int64, best [N] int32, second [N] int32
// with d[i][j] = mask ? popcount(a_i ^ b_j) : 256; best/best_idx the row
// minimum and its lowest column; second the row minimum with that one entry
// taken out. Both are the two smallest values of the key d*M + column.
//
// What bounds it on this card: bytes, and they are the mask's -- N*M bytes
// read against 16 bytes of results per row. In practice, at the shapes of the
// tracking path, it is the launch and two dependent trips to memory (the
// mask, then the descriptors it points at). The search masks of that path are
// very sparse (a window of a few pixels around a projection, a two-pixel row
// band for stereo: 0.002-0.25 % of the entries), so the work is made
// proportional to the candidates:
//   - one warp owns one row and all its columns, so no reduction crosses
//     warps or blocks (no shared memory, no atomics, no second pass, the same
//     result on every run); 4 rows a block keep 1024 rows at 256 blocks;
//   - the row's descriptor is loaded first and is on its way while the warp
//     walks the row's mask with 16-byte loads (16 columns a lane, two loads in
//     flight); a group of 16 that is all zero costs nothing more;
//   - each set byte is visited on its own: two 16-byte loads of b_j and
//     8 XOR+POPC against the row's descriptor in registers; lanes keep their
//     two smallest keys and five shuffle steps merge them.
// A dense mask therefore runs on the POPC pipe (16 results per clock per SM)
// and re-reads b_j per candidate: an all-true mask is this kernel's worst
// case, several times the matrix kernel's time (hamming.cu). A caller with
// dense masks would want the tensor-core tiles of that kernel here; the
// tracking path has none.
// Measured times on an H100 are kept in PERF.md.
// Any N, M >= 1 with M < 2^22; when M is not a multiple of 16 (or the mask is
// not 16-byte aligned) the mask is read bytewise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;           // rows per block, one warp each
constexpr int LOADS = 2;          // 16-byte mask loads in flight per lane
constexpr unsigned NO_KEY = 0xffffffffu;
constexpr int MAX_DIST = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Row {
    uint4 lo, hi;     // the row's descriptor
    const uint4* b;
    unsigned m;
    unsigned k1, k2;  // smallest and second smallest key seen

    __device__ __forceinline__ void visit(unsigned col) {
        const uint4 p = __ldg(b + 2 * (size_t)col), q = __ldg(b + 2 * (size_t)col + 1);
        const unsigned d =
            __popc(lo.x ^ p.x) + __popc(lo.y ^ p.y) + __popc(lo.z ^ p.z) + __popc(lo.w ^ p.w) +
            __popc(hi.x ^ q.x) + __popc(hi.y ^ q.y) + __popc(hi.z ^ q.z) + __popc(hi.w ^ q.w);
        const unsigned key = d * m + col;
        k2 = min(k2, max(k1, key));
        k1 = min(k1, key);
    }
    // four mask bytes in one word, first column `base`
    __device__ __forceinline__ void scan(unsigned w, unsigned base) {
        while (w) {
            const unsigned byte = (__ffs(w) - 1) >> 3;
            w &= ~(0xffu << (8 * byte));
            visit(base + byte);
        }
    }
    // the two smallest of this lane's pair and another lane's (keys are
    // distinct or NO_KEY)
    __device__ __forceinline__ void shfl_merge(int off) {
        const unsigned o1 = __shfl_xor_sync(FULL, k1, off);
        const unsigned o2 = __shfl_xor_sync(FULL, k2, off);
        k2 = min(min(k2, o2), max(k1, o1));
        k1 = min(k1, o1);
    }
};

// One warp walks one row's mask and visits every candidate; true if this
// lane saw one.
template <bool VEC>
__device__ __forceinline__ bool walk_row(const unsigned char* mrow, int m, int lane, Row& row) {
    bool seen = false;
    if (VEC) {
        const uint4* mv = reinterpret_cast<const uint4*>(mrow);
        const int groups = m >> 4;
        for (int g0 = 0; g0 < groups; g0 += 32 * LOADS) {
            uint4 v[LOADS];
#pragma unroll
            for (int k = 0; k < LOADS; ++k) {
                const int gi = g0 + 32 * k + lane;
                v[k] = gi < groups ? __ldg(mv + gi) : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int k = 0; k < LOADS; ++k) {
                if (!(v[k].x | v[k].y | v[k].z | v[k].w)) continue;
                seen = true;
                const unsigned c = 16u * (unsigned)(g0 + 32 * k + lane);
                row.scan(v[k].x, c);
                row.scan(v[k].y, c + 4);
                row.scan(v[k].z, c + 8);
                row.scan(v[k].w, c + 12);
            }
        }
    } else {
        for (int c = lane; c < m; c += 32)
            if (mrow[c]) {
                seen = true;
                row.visit((unsigned)c);
            }
    }
    return seen;
}

template <bool VEC>
__global__ void __launch_bounds__(ROWS * 32)
hamming_best2_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                     const unsigned char* __restrict__ mask,
                     long long* __restrict__ best_idx, int* __restrict__ best,
                     int* __restrict__ second, int n, int m) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = blockIdx.x * ROWS + warp;
    if (r >= n) return;
    Row row;
    row.lo = __ldg(a + 2 * (size_t)r);
    row.hi = __ldg(a + 2 * (size_t)r + 1);
    row.b = b;
    row.m = (unsigned)m;
    row.k1 = row.k2 = NO_KEY;
    const bool seen = walk_row<VEC>(mask + (size_t)r * m, m, lane, row);
    if (__any_sync(FULL, seen)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) row.shfl_merge(off);
    }
    if (lane == 0) {
        // masked-out entries count as MAX_DIST: they win ties from column 0 on
        const unsigned um = (unsigned)m;
        const bool found = row.k1 < (unsigned)MAX_DIST * um;
        best_idx[r] = found ? (long long)(row.k1 % um) : 0ll;
        best[r] = found ? (int)(row.k1 / um) : MAX_DIST;
        second[r] = row.k2 == NO_KEY ? MAX_DIST : min((int)(row.k2 / um), MAX_DIST);
    }
}

}  // namespace

// Plain C entry: enqueues the kernel on `stream` and returns the launch
// status (cudaGetLastError) without synchronizing. `a` and `b` must be
// 16-byte aligned device pointers; 1 <= n, 1 <= m < 2^22.
extern "C" int hamming_masked_best2_launch(const void* a, const void* b, const void* mask,
                                           void* best_idx, void* best, void* second,
                                           int n, int m, void* stream) {
    const unsigned blocks = (unsigned)((n + ROWS - 1) / ROWS);
    const bool vec = (m % 16 == 0) && ((uintptr_t)mask % 16 == 0);
    auto kernel = vec ? hamming_best2_kernel<true> : hamming_best2_kernel<false>;
    kernel<<<blocks, ROWS * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (const unsigned char*)mask,
        (long long*)best_idx, (int*)best, (int*)second, n, m);
    return (int)cudaGetLastError();
}
