// 256-bit Hamming distance matrix for Hopper (sm_90a), on the tensor cores.
//
// Replaces the JAX package's TPU kernel gf_orb_slam2_tpu/ops/pallas_hamming.py
// (`_kernel`, built by `_build`, entered through `distance_matrix_pallas`):
//   a [N,8] x b [M,8] 32-bit words  ->  out [N,M] int32,
//   out[i][j] = popcount(a_i ^ b_j) over the 256 bits.
//
// What bounds it on this card: bytes -- N*M*4 written against (N+M)*32 read,
// 5.06 us at 4096x1024 and 1.27 us at 1024x1024 over 3.35 TB/s. A SIMT kernel
// cannot reach that: 8 POPC per output run on a pipe that retires 16 results
// per clock per SM, about 8 us at 4096x1024 (the first version of this kernel
// measured 11 us). So the bit counting is taken off that pipe: a 256-bit
// descriptor is exactly one k=256 step of the binary matrix instruction
// `mma.sync.m16n8k256 ... b1.b1 .and.popc`, a 16x8 tile of popcount(a & b).
// With the complements,
//   popcount(a ^ b) = popcount(a & ~b) + popcount(~a & b),
// two such instructions chained through the accumulator give the distances
// themselves: no POPC, no row weights and no integer work in the epilogue.
// (nvcc 12.8 also takes the `.xor.popc` form for sm_90a, but the machine code
// it makes of it holds only AND.POPC instructions, and it is no faster.)
// Measured on an H100 (700 W): 6.2 us at 4096x1024, the stores at 2.7 TB/s;
// 3.0 us at 1024x1024, where an empty kernel already takes 1.2 us. Tile
// sizes from 32 to 128 rows and columns all measure the same within 0.2 us:
// what is left is the store stream and the launch.
//
// Design:
//   - a warp owns 16 rows x (16*NGROUPS) columns and reads its fragments
//     straight from global memory as 8-byte loads (lane (g,t) takes words
//     2t,2t+1 of row g / column g: any pairing of words works as long as `a`
//     and `b` use the same one, so nothing is staged or transposed);
//   - columns are dealt to the instruction's B slots so that a thread ends up
//     with 4 consecutive outputs of a row: one 16-byte store, a quad of lanes
//     writes 64 contiguous bytes, every 32-byte sector is written whole;
//   - tiles are small (64x32 outputs per block of 4 warps), so 1024x1024 is
//     512 blocks -- about 4 per SM -- and 4096x1024 still fits in one wave.
// Any N, M >= 1 is handled: rows/columns past the edge are read as zero and
// not stored; when M is not a multiple of 4 the stores are scalar.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;    // warps per block, stacked along the rows
constexpr int NGROUPS = 2;  // 16-column groups per warp
constexpr int TILE_N = 16 * WARPS;
constexpr int TILE_M = 16 * NGROUPS;

// d[16x8] += popcount(a[16x256] & b[256x8]) on one warp.
__device__ __forceinline__ void bmma_and_popc(int (&d)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(WARPS * 32)
hamming_matrix_kernel(const uint2* __restrict__ a, const uint2* __restrict__ b,
                      int* __restrict__ out, int n, int m, int col_blocks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = (blockIdx.x / col_blocks) * TILE_N + warp * 16;
    const int col0 = (blockIdx.x % col_blocks) * TILE_M;
    if (row0 >= n) return;

    // A fragment: rows row0+g and row0+g+8, words 2t and 2t+1 of each
    const int r_lo = row0 + g, r_hi = row0 + g + 8;
    const uint2 zero = make_uint2(0u, 0u);
    const uint2 a_lo = r_lo < n ? a[(size_t)r_lo * 4 + t] : zero;
    const uint2 a_hi = r_hi < n ? a[(size_t)r_hi * 4 + t] : zero;
    const unsigned fa[4] = {a_lo.x, a_hi.x, a_lo.y, a_hi.y};
    const unsigned na[4] = {~a_lo.x, ~a_hi.x, ~a_lo.y, ~a_hi.y};

    // B slot g of the first instruction of a group holds column 4*(g/2)+(g%2),
    // of the second that column + 2: thread t then owns columns 4t..4t+3.
    const int slot_col = 4 * (g >> 1) + (g & 1);
    uint2 fb[NGROUPS][2];
#pragma unroll
    for (int p = 0; p < NGROUPS; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = col0 + 16 * p + slot_col + 2 * h;
            fb[p][h] = c < m ? b[(size_t)c * 4 + t] : zero;
        }

    const bool vec = (m & 3) == 0;
    int* out_lo = out + (size_t)r_lo * m;
    int* out_hi = out + (size_t)r_hi * m;
#pragma unroll
    for (int p = 0; p < NGROUPS; ++p) {
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            bmma_and_popc(acc[h], fa, ~fb[p][h].x, ~fb[p][h].y);
            bmma_and_popc(acc[h], na, fb[p][h].x, fb[p][h].y);
        }
        // acc[h][0..1]: row g, columns c..c+1 (+2h); acc[h][2..3]: row g+8
        const int c = col0 + 16 * p + 4 * t;
        if (vec) {
            if (c < m) {
                if (r_lo < n)
                    *reinterpret_cast<int4*>(out_lo + c) =
                        make_int4(acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
                if (r_hi < n)
                    *reinterpret_cast<int4*>(out_hi + c) =
                        make_int4(acc[0][2], acc[0][3], acc[1][2], acc[1][3]);
            }
        } else {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int cc = c + 2 * h + e;
                    if (cc < m) {
                        if (r_lo < n) out_lo[cc] = acc[h][e];
                        if (r_hi < n) out_hi[cc] = acc[h][2 + e];
                    }
                }
        }
    }
}

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry: enqueues the kernel on `stream` and returns the launch
// status (cudaGetLastError) without synchronizing. Pointers must be 16-byte
// aligned device pointers; n, m >= 1.
extern "C" int hamming_distance_matrix_launch(const void* a, const void* b,
                                              void* out, int n, int m,
                                              void* stream) {
    const long long col_blocks = (m + TILE_M - 1) / TILE_M;
    const long long row_blocks = (n + TILE_N - 1) / TILE_N;
    if (col_blocks * row_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    hamming_matrix_kernel<<<(unsigned)(col_blocks * row_blocks), WARPS * 32, 0,
                            (cudaStream_t)stream>>>(
        (const uint2*)a, (const uint2*)b, (int*)out, n, m, (int)col_blocks);
    return (int)cudaGetLastError();
}

// A kernel that does nothing: its time in a graph replay is the floor under
// every kernel time measured the same way.
extern "C" int empty_kernel_launch(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
