// 256-bit Hamming distance matrix for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel gf_orb_slam2_tpu/ops/pallas_hamming.py
// (`_kernel`, built by `_build`, entered through `distance_matrix_pallas`):
//   a [N,8] x b [M,8] 32-bit words  ->  out [N,M] int32,
//   out[i][j] = sum_w popcount(a[i][w] ^ b[j][w]).
//
// What bounds it on this card: bytes. The output is N*M*4 bytes against
// (N+M)*32 bytes of input and 8 XOR+POPC per output, so the kernel is bound
// by the store stream to device memory. The design therefore
//   - stages a 64-row tile of `a` and a 128-row tile of `b` in shared memory
//     once per block (16-byte loads), so every descriptor is read from device
//     memory once per tile row/column and never per output;
//   - keeps `b` transposed in shared memory ([word][column]) so a warp's 32
//     lanes read 32 consecutive banks, while the `a` row is a broadcast;
//   - lets each warp write 32 consecutive int32 (one 128-byte line) per
//     store, each thread producing an 8x4 patch of outputs from registers.
// Any N, M >= 1 is handled by bounds checks at the ragged edge; the wrapper
// never launches for an empty output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_N = 64;    // rows of `a` per block
constexpr int TILE_M = 128;   // rows of `b` (output columns) per block
constexpr int BLOCK_X = 32;   // lanes along output columns
constexpr int BLOCK_Y = 8;    // warps along output rows
constexpr int ROWS_PER_THREAD = TILE_N / BLOCK_Y;  // 8
constexpr int COLS_PER_THREAD = TILE_M / BLOCK_X;  // 4
constexpr int WORDS = 8;

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
hamming_matrix_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      int* __restrict__ out, int n, int m) {
    __shared__ unsigned sa[TILE_N][WORDS];
    __shared__ unsigned sb[WORDS][TILE_M + 1];

    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    const int row0 = blockIdx.y * TILE_N;
    const int col0 = blockIdx.x * TILE_M;

    // stage `a`: 64 descriptors = 128 uint4; rows past N read as zero
    if (tid < TILE_N * 2) {
        const int r = tid >> 1, h = tid & 1;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n) v = a[(size_t)(row0 + r) * 2 + h];
        sa[r][4 * h + 0] = v.x;
        sa[r][4 * h + 1] = v.y;
        sa[r][4 * h + 2] = v.z;
        sa[r][4 * h + 3] = v.w;
    }
    // stage `b` transposed: 128 descriptors = 256 uint4, one per thread
    {
        const int c = tid >> 1, h = tid & 1;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col0 + c < m) v = b[(size_t)(col0 + c) * 2 + h];
        sb[4 * h + 0][c] = v.x;
        sb[4 * h + 1][c] = v.y;
        sb[4 * h + 2][c] = v.z;
        sb[4 * h + 3][c] = v.w;
    }
    __syncthreads();

    unsigned bw[COLS_PER_THREAD][WORDS];
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j)
#pragma unroll
        for (int w = 0; w < WORDS; ++w)
            bw[j][w] = sb[w][threadIdx.x + BLOCK_X * j];

#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int r = threadIdx.y + BLOCK_Y * i;
        const int row = row0 + r;
        if (row >= n) continue;
        unsigned aw[WORDS];
#pragma unroll
        for (int w = 0; w < WORDS; ++w) aw[w] = sa[r][w];
        int* out_row = out + (size_t)row * m;
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) {
            const int col = col0 + threadIdx.x + BLOCK_X * j;
            int d = 0;
#pragma unroll
            for (int w = 0; w < WORDS; ++w) d += __popc(aw[w] ^ bw[j][w]);
            if (col < m) out_row[col] = d;
        }
    }
}

}  // namespace

// Plain C entry: enqueues the kernel on `stream` and returns the launch
// status (cudaGetLastError) without synchronizing. Pointers must be 16-byte
// aligned device pointers; n, m >= 1.
extern "C" int hamming_distance_matrix_launch(const void* a, const void* b,
                                              void* out, int n, int m,
                                              void* stream) {
    dim3 block(BLOCK_X, BLOCK_Y);
    dim3 grid((m + TILE_M - 1) / TILE_M, (n + TILE_N - 1) / TILE_N);
    hamming_matrix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (int*)out, n, m);
    return (int)cudaGetLastError();
}
