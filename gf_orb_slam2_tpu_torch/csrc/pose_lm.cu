// Motion-only pose optimization for Hopper (sm_90a): one frame's whole
// rounds x iters Levenberg-Marquardt solve in ONE launch.
//
// Replaces the JAX package's device program
// gf_orb_slam2_tpu/optim/pose_opt.py:81 `pose_optimization`: one XLA
// program, a `jax.lax.scan` over rounds*iters LM steps (:152-155). No Pallas
// kernel existed for it (XLA compiled the scan body itself). The port's plain
// PyTorch version, optim/pose_opt.py `pose_optimization_ref`, runs the scan as
// a Python loop of ~250 eager launches a step.
//
//   R0 [3,3], t0 [3], Xw [N,3], uv [N,2], u_right [N] (< 0: monocular),
//   inv_sigma2 [N], valid [N] bytes
//   -> R [3,3], t [3], inliers [N] bytes, n_inliers int64, chi2 [N]
//
// Each step, in the plain version's order: residuals and the 3x6 Jacobian of
// every observation at the current pose; chi2 and the Huber weight; at a
// round boundary the chi2 re-gate, the cost reset and lambda <- 1e-3; the
// normal equations (21 upper entries of H, 6 of b) summed over the block;
// (H + lambda*diag(damping + diag H)) xi = -b by Cholesky on one thread (SPD
// for lambda >= 1e-6; a pivot that is not positive makes the step NaN, which
// the finite guard rejects, as the plain version's solve on a singular
// system); se3_exp and the left compose; the candidate's robust cost summed
// over the block; the accept test with the finite guard; lambda halved or
// quadrupled within [1e-6, 1e6]. The last pass writes the final chi2 gate,
// chi2 and the pose; n_inliers is summed on the device. Built without FMA
// contraction (cuda_lib's -fmad=false): every product and sum is rounded
// on its own, as the plain version's elementwise launches round them; its
// matrix products and sums over the points (cuBLAS, torch's reductions) and
// its LU solve keep orders of their own, so the two agree to float32
// rounding, not bit for bit.
//
// What bounds it on this card: latency, not bytes or operations. The inputs
// are ~37 KB at N = 1024 (0.011 us of HBM) and a 24-step solve does ~7 MFLOP
// (0.1 us of the fp32 peak), but every step is a chain of dependent phases:
// two passes over the points, two block-wide sums, a serial 6x6 solve and
// exponential on one thread, and five barriers. The design keeps everything
// of that chain on chip: R, t, lambda and the cost in shared memory, the
// inputs re-read from L1 (they fit), the running inlier mask kept in the
// `inliers` output itself (each point is owned by one thread from start to
// end), nothing read back to the host and nothing allocated.
//
// What the one-block design gives up: a solve uses one SM of 132, so the
// card is idle beside it unless other streams fill it; several solves (the
// relocalization's candidates) would want one block each in one launch, and
// a longer N would want the points split over several blocks with a second
// pass for the sums. Measured times on an H100 are kept in PERF.md.
// Any N >= 0; float32 only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NH = 21;            // upper triangle of the 6x6 H
constexpr int NACC = NH + 6 + 1;  // H, b, the re-gated cost
constexpr unsigned FULL = 0xffffffffu;
constexpr float CHI2_MONO = 5.991f, CHI2_STEREO = 7.815f;
constexpr float HUBER_MONO = 2.4477f, HUBER_STEREO = 2.7955f;  // sqrt of the above

struct Args {
    const float* R0;
    const float* t0;
    const float* X;     // [N,3]
    const float* uv;    // [N,2]
    const float* ur;    // [N]
    const float* inv2;  // [N]
    const unsigned char* valid;
    int n;
    float fx, fy, cx, cy, bf;
    int rounds, iters;
    float damping;
    float* R;
    float* t;
    unsigned char* inliers;
    long long* n_inliers;
    float* chi2;
};

// One observation projected at a pose: the camera point (z not clamped),
// the clamped inverse depth, the residuals (third = stereo, 0 for mono) and
// chi2.
struct Proj {
    float x, y, z, iz, r0, r1, r2, c2;
    bool stereo;
};

__device__ __forceinline__ Proj project(const float* R, const float* t, const Args& a, int i) {
    Proj p;
    const float X0 = a.X[3 * i], X1 = a.X[3 * i + 1], X2 = a.X[3 * i + 2];
    p.x = X0 * R[0] + X1 * R[1] + X2 * R[2] + t[0];
    p.y = X0 * R[3] + X1 * R[4] + X2 * R[5] + t[1];
    p.z = X0 * R[6] + X1 * R[7] + X2 * R[8] + t[2];
    const float zc = p.z < 1e-6f ? 1e-6f : p.z;
    p.iz = 1.0f / zc;
    const float u = a.fx * p.x * p.iz + a.cx;
    const float v = a.fy * p.y * p.iz + a.cy;
    const float ur = a.ur[i];
    p.stereo = ur >= 0.0f;
    p.r0 = u - a.uv[2 * i];
    p.r1 = v - a.uv[2 * i + 1];
    p.r2 = p.stereo ? (u - a.bf * p.iz) - ur : 0.0f;
    const float e2 = p.r0 * p.r0 + p.r1 * p.r1 + (p.stereo ? p.r2 * p.r2 : 0.0f);
    p.c2 = e2 * a.inv2[i];
    return p;
}

// sqrt(max(c2, 1e-12)) with torch.clamp's NaN propagation
__device__ __forceinline__ float huber_e(float c2) { return sqrtf(c2 < 1e-12f ? 1e-12f : c2); }

__device__ __forceinline__ float huber_rho(float c2, float e, float delta) {
    return e <= delta ? c2 : 2.0f * delta * e - delta * delta;
}

// The block's sums of v[0..K) into out[0..K) (shared), visible to every
// thread on return.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[NACC], float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(FULL, v[k], off);
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) red[warp][k] = v[k];
    }
    __syncthreads();
    if (threadIdx.x < K) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
        out[threadIdx.x] = s;
    }
    __syncthreads();
}

// Σ huber_rho over the observations the mask lets through at pose (R, t).
__device__ __forceinline__ float robust_cost_part(const float* R, const float* t, const Args& a) {
    float c = 0.0f;
    for (int i = threadIdx.x; i < a.n; i += THREADS) {
        const Proj p = project(R, t, a, i);
        const float delta = p.stereo ? HUBER_STEREO : HUBER_MONO;
        const float rho = huber_rho(p.c2, huber_e(p.c2), delta);
        c += (a.inliers[i] && p.z > 1e-4f) ? rho : 0.0f;
    }
    return c;
}

// index of H[i][j], i <= j, in the packed upper triangle
__host__ __device__ constexpr int hidx(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

// (H + lam * diag(damping + diag H)) xi = -b by Cholesky; false (and xi
// NaN) if a pivot is not positive.
__device__ bool solve6(const float* H, const float* b, float lam, float damping, float* xi) {
    float L[6][6];
    for (int i = 0; i < 6; ++i)
        for (int j = 0; j <= i; ++j) {
            float s = H[hidx(j, i)];
            if (i == j) s = s + lam * (damping + s);
            for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
            if (i == j) {
                if (!(s > 0.0f)) {
                    for (int r = 0; r < 6; ++r) xi[r] = __int_as_float(0x7fc00000);
                    return false;
                }
                L[i][i] = sqrtf(s);
            } else {
                L[i][j] = s / L[j][j];
            }
        }
    float y[6];
    for (int i = 0; i < 6; ++i) {
        float s = b[i];
        for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
        y[i] = s / L[i][i];
    }
    for (int i = 5; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < 6; ++k) s -= L[k][i] * xi[k];
        xi[i] = s / L[i][i];
    }
    for (int i = 0; i < 6; ++i) xi[i] = -xi[i];
    return true;
}

// se3_exp(xi) composed on the left of (R, t): geometry/lie.py `se3_exp`,
// `so3_exp` and `se3_compose`, small-angle branch (theta2 < 1e-3) included.
__device__ void exp_compose(const float* xi, const float* R, const float* t, float* Rn, float* tn) {
    const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
    const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
    const float theta = sqrtf(theta2 < 1e-16f ? 1e-16f : theta2);
    const bool small = theta2 < 1e-3f;
    // a division by a constant is a product with its float32 reciprocal,
    // as torch's CUDA division by a Python number computes it
    const float A = small ? 1.0f - theta2 * (1.0f / 6.0f) : sinf(theta) / theta;
    const float B = small ? 0.5f - theta2 * (1.0f / 24.0f) : (1.0f - cosf(theta)) / theta2;
    const float C = small ? 1.0f / 6.0f - theta2 * (1.0f / 120.0f)
                          : (theta - sinf(theta)) / (theta2 * theta);
    const float W[9] = {0.0f, -p2, p1, p2, 0.0f, -p0, -p1, p0, 0.0f};
    float W2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
    float dR[9], V[9];
    for (int k = 0; k < 9; ++k) {
        const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
        dR[k] = eye + A * W[k] + B * W2[k];
        V[k] = eye + B * W[k] + C * W2[k];
    }
    for (int i = 0; i < 3; ++i) {
        const float dt = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] + V[3 * i + 2] * xi[2];
        tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] + dt;
        for (int j = 0; j < 3; ++j)
            Rn[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] + dR[3 * i + 2] * R[6 + j];
    }
}

__global__ void __launch_bounds__(THREADS) pose_lm_kernel(const Args a) {
    __shared__ float sR[9], st[3], nR[9], nt[3];
    __shared__ float red[WARPS][NACC];
    __shared__ float tot[NACC];
    __shared__ float s_cost, s_lam;
    __shared__ bool s_finite;
    const int tid = threadIdx.x;
    if (tid < 9) sR[tid] = a.R0[tid];
    if (tid < 3) st[tid] = a.t0[tid];
    for (int i = tid; i < a.n; i += THREADS) a.inliers[i] = a.valid[i] ? 1 : 0;
    __syncthreads();
    {
        float c[1] = {robust_cost_part(sR, st, a)};
        block_sum<1>(c, red, tot);
    }
    if (tid == 0) {
        s_cost = tot[0];
        s_lam = 1e-3f;
    }
    const int steps = a.rounds * a.iters;
    for (int step = 0; step < steps; ++step) {
        const bool gate = (step % a.iters == 0) && step > 0;
        float acc[NACC];
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
        __syncthreads();  // s_cost / s_lam of the last step, sR / st
        for (int i = tid; i < a.n; i += THREADS) {
            const Proj p = project(sR, st, a, i);
            const float delta = p.stereo ? HUBER_STEREO : HUBER_MONO;
            const float e = huber_e(p.c2);
            bool inl;
            if (gate) {
                // round-boundary chi2 re-gate, reusing this pass's residuals
                inl = a.valid[i] && p.c2 <= (p.stereo ? CHI2_STEREO : CHI2_MONO) && p.z > 1e-4f;
                a.inliers[i] = inl ? 1 : 0;
                acc[NACC - 1] += inl ? huber_rho(p.c2, e, delta) : 0.0f;
            } else {
                inl = a.inliers[i] != 0;
            }
            const bool active = inl && p.z > 1e-4f;
            const float wh = e <= delta ? 1.0f : delta / e;
            const float w = a.inv2[i] * wh * (active ? 1.0f : 0.0f);
            // d(u, v, ur)/d(camera point) times [I | -hat(pc)]
            const float iz = p.iz, iz2 = iz * iz;
            const float d[3][3] = {
                {a.fx * iz, 0.0f, -a.fx * p.x * iz2},
                {0.0f, a.fy * iz, -a.fy * p.y * iz2},
                {p.stereo ? a.fx * iz : 0.0f, 0.0f,
                 p.stereo ? -a.fx * p.x * iz2 + a.bf * iz2 : 0.0f}};
            float J[3][6];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                J[r][0] = d[r][0];
                J[r][1] = d[r][1];
                J[r][2] = d[r][2];
                J[r][3] = -d[r][1] * p.z + d[r][2] * p.y;
                J[r][4] = d[r][0] * p.z - d[r][2] * p.x;
                J[r][5] = -d[r][0] * p.y + d[r][1] * p.x;
            }
            const float res[3] = {p.r0, p.r1, p.r2};
#pragma unroll
            for (int i6 = 0; i6 < 6; ++i6) {
                const float w0 = J[0][i6] * w, w1 = J[1][i6] * w, w2 = J[2][i6] * w;
#pragma unroll
                for (int j6 = i6; j6 < 6; ++j6)
                    acc[hidx(i6, j6)] += w0 * J[0][j6] + w1 * J[1][j6] + w2 * J[2][j6];
                acc[NH + i6] += w0 * res[0] + w1 * res[1] + w2 * res[2];
            }
        }
        block_sum<NACC>(acc, red, tot);
        if (tid == 0) {
            if (gate) {
                s_cost = tot[NACC - 1];
                s_lam = 1e-3f;
            }
            float xi[6];
            solve6(tot, tot + NH, s_lam, a.damping, xi);
            bool finite = true;
            for (int k = 0; k < 6; ++k) finite = finite && isfinite(xi[k]);
            s_finite = finite;
            exp_compose(xi, sR, st, nR, nt);
        }
        __syncthreads();
        {
            float c[1] = {robust_cost_part(nR, nt, a)};
            block_sum<1>(c, red, tot);
        }
        if (tid == 0) {
            const float cost_new = tot[0];
            // the finite guard: a NaN candidate pose closes every depth gate
            // and would price at 0
            const bool accept = cost_new < s_cost && s_finite && isfinite(cost_new);
            if (accept) {
                for (int k = 0; k < 9; ++k) sR[k] = nR[k];
                for (int k = 0; k < 3; ++k) st[k] = nt[k];
                s_cost = cost_new;
            }
            const float lam = accept ? s_lam * 0.5f : s_lam * 4.0f;
            s_lam = fminf(fmaxf(lam, 1e-6f), 1e6f);
        }
    }
    __syncthreads();
    float cnt[1] = {0.0f};
    for (int i = tid; i < a.n; i += THREADS) {
        const Proj p = project(sR, st, a, i);
        const bool inl = a.valid[i] && p.c2 <= (p.stereo ? CHI2_STEREO : CHI2_MONO) && p.z > 1e-4f;
        a.inliers[i] = inl ? 1 : 0;
        a.chi2[i] = p.c2;
        cnt[0] += inl ? 1.0f : 0.0f;  // exact below 2^24 points
    }
    block_sum<1>(cnt, red, tot);
    if (tid < 9) a.R[tid] = sR[tid];
    if (tid < 3) a.t[tid] = st[tid];
    if (tid == 0) *a.n_inliers = (long long)tot[0];
}

}  // namespace

// Plain C entry: enqueues the solve on `stream` and returns the launch
// status (cudaGetLastError) without synchronizing. All pointers are device
// pointers to contiguous float32 (bytes for valid / inliers, int64 for
// n_inliers); n >= 0.
extern "C" int pose_lm_launch(const void* R0, const void* t0, const void* X, const void* uv,
                              const void* ur, const void* inv2, const void* valid, int n,
                              float fx, float fy, float cx, float cy, float bf,
                              int rounds, int iters, float damping,
                              void* R, void* t, void* inliers, void* n_inliers, void* chi2,
                              void* stream) {
    Args a;
    a.R0 = (const float*)R0;
    a.t0 = (const float*)t0;
    a.X = (const float*)X;
    a.uv = (const float*)uv;
    a.ur = (const float*)ur;
    a.inv2 = (const float*)inv2;
    a.valid = (const unsigned char*)valid;
    a.n = n;
    a.fx = fx;
    a.fy = fy;
    a.cx = cx;
    a.cy = cy;
    a.bf = bf;
    a.rounds = rounds;
    a.iters = iters;
    a.damping = damping;
    a.R = (float*)R;
    a.t = (float*)t;
    a.inliers = (unsigned char*)inliers;
    a.n_inliers = (long long*)n_inliers;
    a.chi2 = (float*)chi2;
    pose_lm_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
