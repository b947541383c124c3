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
// (H + lambda*diag(damping + diag H)) xi = -b by Cholesky (SPD for lambda >=
// 1e-6; a pivot that is not positive makes the step NaN, which the finite
// guard rejects, as the plain version's solve on a singular system);
// se3_exp and the left compose; the candidate's robust cost summed over the
// block; the accept test with the finite guard; lambda halved or quadrupled
// within [1e-6, 1e6]. The last pass writes the final chi2 gate, chi2 and the
// pose; n_inliers is summed on the device. Built without FMA contraction
// (cuda_lib's -fmad=false): every product and sum is rounded on its own, as
// the plain version's elementwise launches round them; its matrix products
// and sums over the points (cuBLAS, torch's reductions) and its LU solve
// keep orders of their own, so the two agree to float32 rounding, not bit
// for bit.
//
// What bounds it on this card: latency, not bytes or operations. The inputs
// are ~37 KB at N = 1024 (0.011 us of HBM) and a 24-step solve does ~7 MFLOP
// (0.1 us of the fp32 peak), but every step is a chain of dependent phases:
// a pass over the points (issue-bound on the one SM's four schedulers), a
// block-wide sum, the 6x6 solve and exponential (~5,000 cycles of dependent
// square roots, divisions and sin/cos), and the barriers between them.
//
// The design (it replaces the first version's one-block design, whose
// every step made two passes over the points -- H and b at the current
// pose, then the candidate's cost --, two block sums, a serial solve on one
// thread and five barriers): the same arithmetic, every value computed by the same
// operations in the same order (point i on thread i mod 256 of 256 point
// threads, each thread's sums in point order, the block sums' xor shuffles
// then the warps in order), scheduled so that
//  1. a step makes ONE pass: the candidate's pass sums its robust cost AND
//     its H and b (the same mask, Huber weight and Jacobian code). Accepted,
//     those are the next step's normal equations; rejected, the pose and the
//     mask are unchanged, so the next step solves the kept H and b again
//     with the new lambda. Only the first step and a round's re-gate step
//     make a pass at the accepted pose of their own: 28 passes and block
//     sums for 3 x 8 instead of 50;
//  2. a ninth warp, the solver, takes the block sums' last stage, the accept
//     test and every solve. While the point warps make the candidate's pass
//     it solves the next step as a rejection would leave it (the same H, b
//     and pose, lambda x 4), so a rejected step costs no solve after its
//     pass; an accepted one solves from the candidate's sums. The Cholesky
//     factor and the forward substitution run over lanes 0-5 (lane r owns
//     row r; each value the serial loop's operations in its order): two
//     barriers a step instead of five;
//  3. the inputs (28 bytes a point) and the two masks are held in registers
//     for N <= 1024, loaded once (4 points a thread); a larger N reads them
//     from memory on every pass, as the first version did.
// What it still gives up: a solve uses one SM of 132, so the card is idle
// beside it unless other streams fill it; the pass could be split over the
// SMs of a cluster (each thread's four points' terms added in order by one
// thread, through DSMEM), worth at most the pass's time beyond the
// speculative solve's beside it; not built (PERF.md);
// several solves (the relocalization's candidates) would want one block
// each in one launch. Measured times on an H100 are kept in PERF.md.
// Any N >= 0; float32 only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // the point threads: point i on thread i mod 256
constexpr int WARPS = THREADS / 32;   // the point warps
constexpr int BLOCK = THREADS + 32;   // and the solver warp
constexpr int STAGED = 4;         // points a thread holds in registers: N <= 1024
constexpr int NH = 21;            // upper triangle of the 6x6 H
constexpr int NACC = NH + 6 + 1;  // H, b, the robust cost
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

// One observation's inputs.
struct Obs {
    float X0, X1, X2, u, v, ur, inv2;
};

__device__ __forceinline__ Obs load_obs(const Args& a, int i) {
    return {a.X[3 * i], a.X[3 * i + 1], a.X[3 * i + 2], a.uv[2 * i], a.uv[2 * i + 1], a.ur[i],
            a.inv2[i]};
}

// This thread's points (i = tid + THREADS*k) in registers, with the valid
// and inlier masks as bits k; PPT = 0 keeps nothing (read from memory).
template <int PPT>
struct Points {
    Obs o[PPT > 0 ? PPT : 1];
    unsigned valid, inl;
};

// One observation projected at a pose: the camera point (z not clamped),
// the clamped inverse depth, the residuals (third = stereo, 0 for mono) and
// chi2.
struct Proj {
    float x, y, z, iz, r0, r1, r2, c2;
    bool stereo;
};

__device__ __forceinline__ Proj project(const float* R, const float* t, const Args& a,
                                        const Obs& o) {
    Proj p;
    p.x = o.X0 * R[0] + o.X1 * R[1] + o.X2 * R[2] + t[0];
    p.y = o.X0 * R[3] + o.X1 * R[4] + o.X2 * R[5] + t[1];
    p.z = o.X0 * R[6] + o.X1 * R[7] + o.X2 * R[8] + t[2];
    const float zc = p.z < 1e-6f ? 1e-6f : p.z;
    p.iz = 1.0f / zc;
    const float u = a.fx * p.x * p.iz + a.cx;
    const float v = a.fy * p.y * p.iz + a.cy;
    p.stereo = o.ur >= 0.0f;
    p.r0 = u - o.u;
    p.r1 = v - o.v;
    p.r2 = p.stereo ? (u - a.bf * p.iz) - o.ur : 0.0f;
    const float e2 = p.r0 * p.r0 + p.r1 * p.r1 + (p.stereo ? p.r2 * p.r2 : 0.0f);
    p.c2 = e2 * o.inv2;
    return p;
}

// sqrt(max(c2, 1e-12)) with torch.clamp's NaN propagation
__device__ __forceinline__ float huber_e(float c2) { return sqrtf(c2 < 1e-12f ? 1e-12f : c2); }

__device__ __forceinline__ float huber_rho(float c2, float e, float delta) {
    return e <= delta ? c2 : 2.0f * delta * e - delta * delta;
}

// index of H[i][j], i <= j, in the packed upper triangle
__host__ __device__ constexpr int hidx(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

// One observation's terms added to acc: the robust cost (acc[NACC-1]) and H,
// b. GATE: the round-boundary chi2 re-gate sets `inl` from this projection;
// else `inl` is the running mask.
template <bool GATE>
__device__ __forceinline__ void accumulate(const Proj& p, const Obs& o, bool valid, bool& inl,
                                           const Args& a, float (&acc)[NACC]) {
    const float delta = p.stereo ? HUBER_STEREO : HUBER_MONO;
    const float e = huber_e(p.c2);
    const float rho = huber_rho(p.c2, e, delta);
    if (GATE) {
        inl = valid && p.c2 <= (p.stereo ? CHI2_STEREO : CHI2_MONO) && p.z > 1e-4f;
        acc[NACC - 1] += inl ? rho : 0.0f;
    } else {
        acc[NACC - 1] += (inl && p.z > 1e-4f) ? rho : 0.0f;
    }
    const bool active = inl && p.z > 1e-4f;
    const float wh = e <= delta ? 1.0f : delta / e;
    const float w = o.inv2 * wh * (active ? 1.0f : 0.0f);
    // d(u, v, ur)/d(camera point) times [I | -hat(pc)]
    const float iz = p.iz, iz2 = iz * iz;
    const float d[3][3] = {
        {a.fx * iz, 0.0f, -a.fx * p.x * iz2},
        {0.0f, a.fy * iz, -a.fy * p.y * iz2},
        {p.stereo ? a.fx * iz : 0.0f, 0.0f, p.stereo ? -a.fx * p.x * iz2 + a.bf * iz2 : 0.0f}};
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

// A point warp's xor-shuffle sums of v[0..K), written by its lane 0 to
// red[warp].
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K], float (*red)[NACC]) {
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
}

// The block's sum of value k < NACC: the warps' sums in warp order.
__device__ __forceinline__ float block_total(float (*red)[NACC], int k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][k];
    return s;
}

// A pass of the point warps over their points at pose (R, t): the robust
// cost and H, b summed over the block into red, while the solver warp runs
// `beside`; then the barrier.
template <int PPT, bool GATE, typename Beside>
__device__ __forceinline__ void sweep(const float* R, const float* t, const Args& a,
                                      Points<PPT>& pts, float (*red)[NACC], Beside beside) {
    if (threadIdx.x < THREADS) {
        float acc[NACC];
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
        if constexpr (PPT > 0) {
#pragma unroll
            for (int k = 0; k < PPT; ++k) {
                if ((int)threadIdx.x + THREADS * k < a.n) {
                    bool inl = (pts.inl >> k) & 1u;
                    accumulate<GATE>(project(R, t, a, pts.o[k]), pts.o[k],
                                     (pts.valid >> k) & 1u, inl, a, acc);
                    if (GATE) pts.inl = inl ? pts.inl | (1u << k) : pts.inl & ~(1u << k);
                }
            }
        } else {
            for (int i = threadIdx.x; i < a.n; i += THREADS) {
                const Obs o = load_obs(a, i);
                bool inl = a.inliers[i] != 0;
                accumulate<GATE>(project(R, t, a, o), o, a.valid[i] != 0, inl, a, acc);
                if (GATE) a.inliers[i] = inl ? 1 : 0;
            }
        }
        warp_sums<NACC>(acc, red);
    } else {
        beside();
    }
    __syncthreads();
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

// Warp 0's step (all 32 lanes call it): xi of (H + lam * diag(damping +
// diag H)) xi = -b by Cholesky, H and b packed in Hb, each value by the
// sequence of operations of the serial loop `for i, for j <= i` (the
// diagonal damped first, then the products of earlier columns subtracted in
// column order, then the square root or the division); a pivot that is not
// positive makes xi NaN. The factor's columns and the forward substitution
// run over lanes 0-5 (lane r owns row r; lanes above 5 repeat row 5), the
// back substitution, whose sums run in column order, in every lane; then
// lane 0 composes se3_exp(xi) onto (R, t) into (Rn, tn). Returns the finite
// guard (xi finite), the same in every lane.
__device__ bool solve_step(const float* Hb, float lam, float damping, const float* R,
                           const float* t, float* Rn, float* tn) {
    const int lane = threadIdx.x & 31, r = lane < 6 ? lane : 5;
    float s[6];  // row r's running sums, columns 0..r
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        s[j] = j <= r ? Hb[hidx(j <= r ? j : r, r)] : 0.0f;
        if (j == r) s[j] = s[j] + lam * (damping + s[j]);
    }
    float Lr[6];  // row r of the factor
    bool bad = false;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        float dkk = 0.0f;
        if (r == k) {
            bad = !(s[k] > 0.0f);
            dkk = sqrtf(s[k]);
        }
        const float Lkk = __shfl_sync(FULL, dkk, k);
        Lr[k] = r == k ? Lkk : (r > k ? s[k] / Lkk : 0.0f);
#pragma unroll
        for (int j = k + 1; j < 6; ++j) {
            const float Ljk = __shfl_sync(FULL, Lr[k], j);
            if (j <= r) s[j] -= Lr[k] * Ljk;
        }
    }
    bad = __any_sync(FULL, bad);
    float y[6];
    float sy = Hb[NH + r];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        y[k] = __shfl_sync(FULL, r == k ? sy / Lr[k] : 0.0f, k);
        if (r > k) sy -= Lr[k] * y[k];
    }
    float L[6][6];  // the factor's columns below the diagonal, in every lane
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int k = i; k < 6; ++k) L[k][i] = __shfl_sync(FULL, Lr[i], k);
    }
    float xi[6];
#pragma unroll
    for (int i = 5; i >= 0; --i) {
        float v = y[i];
#pragma unroll
        for (int k = i + 1; k < 6; ++k) v -= L[k][i] * xi[k];
        xi[i] = v / L[i][i];
    }
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        xi[i] = bad ? __int_as_float(0x7fc00000) : -xi[i];
        finite = finite && isfinite(xi[i]);
    }
    if (lane == 0) exp_compose(xi, R, t, Rn, tn);
    return finite;
}

template <int PPT>
__global__ void __launch_bounds__(BLOCK) pose_lm_kernel(const Args a) {
    __shared__ float sR[9], st[3], nR[9], nt[3], rR[9], rt[3];
    __shared__ float red[WARPS][NACC];
    __shared__ float Hb[NH + 6];  // H and b at the accepted pose
    const int tid = threadIdx.x, lane = tid & 31;
    const bool solver = tid >= THREADS;
    const auto idle = [] {};
    Points<PPT> pts;
    if constexpr (PPT > 0) {
        pts.valid = 0u;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
            const int i = tid + THREADS * k;
            if (!solver && i < a.n) {
                pts.o[k] = load_obs(a, i);
                pts.valid |= (a.valid[i] ? 1u : 0u) << k;
            }
        }
        pts.inl = pts.valid;
    } else if (!solver) {
        for (int i = tid; i < a.n; i += THREADS) a.inliers[i] = a.valid[i] ? 1 : 0;
    }
    if (tid < 9) sR[tid] = a.R0[tid];
    if (tid < 3) st[tid] = a.t0[tid];
    __syncthreads();
    // the solver warp's registers: the accepted pose's robust cost, lambda,
    // the finite guard of the candidate in flight and of the speculative one
    float cost = 0.0f, lam = 0.0f;
    bool finite = false, rfinite = false;
    const int steps = a.rounds * a.iters;
    // the first step's normal equations and the starting cost, over the valid points
    sweep<PPT, false>(sR, st, a, pts, red, idle);
    if (solver) {
        const float tot = lane < NACC ? block_total(red, lane) : 0.0f;
        if (lane < NH + 6) Hb[lane] = tot;
        cost = __shfl_sync(FULL, tot, NACC - 1);
        lam = 1e-3f;
        __syncwarp();
        if (steps > 0) finite = solve_step(Hb, lam, a.damping, sR, st, nR, nt);
    }
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
        const int next = step + 1;
        const bool gate_next = next < steps && next % a.iters == 0;
        const bool speculate = next < steps && !gate_next;
        // the candidate: its cost, and H and b there for the next step; the
        // solver warp meanwhile solves the next step as a rejection would
        // leave it (the same H, b and pose, lambda x 4)
        sweep<PPT, false>(nR, nt, a, pts, red, [&] {
            if (speculate)
                rfinite = solve_step(Hb, fminf(fmaxf(lam * 4.0f, 1e-6f), 1e6f), a.damping, sR,
                                     st, rR, rt);
        });
        if (solver) {
            const float tot = lane < NACC ? block_total(red, lane) : 0.0f;
            const float cost_new = __shfl_sync(FULL, tot, NACC - 1);
            // the finite guard: a NaN candidate pose closes every depth gate
            // and would price at 0
            const bool accept = cost_new < cost && finite && isfinite(cost_new);
            if (accept) {
                if (lane < 9) sR[lane] = nR[lane];
                if (lane < 3) st[lane] = nt[lane];
                if (lane < NH + 6) Hb[lane] = tot;
                cost = cost_new;
            }
            const float l = accept ? lam * 0.5f : lam * 4.0f;
            lam = fminf(fmaxf(l, 1e-6f), 1e6f);
            __syncwarp();
            if (speculate) {
                if (accept) {
                    finite = solve_step(Hb, lam, a.damping, sR, st, nR, nt);
                } else {
                    if (lane < 9) nR[lane] = rR[lane];
                    if (lane < 3) nt[lane] = rt[lane];
                    finite = rfinite;
                }
            }
        }
        if (gate_next) {
            // round boundary: the chi2 re-gate at the accepted pose, the
            // cost reset and lambda <- 1e-3, with sums of its own
            __syncthreads();
            sweep<PPT, true>(sR, st, a, pts, red, idle);
            if (solver) {
                const float tot = lane < NACC ? block_total(red, lane) : 0.0f;
                if (lane < NH + 6) Hb[lane] = tot;
                cost = __shfl_sync(FULL, tot, NACC - 1);
                lam = 1e-3f;
                __syncwarp();
                finite = solve_step(Hb, lam, a.damping, sR, st, nR, nt);
            }
        }
        __syncthreads();
    }
    // the final chi2 gate at the accepted pose
    if (!solver) {
        float cnt[1] = {0.0f};
        if constexpr (PPT > 0) {
#pragma unroll
            for (int k = 0; k < PPT; ++k) {
                const int i = tid + THREADS * k;
                if (i < a.n) {
                    const Proj p = project(sR, st, a, pts.o[k]);
                    const bool inl = ((pts.valid >> k) & 1u) &&
                                     p.c2 <= (p.stereo ? CHI2_STEREO : CHI2_MONO) && p.z > 1e-4f;
                    a.inliers[i] = inl ? 1 : 0;
                    a.chi2[i] = p.c2;
                    cnt[0] += inl ? 1.0f : 0.0f;  // exact below 2^24 points
                }
            }
        } else {
            for (int i = tid; i < a.n; i += THREADS) {
                const Proj p = project(sR, st, a, load_obs(a, i));
                const bool inl =
                    a.valid[i] && p.c2 <= (p.stereo ? CHI2_STEREO : CHI2_MONO) && p.z > 1e-4f;
                a.inliers[i] = inl ? 1 : 0;
                a.chi2[i] = p.c2;
                cnt[0] += inl ? 1.0f : 0.0f;
            }
        }
        warp_sums<1>(cnt, red);
    }
    __syncthreads();
    if (tid < 9) a.R[tid] = sR[tid];
    if (tid < 3) a.t[tid] = st[tid];
    if (tid == 0) *a.n_inliers = (long long)block_total(red, 0);
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
    if (n <= STAGED * THREADS)
        pose_lm_kernel<STAGED><<<1, BLOCK, 0, (cudaStream_t)stream>>>(a);
    else
        pose_lm_kernel<0><<<1, BLOCK, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
