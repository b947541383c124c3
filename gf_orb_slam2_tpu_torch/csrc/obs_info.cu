// The good-feature selection's information matrices for Hopper (sm_90a): the
// pool's [P,7,7] per-landmark matrices and the matched keypoints' [n,7,7],
// from the pose, in ONE launch.
//
// Replaces no Pallas kernel. The JAX package computes the same inputs of its
// Max-logDet selection as plain jnp inside its local step
// (gf_orb_slam2_tpu/tracking/tracker.py `local_step`, through
// gf_orb_slam2_tpu/selection/observability.py `info_matrices` /
// `pose_info_from_frame` and gf_orb_slam2_tpu/geometry/lie.py `rot_to_quat`),
// which XLA fuses into its program. The port's plain PyTorch version,
// selection/observability.py `pose_info_for_selection_ref`, runs them as
// ~290 elementwise, stack, mm and bmm launches of a few microseconds of work
// each, and the host pays for every launch.
//
//   R [3,3], t [3] float32 (the pose, world -> camera), pos [P,3] float32,
//   pred_octave [P] int64, valid [P] bytes, scales [L] float32,
//   kp_pos [n,3] float32, kp_valid [n] bytes
//   -> obs [P,7,7], kp_obs [n,7,7] float32 (the wrapper sums kp_obs over its
//      rows with torch, as the plain version sums its keypoint matrices)
//
// Each thread, in the plain version's order: the quaternion q of R^T by
// Shepperd's branchless formula (lie.rot_to_quat: the four pivots, the
// first-occurrence arg-maximum, w >= 0, normalized), the centre -(R^T t), and
// the rotation of q again (lie.quat_to_rot), I - q q^T and 2w. Then per row
// (observability.measurement_jacobians and info_matrices): d = p - centre,
// p_c = d R(q), z clamped at 1e-6, the [3,3] projection derivative (the
// u_right row zeroed for a mono sensor), the derivative of p_c in the
// position (-R(q)^T) and in q (projected onto the unit-quaternion tangent),
// their products H [3,7], the weight (valid and z > 1e-3) * 1/scale^2 of the
// clamped octave (the keypoint rows: weight 1), and M = (H w)^T H.
//
// Rounding: every elementwise product and sum is rounded on its own (the
// build's -fmad=false), as the plain version's elementwise launches round
// them. Where the plain version calls mm or bmm (inner sizes 3 and 4), the
// card's cuBLAS sums the products as one fused multiply-add chain in
// ascending order, and so does this kernel (fmaf); its mv (gemv) fuses the
// second product only, ((a0 b0 + a1 b1) fused) + a2 b2; the cross product is
// torch's kernel compiled with contraction, v1 d2 - v2 d1 as
// fma(v1, d2, -(v2 d1)); the quaternion's norm is summed as torch's CUDA
// reduction of four values sums it, (a0 + a2) + (a1 + a3). These orders
// were read off the card's results (H100, the plain chain step by step
// against every order of each sum). So at the path's shapes every matrix
// equals the plain version's bit for bit (tests/test_torch_obs_info.py
// holds that); at 16 rows or fewer cuBLAS computes d R(q) with another
// kernel, and the keypoints' matrices then differ by rounding.
//
// Blocks 0 .. ceil(P/128)-1 take 128 pool rows each, the rest 128 keypoint
// rows each, one row a thread; each block stages its matrices in shared
// memory and writes its 128 * 49 floats in one coalesced stretch.
//
// What bounds it on this card: neither bytes nor operations. At the path's
// shapes (P = 4096, n = 1024) it writes 1.0 MB, reads 0.1 MB and computes
// ~4 MFLOP: a bound of ~0.33 us against a few us of launch and one pass of
// 40 blocks. The design spends nothing on that: it exists to take the
// plain version's ~290 launches, and their host enqueue, off the frame.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int D = 7;
constexpr int DD = D * D;

struct Args {
    const float* R;
    const float* t;
    const float* pos;
    const int64_t* oct;
    const unsigned char* valid;
    const float* scales;
    const float* kp_pos;
    const unsigned char* kp_valid;
    int P, n, n_levels;
    float fx, fy, bf;
    float stereo;   // 1 or 0: multiplies the u_right row, as the plain mask does
    float* obs;
    float* kp_obs;
};

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

// a0 b0 + a1 b1 + a2 b2 as cuBLAS's mm and bmm sum an inner size of 3
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
    return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// the same as cuBLAS's mv (gemv) sums it: the third product added unfused
__device__ __forceinline__ float gemv3(float a0, float b0, float a1, float b1, float a2,
                                       float b2) {
    return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

// the pose as the selection's state, and what every row shares
struct Pose {
    float q[4];       // unit quaternion [w,x,y,z] of R^T (camera -> world)
    float c[3];       // camera centre -(R^T t)
    float Rq[3][3];   // quat_to_rot(q)
    float proj[4][4]; // I - q q^T
    float tw;         // 2 w
};

__device__ __forceinline__ float norm4(const float* q) {
    // torch.sum of four float32 on the card: lanes 0-3, shuffled down by 2 then 1
    const float a0 = q[0] * q[0], a1 = q[1] * q[1], a2 = q[2] * q[2], a3 = q[3] * q[3];
    return sqrtf((a0 + a2) + (a1 + a3));
}

__device__ void make_pose(const float* R, const float* t, Pose& ps) {
    // m_ij = (R^T)_ij
    const float m00 = R[0], m01 = R[3], m02 = R[6];
    const float m10 = R[1], m11 = R[4], m12 = R[7];
    const float m20 = R[2], m21 = R[5], m22 = R[8];
    const float tr = (m00 + m11) + m22;
    float s[4] = {1.f + tr, ((1.f + m00) - m11) - m22, ((1.f - m00) + m11) - m22,
                  ((1.f - m00) - m11) + m22};
    bool nan = false;
#pragma unroll
    for (int i = 0; i < 4; i++) {
        s[i] = sqrtf(clamp_min(s[i], 1e-8f)) * 0.5f;
        nan |= isnan(s[i]);
    }
    // first-occurrence arg-maximum; no maximum (a NaN) picks 3
    const float mx = nan ? __int_as_float(0x7fffffff) : fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
    int k = 3;
#pragma unroll
    for (int i = 3; i >= 0; i--)
        if (s[i] >= mx) k = i;
    float* q = ps.q;
    const float f = 4.f * s[k];
    if (k == 0) {
        q[0] = s[0]; q[1] = (m21 - m12) / f; q[2] = (m02 - m20) / f; q[3] = (m10 - m01) / f;
    } else if (k == 1) {
        q[0] = (m21 - m12) / f; q[1] = s[1]; q[2] = (m01 + m10) / f; q[3] = (m02 + m20) / f;
    } else if (k == 2) {
        q[0] = (m02 - m20) / f; q[1] = (m01 + m10) / f; q[2] = s[2]; q[3] = (m12 + m21) / f;
    } else {
        q[0] = (m10 - m01) / f; q[1] = (m02 + m20) / f; q[2] = (m12 + m21) / f; q[3] = s[3];
    }
    const float sign = q[0] < 0.f ? -1.f : 1.f;
#pragma unroll
    for (int i = 0; i < 4; i++) q[i] = q[i] * sign;
    float nq = clamp_min(norm4(q), 1e-8f);
#pragma unroll
    for (int i = 0; i < 4; i++) q[i] = q[i] / nq;

    // centre = -(R^T t)
#pragma unroll
    for (int i = 0; i < 3; i++) ps.c[i] = -gemv3(R[i], t[0], R[3 + i], t[1], R[6 + i], t[2]);

    // quat_to_rot(q): normalized again
    float u[4];
    nq = clamp_min(norm4(q), 1e-8f);
#pragma unroll
    for (int i = 0; i < 4; i++) u[i] = q[i] / nq;
    const float w = u[0], x = u[1], y = u[2], z = u[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    ps.Rq[0][0] = 1.f - 2.f * (yy + zz);
    ps.Rq[0][1] = 2.f * (xy - wz);
    ps.Rq[0][2] = 2.f * (xz + wy);
    ps.Rq[1][0] = 2.f * (xy + wz);
    ps.Rq[1][1] = 1.f - 2.f * (xx + zz);
    ps.Rq[1][2] = 2.f * (yz - wx);
    ps.Rq[2][0] = 2.f * (xz - wy);
    ps.Rq[2][1] = 2.f * (yz + wx);
    ps.Rq[2][2] = 1.f - 2.f * (xx + yy);
#pragma unroll
    for (int a = 0; a < 4; a++)
#pragma unroll
        for (int b = 0; b < 4; b++) ps.proj[a][b] = (a == b ? 1.f : 0.f) - q[a] * q[b];
    ps.tw = 2.f * q[0];
}

// H [3,7] of the point p (observability.measurement_jacobians); returns p_c's
// unclamped depth
__device__ __forceinline__ float jacobian(const Pose& ps, const float* p, float fx, float fy,
                                          float bf, float stereo, float H[3][D]) {
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; k++) d[k] = p[k] - ps.c[k];
    float pc[3];
#pragma unroll
    for (int j = 0; j < 3; j++)
        pc[j] = dot3(d[0], ps.Rq[0][j], d[1], ps.Rq[1][j], d[2], ps.Rq[2][j]);
    const float x = pc[0], y = pc[1], z = clamp_min(pc[2], 1e-6f);
    const float iz = 1.f / z;
    const float iz2 = iz * iz;
    const float ux = ((-fx) * x) * iz2;
    const float A[3][3] = {{fx * iz, 0.f, ux},
                           {0.f, fy * iz, ((-fy) * y) * iz2},
                           {(fx * iz) * stereo, 0.f * stereo, (ux + bf * iz2) * stereo}};
    // d p_c / d position = -R(q)^T
    float dp[3][3];
#pragma unroll
    for (int k = 0; k < 3; k++)
#pragma unroll
        for (int j = 0; j < 3; j++) dp[k][j] = -ps.Rq[j][k];
    // d p_c / d q, then onto the tangent: dq = [d/dw | d/dv] (I - q q^T)
    const float* v = ps.q + 1;
    const float vxd[3] = {fmaf(v[1], d[2], -(v[2] * d[1])), fmaf(v[2], d[0], -(v[0] * d[2])),
                          fmaf(v[0], d[1], -(v[1] * d[0]))};
    const float tvtd = 2.f * gemv3(d[0], v[0], d[1], v[1], d[2], v[2]);
    const float hat[3][3] = {{0.f, -d[2], d[1]}, {d[2], 0.f, -d[0]}, {-d[1], d[0], 0.f}};
    float g[3][4];
#pragma unroll
    for (int a = 0; a < 3; a++) {
        g[a][0] = ps.tw * d[a] - 2.f * vxd[a];
#pragma unroll
        for (int b = 0; b < 3; b++)
            g[a][1 + b] = (((2.f * v[a]) * d[b] + tvtd * (a == b ? 1.f : 0.f))
                           - (2.f * d[a]) * v[b]) + ps.tw * hat[a][b];
    }
    float dq[3][4];
#pragma unroll
    for (int a = 0; a < 3; a++)
#pragma unroll
        for (int b = 0; b < 4; b++)
            dq[a][b] = fmaf(g[a][3], ps.proj[3][b],
                            dot3(g[a][0], ps.proj[0][b], g[a][1], ps.proj[1][b],
                                 g[a][2], ps.proj[2][b]));
#pragma unroll
    for (int r = 0; r < 3; r++) {
#pragma unroll
        for (int j = 0; j < 3; j++)
            H[r][j] = dot3(A[r][0], dp[0][j], A[r][1], dp[1][j], A[r][2], dp[2][j]);
#pragma unroll
        for (int b = 0; b < 4; b++)
            H[r][3 + b] = dot3(A[r][0], dq[0][b], A[r][1], dq[1][b], A[r][2], dq[2][b]);
    }
    return pc[2];
}

__global__ void __launch_bounds__(THREADS) obs_info_kernel(const Args a) {
    __shared__ float stage[THREADS * DD];  // 25,088 bytes
    const int tid = threadIdx.x;
    const int pool_blocks = (a.P + THREADS - 1) / THREADS;
    const bool kp = blockIdx.x >= pool_blocks;
    const int row0 = (kp ? blockIdx.x - pool_blocks : blockIdx.x) * THREADS;
    const int rows = min(THREADS, (kp ? a.n : a.P) - row0);
    const int i = row0 + tid;
    if (tid < rows) {
        Pose ps;
        make_pose(a.R, a.t, ps);
        float H[3][D];
        const float* p = (kp ? a.kp_pos : a.pos) + 3 * (size_t)i;
        const float z = jacobian(ps, p, a.fx, a.fy, a.bf, a.stereo, H);
        float w;
        if (kp) {
            w = (a.kp_valid[i] && z > 1e-3f) ? 1.f : 0.f;
        } else {
            int64_t o = a.oct[i];
            o = o < 0 ? 0 : (o > a.n_levels - 1 ? a.n_levels - 1 : o);
            const float sc = a.scales[o];
            w = ((a.valid[i] && z > 1e-3f) ? 1.f : 0.f) * (1.f / (sc * sc));
        }
        // (H w)^T H
#pragma unroll
        for (int e = 0; e < DD; e++) {
            const int r = e / D, c = e % D;
            stage[tid * DD + e] = dot3(H[0][r] * w, H[0][c], H[1][r] * w, H[1][c],
                                       H[2][r] * w, H[2][c]);
        }
    }
    __syncthreads();
    float* out = (kp ? a.kp_obs : a.obs) + (size_t)row0 * DD;
    for (int k = tid; k < rows * DD; k += THREADS) out[k] = stage[k];
}

}  // namespace

extern "C" int obs_info_launch(const void* R, const void* t, const void* pos, const void* oct,
                               const void* valid, const void* scales, const void* kp_pos,
                               const void* kp_valid, int P, int n, int n_levels, float fx,
                               float fy, float bf, int stereo, void* obs, void* kp_obs,
                               void* stream) {
    if (P < 0 || n < 0 || n_levels < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (P + THREADS - 1) / THREADS + (n + THREADS - 1) / THREADS;
    if (blocks == 0) return (int)cudaSuccess;
    Args a{(const float*)R, (const float*)t, (const float*)pos, (const int64_t*)oct,
           (const unsigned char*)valid, (const float*)scales, (const float*)kp_pos,
           (const unsigned char*)kp_valid, P, n, n_levels, fx, fy, bf, stereo ? 1.f : 0.f,
           (float*)obs, (float*)kp_obs};
    obs_info_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
