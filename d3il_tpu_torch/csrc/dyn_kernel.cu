// Arm dynamics kernels for Hopper (sm_90a): ik_window (K1) and arm_stage (K2).
//
// ik_window replaces the JAX package's engine/dyn_kernel.py:ik_window_bm
// (Pallas body _make_ik_window_kernel); arm_stage replaces
// engine/dyn_kernel.py:arm_stage_bm (_make_arm_kernel). The TPU kernels put
// one env per vector lane and unroll the chain into immediates; here each
// env is one thread that walks the chain tables (dyn_scalar.cuh) at run
// time, so one set of device functions serves both chains.
//
// Bound on this card. The least time (chip_smoke.py counts the plain
// version's operations and the bytes in and out at the main path's shapes):
//   ik_window: ~0.53 M flop per env per 35-substep window against ~3.1 KB
//     read and written (des pose + state in, 3 x 35 x 7 floats out), so FP32
//     CUDA-core operations bound it;
//   arm_stage: ~14.5 k flop per env against ~1.25 KB (q, qd, setpoints in;
//     17 body poses, 9 dof frames and the 9 x 9 inverse out), ~12 flop per
//     byte, below the card's FP32 balance of ~20: bytes bound it.
// Both run far above that bound: one thread walks the chain serially, with
// its per-body arrays in local memory, so latency is what limits them now.
// Design: batch-minor ([.., B]) layout so neighbouring threads touch
// neighbouring addresses on every load and store; the 35-substep loop of
// ik_window runs inside the thread with q_virt/old_vel in registers and each
// substep's outputs stored straight to global memory.
#include <cuda_runtime.h>

#include "dyn_scalar.cuh"

struct ArmParams {
  float h;
  float grav[3];
  float pg[7];
  float dg[7];
  float damping[D3_MAXV];
  float frange[D3_MAXV][2];
};

struct CartParams {
  int ee;
  int num_iter;
  float pgain[6];
  float W[7];
  float rest[7];
  float pnull[7];
  float lo[7];
  float hi[7];
  float ddg[7];
  float lr, reg, svd_lo, dt;
};

// ---------------------------------------------------------------------------
// K2: arm stage (dyn_kernel._make_arm_kernel)
// ---------------------------------------------------------------------------
__global__ void arm_stage_kernel(const __grid_constant__ ChainTab ch,
                                 const __grid_constant__ ArmParams P, int B,
                                 const float* __restrict__ q_in,
                                 const float* __restrict__ qd_in,
                                 const float* __restrict__ qdes_in,
                                 const float* __restrict__ qddes_in,
                                 const float* __restrict__ taum_in,
                                 const float* __restrict__ sw_in,
                                 const float* __restrict__ gf_in,
                                 float* __restrict__ xpos_o, float* __restrict__ xquat_o,
                                 float* __restrict__ axes_o, float* __restrict__ anch_o,
                                 float* __restrict__ minv_o, float* __restrict__ qdpre_o,
                                 float* __restrict__ aarm_o) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int nv = ch.nv, nb = ch.nb;
  float q[D3_MAXV], qd[D3_MAXV];
  for (int i = 0; i < nv; ++i) {
    q[i] = q_in[i * B + e];
    qd[i] = qd_in[i * B + e];
  }
  v3 xpos[D3_MAXB], axes[D3_MAXV], anchors[D3_MAXV], coms[D3_MAXB];
  qt xquat[D3_MAXB];
  m3 Iw[D3_MAXB];
  float bias[D3_MAXV], M[D3_MAXV * D3_MAXV];
  fk_d(ch, q, xpos, xquat);
  dof_frames_d(ch, xpos, xquat, axes, anchors);
  v3 grav = {P.grav[0], P.grav[1], P.grav[2]};
  rnea_d(ch, xpos, xquat, axes, anchors, qd, nullptr, grav, bias, coms, Iw);
  crba_d(ch, axes, anchors, coms, Iw, M);

  // joint PD + feedforward + gravity comp (envs/common.physics_substep)
  float ctrl[D3_MAXV];
  for (int i = 0; i < 7; ++i)
    ctrl[i] = P.pg[i] * (qdes_in[i * B + e] - q[i]) + P.dg[i] * (qddes_in[i * B + e] - qd[i])
              + taum_in[i * B + e] + bias[i];
  // finger force law (control/gripper.finger_forces)
  const float PG = 500.0f, DG = 10.0f;
  float sw = sw_in[e], gf = gf_in[e];
  float mean_pos = 0.5f * (q[7] + q[8]);
  bool wide = (mean_pos - sw) > 0.005f;
  for (int k = 7; k < 9; ++k) {
    float force = PG * (mean_pos - q[k]);
    float brake = 200.0f * fmaxf(-(qd[k] + 0.2f), 0.0f);
    float grasp = fminf(-20.0f + brake, 0.0f);
    float close_servo = DG * (-0.2f - qd[k]);
    float pd = clampf(PG * (sw - q[k]) - DG * qd[k], -5.0f, 5.0f);
    ctrl[k] = force + (wide ? (gf > 0.5f ? grasp : close_servo) : pd);
  }
  float f_arm[D3_MAXV];
  for (int i = 0; i < nv; ++i)
    f_arm[i] = clampf(ctrl[i], P.frange[i][0], P.frange[i][1]) - bias[i];

  // (M + h D)^-1, smooth acceleration, pre-contact velocity update
  float Mh[D3_MAXV * D3_MAXV], Minv[D3_MAXV * D3_MAXV];
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j)
      Mh[i * D3_MAXV + j] = M[i * D3_MAXV + j] + (i == j ? P.h * P.damping[i] : 0.0f);
  spd_inverse_d(Mh, nv, Minv);
  float a_arm[D3_MAXV], Mqd[D3_MAXV], rhs[D3_MAXV], qd_pre[D3_MAXV];
  matvec_d(Minv, f_arm, nv, a_arm);
  matvec_d(M, qd, nv, Mqd);
  for (int i = 0; i < nv; ++i) rhs[i] = Mqd[i] + P.h * f_arm[i];
  matvec_d(Minv, rhs, nv, qd_pre);

  for (int b = 0; b < nb; ++b) {
    xpos_o[(b * 3 + 0) * B + e] = xpos[b].x;
    xpos_o[(b * 3 + 1) * B + e] = xpos[b].y;
    xpos_o[(b * 3 + 2) * B + e] = xpos[b].z;
    xquat_o[(b * 4 + 0) * B + e] = xquat[b].w;
    xquat_o[(b * 4 + 1) * B + e] = xquat[b].x;
    xquat_o[(b * 4 + 2) * B + e] = xquat[b].y;
    xquat_o[(b * 4 + 3) * B + e] = xquat[b].z;
  }
  for (int d = 0; d < nv; ++d) {
    axes_o[(d * 3 + 0) * B + e] = axes[d].x;
    axes_o[(d * 3 + 1) * B + e] = axes[d].y;
    axes_o[(d * 3 + 2) * B + e] = axes[d].z;
    anch_o[(d * 3 + 0) * B + e] = anchors[d].x;
    anch_o[(d * 3 + 1) * B + e] = anchors[d].y;
    anch_o[(d * 3 + 2) * B + e] = anchors[d].z;
    qdpre_o[d * B + e] = qd_pre[d];
    aarm_o[d * B + e] = a_arm[d];
    for (int j = 0; j < nv; ++j) minv_o[(d * nv + j) * B + e] = Minv[d * D3_MAXV + j];
  }
}

// ---------------------------------------------------------------------------
// K1: IK window (dyn_kernel._make_ik_window_kernel): n_sub cartesian
// DLS-IK updates (dyn_scalar.cart_step_s) + the RNEA feedforward on the
// control chain with g = 0.
// ---------------------------------------------------------------------------
__device__ __noinline__ void cart_step_d(const ChainTab& ch, const CartParams& C, const float* q_virt,
                            const float* old_vel, v3 des_pos, qt des_quat, float* q,
                            float* qd_des, float* qdd_des) {
  v3 xpos0[D3_MAXB], xpos[D3_MAXB], axes[D3_MAXV], anchors[D3_MAXV];
  qt xquat0[D3_MAXB], xquat[D3_MAXB];
  fk_d(ch, q_virt, xpos0, xquat0);
  for (int d = 0; d < 7; ++d) q[d] = q_virt[d];
  qt dq = des_quat;
  const int ee = C.ee;
  for (int it = 0; it < C.num_iter; ++it) {
    const v3* xp = xpos0;
    const qt* xq = xquat0;
    if (it > 0) {
      fk_d(ch, q, xpos, xquat);
      xp = xpos;
      xq = xquat;
    }
    v3 cur_pos = xp[ee];
    qt cq = xq[ee];
    float dm = (cq.w - dq.w) * (cq.w - dq.w) + (cq.x - dq.x) * (cq.x - dq.x)
               + (cq.y - dq.y) * (cq.y - dq.y) + (cq.z - dq.z) * (cq.z - dq.z);
    float dp = (cq.w + dq.w) * (cq.w + dq.w) + (cq.x + dq.x) * (cq.x + dq.x)
               + (cq.y + dq.y) * (cq.y + dq.y) + (cq.z + dq.z) * (cq.z + dq.z);
    float flip = dm > dp ? -1.0f : 1.0f;
    dq = {dq.w * flip, dq.x * flip, dq.y * flip, dq.z * flip};
    v3 pe = des_pos - cur_pos;
    v3 qe = quat_error_d(cq, dq);
    float target[6] = {C.pgain[0] * clampf(pe.x, -0.01f, 0.01f),
                       C.pgain[1] * clampf(pe.y, -0.01f, 0.01f),
                       C.pgain[2] * clampf(pe.z, -0.01f, 0.01f),
                       C.pgain[3] * clampf(qe.x, -0.1f, 0.1f),
                       C.pgain[4] * clampf(qe.y, -0.1f, 0.1f),
                       C.pgain[5] * clampf(qe.z, -0.1f, 0.1f)};
    dof_frames_d(ch, xp, xq, axes, anchors);
    float J[6][7];
    for (int d = 0; d < 7; ++d) {
      v3 jp = cross(axes[d], cur_pos - anchors[d]);
      J[0][d] = jp.x; J[1][d] = jp.y; J[2][d] = jp.z;
      J[3][d] = axes[d].x; J[4][d] = axes[d].y; J[5][d] = axes[d].z;
    }
    float A[D3_MAXV * D3_MAXV];
    for (int i = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j) {
        float s = (i == j) ? C.reg : 0.0f;
        for (int d = 0; d < 7; ++d) s += J[i][d] * C.W[d] * J[j][d];
        A[i * D3_MAXV + j] = s;
        A[j * D3_MAXV + i] = s;
      }
    float qd_null[7];
    for (int d = 0; d < 7; ++d) qd_null[d] = C.pnull[d] * clampf(C.rest[d] - q[d], -0.2f, 0.2f);
    float rhs[6];
    for (int i = 0; i < 6; ++i) {
      float s = 0.0f;
      for (int d = 0; d < 7; ++d) s += J[i][d] * qd_null[d];
      rhs[i] = target[i] - s;
    }
    // clamped SPD solve: Tikhonov + one refinement step, one factorization
    float L[D3_MAXV * D3_MAXV], inv_diag[D3_MAXV], x0[6], x1[6];
    chol_factor_d(A, 6, C.svd_lo, L, inv_diag);
    chol_apply_d(L, inv_diag, rhs, 6, x0);
    chol_apply_d(L, inv_diag, x0, 6, x1);
    float y[6];
    for (int i = 0; i < 6; ++i) y[i] = x0[i] + C.svd_lo * x1[i];
    float qdd_[7], nrm2 = 0.0f;
    for (int d = 0; d < 7; ++d) {
      float s = 0.0f;
      for (int i = 0; i < 6; ++i) s += J[i][d] * y[i];
      qdd_[d] = C.W[d] * s + qd_null[d];
      nrm2 += qdd_[d] * qdd_[d];
    }
    float nrm = sqrtf(nrm2);
    float scale = nrm > 3.0f ? 3.0f / fmaxf(nrm, 1e-9f) : 1.0f;
    for (int d = 0; d < 7; ++d) q[d] = clampf(q[d] + C.lr * qdd_[d] * scale, C.lo[d], C.hi[d]);
  }
  // convergence gate on fk(q_virt)
  qt cq = xquat0[ee];
  float dm = (cq.w - des_quat.w) * (cq.w - des_quat.w) + (cq.x - des_quat.x) * (cq.x - des_quat.x)
             + (cq.y - des_quat.y) * (cq.y - des_quat.y) + (cq.z - des_quat.z) * (cq.z - des_quat.z);
  float dp = (cq.w + des_quat.w) * (cq.w + des_quat.w) + (cq.x + des_quat.x) * (cq.x + des_quat.x)
             + (cq.y + des_quat.y) * (cq.y + des_quat.y) + (cq.z + des_quat.z) * (cq.z + des_quat.z);
  float flip = dm > dp ? -1.0f : 1.0f;
  qt dqf = {des_quat.w * flip, des_quat.x * flip, des_quat.y * flip, des_quat.z * flip};
  v3 pe = des_pos - xpos0[ee];
  v3 qe = quat_error_d(cq, dqf);
  bool converged = (sqrtf(dot(pe, pe)) < 5e-4f) && (sqrtf(dot(qe, qe)) < 5e-3f);
  for (int d = 0; d < 7; ++d) {
    if (converged) q[d] = q_virt[d];
    qd_des[d] = (q[d] - q_virt[d]) / C.dt;
    qdd_des[d] = clampf(C.ddg[d] * (qd_des[d] - old_vel[d]) / C.dt, -25.0f, 25.0f);
  }
}

__global__ void ik_window_kernel(const __grid_constant__ ChainTab ch,
                                 const __grid_constant__ CartParams C, int B, int n_sub,
                                 const float* __restrict__ qv_in,
                                 const float* __restrict__ ov_in,
                                 const float* __restrict__ dp_in,
                                 const float* __restrict__ dq_in,
                                 float* __restrict__ qv_o, float* __restrict__ ov_o,
                                 float* __restrict__ qdes_o, float* __restrict__ qddes_o,
                                 float* __restrict__ tau_o) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float qv[7], ov[7];
  for (int d = 0; d < 7; ++d) {
    qv[d] = qv_in[d * B + e];
    ov[d] = ov_in[d * B + e];
  }
  v3 des_pos = {dp_in[e], dp_in[B + e], dp_in[2 * B + e]};
  qt dq = {dq_in[e], dq_in[B + e], dq_in[2 * B + e], dq_in[3 * B + e]};
  float n = fmaxf(sqrtf(dq.w * dq.w + dq.x * dq.x + dq.y * dq.y + dq.z * dq.z), 1e-12f);
  dq = {dq.w / n, dq.x / n, dq.y / n, dq.z / n};
  const v3 zero = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < n_sub; ++s) {
    float q[D3_MAXV], qd_des[D3_MAXV], qdd_des[D3_MAXV], tau[D3_MAXV];
    cart_step_d(ch, C, qv, ov, des_pos, dq, q, qd_des, qdd_des);
    v3 xpos[D3_MAXB], axes[D3_MAXV], anchors[D3_MAXV];
    qt xquat[D3_MAXB];
    fk_d(ch, q, xpos, xquat);
    dof_frames_d(ch, xpos, xquat, axes, anchors);
    rnea_d(ch, xpos, xquat, axes, anchors, qd_des, qdd_des, zero, tau, nullptr, nullptr);
    for (int d = 0; d < 7; ++d) {
      size_t o = ((size_t)s * 7 + d) * B + e;
      qdes_o[o] = q[d];
      qddes_o[o] = qd_des[d];
      tau_o[o] = tau[d];
      qv[d] = q[d];
      ov[d] = qd_des[d];
    }
  }
  for (int d = 0; d < 7; ++d) {
    qv_o[d * B + e] = qv[d];
    ov_o[d * B + e] = ov[d];
  }
}

// ---------------------------------------------------------------------------
// C entry points (ctypes): launch on the caller's stream, return the launch
// status. Pointers are device pointers; the tables are host structs passed
// by value into the kernel's constant parameter bank.
// ---------------------------------------------------------------------------
static const int kThreads = 64;

extern "C" int d3il_arm_stage(const ChainTab* ch, const ArmParams* P, int B,
                              const float* q, const float* qd, const float* q_des,
                              const float* qd_des, const float* tau_model, const float* sw,
                              const float* gf, float* xpos, float* xquat, float* axes,
                              float* anch, float* minv, float* qd_pre, float* a_arm,
                              void* stream) {
  if (ch->nv != 9 || ch->nb > D3_MAXB) return (int)cudaErrorInvalidValue;
  int blocks = (B + kThreads - 1) / kThreads;
  arm_stage_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *ch, *P, B, q, qd, q_des, qd_des, tau_model, sw, gf, xpos, xquat, axes, anch, minv,
      qd_pre, a_arm);
  return (int)cudaGetLastError();
}

extern "C" int d3il_ik_window(const ChainTab* ch, const CartParams* C, int B, int n_sub,
                              const float* q_virt, const float* old_vel, const float* des_pos,
                              const float* des_quat, float* qv_out, float* ov_out,
                              float* q_des, float* qd_des, float* tau, void* stream) {
  if (ch->nv != 7 || ch->nb > D3_MAXB) return (int)cudaErrorInvalidValue;
  int blocks = (B + kThreads - 1) / kThreads;
  ik_window_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *ch, *C, B, n_sub, q_virt, old_vel, des_pos, des_quat, qv_out, ov_out, q_des, qd_des,
      tau);
  return (int)cudaGetLastError();
}

extern "C" int d3il_struct_sizes(int* out) {
  out[0] = (int)sizeof(ChainTab);
  out[1] = (int)sizeof(ArmParams);
  out[2] = (int)sizeof(CartParams);
  return 0;
}
