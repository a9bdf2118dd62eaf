// Scalar robot dynamics as CUDA device functions.
//
// Counterpart of engine/dyn_scalar.py (and of the JAX package's
// engine/dyn_scalar.py, which folds chain constants into immediates at
// trace time). A chain's constants are a small table (ChainTab), passed to a
// kernel as a __grid_constant__ parameter (the constant bank) and copied to
// shared memory by kernels whose lanes read different bodies at once.
//
// Two kinds of code use it:
//   * the small helpers (vectors, quaternions, rot_inertia, add_steiner),
//     which arm_stage uses on the 9-dof, 17-body MJCF sim chain, walking
//     the table to its run-time nb (dyn_kernel.cu);
//   * the control chain's per-body steps (cc_*, below), for ik_window and
//     feedforward. The 7-dof URDF control chain's structure (parents, joint
//     types, dofs) is fixed here at compile time, so loops over its bodies
//     unroll, parent indices are constants and per-body state stays in
//     registers; its numbers still come from the table, and cc_matches
//     checks a table against the structure before a launch. feedforward
//     runs the steps in one thread (cc_feedforward); ik_window runs the same
//     steps spread over a group of lanes, so both compute one thing in one
//     operation order, that of engine/dyn_scalar.py.
//
// Everything here is inlined. The first port kept its per-thread FK, RNEA
// and Cholesky functions __noinline__, because nvcc 12.8 returned wrong bias
// forces with them inlined into that port's one-thread arm_stage (ROADMAP.md
// section 3); the kernels built on this file are held against their plain
// versions with everything inlined (tests/test_torch_cuda.py).
#pragma once

#include <math.h>

#define D3_MAXB 17   // bodies
#define D3_MAXV 9    // dofs
#define D3_FIXED 0
#define D3_HINGE 1
#define D3_SLIDE 2

// All fields are 32-bit so the Python ctypes mirror needs no padding rules.
struct ChainTab {
  int nb, nv;
  int parent[D3_MAXB];
  int jtype[D3_MAXB];
  int body_dof[D3_MAXB];
  int dof_body[D3_MAXV];
  float axis[D3_MAXB][3];      // joint axis, body frame
  float jpos[D3_MAXB][3];      // joint anchor, body frame
  float bquat[D3_MAXB][4];     // body frame quat in parent (wxyz)
  float lconst[D3_MAXB][3];    // hinge: bpos + R(bquat) jpos; else bpos
  float sdir[D3_MAXB][3];      // slide: R(bquat) axis; else 0
  float mass[D3_MAXB];
  float com[D3_MAXB][3];
  float inertia[D3_MAXB][9];   // about com, body frame, row-major
  float anc[D3_MAXB][D3_MAXV]; // 1 if dof j is on the path to body i
};

struct v3 { float x, y, z; };
struct qt { float w, x, y, z; };

__device__ __forceinline__ v3 mk3(const float* a) { return {a[0], a[1], a[2]}; }
__device__ __forceinline__ qt mk4(const float* a) { return {a[0], a[1], a[2], a[3]}; }
__device__ __forceinline__ v3 operator+(v3 a, v3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ v3 operator-(v3 a, v3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ v3 operator*(v3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(v3 a, v3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ v3 cross(v3 a, v3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ qt qmul(qt p, qt q) {
  return {p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z,
          p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y,
          p.w * q.y - p.x * q.z + p.y * q.w + p.z * q.x,
          p.w * q.z + p.x * q.y - p.y * q.x + p.z * q.w};
}

// R(q) v in the 2-cross form of ops/quat.rotate
__device__ __forceinline__ v3 qrot(qt q, v3 v) {
  v3 qv = {q.x, q.y, q.z};
  v3 t = cross(qv, v) * 2.0f;
  return v + t * q.w + cross(qv, t);
}

struct m3 { float a[3][3]; };

__device__ __forceinline__ m3 qtomat(qt q) {
  float w = q.w, x = q.x, y = q.y, z = q.z;
  m3 R;
  R.a[0][0] = 1 - 2 * (y * y + z * z); R.a[0][1] = 2 * (x * y - w * z); R.a[0][2] = 2 * (x * z + w * y);
  R.a[1][0] = 2 * (x * y + w * z); R.a[1][1] = 1 - 2 * (x * x + z * z); R.a[1][2] = 2 * (y * z - w * x);
  R.a[2][0] = 2 * (x * z - w * y); R.a[2][1] = 2 * (y * z + w * x); R.a[2][2] = 1 - 2 * (x * x + y * y);
  return R;
}

__device__ __forceinline__ v3 mvec(const m3& M, v3 v) {
  return {M.a[0][0] * v.x + M.a[0][1] * v.y + M.a[0][2] * v.z,
          M.a[1][0] * v.x + M.a[1][1] * v.y + M.a[1][2] * v.z,
          M.a[2][0] * v.x + M.a[2][1] * v.y + M.a[2][2] * v.z};
}

// R I R^T for symmetric I (dyn_scalar.rot_inertia)
__device__ __forceinline__ m3 rot_inertia(const m3& R, const float* I) {
  float A[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      A[i][j] = I[i * 3 + 0] * R.a[j][0] + I[i * 3 + 1] * R.a[j][1] + I[i * 3 + 2] * R.a[j][2];
  m3 out;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out.a[i][j] = R.a[i][0] * A[0][j] + R.a[i][1] * A[1][j] + R.a[i][2] * A[2][j];
  return out;
}

// m (|d|^2 E - d d^T), added into M
__device__ __forceinline__ void add_steiner(m3& M, float m, v3 d) {
  float dv[3] = {d.x, d.y, d.z};
  float d2 = dot(d, d);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M.a[i][j] += m * ((i == j ? d2 : 0.0f) - dv[i] * dv[j]);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// ops/quat.quat_error: wc*vd - wd*vc - vd x vc
__device__ __forceinline__ v3 quat_error_d(qt c, qt d) {
  v3 vc = {c.x, c.y, c.z}, vd = {d.x, d.y, d.z};
  return (vd * c.w - vc * d.w) - cross(vd, vc);
}

// ---------------------------------------------------------------------------
// The control chain (robot/panda.build_control_chain): panda_link0 (fixed
// root), panda_link1..7 on the hinges of dofs 0..6, then panda_link8 and
// panda_hand fixed in a row after link7, and both fingers and
// panda_grasptarget fixed to the hand.
// ---------------------------------------------------------------------------
#define CC_NB 13
#define CC_NV 7
#define CC_EE 12   // panda_grasptarget, the IK target frame

// parent of body b; body b is a hinge for 1 <= b <= CC_NV, on dof b - 1
__host__ __device__ constexpr int cc_parent(int b) { return b == 0 ? -1 : (b <= 9 ? b - 1 : 9); }

inline bool cc_matches(const ChainTab& ch) {
  if (ch.nb != CC_NB || ch.nv != CC_NV) return false;
  for (int b = 0; b < CC_NB; ++b) {
    const bool hinge = b >= 1 && b <= CC_NV;
    if (ch.parent[b] != cc_parent(b) || ch.jtype[b] != (hinge ? D3_HINGE : D3_FIXED)) return false;
    if (hinge && ch.body_dof[b] != b - 1) return false;
  }
  for (int d = 0; d < CC_NV; ++d)
    if (ch.dof_body[d] != d + 1) return false;
  return true;
}

// local transform of hinge body b at joint angle qb (dyn_scalar.fk_s); a
// fixed body's is (bquat, lconst) from the table. IEEE sincosf: K1's
// finite differences divide q by dt twice
__device__ __forceinline__ void cc_local(const ChainTab& ch, int b, float qb, qt& lq, v3& lp) {
  float s, c;
  sincosf(qb * 0.5f, &s, &c);
  const v3 ax = mk3(ch.axis[b]);
  const qt jq = {c, ax.x * s, ax.y * s, ax.z * s};
  lq = qmul(mk4(ch.bquat[b]), jq);
  lp = mk3(ch.lconst[b]) - qrot(lq, mk3(ch.jpos[b]));
}

// world pose of a body from its parent's and its local transform
__device__ __forceinline__ void cc_compose(qt pq, v3 pp, qt lq, v3 lp, qt& xq, v3& xp) {
  xq = qmul(pq, lq);
  xp = pp + qrot(pq, lp);
}

// world axis and anchor of the hinge of body b (dyn_scalar.dof_frames_s)
__device__ __forceinline__ void cc_dof_frame(const ChainTab& ch, int b, qt xq, v3 xp, v3& axis,
                                             v3& anchor) {
  axis = qrot(xq, mk3(ch.axis[b]));
  anchor = xp + qrot(xq, mk3(ch.jpos[b]));
}

// RNEA forward step (dyn_scalar._body_kinematics, gravity 0): angular
// velocity, angular acceleration and the acceleration of the body origin,
// from the parent's (origin o_p) to the body's (origin o_b)
struct cc_motion { v3 w, al, ao; };

__device__ __forceinline__ cc_motion cc_fwd_hinge(const cc_motion& p, v3 o_p, v3 o_b, v3 axis, v3 r,
                                                  float qd, float qdd) {
  cc_motion m;
  m.w = p.w + axis * qd;
  m.al = p.al + cross(p.w, axis) * qd;
  m.al = m.al + axis * qdd;
  const v3 dr = r - o_p;
  const v3 a_r = p.ao + (cross(p.al, dr) + cross(p.w, cross(p.w, dr)));
  const v3 dob = o_b - r;
  m.ao = a_r + (cross(m.al, dob) + cross(m.w, cross(m.w, dob)));
  return m;
}

__device__ __forceinline__ cc_motion cc_fwd_fixed(const cc_motion& p, v3 o_p, v3 o_b) {
  cc_motion m;
  m.w = p.w;
  m.al = p.al;
  const v3 dob = o_b - o_p;
  m.ao = p.ao + (cross(p.al, dob) + cross(p.w, cross(p.w, dob)));
  return m;
}

// RNEA backward-pass seed of body b (dyn_scalar._rnea_backward): force F
// and moment N about the body origin
__device__ __forceinline__ void cc_seed(const ChainTab& ch, int b, qt xq, v3 o_b,
                                        const cc_motion& m, v3& F, v3& N) {
  // world com - origin, formed as rnea_s forms it
  const v3 dc = (o_b + qrot(xq, mk3(ch.com[b]))) - o_b;
  const m3 Iw = rot_inertia(qtomat(xq), ch.inertia[b]);
  const v3 a_c = m.ao + (cross(m.al, dc) + cross(m.w, cross(m.w, dc)));
  const v3 f = a_c * ch.mass[b];
  const v3 n = mvec(Iw, m.al) + cross(m.w, mvec(Iw, m.w));
  F = f;
  N = n + cross(dc, f);
}

// RNEA backward step: body b's force and moment into its parent's
__device__ __forceinline__ void cc_accum(v3& Fp, v3& Np, v3 Fb, v3 Nb, v3 xb, v3 xp) {
  Fp = Fp + Fb;
  Np = Np + (Nb + cross(xb - xp, Fb));
}

// joint torque of a hinge from its body's accumulated force and moment
__device__ __forceinline__ float cc_tau(v3 axis, v3 anchor, v3 xb, v3 Fb, v3 Nb) {
  return dot(axis, Nb + cross(xb - anchor, Fb));
}

// tau = M(q) qdd + C(q, qd) qd on the control chain (dyn_scalar.fk_s +
// rnea_s with gravity 0) in one thread, every per-body quantity in
// registers. Body 0 (the fixed root) stays at rest and carries no dof, so
// its seed and the step into it are not formed
__device__ __forceinline__ void cc_feedforward(const ChainTab& ch, const float* q, const float* qd,
                                               const float* qdd, float* tau) {
  qt xq[CC_NB];
  v3 xp[CC_NB];
  xq[0] = mk4(ch.bquat[0]);
  xp[0] = mk3(ch.lconst[0]);
#pragma unroll
  for (int b = 1; b < CC_NB; ++b) {
    qt lq;
    v3 lp;
    if (b <= CC_NV) {
      cc_local(ch, b, q[b - 1], lq, lp);
    } else {
      lq = mk4(ch.bquat[b]);
      lp = mk3(ch.lconst[b]);
    }
    cc_compose(xq[cc_parent(b)], xp[cc_parent(b)], lq, lp, xq[b], xp[b]);
  }
  v3 ax[CC_NV], an[CC_NV];
#pragma unroll
  for (int d = 0; d < CC_NV; ++d) cc_dof_frame(ch, d + 1, xq[d + 1], xp[d + 1], ax[d], an[d]);
  cc_motion m[CC_NB];
  v3 F[CC_NB], N[CC_NB];
  m[0].w = m[0].al = m[0].ao = v3{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int b = 1; b < CC_NB; ++b) {
    const int p = cc_parent(b);
    if (b <= CC_NV)
      m[b] = cc_fwd_hinge(m[p], xp[p], xp[b], ax[b - 1], an[b - 1], qd[b - 1], qdd[b - 1]);
    else
      m[b] = cc_fwd_fixed(m[p], xp[p], xp[b]);
    cc_seed(ch, b, xq[b], xp[b], m[b], F[b], N[b]);
  }
#pragma unroll
  for (int b = CC_NB - 1; b > 1; --b) {
    const int p = cc_parent(b);
    cc_accum(F[p], N[p], F[b], N[b], xp[b], xp[p]);
  }
#pragma unroll
  for (int d = 0; d < CC_NV; ++d) tau[d] = cc_tau(ax[d], an[d], xp[d + 1], F[d + 1], N[d + 1]);
}
