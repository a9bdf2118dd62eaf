// Scalar robot dynamics as CUDA device functions (one env per thread).
//
// Counterpart of engine/dyn_scalar.py (and of the JAX package's
// engine/dyn_scalar.py, which folds chain constants into immediates at
// trace time). Here the chain is a small table (ChainTab) passed to the
// kernel as a __grid_constant__ parameter, so it sits in the constant bank
// and one set of device functions serves the 7-dof URDF control chain
// (ik_window, feedforward); the small helpers (quaternions, rot_inertia,
// add_steiner) also serve arm_stage, which runs the 9-dof, 17-body MJCF sim
// chain with one env per group of lanes (dyn_kernel.cu). Loops over bodies
// run to the table's nb at run time; per-body arrays are sized by the
// compile-time maxima below and live in local memory (L1-cached).
//
// The stage functions (FK, RNEA, the Cholesky pieces) are __noinline__:
// with them inlined into the one-thread-per-env arm_stage kernel of the
// first port, nvcc 12.8 at NVVM -O1 and above returned wrong bias forces
// (the caller's joint arrays were overwritten during the RNEA; the same
// code was right under -Xcicc -O0, in a host build, and with these calls
// kept out of line). ik_window and feedforward keep them so.
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

// ---------------------------------------------------------------------------
// forward kinematics (dyn_scalar.fk_s): sequential parent -> child compose
// ---------------------------------------------------------------------------
__device__ __noinline__ void fk_d(const ChainTab& ch, const float* q, v3* xpos, qt* xquat) {
  for (int b = 0; b < ch.nb; ++b) {
    qt bq = mk4(ch.bquat[b]);
    qt lq;
    v3 lp;
    int jt = ch.jtype[b];
    if (jt == D3_HINGE) {
      float s, c;
      sincosf(q[ch.body_dof[b]] * 0.5f, &s, &c);
      v3 ax = mk3(ch.axis[b]);
      qt jq = {c, ax.x * s, ax.y * s, ax.z * s};
      lq = qmul(bq, jq);
      lp = mk3(ch.lconst[b]) - qrot(lq, mk3(ch.jpos[b]));
    } else if (jt == D3_SLIDE) {
      lq = bq;
      lp = mk3(ch.lconst[b]) + mk3(ch.sdir[b]) * q[ch.body_dof[b]];
    } else {
      lq = bq;
      lp = mk3(ch.lconst[b]);
    }
    int p = ch.parent[b];
    if (p < 0) {
      xquat[b] = lq;
      xpos[b] = lp;
    } else {
      xquat[b] = qmul(xquat[p], lq);
      xpos[b] = xpos[p] + qrot(xquat[p], lp);
    }
  }
}

// world axis + anchor of every dof (dyn_scalar.dof_frames_s)
__device__ __noinline__ void dof_frames_d(const ChainTab& ch, const v3* xpos, const qt* xquat,
                             v3* axes, v3* anchors) {
  for (int d = 0; d < ch.nv; ++d) {
    int b = ch.dof_body[d];
    axes[d] = qrot(xquat[b], mk3(ch.axis[b]));
    anchors[d] = xpos[b] + qrot(xquat[b], mk3(ch.jpos[b]));
  }
}

// ---------------------------------------------------------------------------
// RNEA (dyn_scalar._body_kinematics + _rnea_backward). qdd may be null
// (zero). Forward pass: world-frame angular velocity/acceleration and the
// linear acceleration of each body origin, root acceleration -g. Backward
// pass: forces and moments about each body's own origin. Also returns the
// world COMs and inertias for CRBA when coms/Iw are non-null.
// ---------------------------------------------------------------------------
__device__ __noinline__ void rnea_d(const ChainTab& ch, const v3* xpos, const qt* xquat,
                       const v3* axes, const v3* anchors, const float* qd,
                       const float* qdd, v3 grav, float* tau, v3* coms_out,
                       m3* Iw_out) {
  v3 omega[D3_MAXB], alpha[D3_MAXB], a_o[D3_MAXB];
  v3 F[D3_MAXB], N[D3_MAXB];
  for (int b = 0; b < ch.nb; ++b) {
    int p = ch.parent[b];
    v3 w_p = {0, 0, 0}, al_p = {0, 0, 0}, ao_p = {-grav.x, -grav.y, -grav.z}, o_p = {0, 0, 0};
    if (p >= 0) {
      w_p = omega[p]; al_p = alpha[p]; ao_p = a_o[p]; o_p = xpos[p];
    }
    v3 o_b = xpos[b];
    v3 w_b, al_b, ao_b;
    int jt = ch.jtype[b];
    if (jt == D3_HINGE) {
      int d = ch.body_dof[b];
      v3 axis = qrot(xquat[b], mk3(ch.axis[b]));
      v3 r = o_b + qrot(xquat[b], mk3(ch.jpos[b]));
      w_b = w_p + axis * qd[d];
      al_b = al_p + cross(w_p, axis) * qd[d];
      if (qdd) al_b = al_b + axis * qdd[d];
      v3 dr = r - o_p;
      v3 a_r = ao_p + (cross(al_p, dr) + cross(w_p, cross(w_p, dr)));
      v3 dob = o_b - r;
      ao_b = a_r + (cross(al_b, dob) + cross(w_b, cross(w_b, dob)));
    } else if (jt == D3_SLIDE) {
      int d = ch.body_dof[b];
      v3 axis = qrot(xquat[b], mk3(ch.axis[b]));
      w_b = w_p;
      al_b = al_p;
      v3 dob = o_b - o_p;
      ao_b = ao_p + (cross(al_p, dob) + cross(w_p, cross(w_p, dob) + axis * (2.0f * qd[d])));
      if (qdd) ao_b = ao_b + axis * qdd[d];
    } else {
      w_b = w_p;
      al_b = al_p;
      v3 dob = o_b - o_p;
      ao_b = ao_p + (cross(al_p, dob) + cross(w_p, cross(w_p, dob)));
    }
    omega[b] = w_b;
    alpha[b] = al_b;
    a_o[b] = ao_b;
    v3 com = o_b + qrot(xquat[b], mk3(ch.com[b]));
    m3 Iw = rot_inertia(qtomat(xquat[b]), ch.inertia[b]);
    if (coms_out) { coms_out[b] = com; Iw_out[b] = Iw; }
    // backward-pass seeds
    v3 dc = com - o_b;
    v3 a_c = ao_b + (cross(al_b, dc) + cross(w_b, cross(w_b, dc)));
    v3 f = a_c * ch.mass[b];
    v3 n = mvec(Iw, al_b) + cross(w_b, mvec(Iw, w_b));
    F[b] = f;
    N[b] = n + cross(dc, f);
  }
  for (int b = ch.nb - 1; b > 0; --b) {
    int p = ch.parent[b];
    F[p] = F[p] + F[b];
    N[p] = N[p] + (N[b] + cross(xpos[b] - xpos[p], F[b]));
  }
  for (int d = 0; d < ch.nv; ++d) {
    int b = ch.dof_body[d];
    if (ch.jtype[b] == D3_HINGE) {
      v3 n_r = N[b] + cross(xpos[b] - anchors[d], F[b]);
      tau[d] = dot(axes[d], n_r);
    } else {
      tau[d] = dot(axes[d], F[b]);
    }
  }
}

// ---------------------------------------------------------------------------
// small SPD algebra (dyn_scalar.chol_factor_s / chol_apply_s), stride D3_MAXV
// ---------------------------------------------------------------------------
__device__ __noinline__ void chol_factor_d(const float* A, int n, float reg, float* L, float* inv_diag) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = A[j * D3_MAXV + i] + (i == j ? reg : 0.0f);
      for (int k = 0; k < j; ++k) s -= L[i * D3_MAXV + k] * L[j * D3_MAXV + k];
      if (i == j) {
        float l = sqrtf(fmaxf(s, 1e-12f));
        L[i * D3_MAXV + i] = l;
        inv_diag[i] = 1.0f / l;
      } else {
        L[i * D3_MAXV + j] = s * inv_diag[j];
      }
    }
  }
}

__device__ __noinline__ void chol_apply_d(const float* L, const float* inv_diag, const float* b,
                             int n, float* x) {
  float y[D3_MAXV];
  for (int i = 0; i < n; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * D3_MAXV + k] * y[k];
    y[i] = s * inv_diag[i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * D3_MAXV + i] * x[k];
    x[i] = s * inv_diag[i];
  }
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// ops/quat.quat_error: wc*vd - wd*vc - vd x vc
__device__ __forceinline__ v3 quat_error_d(qt c, qt d) {
  v3 vc = {c.x, c.y, c.z}, vd = {d.x, d.y, d.z};
  return (vd * c.w - vc * d.w) - cross(vd, vc);
}
