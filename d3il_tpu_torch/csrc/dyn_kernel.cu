// Arm dynamics kernels for Hopper (sm_90a): ik_window (K1), arm_stage (K2)
// and feedforward (K4).
//
// ik_window replaces the JAX package's engine/dyn_kernel.py:ik_window_bm
// (Pallas body _make_ik_window_kernel); arm_stage replaces
// engine/dyn_kernel.py:arm_stage_bm (_make_arm_kernel); feedforward replaces
// engine/dyn_kernel.py:feedforward_bm (_make_ff_kernel). The TPU kernels put
// one env per vector lane and unroll the chain into immediates; here the
// chain tables (dyn_scalar.cuh) are walked at run time, so one set of
// device functions serves both chains.
//
// Bound on this card. The least time (chip_smoke.py counts the plain
// version's operations and the bytes in and out at the main path's shapes):
//   ik_window: ~0.53 M flop per env per 35-substep window against ~3.1 KB
//     read and written (des pose + state in, 3 x 35 x 7 floats out), so FP32
//     CUDA-core operations bound it;
//   arm_stage: ~14.5 k flop per env against ~1.25 KB (q, qd, setpoints in;
//     17 body poses, 9 dof frames and the 9 x 9 inverse out), ~12 flop per
//     byte, below the card's FP32 balance of ~20: bytes bound it.
//   feedforward: one FK + one RNEA pass on the 7-dof control chain, ~6.6 k
//     flop per env against 112 B (three [7] vectors in, one out), ~59 flop
//     per byte, above the card's FP32 balance of ~20: operations bound it.
// All run far above that bound, because each env is a chain of small
// dependent steps: latency limits them, and the number of envs in flight
// that hide it.
//
// K1 and K4: one thread per env walks the chain, per-body arrays in local
// memory; batch-minor ([.., B]) layout so neighbouring threads touch
// neighbouring addresses; the 35-substep loop of ik_window runs inside the
// thread with q_virt/old_vel in registers and each substep's outputs stored
// straight to global memory.
//
// K2: one env per group of 8 lanes (16 envs per 128-thread block), the
// env's state in shared memory, so that B = 8192 puts 2,048 warps in
// flight and B = 480 120 (one thread per env would put 256 and 15).
// Only the passes that are serial by nature run on one lane: FK compose,
// the RNEA forward sweep, the RNEA backward and composite-inertia sweeps
// (interleaved), the Cholesky factor; each keeps the previous body's state
// in registers where the parent is the body before. The lanes share the
// per-body local transforms, world inertias and com offsets, the dof
// frames, the 45 CRBA entries, the 9 right-hand sides of the inverse and
// the matvecs; the block loads its envs' inputs and stores their ~270
// output floats with consecutive threads on consecutive envs. The stages
// are inlined: the miscompile noted in dyn_scalar.cuh does not show in
// this code (tests/test_torch_cuda.py::test_arm_stage_kernel_matches_plain).
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
// K2: arm stage (dyn_kernel._make_arm_kernel), one env per group of K2_G
// lanes (design in the note at the top). Per-env state lives in shared
// memory, K2_STRIDE floats per env, odd so that the envs of a warp hit
// distinct banks; the chain table is copied to shared memory once per
// block, since the lanes of a group read different bodies at once. Each
// quantity is computed in the per-thread functions' operation order
// (dyn_scalar.cuh), only distributed.
// ---------------------------------------------------------------------------
#define K2_G 8                          // lanes per env
#define K2_THREADS 128                  // threads per block
#define K2_EPB (K2_THREADS / K2_G)      // envs per block
#define K2_NV 9
// per-env shared-memory layout (floats); regions reused once dead are noted
#define K2_Q 0          // q [9]
#define K2_QD 9         // qd [9]
#define K2_QDES 18      // q_des [7]
#define K2_QDDES 25     // qd_des [7]
#define K2_TAUM 32      // tau_model [7]
#define K2_SW 39
#define K2_GF 40
#define K2_LQ 41        // local quats [17][4]; then Fj, Nj, cj; then L, 1/diag
#define K2_LP 109       // local positions [17][3]
#define K2_XQ 160       // xquat [17][4]
#define K2_XP 228       // xpos [17][3]
#define K2_AX 279       // dof axes [9][3]
#define K2_AN 306       // dof anchors [9][3]
#define K2_OM 333       // omega [17][3]; then M [9][9] (with AL, AO)
#define K2_AL 384       // alpha [17][3]; then N (RNEA moments)
#define K2_AO 435       // a_o [17][3]; then F (RNEA forces)
#define K2_COM 486      // com [17][3] -> csub; then X [9][9], Minv [9][9]
#define K2_IW 537       // world inertia [17][9] -> Isub
#define K2_MSUB 690     // composite mass [17]
#define K2_BIAS 707     // [9]
#define K2_FARM 716     // [9]
#define K2_AARM 725     // [9]
#define K2_QDPRE 734    // [9]
#define K2_RHS 743      // [9]
#define K2_STRIDE 753

__device__ __forceinline__ v3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void st3(float* p, v3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ qt ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ void st4(float* p, qt q) { p[0] = q.w; p[1] = q.x; p[2] = q.y; p[3] = q.z; }
__device__ __forceinline__ m3 ldm(const float* p) {
  m3 M;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) M.a[i][j] = p[3 * i + j];
  return M;
}
__device__ __forceinline__ void stm(float* p, const m3& M) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) p[3 * i + j] = M.a[i][j];
}

// block-wide coalesced copy between [rows, B] global arrays and the envs'
// shared-memory slots at offset off (one row per env slot entry)
__device__ __forceinline__ void k2_load(float* sm, int e0, int B, const float* __restrict__ g,
                                        int rows, int off) {
  for (int i = threadIdx.x; i < rows * K2_EPB; i += K2_THREADS) {
    int k = i / K2_EPB, el = i - k * K2_EPB, e = e0 + el;
    sm[el * K2_STRIDE + off + k] = e < B ? g[(size_t)k * B + e] : 0.0f;
  }
}
__device__ __forceinline__ void k2_store(const float* sm, int e0, int B, float* __restrict__ g,
                                         int rows, int off) {
  for (int i = threadIdx.x; i < rows * K2_EPB; i += K2_THREADS) {
    int k = i / K2_EPB, el = i - k * K2_EPB, e = e0 + el;
    if (e < B) g[(size_t)k * B + e] = sm[el * K2_STRIDE + off + k];
  }
}

__global__ void __launch_bounds__(K2_THREADS) arm_stage_kernel(
    const __grid_constant__ ChainTab chg, const __grid_constant__ ArmParams P, int B,
    const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ qdes_in, const float* __restrict__ qddes_in,
    const float* __restrict__ taum_in, const float* __restrict__ sw_in,
    const float* __restrict__ gf_in, float* __restrict__ xpos_o, float* __restrict__ xquat_o,
    float* __restrict__ axes_o, float* __restrict__ anch_o, float* __restrict__ minv_o,
    float* __restrict__ qdpre_o, float* __restrict__ aarm_o) {
  __shared__ ChainTab ch;
  extern __shared__ float k2_smem[];
  const int e0 = blockIdx.x * K2_EPB;
  const int el = threadIdx.x / K2_G, gl = threadIdx.x % K2_G;
  float* S = k2_smem + el * K2_STRIDE;
  {
    const int* src = reinterpret_cast<const int*>(&chg);
    int* dst = reinterpret_cast<int*>(&ch);
    for (int i = threadIdx.x; i < (int)(sizeof(ChainTab) / 4); i += K2_THREADS) dst[i] = src[i];
  }
  k2_load(k2_smem, e0, B, q_in, K2_NV, K2_Q);
  k2_load(k2_smem, e0, B, qd_in, K2_NV, K2_QD);
  k2_load(k2_smem, e0, B, qdes_in, 7, K2_QDES);
  k2_load(k2_smem, e0, B, qddes_in, 7, K2_QDDES);
  k2_load(k2_smem, e0, B, taum_in, 7, K2_TAUM);
  k2_load(k2_smem, e0, B, sw_in, 1, K2_SW);
  k2_load(k2_smem, e0, B, gf_in, 1, K2_GF);
  __syncthreads();
  const int nb = ch.nb;
  const float* q = S + K2_Q;
  const float* qd = S + K2_QD;

  // ---- FK, local transforms (per body; fk_d) ----
  for (int b = gl; b < nb; b += K2_G) {
    qt bq = mk4(ch.bquat[b]);
    qt lq;
    v3 lp;
    int jt = ch.jtype[b];
    if (jt == D3_HINGE) {
      // the hardware sine and cosine err by at most 2^-21.41 absolute for
      // |x| <= pi; the Panda's widest joint range (robot/panda.py,
      // JOINT_POS_MAX, 3.7525 rad at joint 6) gives half angles up to
      // 1.88 rad, so |q| may overshoot its limits by 2.5 rad and stay there
      float s, c;
      __sincosf(q[ch.body_dof[b]] * 0.5f, &s, &c);
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
    st4(S + K2_LQ + 4 * b, lq);
    st3(S + K2_LP + 3 * b, lp);
  }
  __syncwarp();
  // ---- FK, compose parent -> child (serial, lane 0). The serial sweeps
  // keep the last body's state in registers and read a parent from shared
  // memory only when it is not the body just before (a branch) ----
  if (gl == 0) {
    qt cq = {1, 0, 0, 0};
    v3 cp = {0, 0, 0};
    for (int b = 0; b < nb; ++b) {
      qt lq = ld4(S + K2_LQ + 4 * b);
      v3 lp = ld3(S + K2_LP + 3 * b);
      int p = ch.parent[b];
      if (p < 0) {
        cq = lq;
        cp = lp;
      } else {
        qt xq = p == b - 1 ? cq : ld4(S + K2_XQ + 4 * p);
        v3 xp = p == b - 1 ? cp : ld3(S + K2_XP + 3 * p);
        cq = qmul(xq, lq);
        cp = xp + qrot(xq, lp);
      }
      st4(S + K2_XQ + 4 * b, cq);
      st3(S + K2_XP + 3 * b, cp);
    }
  }
  __syncwarp();
  // ---- dof frames (per dof; dof_frames_d), world com and inertia (per
  // body; rnea_d) ----
  for (int d = gl; d < K2_NV; d += K2_G) {
    int b = ch.dof_body[d];
    qt xq = ld4(S + K2_XQ + 4 * b);
    st3(S + K2_AX + 3 * d, qrot(xq, mk3(ch.axis[b])));
    st3(S + K2_AN + 3 * d, ld3(S + K2_XP + 3 * b) + qrot(xq, mk3(ch.jpos[b])));
  }
  for (int b = gl; b < nb; b += K2_G) {
    qt xq = ld4(S + K2_XQ + 4 * b);
    st3(S + K2_COM + 3 * b, ld3(S + K2_XP + 3 * b) + qrot(xq, mk3(ch.com[b])));
    stm(S + K2_IW + 9 * b, rot_inertia(qtomat(xq), ch.inertia[b]));
  }
  __syncwarp();
  // ---- RNEA forward sweep (serial, lane 0; rnea_d with qdd = 0) ----
  if (gl == 0) {
    const v3 grav = {P.grav[0], P.grav[1], P.grav[2]};
    v3 cw = {0, 0, 0}, cal = {0, 0, 0}, cao = {0, 0, 0}, co = {0, 0, 0};
    for (int b = 0; b < nb; ++b) {
      int p = ch.parent[b];
      v3 w_p = {0, 0, 0}, al_p = {0, 0, 0}, ao_p = {-grav.x, -grav.y, -grav.z}, o_p = {0, 0, 0};
      if (p >= 0 && p == b - 1) {
        w_p = cw; al_p = cal; ao_p = cao; o_p = co;
      } else if (p >= 0) {
        w_p = ld3(S + K2_OM + 3 * p); al_p = ld3(S + K2_AL + 3 * p);
        ao_p = ld3(S + K2_AO + 3 * p); o_p = ld3(S + K2_XP + 3 * p);
      }
      v3 o_b = ld3(S + K2_XP + 3 * b);
      v3 w_b, al_b, ao_b;
      int jt = ch.jtype[b];
      if (jt == D3_HINGE) {
        int d = ch.body_dof[b];
        v3 axis = ld3(S + K2_AX + 3 * d);
        v3 r = ld3(S + K2_AN + 3 * d);
        w_b = w_p + axis * qd[d];
        al_b = al_p + cross(w_p, axis) * qd[d];
        v3 dr = r - o_p;
        v3 a_r = ao_p + (cross(al_p, dr) + cross(w_p, cross(w_p, dr)));
        v3 dob = o_b - r;
        ao_b = a_r + (cross(al_b, dob) + cross(w_b, cross(w_b, dob)));
      } else if (jt == D3_SLIDE) {
        int d = ch.body_dof[b];
        v3 axis = ld3(S + K2_AX + 3 * d);
        w_b = w_p;
        al_b = al_p;
        v3 dob = o_b - o_p;
        ao_b = ao_p + (cross(al_p, dob) + cross(w_p, cross(w_p, dob) + axis * (2.0f * qd[d])));
      } else {
        w_b = w_p;
        al_b = al_p;
        v3 dob = o_b - o_p;
        ao_b = ao_p + (cross(al_p, dob) + cross(w_p, cross(w_p, dob)));
      }
      st3(S + K2_OM + 3 * b, w_b);
      st3(S + K2_AL + 3 * b, al_b);
      st3(S + K2_AO + 3 * b, ao_b);
      cw = w_b; cal = al_b; cao = ao_b; co = o_b;
    }
  }
  __syncwarp();
  // ---- RNEA backward-pass seeds (per body): F over a_o, N over alpha ----
  for (int b = gl; b < nb; b += K2_G) {
    v3 o_b = ld3(S + K2_XP + 3 * b), w_b = ld3(S + K2_OM + 3 * b);
    v3 al_b = ld3(S + K2_AL + 3 * b), ao_b = ld3(S + K2_AO + 3 * b);
    m3 Iw = ldm(S + K2_IW + 9 * b);
    v3 dc = ld3(S + K2_COM + 3 * b) - o_b;
    v3 a_c = ao_b + (cross(al_b, dc) + cross(w_b, cross(w_b, dc)));
    v3 f = a_c * ch.mass[b];
    v3 n = mvec(Iw, al_b) + cross(w_b, mvec(Iw, w_b));
    st3(S + K2_AO + 3 * b, f);
    st3(S + K2_AL + 3 * b, n + cross(dc, f));
  }
  __syncwarp();
  // ---- RNEA backward sweep and the CRBA composite-inertia sweep (crba_d),
  // interleaved in one loop on lane 0: two independent serial chains (on
  // two lanes of one warp they would run one after the other). Children
  // have larger indices than parents, so when body b - 1 is b's parent, b
  // is the last of its children visited and the parent's sums are final:
  // they are carried in registers to the next step ----
  if (gl == 0) {
    float* msub = S + K2_MSUB;
    for (int b = 0; b < nb; ++b) msub[b] = ch.mass[b];
    v3 cF = {0, 0, 0}, cN = {0, 0, 0}, cc = {0, 0, 0};
    float cm = 0.0f;
    m3 cI;
    bool carry = false, ccarry = false;
    for (int b = nb - 1; b >= 0; --b) {
      const int p = ch.parent[b];
      const bool have = carry, chave = ccarry;
      carry = ccarry = false;
      if (p < 0) continue;
      // RNEA: F[p] += F[b]; N[p] += N[b] + (x_b - x_p) x F[b]
      v3 Fb = have ? cF : ld3(S + K2_AO + 3 * b);
      v3 Nb = have ? cN : ld3(S + K2_AL + 3 * b);
      v3 Fp = ld3(S + K2_AO + 3 * p) + Fb;
      v3 Np = ld3(S + K2_AL + 3 * p)
              + (Nb + cross(ld3(S + K2_XP + 3 * b) - ld3(S + K2_XP + 3 * p), Fb));
      st3(S + K2_AO + 3 * p, Fp);
      st3(S + K2_AL + 3 * p, Np);
      carry = p == b - 1;
      cF = Fp; cN = Np;
      // CRBA: merge body b's composite into its parent's
      float m2 = chave ? cm : msub[b];
      if (m2 == 0.0f) continue;
      float m1 = msub[p];
      v3 cb = chave ? cc : ld3(S + K2_COM + 3 * b);
      m3 Ib = chave ? cI : ldm(S + K2_IW + 9 * b);
      if (m1 == 0.0f) {
        msub[p] = m2;
        st3(S + K2_COM + 3 * p, cb);
        stm(S + K2_IW + 9 * p, Ib);
        cm = m2; cc = cb; cI = Ib;
        ccarry = p == b - 1;
        continue;
      }
      float m = m1 + m2;
      v3 cp = ld3(S + K2_COM + 3 * p);
      v3 c = (cp * m1 + cb * m2) * (1.0f / m);
      m3 Ip = ldm(S + K2_IW + 9 * p);
      add_steiner(Ip, m1, cp - c);
      add_steiner(Ib, m2, cb - c);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Ip.a[i][j] += Ib.a[i][j];
      msub[p] = m;
      st3(S + K2_COM + 3 * p, c);
      stm(S + K2_IW + 9 * p, Ip);
      cm = m; cc = c; cI = Ip;
      ccarry = p == b - 1;
    }
  }
  __syncwarp();
  // ---- per dof: bias forces (rnea_d) and the CRBA force/moment columns
  // Fj, Nj, cj (crba_d) into the local-transform region ----
  float* Fj = S + K2_LQ;
  float* Nj = Fj + 27;
  float* cj = Nj + 27;
  for (int d = gl; d < K2_NV; d += K2_G) {
    int b = ch.dof_body[d];
    v3 ax = ld3(S + K2_AX + 3 * d), an = ld3(S + K2_AN + 3 * d);
    v3 Fb = ld3(S + K2_AO + 3 * b);
    if (ch.jtype[b] == D3_HINGE) {
      v3 n_r = ld3(S + K2_AL + 3 * b) + cross(ld3(S + K2_XP + 3 * b) - an, Fb);
      S[K2_BIAS + d] = dot(ax, n_r);
    } else {
      S[K2_BIAS + d] = dot(ax, Fb);
    }
    v3 csub = ld3(S + K2_COM + 3 * b);
    float ms = S[K2_MSUB + b];
    if (ch.jtype[b] == D3_HINGE) {
      st3(Fj + 3 * d, cross(ax, csub - an) * ms);
      st3(Nj + 3 * d, mvec(ldm(S + K2_IW + 9 * b), ax));
    } else {
      st3(Fj + 3 * d, ax * ms);
      st3(Nj + 3 * d, v3{0, 0, 0});
    }
    st3(cj + 3 * d, csub);
  }
  __syncwarp();
  // ---- the 45 CRBA entries (over the group) into M [9][9]; control law
  // and f_arm = clamp(ctrl) - bias (per dof) ----
  float* M = S + K2_OM;
  for (int pi = gl; pi < K2_NV * (K2_NV + 1) / 2; pi += K2_G) {
    int j = 0;
    while ((j + 1) * (j + 2) / 2 <= pi) ++j;
    int i = pi - j * (j + 1) / 2;  // i <= j
    int bj = ch.dof_body[j];
    float v = 0.0f;
    if (ch.anc[bj][i] > 0.0f) {
      int bi = ch.dof_body[i];
      v3 axi = ld3(S + K2_AX + 3 * i);
      if (ch.jtype[bi] == D3_HINGE)
        v = dot(axi, ld3(Nj + 3 * j) + cross(ld3(cj + 3 * j) - ld3(S + K2_AN + 3 * i),
                                           ld3(Fj + 3 * j)));
      else
        v = dot(axi, ld3(Fj + 3 * j));
    }
    M[i * K2_NV + j] = v;
    M[j * K2_NV + i] = v;
  }
  for (int i = gl; i < K2_NV; i += K2_G) {
    float ctrl;
    if (i < 7) {
      ctrl = P.pg[i] * (S[K2_QDES + i] - q[i]) + P.dg[i] * (S[K2_QDDES + i] - qd[i])
             + S[K2_TAUM + i] + S[K2_BIAS + i];
    } else {  // finger force law (control/gripper.finger_forces)
      const float PG = 500.0f, DG = 10.0f;
      float sw = S[K2_SW], gf = S[K2_GF];
      float mean_pos = 0.5f * (q[7] + q[8]);
      bool wide = (mean_pos - sw) > 0.005f;
      float force = PG * (mean_pos - q[i]);
      float brake = 200.0f * fmaxf(-(qd[i] + 0.2f), 0.0f);
      float grasp = fminf(-20.0f + brake, 0.0f);
      float close_servo = DG * (-0.2f - qd[i]);
      float pd = clampf(PG * (sw - q[i]) - DG * qd[i], -5.0f, 5.0f);
      ctrl = force + (wide ? (gf > 0.5f ? grasp : close_servo) : pd);
    }
    S[K2_FARM + i] = clampf(ctrl, P.frange[i][0], P.frange[i][1]) - S[K2_BIAS + i];
  }
  __syncwarp();
  // ---- Cholesky factor of M + h D (serial, lane 0, in registers;
  // chol_factor_d) ----
  float* L = S + K2_LQ;
  float* inv_diag = L + K2_NV * K2_NV;
  if (gl == 0) {
    float Lr[K2_NV][K2_NV], id[K2_NV];
#pragma unroll
    for (int i = 0; i < K2_NV; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = (M[j * K2_NV + i] + (i == j ? P.h * P.damping[i] : 0.0f)) + 0.0f;
#pragma unroll
        for (int k = 0; k < j; ++k) s -= Lr[i][k] * Lr[j][k];
        if (i == j) {
          float l = sqrtf(fmaxf(s, 1e-12f));
          Lr[i][i] = l;
          id[i] = 1.0f / l;
        } else {
          Lr[i][j] = s * id[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < K2_NV; ++i) {
      inv_diag[i] = id[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i * K2_NV + j] = Lr[i][j];
    }
  }
  __syncwarp();
  // ---- the 9 unit right-hand sides (over the group; chol_apply_d) ----
  float* X = S + K2_COM;  // column j at X[j * 9 + i]
  float* Minv = X + K2_NV * K2_NV;
  for (int j = gl; j < K2_NV; j += K2_G) {
    float y[K2_NV], x[K2_NV];
#pragma unroll
    for (int i = 0; i < K2_NV; ++i) {
      float s = i == j ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i * K2_NV + k] * y[k];
      y[i] = s * inv_diag[i];
    }
#pragma unroll
    for (int i = K2_NV - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < K2_NV; ++k) s -= L[k * K2_NV + i] * x[k];
      x[i] = s * inv_diag[i];
    }
#pragma unroll
    for (int i = 0; i < K2_NV; ++i) X[j * K2_NV + i] = x[i];
  }
  __syncwarp();
  // ---- symmetrized inverse, a_arm = Minv f_arm, M qd (per row) ----
  for (int i = gl; i < K2_NV; i += K2_G) {
    for (int j = 0; j < K2_NV; ++j)
      Minv[i * K2_NV + j] = 0.5f * (i <= j ? X[j * K2_NV + i] + X[i * K2_NV + j]
                                           : X[i * K2_NV + j] + X[j * K2_NV + i]);
    float mq = 0.0f;
    for (int j = 0; j < K2_NV; ++j) mq += M[i * K2_NV + j] * qd[j];
    S[K2_RHS + i] = mq + P.h * S[K2_FARM + i];
  }
  __syncwarp();
  for (int i = gl; i < K2_NV; i += K2_G) {
    float a = 0.0f, v = 0.0f;
    for (int j = 0; j < K2_NV; ++j) a += Minv[i * K2_NV + j] * S[K2_FARM + j];
    for (int j = 0; j < K2_NV; ++j) v += Minv[i * K2_NV + j] * S[K2_RHS + j];
    S[K2_AARM + i] = a;
    S[K2_QDPRE + i] = v;
  }
  __syncthreads();
  k2_store(k2_smem, e0, B, xpos_o, 3 * nb, K2_XP);
  k2_store(k2_smem, e0, B, xquat_o, 4 * nb, K2_XQ);
  k2_store(k2_smem, e0, B, axes_o, 3 * K2_NV, K2_AX);
  k2_store(k2_smem, e0, B, anch_o, 3 * K2_NV, K2_AN);
  k2_store(k2_smem, e0, B, minv_o, K2_NV * K2_NV, K2_COM + K2_NV * K2_NV);
  k2_store(k2_smem, e0, B, qdpre_o, K2_NV, K2_QDPRE);
  k2_store(k2_smem, e0, B, aarm_o, K2_NV, K2_AARM);
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
// K4: control-model feedforward (dyn_kernel._make_ff_kernel):
// tau = M(q) qdd + C(q, qd) on the control chain, one FK + one RNEA pass with
// g = 0. The same device functions K1 runs at the end of each substep.
// ---------------------------------------------------------------------------
__global__ void ff_kernel(const __grid_constant__ ChainTab ch, int B,
                          const float* __restrict__ q_in, const float* __restrict__ qd_in,
                          const float* __restrict__ qdd_in, float* __restrict__ tau_o) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int nv = ch.nv;
  float q[D3_MAXV], qd[D3_MAXV], qdd[D3_MAXV], tau[D3_MAXV];
  for (int d = 0; d < nv; ++d) {
    size_t o = (size_t)d * B + e;
    q[d] = q_in[o];
    qd[d] = qd_in[o];
    qdd[d] = qdd_in[o];
  }
  v3 xpos[D3_MAXB], axes[D3_MAXV], anchors[D3_MAXV];
  qt xquat[D3_MAXB];
  const v3 zero = {0.0f, 0.0f, 0.0f};
  fk_d(ch, q, xpos, xquat);
  dof_frames_d(ch, xpos, xquat, axes, anchors);
  rnea_d(ch, xpos, xquat, axes, anchors, qd, qdd, zero, tau, nullptr, nullptr);
  for (int d = 0; d < nv; ++d) tau_o[(size_t)d * B + e] = tau[d];
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
  if (ch->nv != K2_NV || ch->nb > D3_MAXB) return (int)cudaErrorInvalidValue;
  int blocks = (B + K2_EPB - 1) / K2_EPB;
  size_t bytes = (size_t)K2_STRIDE * K2_EPB * sizeof(float);
  // with the block's static copy of the chain table the block needs more
  // than the 48 KB a launch gets without asking
  cudaError_t err = cudaFuncSetAttribute(
      arm_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  arm_stage_kernel<<<blocks, K2_THREADS, bytes, (cudaStream_t)stream>>>(
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

extern "C" int d3il_feedforward(const ChainTab* ch, int B, const float* q, const float* qd,
                                const float* qdd, float* tau, void* stream) {
  if (ch->nv > D3_MAXV || ch->nb > D3_MAXB) return (int)cudaErrorInvalidValue;
  int blocks = (B + kThreads - 1) / kThreads;
  ff_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*ch, B, q, qd, qdd, tau);
  return (int)cudaGetLastError();
}

extern "C" int d3il_struct_sizes(int* out) {
  out[0] = (int)sizeof(ChainTab);
  out[1] = (int)sizeof(ArmParams);
  out[2] = (int)sizeof(CartParams);
  return 0;
}
