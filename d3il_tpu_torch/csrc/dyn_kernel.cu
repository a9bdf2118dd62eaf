// Arm dynamics kernels for Hopper (sm_90a): ik_window (K1), arm_stage (K2)
// and feedforward (K4).
//
// ik_window replaces the JAX package's engine/dyn_kernel.py:ik_window_bm
// (Pallas body _make_ik_window_kernel); arm_stage replaces
// engine/dyn_kernel.py:arm_stage_bm (_make_arm_kernel); feedforward replaces
// engine/dyn_kernel.py:feedforward_bm (_make_ff_kernel). The TPU kernels put
// one env per vector lane and unroll the chain into immediates. Here a
// chain's numbers are a table (dyn_scalar.cuh); arm_stage walks the sim
// chain's table at run time, ik_window and feedforward run the control
// chain's per-body steps with its structure fixed at compile time.
//
// Bound on this card. The least time (chip_smoke.py counts the plain
// version's operations and the bytes in and out at the main path's shapes):
//   ik_window: ~0.46 M flop per env per 35-substep window (the plain
//     version's ~0.53 M less what it forms twice or never reads: the FK and
//     dof frames of q_virt after the first substep, the gate's pose error,
//     the fingers in the IK's FK) against ~3.1 KB read and written (des pose
//     + state in, 3 x 35 x 7 floats out), so FP32 CUDA-core operations bound
//     it;
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
// are inlined.
//
// K1: the first design ran one thread per env, 64 per block, so B = 8192
// put two warps on each SM and B = 480 eight blocks on 8 SMs, and its
// per-thread FK, RNEA and Cholesky functions were out of line, walking the
// table into local memory (a 2,880 B frame). Now one env per group of G
// lanes (4 from B = 4096 up, as at the env path's 8192; a whole warp below,
// as at the evaluation path's 480 and the set-up launch's one env), the
// env's state in shared memory for the whole window, the control
// chain's structure fixed at compile time. One lane runs what is serial by
// nature, with the body chain in registers: the FK compose, the pose error,
// the 6 x 6 Cholesky with its two solves and the joint step's norm, the
// RNEA's FK, dof frames and sweeps. The group shares the 7 hinges' local
// transforms (sincosf), the IK's dof frames and the 42 entries of J, the 21
// entries of J W J^T and 6 right-hand sides, the clamped update, the
// per-body seeds and the 7 torques. The substep's last FK (for the RNEA) is
// the next substep's fk(q_virt), so a substep composes the chain three
// times, not four; the IK's FK skips the two fingers, which only the RNEA
// needs. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 0.56 ms at B = 8192 (4 lanes), 0.39 ms at 480 (32), 39 ms for the one-env,
// 4000-update set-up launch (32), against 1.55, 1.55 and 174 ms for the
// first design and bounds of 0.056 and 0.0033 ms. The serial lane's
// instruction stream bounds it: at B = 8192 it runs at about one isolated
// env's latency. ptxas: 64 registers, no stack, no spills at 4 lanes; at
// 32 lanes 56 registers and a 32 B frame. That frame is the 7-word array of
// sincosf's slow path (Payne-Hanek reduction, taken only beyond ~1e5 rad,
// never by a joint angle). The PTX of K4 and of both K1 instances holds it
// as a 28 B local depot; ptxas takes it out of local memory in K4 and the
// 4-lane instance (0 B stack) and leaves it in the 32-lane one, whose only
// local loads and stores in the SASS are at that sincosf (cc_local).
//
// K4: one thread per column of the [7, B] inputs (B = 35 x 8192 when the
// window is folded into the batch, so warps are plentiful); the first
// design ran K1's out-of-line functions with a 1,872 B local frame. Now the
// whole pass is unrolled over the compile-time chain (cc_feedforward), the
// per-body state in registers and the table in the constant bank. It runs
// the per-body steps that K1's RNEA tail runs, in the same order, so the
// two agree to rounding. Measured: 0.060 ms at [7, 35 x 8192] against a
// bound of 0.028 ms (first design 0.32 ms); 231 registers, no stack, no
// spills, so two 128-thread blocks per SM (a register cap for more blocks
// spilled and ran slower).
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
// quantity is computed in the plain version's operation order
// (engine/dyn_scalar.py), only distributed.
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

// copy of a table into shared memory by the whole block, word by word
__device__ __forceinline__ void copy_words(void* dst, const void* src, size_t bytes, int threads) {
  const int* from = reinterpret_cast<const int*>(src);
  int* to = reinterpret_cast<int*>(dst);
  for (int i = threadIdx.x; i < (int)(bytes / 4); i += threads) to[i] = from[i];
}

// block-wide coalesced copy between [rows, B] global arrays and the block's
// envs' shared-memory slots (EPB envs of STRIDE floats) at offset off
template <int THREADS, int EPB, int STRIDE>
__device__ __forceinline__ void load_rows(float* sm, int e0, int B, const float* __restrict__ g,
                                          int rows, int off) {
  for (int i = threadIdx.x; i < rows * EPB; i += THREADS) {
    int k = i / EPB, el = i - k * EPB, e = e0 + el;
    sm[el * STRIDE + off + k] = e < B ? g[(size_t)k * B + e] : 0.0f;
  }
}
template <int THREADS, int EPB, int STRIDE>
__device__ __forceinline__ void store_rows(const float* sm, int e0, int B, float* __restrict__ g,
                                           int rows, int off) {
  for (int i = threadIdx.x; i < rows * EPB; i += THREADS) {
    int k = i / EPB, el = i - k * EPB, e = e0 + el;
    if (e < B) g[(size_t)k * B + e] = sm[el * STRIDE + off + k];
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
  copy_words(&ch, &chg, sizeof(ChainTab), K2_THREADS);
  auto load = [&](const float* g, int rows, int off) {
    load_rows<K2_THREADS, K2_EPB, K2_STRIDE>(k2_smem, e0, B, g, rows, off);
  };
  auto store = [&](float* g, int rows, int off) {
    store_rows<K2_THREADS, K2_EPB, K2_STRIDE>(k2_smem, e0, B, g, rows, off);
  };
  load(q_in, K2_NV, K2_Q);
  load(qd_in, K2_NV, K2_QD);
  load(qdes_in, 7, K2_QDES);
  load(qddes_in, 7, K2_QDDES);
  load(taum_in, 7, K2_TAUM);
  load(sw_in, 1, K2_SW);
  load(gf_in, 1, K2_GF);
  __syncthreads();
  const int nb = ch.nb;
  const float* q = S + K2_Q;
  const float* qd = S + K2_QD;

  // ---- FK, local transforms (per body; dyn_scalar.fk_s) ----
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
  // ---- dof frames (per dof; dof_frames_s), world com and inertia (per
  // body; rnea_s) ----
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
  // ---- RNEA forward sweep (serial, lane 0; rnea_s with qdd = 0) ----
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
  // ---- RNEA backward sweep and the CRBA composite-inertia sweep (crba_s),
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
  // ---- per dof: bias forces (rnea_s) and the CRBA force/moment columns
  // Fj, Nj, cj (crba_s) into the local-transform region ----
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
  // chol_factor_s) ----
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
  // ---- the 9 unit right-hand sides (over the group; chol_apply_s) ----
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
  store(xpos_o, 3 * nb, K2_XP);
  store(xquat_o, 4 * nb, K2_XQ);
  store(axes_o, 3 * K2_NV, K2_AX);
  store(anch_o, 3 * K2_NV, K2_AN);
  store(minv_o, K2_NV * K2_NV, K2_COM + K2_NV * K2_NV);
  store(qdpre_o, K2_NV, K2_QDPRE);
  store(aarm_o, K2_NV, K2_AARM);
}

// ---------------------------------------------------------------------------
// K1: IK window (dyn_kernel._make_ik_window_kernel): n_sub cartesian DLS-IK
// updates (dyn_scalar.cart_step_s) + the RNEA feedforward on the control
// chain with g = 0, one env per group of G lanes (4 or 32: the wrapper
// picks G from B, engine/dyn_kernel.py:ik_window_geometry). The
// env's state lives in shared memory for the whole window, K1_STRIDE floats
// per env (odd, so the envs of a warp hit distinct banks); the chain table
// and the gains are copied to shared memory once per block, since the
// lanes of a group read different bodies and dofs at once. Each quantity is computed
// in the plain version's operation order, only distributed; division and
// square root stay IEEE (the finite differences divide by dt twice).
// ---------------------------------------------------------------------------
#define K1_THREADS 128
// per-env shared-memory layout (floats)
#define K1_QV 0       // q_virt [7]
#define K1_OV 7       // old_vel [7]
#define K1_DP 14      // des_pos [3]
#define K1_DQ 17      // des_quat, normalized [4]
#define K1_DQI 21     // des_quat with the sign the IK iterations carry [4]
#define K1_Q 25       // q of the IK iterations [7]
#define K1_TGT 32     // target [6]
#define K1_CONV 38    // convergence gate of the substep
#define K1_QD 39      // qd_des [7]
#define K1_QDD 46     // qdd_des [7]
#define K1_XQ 53      // xquat [13][4]
#define K1_XP 105     // xpos [13][3]
#define K1_AX 144     // dof axes [7][3]
#define K1_AN 165     // dof anchors [7][3]
#define K1_LQ 186     // hinge local quats [7][4]
#define K1_LP 214     // hinge local positions [7][3]
#define K1_J 235      // J [6][7]
#define K1_QN 277     // qd_null [7]
#define K1_A 284      // J W J^T + reg, upper triangle of [6][6]
#define K1_RHS 320    // [6]
#define K1_STEP 326   // the iteration's joint step [7]
#define K1_SCALE 333  // its norm's clamp factor
#define K1_STRIDE 335
// the RNEA tail reuses LQ..STEP once its FK has read LQ, LP: omega, alpha
// (then the moments N), a_o (then the forces F), each [13][3]
#define K1_OM K1_LQ
#define K1_AL (K1_LQ + 39)
#define K1_AO (K1_LQ + 78)

// f(k) for k = gl, gl + G, ... < N: a group's lane gl takes every G-th item;
// the rounds are unrolled so that a lane's items interleave
template <int G, int N, class F>
__device__ __forceinline__ void k1_each(int gl, F f) {
#pragma unroll
  for (int r = 0; r < (N + G - 1) / G; ++r)
    if (gl + r * G < N) f(gl + r * G);
}

// local transform of hinge body d + 1 at angle qd_ into LQ, LP
__device__ __forceinline__ void k1_local(const ChainTab& ch, float* S, int d, float qd_) {
  qt lq;
  v3 lp;
  cc_local(ch, d + 1, qd_, lq, lp);
  st4(S + K1_LQ + 4 * d, lq);
  st3(S + K1_LP + 3 * d, lp);
}

// FK compose (serial, one lane, poses in registers) into XQ, XP. Without
// ALL the fingers are skipped: they are not on the path to the grasp target
// and only the RNEA needs them
template <bool ALL>
__device__ __forceinline__ void k1_compose(const ChainTab& ch, float* S) {
  qt xq[CC_NB];
  v3 xp[CC_NB];
  xq[0] = mk4(ch.bquat[0]);
  xp[0] = mk3(ch.lconst[0]);
  st4(S + K1_XQ, xq[0]);
  st3(S + K1_XP, xp[0]);
#pragma unroll
  for (int b = 1; b < CC_NB; ++b) {
    if (!ALL && (b == 10 || b == 11)) continue;
    const bool hinge = b <= CC_NV;
    const qt lq = hinge ? ld4(S + K1_LQ + 4 * (b - 1)) : mk4(ch.bquat[b]);
    const v3 lp = hinge ? ld3(S + K1_LP + 3 * (b - 1)) : mk3(ch.lconst[b]);
    cc_compose(xq[cc_parent(b)], xp[cc_parent(b)], lq, lp, xq[b], xp[b]);
    st4(S + K1_XQ + 4 * b, xq[b]);
    st3(S + K1_XP + 3 * b, xp[b]);
  }
}

// pose error of the grasp target and the target twist (one lane); on the
// substep's first iteration also the convergence gate, which
// cartesian_step forms from the same fk(q_virt), des_quat and sign
__device__ __forceinline__ void k1_target(const CartParams& C, float* S, bool first) {
  const qt cq = ld4(S + K1_XQ + 4 * CC_EE);
  const v3 cp = ld3(S + K1_XP + 3 * CC_EE);
  const qt dq = ld4(S + (first ? K1_DQ : K1_DQI));
  const float dm = (cq.w - dq.w) * (cq.w - dq.w) + (cq.x - dq.x) * (cq.x - dq.x)
                   + (cq.y - dq.y) * (cq.y - dq.y) + (cq.z - dq.z) * (cq.z - dq.z);
  const float dp = (cq.w + dq.w) * (cq.w + dq.w) + (cq.x + dq.x) * (cq.x + dq.x)
                   + (cq.y + dq.y) * (cq.y + dq.y) + (cq.z + dq.z) * (cq.z + dq.z);
  const float flip = dm > dp ? -1.0f : 1.0f;
  const qt dq2 = {dq.w * flip, dq.x * flip, dq.y * flip, dq.z * flip};
  st4(S + K1_DQI, dq2);
  const v3 pe = ld3(S + K1_DP) - cp;
  const v3 qe = quat_error_d(cq, dq2);
  S[K1_TGT + 0] = C.pgain[0] * clampf(pe.x, -0.01f, 0.01f);
  S[K1_TGT + 1] = C.pgain[1] * clampf(pe.y, -0.01f, 0.01f);
  S[K1_TGT + 2] = C.pgain[2] * clampf(pe.z, -0.01f, 0.01f);
  S[K1_TGT + 3] = C.pgain[3] * clampf(qe.x, -0.1f, 0.1f);
  S[K1_TGT + 4] = C.pgain[4] * clampf(qe.y, -0.1f, 0.1f);
  S[K1_TGT + 5] = C.pgain[5] * clampf(qe.z, -0.1f, 0.1f);
  if (first)
    S[K1_CONV] = (sqrtf(dot(pe, pe)) < 5e-4f) && (sqrtf(dot(qe, qe)) < 5e-3f) ? 1.0f : 0.0f;
}

// L L^T x = b given the factor and its inverse diagonal
// (dyn_scalar.chol_apply_s)
__device__ __forceinline__ void k1_chol_apply(const float (&L)[6][6], const float (&id)[6],
                                              const float (&b)[6], float (&x)[6]) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * id[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * id[i];
  }
}

// the clamped SPD solve (ops/linalg.clamped_spd_solve;
// dyn_scalar.chol_factor_s): Tikhonov + one refinement step through one
// factorization, then the joint step W J^T y + qd_null per dof and the
// clamp factor of its norm (cart_step_s); serial on one lane, the factor
// and y in registers
__device__ __forceinline__ void k1_solve(const CartParams& C, float* S) {
  const float* A = S + K1_A;
  float L[6][6], id[6], rhs[6], x0[6], x1[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    rhs[i] = S[K1_RHS + i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[j * 6 + i] + (i == j ? C.svd_lo : 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrtf(fmaxf(s, 1e-12f));
        id[i] = 1.0f / L[i][i];
      } else {
        L[i][j] = s * id[j];
      }
    }
  }
  k1_chol_apply(L, id, rhs, x0);
  k1_chol_apply(L, id, x0, x1);
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i] = x0[i] + C.svd_lo * x1[i];
  const float* J = S + K1_J;
  float nrm2 = 0.0f;
#pragma unroll
  for (int d = 0; d < CC_NV; ++d) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) s += J[i * 7 + d] * y[i];
    const float step = C.W[d] * s + S[K1_QN + d];
    S[K1_STEP + d] = step;
    nrm2 += step * step;
  }
  const float nrm = sqrtf(nrm2);
  S[K1_SCALE] = nrm > 3.0f ? 3.0f / fmaxf(nrm, 1e-9f) : 1.0f;
}

// the RNEA's FK compose, dof frames and forward sweep (cc_fwd_*) in one pass
// on one lane, poses and motion in registers. The hinges' local transforms
// are read first: omega and alpha are stored over them
__device__ __forceinline__ void k1_rnea_forward(const ChainTab& ch, float* S) {
  qt lq[CC_NV];
  v3 lp[CC_NV];
#pragma unroll
  for (int d = 0; d < CC_NV; ++d) {
    lq[d] = ld4(S + K1_LQ + 4 * d);
    lp[d] = ld3(S + K1_LP + 3 * d);
  }
  qt xq[CC_NB];
  v3 xp[CC_NB];
  cc_motion m[CC_NB];
  xq[0] = mk4(ch.bquat[0]);
  xp[0] = mk3(ch.lconst[0]);
  st4(S + K1_XQ, xq[0]);
  st3(S + K1_XP, xp[0]);
  m[0].w = m[0].al = m[0].ao = v3{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int b = 1; b < CC_NB; ++b) {
    const int p = cc_parent(b);
    if (b <= CC_NV) {
      cc_compose(xq[p], xp[p], lq[b - 1], lp[b - 1], xq[b], xp[b]);
      v3 ax, an;
      cc_dof_frame(ch, b, xq[b], xp[b], ax, an);
      st3(S + K1_AX + 3 * (b - 1), ax);
      st3(S + K1_AN + 3 * (b - 1), an);
      m[b] = cc_fwd_hinge(m[p], xp[p], xp[b], ax, an, S[K1_QD + b - 1], S[K1_QDD + b - 1]);
    } else {
      cc_compose(xq[p], xp[p], mk4(ch.bquat[b]), mk3(ch.lconst[b]), xq[b], xp[b]);
      m[b] = cc_fwd_fixed(m[p], xp[p], xp[b]);
    }
    st4(S + K1_XQ + 4 * b, xq[b]);
    st3(S + K1_XP + 3 * b, xp[b]);
    st3(S + K1_OM + 3 * b, m[b].w);
    st3(S + K1_AL + 3 * b, m[b].al);
    st3(S + K1_AO + 3 * b, m[b].ao);
  }
}

// RNEA backward sweep (serial, one lane; cc_accum): the seeds F (over a_o)
// and N (over alpha) summed into the parents in registers; the hinge
// bodies' totals are stored back for the joint torques
__device__ __forceinline__ void k1_rnea_backward(float* S) {
  v3 F[CC_NB], N[CC_NB];
#pragma unroll
  for (int b = 1; b < CC_NB; ++b) {
    F[b] = ld3(S + K1_AO + 3 * b);
    N[b] = ld3(S + K1_AL + 3 * b);
  }
#pragma unroll
  for (int b = CC_NB - 1; b > 1; --b)
    cc_accum(F[cc_parent(b)], N[cc_parent(b)], F[b], N[b], ld3(S + K1_XP + 3 * b),
             ld3(S + K1_XP + 3 * cc_parent(b)));
#pragma unroll
  for (int b = 1; b <= CC_NV; ++b) {
    st3(S + K1_AO + 3 * b, F[b]);
    st3(S + K1_AL + 3 * b, N[b]);
  }
}

template <int G>
__global__ void __launch_bounds__(K1_THREADS) ik_window_kernel(
    const __grid_constant__ ChainTab chg, const __grid_constant__ CartParams Cg, int B, int n_sub,
    const float* __restrict__ qv_in, const float* __restrict__ ov_in,
    const float* __restrict__ dp_in, const float* __restrict__ dq_in, float* __restrict__ qv_o,
    float* __restrict__ ov_o, float* __restrict__ qdes_o, float* __restrict__ qddes_o,
    float* __restrict__ tau_o) {
  constexpr int EPB = K1_THREADS / G;
  __shared__ ChainTab ch;
  __shared__ CartParams C;
  extern __shared__ float k1_smem[];
  const int e0 = blockIdx.x * EPB;
  const int el = threadIdx.x / G, gl = threadIdx.x % G;
  const int e = e0 + el;
  float* S = k1_smem + el * K1_STRIDE;
  copy_words(&ch, &chg, sizeof(ChainTab), K1_THREADS);
  copy_words(&C, &Cg, sizeof(CartParams), K1_THREADS);
  load_rows<K1_THREADS, EPB, K1_STRIDE>(k1_smem, e0, B, qv_in, 7, K1_QV);
  load_rows<K1_THREADS, EPB, K1_STRIDE>(k1_smem, e0, B, ov_in, 7, K1_OV);
  load_rows<K1_THREADS, EPB, K1_STRIDE>(k1_smem, e0, B, dp_in, 3, K1_DP);
  load_rows<K1_THREADS, EPB, K1_STRIDE>(k1_smem, e0, B, dq_in, 4, K1_DQ);
  __syncthreads();
  if (gl == 0) {  // dyn_scalar.qnormalize
    const qt dq = ld4(S + K1_DQ);
    const float n = fmaxf(sqrtf(dq.w * dq.w + dq.x * dq.x + dq.y * dq.y + dq.z * dq.z), 1e-12f);
    st4(S + K1_DQ, qt{dq.w / n, dq.x / n, dq.y / n, dq.z / n});
  }
  // fk(q_virt) of the first substep; every later substep starts from the
  // FK of its predecessor's RNEA, which is fk of the new q_virt
  k1_each<G, CC_NV>(gl, [&](int d) { k1_local(ch, S, d, S[K1_QV + d]); });
  __syncwarp();
  if (gl == 0) k1_compose<true>(ch, S);
  __syncwarp();
  for (int sub = 0; sub < n_sub; ++sub) {
    for (int it = 0; it < C.num_iter; ++it) {
      // ---- FK of the iteration's q (the first iteration's is fk(q_virt),
      // already in XQ, XP), pose error, target (one lane) ----
      if (gl == 0) {
        if (it > 0) k1_compose<false>(ch, S);
        k1_target(C, S, it == 0);
      }
      __syncwarp();
      // ---- per dof: dof frame, J column, null-space velocity ----
      k1_each<G, CC_NV>(gl, [&](int d) {
        if (it == 0) S[K1_Q + d] = S[K1_QV + d];
        v3 ax, an;
        cc_dof_frame(ch, d + 1, ld4(S + K1_XQ + 4 * (d + 1)), ld3(S + K1_XP + 3 * (d + 1)), ax,
                     an);
        const v3 jp = cross(ax, ld3(S + K1_XP + 3 * CC_EE) - an);
        float* J = S + K1_J;
        J[0 * 7 + d] = jp.x;
        J[1 * 7 + d] = jp.y;
        J[2 * 7 + d] = jp.z;
        J[3 * 7 + d] = ax.x;
        J[4 * 7 + d] = ax.y;
        J[5 * 7 + d] = ax.z;
        S[K1_QN + d] = C.pnull[d] * clampf(C.rest[d] - S[K1_Q + d], -0.2f, 0.2f);
      });
      __syncwarp();
      // ---- the 21 entries of J W J^T + reg and the 6 right-hand sides ----
      k1_each<G, 27>(gl, [&](int k) {
        const float* J = S + K1_J;
        if (k < 21) {
          int i = 0, r = k;  // k-th entry (i, j), i <= j, of the upper triangle by rows
          while (r >= 6 - i) {
            r -= 6 - i;
            ++i;
          }
          const int j = i + r;
          float s = i == j ? C.reg : 0.0f;
          for (int d = 0; d < 7; ++d) s += J[i * 7 + d] * C.W[d] * J[j * 7 + d];
          S[K1_A + i * 6 + j] = s;
        } else {
          const int i = k - 21;
          float s = 0.0f;
          for (int d = 0; d < 7; ++d) s += J[i * 7 + d] * S[K1_QN + d];
          S[K1_RHS + i] = S[K1_TGT + i] - s;
        }
      });
      __syncwarp();
      // ---- clamped SPD solve, joint step and its norm (one lane) ----
      if (gl == 0) k1_solve(C, S);
      __syncwarp();
      // ---- per dof: the clamped update and the new q's local transform;
      // after the last iteration first the convergence gate, the finite
      // differences and the outputs ----
      const bool last = it == C.num_iter - 1;
      k1_each<G, CC_NV>(gl, [&](int d) {
        float q = clampf(S[K1_Q + d] + C.lr * S[K1_STEP + d] * S[K1_SCALE], C.lo[d], C.hi[d]);
        if (last) {
          const float qv = S[K1_QV + d];
          if (S[K1_CONV] != 0.0f) q = qv;
          const float qd = (q - qv) / C.dt;
          const float qdd = clampf(C.ddg[d] * (qd - S[K1_OV + d]) / C.dt, -25.0f, 25.0f);
          S[K1_QV + d] = q;
          S[K1_OV + d] = qd;
          S[K1_QD + d] = qd;
          S[K1_QDD + d] = qdd;
          if (e < B) {
            const size_t o = ((size_t)sub * 7 + d) * B + e;
            qdes_o[o] = q;
            qddes_o[o] = qd;
          }
        }
        S[K1_Q + d] = q;
        k1_local(ch, S, d, q);
      });
      __syncwarp();
    }
    // ---- RNEA feedforward at the new q (dyn_scalar.rnea_s, gravity 0):
    // FK, dof frames and the two sweeps on one lane, the seeds and the
    // torques over the group ----
    if (gl == 0) k1_rnea_forward(ch, S);
    __syncwarp();
    k1_each<G, CC_NB - 1>(gl, [&](int k) {
      const int b = k + 1;
      const cc_motion m = {ld3(S + K1_OM + 3 * b), ld3(S + K1_AL + 3 * b), ld3(S + K1_AO + 3 * b)};
      v3 F, N;
      cc_seed(ch, b, ld4(S + K1_XQ + 4 * b), ld3(S + K1_XP + 3 * b), m, F, N);
      st3(S + K1_AO + 3 * b, F);
      st3(S + K1_AL + 3 * b, N);
    });
    __syncwarp();
    if (gl == 0) k1_rnea_backward(S);
    __syncwarp();
    k1_each<G, CC_NV>(gl, [&](int d) {
      const float tau = cc_tau(ld3(S + K1_AX + 3 * d), ld3(S + K1_AN + 3 * d),
                               ld3(S + K1_XP + 3 * (d + 1)), ld3(S + K1_AO + 3 * (d + 1)),
                               ld3(S + K1_AL + 3 * (d + 1)));
      if (e < B) tau_o[((size_t)sub * 7 + d) * B + e] = tau;
    });
    // the next substep's first writes over what these lanes read (J and
    // qd_null over AL, AO) come after the barrier that follows its target
  }
  k1_each<G, CC_NV>(gl, [&](int d) {
    if (e < B) {
      qv_o[(size_t)d * B + e] = S[K1_QV + d];
      ov_o[(size_t)d * B + e] = S[K1_OV + d];
    }
  });
}

// ---------------------------------------------------------------------------
// K4: control-model feedforward (dyn_kernel._make_ff_kernel): tau = M(q) qdd
// + C(q, qd) qd on the control chain, one FK + one RNEA pass with g = 0, one
// thread per column of the [7, B] inputs, the chain's state in registers
// (cc_feedforward); the table stays in the constant bank, which serves the
// one body that all lanes of a warp read at a time.
// ---------------------------------------------------------------------------
#define K4_THREADS 128

__global__ void __launch_bounds__(K4_THREADS) ff_kernel(
    const __grid_constant__ ChainTab ch, int B, const float* __restrict__ q_in,
    const float* __restrict__ qd_in, const float* __restrict__ qdd_in, float* __restrict__ tau_o) {
  const int e = blockIdx.x * K4_THREADS + threadIdx.x;
  if (e >= B) return;
  float q[CC_NV], qd[CC_NV], qdd[CC_NV], tau[CC_NV];
#pragma unroll
  for (int d = 0; d < CC_NV; ++d) {
    const size_t o = (size_t)d * B + e;
    q[d] = q_in[o];
    qd[d] = qd_in[o];
    qdd[d] = qdd_in[o];
  }
  cc_feedforward(ch, q, qd, qdd, tau);
#pragma unroll
  for (int d = 0; d < CC_NV; ++d) tau_o[(size_t)d * B + e] = tau[d];
}

// ---------------------------------------------------------------------------
// C entry points (ctypes): launch on the caller's stream, return the launch
// status. Pointers are device pointers; the tables are host structs passed
// by value into the kernel's constant parameter bank.
// ---------------------------------------------------------------------------
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

template <int G>
static int launch_ik_window(const ChainTab* ch, const CartParams* C, int B, int n_sub,
                            const float* q_virt, const float* old_vel, const float* des_pos,
                            const float* des_quat, float* qv_out, float* ov_out, float* q_des,
                            float* qd_des, float* tau, cudaStream_t stream) {
  constexpr int EPB = K1_THREADS / G;
  const size_t bytes = (size_t)K1_STRIDE * EPB * sizeof(float);
  ik_window_kernel<G><<<(B + EPB - 1) / EPB, K1_THREADS, bytes, stream>>>(
      *ch, *C, B, n_sub, q_virt, old_vel, des_pos, des_quat, qv_out, ov_out, q_des, qd_des, tau);
  return (int)cudaGetLastError();
}

// lanes: lanes per env, 4 or 32 (engine/dyn_kernel.py:ik_window_geometry)
extern "C" int d3il_ik_window(const ChainTab* ch, const CartParams* C, int B, int n_sub,
                              int lanes, const float* q_virt, const float* old_vel,
                              const float* des_pos, const float* des_quat, float* qv_out,
                              float* ov_out, float* q_des, float* qd_des, float* tau,
                              void* stream) {
  if (!cc_matches(*ch) || C->ee != CC_EE || C->num_iter < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (lanes) {
    case 4:
      return launch_ik_window<4>(ch, C, B, n_sub, q_virt, old_vel, des_pos, des_quat, qv_out,
                                 ov_out, q_des, qd_des, tau, s);
    case 32:
      return launch_ik_window<32>(ch, C, B, n_sub, q_virt, old_vel, des_pos, des_quat, qv_out,
                                  ov_out, q_des, qd_des, tau, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int d3il_feedforward(const ChainTab* ch, int B, const float* q, const float* qd,
                                const float* qdd, float* tau, void* stream) {
  if (!cc_matches(*ch)) return (int)cudaErrorInvalidValue;
  ff_kernel<<<(B + K4_THREADS - 1) / K4_THREADS, K4_THREADS, 0, (cudaStream_t)stream>>>(
      *ch, B, q, qd, qdd, tau);
  return (int)cudaGetLastError();
}

extern "C" int d3il_struct_sizes(int* out) {
  out[0] = (int)sizeof(ChainTab);
  out[1] = (int)sizeof(ArmParams);
  out[2] = (int)sizeof(CartParams);
  return 0;
}
