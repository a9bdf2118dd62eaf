"""Scalarized (structure-of-arrays) robot dynamics: the plain version of
the arm kernels.

Counterpart of ``d3il_tpu/engine/dyn_scalar.py``. Every quantity is one
tensor holding only the env batch ([B]), every loop over bodies/dofs is a
Python loop, and chain constants enter as Python floats, so constant
subexpressions (fixed-tail transforms, the root's zero velocity) fold before
any tensor op runs. The same algorithms, written as CUDA device functions
over chain tables, are ``csrc/dyn_scalar.cuh``; ``engine/dyn_kernel.py``
holds the two against each other.

Algorithms (classical recursions):

  * FK: sequential parent->child compose.
  * Bias forces: RNEA with root acceleration -g, then a leaf->root force
    pass (C(q, qd) qd + g(q), MuJoCo qfrc_bias).
  * Feedforward: the same RNEA with qdd != 0 and g = 0 gives
    M(q) qdd + C(q, qd) qd.
  * Mass matrix: CRBA with composite bodies about their own COM.
  * Small SPD solves: unrolled scalar Cholesky.

Leaves are floats or [B] tensors: vec3/quat are tuples, matrices dicts.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.robot.chain import HINGE, SLIDE
from benchmark.reference.robot.panda import JOINT_POS_MAX, JOINT_POS_MIN


# ---------------------------------------------------------------------------
# dispatching scalar helpers (float -> math, tensor -> torch)
# ---------------------------------------------------------------------------

def _isf(x):
    return isinstance(x, (int, float))


def _sin(x):
    return math.sin(x) if _isf(x) else torch.sin(x)


def _cos(x):
    return math.cos(x) if _isf(x) else torch.cos(x)


def _sqrt(x):
    return math.sqrt(x) if _isf(x) else torch.sqrt(x)


def v3(x=0.0, y=0.0, z=0.0):
    return (x, y, z)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def qmul(p, q):
    w0, x0, y0, z0 = p
    w1, x1, y1, z1 = q
    return (w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1)


def qrot(q, v):
    """Rotate vec3 by quaternion (2-cross form, matches ops/quat.rotate)."""
    qv = (q[1], q[2], q[3])
    t = vscale(vcross(qv, v), 2.0)
    return vadd(vadd(v, vscale(t, q[0])), vcross(qv, t))


def qnormalize(q, eps=1e-12):
    n = _sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    n = max(n, eps) if _isf(n) else torch.clamp_min(n, eps)
    return (q[0] / n, q[1] / n, q[2] / n, q[3] / n)


def qtomat(q):
    """quat -> 3x3 rotation as nested tuples (rows)."""
    w, x, y, z = q
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def mat_vec(R, v):
    return (vdot(R[0], v), vdot(R[1], v), vdot(R[2], v))


def rot_inertia(R, I):
    """R I R^T for symmetric 3x3 I (nested-tuple rows)."""
    # A = I R^T  (I symmetric)
    A = tuple(tuple(I[i][0] * R[j][0] + I[i][1] * R[j][1] + I[i][2] * R[j][2]
                    for j in range(3)) for i in range(3))
    return tuple(tuple(R[i][0] * A[0][j] + R[i][1] * A[1][j] + R[i][2] * A[2][j]
                       for j in range(3)) for i in range(3))


# ---------------------------------------------------------------------------
# forward kinematics (robot/chain.fk port, sequential compose)
# ---------------------------------------------------------------------------

def fk_s(chain, q):
    """q: list[nv] of scalars. Returns (xpos, xquat): lists over bodies of
    vec3 / quat tuples. Chain constants enter as Python floats and fold."""
    xpos, xquat = [], []
    for b in range(chain.nb):
        bq = tuple(float(v) for v in chain.body_quat[b])
        bp = tuple(float(v) for v in chain.body_pos[b])
        jt = int(chain.joint_type[b])
        if jt == HINGE:
            axis = tuple(float(v) for v in chain.joint_axis[b])
            anchor = tuple(float(v) for v in chain.joint_pos[b])
            theta = q[int(chain.body_dof[b])]
            half = theta * 0.5
            c, s = _cos(half), _sin(half)
            jq = (c, axis[0] * s, axis[1] * s, axis[2] * s)
            lq = qmul(bq, jq)
            # bp + R(bq) anchor is constant; R(lq) anchor is runtime
            const = vadd(bp, qrot(bq, anchor))
            lp = vsub(const, qrot(lq, anchor))
        elif jt == SLIDE:
            axis = tuple(float(v) for v in chain.joint_axis[b])
            d = q[int(chain.body_dof[b])]
            lq = bq
            lp = vadd(bp, vscale(qrot(bq, axis), d))
        else:
            lq, lp = bq, bp
        p = int(chain.parent[b])
        if p < 0:
            xquat.append(lq)
            xpos.append(lp)
        else:
            pq, pp = xquat[p], xpos[p]
            xquat.append(qmul(pq, lq))
            xpos.append(vadd(pp, qrot(pq, lp)))
    return xpos, xquat


def dof_frames_s(chain, xpos, xquat):
    """World axis + anchor point of every dof (chain._dof_frames port)."""
    axes, anchors = [], []
    for d in range(chain.nv):
        b = int(chain.dof_body[d])
        axis = tuple(float(v) for v in chain.joint_axis[b])
        jpos = tuple(float(v) for v in chain.joint_pos[b])
        axes.append(qrot(xquat[b], axis))
        anchors.append(vadd(xpos[b], qrot(xquat[b], jpos)))
    return axes, anchors


# ---------------------------------------------------------------------------
# RNEA: bias forces / inverse dynamics
# ---------------------------------------------------------------------------

def _body_kinematics(chain, xpos, xquat, q, qd, qdd, gravity):
    """World-frame velocity/acceleration propagation.

    Root linear acceleration is set to -gravity (the standard RNEA trick), so
    the downstream force pass yields C(q,qd) qd + g(q) for qdd = 0 — exactly
    chain.bias_forces — and M qdd + C qd for gravity = 0, qdd != 0.

    Returns per-body (omega, alpha, a_com) plus world coms and inertias.
    """
    g = tuple(float(v) for v in gravity)
    omega, alpha, v_o, a_o = [], [], [], []
    coms, Iw = [], []
    for b in range(chain.nb):
        p = int(chain.parent[b])
        if p < 0:
            w_p, al_p = v3(), v3()
            vo_p, ao_p = v3(), (-g[0], -g[1], -g[2])
            o_p = v3()
        else:
            w_p, al_p, vo_p, ao_p = omega[p], alpha[p], v_o[p], a_o[p]
            o_p = xpos[p]
        o_b = xpos[b]
        jt = int(chain.joint_type[b])
        if jt == HINGE:
            d = int(chain.body_dof[b])
            axis = qrot(xquat[b], tuple(float(v) for v in chain.joint_axis[b]))
            jpos = tuple(float(v) for v in chain.joint_pos[b])
            r = vadd(o_b, qrot(xquat[b], jpos))           # world anchor
            w_b = vadd(w_p, vscale(axis, qd[d]))
            al_b = vadd(al_p, vscale(vcross(w_p, axis), qd[d]))
            if qdd is not None:
                al_b = vadd(al_b, vscale(axis, qdd[d]))
            dr = vsub(r, o_p)
            v_r = vadd(vo_p, vcross(w_p, dr))
            a_r = vadd(ao_p, vadd(vcross(al_p, dr),
                                  vcross(w_p, vcross(w_p, dr))))
            do = vsub(o_b, r)
            vo_b = vadd(v_r, vcross(w_b, do))
            ao_b = vadd(a_r, vadd(vcross(al_b, do),
                                  vcross(w_b, vcross(w_b, do))))
        elif jt == SLIDE:
            d = int(chain.body_dof[b])
            axis = qrot(xquat[b], tuple(float(v) for v in chain.joint_axis[b]))
            w_b, al_b = w_p, al_p
            do = vsub(o_b, o_p)
            vo_b = vadd(vadd(vo_p, vcross(w_p, do)), vscale(axis, qd[d]))
            ao_b = vadd(ao_p, vadd(vcross(al_p, do),
                                   vcross(w_p, vadd(vcross(w_p, do),
                                                    vscale(axis, 2.0 * qd[d])))))
            if qdd is not None:
                ao_b = vadd(ao_b, vscale(axis, qdd[d]))
        else:
            w_b, al_b = w_p, al_p
            do = vsub(o_b, o_p)
            vo_b = vadd(vo_p, vcross(w_p, do))
            ao_b = vadd(ao_p, vadd(vcross(al_p, do),
                                   vcross(w_p, vcross(w_p, do))))
        omega.append(w_b)
        alpha.append(al_b)
        v_o.append(vo_b)
        a_o.append(ao_b)
        com_l = tuple(float(v) for v in chain.com[b])
        coms.append(vadd(o_b, qrot(xquat[b], com_l)))
        R = qtomat(xquat[b])
        I_l = tuple(tuple(float(chain.inertia[b][i][j]) for j in range(3))
                    for i in range(3))
        Iw.append(rot_inertia(R, I_l))
    return omega, alpha, a_o, coms, Iw


def _rnea_backward(chain, xpos, xquat, omega, alpha, a_o, coms, Iw):
    """Leaf->root force accumulation with moments about each body's own
    origin (NOT the world origin: origin-relative moment arms are ~0.5 m
    while distal joint torques are ~0.01 Nm, and the f32 cancellation of
    world-origin moments cost ~5e-3 relative error on TPU)."""
    nb = chain.nb
    F = [None] * nb
    N = [None] * nb                       # moment about xpos[b]
    for b in range(nb):
        o_b = xpos[b]
        dc = vsub(coms[b], o_b)
        a_c = vadd(a_o[b], vadd(vcross(alpha[b], dc),
                                vcross(omega[b], vcross(omega[b], dc))))
        m = float(chain.mass[b])
        f = vscale(a_c, m)
        n = vadd(mat_vec(Iw[b], alpha[b]),
                 vcross(omega[b], mat_vec(Iw[b], omega[b])))
        F[b] = f
        N[b] = vadd(n, vcross(dc, f))
    for b in range(nb - 1, 0, -1):
        p = int(chain.parent[b])
        F[p] = vadd(F[p], F[b])
        N[p] = vadd(N[p], vadd(N[b], vcross(vsub(xpos[b], xpos[p]), F[b])))
    axes, anchors = dof_frames_s(chain, xpos, xquat)
    tau = []
    for d in range(chain.nv):
        b = int(chain.dof_body[d])
        if int(chain.joint_type[b]) == HINGE:
            n_r = vadd(N[b], vcross(vsub(xpos[b], anchors[d]), F[b]))
            tau.append(vdot(axes[d], n_r))
        else:
            tau.append(vdot(axes[d], F[b]))
    return tau


def rnea_s(chain, xpos, xquat, q, qd, qdd=None, gravity=(0.0, 0.0, -9.81)):
    """Inverse dynamics tau [nv]: M qdd + C(q,qd) qd + g(q).

    qdd=None means zero (-> bias forces, chain.bias_forces semantics);
    gravity=(0,0,0) with qdd -> joint_pd.model_feedforward semantics.
    """
    omega, alpha, a_o, coms, Iw = _body_kinematics(
        chain, xpos, xquat, q, qd, qdd, gravity)
    return _rnea_backward(chain, xpos, xquat, omega, alpha, a_o, coms, Iw)


# ---------------------------------------------------------------------------
# CRBA: mass matrix via composite bodies
# ---------------------------------------------------------------------------

def _ancestor_pairs(chain):
    """Static list of (i, j) dof pairs with i on j's path to root, i <= j."""
    pairs = []
    for j in range(chain.nv):
        bj = int(chain.dof_body[j])
        for i in range(j + 1):
            if chain.ancestor_mask[bj, i] > 0:
                pairs.append((i, j))
    return pairs


def _steiner(m, d):
    """m (|d|^2 E - d d^T) as nested tuples."""
    d2 = vdot(d, d)
    return tuple(tuple(m * ((d2 if i == j else 0.0) - d[i] * d[j])
                       for j in range(3)) for i in range(3))


def _madd(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def crba_s(chain, xpos, xquat, coms=None, Iw=None):
    """Joint-space inertia matrix as dict {(i, j): val} for i <= j.

    Composite bodies accumulated about their own composite COM (Steiner
    shifts over local ~0.1 m distances; an earlier about-world-origin
    formulation lost ~5e-3 relative accuracy in f32 to m|c|^2-scale
    cancellation). Subtree masses are chain constants and fold to floats.
    For a unit qdd of dof j the subtree exerts F = m_s a_j x (c_s - r_j)
    (hinge; with N_cs = I_cs a_j) or F = m_s a_j (slide; N_cs = 0), and
    M[i][j] = a_i . (N_cs + (c_s - r_i) x F) (hinge i) / a_i . F (slide i).
    """
    if coms is None or Iw is None:
        coms, Iw = [], []
        for b in range(chain.nb):
            com_l = tuple(float(v) for v in chain.com[b])
            coms.append(vadd(xpos[b], qrot(xquat[b], com_l)))
            R = qtomat(xquat[b])
            I_l = tuple(tuple(float(chain.inertia[b][i][j]) for j in range(3))
                        for i in range(3))
            Iw.append(rot_inertia(R, I_l))
    nb = chain.nb
    msub = [float(chain.mass[b]) for b in range(nb)]   # floats: fold
    csub = list(coms)
    Isub = list(Iw)
    sub = [None] * nb                                   # finalized composites
    for b in range(nb - 1, -1, -1):
        sub[b] = (msub[b], csub[b], Isub[b])
        p = int(chain.parent[b])
        if p < 0:
            continue
        m1, m2 = msub[p], msub[b]
        m = m1 + m2
        if m2 == 0.0:
            continue
        if m1 == 0.0:
            msub[p], csub[p], Isub[p] = m2, csub[b], Isub[b]
            continue
        c = vscale(vadd(vscale(csub[p], m1), vscale(csub[b], m2)), 1.0 / m)
        I = _madd(_madd(Isub[p], _steiner(m1, vsub(csub[p], c))),
                  _madd(Isub[b], _steiner(m2, vsub(csub[b], c))))
        msub[p], csub[p], Isub[p] = m, c, I
    axes, anchors = dof_frames_s(chain, xpos, xquat)
    Fj, Nj, cj = [], [], []
    for j in range(chain.nv):
        b = int(chain.dof_body[j])
        a = axes[j]
        m_s, c_s, I_cs = sub[b]
        if int(chain.joint_type[b]) == HINGE:
            F = vscale(vcross(a, vsub(c_s, anchors[j])), m_s)
            N = mat_vec(I_cs, a)
        else:
            F = vscale(a, m_s)
            N = v3()
        Fj.append(F)
        Nj.append(N)
        cj.append(c_s)
    M = {}
    for (i, j) in _ancestor_pairs(chain):
        bi = int(chain.dof_body[i])
        if int(chain.joint_type[bi]) == HINGE:
            n_ri = vadd(Nj[j], vcross(vsub(cj[j], anchors[i]), Fj[j]))
            M[(i, j)] = vdot(axes[i], n_ri)
        else:
            M[(i, j)] = vdot(axes[i], Fj[j])
    return M


def dynamics_s(chain, q, qd, gravity=(0.0, 0.0, -9.81)):
    """Scalarized chain.dynamics: (xpos, xquat, M dict, bias list)."""
    xpos, xquat = fk_s(chain, q)
    omega, alpha, a_o, coms, Iw = _body_kinematics(
        chain, xpos, xquat, q, qd, None, gravity)
    bias = _rnea_backward(chain, xpos, xquat, omega, alpha, a_o, coms, Iw)
    axes, anchors = dof_frames_s(chain, xpos, xquat)
    M = crba_s(chain, xpos, xquat, coms, Iw)
    return xpos, xquat, axes, anchors, M, bias


# ---------------------------------------------------------------------------
# small scalar linear algebra
# ---------------------------------------------------------------------------

def chol_factor_s(M, n, reg=0.0):
    """Cholesky of (A + reg I), A symmetric dict {(i,j): v, i<=j}.
    Returns (L lower-triangular lists, inv_diag)."""
    def A(i, j):
        key = (i, j) if i <= j else (j, i)
        return M.get(key, 0.0)

    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = A(j, i) + (reg if i == j else 0.0)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                if _isf(s):
                    L[i][j] = math.sqrt(max(s, 1e-12))
                else:
                    L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
                inv_diag[i] = 1.0 / L[i][j]
            else:
                L[i][j] = s * inv_diag[j]
    return L, inv_diag


def chol_apply_s(fac, b, n):
    """Solve L L^T x = b given chol_factor_s output."""
    L, inv_diag = fac
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_diag[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_diag[i]
    return x


def spd_inverse_s(M, n, reg=0.0):
    """Full inverse of A (+ reg I) as dict {(i,j): v, i<=j} via n solves
    against unit vectors (one shared factorization, symmetrized)."""
    fac = chol_factor_s(M, n, reg)
    cols = []
    for j in range(n):
        e = [1.0 if i == j else 0.0 for i in range(n)]
        cols.append(chol_apply_s(fac, e, n))
    out = {}
    for i in range(n):
        for j in range(i, n):
            out[(i, j)] = 0.5 * (cols[j][i] + cols[i][j])
    return out


def matvec_sym_s(M, x, n):
    """A x for symmetric dict A."""
    out = []
    for i in range(n):
        s = 0.0
        for j in range(n):
            key = (i, j) if i <= j else (j, i)
            s = s + M.get(key, 0.0) * x[j]
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# cartesian DLS-IK impedance controller step (control/cartesian.step port)
# ---------------------------------------------------------------------------

def _where(c, a, b):
    return torch.where(c, a, b)


def _clipv(x, lo, hi):
    return torch.clamp(x, lo, hi)


def quat_error_s(curr, des):
    """ops/quat.quat_error: wc*vd - wd*vc - vd x vc."""
    wc, vc = curr[0], (curr[1], curr[2], curr[3])
    wd, vd = des[0], (des[1], des[2], des[3])
    return vsub(vsub(vscale(vd, wc), vscale(vc, wd)), vcross(vd, vc))


def cart_step_s(ctrl_chain, gains, q_virt, old_des_vel, des_pos, des_quat_n,
                dt):
    """One controller update (control/cartesian.step), scalarized.

    q_virt/old_des_vel: list[7]; des_pos vec3; des_quat_n pre-normalized
    quat. Returns (q_new list[7], qd_des list[7], qdd_des list[7]). All
    branching is elementwise torch.where; gains constants fold.
    """
    ee = ctrl_chain.body_index("panda_grasptarget")
    pgain = [float(v) for v in list(gains.pgain_pos) + list(gains.pgain_quat)]
    W = [float(v) for v in gains.W]
    rest = [float(v) for v in gains.rest_posture]
    pnull = [float(v) for v in gains.pgain_null]
    lo = [float(v) for v in JOINT_POS_MIN]
    hi = [float(v) for v in JOINT_POS_MAX]
    lr = float(gains.learning_rate)
    reg = float(gains.J_reg)
    svd_lo = float(gains.min_svd_values)

    q = list(q_virt)
    fk0 = fk_s(ctrl_chain, q)
    dq = des_quat_n

    def ik_iter(q, dq, fk_cache):
        xpos, xquat = fk_cache
        cur_pos, cur_quat = xpos[ee], xquat[ee]
        d_minus = sum((cur_quat[k] - dq[k]) ** 2 for k in range(4))
        d_plus = sum((cur_quat[k] + dq[k]) ** 2 for k in range(4))
        flip = _where(d_minus > d_plus, -1.0, 1.0)
        dq2 = tuple(dq[k] * flip for k in range(4))
        pos_err = tuple(_clipv(des_pos[k] - cur_pos[k], -0.01, 0.01)
                        for k in range(3))
        qe = quat_error_s(cur_quat, dq2)
        quat_err = tuple(_clipv(qe[k], -0.1, 0.1) for k in range(3))
        target = [pgain[k] * (pos_err + quat_err)[k] for k in range(6)]
        axes, anchors = dof_frames_s(ctrl_chain, xpos, xquat)
        # J [6, 7]: hinge cols (a x (p - r); a)
        J = [[None] * 7 for _ in range(6)]
        for d in range(7):
            jp = vcross(axes[d], vsub(cur_pos, anchors[d]))
            for k in range(3):
                J[k][d] = jp[k]
                J[3 + k][d] = axes[d][k]
        # A = J W J^T + reg I
        A = {}
        for i in range(6):
            for j in range(i, 6):
                s = reg if i == j else 0.0
                for d in range(7):
                    s = s + J[i][d] * W[d] * J[j][d]
                A[(i, j)] = s
        qd_null = [pnull[d] * _clipv(rest[d] - q[d], -0.2, 0.2)
                   for d in range(7)]
        rhs = [target[i] - sum(J[i][d] * qd_null[d] for d in range(7))
               for i in range(6)]
        # clamped SPD solve (ops/linalg.clamped_spd_solve): Tikhonov + one
        # refinement step through one shared factorization
        fac = chol_factor_s(A, 6, svd_lo)
        x0 = chol_apply_s(fac, rhs, 6)
        x1 = chol_apply_s(fac, x0, 6)
        y = [x0[i] + svd_lo * x1[i] for i in range(6)]
        qd_d = [W[d] * sum(J[i][d] * y[i] for i in range(6)) + qd_null[d]
                for d in range(7)]
        nrm = torch.sqrt(sum(v * v for v in qd_d))
        scale = _where(nrm > 3.0, 3.0 / torch.clamp_min(nrm, 1e-9), 1.0)
        return [_clipv(q[d] + lr * qd_d[d] * scale, lo[d], hi[d])
                for d in range(7)], dq2

    for it in range(int(gains.num_iter)):
        q, dq = ik_iter(q, dq, fk0 if it == 0 else fk_s(ctrl_chain, q))

    # convergence gate (control/cartesian.py:107-123), on fk(q_virt) == fk0
    xpos_f, xquat_f = fk0
    cq = xquat_f[ee]
    d_minus = sum((cq[k] - des_quat_n[k]) ** 2 for k in range(4))
    d_plus = sum((cq[k] + des_quat_n[k]) ** 2 for k in range(4))
    flip_f = _where(d_minus > d_plus, -1.0, 1.0)
    dqf = tuple(des_quat_n[k] * flip_f for k in range(4))
    pe = vsub(des_pos, xpos_f[ee])
    qe = quat_error_s(cq, dqf)
    converged = (torch.sqrt(vdot(pe, pe)) < 5e-4) \
        & (torch.sqrt(vdot(qe, qe)) < 5e-3)
    q = [_where(converged, q_virt[d], q[d]) for d in range(7)]

    ddg = [float(v) for v in gains.ddgain]
    qd_des = [(q[d] - q_virt[d]) / dt for d in range(7)]
    qdd_des = [_clipv(ddg[d] * (qd_des[d] - old_des_vel[d]) / dt, -25.0, 25.0)
               for d in range(7)]
    return q, qd_des, qdd_des
