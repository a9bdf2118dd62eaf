"""Arm dynamics kernels: IK window (K1), arm stage (K2), feedforward (K4).

Counterpart of ``d3il_tpu/engine/dyn_kernel.py``. Each kernel has three
parts here:

  * a spec (``IkSpec``, ``ArmSpec``) that packs the static inputs once: the
    chain as a ``ChainTab`` table and the gains, as ctypes structs that
    mirror ``csrc/dyn_scalar.cuh`` / ``csrc/dyn_kernel.cu``;
  * the plain PyTorch version, the scalar algebra of ``dyn_scalar.py`` on
    [B] tensors;
  * the wrapper (``ik_window_bm``, ``arm_stage_bm``, ``feedforward_bm``): on
    CPU tensors it runs
    the plain version; on CUDA tensors it launches the hand-written kernel
    (``csrc/dyn_kernel.cu``) or raises. ``<wrapper>.launches`` counts kernel
    launches.

Layout is batch-minor ([..., B]) as in the JAX kernels. K4 runs one thread
per column, so thread e reads and writes element ``[..., e]`` and a warp's
accesses are contiguous; K1 and K2 run one env per group of lanes
(``ik_window_geometry``, ``arm_stage_geometry``) and their blocks load the
envs' rows together, consecutive threads on consecutive envs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from d3il_tpu_torch.control import gripper
from d3il_tpu_torch.engine import dyn_scalar as dsc
from d3il_tpu_torch.kernels import build
from d3il_tpu_torch.robot.chain import HINGE, SLIDE
from d3il_tpu_torch.robot.panda import JOINT_POS_MAX, JOINT_POS_MIN

MAXB, MAXV = 17, 9
_f, _i = ctypes.c_float, ctypes.c_int


class ChainTab(ctypes.Structure):
    """Mirror of ``ChainTab`` in csrc/dyn_scalar.cuh (all 32-bit fields)."""
    _fields_ = [("nb", _i), ("nv", _i), ("parent", _i * MAXB),
                ("jtype", _i * MAXB), ("body_dof", _i * MAXB),
                ("dof_body", _i * MAXV), ("axis", _f * 3 * MAXB),
                ("jpos", _f * 3 * MAXB), ("bquat", _f * 4 * MAXB),
                ("lconst", _f * 3 * MAXB), ("sdir", _f * 3 * MAXB),
                ("mass", _f * MAXB), ("com", _f * 3 * MAXB),
                ("inertia", _f * 9 * MAXB), ("anc", _f * MAXV * MAXB)]


class ArmParams(ctypes.Structure):
    _fields_ = [("h", _f), ("grav", _f * 3), ("pg", _f * 7), ("dg", _f * 7),
                ("damping", _f * MAXV), ("frange", _f * 2 * MAXV)]


class CartParams(ctypes.Structure):
    _fields_ = [("ee", _i), ("num_iter", _i), ("pgain", _f * 6), ("W", _f * 7),
                ("rest", _f * 7), ("pnull", _f * 7), ("lo", _f * 7),
                ("hi", _f * 7), ("ddg", _f * 7), ("lr", _f), ("reg", _f),
                ("svd_lo", _f), ("dt", _f)]


def _fill(arr, values, dtype=np.float32):
    """Copy values into a ctypes array field (the source array is held in
    a local so it outlives the copy)."""
    src = np.ascontiguousarray(np.asarray(values).reshape(-1), dtype)
    if src.nbytes > ctypes.sizeof(arr):
        raise ValueError(f"{src.size} values do not fit the field")
    ctypes.memmove(arr, src.ctypes.data, src.nbytes)


def _fill_i(arr, values):
    _fill(arr, values, np.int32)


def _rot_np(q, v):
    """R(q) v in float64 (the 2-cross form of ops/quat.rotate)."""
    qv, qw = np.asarray(q[1:], np.float64), float(q[0])
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def pack_chain(chain) -> ChainTab:
    """Chain -> ChainTab, with the constant parts of each body's local
    transform folded in float64 (as dyn_scalar.fk_s folds them)."""
    nb, nv = chain.nb, chain.nv
    if nb > MAXB or nv > MAXV:
        raise ValueError(f"chain has {nb} bodies / {nv} dofs; the kernels "
                         f"take at most {MAXB} / {MAXV}")
    pad = lambda a, n: np.concatenate(
        [np.asarray(a), np.zeros((n - len(a),) + np.asarray(a).shape[1:])])
    lconst = np.array(chain.body_pos, np.float64)
    sdir = np.zeros((nb, 3))
    for b in range(nb):
        if chain.joint_type[b] == HINGE:
            lconst[b] = chain.body_pos[b] + _rot_np(chain.body_quat[b],
                                                    chain.joint_pos[b])
        elif chain.joint_type[b] == SLIDE:
            sdir[b] = _rot_np(chain.body_quat[b], chain.joint_axis[b])
    t = ChainTab()
    t.nb, t.nv = nb, nv
    _fill_i(t.parent, pad(chain.parent, MAXB))
    _fill_i(t.jtype, pad(chain.joint_type, MAXB))
    _fill_i(t.body_dof, pad(chain.body_dof, MAXB))
    _fill_i(t.dof_body, pad(chain.dof_body, MAXV))
    _fill(t.axis, pad(chain.joint_axis, MAXB))
    _fill(t.jpos, pad(chain.joint_pos, MAXB))
    _fill(t.bquat, pad(chain.body_quat, MAXB))
    _fill(t.lconst, pad(lconst, MAXB))
    _fill(t.sdir, pad(sdir, MAXB))
    _fill(t.mass, pad(chain.mass, MAXB))
    _fill(t.com, pad(chain.com, MAXB))
    _fill(t.inertia, pad(chain.inertia.reshape(nb, 9), MAXB))
    anc = np.zeros((MAXB, MAXV))
    anc[:nb, :nv] = chain.ancestor_mask
    _fill(t.anc, anc)
    return t


# K2's launch geometry (mirrors K2_G, K2_THREADS and K2_STRIDE in
# csrc/dyn_kernel.cu): one env per group of ARM_LANES lanes, ARM_THREADS
# threads per block, ARM_STRIDE floats of shared memory per env
ARM_LANES, ARM_THREADS, ARM_STRIDE = 8, 128, 753


def arm_stage_geometry(B: int) -> dict:
    """How ``arm_stage_bm`` launches B envs: lanes per env, envs per block,
    blocks, and shared-memory bytes per env and per block (the envs' state
    plus the block's copy of the chain table)."""
    epb = ARM_THREADS // ARM_LANES
    return {"lanes_per_env": ARM_LANES, "envs_per_block": epb,
            "blocks": -(-B // epb), "smem_per_env": 4 * ARM_STRIDE,
            "smem_per_block": 4 * ARM_STRIDE * epb + ctypes.sizeof(ChainTab)}


# K1's launch geometry (mirrors K1_THREADS and K1_STRIDE in
# csrc/dyn_kernel.cu, which builds the kernel for each of IK_LANES lanes per
# env): IK_THREADS threads per block, IK_STRIDE floats of shared memory per
# env. Each env is a chain of dependent steps: a batch that puts
# IK_IN_FLIGHT threads in flight at 4 lanes per env (the env path's 8192)
# gains from more envs per warp on the serial stages, a smaller one (the
# evaluation path's 480, the set-up launch's 1) from a whole warp per env on
# the parallel ones (chip_smoke.py times both lane counts at B = 8192, 480
# and 1)
IK_THREADS, IK_STRIDE, IK_LANES = 128, 335, (4, 32)
IK_IN_FLIGHT = 16384


def ik_window_geometry(B: int, lanes: int | None = None) -> dict:
    """How ``ik_window_bm`` launches B envs (or, given ``lanes``, how that
    many lanes per env would): lanes per env, envs per block, blocks, and
    shared-memory bytes per env and per block (the envs' state plus the
    block's copies of the chain table and the gains)."""
    if lanes is None:
        lanes = IK_LANES[0] if B * IK_LANES[0] >= IK_IN_FLIGHT else IK_LANES[1]
    if lanes not in IK_LANES:
        raise ValueError(f"ik_window runs {IK_LANES} lanes per env, not {lanes}")
    epb = IK_THREADS // lanes
    return {"lanes_per_env": lanes, "envs_per_block": epb,
            "blocks": -(-B // epb), "smem_per_env": 4 * IK_STRIDE,
            "smem_per_block": 4 * IK_STRIDE * epb + ctypes.sizeof(ChainTab)
            + ctypes.sizeof(CartParams)}


class ArmSpec:
    """Static inputs of the arm stage: the scene's sim chain (7 arm + 2
    finger dofs), the joint PD gains, damping, actuator ranges, dt, g."""

    def __init__(self, scene, pd_gains):
        if scene.robot.nv != 9:
            raise ValueError("arm_stage takes a 7-arm + 2-finger sim chain")
        self.scene, self.pd_gains = scene, pd_gains
        self.chain_tab = pack_chain(scene.robot)
        p = ArmParams()
        p.h = float(scene.dt)
        _fill(p.grav, scene.gravity)
        _fill(p.pg, pd_gains.pgain)
        _fill(p.dg, pd_gains.dgain)
        _fill(p.damping, scene.robot.joint_damping)
        _fill(p.frange, scene.forcerange)
        self.params = p


class IkSpec:
    """Static inputs of the IK window: the URDF control chain, the
    cartesian impedance gains and the control period dt."""

    def __init__(self, ctrl_chain, gains, dt):
        if ctrl_chain.nv != 7:
            raise ValueError("ik_window takes the 7-dof control chain")
        self.ctrl_chain, self.gains, self.dt = ctrl_chain, gains, float(dt)
        self.chain_tab = pack_chain(ctrl_chain)
        c = CartParams()
        c.ee = ctrl_chain.body_index("panda_grasptarget")
        c.num_iter = int(gains.num_iter)
        _fill(c.pgain, np.concatenate([gains.pgain_pos, gains.pgain_quat]))
        _fill(c.W, gains.W)
        _fill(c.rest, gains.rest_posture)
        _fill(c.pnull, gains.pgain_null)
        _fill(c.lo, JOINT_POS_MIN)
        _fill(c.hi, JOINT_POS_MAX)
        _fill(c.ddg, gains.ddgain)
        c.lr, c.reg = float(gains.learning_rate), float(gains.J_reg)
        c.svd_lo, c.dt = float(gains.min_svd_values), float(dt)
        self.params = c


# ---------------------------------------------------------------------------
# kernel library
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


def _lib():
    lib = build.load("dyn_kernel")
    if not getattr(lib, "_d3il_ready", False):
        sizes = (ctypes.c_int * 3)()
        lib.d3il_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.d3il_struct_sizes.restype = ctypes.c_int
        lib.d3il_struct_sizes(sizes)
        want = (ctypes.sizeof(ChainTab), ctypes.sizeof(ArmParams),
                ctypes.sizeof(CartParams))
        if tuple(sizes) != want:
            raise RuntimeError(f"struct layout mismatch: C {tuple(sizes)} "
                               f"vs Python {want}")
        lib.d3il_arm_stage.argtypes = [
            ctypes.POINTER(ChainTab), ctypes.POINTER(ArmParams), ctypes.c_int,
            *([_P] * 14), _P]
        lib.d3il_arm_stage.restype = ctypes.c_int
        lib.d3il_ik_window.argtypes = [
            ctypes.POINTER(ChainTab), ctypes.POINTER(CartParams), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, *([_P] * 9), _P]
        lib.d3il_ik_window.restype = ctypes.c_int
        lib.d3il_feedforward.argtypes = [ctypes.POINTER(ChainTab),
                                         ctypes.c_int, *([_P] * 4), _P]
        lib.d3il_feedforward.restype = ctypes.c_int
        lib._d3il_ready = True
    return lib


def _stack(rows, like: torch.Tensor) -> torch.Tensor:
    """Stack nested lists of [B] tensors / folded Python floats."""
    if isinstance(rows, (list, tuple)):
        return torch.stack([_stack(r, like) for r in rows])
    if isinstance(rows, (int, float)):
        return torch.full_like(like, float(rows))
    return rows


# ---------------------------------------------------------------------------
# K2: arm stage
# ---------------------------------------------------------------------------

def arm_stage_plain(spec: ArmSpec, q, qd, q_des, qd_des, tau_model,
                    set_width, grasp_flag):
    """Plain version of the arm stage (dyn_kernel._make_arm_kernel math)."""
    scene = spec.scene
    robot = scene.robot
    nv = robot.nv
    h = float(scene.dt)
    pg = [float(v) for v in spec.pd_gains.pgain]
    dg = [float(v) for v in spec.pd_gains.dgain]
    D = [float(v) for v in robot.joint_damping]
    fr = np.asarray(scene.forcerange, np.float64)
    qs = [q[i] for i in range(nv)]
    qds = [qd[i] for i in range(nv)]

    xpos, xquat, axes, anchors, M, bias = dsc.dynamics_s(
        robot, qs, qds, tuple(float(v) for v in scene.gravity))
    # joint PD + feedforward + gravity comp, then the finger force law
    ctrl = [pg[i] * (q_des[i] - qs[i]) + dg[i] * (qd_des[i] - qds[i])
            + tau_model[i] + bias[i] for i in range(7)]
    fing = gripper.finger_forces(q[7:].T, qd[7:].T, set_width,
                                 grasp_flag > 0.5)
    ctrl += [fing[:, 0], fing[:, 1]]
    tau_c = [torch.clamp(ctrl[i], float(fr[i, 0]), float(fr[i, 1]))
             for i in range(nv)]
    f_arm = [tau_c[i] - bias[i] for i in range(nv)]
    Mh = dict(M)
    for i in range(nv):
        Mh[(i, i)] = Mh[(i, i)] + h * D[i]
    Minv = dsc.spd_inverse_s(Mh, nv)
    a_arm = dsc.matvec_sym_s(Minv, f_arm, nv)
    Mqd = dsc.matvec_sym_s(M, qds, nv)
    qd_pre = dsc.matvec_sym_s(Minv, [Mqd[i] + h * f_arm[i]
                                     for i in range(nv)], nv)
    full = [[Minv[(i, j)] if i <= j else Minv[(j, i)] for j in range(nv)]
            for i in range(nv)]
    return tuple(_stack(x, set_width) for x in
                 (xpos, xquat, axes, anchors, full, qd_pre, a_arm))


def arm_stage_bm(spec: ArmSpec, q, qd, q_des, qd_des, tau_model, set_width,
                 grasp_flag):
    """Batch-minor arm stage. q, qd [9, B]; q_des, qd_des, tau_model [7, B];
    set_width, grasp_flag [B].

    Returns (xpos [nb,3,B], xquat [nb,4,B], axes [9,3,B], anchors [9,3,B],
    Minv [9,9,B], qd_pre [9,B], a_arm [9,B]): qd_pre is the contact-free
    velocity update (M+hD)^-1 (M qd + h (tau - bias)) and
    a_arm = (M+hD)^-1 (tau - bias)."""
    grasp_flag = grasp_flag.to(torch.float32)
    if q.device.type == "cpu":
        return arm_stage_plain(spec, q, qd, q_des, qd_des, tau_model,
                               set_width, grasp_flag)
    robot = spec.scene.robot
    nb, nv, B = robot.nb, robot.nv, q.shape[-1]
    build.check_inputs({"q": (q, (nv,)), "qd": (qd, (nv,)),
                   "q_des": (q_des, (7,)), "qd_des": (qd_des, (7,)),
                   "tau_model": (tau_model, (7,)),
                   "set_width": (set_width, ()),
                   "grasp_flag": (grasp_flag, ())}, B, q.device)
    new = lambda *s: torch.empty(s + (B,), dtype=torch.float32,
                                 device=q.device)
    outs = (new(nb, 3), new(nb, 4), new(nv, 3), new(nv, 3), new(nv, nv),
            new(nv), new(nv))
    lib = _lib()
    status = lib.d3il_arm_stage(
        ctypes.byref(spec.chain_tab), ctypes.byref(spec.params), B,
        *(t.data_ptr() for t in (q, qd, q_des, qd_des, tau_model, set_width,
                                 grasp_flag)),
        *(o.data_ptr() for o in outs), build.stream_of(q.device))
    build.check(status, "arm_stage launch")
    arm_stage_bm.launches += 1
    return outs


arm_stage_bm.launches = 0


# ---------------------------------------------------------------------------
# K1: IK window
# ---------------------------------------------------------------------------

def ik_window_plain(spec: IkSpec, n_sub, q_virt, old_vel, des_pos, des_quat):
    """Plain version of the IK window (dyn_kernel._make_ik_window_kernel)."""
    chain, gains, dt = spec.ctrl_chain, spec.gains, spec.dt
    dp = tuple(des_pos[k] for k in range(3))
    dq = dsc.qnormalize(tuple(des_quat[k] for k in range(4)))
    qv = [q_virt[i] for i in range(7)]
    ov = [old_vel[i] for i in range(7)]
    qs, qds, taus = [], [], []
    for _ in range(n_sub):
        q_new, qd_des, qdd_des = dsc.cart_step_s(chain, gains, qv, ov, dp, dq,
                                                 dt)
        xpos, xquat = dsc.fk_s(chain, q_new)
        tau = dsc.rnea_s(chain, xpos, xquat, q_new, qd_des, qdd_des,
                         gravity=(0.0, 0.0, 0.0))
        qs.append(_stack(q_new, q_virt[0]))
        qds.append(_stack(qd_des, q_virt[0]))
        taus.append(_stack(tau, q_virt[0]))
        qv, ov = q_new, qd_des
    like = q_virt[0]
    return (_stack(qv, like), _stack(ov, like), torch.stack(qs),
            torch.stack(qds), torch.stack(taus))


def ik_window_bm(spec: IkSpec, n_sub: int, q_virt, old_vel, des_pos,
                 des_quat):
    """Whole-substep-window cartesian DLS-IK + model feedforward.

    q_virt, old_vel [7, B]; des_pos [3, B]; des_quat [4, B]. Returns
    (q_virt' [7,B], old_vel' [7,B], q_des_w [n_sub,7,B], qd_des_w
    [n_sub,7,B], tau_model_w [n_sub,7,B])."""
    if q_virt.device.type == "cpu":
        return ik_window_plain(spec, n_sub, q_virt, old_vel, des_pos,
                               des_quat)
    outs = launch_ik_window(
        spec, n_sub, (q_virt, old_vel, des_pos, des_quat),
        ik_window_geometry(q_virt.shape[-1])["lanes_per_env"])
    ik_window_bm.launches += 1
    return outs


def launch_ik_window(spec: IkSpec, n_sub: int, ins, lanes: int):
    """One launch of K1 on CUDA inputs (q_virt, old_vel, des_pos, des_quat)
    with ``lanes`` lanes per env; returns ``ik_window_bm``'s outputs. Not
    counted: ``ik_window_bm`` counts its own calls, and chip_smoke.py times
    each lane count through this."""
    q_virt, old_vel, des_pos, des_quat = ins
    B = q_virt.shape[-1]
    build.check_inputs({"q_virt": (q_virt, (7,)), "old_vel": (old_vel, (7,)),
                        "des_pos": (des_pos, (3,)),
                        "des_quat": (des_quat, (4,))}, B, q_virt.device)
    ik_window_geometry(B, lanes)      # raises for a lane count not built
    new = lambda *s: torch.empty(s + (B,), dtype=torch.float32,
                                 device=q_virt.device)
    outs = (new(7), new(7), new(n_sub, 7), new(n_sub, 7), new(n_sub, 7))
    status = _lib().d3il_ik_window(
        ctypes.byref(spec.chain_tab), ctypes.byref(spec.params), B,
        int(n_sub), int(lanes), *(t.data_ptr() for t in ins),
        *(o.data_ptr() for o in outs), build.stream_of(q_virt.device))
    build.check(status, "ik_window launch")
    return outs


ik_window_bm.launches = 0


# ---------------------------------------------------------------------------
# K4: control-model feedforward
# ---------------------------------------------------------------------------

def feedforward_plain(spec: IkSpec, q_des, qd_des, qdd_des):
    """Plain version of the feedforward (dyn_kernel._make_ff_kernel): one FK
    and one zero-gravity RNEA pass on the control chain."""
    chain = spec.ctrl_chain
    q, qd, qdd = ([x[i] for i in range(chain.nv)]
                  for x in (q_des, qd_des, qdd_des))
    xpos, xquat = dsc.fk_s(chain, q)
    tau = dsc.rnea_s(chain, xpos, xquat, q, qd, qdd, gravity=(0.0, 0.0, 0.0))
    return _stack(tau, q_des[0])


def feedforward_bm(spec: IkSpec, q_des, qd_des, qdd_des):
    """M(q_des) qdd_des + C(q_des, qd_des) on the control chain
    (joint_pd.model_feedforward), batch-minor: inputs and result [7, B]."""
    if q_des.device.type == "cpu":
        return feedforward_plain(spec, q_des, qd_des, qdd_des)
    nv, B = spec.ctrl_chain.nv, q_des.shape[-1]
    build.check_inputs({"q_des": (q_des, (nv,)), "qd_des": (qd_des, (nv,)),
                        "qdd_des": (qdd_des, (nv,))}, B, q_des.device)
    tau = torch.empty((nv, B), dtype=torch.float32, device=q_des.device)
    status = _lib().d3il_feedforward(
        ctypes.byref(spec.chain_tab), B, q_des.data_ptr(), qd_des.data_ptr(),
        qdd_des.data_ptr(), tau.data_ptr(), build.stream_of(q_des.device))
    build.check(status, "feedforward launch")
    feedforward_bm.launches += 1
    return tau


feedforward_bm.launches = 0
