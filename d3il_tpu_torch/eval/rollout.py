"""Batched on-device rollouts.

Counterpart of ``d3il_tpu/eval/rollout.py``. The env batch dimension holds
(contexts x trajectories) episodes stepped in lockstep; finished episodes
are frozen by masking every leaf of the env state and the policy carry (the
functional analogue of the reference's ``while not done`` early break).
There is no early exit: the loop runs the whole horizon without a host sync.

The rollout protocol matches the reference's simulation harness, including
its one-step observation lag: the env's step computes the returned
observation BEFORE running the physics substeps, so the policy at iteration
k sees the env state as of the entry of step k-1.

  obs_policy_k = concat(prev_abs_action_xy, obs_returned_by_step_{k-1})
  delta        = policy(obs_policy_k)
  abs_xy       = clip(delta, +-0.01) + prev_abs_action_xy
  env action   = [abs_xy, fixed_z, 0, 1, 0, 0]

with prev_abs_action initialized to the tcp position after reset. With
``pos_dim=3`` (aligning) the whole xyz setpoint is the policy's: the delta
is xyz, clipped alike, and there is no fixed z. Stacking's rollout is in
joint space (``make_joint_stepper``).
"""
from __future__ import annotations

import torch


def _map2(fn, a, b):
    """fn over the paired tensor leaves of two like-shaped nested tuples
    (NamedTuples keep their type)."""
    if torch.is_tensor(a):
        return fn(a, b)
    parts = [_map2(fn, x, y) for x, y in zip(a, b)]
    return type(a)(*parts) if hasattr(a, "_fields") else type(a)(parts)


def _freeze(mask, new, old):
    """Where mask [B], keep the old tree's rows; else take the new one's."""
    def pick(n, o):
        return torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), o, n)
    return _map2(pick, new, old)


def make_rod_stepper(params, reset_fn, step_fn, observe_fn, policy_apply,
                     pos_dim: int = 2):
    """(init, body) pair for the Cartesian-delta tasks: planar
    (``pos_dim=2``, z fixed at the tcp's height after reset) or xyz
    (``pos_dim=3``).

    init(policy_carry0, context) -> carry
    body(policy_params, carry) -> carry   (one env step; frozen when done)

    carry = (env state, policy carry, prev_pos [B, pos_dim], prev_obs
    [B, Do], finished [B] bool, fixed_z [B, 1]; unread with pos_dim=3).
    """
    def init(policy_carry0, context):
        state = reset_fn(params, context)
        tcp_pos, _ = params.tcp_pose(state.scene)
        obs0 = observe_fn(params, state)
        finished = torch.zeros(tcp_pos.shape[0], dtype=torch.bool,
                               device=tcp_pos.device)
        return (state, policy_carry0, tcp_pos[:, :pos_dim].contiguous(), obs0,
                finished, tcp_pos[:, 2:3].contiguous())

    down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=params.device)

    def body(policy_params, carry):
        state, pc, prev_pos, prev_obs, finished, fixed_z = carry
        obs_policy = torch.cat([prev_pos, prev_obs], dim=1)
        pc2, delta = policy_apply(policy_params, pc, obs_policy)
        # the reference envs bound the per-step delta (action_space +-0.01)
        abs_pos = torch.clamp(delta[:, :pos_dim], -0.01, 0.01) + prev_pos
        pos3 = abs_pos if pos_dim == 3 else torch.cat([abs_pos, fixed_z], 1)
        action = torch.cat([pos3, down.expand(abs_pos.shape[0], 4)], dim=1)
        new_state, res = step_fn(params, state, action)
        state2 = _freeze(finished, new_state, state)
        pc2 = _freeze(finished, pc2, pc)
        new_pos = torch.where(finished[:, None], prev_pos, abs_pos)
        new_obs = torch.where(finished[:, None], prev_obs, res.obs)
        now_finished = finished | res.done
        return (state2, pc2, new_pos, new_obs, now_finished, fixed_z)

    return init, body


def _rollout(init, body, T: int):
    """rollout(policy_params, policy_carry0, context, on_step=None) over a
    stepper's (init, body) for T steps -> (final env state, dones [T, B]).
    ``on_step(carry)``, when given, sees the carry after every step (keep
    it free of host syncs)."""
    @torch.no_grad()
    def rollout(policy_params, policy_carry0, context, on_step=None):
        carry = init(policy_carry0, context)
        dones = []
        for _ in range(T):
            carry = body(policy_params, carry)
            dones.append(carry[4])
            if on_step is not None:
                on_step(carry)
        return carry[0], torch.stack(dones)

    return rollout


def make_rod_rollout(params, reset_fn, step_fn, observe_fn, policy_apply,
                     max_steps: int | None = None, pos_dim: int = 2):
    """Whole-episode rollout of the Cartesian-delta tasks (see
    make_rod_stepper and _rollout)."""
    T = max_steps if max_steps is not None else params.max_steps
    return _rollout(*make_rod_stepper(params, reset_fn, step_fn, observe_fn,
                                      policy_apply, pos_dim), T)


def make_joint_stepper(params, reset_fn, step_fn, observe_fn, robot_state_fn,
                       policy_apply):
    """(init, body) pair for the joint-space rollout (stacking):

      obs_policy = concat(prev_action8, env_obs)       # 8 + 12 = 20 dims
      pred = policy(obs_policy); q_des = pred[:7] + prev_action8[:7]
      env action = [q_des, pred[7]] (the gripper width passed raw)

    carry = (env state, policy carry, prev_action [B, 8], prev_obs
    [B, Do], finished [B] bool); prev_action starts as robot_state() after
    the reset (joint positions + gripper width).
    """
    def init(policy_carry0, context):
        state = reset_fn(params, context)
        prev_a = robot_state_fn(params, state)
        obs0 = observe_fn(params, state)
        finished = torch.zeros(prev_a.shape[0], dtype=torch.bool,
                               device=prev_a.device)
        return (state, policy_carry0, prev_a, obs0, finished)

    def body(policy_params, carry):
        state, pc, prev_a, prev_obs, finished = carry
        obs_policy = torch.cat([prev_a, prev_obs], dim=1)
        pc2, pred = policy_apply(policy_params, pc, obs_policy)
        action = torch.cat([pred[:, :7] + prev_a[:, :7], pred[:, 7:8]], dim=1)
        new_state, res = step_fn(params, state, action)
        state2 = _freeze(finished, new_state, state)
        pc2 = _freeze(finished, pc2, pc)
        new_a = torch.where(finished[:, None], prev_a, action)
        new_obs = torch.where(finished[:, None], prev_obs, res.obs)
        return (state2, pc2, new_a, new_obs, finished | res.done)

    return init, body


def make_joint_rollout(params, reset_fn, step_fn, observe_fn, robot_state_fn,
                       policy_apply, max_steps: int | None = None):
    """Whole-episode joint-space rollout (see make_joint_stepper and
    _rollout)."""
    T = max_steps if max_steps is not None else params.max_steps
    return _rollout(*make_joint_stepper(params, reset_fn, step_fn,
                                        observe_fn, robot_state_fn,
                                        policy_apply), T)
