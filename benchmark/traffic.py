"""The one traffic generator: contexts and actions from ``--seed`` and a
mix's data file (``traffic/<mix>.json``).

A mix states the batch, the mode (``dynamic`` or ``kinematic``), the loop
(``closed``: the next step is issued when the last returns), the action
policy under ``actions`` (its ``kind`` and parameters), the warm-up and
traced steps, the episode steps the check draws from and the reference's
block of envs. Contexts come from the frozen reference's
``sample_context`` of the configuration's env on a ``torch.Generator`` on
the device, seeded from ``--seed``; the action policies draw from
generators of their own. The same seed gives the same contexts and the
same draws.

An action kind is a module of its own, ``actions/<kind>.py``, found by
the name: its ``make(p, env, params, state, seed)`` takes the mix's
``actions`` entry and the program's reset state and returns a policy whose
``action(state, obs, k)`` gives the action of episode step ``k`` from the
last state and observation, and whose ``summary()`` gives device tensors
of what the policy is doing (logged, never compared).
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent


def stream_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the stream ``what`` of run seed ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, what))


def contexts(ref_env, seed: int, batch: int, device):
    """The batch's contexts from the reference env's ``sample_context``."""
    return ref_env.sample_context(generator(seed, "contexts", device), batch)


def policy(traffic: dict, env, params, state, seed: int, bench=BENCH):
    """The mix's action policy for the program's reset ``state``, made by
    ``actions/<kind>.py``."""
    from benchmark import cell
    p = traffic["actions"]
    path = Path(bench) / "actions" / f"{p['kind']}.py"
    if not path.is_file():
        raise ValueError(f"unknown action kind {p['kind']!r}")
    return cell.load_module(path).make(p, env, params, state, seed)
