#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (d3il_tpu_torch).

Run from the repo root on a machine with one NVIDIA GPU and the CUDA
toolkit: ``python3 chip_smoke.py``. Imports nothing of JAX or d3il_tpu.

``python3 chip_smoke.py --kernels-only`` runs phases 1 and 2 alone, and
K3 held and timed on the substep phases 5-7 hold it on for avoiding and
each general scene (GENERAL_SCENES, each through its Params() at full
width; no launch-geometry line: only the wrappers' own signatures,
ContactTables(meta, device) and phase_batched_bm(tables, *args), are
used), and prints the ``kernels`` line without launches. The same file
copied into a checkout of an earlier commit times that commit's kernels,
so runs of both checkouts in turns (old, new, new, old) in one call
compare two designs on one card.

``python3 chip_smoke.py --launch-only`` runs phase 1's build and phase
13's launcher part alone (``launch_phase``, on a gmm of one epoch trained
for it): on a host with several cards, the quick check that the entry
points run over every card and agree with card 0.

Phases (each fatal on failure):
  1. device check; build the kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and each kernel's ptxas
     register/spill lines;
  2. hold each kernel (K1 ik_window, K2 arm_stage, K3 contact phase, K4
     feedforward) against its plain PyTorch version on the card, at
     main-path shapes: B = 8192 envs, a 35-substep window, the pushing
     scene, inputs from a real reset + 2 steps; K4 runs on K1's own window,
     at [7, 8192] and folded to [7, 35 * 8192], and is also held against
     K1's tau_model; K3's general variant on a 66-row scene cut from the
     same inputs (timed, with ``k3_report``'s figures); print the scaled
     errors against the tolerances and the
     median kernel / plain times (CUDA events around one launch on an idle
     device: ``ms``, which includes the host's submission of the launch;
     and with a sleep kernel queued ahead, so that the events bracket
     device time alone: ``device_ms``); then hold K1-K3 again at the
     evaluation path's own shapes: B = 480 (not a multiple of the block
     sizes), the inputs of one real substep of the 480-episode rollout
     under full dynamics and one in kinematic mode (zero arm inverse mass,
     plain-FK frames, finite-difference velocity), and time K1-K3 there
     (dynamic); time K1's set-up launch (B = 1, the 4000-update window that
     PushingParams() runs); outside --kernels-only, time K1 at each lane
     count it is built for on the B = 8192, the B = 480 and the set-up
     inputs;
  3. drive the env path: PushingParams() at full width, reset of 8192
     seeded contexts, 8 hold steps then 10 steps pushing toward the red
     box; check the state, the resting boxes, the tcp tracking and that
     each kernel's launch count, read right after the last step, matches
     the window structure; print env-steps/s with the card's name and power
     limit; then launch K4 on the window of the next push step and hold it
     to K1's tau_model (counted apart from the path's launches); one push
     step profiled through utils/logging.profile_trace, its Chrome trace
     written under build/chip_smoke/trace (fatal if none appears) with the
     seconds the export adds;
  4. drive the evaluation path: train a gmm agent at the registry's defaults
     on data/pushing (epochs cut to EVAL_EPOCHS), save it, reload it, and
     roll out the
     reference workload of 30 contexts x 16 trajectories (480 episodes in
     lockstep) under full arm dynamics and in kinematic mode, at a cut
     horizon; check finiteness, the frozen episodes, the +-0.01 m setpoint
     clip, the metrics' range, the launch counts and that a bc rollout
     repeats exactly; print success rate, entropy, score, seconds and
     episode-steps/s;
  5. the rod tasks: avoiding, aligning and sorting with 2, 4 and 6 boxes,
     each with its Params() at full width (35 substeps, the scene's solver
     iterations, full arm dynamics); its 480-episode evaluation batch
     (avoiding: 1 x 480 from its one empty context, its arms then set into
     the first obstacle; the others 60 contexts x 8 from the reset's
     initial scene through ROD_CHECK_SUBSTEPS hold substeps, aligning on
     its shipped contexts), then K3 held against its plain version on the
     next substep's inputs (avoiding: the register variant with no free
     body, nf = 0; the others: the general variant), K2 too on avoiding,
     aligning and sorting_2 (one per start pose), K3 timed there with its
     bound and roofline share; on a general scene ``k3_report``: the
     active contacts per env, the envs each path of the compact variant
     takes, the bound over every row and over the active rows with the
     roofline share against each, envs per block, blocks per SM and waves;
     on PATHS_SCENE (sorting_6) also the held batch cut so that its envs
     take every path, the global workspace included
     (``compact_paths_kernel``: held, timed, f exactly 0 on every inactive
     contact); on avoiding, a failure unless the rod's row
     against the first obstacle carries force in 99 % of the envs; a gmm agent trained on the card on
     data/<task> (epochs cut to ROD_EPOCHS) and rolled out through the
     task's Sim in both modes at a cut horizon (its steps timed apart from
     the reset); checks of finiteness, the frozen episodes, the setpoint
     clip, the metrics' range, the launch counts (K1 = steps, K2 and K3 =
     35 x steps + the reset's hold substeps, no K2 in kinematic mode) and,
     on aligning and sorting_2, a bc rollout that repeats exactly; prints
     episode-steps/s and one profiled dynamic step per task (device busy
     share, launches per substep, K3's device time in the step);
  6. stacking: StackingParams() at full width (30 substeps, 40 solver
     iterations, the gripper chain), its 1,080-episode batch (60 shipped
     contexts x 18) reset with each red box then pressed by a finger's tip
     pad, K2 held with the grasp law on (width 0, grasp flag set) and K3's
     general variant held and timed on the first substep of a joint-window
     hold, a failure unless a finger-box row carries force in 99 % of the
     envs; a gmm agent trained at window 5 (epochs cut to STACK_EPOCHS) and
     rolled out through StackingSim's joint-space rollout in both modes at
     a cut horizon; the checks of phase 5 but the setpoint clip (the joint
     rollout has none), the KL beside success and entropy, launch counts
     K1 = 0, K2 and K3 = 30 x steps + 5 (the reset's joint substeps), no K2
     in kinematic mode; one profiled dynamic step;
  7. inserting, the largest scene (78 pairs, 810 rows, nv 27): the rod task
     of phase 5 on InsertingParams() at full width and its Sim's 30 x 8
     reference workload (240 episodes, contexts from seed 2), the hold scene
     the reset with each env's rod pressing its red box 1 mm into a maze
     wall (``rod_pressing_box``): K1 (the window of a setpoint 1 cm
     further toward the wall), K2 and K3's general variant held, K3 timed
     with ``k3_report``'s figures, a failure unless the box-wall row carries
     force in 99 % of the envs; gmm trained INSERT_EPOCHS epochs on
     data/inserting and rolled out INSERT_STEPS_DYNAMIC dynamic and
     INSERT_STEPS_KINEMATIC kinematic steps with phase 5's checks; one
     profiled dynamic step;
  8. the agents: each of AGENTS (gpt_bc, bet, bet_mlp, act, cvae, lstm_gmm,
     ibc, ddpm, ddpm_encdec, beso) at its registry defaults (beso with
     pushing's agent_kw: the GPT backbone at window 5) trained on the card
     on data/pushing for AGENT_EPOCHS epochs, saved and reloaded through the
     entry points' functions, and rolled out AGENT_STEPS dynamic steps of
     PushingSim's 30 x 16 episodes (K1, K2 and K3's register variant under
     every policy); checks of finite actions and state, the metrics' range
     and the launch counts; prints train seconds, episode-steps/s and the
     finite share of the actions; then beso takes SAMPLER_STEPS dynamic
     step of the 480 episodes under each of its 14 samplers (finite actions
     and state, launch counts; the denoiser's calls counted by a wrapper
     here, which gives dpm_adaptive's loop iterations and whether it
     reached its 64-iteration fuse); one ``agents`` JSON line;
  9. demo generation: each runner family of data/experts.py in gen_demos'
     default mode on the Params() phases 3 and 5-7 built (avoiding,
     pushing, aligning, sorting_2 and inserting kinematic, stacking and
     pushing again under full dynamics), DEMO_N = 60 contexts from the
     port's sample_context, 4 steps (inserting 2) in chunks of 2 through
     run_chunked, every tenth env marked done from the start; checks of
     finite state and logs, the marked envs frozen in every leaf, the rod
     tasks' setpoint moves within +-0.011 m per axis, the launch counts (K1
     = steps but on stacking, K2 = substeps x steps + the reset's hold
     substeps under full dynamics and 0 kinematic, K3 = substeps x steps +
     the reset's hold substeps), every env's logs written as episodes by
     gen_demos.write under build/chip_smoke/demos/<task> and loaded back by
     the dataset loader and the task's assemble at the spec's dims; then
     one more step from the run's end, instrumented: each expert call timed
     alone between CUDA synchronizes, and the inputs of K1-K3's last calls
     kept, on which each kernel the case launches is held against its
     plain version (K1 on DEMO_K1_CASE, K2 under full dynamics, K3 on
     all) at the tolerances of phase 2; prints episode-steps/s (of the
     uninstrumented run), the expert step's share of the instrumented step
     and the launches, then one ``demos`` JSON line;
 10. vision on VISION_TASK (sorting_2) at full width, its Params() from
     phase 5 and its 60 x 8 = 480 episodes: both cameras at 96 x 96 of the
     batch after a reset, checked (values in [0, 1], each box colour seen
     by the bp camera in every env, the inhand view following the tcp (a
     box in view with the tcp 8 cm beside it), VISION_CPU_ENVS envs rendered on the CPU agreeing with the
     card's on 99.8 % of pixels within 1e-5) and timed; bc_vision at its
     registry defaults trained on data/sorting_2 through run_vision_torch's
     functions (VISION_EPOCHS epochs of VISION_STEPS_PER_EPOCH steps, one
     rollout selection eval at the end), saved, reloaded through
     run_eval_torch.load_agent and rolled out VISION_STEPS_DYNAMIC dynamic
     + VISION_STEPS_KINEMATIC kinematic steps, K2 and K3 held on the
     inputs of their last calls there at the tolerances of phase 2; then
     each of VISION_AGENTS trained VISION_AGENT_TRAIN_STEPS steps, reloaded
     and rolled out
     VISION_AGENT_STEPS dynamic step; per agent: parameters, train
     seconds, episode-steps/s, render, encoder-forward and policy-step ms
     at B = 480 (CUDA events), peak device memory in training and in the
     rollout; checks of finite actions and state, the frozen episodes,
     the setpoint clip, the metrics' range and the launch counts (K1 =
     steps, K2 = 35 x steps + the reset's 60 hold substeps under full
     dynamics and 0 kinematic, K3 = 35 x steps + 60); one ``vision`` JSON
     line;
 11. the per-env API: PER_ENV_ENVS envs of phase 3's batch after its last
     push step (those whose rod carries force first; fatal unless one
     does), each run alone through envs/common._run_substeps_single on
     the next window's setpoint (K1 and K3 at a batch of one, the arm's
     dynamics in plain PyTorch), then the batched window of the same envs
     (K1, K2 and K3 at B = PER_ENV_ENVS); per-env held against batched
     (every scene field to PER_ENV_TOL max-scaled, the controller state to
     PER_ENV_CS_TOL), launches per env-window K1 1, K2 0, K3 35, and the
     batched window's K1 1, K2 35, K3 35; K1 and K3 timed at B = 1 on the
     inputs of their last per-env calls, K3 held there against its plain
     version;
 12. the benchmark sweep: ``run_benchmark_torch.py`` with SWEEP_ARGS
     (avoiding, gmm, seed 0, 1 epoch, 16 episodes of 2 steps) in a
     subprocess into build/chip_smoke/sweep, run again (it must skip the
     recorded row: ``[done]``), then tools/make_results.py on its rows;
     checks of the row's schema (the JAX package's keys, wall_seconds
     and ranks), device cuda, ranks every visible card, the metrics' range
     and that the rendered table holds the row;
 13. the data-parallel path: a process group of one rank started by
     parallel/distributed.initialize_from_env from the D3IL_* variables
     (fatal unless its backend is NCCL); one push step of phase 3's batch
     through parallel/mesh.run_sharded held against the direct step on the
     same state (DP_TOL max-scaled; launches K1 1, K2 35, K3 35), one bc
     epoch on data/pushing with the mesh against one without (same
     history, weights to DP_TOL), phase 4's gmm through PushingSim at
     DP_SIM_STEPS dynamic steps with the mesh against without (same
     metrics, final states to DP_TOL); the seconds of each; the group
     destroyed; then the entry points' launcher
     (parallel/distributed.run_on_local_devices, ``launch_phase``):
     run_train_torch.main on a bc row (LAUNCH_EPOCHS on data/pushing,
     --skip-eval) in this process at one rank against run_one called
     directly (weights and losses bitwise equal; on one card this holds
     main's path, not the spawn / NCCL code); where two or more cards are
     visible, run_train_torch.py on that row and run_eval_torch.py on its
     checkpoint as subprocesses over every card against
     CUDA_VISIBLE_DEVICES=0 (weights LAUNCH_W_TOL, losses
     LAUNCH_LOSS_RTOL, one log file, the rows' ranks, the same metrics)
     and the PushingSim grid at DP_SIM_STEPS dynamic steps over
     LAUNCH_RANKS NCCL ranks against one, under the bc row's weights
     (final states to DP_TOL, the same metrics) and phase 4's gmm (finite,
     metrics in range; not held row for row: each rank draws its policy's
     noise from its own generator), with rank 0's launches; else the line
     "phase 13: ranks 1 (one card visible)";
 14. print the ``kernels`` JSON line (with ``design``, the PR whose design
     each kernel is, ``device_ms``, the B = 480 times and bounds of K1-K3,
     ``launches_demos``, ``launches_vision`` (phase 10's rollouts; on the
     K3 rows, sorting_2's alone), ``launches_per_env`` (phase 11's per-env
     windows, K1-K4 rows), ``launches_data_parallel`` (phase 13's sharded
     step, K1-K4 rows), and one K3 row per scene of phases 5-7,
     a general scene's with ``k3_report``'s figures),
     the card line, and last {"ok": true, "device": {...}}.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8192
# 8 hold steps (two fewer than push steps: they give back the time the
# profile trace's export takes in phase 3) then 10 push steps
HOLD_STEPS, PUSH_STEPS = 8, 10
EVAL_CONTEXTS, EVAL_TRAJS = 30, 16      # the reference workload: 480 episodes
EVAL_STEPS_DYNAMIC, EVAL_STEPS_KINEMATIC = 10, 4     # of the task's 400
REPEAT_STEPS = 5                        # bc determinism rollouts (kinematic)
ROLLOUT_CHECK_STEPS = 6     # push steps before the B = 480 substep checks
ROD_TASKS = ("avoiding", "aligning", "sorting_2", "sorting_4", "sorting_6")
# their reference workloads, contexts x trajectories: 480 episodes each
ROD_WORKLOADS = {"avoiding": (1, 480),  # no context: one empty context
                 "inserting": (30, 8)}
ROD_CONTEXTS, ROD_TRAJS = 60, 8         # the others
# training epochs are cut to what shows each agent's training working;
# the rollouts test the trained weights' path, not their quality, and the
# whole run has to stay well within the chip check's limit on a slow host
EVAL_EPOCHS = 20                        # phase 4's gmm, of the registry's 100
ROD_EPOCHS = 2                          # of the registry's 100
ROD_STEPS_DYNAMIC, ROD_STEPS_KINEMATIC = 2, 2   # of 400 (aligning), 700
# hold substeps from a reset's initial scene before the B = 480 substep
# checks, where the contacts carry force: aligning's tray has fallen the
# 9 mm onto the table, sorting's boxes are still inside the platform
ROD_CHECK_SUBSTEPS = {"aligning": 50, "sorting_2": 3, "sorting_4": 3,
                      "sorting_6": 3}
ROD_REPEAT_TASKS = ("aligning", "sorting_2")   # bc determinism rollouts
# K2 is held once per distinct arm state: the arm sees no box, so the
# sorting scenes start it alike and only the start pose tells them apart;
# avoiding's arms are set into the obstacle
ROD_K2_TASKS = ("avoiding", "aligning", "sorting_2", "inserting")
ROD_REPEAT_STEPS = 1
STACK_CONTEXTS, STACK_TRAJS = 60, 18    # stacking's reference workload: 1,080
STACK_EPOCHS = 1                        # of the registry's 100
STACK_STEPS_DYNAMIC, STACK_STEPS_KINEMATIC = 2, 2   # of 1,000
INSERT_EPOCHS = 2                       # of the registry's 100
INSERT_STEPS_DYNAMIC, INSERT_STEPS_KINEMATIC = 2, 2   # of InsertingSim's 400
# the agents driven on the pushing evaluation path at their registry
# defaults, beside gmm (phase 4)
AGENTS = ("gpt_bc", "bet", "bet_mlp", "act", "cvae", "lstm_gmm", "ibc",
          "ddpm", "ddpm_encdec", "beso")
AGENT_EPOCHS = 2                        # of the registry's 100
AGENT_STEPS = 2                         # dynamic steps of PushingSim's 400
SAMPLER_STEPS = 1       # dynamic steps of the 480 episodes per beso sampler
# demo generation (phase 9): each runner family in gen_demos' default mode
# (stacking and the second pushing case under full dynamics), B = 60 (--n's
# default), a cut horizon in chunks of DEMO_CHUNK steps; every
# DEMO_FROZEN_EVERY-th env starts marked done, to be held frozen
DEMO_N = 60
DEMO_CASES = (("avoiding", True, 4), ("pushing", True, 4),
              ("aligning", True, 4), ("sorting_2", True, 4),
              ("inserting", True, 2), ("stacking", False, 4),
              ("pushing", False, 4))
DEMO_CHUNK = 2
DEMO_FROZEN_EVERY = 10
# K1's plain version is a host loop of ~6 s at any batch: K1 is held on the
# demo inputs of one case (K2 and K3 on every case that launches them)
DEMO_K1_CASE = ("pushing", False)
# the vision path (phase 10) on sorting_2's 60 x 8 = 480 episodes: bc_vision
# at its registry defaults (96 x 96 images) through run_vision_torch's
# functions, cut to VISION_EPOCHS epochs of VISION_STEPS_PER_EPOCH minibatch
# steps (of 100 epochs x 40 steps at batch 512) with one selection eval at
# the end (VISION_SELECT: contexts, trajectories, dynamic steps), then
# rolled out; the nine other vision agents trained VISION_AGENT_TRAIN_STEPS
# steps and rolled out VISION_AGENT_STEPS dynamic steps
VISION_TASK = "sorting_2"
VISION_EPOCHS, VISION_STEPS_PER_EPOCH = 2, 10
VISION_SELECT = (2, 2, 2)
VISION_STEPS_DYNAMIC, VISION_STEPS_KINEMATIC = 2, 2
VISION_AGENTS = ("ddpm_vision", "bet_mlp_vision", "gmm_vision",
                 "cvae_vision", "beso_vision", "act_vision", "gpt_bc_vision",
                 "ibc_vision", "ddpm_encdec_vision")
VISION_AGENT_TRAIN_STEPS = 5
VISION_AGENT_STEPS = 1
VISION_CPU_ENVS = 8     # views rendered on the CPU too, held to the card's
# the Params() each scene's phase built (3, 5-7), reused by the demo phase
SCENE_PARAMS = {}
# ptxas's registers per thread of each kernel, from phase 1's build log
PTXAS_REGS = {}
# the scenes of K3's general variant, on which phases 5-7 hold it
# (--kernels-only holds and times K3 on each alone)
GENERAL_SCENES = ("aligning", "sorting_2", "sorting_4", "sorting_6",
                  "stacking", "inserting")
# the scene whose held batch is also cut into every path of the compact
# variant, the global workspace included (``compact_paths_kernel``)
PATHS_SCENE = "sorting_6"
# the per-env phase: envs of the main path's batch after its last push
# step, each run one at a time through the per-env window and held against
# the batched window of the same envs; every scene field max-scaled to
# PER_ENV_TOL (K2's qd_pre hold: the per-env arm runs plain dynamics), the
# controller state to PER_ENV_CS_TOL (K1's q_virt hold)
PER_ENV_ENVS = 4
PER_ENV_TOL = 1e-3
PER_ENV_CS_TOL = 3e-5
# the sweep phase: one benchmark row through run_benchmark_torch.py
SWEEP_ARGS = ("--tasks", "avoiding", "--agents", "gmm", "--seeds", "0",
              "--epochs", "1", "--n-trajs", "16", "--eval-max-steps", "2")
# the data-parallel phase (13): NCCL at world size 1; phase 3's push step,
# DP_FIT_EPOCHS of bc on data/pushing and phase 4's gmm PushingSim at
# DP_SIM_STEPS dynamic steps, each with the mesh against without, held to
# DP_TOL max-scaled (equal where the kernels repeat bitwise)
DP_FIT_EPOCHS = 1
DP_SIM_STEPS = 2
DP_TOL = 1e-5
# phase 13's launcher (parallel/distributed.run_on_local_devices): a bc row
# of run_train_torch.main (LAUNCH_EPOCHS on data/pushing, --skip-eval) at
# one rank against run_one called directly (bitwise); where two or more
# cards are visible, run_train_torch.py and run_eval_torch.py over every
# card against card 0 (weights to LAUNCH_W_TOL absolute, losses to
# LAUNCH_LOSS_RTOL relative: the JAX test's bars,
# tests/test_parallel.py:73-109), and the PushingSim grid at DP_SIM_STEPS
# dynamic steps over LAUNCH_RANKS NCCL ranks against one (final states to
# DP_TOL, tests/test_parallel.py:54-57)
LAUNCH_EPOCHS = 1
LAUNCH_RANKS = 2
LAUNCH_W_TOL = 2e-4
LAUNCH_LOSS_RTOL = 2e-4
SM_SHARED_BYTES = 233472    # H100 shared memory per SM (228 KB)
BLOCK_RESERVED_BYTES = 1024     # shared memory CUDA reserves per block
PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def log(msg):
    print(msg, flush=True)


def ptxas_entries(text):
    """{kernel: (registers line, stack/spill line)} from an nvcc -Xptxas -v
    log, kernels named from their mangled names (template argument kept)."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        if props == entry and entry and "spill" in line:
            out.setdefault(entry, ["", ""])[1] = line.strip()
        if entry and "Used" in line and "registers" in line:
            out.setdefault(entry, ["", ""])[0] = line.split(":", 1)[-1].strip()
            entry = None
    named = {}
    for mangled, v in out.items():
        m = re.match(r"_Z(\d+)(\w+)", mangled)
        n = int(m.group(1))
        name, rest = m.group(2)[:n], m.group(2)[n:]
        t = re.match(r"ILi(\d+)E", rest)
        named[name + (f"<{t.group(1)}>" if t else "")] = tuple(v)
    return named


SLEEP_CYCLES = 2_000_000    # ~1 ms of device time queued ahead of a launch


def cuda_ms(fn, reps, queued=False, warm=True):
    """Median of ``reps`` CUDA-event timings of one fn() (after a warm-up
    call, unless ``warm`` is false: the caller has just run fn).
    Without ``queued`` the device is idle at the first event, so the bracket
    also holds the host's submission of fn's launches (the wrapper's checks,
    allocations and the ctypes call). With ``queued`` a sleep kernel is
    enqueued first, so the host has submitted them before the device reaches
    the first event and the events bracket device time alone."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def count_ops(fn, *args):
    """Floating-point operations the plain version performs on these
    inputs: numel of every arithmetic op's result (of its input for
    reductions), 2 m n k for matrix products; data movement counts 0."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    move = {"view", "_unsafe_view", "expand", "permute", "transpose", "t",
            "select", "slice", "unsqueeze", "squeeze", "as_strided",
            "reshape", "alias", "detach", "clone", "copy_", "_to_copy",
            "cat", "stack", "empty", "zeros", "ones", "full", "zeros_like",
            "ones_like", "full_like", "empty_like", "new_zeros", "new_ones",
            "new_empty", "new_full", "scalar_tensor", "lift_fresh", "index",
            "gather", "scatter", "unbind", "split", "repeat_interleave",
            "contiguous", "lift_fresh_copy", "_local_scalar_dense",
            "fill_", "zero_", "movedim", "split_with_sizes", "index_select",
            "repeat", "new_empty_strided", "empty_strided", "eye",
            "arange", "linspace", "_to_dim_order_copy", "slice_scatter",
            "select_scatter", "unfold", "diagonal", "flip", "roll"}
    reduce_ = {"sum", "amin", "amax", "mean", "linalg_vector_norm", "max",
               "min", "prod"}

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                a, b2 = args[-2], args[-1]
                Counter.ops += 2 * a.numel() * b2.shape[-1]
            elif name in move:
                pass
            elif name in reduce_:
                Counter.ops += args[0].numel()
            else:
                outs = out if isinstance(out, (tuple, list)) else [out]
                Counter.ops += sum(o.numel() for o in outs
                                   if isinstance(o, torch.Tensor)
                                   and o.is_floating_point())
            return out

    with Counter():
        fn(*args)
    return Counter.ops


def ik_window_ops(spec, n_sub, ins, plain):
    """Operations K1's function needs on these inputs (q_virt, old_vel,
    des_pos, des_quat): ``plain``, the plain version's count on them
    (count_ops), less what it forms twice
    or never reads. Each substep after the first composes fk(q_virt) and
    its dof frames again, which its predecessor's RNEA formed at the same
    q; each convergence gate repeats the first IK iteration's pose error;
    each later IK iteration's FK composes the bodies off the path to the
    grasp target (the fingers), which nothing reads before the next FK."""
    from d3il_tpu_torch.engine import dyn_kernel
    from d3il_tpu_torch.engine import dyn_scalar as dsc
    chain = spec.ctrl_chain
    ee = chain.body_index("panda_grasptarget")
    q = [ins[0][i] for i in range(chain.nv)]
    dp = tuple(ins[2][k] for k in range(3))
    dq = dsc.qnormalize(tuple(ins[3][k] for k in range(4)))
    xpos, xquat = dsc.fk_s(chain, q)
    path, b = set(), ee
    while b >= 0:
        path.add(b)
        b = int(chain.parent[b])
    off_path = [b for b in range(chain.nb) if b not in path]
    assert all(int(chain.joint_type[b]) not in (dsc.HINGE, dsc.SLIDE)
               for b in off_path)

    def gate():         # cart_step_s's gate, as far as iteration 0 forms it
        cq = xquat[ee]
        d_minus = sum((cq[k] - dq[k]) ** 2 for k in range(4))
        d_plus = sum((cq[k] + dq[k]) ** 2 for k in range(4))
        flip = dsc._where(d_minus > d_plus, -1.0, 1.0)
        dsc.vsub(dp, xpos[ee])
        dsc.quat_error_s(cq, tuple(dq[k] * flip for k in range(4)))

    def off_path_composes():        # fk_s on a welded body
        for b in off_path:
            p = int(chain.parent[b])
            dsc.qmul(xquat[p], tuple(float(v) for v in chain.body_quat[b]))
            dsc.vadd(xpos[p], dsc.qrot(
                xquat[p], tuple(float(v) for v in chain.body_pos[b])))

    twice = (count_ops(lambda: dsc.fk_s(chain, q))
             + count_ops(lambda: dsc.dof_frames_s(chain, xpos, xquat)))
    later_iters = int(spec.gains.num_iter) - 1
    return (plain - (n_sub - 1) * twice - n_sub * count_ops(gate)
            - n_sub * later_iters * count_ops(off_path_composes))


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def hold_action(tcp):
    """bench.py's hold action: the tcp's xy, z 0.12, the rod pointing down."""
    import torch
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=tcp.device)
    return torch.cat([tcp[:, :2], torch.full_like(tcp[:, :1], 0.12),
                      down.expand(tcp.shape[0], 4)], dim=1)


def push_action(state, hold):
    """The hold action moved onto the red box's xy."""
    import torch
    return torch.cat([state.scene.free_pos[:, 0, :2], hold[:, 2:]], dim=1)


def profile_step(params, state, hold, trace_dir):
    """One push step under torch.profiler, through
    utils/logging.profile_trace: device busy time against the step's wall
    time, launches by kind, and the kernels that take the most device time;
    the Chrome trace written under ``trace_dir`` (fatal if none appears),
    with the seconds its export adds. Prints "not measured" when the trace
    has no device time."""
    import shutil
    import torch
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.utils import logging as run_logging
    shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t_block = time.perf_counter()
    with run_logging.profile_trace(trace_dir) as prof:
        t0 = time.perf_counter()
        pushing.step(params, state, push_action(state, hold))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        t_stop = time.perf_counter()
    t_export = time.perf_counter() - t_stop
    traces = [f for f in (os.listdir(trace_dir) if os.path.isdir(trace_dir)
                          else []) if f.endswith(".pt.trace.json")]
    if not traces:
        raise SystemExit(f"profile_trace wrote no trace under {trace_dir}")
    size = os.path.getsize(os.path.join(trace_dir, traces[0]))
    log(f"profile trace: {traces[0]} ({size / 2**20:.1f} MiB) under "
        f"{os.path.relpath(trace_dir, ROOT)}; the profiled block "
        f"{time.perf_counter() - t_block:.2f} s, of which the trace's "
        f"export {t_export:.2f} s")
    dev = device_events(prof)
    busy_us = sum(us for _, us in dev)
    if not dev or busy_us <= 0:
        log("profile: not measured (the trace holds no device time)")
        return
    by_name = top_device_time(dev)
    memcpy = sum(n for name, (n, _) in by_name.items()
                 if "memcpy" in name.lower())
    log(f"profile of one push step: wall {wall_us / 1e3:.1f} ms (profiler "
        f"on), device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), "
        f"{len(dev)} device activities of which {memcpy} memcpy")


def device_events(prof):
    """(name, us) of every device activity a finished torch.profiler
    session recorded, read from its raw results: the profiler's
    FunctionEvents, built in Python for each of up to a quarter of a
    million events, take seconds."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def top_device_time(dev, k=8):
    """Device time and count by kernel name over (name, us) pairs ``dev``;
    prints the ``k`` largest. Returns {name: (count, us)}."""
    by_name = {}
    for name, us in dev:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]
    for name, (n, t) in top:
        log(f"  {t / 1e3:9.3f} ms {n:6d}x  {name[:90]}")
    return by_name


def leaves(tree):
    """Tensor leaves of nested (Named)tuples."""
    import torch
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for x in tree for leaf in leaves(x)]


class Watch:
    """Per-step observer of a rollout, free of host syncs: the largest
    per-axis move of the setpoint between steps (the xy or xyz setpoint;
    stacking's joint setpoint and width), and whether every state leaf
    stayed finite."""

    def __init__(self, device):
        import torch
        self.prev = None
        self.max_delta = torch.zeros((), device=device)
        self.finite = torch.ones((), dtype=torch.bool, device=device)

    def __call__(self, carry):
        import torch
        state, _, pos, obs = carry[:4]
        if self.prev is not None:
            self.max_delta = torch.maximum(self.max_delta,
                                           (pos - self.prev).abs().max())
        for x in leaves(state) + [pos, obs]:
            if x.is_floating_point():
                self.finite = self.finite & torch.isfinite(x).all()
        self.prev = pos


class TimedReset:
    """A task's env module whose reset ends with a device synchronize and
    notes the host clock there, so that a rollout's steps are timed apart
    from its reset (and the reset's hold substeps)."""

    def __init__(self, env):
        self.env, self.done_at = env, None

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, params, context):
        import torch
        state = self.env.reset(params, context)
        torch.cuda.synchronize()
        self.done_at = time.perf_counter()
        return state


def eval_rollout(spec, agent, q_init, kinematic, steps, counters, card,
                 seed=0, watch=True, workload=(EVAL_CONTEXTS, EVAL_TRAJS)):
    """The task's Sim on ``workload`` (contexts x trajectories; pushing's
    reference workload, 30 x 16 episodes in lockstep, by default) for
    ``steps`` env steps with the kernel counts zeroed just before and read
    just after. Returns (final state, dones, metrics, launches, seconds of
    the steps, seconds of the reset, Watch)."""
    import torch
    params = spec.make_params(kinematic=kinematic, max_steps=steps,
                              device="cuda", q_init=q_init)
    sim = spec.make_sim(seed=seed, n_contexts=workload[0],
                        n_trajectories_per_context=workload[1])
    env = TimedReset(sim.env())
    sim.env = lambda: env
    w = Watch(params.device) if watch else None
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, dones = sim.run_episodes(agent, params, on_step=w)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k: fn.launches for k, fn in counters.items()}
    return (state, dones, sim.score(state), launches, t1 - env.done_at,
            env.done_at - t0, w)


def profile_eval_step(spec, agent, q_init, card):
    """Where one evaluation step at B = 480 goes: host-clock times (each
    ending in a synchronize) of the policy forward and the env step against
    the whole rollout body, then the body once under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.eval import rollout, sims
    params = spec.make_params(kinematic=False, max_steps=400, device="cuda",
                              q_init=q_init)
    n = EVAL_CONTEXTS * EVAL_TRAJS
    ctxs = sims._fixed_or_sampled(sims.ref_contexts.pushing_contexts,
                                  pushing.sample_context, EVAL_CONTEXTS, True,
                                  params.device)
    cidx = sims._grid(EVAL_CONTEXTS, EVAL_TRAJS, params.device)
    apply = agent.policy_apply(sims.policy_generator(0, params.device))
    init, body = rollout.make_rod_stepper(params, pushing.reset, pushing.step,
                                          pushing.get_observation, apply)

    def timed(fn, reps=3):
        out = fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), out

    with torch.no_grad():
        carry = init(agent.init_carry(10, n), tuple(x[cidx] for x in ctxs))
        for _ in range(2):
            carry = body(agent.params, carry)
        state, pc, pos, obs = carry[:4]
        obs_policy = torch.cat([pos, obs], dim=1)
        t_policy, (_, delta) = timed(
            lambda: apply(agent.params, pc, obs_policy))
        action = torch.cat([pos + delta.clamp(-0.01, 0.01), carry[5],
                            torch.tensor([0.0, 1.0, 0.0, 0.0],
                                         device=pos.device).expand(n, 4)], 1)
        t_step, _ = timed(lambda: pushing.step(params, state, action))
        t_body, _ = timed(lambda: body(agent.params, carry))
        log(f"eval step at B = {n} (host clock, median of 3): rollout body "
            f"{t_body:.1f} ms = policy forward {t_policy:.2f} ms + env step "
            f"{t_step:.1f} ms + rollout glue {t_body - t_policy - t_step:.2f} "
            f"ms [{card}]")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            body(agent.params, carry)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = device_events(prof)
    busy_us = sum(us for _, us in dev)
    if not dev or busy_us <= 0:
        log("eval step profile: not measured (the trace holds no device "
            "time)")
        return
    log(f"eval step profile at B = {n}: wall {wall_us / 1e3:.1f} ms "
        f"(profiler on), device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / wall_us:.1%}), {len(dev)} device activities [{card}]")
    top_device_time(dev)


def scaled_err(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()


def hold_kernel(k, card, failed, timed=True):
    """Hold one kernel's outputs (``k["out"]``, from its wrapper) against its
    plain version on the same inputs at the stated tolerances; with
    ``timed``, also time both and compute the bound. Failures are appended
    to ``failed``."""
    import torch
    ref = k["plain"]()
    torch.cuda.synchronize()
    errs = [scaled_err(a, b) for a, b in zip(k["out"], ref)]
    k["max_abs_err"] = max((a.double() - b.double()).abs().max().item()
                           for a, b in zip(k["out"], ref))
    if "f64" in k:
        floor = [scaled_err(a, b) for a, b in zip(ref, k["f64"]())]
        log(f"{k['key']} {k['name']}: floor (plain float32 vs float64) "
            + ", ".join(f"{n} {e:.3e}" for n, e in zip(k["names"], floor)))
    for name, e, tol in zip(k["names"], errs, k["tols"]):
        ok = e <= tol
        log(f"{k['key']} {k['name']}.{name}: scaled err {e:.3e} "
            f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{k['name']}.{name}")
    if not timed:
        return
    k["ms"] = cuda_ms(k["run"], k["reps"][0])
    k["device_ms"] = cuda_ms(k["run"], k["reps"][0], queued=True)
    # the hold above ran the plain version: it is warm
    k["plain_ms"] = cuda_ms(k["plain"], k["reps"][1], warm=False)
    # the operations the function needs: the plain version's, unless it
    # forms some twice (k["ops"], given the plain version's count)
    plain_ops = count_ops(k["plain"])
    ops = k["ops"](plain_ops) if "ops" in k else plain_ops
    byt = nbytes(k["ins"]) + nbytes(k["out"])
    k["bound_ms"], k["bound_by"] = bound_of(ops, byt)
    more = (f"; the plain version does {plain_ops:.3e}" if "ops" in k
            else "")
    if "meta" in k:     # K3 (``meta``: its scene): also each env's active
        act_ops, act_byt = active_work(k["meta"], k["ins"], k["out"])
        k["bound_active_ms"], k["bound_active_by"] = bound_of(act_ops,
                                                              act_byt)
        more = (f"; active rows {act_ops:.3e} flop, {act_byt:.3e} B, bound "
                f"{k['bound_active_ms']:.5f} ms ({k['bound_active_by']})")
    log(f"{k['key']} {k['name']}: kernel {k['ms']:.4f} ms (device "
        f"{k['device_ms']:.4f} ms), plain "
        f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.5f} ms "
        f"({k['bound_by']}: {ops:.3e} flop{more}, {byt:.3e} B) [{card}]")


def rollout_substep_kernels(spec, q_init, kinematic, tols):
    """K1-K3 on the inputs of one real substep of the evaluation rollout:
    the 30 x 16 reference episodes (B = 480) are reset, pushed toward the
    red box for ROLLOUT_CHECK_STEPS env steps, and the next step's window
    and first substep are formed as run_substeps_bm forms them, through the
    wrappers. Returns the kernel records for hold_kernel (no K2 in kinematic
    mode, which does not launch it)."""
    import torch
    from d3il_tpu_torch.engine import (contact_kernel, dyn_kernel,
                                       substep_bm)
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.eval import sims
    params = spec.make_params(kinematic=kinematic, device="cuda",
                              q_init=q_init)
    st, n_sub = params.statics, params.n_substeps
    ctxs = sims._fixed_or_sampled(sims.ref_contexts.pushing_contexts,
                                  pushing.sample_context, EVAL_CONTEXTS, True,
                                  params.device)
    cidx = sims._grid(EVAL_CONTEXTS, EVAL_TRAJS, params.device)
    state = pushing.reset(params, tuple(x[cidx] for x in ctxs))
    tcp, _ = params.tcp_pose(state.scene)
    hold = hold_action(tcp)
    for _ in range(ROLLOUT_CHECK_STEPS):
        state, _ = pushing.step(params, state, push_action(state, hold))
    push = push_action(state, hold)
    n = push.shape[0]
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    sb = substep_bm.scene_to_bm(state.scene)
    mode = "kinematic" if kinematic else "dynamic"
    k1_in = (bm(state.ctrl.q_virt), bm(state.ctrl.old_des_vel),
             bm(push[:, :3]), bm(push[:, 3:]))
    k1_out = dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in)
    recs = [dict(name=f"ik_window_b{n}_{mode}", key="K1", out=k1_out,
                 ins=k1_in, reps=(5, 1),
                 run=lambda: dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in),
                 plain=lambda: dyn_kernel.ik_window_plain(st.ik, n_sub,
                                                          *k1_in),
                 ops=lambda plain: ik_window_ops(st.ik, n_sub, k1_in, plain),
                 f64=lambda: dyn_kernel.ik_window_plain(
                     st.ik, n_sub, *(x.double() for x in k1_in)),
                 names=("q_virt", "old_vel", "q_des", "qd_des", "tau_model"),
                 tols=tols["K1"])]
    sw = torch.full((n,), 0.04, device=params.device)
    if kinematic:
        q_new, qd_new = substep_bm.kinematic_target(st, sb, k1_out[2][0], sw)
        sb = sb._replace(q=q_new.contiguous(), qd=qd_new.contiguous())
        arm_out = substep_bm.beam_arm_out(st, sb.q)
        if arm_out[4].shape != (9, 9, n) or arm_out[4].any().item():
            raise SystemExit("kinematic mode: Minv is not a zero [9, 9, B]")
    else:
        gf = torch.zeros(n, dtype=torch.bool, device=params.device)
        k2_in = (sb.q, sb.qd, k1_out[2][0], k1_out[3][0], k1_out[4][0], sw, gf)
        arm_out = dyn_kernel.arm_stage_bm(st.arm, *k2_in)
        recs.append(dict(
            name=f"arm_stage_b{n}_{mode}", key="K2", out=arm_out, ins=k2_in,
            run=lambda: dyn_kernel.arm_stage_bm(st.arm, *k2_in),
            reps=(20, 3),
            plain=lambda: dyn_kernel.arm_stage_plain(
                st.arm, *k2_in[:6], k2_in[6].to(torch.float32)),
            names=("xpos", "xquat", "axes", "anchors", "Minv", "qd_pre",
                   "a_arm"), tols=tols["K2"]))
    k3_in = substep_bm.contact_inputs(st, sb, arm_out)
    k3_out = contact_kernel.phase_batched_bm(st.contact, *k3_in)
    active = (k3_in[2] > 0).float().sum(0).mean().item()
    rod = (k3_out[0][12:14].abs().amax(dim=(0, 1)) > 0).float().mean().item()
    log(f"rollout substep ({mode}, B = {n}, after {ROLLOUT_CHECK_STEPS} push "
        f"steps): {active:.1f} contacts with depth > 0 per env, rod-box contact "
        f"force in {rod:.1%} of envs, max |v_all| {k3_in[6].abs().max():.3f}")
    recs.append(dict(name=f"contact_phase_b{n}_{mode}", key="K3", out=k3_out,
                     ins=k3_in, reps=(20, 3), meta=st.meta,
                     run=lambda: contact_kernel.phase_batched_bm(st.contact,
                                                                 *k3_in),
                     plain=lambda: contact_kernel.phase_plain(st.meta, *k3_in),
                     names=("f", "qfrc"), tols=tols["K3"]))
    return recs


def general_scene_kernel(st, k3_in, tols):
    """K3's general variant, which takes scenes of more than 56 rows: a
    66-row scene made of pushing's 18 contacts and 4 of them again, on the
    main path's inputs cut the same way."""
    import torch
    from d3il_tpu_torch.engine import contact, contact_kernel
    idx = list(range(st.meta.ncon)) + [12, 13, 5, 6]
    meta = contact.select_contacts(st.meta, idx)
    tables = contact_kernel.ContactTables(meta, k3_in[0].device)
    geo = k3_geometry(tables, k3_in[0].shape[-1])
    if geo.variant != 2:
        raise SystemExit(f"a 66-row scene should take the general variant: "
                         f"{geo}")
    t = torch.as_tensor(idx, device=k3_in[0].device)
    ins = tuple(a[t].contiguous() if i in (0, 1, 2, 10) else a
                for i, a in enumerate(k3_in))  # pts, normal, depth, warm
    run = lambda: contact_kernel.phase_batched_bm(tables, *ins)
    return dict(name="contact_phase_66_rows", key="K3", report=False,
                tables=tables, meta=meta, out=run(), ins=ins, run=run,
                reps=(20, 3),
                plain=lambda: contact_kernel.phase_plain(meta, *ins),
                names=("f", "qfrc"), tols=tols)


def k3_geometry(tables, B):
    """K3's launch geometry for a batch of B envs: ContactTables.geometry
    is a method of the batch since the compact design, an attribute of the
    scene before it (a checkout of an earlier commit)."""
    g = tables.geometry
    return g(B) if callable(g) else g


def bound_of(n_ops, n_bytes):
    """(ms, "operations" or "bytes"): the least time for n_ops float32
    operations and n_bytes moved, the larger of the two."""
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def active_work(meta, ins, out):
    """(operations, bytes) of K3 on each env's active contacts (depth >
    0) alone, summed over the batch. Operations: the plain version's on
    each env's scene cut to them; the count depends on the shapes alone,
    so it is taken once per distinct active count, on the first env with
    that count; an env with none needs none. Bytes: depth, f and qfrc of
    every env, the per-env inputs of the envs with an active contact, and
    pts, normal and warm of the active contacts only."""
    import torch
    from d3il_tpu_torch.engine import contact, contact_kernel
    n_act = (ins[2] > 0).sum(0)
    B = n_act.shape[0]
    per_contact = (0, 1, 10)    # pts, normal, warm: [ncon, 3, B]
    byt = (nbytes((ins[2],) + tuple(out))
           + nbytes(ins[3:10]) * int((n_act > 0).sum()) // B
           + int(n_act.sum()) * sum(ins[i][0, :, 0].numel()
                                    * ins[i].element_size()
                                    for i in per_contact))
    total = 0
    counts = torch.bincount(n_act).tolist()
    for n, envs in enumerate(counts):
        if n == 0 or envs == 0:
            continue
        e = int(torch.nonzero(n_act == n)[0, 0])
        idx = torch.nonzero(ins[2][:, e] > 0)[:, 0]
        cut = [x[..., e:e + 1].contiguous() for x in ins]
        for i in (0, 1, 2, 10):     # pts, normal, depth, warm
            cut[i] = cut[i][idx].contiguous()
        meta_e = contact.select_contacts(meta, idx.cpu().numpy())
        total += envs * count_ops(
            lambda: contact_kernel.phase_plain(meta_e, *cut))
    return total, byt


def k3_residency(geo, B):
    """(blocks per SM, waves) of a K3 launch of B envs on this card: the
    fewest of what shared memory (with CUDA's reservation per block),
    ptxas's registers and the SM's warp and block limits allow."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    warps = geo.envs_per_block
    name = {1: "contact_phase_reg_kernel"}.get(
        geo.variant, "contact_phase_compact_kernel"
        if "contact_phase_compact_kernel" in PTXAS_REGS
        else "contact_phase_general_kernel")
    regs = PTXAS_REGS.get(name)
    per_sm = min(SM_SHARED_BYTES // (geo.smem_per_block
                                     + BLOCK_RESERVED_BYTES),
                 64 // warps, 32)
    if regs:    # registers are allocated per warp in units of 256
        per_sm = min(per_sm, 65536 // (-(-regs * 32 // 256) * 256 * warps))
    blocks = -(-B // warps)
    return per_sm, -(-blocks // (per_sm * n_sm))


def k3_report(k, tables, card):
    """For a K3 record held and timed by hold_kernel on a scene of the
    general variant: the active contacts per env (min / mean / max), the
    envs each path of the compact variant takes (none active, the register
    form's 56 rows, the factored form in shared memory up to the cap, the
    global workspace above it; "n/a" for a design without them), the
    bound both ways (every row, ``bound_ms``, and each env's active rows,
    ``bound_active_ms``) with the roofline share against each, and the
    launch's envs per block, blocks per SM and waves. Adds them to the
    record."""
    meta = tables.meta
    n_act = (k["ins"][2] > 0).sum(0)
    B = n_act.shape[0]
    geo = k3_geometry(tables, B)
    cap = getattr(geo, "cap", None)
    reg = (n_act > 0) & (3 * n_act <= 56)
    paths = {"none": int((n_act == 0).sum()), "register": int(reg.sum())}
    if cap is None:
        paths.update(shared="n/a", workspace="n/a")
    else:
        paths.update(shared=int(((3 * n_act > 56) & (n_act <= cap)).sum()),
                     workspace=int((n_act > cap).sum()))
    per_sm, waves = k3_residency(geo, B)
    k["active_contacts"] = dict(min=int(n_act.min()),
                                mean=float(n_act.float().mean()),
                                max=int(n_act.max()))
    k.update(paths=paths, cap=cap, envs_per_block=geo.envs_per_block,
             smem_per_block=geo.smem_per_block, blocks_per_sm=per_sm,
             waves=waves)
    a = k["active_contacts"]
    log(f"{k['key']} {k['name']} at B = {B}: active contacts per env "
        f"{a['min']} / {a['mean']:.2f} / {a['max']} of {meta.ncon} (min / "
        f"mean / max); envs per path {paths} (cap {cap}); kernel "
        f"{k['ms']:.4f} ms (device {k['device_ms']:.4f} ms); bound every "
        f"row {k['bound_ms']:.5f} ms ({k['bound_by']}), active rows "
        f"{k['bound_active_ms']:.5f} ms ({k['bound_active_by']}); "
        f"roofline share {k['bound_ms'] / k['device_ms']:.2%} / "
        f"{k['bound_active_ms'] / k['device_ms']:.2%}; "
        f"{geo.smem_per_env} B of shared memory per env, "
        f"{geo.smem_per_block} B per block, {geo.envs_per_block} envs per "
        f"block, {per_sm} blocks per SM, {waves} wave(s) [{card}]")


def compact_paths_kernel(k, tables, tols):
    """K3 on the held batch ``k`` cut so that its envs take every path of
    the compact variant: by env modulo 6, no active contact, one, five
    (the register form), the scene's own (the factored form in shared
    memory), exactly the cap (inactive contacts set to 1 mm depth), and
    every contact at 1 mm (above the cap: the global workspace). Returns
    the record for hold_kernel, timed (the workspace envs' chain bounds
    it)."""
    import torch
    from d3il_tpu_torch.engine import contact_kernel
    meta = tables.meta
    cap = getattr(k3_geometry(tables, k["ins"][2].shape[-1]), "cap",
                  meta.ncon // 2)
    depth = k["ins"][2].clone()
    for e in range(depth.shape[1]):
        act = torch.nonzero(depth[:, e] > 0)[:, 0]
        kind = e % 6
        if kind < 3:
            depth[act[(0, 1, 5)[kind]:], e] = -1e-3
        elif kind == 4:
            free = torch.nonzero(depth[:, e] <= 0)[:, 0]
            depth[free[:max(cap - len(act), 0)], e] = 1e-3
        elif kind == 5:
            depth[:, e] = 1e-3
    ins = k["ins"][:2] + (depth,) + k["ins"][3:]
    run = lambda: contact_kernel.phase_batched_bm(tables, *ins)
    out = run()
    launch = getattr(contact_kernel, "_launch", None)
    if launch is not None:
        # a launch into outputs filled with NaN first: every element,
        # inactive contacts' f included, must come from the kernel
        out = tuple(torch.full_like(o, float("nan")) for o in out)
        launch(tables, ins, *out)
    return dict(name=k["name"] + "_every_path", key="K3", out=out,
                ins=ins, run=run, reps=(5, 1), tables=tables, meta=meta,
                plain=lambda: contact_kernel.phase_plain(meta, *ins),
                names=("f", "qfrc"), tols=tols)


def hold_general_k3(k, card, failed):
    """hold_kernel (timed) and k3_report of a K3 record on a general
    scene; on PATHS_SCENE also its ``compact_paths_kernel`` batch, whose f
    must be exactly 0 on every inactive contact."""
    hold_kernel(k, card, failed)
    k3_report(k, k["tables"], card)
    if not k["name"].endswith("_" + PATHS_SCENE):
        return
    kp = compact_paths_kernel(k, k["tables"], k["tols"])
    hold_kernel(kp, card, failed)
    k3_report(kp, kp["tables"], card)
    zero = bool((kp["out"][0].movedim(1, -1)[kp["ins"][2] <= 0] == 0).all())
    log(f"{kp['key']} {kp['name']}: f exactly 0 on every inactive contact: "
        f"{zero}")
    if not zero:
        failed.append(f"{kp['name']}.inactive_f")


def setup_launch(params, card):
    """K1's set-up launch, as PushingParams() makes it: the window of
    RodTaskParams._null_converge (one env, NULL_CONVERGE_ITERS controller
    updates from the offline IK posture) on the inputs that method builds.
    Timed like the kernels (``ms`` bare, ``device_ms`` queued, median of
    3)."""
    from d3il_tpu_torch.engine import dyn_kernel
    from d3il_tpu_torch.envs import common
    ins = params.null_converge_window(params.start_ik(), params.init_ee_pos,
                                      params.init_ee_quat)
    n_sub = common.NULL_CONVERGE_ITERS
    run = lambda: dyn_kernel.ik_window_bm(params.statics.ik, n_sub, *ins)
    ms, dev_ms = cuda_ms(run, 3), cuda_ms(run, 3, queued=True)
    log(f"K1 set-up launch (B = 1, n_sub = {n_sub}): kernel {ms:.3f} "
        f"ms (device {dev_ms:.3f} ms) [{card}]")
    return ins, n_sub


def lane_sweep(spec, n_sub, ins, card):
    """K1's device time at each lane count it is built for, on ``ins``
    (the wrapper picks one by batch: engine/dyn_kernel.ik_window_geometry)."""
    from d3il_tpu_torch.engine import dyn_kernel
    B = ins[0].shape[-1]
    times = {g: cuda_ms(lambda: dyn_kernel.launch_ik_window(spec, n_sub, ins,
                                                            g), 5, queued=True)
             for g in dyn_kernel.IK_LANES}
    log(f"K1 lanes per env at B = {B}, n_sub = {n_sub} (device ms): "
        + ", ".join(f"{g}: {t:.4f}" for g, t in times.items())
        + f"; the wrapper takes "
        f"{dyn_kernel.ik_window_geometry(B)['lanes_per_env']} [{card}]")


def main_path_kernels(params, dev):
    """K1-K4 on the main path's shapes and inputs: B = 8192 seeded contexts
    reset and held for 2 steps, then K1 on the push setpoint's window, K2
    and K3 on its first substep, K4 on K1's own window (one substep, and the
    window folded into the batch). Returns (kernel records for hold_kernel,
    K1's window inputs and outputs, K4's window output, the K4 window
    helpers (ddgain, fold))."""
    import torch
    from d3il_tpu_torch.engine import (contact_kernel, dyn_kernel,
                                       substep_bm)
    from d3il_tpu_torch.envs import pushing
    st = params.statics
    gen = torch.Generator(device=dev).manual_seed(0)
    state = pushing.reset(params, pushing.sample_context(gen, B))
    tcp, _ = params.tcp_pose(state.scene)
    hold = hold_action(tcp)
    for _ in range(2):
        state, _ = pushing.step(params, state, hold)
    torch.cuda.synchronize()

    # K1 gets the push setpoint (the red box), far from the converged hold
    # posture, so that every DLS iteration does work
    push = push_action(state, hold)
    sb = substep_bm.scene_to_bm(state.scene)
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    k1_in = (bm(state.ctrl.q_virt), bm(state.ctrl.old_des_vel),
             bm(push[:, :3]), bm(push[:, 3:]))
    n_sub = params.n_substeps
    k1_out = dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in)
    sw = torch.full((B,), 0.04, device=dev)
    gf = torch.zeros(B, dtype=torch.bool, device=dev)
    k2_in = (sb.q, sb.qd, k1_out[2][0], k1_out[3][0], k1_out[4][0], sw, gf)
    k2_out = dyn_kernel.arm_stage_bm(st.arm, *k2_in)
    k3_in = substep_bm.contact_inputs(st, sb, k2_out)
    k3_out = contact_kernel.phase_batched_bm(st.contact, *k3_in)
    # K4 on K1's own window: q_des and qd_des as K1 stored them, qdd_des
    # rebuilt as the controller forms it (clip(ddgain (qd_i - qd_{i-1}) / dt,
    # +-25), qd_{-1} = the old_vel input), one substep and the whole window
    # folded into the batch
    ddg = torch.tensor([float(v) for v in params.cart_gains.ddgain],
                       device=dev)[None, :, None]
    qd_prev = torch.cat([k1_in[1][None], k1_out[3][:-1]])
    qdd_w = torch.clamp(ddg * (k1_out[3] - qd_prev) / float(params.dt),
                        -25.0, 25.0)
    fold = lambda x: torch.movedim(x, 0, 1).reshape(7, n_sub * B).contiguous()
    k4_in = (k1_out[2][0], k1_out[3][0], qdd_w[0].contiguous())
    k4w_in = (fold(k1_out[2]), fold(k1_out[3]), fold(qdd_w))
    k4_out = (dyn_kernel.feedforward_bm(st.ik, *k4_in),)
    k4w_out = (dyn_kernel.feedforward_bm(st.ik, *k4w_in),)
    torch.cuda.synchronize()

    kernels = [
        dict(name="ik_window", key="K1", route="cuda", design="PR 4",
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:230",
             run=lambda: dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in),
             plain=lambda: dyn_kernel.ik_window_plain(st.ik, n_sub, *k1_in),
             ops=lambda plain: ik_window_ops(st.ik, n_sub, k1_in, plain),
             ins=k1_in, out=k1_out, reps=(5, 1),
             names=("q_virt", "old_vel", "q_des", "qd_des", "tau_model"),
             # test_dyn_kernel.py:148-156, but tau_model 2e-2 instead of
             # 2e-3: that test runs 2 substeps; over 35, float32 rounding
             # in q_des reaches qdd_des = ddg (dq/dt - old_vel)/dt times
             # 1/dt^2 = 1e6, and the plain version alone differs from its
             # own float64 run by ~7e-3 scaled (printed below as "floor")
             tols=(3e-5, 3e-2, 3e-5, 3e-2, 2e-2),
             f64=lambda: dyn_kernel.ik_window_plain(
                 st.ik, n_sub, *(x.double() for x in k1_in))),
        dict(name="arm_stage", key="K2", route="cuda", design="PR 3",
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:165",
             run=lambda: dyn_kernel.arm_stage_bm(st.arm, *k2_in),
             plain=lambda: dyn_kernel.arm_stage_plain(
                 st.arm, *k2_in[:6], k2_in[6].to(torch.float32)),
             ins=k2_in, out=k2_out, reps=(20, 3),
             names=("xpos", "xquat", "axes", "anchors", "Minv", "qd_pre",
                    "a_arm"),
             # test_dyn_kernel.py:73-79
             tols=(1e-5, 1e-5, 1e-5, 1e-5, 3e-4, 1e-3, 1e-3)),
        dict(name="contact_phase", key="K3", route="cuda", design="PR 3",
             source="d3il_tpu_torch/csrc/contact_kernel.cu",
             replaces="d3il_tpu/engine/contact_kernel.py:345",
             run=lambda: contact_kernel.phase_batched_bm(st.contact, *k3_in),
             plain=lambda: contact_kernel.phase_plain(st.meta, *k3_in),
             ins=k3_in, out=k3_out, reps=(20, 3), names=("f", "qfrc"),
             meta=st.meta,
             # test_contact_kernel.py:116-117
             tols=(2e-4, 2e-4)),
        dict(name="feedforward_b8192", key="K4", route="cuda", report=False,
             design="PR 4", source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:276",
             run=lambda: (dyn_kernel.feedforward_bm(st.ik, *k4_in),),
             plain=lambda: (dyn_kernel.feedforward_plain(st.ik, *k4_in),),
             ins=k4_in, out=k4_out, reps=(20, 3), names=("tau",),
             # test_dyn_kernel.py:169-171
             tols=(3e-4,)),
        dict(name="feedforward", key="K4", route="cuda", design="PR 4",
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:276",
             run=lambda: (dyn_kernel.feedforward_bm(st.ik, *k4w_in),),
             plain=lambda: (dyn_kernel.feedforward_plain(st.ik, *k4w_in),),
             ins=k4w_in, out=k4w_out, reps=(20, 3), names=("tau",),
             tols=(3e-4,)),
    ]
    return kernels, k1_in, k1_out, k4w_out, (ddg, fold)


def rod_hold_action(tcp):
    """The rod tasks' hold action: the tcp's xyz, the rod pointing down."""
    import torch
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=tcp.device)
    return torch.cat([tcp, down.expand(tcp.shape[0], 4)], dim=1)


def rod_workload(task):
    """(contexts, trajectories) of a rod task's evaluation batch."""
    return ROD_WORKLOADS.get(task, (ROD_CONTEXTS, ROD_TRAJS))


def avoiding_contact_posture(params):
    """Arm joints (NumPy [7]) whose rod sits ~5 mm inside avoiding's first
    obstacle, from below: offline IK of a tcp 35 mm short of its axis in y
    (the IK lands ~3 mm short of its target, hence the 32 mm). The CPU and
    CUDA tests of avoiding's contacts take their posture from here too."""
    import numpy as np
    from d3il_tpu_torch.control import offline_ik
    from d3il_tpu_torch.envs import scenes
    tgt = np.array([scenes.AVOIDING_L1_X, scenes.AVOIDING_L1_Y - 0.032, 0.12])
    return offline_ik.solve(params.ctrl_chain, tgt, params.init_ee_quat,
                            q0=params.q_init)


def box_between_fingers(params, sc):
    """[B, 3]: where an axis-aligned stacking box (3 cm half-width) sits
    between each env's open fingers at the tip pads' height, its face 1 mm
    into the first tip pad (the port's FK of ``sc``). The CPU and CUDA
    tests of stacking's finger contacts place their box from here too."""
    from d3il_tpu_torch.engine import step as estep
    from d3il_tpu_torch.envs import stacking
    from d3il_tpu_torch.robot import chain as chain_mod
    xpos, xquat = chain_mod.fk(params.scene.robot, sc.q)
    tips = [estep._geom_world_pose(g, xpos, xquat, sc.free_pos,
                                   sc.free_quat)[0]
            for g in stacking.gripper_finger_geoms(params.scene.robot)[::2]]
    u = tips[1] - tips[0]
    return tips[0] + u / u.norm(dim=1, keepdim=True) * (0.004 + 0.03 - 1e-3)


# inserting's press: the red box 1 mm into the right face of maze_9 (the
# wall left of its target slot: centre x 0.32, half-width 0.01), the rod 3
# mm into the box's opposite face
PRESS_BOX_XY = (0.32 + 0.01 + 0.025 - 0.001, 0.276)
PRESS_WALL = "maze_9"


def rod_pressing_box(params, sc):
    """Inserting's scene ``sc`` with each env's red box axis-aligned 1 mm
    into maze_9's face, on the table, and its arm at the offline-IK posture
    of a tcp 3 mm into the box's opposite face: the rod presses the box
    against the wall. The CUDA test of inserting's contacts takes its
    scene from here too."""
    import numpy as np
    import torch
    from d3il_tpu_torch.control import offline_ik
    from d3il_tpu_torch.envs import scenes
    x, y = PRESS_BOX_XY
    tcp = np.array([x + 0.025 + 0.01 - 0.003, y, 0.12])
    qc = offline_ik.solve(params.ctrl_chain, tcp, params.init_ee_quat,
                          q0=params.q_init)
    dev = sc.q.device
    q, fp, fq = sc.q.clone(), sc.free_pos.clone(), sc.free_quat.clone()
    q[:, :7] = torch.as_tensor(qc, dtype=torch.float32, device=dev)
    fp[:, 0] = torch.tensor([x, y, scenes.TABLE_Z + 0.025], device=dev)
    fq[:, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    return sc._replace(q=q, qd=torch.zeros_like(sc.qd), free_pos=fp,
                       free_quat=fq)


def is_box_wall(pair):
    """The pair of inserting's red box and the wall it is pressed into."""
    return {pair.geom_a.name, pair.geom_b.name} == {"push_box1", PRESS_WALL}


def rod_check_scene(spec, params):
    """The scene of a rod task's evaluation batch (its Sim's contexts x
    trajectories: B = 480, inserting's 240) on which K2 and K3 are held,
    and what it is.
    Aligning and sorting: the reset's initial scene through
    ROD_CHECK_SUBSTEPS hold substeps, while the contacts carry force.
    Avoiding (no context, no free body): the reset, then each arm at a
    seeded perturbation (1e-3 rad) of a posture whose rod sits ~5 mm inside
    the first obstacle (offline IK of a tcp 35 mm short of its axis)."""
    import torch
    from d3il_tpu_torch.envs import common
    from d3il_tpu_torch.eval import sims
    env = spec.env()
    C, T = rod_workload(spec.name)
    sim = spec.make_sim(n_contexts=C, n_trajectories_per_context=T)
    cidx = sims._grid(C, T, params.device)
    ctx = tuple(x[cidx] for x in sim.contexts(params))
    if spec.name == "inserting":
        sc = env.reset(params, ctx).scene
        return (rod_pressing_box(params, sc), "after the reset, the rod "
                "pressing the red box 1 mm into maze_9")
    if spec.name != "avoiding":
        held = ROD_CHECK_SUBSTEPS[spec.name]
        return (common.settle(params, env.initial_scene(params, ctx), n=held),
                f"after {held} hold substeps from the reset's initial scene")
    sc = env.reset(params, ctx).scene
    qc = avoiding_contact_posture(params)
    gen = torch.Generator(device=params.device).manual_seed(12)
    q = sc.q.clone()
    q[:, :7] = torch.as_tensor(qc, dtype=torch.float32, device=params.device) \
        + 1e-3 * torch.randn((q.shape[0], 7), generator=gen,
                             device=params.device)
    return (sc._replace(q=q), "after the reset, the arms at postures whose "
            "rod sits ~5 mm inside the first obstacle")


def rod_substep_kernels(spec, params, tols):
    """K1, K2 and K3 on one real substep of a rod task's evaluation batch:
    on ``rod_check_scene``'s scene, the window of a hold at the tcp (on
    inserting a setpoint 1 cm further toward the wall) (K1) and its first
    substep are formed as run_substeps_bm forms them, through the wrappers.
    Returns the records for hold_kernel: K3 (timed; its register variant on
    avoiding, its general variant on the other scenes), K2 and K1."""
    import torch
    from d3il_tpu_torch.control import cartesian
    from d3il_tpu_torch.engine import dyn_kernel, substep_bm
    st, n_sub = params.statics, params.n_substeps
    sc, what = rod_check_scene(spec, params)
    cs = cartesian.init_state(sc.q[:, :7].clone())
    tcp, _ = params.tcp_pose(sc)
    hold = rod_hold_action(tcp)
    if spec.name == "inserting":
        # press 1 cm further toward the wall: a window whose IK moves (at
        # the tcp itself K1's outputs are the rest posture's)
        hold[:, 0] -= 0.01
    n = hold.shape[0]
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    sb = substep_bm.scene_to_bm(sc)
    k1_out = dyn_kernel.ik_window_bm(
        st.ik, n_sub, bm(cs.q_virt), bm(cs.old_des_vel), bm(hold[:, :3]),
        bm(hold[:, 3:]))
    sw = torch.full((n,), 0.04, device=params.device)
    gf = torch.zeros(n, dtype=torch.bool, device=params.device)
    k2_in = (sb.q, sb.qd, k1_out[2][0], k1_out[3][0], k1_out[4][0], sw, gf)
    k1_in = (bm(cs.q_virt), bm(cs.old_des_vel), bm(hold[:, :3]),
             bm(hold[:, 3:]))
    k1 = dict(name=f"ik_window_b{n}_{spec.name}", key="K1", out=k1_out,
              ins=k1_in, plain=lambda: dyn_kernel.ik_window_plain(
                  st.ik, n_sub, *k1_in),
              names=("q_virt", "old_vel", "q_des", "qd_des", "tau_model"),
              tols=tols["K1"])
    return contact_records(spec, params, sb, k2_in, what, tols) + (k1,)


def contact_records(spec, params, sb, k2_in, what, tols):
    """K2 on ``k2_in`` and K3 on the contact inputs that follow from it and
    the batch-minor scene ``sb``, through the wrappers; logs the contacts
    that carry force. Returns the records for hold_kernel: K3 (timed) and
    K2."""
    import torch
    from d3il_tpu_torch.engine import (contact_kernel, dyn_kernel,
                                       substep_bm)
    st = params.statics
    arm_out = dyn_kernel.arm_stage_bm(st.arm, *k2_in)
    k3_in = substep_bm.contact_inputs(st, sb, arm_out)
    k3_out = contact_kernel.phase_batched_bm(st.contact, *k3_in)
    n = sb.q.shape[-1]
    active = (k3_in[2] > 0).float().sum(0).mean().item()
    loaded = (k3_out[0].abs().amax(dim=1) > 0).float().sum(0).mean().item()
    log(f"{spec.name} substep (B = {n}, {what}): {active:.1f} of "
        f"{st.meta.ncon} contacts with depth > 0 per env, {loaded:.1f} "
        f"carrying force")
    variant = ("register" if k3_geometry(st.contact, n).variant == 1
               else "general")
    k3 = dict(name=f"contact_phase_{variant}_{spec.name}", key="K3",
              route="cuda", design=("register variant, PR 3"
                                    if variant == "register" else
                                    "general variant, PR 10: active "
                                    "contacts compacted"),
              source="d3il_tpu_torch/csrc/contact_kernel.cu",
              replaces="d3il_tpu/engine/contact_kernel.py:345",
              out=k3_out, ins=k3_in, reps=(10, 3), tables=st.contact,
              meta=st.meta,
              run=lambda: contact_kernel.phase_batched_bm(st.contact, *k3_in),
              plain=lambda: contact_kernel.phase_plain(st.meta, *k3_in),
              names=("f", "qfrc"), tols=tols["K3"])
    k2 = dict(name=f"arm_stage_b{n}_{spec.name}", key="K2", out=arm_out,
              ins=k2_in, names=("xpos", "xquat", "axes", "anchors", "Minv",
                                "qd_pre", "a_arm"), tols=tols["K2"],
              plain=lambda: dyn_kernel.arm_stage_plain(
                  st.arm, *k2_in[:6], k2_in[6].to(torch.float32)))
    return k3, k2


def profile_rod_step(spec, params, state, hold, card, top=False):
    """One dynamic env step of a task at its batch under torch.profiler,
    toward the action ``hold``: wall time, device busy share and device
    launches per substep (each of the window's substeps, K1 where the step
    has it, and the step's glue spread over them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        spec.env().step(params, state, hold)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = device_events(prof)
    busy_us = sum(us for _, us in dev)
    if not dev or busy_us <= 0:
        log(f"{spec.name} step profile: not measured (the trace holds no "
            f"device time)")
        return
    k3 = [us for name, us in dev if "contact_phase" in name]
    log(f"{spec.name} step profile at B = {hold.shape[0]}: wall "
        f"{wall_us / 1e3:.1f} ms (profiler on), device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), {len(dev)} "
        f"device activities = {len(dev) / params.n_substeps:.0f} per "
        f"substep; K3 {sum(k3) / 1e3:.3f} ms in {len(k3)} launches "
        f"({sum(k3) / busy_us:.1%} of device busy) [{card}]")
    if top:
        top_device_time(dev)


def rod_task(task, counters, tols, card, failed, problems):
    """One rod task through its Params() at full width: K2 (on
    ROD_K2_TASKS) and K3 held on a real substep of its evaluation batch
    (avoiding: the register variant with no free body; the others: the
    general variant), K1 too on inserting's, a gmm agent trained on its
    demos and its Sim's rollout in both modes. Failures are appended to
    ``failed`` (kernel holds) and ``problems``. Returns the K3 record for
    the kernels line."""
    import torch
    import run_eval_torch
    import run_train_torch
    from d3il_tpu_torch import registry
    spec = registry.TASKS[task]
    workload = rod_workload(task)
    n_eps = workload[0] * workload[1]
    t0 = t_task = time.perf_counter()
    params = SCENE_PARAMS[task] = spec.make_params(device="cuda")
    torch.cuda.synchronize()
    meta, n_sub = params.statics.meta, params.n_substeps
    geo = params.statics.contact.geometry(n_eps)
    log(f"{task}: params {time.perf_counter() - t0:.1f} s; "
        f"{len(params.scene.pairs)} contact pairs, {meta.ncon} contacts, "
        f"{3 * meta.ncon} rows, nv {meta.nv}, {meta.n_iters} solver "
        f"iterations; K3 at B = {n_eps} {geo}")
    k3, k2, k1 = rod_substep_kernels(spec, params, tols)
    if task == "inserting":
        hold_kernel(k1, card, failed, timed=False)
    if task in ROD_K2_TASKS:
        hold_kernel(k2, card, failed, timed=False)
    if geo.variant == 1:
        hold_kernel(k3, card, failed)
    else:
        hold_general_k3(k3, card, failed)
    log(f"{task} K3 ({k3['name']}) at B = {n_eps}: roofline share "
        f"{k3['bound_ms'] / k3['device_ms']:.2%} [{card}]")
    loaded = {"avoiding": ("the rod-obstacle row",
                           lambda p: p.geom_b.name == "l1_obs"),
              "inserting": ("the red box-maze_9 row", is_box_wall)}
    if task in loaded:
        what, pick = loaded[task]
        share = loaded_share(k3["out"][0], pair_rows(params.scene, pick))
        log(f"{task}: {what} carries force in {share:.1%} of envs")
        if share < 0.99:
            problems.append(f"{task}: {what} carries force in only "
                            f"{share:.1%} of envs")
    ckpt = os.path.join(ROOT, "build", "chip_smoke", f"{task}_gmm.pt")
    epochs = INSERT_EPOCHS if task == "inserting" else ROD_EPOCHS
    targs = run_train_torch.make_args(
        task=task, agent="gmm", device="cuda", skip_eval=True, ckpt=ckpt,
        epochs=epochs, data=os.path.join(ROOT, "data"))
    row = run_train_torch.run_one(targs)
    log(f"{task}: trained gmm for {targs.epochs} epochs (cut from "
        f"{spec.train_kw['epochs']}) in {row['train_seconds']} s, final "
        f"train loss {row['final_train_loss']} [{card}]")
    _, agent, _ = run_eval_torch.load_agent(ckpt, "cuda")
    settle = spec.env().SETTLE_SUBSTEPS
    steps = ((INSERT_STEPS_DYNAMIC, INSERT_STEPS_KINEMATIC)
             if task == "inserting"
             else (ROD_STEPS_DYNAMIC, ROD_STEPS_KINEMATIC))
    for mode, kin, T in (("dynamic", False, steps[0]),
                         ("kinematic", True, steps[1])):
        state, dones, out, ln, secs, reset_s, w = eval_rollout(
            spec, agent, params.q_init, kin, T, counters, card,
            workload=workload)
        k3["launches_eval_" + mode] = ln["K3"]
        want = {"K1": T, "K2": 0 if kin else T * n_sub + settle,
                "K3": T * n_sub + settle, "K4": 0}
        finite = bool(w.finite.item()) and all(
            torch.isfinite(x).all().item() for x in leaves(state)
            if x.is_floating_point())
        frozen = bool((dones[1:] | ~dones[:-1]).all().item())
        log(f"{task} ({mode}): {n_eps} episodes x {T} steps (horizon "
            f"cut from {spec.max_steps}) in {secs:.2f} s = "
            f"{n_eps * T / secs:.1f} episode-steps/s, after a reset of "
            f"{reset_s:.2f} s ({settle} hold substeps); "
            + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
            + f"; max setpoint move per step {w.max_delta.item():.5f} m;"
            f" all finite: {finite}; launches {ln} expected {want} "
            f"[{card}]")
        bad = []
        if not finite:
            bad.append("non-finite state")
        if not frozen:
            bad.append("done went back to false")
        if w.max_delta.item() > 0.01 + 1e-6:
            bad.append(f"setpoint moved {w.max_delta.item()} m in a step")
        in01 = ("success_rate", "entropy") + (
            () if task.startswith("sorting") else ("score",))
        if not all(0.0 <= out[k] <= 1.0 for k in in01):
            bad.append(f"metrics out of [0, 1]: {out}")
        if "kl" in out and not out["kl"] >= -1e-6:
            bad.append(f"negative KL: {out}")
        if ln != want:
            bad.append(f"launch counts {ln} != {want}")
        problems += [f"{task} ({mode}): {b}" for b in bad]
        if mode == "dynamic":
            tcp, _ = params.tcp_pose(state.scene)
            profile_rod_step(spec, params, state, rod_hold_action(tcp),
                             card, top=task in (ROD_TASKS[-1], "inserting"))
    log(f"{task}: {time.perf_counter() - t_task:.1f} s in all")
    if task in ROD_REPEAT_TASKS:
        bc, _ = registry.make_agent(
            "bc", torch.Generator(device="cuda").manual_seed(3), spec.obs_dim,
            spec.act_dim, agent.scaler)
        finals = [eval_rollout(spec, bc, params.q_init, True,
                               ROD_REPEAT_STEPS, counters, card, seed=5,
                               watch=False, workload=workload)[0]
                  for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(leaves(finals[0]),
                                                     leaves(finals[1])))
        log(f"{task}: bc rolled out twice ({n_eps} episodes x "
            f"{ROD_REPEAT_STEPS} kinematic steps, seed 5): final states "
            f"identical: {same}")
        if not same:
            problems.append(f"{task}: the bc rollout does not repeat")
    return k3


def rod_tasks(counters, tols, card, tasks=ROD_TASKS):
    """Phase 5 (avoiding, aligning and sorting with 2, 4 and 6 boxes: 480
    episodes each, avoiding 1 x 480, the others 60 x 8) and phase 7
    (inserting, 30 x 8): ``rod_task`` of each. Returns the K3 records for
    the kernels line."""
    rows, failed, problems = [], [], []
    for task in tasks:
        rows.append(rod_task(task, counters, tols, card, failed, problems))
    if failed:
        raise SystemExit(f"{', '.join(tasks)}: kernels disagree with their "
                         f"plain versions: {failed}")
    if problems:
        raise SystemExit(f"{', '.join(tasks)} failed: " + "; ".join(problems))
    return rows


def stacking_check_scene(params, env):
    """Stacking's evaluation batch reset on its shipped contexts (60 x 18,
    B = 1,080), each env's red box then moved between the open fingers, 1
    mm into the first tip pad: the green and blue boxes on the table, a
    finger pressing a box. Returns the scene."""
    import torch
    from d3il_tpu_torch.eval import sims
    sim = sims.StackingSim(n_contexts=STACK_CONTEXTS,
                           n_trajectories_per_context=STACK_TRAJS)
    cidx = sims._grid(STACK_CONTEXTS, STACK_TRAJS, params.device)
    sc = env.reset(params, tuple(x[cidx] for x in sim.contexts(params))).scene
    fp, fq = sc.free_pos.clone(), sc.free_quat.clone()
    fp[:, 0] = box_between_fingers(params, sc)
    fq[:, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=params.device)
    return sc._replace(free_pos=fp, free_quat=fq)


def pair_rows(scene, pick):
    """Indices of the contacts of the scene's pairs for which ``pick(pair)``
    holds."""
    rows, r = [], 0
    for pair in scene.pairs:
        if pick(pair):
            rows += range(r, r + pair.max_points)
        r += pair.max_points
    return rows


def is_finger_box(pair):
    """A stacking pair of a finger geom (on the chain) and a box."""
    a, b = pair.geom_a, pair.geom_b
    return a.body >= 0 and a.free_idx < 0 and b.free_idx >= 0


def loaded_share(f, rows):
    """Share of envs in which one of the contacts ``rows`` of K3's forces
    ``f`` [ncon, 3, B] carries more than 1e-3 N: a hold on rows without
    force would compare zeros."""
    return (f[rows].abs().amax(dim=(0, 1)) > 1e-3).float().mean().item()


def stacking_records(spec, params, tols):
    """K2 (the grasp law on: width 0, grasp flag set) and K3 on the first
    substep of a joint-window hold of stacking's 1,080-episode batch with
    a finger pressing a box (``stacking_check_scene``): the records of
    ``contact_records``."""
    import torch
    from d3il_tpu_torch.engine import substep_bm
    sc = stacking_check_scene(params, spec.env())
    sb = substep_bm.scene_to_bm(sc)
    n_eps = sb.q.shape[-1]
    zeros = torch.zeros_like(sb.q[:7])
    k2_in = (sb.q, sb.qd, sb.q[:7].contiguous(), zeros, zeros,
             torch.zeros(n_eps, device=params.device),
             torch.ones(n_eps, dtype=torch.bool, device=params.device))
    return contact_records(
        spec, params, sb, k2_in, "after the reset, the red box pressed by "
        "a finger's tip pad; the gripper closing under the grasp force",
        tols)


def scene_records(tols):
    """--kernels-only: avoiding (K3's register variant with no free body)
    and each of GENERAL_SCENES through its Params() at full width, and
    K3's record on the substep phases 5-7 hold it on
    (``rod_substep_kernels``, ``stacking_records``), through ContactTables
    and phase_batched_bm alone."""
    from d3il_tpu_torch import registry
    recs = []
    for task in ("avoiding",) + GENERAL_SCENES:
        spec = registry.TASKS[task]
        params = spec.make_params(device="cuda")
        recs.append((stacking_records(spec, params, tols) if task ==
                     "stacking" else rod_substep_kernels(spec, params,
                                                         tols))[0])
    return recs


def stacking_task(counters, tols, card):
    """Phase 6: stacking through StackingParams() at full width (30
    substeps, 40 solver iterations, the gripper chain), K2 (the grasp law
    on: width 0, grasp flag set) and K3's general variant held on the first
    substep of a joint-window hold of its 1,080-episode batch with a finger
    pressing a box, a gmm agent trained on data/stacking at window 5, and
    its Sim's joint-space rollout of 60 x 18 episodes in both modes.
    Returns the K3 record for the kernels line."""
    import torch
    import run_eval_torch
    import run_train_torch
    from d3il_tpu_torch import registry
    from d3il_tpu_torch.engine import substep_bm
    spec = registry.TASKS["stacking"]
    env = spec.env()
    failed, problems = [], []
    n_eps = STACK_CONTEXTS * STACK_TRAJS
    t0 = time.perf_counter()
    params = SCENE_PARAMS["stacking"] = spec.make_params(device="cuda")
    torch.cuda.synchronize()
    meta, n_sub = params.statics.meta, params.n_substeps
    log(f"stacking: params {time.perf_counter() - t0:.1f} s; "
        f"{len(params.scene.pairs)} contact pairs, {meta.ncon} contacts, "
        f"{3 * meta.ncon} rows, nv {meta.nv}, {meta.n_iters} solver "
        f"iterations, {params.scene.robot.nb} bodies in the chain; K3 at "
        f"B = {STACK_CONTEXTS * STACK_TRAJS} "
        f"{params.statics.contact.geometry(STACK_CONTEXTS * STACK_TRAJS)}")
    k3, k2 = stacking_records(spec, params, tols)
    hold_kernel(k2, card, failed, timed=False)
    hold_general_k3(k3, card, failed)
    f, qfrc = k3["out"]
    fingers = loaded_share(f, pair_rows(params.scene, is_finger_box))
    log(f"stacking: a finger-box row carries force in {fingers:.1%} of "
        f"envs; max |J' f| on the finger slide joints "
        f"{qfrc[7:9].abs().max().item():.3f}; K3 roofline share "
        f"{k3['bound_ms'] / k3['device_ms']:.2%} [{card}]")
    if failed:
        raise SystemExit(f"stacking: kernels disagree with their plain "
                         f"versions: {failed}")
    if fingers < 0.99:
        problems.append(f"finger rows carry force in only {fingers:.1%}")
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "stacking_gmm.pt")
    targs = run_train_torch.make_args(
        task="stacking", agent="gmm", device="cuda", skip_eval=True,
        ckpt=ckpt, epochs=STACK_EPOCHS, data=os.path.join(ROOT, "data"))
    row = run_train_torch.run_one(targs)
    log(f"stacking: trained gmm (window {targs.window}) for {targs.epochs} "
        f"epochs (cut from {spec.train_kw['epochs']}) in "
        f"{row['train_seconds']} s, final train loss "
        f"{row['final_train_loss']} [{card}]")
    _, agent, _ = run_eval_torch.load_agent(ckpt, "cuda")
    for mode, kin, T in (("dynamic", False, STACK_STEPS_DYNAMIC),
                         ("kinematic", True, STACK_STEPS_KINEMATIC)):
        state, dones, out, ln, secs, reset_s, w = eval_rollout(
            spec, agent, params.q_init, kin, T, counters, card,
            workload=(STACK_CONTEXTS, STACK_TRAJS))
        k3["launches_eval_" + mode] = ln["K3"]
        settle = env.SETTLE_SUBSTEPS
        want = {"K1": 0, "K2": 0 if kin else T * n_sub + settle,
                "K3": T * n_sub + settle, "K4": 0}
        finite = bool(w.finite.item()) and all(
            torch.isfinite(x).all().item() for x in leaves(state)
            if x.is_floating_point())
        frozen = bool((dones[1:] | ~dones[:-1]).all().item())
        log(f"stacking ({mode}): {n_eps} episodes x {T} steps (horizon cut "
            f"from {spec.max_steps}) in {secs:.2f} s = "
            f"{n_eps * T / secs:.1f} episode-steps/s, after a reset of "
            f"{reset_s:.2f} s ({settle} joint substeps); "
            + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
            + f"; max joint setpoint move per step {w.max_delta.item():.4f};"
            f" all finite: {finite}; launches {ln} expected {want} [{card}]")
        bad = []
        if not finite:
            bad.append("non-finite state")
        if not frozen:
            bad.append("done went back to false")
        in01 = ("success_rate", "success_rate_1", "success_rate_2",
                "entropy_1", "entropy_2", "entropy_3")
        if not all(0.0 <= out[k] <= 1.0 + 1e-6 for k in in01):
            bad.append(f"metrics out of [0, 1]: {out}")
        if not all(out[k] >= -1e-6 for k in ("kl_1", "kl_2", "kl_3")):
            bad.append(f"negative KL: {out}")
        if ln != want:
            bad.append(f"launch counts {ln} != {want}")
        problems += [f"stacking ({mode}): {b}" for b in bad]
        if mode == "dynamic":
            profile_rod_step(spec, params, state,
                             env.robot_state(params, state), card)
    if problems:
        raise SystemExit("stacking failed: " + "; ".join(problems))
    return k3


class ActionWatch:
    """An agent whose policy's actions are counted on the device (no host
    sync): rows with every entry finite, and all rows."""

    def __init__(self, agent):
        self.agent, self.finite, self.total = agent, 0, 0

    def __getattr__(self, name):
        return getattr(self.agent, name)

    def policy_apply(self, generator):
        apply = self.agent.policy_apply(generator)

        def watched(params, carry, obs):
            carry, act = apply(params, carry, obs)
            self.finite = self.finite + act.isfinite().all(dim=1).sum()
            self.total += act.shape[0]
            return carry, act

        return watched


def agents_phase(counters, q_init, card):
    """Phase 8: each agent of AGENTS at its registry defaults, trained on
    data/pushing on the card (AGENT_EPOCHS epochs), saved and reloaded
    through the entry points' functions, then PushingSim's reference
    workload (30 x 16 = 480 episodes) rolled out AGENT_STEPS dynamic steps:
    K1, K2 and K3's register variant under every policy. Checks: finite
    actions and state, the metrics' range, the launch counts. Returns one
    row per agent."""
    import torch
    import run_eval_torch
    import run_train_torch
    from d3il_tpu_torch import registry
    spec = registry.TASKS["pushing"]
    n_eps, T = EVAL_CONTEXTS * EVAL_TRAJS, AGENT_STEPS
    rows, problems = [], []
    for name in AGENTS:
        ckpt = os.path.join(ROOT, "build", "chip_smoke", f"pushing_{name}.pt")
        targs = run_train_torch.make_args(
            task="pushing", agent=name, device="cuda", skip_eval=True,
            ckpt=ckpt, epochs=AGENT_EPOCHS, data=os.path.join(ROOT, "data"))
        row = run_train_torch.run_one(targs)
        _, agent, meta = run_eval_torch.load_agent(ckpt, "cuda")
        n_params = sum(v.numel() for v in agent.params.values())
        watch = ActionWatch(agent)
        state, dones, out, ln, secs, reset_s, w = eval_rollout(
            spec, watch, q_init, False, T, counters, card)
        finite_share = (watch.finite / watch.total).item()
        want = {"K1": T, "K2": T * 35 + 2, "K3": T * 35 + 2, "K4": 0}
        finite = bool(w.finite.item()) and all(
            torch.isfinite(x).all().item() for x in leaves(state)
            if x.is_floating_point())
        log(f"agent {name}: {n_params} parameters (window "
            f"{meta['window']}), trained {targs.epochs} epochs (cut from "
            f"{spec.train_kw['epochs']}) in {row['train_seconds']} s, final "
            f"train loss {row['final_train_loss']}; {n_eps} episodes x {T} "
            f"dynamic steps in {secs:.2f} s = {n_eps * T / secs:.1f} "
            f"episode-steps/s (reset {reset_s:.2f} s); finite actions "
            f"{finite_share:.1%}; "
            + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
            + f"; launches {ln} expected {want} [{card}]")
        bad = []
        if finite_share < 1.0 or not finite:
            bad.append(f"non-finite actions ({finite_share:.1%} finite) or "
                       f"state")
        if not all(0.0 <= out[k] <= 1.0 for k in
                   ("success_rate", "entropy", "score")):
            bad.append(f"metrics out of [0, 1]: {out}")
        if ln != want:
            bad.append(f"launch counts {ln} != {want}")
        problems += [f"agent {name}: {b}" for b in bad]
        rows.append({"agent": name, "params": n_params,
                     "train_seconds": row["train_seconds"],
                     "episode_steps_per_s": n_eps * T / secs,
                     "finite_actions": finite_share})
        if name == "beso":
            log(f"agent beso: backbone {agent.backbone}, window "
                f"{agent.window_size}, agent_extra {meta['agent_extra']}")
            if (agent.backbone, agent.window_size) != ("gpt", 5):
                problems.append("agent beso: not pushing's GPT at window 5")
            rows[-1]["samplers"] = beso_samplers(spec, agent, counters,
                                                 q_init, card)
    log(json.dumps({"agents": rows, "card": card}))
    if problems:
        raise SystemExit("agents failed: " + "; ".join(problems))
    return rows

def beso_samplers(spec, agent, counters, q_init, card):
    """One dynamic step (SAMPLER_STEPS) of PushingSim's 480 episodes with
    beso under each of its 14 samplers. Checks: finite actions and state,
    the launch counts. The denoiser's calls are counted here (a wrapper of
    ``beso.edm_denoise``): dpm_adaptive's batch loop runs 4 calls per
    iteration and 1 after, which gives its iterations and whether it
    reached the 64-iteration fuse. Returns one row per sampler."""
    import torch
    from d3il_tpu_torch.agents import beso
    T, n_eps = SAMPLER_STEPS, EVAL_CONTEXTS * EVAL_TRAJS
    calls = [0]
    plain = beso.edm_denoise

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    rows, problems = [], []
    beso.edm_denoise = counted
    try:
        for name in beso.SAMPLERS:
            agent.sampler = name
            watch = ActionWatch(agent)
            calls[0] = 0
            state, _, _, ln, secs, _, w = eval_rollout(
                spec, watch, q_init, False, T, counters, card)
            share = (watch.finite / watch.total).item()
            finite = bool(w.finite.item()) and all(
                torch.isfinite(x).all().item() for x in leaves(state)
                if x.is_floating_point())
            want = {"K1": T, "K2": T * 35 + 2, "K3": T * 35 + 2, "K4": 0}
            row = {"sampler": name, "denoiser_calls": calls[0],
                   "seconds": secs, "finite_actions": share}
            more = ""
            if name == "dpm_adaptive":
                iters = (calls[0] // T - 1) / 4
                row.update(loop_iterations=iters, fuse_reached=iters >= 64)
                more = (f"; the batch loop ran {iters:g} iterations per "
                        f"step, fuse (64) reached: {iters >= 64}")
            log(f"beso sampler {name}: {n_eps} episodes x {T} dynamic "
                f"step(s) in {secs:.2f} s, {calls[0]} denoiser calls, "
                f"finite actions {share:.1%}, state finite {finite}; "
                f"launches {ln} expected {want}{more} [{card}]")
            if share < 1.0 or not finite:
                problems.append(f"{name}: non-finite actions or state")
            if ln != want:
                problems.append(f"{name}: launch counts {ln} != {want}")
            rows.append(row)
    finally:
        beso.edm_denoise = plain
        agent.sampler = "euler_ancestral"
    if problems:
        raise SystemExit("beso samplers failed: " + "; ".join(problems))
    return rows


class TimedExperts:
    """The expert steps of data/experts.py wrapped for the demo phase's
    second pass: each call timed alone on the host clock with a CUDA
    synchronize before and after it (seconds summed in ``seconds``)."""

    NAMES = ("avoiding_expert_step", "pushing_expert_step",
             "sorting_expert_step", "inserting_expert_step",
             "aligning_expert_step", "stacking_expert_step")

    def __init__(self, module):
        self.module, self.seconds = module, 0.0
        self.plain = {n: getattr(module, n) for n in self.NAMES}

    def __enter__(self):
        import torch

        def timed(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                return out
            return run
        for n, fn in self.plain.items():
            setattr(self.module, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.plain.items():
            setattr(self.module, n, fn)


class KernelInputs:
    """The demo phase's second pass: engine/substep_bm.py's references to
    engine/dyn_kernel.py and engine/contact_kernel.py replaced by views
    that keep the arguments of K1-K3's last calls in ``args`` and call the
    wrappers, which count their launches as always."""

    WRAPPERS = {"ik_window_bm": "K1", "arm_stage_bm": "K2",
                "phase_batched_bm": "K3"}

    class View:
        def __init__(self, module, args):
            self.module, self.args = module, args

        def __getattr__(self, name):
            fn = getattr(self.module, name)
            key = KernelInputs.WRAPPERS.get(name)
            if key is None:
                return fn

            def keep(*args):
                self.args[key] = args
                return fn(*args)
            return keep

    def __enter__(self):
        from d3il_tpu_torch.engine import substep_bm
        self.args = {}
        self.saved = (substep_bm.dyn_kernel, substep_bm.contact_kernel)
        substep_bm.dyn_kernel = self.View(self.saved[0], self.args)
        substep_bm.contact_kernel = self.View(self.saved[1], self.args)
        return self

    def __exit__(self, *exc):
        from d3il_tpu_torch.engine import substep_bm
        substep_bm.dyn_kernel, substep_bm.contact_kernel = self.saved


def demo_kernel_records(args, label, tols, with_k1):
    """K1 (``with_k1``), K2 and K3 held on the inputs of their last call in
    a demo step or a rollout (``args`` from KernelInputs), where it
    launched them: each wrapper called again on them against its plain
    version, the records named with ``label``. Returns the records for
    hold_kernel."""
    import torch
    from d3il_tpu_torch.engine import contact_kernel, dyn_kernel
    recs = []
    if with_k1 and "K1" in args:
        a = args["K1"]
        recs.append(dict(
            name=f"ik_window_b{a[2].shape[-1]}_{label}", key="K1",
            out=dyn_kernel.ik_window_bm(*a),
            plain=lambda a=a: dyn_kernel.ik_window_plain(*a),
            names=("q_virt", "old_vel", "q_des", "qd_des", "tau_model"),
            tols=tols["K1"]))
    if "K2" in args:
        a = args["K2"]
        recs.append(dict(
            name=f"arm_stage_b{a[1].shape[-1]}_{label}", key="K2",
            out=dyn_kernel.arm_stage_bm(*a),
            plain=lambda a=a: dyn_kernel.arm_stage_plain(
                *a[:7], a[7].to(torch.float32)),
            names=("xpos", "xquat", "axes", "anchors", "Minv", "qd_pre",
                   "a_arm"), tols=tols["K2"]))
    a = args["K3"]
    recs.append(dict(
        name=f"contact_phase_b{a[3].shape[-1]}_{label}", key="K3",
        out=contact_kernel.phase_batched_bm(*a),
        plain=lambda a=a: contact_kernel.phase_plain(a[0].meta, *a[1:]),
        names=("f", "qfrc"), tols=tols["K3"]))
    return recs


def demo_case(task, kinematic, T, counters, tols, card):
    """One runner family of demo generation on the Params() its scene's
    phase built: DEMO_N contexts from the port's sample_context, the
    choices of gen_demos, T steps in chunks of DEMO_CHUNK through
    run_chunked; every DEMO_FROZEN_EVERY-th env starts marked done. Checks:
    finite state and logs, the marked envs frozen in every leaf of the env
    and expert state, the rod tasks' setpoint moves within +-0.011 m per
    axis and step, the launch counts, and every env's logs written as
    episodes (success ignored), loaded back with the dataset loader and the
    task's assemble at the spec's dims. The rate is that run's, with no
    instrumentation. A second pass of one step from its end times each
    expert call alone (the expert's share) and keeps the inputs of K1-K3's
    last calls, on which each kernel is then held against its plain
    version. Returns the case's row and its problems."""
    import copy
    import numpy as np
    import torch
    from d3il_tpu_torch import registry
    from d3il_tpu_torch.data import dataset as ds
    from d3il_tpu_torch.data import experts, gen_demos
    spec = registry.TASKS[task]
    params = copy.copy(SCENE_PARAMS[task])
    params.kinematic = kinematic
    dev, n, n_sub = params.device, DEMO_N, params.n_substeps
    settle = getattr(spec.env(), "SETTLE_SUBSTEPS", 2)
    label = task + ("" if kinematic else " dynamic")
    ctx = gen_demos.sample_contexts(task, n, 0, dev)
    extras = gen_demos.plan(task, tuple(c.cpu().numpy() for c in ctx), n, 0)
    init, chunk = gen_demos.make_runner(
        task, params, DEMO_CHUNK,
        torch.Generator(device=dev).manual_seed(1000))
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    carry0 = init(*gen_demos.init_args(task, ctx, extras))
    frozen = torch.arange(n, device=dev) % DEMO_FROZEN_EVERY == 0
    carry0 = carry0._replace(done=frozen.clone())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    carry, logs, dones = experts.run_chunked(chunk, carry0, T, DEMO_CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ln = {k: fn.launches for k, fn in counters.items()}
    want = {"K1": 0 if task == "stacking" else T,
            "K2": 0 if kinematic else T * n_sub + settle,
            "K3": T * n_sub + settle, "K4": 0}
    state_leaves = leaves((carry.env, carry.es))
    finite = all(torch.isfinite(x).all().item() for x in state_leaves
                 if x.is_floating_point()) and all(
        np.isfinite(x).all() for x in logs)
    held = all(torch.equal(a[frozen], b[frozen]) for a, b in
               zip(state_leaves, leaves((carry0.env, carry0.es))))
    moved = np.abs(np.diff(logs[0], axis=1)).max() if task != "stacking" \
        else 0.0
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "demos",
                           task + ("" if kinematic else "_dynamic"))
    all_dir = os.path.join(out_dir, "all_data")
    os.makedirs(all_dir, exist_ok=True)
    files = gen_demos.write(task, all_dir, logs, dones, carry.env, extras,
                            keep_failed=True)
    train, _ = gen_demos.write_split(out_dir, files, 0)
    data = ds.load_task_dataset(all_dir, train, spec.assemble,
                                spec.max_steps, 1, device=dev)
    x, y = ds.all_valid(data)
    # second pass: one more step from the run's end, instrumented
    _, step1 = gen_demos.make_runner(
        task, params, 1, torch.Generator(device=dev).manual_seed(1001))
    with TimedExperts(experts) as timer, KernelInputs() as seen:
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        experts.run_chunked(step1, carry, 1, 1)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    failed = []
    kerr = {}
    for k in demo_kernel_records(seen.args,
                                 "demos_" + label.replace(" ", "_"), tols,
                                 (task, kinematic) == DEMO_K1_CASE):
        hold_kernel(k, card, failed, timed=False)
        kerr[k["key"]] = k["max_abs_err"]
    steps_s, share = t2 - t1, timer.seconds / (t4 - t3)
    row = {"task": task, "kinematic": kinematic, "episodes": n, "steps": T,
           "reset_seconds": t1 - t0, "step_seconds": steps_s,
           "episode_steps_per_s": n * T / steps_s,
           "expert_share": share, "launches": ln,
           "episodes_written": len(files), "kernel_max_abs_err": kerr}
    log(f"demos {label}: {n} episodes x {T} steps (chunks of {DEMO_CHUNK}) "
        f"in {steps_s:.2f} s = {n * T / steps_s:.1f} episode-steps/s after "
        f"a reset of {t1 - t0:.2f} s ({settle} hold substeps); one more "
        f"step, instrumented, {t4 - t3:.3f} s, the expert step timed alone "
        f"{timer.seconds:.3f} s = {share:.1%} of it; max setpoint move "
        f"per step {moved:.5f} m; {len(files)} episodes written, "
        f"{len(train)} loaded for training as obs {x.shape[-1]} act "
        f"{y.shape[-1]}; finite {finite}; marked envs frozen {held}; "
        f"launches {ln} expected {want}; kernels held on the step's last "
        f"inputs {sorted(kerr)} [{card}]")
    bad = [f"{f} disagrees with its plain version" for f in failed]
    if not finite:
        bad.append("non-finite state or logs")
    if not held:
        bad.append("an env marked done moved")
    if moved > 0.011 + 1e-6:
        bad.append(f"setpoint moved {moved} m in one step")
    if ln != want:
        bad.append(f"launch counts {ln} != {want}")
    if len(files) != n:
        bad.append(f"{len(files)} episodes written of {n}")
    if (x.shape[-1], y.shape[-1]) != (spec.obs_dim, spec.act_dim):
        bad.append(f"dataset dims ({x.shape[-1]}, {y.shape[-1]}) != "
                   f"({spec.obs_dim}, {spec.act_dim})")
    return row, [f"demos {label}: {b}" for b in bad]


def vision_views(spec, params, card, problems):
    """The task's views of its 480-episode batch after a reset, both
    cameras at 96 x 96 on the card: in [0, 1], each box colour seen by the
    bp camera in every env, the inhand view following the tcp (with the
    tcp 8 cm beside a box, the box in view), and the first
    VISION_CPU_ENVS envs' views rendered on the CPU agreeing with the
    card's. Returns the policy observations."""
    import torch
    from d3il_tpu_torch.eval import sims
    from d3il_tpu_torch.vision import taskviews
    n_ctx, n_traj = rod_workload(spec.name)
    sim = spec.make_sim(seed=0, n_contexts=n_ctx,
                        n_trajectories_per_context=n_traj)
    env = sim.env()
    cidx = sims._grid(n_ctx, n_traj, params.device)
    state = env.reset(params, tuple(x[cidx] for x in sim.contexts(params)))
    tcp, _ = params.tcp_pose(state.scene)
    obs = torch.cat([tcp[:, :2], env.get_observation(params, state)], 1)
    render = taskviews.make_render_obs(spec.name)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bp, ih, low = render(obs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(lambda: render(obs), 5)
    is_red = lambda im: ((im[..., 0] > 0.5) & (im[..., 1] < 0.2)
                         & (im[..., 2] < 0.2)).sum(dim=(1, 2))
    is_blue = lambda im: ((im[..., 2] > 0.5) & (im[..., 0] < 0.2)) \
        .sum(dim=(1, 2))
    red, blue = is_red(bp), is_blue(bp)
    # the inhand camera follows the tcp: with the tcp 8 cm beside the first
    # red (then the first blue) box, that box fills part of its view, off
    # the rod below the camera
    n_box = (obs.shape[1] - 4) // 3
    follow = []
    for col, count in ((0, is_red), (n_box // 2, is_blue)):
        moved = obs.clone()
        moved[:, 2] = obs[:, 4 + 3 * col] + 0.08
        moved[:, 3] = obs[:, 5 + 3 * col]
        follow.append(count(render(moved)[1]).min().item())
    k = VISION_CPU_ENVS
    cpu = taskviews.make_render_obs(spec.name)(obs[:k].cpu())
    agree = min(((a.cpu() - b).abs() <= 1e-5).all(-1).float().mean().item()
                for a, b in zip((bp[:k], ih[:k]), cpu[:2]))
    lo = min(bp.min().item(), ih.min().item())
    hi = max(bp.max().item(), ih.max().item())
    log(f"vision views ({spec.name}, {obs.shape[0]} envs, both cameras at "
        f"{bp.shape[1]} x {bp.shape[2]}): render {ms:.2f} ms (CUDA events, "
        f"median of 5), {peak / 2**20:.1f} MiB above the resident; values in "
        f"[{lo:.3f}, {hi:.3f}]; red pixels per env min "
        f"{red.min().item()}, blue min {blue.min().item()}; the inhand "
        f"view with the tcp beside a red / blue box: that colour's pixels "
        f"per env min {follow[0]} / {follow[1]}; CPU vs card on {k} envs: "
        f"{agree:.2%} of pixels within 1e-5 [{card}]")
    if not (0.0 <= lo and hi <= 1.0):
        problems.append(f"views outside [0, 1]: [{lo}, {hi}]")
    if red.min().item() < 4 or blue.min().item() < 4:
        problems.append("a box colour is missing from the bp view of some "
                        "env")
    if min(follow) < 20:
        problems.append("the inhand view does not follow the tcp")
    if agree < 0.998:
        problems.append(f"the CPU's views agree with the card's on only "
                        f"{agree:.2%} of pixels")
    return obs


def vision_step_times(agent, obs):
    """CUDA-event times (median of 5) at the batch of ``obs``: the render
    of both cameras, the encoder forward on its images, and one whole
    policy step from a fresh carry."""
    import torch
    from torch.func import functional_call
    from d3il_tpu_torch.agents import vision
    bp, ih, low = agent.render_fn(obs)
    low = vision._scale_low(agent.scaler, low)
    core = agent.model.core
    sub = vision._sub(agent.params, "core")
    apply = agent.policy_apply(torch.Generator(device=obs.device)
                               .manual_seed(0))
    carry = agent.init_carry(obs.shape[1], obs.shape[0])
    with torch.no_grad():
        return (cuda_ms(lambda: agent.render_fn(obs), 5),
                cuda_ms(lambda: functional_call(core, sub, (bp, ih, low)), 5),
                cuda_ms(lambda: apply(agent.params, carry, obs), 5))


def vision_agent(name, spec, q_init, obs, counters, card, steps, **train):
    """One vision agent at its registry defaults trained through
    run_vision_torch.run (``train``: its cut), saved, reloaded by
    run_eval_torch.load_agent and rolled out ``steps`` (mode, kinematic, T)
    on the task's 480-episode batch. Returns (row, problems, launches
    summed over the rollouts)."""
    import torch
    import run_eval_torch
    import run_vision_torch
    ckpt = os.path.join(ROOT, "build", "chip_smoke",
                        f"{spec.name}_{name}.pt")
    vargs = run_vision_torch.make_args(
        task=spec.name, agent=name, device="cuda", skip_eval=True,
        ckpt=ckpt, data=os.path.join(ROOT, "data"), **train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run_vision_torch.run(vargs)
    train_peak = torch.cuda.max_memory_allocated()
    _, agent, _ = run_eval_torch.load_agent(ckpt, "cuda")
    saved = torch.load(ckpt, map_location="cuda", weights_only=True)
    problems = []
    if set(saved["params"]) != set(agent.params) or not all(
            torch.equal(agent.params[k], v)
            for k, v in saved["params"].items()):
        problems.append("the reloaded weights differ from the saved")
    n_params = sum(v.numel() for v in agent.params.values())
    render_ms, enc_ms, policy_ms = vision_step_times(agent, obs)
    row = {"agent": name, "params": n_params,
           "train_seconds": out["train_seconds"],
           "train_steps": vargs.epochs * vargs.steps_per_epoch,
           "selected_epoch": out["selected_epoch"],
           "render_ms": render_ms, "encoder_ms": enc_ms,
           "policy_ms": policy_ms, "train_peak_mib": train_peak / 2**20}
    n_eps = obs.shape[0]
    settle = spec.env().SETTLE_SUBSTEPS
    total = dict.fromkeys(counters, 0)
    for mode, kin, T in steps:
        watch = ActionWatch(agent)
        torch.cuda.reset_peak_memory_stats()
        state, dones, metrics, ln, secs, reset_s, w = eval_rollout(
            spec, watch, q_init, kin, T, counters, card,
            workload=rod_workload(spec.name))
        peak = torch.cuda.max_memory_allocated()
        total = {k: total[k] + ln[k] for k in counters}
        n_sub = SCENE_PARAMS[spec.name].n_substeps
        want = {"K1": T, "K2": 0 if kin else T * n_sub + settle,
                "K3": T * n_sub + settle, "K4": 0}
        finite_share = (watch.finite / watch.total).item()
        finite = bool(w.finite.item()) and all(
            torch.isfinite(x).all().item() for x in leaves(state)
            if x.is_floating_point())
        frozen = bool((dones[1:] | ~dones[:-1]).all().item())
        eps = n_eps * T / secs
        row[f"episode_steps_per_s_{mode}"] = eps
        row[f"rollout_peak_mib_{mode}"] = peak / 2**20
        log(f"vision {name} ({mode}): {n_params} parameters, trained "
            f"{row['train_steps']} steps in {out['train_seconds']} s (peak "
            f"{train_peak / 2**30:.2f} GiB); {n_eps} episodes x {T} steps "
            f"in {secs:.2f} s = {eps:.1f} episode-steps/s (reset "
            f"{reset_s:.2f} s, peak {peak / 2**30:.2f} GiB); at B = {n_eps}:"
            f" render {render_ms:.2f} ms, encoder forward {enc_ms:.2f} ms, "
            f"policy step {policy_ms:.2f} ms = "
            f"{policy_ms / (secs / T * 1e3):.2%} of a step; finite actions "
            f"{finite_share:.1%}; "
            + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            + f"; max setpoint move {w.max_delta.item():.5f} m; launches "
            f"{ln} expected {want} [{card}]")
        bad = []
        if finite_share < 1.0 or not finite:
            bad.append(f"non-finite actions ({finite_share:.1%} finite) or "
                       f"state")
        if not frozen:
            bad.append("done went back to false")
        if w.max_delta.item() > 0.01 + 1e-6:
            bad.append(f"setpoint moved {w.max_delta.item()} m in a step")
        if not all(0.0 <= metrics[k] <= 1.0
                   for k in ("success_rate", "entropy")):
            bad.append(f"metrics out of [0, 1]: {metrics}")
        if ln != want:
            bad.append(f"launch counts {ln} != {want}")
        problems += [f"{mode}: {b}" for b in bad]
    return row, [f"vision {name}: {b}" for b in problems], total


def vision_phase(counters, tols, card):
    """Phase 10: the vision path on VISION_TASK's 480 episodes (its
    Params() from phase 5): the views checked, bc_vision trained with one
    rollout selection eval, saved, reloaded and rolled out
    VISION_STEPS_DYNAMIC + VISION_STEPS_KINEMATIC steps, K2 and K3 then
    held on the inputs of their last calls in those rollouts, then each of
    VISION_AGENTS trained a few steps and rolled out VISION_AGENT_STEPS
    dynamic steps. Returns the launches of every kernel summed over the
    phase's rollouts."""
    from d3il_tpu_torch import registry
    spec = registry.TASKS[VISION_TASK]
    params = SCENE_PARAMS[VISION_TASK]
    problems = []
    obs = vision_views(spec, params, card, problems)
    n_ctx, n_traj, n_sel = VISION_SELECT
    with KernelInputs() as seen:
        row, bad, launches = vision_agent(
            "bc_vision", spec, params.q_init, obs, counters, card,
            (("dynamic", False, VISION_STEPS_DYNAMIC),
             ("kinematic", True, VISION_STEPS_KINEMATIC)),
            epochs=VISION_EPOCHS, steps_per_epoch=VISION_STEPS_PER_EPOCH,
            eval_every=VISION_EPOCHS, select_contexts=n_ctx,
            select_trajs=n_traj, eval_max_steps=n_sel)
    failed = []
    for k in demo_kernel_records(seen.args, "vision_bc_vision", tols, False):
        hold_kernel(k, card, failed, timed=False)
    if failed:
        raise SystemExit(f"vision: kernels disagree with their plain "
                         f"versions: {failed}")
    rows, problems = [row], problems + bad
    if row["selected_epoch"] != VISION_EPOCHS:
        problems.append(f"bc_vision: selected epoch {row['selected_epoch']}"
                        f" != {VISION_EPOCHS} (one selection eval)")
    for name in VISION_AGENTS:
        row, bad, ln = vision_agent(
            name, spec, params.q_init, obs, counters, card,
            (("dynamic", False, VISION_AGENT_STEPS),), epochs=1,
            steps_per_epoch=VISION_AGENT_TRAIN_STEPS, eval_every=2)
        rows.append(row)
        problems += bad
        launches = {k: launches[k] + ln[k] for k in counters}
    log(json.dumps({"vision": rows, "task": VISION_TASK, "card": card}))
    if problems:
        raise SystemExit("vision failed: " + "; ".join(problems))
    return launches


def demos_phase(counters, tols, card):
    """Phase 9: ``demo_case`` of each of DEMO_CASES. Returns the rows and
    the launches of every kernel summed over the cases."""
    rows, problems = [], []
    for task, kinematic, T in DEMO_CASES:
        row, bad = demo_case(task, kinematic, T, counters, tols, card)
        rows.append(row)
        problems += bad
    log(json.dumps({"demos": rows, "card": card}))
    if problems:
        raise SystemExit("demo generation failed: " + "; ".join(problems))
    total = {k: sum(r["launches"][k] for r in rows) for k in counters}
    return rows, total


class LastCall:
    """``module.name`` replaced for the block by a function that keeps the
    arguments of its last call in ``args`` and calls the original. Used on
    the launch functions the wrappers call (``dyn_kernel.launch_ik_window``,
    ``contact_kernel._launch``), so that the wrappers count their launches
    as always."""

    def __init__(self, module, name):
        self.module, self.name, self.args = module, name, None

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def keep(*args):
            self.args = args
            return self.fn(*args)
        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def per_env_inputs(state, act):
    """PER_ENV_ENVS envs of the main path's batch after its last push step,
    those whose rod-box rows carry force first, with the next window's
    setpoint ``act`` [B, 7] (copies)."""
    import torch
    rod = state.scene.warm[:, 12:14].abs().amax(dim=(1, 2)) > 0
    idx = torch.sort((~rod).to(torch.int8), stable=True).indices
    idx = idx[:PER_ENV_ENVS]
    take = lambda x: x[idx].clone()
    return (type(state.scene)(*map(take, state.scene)),
            type(state.ctrl)(*map(take, state.ctrl)), take(act))


def per_env_phase(params, inputs, counters, tols, card):
    """The per-env API on the card: ``envs/common._run_substeps_single``
    for each env of ``inputs`` (per_env_inputs) on the next window's
    setpoint, one env at a time (K1 and K3 at a batch of one, the arm's
    dynamics in plain PyTorch), then the batched window of the same envs
    (K1, K2, K3 at B = PER_ENV_ENVS); per-env held against batched, the
    launches of each env-window and of the batched window checked; K1 and
    K3 timed at B = 1 on the inputs of their last per-env calls, K3 held
    there against its plain version. Returns the per-env run's launches."""
    import torch
    from d3il_tpu_torch.engine import contact_kernel, dyn_kernel
    from d3il_tpu_torch.envs import common
    sc, cs, act = inputs
    B, n_sub = sc.q.shape[0], params.n_substeps
    loaded = sc.warm.abs().amax(-1) > 0
    rod = loaded[:, 12:14].any(1)
    log(f"per-env: {B} envs of the main path's batch, rows carrying force "
        f"per env {loaded.sum(1).tolist()}, the rod's in "
        f"{int(rod.sum())}")
    if not rod.any():
        raise SystemExit("per-env phase failed: no env of the slice has a "
                         "rod contact that carries force")
    for fn in counters.values():
        fn.launches = 0
    outs, secs, per_window = [], [], []
    with LastCall(dyn_kernel, "launch_ik_window") as k1, \
            LastCall(contact_kernel, "_launch") as k3:
        for e in range(B):
            n0 = {k: fn.launches for k, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(common._run_substeps_single(
                params, type(sc)(*(x[e] for x in sc)),
                type(cs)(*(x[e] for x in cs)), act[e, :3], act[e, 3:], 0.04,
                False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            per_window.append({k: fn.launches - n0[k]
                               for k, fn in counters.items()})
    launches = {k: fn.launches for k, fn in counters.items()}
    n0 = dict(launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc_b, cs_b = common.run_substeps(params, sc, cs, act[:, :3].contiguous(),
                                     act[:, 3:].contiguous())
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    batched = {k: fn.launches - n0[k] for k, fn in counters.items()}
    want = {"K1": 1, "K2": 0, "K3": n_sub, "K4": 0}
    want_b = {"K1": 1, "K2": n_sub, "K3": n_sub, "K4": 0}
    errs = {name: max(scaled_err(o[0][i], sc_b[i][e])
                      for e, o in enumerate(outs))
            for i, name in enumerate(sc._fields)}
    cs_err = max(scaled_err(o[1][i], cs_b[i][e]) for e, o in enumerate(outs)
                 for i in range(2))
    log(f"per-env: {B} env-windows of {n_sub} substeps, "
        + ", ".join(f"{t:.2f}" for t in secs) + f" s each; the batched "
        f"window of the {B} {t_batched:.3f} s [{card}]")
    log(f"per-env launches per env-window {per_window} expected {want}; "
        f"batched window {batched} expected {want_b}")
    log("per-env vs batched, max scaled err over the envs: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {PER_ENV_TOL:g}); controller {cs_err:.3e} "
        f"(tol {PER_ENV_CS_TOL:g})")
    problems = []
    if any(w != want for w in per_window):
        problems.append(f"per env-window launches {per_window} != {want}")
    if batched != want_b:
        problems.append(f"batched window launches {batched} != {want_b}")
    bad = {n: e for n, e in errs.items() if not e <= PER_ENV_TOL}
    if bad:
        problems.append(f"per-env state off the batched window: {bad}")
    if not cs_err <= PER_ENV_CS_TOL:
        problems.append(f"per-env controller state off by {cs_err:.3e}")
    if not all(torch.isfinite(x).all().item() for o in outs for x in o[0]):
        problems.append("non-finite per-env state")
    # K1 and K3 at B = 1 on their last per-env inputs (launches not counted)
    spec, steps, ins1, _ = k1.args
    run1 = lambda: dyn_kernel.ik_window_bm(spec, steps, *ins1)
    log(f"K1 at B = 1 (n_sub {n_sub}, per-env window): kernel "
        f"{cuda_ms(run1, 10):.4f} ms (device "
        f"{cuda_ms(run1, 10, queued=True):.4f} ms) [{card}]")
    a3 = (k3.args[0], *k3.args[1])
    rec = dict(name="contact_phase_b1_per_env", key="K3",
               out=contact_kernel.phase_batched_bm(*a3),
               plain=lambda: contact_kernel.phase_plain(a3[0].meta, *a3[1:]),
               run=lambda: contact_kernel.phase_batched_bm(*a3),
               names=("f", "qfrc"), tols=tols["K3"], reps=(20, 3),
               ins=a3[1:], meta=a3[0].meta)
    failed = []
    hold_kernel(rec, card, failed)
    if failed:
        problems.append(f"K3 at B = 1 disagrees with its plain version: "
                        f"{failed}")
    if problems:
        raise SystemExit("per-env phase failed: " + "; ".join(problems))
    return launches


def sweep_phase(card):
    """The benchmark sweep through its entry point, as a user runs it: one
    row (SWEEP_ARGS) in a subprocess of run_benchmark_torch.py (its row in
    a subprocess of run_train_torch.py), then the same command again, which
    must skip the recorded row, then tools/make_results.py on the rows;
    checks of the row's schema, device, metrics' range, wall seconds and
    ranks (every visible card)."""
    import shutil
    import torch
    out = os.path.join(ROOT, "build", "chip_smoke", "sweep")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, os.path.join(ROOT, "run_benchmark_torch.py"),
           *SWEEP_ARGS, "--out", out]
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        runs.append((r, time.perf_counter() - t0))
        if r.returncode != 0:
            raise SystemExit(f"sweep failed (rc {r.returncode}):\n"
                             + (r.stdout + r.stderr)[-2000:])
    path = os.path.join(out, "results.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    md = os.path.join(out, "RESULTS.md")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "make_results.py"),
                        "--in", path, "--out", md], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    t_md = time.perf_counter() - t0
    text = open(md).read() if os.path.exists(md) else ""
    row = rows[0] if rows else {}
    log(f"sweep: {' '.join(SWEEP_ARGS)}: first run {runs[0][1]:.1f} s, "
        f"rerun {runs[1][1]:.1f} s, make_results {t_md:.1f} s [{card}]")
    log(f"sweep row: {json.dumps(row)}")
    keys = {"task", "agent", "seed", "eval_mode", "data", "device", "date",
            "train_seconds", "final_train_loss", "success_rate", "entropy",
            "score", "eval_seconds", "wall_seconds", "ranks"}
    problems = []
    if len(rows) != 1 or "error" in row:
        problems.append(f"{len(rows)} rows, error {row.get('error')}")
    elif not keys <= set(row):
        problems.append(f"row lacks {sorted(keys - set(row))}")
    else:
        if (row["task"], row["agent"], row["seed"], row["device"],
                row["eval_mode"]) != ("avoiding", "gmm", 0, "cuda",
                                      "dynamic"):
            problems.append("row is not avoiding / gmm / seed 0 / cuda / "
                            "dynamic")
        if not all(0.0 <= row[k] <= 1.0 for k in ("success_rate", "entropy",
                                                  "score")):
            problems.append("metrics out of [0, 1]")
        if not 0 < row["wall_seconds"] <= runs[0][1]:
            problems.append(f"wall_seconds {row['wall_seconds']}")
        if row["ranks"] != torch.cuda.device_count():
            problems.append(f"ranks {row['ranks']}: the row ran on "
                            "fewer than every visible card")
    if "[done] avoiding gmm seed 0" not in runs[1][0].stdout:
        problems.append("the rerun did not skip the recorded row")
    if r.returncode != 0 or "## avoiding" not in text or not any(
            ln.startswith("| gmm") for ln in text.splitlines()):
        problems.append(f"make_results failed (rc {r.returncode}): "
                        + r.stderr[-500:])
    if problems:
        raise SystemExit("sweep phase failed: " + "; ".join(problems))


def data_parallel_phase(params, dp_in, ckpt, counters, card):
    """Phase 13: the data-parallel path (``parallel/``) on a process group
    of one rank, NCCL on the card, started by
    ``distributed.initialize_from_env`` from the D3IL_* variables: one push
    step of phase 3's batch through ``mesh.run_sharded`` against the
    direct step on the same state (launches K1 1, K2 35, K3 35), one bc
    epoch on data/pushing with the mesh against one without, and phase 4's
    gmm through PushingSim at DP_SIM_STEPS dynamic steps with the mesh
    against without. Returns the sharded step's launch counts."""
    import socket
    import torch
    import torch.distributed as dist
    import run_eval_torch
    import run_train_torch
    from d3il_tpu_torch.agents import base
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.parallel import distributed as pdist
    from d3il_tpu_torch.parallel import mesh as pmesh
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {"D3IL_COORD_ADDR": f"127.0.0.1:{port}", "D3IL_NUM_PROCS": "1",
           "D3IL_PROC_ID": "0"}
    os.environ.update(env)
    problems = []

    def held(got, want):
        """(bitwise equal, max scaled error) over paired tensor leaves."""
        pairs = [(a, b) for a, b in zip(pmesh.tree_leaves(got),
                                        pmesh.tree_leaves(want))
                 if a.numel()]
        return (all(torch.equal(a, b) for a, b in pairs),
                max(scaled_err(a, b) for a, b in pairs))

    try:
        t0 = time.perf_counter()
        started = pdist.initialize_from_env()
        backend = dist.get_backend() if started else None
        mesh = pdist.global_mesh()
        log(f"data parallel: initialize_from_env {started}, backend "
            f"{backend}, world {mesh.world}, rank {mesh.rank}, device "
            f"{mesh.device}, {time.perf_counter() - t0:.2f} s")
        if not started or backend != "nccl" or mesh.world != 1:
            raise SystemExit("data-parallel phase failed: no NCCL process "
                             "group of one rank")

        # one push step of the main path's batch, direct and sharded
        state, act = dp_in
        step = lambda s, a: pushing.step(params, s, a)
        t0 = time.perf_counter()
        want = step(state, act)
        torch.cuda.synchronize()
        t_direct = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = pmesh.run_sharded(step, state, act, mesh=mesh)
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        equal, err = held(got, want)
        n_sub = params.n_substeps
        expect = {"K1": 1, "K2": n_sub, "K3": n_sub, "K4": 0}
        log(f"data parallel: push step at B = {B} direct {t_direct:.2f} s, "
            f"through run_sharded {t_sharded:.2f} s; every leaf equal: "
            f"{equal}, max scaled err {err:.3e} (tol {DP_TOL:g}); launches "
            f"{launches} expected {expect} [{card}]")
        if not err <= DP_TOL:
            problems.append(f"sharded step err {err:.3e}")
        if launches != expect:
            problems.append(f"sharded step launches {launches} != {expect}")

        # one bc epoch on data/pushing, without the mesh and with it
        targs = run_train_torch.make_args(task="pushing", agent="bc",
                                          device="cuda",
                                          data=os.path.join(ROOT, "data"))
        _, agent, _, train, val = run_train_torch.build_agent_and_data(
            targs, torch.Generator(device="cuda").manual_seed(0))
        cfg = base.TrainConfig(epochs=DP_FIT_EPOCHS,
                               batch_size=targs.batch_size,
                               window_size=targs.window,
                               eval_every_n_epochs=1)
        fits = []
        for m in (None, mesh):
            t0 = time.perf_counter()
            _, final, hist = base.fit(
                agent.loss_fn(), agent.params, train, val, cfg,
                torch.Generator(device="cuda").manual_seed(1), mesh=m)
            torch.cuda.synchronize()
            fits.append((final, hist, time.perf_counter() - t0))
        (f0, h0, s0), (f1, h1, s1) = fits
        equal, err = held(f1, f0)
        hist_err = max(abs(r1[k] - r0[k]) / max(abs(r0[k]), 1.0)
                       for r0, r1 in zip(h0, h1) for k in r0)
        log(f"data parallel: bc fit, {cfg.epochs} epoch of "
            f"{train.n_windows // cfg.batch_size} steps at batch "
            f"{cfg.batch_size} on data/pushing, without the mesh {s0:.2f} s, "
            f"with it {s1:.2f} s; history {h1}, equal: {h0 == h1}, max "
            f"scaled err {hist_err:.3e}; weights equal: {equal}, max scaled "
            f"err {err:.3e} [{card}]")
        if len(h0) != len(h1) or not hist_err <= DP_TOL or not err <= DP_TOL:
            problems.append(f"bc fit with the mesh differs (history err "
                            f"{hist_err:.3e}, weights err {err:.3e})")

        # phase 4's gmm through PushingSim, without the mesh and with it
        spec, gmm, _ = run_eval_torch.load_agent(ckpt, "cuda")
        sim_params = spec.make_params(kinematic=False, max_steps=DP_SIM_STEPS,
                                      device="cuda", q_init=params.q_init)
        sims = []
        for m in (None, mesh):
            sim = spec.make_sim(seed=0, n_contexts=EVAL_CONTEXTS,
                                n_trajectories_per_context=EVAL_TRAJS)
            t0 = time.perf_counter()
            st, dones = sim.run_episodes(gmm, sim_params, mesh=m)
            torch.cuda.synchronize()
            sims.append((st, dones, sim.score(st), time.perf_counter() - t0))
        (st0, d0, out0, s0), (st1, d1, out1, s1) = sims
        equal, err = held((st1, d1), (st0, d0))
        log(f"data parallel: gmm PushingSim, {EVAL_CONTEXTS * EVAL_TRAJS} "
            f"episodes x {DP_SIM_STEPS} dynamic steps, without the mesh "
            f"{s0:.2f} s ({out0}), with it {s1:.2f} s ({out1}); final states "
            f"equal: {equal}, max scaled err {err:.3e} [{card}]")
        if out0 != out1 or not err <= DP_TOL:
            problems.append(f"PushingSim with the mesh differs ({out1} vs "
                            f"{out0}, err {err:.3e})")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    if problems:
        raise SystemExit("data-parallel phase failed: " + "; ".join(problems))
    return launches


def kernel_counters():
    """The kernel wrappers whose launch counts the phases read, by key."""
    from d3il_tpu_torch.engine import contact_kernel, dyn_kernel
    return {"K1": dyn_kernel.ik_window_bm, "K2": dyn_kernel.arm_stage_bm,
            "K3": contact_kernel.phase_batched_bm,
            "K4": dyn_kernel.feedforward_bm}


def launch_sim(ckpt, q_init, steps):
    """One rank's ``eval_rollout`` of the agent at ``ckpt`` (PushingSim's
    EVAL_CONTEXTS x EVAL_TRAJS grid, ``steps`` dynamic steps): the
    gathered final state and dones (on the CPU), the metrics, this rank's
    launches, the seconds of the steps and the world size. A module-level
    function, so that ``run_on_local_devices`` can hand it to a rank."""
    import run_eval_torch
    from d3il_tpu_torch.parallel import distributed as pdist
    from d3il_tpu_torch.parallel import mesh as pmesh
    spec, agent, _ = run_eval_torch.load_agent(ckpt, "cuda")
    state, dones, metrics, launches, seconds, _, _ = eval_rollout(
        spec, agent, q_init, False, steps, kernel_counters(), None,
        watch=False)
    return {"leaves": [x.cpu() for x in pmesh.tree_leaves((state, dones))],
            "metrics": metrics, "seconds": seconds, "launches": launches,
            "world": pmesh.data_mesh(device="cuda").world,
            "rank": pdist.process_index()}


def launch_sims(sims):
    """What each of phase 13's NCCL ranks runs: ``launch_sim`` of each
    (name, ckpt, q_init, steps) of ``sims``."""
    return {name: launch_sim(*a) for name, *a in sims}


def run_entry(argv, env=None):
    """An entry script run as a user runs it, a subprocess from the repo
    root with ``env`` over this process's variables: its last JSON line
    and its seconds. Fatal if it fails."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *argv], cwd=ROOT,
                       env={**os.environ, **(env or {})},
                       capture_output=True, text=True, timeout=900)
    rows = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not rows:
        raise SystemExit(f"{argv[0]} failed (rc {r.returncode}):\n"
                         + (r.stdout + r.stderr)[-2000:])
    return json.loads(rows[-1]), time.perf_counter() - t0


def launch_phase(gmm_ckpt, q_init, card):
    """Phase 13's launcher part. In this process, run_train_torch.main on a
    bc row (LAUNCH_EPOCHS on data/pushing, --skip-eval; --device cuda on
    one card, cuda:0 on more) against run_one called directly: bitwise
    equal weights and losses, one printed row with ``ranks`` 1. On one
    card main runs its one rank in this process, so this holds main's path
    but none of the spawn / NCCL code; only the branch below, where two or
    more cards are visible, runs that. There:
    run_train_torch.py and then run_eval_torch.py on its checkpoint, each a
    subprocess as a user runs it, with every card visible (one rank a card)
    against CUDA_VISIBLE_DEVICES=0 (one rank): weights LAUNCH_W_TOL, losses
    LAUNCH_LOSS_RTOL, one log file with one start record, the rows'
    ``ranks``, the same metrics; and in this process the PushingSim grid
    over LAUNCH_RANKS NCCL ranks against one, under the bc row's weights
    (final states to DP_TOL, the same metrics; a deterministic policy,
    since each rank draws a stochastic policy's noise from a generator of
    its own) and under phase 4's gmm (finite, metrics in range), with
    rank 0's launches. Returns the printed summary."""
    import contextlib
    import io
    import shutil
    import torch
    import run_train_torch
    from d3il_tpu_torch.agents import base
    from d3il_tpu_torch.parallel import distributed as pdist
    out = os.path.join(ROOT, "build", "chip_smoke", "launch")
    shutil.rmtree(out, ignore_errors=True)
    problems = []

    def row_argv(name):
        return ["--task", "pushing", "--agent", "bc", "--epochs",
                str(LAUNCH_EPOCHS), "--skip-eval", "--data",
                os.path.join(ROOT, "data"), "--ckpt",
                os.path.join(out, name, "bc.pt"), "--log-dir",
                os.path.join(out, name, "log")]

    def trained(name):
        """The saved weights, the logged epoch losses, the number of log
        files and of start records of a row."""
        params = base.load_checkpoint(os.path.join(out, name, "bc.pt"),
                                      device="cpu")["params"]
        logs = os.listdir(os.path.join(out, name, "log"))
        with open(os.path.join(out, name, "log", logs[0])) as f:
            records = [json.loads(line) for line in f]
        return (params, [r["train_loss"] for r in records
                         if r["event"] == "epoch"], len(logs),
                [r["event"] for r in records].count("start"))

    # the default device on one card; card 0 named where main would start
    # a rank a card
    visible = torch.cuda.device_count()
    one = ["--device", "cuda" if visible < 2 else "cuda:0"]
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        run_train_torch.main(row_argv("main") + one)
    t_main = time.perf_counter() - t0
    rows = [json.loads(ln) for ln in said.getvalue().splitlines()
            if ln.startswith("{")]
    t0 = time.perf_counter()
    run_train_torch.run_one(run_train_torch.parse_args(row_argv("direct")
                                                       + one))
    t_direct = time.perf_counter() - t0
    (w1, l1, _, _), (w0, l0, _, _) = trained("main"), trained("direct")
    equal = w1.keys() == w0.keys() and all(torch.equal(w1[k], w0[k])
                                           for k in w0)
    log(f"launcher: bc row of {LAUNCH_EPOCHS} epoch on data/pushing through "
        f"run_train_torch.main {t_main:.2f} s, run_one directly "
        f"{t_direct:.2f} s; weights bitwise equal: {equal}, losses {l1} vs "
        f"{l0}, printed rows' ranks {[r.get('ranks') for r in rows]} "
        f"[{card}]")
    if not equal or l1 != l0 or [r.get("ranks") for r in rows] != [1]:
        problems.append("run_train_torch.main at one rank differs from "
                        "run_one")

    summary = {"ranks": 1, "visible": visible}
    if visible < 2:
        log("phase 13: ranks 1 (one card visible)")
    else:
        entry = {}
        for name, env in (("every card", None),
                          ("card 0", {"CUDA_VISIBLE_DEVICES": "0"})):
            d = name.replace(" ", "_")
            row, s_train = run_entry(["run_train_torch.py", *row_argv(d)],
                                     env)
            ev, s_eval = run_entry(
                ["run_eval_torch.py", "--ckpt", os.path.join(out, d, "bc.pt"),
                 "--n-contexts", str(EVAL_CONTEXTS), "--n-trajs",
                 str(EVAL_TRAJS), "--eval-max-steps", str(DP_SIM_STEPS)], env)
            w, losses, n_logs, starts = trained(d)
            log(f"launcher: {name}: run_train_torch.py {s_train:.2f} s "
                f"(ranks {row.get('ranks')}), run_eval_torch.py "
                f"{s_eval:.2f} s ({json.dumps(ev)}); {n_logs} log file, "
                f"{starts} start record [{card}]")
            if n_logs != 1 or starts != 1:
                problems.append(f"{name}: {n_logs} log files, {starts} "
                                "start records")
            entry[name] = (row, ev, w, losses)
        (row_a, ev_a, w_a, l_a), (row_1, ev_1, w_1, l_1) = entry.values()
        w_err = max((w_a[k] - w_1[k]).abs().max().item() for k in w_1)
        l_err = max(abs(a - b) / abs(b) for a, b in zip(l_a, l_1))
        log(f"launcher: every card against card 0: weights max abs err "
            f"{w_err:.3e} (tol {LAUNCH_W_TOL:g}), losses max rel err "
            f"{l_err:.3e} (tol {LAUNCH_LOSS_RTOL:g}) [{card}]")
        if not (w_err <= LAUNCH_W_TOL and l_err <= LAUNCH_LOSS_RTOL
                and len(l_a) == len(l_1) == LAUNCH_EPOCHS):
            problems.append("every card's row differs from card 0's")
        metrics = ("success_rate", "entropy", "score")
        if [row_a.get("ranks"), ev_a.get("ranks"), row_1.get("ranks"),
                ev_1.get("ranks")] != [visible, visible, 1, 1] or any(
                    ev_a[k] != ev_1[k] for k in metrics):
            problems.append("every card's entry points differ from card "
                            "0's in ranks or metrics")
        summary.update(ranks=visible, weights_err=w_err, loss_err=l_err)

        sims = [("bc", os.path.join(out, "direct", "bc.pt"), q_init,
                 DP_SIM_STEPS),
                ("gmm", gmm_ckpt, q_init, DP_SIM_STEPS)]
        ones = launch_sims(sims)
        t0 = time.perf_counter()
        many = pdist.run_on_local_devices(launch_sims, sims,
                                          nprocs=LAUNCH_RANKS, device="cuda")
        t_ranks = time.perf_counter() - t0
        log(f"launcher: PushingSim over {LAUNCH_RANKS} NCCL ranks in "
            f"{t_ranks:.2f} s [{card}]")
        summary["sims_seconds"] = round(t_ranks, 2)
        for name, _, _, steps in sims:
            one, got = ones[name], many[name]
            errs = [scaled_err(a, b) for a, b in zip(got["leaves"],
                                                     one["leaves"])
                    if a.is_floating_point() and a.numel()]
            finite = all(torch.isfinite(a).all() for a in got["leaves"]
                         if a.is_floating_point())
            shapes = [a.shape for a in got["leaves"]] == \
                [a.shape for a in one["leaves"]]
            in_range = all(0.0 <= v <= 1.0 for v in got["metrics"].values())
            log(f"launcher: {name} PushingSim, {EVAL_CONTEXTS * EVAL_TRAJS} "
                f"episodes x {steps} dynamic steps: one rank "
                f"{one['seconds']:.2f} s ({one['metrics']}), "
                f"{got['world']} ranks {got['seconds']:.2f} s on rank "
                f"{got['rank']} ({got['metrics']}); final states max scaled "
                f"err {max(errs):.3e} (tol {DP_TOL:g}"
                f"{'' if name == 'bc' else ', not held: own draws a rank'}); "
                f"rank 0's launches {got['launches']} (one rank "
                f"{one['launches']}) [{card}]")
            if got["world"] != LAUNCH_RANKS or not (finite and shapes
                                                    and in_range):
                problems.append(f"{name} PushingSim over {LAUNCH_RANKS} "
                                f"ranks: world {got['world']}, finite "
                                f"{finite}, shapes {shapes}, metrics "
                                f"{got['metrics']}")
            if name == "bc" and (max(errs) > DP_TOL
                                 or got["metrics"] != one["metrics"]):
                problems.append(f"bc PushingSim over {LAUNCH_RANKS} ranks "
                                f"differs (err {max(errs):.3e})")
            if got["launches"]["K1"] != steps or not \
                    got["launches"]["K2"] == got["launches"]["K3"] == \
                    one["launches"]["K3"]:
                problems.append(f"{name} rank 0's launches "
                                f"{got['launches']}")
            summary[f"launches_{name}"] = got["launches"]
    if problems:
        raise SystemExit("launcher failed: " + "; ".join(problems))
    return summary


def launch_only():
    """``--launch-only``: phase 1's build and phase 13's launcher part
    alone, on a gmm trained here for one epoch; the quick check of a host
    with several cards."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import run_train_torch
    from d3il_tpu_torch import registry
    from d3il_tpu_torch.kernels import build
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | {card}")
    log(f"build: {json.dumps(build.build_all())}")
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "launch_gmm.pt")
    run_train_torch.run_one(run_train_torch.make_args(
        task="pushing", agent="gmm", device="cuda", epochs=1,
        skip_eval=True, ckpt=ckpt, data=os.path.join(ROOT, "data")))
    q_init = registry.TASKS["pushing"].make_params(
        device="cuda", max_steps=DP_SIM_STEPS).q_init
    t0 = time.perf_counter()
    log(f"launcher: {json.dumps(launch_phase(ckpt, q_init, card))}")
    log(f"launcher part took {time.perf_counter() - t0:.1f} s")
    return 0


def main(kernels_only=False):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from d3il_tpu_torch.engine import dyn_kernel, substep_bm
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    since = lambda: f"{time.perf_counter() - t_start:.1f} s into the run"
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in took.items()}))
    for name in build.SOURCES:
        logf = build.lib_path(name).with_suffix(".log")
        if logf.exists():
            for entry, (regs, spill) in ptxas_entries(logf.read_text()).items():
                log(f"  ptxas {name} {entry}: {regs}; {spill}")
                m = re.search(r"Used (\d+) registers", regs)
                if m:
                    PTXAS_REGS[entry] = int(m.group(1))

    # ---- phase 2: kernels vs plain at main-path shapes ------------------
    log(f"phase 2: {since()}")
    t0 = time.perf_counter()
    params = pushing.PushingParams()            # 35 substeps, 25 iterations
    SCENE_PARAMS["pushing"] = params
    torch.cuda.synchronize()
    log(f"params: {time.perf_counter() - t0:.1f} s (offline IK + null-space "
        f"convergence), q_init {params.q_init.round(4).tolist()}")
    st = params.statics
    if not kernels_only:
        log(f"launch geometry: K2 at B = {B} "
            f"{dyn_kernel.arm_stage_geometry(B)}; K3 on pushing "
            f"{st.contact.geometry(B)}")
    n_sub = params.n_substeps
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    kernels, k1_in, k1_out, k4w_out, (ddg, fold) = main_path_kernels(params,
                                                                     dev)
    kernels.append(general_scene_kernel(st, kernels[2]["ins"],
                                        kernels[2]["tols"]))
    failed = []
    for k in kernels:
        hold_kernel(k, card, failed, timed=k.get("timed", True))
    k3_report(kernels[-1], kernels[-1]["tables"], card)
    # K4 against K1: the same FK + RNEA pass on the same window
    K4_VS_K1_TOL = 1e-4
    e = scaled_err(k4w_out[0].reshape(7, n_sub, B).movedim(1, 0), k1_out[4])
    log(f"K4 feedforward.tau vs K1 ik_window.tau_model on the window: scaled "
        f"err {e:.3e} (tol {K4_VS_K1_TOL:g}) "
        f"{'ok' if e <= K4_VS_K1_TOL else 'FAIL'}")
    if e > K4_VS_K1_TOL:
        failed.append("K4.tau_vs_K1")
    # K1-K3 at the evaluation path's shapes and inputs, both modes, at the
    # tolerances above
    from d3il_tpu_torch import registry
    spec = registry.TASKS["pushing"]
    tols = {k["key"]: k["tols"] for k in kernels[:3]}
    by_key = {k["key"]: k for k in kernels if k.get("report", True)}
    for kin in (False, True):
        for k in rollout_substep_kernels(spec, params.q_init, kin, tols):
            # K1-K3 timed at the evaluation path's batch, dynamic mode
            timed = not kin
            if timed and k["key"] == "K1":
                k1_b480 = k
            hold_kernel(k, card, failed, timed=timed)
            if timed:
                for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                          "bound_by"):
                    by_key[k["key"]][f + "_b480"] = k[f]
    general = []
    if kernels_only:    # K3 on avoiding's and each general scene's substep
        log(f"scenes: {since()}")
        general = scene_records(tols)
        for k in general:
            if k3_geometry(k["tables"], k["ins"][0].shape[-1]).variant == 1:
                hold_kernel(k, card, failed)
            else:
                hold_general_k3(k, card, failed)
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")
    setup = setup_launch(params, card)
    if not kernels_only:
        log(f"launch geometry: K1 at B = {B} "
            f"{dyn_kernel.ik_window_geometry(B)}, at B = 480 "
            f"{dyn_kernel.ik_window_geometry(480)}")
        for ins, steps in ((k1_in, n_sub), (k1_b480["ins"], n_sub), setup):
            lane_sweep(st.ik, steps, ins, card)
    keys = ("name", "route", "source", "replaces", "design", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    b480 = ("ms_b480", "device_ms_b480", "plain_ms_b480", "bound_ms_b480",
            "bound_by_b480")
    if kernels_only:    # the checkout under test may be another design's
        keys = tuple(k for k in keys if k != "design")
    # a K3 row also carries its active-rows bound, a general scene's also
    # k3_report's figures
    general_keys = ("bound_active_ms", "bound_active_by",
                    "active_contacts", "paths", "cap", "envs_per_block",
                    "blocks_per_sm", "waves")
    line = lambda kk, **more: dict({k: kk[k] for k in keys},
                                   **{k: kk[k] for k in b480 + general_keys
                                      if k in kk},
                                   **more, library_ms=None)
    if kernels_only:
        print(json.dumps({"kernels": [line(kk) for kk in kernels
                                      if kk.get("report", True)]
                          + [line(kk) for kk in general]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 3: the main path ----------------------------------------
    log(f"phase 3: {since()}")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    state = pushing.reset(params, pushing.sample_context(gen, B))
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    tcp0, _ = params.tcp_pose(state.scene)
    hold = hold_action(tcp0)
    t0 = time.perf_counter()
    for _ in range(HOLD_STEPS):
        state, res = pushing.step(params, state, hold)
    torch.cuda.synchronize()
    t_hold = time.perf_counter() - t0
    tcp, _ = params.tcp_pose(state.scene)
    box_z = state.scene.free_pos[..., 2]
    z_err = (box_z - 0.011).abs().max().item()
    track_err = (tcp[:, :2] - hold[:, :2]).norm(dim=1).max().item()
    red0 = state.scene.free_pos[:, 0, :2].clone()
    t0 = time.perf_counter()
    for _ in range(PUSH_STEPS):
        state, res = pushing.step(params, state, push_action(state, hold))
    torch.cuda.synchronize()
    t_push = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # K4 lies on no path of its own (K1 folds the same pass into its loop):
    # launch it here on the window of the next push step, as the controller
    # would feed it, and hold it to K1's tau_model. These launches (one of
    # K1, one of K4) are counted apart from the path's
    act = push_action(state, hold)
    qv, ov = bm(state.ctrl.q_virt), bm(state.ctrl.old_des_vel)
    _, _, qdes_w, qddes_w, tau_w = dyn_kernel.ik_window_bm(
        st.ik, n_sub, qv, ov, bm(act[:, :3]), bm(act[:, 3:]))
    qdd_w = torch.clamp(
        ddg * (qddes_w - torch.cat([ov[None], qddes_w[:-1]])) / float(params.dt),
        -25.0, 25.0)
    tau_ff = dyn_kernel.feedforward_bm(st.ik, fold(qdes_w), fold(qddes_w),
                                       fold(qdd_w))
    ff_err = scaled_err(tau_ff.reshape(7, n_sub, B).movedim(1, 0), tau_w)
    window_launches = {k: fn.launches - launches[k]
                       for k, fn in counters.items()}

    finite = all(torch.isfinite(x).all().item() for x in
                 list(state.scene) + list(state.ctrl))
    moved = ((state.scene.free_pos[:, 0, :2] - red0).norm(dim=1)
             > 0.005).float().mean().item()
    rod_rows = state.scene.warm[:, 12:14].abs().amax(dim=(1, 2))
    rod_contact = (rod_rows > 0).float().mean().item()
    steps = HOLD_STEPS + PUSH_STEPS
    sps = B * steps / (t_hold + t_push)
    log(f"main path: reset {t_reset:.2f} s; hold {HOLD_STEPS} steps "
        f"{t_hold:.2f} s ({B * HOLD_STEPS / t_hold:.1f} env-steps/s); push "
        f"{PUSH_STEPS} steps {t_push:.2f} s "
        f"({B * PUSH_STEPS / t_push:.1f} env-steps/s)")
    log(f"main path: box z max |z - 0.011| after hold {z_err:.2e} m; tcp "
        f"xy tracking max error {track_err * 1e3:.3f} mm; red box moved "
        f">5 mm in {moved:.1%} of envs; rod-box contact force in "
        f"{rod_contact:.1%} of envs; all state finite: {finite}")
    expect = {"K1": steps, "K2": steps * params.n_substeps + 2,
              "K3": steps * params.n_substeps + 2, "K4": 0}
    expect_window = {"K1": 1, "K2": 0, "K3": 0, "K4": 1}
    log(f"main path launches {launches} expected {expect}; window check "
        f"after it {window_launches} expected {expect_window}: K4 tau vs K1 "
        f"tau_model scaled err {ff_err:.3e}, tol {K4_VS_K1_TOL:g}")
    log(json.dumps({"metric": "pushing_env_steps_per_s", "value": sps,
                    "unit": "env-steps/s", "batch": B, "steps": steps,
                    "card": card}))
    problems = []
    if not finite:
        problems.append("non-finite state")
    if z_err > 3e-3:
        problems.append(f"boxes not resting at z=0.011 (err {z_err:.2e})")
    if track_err > 5e-3:
        problems.append(f"tcp tracking error {track_err * 1e3:.2f} mm")
    if launches != expect:
        problems.append(f"launch counts {launches} != {expect}")
    if window_launches != expect_window:
        problems.append(f"window check launches {window_launches} != "
                        f"{expect_window}")
    if moved < 0.5:
        problems.append(f"the red box moved in only {moved:.1%} of envs")
    if not ff_err <= K4_VS_K1_TOL:
        problems.append(f"K4 disagrees with K1 on the path's window "
                        f"({ff_err:.3e})")
    if problems:
        raise SystemExit("main path failed: " + "; ".join(problems))
    for f in ("ms", "device_ms"):
        kernel_s = sum(k[f] * launches[k["key"]] for k in kernels
                       if k.get("report", True)) / 1e3
        log(f"main path: the kernels' timed {f} x launches = {kernel_s:.3f} "
            f"s of {t_hold + t_push:.3f} s wall "
            f"({kernel_s / (t_hold + t_push):.1%}) [{card}]")
    profile_step(params, state, hold,
                 os.path.join(ROOT, "build", "chip_smoke", "trace"))
    per_env_in = per_env_inputs(state, act)
    dp_in = (state, act)        # phase 13's push step

    # ---- phase 4: the evaluation path -----------------------------------
    log(f"phase 4: {since()}")
    import run_eval_torch
    import run_train_torch
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "pushing_gmm.pt")
    targs = run_train_torch.make_args(
        task="pushing", agent="gmm", device="cuda", skip_eval=True, ckpt=ckpt,
        epochs=EVAL_EPOCHS, data=os.path.join(ROOT, "data"))
    row = run_train_torch.run_one(targs)
    log(f"eval path: trained gmm (hidden {targs.hidden}, {targs.layers} "
        f"layers, window {targs.window}) for {targs.epochs} epochs in "
        f"{row['train_seconds']} s, final train loss "
        f"{row['final_train_loss']} [{card}]")
    spec, agent, meta = run_eval_torch.load_agent(ckpt, "cuda")
    n_eps = EVAL_CONTEXTS * EVAL_TRAJS
    eval_launches = {}
    for mode, kin, T in (("dynamic", False, EVAL_STEPS_DYNAMIC),
                         ("kinematic", True, EVAL_STEPS_KINEMATIC)):
        state, dones, out, ln, secs, reset_s, w = eval_rollout(
            spec, agent, params.q_init, kin, T, counters, card)
        eval_launches[mode] = ln
        want = {"K1": T, "K2": 0 if kin else T * n_sub + 2,
                "K3": T * n_sub + 2, "K4": 0}
        finite = bool(w.finite.item()) and all(
            torch.isfinite(x).all().item() for x in leaves(state)
            if x.is_floating_point())
        max_delta = w.max_delta.item()
        frozen = bool((dones[1:] | ~dones[:-1]).all().item())
        log(f"eval path ({mode}): {n_eps} episodes x {T} steps (horizon cut "
            f"from {spec.max_steps}) in {secs:.2f} s = "
            f"{n_eps * T / secs:.1f} episode-steps/s, after a reset of "
            f"{reset_s:.2f} s; success_rate "
            f"{out['success_rate']:.4f}, entropy {out['entropy']:.4f}, score "
            f"{out['score']:.4f}; done at the end in "
            f"{dones[-1].float().mean().item():.1%} of episodes; max setpoint "
            f"move per step {max_delta:.5f} m; all finite: {finite}; "
            f"launches {ln} expected {want} [{card}]")
        problems = []
        if not finite:
            problems.append("non-finite state")
        if not frozen:
            problems.append("done went back to false")
        if max_delta > 0.01 + 1e-6:
            problems.append(f"setpoint moved {max_delta} m in one step")
        if not all(0.0 <= out[k] <= 1.0 for k in
                   ("success_rate", "entropy", "score")):
            problems.append(f"metrics out of [0, 1]: {out}")
        if ln != want:
            problems.append(f"launch counts {ln} != {want}")
        if problems:
            raise SystemExit(f"eval path ({mode}) failed: "
                             + "; ".join(problems))
    # a deterministic policy rolled out twice from one seed repeats exactly
    bc, _ = registry.make_agent(
        "bc", torch.Generator(device=dev).manual_seed(3), spec.obs_dim,
        spec.act_dim, agent.scaler)
    finals = [eval_rollout(spec, bc, params.q_init, True, REPEAT_STEPS,
                           counters, card, seed=5, watch=False)[0]
              for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(leaves(finals[0]),
                                                 leaves(finals[1])))
    log(f"eval path: bc rolled out twice ({n_eps} episodes x {REPEAT_STEPS} "
        f"kinematic steps, seed 5): final states identical: {same}")
    if not same:
        raise SystemExit("eval path failed: the bc rollout does not repeat")
    profile_eval_step(spec, agent, params.q_init, card)

    # ---- phase 5: the rod tasks ----------------------------------------
    log(f"phase 5: {since()}")
    rod_rows = rod_tasks(counters, tols, card)

    # ---- phase 6: stacking ------------------------------------------------
    log(f"phase 6: {since()}")
    rod_rows.append(stacking_task(counters, tols, card))

    # ---- phase 7: inserting -----------------------------------------------
    log(f"phase 7: {since()}")
    rod_rows += rod_tasks(counters, tols, card, tasks=("inserting",))

    # ---- phase 8: the agents ----------------------------------------------
    log(f"phase 8: {since()}")
    agents_phase(counters, params.q_init, card)

    # ---- phase 9: demo generation ------------------------------------------
    log(f"phase 9: {since()}")
    demo_rows, demo_launches = demos_phase(counters, tols, card)
    # a scene's K3 row: the K3 launches of its own demo cases
    scene_demos = lambda name: sum(r["launches"]["K3"] for r in demo_rows
                                   if name.endswith("_" + r["task"]))

    # ---- phase 10: vision --------------------------------------------------
    log(f"phase 10: {since()}")
    vision_launches = vision_phase(counters, tols, card)

    # ---- phase 11: the per-env window -------------------------------------
    log(f"phase 11: {since()}")
    t0 = time.perf_counter()
    per_env_launches = per_env_phase(params, per_env_in, counters, tols,
                                     card)
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    # ---- phase 12: the benchmark sweep --------------------------------------
    log(f"phase 12: {since()}")
    t0 = time.perf_counter()
    sweep_phase(card)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")

    # ---- phase 13: the data-parallel path ---------------------------------
    log(f"phase 13: {since()}")
    t0 = time.perf_counter()
    dp_launches = data_parallel_phase(params, dp_in, ckpt, counters, card)
    launch = launch_phase(ckpt, params.q_init, card)
    log(f"launcher: {json.dumps(launch)}")
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")

    # ---- phase 14: report -------------------------------------------------
    log(f"phase 14: {since()}")
    # ``launches`` is the main path's count for K1-K3; K4, which no path
    # calls, reports its one launch on that path's window instead
    # (launches_path 0, launches_window_check 1); each rod scene's K3 row
    # its own dynamic rollout's count; ``launches_demos`` the demo phase's
    # (summed over its cases)
    print(json.dumps({"kernels": [
        line(kk, launches=launches[kk["key"]] or window_launches[kk["key"]],
             launches_path=launches[kk["key"]],
             launches_window_check=window_launches[kk["key"]],
             launches_eval_dynamic=eval_launches["dynamic"][kk["key"]],
             launches_eval_kinematic=eval_launches["kinematic"][kk["key"]],
             launches_demos=demo_launches[kk["key"]],
             launches_vision=vision_launches[kk["key"]],
             launches_per_env=per_env_launches[kk["key"]],
             launches_data_parallel=dp_launches[kk["key"]])
        for kk in kernels if kk.get("report", True)] + [
        line(kk, launches=kk["launches_eval_dynamic"],
             launches_eval_dynamic=kk["launches_eval_dynamic"],
             launches_eval_kinematic=kk["launches_eval_kinematic"],
             launches_demos=scene_demos(kk["name"]),
             launches_vision=vision_launches["K3"]
             if kk["name"].endswith("_" + VISION_TASK) else 0)
        for kk in rod_rows]}))
    log(f"report printed: {since()}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels-only"], ["--launch-only"]):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:] == ["--launch-only"]:
        sys.exit(launch_only())
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels-only"]))
