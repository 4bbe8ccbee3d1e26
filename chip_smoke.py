#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card, each through the entry points a user
calls, and holds every kernel against its plain PyTorch version:

* the cold main path -- the headline workload of bench.py:build():
  Crazyflie quadrotor at 20 Hz (nx=12, nu=4), horizon N=20, box bounds +-5
  on x and +-0.5 on u, hover reference, cold start, fixed rho, B=32768
  problems with x0 ~ U[-0.5, 0.5]^12 from numpy's default_rng(0),
  max_iter=100, check_termination=25, through setup -> with_bounds ->
  with_settings -> kernels.solve_fused (csrc/admm_group.cu, cold: a
  problem a group of 16 threads, its trajectories in shared memory);
* the serving loop -- the closed-loop workload of bench_all.py:569-596: the
  same quadrotor at N=10, hover reference z=1, B=16384 plants with
  x0 ~ U[-0.3, 0.3]^12 from default_rng(0), T=50 MPC steps, max_iter=100,
  check_termination=5, through kernels.closed_loop_fused
  (csrc/closed_loop_fused.cu); then bench_all.py:601-610's max_iter=500
  regime with shift_warm off and on;
* the external-plant loop of examples/serving_fleet.py:62-77 at B=16384
  (x0 = hover + U[-0.3, 0.3]^12, max_iter=100, check_termination=1):
  5 warm solves through kernels.solve_fused_warm (csrc/admm_group.cu,
  warm), the plant stepped with the applied input plus 0.01 N(0,1)
  actuator noise from the seeded generator;
* the constraint families on the thread-group kernel's families kinds
  (csrc/admm_group.cu, entry tinympc_admm_group_families; admm_group.cuh's
  GroupFamilies with csrc/admm_families.cuh's projections):
  bench_all.py:199-222's "rocket SOC cold solve
  (fused)" -- rocket_landing_20hz (nx=6, nu=3), N=10, box x in
  [-5,-5,-0.5,-10,-10,-20]..[5,5,100,10,10,20] and u in [-10, 105], state
  cone (0, 3, mu 0.25) and input cone (0, 3, mu 0.5), max_iter 100, ct 1,
  abs_pri_tol 2e-3, B=16384 with x0 = xinit U[0.9, 1.2] (default_rng(0)),
  Xref = linspace(xinit, 0, 10), Uref[:, 2] = 10 -- through setup ->
  with_bounds -> with_cones -> with_settings -> kernels.solve_fused; the
  same problem as an external-plant sequence of 5 warm solves
  (x+ = A x + B u0 + f); and the hyperplane demos of
  examples/scenarios.py:121-170 as a cold batch: quadrotor_50hz, N=10, box
  off, z <= 3 and sum(u) <= 6 (tv: z below the demo's first window of
  z_lim_total), max_iter 100, ct 1, B=16384, x0 = [-2, -2, 1, 0...] +
  0.1 U[-1, 1]^12 (default_rng(0)), Xref the demo's step-0 window;
* adaptive rho on the thread-group kernel csrc/admm_group.cu (entry
  tinympc_admm_group_adaptive; admm_group.cuh's GroupAdaptiveRho, the
  adaptation folded into the forward sweep): bench_all.py:401-446's "to-convergence 500it
  hard batch (adaptive rho)" -- the quadrotor at N=20, rho0=5, box +-5 /
  +-0.5, z reference 1, B=32768 with x0 ~ U[-0.5, 0.5]^12
  (default_rng(0)), max_iter 500, check_termination 1, the sensitivities
  from compute_sensitivities -- through setup -> with_bounds ->
  with_settings(adaptive_rho=True) -> kernels.solve_fused, with fixed rho
  on the same inputs beside it; bench_all.py:458-487's mis-tuned rho0=85
  (fixed / adaptive / guarded tol 3), and rho0=1000, where float32 at
  "highest" finds fixed rho mis-tuned; and phase 8's external-plant
  sequence with adaptive rho (5 warm solves, rho riding the carry);
* the streamed long-horizon solve on csrc/admm_stream.cu (its backward
  kernel, its forward kernel and the forward's stale variant):
  examples/long_horizon.py -- the quadrotor at 20 Hz, N=512, box +-5 /
  +-0.5, the figure-eight reference, x0 ~ U[-0.3, 0.3]^12
  (default_rng(0)), max_iter 20, ct 1 -- cold at B=1024 and at B=16384,
  then its :78-97 receding horizon, 5 warm solves at max_iter 100 with
  x+ = A x + B u0 (B=1024); bench_all.py:343-367's full-descent rocket
  SOC (N=256, B=1024, max_iter 20, abs_pri_tol 2e-3, x0 = xinit
  U[0.9, 1.1]); :503-518's N=256 batch to convergence (B=4096, max_iter
  500, x0 = U[-1, 1]^12 times scales 0.05 .. 0.5, permuted); phase 12's
  low-ceiling hyperplane batches; and the long-horizon set-up at N=2048,
  past the resident kernel's shared-memory wall -- through
  kernels.solve_fused_streamed(_warm); box problems, at fixed and adaptive
  rho, problems with families at fixed rho (the rocket's cones, the
  hyperplane demos) and consensus problems at fixed rho (a scenario group
  in a block, or across a thread-block cluster) on the lane-team kernels of
  csrc/admm_stream_team.cuh (both launches), each route checked from the
  launch counts;
* scenario-tree consensus on u[0] on the thread-group kernel
  csrc/admm_group.cu (entry tinympc_admm_group_consensus: a scenario
  group's offers through one block's shared memory, or through a
  thread-block cluster's when the group spans blocks), and with the
  rocket's cones on the families consensus instantiation of
  csrc/admm_fused.cu (with csrc/admm_consensus.cuh): bench_all.py:224-250's
  "consensus G=16 cold solve (fused)" -- the quadrotor at 20 Hz, N=10, box
  +-5 / +-0.5, z reference 0.5, max_iter 500, ct 1, rho_c 100, 2048 groups
  of 16 (B=32768) with x0 = a nominal U[-0.3, 0.3]^12 a group plus 0.05
  U[-1, 1]^12 a lane (default_rng(0)) -- through setup -> with_bounds ->
  with_settings -> with_consensus -> kernels.solve_fused, beside the same
  batch without consensus; and examples/scenario_tree_mpc.py:37-80's warm
  loop -- 256 trees of 8, z 1, the same settings, T=20 steps of
  kernels.solve_fused_warm, the nominal plant stepped with the group-mean
  u[0] and re-branched by 0.05 U[-1, 1]^12 from a seeded generator. Both
  sources set matmul_precision "high", a TPU mode the port refuses; these
  run at "highest";
* lane compaction to convergence (kernels.make_compact_solver: phases of
  warm solve_fused_warm(final=True) on the resident kernels -- box
  problems at (12, 4) on csrc/admm_group.cu, fixed or adaptive rho or
  consensus, and the families (the rocket's cones) there too --, or of
  solve_fused_streamed_warm on csrc/admm_stream.cu, with the live lanes
  regathered between phases) and the consensus instantiations of the
  streamed kernels: bench_all.py:448-452 / :497-501's mixed batch -- the
  quadrotor at 20 Hz, N=20, box +-5 / +-0.5, max_iter 500, ct 1,
  B=262144, x0 = U[-1, 1]^12 times linspace(0.05, 0.5) over the lanes,
  permuted (default_rng(0)) -- in phases [100, 400] beside one long
  solve_fused; :536-559's 1M fleet (B=2^20, segments of 2^18); :503-526's
  streamed N=256 batch (B=4096) on both backends; bench_all.py:224-250's
  G=16 batch compacted in group units on both backends, and solved by
  solve_fused_streamed beside the resident consensus kernel; and
  :413-435's precision-recovery ladder on the hard batch (B=32768, z 1,
  max_iter 500, precise_tail 500) beside its matched-budget control
  (max_iter 1000 in phases [100, 400, 500]). The sources' "high" runs at
  "highest" here, so the ladder's tail changes only the budget;
* adaptive rho with the constraint families and at the rocket's (6, 3), on
  the families adaptive kinds of csrc/admm_group.cu: phase 10's
  rocket SOC batch (B=16384) with adaptive_rho=True -- the rocket's
  sensitivities from compute_sensitivities, adaptive_rho_min lowered to
  0.05 so that its rho of 1 can move -- cold and as phase 11's
  external-plant sequence of 5 warm solves, beside fixed rho on the same
  inputs; and adaptive rho on the adaptive instantiations of
  csrc/admm_stream.cu (backward, forward, stale forward): bench_all.py:
  369-392's "long horizon N=256 adaptive rho (fused streamed)" -- the
  quadrotor at 20 Hz, N=256, B=1024, box +-5 / +-0.5, z reference 1,
  x0 ~ U[-0.3, 0.3]^12 (default_rng(0)), max_iter 20, ct 1 -- through
  kernels.solve_fused_streamed beside the resident adaptive solve_fused,
  then at N=2048; and :503-526's N=256 batch (B=4096, max_iter 500) with
  adaptive rho, compacted in phases [100, 400] on both backends;
* the roofline probes of csrc/roofline.cu (tools/roofline.py's dot and
  elementwise probes) through python -m tinympc_tpu_torch.roofline's
  three configs -- the quadrotor at N=20, B=32768, ct 1 and 25, and
  synthetic(32, 8) at B=16384, max_iter 100, tolerances 0 -- beside the
  fused solve;
* heterogeneous fleets in one multi-system launch of csrc/admm_group.cu:
  bench_all.py:273-300's "hetero fleet 16 systems" -- the quadrotor's A
  scaled off the diagonal by 1 + 0.002 (i - 8), i < 16, N=10, box +-5 /
  +-0.5, max_iter 100, ct 25, 2048 lanes a system (B=32768), x0 ~
  U[-0.5, 0.5]^12 (default_rng(0)) -- through make_fleet_solver, and
  examples/serving_fleet.py:100-113's 4 variants (1 + 0.004 (i - 2), hover
  reference, ct 25) as a warm fleet of 16384 lanes with random
  assignments, x0 = hover + U[-0.3, 0.3]^12, 5 external-plant solves,
  each plant stepped with its own system;
* the one-thread kernels at the pairs that have no thread-group kind or
  lane team (kernels.admm_fused.THREAD_KERNEL_DIMS): bench_all.py:128-142's
  cartpole row -- systems.cartpole (nx=4, nu=1), N=10, box +-5 / +-0.5,
  Xref[:, 2] = 1, B=32768 with x0 ~ U[-0.5, 0.5]^4 (default_rng(0)),
  max_iter 100, ct 1 -- through setup -> with_bounds -> with_settings ->
  kernels.solve_fused (csrc/admm_fused.cu, tinympc_admm_fused: the families
  instantiation with zero counts), then as an external-plant sequence of 5
  warm solves at B=16384 (x+ = A x + B u0); the degenerate pairs (2, 2),
  (2, 1), (3, 3), (1, 1) of tests/test_degenerate_dims.py (its random
  stable systems) at its N and at N=10, small; and cartpole's other kinds
  at B=1024 (adaptive rho, consensus, a hyperplane, a fleet through
  tinympc_admm_fused_multi, compaction, and the streamed solve at N=256 on
  the one-thread entries of csrc/admm_stream.cu);
* the fused closed loop on one thread a plant (csrc/closed_loop_thread.cu,
  closed_loop_kernel.THREAD_LOOP_DIMS): examples/scenarios.py:181-225's
  rocket landing (rocket_landing_mpc.cpp) -- its box alone, the cones
  configured but off, max_iter 100, ct 1, abs_pri_tol 2e-3 -- at B=16384
  with x0 = xinit U[0.9, 1.2] per lane (default_rng(0)), T=90 steps along
  its sliding reference xinit (1 - k / 99), Uref[:, 2] = 10; :38-57's
  cartpole regulation to x = 1 (cartpole_example.cpp) under
  bench_all.py:128-142's box at B=16384, x0 = [0.5, 0, 0, 0] +
  U[-0.3, 0.3]^4, T=50, max_iter 100, ct 5, then bench_all.py:601-610's
  max_iter=500 regime with shift_warm off and on; every pair small; and the
  kernel's (12, 4) instance, pinned, on the serving loop beside the
  thread-group loop.

Phases, each of which raises on failure:

1. card: name and power limit (nvidia-smi); TF32 off;
2. build: compile every csrc/*.cu for sm_90a, one nvcc each, together
   (timed, set-up), with each kernel's ptxas register and spill lines (a
   families, streamed, thread-group, closed-loop or tensor-core probe
   kernel that spills fails the run);
3. cold kernel against its plain version at B=1000 (ragged) and 1024,
   check_termination 25 and 1; and against the port's admm.solve at B=256;
4. cold main path at B=32768 and bench.py's two other regimes, each
   launch on the thread-group kernel's entry (tinympc_admm_group);
5. warm kernel against its plain version, small: B=1000, an external-plant
   sequence of 6 solves at check_termination 1 and 5;
6. closed-loop kernel against its plain version, small: B=1000, T=20, at
   ct 5; ct 1 with reset_duals; ct 5 with shift_warm; ct 5 and ct 1 with
   reset_duals on a moving reference, the last with rounding witnesses;
7. serving path at full width (B=16384, T=50, ct 5): launch count, kernel
   against plain version, kernel time, MPC steps/s and its bound; then the
   max_iter=500 regimes;
8. the external-plant loop at B=16384, ct 1;
9. families kernels against their plain versions, small: cold and warm,
   (nx, nu) = (6, 3) (the rocket's cones) and (12, 4) (the quadrotor's
   hyperplanes, with z ceilings low enough that the state planes bite),
   B=1000, ct 1 and 5; warm as sequences of 4 solves; phases 9-12 and
   33-34 each held to the thread-group kernel's families entry
   (tinympc_admm_group_families);
10. the rocket SOC cold batch at B=16384;
11. the rocket SOC external-plant sequence at B=16384, 5 warm solves;
12. the hyperplane demos as cold batches at B=16384, static and tv; then
   the same under phase 9's low ceilings;
13. adaptive kernel against its plain versions, small: B=1000, N=20, ct 1,
   cold at rho_tol 1, at rho_tol 3 from rho0=85 (max_iter 500), with
   apply_c; warm, 6 solves of an external plant (N=10);
14. the adaptive hard batch at B=32768, and fixed rho on the same inputs;
15. the mis-tuned rho0=85 and rho0=1000 batches at B=32768: fixed,
   adaptive, guarded;
16. the adaptive external-plant sequence at B=16384, 5 warm solves;
17. the streamed solve, long horizon cold: N=512 at B=1024 and 16384;
18. the streamed solve, long horizon warm: 5 solves at B=1024;
19. the streamed solve, rocket SOC full descent, N=256;
20. the streamed solve to convergence, N=256, B=4096, max_iter 500;
21. the streamed solve on phase 12's low-ceiling batches;
22. the streamed solve at N=2048, which the resident solve refuses;
23. consensus kernels against their plain versions, small: the quadrotor
   (z 0.5) at rho_c 100 and the default as 128 x 8, 512 x 2 and 8 x 128
   groups (the last a cluster of 16 blocks), and the rocket's cones with
   consensus at (6, 3), 128 x 8; cold, then 2 warm solves, at ct 1 and 5;
   each case's C entry checked; then the rocket's case timed on the
   one-thread families consensus kernel;
24. the G=16 scenario batch at B=32768, and the same batch without
   consensus on the families kernel;
25. the scenario-tree warm loop, 256 x 8, T=20;
26. compaction on the kernels against compaction on the plain versions on
   the CPU, B=1024: the box quadrotor's mixed batch (scales 0.05-0.45) at
   ct 1 in phases of 15 and [100, 400] and at ct 25 in [100, 400], max_iter
   500; the rocket SOC in phases of 20; adaptive rho (resident) in
   [100, 400]; precise_tail 200 after a budget of 100; consensus 128 x 8 on
   both backends;
27. the streamed consensus kernels against their plain version and,
   bitwise, the resident consensus kernel: phase 23's shapes and groups
   of 1 and 16 at rho_c 100, ct 1, cold then 4 warm solves, on the team
   consensus entries; each team launch bitwise the one-thread launch on
   the same state, cold and warm (its first launch stale);
28. the mixed batch at B=262144 in phases [100, 400], bitwise against one
   long solve_fused, with both times and the long solve's lane, warp and
   block occupancy;
29. the 1M fleet in segments of 2^18, bitwise against one long solve;
30. streamed compaction at N=256, B=4096, on both backends, bitwise
   against phase 20's long streamed solve, with "auto"'s pick and the
   three times;
31. consensus compaction of the G=16 batch on both backends, bitwise
   between them and against a loop of full-width final=True phases with a
   first-convergence freeze, the spread bar (its witness admm.solve on the
   same phases); the same batch through
   solve_fused_streamed beside the resident consensus kernel, and the
   streamed consensus kernels per launch, on lane teams and on one thread
   a lane in turns (CUDA events and torch.profiler device time);
32. the ladder against its matched-budget control, bitwise;
33. the families adaptive kernel against its plain versions, small
   (B=1024): the rocket SOC cold (and with apply_c) and over 5 warm
   solves, the box-only rocket with the guard (tol 3) and at fixed rho
   (which runs the families kinds with zero counts), and the quadrotor
   hyperplanes, static and time-varying, under phase 9's low ceilings;
   then the rocket SOC cold (with and without apply_c, and at fixed rho)
   and its 5 adaptive warm solves on the one-thread kernel of
   csrc/admm_fused.cu (the route pinned to no
   group launch; the families' multi-system launch and the horizons past
   the cutoff take it), at the same bars and bitwise the group entry's
   solves;
34. the rocket SOC batch with adaptive rho at B=16384, cold and 5 warm
   solves, beside fixed rho on the same inputs;
35. the streamed adaptive kernels against their plain versions and,
   bitwise (final rho and carry included), the resident adaptive kernel,
   B=1024, N=32: box, apply_c, the guard from rho0 1000, the rocket's
   cones; cold and 5 warm solves (the plain version on the first and the
   fifth);
36. the long-horizon adaptive batch (N=256, B=1024), bitwise against the
   resident adaptive kernel, per launch and per solve; then N=2048;
37. adaptive compaction at N=256, B=4096, streamed bitwise against
   resident, beside one long streamed solve;
38. the roofline probes against their plain versions, small (B=1000,
   ragged) and at the tool's shapes, with the dot kernels' FFMA count in
   the SASS and the reps scaling; then the tool's three configs, timed,
   the elementwise rate at L2 (4096 lanes) and HBM (32768 lanes) size;
39. the cold fleet of 16 systems: the one launch bitwise the 16 per-bucket
   solve_fused launches and at the bar against its plain version, a small
   ragged fleet (4 systems, B=1000, random assignments) the same, and the
   one launch timed beside the 16 and beside one single-system launch;
40. the warm fleet, 4 systems, B=16384, 5 external-plant solves: bitwise
   the per-bucket solve_fused_warm launches at every step, at the bar
   against its plain version, the sixth solve timed;
41. the group kernels' other places (csrc/admm_group.cuh Place): at N=64
   the box solve, cold and over 2 warm solves, and the closed loop at N=10
   (T=20, shift_warm, reset_duals) launched at every place and smaller
   blocks, bitwise the launch the wrappers choose; then the places long
   horizons choose, through the entry points at the bar against the plain
   version: a cold solve at N=700 (the table in device memory), warm
   solves at N=1100 and N=1150 (past N=1117 the saved columns in device
   memory too), closed loops at N=700 and N=1150 (T=2); then the
   families kinds: the rocket's cones and every family on both sides of
   the quadrotor, cold and 2 warm solves, at every place and P (the
   wrappers' and 1), bitwise the wrappers' launch; and the cutoff of the
   every-family problem by the library's own counts (FAMILY_CUTOFF), a
   solve there on the group kernel bitwise the one-thread kernel's and
   one a step past it on csrc/admm_fused.cu, both cold and warm against
   the plain versions on the card and on the CPU at the bars of the plain
   version's own spread between the two (the every-family problem is
   float32-sensitive: a 1-ulp change of x0 moves its 12-iteration
   solution by ~1e-2 in the plain version itself);
42. the cartpole cold batch at B=32768 on csrc/admm_fused.cu: against its
   plain version, timed (CUDA events, torch.profiler device time), solved
   fraction, mean iterations, the bound;
43. its external-plant sequence at B=16384, 5 warm solves, against the
   plain version, the sixth solve timed;
44. the one-thread kernel at cartpole and each degenerate pair (at
   tests/test_degenerate_dims.py's N and at N=10) against its plain
   versions on the card and the CPU: B=1000 and 1024, ct 1 and 25, cold,
   and 6 warm solves at B=1000;
45. cartpole's kinds at B=1024: adaptive rho with and without apply_c
   (cold and 5 warm), consensus 128 x 8 at rho_c 20 (cold and 2 warm, the
   spread bar), a state hyperplane x[0] <= 0.2 (cold and 3 warm), a fleet
   of 4 variants (cold and 2 warm, bitwise the per-bucket launches),
   compaction in phases [100, 400] (bitwise one long solve_fused), and the
   streamed solve at N=256 on the one-thread entries (bitwise the resident
   kernel, cold and 3 warm solves; each launch timed and held to its plain
   version); every launch checked by entry_counts / launch_counts;
46. the kernels line, then the device line last, after phases 47-50:
47. the rocket's serving loop on the one-thread closed loop at B=16384,
   T=90, against its plain version on the card (bitwise or not, at the
   bar), timed beside its bound; every instantiation of
   csrc/closed_loop_thread.cu present in ptxas and spill-free;
48. cartpole's serving loop at B=16384, T=50, the same; then its max_iter
   500 regimes, shift_warm off and on, timed, each held to its plain
   version on its first 3 steps;
49. the one-thread closed loop against its plain version, B=1000, T=10,
   N=10: each degenerate pair fixed (ct 5), with reset_duals (ct 1) and
   with shift_warm (ct 5); the rocket with reset_duals and shift_warm,
   cartpole with reset_duals; each launch counted on the thread kernel;
50. the one-thread closed loop pinned at (12, 4) on phase 7's serving
   loop, bitwise the thread-group loop, both timed in turns.

Every comparison prints its numbers; a missed bar fails the run at its end.
Bar of kernel against plain version (float32; the kernels sum each matrix
product as an FMA chain in column order, the plain versions through cuBLAS,
whose order depends on the shape): max|dx|, max|du| <= 1e-4, identical
solved fraction, >= 99% identical iteration counts. Where a lane that
crosses the tolerance one check earlier on one side ends on another
iterate, the values are held on the lanes whose counts agree (at every
step so far, in the warm sequences and closed loops). Closed loops hold
the solved fraction over (step, lane) within 0.001; the full-width
external-plant loop holds it within 2 lanes of 16384. Cold max_iter 500
holds its agreed lanes to 1e-3, as do the adaptive batches
of max_iter 500; adaptive solves also hold each lane's final rho to
within 1e-3 (relative) on the lanes whose counts agree, and the small
adaptive batches are held, against the plain version on the card and on
the CPU, to the plain version's own spread between the two. A closed loop at
check_termination 1 on a moving reference puts many (step, lane) counts
on a float32 tie, so two summation orders disagree on more than 1% of
them whichever two they are: there the count bar is the plain version's
own agreement between the GPU and the CPU (another order for every
product) less 0.005, where that is below 99%, and the kernel must be as
close as the plain version to the port's closed_loop in float64, to
0.005. The small families batches sit on such ties too: there the kernel
is held to the bar against the plain version on the CPU (on the lanes
whose counts agree), and against the plain version on the card to that
version's own spread from the CPU. The streamed solve is held bitwise
against the resident kernel on the same inputs (the same device functions;
phases 17-21, and under consensus phases 27 and 31), and against its plain
version at the bar, each single launch too; each team launch is held
bitwise against the one-thread launch on the same state (team=False,
phases 17-22, 27, 35, 36); a compacted solve is held
bitwise against one long kernel solve (kernel against kernel: cuBLAS's
order in a plain version depends on the width) and at the bar against
compaction on the plain versions on the CPU; a plain run of fewer than 16384 lanes takes the batch repeated to
16384, where cuBLAS sums each product in the kernels' column order. A
consensus lane is held only where every lane of its group agrees on the
count (at every step so far), and each group whose lanes all converged
has its u[0] spread below 2 abs_pri_tol + 1e-5. Each
phase's start prints the seconds
since the script began. Exits non-zero, printing no result, without a CUDA
device or outside a checkout of the repository.
"""
import contextlib
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np

N_HORIZON = 20
BATCH = 32768
HOVER = [0, 0, 1.0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
BAR_ATOL = 1e-4
BAR_ITER_SHARE = 0.99
BAR_LOOP_SOLVED = 1e-3
WITNESS_SLACK = 0.005
REPS = 7
DEVICE = "cuda"
# Comparisons that missed their bar; the run fails at its end if any did,
# after every phase has printed its numbers.
FAILURES = []
# The serving loop of bench_all.py:569-596.
SERVE_N, SERVE_B, SERVE_T = 10, 16384, 50
# The constraint-family paths: batch of the full-width runs, and of the
# small comparisons.
FAM_N, FAM_B = 10, 16384
FAM_SMALL_B = 1000
# z ceilings of the quadrotor hyperplane problems low enough that the state
# planes bite on part of the lanes while most still converge.
LOW_CEILING = dict(linear=np.full(FAM_N, 1.24),
                   tv=1.07 + 0.02 * np.arange(FAM_N))
ROCKET_XINIT = [4.0, 2.0, 20.0, -3.0, 2.0, -4.5]
QUAD_START = [-2.0, -2.0, 1.0] + [0.0] * 9
QUAD_GOAL = [2.0, 2.0, 4.0] + [0.0] * 9
# Adaptive rho: the hard batch of bench_all.py:401-405 (N=20, B=32768,
# max_iter 500, check_termination 1, z reference 1), its mis-tuned rho0
# (:458-487), and the small comparisons; the adaptive external-plant
# sequence runs at SERVE_B, N=SERVE_N.
ADAPT_B, ADAPT_ITER, ADAPT_SMALL_B = 32768, 500, 1000
MISTUNED_RHO = 85.0
# A rho0 that float32 at matmul_precision "highest" finds mis-tuned on the
# hard batch. At 85 fixed rho solves most lanes in float32: so does the JAX
# package's XLA path on the CPU (tests/test_torch_mistuned.py, run as a
# script, sweeps rho0 there), and bench_all.py's direction for 85, taken on
# a TPU at "high", shows in float32 only from rho0 ~500 up.
DETUNED_RHO = 1000.0
RHO_RTOL = 1e-3
# The long-horizon path: examples/long_horizon.py (N=512, B=1024, max_iter
# 20, then warm solves at max_iter 100), a fleet that fills the card
# (B=16384), bench_all.py:343-367's full-descent rocket (N=256) and
# :503-518's to-convergence batch (N=256, B=4096, max_iter 500), and a
# horizon past the resident kernel's shared-memory wall (N=2048).
LH_N, LH_B, LH_FLEET_B, LH_ITER, LH_WARM_ITER = 512, 1024, 16384, 20, 100
LH_SOC_N, LH_CONV_N, LH_CONV_B, LH_CONV_ITER = 256, 256, 4096, 500
LH_WALL_N = 2048
# The batch at which the streamed plain version runs a smaller one,
# repeated: cuBLAS then sums each product in the kernels' column order.
WIDE_B = 16384
# Scenario-tree consensus: bench_all.py:224-250's G=16 cold batch (2048
# trees x 16 branches, max_iter 500, ct 1, rho_c 100, N=10, z 0.5),
# examples/scenario_tree_mpc.py's warm loop (256 trees x 8, z 1, T=20), and
# the small comparisons at B=1024, each a cold solve and then
# CONS_SMALL_WARM warm solves.
CONS_N, CONS_RHO, CONS_ITER = 10, 100.0, 500
CONS_NG, CONS_G = 2048, 16
TREE_NG, TREE_G, TREE_T = 256, 8, 20
CONS_SMALL_B = 1024
CONS_SMALL_WARM = 2
# Lane compaction (make_compact_solver): bench_all.py:448-452 / :497-501's
# mixed batch to convergence (B=262144), :536-559's 1M fleet in segments
# of 2^18, both in phases [100, 400]; the small comparisons at B=1024.
COMPACT_B, COMPACT_FLEET_B, COMPACT_SEGMENT = 262144, 1 << 20, 1 << 18
COMPACT_CHUNK = [100, 400]
COMPACT_SMALL_B = 1024
# Adaptive rho with the families and on the streamed kernels: the small
# comparisons at B=1024 (the streamed ones at N=32, a horizon the resident
# kernel takes). The rocket's rho of 1 sits on adaptive_rho_min's default of
# 1 and its predictions fall below it, so its adaptive problems lower the
# floor to let rho move.
ADAPT_FAM_B = 1024
STREAM_ADAPT_N = 32
ROCKET_RHO_MIN = 0.05

# Published dense peaks (NVIDIA data sheets): FP32 on the CUDA cores, and
# device-memory bandwidth. The SXM part is the default.
PEAKS = (("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 67.0e12, 3.35e12))
# bf16 on the tensor cores, dense (the same sheets): the bound of the bf16
# dot probe, whose products of bf16 values with float32 sums are what the
# tensor cores compute.
PEAKS_BF16 = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12))
# Heterogeneous fleets: bench_all.py:273-300's 16 quadrotor variants of
# 2048 lanes each (N=10, max_iter 100, ct 25), and
# examples/serving_fleet.py:100-113's 4 variants as a warm fleet of 16384
# lanes with random assignments.
FLEET_N, FLEET_SYS, FLEET_PER = 10, 16, 2048
WARM_FLEET_SYS, WARM_FLEET_B = 4, 16384
# Lanes of the elementwise probe's stream: its two arrays resident in L2
# (10.5 MB at the quadrotor's N=20, F=16), and from device memory (84 MB).
STREAM_LANES = (4096, 32768)
# The one-thread kernels' own pairs (admm_fused.THREAD_KERNEL_DIMS):
# bench_all.py:128-142's cartpole row (N=10, B=32768, max_iter 100, ct 1)
# and its external-plant sequence at B=16384; the degenerate pairs of
# tests/test_degenerate_dims.py:23-26 at its N and at N=10, small; and
# cartpole's other kinds at B=1024: consensus at tests/test_diff.py:171's
# rho_c, a state hyperplane x[0] <= CART_PLANE on the cart position, a
# fleet of CART_FLEET_SYS variants, compaction, the streamed solve at
# CART_STREAM_N.
CART_N, CART_B, CART_PLANT_B = 10, 32768, 16384
DEGENERATE = ((2, 2, 3), (2, 1, 3), (3, 3, 4), (1, 1, 3))
DIMS_SMALL_B = (1000, 1024)
CART_KIND_B, CART_RHO_C, CART_PLANE = 1024, 20.0, 0.2
CART_FLEET_SYS, CART_STREAM_N = 4, 256
# The fused closed loop on one thread a plant (csrc/closed_loop_thread.cu,
# closed_loop_kernel.THREAD_LOOP_DIMS): examples/scenarios.py:181-225's
# rocket landing -- its box alone, the cones configured but off -- as a
# serving loop of T=90 steps along its NTOTAL=100-row sliding reference at
# ct 1; :38-57's cartpole regulation to x = 1 under bench_all.py:128-142's
# box at T=50, ct 5, then phase 7's max_iter 500 regimes; both at
# B=SERVE_B; every pair small at B=1000, T=10.
ROCKET_LOOP_T, ROCKET_NTOTAL = 90, 100
CART_LOOP_T, LOOP_PREFIX_T = 50, 3
LOOP_SMALL_B, LOOP_SMALL_T = 1000, 10


def log(msg):
    print(msg, flush=True)


START = time.perf_counter()


def phase(msg):
    """Log the start of a phase with the seconds since the script began."""
    log(f"{msg} [{time.perf_counter() - START:.1f} s]")


def on_cpu(obj):
    """A copy of a Solution or FusedCarry with every tensor on the CPU."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None})


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no published peak rates for {name!r}")


def problem(tt, torch, max_iter, ct, N=N_HORIZON, device=None, dtype=None):
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=dtype or torch.float32,
                    device=device or DEVICE)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct)


def inputs(torch, B, N=N_HORIZON, spread=0.5):
    x0 = np.random.default_rng(0).uniform(-spread, spread, (B, 12))
    Xref = np.tile(HOVER, (N, 1))
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def rocket_problem(tt, torch, max_iter, ct, dtype=None, N=FAM_N,
                   cones=True):
    """bench_all.py:199-222's rocket landing with its cones (or its box
    alone), through the user's entry points (at horizon N: :343-367's full
    descent)."""
    s = tt.systems.rocket_landing_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, f=s["f"], dtype=dtype or torch.float32,
                    device=DEVICE)
    prob = tt.with_bounds(
        prob, x_min=np.tile([-5.0, -5.0, -0.5, -10.0, -10.0, -20.0],
                            (N, 1)),
        x_max=np.tile([5.0, 5.0, 100.0, 10.0, 10.0, 20.0], (N, 1)),
        u_min=-10.0, u_max=105.0)
    if cones:
        prob = tt.with_cones(prob, state_cones=[(0, 3, 0.25)],
                             input_cones=[(0, 3, 0.5)])
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=2e-3)


def rocket_inputs(torch, B):
    """x0 = xinit U[0.9, 1.2] per lane (default_rng(0)), Xref =
    linspace(xinit, 0, N), Uref[:, 2] = 10."""
    xinit = np.asarray(ROCKET_XINIT)
    x0 = xinit * np.random.default_rng(0).uniform(0.9, 1.2, (B, 1))
    Xref = np.linspace(xinit, np.zeros(6), FAM_N)
    Uref = np.zeros((FAM_N - 1, 3))
    Uref[:, 2] = 10.0
    kw = dict(dtype=torch.float32, device=DEVICE)
    return tuple(torch.as_tensor(a, **kw) for a in (x0, Xref, Uref))


def rocket_descent_inputs(torch, B, N):
    """bench_all.py:359-362: x0 = xinit U[0.9, 1.1] per lane
    (default_rng(0)), Xref = linspace(xinit, 0, N), Uref[:, 2] = 10."""
    xinit = np.asarray(ROCKET_XINIT)
    x0 = xinit * np.random.default_rng(0).uniform(0.9, 1.1, (B, 1))
    Uref = np.zeros((N - 1, 3))
    Uref[:, 2] = 10.0
    kw = dict(dtype=torch.float32, device=DEVICE)
    return tuple(torch.as_tensor(a, **kw) for a in (
        x0, np.linspace(xinit, np.zeros(6), N), Uref))


def long_horizon_inputs(torch, B, N):
    """examples/long_horizon.py: x0 ~ U[-0.3, 0.3]^12 (default_rng(0)) and
    the figure-eight reference over the horizon."""
    t = np.linspace(0, 4 * np.pi, N)
    Xref = np.zeros((N, 12), np.float32)
    Xref[:, 0] = np.sin(t)
    Xref[:, 1] = np.sin(2 * t) / 2
    Xref[:, 2] = 1.0
    x0 = np.random.default_rng(0).uniform(-0.3, 0.3, (B, 12))
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def quad_plane_problem(tt, torch, tv, max_iter, ct, zmax=None, dtype=None):
    """The hyperplane demos of examples/scenarios.py:121-170: quadrotor at
    50 Hz, box off, z <= 3 (tv: z under the demo's first window of
    z_lim_total) and sum(u) <= 6. ``zmax`` (an (N,) ceiling) replaces the
    demo's z ceiling."""
    s = tt.systems.quadrotor_50hz()
    N = FAM_N
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=N, dtype=dtype or torch.float32, device=DEVICE)
    if zmax is None:
        z_lim_total = 1.1 + (3.0 - 1.1) * np.arange(50) / (50 - N - 1)
        zmax = z_lim_total[:N] if tv else np.full(N, 3.0)
    if tv:
        Ax = np.zeros((N, 1, 12))
        Ax[:, 0, 2] = 1.0
        prob = tt.with_tv_linear_constraints(
            prob, Ax, np.asarray(zmax).reshape(N, 1), np.ones((N - 1, 1, 4)),
            np.full((N - 1, 1), 6.0))
    else:
        Ax = np.zeros((1, 12))
        Ax[0, 2] = 1.0
        prob = tt.with_linear_constraints(prob, Ax, [float(zmax[0])],
                                          np.ones((1, 4)), [6.0])
    prob = tt.with_bounds(prob, enable=False)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)


def quad_plane_inputs(torch, B):
    """x0 = [-2, -2, 1, 0...] + 0.1 U[-1, 1]^12 (default_rng(0)), Xref the
    demo's step-0 window from the start toward the goal."""
    start, goal = np.asarray(QUAD_START), np.asarray(QUAD_GOAL)
    x0 = start + 0.1 * np.random.default_rng(0).uniform(-1, 1, (B, 12))
    alpha = np.arange(FAM_N)[:, None] / 49.0
    Xref = (1 - alpha) * start + alpha * goal
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw), None


def fail(label, ok, msg):
    """Record a missed bar (printed now, failing the run at its end)."""
    if not ok:
        FAILURES.append(f"{label}: {msg}")
        log(f"  FAIL {label}: {msg}")


def compare(torch, label, sol_k, sol_p, res_k=None, res_p=None,
            atol=BAR_ATOL, lanes="all", solved_tol=0.0,
            share=BAR_ITER_SHARE, among=None):
    """Kernel against plain version. ``lanes="all"`` holds every lane to
    ``atol`` (the bar); ``lanes="same_iters"`` holds only the lanes whose
    iteration counts agree, for the long regimes where a lane that crosses
    the tolerance one check earlier on one side ends on another iterate; a
    bool tensor names the lanes held. Solved fractions must be identical,
    or within ``solved_tol``. Returns the max abs difference over x and u
    of the lanes held. ``among`` (bool lanes) counts identical iteration
    counts among those lanes only, default all."""
    B = sol_k.iter.shape[0]
    same = sol_k.iter == sol_p.iter
    if isinstance(lanes, str):
        held = torch.ones_like(same) if lanes == "all" else same
    else:
        held, lanes = lanes, "given"
    dx_all = (sol_k.x - sol_p.x).abs().amax(dim=(0, 2))
    du_all = (sol_k.u - sol_p.u).abs().amax(dim=(0, 2))
    dx = dx_all[held].max().item()
    du = du_all[held].max().item()
    same_iter = (same if among is None else same[among]).float().mean() \
        .item()
    sf_k = sol_k.solved.float().mean().item()
    sf_p = sol_p.solved.float().mean().item()
    finite = bool(torch.isfinite(sol_k.x).all() and torch.isfinite(sol_k.u)
                  .all())
    dres = None if res_k is None else (res_k - res_p).abs().max().item()
    bitwise = bool(torch.equal(sol_k.x, sol_p.x) and torch.equal(
        sol_k.u, sol_p.u) and torch.equal(sol_k.iter, sol_p.iter))
    log(f"  {label}: B={B} bitwise={bitwise} lanes held={lanes} "
        f"({held.float().mean().item():.5f}) max|dx|={dx:.3e} "
        f"max|du|={du:.3e} (all lanes {dx_all.max().item():.3e} "
        f"{du_all.max().item():.3e}) max|dres|={dres} "
        f"same_iters={same_iter:.5f} solved_frac kernel={sf_k:.5f} "
        f"plain={sf_p:.5f}")
    fail(label, finite, "kernel output is not finite")
    fail(label, dx <= atol and du <= atol, f"kernel differs from plain "
         f"version by {max(dx, du):.3e} > {atol}")
    fail(label, abs(sf_k - sf_p) <= solved_tol,
         f"solved fraction {sf_k} vs {sf_p}")
    fail(label, same_iter >= share, f"only {same_iter:.4f} of lanes have "
         f"identical iteration counts (bar {share:.4f})")
    return max(dx, du)


def compare_carry(torch, label, c_k, c_p, held, atol=BAR_ATOL):
    """The warm carries' vnew, v, g and y (lane-last) on the held lanes, and
    the family duals, the consensus pair and x/u where the carry has
    them."""
    errs = {}
    names = ("vnew", "v", "g", "y") + tuple(
        k for k in ("gc", "yc", "gl", "yl", "gtv", "ytv", "zc0", "yc0", "x",
                    "u")
        if getattr(c_k, k) is not None)
    for name in names:
        d = (getattr(c_k, name) - getattr(c_p, name)).abs()
        d = d.amax(dim=tuple(range(d.ndim - 1)))
        errs[name] = d[held].max().item()
        fail(label, bool(torch.isfinite(getattr(c_k, name)).all()),
             f"carry.{name} is not finite")
    log(f"  {label} carry: " + " ".join(f"max|d{k}|={v:.3e}"
                                        for k, v in errs.items()))
    fail(label, max(errs.values()) <= atol, f"carry differs from plain "
         f"version by {max(errs.values()):.3e} > {atol}")
    return max(errs.values())


def compare_loop(torch, label, out_k, out_p, share=BAR_ITER_SHARE):
    """Closed loop, kernel against plain version: at least ``share`` (99%)
    identical (step, lane) iteration counts, solved fractions within 0.001,
    and xs/us to 1e-4 on the lanes whose counts agree at every step.
    Returns the max abs difference of the lanes held."""
    xs_k, us_k, it_k, sv_k = out_k
    xs_p, us_p, it_p, sv_p = out_p
    same = it_k == it_p
    held = same.all(dim=0)
    dxs = (xs_k - xs_p).abs().amax(dim=(0, 2))
    dus = (us_k - us_p).abs().amax(dim=(0, 2))
    dx = dxs[held].max().item() if held.any() else float("inf")
    du = dus[held].max().item() if held.any() else float("inf")
    same_iter = same.float().mean().item()
    sf_k = sv_k.float().mean().item()
    sf_p = sv_p.float().mean().item()
    finite = bool(torch.isfinite(xs_k).all() and torch.isfinite(us_k).all())
    log(f"  {label}: T={it_k.shape[0]} B={it_k.shape[1]} lanes held "
        f"{held.float().mean().item():.5f} max|dxs|={dx:.3e} "
        f"max|dus|={du:.3e} (all lanes {dxs.max().item():.3e} "
        f"{dus.max().item():.3e}) same (step, lane) iters={same_iter:.5f} "
        f"solved_frac kernel={sf_k:.5f} plain={sf_p:.5f} mean iters/step "
        f"kernel={it_k.float().mean().item():.4f} "
        f"plain={it_p.float().mean().item():.4f}")
    deltas, counts = torch.unique((it_k - it_p)[~same], return_counts=True)
    log(f"    lanes with other counts, by step: "
        f"{(~same).sum(dim=1).tolist()}; count differences "
        f"{dict(zip(deltas.tolist(), counts.tolist()))}")
    fail(label, finite, "kernel output is not finite")
    fail(label, dx <= BAR_ATOL and du <= BAR_ATOL, f"kernel differs from "
         f"plain version by {max(dx, du):.3e} > {BAR_ATOL}")
    fail(label, abs(sf_k - sf_p) <= BAR_LOOP_SOLVED,
         f"solved fraction {sf_k} vs {sf_p}")
    fail(label, same_iter >= share, f"only {same_iter:.4f} of (step, lane) "
         f"pairs have identical iteration counts (bar {share:.4f})")
    return max(dx, du)


def rounding_floor(torch, tt, label, max_iter, ct, xref, x0, T, opts, out_k,
                   out_p, prob_c=None, prob64=None, Uref=None):
    """Witnesses for a closed loop whose iteration counts sit on float32
    ties: the same plain version on the CPU (every matrix product summed in
    another order) and the port's closed_loop (admm.solve) in float64 on
    the card. Records a failure unless the kernel agrees with the float64
    loop on as many (step, lane) counts as the plain version does, less
    WITNESS_SLACK. Returns the count bar of the kernel against the plain
    version: 99%, or the plain version's agreement with itself across the
    two orders less WITNESS_SLACK where that is lower. The problems
    default to the serving loop's quadrotor at ``max_iter`` and ``ct``."""
    if prob_c is None:
        prob_c = problem(tt, torch, max_iter, ct, N=SERVE_N, device="cpu")
    if prob64 is None:
        prob64 = problem(tt, torch, max_iter, ct, N=SERVE_N,
                         dtype=torch.float64)
    out_c = tt.kernels.closed_loop_fused_reference(
        prob_c, xref.cpu(), x0.cpu(), T,
        None if Uref is None else Uref.cpu(), **opts)
    out_64 = tt.closed_loop(prob64, tt.init_state(prob64, (x0.shape[0],)),
                            x0.double(), xref.double(), T,
                            None if Uref is None else Uref.double(), **opts)
    it_k, it_p, it_c, it_64 = (o[2].cpu() for o in (out_k, out_p, out_c,
                                                     out_64))
    same = lambda a, b: (a == b).float().mean().item()
    s_cp, s_k64, s_p64 = same(it_c, it_p), same(it_k, it_64), same(it_p, it_64)
    log(f"  {label} witnesses: identical (step, lane) counts plain(cpu) vs "
        f"plain(gpu) {s_cp:.5f}, kernel vs closed_loop float64 {s_k64:.5f}, "
        f"plain(gpu) vs float64 {s_p64:.5f}, plain(cpu) vs float64 "
        f"{same(it_c, it_64):.5f}, kernel vs plain(cpu) "
        f"{same(it_k, it_c):.5f}")
    fail(label, s_k64 >= s_p64 - WITNESS_SLACK, f"kernel agrees with the "
         f"float64 loop on {s_k64:.4f} of counts, the plain version on "
         f"{s_p64:.4f}")
    return min(BAR_ITER_SHARE, s_cp - WITNESS_SLACK)


def plain_spread(torch, sol_p, sol_c, among, c_p=None, c_c=None):
    """How far the plain version is from itself when every product is
    summed in another order: its run on the card (``sol_p``, carry
    ``c_p``) against its run on the CPU (``sol_c``, ``c_c``). Returns the
    share of identical counts among the ``among`` lanes, the difference of
    the solved fractions, the largest difference of x, u and the carry's
    fields on the lanes whose counts agree, and those lanes."""
    it_p, it_c = sol_p.iter.cpu(), sol_c.iter.cpu()
    same = it_p == it_c
    held = same & among
    share = same[among].float().mean().item()
    dsf = abs(sol_p.solved.float().mean().item()
              - sol_c.solved.float().mean().item())
    pairs = [(sol_p.x.cpu(), sol_c.x, 1), (sol_p.u.cpu(), sol_c.u, 1)]
    if c_p is not None:     # carry fields are lane-last
        pairs += [(getattr(c_p, f.name).cpu(), getattr(c_c, f.name),
                   getattr(c_p, f.name).ndim - 1)
                  for f in dataclasses.fields(c_p)
                  if getattr(c_p, f.name) is not None]
    dval = 0.0
    for a, b, lane_axis in pairs:
        d = (a - b).abs().amax(dim=tuple(k for k in range(a.ndim)
                                         if k != lane_axis))
        if held.any():
            dval = max(dval, d[held].max().item())
    return share, dsf, dval, held


def spread_bars(label, share_c, dsf_c, dval_c, B):
    """Bars of a kernel-vs-plain comparison from the plain version's own
    spread: identical counts at least min(99%, its share less
    WITNESS_SLACK); solved fractions within its difference plus one lane;
    values within max(1e-4, twice its value difference)."""
    share = min(BAR_ITER_SHARE, share_c - WITNESS_SLACK)
    solved_tol = dsf_c + 1 / B
    atol = max(BAR_ATOL, 2 * dval_c)
    log(f"  {label} plain(gpu) vs plain(cpu): identical counts "
        f"{share_c:.5f}, solved fractions {dsf_c:.5f} apart, max value "
        f"difference {dval_c:.3e} on agreeing lanes -> bars: counts "
        f"{share:.4f}, solved {solved_tol:.5f}, values {atol:.3e}")
    return share, solved_tol, atol


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def host_ms(torch, fn):
    """Milliseconds of one call of ``fn`` on the host clock, to the end of
    its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def family_ops(spec):
    """Operations of the constraint families beyond the box in one ADMM
    iteration of one lane (1 each for an add, multiply, divide, square
    root, compare or select): per row and family the candidate x + dual,
    the dual update and the linear-cost term (6 a feature); per cone and
    row the norm, the case select and the scale (3 (dim - 1) + 10); per
    hyperplane and row the dot, the test, the step (val - b) / ||a||^2 and
    the axpy (4 F + 3). ||a||^2 is an input: it is summed once, when the
    table is packed, not per lane."""
    ops = 0
    for rows, F, cones, nlin, ntv in (
            (spec.N, spec.nx, spec.enabled_state_cones, spec.n_state_lin,
             spec.n_tv_state_lin),
            (spec.N - 1, spec.nu, spec.enabled_input_cones, spec.n_input_lin,
             spec.n_tv_input_lin)):
        families = bool(cones) + bool(nlin) + bool(ntv)
        ops += rows * (6 * F * families
                       + sum(3 * (dim - 1) + 10 for _, dim in cones)
                       + (nlin + ntv) * (4 * F + 3))
    return ops


def iteration_ops(N, nx, nu):
    """Operations of one ADMM iteration of one lane: the backward sweep's
    [B';AmBKt]p, Quu w and Kinf'r products and the forward sweep's
    [Kinf;A]x and Bu products (an FMA counts as 2 operations), plus the
    elementwise work of the linear cost, projection and dual update (1
    each)."""
    fma = (N - 1) * ((nu + nx) * nx + nu * nu + nx * nu) \
        + (N - 1) * ((nu + nx) * nx + nx * nu)
    elementwise = (N - 1) * (6 * nx + 5 * nu) + N * nx * 5 \
        + (N - 1) * (nu * 6 + 2 * nx)
    return 2 * fma + elementwise


def fused_work(N, nx, nu, B, iter_sum, carry_floats=0, spec=None):
    """Operations and bytes a fused solve needs for this run: the run's
    summed iteration count times :func:`iteration_ops` (plus
    :func:`family_ops` of ``spec``); bytes are x0 read once and x, u,
    iterations, solved flags and residuals written once, plus a warm
    carry of ``carry_floats`` floats a lane read and written once."""
    per_iter = iteration_ops(N, nx, nu) + (0 if spec is None
                                           else family_ops(spec))
    ops = float(iter_sum) * per_iter
    nbytes = 4 * B * nx + 4 * B * (N * nx + (N - 1) * nu) + B * (4 + 1 + 16)
    nbytes += 2 * 4 * B * carry_floats
    return ops, nbytes


def consensus_ops(G, nu):
    """Operations consensus adds to one ADMM iteration of one lane: the
    group sum of the offers (G), and per feature the offer, the dual
    update and the residual (3 nu). The step-0 gains replace Kinf and
    Quu_inv in products counted already."""
    return G + 3 * nu


def adaptive_ops(N, nx, nu, apply_c):
    """Operations adaptive rho adds to one ADMM iteration of one lane: the
    sensitivity products dKinf x and dKinf^T r of every row (and dC1 w,
    dC2 p under apply_c), each scaled by drho and added (2 operations an
    output), and the terminal term's drho * (-dPinf^T Xref) (2 a
    feature)."""
    return sum(adaptive_sweep_ops(N, nx, nu, apply_c))


def adaptive_sweep_ops(N, nx, nu, apply_c):
    """:func:`adaptive_ops` split between the backward sweep (dKinf^T r,
    the terminal term, and dC1 w, dC2 p under apply_c) and the forward
    sweep (dKinf x): (backward, forward)."""
    bwd = 2 * (N - 1) * nx * nu + 2 * ((N - 1) * nx + nx)
    if apply_c:
        bwd += 2 * (N - 1) * (nu * nu + nx * nx) + 2 * (N - 1) * (nu + nx)
    return bwd, 2 * (N - 1) * nu * nx + 2 * (N - 1) * nu


def adaptation_ops(N, nx, nu):
    """Operations of one rho adaptation of one lane (every 5th iteration):
    A^T g and B^T g of every dynamics row, Pinf x and dPinf x of the last
    state, the dynamics rows (A x + B u) - x+ (1 a feature; the products
    are the rollout's), the elementwise P x + q + A^T y terms and the
    max-abs updates of the residuals and norms (10 a feature), and the
    prediction (10)."""
    fma = (N - 1) * (nx * nx + nu * nx) + 2 * nx * nx
    elementwise = (N - 1) * nx + 10 * (N * nx + (N - 1) * nu) + 10
    return 2 * fma + elementwise


def adaptations(iters):
    """Adaptations a lane that ran ``iters`` iterations made: iterations
    5, 10, ... below ``iters``, summed over the lanes."""
    return int(((iters.long() - 1).clamp(min=0) // 5).sum().item())


def adaptive_work(N, nx, nu, B, iters, apply_c, carry_floats=0, spec=None):
    """Operations and bytes of an adaptive fused solve for this run: the
    fixed-rho work of :func:`fused_work` (with the families of ``spec``)
    plus :func:`adaptive_ops` on every iteration and
    :func:`adaptation_ops` on every adaptation the run made; bytes add the
    final rho row (and a warm carry, rho included)."""
    iter_sum = int(iters.sum().item())
    ops, nbytes = fused_work(N, nx, nu, B, iter_sum, carry_floats, spec)
    ops += float(iter_sum) * adaptive_ops(N, nx, nu, apply_c) \
        + float(adaptations(iters)) * adaptation_ops(N, nx, nu)
    return ops, nbytes + 4 * B


def compare_rho(label, rho_k, rho_p, held, rtol=RHO_RTOL):
    """Final rho rows of kernel and plain version on the held lanes,
    within ``rtol``; returns the largest relative difference."""
    rel = ((rho_k - rho_p).abs() / rho_p.abs())[held]
    worst = rel.max().item() if held.any() else 0.0
    moved = (rho_k != rho_k.flatten()[0]).float().mean().item()
    log(f"  {label}: final rho max rel diff {worst:.3e} on held lanes; "
        f"quartiles {[round(q, 4) for q in quartiles(rho_k)]}")
    fail(label, worst <= rtol and bool((rho_k > 0).all()),
         f"final rho differs by {worst:.3e} > {rtol} (or is not positive)")
    return worst


def quartiles(t):
    t = t.flatten().float().cpu()
    return [t.quantile(q).item() for q in (0.0, 0.25, 0.5, 0.75, 1.0)]


def lane_carry_floats(carry):
    """Floats a lane of a warm carry holds."""
    return sum(getattr(carry, f.name)[..., 0].numel()
               for f in dataclasses.fields(carry)
               if getattr(carry, f.name) is not None)


def loop_work(N, nx, nu, B, T, iter_sum):
    """Operations and bytes of a fused closed loop for this run: the summed
    (step, lane) iteration count times :func:`iteration_ops`, plus per step
    and lane the terminal reference term Pinf^T x (nx^2 FMA) and the plant
    step A x + B u + f; bytes are x0 and the reference read once and xs,
    us, iterations and solved flags written once."""
    per_step = 2 * nx * nx + 2 * (nx * nx + nx * nu) + 2 * nx
    ops = float(iter_sum) * iteration_ops(N, nx, nu) \
        + float(T * B) * per_step
    nbytes = 4 * B * nx + 4 * (T + N - 1) * nx \
        + T * B * (4 * nx + 4 * nu + 4 + 1)
    return ops, nbytes


def bound(ops, nbytes, peak_flops, peak_bw):
    t_ops, t_bytes = ops / peak_flops, nbytes / peak_bw
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def ptxas_entries(text):
    """Registers, stack frame and spill bytes of each entry function in
    ``nvcc -Xptxas -v`` output, by mangled name."""
    out, cur, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None and props == cur:
            out[cur].update(stack=int(m[1]), spill_st=int(m[2]),
                            spill_ld=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur]["regs"] = int(m[1])
    return out


def kernel_label(fn):
    """A readable name for a mangled kernel name of csrc/."""
    a = re.search(r"AdaptiveRhoILi\d+ELi\d+ELb([01])E", fn)
    adapt = "" if a is None else \
        "adaptive apply_c" if a[1] == "1" else "adaptive"
    m = re.search(r"stream_(backward|forward)_team_kernelILi(\d+)ELi(\d+)E",
                  fn)
    if m:
        fam = " families" if "TeamFamilies" in fn else ""
        fam += " consensus" if "TeamConsensus" in fn else ""
        return (f"admm_stream {m[1]} team{fam}"
                f"{' ' + adapt if adapt else ''} ({m[2]}, {m[3]})")
    m = re.search(r"dot_independent_mma_kernelILi(\d+)E", fn)
    if m:
        return f"roofline dot independent bf16 mma ({m[1]})"
    m = re.search(r"stream_(backward|forward)_kernelILi(\d+)ELi(\d+)E"
                  r"Lb([01])E(?:Lb([01])E)?", fn)
    if m:
        # backward<NX, NU, CONS, Rho>, forward<NX, NU, STALE, CONS, Rho>
        stale, cons = (m[4], m[5]) if m[1] == "forward" else ("0", m[4])
        return (f"admm_stream {m[1]}{' stale' if stale == '1' else ''}"
                f"{' consensus' if cons == '1' else ''}"
                f"{' ' + adapt if adapt else ''} ({m[2]}, {m[3]})")
    m = re.search(r"ILi(\d+)ELi(\d+)ELb([01])EN7tinympc\d+(NoFamilies|"
                  r"Families)", fn)
    if m:
        kind = "families" if m[4] == "Families" else "box"
        if adapt:
            kind = adapt if kind == "box" else f"families {adapt}"
        if "ConsensusILi" in fn:
            kind = "families consensus"
        mode = "warm" if m[3] == "1" else "cold"
        multi = " multi" if re.search(r"Lb1EEEv", fn) else ""
        return f"admm_fused {kind} {mode}{multi} ({m[1]}, {m[2]})"
    # The group kernels' PLACE (csrc/admm_group.cuh Place)
    place = {"0": "", "1": " table in device memory",
             "2": " saved columns in device memory"}
    # ... and its KIND (csrc/admm_group.cu Kind)
    kinds = {"0": "box", "1": "consensus", "2": "adaptive",
             "3": "adaptive apply_c", "4": "families",
             "5": "families adaptive", "6": "families adaptive apply_c"}
    m = re.search(r"admm_group_kernelILi(\d+)ELi(\d+)ELb([01])ELi(\d)E"
                  r"Li(\d)E", fn)
    if m:
        return (f"admm_group {kinds[m[5]]} "
                f"{'warm' if m[3] == '1' else 'cold'} "
                f"({m[1]}, {m[2]}){place[m[4]]}")
    m = re.search(r"closed_loop_group_kernelILi(\d+)ELi(\d+)ELi(\d)E", fn)
    if m:
        return f"closed_loop_fused ({m[1]}, {m[2]}){place[m[3]]}"
    m = re.search(r"closed_loop_thread_kernelILi(\d+)ELi(\d+)E", fn)
    if m:
        return f"closed_loop_thread ({m[1]}, {m[2]})"
    return fn


def check_rounding(torch, lib, n=1 << 24):
    """The families kernel's division and square root (div_rn, sqrt_rn in
    csrc/admm_families.cuh) against IEEE's, bitwise, on n random float
    pairs of every exponent plus zeros, infinities, NaN and subnormals.
    Returns the number of results that differ."""
    import ctypes
    g = torch.Generator(device="cpu").manual_seed(0)
    bits = torch.randint(-2 ** 31, 2 ** 31, (2, n), generator=g,
                         dtype=torch.int64).to(torch.int32)
    a, b = bits.view(torch.float32).to(DEVICE)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-45, -1e-45, 1.1754942e-38,
                            3.4028235e38, 1.0, 3.0, 0.25],
                           device=DEVICE)
    k = special.numel()
    a[:k * k] = special.repeat_interleave(k)
    b[:k * k] = special.repeat(k)
    q, r = torch.empty_like(a), torch.empty_like(a)
    fn = lib.tinympc_admm_fused_check_rounding
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    err = fn(n, a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rounding check launch failed: CUDA error {err}")
    torch.cuda.synchronize()

    def differ(x, y):
        both_nan = torch.isnan(x) & torch.isnan(y)
        return int(((x.view(torch.int32) != y.view(torch.int32))
                    & ~both_nan).sum().item())

    return differ(q, a / b) + differ(r, torch.sqrt(a.abs()))


def adaptive_problem(tt, torch, rho, N, max_iter, ct, tol=1.0, apply_c=False,
                     tables=None):
    """The quadrotor of bench_all.py:401-403 with adaptive rho, through the
    user's entry points: with_settings computes the rho sensitivities
    (compute_sensitivities) unless ``tables`` (dKinf, dPinf, dC1, dC2) are
    given."""
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=rho, N=N,
                    dtype=torch.float32, device=DEVICE)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    if tables is not None:
        prob = tt.with_sensitivities(prob, tables)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct,
                            adaptive_rho=True, adaptive_rho_tolerance=tol,
                            adaptive_rho_apply_c=apply_c)


def sensitivity_tables(prob):
    c = prob.cache
    return c.dKinf_drho, c.dPinf_drho, c.dC1_drho, c.dC2_drho


def adaptive_small(torch, tt, convert, label, prob, x0, Xref, B, Uref=None):
    """An adaptive cold batch, kernel against its plain version on the CPU
    at the default bar, and against its plain version on the card at the
    bar of the plain version's own spread between the two (its counts,
    solved fraction and values; never looser than the default bar); final
    rho within RHO_RTOL on the lanes whose counts agree. (A fixed-rho batch
    is held the same way, without the rho row.) Returns the kernel's
    solution and residuals."""
    prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                        "cpu")
    cpu = lambda a: None if a is None else a.cpu()
    sol_k, res_k = tt.kernels.solve_fused(prob, Xref, Uref, x0)
    sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref, Uref, x0)
    sol_c, res_c = tt.kernels.solve_fused_reference(prob_c, cpu(Xref),
                                                    cpu(Uref), x0.cpu())
    torch.cuda.synchronize()
    everyone = torch.ones(B, dtype=torch.bool)
    share, solved_tol, atol = spread_bars(
        label, *plain_spread(torch, sol_p, sol_c, everyone)[:3], B)
    sol_kc = on_cpu(sol_k)
    for other, sol_o, res_o, bars in (
            ("plain(cpu)", sol_c, res_c, {}),
            ("plain(gpu)", on_cpu(sol_p), res_p.cpu(),
             dict(atol=atol, solved_tol=solved_tol, share=share))):
        name = f"{label} vs {other}"
        compare(torch, name, sol_kc, sol_o, lanes="same_iters", **bars)
        if res_k.shape[0] == 5:
            compare_rho(name, res_k[4].cpu(), res_o[4],
                        sol_kc.iter == sol_o.iter)
    moved = (res_k[4] != float(prob.cache.rho)).float().mean().item() \
        if res_k.shape[0] == 5 else 0.0
    log(f"  {label}: lanes whose rho moved {moved:.5f}, mean iters "
        f"{sol_k.iter.float().mean().item():.4f}, solved frac "
        f"{sol_k.solved.float().mean().item():.5f}")
    return sol_k, res_k


def adaptive_warm_small(torch, tt, convert, label, prob, x, Xref, B,
                        Uref=None, steps=5, carry_spread=False):
    """An adaptive external-plant sequence of ``steps`` warm solves, rho
    riding the carry, the plant stepped with the kernel's u0; each step held
    on the lanes whose counts agree at every step so far: against the plain
    version on the CPU at the default bar, on the card at the plain
    version's own spread; the carried rho within RHO_RTOL. With
    ``carry_spread`` the carry is held against the plain version on the CPU
    to that spread too: its scaled duals grow as 1/rho, so where rho falls
    far below 1 their rounding passes the absolute bar while x and u meet
    it. A fixed-rho sequence is held the same way, without the rho. Returns
    the kernel's (solution, residuals, carry) of each step."""
    prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                        "cpu")
    cpu = lambda a: None if a is None else a.cpu()
    c_k, c_p, c_c = (tt.init_carry(prob, B), tt.init_carry(prob, B),
                     tt.init_carry(prob_c, B))
    outs = []
    agreed = {o: torch.ones(B, dtype=torch.bool)
              for o in ("plain(cpu)", "plain(gpu)")}
    for step in range(steps):
        sol_k, res_k, c_k = tt.kernels.solve_fused_warm(prob, Xref, Uref, x,
                                                        c_k)
        outs.append((sol_k, res_k, c_k))
        sol_p, res_p, c_p = tt.kernels.solve_fused_warm_reference(
            prob, Xref, Uref, x, c_p)
        sol_c, res_c, c_c = tt.kernels.solve_fused_warm_reference(
            prob_c, cpu(Xref), cpu(Uref), x.cpu(), c_c)
        torch.cuda.synchronize()
        name = f"{label} B={B} step {step}"
        share_c, dsf_c, dval_c, _ = plain_spread(
            torch, sol_p, sol_c, agreed["plain(gpu)"], c_p, c_c)
        share, solved_tol, atol = spread_bars(name, share_c, dsf_c, dval_c,
                                              B)
        sol_kc, c_kc = on_cpu(sol_k), on_cpu(c_k)
        for other, sol_o, c_o, bars in (
                ("plain(cpu)", sol_c, c_c, {}),
                ("plain(gpu)", on_cpu(sol_p), on_cpu(c_p),
                 dict(atol=atol, solved_tol=solved_tol, share=share))):
            before = agreed[other].clone()
            agreed[other] &= sol_kc.iter == sol_o.iter
            compare(torch, f"{name} vs {other}", sol_kc, sol_o,
                    lanes=agreed[other], among=before, **bars)
            compare_carry(torch, f"{name} vs {other}", c_kc, c_o,
                          agreed[other],
                          atol=atol if carry_spread else bars.get(
                              "atol", BAR_ATOL))
            if c_kc.rho is not None:
                compare_rho(f"{name} vs {other}", c_kc.rho[0], c_o.rho[0],
                            agreed[other])
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
    return outs


def adaptive_phases(torch, tt, convert, admm_fused, counters, card,
                    peak_flops, peak_bw):
    """Phases 13-16: box adaptive rho at (12, 4) on the thread-group
    kernel (csrc/admm_group.cu, tinympc_admm_group_adaptive). Returns the
    kernels-line numbers of the cold hard batch and of the warm
    external-plant sequence, and the quadrotor's sensitivity tables at each
    rho0 it set up."""
    # 13. small batches against the plain version, on the card and the CPU
    phase(f"phase 13: adaptive kernel vs plain versions, B={ADAPT_SMALL_B}")
    t0 = time.perf_counter()
    prob5 = adaptive_problem(tt, torch, 5.0, N_HORIZON, ADAPT_ITER, 1)
    torch.cuda.synchronize()
    sens5_ms = 1e3 * (time.perf_counter() - t0)
    t5 = sensitivity_tables(prob5)
    t0 = time.perf_counter()
    prob85 = adaptive_problem(tt, torch, MISTUNED_RHO, N_HORIZON, ADAPT_ITER,
                              1)
    torch.cuda.synchronize()
    sens85_ms = 1e3 * (time.perf_counter() - t0)
    t85 = sensitivity_tables(prob85)
    # compute_sensitivities alone, on host tensors.
    c = prob5.cache
    args = [a.cpu() for a in (prob5.A, prob5.B, prob5.f,
                                prob5.Qdiag - c.rho, prob5.Rdiag - c.rho,
                                c.rho)]
    t0 = time.perf_counter()
    t5_host = tt.riccati.compute_sensitivities(*args)
    host5_ms = 1e3 * (time.perf_counter() - t0)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(t5, t5_host))
    log(f"  setup with compute_sensitivities (on the host, the tables "
        f"moved to the card; set-up): rho 5 {sens5_ms:.1f} ms, rho "
        f"{MISTUNED_RHO} {sens85_ms:.1f} ms; compute_sensitivities alone, "
        f"rho 5: {host5_ms:.1f} ms, tables bitwise with_settings': {same}")
    B = ADAPT_SMALL_B
    x0, Xref = inputs(torch, B)
    zero_entries(admm_fused)
    for label, rho, mi, tol, apply_c, tables in (
            ("adaptive rho_tol 1", 5.0, 100, 1.0, False, t5),
            ("adaptive rho_tol 3 rho0 85", MISTUNED_RHO, ADAPT_ITER, 3.0,
             False, t85),
            ("adaptive apply_c", 5.0, 100, 1.0, True, t5)):
        prob = adaptive_problem(tt, torch, rho, N_HORIZON, mi, 1, tol,
                                apply_c, tables)
        adaptive_small(torch, tt, convert, f"{label} cold B={B}", prob, x0,
                       Xref, B)
    # Warm: six solves of an external plant, rho riding the carry.
    prob = adaptive_problem(tt, torch, 5.0, SERVE_N, 100, 1, tables=t5)
    x, Xref = inputs(torch, B, N=SERVE_N, spread=0.3)
    adaptive_warm_small(torch, tt, convert, "adaptive warm", prob, x, Xref,
                        B, steps=6)
    # Box adaptive rho at (12, 4) runs the thread-group kernel's adaptive
    # entry: 3 cold solves and 6 warm ones.
    took_entries(admm_fused, "adaptive small batches", {GROUP_ADAPT: 9})

    # 14. the adaptive hard batch at full width, and fixed rho beside it
    phase(f"phase 14: adaptive hard batch, B={ADAPT_B}, N={N_HORIZON}, "
          f"max_iter {ADAPT_ITER}, ct 1")
    x0, Xref = inputs(torch, ADAPT_B)
    zero_counts(counters)
    sol_k, res_k = tt.kernels.solve_fused(prob5, Xref, None, x0)
    torch.cuda.synchronize()
    launches = admm_fused.adaptive_launch_count
    if launches < 1:
        raise AssertionError("the adaptive hard batch did not launch the "
                             "adaptive kernel")
    took_entries(admm_fused, "adaptive hard batch", {GROUP_ADAPT: launches})
    if sol_k.x.shape != (N_HORIZON, ADAPT_B, 12) or \
            res_k.shape != (5, ADAPT_B):
        raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                             f"{res_k.shape}")
    plain_ms, (sol_p, res_p) = host_ms(
        torch, lambda: tt.kernels.solve_fused_reference(prob5, Xref, None,
                                                        x0))
    # Over 500 iterations the agreed lanes are held to 1e-3, the bar of
    # the cold max_iter 500 regime.
    err = compare(torch, "adaptive hard batch", sol_k, sol_p, res_k[:4],
                  res_p[:4], atol=1e-3, lanes="same_iters")
    compare_rho("adaptive hard batch", res_k[4], res_p[4],
                sol_k.iter == sol_p.iter)

    def time_cold(prob):
        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        run = lambda: admm_fused._solve_kernel(tables, x0c, N_HORIZON, 12, 4,
                                               **params)
        sol = run()[0]                                  # warm-up
        ms, times = cuda_ms(torch, run, 5)
        call_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.solve_fused(prob, Xref, None,
                                                          x0))[0]
            for _ in range(3))
        return sol, ms, times, call_ms

    sol_t, ms, times, call_ms = time_cold(prob5)
    ops, nbytes = adaptive_work(N_HORIZON, 12, 4, ADAPT_B, sol_t.iter, False)
    bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    mean_it = sol_k.iter.float().mean().item()
    log(f"  adaptive hard batch: kernel {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), solve_fused call {call_ms:.4f} ms "
        f"on the host clock (kernel share {ms / call_ms:.4f}), "
        f"{ADAPT_B / (ms / 1e3):.1f} solves/s, solved frac "
        f"{sol_k.solved.float().mean().item():.5f}, mean iters "
        f"{mean_it:.4f} ({ms / mean_it:.5f} ms per mean iteration), "
        f"adaptations {adaptations(sol_k.iter)}, final rho quartiles "
        f"{[round(q, 4) for q in quartiles(res_k[4])]}, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.1f} ms, launches "
        f"{launches}; card {card}")
    fixed = tt.with_settings(prob5, adaptive_rho=False)
    sol_f, ms_f, times_f, call_f = time_cold(fixed)
    mean_f = sol_f.iter.float().mean().item()
    log(f"  fixed rho, same inputs: kernel {ms_f:.4f} ms (reps "
        f"{[round(t, 4) for t in times_f]}), call {call_f:.4f} ms, solved "
        f"frac {sol_f.solved.float().mean().item():.5f}, mean iters "
        f"{mean_f:.4f} ({ms_f / mean_f:.5f} ms per mean iteration); "
        f"adaptive / fixed time {ms / ms_f:.4f}, per mean iteration "
        f"{(ms / mean_it) / (ms_f / mean_f):.4f}")
    rows = {"adaptive": dict(launches=launches, err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)}

    # 15. mis-tuned rho0: fixed, adaptive, guarded, at bench_all.py's 85
    # and at DETUNED_RHO, where the adaptation must solve more lanes than
    # fixed rho does
    phase(f"phase 15: mis-tuned rho0 {MISTUNED_RHO} and {DETUNED_RHO}, "
          f"B={ADAPT_B}: fixed / adaptive / guarded tol 3")
    t0 = time.perf_counter()
    prob_d = adaptive_problem(tt, torch, DETUNED_RHO, N_HORIZON, ADAPT_ITER, 1)
    torch.cuda.synchronize()
    sens = {5.0: t5, MISTUNED_RHO: t85,
            DETUNED_RHO: sensitivity_tables(prob_d)}
    log(f"  setup with compute_sensitivities at rho {DETUNED_RHO} "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms (set-up)")
    for rho0, base in ((MISTUNED_RHO, prob85), (DETUNED_RHO, prob_d)):
        fractions = {}
        for label, ad, tol in (("fixed rho", False, 1.0),
                               ("adaptive rho", True, 1.0),
                               ("adaptive guarded tol=3", True, 3.0)):
            name = f"rho0 {rho0:g} {label}"
            prob = tt.with_settings(base, adaptive_rho=ad,
                                    adaptive_rho_tolerance=tol)
            zero_entries(admm_fused)
            sol, res = tt.kernels.solve_fused(prob, Xref, None, x0)
            took_entries(admm_fused, name, {
                GROUP_ADAPT if ad else "tinympc_admm_group": 1})
            if ad:
                sol_p, res_p = tt.kernels.solve_fused_reference(
                    prob, Xref, None, x0)
                compare(torch, name, sol, sol_p, res[:4], res_p[:4],
                        atol=1e-3, lanes="same_iters")
                compare_rho(name, res[4], res_p[4], sol.iter == sol_p.iter)
            _, ms_m, _, _ = time_cold(prob)
            fractions[label] = sol.solved.float().mean().item()
            log(f"  {name}: solved frac {fractions[label]:.5f}, mean iters "
                f"{sol.iter.float().mean().item():.4f}, kernel {ms_m:.4f} "
                f"ms, {ADAPT_B / (ms_m / 1e3):.1f} solves/s"
                + (f", final rho quartiles "
                   f"{[round(q, 4) for q in quartiles(res[4])]}" if ad
                   else "") + f"; card {card}")
        if rho0 == DETUNED_RHO:
            for label in ("adaptive rho", "adaptive guarded tol=3"):
                fail(f"rho0 {rho0:g} {label}",
                     fractions[label] > fractions["fixed rho"],
                     f"solves {fractions[label]:.5f} of lanes, fixed rho "
                     f"{fractions['fixed rho']:.5f}: the adaptation does "
                     "not help")

    # 16. adaptive external-plant sequence (phase 8's set-up)
    phase(f"phase 16: adaptive external-plant sequence, B={SERVE_B}, 5 warm "
          f"solves")
    prob = adaptive_problem(tt, torch, 5.0, SERVE_N, 100, 1, tables=t5)
    rng = np.random.default_rng(0)
    hover = torch.as_tensor(HOVER, dtype=torch.float32, device=DEVICE)
    Xref = hover.expand(SERVE_N, 12).contiguous()
    x = hover + torch.as_tensor(rng.uniform(-0.3, 0.3, (SERVE_B, 12)),
                                dtype=torch.float32, device=DEVICE)
    c_k = tt.init_carry(prob, SERVE_B)
    zero_counts(counters)
    states, sols, carries = [], [], []
    for step in range(5):
        sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, None, x, c_k)
        states.append(x)
        sols.append(sol_k)
        carries.append(c_k)
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
    torch.cuda.synchronize()
    warm_launches = admm_fused.adaptive_warm_launch_count
    if warm_launches < 5:
        raise AssertionError("the adaptive sequence did not launch the warm "
                             "adaptive kernel")
    took_entries(admm_fused, "adaptive external-plant sequence",
                 {GROUP_ADAPT: warm_launches})
    c_p = tt.init_carry(prob, SERVE_B)
    agreed = torch.ones(SERVE_B, dtype=torch.bool, device=DEVICE)
    err_w = 0.0
    for step, (x_s, sol_k, c_ks) in enumerate(zip(states, sols, carries)):
        plain_w_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_warm_reference(
                prob, Xref, None, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_w = max(err_w, compare(torch, f"adaptive warm step {step}",
                                   sol_k, sol_p, lanes=agreed,
                                   solved_tol=2 / SERVE_B))
        compare_rho(f"adaptive warm step {step}", c_ks.rho[0], c_p.rho[0],
                    agreed)
        log(f"  step {step}: mean iters "
            f"{sol_k.iter.float().mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}")
    compare_carry(torch, "adaptive after 5 steps", c_k, c_p, agreed)
    tables, xc, params = admm_fused._prepare(prob, Xref, None, x)
    carry = admm_fused._carry_tensors(prob, c_k, SERVE_B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, SERVE_N,
                                                12, 4, **params)
    sol_w = run()[0]                                    # warm-up
    w_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: tt.kernels.solve_fused_warm(prob, Xref, None,
                                                           x, c_k))[0]
        for _ in range(REPS))
    ops, nbytes = adaptive_work(SERVE_N, 12, 4, SERVE_B, sol_w.iter, False,
                                lane_carry_floats(c_k))
    w_bound_ms, w_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  adaptive solve_fused_warm (the sixth solve): kernel {w_ms:.4f} "
        f"ms (reps {[round(t, 4) for t in times]}), whole call "
        f"{call_ms:.4f} ms on the host clock (kernel share "
        f"{w_ms / call_ms:.4f}), plain {plain_w_ms:.1f} ms, bound "
        f"{w_bound_ms:.4f} ms ({w_bound_by}), mean iters "
        f"{sol_w.iter.float().mean().item():.4f}, "
        f"{SERVE_B / (w_ms / 1e3):.1f} solves/s, adaptive warm launches "
        f"{warm_launches}; card {card}")
    rows["adaptive_warm"] = dict(launches=warm_launches, err=err_w, ms=w_ms,
                                 plain_ms=plain_w_ms, bound_ms=w_bound_ms,
                                 bound_by=w_bound_by)
    return rows, sens


def stream_floats(spec, track=False, adaptive=False):
    """Floats one lane's backward and forward launch read and write in one
    iteration, each array once: the backward reads vnew, g, znew, y and
    each family's slack and dual and writes d; the forward reads x0, g, y,
    d, the previous slacks and each family's dual and writes the slacks,
    the duals and each family's slack and dual (and, tracked, x and u).
    Under consensus the backward also reads each lane's zc0 and yc0, and
    the forward reads and writes them (a lane that converges in the launch
    also writes its standing offer, nu floats, which the caller counts
    from the run's data). Under adaptive rho the backward also reads each
    lane's rho, and the forward reads and writes its rho and virtual rho
    (the scratch of an adaptation iteration is the launch's own). Returns
    (backward, forward)."""
    N, nx, nu = spec.N, spec.nx, spec.nu
    cb, cf = (2 * nu, 4 * nu) if spec.en_consensus else (0, 0)
    if adaptive:
        cb, cf = cb + 1, cf + 4
    fx = sum(map(bool, (spec.enabled_state_cones, spec.n_state_lin,
                        spec.n_tv_state_lin)))
    fu = sum(map(bool, (spec.enabled_input_cones, spec.n_input_lin,
                        spec.n_tv_input_lin)))
    sx, su = N * nx, (N - 1) * nu
    bwd = 2 * sx + 3 * su + 2 * fx * sx + 2 * fu * su + cb
    fwd = nx + 4 * sx + 5 * su + 3 * fx * sx + 3 * fu * su + cf
    return bwd, fwd + (sx + su if track else 0)


def stream_ops(spec, group=0, adapt=None):
    """Operations of one lane's backward and forward launch, as
    iteration_ops and family_ops count them: the backward sweep's
    products and linear cost (with each family's term, 3 a feature), the
    forward sweep's products, projections and dual updates; under
    consensus in groups of ``group`` lanes, r[0]'s term (3 a feature) and
    consensus_ops (the step-0 gains replace products counted already);
    under adaptive rho (``adapt``, the settings) the telescoped products of
    :func:`adaptive_sweep_ops` (an adaptation's pass is counted per
    adaptation, :func:`adaptation_ops`)."""
    N, nx, nu = spec.N, spec.nx, spec.nu
    fx = sum(map(bool, (spec.enabled_state_cones, spec.n_state_lin,
                        spec.n_tv_state_lin)))
    fu = sum(map(bool, (spec.enabled_input_cones, spec.n_input_lin,
                        spec.n_tv_input_lin)))
    cost = 3 * (N * nx * fx + (N - 1) * nu * fu)
    bwd = 2 * (N - 1) * ((nu + nx) * nx + nu * nu + nx * nu) \
        + (N - 1) * (6 * nx + 5 * nu) + cost
    fwd = 2 * (N - 1) * ((nu + nx) * nx + nx * nu) + N * nx * 5 \
        + (N - 1) * (nu * 6 + 2 * nx) + family_ops(spec) - cost
    if spec.en_consensus:
        bwd, fwd = bwd + 3 * nu, fwd + consensus_ops(group, nu)
    if adapt is not None:
        ab, af = adaptive_sweep_ops(N, nx, nu, adapt.adaptive_rho_apply_c)
        bwd, fwd = bwd + ab, fwd + af
    return bwd, fwd


def cut(obj, B):
    """A Solution, or a carry (lane-last), cut to its first B lanes."""
    if hasattr(obj, "solved"):
        return dataclasses.replace(obj, iter=obj.iter[:B],
                                   solved=obj.solved[:B], x=obj.x[:, :B],
                                   u=obj.u[:, :B])
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name)[..., :B] for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None})


def plain_wide(torch, fn, prob, Xref, Uref, x0, carry=None):
    """The streamed plain version ``fn`` on the card for the B lanes of x0,
    run on the batch repeated to WIDE_B lanes and cut back: at that width
    cuBLAS sums each product in the kernels' column order (at smaller ones
    it does not), and no lane's result depends on the others."""
    B = x0.shape[0]
    k = max(1, WIDE_B // B)
    if carry is None:
        sol, res = fn(prob, Xref, Uref, x0.repeat(k, 1))
        return cut(sol, B), res[:, :B]
    wide = dataclasses.replace(carry, **{
        f.name: torch.cat([getattr(carry, f.name)] * k, dim=-1)
        for f in dataclasses.fields(carry)
        if getattr(carry, f.name) is not None})
    sol, res, c = fn(prob, Xref, Uref, x0.repeat(k, 1), wide)
    return cut(sol, B), res[:, :B], cut(c, B)


def same_bits(torch, label, a, b, what):
    """Two solves that must agree bitwise: x, u, counts, flags, residuals
    and, warm, every carry field. Returns whether they do."""
    same = all(torch.equal(getattr(a[0], k), getattr(b[0], k))
               for k in ("x", "u", "iter", "solved")) and torch.equal(a[1],
                                                                      b[1])
    if len(a) > 2:
        same = same and all(
            torch.equal(getattr(a[2], f.name), getattr(b[2], f.name))
            for f in dataclasses.fields(a[2])
            if getattr(a[2], f.name) is not None)
    log(f"  {label}: bitwise against {what}: {same}")
    fail(label, same, f"not bitwise equal to {what}")
    return same


def stream_launches(torch, ast, prob, Xref, Uref, x0, carry=None):
    """The two kernels of iteration 0 on a fresh state, where every lane
    runs (the forward stale on a warm state): per-launch ms of each (CUDA
    events, median of REPS), one launch of each against its plain version
    on the same inputs (largest difference over every array it writes;
    the plain launch runs on the batch repeated to WIDE_B lanes, as
    plain_wide runs a solve, and is cut back), the plain version's ms for
    one launch on the card at the batch itself, and the lanes that
    converged in the compared forward launch. Below WIDE_B lanes two
    witnesses of that choice: the same differences against the plain
    launch at the batch itself, on the card (where cuBLAS may sum in
    another order) and on the CPU (where PyTorch sums each row in the
    kernels' column order)."""
    warm = carry is not None
    tables, x0c, carry_t, params = ast._prepare(prob, Xref, Uref, x0, carry,
                                                warm)
    spec = prob.spec
    N, nx, nu = spec.N, spec.nx, spec.nu
    B = x0c.shape[0]
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    k = max(1, WIDE_B // B)
    carry_w = None if carry is None else dataclasses.replace(carry, **{
        f.name: torch.cat([getattr(carry, f.name)] * k, dim=-1)
        for f in dataclasses.fields(carry)
        if getattr(carry, f.name) is not None})
    _, x0w, carry_tw, _ = ast._prepare(
        prob, Xref, Uref, x0.repeat(k, *([1] * (x0.dim() - 1))), carry_w,
        warm)

    def fresh(launcher, x=x0c, c=carry_t, t=tables):
        s = ast._init(x, N, nx, nu, c, params["fam"], params["cons"],
                      None if params["adapt"] is None else params["rho"])
        return s, launcher(t, x, s, c, N, nx, nu, **kw)

    bwd, fwd = [], []
    for _ in range(REPS):
        s, run = fresh(ast._KERNELS)
        bwd.append(cuda_ms(torch, lambda: run.backward(1), 1)[0])
        fwd.append(cuda_ms(torch, lambda: run.forward(0, warm), 1)[0])
    s, run = fresh(ast._KERNELS)
    sp, plain = fresh(ast._PLAIN)
    sw, wide = fresh(ast._PLAIN, x0w, carry_tw)
    cut = lambda a: a[..., :B]
    cpu = lambda c: c if c is None else dataclasses.replace(c, **{
        f.name: getattr(c, f.name).cpu() for f in dataclasses.fields(c)
        if getattr(c, f.name) is not None})
    sc, plain_cpu = fresh(ast._PLAIN, x0c.cpu(), cpu(carry_t),
                          tables.cpu()) if k > 1 else (None, None)
    run.backward(1)
    plain_bwd_ms = host_ms(torch, lambda: plain.backward(1))[0]
    wide.backward(1)
    err_b = (s["d"] - cut(sw["d"])).abs().max().item()
    wit = {}
    if k > 1:
        plain_cpu.backward(1)
        wit["b_card"] = (s["d"] - sp["d"]).abs().max().item()
        wit["b_cpu"] = (s["d"].cpu() - sc["d"]).abs().max().item()
        sc["d"] = s["d"].cpu()
    sp["d"] = s["d"].clone()
    sw["d"] = torch.cat([s["d"]] * k, dim=-1)
    run.forward(0, warm)
    plain_fwd_ms = host_ms(torch, lambda: plain.forward(0, warm))[0]
    wide.forward(0, warm)

    def err_fwd(o, at=lambda a: a):
        pairs = [(s[n], at(o[n])) for n in (
            "vnew", "znew", "g", "y", "res", "x", "u", "zc0", "yc0",
            "offer", "rho", "rho_v") if s[n] is not None]
        pairs += [(a, at(b)) for a, b in zip(s["fams"], o["fams"])
                  if a is not None]
        same = torch.equal(s["iters"], at(o["iters"])) and torch.equal(
            s["done"], at(o["done"]))
        return max((a - b).abs().max().item()
                   for a, b in pairs) if same else float("inf")

    err_f = err_fwd(sw, cut)
    if k > 1:
        plain_cpu.forward(0, warm)
        wit["f_card"] = err_fwd(sp)
        wit["f_cpu"] = err_fwd(sc, lambda a: a.to(s["d"].device))
    return dict(bwd_ms=statistics.median(bwd), fwd_ms=statistics.median(fwd),
                bwd_reps=bwd, fwd_reps=fwd, err_b=err_b, err_f=err_f,
                witness=wit, plain_bwd_ms=plain_bwd_ms,
                plain_fwd_ms=plain_fwd_ms,
                converged=int(s["done"].sum().item()))


def witness_text(lt):
    """stream_launches' differences against the plain launch at the batch
    itself (below WIDE_B lanes), as text for a log line."""
    w = lt["witness"]
    if not w:
        return ""
    return (f" (plain launch at the batch itself: on the card max|d| "
            f"{w['b_card']:.3e}, forward {w['f_card']:.3e}; on the CPU "
            f"max|d| {w['b_cpu']:.3e}, forward {w['f_cpu']:.3e})")


def team_route(prob, group=None):
    """Whether a problem's streamed launches run on lane teams
    (csrc/admm_stream_team.cuh): a box problem at fixed or adaptive rho, a
    problem with families at fixed rho, and a consensus problem at fixed
    rho in scenario groups of ``group`` lanes whose thread-block cluster
    the card can form (admm_stream.team_consensus_route, asking the loaded
    library's occupancy query); never at a pair without team entries
    (admm_fused.THREAD_KERNEL_DIMS: cartpole and the degenerate pairs)."""
    from tinympc_tpu_torch.kernels import admm_fused, admm_stream
    spec = prob.spec
    if (spec.nx, spec.nu) in admm_fused.THREAD_KERNEL_DIMS:
        return False
    if spec.en_consensus:
        import ctypes
        fits = admm_stream._team_consensus_fns()[2]
        counts = (ctypes.c_int * 6)(*admm_fused._families(spec))
        return admm_stream.team_consensus_route(
            group, spec.nx,
            lambda c: fits(spec.nx, spec.nu, counts, c)) is not None
    return not (spec.any_extra_family and prob.settings.adaptive_rho)


def stream_keys(prob, group=None):
    """The launch counts of the streamed kernels a problem runs: backward,
    forward and stale forward (on lane teams for a box problem, adaptive or
    not, for families at fixed rho, ``_team_families``, and for consensus
    in groups of ``group`` lanes, ``_team_consensus``, where its cluster
    can be formed)."""
    sfx = "_adaptive" if prob.settings.adaptive_rho else \
        "_consensus" if prob.spec.en_consensus else ""
    team = "" if not team_route(prob, group) else \
        "_team" if prob.spec.en_consensus else \
        "_team_families" if prob.spec.any_extra_family else "_team"
    return (f"backward{team}{sfx}", f"forward{team}{sfx}",
            f"forward{team}{sfx}_stale")


def took_route(ast, label, prob, group=None):
    """Fail the run unless both streamed launches since the counts were
    last zeroed took the problem's route: the team entries alone for a box
    problem (fixed or adaptive rho), for families at fixed rho and for
    consensus in groups of ``group`` lanes whose cluster can be formed --
    the consensus team entries (``_team_consensus``) for consensus, with or
    without families, the family team entries (``_team_families``) for
    families without it; the one-thread kernels alone for any other
    (families under adaptive rho, a cluster the card cannot form)."""
    c = ast.launch_counts
    route = team_route(prob, group)
    want = "lane teams" if route else "one thread a lane"
    cons = prob.spec.en_consensus
    for side in ("backward", "forward"):
        team = sum(v for k, v in c.items()
                   if k.startswith(side) and "_team" in k)
        other = sum(v for k, v in c.items()
                    if k.startswith(side) and "_team" not in k)
        ok = (team > 0 and other == 0) if route else \
            (team == 0 and other > 0)
        if route:
            # the consensus team entries for consensus, the family ones for
            # families without it, the box ones for a box
            tcons = sum(v for k, v in c.items()
                        if k.startswith(side) and "_team_consensus" in k)
            fams = sum(v for k, v in c.items()
                       if k.startswith(side) and "_team_families" in k)
            ok = ok and (tcons == team) == cons and (fams == team) == (
                prob.spec.any_extra_family and not cons)
        got = {k: v for k, v in c.items() if k.startswith(side) and v}
        log(f"  {label}: {side} launches {got} (want {want})")
        fail(f"{label} {side} route", ok,
             f"{side} launches {got}, {want} expected")


# The ptxas label (kernel_label) of the instantiation each streamed row of
# the kernels line measured: at (12, 4) the box and consensus phases
# (17, 18, 31, 35, 36), at (6, 3) the rocket's cones (19, 35), at (4, 1)
# cartpole's one-thread launches (45). Every
# streamed instantiation, the family team kernels at (12, 4) of phase 21
# and the consensus ones with families or at (6, 3) of phase 27 too, is
# held to no spill when it is built.
STREAM_PTXAS = {
    "backward_team": "admm_stream backward team (12, 4)",
    "forward_team": "admm_stream forward team (12, 4)",
    "forward_team_stale": "admm_stream forward team (12, 4)",
    "backward_team_families": "admm_stream backward team families (6, 3)",
    "forward_team_families": "admm_stream forward team families (6, 3)",
    "forward_team_families_stale":
        "admm_stream forward team families (6, 3)",
    "backward_consensus": "admm_stream backward consensus (12, 4)",
    "forward_consensus": "admm_stream forward consensus (12, 4)",
    "forward_consensus_stale": "admm_stream forward stale consensus (12, 4)",
    "backward_team_consensus": "admm_stream backward team consensus (12, 4)",
    "forward_team_consensus": "admm_stream forward team consensus (12, 4)",
    "forward_team_consensus_stale":
        "admm_stream forward team consensus (12, 4)",
    "backward_team_adaptive": "admm_stream backward team adaptive (12, 4)",
    "forward_team_adaptive": "admm_stream forward team adaptive (12, 4)",
    "forward_team_adaptive_stale":
        "admm_stream forward team adaptive (12, 4)",
    "backward_adaptive": "admm_stream backward adaptive (6, 3)",
    "forward_adaptive": "admm_stream forward adaptive (6, 3)",
    "forward_adaptive_stale": "admm_stream forward stale adaptive (6, 3)",
    "backward_4x1": "admm_stream backward (4, 1)",
    "forward_4x1": "admm_stream forward (4, 1)",
    "forward_stale_4x1": "admm_stream forward stale (4, 1)",
}


def team_bits(ctx, label, prob, Xref, Uref, x0, carry=None):
    """Each team launch of a box problem, of families at fixed rho, or of
    consensus (x0 (n_groups, G, nx); the lanes' zc0, yc0 and standing
    offers compared too), against the one-thread launch on the same state
    (``_KERNELS(..., team=False)``), bitwise: from the state
    the team kernels reach in some iterations (3 cold, 4 under adaptive
    rho, so that the second compared forward launch adapts rho; none warm,
    whose first launch is the stale one), two iterations from copies of
    it, at ct 2 cold (a check and a non-check launch) and ct 1 warm; every
    array either launch writes. Logs each compared launch's ms (one launch
    on CUDA events)."""
    torch, ast = ctx.torch, ctx.ast
    warm = carry is not None
    tables, x0c, carry_t, params = ast._prepare(prob, Xref, Uref, x0, carry,
                                                warm)
    spec = prob.spec
    N, nx, nu = spec.N, spec.nx, spec.nu
    kw = {k: v for k, v in params.items() if k != "max_iter"}
    kw["ct"] = 1 if warm else 2
    adaptive = params["adapt"] is not None
    s = ast._init(x0c, N, nx, nu, carry_t, params["fam"], params["cons"],
                  params["rho"] if adaptive else None)
    run = ast._KERNELS(tables, x0c, s, carry_t, N, nx, nu, **kw)
    first = 0 if warm else 4 if adaptive else 3
    for it in range(first):
        run.backward(1 - it % 2)
        run.forward(it, False)
    s1 = {k: v.clone() if torch.is_tensor(v) else
          [a if a is None else a.clone() for a in v] if isinstance(v, list)
          else v for k, v in s.items()}
    one = ast._KERNELS(tables, x0c, s1, carry_t, N, nx, nu, **kw,
                       team=False)
    keys = [k for k in ("vnew", "znew", "g", "y", "d", "iters", "done",
                        "res", "active", "rho", "rho_v", "x", "u", "zc0",
                        "yc0", "offer")
            if s[k] is not None]
    if run.team is None:
        raise AssertionError(f"{label}: the launches are not on lane teams")
    same, ms = True, {}
    for it in (first, first + 1):
        stale = warm and it == 0
        for name, r in (("team", run), ("one thread", one)):
            ms[(name, it, "backward")] = cuda_ms(
                torch, lambda: r.backward(1 - it % 2), 1)[0]
            ms[(name, it, "forward")] = cuda_ms(
                torch, lambda: r.forward(it, stale), 1)[0]
        same = same and all(torch.equal(s[k], s1[k]) for k in keys) and all(
            a is None or torch.equal(a, b)
            for a, b in zip(s["fams"], s1["fams"]))
    log(f"  {label}: team launches bitwise the one-thread launches on the "
        f"same state (iterations {first} and {first + 1}, ct {kw['ct']}"
        f"{', the first stale' if warm else ''}"
        f"{', the second adapting rho' if adaptive and not warm else ''}): "
        f"{same}; ms " + ", ".join(
            f"{side} it {it} {name} {v:.4f}"
            for (name, it, side), v in sorted(ms.items(),
                                              key=lambda kv: kv[0][1:])))
    fail(f"{label} team launches", same, "a team launch differs from the "
         "one-thread launch on the same state")


def device_ms(torch, fn):
    """Device milliseconds of the kernels one call of ``fn`` launches, by
    torch.profiler (the kernel's own time, without the host's launch path
    that CUDA events also hold); None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and "kernel" in e.key:
            total += us
    return total / 1e3 if total else None


def design_times(ctx, prob, Xref, Uref, x0, carry=None, reps=REPS):
    """The backward and forward launch of iteration 0 (the forward stale
    with a carry) on fresh states, on lane teams and on one thread a lane
    (``team=False``) in turns: the median of ``reps`` CUDA-event times and
    the median of 3 torch.profiler device times of each, by launch and
    design."""
    torch, ast = ctx.torch, ctx.ast
    warm = carry is not None
    tables, x0c, carry_t, params = ast._prepare(prob, Xref, Uref, x0, carry,
                                                warm)
    spec = prob.spec
    N, nx, nu = spec.N, spec.nx, spec.nu
    kw = {k: v for k, v in params.items() if k != "max_iter"}

    def fresh(team):
        s = ast._init(x0c, N, nx, nu, carry_t, params["fam"], params["cons"],
                      None if params["adapt"] is None else params["rho"])
        run = ast._KERNELS(tables, x0c, s, carry_t, N, nx, nu, **kw,
                           team=team)
        return {"backward": lambda: run.backward(1),
                "forward": lambda: run.forward(0, warm)}

    ev, dev = {}, {}
    for rep in range(reps + 3):
        for team in (True, False):
            design = "team" if team else "one thread"
            for side, fn in fresh(team).items():
                if rep < reps:
                    ev.setdefault((side, design), []).append(
                        cuda_ms(torch, fn, 1)[0])
                else:
                    dev.setdefault((side, design), []).append(
                        device_ms(torch, fn))
    out = {}
    for (side, design), t in ev.items():
        d = [v for v in dev[(side, design)] if v is not None]
        out.setdefault(side, {})[design] = dict(
            ms=statistics.median(t),
            device_ms=statistics.median(d) if d else None)
    return out


def team_lanes(ast, spec):
    """The lanes a block of the team forward launch holds at the spec's
    (nx, nu), as csrc/admm_stream.cu counts them."""
    return ast._build.load(ast.KERNEL).tinympc_stream_team_lanes(spec.nx,
                                                                 spec.nu)


def stream_drive(ctx, label, prob, Xref, Uref, x0, carry=None):
    """One streamed solve through the entry point with the counts at 0: its
    result and the launches (backward, forward, stale forward)."""
    torch, kern = ctx.torch, ctx.tt.kernels
    zero_counts(ctx.counters)
    out = (kern.solve_fused_streamed(prob, Xref, Uref, x0)
           if carry is None else
           kern.solve_fused_streamed_warm(prob, Xref, Uref, x0, carry))
    torch.cuda.synchronize()
    launches = tuple(ctx.ast.launch_counts[k] for k in stream_keys(prob))
    if launches[0] < 1 or launches[1] + launches[2] < 1:
        raise AssertionError(f"{label} did not launch the streamed "
                             "kernels")
    took_route(ctx.ast, label, prob)
    spec, B = prob.spec, x0.shape[0]
    if out[0].x.shape != (spec.N, B, spec.nx) or \
            out[0].u.shape != (spec.N - 1, B, spec.nu):
        raise AssertionError(f"{label}: bad output shapes "
                             f"{out[0].x.shape} {out[0].u.shape}")
    fail(label, bool(torch.isfinite(out[0].x).all()
                     and torch.isfinite(out[0].u).all()),
         "output is not finite")
    return out, launches


def stream_report(ctx, label, prob, Xref, Uref, x0, sol, launches,
                  carry=None, resident=None):
    """Per-launch and per-solve times beside their bounds; the kernels-line
    numbers of the backward and forward kernel."""
    torch, kern = ctx.torch, ctx.tt.kernels
    spec, B = prob.spec, x0.shape[0]
    warm = carry is not None
    adaptive = prob.settings.adaptive_rho
    lt = stream_launches(torch, ctx.ast, prob, Xref, Uref, x0, carry)
    fail(label, lt["err_b"] <= BAR_ATOL and lt["err_f"] <= BAR_ATOL,
         f"one launch differs from its plain version by "
         f"{max(lt['err_b'], lt['err_f']):.3e}")
    if team_route(prob):
        team_bits(ctx, label, prob, Xref, Uref, x0, carry)
    solve = ((lambda: kern.solve_fused_streamed(prob, Xref, Uref, x0))
             if not warm else
             (lambda: kern.solve_fused_streamed_warm(prob, Xref, Uref, x0,
                                                     carry)))
    solve_ms, times = cuda_ms(torch, solve, 3)
    host = statistics.median(host_ms(torch, solve)[0] for _ in range(3))
    track = warm and spec.any_extra_family
    fb, ff = stream_floats(spec, track, adaptive)
    ob, of = stream_ops(spec, adapt=prob.settings if adaptive else None)
    b_bwd = bound(B * ob, 4 * B * fb, ctx.peak_flops, ctx.peak_bw)
    b_fwd = bound(B * of, 4 * B * ff, ctx.peak_flops, ctx.peak_bw)
    iter_sum = int(sol.iter.sum().item())
    ops = iter_sum * (ob + of)
    if adaptive:
        ops += adaptations(sol.iter) * adaptation_ops(spec.N, spec.nx,
                                                      spec.nu)
    b_solve = bound(ops, 4 * iter_sum * (fb + ff), ctx.peak_flops,
                    ctx.peak_bw)
    its = launches[0]
    kernel_ms = its * (lt["bwd_ms"] + lt["fwd_ms"])
    lanes = team_lanes(ctx.ast, spec) if team_route(prob) else \
        ctx.admm_fused.BLOCK
    res_txt = ""
    if resident is not None:
        res_ms = cuda_ms(torch, resident, 3)[0]
        res_txt = (f", resident solve_fused{'_warm' if warm else ''} "
                   f"{res_ms:.4f} ms (streamed / resident "
                   f"{solve_ms / res_ms:.4f})")
    log(f"  {label}: backward {lt['bwd_ms']:.4f} ms a launch (reps "
        f"{[round(t, 4) for t in lt['bwd_reps']]}; bound "
        f"{b_bwd[0]:.4f} ms, {b_bwd[1]}; plain {lt['plain_bwd_ms']:.1f} "
        f"ms), forward{' (stale)' if warm else ''} {lt['fwd_ms']:.4f} ms "
        f"(reps {[round(t, 4) for t in lt['fwd_reps']]}; bound "
        f"{b_fwd[0]:.4f} ms, {b_fwd[1]}; plain {lt['plain_fwd_ms']:.1f} "
        f"ms); one launch vs plain: max|d| {lt['err_b']:.3e}, forward "
        f"{lt['err_f']:.3e}" + witness_text(lt))
    log(f"  {label}: solve {solve_ms:.4f} ms on the card's clock (reps "
        f"{[round(t, 4) for t in times]}), {host:.4f} ms on the host "
        f"clock, kernels ~{kernel_ms:.4f} ms ({its} iterations x the "
        f"per-launch times; share {kernel_ms / host:.4f}), launches per "
        f"solve {launches}, bound {b_solve[0]:.4f} ms ({b_solve[1]}), "
        f"{4 * (fb + ff)} B a lane and iteration "
        f"({4 * (fb + ff) / spec.N:.1f} B a horizon row), mean iters "
        f"{iter_sum / B:.4f}, solved frac "
        f"{sol.solved.float().mean().item():.5f}, "
        f"{B / (solve_ms / 1e3):.1f} solves/s{res_txt}; {B} lanes fill "
        f"{-(-B // lanes)} blocks of each launch on 132 SMs; card "
        f"{ctx.card}")
    return lt, b_bwd, b_fwd


def resident_cold(admm_fused, prob, Xref, Uref, x0):
    """One launch of the resident kernel on the solve's checked inputs."""
    tables, x0c, params = admm_fused._prepare(prob, Xref, Uref, x0)
    spec = prob.spec
    return lambda: admm_fused._solve_kernel(tables, x0c, spec.N, spec.nx,
                                            spec.nu, **params)


def streamed_phases(ctx):
    """Phases 17-22: the streamed long-horizon solve on csrc/admm_stream.cu.
    Returns the kernels-line numbers of its backward kernel, its forward
    kernel and the forward's stale variant, on lane teams: box problems
    and the rocket's cones (the family team kernels)."""
    torch, tt, admm_fused, ast = ctx.torch, ctx.tt, ctx.admm_fused, ctx.ast
    counters = ctx.counters
    kern = tt.kernels
    ref, ref_warm = (kern.solve_fused_streamed_reference,
                     kern.solve_fused_streamed_warm_reference)
    rows = {}
    drive = functools.partial(stream_drive, ctx)
    report = functools.partial(stream_report, ctx)
    resident = functools.partial(resident_cold, admm_fused)

    # 17. examples/long_horizon.py, cold, at the source's batch and a fleet
    phase(f"phase 17: long horizon cold, N={LH_N}, B={LH_B} and "
          f"{LH_FLEET_B}, max_iter {LH_ITER}")
    prob = problem(tt, torch, LH_ITER, 1, N=LH_N)
    for B in (LH_B, LH_FLEET_B):
        label = f"long horizon cold N={LH_N} B={B}"
        x0, Xref = long_horizon_inputs(torch, B, LH_N)
        (sol_k, res_k), launches = drive(label, prob, Xref, None, x0)
        same_bits(torch, label, (sol_k, res_k),
                  kern.solve_fused(prob, Xref, None, x0), "solve_fused")
        plain_ms, (sol_p, res_p) = host_ms(
            torch, lambda: plain_wide(torch, ref, prob, Xref, None, x0))
        err = compare(torch, f"{label} vs plain", sol_k, sol_p, res_k, res_p)
        lt, b_bwd, b_fwd = report(label, prob, Xref, None, x0, sol_k,
                                  launches,
                                  resident=resident(prob, Xref, None,
                                                         x0))
        log(f"  {label}: plain solve {plain_ms:.1f} ms")
        if B == LH_B:
            rows["backward_team"] = dict(launches=launches[0],
                                         err=lt["err_b"], ms=lt["bwd_ms"],
                                         plain_ms=lt["plain_bwd_ms"],
                                         bound_ms=b_bwd[0],
                                         bound_by=b_bwd[1])
            rows["forward_team"] = dict(launches=launches[1],
                                        err=lt["err_f"], ms=lt["fwd_ms"],
                                        plain_ms=lt["plain_fwd_ms"],
                                        bound_ms=b_fwd[0],
                                        bound_by=b_fwd[1])

    # 18. examples/long_horizon.py:78-97, warm: 5 solves of a plant
    phase(f"phase 18: long horizon warm, N={LH_N}, B={LH_B}, 5 warm solves "
          f"at max_iter {LH_WARM_ITER}")
    prob = problem(tt, torch, LH_WARM_ITER, 1, N=LH_N)
    x, Xref = long_horizon_inputs(torch, LH_B, LH_N)
    c_k, c_r = tt.init_carry(prob, LH_B), tt.init_carry(prob, LH_B)
    zero_counts(counters)
    states, sols, carries = [], [], [c_k]
    for step in range(5):
        sol_k, res_k, c_k = kern.solve_fused_streamed_warm(prob, Xref, None, x,
                                                            c_k)
        sol_r, res_r, c_r = kern.solve_fused_warm(prob, Xref, None, x, c_r)
        same_bits(torch, f"long horizon warm step {step}",
                  (sol_k, res_k, c_k), (sol_r, res_r, c_r),
                  "solve_fused_warm")
        states.append(x)
        sols.append(sol_k)
        carries.append(c_k)
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T
    torch.cuda.synchronize()
    warm_launches = tuple(ast.launch_counts[k] for k in stream_keys(prob))
    if warm_launches[2] < 5:
        raise AssertionError("the warm long-horizon sequence did not launch "
                             "the stale forward kernel")
    took_route(ast, "long horizon warm sequence", prob)
    # The plain version on the first and the fifth solve, each from the
    # kernel's carry in (a plain warm solve at N=512 takes ~10 s).
    err_w = 0.0
    for step in (0, 4):
        sol_p, _, c_p = plain_wide(torch, ref_warm, prob, Xref, None,
                                   states[step], carries[step])
        label = f"long horizon warm step {step} vs plain"
        err_w = max(err_w, compare(torch, label, sols[step], sol_p),
                    compare_carry(torch, label, carries[step + 1], c_p,
                                  torch.ones(LH_B, dtype=torch.bool,
                                             device=DEVICE)))
    for step, sol_k in enumerate(sols):
        log(f"  step {step}: mean iters {sol_k.iter.float().mean().item():.4f}"
            f", solved frac {sol_k.solved.float().mean().item():.5f}")
    # The fifth solve again, for its launches and times.
    launches5 = drive("long horizon warm", prob, Xref, None, states[-1],
                      carries[-2])[1]
    lt, _, b_stale = report("long horizon warm (the fifth solve)", prob,
                            Xref, None, states[-1], sols[-1], launches5,
                            carry=carries[-2])
    rows["forward_team_stale"] = dict(
        launches=warm_launches[2], err=max(err_w, lt["err_f"]),
        ms=lt["fwd_ms"], plain_ms=lt["plain_fwd_ms"], bound_ms=b_stale[0],
        bound_by=b_stale[1])

    # 19. bench_all.py:343-367, rocket SOC full descent; then as an
    # external-plant sequence of 2 warm solves (the family team kernels and
    # the forward's stale launch)
    phase(f"phase 19: rocket SOC full descent, N={LH_SOC_N}, B={LH_B}, "
          f"max_iter {LH_ITER}, cold and 2 warm solves")
    prob = rocket_problem(tt, torch, LH_ITER, 1, N=LH_SOC_N)
    x0, Xref, Uref = rocket_descent_inputs(torch, LH_B, LH_SOC_N)
    label = f"rocket SOC N={LH_SOC_N}"
    (sol_k, res_k), launches = drive(label, prob, Xref, Uref, x0)
    same_bits(torch, label, (sol_k, res_k),
              kern.solve_fused(prob, Xref, Uref, x0), "solve_fused")
    sol_p, res_p = plain_wide(torch, ref, prob, Xref, Uref, x0)
    compare(torch, f"{label} vs plain", sol_k, sol_p, res_k, res_p)
    lt, b_bwd, b_fwd = report(label, prob, Xref, Uref, x0, sol_k, launches,
                              resident=resident(prob, Xref, Uref, x0))
    rows["backward_team_families"] = dict(
        launches=launches[0], err=lt["err_b"], ms=lt["bwd_ms"],
        plain_ms=lt["plain_bwd_ms"], bound_ms=b_bwd[0], bound_by=b_bwd[1])
    rows["forward_team_families"] = dict(
        launches=launches[1], err=lt["err_f"], ms=lt["fwd_ms"],
        plain_ms=lt["plain_fwd_ms"], bound_ms=b_fwd[0], bound_by=b_fwd[1])
    c_k = c_r = tt.init_carry(prob, LH_B)
    x = x0
    for step in range(2):
        zero_counts(counters)
        out_k = kern.solve_fused_streamed_warm(prob, Xref, Uref, x, c_k)
        torch.cuda.synchronize()
        took_route(ast, f"{label} warm step {step}", prob)
        stale = ast.launch_counts[stream_keys(prob)[2]]
        out_r = kern.solve_fused_warm(prob, Xref, Uref, x, c_r)
        same_bits(torch, f"{label} warm step {step}", out_k, out_r,
                  "solve_fused_warm")
        x_prev, c_prev = x, c_k
        c_k, c_r = out_k[2], out_r[2]
        x = x @ prob.A.T + out_k[0].u[0] @ prob.B.T + prob.f
    sol_p, _, c_p = plain_wide(torch, ref_warm, prob, Xref, Uref, x_prev,
                               c_prev)
    err_w = max(compare(torch, f"{label} warm step 1 vs plain", out_k[0],
                        sol_p),
                compare_carry(torch, f"{label} warm step 1 vs plain", c_k,
                              c_p, torch.ones(LH_B, dtype=torch.bool,
                                              device=DEVICE)))
    launches = drive(f"{label} warm", prob, Xref, Uref, x_prev, c_prev)[1]
    lt, _, b_stale = report(f"{label} warm (the second solve)", prob, Xref,
                            Uref, x_prev, out_k[0], launches, carry=c_prev)
    rows["forward_team_families_stale"] = dict(
        launches=stale, err=max(err_w, lt["err_f"]), ms=lt["fwd_ms"],
        plain_ms=lt["plain_fwd_ms"], bound_ms=b_stale[0],
        bound_by=b_stale[1])

    # 20. bench_all.py:503-518, N=256 to convergence, mixed x0 scales
    phase(f"phase 20: long horizon to convergence, N={LH_CONV_N}, "
          f"B={LH_CONV_B}, max_iter {LH_CONV_ITER}")
    prob = problem(tt, torch, LH_CONV_ITER, 1, N=LH_CONV_N)
    rng = np.random.default_rng(0)
    scales = np.linspace(0.05, 0.5, LH_CONV_B)[:, None]
    x0 = torch.as_tensor((rng.uniform(-1, 1, (LH_CONV_B, 12)) * scales)[
        rng.permutation(LH_CONV_B)], dtype=torch.float32, device=DEVICE)
    label = f"to convergence N={LH_CONV_N}"
    (sol_k, res_k), launches = drive(label, prob, None, None, x0)
    same_bits(torch, label, (sol_k, res_k),
              kern.solve_fused(prob, None, None, x0), "solve_fused")
    its = launches[0]
    # Iterations in which a lane, a block of the team launches (a team of
    # lanes) or a block of the one-thread launches (128 lanes) had a lane
    # running: a block returns at once when all of its lanes are done.
    team = team_lanes(ast, prob.spec)
    busy = {n: int(sol_k.iter.reshape(-1, n).amax(dim=1).sum().item())
            for n in (1, team, admm_fused.BLOCK)}
    share = {n: busy[n] * n / (its * LH_CONV_B) for n in busy}
    log(f"  {label}: solved frac {sol_k.solved.float().mean().item():.5f}, "
        f"mean iters {sol_k.iter.float().mean().item():.4f}, loop ran {its} "
        f"of {LH_CONV_ITER} iterations ({2 * its} launches, "
        f"{2 * (LH_CONV_ITER - its)} saved by the stop once every lane is "
        f"done); share of the launches' lane-iterations run by a running "
        f"lane {share[1]:.4f}, by a block of {team} lanes (both launches) "
        f"with one {share[team]:.4f} (the rest returned at once), by a "
        f"block of {admm_fused.BLOCK} with one {share[admm_fused.BLOCK]:.4f} "
        f"(one thread a lane)")
    report(label, prob, None, None, x0, sol_k, launches,
           resident=resident(prob, None, None, x0))

    # 21. phase 12's binding ceilings through the streamed kernels
    phase(f"phase 21: hyperplanes under low ceilings, streamed, B={FAM_B}, "
          f"N={FAM_N}")
    x0, Xref, _ = quad_plane_inputs(torch, FAM_B)
    for kind in ("linear", "tv"):
        prob = quad_plane_problem(tt, torch, kind == "tv", 100, 1,
                                  LOW_CEILING[kind])
        label = f"quadrotor {kind} low ceilings streamed"
        (sol_k, res_k), launches = drive(label, prob, Xref, None, x0)
        same_bits(torch, label, (sol_k, res_k),
                  kern.solve_fused(prob, Xref, None, x0), "solve_fused")
        report(label, prob, Xref, None, x0, sol_k, launches,
               resident=resident(prob, Xref, None, x0))

    # 22. past the resident kernel's shared-memory wall
    phase(f"phase 22: long horizon N={LH_WALL_N}, B={LH_B}, max_iter "
          f"{LH_ITER}")
    prob = problem(tt, torch, LH_ITER, 1, N=LH_WALL_N)
    x0, Xref = long_horizon_inputs(torch, LH_B, LH_WALL_N)
    smem = admm_fused.smem_bytes(12, 4, LH_WALL_N)
    try:
        kern.solve_fused(prob, Xref, None, x0)
        refused = False
    except ValueError as e:
        refused = "solve_fused_streamed" in str(e)
    log(f"  N={LH_WALL_N}: the resident tables take {smem} B of shared "
        f"memory (limit {admm_fused.SMEM_LIMIT}); fused_supported "
        f"{kern.fused_supported(prob)}, solve_fused refused: {refused}")
    fail(f"N={LH_WALL_N}", refused and not kern.fused_supported(prob),
         "the resident solve did not refuse a table past shared memory")
    label = f"long horizon cold N={LH_WALL_N}"
    (sol_k, res_k), launches = drive(label, prob, Xref, None, x0)
    sol_p, res_p = plain_wide(torch, ref, prob, Xref, None, x0)
    compare(torch, f"{label} vs plain", sol_k, sol_p, res_k, res_p)
    report(label, prob, Xref, None, x0, sol_k, launches)
    return rows


def consensus_problem(tt, torch, max_iter, ct, rho_c=CONS_RHO, device=None,
                      dtype=None):
    """The quadrotor at 20 Hz, N=10, box +-5 / +-0.5, with consensus at
    rho_c (None: the problem's rho), through the user's entry points."""
    prob = problem(tt, torch, max_iter, ct, N=CONS_N, device=device,
                   dtype=dtype)
    return tt.with_consensus(prob, rho_c=rho_c)


def tree_inputs(torch, ng, G, z):
    """x0 = a nominal U[-0.3, 0.3]^(ng, 1, 12) plus 0.05 U[-1, 1]^(ng, G,
    12) branches (default_rng(0)), as bench_all.py:236-237 and
    examples/scenario_tree_mpc.py:54-56 make them; Xref hover at z."""
    rng = np.random.default_rng(0)
    nominal = rng.uniform(-0.3, 0.3, (ng, 1, 12))
    x0 = nominal + 0.05 * rng.uniform(-1, 1, (ng, G, 12))
    Xref = np.zeros((CONS_N, 12))
    Xref[:, 2] = z
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def lanes(sol):
    """A consensus Solution, (N, n_groups, G, F), as lanes, (N, B, F)."""
    N = sol.x.shape[0]
    return dataclasses.replace(
        sol, iter=sol.iter.reshape(-1), solved=sol.solved.reshape(-1),
        x=sol.x.reshape(N, -1, sol.x.shape[-1]),
        u=sol.u.reshape(N - 1, -1, sol.u.shape[-1]))


def group_agree(it_a, it_b, G):
    """The lanes of the groups whose every lane has the same count in both
    solves: a lane's result depends on its group's."""
    same = (it_a.reshape(-1, G) == it_b.reshape(-1, G)).all(dim=1)
    return same.repeat_interleave(G)


def spread_stats(sol, tol_pri):
    """The u[0] spread of a consensus solve's groups (max - min over the
    group, largest over the features): the groups whose lanes all
    converged, how many of those pass 2 abs_pri_tol + 1e-5, the largest
    spread among them and among all groups."""
    u0 = sol.u[0]
    spread = (u0.amax(dim=1) - u0.amin(dim=1)).amax(dim=-1)
    done = sol.solved.all(dim=1)
    n = int(done.sum().item())
    return dict(groups=done.numel(), solved=n,
                over=int((done & (spread > 2 * tol_pri + 1e-5)).sum().item()),
                worst=spread[done].max().item() if n else 0.0,
                all=spread.max().item())


def hold_spread(label, stats, tol_pri, witness, also=()):
    """tests/test_fused_kernel.py:262-268's bar: each group whose lanes all
    converged has its u[0] spread below 2 abs_pri_tol + 1e-5. A lane
    converges on its own |u[0] - zc0| < abs_pri_tol against the group
    mean of its converging iteration, so two lanes of a group that
    converge at different iterations may pass the bar between them, under
    any rule for a converged lane's offer. Where the kernel's solve misses
    it, ``witness()`` -- the port's admm.solve on the same inputs in
    float32 on the card, the JAX package's XLA path's rule -- gives the
    share of solved groups that miss it there, and the kernel's share may
    pass that by WITNESS_SLACK at most. ``also`` names further witnesses,
    (name, function) pairs, whose shares are printed beside it and not
    held."""
    bar = 2 * tol_pri + 1e-5
    msg = (f"  {label}: solved groups {stats['solved']} of "
           f"{stats['groups']}, their largest u[0] spread "
           f"{stats['worst']:.3e} (bar {bar:.3e}), {stats['over']} pass "
           f"the bar; all groups' largest {stats['all']:.3e}")
    if stats["over"] == 0:
        log(msg)
        return
    w = spread_stats(witness(), tol_pri)
    share = stats["over"] / stats["solved"]
    share_w = w["over"] / max(w["solved"], 1)
    log(f"{msg}; admm.solve (float32, the XLA path's rule) on the same "
        f"inputs: solved groups {w['solved']}, largest spread "
        f"{w['worst']:.3e}, {w['over']} pass the bar (share of solved "
        f"groups: kernel {share:.5f}, admm.solve {share_w:.5f})")
    for name, fn in also:
        a = spread_stats(fn(), tol_pri)
        log(f"  {label}: beside it, {name}: solved groups {a['solved']}, "
            f"largest spread {a['worst']:.3e}, {a['over']} pass the bar "
            f"(share {a['over'] / max(a['solved'], 1):.5f}; not held)")
    fail(label, share <= share_w + WITNESS_SLACK, f"{share:.4f} of solved "
         f"groups pass the spread bar, admm.solve's {share_w:.4f}")


def block_iters(torch, iters, block):
    """The mean over the launch's blocks of each block's largest count: a
    block runs until its slowest lane stops."""
    it = iters.reshape(-1)
    it = torch.cat([it, it.new_zeros(-it.numel() % block)])
    return it.reshape(-1, block).amax(dim=1).float().mean().item()


def plain_groups(torch, fn, prob, Xref, Uref, x0, carry=None):
    """A consensus plain version ``fn`` on the card for the groups of x0
    (n_groups, G, nx), run on the groups repeated to WIDE_B lanes and cut
    back (see plain_wide): groups are independent of each other."""
    ng, G = x0.shape[:2]
    k = max(1, WIDE_B // (ng * G))
    xw = x0.repeat(k, 1, 1)
    if carry is None:
        sol, res = fn(prob, Xref, Uref, xw)
        extra = ()
    else:
        wide = dataclasses.replace(carry, **{
            f.name: torch.cat([getattr(carry, f.name)] * k, dim=-1)
            for f in dataclasses.fields(carry)
            if getattr(carry, f.name) is not None})
        sol, res, c = fn(prob, Xref, Uref, xw, wide)
        extra = (cut(c, ng * G),)
    sol = dataclasses.replace(sol, iter=sol.iter[:ng], solved=sol.solved[:ng],
                              x=sol.x[:, :ng], u=sol.u[:, :ng])
    return (sol, res[:, :ng]) + extra


def consensus_sequence(torch, tt, convert, admm_fused, label, ct, prob, x0,
                       Xref, Uref, entry):
    """One consensus case of the small comparisons: a cold solve and
    CONS_SMALL_WARM warm solves of an external plant stepped with the
    kernel's u0, x0 (n_groups, G, nx). Each solve is held to the bar
    against the plain version on the CPU and on the card (on the groups
    whose counts agree, at every step so far), with the bars of the plain
    version's own spread between the two where they sit on float32 ties;
    every launch on the C entry ``entry``; each solve's solved groups to
    the spread bar (hold_spread). Returns each step's largest difference
    from the plain version on the card."""
    kern = tt.kernels
    cpu = lambda a: None if a is None else a.cpu()
    ng, G = x0.shape[:2]
    B = ng * G
    errs = {}
    zero_entries(admm_fused)
    prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                        "cpu")
    everyone = torch.ones(B, dtype=torch.bool)
    agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
    agreed_c = everyone.clone()
    c_k = c_p = c_c = None
    x = x0
    states, spreads = [], []
    for step in range(1 + CONS_SMALL_WARM):
        warm = step > 0
        name = (f"{label} {'warm' if warm else 'cold'} ct={ct}"
                + (f" step {step}" if warm else ""))
        if warm and c_k is None:
            # A fresh sequence: the warm solves start from zero carries.
            c_k, c_p = tt.init_carry(prob, B), tt.init_carry(prob, B)
            c_c = tt.init_carry(prob_c, B)
            agreed.fill_(True)
            agreed_c.fill_(True)
        if not warm:
            sol_k, res_k = kern.solve_fused(prob, Xref, Uref, x)
            sol_p, res_p = plain_groups(torch, kern.solve_fused_reference,
                                        prob, Xref, Uref, x)
            sol_c, _ = kern.solve_fused_reference(prob_c, cpu(Xref),
                                                  cpu(Uref), cpu(x))
        else:
            sol_k, res_k, c_k = kern.solve_fused_warm(prob, Xref, Uref, x,
                                                      c_k)
            sol_p, res_p, c_p = plain_groups(
                torch, kern.solve_fused_warm_reference, prob, Xref, Uref,
                x, c_p)
            sol_c, _, c_c = kern.solve_fused_warm_reference(
                prob_c, cpu(Xref), cpu(Uref), cpu(x), c_c)
        torch.cuda.synchronize()
        states.append(x)
        spreads.append((name, spread_stats(sol_k,
                                           prob.settings.abs_pri_tol)))
        fk, fp, fc = lanes(sol_k), lanes(sol_p), lanes(sol_c)
        fkc = on_cpu(fk)
        before_c = agreed_c.clone()
        agreed_c &= group_agree(fkc.iter, fc.iter, G)
        compare(torch, f"{name} vs plain(cpu)", fkc, fc, lanes=agreed_c,
                among=before_c)
        share_c, dsf_c, dval_c, _ = plain_spread(
            torch, fp, fc, before_c,
            *((c_p, c_c) if warm else ()))
        share, solved_tol, atol = spread_bars(name, share_c, dsf_c,
                                              dval_c, B)
        before = agreed.clone()
        agreed &= group_agree(fk.iter, fp.iter, G)
        errs[step] = compare(
            torch, name, fk, fp, res_k.reshape(4, -1),
            res_p.reshape(4, -1), atol=atol, lanes=agreed,
            solved_tol=solved_tol, share=share, among=before)
        if warm:
            # The CPU's float32 torch.sqrt is not always correctly
            # rounded (ROADMAP.md, Queue 3), which the rocket's duals
            # carry from solve to solve: the carry is held to the plain
            # version's own spread there.
            compare_carry(torch, f"{name} vs plain(cpu)", on_cpu(c_k),
                          c_c, agreed_c, atol=atol)
            compare_carry(torch, name, c_k, c_p, agreed, atol=atol)
        xf = x.reshape(B, -1)
        x = (xf @ prob.A.T + fk.u[0] @ prob.B.T + prob.f).reshape(
            ng, G, -1)
    took_entries(admm_fused, f"{label} ct={ct}",
                 {entry: 1 + CONS_SMALL_WARM})
    # The spread bar, with admm.solve's witness where it is missed: a
    # cold solve, then a warm sequence of its own on the same states.
    witness = {}

    def admm_solves():
        if not witness:
            witness[0] = tt.solve(prob, tt.init_state(prob, (ng, G)),
                                  Xref, Uref, states[0])[0]
            st = tt.init_state(prob, (ng, G))
            for k in range(1, len(states)):
                witness[k], st, _ = tt.solve(prob, st, Xref, Uref,
                                             states[k])
        return witness

    for k, (name, stats) in enumerate(spreads):
        hold_spread(name, stats, prob.settings.abs_pri_tol,
                    lambda k=k: admm_solves()[k])
    return errs


def consensus_phases(torch, tt, convert, admm_fused, counters, card,
                     peak_flops, peak_bw):
    """Phases 23-25: box consensus at (12, 4) on the thread-group kernel
    (csrc/admm_group.cu, tinympc_admm_group_consensus), consensus with the
    rocket's cones on the families consensus instantiation of
    csrc/admm_fused.cu. Returns the kernels-line numbers of the group
    kernel's cold and warm launches and of the families consensus
    kernel."""
    kern = tt.kernels
    rows = {}

    phase(f"phase 23: consensus kernel vs plain versions, B={CONS_SMALL_B}")
    # The quadrotor (hover z 0.5) at rho_c 100 and the default, as
    # 128 x 8, 512 x 2 and 8 x 128 groups; the rocket's cones (phase 9)
    # with consensus at (6, 3), 128 x 8. Cold, then 2 warm solves of an
    # external plant stepped with the kernel's u0, at ct 1 and 5. Each
    # solve is held to the bar against the plain version on the CPU and on
    # the card (on the groups whose counts agree, at every step so far),
    # with the bars of the plain version's own spread between the two
    # where they sit on float32 ties, as phase 9 does.
    small = []
    for ct in (1, 5):
        for rho_c in (CONS_RHO, None):
            for ng, G in ((CONS_SMALL_B // 8, 8), (CONS_SMALL_B // 2, 2),
                          (8, CONS_SMALL_B // 8)):
                small.append((f"quadrotor rho_c={rho_c} {ng}x{G}", ct,
                              lambda mi, ct, rc=rho_c: consensus_problem(
                                  tt, torch, mi, ct, rc), (ng, G), "quad"))
        small.append((f"rocket SOC rho_c={CONS_RHO} "
                      f"{CONS_SMALL_B // 8}x8", ct,
                      lambda mi, ct: tt.with_consensus(
                          rocket_problem(tt, torch, mi, ct),
                          rho_c=CONS_RHO), (CONS_SMALL_B // 8, 8), "rocket"))
    errs = {}
    for label, ct, make, (ng, G), kind in small:
        B = ng * G
        prob = make(100, ct)
        if kind == "quad":
            x0, Xref = inputs(torch, B, N=CONS_N, spread=0.3)
            Xref = Xref.clone()
            Xref[:, 2] = 0.5
            Uref = None
        else:
            x0, Xref, Uref = rocket_inputs(torch, B)
        x0 = x0.reshape(ng, G, -1)
        errs.update({(kind, ct, step): e for step, e in consensus_sequence(
            torch, tt, convert, admm_fused, label, ct, prob, x0, Xref, Uref,
            GROUP_CONS if kind == "quad" else FUSED).items()})

    # The one-thread families consensus kernel (csrc/admm_fused.cu), which
    # consensus with a family beyond the box runs: the rocket's cones,
    # 128 x 8, cold, ct 1, timed.
    ng, G, B = CONS_SMALL_B // 8, 8, CONS_SMALL_B
    prob = tt.with_consensus(rocket_problem(tt, torch, 100, 1),
                             rho_c=CONS_RHO)
    x0, Xref, Uref = rocket_inputs(torch, B)
    x0 = x0.reshape(ng, G, -1)
    zero_counts(counters)
    sol_k, _ = kern.solve_fused(prob, Xref, Uref, x0)
    torch.cuda.synchronize()
    launches = admm_fused.entry_counts[FUSED]
    took_entries(admm_fused, "rocket SOC consensus", {FUSED: 1})
    plain_ms, _ = host_ms(torch, lambda: plain_groups(
        torch, kern.solve_fused_reference, prob, Xref, Uref, x0))
    tables, x0c, params = admm_fused._prepare(prob, Xref, Uref, x0)
    ms, times = cuda_ms(torch, lambda: admm_fused._solve_kernel(
        tables, x0c, FAM_N, 6, 3, **params), REPS)
    iter_sum = int(sol_k.iter.sum().item())
    ops, nbytes = fused_work(FAM_N, 6, 3, B, iter_sum, spec=prob.spec)
    ops += float(iter_sum) * consensus_ops(G, 3)
    bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  rocket SOC consensus 128 x 8 (one-thread families consensus "
        f"kernel): kernel {ms:.4f} ms (reps {[round(t, 4) for t in times]})"
        f", mean iters {iter_sum / B:.4f}, bound {bound_ms:.4f} ms "
        f"({bound_by}), plain {plain_ms:.1f} ms, launches {launches}; card "
        f"{card}")
    rows["families_consensus"] = dict(
        launches=launches, err=errs[("rocket", 1, 0)], ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

    phase(f"phase 24: consensus G={CONS_G} scenario batch, "
          f"B={CONS_NG * CONS_G}, max_iter {CONS_ITER}, ct 1")
    # bench_all.py:224-250: 2048 scenario trees x 16 branches.
    ng, G, B = CONS_NG, CONS_G, CONS_NG * CONS_G
    t0 = time.perf_counter()
    prob = consensus_problem(tt, torch, CONS_ITER, 1)
    setup_ms = 1e3 * (time.perf_counter() - t0)
    x0, Xref = tree_inputs(torch, ng, G, 0.5)
    zero_counts(counters)
    sol_k, res_k = kern.solve_fused(prob, Xref, None, x0)
    torch.cuda.synchronize()
    launches = admm_fused.consensus_launch_count
    if launches < 1:
        raise AssertionError("the scenario batch did not launch the "
                             "consensus kernel")
    took_entries(admm_fused, f"G={G} scenario batch", {GROUP_CONS: launches})
    if sol_k.x.shape != (CONS_N, ng, G, 12) or \
            sol_k.u.shape != (CONS_N - 1, ng, G, 4) or \
            res_k.shape != (4, ng, G):
        raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                             f"{sol_k.u.shape} {res_k.shape}")
    plain_ms, (sol_p, res_p) = host_ms(
        torch, lambda: kern.solve_fused_reference(prob, Xref, None, x0))
    fk, fp = lanes(sol_k), lanes(sol_p)
    err = compare(torch, f"G={G} scenario batch", fk, fp,
                  res_k.reshape(4, -1), res_p.reshape(4, -1),
                  lanes=group_agree(fk.iter, fp.iter, G))
    hold_spread(f"G={G} scenario batch",
                spread_stats(sol_k, prob.settings.abs_pri_tol),
                prob.settings.abs_pri_tol,
                lambda: tt.solve(prob, tt.init_state(prob, (ng, G)), Xref,
                                 None, x0)[0])
    tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
    run = lambda: admm_fused._solve_kernel(tables, x0c, CONS_N, 12, 4,
                                           **params)
    run()                                               # warm-up
    ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: kern.solve_fused(prob, Xref, None, x0))[0]
        for _ in range(REPS))
    iter_sum = int(sol_k.iter.sum().item())
    ops, nbytes = fused_work(CONS_N, 12, 4, B, iter_sum)
    ops += float(iter_sum) * consensus_ops(G, 4)
    bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    avg = iter_sum / B
    # The same batch on the families kernel with consensus off (group 0):
    # each lane its own problem, no exchange, no step-0 gains.
    off = dict(params, cons=admm_fused.Consensus(0, 0.0))
    run_off = lambda: admm_fused._launch(
        tables, x0c, CONS_N, 12, 4, off["fam"], None, off["cons"], None,
        CONS_ITER, 1, off["rho"], off["tol_pri"], off["tol_dua"])
    zero_entries(admm_fused)
    sol_off = run_off()[0]
    took_entries(admm_fused, f"G={G} batch without consensus", {FUSED: 1})
    ms_off, times_off = cuda_ms(torch, run_off, REPS)
    avg_off = sol_off.iter.float().mean().item()
    blk = block_iters(torch, sol_k.iter, admm_fused.BLOCK)
    blk_off = block_iters(torch, sol_off.iter, admm_fused.BLOCK)
    log(f"  G={G} scenario batch: kernel {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), solve_fused call {call_ms:.4f} ms "
        f"on the host clock (kernel share {ms / call_ms:.4f}), "
        f"{B / (ms / 1e3):.1f} solves/s, solved frac "
        f"{fk.solved.float().mean().item():.5f}, mean iters {avg:.4f}, "
        f"{ms / avg:.6f} ms a mean iteration, mean block iterations (the "
        f"slowest lane of each block) {blk:.4f}, {ms / blk:.6f} ms a block "
        f"iteration, bound {bound_ms:.4f} ms "
        f"({bound_by}; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; "
        f"kernel / bound {ms / bound_ms:.2f}), plain {plain_ms:.1f} ms, "
        f"launches {launches}; setup + with_consensus {setup_ms:.1f} ms; "
        f"card {card}")
    log(f"  the same batch without consensus on the one-thread families "
        f"kernel (group 0): {ms_off:.4f} ms (reps "
        f"{[round(t, 4) for t in times_off]}), mean iters {avg_off:.4f}, "
        f"mean block iterations {blk_off:.4f}, {ms_off / blk_off:.6f} ms a "
        f"block iteration, solved frac "
        f"{sol_off.solved.float().mean().item():.5f}; the group kernel with "
        f"the exchange takes {(ms / blk) / (ms_off / blk_off):.4f}x its "
        f"time a block iteration (blocks of {admm_fused.BLOCK} lanes)")
    rows["consensus"] = dict(launches=launches, err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)

    phase(f"phase 25: scenario-tree warm loop, {TREE_NG} x {TREE_G}, "
          f"T={TREE_T}, max_iter {CONS_ITER}")
    # examples/scenario_tree_mpc.py:37-80: every step a warm solve, the
    # nominal plant stepped with the group-mean u[0], fresh branches
    # 0.05 U[-1, 1] around it from a seeded generator; the carry rides.
    ng, G, B = TREE_NG, TREE_G, TREE_NG * TREE_G
    prob = consensus_problem(tt, torch, CONS_ITER, 1)
    x, Xref = tree_inputs(torch, ng, G, 1.0)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    c_k = tt.init_carry(prob, B)
    states, sols = [], []
    zero_counts(counters)
    t0 = time.perf_counter()
    for _ in range(TREE_T):
        sol_k, _, c_k = kern.solve_fused_warm(prob, Xref, None, x, c_k)
        states.append(x)
        sols.append(sol_k)
        u0 = sol_k.u[0].mean(dim=1, keepdim=True)
        x_nom = x.mean(dim=1, keepdim=True)
        branch = 0.05 * (2 * torch.rand((ng, G, 12), generator=gen,
                                        device=DEVICE) - 1)
        x = x_nom @ prob.A.T + u0 @ prob.B.T + branch
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0)
    warm_launches = admm_fused.consensus_warm_launch_count
    if warm_launches < TREE_T:
        raise AssertionError("the scenario-tree loop did not launch the warm "
                             "consensus kernel")
    took_entries(admm_fused, "scenario-tree loop", {GROUP_CONS: warm_launches})
    c_p = tt.init_carry(prob, B)
    agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
    err_w = 0.0
    for step, (x_s, sol_k) in enumerate(zip(states, sols)):
        plain_w_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: plain_groups(torch, kern.solve_fused_warm_reference,
                                        prob, Xref, None, x_s, c_p))
        fk, fp = lanes(sol_k), lanes(sol_p)
        before = agreed.clone()
        agreed &= group_agree(fk.iter, fp.iter, G)
        err_w = max(err_w, compare(torch, f"tree step {step}", fk, fp,
                                   lanes=agreed, among=before))
    compare_carry(torch, f"tree after {TREE_T} steps", c_k, c_p, agreed)

    def tree_admm():
        st = tt.init_state(prob, (ng, G))
        for x_s in states:
            sol_w, st, _ = tt.solve(prob, st, Xref, None, x_s)
        return sol_w

    last = spread_stats(sols[-1], prob.settings.abs_pri_tol)
    hold_spread(f"tree step {TREE_T - 1}", last, prob.settings.abs_pri_tol,
                tree_admm)
    tables, xc, params = admm_fused._prepare(prob, Xref, None, x)
    carry = admm_fused._carry_tensors(prob, c_k, B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, CONS_N,
                                                12, 4, **params)
    sol_w = run()[0]                                    # warm-up
    w_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: kern.solve_fused_warm(prob, Xref, None, x,
                                                     c_k))[0]
        for _ in range(REPS))
    iter_sum = int(sol_w.iter.sum().item())
    ops, nbytes = fused_work(CONS_N, 12, 4, B, iter_sum,
                             lane_carry_floats(c_k))
    ops += float(iter_sum) * consensus_ops(G, 4)
    w_bound_ms, w_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    iters = torch.stack([s.iter for s in sols]).float()
    log(f"  tree loop: {TREE_T} steps in {loop_ms:.1f} ms on the host clock "
        f"({B * TREE_T / (loop_ms / 1e3):.1f} scenario-solves/s with the "
        f"plant step), mean iters a step {iters.mean().item():.4f} (first "
        f"{iters[0].mean().item():.4f}, last {iters[-1].mean().item():.4f}),"
        f" solved groups at the last step {last['solved']} of "
        f"{last['groups']}, their largest u[0] spread {last['worst']:.3e}; "
        f"one warm solve (the {TREE_T + 1}th): "
        f"kernel {w_ms:.4f} ms (reps {[round(t, 4) for t in times]}), call "
        f"{call_ms:.4f} ms on the host clock (kernel share "
        f"{w_ms / call_ms:.4f}), {B / (w_ms / 1e3):.1f} scenario-solves/s, "
        f"mean iters {iter_sum / B:.4f}, bound {w_bound_ms:.4f} ms "
        f"({w_bound_by}), plain {plain_w_ms:.1f} ms, warm launches "
        f"{warm_launches}; card {card}")
    rows["consensus_warm"] = dict(launches=warm_launches, err=err_w,
                                  ms=w_ms, plain_ms=plain_w_ms,
                                  bound_ms=w_bound_ms, bound_by=w_bound_by)
    return rows


def mixed_inputs(torch, B, lo=0.05, hi=0.5, permute=True):
    """x0 = U[-1, 1]^12 times scales linspace(lo, hi) over the lanes, then
    permuted (bench_all.py:448-452; default_rng(0)); unpermuted, the mixed
    batch of tests/test_compact.py:42-47."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (B, 12)) * np.linspace(lo, hi, B)[:, None]
    if permute:
        x0 = x0[rng.permutation(B)]
    return torch.as_tensor(x0, dtype=torch.float32, device=DEVICE)


def hover_ref(torch, N, z):
    """Hover at height z over the horizon."""
    Xref = np.zeros((N, 12))
    Xref[:, 2] = z
    return torch.as_tensor(Xref, dtype=torch.float32, device=DEVICE)


def warp_shares(iters, its, warp, block):
    """Share of the lane-iterations of a run of ``its`` iterations that a
    running lane, a warp with a running lane and a block with one take (a
    converged lane idles in its warp; a block exits with its slowest
    lane); ``warp`` and ``block`` are the lanes of a warp and of a block
    (the box solve's thread groups: 32 / GROUP and P problems)."""
    it = iters.reshape(-1)
    B = it.numel()
    return {n: int(it.reshape(-1, n).amax(dim=1).sum().item()) * n
            / (its * B) for n in (1, warp, block)}


def stream_consensus_small(ctx):
    """Phase 27: the streamed consensus kernels against their plain version
    and, bitwise, against the resident consensus kernel, cold and then 4
    warm solves (phase 23's shapes, and groups of 1 and 16), on the route
    the group takes (the team consensus entries, in a block or across a
    cluster); each team launch bitwise the one-thread launch on the same
    state, cold and warm. Returns the largest difference from the plain
    version."""
    torch, tt, ast, counters = ctx.torch, ctx.tt, ctx.ast, ctx.counters
    kern = tt.kernels
    ref, ref_warm = (kern.solve_fused_streamed_reference,
                     kern.solve_fused_streamed_warm_reference)
    phase(f"phase 27: streamed consensus kernels vs plain version and the "
          f"resident consensus kernel, B={CONS_SMALL_B}")
    err = 0.0
    cases = [(f"quadrotor rho_c={CONS_RHO} {ng}x{G}", (ng, G), "quad")
             for ng, G in ((CONS_SMALL_B // 8, 8), (CONS_SMALL_B // 2, 2),
                           (8, CONS_SMALL_B // 8), (CONS_SMALL_B, 1),
                           (CONS_SMALL_B // 16, 16))]
    cases.append((f"rocket SOC rho_c={CONS_RHO} {CONS_SMALL_B // 8}x8",
                  (CONS_SMALL_B // 8, 8), "rocket"))
    for label, (ng, G), kind in cases:
        B = ng * G
        if kind == "quad":
            prob = consensus_problem(tt, torch, 100, 1)
            x0, Xref = inputs(torch, B, N=CONS_N, spread=0.3)
            Xref = Xref.clone()
            Xref[:, 2] = 0.5
            Uref = None
        else:
            prob = tt.with_consensus(rocket_problem(tt, torch, 100, 1),
                                     rho_c=CONS_RHO)
            x0, Xref, Uref = rocket_inputs(torch, B)
        x = x0.reshape(ng, G, -1)
        zero_counts(counters)
        cold = kern.solve_fused_streamed(prob, Xref, Uref, x)
        torch.cuda.synchronize()
        if ast.launch_counts[stream_keys(prob, G)[1]] < 1:
            raise AssertionError(f"{label} did not launch the streamed "
                                 "consensus kernels")
        took_route(ast, f"{label} streamed cold", prob, G)
        # Each team launch against the one-thread launch on the same
        # state, cold, then warm from a carry (its first launch stale).
        team_bits(ctx, f"{label} streamed", prob, Xref, Uref, x)
        team_bits(ctx, f"{label} streamed warm", prob, Xref, Uref, x,
                  kern.solve_fused_streamed_warm(
                      tt.with_settings(prob, max_iter=20), Xref, Uref, x,
                      tt.init_carry(prob, B))[2])
        same_bits(torch, f"{label} streamed cold", cold,
                  kern.solve_fused(prob, Xref, Uref, x), "solve_fused")
        sol_p, res_p = plain_groups(torch, ref, prob, Xref, Uref, x)
        fk, fp = lanes(cold[0]), lanes(sol_p)
        agreed = group_agree(fk.iter, fp.iter, G)
        err = max(err, compare(torch, f"{label} streamed cold vs plain", fk,
                               fp, cold[1].reshape(4, -1),
                               res_p.reshape(4, -1), lanes=agreed))
        c_s = c_r = c_p = tt.init_carry(prob, B)
        for step in range(1, 5):
            name = f"{label} streamed warm step {step}"
            before = agreed.clone()
            zero_counts(counters)
            s = kern.solve_fused_streamed_warm(prob, Xref, Uref, x, c_s)
            took_route(ast, name, prob, G)
            r = kern.solve_fused_warm(prob, Xref, Uref, x, c_r)
            sol_p, _, c_p = plain_groups(torch, ref_warm, prob, Xref, Uref, x,
                                         c_p)
            torch.cuda.synchronize()
            same_bits(torch, name, s, r, "solve_fused_warm")
            fk, fp = lanes(s[0]), lanes(sol_p)
            agreed &= group_agree(fk.iter, fp.iter, G)
            err = max(err, compare(torch, f"{name} vs plain", fk, fp,
                                   lanes=agreed, among=before),
                      compare_carry(torch, f"{name} vs plain", s[2], c_p,
                                    agreed))
            c_s, c_r = s[2], r[2]
            x = (x.reshape(B, -1) @ prob.A.T + fk.u[0] @ prob.B.T
                 + prob.f).reshape(ng, G, -1)
    return err


# The warm instantiations' launch counts of the resident kernels
# (csrc/admm_group.cu, csrc/admm_fused.cu), and the stale forward launches
# of csrc/admm_stream.cu: one of them a phase of a compacted solve.
WARM_COUNTS = ("warm_launch_count", "families_warm_launch_count",
               "adaptive_warm_launch_count",
               "adaptive_families_warm_launch_count",
               "consensus_warm_launch_count")
STALE_COUNTS = ("forward_stale", "forward_consensus_stale",
                "forward_adaptive_stale", "forward_team_stale",
                "forward_team_adaptive_stale", "forward_team_families_stale",
                "forward_team_consensus_stale")


def compact_drive(ctx, label, prob, x0, Xref=None, Uref=None, entries=None,
                  **kw):
    """One compacted solve through make_compact_solver with the counts at
    0: its result, the phases it ran and the launches of each warm
    instantiation and of the streamed kernels; with ``entries``, the set
    of resident C entries its phases must take (took_entries)."""
    torch, compact = ctx.torch, ctx.compact
    zero_counts(ctx.counters)
    compact.phase_count = 0
    out = ctx.tt.kernels.make_compact_solver(prob, **kw)(x0, Xref, Uref)
    torch.cuda.synchronize()
    if entries is not None:
        took_entries(ctx.admm_fused, label, entries)
    warm = sum(getattr(ctx.admm_fused, k) for k in WARM_COUNTS)
    stream = sum(ctx.ast.launch_counts[k] for k in STALE_COUNTS)
    phases = compact.phase_count
    if phases < 1 or warm + stream != phases:
        raise AssertionError(f"{label}: {phases} phases but {warm} warm "
                             f"and {stream} stale streamed launches")
    fail(label, bool(torch.isfinite(out[0].x).all()
                     and torch.isfinite(out[0].u).all()),
         "output is not finite")
    return out, phases


def compaction_phases(ctx):
    """Phases 26-32: lane compaction (kernels/compact.py) on the resident
    and streamed kernels, warm final=True phases, and the consensus
    instantiations of the streamed kernels. Returns the kernels-line
    numbers of the streamed consensus kernels."""
    torch, tt, convert, admm_fused, ast, compact = (
        ctx.torch, ctx.tt, ctx.convert, ctx.admm_fused, ctx.ast, ctx.compact)
    counters, card, peak_flops, peak_bw = (ctx.counters, ctx.card,
                                           ctx.peak_flops, ctx.peak_bw)
    kern = tt.kernels
    cpu = lambda a: None if a is None else a.cpu()
    drive = functools.partial(compact_drive, ctx)

    # 26. compaction on the kernels against compaction on the plain
    # versions on the CPU, at the bar of kernel against plain version
    B = COMPACT_SMALL_B
    phase(f"phase 26: compaction kernels vs plain versions, B={B}")
    x_mixed = mixed_inputs(torch, B, 0.05, 0.45, permute=False)
    x_hard = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (B, 12)), dtype=torch.float32, device=DEVICE)
    z1 = hover_ref(torch, N_HORIZON, 1.0)
    x_rock, Xr, Ur = rocket_inputs(torch, B)
    x_tree, Xt = tree_inputs(torch, B // 8, 8, 0.5)
    tables = tt.systems.crazyflie_sensitivity_tables()
    # Each case with the resident C entries its phases take: the
    # thread-group kernel's (box at fixed and adaptive rho and consensus at
    # (12, 4); the rocket's cones, its families kind), the streamed backend
    # none.
    box = {"tinympc_admm_group"}
    small = [
        ("box ct 1 chunk 15", lambda: problem(tt, torch, 500, 1), x_mixed,
         None, None, dict(chunk=15), box),
        ("box ct 1 chunk [100, 400]", lambda: problem(tt, torch, 500, 1),
         x_mixed, None, None, dict(chunk=COMPACT_CHUNK), box),
        ("box ct 25 chunk [100, 400]", lambda: problem(tt, torch, 500, 25),
         x_mixed, None, None, dict(chunk=COMPACT_CHUNK), box),
        ("rocket SOC chunk 20", lambda: rocket_problem(tt, torch, 100, 1),
         x_rock, Xr, Ur, dict(chunk=20), {GROUP_FAM}),
        ("adaptive rho chunk [100, 400]", lambda: adaptive_problem(
            tt, torch, 5.0, N_HORIZON, 500, 1, tables=tables), x_hard, z1,
         None, dict(chunk=COMPACT_CHUNK, backend="resident"), {GROUP_ADAPT}),
        ("box precise_tail 200 after 100", lambda: problem(tt, torch, 100,
                                                            1),
         x_mixed, None, None, dict(chunk=50, precise_tail=200), box),
    ] + [(f"consensus 128x8 {be} chunk [100, 400]",
          lambda: consensus_problem(tt, torch, 500, 1), x_tree, Xt, None,
          dict(chunk=COMPACT_CHUNK, backend=be),
          {GROUP_CONS} if be == "resident" else set())
         for be in ("resident", "streamed")]
    for label, make, x0, Xref, Uref, kw, entries in small:
        prob = make()
        prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                            "cpu")
        (sol_k, res_k), phases = drive(label, prob, x0, Xref, Uref,
                                       entries=entries, **kw)
        t0 = time.perf_counter()
        sol_c, res_c = kern.make_compact_solver(prob_c, **kw)(
            cpu(x0), cpu(Xref), cpu(Uref))
        plain_ms = 1e3 * (time.perf_counter() - t0)
        atol = 1e-3 if prob.settings.max_iter >= 500 else BAR_ATOL
        rows = res_k.shape[0]
        fk, fc = lanes(on_cpu(sol_k)), lanes(sol_c)
        held = (group_agree(fk.iter, fc.iter, x0.shape[1])
                if prob.spec.en_consensus else fk.iter == fc.iter)
        compare(torch, f"{label} vs plain(cpu)", fk, fc,
                res_k.reshape(rows, -1).cpu(), res_c.reshape(rows, -1),
                atol=atol, lanes=held)
        if rows == 5:
            compare_rho(f"{label} vs plain(cpu)", res_k[4].cpu(), res_c[4],
                        held)
        log(f"  {label}: {phases} phases, mean iters "
            f"{fk.iter.float().mean().item():.4f} (max "
            f"{fk.iter.max().item()}), solved frac "
            f"{fk.solved.float().mean().item():.5f}, plain (CPU) "
            f"{plain_ms:.1f} ms")

    err = stream_consensus_small(ctx)

    # 28. bench_all.py:448-452 / :497-501, the mixed batch to convergence
    B = COMPACT_B
    phase(f"phase 28: compaction of the mixed batch, B={B}, N={N_HORIZON}, "
          f"max_iter 500, ct 1, chunk {COMPACT_CHUNK}")
    prob = problem(tt, torch, 500, 1)
    x0 = mixed_inputs(torch, B)
    long_ms, long = host_ms(torch, lambda: kern.solve_fused(prob, None, None,
                                                            x0))
    (sol_c, res_c), phases = drive("mixed batch", prob, x0,
                                   chunk=COMPACT_CHUNK)
    same_bits(torch, "mixed batch compaction", (sol_c, res_c), long,
              "one long solve_fused")
    solver = kern.make_compact_solver(prob, chunk=COMPACT_CHUNK)
    t_long = [host_ms(torch, lambda: kern.solve_fused(prob, None, None,
                                                      x0))[0]
              for _ in range(3)]
    t_comp = [host_ms(torch, lambda: solver(x0))[0] for _ in range(3)]
    card_comp, _ = cuda_ms(torch, lambda: solver(x0), 3)
    it, sv = long[0].iter, long[0].solved
    live = int((~(sv & (it <= COMPACT_CHUNK[0]))).sum().item())
    w_lanes = 32 // admm_fused.GROUP
    b_lanes = admm_fused.group_geometry(N_HORIZON, False)[0]
    sh = warp_shares(it, int(it.max().item()), w_lanes, b_lanes)
    # The compacted solve's work: the long solve's iterations (the counts
    # are the same), x0 and the outputs once, and each phase's carry read
    # and written once at the phase's width.
    ops, nbytes = fused_work(N_HORIZON, 12, 4, B, int(it.sum().item()))
    nbytes += 2 * 4 * lane_carry_floats(tt.init_carry(prob, 1)) * (
        B + max(live, min(256, B)))
    b_comp = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  mixed batch: one long solve_fused {statistics.median(t_long):.4f}"
        f" ms (reps {[round(t, 4) for t in t_long]}), compaction "
        f"{statistics.median(t_comp):.4f} ms (reps "
        f"{[round(t, 4) for t in t_comp]}), both on the host clock; "
        f"compaction {card_comp:.4f} ms on the card's clock, bound "
        f"{b_comp[0]:.4f} ms ({b_comp[1]}); "
        f"{phases} phases, live lanes {B} then {live} "
        f"({live / B:.4f}); solved frac {sv.float().mean().item():.5f}, "
        f"mean iters {it.float().mean().item():.4f}; the long solve's "
        f"lane-iterations with a running lane {sh[1]:.4f}, warp-iterations "
        f"with one {sh[w_lanes]:.4f} ({w_lanes} problems a warp), "
        f"block-iterations with one {sh[b_lanes]:.4f} ({b_lanes} a block); "
        f"first call of the compaction {long_ms:.1f} ms long; card {card}")
    del long, sol_c, res_c

    # 29. bench_all.py:536-559, the 1M fleet, segments of 2^18
    B = COMPACT_FLEET_B
    phase(f"phase 29: the 1M fleet, B={B}, segment={COMPACT_SEGMENT}, "
          f"chunk {COMPACT_CHUNK}")
    x0 = mixed_inputs(torch, B)
    t_long, long = host_ms(torch, lambda: kern.solve_fused(prob, None, None,
                                                           x0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (sol_c, res_c), phases = drive("1M fleet", prob, x0, chunk=COMPACT_CHUNK,
                                   segment=COMPACT_SEGMENT)
    t_comp = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    same_bits(torch, "1M fleet compaction", (sol_c, res_c), long,
              "one long solve_fused")
    log(f"  1M fleet: one long solve_fused {t_long:.4f} ms, compaction "
        f"{t_comp:.4f} ms ({phases} phases over {B // COMPACT_SEGMENT} "
        f"segments), both on the host clock; peak device memory of the "
        f"compaction {peak:.2f} GiB; solved frac "
        f"{long[0].solved.float().mean().item():.5f}; card {card}")
    del long, sol_c, res_c, x0

    # 30. bench_all.py:503-526, streamed compaction at N=256
    B = LH_CONV_B
    phase(f"phase 30: streamed compaction, N={LH_CONV_N}, B={B}, max_iter "
          f"{LH_CONV_ITER}, chunk {COMPACT_CHUNK}")
    prob = problem(tt, torch, LH_CONV_ITER, 1, N=LH_CONV_N)
    x0 = mixed_inputs(torch, B)
    long = kern.solve_fused_streamed(prob, None, None, x0)
    out = {}
    for be in ("streamed", "resident"):
        out[be], phases = drive(f"N={LH_CONV_N} {be} compaction", prob, x0,
                                chunk=COMPACT_CHUNK, backend=be)
        if be == "streamed":
            took_route(ast, f"N={LH_CONV_N} streamed compaction", prob)
        same_bits(torch, f"N={LH_CONV_N} {be} compaction", out[be], long,
                  "phase 20's long solve_fused_streamed")
    auto = compact._backend(prob, "auto")
    t = {name: statistics.median(host_ms(torch, fn)[0] for _ in range(3))
         for name, fn in (
             ("long streamed", lambda: kern.solve_fused_streamed(
                 prob, None, None, x0)),
             ("streamed compaction", lambda: kern.make_compact_solver(
                 prob, chunk=COMPACT_CHUNK, backend="streamed")(x0)),
             ("resident compaction", lambda: kern.make_compact_solver(
                 prob, chunk=COMPACT_CHUNK, backend="resident")(x0)))}
    log(f"  N={LH_CONV_N}: \"auto\" picks {auto}; on the host clock "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; solved frac {long[0].solved.float().mean().item():.5f}; card "
        f"{card}")
    del long, out

    # 31. bench_all.py:224-250's G=16 batch: consensus compaction on both
    # backends, and the streamed consensus solve beside the resident one
    ng, G, B = CONS_NG, CONS_G, CONS_NG * CONS_G
    phase(f"phase 31: consensus compaction, {ng} x {G}, max_iter "
          f"{CONS_ITER}, chunk {COMPACT_CHUNK}; the streamed consensus "
          f"solve")
    prob = consensus_problem(tt, torch, CONS_ITER, 1)
    x0, Xref = tree_inputs(torch, ng, G, 0.5)
    comp, stale = {}, 0
    for be in ("resident", "streamed"):
        comp[be], _ = drive(f"G={G} {be} compaction", prob, x0, Xref,
                            chunk=COMPACT_CHUNK, backend=be,
                            entries={GROUP_CONS} if be == "resident"
                            else set())
        if be == "streamed":
            took_route(ast, f"G={G} streamed compaction", prob, G)
            stale = ast.launch_counts[stream_keys(prob, G)[2]]
    same_bits(torch, f"G={G} compaction", comp["streamed"], comp["resident"],
              "the resident backend")
    # The manual loop on the card: every phase relaunches every group
    # (full width) from its carry, the host keeps first-convergence
    # outputs (tests/test_compact.py:296-321).
    carry, man, used = tt.init_carry(prob, B), None, 0
    zero_entries(admm_fused)
    for step in COMPACT_CHUNK:
        p = tt.with_settings(prob, max_iter=step)
        sol, res, carry = kern.solve_fused_warm(p, Xref, None, x0, carry,
                                                final=True)
        new = [sol.x, sol.u, sol.iter, sol.solved, res]
        if man is None:
            man = new
        else:
            live = ~man[3]
            man = [torch.where(live[None, ..., None], new[0], man[0]),
                   torch.where(live[None, ..., None], new[1], man[1]),
                   torch.where(live, used + new[2], man[2]),
                   man[3] | new[3],
                   torch.where(live[None], new[4], man[4])]
        used += step
    took_entries(admm_fused, f"G={G} final=True phases",
                 {GROUP_CONS: len(COMPACT_CHUNK)})
    same_bits(torch, f"G={G} compaction", comp["resident"],
              (tt.Solution(iter=man[2], solved=man[3], x=man[0], u=man[1]),
               man[4]), "the manual loop of final=True phases")
    # The spread bar's witness: admm.solve (the XLA path's rule) on the
    # same phases, its state carried between them and a lane's outputs
    # kept from its first convergence on. A compacted consensus solve is a
    # sequence of warm solves, each re-seeding a live group's slack from
    # the carried u[0] (tinympc_tpu/kernels/compact.py:42-50), and misses
    # the bar more often than one long solve does; one long admm.solve is
    # printed beside it, and tests/test_torch_compact.py shows the JAX
    # package's own compaction missing it more often than its long solve.
    def phased_admm():
        st, out = tt.init_state(prob, (ng, G)), None
        for step in COMPACT_CHUNK:
            sol, st, _ = tt.solve(tt.with_settings(prob, max_iter=step), st,
                                  Xref, None, x0)
            if out is None:
                out = sol
            else:
                live = ~out.solved
                out = dataclasses.replace(
                    out, u=torch.where(live[None, ..., None], sol.u, out.u),
                    solved=out.solved | sol.solved)
        return out

    hold_spread(f"G={G} compaction", spread_stats(comp["resident"][0],
                                                  prob.settings.abs_pri_tol),
                prob.settings.abs_pri_tol, phased_admm,
                also=[("one long admm.solve", lambda: tt.solve(
                    prob, tt.init_state(prob, (ng, G)), Xref, None,
                    x0)[0])])
    zero_counts(counters)
    s_cold = kern.solve_fused_streamed(prob, Xref, None, x0)
    torch.cuda.synchronize()
    keys = stream_keys(prob, G)
    launches = (ast.launch_counts[keys[0]], ast.launch_counts[keys[1]])
    if min(launches) < 1 or stale < 1:
        raise AssertionError("the G=16 batch did not launch the streamed "
                             "consensus kernels")
    took_route(ast, f"G={G} streamed solve", prob, G)
    same_bits(torch, f"G={G} streamed solve", s_cold,
              kern.solve_fused(prob, Xref, None, x0), "solve_fused")
    t = {name: statistics.median(host_ms(torch, fn)[0] for _ in range(3))
         for name, fn in (
             ("resident solve_fused", lambda: kern.solve_fused(
                 prob, Xref, None, x0)),
             ("solve_fused_streamed", lambda: kern.solve_fused_streamed(
                 prob, Xref, None, x0)),
             ("resident compaction", lambda: kern.make_compact_solver(
                 prob, chunk=COMPACT_CHUNK)(x0, Xref)),
             ("streamed compaction", lambda: kern.make_compact_solver(
                 prob, chunk=COMPACT_CHUNK, backend="streamed")(x0, Xref)))}
    log(f"  G={G}: on the host clock " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; streamed launches {launches} + {stale} stale (in the "
        f"compaction); solved frac "
        f"{s_cold[0].solved.float().mean().item():.5f}; card {card}")
    # Per launch, on iteration 0 of a fresh state: cold, and stale from
    # the compaction's first-phase carry.
    spec = prob.spec
    lt = stream_launches(torch, ast, prob, Xref, None, x0)
    c1 = kern.solve_fused_streamed_warm(tt.with_settings(prob, max_iter=100),
                                        Xref, None, x0,
                                        tt.init_carry(prob, B))[2]
    lt_s = stream_launches(torch, ast, prob, Xref, None, x0, c1)
    # A lane that converges in the measured launch also stores its offer.
    fb, ff = stream_floats(spec)
    ob, of = stream_ops(spec, G)
    b_bwd = bound(B * ob, 4 * B * fb, peak_flops, peak_bw)
    b_fwd = bound(B * of, 4 * (B * ff + spec.nu * lt["converged"]),
                  peak_flops, peak_bw)
    b_stale = bound(B * of, 4 * (B * stream_floats(spec, True)[1]
                                 + spec.nu * lt_s["converged"]),
                    peak_flops, peak_bw)
    log(f"  G={G}: lanes that converged in the measured forward launch "
        f"{lt['converged']}, stale {lt_s['converged']}")
    # Both designs per launch, in turns on fresh states: lane teams and
    # one thread a lane (team=False), CUDA events and device time.
    designs = design_times(ctx, prob, Xref, None, x0)
    designs_s = design_times(ctx, prob, Xref, None, x0, c1)
    for name, d in (("backward", designs["backward"]),
                    ("forward", designs["forward"]),
                    ("forward stale", designs_s["forward"])):
        log(f"  G={G} streamed consensus {name} by design: " + "; ".join(
            f"{k} events {v['ms']:.4f} ms, device "
            + ("not measured" if v["device_ms"] is None
               else f"{v['device_ms']:.4f} ms") for k, v in d.items())
            + f"; card {card}")
    for name, ms, plain, b, e in (
            ("backward", lt["bwd_ms"], lt["plain_bwd_ms"], b_bwd,
             lt["err_b"]),
            ("forward", lt["fwd_ms"], lt["plain_fwd_ms"], b_fwd,
             lt["err_f"]),
            ("forward stale", lt_s["fwd_ms"], lt_s["plain_fwd_ms"], b_stale,
             lt_s["err_f"])):
        log(f"  G={G} streamed consensus {name}: {ms:.4f} ms a launch, "
            f"bound {b[0]:.6f} ms ({b[1]}), plain {plain:.1f} ms, one launch "
            f"vs plain max diff {e:.3e}; card {card}")
        fail(f"G={G} streamed consensus {name}", e <= BAR_ATOL,
             f"one launch differs from its plain version by {e:.3e}")
    rows = {
        keys[0]: dict(
            launches=launches[0], err=max(err, lt["err_b"]),
            ms=lt["bwd_ms"], plain_ms=lt["plain_bwd_ms"], bound_ms=b_bwd[0],
            bound_by=b_bwd[1]),
        keys[1]: dict(
            launches=launches[1], err=max(err, lt["err_f"]),
            ms=lt["fwd_ms"], plain_ms=lt["plain_fwd_ms"], bound_ms=b_fwd[0],
            bound_by=b_fwd[1]),
        keys[2]: dict(
            launches=stale, err=max(err, lt_s["err_f"]), ms=lt_s["fwd_ms"],
            plain_ms=lt_s["plain_fwd_ms"], bound_ms=b_stale[0],
            bound_by=b_stale[1])}

    # 32. bench_all.py:413-435, the precision-recovery ladder beside its
    # matched-budget control
    B = ADAPT_B
    phase(f"phase 32: the ladder, hard batch B={B}, max_iter 500 + "
          f"precise_tail 500 against max_iter 1000 in [100, 400, 500]")
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.5, 0.5, (B, 12)), dtype=torch.float32, device=DEVICE)
    p500, p1k = problem(tt, torch, 500, 1), problem(tt, torch, 1000, 1)
    (lad, ladres), ph_l = drive("ladder", p500, x0, z1, chunk=COMPACT_CHUNK,
                                precise_tail=500)
    (ctl, ctlres), ph_c = drive("ladder control", p1k, x0, z1,
                                chunk=COMPACT_CHUNK + [500])
    same_bits(torch, "ladder", (lad, ladres), (ctl, ctlres),
              "the matched-budget control")
    t_l = host_ms(torch, lambda: kern.make_compact_solver(
        p500, chunk=COMPACT_CHUNK, precise_tail=500)(x0, z1))[0]
    t_c = host_ms(torch, lambda: kern.make_compact_solver(
        p1k, chunk=COMPACT_CHUNK + [500])(x0, z1))[0]
    base = kern.solve_fused(p500, z1, None, x0)[0]
    log(f"  ladder: {t_l:.4f} ms ({ph_l} phases), control {t_c:.4f} ms "
        f"({ph_c} phases), on the host clock; solved frac at 500 "
        f"{base.solved.float().mean().item():.5f}, after the tail "
        f"{lad.solved.float().mean().item():.5f}, lanes past 500 "
        f"{(lad.iter > 500).float().mean().item():.5f}; card {card}")
    return rows


def adaptive_rocket(ctx, max_iter, ct, tables, cones=True, tol=1.0,
                    apply_c=False, N=FAM_N):
    """phase 10's rocket (or its box alone) with adaptive rho, the rocket's
    sensitivity ``tables`` attached, and its floor of rho lowered so that
    rho moves (ROCKET_RHO_MIN)."""
    prob = rocket_problem(ctx.tt, ctx.torch, max_iter, ct, N=N, cones=cones)
    prob = ctx.tt.with_sensitivities(prob, tables)
    return ctx.tt.with_settings(prob, adaptive_rho=True,
                                adaptive_rho_min=ROCKET_RHO_MIN,
                                adaptive_rho_tolerance=tol,
                                adaptive_rho_apply_c=apply_c)


def timed_setup(ctx, label, make):
    """``make()`` on the card's clock, logged as set-up."""
    t0 = time.perf_counter()
    out = make()
    ctx.torch.cuda.synchronize()
    log(f"  {label}: {1e3 * (time.perf_counter() - t0):.1f} ms (set-up)")
    return out


def adaptive_family_phases(ctx):
    """Phases 33-34: adaptive rho with the constraint families (and every
    problem at (6, 3)) on the families adaptive kinds of
    csrc/admm_group.cu (entry tinympc_admm_group_families), and phase 33's
    rocket cones on the one-thread kernel of csrc/admm_fused.cu as well.
    Returns the kernels-line numbers of the rocket SOC cold batch and of
    its warm sequence."""
    torch, tt, convert, admm_fused = (ctx.torch, ctx.tt, ctx.convert,
                                      ctx.admm_fused)
    kern = tt.kernels

    # 33. small batches against the plain version, on the card and the CPU
    B = ADAPT_FAM_B
    phase(f"phase 33: families adaptive kernel vs plain versions, B={B}")
    rocket = rocket_problem(tt, torch, 100, 1)
    ctx.rocket_tables = sensitivity_tables(timed_setup(
        ctx, "with_settings(adaptive_rho=True) on the rocket, "
        "compute_sensitivities on the host",
        lambda: tt.with_settings(rocket, adaptive_rho=True)))
    plane = quad_plane_problem(tt, torch, False, 100, 1, LOW_CEILING["linear"])
    plane_tables = sensitivity_tables(timed_setup(
        ctx, "with_settings(adaptive_rho=True) on the 50 Hz quadrotor, "
        "compute_sensitivities on the host",
        lambda: tt.with_settings(plane, adaptive_rho=True)))
    x_r, Xr, Ur = rocket_inputs(torch, B)
    x_q, Xq, _ = quad_plane_inputs(torch, B)

    def plane_problem(kind):
        prob = quad_plane_problem(tt, torch, kind == "tv", 100, 1,
                                  LOW_CEILING[kind])
        return tt.with_settings(tt.with_sensitivities(prob, plane_tables),
                                adaptive_rho=True)

    t = ctx.rocket_tables
    cases = [
        ("rocket SOC adaptive", adaptive_rocket(ctx, 100, 1, t), x_r, Xr,
         Ur),
        ("rocket SOC adaptive apply_c", adaptive_rocket(
            ctx, 100, 1, t, apply_c=True), x_r, Xr, Ur),
        ("rocket SOC fixed rho", rocket_problem(tt, torch, 100, 1), x_r, Xr,
         Ur),
        ("rocket box adaptive guard tol 3", adaptive_rocket(
            ctx, 100, 1, t, cones=False, tol=3.0), x_r, Xr, Ur),
        ("rocket box fixed rho", rocket_problem(tt, torch, 100, 1,
                                                cones=False), x_r, Xr, Ur),
        ("quadrotor linear low ceilings adaptive", plane_problem("linear"),
         x_q, Xq, None),
        ("quadrotor tv low ceilings adaptive", plane_problem("tv"), x_q,
         Xq, None)]
    group_outs = {}
    for label, prob, x0, Xref, Uref in cases:
        zero_counts(ctx.counters)
        group_outs[label] = adaptive_small(
            torch, tt, convert, f"{label} cold B={B}", prob, x0, Xref, B,
            Uref)
        key = ("adaptive_families_launch_count"
               if prob.settings.adaptive_rho else "families_launch_count")
        fail(label, getattr(admm_fused, key) >= 1,
             f"the kernel's {key} stayed 0")
        took_entries(admm_fused, label, {GROUP_FAM})
    zero_entries(admm_fused)
    group_warm = adaptive_warm_small(
        torch, tt, convert, "rocket SOC adaptive warm", cases[0][1], x_r, Xr,
        B, Ur, steps=5, carry_spread=True)
    took_entries(admm_fused, "rocket SOC adaptive warm", {GROUP_FAM})
    # The one-thread families kernel (csrc/admm_fused.cu), which the
    # families' multi-system launch and the horizons past the group
    # kernel's cutoff take: the rocket's cones at adaptive rho (with and
    # without apply_c) and at fixed rho with the route giving no group
    # launch, at the same bars against the plain versions, and bitwise
    # the group entry's solves on the same inputs.
    for label, prob, x0, Xref, Uref in cases[:3]:
        name = f"{label} one-thread kernel"
        zero_entries(admm_fused)
        with pinned(admm_fused, "group_route", None):
            got = adaptive_small(torch, tt, convert, f"{name} cold B={B}",
                                 prob, x0, Xref, B, Uref)
        took_entries(admm_fused, name, {FUSED: 1})
        same_bits(torch, name, got, group_outs[label],
                  "the group entry's solve")
    zero_entries(admm_fused)
    with pinned(admm_fused, "group_route", None):
        got = adaptive_warm_small(
            torch, tt, convert, "rocket SOC adaptive warm one-thread kernel",
            cases[0][1], x_r, Xr, B, Ur, steps=5, carry_spread=True)
    took_entries(admm_fused, "rocket SOC adaptive warm one-thread kernel",
                 {FUSED: 5})
    for step, (g, w) in enumerate(zip(got, group_warm)):
        same_bits(torch, f"rocket SOC adaptive warm one-thread kernel step "
                  f"{step}", g, w, "the group entry's solve")

    # 34. the rocket SOC batch at full width with adaptive rho, beside
    # fixed rho on the same inputs: cold, then phase 11's external plant
    B = FAM_B
    phase(f"phase 34: rocket SOC adaptive, B={B}, N={FAM_N}, cold and 5 "
          f"warm solves, beside fixed rho")
    prob_a = adaptive_rocket(ctx, 100, 1, t)
    prob_f = rocket_problem(tt, torch, 100, 1)
    x0, Xref, Uref = rocket_inputs(torch, B)
    zero_counts(ctx.counters)
    sol_k, res_k = kern.solve_fused(prob_a, Xref, Uref, x0)
    torch.cuda.synchronize()
    launches = admm_fused.adaptive_families_launch_count
    if launches < 1:
        raise AssertionError("the adaptive rocket batch did not launch the "
                             "families adaptive kernel")
    took_entries(admm_fused, "rocket SOC adaptive cold",
                 {GROUP_FAM: launches})
    if sol_k.x.shape != (FAM_N, B, 6) or res_k.shape != (5, B):
        raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                             f"{res_k.shape}")
    plain_ms, (sol_p, res_p) = host_ms(
        torch, lambda: kern.solve_fused_reference(prob_a, Xref, Uref, x0))
    err = compare(torch, "rocket SOC adaptive cold", sol_k, sol_p,
                  res_k[:4], res_p[:4], lanes="same_iters")
    compare_rho("rocket SOC adaptive cold", res_k[4], res_p[4],
                sol_k.iter == sol_p.iter)

    def time_solve(prob, x, carry=None):
        """Kernel ms (CUDA events), the entry point's call on the host
        clock, and the kernel's solution."""
        tables, xc, params = admm_fused._prepare(prob, Xref, Uref, x)
        if carry is None:
            run = lambda: admm_fused._solve_kernel(tables, xc, FAM_N, 6, 3,
                                                   **params)
            call = lambda: kern.solve_fused(prob, Xref, Uref, x)
        else:
            c = admm_fused._carry_tensors(prob, carry, B)
            run = lambda: admm_fused._solve_kernel_warm(
                tables, xc, c, FAM_N, 6, 3, **params)
            call = lambda: kern.solve_fused_warm(prob, Xref, Uref, x, carry)
        sol = run()[0]                                  # warm-up
        ms, times = cuda_ms(torch, run, REPS)
        call_ms = statistics.median(host_ms(torch, call)[0]
                                    for _ in range(3))
        return sol, ms, times, call_ms

    rows = {}

    def report(label, key, prob, sol, ms, times, call_ms, plain, errv,
               nlaunch, fixed, carry=None):
        floats = 0 if carry is None else lane_carry_floats(carry)
        ops, nbytes = adaptive_work(FAM_N, 6, 3, B, sol.iter, False, floats,
                                    prob.spec)
        b = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
        mean_it = sol.iter.float().mean().item()
        sol_f, ms_f = fixed
        mean_f = sol_f.iter.float().mean().item()
        log(f"  {label}: kernel {ms:.4f} ms (reps "
            f"{[round(x, 4) for x in times]}), call {call_ms:.4f} ms on the "
            f"host clock (kernel share {ms / call_ms:.4f}), "
            f"{B / (ms / 1e3):.1f} solves/s, solved frac "
            f"{sol.solved.float().mean().item():.5f}, mean iters "
            f"{mean_it:.4f} ({ms / mean_it:.5f} ms per mean iteration), "
            f"adaptations {adaptations(sol.iter)}, bound {b[0]:.4f} ms "
            f"({b[1]}; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), plain "
            f"{plain:.1f} ms, launches {nlaunch}; fixed rho on the same "
            f"inputs: kernel {ms_f:.4f} ms, solved frac "
            f"{sol_f.solved.float().mean().item():.5f}, mean iters "
            f"{mean_f:.4f} ({ms_f / mean_f:.5f} ms per mean iteration); "
            f"adaptive / fixed per mean iteration "
            f"{(ms / mean_it) / (ms_f / mean_f):.4f}; card {ctx.card}")
        rows[key] = dict(launches=nlaunch, err=errv, ms=ms, plain_ms=plain,
                         bound_ms=b[0], bound_by=b[1])

    sol_t, ms, times, call_ms = time_solve(prob_a, x0)
    sol_tf, ms_f = time_solve(prob_f, x0)[:2]
    log(f"  rocket SOC adaptive cold: final rho quartiles "
        f"{[round(q, 4) for q in quartiles(res_k[4])]}, lanes whose rho "
        f"moved {(res_k[4] != float(prob_a.cache.rho)).float().mean():.5f}")
    report("rocket SOC adaptive cold", "adaptive_families", prob_a, sol_t,
           ms, times, call_ms, plain_ms, err, launches, (sol_tf, ms_f))
    # The source's settings: adaptive_rho_min's default of 1 pins the
    # rocket's rho of 1, so the adaptive kernel runs with drho = 0.
    at_floor = tt.with_settings(tt.with_sensitivities(prob_f, t),
                                adaptive_rho=True)
    sol_pin, ms_pin, times_pin = time_solve(at_floor, x0)[:3]
    same = all(torch.equal(getattr(sol_pin, k), getattr(sol_tf, k))
               for k in ("x", "u", "iter", "solved"))
    mean_pin = sol_pin.iter.float().mean().item()
    mean_f = sol_tf.iter.float().mean().item()
    log(f"  rocket SOC adaptive cold, adaptive_rho_min 1 (rho pinned at "
        f"1): kernel {ms_pin:.4f} ms (reps "
        f"{[round(v, 4) for v in times_pin]}), mean iters "
        f"{mean_pin:.4f}, solved frac "
        f"{sol_pin.solved.float().mean():.5f}, bitwise the fixed-rho "
        f"kernel's solution: {same}; per mean iteration against fixed rho "
        f"{(ms_pin / mean_pin) / (ms_f / mean_f):.4f}")

    c_k, c_f = tt.init_carry(prob_a, B), tt.init_carry(prob_f, B)
    zero_counts(ctx.counters)
    states, sols, carries = [], [], []
    x = x0
    for step in range(5):
        sol_k, _, c_k = kern.solve_fused_warm(prob_a, Xref, Uref, x, c_k)
        states.append(x)
        sols.append(sol_k)
        carries.append(c_k)
        x = x @ prob_a.A.T + sol_k.u[0] @ prob_a.B.T + prob_a.f
    torch.cuda.synchronize()
    warm_launches = admm_fused.adaptive_families_warm_launch_count
    if warm_launches < 5:
        raise AssertionError("the adaptive rocket sequence did not launch "
                             "the warm families adaptive kernel")
    took_entries(admm_fused, "rocket SOC adaptive sequence",
                 {GROUP_FAM: warm_launches})
    c_p = tt.init_carry(prob_a, B)
    agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
    err_w = 0.0
    for step, (x_s, sol_k, c_ks) in enumerate(zip(states, sols, carries)):
        plain_w_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: kern.solve_fused_warm_reference(
                prob_a, Xref, Uref, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_w = max(err_w, compare(torch, f"rocket SOC adaptive warm step "
                                   f"{step}", sol_k, sol_p, lanes=agreed))
        compare_rho(f"rocket SOC adaptive warm step {step}", c_ks.rho[0],
                    c_p.rho[0], agreed)
        log(f"  step {step}: mean iters "
            f"{sol_k.iter.float().mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}")
    compare_carry(torch, "rocket SOC adaptive after 5 steps", c_k, c_p,
                  agreed)
    # Fixed rho along the same states, for its sixth solve beside.
    for x_s in states:
        c_f = kern.solve_fused_warm(prob_f, Xref, Uref, x_s, c_f)[2]
    sol_w, w_ms, times, call_ms = time_solve(prob_a, x, c_k)
    sol_wf, w_ms_f = time_solve(prob_f, x, c_f)[:2]
    report("rocket SOC adaptive solve_fused_warm (the sixth solve)",
           "adaptive_families_warm", prob_a, sol_w, w_ms, times, call_ms,
           plain_w_ms, err_w, warm_launches, (sol_wf, w_ms_f), c_k)
    return rows


def adaptive_stream_phases(ctx):
    """Phases 35-37: adaptive rho on the adaptive instantiations of
    csrc/admm_stream.cu, and compaction on adaptive problems. Returns the
    kernels-line numbers of the adaptive backward, forward and stale
    forward kernels, on lane teams (box problems) and on one thread a lane
    (the rocket's cones)."""
    torch, tt, admm_fused, ast = ctx.torch, ctx.tt, ctx.admm_fused, ctx.ast
    kern = tt.kernels
    ref, ref_warm = (kern.solve_fused_streamed_reference,
                     kern.solve_fused_streamed_warm_reference)
    drive = functools.partial(stream_drive, ctx)
    report = functools.partial(stream_report, ctx)
    resident = functools.partial(resident_cold, admm_fused)
    rows = {}

    def row(key, launches, err, ms, plain_ms, b):
        rows[key] = dict(launches=launches, err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1])

    # 35. small batches: the streamed kernels against their plain versions
    # and, bitwise, against the resident adaptive kernel, cold and warm
    B, N = LH_B, STREAM_ADAPT_N
    phase(f"phase 35: streamed adaptive kernels vs plain versions and the "
          f"resident adaptive kernel, B={B}, N={N}")
    t5 = ctx.tables[5.0]
    x_q, X_q = inputs(torch, B, N=N, spread=0.3)
    x_r, X_r, U_r = rocket_descent_inputs(torch, B, N)
    cases = [
        ("box", adaptive_problem(tt, torch, 5.0, N, 100, 1, tables=t5),
         x_q, X_q, None),
        ("box apply_c", adaptive_problem(tt, torch, 5.0, N, 100, 1,
                                         apply_c=True, tables=t5),
         x_q, X_q, None),
        ("box guard tol 3 rho0 1000", adaptive_problem(
            tt, torch, DETUNED_RHO, N, 100, 1, tol=3.0,
            tables=ctx.tables[DETUNED_RHO]), x_q, X_q, None),
        ("rocket SOC", adaptive_rocket(ctx, 100, 1, ctx.rocket_tables, N=N),
         x_r, X_r, U_r)]
    for case, prob, x0, Xref, Uref in cases:
        label = f"streamed adaptive {case}"
        (sol_k, res_k), launches = drive(label, prob, Xref, Uref, x0)
        zero_entries(admm_fused)
        same_bits(torch, label, (sol_k, res_k),
                  kern.solve_fused(prob, Xref, Uref, x0), "solve_fused")
        # The resident adaptive kernel it is held to: the thread-group
        # kernel's, its families kinds at (6, 3).
        took_entries(admm_fused, f"{label} resident", {
            GROUP_FAM if prob.spec.nx == 6 else GROUP_ADAPT: 1})
        sol_p, res_p = plain_wide(torch, ref, prob, Xref, Uref, x0)
        compare(torch, f"{label} vs plain", sol_k, sol_p, res_k[:4],
                res_p[:4])
        compare_rho(f"{label} vs plain", res_k[4], res_p[4],
                    sol_k.iter == sol_p.iter)
        log(f"  {label}: launches {launches}, mean iters "
            f"{sol_k.iter.float().mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}, final rho "
            f"quartiles {[round(q, 4) for q in quartiles(res_k[4])]}")
        if case == "rocket SOC":
            # The one-thread adaptive kernels, which the families run.
            lt, b_bwd, b_fwd = report(label, prob, Xref, Uref, x0, sol_k,
                                      launches)
            row("backward_adaptive", launches[0], lt["err_b"],
                lt["bwd_ms"], lt["plain_bwd_ms"], b_bwd)
            row("forward_adaptive", launches[1], lt["err_f"], lt["fwd_ms"],
                lt["plain_fwd_ms"], b_fwd)
        c_s = c_r = tt.init_carry(prob, B)
        x = x0
        states = []
        err = 0.0
        for step in range(5):
            name = f"{label} warm step {step}"
            s = kern.solve_fused_streamed_warm(prob, Xref, Uref, x, c_s)
            r = kern.solve_fused_warm(prob, Xref, Uref, x, c_r)
            same_bits(torch, name, s, r, "solve_fused_warm")
            if step in (0, 4):
                # The plain version on the first and the fifth solve, each
                # from the kernels' carry in.
                p = plain_wide(torch, ref_warm, prob, Xref, Uref, x, c_s)
                held = s[0].iter == p[0].iter
                err = max(err, compare(torch, f"{name} vs plain", s[0],
                                       p[0], lanes=held),
                          compare_carry(torch, f"{name} vs plain", s[2],
                                        p[2], held))
                compare_rho(f"{name} vs plain", s[2].rho[0], p[2].rho[0],
                            held)
            states.append((x, c_s))
            c_s, c_r = s[2], r[2]
            x = x @ prob.A.T + s[0].u[0] @ prob.B.T + prob.f
        if case in ("box", "rocket SOC"):
            # The fifth solve again, for its launches and times: the team
            # kernels' stale launch (box) and the one-thread kernel's.
            x5, c5 = states[-1]
            launches5 = drive(f"{label} warm", prob, Xref, Uref, x5, c5)[1]
            lt, _, b_stale = report(f"{label} warm (the fifth solve)", prob,
                                    Xref, Uref, x5, s[0], launches5,
                                    carry=c5)
            row(f"{stream_keys(prob)[2]}", launches5[2],
                max(err, lt["err_f"]), lt["fwd_ms"], lt["plain_fwd_ms"],
                b_stale)

    # 36. bench_all.py:369-392, the long-horizon adaptive batch
    B, N = LH_B, LH_SOC_N
    phase(f"phase 36: long horizon adaptive, N={N}, B={B}, max_iter "
          f"{LH_ITER}, ct 1; then N={LH_WALL_N}")
    for label, fn in sorted(ctx.ptxas.items()):
        if "admm_stream" in label and "adaptive" in label:
            log(f"  ptxas {label}: {fn.get('regs')} registers, "
                f"{fn.get('spill_st')} / {fn.get('spill_ld')} bytes spill "
                f"stores / loads")
    prob = adaptive_problem(tt, torch, 5.0, N, LH_ITER, 1, tables=t5)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.3, 0.3,
                                                          (B, 12)),
                         dtype=torch.float32, device=DEVICE)
    Xref = hover_ref(torch, N, 1.0)
    label = f"long horizon adaptive N={N}"
    (sol_k, res_k), launches = drive(label, prob, Xref, None, x0)
    zero_entries(admm_fused)
    same_bits(torch, label, (sol_k, res_k),
              kern.solve_fused(prob, Xref, None, x0), "solve_fused")
    took_entries(admm_fused, f"{label} resident", {GROUP_ADAPT: 1})
    plain_ms, (sol_p, res_p) = host_ms(
        torch, lambda: plain_wide(torch, ref, prob, Xref, None, x0))
    err = compare(torch, f"{label} vs plain", sol_k, sol_p, res_k[:4],
                  res_p[:4])
    compare_rho(f"{label} vs plain", res_k[4], res_p[4],
                sol_k.iter == sol_p.iter)
    lt, b_bwd, b_fwd = report(label, prob, Xref, None, x0, sol_k, launches,
                              resident=resident(prob, Xref, None, x0))
    log(f"  {label}: plain solve {plain_ms:.1f} ms, final rho quartiles "
        f"{[round(q, 4) for q in quartiles(res_k[4])]}")
    row("backward_team_adaptive", launches[0], max(err, lt["err_b"]),
        lt["bwd_ms"], lt["plain_bwd_ms"], b_bwd)
    row("forward_team_adaptive", launches[1], max(err, lt["err_f"]),
        lt["fwd_ms"], lt["plain_fwd_ms"], b_fwd)
    N = LH_WALL_N
    prob = adaptive_problem(tt, torch, 5.0, N, LH_ITER, 1, tables=t5)
    x0, Xref = long_horizon_inputs(torch, B, N)
    fail(f"adaptive N={N}", not kern.fused_supported(prob)
         and kern.stream_supported(prob),
         "the resident solve takes, or the streamed one refuses, the "
         "adaptive problem past shared memory")
    label = f"long horizon adaptive cold N={N}"
    (sol_k, res_k), launches = drive(label, prob, Xref, None, x0)
    sol_p, res_p = plain_wide(torch, ref, prob, Xref, None, x0)
    compare(torch, f"{label} vs plain", sol_k, sol_p, res_k[:4], res_p[:4])
    compare_rho(f"{label} vs plain", res_k[4], res_p[4],
                sol_k.iter == sol_p.iter)
    report(label, prob, Xref, None, x0, sol_k, launches)
    del sol_p, res_p

    # 37. bench_all.py:503-526's N=256 batch to convergence, adaptive,
    # compacted on both backends
    B, N = LH_CONV_B, LH_CONV_N
    phase(f"phase 37: adaptive compaction, N={N}, B={B}, max_iter "
          f"{LH_CONV_ITER}, chunk {COMPACT_CHUNK}, both backends")
    prob = adaptive_problem(tt, torch, 5.0, N, LH_CONV_ITER, 1, tables=t5)
    x0 = mixed_inputs(torch, B)
    out = {}
    for be in ("streamed", "resident"):
        out[be], phases = compact_drive(ctx, f"adaptive N={N} {be} "
                                        f"compaction", prob, x0,
                                        chunk=COMPACT_CHUNK, backend=be,
                                        entries={GROUP_ADAPT}
                                        if be == "resident" else set())
        if be == "streamed":
            took_route(ast, f"adaptive N={N} streamed compaction", prob)
    same_bits(torch, f"adaptive N={N} streamed compaction", out["streamed"],
              out["resident"], "the resident compaction")
    long = drive(f"adaptive N={N} long streamed", prob, None, None, x0)[0]
    t = {name: host_ms(torch, fn)[0] for name, fn in (
        ("long streamed", lambda: kern.solve_fused_streamed(
            prob, None, None, x0)),
        ("streamed compaction", lambda: kern.make_compact_solver(
            prob, chunk=COMPACT_CHUNK, backend="streamed")(x0)),
        ("resident compaction", lambda: kern.make_compact_solver(
            prob, chunk=COMPACT_CHUNK, backend="resident")(x0)))}
    sol_c = out["streamed"][0]
    log(f"  adaptive N={N}: {phases} phases; \"auto\" picks "
        f"{ctx.compact._backend(prob, 'auto')}; on the host clock "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; compacted: solved frac {sol_c.solved.float().mean():.5f}, "
        f"mean iters {sol_c.iter.float().mean():.4f}; one long streamed "
        f"solve: solved frac {long[0].solved.float().mean():.5f}, mean iters "
        f"{long[0].iter.float().mean():.4f} (each phase restarts the "
        f"adaptation clock, so the two differ); card {ctx.card}")
    return rows


def sass_counts(path):
    """FFMA and HMMA instructions in each function of a built library's
    SASS (cuobjdump -sass), by mangled name, as {"FFMA": n, "HMMA": m};
    None where cuobjdump cannot read it."""
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                             text=True, timeout=600, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {"FFMA": 0, "HMMA": 0}
        elif cur is not None:
            for op in ("FFMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[cur][op] += 1
    return counts


def dot_work(L, depth, lanes, reps, chained, bf16):
    """Operations and bytes of one dot probe: L products of depth^2 FMAs (2
    operations each) a lane and rep; the matrix read (M chained, Ms
    independent; 2 bytes an entry in bf16) and v read and out written
    once, float32."""
    mats = depth * depth * (1 if chained else L) * (2 if bf16 else 4)
    return 2.0 * L * depth * depth * lanes * reps, mats + 8 * depth * lanes


def elementwise_work(N, F, lanes, passes, reductions, reps):
    """Operations and bytes of one elementwise probe: per element and rep 3
    a pass (add, max, min) and 2 a reduction (abs, max), per lane and rep
    the max and the add into the sum; a (and b with passes) read once and
    out written once."""
    rows = N * F * lanes
    ops = float(reps) * (rows * (3 * passes + 2 * reductions) + 2 * lanes)
    return ops, 4 * rows * (2 if passes else 1) + 4 * lanes


def merge_buckets(af, B, parts):
    """Per-bucket outputs ``[(lanes, (Solution, residuals[, carry]))]``
    scattered into one batch-order output of the same form."""
    n = len(parts[0][1])
    return af.merge_lanes([(idx, (tuple(o) + (None,))[:3])
                           for idx, o in parts], B)[:n]


def roofline_phase(ctx):
    """Phase 38: the roofline probes of csrc/roofline.cu against their
    plain versions, small and at full size; tinympc_tpu_torch.roofline's
    three configs; the elementwise rate at L2 and at HBM size. Returns the
    kernels-line numbers of the three probes."""
    torch, rf, tool, card = ctx.torch, ctx.rf, ctx.tool, ctx.card
    phase("phase 38: roofline probes vs plain versions, then "
          "tools/roofline.py's configs")
    counts = sass_counts(ctx.build.library_path(rf.KERNEL))
    if counts is None:
        log("  SASS: cuobjdump could not read the probes' library; the "
            "reps scaling below stands for the check")
    else:
        for fn, n in sorted(counts.items()):
            # The CUDA-core dots: one product's depth^2 FFMA at least. The
            # tensor-core dots: one matrix's mma.sync tiles at least, a
            # warp's 32 lanes being 4 tiles of 8 and the padded depth
            # P = 16 ceil(depth / 16) (P / 16)^2 tiles of 16 x 16 each.
            m = re.search(r"dot_(chained|independent)_kernelILi(\d+)E(Lb([01]))?",
                          fn)
            t = re.search(r"dot_independent_mma_kernelILi(\d+)E", fn)
            if m:
                d = int(m[2])
                operand = "bf16" if m[4] == "1" else "f32"
                log(f"  SASS dot {m[1]} depth {d} {operand}: {n['FFMA']} "
                    f"FFMA (one product is {d * d})")
                fail(f"SASS dot {m[1]} {d}", n["FFMA"] >= d * d,
                     f"{n['FFMA']} FFMA, fewer than one product's {d * d}: "
                     "the loop was collapsed")
            elif t:
                d = int(t[1])
                need = (-(-d // 16)) ** 2 * 4
                log(f"  SASS dot independent depth {d} bf16 (tensor "
                    f"cores): {n['HMMA']} HMMA (one matrix is {need} "
                    f"m16n8k16 tiles a warp), {n['FFMA']} FFMA")
                fail(f"SASS dot independent mma {d}", n["HMMA"] >= need,
                     f"{n['HMMA']} HMMA, fewer than one matrix's {need}: "
                     "not on the tensor cores, or the loop was collapsed")

    def hold_dot(label, L, depth, lanes, chained, reps, operand):
        """The kernel against the plain version on inputs whose chain stays
        of order one (rf.held_dot_inputs; on the TPU probe's own, used for
        the timings, the chain leaves float32's normal range): bf16
        operands at rtol 8e-3 chained (a dot re-rounds its operand) and
        1e-5 independent; the float32 chain against the plain version in
        float64 at rtol 1e-5. No absolute floor. Returns the max abs
        difference."""
        M, Ms, v = rf.held_dot_inputs(L, depth, lanes, operand, device=DEVICE)
        k = rf.run_dot(M, Ms, v, chained, reps)
        if operand == "bf16":
            p = rf.dot_probe_reference(M, Ms, v, chained, reps).double()
            rtol = 8e-3 if chained else 1e-5
        else:
            p = rf.dot_probe_reference(M.double(), Ms.double(), v.double(),
                                       chained, reps)
            rtol = 1e-5
        torch.cuda.synchronize()
        d = (k.double() - p).abs()
        fail(f"dot {operand} {label} L={L} depth={depth} inputs",
             p.abs().min().item() > 0.1,
             f"the plain output fell to {p.abs().min().item():.3e}: the "
             "held inputs no longer keep the chain of order one")
        ok = bool(torch.isfinite(k).all()) and bool((d <= rtol * p.abs())
                                                    .all())
        rel = (d / p.abs()).max().item()
        log(f"  dot {operand} {label}: L={L} depth={depth} lanes={lanes} "
            f"reps={reps}: max rel diff {rel:.3e} (rtol {rtol}), max abs "
            f"diff {d.max().item():.3e}, |out| in [{p.abs().min().item():.4f}"
            f", {p.abs().max().item():.4f}]")
        fail(f"dot {operand} {label} L={L} depth={depth}", ok,
             f"kernel differs from plain version beyond rtol {rtol}")
        return d.max().item()

    def hold_elementwise(N, F, lanes, passes, reductions, reps):
        a, b = rf.elementwise_inputs(N, F, lanes, DEVICE)
        k = rf.run_elementwise(a, b, passes, reductions, reps)
        p = rf.elementwise_probe_reference(a, b, passes, reductions, reps)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        log(f"  elementwise N={N} F={F} lanes={lanes} passes={passes} "
            f"reductions={reductions} reps={reps}: bitwise {same}")
        fail(f"elementwise lanes={lanes} passes={passes}", same,
             "kernel not bitwise the plain version")

    for operand, depth, L in (("bf16", 36, 4), ("bf16", 96, 4),
                              ("f32", 12, 38), ("f32", 32, 38)):
        for chained in (True, False):
            hold_dot("chained" if chained else "independent", L, depth, 1000,
                     chained, 2, operand)
    for passes, reductions in ((8, 4), (8, 0), (0, 4)):
        hold_elementwise(20, 16, 1000, passes, reductions, 2)
    # Full size: the shapes of the tool's configs, one rep. The kernels
    # line reports the bf16 errors at the first config's (the quadrotor's).
    full_err = {}
    for nx, nu, N, lanes in sorted({c[2:6] for c in tool.CONFIGS}):
        for operand, depth, L in (("bf16", 3 * nx, 5 * (N - 1)),
                                  ("f32", nx, tool.chain_length(N))):
            for chained in (True, False):
                full_err[(nx, N, lanes, operand, chained)] = hold_dot(
                    ("chained" if chained else "independent") + " full", L,
                    depth, lanes, chained, 1, operand)
        hold_elementwise(N, nx + nu, lanes, 8, 4, 1)

    zero_counts(ctx.counters)
    lines = []
    for label, name, nx, nu, N, B, ct in tool.CONFIGS:
        sysd = ctx.tt.systems.synthetic(nx, nu) if name == "synthetic" \
            else getattr(ctx.tt.systems, name)()
        lines.append(tool.run_config(label, sysd, nx, nu, N, B, ct,
                                     tool.card_info(), device=DEVICE))
    torch.cuda.synchronize()
    launches = dict(rf.launch_counts)
    log(f"  probe launches in the tool's run: {launches}")
    for key in launches:
        if launches[key] < 1:
            raise AssertionError(f"the roofline tool did not launch the "
                                 f"{key} kernel")
    for line in lines:
        log(f"  {line['config']}: chained/independent bf16 "
            f"{line['chain_vs_pipeline']}, f32 {line['f32_chain_vs_pipeline']}"
            f"; {line['ns_per_chained_matvec']} ns per chained f32 matvec "
            f"x {line['f32_chain_matvecs_per_iter']} = predicted iteration "
            f"{line['predicted_iter_us']} us against measured "
            f"{line['measured_iter_us']} us (the main path's, ct 25 with its "
            f"tolerances: {ctx.main_iter_us:.4f} us); SM clock after the "
            f"probes {line['sm_clock_after_probes']}, after the solve "
            f"{line['sm_clock_after_solve']}; card {card}")
    # The elementwise stream at L2 size (4096 lanes, 10.5 MB) and HBM size
    # (32768 lanes, 84 MB): 8 passes, a and b read once a rep.
    for lanes in STREAM_LANES:
        a, b = rf.elementwise_inputs(20, 16, lanes, DEVICE)
        t = tool.cuda_ms(lambda: rf.run_elementwise(a, b, 8, 0, tool.REPS)) \
            / tool.REPS
        nbytes = 8 * 20 * 16 * lanes
        log(f"  elementwise stream, {lanes} lanes ({nbytes / 1e6:.2f} MB a "
            f"rep): {t:.6f} ms a rep, {nbytes / (t * 1e-3) / 1e12:.4f} TB/s "
            f"against the card's 3.35 TB/s; card {card}")
    # reps scaling: a rep loop the compiler folded would not scale.
    _, _, nx, nu, N, lanes, _ = tool.CONFIGS[0]
    M, Ms, v = rf.dot_inputs(5 * (N - 1), 3 * nx, lanes, "bf16", DEVICE)
    t1 = tool.cuda_ms(lambda: rf.run_dot(M, Ms, v, True, 1))
    t20 = tool.cuda_ms(lambda: rf.run_dot(M, Ms, v, True, tool.REPS))
    log(f"  chained dots, reps {tool.REPS} against 1: {t20 / t1:.3f}x")
    fail("dot reps scaling", t20 / t1 > tool.REPS / 2,
         f"reps {tool.REPS} took {t20 / t1:.3f}x reps 1: a rep was folded")

    # Kernels-line rows: one rep at the quadrotor's shapes, timed on the
    # TPU probe's inputs; the error is the full-size hold's above.
    rows = {}
    for key, chained in (("dot_chained", True), ("dot_independent", False)):
        L, depth = 5 * (N - 1), 3 * nx
        M, Ms, v = rf.dot_inputs(L, depth, lanes, "bf16", DEVICE)
        ms = tool.cuda_ms(lambda: rf.run_dot(M, Ms, v, chained, 1), REPS)
        k = rf.run_dot(M, Ms, v, chained, 1)
        plain_ms, _ = host_ms(torch, lambda: rf.dot_probe_reference(
            M, Ms, v, chained, 1))
        err = full_err[(nx, N, lanes, "bf16", chained)]
        ops, nbytes = dot_work(L, depth, lanes, 1, chained, True)
        bound_ms, bound_by = bound(ops, nbytes, ctx.peak_bf16, ctx.peak_bw)
        lib_ms = None
        if not chained:
            # One call computes the sum of the L products: the matrices
            # side by side times the operand stacked L times (the operands'
            # layout made outside the timing), in float32 on bf16 values.
            mcat = Ms.float().permute(1, 0, 2).reshape(depth, L * depth)
            ystack = v.to(torch.bfloat16).float().repeat(L, 1)
            lib_ms = tool.cuda_ms(lambda: torch.matmul(mcat, ystack), REPS)
            lib = torch.matmul(mcat, ystack)
            log(f"  library torch.matmul (depth x L*depth) @ (L*depth x "
                f"lanes), float32 operands holding bf16 values, float32 "
                f"out: {lib_ms:.4f} ms, max rel diff from the kernel "
                f"{((lib - k).abs() / k.abs()).max().item():.3e}")
            # The same product on bf16 operands (cuBLAS on the tensor
            # cores, float32 accumulation, bf16 out): a second yardstick,
            # logged beside the first, not the kernels line's.
            mb, yb = mcat.to(torch.bfloat16), ystack.to(torch.bfloat16)
            lib_bf16_ms = tool.cuda_ms(lambda: torch.matmul(mb, yb), REPS)
            lib_b = torch.matmul(mb, yb)
            log(f"  library torch.matmul on bf16 operands, {lib_b.dtype} "
                f"out: {lib_bf16_ms:.4f} ms, max rel diff from the kernel "
                f"{((lib_b.float() - k).abs() / k.abs()).max().item():.3e}")
            del mcat, ystack, lib, mb, yb, lib_b
        log(f"  {key} (bf16, L={L}, depth {depth}, {lanes} lanes, one rep): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP at the "
            f"bf16 tensor-core peak, {nbytes / 1e6:.2f} MB), library "
            f"{lib_ms}, launches {launches[key]}; card {card}")
        rows[key] = dict(launches=launches[key], err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
    a, b = rf.elementwise_inputs(N, nx + nu, lanes, DEVICE)
    ms = tool.cuda_ms(lambda: rf.run_elementwise(a, b, 8, 4, 1), REPS)
    k = rf.run_elementwise(a, b, 8, 4, 1)
    plain_ms, p = host_ms(torch, lambda: rf.elementwise_probe_reference(
        a, b, 8, 4, 1))
    ops, nbytes = elementwise_work(N, nx + nu, lanes, 8, 4, 1)
    bound_ms, bound_by = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
    log(f"  elementwise (N={N}, F={nx + nu}, {lanes} lanes, 8 passes, 4 "
        f"reductions, one rep): kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), no single library call (clip of a "
        f"sum is two calls), launches {launches['elementwise']}; card {card}")
    rows["elementwise"] = dict(
        launches=launches["elementwise"], err=(k - p).abs().max().item(),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)
    return rows


def fleet_problems(ctx, scales, device=None):
    """Quadrotor variants at 20 Hz, A off the diagonal scaled by each of
    ``scales`` (bench_all.py:281-284), N=FLEET_N, box +-5 / +-0.5,
    max_iter 100, ct 25."""
    tt, torch = ctx.tt, ctx.torch
    s = tt.systems.quadrotor_20hz()
    out = []
    for scale in scales:
        A = s["A"] * np.where(np.eye(12) == 1, 1.0, scale)
        p = tt.setup(A, s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                     N=FLEET_N, dtype=torch.float32, device=device or DEVICE)
        p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
        out.append(tt.with_settings(p, max_iter=100, check_termination=25))
    return out


def fleet_launch(af, tables, x0, bk, carry, params):
    """One multi-system launch on inputs already in the padded layout
    (timing only; not counted)."""
    return lambda: af._launch(
        tables.reshape(-1), x0, FLEET_N, 12, 4, params["fam"], None, None,
        carry, params["max_iter"], params["ct"], params["rho"],
        params["tol_pri"], params["tol_dua"], block_sys=bk.block_sys)


def bucket_launches(af, probs, idxs, x, Xref, carry=None):
    """The per-bucket launches of the same fleet on gathered lanes (timing
    only; not counted)."""
    runs = []
    for p, idx in zip(probs, idxs):
        tables, x0, params = af._prepare(p, Xref, None, x[idx])
        c = None if carry is None else af._take_lanes(carry, idx)
        runs.append((tables, x0, c, params))
    return lambda: [af._launch(t, x0, FLEET_N, 12, 4, pr["fam"], None, None,
                               c, pr["max_iter"], pr["ct"], pr["rho"],
                               pr["tol_pri"], pr["tol_dua"])
                    for t, x0, c, pr in runs]


def cold_fleet_phase(ctx):
    """Phase 39: bench_all.py:273-300's fleet of 16 quadrotor variants in
    one multi-system launch: bitwise the per-bucket solve_fused launches,
    at the bar against the plain version, a small ragged fleet, and the
    one launch timed beside the 16 and beside one single-system launch of
    the same width. Returns the kernels-line numbers."""
    torch, tt, af, card = ctx.torch, ctx.tt, ctx.admm_fused, ctx.card
    B = FLEET_SYS * FLEET_PER
    phase(f"phase 39: cold fleet, {FLEET_SYS} systems x {FLEET_PER} "
          f"(B={B}), N={FLEET_N}, max_iter 100, ct 25")
    kw = dict(dtype=torch.float32, device=DEVICE)

    def drive(label, probs, assign, x0):
        """The fleet through make_fleet_solver with the counts at 0, held
        bitwise against per-bucket solve_fused and at the bar against the
        plain version. Returns the numbers of the run."""
        n, Bn = len(probs), x0.shape[0]
        solver = tt.make_fleet_solver(probs)
        zero_counts(ctx.counters)
        call_ms, out = host_ms(torch, lambda: solver(assign, x0))
        launches = af.multi_launch_count
        if launches < 1:
            raise AssertionError(f"{label} did not launch the multi-system "
                                 "kernel")
        took_group(af, label, launches)
        if out[0].x.shape != (FLEET_N, Bn, 12) or \
                out[0].u.shape != (FLEET_N - 1, Bn, 4):
            raise AssertionError(f"bad fleet output shapes {out[0].x.shape} "
                                 f"{out[0].u.shape}")
        idxs = [torch.as_tensor(np.flatnonzero(assign == s), device=DEVICE)
                for s in range(n)]
        parts = [(idx, tt.kernels.solve_fused(p, None, None, x0[idx]))
                 for p, idx in zip(probs, idxs) if idx.numel()]
        torch.cuda.synchronize()
        same_bits(torch, label, out, merge_buckets(af, Bn, parts),
                  "per-bucket solve_fused launches")
        tables = af.system_tables(probs)
        x0c, params = af._x0_params(probs[0], x0)
        bk = af.buckets(assign, n, DEVICE)
        plain_ms, (sol_p, res_p) = host_ms(torch, lambda: af.solve_systems(
            tables, x0c, bk, FLEET_N, 12, 4, plain=True, **params)[:2])
        # The bar, the values held on the lanes whose counts agree (a lane
        # that crosses the tolerance one check earlier ends elsewhere).
        err = compare(torch, f"{label} vs plain", out[0], sol_p, out[1],
                      res_p, lanes="same_iters")
        return dict(out=out, launches=launches, err=err, plain_ms=plain_ms,
                    call_ms=call_ms, tables=tables, x0c=x0c, params=params,
                    bk=bk, idxs=idxs)

    # The small ragged fleet: 4 systems, random assignments, B=1000.
    rng = np.random.default_rng(1)
    small = fleet_problems(ctx, [1 + 0.002 * (i - 8) for i in range(4)])
    drive("ragged fleet 4 systems B=1000", small, rng.integers(0, 4, 1000),
          torch.as_tensor(rng.uniform(-0.5, 0.5, (1000, 12)), **kw))

    probs = fleet_problems(ctx, [1 + 0.002 * (i - FLEET_SYS // 2)
                                 for i in range(FLEET_SYS)])
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5,
                                                         (B, 12)), **kw)
    assign = np.repeat(np.arange(FLEET_SYS), FLEET_PER)
    r = drive(f"fleet {FLEET_SYS} x {FLEET_PER}", probs, assign, x0)
    bk, params = r["bk"], r["params"]
    multi = fleet_launch(af, r["tables"], r["x0c"].index_select(0, bk.gather),
                         bk, None, params)
    ms, times = cuda_ms(torch, multi, REPS)
    buckets_ms = cuda_ms(torch, bucket_launches(af, probs, r["idxs"], x0,
                                                None), REPS)[0]
    tables0, x00, p0 = af._prepare(probs[0], None, None, x0)
    single_ms = cuda_ms(torch, lambda: af._launch(
        tables0, x00, FLEET_N, 12, 4, p0["fam"], None, None, None,
        p0["max_iter"], p0["ct"], p0["rho"], p0["tol_pri"], p0["tol_dua"]),
        REPS)[0]
    # A tick of a built solver whose assignment pattern is known: the
    # tables were packed and the indices built by its first call.
    solver = tt.make_fleet_solver(probs)
    solver(assign, x0)
    call_ms = statistics.median(host_ms(torch, lambda: solver(assign, x0))[0]
                                for _ in range(REPS))
    sol = r["out"][0]
    iter_sum = int(sol.iter.sum().item())
    ops, nbytes = fused_work(FLEET_N, 12, 4, B, iter_sum)
    nbytes += 4 * r["tables"].numel()
    bound_ms, bound_by = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
    log(f"  one multi-system launch {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), {FLEET_SYS} per-bucket launches "
        f"{buckets_ms:.4f} ms, one single-system launch of {B} lanes "
        f"{single_ms:.4f} ms; {B / (ms / 1e3):.1f} solves/s; a tick of "
        f"the built solver {call_ms:.4f} ms on the host clock (its first "
        f"call, indices built: {r['call_ms']:.4f} ms); mean iters "
        f"{iter_sum / B:.4f}, "
        f"solved frac {sol.solved.float().mean().item():.5f}; bound "
        f"{bound_ms:.4f} ms ({bound_by}); plain {r['plain_ms']:.1f} ms; "
        f"launches {r['launches']}; card {card}")
    return dict(launches=r["launches"], err=r["err"], ms=ms,
                plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by)


def warm_fleet_phase(ctx):
    """Phase 40: examples/serving_fleet.py:100-113's 4 variants as a warm
    fleet with random assignments, B=WARM_FLEET_B, 5 external-plant solves
    (each plant stepped with its own system): the one launch bitwise the
    per-bucket solve_fused_warm launches at every step and at the bar
    against the plain version; the sixth solve timed beside the per-bucket
    launches. Returns the kernels-line numbers."""
    torch, tt, af, card = ctx.torch, ctx.tt, ctx.admm_fused, ctx.card
    B, n = WARM_FLEET_B, WARM_FLEET_SYS
    phase(f"phase 40: warm fleet, {n} systems, B={B}, 5 external-plant "
          f"solves, ct 25")
    probs = fleet_problems(ctx, [1 + 0.004 * (i - n // 2) for i in range(n)])
    rng = np.random.default_rng(0)
    hover = torch.as_tensor(HOVER, dtype=torch.float32, device=DEVICE)
    Xref = hover.expand(FLEET_N, 12).contiguous()
    x = hover + torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 12)),
                                dtype=torch.float32, device=DEVICE)
    assign = rng.integers(0, n, B)
    idxs = [torch.as_tensor(np.flatnonzero(assign == s), device=DEVICE)
            for s in range(n)]

    def plant(x, u0):
        out = torch.empty_like(x)
        for p, idx in zip(probs, idxs):
            out[idx] = x[idx] @ p.A.T + u0[idx] @ p.B.T + p.f
        return out

    solve = tt.make_fleet_solver(probs, warm=True)
    carry = tt.init_carry(probs[0], B)
    zero_counts(ctx.counters)
    states, outs = [], []
    for _ in range(5):
        out = solve(assign, x, carry, Xref)
        states.append(x)
        outs.append(out)
        carry = out[2]
        x = plant(x, out[0].u[0])
    torch.cuda.synchronize()
    launches = af.multi_warm_launch_count
    if launches < 5:
        raise AssertionError("the warm fleet did not launch the warm "
                             "multi-system kernel")
    took_group(af, "warm fleet", launches)
    carries = [tt.init_carry(p, idx.numel()) for p, idx in zip(probs, idxs)]
    tables = af.system_tables(probs, Xref)
    bk = af.buckets(assign, n, DEVICE)
    c_p = af._carry_tensors(probs[0], tt.init_carry(probs[0], B), B)
    agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
    err = 0.0
    for step, (x_s, out) in enumerate(zip(states, outs)):
        parts = []
        for s, (p, idx) in enumerate(zip(probs, idxs)):
            w = tt.kernels.solve_fused_warm(p, Xref, None, x_s[idx],
                                            carries[s])
            carries[s] = w[2]
            parts.append((idx, w))
        torch.cuda.synchronize()
        same_bits(torch, f"warm fleet step {step}", out,
                  merge_buckets(af, B, parts),
                  "per-bucket solve_fused_warm launches")
        x0c, params = af._x0_params(probs[0], x_s)
        plain_ms, (sol_p, res_p, c_p) = host_ms(torch, lambda: af.solve_systems(
            tables, x0c, bk, FLEET_N, 12, 4, c_p, plain=True, **params))
        agreed &= out[0].iter == sol_p.iter
        err = max(err, compare(torch, f"warm fleet step {step} vs plain",
                               out[0], sol_p, lanes=agreed,
                               solved_tol=2 / B))
        log(f"  step {step}: mean iters "
            f"{out[0].iter.float().mean().item():.4f}, solved frac "
            f"{out[0].solved.float().mean().item():.5f}")
    compare_carry(torch, "warm fleet after 5 steps", carry, c_p, agreed)
    x0c, params = af._x0_params(probs[0], x)
    carry_t = af._carry_tensors(probs[0], carry, B)
    multi = fleet_launch(af, tables, x0c.index_select(0, bk.gather), bk,
                         af._take_lanes(carry_t, bk.gather), params)
    sol_w = multi()[0]
    ms, times = cuda_ms(torch, multi, REPS)
    buckets_ms = cuda_ms(torch, bucket_launches(af, probs, idxs, x, Xref,
                                                carry_t), REPS)[0]
    # The bound counts the fleet's B lanes, not the padding's copies.
    iter_sum = int(sol_w.iter.index_select(0, bk.real).sum().item())
    ops, nbytes = fused_work(FLEET_N, 12, 4, B, iter_sum,
                             lane_carry_floats(carry))
    nbytes += 4 * tables.numel()
    bound_ms, bound_by = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
    log(f"  the sixth solve: one warm multi-system launch {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}; {sol_w.iter.shape[0]} padded "
        f"lanes for {B}), {n} per-bucket warm launches {buckets_ms:.4f} ms; "
        f"mean iters {iter_sum / B:.4f}; bound {bound_ms:.4f} "
        f"ms ({bound_by}); plain {plain_ms:.1f} ms; launches {launches}; "
        f"card {card}")
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


@contextlib.contextmanager
def pinned(module, name, geometry):
    """``module.<name>`` (a geometry function) returns ``geometry`` while
    the block runs: a launch at a place and block of the check's choosing."""
    keep = getattr(module, name)
    setattr(module, name, lambda *a, **k: geometry)
    try:
        yield
    finally:
        setattr(module, name, keep)


def every_family_problem(tt, torch, N, max_iter, ct):
    """Every family on both sides of the 50 Hz quadrotor (12, 4), with its
    box: two state cones and an input cone, the static z ceiling and
    thrust-sum plane, two time-varying state planes and one input plane
    (chip_compare.py's ``_mixed``)."""
    s = tt.systems.quadrotor_50hz()
    p = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"], N=N,
                 dtype=torch.float32, device=DEVICE)
    Ax = np.zeros((1, 12))
    Ax[0, 2] = 1.0
    p = tt.with_linear_constraints(p, Ax, [1.24], np.ones((1, 4)), [6.0])
    Ax = np.zeros((N, 2, 12))
    Ax[:, 0, 2] = 1.0
    Ax[:, 1, :2] = 0.5
    Au = np.ones((N - 1, 1, 4))
    Au[:, 0, 3] = 2.0
    p = tt.with_tv_linear_constraints(
        p, Ax, np.stack([1.07 + 0.02 * np.arange(N), np.full(N, -1.5)], 1),
        Au, np.full((N - 1, 1), 6.0))
    p = tt.with_cones(p, state_cones=[(3, 3, 0.5), (6, 4, 2.0)],
                      input_cones=[(0, 2, 0.3)])
    p = tt.with_bounds(p, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=3.0)
    return tt.with_settings(p, max_iter=max_iter, check_termination=ct,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)


def every_family_inputs(torch, B, N):
    """x0 = [-2, -2, 1, 0...] + 0.1 U[-1, 1]^12 (default_rng(0)); Xref the
    demo's window toward the goal over N steps."""
    start, goal = np.asarray(QUAD_START), np.asarray(QUAD_GOAL)
    x0 = start + 0.1 * np.random.default_rng(0).uniform(-1, 1, (B, 12))
    alpha = np.minimum(np.arange(N)[:, None] / 49.0, 1.0)
    kw = dict(dtype=torch.float32, device=DEVICE)
    return (torch.as_tensor(x0, **kw),
            torch.as_tensor((1 - alpha) * start + alpha * goal, **kw))


# The last horizon at which the every-family problem (three families on
# each side at (12, 4)) runs on the thread-group kernel: one problem's
# family columns fill a block's shared memory past it
# (admm_fused.group_route).
FAMILY_CUTOFF = 440


def group_places_phase(ctx):
    """Phase 41: every place of the group kernels (csrc/admm_group.cuh
    Place) and smaller blocks, bitwise the place the wrappers choose, at
    the horizons of the main path's neighbourhood; then the long horizons
    that choose the other places, at the bar against the plain version.
    Each launch is held to the place it was meant to take. Then the same
    for the families kinds (the rocket's cones at (6, 3) and every family
    at (12, 4), cold and warm), and their horizon cutoff: the last horizon
    on the group kernel and the next on csrc/admm_fused.cu."""
    torch, tt, af = ctx.torch, ctx.tt, ctx.admm_fused
    from tinympc_tpu_torch.kernels import closed_loop_kernel as clk
    phase("phase 41: the group kernels' places, pinned at N=64 and N=10, "
          "then long horizons")
    places = {af.PLACE_SHARED: "shared", af.PLACE_TABLE_GLOBAL: "table "
              "global", af.PLACE_SAVED_GLOBAL: "saved global"}

    def launches_at(geom, run):
        """``run()`` with its launch pinned to ``geom`` = (P, place, smem)
        and the counts at 0; one group entry launch (or one closed-loop
        launch) expected."""
        zero_counts(ctx.counters)
        with pinned(af, "group_geometry", geom), \
                pinned(clk, "loop_geometry", geom):
            out = run()
        torch.cuda.synchronize()
        n = af.entry_counts["tinympc_admm_group"] + clk.launch_count \
            + af.entry_counts[GROUP_FAM]
        fail("pinned launch", n >= 1, f"no group launch at {geom}")
        return out

    N = 64
    prob = problem(tt, torch, 100, 5, N=N)
    x0, Xref = inputs(torch, 1000, N=N, spread=0.3)
    cold = lambda: tt.kernels.solve_fused(prob, Xref, None, x0)

    def warm():
        c, outs = tt.init_carry(prob, 1000), []
        for _ in range(2):
            out = tt.kernels.solve_fused_warm(prob, Xref, None, x0, c)
            outs.append(out)
            c = out[2]
        return outs

    for save, run, kind in ((False, cold, "cold"), (True, warm, "warm")):
        base = af.group_geometry(N, save)
        want = run()
        log(f"  box {kind} N={N}: the wrappers launch P={base[0]} at "
            f"{places[base[1]]}")
        table = af._table_floats(12, 4, N)
        for place in places:
            if place == af.PLACE_SAVED_GLOBAL and not save:
                continue
            for P in (base[0], 1):
                geom = (P, place, af.group_smem(N, P, place, save, table))
                got = launches_at(geom, run)
                for k, (g, w) in enumerate(zip(
                        got if save else [got], want if save else [want])):
                    same_bits(torch, f"box {kind} N={N} P={P} "
                              f"{places[place]} solve {k}", g, w,
                              "the wrappers' launch")
    # The closed loop at the serving horizon: its options at every place.
    N, T = SERVE_N, 20
    prob = problem(tt, torch, 100, 5, N=N)
    x0, Xref = inputs(torch, 1000, N=N, spread=0.3)
    table = clk._table_floats(N, T)
    for opts in (dict(), dict(shift_warm=True), dict(reset_duals=True)):
        run = lambda: tt.kernels.closed_loop_fused(prob, Xref, x0, T, **opts)
        want = run()
        for place in places:
            P = 2
            geom = (P, place, af.group_smem(N, P, place, True, table))
            got = launches_at(geom, run)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            log(f"  closed loop N={N} T={T} {opts} P={P} {places[place]}: "
                f"bitwise the wrappers' launch: {same}")
            fail(f"closed loop {opts} {places[place]}", same,
                 "not bitwise equal to the wrappers' launch")
    # Long horizons through the entry points, each on the place it chooses.
    B = 64
    for N, kind, T in ((700, "cold", None), (1100, "warm", None),
                       (1150, "warm", None), (700, "loop", 2),
                       (1150, "loop", 2)):
        prob = problem(tt, torch, 12, 3, N=N)
        x0, Xref = inputs(torch, B, N=N, spread=0.3)
        geom = clk.loop_geometry(N, T) if kind == "loop" else \
            af.group_geometry(N, kind == "warm")
        label = f"{kind} N={N} ({places[geom[1]]}, P={geom[0]})"
        zero_counts(ctx.counters)
        if kind == "cold":
            sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
            sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref, None,
                                                            x0)
            took_group(af, label, 1)
            compare(torch, label, sol_k, sol_p, res_k, res_p)
        elif kind == "warm":
            c_k = c_p = tt.init_carry(prob, B)
            agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
            for step in range(2):
                sol_k, res_k, c_k = tt.kernels.solve_fused_warm(
                    prob, Xref, None, x0, c_k)
                sol_p, res_p, c_p = tt.kernels.solve_fused_warm_reference(
                    prob, Xref, None, x0, c_p)
                agreed &= sol_k.iter == sol_p.iter
                compare(torch, f"{label} step {step}", sol_k, sol_p,
                        lanes=agreed)
                compare_carry(torch, f"{label} step {step}", c_k, c_p,
                              agreed)
            took_group(af, label, 2)
        else:
            out_k = tt.kernels.closed_loop_fused(prob, Xref, x0, T,
                                                 shift_warm=True)
            out_p = tt.kernels.closed_loop_fused_reference(
                prob, Xref, x0, T, shift_warm=True)
            fail(label, clk.launch_count == 1, "no closed-loop launch")
            compare_loop(torch, label, out_k, out_p)
    group_families_places(ctx, launches_at, places)


def group_families_places(ctx, launches_at, places, B=1000):
    """Phase 41's families: the rocket's cones at (6, 3) and every family
    at (12, 4), cold and two warm solves at every place and P (the
    wrappers' and 1), bitwise the wrappers' launch (``launches_at`` pins
    one); then the every-family problem's cutoff by the library's own
    counts (FAMILY_CUTOFF), a solve there on the group kernel bitwise the
    one-thread kernel's, and one a step past it on csrc/admm_fused.cu,
    each held against the plain versions, cold and warm, at the bars of
    their own spread."""
    torch, tt, af = ctx.torch, ctx.tt, ctx.admm_fused
    x_r, X_r, U_r = rocket_inputs(torch, B)
    x_m, X_m = every_family_inputs(torch, B, FAM_N)
    for name, prob, x0, Xref, Uref in (
            ("rocket SOC", rocket_problem(tt, torch, 100, 1), x_r, X_r, U_r),
            ("every family", every_family_problem(tt, torch, FAM_N, 100,
                                                  1), x_m, X_m, None)):
        spec = prob.spec
        fam = af._families(spec)

        def run(warm, prob=prob, x0=x0, Xref=Xref, Uref=Uref):
            if not warm:
                return [tt.kernels.solve_fused(prob, Xref, Uref, x0)]
            c, outs = tt.init_carry(prob, B), []
            for _ in range(2):
                out = tt.kernels.solve_fused_warm(prob, Xref, Uref, x0, c)
                outs.append(out)
                c = out[2]
            return outs

        table = af._group_table(spec.N, spec.nx, spec.nu, "families", fam)
        for save in (False, True):
            zero_entries(af)
            want = run(save)
            took_entries(af, f"{name} {'warm' if save else 'cold'}",
                         {GROUP_FAM: len(want)})
            base = af.group_geometry(spec.N, save, None, spec.nx, spec.nu,
                                     "families", fam=fam)
            log(f"  {name} {'warm' if save else 'cold'}: the wrappers "
                f"launch P={base[0]} at {places[base[1]]}")
            for place in places:
                if place == af.PLACE_SAVED_GLOBAL and not save:
                    continue
                for P in (base[0], 1):
                    geom = (P, place, af.group_smem(
                        spec.N, P, place, save, table, spec.nx, spec.nu,
                        "families", fam))
                    got = launches_at(geom, lambda: run(save))
                    for k, (g, w) in enumerate(zip(got, want)):
                        same_bits(torch, f"{name} {'warm' if save else 'cold'}"
                                  f" P={P} {places[place]} solve {k}", g, w,
                                  "the wrappers' launch")
    # The cutoff of the every-family problem, by the library's own counts.
    fam = af._families(every_family_problem(tt, torch, 12, 1, 1).spec)
    probe = af._group_probe("families", True, fam, 12, 4)
    cut = next(N for N in range(2, 2000) if af.group_route(
        N + 1, 12, 4, fam, None, None, True, *probe) is None)
    fail("families cutoff", cut == FAMILY_CUTOFF, f"the group kernel takes "
         f"the every-family problem to N={cut}, expected {FAMILY_CUTOFF}")
    # On both sides of the cutoff, cold and warm, the solves are held
    # against the plain versions on the card and on the CPU, at the bars
    # of the plain version's own spread between the two: the every-family
    # problem does not converge, and a 1-ulp change of x0 moves the plain
    # version's own 12-iteration solution by ~1e-2. At the cutoff the
    # group kernel's solve is also bitwise the one-thread kernel's (taken
    # by giving the route rule no group launch); a step past it the
    # wrappers take the one-thread kernel themselves.
    B = 64
    everyone = torch.ones(B, dtype=torch.bool)
    for N, entry in ((cut, GROUP_FAM), (cut + 1, FUSED)):
        prob = every_family_problem(tt, torch, N, 12, 3)
        prob_c = ctx.convert.problem_from_numpy(
            ctx.convert.problem_to_numpy(prob), "cpu")
        x0, Xref = every_family_inputs(torch, B, N)
        label = f"every family N={N}"
        run = lambda: [tt.kernels.solve_fused(prob, Xref, None, x0),
                       tt.kernels.solve_fused_warm(prob, Xref, None, x0,
                                                   tt.init_carry(prob, B))]
        zero_entries(af)
        got = run()
        took_entries(af, label, {entry: 2})
        plain = [tt.kernels.solve_fused_reference(prob, Xref, None, x0),
                 tt.kernels.solve_fused_warm_reference(
                     prob, Xref, None, x0, tt.init_carry(prob, B))]
        cpu = [tt.kernels.solve_fused_reference(prob_c, Xref.cpu(), None,
                                                x0.cpu()),
               tt.kernels.solve_fused_warm_reference(
                   prob_c, Xref.cpu(), None, x0.cpu(),
                   tt.init_carry(prob_c, B))]
        for k, kind in enumerate(("cold", "warm")):
            name = f"{label} {kind}"
            c_p, c_c = (plain[k][2], cpu[k][2]) if k else (None, None)
            share, solved_tol, atol = spread_bars(name, *plain_spread(
                torch, plain[k][0], cpu[k][0], everyone, c_p, c_c)[:3], B)
            sol_k = on_cpu(got[k][0])
            for other, sol_o, c_o in (
                    ("plain(cpu)", cpu[k][0], c_c),
                    ("plain(gpu)", on_cpu(plain[k][0]),
                     None if c_p is None else on_cpu(c_p))):
                agreed = sol_k.iter == sol_o.iter
                compare(torch, f"{name} vs {other}", sol_k, sol_o,
                        atol=atol, lanes=agreed, solved_tol=solved_tol,
                        share=share)
                if k:
                    compare_carry(torch, f"{name} vs {other}",
                                  on_cpu(got[k][2]), c_o, agreed, atol=atol)
        if entry == GROUP_FAM:
            with pinned(af, "group_route", None):
                want = run()
            for k, (g, w) in enumerate(zip(got, want)):
                same_bits(torch, f"{label} {('cold', 'warm')[k]}", g, w,
                          "the one-thread kernel's")
        log(f"  {label}: on {entry}, mean iters "
            f"{got[0][0].iter.float().mean().item():.4f}")


def zero_counts(kernels):
    """Set every launch count to 0: a module's counter, or each entry of
    a module's dict of counters."""
    for mod, attr in kernels:
        counts = getattr(mod, attr)
        if isinstance(counts, dict):
            counts.update(dict.fromkeys(counts, 0))
        else:
            setattr(mod, attr, 0)


def took_entries(admm_fused, label, want):
    """Fail the run unless the resident launches since the counts were
    last zeroed took exactly the C entries of ``want`` (a dict of entry
    and launches; a set of entries, each launched at least once); every
    other entry launched no time."""
    got = {k: v for k, v in admm_fused.entry_counts.items() if v}
    ok = got == want if isinstance(want, dict) else set(got) == set(want)
    fail(f"{label} entry", ok, f"launches by entry {got}, expected "
         f"{want if isinstance(want, dict) else sorted(want)}")
    log(f"  {label}: launches by entry {got}")


def zero_entries(admm_fused):
    admm_fused.entry_counts.update(dict.fromkeys(admm_fused.entry_counts, 0))


GROUP_CONS = "tinympc_admm_group_consensus"
GROUP_ADAPT = "tinympc_admm_group_adaptive"
GROUP_FAM = "tinympc_admm_group_families"
FUSED = "tinympc_admm_fused"


def took_group(admm_fused, label, launches):
    """Fail the run unless the box-only fixed-rho launches since the counts
    were last zeroed took the thread-group kernel's entry
    (tinympc_admm_group, csrc/admm_group.cu), ``launches`` of them, and no
    launch took the one-thread-a-problem entries."""
    e = admm_fused.entry_counts
    fail(f"{label} entry", e["tinympc_admm_group"] == launches
         and e["tinympc_admm_fused"] == 0
         and e["tinympc_admm_fused_multi"] == 0,
         f"launches by entry {e}, {launches} expected on tinympc_admm_group")
    log(f"  {label}: launches by entry {e}")


def cartpole_problem(tt, torch, max_iter, ct, N=CART_N, A=None,
                     device=None):
    """bench_all.py:128-131's cartpole (nx=4, nu=1): N=10, box +-5 on x and
    +-0.5 on u, through the user's entry points; ``A`` replaces the
    system's (a fleet's variant)."""
    s = tt.systems.cartpole()
    prob = tt.setup(s["A"] if A is None else A, s["B"], s["Qdiag"],
                    s["Rdiag"], rho=s["rho"], N=N, f=s["f"],
                    dtype=torch.float32, device=device or DEVICE)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5,
                          u_max=0.5)
    return tt.with_settings(prob, max_iter=max_iter, check_termination=ct)


def cartpole_inputs(torch, B, N=CART_N):
    """x0 ~ U[-0.5, 0.5]^4 from default_rng(0) and Xref[:, 2] = 1
    (bench_all.py:132-133)."""
    x0 = np.random.default_rng(0).uniform(-0.5, 0.5, (B, 4))
    Xref = np.zeros((N, 4))
    Xref[:, 2] = 1.0
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def degenerate_problem(tt, torch, nx, nu, N, ct):
    """tests/test_degenerate_dims.py:29-41's random stable system (seed
    nx * 100 + nu, its fused test's; A at spectral radius 0.9), box x in
    [-3, 3] and u in [-2, 2], rho 1, max_iter 50."""
    rng = np.random.default_rng(nx * 100 + nu)
    A = rng.uniform(-1.0, 1.0, (nx, nx))
    A *= 0.9 / max(np.abs(np.linalg.eigvals(A)).max(), 1e-9)
    B = rng.uniform(-1.0, 1.0, (nx, nu))
    Q, R = rng.uniform(1.0, 5.0, nx), rng.uniform(0.1, 1.0, nu)
    prob = tt.setup(A, B, Q, R, rho=1.0, N=N, dtype=torch.float32,
                    device=DEVICE)
    prob = tt.with_bounds(prob, x_min=-3.0, x_max=3.0, u_min=-2.0,
                          u_max=2.0)
    return tt.with_settings(prob, max_iter=50, check_termination=ct)


def degenerate_inputs(torch, B, nx, N):
    """x0 ~ U[-0.5, 0.5]^nx from default_rng(0), a zero reference."""
    kw = dict(dtype=torch.float32, device=DEVICE)
    x0 = np.random.default_rng(0).uniform(-0.5, 0.5, (B, nx))
    return torch.as_tensor(x0, **kw), torch.zeros((N, nx), **kw)


def resident_times(ctx, run, call):
    """CUDA-event ms (median of REPS) of ``run``, one launch on checked
    inputs; its device ms, as text: torch.profiler's (the median of the 3
    samples that record any), or where none does, CUDA events around REPS
    launches queued back to back, over REPS (the host's launch path then
    overlaps the kernels instead of standing between the events); and the
    host clock's ms of ``call``, the entry point's whole call."""
    torch = ctx.torch
    run()                                               # warm-up
    ms, times = cuda_ms(torch, run, REPS)
    dev = [d for d in (device_ms(torch, run) for _ in range(3))
           if d is not None]
    if dev:
        dev = f"{statistics.median(dev):.4f} ms (torch.profiler)"
    else:
        queued = cuda_ms(torch, lambda: [run() for _ in range(REPS)], 3)[0]
        dev = (f"{queued / REPS:.4f} ms (torch.profiler recorded none; "
               f"events around {REPS} queued launches)")
    call_ms = statistics.median(host_ms(torch, call)[0]
                                for _ in range(REPS))
    return ms, times, dev, call_ms


def cartpole_phases(ctx):
    """Phases 42-43: bench_all.py:128-142's cartpole batch at full width
    on csrc/admm_fused.cu (tinympc_admm_fused; at (4, 1) the families
    instantiation with zero counts, one thread a problem), then its
    external-plant sequence. Returns the kernels-line numbers of both."""
    torch, tt, af, card = ctx.torch, ctx.tt, ctx.admm_fused, ctx.card
    kern = tt.kernels
    rows = {}
    phase(f"phase 42: cartpole cold batch, B={CART_B}, N={CART_N}, "
          f"max_iter 100, ct 1")
    t0 = time.perf_counter()
    prob = cartpole_problem(tt, torch, 100, 1)
    setup_ms = 1e3 * (time.perf_counter() - t0)
    x0, Xref = cartpole_inputs(torch, CART_B)
    zero_counts(ctx.counters)
    sol_k, res_k = kern.solve_fused(prob, Xref, None, x0)
    torch.cuda.synchronize()
    launches = af.families_launch_count
    if launches < 1:
        raise AssertionError("the cartpole batch did not launch the kernel")
    took_entries(af, "cartpole cold", {FUSED: launches})
    if sol_k.x.shape != (CART_N, CART_B, 4) or \
            sol_k.u.shape != (CART_N - 1, CART_B, 1):
        raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                             f"{sol_k.u.shape}")
    plain_ms, (sol_p, res_p) = host_ms(
        torch, lambda: kern.solve_fused_reference(prob, Xref, None, x0))
    # At check_termination 1 the lanes whose counts agree are held, as
    # phase 4 holds the main path's ct 1 regime.
    err = compare(torch, "cartpole cold ct=1", sol_k, sol_p, res_k, res_p,
                  lanes="same_iters")
    tables, x0c, params = af._prepare(prob, Xref, None, x0)
    ms, times, dev, call_ms = resident_times(
        ctx, lambda: af._solve_kernel(tables, x0c, CART_N, 4, 1, **params),
        lambda: kern.solve_fused(prob, Xref, None, x0))
    iter_sum = int(sol_k.iter.sum().item())
    ops, nbytes = fused_work(CART_N, 4, 1, CART_B, iter_sum)
    bound_ms, bound_by = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
    log(f"  cartpole cold ct=1: kernel {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), device {dev}, solve_fused "
        f"call {call_ms:.4f} ms on the host clock (kernel share "
        f"{ms / call_ms:.4f}), {CART_B / (ms / 1e3):.1f} solves/s, mean "
        f"iters {iter_sum / CART_B:.4f}, solved frac "
        f"{sol_k.solved.float().mean().item():.5f}, bound {bound_ms:.4f} ms "
        f"({bound_by}; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), plain "
        f"{plain_ms:.1f} ms, launches {launches}; set-up {setup_ms:.1f} ms; "
        f"card {card}")
    rows["cartpole"] = dict(launches=launches, err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)

    # 43. the same problem as an external plant, x+ = A x + B u0
    B = CART_PLANT_B
    phase(f"phase 43: cartpole external-plant sequence, B={B}, 5 warm "
          f"solves")
    x, Xref = cartpole_inputs(torch, B)
    c_k = tt.init_carry(prob, B)
    zero_counts(ctx.counters)
    states, sols = [], []
    for _ in range(5):
        sol, _, c_k = kern.solve_fused_warm(prob, Xref, None, x, c_k)
        states.append(x)
        sols.append(sol)
        x = x @ prob.A.T + sol.u[0] @ prob.B.T + prob.f
    torch.cuda.synchronize()
    warm_launches = af.families_warm_launch_count
    if warm_launches < 5:
        raise AssertionError("the cartpole sequence did not launch the warm "
                             "kernel")
    took_entries(af, "cartpole sequence", {FUSED: warm_launches})
    c_p = tt.init_carry(prob, B)
    agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
    err_w = 0.0
    for step, (x_s, sol) in enumerate(zip(states, sols)):
        plain_w_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: kern.solve_fused_warm_reference(prob, Xref, None,
                                                           x_s, c_p))
        agreed &= sol.iter == sol_p.iter
        err_w = max(err_w, compare(torch, f"cartpole warm step {step}", sol,
                                   sol_p, lanes=agreed, solved_tol=2 / B))
        log(f"  step {step}: mean iters {sol.iter.float().mean().item():.4f}"
            f", solved frac {sol.solved.float().mean().item():.5f}")
    err_w = max(err_w, compare_carry(torch, "cartpole after 5 steps", c_k,
                                     c_p, agreed))
    tables, xc, params = af._prepare(prob, Xref, None, x)
    carry = af._carry_tensors(prob, c_k, B)
    run = lambda: af._solve_kernel_warm(tables, xc, carry, CART_N, 4, 1,
                                        **params)
    sol_w = run()[0]
    ms, times, dev, call_ms = resident_times(
        ctx, run, lambda: kern.solve_fused_warm(prob, Xref, None, x, c_k))
    iter_sum = int(sol_w.iter.sum().item())
    ops, nbytes = fused_work(CART_N, 4, 1, B, iter_sum,
                             lane_carry_floats(c_k))
    bound_ms, bound_by = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
    log(f"  cartpole solve_fused_warm (the sixth solve): kernel {ms:.4f} ms "
        f"(reps {[round(t, 4) for t in times]}), device {dev}, whole call "
        f"{call_ms:.4f} ms on the host clock (kernel share "
        f"{ms / call_ms:.4f}), mean iters {iter_sum / B:.4f}, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_w_ms:.1f} ms, warm "
        f"launches {warm_launches}; card {card}")
    rows["cartpole_warm"] = dict(launches=warm_launches, err=err_w, ms=ms,
                                 plain_ms=plain_w_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
    return rows


def dims_small_phase(ctx):
    """Phase 44: the one-thread kernel at every new pair against its plain
    versions, small: cartpole at N=10 and the degenerate pairs at
    tests/test_degenerate_dims.py's N and at N=10, B=1000 (ragged) and
    1024, ct 1 and 25, cold; and a 6-solve external-plant sequence at
    B=1000. Every launch on tinympc_admm_fused."""
    torch, tt, af, convert = ctx.torch, ctx.tt, ctx.admm_fused, ctx.convert
    phase(f"phase 44: the one-thread kernel at cartpole and the degenerate "
          f"pairs vs plain versions, B={DIMS_SMALL_B}, ct 1 and 25, cold "
          f"and 6 warm solves")
    cases = [("cartpole N=10", lambda ct: cartpole_problem(tt, torch, 100,
                                                          ct),
              lambda B: cartpole_inputs(torch, B))]
    for nx, nu, N in DEGENERATE:
        for n in (N, 10):
            cases.append((
                f"random ({nx}, {nu}) N={n}",
                lambda ct, nx=nx, nu=nu, n=n: degenerate_problem(
                    tt, torch, nx, nu, n, ct),
                lambda B, nx=nx, n=n: degenerate_inputs(torch, B, nx, n)))
    for label, make, make_inputs in cases:
        for ct in (1, 25):
            prob = make(ct)
            for B in DIMS_SMALL_B:
                x0, Xref = make_inputs(B)
                name = f"{label} cold B={B} ct={ct}"
                zero_entries(af)
                adaptive_small(torch, tt, convert, name, prob, x0, Xref, B)
                took_entries(af, name, {FUSED: 1})
            B = DIMS_SMALL_B[0]
            x0, Xref = make_inputs(B)
            name = f"{label} warm ct={ct}"
            zero_entries(af)
            adaptive_warm_small(torch, tt, convert, name, prob, x0, Xref, B,
                                steps=6)
            took_entries(af, name, {FUSED: 6})


def cartpole_kinds_phase(ctx):
    """Phase 45: cartpole's other kinds on the one-thread kernels, B=1024:
    adaptive rho (and apply_c), cold and 5 warm solves; consensus 128 x 8;
    a state hyperplane; a fleet of CART_FLEET_SYS variants; compaction;
    the streamed solve at N=CART_STREAM_N. Returns the kernels-line numbers
    of the streamed launches (backward, forward, stale forward)."""
    torch, tt, af, ast, convert = (ctx.torch, ctx.tt, ctx.admm_fused,
                                   ctx.ast, ctx.convert)
    kern = tt.kernels
    B = CART_KIND_B
    phase(f"phase 45: cartpole kinds, B={B}: adaptive rho, consensus, a "
          f"hyperplane, a fleet, compaction, the streamed solve at "
          f"N={CART_STREAM_N}")
    x0, Xref = cartpole_inputs(torch, B)
    # Adaptive rho: cartpole's rho of 1 sits on adaptive_rho_min's default,
    # so the floor is lowered, as for the rocket.
    for apply_c in (False, True):
        label = f"cartpole adaptive{' apply_c' if apply_c else ''}"
        prob = tt.with_settings(cartpole_problem(tt, torch, 100, 1),
                                adaptive_rho=True,
                                adaptive_rho_min=ROCKET_RHO_MIN,
                                adaptive_rho_apply_c=apply_c)
        zero_counts(ctx.counters)
        adaptive_small(torch, tt, convert, f"{label} cold B={B}", prob, x0,
                       Xref, B)
        # rho falls toward the lowered floor, so the carry's scaled duals
        # grow as 1 / rho and are held to the plain version's own spread,
        # as phase 33 holds the rocket's.
        adaptive_warm_small(torch, tt, convert, f"{label} warm", prob, x0,
                            Xref, B, steps=5, carry_spread=True)
        took_entries(af, label, {FUSED: 6})
        fail(label, af.adaptive_families_launch_count == 1
             and af.adaptive_families_warm_launch_count == 5,
             "not on the families adaptive instantiations")

    # Consensus, 128 groups of 8, cold and CONS_SMALL_WARM warm solves.
    prob = tt.with_consensus(cartpole_problem(tt, torch, 100, 1),
                             rho_c=CART_RHO_C)
    consensus_sequence(torch, tt, convert, af,
                       f"cartpole rho_c={CART_RHO_C} {B // 8}x8", 1, prob,
                       x0.reshape(B // 8, 8, 4), Xref, None, FUSED)

    # A state hyperplane on the cart position, cold and 3 warm solves.
    label = f"cartpole x[0] <= {CART_PLANE}"
    prob = tt.with_linear_constraints(cartpole_problem(tt, torch, 100, 1),
                                      [[1.0, 0.0, 0.0, 0.0]], [CART_PLANE])
    zero_counts(ctx.counters)
    adaptive_small(torch, tt, convert, f"{label} cold B={B}", prob, x0,
                   Xref, B)
    outs = adaptive_warm_small(torch, tt, convert, f"{label} warm", prob,
                               x0, Xref, B, steps=3)
    took_entries(af, label, {FUSED: 4})
    binds = (outs[0][2].gl.abs().amax(dim=(0, 1)) > 0).float().mean().item()
    log(f"  {label}: the plane binds on {binds:.5f} of lanes after the "
        f"first warm solve")

    # A fleet of variants, A off the diagonal scaled by 1 + 0.004 (i - 2)
    # (examples/serving_fleet.py:100-113's spread), random assignments:
    # cold and 2 warm solves, one multi-system launch each, bitwise the
    # per-bucket launches.
    n = CART_FLEET_SYS
    s = tt.systems.cartpole()
    probs = [cartpole_problem(tt, torch, 100, 1, A=s["A"] * np.where(
        np.eye(4) == 1, 1.0, 1 + 0.004 * (i - n // 2))) for i in range(n)]
    assign = np.random.default_rng(0).integers(0, n, B)
    idxs = [torch.as_tensor(np.flatnonzero(assign == k), device=DEVICE)
            for k in range(n)]
    zero_counts(ctx.counters)
    cold = tt.make_fleet_solver(probs)(assign, x0, Xref)
    parts = [(idx, kern.solve_fused(p, Xref, None, x0[idx]))
             for p, idx in zip(probs, idxs)]
    torch.cuda.synchronize()
    same_bits(torch, "cartpole fleet cold", cold,
              merge_buckets(af, B, parts), "per-bucket solve_fused launches")
    solve = tt.make_fleet_solver(probs, warm=True)
    carry, carries, x = tt.init_carry(probs[0], B), [
        tt.init_carry(p, idx.numel()) for p, idx in zip(probs, idxs)], x0
    for step in range(2):
        out = solve(assign, x, carry, Xref)
        parts = []
        for k, (p, idx) in enumerate(zip(probs, idxs)):
            w = kern.solve_fused_warm(p, Xref, None, x[idx], carries[k])
            carries[k] = w[2]
            parts.append((idx, w))
        torch.cuda.synchronize()
        same_bits(torch, f"cartpole fleet warm step {step}", out,
                  merge_buckets(af, B, parts),
                  "per-bucket solve_fused_warm launches")
        carry = out[2]
        nxt = torch.empty_like(x)
        for p, idx in zip(probs, idxs):
            nxt[idx] = x[idx] @ p.A.T + out[0].u[0][idx] @ p.B.T
        x = nxt
    took_entries(af, "cartpole fleet", {
        "tinympc_admm_fused_multi": 3, FUSED: n + 2 * n})
    fail("cartpole fleet", af.multi_launch_count == 1
         and af.multi_warm_launch_count == 2, "not one multi-system launch "
         "a solve")

    # Compaction to convergence in phases [100, 400], bitwise one long
    # solve_fused; "auto" takes the resident kernel.
    label = "cartpole compaction [100, 400]"
    prob = cartpole_problem(tt, torch, 500, 1)
    fail(label, ctx.compact._backend(prob, "auto") == "resident",
         "auto does not take the resident kernel")
    (sol_c, res_c), phases = compact_drive(ctx, label, prob, x0, Xref,
                                           entries={FUSED},
                                           chunk=COMPACT_CHUNK)
    same_bits(torch, label, (sol_c, res_c),
              kern.solve_fused(prob, Xref, None, x0), "one long solve_fused")
    log(f"  {label}: {phases} phases, mean iters "
        f"{sol_c.iter.float().mean().item():.4f}, solved frac "
        f"{sol_c.solved.float().mean().item():.5f}")

    # The streamed solve at N=CART_STREAM_N on the one-thread entries,
    # bitwise the resident kernel on the same inputs: cold, then 3 warm
    # solves of a plant, each bitwise solve_fused_warm.
    N = CART_STREAM_N
    label = f"cartpole streamed N={N}"
    prob = cartpole_problem(tt, torch, 100, 1, N=N)
    xs, Xs = cartpole_inputs(torch, B, N)
    (sol_k, res_k), launches = stream_drive(ctx, label, prob, Xs, None, xs)
    same_bits(torch, label, (sol_k, res_k),
              kern.solve_fused(prob, Xs, None, xs), "solve_fused")
    lt, b_bwd, b_fwd = stream_report(
        ctx, label, prob, Xs, None, xs, sol_k, launches,
        resident=resident_cold(af, prob, Xs, None, xs))
    rows = {"backward_4x1": dict(launches=launches[0], err=lt["err_b"],
                                 ms=lt["bwd_ms"], plain_ms=lt["plain_bwd_ms"],
                                 bound_ms=b_bwd[0], bound_by=b_bwd[1]),
            "forward_4x1": dict(launches=launches[1], err=lt["err_f"],
                                ms=lt["fwd_ms"], plain_ms=lt["plain_fwd_ms"],
                                bound_ms=b_fwd[0], bound_by=b_fwd[1])}
    c_k, c_r, x = tt.init_carry(prob, B), tt.init_carry(prob, B), xs
    zero_counts(ctx.counters)
    states, carries = [], [c_k]
    for step in range(3):
        sol_k, res_k, c_k = kern.solve_fused_streamed_warm(prob, Xs, None, x,
                                                            c_k)
        sol_r, res_r, c_r = kern.solve_fused_warm(prob, Xs, None, x, c_r)
        same_bits(torch, f"{label} warm step {step}", (sol_k, res_k, c_k),
                  (sol_r, res_r, c_r), "solve_fused_warm")
        states.append(x)
        carries.append(c_k)
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
    torch.cuda.synchronize()
    stale = ast.launch_counts["forward_stale"]
    fail(f"{label} warm", stale == 3, f"{stale} stale forward launches, 3 "
         f"expected")
    took_route(ast, f"{label} warm", prob)
    # The third solve again, for its launches and times.
    name = f"{label} warm (the third solve)"
    launches3 = stream_drive(ctx, name, prob, Xs, None, states[-1],
                             carries[-2])[1]
    lt, _, b_stale = stream_report(ctx, name, prob, Xs, None, states[-1],
                                   sol_k, launches3, carry=carries[-2])
    rows["forward_stale_4x1"] = dict(
        launches=stale, err=lt["err_f"], ms=lt["fwd_ms"],
        plain_ms=lt["plain_fwd_ms"], bound_ms=b_stale[0],
        bound_by=b_stale[1])
    return rows


def rocket_loop_inputs(torch, B, T=ROCKET_LOOP_T, N=FAM_N):
    """examples/scenarios.py:181-225's loop: x0 = xinit U[0.9, 1.2] per
    lane (default_rng(0)), the sliding reference xinit + (0 - xinit) k /
    (NTOTAL - 1) for k = 0 .. T + N - 2, Uref[:, 2] = 10."""
    xinit = np.asarray(ROCKET_XINIT)
    x0 = xinit * np.random.default_rng(0).uniform(0.9, 1.2, (B, 1))
    k = np.arange(T + N - 1)[:, None]
    xtot = xinit + (0.0 - xinit) * k / (ROCKET_NTOTAL - 1)
    Uref = np.zeros((N - 1, 3))
    Uref[:, 2] = 10.0
    kw = dict(dtype=torch.float32, device=DEVICE)
    return tuple(torch.as_tensor(a, **kw) for a in (x0, xtot, Uref))


def cartpole_loop_inputs(torch, B, N=CART_N):
    """examples/scenarios.py:38-57's regulation: x0 = [0.5, 0, 0, 0] +
    U[-0.3, 0.3]^4 (default_rng(0)), the reference x = 1 held."""
    x0 = np.asarray([0.5, 0.0, 0.0, 0.0]) \
        + np.random.default_rng(0).uniform(-0.3, 0.3, (B, 4))
    Xref = np.zeros((N, 4))
    Xref[:, 0] = 1.0
    kw = dict(dtype=torch.float32, device=DEVICE)
    return torch.as_tensor(x0, **kw), torch.as_tensor(Xref, **kw)


def took_loop(cl, label, thread):
    """Fail the run unless the closed-loop launches since the counts were
    last zeroed took the one-thread loop (csrc/closed_loop_thread.cu)
    ``thread`` times and the thread-group loop no time."""
    got = dict(cl.launch_counts)
    want = {cl.KERNEL: 0, cl.THREAD_KERNEL: thread}
    fail(f"{label} kernel", got == want and cl.launch_count == thread,
         f"launches by kernel {got}, expected {want}")
    log(f"  {label}: launches by kernel {got}")


def thread_loop_check(ctx, label, prob, xtot, x0, T, Uref=None,
                      plain_T=None, **opts):
    """One closed loop through closed_loop_fused on the one-thread kernel,
    held to its plain version on the card: the launch counted on that
    kernel, the shapes, compare_loop's bar (where fewer than 99% of the
    counts agree, the count bar of rounding_floor's witnesses), and
    whether the two are bitwise. With ``plain_T`` the plain version runs
    the first ``plain_T`` steps only and is held to the kernel's first
    ``plain_T`` (a step depends on the steps before it alone). Returns the
    kernel's output, the plain version's ms and the error."""
    torch, tt, cl, convert = ctx.torch, ctx.tt, ctx.cl, ctx.convert
    spec = prob.spec
    B = x0.shape[0]
    zero_counts(ctx.counters)
    out_k = tt.kernels.closed_loop_fused(prob, xtot, x0, T, Uref, **opts)
    torch.cuda.synchronize()
    took_loop(cl, label, 1)
    if out_k[0].shape != (T, B, spec.nx) or out_k[1].shape != (T, B,
                                                               spec.nu):
        raise AssertionError(f"{label}: bad output shapes {out_k[0].shape} "
                             f"{out_k[1].shape}")
    full_k = out_k
    if plain_T is not None:
        T, xtot, out_k = plain_T, xtot[:plain_T + spec.N - 1], tuple(
            o[:plain_T] for o in out_k)
        label = f"{label} (first {T} steps)"
    plain_ms, out_p = host_ms(
        torch, lambda: tt.kernels.closed_loop_fused_reference(
            prob, xtot, x0, T, Uref, **opts))
    bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    log(f"  {label}: bitwise the plain version on the card: {bitwise}")
    share = BAR_ITER_SHARE
    if (out_k[2] == out_p[2]).float().mean().item() < share:
        np_prob = convert.problem_to_numpy(prob)
        prob_c = convert.problem_from_numpy(np_prob, "cpu")
        prob64 = convert.problem_from_numpy(np_prob, DEVICE, torch.float64)
        share = rounding_floor(torch, tt, label, None, 1, xtot, x0, T, opts,
                               out_k, out_p, prob_c=prob_c, prob64=prob64,
                               Uref=Uref)
    return full_k, plain_ms, compare_loop(torch, label, out_k, out_p, share)


def thread_loop_row(ctx, label, prob, xtot, x0, T, Uref=None, plain_T=None,
                    **opts):
    """A full-width serving loop on the one-thread kernel: checked by
    :func:`thread_loop_check`, then timed (CUDA events, torch.profiler
    device time, the entry point's whole call on the host clock) beside
    its bound. Returns the kernels-line numbers."""
    torch, tt, cl = ctx.torch, ctx.tt, ctx.cl
    spec = prob.spec
    N, nx, nu, B = spec.N, spec.nx, spec.nu, x0.shape[0]
    out_k, plain_ms, err = thread_loop_check(ctx, label, prob, xtot, x0, T,
                                             Uref, plain_T, **opts)
    tables, xt, x0c, T_, params = cl._prepare_loop(prob, xtot, x0, T, Uref)
    launch = dict(reset_duals=False, shift_warm=False, **params)
    launch.update(opts)
    ms, times, dev, call_ms = resident_times(
        ctx, lambda: cl._loop_thread_kernel(tables, xt, x0c, T_, N, nx, nu,
                                            **launch),
        lambda: tt.kernels.closed_loop_fused(prob, xtot, x0, T, Uref,
                                             **opts))
    iter_sum = int(out_k[2].sum().item())
    ops, nbytes = loop_work(N, nx, nu, B, T, iter_sum)
    bound_ms, bound_by = bound(ops, nbytes, ctx.peak_flops, ctx.peak_bw)
    log(f"  {label}: kernel {ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), device {dev}, "
        f"{B * T / (ms / 1e3):.1f} MPC steps/s, mean iters per step "
        f"{iter_sum / (B * T):.4f}, solved frac "
        f"{out_k[3].float().mean().item():.5f}, bound {bound_ms:.4f} ms "
        f"({bound_by}; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), plain "
        f"{plain_ms:.1f} ms{'' if plain_T is None else f' ({plain_T} steps)'}"
        f", closed_loop_fused call {call_ms:.4f} ms (kernel share "
        f"{ms / call_ms:.4f}), launches 1; card {ctx.card}")
    return dict(launches=1, err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def thread_loop_phases(ctx):
    """Phases 47-50: the fused closed loop on one thread a plant
    (csrc/closed_loop_thread.cu) -- the rocket's and cartpole's serving
    loops at full width, the degenerate pairs small, and the pinned
    (12, 4) instance bitwise the thread-group loop on phase 7's serving
    loop. Returns the kernels-line numbers of the two serving loops."""
    torch, tt, cl = ctx.torch, ctx.tt, ctx.cl
    rows = {}
    B = SERVE_B
    phase(f"phase 47: the rocket's serving loop on the one-thread closed "
          f"loop, B={B}, T={ROCKET_LOOP_T}, N={FAM_N}, ct 1")
    # Every instantiation compiled spill-free (the build phase fails any
    # closed-loop kernel that spills; here each must also be present).
    for nx, nu in cl.THREAD_LOOP_DIMS + cl.KERNEL_DIMS:
        label = f"closed_loop_thread ({nx}, {nu})"
        e = ctx.ptxas.get(label, {})
        log(f"  ptxas {label}: {e.get('regs')} registers, {e.get('stack')} "
            f"bytes stack frame, {e.get('spill_st')} / {e.get('spill_ld')} "
            f"bytes spill stores / loads")
        fail(f"ptxas {label}", bool(e) and e.get("stack") == 0
             and e.get("spill_st") == 0 and e.get("spill_ld") == 0,
             "missing, or the kernel spills or uses local memory")
    prob = rocket_problem(tt, torch, 100, 1, cones=False)
    x0, xtot, Uref = rocket_loop_inputs(torch, B)
    rows["rocket"] = thread_loop_row(ctx, "rocket loop", prob, xtot, x0,
                                     ROCKET_LOOP_T, Uref)

    phase(f"phase 48: cartpole's serving loop on the one-thread closed "
          f"loop, B={B}, T={CART_LOOP_T}, N={CART_N}, ct 5; then max_iter "
          f"500, shift_warm off and on (their plain versions on the first "
          f"{LOOP_PREFIX_T} steps)")
    x0, Xref = cartpole_loop_inputs(torch, B)
    # At max_iter 500 a quarter of the (step, lane) pairs never converge,
    # so every step of the plain version runs all 500 iterations (~70 s
    # for the 50 steps); it is held to the kernel's first steps.
    for mi, shift, plain_T in ((100, False, None), (500, False, LOOP_PREFIX_T),
                               (500, True, LOOP_PREFIX_T)):
        prob = cartpole_problem(tt, torch, mi, 5)
        label = f"cartpole loop max_iter={mi} shift_warm={shift}"
        r = thread_loop_row(ctx, label, prob, Xref, x0, CART_LOOP_T,
                            plain_T=plain_T, shift_warm=shift)
        if mi == 100:
            rows["cartpole"] = r

    phase(f"phase 49: the one-thread closed loop at the degenerate pairs "
          f"(fixed, reset_duals, shift_warm), the rocket (reset_duals, "
          f"shift_warm) and cartpole (reset_duals) vs plain version, "
          f"B={LOOP_SMALL_B}, T={LOOP_SMALL_T}, N=10")
    T = LOOP_SMALL_T
    fixed, reset, shift = ((5, {}), (1, dict(reset_duals=True)),
                           (5, dict(shift_warm=True)))
    cases = []
    for nx, nu, _ in DEGENERATE:
        x0, Xref = degenerate_inputs(torch, LOOP_SMALL_B, nx, 10)
        cases.append((f"random ({nx}, {nu}) N=10",
                      lambda ct, nx=nx, nu=nu: degenerate_problem(
                          tt, torch, nx, nu, 10, ct), Xref, x0, None,
                      (fixed, reset, shift)))
    # The full-width loops ran the rocket fixed and cartpole fixed and
    # shifted; here the other options, on a ragged batch.
    x0, xtot, Uref = rocket_loop_inputs(torch, LOOP_SMALL_B, T)
    cases.append(("rocket", lambda ct: rocket_problem(tt, torch, 100, ct,
                                                      cones=False),
                  xtot, x0, Uref, (reset, shift)))
    x0, Xref = cartpole_loop_inputs(torch, LOOP_SMALL_B)
    cases.append(("cartpole", lambda ct: cartpole_problem(tt, torch, 100,
                                                          ct), Xref, x0,
                  None, (reset,)))
    for name, make, xtot, x0, Uref, options in cases:
        for ct, opts in options:
            label = f"{name} ct={ct}" + "".join(f" {k}" for k in opts)
            thread_loop_check(ctx, label, make(ct), xtot, x0, T, Uref,
                              **opts)

    phase(f"phase 50: the one-thread closed loop pinned at (12, 4), phase "
          f"7's serving loop, B={SERVE_B}, T={SERVE_T}: bitwise the "
          f"thread-group loop, both timed in turns")
    prob = problem(tt, torch, 100, 5, N=SERVE_N)
    x0, Xref = inputs(torch, SERVE_B, N=SERVE_N, spread=0.3)
    zero_counts(ctx.counters)
    out_g = tt.kernels.closed_loop_fused(prob, Xref, x0, SERVE_T)
    torch.cuda.synchronize()
    fail("serving loop group kernel", cl.launch_counts == {
        cl.KERNEL: 1, cl.THREAD_KERNEL: 0}, f"launches by kernel "
        f"{cl.launch_counts}")
    zero_counts(ctx.counters)
    out_t = cl._closed_loop_fused(prob, Xref, x0, SERVE_T, thread=True)
    torch.cuda.synchronize()
    took_loop(cl, "serving loop pinned to the one-thread loop", 1)
    same = [torch.equal(a, b) for a, b in zip(out_t, out_g)]
    log(f"  serving loop: one-thread loop bitwise the thread-group loop "
        f"(xs, us, iters, solved): {same}")
    fail("serving loop pinned (12, 4)", all(same), "the one-thread loop is "
         "not bitwise the thread-group loop")
    tables, xt, x0c, T_, params = cl._prepare_loop(prob, Xref, x0, SERVE_T,
                                                   None)
    runs = {
        "group": lambda: cl._loop_kernel(tables, xt, x0c, T_, SERVE_N, 12,
                                         4, reset_duals=False,
                                         shift_warm=False, **params),
        "thread": lambda: cl._loop_thread_kernel(
            tables, xt, x0c, T_, SERVE_N, 12, 4, reset_duals=False,
            shift_warm=False, **params)}
    for run in runs.values():
        run()                                           # warm-up
    got = {k: [] for k in runs}
    for k in ("group", "thread", "thread", "group"):
        got[k].append(cuda_ms(torch, runs[k], REPS)[0])
    log(f"  serving loop (12, 4) in turns (group, thread, thread, group): "
        f"thread-group loop {[round(t, 4) for t in got['group']]} ms, "
        f"one-thread loop {[round(t, 4) for t in got['thread']]} ms; card "
        f"{ctx.card}")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tinympc_tpu_torch as tt
    from tinympc_tpu_torch import convert
    from tinympc_tpu_torch import roofline as roofline_tool
    from tinympc_tpu_torch.kernels import _build, admm_fused, admm_stream, \
        closed_loop_kernel, compact, roofline
    counters = ((admm_stream, "launch_counts"),
                (roofline, "launch_counts"),
                (admm_fused, "multi_launch_count"),
                (admm_fused, "multi_warm_launch_count"),
                (compact, "phase_count"),
                (admm_fused, "launch_count"),
                (admm_fused, "warm_launch_count"),
                (admm_fused, "families_launch_count"),
                (admm_fused, "families_warm_launch_count"),
                (closed_loop_kernel, "launch_count"),
                (closed_loop_kernel, "launch_counts"),
                (admm_fused, "adaptive_launch_count"),
                (admm_fused, "adaptive_warm_launch_count"),
                (admm_fused, "adaptive_families_launch_count"),
                (admm_fused, "adaptive_families_warm_launch_count"),
                (admm_fused, "consensus_launch_count"),
                (admm_fused, "consensus_warm_launch_count"),
                (admm_fused, "entry_counts"))

    # 1. card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peaks(name)
    peak_bf16 = next(v for key, v in PEAKS_BF16 if key in name)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    # What the phases share: modules, counters, the card, and what earlier
    # phases found (ptxas entries by label, sensitivity tables).
    ctx = types.SimpleNamespace(
        torch=torch, tt=tt, convert=convert, admm_fused=admm_fused,
        ast=admm_stream, compact=compact, counters=counters, card=card,
        peak_flops=peak_flops, peak_bw=peak_bw, peak_bf16=peak_bf16,
        ptxas={}, tables={}, rocket_tables=None, rf=roofline,
        tool=roofline_tool, build=_build, main_iter_us=None,
        cl=closed_loop_kernel)

    # 2. build: every source, one nvcc each, started together
    t0 = time.perf_counter()
    logs = _build.build(_build.SOURCES)
    admm_fused._group_fn()
    admm_fused._kernel_fn()
    admm_fused._kernel_fn(multi=True)
    closed_loop_kernel._kernel_fn()
    closed_loop_kernel._thread_kernel_fn()
    admm_stream._kernel_fns()
    roofline._fns()
    log(f"build: {time.perf_counter() - t0:.1f} s (set-up), "
        f"{len(logs)} sources compiled")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "entry function" in line \
                    or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
        for fn, e in sorted(ptxas_entries(text).items(),
                            key=lambda kv: kernel_label(kv[0])):
            label = kernel_label(fn)
            ctx.ptxas[label] = e
            log(f"  ptxas summary: {label}: {e.get('regs')} registers, "
                f"{e.get('stack')} bytes stack frame (local memory), "
                f"{e.get('spill_st')} / {e.get('spill_ld')} bytes spill "
                f"stores / loads")
            if "families" in label or "admm_stream" in label \
                    or "admm_group" in label or "closed_loop" in label \
                    or "mma" in label:
                fail(f"ptxas {label}", e.get("stack") == 0
                     and e.get("spill_st") == 0 and e.get("spill_ld") == 0,
                     "the kernel spills or uses local memory")

    bad = check_rounding(torch, _build.load(admm_fused.KERNEL))
    log(f"rounding: div_rn and sqrt_rn against IEEE division and square "
        f"root on {1 << 24} random float pairs: {bad} results differ")
    fail("rounding", bad == 0, f"{bad} results differ from IEEE's")

    # 3. cold kernel against plain version, small; and against admm.solve
    phase("phase 3: cold kernel vs plain version, small batches")
    for B in (1000, 1024):
        for ct in (25, 1):
            prob = problem(tt, torch, 100, ct)
            x0, Xref = inputs(torch, B)
            sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
            sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref,
                                                            None, x0)
            torch.cuda.synchronize()
            compare(torch, f"ct={ct}", sol_k, sol_p, res_k, res_p)
    prob = problem(tt, torch, 100, 5)
    x0, Xref = inputs(torch, 256)
    sol_k, _ = tt.kernels.solve_fused(prob, Xref, None, x0)
    sol_s, _, _ = tt.solve(prob, tt.init_state(prob, (256,)), Xref, None, x0)
    torch.cuda.synchronize()
    compare(torch, "kernel vs admm.solve ct=5", sol_k, sol_s)

    # 4. cold main path at full width
    phase(f"phase 4: cold main path, B={BATCH}")
    x0, Xref = inputs(torch, BATCH)
    regimes = {}
    # The main path is held to the bar on every lane. The other two
    # regimes hold the lanes whose iteration counts agree: to 1e-3 over
    # max_iter 500 (float32 rounding differences grow with the iterations)
    # and to the bar at check_termination 1.
    for mi, ct, atol, lanes in ((100, 25, BAR_ATOL, "all"),
                                (500, 25, 1e-3, "same_iters"),
                                (100, 1, BAR_ATOL, "same_iters")):
        t0 = time.perf_counter()
        prob = problem(tt, torch, mi, ct)
        setup_ms = 1e3 * (time.perf_counter() - t0)
        zero_counts(counters)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, None, x0)
        torch.cuda.synchronize()
        launches = admm_fused.launch_count
        if launches < 1:
            raise AssertionError("the main path did not launch the kernel")
        took_group(admm_fused, f"main path max_iter={mi} ct={ct}", launches)
        if sol_k.x.shape != (N_HORIZON, BATCH, 12) or \
                sol_k.u.shape != (N_HORIZON - 1, BATCH, 4):
            raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                                 f"{sol_k.u.shape}")
        plain_ms, (sol_p, res_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_reference(prob, Xref, None,
                                                            x0))
        err = compare(torch, f"max_iter={mi} ct={ct}", sol_k, sol_p, res_k,
                      res_p, atol, lanes)

        tables, x0c, params = admm_fused._prepare(prob, Xref, None, x0)
        run = lambda: admm_fused._solve_kernel(
            tables, x0c, N_HORIZON, 12, 4, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, REPS)
        # The whole entry-point call on the host clock (table packing,
        # allocation, launch, wait): how much of it the device is busy.
        e2e_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.solve_fused(prob, Xref, None,
                                                          x0))[0]
            for _ in range(REPS))
        iter_sum = int(sol_k.iter.sum().item())
        ops, nbytes = fused_work(N_HORIZON, 12, 4, BATCH, iter_sum)
        bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
        avg_it = iter_sum / BATCH
        solved = sol_k.solved.float().mean().item()
        log(f"  max_iter={mi} ct={ct}: kernel {ms:.4f} ms "
            f"(reps {[round(t, 4) for t in times]}), plain {plain_ms:.1f} ms, "
            f"bound {bound_ms:.4f} ms ({ops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {BATCH / (ms / 1e3):.1f} solves/s, "
            f"avg iters {avg_it:.4f}, solved frac {solved:.5f}, "
            f"launches {launches}; setup {setup_ms:.1f} ms, solve_fused "
            f"call {e2e_ms:.4f} ms (kernel share {ms / e2e_ms:.4f}); "
            f"card {card}")
        regimes[(mi, ct)] = dict(launches=launches, err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
        if (mi, ct) == (100, 25):
            ctx.main_iter_us = 1e3 * ms / avg_it

    # 5. warm kernel against plain version, small external-plant sequences
    phase("phase 5: warm kernel vs plain version, B=1000, 6 warm solves")
    for ct in (1, 5):
        prob = problem(tt, torch, 100, ct, N=SERVE_N)
        x, Xref = inputs(torch, 1000, N=SERVE_N, spread=0.3)
        c_k, c_p = tt.init_carry(prob, 1000), tt.init_carry(prob, 1000)
        agreed = torch.ones(1000, dtype=torch.bool, device=DEVICE)
        for step in range(6):
            sol_k, res_k, c_k = tt.kernels.solve_fused_warm(prob, Xref, None,
                                                            x, c_k)
            sol_p, res_p, c_p = tt.kernels.solve_fused_warm_reference(
                prob, Xref, None, x, c_p)
            torch.cuda.synchronize()
            agreed &= sol_k.iter == sol_p.iter
            label = f"ct={ct} step {step}"
            compare(torch, label, sol_k, sol_p, lanes=agreed)
            compare_carry(torch, label, c_k, c_p, agreed)
            x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f

    # 6. closed-loop kernel against plain version, small
    phase("phase 6: closed-loop kernel vs plain version, B=1000, T=20")
    T6 = 20
    # The last two loops slide the window along a reference that climbs
    # 0.01 m a step in y (0.2 m/s at 20 Hz).
    moving = torch.as_tensor(
        [[0, 0.01 * k, 1.0] + [0.0] * 9 for k in range(T6 + SERVE_N - 1)],
        dtype=torch.float32, device=DEVICE)
    for ct, reset, shift, move, label in (
            (5, False, False, False, "ct=5"),
            (1, True, False, False, "ct=1 reset_duals"),
            (5, False, True, False, "ct=5 shift_warm"),
            (5, True, False, True, "ct=5 reset_duals, moving reference"),
            (1, True, False, True, "ct=1 reset_duals, moving reference")):
        prob = problem(tt, torch, 100, ct, N=SERVE_N)
        x0, Xref = inputs(torch, 1000, N=SERVE_N, spread=0.3)
        xref = moving if move else Xref
        opts = dict(reset_duals=reset, shift_warm=shift)
        out_k = tt.kernels.closed_loop_fused(prob, xref, x0, T6, **opts)
        out_p = tt.kernels.closed_loop_fused_reference(prob, xref, x0, T6,
                                                       **opts)
        torch.cuda.synchronize()
        share = BAR_ITER_SHARE
        if ct == 1 and move:
            share = rounding_floor(torch, tt, label, 100, ct, xref, x0, T6,
                                   opts, out_k, out_p)
        compare_loop(torch, label, out_k, out_p, share)

    # 7. serving path at full width, then the max_iter 500 regimes
    phase(f"phase 7: serving closed loop, B={SERVE_B}, T={SERVE_T}, "
        f"N={SERVE_N}")
    x0, Xref = inputs(torch, SERVE_B, N=SERVE_N, spread=0.3)
    loops = {}
    for mi, shift, reps in ((100, False, REPS), (500, False, 3),
                            (500, True, 3)):
        prob = problem(tt, torch, mi, 5, N=SERVE_N)
        label = f"max_iter={mi} ct=5 shift_warm={shift}"
        zero_counts(counters)
        out_k = tt.kernels.closed_loop_fused(prob, Xref, x0, SERVE_T,
                                             shift_warm=shift)
        torch.cuda.synchronize()
        launches = closed_loop_kernel.launch_count
        if launches < 1:
            raise AssertionError("the serving path did not launch the "
                                 "closed-loop kernel")
        if out_k[0].shape != (SERVE_T, SERVE_B, 12) or \
                out_k[1].shape != (SERVE_T, SERVE_B, 4):
            raise AssertionError(f"bad output shapes {out_k[0].shape} "
                                 f"{out_k[1].shape}")
        plain_ms, out_p = host_ms(
            torch, lambda: tt.kernels.closed_loop_fused_reference(
                prob, Xref, x0, SERVE_T, shift_warm=shift))
        err = compare_loop(torch, label, out_k, out_p)
        args = closed_loop_kernel._prepare_loop(prob, Xref, x0, SERVE_T,
                                                None)
        tables, xtot, x0c, T, params = args
        run = lambda: closed_loop_kernel._loop_kernel(
            tables, xtot, x0c, T, SERVE_N, 12, 4, reset_duals=False,
            shift_warm=shift, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, reps)
        call_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.closed_loop_fused(
                prob, Xref, x0, SERVE_T, shift_warm=shift))[0]
            for _ in range(reps))
        iters = out_k[2]
        iter_sum = int(iters.sum().item())
        ops, nbytes = loop_work(SERVE_N, 12, 4, SERVE_B, SERVE_T, iter_sum)
        bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
        log(f"  {label}: kernel {ms:.4f} ms (reps "
            f"{[round(t, 4) for t in times]}), "
            f"{SERVE_B * SERVE_T / (ms / 1e3):.1f} MPC steps/s, mean iters "
            f"per step {iter_sum / (SERVE_B * SERVE_T):.4f}, solved frac "
            f"{out_k[3].float().mean().item():.5f}, bound {bound_ms:.4f} ms "
            f"({bound_by}; {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"plain {plain_ms:.1f} ms, closed_loop_fused call {call_ms:.4f} "
            f"ms (kernel share {ms / call_ms:.4f}), launches {launches}; "
            f"card {card}")
        loops[(mi, shift)] = dict(launches=launches, err=err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)

    # 8. the external-plant loop of examples/serving_fleet.py:62-77
    phase(f"phase 8: external-plant loop, B={SERVE_B}, 5 warm solves")
    # check_termination 1, as serving_fleet.py leaves it.
    prob = problem(tt, torch, 100, 1, N=SERVE_N)
    rng = np.random.default_rng(0)
    hover = torch.as_tensor(HOVER, dtype=torch.float32, device=DEVICE)
    Xref = hover.expand(SERVE_N, 12).contiguous()
    x = hover + torch.as_tensor(rng.uniform(-0.3, 0.3, (SERVE_B, 12)),
                                dtype=torch.float32, device=DEVICE)
    c_k = tt.init_carry(prob, SERVE_B)
    zero_counts(counters)
    states, sols = [], []
    for step in range(5):
        sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, None, x, c_k)
        states.append(x)
        sols.append(sol_k)
        u0 = sol_k.u[0] + 0.01 * torch.as_tensor(
            rng.normal(size=(SERVE_B, 4)), dtype=torch.float32,
            device=DEVICE)
        x = x @ prob.A.T + u0 @ prob.B.T + prob.f
    torch.cuda.synchronize()
    warm_launches = admm_fused.warm_launch_count
    if warm_launches < 5:
        raise AssertionError("the external-plant loop did not launch the "
                             "warm kernel")
    took_group(admm_fused, "external-plant loop", warm_launches)
    # The plain version on the same plant states, with its own carry.
    c_p = tt.init_carry(prob, SERVE_B)
    agreed = torch.ones(SERVE_B, dtype=torch.bool, device=DEVICE)
    err_warm = 0.0
    for step, (x_s, sol_k) in enumerate(zip(states, sols)):
        plain_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_warm_reference(
                prob, Xref, None, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_warm = max(err_warm, compare(torch, f"step {step}", sol_k,
                                         sol_p, lanes=agreed,
                                         solved_tol=2 / SERVE_B))
        log(f"  step {step}: mean iters {sol_k.iter.float().mean().item():.4f}"
            f", mean pos err "
            f"{(x_s[:, :3] - hover[:3]).norm(dim=-1).mean().item():.6f}")
    compare_carry(torch, "after 5 steps", c_k, c_p, agreed)
    tables, xc, params = admm_fused._prepare(prob, Xref, None, x)
    carry = admm_fused._carry_tensors(prob, c_k, SERVE_B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, SERVE_N,
                                                12, 4, **params)
    sol_w = run()[0]                                    # warm-up
    warm_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: tt.kernels.solve_fused_warm(prob, Xref, None,
                                                           x, c_k))[0]
        for _ in range(REPS))
    iter_sum = int(sol_w.iter.sum().item())
    ops, nbytes = fused_work(SERVE_N, 12, 4, SERVE_B, iter_sum,
                             lane_carry_floats(c_k))
    warm_bound_ms, warm_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  solve_fused_warm: kernel {warm_ms:.4f} ms (reps "
        f"{[round(t, 4) for t in times]}), whole call {call_ms:.4f} ms on "
        f"the host clock (kernel share {warm_ms / call_ms:.4f}), plain "
        f"{plain_ms:.1f} ms, bound {warm_bound_ms:.4f} ms ({warm_bound_by}; "
        f"mean iters {iter_sum / SERVE_B:.4f}), "
        f"{SERVE_B / (warm_ms / 1e3):.1f} solves/s, launches "
        f"{warm_launches}; card {card}")

    # 9. families kernels against their plain versions, small
    phase(f"phase 9: families kernels vs plain versions, B={FAM_SMALL_B}")
    # The quadrotor's ceilings sit low enough here that the state planes
    # bite on part of the lanes while most still converge.
    B = FAM_SMALL_B
    small = []
    for ct in (1, 5):
        small += [("rocket SOC", ct,
                   lambda mi, ct, dt=None: rocket_problem(
                       tt, torch, mi, ct, dtype=dt), rocket_inputs)]
        kind = "linear" if ct == 1 else "tv"
        small += [(f"quadrotor {kind}", ct,
                   lambda mi, ct, dt=None, k=kind: quad_plane_problem(
                       tt, torch, k == "tv", mi, ct, LOW_CEILING[k],
                       dtype=dt), quad_plane_inputs)]
    cpu = lambda a: None if a is None else a.cpu()
    everyone = torch.ones(B, dtype=torch.bool)
    for label, ct, make, make_inputs in small:
        prob = make(100, ct)
        # The same problem arrays on the CPU, for the plain version there.
        prob_c = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                            "cpu")
        x0, Xref, Uref = make_inputs(torch, B)
        zero_entries(admm_fused)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, Uref, x0)
        sol_p, res_p = tt.kernels.solve_fused_reference(prob, Xref, Uref, x0)
        sol_c, _ = tt.kernels.solve_fused_reference(prob_c, cpu(Xref),
                                                    cpu(Uref), cpu(x0))
        torch.cuda.synchronize()
        name = f"{label} cold B={B} ct={ct}"
        took_entries(admm_fused, name, {GROUP_FAM: 1})
        # The bar against the plain version on the CPU, on the lanes
        # whose counts agree; against the plain version on the card
        # (cuBLAS's summation order), the bar of its own spread from the
        # CPU.
        compare(torch, f"{name} vs plain(cpu)", on_cpu(sol_k), sol_c,
                lanes="same_iters")
        share, solved_tol, atol = spread_bars(
            name, *plain_spread(torch, sol_p, sol_c, everyone)[:3], B)
        compare(torch, name, sol_k, sol_p, res_k, res_p, atol=atol,
                lanes="same_iters", solved_tol=solved_tol, share=share)
        # Float64 witness: the kernel agrees with admm.solve in float64 on
        # as many counts as the plain version does, less WITNESS_SLACK.
        prob64 = make(100, ct, torch.float64)
        f64 = lambda a: None if a is None else a.double()
        it_64 = tt.solve(prob64, tt.init_state(prob64, (B,)), f64(Xref),
                         f64(Uref), f64(x0))[0].iter
        s_k64 = (sol_k.iter == it_64).float().mean().item()
        s_p64 = (sol_p.iter == it_64).float().mean().item()
        log(f"  {name}: identical counts with admm.solve float64: kernel "
            f"{s_k64:.5f}, plain {s_p64:.5f}")
        fail(name, s_k64 >= s_p64 - WITNESS_SLACK, f"kernel agrees with "
             f"the float64 solve on {s_k64:.4f} of counts, the plain "
             f"version on {s_p64:.4f}")
        # Warm: an external-plant sequence of 4 solves, the plant stepped
        # with the kernel's u0; each step held on the lanes that agree at
        # every step so far: to the bar against the plain version on
        # the CPU, and to the plain version's own spread on the card.
        c_k, c_p = tt.init_carry(prob, B), tt.init_carry(prob, B)
        c_c = tt.init_carry(prob_c, B)
        agreed = torch.ones(B, dtype=torch.bool, device=DEVICE)
        agreed_c, agreed_kc = everyone, everyone.clone()
        x = x0
        zero_entries(admm_fused)
        for step in range(4):
            sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, Uref, x,
                                                        c_k)
            sol_p, _, c_p = tt.kernels.solve_fused_warm_reference(
                prob, Xref, Uref, x, c_p)
            sol_c, _, c_c = tt.kernels.solve_fused_warm_reference(
                prob_c, cpu(Xref), cpu(Uref), cpu(x), c_c)
            torch.cuda.synchronize()
            name = f"{label} warm B={B} ct={ct} step {step}"
            before = agreed_kc.clone()
            sol_kc, c_kc = on_cpu(sol_k), on_cpu(c_k)
            agreed_kc &= sol_kc.iter == sol_c.iter
            compare(torch, f"{name} vs plain(cpu)", sol_kc, sol_c,
                    lanes=agreed_kc, among=before)
            compare_carry(torch, f"{name} vs plain(cpu)", c_kc, c_c,
                          agreed_kc)
            share_c, dsf_c, dval_c, held_c = plain_spread(
                torch, sol_p, sol_c, agreed_c, c_p, c_c)
            share, solved_tol, atol = spread_bars(name, share_c, dsf_c,
                                                  dval_c, B)
            before = agreed.clone()
            agreed &= sol_k.iter == sol_p.iter
            agreed_c = held_c
            compare(torch, name, sol_k, sol_p, atol=atol, lanes=agreed,
                    solved_tol=solved_tol, share=share, among=before)
            compare_carry(torch, name, c_k, c_p, agreed, atol=atol)
            x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
        took_entries(admm_fused, f"{label} warm B={B} ct={ct}",
                     {GROUP_FAM: 4})

    def time_cold(prob, Xref, Uref, x0, sol_k):
        """Kernel ms (CUDA events, median of REPS), the solve_fused call on
        the host clock, and the bound of this run's work."""
        tables, x0c, params = admm_fused._prepare(prob, Xref, Uref, x0)
        spec = prob.spec
        run = lambda: admm_fused._solve_kernel(tables, x0c, spec.N, spec.nx,
                                               spec.nu, **params)
        run()                                           # warm-up
        ms, times = cuda_ms(torch, run, REPS)
        call_ms = statistics.median(
            host_ms(torch, lambda: tt.kernels.solve_fused(prob, Xref, Uref,
                                                          x0))[0]
            for _ in range(REPS))
        iter_sum = int(sol_k.iter.sum().item())
        ops, nbytes = fused_work(spec.N, spec.nx, spec.nu, x0.shape[0],
                                 iter_sum, spec=spec)
        bound_ms, bound_by = bound(ops, nbytes, peak_flops, peak_bw)
        return ms, times, call_ms, bound_ms, bound_by, ops, nbytes

    def full_width_cold(label, prob, Xref, Uref, x0):
        """Drive a families cold batch through kernels.solve_fused with the
        counts at 0, check it (on the thread-group kernel's families
        entry), hold it against the plain version and time it. Returns the
        kernels-line numbers."""
        spec = prob.spec
        zero_counts(counters)
        sol_k, res_k = tt.kernels.solve_fused(prob, Xref, Uref, x0)
        torch.cuda.synchronize()
        launches = admm_fused.families_launch_count
        if launches < 1:
            raise AssertionError(f"{label} did not launch the families "
                                 "kernel")
        took_entries(admm_fused, label, {GROUP_FAM: launches})
        B = x0.shape[0]
        if sol_k.x.shape != (spec.N, B, spec.nx) or \
                sol_k.u.shape != (spec.N - 1, B, spec.nu):
            raise AssertionError(f"bad output shapes {sol_k.x.shape} "
                                 f"{sol_k.u.shape}")
        plain_ms, (sol_p, res_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_reference(prob, Xref, Uref,
                                                            x0))
        err = compare(torch, label, sol_k, sol_p, res_k, res_p)
        ms, times, call_ms, bound_ms, bound_by, ops, nbytes = time_cold(
            prob, Xref, Uref, x0, sol_k)
        iters = sol_k.iter.float()
        log(f"  {label}: families launches {launches}, kernel {ms:.4f} ms "
            f"(reps {[round(t, 4) for t in times]}), solve_fused call "
            f"{call_ms:.4f} ms on the host clock (kernel share "
            f"{ms / call_ms:.4f}), {B / (ms / 1e3):.1f} solves/s, mean "
            f"iters {iters.mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.1f} ms; card {card}")
        return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    # 10. rocket SOC cold batch at full width
    phase(f"phase 10: rocket SOC cold batch, B={FAM_B}, N={FAM_N}")
    t0 = time.perf_counter()
    prob = rocket_problem(tt, torch, 100, 1)
    setup_ms = 1e3 * (time.perf_counter() - t0)
    log(f"  setup -> with_bounds -> with_cones -> with_settings "
        f"{setup_ms:.1f} ms (set-up)")
    x0, Xref, Uref = rocket_inputs(torch, FAM_B)
    fam_rows = {"soc": full_width_cold("rocket SOC cold ct=1", prob, Xref,
                                       Uref, x0)}

    # 11. rocket SOC external-plant sequence, 5 warm solves
    phase(f"phase 11: rocket SOC external-plant sequence, B={FAM_B}, 5 warm "
        f"solves")
    c_k = tt.init_carry(prob, FAM_B)
    zero_counts(counters)
    states, sols = [], []
    x = x0
    for step in range(5):
        sol_k, _, c_k = tt.kernels.solve_fused_warm(prob, Xref, Uref, x, c_k)
        states.append(x)
        sols.append(sol_k)
        x = x @ prob.A.T + sol_k.u[0] @ prob.B.T + prob.f
    torch.cuda.synchronize()
    fam_warm_launches = admm_fused.families_warm_launch_count
    if fam_warm_launches < 5:
        raise AssertionError("the rocket SOC sequence did not launch the "
                             "warm families kernel")
    took_entries(admm_fused, "rocket SOC sequence",
                 {GROUP_FAM: fam_warm_launches})
    c_p = tt.init_carry(prob, FAM_B)
    agreed = torch.ones(FAM_B, dtype=torch.bool, device=DEVICE)
    err_fw = 0.0
    for step, (x_s, sol_k) in enumerate(zip(states, sols)):
        plain_fw_ms, (sol_p, _, c_p) = host_ms(
            torch, lambda: tt.kernels.solve_fused_warm_reference(
                prob, Xref, Uref, x_s, c_p))
        agreed &= sol_k.iter == sol_p.iter
        err_fw = max(err_fw, compare(torch, f"rocket SOC warm step {step}",
                                     sol_k, sol_p, lanes=agreed))
        log(f"  step {step}: mean iters "
            f"{sol_k.iter.float().mean().item():.4f}, solved frac "
            f"{sol_k.solved.float().mean().item():.5f}, mean altitude "
            f"{x_s[:, 2].mean().item():.4f}")
    compare_carry(torch, "rocket SOC after 5 steps", c_k, c_p, agreed)
    tables, xc, params = admm_fused._prepare(prob, Xref, Uref, x)
    carry = admm_fused._carry_tensors(prob, c_k, FAM_B)
    run = lambda: admm_fused._solve_kernel_warm(tables, xc, carry, FAM_N, 6,
                                                3, **params)
    sol_w = run()[0]                                    # warm-up
    fw_ms, times = cuda_ms(torch, run, REPS)
    call_ms = statistics.median(
        host_ms(torch, lambda: tt.kernels.solve_fused_warm(
            prob, Xref, Uref, x, c_k))[0] for _ in range(REPS))
    iter_sum = int(sol_w.iter.sum().item())
    ops, nbytes = fused_work(FAM_N, 6, 3, FAM_B, iter_sum,
                             lane_carry_floats(c_k), prob.spec)
    fw_bound_ms, fw_bound_by = bound(ops, nbytes, peak_flops, peak_bw)
    log(f"  rocket SOC solve_fused_warm (the sixth solve): kernel "
        f"{fw_ms:.4f} ms (reps {[round(t, 4) for t in times]}), whole call "
        f"{call_ms:.4f} ms on the host clock (kernel share "
        f"{fw_ms / call_ms:.4f}), plain {plain_fw_ms:.1f} ms, bound "
        f"{fw_bound_ms:.4f} ms ({fw_bound_by}; {nbytes / 1e6:.2f} MB), mean "
        f"iters {iter_sum / FAM_B:.4f}, solved frac "
        f"{sol_w.solved.float().mean().item():.5f}, "
        f"{FAM_B / (fw_ms / 1e3):.1f} solves/s, families warm launches "
        f"{fam_warm_launches}; card {card}")
    fam_rows["soc_warm"] = dict(launches=fam_warm_launches, err=err_fw,
                                ms=fw_ms, plain_ms=plain_fw_ms,
                                bound_ms=fw_bound_ms, bound_by=fw_bound_by)

    # 12. the hyperplane demos as cold batches at full width
    phase(f"phase 12: hyperplane demos, cold, B={FAM_B}, N={FAM_N}")
    x0, Xref, _ = quad_plane_inputs(torch, FAM_B)
    for kind in ("linear", "tv"):
        prob = quad_plane_problem(tt, torch, kind == "tv", 100, 1)
        fam_rows[kind] = full_width_cold(f"quadrotor {kind} cold ct=1", prob,
                                         Xref, None, x0)
    # The demos' ceilings do not bind at step 0; under phase 9's low
    # ceilings the state planes bite, held here to the bar at full width.
    for kind in ("linear", "tv"):
        prob = quad_plane_problem(tt, torch, kind == "tv", 100, 1,
                                  LOW_CEILING[kind])
        full_width_cold(f"quadrotor {kind} low ceilings cold ct=1", prob,
                        Xref, None, x0)
        # How many lanes the z ceiling binds on: a non-zero dual of the
        # state plane after a solve from a zero carry.
        c = tt.kernels.solve_fused_warm(prob, Xref, None, x0,
                                        tt.init_carry(prob, FAM_B))[2]
        dual = c.gl if kind == "linear" else c.gtv
        log(f"  quadrotor {kind} low ceilings: the z ceiling binds on "
            f"{(dual[:, 2].abs().amax(dim=0) > 0).float().mean().item():.5f}"
            f" of lanes")

    adapt_rows, ctx.tables = adaptive_phases(torch, tt, convert, admm_fused,
                                             counters, card, peak_flops,
                                             peak_bw)
    stream_rows = streamed_phases(ctx)
    cons_rows = consensus_phases(torch, tt, convert, admm_fused, counters,
                                 card, peak_flops, peak_bw)
    compact_rows = compaction_phases(ctx)
    adapt_fam_rows = adaptive_family_phases(ctx)
    adapt_stream_rows = adaptive_stream_phases(ctx)
    probe_rows = roofline_phase(ctx)
    fleet_rows = {"multi": cold_fleet_phase(ctx),
                  "multi_warm": warm_fleet_phase(ctx)}
    group_places_phase(ctx)
    cart_rows = cartpole_phases(ctx)
    dims_small_phase(ctx)
    cart_stream_rows = cartpole_kinds_phase(ctx)
    loop_rows = thread_loop_phases(ctx)

    if FAILURES:
        phase(f"{len(FAILURES)} comparison(s) missed their bar:")
        for f in FAILURES:
            log(f"  {f}")
        return 1

    # 46. kernels line, then the device line last
    phase("phase 46: kernels line")
    main_run, serve = regimes[(100, 25)], loops[(100, False)]
    rows = [("admm_group", "tinympc_tpu_torch/csrc/admm_group.cu",
             "tinympc_tpu/kernels/admm_pallas.py:387", main_run),
            ("admm_group_warm", "tinympc_tpu_torch/csrc/admm_group.cu",
             "tinympc_tpu/kernels/admm_pallas.py:387",
             dict(launches=warm_launches, err=err_warm, ms=warm_ms,
                  plain_ms=plain_ms, bound_ms=warm_bound_ms,
                  bound_by=warm_bound_by)),
            ("closed_loop_fused",
             "tinympc_tpu_torch/csrc/closed_loop_fused.cu",
             "tinympc_tpu/kernels/closed_loop_pallas.py:63", serve)]
    rows += [(f"admm_group_families_{key}",
              "tinympc_tpu_torch/csrc/admm_group.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", fam_rows[key])
             for key in ("soc", "soc_warm", "linear", "tv")]
    rows += [(f"admm_group_{key}", "tinympc_tpu_torch/csrc/admm_group.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", adapt_rows[key])
             for key in ("adaptive", "adaptive_warm")]
    rows += [(f"admm_group_{key}", "tinympc_tpu_torch/csrc/admm_group.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", cons_rows[key])
             for key in ("consensus", "consensus_warm")]
    rows += [("admm_fused_families_consensus",
              "tinympc_tpu_torch/csrc/admm_fused.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387",
              cons_rows["families_consensus"])]
    rows += [(f"admm_stream_{key}", f"tinympc_tpu_torch/csrc/{src}", rep,
              stream_rows[key])
             for key, src, rep in (
                 ("backward_team", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:121"),
                 ("backward_team_families", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:121"),
                 ("forward_team", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:258"),
                 ("forward_team_stale", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:258"),
                 ("forward_team_families", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:258"),
                 ("forward_team_families_stale", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:258"))]
    # The streamed consensus launches of phase 31, on the route the G=16
    # batch took (lane teams, csrc/admm_stream_team.cuh).
    rows += [(f"admm_stream_{key}", "tinympc_tpu_torch/csrc/"
              + ("admm_stream_team.cuh" if "_team" in key
                 else "admm_stream.cu"),
              "tinympc_tpu/kernels/admm_stream.py:"
              + ("121" if key.startswith("backward") else "258"), r)
             for key, r in compact_rows.items()]
    rows += [(f"admm_group_{key}", "tinympc_tpu_torch/csrc/admm_group.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", adapt_fam_rows[key])
             for key in ("adaptive_families", "adaptive_families_warm")]
    rows += [(f"admm_stream_{key}", f"tinympc_tpu_torch/csrc/{src}", rep,
              adapt_stream_rows[key])
             for key, src, rep in (
                 ("backward_team_adaptive", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:121"),
                 ("forward_team_adaptive", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:258"),
                 ("forward_team_adaptive_stale", "admm_stream_team.cuh",
                  "tinympc_tpu/kernels/admm_stream.py:258"),
                 ("backward_adaptive", "admm_stream.cu",
                  "tinympc_tpu/kernels/admm_stream.py:121"),
                 ("forward_adaptive", "admm_stream.cu",
                  "tinympc_tpu/kernels/admm_stream.py:258"),
                 ("forward_adaptive_stale", "admm_stream.cu",
                  "tinympc_tpu/kernels/admm_stream.py:258"))]
    rows += [(f"roofline_{key}", "tinympc_tpu_torch/csrc/roofline.cu", rep,
              probe_rows[key])
             for key, rep in (("dot_chained", "tools/roofline.py:59"),
                              ("dot_independent", "tools/roofline.py:59"),
                              ("elementwise", "tools/roofline.py:98"))]
    rows += [(f"admm_group_{key}", "tinympc_tpu_torch/csrc/admm_group.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", fleet_rows[key])
             for key in ("multi", "multi_warm")]
    # The one-thread kernels at cartpole's (4, 1): the resident solve of
    # phases 42-43 and the streamed launches of phase 45.
    rows += [(f"admm_fused_{key}", "tinympc_tpu_torch/csrc/admm_fused.cu",
              "tinympc_tpu/kernels/admm_pallas.py:387", cart_rows[key])
             for key in ("cartpole", "cartpole_warm")]
    rows += [(f"admm_stream_{key}", "tinympc_tpu_torch/csrc/admm_stream.cu",
              "tinympc_tpu/kernels/admm_stream.py:"
              + ("121" if key.startswith("backward") else "258"),
              cart_stream_rows[key])
             for key in ("backward_4x1", "forward_4x1", "forward_stale_4x1")]
    # The one-thread closed loop at the rocket's (6, 3) and cartpole's
    # (4, 1): the serving loops of phases 47-48.
    rows += [(f"closed_loop_thread_{key}",
              "tinympc_tpu_torch/csrc/closed_loop_thread.cu",
              "tinympc_tpu/kernels/closed_loop_pallas.py:63", loop_rows[key])
             for key in ("rocket", "cartpole")]
    # Each streamed row's ptxas line: the instantiation it measured spills
    # nothing.
    spills = 0
    for kname, _, _, _ in rows:
        if not kname.startswith("admm_stream_"):
            continue
        label = STREAM_PTXAS[kname[len("admm_stream_"):]]
        e = ctx.ptxas.get(label, {})
        ok = bool(e) and e.get("stack") == 0 and e.get("spill_st") == 0 \
            and e.get("spill_ld") == 0
        spills += not ok
        log(f"  {kname}: ptxas {label}: {e.get('regs')} registers, "
            f"{e.get('stack')} bytes stack frame, {e.get('spill_st')} / "
            f"{e.get('spill_ld')} bytes spill stores / loads"
            f"{'' if ok else ' -- MISSING OR SPILLS'}")
    if spills:
        log(f"{spills} streamed row(s) without a spill-free ptxas entry")
        return 1
    print(json.dumps({"kernels": [{
        "name": kname, "route": "cuda", "source": src, "replaces": rep,
        "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
    } for kname, src, rep, r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
