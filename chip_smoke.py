#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases (each raises on failure; nothing is caught):
  1. device: the card's name and power limit (nvidia-smi) and the TF32
     switches, which stay off;
  2. build: nvcc builds esdg_cns_tpu_torch/csrc/*.cu for sm_90a; prints the
     build time and ptxas' register/spill report of the N=3 hex kernels
     (K1 diag, general and curved; row 10), of K1 and row 10 curved
     at N=4 in f64, of K3 and the CNS kernels in every form, of K5 and of
     the Becker bisection; then one line per K1 instantiation (N+1 =
     2..8, three forms, two types), per K2 grid form (diag and general,
     on ph_qf and on the split parts) and of the split projection at
     N+1 = 2..8, and for K3 at each dim (and curved tris) on the paths'
     operator lists: the blocks and warps resident per SM
     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, exported by the
     library) beside the registers and spills;
  3. Euler kernels: K1 (euler_volume) and K2 (euler_surface, on gathered
     neighbour traces and in the grid form the paths run, which reads
     them itself) against their plain PyTorch versions on the card, at
     the main-path shapes (N=3, k1d=32, f32, axis-aligned) and at N=3,
     k1d=8 in f64 (axis-aligned and general); the general variant also on
     a seeded random non-diagonal affine metric (k1d=32 f32, k1d=8 f64),
     where no cross term is an exact zero;
  4. Euler path: presets.euler_hex_3d(3, 32, f32) -> make_euler_rhs_fused ->
     lsrk45 for 20 steps with every launch counter at 0 before; checks the
     state is finite, each kernel launched once per stage and no roll
     exchange or split combine run (their call counters), the update
     kernel (ops.lsrk45_update) launched once per stage, the state agrees
     with the plain twin make_euler_rhs(flux_diff_impl='lines') run from the
     same q0, and sum(wJq q) per field is conserved; then an f64 k1d=4
     entropy-conservation check (dissipation off) on the kernel path;
  5. Euler timing with CUDA events (medians of 5 repeats after warm-up): the
     rate in DOF*RK-stage/s (5 Np K stages / s, bench.py's definition) over
     1200 stages, the twin's rate over fewer stages, and per-kernel device
     times beside the plain versions, the stage's split and, no longer in
     the stage, the roll exchange and K2 on gathered traces; then
     torch.profiler over 20 stages:
     device time by kernel and the device's busy share; then the general
     contraction on the same uniform mesh (axis_aligned=False) timed
     beside the diag path, stage and kernels (the diag-vs-general delta);
     then LSRK45's update kernel against the plain two lines at each
     stage, bitwise, on the path's state and RHS in f32 and f64, and its
     device time a stage beside its bound (update_roofline's: 24 passes
     over the state in 5 stages) and the plain lines' five kernels;
  6. cavity kernels: K3 (euler_modal_volume) and K4 (cns_surface_viscous,
     both fold_tail forms) against their plain versions on seeded moving
     states (esdg_cns_tpu_torch.cavity_cases: velocity of standard
     deviation 0.3, so no velocity term multiplies zeros) at the cavity's
     shapes (tri N=3, k1d=128, f32, isothermal walls), and at k1d=8 in f64
     for every BC shape (isothermal, adiabatic, slip, an array lid profile,
     a Dirichlet region of seeded states, no BC, and all four kinds with
     array wall speeds and temperatures), and at k1d=5 (K=50, a ragged
     last tile);
  7. cavity path: presets.lid_driven_cavity(3, 128, f32) ->
     make_cns_rhs_affine (bench.py's flags) -> lsrk45 for 20 steps at
     dt=1e-4 with every launch counter at 0 before; checks K3 and K4
     launched once per stage, the state is finite f32, agrees with the twin
     make_cns_rhs run from the same q0, and conserves mass; then an f64
     k1d=8 entropy check (adiabatic walls at rest, rhstest on) on the kernel
     path;
  8. cavity timing: the rate in DOF*RK-stage/s (4 Np K stages / s,
     bench.py's cns definition) over 1200 stages at dt=1e-6, the twin's
     rate, K3 and K4 beside their plain versions, the two exchanges, the
     rest of the stage, and the profiler's split as in phase 5;
  9. 3D cavity kernels: K1 (in this use), K4 at dim=3 (both fold_tail
     forms), the tail kernel after it (cns_traction_tail, on every BC
     shape its rule covers), K8 (cns_surface) and K7 (cns_viscous)
     against their plain versions on the 3D cavity's moving states (hex
     N=3, k1d=16, f32, isothermal), at k1d=4 in f64 for every BC shape,
     and at k1d=3 (K=27, a ragged last tile); K8 and K7 also over the 2D
     cases of phase 6;
 10. 3D cavity path: presets.lid_driven_cavity_3d(3, 16, f32) ->
     make_cns_rhs_affine(volume_impl='fused_hex', bench.py's flags) ->
     lsrk45 for 20 steps at dt=1e-4 with every launch counter at 0 before;
     checks K1, K4 and the tail kernel launched once per stage, the state
     is finite f32 and agrees with the twin make_cns_rhs; the f64 kernel
     path (the tail kernel once per stage) conserves mass over 20 steps;
     an f64 k1d=4 entropy check (adiabatic walls, the lid at rest, rhstest
     on);
 11. 3D cavity timing, as phase 8: the rate over 1200 stages, the twin's,
     K1, K4 and the tail kernel beside their plain versions (the tail's:
     the exchange, stress_normal, the jump's LIFT and 1/J) and the tail's
     bound, the exchange, the profiler;
 12. the split path on both cavities at full width: surface_impl='fused'
     (K3 or K1, then K8, then K7) against merged_tail on one RHS (f32, and
     f64 at k1d=8 / k1d=4), 20 steps with every counter at 0 before (K8
     and K7 launched once per stage), the rate over 1200 stages, and K8
     and K7 beside their plain versions;
 13. curved Euler kernels: K1 on the curved metric (K1c) and K2 on curved
     normals against their plain versions on presets.euler_hex_3d(3, 32,
     curved=True) in f32 (the path's full width), at k1d=8 in f64 and at
     k1d=3 (K=27, a ragged tile) in both types;
 14. curved Euler path: euler_hex_3d(3, 32, curved=True, f32) ->
     make_euler_rhs_fused -> lsrk45 for 20 steps with every counter at 0
     before; checks K1 and K2 launched once per stage, the state is finite,
     agrees with the twin make_euler_rhs(flux_diff_impl='lines') and
     conserves sum(wJq q); free stream on the warped mesh (f64 k1d=8, a
     constant state); f64 k1d=4 rhstest with dissipation off; then the
     twin with flux_diff_impl='lines_pallas' (row 10) for 20 steps with
     the counters at 0 before: row 10 launched once per stage, the state
     agrees with the 'lines' twin; its rate;
 15. curved Euler timing, as phase 5: the rate over 1200 stages, K1c and
     K2 device times beside their plain versions, the profiler's split;
 16. flux-differencing kernels against their plain versions: row 10 on
     the curved and the uniform hex (N=3, k1d=32 f32; k1d=8 and k1d=3
     f64), K5 on the 2D cavity's shapes (tri N=3, k1d=128 f32), on a tri
     mesh curved by presets.square_warp and on a curved hex N=3 at k1d=4
     (f32, f64; tri k1d=5 and hex k1d=3 ragged), K3 on the curved tri mesh
     (K3c: k1d=128 f32, k1d=8 f64, k1d=5 ragged); device times of row 10,
     K5 and K3c at the full-width shapes;
 17. the cavity twin with flux_diff_impl='pallas' (K5; bench.py's flags)
     for 20 steps with the counters at 0 before: K5 launched once per
     stage, the state agrees with the 'xla' twin of phase 7; its rate;
 18. split volume kernels against their plain versions: the projection
     (hex_project), the per-direction fd (hex_fd_dir, d = 0, 1, 2; diag on
     the mesh's metric and general on a seeded random non-diagonal affine
     metric), its dense form (hex_fd_dir_dense) and K2 at N+1 = 8 (and 5,
     4) in five forms (ph_qf or the split parts, gathered or grid, the
     split grid form also general), at the N=7 path's shapes (k1d=16
     f32), the N=4 bench mesh (k1d=24 f32), the main path's mesh (N=3
     k1d=32 f32), and in f64 at N=4 k1d=4 and N=7 k1d=3 (K=27, a ragged
     tile); then the fd and its dense form at every N+1 = 2..8, f32 and
     f64, on K=27, on a moving state and at rest (every pair of equal
     states), diag and general on the mesh's metric, general and dense
     on a random one;
 19. the N=7 path: presets.euler_hex_3d(7, 16, f32) ->
     make_euler_rhs_fused(force_fused=True), which resolves to the split
     path ('auto', diag detected) -> lsrk45 for 20 steps at dt=2.5e-4 with
     every counter at 0 before: per stage the projection once, the fd once
     per direction, K2 once (the split form on the grid), K1 never, no
     roll exchange or combine; a finite f32 state that agrees with
     the twin make_euler_rhs(flux_diff_impl='lines') from the same q0;
     sum(wJq q) conserved; f64 k1d=3 rhstest with dissipation off;
 20. the N=4 volume modes on the bench mesh (N=4, k1d=24, f32): 'auto' (K1,
     joint_packed), 'split', 'split_pad8' and 'split_dense', each RHS
     against the 'auto' one on a moving state (f32, and f64 at k1d=4),
     then 20 steps of each with the counters at 0 before (launches per
     stage; no exchange or combine);
 21. split timing: the N=7 rate over 1200 stages, device times of the
     projection, each fd direction, the dense fd and K2 at N+1 = 8 beside
     their plain versions, the stage's split and, no longer in it, K2 on
     ph_qf, the combine and the exchange it replaced, the profiler's
     split;
     the four N=4 modes' rates over 600 stages, their stages queued
     ahead of the device and their volume stages'
     device times;
 22. K1 at N+1 = 6, the path JAX's 'auto' runs on it at N=5:
     presets.euler_hex_3d(5, 20, f32) (K=8000, 8.64M DOF) ->
     make_euler_rhs_fused ('auto' = joint_packed = K1, diag detected):
     K1 and K2 against their plain versions (f32 at full width; f64 at
     k1d=4 and k1d=3, K=27 ragged, diag and a random metric), lsrk45 for 20
     steps at dt=5e-4 with every counter at 0 before (K1 and K2 once per
     stage, nothing else, no exchange or combine), the twin make_euler_rhs(flux_diff_impl='lines'),
     conservation, f64 k1d=3 rhstest with dissipation off; the rate over
     1200 stages beside volume_mode='split' over 600 (one RHS of each
     agrees), K1's, the split volume stage's and K2's device times;
 23. the same for K1 at N+1 = 7: euler_hex_3d(6, 16, f32) (K=4096, 7.0M
     DOF) with force_fused=True, dt=4e-4;
 24. K1 at N+1 = 8: curved N=7 at k1d=8 under force_fused (K1c) and affine
     N=7 with volume_mode='joint' (diag), against their plain versions (f32
     at k1d=8; f64 at k1d=4 and k1d=3), one RHS each with the counters at
     0 before (K1 and K2 once, no exchange or combine), K1's device time;
 25. K1c at N+1 = 6: curved N=5 at k1d=16 against the plain version (f32;
     f64 at k1d=4 and 3), one RHS, K1c's device time, and the free stream
     of the f64 kernel path (max |dq| of a constant state) at k1d=8 and,
     beside the plain twin's, at k1d=16;
 26. the 3D Becker shock tube: presets.becker_shocktube_3d(5, 32)
     (32 x 8 x 8 hexes, 2.21M DOF, mu=0.01) ->
     make_cns_rhs_affine(volume_impl='fused_hex') (K1 at N+1 = 6, then K4
     at dim=3 with the exact wave's time-dependent Dirichlet ghosts) ->
     lsrk45 for 20 steps at the time step of esdg_cns_tpu/config.py's
     estimate_dt, in f32 and f64, each with every counter at 0 before (K1
     and K4 once per stage), against the twin make_cns_rhs, rhstest_visc
     >= 0; the f64 L2 error against the exact wave at k1d=16 and k1d=32 at
     one time, printed for mu=0.01 and required to fall for the resolved
     mu=0.1 wave; the f32 rate over 25 stages and the ghosts' time;
 27. the forms of the modal front: K3 at dim 1 and 3, K4 at (1, True) and
     (3, True) (both fold_tail forms), K7 at the same (contract True and
     False) and K8 at dim 1 against their plain versions, at the paths'
     shapes (line N=4 K=128 f64 and f32, the Becker tube's pool; hex N=3
     k1d=16 f32, the 3D cavity with the modal front), at ragged K (line
     K=37, hex K=27) and in f64 on the wall recipes and the 3D Becker
     tube; K7 contract=False also at the cavities' forms (2, True) and
     (3, False); the Becker bisection kernel against the eager loop on the
     1D and 3D tubes' face points (f32, f64: bitwise, or within an ulp
     with the cause printed) and its time per RHS beside the loop's;
 28. the 3D hex path through K3: lid_driven_cavity_3d(3, 16, f32) ->
     make_cns_rhs_affine(volume_impl='fused', bench.py's flags) -> lsrk45
     for 20 steps with every counter at 0 before (K3, K4 and the tail
     kernel once per stage, K1 never), finite and within 1e-5 of the
     twin; one RHS against fused_hex (f32 1e-5; f64 k1d=4 1e-9), the
     split form (K8, K7 at (3, True)) against merged_tail; f64 mass
     over 20 steps; the rate over 1200 stages, K3's, K4's and K7's device
     times (K3 also on the cavity at rest, beside row 12's divide chain on
     zero dividends and on x = 1), the profiler; the 3D Becker tube (N=2,
     k1d=8, f64) through 'fused' on one RHS against the twin
     (1e-10) and fused_hex (1e-9);
 29. the 1D path: becker_shocktube_1d(4, 128, f64) ->
     make_cns_rhs_affine(volume_impl='fused', compute_rhstest=False) (K3
     at dim 1, K4 at (1, True) merged_tail): one RHS against the twin
     (1e-10), dopri45 to t=0.005 at err_tol 1e-11 against the twin stepped
     the same way (1e-10, accepted steps equal or one apart: at that
     tolerance the error estimate is a few digits above the RHS's
     roundoff; K3 and K4 once per RHS),
     its host time per step and per RHS, the split path (K8, K7 at dim 1)
     against merged_tail; the device times of K3, K4, K7, K8 at dim 1 and
     of K7 contract=False at each form;
 30. the paper anchor on the card: through the phase-29 path, dopri45 at
     err_tol 1e-11 to T=0.1 at N=4, K=32, 64, 128, scored by
     verification.becker_errors, each of l1, l2, linf within 1% of
     results/paper_anchor_r05.json's row and the L2 rates above 4.5; the
     readings, accepted steps beside the artifact's and seconds per row;
     then verification.becker_shocktube_errors(2, 32) (the twin, as JAX
     runs it) against its row;
 31. the probes and the flux-differencing section (esdg_cns_tpu_torch/
     probes): each probe kernel against its plain version (the FMA chains
     to iters 2^-24, the other chains to 1e-5) and K1's fd section, its
     joint body and the split path's three hex_fd_dir launches, against
     the plain version at N+1 = 5, 6, 7 (f32 at the study's K = 13824,
     8000, 4096, diag and general; f64 at K=45); then, with the probes'
     counters at 0, the FMA rate at the TPU probes' defaults (refused
     outside 50-105% of 67 TFLOP/s), the divide's and every chain kind's
     cost in FMA issue slots, each probe's device time beside its plain
     version's, and the fd section's A/B: the joint body against the
     three launches and their assembly;
 32. with --parent DIR only (a checkout of the parent commit in a folder
     .gitignore lists): the parent tree's kernels and stages against this
     tree's on the same card, in turns (parent, new, new, parent): K1 in
     every form at the paths' shapes, K3 at each dim (the 3D cavity moving
     and at rest), K5, K4 in every form the paths run, K7 at dims 1, 2
     and 3, K8, rows 10 and 14, the split fd (4a diag and general, 4b) at
     N+1 = 5..8 in each direction, the projection (row 3) and K2 at
     every N+1 the paths run, on its own and against the parent's K2 with
     the exchange (and, after the split front, the combine) it took in,
     each pair held to each other, and the parent's roll exchange at N=3;
     the device-bound stages (Euler N=3, N=4 'auto', N=5, N=6, curved,
     N=7, 'split' at N=4, 5, 6, 'split_dense' at N=4) over 300 stages and
     the host-bound ones'
     device busy time,
     torch.profiler over 100 stages (both cavities' default forms, the 3D
     cavity's 'fused' form, Becker 3D, the 1D anchor path), their wall
     clock beside it; a line names each one more than 2% slower than the
     parent's.
A kernel's time is its device time: the timed calls are queued behind a
sleeping kernel, so the host's dispatch does not enter it.
The Becker bisection's time per RHS is printed apart: it replaces no TPU
kernel.  The line before the last is {"kernels": [...]} with each
kernel's bound (the larger of its bytes over 3.35 TB/s and its operations,
an FMA two, over 67 TFLOP/s in f32 or 34 in f64, from this run's shapes
and the entries of its operators that the function needs) and, for the
f32 rows, its priced bound (the operations by kind at the costs phase 31
measured: the larger of the bytes leg and sum n_kind slots_kind over the
FMA rate); the last line is {"ok": true, "device": {...}}.
The elapsed time at each phase goes to stderr.  Without a CUDA device it exits non-zero and prints no
result: there is no CPU path.
"""

import collections
import json
import re
import statistics
import subprocess
import sys
import time
import types

# the Euler path: N=3, k1d=32 (K=32768, 10.5M DOF), f32
N, K1D, STEPS, DT = 3, 32, 20, 1e-3
TIMED_STEPS, TWIN_TIMED_STEPS, REPEATS = 240, 5, 5
# the cavity path: tri N=3, k1d=128 (K=32768, 1.31M DOF), f32
CAV_N, CAV_K1D, CAV_STEPS, CAV_DT = 3, 128, 20, 1e-4
CAV_TIMED_DT = 1e-6        # timing run, as bench.py's
# the 3D cavity path: hex N=3, k1d=16 (K=4096, 1.31M DOF), f32; the same
# steps and time steps as the 2D cavity
CAV3_N, CAV3_K1D = 3, 16
# kernel vs plain, max |kernel - plain| / max |plain|: the kernels sum in
# another order than the plain version and contract multiply-adds into
# FMAs, and libdevice's log/exp/pow differ from PyTorch's by an ulp or two
TOL = {"float32": 1e-5, "float64": 1e-12}
# after 20 steps (100 stages), max |fused - twin| / max |twin| in f32:
# per-stage RHS differences of ~1e-6 relative, times dt, over 100 stages
TWIN_TOL_F32 = 1e-5
# |change of sum(wJq q_f)| over 20 steps / sum(wJq rho), f32 state updates:
# the runs read <= 1.9e-10 (roundoff of the f32 updates); the limit leaves
# a factor 50 and fails a leak of 1e-10 per stage over the 100 stages
CONSERVATION_TOL_F32 = 1e-8
# f64 entropy balance with dissipation off (k1d=4)
RHSTEST_TOL_F64 = 1e-10
# free stream on the warped hex mesh, f64 k1d=8: max |dq| of a constant
# state, every term of which cancels through the curl-form metric identity
# (about 1e-13 at k1d=2 on the CPU; the residual grows like 1/h and with N:
# on the CPU the plain RHS reads 2.5e-12 at N=3 k1d=8, 4.3e-11 at N=5 k1d=8
# and 1.66e-10 at N=5 k1d=16, as the JAX package's does)
FREESTREAM_TOL_F64 = 1e-10
# where that floor passes the tolerance, the kernel path's residual against
# the plain twin's on the same mesh
FREESTREAM_TWIN_FACTOR = 2.0
# the split path (K8 then K7) against the merged kernel (K4) on one RHS,
# max |split - merged| / max |merged|: the same arithmetic in two kernels
SPLIT_TOL = {"float32": 1e-5, "float64": 1e-12}
# cavity mass, |change of sum(wJq rho)| / sum(wJq rho) over 20 steps.  The
# walls carry no mass flux and rho+ = rho- on them, so the RHS conserves
# mass to roundoff: in f64 (the kernel path at k1d=128) the drift must
# stay at roundoff.  In f32 the state starts at rest and most nodes get
# increments below half an ulp of rho, which round away coherently (4.3e-8
# at k1d=128 on an H100; the f32 twin's drift is printed beside it), so the
# f32 limit lies between that reading and the coherent worst case of 100
# stages x 2^-24: 100 times looser than the 1e-8 first asked of f32, which
# the f64 limit carries instead.
CAV_MASS_TOL_F64 = 1e-12
CAV_MASS_TOL_F32 = 1e-6
# device-only timing: the stream sleeps this many cycles (about 0.1 s at
# the H100's clock) while the host queues the timed calls behind it
SLEEP_CYCLES = 200_000_000
# the N=7 path (split volume): N=7, k1d=16 (K=4096, Np=512, 10.5M DOF),
# f32; the time step scales the N=3 path's 1e-3 by the h/N^2 limit
# (about 0.37 of it at k1d=16) with margin
N7, N7_K1D, N7_DT = 7, 16, 2.5e-4
# the N=4 bench mesh of the volume-mode comparison: k1d=24 (K=13824,
# 8.64M DOF), f32
N4, N4_K1D = 4, 24
N4_MODES = ("auto", "split", "split_pad8", "split_dense")
# the four N=4 modes (and 'split' at N=5, 6) are timed over 120 steps (600
# stages) each, median of REPEATS: at 1200 stages 'split' and 'split_pad8'
# (the same kernels) read 0.03% apart, at 240 stages 10% apart
N4_TIMED_STEPS = 120
# K1 at N+1 = 6, 7 on the Euler paths JAX runs on it: N=5 at k1d=20
# (K=8000, Np=216, 8.64M DOF: the N=4 bench mesh's DOF) under 'auto', and
# N=6 at k1d=16 (K=4096, 7.0M DOF) under force_fused, f32; their time
# steps scale the N=3 path's 1e-3 by the h/N^2 limit with margin
N5, N5_K1D, N5_DT = 5, 20, 5e-4
N6, N6_K1D, N6_DT = 6, 16, 4e-4
# K1 at N+1 = 8 (curved N=7 under force_fused, affine N=7 with
# volume_mode='joint') and K1c at N+1 = 6 (curved N=5)
N7_K1_K1D, CURVED_N5_K1D = 8, 16
# the 3D Becker shock tube (presets.becker_shocktube_3d, mu=0.01): N=5,
# k1d=32 (32 x 8 x 8 = 2048 hexes, 2.21M DOF) through fused_hex
BECKER_N, BECKER_K1D = 5, 32
# the accuracy check's wave: the JAX package's accuracy tests' (mu = 0.1),
# which k1d=16 and 32 resolve; the default mu = 0.01 shock they do not
BECKER_ACCURACY_MU = 0.1
# f64 kernel path against the f64 twin after 20 steps (100 stages): one
# RHS agrees to ~1e-13 of max |dq|, and the stages add dt times that
TWIN_TOL_F64 = 1e-10
# phases 27-30, the modal front (K3) on lines and hexes: the 3D cavity's
# mesh through volume_impl='fused' (hex N=3, k1d=16, f32) and the 1D Becker
# tube of the paper's anchor (line N=4, K=128, f64); the line path steps
# with dopri45 to LINE_T at the anchor's err_tol
LINE_N, LINE_K, LINE_T = 4, 128, 0.005
# dopri45 on the kernel path and on the twin at err_tol 1e-11: the
# accepted counts one apart at most (phase 29 says why), the states within
# TWIN_TOL_F64
DOPRI_STEP_SLACK = 1
# the fused front against fused_hex on the 3D cavity, one RHS: f32 at full
# width, and f64 at k1d=4 to the TPU package's own limit between these
# fronts (tests/test_cns_fused.py:48-67; Vq Pq = I only up to roundoff)
FRONT_TOL = {"float32": 1e-5, "float64": 1e-9}
# the 3D Becker tube in f64 through 'fused' (N=2, k1d=8), one RHS: against
# the twin to the TPU package's limit between the affine and twin paths
# (tests/test_cns_fused.py:42), against fused_hex as FRONT_TOL
BECKER3D_FUSED = (2, 8)
# the paper anchor (results/paper_anchor_r05.json, the reference 1D
# driver's Mach-3 tube, N=4, T=0.1, err_tol 1e-11, f64): each of l1, l2,
# linf within 1% of the artifact's row, and the L2 rates above 4.5, as
# tests/test_paper_anchor.py:43 requires of the artifact
ANCHOR_FILE = "results/paper_anchor_r05.json"
ANCHOR_N, ANCHOR_KS, ANCHOR_T, ANCHOR_ERR_TOL = 4, (32, 64, 128), 0.1, 1e-11
ANCHOR_REL, ANCHOR_MIN_RATE = 0.01, 4.5
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
# operations/s outside the tensor cores in float32 and float64
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# phase 31, the probes at the TPU probes' defaults (examples/vpu_peak.py
# ITERS, BLOCKS, REPS, INNER_LO, INNER_HI)
PROBE_ITERS, PROBE_BLOCKS, PROBE_REPS, PROBE_INNER = 512, 64, 3, (4, 24)
# the FMA probe reads between these shares of FP32_OPS_PER_S or it is
# refused: under half it measures latency, not throughput; above the
# data sheet it measures nothing real
FMA_SHARE = (0.50, 1.05)
# row 11 kernel vs plain, max |kernel - plain| / max |plain|: the map's
# factor 0.999998 keeps the chain's roundings (fmaf rounds once, the plain
# multiply and add twice), so they add up over the chain: iters 2^-24.
# The contracting chains (factor 0.97, div, log, exp, rsqrt, sqrt, mul)
# and add (the same f32 additions in the same order): TOL["float32"]
PEAK_TOL_PER_ITER = 2.0 ** -24
# row 14's A/B at the study's size (N=4 at k1d=24) and at the orders of
# the 'split' question (N=5 at k1d=20, N=6 at k1d=16): (N+1, K)
FD_SECTION_CASES = ((5, 13824), (6, 8000), (7, 4096))
# its f64 check, at a small K with a ragged tile
FD_SECTION_F64_K = 45
def becker_dt(n, k1d, cfl=0.5):
    """The time step of esdg_cns_tpu/config.py's estimate_dt for a CNS run
    on hexes: cfl h / C_N with C_N = 3 (N+1)(N+2)/2 and h = 2 / k1d,
    capped by the parabolic limit 2 / (C_N k1d^2)."""
    cn = 3.0 * (n + 1) * (n + 2) / 2
    return min(cfl * (2.0 / k1d) / cn, 2.0 / (cn * k1d * k1d))


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b):
    """(max|a - b| / max|b|, max|a - b|)."""
    d = float((a - b).abs().max())
    return d / float(b.abs().max()), d


def cuda_ms(fn, n_calls, repeats=REPEATS, device_only=False):
    """Median over repeats of the mean per-call time of fn, CUDA events.

    device_only: queue the calls behind a sleeping kernel, so the events
    bracket the device's work alone and not the host's dispatch."""
    import torch

    fn()   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n_calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n_calls)
    return statistics.median(times)


def device_profile(fn, stages):
    """torch.profiler (CUDA activity) over one call of fn: (device busy
    ms, window ms from the first kernel's start to the last one's end,
    [(kernel, device ms)] by total time), per stage; None when the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    by_name = {}
    for e in evs:
        name = e.name.split("(")[0].replace("void ", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return (busy / 1e3 / stages, window / 1e3 / stages,
            [(n, us / 1e3 / stages) for n, us in top])


def print_profile(card, label, prof):
    if prof is None:
        print(f"[{card}] {label} profile: not measured (the profiler "
              "recorded no device activity)")
        return
    busy, window, top = prof
    print(f"[{card}] {label} profile (torch.profiler, 20 stages): device "
          f"busy {busy:.4f} of {window:.4f} ms/stage ({busy / window:.1%})")
    for name, ms in top[:8]:
        print(f"    {ms:.4f} ms/stage  {name}")


T_START = time.perf_counter()


def stamp(phase):
    """The script's elapsed time at the start of a phase, on stderr."""
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s at phase "
          f"{phase}", file=sys.stderr, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# Operations per element, counted by hand from the sources at the shapes
# they are given, by kind (Ops).  The data-sheet bound weighs an FMA two
# operations and every other kind one (so the bound is a floor); an
# operator product over the operator's entries that the function needs
# (entries(op)): all of them on the tri, one node line per point on the
# Gauss-collocated hex (N+1 of each row of Ef, of each column of LIFT, of
# each row of a derivative); each two-point flux pair counted ONCE (the
# triangular form, the least work).  Each pointwise count (split) keeps
# its hand total in that weighing, with the divisions, logs, exps, powers
# and square roots the source does and the FMAs and multiplies it shows;
# add takes the rest of the total.
# Pair costs: the 3D EC pair with one metric direction (diag) 74, five
# of them divisions (ec_pair_n: the two logarithmic means' v, rho's mean,
# beta's reciprocal mean, the pressure average; the two series terms
# v / 448 are multiplies by 1/448, common.cuh); the
# general 3-term contraction adds the two other directional fluxes (12)
# and two more metric terms per field (20): 106; a curved metric adds the
# pairwise average of the three terms (6): 112.  The 2D EC pair with both
# directions, the metric contraction and both rows' accumulation 85; a
# curved metric adds the average of the four operator-metric terms (8).
# The 1D pair (two logarithmic means, one direction, one metric term, both
# rows' accumulation) 55.
KINDS = ("fma", "mul", "add", "div", "log", "exp", "sqrt", "rsqrt", "pow")


class Ops(dict):
    """Operation counts by kind (KINDS); + adds, * scales by an integer."""

    def __init__(self, **counts):
        unknown = set(counts) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown operation kinds {sorted(unknown)}")
        super().__init__({k: counts.get(k, 0) for k in KINDS})

    def __add__(self, other):
        return Ops(**{k: self[k] + other[k] for k in KINDS})

    def __mul__(self, n):
        return Ops(**{k: self[k] * n for k in KINDS})

    __rmul__ = __mul__

    def flops(self):
        """The data-sheet count: an FMA two operations, any other one."""
        return sum(self.values()) + self["fma"]


def split(total, fma=0, mul=0, **special):
    """A hand total by kind: the special functions and FMAs given, then
    the multiplies given as far as the total allows, add the rest."""
    rest = total - 2 * fma - sum(special.values())
    if rest < 0:
        raise ValueError(f"the kinds exceed the hand total {total}")
    mul = min(mul, rest)
    return Ops(fma=fma, mul=mul, add=rest - mul, **special)


PAIR_3D = {"diag": split(74, fma=11, mul=29, div=5),
           "general": split(106, fma=23, mul=37, div=5),
           "curved": split(112, fma=23, mul=40, div=5)}
PAIR_MODAL = {1: split(55, fma=15, mul=16, div=5),
              2: split(85, fma=29, mul=22, div=5),
              3: PAIR_3D["general"]}
PAIR_TRI_CURVED = split(93, fma=29, mul=26, div=5)
# pow is libdevice's expansion, exp(y log x) with corrections: priced as a
# log, an exp and a multiply
POW_PARTS = ("log", "exp", "mul")


Bound = collections.namedtuple("Bound", "ms by n_bytes ops dtype")


def bound(n_bytes, ops, dtype):
    """The data-sheet floor: the larger of bytes over the HBM peak and
    operations (FMA two, every other kind one) over the peak of the dtype
    (FP32_OPS_PER_S or FP64_OPS_PER_S).  Keeps what priced_bound needs."""
    name = str(dtype).replace("torch.", "")
    if name not in ("float32", "float64"):
        raise ValueError(f"bound: dtype {dtype}")
    peak = FP64_OPS_PER_S if name == "float64" else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops.flops() / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return Bound(max(t_bytes, t_ops), by, n_bytes, ops, name)


def priced_ms(ops, slots, fma_per_s):
    """The operations' time at the card's measured costs: sum of n_kind
    slots_kind over the FMA rate (FMA/s); an FMA is one slot, pow a log,
    an exp and a multiply."""
    price = dict(slots, fma=1.0)
    price["pow"] = sum(price[k] for k in POW_PARTS)
    return sum(n * price[k] for k, n in ops.items() if n) / fma_per_s * 1e3


def priced_bound(b, slots, fma_per_s):
    """The larger of the bytes leg and the priced operation time; None
    for float64 (the probes are f32, as the TPU ones are)."""
    if b.dtype != "float32":
        return None
    return max(b.n_bytes / HBM_BYTES_PER_S * 1e3,
               priced_ms(b.ops, slots, fma_per_s))


def line_pairs(n1):
    """Pairs of the line loop per element: the triangular vol-vol pairs of
    each line and its two vol-face couplings, over 3 directions."""
    return 3 * n1 * n1 * (n1 * (n1 - 1) // 2 + 2 * n1)


def entries(op):
    """Entries of an operator that its product needs: those above its
    roundoff (1e-12 of its largest).  The hex line operators hold exact
    zeros only up to roundoff of the 1D interpolation."""
    a = op.abs()
    return int((a > 1e-12 * a.max()).sum())


def ops_project(n1, ef_entries):
    """The entropy projection of K1 and row 3: v(U) at the volume nodes
    (ten divisions, three logs), Ef v, and U(v_f) with the flux variables
    and logs at the face points (two pows, an exp, eight divisions, two
    logs)."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return (split(27, fma=3, mul=9, div=10, log=3) * nq
            + Ops(fma=ef_entries * 5)
            + split(40, fma=4, mul=12, div=8, log=2, exp=1, pow=2) * nfq)


def ops_k1(n1, ef_entries, lift_entries, form="diag"):
    """K1: the projection, the pairs at the form's cost, the face rows'
    1/wf, LIFT over each point's lines and 2 (1/wq) acc + 2 LIFT."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return (ops_project(n1, ef_entries) + PAIR_3D[form] * line_pairs(n1)
            + Ops(mul=5) * nfq + Ops(fma=lift_entries * 5)
            + split(15, fma=5, mul=6) * nq)


def ops_k2(n1, lift_entries, diag=True, split_form=False):
    """At every face node the EC pair (five divisions, as PAIR_3D's),
    both sides' conservative states, both wave speeds (three divisions
    and a square root each) and LF; the general form adds the two other
    directional fluxes (12), two more normal terms per field (20) and the
    3-component normal velocity of both sides (8), and reads 1/sj where
    diag divides.  The split form
    adds the combine: 2 (1/wf) face rows at each face node, and at each
    volume node 2 (1/wq) times the three parts' sum where ph_qf was
    read."""
    nq, nfq = n1 ** 3, 6 * n1 * n1
    face = (split(120, fma=22, mul=52, div=14, sqrt=2) if diag
            else split(160, fma=38, mul=60, div=13, sqrt=2))
    if split_form:
        face = face + Ops(fma=5, mul=1)
    node = split(26, fma=5, mul=6) if split_form else split(15, mul=5)
    return face * nfq + Ops(fma=lift_entries * 5) + node * nq


def ops_lines(n1, curved):
    """Row 10: the line loop alone (general contraction) on given flux
    variables, and the doubling of 2 QF."""
    nh = n1 ** 3 + 6 * n1 * n1
    return (PAIR_3D["curved" if curved else "general"] * line_pairs(n1)
            + Ops(mul=5) * nh)


def tri_pairs(nq, nh):
    return nq * (nq - 1) // 2 + nq * (nh - nq)


def needed_pairs(q_skew, nq):
    """The pairs i < j of K3's sum that the data needs: those with an
    operator entry of any direction above roundoff (1e-12 of the largest),
    the zero face-face block left out.  Every pair on the tri and the line;
    on the collocated hex only the pairs of a node line."""
    a = q_skew.abs()
    nz = (a > 1e-12 * a.max()).any(0)
    nz[nq:, nq:] = False
    return int(nz.triu(1).sum())


def ops_k3(dim, vq, vhp, ph, q_skew, nq, curved=False):
    """K3 per element: the three operator products over the entries they
    need (Vq, Vh Pq and Ph: each full on lines and tris, the identity and
    one node line per face point on the collocated hex), v(U) (3 + dim
    divisions, two logs) and U(v) (4 + dim divisions, two pows, an exp,
    two logs) with the flux variables and logs at each point, and the
    pairs the data needs at the dim's pair cost (curved tris: 93)."""
    nf, nh = dim + 2, vhp.shape[0]
    np_ = ph.shape[0]
    pair = PAIR_TRI_CURVED if curved else PAIR_MODAL[dim]
    return (Ops(fma=nf * (entries(vq) + entries(vhp) + entries(ph)))
            + split(10 + 5 * dim, fma=dim, mul=5 + dim, div=3 + dim,
                    log=2) * nq
            + split(30 + 5 * dim, fma=2 * dim - 2, mul=11, div=4 + dim,
                    log=2, exp=1, pow=2) * nh
            + pair * needed_pairs(q_skew, nq) + Ops(mul=nf) * np_)


def ops_dense_2d(nq, nh, curved):
    """K5 in 2D: K3's pair cost on the triangular pair count, and the
    doubling of 2 QF."""
    pair = PAIR_TRI_CURVED if curved else PAIR_MODAL[2]
    return pair * tri_pairs(nq, nh) + Ops(mul=4) * nh


def line_metric_bytes(n1, k, itemsize):
    """The curved metric values the line loop needs: rows 3d..3d+2 at the
    N+1 volume points and the two face points of each line (864 of the
    1440 per element at N=3)."""
    return 3 * n1 * n1 * 3 * (n1 + 2) * k * itemsize


def ops_face(dim, rebuild_local):
    """One face node of the CNS surface stage: the traces rebuilt (the
    neighbour's conservative (one division) and entropy ones, with
    rebuild_local the local ones too), the BC ghosts and ghost logs, the
    EC pair (five divisions, as PAIR_3D's) and its dim directions
    contracted with the normal, LF (two wave speeds: two divisions and a
    square root each), the entropy BC, the jump and the penalty rows (two
    divisions)."""
    nf = dim + 2
    cons = split(3 * dim + 4, fma=dim, mul=dim + 4, div=1)
    evars = split(3 * dim + 7, fma=dim + 1, mul=dim + 3)
    rebuild = (cons + evars) * (2 if rebuild_local else 1)
    ghosts = split(7 * dim + 2, fma=2 * dim - 1, log=2)
    pair = split(34 + 4 * dim + dim * (2 * dim + 2 + 2 * nf),
                 fma=7 + 2 * dim + (dim - 1) * nf, mul=2, div=5)
    lf = split(4 * dim + 19 + 3 * nf, fma=2 * (dim - 1) + nf, div=4,
               sqrt=2)
    return (rebuild + ghosts + pair + lf + Ops(add=nf)
            + split(4 * dim + 6, div=2) + Ops(add=nf))


def ops_visc(dim, nq, nfq, front, vqlift, ef, drpq):
    """One element of the viscous mid-section, each contraction formed
    once (the kernels repeat some per node; the bound counts what the
    function needs): the front product; the surface gradient term
    (0.5·dv·nxj once per face node, then its lift); per quadrature node
    the gradients, K(v) (83 operations in 2D, 190 in 3D; two divisions)
    and the production; the contracted traction; the divergence (g_r =
    Σ_x geo[r,x]·σ_x once per node, then the D_r Pq products).  front,
    vqlift, ef and drpq are the operators the kernels take."""
    nf = dim + 2
    sigma = {1: 20, 2: 83, 3: 190}[dim]
    front = Ops(fma=entries(front) * nf)
    surface = (Ops(fma=dim * entries(vqlift) * nf)
               + Ops(mul=nfq * nf * (1 + dim)))
    node = (Ops(fma=nf * dim * (dim - 1), mul=2 * nf * dim, add=nf * dim)
            + split(sigma, div=2) + split(3 * dim * nf, fma=dim * nf))
    traction = Ops(fma=dim * nf * entries(ef) + nfq * dim * nf)
    div = (Ops(fma=dim * (dim - 1) * nf * nq, mul=dim * nf * nq)
           + Ops(fma=entries(drpq) * nf))
    return front + surface + node * nq + traction + div


def ops_k4(dim, np_, nq, nfq, k4args, lift):
    """The tail-folded form (merged_tail), as the cavity paths run it;
    k4args are K4's positional arguments (the operators are the last
    four), lift the tail's LIFT."""
    fold = (Ops(fma=2 * (dim + 2) * entries(lift))
            + Ops(add=6 * (dim + 2) * np_))
    return (ops_face(dim, True) * nfq
            + ops_visc(dim, nq, nfq, *k4args[-4:]) + fold)


def ptxas_report(log):
    """ptxas' register/spill lines of the kernels worth watching, from the
    build log: the N=3 hex kernels (K1 diag, general and curved; row
    10), K1 and row 10 curved at N=4 in f64, K1 at N = 5, 6, 7 in every
    form and type (a line of a curved f64 thread is more than its 255
    registers hold; K2's, the projection's and the split fd's are in
    their shape lines), K3 at every dim and form, the CNS kernels, K5 and
    the Becker bisection, the fd section at N+1 = 5, 6, 7 and the probes.
    A spill line counts only under its own entry's "Function properties"
    (not under a device function's, such as libdevice's pow)."""
    out, entry, props = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, props = line, None
            continue
        if "Function properties for" in line:
            props = line.split("for", 1)[1].strip()
            continue
        if not entry or not ("registers" in line or "spill" in line):
            continue
        if "spill" in line and (props is None or props not in entry):
            continue
        report = line.split("ptxas info    :")[-1].strip()
        name = entry.split("'")[1] if "'" in entry else entry
        kind = next((k for k in ("hex_volume", "hex_surface", "hex_lines",
                                 "hex_project", "hex_fd_dir",
                                 "modal_volume", "dense_fd",
                                 "cns_surface_viscous", "cns_surface",
                                 "cns_viscous", "cns_tail", "becker_bisect",
                                 "fd_section", "probe_peak", "probe_chain")
                     if k + "_kernel" in name), None)
        if kind is None:
            continue
        form = name.split("kernel", 1)[1]
        prec = "f64" if form.startswith("Id") else "f32"
        flags = [b == "1" for b in re.findall(r"Lb([01])E", form)]
        ints = re.findall(r"Li(\d+)E", form)
        if kind == "fd_section":
            out.append(f"ptxas N+1={ints[0]} {kind} {prec} "
                       f"{'diag' if flags[0] else 'general'}: {report}")
            continue
        if kind.startswith("probe_"):
            out.append(f"ptxas {kind}" + (f" kind {ints[0]}" if ints else "")
                       + f": {report}")
            continue
        if kind in ("hex_surface", "hex_project", "hex_fd_dir", "cns_tail"):
            continue    # in their shape lines (kernel_shapes)
        if kind.startswith("hex_"):
            if kind == "hex_volume":
                variant = ("diag" if flags[0] else
                           "curved" if flags[1] else "general")
            else:
                variant = "curved" if flags[0] else "affine"
            if kind == "hex_volume" and ints and ints[0] in ("6", "7", "8"):
                out.append(f"ptxas N={int(ints[0]) - 1} {kind} {prec} "
                           f"{variant}: {report}")
            elif "Li4E" in form:
                out.append(f"ptxas N=3 {kind} {prec} {variant}: {report}")
            elif "Li5E" in form and prec == "f64" and variant == "curved":
                out.append(f"ptxas N=4 {kind} {prec} {variant}: {report}")
        elif kind == "dense_fd":
            dim = re.search(r"Li([123])E", form).group(1)
            out.append(f"ptxas dense_fd {dim}D {prec} "
                       f"{'curved' if flags[0] else 'affine'}, operators in "
                       f"{'global' if flags[1] else 'shared'} memory: "
                       f"{report}")
        else:
            dim = re.search(r"Li([123])E", form)
            dim = f" {dim.group(1)}D" if dim else ""
            if kind == "modal_volume":      # <T, DIM, CURVED, OPS_GLOBAL>
                variant = ((" curved" if flags[0] else "")
                           + (", operators in global memory" if flags[1]
                              else ""))
            elif kind in ("cns_surface_viscous", "cns_viscous"):
                # <T, DIM, PROJ, OPS_SMEM>: dense operators at dims 1 and
                # 2, their lists at dim 3
                held = "lists" if dim.strip() == "3D" else "operators"
                variant = ((" proj" if flags[0] else " no proj")
                           + f", {held} in "
                           + ("shared" if flags[1] else "global")
                           + " memory")
            else:
                variant = ""
            out.append(f"ptxas {kind}{dim} {prec}{variant}: {report}")
    return out


def modal_phases(c):
    """Phases 27-30: the modal front K3 on lines and hexes and the forms of
    K4, K7 and K8 it leads to; the 3D cavity's mesh and the 1D Becker tube
    through make_cns_rhs_affine(volume_impl='fused'); the paper anchor.
    c: the main phases' helpers (dev, card, zero_counts, read_counts, held,
    cavity_kernels, dev_ms, kernel_times, path_timing, mass).  Returns the
    kernels line's rows of the new forms and the bisection's times."""
    import numpy as np
    import torch

    from esdg_cns_tpu_torch.cavity_cases import (becker_case, cavity_case,
                                                 k7_inputs)
    from esdg_cns_tpu_torch.ops import becker_bisect as bb
    from esdg_cns_tpu_torch.ops import cns_surface as cs
    from esdg_cns_tpu_torch.ops import modal_volume as mv
    from esdg_cns_tpu_torch.ops import surface_viscous as sv
    from esdg_cns_tpu_torch.presets import (becker_shocktube_1d,
                                            becker_shocktube_3d,
                                            lid_driven_cavity_3d)
    from esdg_cns_tpu_torch.solvers import make_cns_rhs, make_cns_rhs_affine
    from esdg_cns_tpu_torch.timestepping import dopri45, lsrk45
    from esdg_cns_tpu_torch.verification import (becker_dt0,
                                                 becker_shocktube_errors)

    dev, card, held = c.dev, c.card, c.held
    f32, f64 = torch.float32, torch.float64
    name_of = lambda dt: str(dt).replace("torch.", "")

    # ---- 27. the kernel forms against their plain versions ----
    stamp("27")

    def modal_kernels(disc, q, bc, p, tag):
        """The kernels of the modal front (phase 6's checks with proj, K7
        in both contract forms), the Becker ghosts at t > 0."""
        errs, ins, _ = c.cavity_kernels(disc, q, bc, p, tag, t=0.003,
                                        proj=True, contracts=(True, False))
        return errs, ins

    # the path shapes: the line at the anchor's K=128 (f64, the path's
    # type, and f32), the hex cavity at k1d=16 with the modal front (f32)
    lerrs, lins = modal_kernels(
        *becker_case(1, LINE_N, LINE_K, f64, dev),
        f"line N={LINE_N} K={LINE_K} f64 Becker (1D path)")
    modal_kernels(*becker_case(1, LINE_N, LINE_K, f32, dev),
                  f"line N={LINE_N} K={LINE_K} f32 Becker")
    hcase = cavity_case("isothermal", CAV3_N, CAV3_K1D, f32, dev, dim=3)
    herrs, hins = modal_kernels(
        *hcase, f"hex N={CAV3_N} k1d={CAV3_K1D} f32 isothermal, modal "
        "front (3D fused path)")
    # small f64 cases: every wall kind, the Becker pools, ragged tiles
    for dt in (f64, f32):
        modal_kernels(*becker_case(1, LINE_N, 37, dt, dev),
                      f"line N={LINE_N} K=37 (ragged) {name_of(dt)} Becker")
        modal_kernels(*becker_case(1, 3, 5, dt, dev, wall=True),
                      f"line N=3 K=5 {name_of(dt)} walls")
        modal_kernels(*cavity_case("mixed", CAV3_N, 3, dt, dev, dim=3),
                      f"hex N={CAV3_N} k1d=3 (K=27, ragged) {name_of(dt)} "
                      "mixed walls")
        modal_kernels(*becker_case(3, 2, BECKER3D_FUSED[1], dt, dev),
                      f"hex N=2 k1d={BECKER3D_FUSED[1]} {name_of(dt)} "
                      "Becker")
    modal_kernels(*cavity_case("mixed", CAV3_N, 4, f64, dev, dim=3),
                  f"hex N={CAV3_N} k1d=4 f64 mixed walls")
    # K7 contract=False at the cavities' forms, (2, True) and (3, False)
    uncontracted = {}
    for dim, k1d in ((2, CAV_K1D), (3, CAV3_K1D)):
        for case, size, dt in (("isothermal", k1d, f32),
                               ("mixed", 8 if dim == 2 else 4, f64),
                               ("mixed", 5 if dim == 2 else 3, f64)):
            d, q, bc, p = cavity_case(case, 3, size, dt, dev, dim=dim)
            a7, kw7 = k7_inputs(d, q, bc, p)
            kw7["contract"] = False
            if dim == 3:
                kw7["lists"] = make_cns_rhs_affine(
                    d, volume_impl="fused_hex", mu=p["mu"], pr=p["pr"],
                    re=p["re"], bc=bc, compute_rhstest=False).visc_lists
            err = held(f"K7 cns_viscous ({dim}, {dim == 2}) contract=False",
                       f"{case} k1d={size} {name_of(dt)}",
                       sv.cns_viscous(*a7, **kw7),
                       sv.cns_viscous_plain(*a7, **kw7), TOL[name_of(dt)],
                       ("s_f", "div", "prod", "vuq"))
            if size == k1d:
                uncontracted[dim, dim == 2] = (a7, kw7, err)
    uncontracted[1, True] = (*lins["k7_components"],
                             lerrs["k7_components"])
    uncontracted[3, True] = (*hins["k7_components"],
                             herrs["k7_components"])

    # the bisection kernel against the eager loop on the tubes' face points
    bisect_times = {}
    for label, make, size in (
            (f"1D N={LINE_N} K={LINE_K}", becker_shocktube_1d,
             dict(n=LINE_N, k=LINE_K)),
            (f"3D N={BECKER_N} k1d={BECKER_K1D}", becker_shocktube_3d,
             dict(n=BECKER_N, k1d=BECKER_K1D))):
        for dt in (f32, f64):
            disc, _, _, shock = make(**size, dtype=dt, device=dev)
            xi = disc.xf[0] - float(shock.v_inf) * 0.037
            kw = shock.bisection(dt)
            got, ref = bb.becker_bisect(xi, **kw), bb.becker_bisect_plain(
                xi, **kw)
            torch.cuda.synchronize()
            ne = int((got != ref).sum())
            ulp = torch.finfo(dt).eps * ref.abs()
            worst = float(((got - ref).abs() / ulp).max())
            print(f"Becker bisection {label} {name_of(dt)} ({xi.numel()} "
                  f"face points): {ne} differ from the eager loop, at most "
                  f"{worst:.2f} ulp")
            if worst > 1.0:
                raise AssertionError("the bisection kernel departs from the "
                                     "eager loop by more than an ulp")
            if ne:
                print("    cause: libdevice's log against PyTorch's, "
                      "an ulp apart, flips a comparison near the root")
            if dt == f32:
                continue
            k_ms = cuda_ms(lambda: bb.becker_bisect(xi, **kw), 20)
            e_ms = cuda_ms(lambda: bb.becker_bisect_plain(xi, **kw), 2)
            g_ms = cuda_ms(lambda: shock.conservative_torch(disc.xf[0],
                                                            0.037), 20)
            bisect_times[label] = (k_ms, e_ms, g_ms)
            print(f"[{card}] Becker ghosts {label} f64, per RHS: bisection "
                  f"kernel {k_ms:.4f} ms, eager loop {e_ms:.4f} ms "
                  f"({e_ms / k_ms:.1f}x); the whole exact state "
                  f"(conservative_torch) {g_ms:.4f} ms; host clock, CUDA "
                  "events")

    # ---- 28. the 3D hex path through K3 ----
    stamp("28")
    hdisc, hq0, hbc, hp = lid_driven_cavity_3d(CAV3_N, CAV3_K1D, dtype=f32,
                                               device=dev)
    hflags = dict(mu=hp["mu"], pr=hp["pr"], re=hp["re"], bc=hbc,
                  inviscid_dissipation=True, viscous_dissipation=True,
                  compute_rhstest=False)
    mrhs = make_cns_rhs_affine(hdisc, volume_impl="fused", **hflags)
    stages = 5 * CAV_STEPS
    c.zero_counts()
    mqf, _ = lsrk45(mrhs, hq0, CAV_DT, CAV_STEPS)
    torch.cuda.synchronize()
    counts = {k: v for k, v in c.read_counts().items() if v}
    print(f"3D cavity fused path (K3 dim 3, then K4 (3, True)): {CAV_STEPS} "
          f"LSRK45 steps ({stages} stages) at dt={CAV_DT:g}, launches "
          f"{counts}")
    want = {"euler_modal_volume": stages, "cns_surface_viscous": stages,
            "cns_traction_tail": stages, "lsrk45_update": stages}
    if counts != want:
        raise AssertionError(f"expected launches {want} on the fused 3D "
                             "path, K1 none")
    hex_launches = counts
    if not bool(torch.isfinite(mqf).all()):
        raise AssertionError("3D fused-path state not finite")
    hqt, _ = lsrk45(make_cns_rhs(hdisc, **hflags), hq0, CAV_DT, CAV_STEPS)
    e_tw, _ = rel_err(mqf, hqt)
    print(f"3D cavity fused vs twin make_cns_rhs after {CAV_STEPS} steps: "
          f"rel {e_tw:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_tw <= TWIN_TOL_F32:
        raise AssertionError("3D fused path disagrees with the twin")
    del hqt, mqf
    for cd, tag in ((hcase, f"k1d={CAV3_K1D} f32"),
                    (cavity_case("isothermal", CAV3_N, 4, f64, dev, dim=3),
                     "k1d=4 f64")):
        d, q, bc, p = cd
        fl = dict(hflags, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc)
        a = make_cns_rhs_affine(d, volume_impl="fused", **fl)(q)[0]
        b = make_cns_rhs_affine(d, volume_impl="fused_hex", **fl)(q)[0]
        e, _ = rel_err(a, b)
        tol = FRONT_TOL[name_of(q.dtype)]
        print(f"3D cavity fused vs fused_hex, one RHS on a moving state, "
              f"{tag}: rel {e:.3e} (tol {tol:.0e})")
        if not e <= tol:
            raise AssertionError("the fused front disagrees with fused_hex")
        if q.dtype == f32:
            split = make_cns_rhs_affine(d, volume_impl="fused",
                                        surface_impl="fused", **fl)
            c.zero_counts()
            e, _ = rel_err(split(q)[0], a)
            counts = {k: v for k, v in c.read_counts().items() if v}
            print(f"3D cavity fused split path (K8, then K7 (3, True)) vs "
                  f"merged_tail, one RHS {tag}: rel {e:.3e} (tol "
                  f"{SPLIT_TOL['float32']:.0e}), launches {counts}")
            if not (e <= SPLIT_TOL["float32"] and counts.get("cns_viscous")
                    == 1 and counts.get("cns_surface") == 1):
                raise AssertionError("3D fused split path disagrees")
            split_launches = counts
    d64, q64, bc64, p64 = lid_driven_cavity_3d(CAV3_N, CAV3_K1D, dtype=f64,
                                               device=dev)
    q64f, _ = lsrk45(make_cns_rhs_affine(
        d64, volume_impl="fused", **dict(hflags, bc=bc64)), q64, CAV_DT,
        CAV_STEPS)
    drift = abs(c.mass(d64, q64f) - c.mass(d64, q64)) / c.mass(d64, q64)
    print(f"3D cavity fused path f64 mass |d sum(wJq rho)| / sum(wJq rho) "
          f"after {CAV_STEPS} steps: {drift:.2e} (tol "
          f"{CAV_MASS_TOL_F64:.0e})")
    if not drift <= CAV_MASS_TOL_F64:
        raise AssertionError("3D fused path does not conserve mass")
    del d64, q64, q64f
    hdof = 5 * hdisc.np_ * hdisc.num_elements
    mstage_ms, _ = c.path_timing(
        "3D cavity fused path (K3+exchange+K4+exchange+LIFT, LSRK45)", mrhs,
        hq0, hdof, None)
    a3, kw3 = hins["front"]
    h4a, h4t, h4kw = hins["k4"]
    kl3 = k3_lists(mv, a3, kw3)
    k3_call = lambda: mv.euler_modal_volume(*a3, **kw3, lists=kl3)
    k4_call = lambda: sv.cns_surface_viscous(*h4a, *h4t, fold_tail=True,
                                             **h4kw)
    times = c.kernel_times(f"hex N={CAV3_N} k1d={CAV3_K1D} f32", [
        ("K3 euler_modal_volume dim=3", k3_call,
         lambda: mv.euler_modal_volume_plain(*a3, **kw3)),
        ("K4 cns_surface_viscous (3, True) fold_tail", k4_call,
         lambda: sv.cns_surface_viscous_plain(*h4a, *h4t, fold_tail=True,
                                              **h4kw))])
    # K3's time on the path's own state (the cavity at rest) beside the
    # moving state's above
    a3r = (hq0, *a3[1:])
    rest_ms = c.dev_ms(lambda: mv.euler_modal_volume(*a3r, **kw3,
                                                     lists=kl3), 20)
    print(f"[{card}] K3 euler_modal_volume dim=3 on the cavity at rest (the "
          f"path's state): {rest_ms:.4f} ms, device time")
    # the gap's cause (PERF.md §7): an f32 IEEE division with a zero
    # dividend leaves the divider's fast path.  The chain a <- x / (a + c)
    # divides zero at every step when x = 0 (row 12's kernel)
    from esdg_cns_tpu_torch.probes import transcendental as tr
    xs = {x0: torch.full((8 * 512, 1024), x0, dtype=f32, device=dev)
          for x0 in (0.0, 1.0)}
    div_ms = {x0: c.dev_ms(lambda x=x: tr.chain(x, "div", PROBE_ITERS), 5)
              for x0, x in xs.items()}
    print(f"[{card}] the div chain ({PROBE_ITERS} steps, 8 x 512 x 1024 "
          f"f32): zero dividends {div_ms[0.0]:.4f} ms, x = 1 "
          f"{div_ms[1.0]:.4f} ms ({div_ms[0.0] / div_ms[1.0]:.2f}x)")
    del xs
    mdev_ms = c.dev_ms(lambda: lsrk45(mrhs, hq0, CAV_TIMED_DT, 10), 1) / 50
    print(f"[{card}] 3D cavity fused stage device time (queued ahead of the "
          f"device): {mdev_ms:.4f} ms of {mstage_ms:.4f} ms")
    print_profile(card, "3D cavity fused path", device_profile(
        lambda: lsrk45(mrhs, hq0, CAV_TIMED_DT, 4), 20))
    ne = hdisc.num_elements
    k3o, k4o = k3_call(), k4_call()
    rows = [("euler_modal_volume_dim3", "modal_volume_dim3.cu",
             "pallas_modal_volume.py:45", hex_launches["euler_modal_volume"],
             herrs["front"], *times["K3 euler_modal_volume dim=3"],
             bound(nbytes(*a3[:6], *k3o),
                   ops_k3(3, hdisc.vq, hdisc.vhp, hdisc.ph, a3[2],
                                hdisc.nq) * ne,
                   a3[0].dtype)),
            ("cns_surface_viscous_dim3_proj", "cns_surface_viscous_dim3.cu",
             "pallas_viscous.py:152", hex_launches["cns_surface_viscous"],
             herrs["k4"], *times["K4 cns_surface_viscous (3, True) "
                                 "fold_tail"],
             bound(nbytes(*h4a, *h4t, *k4o),
                   ops_k4(3, hdisc.np_, hdisc.nq, hdisc.nfq, h4a, h4t[1])
                   * ne,
                   h4a[0].dtype))]
    every = (hdisc.nq * (hdisc.nq - 1) // 2
             + hdisc.nq * (hdisc.nh - hdisc.nq))
    every_ms = every * PAIR_MODAL[3].flops() * ne / FP32_OPS_PER_S * 1e3
    print(f"K3 dim=3 bound: {needed_pairs(a3[2], hdisc.nq)} pairs per element "
          f"carry an operator entry above roundoff (the line-sparse Q_r), "
          f"bound {rows[0][-1].ms:.4f} ms by {rows[0][-1].by}; counting "
          f"every pair of the dense sum ({every}, the TPU kernel's "
          f"triangular form) at {PAIR_MODAL[3].flops()} operations would "
          f"give {every_ms:.4f} ms")
    a7, kw7 = hins["k7"]
    k7_ms, k7_pms = c.kernel_times(f"hex N={CAV3_N} k1d={CAV3_K1D} f32", [
        ("K7 cns_viscous (3, True)", lambda: sv.cns_viscous(*a7, **kw7),
         lambda: sv.cns_viscous_plain(*a7, **kw7))])["K7 cns_viscous (3, "
                                                     "True)"]
    rows.append(("cns_viscous_dim3_proj", "cns_viscous_dim3.cu",
                 "pallas_viscous.py:131", split_launches["cns_viscous"],
                 herrs["k7"], k7_ms, k7_pms,
                 bound(nbytes(*a7, *sv.cns_viscous(*a7, **kw7)),
                       ops_visc(3, hdisc.nq, hdisc.nfq, *a7[6:10]) * ne,
                       a7[0].dtype)))
    del k3o, k4o, mrhs
    # the 3D Becker tube in f64 through 'fused', one RHS
    bn, bk = BECKER3D_FUSED
    bdisc, bq0, bbc, bshock = becker_shocktube_3d(bn, bk, dtype=f64,
                                                  device=dev)
    bflags = dict(mu=bshock.mu, pr=bshock.pr, bc=bbc,
                  inviscid_dissipation=True, compute_rhstest=False)
    got = make_cns_rhs_affine(bdisc, volume_impl="fused", **bflags)(bq0,
                                                                    0.01)[0]
    e_tw, _ = rel_err(got, make_cns_rhs(bdisc, **bflags)(bq0, 0.01)[0])
    e_hex, _ = rel_err(got, make_cns_rhs_affine(
        bdisc, volume_impl="fused_hex", **bflags)(bq0, 0.01)[0])
    print(f"Becker 3D N={bn} k1d={bk} f64 'fused', one RHS at t=0.01: vs "
          f"twin rel {e_tw:.3e} (tol {TWIN_TOL_F64:.0e}), vs fused_hex rel "
          f"{e_hex:.3e} (tol {FRONT_TOL['float64']:.0e})")
    if not (e_tw <= TWIN_TOL_F64 and e_hex <= FRONT_TOL["float64"]):
        raise AssertionError("the 3D Becker tube through 'fused' disagrees")

    # ---- 29. the 1D path ----
    stamp("29")
    ldisc, lq0, lbc, lshock = becker_shocktube_1d(LINE_N, LINE_K, dtype=f64,
                                                  device=dev)
    lflags = dict(mu=lshock.mu, pr=lshock.pr, bc=lbc,
                  inviscid_dissipation=True, compute_rhstest=False)
    lrhs = make_cns_rhs_affine(ldisc, volume_impl="fused", **lflags)
    ltwin = make_cns_rhs(ldisc, **lflags)
    c.zero_counts()
    a = lrhs(lq0, 0.01)[0]
    counts = {k: v for k, v in c.read_counts().items() if v}
    e, _ = rel_err(a, ltwin(lq0, 0.01)[0])
    print(f"1D Becker N={LINE_N} K={LINE_K} f64 'fused' (merged_tail), one "
          f"RHS at t=0.01 vs twin: rel {e:.3e} (tol {TWIN_TOL_F64:.0e}), "
          f"launches {counts}")
    if not (e <= TWIN_TOL_F64 and counts == {"euler_modal_volume": 1,
                                             "cns_surface_viscous": 1}):
        raise AssertionError("the 1D fused path disagrees with the twin")
    c.zero_counts()
    bb.becker_bisect.launches = 0
    dt0 = becker_dt0(LINE_N, LINE_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qk, sk = dopri45(lrhs, lq0, LINE_T, dt0, err_tol=ANCHOR_ERR_TOL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    line_launches = {k: v for k, v in c.read_counts().items() if v}
    n_bisect = bb.becker_bisect.launches
    n_steps = sk["n_accepted"] + sk["n_rejected"]
    n_rhs = 1 + 6 * n_steps
    qt, st = dopri45(ltwin, lq0, LINE_T, dt0, err_tol=ANCHOR_ERR_TOL)
    e, _ = rel_err(qk, qt)
    print(f"1D path dopri45 to t={LINE_T} (err_tol {ANCHOR_ERR_TOL:g}): "
          f"{sk['n_accepted']} accepted, {sk['n_rejected']} rejected "
          f"(twin {st['n_accepted']}, {st['n_rejected']}); last step size "
          f"{sk['dt']:.6e} (twin {st['dt']:.6e}); launches "
          f"{line_launches}, bisection {n_bisect}; vs twin "
          f"rel {e:.3e} (tol {TWIN_TOL_F64:.0e})")
    # at err_tol 1e-11 the error estimate lies a few digits above the two
    # RHS's difference (about 2e-11 of max |dq|), so their step sizes part
    # and the last step before t_end can fall either side of it: the
    # accepted counts may differ by one, the states may not
    if not (e <= TWIN_TOL_F64
            and abs(sk["n_accepted"] - st["n_accepted"]) <= DOPRI_STEP_SLACK
            and line_launches == {"euler_modal_volume": n_rhs,
                                  "cns_surface_viscous": n_rhs}):
        raise AssertionError("the 1D dopri45 run disagrees with the twin")
    print(f"[{card}] 1D path dopri45: {1e3 * wall / n_steps:.4f} ms per "
          f"step ({n_steps} steps, {n_rhs} RHS: {1e3 * wall / n_rhs:.4f} ms "
          "per RHS), host clock; one synchronisation per step")
    ldev = c.dev_ms(lambda: lrhs(lq0, 0.01), 1)
    print(f"[{card}] 1D RHS queued ahead of the device: {ldev:.4f} ms")
    c.zero_counts()
    sa = make_cns_rhs_affine(ldisc, volume_impl="fused", surface_impl="fused",
                             **lflags)(lq0, 0.01)[0]
    split_counts = {k: v for k, v in c.read_counts().items() if v}
    e, _ = rel_err(sa, a)
    print(f"1D split path (K8, then K7 (1, True)) vs merged_tail, one RHS: "
          f"rel {e:.3e} (tol {SPLIT_TOL['float64']:.0e}), launches "
          f"{split_counts}")
    if not (e <= SPLIT_TOL["float64"] and split_counts.get("cns_surface") == 1
            and split_counts.get("cns_viscous") == 1):
        raise AssertionError("the 1D split path disagrees")
    a3, kw3 = lins["front"]
    l4a, l4t, l4kw = lins["k4"]
    a7, kw7 = lins["k7"]
    a8, kw8 = lins["k8"]
    kl3 = k3_lists(mv, a3, kw3)
    ltimes = c.kernel_times(f"line N={LINE_N} K={LINE_K} f64", [
        ("K3 euler_modal_volume dim=1",
         lambda: mv.euler_modal_volume(*a3, **kw3, lists=kl3),
         lambda: mv.euler_modal_volume_plain(*a3, **kw3)),
        ("K4 cns_surface_viscous (1, True) fold_tail",
         lambda: sv.cns_surface_viscous(*l4a, *l4t, fold_tail=True, **l4kw),
         lambda: sv.cns_surface_viscous_plain(*l4a, *l4t, fold_tail=True,
                                              **l4kw)),
        ("K7 cns_viscous (1, True)", lambda: sv.cns_viscous(*a7, **kw7),
         lambda: sv.cns_viscous_plain(*a7, **kw7)),
        ("K8 cns_surface dim=1", lambda: cs.cns_surface(*a8, **kw8),
         lambda: cs.cns_surface_plain(*a8, **kw8))])
    lk = ldisc.num_elements
    rows += [
        ("euler_modal_volume_dim1", "modal_volume_dim1.cu",
         "pallas_modal_volume.py:45", line_launches["euler_modal_volume"],
         lerrs["front"], *ltimes["K3 euler_modal_volume dim=1"],
         bound(nbytes(*a3[:6], *mv.euler_modal_volume(*a3, **kw3,
                                                      lists=kl3)),
               ops_k3(1, ldisc.vq, ldisc.vhp, ldisc.ph, a3[2],
                            ldisc.nq) * lk,
               a3[0].dtype)),
        ("cns_surface_viscous_dim1", "cns_surface_viscous_dim1.cu",
         "pallas_viscous.py:152", line_launches["cns_surface_viscous"],
         lerrs["k4"], *ltimes["K4 cns_surface_viscous (1, True) fold_tail"],
         bound(nbytes(*l4a, *l4t, *sv.cns_surface_viscous(
             *l4a, *l4t, fold_tail=True, **l4kw)),
             ops_k4(1, ldisc.np_, ldisc.nq, ldisc.nfq, l4a, l4t[1]) * lk,
               l4a[0].dtype)),
        ("cns_viscous_dim1", "cns_viscous_dim1.cu", "pallas_viscous.py:131",
         split_counts["cns_viscous"], lerrs["k7"],
         *ltimes["K7 cns_viscous (1, True)"],
         bound(nbytes(*a7, *sv.cns_viscous(*a7, **kw7)),
               ops_visc(1, ldisc.nq, ldisc.nfq, *a7[6:10]) * lk,
               a7[0].dtype)),
        ("cns_surface_dim1", "cns_surface.cu", "pallas_cns_surface.py:155",
         split_counts["cns_surface"], lerrs["k8"],
         *ltimes["K8 cns_surface dim=1"],
         bound(nbytes(*a8, *cs.cns_surface(*a8, **kw8)),
               ops_face(1, False) * ldisc.nfq * lk,
               a8[0].dtype))]
    # K7 contract=False: the slowest of its four forms in the line
    utimes = {}
    for (dim, proj), (a7, kw7, err) in sorted(uncontracted.items()):
        label = f"K7 cns_viscous ({dim}, {proj}) contract=False"
        utimes[dim, proj] = (*c.kernel_times(
            f"K={a7[0].shape[-1]} {name_of(a7[0].dtype)}",
            [(label, lambda: sv.cns_viscous(*a7, **kw7),
              lambda: sv.cns_viscous_plain(*a7, **kw7))])[label], err)
    (udim, uproj), (ums, upms, uerr) = max(utimes.items(),
                                           key=lambda kv: kv[1][0])
    a7, kw7, _ = uncontracted[udim, uproj]
    d7 = a7[0]
    rows.append((f"cns_viscous_uncontracted ({udim}, {uproj})",
                 f"cns_viscous{'' if udim == 2 else f'_dim{udim}'}.cu",
                 "pallas_viscous.py:131", 0, uerr, ums, upms,
                 bound(nbytes(*a7, *sv.cns_viscous(*a7, **kw7)),
                       ops_visc(udim, kw7["nq"], a7[1].shape[1], *a7[6:10])
                       * d7.shape[-1],
                       a7[0].dtype)))
    del lrhs, ltwin, qk, qt

    # ---- 30. the paper anchor on the card ----
    stamp("30")
    with open(ANCHOR_FILE) as fh:
        art = {(r["n"], r["k"]): r for r in json.load(fh)["rows"]}
    got = {}
    for k in ANCHOR_KS:
        c.zero_counts()
        t0 = time.perf_counter()
        got[k] = becker_shocktube_errors(
            ANCHOR_N, k, ANCHOR_T, ANCHOR_ERR_TOL, dtype=f64, device=dev,
            volume_impl="fused")
        sec = time.perf_counter() - t0
        ref = art[ANCHOR_N, k]
        counts = {kk: v for kk, v in c.read_counts().items() if v}
        rels = {key: abs(got[k][key] - ref[key]) / ref[key]
                for key in ("l1", "l2", "linf")}
        print(f"[{card}] paper anchor N={ANCHOR_N} K={k} (K3 dim 1 + K4 (1, "
              f"True), dopri45 err_tol {ANCHOR_ERR_TOL:g} to "
              f"T={ANCHOR_T}): l1 {got[k]['l1']:.6e}, l2 {got[k]['l2']:.6e},"
              f" linf {got[k]['linf']:.6e}; artifact {ref['l1']:.6e}, "
              f"{ref['l2']:.6e}, {ref['linf']:.6e} (rel "
              + ", ".join(f"{rels[key]:.2e}" for key in rels)
              + f", tol {ANCHOR_REL:g}); accepted {got[k]['n_accepted']} "
              f"(artifact {ref['n_accepted']}); {sec:.1f} s; launches "
              f"{counts}")
        if not all(r <= ANCHOR_REL for r in rels.values()):
            raise AssertionError(f"the anchor row K={k} departs from "
                                 f"{ANCHOR_FILE}")
        if set(counts) != {"euler_modal_volume", "cns_surface_viscous"}:
            raise AssertionError("the anchor did not run on K3 and K4")
    rates = [float(np.log2(got[a]["l2"] / got[b]["l2"]))
             for a, b in zip(ANCHOR_KS, ANCHOR_KS[1:])]
    print(f"paper anchor N={ANCHOR_N} L2 rates "
          + ", ".join(f"{r:.4f}" for r in rates)
          + f" (> {ANCHOR_MIN_RATE}); artifact "
          + ", ".join(f"{art[ANCHOR_N, k]['l2_rate']:.4f}"
                      for k in ANCHOR_KS[1:]))
    if not min(rates) > ANCHOR_MIN_RATE:
        raise AssertionError("the anchor's L2 rates fall short")
    t0 = time.perf_counter()
    twin = becker_shocktube_errors(2, 32, ANCHOR_T, ANCHOR_ERR_TOL,
                                   dtype=f64, device=dev)
    ref = art[2, 32]
    rels = {key: abs(twin[key] - ref[key]) / ref[key]
            for key in ("l1", "l2", "linf")}
    print(f"[{card}] becker_shocktube_errors(2, 32) (the twin, as JAX runs "
          f"it): l1 {twin['l1']:.6e}, l2 {twin['l2']:.6e}, linf "
          f"{twin['linf']:.6e}, accepted {twin['n_accepted']} (artifact "
          f"{ref['n_accepted']}); rel " + ", ".join(
              f"{rels[key]:.2e}" for key in rels)
          + f" (tol {ANCHOR_REL:g}); {time.perf_counter() - t0:.1f} s")
    if not all(r <= ANCHOR_REL for r in rels.values()):
        raise AssertionError("the twin's N=2 K=32 row departs from the "
                             "artifact")
    return rows, bisect_times


def probe_phases(c):
    """Phase 31: the throughput probes (rows 11-13) and K1's
    flux-differencing section in its two bodies (row 14).  Each kernel is
    first held against its plain version (those launches are not
    counted); then, with the probes' counters at 0, the probes measure
    the FMA rate and the slots of every kind at the TPU probes' defaults
    and row 14's A/B times both bodies: the launches of that run are the
    rows' launches.  c: dev, card, dev_ms.  Returns (rows, slots,
    fma_per_s): the kernels line's rows and the prices of priced_bound."""
    import numpy as np
    import torch

    from esdg_cns_tpu_torch.ops import fused_volume as fv
    from esdg_cns_tpu_torch.probes import divide, peak
    from esdg_cns_tpu_torch.probes import fd_section as fs
    from esdg_cns_tpu_torch.probes import transcendental as tr
    from esdg_cns_tpu_torch.probes.timing import spread

    stamp("31")
    dev, card, dev_ms = c.dev, c.card, c.dev_ms
    iters, blocks, reps = PROBE_ITERS, PROBE_BLOCKS, PROBE_REPS
    lo, hi = PROBE_INNER
    f32, f64 = torch.float32, torch.float64
    probes = {"fma_peak": peak.fma_peak, "divide.chain": divide.chain,
              "transcendental.chain": tr.chain,
              "fd_section": fs.fd_section, "hex_fd_dir": fv.hex_fd_dir}

    # ---- kernel vs plain, on seeded inputs (launches not counted) ----
    rng = np.random.default_rng(31)
    seeded = lambda rows: torch.as_tensor(
        1.0 + 0.5 * rng.random((blocks * rows, 1024)), dtype=f32, device=dev)
    errs = {}

    def check(label, kern, plain, tol):
        torch.cuda.synchronize()
        e, a = rel_err(kern, plain)
        print(f"{label}: kernel vs plain rel {e:.3e} (tol {tol:.1e})")
        if not e <= tol:
            raise AssertionError(f"{label} disagrees with its plain version")
        errs[label] = a

    x = seeded(peak.BS[0])
    check(f"row 11 fma_peak iters={iters}", peak.fma_peak(x, iters),
          peak.fma_peak_plain(x, iters), iters * PEAK_TOL_PER_ITER)
    for kind in divide.DIVIDE_KINDS:
        check(f"row 12 divide.chain {kind}", divide.chain(x, kind, iters),
              divide.chain_plain(x, kind, iters), TOL["float32"])
    x = seeded(tr.BS[0])
    for kind in tr.KINDS:
        check(f"row 13 transcendental.chain {kind}",
              tr.chain(x, kind, iters), tr.chain_plain(x, kind, iters),
              TOL["float32"])
    del x
    fd_cases = {}
    for n1, k in FD_SECTION_CASES:
        for diag in (True, False):
            args = fs.as_tensors(fs.study_inputs(n1, k, diag), dev)
            kw = dict(n1=n1, diag=diag)
            plain = fs.fd_section_plain(*args, 1.4, **kw)
            form = "diag" if diag else "general"
            for body, fn in (("joint", fs.fd_section),
                             ("split", fs.fd_section_split)):
                check(f"row 14 fd_section {body} N+1={n1} K={k} f32 {form}",
                      fn(*args, 1.4, **kw), plain, TOL["float32"])
            fd_cases[n1, k, diag] = args
            del plain
    for n1, _ in FD_SECTION_CASES:
        for diag in (True, False):
            args = fs.as_tensors(fs.study_inputs(n1, FD_SECTION_F64_K, diag,
                                                 dtype=np.float64), dev)
            kw = dict(n1=n1, diag=diag)
            plain = fs.fd_section_plain(*args, 1.4, **kw)
            for body, fn in (("joint", fs.fd_section),
                             ("split", fs.fd_section_split)):
                check(f"row 14 fd_section {body} N+1={n1} "
                      f"K={FD_SECTION_F64_K} (ragged) f64 "
                      f"{'diag' if diag else 'general'}",
                      fn(*args, 1.4, **kw), plain, TOL["float64"])

    # ---- the probes' run: counters at 0 before, read after ----
    for w in probes.values():
        w.launches = 0
    r_peak = peak.rates(iters, blocks, reps, lo, hi, dev)
    flops = float(np.median(r_peak))
    share = flops / FP32_OPS_PER_S
    print(f"[{card}] row 11 FMA f32 (ITERS={iters} BLOCKS={blocks} "
          f"REPS={reps} INNER={lo}->{hi}): median {flops / 1e12:.3f} "
          f"TFLOP/s (best {r_peak.max() / 1e12:.3f}, spread "
          f"{spread(r_peak):.1%}), {share:.1%} of the data sheet's "
          f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s (required "
          f"{FMA_SHARE[0]:.0%}-{FMA_SHARE[1]:.0%})")
    if not FMA_SHARE[0] <= share <= FMA_SHARE[1]:
        raise AssertionError("the FMA probe reads outside its range: under "
                             "half it measures latency, not throughput")
    r_div = divide.rates(iters, blocks, reps, lo, hi, dev)
    for kind, r in r_div.items():
        print(f"[{card}] row 12 {kind:>5} chain: "
              f"{float(np.median(r)) / 1e12:.4f} T iters/s (spread "
              f"{spread(r):.1%})")
    print(f"[{card}] row 12 divide cost: {divide.slots(r_div)['div']:.2f} "
          "FMA-issue slots (chain iter = 1 add + 1 div vs 1 FMA)")
    r_tr = tr.rates(tr.KINDS, iters, blocks, reps, lo, hi, dev)
    slots = tr.slots(r_tr)
    for kind, r in r_tr.items():
        print(f"[{card}] row 13 {kind:>5} chain: "
              f"{float(np.median(r)) / 1e12:.4f} T iters/s (spread "
              f"{spread(r):.1%})" + (f", {slots[kind]:.2f} FMA-issue slots"
                                     if kind in slots else ""))
    print(json.dumps({"fma_T_iters_per_s": float(np.median(r_tr["fma"]))
                      / 1e12, "slots": {k: round(v, 2)
                                        for k, v in slots.items()}}))
    # the prices: a mul or an add is R_fma / R_kind slots (its chain has
    # no companion add), the others the slots above; the FMA rate is row
    # 11's (two flops an FMA)
    prices = dict(slots, mul=slots["mul"] + 1.0, add=slots["add"] + 1.0)
    fma_per_s = flops / 2.0

    # device times per launch, kernel and plain, at the probes' inputs
    times = {}
    x = peak.probe_input(blocks, peak.BS[0], dev)
    times["fma_peak"] = (dev_ms(lambda: peak.fma_peak(x, iters), 5),
                         dev_ms(lambda: peak.fma_peak_plain(x, iters), 1))
    n_peak = x.numel()
    for kind in divide.DIVIDE_KINDS:
        times["divide", kind] = (
            dev_ms(lambda: divide.chain(x, kind, iters), 5),
            dev_ms(lambda: divide.chain_plain(x, kind, iters), 1))
    x = peak.probe_input(blocks, tr.BS[0], dev)
    n_tr = x.numel()
    for kind in tr.KINDS:
        times["tr", kind] = (dev_ms(lambda: tr.chain(x, kind, iters), 5),
                             dev_ms(lambda: tr.chain_plain(x, kind, iters),
                                    1))
    del x
    for key, (ms, pms) in times.items():
        label = (key if isinstance(key, str) else
                 f"{'divide' if key[0] == 'divide' else 'transcendental'}"
                 f".chain {key[1]}")
        print(f"[{card}] {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"({pms / ms:.1f}x), device times")

    # row 14's A/B: K1's joint line body against the split path's three
    # launches and their assembly, on the same inputs
    fd_times = {}
    for (n1, k, diag), args in fd_cases.items():
        kw = dict(n1=n1, diag=diag)
        lo_ = fs.line_ops(n1)
        fd = lambda d: fv.hex_fd_dir(args[0], args[1], args[2], 1.4,
                                     line_ops=lo_, d=d, diag=diag,
                                     coeffs=args[3:])
        parts = [fd(d) for d in range(3)]
        joint = dev_ms(lambda: fs.fd_section(*args, 1.4, **kw), 20)
        split3 = dev_ms(lambda: [fd(d) for d in range(3)], 20)
        asm = dev_ms(lambda: fs.assemble(parts, n1 ** 3), 20)
        fd_times[n1, k, diag] = (joint, split3, asm)
        print(f"[{card}] row 14 fd section N+1={n1} K={k} f32 "
              f"{'diag' if diag else 'general'}: joint (K1's line body) "
              f"{joint:.4f} ms; split 3 x hex_fd_dir {split3:.4f} ms + "
              f"assembly {asm:.4f} ms = {split3 + asm:.4f} ms "
              f"({(split3 + asm) / joint:.2f}x the joint; the launches "
              f"alone {split3 / joint:.2f}x), device times")
        del parts
    n1, k = FD_SECTION_CASES[0]
    args = fd_cases[n1, k, True]
    fd_ms = fd_times[n1, k, True][0]
    fd_plain_ms = dev_ms(lambda: fs.fd_section_plain(*args, 1.4, n1=n1,
                                                     diag=True), 1)
    fd_bytes = nbytes(*args) + 5 * args[0].shape[1] * k * 4
    launches = {name: w.launches for name, w in probes.items()}
    print(f"phase 31 launches (the probes' run and the A/B): {launches}")
    if not all(launches[name] for name in ("fma_peak", "divide.chain",
                                           "transcendental.chain",
                                           "fd_section")):
        raise AssertionError("a probe kernel was not launched in its run")

    # the rows: ops per element of each probe (the chain frame: four
    # starts, three sums and the scaling)
    frame = Ops(fma=4, add=3, mul=1)
    step = {"fma": Ops(fma=1), "mul": Ops(mul=1), "add": Ops(add=1),
            "div": Ops(add=1, div=1), "log": Ops(log=1, add=1),
            "exp": Ops(exp=1, add=1), "rsqrt": Ops(add=1, rsqrt=1),
            "sqrt": Ops(add=2, sqrt=1)}
    slowest = max(tr.KINDS, key=lambda kd: times["tr", kd][0])
    rows = [
        ("fma_peak", "probes.cu", "examples/vpu_peak.py:62",
         launches["fma_peak"], errs[f"row 11 fma_peak iters={iters}"],
         *times["fma_peak"],
         bound(8 * n_peak, (Ops(fma=iters + 1, add=1, mul=1)) * n_peak,
               f32)),
        ("probe_divide (div)", "probes.cu", "examples/vpu_divide.py:53",
         launches["divide.chain"], errs["row 12 divide.chain div"],
         *times["divide", "div"],
         bound(8 * n_peak, (step["div"] * iters + frame) * n_peak, f32)),
        (f"probe_transcendental ({slowest}, the slowest kind)", "probes.cu",
         "examples/vpu_transcendental.py:78",
         launches["transcendental.chain"],
         errs[f"row 13 transcendental.chain {slowest}"],
         *times["tr", slowest],
         bound(8 * n_tr, (step[slowest] * iters + frame) * n_tr, f32)),
        ("fd_section", "fd_section.cuh", "examples/r5_packed_fd_study.py:54",
         launches["fd_section"],
         errs[f"row 14 fd_section joint N+1={n1} K={k} f32 diag"], fd_ms,
         fd_plain_ms,
         bound(fd_bytes, PAIR_3D["diag"] * (line_pairs(n1) * k), f32))]
    return rows, prices, fma_per_s


def k3_lists(mv, args, kw):
    """K3's operator lists for its positional arguments (q, geo, q_skew,
    vq, vhp, ph, gamma), built once, as make_cns_rhs_affine builds them:
    the timed calls pass them."""
    return mv.modal_lists(*args[2:6], kw["nq"])


def ptxas_entries(log):
    """{entry function (mangled): (registers, spill stores, spill loads)}
    from the build log's ptxas report."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, props = m.group(1), None
            out[entry] = [0, 0, 0]
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == entry:
            out[entry][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry][0] = int(m.group(1))
    return out


def ptxas_of(entries, kind, prec, ints, flags):
    """ptxas' (registers, spill stores, spill loads) of one instantiation
    of esdg::<kind>_kernel: its type, integer and bool template arguments,
    in order; None when the log does not hold it."""
    form = ("If" if prec == "f32" else "Id") + "".join(
        f"Li{i}E" for i in ints) + "".join(f"Lb{int(b)}E" for b in flags)
    for name, v in entries.items():
        if f"{kind}_kernel{form}" in name:
            return tuple(v)
    return None


def shape_line(label, occ, ptx):
    """One launch shape: blocks and warps resident per SM beside the
    registers and spills."""
    blocks, threads, smem, regs, local, te = occ
    warps = blocks * ((threads + 31) // 32)
    ptx_s = ("ptxas: not in the log" if ptx is None else
             f"ptxas {ptx[0]} registers, spill stores {ptx[1]} B, loads "
             f"{ptx[2]} B")
    return (f"shape {label}: {blocks} blocks x {threads} threads "
            f"({te} elements a block, {smem} B shared) -> {warps} warps "
            f"resident per SM; {regs} registers, {local} B local; {ptx_s}")


def kernel_shapes(dev, log):
    """The launch shape of every K1 instantiation (N+1 = 2..8, diag,
    general, curved, f32 and f64), of K2 in its grid forms, the split
    projection (row 3) and the split fd (rows 4a, 4b; at N+1 = 8 in f32
    at least 16 warps an SM and no local memory, else it raises) at
    N+1 = 2..8, of K3 at each dim (and curved tris) and
    of the tail kernel after K4 at N+1 = 2..8, of K4 (both fold_tail
    forms) and K7 at dim 3 (hex N=3 with either front, N=5 without) at
    the paths' operators, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor
    and cudaFuncGetAttributes give them, beside ptxas' report; returns
    {(kernel, N+1 or dim, form, type): warps resident per SM}."""
    import torch
    from esdg_cns_tpu_torch.cavity_cases import warped_tri_case
    from esdg_cns_tpu_torch.ops import fused_volume as fv
    from esdg_cns_tpu_torch.ops import modal_volume as mv
    from esdg_cns_tpu_torch.ops import cns_tail as ct
    from esdg_cns_tpu_torch.presets import (becker_shocktube_1d,
                                            lid_driven_cavity,
                                            lid_driven_cavity_3d)
    entries = ptxas_entries(log)
    warps = {}
    for n1 in range(2, 9):
        for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            for form in ("diag", "general", "curved"):
                occ = fv.euler_volume_shape(dtype, n1, diag=form == "diag",
                                            curved=form == "curved")[:6]
                ptx = ptxas_of(entries, "hex_volume", prec, [n1],
                               [form == "diag", form == "curved"])
                print(shape_line(f"K1 N+1={n1} {form} {prec}", occ, ptx))
                warps[("K1", n1, form, prec)] = (
                    occ[0] * ((occ[1] + 31) // 32))
    # K2 in its grid forms (diag and general, on ph_qf and on the split
    # parts) and the split path's projection, at every N+1 they are built
    # for
    for n1 in range(2, 9):
        for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            for diag in (True, False):
                for split in (False, True):
                    occ = fv.euler_surface_shape(dtype, n1, diag=diag,
                                                 grid=True, split=split)
                    ptx = ptxas_of(entries, "hex_surface", prec,
                                   [n1, occ[5], occ[1], occ[6]],
                                   [diag, True, split])
                    form = (f"{'diag' if diag else 'general'} grid "
                            f"{'split' if split else 'ph_qf'}")
                    print(shape_line(f"K2 N+1={n1} {form} {prec}", occ[:6],
                                     ptx))
                    warps[("K2", n1, form, prec)] = (
                        occ[0] * ((occ[1] + 31) // 32))
            occ = fv.hex_project_shape(dtype, n1)
            ptx = ptxas_of(entries, "hex_project", prec,
                           [n1, occ[5], occ[1], occ[6]], [])
            print(shape_line(f"row 3 hex_project N+1={n1} {prec}", occ[:6],
                             ptx))
            warps[("row 3", n1, "", prec)] = occ[0] * ((occ[1] + 31) // 32)
            occ = ct.cns_traction_tail_shape(dtype, n1)
            ptx = ptxas_of(entries, "cns_tail", prec,
                           [n1, occ[5], occ[1], occ[6]], [])
            print(shape_line(f"tail cns_traction_tail N+1={n1} {prec}",
                             occ[:6], ptx))
            warps[("tail", n1, "", prec)] = occ[0] * ((occ[1] + 31) // 32)
            # the split fd (rows 4a, 4b; dense runs the general kernel) in
            # direction 0 (the others differ in their strides alone)
            for diag in (True, False):
                occ = fv.hex_fd_dir_shape(dtype, n1, diag=diag)
                mangled = (f"hex_fd_dir_kernelI{'f' if prec == 'f32' else 'd'}"
                           f"Li{n1}ELi0ELb{int(diag)}E")
                ptx = next((tuple(v) for name, v in entries.items()
                            if mangled in name), None)
                form = "diag" if diag else "general (dense)"
                print(shape_line(f"rows 4a/4b hex_fd_dir N+1={n1} {form} "
                                 f"{prec} (min blocks {occ[6]})", occ[:6],
                                 ptx))
                w = occ[0] * ((occ[1] + 31) // 32)
                warps[("fd", n1, form, prec)] = w
                if prec == "f32" and n1 == 8 and (w < 16 or occ[4]):
                    raise AssertionError(
                        f"hex_fd_dir N+1=8 {form} f32: {w} warps an SM, "
                        f"{occ[4]} local bytes (want >= 16 and 0)")
    cases = (("hex N=3", lambda dt: lid_driven_cavity_3d(3, 2, dtype=dt,
                                                         device=dev)[0]),
             ("tri N=3", lambda dt: lid_driven_cavity(3, 2, dtype=dt,
                                                      device=dev)[0]),
             ("line N=4", lambda dt: becker_shocktube_1d(4, 8, dtype=dt,
                                                         device=dev)[0]),
             ("curved tri N=3", lambda dt: warped_tri_case(3, 2, dt,
                                                          dev)[0]))
    for label, make in cases:
        for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            disc = make(dtype)
            curved = disc.geo.shape[1] != 1
            lists = mv.modal_lists(torch.stack(disc.q_skew), disc.vq,
                                   disc.vhp, disc.ph, disc.nq)
            occ, ops_global = mv.euler_modal_volume_shape(
                dtype, disc.dim, curved, disc.np_, disc.nq, disc.nh, lists)
            ptx = ptxas_of(entries, "modal_volume", prec, [disc.dim],
                           [curved, ops_global])
            print(shape_line(f"K3 dim {disc.dim} {label} {prec} (lists: "
                             f"{lists.pairs} partners, "
                             f"{'global' if ops_global else 'shared'} "
                             "memory)", occ, ptx))
            warps[("K3", disc.dim, "curved" if curved else "affine",
                   prec)] = occ[0] * ((occ[1] + 31) // 32)
    # K4 and K7 at dim 3 on the lists the RHS builds: the 3D cavity's hex
    # N=3 with either front, the 3D Becker tube's N=5
    from esdg_cns_tpu_torch.ops import surface_viscous as sv
    from esdg_cns_tpu_torch.solvers.cns_fused import composed_operators
    for n, proj in ((3, True), (3, False), (BECKER_N, False)):
        for prec, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            disc = lid_driven_cavity_3d(n, 2, dtype=dtype, device=dev)[0]
            front, vqlift, drpq = composed_operators(disc, proj=proj)
            lists = sv.visc_lists(front, vqlift, disc.vhp[disc.nq:], drpq,
                                  disc.lift, nq=disc.nq, proj=proj)
            shapes = sv.viscous_shapes(dtype, 3, proj, disc.np_, disc.nq,
                                       disc.nfq, lists)
            for key, (occ, ops_global) in shapes.items():
                kind = "cns_viscous" if key == "K7" else "cns_surface_viscous"
                ptx = ptxas_of(entries, kind, prec, [3],
                               [proj, not ops_global])
                print(shape_line(
                    f"{key} (3, {'proj' if proj else 'no proj'}) hex N={n} "
                    f"{prec} (lists: {lists.entries} entries, "
                    f"{'global' if ops_global else 'shared'} memory, "
                    f"{occ[1] // occ[5]} workers an element)", occ, ptx))
                warps[(key, n, proj, prec)] = occ[0] * ((occ[1] + 31) // 32)
    return warps


# the A/B's turns: parent, this tree, this tree, parent
AB_TURNS = ("parent", "new", "new", "parent")
# a kernel or stage of this tree slower than the parent's by more than
# this share is printed as a regression
AB_SLOWER = 0.02


def ab_phase(card, dev, dev_ms, parent_dir):
    """32. The parent tree against this one on one card, in turns (parent,
    new, new, parent): K1 in every form at the paths' shapes, K3 at each
    dim on moving states and the 3D cavity at rest, K5, K4 in every form
    the paths run (dims 1, 2 and 3, both fronts at dim 3, the 3D Becker
    tube's N=5), K7 at dims 1, 2 and 3 and K8, the split fd (rows 4a,
    4b), row 10 and the fd section (row 14), each pair of calls on the
    same inputs (outputs held to each other); then the stages of the
    device-bound paths (ms per stage over 300 stages) and, on the
    host-bound ones, the stage's device busy time (torch.profiler).
    Returns the rows [(name, parent ms, new ms)]."""
    import numpy as np
    import torch

    from esdg_cns_tpu_torch.probes.timing import load_parent

    par = load_parent(parent_dir)
    pkernels = par("kernels")
    info = pkernels.build()
    pkernels.library()
    print(f"A/B: the parent tree {parent_dir} built in {info.seconds:.1f} s")
    from esdg_cns_tpu_torch import presets as npre, solvers as nsol
    from esdg_cns_tpu_torch.cavity_cases import (becker_case, cavity_case,
                                                 fd_inputs, k4_inputs,
                                                 k7_inputs, k8_inputs,
                                                 moving_state,
                                                 warped_tri_case)
    from esdg_cns_tpu_torch.ops import cns_surface as ncs
    from esdg_cns_tpu_torch.ops import dense_fd as ndf
    from esdg_cns_tpu_torch.ops import fused_volume as nfv
    from esdg_cns_tpu_torch.ops import modal_volume as nmv
    from esdg_cns_tpu_torch.ops import surface_viscous as nsv
    from esdg_cns_tpu_torch.ops import tensor_product_fd as ntp
    from esdg_cns_tpu_torch.probes import fd_section as nfs
    from esdg_cns_tpu_torch.timestepping import lsrk45 as nlsrk45
    pfv, pmv = par("ops.fused_volume"), par("ops.modal_volume")
    ptp, pdf = par("ops.tensor_product_fd"), par("ops.dense_fd")
    pfs = par("probes.fd_section")
    ppre, psol = par("presets"), par("solvers")
    plsrk45 = par("timestepping").lsrk45
    f32, f64 = torch.float32, torch.float64
    rows = []

    def turns(name, calls, n_calls=20):
        """Time calls['parent'] and calls['new'] in turns; print and keep
        the means."""
        t = {"parent": [], "new": []}
        for who in AB_TURNS:
            t[who].append(dev_ms(calls[who], n_calls))
        p_ms, n_ms = (statistics.mean(t["parent"]),
                      statistics.mean(t["new"]))
        flag = ("  SLOWER" if n_ms > p_ms * (1 + AB_SLOWER) else "")
        print(f"[{card}] A/B {name}: parent {p_ms:.4f} ms, new {n_ms:.4f} "
              f"ms ({n_ms / p_ms:.3f}x; turns {t['parent'][0]:.4f} "
              f"{t['new'][0]:.4f} {t['new'][1]:.4f} {t['parent'][1]:.4f})"
              f"{flag}")
        rows.append((name, p_ms, n_ms))

    def agree(name, a, b):
        a = a if isinstance(a, (tuple, list)) else (a,)
        b = b if isinstance(b, (tuple, list)) else (b,)
        tol = TOL[str(a[0].dtype).replace("torch.", "")]
        e = max(rel_err(x, y)[0] for x, y in zip(a, b))
        if not e <= tol:
            raise AssertionError(f"A/B {name}: parent and new disagree "
                                 f"({e:.2e})")

    def rstate(disc, seed):
        rng = np.random.default_rng(seed)
        sh = (disc.np_, disc.num_elements)
        t = lambda a: torch.as_tensor(a, dtype=disc.wq.dtype, device=dev)
        from esdg_cns_tpu_torch.physics import primitive_to_conservative
        return primitive_to_conservative(
            t(2 + 0.1 * rng.random(sh)),
            t(0.3 * rng.standard_normal((3, *sh))),
            t(2 + 0.1 * rng.random(sh)))

    # ---- kernels: K1 in every form at the paths' shapes (f64: the
    # 3D cavity's and the 3D Becker tube's K) ----
    for label, n, k1d, curved, form, dtype in (
            ("K1 N+1=4 diag k1d=32 (main path)", 3, 32, False, "diag", f32),
            ("K1 N+1=4 general k1d=32", 3, 32, False, "general", f32),
            ("K1 N+1=4 k1d=16 diag (3D cavity, fused_hex)", 3, 16, False,
             "diag", f32),
            ("K1c N+1=4 k1d=32", 3, 32, True, "curved", f32),
            ("K1 N+1=5 k1d=24 diag (N=4 'auto')", 4, 24, False, "diag",
             f32),
            ("K1 N+1=6 k1d=20 diag (N=5 'auto')", 5, 20, False, "diag",
             f32),
            ("K1 N+1=6 k1d=20 general", 5, 20, False, "general", f32),
            ("K1 N+1=7 k1d=16 diag (N=6 force_fused)", 6, 16, False,
             "diag", f32),
            ("K1 N+1=8 k1d=8 diag", 7, 8, False, "diag", f32),
            ("K1c N+1=6 k1d=16", 5, 16, True, "curved", f32),
            ("K1c N+1=8 k1d=8", 7, 8, True, "curved", f32),
            ("K1 N+1=4 k1d=16 diag f64", 3, 16, False, "diag", f64),
            ("K1 N+1=6 k1d=13 diag f64 (K=2197)", 5, 13, False, "diag",
             f64)):
        disc, _ = npre.euler_hex_3d(n=n, k1d=k1d, curved=curved,
                                    dtype=dtype, device=dev)
        q = rstate(disc, 5)
        vargs = (q, disc.geo, disc.vhp[disc.nq:], disc.lift, 1.4)
        vkw = dict(line_ops=disc.line_ops, diag=form == "diag")
        calls = {"new": lambda: nfv.euler_volume(*vargs, **vkw),
                 "parent": lambda: pfv.euler_volume(*vargs, **vkw)}
        agree(label, calls["new"](), calls["parent"]())
        turns(label, calls)
        del disc, q, vargs
        torch.cuda.empty_cache()

    # ---- K3 at each dim ----
    hdisc, hq0, _, _ = npre.lid_driven_cavity_3d(3, 16, dtype=f32,
                                                 device=dev)
    tdisc, tq0, _, _ = npre.lid_driven_cavity(3, 128, dtype=f32, device=dev)
    ldisc, lq0, _, _ = npre.becker_shocktube_1d(4, 128, dtype=f64,
                                                device=dev)
    cdisc, cq = warped_tri_case(3, 128, f32, dev)
    for label, disc, q in (
            ("K3 dim 3 hex N=3 k1d=16, moving", hdisc,
             moving_state(hq0, np.random.default_rng(3))),
            ("K3 dim 3 hex N=3 k1d=16, at rest", hdisc, hq0),
            ("K3 dim 2 tri N=3 k1d=128, moving", tdisc,
             moving_state(tq0, np.random.default_rng(3))),
            ("K3 dim 1 line N=4 K=128 f64", ldisc, lq0),
            ("K3c curved tri N=3 k1d=128", cdisc, cq)):
        qs = torch.stack(disc.q_skew)
        margs = (q, disc.geo, qs, disc.vq, disc.vhp, disc.ph, 1.4)
        # each tree on its own lists, built once as its RHS builds them
        lists = nmv.modal_lists(qs, disc.vq, disc.vhp, disc.ph, disc.nq)
        plists = pmv.modal_lists(qs, disc.vq, disc.vhp, disc.ph, disc.nq)
        calls = {"new": lambda: nmv.euler_modal_volume(*margs, nq=disc.nq,
                                                       lists=lists),
                 "parent": lambda: pmv.euler_modal_volume(
                     *margs, nq=disc.nq, lists=plists)}
        agree(label, calls["new"](), calls["parent"]())
        turns(label, calls)

    # ---- K5 on the cavity's tri, row 10, the split fd, the fd section ----
    qh, qlog = fd_inputs(tdisc, moving_state(tq0, np.random.default_rng(4)))
    dargs = (qh, qlog, torch.stack(tdisc.q_skew), tdisc.geo, 1.4)
    calls = {"new": lambda: ndf.flux_differencing_dense(*dargs,
                                                        nq=tdisc.nq),
             "parent": lambda: pdf.flux_differencing_dense(*dargs,
                                                           nq=tdisc.nq)}
    agree("K5", calls["new"](), calls["parent"]())
    turns("K5 tri N=3 k1d=128", calls)

    # ---- K4 in every form the paths run, K7 at dims 1, 2, 3 and K8, at
    # the paths' shapes: this tree's kernels on the lists the RHS builds
    # (dim 3), the parent's on the dense operators ----
    psv, pcs = par("ops.surface_viscous"), par("ops.cns_surface")
    for label, make, projs, t, folds in (
            ("tri N=3 k1d=128", lambda: cavity_case(
                "isothermal", 3, 128, f32, dev), (True,), 0.0, (True,)),
            ("hex N=3 k1d=16", lambda: cavity_case(
                "isothermal", 3, 16, f32, dev, dim=3), (False, True), 0.0,
             (True, False)),
            ("line N=4 K=128 f64", lambda: becker_case(
                1, LINE_N, LINE_K, f64, dev), (True,), 0.003, (True,)),
            ("hex N=5 k1d=32 (Becker 3D)", lambda: becker_case(
                3, BECKER_N, BECKER_K1D, f32, dev), (False,), 0.003,
             (True,))):
        disc, q, bc, p = make()
        dim = disc.dim
        for proj in projs:
            form = f"({dim}, {'proj' if proj else 'no proj'})"
            args, tail, kw = k4_inputs(disc, q, bc, p, t=t, proj=proj)
            a7, kw7 = k7_inputs(disc, q, bc, p, t=t, proj=proj)
            lists = (nsv.visc_lists(*args[11:15], tail[1], nq=disc.nq,
                                    proj=proj) if dim == 3 else None)
            for fold in folds:
                extra = tail if fold else ()
                calls = {"new": lambda: nsv.cns_surface_viscous(
                             *args, *extra, fold_tail=fold, lists=lists,
                             **kw),
                         "parent": lambda: psv.cns_surface_viscous(
                             *args, *extra, fold_tail=fold, **kw)}
                name = (f"K4 {form} {'fold_tail' if fold else 'no tail'} "
                        f"{label}")
                agree(name, [o for o in calls["new"]() if o is not None],
                      [o for o in calls["parent"]() if o is not None])
                turns(name, calls)
            calls = {"new": lambda: nsv.cns_viscous(*a7, lists=lists,
                                                    **kw7),
                     "parent": lambda: psv.cns_viscous(*a7, **kw7)}
            agree(f"K7 {form}", calls["new"](), calls["parent"]())
            turns(f"K7 {form} {label}", calls)
        a8, kw8 = k8_inputs(disc, q, bc, p, t=t, proj=projs[0])
        calls = {"new": lambda: ncs.cns_surface(*a8, **kw8),
                 "parent": lambda: pcs.cns_surface(*a8, **kw8)}
        agree(f"K8 dim {dim}", [o for o in calls["new"]() if o is not None],
              [o for o in calls["parent"]() if o is not None])
        turns(f"K8 dim {dim} {label}", calls)
        del disc, q, bc, args, tail, a7, a8, lists
        torch.cuda.empty_cache()
    del hdisc, tdisc, ldisc, cdisc, qh, qlog, dargs
    for label, curved in (("row 10 N=3 k1d=32", False),
                          ("row 10 curved N=3 k1d=32", True)):
        disc, q = npre.euler_hex_3d(n=3, k1d=32, curved=curved, dtype=f32,
                                    device=dev)
        qh, qlog = fd_inputs(disc, q)
        largs = (qh, qlog, disc.geo, 1.4)
        lkw = dict(elem_type="hex", line_ops=disc.line_ops, nq=disc.nq)
        calls = {"new": lambda: ntp.flux_differencing_lines_fused(*largs,
                                                                  **lkw),
                 "parent": lambda: ptp.flux_differencing_lines_fused(
                     *largs, **lkw)}
        agree(label, calls["new"](), calls["parent"]())
        turns(label, calls)
        del disc, q, qh, qlog, largs
        torch.cuda.empty_cache()
    # the split fd at the 'split' paths' shapes, N+1 = 5..8: diag and the
    # dense form on the mesh's metric (the paths' forms), general on a
    # random affine one
    for n, k1d in ((4, 24), (5, 20), (6, 16), (7, 16)):
        disc, _ = npre.euler_hex_3d(n=n, k1d=k1d, dtype=f32, device=dev)
        qh, qlog = fd_inputs(disc, rstate(disc, 6))
        rgeo = torch.as_tensor(np.random.default_rng(9).uniform(
            0.5, 1.5, (9, 1, disc.num_elements)), dtype=f32, device=dev)
        for row, form, geo in (("4a", "diag", disc.geo),
                               ("4a", "general, random metric", rgeo),
                               ("4b", "dense", disc.geo)):
            label = f"row {row} N+1={n + 1} k1d={k1d} {form}"
            for d in range(3):
                kw = dict(line_ops=disc.line_ops, d=d)
                if row == "4a":
                    kw["diag"] = form == "diag"
                nf_ = nfv.hex_fd_dir_dense if row == "4b" else nfv.hex_fd_dir
                pf_ = pfv.hex_fd_dir_dense if row == "4b" else pfv.hex_fd_dir
                calls = {"new": lambda: nf_(qh, qlog, geo, 1.4, **kw),
                         "parent": lambda: pf_(qh, qlog, geo, 1.4, **kw)}
                agree(label, calls["new"](), calls["parent"]())
                turns(f"{label} d={d}", calls)
            p_ms, n_ms = (statistics.mean(r[i] for r in rows[-3:])
                          for i in (1, 2))
            print(f"[{card}] A/B {label}, mean of the three directions: "
                  f"parent {p_ms:.4f} ms, new {n_ms:.4f} ms "
                  f"({n_ms / p_ms:.3f}x)")
        del disc, qh, qlog, rgeo
        torch.cuda.empty_cache()
    # ---- row 3, and K2: on its own (gathered traces, ph_qf) and with
    # the work it took in (the parent's K2 after its roll exchange and,
    # on the split paths, its combine, against this tree's K2 in the form
    # the stage runs) ----
    for label, n, k1d, split, curved in (
            ("N+1=4 k1d=32 (main path)", 3, 32, False, False),
            ("N+1=4 k1d=32 curved", 3, 32, False, True),
            ("N+1=5 k1d=24 (N=4 'auto')", 4, 24, False, False),
            ("N+1=5 k1d=24 (N=4 'split')", 4, 24, True, False),
            ("N+1=6 k1d=20 (N=5 'auto')", 5, 20, False, False),
            ("N+1=6 k1d=20 (N=5 'split')", 5, 20, True, False),
            ("N+1=7 k1d=16 (N=6 force_fused)", 6, 16, False, False),
            ("N+1=7 k1d=16 (N=6 'split')", 6, 16, True, False),
            ("N+1=8 k1d=16 (N=7 split)", 7, 16, True, False)):
        disc, _ = npre.euler_hex_3d(n=n, k1d=k1d, curved=curved,
                                    dtype=f32, device=dev)
        q = rstate(disc, 7)
        ef, lo = disc.vhp[disc.nq:], disc.line_ops
        if split:
            calls = {"new": lambda: nfv.hex_project(q, ef, 1.4),
                     "parent": lambda: pfv.hex_project(q, ef, 1.4)}
            agree(f"row 3 {label}", calls["new"](), calls["parent"]())
            turns(f"row 3 hex_project {label}", calls)
        qh, qlog, tr = nfv.hex_project_plain(q, ef, 1.4)
        if curved:
            geom = (torch.stack(disc.nxj), disc.sj, disc.inv_sj,
                    disc.inv_jac)
        else:
            geom = ((disc.nxj[0] + disc.nxj[1] + disc.nxj[2])[None],
                    disc.sj, disc.inv_sj, disc.inv_jac[:1])
        diag = not curved
        ph_qf = torch.as_tensor(
            np.random.default_rng(8).standard_normal((5, disc.nq, q.shape[2])),
            dtype=f32, device=dev)
        nbr = disc.gather_traces(tr)
        args = (tr, nbr, *geom, disc.lift, ph_qf, 1.4)
        calls = {"new": lambda: nfv.euler_surface(*args, diag=diag),
                 "parent": lambda: pfv.euler_surface(*args, diag=diag)}
        agree(f"K2 {label}", calls["new"](), calls["parent"]())
        turns(f"K2 on its own (gathered, ph_qf) {label}", calls)
        if n == 3 and not curved:
            pdisc, _ = ppre.euler_hex_3d(n=n, k1d=k1d, dtype=f32, device=dev)
            print(f"[{card}] A/B the parent's roll exchange {label}: "
                  f"{dev_ms(lambda: pdisc.gather_traces(tr), 20):.4f} ms "
                  "(device time; no longer in this tree's stage)")
            del pdisc
        if split:
            parts = [nfv.hex_fd_dir(qh, qlog, disc.geo, 1.4, line_ops=lo,
                                    d=d, diag=True) for d in range(3)]
            calls = {"new": lambda: nfv.euler_surface(
                         tr, None, *geom, disc.lift, None, 1.4, diag=diag,
                         grid=disc.grid_shape, parts=parts, line_ops=lo),
                     "parent": lambda: pfv.euler_surface(
                         tr, disc.gather_traces(tr), *geom, disc.lift,
                         pfv.split_combine(parts, disc.lift, lo), 1.4,
                         diag=diag)}
            work = "K2 + combine + exchange"
        else:
            calls = {"new": lambda: nfv.euler_surface(
                         tr, None, *geom, disc.lift, ph_qf, 1.4, diag=diag,
                         grid=disc.grid_shape),
                     "parent": lambda: pfv.euler_surface(
                         tr, disc.gather_traces(tr), *geom, disc.lift, ph_qf,
                         1.4, diag=diag)}
            work = "K2 + exchange"
        agree(f"{work} {label}", calls["new"](), calls["parent"]())
        turns(f"{work} (new: K2 alone) {label}", calls)
        del disc, q, qh, qlog, tr, nbr, ph_qf, args
        torch.cuda.empty_cache()
    for n1, k in FD_SECTION_CASES:
        for diag in (True, False):
            args = nfs.as_tensors(nfs.study_inputs(n1, k, diag), dev)
            kw = dict(n1=n1, diag=diag)
            calls = {"new": lambda: nfs.fd_section(*args, 1.4, **kw),
                     "parent": lambda: pfs.fd_section(*args, 1.4, **kw)}
            label = f"row 14 N+1={n1} K={k} {'diag' if diag else 'general'}"
            agree(label, calls["new"](), calls["parent"]())
            turns(label, calls)

    # ---- the stages ----
    def euler_case(pkg_pre, pkg_sol, n, k1d, curved=False, **kw):
        disc, q0 = pkg_pre.euler_hex_3d(n=n, k1d=k1d, curved=curved,
                                        dtype=f32, device=dev)
        return pkg_sol.make_euler_rhs_fused(disc, dissipation=True, **kw), q0

    def cavity3_case(pkg_pre, pkg_sol, impl):
        disc, q0, bc, p = pkg_pre.lid_driven_cavity_3d(3, 16, dtype=f32,
                                                       device=dev)
        return pkg_sol.make_cns_rhs_affine(
            disc, volume_impl=impl, mu=p["mu"], pr=p["pr"], re=p["re"],
            bc=bc, inviscid_dissipation=True, viscous_dissipation=True,
            compute_rhstest=False), q0

    def cavity2_case(pkg_pre, pkg_sol):
        disc, q0, bc, p = pkg_pre.lid_driven_cavity(3, 128, dtype=f32,
                                                    device=dev)
        return pkg_sol.make_cns_rhs_affine(
            disc, volume_impl="fused", surface_impl="auto", mu=p["mu"],
            pr=p["pr"], re=p["re"], bc=bc, inviscid_dissipation=True,
            viscous_dissipation=True, compute_rhstest=False), q0

    def becker3_case(pkg_pre, pkg_sol):
        disc, q0, bc, shock = pkg_pre.becker_shocktube_3d(
            n=BECKER_N, k1d=BECKER_K1D, dtype=f32, device=dev)
        return pkg_sol.make_cns_rhs_affine(
            disc, volume_impl="fused_hex", mu=shock.mu, pr=shock.pr, bc=bc,
            inviscid_dissipation=True, compute_rhstest=False), q0

    def becker1_case(pkg_pre, pkg_sol):
        disc, q0, bc, shock = pkg_pre.becker_shocktube_1d(
            LINE_N, LINE_K, dtype=f64, device=dev)
        return pkg_sol.make_cns_rhs_affine(
            disc, volume_impl="fused", mu=shock.mu, pr=shock.pr, bc=bc,
            inviscid_dissipation=True, compute_rhstest=False), q0

    steps = 60
    for label, make, dt, host_bound in (
            ("Euler N=3 k1d=32", lambda pp, ps: euler_case(pp, ps, 3, 32),
             DT, False),
            ("Euler N=4 k1d=24 'auto'",
             lambda pp, ps: euler_case(pp, ps, 4, 24), N5_DT, False),
            ("Euler N=5 k1d=20 'auto'",
             lambda pp, ps: euler_case(pp, ps, 5, 20), N5_DT, False),
            ("Euler N=6 k1d=16 force_fused",
             lambda pp, ps: euler_case(pp, ps, 6, 16, force_fused=True),
             N6_DT, False),
            ("curved Euler N=3 k1d=32",
             lambda pp, ps: euler_case(pp, ps, 3, 32, curved=True), DT,
             False),
            ("Euler N=7 k1d=16 split",
             lambda pp, ps: euler_case(pp, ps, 7, 16, force_fused=True),
             N7_DT, False),
            ("Euler N=4 k1d=24 'split'",
             lambda pp, ps: euler_case(pp, ps, 4, 24, volume_mode="split"),
             N5_DT, False),
            ("Euler N=4 k1d=24 'split_dense'",
             lambda pp, ps: euler_case(pp, ps, 4, 24,
                                       volume_mode="split_dense"),
             N5_DT, False),
            ("Euler N=5 k1d=20 'split'",
             lambda pp, ps: euler_case(pp, ps, 5, 20, volume_mode="split"),
             N5_DT, False),
            ("Euler N=6 k1d=16 'split'",
             lambda pp, ps: euler_case(pp, ps, 6, 16, force_fused=True,
                                       volume_mode="split"),
             N6_DT, False),
            ("3D cavity 'fused' (K3)",
             lambda pp, ps: cavity3_case(pp, ps, "fused"), CAV_TIMED_DT,
             True),
            ("Becker 3D N=5 k1d=32 f32", becker3_case,
             becker_dt(BECKER_N, BECKER_K1D), True),
            ("2D cavity (K3 dim 2)", cavity2_case, CAV_TIMED_DT, True),
            ("3D cavity fused_hex (K1)",
             lambda pp, ps: cavity3_case(pp, ps, "fused_hex"),
             CAV_TIMED_DT, True),
            ("1D Becker anchor path (K3 dim 1, f64)", becker1_case, 1e-5,
             True)):
        runs = {}
        for who, pp, ps, ls in (("new", npre, nsol, nlsrk45),
                                ("parent", ppre, psol, plsrk45)):
            rhs, q0 = make(pp, ps)
            n_steps = 20 if host_bound else steps
            runs[who] = (lambda rhs=rhs, q0=q0, ls=ls, n=n_steps:
                         ls(rhs, q0, dt, n))
        if host_bound:
            # the stage's device time: the profiler's busy time over 100
            # stages (a path whose host synchronises or falls behind the
            # sleeping kernel leaves the device idle inside a queued-ahead
            # window; over 20 stages the two trees' readings on the 2D
            # cavity came out in the other order than over 100, and the
            # anchor's turns spread 8%); the wall clock beside it moves
            # with the host
            t = {"parent": [], "new": []}
            for who in AB_TURNS:
                prof = device_profile(runs[who], 100)
                if prof is None:
                    raise AssertionError("A/B: the profiler recorded no "
                                         "device activity")
                t[who].append(prof[0])
            wall = {who: cuda_ms(runs[who], 1, repeats=3) / 100
                    for who in ("parent", "new")}
            p_ms, n_ms = (statistics.mean(t["parent"]),
                          statistics.mean(t["new"]))
            kind = (f"device busy, ms/stage (torch.profiler, 100 stages); "
                    f"wall clock parent {wall['parent']:.4f}, new "
                    f"{wall['new']:.4f} ms/stage, not held")
        else:
            t = {"parent": [], "new": []}
            for who in AB_TURNS:
                t[who].append(cuda_ms(runs[who], 1, repeats=3)
                              / (5 * steps))
            p_ms, n_ms = (statistics.mean(t["parent"]),
                          statistics.mean(t["new"]))
            kind = f"ms/stage over {5 * steps} stages"
        flag = "  SLOWER" if n_ms > p_ms * (1 + AB_SLOWER) else ""
        print(f"[{card}] A/B stage {label} ({kind}): parent {p_ms:.4f}, "
              f"new {n_ms:.4f} ({n_ms / p_ms:.3f}x; turns "
              f"{t['parent'][0]:.4f} {t['new'][0]:.4f} {t['new'][1]:.4f} "
              f"{t['parent'][1]:.4f}){flag}")
        rows.append((f"stage {label}", p_ms, n_ms))
        del runs
        torch.cuda.empty_cache()
    slower = [name for name, p_ms, n_ms in rows
              if n_ms > p_ms * (1 + AB_SLOWER)]
    print(f"[{card}] A/B: slower than the parent by more than "
          f"{AB_SLOWER:.0%}: {', '.join(slower) if slower else 'none'}")
    return rows


def update_phase(card, dev_ms, q, dq):
    """LSRK45's update kernel against the plain two lines, bitwise at each
    stage, on the state q and its RHS dq (res random, NaN at the first
    stage, where it is not read), in float32 and float64; then its
    device time a stage over a step beside its bound and the plain lines'
    (the five kernels and the zero fill a step that the stepper ran
    before the kernel).  Prints; raises on a difference."""
    import torch

    from esdg_cns_tpu_torch.ops.lsrk45_update import lsrk45_update
    from esdg_cns_tpu_torch.timestepping.explicit import LSRK45_A, LSRK45_B

    coef = [(float(a), float(b)) for a, b in zip(LSRK45_A, LSRK45_B)]
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}

    def plain_step(q, dq, dt):
        res = torch.zeros_like(q)
        for a, b in coef:
            res = a * res + dt * dq
            q_new = q + b * res
        return q_new

    for dtype in (torch.float32, torch.float64):
        qs, dqs = q.to(dtype), dq.to(dtype)
        g = torch.Generator(device=q.device).manual_seed(3)
        res = torch.randn(qs.shape, dtype=dtype, device=q.device,
                          generator=g)
        dt = torch.tensor(DT, dtype=dtype).item()
        before = lsrk45_update.launches
        differ = []
        for s, (a, b) in enumerate(coef):
            r0 = res if s else torch.zeros_like(qs)
            want_res = a * r0 + dt * dqs
            want_q = qs + b * want_res
            given = res.clone() if s else torch.full_like(qs, float("nan"))
            got_q, got_res = lsrk45_update(qs, given, dqs, a, b, dt, s == 0)
            torch.cuda.synchronize()
            differ.append(sum(int((x.view(ints[dtype]) != y.view(
                ints[dtype])).sum()) for x, y in ((got_q, want_q),
                                                  (got_res, want_res))))
        name = str(dtype).replace("torch.", "")
        print(f"update kernel {name} {tuple(qs.shape)}: values differing "
              f"bitwise from the plain lines a stage {differ}, launches "
              f"{lsrk45_update.launches - before}")
        if any(differ) or lsrk45_update.launches - before != 5:
            raise AssertionError("the update kernel departs from the plain "
                                 f"lines ({name})")
        # views one value off 16-byte alignment: the one-value-a-thread form
        n = qs.numel()
        flat = torch.empty(3 * n + 1, dtype=dtype, device=q.device)
        uq, ur, ud = (flat[1 + k * n:1 + (k + 1) * n].view(qs.shape)
                      for k in range(3))
        for view, t in ((uq, qs), (ur, res), (ud, dqs)):
            view.copy_(t)
        want_res = a * res + dt * dqs
        want_q = qs + b * want_res
        before = lsrk45_update.launches
        got_q, got_res = lsrk45_update(uq, ur, ud, a, b, dt, False)
        torch.cuda.synchronize()
        off = sum(int((x.view(ints[dtype]) != y.view(ints[dtype])).sum())
                  for x, y in ((got_q, want_q), (got_res, want_res)))
        print(f"update kernel {name}, views off 16-byte alignment: values "
              f"differing bitwise {off}, launches "
              f"{lsrk45_update.launches - before}")
        if off or lsrk45_update.launches - before != 1:
            raise AssertionError("the update kernel's unaligned form departs "
                                 f"from the plain lines ({name})")
        del flat, uq, ur, ud
        b_step = bound(24 * n * qs.element_size(),
                       Ops(mul=14 * n, add=10 * n), dtype)
        k_ms = dev_ms(lambda: [lsrk45_update(qs, res, dqs, a, b, dt, s == 0)
                               for s, (a, b) in enumerate(coef)], 20) / 5
        p_ms = dev_ms(lambda: plain_step(qs, dqs, dt), 5) / 5
        print(f"[{card}] update kernel {name}, {n} values (no TPU kernel; "
              f"not in the kernels line): {k_ms:.4f} ms a stage over a step, "
              f"bound {b_step.ms / 5:.4f} ms by {b_step.by} "
              f"({b_step.ms / 5 / k_ms:.1%}); plain lines {p_ms:.4f} ms "
              f"({p_ms / k_ms:.2f}x); device times")
        del qs, dqs, res, given, got_q, got_res, want_q, want_res


def report(card, rows, prices, fma_per_s, split_rows, bisect_times):
    """Print every kernel's time beside its data-sheet and priced bounds,
    the f64 rows' operation legs, the order of the perf work and the
    kernels slower than their plain versions; return the kernels line."""
    priced = [priced_bound(b, prices, fma_per_s) for *_, b in rows]
    print(f"[{card}] prices of the priced bounds (FMA issue slots; row 13's "
          "chains, the FMA rate row 11's "
          f"{2 * fma_per_s / 1e12:.3f} TFLOP/s): " + ", ".join(
              f"{k} {v:.2f}" for k, v in prices.items())
          + "; pow as log + exp + mul")
    for (name, *_, ms, pms, b), pb in zip(rows, priced):
        at_price = ("f64: not priced (the probes are f32)" if pb is None
                    else f"priced {pb:.4f} ms ({pb / ms:.1%} of the kernel's"
                    " time)")
        print(f"[{card}] {name}: bound {b.ms:.4f} ms by {b.by} "
              f"({b.ms / ms:.1%}), {at_price}; kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms ({pms / ms:.2f}x the kernel's time)")
    # the float64 rows' operation leg at the f64 peak, beside the f32 peak
    # it was divided by before
    for name, *_, b in rows:
        if b.dtype == "float64":
            t_bytes = b.n_bytes / HBM_BYTES_PER_S * 1e3
            print(f"f64 row {name}: bytes {t_bytes:.7f} ms, operations "
                  f"{b.ops.flops() / FP64_OPS_PER_S * 1e3:.7f} ms at 34 "
                  f"TFLOP/s (at 67: "
                  f"{b.ops.flops() / FP32_OPS_PER_S * 1e3:.7f}); bound "
                  f"{b.ms:.7f} ms by {b.by}")
    # the order of the perf work: launches x (time - priced bound)
    # (the study kernels of examples/ are no perf work)
    rank = sorted(((n * (ms - pb), name, n, ms, pb)
                   for (name, _, rep, n, _, ms, _, _), pb in zip(rows, priced)
                   if pb is not None and not rep.startswith("examples/")),
                  reverse=True)
    print(f"[{card}] launches x (ms - priced bound), largest first: "
          + "; ".join(f"{name} {loss:.2f} ({n} x ({ms:.4f} - {pb:.4f}))"
                      for loss, name, n, ms, pb in rank))
    slower = [name for name, *_, ms, pms, _ in rows if ms > pms]
    print(f"[{card}] kernels slower than their plain version: "
          f"{', '.join(slower) if slower else 'none'}")
    for label in ("tri",):
        sr = split_rows[label]
        for key, bkey in (("K8 cns_surface", "k8_bound"),
                          ("K7 cns_viscous", "k7_bound")):
            b = sr[bkey]
            pb = priced_bound(b, prices, fma_per_s)
            print(f"[{card}] {key} ({label} split path): bound {b.ms:.4f} ms "
                  f"by {b.by}, priced {pb:.4f} ms, kernel "
                  f"{sr['times'][key][0]:.4f} ms "
                  f"({b.ms / sr['times'][key][0]:.1%} of the bound)")
    # the bisection replaces no TPU kernel: printed apart from the line
    for label, (k_ms, e_ms, g_ms) in bisect_times.items():
        print(f"[{card}] Becker bisection {label} f64 (no TPU kernel; not in "
              f"the kernels line): {k_ms:.4f} ms per RHS against the eager "
              f"loop's {e_ms:.4f} ms")
    # no single PyTorch call computes any of these: library_ms is null
    kernels_line = [
        {"name": name, "route": "cuda",
         "source": f"esdg_cns_tpu_torch/csrc/{src}",
         "replaces": rep if "/" in rep else f"esdg_cns_tpu/ops/{rep}",
         "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
         "bound_ms": b.ms, "bound_by": b.by, "priced_bound_ms": pb,
         "library_ms": None}
        for (name, src, rep, n, err, ms, pms, b), pb in zip(rows, priced)
    ]
    return kernels_line


def main(parent=None):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from esdg_cns_tpu_torch import kernels
    from esdg_cns_tpu_torch.ops import cns_surface as cs
    from esdg_cns_tpu_torch.ops import cns_tail as ct
    from esdg_cns_tpu_torch.ops import dense_fd as df
    from esdg_cns_tpu_torch.ops import fused_volume as fv
    from esdg_cns_tpu_torch.ops import modal_volume as mv
    from esdg_cns_tpu_torch.ops import surface_viscous as sv
    from esdg_cns_tpu_torch.ops import tensor_product_fd as tp
    from esdg_cns_tpu_torch.ops.lsrk45_update import lsrk45_update
    from esdg_cns_tpu_torch.solvers._shared import neighbor_traction
    from esdg_cns_tpu_torch.presets import (euler_hex_3d, lid_driven_cavity,
                                            lid_driven_cavity_3d)
    from esdg_cns_tpu_torch.solvers import (make_cns_rhs, make_cns_rhs_affine,
                                            make_euler_rhs,
                                            make_euler_rhs_fused)
    from esdg_cns_tpu_torch.physics import primitive_to_conservative
    from esdg_cns_tpu_torch.timestepping import lsrk45
    # the cavity BC shapes, moving states and the kernels' arguments,
    # shared with tests/test_torch_gpu.py
    from esdg_cns_tpu_torch.cavity_cases import (CAVITY_BCS, VELOCITY,
                                                 cavity_case, fd_inputs,
                                                 k4_inputs, k7_inputs,
                                                 k8_inputs, tail_inputs,
                                                 warped_tri_case)

    wrappers = {"euler_volume": fv.euler_volume,
                "euler_surface": fv.euler_surface,
                "euler_modal_volume": mv.euler_modal_volume,
                "cns_surface_viscous": sv.cns_surface_viscous,
                "cns_surface": cs.cns_surface,
                "cns_viscous": sv.cns_viscous,
                "flux_differencing_lines_fused":
                    tp.flux_differencing_lines_fused,
                "flux_differencing_dense": df.flux_differencing_dense,
                "hex_project": fv.hex_project, "hex_fd_dir": fv.hex_fd_dir,
                "hex_fd_dir_dense": fv.hex_fd_dir_dense,
                "lsrk45_update": lsrk45_update,
                "cns_traction_tail": ct.cns_traction_tail}

    # the plain stage work that K2 took in on grid meshes: the roll
    # exchange and the split combine, counted per call
    from esdg_cns_tpu_torch.core.discretization import grid_neighbours
    plain_work = {"grid_neighbours": grid_neighbours,
                  "split_combine": fv.split_combine}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        for f in plain_work.values():
            f.calls = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    def no_plain_work(tag):
        """Raise unless the run since zero_counts() made no roll exchange
        and no split combine (grid meshes: K2 does both)."""
        calls = {name: f.calls for name, f in plain_work.items()}
        print(f"{tag}: plain exchange and combine calls {calls}")
        if any(calls.values()):
            raise AssertionError(f"{tag}: the stage ran plain work that K2 "
                                 f"takes in: {calls}")

    # ---- 1. device ----
    stamp("1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    dev = torch.device("cuda", 0)
    print(card)   # name, power limit — as nvidia-smi gives them
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ----
    stamp("2")
    info = kernels.build()
    kernels.library()
    print(f"build: {info.seconds:.1f} s -> {info.path.name}")
    secs = sorted(info.source_seconds().items(), key=lambda kv: -kv[1])
    if secs:
        print("nvcc per source, all started together: " + ", ".join(
            f"{name} {sec:.1f} s" for name, sec in secs))
    for line in ptxas_report(info.log):
        print(line)
    # K1's and K3's launch shapes: warps resident per SM beside ptxas'
    # registers and spills
    kernel_shapes(dev, info.log)

    gamma = 1.4

    def random_affine(disc, seed=11):
        """Seeded non-diagonal affine geometry: geo [9, 1, K] with all nine
        entries O(1), nxj [3, Nfq, K] with sj = |nxj| and inv_sj = 1/sj,
        and inv_jac [Nq, K] varying per node."""
        rng = np.random.default_rng(seed)
        k = disc.num_elements
        geo = (rng.uniform(0.5, 1.5, (9, 1, k))
               * rng.choice([-1.0, 1.0], (9, 1, k)))
        nxj = rng.standard_normal((3, disc.nfq, k))
        sj = np.sqrt((nxj ** 2).sum(axis=0))
        inv_jac = rng.uniform(0.5, 2.0, (disc.nq, k))
        t = lambda a: torch.as_tensor(a, dtype=disc.wq.dtype, device=dev)
        return t(geo), t(nxj), t(sj), t(1.0 / sj), t(inv_jac)

    def random_state(disc, seed):
        """Seeded moving state: density and pressure 2 + 0.1 U(0, 1), all
        three velocity components 0.3 N(0, 1), so no velocity term of the
        kernels multiplies zeros (the preset's field moves along y only)."""
        rng = np.random.default_rng(seed)
        sh = (disc.np_, disc.num_elements)
        t = lambda a: torch.as_tensor(a, dtype=disc.wq.dtype, device=dev)
        return primitive_to_conservative(
            t(2 + 0.1 * rng.random(sh)),
            t(0.3 * rng.standard_normal((3, *sh))),
            t(2 + 0.1 * rng.random(sh)))

    def curved_geom(disc):
        """The general kernels' geometry of a curved mesh: the metric at
        every hybridized point, per-point normals, sj, 1/sj and 1/J."""
        return (disc.geo, torch.stack(disc.nxj), disc.sj, disc.inv_sj,
                disc.inv_jac)

    def dtype_name(t):
        return str(t.dtype).replace("torch.", "")

    def check_kernels(disc, q, diag, tag, geom=None):
        dtype = str(q.dtype).replace("torch.", "")
        tol = TOL[dtype]
        ef = disc.vhp[disc.nq:]
        if geom is not None:
            geo, nxj, sj, inv_sj, inv_jac = geom
        elif diag:
            geo, sj, inv_sj = disc.geo, disc.sj, disc.inv_sj
            nxj = (disc.nxj[0] + disc.nxj[1] + disc.nxj[2])[None]
            inv_jac = disc.inv_jac[:1]
        else:
            geo, sj, inv_sj = disc.geo, disc.sj, disc.inv_sj
            nxj, inv_jac = torch.stack(disc.nxj), disc.inv_jac
        vargs = (q, geo, ef, disc.lift, gamma)
        vkw = dict(line_ops=disc.line_ops, diag=diag)
        p_out, p_tr = fv.euler_volume_plain(*vargs, **vkw)
        k_out, k_tr = fv.euler_volume(*vargs, **vkw)
        torch.cuda.synchronize()
        e_out, a_out = rel_err(k_out, p_out)
        e_tr, a_tr = rel_err(k_tr, p_tr)
        print(f"K1 euler_volume {tag}: ph_qf rel {e_out:.3e}, traces rel "
              f"{e_tr:.3e} (tol {tol:.0e})")
        if not (e_out <= tol and e_tr <= tol):
            raise AssertionError(f"K1 disagrees with its plain version ({tag})")
        # K2 in the gathered form (the neighbour traces given) and the
        # grid form the paths run (the kernel reads them itself)
        nbr = disc.gather_traces(p_tr)
        a_s = 0.0
        for form, nb, grid in (("gathered", nbr, None),
                               ("grid", None, disc.grid_shape)):
            sargs = (p_tr, nb, nxj, sj, inv_sj, inv_jac, disc.lift, p_out,
                     gamma)
            skw = dict(dissipation=True, diag=diag, grid=grid)
            p_s = fv.euler_surface_plain(*sargs, **skw)
            k_s = fv.euler_surface(*sargs, **skw)
            torch.cuda.synchronize()
            e_s, a = rel_err(k_s, p_s)
            a_s = max(a_s, a)
            print(f"K2 euler_surface {form} {tag}: rel {e_s:.3e} (tol "
                  f"{tol:.0e})")
            if not e_s <= tol:
                raise AssertionError(f"K2 ({form}) disagrees with its plain "
                                     f"version ({tag})")
        return max(a_out, a_tr), a_s, vargs, vkw, sargs, skw, (k_out, k_tr,
                                                               k_s)

    # ---- 3. Euler kernels against their plain versions ----
    stamp("3")
    disc, q0 = euler_hex_3d(n=N, k1d=K1D, dtype=torch.float32, device=dev)
    if not fv.detect_axis_aligned(disc):
        raise AssertionError("the k1d=32 mesh must be detected axis-aligned")
    main_abs_v, main_abs_s, vargs, vkw, sargs, skw, kouts = check_kernels(
        disc, q0, True, "N=3 k1d=32 f32 diag (main path)")
    disc8, q8 = euler_hex_3d(n=N, k1d=8, dtype=torch.float64, device=dev)
    check_kernels(disc8, q8, True, "N=3 k1d=8 f64 diag")
    check_kernels(disc8, q8, False, "N=3 k1d=8 f64 general")
    check_kernels(disc8, q8, False, "N=3 k1d=8 f64 general, random metric",
                  random_affine(disc8))
    check_kernels(disc, q0, False, "N=3 k1d=32 f32 general, random metric",
                  random_affine(disc))
    del disc8, q8

    # ---- 4. the Euler path ----
    stamp("4")
    rhs = make_euler_rhs_fused(disc, dissipation=True)
    zero_counts()
    qf, _ = lsrk45(rhs, q0, DT, STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: counts[k] for k in ("euler_volume", "euler_surface",
                                       "lsrk45_update")}
    stages = 5 * STEPS
    print(f"main path: {STEPS} LSRK45 steps ({stages} stages), launches "
          f"{launches}")
    if any(v != stages for v in launches.values()):
        raise AssertionError(f"expected {stages} launches of each kernel")
    no_plain_work("main path")
    if qf.dtype != torch.float32 or not bool(torch.isfinite(qf).all()):
        raise AssertionError("main-path state not finite f32")

    twin = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)
    qt, _ = lsrk45(twin, q0, DT, STEPS)
    e_twin, _ = rel_err(qf, qt)
    print(f"fused vs plain twin after {STEPS} steps: rel {e_twin:.3e} "
          f"(tol {TWIN_TOL_F32:.0e})")
    if not e_twin <= TWIN_TOL_F32:
        raise AssertionError("fused path disagrees with the plain twin")
    del qt

    def check_conservation(disc, q0, qf, tag):
        w = disc.wjq.double()[None]
        before = (w * q0.double()).sum(dim=(1, 2))
        after = (w * qf.double()).sum(dim=(1, 2))
        mass = float(before[0])
        drift = [abs(float(a - b)) / mass for a, b in zip(after, before)]
        print(f"{tag}conservation |d sum(wJq q_f)| / sum(wJq rho): "
              + ", ".join(f"{d:.2e}" for d in drift)
              + f" (tol {CONSERVATION_TOL_F32:.0e})")
        if not max(drift) <= CONSERVATION_TOL_F32:
            raise AssertionError("conservation violated")

    check_conservation(disc, q0, qf, "")

    disc4, q4 = euler_hex_3d(n=N, k1d=4, dtype=torch.float64, device=dev)
    _, aux = make_euler_rhs_fused(disc4, dissipation=False,
                                  compute_rhstest=True)(q4)
    rt = float(aux["rhstest"])
    print(f"f64 k1d=4 kernel path, dissipation off: rhstest {rt:.3e} "
          f"(tol {RHSTEST_TOL_F64:.0e})")
    if not abs(rt) <= RHSTEST_TOL_F64:
        raise AssertionError("entropy conservation violated")
    del disc4, q4

    # ---- 5. Euler timing ----
    stamp("5")
    dof = 5 * disc.np_ * disc.num_elements
    step_ms = cuda_ms(lambda: lsrk45(rhs, q0, DT, TIMED_STEPS), 1)
    rate = dof * 5 * TIMED_STEPS / (step_ms / 1e3)
    twin_ms = cuda_ms(lambda: lsrk45(twin, q0, DT, TWIN_TIMED_STEPS), 1)
    twin_rate = dof * 5 * TWIN_TIMED_STEPS / (twin_ms / 1e3)
    stage_ms = step_ms / (5 * TIMED_STEPS)
    print(f"[{card}] main path (K1+K2, LSRK45): {rate:.4e} "
          f"DOF*RK-stage/s, {stage_ms:.4f} ms/stage over "
          f"{5 * TIMED_STEPS} stages, median of {REPEATS}")
    print(f"[{card}] plain twin: {twin_rate:.4e} DOF*RK-stage/s, "
          f"{twin_ms / (5 * TWIN_TIMED_STEPS):.4f} ms/stage over "
          f"{5 * TWIN_TIMED_STEPS} stages, median of {REPEATS}")

    dev_ms = lambda fn, n: cuda_ms(fn, n, device_only=True)
    k1_ms = dev_ms(lambda: fv.euler_volume(*vargs, **vkw), 20)
    k1_plain_ms = dev_ms(lambda: fv.euler_volume_plain(*vargs, **vkw), 2)
    k2_ms = dev_ms(lambda: fv.euler_surface(*sargs, **skw), 20)
    k2_plain_ms = dev_ms(lambda: fv.euler_surface_plain(*sargs, **skw), 2)
    # the gathered form and the roll exchange it needs: no longer in the
    # stage, timed for the record
    gather_ms = dev_ms(lambda: disc.gather_traces(sargs[0]), 20)
    gsk = (sargs[0], disc.gather_traces(sargs[0]), *sargs[2:])
    gskw = dict(skw, grid=None)
    k2_gathered_ms = dev_ms(lambda: fv.euler_surface(*gsk, **gskw), 20)
    for name, ms, pms in (("K1 euler_volume", k1_ms, k1_plain_ms),
                          ("K2 euler_surface (grid)", k2_ms, k2_plain_ms)):
        print(f"[{card}] {name} N=3 k1d=32 f32: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms ({pms / ms:.1f}x), device times")
    print(f"[{card}] main stage: K1 {k1_ms:.4f} + K2 {k2_ms:.4f} = "
          f"{k1_ms + k2_ms:.4f} ms of {stage_ms:.4f} ms; not in the stage: "
          f"the roll exchange {gather_ms:.4f} ms, K2 on gathered traces "
          f"{k2_gathered_ms:.4f} ms")
    del gsk
    print_profile(card, "Euler path", device_profile(
        lambda: lsrk45(rhs, q0, DT, 4), 20))
    # the diag-vs-general delta: the general contraction on the same
    # uniform mesh, whose off-axis metric terms are exact zeros
    grhs = make_euler_rhs_fused(disc, dissipation=True, axis_aligned=False)
    e_g, _ = rel_err(grhs(q0)[0], rhs(q0)[0])
    gstep_ms = cuda_ms(lambda: lsrk45(grhs, q0, DT, TIMED_STEPS), 1)
    gstage_ms = gstep_ms / (5 * TIMED_STEPS)
    gvkw = dict(vkw, diag=False)
    gsargs = (*sargs[:2], torch.stack(disc.nxj), disc.sj, disc.inv_sj,
              disc.inv_jac, *sargs[6:])   # the grid form, general
    gskw = dict(skw, diag=False)
    k1g_ms = dev_ms(lambda: fv.euler_volume(*vargs, **gvkw), 20)
    k2g_ms = dev_ms(lambda: fv.euler_surface(*gsargs, **gskw), 20)
    print(f"[{card}] diag vs general on the uniform k1d={K1D} mesh "
          f"(axis_aligned=False; one RHS agrees rel {e_g:.3e}): general "
          f"{dof * 5 * TIMED_STEPS / (gstep_ms / 1e3):.4e} DOF*RK-stage/s, "
          f"{gstage_ms:.4f} ms/stage against diag {stage_ms:.4f} "
          f"({gstage_ms / stage_ms - 1:+.1%}); K1 general {k1g_ms:.4f} ms "
          f"against diag {k1_ms:.4f} ({k1g_ms / k1_ms - 1:+.1%}); K2 general "
          f"{k2g_ms:.4f} ms against diag {k2_ms:.4f} "
          f"({k2g_ms / k2_ms - 1:+.1%}), device times")
    if not e_g <= TOL["float32"]:
        raise AssertionError("the general contraction disagrees with diag")
    del grhs, gsargs
    update_phase(card, dev_ms, q0, rhs(q0)[0])
    k_out, k_tr, k_s = kouts
    ne = disc.num_elements
    # bytes the diag variants read and write: q, geo, Ef, LIFT -> ph_qf,
    # traces; the grid form of K2: traces (its neighbours' are the same
    # array), compact nxj, 1/J, LIFT, ph_qf -> dq
    k1_bound = bound(nbytes(q0, disc.geo, vargs[2], disc.lift, k_out, k_tr),
                     ops_k1(N + 1, entries(vargs[2]), entries(vargs[3]))
                     * ne,
                     q0.dtype)
    k2_bound = bound(nbytes(sargs[0], sargs[2], sargs[5], disc.lift,
                            sargs[7], k_s),
                     ops_k2(N + 1, entries(disc.lift)) * ne,
                     q0.dtype)
    udisc = disc      # the uniform mesh, for row 10 (phase 16)
    del rhs, twin, qf, vargs, sargs, kouts, k_out, k_tr, k_s, disc, q0
    torch.cuda.empty_cache()

    # ---- 6. cavity kernels against their plain versions ----
    stamp("6")
    def held(name, tag, kern, plain, tol, names):
        """max |kernel - plain| / max |plain| per output, printed; raises
        past tol; returns the largest absolute error."""
        torch.cuda.synchronize()
        errs = []
        for a, b in zip(kern, plain):
            d, m = float((a - b).abs().max()), float(b.abs().max())
            errs.append((d / m if m > 0 else d, d))
        print(f"{name} {tag}: rel " + ", ".join(
            f"{n} {e:.3e}" for n, (e, _) in zip(names, errs))
            + f" (tol {tol:.0e})")
        if not all(e <= tol for e, _ in errs):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({tag})")
        return max(a for _, a in errs)

    def cavity_kernels(disc, q, bc, p, tag, t=0.0, proj=None,
                       contracts=(True,)):
        """The CNS kernels against their plain versions: the volume front
        (K3, the modal front, when proj; else K1 on collocated hexes; proj
        None: K1 on hexes, K3 elsewhere), K4 (both fold_tail forms), K8 and
        K7 with each of `contracts` (keys "k7" for the contracted
        traction, "k7_components" for the component traces).  Returns
        ({kernel: max abs error}, {kernel: arguments}, the front kernel's
        outputs)."""
        tol = TOL[str(q.dtype).replace("torch.", "")]
        nq = disc.nq
        proj = disc.dim != 3 if proj is None else proj
        errs, ins = {}, {}
        if proj:
            args = (q, disc.geo, torch.stack(disc.q_skew), disc.vq,
                    disc.vhp, disc.ph, gamma)
            kw = dict(nq=nq)
            front_k = mv.euler_modal_volume(*args, **kw)
            errs["front"] = held(
                f"K3 euler_modal_volume dim={disc.dim}", tag, front_k,
                mv.euler_modal_volume_plain(*args, **kw), tol,
                ("ph_qf", "traces", "vu_q"))
        else:
            args = (q, disc.geo, disc.vhp[nq:], disc.lift, gamma)
            kw = dict(line_ops=disc.line_ops,
                      diag=fv.detect_axis_aligned(disc))
            front_k = fv.euler_volume(*args, **kw)
            errs["front"] = held("K1 euler_volume", tag, front_k,
                                 fv.euler_volume_plain(*args, **kw), tol,
                                 ("ph_qf", "traces"))
        ins["front"] = (args, kw)
        form = f"({disc.dim}, {proj})"
        k4args, k4tail, k4kw = k4_inputs(disc, q, bc, p, t=t, proj=proj)
        a7, kw7 = k7_inputs(disc, q, bc, p, t=t, proj=proj)
        if disc.dim == 3:
            # K4 and K7 read the operator lists the RHS builds (the plain
            # versions the dense operators)
            lists = make_cns_rhs_affine(
                disc, volume_impl="fused" if proj else "fused_hex",
                mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                compute_rhstest=False).visc_lists
            k4kw = dict(k4kw, lists=lists)
            kw7 = dict(kw7, lists=lists)
        ins["k4"] = (k4args, k4tail, k4kw)
        rule = ct.traction_rule(disc, bc) if disc.dim == 3 else None
        if rule is not None:
            # the tail kernel after K4's fold_tail form, where its rule
            # covers the walls, against the plain tail
            (dq_part, t_f, lift, inv_j), t_pn = tail_inputs(disc, q, bc, p,
                                                            t=t)
            ins["tail"] = (dq_part, t_f, lift, inv_j, rule, t_pn)
            errs["tail"] = held(
                "tail cns_traction_tail", tag,
                (ct.cns_traction_tail(dq_part.clone(), t_f, lift, inv_j,
                                      rule=rule),),
                (ct.cns_traction_tail_plain(dq_part, t_f, lift, inv_j,
                                            t_pn=t_pn),), tol, ("dq",))
        errs["k4"] = 0.0
        for fold in (False, True):
            tail = k4tail if fold else ()
            names = (("dq_part", "t_f", "prod", "vuq") if fold else
                     ("flux", "pen", "t_f", "div", "prod", "vuq"))
            errs["k4"] = max(errs["k4"], held(
                f"K4 cns_surface_viscous {form}", f"{tag} fold_tail={fold}",
                sv.cns_surface_viscous(*k4args, *tail, fold_tail=fold,
                                       **k4kw),
                sv.cns_surface_viscous_plain(*k4args, *tail, fold_tail=fold,
                                             **k4kw), tol, names))
        ins["k8"] = k8_inputs(disc, q, bc, p, t=t, proj=proj)
        errs["k8"] = held(f"K8 cns_surface dim={disc.dim}", tag,
                          cs.cns_surface(*ins["k8"][0], **ins["k8"][1]),
                          cs.cns_surface_plain(*ins["k8"][0],
                                               **ins["k8"][1]), tol,
                          ("flux", "dv", "pen"))
        for contract in contracts:
            key = "k7" if contract else "k7_components"
            ins[key] = (a7, dict(kw7, contract=contract))
            errs[key] = held(
                f"K7 cns_viscous {form} contract={contract}", tag,
                sv.cns_viscous(*a7, **ins[key][1]),
                sv.cns_viscous_plain(*a7, **ins[key][1]), tol,
                ("s_f", "div", "prod", "vuq"))
        return errs, ins, front_k

    cdisc, cq, cbc, cp = cavity_case("isothermal", CAV_N, CAV_K1D,
                                     torch.float32, dev)
    cerrs, cins, k3outs = cavity_kernels(
        cdisc, cq, cbc, cp, f"tri N=3 k1d={CAV_K1D} f32 isothermal (cavity "
        "path)")
    print(f"(kernel checks on moving states: density and pressure x (1 + "
          f"0.01 n), velocity + {VELOCITY} n, n seeded standard normal; "
          f"max |u| {float((cq[1:3] / cq[0]).abs().max()):.3f} at k1d="
          f"{CAV_K1D})")
    for case in CAVITY_BCS:
        d8, q8, bc8, p8 = cavity_case(case, CAV_N, 8, torch.float64, dev)
        cavity_kernels(d8, q8, bc8, p8, f"tri N=3 k1d=8 f64 {case}")
    d5, q5, bc5, p5 = cavity_case("isothermal", CAV_N, 5, torch.float64,
                                  dev)
    cavity_kernels(d5, q5, bc5, p5, "tri N=3 k1d=5 (K=50, ragged tile) f64 "
                   "isothermal")
    del d8, q8, bc8, d5, q5, bc5

    # ---- 7. the cavity path ----
    stamp("7")
    cdisc, cq0, cbc, cp = lid_driven_cavity(CAV_N, CAV_K1D,
                                            dtype=torch.float32, device=dev)
    flags = dict(mu=cp["mu"], pr=cp["pr"], re=cp["re"], bc=cbc,
                 inviscid_dissipation=True, viscous_dissipation=True,
                 compute_rhstest=False)
    crhs = make_cns_rhs_affine(cdisc, volume_impl="fused",
                               surface_impl="auto", **flags)
    zero_counts()
    cqf, _ = lsrk45(crhs, cq0, CAV_DT, CAV_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    cav_launches = {k: counts[k] for k in ("euler_modal_volume",
                                           "cns_surface_viscous",
                                           "lsrk45_update")}
    stages = 5 * CAV_STEPS
    print(f"cavity path: {CAV_STEPS} LSRK45 steps ({stages} stages) at "
          f"dt={CAV_DT:g}, launches {counts}")
    if any(v != stages for v in cav_launches.values()):
        raise AssertionError(f"expected {stages} launches of K3, K4 and "
                             "the update")
    if cqf.dtype != torch.float32 or not bool(torch.isfinite(cqf).all()):
        raise AssertionError("cavity state not finite f32")
    ctwin = make_cns_rhs(cdisc, **flags)
    cqt, _ = lsrk45(ctwin, cq0, CAV_DT, CAV_STEPS)
    e_ctwin, _ = rel_err(cqf, cqt)
    print(f"cavity fused vs twin make_cns_rhs after {CAV_STEPS} steps: rel "
          f"{e_ctwin:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_ctwin <= TWIN_TOL_F32:
        raise AssertionError("cavity path disagrees with the twin")

    def mass(disc, q):
        return float((disc.wjq.double()
                      * (disc.vq.double() @ q[0].double())).sum())

    cdrift = abs(mass(cdisc, cqf) - mass(cdisc, cq0)) / mass(cdisc, cq0)
    cdrift_twin = abs(mass(cdisc, cqt) - mass(cdisc, cq0)) / mass(cdisc, cq0)
    d64, q64, bc64, p64 = lid_driven_cavity(CAV_N, CAV_K1D,
                                            dtype=torch.float64, device=dev)
    zero_counts()
    q64f, _ = lsrk45(make_cns_rhs_affine(d64, volume_impl="fused",
                                         **dict(flags, bc=bc64)),
                     q64, CAV_DT, CAV_STEPS)
    cdrift64 = abs(mass(d64, q64f) - mass(d64, q64)) / mass(d64, q64)
    print(f"cavity mass |d sum(wJq rho)| / sum(wJq rho) after {CAV_STEPS} "
          f"steps: f32 {cdrift:.2e} (tol {CAV_MASS_TOL_F32:.0e}; the f32 "
          f"twin make_cns_rhs from the same q0: {cdrift_twin:.2e}), f64 "
          f"kernel path (launches {read_counts()}) {cdrift64:.2e} (tol "
          f"{CAV_MASS_TOL_F64:.0e})")
    if not (cdrift <= CAV_MASS_TOL_F32 and cdrift64 <= CAV_MASS_TOL_F64):
        raise AssertionError("cavity mass not conserved")
    del d64, q64, q64f

    edisc, eq0, ebc, ep = lid_driven_cavity(CAV_N, 8, bctype="adiabatic",
                                            lid_profile=lambda x: 0.0 * x,
                                            dtype=torch.float64, device=dev)
    rng = np.random.default_rng(1)
    eq = eq0 + 1e-3 * torch.as_tensor(
        rng.standard_normal(tuple(eq0.shape)), device=dev) * torch.tensor(
        [1.0, 0.1, 0.1, 1.0], dtype=torch.float64, device=dev)[:, None, None]
    zero_counts()
    _, eaux = make_cns_rhs_affine(
        edisc, mu=ep["mu"], pr=ep["pr"], re=ep["re"], bc=ebc,
        inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl="fused", compute_rhstest=True)(eq)
    rtv, rt = float(eaux["rhstest_visc"]), float(eaux["rhstest"])
    print(f"f64 k1d=8 kernel path (K3 + K4 merged, launches "
          f"{read_counts()}), adiabatic walls at rest: rhstest_visc "
          f"{rtv:.3e} (>= 0), rhstest {rt:.3e} (< {RHSTEST_TOL_F64:.0e})")
    if not (rtv >= 0.0 and rt < RHSTEST_TOL_F64):
        raise AssertionError("cavity entropy stability violated")
    del edisc, eq0, eq

    # ---- 8. cavity timing ----
    stamp("8")
    def path_timing(label, rhs, q0, dof, twin):
        """(ms per stage, DOF*RK-stage/s) of rhs over 1200 stages, and the
        twin's rate, printed."""
        step_ms = cuda_ms(lambda: lsrk45(rhs, q0, CAV_TIMED_DT, TIMED_STEPS),
                          1)
        rate = dof * 5 * TIMED_STEPS / (step_ms / 1e3)
        stage_ms = step_ms / (5 * TIMED_STEPS)
        print(f"[{card}] {label}: {rate:.4e} DOF*RK-stage/s, "
              f"{stage_ms:.4f} ms/stage over {5 * TIMED_STEPS} stages, "
              f"median of {REPEATS}")
        if twin is not None:
            twin_ms = cuda_ms(lambda: lsrk45(twin, q0, CAV_TIMED_DT,
                                             TWIN_TIMED_STEPS), 1)
            print(f"[{card}] {label}, twin make_cns_rhs: "
                  f"{dof * 5 * TWIN_TIMED_STEPS / (twin_ms / 1e3):.4e} "
                  f"DOF*RK-stage/s, {twin_ms / (5 * TWIN_TIMED_STEPS):.4f} "
                  f"ms/stage over {5 * TWIN_TIMED_STEPS} stages, median of "
                  f"{REPEATS}")
        return stage_ms, rate

    def kernel_times(shape, calls):
        """Device times of each (name, kernel call, plain call), printed
        beside the host's back-to-back time; returns {name: (ms, plain
        ms)}."""
        out = {}
        for name, kcall, pcall in calls:
            ms, pms = dev_ms(kcall, 20), dev_ms(pcall, 2)
            print(f"[{card}] {name} {shape}: kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms ({pms / ms:.1f}x), device times; back to "
                  f"back from the host {cuda_ms(kcall, 20):.4f} ms")
            out[name] = (ms, pms)
        return out

    cdof = 4 * cdisc.np_ * cdisc.num_elements
    cstage_ms, _ = path_timing(
        "cavity path (K3+exchange+K4+exchange+LIFT, LSRK45)", crhs, cq0,
        cdof, ctwin)
    k3args, k3kw = cins["front"]
    k4args, k4tail, k4kw = cins["k4"]
    k3l = k3_lists(mv, k3args, k3kw)
    k3_call = lambda: mv.euler_modal_volume(*k3args, **k3kw, lists=k3l)
    k4_call = lambda: sv.cns_surface_viscous(*k4args, *k4tail,
                                             fold_tail=True, **k4kw)
    ctimes = kernel_times(f"tri N=3 k1d={CAV_K1D} f32", [
        ("K3 euler_modal_volume", k3_call,
         lambda: mv.euler_modal_volume_plain(*k3args, **k3kw)),
        ("K4 cns_surface_viscous (fold_tail)", k4_call,
         lambda: sv.cns_surface_viscous_plain(*k4args, *k4tail,
                                              fold_tail=True, **k4kw))])
    k3_ms, k3_plain_ms = ctimes["K3 euler_modal_volume"]
    k4_ms, k4_plain_ms = ctimes["K4 cns_surface_viscous (fold_tail)"]
    tr = k3outs[1]
    k4out = k4_call()
    ex1_ms = dev_ms(lambda: cdisc.gather_traces(tr), 20)
    ex2_ms = dev_ms(lambda: cdisc.gather_traces(k4out[1]), 20)
    rest = cstage_ms - k3_ms - k4_ms - ex1_ms - ex2_ms
    print(f"[{card}] cavity stage split: K3 {k3_ms:.4f} + exchange 1 "
          f"(index_select, 6 rows) {ex1_ms:.4f} + K4 {k4_ms:.4f} + exchange "
          f"2 (index_select, 4 rows) {ex2_ms:.4f} + rest (traction BC, jump "
          f"LIFT, 1/J, LSRK45 update, host gaps) {rest:.4f} = "
          f"{cstage_ms:.4f} ms")
    cstage_dev_ms = dev_ms(lambda: lsrk45(crhs, cq0, CAV_TIMED_DT, 10),
                           1) / 50
    print(f"[{card}] cavity stage device time (queued ahead of the "
          f"device): {cstage_dev_ms:.4f} ms of {cstage_ms:.4f} ms")
    print_profile(card, "cavity path", device_profile(
        lambda: lsrk45(crhs, cq0, CAV_TIMED_DT, 4), 20))
    cne = cdisc.num_elements
    k3_bound = bound(nbytes(*k3args[:6], *k3outs),
                     ops_k3(2, cdisc.vq, cdisc.vhp, cdisc.ph, k3args[2],
                            cdisc.nq) * cne,
                     k3args[0].dtype)
    k4_bound = bound(nbytes(*k4args, *k4tail, *k4out),
                     ops_k4(2, cdisc.np_, cdisc.nq, cdisc.nfq, k4args,
                            k4tail[1]) * cne,
                     k4args[0].dtype)
    del ctwin, k4out

    # ---- 9. 3D cavity kernels against their plain versions ----
    stamp("9")
    hdisc, hq, hbc, hp = cavity_case("isothermal", CAV3_N, CAV3_K1D,
                                     torch.float32, dev, dim=3)
    herrs, hins, k1outs = cavity_kernels(
        hdisc, hq, hbc, hp, f"hex N=3 k1d={CAV3_K1D} f32 isothermal (3D "
        "cavity path)")
    for case in CAVITY_BCS:
        d4, q4, bc4, p4 = cavity_case(case, CAV3_N, 4, torch.float64, dev,
                                      dim=3)
        cavity_kernels(d4, q4, bc4, p4, f"hex N=3 k1d=4 f64 {case}")
    d3, q3, bc3, p3 = cavity_case("isothermal", CAV3_N, 3, torch.float64,
                                  dev, dim=3)
    cavity_kernels(d3, q3, bc3, p3, "hex N=3 k1d=3 (K=27, ragged tile) f64 "
                   "isothermal")
    del d4, q4, bc4, d3, q3, bc3

    # ---- 10. the 3D cavity path ----
    stamp("10")
    hdisc, hq0, hbc, hp = lid_driven_cavity_3d(CAV3_N, CAV3_K1D,
                                               dtype=torch.float32,
                                               device=dev)
    if not fv.detect_axis_aligned(hdisc):
        raise AssertionError("the 3D cavity mesh must be detected "
                             "axis-aligned")
    hflags = dict(flags, mu=hp["mu"], pr=hp["pr"], re=hp["re"], bc=hbc)
    hrhs = make_cns_rhs_affine(hdisc, volume_impl="fused_hex",
                               surface_impl="auto", **hflags)
    zero_counts()
    hqf, _ = lsrk45(hrhs, hq0, CAV_DT, CAV_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    cav3_launches = {k: counts[k] for k in ("euler_volume",
                                            "cns_surface_viscous",
                                            "cns_traction_tail",
                                            "lsrk45_update")}
    print(f"3D cavity path: {CAV_STEPS} LSRK45 steps ({stages} stages) at "
          f"dt={CAV_DT:g}, launches {counts}")
    if any(v != stages for v in cav3_launches.values()):
        raise AssertionError(f"expected {stages} launches of K1, K4, the "
                             "tail kernel and the update")
    if hqf.dtype != torch.float32 or not bool(torch.isfinite(hqf).all()):
        raise AssertionError("3D cavity state not finite f32")
    htwin = make_cns_rhs(hdisc, **hflags)
    hqt, _ = lsrk45(htwin, hq0, CAV_DT, CAV_STEPS)
    e_htwin, _ = rel_err(hqf, hqt)
    print(f"3D cavity fused_hex vs twin make_cns_rhs after {CAV_STEPS} "
          f"steps: rel {e_htwin:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_htwin <= TWIN_TOL_F32:
        raise AssertionError("3D cavity path disagrees with the twin")
    hdrift = abs(mass(hdisc, hqf) - mass(hdisc, hq0)) / mass(hdisc, hq0)
    del hqt
    d64, q64, bc64, p64 = lid_driven_cavity_3d(CAV3_N, CAV3_K1D,
                                               dtype=torch.float64,
                                               device=dev)
    zero_counts()
    q64f, _ = lsrk45(make_cns_rhs_affine(d64, volume_impl="fused_hex",
                                         **dict(hflags, bc=bc64)),
                     q64, CAV_DT, CAV_STEPS)
    hdrift64 = abs(mass(d64, q64f) - mass(d64, q64)) / mass(d64, q64)
    print(f"3D cavity mass |d sum(wJq rho)| / sum(wJq rho) after "
          f"{CAV_STEPS} steps: f32 {hdrift:.2e} (printed), f64 kernel path "
          f"(launches {read_counts()}) {hdrift64:.2e} (tol "
          f"{CAV_MASS_TOL_F64:.0e})")
    if not hdrift64 <= CAV_MASS_TOL_F64:
        raise AssertionError("3D cavity mass not conserved")
    if read_counts()["cns_traction_tail"] != stages:
        raise AssertionError(f"expected {stages} launches of the tail "
                             "kernel on the f64 3D cavity path")
    del d64, q64, q64f

    edisc, eq0, ebc, ep = lid_driven_cavity_3d(CAV3_N, 4, bctype="adiabatic",
                                               dtype=torch.float64,
                                               device=dev)
    ebc.regions[0].u_wall = (0.0, 0.0, 0.0)       # the lid at rest
    rng = np.random.default_rng(1)
    eq = eq0 + 1e-3 * torch.as_tensor(
        rng.standard_normal(tuple(eq0.shape)), device=dev) * torch.tensor(
        [1.0, 0.1, 0.1, 0.1, 1.0], dtype=torch.float64,
        device=dev)[:, None, None]
    zero_counts()
    _, eaux = make_cns_rhs_affine(
        edisc, mu=ep["mu"], pr=ep["pr"], re=ep["re"], bc=ebc,
        inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl="fused_hex", surface_impl="merged",
        compute_rhstest=True)(eq)
    rtv, rt = float(eaux["rhstest_visc"]), float(eaux["rhstest"])
    print(f"f64 hex k1d=4 kernel path (K1 + K4 merged, launches "
          f"{read_counts()}), adiabatic walls, lid at rest: rhstest_visc "
          f"{rtv:.3e} (>= 0), rhstest {rt:.3e} (< {RHSTEST_TOL_F64:.0e})")
    if not (rtv >= 0.0 and rt < RHSTEST_TOL_F64):
        raise AssertionError("3D cavity entropy stability violated")
    del edisc, eq0, eq

    # ---- 11. 3D cavity timing ----
    stamp("11")
    hdof = 5 * hdisc.np_ * hdisc.num_elements
    hstage_ms, _ = path_timing(
        "3D cavity path (K1+exchange+K4+exchange+LIFT, LSRK45)", hrhs, hq0,
        hdof, htwin)
    k1args, k1kw = hins["front"]
    h4args, h4tail, h4kw = hins["k4"]
    k1_call = lambda: fv.euler_volume(*k1args, **k1kw)
    h4_call = lambda: sv.cns_surface_viscous(*h4args, *h4tail,
                                             fold_tail=True, **h4kw)
    htimes = kernel_times(f"hex N=3 k1d={CAV3_K1D} f32", [
        ("K1 euler_volume (3D cavity)", k1_call,
         lambda: fv.euler_volume_plain(*k1args, **k1kw)),
        ("K4 cns_surface_viscous dim=3 (fold_tail)", h4_call,
         lambda: sv.cns_surface_viscous_plain(*h4args, *h4tail,
                                              fold_tail=True, **h4kw))])
    h1_ms = htimes["K1 euler_volume (3D cavity)"][0]
    h4_ms, h4_plain_ms = htimes["K4 cns_surface_viscous dim=3 (fold_tail)"]
    h4out = h4_call()
    tdq, tf_, tlift, tinv_j, trule, _ = hins["tail"]
    tdq_k = tdq.clone()     # the kernel writes dq over its dq_part
    ttimes = kernel_times(f"hex N=3 k1d={CAV3_K1D} f32", [
        ("tail cns_traction_tail (3D cavity)",
         lambda: ct.cns_traction_tail(tdq_k, tf_, tlift, tinv_j, rule=trule),
         lambda: ct.cns_traction_tail_plain(
             tdq, tf_, tlift, tinv_j, t_pn=neighbor_traction(
                 hdisc, hbc, tf_, hdisc.gather_traces(tf_))))])
    htail_ms, htail_plain_ms = ttimes["tail cns_traction_tail (3D cavity)"]
    # per element: the 5 x 6 LIFT entries of each volume node and the
    # scaled add (FMAs), a negate, a difference and a halving per field
    # of a face point
    htail_bound = bound(
        nbytes(tdq, tf_, trule.code, trule.wall, tlift, tinv_j, tdq),
        Ops(fma=35 * hdisc.nq, add=10 * hdisc.nfq, mul=5 * hdisc.nfq)
        * hdisc.num_elements, tdq.dtype)
    print(f"[{card}] tail kernel bound ({htail_bound.by}: dq_part, t_f, "
          f"the code, LIFT, 1/J in, dq out): {htail_bound.ms:.4f} ms, "
          f"{100 * htail_bound.ms / htail_ms:.2f}% of it; plain tail "
          f"{htail_plain_ms:.4f} ms")
    hex1_ms = dev_ms(lambda: hdisc.gather_traces(k1outs[1]), 20)
    hrest = hstage_ms - h1_ms - h4_ms - hex1_ms - htail_ms
    print(f"[{card}] 3D cavity stage split: K1 {h1_ms:.4f} + exchange 1 "
          f"(index_select, 7 rows) {hex1_ms:.4f} + K4 {h4_ms:.4f} + the "
          f"tail kernel (exchange 2, traction BC, jump LIFT, 1/J) "
          f"{htail_ms:.4f} + rest (v(U), the production's sum, LSRK45 "
          f"update, host gaps) {hrest:.4f} = {hstage_ms:.4f} ms")
    hstage_dev_ms = dev_ms(lambda: lsrk45(hrhs, hq0, CAV_TIMED_DT, 10),
                           1) / 50
    print(f"[{card}] 3D cavity stage device time (queued ahead of the "
          f"device): {hstage_dev_ms:.4f} ms of {hstage_ms:.4f} ms")
    print_profile(card, "3D cavity path", device_profile(
        lambda: lsrk45(hrhs, hq0, CAV_TIMED_DT, 4), 20))
    hne = hdisc.num_elements
    h4_bound = bound(nbytes(*h4args, *h4tail, *h4out),
                     ops_k4(3, hdisc.np_, hdisc.nq, hdisc.nfq, h4args,
                            h4tail[1]) * hne,
                     h4args[0].dtype)
    del htwin, h4out

    # ---- 12. the split path (K8 then K7) on both cavities ----
    stamp("12")
    split_rows = {}
    for label, disc, q0, pflags, vol, ins, small in (
            ("tri", cdisc, cq0, flags, "fused", cins,
             cavity_case("isothermal", CAV_N, 8, torch.float64, dev)),
            ("hex", hdisc, hq0, hflags, "fused_hex", hins,
             cavity_case("isothermal", CAV3_N, 4, torch.float64, dev,
                         dim=3))):
        split = make_cns_rhs_affine(disc, volume_impl=vol,
                                    surface_impl="fused", **pflags)
        merged = make_cns_rhs_affine(disc, volume_impl=vol,
                                     surface_impl="merged_tail", **pflags)
        qm_ = cq if label == "tri" else hq
        e32, _ = rel_err(split(qm_)[0], merged(qm_)[0])
        sd, sq, sbc, sp = small
        sflags = dict(pflags, mu=sp["mu"], pr=sp["pr"], re=sp["re"], bc=sbc)
        e64, _ = rel_err(
            make_cns_rhs_affine(sd, volume_impl=vol, surface_impl="fused",
                                **sflags)(sq)[0],
            make_cns_rhs_affine(sd, volume_impl=vol,
                                surface_impl="merged_tail", **sflags)(sq)[0])
        print(f"{label} split path (surface_impl='fused') vs merged_tail, "
              f"one RHS on a moving state: f32 full width rel {e32:.3e} (tol "
              f"{SPLIT_TOL['float32']:.0e}), f64 small rel {e64:.3e} (tol "
              f"{SPLIT_TOL['float64']:.0e})")
        if not (e32 <= SPLIT_TOL["float32"] and e64 <= SPLIT_TOL["float64"]):
            raise AssertionError(f"{label} split path disagrees with K4")
        zero_counts()
        sqf, _ = lsrk45(split, q0, CAV_DT, CAV_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{label} split path: {CAV_STEPS} LSRK45 steps ({stages} "
              f"stages), launches {counts}")
        front = "euler_modal_volume" if label == "tri" else "euler_volume"
        if any(counts[k] != stages for k in (front, "cns_surface",
                                             "cns_viscous", "lsrk45_update")):
            raise AssertionError(f"expected {stages} launches of the front, "
                                 "K8, K7 and the update")
        if not bool(torch.isfinite(sqf).all()):
            raise AssertionError(f"{label} split-path state not finite")
        dof = (disc.dim + 2) * disc.np_ * disc.num_elements
        path_timing(f"{label} split path (front+exchange+K8+K7+exchange+"
                    "LIFTs, LSRK45)", split, q0, dof, None)
        a8, kw8 = ins["k8"]
        a7, kw7 = ins["k7"]
        shape = (f"tri N=3 k1d={CAV_K1D} f32" if label == "tri"
                 else f"hex N=3 k1d={CAV3_K1D} f32")
        stimes = kernel_times(shape, [
            ("K8 cns_surface", lambda: cs.cns_surface(*a8, **kw8),
             lambda: cs.cns_surface_plain(*a8, **kw8)),
            ("K7 cns_viscous", lambda: sv.cns_viscous(*a7, **kw7),
             lambda: sv.cns_viscous_plain(*a7, **kw7))])
        ne = disc.num_elements
        o8, o7 = cs.cns_surface(*a8, **kw8), sv.cns_viscous(*a7, **kw7)
        proj = disc.dim == 2
        split_rows[label] = dict(
            launches=counts, times=stimes,
            k8_bound=bound(nbytes(*a8, *o8),
                           ops_face(disc.dim, False) * disc.nfq * ne,
                           a8[0].dtype),
            k7_bound=bound(nbytes(*a7, *(o7 if proj else o7[:3])),
                           ops_visc(disc.dim, disc.nq, disc.nfq, *a7[6:10])
                           * ne,
                           a7[0].dtype))
        del split, merged, sqf, o8, o7


    # ---- 13. curved Euler kernels against their plain versions ----
    stamp("13")
    vdisc, vq0 = euler_hex_3d(n=N, k1d=K1D, curved=True,
                              dtype=torch.float32, device=dev)
    if vdisc.geo.shape[1] != vdisc.nh or fv.detect_axis_aligned(vdisc):
        raise AssertionError("the curved mesh must carry a per-point metric")
    vq = random_state(vdisc, 5)
    cv_abs_v, cv_abs_s, cvargs, cvkw, csargs, cskw, ckouts = check_kernels(
        vdisc, vq, False, f"curved N=3 k1d={K1D} f32 (curved path)",
        curved_geom(vdisc))
    for k1d, dt in ((8, torch.float64), (3, torch.float32),
                    (3, torch.float64)):
        d_, _ = euler_hex_3d(n=N, k1d=k1d, curved=True, dtype=dt, device=dev)
        check_kernels(d_, random_state(d_, 5), False,
                      f"curved N=3 k1d={k1d} {str(dt)[6:]}"
                      + (" (K=27, ragged tile)" if k1d == 3 else ""),
                      curved_geom(d_))
    del d_

    # ---- 14. the curved Euler path ----
    stamp("14")
    vrhs = make_euler_rhs_fused(vdisc, dissipation=True)
    zero_counts()
    vqf, _ = lsrk45(vrhs, vq0, DT, STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    curved_launches = {k: counts[k] for k in ("euler_volume",
                                              "euler_surface",
                                              "lsrk45_update")}
    print(f"curved path: {STEPS} LSRK45 steps ({5 * STEPS} stages), "
          f"launches {curved_launches}")
    if any(v != 5 * STEPS for v in curved_launches.values()):
        raise AssertionError(f"expected {5 * STEPS} launches of K1, K2 and "
                             "the update")
    no_plain_work("curved path")
    if vqf.dtype != torch.float32 or not bool(torch.isfinite(vqf).all()):
        raise AssertionError("curved-path state not finite f32")
    vtwin = make_euler_rhs(vdisc, dissipation=True, flux_diff_impl="lines",
                           compute_rhstest=False)
    vqt, _ = lsrk45(vtwin, vq0, DT, STEPS)
    e_vtwin, _ = rel_err(vqf, vqt)
    print(f"curved fused vs plain twin after {STEPS} steps: rel "
          f"{e_vtwin:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_vtwin <= TWIN_TOL_F32:
        raise AssertionError("curved path disagrees with the plain twin")
    check_conservation(vdisc, vq0, vqf, "curved path ")

    def constant_state(disc):
        sh = (disc.np_, disc.num_elements)
        full = lambda v: torch.full(sh, v, dtype=disc.wq.dtype, device=dev)
        return primitive_to_conservative(
            full(1.3), torch.stack([full(0.2), full(-0.1), full(0.4)]),
            full(0.9))

    fs32 = float(vrhs(constant_state(vdisc))[0].abs().max())
    d8, _ = euler_hex_3d(n=N, k1d=8, curved=True, dtype=torch.float64,
                         device=dev)
    fs64 = float(make_euler_rhs_fused(d8, dissipation=True)(
        constant_state(d8))[0].abs().max())
    print(f"free stream on the warped mesh, max |dq| of a constant state: "
          f"f64 k1d=8 {fs64:.3e} (tol {FREESTREAM_TOL_F64:.0e}); f32 "
          f"k1d={K1D} {fs32:.3e} (printed)")
    if not fs64 <= FREESTREAM_TOL_F64:
        raise AssertionError("free stream not preserved on the curved mesh")
    d4, _ = euler_hex_3d(n=N, k1d=4, curved=True, dtype=torch.float64,
                         device=dev)
    zero_counts()
    _, aux = make_euler_rhs_fused(d4, dissipation=False,
                                  compute_rhstest=True)(random_state(d4, 7))
    rt = float(aux["rhstest"])
    print(f"f64 curved k1d=4 kernel path (launches {read_counts()}), "
          f"dissipation off: rhstest {rt:.3e} (tol {RHSTEST_TOL_F64:.0e})")
    if not abs(rt) <= RHSTEST_TOL_F64:
        raise AssertionError("entropy conservation violated (curved)")
    del d8, d4

    # the twin with the line kernel (row 10): flux_diff_impl='lines_pallas'
    ltwin = make_euler_rhs(vdisc, dissipation=True,
                           flux_diff_impl="lines_pallas",
                           compute_rhstest=False)
    zero_counts()
    vql, _ = lsrk45(ltwin, vq0, DT, STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    lines_launches = counts["flux_differencing_lines_fused"]
    e_lines, _ = rel_err(vql, vqt)
    print(f"curved twin flux_diff_impl='lines_pallas': {STEPS} steps, "
          f"launches {counts}; vs 'lines' rel {e_lines:.3e} (tol "
          f"{TWIN_TOL_F32:.0e})")
    if lines_launches != 5 * STEPS or counts["lsrk45_update"] != 5 * STEPS:
        raise AssertionError(f"expected {5 * STEPS} launches of row 10 and "
                             "the update")
    if not e_lines <= TWIN_TOL_F32:
        raise AssertionError("the 'lines_pallas' twin disagrees")
    vdof = 5 * vdisc.np_ * vdisc.num_elements
    for label, r in (("'lines_pallas' (row 10)", ltwin), ("'lines'", vtwin)):
        ms = cuda_ms(lambda: lsrk45(r, vq0, DT, TWIN_TIMED_STEPS), 1)
        print(f"[{card}] curved twin {label}: "
              f"{vdof * 5 * TWIN_TIMED_STEPS / (ms / 1e3):.4e} "
              f"DOF*RK-stage/s, {ms / (5 * TWIN_TIMED_STEPS):.4f} ms/stage "
              f"over {5 * TWIN_TIMED_STEPS} stages, median of {REPEATS}")
    del vqt, vql, vtwin, ltwin

    # ---- 15. curved Euler timing ----
    stamp("15")
    vstep_ms = cuda_ms(lambda: lsrk45(vrhs, vq0, DT, TIMED_STEPS), 1)
    vstage_ms = vstep_ms / (5 * TIMED_STEPS)
    print(f"[{card}] curved path (K1c+K2, LSRK45): "
          f"{vdof * 5 * TIMED_STEPS / (vstep_ms / 1e3):.4e} DOF*RK-stage/s, "
          f"{vstage_ms:.4f} ms/stage over {5 * TIMED_STEPS} stages, median "
          f"of {REPEATS}")
    k1c_ms = dev_ms(lambda: fv.euler_volume(*cvargs, **cvkw), 20)
    k1c_plain_ms = dev_ms(lambda: fv.euler_volume_plain(*cvargs, **cvkw), 2)
    k2c_ms = dev_ms(lambda: fv.euler_surface(*csargs, **cskw), 20)
    k2c_plain_ms = dev_ms(lambda: fv.euler_surface_plain(*csargs, **cskw),
                          2)
    vgather_ms = dev_ms(lambda: vdisc.gather_traces(csargs[0]), 20)
    for name, ms, pms in (("K1c euler_volume (curved)", k1c_ms,
                           k1c_plain_ms),
                          ("K2 euler_surface (curved normals, grid)", k2c_ms,
                           k2c_plain_ms)):
        print(f"[{card}] {name} N=3 k1d={K1D} f32: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms ({pms / ms:.1f}x), device times")
    print(f"[{card}] curved stage: K1c {k1c_ms:.4f} + K2 {k2c_ms:.4f} = "
          f"{k1c_ms + k2c_ms:.4f} ms of {vstage_ms:.4f} ms; not in the "
          f"stage: the roll exchange {vgather_ms:.4f} ms")
    print_profile(card, "curved Euler path", device_profile(
        lambda: lsrk45(vrhs, vq0, DT, 4), 20))
    vne = vdisc.num_elements
    k1c_bound = bound(nbytes(cvargs[0], cvargs[2], cvargs[3], *ckouts[:2])
                      + line_metric_bytes(N + 1, vne, 4),
                      ops_k1(N + 1, entries(cvargs[2]), entries(cvargs[3]),
                             "curved") * vne,
                      cvargs[0].dtype)
    k2c_bound = bound(nbytes(*csargs[:8], ckouts[2]),
                      ops_k2(N + 1, entries(csargs[6]), diag=False) * vne,
                      csargs[0].dtype)
    del vrhs, ckouts, csargs

    # ---- 16. the flux-differencing kernels against their plain versions --
    stamp("16")
    def fd_case(kind, disc, q, tag):
        """Row 10 ('lines'), K5 ('dense') or K3c ('modal') on (disc, q)
        against the plain version; returns (max abs error, the call, the
        plain call, inputs, output)."""
        tol = TOL[dtype_name(q)]
        if kind == "modal":
            args = (q, disc.geo, torch.stack(disc.q_skew), disc.vq,
                    disc.vhp, disc.ph, gamma)
            lists = mv.modal_lists(*args[2:6], disc.nq)
            call = lambda: mv.euler_modal_volume(*args, nq=disc.nq,
                                                 lists=lists)
            plain = lambda: mv.euler_modal_volume_plain(*args, nq=disc.nq)
            name, names = "K3c euler_modal_volume", ("ph_qf", "traces",
                                                     "vu_q")
        else:
            qh, qlog = fd_inputs(disc, q)
            if kind == "lines":
                args = (qh, qlog, disc.geo, gamma)
                kw = dict(elem_type="hex", line_ops=disc.line_ops,
                          nq=disc.nq)
                call = lambda: (tp.flux_differencing_lines_fused(*args,
                                                                 **kw),)
                plain = lambda: (tp.flux_differencing_lines(*args, **kw),)
                name = "row 10 flux_differencing_lines_fused"
            else:
                args = (qh, qlog, torch.stack(disc.q_skew), disc.geo, gamma)
                call = lambda: (df.flux_differencing_dense(*args,
                                                           nq=disc.nq),)
                plain = lambda: (df.flux_differencing_dense_plain(
                    *args, nq=disc.nq),)
                name = "K5 flux_differencing_dense"
            names = ("2QF",)
        out = call()
        err = held(name, tag, out, plain(), tol, names)
        return err, call, plain, args, out

    fd_rows = {}
    # row 10 at the curved path's full width, then the uniform mesh
    fd_rows["lines"] = fd_case("lines", vdisc, vq, f"curved N=3 k1d={K1D} "
                               "f32 (the 'lines_pallas' twin's shapes)")
    fd_case("lines", udisc, random_state(udisc, 6),
            f"uniform N=3 k1d={K1D} f32")
    for curved, k1d in ((True, 8), (False, 8), (True, 3), (False, 3)):
        d_, _ = euler_hex_3d(n=N, k1d=k1d, curved=curved,
                             dtype=torch.float64, device=dev)
        fd_case("lines", d_, random_state(d_, 6),
                f"{'curved' if curved else 'uniform'} N=3 k1d={k1d} f64"
                + (" (K=27, ragged)" if k1d == 3 else ""))
    del udisc
    # K5 at the cavity twin's shapes, on the curved tri and hex meshes
    fd_rows["dense"] = fd_case("dense", cdisc, cq, f"tri N=3 k1d={CAV_K1D} "
                               "f32 affine (the 'pallas' cavity twin's "
                               "shapes)")
    wdisc, wq = warped_tri_case(CAV_N, CAV_K1D, torch.float32, dev)
    if wdisc.geo.shape[1] != wdisc.nh:
        raise AssertionError("the warped tri mesh must be curved")
    fd_case("dense", wdisc, wq, f"curved tri N=3 k1d={CAV_K1D} f32")
    for dt in (torch.float32, torch.float64):
        d_, _ = euler_hex_3d(n=N, k1d=4, curved=True, dtype=dt, device=dev)
        fd_case("dense", d_, random_state(d_, 8),
                f"curved hex N=3 k1d=4 {str(dt)[6:]} (Nh=160, operators "
                "from global memory)")
    d_, q_, _, _ = cavity_case("isothermal", CAV_N, 8, torch.float64, dev)
    fd_case("dense", d_, q_, "tri N=3 k1d=8 f64 affine")
    for k1d in (8, 5):
        d_, q_ = warped_tri_case(CAV_N, k1d, torch.float64, dev)
        fd_case("dense", d_, q_, f"curved tri N=3 k1d={k1d} f64"
                + (" (K=50, ragged)" if k1d == 5 else ""))
    d_, _ = euler_hex_3d(n=N, k1d=3, curved=True, dtype=torch.float64,
                         device=dev)
    fd_case("dense", d_, random_state(d_, 8), "curved hex N=3 k1d=3 f64 "
            "(K=27, ragged)")
    # K3c on the curved tri mesh
    fd_rows["modal"] = fd_case("modal", wdisc, wq,
                               f"curved tri N=3 k1d={CAV_K1D} f32")
    for k1d in (8, 5):
        d_, q_ = warped_tri_case(CAV_N, k1d, torch.float64, dev)
        fd_case("modal", d_, q_, f"curved tri N=3 k1d={k1d} f64"
                + (" (K=50, ragged)" if k1d == 5 else ""))
    del d_, q_
    fd_times = kernel_times("at the shapes above (full width, f32)", [
        (f"{label}", fd_rows[kind][1], fd_rows[kind][2])
        for kind, label in (("lines", "row 10 flux_differencing_lines_fused"
                                      f" (curved N=3 k1d={K1D})"),
                            ("dense", "K5 flux_differencing_dense (tri N=3 "
                                      f"k1d={CAV_K1D})"),
                            ("modal", "K3c euler_modal_volume (curved tri "
                                      f"N=3 k1d={CAV_K1D})"))])
    r10_ms, r10_plain_ms = fd_times[next(k for k in fd_times
                                         if k.startswith("row 10"))]
    k5_ms, k5_plain_ms = fd_times[next(k for k in fd_times
                                       if k.startswith("K5"))]
    k3c_ms, k3c_plain_ms = fd_times[next(k for k in fd_times
                                         if k.startswith("K3c"))]
    _, _, _, largs, lout = fd_rows["lines"]
    r10_bound = bound(nbytes(*largs[:2], *lout)
                      + line_metric_bytes(N + 1, vne, 4),
                      ops_lines(N + 1, True) * vne,
                      largs[0].dtype)
    _, _, _, dargs, dout = fd_rows["dense"]
    k5_bound = bound(nbytes(*dargs[:4], *dout),
                     ops_dense_2d(cdisc.nq, cdisc.nh, False) * cne,
                     dargs[0].dtype)
    _, _, _, margs, mout = fd_rows["modal"]
    k3c_bound = bound(nbytes(*margs[:6], *mout),
                      ops_k3(2, wdisc.vq, wdisc.vhp, wdisc.ph, margs[2],
                             wdisc.nq, curved=True) * wdisc.num_elements,
                      margs[0].dtype)
    del vdisc, vq0, vq, vqf, wdisc, wq

    # ---- 17. the cavity twin with the dense kernel (K5) ----
    stamp("17")
    ptwin = make_cns_rhs(cdisc, flux_diff_impl="pallas", **flags)
    zero_counts()
    cqp, _ = lsrk45(ptwin, cq0, CAV_DT, CAV_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    dense_launches = counts["flux_differencing_dense"]
    e_dense, _ = rel_err(cqp, cqt)
    print(f"cavity twin flux_diff_impl='pallas': {CAV_STEPS} steps at "
          f"dt={CAV_DT:g}, launches {counts}; vs 'xla' rel {e_dense:.3e} "
          f"(tol {TWIN_TOL_F32:.0e})")
    if dense_launches != 5 * CAV_STEPS or (counts["lsrk45_update"]
                                            != 5 * CAV_STEPS):
        raise AssertionError(f"expected {5 * CAV_STEPS} launches of K5 and "
                             "the update")
    if not e_dense <= TWIN_TOL_F32:
        raise AssertionError("the 'pallas' cavity twin disagrees")
    ms = cuda_ms(lambda: lsrk45(ptwin, cq0, CAV_TIMED_DT, TWIN_TIMED_STEPS),
                 1)
    print(f"[{card}] cavity twin 'pallas' (K5): "
          f"{cdof * 5 * TWIN_TIMED_STEPS / (ms / 1e3):.4e} DOF*RK-stage/s, "
          f"{ms / (5 * TWIN_TIMED_STEPS):.4f} ms/stage over "
          f"{5 * TWIN_TIMED_STEPS} stages, median of {REPEATS}")
    del ptwin, cqp, cqt

    # ---- 18. split volume kernels against their plain versions ----
    stamp("18")
    def split_case(disc, q, tag, random_geo=None):
        """The projection, the fd of each direction (diag on the mesh's
        metric; general on random_geo), the dense fd, the split stage and
        K2 against their plain versions; returns ({kernel: max abs error},
        {kernel: (call, plain call)}, inputs and outputs for the bounds)."""
        tol = TOL[dtype_name(q)]
        lo, ef = disc.line_ops, disc.vhp[disc.nq:]
        errs, calls = {}, {}
        errs["proj"] = held("hex_project", tag, fv.hex_project(q, ef, gamma),
                            fv.hex_project_plain(q, ef, gamma), tol,
                            ("qh", "qlog", "traces"))
        calls["proj"] = (lambda: fv.hex_project(q, ef, gamma),
                         lambda: fv.hex_project_plain(q, ef, gamma))
        qh, qlog, _ = fv.hex_project_plain(q, ef, gamma)
        forms = [("diag", disc.geo, True)]
        if random_geo is not None:
            forms.append(("general, random metric", random_geo, False))
        errs["fd"] = errs["dense"] = 0.0
        for d in range(3):
            for label, geo, diag in forms:
                kw = dict(line_ops=lo, d=d, diag=diag)
                errs["fd"] = max(errs["fd"], held(
                    "hex_fd_dir", f"{tag} d={d} {label}",
                    (fv.hex_fd_dir(qh, qlog, geo, gamma, **kw),),
                    (fv.hex_fd_dir_plain(qh, qlog, geo, gamma, **kw),), tol,
                    ("out",)))
                calls[f"fd{d}"] = (
                    lambda kw=kw: fv.hex_fd_dir(qh, qlog, disc.geo, gamma,
                                                **dict(kw, diag=True)),
                    lambda kw=kw: fv.hex_fd_dir_plain(qh, qlog, disc.geo,
                                                      gamma,
                                                      **dict(kw, diag=True)))
            for label, geo, _ in forms:
                kw = dict(line_ops=lo, d=d)
                errs["dense"] = max(errs["dense"], held(
                    "hex_fd_dir_dense", f"{tag} d={d} {label.split(',')[-1]}",
                    (fv.hex_fd_dir_dense(qh, qlog, geo, gamma, **kw),),
                    (fv.hex_fd_dir_dense_plain(qh, qlog, geo, gamma, **kw),),
                    tol, ("out",)))
                calls[f"dense{d}"] = (
                    lambda kw=kw: fv.hex_fd_dir_dense(qh, qlog, disc.geo,
                                                      gamma, **kw),
                    lambda kw=kw: fv.hex_fd_dir_dense_plain(
                        qh, qlog, disc.geo, gamma, **kw))
        vkw = dict(line_ops=lo, diag=True)
        vargs = (q, disc.geo, ef, disc.lift, gamma)
        held("euler_volume_split", tag, fv.euler_volume_split(*vargs, **vkw),
             fv.euler_volume_split_plain(*vargs, **vkw), tol,
             ("ph_qf", "traces"))
        ph_qf, tr = fv.euler_volume_split_plain(*vargs, **vkw)
        parts = [fv.hex_fd_dir(qh, qlog, disc.geo, gamma, line_ops=lo, d=d,
                               diag=True) for d in range(3)]
        nbr = disc.gather_traces(tr)
        # K2 in each form: ph_qf or the three parts, the neighbours given
        # or read on the grid; the split forms also general (the mesh's
        # normals and 1/J at every node)
        diag_geom = ((disc.nxj[0] + disc.nxj[1] + disc.nxj[2])[None],
                     disc.sj, disc.inv_sj, disc.inv_jac[:1])
        gen_geom = (torch.stack(disc.nxj), disc.sj, disc.inv_sj,
                    disc.inv_jac)
        k2 = {}
        for form, geom, diag, grid, split in (
                ("ph_qf, gathered", diag_geom, True, False, False),
                ("ph_qf, grid", diag_geom, True, True, False),
                ("split, gathered", diag_geom, True, False, True),
                ("split, grid (the N=7 path)", diag_geom, True, True, True),
                ("split, grid, general", gen_geom, False, True, True)):
            args = (tr, None if grid else nbr, *geom, disc.lift,
                    None if split else ph_qf, gamma)
            kw = dict(dissipation=True, diag=diag,
                      grid=disc.grid_shape if grid else None,
                      parts=parts if split else None, line_ops=lo)
            k2[form] = (args, kw)
            errs["k2"] = max(errs.get("k2", 0.0), held(
                f"K2 euler_surface (N+1={lo.n1d}, {form})", tag,
                (fv.euler_surface(*args, **kw),),
                (fv.euler_surface_plain(*args, **kw),), tol, ("dq",)))
        sargs, skw = k2["split, grid (the N=7 path)"]
        calls["k2"] = (lambda: fv.euler_surface(*sargs, **skw),
                       lambda: fv.euler_surface_plain(*sargs, **skw))
        oargs, okw = k2["ph_qf, gathered"]
        calls["k2_ph_qf"] = (lambda: fv.euler_surface(*oargs, **okw), None)
        calls["combine"] = (lambda: fv.split_combine(parts, disc.lift, lo),
                            None)
        calls["exchange"] = (lambda: disc.gather_traces(tr), None)
        io = dict(q=q, ef=ef, qh=qh, qlog=qlog, tr=tr, out=parts[0],
                  parts=parts, sargs=sargs,
                  dq=fv.euler_surface_plain(*sargs, **skw))
        return errs, calls, io

    d7, q7_0 = euler_hex_3d(n=N7, k1d=N7_K1D, dtype=torch.float32,
                            device=dev)
    if not fv.detect_axis_aligned(d7):
        raise AssertionError("the N=7 k1d=16 mesh must be detected "
                             "axis-aligned")
    q7 = random_state(d7, 9)
    n7_errs, n7_calls, n7_io = split_case(
        d7, q7, f"N=7 k1d={N7_K1D} f32 (the N=7 path)",
        random_affine(d7)[0])
    d4, _ = euler_hex_3d(n=N4, k1d=N4_K1D, dtype=torch.float32, device=dev)
    q4m = random_state(d4, 10)
    n4_errs, n4_calls, n4_io = split_case(
        d4, q4m, f"N=4 k1d={N4_K1D} f32 (the N=4 bench mesh)",
        random_affine(d4)[0])
    d3s, _ = euler_hex_3d(n=N, k1d=K1D, dtype=torch.float32, device=dev)
    split_case(d3s, random_state(d3s, 8), f"N=3 k1d={K1D} f32 (the main "
               "path's mesh)")
    del d3s
    for n_, k1d in ((N4, 4), (N7, 3)):
        d_, _ = euler_hex_3d(n=n_, k1d=k1d, dtype=torch.float64, device=dev)
        split_case(d_, random_state(d_, 11), f"N={n_} k1d={k1d} f64"
                   + (" (K=27, ragged)" if k1d == 3 else ""),
                   random_affine(d_)[0])
    # the split fd at every N+1 = 2..8, f32 and f64, on ragged K = 27, on
    # a moving state and at rest (uniform density and pressure, so every
    # pair is of equal states): diag and general on the mesh's metric,
    # general and dense on a random one
    for n_ in range(1, 8):
        for dt_ in (torch.float32, torch.float64):
            d_, _ = euler_hex_3d(n=n_, k1d=3, dtype=dt_, device=dev)
            prec = str(dt_).replace("torch.", "")
            rgeo = random_affine(d_)[0]
            full = lambda v, *sh: torch.full((*sh, d_.np_, d_.num_elements),
                                             v, dtype=dt_, device=dev)
            rest = primitive_to_conservative(full(1.2), full(0.0, 3),
                                             full(1.5))
            for state, q_ in (("moving", random_state(d_, 30 + n_)),
                              ("at rest", rest)):
                qh, qlog, _ = fv.hex_project_plain(q_, d_.vhp[d_.nq:],
                                                   gamma)
                errs = {}
                for d in range(3):
                    kw = dict(line_ops=d_.line_ops, d=d)
                    for form, geo, diag in (
                            ("diag", d_.geo, True),
                            ("general", d_.geo, False),
                            ("general, random metric", rgeo, False),
                            ("dense", d_.geo, None),
                            ("dense, random metric", rgeo, None)):
                        if diag is None:
                            got = fv.hex_fd_dir_dense(qh, qlog, geo, gamma,
                                                      **kw)
                            want = fv.hex_fd_dir_dense_plain(
                                qh, qlog, geo, gamma, **kw)
                        else:
                            got = fv.hex_fd_dir(qh, qlog, geo, gamma,
                                                diag=diag, **kw)
                            want = fv.hex_fd_dir_plain(qh, qlog, geo, gamma,
                                                       diag=diag, **kw)
                        errs[form] = max(errs.get(form, 0.0),
                                         rel_err(got, want)[0])
                print(f"split fd N+1={n_ + 1} K=27 {prec} {state}, the "
                      "three directions: rel " + ", ".join(
                          f"{k} {v:.3e}" for k, v in errs.items())
                      + f" (tol {TOL[prec]:.0e})")
                if not all(v <= TOL[prec] for v in errs.values()):
                    raise AssertionError(f"the split fd disagrees with its "
                                         f"plain version (N+1={n_ + 1}, "
                                         f"{prec}, {state})")
    del d_

    # ---- 19. the N=7 path ----
    stamp("19")
    from esdg_cns_tpu_torch.solvers.euler_fused import resolve_volume_mode

    if resolve_volume_mode(d7) != "split":
        raise AssertionError("'auto' must resolve to the split path at N=7")
    rhs7 = make_euler_rhs_fused(d7, dissipation=True, force_fused=True)
    zero_counts()
    q7f, _ = lsrk45(rhs7, q7_0, N7_DT, STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    n7_launches = {k: counts[k] for k in ("hex_project", "hex_fd_dir",
                                          "euler_surface", "euler_volume",
                                          "hex_fd_dir_dense",
                                          "lsrk45_update")}
    print(f"N=7 path: {STEPS} LSRK45 steps ({5 * STEPS} stages) at "
          f"dt={N7_DT:g}, launches {n7_launches}")
    want = {"hex_project": 5 * STEPS, "hex_fd_dir": 15 * STEPS,
            "euler_surface": 5 * STEPS, "euler_volume": 0,
            "hex_fd_dir_dense": 0, "lsrk45_update": 5 * STEPS}
    if n7_launches != want:
        raise AssertionError(f"expected launches {want} on the N=7 path")
    no_plain_work("N=7 path")
    if q7f.dtype != torch.float32 or not bool(torch.isfinite(q7f).all()):
        raise AssertionError("N=7 state not finite f32")
    twin7 = make_euler_rhs(d7, dissipation=True, flux_diff_impl="lines",
                           compute_rhstest=False)
    q7t, _ = lsrk45(twin7, q7_0, N7_DT, STEPS)
    e_twin7, _ = rel_err(q7f, q7t)
    print(f"N=7 split path vs plain twin after {STEPS} steps: rel "
          f"{e_twin7:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_twin7 <= TWIN_TOL_F32:
        raise AssertionError("N=7 path disagrees with the plain twin")
    check_conservation(d7, q7_0, q7f, "N=7 path ")
    del q7t
    d3_, _ = euler_hex_3d(n=N7, k1d=3, dtype=torch.float64, device=dev)
    zero_counts()
    _, aux = make_euler_rhs_fused(d3_, dissipation=False, force_fused=True,
                                  compute_rhstest=True)(random_state(d3_, 12))
    rt = float(aux["rhstest"])
    print(f"f64 N=7 k1d=3 kernel path (launches {read_counts()}), "
          f"dissipation off: rhstest {rt:.3e} (tol {RHSTEST_TOL_F64:.0e})")
    if not abs(rt) <= RHSTEST_TOL_F64:
        raise AssertionError("entropy conservation violated (N=7)")
    del d3_

    # ---- 20. the N=4 volume modes ----
    stamp("20")
    mode_rhs = {m: make_euler_rhs_fused(d4, dissipation=True, volume_mode=m)
                for m in N4_MODES}
    ref4 = mode_rhs["auto"](q4m)[0]
    d4s, _ = euler_hex_3d(n=N4, k1d=4, dtype=torch.float64, device=dev)
    q4s = random_state(d4s, 13)
    ref4s = make_euler_rhs_fused(d4s)(q4s)[0]
    mode_launches = {}
    for m in N4_MODES[1:]:
        e32, _ = rel_err(mode_rhs[m](q4m)[0], ref4)
        e64, _ = rel_err(make_euler_rhs_fused(d4s, volume_mode=m)(q4s)[0],
                         ref4s)
        print(f"N=4 volume_mode={m!r} vs 'auto' (K1), one RHS on a moving "
              f"state: f32 k1d={N4_K1D} rel {e32:.3e} (tol "
              f"{TOL['float32']:.0e}), f64 k1d=4 rel {e64:.3e} (tol "
              f"{TOL['float64']:.0e})")
        if not (e32 <= TOL["float32"] and e64 <= TOL["float64"]):
            raise AssertionError(f"volume_mode={m!r} disagrees with K1")
    del d4s, q4s, ref4s, ref4
    q4_0 = euler_hex_3d(n=N4, k1d=N4_K1D, dtype=torch.float32,
                        device=dev)[1]
    for m in N4_MODES:
        zero_counts()
        q4f, _ = lsrk45(mode_rhs[m], q4_0, DT, STEPS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        mode_launches[m] = counts
        print(f"N=4 volume_mode={m!r}: {STEPS} steps, launches {counts}")
        dense = m == "split_dense"
        want = ({"euler_volume": 5 * STEPS, "euler_surface": 5 * STEPS}
                if m == "auto" else
                {"hex_project": 5 * STEPS, "euler_surface": 5 * STEPS,
                 ("hex_fd_dir_dense" if dense else "hex_fd_dir"): 15 * STEPS})
        want["lsrk45_update"] = 5 * STEPS
        if counts != want:
            raise AssertionError(f"expected launches {want} for {m!r}")
        no_plain_work(f"N=4 volume_mode={m!r}")
        if not bool(torch.isfinite(q4f).all()):
            raise AssertionError(f"N=4 {m!r} state not finite")
    del q4f

    # ---- 21. split timing ----
    stamp("21")
    dof7 = 5 * d7.np_ * d7.num_elements
    step7_ms = cuda_ms(lambda: lsrk45(rhs7, q7_0, N7_DT, TIMED_STEPS), 1)
    stage7_ms = step7_ms / (5 * TIMED_STEPS)
    print(f"[{card}] N=7 path (split: projection+3 fd+K2, "
          f"LSRK45): {dof7 * 5 * TIMED_STEPS / (step7_ms / 1e3):.4e} "
          f"DOF*RK-stage/s, {stage7_ms:.4f} ms/stage over "
          f"{5 * TIMED_STEPS} stages, median of {REPEATS}")
    twin7_ms = cuda_ms(lambda: lsrk45(twin7, q7_0, N7_DT, TWIN_TIMED_STEPS),
                       1)
    print(f"[{card}] N=7 plain twin 'lines': "
          f"{dof7 * 5 * TWIN_TIMED_STEPS / (twin7_ms / 1e3):.4e} "
          f"DOF*RK-stage/s, {twin7_ms / (5 * TWIN_TIMED_STEPS):.4f} ms/stage")
    del twin7
    n7_times = {}
    for key, label in (("proj", "hex_project"), ("fd0", "hex_fd_dir d=0"),
                       ("fd1", "hex_fd_dir d=1"), ("fd2", "hex_fd_dir d=2"),
                       ("dense0", "hex_fd_dir_dense d=0"),
                       ("dense1", "hex_fd_dir_dense d=1"),
                       ("dense2", "hex_fd_dir_dense d=2"),
                       ("k2", "K2 euler_surface N+1=8 (split, grid)"),
                       ("combine", "not in the stage: the plain combine "
                        "(sums, 1/w, LIFT matmul)"),
                       ("exchange", "not in the stage: the roll exchange"),
                       ("k2_ph_qf", "not in the stage: K2 on ph_qf and "
                        "gathered traces")):
        call, plain = n7_calls[key]
        ms = dev_ms(call, 20)
        pms = dev_ms(plain, 2) if plain is not None else None
        n7_times[key] = (ms, pms)
        print(f"[{card}] {label} N=7 k1d={N7_K1D} f32: kernel {ms:.4f} ms"
              + (f", plain {pms:.4f} ms ({pms / ms:.1f}x)" if pms else "")
              + ", device time")
    fd_ms = sum(n7_times[f"fd{d}"][0] for d in range(3))
    split7 = n7_times["proj"][0] + fd_ms + n7_times["k2"][0]
    old7 = [n7_times[key][0] for key in ("k2_ph_qf", "combine", "exchange")]
    print(f"[{card}] N=7 stage: projection {n7_times['proj'][0]:.4f} + fd "
          f"{fd_ms:.4f} + K2 {n7_times['k2'][0]:.4f} = {split7:.4f} ms of "
          f"{stage7_ms:.4f} ms; the parts K2 replaced, K2 on ph_qf + combine "
          f"+ exchange: {' + '.join(f'{ms:.4f}' for ms in old7)} = "
          f"{sum(old7):.4f} ms")
    stage7_dev_ms = dev_ms(lambda: lsrk45(rhs7, q7_0, N7_DT, 10), 1) / 50
    print(f"[{card}] N=7 stage device time (queued ahead of the device): "
          f"{stage7_dev_ms:.4f} ms of {stage7_ms:.4f} ms")
    print_profile(card, "N=7 path", device_profile(
        lambda: lsrk45(rhs7, q7_0, N7_DT, 4), 20))
    dof4 = 5 * d4.np_ * d4.num_elements
    ef4 = d4.vhp[d4.nq:]
    # the volume stage each mode's RHS runs: K1, or the split front up to
    # the parts (K2 sums them)
    vol4 = {m: (lambda m=m: fv.euler_volume_split_parts(
        q4m, d4.geo, ef4, gamma, line_ops=d4.line_ops,
        **({"dense": True} if m == "split_dense" else {"diag": True}),
        **({"pad_x": True} if m == "split_pad8" else {}))
        if m.startswith("split") else fv.euler_volume(
            q4m, d4.geo, ef4, d4.lift, gamma, line_ops=d4.line_ops,
            diag=True))
        for m in N4_MODES}
    for m in N4_MODES:
        ms = cuda_ms(lambda: lsrk45(mode_rhs[m], q4_0, DT, N4_TIMED_STEPS),
                     1)
        vms = dev_ms(vol4[m], 20)
        sdev = dev_ms(lambda: lsrk45(mode_rhs[m], q4_0, DT, 10), 1) / 50
        print(f"[{card}] N=4 k1d={N4_K1D} volume_mode={m!r}: "
              f"{dof4 * 5 * N4_TIMED_STEPS / (ms / 1e3):.4e} DOF*RK-stage/s, "
              f"{ms / (5 * N4_TIMED_STEPS):.4f} ms/stage over "
              f"{5 * N4_TIMED_STEPS} stages, median of {REPEATS}; stage "
              f"queued ahead of the device {sdev:.4f} ms; volume stage "
              f"{vms:.4f} ms (device time)")
    # row 4b at the shape of the run that counts its launches (the N=4
    # 'split_dense' path), each direction beside its plain version
    n4_times = {}
    for key, label in (("proj", "hex_project"), ("fd0", "hex_fd_dir d=0"),
                       ("dense0", "hex_fd_dir_dense d=0"),
                       ("dense1", "hex_fd_dir_dense d=1"),
                       ("dense2", "hex_fd_dir_dense d=2"),
                       ("k2", "K2 euler_surface N+1=5 (split, grid)")):
        call, plain = n4_calls[key]
        ms = dev_ms(call, 20)
        pms = dev_ms(plain, 2) if key.startswith("dense") else None
        n4_times[key] = (ms, pms)
        print(f"[{card}] {label} N=4 k1d={N4_K1D} f32: kernel {ms:.4f} ms"
              + (f", plain {pms:.4f} ms ({pms / ms:.1f}x)" if pms else "")
              + ", device time")
    ne7 = d7.num_elements
    nq7, nfp7 = d7.nq, d7.nfq // 6
    itemsize = 4
    proj_bound = bound(nbytes(n7_io["q"], n7_io["ef"], n7_io["qh"],
                              n7_io["qlog"], n7_io["tr"]),
                       ops_project(N7 + 1, entries(n7_io["ef"])) * ne7,
                       n7_io["q"].dtype)
    # one direction reads its volume points and its two faces' points of
    # qh and qlog (7 rows), one metric row (diag; three for the dense
    # form's contraction) and writes [5, Nq + 2 Nfp, K]
    fd_in = 7 * (nq7 + 2 * nfp7) * ne7 * itemsize
    fd_bound = bound(fd_in + ne7 * itemsize + nbytes(n7_io["out"]),
                     PAIR_3D["diag"] * (line_pairs(N7 + 1) // 3 * ne7),
                     n7_io["out"].dtype)
    # row 4b at N=4 k1d=24: the general form's reads (three metric rows)
    # and pairs, each once
    ne4, nq4, nfp4 = d4.num_elements, d4.nq, d4.nfq // 6
    dense_bound = bound(7 * (nq4 + 2 * nfp4) * ne4 * itemsize
                        + 3 * ne4 * itemsize + nbytes(n4_io["out"]),
                        PAIR_3D["general"] * (line_pairs(N4 + 1) // 3 * ne4),
                        n4_io["out"].dtype)
    # K2's split form on the grid: traces (its neighbours' are the same
    # array), compact nxj, 1/J, LIFT, 1/wq, 1/wf and the three parts -> dq
    sa = n7_io["sargs"]
    k2n8_bound = bound(nbytes(sa[0], sa[2], sa[5], sa[6], *n7_io["parts"],
                              n7_io["dq"])
                       + (nq7 + nfp7) * itemsize,
                       ops_k2(N7 + 1, entries(sa[6]), split_form=True)
                       * ne7,
                       n7_io["dq"].dtype)
    fd_avg = fd_ms / 3
    fd_plain_avg = sum(n7_times[f"fd{d}"][1] for d in range(3)) / 3
    dense_avg = sum(n4_times[f"dense{d}"][0] for d in range(3)) / 3
    dense_plain_avg = sum(n4_times[f"dense{d}"][1] for d in range(3)) / 3
    dense7_avg = sum(n7_times[f"dense{d}"][0] for d in range(3)) / 3
    print(f"[{card}] hex_fd_dir_dense, mean of the directions: N=4 "
          f"k1d={N4_K1D} {dense_avg:.4f} ms (plain {dense_plain_avg:.4f}), "
          f"N=7 k1d={N7_K1D} {dense7_avg:.4f} ms; hex_fd_dir diag N=7 "
          f"{fd_avg:.4f} ms (device times)")
    del rhs7, mode_rhs, vol4, n7_calls, n4_calls, n7_io, n4_io, d4, q4m

    # ---- 22., 23. K1 at N+1 = 6, 7: the Euler paths JAX runs on it ----
    def k1_order_path(n, k1d, dt, kw, phase):
        """The Euler path at order n whose 'auto' volume stage is K1
        (JAX's joint_packed): K1 and K2 against their plain versions (f32
        at full width, f64 small), 20 steps with every counter at 0
        before, the twin, conservation, f64 rhstest, then the rate beside
        volume_mode='split' and K1's device time.  Returns the kernels
        line's numbers for K1 at this order."""
        stamp(phase)
        disc, q0 = euler_hex_3d(n=n, k1d=k1d, dtype=torch.float32,
                                device=dev)
        if not fv.detect_axis_aligned(disc):
            raise AssertionError(f"the N={n} k1d={k1d} mesh must be "
                                 "detected axis-aligned")
        if resolve_volume_mode(disc) != "joint_packed":
            raise AssertionError(f"'auto' must resolve to K1 at N={n}")
        tag = f"N={n} k1d={k1d}"
        abs_v, _, vargs, vkw, sargs, skw, kouts = check_kernels(
            disc, random_state(disc, 20 + n), True,
            f"{tag} f32 diag (the N={n} path)")
        for k1d_s in (4, 3):
            d_, _ = euler_hex_3d(n=n, k1d=k1d_s, dtype=torch.float64,
                                 device=dev)
            q_ = random_state(d_, 21)
            ragged = " (K=27, ragged tile)" if k1d_s == 3 else ""
            check_kernels(d_, q_, True, f"N={n} k1d={k1d_s} f64 diag{ragged}")
            check_kernels(d_, q_, False, f"N={n} k1d={k1d_s} f64 general, "
                          f"random metric{ragged}", random_affine(d_))
        rhs_n = make_euler_rhs_fused(disc, dissipation=True, **kw)
        zero_counts()
        qf, _ = lsrk45(rhs_n, q0, dt, STEPS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        print(f"N={n} path ('auto' = K1{', force_fused' if kw else ''}): "
              f"{STEPS} LSRK45 steps ({5 * STEPS} stages) at dt={dt:g}, "
              f"launches {counts}")
        want = {"euler_volume": 5 * STEPS, "euler_surface": 5 * STEPS,
                "lsrk45_update": 5 * STEPS}
        if counts != want:
            raise AssertionError(f"expected launches {want} on the N={n} "
                                 "path")
        no_plain_work(f"N={n} path")
        if qf.dtype != torch.float32 or not bool(torch.isfinite(qf).all()):
            raise AssertionError(f"N={n} state not finite f32")
        twin_n = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                                compute_rhstest=False)
        qt, _ = lsrk45(twin_n, q0, dt, STEPS)
        e_tw, _ = rel_err(qf, qt)
        print(f"N={n} path vs plain twin after {STEPS} steps: rel "
              f"{e_tw:.3e} (tol {TWIN_TOL_F32:.0e})")
        if not e_tw <= TWIN_TOL_F32:
            raise AssertionError(f"N={n} path disagrees with the plain twin")
        check_conservation(disc, q0, qf, f"N={n} path ")
        del qt, qf, twin_n
        d_, _ = euler_hex_3d(n=n, k1d=3, dtype=torch.float64, device=dev)
        zero_counts()
        _, aux = make_euler_rhs_fused(d_, dissipation=False,
                                      compute_rhstest=True, **kw)(
            random_state(d_, 22))
        rt = float(aux["rhstest"])
        print(f"f64 N={n} k1d=3 kernel path (launches {read_counts()}), "
              f"dissipation off: rhstest {rt:.3e} (tol "
              f"{RHSTEST_TOL_F64:.0e})")
        if not (abs(rt) <= RHSTEST_TOL_F64
                and read_counts()["euler_volume"] == 1):
            raise AssertionError(f"entropy conservation violated (N={n})")
        del d_
        dof = 5 * disc.np_ * disc.num_elements
        step_ms = cuda_ms(lambda: lsrk45(rhs_n, q0, dt, TIMED_STEPS), 1)
        stage_ms = step_ms / (5 * TIMED_STEPS)
        print(f"[{card}] N={n} path (K1+K2, LSRK45): "
              f"{dof * 5 * TIMED_STEPS / (step_ms / 1e3):.4e} "
              f"DOF*RK-stage/s, {stage_ms:.4f} ms/stage over "
              f"{5 * TIMED_STEPS} stages, median of {REPEATS}")
        srhs = make_euler_rhs_fused(disc, dissipation=True,
                                    volume_mode="split", **kw)
        e_s, _ = rel_err(srhs(q0)[0], rhs_n(q0)[0])
        if not e_s <= TOL["float32"]:
            raise AssertionError(f"N={n} 'split' disagrees with K1")
        sstep_ms = cuda_ms(lambda: lsrk45(srhs, q0, dt, N4_TIMED_STEPS), 1)
        sstage_ms = sstep_ms / (5 * N4_TIMED_STEPS)
        k1n_ms = dev_ms(lambda: fv.euler_volume(*vargs, **vkw), 20)
        k1n_plain_ms = dev_ms(lambda: fv.euler_volume_plain(*vargs, **vkw),
                              2)
        split_ms = dev_ms(lambda: fv.euler_volume_split_parts(
            vargs[0], vargs[1], vargs[2], gamma, **vkw), 20)
        k2n_ms = dev_ms(lambda: fv.euler_surface(*sargs, **skw), 20)
        sdev = dev_ms(lambda: lsrk45(rhs_n, q0, dt, 10), 1) / 50
        print(f"[{card}] N={n} volume_mode='split' (one RHS vs K1 rel "
              f"{e_s:.3e}): {dof * 5 * N4_TIMED_STEPS / (sstep_ms / 1e3):.4e}"
              f" DOF*RK-stage/s, {sstage_ms:.4f} ms/stage over "
              f"{5 * N4_TIMED_STEPS} stages, against 'auto' (K1) "
              f"{stage_ms:.4f} ms/stage ({sstage_ms / stage_ms - 1:+.1%})")
        print(f"[{card}] N={n} k1d={k1d} f32 device times: K1 {k1n_ms:.4f} ms "
              f"(plain {k1n_plain_ms:.4f}), split front (to the parts) "
              f"{split_ms:.4f} ms, K2 N+1={n + 1} {k2n_ms:.4f} ms; stage "
              f"queued ahead of the device {sdev:.4f} of {stage_ms:.4f} ms")
        k_out, k_tr, _ = kouts
        ne_ = disc.num_elements
        b = bound(nbytes(vargs[0], disc.geo, vargs[2], disc.lift, k_out,
                         k_tr),
                  ops_k1(n + 1, entries(vargs[2]), entries(vargs[3])) * ne_,
                  vargs[0].dtype)
        return dict(launches=counts["euler_volume"], err=abs_v, ms=k1n_ms,
                    plain_ms=k1n_plain_ms, bound=b)

    k1_n6 = k1_order_path(N5, N5_K1D, N5_DT, {}, "22")
    torch.cuda.empty_cache()
    k1_n7 = k1_order_path(N6, N6_K1D, N6_DT,
                          dict(force_fused=True), "23")
    torch.cuda.empty_cache()

    def k1_one_rhs(disc, q, kw, label):
        """One RHS of make_euler_rhs_fused with every counter at 0 before:
        K1 and K2 launched once, nothing else; returns K1's launches."""
        zero_counts()
        dq, _ = make_euler_rhs_fused(disc, dissipation=True, **kw)(q)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        print(f"{label}: one RHS, launches {counts}")
        if counts != {"euler_volume": 1, "euler_surface": 1}:
            raise AssertionError(f"expected K1 and K2 once ({label})")
        no_plain_work(label)
        if not bool(torch.isfinite(dq).all()):
            raise AssertionError(f"{label}: RHS not finite")
        return counts["euler_volume"]

    def k1_row(disc, vargs, vkw, kouts, launches, err, form, tag, curved):
        """Device times and the bound of K1 at these shapes."""
        ms = dev_ms(lambda: fv.euler_volume(*vargs, **vkw), 20)
        pms = dev_ms(lambda: fv.euler_volume_plain(*vargs, **vkw), 2)
        print(f"[{card}] K1 {tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms "
              f"({pms / ms:.1f}x), device times")
        ne_, n1 = disc.num_elements, disc.line_ops.n1d
        extra = (line_metric_bytes(n1, ne_, vargs[0].element_size())
                 if curved else nbytes(vargs[1]))
        b = bound(nbytes(vargs[0], vargs[2], vargs[3], *kouts[:2]) + extra,
                  ops_k1(n1, entries(vargs[2]), entries(vargs[3]), form)
                  * ne_,
                  vargs[0].dtype)
        return dict(launches=launches, err=err, ms=ms, plain_ms=pms, bound=b)

    # ---- 24. K1 at N+1 = 8: curved (K1c) and affine volume_mode='joint' ----
    stamp("24")
    k1_n8 = {}
    for label, curved, kw in (
            ("curved", True, dict(force_fused=True)),
            ("affine", False, dict(force_fused=True, volume_mode="joint"))):
        d_, _ = euler_hex_3d(n=7, k1d=N7_K1_K1D, curved=curved,
                             dtype=torch.float32, device=dev)
        q_ = random_state(d_, 23)
        diag = not curved and fv.detect_axis_aligned(d_)
        tag = (f"N=7 k1d={N7_K1_K1D} f32 {label}"
               + (" diag" if diag else "") + " (N+1=8)")
        geom = curved_geom(d_) if curved else None
        abs_v, _, vargs, vkw, _, _, kouts = check_kernels(d_, q_, diag, tag,
                                                          geom)
        for k1d_s in (4, 3):
            ds, _ = euler_hex_3d(n=7, k1d=k1d_s, curved=curved,
                                 dtype=torch.float64, device=dev)
            qs = random_state(ds, 24)
            ragged = " (K=27, ragged tile)" if k1d_s == 3 else ""
            check_kernels(ds, qs, diag, f"N=7 k1d={k1d_s} f64 {label}"
                          + (" diag" if diag else "") + ragged,
                          curved_geom(ds) if curved else None)
            if not curved:
                check_kernels(ds, qs, False, f"N=7 k1d={k1d_s} f64 general, "
                              f"random metric{ragged}", random_affine(ds))
        kws = ", ".join(f"{k}={v!r}" for k, v in kw.items())
        n_launch = k1_one_rhs(d_, q_, kw,
                              f"N=7 k1d={N7_K1_K1D} {label} ({kws})")
        k1_n8[label] = k1_row(d_, vargs, vkw, kouts, n_launch, abs_v,
                              "curved" if curved else
                              ("diag" if diag else "general"),
                              tag, curved)
        del d_, q_, vargs, kouts
    torch.cuda.empty_cache()

    # ---- 25. K1c at N+1 = 6: curved N=5 ----
    stamp("25")
    cd5, _ = euler_hex_3d(n=5, k1d=CURVED_N5_K1D, curved=True,
                          dtype=torch.float32, device=dev)
    cq5 = random_state(cd5, 25)
    tag = f"curved N=5 k1d={CURVED_N5_K1D} f32 (N+1=6)"
    abs_v, _, vargs, vkw, _, _, kouts = check_kernels(cd5, cq5, False, tag,
                                                      curved_geom(cd5))
    for k1d_s in (4, 3):
        ds, _ = euler_hex_3d(n=5, k1d=k1d_s, curved=True, dtype=torch.float64,
                             device=dev)
        check_kernels(ds, random_state(ds, 26), False,
                      f"curved N=5 k1d={k1d_s} f64"
                      + (" (K=27, ragged tile)" if k1d_s == 3 else ""),
                      curved_geom(ds))
    n_launch = k1_one_rhs(cd5, cq5, {}, f"curved N=5 k1d={CURVED_N5_K1D}")
    k1c_n6 = k1_row(cd5, vargs, vkw, kouts, n_launch, abs_v, "curved", tag,
                    True)
    del cd5, cq5, vargs, kouts
    # the free stream, f64: at k1d=8 against FREESTREAM_TOL_F64 (phase 14's
    # mesh size); at the path's k1d=16 the metric identity's own roundoff
    # floor is above it (the JAX package's lines RHS reads 1.66e-10 there
    # on the CPU), so the kernel path is held to the plain twin's residual
    fs5 = {}
    for k1d in (8, CURVED_N5_K1D):
        ds, _ = euler_hex_3d(n=5, k1d=k1d, curved=True, dtype=torch.float64,
                             device=dev)
        zero_counts()
        fs_k = float(make_euler_rhs_fused(ds, dissipation=True)(
            constant_state(ds))[0].abs().max())
        launched = read_counts()["euler_volume"]
        fs_t = float(make_euler_rhs(ds, dissipation=True,
                                    flux_diff_impl="lines",
                                    compute_rhstest=False)(
            constant_state(ds))[0].abs().max())
        fs5[k1d] = (fs_k, fs_t)
        print(f"free stream on the warped mesh, N=5 k1d={k1d} f64: max |dq| "
              f"of a constant state, kernel path (K1 launches {launched}) "
              f"{fs_k:.3e}, plain twin 'lines' {fs_t:.3e}")
        if launched != 1:
            raise AssertionError("expected one K1 launch (free stream)")
        del ds
    print(f"free stream checks: k1d=8 kernel path <= {FREESTREAM_TOL_F64:.0e}"
          f"; k1d={CURVED_N5_K1D} kernel path <= "
          f"{FREESTREAM_TWIN_FACTOR:g} x the twin's")
    if not (fs5[8][0] <= FREESTREAM_TOL_F64
            and fs5[CURVED_N5_K1D][0] <= FREESTREAM_TWIN_FACTOR
            * fs5[CURVED_N5_K1D][1]):
        raise AssertionError("free stream not preserved on the curved mesh "
                             "(N=5)")
    torch.cuda.empty_cache()

    # ---- 26. the 3D Becker shock tube at N=5 through fused_hex ----
    stamp("26")
    from esdg_cns_tpu_torch.physics.exact import BeckerShock
    from esdg_cns_tpu_torch.presets import becker_shocktube_3d
    from esdg_cns_tpu_torch.solvers import l2_error

    def becker_case(k1d, dtype, mu=None):
        disc, q0, bc, shock = becker_shocktube_3d(
            n=BECKER_N, k1d=k1d, dtype=dtype, device=dev,
            shock=None if mu is None else BeckerShock(mu=mu))
        flags = dict(mu=shock.mu, pr=shock.pr, bc=bc,
                     inviscid_dissipation=True, compute_rhstest=False)
        return (disc, q0, shock, flags,
                make_cns_rhs_affine(disc, volume_impl="fused_hex", **flags))

    bdt = becker_dt(BECKER_N, BECKER_K1D)
    becker = {}
    for dtype, tol in ((torch.float32, TWIN_TOL_F32),
                       (torch.float64, TWIN_TOL_F64)):
        disc, q0, shock, flags, brhs = becker_case(BECKER_K1D, dtype)
        name = dtype_name(q0)
        zero_counts()
        qf, _ = lsrk45(brhs, q0, bdt, STEPS)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        print(f"Becker 3D N={BECKER_N} k1d={BECKER_K1D} (K={disc.num_elements}"
              f", mu={shock.mu}) {name} fused_hex: {STEPS} LSRK45 steps at "
              f"dt={bdt:.6g}, launches {counts}")
        want = {"euler_volume": 5 * STEPS, "cns_surface_viscous": 5 * STEPS,
                "cns_traction_tail": 5 * STEPS, "lsrk45_update": 5 * STEPS}
        if counts != want:
            raise AssertionError(f"expected launches {want} on the Becker "
                                 "path")
        if not bool(torch.isfinite(qf).all()):
            raise AssertionError("Becker state not finite")
        qt, _ = lsrk45(make_cns_rhs(disc, **flags), q0, bdt, STEPS)
        e_tw, _ = rel_err(qf, qt)
        _, aux = brhs(qf, STEPS * bdt)
        rtv = float(aux["rhstest_visc"])
        print(f"Becker 3D {name} fused_hex vs twin make_cns_rhs after "
              f"{STEPS} steps: rel {e_tw:.3e} (tol {tol:.0e}); rhstest_visc "
              f"{rtv:.4e} (>= 0)")
        if not (e_tw <= tol and rtv >= 0.0):
            raise AssertionError(f"Becker path ({name}) disagrees with the "
                                 "twin or produces negative entropy")
        becker[name] = (disc, q0, shock, brhs)
        del qt, qf
    # accuracy against the exact wave, f64, both meshes to one time: with
    # mu = 0.01 the shock (about 0.02 wide) is under-resolved at k1d=16 and
    # 32 (0.125 per element) and the error does not fall (printed); the
    # check takes the wave of the JAX package's accuracy tests (mu = 0.1,
    # tests/test_viscous.py:151), which the meshes resolve
    t_end = STEPS * becker_dt(BECKER_N, BECKER_K1D // 2)
    errs = {}
    for mu in (None, BECKER_ACCURACY_MU):
        for k1d in (BECKER_K1D // 2, BECKER_K1D):
            disc, q0, shock, _, brhs = becker_case(k1d, torch.float64, mu)
            ns = int(np.ceil(t_end / becker_dt(BECKER_N, k1d)))
            qf, _ = lsrk45(brhs, q0, t_end / ns, ns)
            u1d = shock.conservative(disc.xq[0].cpu().numpy(), t_end)
            z = np.zeros_like(u1d[0])
            exact = torch.as_tensor(np.stack([u1d[0], u1d[1], z, z, u1d[2]]),
                                    device=dev)
            errs[shock.mu, k1d] = float(l2_error(disc, qf, exact))
            print(f"Becker 3D f64 mu={shock.mu} k1d={k1d} "
                  f"(K={disc.num_elements}): {ns} steps to t={t_end:.6g}, L2 "
                  f"error against the exact wave {errs[shock.mu, k1d]:.4e}"
                  + ("" if mu else " (printed)"))
    if not (errs[BECKER_ACCURACY_MU, BECKER_K1D]
            < errs[BECKER_ACCURACY_MU, BECKER_K1D // 2]):
        raise AssertionError("the Becker error did not fall with the mesh")
    # the rate over the twins' 25 stages, as before the ghosts' bisection
    # became one kernel (ops/becker_bisect.py; it was some 1400 small
    # launches per RHS), so the two read alike
    disc, q0, shock, brhs = becker["float32"]
    bdof = 5 * disc.np_ * disc.num_elements
    bstep_ms = cuda_ms(lambda: lsrk45(brhs, q0, bdt, TWIN_TIMED_STEPS), 1)
    bstage_ms = bstep_ms / (5 * TWIN_TIMED_STEPS)
    bdev = dev_ms(lambda: lsrk45(brhs, q0, bdt, 2), 1) / 10
    ghost_ms = cuda_ms(lambda: shock.conservative_torch(disc.xf[0], 0.01), 5)
    print(f"[{card}] Becker 3D N={BECKER_N} k1d={BECKER_K1D} f32 (exact-wave "
          f"ghosts + K1 N+1=6 + exchange + K4-3D + exchange + LIFT, LSRK45): "
          f"{bdof * 5 * TWIN_TIMED_STEPS / (bstep_ms / 1e3):.4e} "
          f"DOF*RK-stage/s, {bstage_ms:.4f} ms/stage over "
          f"{5 * TWIN_TIMED_STEPS} stages, median of {REPEATS}; stage queued "
          f"ahead of the device {bdev:.4f} ms; the ghosts' exact state "
          f"(the bisection kernel, 100 halvings, and the conversions; once "
          f"per RHS) {ghost_ms:.4f} ms")
    del becker, disc, q0, brhs
    torch.cuda.empty_cache()

    # ---- 27.-30. the modal front on lines and hexes, the paper anchor ----
    modal_rows, bisect_times = modal_phases(types.SimpleNamespace(
        dev=dev, card=card, zero_counts=zero_counts, read_counts=read_counts,
        held=held, cavity_kernels=cavity_kernels, dev_ms=dev_ms,
        kernel_times=kernel_times,
        path_timing=path_timing, mass=mass))
    torch.cuda.empty_cache()

    hex_split = split_rows["hex"]
    rows = [
        ("euler_volume", "hex_volume.cu", "pallas_volume.py:87",
         launches["euler_volume"], main_abs_v, k1_ms, k1_plain_ms, k1_bound),
        ("euler_surface", "hex_surface.cu", "pallas_volume.py:1146",
         launches["euler_surface"], main_abs_s, k2_ms, k2_plain_ms, k2_bound),
        ("euler_modal_volume", "tri_modal_volume.cu",
         "pallas_modal_volume.py:45", cav_launches["euler_modal_volume"],
         cerrs["front"], k3_ms, k3_plain_ms, k3_bound),
        ("cns_surface_viscous", "cns_surface_viscous.cu",
         "pallas_viscous.py:152", cav_launches["cns_surface_viscous"],
         cerrs["k4"], k4_ms, k4_plain_ms, k4_bound),
        ("cns_surface_viscous_3d", "cns_surface_viscous_dim3.cu",
         "pallas_viscous.py:152", cav3_launches["cns_surface_viscous"],
         herrs["k4"], h4_ms, h4_plain_ms, h4_bound),
        ("cns_surface", "cns_surface.cu", "pallas_cns_surface.py:155",
         hex_split["launches"]["cns_surface"], herrs["k8"],
         *hex_split["times"]["K8 cns_surface"], hex_split["k8_bound"]),
        ("cns_viscous", "cns_viscous_dim3.cu", "pallas_viscous.py:131",
         hex_split["launches"]["cns_viscous"], herrs["k7"],
         *hex_split["times"]["K7 cns_viscous"], hex_split["k7_bound"]),
        ("euler_volume_curved", "hex_volume.cu", "pallas_volume.py:87",
         curved_launches["euler_volume"], cv_abs_v, k1c_ms, k1c_plain_ms,
         k1c_bound),
        ("euler_surface_curved", "hex_surface.cu", "pallas_volume.py:1146",
         curved_launches["euler_surface"], cv_abs_s, k2c_ms, k2c_plain_ms,
         k2c_bound),
        # K3c: no path of either package reaches the curved modal volume
        # (make_cns_rhs_affine needs an affine mesh), so no path launches
        # it; it is held against its plain version in phase 16
        ("euler_modal_volume_curved", "tri_modal_volume.cu",
         "pallas_modal_volume.py:45", 0, fd_rows["modal"][0], k3c_ms,
         k3c_plain_ms, k3c_bound),
        ("flux_differencing_dense", "dense_fd.cu", "pallas_fd.py:250",
         dense_launches, fd_rows["dense"][0], k5_ms, k5_plain_ms, k5_bound),
        ("flux_differencing_lines_fused", "hex_lines.cu",
         "tensor_product_fd.py:506", lines_launches, fd_rows["lines"][0],
         r10_ms, r10_plain_ms, r10_bound),
        # the split path: launches over the N=7 path's 100 stages (the
        # dense fd: the N=4 'split_dense' run's); ms per launch at N=7
        # k1d=16 (the fd: the mean of the three directions; the dense fd
        # at N=4 k1d=24, the shape of the run that counts it)
        ("hex_project", "hex_split.cu", "pallas_volume.py:429",
         n7_launches["hex_project"], n7_errs["proj"], *n7_times["proj"],
         proj_bound),
        ("hex_fd_dir", "hex_split.cuh", "pallas_volume.py:451",
         n7_launches["hex_fd_dir"], n7_errs["fd"], fd_avg, fd_plain_avg,
         fd_bound),
        ("hex_fd_dir_dense", "hex_split.cuh", "pallas_volume.py:930",
         mode_launches["split_dense"]["hex_fd_dir_dense"],
         max(n7_errs["dense"], n4_errs["dense"]), dense_avg,
         dense_plain_avg, dense_bound),
        ("euler_surface_n8", "hex_surface.cu", "pallas_volume.py:1146",
         n7_launches["euler_surface"], n7_errs["k2"], *n7_times["k2"],
         k2n8_bound),
        # K1 at N+1 = 6, 7 (phases 22, 23: launches over each path's 100
        # stages), at N+1 = 8 and K1c at N+1 = 6, 8 (one RHS each)
    ] + [(name, src, "pallas_volume.py:87", r["launches"], r["err"], r["ms"],
          r["plain_ms"], r["bound"])
         for name, src, r in (
             ("euler_volume_n6", "hex_volume6.cu", k1_n6),
             ("euler_volume_n7", "hex_volume7.cu", k1_n7),
             ("euler_volume_n8", "hex_volume8.cu", k1_n8["affine"]),
             ("euler_volume_curved_n6", "hex_volume6.cu", k1c_n6),
             ("euler_volume_curved_n8", "hex_volume8.cu",
              k1_n8["curved"]))] + modal_rows
    # ---- 31. the probes and the fd section; the priced bounds ----
    probe_rows, prices, fma_per_s = probe_phases(types.SimpleNamespace(
        dev=dev, card=card, dev_ms=dev_ms))
    rows += probe_rows
    # ---- 32. the parent tree against this one (--parent DIR only) ----
    if parent is not None:
        stamp("32")
        ab_phase(card, dev, dev_ms, parent)
    kernels_line = report(card, rows, prices, fma_per_s, split_rows,
                          bisect_times)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout of the parent commit (git archive "
                    "into a folder .gitignore lists): phase 32 times its "
                    "kernels and stages against this tree's, in turns")
    rc = main(ap.parse_args().parent)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
