#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Seven paths of exp_tpu_torch, each with backend='pallas', run the port's
eleven hand-written kernels, and the YAML driver runs two of those paths
from run configs, with and without its extras:

  the sphere path (1,048,576 particles): the sphereSL KDK step of a
    Hernquist halo under the spherical Sturm-Liouville basis (lmax=4,
    nmax=10, 2000 radial nodes), through K1 (sphere coefficients,
    csrc/sphere_coef.cu) and K2 (sphere force, csrc/sphere_accel.cu);
  the disk path (1,048,576 particles): the EOF cylinder KDK step of the
    disk bench (mmax=6, nmax=18, 256 x 128 EOF tables, ncx=64 'spline'),
    through K4 (cylinder coefficients, csrc/cyl_coef.cu) and K5 (cylinder
    force, csrc/cyl_accel.cu);
  the cube path (4,194,304 particles): the periodic plane-wave cube of the
    cube bench (nmax=6 on each axis, dt=1e-3), through K7 (cube
    coefficients, csrc/cube_coef.cu; K11a, pallas_version 1, is the same
    kernel) and K8 (cube force, csrc/cube_accel.cu; K11b reaches it
    through its v1 packing);
  the slab path (1,048,576 particles): the periodic slab of the slab bench
    (nmax 4 x 4 x 6, numz=401, nzc=126 'spline', an isothermal sheet,
    dt=1e-3), through K9 (slab coefficients, csrc/slab_coef.cu) and K10
    (slab force, csrc/slab_accel.cu);
  the sphere-settings path (1,048,576 particles): the sphere path's halo
    under SphereSL's other pallas settings, through K3 (recurrence
    coefficients, csrc/sphere_coef_rec.cu), K6 (poly force,
    csrc/sphere_accel_poly.cu), the 'hat' branches of K1 and K2 and K2 at
    lmax 10;
  the composite path (1,048,576 particles): the flagship disk + halo of
    the composite bench (exp_tpu_torch/bench_composite.py), 786,432 halo
    particles under the sphere path's basis and 262,144 disk particles
    under the disk path's, from the DiskHalo ICs, coupled both ways and
    stepped by the 4-level binary multistep (M=4, dtime 2e-3), through K1,
    K2, K4 and K5 on the per-level buckets;
  the phase-stream probe (1,048,576 particles): the slab coefficients G
    from a streamed bf16 phase table (exp_tpu_torch/
    probe_slab_phasestream.py), through P1 (csrc/slab_phasestream.cu);
  the driver path: exp_tpu_torch's YAML driver (nbody/simulation.py,
    run.py) on the flagship composite's run config, through K1, K2, K4
    and K5, and single-rate on the sphere path's sample, through K1 and K2;
  the remaining forces: hernq, CBsphere and twocenter through K1 and K2
    from run configs, and bessel, direct, shells and halobulge (plain
    torch, no TPU kernel) at the same sizes;
  the multistep relevel's movers-only style, the composite's energy bars
    and the multi-rank runs (a one-rank NCCL world, two ranks on the
    card), through K1, K2, K4 and K5;
  the analysis library (exp_tpu_torch/analysis, io/readers.py): snapshots
    read back through createReader and projected by Basis, fields
    rendered by FieldGenerator, FieldBasis, BiorthWake, cross_validate,
    diskeof, the kinematic series, MSSA and Koopman, through K1, K2, K4
    and K5, and K7/K8 and K9/K10 once each;
  what a world of several ranks runs since ROADMAP item 12b: the host
    operators, the adaptive sphereSL rebuild and the writers OutAscii,
    OrbTrace, OutDiag, OutFrac, OutCalbr and OutVel, through K1 and K2;
  the remaining ICs (exp_tpu_torch/bench_ics.py): the QP halo of gensph
    --qp, the Zang disk of zangics under its flatdisk basis and the 2D disk
    + halo of gendisk2d --nhalo, through K1, K2, K4 and K5;
  the last slice (ROADMAP item 14b.2): the native ascii reader, the
    PhaseSpace and IC tools as child processes, and the port's sphere
    step against the f64 comparator (exp_tpu_torch/validate.py,
    bench_validate.py), through K1 and K2 in their 'hat' branches.

Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from the sources with nvcc (sm_90a), in parallel;
  3. build the sphere tables and the force on the card;
  4. K1 and K2 against their plain PyTorch versions on the same inputs (the
     benches' sample plus edge rows), with the stated tolerances;
  5. the sphere path: init + 50 KDK steps (dt=1e-3) of an equilibrium
     sample, with each kernel's launch count, finiteness, the virial ratio
     and the energy drift gated;
  6. sphere timing: the steady-state step on the benches' sample, each
     kernel and its plain version with CUDA events, and each bound;
  D1. build the disk bench's EOF tables on the host and the force on the
     card;
  D2. K4 and K5 against their plain versions on the disk bench's sample
     plus edge rows, with the stated tolerances;
  D3. the disk path: init + 50 KDK steps (dt=1e-4) of the bench's sample
     and velocities, with each kernel's launch count, finiteness, the
     energy drift and the change of Lz gated (2T/VC is reported: the
     sample is not an equilibrium of its own field);
  D4. disk timing, as in phase 6;
  C1. the cube bench's uniform sample and a perturbed sample (a 50%
     density wave along x), and the force on the card;
  C2. K7 and K8 against their plain versions on both samples plus edge
     rows, with the stated tolerances; the Poisson solution of the
     perturbed sample; the pallas_version 1 entry against version 2;
  C3. the cube path: init + 50 KDK steps (dt=1e-3) of the perturbed sample,
     with each kernel's launch count, finiteness, the energy drift and the
     total momentum gated; then the pallas_version 1 path, which must give
     the same state bit for bit;
  C4. cube timing, as in phase 6;
  SL1. the slab bench's tables on the host and the force on the card; the
     bench's sheet, a sample half outside |z| <= zmax, and edge rows;
  SL2. K9 and K10 ('spline' and 'linear') against their plain versions on
     both samples plus edge rows, with the stated tolerances, each
     repeatable bit for bit; the sheet's mean field and the vacuum
     continuation beyond zmax;
  SL3. the slab path: init + 50 KDK steps (dt=1e-3) of the bench's sheet,
     with each kernel's launch count, finiteness, the energy drift, the
     change of the horizontal momentum and of the sheet's thickness gated;
  SL4. slab timing, as in phase 6, with K10 also under 'linear' and on an
     outside sample of 1,048,576 rows (the vacuum branch);
  V1. lmax=10, nmax=10, numr=2000 tables of the same halo beside phase 3's
     lmax=4 ones, and a force on the card for each setting: recurrence (K3 +
     K2), poly (K1 + K6), hat (K1-hat + K2-hat), hat + recurrence (K3-hat +
     K2-hat), hat + poly (K1-hat + K6-hat) and lmax 10 under 'auto' (K3 +
     K2 above lmax 6);
  V2. each new kernel and branch against its plain version on the benches'
     sample plus edge rows and rows exactly on hat nodes, with the stated
     tolerances; zero-mass and masked rows give exactly 0;
  V3. init + 50 KDK steps (dt=1e-3) of phase 5's equilibrium sample under
     each setting, with each kernel's launch count, finiteness, the virial
     ratio and the energy drift gated;
  V4. the steady step of each setting, and each new kernel and branch with
     its plain version by CUDA events, and each bound;
  CM1. the composite's forces on phase 3's and D1's tables and the DiskHalo
     ICs on the card, with the virial ratio gated;
  CM2. init_state, the warmup (until the capacity signature holds for 2
     relevels, at most 8 big steps) and 10 big steps with relevels, with
     finiteness, the live count and identities after every relevel, the
     capacity signature, each level's move, the energy drift and each
     kernel's launches against the schedule gated;
  CM3. big steps and relevels timed; K1, K2, K4 and K5 against their plain
     versions on every bucket, with the stated tolerances, and each one's
     device time a big step (profiler) beside its bound, and a launch on
     each level's bucket (CUDA events around launches queued behind a spin
     kernel), printed for each kernel and level;
  KS. K1 and K2 ('spline' and 'hat'), K4 and K5 on the sphere and disk
     benches' samples cut to 224 ... 1,048,576 rows with a padding row
     last, each against its plain version (K1, K2 and K5 also bit for bit
     under more padding), then timed at each size beside its bound, with
     the fitted fixed cost a launch and cost a row
     (exp_tpu_torch/bench_kernels.py);
  R1. the flagship's run config as a dict (the composite bench's settings,
     the halo's model as a file, both forces 'pallas', OUTLOG every big
     step, PSP every 10) and CM1's ICs as PSP body files;
  R2. Simulation on it for 10 big steps, with finiteness, 11 OUTLOG rows,
     OUTLOG's |dEtot/Etot| (DRIVER_DRIFT_BOUND), each kernel's launches
     against the schedule and the step-10 PSP file equal to the state
     gated; the bare MultistepRunner from the same bodies on CM1's forces,
     its state equal to the driver's bit for bit after init_state and
     every big step; `exp_tpu_torch.run` on the config as a YAML file,
     its OUTLOG rows equal to the driver's;
  R3. the single-rate driver on phase 5's sample as an ascii body file
     (its write and NumPy read timed), 50 steps under phase 5's gates;
  R4. the driver's time a big step and a step beside the bare runner's
     and make_kdk_step's, on the host clock (printed, not gated);
  E1. the flagship's run config with the disk's EJ: 2, nEJkeep 256,
     EJwindow 16, nEJaccel 8 and the halo's npca 5, nsamples 8, tk_type
     Hall (exp_tpu_torch/bench_extras.py), 10 big steps from t = 0, with
     finiteness after every big step, 11 OUTLOG rows, an orient-log row an
     update, K2/K4/K5's launches the schedule's and K1's the schedule's
     plus nsamples a Hall update, the tracked center against its NumPy
     f64 recomputation from the card's synced state, the halo's set the
     driver assembled in the last big step against its Hall weights on
     K1's plain version's coefficients of the synced state, the driver's
     next Hall update against the same update through K1's plain version,
     and OUTLOG's |dEtot/Etot| (E1_DRIFT_BOUND) gated;
  E2. the sphere run config with the halo's NO_L1 and External userbar,
     50 steps, with finiteness, 51/51 launches of K1 and K2, the l = 1
     coefficients exactly 0 after every step, 2T/VC at both ends and the
     bar's acceleration at 4,096 bodies against f64 gated;
  E3. the flagship's run config with the halo's self_consistent: false,
     10 big steps, with the halo's coefficients equal to the initial ones
     bit for bit after every big step, K1 launched only by init_state,
     K2/K4/K5 the schedule's, finiteness and the disk's |dE/E|
     (E3_DRIFT_BOUND) gated;
  E4. E1's and E3's big step and E2's step beside R4's, the Orient and
     Hall timers, one EJ and one Hall update, a ScatterMFP application and
     a NOISE draw at 2^20, on the host clock (printed, not gated);
  MF1. the analytic bases (exp_tpu_torch/bench_forces.py): hernq on phase
     5's sample and CBsphere on a 2^20 Plummer sample, lmax 4, nmax 10,
     numr 2000, rmax 50, pallas, K1 and K2 on their tables against the
     plain versions, each basis's field on 12 radii against its model's
     M(<r)/r^2 (median under 3%), then the single-rate driver for 50
     steps with 51 / 51 launches, OUTLOG's |dE/E| and 2T/VC against a CPU
     run of the same config; bessel (gather) in f32 against f64;
  MF2. twocenter on a 2^20 lopsided cusp + envelope (tests/test_twocenter
     .py:39's, EJ: 2): K1 and K2 on the inner and outer inputs against
     the plain versions, the two-center field against the direct sum
     beside one COM-centered expansion, the single-rate driver for 20
     steps and multistep 2 for 4 big steps, launches twice the
     single-center schedule, finite state and KE > 0;
  MF3. DirectForce at 65,536 bodies in each source model, f32 against f64,
     one evaluation timed with its temporaries' peak; the sphere path's
     halo and a one-body bh under direct at multistep 4 for 4 big steps,
     launches the schedule's and the halo's |dE/E| against a CPU run;
  MF4. shells and halobulge at 2^20 on the card against the same on the
     CPU and the model's M(<r)/r^2; MF1-MF3's step times (host clock);
  RI1. the composite from CM1's ICs, 10 big steps with a relevel each
     under rebucket_style 'incremental' and under 'sortfull': in lockstep
     each relevel both ways from one state, the live sets bucket by
     bucket, each particle's x, v, acc, pot bit for bit and the rebuilt
     registers gated; launches the schedule's; n_compactions and
     relevel_ms both ways; K1, K2, K4, K5 on the incremental run's
     buckets;
  MD1. the flagship run config through `run.py --distributed` as a world
     of one rank over NCCL: R2's state bit for bit and R2's launches;
  MD2. (a) the sphere cell's 2^20 sample over two ranks on the card
     (gloo), 50 KDK steps: the coefficients every step against one rank's,
     the sphere's 2T/VC and |dE/E| gates, 51 K1 and 51 K2 launches on
     each rank; (b) the flagship run config through `run.py --ndev 2`, 10
     big steps: OUTLOG and the level populations against MD1's, each file
     written once, and a restart from its own PSP snapshot; with two cards
     or more (a) also runs over NCCL on two cards; K1, K2, K4, K5 at a
     rank's shapes;
  AN1. 16 snapshots of phase 5's 2^20 sample (each x (1 + 0.01 sin 0.3t))
     written as PSP files and read back through createReader, equal bit
     for bit; Basis.factory on a sphereSL stanza (lmax 4, nmax 10,
     pallas) and create_from_snapshots, one K1 a snapshot, each
     snapshot's coefficients against K1's plain version (COEF_RTOL) and
     an f64 gather Basis (tests/test_spherical_force.py:270-294's bounds,
     the fields too); FieldGenerator slices (256^2) and volumes (64^3) at
     4 times, one K2 a time and grid, against the plain version; the
     monopole's power; FieldBasis (4 K1 a snapshot); BiorthWake's halves
     against the full field; cross_validate at 256 points
     (tests/test_analysis.py:152-154's bounds);
  AN2. CM1's 262,144 disk particles turned by 0.05 t rad, 8 snapshots:
     create_from_snapshots through K4 (one a snapshot) against its plain
     version, a 256^2 slice through K5 against its plain version,
     diskeof accumulate / rotate / rotated_grids with
     tests/test_diskeof.py:35-68's gates, the bess / lagu / ring series;
  AN3. expMSSA (window 8) and Koopman on AN1's series, every eigentriple
     giving the series back; VTK/PVD files of AN1's slices; a cube (nmax
     6) and a slab (the bench's) Basis at 2^20 through K7/K8 and K9/K10
     once each, against their plain versions; the host-clock times (a
     snapshot's read, upload and projection, a render a time, MSSA,
     cross_validate) and the peak device memory, printed;
  WX1. (after MD2) the sphere run config on phase 5's 2^20 sample with
     scatterMFP, generateRelaxation, the halo's sphereSL rebuilt every
     0.01 and OutAscii, OrbTrace, OutDiag, OutFrac and OutCalbr
     (bench_multirank.extras_run_config), 20 steps through `run.py` on one
     rank and `run.py --ndev 2` (gloo, both ranks on the card): every file
     written by each, each file against one rank's (bench_multirank.
     file_difference) at MD2(b)'s tolerances, K1 and K2 launched once a
     step on every rank and the launches at each rebuild; K1 and K2 at a
     rank's rows on tables rebuilt from the binned sample;
  WX2. OutVel's gather over two ranks on the card (each rank's
     projections summed) against one rank's, at MD2(a)'s bound (the card
     has no h5py: OutVel's and OutHDF5's files are held by the CPU tests);
  VR0. exp_tpu_torch.native builds (g++) and loads, and R3's 2^20-row
     ascii body file reads through it bit for bit as np.loadtxt reads it,
     both read times on the host clock;
  IC1. (after AN3) the QP halo of gensph --qp at 2^20 (its DF on the
     card), its 2T/VC in the model's field (tests/test_qpdistf.py:66), 50
     KDK steps under phase 3's force with its launches and drift gated, K1
     and K2 against their plain versions on its rows;
  IC2. the Zang disk of zangics at 262,144 under the 'zang' flatdisk basis
     (mmax 4, nmax 8), 20 KDK steps with z and vz exactly 0, its launches
     and drift gated, K4 and K5 against their plain versions;
  IC3. the 2D disk + halo of gendisk2d --nhalo (786,432 + 262,144, lmax 4
     nmax 10, mmax 4 nmax 8, pallas): -2T/VC (tests/test_diskhalo2d.py:77),
     the disk's z = vz = 0, 4 big steps at M=2 finite with the schedule's
     launches, K1, K2, K4 and K5 against their plain versions on its rows;
  PX1. (after AN3) doc/tutorial.md §3's pyEXP flow through
     `exp_tpu_torch.pyexp` on AN1's stanza: 8 PSP snapshots of phase 5's
     2^20 sample read by ParticleReader.createReader('PSPout') and
     projected by createFromReader, one K1 a snapshot, equal bit for bit to
     create_from_snapshots on the same files, against K1's plain version
     and an f64 gather basis; initFromArray / addFromArray in 4 chunks /
     makeFromArray against the one-shot projection; getFields at 4,096
     particles (two K2) against the plain version and the reference's
     labels; expMSSA and getReconstructed; FieldGenerator slices (256^2,
     one K2 a time); IntegrateOrbits of 1,024 bodies for 500 steps in the
     frozen field (one K2 a step and one first) with their mean |dE/E|
     gated and their end points against the plain version's;
     enableCoefCovariance at sampT 100 (101 K1); each step's host time;
  PX2. pyEXP's cylinder on D1's tables (pallas): createFromArray of CM1's
     262,144 disk particles through K4, getFields at 4,096 of them (two K5)
     and a midplane slice (one K5, then one for each of 17 scanned
     heights), each against the
     plain version, and the cylinder's geometry and labels;
  CL1. makecoefs (pallas) launching K1 and refusing loudly where h5py is
     missing; the ported tools as `python -m exp_tpu_torch.cli <tool>`
     child processes on the card: orthochk, slcheck, haloprof (a PX1 PSP
     file), diskprof (CM1's disk as a body file), slabprof, scalarprod
     (pallas), crossval and kldiv (65,536 rows), slshift, yamldiff, each
     exiting 0 with exp_tpu's output files;
  CL2. the PhaseSpace and IC tools of item 14b.2 as such children on PX1's
     2^20-row PSP files and CL1's body files: 34 runs of 32 tools, each
     exiting 0 with exp_tpu's file names and its word (forcetest on the
     2^20 halo at 500 points, its f64 expansion on the card; gendisk
     --nhalo at 4,096 + 8,192); psp2hdf5, hdf52accel and snapconvert's
     gadgethdf5 output refusing loudly without h5py.  CL1's and CL2's
     children run beside EN1 and EN2, one BLAS thread each and at most a
     core fewer than the host's at once, and are checked after them;
  PS1. P1 against its plain version on the probe's sample with edge rows,
     stream1 and stream2, with the stated tolerances;
  PS2. the probe's run: producer + P1, P1 alone, the producer, the
     yardstick and K9 at the same particles by CUDA events, each bound;
  VR1. (after PS2) (a) the f64 gather SphereSL step (deriv 'lerp') on the
     card against ReferenceSphereStep on the host at
     tests/test_reference_comparator.py's problem and gates (1e-12 a step,
     rtol 1e-10 / atol 1e-12, drift 1e-6 at 25 steps, 1e-9 over 300), no
     launch; (b) the same problem through K1 'hat' and K2 'hat'
     ('highest', the hats on the table's 1,000 nodes), 26 launches each
     over 25 steps, every step's coefficients against the comparator's;
     (c) phase 3's tables under (b)'s settings (2,000 nodes), one K1 of
     phase 5's 2^20 sample and one K2 against the comparator's, chunked on
     host threads; (b) and (c) within three times their plain versions'
     figures on a CPU; each kernel against its plain version and timed;
  EN1. exp_tpu_torch.bench_energy direct at the script's settings (500 big
     steps of the composite, 6 snapshots, a 65,536 subsample's true energy
     by a direct pair sum over every particle, and at each of the last 5
     big steps), gated by tests/test_energy_artifacts.py:42-66; one 65,536
     x 1,048,576 pair sum timed, the peak memory;
  EN2. bench_energy ab, arms A, B and C (100 big steps at dtime, 200 at
     dtime / 2, 100 relevelling every second big step), gated by
     tests/test_energy_artifacts.py:69-87, with arm A again at dtime (1 +
     1e-6) reported beside them.  The two gates of EN_SINGLE_DRAW are
     printed with the others, not failed on: one draw of each spreads
     wider than its bound on the card.

Prints one JSON line {"kernels": [...]} before EN1 and, last, {"ok": true,
"device": ...}.  Any failure raises and exits non-zero before the last line.  Needs
a CUDA device and the repository around it.
"""

import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores, dense TF32 FLOP/s on the tensor cores.  A bound
# is the larger of bytes / HBM rate and operations / FP32 rate; the cube
# kernels, whose products run as three TF32 passes, also carry the bound of
# that route (tc_bound_ms).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

N = 1_048_576
STEPS = 50
DT = 1e-3
# |dEtot/Etot| bound over the 50 steps.  The same run through the plain
# versions on a CPU (python -m exp_tpu_torch.bench_sphere kdk --device cpu)
# gave 8.1e-7, which is at the rounding level of the f32 energy sums over
# 2^20 particles (eps * log2 N ~ 2.4e-6); 1e-5 leaves room for sums taken
# in another order on the card and fails a step that breaks conservation.
DRIFT_BOUND = 1e-5
VIRIAL_TOL = 0.05
COEF_RTOL = 1e-5          # max|dc| / max|c|, f32 sums in another order
ACC_RTOL, ACC_ATOL = 1e-4, 1e-6
POT_RTOL, POT_ATOL = 1e-5, 1e-7

# The disk path (bench_suite.bench_disk's configuration).
DISK_STEPS = 50
DISK_DT = 1e-4
# |dEtot/Etot| bound over the 50 disk steps.  The same run through the
# plain versions on a CPU (python -m exp_tpu_torch.bench_disk kdk --device
# cpu) gave 6.89e-5: the disk sample is not an equilibrium of its own
# field, and the coarse-grid force is not the exact gradient of the
# interpolated potential, so Etot moves by that much in 50 steps at
# dt=1e-4.  Sums taken in another order on the card move each end's Etot
# by about eps * log2 N ~ 2.4e-6 of it, so the card should land within
# ~5e-6 of the CPU's drift; 1e-4 leaves room for that and fails a step
# whose force breaks conservation by half as much again.
DISK_DRIFT_BOUND = 1e-4
# |dLz/Lz| bound over the same run.  The CPU gave 2.0e-7: the sample's
# non-axisymmetric noise exerts almost no torque in 50 steps.  Each Lz is
# an f32 sum over 2^20 particles, good to ~eps * log2 N ~ 2.4e-6 in another
# order of summation, so the change read on the card may be up to ~5e-6;
# 1e-5 leaves room for that and fails a force with a spurious torque.
DISK_LZ_BOUND = 1e-5
# K4: G and the coefficients, max|d| / max|value|: f32 sums of 2^20
# particles in a varying order (shared-memory atomics, then the chunk
# partials in a fixed order), the same bound as K1.
CYL_COEF_RTOL = 1e-5
# K5: the same arithmetic as the plain version but for nvcc's FMA
# contraction (1 ulp a step) in the interpolation and the assembly, so
# rtol 1e-4 on acc and 1e-5 on pot as for K2.  Components that cancel to
# near 0 (F_z at the midplane, F_phi) are held to an atol of 1e-6 (acc) and
# 1e-7 (pot) of the field's largest value.
CYL_ACC_RTOL, CYL_ACC_ATOL_REL = 1e-4, 1e-6
CYL_POT_RTOL, CYL_POT_ATOL_REL = 1e-5, 1e-7

# The cube path (bench_suite.bench_cube's configuration).
CUBE_N = 4_194_304
CUBE_STEPS = 50
CUBE_V1_STEPS = 10
# |dEtot/Etot| bound over the 50 cube steps of the perturbed sample.  The
# same run through the plain versions on a CPU (python -m
# exp_tpu_torch.bench_cube kdk --device cpu, 4,194,304 particles) gave
# 1.33e-6.  Etot (-0.0049) is KE (0.015) + PE (-0.020): the f32 sums of
# 2^22 terms in another order may move each end by up to eps log2 N
# (|KE| + |PE|) / |Etot| ~ 1e-5 of Etot.  The force does work of 0.12
# |Etot| over the run, so a force off by 0.1% of its scale moves Etot by
# ~1e-4, the bound.
CUBE_DRIFT_BOUND = 1e-4
# |sum m v| bound at both ends.  The initial velocities have zero mean in
# f64 and the periodic force has no net self-force, so the CPU run gave
# 1.7e-11 -> 4.7e-11; an f32 sum of 2^22 terms errs by at most ~60 eps sum
# m|v_c| ~ 3e-7 (sum m|v| = 0.16), and a net force of 1e-4 of the field's
# scale would add ~1e-6 over the run.
CUBE_MOM_BOUND = 1e-6
# K7 on the coefficients c = -norm S (k = 0 folds to 0, so the total mass,
# ~sqrt(N) times any other entry of S, cannot hide errors), max|dc| /
# max|c|: f32 sums of 2^22 terms in another order err by ~1e-7 of the
# total mass; the uniform sample's largest |c| is shot noise, ~1/sqrt(N)
# times norm, so its relative error is ~100x the perturbed sample's, whose
# largest |c| is the density wave's A/2 norm.
CUBE_COEF_RTOL = {"uniform": 1e-4, "perturbed": 5e-6}
# K8: acc and pot within this share of their largest values.  The kernel's
# phases (sincospif and angle addition) and the plain version's (cos/sin
# of the rounded angle 2 pi k u, up to 38 rad) each err by ~1e-6 of a
# term, and the sums over 1183 lattice points add ~1e-6 more.
CUBE_FORCE_RTOL = 2e-5
# Poisson check of the perturbed sample (density 1 + A cos(2 pi x)):
# tests/test_cube_force.py holds Phi - mean to -A cos(2 pi x)/pi at atol
# 6e-3 and the plain torch port's test holds a_x to -2 A sin(2 pi x) at
# atol 0.1, both at 200,000 particles; both are shot noise, which falls as
# 1/sqrt(N), so at 2^22 particles the bounds are scaled by
# sqrt(200,000 / 2^22) = 0.218.
CUBE_PERT_AMP = 0.5
CUBE_POISSON_POT_ATOL = 6e-3 * (200_000 / CUBE_N) ** 0.5
CUBE_POISSON_ACC_ATOL = 0.1 * (200_000 / CUBE_N) ** 0.5

# The slab path (exp_tpu_torch/bench_slab.py: nmax 4 x 4 x 6, numz 401,
# nzc 126 'spline', the isothermal sheet of 2^20 particles, dt=1e-3).
SLAB_STEPS = 50
SLAB_OUTSIDE_N = 65_536
# Gates of the 50 slab steps.  The same run through the plain versions on a
# CPU (python -m exp_tpu_torch.bench_slab kdk --device cpu) gave |dEtot/Etot|
# 9.5e-8, a change of (sum m v_x, sum m v_y) of 2.4e-10 (its value, 6e-5,
# is the draw's shot noise) and |d z_rms / z_rms| 7.0e-4 (the sheet is an
# equilibrium).  Energy: f32 sums of 2^20 terms in another order move each
# end by up to ~eps log2 N ~ 1.2e-6 of Etot; 1e-5 leaves room for that.
# Momentum: the same sum order at both ends, so rounding largely cancels in
# the change; 1e-8 fails a net horizontal force of 2e-7 over the run's 0.05
# time units.  Thickness: the vertical period is ~0.25, so a vertical force
# off by 0.6% moves z_rms by ~2e-3 in 0.05 time units.
SLAB_DRIFT_BOUND = 1e-5
SLAB_MOM_BOUND = 1e-8
SLAB_THICKNESS_BOUND = 2e-3
# K9: G over k != 0 (shot noise of the uniform (x, y), ~1/sqrt(N) of the
# k = 0 row) and the k = 0 row (the sheet's mass profile), each max|dG| over
# its own largest |G|, and the same for the coefficients: f32 sums of 2^20
# terms in another order, with the kernel's phases by sincospif and angle
# addition against the plain version's cos/sin of the rounded angle
# (~1e-6 a term).
SLAB_COEF_RTOL = 1e-4
SLAB_COEF0_RTOL = 1e-5
# K10: acc and pot within this share of their largest values (the phases as
# for K9; sums over 41 wavevectors).
SLAB_FORCE_RTOL = 2e-5
# The sheet's mean field (tests/test_slab.py:38-50): g_z against
# -2 pi tanh(z/h) within rtol 0.06, the horizontal force under 5% of
# max|g_z|.
SLAB_FIELD_RTOL = 0.06
SLAB_FIELD_XY = 0.05

# The sphere-settings path: the sphere path's halo under SphereSL's other
# pallas settings, name: (lmax, pallas_harmonics, pallas_interp, the two
# kernel wrappers the setting launches).
VARIANTS = {
    "recurrence": (4, "recurrence", "spline",
                   ("sphere_coef_rec", "sphere_accel")),
    "poly": (4, "poly", "spline", ("sphere_coef", "sphere_accel_poly")),
    "hat": (4, "auto", "hat", ("sphere_coef", "sphere_accel")),
    "hat+recurrence": (4, "recurrence", "hat",
                       ("sphere_coef_rec", "sphere_accel")),
    "hat+poly": (4, "poly", "hat", ("sphere_coef", "sphere_accel_poly")),
    "lmax10": (10, "auto", "spline", ("sphere_coef_rec", "sphere_accel")),
}
# |dEtot/Etot| bound over the 50 steps of each setting.  The same runs
# through the plain versions on a CPU (python -m exp_tpu_torch.bench_sphere
# kdk --device cpu with --harmonics / --interp / --lmax as the setting, the
# full 2^20 particles) gave 5.4e-7 (recurrence), 7.2e-7 (poly), 1.8e-7
# (hat, hat + recurrence, hat + poly) and 7.2e-7 (lmax 10); like the main
# path's 8.1e-7 these are at the rounding level of the f32 energy sums
# over 2^20 particles (eps log2 N ~ 2.4e-6), so the main path's bound,
# 1e-5, holds each of them with room for sums in another order.
VARIANT_DRIFT_BOUND = 1e-5
# hat nodes (of numr_c = 512) the agreement inputs put rows exactly on
HAT_NODES = [20, 90, 140, 200, 300, 510]

# The composite path (exp_tpu_torch/bench_composite.py, bench_suite.py:
# 211-314): 786,432 halo + 262,144 disk particles from the DiskHalo ICs,
# M=4, dtime 2e-3; big steps with relevels after the warmup, and big steps
# timed.
COMP_NBIG = 10
COMP_TIMED = 5
# |dEtot/Etot| bound from the warmup's last big step to the last of the
# COMP_NBIG.  The same run through the plain versions on a CPU (python -m
# exp_tpu_torch.bench_composite kdk --device cpu, the full 1,048,576
# particles) gave 6.50e-5: the integrator's own drift (the coarse levels'
# long steps, the interpolated coefficient tableau, particles that change
# level).  Sums taken in another order on the card move each end's Etot by
# about eps log2 N (|KE| + |PE|) / |Etot| ~ 1e-5 of it and send particles
# near a level boundary to the other level, which changes the drift by a
# part of itself, not a multiple; 2e-4 fails a run whose force or tableau
# breaks conservation by twice the CPU's drift.
COMP_DRIFT_BOUND = 2e-4
# No level's population may move by more than this share of its component
# from the start of the run to its end (tests/test_diskhalo.py:165-170's
# gate, there over 4 big steps at M=2); the largest move at any relevel is
# reported.
COMP_LEVEL_MOVE = 0.02
# KS: calls a size queued behind a spin kernel, and launches in a row (5x
# below 2^16 rows), each timed by CUDA events; CM3: calls a level's bucket
KS_REPS = 20
CM3_LEVEL_REPS = 10

# The phase-stream probe P1 (exp_tpu_torch/probe_slab_phasestream.py, the
# JAX probe's shapes: nmax 4, nzc 126 'spline', 2^20 particles).
P1_N = 1 << 20
P1_REPS = 30
# P1 against its plain version on the same bf16 table: G within P1_RTOL of
# max|G| (the k = 0 row, the sheet's z profile: f32 sums of 2^20 terms in
# another order) and the k != 0 rows within P1_KN_RTOL of their own largest
# value (shot noise, ~1/sqrt(N) of the k = 0 row), K9's gates (SL2).
P1_RTOL = 1e-5
P1_KN_RTOL = 1e-4

# The YAML driver (exp_tpu_torch/nbody/simulation.py, run.py) on the
# flagship's run config (R1-R2: the composite path's settings, CM1's ICs as
# PSP body files) and on the sphere path's sample as an ascii body file
# (R3).  R2 runs DRIVER_NBIG big steps; the driver adds no physics, so its
# state must equal the bare runner's bit for bit.  R3 runs STEPS
# single-rate steps under phase 5's gates.  R4 times DRIVER_TIMED big
# steps and DRIVER_TIMED_STEPS steps of each, beside the bare runner and
# make_kdk_step, on the host clock.
DRIVER_NBIG = 10
# |dEtot/Etot| bound over R2's OUTLOG, row 0 (t = 0, init_state) to row
# DRIVER_NBIG.  CM2's window starts after the warmup; this one holds the
# first big steps from the ICs, where particles settle into their levels.
# The same window through the plain versions on a CPU (python -m
# exp_tpu_torch.bench_composite kdk --device cpu --max-warmup 0, the full
# 1,048,576 particles) gave 2.017e-4; as for CM2, the bound is three times
# the CPU's drift, failing a run whose force or tableau breaks
# conservation by twice as much again.
DRIVER_DRIFT_BOUND = 6e-4
DRIVER_TIMED = 5
DRIVER_TIMED_STEPS = 20

# The driver's extras (exp_tpu_torch/bench_extras.py's E1-E3 configs).
# E1: the flagship with the disk's EJ: 2 (nEJkeep 256, EJwindow 16,
# nEJaccel 8) and the halo's npca 5 (nsamples 8, Hall), DRIVER_NBIG big
# steps from t = 0; E2: the sphere run config with NO_L1 and the userbar,
# STEPS steps; E3: the flagship with the halo's self_consistent: false.
# |dEtot/Etot| bounds over OUTLOG's rows 0..DRIVER_NBIG, E1's on the global
# columns, E3's on the disk's own (the halo is rigid): three times the drift
# of the same config through the plain versions on a CPU (python -m
# exp_tpu_torch.bench_extras kdk --case E1|E3 --device cpu --threads 3 on
# the card's host), the rule of R2 and CM2.  E1's CPU run drifted 1.056e-2:
# from the 8th big step on, nEJaccel's frame correction subtracts the
# estimated acceleration of the disk's tracked center (2x the quadratic
# coefficient of 8 centroids 2e-3 apart, ~170 in these units: the top-256
# centroid moves by ~1e-3 between updates) from every disk particle, which
# does work on the disk.  exp_tpu's driver does the same: on a reduced copy
# of E1's extras (tests/test_torch_extras_frame.py::test_e1_extras_reduced,
# f64 on the CPU) both drivers drift 9.086e-2 with nEJaccel and 1.288e-3
# without, the frame acceleration after every big step equal.  E3's CPU
# run: the disk's own Etot drifted 3.314e-4.
E1_DRIFT_BOUND = 3.2e-2
E3_DRIFT_BOUND = 1.0e-3
# E1's tracked disk center against its NumPy f64 recomputation from the
# card's synced state (the same top-256 centroid and window regression), in
# the disk's length units (acyl = 0.01): the card ranks f32 energies, so one
# particle may trade places at the 256th rank (the set's rows lie within
# ~1e-3 of the center: ~4e-6 on the centroid, ~0.4 of it on the regression
# at the window's end), and the f32 centroid sum errs by ~256 eps |x| ~
# 2e-8; 2e-6 holds one such trade and fails a wrong set or a wrong
# regression.
E1_CENTER_ATOL = 2e-6
# E1's Hall smoothing, two comparisons, each max|d| / max|value| on the
# card's synced state.  (a) The halo's set the driver assembled in the last
# big step (K1 on each level's bucket at the final positions, then the Hall
# weights w <= 1 then in use) against those weights on K1's plain version's
# coefficients c0 of all rows: each bucket's K1 errs by COEF_RTOL of its own
# max|c_l| <= max|c|, and the sum over the levels by the same order.  (b)
# The driver's next Hall update through K1 against the same update through
# K1's plain version, both applied to c0: each subsample's coefficients err
# by COEF_RTOL of max|c|, and the smoothed value w * s moves by at most ~2
# of that (|d(w s)| <= |ds| (1 + 1/2) for w = s^2 / (s^2 + var), with var's
# own error of the same order).
E1_HALL_RTOL = 4 * COEF_RTOL
# E2's bar acceleration at E2_BAR_N of the bodies on the card (f32, torch.
# autograd) against the same formula in f64 on the CPU, max|da| / max|a|:
# ~30 f32 operations a term, each rounding at 6e-8.
E2_BAR_N = 4096
E2_BAR_RTOL = 1e-5


# The remaining forces (exp_tpu_torch/bench_forces.py's run configs).
# MF1: hernq on phase 5's sample and CBsphere on a Plummer sample (a 1,
# M 1) of 2^20, lmax 4, nmax 10, numr 2000, rmax 50, pallas, through the
# single-rate driver for STEPS steps of DT; MF2: twocenter on
# tests/test_twocenter.py:39's lopsided system at 2^20, single-rate for
# TC_STEPS steps and at multistep 2 for TC_NBIG big steps; MF3b: phase 5's
# halo and a one-body bh under direct at multistep 4, BH_NBIG big steps.
# Each K1 / K2 check holds phase 4's tolerances (COEF_RTOL, ACC_*, POT_*).
# tests/test_more_forces.py's bar: each analytic basis reproduces its own
# halo's M(<r)/r^2 on 12 radii from 0.1 to 10 to a median of 3%.
MF1_BAR = 0.03
# MF1's |dEtot/Etot| over OUTLOG's 51 rows: three times the drift of the
# same config through the plain versions on a CPU (python -m
# exp_tpu_torch.bench_forces ref --case hernq|CBsphere --device cpu on the
# card's host), the rule of R2 and CM2, and at least DRIFT_BOUND: a drift
# at the rounding level of the f32 energy sums (phase 5's reasoning) may
# differ by that much between the two orders of summation.  2T/VC at both
# ends within MF1_VIRIAL_ATOL of the CPU run's: the same f32 sums of the
# same 2^20 bodies (~eps log2 N ~ 2.4e-6 relative) after 50 steps that
# separate the two runs' orbits by rounding only.  The CPU runs (on the
# card's host, 2 threads each): hernq drifted 5.59e-6 (2T/VC 0.98824 ->
# 0.98818), CBsphere 2.04e-7 (1.00002 -> 0.99999).
MF1_CPU = {"hernq": {"dE_rel": 5.586144669652306e-06, "virial0": 0.9882393,
                     "virial1": 0.98817841},
           "CBsphere": {"dE_rel": 2.03991765341778e-07, "virial0": 1.0000214,
                        "virial1": 0.99999514}}
MF1_VIRIAL_ATOL = 1e-4
# bessel (the gather backend, f32) on phase 5's sample scaled into its
# rmax 1, against the same force in f64 on the card, at 65,536 of the
# bodies: max|da| / max|a|, max|dpot| / max|pot| and the median of each
# body's |da| / |a|.  The largest error is the f32 evaluation at the body
# nearest the center (r = 2.6e-5 in the basis' units), where the angular
# terms go as 1/r: the f64 coefficients' field in f32 errs as much there
# (1.8e-3 on the card), and exp_tpu's f32 gather backend gives the port's
# error to four digits at that body (3.09e-3 on a CPU, with a 2^18
# subsample's coefficients).  The bounds hold that error with room for
# the coefficients' f32 sums (9e-4 of max|c|); the median holds the bulk.
BESSEL_N = 65_536
BESSEL_ACC_RTOL = 5e-3
BESSEL_POT_RTOL = 5e-4
BESSEL_MEDIAN_RTOL = 1e-4
# MF2's accuracy bar, tests/test_twocenter.py:39's: the median relative
# force error against the direct sum (DirectForce, plummer, eps 1e-3, f64,
# all 2^20 sources) on 150 points about the cusp and 150 in the envelope:
# twocenter < 0.3 x one COM-centered expansion in the cusp, and < 0.1;
# < 1.2 x in the envelope.
TC_CUSP_RATIO, TC_CUSP_MAX, TC_ENV_RATIO = 0.3, 0.1, 1.2
# MF3a: DirectForce at DIRECT_N bodies (doc/direct_energy.json's direct-sum
# subsample) in f32 against f64 on the card, each source model, max|da| /
# max|a| and max|dpot| / max|pot|, set before the first run: a term rounds
# ~20 f32 operations (~1e-6 relative), a body sums 65,536 terms in four
# chunks (a tree sum, ~log2(16384) eps ~ 1e-6 of the sum of |terms|); the
# potential's terms share a sign, the acceleration's cancel by up to ~10x
# at the center.
DIRECT_N = 65_536
DIRECT_ACC_RTOL = 1e-4
DIRECT_POT_RTOL = 1e-5
# MF3b's halo |dEtot/Etot| over OUTLOG's rows (the halo's own columns):
# three times the CPU run's drift (python -m exp_tpu_torch.bench_forces ref
# --case bh --device cpu, on the card's host: 6.69e-4), and at least
# DRIFT_BOUND, as for MF1.
MF3B_CPU = {"dE_rel": 0.0006694166964610148}
# MF4: ShellsForce (rmax 10, 256 bins) and HaloBulgeForce (the halo's
# model) on phase 5's sample at 2^20, on the card and on the CPU in the
# same call, at the sample's first MF4_PTS bodies within 0.05 <= r <= 9.5.
# The card against the CPU: max|da| / max|a| <= MF4_RTOL (the bins' f32
# sums in another order, ~sqrt(4096) eps a bin).  Against the model's
# M(<r)/r^2: the card's median |a_R / (M/r^2) - 1| within 1.5 times the
# CPU's plus 1e-6 (the binning and shot noise are the same inputs' on
# both).
MF4_PTS = 4096
MF4_RTOL = 2e-5
MF_TIMED_STEPS = 10


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def edge_rows(n_bulk):
    """The origin, both poles, r > rmax, r < rmin and a zero-mass row."""
    import numpy as np

    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.7], [0.0, 0.0, -1.3],
                  [30.0, 0.0, 0.0], [0.0, -25.0, 10.0], [3e-4, 0.0, 1e-4],
                  [0.3, 0.2, 0.1]])
    m = np.full(7, 1.0 / n_bulk)
    m[-1] = 0.0
    return x, m


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` launches, by CUDA events,
    after two warm-up calls."""
    import torch

    fn()
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# FP32 operations of one particle's radial weights: the grid position and
# the 3 quadratic-B-spline weights ('spline'), or the cell and the 2 hat
# weights ('hat'); and the nonzero weights it has
WEIGHT_OPS = {"spline": 24, "hat": 12}
NODES = {"spline": 3, "hat": 2}


def k1_work(n, n_in, lmax, nmax, rows, interp="spline"):
    """Bytes and FP32 operations K1 needs on these inputs (an FMA counts
    2).  Per particle: radius, xi map and mask (13), 1/r and u (4), the
    monomials (n_mono - 4 products), the nonzero entries of M . mono (an
    FMA each) and the mass weight (P), the radial weights (WEIGHT_OPS).
    For the n_in particles inside the mass mask, an FMA into each of P rows
    at each of the NODES nonzero weights.  Then the reduction over
    particles is folded into that count, and the contraction with the
    table is P * rows * nmax FMAs."""
    from exp_tpu_torch.ops.solidharm import harmonic_matrix
    from exp_tpu_torch.ops.sphere_kernels import packed_rows

    P = (lmax + 1) ** 2
    n_mono = (lmax + 1) * (lmax + 2) * (lmax + 3) // 6
    nnz = int((harmonic_matrix(lmax, tuple(packed_rows(lmax))) != 0).sum())
    per = 13 + 4 + (n_mono - 4) + 2 * nnz + P + WEIGHT_OPS[interp]
    ops = n * per + n_in * NODES[interp] * P * 2 + P * rows * nmax * 2
    byts = (n * 16 + P * n_mono * 4 + rows * (lmax + 1) * nmax * 4
            + 2 * (lmax + 1) ** 2 * nmax * 4)
    return byts, ops


def k2_work(n, lmax, rows, interp="spline"):
    """Bytes and FP32 operations K2 needs on these inputs (an FMA counts
    2).  Per particle: geometry (15), the pole clamp and P_lm recurrences
    (about 5 per entry), dP_lm (5 per entry), trig rows (6 per m), the
    radial weights (WEIGHT_OPS), the interpolation ('spline': 2P rows x 3
    FMAs; 'hat': P rows x 2 products and a sum, and the cell difference,
    2 products and a sum), the continuation (2 + L), 14 operations per
    packed row of the assembly (plus 6 for m > 0) and the Cartesian step
    (30)."""
    P = (lmax + 1) ** 2
    nlm = (lmax + 1) * (lmax + 2) // 2
    n_m = lmax * (lmax + 1) // 2 * 2             # packed rows with m > 0
    interp_ops = 2 * P * 3 * 2 if interp == "spline" else P * 6
    per = (15 + 5 * nlm + 5 * nlm + 6 * lmax + WEIGHT_OPS[interp]
           + interp_ops + 2 + lmax + 14 * P + 6 * n_m + 30)
    tw = 2 * P if interp == "spline" else P
    byts = n * (12 + 16) + tw * rows * 4 + (lmax + 1) ** 2 * 4
    return byts, n * per


def k3_work(n, n_in, lmax, nmax, rows, interp="spline"):
    """Bytes and FP32 operations K3 needs on these inputs (an FMA counts
    2).  Per particle: r and R (11), cos theta, cos phi, sin phi (3), rs,
    the xi map and the mask (8).  For the n_in particles inside the mass
    mask: the Legendre recurrences (about 5 per entry), the trig rows (6
    per m), w fac P_lm (2 per entry) times trig (1 per packed row), the
    radial weights (WEIGHT_OPS) and an FMA into each of P rows at each of
    the NODES nonzero weights.  Then the contraction with the table, P *
    rows * nmax FMAs.  Bytes: x and mass in, fac and the table once, the
    coefficients out."""
    P = (lmax + 1) ** 2
    nlm = (lmax + 1) * (lmax + 2) // 2
    per_in = (5 * nlm + 6 * lmax + 2 * nlm + P + WEIGHT_OPS[interp]
              + NODES[interp] * P * 2)
    ops = n * 22 + n_in * per_in + P * rows * nmax * 2
    byts = (n * 16 + (lmax + 1) ** 2 * 4 + rows * (lmax + 1) * nmax * 4
            + 2 * (lmax + 1) ** 2 * nmax * 4)
    return byts, ops


def k6_work(n, lmax, rows, Ms, interp="spline"):
    """Bytes and FP32 operations K6 needs on these inputs (an FMA counts
    2).  Per particle: r, rs, the boundary test, the xi map and d xi/dr
    (18), the radial weights (WEIGHT_OPS), the continuation powers (L),
    1/r and u (4), the monomials (n_mono - 4 products); per packed row the
    interpolation of pc and dpc ('spline': 2 x 3 FMAs; 'hat': 6), dpc
    d xi/dr and g, dg (4) and an FMA into each of the 5 sums (10); an FMA
    for each nonzero entry of the [M; Mx; My; Mz] stack Ms (the entries K6
    multiplies); the projection and the
    Cartesian step (25).  Bytes: x in, acc and pot out, twT and Ms once."""
    P = (lmax + 1) ** 2
    n_mono = (lmax + 1) * (lmax + 2) * (lmax + 3) // 6
    nnz = int((Ms != 0).sum())
    interp_ops = 12 if interp == "spline" else 6
    per = (18 + WEIGHT_OPS[interp] + lmax + 4 + (n_mono - 4)
           + P * (interp_ops + 4 + 10) + 2 * nnz + 25)
    tw = 2 * P if interp == "spline" else P
    byts = n * (12 + 16) + tw * rows * 4 + 4 * P * n_mono * 4
    return byts, n * per


def disk_edge_rows(n_bulk):
    """For the disk tables (rmax_grid = 0.2, inner x edge R = 1e-5): the
    origin, the z axis, r > rmax_grid in the plane and off it, |z| at and
    near ymax, R at the inner and outer x edge, and a zero-mass row."""
    import numpy as np

    x = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.05], [0.3, 0.0, 0.0],
                  [0.15, 0.1, 0.12], [0.0, 0.0, 0.25], [0.001, 0.0, 0.1999],
                  [0.002, 0.001, -0.1995], [1e-5, 0.0, 0.0],
                  [0.0, -3e-6, 1e-6], [0.1999, 0.0, 0.0], [0.01, 0.01, 0.0]])
    m = np.full(len(x), 0.05 / n_bulk)
    m[-1] = 0.0
    return x, m


def _cyl_point_ops(mmax, kx):
    """FP32 operations of the per-particle set-up both cylinder kernels
    share: R and r (10), cos/sin phi (2), the x and y maps and clamps (19),
    kx x weights (11 each) and 2 y weights (6 each), the trig rows by angle
    addition (6 per m)."""
    return 10 + 2 + 19 + 11 * kx + 12 + 6 * mmax


def k4_work(n, n_in, mmax, xrows, ncy, kx):
    """Bytes and FP32 operations the function of K4 needs at least on these
    inputs (an FMA counts 2), not the kernel's own arithmetic: the mass
    mask for every particle (1); for the n_in particles with mass inside
    rmax_grid, the set-up (_cyl_point_ops), the 2 kx node weights wx_a wy_b
    once (1 each) and, for each of the 2(M+1) - 1 nonzero trig rows, w trig
    (1) and one FMA into G per node (2 kx nodes x 2).  Bytes: x and mass
    in, G out."""
    T = 2 * (mmax + 1)
    per_in = _cyl_point_ops(mmax, kx) + 2 * kx + (T - 1) * (1 + 2 * kx * 2)
    return n * 16 + xrows * T * ncy * 4, n + n_in * per_in


def k5_work(n, mmax, xrows, ncy, kx):
    """Bytes and FP32 operations the function of K5 needs at least on these
    inputs (an FMA counts 2), not the kernel's own arithmetic: the set-up
    (_cyl_point_ops), the mask and shrink (4), the 2 kx node weights wx_a
    wy_b once (1 each), then per table value one FMA per node (2 kx nodes x
    2) over 6(M+1) values, the assembly (17 per m: pot, F_R, F_z by 2 FMAs
    each and F_phi) and F_phi/R (1), the continuation or the Cartesian step
    (8).  Bytes: x in, acc and pot out, the contracted table once."""
    S = 6 * (mmax + 1)
    SP = (S + 3) // 4 * 4
    per = (_cyl_point_ops(mmax, kx) + 4 + 2 * kx + S * 2 * kx * 2
           + 17 * (mmax + 1) + 9)
    return n * (12 + 16) + xrows * ncy * SP * 4, n * per


def cube_edge_rows(n_bulk):
    """The wrap's edges (x = 1.0, -1e-7, -2.75, 3.25, 1000.3 on each axis)
    and a zero-mass row, last."""
    import numpy as np

    x = np.array([[1.0, -1e-7, -2.75], [3.25, 1000.3, 0.5],
                  [-1e-7, 1.0, 1000.3], [-2.75, 3.25, 1.0],
                  [1000.3, -2.75, -1e-7], [0.3, 0.2, 0.1]])
    m = np.full(len(x), 1.0 / n_bulk)
    m[-1] = 0.0
    return x, m


def _cube_phase_ops(nmaxx, nmaxy, nmaxz):
    """FP32 operations of one particle's phase rows, shared by K7 and K8:
    the wraps (3), three sincos (2 each) and the powers of each row by
    angle addition (a complex product, 6, per k > 0)."""
    return 3 + 6 + 6 * (nmaxx + nmaxy + nmaxz)


def _cube_half_pairs(nmaxx, nmaxy):
    """(pairs, pairs with kx > 0) of the half (kx, ky) lattice: kx = 0 with
    ky >= 0, then kx > 0 with every ky ((kx ky + 1) / 2 in all)."""
    ky = 2 * nmaxy + 1
    return (nmaxy + 1) + nmaxx * ky, nmaxx * ky


def k7_work(n, nmaxx, nmaxy, nmaxz):
    """(bytes, FP32 operations, the operations of the folded product among
    them) that the function of K7 needs at least (an FMA counts 2).

    A real mass gives S(-k) = conj S(k), so only the half (kx, ky) lattice
    (_cube_half_pairs) needs sums, and the kz axis folds into cosines and
    sines: with XY = e_x^a e_y^b, U = sum m c_q XY and V = sum m s_q XY give
    S(a, b, +-q) = U -+ i V.  So per particle: the phase rows
    (_cube_phase_ops), m c_q and m s_q (2 nmaxz products), XY for the pairs
    with kx > 0 (a complex product, 6, each) and the folded product, a real
    times a complex multiply-add (4) for each pair and each of the 2 nmaxz +
    1 columns; per lattice point, once, the combine U -+ i V (2).  The
    einsum path's count, a complex multiply-add at each of the (K + 1) / 2
    points, overstates this by ~2x.  Bytes: x and mass in, the complex f32
    lattice out."""
    kz = 2 * nmaxz + 1
    K = (2 * nmaxx + 1) * (2 * nmaxy + 1) * kz
    pairs, outer = _cube_half_pairs(nmaxx, nmaxy)
    gemm = 4 * pairs * kz
    per = _cube_phase_ops(nmaxx, nmaxy, nmaxz) + 2 * nmaxz + 6 * outer + gemm
    return n * 16 + K * 8, n * per + 2 * K, n * gemm


def k8_work(n, nmaxx, nmaxy, nmaxz):
    """(bytes, FP32 operations, the operations of the folded product among
    them) that the function of K8 needs at least (an FMA counts 2).

    The outputs are real, so the terms k and -k fold into one, and the kz
    axis folds into cosines and sines: per (kx, ky) row of the half lattice
    (_cube_half_pairs), t = sum_q T_q e^{2 pi i q uz} and t_z (2 pi q T_q
    inside) are real combinations of the 2 nmaxz + 1 phases [c_0..c_nz,
    s_1..s_nz], whose coefficients fold from the table once a launch (not
    counted: a few thousand operations).  Per particle: the phase rows
    (_cube_phase_ops); the folded product, an FMA for each of the 4 real
    columns (Re, Im of t and t_z) of each row and each phase; per row t e
    (6), pot (1), a_z from Im t_z e (3 + 1), and for rows with kx > 0, e =
    e_x^a e_y^b (6) and a_x (2), for rows with ky != 0, a_y (2).  The
    einsum path's count, two complex multiply-adds at each of the (K + 1) /
    2 points, overstates this by ~2x.  Bytes: x and the table in, acc and
    pot out."""
    kz = 2 * nmaxz + 1
    rows, outer = _cube_half_pairs(nmaxx, nmaxy)
    gemm = 8 * rows * kz
    epi = 11 * rows + 8 * outer + 2 * (rows - (nmaxx + 1))
    per = _cube_phase_ops(nmaxx, nmaxy, nmaxz) + gemm + epi
    tab = (nmaxx + 1) * (2 * nmaxy + 1) * kz * 8
    return n * (12 + 16) + tab, n * per, n * gemm


def bound_ms(byts, ops):
    t_b = byts / HBM_BYTES_PER_S
    t_o = ops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def tc_bound_ms(byts, ops, gemm):
    """The bound of the split-TF32 route (K7, K8): the larger of the
    product's `gemm` operations as three TF32 passes on the tensor cores,
    the rest of the operations in FP32 on the CUDA cores, and bytes / HBM
    rate.  The two units run at the same time, so the times are not added."""
    t_b = byts / HBM_BYTES_PER_S
    t_o = max(3 * gemm / TF32_FLOP_PER_S, (ops - gemm) / FP32_FLOP_PER_S)
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def disk_path(dev):
    """Phases D1-D4 on the card; returns the kernels-line rows of K4, K5 and
    the EOF tables (the composite's disk uses them too)."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_disk import (bench_disk, disk_force,
                                          disk_sample, disk_tables)
    from exp_tpu_torch.bench_sphere import kdk_run
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import sphere_kernels as sk

    # D1. the EOF tables on the host, the force on the card
    t0 = time.perf_counter()
    tables = disk_tables()
    print(f"D1 disk EOF tables (mmax={tables.mmax}, nmax={tables.nmax}, "
          f"{tables.numx} x {tables.numy}): "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    force = disk_force(tables, dev)
    prm = force._kernel_params()

    # D2. K4 and K5 against their plain versions at the path's shapes
    xb, vb, mb = disk_sample(N)
    ex, em = disk_edge_rows(N)
    x = torch.tensor(np.concatenate([xb, ex]), dtype=torch.float32,
                     device=dev)
    m = torch.tensor(np.concatenate([mb, em]), dtype=torch.float32,
                     device=dev)
    G = ck.cyl_coef(x, m, prm)
    G0 = ck.cyl_coef_plain(x, m, prm)
    c = ck.contract_coef_output(G, force.tab3)
    c0 = ck.contract_coef_output(G0, force.tab3)
    torch.cuda.synchronize()
    k4_err = float((G - G0).abs().max())
    g_rel = k4_err / float(G0.abs().max())
    c_rel = float((c - c0).abs().max()) / float(c0.abs().max())
    zero = float(ck.cyl_coef(x[-1:], m[-1:], prm).abs().max())
    print(f"D2 K4 vs plain: max|dG| = {k4_err:.3e}, max|dG|/max|G| = "
          f"{g_rel:.3e}, coefficients {c_rel:.3e} (tolerance "
          f"{CYL_COEF_RTOL:.0e}); zero-mass row gives {zero}", flush=True)
    if not (g_rel <= CYL_COEF_RTOL and c_rel <= CYL_COEF_RTOL
            and zero == 0.0):
        raise AssertionError(f"K4 disagrees with its plain version: G "
                             f"{g_rel}, coefficients {c_rel}, zero {zero}")

    Ct = ck.contract_coef_tables(c0, force.tab3, prm.xrows, prm.ncy)
    a, p = ck.cyl_accel(x, Ct, prm)
    a0, p0 = ck.cyl_accel_plain(x, Ct, prm)
    torch.cuda.synchronize()
    da, dp = (a - a0).abs(), (p - p0).abs()
    k5_err = max(float(da.max()), float(dp.max()))
    amax, pmax = float(a0.abs().max()), float(p0.abs().max())
    ok_a = da <= CYL_ACC_ATOL_REL * amax + CYL_ACC_RTOL * a0.abs()
    ok_p = dp <= CYL_POT_ATOL_REL * pmax + CYL_POT_RTOL * p0.abs()
    edge = slice(N, None)
    print(f"D2 K5 vs plain: max|da| = {float(da.max()):.3e} (|a| up to "
          f"{amax:.3e}), max|dpot| = {float(dp.max()):.3e} (|pot| up to "
          f"{pmax:.3e}); edge rows max|da| = {float(da[edge].max()):.3e}, "
          f"max|dpot| = {float(dp[edge].max()):.3e}; tolerance acc rtol "
          f"{CYL_ACC_RTOL:.0e} atol {CYL_ACC_ATOL_REL:.0e} max|a|, pot rtol "
          f"{CYL_POT_RTOL:.0e} atol {CYL_POT_ATOL_REL:.0e} max|pot|",
          flush=True)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    if not (finite and bool(ok_a.all()) and bool(ok_p.all())):
        bad = int(torch.argmin(ok_a.all(dim=1).int() * ok_p.int()))
        raise AssertionError(
            f"K5 disagrees with its plain version (finite={finite}); first "
            f"bad row {bad} at {x[bad].tolist()}: acc {a[bad].tolist()} vs "
            f"{a0[bad].tolist()}, pot {float(p[bad])} vs {float(p0[bad])}")

    # D3. the disk path: init + DISK_STEPS KDK steps of the bench's sample
    sk.reset_launch_counts()
    ck.reset_launch_counts()
    run = kdk_run(force, xb, vb, mb, steps=DISK_STEPS, dt=DISK_DT,
                  device=dev)
    torch.cuda.synchronize()
    launches = {**sk.launch_counts, **ck.launch_counts}
    print("D3 disk path: " + json.dumps({**run, "launches": launches}),
          flush=True)
    if not run["finite"]:
        raise AssertionError("non-finite state after the disk KDK run")
    for name in ck.launch_counts:
        if launches[name] != DISK_STEPS + 1:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the disk path, expected "
                                 f"{DISK_STEPS + 1}")
    if not run["dE_rel"] < DISK_DRIFT_BOUND:
        raise AssertionError(f"disk |dEtot/Etot| = {run['dE_rel']} over "
                             f"{DISK_STEPS} steps exceeds {DISK_DRIFT_BOUND}")
    if not run["dLz_rel"] < DISK_LZ_BOUND:
        raise AssertionError(f"disk |dLz/Lz| = {run['dLz_rel']} over "
                             f"{DISK_STEPS} steps exceeds {DISK_LZ_BOUND}")

    # D4. timing
    bench = bench_disk(n=N, reps=30, tables=tables, device=dev)
    print("D4 disk step: " + json.dumps(bench), flush=True)
    kx = 3 if prm.interp == "spline" else 2
    r = x.norm(dim=1)
    n_in = int(((r <= prm.rmax_grid) & (m > 0)).sum())
    rows = []
    for name, src, line, fn, plain, err, (byts, ops) in (
            ("cyl_coef", "exp_tpu_torch/csrc/cyl_coef.cu",
             "exp_tpu/ops/pallas_cylinder.py:164",
             lambda: ck.cyl_coef(x, m, prm),
             lambda: ck.cyl_coef_plain(x, m, prm), k4_err,
             k4_work(x.shape[0], n_in, prm.mmax, prm.xrows, prm.ncy, kx)),
            ("cyl_accel", "exp_tpu_torch/csrc/cyl_accel.cu",
             "exp_tpu/ops/pallas_cylinder.py:257",
             lambda: ck.cyl_accel(x, Ct, prm),
             lambda: ck.cyl_accel_plain(x, Ct, prm), k5_err,
             k5_work(x.shape[0], prm.mmax, prm.xrows, prm.ncy, kx))):
        bms, by = bound_ms(byts, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[name], "max_abs_err": err,
            "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "bytes": byts, "operations": ops})
    return rows, tables


def _cube_state(force, x, v, m, steps, dev):
    """init + `steps` KDK steps at the cube's dt; the final state and
    coefficients."""
    from exp_tpu_torch.bench_cube import DT
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step

    ps = ParticleSystem.from_arrays(x, v, m, device=dev)
    ps, coef, _ = init_force_state(force, ps)
    step = make_kdk_step(force, DT)
    for _ in range(steps):
        ps, coef, _ = step(ps)
    return ps, coef


def cube_path(dev):
    """Phases C1-C4 on the card; returns the kernels-line rows of K7, K8,
    K11a and K11b."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_cube import (DT, NMAX, bench_cube, cube_force,
                                          cube_sample)
    from exp_tpu_torch.bench_sphere import kdk_run
    from exp_tpu_torch.ops import cube_kernels as ck
    from exp_tpu_torch.ops import cyl_kernels as yk
    from exp_tpu_torch.ops import sphere_kernels as sk

    # C1. the bench's sample, the perturbed sample, the force on the card
    t0 = time.perf_counter()
    samples = {"uniform": cube_sample(CUBE_N),
               "perturbed": cube_sample(CUBE_N, perturbed=True)}
    print(f"C1 cube samples of {CUBE_N}: {time.perf_counter() - t0:.1f} s "
          "on the host", flush=True)
    force = cube_force(dev)
    force_v1 = cube_force(dev, pallas_version=1)
    prm = force._kernel_params()
    ex, em = cube_edge_rows(CUBE_N)

    # C2. K7 and K8 against their plain versions, on both samples + edges
    inputs, errs = {}, {"cube_coef": 0.0, "cube_accel": 0.0}
    for name, (xs, _, ms) in samples.items():
        x = torch.tensor(np.concatenate([xs, ex]), dtype=torch.float32,
                         device=dev)
        m = torch.tensor(np.concatenate([ms, em]), dtype=torch.float32,
                         device=dev)
        inputs[name] = (x, m)
        S = ck.cube_coef(x, m, prm)
        S0 = ck.cube_coef_plain(x, m, prm)
        c, c0 = -S * force.norm, -S0 * force.norm
        torch.cuda.synchronize()
        dS = float((S - S0).abs().max())
        errs["cube_coef"] = max(errs["cube_coef"], dS)
        c_rel = float((c - c0).abs().max()) / float(c0.abs().max())
        herm = bool(torch.equal(S, S.flip(0, 1, 2).conj()))
        again = bool(torch.equal(S, ck.cube_coef(x, m, prm)))
        zero = float(ck.cube_coef(x[-1:], m[-1:], prm).abs().max())
        print(f"C2 {name} K7 vs plain: max|dS| = {dS:.3e}, S(0) = "
              f"{float(S[NMAX, NMAX, NMAX].real):.7f}, max|dc|/max|c| = "
              f"{c_rel:.3e} (tolerance {CUBE_COEF_RTOL[name]:.0e}); "
              f"Hermitian {herm}, repeatable {again}; zero-mass row gives "
              f"{zero}", flush=True)
        if not (c_rel <= CUBE_COEF_RTOL[name] and herm and again
                and zero == 0.0):
            raise AssertionError(f"K7 disagrees with its plain version on "
                                 f"the {name} sample")

        b = c0 * force.norm
        tab = ck.cube_force_table(b, prm)
        a, p = ck.cube_accel(x, tab, prm)
        a0, p0 = ck.cube_accel_plain(x, tab, prm)
        torch.cuda.synchronize()
        da, dp = (a - a0).abs(), (p - p0).abs()
        errs["cube_accel"] = max(errs["cube_accel"], float(da.max()),
                                 float(dp.max()))
        amax, pmax = float(a0.abs().max()), float(p0.abs().max())
        edge = slice(CUBE_N, None)
        print(f"C2 {name} K8 vs plain: max|da| = {float(da.max()):.3e} (|a| "
              f"up to {amax:.3e}), max|dpot| = {float(dp.max()):.3e} (|pot| "
              f"up to {pmax:.3e}); edge rows max|da| = "
              f"{float(da[edge].max()):.3e}, max|dpot| = "
              f"{float(dp[edge].max()):.3e}; tolerance {CUBE_FORCE_RTOL:.0e} "
              "of each largest value", flush=True)
        finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
        if not (finite and float(da.max()) <= CUBE_FORCE_RTOL * amax
                and float(dp.max()) <= CUBE_FORCE_RTOL * pmax):
            raise AssertionError(f"K8 disagrees with its plain version on "
                                 f"the {name} sample (finite={finite})")

        # the v1 entries: the same kernels given the same b
        c1 = force_v1.coefficients(x, m)
        a1, p1 = force_v1.acceleration(c1, x)
        c2 = force.coefficients(x, m)
        a2, p2 = force.acceleration(c2, x)
        Rr, Ri = ck.pack_force_matrix(b, NMAX, NMAX, NMAX)
        av, pv = ck.cube_accel_v1(x, Rr, Ri, prm)
        same = (torch.equal(c1, c2) and torch.equal(a1, a2)
                and torch.equal(p1, p2) and torch.equal(av, a)
                and torch.equal(pv, p))
        print(f"C2 {name} pallas_version 1 equals version 2: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"the v1 force differs from the v2 force "
                                 f"on the {name} sample")

    x, m = inputs["perturbed"]
    xt = np.linspace(0.05, 0.95, 10)
    pts = torch.tensor(np.stack([xt, np.full_like(xt, 0.5),
                                 np.full_like(xt, 0.5)], -1),
                       dtype=torch.float32, device=dev)
    acc, pot = force.acceleration(force.coefficients(x, m), pts)
    pot = pot.double().cpu().numpy()
    want = -CUBE_PERT_AMP * np.cos(2 * np.pi * xt) / np.pi
    dpot = float(np.abs(pot - pot.mean() - (want - want.mean())).max())
    dax = float(np.abs(acc[:, 0].double().cpu().numpy()
                       + 2 * CUBE_PERT_AMP * np.sin(2 * np.pi * xt)).max())
    print(f"C2 Poisson (perturbed sample): max|dPhi| = {dpot:.3e} (bound "
          f"{CUBE_POISSON_POT_ATOL:.3e}), max|da_x| = {dax:.3e} (bound "
          f"{CUBE_POISSON_ACC_ATOL:.3e})", flush=True)
    if not (dpot <= CUBE_POISSON_POT_ATOL and dax <= CUBE_POISSON_ACC_ATOL):
        raise AssertionError("the cube force misses the Poisson solution of "
                             "the perturbed sample")

    # C3. the cube path: init + CUBE_STEPS KDK steps of the perturbed sample
    xp, vp, mp = samples["perturbed"]
    for mod in (sk, yk, ck):
        mod.reset_launch_counts()
    run = kdk_run(force, xp, vp, mp, steps=CUBE_STEPS, dt=DT, device=dev)
    torch.cuda.synchronize()
    launches = {**sk.launch_counts, **yk.launch_counts, **ck.launch_counts}
    print("C3 cube path: " + json.dumps({**run, "launches": launches}),
          flush=True)
    if not run["finite"]:
        raise AssertionError("non-finite state after the cube KDK run")
    for name in ck.launch_counts:
        if launches[name] != CUBE_STEPS + 1:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the cube path, expected "
                                 f"{CUBE_STEPS + 1}")
    if not run["dE_rel"] < CUBE_DRIFT_BOUND:
        raise AssertionError(f"cube |dEtot/Etot| = {run['dE_rel']} over "
                             f"{CUBE_STEPS} steps exceeds {CUBE_DRIFT_BOUND}")
    if not (run["P0"] < CUBE_MOM_BOUND and run["P1"] < CUBE_MOM_BOUND):
        raise AssertionError(f"cube |sum m v| = {run['P0']} -> {run['P1']} "
                             f"exceeds {CUBE_MOM_BOUND}")

    # the pallas_version 1 path (K11a, K11b): the same state bit for bit
    s2, c2 = _cube_state(force, xp, vp, mp, CUBE_V1_STEPS, dev)
    ck.reset_launch_counts()
    s1, c1 = _cube_state(force_v1, xp, vp, mp, CUBE_V1_STEPS, dev)
    torch.cuda.synchronize()
    launches_v1 = dict(ck.launch_counts)
    same = all(torch.equal(a, b) for a, b in ((s1.x, s2.x), (s1.v, s2.v),
                                              (s1.acc, s2.acc),
                                              (s1.pot, s2.pot), (c1, c2)))
    print(f"C3 cube path, pallas_version 1: init + {CUBE_V1_STEPS} steps, "
          f"launches {launches_v1}, state equal to version 2's: {same}",
          flush=True)
    if not same:
        raise AssertionError("the v1 cube path differs from the v2 path")
    for name, cnt in launches_v1.items():
        if cnt != CUBE_V1_STEPS + 1:
            raise AssertionError(f"{name} launched {cnt} times on the v1 "
                                 f"path, expected {CUBE_V1_STEPS + 1}")
    del s1, s2, c1, c2, run

    # C4. timing on the bench's sample
    bench = bench_cube(n=CUBE_N, reps=20, device=dev)
    print("C4 cube step: " + json.dumps(bench), flush=True)
    x, m = inputs["uniform"]
    S0 = ck.cube_coef_plain(x, m, prm)
    b = -S0 * force.norm * force.norm
    tab = ck.cube_force_table(b, prm)
    Rr, Ri = ck.pack_force_matrix(b, NMAX, NMAX, NMAX)
    av, pv = ck.cube_accel_v1(x, Rr, Ri, prm)
    a0, p0 = ck.cube_accel_plain(x, tab, prm)
    err_v1 = max(float((av - a0).abs().max()), float((pv - p0).abs().max()))
    n = x.shape[0]
    w7 = k7_work(n, NMAX, NMAX, NMAX)
    w8 = k8_work(n, NMAX, NMAX, NMAX)
    rows = []
    for name, line, src, fn, plain, err, (byts, ops, gemm), cnt in (
            ("cube_coef", "exp_tpu/ops/pallas_cube.py:332", "cube_coef",
             lambda: ck.cube_coef(x, m, prm),
             lambda: ck.cube_coef_plain(x, m, prm), errs["cube_coef"], w7,
             launches["cube_coef"]),
            ("cube_accel", "exp_tpu/ops/pallas_cube.py:392", "cube_accel",
             lambda: ck.cube_accel(x, tab, prm),
             lambda: ck.cube_accel_plain(x, tab, prm), errs["cube_accel"],
             w8, launches["cube_accel"]),
            ("cube_coef_v1", "exp_tpu/ops/pallas_cube.py:141",
             "cube_coef", lambda: ck.cube_coef(x, m, prm),
             lambda: ck.cube_coef_plain(x, m, prm), errs["cube_coef"], w7,
             launches_v1["cube_coef"]),
            ("cube_accel_v1", "exp_tpu/ops/pallas_cube.py:220",
             "cube_accel", lambda: ck.cube_accel_v1(x, Rr, Ri, prm),
             lambda: ck.cube_accel_plain(
                 x, ck.cube_force_table(ck.v1_matrix_to_b(Rr, Ri, prm), prm),
                 prm), err_v1, w8, launches_v1["cube_accel"])):
        fp32_ms, _ = bound_ms(byts, ops)
        bms, by = tc_bound_ms(byts, ops, gemm)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"exp_tpu_torch/csrc/{src}.cu", "replaces": line,
            "launches": cnt, "max_abs_err": err,
            "ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(plain, 3),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this "
                            "non-uniform Fourier sum from x and mass",
            "bound_route": "split TF32 on the tensor cores (tc_bound_ms)",
            "fp32_bound_ms": fp32_ms, "bytes": byts, "operations": ops,
            "product_operations": gemm})
    return rows


def slab_edge_rows(n_bulk):
    """The wrap's edges (x, y = 1.0, -1e-7, -2.75, 1000.3) paired with z at
    and near the slab's faces (+-zmax, +-zmax (1 +- 1e-3)), beyond them
    (+-0.3, +-1.0), and a zero-mass row, last."""
    import numpy as np

    from exp_tpu_torch.bench_slab import ZMAX

    xy = [1.0, -1e-7, -2.75, 1000.3]
    zs = [ZMAX, -ZMAX, ZMAX * 0.999, ZMAX * 1.001, -ZMAX * 0.999,
          -ZMAX * 1.001, 0.3, -0.3, 1.0, -1.0]
    x = np.array([[xy[i % 4], xy[(i + 1) % 4], z] for i, z in enumerate(zs)]
                 + [[0.3, 0.2, 0.01]])
    m = np.full(len(x), 1.0 / n_bulk)
    m[-1] = 0.0
    return x, m


def _slab_phase_ops(nmaxx, nmaxy):
    """FP32 operations of one particle's phase rows, shared by K9 and K10:
    the two wraps (2), two sincos (2 each) and the powers by angle
    addition (a complex product, 6, per k > 0)."""
    return 2 + 4 + 6 * (nmaxx + nmaxy)


def p1_work(n, n_in, C, zrows, kz, split):
    """Bytes and FP32 operations the function of P1 needs at least on these
    inputs (an FMA counts 2), not the kernel's own arithmetic.  The mass
    mask for every particle (1); for the n_in particles with mass inside
    |z| <= zmax, the grid position (3) and the kz z weights (11 each) times
    w (1 each), with a split table the sum hi + lo of each of the 2C rows
    (1), and one FMA into kz sums of each of the 2C rows.  Bytes: the 2C
    table rows G needs (4C with a split table; the Cr - C padding rows are
    not needed), 2 bytes an entry, z and mass, and G out."""
    A = 2 * C
    rows = 2 * A if split else A
    per_in = 3 + 12 * kz + (A if split else 0) + A * kz * 2
    return n * (2 * rows + 8) + C * zrows * 8, n + n_in * per_in


def k9_work(n, n_in, nmaxx, nmaxy, zrows, kz):
    """Bytes and FP32 operations the function of K9 needs at least on these
    inputs (an FMA counts 2), not the kernel's own arithmetic.  Real
    weights give G(-k, j) = conj G(k, j), so only the H = (C + 1) / 2
    half-lattice wavevectors need sums.  The mass mask for every particle
    (1); for the n_in particles with mass inside |z| <= zmax, the phase
    rows (_slab_phase_ops), the grid position (3) and the kz z weights (11
    each, as _cyl_point_ops counts them) times w (1 each), then for each
    of the H wavevectors e_h = e_x e_y (a complex product, 6) and one
    complex-by-real multiply-add (2 FMAs) into each of its kz sums.  Bytes:
    x and mass in, the complex f32 (C, zrows) G out."""
    C = (2 * nmaxx + 1) * (2 * nmaxy + 1)
    H = (C + 1) // 2
    per_in = (_slab_phase_ops(nmaxx, nmaxy) + 3 + 12 * kz
              + H * (6 + 4 * kz))
    return n * 16 + C * zrows * 8, n + n_in * per_in


def k10_work(n, n_out, nmaxx, nmaxy, force_rows, kz):
    """Bytes and FP32 operations the function of K10 needs at least on
    these inputs (an FMA counts 2), not the kernel's own arithmetic.  The
    outputs are real, so the terms k and -k fold into one (the folded
    table of ops/slab_kernels.fold_half): H = (C + 1) / 2 wavevectors.  Per
    particle the phase rows (_slab_phase_ops), |z| - zmax and the side (3)
    and, per wavevector, e_h = e_x e_y (6).  Inside (n - n_out particles):
    the grid position (3) and the offset g from the first node (1), then
    per wavevector the 4 profiles, polynomials of degree kz - 1 in g
    (slab_kernels.force_poly), by Horner's rule (kz - 1 FMAs each, 8 (kz -
    1)), and the assembly: Re and Im of T e (4), pot (1), a_x and a_y (2
    FMAs), a_z from Re T' e (3).  Outside: per wavevector Tb e (6), 2 pi
    |k| dz and its exp (2), the attenuation (2), pot (1), a_x, a_y and a_z
    (3 FMAs), and the k = 0 linear terms (5).  Bytes: x in, acc and pot
    out, the table (force_rows, H, kz, 4) f32 and the boundary rows
    once."""
    C = (2 * nmaxx + 1) * (2 * nmaxy + 1)
    H = (C + 1) // 2
    per = _slab_phase_ops(nmaxx, nmaxy) + 3 + 6 * H
    per_in = 4 + H * (8 * (kz - 1) + 4 + 1 + 4 + 3)
    per_out = H * (6 + 2 + 2 + 1 + 6) + 5
    ops = n * per + (n - n_out) * per_in + n_out * per_out
    return n * (12 + 16) + force_rows * H * kz * 16 + H * 32, ops


def _slab_k9_check(name, x, m, prm, force, sk):
    """K9 against its plain version on (x, m): G over k != 0 and k = 0 and
    the coefficients, each relative to its own largest value; G Hermitian
    and repeatable bit for bit; the zero-mass row and the rows beyond
    |z| = zmax add exactly 0.  Returns max|dG|."""
    import torch

    G = sk.slab_coef(x, m, prm)
    G0 = sk.slab_coef_plain(x, m, prm)
    c = sk.contract_coef_output(G, force.phi_s, force.sgn)
    c0 = sk.contract_coef_output(G0, force.phi_s, force.sgn)
    torch.cuda.synchronize()
    ctr = (prm.C - 1) // 2
    dG = (G - G0).abs()
    kn = torch.ones(prm.C, dtype=torch.bool, device=x.device)
    kn[ctr] = False
    g_rel = float(dG[kn].max()) / float(G0[kn].abs().max())
    g0_rel = float(dG[ctr].max()) / float(G0[ctr].abs().max())
    cf, cf0 = c.reshape(prm.C, -1), c0.reshape(prm.C, -1)
    dc = (cf - cf0).abs()
    c_rel = float(dc[kn].max()) / float(cf0[kn].abs().max())
    c0_rel = float(dc[ctr].max()) / float(cf0[ctr].abs().max())
    herm = bool(torch.equal(G, G.flip(0).conj()))
    again = bool(torch.equal(G, sk.slab_coef(x, m, prm)))
    dead = (m == 0) | (x[:, 2].abs() > prm.zmax)
    zero = float(sk.slab_coef(x[dead].contiguous(), m[dead].contiguous(),
                              prm).abs().max())
    print(f"SL2 {name} K9 vs plain: max|dG|/max|G| = {g_rel:.3e} (k != 0) "
          f"and {g0_rel:.3e} (k = 0), coefficients {c_rel:.3e} (k != 0) and "
          f"{c0_rel:.3e} (k = 0) (tolerance {SLAB_COEF_RTOL:.0e} and "
          f"{SLAB_COEF0_RTOL:.0e}); Hermitian {herm}, repeatable {again}; "
          f"{int(dead.sum())} zero-mass or |z| > zmax rows give {zero}",
          flush=True)
    if not (g_rel <= SLAB_COEF_RTOL and c_rel <= SLAB_COEF_RTOL
            and g0_rel <= SLAB_COEF0_RTOL and c0_rel <= SLAB_COEF0_RTOL
            and herm and again and zero == 0.0):
        raise AssertionError(f"K9 disagrees with its plain version on the "
                             f"{name} sample")
    return float(dG.max())


def _slab_k10_check(name, x, coef, force, sk):
    """K10 against its plain version on x for the force's interp: acc and
    pot within SLAB_FORCE_RTOL of their largest values, the edge rows
    (last) included, every value finite, and a second launch the same bit
    for bit.  Returns the largest error."""
    import torch

    prm = force._kernel_params()
    tab = sk.slab_force_table(coef, force.zq_s, prm)
    aux = sk.slab_force_aux(coef, force.bnd_s, prm)
    a, p = sk.slab_accel(x, tab, aux, prm)
    a0, p0 = sk.slab_accel_plain(x, tab, aux, prm)
    a1, p1 = sk.slab_accel(x, tab, aux, prm)
    torch.cuda.synchronize()
    again = bool(torch.equal(a, a1)) and bool(torch.equal(p, p1))
    da, dp = (a - a0).abs(), (p - p0).abs()
    amax, pmax = float(a0.abs().max()), float(p0.abs().max())
    ne = len(slab_edge_rows(1)[1])
    edge = slice(x.shape[0] - ne, None)
    out = x[:, 2].abs() > prm.zmax
    print(f"SL2 {name} K10 ({prm.interp}) vs plain: max|da| = "
          f"{float(da.max()):.3e} (|a| up to {amax:.3e}), max|dpot| = "
          f"{float(dp.max()):.3e} (|pot| up to {pmax:.3e}); |z| > zmax rows "
          f"({int(out.sum())}) max|da| = "
          f"{float(da[out].max()) if bool(out.any()) else 0.0:.3e}; edge "
          f"rows max|da| = {float(da[edge].max()):.3e}, max|dpot| = "
          f"{float(dp[edge].max()):.3e}; tolerance {SLAB_FORCE_RTOL:.0e} of "
          f"each largest value; repeatable {again}", flush=True)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    if not (finite and again and float(da.max()) <= SLAB_FORCE_RTOL * amax
            and float(dp.max()) <= SLAB_FORCE_RTOL * pmax):
        raise AssertionError(f"K10 ({prm.interp}) disagrees with its plain "
                             f"version on the {name} sample (finite="
                             f"{finite}, repeatable={again})")
    return max(float(da.max()), float(dp.max()))


def _slab_physics(force, dev):
    """The sech^2 sheet's mean field and the vacuum continuation
    (tests/test_slab.py:38-50, :157-191) through the pallas force, from
    the coefficients of a sheet of N particles truncated at zmax."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_slab import H as HS
    from exp_tpu_torch.bench_slab import ZMAX, truncated_sheet

    x, m = truncated_sheet(N, seed=1)
    coef = force.coefficients(torch.tensor(x, dtype=torch.float32, device=dev),
                              torch.tensor(m, dtype=torch.float32, device=dev))

    def at(pts):
        a, p = force.acceleration(
            coef, torch.tensor(pts, dtype=torch.float32, device=dev))
        return a.double().cpu().numpy(), p.double().cpu().numpy()

    zt = np.array([0.003, 0.01, 0.03, 0.06])
    acc, _ = at(np.stack([np.full(4, 0.3), np.full(4, 0.7), zt], -1))
    gz = -2 * np.pi * np.tanh(zt / HS)
    rz = float(np.abs(acc[:, 2] / gz - 1).max())
    rxy = float(np.abs(acc[:, :2]).max() / np.abs(gz).max())
    print(f"SL2 sech^2 field: max|g_z/(-2 pi tanh(z/h)) - 1| = {rz:.3e} "
          f"(bound {SLAB_FIELD_RTOL}), max|g_xy|/max|g_z| = {rxy:.3e} "
          f"(bound {SLAB_FIELD_XY})", flush=True)

    zs = ZMAX * np.array([0.999, 1.001, 3.0, 6.0, -6.0])
    a, p = at(np.stack([np.full(5, 0.31), np.full(5, 0.72), zs], -1))
    gs = -2.0 * np.pi * np.tanh(ZMAX / HS)
    # continuity (rtol 5e-3 / atol 1e-4 on acc, rtol 5e-3 on pot)
    r_cont = float(np.max(np.abs(a[1] - a[0]) / (1e-4 + 5e-3 * np.abs(a[0]))))
    r_pcont = abs(p[1] - p[0]) / (5e-3 * abs(p[0]))
    r_far = float(np.abs(a[2:4, 2] / gs - 1).max()) / 0.08
    r_slope = abs((p[3] - p[2]) / (3 * ZMAX) / -gs - 1) / 0.1
    r_mir = abs(a[4, 2] / -a[3, 2] - 1) / 1e-3
    r_pmir = abs(p[4] / p[3] - 1) / 0.05
    decays = abs(a[3, 0]) <= abs(a[2, 0]) + 1e-8
    cont = {"continuity_acc": r_cont, "continuity_pot": r_pcont,
            "sheet_gz": r_far, "pot_slope": r_slope, "mirror_gz": r_mir,
            "mirror_pot": r_pmir}
    print("SL2 vacuum continuation, each deviation as a share of its bound "
          "(tests/test_slab.py:157-191): "
          + ", ".join(f"{k} {v:.3f}" for k, v in cont.items())
          + f"; |a_x| decays from 3 to 6 zmax: {decays}", flush=True)
    if not (rz <= SLAB_FIELD_RTOL and rxy <= SLAB_FIELD_XY and decays
            and all(v <= 1.0 for v in cont.values())):
        raise AssertionError("the slab force misses the sech^2 sheet's field "
                             "or its vacuum continuation")


def slab_path(dev):
    """Phases SL1-SL4 on the card; returns the kernels-line rows of K9,
    K10 and K10 under 'linear' and on the outside sample."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_slab import (DT, bench_slab, slab_force,
                                          slab_outside_sample, slab_run,
                                          slab_sample, slab_tables)
    from exp_tpu_torch.forces.slab import SlabForce
    from exp_tpu_torch.ops import cube_kernels as qk
    from exp_tpu_torch.ops import cyl_kernels as yk
    from exp_tpu_torch.ops import slab_kernels as sk
    from exp_tpu_torch.ops import sphere_kernels as hk

    # SL1. the tables on the host, the force on the card, the samples
    t0 = time.perf_counter()
    tables = slab_tables()
    force = slab_force(tables, dev)
    force_lin = SlabForce.from_tables(tables, backend="pallas",
                                      pallas_interp="linear", device=dev)
    prm = force._kernel_params()
    xb, vb, mb = slab_sample(N)
    xo, mo = slab_outside_sample(SLAB_OUTSIDE_N)
    ex, em = slab_edge_rows(N)
    print(f"SL1 slab tables (nmax {tables.nmaxx} x {tables.nmaxy} x "
          f"{tables.nmax}, numz {tables.numz}), force (nzc {prm.nzc}, "
          f"{prm.zrows} rows) and samples: {time.perf_counter() - t0:.1f} s; "
          f"sheet max|z| = {float(np.abs(xb[:, 2]).max()):.4f}", flush=True)

    # SL2. K9 and K10 against their plain versions, then the physics; K10's
    # errors by kernels-line row: the sheet under 'spline', under 'linear',
    # and the outside sample under both
    inputs = {}
    errs = dict.fromkeys(("slab_coef", "slab_accel", "slab_accel[linear]",
                          "slab_accel[outside]"), 0.0)
    for name, (xs, ms) in (("sheet", (xb, mb)), ("outside", (xo, mo))):
        x = torch.tensor(np.concatenate([xs, ex]), dtype=torch.float32,
                         device=dev)
        m = torch.tensor(np.concatenate([ms, em]), dtype=torch.float32,
                         device=dev)
        inputs[name] = (x, m)
        errs["slab_coef"] = max(errs["slab_coef"],
                                _slab_k9_check(name, x, m, prm, force, sk))
        c0 = sk.contract_coef_output(sk.slab_coef_plain(x, m, prm),
                                     force.phi_s, force.sgn)
        for f in (force, force_lin):
            row = ("slab_accel[outside]" if name == "outside" else
                   "slab_accel[linear]" if f is force_lin else "slab_accel")
            errs[row] = max(errs[row], _slab_k10_check(name, x, c0, f, sk))
    _slab_physics(force, dev)

    # SL3. the slab path: init + SLAB_STEPS KDK steps of the bench's sheet
    for mod in (hk, yk, qk, sk):
        mod.reset_launch_counts()
    run = slab_run(force, xb, vb, mb, steps=SLAB_STEPS, dt=DT, device=dev)
    torch.cuda.synchronize()
    launches = {**hk.launch_counts, **yk.launch_counts, **qk.launch_counts,
                **sk.launch_counts}
    print("SL3 slab path: " + json.dumps({**run, "launches": launches}),
          flush=True)
    if not run["finite"]:
        raise AssertionError("non-finite state after the slab KDK run")
    for name in ("slab_coef", "slab_accel"):
        if launches[name] != SLAB_STEPS + 1:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"on the slab path, expected "
                                 f"{SLAB_STEPS + 1}")
    # the same path under 'linear', and from the outside sample at rest,
    # for the launches of K10's other two kernels-line rows
    k10_launches = {"slab_accel": launches["slab_accel"]}
    xo_run, mo_run = slab_outside_sample(N)
    for row, f, (xs, vs, ms) in (
            ("slab_accel[linear]", force_lin, (xb, vb, mb)),
            ("slab_accel[outside]", force,
             (xo_run, np.zeros_like(xo_run), mo_run))):
        sk.reset_launch_counts()
        run2 = slab_run(f, xs, vs, ms, steps=SLAB_STEPS, dt=DT, device=dev)
        torch.cuda.synchronize()
        k10_launches[row] = sk.launch_counts["slab_accel"]
        print(f"SL3 {row}: " + json.dumps(
            {**run2, "launches": dict(sk.launch_counts)}), flush=True)
        if not run2["finite"]:
            raise AssertionError(f"non-finite state after the {row} run")
        if k10_launches[row] != SLAB_STEPS + 1:
            raise AssertionError(f"slab_accel launched {k10_launches[row]} "
                                 f"times on the {row} run, expected "
                                 f"{SLAB_STEPS + 1}")
    if launches["slab_phasestream"] != 0:
        raise AssertionError("P1 launched on the slab path")
    for key, bound in (("dE_rel", SLAB_DRIFT_BOUND),
                       ("dPxy", SLAB_MOM_BOUND),
                       ("dzrms_rel", SLAB_THICKNESS_BOUND)):
        if not run[key] < bound:
            raise AssertionError(f"slab {key} = {run[key]} over "
                                 f"{SLAB_STEPS} steps exceeds {bound}")

    # SL4. timing on the bench's sheet (edge rows included): K9, K10 under
    # 'spline' and 'linear'; K10 on an outside sample of N rows
    bench = bench_slab(n=N, reps=30, tables=tables, device=dev)
    print("SL4 slab step: " + json.dumps(bench), flush=True)
    x, m = inputs["sheet"]
    xo2, mo2 = (torch.tensor(a, dtype=torch.float32, device=dev)
                for a in (xo_run, mo_run))

    def k10_row(f, x, m):
        """(call, plain call, work) of K10 for force f on (x, m), from the
        table of the plain coefficients."""
        p = f._kernel_params()
        c0 = sk.contract_coef_output(sk.slab_coef_plain(x, m, p), f.phi_s,
                                     f.sgn)
        tab = sk.slab_force_table(c0, f.zq_s, p)
        aux = sk.slab_force_aux(c0, f.bnd_s, p)
        n_out = int((x[:, 2].abs() > p.zmax).sum())
        return (lambda: sk.slab_accel(x, tab, aux, p),
                lambda: sk.slab_accel_plain(x, tab, aux, p),
                k10_work(x.shape[0], n_out, p.nmaxx, p.nmaxy, p.force_rows,
                         p.kz))

    n = x.shape[0]
    n_in = int(((m > 0) & (x[:, 2].abs() <= prm.zmax)).sum())
    k10 = "exp_tpu/ops/pallas_slab.py:286"
    rows = []
    for name, line, (fn, plain, (byts, ops)) in (
            ("slab_coef", "exp_tpu/ops/pallas_slab.py:134",
             (lambda: sk.slab_coef(x, m, prm),
              lambda: sk.slab_coef_plain(x, m, prm),
              k9_work(n, n_in, prm.nmaxx, prm.nmaxy, prm.zrows,
                      3 if prm.interp == "spline" else 2))),
            ("slab_accel", k10, k10_row(force, x, m)),
            ("slab_accel[linear]", k10, k10_row(force_lin, x, m)),
            ("slab_accel[outside]", k10, k10_row(force, xo2, mo2))):
        bms, by = bound_ms(byts, ops)
        wrapper = name.split("[")[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"exp_tpu_torch/csrc/{wrapper}.cu", "replaces": line,
            "launches": k10_launches.get(name, launches[wrapper]),
            "max_abs_err": errs[name],
            "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes these "
                            "non-uniform Fourier sums with z weights",
            "bytes": byts, "operations": ops})
    rows[2]["launches_note"] = "K10's launches on SL3's run under 'linear'"
    rows[3]["launches_note"] = ("K10's launches on SL3's run from the "
                                "outside sample at rest")
    return rows

def _variant_rows(forces):
    """The V2 checks: (kernels-line name, wrapper, source, TPU site, force,
    kind) of each new kernel and branch."""
    return [
        ("sphere_coef[hat]", "sphere_coef", "sphere_coef.cu",
         "exp_tpu/ops/pallas_sphere.py:521", forces["hat"], "coef"),
        ("sphere_accel[hat]", "sphere_accel", "sphere_accel.cu",
         "exp_tpu/ops/pallas_sphere.py:398", forces["hat"], "accel"),
        ("sphere_accel[lmax10]", "sphere_accel", "sphere_accel.cu",
         "exp_tpu/ops/pallas_sphere.py:398", forces["lmax10"], "accel"),
        ("sphere_coef_rec", "sphere_coef_rec", "sphere_coef_rec.cu",
         "exp_tpu/ops/pallas_sphere.py:249", forces["recurrence"], "coef"),
        ("sphere_coef_rec[hat]", "sphere_coef_rec", "sphere_coef_rec.cu",
         "exp_tpu/ops/pallas_sphere.py:249", forces["hat+recurrence"],
         "coef"),
        ("sphere_coef_rec[lmax10]", "sphere_coef_rec", "sphere_coef_rec.cu",
         "exp_tpu/ops/pallas_sphere.py:249", forces["lmax10"], "coef"),
        ("sphere_accel_poly", "sphere_accel_poly", "sphere_accel_poly.cu",
         "exp_tpu/ops/pallas_sphere.py:649", forces["poly"], "accel"),
        ("sphere_accel_poly[hat]", "sphere_accel_poly", "sphere_accel_poly.cu",
         "exp_tpu/ops/pallas_sphere.py:649", forces["hat+poly"], "accel"),
    ]


def _variant_fns(sk, wrapper, f, x, m, c0):
    """(kernel call, plain call) of one V2 row; force rows take the
    contracted table of the plain coefficients c0."""
    prm = f._kernel_params()
    tab = f._radial_table()
    if wrapper == "sphere_coef":
        return (lambda: sk.sphere_coef(x, m, tab, f.Mp, prm),
                lambda: sk.sphere_coef_plain(x, m, tab, f.Mp, prm))
    if wrapper == "sphere_coef_rec":
        return (lambda: sk.sphere_coef_rec(x, m, tab, f.fac32, prm),
                lambda: sk.sphere_coef_rec_plain(x, m, tab, f.fac32, prm))
    twT = f.accel_table(c0)
    if wrapper == "sphere_accel":
        return (lambda: sk.sphere_accel(x, twT, f.fac32, prm),
                lambda: sk.sphere_accel_plain(x, twT, f.fac32, prm))
    return (lambda: sk.sphere_accel_poly(x, twT, f.Ms, prm),
            lambda: sk.sphere_accel_poly_plain(x, twT, f.Ms, prm))


def sphere_settings_path(dev, tables, xe, ve, me):
    """Phases V1-V4 on the card: `tables` are phase 3's lmax=4 tables,
    (xe, ve, me) phase 5's equilibrium sample.  Returns the kernels-line
    rows of the new kernels and branches."""
    import numpy as np
    import torch

    from exp_tpu_torch.bench_sphere import (bench_sphere, hernquist_sample_np,
                                            kdk_run, sphere_force,
                                            sphere_tables)
    from exp_tpu_torch.ops import cube_kernels as qk
    from exp_tpu_torch.ops import cyl_kernels as yk
    from exp_tpu_torch.ops import slab_kernels as lk
    from exp_tpu_torch.ops import sphere_kernels as sk

    # V1. the lmax=10 tables and a force for each setting
    t0 = time.perf_counter()
    tabs = {4: tables, 10: sphere_tables(lmax=10, nmax=10)}
    forces = {name: sphere_force(tabs[lmax], dev, harm, interp)
              for name, (lmax, harm, interp, _) in VARIANTS.items()}
    print(f"V1 lmax=10 tables and {len(forces)} forces: "
          f"{time.perf_counter() - t0:.1f} s; kernels "
          + ", ".join(f"{k} {f._harmonics_eff('coef')}/"
                      f"{f._harmonics_eff('accel')}/{f._interp_eff}"
                      for k, f in forces.items()), flush=True)

    # V2. each new kernel and branch against its plain version
    xb, _, mb = hernquist_sample_np(N, seed=0)
    ex, em = edge_rows(N)
    nx = sk.hat_node_points(forces["hat"]._kernel_params(), HAT_NODES)
    x = torch.tensor(np.concatenate([xb, ex, nx]), dtype=torch.float32,
                     device=dev)
    m = torch.tensor(np.concatenate([mb, em, np.full(len(nx), 1.0 / N)]),
                     dtype=torch.float32, device=dev)
    # beyond rmax (2), inside rmin, zero mass
    dead = torch.tensor([N + 3, N + 4, N + 5, N + 6], device=dev)
    coef0, errs, fns, bad = {}, {}, {}, []
    for name, wrapper, _, _, f, kind in _variant_rows(forces):
        key = id(f)
        if key not in coef0:
            prm = f._kernel_params()
            coef0[key] = (sk.sphere_coef_plain(x, m, f._radial_table(), f.Mp,
                                               prm)
                          if f._harmonics_eff("coef") == "poly" else
                          sk.sphere_coef_rec_plain(x, m, f._radial_table(),
                                                   f.fac32, prm))
        fn, plain = _variant_fns(sk, wrapper, f, x, m, coef0[key])
        fns[name] = (fn, plain)
        if kind == "coef":
            c, c0 = fn(), coef0[key]
            torch.cuda.synchronize()
            errs[name] = float((c - c0).abs().max())
            rel = errs[name] / float(c0.abs().max())
            cf, _ = _variant_fns(sk, wrapper, f, x[dead], m[dead], None)
            zero = float(cf().abs().max())
            print(f"V2 {name} vs plain: max|dc| = {errs[name]:.3e}, "
                  f"max|dc|/max|c| = {rel:.3e} (tolerance {COEF_RTOL:.0e}); "
                  f"zero-mass and masked rows give {zero}", flush=True)
            if not (rel <= COEF_RTOL and zero == 0.0):
                bad.append(name)
            continue
        (a, p), (a0, p0) = fn(), plain()
        torch.cuda.synchronize()
        da, dp = (a - a0).abs(), (p - p0).abs()
        errs[name] = max(float(da.max()), float(dp.max()))
        ok_a = da <= ACC_ATOL + ACC_RTOL * a0.abs()
        ok_p = dp <= POT_ATOL + POT_RTOL * p0.abs()
        worst = int(torch.argmax((da - ACC_RTOL * a0.abs()).max(dim=1).values))
        nodes = slice(N + len(em), None)
        print(f"V2 {name} vs plain: max|da| = {float(da.max()):.3e} (|a| up "
              f"to {float(a0.abs().max()):.3e}), max|dpot| = "
              f"{float(dp.max()):.3e}; edge and node rows max|da| = "
              f"{float(da[N:].max()):.3e} (nodes {float(da[nodes].max()):.3e})"
              f"; worst acc row {worst} r = {float(x[worst].norm()):.4g} "
              f"rho = {float(x[worst, :2].norm()):.3e}; {int((~ok_a).sum())} "
              f"acc and {int((~ok_p).sum())} pot values outside acc rtol "
              f"{ACC_RTOL:.0e} atol {ACC_ATOL:.0e}, pot rtol {POT_RTOL:.0e} "
              f"atol {POT_ATOL:.0e}", flush=True)
        finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
        if not (finite and bool(ok_a.all()) and bool(ok_p.all())):
            bad.append(name)
    if bad:
        raise AssertionError(f"V2: kernels disagree with their plain "
                             f"versions: {bad}")

    # V3. init + STEPS KDK steps of the equilibrium sample under each setting
    launches = {}
    for name, (lmax, harm, interp, kernels) in VARIANTS.items():
        for mod in (sk, yk, qk, lk):
            mod.reset_launch_counts()
        run = kdk_run(forces[name], xe, ve, me, steps=STEPS, dt=DT,
                      device=dev)
        torch.cuda.synchronize()
        counts = {**sk.launch_counts, **yk.launch_counts, **qk.launch_counts,
                  **lk.launch_counts}
        launches[name] = counts
        print(f"V3 {name}: " + json.dumps({**run, "launches": counts}),
              flush=True)
        want = {k: (STEPS + 1 if k in kernels else 0) for k in counts}
        if counts != want:
            raise AssertionError(f"V3 {name}: launches {counts}, expected "
                                 f"{want}")
        if not run["finite"]:
            raise AssertionError(f"V3 {name}: non-finite state")
        for key in ("virial0", "virial1"):
            if not abs(run[key] - 1.0) <= VIRIAL_TOL:
                raise AssertionError(f"V3 {name}: 2T/VC {key} = {run[key]}")
        if not run["dE_rel"] < VARIANT_DRIFT_BOUND:
            raise AssertionError(f"V3 {name}: |dEtot/Etot| = {run['dE_rel']} "
                                 f"exceeds {VARIANT_DRIFT_BOUND}")

    # V4. timing: each setting's step, each new kernel and branch
    for name, (lmax, harm, interp, _) in VARIANTS.items():
        bench = bench_sphere(n=N, reps=30, tables=tabs[lmax], device=dev,
                             harmonics=harm, interp=interp)
        print(f"V4 {name} step: " + json.dumps(bench), flush=True)
    r = x.norm(dim=1) + 1e-10
    run_of = {"sphere_coef[hat]": "hat", "sphere_accel[hat]": "hat",
              "sphere_accel[lmax10]": "lmax10",
              "sphere_coef_rec": "recurrence",
              "sphere_coef_rec[hat]": "hat+recurrence",
              "sphere_coef_rec[lmax10]": "lmax10",
              "sphere_accel_poly": "poly",
              "sphere_accel_poly[hat]": "hat+poly"}
    rows = []
    for name, wrapper, src, line, f, kind in _variant_rows(forces):
        prm = f._kernel_params()
        n_in = int(((r >= prm.rmin) & (r <= prm.rmax) & (m > 0)).sum())
        work = {"sphere_coef": lambda: k1_work(x.shape[0], n_in, prm.lmax,
                                               prm.nmax, prm.rows, prm.interp),
                "sphere_coef_rec": lambda: k3_work(x.shape[0], n_in, prm.lmax,
                                                   prm.nmax, prm.rows,
                                                   prm.interp),
                "sphere_accel": lambda: k2_work(x.shape[0], prm.lmax,
                                                prm.rows, prm.interp),
                "sphere_accel_poly": lambda: k6_work(
                    x.shape[0], prm.lmax, prm.rows, f.Ms.cpu().numpy(),
                    prm.interp)}[wrapper]
        byts, ops = work()
        bms, by = bound_ms(byts, ops)
        fn, plain = fns[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"exp_tpu_torch/csrc/{src}", "replaces": line,
            "launches": launches[run_of[name]][wrapper],
            "max_abs_err": errs[name], "ms": cuda_ms(fn, 20),
            "plain_ms": cuda_ms(plain, 3), "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "bytes": byts, "operations": ops})
    return rows


def _comp_kernels(halo, disk, coef):
    """The composite's four kernels as (kernels-line name, wrapper, source,
    TPU site, components whose buckets it runs on, fn(b) -> kernel call,
    plain(b), work(b) -> (bytes, operations), check(out, out0) -> (ok,
    max abs error)); the force kernels take the tables of the assembled
    coefficients `coef` of a substep.  A force given as None leaves its
    two kernels out."""
    import torch

    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import sphere_kernels as sk

    if halo is not None:
        hp = halo._kernel_params()
        twT = halo.accel_table(coef["halo"])
    if disk is not None:
        dp = disk._kernel_params()
        Ct = ck.contract_coef_tables(coef["disk"], disk.tab3, dp.xrows,
                                     dp.ncy)
        kx = 3 if dp.interp == "spline" else 2

    def sph_in(b):
        rs = b.x.norm(dim=1) / hp.scale
        return int(((rs >= hp.rmin) & (rs <= hp.rmax) & (b.mass > 0)).sum())

    def cyl_in(b):
        return int(((b.x.norm(dim=1) <= dp.rmax_grid) & (b.mass > 0)).sum())

    def coef_check(rtol):
        def check(c, c0):
            err = float((c - c0).abs().max())
            return err <= rtol * float(c0.abs().max()), err
        return check

    def accel_check(a_rtol, a_atol, p_rtol, p_atol, rel):
        def check(out, out0):
            (a, p), (a0, p0) = out, out0
            da, dp_ = (a - a0).abs(), (p - p0).abs()
            sa = float(a0.abs().max()) if rel else 1.0
            sp = float(p0.abs().max()) if rel else 1.0
            ok = (bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
                  and bool((da <= a_atol * sa + a_rtol * a0.abs()).all())
                  and bool((dp_ <= p_atol * sp + p_rtol * p0.abs()).all()))
            return ok, max(float(da.max()), float(dp_.max()))
        return check

    sphere = [
        ("sphere_coef[composite]", "sphere_coef", "sphere_coef.cu",
         "exp_tpu/ops/pallas_sphere.py:521", ("halo",),
         lambda b: sk.sphere_coef(b.x, b.mass, halo.tabc_s, halo.Mp, hp),
         lambda b: sk.sphere_coef_plain(b.x, b.mass, halo.tabc_s, halo.Mp, hp),
         lambda b: k1_work(b.x.shape[0], sph_in(b), hp.lmax, hp.nmax,
                           hp.rows),
         coef_check(COEF_RTOL)),
        ("sphere_accel[composite]", "sphere_accel", "sphere_accel.cu",
         "exp_tpu/ops/pallas_sphere.py:398", ("halo", "disk"),
         lambda b: sk.sphere_accel(b.x, twT, halo.fac32, hp),
         lambda b: sk.sphere_accel_plain(b.x, twT, halo.fac32, hp),
         lambda b: k2_work(b.x.shape[0], hp.lmax, hp.rows),
         accel_check(ACC_RTOL, ACC_ATOL, POT_RTOL, POT_ATOL, False))]
    cyl = [
        ("cyl_coef[composite]", "cyl_coef", "cyl_coef.cu",
         "exp_tpu/ops/pallas_cylinder.py:164", ("disk",),
         lambda b: ck.cyl_coef(b.x, b.mass, dp),
         lambda b: ck.cyl_coef_plain(b.x, b.mass, dp),
         lambda b: k4_work(b.x.shape[0], cyl_in(b), dp.mmax, dp.xrows,
                           dp.ncy, kx),
         coef_check(CYL_COEF_RTOL)),
        ("cyl_accel[composite]", "cyl_accel", "cyl_accel.cu",
         "exp_tpu/ops/pallas_cylinder.py:257", ("halo", "disk"),
         lambda b: ck.cyl_accel(b.x, Ct, dp),
         lambda b: ck.cyl_accel_plain(b.x, Ct, dp),
         lambda b: k5_work(b.x.shape[0], dp.mmax, dp.xrows, dp.ncy, kx),
         accel_check(CYL_ACC_RTOL, CYL_ACC_ATOL_REL, CYL_POT_RTOL,
                     CYL_POT_ATOL_REL, True))]
    return ((sphere if halo is not None else [])
            + (cyl if disk is not None else []))


def composite_path(dev, sphere_tables, disk_tables):
    """Phases CM1-CM3 on the card: `sphere_tables` are phase 3's, the disk's
    EOF tables D1's (the composite uses the benches' tables).  Returns the
    kernels-line rows of K1, K2, K4 and K5 at the composite's buckets, and
    CM1's forces and ICs (bench_composite.prepare's dict)."""
    import numpy as np
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_kernels as bk

    # CM1. the forces and the DiskHalo ICs on the card, at full size
    t0 = time.perf_counter()
    forces = bc.composite_forces(dev, sphere_tables, disk_tables)
    s = bc.prepare(bc.N_HALO, bc.N_DISK, dev, forces)
    n_total = bc.N_HALO + bc.N_DISK
    print(f"CM1 DiskHalo ICs of {bc.N_HALO} halo + {bc.N_DISK} disk "
          f"particles: {time.perf_counter() - t0:.1f} s; -2T/VC = "
          f"{s['virial']:.5f} (within {VIRIAL_TOL} of 1)", flush=True)
    if not abs(s["virial"] - 1.0) < VIRIAL_TOL:
        raise AssertionError(f"CM1: the ICs' virial ratio {s['virial']}")

    # CM2. init_state, the warmup, COMP_NBIG big steps with relevels
    bc.reset_launches()
    t0 = time.perf_counter()
    s = bc.start(s)
    runner = s["runner"]
    st, regs, rep = bc.composite_run(runner, s["st"], s["regs"], s["diag"],
                                     COMP_NBIG)
    torch.cuda.synchronize()
    launches = bc.kernel_launches()
    nbig_total = s["warmup_bigsteps"] + COMP_NBIG
    want = {k: 0 for k in launches}
    want.update(bc.expected_launches(runner, nbig_total))
    print("CM2 composite path: " + json.dumps({
        **rep, "warmup_bigsteps": s["warmup_bigsteps"],
        "warmup_stable": s["warmup_stable"],
        "relevel_rebuilds": runner.n_rebuilds,
        "relevel_fallbacks": runner.n_fallbacks, "launches": launches,
        "expected_launches": want,
        "sec": time.perf_counter() - t0}), flush=True)
    if not rep["finite"]:
        raise AssertionError("CM2: non-finite state or coefficients")
    if not (rep["n_live"] == n_total and rep["ids_unchanged"]):
        raise AssertionError(f"CM2: {rep['n_live']} live particles or "
                             "their identities changed")
    if not (s["warmup_stable"] and rep["caps_unchanged"]):
        raise AssertionError("CM2: the capacity signature changed after "
                             "the warmup")
    if not rep["level_move_net"] <= COMP_LEVEL_MOVE:
        raise AssertionError(f"CM2: a level moved by {rep['level_move_net']}"
                             f" of its component (bound {COMP_LEVEL_MOVE})")
    if not rep["dE_rel"] < COMP_DRIFT_BOUND:
        raise AssertionError(f"CM2: |dEtot/Etot| = {rep['dE_rel']} exceeds "
                             f"{COMP_DRIFT_BOUND}")
    if launches != want:
        raise AssertionError(f"CM2: launches {launches}, the schedule "
                             f"implies {want}")

    # CM3. big steps and relevels timed; each kernel against its plain
    # version on every bucket; its device time in one big step from
    # torch.profiler (CUDA events around launches of the small buckets
    # would time the host's enqueue), by the device kernels it launches:
    # their union over one profile of calls on every bucket (which kernels
    # a call launches depends on its rows); a launch on each level's bucket
    # by bench_kernels.queued_ms
    st, regs, big, rel = bc.time_bigsteps(runner, st, regs, COMP_TIMED)
    step = float(np.median(big))
    counts = runner.level_counts(st)
    st, regs, coef, _ = runner.bigstep(st, regs)
    kernels = _comp_kernels(s["halo"], s["disk"], coef)
    ops, n_ops = bk.device_ops(lambda: runner.bigstep(st, regs))
    dev_ms = sum(ops.values())
    names = {}
    for name, _, _, _, comps, fn, *_ in kernels:
        ops_w, _ = bk.device_ops(
            lambda: [fn(b) for c in comps for b in st[c] for _ in range(3)])
        names[name] = set(ops_w)
    print("CM3 composite step: " + json.dumps({
        "metric": "composite_particle_substeps_per_sec",
        "value": bc.substeps_per_bigstep(counts) / step, "unit": "1/s",
        "step_ms": step * 1e3, "step_ms_all": [t * 1e3 for t in big],
        "relevel_ms": float(np.median(rel)) * 1e3,
        "relevel_ms_all": [t * 1e3 for t in rel],
        "device_ms_per_bigstep": dev_ms, "device_busy": dev_ms / (step * 1e3),
        "device_launches_per_bigstep": n_ops, "level_counts": counts,
        "caps": runner.caps, "device": torch.cuda.get_device_name(dev)}),
        flush=True)
    rows, bad = [], []
    for name, wrapper, src, line, comps, fn, plain, work, check in kernels:
        per = {"plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0, "operations": 0}
        nl, err, levels = 0, 0.0, []
        for c in comps:
            for l, b in enumerate(st[c]):
                ok, e = check(fn(b), plain(b))
                err = max(err, e)
                if not ok:
                    bad.append(f"{name} {c} level {l}")
                byts, ops_ = work(b)
                w = 2 ** l          # level l runs 2^l times a big step
                nl += w
                per["plain_ms"] += w * cuda_ms(lambda: plain(b), 1)
                per["bound_ms"] += w * bound_ms(byts, ops_)[0]
                per["bytes"] += w * byts
                per["operations"] += w * ops_
                # device time a launch on this level's bucket: launches
                # queued behind a spin kernel, timed by CUDA events
                lv_ms = bk.queued_ms(lambda: fn(b), CM3_LEVEL_REPS)
                levels.append({"component": c, "level": l,
                               "rows": int(b.x.shape[0]),
                               "launches_per_bigstep": w, "device_ms": lv_ms,
                               "bound_ms": bound_ms(byts, ops_)[0]})
                print(f"CM3 {name} {c} level {l}: {b.x.shape[0]} rows, "
                      f"{w} launches a big step, {lv_ms:.4f} ms device "
                      f"time a launch (bound "
                      f"{bound_ms(byts, ops_)[0]:.5f}), "
                      f"{w * lv_ms:.4f} ms a big step", flush=True)
        # the profile's categories must file every device kernel of the
        # wrapper under the port's kernels
        stray = [k for k in names[name] if bc._category(k) != "kernels"]
        if stray:
            bad.append(f"{name}: device ops {stray} outside the profile's "
                       "kernels category")
        ms = sum(t for k, t in ops.items() if k in names[name])
        by = bound_ms(per["bytes"], per["operations"])[1]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"exp_tpu_torch/csrc/{src}", "replaces": line,
            "launches": launches[wrapper], "max_abs_err": err,
            "ms": ms / nl, "plain_ms": per["plain_ms"] / nl,
            "bound_ms": per["bound_ms"] / nl, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "launches_per_bigstep": nl, "ms_per_bigstep": ms,
            "bound_ms_per_bigstep": per["bound_ms"],
            "bytes_per_bigstep": per["bytes"],
            "operations_per_bigstep": per["operations"],
            "levels": levels,
            "device_kernels": sorted(n[:60] for n in names[name])})
        print(f"CM3 {name}: {nl} launches a big step, {ms:.3f} ms of device "
              f"time (bound {per['bound_ms']:.4f}), max error against the "
              f"plain version over the buckets {err:.3e}", flush=True)
    if bad:
        raise AssertionError(f"CM3: kernels disagree with their plain "
                             f"versions on the buckets {bad}")
    return rows, s



def _bucket_diff(st_a, st_b):
    """The first (component, level, field) where two bucketed states differ
    bit for bit, or None."""
    import torch

    for n in st_a:
        for l, (a, b) in enumerate(zip(st_a[n], st_b[n])):
            for f in ("x", "v", "mass", "acc", "pot", "level", "indx",
                      "scale"):
                if not torch.equal(getattr(a, f), getattr(b, f)):
                    return n, l, f
    return None


def _clone_state(st):
    from dataclasses import replace

    return {n: [replace(b, **{f: getattr(b, f).clone() for f in
                              ("x", "v", "mass", "acc", "pot", "level",
                               "indx", "scale")}) for b in bs]
            for n, bs in st.items()}


def driver_path(dev, sphere_tables, comp, xe, ve, me):
    """Phases R1-R4 on the card: the YAML driver on the flagship's run
    config from CM1's ICs (`comp`, composite_path's set-up), held against
    the bare MultistepRunner bit for bit; the single-rate driver on phase
    5's sample (xe, ve, me); the driver's own time beside the bare paths'.
    Returns R4's times, the work directory (its body and model files),
    which the caller cleans up, and R2's state after DRIVER_NBIG big steps
    with its launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_extras as be
    from exp_tpu_torch.bench_extras import (flagship_config, sphere_config,
                                            write_bodies)
    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.config import RunConfig
    from exp_tpu_torch.io.psp import read_psp
    from exp_tpu_torch.nbody.particles import (ParticleSystem,
                                               read_ascii_arrays,
                                               read_bodies,
                                               write_ascii_bodies)
    from exp_tpu_torch.nbody.simulation import Simulation
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step
    from exp_tpu_torch.ops import sphere_kernels as sk

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_driver_")
    wd = work.name

    # R1. the flagship's body files and run config
    t0 = time.perf_counter()
    ic = comp["ic"]
    write_bodies(wd, ic)
    cfg = RunConfig.from_dict(flagship_config("out"), where="R1")
    print(f"R1 flagship run config: {len(ic['mh'])} halo + {len(ic['md'])} "
          f"disk bodies as PSP files, {time.perf_counter() - t0:.1f} s; "
          + json.dumps(flagship_config("out")), flush=True)

    # R2. Simulation on that config for DRIVER_NBIG big steps, each state
    # kept; then the bare runner from the same bodies, compared bit for bit
    t0 = time.perf_counter()
    sim = Simulation(cfg, workdir=wd, device=dev)
    t_build = time.perf_counter() - t0
    bc.reset_launches()
    t0 = time.perf_counter()
    sim.run(0)                                  # init_state, outputs at 0
    states = [_clone_state(sim._ms_state)]
    for _ in range(DRIVER_NBIG):
        sim.run(1)
        states.append(_clone_state(sim._ms_state))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = bc.kernel_launches()
    want = {k: 0 for k in launches}
    want.update(bc.expected_launches(sim._ms_runner, DRIVER_NBIG))
    log = be.outlog_rows(os.path.join(wd, "out", "OUTLOG.flag"))
    etot = log[:, 12] + log[:, 13]
    de = abs(etot[-1] - etot[0]) / abs(etot[0])
    finite = bool(np.isfinite(log).all()) and all(
        bool(torch.isfinite(getattr(b, f)).all())
        for bs in sim._ms_state.values() for b in bs
        for f in ("x", "v", "acc", "pot"))
    snap = read_psp(os.path.join(wd, "out", f"OUT.flag.{DRIVER_NBIG:05d}"))
    psp_ok = abs(snap.time - sim.time) < 1e-12
    for c in snap.components:
        ps = sim._state[c.name]
        live = (ps.mass > 0).cpu().numpy()
        for k, col in (("x", c.x), ("v", c.v), ("mass", c.mass),
                       ("pot", c.pot)):
            psp_ok &= np.array_equal(getattr(ps, k).cpu().numpy()[live],
                                     col.astype(np.float32))
    rep = {"build_sec": t_build, "run_sec": t_run, "rows": len(log),
           "Etot0": float(etot[0]), "Etot": float(etot[-1]), "dE_rel": de,
           "Etot_rows": [float(e) for e in etot],
           "finite": finite, "psp_equal": bool(psp_ok),
           "level_counts": sim._ms_runner.level_counts(sim._ms_state),
           "relevel_rebuilds": sim._ms_runner.n_rebuilds,
           "relevel_fallbacks": sim._ms_runner.n_fallbacks,
           "overrun": sim._ms_runner.overrun,
           "launches": launches, "expected_launches": want}
    print("R2 driver run: " + json.dumps(rep), flush=True)
    if not finite:
        raise AssertionError("R2: non-finite OUTLOG or state")
    if len(log) != DRIVER_NBIG + 1:
        raise AssertionError(f"R2: {len(log)} OUTLOG rows")
    if not de < DRIVER_DRIFT_BOUND:
        raise AssertionError(f"R2: OUTLOG |dEtot/Etot| = {de} exceeds "
                             f"{DRIVER_DRIFT_BOUND}")
    if launches != want:
        raise AssertionError(f"R2: launches {launches}, the schedule "
                             f"implies {want}")
    if not psp_ok:
        raise AssertionError(f"R2: OUT.flag.{DRIVER_NBIG:05d} does not read "
                             "back equal to the state")
    r2 = {"state": states[DRIVER_NBIG], "launches": dict(launches)}

    # the bare runner on CM1's forces from the same bodies
    runner = bc.make_runner(comp["halo"], comp["disk"])
    flat = {n: read_bodies(os.path.join(wd, f"{n}.psp"), device=dev)
            for n in ("halo", "disk")}
    st, regs, _, _ = runner.init_state(flat)
    diffs = [_bucket_diff(states[0], st)]
    t = 0.0
    for k in range(DRIVER_NBIG):
        st, regs, _, _ = runner.bigstep(st, regs, t)
        mid = _clone_state(st)
        st, regs = runner.relevel(st, regs, t0=t + runner.dtime)
        t += runner.dtime
        d = _bucket_diff(states[k + 1], st)
        if d is not None and diffs[-1] is None and \
                _bucket_diff(states[k + 1], mid) is None:
            d = d + ("after the relevel",)
        diffs.append(d)
    first = next(((k, d) for k, d in enumerate(diffs) if d), None)
    print("R2 driver vs bare runner: " + (
        "the same state bit for bit after init_state and each of the "
        f"{DRIVER_NBIG} big steps" if first is None else
        f"first differs after big step {first[0]} (0: init_state) in "
        f"{first[1]}"), flush=True)
    if first is not None:
        raise AssertionError(f"R2: the driver's state differs from the bare "
                             f"runner's: big step {first[0]}, {first[1]}")

    # the CLI on the same config as a YAML file: its rows equal R2's
    import yaml

    yml = os.path.join(wd, "flag_cli.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(flagship_config("cli"), f)
    from exp_tpu_torch.run import main

    t0 = time.perf_counter()
    main([yml, "-n", "2"])
    cli = be.outlog_rows(os.path.join(wd, "cli", "OUTLOG.flag"))
    print(f"R2 exp_tpu_torch.run on flag_cli.yml -n 2: "
          f"{time.perf_counter() - t0:.1f} s, {len(cli)} OUTLOG rows, equal "
          f"to the driver's: {bool(np.array_equal(cli, log[:3]))}",
          flush=True)
    if not np.array_equal(cli, log[:3]):
        raise AssertionError("R2: the CLI's OUTLOG differs from the "
                             "driver's first rows")

    # R4 (composite). DRIVER_TIMED big steps of the driver and of the bare
    # runner, each ended by a synchronise, on the host clock
    drv = []
    for _ in range(DRIVER_TIMED):
        t0 = time.perf_counter()
        sim.run(1)
        torch.cuda.synchronize()
        drv.append(time.perf_counter() - t0)
    st, regs, big, rel = bc.time_bigsteps(runner, st, regs, DRIVER_TIMED, t)
    r4c = {"driver_bigstep_ms": float(np.median(drv)) * 1e3,
           "driver_bigstep_ms_all": [x * 1e3 for x in drv],
           "bare_bigstep_plus_relevel_ms": float(np.median(
               np.add(big, rel))) * 1e3,
           "bare_bigstep_ms": float(np.median(big)) * 1e3,
           "bare_relevel_ms": float(np.median(rel)) * 1e3,
           "device": torch.cuda.get_device_name(dev)}
    del sim, runner, st, regs, states, flat

    # R3. the single-rate driver on phase 5's sample as an ascii body file
    t0 = time.perf_counter()
    write_ascii_bodies(os.path.join(wd, "sphere.bods"), (xe, ve, me))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    xr, vr, mr = read_ascii_arrays(os.path.join(wd, "sphere.bods"))
    t_read = time.perf_counter() - t0
    if not (np.array_equal(xr, xe) and np.array_equal(vr, ve)
            and np.array_equal(mr, me)):
        raise AssertionError("R3: the ascii body file does not read back "
                             "equal to the sample")
    scfg = sphere_config("sph", "sph", DT, STEPS)
    t0 = time.perf_counter()
    sim = Simulation(RunConfig.from_dict(scfg, where="R3"), workdir=wd,
                     device=dev)
    t_build = time.perf_counter() - t0
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    sim.prime()
    sim.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(sk.launch_counts)
    log = be.outlog_rows(os.path.join(wd, "sph", "OUTLOG.sph"))
    etot = log[:, 12] + log[:, 13]
    de = abs(etot[-1] - etot[0]) / abs(etot[0])
    rep = {"ascii_write_sec": t_write, "ascii_read_sec": t_read,
           "bodies": int(log[0, 2]), "build_sec": t_build,
           "run_sec": t_run, "rows": len(log), "virial0": float(log[0, 16]),
           "virial1": float(log[-1, 16]), "Etot0": float(etot[0]),
           "Etot1": float(etot[-1]), "dE_rel": de,
           "finite": bool(np.isfinite(log).all()), "launches": launches}
    print("R3 single-rate driver: " + json.dumps(rep), flush=True)
    if not rep["finite"] or len(log) != STEPS + 1:
        raise AssertionError(f"R3: {len(log)} OUTLOG rows, finite "
                             f"{rep['finite']}")
    for name, cnt in launches.items():
        want_n = STEPS + 1 if name in ("sphere_coef", "sphere_accel") else 0
        if cnt != want_n:
            raise AssertionError(f"R3: {name} launched {cnt} times, "
                                 f"expected {want_n}")
    for key in ("virial0", "virial1"):
        if not abs(rep[key] - 1.0) <= VIRIAL_TOL:
            raise AssertionError(f"R3: 2T/VC {key} = {rep[key]}")
    if not de < DRIFT_BOUND:
        raise AssertionError(f"R3: |dEtot/Etot| = {de} over {STEPS} steps "
                             f"exceeds {DRIFT_BOUND}")

    # R4 (single rate). DRIVER_TIMED_STEPS steps of the driver (an OUTLOG
    # row each) and of make_kdk_step on the same sample and tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(DRIVER_TIMED_STEPS)
    torch.cuda.synchronize()
    t_drv = (time.perf_counter() - t0) / DRIVER_TIMED_STEPS
    force = sphere_force(sphere_tables, dev)
    ps = ParticleSystem.from_arrays(xe, ve, me, device=dev)
    ps, _, _ = init_force_state(force, ps)
    step = make_kdk_step(force, DT)
    step(ps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DRIVER_TIMED_STEPS):
        step(ps)
    torch.cuda.synchronize()
    t_kdk = (time.perf_counter() - t0) / DRIVER_TIMED_STEPS
    r4c.update(driver_step_ms=t_drv * 1e3, kdk_step_ms=t_kdk * 1e3)
    print("R4 driver overhead (host clock, not gated): " + json.dumps(r4c),
          flush=True)
    return r4c, work, r2

def _finite_buckets(sim):
    import torch

    return all(bool(torch.isfinite(getattr(b, f)).all())
               for bs in sim._ms_state.values() for b in bs
               for f in ("x", "v", "acc", "pot"))


class _PlainK1:
    """A sphere force's coefficients through K1's plain version (PyTorch
    ops on the card), for E1's Hall comparisons."""

    def __init__(self, force):
        self.f = force

    def coefficients(self, x, mass, accum_dtype=None):
        from exp_tpu_torch.ops import sphere_kernels as sk

        f = self.f
        return sk.sphere_coef_plain(
            x.float().contiguous(), mass.float().contiguous(),
            f._radial_table(), f.Mp, f._kernel_params())


def _extras_run(sim, nbig, check=None):
    """init_state, then nbig big steps, each timed on the host clock and
    followed by `check(k)`; the launches read just after."""
    import torch

    from exp_tpu_torch import bench_composite as bc

    bc.reset_launches()
    sim.run(0)
    times, ok = [], _finite_buckets(sim)
    if check:
        check(-1)
    for k in range(nbig):
        t0 = time.perf_counter()
        sim.run(1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        ok &= _finite_buckets(sim)
        if check:
            check(k)
    return bc.kernel_launches(), times, ok


def extras_path(dev, wd, r4):
    """Phases E1-E4 on the card: the driver's extras on the flagship's run
    config (E1: EJ, nEJaccel and Hall; E3: a frozen halo) and the sphere's
    (E2: NO_L1 and the userbar), from R1's body files and R3's in the
    work directory `wd`; E4 prints their times beside R4's (`r4`)."""
    import os

    import numpy as np
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_extras as be
    from exp_tpu_torch.config import RunConfig
    from exp_tpu_torch.nbody.centering import _regress
    from exp_tpu_torch.nbody.pca import apply_hall
    from exp_tpu_torch.nbody.simulation import Simulation
    from exp_tpu_torch.ops import sphere_kernels as sk

    e4 = {"R4_driver_bigstep_ms": r4["driver_bigstep_ms"],
          "R4_driver_step_ms": r4["driver_step_ms"]}

    # E1. EJ + nEJaccel on the disk, Hall on the halo, multistep
    t0 = time.perf_counter()
    sim = Simulation(RunConfig.from_dict(
        be.case_config("E1", "e1", "e1", DRIVER_NBIG), where="E1"),
        workdir=wd, device=dev)
    t_build = time.perf_counter() - t0
    w_used = {}

    def keep_hall(k):
        # the Hall weights the driver applies in the last big step (its
        # update after big step npca * j applies until the next)
        if k == DRIVER_NBIG - 2:
            w_used["halo"] = sim._hall["halo"].clone()

    launches, times, finite = _extras_run(sim, DRIVER_NBIG, keep_hall)
    halo = sim.components["halo"]
    n_hall = DRIVER_NBIG // halo.npca
    want = {k: 0 for k in launches}
    want.update(bc.expected_launches(sim._ms_runner, DRIVER_NBIG))
    want["sphere_coef"] += halo.nsamples * n_hall
    log = be.outlog_rows(os.path.join(wd, "e1", "OUTLOG.e1"))
    de = be.drift(log, "E1")
    orient_rows = np.loadtxt(os.path.join(wd, "e1", "e1.orient.disk"),
                             ndmin=2)
    # the tracked center against NumPy f64 from the card's synced state
    sim._sync_flat_state()
    ps = sim._state["disk"]
    xd, vd, md, pd = (getattr(ps, f).double().cpu().numpy()
                      for f in ("x", "v", "mass", "pot"))
    E = pd + 0.5 * np.sum(vd * vd, axis=1)
    E[md <= 0] = np.inf
    top = np.argsort(E, kind="stable")[:256]
    w = md[top]
    c1 = np.sum(xd[top] * w[:, None], axis=0) / max(w.sum(), 1e-30)
    orient = sim.components["disk"].orient
    hist = list(orient._histC)
    c_np, _ = _regress(hist[:-1] + [(hist[-1][0], c1)], sim.time,
                       orient.damp)
    Eg = ps.pot + 0.5 * torch.sum(ps.v * ps.v, dim=-1)
    Eg = torch.where(ps.mass > 0, Eg, torch.full_like(Eg, float("inf")))
    top_card = set(torch.topk(-Eg, 256).indices.cpu().tolist())
    dcen = float(np.abs(c_np - sim._centers["disk"]).max())
    # the halo's set the driver assembled in the last big step (K1 on each
    # level's bucket at the final positions, Hall applied) against its
    # Hall weights on K1's plain version's coefficients of the synced state
    hp = sim._state["halo"]
    c0 = _PlainK1(halo.force).coefficients(hp.x, hp.mass)
    ref = apply_hall(c0, w_used["halo"])
    drv = torch.as_tensor(sim._coefs["halo"], device=dev)
    assembled_rel = float((drv - ref).abs().max() / ref.abs().max())
    # the driver's next Hall update (E4 times it; the 10th big step is one
    # of npca's) against the same update through K1's plain version, both
    # applied to c0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim._update_hall(multistep=True)
    torch.cuda.synchronize()
    t_hall = time.perf_counter() - t0
    w_card = sim._hall["halo"]
    halo.force = _PlainK1(halo.force)
    try:
        sim._update_hall(multistep=True)
    finally:
        halo.force = halo.force.f
    w_plain, sim._hall["halo"] = sim._hall["halo"], w_card
    ref = apply_hall(c0, w_plain)
    hall_rel = float((apply_hall(c0, w_card) - ref).abs().max()
                     / ref.abs().max())
    rep = {"build_sec": t_build, "rows": len(log), "dE_rel": de,
           "finite": finite and bool(np.isfinite(log).all()),
           "orient_rows": len(orient_rows), "center": list(
               sim._centers["disk"]), "center_np": list(c_np),
           "center_c1_card": list(hist[-1][1]), "center_c1_np": list(c1),
           "top256_differ": len(top_card - set(top.tolist())),
           "center_dmax": dcen, "assembled_rel": assembled_rel,
           "hall_rel": hall_rel,
           "hall_weight_min": float(sim._hall["halo"].min()),
           "pseudo": [list(a) for a in sim.components["disk"].pseudo()],
           "level_counts": sim._ms_runner.level_counts(sim._ms_state),
           "launches": launches, "expected_launches": want,
           "timers": dict(sim.timers)}
    print("E1 flagship + EJ/nEJaccel (disk) + Hall (halo): "
          + json.dumps(rep), flush=True)
    # E4's update times: one EJ update more, and the Hall update above
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim._update_orient(multistep=True)
    t_orient = time.perf_counter() - t0
    e4.update(E1_bigstep_ms=float(np.median(times)) * 1e3,
              E1_bigstep_ms_all=[t * 1e3 for t in times],
              E1_orient_timer_sec=sim.timers["Orient"],
              E1_hall_timer_sec=sim.timers["Hall"],
              ej_update_ms=t_orient * 1e3, hall_update_ms=t_hall * 1e3)
    del sim, ps, hp
    if not rep["finite"] or len(log) != DRIVER_NBIG + 1:
        raise AssertionError(f"E1: {len(log)} OUTLOG rows, finite "
                             f"{rep['finite']}")
    if len(orient_rows) != DRIVER_NBIG:
        raise AssertionError(f"E1: {len(orient_rows)} orient-log rows")
    if launches != want:
        raise AssertionError(f"E1: launches {launches}, the schedule and "
                             f"{n_hall} Hall updates imply {want}")
    if not dcen <= E1_CENTER_ATOL:
        raise AssertionError(f"E1: tracked center off its f64 "
                             f"recomputation by {dcen}")
    if not assembled_rel <= E1_HALL_RTOL:
        raise AssertionError(f"E1: the halo's assembled set off its Hall "
                             f"weights on K1's plain version by "
                             f"{assembled_rel}")
    if not hall_rel <= E1_HALL_RTOL:
        raise AssertionError(f"E1: the driver's Hall update through K1 and "
                             f"through its plain version differ by "
                             f"{hall_rel}")
    if not de < E1_DRIFT_BOUND:
        raise AssertionError(f"E1: OUTLOG |dEtot/Etot| = {de} exceeds "
                             f"{E1_DRIFT_BOUND}")

    # E2. the sphere with NO_L1 and the userbar, single-rate
    t0 = time.perf_counter()
    sim = Simulation(RunConfig.from_dict(
        be.sphere_config("e2", "e2", DT, STEPS, extras=True), where="E2"),
        workdir=wd, device=dev)
    t_build = time.perf_counter() - t0
    sk.reset_launch_counts()
    sim.prime()
    l1 = [float(np.abs(sim._coefs["halo"][:, 1]).max())]
    for _ in range(STEPS):
        sim.run(1)
        l1.append(float(np.abs(sim._coefs["halo"][:, 1]).max()))
    torch.cuda.synchronize()
    launches = dict(sk.launch_counts)
    log = be.outlog_rows(os.path.join(wd, "e2", "OUTLOG.e2"))
    bar = sim.externals[0]
    x4 = sim._state["halo"].x[:E2_BAR_N]
    a_c, _ = bar.acceleration(x4, sim.time)
    a_r, _ = bar.acceleration(x4.double().cpu(), sim.time)
    bar_rel = float((a_c.double().cpu() - a_r).abs().max()
                    / a_r.abs().max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(DRIVER_TIMED_STEPS)
    torch.cuda.synchronize()
    e4["E2_step_ms"] = (time.perf_counter() - t0) / DRIVER_TIMED_STEPS * 1e3
    # the host transfers of ScatterMFP and of a NOISE draw at 2^20
    from exp_tpu_torch.basis.model import SphericalModelTable
    from exp_tpu_torch.forces.external import ScatterMFP
    from exp_tpu_torch.nbody.noise import SphereNoise

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ScatterMFP(tau=10.0).apply(sim._state["halo"], DT, 0)
    torch.cuda.synchronize()
    e4["scatterMFP_apply_ms"] = (time.perf_counter() - t0) * 1e3
    nz = SphereNoise.build(sim.components["halo"].force,
                           SphericalModelTable.from_file(
                               os.path.join(wd, "halo.model")))
    t0 = time.perf_counter()
    torch.as_tensor(nz.interpolate(0.0), device=dev)
    torch.cuda.synchronize()
    e4["noise_draw_ms"] = (time.perf_counter() - t0) * 1e3
    rep = {"build_sec": t_build, "rows": len(log),
           "finite": bool(np.isfinite(log).all()) and bool(
               torch.isfinite(sim._state["halo"].x).all()),
           "l1_max_abs": max(l1), "virial0": float(log[0, 16]),
           "virial1": float(log[STEPS, 16]), "bar_rel": bar_rel,
           "bar_amax": float(a_r.abs().max()), "launches": launches}
    print("E2 sphere + NO_L1 + userbar: " + json.dumps(rep), flush=True)
    del sim, x4
    if not rep["finite"] or len(log) != STEPS + 1:
        raise AssertionError(f"E2: {len(log)} OUTLOG rows, finite "
                             f"{rep['finite']}")
    for name, cnt in launches.items():
        want_n = STEPS + 1 if name in ("sphere_coef", "sphere_accel") else 0
        if cnt != want_n:
            raise AssertionError(f"E2: {name} launched {cnt} times, "
                                 f"expected {want_n}")
    if max(l1) != 0.0:
        raise AssertionError(f"E2: l = 1 coefficients up to {max(l1)}")
    for key in ("virial0", "virial1"):
        if not abs(rep[key] - 1.0) <= VIRIAL_TOL:
            raise AssertionError(f"E2: 2T/VC {key} = {rep[key]}")
    if not bar_rel <= E2_BAR_RTOL:
        raise AssertionError(f"E2: the bar's acceleration on the card is "
                             f"off its f64 evaluation by {bar_rel}")

    # E3. the flagship with a frozen halo
    t0 = time.perf_counter()
    sim = Simulation(RunConfig.from_dict(
        be.case_config("E3", "e3", "e3", DRIVER_NBIG), where="E3"),
        workdir=wd, device=dev)
    t_build = time.perf_counter() - t0
    frozen = []

    def check(k):
        c = sim._coefs["halo"]
        c = c.cpu().numpy() if isinstance(c, torch.Tensor) else c
        frozen.append(c.copy())

    launches, times, finite = _extras_run(sim, DRIVER_NBIG, check)
    nb = sim._ms_runner.M + 1
    want = {k: 0 for k in launches}
    want.update(bc.expected_launches(sim._ms_runner, DRIVER_NBIG))
    want["sphere_coef"] = 2 * nb
    same = all(np.array_equal(c, frozen[0]) for c in frozen[1:])
    log = be.outlog_rows(os.path.join(wd, "e3", "OUTLOG.e3"))
    de = be.drift(log, "E3")
    rep = {"build_sec": t_build, "rows": len(log), "disk_dE_rel": de,
           "global_dE_rel": be.drift(log, "E1"),
           "finite": finite and bool(np.isfinite(log).all()),
           "halo_coefs_frozen_bitwise": same,
           "launches": launches, "expected_launches": want}
    print("E3 flagship, halo self_consistent: false: " + json.dumps(rep),
          flush=True)
    e4["E3_bigstep_ms"] = float(np.median(times)) * 1e3
    e4["E3_bigstep_ms_all"] = [t * 1e3 for t in times]
    del sim
    if not rep["finite"] or len(log) != DRIVER_NBIG + 1:
        raise AssertionError(f"E3: {len(log)} OUTLOG rows, finite "
                             f"{rep['finite']}")
    if not same:
        raise AssertionError("E3: the frozen halo's coefficients changed")
    if launches != want:
        raise AssertionError(f"E3: launches {launches}, expected {want}")
    if not de < E3_DRIFT_BOUND:
        raise AssertionError(f"E3: the disk's |dE/E| = {de} exceeds "
                             f"{E3_DRIFT_BOUND}")

    # E4. times on the host clock, printed and not gated
    e4["device"] = torch.cuda.get_device_name(dev)
    print("E4 extras' times (host clock, not gated): " + json.dumps(e4),
          flush=True)


def _mf_sphere_check(tag, force, x, m):
    """K1 and K2 on `force`'s tables against their plain versions on (x, m)
    (f32 on the card) at phase 4's tolerances; returns the kernels-line
    fields of each (max error, ms, plain ms, bound) and raises on a
    disagreement."""
    import torch

    from exp_tpu_torch.ops import sphere_kernels as sk

    prm = force._kernel_params()
    tab = force._radial_table()
    c = sk.sphere_coef(x, m, tab, force.Mp, prm)
    c0 = sk.sphere_coef_plain(x, m, tab, force.Mp, prm)
    twT = force.accel_table(c0)
    a, p = sk.sphere_accel(x, twT, force.fac32, prm)
    a0, p0 = sk.sphere_accel_plain(x, twT, force.fac32, prm)
    torch.cuda.synchronize()
    k1_err = float((c - c0).abs().max())
    k1_rel = k1_err / float(c0.abs().max())
    da, dp = (a - a0).abs(), (p - p0).abs()
    k2_err = max(float(da.max()), float(dp.max()))
    ok_a = bool((da <= ACC_ATOL + ACC_RTOL * a0.abs()).all())
    ok_p = bool((dp <= POT_ATOL + POT_RTOL * p0.abs()).all())
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    print(f"{tag} K1 vs plain: max|dc|/max|c| = {k1_rel:.3e} (tolerance "
          f"{COEF_RTOL:.0e}); K2 vs plain: max|da| = {float(da.max()):.3e} "
          f"(|a| up to {float(a0.abs().max()):.3e}), max|dpot| = "
          f"{float(dp.max()):.3e}", flush=True)
    if not (k1_rel <= COEF_RTOL and ok_a and ok_p and finite):
        raise AssertionError(f"{tag}: K1/K2 disagree with their plain "
                             f"versions (K1 {k1_rel}, acc ok {ok_a}, pot ok "
                             f"{ok_p}, finite {finite})")
    r = x.norm(dim=1) + 1e-10
    n_in = int(((r >= prm.rmin * prm.scale) & (r <= prm.rmax * prm.scale)
                & (m > 0)).sum())
    out = {}
    for name, fn, plain, err, (byts, ops) in (
            ("sphere_coef",
             lambda: sk.sphere_coef(x, m, tab, force.Mp, prm),
             lambda: sk.sphere_coef_plain(x, m, tab, force.Mp, prm), k1_err,
             k1_work(x.shape[0], n_in, prm.lmax, prm.nmax, prm.rows)),
            ("sphere_accel",
             lambda: sk.sphere_accel(x, twT, force.fac32, prm),
             lambda: sk.sphere_accel_plain(x, twT, force.fac32, prm), k2_err,
             k2_work(x.shape[0], prm.lmax, prm.rows))):
        bms, by = bound_ms(byts, ops)
        out[name] = {"max_abs_err": err, "ms": cuda_ms(fn, 20),
                     "plain_ms": cuda_ms(plain, 2), "bound_ms": bms,
                     "bound_by": by, "bytes": byts, "operations": ops}
    return out


def _mf_rows(case, checks, launches, note):
    """Kernels-line rows of K1 and K2 under an MF case."""
    rows = []
    for name, src, line in (
            ("sphere_coef", "exp_tpu_torch/csrc/sphere_coef.cu",
             "exp_tpu/ops/pallas_sphere.py:521"),
            ("sphere_accel", "exp_tpu_torch/csrc/sphere_accel.cu",
             "exp_tpu/ops/pallas_sphere.py:398")):
        rows.append({"name": f"{name}[{case}]", "route": "cuda",
                     "source": src, "replaces": line,
                     "launches": launches[name], **checks[name],
                     "library_ms": None,
                     "library_note": "no single PyTorch call computes this "
                     "function", "note": note})
    return rows


def _mf_run(sim, steps=None):
    """The driver's run from a reset of every launch count: prime and run
    (single-rate) or init_state and the big steps (multistep); returns the
    launches read just after and the run's host seconds."""
    import torch

    from exp_tpu_torch import bench_composite as bc

    bc.reset_launches()
    t0 = time.perf_counter()
    if sim.M == 0:
        sim.prime()
    sim.run(steps)
    torch.cuda.synchronize()
    return bc.kernel_launches(), time.perf_counter() - t0


def _mf_timed(sim, steps):
    """Host-clock ms a step (a big step under multistep) of `steps` more."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _ms_schedule(M, nbig, n_rebuilds, centers=1, kicked=1):
    """K1's and K2's launches the multistep schedule implies for one basis
    expansion (`centers` of them: 2 for a twocenter) over `kicked`
    components' buckets (bench_composite.expected_launches' count)."""
    per, nb = 2 ** (M + 1) - 1, M + 1
    return {"sphere_coef": centers * (per * nbig + (2 + n_rebuilds) * nb),
            "sphere_accel": centers * kicked * (per * nbig + 2 * nb)}


def _want(launches, want):
    full = {k: 0 for k in launches}
    full.update(want)
    return full


def _mf_bound(cpu):
    """Three times the CPU run's drift, at least DRIFT_BOUND."""
    return max(3.0 * cpu["dE_rel"], DRIFT_BOUND)


def forces_path(dev, xe, ve, me):
    """Phases MF1-MF4 on the card: the remaining forces through the driver
    and on their own (exp_tpu_torch/bench_forces.py's configs).  Returns
    the kernels-line rows of K1 and K2 under hernq, CBsphere and
    twocenter."""
    import os
    import tempfile

    import numpy as np
    import torch

    from exp_tpu_torch import bench_forces as bf
    from exp_tpu_torch.basis.bessel import make_bessel_force
    from exp_tpu_torch.basis.model import hernquist_model, plummer_model
    from exp_tpu_torch.config import RunConfig
    from exp_tpu_torch.forces.direct import DirectForce
    from exp_tpu_torch.forces.shells import HaloBulgeForce, ShellsForce
    from exp_tpu_torch.nbody.simulation import Simulation

    f32 = dict(dtype=torch.float32, device=dev)
    rows, times = [], {}
    ex, em = edge_rows(N)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_forces_")
    wd = work.name

    def sim_of(case, cfg, sub):
        d = os.path.join(wd, sub)
        t0 = time.perf_counter()
        sim = Simulation(RunConfig.from_dict(cfg, where=case), workdir=d,
                         device=dev)
        times[f"{case.replace(' ', '_')}_build_sec"] = time.perf_counter() - t0
        return sim, d

    # MF1. hernq and CBsphere through the single-rate driver
    t0 = time.perf_counter()
    samples = {"hernq": (xe, ve, me), "CBsphere": bf.plummer_sample(N)}
    models = {"hernq": hernquist_model(rmin=1e-3, rmax=20.0),
              "CBsphere": plummer_model(rmin=1e-3, rmax=20.0)}
    times["MF1_plummer_sample_sec"] = time.perf_counter() - t0
    for kind, (xs, vs, ms) in samples.items():
        tag = f"MF1 {kind}"
        os.makedirs(os.path.join(wd, kind))
        bf.write_case_files(kind, os.path.join(wd, kind), (xs, vs, ms))
        sim, d = sim_of(tag, bf.analytic_config(kind, "out", "mf"), kind)
        force = sim.components["halo"].force
        x = torch.tensor(np.concatenate([xs, ex]), **f32)
        m = torch.tensor(np.concatenate([ms, em]), **f32)
        checks = _mf_sphere_check(tag, force, x, m)
        # tests/test_more_forces.py's bar on the card: K1's coefficients of
        # the sample, K2's field on 12 radii
        c = force.coefficients(x[:N], m[:N])
        rr = np.geomspace(0.1, 10.0, 12)
        pts = torch.tensor(np.stack([rr, 0 * rr, 0 * rr], -1), **f32)
        acc, _ = force.acceleration(c, pts)
        exact = models[kind].get_mass(rr) / rr ** 2
        bar = float(np.median(np.abs(-acc[:, 0].double().cpu().numpy()
                                     / exact - 1.0)))
        launches, t_run = _mf_run(sim)
        _, rep = bf.outlog_report(os.path.join(d, "out", "OUTLOG.mf"),
                                  kind)
        times[f"MF1_{kind}_step_ms"] = _mf_timed(sim, MF_TIMED_STEPS)
        cpu = MF1_CPU[kind]
        bound = _mf_bound(cpu)
        want = _want(launches, {"sphere_coef": STEPS + 1,
                                "sphere_accel": STEPS + 1})
        print(f"{tag} single-rate driver: " + json.dumps({
            **rep, "bar_median": bar, "launches": launches,
            "expected_launches": want, "run_sec": t_run, "cpu": cpu,
            "dE_bound": bound}), flush=True)
        if not (rep["finite"] and rep["rows"] == STEPS + 1):
            raise AssertionError(f"{tag}: {rep['rows']} OUTLOG rows, finite "
                                 f"{rep['finite']}")
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, expected "
                                 f"{want}")
        if not bar < MF1_BAR:
            raise AssertionError(f"{tag}: median |a_R / (M/r^2) - 1| = "
                                 f"{bar} exceeds {MF1_BAR}")
        if not rep["dE_rel"] < bound:
            raise AssertionError(f"{tag}: |dEtot/Etot| = {rep['dE_rel']} "
                                 f"exceeds {bound}")
        for key in ("virial0", "virial1"):
            if not abs(rep[key] - cpu[key]) <= MF1_VIRIAL_ATOL:
                raise AssertionError(f"{tag}: 2T/VC {key} = {rep[key]}, the "
                                     f"CPU's {cpu[key]}")
        rows += _mf_rows(kind, checks, launches,
                         f"{tag}: the single-rate driver, {STEPS} steps")
        del sim, force, x, m, c

    # MF1. bessel (gather, no kernel) on the sample scaled into rmax 1: f32
    # against f64, and the f32 field of the f64 coefficients (the error of
    # the evaluation alone)
    t0 = time.perf_counter()
    xb = xe / 20.0
    fb, cb, xt = {}, {}, {}
    for dt in (torch.float32, torch.float64):
        fb[dt] = make_bessel_force(4, 10, 1.0, numr=2000, dtype=dt,
                                   device=dev)
        xt[dt] = torch.tensor(xb, dtype=dt, device=dev)
        cb[dt] = fb[dt].coefficients(xt[dt], torch.tensor(me, dtype=dt,
                                                          device=dev),
                                     accum_dtype=dt)
    a64, p64 = fb[torch.float64].acceleration(cb[torch.float64],
                                              xt[torch.float64][:BESSEL_N])
    f32b = fb[torch.float32]
    pts = xt[torch.float32][:BESSEL_N]
    a32, p32 = f32b.acceleration(cb[torch.float32], pts)
    a32e, _ = f32b.acceleration(cb[torch.float64].float(), pts)
    torch.cuda.synchronize()
    da = (a32.double() - a64).abs().max(dim=1).values
    worst = int(torch.argmax(da))
    brep = {"acc_rel": float(da.max() / a64.abs().max()),
            "pot_rel": float((p32.double() - p64).abs().max()
                             / p64.abs().max()),
            "coef_rel": float((cb[torch.float32].double()
                               - cb[torch.float64]).abs().max()
                              / cb[torch.float64].abs().max()),
            "acc_rel_eval_only": float((a32e.double() - a64).abs().max()
                                       / a64.abs().max()),
            "worst_r": float(xt[torch.float64][worst].norm()),
            "worst_abs_a": float(a64[worst].abs().max()),
            "median_rel": float(torch.median(da / a64.norm(dim=1)))}
    times["MF1_bessel_sec"] = time.perf_counter() - t0
    print(f"MF1 bessel (gather) f32 vs f64 at {BESSEL_N} (tolerance acc "
          f"{BESSEL_ACC_RTOL:.0e}, pot {BESSEL_POT_RTOL:.0e}, median "
          f"{BESSEL_MEDIAN_RTOL:.0e}): " + json.dumps(brep), flush=True)
    if not (brep["acc_rel"] <= BESSEL_ACC_RTOL
            and brep["pot_rel"] <= BESSEL_POT_RTOL
            and brep["median_rel"] <= BESSEL_MEDIAN_RTOL):
        raise AssertionError(f"MF1 bessel: f32 off f64: {brep}")
    del fb, cb, xt, a32, p32, a64, p64, a32e

    # MF2. twocenter on the lopsided system at 2^20
    t0 = time.perf_counter()
    xl, vl, ml, off, com = bf.lopsided_sample(N)
    times["MF2_sample_sec"] = time.perf_counter() - t0
    os.makedirs(os.path.join(wd, "tc"))
    os.makedirs(os.path.join(wd, "tcms"))
    for sub in ("tc", "tcms"):
        bf.write_case_files("twocenter", os.path.join(wd, sub), (xl, vl, ml))
    sim, d = sim_of("MF2", bf.twocenter_config("out", "mf", 0, bf.TC_STEPS),
                    "tc")
    tcf = sim.components["sys"].force.with_centers(
        torch.tensor(off, **f32), torch.tensor(com, **f32))
    xt = torch.tensor(xl, **f32)
    mt = torch.tensor(ml, **f32)
    mix = tcf.mixture(xt)
    checks = {}
    for part, sub, c_, w in (("inner", tcf.inner, tcf.c1, 1 - mix),
                             ("outer", tcf.outer, tcf.c2, mix)):
        checks[part] = _mf_sphere_check(f"MF2 {part}", sub,
                                        (xt - c_).contiguous(),
                                        (mt * w).contiguous())
    # tests/test_twocenter.py:39's bar against the direct sum
    single = tcf.inner
    cs = single.coefficients(xt - torch.tensor(com, **f32), mt)
    ct = tcf.coefficients(xt, mt)
    direct = DirectForce(eps=1e-3, kernel="plummer")
    rng = np.random.default_rng(2)
    regions = {"cusp": off + rng.normal(0, 0.3, (150, 3)),
               "env": rng.normal(0, 2.0, (150, 3))}
    errs = {}
    xs64 = torch.tensor(xl, dtype=torch.float64, device=dev)
    ms64 = torch.tensor(ml, dtype=torch.float64, device=dev)
    for name, pts in regions.items():
        p64 = torch.tensor(pts, dtype=torch.float64, device=dev)
        a_ref, _ = direct.acceleration((xs64, ms64), p64)
        scale = a_ref.norm(dim=1)
        p32 = p64.float()
        a1, _ = single.acceleration(cs, p32 - torch.tensor(com, **f32))
        a2, _ = tcf.acceleration(ct, p32)
        errs[name] = [float(np.median(((a.double() - a_ref).norm(dim=1)
                                       / scale).cpu().numpy()))
                      for a in (a1, a2)]
    del xs64, ms64
    (e1c, e2c), (e1e, e2e) = errs["cusp"], errs["env"]
    launches_sr, t_run = _mf_run(sim)
    ke_sr = float(sim._diag["sys"]["KE"])
    fin_sr = all(bool(torch.isfinite(t).all()) for t in (
        sim._state["sys"].x, sim._state["sys"].v))
    times["MF2_step_ms"] = _mf_timed(sim, MF_TIMED_STEPS)
    want_sr = _want(launches_sr, {"sphere_coef": 2 * (bf.TC_STEPS + 1),
                                  "sphere_accel": 2 * (bf.TC_STEPS + 1)})
    del sim
    simm, _ = sim_of("MF2 multistep", bf.twocenter_config(
        "out", "mf", 2, bf.TC_NBIG), "tcms")
    launches_ms, t_run_ms = _mf_run(simm)
    ke_ms = float(simm._diag["sys"]["KE"])
    fin_ms = _finite_buckets(simm)
    want_ms = _want(launches_ms, _ms_schedule(
        2, bf.TC_NBIG, simm._ms_runner.n_rebuilds, centers=2))
    times["MF2_bigstep_ms"] = _mf_timed(simm, 2)
    rep = {"errors": {"cusp_single": e1c, "cusp_twocenter": e2c,
                      "env_single": e1e, "env_twocenter": e2e},
           "single_rate": {"launches": launches_sr,
                           "expected_launches": want_sr, "KE": ke_sr,
                           "finite": fin_sr, "run_sec": t_run},
           "multistep": {"launches": launches_ms,
                         "expected_launches": want_ms, "KE": ke_ms,
                         "finite": fin_ms, "run_sec": t_run_ms,
                         "rebuilds": simm._ms_runner.n_rebuilds}}
    print("MF2 twocenter: " + json.dumps(rep), flush=True)
    if not (e2c < TC_CUSP_RATIO * e1c and e2c < TC_CUSP_MAX
            and e2e < TC_ENV_RATIO * e1e):
        raise AssertionError(f"MF2: the two-center bar fails: {errs}")
    if launches_sr != want_sr or launches_ms != want_ms:
        raise AssertionError(f"MF2: launches {launches_sr} / {launches_ms}, "
                             f"expected {want_sr} / {want_ms}")
    if not (fin_sr and fin_ms and ke_sr > 0 and ke_ms > 0):
        raise AssertionError(f"MF2: finite {fin_sr}, {fin_ms}; KE {ke_sr}, "
                             f"{ke_ms}")
    both = {k: launches_sr[k] + launches_ms[k] for k in launches_sr}
    rows += _mf_rows("twocenter", checks["inner"], both,
                     f"MF2: the inner expansion's inputs; launches of the "
                     f"single-rate run ({launches_sr['sphere_coef']}, "
                     f"{launches_sr['sphere_accel']}) and the multistep run "
                     f"({launches_ms['sphere_coef']}, "
                     f"{launches_ms['sphere_accel']})")
    del simm, tcf, single, xt, mt, mix, cs, ct

    # MF3a. DirectForce at DIRECT_N bodies, f32 against f64 on the card
    mod = plummer_model(a=0.5, M=1.0, rmin=1e-3, rmax=5.0)
    kinds = {"plummer": dict(eps=0.01, kernel="plummer"),
             "spline": dict(eps=0.05, kernel="spline"),
             "mn": dict(mn_model=True, a=0.8, b=0.2),
             "pm": dict(eps=1e-3, kernel="plummer")}
    rep = {}
    for kind, kw in kinds.items():
        out = {}
        for dt in (torch.float32, torch.float64):
            f = (DirectForce.with_pm_model(mod, device=dev, **kw)
                 if kind == "pm" else DirectForce(**kw).to(dev))
            xs = torch.tensor(xe[:DIRECT_N], dtype=dt, device=dev)
            ms = torch.tensor(me[:DIRECT_N], dtype=dt, device=dev)
            out[dt] = f.acceleration(f.coefficients(xs, ms), xs)
        (a32, p32), (a64, p64) = out[torch.float32], out[torch.float64]
        rep[kind] = {
            "acc_rel": float((a32.double() - a64).abs().max()
                             / a64.abs().max()),
            "pot_rel": float((p32.double() - p64).abs().max()
                             / p64.abs().max()),
            "finite": bool(torch.isfinite(a32).all())}
    f = DirectForce(**kinds["plummer"])
    xs = torch.tensor(xe[:DIRECT_N], **f32)
    ms = torch.tensor(me[:DIRECT_N], **f32)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    direct_ms = cuda_ms(lambda: f.acceleration((xs, ms), xs), 3)
    peak = torch.cuda.max_memory_allocated(dev) - base
    rep["eval_ms"] = direct_ms
    rep["tmp_bytes_cap"] = f.tmp_bytes
    rep["peak_bytes"] = peak
    rep["target_chunk"] = f.target_chunk(DIRECT_N, torch.float32)
    print(f"MF3a direct at {DIRECT_N}: " + json.dumps(rep), flush=True)
    for kind in kinds:
        r = rep[kind]
        if not (r["finite"] and r["acc_rel"] <= DIRECT_ACC_RTOL
                and r["pot_rel"] <= DIRECT_POT_RTOL):
            raise AssertionError(f"MF3a {kind}: f32 off f64: {r}")
    del xs, ms

    # MF3b. the halo and a one-body bh under direct at multistep 4
    os.makedirs(os.path.join(wd, "bh"))
    bf.write_case_files("bh", os.path.join(wd, "bh"), (xe, ve, me))
    sim, d = sim_of("MF3b", bf.bh_config("out", "mf"), "bh")
    launches, t_run = _mf_run(sim)
    _, rep = bf.outlog_report(os.path.join(d, "out", "OUTLOG.mf"), "bh")
    fin = _finite_buckets(sim)
    want = _want(launches, _ms_schedule(bf.BH_M, bf.BH_NBIG,
                                        sim._ms_runner.n_rebuilds, kicked=2))
    times["MF3b_bigstep_ms"] = _mf_timed(sim, 2)
    bound = _mf_bound(MF3B_CPU)
    sim._sync_flat_state()
    bh = sim._state["bh"]
    rep.update(launches=launches, expected_launches=want, finite_state=fin,
               rebuilds=sim._ms_runner.n_rebuilds, run_sec=t_run,
               cpu=MF3B_CPU, dE_bound=bound,
               bh_x=bh.x[bh.mass > 0].double().cpu().numpy().tolist())
    print("MF3b halo + bh (direct) at multistep 4: " + json.dumps(rep),
          flush=True)
    if not (fin and rep["finite"]):
        raise AssertionError("MF3b: non-finite state or OUTLOG")
    if launches != want:
        raise AssertionError(f"MF3b: launches {launches}, expected {want}")
    if not rep["dE_rel"] < bound:
        raise AssertionError(f"MF3b: the halo's |dEtot/Etot| = "
                             f"{rep['dE_rel']} exceeds {bound}")
    del sim, bh

    # MF4. shells and halobulge at 2^20, the card and the CPU
    r = np.linalg.norm(xe, axis=1)
    sel = np.nonzero((r >= 0.05) & (r <= 9.5))[0][:MF4_PTS]
    rp = r[sel]
    exact = models["hernq"].get_mass(rp) / rp ** 2
    rep = {}
    for name in ("shells", "halobulge"):
        res = {}
        for where in ("cpu", "card"):
            device = torch.device("cpu") if where == "cpu" else dev
            force = (ShellsForce() if name == "shells" else
                     HaloBulgeForce.from_model(models["hernq"],
                                               device=device))
            xt = torch.tensor(xe, dtype=torch.float32, device=device)
            mt = torch.tensor(me, dtype=torch.float32, device=device)
            c = force.coefficients(xt, mt)
            a, _ = force.acceleration(c, xt[sel])
            a = a.double().cpu().numpy()
            aR = -(a * xe[sel]).sum(1) / rp
            res[where] = (a, float(np.median(np.abs(aR / exact - 1.0))))
            if where == "card":
                res["ms"] = cuda_ms(lambda: force.acceleration(
                    force.coefficients(xt, mt), xt), 5)
        (ac, mc), (ag, mg) = res["cpu"], res["card"]
        rep[name] = {"card_vs_cpu": float(np.abs(ag - ac).max()
                                          / np.abs(ac).max()),
                     "median_dev_card": mg, "median_dev_cpu": mc,
                     "ms_2^20": res["ms"]}
    rep["times"] = times
    print("MF4 shells, halobulge at 2^20; MF1-MF3 times (host clock): "
          + json.dumps(rep), flush=True)
    for name in ("shells", "halobulge"):
        q = rep[name]
        if not (q["card_vs_cpu"] <= MF4_RTOL
                and q["median_dev_card"] <= 1.5 * q["median_dev_cpu"] + 1e-6):
            raise AssertionError(f"MF4 {name}: {q}")
    work.cleanup()
    return rows


def sweep_path(dev, sphere_tables, disk_tables, rows):
    """Phase KS on the card: K1 and K2 ('spline' and 'hat'), K4 and K5 on
    the sphere and disk benches' samples cut to bench_kernels.SWEEP_SIZES
    rows, the last a padding row (zero mass, at the origin) as in a bucket;
    at each size each against its plain version, and bit for bit against
    the same rows padded to twice as many (each kernel's output on a row
    depends on that row alone: K2, K5; or on the rows in order, with zero
    rows adding exactly nothing: K1); then each timed (device time a launch
    by CUDA events around KS_REPS launches queued behind a spin kernel, and
    by CUDA events over launches in a row) beside its bound, and the device
    times fitted to a fixed cost a launch plus a cost a row.  Adds the
    sweep to the kernels line's rows of these kernels (`rows`)."""
    import torch

    from exp_tpu_torch import bench_kernels as bk

    forces = bk.samples(dev, sphere_tables, disk_tables)
    fns = bk.kernel_fns(forces)
    prms = {key: f._kernel_params() for key, (f, _, _) in forces.items()}

    def work(key, x, m):
        p = prms[key]
        if key in ("K1", "K1hat"):
            rs = (x.norm(dim=1) + 1e-10) / p.scale
            n_in = int(((rs >= p.rmin) & (rs <= p.rmax) & (m > 0)).sum())
            return k1_work(x.shape[0], n_in, p.lmax, p.nmax, p.rows,
                           p.interp)
        if key in ("K2", "K2hat"):
            return k2_work(x.shape[0], p.lmax, p.rows, p.interp)
        kx = 3 if p.interp == "spline" else 2
        if key == "K5":
            return k5_work(x.shape[0], p.mmax, p.xrows, p.ncy, kx)
        n_in = int(((x.norm(dim=1) <= p.rmax_grid) & (m > 0)).sum())
        return k4_work(x.shape[0], n_in, p.mmax, p.xrows, p.ncy, kx)

    def agrees(key, out, ref):
        if key in ("K1", "K1hat", "K4"):
            rtol = CYL_COEF_RTOL if key == "K4" else COEF_RTOL
            return float((out - ref).abs().max()) <= \
                rtol * float(ref.abs().max())
        (a, p), (a0, p0) = out, ref
        if key == "K5":     # atol relative to the field's largest value
            aa = CYL_ACC_ATOL_REL * float(a0.abs().max())
            pa = CYL_POT_ATOL_REL * float(p0.abs().max())
            ar, pr = CYL_ACC_RTOL, CYL_POT_RTOL
        else:
            aa, pa, ar, pr = ACC_ATOL, POT_ATOL, ACC_RTOL, POT_RTOL
        return (bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
                and bool(((a - a0).abs() <= aa + ar * a0.abs()).all())
                and bool(((p - p0).abs() <= pa + pr * p0.abs()).all()))

    def same(key, out, padded, n):
        if key in ("K1", "K1hat", "K4"):
            return key == "K4" or torch.equal(out, padded)
        return (torch.equal(out[0], padded[0][:n])
                and torch.equal(out[1], padded[1][:n]))

    bad, bounds = [], {}
    for key, (fn, plain) in fns.items():
        _, x, m = forces[key]
        for n in bk.SWEEP_SIZES:
            xb, mb = bk.bucket(x, m, n)
            out, ref = fn(xb, mb), plain(xb, mb)
            torch.cuda.synchronize()
            xp, mp = bk.bucket(x, m, n, cap=2 * n + 64)
            if not (agrees(key, out, ref) and same(key, out, fn(xp, mp), n)):
                bad.append(f"{key} n={n}")
            bounds[key, n] = bound_ms(*work(key, xb, mb))
    res = bk.sweep(forces, reps=KS_REPS)
    for r in res["rows"]:
        r["bound_ms"], r["bound_by"] = bounds[r["kernel"], r["n"]]
        print(f"KS {r['kernel']} n={r['n']}: {r['device_ms']:.4f} ms device "
              f"time a launch (queued), {r['event_ms']:.4f} ms a launch by "
              f"CUDA events over {r['event_reps']} in a row, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
    for key, f in res["fit"].items():
        print(f"KS {key} fit: {f['fixed_ms'] * 1e3:.2f} us a launch + "
              f"{f['ms_per_row'] * 1e6:.4f} us a 1,000 rows", flush=True)
    if bad:
        raise AssertionError(f"KS: kernels disagree with their plain versions"
                             f" or change under padding: {bad}")
    for row in rows:
        key = {"sphere_coef": "K1", "sphere_coef[hat]": "K1hat",
               "sphere_accel": "K2", "sphere_accel[hat]": "K2hat",
               "cyl_coef": "K4", "cyl_accel": "K5"}.get(row["name"])
        if key:
            row["sweep"] = [{k: r[k] for k in ("n", "device_ms", "event_ms",
                                               "bound_ms")}
                            for r in res["rows"] if r["kernel"] == key]
            row["sweep_fixed_ms"] = res["fit"][key]["fixed_ms"]
            row["sweep_ms_per_row"] = res["fit"][key]["ms_per_row"]


def phasestream_path(dev):
    """Phases PS1-PS2 on the card: P1 against its plain version, then the
    probe's own run timed.  Returns the kernels-line rows of P1."""
    import numpy as np
    import torch

    from exp_tpu_torch import probe_slab_phasestream as probe
    from exp_tpu_torch.ops import slab_kernels as lk

    # PS1. P1 against its plain version at 2^20 particles, edge rows last:
    # zero mass, |z| > zmax of both signs, z exactly +-zmax
    prm = probe.probe_params()
    xs, ms = probe.probe_sample(P1_N)
    zmax = np.float32(probe.ZMAX)
    xs[-5:, 2] = [0.01, 0.3, -0.25, zmax, -zmax]
    ms[-5] = 0.0
    x = torch.tensor(xs, device=dev)
    m = torch.tensor(ms, device=dev)
    kn = torch.arange(prm.C, device=dev) != (prm.C - 1) // 2
    errs, bad = {}, []
    for split in (False, True):
        ph = lk.phase_table(x, prm, split)
        errs[split] = 0.0
        for n in (P1_N, P1_N - 3):      # 16-byte loads, then element loads
            xn, mn = x[:n], m[:n]
            phn = ph if n == P1_N else ph[:, :n].contiguous()
            G = lk.stream_coef(phn, xn, mn, prm)
            G0 = lk.stream_coef_plain(phn, xn, mn, prm)
            torch.cuda.synchronize()
            dG = (G - G0).abs()
            rel = float(dG.max()) / float(G0.abs().max())
            rel_kn = float(dG[kn].max()) / float(G0[kn].abs().max())
            again = bool(torch.equal(G, lk.stream_coef(phn, xn, mn, prm)))
            errs[split] = max(errs[split], float(dG.max()))
            print(f"PS1 P1 {'stream2' if split else 'stream1'} n={n} vs "
                  f"plain: max|dG|/max|G| = {rel:.3e} (tolerance "
                  f"{P1_RTOL:.0e}), k != 0 rows {rel_kn:.3e} (tolerance "
                  f"{P1_KN_RTOL:.0e}); repeatable {again}", flush=True)
            if not (rel <= P1_RTOL and rel_kn <= P1_KN_RTOL and again):
                bad.append(f"split={split} n={n}")
        for rows, nonzero in ((slice(-5, -2), False), (slice(-2, None), True)):
            xr, mr = x[rows].contiguous(), m[rows].contiguous()
            g = lk.stream_coef(lk.phase_table(xr, prm, split), xr, mr, prm)
            if (float(g.abs().max()) > 0.0) != nonzero:
                bad.append(f"split={split} edge rows {rows}")
        del ph
    print(f"PS1 P1 edge rows: zero-mass and |z| > zmax rows give 0, rows at "
          f"+-zmax count: {not any('edge' in b for b in bad)}", flush=True)
    if bad:
        raise AssertionError(f"PS1: P1 disagrees with its plain version: "
                             f"{bad}")

    # PS2. the probe's run: producer + P1, P1 alone, the producer, the
    # yardstick and K9 at the same particles, by CUDA events
    rows = []
    n_in = int(((m > 0) & (x[:, 2].abs() <= prm.zmax)).sum())
    kz = 3 if prm.interp == "spline" else 2
    for variant, split in probe.VARIANTS.items():
        lk.reset_launch_counts()
        out = probe.bench(n=P1_N, reps=P1_REPS, device=dev,
                          variants=(variant,))
        torch.cuda.synchronize()
        count = lk.launch_counts["slab_phasestream"]
        k9, r = out[0], out[1]
        byts, ops = p1_work(P1_N, n_in, prm.C, prm.zrows, kz, split)
        bms, by = bound_ms(byts, ops)
        # the producer writes the padded table (2 Cr or 4 Cr rows) and
        # reads x and y; producer + P1 move both
        prod_bytes = P1_N * (8 + 2 * (4 if split else 2) * lk.phase_rows(prm))
        ph = lk.phase_table(x, prm, split)
        row = {
            "name": f"slab_phasestream[{'stream2' if split else 'stream1'}]",
            "route": "cuda", "source": "exp_tpu_torch/csrc/slab_phasestream.cu",
            "replaces": "scripts/probe_slab_phasestream.py:128",
            "launches": count, "max_abs_err": errs[split],
            "ms": r["kernel_ms"],
            "plain_ms": cuda_ms(lambda: lk.stream_coef_plain(ph, x, m, prm),
                                3),
            "bound_ms": bms, "bound_by": by, "library_ms": r["library_ms"],
            "library_note": "torch.matmul of the bf16 table with a prebuilt "
                            "bf16 Wz^T (N, zrows): the contraction alone, "
                            "without building Wz",
            "bytes": byts, "operations": ops,
            "producer_plus_kernel_ms": r["ms"], "producer_ms": r["producer_ms"],
            "producer_plus_kernel_bound_ms": (prod_bytes + byts)
            / HBM_BYTES_PER_S * 1e3,
            "k9_ms": k9["ms"], "max_err_vs_f64": r["max_err"],
            "k9_max_err_vs_f64": k9["max_err"]}
        del ph
        rows.append(row)
        print(f"PS2 {variant}: " + json.dumps(row), flush=True)
        if count == 0:
            raise AssertionError(f"PS2: the probe's {variant} run launched "
                                 "no P1")
    return rows


# ---------------------------------------------------------------------------
# RI1, EN1, EN2, MD1, MD2: the incremental relevel, the energy bars and the
# multi-rank runs
# ---------------------------------------------------------------------------

# RI1: the composite from CM1's ICs, RI_NBIG big steps with a relevel
# each under 'incremental' and under 'sortfull' (relevel_path).  The same
# configuration through the plain versions on a CPU at 65,536 + 16,384
# particles (its 10 relevels: 2 moved the movers only, 8 compacted) gave
# the same live sets and x, v, acc, pot equal bit for bit; the card's K1
# and K4 add block partials of other rows after a relevel that moved
# rows, so the two runs may part by rounding, and the gate is taken in
# lockstep: each relevel both ways from one state.
RI_NBIG = 10
# MD2(a): the sphere cell's 2^20 sample split 2 x 2^19 over two ranks on
# the one card (gloo), STEPS KDK steps; the coefficients of every step
# within MD2A_COEF_RTOL of max|c| of the one-rank run's.  The same pair
# through the plain versions on a CPU at 131,072 particles (the sample's
# first eighth, 2 gloo ranks against one) stayed within 7.0e-7 of max|c|
# at every step, 1-6 f32 ulps of the largest term, with no growth over
# the 50 steps (|dE/E| 1.786156e-7 both ways): each step adds the two
# ranks' f32 partials once.  5e-6 holds that with a 7x margin and fails a
# rank that drops or doubles 1e-5 of the mass.
MD2A_COEF_RTOL = 5e-6
# MD2(b): the flagship run config (R2's, with OutMulti) through `run.py
# --ndev 2`, DRIVER_NBIG big steps, against MD1's one-rank run.  The same
# pair through the plain versions on a CPU at 65,536 + 16,384 particles
# (`run.py --cpu` and `--cpu --ndev 2` on write_bodies' files of
# bench_composite.prepare(65536, 16384)) gave OUTLOG's mass, L, KE, PE,
# VC, E and 2T/VC columns within 1.8e-6 of each other (energies 8.5e-7),
# R and V (sums of +- terms near 0) within 3.5e-9 absolutely, and the
# same level populations.  The f32 sums run over 16x more rows here, and
# rounding sends particles near a level boundary to the other level
# (CM2's note); the bounds hold the CPU's figures with a 5-30x margin, and
# the level share allows ~26 disk particles.  The L columns are held over
# the largest |L| of their block (bench_multirank.outlog_difference): on
# the card, over each column's own largest value, the disk's L(x) and L(y)
# (near-0 remainders of terms as large as its L(z)) read 7.8e-6, 9.3e-7
# and 9.0e-6 for DiskHalo seeds 3, 4 and 5, 1.1x from the bound, while
# every other column stayed near the CPU's figures.
MD2B_LOG_RTOL = 1e-5
MD2B_LOG_ATOL = 1e-7
MD2B_LEVEL_SHARE = 1e-4
#: big steps of MD2(b)'s restart from its own PSP snapshot
MD2B_RESTART_NBIG = 3


def _bucket_rows(tag, kernels, st, launches):
    """kernels-line rows of the composite's kernels on the buckets `st`
    (phase CM3's way, without the profiler): each against its plain
    version on every bucket, a launch on each level's bucket timed by CUDA
    events behind a spin kernel, averaged over a big step's launches (level
    l launches 2^l times), its plain version's time and the bound the same
    way; `launches` are the wrapper counts of the phase's run.  A
    component `st` does not hold is left out."""
    from exp_tpu_torch import bench_kernels as bk

    rows, bad = [], []
    for name, wrapper, src, line, comps, fn, plain, work, check in kernels:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
               "operations": 0}
        nl, err = 0, 0.0
        for c in comps:
            for l, b in enumerate(st.get(c, ())):
                ok, e = check(fn(b), plain(b))
                err = max(err, e)
                if not ok:
                    bad.append(f"{name} {c} level {l}")
                byts, ops_ = work(b)
                w = 2 ** l
                nl += w
                tot["ms"] += w * bk.queued_ms(lambda: fn(b), CM3_LEVEL_REPS)
                tot["plain_ms"] += w * cuda_ms(lambda: plain(b), 1)
                tot["bound_ms"] += w * bound_ms(byts, ops_)[0]
                tot["bytes"] += w * byts
                tot["operations"] += w * ops_
        rows.append({
            "name": name.replace("[composite]", f"[{tag}]"), "route": "cuda",
            "source": f"exp_tpu_torch/csrc/{src}", "replaces": line,
            "launches": launches[wrapper], "max_abs_err": err,
            "ms": tot["ms"] / nl, "plain_ms": tot["plain_ms"] / nl,
            "bound_ms": tot["bound_ms"] / nl,
            "bound_by": bound_ms(tot["bytes"], tot["operations"])[1],
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "launches_per_bigstep": nl})
    if bad:
        raise AssertionError(f"{tag}: kernels disagree with their plain "
                             f"versions on the buckets {bad}")
    return rows


def _by_indx(st, n):
    """Every field of component n's live rows, ordered by identity."""
    import torch

    f = {k: torch.cat([getattr(b, k) for b in st[n]])
         for k in ("x", "v", "acc", "pot", "mass", "indx")}
    live = f["mass"] > 0
    order = torch.argsort(f["indx"][live])
    return {k: a[live][order] for k, a in f.items()}


def _regs_diff(ra, rb):
    """max|d| / max|c| of two register sets, per component (the N halves:
    after a relevel L and N coincide)."""
    out = {}
    for n in ra:
        a = [c.reshape(-1) for c in ra[n][1]]
        b = [c.reshape(-1) for c in rb[n][1]]
        out[n] = max(float((x - y).abs().max() / y.abs().max().clamp_min(
            1e-30)) for x, y in zip(a, b))
    return out


def relevel_path(dev, comp):
    """RI1 on the card: the composite's 'incremental' relevel against
    'sortfull' from CM1's ICs, RI_NBIG big steps.  In lockstep, each of
    the incremental run's relevels is also taken by 'sortfull' from a copy
    of the same state: the live sets must agree bucket by bucket, each
    particle's x, v, acc and pot bit for bit (the relevel moves data, the
    CPU run of the same configuration gave 0 difference), and the rebuilt
    registers within K1's and K4's agreement bounds (their block partials
    sum other rows).  The sortfull run is also taken on its own; the two
    runs' end states are reported.  Returns the kernels-line rows of K1,
    K2, K4 and K5 on the incremental run's buckets."""
    import numpy as np
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch.nbody.multistep import MultistepRunner

    def runner(style):
        return MultistepRunner({"halo": comp["halo"], "disk": comp["disk"]},
                               bc.COUPLES, bc.DTIME, bc.M, dynparams=bc.DYN,
                               cap_headroom=bc.CAP_HEADROOM, fused=True,
                               rebucket_style=style)

    runs, lock = {}, {"live_sets": True, "bit_equal": True,
                      "regs_rel": {"halo": 0.0, "disk": 0.0}}
    tol = {"halo": COEF_RTOL, "disk": CYL_COEF_RTOL}
    shadow = runner("sortfull")
    for style in ("incremental", "sortfull"):
        r = runner(style)
        bc.reset_launches()
        st, regs, _, _ = r.init_state(bc.flat_systems(comp["ic"], dev))
        rel = []
        lk = {k: 0 for k in bc.kernel_launches()}  # the shadow's launches
        for _ in range(RI_NBIG):
            st, regs, coef, _ = r.bigstep(st, regs)
            if style == "incremental":
                # the same relevel by 'sortfull' from a copy of the state,
                # its launches kept out of the run's count
                before = bc.kernel_launches()
                shadow.caps = dict(r.caps)
                st_b, regs_b = shadow.relevel(_clone_state(st), regs)
                for k, v in bc.kernel_launches().items():
                    lk[k] += v - before[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, regs = r.relevel(st, regs)
            torch.cuda.synchronize()
            rel.append((time.perf_counter() - t0) * 1e3)
            if style == "incremental":
                for n in st:
                    for l, (a, b) in enumerate(zip(st[n], st_b[n])):
                        ia = torch.sort(a.indx[a.mass > 0]).values
                        ib = torch.sort(b.indx[b.mass > 0]).values
                        lock["live_sets"] &= bool(torch.equal(ia, ib))
                    pa, pb = _by_indx(st, n), _by_indx(st_b, n)
                    lock["bit_equal"] &= all(bool(torch.equal(pa[k], pb[k]))
                                             for k in pa)
                for n, d in _regs_diff(regs, regs_b).items():
                    lock["regs_rel"][n] = max(lock["regs_rel"][n], d)
        launches = {k: v - lk.get(k, 0) if style == "incremental" else v
                    for k, v in bc.kernel_launches().items()}
        want = {k: 0 for k in launches}
        want.update(bc.expected_launches(r, RI_NBIG))
        runs[style] = (r, st, coef, launches)
        print(f"RI1 {style}: " + json.dumps({
            "relevel_ms": float(np.median(rel)), "relevel_ms_all": rel,
            "n_rebuilds": r.n_rebuilds, "n_compactions": r.n_compactions,
            "n_fallbacks": r.n_fallbacks,
            "level_counts": r.level_counts(st), "caps": r.caps,
            "launches": launches, "expected_launches": want}), flush=True)
        if launches != want:
            raise AssertionError(f"RI1 {style}: launches {launches}, the "
                                 f"schedule implies {want}")
    print("RI1 lockstep, each relevel both ways from one state: "
          + json.dumps({**lock, "regs_tolerance": tol}), flush=True)
    if not (lock["live_sets"] and lock["bit_equal"]) or any(
            lock["regs_rel"][n] > tol[n] for n in tol):
        raise AssertionError(f"RI1: incremental differs from sortfull {lock}")
    (ri, si, ci, li), (rs, ss, _, _) = runs["incremental"], runs["sortfull"]
    end = {"bit_equal": True, "max_rel": {}, "levels_equal":
           ri.level_counts(si) == rs.level_counts(ss)}
    for n in ("halo", "disk"):
        a, b = _by_indx(si, n), _by_indx(ss, n)
        for k in ("x", "v", "acc", "pot"):
            end["max_rel"][f"{n}.{k}"] = float(
                (a[k] - b[k]).abs().max() / b[k].abs().max())
            end["bit_equal"] &= bool(torch.equal(a[k], b[k]))
    print("RI1 the two runs after {} big steps (reported): ".format(RI_NBIG)
          + json.dumps(end), flush=True)
    return _bucket_rows("RI1", _comp_kernels(comp["halo"], comp["disk"], ci),
                        si, li)


#: big steps at the end of EN1 with the subsample's true energy each (5 of
#: the script's 20, to keep the whole script inside its 1200 s with WX1-WX2
#: and IC1-IC3: each is a 65,536 x 1,048,576 pair sum, ~2.8 s)
EN1_TAIL = 5
#: gates of tests/test_energy_artifacts.py that EN1 and EN2 print but do
#: not fail on: each reads one draw of a quantity whose spread on the card
#: is wider than its bound (`python -m exp_tpu_torch.bench_energy spread`
#: and `direct --tail 20`, PERF.md's PR 17 section).  |dE_A - dE_B| read
#: 1.7e-4, 1.7e-4 / 9.7e-5 and 2.2e-3 at 1M for DiskHalo seeds 3, 4 and 5,
#: and 2.8e-6 / 2.1e-4 / 2.3e-4 at 262,144 for steps changed by 0, 1e-6
#: and 2e-6 of themselves; EN1's last-row E_sub_dir moves by up to 1e-3
#: between consecutive big steps of the last 20 (5.3e-4 to 2.2e-3).
EN_SINGLE_DRAW = ("last E_sub_dir < 1e-3", "|dE_A - dE_B| < 1e-4")


def energy_path(dev, comp):
    """EN1 and EN2 on the card: bench_energy's `direct` (with the true
    energy at each of its last EN1_TAIL big steps) and `ab` at the
    scripts' settings on CM1's forces and ICs, each gated by
    tests/test_energy_artifacts.py's gates but the EN_SINGLE_DRAW ones,
    which are printed with the rest; both run before a failure of either
    is raised."""
    import torch

    from exp_tpu_torch import bench_energy as be

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    d = be.run_direct(comp["halo"], comp["disk"], comp["ic"], dev,
                      tail=EN1_TAIL,
                      log=lambda s: print("EN1 " + s, flush=True))
    sec = time.perf_counter() - t0
    # one 65,536 x 1,048,576 pair sum on the ICs' sources
    phi = be.make_phi_direct()
    xs = torch.cat([torch.as_tensor(comp["ic"][k], dtype=torch.float32,
                                    device=dev) for k in ("xh", "xd")])
    ms = torch.cat([torch.as_tensor(comp["ic"][k], dtype=torch.float32,
                                    device=dev) for k in ("mh", "md")])
    xt = xs[::max(1, xs.shape[0] // be.NSUB)][:be.NSUB]
    pair_ms = cuda_ms(lambda: phi(xt, xs, ms), 3)
    peak = torch.cuda.max_memory_allocated(dev)
    failed = {"EN1": be.direct_gates(d)}
    print("EN1 direct: " + json.dumps({
        **{k: v for k, v in d.items() if k != "rows"},
        "rows": [{k: r[k] for k in ("t", "E_rep", "E_sub_rep", "E_sub_dir",
                                     "E_dir_est")} for r in d["rows"]],
        "pair_sum_ms": pair_ms, "pairs": int(xt.shape[0]) * int(xs.shape[0]),
        "peak_mem_bytes": peak, "sec": sec, "gates_failed": failed["EN1"]}),
        flush=True)
    t0 = time.perf_counter()
    d = be.run_ab(comp["halo"], comp["disk"], comp["ic"], dev,
                  log=lambda s: print("EN2 " + s, flush=True))
    failed["EN2"] = be.ab_gates(d)
    sec = time.perf_counter() - t0
    # reported, not gated: arm A again at dtime (1 + 1e-6), the
    # measurement's own sensitivity to a change far below B's
    a2 = be.run_arm(comp["halo"], comp["disk"], comp["ic"], dev,
                    be.DTIME * (1 + 1e-6), be.NBIG_AB, 1, be.NSUB, name="A'",
                    log=lambda s: print("EN2 " + s, flush=True))
    print("EN2 ab: " + json.dumps({
        **d, "sec": sec, "gates_failed": failed["EN2"],
        "A_at_dtime_1e-6_longer": {"dE_true": a2["dE_true"],
                                   "E1": a2["E1"]},
        "abs_dE_A_minus_A_prime": abs(d["A"]["dE_true"] - a2["dE_true"])}),
        flush=True)
    failed = {k: [g for g in v if g not in EN_SINGLE_DRAW]
              for k, v in failed.items()}
    failed = {k: v for k, v in failed.items() if v}
    if failed:
        raise AssertionError(f"energy bars: gates failed {failed}")


def multi_path(dev, sphere_tables, comp, wd, r2, xe, ve, me):
    """MD1 and MD2 on the card: a one-rank NCCL world of the YAML driver
    against R2's state (`r2`: its state after DRIVER_NBIG big steps and
    its launches), the sphere cell over two ranks on the one card (gloo)
    against one rank, and the flagship through `run.py --ndev 2` against
    MD1, with a restart (exp_tpu_torch/bench_multirank.py's worlds).  `wd`
    holds R1's body and model files.  Returns the kernels-line rows of K1
    and K2 at MD2(a)'s rows a rank and of K1, K2, K4 and K5 at MD2(b)'s
    buckets of rank 0."""
    import os

    import numpy as np
    import torch
    import yaml

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_multirank as bmr
    from exp_tpu_torch.bench_extras import outlog_rows
    from exp_tpu_torch.bench_sphere import sphere_force
    from exp_tpu_torch.nbody.particles import ParticleSystem
    from exp_tpu_torch.nbody.step import init_force_state, make_kdk_step
    from exp_tpu_torch.ops import sphere_kernels as sk
    from exp_tpu_torch.run import main as run_main

    # MD1. a one-rank NCCL world of the driver on R2's config and bodies
    cfg1 = os.path.join(wd, "md1.yml")
    with open(cfg1, "w") as f:
        yaml.safe_dump(bmr.flagship_run_config("md1"), f)
    env = {"EXP_COORDINATOR": f"127.0.0.1:{bmr.free_port()}",
           "EXP_NPROCS": "1", "EXP_PROCID": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    bc.reset_launches()
    t0 = time.perf_counter()
    try:
        sim = run_main([cfg1, "--distributed"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    launches = bc.kernel_launches()
    diff = _bucket_diff(r2["state"], sim._ms_state)
    print("MD1 one-rank NCCL world: " + json.dumps({
        "sec": time.perf_counter() - t0, "launches": launches,
        "r2_launches": r2["launches"],
        "state_vs_r2": "equal bit for bit" if diff is None else
        f"differs first in {diff}"}), flush=True)
    if diff is not None:
        raise AssertionError(f"MD1: the state differs from R2's in {diff}")
    if launches != r2["launches"]:
        raise AssertionError(f"MD1: launches {launches}, R2's "
                             f"{r2['launches']}")
    del sim

    # MD2(a). the sphere cell's sample over two ranks on this card (gloo),
    # and over NCCL on two cards where there are two
    ncard = torch.cuda.device_count()
    rows = []
    worlds = [("gloo", [str(dev), str(dev)])]
    if ncard >= 2:
        worlds.append(("nccl", ["cuda:0", "cuda:1"]))
    else:
        print(f"MD2 over NCCL on two cards: not run ({ncard} card)",
              flush=True)
    force = sphere_force(sphere_tables, dev)
    ps = ParticleSystem.from_arrays(xe, ve, me, device=dev)
    ps, c, diag = init_force_state(force, ps)
    ref = [c.clone()]
    step = make_kdk_step(force, DT)
    for _ in range(STEPS):
        ps, c, diag = step(ps)
        ref.append(c.clone())
    ref = torch.stack(ref).cpu().numpy()
    for backend, devs in worlds:
        rep = bmr.sphere_world(sphere_tables, xe, ve, me, 2, STEPS, ref=ref,
                               devs=devs, backend=backend)
        rep["tolerance"] = MD2A_COEF_RTOL
        print(f"MD2(a) sphere cell, 2 ranks ({backend}): " + json.dumps(rep),
              flush=True)
        if not rep["finite"] or not rep["ranks_equal_coefs"]:
            raise AssertionError(f"MD2(a) {backend}: non-finite state or "
                                 "the ranks' coefficients differ")
        if not rep["coef_rel_err_max"] <= MD2A_COEF_RTOL:
            raise AssertionError(f"MD2(a) {backend}: coefficients "
                                 f"{rep['coef_rel_err_max']} from the "
                                 "one-rank run's")
        for key in ("virial0", "virial1"):
            if not abs(rep[key] - 1.0) <= VIRIAL_TOL:
                raise AssertionError(f"MD2(a): 2T/VC {key} = {rep[key]}")
        if not rep["dE_rel"] < DRIFT_BOUND:
            raise AssertionError(f"MD2(a): |dEtot/Etot| = {rep['dE_rel']}")
        for r, cnt in enumerate(rep["launches"]):
            for name, n in cnt.items():
                want = STEPS + 1 if name in ("sphere_coef",
                                             "sphere_accel") else 0
                if n != want:
                    raise AssertionError(f"MD2(a) rank {r}: {name} launched "
                                         f"{n} times, expected {want}")
        if backend == "gloo":
            md2a_launches = rep["launches"][0]
    # K1 and K2 at a rank's shape (its 2^19 rows), on this process
    half = ParticleSystem.from_arrays(xe[:len(me) // 2], ve[:len(me) // 2],
                                      me[:len(me) // 2], device=dev)
    prm = force._kernel_params()
    twT = force.accel_table(torch.as_tensor(ref[-1], device=dev))
    n_in = int(((half.x.norm(dim=1) >= prm.rmin)
                & (half.x.norm(dim=1) <= prm.rmax) & (half.mass > 0)).sum())
    for name, src, line, fn, plain, (byts, ops), cmp in (
            ("sphere_coef[MD2a rank]", "sphere_coef.cu",
             "exp_tpu/ops/pallas_sphere.py:521",
             lambda: sk.sphere_coef(half.x, half.mass, force.tabc_s,
                                    force.Mp, prm),
             lambda: sk.sphere_coef_plain(half.x, half.mass, force.tabc_s,
                                          force.Mp, prm),
             k1_work(half.n, n_in, 4, 10, prm.rows), "sphere_coef"),
            ("sphere_accel[MD2a rank]", "sphere_accel.cu",
             "exp_tpu/ops/pallas_sphere.py:398",
             lambda: sk.sphere_accel(half.x, twT, force.fac32, prm),
             lambda: sk.sphere_accel_plain(half.x, twT, force.fac32, prm),
             k2_work(half.n, 4, prm.rows), "sphere_accel")):
        out, out0 = fn(), plain()
        if isinstance(out, tuple):
            err = max(float((a - b).abs().max()) for a, b in zip(out, out0))
        else:
            err = float((out - out0).abs().max())
        bms, by = bound_ms(byts, ops)
        rows.append({"name": name, "route": "cuda",
                     "source": f"exp_tpu_torch/csrc/{src}", "replaces": line,
                     "launches": md2a_launches[cmp], "max_abs_err": err,
                     "ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(plain, 3),
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "library_note": "no single PyTorch call computes this "
                                     "function"})
    del half, ps, force

    # MD2(b). the flagship through run.py --ndev 2 on this card against
    # MD1's run, then a restart of the world from its own PSP snapshot
    rep = bmr.flagship_world(wd, 2, ref_tag="md1")
    rep["tolerance"] = {"outlog_rel": MD2B_LOG_RTOL,
                        "outlog_abs_RV": MD2B_LOG_ATOL,
                        "level_share": MD2B_LEVEL_SHARE}
    print("MD2(b) run.py --ndev 2 flagship: " + json.dumps(rep), flush=True)
    log2 = outlog_rows(os.path.join(wd, "many", "OUTLOG.flag"))
    nlev = sum(1 for ln in open(os.path.join(wd, "many", "flag.levels"))
               if not ln.startswith("#"))
    reps = rep["runs"]["many"]["reports"]
    if rep["rows"] != [DRIVER_NBIG + 1] * 2 or nlev != 2 * (DRIVER_NBIG + 1):
        raise AssertionError(f"MD2(b): a file was not written once: OUTLOG "
                             f"rows {rep['rows']}, {nlev} levels rows")
    if not (rep["outlog_max_rel"] <= MD2B_LOG_RTOL
            and rep["outlog_max_abs_RV"] <= MD2B_LOG_ATOL):
        raise AssertionError(f"MD2(b): OUTLOG {rep['outlog_max_rel']} (R, V: "
                             f"{rep['outlog_max_abs_RV']}) from MD1's")
    if not rep["level_share_max"] <= MD2B_LEVEL_SHARE:
        raise AssertionError(f"MD2(b): a level's population moved "
                             f"{rep['level_share_max']} of its component "
                             "from MD1's")
    if len(reps) != 2:
        raise AssertionError(f"MD2(b): {len(reps)} rank reports")
    cfg3 = os.path.join(wd, "many_restart.yml")
    with open(cfg3, "w") as f:
        yaml.safe_dump(bmr.flagship_run_config(
            "many", MD2B_RESTART_NBIG, infile=f"OUT.flag.{DRIVER_NBIG:05d}"),
            f)
    t0 = time.perf_counter()
    bmr.run_cli(["--ndev", "2", cfg3])
    log2b = outlog_rows(os.path.join(wd, "many", "OUTLOG.flag"))
    etot = log2b[:, 12] + log2b[:, 13]
    rep = {"sec": time.perf_counter() - t0, "rows": len(log2b),
           "t_last": float(log2b[-1, 0]), "t_before": float(log2[-1, 0]),
           "dE_rel": float(abs(etot[-1] - etot[0]) / abs(etot[0]))}
    print("MD2(b) restart from OUT.flag.00010: " + json.dumps(rep),
          flush=True)
    if len(log2b) != DRIVER_NBIG + 1 + 1 + MD2B_RESTART_NBIG:
        raise AssertionError(f"MD2(b) restart: {len(log2b)} OUTLOG rows")
    if not log2b[-1, 0] > log2[-1, 0] + (MD2B_RESTART_NBIG - 0.5) * bc.DTIME:
        raise AssertionError("MD2(b) restart: the time did not advance")
    if not rep["dE_rel"] < DRIVER_DRIFT_BOUND:
        raise AssertionError(f"MD2(b) restart: |dEtot/Etot| {rep['dE_rel']}")

    # K4 and K5 (and K1, K2) at a rank's buckets: rank 0's row block of
    # the ICs cut into its final capacities and live counts
    r0 = next(r for r in reps if r["rank"] == 0)
    ic = comp["ic"]
    st = {}
    for n, (kx, kv, km) in (("halo", ("xh", "vh", "mh")),
                            ("disk", ("xd", "vd", "md"))):
        half = len(ic[km]) // 2
        x, v, m = ic[kx][:half], ic[kv][:half], ic[km][:half]
        bs, k = [], 0
        for cap, nl in zip(r0["caps"][n], r0["live"][n]):
            xs = np.zeros((cap, 3))
            ms = np.zeros(cap)
            xs[:nl], ms[:nl] = x[k:k + nl], m[k:k + nl]
            k += nl
            bs.append(ParticleSystem.from_arrays(xs, np.zeros((cap, 3)), ms,
                                                 device=dev))
        st[n] = bs
    coef = {"halo": comp["halo"].coefficients(
        torch.cat([b.x for b in st["halo"]]),
        torch.cat([b.mass for b in st["halo"]])),
        "disk": comp["disk"].coefficients(
        torch.cat([b.x for b in st["disk"]]),
        torch.cat([b.mass for b in st["disk"]]))}
    rows += _bucket_rows("MD2b rank", _comp_kernels(comp["halo"],
                                                    comp["disk"], coef),
                         st, r0["launches"])
    return rows


# ---------------------------------------------------------------------------
# AN1, AN2, AN3: the analysis library (exp_tpu_torch/analysis, io/readers)
# ---------------------------------------------------------------------------

# AN1: AN_SNAPS snapshots of phase 5's 2^20 equilibrium sample, snapshot t
# at x (1 + 0.01 sin(0.3 t)) as tests/test_analysis.py:37 jitters its own,
# written as PSP files and read back through createReader; the sphereSL
# stanza of phase 3's tables (the model's file, lmax 4, nmax 10, numr 2000,
# backend pallas); slices of AN_SLICE^2 and volumes of AN_VOL^3 points at
# AN_TIMES of the snapshots' times; FieldBasis on AN_FB_SNAPS snapshots;
# cross_validate at AN_NTEST points, Plummer eps AN_EPS.
AN_SNAPS = 16
AN_TIMES = 4
AN_SLICE = 256
AN_VOL = 64
AN_FB_SNAPS = 2
AN_NTEST, AN_EPS = 256, 5e-3
# the pallas Basis against an f64 gather Basis of the same stanza, at
# tests/test_spherical_force.py:270-294's pallas-vs-gather bounds:
# coefficients max|dc|/max|c|, acc (rtol, atol), pot (rtol, atol), on the
# first AN_GATHER_PTS particles of snapshot 0
AN_GATHER_COEF = 5e-5
AN_GATHER_ACC = (2e-3, 2e-5)
AN_GATHER_POT = (2e-4, 1e-6)
AN_GATHER_PTS = 4096
# tests/test_analysis.py:152-154's cross-validation bounds
AN_FERR_MED, AN_PERR_MED = 0.08, 0.02
# the wake's monopole + band against the full field of the same
# coefficients: two K2 sums against one, f32 (1e-5 of max|pot|)
AN_WAKE_RTOL = 1e-5
# AN2: CM1's disk, AN_DISK_SNAPS snapshots, snapshot t turned by 0.05 t
# about z; slices of AN_SLICE^2 points at z = 0.001 over |x|, |y| <= 0.1;
# diskeof's gates as tests/test_diskeof.py:35-68: the series against K4's
# pass (rtol, atol), Urot orthogonal and each harmonic's amplitude kept
AN_DISK_SNAPS = 8
AN_EOF_RTOL, AN_EOF_ATOL = 2e-3, 2e-5
AN_ROT_TOL = 1e-12
# AN3: expMSSA's window; every eigentriple (T - window + 1 of them) gives
# the series back to f64 rounding of the SVD
AN_WINDOW = 8
AN_MSSA_REC = 1e-10
# the cube (the bench's nmax 6) and slab (the bench's tables) stanzas on
# AN_PERIODIC_N rows of their benches' samples
AN_PERIODIC_N = 1_048_576


def _plain(*sites):
    """A context in which each kernel wrapper (module, name) is replaced by
    its plain version, `name + '_plain'`: an analysis entry point then
    gives the plain versions' answer on the same inputs, on the card, and
    counts no launch."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        saved = [(mod, name, getattr(mod, name)) for mod, name in sites]
        for mod, name, _ in saved:
            setattr(mod, name, getattr(mod, name + "_plain"))
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    return swapped()


def _want_launches(tag, launches, want):
    """Fail unless each kernel launched `want`'s count (0 if unnamed)."""
    bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{tag}: launches {bad}, expected {want} and "
                             "0 for the rest")


def _field_check(tag, out, ref, acc_tol, pot_tol, rel):
    """max|d| of the fields (dens, pot, acc) `out` against `ref`, each
    element within atol + rtol |ref| (atol times the largest |ref| when
    `rel`); the density (plain torch on both sides) to 1e-12 of its
    largest.  Returns the largest |d| of acc and pot."""
    import numpy as np

    (d, p, a), (d0, p0, a0) = out, ref
    da, dp = np.abs(a - a0), np.abs(p - p0)
    sa = np.abs(a0).max() if rel else 1.0
    sp = np.abs(p0).max() if rel else 1.0
    ok = (np.isfinite(a).all() and np.isfinite(p).all()
          and np.isfinite(d).all()
          and (da <= acc_tol[1] * sa + acc_tol[0] * np.abs(a0)).all()
          and (dp <= pot_tol[1] * sp + pot_tol[0] * np.abs(p0)).all()
          and np.abs(d - d0).max() <= 1e-12 * np.abs(d0).max())
    if not ok:
        raise AssertionError(f"{tag}: max|da| {da.max()}, max|dpot| "
                             f"{dp.max()}, max|ddens| "
                             f"{np.abs(d - d0).max()}")
    return max(float(da.max()), float(dp.max()))


def _an_row(name, src, line, launches, err, fn, plain, work, reps=20):
    """A kernels-line row: the kernel's device ms by launches queued behind
    a spin kernel (bench_kernels.queued_ms), beside `event_ms` by CUDA
    events around launches in a row, which at these sizes times the host's
    enqueue; its plain version's by CUDA events."""
    from exp_tpu_torch import bench_kernels as bk

    bms, by = bound_ms(*work)
    return {"name": name, "route": "cuda",
            "source": f"exp_tpu_torch/csrc/{src}", "replaces": line,
            "launches": launches, "max_abs_err": err,
            "ms": bk.queued_ms(fn, reps), "event_ms": cuda_ms(fn, reps),
            "plain_ms": cuda_ms(plain, 3),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "bytes": work[0], "operations": work[1]}


def analysis_path(dev, comp, disk_tables, xe, ve, me):
    """Phases AN1-AN3 on the card: the analysis library's user path
    (exp_tpu_torch/analysis, io/readers.py) through K1, K2, K4 and K5, and
    K7/K8 and K9/K10 once each.  `comp` is CM1's dict (its disk ICs),
    `disk_tables` D1's, (xe, ve, me) phase 5's sample.  Returns the
    kernels-line rows of K1, K2, K4 and K5 at the analysis's shapes."""
    import os
    import tempfile

    import numpy as np
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch.analysis import diskeof, kincoefs
    from exp_tpu_torch.analysis.basis import Basis, upload
    from exp_tpu_torch.analysis.crossval import cross_validate
    from exp_tpu_torch.analysis.edmd import Koopman
    from exp_tpu_torch.analysis.field import (FieldGenerator, write_pvd,
                                              write_vtk)
    from exp_tpu_torch.analysis.field_basis import FieldBasis
    from exp_tpu_torch.analysis.mssa import expMSSA
    from exp_tpu_torch.analysis.wake import BiorthWake
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp
    from exp_tpu_torch.io.readers import createReader
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import sphere_kernels as sk

    f64 = torch.float64
    rows, host = [], {}
    torch.cuda.reset_peak_memory_stats()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_")
    wd = work.name
    n = len(me)

    # AN1. the snapshots as PSP files, read back through createReader
    times = np.arange(AN_SNAPS) * 0.1
    jit = [1.0 + 0.01 * float(np.sin(0.3 * t)) for t in range(AN_SNAPS)]
    t0 = time.perf_counter()
    for i, s in enumerate(jit):
        write_psp(os.path.join(wd, f"OUT.an.{i:05d}"), PSPDump(
            time=float(times[i]), components=[PSPComponent(
                name="halo", info="name: halo\n", mass=me, x=xe * s, v=ve,
                pot=np.zeros(n))]))
    host["psp_write_s_per_snapshot"] = (time.perf_counter() - t0) / AN_SNAPS
    reads, differ = [], []

    def snapshots():
        for i, s in enumerate(jit):
            p = os.path.join(wd, f"OUT.an.{i:05d}")
            t1 = time.perf_counter()
            snap = createReader("psp", p)
            x, v, m = snap.GetParticles("halo")
            reads.append(time.perf_counter() - t1)
            if not (snap.time == times[i] and np.array_equal(x, xe * s)
                    and np.array_equal(v, ve) and np.array_equal(m, me)):
                differ.append(i)
            os.remove(p)
            yield x, m

    hernquist_model(rmin=1e-3, rmax=20.0).to_file(
        os.path.join(wd, "halo.model"))
    stanza = ("id: sphereSL\nparameters: {modelname: halo.model, Lmax: 4, "
              "nmax: 10, numr: 2000, cmap: 1, rmapping: 1.0, "
              "backend: %s}\n")
    t0 = time.perf_counter()
    basis = Basis.factory(stanza % "pallas", workdir=wd, device=dev)
    gather = Basis.factory(stanza % "gather", workdir=wd, device=dev)
    host["basis_factory_s"] = (time.perf_counter() - t0) / 2
    force, prm = basis.force, basis.force._kernel_params()
    bc.reset_launches()
    t0 = time.perf_counter()
    coefs = basis.create_from_snapshots(snapshots(), times=times)
    torch.cuda.synchronize()
    host["create_from_snapshots_s"] = time.perf_counter() - t0
    k1_launches = bc.kernel_launches()
    print("AN1 create_from_snapshots: " + json.dumps({
        "snapshots": AN_SNAPS, "rows": n, "launches": k1_launches,
        "psp_read_s": reads, "differ": differ}), flush=True)
    if differ:
        raise AssertionError(f"AN1: snapshots {differ} read back differ "
                             "from what was written")
    _want_launches("AN1 create_from_snapshots", k1_launches,
                   {"sphere_coef": AN_SNAPS})
    A = coefs.as_array()
    xd, vd, md = (torch.as_tensor(a, device=dev) for a in (xe, ve, me))
    k1_err = k1_rel = g_rel = 0.0
    for i, s in enumerate(jit):
        with _plain((sk, "sphere_coef")):
            c0 = basis.create_coefficients(xd * s, md)
        cg = gather.create_coefficients(xd * s, md)
        k1_err = max(k1_err, float(np.abs(A[i] - c0).max()))
        k1_rel = max(k1_rel, float(np.abs(A[i] - c0).max()
                                   / np.abs(c0).max()))
        g_rel = max(g_rel, float(np.abs(A[i] - cg).max() / np.abs(cg).max()))
    P = coefs.power()
    mono = bool(np.all(P[:, 0] > 10 * P[:, 1:].sum(axis=1)))
    print(f"AN1 coefficients: K1 vs plain max|dc|/max|c| = {k1_rel:.3e} "
          f"(tolerance {COEF_RTOL:.0e}); vs the f64 gather Basis "
          f"{g_rel:.3e} (tolerance {AN_GATHER_COEF:.0e}); monopole power "
          f"over 10x the rest at every time: {mono}", flush=True)
    if not (k1_rel <= COEF_RTOL and g_rel <= AN_GATHER_COEF and mono
            and np.isfinite(A).all()):
        raise AssertionError(f"AN1: coefficients K1 {k1_rel}, gather "
                             f"{g_rel}, monopole {mono}")
    # the fields at particle positions against the f64 gather Basis
    pts = xe[:AN_GATHER_PTS]
    d, p, a = basis.get_fields(A[0], pts)
    d0, p0, a0 = gather.get_fields(A[0], pts)
    g_ok = (np.allclose(a, a0, rtol=AN_GATHER_ACC[0], atol=AN_GATHER_ACC[1])
            and np.allclose(p, p0, rtol=AN_GATHER_POT[0],
                            atol=AN_GATHER_POT[1]))
    print(f"AN1 fields vs the f64 gather Basis at {AN_GATHER_PTS} "
          f"particles: max|da| {np.abs(a - a0).max():.3e}, max|dpot| "
          f"{np.abs(p - p0).max():.3e} (acc rtol/atol {AN_GATHER_ACC}, pot "
          f"{AN_GATHER_POT}): {g_ok}", flush=True)
    if not g_ok:
        raise AssertionError("AN1: the pallas fields disagree with the "
                             "gather Basis's")
    # per snapshot: read, upload and project, on the host clock
    x1, m1 = xe * jit[0], me
    up, pr = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xu, mu = upload(dev, x1, m1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        force.coefficients(xu, mu, accum_dtype=f64)
        torch.cuda.synchronize()
        up.append(t1 - t0)
        pr.append(time.perf_counter() - t1)
    host.update({"psp_read_s_median": float(np.median(reads)),
                 "upload_s_median": float(np.median(up)),
                 "project_s_median": float(np.median(pr))})

    # slices and volumes: one K2 a time and grid
    ft = [float(t) for t in times[::AN_SNAPS // AN_TIMES][:AN_TIMES]]
    fgs = {"slice": FieldGenerator(ft, [-2, -2, 0], [2, 2, 0],
                                   [AN_SLICE, AN_SLICE, 0]),
           "volume": FieldGenerator(ft, [-2, -2, -2], [2, 2, 2],
                                    [AN_VOL] * 3)}
    rendered, k2 = {}, {}
    for kind, fg in fgs.items():
        bc.reset_launches()
        t0 = time.perf_counter()
        rendered[kind] = (fg.slices if kind == "slice" else fg.volumes)(
            basis, coefs)
        host[f"{kind}_render_s_per_time"] = (time.perf_counter() - t0) \
            / AN_TIMES
        launches = bc.kernel_launches()
        _want_launches(f"AN1 {kind}s", launches, {"sphere_accel": AN_TIMES})
        pts = fg._mesh()[0]
        err = 0.0
        for t in ft:
            f = rendered[kind][t]
            out = (f["dens"].ravel(), f["potl"].ravel(), np.stack(
                [f["accx"].ravel(), f["accy"].ravel(), f["accz"].ravel()],
                -1))
            with _plain((sk, "sphere_accel")):
                ref = basis.get_fields(coefs.interpolate(t), pts)
            err = max(err, _field_check(f"AN1 {kind} t={t}", out, ref,
                                        (ACC_RTOL, ACC_ATOL),
                                        (POT_RTOL, POT_ATOL), False))
        k2[kind] = (launches["sphere_accel"], err, pts)
        print(f"AN1 {kind}s ({len(pts)} points x {AN_TIMES} times): "
              f"launches {launches}, K2 vs plain max|d| {err:.3e} "
              f"(tolerance acc rtol {ACC_RTOL:.0e} atol {ACC_ATOL:.0e}, pot "
              f"rtol {POT_RTOL:.0e} atol {POT_ATOL:.0e})", flush=True)

    # FieldBasis: 'dens' and vx, vy, vz, one K1 each a snapshot
    fb = FieldBasis(force)
    bc.reset_launches()
    t0 = time.perf_counter()
    fser = fb.create_from_snapshots(
        [(xe * jit[i], ve, me) for i in range(AN_FB_SNAPS)])
    host["fieldbasis_s_per_snapshot"] = (time.perf_counter() - t0) \
        / AN_FB_SNAPS
    launches = bc.kernel_launches()
    _want_launches("AN1 FieldBasis", launches,
                   {"sphere_coef": 4 * AN_FB_SNAPS})
    fb_rel = float(np.abs(fser["dens"] - A[:AN_FB_SNAPS]).max()
                   / np.abs(A[:AN_FB_SNAPS]).max())
    fin = all(np.isfinite(v).all() for v in fser.values())
    print(f"AN1 FieldBasis ({AN_FB_SNAPS} snapshots): launches {launches}, "
          f"'dens' vs create_from_snapshots max|dc|/max|c| {fb_rel:.3e}, "
          f"finite {fin}", flush=True)
    if not (fin and fb_rel <= COEF_RTOL):
        raise AssertionError(f"AN1 FieldBasis: finite {fin}, dens {fb_rel}")

    # BiorthWake: the monopole and the l >= 1 band (two K2)
    spts = k2["slice"][2]
    bc.reset_launches()
    d0, dw, p0, pw = BiorthWake(force).reconstruct(A[0], spts, L1=1)
    launches = bc.kernel_launches()
    _want_launches("AN1 BiorthWake", launches, {"sphere_accel": 2})
    df, pf, _ = basis.get_fields(A[0], spts)
    w_err = float(np.abs(p0 + pw - pf).max() / np.abs(pf).max())
    wd_err = float(np.abs(d0 + dw - df).max() / np.abs(df).max())
    print(f"AN1 BiorthWake: launches {launches}, |pot0 + pot_wake - pot| "
          f"{w_err:.3e} of max|pot| (tolerance {AN_WAKE_RTOL:.0e}), dens "
          f"{wd_err:.3e}", flush=True)
    if not (w_err <= AN_WAKE_RTOL and wd_err <= 1e-12):
        raise AssertionError(f"AN1 BiorthWake: pot {w_err}, dens {wd_err}")

    # cross_validate on snapshot 0 at 2^20 (one K1, one K2; the direct sum
    # on the host)
    bc.reset_launches()
    t0 = time.perf_counter()
    cv = cross_validate(force, xe, me, ntest=AN_NTEST, eps=AN_EPS)
    host["cross_validate_s"] = time.perf_counter() - t0
    launches = bc.kernel_launches()
    _want_launches("AN1 cross_validate", launches,
                   {"sphere_coef": 1, "sphere_accel": 1})
    print("AN1 cross_validate: " + json.dumps({
        "ferr_all_med": cv["ferr_all_med"], "perr_all_med":
        cv["perr_all_med"], "bounds": [AN_FERR_MED, AN_PERR_MED],
        "launches": launches}), flush=True)
    if not (cv["ferr_all_med"] < AN_FERR_MED
            and cv["perr_all_med"] < AN_PERR_MED):
        raise AssertionError(f"AN1 cross_validate: {cv}")

    # K1 and K2 at the analysis's shapes
    x32 = torch.as_tensor(xe * jit[0], dtype=torch.float32, device=dev)
    m32 = torch.as_tensor(me, dtype=torch.float32, device=dev)
    tab, r = force._radial_table(), x32.norm(dim=1) + 1e-10
    n_in = int(((r >= prm.rmin * prm.scale) & (r <= prm.rmax * prm.scale)
                & (m32 > 0)).sum())
    rows.append(_an_row(
        "sphere_coef[AN1 snapshot]", "sphere_coef.cu",
        "exp_tpu/ops/pallas_sphere.py:521", k1_launches["sphere_coef"],
        k1_err, lambda: sk.sphere_coef(x32, m32, tab, force.Mp, prm),
        lambda: sk.sphere_coef_plain(x32, m32, tab, force.Mp, prm),
        k1_work(n, n_in, prm.lmax, prm.nmax, prm.rows)))
    twT = force.accel_table(torch.as_tensor(A[0], device=dev))
    for kind, (cnt, err, pts) in k2.items():
        p32 = torch.as_tensor(pts, dtype=torch.float32, device=dev)
        rows.append(_an_row(
            f"sphere_accel[AN1 {kind}]", "sphere_accel.cu",
            "exp_tpu/ops/pallas_sphere.py:398", cnt, err,
            lambda p32=p32: sk.sphere_accel(p32, twT, force.fac32, prm),
            lambda p32=p32: sk.sphere_accel_plain(p32, twT, force.fac32,
                                                  prm),
            k2_work(len(pts), prm.lmax, prm.rows)))
    del xd, vd, md, x32, m32, gather

    # AN2. the disk: CM1's disk particles, turned a little each snapshot
    ic = comp["ic"]
    xk, vk, mk = ic["xd"], ic["vd"], ic["md"]

    def turn(x, ang):
        c, s = np.cos(ang), np.sin(ang)
        return np.stack([c * x[:, 0] - s * x[:, 1], s * x[:, 0]
                         + c * x[:, 1], x[:, 2]], -1)

    dsnaps = [(turn(xk, 0.05 * t), mk) for t in range(AN_DISK_SNAPS)]
    dtimes = np.arange(AN_DISK_SNAPS) * 0.1
    disk = Basis(CylinderForce.from_tables(disk_tables, backend="pallas",
                                           device=dev), name="disk")
    dforce, dp = disk.force, disk.force._kernel_params()
    bc.reset_launches()
    t0 = time.perf_counter()
    dcoefs = disk.create_from_snapshots(dsnaps, times=dtimes)
    host["disk_create_from_snapshots_s"] = time.perf_counter() - t0
    k4_launches = bc.kernel_launches()
    _want_launches("AN2 create_from_snapshots", k4_launches,
                   {"cyl_coef": AN_DISK_SNAPS})
    DA = dcoefs.as_array()
    k4_err = k4_rel = 0.0
    for i, (x, m) in enumerate(dsnaps):
        with _plain((ck, "cyl_coef")):
            c0 = disk.create_coefficients(x, m)
        k4_err = max(k4_err, float(np.abs(DA[i] - c0).max()))
        k4_rel = max(k4_rel, float(np.abs(DA[i] - c0).max()
                                   / np.abs(c0).max()))
    print(f"AN2 create_from_snapshots ({AN_DISK_SNAPS} x {len(mk)}): "
          f"launches {k4_launches}, K4 vs plain max|dc|/max|c| = "
          f"{k4_rel:.3e} (tolerance {CYL_COEF_RTOL:.0e})", flush=True)
    if not (k4_rel <= CYL_COEF_RTOL and np.isfinite(DA).all()):
        raise AssertionError(f"AN2: K4 vs plain {k4_rel}")
    dfg = FieldGenerator([0.0], [-0.1, -0.1, 1e-3], [0.1, 0.1, 1e-3],
                         [AN_SLICE, AN_SLICE, 0])
    dpts = dfg._mesh()[0]
    bc.reset_launches()
    t0 = time.perf_counter()
    dout = disk.get_fields(DA[0], dpts)
    host["disk_get_fields_s"] = time.perf_counter() - t0
    k5_launches = bc.kernel_launches()
    _want_launches("AN2 get_fields", k5_launches, {"cyl_accel": 1})
    with _plain((ck, "cyl_accel")):
        dref = disk.get_fields(DA[0], dpts)
    k5_err = _field_check("AN2 get_fields", dout, dref,
                          (CYL_ACC_RTOL, CYL_ACC_ATOL_REL),
                          (CYL_POT_RTOL, CYL_POT_ATOL_REL), True)
    print(f"AN2 get_fields ({len(dpts)} points): launches {k5_launches}, "
          f"K5 vs plain max|d| {k5_err:.3e} (|a| up to "
          f"{np.abs(dref[2]).max():.3e})", flush=True)
    # diskeof on the same snapshots
    t0 = time.perf_counter()
    _, cc, ss, D = diskeof.accumulate(
        dforce, ((t, m, x) for t, (x, m) in zip(dtimes, dsnaps)))
    svals, Urot, rotC, rotS = diskeof.rotate(cc, ss, D)
    dg, pg = diskeof.rotated_grids(dforce, Urot, rotC, rotS, 2, 0.1, 64)
    host["diskeof_s"] = time.perf_counter() - t0
    eof_ok = (np.allclose(cc, DA[:, 0], rtol=AN_EOF_RTOL, atol=AN_EOF_ATOL)
              and np.allclose(ss, DA[:, 1], rtol=AN_EOF_RTOL,
                              atol=AN_EOF_ATOL))
    M1, nord = D.shape[0], D.shape[1]
    orth = max(float(np.abs(Urot[m] @ Urot[m].T - np.eye(nord)).max())
               for m in range(M1))
    amp = max(float(np.abs(np.linalg.norm(rotC[:, m], axis=1)
                           - np.linalg.norm(cc[:, m], axis=1)).max()
                    / np.linalg.norm(cc[:, m], axis=1).max())
              for m in range(M1))
    psd = all(np.allclose(D[m], D[m].T) and np.linalg.eigvalsh(D[m]).min()
              > -1e-10 * np.abs(D[m]).max() for m in range(M1))
    print(f"AN2 diskeof ({AN_DISK_SNAPS} snapshots): series vs K4's pass "
          f"max|d| {max(np.abs(cc - DA[:, 0]).max(), np.abs(ss - DA[:, 1]).max()):.3e}"
          f" (rtol {AN_EOF_RTOL:.0e} atol {AN_EOF_ATOL:.0e}): {eof_ok}; "
          f"|Urot Urot^T - I| {orth:.3e}, amplitude {amp:.3e} (tolerance "
          f"{AN_ROT_TOL:.0e}); D symmetric PSD {psd}; grids finite "
          f"{bool(np.isfinite(dg).all() and np.isfinite(pg).all())}",
          flush=True)
    if not (eof_ok and orth <= AN_ROT_TOL and amp <= AN_ROT_TOL and psd
            and np.isfinite(dg).all() and np.isfinite(pg).all()):
        raise AssertionError("AN2: diskeof's gates")
    # the kinematic series of the same particles (host NumPy)
    t0 = time.perf_counter()
    kin = (kincoefs.bess_coefs(mk, xk, vk, 0.1, mmax=4, nmax=10)
           + kincoefs.lagu_coefs(mk, xk, vk, bc.ACYL, mmax=4, nmax=10)
           + kincoefs.ring_coefs(mk, xk, vk, 0.0, 0.1, 20, mmin=1, mmax=4))
    host["kincoefs_s"] = time.perf_counter() - t0
    if not all(np.isfinite(k).all() for k in kin):
        raise AssertionError("AN2: non-finite kinematic series")
    print(f"AN2 kincoefs bess/lagu/ring: shapes "
          f"{[list(k.shape) for k in kin]}", flush=True)
    xk32 = torch.as_tensor(dsnaps[0][0], dtype=torch.float32, device=dev)
    mk32 = torch.as_tensor(mk, dtype=torch.float32, device=dev)
    kx = 3 if dp.interp == "spline" else 2
    nk_in = int(((xk32.norm(dim=1) <= dp.rmax_grid) & (mk32 > 0)).sum())
    rows.append(_an_row(
        "cyl_coef[AN2 snapshot]", "cyl_coef.cu",
        "exp_tpu/ops/pallas_cylinder.py:164", k4_launches["cyl_coef"],
        k4_err, lambda: ck.cyl_coef(xk32, mk32, dp),
        lambda: ck.cyl_coef_plain(xk32, mk32, dp),
        k4_work(len(mk), nk_in, dp.mmax, dp.xrows, dp.ncy, kx)))
    Ct = ck.contract_coef_tables(torch.as_tensor(DA[0], device=dev),
                                 dforce.tab3, dp.xrows, dp.ncy)
    dp32 = torch.as_tensor(dpts, dtype=torch.float32, device=dev)
    rows.append(_an_row(
        "cyl_accel[AN2 slice]", "cyl_accel.cu",
        "exp_tpu/ops/pallas_cylinder.py:257", k5_launches["cyl_accel"],
        k5_err, lambda: ck.cyl_accel(dp32, Ct, dp),
        lambda: ck.cyl_accel_plain(dp32, Ct, dp),
        k5_work(len(dpts), dp.mmax, dp.xrows, dp.ncy, kx)))
    del xk32, mk32, dp32, Ct, disk, dforce

    # AN3. the host side: MSSA and Koopman on AN1's series, VTK files
    t0 = time.perf_counter()
    npc = AN_SNAPS - AN_WINDOW + 1
    mssa = expMSSA({"halo": coefs}, window=AN_WINDOW, numpc=npc)
    rec = mssa.reconstruct_coefs(coefs).as_array()
    host["mssa_s"] = time.perf_counter() - t0
    rec_err = float(np.abs(rec - A).max() / np.abs(A).max())
    t0 = time.perf_counter()
    koop = Koopman({"halo": coefs}, numev=npc - 1, window=AN_WINDOW)
    kr = koop.reconstruction()
    host["koopman_s"] = time.perf_counter() - t0
    print(f"AN3 expMSSA (window {AN_WINDOW}, {mssa.nkeys} channels, "
          f"{npc} eigentriples): every group gives the series back to "
          f"{rec_err:.3e} of max|c| (tolerance {AN_MSSA_REC:.0e}); "
          f"Koopman reconstruction {list(kr.shape)} finite "
          f"{bool(np.isfinite(kr).all())}", flush=True)
    if not (rec_err <= AN_MSSA_REC and np.isfinite(kr).all()):
        raise AssertionError(f"AN3: MSSA reconstruction {rec_err}")
    t0 = time.perf_counter()
    paths = []
    for i, t in enumerate(ft):
        p = os.path.join(wd, f"an_{i:05d}.vtk")
        write_vtk(p, rendered["slice"][t], fgs["slice"].pmin,
                  fgs["slice"].pmax, axes=(0, 1))
        paths.append((t, p))
    write_pvd(os.path.join(wd, "an.pvd"), paths)
    host["vtk_write_s_per_time"] = (time.perf_counter() - t0) / AN_TIMES
    with open(paths[0][1]) as fh:
        body = fh.read().split("LOOKUP_TABLE default\n")[1].split()[:8]
    first = rendered["slice"][ft[0]]["dens"].ravel(order="F")[:8]
    vtk_ok = np.allclose([float(v) for v in body], first, rtol=1e-6)
    print(f"AN3 VTK/PVD: {len(paths)} files of {AN_SLICE}^2 points, the "
          f"first values read back within %.6e rounding: {vtk_ok}",
          flush=True)
    if not vtk_ok:
        raise AssertionError("AN3: the VTK file does not hold the slice")
    # the cube and the slab through Basis: K7/K8 and K9/K10 once each
    from exp_tpu_torch import bench_cube, bench_slab
    from exp_tpu_torch.ops import cube_kernels as cuk
    from exp_tpu_torch.ops import slab_kernels as slk

    for case, conf, sample, wrappers, ctol, ftol in (
            ("cube", {"id": "cube", "parameters": {
                "nmaxx": bench_cube.NMAX, "nmaxy": bench_cube.NMAX,
                "nmaxz": bench_cube.NMAX, "backend": "pallas"}},
             bench_cube.cube_sample(AN_PERIODIC_N, perturbed=True),
             (cuk, "cube_coef", "cube_accel"), CUBE_COEF_RTOL["perturbed"],
             CUBE_FORCE_RTOL),
            ("slab", {"id": "slabSL", "parameters": {
                "nmaxx": bench_slab.NMAXXY, "nmaxy": bench_slab.NMAXXY,
                "nmaxz": bench_slab.NMAX, "zmax": bench_slab.ZMAX,
                "hslab": bench_slab.H, "backend": "pallas"}},
             bench_slab.slab_sample(AN_PERIODIC_N), (slk, "slab_coef",
                                                     "slab_accel"),
             SLAB_COEF_RTOL, SLAB_FORCE_RTOL)):
        mod, kc, ka = wrappers
        x, _, m = sample
        b = Basis.factory(conf, workdir=wd, device=dev)
        bc.reset_launches()
        t0 = time.perf_counter()
        c = b.create_coefficients(x, m)
        f = b.get_fields(c, x[:65536])
        host[f"{case}_coef_and_fields_s"] = time.perf_counter() - t0
        launches = bc.kernel_launches()
        _want_launches(f"AN3 {case}", launches, {kc: 1, ka: 1})
        with _plain((mod, kc), (mod, ka)):
            c0 = b.create_coefficients(x, m)
            f0 = b.get_fields(c0, x[:65536])
        c_rel = float(np.abs(c - c0).max() / np.abs(c0).max())
        a_rel = float(np.abs(f[2] - f0[2]).max() / np.abs(f0[2]).max())
        p_rel = float(np.abs(f[1] - f0[1]).max() / np.abs(f0[1]).max())
        print(f"AN3 {case} Basis ({len(m)} rows): launches {launches}, "
              f"coefficients vs plain {c_rel:.3e} (tolerance {ctol:.0e}), "
              f"acc {a_rel:.3e}, pot {p_rel:.3e} of their largest "
              f"(tolerance {ftol:.0e})", flush=True)
        if not (c_rel <= ctol and a_rel <= ftol and p_rel <= ftol
                and all(np.isfinite(v).all() for v in f)):
            raise AssertionError(f"AN3 {case}: coefficients {c_rel}, acc "
                                 f"{a_rel}, pot {p_rel}")
        del b
    host["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())
    print("AN3 host clock: " + json.dumps(host), flush=True)
    work.cleanup()
    return rows


# ---------------------------------------------------------------------------
# PX1, PX2, CL1: the pyEXP drop-in (exp_tpu_torch/pyexp) and the CLI's
# analysis, MSSA and basis tools (exp_tpu_torch/cli)
# ---------------------------------------------------------------------------

# PX1: PX_SNAPS PSP snapshots of phase 5's sample at x (1 + 0.01 sin(0.3 t)),
# read through pyEXP.read and projected through pyEXP.basis on AN1's stanza
# (bench_pyexp.STANZA); slices of AN_SLICE^2 points at PX_TIMES of the
# times; expMSSA of the series at window PX_WINDOW; the accumulation API in
# PX_CHUNKS chunks; the covariance's PX_SAMPT partitions of snapshot 0;
# IntegrateOrbits of bench_pyexp.ORBITS bodies for bench_pyexp.STEPS steps.
PX_SNAPS = 8
PX_TIMES = 2
PX_WINDOW = 4
PX_CHUNKS = 4
PX_SAMPT = 100
# The orbits' mean |dE/E| (E = v^2/2 + the expansion's potential at both
# ends of the float32 orbits): three times the same run through the plain
# versions on a CPU, at least DRIFT_BOUND (_mf_bound's rule, as MF1, MF3b
# and IC2).  The CPU run: python -m exp_tpu_torch.bench_pyexp orbits
# --device cpu --threads 2 (the same sample, basis, coefficients and
# leapfrog, on an 8-core Intel Xeon host without a card): mean 3.43e-7,
# largest 4.83e-6, 7.1 ms a step.  At ~1e-7 a body the energy errs at the
# rounding of its f32 positions and potential, so the bound is
# DRIFT_BOUND's.
PX_ORBIT_CPU = {"dE_rel": 3.434574783330816e-07}   # the orbits' mean
# The orbits' end points on the card against the same integration through
# K2's plain version on the card, max|d| / max|value| of the positions and
# of the velocities, set before the first run: K2 and its plain version
# differ by ~1e-6 of |a| at a step (phase 4), and 500 steps in a smooth
# spherical field carry that difference along the orbits, growing about
# linearly with the number of steps.
PX_ORBIT_END_RTOL = 1e-3
# PX2: getFields at PX_DISK_PTS of CM1's disk particles; the midplane
# slice of PX_MID^2 points over |x|, |y| <= 0.1 at t 0
PX_DISK_PTS = 4096
PX_MID = 128
# CL1: the rows of the body file crossval and kldiv read (the host direct
# sum at 2^20 takes 36-44 s, PERF.md §5)
CL_ROWS = 65_536
# pyEXP's spherical label set (BiorthBasis.cc:71-96)
PX_LABELS = ["dens m=0", "dens m>0", "dens", "potl m=0", "potl m>0",
             "potl", "rad force", "mer force", "azi force"]


def _columns_check(tag, out, ref, acc_tol, pot_tol, rel):
    """pyEXP getFields columns (cartesian field type) `out` against `ref`:
    the density columns (plain torch on both sides) to 1e-12 of their
    largest, the potential columns to `pot_tol` (the m>0 column, a
    difference of two evaluations, to twice it), the force columns to
    `acc_tol`, as _field_check.  Returns the largest |d| of the potential
    and force columns."""
    import numpy as np

    d = np.abs(out - ref)
    sp = np.abs(ref[:, 5]).max() if rel else 1.0
    sa = np.abs(ref[:, 6:9]).max() if rel else 1.0
    bad = []
    if not np.isfinite(out).all():
        bad.append("non-finite")
    if d[:, :3].max() > 1e-12 * np.abs(ref[:, 2]).max():
        bad.append(f"dens {d[:, :3].max()}")
    for j, k in ((3, 1.0), (4, 2.0), (5, 1.0)):
        lim = k * (pot_tol[1] * sp + pot_tol[0] * np.abs(ref[:, 5]))
        if not (d[:, j] <= lim).all():
            bad.append(f"column {j} {d[:, j].max()}")
    lim = acc_tol[1] * sa + acc_tol[0] * np.abs(ref[:, 6:9])
    if not (d[:, 6:9] <= lim).all():
        bad.append(f"force {d[:, 6:9].max()}")
    if bad:
        raise AssertionError(f"{tag}: {', '.join(bad)}")
    return float(d[:, 3:9].max())


def _rel(a, b):
    import numpy as np

    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def pyexp_path(dev, comp, disk_tables, xe, ve, me):
    """Phases PX1 and PX2 on the card: doc/tutorial.md §3's pyEXP flow
    (`import exp_tpu_torch.pyexp as pyEXP`) at the sphere cell's width,
    through K1 and K2, and pyEXP's cylinder on D1's tables through K4 and
    K5.  `comp` is CM1's dict, `disk_tables` D1's, (xe, ve, me) phase 5's
    sample.  Returns the kernels-line rows and the working directory with
    the PSP files (CL1 reads them; the caller cleans it up)."""
    import os
    import tempfile

    import numpy as np
    import torch

    import exp_tpu_torch.pyexp as pyEXP
    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_pyexp as bp
    from exp_tpu_torch.analysis.basis import Basis as NativeBasis
    from exp_tpu_torch.forces.cylinder import CylinderForce
    from exp_tpu_torch.io.psp import PSPComponent, PSPDump, write_psp
    from exp_tpu_torch.io.readers import createReader
    from exp_tpu_torch.ops import cyl_kernels as ck
    from exp_tpu_torch.ops import sphere_kernels as sk

    rows, host = [], {}
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_pyexp_")
    wd = work.name
    n = len(me)

    # PX1. the snapshots as PSP files
    times = np.arange(PX_SNAPS) * 0.1
    jit = [1.0 + 0.01 * float(np.sin(0.3 * t)) for t in range(PX_SNAPS)]
    files = [os.path.join(wd, f"OUT.px.{i:05d}") for i in range(PX_SNAPS)]
    t0 = time.perf_counter()
    for i, s in enumerate(jit):
        write_psp(files[i], PSPDump(time=float(times[i]), components=[
            PSPComponent(name="halo", info="name: halo\n", mass=me,
                         x=xe * s, v=ve, pot=np.zeros(n))]))
    host["psp_write_s_per_snapshot"] = (time.perf_counter() - t0) / PX_SNAPS
    bp.write_model(wd)
    t0 = time.perf_counter()
    basis = pyEXP.basis.Basis.factory(bp.STANZA % "pallas", workdir=wd,
                                      device=dev)
    gather = pyEXP.basis.Basis.factory(bp.STANZA % "gather", workdir=wd,
                                       device=dev)
    host["basis_factory_s"] = (time.perf_counter() - t0) / 2
    force, prm = basis.native.force, basis.native.force._kernel_params()

    # createReader -> createFromReader, one K1 a snapshot
    series, reads, projs = None, [], []
    bc.reset_launches()
    for f in files:
        t1 = time.perf_counter()
        reader = pyEXP.read.ParticleReader.createReader("PSPout", f)
        reader.SelectType("halo")
        t2 = time.perf_counter()
        c = basis.createFromReader(reader)
        t3 = time.perf_counter()
        reads.append(t2 - t1)
        projs.append(t3 - t2)
        st = c.getCoefStruct(c.Times()[0])
        if series is None:
            series = pyEXP.coefs.Coefs.makecoefs(st, "halo")
        series.add(st)
    k1_launches = bc.kernel_launches()
    print("PX1 createFromReader: " + json.dumps({
        "snapshots": PX_SNAPS, "rows": n, "launches": k1_launches,
        "read_s": reads, "project_s": projs}), flush=True)
    _want_launches("PX1 createFromReader", k1_launches,
                   {"sphere_coef": PX_SNAPS})
    A = np.stack([series.getCoefStruct(t).getCoefs()
                  for t in series.Times()])
    if not (series.Times() == [float(t) for t in times]
            and series.getGeometry() == "sphere"):
        raise AssertionError(f"PX1: times {series.Times()}, geometry "
                             f"{series.getGeometry()}")
    # the same files through the analysis library: the same code path
    def snaps():
        for f in files:
            x, v, m = createReader("psp", f).GetParticles("halo")
            yield x, m

    nat = basis.native.create_from_snapshots(snaps(), times=times)
    same = bool(np.array_equal(nat.as_array(), A))
    k1_err = k1_rel = g_rel = 0.0
    for i, s in enumerate(jit):
        with _plain((sk, "sphere_coef")):
            c0 = basis.createFromArray(me, xe * s).getCoefs()
        cg = gather.createFromArray(me, xe * s).getCoefs()
        k1_err = max(k1_err, float(np.abs(A[i] - c0).max()))
        k1_rel = max(k1_rel, _rel(A[i], c0))
        g_rel = max(g_rel, _rel(A[i], cg))
    # the accumulation API in chunks against the one-shot projection
    basis.initFromArray()
    for part in np.array_split(np.arange(n), PX_CHUNKS):
        basis.addFromArray(me[part], xe[part] * jit[0])
    bc.reset_launches()
    acc_st = basis.makeFromArray(time=0.0)
    acc_launches = bc.kernel_launches()
    _want_launches("PX1 makeFromArray", acc_launches, {"sphere_coef": 1})
    acc_rel = _rel(acc_st.getCoefs(), A[0])
    print(f"PX1 coefficients: createFromReader equal to "
          f"create_from_snapshots bit for bit: {same}; K1 vs plain "
          f"max|dc|/max|c| = {k1_rel:.3e} (tolerance {COEF_RTOL:.0e}); vs "
          f"the f64 gather Basis {g_rel:.3e} (tolerance "
          f"{AN_GATHER_COEF:.0e}); initFromArray / {PX_CHUNKS} x "
          f"addFromArray / makeFromArray vs one-shot {acc_rel:.3e} "
          f"(tolerance {COEF_RTOL:.0e})", flush=True)
    if not (same and k1_rel <= COEF_RTOL and g_rel <= AN_GATHER_COEF
            and acc_rel <= COEF_RTOL and np.isfinite(A).all()):
        raise AssertionError(f"PX1: coefficients (same {same}, K1 {k1_rel}, "
                             f"gather {g_rel}, accumulation {acc_rel})")

    # getFields at AN_GATHER_PTS particles: two K2 (the coefficients and
    # their m = 0 part), against the plain version; the label set
    basis.set_coefs(series.getCoefStruct(0.0))
    if basis.getFieldLabels() != PX_LABELS:
        raise AssertionError(f"PX1 labels {basis.getFieldLabels()}")
    pts = xe[:AN_GATHER_PTS]
    basis.setFieldType("cartesian")
    bc.reset_launches()
    t0 = time.perf_counter()
    out = basis.getFields(pts[:, 0], pts[:, 1], pts[:, 2])
    host["getFields_s"] = time.perf_counter() - t0
    launches = bc.kernel_launches()
    _want_launches("PX1 getFields", launches, {"sphere_accel": 2})
    with _plain((sk, "sphere_accel")):
        ref = basis.getFields(pts[:, 0], pts[:, 1], pts[:, 2])
    basis.setFieldType("spherical")
    gf_err = _columns_check("PX1 getFields", out, ref, (ACC_RTOL, ACC_ATOL),
                            (POT_RTOL, POT_ATOL), False)
    print(f"PX1 getFields ({AN_GATHER_PTS} points): launches {launches}, "
          f"K2 vs plain max|d| {gf_err:.3e} (tolerance acc rtol "
          f"{ACC_RTOL:.0e} atol {ACC_ATOL:.0e}, pot rtol {POT_RTOL:.0e} "
          f"atol {POT_ATOL:.0e}); labels {PX_LABELS}", flush=True)

    # expMSSA of the series: every eigentriple gives the series back
    t0 = time.perf_counter()
    npc = PX_SNAPS - PX_WINDOW + 1
    ssa = pyEXP.mssa.expMSSA({"halo": (series, None, [])}, PX_WINDOW, npc)
    ssa.reconstruct(list(range(npc)))
    rec = ssa.getReconstructed()["halo"]
    host["mssa_s"] = time.perf_counter() - t0
    rec_err = _rel(rec.getAllCoefs(), series.getAllCoefs())
    ev = ssa.eigenvalues()
    print(f"PX1 expMSSA (window {PX_WINDOW}, {npc} eigentriples): "
          f"getReconstructed gives the series back to {rec_err:.3e} of "
          f"max|c| (tolerance {AN_MSSA_REC:.0e}); eigenvalues "
          f"{[float(e) for e in ev]}", flush=True)
    if not (rec_err <= AN_MSSA_REC and rec.Times() == series.Times()
            and (np.diff(ev) <= 0).all()):
        raise AssertionError(f"PX1 expMSSA: {rec_err}")

    # FieldGenerator.slices: one K2 a time
    ft = [float(t) for t in times[::PX_SNAPS // PX_TIMES][:PX_TIMES]]
    fg = pyEXP.field.FieldGenerator(ft, (-2, -2, 0), (2, 2, 0),
                                    (AN_SLICE, AN_SLICE, 0))
    bc.reset_launches()
    t0 = time.perf_counter()
    sl = fg.slices(basis, series)
    host["slice_render_s_per_time"] = (time.perf_counter() - t0) / PX_TIMES
    sl_launches = bc.kernel_launches()
    _want_launches("PX1 slices", sl_launches, {"sphere_accel": PX_TIMES})
    with _plain((sk, "sphere_accel")):
        sl0 = fg.slices(basis, series)
    sl_err = 0.0
    for t in ft:
        o, r_ = ((f["dens"].ravel(), f["potl"].ravel(), np.stack(
            [f["accx"].ravel(), f["accy"].ravel(), f["accz"].ravel()], -1))
                 for f in (sl[t], sl0[t]))
        sl_err = max(sl_err, _field_check(f"PX1 slice t={t}", o, r_,
                                          (ACC_RTOL, ACC_ATOL),
                                          (POT_RTOL, POT_ATOL), False))
    print(f"PX1 FieldGenerator.slices ({AN_SLICE}^2 points x {PX_TIMES} "
          f"times): launches {sl_launches}, K2 vs plain max|d| "
          f"{sl_err:.3e}", flush=True)

    # IntegrateOrbits in the frozen field: one K2 a step and one first,
    # and one each for the energy at both ends
    xo, vo = xe[:bp.ORBITS], ve[:bp.ORBITS]
    bc.reset_launches()
    O, orb = bp.orbit_energy(basis, series, xo, vo)
    orb_launches = bc.kernel_launches()
    _want_launches("PX1 IntegrateOrbits", orb_launches,
                   {"sphere_accel": bp.STEPS + 3})
    with _plain((sk, "sphere_accel")):
        O0, orb0 = bp.orbit_energy(basis, series, xo, vo)
    end_x = _rel(O[-1][:, :3], O0[-1][:, :3])
    end_v = _rel(O[-1][:, 3:], O0[-1][:, 3:])
    bound = _mf_bound(PX_ORBIT_CPU)
    host["orbit_step_s"] = orb["step_s"]
    host["orbit_step_s_plain"] = orb0["step_s"]
    print("PX1 IntegrateOrbits: " + json.dumps({
        **orb, "plain_dE_mean": orb0["dE_mean"], "cpu": PX_ORBIT_CPU,
        "dE_bound": bound, "launches": orb_launches,
        "end_x_rel": end_x, "end_v_rel": end_v,
        "end_rtol": PX_ORBIT_END_RTOL}), flush=True)
    if not (orb["finite"] and orb["dE_mean"] <= bound
            and end_x <= PX_ORBIT_END_RTOL and end_v <= PX_ORBIT_END_RTOL):
        raise AssertionError(f"PX1 IntegrateOrbits: dE {orb['dE_mean']} "
                             f"(bound {bound}), ends {end_x}, {end_v}")

    # the coefficient covariance: PX_SAMPT partitions of snapshot 0, one K1
    # each, and the projection itself
    basis.enableCoefCovariance(True, sampT=PX_SAMPT)
    bc.reset_launches()
    t0 = time.perf_counter()
    cst = basis.createFromArray(me, xe * jit[0], time=0.0)
    host["covariance_s"] = time.perf_counter() - t0
    cov_launches = bc.kernel_launches()
    _want_launches("PX1 covariance", cov_launches,
                   {"sphere_coef": PX_SAMPT + 1})
    mu, C = basis.getCoefCovariance()
    basis.enableCoefCovariance(False)
    cov_rel = _rel(mu, cst.getCoefs().ravel())
    psd = bool(np.diag(C).min() >= 0.0)
    print(f"PX1 enableCoefCovariance (sampT {PX_SAMPT}): launches "
          f"{cov_launches}, the partitions' mean vs the projection "
          f"{cov_rel:.3e} (tolerance {COEF_RTOL:.0e}), covariance "
          f"{list(C.shape)} with a non-negative diagonal {psd}", flush=True)
    if not (cov_rel <= COEF_RTOL and psd and np.isfinite(C).all()):
        raise AssertionError(f"PX1 covariance: {cov_rel}, psd {psd}")
    print("PX1 host clock: " + json.dumps({
        **host, "read_s_median": float(np.median(reads)),
        "project_s_median": float(np.median(projs))}), flush=True)

    # kernels-line rows at PX1's shapes
    x32 = torch.as_tensor(xe * jit[0], dtype=torch.float32, device=dev)
    m32 = torch.as_tensor(me, dtype=torch.float32, device=dev)
    tab, r = force._radial_table(), x32.norm(dim=1) + 1e-10
    n_in = int(((r >= prm.rmin * prm.scale) & (r <= prm.rmax * prm.scale)
                & (m32 > 0)).sum())
    rows.append(_an_row(
        "sphere_coef[PX1 pyEXP createFromReader]", "sphere_coef.cu",
        "exp_tpu/ops/pallas_sphere.py:521", k1_launches["sphere_coef"],
        k1_err, lambda: sk.sphere_coef(x32, m32, tab, force.Mp, prm),
        lambda: sk.sphere_coef_plain(x32, m32, tab, force.Mp, prm),
        k1_work(n, n_in, prm.lmax, prm.nmax, prm.rows)))
    twT = force.accel_table(torch.as_tensor(A[0], device=dev))
    for kind, cnt, p in (
            ("slice", sl_launches["sphere_accel"], fg._fg._mesh()[0]),
            ("orbit step", orb_launches["sphere_accel"], xo)):
        p32 = torch.as_tensor(p, dtype=torch.float32, device=dev)
        a, pt = sk.sphere_accel(p32, twT, force.fac32, prm)
        a0, pt0 = sk.sphere_accel_plain(p32, twT, force.fac32, prm)
        err = max(float((a - a0).abs().max()), float((pt - pt0).abs().max()))
        rows.append(_an_row(
            f"sphere_accel[PX1 pyEXP {kind}]", "sphere_accel.cu",
            "exp_tpu/ops/pallas_sphere.py:398", cnt, err,
            lambda p32=p32: sk.sphere_accel(p32, twT, force.fac32, prm),
            lambda p32=p32: sk.sphere_accel_plain(p32, twT, force.fac32,
                                                  prm),
            k2_work(len(p), prm.lmax, prm.rows)))
    del x32, m32, gather

    # PX2. pyEXP's cylinder on D1's tables and CM1's disk particles
    ic = comp["ic"]
    xk, mk = ic["xd"], ic["md"]
    disk = pyEXP.basis.Basis(NativeBasis(CylinderForce.from_tables(
        disk_tables, backend="pallas", device=dev), name="disk"))
    dforce, dp = disk.native.force, disk.native.force._kernel_params()
    bc.reset_launches()
    t0 = time.perf_counter()
    dst = disk.createFromArray(mk, xk, time=0.0)
    host2 = {"createFromArray_s": time.perf_counter() - t0}
    k4_launches = bc.kernel_launches()
    _want_launches("PX2 createFromArray", k4_launches, {"cyl_coef": 1})
    with _plain((ck, "cyl_coef")):
        dst0 = disk.createFromArray(mk, xk, time=0.0)
    k4_err = float(np.abs(dst.getCoefs() - dst0.getCoefs()).max())
    k4_rel = _rel(dst.getCoefs(), dst0.getCoefs())
    labels = disk.getFieldLabels()
    geo_ok = (dst.getGeometry() == "cylinder"
              and disk.getFieldType() == "cylindrical"
              and labels[6:] == ["rad force", "ver force", "azi force"])
    print(f"PX2 createFromArray ({len(mk)} disk particles): launches "
          f"{k4_launches}, K4 vs plain max|dc|/max|c| = {k4_rel:.3e} "
          f"(tolerance {CYL_COEF_RTOL:.0e}); geometry "
          f"{dst.getGeometry()!r}, labels {labels}", flush=True)
    if not (k4_rel <= CYL_COEF_RTOL and geo_ok
            and np.isfinite(dst.getCoefs()).all()):
        raise AssertionError(f"PX2: K4 {k4_rel}, geometry/labels {geo_ok}")
    disk.set_coefs(dst)
    dpts = xk[:PX_DISK_PTS]
    disk.setFieldType("cartesian")
    bc.reset_launches()
    t0 = time.perf_counter()
    dout = disk.getFields(dpts[:, 0], dpts[:, 1], dpts[:, 2])
    host2["getFields_s"] = time.perf_counter() - t0
    k5_launches = bc.kernel_launches()
    _want_launches("PX2 getFields", k5_launches, {"cyl_accel": 2})
    with _plain((ck, "cyl_accel")):
        dref = disk.getFields(dpts[:, 0], dpts[:, 1], dpts[:, 2])
    disk.setFieldType("cylindrical")
    k5_err = _columns_check("PX2 getFields", dout, dref,
                            (CYL_ACC_RTOL, CYL_ACC_ATOL_REL),
                            (CYL_POT_RTOL, CYL_POT_ATOL_REL), True)
    print(f"PX2 getFields ({PX_DISK_PTS} points): launches {k5_launches}, "
          f"K5 vs plain max|d| {k5_err:.3e} (|a| up to "
          f"{np.abs(dref[:, 6:9]).max():.3e})", flush=True)
    # a midplane slice: one K5 for the slice and one a scanned height
    dser = pyEXP.coefs.Coefs.makecoefs(dst, "disk")
    dser.add(dst)
    mfg = pyEXP.field.FieldGenerator([0.0], (-0.1, -0.1, 0), (0.1, 0.1, 0),
                                     (PX_MID, PX_MID, 0))
    mfg.setMidplane(True)
    bc.reset_launches()
    t0 = time.perf_counter()
    msl = mfg.slices(disk, dser)[0.0]
    host2["midplane_slice_s"] = time.perf_counter() - t0
    mid_launches = bc.kernel_launches()
    with _plain((ck, "cyl_accel")):
        msl0 = mfg.slices(disk, dser)[0.0]
    nz = mid_launches.get("cyl_accel", 0)
    # exp_tpu's midplane: the slice at z 0, then 17 scanned heights
    _want_launches("PX2 midplane slice", mid_launches, {"cyl_accel": 18})
    mo, mr = ((f["dens"].ravel(), f["potl"].ravel(), np.stack(
        [f["accx"].ravel(), f["accy"].ravel(), f["accz"].ravel()], -1))
              for f in (msl, msl0))
    mid_err = _field_check("PX2 midplane", mo, mr,
                           (CYL_ACC_RTOL, CYL_ACC_ATOL_REL),
                           (CYL_POT_RTOL, CYL_POT_ATOL_REL), True)
    same_mid = bool(np.array_equal(msl["midplane"], msl0["midplane"]))
    hmax = float(np.abs(msl["midplane"]).max())
    print(f"PX2 midplane slice ({PX_MID}^2 points, {nz} evaluations): "
          f"launches "
          f"{mid_launches}, K5 vs plain max|d| {mid_err:.3e}, the same "
          f"midplane heights as the plain run: {same_mid}, max|z_mid| "
          f"{hmax:.3e} (hcyl {dforce.hcyl})", flush=True)
    if not (same_mid and hmax <= 4.0 * dforce.hcyl + 1e-12):
        raise AssertionError(f"PX2 midplane: same {same_mid}, |z| {hmax}")
    print("PX2 host clock: " + json.dumps(host2), flush=True)
    xk32 = torch.as_tensor(xk, dtype=torch.float32, device=dev)
    mk32 = torch.as_tensor(mk, dtype=torch.float32, device=dev)
    kx = 3 if dp.interp == "spline" else 2
    nk_in = int(((xk32.norm(dim=1) <= dp.rmax_grid) & (mk32 > 0)).sum())
    rows.append(_an_row(
        "cyl_coef[PX2 pyEXP createFromArray]", "cyl_coef.cu",
        "exp_tpu/ops/pallas_cylinder.py:164", k4_launches["cyl_coef"],
        k4_err, lambda: ck.cyl_coef(xk32, mk32, dp),
        lambda: ck.cyl_coef_plain(xk32, mk32, dp),
        k4_work(len(mk), nk_in, dp.mmax, dp.xrows, dp.ncy, kx)))
    Ct = ck.contract_coef_tables(torch.as_tensor(dst.getCoefs(), device=dev),
                                 dforce.tab3, dp.xrows, dp.ncy)
    dp32 = torch.as_tensor(dpts, dtype=torch.float32, device=dev)
    rows.append(_an_row(
        "cyl_accel[PX2 pyEXP getFields]", "cyl_accel.cu",
        "exp_tpu/ops/pallas_cylinder.py:257", k5_launches["cyl_accel"],
        k5_err, lambda: ck.cyl_accel(dp32, Ct, dp),
        lambda: ck.cyl_accel_plain(dp32, Ct, dp),
        k5_work(len(dpts), dp.mmax, dp.xrows, dp.ncy, kx)))
    return rows, work, files


def tools_path(comp, xe, ve, me, work, files):
    """Phase CL1 on the card: the inputs of the ported analysis, MSSA and
    basis tools, then makecoefs with a `backend: pallas` stanza in this
    process, which launches K1 and refuses loudly where h5py is missing.
    Returns CL1's child runs, `python -m exp_tpu_torch.cli <tool>` on the
    card (no --cpu), each to exit 0 and write exp_tpu's file names
    (`tool_pool` runs them beside the energy path with CL2's)."""
    import os

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_pyexp as bp
    from exp_tpu_torch.bench_slab import slab_sample
    from exp_tpu_torch.nbody.particles import write_ascii_bodies

    wd = work.name
    ic = comp["ic"]
    t0 = time.perf_counter()
    write_ascii_bodies(os.path.join(wd, "disk.bods"),
                       (ic["xd"], ic["vd"], ic["md"]))
    write_ascii_bodies(os.path.join(wd, "halo.bods"),
                       (xe[:CL_ROWS], ve[:CL_ROWS], me[:CL_ROWS]))
    write_ascii_bodies(os.path.join(wd, "slab.bods"), slab_sample(CL_ROWS))
    for f in ("a.yml", "b.yml"):
        with open(os.path.join(wd, f), "w") as fh:
            fh.write("Global: {dtime: 0.01, nsteps: 5}\n")
    cfg = os.path.join(wd, "basis.yml")
    with open(cfg, "w") as fh:
        fh.write(bp.STANZA % "pallas")
    print("CL1 host clock: " + json.dumps({
        "prepare_s": time.perf_counter() - t0}), flush=True)
    psp = os.path.basename(files[0])
    # (phase, tool, argv, files it must write, a word its output must
    # hold, needs h5py)
    runs = [
        ("CL1", "crossval", ["halo.bods", "--type", "ascii"], [],
         "overall median force error", False),
        ("CL1", "orthochk", ["-i", "hernquist", "--lmax", "1", "--nmax", "6",
                             "--numr", "500"], [], "PASS", False),
        ("CL1", "slcheck", ["-i", "plummer", "--lmax", "1", "--nmax", "4",
                            "--numr", "400"], [], "eigenvalues", False),
        ("CL1", "haloprof", [psp, "--type", "psp", "--comp", "halo",
                             "--nbins", "20"], [psp + ".haloprof"], "wrote",
         False),
        ("CL1", "diskprof", ["disk.bods", "--type", "ascii", "--nbins", "15"],
         ["disk.bods.diskprof"], "wrote", False),
        ("CL1", "kldiv", ["halo.bods", "disk.bods", "--cyl"], [],
         "KL(p1 || p2)", False),
        ("CL1", "slshift", ["-o", "slshift"],
         ["slshift.coefs", "slshift.profile"], "rel err", False),
        ("CL1", "slabprof", ["slab.bods", "--nbins", "20"],
         ["slab.bods.slabprof"], "wrote", False),
        ("CL1", "scalarprod", ["halo.bods", "--type", "ascii", "--config",
                               cfg, "--center"], [], "geometry=sphere",
         False),
        ("CL1", "yamldiff", ["a.yml", "b.yml"], [], "configs identical",
         False),
    ]
    # makecoefs, in this process (its K1 launch counted), and as a tool
    # among the children
    has_h5py = _has_h5py()
    from exp_tpu_torch.cli.makecoefs import main as makecoefs

    argv = [psp, "--config", cfg, "--type", "psp", "--comp", "halo", "-o",
            "px.h5"]
    cwd = os.getcwd()
    os.chdir(wd)
    bc.reset_launches()
    try:
        try:
            makecoefs(argv)
            refusal = None
        except ImportError as e:
            refusal = str(e)
    finally:
        os.chdir(cwd)
    mk_launches = bc.kernel_launches()
    _want_launches("CL1 makecoefs", mk_launches, {"sphere_coef": 1})
    print(f"CL1 makecoefs (backend pallas, {psp}): launches {mk_launches}; "
          f"h5py here: {has_h5py}; in this process: "
          f"{'ImportError ' + repr(refusal) if refusal else 'wrote px.h5'}",
          flush=True)
    # ModuleNotFoundError is the ImportError that names the module
    if (refusal is None) != has_h5py or (refusal and "h5py" not in refusal):
        raise AssertionError("CL1 makecoefs: the missing h5py was not "
                             "refused loudly" if not has_h5py else
                             "CL1 makecoefs failed")
    runs.append(("CL1", "makecoefs", argv, ["px.h5"], "", True))
    print("CL1 not run on the card, their inputs or outputs being HDF5 "
          "(coefficient files, EOF caches) and the card's machine having no "
          "h5py; the CPU tests hold them against exp_tpu's: " + json.dumps([
              "viewcoefs", "h5compare", "h5power", "mssaprof", "sphprof",
              "diskprof --coef", "eofinfo", "cylcache", "coefstoh5",
              "mssafilter", "expmssa", "diskeof", "diskfreqs",
              "crossval --eof"]), flush=True)
    return runs


# ---------------------------------------------------------------------------
# IC1, IC2, IC3: the remaining ICs (exp_tpu_torch/bench_ics.py)
# ---------------------------------------------------------------------------

# IC1's gate on the sample's 2T/VC in the model's own field
# (tests/test_qpdistf.py:66) and its drift bound, the sphere path's for its
# equilibrium sample of the same model under the same basis and steps
IC1_VIRIAL_TOL = 0.06
IC1_DRIFT_BOUND = DRIFT_BOUND
# IC2's CPU drift: python -m exp_tpu_torch.bench_ics kdk --case IC2
# --device cpu --threads 3 (262,144 particles, 20 steps of dt 1e-3, the
# kernels' plain versions); the bound is three times it, as MF1's and
# CM2's are
IC2_CPU = {"dE_rel": 8.583483177473419e-05}
# IC3's gate on the composite's 2T/VC (tests/test_diskhalo2d.py:77)
IC3_VIRIAL_TOL = 0.05


def ic_path(dev, force):
    """Phases IC1-IC3 on the card (exp_tpu_torch/bench_ics.py): the QP
    halo under phase 3's `force` (the sphere cell's basis), the Zang disk
    under its flatdisk basis (the first flatdisk tables through K4 and
    K5), and the 2D disk + halo.  Returns the kernels-line rows of K1 and
    K2 on IC1, K4 and K5 on IC2 and the four kernels on IC3."""
    import numpy as np
    import torch

    from exp_tpu_torch import bench_composite as bc
    from exp_tpu_torch import bench_ics as bi
    from exp_tpu_torch.basis.model import hernquist_model
    from exp_tpu_torch.nbody.particles import ParticleSystem

    rows = []

    # IC1. gensph --qp: the QP halo at 2^20, its DF on the card
    (x, v, m), info = bi.qp_halo(bi.QP_N, dev)
    model = hernquist_model(rmin=1e-3, rmax=20.0)
    r = np.linalg.norm(x, axis=1)
    vir = float(np.sum(m * np.sum(v * v, 1))
                / np.sum(m * r * model.get_dpot(r)))
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    mt = torch.as_tensor(m, dtype=torch.float32, device=dev)
    bc.reset_launches()
    t0 = time.perf_counter()
    _, run = bi.kdk(force, x, v, m, bi.QP_STEPS, bi.QP_DT, dev)
    torch.cuda.synchronize()
    launches = bc.kernel_launches()
    rep = {**info, "n": len(m), "virial_model": vir, **run,
           "run_sec": time.perf_counter() - t0, "launches": launches,
           "tolerance": {"virial_model": IC1_VIRIAL_TOL,
                         "dE_rel": IC1_DRIFT_BOUND}}
    print("IC1 gensph --qp: " + json.dumps(rep), flush=True)
    if not abs(vir - 1.0) <= IC1_VIRIAL_TOL:
        raise AssertionError(f"IC1: the sample's 2T/VC is {vir}")
    if not run["finite"] or not run["dE_rel"] < IC1_DRIFT_BOUND:
        raise AssertionError(f"IC1: finite {run['finite']}, |dE/E| "
                             f"{run['dE_rel']}")
    want = _want(launches, {"sphere_coef": bi.QP_STEPS + 1,
                            "sphere_accel": bi.QP_STEPS + 1})
    if launches != want:
        raise AssertionError(f"IC1: launches {launches}, expected {want}")
    rows += _mf_rows("IC1", _mf_sphere_check("IC1", force, xt, mt),
                     launches, "the QP halo's 2^20 rows")
    del xt, mt

    # IC2. zangics: 262,144 bodies under the 'zang' flatdisk basis
    t0 = time.perf_counter()
    disk = bi.zang_force(dev)
    t1 = time.perf_counter()
    x, v, m = bi.zang_disk(bi.ZANG_N)
    t2 = time.perf_counter()
    bc.reset_launches()
    ps, run = bi.kdk(disk, x, v, m, bi.ZANG_STEPS, bi.ZANG_DT, dev)
    torch.cuda.synchronize()
    launches = bc.kernel_launches()
    flat = bool((ps.x[:, 2] == 0).all()) and bool((ps.v[:, 2] == 0).all())
    bound = _mf_bound(IC2_CPU)
    rep = {"tables_sec": t1 - t0, "sample_sec": t2 - t1, **run,
           "run_sec": time.perf_counter() - t2, "z_vz_zero": flat,
           "launches": launches, "cpu": IC2_CPU,
           "tolerance": {"dE_rel": bound}}
    print("IC2 zangics: " + json.dumps(rep), flush=True)
    if not (run["finite"] and flat and run["dE_rel"] < bound):
        raise AssertionError(f"IC2: finite {run['finite']}, z = vz = 0 "
                             f"{flat}, |dE/E| {run['dE_rel']}")
    want = _want(launches, {"cyl_coef": bi.ZANG_STEPS + 1,
                            "cyl_accel": bi.ZANG_STEPS + 1})
    if launches != want:
        raise AssertionError(f"IC2: launches {launches}, expected {want}")
    b = ParticleSystem.from_arrays(x, v, m, device=dev)
    coef = {"disk": disk.coefficients(b.x, b.mass)}
    rows += _bucket_rows("IC2", _comp_kernels(None, disk, coef),
                         {"disk": [b]}, launches)
    del disk, ps, b, coef

    # IC3. gendisk2d --nhalo: the 2D disk + halo at the flagship's counts
    t0 = time.perf_counter()
    halo, disk = bi.disk2d_forces(dev)
    t1 = time.perf_counter()
    ics, vir = bi.disk2d_ics(halo, disk)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    flat = bool(np.all(ics.x_disk[:, 2] == 0)
                and np.all(ics.v_disk[:, 2] == 0))
    mh = np.maximum(ics.m_halo, 0.0)
    st0 = {"halo": ParticleSystem.from_arrays(ics.x_halo, ics.v_halo, mh,
                                              device=dev),
           "disk": ParticleSystem.from_arrays(ics.x_disk, ics.v_disk,
                                              ics.m_disk, device=dev)}
    runner = bi.disk2d_runner(halo, disk)
    bc.reset_launches()
    t3 = time.perf_counter()
    st, regs, _, _ = runner.init_state(st0)
    for k in range(bi.D2_NBIG):
        st, regs, _, _ = runner.bigstep(st, regs, k * runner.dtime)
        st, regs = runner.relevel(st, regs, t0=(k + 1) * runner.dtime)
    torch.cuda.synchronize()
    launches = bc.kernel_launches()
    want = _want(launches, bc.expected_launches(runner, bi.D2_NBIG))
    finite = all(bool(torch.isfinite(t).all()) for bs in st.values()
                 for bb in bs for t in (bb.x, bb.v, bb.acc, bb.pot))
    rep = {"tables_sec": t1 - t0, "ics_sec": t2 - t1, "virial": vir,
           "disk_z_vz_zero": flat, "n_oob": ics.diag["n_oob"],
           "run_sec": time.perf_counter() - t3, "finite": finite,
           "level_counts": runner.level_counts(st), "launches": launches,
           "tolerance": {"virial": IC3_VIRIAL_TOL}}
    print("IC3 gendisk2d --nhalo: " + json.dumps(rep), flush=True)
    if not (abs(vir - 1.0) <= IC3_VIRIAL_TOL and flat and finite):
        raise AssertionError(f"IC3: -2T/VC {vir}, disk z = vz = 0 {flat}, "
                             f"finite {finite}")
    if launches != want:
        raise AssertionError(f"IC3: launches {launches}, expected {want}")
    coef = {"halo": halo.coefficients(st0["halo"].x, st0["halo"].mass),
            "disk": disk.coefficients(st0["disk"].x, st0["disk"].mass)}
    rows += _bucket_rows("IC3", _comp_kernels(halo, disk, coef),
                         {n: [b] for n, b in st0.items()}, launches)
    return rows


# ---------------------------------------------------------------------------
# WX1, WX2: what a world of several ranks runs since ROADMAP item 12b
# ---------------------------------------------------------------------------

# WX1's files against one rank's: the value columns at MD2(b)'s OUTLOG
# tolerance, OUTLOG's R and V at its absolute one, and the statistics over
# a bin's members at its level-population share (bench_multirank.
# file_difference); WX2's OutVel coefficients at MD2(a)'s coefficient
# bound, each field's difference over the size of its terms
# (bench_multirank.outvel_world: a velocity field's own max|c| cancels to
# the sample's noise; over it the fields read 3.5e-6 to 5.3e-6 on an H100,
# PERF.md §6)
WX_FILES = ("OUTLOG.wx", "ORBTRACE.wx", "OUTDIAG.wx", "OUTFRAC.wx",
            "OUTCALBR.wx", "wx.relx")


def world_extras_path(dev, sphere_tables, wd, xe, ve, me):
    """Phases WX1 and WX2 on the card: the extras run config
    (bench_multirank.extras_run_config: both host operators, the adaptive
    rebuild, OutAscii, OrbTrace, OutDiag, OutFrac, OutCalbr) on R3's
    sphere.bods in `wd` through run.py on one rank and with --ndev 2
    (gloo, both ranks on this card), file by file; OutVel's gather over
    two ranks against one rank's.  Returns the kernels-line rows of K1 and
    K2 at a rank's 2^19 rows under tables rebuilt from the sample, as the
    run rebuilds them."""
    import numpy as np
    import torch

    from exp_tpu_torch import bench_multirank as bmr
    from exp_tpu_torch.basis.model import model_from_particles
    from exp_tpu_torch.basis.slgrid import build_sph_sl_tables
    from exp_tpu_torch.bench_sphere import sphere_force

    # WX1
    rep = bmr.extras_world(wd, 2)
    rep["tolerance"] = {"rel": MD2B_LOG_RTOL, "abs_RV": MD2B_LOG_ATOL,
                        "bin": MD2B_LEVEL_SHARE}
    print("WX1 run.py --ndev 2 extras: " + json.dumps(rep), flush=True)
    nst = bmr.WX_STEPS
    dumps = ["halo.wx.00000.ascii"]
    for tag in ("one", "many"):
        miss = set(WX_FILES + tuple(dumps)) - set(rep["files"][tag])
        if miss:
            raise AssertionError(f"WX1 {tag}: {sorted(miss)} not written")
    if rep["files"]["one"] != rep["files"]["many"]:
        raise AssertionError(f"WX1: the files differ: {rep['files']}")
    tol = rep["tolerance"]
    for f, d in rep["difference"].items():
        if any(not d[k] <= tol[k] for k in tol):
            raise AssertionError(f"WX1 {f}: {d} against one rank's")
    reps = rep["runs"]["many"]["reports"]
    if sorted(r["rank"] for r in reps) != [0, 1]:
        raise AssertionError(f"WX1: rank reports {reps}")
    for r in reps + rep["runs"]["one"]["reports"]:
        ln = r["launches"]
        if not ln["sphere_coef"] == ln["sphere_accel"] == nst + 1:
            raise AssertionError(f"WX1 rank {r['rank']}: launches {ln}")
        times = [b["time"] for b in r["rebuilds"]]
        if len(times) != round(nst * DT / bmr.WX_REBUILD):
            raise AssertionError(f"WX1 rank {r['rank']}: rebuilds at "
                                 f"{times}")
        for b in r["rebuilds"]:
            k = round(b["time"] / DT) + 1
            if not (b["launches"]["sphere_coef"]
                    == b["launches"]["sphere_accel"] == k):
                raise AssertionError(f"WX1 rank {r['rank']}: launches "
                                     f"{b['launches']} at the rebuild at "
                                     f"t = {b['time']}")
    # K1 and K2 at a rank's rows under tables rebuilt from the sample
    half = len(me) // 2
    tabs = build_sph_sl_tables(model_from_particles(xe, me), lmax=4,
                               nmax=10, numr=2000, cmap=1, rmap=1.0)
    xt = torch.as_tensor(xe[:half], dtype=torch.float32, device=dev)
    mt = torch.as_tensor(me[:half], dtype=torch.float32, device=dev)
    r0 = next(r for r in reps if r["rank"] == 0)
    rows = _mf_rows("WX1 rank", _mf_sphere_check(
        "WX1 rank", sphere_force(tabs, dev), xt, mt), r0["launches"],
        "a rank's 2^19 rows, tables rebuilt from the binned sample")
    del xt, mt

    # WX2. OutVel's gather over two ranks on this card
    rep = bmr.outvel_world(sphere_tables, xe, ve, me, 2,
                           devs=[str(dev), str(dev)], backend="gloo")
    rep["tolerance"] = MD2A_COEF_RTOL
    print("WX2 OutVel world gather: " + json.dumps(rep), flush=True)
    if not max(rep["rel_err"].values()) <= MD2A_COEF_RTOL:
        raise AssertionError(f"WX2: OutVel's coefficients "
                             f"{rep['rel_err']} from one rank's")
    return rows


# ---------------------------------------------------------------------------
# VR0: the native ascii reader (exp_tpu_torch/native)
# ---------------------------------------------------------------------------

def native_path(wd):
    """Phase VR0 on the card's host: exp_tpu_torch.native builds and
    loads (g++, nvcc's host compiler, is on the card's machine: a missing
    library fails here rather than reading through NumPy unseen), then
    R3's 2^20-row ascii body file in `wd` is read through
    read_ascii_arrays (the library) and through np.loadtxt, bit for bit
    equal, both times on the host clock."""
    import os

    import numpy as np

    from exp_tpu_torch import native
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    if os.environ.get("EXP_TPU_NO_NATIVE"):
        raise AssertionError("VR0: EXP_TPU_NO_NATIVE is set")
    t0 = time.perf_counter()
    lib = native.get_lib()
    t_build = time.perf_counter() - t0
    if lib is None:
        raise AssertionError("VR0: exp_tpu_torch.native did not build or "
                             "load (g++ missing?)")
    path = os.path.join(wd, "sphere.bods")
    t0 = time.perf_counter()
    x, v, m = read_ascii_arrays(path)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path) as f:
        n = int(f.readline().split()[0])
        data = np.loadtxt(f, max_rows=n, usecols=range(7), ndmin=2)
    t_numpy = time.perf_counter() - t0
    same = all(a.tobytes() == np.ascontiguousarray(b).tobytes() for a, b in (
        (x, data[:, 1:4]), (v, data[:, 4:7]), (m, data[:, 0])))
    rep = {"library": native.lib_path().name, "build_or_load_s": t_build,
           "rows": int(len(m)), "native_read_s": t_native,
           "loadtxt_read_s": t_numpy, "bit_equal": same}
    print("VR0 native reader: " + json.dumps(rep), flush=True)
    if not same or len(m) != n:
        raise AssertionError("VR0: the native read differs from loadtxt's")


# ---------------------------------------------------------------------------
# CL2: the PhaseSpace and IC tools as child processes on the card
# ---------------------------------------------------------------------------

def psptools_path(work, files):
    """Phase CL2's inputs: exp_tpu's PhaseSpace and IC tools ported in this
    slice, on PX1's 2^20-row PSP files and CL1's body files in `work`.
    Returns its child runs, `python -m exp_tpu_torch.cli <tool>` on the
    card (no --cpu), the longest first: each exits 0, writes exp_tpu's
    file names and prints its tool's word; forcetest on the 2^20 halo at
    --nsample 500 (its f64 expansion on the card); gendisk --nhalo at a
    small -N (its expansions on the card).  Where h5py is missing,
    psp2hdf5, hdf52accel and snapconvert's gadgethdf5 output must fail
    loudly, naming h5py."""
    import os

    import numpy as np

    from exp_tpu_torch.io.psp import (PSPComponent, PSPDump, read_psp,
                                      write_psp, write_spl)
    from exp_tpu_torch.io.readers import Snapshot, write_tipsy
    from exp_tpu_torch.nbody.particles import read_ascii_arrays

    wd = work.name
    px = [os.path.basename(f) for f in files]
    t0 = time.perf_counter()
    # inputs the tools cannot share with PX1 and CL1: an SPL set of PX1's
    # first dump, CL1's halo rows as a PSP file and as a tipsy file
    d0 = read_psp(files[0])
    write_spl(os.path.join(wd, "SPL.px.00000"), d0, nparts=2)
    xh, vh, mh = read_ascii_arrays(os.path.join(wd, "halo.bods"))
    npx, ncl = len(d0.components[0].mass), len(mh)
    write_psp(os.path.join(wd, "OUT.cl.00000"), PSPDump(time=0.0, components=[
        PSPComponent(name="halo", info="name: halo\n", mass=mh, x=xh, v=vh,
                     pot=np.zeros(len(mh)))]))
    snap = Snapshot(0.25)
    snap.add("dark", xh, vh, mh, pot=np.zeros(len(mh)))
    write_tipsy(os.path.join(wd, "halo.tipsy"), snap)
    if _has_h5py():
        import h5py

        with h5py.File(os.path.join(wd, "none.hdf5"), "w") as f:
            f.create_group("Header").attrs["MassTable"] = np.zeros(6)
            g = f.create_group("PartType2")
            g.create_dataset("Coordinates", data=xh[:64])
            g.create_dataset("Acceleration", data=vh[:64])
    print("CL2 host clock: " + json.dumps({
        "prepare_s": time.perf_counter() - t0}), flush=True)
    # (tool, argv, files it must write, a word its output must hold,
    # needs h5py); the longest first
    runs = [
        ("gendisk", ["-N", "4096", "--halo", "hernquist", "--nhalo", "8192",
                     "--mmax", "2", "--nmaxd", "6", "--lmax", "2",
                     "--nmaxh", "6", "-o", "gd.bods", "--ohalo", "gh.bods"],
         ["gd.bods", "gh.bods"], "-2T/VC=", False),
        ("forcetest", [px[0], "--comp", "halo", "--nsample", "500"], [],
         "p50 relative force error", False),
        ("psp2ascii", [px[0], "-o", "px0"], ["px0.halo.ascii"], "wrote",
         False),
        ("psporbv", ["-f", px[1], "-c", "halo", "-m", "hernquist", "-R",
                     "2.0", "-k", "0.9", "-s", "px", "--nE", "24", "--nK",
                     "12", "-N", "8"], ["orbv.px", "orbv.px.histo"],
         "orbits", False),
        ("pspmono", [px[2], "--comp", "halo", "-o", "mono.model"],
         ["mono.model"], "pspmono: wrote", False),
        ("psp2bess", ["-T", "px", "-c", "halo", "-e", "0", "-R", "2.0"],
         ["px.bess_coefs"], "1 snapshot block(s)", False),
        ("psp2lagu", ["-T", "px", "-c", "halo", "-e", "0", "-a", "0.5"],
         ["px.lagu_coefs"], "1 snapshot block(s)", False),
        ("psp2rings", ["-T", "px", "-c", "halo", "-e", "0", "-R", "2.0"],
         ["px.ring_coefs"], "1 snapshot block(s)", False),
        ("psp2vtu", ["-T", "cl", "-c", "halo", "--dens", "8",
                     "OUT.cl.00000"], ["cl_00000.vtu"], f"{ncl} points",
         False),
        ("pspinfo", [px[0]], [], f"ntot={npx}", False),
        ("pspstat", [px[0]], [], f"N={npx}", False),
        ("ascii2psp", ["halo.bods", "-o", "halo.psp", "--name", "halo"],
         ["halo.psp"], "wrote", False),
        ("snap2ascii", ["OUT.cl.00000", "--comp", "halo", "-o", "cl.ascii"],
         ["cl.ascii"], f"{ncl} bodies", False),
        ("diffpsp", [px[0], px[0]], [], "max=0", False),
        ("pspinterp", [px[0], px[1], "-t", "0.05", "-o", "interp.psp"],
         ["interp.psp"], "w=0.5000", False),
        ("psp2hdf5", [px[0]], [px[0] + ".h5"], "wrote", True),
        ("shrinkics", ["halo.bods", "-f", "4"], ["halo.bods.shrink"],
         "mass conserved", False),
        ("psphisto", [px[4], "--field", "r", "--log"],
         [px[4] + ".histo.r"], "wrote", False),
        ("pspbox", [px[5], "--radius", "1.0"], [px[5] + ".box"],
         "bodies kept", False),
        ("snapconvert", [px[6], "--to", "tipsy", "-o", "px6.tipsy"],
         ["px6.tipsy"], "wrote", False),
        ("snapconvert", [px[6], "--to", "gadgethdf5", "-o", "px6.hdf5"],
         ["px6.hdf5"], "wrote", True),
        ("snap2vtk", [px[7], "--stride", "16"], [px[7] + ".vtk"], "points",
         False),
        ("psp2range", [px[0]], [], f"{npx} bodies", False),
        ("pspreal", [px[1], "-o", "px1.real4"], ["px1.real4"],
         "pspreal: wrote", False),
        ("spl2psp", ["-r", "px", "-p", "SPLOUT"], ["SPLOUT.px.00000"],
         "wrote 1 PSP file", False),
        ("tipstd2psp", ["halo.tipsy", "tip.psp"], ["tip.psp"], "wrote",
         False),
        ("modelfit", ["halo.bods", "--family", "hernquist", "-o",
                      "fit.model"], ["fit.model"], "hernquist:", False),
        ("addring", ["halo.bods", "-o", "ring.bods", "--nring", "1000"],
         ["ring.bods"], "1000 ring particles", False),
        ("addsphmod", ["hernquist", "plummer", "-o", "combo.model"],
         ["combo.model"], "wrote", False),
        ("hdf52accel", ["--hdf5", "none.hdf5"], ["force.data"],
         "hdf52accel: wrote", True),
        ("cubeics", ["-N", "65536"], ["cube.bods"], "cubeics: wrote", False),
        ("genslab", ["-N", "65536", "-o", "genslab.bods"], ["genslab.bods"],
         "genslab: wrote", False),
        ("gendisk", ["-N", "65536", "-o", "disk65.bods"], ["disk65.bods"],
         "gendisk: wrote", False),
        ("bonnerebert", ["-N", "1000", "-o", "be.bods"], ["be.bods"], "",
         False),
    ]
    return [("CL2",) + r for r in runs]


def _has_h5py():
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def _tool_env():
    """The children's environment: the repository on PYTHONPATH, and one
    thread each for BLAS and torch, so that the children share the cores
    with the process that drives the card."""
    import os

    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[k] = "1"
    return env


def tool_pool(wd, runs):
    """Start `runs` (phase, tool, argv, files, word, needs h5py) as
    `python -m exp_tpu_torch.cli <tool> argv` children in `wd` on a host
    thread, at most os.cpu_count() - 1 at once (a core is left to the
    process that drives the card), in the order given.  Returns the pool
    for `tool_results`."""
    import os
    import threading

    width = max(1, (os.cpu_count() or 1) - 1)
    logs = os.path.join(wd, "tool_logs")
    os.mkdir(logs)
    pool = {"runs": runs, "wd": wd, "width": width, "done": {},
            "error": None, "t0": time.perf_counter()}
    env = _tool_env()

    def drive():
        todo, live = list(enumerate(runs)), {}
        try:
            while todo or live:
                while todo and len(live) < width:
                    i, (_, tool, argv, _, _, _) = todo.pop(0)
                    fo = open(os.path.join(logs, f"{i}.out"), "w+")
                    fe = open(os.path.join(logs, f"{i}.err"), "w+")
                    live[i] = (subprocess.Popen(
                        [sys.executable, "-m", "exp_tpu_torch.cli", tool]
                        + argv, cwd=wd, env=env, stdout=fo, stderr=fe,
                        text=True), fo, fe, time.perf_counter())
                for i in [i for i, v in live.items()
                          if v[0].poll() is not None]:
                    p, fo, fe, ts = live.pop(i)
                    fo.seek(0)
                    fe.seek(0)
                    pool["done"][i] = (p.returncode, fo.read(), fe.read(),
                                       time.perf_counter() - ts)
                    fo.close()
                    fe.close()
                if time.perf_counter() - pool["t0"] > 900:
                    raise TimeoutError(f"{sorted(live)} still running after "
                                       "900 s")
                time.sleep(0.05)
        except Exception as e:      # reported by tool_results
            pool["error"] = repr(e)
        finally:
            for p, fo, fe, _ in live.values():
                p.kill()
                p.wait()
                fo.close()
                fe.close()
            pool["wall_s"] = time.perf_counter() - pool["t0"]

    pool["thread"] = threading.Thread(target=drive, daemon=True)
    pool["thread"].start()
    return pool


def tool_results(pool):
    """Wait for the pool and check each run: exit 0, its files written and
    its word printed, or, for a run that needs h5py where it is missing, a
    loud refusal naming h5py.  Then the finite checks of the tables CL1
    and CL2 write, and each phase's host clock."""
    import os

    import numpy as np

    from exp_tpu_torch.basis.model import SphericalModelTable

    pool["thread"].join(timeout=960)
    if pool["thread"].is_alive() or pool["error"]:
        raise AssertionError(f"the tools' pool: {pool['error'] or 'hung'}")
    wd, done, has_h5py = pool["wd"], pool["done"], _has_h5py()
    bad, refused = [], []
    for i, (phase, tool, argv, want, word, hdf5) in enumerate(pool["runs"]):
        rc, out, err, sec = done[i]
        last = (out.strip().splitlines() or [""])[-1]
        tail = (err.strip().splitlines() or [""])[-1]
        if hdf5 and not has_h5py:
            ok = (rc != 0 and "h5py" in tail and tail.split(":")[0] in
                  ("ImportError", "ModuleNotFoundError"))
            if phase == "CL2":
                refused.append(tool if tool != "snapconvert"
                               else "snapconvert --to gadgethdf5")
            print(f"{phase} {tool} {' '.join(argv[-2:])}: exit {rc}, "
                  f"{sec:.1f} s, refused: {tail!r}", flush=True)
        else:
            missing = [f for f in want
                       if not os.path.exists(os.path.join(wd, f))]
            ok = rc == 0 and not missing and word in out
            print(f"{phase} {tool}: exit {rc}, {sec:.1f} s, wrote {want}, "
                  f"'{word}' printed {word in out}: {last}", flush=True)
        if not ok:
            bad.append(f"{phase} {tool}")
            print(f"{phase} {tool} stderr:\n{err[-3000:]}", flush=True)
    psp = next(r[2][0] for r in pool["runs"] if r[1] == "haloprof")
    for f in ("disk.bods.diskprof", psp + ".haloprof", "slshift.profile",
              "slab.bods.slabprof", "orbv.px"):
        if not np.isfinite(np.loadtxt(os.path.join(wd, f))).all():
            bad.append(f)
    for f in ("mono.model", "fit.model", "combo.model"):
        mt = SphericalModelTable.from_file(os.path.join(wd, f))
        if not all(np.isfinite(a).all() for a in (mt.r, mt.rho, mt.mass,
                                                  mt.pot)):
            bad.append(f)
    if bad:
        raise AssertionError(f"the tools: {bad} failed")
    print("CL2 not run on the card, their inputs or outputs being HDF5 and "
          "the card's machine having no h5py (refused loudly above; the CPU "
          "tests hold them against exp_tpu's): " + json.dumps(refused),
          flush=True)
    for phase in ("CL1", "CL2"):
        idx = [i for i, r in enumerate(pool["runs"]) if r[0] == phase]
        print(f"{phase} host clock: " + json.dumps({
            "children": len(idx), "child_s": {
                f"{pool['runs'][i][1]} {i}": done[i][3] for i in idx}}),
              flush=True)
    print("tools' pool host clock: " + json.dumps({
        "wall_s": pool["wall_s"], "children": len(done),
        "at_once": pool["width"]}), flush=True)


# ---------------------------------------------------------------------------
# VR1: the f64 comparator on the card (exp_tpu_torch/bench_validate.py)
# ---------------------------------------------------------------------------

# VR1 (a): tests/test_reference_comparator.py's gates, unchanged
VR1A_STEP_COEF = 1e-12
VR1A_STEP_ATOL = 1e-12      # beyond rtol 1e-10, accelerations and potential
VR1A_DRIFT_25 = 1e-6
VR1A_DRIFT_300 = 1e-9
# VR1 (b) and (c): f32 kernels against the f64 comparator; each bound is
# three times the same figure from the kernels' plain versions on a CPU
# (the rule of MF1's and IC2's bounds).  (b): python -m
# exp_tpu_torch.bench_validate b --device cpu --threads 1, the largest
# max|c - c_ref| / max|c_ref| over the 25 steps (4.51e-7; at step 25
# 1.35e-7; the same at 3, 4 and 8 threads, 3.38e-7 at 2: f32 sums in
# another order)
VR1B_CPU = {"drift_max": 4.5102455053879105e-07}
# (c): python -m exp_tpu_torch.bench_validate c --device cpu --threads 4
# (2^20 rows): max|d| / max|ref| of the coefficients, the accelerations
# (the f32 cell difference of nearly equal nodes dominates) and the
# potential
VR1C_CPU = {"coef_rel": 7.173741442808491e-08,
            "acc_rel": 0.00031785449439627973,
            "pot_rel": 4.7583621641428725e-07}


def validate_path(dev, tables, xe, me):
    """Phase VR1 on the card (exp_tpu_torch/bench_validate.py): (a) the
    port's f64 gather step (deriv 'lerp') on the card against
    ReferenceSphereStep on the host, at the JAX test's gates; (b) the same
    problem through K1 'hat' and K2 'hat' (pallas_precision 'highest', the
    hats on the table's own nodes), 26 launches each over 25 steps,
    against the comparator's trajectory; (c) the sphere cell's `tables`
    under (b)'s settings, one K1 projection of phase 5's (xe, me) and one
    K2 force evaluation against the comparator's.  Returns the kernels-line
    rows of K1 and K2 in (b) and (c)."""
    import numpy as np
    import torch

    from exp_tpu_torch import bench_validate as bv
    from exp_tpu_torch.ops import sphere_kernels as sk

    prob = bv.problem()
    t0 = time.perf_counter()
    ref_traj = bv.reference_run(*prob, bv.A_STEPS)
    host = {"comparator_300_steps_s": time.perf_counter() - t0}

    # (a)
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    ra = bv.case_a(dev, prob=prob, ref_traj=ref_traj)
    host["a_s"] = time.perf_counter() - t0
    _want_launches("VR1 (a)", dict(sk.launch_counts), {})
    print("VR1 (a) f64 gather step on the card: " + json.dumps(ra),
          flush=True)
    if not (ra["step_coef_rel"] < VR1A_STEP_COEF
            and ra["step_acc_excess"] <= VR1A_STEP_ATOL
            and ra["step_pot_excess"] <= VR1A_STEP_ATOL
            and ra["drift_25"] < VR1A_DRIFT_25
            and ra["drift_max"] < VR1A_DRIFT_300):
        raise AssertionError(f"VR1 (a): {ra}")

    # (b)
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    rb, fb = bv.case_b(dev, prob=prob, ref_traj=ref_traj)
    host["b_s"] = time.perf_counter() - t0
    lb = dict(sk.launch_counts)
    rb["bound"] = 3 * VR1B_CPU["drift_max"]
    rb["launches"] = lb
    print("VR1 (b) K1 'hat' + K2 'hat' steps: " + json.dumps(rb),
          flush=True)
    _want_launches("VR1 (b)", lb, {"sphere_coef": bv.B_STEPS + 1,
                                   "sphere_accel": bv.B_STEPS + 1})
    if not rb["drift_max"] <= rb["bound"]:
        raise AssertionError(f"VR1 (b): drift {rb['drift_max']} exceeds "
                             f"{rb['bound']}")

    # (c)
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    rc, (fc, x32, m32) = bv.case_c(dev, tables=tables, x=xe, mass=me)
    host["c_s"] = time.perf_counter() - t0
    lc = dict(sk.launch_counts)
    rc["bound"] = {k: 3 * v for k, v in VR1C_CPU.items()}
    rc["launches"] = lc
    print("VR1 (c) one K1 + one K2 at the sphere cell's width: "
          + json.dumps(rc), flush=True)
    _want_launches("VR1 (c)", lc, {"sphere_coef": 1, "sphere_accel": 1})
    for k, b in rc["bound"].items():
        if not rc[k] <= b:
            raise AssertionError(f"VR1 (c): {k} {rc[k]} exceeds {b}")

    # each kernel against its plain version on (b)'s and (c)'s inputs
    tb, xb, _, mb = prob
    xb = torch.as_tensor(xb, dtype=torch.float32, device=dev)
    mb = torch.as_tensor(mb, dtype=torch.float32, device=dev)
    rows = []
    for tag, f, x, m, launches in (("(b)", fb, xb, mb, lb),
                                   ("(c)", fc, x32, m32, lc)):
        prm = f._kernel_params()
        tab = f._radial_table()
        c = sk.sphere_coef(x, m, tab, f.Mp, prm)
        c0 = sk.sphere_coef_plain(x, m, tab, f.Mp, prm)
        twT = f.accel_table(c0)
        a, p = sk.sphere_accel(x, twT, f.fac32, prm)
        a0, p0 = sk.sphere_accel_plain(x, twT, f.fac32, prm)
        torch.cuda.synchronize()
        k1_rel = float((c - c0).abs().max() / c0.abs().max())
        da, dp = (a - a0).abs(), (p - p0).abs()
        ok = (k1_rel <= COEF_RTOL
              and bool((da <= ACC_ATOL + ACC_RTOL * a0.abs()).all())
              and bool((dp <= POT_ATOL + POT_RTOL * p0.abs()).all()))
        print(f"VR1 {tag} against the plain versions: K1 max|dc|/max|c| "
              f"{k1_rel:.3e}, K2 max|da| {float(da.max()):.3e} max|dpot| "
              f"{float(dp.max()):.3e} (phase 4's tolerances)", flush=True)
        if not ok:
            raise AssertionError(f"VR1 {tag}: a kernel disagrees with its "
                                 "plain version")
        r = x.norm(dim=1) + 1e-10
        n_in = int(((r >= prm.rmin) & (r <= prm.rmax) & (m > 0)).sum())
        what = (f"VR1 {tag} hat, lmax {prm.lmax}, {prm.nc} nodes, "
                f"{x.shape[0]} rows")
        rows.append(_an_row(
            f"sphere_coef[{what}]", "sphere_coef.cu",
            "exp_tpu/ops/pallas_sphere.py:521", launches["sphere_coef"],
            float((c - c0).abs().max()),
            lambda x=x, m=m, tab=tab, f=f, prm=prm: sk.sphere_coef(
                x, m, tab, f.Mp, prm),
            lambda x=x, m=m, tab=tab, f=f, prm=prm: sk.sphere_coef_plain(
                x, m, tab, f.Mp, prm),
            k1_work(x.shape[0], n_in, prm.lmax, prm.nmax, prm.rows, "hat")))
        rows.append(_an_row(
            f"sphere_accel[{what}]", "sphere_accel.cu",
            "exp_tpu/ops/pallas_sphere.py:398", launches["sphere_accel"],
            max(float(da.max()), float(dp.max())),
            lambda x=x, twT=twT, f=f, prm=prm: sk.sphere_accel(
                x, twT, f.fac32, prm),
            lambda x=x, twT=twT, f=f, prm=prm: sk.sphere_accel_plain(
                x, twT, f.fac32, prm),
            k2_work(x.shape[0], prm.lmax, prm.rows, "hat")))
    host["rows_s"] = time.perf_counter() - t0 - host["c_s"]
    print("VR1 host clock: " + json.dumps(host), flush=True)
    return rows



def main():
    import torch

    t_start = time.perf_counter()

    def clock(path):
        print(f"clock: {path} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from exp_tpu_torch.bench_sphere import (bench_sphere, equilibrium_sample,
                                            hernquist_sample_np, kdk_run,
                                            sphere_tables)
    from exp_tpu_torch.forces.spherical import SphereSL
    from exp_tpu_torch.ops import _build
    from exp_tpu_torch.ops import sphere_kernels as sk

    # 1. the card
    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    # every matmul of the port's glue (the table contractions, and the
    # multistep's rotation of positions when one is given) runs in full
    # FP32: TF32 would round positions to 10 bits of mantissa
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs them off")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'already built'})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if line.startswith("nvcc "):
                print("  " + line)

    # 3. tables and the force
    t0 = time.perf_counter()
    tables = sphere_tables(lmax=4, nmax=10)
    force = SphereSL.from_tables(tables, backend="pallas", device=dev)
    prm = force._kernel_params()
    print(f"tables + force: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. kernels against their plain versions, at the main path's shapes
    xb, _, mb = hernquist_sample_np(N, seed=0)
    ex, em = edge_rows(N)
    x = torch.tensor(np.concatenate([xb, ex]), dtype=torch.float32,
                     device=dev)
    m = torch.tensor(np.concatenate([mb, em]), dtype=torch.float32,
                     device=dev)
    c = sk.sphere_coef(x, m, force.tabc_s, force.Mp, prm)
    c0 = sk.sphere_coef_plain(x, m, force.tabc_s, force.Mp, prm)
    torch.cuda.synchronize()
    k1_err = float((c - c0).abs().max())
    k1_rel = k1_err / float(c0.abs().max())
    print(f"K1 vs plain: max|dc| = {k1_err:.3e}, max|dc|/max|c| = "
          f"{k1_rel:.3e} (tolerance {COEF_RTOL:.0e})", flush=True)
    if not k1_rel <= COEF_RTOL:
        raise AssertionError(f"K1 disagrees with its plain version: {k1_rel}")

    twT = force.accel_table(c0)
    a, p = sk.sphere_accel(x, twT, force.fac32, prm)
    a0, p0 = sk.sphere_accel_plain(x, twT, force.fac32, prm)
    torch.cuda.synchronize()
    da, dp = (a - a0).abs(), (p - p0).abs()
    k2_err = max(float(da.max()), float(dp.max()))
    worst_a = int(torch.argmax((da - ACC_RTOL * a0.abs()).max(dim=1).values))
    worst_p = int(torch.argmax(dp - POT_RTOL * p0.abs()))
    print(f"K2 vs plain: max|da| = {float(da.max()):.3e} (|a| up to "
          f"{float(a0.abs().max()):.3e}), max|dpot| = {float(dp.max()):.3e}; "
          f"worst acc row {worst_a} r = "
          f"{float(x[worst_a].norm()):.4g} rho = "
          f"{float(x[worst_a, :2].norm()):.3e}; tolerance acc rtol "
          f"{ACC_RTOL:.0e} atol {ACC_ATOL:.0e}, pot rtol {POT_RTOL:.0e} "
          f"atol {POT_ATOL:.0e}", flush=True)
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(p).all())
    ok_a = bool((da <= ACC_ATOL + ACC_RTOL * a0.abs()).all())
    ok_p = bool((dp <= POT_ATOL + POT_RTOL * p0.abs()).all())
    if not (finite and ok_a and ok_p):
        raise AssertionError(
            f"K2 disagrees with its plain version (finite={finite}, "
            f"acc ok={ok_a}, pot ok={ok_p}; worst pot row {worst_p})")

    # 5. the main path: init + STEPS KDK steps of an equilibrium sample
    t0 = time.perf_counter()
    xe, ve, me = equilibrium_sample(N, seed=0)
    print(f"equilibrium sample of {N}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    sk.reset_launch_counts()
    run = kdk_run(force, xe, ve, me, steps=STEPS, dt=DT, device=dev)
    torch.cuda.synchronize()
    launches = dict(sk.launch_counts)
    print("main path: " + json.dumps({**run, "launches": launches}),
          flush=True)
    if not run["finite"]:
        raise AssertionError("non-finite state after the KDK run")
    for name, cnt in launches.items():
        want = STEPS + 1 if name in ("sphere_coef", "sphere_accel") else 0
        if cnt != want:
            raise AssertionError(f"{name} launched {cnt} times, expected "
                                 f"{want}")
    for key in ("virial0", "virial1"):
        if not abs(run[key] - 1.0) <= VIRIAL_TOL:
            raise AssertionError(f"2T/VC {key} = {run[key]}")
    if not run["dE_rel"] < DRIFT_BOUND:
        raise AssertionError(f"|dEtot/Etot| = {run['dE_rel']} over "
                             f"{STEPS} steps exceeds {DRIFT_BOUND}")

    # 6. timing
    bench = bench_sphere(n=N, reps=30, tables=tables, device=dev)
    print("step: " + json.dumps(bench), flush=True)

    n_in = int(((x.norm(dim=1) + 1e-10 >= prm.rmin)
                & (x.norm(dim=1) + 1e-10 <= prm.rmax) & (m > 0)).sum())
    b1, o1 = k1_work(x.shape[0], n_in, 4, 10, prm.rows)
    b2, o2 = k2_work(x.shape[0], 4, prm.rows)
    rows = []
    for name, src, line, fn, plain, err, (byts, ops) in (
            ("sphere_coef", "exp_tpu_torch/csrc/sphere_coef.cu",
             "exp_tpu/ops/pallas_sphere.py:521",
             lambda: sk.sphere_coef(x, m, force.tabc_s, force.Mp, prm),
             lambda: sk.sphere_coef_plain(x, m, force.tabc_s, force.Mp, prm),
             k1_err, (b1, o1)),
            ("sphere_accel", "exp_tpu_torch/csrc/sphere_accel.cu",
             "exp_tpu/ops/pallas_sphere.py:398",
             lambda: sk.sphere_accel(x, twT, force.fac32, prm),
             lambda: sk.sphere_accel_plain(x, twT, force.fac32, prm),
             k2_err, (b2, o2))):
        bms, by = bound_ms(byts, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": line,
            "launches": launches[name], "max_abs_err": err,
            "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "bytes": byts, "operations": ops})
    clock("disk")
    disk_rows, disk_tables = disk_path(dev)
    rows += disk_rows
    clock("cube")
    rows += cube_path(dev)
    clock("slab")
    rows += slab_path(dev)
    clock("sphere settings")
    rows += sphere_settings_path(dev, tables, xe, ve, me)
    clock("composite")
    comp_rows, comp = composite_path(dev, tables, disk_tables)
    rows += comp_rows
    clock("sweep")
    sweep_path(dev, tables, disk_tables, rows)
    clock("driver")
    r4, work, r2 = driver_path(dev, tables, comp, xe, ve, me)
    clock("extras")
    extras_path(dev, work.name, r4)
    clock("forces")
    rows += forces_path(dev, xe, ve, me)
    clock("relevel")
    rows += relevel_path(dev, comp)
    clock("multi-rank")
    rows += multi_path(dev, tables, comp, work.name, r2, xe, ve, me)
    clock("world extras")
    rows += world_extras_path(dev, tables, work.name, xe, ve, me)
    clock("native reader")
    native_path(work.name)
    work.cleanup()
    clock("ICs")
    rows += ic_path(dev, force)
    clock("analysis")
    rows += analysis_path(dev, comp, disk_tables, xe, ve, me)
    clock("pyEXP")
    px_rows, px_work, px_files = pyexp_path(dev, comp, disk_tables, xe, ve,
                                            me)
    rows += px_rows
    clock("tools")
    cl1 = tools_path(comp, xe, ve, me, px_work, px_files)
    clock("PhaseSpace tools")
    cl2 = psptools_path(px_work, px_files)
    clock("phase stream")
    rows += phasestream_path(dev)
    clock("comparator")
    rows += validate_path(dev, tables, xe, me)
    print(json.dumps({"kernels": rows}), flush=True)
    # the energy bars last: their runs are the longest.  Beside them, on
    # the host's other cores, CL1's and CL2's tools run as children (host
    # work but for forcetest's and gendisk's projections), their longest
    # first; their results are checked after the bars
    clock("energy, with the tools' children")
    pool = tool_pool(px_work.name, cl1[:1] + cl2 + cl1[1:])
    energy_path(dev, comp)
    clock("the tools' results")
    tool_results(pool)
    px_work.cleanup()
    clock("end")
    del comp, r2
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
