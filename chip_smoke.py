"""Smoke run of the PyTorch/CUDA port (nextsimdg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``nextsimdg_tpu_torch/csrc`` and
drives the port's roofline path, its six model paths and, since dG0 and
dG2 were ported, BASELINE config 2 and the degree variants, and since the
momentum forms were ported, the battery's ``box_adaptive`` and
``coupled_1m_aweighted`` and the forms' other paths (below). The roofline path
(``nextsimdg_tpu_torch.benchmarks.roofline``, the twin of
``benchmarks/roofline.py``): the ``chain`` kernel (csrc/roofline.cu, the
counterpart of the TPU kernel ``measure_vpu_peak``), a float32 chain held in
registers, measures the card's fused float32 ceilings (fma: the TPU kernel's
x = a*x + b; fma_imm: the addend an immediate, the FFMA issue rate) and its
unfused one (mul_add, as the port's kernels issue), and a streaming add its
HBM rate. The model paths run float32,
dG1 tracers (hice, cice, hsnow), 100 mEVP subcycles, dt = 600 s,
CFL-adaptive transport substeps:

* the headline dynamics-only step (BASELINE config 3, ``bench.py``): a
  closed 256 x 256 mesh of 2 km elements, wind (8, 2) m/s, ocean current
  (0.02, 0) m/s, on ``mevp_backend="pallas"``: fused_dynamics, the whole
  dynamics phase in one cooperative launch with k on the card (K1 as the
  TPU kernel runs it; phase ``check_fused`` holds it against
  the plain phase and K1's split schedule of mevp_stress, mevp_velocity,
  dg1_sample_cfl and dg1_rk_stage, and times the "auto" threshold);
* the coupled thermo+dynamics step of BASELINE config 4
  (``benchmarks/run_benchmarks.py`` ``bench_coupled_1m``): a closed
  1024 x 1024 mesh of 4 km elements, initial hice 1.2, cice 0.95, hsnow
  0.1, physics forcing tair -15, dew2m -17, pair 1e5, sw_in 5, lw_in 240,
  mld 10, snowfall 1e-4, wind 6; wind (6, 3) m/s, ocean (0.02, 0) m/s, on
  the default ("auto") schedule, the ghost-zone tiled kernels mevp_tiled
  and transport_tiled (persistent blocks that copy the next window while
  they compute this one) with dg1_sample_cfl, and the column physics;
* config 4's spherical coastline variant (``run_benchmarks.py``
  ``coupled_1m_spherical``, ``bench_coupled_1m(land_mask=True,
  spherical=True)``): the same step on a closed 1024 x 1024 lon-lat window
  (40W-40E, 55N-85N) with ``synthetic_coastline(1024)``, on
  ``mevp_backend="pallas"``: mevp_single (all 100 subcycles in one
  cooperative launch) with the metric planes, dg1_sample_cfl and the
  metric transport_tiled with the coastline face masks;
* the higher-order (CG2 velocity, dG1 stress) coupled step
  (``run_benchmarks.py`` ``ho_coupled_1m``, ``bench_coupled_1m(high_order=True)``):
  config 4's mesh, state and forcing with ``Nextsim::IDynamics =
  Nextsim::MEVPHighOrder`` selected through the module registry, on "auto":
  ho_tiled (ghost-zone windows of the 17 HO state planes, one a
  thread-block cluster launch, shipped as clusters of one block: one 48^2
  window a block; sm_90 or newer), the CG2 velocity
  sampled at the quadrature points, and the ``qv`` form of transport_tiled;
  and the same at 256^2 on ``mevp_backend="pallas"`` (``ho_coupled_256``):
  ho_single, all 100 HO subcycles in one cooperative launch whose tiles
  stay in shared memory and swap their edges with their neighbours only;
  then that step with ``transport_backend="xla"`` (``ho_coupled_256_staged``)
  and with rk3 (``ho_coupled_256_rk3``), whose transport is the
  staged dg1_rk_stage in its qv form (one launch per RK stage on the CG2
  velocity's quadrature samples);
* BASELINE config 5 (``run_benchmarks.py`` ``bench_multihost_16m``,
  ``multihost_16m``): a closed 4096 x 4096 mesh of 2 km elements with
  config 4's state and forcing, decomposed over a 2 x 2 grid of 2048^2 rank
  blocks held by this process on the one card (``parallel.RankGrid``; each
  rank a thread with a compute and a copy stream), on "auto" (the blocked
  exchange: mevp_tiled on blocks widened by h = 16 ghost cells once per 16
  subcycles) and on "rdma" (K7: rdma_stage, the strips copied while
  mevp_tiled runs the interior, rdma_band on the patch's cone of the edge
  bands, by clusters of blocks along each band); the
  transport is transport_tiled on the block widened by H ghost cells, the
  CFL count one max over the ranks;
* BASELINE config 2 (``run_benchmarks.py`` ``bench_advection``,
  ``advection``): a closed 128 x 128 unit square, solid-body rotation
  sampled at the quadrature points, a Gaussian at (0.5, 0.7) of width 0.01
  projected, dt = 0.2/(128 2 pi), chunks of 400 unlimited steps
  (``DGTransport.run``: dg1_rk_stage's no-limit instance, one launch a
  stage), at dG2 (rk3) and dG1 (rk2); and the degree variants: the
  headline and config 4 at dG0 (rk1) and dG2 (rk3, on transport_tiled at
  1024^2), the HO 256^2 step at dG2 and a 2 x 2 rank grid of 256^2 blocks
  at dG2 (the spmd transport_tiled with rk3);
* fused_dynamics in every other form it runs (phase
  ``check_fused_forms``): at 256^2 periodic in x and in both axes,
  A-weighted, adaptive alpha, dG0 (rk1), dG2 (rk3), TVB at dG1 (a middle
  M) and dG2 (M = 0) and all of them at once with the coastline, each
  against the plain phase and K1's split schedule in that form, each
  form's path (the headline box in the form, "pallas") three steps, k on
  the card equal to the host's, no host sync; the battery's
  ``box_adaptive`` on "auto"; the "auto" threshold of ``box_adaptive``
  and of dG2 with TVB. Where the headline's variants (dG0, dG2,
  ``box_adaptive``, periodic TVB) ran K1's split kernels before, their
  ``_k1`` paths pin that schedule (``K1_SPLIT``, ``K1_PINNED``), so that
  K1's kernels keep their checks in those forms;
* the momentum forms of ``MEVPParams`` (phase ``check_momentum_forms``):
  the battery's ``box_adaptive`` (``bench_box`` with adaptive alpha = beta:
  the headline box on "auto", mevp_tiled, and on K1's schedule) and
  ``coupled_1m_aweighted`` (config 4 with the A-weighted stresses, on
  "auto"), the spherical coastline step A-weighted on mevp_single, the
  headline box with ``Nextsim::FreeDrift`` (its momentum step plain
  PyTorch, as in the JAX package; dg1_sample_cfl and transport_tiled), and
  the A-weighted 2 x 2 rank grid of 256^2 blocks (blocked: mevp_tiled on
  the widened blocks);
* periodic axes and the TVB slope limiter (phase ``check_tvb_periodic``):
  (a) the headline box periodic in both axes, dG1 rk2, from a state with
  fronts (a seeded patch of thicker, looser ice and seeded moments), with
  ``tvb_m`` = 0 (pure TVD) and with a middle M taken from that step's
  |psi1| (the limiter then cuts some elements and keeps others: both
  shares printed), on "auto" (mevp_tiled, transport_tiled's TVB form), on
  K1's schedule (dg1_rk_stage's unlimited stage and dg1_limit a stage) and
  on mevp_tiled with the staged transport; (b) config 4 periodic in both
  axes at dG2 rk3 with the same two M on the same three schedules; (c) a
  1024^2 lon-lat ring (0-360E, 60-85N, periodic in x) with the coastline,
  without TVB on "auto" (mevp_single with its tiles in a ring,
  transport_tiled), on mevp_single with the staged transport and on
  mevp_tiled, and with M = 0 on "auto" (mevp_single, the staged transport
  with dg1_limit and its tolerance planes) and on mevp_tiled;
* the HO solver's A-weighted and periodic forms (phase ``check_ho_forms``):
  the battery's ``ho_coupled_1m_periodic`` (``bench_coupled_1m(
  high_order=True, periodic=True)``: config 4 with both axes periodic, on
  "auto": ho_tiled's periodic form and transport_tiled's periodic qv form),
  the same with tvb_m = 0 (the qv TVB form), the HO 256^2 step periodic in
  both axes on ho_single with the staged transport (dg1_rk_stage's periodic
  qv stage; with tvb_m = 0 its TVB stage and dg1_limit), and the A-weighted
  HO step (``MEVPParams(a_weighted_stress=True)``) at 1024^2 on ho_tiled and
  at 256^2 on ho_single;
* the HO solver on graded and spherical meshes (phase ``check_ho_metric``):
  the HO spherical coastline step at 1024^2 (``bench_coupled_1m(
  land_mask=True, spherical=True, high_order=True)``'s model, "auto":
  ho_tiled's metric form and transport_tiled's metric qv form), also
  A-weighted; the same window at 256^2 (ho_single's metric form, with
  transport_tiled and with the staged dg1_rk_stage); the 1024^2 ring with
  the coastline (ho_tiled's metric form wrapped in x, with transport_tiled's
  periodic metric qv form, with the staged periodic metric qv stage, and
  with M = 0 its TVB stage and dg1_limit); and a graded 256^2 RectMesh
  on ho_single and on ho_tiled;
* the rank grid on graded, spherical and periodic meshes (phase
  ``check_grid_forms``, ROADMAP M10b part 1): the battery's
  ``coupled_1m_spherical_spmd`` (the 1024^2 spherical coastline window,
  config 4's state and forcing, on 2 x 2 ranks of 512^2
  ``LocalMeshView`` blocks: the blocked schedule, mevp_tiled with the
  widened metric consts, and rdma, rdma_band's metric form; the spmd
  transport_tiled with the widened metric planes) and
  ``spherical_16m_spmd`` (the same at 4096^2 on 2048^2 blocks: BASELINE
  config 5 on the spherical coastline domain); the 1024^2 ring with the
  coastline on rdma on 2 x 2, 2 x 1 (a ring of two ranks) and 1 x 2 (the
  ring's axis not split: mevp_tiled's periodic interior, rdma_band's ring
  form) and blocked on 1 x 2; config 4 periodic in both axes with
  ``tvb_m`` = 0 and a middle M, and closed with M = 0 (transport_tiled's
  rank grid TVB form: the global walls inside the widened block); the
  A-weighted config 4 and ``box_adaptive``'s forms on rdma; free drift on
  config 4;
* the engine (``nextsimdg_tpu_torch.runtime``, ``python -m
  nextsimdg_tpu_torch``), which runs no kernel: BASELINE config 1
  (``run/dev1.cfg``: the 10 x 10 devgrid restart, 1 step of 1 s, dummy
  forcing) through ``main()``, and a seeded 1024^2 rectgrid restart
  (1,048,576 columns, config 4's grid: a pan-Arctic-size thermodynamics run)
  for 20 steps of 600 s with a checkpoint every 10, with ThermoIce0 on 1
  layer and with ThermoWinton (selected by ``[Modules]``) on 3. Restart files
  need h5py: where it is not installed the same runs start from the
  in-memory restart (``Model.configure(fields)``) and write no file, and the
  script says so.

Phases, each printed on its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: the kernels' compile (or cache hit) time, registers and spills;
   the launch of the cluster kernels at their paths' shapes (ho_tiled at
   1024^2, shipped and in 2 x 2 clusters; rdma_band on config 5's bands,
   with its launch bound): cluster shape, sub-window or
   segment, threads, shared bytes, registers, the clusters the card holds
   at once, the blocks of a launch and the SMs it reaches; and, printed
   after the checks (``cuobjdump -sass`` of the library runs
   beside them), the FFMA, FMUL and FADD counts of the chain kernel's fma,
   fma_imm and mul_add forms: --fmad=false must leave the first two fused
   and the third unfused;
3. roofline: the chain kernel against its plain version for every link
   (fma, mul_add, div, sqrt, shift0, shift1, fma_imm) and both unrolls (16,
   64), on seeded planes at 512^2 and 1000 x 968, 160 and 128 links; then,
   from zeroed launch counts, ``measure_vpu_peak`` (fma, fma_imm, mul_add)
   and ``measure_hbm_peak``, each rate held below the data sheet's peak;
4. check: K1's four kernels against their plain PyTorch versions at 256^2
   (dg1_rk_stage blended and with a = 0, on the CG1 velocity and in its qv
   form), then mevp_tiled and transport_tiled against theirs and against K1's
   schedule on the same inputs, at 1024^2 and at a ragged 1000 x 968, with
   100 subcycles and with a count that is not a multiple of the halo
   (transport_tiled also by 4-byte copies and in two blocks an SM, and on a
   1000 x 966 grid, whose rows take 4-byte copies); then
   mevp_single (tiles resident in shared memory, edges swapped with the
   neighbours only) against its plain version (256^2 spherical, N = 1, 13
   and 100; 256^2 uniform, 1024^2 and 1000 x 968 spherical, N = 100), K1's
   schedule (256^2 uniform, 1024^2 and 1000 x 968 spherical) and mevp_tiled
   (spherical consts, 1024^2 and 1000 x 968), and the metric
   transport_tiled and dg1_rk_stage against their plain versions and each
   other at 1024^2 spherical with the coastline; then ho_single against its
   plain version (256^2, N = 1, 13, 100), ho_tiled against it (1024^2,
   N = 1 and 13, and 1000 x 968), the two against each other (256^2 and
   512^2, ho_single by its neighbour waits and by grid.sync()), ho_tiled's shipped window (a cluster of one block) against
   clusters of 2 to 16 blocks that push their edges through distributed
   shared memory (1024^2, N = 13), and the qv form of transport_tiled
   against its plain version and the staged qv transport (1024^2); on config 5's 2048^2 rank blocks rdma_stage and rdma_band
   launch by launch against their plain versions, and the rdma round
   against the blocked round; dg1_sample_cfl (a streaming max on resident
   blocks) at every shape the paths launch it: 256^2, 1024^2 uniform and
   spherical, 4096^2 and a rank's 2048^2 block widened by H = 8, its speeds
   equal to the plain version's;
5. slice: for each path, one step on the kernels against the plain path on
   the card (the spherical one on "pallas" and on "auto", and one step of
   the uniform coastline variant ``coupled_1m_mask``; the HO paths, the two
   staged ones included), then
   20 steps from zeroed launch counters: every leaf finite, 0 <= cice <= 1,
   hice >= 0, hsnow >= 0, every kernel of the path launched, and with a
   coastline the land tracers unchanged and u = v = 0 on every node that
   touches land; then (phase ``check_degrees``) dg1_sample_cfl at dG0 and
   dG2 (speeds exactly, k equal) and dg1_rk_stage at dG0 and dG2 in every
   form (uniform or metric, CG1 or qv, blended or first stage) and its
   no-limit instance, launch by launch at 256^2; transport_tiled at dG2
   with rk3 and at dG0 at 1024^2, its dG2 qv form, and its spmd form on a
   2 x 2 rank grid, against the plain version, and the staged rk3 transport
   against it (expected 0); config 2 at dG1 and dG2: 400 steps against the
   plain path, one revolution (its L2 error against the projected start,
   dG2's below half of dG1's, and the mass drift) and element updates/s;
   the dG0 and dG2 headline and config 4 steps against the plain path and
   20 steps bounded, the HO 256^2 step at dG2, the 2 x 2 rank grid's step at
   dG2 against the single-device step (expected 0); then (phase
   ``check_momentum_forms``) mevp_stress and mevp_velocity at 256^2,
   mevp_tiled at 1024^2 and mevp_single at 1024^2 spherical with the
   coastline, each in the A-weighted, the adaptive and the combined form
   on seeded inputs with partial cover (nodes below a_dyn_min, alpha above
   its floor), launch by launch against the plain version (TOL_LAUNCH) and
   over 8 and 100 subcycles against it and against K1's schedule (and
   mevp_tiled; expected 0); the forms' paths one step against the plain
   path and 20 steps bounded (the rank grid's one step against the
   single-device step, expected 0); then (phase ``check_tvb_periodic``)
   each periodic and TVB form launch by launch against its plain version
   (TOL_LAUNCH) and the schedules against each other (expected 0), and the
   periodic and TVB paths one step against the plain path and 3 steps
   bounded, every kernel of the path launched (dg1_limit on the staged TVB
   ones); then (phase ``check_ho_forms``) ho_single at 256^2 and ho_tiled
   at 1024^2 in the A-weighted, periodic and combined forms on seeded
   inputs with partial cover and a wind that varies along the seams, one
   subcycle against the plain version (TOL_LAUNCH) and 100 against it
   (TOL_STEP_MEVP), ho_single against ho_tiled and ho_tiled's 2 x 2
   clusters against its shipped window (expected 0); dg1_rk_stage's
   periodic qv stage and its TVB stage with dg1_limit at 256^2;
   transport_tiled's periodic qv form and its TVB form at 1024^2 (k = 1
   and 4) against the plain version and the staged schedule (expected 0);
   and the forms' paths one step against the plain path and 20 steps
   bounded, every kernel of the path launched; then (phase
   ``check_ho_metric``) ho_single at 256^2 (the spherical window
   unweighted and A-weighted, the graded mesh, the ring) and ho_tiled at
   1024^2 (the window both ways, the ring) in their metric forms, one
   subcycle against the plain version (TOL_LAUNCH), 13 and 100 against it
   (TOL_STEP_MEVP), ho_single against ho_tiled and 2 x 2 clusters against
   the shipped window (expected 0); on the 1024^2 ring transport_tiled's
   periodic metric qv form (k = 1 and 4) against the plain version and the
   staged schedule (expected 0), dg1_rk_stage's periodic metric qv stage
   and its TVB stage with dg1_limit; and the metric paths one step against
   the plain path and 20 steps bounded, land untouched, every kernel of the
   path launched;
   then (phase ``check_grid_forms``) each new form of rdma_band (metric,
   ring, A-weighted, adaptive) and of the spmd transport_tiled (the TVB
   walls, the widened metric planes) launch by launch against its plain
   version (TOL_LAUNCH), the rdma rounds against the blocked round
   (expected 0), each grid path one decomposed step against the
   single-device step (expected 0) and 20 steps (4 but on the two cells
   and the 2 x 2 ring) bounded with land untouched, and 4 steps of
   ``spherical_16m_spmd``; then (phase ``check_grid_ho``) the battery's six
   HO ``*_spmd`` configs on 2 x 2 ranks at full size (the spherical
   coastline window and its ablations at 1024^2, ``ho_spherical_16m_spmd``
   at 4096^2): one decomposed step against the single-device HO step
   (expected 0; at h = 16, 32 and 64 on the two timed configs), rank 0's
   widened ho_tiled launch of each new shape and form against plain (one
   subcycle at TOL_LAUNCH, a round at TOL_STEP_MEVP), each spmd qv
   transport_tiled launch against plain at the 512^2 and 2048^2 blocks,
   then 20 steps (``ho_coupled_1m_spherical_spmd``) or 4 bounded with land
   untouched; then (phase ``check_grid_ho_rdma``) the HO solver on the
   rdma schedule (K7's 17-plane round): ``ho_coupled_1m_spherical_spmd``,
   ``ho_ablate_uniform_spmd`` and ``ho_spherical_16m_spmd`` on rdma, and
   a 256^2 A-weighted grid and the 256^2 ring on 1 x 2 ranks (the HO
   band's other forms), each one decomposed step against the single-device
   HO step and (the battery's three) the blocked decomposed step (expected
   0), one round on every rank with each rdma_stage launch and rank 0's HO
   rdma_band launches against plain (TOL_LAUNCH, per plane) and every
   round against the blocked round (expected 0), then 4 steps (at 16M the
   one) bounded with land untouched; then (phase ``check_grid_tvb``) TVB on
   the rank grid at full width: ``ho_coupled_1m`` with TVB (M = 0 on
   blocked, the middle M on rdma: the spmd transport_tiled's qv + walls
   instance), the HO 256^2 mesh periodic in both axes with the middle M,
   ``coupled_1m_spherical_spmd`` with TVB (M = 0 blocked, the middle M on
   rdma) and ``ho_coupled_1m_spherical_spmd`` with the middle M (the
   staged route: the halo forms of dg1_rk_stage and dg1_limit), the 1024^2
   ring with the coastline and M = 0 on 1 x 2 ranks, and config 4 with
   ``transport_backend="xla"`` (the positivity-limited halo stage): each
   4 steps against 4 single-device steps (expected 0), bounded with land
   untouched, every kernel of the path launched, the exchanges and
   launches of one step counted, the first path 20 steps bounded; every
   spmd qv + walls launch against plain on every rank, and rank 0's halo
   stage and limiter against plain (TOL_LAUNCH) and against the
   single-domain kernels on its block (expected 0); the mEVP's width-1
   ("xla") schedule on 2 x 2 ranks (phase ``check_grid_xla``, M10d):
   ``coupled_1m_spherical_spmd`` and ``ho_coupled_1m_spherical_spmd``,
   the uniform box (HO, A-weighted), the 1024^2 ring with the coastline
   (CG1, A-weighted and adaptive) for 4 steps and the two 16M cells
   (``spherical_16m_spmd``, ``ho_spherical_16m_spmd``) for 2 and 1, each
   against the single-device and the blocked step (expected 0), each
   halo half launched twice a subcycle and rank and no other mEVP kernel;
   every halo launch of one more step against its plain version
   (TOL_LAUNCH; on every rank of the spherical cell, else on rank 0, at
   16M the first 4 a kernel);
   for config 5 one decomposed step (blocked and rdma) against the
   single-device kernel step at 4096^2 (expected 0), the decomposed kernel
   step against the decomposed plain step at 512^2, and 4 steps of each
   form; then the engine (phase ``check_engine``): whether h5py and the
   system libnetcdf are installed; dev1 on the card against the JAX
   package's anchors (cice 0.36670813, hice 0.04668325, tice -1.4445018,
   rtol 1e-5), sst and sss unchanged, every field uniform; each 1024^2 run
   against the port's CPU runs of the same restart in float32 and float64,
   plane by plane (``TOL_ENGINE``: the columns beyond 1e-5 of the plane's
   max of the CPU float32 run counted and printed, those beyond 1e-3 as
   branch flips; the failure line is the card's distance from the float64
   run); its ms per step and column updates/s by CUDA events over 20
   back-to-back steps after a warm-up, beside the Timer's host time per step
   (issue time), the restart's move to and from the card and, with h5py,
   the restart file's write and read times (its profile runs after the
   other timings); then the coupled CLI (phase ``check_cli``, ROADMAP M8b
   part 1), ``runtime.coupled_main.run_coupled`` on the card in a temporary
   directory: run/box.cfg and run/arctic.cfg as they stand, run/arctic.cfg
   on 2 x 2 ranks cut to 12 steps, BASELINE config 5's size (4096^2 on
   2 x 2 ranks, a probe and a checkpoint every step, 2 steps) and health at
   256^2 with the step poisoned on its second call (abort: the post-mortem
   non-finite, the final checkpoint the step-1 state; retry-halved: two
   half steps, three finite rows); each run's final state, checkpoints
   and diagnostics rows against a direct loop of the same model on the
   same fields (``ShardedCoupledModel.__call__`` on the grid; expected 0,
   failing above TOL_SAME_SCHEDULE), the 2 x 2 arctic run against the
   single-device one, each run's launches (paths ``cli_*``), and the CLI's
   ms per step beside the bare step in turns, the probe, the checkpoint
   fetch, the gather and the forcing copy each alone; without h5py
   in-memory recorders stand in for the CLI's checkpoint and diagnostics
   writers (``CliFiles``), and nothing else is patched; then the file
   forcings (phase ``check_forcing_files``, ROADMAP M8b part 2): the
   forcing archive's ``ForcingProvider`` on the card at 256^2 and 1024^2
   (a record, between records, below and above the range, the periodic
   wrap, the last record) against the host's float64 blend rounded to
   float32 (expected 0); ``archive:`` runs of run/box.cfg and
   run/arctic.cfg as they stand, run/arctic.cfg on 2 x 2 ranks cut to 12
   steps and health at 256^2 poisoned on retry-halved (the archive read at
   the replay's half steps), on 6-hourly records of all twelve fields
   that vary in time and space; an ``era5:`` run of run/arctic.cfg on
   ERA5-style variables (packed t2m, u10, v10, unpacked ssrd and sf)
   regridded onto its centres; BASELINE config 5's size (4096^2 on 2 x 2
   ranks, 2 steps) on 3 records of six fields; each run against a direct
   loop fed the same provider (expected 0), the 2 x 2 run against the
   single-device one, each run's launches (paths ``files_*``), the CLI's
   ms per step beside the bare step, its forcing scope and the provider's
   refresh alone; and one traced step of the archive box run
   (``utils.profiling.device_trace``, in a process of its own:
   ``chip_smoke.py --trace-archive-box DIR``), whose trace must name
   ``mevp_tiled`` and the annotation. Without h5py in-memory stand-ins
   replace ``forcing_file.read_forcing_archive``,
   ``forcing_file.write_forcing_archive`` and ``era5.read_era5_variables``
   (``ForcingFiles``); and, after config 5's timings, the rank grid
   across processes (phase ``check_multiprocess``, ROADMAP M10b part 3):
   config 5 on 4 worker processes of one rank each on the one card
   (``parallel.multiprocess.launch``: gloo, strips staged through pinned
   host buffers), blocked ("auto", h = 16) and rdma, 2 steps: process 0's
   gathered and checkpointed state (an in-memory recorder where h5py is
   missing) against the thread grid's on the same inputs (expected 0),
   the health probe over the 4 processes (one NaN in the last must fail
   it on all), the workers' launches (paths ``multiprocess_16m*``), each
   process's ms a step (3 timed), the host-staged exchange's ms a round
   and process 0's idle share, beside the thread grid and the single
   device in turns before and after; then the JAX worker's paths
   (blocked, shardmap, blocked-ring) at 16^2 on 2 processes x 2 ranks
   against the single domain and the thread grid (expected 0);
6. time (CUDA events, each function warmed up once; a plain path, run by
   the checks before, timed once): ms per step and element updates/s of
   each path, of the config-4 step on K1's schedule, on the tiled one and on
   the plain path, of the physics alone, the spherical step on mevp_single,
   on mevp_tiled and on the plain path, the HO paths' step on their kernels
   and on the plain path, and each kernel per call against its plain
   version and its bound; config 5's single-device, 2 x 2 blocked and 2 x 2
   rdma steps, box_adaptive beside box and coupled_1m_aweighted beside
   coupled_1m in turns, the blocked round against the rdma round, the dynamics step
   at h = 8, 16, and profiles; each
   periodic and TVB form in turns with its closed (or untouched) instance,
   and the periodic, TVB and ring steps in turns with their closed ones;
   each HO form in turns with its closed instance, and
   ``ho_coupled_1m_periodic`` and the A-weighted HO step beside
   ``ho_coupled_1m``, the periodic HO 256^2 staged step beside the closed
   one, with a profile of ``ho_coupled_1m_periodic``; each metric form in
   turns with its closed instance, and the HO spherical coastline step and
   the HO ring beside ``ho_coupled_1m``, with a profile of each;
   ``coupled_1m_spherical_spmd`` in chunks of 4 steps at h = 16 beside
   the single-device spherical step, with a profile of the grid step; each
   new form of rdma_band and the spmd
   transport_tiled in turns with the closed uniform instance on the same
   launch; the two timed HO grid configs in chunks of 2 steps at h = 16
   beside the single-device HO step, with a profile of each; the spmd qv
   form of transport_tiled in turns with its CG1 form; the 1M HO grid
   config on rdma at h = 16 in turns with blocked at h = 16, with a
   profile of its rdma step (its HO
   rdma_band's ms a launch), rdma_stage's 17-plane x launch in turns with
   one torch.stack of its strips, and each HO rdma_band form in turns
   with the closed uniform HO instance on the same band; the TVB grid's
   run a in chunks of 2 steps in turns with the single-device step, with
   a profile, and the new forms in turns with their
   closed instances (the qv TVB transport_tiled without the walls, the
   single-domain stage and limiter on the unwidened block); the four
   halo kernels at config 5's 2048^2 blocks with their bounds and plain
   versions, in turns with the copy that a block widened by one ring
   would take in place of the strips; the fused_dynamics threshold sweep
   and headline profile (phase check_fused), each other form in turns
   with the headline's instance and its threshold sweeps (phase
   check_fused_forms); last, in one profiler
   session, the profiler's device duration of K1's four kernels at 256^2 (and
   dg1_rk_stage's first-stage and qv forms there, its metric form at 1024^2),
   transport_tiled at 1024^2, ho_single and ho_tiled at their paths'
   shapes, rdma_stage and rdma_band on the x and y bands, beside their
   back-to-back times (every row of the summary
   carries the back-to-back time per call) and the CUDA events' time of
   the whole call, which stands alone where a profiler session records
   nothing (CUPTI on some H100 machines now and then stops recording for the
   rest of the process). One card shows what
   the exchange costs, not how the step scales over cards.
   The "auto" threshold sweeps and the tile sweeps are
   ``python -m nextsimdg_tpu_torch.benchmarks.mevp_large``'s.

Any failure raises (non-zero exit); there is no CPU path. The script's wall
time, the card's ``nvidia-smi`` name and power limit and the kernels' JSON
summary come last but one; each kernel's row carries ``bound_ms`` on the
data sheet's peaks and ``measured_bound_ms`` on the measured HBM and
mul_add rates, and each new periodic or TVB form of an earlier kernel has a
row of its own ("mevp_stress (periodic form)", ..., "ho_tiled (A-weighted form)",
"transport_tiled (periodic qv form)", "fused_dynamics (dG2 form)", ...); each launch counts on one row
(a path's launches of a kernel on the last form row that names the path).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from nextsimdg_tpu_torch import coupled, modules
from nextsimdg_tpu_torch.benchmarks import mevp_large, roofline, run_benchmarks
from nextsimdg_tpu_torch.benchmarks.common import best_ms, profiled_ms_many
from nextsimdg_tpu_torch.config import Configurator, ConfiguredModule
from nextsimdg_tpu_torch.coupled import CoupledModel
from nextsimdg_tpu_torch.dynamics import MEVPParams, RectMesh, SphericalMesh, synthetic_coastline
from nextsimdg_tpu_torch.dynamics import mevp_ho
from nextsimdg_tpu_torch.dynamics.dgbasis import dg_basis
from nextsimdg_tpu_torch.dynamics.kernels import coupled_cuda as cc
from nextsimdg_tpu_torch.dynamics.kernels import fused_dynamics_cuda as fd
from nextsimdg_tpu_torch.dynamics.kernels import ho_single_cuda as hsc
from nextsimdg_tpu_torch.dynamics.kernels import ho_tiled_cuda as htc
from nextsimdg_tpu_torch.dynamics.kernels import mevp_rdma_cuda as rdma
from nextsimdg_tpu_torch.dynamics.kernels import mevp_single_cuda as single
from nextsimdg_tpu_torch.dynamics.kernels import mevp_tiled_cuda as mt
from nextsimdg_tpu_torch.dynamics.kernels import transport_tiled_cuda as tt
from nextsimdg_tpu_torch.dynamics.mevp import DynamicsForcing, MEVPSolver, VelocityState
from nextsimdg_tpu_torch.grid import StructureFactory
from nextsimdg_tpu_torch.interop import coupled_state_to_numpy
from nextsimdg_tpu_torch.io import (
    coupled_restart, diagnostics, era5, forcing_file, netcdf_c, read_restart, write_restart_fields,
)
from nextsimdg_tpu_torch.parallel import RankGrid, build_sharded_coupled_model, multiprocess, run_ranks
from nextsimdg_tpu_torch.runtime import Model, coupled_main
from nextsimdg_tpu_torch.runtime.coupled_main import run_coupled
from nextsimdg_tpu_torch.runtime.main import main as engine_main
from nextsimdg_tpu_torch.state import Forcing
from nextsimdg_tpu_torch.tools.make_dev_restart import (
    dev_restart_fields, make_dev_restart, seeded_rect_fields,
)
from nextsimdg_tpu_torch.utils import main_timer, profiling

N = 256
N4 = 1024  # BASELINE config 4
N16 = 4096  # BASELINE config 5: 16.8M elements
RANKS = (2, 2)  # config 5's rank grid, all ranks on the one card
N_PLAIN_GRID = 512  # the decomposed plain step's size
RAGGED = (1000, 968)  # a multiple of no tile
N_SUBCYCLES = 100
DT = 600.0
SEED = 0
#: Subcycles of a timed mevp_tiled call.
TILED_SUBCYCLES = 8
#: Steps of each config-5 form from zeroed launch counts (20 on the other
#: paths): every kernel of the form launches in each step, and a 2 x 2 step
#: takes 0.2-0.4 s of host issue.
N5_STEPS = 4
K1 = "nextsimdg_tpu/dynamics/kernels/coupled_pallas.py:62"
REPLACES = {
    "mevp_stress": K1, "mevp_velocity": K1, "dg1_sample_cfl": K1, "dg1_rk_stage": K1,
    "dg1_limit": K1,
    "mevp_tiled": "nextsimdg_tpu/dynamics/kernels/mevp_tiled.py:173",
    "transport_tiled": "nextsimdg_tpu/dynamics/kernels/transport_tiled.py:105",
    "mevp_single": "nextsimdg_tpu/dynamics/kernels/mevp_pallas.py:49",
    "ho_single": "nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py:45",
    "ho_tiled": "nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py:118",
    "rdma_stage": "nextsimdg_tpu/dynamics/kernels/mevp_rdma.py:61",
    "rdma_band": "nextsimdg_tpu/dynamics/kernels/mevp_rdma.py:61",
    "chain": "benchmarks/roofline.py:154",
    "fused_dynamics": K1,
}
SOURCES = {
    "mevp_stress": "nextsimdg_tpu_torch/csrc/mevp.cu",
    "mevp_velocity": "nextsimdg_tpu_torch/csrc/mevp.cu",
    "dg1_sample_cfl": "nextsimdg_tpu_torch/csrc/transport.cu",
    "dg1_rk_stage": "nextsimdg_tpu_torch/csrc/transport.cu",
    "dg1_limit": "nextsimdg_tpu_torch/csrc/transport_tvb.cu",
    "mevp_tiled": "nextsimdg_tpu_torch/csrc/mevp_tiled.cu",
    "transport_tiled": "nextsimdg_tpu_torch/csrc/transport_tiled.cu",
    "mevp_single": "nextsimdg_tpu_torch/csrc/mevp_single.cu",
    "ho_single": "nextsimdg_tpu_torch/csrc/ho_single.cu",
    "ho_tiled": "nextsimdg_tpu_torch/csrc/ho_tiled.cu",
    "rdma_stage": "nextsimdg_tpu_torch/csrc/mevp_rdma.cu",
    "rdma_band": "nextsimdg_tpu_torch/csrc/mevp_rdma.cu",
    "chain": "nextsimdg_tpu_torch/csrc/roofline.cu",
    "fused_dynamics": "nextsimdg_tpu_torch/csrc/fused_dynamics.cu",
}
PATH_KERNELS = {
    "headline": ("fused_dynamics",),
    "config4": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "spherical": ("mevp_single", "dg1_sample_cfl", "transport_tiled"),
    "ho_coupled_1m": ("ho_tiled", "transport_tiled"),
    "ho_coupled_256": ("ho_single", "transport_tiled"),
    "ho_coupled_256_staged": ("ho_single", "dg1_rk_stage"),
    "ho_coupled_256_rk3": ("ho_single", "dg1_rk_stage"),
    "multihost_16m": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled", "rdma_stage", "rdma_band"),
    "multihost_16m_blocked": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "roofline": ("chain",),
    # dG0 and dG2 (check_degrees): config 2 on dg1_rk_stage's no-limit
    # instance, the headline and config 4 at dG0 and dG2, HO and the rank
    # grid at dG2 (rk3 on the spmd transport_tiled).
    "advection_dg1": ("dg1_rk_stage",),
    "advection_dg2": ("dg1_rk_stage",),
    # Since the forms of fused_dynamics: the headline at dG0 and dG2 on
    # "pallas" runs it; K1's split schedule is pinned (K1_SPLIT) on the _k1
    # paths, so that K1's kernels keep their checks in these forms.
    "headline_dg0": ("fused_dynamics",),
    "headline_dg2": ("fused_dynamics",),
    "headline_dg0_k1": ("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage"),
    "headline_dg2_k1": ("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage"),
    "config4_dg0": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "config4_dg2": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "ho_coupled_256_dg2": ("ho_single", "transport_tiled"),
    "multihost_dg2": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    # The momentum forms (check_momentum_forms): the battery's box_adaptive
    # on "auto" and on K1's schedule, coupled_1m_aweighted, the spherical
    # coastline step A-weighted on mevp_single, free drift at 256^2 (its
    # momentum step is plain PyTorch: no TPU kernel exists for it), and the
    # A-weighted 2 x 2 rank grid. box_adaptive on "auto" runs fused_dynamics
    # since its forms; box_adaptive_k1 pins K1's split schedule.
    "box_adaptive": ("fused_dynamics",),
    "box_adaptive_k1": ("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage"),
    "coupled_1m_aweighted": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "spherical_aweighted": ("mevp_single", "dg1_sample_cfl", "transport_tiled"),
    "free_drift": ("dg1_sample_cfl", "transport_tiled"),
    "multihost_aweighted": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
}
VELOCITY = ("u", "v", "s11", "s22", "s12")
#: K1's split schedule as a step's phase (on a uniform mesh "pallas" takes
#: fused_dynamics where it holds), and the paths that pin it: their models
#: run fused_dynamics on their own schedule.
K1_SPLIT = functools.partial(cc.dynamics_phase, mevp="pallas", transport="xla")
K1_PINNED = {"headline_dg0_k1", "headline_dg2_k1", "box_adaptive_k1"}
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# float32 operations per element of each body, counted from
# csrc/mevp_body.cuh and csrc/dg1_body.cuh (a sqrt or a divide counts as
# one): the stress half, the velocity half (uniform consts), the CFL
# sampling, and one RK stage as dg1_rk_stage does it: each face's flux
# once, so an element and tracer takes 4 of the 8 face points (7
# operations each) of the 243 operations of dg1_stage_cell; the CG1 form
# samples the 8 volume velocities once an element (56) and the normal
# velocity at its 4 face points once a tracer (3 each), the qv form reads
# the samples, so it does the tracers' part only; transport_tiled's stage
# (dg1_stage_cell an element: the velocity sampled in full, every face point
# of each tracer); the velocity
# half with the metric consts (16 multiplies of the weighted stresses, 14
# adds, for the uniform forces' 18 operations); and, counted
# from csrc/ho_body.cuh as the kernels run them (dense tables), the HO
# stress half per element and velocity half per node index.
#: The momentum forms (csrc/mevp_body.cuh) add to the stress half: the
#: weighted form one multiply (c_w a_node); the adaptive form gives up the
#: shared divide's 9 operations (one divide) for 13 (three divides, a
#: square root and a select): 4 more, of which 2 divides and the square root.
OPS = {
    "stress": 80, "stress_weighted": 81, "stress_adaptive": 84, "stress_both": 85,
    "velocity": 42, "velocity_metric": 54, "cfl": 92, "stage": 56 + 3 * (4 * 3 + 243 - 4 * 7),
    "stage_qv": 3 * (243 - 4 * 7), "stage_cell": 80 + 3 * 243,
    "ho_stress": 516, "ho_velocity": 398,
}
#: Planes one HO call moves: 17 state planes in, 29 consts in, 17 out.
HO_PLANES_MOVED = 17 + 29 + 17
#: The 17 HO state planes in the kernels' order (coupled_cuda.ho_flatten).
HO_PLANE_NAMES = tuple(f"{q}.{k}" for q in "uv" for k in "vblc") + tuple(
    f"{s}[{c}]" for s in ("s11", "s22", "s12") for c in range(3))
HO = "Nextsim::MEVPHighOrder"
# Single launches: the kernel and the plain version run the same float32
# operations in the same order (a width divides through its float32
# reciprocal on both sides); 1e-5 of the plane's max covers an ulp where
# PyTorch's own kernels round differently.
TOL_LAUNCH = 1e-5
# One full step: 100 subcycles amplify single-ulp differences through the
# shared divide, hence 1e-3 for the mEVP planes; the tracers move by
# dt * velocity, 1e-5 of their max.
TOL_STEP_MEVP = 1e-3
TOL_STEP_TRACER = 1e-5
# The tiled kernels run the same element bodies as K1's kernels in the same
# order (--fmad=false), so they should equal K1's schedule exactly; 1e-6 of
# the plane's max is the failure line.
TOL_SAME_SCHEDULE = 1e-6
# The chain kernel's mul_add, div, sqrt and shift links round each operation
# as PyTorch's CUDA kernels do (IEEE divide and square root): expected 0,
# failure above 1e-6 of the plane's max. Its fma form rounds once per link
# where a * x + b rounds twice; the float64 chain's contraction (|a| < 1)
# keeps the error of L links below L x 2^-24 of the plane's max, held at 2 L x
# 2^-24 against the float64 chain.
TOL_CHAIN = 1e-6
#: The checks' chains: iterations per unroll, 160 and 128 links.
CHAIN_CHECK_ITERS = {16: 10, 64: 2}


@dataclass
class Row:
    """One kernel's line of the summary: its largest check error, ms per
    call of the kernel and of its plain version, the bytes (each input read
    once, each output written once) and float32 operations of that call,
    the ms of one PyTorch call of the same function, where there is one,
    and whether its operations issue as fused multiply-adds (the chain's
    fma form; the port's kernels issue each operation on its own)."""

    err: float
    ms: float
    plain_ms: float
    n_bytes: float
    n_ops: float
    library_ms: float = None
    fused: bool = False


#: Launches whose device duration (torch.profiler) the run logs last, by
#: "kernel shape": the phases add them.
DEVICE_PROBES = {}
#: dg1_rk_stage at the other shapes and forms the paths run it, by label:
#: Rows whose bounds the run logs once the ceilings are measured.
STAGE_FORMS = {}
#: The CG1 mEVP kernels in the momentum forms, by label: Rows whose bounds
#: the run logs once the ceilings are measured.
MOMENTUM_FORMS = {}


def log(phase: str, message: str) -> None:
    print(f"[{phase}] {message}", flush=True)


def compare(name: str, got, ref, tol: float) -> float:
    """Max abs error; fails unless it is within tol x the plane's max |ref|."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / scale if scale > 0 else err
    ok = err <= tol * scale if scale > 0 else err == 0.0
    log("check", (
        f"{name}: max_abs_err={err:.3e} (tol {tol * scale:.3e}), max_rel_err={rel:.3e} "
        f"relative to max|ref|={scale:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}"
    ))
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {tol:g} x {scale:.3e}")
    return err


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for a call
    that moves n_bytes (each input read once, each output written once)
    and does n_ops float32 operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call, back to back, on the device timeline (CUDA events)
    after a warm-up call (none with ``warm=False``: fn ran before): where
    the host issues slower than the device runs, this is the issue rate."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_model(device, n: int = N, degree: int = 1, periodic=(False, False), ocean=None, **form):
    """The headline configuration (on a 512 km square; n elements a side);
    ``periodic``: the (x, y) axes, ``ocean``: a coastline, ``form``: more
    of the model's keywords (tvb_m, mevp_params)."""
    mesh = RectMesh(n, n, dx=512e3 / n, dy=512e3 / n, periodic_x=periodic[0], periodic_y=periodic[1])
    form = {"mevp_params": MEVPParams(), **form}
    model = CoupledModel(
        mesh, degree=degree, n_subcycles=N_SUBCYCLES, mevp_backend="pallas", ocean_mask=ocean, **form,
    )
    state = model.initial_state(
        hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0,
        device=device, dtype=torch.float32,
    )
    full = lambda value: torch.full((n, n), value, device=device, dtype=torch.float32)
    forcing = DynamicsForcing(
        u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return model, state, forcing


def check_kernels(model, device) -> dict:
    """Phase 3: each kernel against its plain version on seeded inputs."""
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    solver, transport = model.mevp, model.transport
    u, v = t(rng.normal(0.0, 0.2, (N, N))), t(rng.normal(0.0, 0.2, (N, N)))
    s11, s22, s12 = (t(rng.normal(0.0, 1e3, (N, N))) for _ in range(3))
    h, a = t(rng.uniform(0.2, 2.0, (N, N))), t(rng.uniform(0.3, 1.0, (N, N)))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(8.0, 2.0, (N, N))), v_atm=t(rng.normal(2.0, 2.0, (N, N))),
        u_ocean=t(rng.normal(0.0, 0.05, (N, N))), v_ocean=t(rng.normal(0.0, 0.05, (N, N))),
    )
    mask = model.node_mask(device=device, dtype=torch.float32)
    state = VelocityState(u=u, v=v, s11=s11, s22=s22, s12=s12)
    consts = solver.step_consts(state, h, a, forcing, mask, DT)
    carry = (u, v, s11, s22, s12)
    results = {}

    ref = solver.stress_update(carry, consts)
    got = cc.mevp_stress(solver, carry, consts)
    names = ("s11", "s22", "s12", "c_w", "inv_drag")
    results["mevp_stress"] = max(
        compare(f"mevp_stress.{n}", g, r, TOL_LAUNCH) for n, g, r in zip(names, got, ref)
    )

    carry_v = (u, v, *ref[:3])
    ref_uv = solver.velocity_update(carry_v, consts, ref[3], ref[4], DT)
    got_uv = cc.mevp_velocity(solver, carry_v, consts, ref[3], ref[4], DT)
    results["mevp_velocity"] = max(
        compare(f"mevp_velocity.{n}", g, r, TOL_LAUNCH) for n, g, r in zip("uv", got_uv, ref_uv)
    )

    # The CFL speeds must be equal, so that k is equal.
    speeds = cc.dg1_sample_cfl(transport, u, v)
    speeds_ref = cc.dg1_sample_cfl_reference(transport, u, v)
    results["dg1_sample_cfl"] = compare("dg1_sample_cfl.speeds", speeds, speeds_ref, 0.0)
    k_of = lambda sp: int(cc.substeps_from_speeds(sp[0], sp[1], DT, model.mesh, 1))
    if k_of(speeds) != k_of(speeds_ref):
        raise AssertionError(f"k differs: {k_of(speeds)} != {k_of(speeds_ref)}")
    log("check", f"dg1_sample_cfl: k = {k_of(speeds)} on both paths")

    coeffs = lambda: t(np.concatenate([
        rng.uniform(0.1, 1.0, (1, 3, N, N)), rng.normal(0.0, 0.3, (2, 3, N, N))
    ]))
    psi, base = coeffs(), coeffs()
    face_x = t((rng.uniform(size=(N, N)) > 0.1).astype(np.float32))
    face_y = t((rng.uniform(size=(N, N)) > 0.1).astype(np.float32))
    errs = []
    for a_, b_ in ((0.0, 1.0), (0.5, 0.5)):
        args = (transport, psi, base, u, v, face_x, face_y, a_, b_, 300.0)
        errs.append(compare(
            f"dg1_rk_stage(a={a_}, b={b_})", cc.dg1_rk_stage(*args),
            cc.dg1_rk_stage_reference(*args), TOL_LAUNCH,
        ))
    # The qv form (the HO path's staged transport): the quadrature samples
    # of a seeded CG2 velocity in place of (u, v).
    cg2 = lambda: mevp_ho.HOField(*(t(rng.normal(0.0, 0.2, (N, N))) for _ in range(4)))
    qv = mevp_ho.ho_velocity_to_quad(model.mesh, transport.basis, cg2(), cg2())
    for a_, b_ in ((0.0, 1.0), (0.5, 0.5)):
        args = (transport, psi, base, None, None, face_x, face_y, a_, b_, 300.0)
        errs.append(compare(
            f"dg1_rk_stage qv form (a={a_}, b={b_})", cc.dg1_rk_stage(*args, qv=qv),
            cc.dg1_rk_stage_reference(*args, qv=qv), TOL_LAUNCH,
        ))
    results["dg1_rk_stage"] = max(errs)
    torch.cuda.synchronize()

    # Times: the in-place launches of the main path against the plain version.
    scalars, tables = cc._mevp_scalars(solver, DT), cc._dg1_tables(transport)
    stream = cc._stream(device)
    planes = tuple(p.clone() for p in carry)
    c_w, inv_drag = torch.empty_like(u), torch.empty_like(u)
    zeros2 = torch.zeros(2, device=device)
    out = torch.empty_like(psi)
    ptrs = cc._mevp_consts(consts)
    # keep=: the planes behind a pointer array live as long as the launch
    # that reads them (the device probes run it last).
    timed = {
        "mevp_stress": (
            lambda keep=consts: cc._mevp_half_("mevp_stress", planes, ptrs, c_w, inv_drag, scalars, stream),
            lambda: solver.stress_update(carry, consts),
        ),
        "mevp_velocity": (
            lambda keep=consts: cc._mevp_half_("mevp_velocity", planes, ptrs, c_w, inv_drag, scalars, stream),
            lambda: solver.velocity_update(carry_v, consts, ref[3], ref[4], DT),
        ),
        "dg1_sample_cfl": (
            lambda: cc._dg1_sample_cfl_(u, v, zeros2, tables, stream),
            lambda: cc.dg1_sample_cfl_reference(transport, u, v),
        ),
        "dg1_rk_stage": (
            lambda: cc._dg1_rk_stage_(
                psi, base, u, v, face_x, face_y, None, out, 0.5, 0.5, 300.0, tables, stream
            ),
            lambda: cc.dg1_rk_stage_reference(
                transport, psi, base, u, v, face_x, face_y, 0.5, 0.5, 300.0
            ),
        ),
    }
    n = N * N
    work = {  # (bytes, operations) of one call at N^2
        "mevp_stress": (15 * 4 * n, OPS["stress"] * n),
        "mevp_velocity": (14 * 4 * n, OPS["velocity"] * n),
        "dg1_sample_cfl": (2 * 4 * n + 8, OPS["cfl"] * n),
        "dg1_rk_stage": ((9 + 9 + 4 + 9) * 4 * n, OPS["stage"] * n),
    }
    rows = {}
    for name, (kernel, plain) in timed.items():
        DEVICE_PROBES[f"{name} {N}^2"] = kernel
        rows[name] = Row(results[name], time_ms(kernel, 200), time_ms(plain, 20), *work[name])
        log("time", (
            f"{name}: kernel {rows[name].ms:.4f} ms, plain {rows[name].plain_ms:.4f} ms, "
            f"bound {bound(*work[name])[0]:.4f} ms ({bound(*work[name])[1]}) per call at {N}x{N}"
        ))
    # dg1_rk_stage's other forms at 256^2: the first stage (a = 0: no base)
    # and the blended qv form (12 sample planes in place of u and v).
    qv_ptrs = cc._dg1_qv(qv, (N, N), device, transport.basis.degree)
    forms = {
        "first stage": (
            lambda: cc._dg1_rk_stage_(psi, base, u, v, face_x, face_y, None, out, 0.0, 1.0, 300.0, tables, stream),
            lambda: cc.dg1_rk_stage_reference(transport, psi, base, u, v, face_x, face_y, 0.0, 1.0, 300.0),
            (9 + 4 + 9) * 4 * n, OPS["stage"] * n,
        ),
        "qv form": (
            lambda keep=qv: cc._dg1_rk_stage_(
                psi, base, None, None, face_x, face_y, None, out, 0.5, 0.5, 300.0, tables, stream, qv=qv_ptrs),
            lambda: cc.dg1_rk_stage_reference(
                transport, psi, base, None, None, face_x, face_y, 0.5, 0.5, 300.0, qv=qv),
            (9 + 9 + 12 + 2 + 9) * 4 * n, OPS["stage_qv"] * n,
        ),
    }
    for form, (kernel, plain, n_bytes, n_ops) in forms.items():
        DEVICE_PROBES[f"dg1_rk_stage {N}^2 {form}"] = kernel
        STAGE_FORMS[f"{form} at {N}x{N}"] = Row(0.0, time_ms(kernel, 200), time_ms(plain, 20), n_bytes, n_ops)
    return rows


def velocity_leaves(velocity):
    """(name, tensor) of a VelocityState, or of an HOVelocityState (its CG2
    fields plane by plane)."""
    for name in VELOCITY:
        leaf = getattr(velocity, name)
        if isinstance(leaf, mevp_ho.HOField):
            for k, plane in zip("vblc", leaf.planes()):
                yield f"{name}.{k}", plane
        else:
            yield name, leaf


def leaves(state, like):
    """(name, leaf, leaf of ``like``) for every tensor of a CoupledState."""
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        yield name, getattr(state, name), getattr(like, name)
    pairs = zip(velocity_leaves(state.velocity), velocity_leaves(like.velocity))
    for (name, leaf), (_, other) in pairs:
        yield f"velocity.{name}", leaf, other


def ptxas_report(text: str):
    """'kernel: registers, shared memory; spills' lines from the compilers'
    -v report."""
    kernel, spills = "?", ""
    for line in text.splitlines():
        found = re.search(r"entry function '_ZN3nst(\d+)(\w+)'", line)
        if found:
            kernel = found.group(2)[: int(found.group(1))]
            rest = found.group(2)[int(found.group(1)):]
            args = re.findall(r"L([bi])(\d+)E", rest.split("EE")[0] + "E") if rest.startswith("I") else []
            if kernel == "rdma_stage_kernel":  # the state's planes, 16-byte vectors
                kernel += f"<{args[0][1]} planes, {'float4' if args[1][1] == '1' else 'scalar'}>"
            elif kernel == "rdma_band_ho_kernel":  # the band's long axis, the HO form, the ring, staged consts
                forms = [name for bit, name in ((2, "metric"), (1, "A-weighted")) if int(args[1][1]) & bit]
                kernel += "<" + ", ".join(
                    ["along columns, x bands" if args[0][1] == "1" else "along rows, y bands"] + forms
                    + (["ring"] if args[2][1] == "1" else []) + (["L2 consts"] if args[3][1] == "0" else [])) + ">"
            elif kernel == "rdma_band_kernel":  # the band's long axis, the launch bound, the forms
                axis = "along columns, x bands" if args[0][1] == "1" else "along rows, y bands"
                forms = []
                if args[2:] and args[2][1] == "1":
                    forms.append("metric")
                if args[3:] and args[3][1] != "0":
                    forms.append(MOMENTUM_FORM_NAMES[int(args[3][1])])
                if args[4:] and args[4][1] == "1":
                    forms.append("ring")
                kernel += f"<{axis}, {args[1][1]} threads{''.join(', ' + f for f in forms)}>"
            elif kernel == "transport_tiled_kernel":  # degree, metric, qv, copy form, TVB, periodic, walls
                kernel += "<" + ", ".join((
                    f"dG{args[0][1]}", "metric" if args[1][1] == "1" else "uniform",
                    "qv" if args[2][1] == "1" else "cg1",
                    "16-byte copies" if args[3][1] == "4" else "4-byte copies",
                ) + tuple(name for name, arg in zip(("TVB", "periodic", "rank grid walls"), args[4:])
                          if arg[1] == "1")) + ">"
            elif kernel in ("ho_stress_halo_kernel", "ho_velocity_halo_kernel"):  # the HO form's bits
                form = int(args[0][1])
                kernel += f"<{'metric' if form & 2 else 'uniform'}{', A-weighted' if form & 1 else ''}>"
            elif kernel == "ho_single_kernel":  # consts in shared memory
                kernel += "<consts shared>" if args[0][1] == "1" else "<consts global>"
            elif kernel == "ho_single_sync_kernel":
                kernel += "<grid sync>" if args[0][1] == "1" else "<neighbours>"
            elif kernel == "ho_tiled_kernel" and args:  # the sub-window width, 0: any
                kernel += f"<width {args[0][1]}>" if args[0][1] != "0" else "<any width>"
            elif kernel == "dg1_rk_stage_kernel":  # degree, tracers, metric, qv, blend, limit, periodic
                kernel += "<" + ", ".join((
                    f"dG{args[0][1]}", f"{args[1][1]} tracers", "metric" if args[2][1] == "1" else "uniform",
                    "qv" if args[3][1] == "1" else "cg1", "blended" if args[4][1] == "1" else "a = 0",
                    "limited" if args[5][1] == "1" else "no limit",
                ) + tuple("periodic" for arg in args[6:] if arg[1] == "1")) + ">"
            elif kernel == "dg1_sample_cfl_kernel":  # elements a lane, volume points, periodic
                kernel += "<" + ("16-byte loads" if args[0][1] == "4" else "4-byte loads") + (
                    ", 3x3 points (dG2)" if args[1][1] == "9" else ", 2x2 points (dG0, dG1)") + (
                    ", periodic" if args[3:] and args[3][1] == "1" else "") + ">"
            elif kernel == "fused_dynamics_kernel":  # resident consts, the coastline form
                kernel += f"<{args[0][1]} const planes in shared memory{', face masks' if args[1][1] == '1' else ''}>"
            elif kernel == "fused_dynamics_forms_kernel":  # degree, TVB, momentum form, resident consts
                kernel += (f"<dG{args[0][1]}{', TVB' if args[1][1] == '1' else ''}, "
                           f"{'adaptive' if int(args[2][1]) & 2 else 'fixed'} alpha, "
                           f"{args[3][1]} const planes in shared memory>")
            elif kernel == "dg1_limit_kernel":  # degree, metric tolerance planes
                kernel += f"<dG{args[0][1]}, {'metric' if args[1][1] == '1' else 'uniform'}>"
            elif args and args[0][0] == "b":  # the metric template first: ILb1E = <true>
                names = ["metric" if args[0][1] == "1" else "uniform"]
                if kernel == "mevp_tiled_kernel":  # then the window width
                    names.append(f"width {args[1][1]}" if args[1][1] != "0" else "any width")
                if kernel == "mevp_single_kernel":  # then the const planes in shared memory
                    names.append(f"{args[1][1]} const planes in shared memory")
                ints = [value for kind, value in args[1:] if kind == "i"]
                if ints and kernel.startswith("mevp_"):  # the momentum form, then the periodic form
                    names.append(MOMENTUM_FORM_NAMES[int(ints[-1])])
                    if args[-1] == ("b", "1"):
                        names.append("periodic")
                kernel += "<" + ", ".join(names) + ">"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}"


#: The momentum forms' template bits (csrc/mevp_body.cuh kForm), by name.
MOMENTUM_FORM_NAMES = {0: "fixed alpha", 1: "A-weighted", 2: "adaptive alpha", 3: "A-weighted, adaptive alpha"}


def spherical_mesh(nx: int, ny: int = None):
    """The pan-Arctic lon-lat window of ``coupled_1m_spherical``."""
    return SphericalMesh(nx, nx if ny is None else ny, lon0=-40.0, lon1=40.0, lat0=55.0, lat1=85.0)


def config4_model(device, degree: int = 1, **backends):
    """BASELINE config 4 as ``bench_coupled_1m`` builds it (no land mask):
    (model, initial state, physics forcing, dynamics forcing)."""
    return coupled_model(device, RectMesh(N4, N4, dx=4e3, dy=4e3), None, degree, **backends)


def spherical_model(device, n: int = N4, **backends):
    """``bench_coupled_1m(land_mask=True, spherical=True)`` at n^2."""
    return coupled_model(device, spherical_mesh(n), synthetic_coastline(n), **backends)


def coupled_model(device, mesh, ocean, degree: int = 1, mevp_params=MEVPParams(), **backends):
    """Config 4's model, state and forcing on ``mesh`` with the coastline
    ``ocean`` (or none), at DG ``degree``, in the momentum form of
    ``mevp_params``."""
    model = CoupledModel(
        mesh, degree=degree, mevp_params=mevp_params, n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
        **backends,
    )
    state = model.initial_state(
        hice0=1.2, cice0=0.95, hsnow0=0.1, device=device, dtype=torch.float32
    )
    shape = (mesh.nx, mesh.ny)
    full = lambda value: torch.full(shape, value, device=device, dtype=torch.float32)
    phys = Forcing(
        tair=full(-15.0), dew2m=full(-17.0), pair=full(1e5), sw_in=full(5.0),
        lw_in=full(240.0), mld=full(10.0), snowfall=full(1e-4), wind=full(6.0),
    )
    dyn = DynamicsForcing(
        u_atm=full(6.0), v_atm=full(3.0), u_ocean=full(0.02), v_ocean=full(0.0)
    )
    return model, state, phys, dyn


def plain_step(model, state, phys, dyn):
    """The coupled step on the plain PyTorch path (same device)."""
    state = model.step_dynamics(state, dyn, DT, phase=cc.fused_dynamics_reference)
    return model.step_thermo(state, phys, DT)


def tiled_inputs(nx, ny, device, seed, spherical=False):
    """Seeded mEVP planes and consts, dG1 tracers and face masks on a closed
    (nx, ny) mesh of 4 km elements (random face masks), or with
    ``spherical`` on the lon-lat window with the synthetic coastline (its
    metric consts and face masks)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (nx, ny)
    if spherical:
        model = CoupledModel(
            spherical_mesh(nx, ny), n_subcycles=N_SUBCYCLES,
            ocean_mask=synthetic_coastline(nx, ny),
        )
    else:
        model = CoupledModel(RectMesh(nx, ny, 4e3, 4e3), n_subcycles=N_SUBCYCLES)
    carry = tuple(t(rng.normal(0.0, s, shape)) for s in (0.2, 0.2, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(6.0, 2.0, shape)), v_atm=t(rng.normal(3.0, 2.0, shape)),
        u_ocean=t(rng.normal(0.0, 0.05, shape)), v_ocean=t(rng.normal(0.0, 0.05, shape)),
    )
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, DT)
    psi = t(np.concatenate([
        rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (2, 3, *shape))
    ]))
    if spherical:
        faces = model.face_masks(device=device, dtype=torch.float32)
    else:
        faces = tuple(t((rng.uniform(size=shape) > 0.1).astype(np.float32)) for _ in range(2))
    return model, carry, consts, psi, faces


def same_schedule(name: str, got, ref, other: str = "K1's schedule") -> float:
    """Max abs difference from another schedule on the same inputs; fails
    above TOL_SAME_SCHEDULE x the plane's max |value|."""
    err = float((got.double() - ref.double()).abs().max())
    limit = TOL_SAME_SCHEDULE * float(ref.abs().max())
    ok = err <= limit
    log("check", (
        f"{name} vs {other}: max_abs_diff={err:.3e} (expected 0, fail above "
        f"{limit:.3e}) {'ok' if ok else 'FAIL'}"
    ))
    if not ok:
        raise AssertionError(f"{name}: differs from {other} by {err:.3e}")
    return err


def check_tiled(device) -> dict:
    """Phase 3, second part: mevp_tiled and transport_tiled against their
    plain versions and against K1's schedule, at 1024^2 and a ragged shape
    (mevp_tiled in both shipped launch configurations), and mevp_tiled at
    config 5's 4096^2 in the configuration the host picks there; then each
    per call at 1024^2 against its plain version, and mevp_tiled at 4096^2."""
    errs = {"mevp_tiled": 0.0, "transport_tiled": 0.0}

    def mevp_tiled_against_plain_and_k1(tag, solver, carry, consts, configs):
        for n in (N_SUBCYCLES, 13):  # 13: a multiple of neither halo
            ref = mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, n)
            k1 = cc.mevp_subcycles(solver, carry, consts, DT, n)
            for config in configs:
                got = mt.mevp_subcycles_tiled(solver, carry, consts, DT, n, *config)
                for plane, g, r, q in zip(VELOCITY, got, ref, k1):
                    label = f"mevp_tiled {tag} {config} N={n} {plane}"
                    errs["mevp_tiled"] = max(errs["mevp_tiled"], compare(label, g, r, TOL_STEP_MEVP))
                    same_schedule(label, g, q)

    inputs = {shape: tiled_inputs(*shape, device, SEED + 1) for shape in ((N4, N4), RAGGED)}
    for (nx, ny), (model, carry, consts, psi, faces) in inputs.items():
        solver, transport = model.mevp, model.transport
        mevp_tiled_against_plain_and_k1(f"{nx}x{ny}", solver, carry, consts, (mt.SMALL, mt.LARGE))
        u, v = carry[0], carry[1]
        for k in (1, 4):  # 4 substeps run in two launches
            args = (transport, psi, u, v, DT / k, k, faces)
            got = tt.transport_substeps_tiled(*args)
            tag = f"transport_tiled {nx}x{ny} k={k} ({tt.copy_form(ny, psi, u, v)} windows)"
            err = compare(tag, got, tt.transport_substeps_tiled_reference(*args), TOL_STEP_TRACER)
            errs["transport_tiled"] = max(errs["transport_tiled"], err)
            k1 = cc.transport_substeps(*args)
            same_schedule(tag, got, k1)
            # The other copy form and the two-block alternative: the same schedule.
            for name, launch in (("4-byte copies", {"copy": "scalar"}), ("two blocks an SM", {"config": tt.TWO_BLOCKS})):
                same_schedule(f"transport_tiled {nx}x{ny} k={k} {name}", tt.transport_substeps_tiled(*args, **launch), k1)
    # A grid whose rows are no multiple of 16 bytes: 4-byte copies.
    model, carry, _, psi, faces = tiled_inputs(RAGGED[0], RAGGED[1] - 2, device, SEED + 1)
    for k in (1, 4):
        args = (model.transport, psi, carry[0], carry[1], DT / k, k, faces)
        got = tt.transport_substeps_tiled(*args)
        tag = f"transport_tiled {RAGGED[0]}x{RAGGED[1] - 2} k={k} ({tt.copy_form(RAGGED[1] - 2, psi)} windows)"
        err = compare(tag, got, tt.transport_substeps_tiled_reference(*args), TOL_STEP_TRACER)
        errs["transport_tiled"] = max(errs["transport_tiled"], err)
        same_schedule(tag, got, cc.transport_substeps(*args))
    torch.cuda.synchronize()

    model, carry, consts, psi, faces = inputs[(N4, N4)]
    solver, transport = model.mevp, model.transport
    u, v = carry[0], carry[1]
    timed = {
        # 8 subcycles, one launch at 1024^2; the plain version runs the same subcycles
        # (arguments bound now: the names are taken again for 4096^2 below,
        # and DEVICE_PROBES runs these at the end)
        "mevp_tiled": (
            lambda solver=solver, carry=carry, consts=consts: mt.mevp_subcycles_tiled(
                solver, carry, consts, DT, TILED_SUBCYCLES),
            lambda: mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, TILED_SUBCYCLES),
        ),
        # one launch: one rk2 substep with its velocity sampling
        "transport_tiled": (
            lambda: tt.transport_substeps_tiled(transport, psi, u, v, DT, 1, faces),
            lambda: tt.transport_substeps_tiled_reference(transport, psi, u, v, DT, 1, faces),
        ),
    }
    n = N4 * N4
    work = {  # (bytes, operations) of one call at 1024^2
        "mevp_tiled": ((5 + 7 + 5) * 4 * n, TILED_SUBCYCLES * (OPS["stress"] + OPS["velocity"]) * n),
        "transport_tiled": ((9 + 4 + 9) * 4 * n, 2 * OPS["stage_cell"] * n),
    }
    results = {}
    for name, (kernel, plain) in timed.items():
        DEVICE_PROBES[f"{name} {N4}^2"] = kernel
        ms_, plain_ms = time_ms(kernel, 50), time_ms(plain, 3)
        results[name] = Row(errs[name], ms_, plain_ms, *work[name])
        log("time", (
            f"{name}: kernel {ms_:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound(*work[name])[0]:.4f} ms ({bound(*work[name])[1]}) per call at {N4}x{N4} "
            f"({'8 subcycles' if name == 'mevp_tiled' else 'one rk2 substep'})"
        ))
    # transport_tiled at config 5's 4096^2: one rk2 substep per call.
    # The launch the host picks there (two blocks an SM from 2048^2) against
    # its plain version and K1's schedule first.
    transport16, psi16, u16, v16 = mevp_large.transport_inputs(N16, device, SEED + 1)
    n16 = N16 * N16
    config = tt.launch_config(tt.halo_for(1, 2), elements=n16)
    args16 = (transport16, psi16, u16, v16, DT, 1)
    got16 = tt.transport_substeps_tiled(*args16)
    tag = f"transport_tiled {N16}x{N16} k=1 ({config}, the host's pick)"
    err = compare(tag, got16, tt.transport_substeps_tiled_reference(*args16), TOL_STEP_TRACER)
    errs["transport_tiled"] = max(errs["transport_tiled"], err)
    results["transport_tiled"].err = errs["transport_tiled"]
    same_schedule(tag, got16, cc.transport_substeps(*args16))
    del got16
    # dg1_rk_stage at 1024^2 (rk3 on one device, transport_backend="xla"):
    # one blended stage against its plain version.
    stage = (transport, psi, psi.flip(-1).contiguous(), u, v, *faces, 0.5, 0.5, DT)
    compare(f"dg1_rk_stage {N4}x{N4}", cc.dg1_rk_stage(*stage), cc.dg1_rk_stage_reference(*stage), TOL_LAUNCH)
    DEVICE_PROBES[f"dg1_rk_stage {N4}^2 uniform"] = lambda stage=stage: cc.dg1_rk_stage(*stage)
    STAGE_FORMS[f"blended at {N4}x{N4}"] = Row(
        0.0, time_ms(lambda: cc.dg1_rk_stage(*stage), 50), time_ms(lambda: cc.dg1_rk_stage_reference(*stage), 3),
        (9 + 9 + 4 + 9) * 4 * n, OPS["stage"] * n,
    )
    ms16 = time_ms(lambda: tt.transport_substeps_tiled(*args16), 20)
    plain16 = time_ms(lambda: tt.transport_substeps_tiled_reference(*args16), 1)
    bound16 = bound((9 + 4 + 9) * 4 * n16, 2 * OPS["stage_cell"] * n16)
    log("time", (
        f"transport_tiled: kernel {ms16:.4f} ms per call at {N16}x{N16} (one rk2 substep), plain "
        f"{plain16:.4f} ms, bound {bound16[0]:.4f} ms ({bound16[1]}); {config}, "
        f"{tt.blocks_per_sm(device, config, tt.halo_for(1, 2))} blocks an SM"
    ))
    del args16, psi16, u16, v16
    # mevp_tiled at config 5's 4096^2 (seeded planes in motion, mevp_large's)
    # against its plain version and K1's schedule, then per call of 8
    # subcycles and per element and subcycle.
    solver, carry, consts = mevp_large.seeded_phase(N16, False, device, SEED + 1)
    config16 = mt.launch_config(N16, N16)
    mevp_tiled_against_plain_and_k1(f"{N16}x{N16}", solver, carry, consts, (config16,))
    results["mevp_tiled"].err = errs["mevp_tiled"]
    ms16 = time_ms(lambda: mt.mevp_subcycles_tiled(solver, carry, consts, DT, TILED_SUBCYCLES), 20)
    plain16 = time_ms(lambda: mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, TILED_SUBCYCLES), 1)
    log("time", (
        f"mevp_tiled: kernel {results['mevp_tiled'].ms:.4f} ms per call at {N4}x{N4} "
        f"({results['mevp_tiled'].ms * 1e9 / (n * TILED_SUBCYCLES):.2f} ps per element and subcycle; "
        f"tile, halo, threads {mt.launch_config(N4, N4)}), {ms16:.4f} ms at {N16}x{N16} "
        f"({ms16 * 1e9 / (N16 * N16 * TILED_SUBCYCLES):.2f} ps; {config16}; plain {plain16:.4f} ms), "
        f"{TILED_SUBCYCLES} subcycles a call"
    ))
    return results


def launches_per_call(fn, kernel: str) -> int:
    """The launches of ``kernel`` that one ``fn()`` makes."""
    before = cc.launches[kernel]
    fn()
    return cc.launches[kernel] - before


def check_single(device) -> dict:
    """Phase 3, third part: mevp_single against its plain version, K1's
    schedule and mevp_tiled (256^2 uniform and spherical, 1024^2 spherical,
    the ragged shape), and the metric transport kernels against their plain
    versions and each other; then mevp_single per call at 256^2 uniform and
    at the spherical path's 1024^2 beside mevp_tiled on the same carry."""
    errs = []
    model, carry, consts, _, _ = tiled_inputs(N, N, device, SEED + 2, spherical=True)
    for n in (1, 13, N_SUBCYCLES):
        got = single.mevp_subcycles_single(model.mevp, carry, consts, DT, n)
        ref = single.mevp_single_reference(model.mevp, carry, consts, DT, n)
        tol = TOL_LAUNCH if n == 1 else TOL_STEP_MEVP
        for name, g, r in zip(VELOCITY, got, ref):
            errs.append(compare(f"mevp_single {N}x{N} spherical N={n} {name}", g, r, tol))
    uniform = tiled_inputs(N, N, device, SEED + 3)
    model, carry, consts, _, _ = uniform
    got = single.mevp_subcycles_single(model.mevp, carry, consts, DT, N_SUBCYCLES)
    k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, N_SUBCYCLES)
    ref = single.mevp_single_reference(model.mevp, carry, consts, DT, N_SUBCYCLES)
    for name, g, q, r in zip(VELOCITY, got, k1, ref):
        tag = f"mevp_single {N}x{N} uniform N={N_SUBCYCLES} {name}"
        errs.append(compare(tag, g, r, TOL_STEP_MEVP))
        same_schedule(tag, g, q)
    spherical = {
        shape: tiled_inputs(*shape, device, SEED + 4, spherical=True) for shape in ((N4, N4), RAGGED)
    }
    for (nx, ny), (model, carry, consts, _, _) in spherical.items():
        got = single.mevp_subcycles_single(model.mevp, carry, consts, DT, N_SUBCYCLES)
        ref = single.mevp_single_reference(model.mevp, carry, consts, DT, N_SUBCYCLES)
        tiled = mt.mevp_subcycles_tiled(model.mevp, carry, consts, DT, N_SUBCYCLES)
        k1 = cc.mevp_subcycles(model.mevp, carry, consts, DT, N_SUBCYCLES)
        for name, g, r, w, q in zip(VELOCITY, got, ref, tiled, k1):
            tag = f"mevp_single {nx}x{ny} spherical N={N_SUBCYCLES} {name}"
            errs.append(compare(tag, g, r, TOL_STEP_MEVP))
            same_schedule(tag, g, w, "mevp_tiled")
            same_schedule(tag, g, q)
        del got, ref, tiled, k1

    # The metric transport kernels with the coastline, at 1024^2.
    model, carry, _, psi, faces = spherical[(N4, N4)]
    transport, u, v = model.transport, carry[0], carry[1]
    transport_errs = []
    for k in (1, 4):
        args = (transport, psi, u, v, DT / k, k, faces)
        got = tt.transport_substeps_tiled(*args)
        tag = f"transport_tiled {N4}x{N4} spherical, coastline, k={k}"
        transport_errs.append(
            compare(tag, got, tt.transport_substeps_tiled_reference(*args), TOL_STEP_TRACER)
        )
        same_schedule(tag, got, cc.transport_substeps(*args), "the metric dg1_rk_stage schedule")
    stage = (transport, psi, psi.flip(-1).contiguous(), u, v, *faces, 0.5, 0.5, DT)
    stage_err = compare(
        f"dg1_rk_stage {N4}x{N4} spherical, coastline", cc.dg1_rk_stage(*stage),
        cc.dg1_rk_stage_reference(*stage), TOL_LAUNCH,
    )
    DEVICE_PROBES[f"dg1_rk_stage {N4}^2 spherical"] = lambda stage=stage: cc.dg1_rk_stage(*stage)
    n = N4 * N4
    STAGE_FORMS[f"metric, blended at {N4}x{N4} spherical, coastline"] = Row(
        0.0, time_ms(lambda: cc.dg1_rk_stage(*stage), 50), time_ms(lambda: cc.dg1_rk_stage_reference(*stage), 3),
        (9 + 9 + 4 + 5 + 9) * 4 * n, OPS["stage"] * n,
    )
    torch.cuda.synchronize()

    # Per call at the headline's size, uniform consts: 100 subcycles.
    model, carry, consts, _, _ = uniform
    solver = model.mevp
    runs = time_in_turns(
        {
            "mevp_single": lambda: single.mevp_subcycles_single(solver, carry, consts, DT, N_SUBCYCLES),
            "K1": lambda: cc.mevp_subcycles(solver, carry, consts, DT, N_SUBCYCLES),
            "plain": lambda: single.mevp_single_reference(solver, carry, consts, DT, N_SUBCYCLES),
        },
        {"mevp_single": 20, "K1": 10, "plain": 2},
    )
    mean = {name: sum(r) / len(r) for name, r in runs.items()}
    n = N * N
    work = ((5 + 7 + 5) * 4 * n, N_SUBCYCLES * (OPS["stress"] + OPS["velocity"]) * n)
    bound_ms, bound_by = bound(*work)
    config = single.tiling(N, N, single.sm_count(device))
    log("time", (
        f"mevp_single: {mean['mevp_single']:.4f} ms per call of {N_SUBCYCLES} subcycles at "
        f"{N}x{N} uniform (runs {', '.join(f'{m:.4f}' for m in runs['mevp_single'])}), K1's schedule "
        f"{mean['K1']:.4f}, plain {mean['plain']:.4f}, bound {bound_ms:.4f} ms ({bound_by}); "
        f"{config.n_tiles} tiles of {config.tile}"
    ))
    DEVICE_PROBES[f"mevp_single {N}^2 uniform"] = (
        lambda solver=solver, carry=carry, consts=consts:
        single.mevp_subcycles_single(solver, carry, consts, DT, N_SUBCYCLES)
    )

    # Per call at the spherical path's shape, 1024^2 with the metric consts,
    # beside mevp_tiled's 13 launches on the same carry: the kernels line's row.
    model, carry, consts, _, _ = spherical[(N4, N4)]
    solver = model.mevp
    fns = {
        "mevp_single": lambda: single.mevp_subcycles_single(solver, carry, consts, DT, N_SUBCYCLES),
        "mevp_tiled": lambda: mt.mevp_subcycles_tiled(solver, carry, consts, DT, N_SUBCYCLES),
        "plain": lambda: single.mevp_single_reference(solver, carry, consts, DT, N_SUBCYCLES),
    }
    runs = time_in_turns(fns, {"mevp_single": 20, "mevp_tiled": 20, "plain": None})
    mean = {name: sum(r) / len(r) for name, r in runs.items()}
    n = N4 * N4
    work = (
        (5 + 12 + 5) * 4 * n, N_SUBCYCLES * (OPS["stress"] + OPS["velocity_metric"]) * n
    )
    bound_ms, bound_by = bound(*work)
    config = single.tiling(N4, N4, single.sm_count(device))
    log("time", (
        f"mevp_single: {mean['mevp_single']:.4f} ms per call of {N_SUBCYCLES} subcycles at "
        f"{N4}x{N4} spherical (runs {', '.join(f'{m:.4f}' for m in runs['mevp_single'])}), "
        f"mevp_tiled {mean['mevp_tiled']:.4f} in {launches_per_call(fns['mevp_tiled'], 'mevp_tiled')} "
        f"launches (runs {', '.join(f'{m:.4f}' for m in runs['mevp_tiled'])}), plain "
        f"{mean['plain']:.4f}, bound {bound_ms:.4f} ms ({bound_by}); {config.n_tiles} tiles of "
        f"{config.tile}, {config.threads} threads, const planes in shared memory "
        f"{config.resident(True)}"
    ))
    DEVICE_PROBES[f"mevp_single {N4}^2 spherical"] = fns["mevp_single"]
    DEVICE_PROBES[f"mevp_tiled {N4}^2 spherical, {N_SUBCYCLES} subcycles"] = fns["mevp_tiled"]
    return {
        "mevp_single": Row(max(errs), mean["mevp_single"], mean["plain"], *work),
        "transport_metric": max(transport_errs),
        "dg1_rk_stage_metric": stage_err,
    }


def check_cfl(device) -> float:
    """Phase 3, fifth part: dg1_sample_cfl at every shape the paths launch
    it (256^2 in check_kernels): config 4's and the spherical path's 1024^2,
    config 5's single-device 4096^2, and a 2x2 rank's 2048^2 block widened
    by the spmd transport's H = 8 (its halo form); speeds equal to the plain
    version's, with nothing zeroed before, then per call against its plain
    version and its bound (u and v read once)."""
    err = 0.0
    cases = (
        ("uniform", N4, 0, False), ("spherical", N4, 0, True), ("uniform", N16, 0, False),
        ("rank block", N16 // 2, 8, False),
    )
    for tag, n, halo, sphere in cases:
        rng = np.random.default_rng(SEED + 14 + n + halo)
        mesh = spherical_mesh(n) if sphere else RectMesh(n, n, 4e3, 4e3)
        transport = CoupledModel(mesh).transport
        shape = (n + 2 * halo, n + 2 * halo)
        u, v = (torch.tensor(rng.normal(0.0, 0.3, shape), device=device, dtype=torch.float32) for _ in range(2))
        speeds = torch.full((2,), float("nan"), device=device)
        tables, stream = cc._dg1_tables(transport), cc._stream(device)
        call = lambda u=u, v=v, speeds=speeds, tables=tables, halo=halo: cc._dg1_sample_cfl_(
            u, v, speeds, tables, stream, halo=halo)
        call()
        ref = cc.dg1_sample_cfl_reference(transport, u, v, halo=halo)
        label = f"dg1_sample_cfl {n}x{n} {tag}" + (f", halo {halo} ({shape[0]}^2 widened)" if halo else "")
        err = max(err, compare(f"{label} speeds", speeds, ref, 0.0))
        ms_ = time_ms(call, 50)
        plain_ms = time_ms(lambda: cc.dg1_sample_cfl_reference(transport, u, v, halo=halo), 3)
        work = (2 * 4 * (n + 1) ** 2 + 8, OPS["cfl"] * n * n)
        log("time", (
            f"{label}: kernel {ms_:.5f} ms back to back, plain {plain_ms:.4f} ms, bound "
            f"{bound(*work)[0]:.5f} ms ({bound(*work)[1]}) per call"
        ))
        DEVICE_PROBES[f"dg1_sample_cfl {n}^2 {tag}" + (f" halo {halo}" if halo else "")] = call
    return err


def ho_model(device, n: int = N4, degree: int = 1, **backends):
    """``bench_coupled_1m(high_order=True)`` at n^2: config 4 with the HO
    solver selected through the module registry (reset after the build)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        return coupled_model(device, RectMesh(n, n, dx=4e3, dy=4e3), None, degree, **backends)
    finally:
        loader.reset()


def ho_inputs(nx, ny, device, seed):
    """Seeded HO solver inputs on a closed (nx, ny) mesh of 4 km elements:
    (model, carry, consts, tracers, face masks)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (nx, ny)
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        model = CoupledModel(RectMesh(nx, ny, 4e3, 4e3), n_subcycles=N_SUBCYCLES)
    finally:
        loader.reset()
    field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, shape)) for _ in range(4)))
    state = mevp_ho.HOVelocityState(
        u=field(0.2), v=field(0.2), s11=t(rng.normal(0.0, 1e3, (3, *shape))),
        s22=t(rng.normal(0.0, 1e3, (3, *shape))), s12=t(rng.normal(0.0, 5e2, (3, *shape))),
    )
    forcing = mevp_ho.HODynamicsForcing(field(2.0, 6.0), field(2.0, 3.0), field(0.05), field(0.05))
    h, a = t(rng.uniform(0.0, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(state, h, a, forcing, mask, DT)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    psi = t(np.concatenate([
        rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (2, 3, *shape))
    ]))
    faces = tuple(t((rng.uniform(size=shape) > 0.1).astype(np.float32)) for _ in range(2))
    return model, carry, consts, psi, faces


def ho_planes(carry):
    """(name, plane) of an HO carry: 8 velocity planes, 3 stress stacks."""
    return list(velocity_leaves(mevp_ho.HOVelocityState(*carry)))


def check_ho(device) -> dict:
    """Phase 3, fourth part: ho_single and ho_tiled against their plain
    version and each other, and the qv form of transport_tiled; then each
    per call at its path's shape against its plain version and bound."""
    errs = {"ho_single": 0.0, "ho_tiled": 0.0}

    def against_plain(kernel, run, tag, model, carry, consts, n):
        got = run(model.mevp, carry, consts, DT, n)
        ref = mevp_ho.ho_subcycles_reference(model.mevp, carry, consts, DT, n)
        tol = TOL_LAUNCH if n == 1 else TOL_STEP_MEVP
        for (name, g), (_, r) in zip(ho_planes(got), ho_planes(ref)):
            errs[kernel] = max(errs[kernel], compare(f"{tag} N={n} {name}", g, r, tol))
        return got

    # The inputs at the paths' shapes serve the timings below too.
    inputs = {N: ho_inputs(N, N, device, SEED + 6), N4: ho_inputs(N4, N4, device, SEED + 7)}
    model, carry, consts, _, _ = inputs[N]
    for n in (1, 13, N_SUBCYCLES):
        against_plain("ho_single", hsc.ho_subcycles_single, f"ho_single {N}x{N}", model, carry, consts, n)
    for (nx, ny), (model, carry, consts, _, _) in (
        ((N4, N4), inputs[N4]), (RAGGED, ho_inputs(*RAGGED, device, SEED + 7)),
    ):
        for n in (1, 13):  # 13 = 8 + 5: not a multiple of the halo
            against_plain("ho_tiled", htc.ho_subcycles_tiled, f"ho_tiled {nx}x{ny}", model, carry, consts, n)
    for n_side in (N, 2 * N):
        model, carry, consts, _, _ = ho_inputs(n_side, n_side, device, SEED + 8)
        tiled = htc.ho_subcycles_tiled(model.mevp, carry, consts, DT, N_SUBCYCLES)
        single = hsc.ho_subcycles_single(model.mevp, carry, consts, DT, N_SUBCYCLES)
        for (name, g), (_, w) in zip(ho_planes(single), ho_planes(tiled)):
            same_schedule(f"ho_single {n_side}x{n_side} N={N_SUBCYCLES} {name}", g, w, "ho_tiled")
    # The shipped window (a cluster of one block) against clusters of 2 to
    # 16 blocks, whose blocks push their edges into each other's shared
    # memory, at 1024^2, N = 13.
    model, carry, consts, _, _ = inputs[N4]
    shipped = htc.ho_subcycles_tiled(model.mevp, carry, consts, DT, 13, htc.SHIPPED)
    for other in (htc.CLUSTER_2X2, htc.LaunchConfig(1, 2, 48, 8, 512), htc.LaunchConfig(2, 4, 48, 8, 512),
                  htc.LaunchConfig(4, 4, 32, 8, 256)):
        got = htc.ho_subcycles_tiled(model.mevp, carry, consts, DT, 13, other)
        for (name, g), (_, w) in zip(ho_planes(got), ho_planes(shipped)):
            same_schedule(f"ho_tiled {other} {N4}x{N4} N=13 {name}", g, w, f"ho_tiled {htc.SHIPPED}")

    # The qv form of transport_tiled at 1024^2: the CG2 samples of a
    # velocity scaled so that k = 4 runs two launches.
    model, carry, _, psi, faces = inputs[N4]
    qv_errs = []
    for k in (1, 4):
        scaled = tuple(mevp_ho.HOField(*(k * x for x in f.planes())) for f in carry[:2])
        qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, *scaled)
        args = (model.transport, psi, None, None, DT / k, k, faces)
        got = tt.transport_substeps_tiled(*args, qv=qv)
        ref = tt.transport_substeps_tiled_reference(*args, qv=qv)
        tag = f"transport_tiled qv form {N4}x{N4} k={k}"
        qv_errs.append(compare(tag, got, ref, TOL_STEP_TRACER))
        same_schedule(tag, got, cc.transport_substeps(*args, qv=qv), "the staged qv transport")
    torch.cuda.synchronize()

    # Per call at the paths' shapes: ho_single's 100 subcycles at 256^2,
    # one ho_tiled launch (HALO subcycles) at 1024^2.
    results = {}
    for kernel, n_side, n_sub, run in (
        ("ho_single", N, N_SUBCYCLES, hsc.ho_subcycles_single),
        ("ho_tiled", N4, htc.HALO, htc.ho_subcycles_tiled),
    ):
        model, carry, consts, _, _ = inputs[n_side]
        solver = model.mevp
        DEVICE_PROBES[f"{kernel} {n_side}^2"] = (
            lambda run=run, solver=solver, carry=carry, consts=consts, n_sub=n_sub:
            run(solver, carry, consts, DT, n_sub)
        )
        runs = time_in_turns(
            {
                "kernel": lambda: run(solver, carry, consts, DT, n_sub),
                "plain": lambda: mevp_ho.ho_subcycles_reference(solver, carry, consts, DT, n_sub),
            },
            {"kernel": 20, "plain": None},
        )
        mean = {name: sum(r) / len(r) for name, r in runs.items()}
        elements = n_side * n_side
        work = (
            HO_PLANES_MOVED * 4 * elements, n_sub * (OPS["ho_stress"] + OPS["ho_velocity"]) * elements
        )
        bound_ms, bound_by = bound(*work)
        results[kernel] = Row(errs[kernel], mean["kernel"], mean["plain"], *work)
        log("time", (
            f"{kernel}: kernel {mean['kernel']:.4f} ms (runs "
            f"{', '.join(f'{m:.4f}' for m in runs['kernel'])}), plain {mean['plain']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}) per call of {n_sub} subcycles at {n_side}x{n_side}"
        ))
    for n_side in (N, 2 * N):
        config = hsc.tiling(n_side, n_side, hsc.sm_count(device))
        log("build", (
            f"ho_single at {n_side}x{n_side}: {config.tiles[0]}x{config.tiles[1]} tiles of {config.tile}, "
            f"{config.threads} threads, {config.shared_bytes()} B shared (consts "
            f"{'in shared memory' if config.consts_shared else 'from global memory'}), "
            f"{hsc.max_blocks(device, config)} blocks resident at once; holds grids up to "
            f"{hsc.largest_square(hsc.sm_count(device))}^2"
        ))
    return {**results, "transport_qv": max(qv_errs)}


def check_bounded(tag: str, out, first) -> None:
    for name, leaf, like in leaves(out, first):
        if leaf.shape != like.shape or not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"{tag}: {name} is not finite or has shape {tuple(leaf.shape)}")
    cice, hice, hsnow = out.cice[0], out.hice[0], out.hsnow[0]
    if not (bool((cice >= 0).all()) and bool((cice <= 1).all())):
        raise AssertionError(f"{tag}: cice outside [0, 1]")
    if not (bool((hice >= 0).all()) and bool((hsnow >= 0).all())):
        raise AssertionError(f"{tag}: negative hice or hsnow")
    log("slice", (
        f"{tag} finite and bounded: max|u| {max_u(out.velocity):.4f} m/s, "
        f"cice in [{float(cice.min()):.4f}, {float(cice.max()):.4f}], "
        f"hice >= {float(hice.min()):.4f}"
    ))


def max_u(velocity) -> float:
    """max |u| over the x velocity's planes."""
    return max(float(x.abs().max()) for n, x in velocity_leaves(velocity) if n[0] == "u")


def check_land(tag: str, model, out, first) -> None:
    """With a coastline: land elements keep their initial tracers exactly
    (with the TVB limiter, which limits the slopes of every element as the
    JAX package's does, their cell means), and every node that touches land
    (node mask 0) is at rest. rk3's stage blends (3/4 psi + 1/4 psi, 1/3 psi
    + 2/3 psi) round a land element's unchanged value by an ulp, on the plain
    path too: there the tracers must stay within 1e-6 of their value."""
    device = out.hice.device
    land = torch.as_tensor(model.ocean_mask == 0.0, device=device)
    kept = slice(0, 1) if model.transport.limits_slopes else slice(None)
    rk3 = model.transport.scheme == "rk3"
    for name in ("hice", "cice", "hsnow"):
        got, ref = getattr(out, name)[kept][:, land], getattr(first, name)[kept][:, land]
        same = torch.allclose(got, ref, rtol=1e-6, atol=0.0) if rk3 else torch.equal(got, ref)
        if not same:
            raise AssertionError(f"{tag}: {name} changed on land")
    mask = model.node_mask(device=device, dtype=out.hice.dtype)
    # The HO velocity: the nodes of each CG2 plane against that plane's mask.
    planes = mevp_ho.PLANES if model.is_high_order else (None,)
    at = lambda x, k: x if k is None else getattr(x, k)
    n_pinned = 0
    for k in planes:
        pinned = at(mask, k) == 0.0
        n_pinned += int(pinned.sum())
        for name in ("u", "v"):
            if not bool((at(getattr(out.velocity, name), k)[pinned] == 0.0).all()):
                raise AssertionError(f"{tag}: {name} is not zero on a node that touches land")
    log("slice", (
        f"{tag}: land tracers unchanged on {int(land.sum())} elements, u = v = 0 on "
        f"{n_pinned} pinned nodes"
    ))


def compare_step(tag: str, got, ref) -> None:
    """Every leaf of one coupled step (12; 18 with the HO velocity) against
    the plain path."""
    for name in ("hice", "cice", "hsnow", "sst", "sss", "tice", "new_ice"):
        compare(f"{tag}.{name}", getattr(got, name), getattr(ref, name), TOL_STEP_TRACER)
    pairs = zip(velocity_leaves(got.velocity), velocity_leaves(ref.velocity))
    for (name, g), (_, r) in pairs:
        compare(f"{tag}.velocity.{name}", g, r, TOL_STEP_MEVP)


def path_step(model, state, phys, dyn, do_thermo: bool, phase=None):
    """One step of a path: the model's own schedule, or with ``phase`` (as
    ``K1_SPLIT``) that dynamics phase in its place."""
    if phase is None:
        return model.step(state, phys, dyn, DT, do_thermo=do_thermo)
    state = model.step_dynamics(state, dyn, DT, phase=phase)
    return model.step_thermo(state, phys, DT) if do_thermo else state


def drive_path(path: str, model, state, phys, dyn, do_thermo: bool, n_steps: int = 20, phase=None) -> dict:
    """n_steps steps from zeroed launch counters (``phase``: as
    ``path_step``'s); fails unless every kernel of the path was launched."""
    cc.reset_launches()
    if phase is None:
        out = model.run(state, phys, dyn, DT, n_steps, do_thermo=do_thermo)
    else:
        out = state
        for _ in range(n_steps):
            out = path_step(model, out, phys, dyn, do_thermo, phase)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    log("slice", f"{path}: {n_steps} steps, launches: {counts}")
    check_bounded(f"{path}: {n_steps} steps", out, state)
    if model.ocean_mask is not None:
        check_land(f"{path}: {n_steps} steps", model, out, state)
    missing = [name for name in PATH_KERNELS[path] if counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    return counts


def check_slice(device) -> dict:
    """Phase 4: each main path against the plain path, then 20 steps."""
    model, state, forcing = bench_model(device)
    got = model.step(state, None, forcing, DT, do_thermo=False)
    ref = model.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference)
    for name in ("hice", "cice", "hsnow"):
        compare(f"step.{name}", getattr(got, name), getattr(ref, name), TOL_STEP_TRACER)
    for name in ("u", "v", "s11", "s22", "s12"):
        compare(
            f"step.velocity.{name}", getattr(got.velocity, name),
            getattr(ref.velocity, name), TOL_STEP_MEVP,
        )
    counts = {"headline": drive_path("headline", model, state, None, forcing, False)}

    model, state, phys, dyn = config4_model(device)
    schedule = model.schedule(device)
    log("slice", f"config4: {N4}x{N4}, auto schedule {schedule}")
    if schedule != ("pallas-tiled", "tiled"):
        raise AssertionError(f"config 4 does not run the tiled kernels: {schedule}")
    compare_step("config4.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
    counts["config4"] = drive_path("config4", model, state, phys, dyn, True)

    # Config 4's uniform coastline variant (coupled_1m_mask), on "auto".
    model, state, phys, dyn = coupled_model(
        device, RectMesh(N4, N4, dx=4e3, dy=4e3), synthetic_coastline(N4)
    )
    got = model.step(state, phys, dyn, DT)
    compare_step("config4_mask.step", got, plain_step(model, state, phys, dyn))
    check_land("config4_mask: 1 step", model, got, state)

    # The spherical coastline variant (coupled_1m_spherical).
    model, state, phys, dyn = spherical_model(device, mevp_backend="pallas")
    schedule = model.schedule(device)
    log("slice", (
        f"spherical: {N4}x{N4}, min dx {float(np.min(model.mesh.dx)):.1f} m, max dx "
        f"{float(np.max(model.mesh.dx)):.1f} m, dy {model.mesh.dy:.1f} m, ocean share "
        f"{float(model.ocean_mask.mean()):.4f}, schedule {schedule}"
    ))
    if schedule != ("single", "tiled"):
        raise AssertionError(f"the spherical path does not run mevp_single: {schedule}")
    model_auto = spherical_model(device)[0]
    log("slice", f"spherical: auto schedule {model_auto.schedule(device)}")
    for tag, m in (("spherical.pallas.step", model), ("spherical.auto.step", model_auto)):
        compare_step(tag, m.step(state, phys, dyn, DT), plain_step(m, state, phys, dyn))
    counts["spherical"] = drive_path("spherical", model, state, phys, dyn, True)

    # The HO paths: ho_coupled_1m on "auto", ho_coupled_256 on "pallas".
    for path, n, backend, expected in (
        ("ho_coupled_1m", N4, "auto", ("tiled", "tiled")),
        ("ho_coupled_256", N, "pallas", ("single", "tiled")),
    ):
        model, state, phys, dyn = ho_model(device, n, mevp_backend=backend)
        schedule = model.schedule(device)
        log("slice", f"{path}: {n}x{n}, HO solver, {backend} schedule {schedule}")
        if not model.is_high_order or schedule != expected:
            raise AssertionError(f"{path} does not run {expected}: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)

    # The HO 256^2 step on the staged transport (transport_backend="xla"),
    # with rk2 and with rk3 ("auto" takes transport_tiled for rk3 too).
    for path, scheme, transport in (("ho_coupled_256_staged", "rk2", "xla"), ("ho_coupled_256_rk3", "rk3", "xla")):
        model, state, phys, dyn = ho_model(device, N, mevp_backend="pallas", transport_backend=transport)
        model.transport.scheme = scheme
        schedule = model.schedule(device)
        log("slice", f"{path}: {N}x{N}, HO solver, {scheme}, transport_backend={transport!r}: schedule {schedule}")
        if schedule != ("single", "xla"):
            raise AssertionError(f"{path} does not run the staged transport: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)
    return counts


# -- K1 as one launch: fused_dynamics (phase check_fused) --------------------------
#: The squares of the "auto" threshold's sweep, and the largest the kernel
#: holds on the card (added at run time); the headline's steps whose k is
#: held to the host's.
FUSED_SWEEP = (64, 128, 256)
FUSED_STEPS = 20
#: Element width of the checks' inputs: 250 m, so that the relaxed velocity
#: needs k > 1 substeps.
FUSED_DX = 250.0


def fused_inputs(device, n: int, masked: bool, auto: bool, seed: int = SEED + 40, periodic=(False, False),
                 **form):
    """(model, carry, consts, psi, faces): seeded float32 inputs on an n^2
    mesh of FUSED_DX elements (``periodic``: its (x, y) axes), 100
    subcycles, a coastline with ``masked``, with ``auto`` off k = 3;
    ``form``: the model's degree, mevp_params and tvb_m ("mid": the middle M
    of the drawn hice slopes, so that the limiter both cuts and keeps)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    shape = (n, n)
    mid = form.get("tvb_m") == "mid"
    if mid:
        form = {**form, "tvb_m": 0.0}  # set below, from the drawn slopes
    model = CoupledModel(
        RectMesh(n, n, FUSED_DX, FUSED_DX, periodic_x=periodic[0], periodic_y=periodic[1]),
        n_subcycles=N_SUBCYCLES, ocean_mask=synthetic_coastline(n, n) if masked else None,
        auto_substeps=auto, transport_substeps=1 if auto else 3, **form,
    )
    carry = tuple(t(rng.normal(0.0, s, shape)) for s in (0.2, 0.2, 1e3, 1e3, 1e3))
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(8.0, 2.0, shape)), v_atm=t(rng.normal(2.0, 2.0, shape)),
        u_ocean=t(rng.normal(0.0, 0.05, shape)), v_ocean=t(rng.normal(0.0, 0.05, shape)),
    )
    h, a = t(rng.uniform(0.2, 2.0, shape)), t(rng.uniform(0.3, 1.0, shape))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), h, a, forcing, mask, DT)
    k = model.transport.basis.n_dofs
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (k - 1, 3, *shape))]))
    if mid:
        model.transport.tvb_m = middle_m(psi[:, 0], model.mesh)
    return model, carry, consts, psi, model.face_masks(device=device, dtype=torch.float32)


def check_fused_launch(tag: str, model, carry, consts, psi, faces, auto: bool) -> float:
    """One fused_dynamics launch against the plain phase (1e-3 on the mEVP
    planes, 1e-5 on the tracers) and K1's split schedule in the same form
    (expected 0, failure above 1e-6); its speeds equal dg1_sample_cfl's and
    its k the host's (k > 1; 3 with ``auto`` off). Returns the largest error
    against the plain phase."""
    errs = [0.0]
    cc.reset_launches()
    got_carry, got_tr, info = fd.fused_dynamics_single(model, carry, psi, consts, DT, N_SUBCYCLES, faces)
    torch.cuda.synchronize()
    if cc.launches["fused_dynamics"] != 1 or sum(cc.launches.values()) != 1:
        raise AssertionError(f"{tag}: launches {dict(cc.launches)}")
    split = K1_SPLIT(model, carry, psi, consts, DT, N_SUBCYCLES, faces)
    ref = cc.fused_dynamics_reference(model, carry, psi, consts, DT, N_SUBCYCLES, faces)
    for name, g, sp, r in zip(VELOCITY, got_carry, split[0], ref[0]):
        same_schedule(f"{tag}.{name}", g, sp)
        errs.append(compare(f"{tag}.{name} vs plain", g, r, TOL_STEP_MEVP))
    same_schedule(f"{tag}.tracers", got_tr, split[1])
    errs.append(compare(f"{tag}.tracers vs plain", got_tr, ref[1], TOL_STEP_TRACER))
    speeds = cc.dg1_sample_cfl(model.transport, split[0][0], split[0][1])
    compare(f"{tag}.speeds vs dg1_sample_cfl", info[:2], speeds, 0.0)
    k, host_k = int(info[2]), (cc._k_of_speeds(model, speeds, DT) if auto else 3)
    if k != host_k or k < 2:
        raise AssertionError(f"{tag}: k = {k}, the host's {host_k} (k > 1 expected)")
    log("check", f"{tag}: k = {k} on the card and on the host")
    return max(errs)


def fused_work(n: int, k: int, masked: bool = False) -> tuple:
    """(bytes, operations) of one fused_dynamics call at n^2 with k
    substeps: the 5 state, 7 const and 9 tracer planes (and 2 masks) read
    once, 5 + 9 written; the subcycles' stress and velocity halves, the
    CFL sampling and 2k stages of dg1_stage_cell (the velocity sampled in
    full, every face point of each tracer) an element."""
    planes = 5 + 7 + 9 + (2 if masked else 0) + 5 + 9
    ops = N_SUBCYCLES * (OPS["stress"] + OPS["velocity"]) + OPS["cfl"] + 2 * k * OPS["stage_cell"]
    return planes * 4 * n * n, ops * n * n


def check_fused(device, card: str) -> Row:
    """Phase check_fused: K1 as one launch (fused_dynamics) at 256^2.

    1. The kernel against the plain phase (1e-3 on the mEVP planes, 1e-5 on
       the tracers) and K1's split schedule (expected 0, failure above
       1e-6), with and without the coastline, auto_substeps on (k > 1) and
       off (k = 3); its speeds equal dg1_sample_cfl's and its k the host's.
    2. The kernel's k arithmetic against the host's on every ceil boundary.
    3. FUSED_STEPS bounded headline steps, k equal to the host's at each.
    4. Warmed-up headline steps under set_sync_debug_mode("error").
    5. The kernel's times (back to back, its plain phase), the "auto"
       threshold's sweep in turns (fused, tiled, K1's split schedule, the
       dynamics step at FUSED_SWEEP and the largest square held), and a
       profile of the fused headline step.
    Returns the kernel's Row."""
    sms = cc.sm_count(device)
    largest = fd.largest_square(sms)
    for masked in (False, True):
        config = fd.tiling(N, N, sms, masked)
        log("build", (
            f"fused_dynamics at {N}x{N}{' with the coastline' if masked else ''}: {config.tiles[0]}x{config.tiles[1]} "
            f"tiles of {config.tile}, {config.threads} threads, {config.shared_bytes} B shared, "
            f"{config.resident} const planes resident, {config.exchange_words * 8} B of exchange words; "
            f"{fd.max_blocks(device, config)} blocks resident at once; holds squares up to {largest}^2 "
            f"({fd.tiling(largest, largest, sms, masked).resident} const planes resident there)"
        ))
    errs = [0.0]
    for masked in (False, True):
        for auto in (True, False):
            tag = f"fused_dynamics {N}x{N}{' coastline' if masked else ''} {'auto' if auto else 'k = 3'}"
            model, carry, consts, psi, faces = fused_inputs(device, N, masked, auto)
            errs.append(check_fused_launch(tag, model, carry, consts, psi, faces, auto))

    mesh = RectMesh(N, N, dx=512e3 / N, dy=512e3 / N)
    speeds = fd.ceil_boundary_speeds(DT, mesh)
    for k_floor in (1, 3):
        got = fd.substeps_on_card(torch.tensor(speeds, device=device), DT, mesh, k_floor=k_floor).cpu().numpy()
        host = np.array([int(cc.substeps_from_speeds(torch.tensor(x), torch.tensor(y), DT, mesh, 1, k_floor=k_floor))
                         for x, y in speeds])
        plain = fd.substeps_plain(speeds[:, 0], speeds[:, 1], DT, mesh, k_floor=k_floor)
        if not (np.array_equal(got, host) and np.array_equal(got, plain)):
            raise AssertionError(f"fused_substeps: {int((got != host).sum())} of {len(speeds)} k differ from the host's")
        log("check", (
            f"fused_substeps (k_floor {k_floor}): {len(speeds)} speed pairs at every ceil boundary up to k "
            f"{fd.K_MAX + 6}: the card's k equals the host's and the plain mirror's on all"
        ))

    model, state, forcing = bench_model(device)
    if model.schedule(device) != ("fused", "xla"):
        raise AssertionError(f"the headline does not run fused_dynamics: {model.schedule(device)}")
    infos = []

    def recorded(model, carry, tracers, consts, dt, n, faces):
        planes, out, info = fd.fused_dynamics_single(model, carry, tracers, consts, dt, n, faces)
        infos.append((info, planes[0], planes[1]))
        return planes, out

    out = state
    for _ in range(FUSED_STEPS):
        out = model.step_dynamics(out, forcing, DT, phase=recorded)
    ks = []
    for info, u, v in infos:
        speeds = cc.dg1_sample_cfl(model.transport, u, v)
        if not torch.equal(info[:2], speeds) or int(info[2]) != cc._k_of_speeds(model, speeds, DT):
            raise AssertionError(f"headline step {len(ks)}: the card's (speeds, k) {info.tolist()} differ from the host's")
        ks.append(int(info[2]))
    check_bounded(f"headline: {FUSED_STEPS} steps on fused_dynamics", out, state)
    log("check", f"headline: k on the card = the host's at each of {FUSED_STEPS} steps: {ks}")

    step = lambda: model.step(state, None, forcing, DT, do_thermo=False)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("check", "headline: 3 warmed-up steps on fused_dynamics under set_sync_debug_mode('error'): no host sync")

    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(state.velocity, state.hice[0], torch.clamp(state.cice[0], 0.0, 1.0), forcing,
                                    mask, DT)
    carry = (state.velocity.u, state.velocity.v, state.velocity.s11, state.velocity.s22, state.velocity.s12)
    tracers = torch.stack([state.hice, state.cice, state.hsnow], dim=1)
    launch = lambda keep=consts: fd.fused_dynamics_single(model, carry, tracers, consts, DT, N_SUBCYCLES)
    k = int(launch()[2][2])
    plain = lambda: cc.fused_dynamics_reference(model, carry, tracers, consts, DT, N_SUBCYCLES)
    runs = time_in_turns({"kernel": launch, "plain": plain}, {"kernel": 50, "plain": None})
    DEVICE_PROBES[f"fused_dynamics {N}^2"] = launch
    work = fused_work(N, k)
    row = Row(max(errs), sum(runs["kernel"]) / len(runs["kernel"]), runs["plain"][0], *work)
    log("time", (
        f"fused_dynamics: kernel {', '.join(f'{m:.5f}' for m in runs['kernel'])} ms per call back to back "
        f"(the headline's first step, k = {k}), plain {row.plain_ms:.3f} ms, bound {bound(*work)[0]:.5f} ms "
        f"({bound(*work)[1]}) at {N}x{N} on {card}"
    ))

    for n in (*FUSED_SWEEP, largest):
        m, st, f = bench_model(device, n)
        fns = {
            "fused": lambda: m.step_dynamics(st, f, DT, phase=functools.partial(
                cc.dynamics_phase, mevp="fused", transport="xla")),
            "tiled": lambda: m.step_dynamics(st, f, DT, phase=functools.partial(
                cc.dynamics_phase, mevp="pallas-tiled", transport="tiled")),
            "K1 split": lambda: m.step_dynamics(st, f, DT, phase=K1_SPLIT),
        }
        runs = time_in_turns(fns, dict.fromkeys(fns, 5))
        means = {name: sum(ms) / len(ms) for name, ms in runs.items()}
        for name, ms in runs.items():
            report(f"threshold sweep: the dynamics step on {name} ({n}x{n})", ms, n * n, card)
        fastest = min(means, key=means.get)
        log("time", (
            f"threshold sweep {n}x{n}: fastest {fastest}; 'auto' runs {m.schedule(device)[0]} there "
            f"(FUSED_MAX_ELEMENTS {coupled.FUSED_MAX_ELEMENTS})"
        ))
        del m, st, f, fns
    profile(f"headline step on fused_dynamics ({N}x{N})", step, watch="fused_dynamics")
    return row


# -- fused_dynamics in its other forms (phase check_fused_forms) ------------------
#: The forms that check_fused_forms holds at 256^2: key -> (the kernels
#: line's row, fused_inputs' keywords, the instances' source, the paths
#: whose launches the row counts besides its own "fused_<key>"). tvb_m
#: "mid": the middle M of the inputs' slopes; "masked": the coastline only.
_BOTH_FORMS = MEVPParams(a_weighted_stress=True, adaptive_alpha=True, alpha_min=20.0)
FUSED_FORMS = {
    "periodic_x": ("fused_dynamics periodic x", dict(periodic=(True, False)), "fused_dynamics_dg1.cu", ()),
    "periodic": ("fused_dynamics periodic", dict(periodic=(True, True)), "fused_dynamics_dg1.cu", ()),
    "a_weighted": ("fused_dynamics A-weighted", dict(mevp_params=MEVPParams(a_weighted_stress=True)),
                   "fused_dynamics_dg1.cu", ()),
    "adaptive": ("fused_dynamics adaptive", dict(mevp_params=MEVPParams(adaptive_alpha=True, alpha_min=20.0)),
                 "fused_dynamics_dg1.cu", ("box_adaptive",)),
    "dg0": ("fused_dynamics dG0", dict(degree=0), "fused_dynamics_dg0.cu", ("headline_dg0",)),
    "dg2": ("fused_dynamics dG2", dict(degree=2), "fused_dynamics_dg2.cu", ("headline_dg2",)),
    "tvb_dg1": ("fused_dynamics tvb dG1", dict(tvb_m="mid"), "fused_dynamics_dg1_tvb.cu",
                ("tvb_headline_auto_m0", "tvb_headline_auto_mmid")),
    "tvb_dg2": ("fused_dynamics tvb dG2", dict(degree=2, tvb_m=0.0), "fused_dynamics_dg2_tvb.cu", ()),
    "every": ("fused_dynamics dG2 tvb periodic A-weighted adaptive coastline",
              dict(periodic=(True, True), degree=2, tvb_m="mid", mevp_params=_BOTH_FORMS, masked=True),
              "fused_dynamics_dg2_tvb.cu", ()),
}
PATH_KERNELS.update({f"fused_{key}": ("fused_dynamics",) for key in FUSED_FORMS})
#: Steps of each form's path: k held to the host's at each, then the
#: launch counts, then the no-sync steps.
FUSED_FORM_STEPS = 3


def fused_form_work(n: int, k: int, form, masked: bool) -> tuple:
    """(bytes, operations) of one call of the forms' kernel at n^2 with k
    substeps: the 5 state, 8 const (a_node too) and 3K tracer planes (and 2
    masks) read once, 5 + 3K written; per element the subcycles' stress
    (the weighted body; adaptive: its divides) and velocity halves, the CFL
    sampling at the degree's points, and per substep and stage the velocity
    sampled in full and per tracer its stage (dg1_stage_cell: the update and
    the limiter, every face point: a trace, the normal flux, the mask) and,
    with TVB, the limiter pass."""
    kk, q, e = dg_sizes(form.degree)
    planes = 5 + 8 + 3 * kk + (2 if masked else 0) + 5 + 3 * kk
    stress = OPS["stress_both"] if form.adaptive else OPS["stress_weighted"]
    cfl = 2 * q * 9 + 2 * e * 5
    tracer = stage_cell_ops(form.degree, True, not form.tvb) + 4 * e * (2 * kk + 1)
    tracer += tvb_limit_ops(form.degree) if form.tvb else 0
    stage = 2 * q * 7 + 4 * e * 3 + 3 * tracer
    ops = N_SUBCYCLES * (stress + OPS["velocity"]) + cfl + form.stages * k * stage
    return planes * 4 * n * n, ops * n * n


def fused_form_path(device, key: str):
    """(model, state, forcing) of a form's path: the headline box (256^2, 2
    km elements, wind (8, 2)) in the form, on "pallas"; TVB forms from a
    state with fronts, so that the limiter has slopes to cut."""
    kwargs = dict(FUSED_FORMS[key][1])
    masked = kwargs.pop("masked", False)
    mid = kwargs.get("tvb_m") == "mid"
    if mid:
        kwargs["tvb_m"] = 0.0  # set below, from the fronts' slopes
    model, state, forcing = bench_model(device, N, ocean=synthetic_coastline(N) if masked else None, **kwargs)
    if model.transport.limits_slopes:
        state = with_fronts(state, SEED + 30)
    if mid:
        model.transport.tvb_m = middle_m(state.hice, model.mesh)
    return model, state, forcing


def check_fused_forms(device, card: str) -> tuple:
    """Phase check_fused_forms: fused_dynamics in every other form
    (FUSED_FORMS) at 256^2, as check_fused holds the headline's:

    1. each form's kernel against the plain phase and K1's split schedule in
       that form, with and without the coastline, auto_substeps on and off,
       its speeds and k against the host's (check_fused_launch); the k
       arithmetic at dG0 and dG2 on every ceil boundary;
    2. each form's path (the headline box in the form): its k equal to the
       host's at each of FUSED_FORM_STEPS steps, the steps bounded with
       fused_dynamics launched and nothing else of K1, and warmed-up steps
       under set_sync_debug_mode("error");
    3. each form's kernel in turns with the headline's instance, back to
       back, and its plain phase once (device durations probed last);
    4. the battery's box_adaptive (``run_benchmarks.run_config``) on "auto",
       on fused_dynamics; the "auto" threshold sweep of box_adaptive and of
       dG2 with TVB (M = 0) at 256^2 and at the largest square the form
       holds: the dynamics step on fused, tiled and K1's split schedule in
       turns.

    Returns (the counts by path, the largest check error)."""
    sms = cc.sm_count(device)
    errs, counts = [0.0], {}
    c_model, c_carry, c_consts, c_psi, _ = fused_inputs(device, N, False, True)
    closed_launch = lambda: fd.fused_dynamics_single(c_model, c_carry, c_psi, c_consts, DT, N_SUBCYCLES)
    for key, (label, kwargs, source, _) in FUSED_FORMS.items():
        kwargs = dict(kwargs)
        masks = (True,) if kwargs.pop("masked", False) else (False, True)
        form = None
        for masked in masks:
            for auto in (True, False):
                model, carry, consts, psi, faces = fused_inputs(device, N, masked, auto, **kwargs)
                form = fd.form_of(model)
                tag = f"{label} {N}x{N}{' coastline' if masked else ''} {'auto' if auto else 'k = 3'}"
                if model.schedule(device) != ("fused", "xla") or form.headline:
                    raise AssertionError(f"{tag}: schedule {model.schedule(device)}, form {form}")
                errs.append(check_fused_launch(tag, model, carry, consts, psi, faces, auto))
        config = fd.tiling(N, N, sms, masked, form)
        log("build", (
            f"{label} at {N}x{N}: {config.tiles[0]}x{config.tiles[1]} tiles of {config.tile}, {config.threads} "
            f"threads, {config.shared_bytes} B shared, {config.resident} const planes resident, "
            f"{config.exchange_words * 8} B of exchange words; {fd.max_blocks(device, config)} blocks resident at "
            f"once; holds squares up to {fd.largest_square(sms, masked, form)}^2"
        ))
        # The timed call: the last inputs (auto off, k = 3, with the coastline).
        launch = lambda m=model, c=carry, k_=consts, p=psi, f=faces: fd.fused_dynamics_single(
            m, c, p, k_, DT, N_SUBCYCLES, f)
        k = int(launch()[2][2])
        plain = lambda m=model, c=carry, k_=consts, p=psi, f=faces: cc.fused_dynamics_reference(
            m, c, p, k_, DT, N_SUBCYCLES, f)
        runs = time_in_turns({"form": launch, "headline": closed_launch, "plain": plain},
                             {"form": 20, "headline": 20, "plain": None})
        DEVICE_PROBES[label] = launch
        work = fused_form_work(N, k, form, masked)
        TVB_FORMS[label] = Row(max(errs), sum(runs["form"]) / len(runs["form"]), runs["plain"][0], *work)
        b = bound(*work)
        log("time", (
            f"{label}: form {', '.join(f'{m:.5f}' for m in runs['form'])} ms, headline instance "
            f"{', '.join(f'{m:.5f}' for m in runs['headline'])} ms (in turns, back to back; k = {k}), plain "
            f"{runs['plain'][0]:.3f} ms, bound {b[0]:.5f} ms ({b[1]}) at {N}x{N} on {card}"
        ))

        path = f"fused_{key}"
        model, state, forcing = fused_form_path(device, key)
        if model.schedule(device) != ("fused", "xla"):
            raise AssertionError(f"{path} does not run fused_dynamics: {model.schedule(device)}")
        infos = []

        def recorded(model, carry, tracers, consts, dt, n, faces):
            planes, out, info = fd.fused_dynamics_single(model, carry, tracers, consts, dt, n, faces)
            infos.append((info, planes[0], planes[1]))
            return planes, out

        out = state
        for _ in range(FUSED_FORM_STEPS):
            out = model.step_dynamics(out, forcing, DT, phase=recorded)
        for info, u, v in infos:
            speeds = cc.dg1_sample_cfl(model.transport, u, v)
            if not torch.equal(info[:2], speeds) or int(info[2]) != cc._k_of_speeds(model, speeds, DT):
                raise AssertionError(f"{path}: the card's (speeds, k) {info.tolist()} differ from the host's")
        counts[path] = drive_path(path, model, state, None, forcing, False, n_steps=FUSED_FORM_STEPS)
        if sum(counts[path].values()) != counts[path]["fused_dynamics"]:
            raise AssertionError(f"{path}: kernels besides fused_dynamics launched: {counts[path]}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.run(state, None, forcing, DT, 2, do_thermo=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log("check", (
            f"{path}: k on the card = the host's at each of {FUSED_FORM_STEPS} steps "
            f"({[int(i[2]) for i, _, _ in infos]}); 2 steps under set_sync_debug_mode('error'): no host sync"
        ))

    mesh = RectMesh(N, N, dx=512e3 / N, dy=512e3 / N)
    for degree in (0, 2):
        speeds = fd.ceil_boundary_speeds(DT, mesh, degree)
        got = fd.substeps_on_card(torch.tensor(speeds, device=device), DT, mesh, degree).cpu().numpy()
        plain = fd.substeps_plain(speeds[:, 0], speeds[:, 1], DT, mesh, degree)
        host = np.array([int(cc.substeps_from_speeds(torch.tensor(x), torch.tensor(y), DT, mesh, degree))
                         for x, y in speeds])
        if not (np.array_equal(got, host) and np.array_equal(got, plain)):
            raise AssertionError(f"fused_substeps dG{degree}: {int((got != host).sum())} k differ from the host's")
        log("check", f"fused_substeps dG{degree}: {len(speeds)} speed pairs at every ceil boundary: the card's k = the host's")

    cc.reset_launches()
    result = run_benchmarks.run_config("box_adaptive", device, chunk=10)
    if cc.launches["fused_dynamics"] == 0 or cc.launches["mevp_tiled"] or cc.launches["mevp_stress"]:
        raise AssertionError(f"the battery's box_adaptive does not run fused_dynamics: {dict(cc.launches)}")
    log("time", f"battery box_adaptive on auto (fused_dynamics): {result['ms_per_step']} ms a step, {result['value']:.4e} "
                f"element updates/s on {card}")

    for name, build, form in (
        ("box_adaptive", lambda n: box_model(device, True, n), fd.Form(adaptive=True)),
        ("dG2 TVB", lambda n: bench_model(device, n, degree=2, tvb_m=0.0), fd.Form(degree=2, stages=3, tvb=True)),
    ):
        for n in (N, fd.largest_square(sms, False, form)):
            m, st, f = build(n)
            fns = {
                "fused": lambda: m.step_dynamics(st, f, DT, phase=functools.partial(
                    cc.dynamics_phase, mevp="fused", transport="xla")),
                "tiled": lambda: m.step_dynamics(st, f, DT, phase=functools.partial(
                    cc.dynamics_phase, mevp="pallas-tiled", transport="tiled")),
                "K1 split": lambda: m.step_dynamics(st, f, DT, phase=K1_SPLIT),
            }
            runs = time_in_turns(fns, dict.fromkeys(fns, 5))
            means = {s_: sum(ms) / len(ms) for s_, ms in runs.items()}
            for s_, ms in runs.items():
                report(f"threshold sweep: {name}'s dynamics step on {s_} ({n}x{n})", ms, n * n, card)
            log("time", (
                f"threshold sweep {name} {n}x{n}: fastest {min(means, key=means.get)}; 'auto' runs "
                f"{m.schedule(device)[0]} there"
            ))
            del m, st, f, fns
    return counts, max(errs)


#: BASELINE config 2 (``run_benchmarks.py`` ``bench_advection``): 128^2
#: elements, chunks of 400 unlimited steps.
N2 = 128
CHUNK2 = 400
#: The degree forms' rows of the summary's log: label -> Row.
DEGREE_FORMS = {}


def dg_sizes(degree: int) -> tuple:
    """(K dofs, Q volume points, E points a face) of a degree."""
    b = dg_basis(degree)
    return b.n_dofs, len(b.w_vol), len(b.s_edge)


def stage_cell_ops(degree: int, blend: bool, limit: bool) -> int:
    """float32 operations of one element and tracer's stage, counted from
    csrc/dg1_body.cuh: the volume term (Q traces of 2K - 1, 2 velocity
    products, 2K accumulations), the update of K dofs (4 face sums of E
    points, the metric, rhs, the step and, blended, 3 more), the limiter
    (dG1 11, dG2 21 traces, 20 minima, theta and K - 1 scalings)."""
    k, q, e = dg_sizes(degree)
    volume = q * (2 * k + 1) + 2 * k + (q - 1) * 4 * k
    update = k * (8 * e + 8 + (3 if blend else 0))
    limiter = {0: 0, 1: 11, 2: 21 * (2 * k - 1) + 20 + 4 + (k - 1)}[degree] if limit else 0
    return volume + update + limiter


def stage_work(degree: int, n: int, qv: bool, metric: bool, blend: bool, limit: bool = True) -> tuple:
    """(bytes, float32 operations) of one dg1_rk_stage launch on n elements:
    the planes read once (psi, the base where blended, the velocity: CG1
    nodes or the 2Q + 2E samples, with the limiter 2 face masks, 5 metric
    planes) and written once (out); per element and tracer its stage and
    the 2E face points it owns (a trace, the normal flux, with the limiter
    the mask, on a metric the length); in the CG1 form, once an element,
    its 2E normal velocities (3 each) and 2Q volume velocities (7 each).
    The no-limit instance (config 2) reads no face masks."""
    k, q, e = dg_sizes(degree)
    tracers = cc.STAGE_TRACERS if limit else 1
    faces = 2 * e * (2 * k + (1 if limit else 0) + (1 if metric else 0))
    ops = tracers * (stage_cell_ops(degree, blend, limit) + faces) + (0 if qv else 2 * e * 3 + 2 * q * 7)
    planes = k * tracers * (3 if blend else 2) + (2 * q + 2 * e if qv else 2) + (2 if limit else 0)
    planes += 5 if metric else 0
    return planes * 4 * n, ops * n


def tiled_work(
    degree: int, n: int, k: int, stages: tuple, qv: bool, tracers: int = 3, metric: bool = False,
) -> tuple:
    """(bytes, float32 operations) of k substeps of transport_tiled on n
    elements with the RK ``stages`` ((a, b) each; a = 0: not blended): the
    tracers, the velocity and the 2 face masks read once and the tracers
    written once; per element, substep, stage and tracer its stage and the
    2E face points it owns (a trace, the normal flux, the mask; on a
    ``metric`` mesh the length, and its 5 metric planes read once); in the
    CG1 form the velocity sampled once a launch (2Q bilinear, 2E along a
    face), as the plain version samples it."""
    kk, q, e = dg_sizes(degree)
    planes = 2 * kk * tracers + (2 * q + 2 * e if qv else 2) + 2 + (5 if metric else 0)
    faces = 2 * e * (2 * kk + 1 + (1 if metric else 0))
    cells = sum(stage_cell_ops(degree, a != 0.0, True) + faces for a, _ in stages)
    ops = k * tracers * cells + (0 if qv else 2 * q * 7 + 2 * e * 3)
    return planes * 4 * n, ops * n


def time_form(label: str, probe: str, kernel, plain, work: tuple, reps: int = 200) -> Row:
    """A form's row: the kernel back to back, the plain version, the bound;
    the kernel's device duration is probed last (``probe``: "kernel ...")."""
    row = Row(0.0, time_ms(kernel, reps), time_ms(plain, 5), *work)
    DEGREE_FORMS[label] = row
    DEVICE_PROBES[probe] = kernel
    log("time", (
        f"{label}: kernel {row.ms:.5f} ms, plain {row.plain_ms:.4f} ms, bound "
        f"{bound(*work)[0]:.5f} ms ({bound(*work)[1]}) per call"
    ))
    return row


def check_degree_launches(device) -> dict:
    """dg1_sample_cfl and every form of dg1_rk_stage at dG0 and dG2 (and
    the no-limit instance at dG1), launch by launch against their plain
    versions at 256^2: uniform with random face masks, and the spherical
    window with the coastline (its metric and face masks). Returns the
    largest error per kernel."""
    rng = np.random.default_rng(SEED + 2)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    errs = {"dg1_sample_cfl": 0.0, "dg1_rk_stage": 0.0}
    for degree, spherical in ((0, False), (0, True), (1, False), (2, False), (2, True)):
        mesh = spherical_mesh(N) if spherical else RectMesh(N, N, 2e3, 2e3)
        ocean = synthetic_coastline(N) if spherical else None
        transport = CoupledModel(mesh, degree=degree, n_subcycles=1, ocean_mask=ocean).transport
        where = "metric" if spherical else "uniform"
        u, v = t(rng.normal(0.0, 0.2, (N, N))), t(rng.normal(0.0, 0.2, (N, N)))
        if not spherical:
            speeds = cc.dg1_sample_cfl(transport, u, v)
            ref = cc.dg1_sample_cfl_reference(transport, u, v)
            errs["dg1_sample_cfl"] = max(errs["dg1_sample_cfl"], compare(
                f"dg1_sample_cfl[dG{degree}].speeds", speeds, ref, 0.0))
            k_of = lambda sp: int(cc.substeps_from_speeds(sp[0], sp[1], DT, mesh, degree))
            if k_of(speeds) != k_of(ref):
                raise AssertionError(f"dG{degree}: k differs: {k_of(speeds)} != {k_of(ref)}")
        n_dofs = transport.basis.n_dofs
        coeffs = lambda tracers: t(np.concatenate([
            rng.uniform(0.1, 1.0, (1, tracers, N, N)), rng.normal(0.0, 0.3, (n_dofs - 1, tracers, N, N))
        ]))
        if spherical:
            faces = CoupledModel(mesh, degree=degree, n_subcycles=1, ocean_mask=ocean).face_masks(
                device=device, dtype=torch.float32)
        else:
            faces = tuple(t((rng.uniform(size=(N, N)) > 0.1).astype(np.float32)) for _ in range(2))
        qv = cc.velocity_from_cg(mesh, transport.basis, u, v)
        psi, base = coeffs(3), coeffs(3)
        forms = [] if degree == 1 else [
            (f"{'qv' if q is not None else 'cg1'},{where},{'first' if a == 0 else 'blend'}", q, a, b, True)
            for q in (None, qv) for a, b in ((0.0, 1.0), (0.75, 0.25))
        ]
        forms += [(f"no limit,{where},{'first' if a == 0 else 'blend'}", qv, a, b, False)
                  for a, b in ((0.0, 1.0), (1.0 / 3.0, 2.0 / 3.0))]
        for label, q, a, b, limit in forms:
            p, bs = (psi, base) if limit else (psi[:, :1].contiguous(), base[:, :1].contiguous())
            args = (transport, p, bs, u, v, *(faces if limit else (None, None)), a, b, 300.0)
            errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], compare(
                f"dg1_rk_stage[dG{degree},{label}]", cc.dg1_rk_stage(*args, qv=q, limit=limit),
                cc.dg1_rk_stage_reference(*args, qv=q, limit=limit), TOL_LAUNCH))
        if not spherical and degree != 1:
            time_headline_forms(transport, u, v, psi, base, faces)
    torch.cuda.synchronize()
    return errs


def time_headline_forms(transport, u, v, psi, base, faces) -> None:
    """Times of the forms the headline path runs at 256^2 at the
    transport's degree: dg1_sample_cfl and the blended CG1 stage (a
    function of its own, so that the probes run later keep its inputs)."""
    degree, device = transport.basis.degree, psi.device
    tables, stream, out = cc._dg1_tables(transport), cc._stream(device), torch.empty_like(psi)
    zeros2 = torch.zeros(2, device=device)
    time_form(
        f"dg1_sample_cfl[dG{degree}] at {N}x{N}", f"dg1_sample_cfl {N}^2 dG{degree}",
        lambda: cc._dg1_sample_cfl_(u, v, zeros2, tables, stream),
        lambda: cc.dg1_sample_cfl_reference(transport, u, v),
        (2 * 4 * N * N + 8, (2 * len(transport.basis.w_vol) * 9 + 2 * len(transport.basis.s_edge) * 5) * N * N),
    )
    time_form(
        f"dg1_rk_stage[dG{degree},cg1,blend] at {N}x{N}", f"dg1_rk_stage {N}^2 dG{degree} cg1",
        lambda: cc._dg1_rk_stage_(psi, base, u, v, *faces, None, out, 0.75, 0.25, 300.0, tables, stream),
        lambda: cc.dg1_rk_stage_reference(transport, psi, base, u, v, *faces, 0.75, 0.25, 300.0),
        stage_work(degree, N * N, False, False, True),
    )


def tiled_degree_inputs(n, degree, device, seed, k=1):
    """A transport at ``degree`` on a closed n^2 mesh of 4 km elements,
    seeded (K, 3, n, n) tracers, CG1 velocity and random face masks."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    transport = CoupledModel(RectMesh(n, n, 4e3, 4e3), degree=degree, n_subcycles=1).transport
    n_dofs = transport.basis.n_dofs
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, n, n)), rng.normal(0.0, 0.3, (n_dofs - 1, 3, n, n))]))
    u, v = t(rng.normal(0.0, 0.3, (n, n))), t(rng.normal(0.0, 0.3, (n, n)))
    faces = tuple(t((rng.uniform(size=(n, n)) > 0.1).astype(np.float32)) for _ in range(2))
    return transport, psi, u, v, faces


def check_degree_transport(device) -> dict:
    """transport_tiled at dG2 with rk3 and at dG0 with rk1 at 1024^2 (k = 1
    and 4: two launches) against the plain version, and the staged rk3
    transport (one dg1_rk_stage a stage) against it on the same inputs
    (expected 0); the spmd form on a 2 x 2 grid of 256^2 rank blocks
    against the plain transport of the whole grid and the single-device
    transport_tiled (expected 0)."""
    errs = {"transport_tiled": 0.0, "dg1_rk_stage": 0.0}
    for degree, k in ((2, 1), (2, 4), (0, 3)):
        transport, psi, u, v, faces = tiled_degree_inputs(N4, degree, device, SEED + 3)
        scheme = transport.scheme
        args = (transport, psi, u, v, DT / k, k, faces)
        cc.reset_launches()
        got = tt.transport_substeps_tiled(*args)
        launches = cc.launches["transport_tiled"]
        errs["transport_tiled"] = max(errs["transport_tiled"], compare(
            f"transport_tiled[dG{degree},{scheme}] k={k} at {N4}x{N4} ({launches} launches)",
            got, cc.transport_substeps_reference(*args), TOL_LAUNCH))
        if degree == 2:
            same_schedule(f"staged {scheme} at dG2, k={k}", cc.transport_substeps(*args), got, "transport_tiled")
        if k == 1:
            halo = tt.halo_for(1, len(tt._STAGES[scheme]))
            group = tt.window_tracers(halo, False, 3, N4 * N4, psi.shape[0], len(tt._STAGES[scheme]))
            config = tt.launch_config(halo, False, group, N4 * N4, psi.shape[0], len(tt._STAGES[scheme]))
            log("check", f"transport_tiled[dG{degree},{scheme}] launch: halo {halo}, {group} tracer(s) a window, {config}")
            time_form(
                f"transport_tiled[dG{degree},{scheme}] k=1 at {N4}x{N4}",
                f"transport_tiled {N4}^2 dG{degree} {scheme}",
                lambda a=args: tt.transport_substeps_tiled(*a), lambda a=args: cc.transport_substeps_reference(*a),
                tiled_work(degree, N4 * N4, 1, tt._STAGES[scheme], False), reps=50,
            )
        if degree == 2 and k == 1:
            # A window of one tracer at the full tile (shipped) against one
            # of all three at the narrower tile that fits, in turns.
            narrow = tt.launch_config(halo, False, 3, N4 * N4, psi.shape[0], len(tt._STAGES[scheme]))
            same_schedule("transport_tiled[dG2,rk3] windows of 3 tracers", tt.transport_substeps_tiled(*args, group=3),
                          got, "windows of 1")
            runs = time_in_turns(
                {"1": lambda a=args: tt.transport_substeps_tiled(*a, group=1),
                 "3": lambda a=args: tt.transport_substeps_tiled(*a, group=3)}, {"1": 50, "3": 50})
            log("time", (
                f"transport_tiled[dG2,rk3] k=1 at {N4}x{N4}: windows of 1 tracer, tile {config.tile}: "
                f"{', '.join(f'{m:.5f}' for m in runs['1'])} ms; of 3 tracers, tile {narrow.tile}: "
                f"{', '.join(f'{m:.5f}' for m in runs['3'])} ms (in turns, back to back)"
            ))
    # The qv form at dG2 (the HO path's): the CG2 samples at 3 x 3 points.
    transport, psi, _, _, faces = tiled_degree_inputs(N, 2, device, SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    cg2 = lambda: mevp_ho.HOField(*(torch.tensor(rng.normal(0.0, 0.3, (N, N)), device=device, dtype=torch.float32) for _ in range(4)))
    qv = mevp_ho.ho_velocity_to_quad(transport.mesh, transport.basis, cg2(), cg2())
    args = (transport, psi, None, None, DT / 2, 2, faces)
    got = tt.transport_substeps_tiled(*args, qv=qv)
    errs["transport_tiled"] = max(errs["transport_tiled"], compare(
        "transport_tiled[dG2,rk3,qv] k=2", got, cc.transport_substeps_reference(*args, qv=qv), TOL_LAUNCH))
    same_schedule("staged rk3 qv at dG2, k=2", cc.transport_substeps(*args, qv=qv), got, "transport_tiled")

    # The spmd form on a 2 x 2 rank grid of the one card.
    n = 2 * N
    for degree, k in ((2, 4), (0, 3)):
        transport, psi, u, v, faces = tiled_degree_inputs(n, degree, device, SEED + 5)
        model, sharded = build_sharded_coupled_model(RectMesh(n, n, 4e3, 4e3), RankGrid(*RANKS, device), degree=degree)
        grid = sharded.grid
        parts = [grid.split(x) for x in (u, v, *faces)]
        tracer_parts = grid.split(psi)

        def body(rank, k=k):
            m, r = sharded.models[rank.rank], rank.rank
            velocity_w = tt.widen_velocity(m, parts[0][r], parts[1][r])
            return tt.transport_substeps_tiled_spmd(m, tracer_parts[r], velocity_w, DT / k, k, (parts[2][r], parts[3][r]))

        cc.reset_launches()
        got = grid.gather(run_ranks(grid.ring, body), device)
        torch.cuda.synchronize()
        H = tt.transport_tiled_spmd_config(model)[0]
        log("check", f"spmd transport_tiled[dG{degree},{model.transport.scheme}]: H = {H}, {cc.launches['transport_tiled']} launches on 4 ranks")
        args = (transport, psi, u, v, DT / k, k, faces)
        errs["transport_tiled"] = max(errs["transport_tiled"], compare(
            f"spmd transport_tiled[dG{degree},{transport.scheme}] k={k} on 2x2 ranks of {N}^2",
            got, cc.transport_substeps_reference(*args), TOL_LAUNCH))
        same_schedule(f"spmd dG{degree} k={k}", got, tt.transport_substeps_tiled(*args), "transport_tiled on one domain")
    return errs


def check_advection(device) -> tuple:
    """BASELINE config 2 at 128^2, dG1 and dG2: 400 steps on the kernels
    (dg1_rk_stage's no-limit instance, one launch per stage) against the
    plain path on the card; one full revolution with its L2 error and mass
    drift; element updates/s by CUDA events. Returns (counts by path,
    largest error)."""
    from nextsimdg_tpu_torch.benchmarks.run_benchmarks import advection_setup

    counts, errors, err = {}, {}, 0.0
    for degree in (1, 2):
        transport, vel, psi0, dt = advection_setup(N2, degree, device)
        stages = len(cc._RK_STAGES[transport.scheme])
        cc.reset_launches()
        got = transport.run(psi0, vel, dt, CHUNK2)
        torch.cuda.synchronize()
        counts[f"advection_dg{degree}"] = dict(cc.launches)
        if cc.launches["dg1_rk_stage"] != CHUNK2 * stages:
            raise AssertionError(f"config 2 dG{degree}: {cc.launches['dg1_rk_stage']} dg1_rk_stage launches")
        err = max(err, compare(
            f"advection dG{degree}: {CHUNK2} steps", got,
            cc.transport_run_reference(transport, psi0, vel, dt, CHUNK2), TOL_LAUNCH))
        steps = int(round(1.0 / dt))
        back = transport.run(psi0, vel, 1.0 / steps, steps)
        l2 = float(torch.sqrt(torch.mean((back[0].double() - psi0[0].double()) ** 2)))
        mass0 = float(transport.total_mass(psi0.double()))
        drift = abs(float(transport.total_mass(back.double())) - mass0)
        errors[degree] = l2
        ms = time_ms(lambda: transport.run(psi0, vel, dt, CHUNK2), 3)
        log("slice", (
            f"advection dG{degree} ({transport.scheme}): one revolution of {steps} steps, L2 error "
            f"{l2:.6e} against the projected start, mass drift {drift:.3e} of {mass0:.6e}"
        ))
        log("time", (
            f"advection dG{degree}: {ms:.3f} ms per chunk of {CHUNK2} steps, "
            f"{N2 * N2 * CHUNK2 / (ms / 1e3):.4e} element updates/s (CUDA events)"
        ))
        time_no_limit_form(transport, vel, psi0, dt)
    if not errors[2] < 0.5 * errors[1]:
        raise AssertionError(f"dG2's revolution error {errors[2]:.3e} is not below half of dG1's {errors[1]:.3e}")
    log("check", f"advection: dG2's L2 error {errors[2]:.3e} < 0.5 x dG1's {errors[1]:.3e} ok")
    return counts, err


def time_no_limit_form(transport, vel, psi0, dt) -> None:
    """Times of config 2's launch, dg1_rk_stage's no-limit instance (its
    first stage), at the transport's degree."""
    degree, device = transport.basis.degree, psi0.device
    p, out = psi0[:, None].contiguous(), torch.empty((psi0.shape[0], 1, N2, N2), device=device)
    qv_ptrs = cc._dg1_qv(vel, (N2, N2), device, degree)
    tables, stream = cc._dg1_tables(transport), cc._stream(device)
    time_form(
        f"dg1_rk_stage[dG{degree},no limit,qv] at {N2}x{N2}", f"dg1_rk_stage {N2}^2 dG{degree} no limit",
        lambda keep=vel: cc._dg1_rk_stage_(p, p, None, None, None, None, None, out, 0.0, 1.0, dt, tables,
                                           stream, qv=qv_ptrs, limit=False),
        lambda: cc.dg1_rk_stage_reference(transport, p, p, None, None, None, None, 0.0, 1.0, dt, qv=vel, limit=False),
        stage_work(degree, N2 * N2, True, False, False, limit=False),
    )


def check_degree_steps(device, card: str) -> dict:
    """The coupled step at dG0 and dG2: the headline (256^2, dynamics only,
    on fused_dynamics and on K1's split schedule, pinned) and config 4 (1024^2, "auto": mevp_tiled and
    transport_tiled with rk3 at dG2), the HO step at dG2 (256^2, ho_single
    and the qv form of transport_tiled), and the 2 x 2 rank grid's step at
    dG2 (512^2: the blocked mEVP and the spmd transport_tiled with rk3):
    one step against the plain path (the rank grid's against the
    single-device step, expected 0), 20 steps bounded with every kernel of
    the path launched (the rank grid's one step), ms per step by CUDA
    events. Returns the counts by path."""
    counts = {}
    for degree in (0, 2):
        model, state, forcing = bench_model(device, degree=degree)
        if model.schedule(device) != ("fused", "xla"):
            raise AssertionError(f"headline_dg{degree} does not run fused_dynamics: {model.schedule(device)}")
        ref = model.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference)
        ms = {}
        for path, phase in ((f"headline_dg{degree}", None), (f"headline_dg{degree}_k1", K1_SPLIT)):
            got = path_step(model, state, None, forcing, False, phase)
            for name in ("hice", "cice", "hsnow"):
                compare(f"{path}.step.{name}", getattr(got, name), getattr(ref, name), TOL_STEP_TRACER)
            for name in VELOCITY:
                compare(f"{path}.step.velocity.{name}", getattr(got.velocity, name), getattr(ref.velocity, name),
                        TOL_STEP_MEVP)
            counts[path] = drive_path(path, model, state, None, forcing, False, phase=phase)
            ms[path] = time_ms(lambda: path_step(model, state, None, forcing, False, phase), 20)
        log("time", (
            f"headline_dg{degree}: {ms[f'headline_dg{degree}']:.3f} ms/step on fused_dynamics, "
            f"{ms[f'headline_dg{degree}_k1']:.3f} on K1's split schedule ({N}x{N}, dG{degree}), "
            f"{N * N / (ms[f'headline_dg{degree}'] / 1e3):.4e} element updates/s, f32 on {card}"
        ))

        model, state, phys, dyn = config4_model(device, degree=degree)
        path = f"config4_dg{degree}"
        schedule = model.schedule(device)
        if schedule != ("pallas-tiled", "tiled"):
            raise AssertionError(f"{path} does not run the tiled kernels: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)
        ms = time_ms(lambda: model.step(state, phys, dyn, DT), 10)
        log("time", f"{path}: {ms:.3f} ms/step ({N4}x{N4}, {schedule}, dG{degree}, {model.transport.scheme}), {N4 * N4 / (ms / 1e3):.4e} element updates/s, f32 on {card}")

    model, state, phys, dyn = ho_model(device, N, degree=2, mevp_backend="pallas")
    path = "ho_coupled_256_dg2"
    schedule = model.schedule(device)
    if not model.is_high_order or schedule != ("single", "tiled"):
        raise AssertionError(f"{path} does not run ho_single and transport_tiled: {schedule}")
    compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
    counts[path] = drive_path(path, model, state, phys, dyn, True)

    n = 2 * N
    model, sharded = sharded_model(device, n, degree=2)
    path = "multihost_dg2"
    single, state, phys, dyn = coupled_model(device, RectMesh(n, n, dx=2e3, dy=2e3), None, 2)
    log("slice", f"{path}: {n}x{n} on 2x2 ranks, schedule {(model.mevp_schedule(), model.transport_schedule())}, {model.transport.scheme}")
    cc.reset_launches()
    got = sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts[path] = dict(cc.launches)
    log("slice", f"{path}: 1 step, launches: {counts[path]}")
    compare_sharded_step(path, got, single.step(state, phys, dyn, DT), tol_same=True)
    check_bounded(f"{path}: 1 step", got, state)
    missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
    if missing or counts[path]["dg1_rk_stage"]:
        raise AssertionError(f"{path}: kernels not launched {missing}, or the staged transport ran")
    return counts


def check_degrees(device, card: str) -> tuple:
    """Phase: dG0 and dG2, rk3 on transport_tiled and config 2 (the degree
    forms of dg1_sample_cfl, dg1_rk_stage and transport_tiled, each against
    its plain version; the paths that run them). Returns (counts by path,
    largest error per kernel)."""
    errs = check_degree_launches(device)
    for kernel, err in check_degree_transport(device).items():
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    counts, err = check_advection(device)
    errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], err)
    counts.update(check_degree_steps(device, card))
    return counts, errs


#: The momentum forms of MEVPParams that check_momentum_forms holds each CG1
#: kernel to: the A-weighted stresses, the adaptive alpha (its floor lowered
#: to 20, so that the stability bound sets alpha on the calm nodes of the
#: seeded inputs) and both.
MEVP_FORMS = {
    "weighted": MEVPParams(a_weighted_stress=True),
    "adaptive": MEVPParams(adaptive_alpha=True, alpha_min=20.0),
    "both": MEVPParams(a_weighted_stress=True, adaptive_alpha=True, alpha_min=20.0),
}


def form_inputs(nx, ny, device, seed, params, spherical=False):
    """``tiled_inputs`` in a momentum form, with partial cover: A below 0.06
    on the first quarter of the rows (some nodes below a_dyn_min), and the
    last half of the rows calm (velocities 1e-4 of the rest: a small strain
    rate, a large zeta and an adaptive alpha above its floor). Returns
    (solver, carry, consts)."""
    model, carry, _, _, _ = tiled_inputs(nx, ny, device, seed, spherical)
    mesh, ocean = model.mesh, model.ocean_mask
    model = CoupledModel(mesh, n_subcycles=N_SUBCYCLES, ocean_mask=ocean, mevp_params=params)
    rng = np.random.default_rng(seed + 100)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    a = rng.uniform(0.3, 1.0, (nx, ny))
    a[: nx // 4] = rng.uniform(0.0, 0.06, (nx // 4, ny))
    calm = t(np.where(np.arange(nx)[:, None] < nx // 2, 1.0, 1e-4) * np.ones((nx, ny)))
    carry = (carry[0] * calm, carry[1] * calm, *carry[2:])
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(6.0, 2.0, (nx, ny))), v_atm=t(rng.normal(3.0, 2.0, (nx, ny))),
        u_ocean=t(rng.normal(0.0, 0.05, (nx, ny))), v_ocean=t(rng.normal(0.0, 0.05, (nx, ny))),
    )
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), t(rng.uniform(0.2, 2.0, (nx, ny))), t(a), forcing, mask, DT)
    return model.mevp, carry, consts


def form_coverage(tag: str, solver, carry, consts) -> None:
    """Logs (and requires) what makes the forms' checks bite: nodes below
    a_dyn_min in the weighted form, an alpha above its floor in the adaptive
    one."""
    p = solver.params
    notes = []
    if p.a_weighted_stress:
        a_node = consts["a_node"]
        low = int(((a_node > 0) & (a_node < p.a_dyn_min)).sum())
        notes.append(f"a_node in [{float(a_node.min()):.3f}, {float(a_node.max()):.3f}], {low} nodes below a_dyn_min")
        if not low or float(a_node.max()) < 0.5:
            raise AssertionError(f"{tag}: the cover is not partial")
    if p.adaptive_alpha:
        beta = solver.stress_update(carry, consts)[5]
        above = int((beta > p.alpha_min).sum())
        notes.append(f"alpha in [{float(beta.min()):.1f}, {float(beta.max()):.1f}], above its floor at {above} nodes")
        if not above:
            raise AssertionError(f"{tag}: the adaptive alpha never leaves its floor")
    log("check", f"{tag}: {'; '.join(notes)}")


def form_row(label: str, err: float, kernel, plain, work: tuple, reps: int = 200, plain_reps: int = 20) -> None:
    """A form's Row: back-to-back ms of the kernel and its plain version,
    its bytes and operations; its device duration is probed last."""
    MOMENTUM_FORMS[label] = Row(err, time_ms(kernel, reps), time_ms(plain, plain_reps), *work)
    DEVICE_PROBES[label] = kernel


def check_form_launches(device) -> dict:
    """Each CG1 mEVP kernel in each momentum form against its plain version
    launch by launch, at its path's shape with partial cover: mevp_stress
    and mevp_velocity at 256^2 (uniform), mevp_tiled at 1024^2 (uniform,
    one launch of one subcycle and of the shipped 8; 100 subcycles against
    plain and K1's schedule), mevp_single at 1024^2 spherical with the
    coastline (one launch of 1 subcycle and of 100; against K1's schedule and
    mevp_tiled). Returns the largest error per kernel; each form's timing
    and bound are logged last."""
    errs = dict.fromkeys(("mevp_stress", "mevp_velocity", "mevp_tiled", "mevp_single"), 0.0)

    def held(kernel, tag, got, ref, tol):
        for name, g, r in zip(("s11", "s22", "s12", "c_w", "inv_drag", "beta"), got, ref):
            errs[kernel] = max(errs[kernel], compare(f"{tag} {name}", g, r, tol))

    n = N * N
    for form, params in MEVP_FORMS.items():
        solver, carry, consts = form_inputs(N, N, device, SEED + 20, params)
        form_coverage(f"mevp_stress {N}x{N} {form}", solver, carry, consts)
        ref = solver.stress_update(carry, consts)
        got = cc.mevp_stress(solver, carry, consts)
        held("mevp_stress", f"mevp_stress {N}x{N} {form}", got, ref, TOL_LAUNCH)
        carry_v = (carry[0], carry[1], *ref[:3])
        nodes = (ref[3], ref[4], DT, *ref[5:])
        got_uv = cc.mevp_velocity(solver, carry_v, consts, *nodes)
        ref_uv = solver.velocity_update(carry_v, consts, *nodes)
        for name, g, r in zip("uv", got_uv, ref_uv):
            errs["mevp_velocity"] = max(errs["mevp_velocity"], compare(f"mevp_velocity {N}x{N} {form} {name}", g, r, TOL_LAUNCH))
        # Per launch, in place, as K1's schedule launches them.
        planes = tuple(x.clone() for x in carry)
        c_w, inv_drag = torch.empty_like(carry[0]), torch.empty_like(carry[0])
        beta = torch.empty_like(carry[0]) if params.adaptive_alpha else None
        scalars, stream, ptrs = cc._mevp_scalars(solver, DT), cc._stream(device), cc._mevp_consts(consts)
        weighted, adaptive = int(params.a_weighted_stress), int(params.adaptive_alpha)
        form_row(
            f"mevp_stress {N}^2 {form}", errs["mevp_stress"],
            lambda planes=planes, c_w=c_w, inv_drag=inv_drag, beta=beta, scalars=scalars, ptrs=ptrs, keep=consts:
            cc._mevp_half_("mevp_stress", planes, ptrs, c_w, inv_drag, scalars, stream, beta),
            lambda solver=solver, carry=carry, consts=consts: solver.stress_update(carry, consts),
            ((15 + weighted + adaptive) * 4 * n, OPS[f"stress_{form}"] * n),
        )
        form_row(
            f"mevp_velocity {N}^2 {form}", errs["mevp_velocity"],
            lambda planes=planes, c_w=c_w, inv_drag=inv_drag, beta=beta, scalars=scalars, ptrs=ptrs, keep=consts:
            cc._mevp_half_("mevp_velocity", planes, ptrs, c_w, inv_drag, scalars, stream, beta),
            lambda solver=solver, carry_v=carry_v, consts=consts, nodes=nodes:
            solver.velocity_update(carry_v, consts, *nodes),
            ((14 + adaptive) * 4 * n, OPS["velocity"] * n),
        )

    n = N4 * N4
    for form, params in MEVP_FORMS.items():
        solver, carry, consts = form_inputs(N4, N4, device, SEED + 21, params)
        form_coverage(f"mevp_tiled {N4}x{N4} {form}", solver, carry, consts)
        for n_sub, tol in ((1, TOL_LAUNCH), (TILED_SUBCYCLES, TOL_STEP_MEVP), (N_SUBCYCLES, TOL_STEP_MEVP)):
            got = mt.mevp_subcycles_tiled(solver, carry, consts, DT, n_sub)
            ref = mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, n_sub)
            k1 = cc.mevp_subcycles(solver, carry, consts, DT, n_sub)
            for name, g, r, q in zip(VELOCITY, got, ref, k1):
                tag = f"mevp_tiled {N4}x{N4} {form} N={n_sub} {name}"
                errs["mevp_tiled"] = max(errs["mevp_tiled"], compare(tag, g, r, tol))
                same_schedule(tag, g, q)
        weighted = int(params.a_weighted_stress)
        form_row(
            f"mevp_tiled {N4}^2 {form}", errs["mevp_tiled"],
            lambda solver=solver, carry=carry, consts=consts: mt.mevp_subcycles_tiled(solver, carry, consts, DT, TILED_SUBCYCLES),
            lambda solver=solver, carry=carry, consts=consts: mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, TILED_SUBCYCLES),
            ((5 + 7 + weighted + 5) * 4 * n, TILED_SUBCYCLES * (OPS[f"stress_{form}"] + OPS["velocity"]) * n),
            reps=50, plain_reps=3,
        )

    for form, params in MEVP_FORMS.items():
        solver, carry, consts = form_inputs(N4, N4, device, SEED + 22, params, spherical=True)
        form_coverage(f"mevp_single {N4}x{N4} spherical {form}", solver, carry, consts)
        for n_sub, tol in ((1, TOL_LAUNCH), (N_SUBCYCLES, TOL_STEP_MEVP)):
            got = single.mevp_subcycles_single(solver, carry, consts, DT, n_sub)
            ref = single.mevp_single_reference(solver, carry, consts, DT, n_sub)
            k1 = cc.mevp_subcycles(solver, carry, consts, DT, n_sub)
            tiled = mt.mevp_subcycles_tiled(solver, carry, consts, DT, n_sub)
            for name, g, r, q, w in zip(VELOCITY, got, ref, k1, tiled):
                tag = f"mevp_single {N4}x{N4} spherical, coastline {form} N={n_sub} {name}"
                errs["mevp_single"] = max(errs["mevp_single"], compare(tag, g, r, tol))
                same_schedule(tag, g, q)
                same_schedule(tag, g, w, "mevp_tiled")
        weighted = int(params.a_weighted_stress)
        config = single.tiling(N4, N4, single.sm_count(device))
        log("check", (
            f"mevp_single {N4}x{N4} spherical {form}: const planes in shared memory "
            f"{config.resident(True, bool(weighted))}"
        ))
        form_row(
            f"mevp_single {N4}^2 spherical {form}", errs["mevp_single"],
            lambda solver=solver, carry=carry, consts=consts: single.mevp_subcycles_single(solver, carry, consts, DT, N_SUBCYCLES),
            lambda solver=solver, carry=carry, consts=consts: single.mevp_single_reference(solver, carry, consts, DT, N_SUBCYCLES),
            ((5 + 12 + weighted + 5) * 4 * n, N_SUBCYCLES * (OPS[f"stress_{form}"] + OPS["velocity_metric"]) * n),
            reps=20, plain_reps=1,
        )
    torch.cuda.synchronize()
    return errs


def free_drift_model(device):
    """The headline configuration (256^2 box) with Nextsim::FreeDrift
    selected through the registry (reset after the build)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::FreeDrift")
    try:
        return bench_model(device)
    finally:
        loader.reset()


def box_model(device, adaptive: bool, n: int = N, **backends):
    """The battery's ``box`` (``adaptive=False``) or ``box_adaptive``:
    ``bench_box`` builds a 256^2 box of 2 km elements (n^2 of 512 km / n),
    wind (8, 2), on "auto"; (model, state, forcing)."""
    mesh = RectMesh(n, n, dx=512e3 / n, dy=512e3 / n)
    model = CoupledModel(
        mesh, degree=1, n_subcycles=N_SUBCYCLES, mevp_params=MEVPParams(adaptive_alpha=adaptive), **backends,
    )
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device=device, dtype=torch.float32)
    full = lambda value: torch.full((n, n), value, device=device, dtype=torch.float32)
    return model, state, DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))


def check_form_paths(device) -> dict:
    """The paths of the momentum forms: one step against the plain path on
    the card, then 20 steps from zeroed launch counts (finite, bounded,
    every kernel of the path launched): box_adaptive on "auto"
    (fused_dynamics) and on K1's split schedule (pinned), coupled_1m_aweighted on "auto", the spherical
    coastline step A-weighted on mevp_single, free drift at 256^2; and the
    A-weighted 2 x 2 rank grid's step (512^2, blocked) against the
    single-device step (expected 0). Returns the counts by path."""
    counts = {}
    for path, backends in (("box_adaptive", {}), ("box_adaptive_k1", {"mevp_backend": "pallas"})):
        model, state, forcing = box_model(device, True, **backends)
        schedule = model.schedule(device)
        phase = K1_SPLIT if path in K1_PINNED else None
        log("slice", f"{path}: {N}x{N}, adaptive alpha, schedule {schedule}{', K1 pinned' if phase else ''}")
        if schedule != ("fused", "xla"):
            raise AssertionError(f"{path} does not run fused_dynamics: {schedule}")
        got = path_step(model, state, None, forcing, False, phase)
        ref = model.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference)
        for name, g, r in leaves(got, ref):
            compare(f"{path}.step.{name}", g, r, TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)
        counts[path] = drive_path(path, model, state, None, forcing, False, phase=phase)

    weighted = MEVPParams(a_weighted_stress=True)
    for path, mesh, ocean, backends, expected in (
        ("coupled_1m_aweighted", RectMesh(N4, N4, dx=4e3, dy=4e3), None, {}, ("pallas-tiled", "tiled")),
        ("spherical_aweighted", spherical_mesh(N4), synthetic_coastline(N4), {"mevp_backend": "pallas"}, ("single", "tiled")),
    ):
        model, state, phys, dyn = coupled_model(device, mesh, ocean, mevp_params=weighted, **backends)
        schedule = model.schedule(device)
        log("slice", f"{path}: {N4}x{N4}, A-weighted, schedule {schedule}")
        if schedule != expected:
            raise AssertionError(f"{path} does not run {expected}: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)

    model, state, forcing = free_drift_model(device)
    schedule = model.schedule(device)
    log("slice", f"free_drift: {N}x{N}, Nextsim::FreeDrift, schedule {schedule}")
    if not model.is_free_drift or schedule != ("free-drift", "tiled"):
        raise AssertionError(f"free_drift does not run the free-drift step and transport_tiled: {schedule}")
    got = model.step(state, None, forcing, DT, do_thermo=False)
    ref = model.step_dynamics(state, forcing, DT, phase=cc.fused_dynamics_reference)
    for name, g, r in leaves(got, ref):
        compare(f"free_drift.step.{name}", g, r, TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)
    counts["free_drift"] = drive_path("free_drift", model, state, None, forcing, False)

    n = 2 * N
    model, sharded = sharded_model(device, n, mevp_params=weighted)
    path = "multihost_aweighted"
    single_model, state, phys, dyn = coupled_model(device, RectMesh(n, n, dx=2e3, dy=2e3), None, mevp_params=weighted)
    log("slice", f"{path}: {n}x{n} on 2x2 ranks, A-weighted, schedule {(model.mevp_schedule(), model.transport_schedule())}")
    cc.reset_launches()
    got = sharded(state, phys, dyn, DT)
    torch.cuda.synchronize()
    counts[path] = dict(cc.launches)
    log("slice", f"{path}: 1 step, launches: {counts[path]}")
    compare_sharded_step(path, got, single_model.step(state, phys, dyn, DT), tol_same=True)
    check_bounded(f"{path}: 1 step", got, state)
    missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels not launched {missing}")
    return counts


def check_momentum_forms(device) -> tuple:
    """Phase: the A-weighted and adaptive momentum forms of the four CG1
    mEVP kernels (launch by launch) and the paths that run them, free drift
    included. Returns (counts by path, largest error per kernel)."""
    errs = check_form_launches(device)
    return check_form_paths(device), errs


def time_momentum_forms(device, card: str) -> None:
    """ms per step of box_adaptive beside box, and of coupled_1m_aweighted
    beside coupled_1m, on "auto", in turns."""
    box, state_b, forcing_b = box_model(device, False)
    box_a = box_model(device, True)[0]
    runs = time_in_turns(
        {
            "box": lambda: box.step(state_b, None, forcing_b, DT, do_thermo=False),
            "box_adaptive": lambda: box_a.step(state_b, None, forcing_b, DT, do_thermo=False),
        },
        {"box": 10, "box_adaptive": 10},
    )
    for name, ms in runs.items():
        report(f"{name} step ({N}x{N}, {N_SUBCYCLES} subcycles, auto: {box.schedule(device)[0]})", ms, N * N, card)
    model, state, phys, dyn = config4_model(device)
    model_w = coupled_model(device, RectMesh(N4, N4, dx=4e3, dy=4e3), None, mevp_params=MEVPParams(a_weighted_stress=True))[0]
    runs = time_in_turns(
        {
            "coupled_1m": lambda: model.step(state, phys, dyn, DT),
            "coupled_1m_aweighted": lambda: model_w.step(state, phys, dyn, DT),
        },
        {"coupled_1m": 10, "coupled_1m_aweighted": 10},
    )
    for name, ms in runs.items():
        report(f"{name} coupled step ({N4}x{N4}, auto: mevp_tiled)", ms, N4 * N4, card)
    profile(f"coupled_1m_aweighted coupled step ({N4}x{N4})", lambda: model_w.step(state, phys, dyn, DT))


def report(what: str, ms: list, elements: int, card: str) -> float:
    mean = sum(ms) / len(ms)
    log("time", (
        f"{what}: {mean:.3f} ms/step (runs {', '.join(f'{m:.3f}' for m in ms)}), "
        f"{elements / (mean / 1e3):.4e} element updates/s, f32 on {card}"
    ))
    return mean


def time_in_turns(fns: dict, reps: dict) -> dict:
    """ms per call of each function, run in turns: a b ... b a, each warmed
    up in its first turn. A function whose reps is None (a plain path,
    100-1000x slower than the kernels, which the checks ran before at the
    same shapes) runs once after the turns, with no warm-up."""
    turns = [name for name in fns if reps[name]]
    runs = {name: [] for name in fns}
    for i, name in enumerate(turns + turns[::-1]):
        runs[name].append(time_ms(fns[name], reps[name], warm=i < len(turns)))
    for name in fns:
        if not reps[name]:
            runs[name].append(time_ms(fns[name], 1, warm=False))
    return runs


def profile(tag: str, step, n_steps: int = 5, watch: str = None) -> None:
    """Device busy time per step and the device's idle share over n_steps
    back-to-back steps under torch.profiler, and the kernels that took the
    most device time (and the kernels whose names hold ``watch``: their ms
    a launch). Busy time sums the CUDA events' own device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    events = [
        e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not events:
        log("time", f"profile {tag}: wall {wall:.3f} ms/step (profiled); the profiler recorded no device event")
        return
    per_step = lambda e: e.self_device_time_total / 1e3 / n_steps
    busy = sum(per_step(e) for e in events)
    top = sorted(events, key=per_step, reverse=True)[:5]
    log("time", (
        f"profile {tag}: wall {wall:.3f} ms/step (profiled), device busy {busy:.3f} ms/step, "
        f"idle share {1.0 - busy / wall:.3f}, {sum(e.count for e in events) / n_steps:.0f} "
        f"device activities/step; top: " + "; ".join(
            f"{e.key[:48]} {per_step(e):.3f} ms x{e.count / n_steps:g}" for e in top
        )
    ))
    for e in (e for e in events if watch and watch in e.key):
        log("time", (
            f"profile {tag}: {e.key[:64]} {per_step(e):.4f} ms/step in {e.count / n_steps:g} launches, "
            f"{e.self_device_time_total / 1e3 / e.count:.5f} ms a launch"
        ))


def time_paths(device, card: str) -> None:
    """Phase 5: ms per step of the paths and schedules, in turns."""
    model, state, forcing = bench_model(device)
    runs = time_in_turns(
        {
            "kernel": lambda: model.step(state, None, forcing, DT, do_thermo=False),
            "plain": lambda: model.step_dynamics(
                state, forcing, DT, phase=cc.fused_dynamics_reference
            ),
        },
        {"kernel": 10, "plain": None},
    )
    for name, ms in runs.items():
        report(f"headline {name} path ({N}x{N}, {N_SUBCYCLES} subcycles)", ms, N * N, card)

    # The config-4 coupled step: tiled (auto), K1's schedule, plain; physics alone.
    model, state, phys, dyn = config4_model(device)
    model_k1 = config4_model(device, mevp_backend="pallas")[0]
    runs = time_in_turns(
        {
            "tiled": lambda: model.step(state, phys, dyn, DT),
            "K1": lambda: model_k1.step(state, phys, dyn, DT),
            "plain": lambda: plain_step(model, state, phys, dyn),
        },
        {"tiled": 10, "K1": 10, "plain": None},
    )
    for name, ms in runs.items():
        report(f"config4 coupled step, {name} path ({N4}x{N4})", ms, N4 * N4, card)
    ms = [time_ms(lambda: model.step_thermo(state, phys, DT), 10) for _ in range(2)]
    report(f"config4 physics alone ({N4}x{N4})", ms, N4 * N4, card)
    profile(f"config4 coupled step, tiled path ({N4}x{N4})", lambda: model.step(state, phys, dyn, DT))

    # The spherical coupled step: mevp_single ("pallas"), mevp_tiled, plain.
    model, state, phys, dyn = spherical_model(device, mevp_backend="pallas")
    model_tiled = spherical_model(device, mevp_backend="pallas-tiled")[0]
    runs = time_in_turns(
        {
            "mevp_single": lambda: model.step(state, phys, dyn, DT),
            "mevp_tiled": lambda: model_tiled.step(state, phys, dyn, DT),
            "plain": lambda: plain_step(model, state, phys, dyn),
        },
        {"mevp_single": 10, "mevp_tiled": 10, "plain": None},
    )
    for name, ms in runs.items():
        report(f"spherical coupled step, {name} path ({N4}x{N4})", ms, N4 * N4, card)
    profile(f"spherical coupled step on mevp_single ({N4}x{N4})", lambda: model.step(state, phys, dyn, DT))
    profile(f"spherical coupled step on mevp_tiled ({N4}x{N4})", lambda: model_tiled.step(state, phys, dyn, DT))


def time_ho(device, card: str) -> None:
    """Phase 5, HO part: the HO paths' step on their kernels and on the
    plain path, and a profile of ho_coupled_1m."""
    for path, n, backend, transport in (
        ("ho_coupled_1m", N4, "auto", "auto"), ("ho_coupled_256", N, "pallas", "auto"),
        ("ho_coupled_256_staged", N, "pallas", "xla"),
    ):
        model, state, phys, dyn = ho_model(device, n, mevp_backend=backend, transport_backend=transport)
        runs = time_in_turns(
            {
                "kernel": lambda: model.step(state, phys, dyn, DT),
                "plain": lambda: plain_step(model, state, phys, dyn),
            },
            {"kernel": 10, "plain": None},
        )
        for name, ms in runs.items():
            schedule = model.schedule(device)
            report(f"{path} coupled step, {name} path ({n}x{n}, {schedule})", ms, n * n, card)

    model, state, phys, dyn = ho_model(device, N4)
    profile(f"ho_coupled_1m coupled step ({N4}x{N4}, {model.schedule(device)[0]})", lambda: model.step(state, phys, dyn, DT))


# -- BASELINE config 5: the decomposed coupled step on a 2 x 2 rank grid --------
def config5_model(device, n: int = None, **backends):
    """Config 5 as ``bench_multihost_16m`` sets it (a closed n^2 RectMesh of
    2 km elements, n = N16 by default) with config 4's state and forcing, on
    one device: (model, initial state, physics forcing, dynamics forcing)."""
    n = N16 if n is None else n
    return coupled_model(device, RectMesh(n, n, dx=2e3, dy=2e3), None, **backends)


def sharded_model(device, n: int = None, degree: int = 1, mevp_params=MEVPParams(), **backends):
    """The decomposed model of config 5 (n = N16 by default) on a fresh
    2 x 2 rank grid of the one card: (rank 0's model, the ShardedCoupledModel)."""
    n = N16 if n is None else n
    grid = RankGrid(*RANKS, device)
    return build_sharded_coupled_model(
        RectMesh(n, n, dx=2e3, dy=2e3), grid, degree=degree, mevp_params=mevp_params,
        n_subcycles=N_SUBCYCLES, **backends,
    )


def blocks_of(sharded, state, phys, dyn):
    return sharded.grid.split_tree(state), sharded.grid.split_tree(phys), sharded.grid.split_tree(dyn)


def step_consts_of(model, state, dyn):
    """(carry, consts) of one rank's mEVP step from its state block (with
    the HO solver its CG2 forcing through the rank's exchange)."""
    mask = model.node_mask(device=state.hice.device, dtype=state.hice.dtype)
    velocity = state.velocity
    if model.is_high_order:
        dyn = mevp_ho.HODynamicsForcing.from_vertex_forcing(
            dyn, model.mesh.periodic_x, model.mesh.periodic_y, model.spmd)
    consts = model.mevp.step_consts(
        velocity, state.hice[0], torch.clamp(state.cice[0], 0.0, 1.0), dyn, mask, DT
    )
    return (velocity.u, velocity.v, velocity.s11, velocity.s22, velocity.s12), consts


def rdma_round_checked(model, carry, consts, plain_bands: bool = True):
    """One rdma round of h subcycles on a rank whose rdma_stage and
    rdma_band launches are each held against their plain versions on the
    same inputs (those launches are not counted; ``plain_bands`` False: the
    stage's only), then the blocked round on the same inputs. With the HO
    solver the round is K7's 17-plane one (its state one (17, nx, ny)
    tensor, the interior pass ``rdma.ho_interior``). Returns (errors, rdma
    round, blocked round, the launches' inputs by axis for timing), the
    rounds as planes."""
    solver = model.mevp
    h = solver.block_halo
    ho = model.is_high_order
    axes, consts_w = solver.rdma_round_inputs(consts)
    errors, captured = [], {}
    clone = (lambda st: st.clone()) if ho else (lambda st: [x.clone() for x in st])
    names = HO_PLANE_NAMES if ho else VELOCITY

    def stage(src, axis):
        got = rdma.rdma_stage(src, axis)
        ref = rdma.rdma_stage_reference(src, axis)
        errors.append(("rdma_stage", f"axis {axis}", got, ref))
        return got

    def band(local, src, axis, consts_w, dt, n, state):
        got = rdma.rdma_band(local, src, axis, consts_w, dt, n, clone(state))
        if plain_bands:
            ref = rdma.rdma_band_reference(local, src, axis, consts_w, dt, n, clone(state))
            errors.extend(("rdma_band", f"axis {axis} {name}", g, r) for name, g, r in zip(names, got, ref))
        captured.setdefault(axis, (local, src, consts_w, clone(state)))
        return got

    if ho:
        out = rdma._round(solver.local(), cc.ho_flatten(carry), consts, consts_w, DT, h, h, axes, stage, band,
                          rdma.ho_interior)
        blocked = mevp_ho.MEVPSolverHO(model.mesh, solver.params, backend="blocked", spmd=model.spmd, block_halo=h)
        return errors, tuple(out), tuple(cc.ho_flatten(blocked.spmd_subcycles(carry, consts, DT, h))), captured
    out = rdma._round(
        solver.local(), carry, consts, consts_w, DT, h, h, axes, stage, band, mt.mevp_subcycles_tiled,
    )
    blocked = MEVPSolver(model.mesh, solver.params, backend="blocked", spmd=model.spmd, block_halo=h)
    return errors, out, blocked.spmd_subcycles(carry, consts, DT, h), captured


def rdma_band_work(axis: int, h: int, n_sub: int, nx: int, ny: int, hx: int, n_consts: int = 7,
                   cell_ops: int = None, planes: int = 5) -> tuple:
    """(bytes, operations) that one rdma_band launch (a pair of bands) needs
    for its patch: the cone of dependence of the h patch rows (x) or
    columns (y), which narrows by one ring per subcycle. At subcycle s of
    n_sub it spans h + 2 (n_sub - s) cells across the band and, along it,
    the ny columns of an x band or nx + 2 (n_sub - s) of the nx + 2 hx rows
    of a y band. Bytes: the ``planes`` state planes (5; the HO form's 17)
    and ``n_consts`` const planes (7; 12 or 13 in the metric and A-weighted
    forms; the HO form's 29-37) of the first subcycle's cone read once, the
    patch written once; ``cell_ops``: the stress and velocity bodies'
    operations a cell (the uniform fixed-alpha ones by default; the HO
    form's element and node index, all four planes)."""
    cell_ops = OPS["stress"] + OPS["velocity"] if cell_ops is None else cell_ops
    across = lambda s: min(3 * h, h + 2 * (n_sub - s))
    along = lambda s: ny if axis == 0 else min(nx + 2 * hx, nx + 2 * (n_sub - s))
    cells = sum(across(s) * along(s) for s in range(1, n_sub + 1))
    patch = planes * h * (ny if axis == 0 else nx) * 4
    return (
        2 * ((planes + n_consts) * across(1) * along(1) * 4 + patch),
        2 * cells * cell_ops,
    )


def compare_sharded_step(tag: str, got, ref, tol_same: bool = False,
                         other: str = "the single-device kernel step") -> None:
    """Every leaf of a decomposed step against another step of the same
    state: the plain path (the step tolerances), or with ``tol_same``
    another schedule of the same bodies, ``other`` (expected 0)."""
    for name, g, r in leaves(got, ref):
        if tol_same:
            same_schedule(f"{tag}.{name}", g, r, other)
        else:
            compare(f"{tag}.{name}", g, r, TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)


def check_multihost(device) -> tuple:
    """Config 5 (4096^2 on 2 x 2 ranks of the one card), blocked ("auto")
    and rdma: K7's kernels launch by launch against their plain versions,
    the rdma round against the blocked round, one decomposed step against
    the single-device kernel step at 4096^2, the decomposed kernel step
    against the decomposed plain step at 512^2, and N5_STEPS steps of each form.
    Returns (launch counts per path, K7's Row per kernel, rank 0's
    rdma_stage and rdma_band launches for the profiler)."""
    model1, state, phys, dyn = config5_model(device)
    log("slice", (
        f"multihost_16m: {N16}x{N16} ({N16 * N16} elements) on a {RANKS[0]}x{RANKS[1]} rank grid "
        f"of one card ({RANKS[0] * RANKS[1]} ranks, one thread and two streams each); "
        f"single-device schedule {model1.schedule(device)}"
    ))
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref = model1.step(state, phys, dyn, DT)
    torch.cuda.synchronize()
    mem_single = (torch.cuda.max_memory_allocated() - before) / 2**30
    forms = {}
    for path, backend in (("multihost_16m_blocked", "auto"), ("multihost_16m", "rdma")):
        model, sharded = sharded_model(device, mevp_backend=backend)
        schedule = model.schedule(device)
        log("slice", (
            f"{path}: rank blocks {model.mesh.nx}x{model.mesh.ny}, schedule {schedule}, h = "
            f"{model.mevp.block_halo}, spmd transport (H, k_cap) = {tt.transport_tiled_spmd_config(model)}"
        ))
        if schedule != ("rdma" if backend == "rdma" else "blocked", "tiled"):
            raise AssertionError(f"{path} does not run its kernels: {schedule}")
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = sharded(state, phys, dyn, DT)
        torch.cuda.synchronize()
        log("slice", (
            f"{path}: device memory of one global-shaped step, its peak above what the "
            f"state and forcing held before: {(torch.cuda.max_memory_allocated() - before) / 2**30:.3f} "
            f"GiB (the single-device step: {mem_single:.3f} GiB; one 4096^2 plane is 0.0625 GiB)"
        ))
        compare_sharded_step(f"{path}.step vs single-device", got, ref, tol_same=True)
        for name, g, r in leaves(got, ref):  # and within the step tolerances, printed
            compare(f"{path}.step vs single-device {name}", g, r,
                    TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)
        forms[path] = (model, sharded, got)

    # K7 launch by launch, and the rdma round against the blocked round, on
    # the state after one step (moving ice, nonzero stresses).
    _, sharded, after = forms["multihost_16m"]
    states, _, dyns = blocks_of(sharded, after, phys, dyn)

    def check_round(rank):
        model = sharded.models[rank.rank]
        carry, consts = step_consts_of(model, states[rank.rank], dyns[rank.rank])
        return rdma_round_checked(model, carry, consts)

    results = run_ranks(sharded.grid.ring, check_round)
    torch.cuda.synchronize()
    errs = {"rdma_stage": 0.0, "rdma_band": 0.0}
    for r, (errors, out, blocked, _) in enumerate(results):
        for kernel, what, g, ref_ in errors:
            errs[kernel] = max(errs[kernel], compare(f"{kernel} rank {r} {what}", g, ref_, TOL_LAUNCH))
        for name, g, b in zip(VELOCITY, out, blocked):
            same_schedule(f"rdma round rank {r} {name}", g, b, "the blocked round")

    # The decomposed kernel step of each form against the decomposed plain
    # step (the same plain step for both: it runs no mEVP schedule).
    _, state_p, phys_p, dyn_p = config5_model(device, N_PLAIN_GRID)
    plain = None
    for backend in ("rdma", "auto"):
        model_p, sharded_p = sharded_model(device, N_PLAIN_GRID, mevp_backend=backend)
        got = sharded_p(state_p, phys_p, dyn_p, DT)
        if plain is None:
            blocks = blocks_of(sharded_p, state_p, phys_p, dyn_p)
            plain = sharded_p.grid.gather_tree(run_ranks(sharded_p.grid.ring, lambda rank: plain_step(
                sharded_p.models[rank.rank], *(b[rank.rank] for b in blocks)
            )), device)
        compare_step(f"multihost_{N_PLAIN_GRID} ({model_p.schedule(device)[0]}) decomposed step vs decomposed plain", got, plain)

    # N5_STEPS steps of each form from zeroed launch counters.
    counts = {}
    for path, (model, sharded, _) in forms.items():
        blocks = blocks_of(sharded, state, phys, dyn)
        cc.reset_launches()
        out = sharded.run_blocks(*blocks, DT, N5_STEPS)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        log("slice", f"{path}: {N5_STEPS} steps, launches: {counts[path]}")
        check_bounded(f"{path}: {N5_STEPS} steps", sharded.grid.gather_tree(out, device), state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")

    # K7 per call at the path's shapes (rank 0's x launches of the checked
    # round), against the plain versions; rdma_stage's library yardstick is
    # one torch.stack of the ten strip slices. The y launches are printed.
    local, src, consts_w, state0 = results[0][3][0]
    h = src.h
    nx, ny = src.own[0].shape
    times = {}
    # rdma_stage as the main path runs it: on a round's new sources, so each
    # timed call fetches the round's stream, checks the planes and builds
    # the pointer arrays, the ghosts as received.
    fresh = lambda s: rdma.RoundSources(s.own, s.h, s.split, s.gx, s.gy, stream=cc._stream(device))
    for axis in (0, 1):
        local_a, src_a, consts_a, state_a = results[0][3][axis]
        rows, cols = (3 * h, ny) if axis == 0 else (nx + 2 * src_a.hx, 3 * h)
        strip = 5 * h * (ny if axis == 0 else nx + 2 * src_a.hx) * 4
        timed = {
            "rdma_stage": (
                lambda: rdma.rdma_stage(fresh(src_a), axis),
                lambda: rdma.rdma_stage_reference(src_a, axis),
                (2 * 2 * strip, 0),
            ),
            "rdma_band": (
                lambda: rdma.rdma_band(local_a, src_a, axis, consts_a, DT, h, state_a),
                lambda: rdma.rdma_band_reference(local_a, src_a, axis, consts_a, DT, h, state_a),
                rdma_band_work(axis, h, h, nx, ny, src_a.hx),
            ),
        }
        for name, (kernel, plain, work) in timed.items():
            ms_, plain_ms = time_ms(kernel, 50), time_ms(plain, 3)
            bound_ms, bound_by = bound(*work)
            times[(name, axis)] = (ms_, plain_ms, *work)
            log("time", (
                f"{name} axis {axis}: kernel {ms_:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}) per call on a {nx}x{ny} rank block, h = {h}, "
                f"n_sub = {h}{' (a pair of ' + str(rows) + 'x' + str(cols) + ' bands)' if name == 'rdma_band' else ''}"
            ))
    # rdma_stage's x launch on new sources and on built ones against its
    # yardstick, in turns (a b c c b a) on the same host.
    cached = fresh(src)
    runs = time_in_turns({
        "new": lambda: rdma.rdma_stage(fresh(src), 0),
        "built": lambda: rdma.rdma_stage(cached, 0),
        "stack": lambda: torch.stack([p[:h] for p in src.own] + [p[nx - h:] for p in src.own]),
    }, dict.fromkeys(("new", "built", "stack"), 50))
    mean = {name: sum(ms) / len(ms) for name, ms in runs.items()}
    log("time", (
        f"rdma_stage axis 0 in turns: {mean['new']:.4f} ms per call on a round's new sources "
        f"(stream, check and pointers included; runs {', '.join(f'{m:.4f}' for m in runs['new'])}), "
        f"{mean['built']:.4f} ms on sources already built, library yardstick (one torch.stack of "
        f"the strips) {mean['stack']:.4f} ms (runs {', '.join(f'{m:.4f}' for m in runs['stack'])}); "
        f"bound {bound(*times[('rdma_stage', 0)][2:])[0]:.5f} ms"
    ))
    kernels = {
        "rdma_stage": Row(errs["rdma_stage"], mean["new"], *times[("rdma_stage", 0)][1:], mean["stack"]),
        "rdma_band": Row(errs["rdma_band"], *times[("rdma_band", 0)]),
    }
    # The device durations (torch.profiler, last in the run) of these launches.
    probes = {"rdma_stage axis 0": lambda: rdma.rdma_stage(cached, 0)}
    for axis in (0, 1):
        local_a, src_a, consts_a, state_a = results[0][3][axis]
        probes[f"rdma_band axis {axis}"] = (
            lambda local_a=local_a, src_a=src_a, consts_a=consts_a, state_a=state_a, axis=axis:
            rdma.rdma_band(local_a, src_a, axis, consts_a, DT, h, state_a)
        )
    return counts, kernels, probes


def time_multihost(device, card: str) -> None:
    """Phase 5, config 5: the single-device 4096^2 step, the 2 x 2 blocked
    and rdma steps on resident blocks; the blocked round against the rdma
    round; an h sweep of the dynamics step (h = 8, 16); profiles. One card
    shows what
    the exchange costs, not how the step scales over cards."""
    model1, state, phys, dyn = config5_model(device)
    sharded = {name: sharded_model(device, mevp_backend=name)[1] for name in ("auto", "rdma")}
    blocks = {name: blocks_of(s, state, phys, dyn) for name, s in sharded.items()}
    runs = time_in_turns(
        {
            "single-device": lambda: model1.step(state, phys, dyn, DT),
            "2x2 blocked": lambda: sharded["auto"].run_blocks(*blocks["auto"], DT, 1),
            "2x2 rdma": lambda: sharded["rdma"].run_blocks(*blocks["rdma"], DT, 1),
        },
        {"single-device": 2, "2x2 blocked": 2, "2x2 rdma": 2},
    )
    for name, ms in runs.items():
        report(f"multihost_16m coupled step, {name} ({N16}x{N16})", ms, N16 * N16, card)

    # One round of h subcycles on every rank: blocked against rdma.
    for name in ("auto", "rdma"):
        s = sharded[name]
        states, _, dyns = blocks[name]
        inputs = run_ranks(s.grid.ring, lambda rank: step_consts_of(
            s.models[rank.rank], states[rank.rank], dyns[rank.rank]
        ))
        h = s.models[0].mevp.block_halo
        ms = [time_ms(lambda: run_ranks(s.grid.ring, lambda rank: s.models[rank.rank].mevp.spmd_subcycles(
            *inputs[rank.rank], DT, h
        )), 5) for _ in range(2)]
        log("time", (
            f"multihost_16m one {s.models[0].schedule(device)[0]} round of {h} subcycles on 4 ranks: "
            f"{sum(ms) / 2:.4f} ms (runs {', '.join(f'{m:.4f}' for m in ms)}) on {card}"
        ))

    # The h sweep: the dynamics step (no physics) at h = 8, 16.
    fns = {}
    for h in (8, 16):
        for name in ("auto", "rdma"):
            s = sharded_model(device, mevp_backend=name, mevp_block_halo=h)[1]
            b = blocks_of(s, state, phys, dyn)
            fns[f"{'blocked' if name == 'auto' else 'rdma'} h={h}"] = (
                lambda s=s, b=b: s.run_blocks(*b, DT, 1, do_thermo=False)
            )
    runs = time_in_turns(fns, dict.fromkeys(fns, 1))
    for name, ms in runs.items():
        report(f"multihost_16m dynamics step, 2x2 {name} ({N16}x{N16})", ms, N16 * N16, card)

    for name in ("auto", "rdma"):
        profile(
            f"multihost_16m coupled step, 2x2 {'blocked' if name == 'auto' else 'rdma'} ({N16}x{N16})",
            lambda: sharded[name].run_blocks(*blocks[name], DT, 1), n_steps=1,
        )
    profile(f"multihost_16m coupled step, single-device ({N16}x{N16})", lambda: model1.step(state, phys, dyn, DT))


# -- BASELINE config 5 on processes: 2 x 2 worker processes of the one card --------
#: Config 5 on MP_PROCESSES worker processes of one rank each (a 2 x 2 grid),
#: by path label: the worker's path (the mEVP schedule of both grids).
MP_PROCESSES = 4
MP_FORMS = {"multiprocess_16m_blocked": "auto", "multiprocess_16m": "rdma"}
MP_STEPS = 2
MP_REPS = 3
#: The JAX worker's paths at 16^2 (2 processes x 2 ranks, 10 subcycles), and
#: the kernels each must launch.
MP_SMALL = {
    "blocked": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    "shardmap": ("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage"),
    "blocked-ring": ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
}
PATH_KERNELS.update({
    "multiprocess_16m_blocked": PATH_KERNELS["multihost_16m_blocked"],
    "multiprocess_16m": PATH_KERNELS["multihost_16m"],
})


def mp_thread_grid(device, backend: str):
    """Config 5's thread grid (2 x 2 ranks of this process on the card) on
    ``backend`` with the workers' inputs: (ShardedCoupledModel, state,
    physics and dynamics forcing blocks)."""
    _, sharded = sharded_model(device, mevp_backend=backend)
    states, phys, dyns = (list(x) for x in zip(*(
        multiprocess.problem_inputs("config5", m, device, torch.float32) for m in sharded.models
    )))
    return sharded, states, phys, dyns


def mp_turns(device, card: str, tag: str) -> dict:
    """Config 5's ms a step in turns: the single device and the 4-thread
    grid on both schedules, each from its initial state."""
    model1, state, phys, dyn = config5_model(device)
    grids = {label: mp_thread_grid(device, backend) for label, backend in MP_FORMS.items()}
    fns = {"single-device": lambda: model1.step(state, phys, dyn, DT)}
    for label, (sharded, states, physs, dyns) in grids.items():
        fns[f"4 threads {MP_FORMS[label]}"] = (
            lambda sharded=sharded, b=(states, physs, dyns): sharded.run_blocks(*b, DT, 1))
    runs = time_in_turns(fns, dict.fromkeys(fns, 2))
    for name, ms in runs.items():
        report(f"multiprocess_16m {tag}: config 5 step, {name} ({N16}x{N16})", ms, N16 * N16, card)
    return runs


def check_multiprocess(device, card: str) -> dict:
    """Config 5 on 4 worker processes of one rank each on the one card
    (``parallel.multiprocess.launch``: gloo, strips staged through pinned
    host buffers), blocked ("auto", h = 16) and rdma, MP_STEPS steps: process
    0's gathered (and checkpointed) final state against the thread grid's
    from the same inputs (expected 0), the health probe on every process,
    the workers' launches; ms a step in turns with the thread grid and the
    single device before and after, the exchange's ms a round and process
    0's idle share; then the JAX worker's paths at 16^2 on 2 processes x 2
    ranks against the single domain and the thread grid. Returns the
    workers' launch counts by path."""
    refs = {}
    for label, backend in MP_FORMS.items():
        sharded, states, phys, dyns = mp_thread_grid(device, backend)
        refs[label] = sharded.grid.gather_tree(sharded.run_blocks(states, phys, dyns, DT, MP_STEPS), "cpu")
        del sharded, states, phys, dyns
    mp_turns(device, card, "before the processes")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("slice", (
        f"multiprocess_16m: the parent holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card "
        f"({torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved) as it spawns {MP_PROCESSES} workers"
    ))
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        t0 = time.perf_counter()
        results = multiprocess.launch(
            MP_PROCESSES, 1, paths=tuple(MP_FORMS.values()), n=N16, steps=MP_STEPS,
            n_subcycles=N_SUBCYCLES, bench_reps=MP_REPS, device="cuda", problem="config5", out_dir=tmp,
            timeout=900, worker_args=("--no-reference", "--save-dir", tmp, "--profile"),
        )
        log("time", f"multiprocess_16m: launch of {MP_PROCESSES} workers {time.perf_counter() - t0:.1f} s wall")
        for r in results:
            log("slice", (
                f"multiprocess_16m process {r['process_id']}: backend {r['backend']}, host-staged strips "
                f"{r['host_staged']}, {r['local_devices']} rank of {r['global_devices']}, {r['device']}"
            ))
            if (r["backend"], r["host_staged"], r["process_count"]) != ("gloo", True, MP_PROCESSES):
                raise AssertionError(f"worker {r['process_id']} is not on gloo with host-staged strips: {r}")
        for label, backend in MP_FORMS.items():
            entries = [r["paths"][backend] for r in results]
            got = multiprocess.load_saved_state(Path(tmp) / f"{backend}.npz")
            for name, g, r in leaves(refs[label], refs[label]):
                same_schedule(f"{label} process 0's gathered checkpoint {name}",
                              torch.from_numpy(got[name.replace(".", "/")]), g, "the thread grid")
            probes = [(e["finite_probe"], e["finite_probe_detects"]) for e in entries]
            log("check", (
                f"{label} probe over {MP_PROCESSES} processes, healthy / one NaN in the last: {probes} "
                f"({'ok' if all(a and b for a, b in probes) else 'FAIL'})"
            ))
            if not all(a and b for a, b in probes):
                raise AssertionError(f"{label}: the probe over processes failed: {probes}")
            log("check", f"{label} checkpoint: {entries[0]['checkpoint']}, max_abs_diff {entries[0]['checkpoint_max_abs_error']:.3e}")
            counts[label] = dict.fromkeys(cc.KERNELS, 0)
            for e in entries:
                for kernel, n in e["launches"].items():
                    counts[label][kernel] += n
            log("slice", f"{label}: {MP_STEPS} steps on {MP_PROCESSES} processes, launches (all processes): {counts[label]}")
            missing = [k for k in PATH_KERNELS[label] if counts[label][k] == 0]
            if missing:
                raise AssertionError(f"kernels not launched on the {label} path: {missing}")
            ms = entries[0]["ms_per_step"]
            slowest = [max(e["ms_per_step"][i] for e in entries) for i in range(MP_REPS)]
            report(f"multiprocess_16m: config 5 step, {MP_PROCESSES} processes {backend} ({N16}x{N16}), process 0",
                   ms, N16 * N16, card)
            rounds = ", ".join(f"{e['exchange_ms_per_round']:.3f}" for e in entries)
            log("time", (
                f"{label}: slowest process a step {', '.join(f'{m:.3f}' for m in slowest)} ms; host-staged "
                f"exchange round (5 planes, h = 16, x then y) {rounds} ms by process; steps "
                f"{entries[0]['run_s']:.2f} s, gather {entries[0]['gather_s']:.2f} s; process 0 profiled "
                f"step: {entries[0].get('profile')} on {card}"
            ))
    mp_turns(device, card, "after the processes")

    # The JAX worker's paths at 16^2: 2 processes x 2 ranks.
    results = multiprocess.launch(2, 2, paths=tuple(MP_SMALL), n=16, steps=2, n_subcycles=10, device="cuda",
                                  timeout=600)
    for path, kernels in MP_SMALL.items():
        entries = [r["paths"][path] for r in results]
        e = entries[0]
        for ref in ("single", "threads"):
            ok = e[f"{ref}_max_rel_error"] <= TOL_SAME_SCHEDULE
            log("check", (
                f"multiprocess 16^2 {path} ({e['schedule']}, 2 processes x 2 ranks) vs the "
                f"{'single domain' if ref == 'single' else 'thread grid'}: max_abs_diff "
                f"{e[f'{ref}_max_abs_error']:.3e}, relative {e[f'{ref}_max_rel_error']:.3e} (expected 0, fail above "
                f"{TOL_SAME_SCHEDULE:g}) {'ok' if ok else 'FAIL'}"
            ))
            if not ok:
                raise AssertionError(f"multiprocess 16^2 {path} differs from the {ref} run")
        launches = {}
        for entry in entries:
            for kernel, n in entry["launches"].items():
                launches[kernel] = launches.get(kernel, 0) + n
        probes = [(x["finite_probe"], x["finite_probe_detects"]) for x in entries]
        log("slice", f"multiprocess 16^2 {path}: launches {launches}, probes {probes}, checkpoint {e['checkpoint']}")
        missing = [k for k in kernels if not launches.get(k)]
        if missing or not all(a and b for a, b in probes):
            raise AssertionError(f"multiprocess 16^2 {path}: kernels not launched {missing} or probes {probes}")
    return counts


# -- the roofline path: K8's chain kernel and the measured ceilings -------------
#: The chain forms whose SASS is counted: the two fused and the unfused.
# -- the engine (BASELINE config 1 and a rectgrid run at config 4's size) -----
#: The engine's 1024^2 rectgrid runs: steps, checkpoint period, and the
#: thermodynamics modules with their layer counts.
ENGINE_STEPS = 20
ENGINE_CHECKPOINT = 10
ENGINE_THERMO = (("Nextsim::ThermoIce0", 1), ("Nextsim::ThermoWinton", 3))
#: The JAX package's dev1 regression anchors (tests/test_runtime.py:98-100),
#: held at float32 on the card.
DEV1_ANCHORS = {"cice": 0.36670813, "hice": 0.04668325, "tice": -1.4445018}
TOL_DEV1 = 1e-5
#: The card's float32 run against the CPU's float32 run of the same restart,
#: in each plane's max: the columns beyond it are counted and printed, and
#: those beyond BRANCH_FLIP (a branch taken on one side only) too. The
#: failure line is the float64 run: the card's float32 run must lie within
#: TOL_ENGINE of the plane's max of the CPU float32 run's own distance from
#: it. float32 holds 273.15 + T to 3e-5 K, which at 20 steps is ~2e-5 of a
#: surface-temperature plane whose max is ~1.7 degC, so the 1e-5 comparison
#: against the CPU float32 run cannot hold there on either side.
TOL_ENGINE = 1e-5
BRANCH_FLIP = 1e-3
RESTART_PLANES = ("hice", "cice", "hsnow", "sst", "sss", "tice")


def engine_model(stream: str, fields, device, dtype):
    """A Model configured from one config stream (and the module selection
    it makes) on an in-memory restart; the port's Configurator and registry
    are reset first."""
    Configurator.clear()
    modules.get_loader().reset()
    Configurator.add_stream(stream)
    modules.get_loader().set_all_defaults()
    ConfiguredModule.parse_configurator()
    model = Model(device=device, dtype=dtype)
    model.configure(fields)
    return model


def engine_run(stream: str, fields, device, workdir: Path, files: bool):
    """``stream`` through the port's engine on the card in float32: with
    restart files, ``main()`` in ``workdir`` on the restart written there
    (checkpoints and the final ``restart.nc`` written, read back); without,
    a Model from the in-memory ``fields`` and its time loop. Returns the
    final restart and the host seconds of the restart write and read."""
    io_s = {}
    if not files:
        model = engine_model(stream, fields, device, torch.float32)
        model.iterator.run()
        return model.structure.restart_fields(), io_s
    t0 = time.perf_counter()
    write_restart_fields(str(workdir / "init.nc"), fields)
    io_s["write"] = time.perf_counter() - t0
    (workdir / "run.cfg").write_text(f"{stream}[model]\ninit_file = init.nc\n")
    cwd = Path.cwd()
    os.chdir(workdir)
    try:
        Configurator.clear()
        modules.get_loader().reset()
        if engine_main(["nextsim", "--config-file", "run.cfg"], device=device, dtype=torch.float32):
            raise AssertionError(f"main() failed in {workdir}")
    finally:
        os.chdir(cwd)
    t0 = time.perf_counter()
    out = read_restart(str(workdir / "restart.nc"))
    io_s["read"] = time.perf_counter() - t0
    return out, io_s


def check_dev1(device, workdir: Path, files: bool) -> None:
    """run/dev1.cfg (10 x 10 devgrid, 1 step of 1 s) on the card: the JAX
    package's anchors, sst and sss unchanged, every field uniform."""
    stream = (Path(__file__).parent / "run" / "dev1.cfg").read_text()
    if files:
        # main() reads the restart file that run/dev1.cfg names, in workdir.
        make_dev_restart(str(workdir / "dev1.res.nc"))
    out, _ = engine_run(stream, dev_restart_fields(), device, workdir, files)
    for name in RESTART_PLANES:
        plane = getattr(out, name)
        if not np.all(plane == plane.flat[0]):
            raise AssertionError(f"dev1: {name} is not uniform")
    if not (np.all(out.sst == -1.0) and np.all(out.sss == 32.0)):
        raise AssertionError("dev1: sst or sss changed")
    for name, anchor in DEV1_ANCHORS.items():
        got = float(getattr(out, name).flat[0])
        ok = abs(got - anchor) <= TOL_DEV1 * abs(anchor)
        log("check", (
            f"engine dev1 on the card: {name} {got:.8f} against the anchor {anchor} "
            f"(rtol {TOL_DEV1:g}) {'ok' if ok else 'FAIL'}"
        ))
        if not ok:
            raise AssertionError(f"dev1: {name} {got} is not within {TOL_DEV1:g} of {anchor}")


def engine_stream(thermo: str, checkpoint: int) -> str:
    stream = (
        f"[model]\nstart = 0\nstop = {ENGINE_STEPS * DT:g}\ntime_step = {DT:g}\n"
        f"[Modules]\nNextsim::IThermodynamics = {thermo}\n"
    )
    if checkpoint:
        stream += f"[model]\ncheckpoint_period = {checkpoint}\n"
    return stream


def compare_engine(tag: str, card, cpu32, cpu64) -> None:
    """The card's final restart against the CPU's float32 and float64 runs
    of the same restart, plane by plane (see TOL_ENGINE)."""
    failed = []
    for name in RESTART_PLANES:
        got, ref, exact = (getattr(r, name) for r in (card, cpu32, cpu64))
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{tag}: {name} has non-finite values")
        scale = float(np.abs(exact).max())
        diff = np.abs(got - ref).reshape(got.shape[0], got.shape[1], -1).max(-1)
        beyond, flipped = (int((diff > tol * scale).sum()) for tol in (TOL_ENGINE, BRANCH_FLIP))
        card64 = float(np.abs(got - exact).max())
        cpu64_err = float(np.abs(ref - exact).max())
        ok = card64 <= cpu64_err + TOL_ENGINE * scale
        log("check", (
            f"{tag} {name}: max_abs_err={diff.max():.3e} against the CPU float32 run, "
            f"max_rel_err={diff.max() / scale:.3e} of max|float64|={scale:.3e}: {beyond} columns "
            f"beyond {TOL_ENGINE:g}, {flipped} beyond {BRANCH_FLIP:g}; against the CPU float64 "
            f"run: card {card64 / scale:.3e}, CPU float32 {cpu64_err / scale:.3e} (tol +{TOL_ENGINE:g}) "
            f"{'ok' if ok else 'FAIL'}"
        ))
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(
            f"{tag}: {failed} further than {TOL_ENGINE:g} of the plane's max beyond the CPU "
            "float32 run's distance from the float64 run"
        )


def time_engine(tag: str, thermo: str, fields, device, card: str) -> None:
    """After a warm-up step: the Timer's host ms per step over the Iterator's
    ENGINE_STEPS steps (the time to issue a step), then ms per step and
    column updates/s by CUDA events over ENGINE_STEPS back-to-back steps,
    and the restart's move to and from the card."""
    model = engine_model(engine_stream(thermo, 0), fields, device, torch.float32)
    model.model_step.run_steps_scanned(1, DT)
    torch.cuda.synchronize()
    main_timer.reset()
    model.iterator.run()
    torch.cuda.synchronize()
    step = main_timer.root.children["time-loop"].children["step"].chrono
    host_ms = step.wall_time() / step.ticks * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model.model_step.run_steps_scanned(ENGINE_STEPS, DT)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / ENGINE_STEPS
    columns = fields.nx * fields.ny
    t0 = time.perf_counter()
    loaded = StructureFactory.generate_from_fields(fields, device=device, dtype=torch.float32)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loaded.restart_fields()
    fetch_ms = (time.perf_counter() - t0) * 1e3
    log("time", (
        f"{tag}: {ms:.4f} ms per step, {columns / ms * 1e3:.4g} column updates/s (CUDA events, "
        f"{ENGINE_STEPS} steps back to back); the Timer's host time per step of the time loop "
        f"{host_ms:.4f} ms (issue, not device time); restart to the card {load_ms:.2f} ms, "
        f"to float64 host arrays {fetch_ms:.2f} ms; {card}"
    ))


def profile_engine(device) -> None:
    """The profile of the 1024^2 ThermoIce0 step (after the timings: a
    profiler session slows the host's later launches)."""
    fields = seeded_rect_fields(N4, N4, 1, seed=SEED)
    try:
        model = engine_model(engine_stream(ENGINE_THERMO[0][0], 0), fields, device, torch.float32)
        profile(
            f"engine {N4}^2 rectgrid ThermoIce0 step",
            lambda: model.model_step.run_steps_scanned(1, DT),
        )
    finally:
        Configurator.clear()
        modules.get_loader().reset()


def check_engine(device, smi: str) -> None:
    """The port's engine on the card: run/dev1.cfg, then 20 steps of a
    seeded 1024^2 rectgrid restart with ThermoIce0 (1 layer) and with
    ThermoWinton (3 layers), each against the port's CPU runs of the same
    restart, and their times. Restart files need h5py; where it is missing
    the same runs start from the in-memory restart."""
    files = importlib.util.find_spec("h5py") is not None
    log("engine", (
        f"h5py {'installed' if files else 'not installed'}, system libnetcdf "
        f"{'found' if netcdf_c.available() else 'not found'}"
    ))
    if not files:
        log("engine", (
            "restart file I/O not exercised on the card: no h5py here, so every run starts from "
            "the in-memory RestartFields of the same arrays and writes no checkpoint or restart file"
        ))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            check_dev1(device, Path(tmp), files)
        for thermo, nlayers in ENGINE_THERMO:
            name = thermo.split("::")[1]
            tag = f"engine {N4}^2 rectgrid {name}"
            fields = seeded_rect_fields(N4, N4, nlayers, seed=SEED)
            with tempfile.TemporaryDirectory() as tmp:
                card, io_s = engine_run(
                    engine_stream(thermo, ENGINE_CHECKPOINT if files else 0), fields, device,
                    Path(tmp), files,
                )
                if files:
                    checkpoints = sorted(p.name for p in Path(tmp).glob("checkpoint.*.nc"))
                    log("engine", f"{tag}: checkpoints {checkpoints}")
            if io_s:
                log("time", (
                    f"{tag}: restart file write {io_s['write'] * 1e3:.1f} ms, read "
                    f"{io_s['read'] * 1e3:.1f} ms (host clock); {smi}"
                ))
            stream = engine_stream(thermo, 0)
            cpu = {}
            for dtype in (torch.float32, torch.float64):
                model = engine_model(stream, fields, "cpu", dtype)
                model.iterator.run()
                cpu[dtype] = model.structure.restart_fields()
            compare_engine(tag, card, cpu[torch.float32], cpu[torch.float64])
            time_engine(tag, thermo, fields, device, smi)
    finally:
        Configurator.clear()
        modules.get_loader().reset()


# -- the coupled CLI (phase check_cli, ROADMAP M8b part 1) ----------------------
RUN_DIR = Path(__file__).parent / "run"
#: BASELINE config 5's size through the CLI: 4096^2 elements of 2 km on a
#: 2 x 2 rank grid of the card, probed and checkpointed every step, 2 steps
#: (cut in depth, not in width), with the box's cyclone forcing.
CLI_16M_CFG = (
    "[model]\nstart = 0\nstop = 1200\ntime_step = 600\nhealth_period = 1\n"
    "checkpoint_period = 1\ncheckpoint_pattern = config5.{step}.chk\n"
    f"[dynamics]\nnx = {N16}\nny = {N16}\ndx = 2000.0\ndy = 2000.0\nsubcycles = {N_SUBCYCLES}\n"
    "thermo = true\nforcing = cyclone\nwind = 30.0\n"
    "[parallel]\nmode = shardmap\nmesh_shape = 2x2\n"
)
#: The health runs' overrides of run/box.cfg: 3 steps of constant forcing,
#: a probe, a diagnostics row and (every 2 steps) a checkpoint.
CLI_HEALTH_ARGS = (
    "--dynamics.forcing=constant", "--model.stop=1800", "--model.health_period=1",
    "--model.diagnostics_period=1", "--model.checkpoint_period=2",
)
#: The CLI's timer scopes read per run.
CLI_SCOPES = ("step", "health", "forcing", "checkpoint", "diagnostics")


class CliFiles:
    """What a CLI run wrote, by file name: its checkpoints (model time and
    host leaves) and its diagnostics rows (time and planes). Where h5py is
    installed the files are written and read back; where it is not (the
    card machines so far), in-memory recorders stand in for
    ``coupled_restart.save_coupled_state`` and
    ``diagnostics.DiagnosticWriter`` as the CLI reaches them, keeping each
    call's host arrays and time; nothing else is patched."""

    def __init__(self, files: bool) -> None:
        self.files = files
        self.checkpoints = {}
        self.rows = []
        self._saved = None

    def save(self, path, host: dict, time=0.0) -> None:
        self.checkpoints[str(path)] = (float(time), host)

    def writer(self, path, field_names=diagnostics.DEFAULT_FIELDS):
        rows = self.rows

        class Recorder:
            def write(self, time, fields):
                rows.append((float(time), {name: np.array(fields[name]) for name in field_names}))

            def close(self):
                pass

        return Recorder()

    def __enter__(self) -> "CliFiles":
        if not self.files:
            self._saved = (coupled_restart.save_coupled_state, diagnostics.DiagnosticWriter)
            coupled_restart.save_coupled_state, diagnostics.DiagnosticWriter = self.save, self.writer
        return self

    def __exit__(self, *exc) -> None:
        if self._saved is not None:
            coupled_restart.save_coupled_state, diagnostics.DiagnosticWriter = self._saved

    def collect(self, workdir: Path) -> tuple:
        """(checkpoints, rows) of the run that just ended, then forget them
        (with files: read from workdir, then deleted)."""
        if self.files:
            for path in sorted(workdir.glob("*.chk")):
                state = coupled_restart.load_coupled_state(str(path), device="cpu", dtype=torch.float32)
                self.checkpoints[path.name] = (coupled_restart.load_time(str(path)), coupled_state_to_numpy(state))
                path.unlink()
            for path in sorted(workdir.glob("*.h5")):
                data = diagnostics.read_diagnostics(str(path))
                self.rows += [(float(t), {name: data[name][i] for name in diagnostics.DEFAULT_FIELDS})
                              for i, t in enumerate(data["time"])]
                path.unlink()
        out = (self.checkpoints, self.rows)
        self.checkpoints, self.rows = {}, []
        return out


@dataclass
class CliRun:
    """One CLI run: its launches, wall seconds, the timer's scopes (total s,
    activations), checkpoints and diagnostics rows."""

    counts: dict
    wall_s: float
    scopes: dict
    checkpoints: dict
    rows: list


def cli_run(argv, device, workdir: Path, files: CliFiles, raises=None) -> CliRun:
    """``run_coupled(argv)`` on the card in float32, in ``workdir``, from
    zeroed launch counts; with ``raises``, the run must raise it."""
    Configurator.clear()
    modules.get_loader().reset()
    main_timer.reset()
    cwd = Path.cwd()
    os.chdir(workdir)
    try:
        cc.reset_launches()
        t0 = time.perf_counter()
        try:
            rc = run_coupled(["nextsim", *argv], device=device)
        except Exception as err:
            if raises is None or not isinstance(err, raises):
                raise
        else:
            if raises is not None:
                raise AssertionError(f"the CLI with {argv} returned {rc} where it should raise {raises.__name__}")
            if rc != 0:
                raise AssertionError(f"the CLI with {argv} returned {rc}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cc.launches)
        run_node = main_timer.root.children.get("run")
        scopes = {} if run_node is None else {
            name: (node.chrono.wall_time(), node.chrono.ticks)
            for name, node in [("run", run_node), *run_node.children.items()]
        }
    finally:
        os.chdir(cwd)
        Configurator.clear()
        modules.get_loader().reset()
    return CliRun(counts, wall, scopes, *files.collect(workdir))


def cli_setup(argv, device):
    """The setup that the CLI builds from ``argv`` (its config, overrides and
    module selections), built anew on the card: the direct loops' model."""
    Configurator.clear()
    modules.get_loader().reset()
    try:
        coupled_main.apply_config(["nextsim", *argv])
        return coupled_main.configure_coupled(device=device, dtype=torch.float32)
    finally:
        Configurator.clear()
        modules.get_loader().reset()


def direct_loop(setup, dts, keep) -> dict:
    """The setup's model stepped without the CLI's run loop: ``model.step`` (on a
    rank grid ``ShardedCoupledModel.__call__``, the global-shaped step) at
    each dt of ``dts``, fed the same fields (a second cyclone pipeline of
    the same parameters; with a forcing archive, the setup's provider's
    physics and dynamics forcing at each step's start time); the global
    state fetched to the host after each full step in ``keep`` (by step
    number)."""
    pipe = setup.open_pipeline()
    state, out, step, halves = setup.state, {}, 0, 0
    nx, ny = setup.model.mesh.nx, setup.model.mesh.ny
    try:
        for dt in dts:
            phys, dyn = setup.phys_forcing, setup.dyn_forcing
            if pipe is not None:
                dyn = coupled_main.cyclone_forcing(pipe.next_fields(), device=setup.device, dtype=setup.dtype)
            elif setup.provider is not None:
                t = setup.start + halves * (setup.dt / 2)
                phys, dyn = setup.provider.thermo_forcing(t, nx, ny), setup.provider.dynamics_forcing(t, nx, ny)
            stepper = setup.model.step if setup.sharded is None else setup.sharded
            state = stepper(state, phys, dyn, dt, do_thermo=setup.do_thermo)
            halves += 1 if dt < setup.dt else 2
            if halves % 2 == 0:
                step = halves // 2
                if step in keep:
                    out[step] = coupled_restart.fetch_coupled_state(state)
    finally:
        if pipe is not None:
            pipe.close()
    return out


def compare_host(tag: str, got: dict, ref: dict) -> float:
    """Every leaf of two host states (interop layout); expected 0, failing
    above TOL_SAME_SCHEDULE of the plane's max."""
    def flat(d, prefix=""):
        for key, value in d.items():
            yield from flat(value, f"{prefix}{key}.") if isinstance(value, dict) else ((prefix + key, value),)

    ref = dict(flat(ref))
    worst = 0.0
    for name, value in flat(got):
        worst = max(worst, compare(f"{tag}.{name}", torch.from_numpy(value), torch.from_numpy(ref[name]),
                                   TOL_SAME_SCHEDULE))
    return worst


def compare_rows(tag: str, rows: list, ref: dict, dt: float) -> None:
    """The diagnostics rows against the direct loop's states at their steps."""
    for t, fields in rows:
        state = ref[int(round(t / dt))]
        for name, plane in fields.items():
            want = state[name][0] if state[name].ndim == 3 and name in ("hice", "cice", "hsnow") else state[name]
            compare(f"{tag} row t={t:g} {name}", torch.from_numpy(np.asarray(plane)), torch.from_numpy(want),
                    TOL_SAME_SCHEDULE)


def best_host_ms(fn, reps: int = 5) -> float:
    """Best host-clock ms of fn() followed by a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def bare_ms(setup, n: int) -> float:
    """ms per step of n back-to-back steps of the setup's model on one fixed
    forcing (on a rank grid ``run_blocks`` on resident blocks), host clock
    to a synchronize."""
    dyn = setup.dyn_forcing
    if dyn is None:
        with setup.open_pipeline() as pipe:
            dyn = coupled_main.cyclone_forcing(pipe.next_fields(), device=setup.device, dtype=setup.dtype)
    state = setup.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if setup.sharded is None:
        setup.model.run(state, setup.phys_forcing, dyn, setup.dt, n, do_thermo=setup.do_thermo)
    else:
        setup.sharded.run_blocks(*blocks_of(setup.sharded, state, setup.phys_forcing, dyn), setup.dt, n,
                                 do_thermo=setup.do_thermo)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def box_kernels(device) -> tuple:
    """The kernels of run/box.cfg's step on this card: 256^2 closed, "auto"
    (fused_dynamics where it holds the grid below FUSED_MAX_ELEMENTS, else
    the tiled schedule)."""
    model = CoupledModel(RectMesh(N, N, dx=2000.0, dy=2000.0))
    return SCHEDULE_KERNELS[model.schedule(device)]


def cli_expect(path: str, run: CliRun, kernels: tuple) -> None:
    """The run's launches: every kernel of its path launched."""
    PATH_KERNELS[path] = kernels
    launched = {k: v for k, v in run.counts.items() if v}
    log("slice", f"{path}: launches {launched}")
    missing = [k for k in kernels if run.counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")


def cli_against_loop(path: str, argv, kernels: tuple, device, workdir: Path, rec) -> tuple:
    """One CLI run of ``argv`` against a direct loop of the same setup: the
    kernels of its path launched, its final state (at the config's stop),
    checkpoints and diagnostics rows each equal to the loop's state at their
    step. Returns (setup, run)."""
    setup = cli_setup(argv, device)
    n = setup.n_steps
    log("slice", (
        f"{path}: {setup.model.mesh.nx}x{setup.model.mesh.ny} {type(setup.model.mesh).__name__}, "
        f"{'HO' if setup.model.is_high_order else 'CG1'}, {n} steps, schedule {setup.model.schedule(device)}"
    ))
    run = cli_run(argv, device, workdir, rec)
    cli_expect(path, run, kernels)
    keep = {int(round(t / setup.dt)) for t, _ in run.rows} | {n} | {
        int(round(t / setup.dt)) for t, _ in run.checkpoints.values()}
    ref = direct_loop(setup, [setup.dt] * n, keep)
    final_t, final = run.checkpoints["coupled_restart.chk"]
    if final_t != setup.stop:
        raise AssertionError(f"{path}: the final checkpoint's time {final_t} is not {setup.stop}")
    compare_host(f"{path} final vs direct loop", final, ref[n])
    for name, (t, host) in sorted(run.checkpoints.items()):
        if name != "coupled_restart.chk":
            compare_host(f"{path} {name} vs direct loop", host, ref[int(round(t / setup.dt))])
    compare_rows(path, run.rows, ref, setup.dt)
    log("slice", (
        f"{path}: checkpoints {sorted(run.checkpoints)}, diagnostics rows at "
        f"{[t for t, _ in run.rows]}: each equal to the direct loop"
    ))
    return setup, run


def cli_in_turns(path: str, argv, setup, run: CliRun, device, workdir: Path, rec, card: str) -> None:
    """The CLI's ms per step (``run`` and a second run) in turns with the
    bare step, and the isolated times."""
    n = setup.n_steps
    bare = [bare_ms(setup, n)]
    again = cli_run(argv, device, workdir, rec)
    bare.append(bare_ms(setup, n))
    cli_times(path, run, n, setup, card, {})
    cli_times(f"{path} (again)", again, n, setup, card, {
        "bare step (in turns)": bare[0], "bare step again": bare[1], **isolated_times(setup)})


def cli_times(path: str, run: CliRun, n_steps: int, setup, card: str, extra: dict) -> None:
    """The CLI's ms per step (the timer's run scope over its steps), each
    scope's ms per activation, and the isolated times in ``extra``."""
    total, _ = run.scopes["run"]
    scopes = ", ".join(
        f"{name} {run.scopes[name][0] * 1e3 / run.scopes[name][1]:.3f} ms x{run.scopes[name][1]}"
        for name in CLI_SCOPES if name in run.scopes
    )
    log("time", (
        f"cli {path}: {total * 1e3 / n_steps:.3f} ms per step through the CLI ({n_steps} steps, host clock of its "
        f"run loop, probes and cadence work included; whole call {run.wall_s:.2f} s); scopes a call: {scopes}; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in extra.items()) + f"; {card}"
    ))


def isolated_times(setup) -> dict:
    """The probe, the checkpoint fetch and (cyclone) the forcing copy on the
    setup's initial state, each timed alone (host clock to a synchronize,
    best of 5); on a rank grid also the gather of the resident blocks. With
    a forcing archive, the step's refresh (both forcings from the provider,
    on a grid split into the rank blocks) at a new time inside the first
    bracket (the blend alone) and at times that alternate between the first
    two brackets (one record copied each time). Every closure holds its own
    inputs."""
    from nextsimdg_tpu_torch.runtime.health import finite_probe

    out = {}
    state = setup.state
    if setup.sharded is None:
        out["probe"] = best_host_ms(lambda s=state: finite_probe(s))
        out["checkpoint fetch"] = best_host_ms(lambda s=state: coupled_restart.fetch_coupled_state(s), 3)
    else:
        grid = setup.sharded.grid
        blocks = grid.split_tree(state)
        out["probe (resident blocks)"] = best_host_ms(lambda b=blocks: finite_probe(b))
        out["gather"] = best_host_ms(lambda b=blocks: grid.gather_tree(b, device=setup.device), 3)
        out["checkpoint fetch (gather + copy)"] = best_host_ms(
            lambda b=blocks: coupled_restart.fetch_coupled_state(grid.gather_tree(b, device=setup.device)), 3)
        del blocks
    if setup.cyclone is not None:
        with setup.open_pipeline() as pipe:
            fields = pipe.next_fields()
        out["forcing copy"] = best_host_ms(
            lambda f=fields: coupled_main.cyclone_forcing(f, device=setup.device, dtype=setup.dtype))
    if setup.provider is not None:
        provider, (nx, ny) = setup.provider, (setup.model.mesh.nx, setup.model.mesh.ny)
        place = (lambda tree: tree) if setup.sharded is None else setup.sharded.grid.split_tree
        inside = iter(provider.time[0] + np.arange(1, 100) * 1e-3 * (provider.time[1] - provider.time[0]))
        across = iter([0.5 * (provider.time[i] + provider.time[i + 1]) for i in (0, 1)] * 50)

        def refresh(times):
            t = float(next(times))
            return place(provider.thermo_forcing(t, nx, ny)), place(provider.dynamics_forcing(t, nx, ny))

        out["forcing refresh (blend)"] = best_host_ms(lambda: refresh(inside))
        out["forcing refresh across a bracket (one record copied)"] = best_host_ms(lambda: refresh(across))
    return out


def check_cli(device, smi: str) -> dict:
    """Phase: the coupled CLI (``runtime.coupled_main.run_coupled``) on the
    card, five runs in a temporary directory: run/box.cfg as it stands;
    run/arctic.cfg as it stands; run/arctic.cfg on a 2 x 2 rank grid cut to
    12 steps; BASELINE config 5's size on a 2 x 2 grid for 2 steps, probed
    and checkpointed every step; and health at 256^2 with the step poisoned
    (abort, and retry-halved). Each run's final state, checkpoints and
    diagnostics rows against a direct loop of the same model on the same
    fields (expected 0), the 2 x 2 arctic run against the single-device
    one, the launches of each run, and the CLI's ms per step beside the
    bare step, the probe, the checkpoint fetch and the forcing copy.
    Returns the launch counts by path."""
    files = importlib.util.find_spec("h5py") is not None
    if not files:
        log("cli", (
            "checkpoint and diagnostics file I/O not exercised on the card: no h5py here, so in-memory "
            "recorders stand in for coupled_restart.save_coupled_state and diagnostics.DiagnosticWriter "
            "(each call's host arrays and time); nothing else is patched"
        ))
    box, arctic = ["--config-file", str(RUN_DIR / "box.cfg")], ["--config-file", str(RUN_DIR / "arctic.cfg")]
    cut = ["--model.stop=7200"]
    grid = ["--parallel.mode=shardmap", "--parallel.mesh_shape=2x2"]
    tiled = ("mevp_tiled", "dg1_sample_cfl", "transport_tiled")
    boxed = box_kernels(device)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp, CliFiles(files) as rec:
        workdir = Path(tmp)

        # 1 and 2: run/box.cfg and run/arctic.cfg as they stand, each twice
        # in turns with the bare step.
        for path, argv, kernels in (("cli_box", box, boxed), ("cli_arctic", arctic, ("ho_single", "transport_tiled"))):
            t0 = time.perf_counter()
            setup, run = cli_against_loop(path, argv, kernels, device, workdir, rec)
            counts[path] = run.counts
            cli_in_turns(path, argv, setup, run, device, workdir, rec, smi)
            log("time", f"check_cli {path}: {time.perf_counter() - t0:.1f} s")
            del setup

        # 3: run/arctic.cfg on 2 x 2 ranks, 12 steps, against a loop of the
        # global-shaped step and the single-device CLI cut to 12 steps.
        t0 = time.perf_counter()
        setup = cli_setup(arctic + cut + grid, device)
        n = setup.n_steps
        model = setup.sharded.models[0]
        log("slice", (
            f"cli_arctic_2x2: {type(model.mesh).__name__} blocks {model.mesh.nx}x{model.mesh.ny}, "
            f"schedule {model.schedule(device)}, {n} steps"
        ))
        run = cli_run(arctic + cut + grid, device, workdir, rec)
        cli_expect("cli_arctic_2x2", run, ("ho_single", "transport_tiled"))
        counts["cli_arctic_2x2"] = run.counts
        ref = direct_loop(setup, [setup.dt] * n, {n} | {int(round(t / setup.dt)) for t, _ in run.rows})
        final = run.checkpoints["coupled_restart.chk"][1]
        compare_host("cli_arctic_2x2 final vs a loop of ShardedCoupledModel.__call__", final, ref[n])
        compare_rows("cli_arctic_2x2", run.rows, ref, setup.dt)
        single = cli_run(arctic + cut, device, workdir, rec)
        compare_host("cli_arctic_2x2 final vs the single-device CLI run", final,
                     single.checkpoints["coupled_restart.chk"][1])
        cli_times("cli_arctic_2x2", run, n, setup, smi, {
            "bare step (resident blocks)": bare_ms(setup, 4), **isolated_times(setup)})
        log("time", f"check_cli cli_arctic_2x2: {time.perf_counter() - t0:.1f} s")
        del setup, ref, run, single, model

        # 4: config 5's size through the CLI, 2 steps, probed and
        # checkpointed every step.
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = workdir / "config5.cfg"
        cfg.write_text(CLI_16M_CFG)
        argv = ["--config-file", str(cfg)]
        setup = cli_setup(argv, device)
        n = setup.n_steps
        model = setup.sharded.models[0]
        log("slice", (
            f"cli_16m: {N16}^2 on 2x2 ranks of {model.mesh.nx}x{model.mesh.ny}, schedule {model.schedule(device)}, "
            f"{n} steps, health and checkpoints every step"
        ))
        run = cli_run(argv, device, workdir, rec)
        cli_expect("cli_16m", run, tiled)
        counts["cli_16m"] = run.counts
        ref = direct_loop(setup, [setup.dt] * n, set(range(1, n + 1)))
        for name, (t, host) in sorted(run.checkpoints.items()):
            compare_host(f"cli_16m {name} vs a loop of ShardedCoupledModel.__call__", host, ref[int(round(t / setup.dt))])
        log("slice", f"cli_16m: checkpoints {sorted(run.checkpoints)}; device memory peak "
                     f"{torch.cuda.max_memory_reserved(device) / 2**30:.1f} GiB reserved")
        del ref
        run.checkpoints = None
        cli_times("cli_16m", run, n, setup, smi, {
            "bare step (resident blocks)": bare_ms(setup, n), **isolated_times(setup)})
        del setup, run, model
        torch.cuda.empty_cache()
        log("time", f"check_cli cli_16m: {time.perf_counter() - t0:.1f} s")

        # 5: health at 256^2, the step poisoned on its second call.
        t0 = time.perf_counter()
        original = CoupledModel.step
        calls = {"full": 0, "half": 0}

        def poisoned(self, state, phys, dyn, dt, *args, **kwargs):
            out = original(self, state, phys, dyn, dt, *args, **kwargs)
            calls["full" if dt == DT else "half"] += 1
            if dt == DT and calls["full"] == 2:
                out = replace(out, hice=out.hice * float("nan"))
            return out

        from nextsimdg_tpu_torch.runtime.health import NonFiniteStateError

        argv_abort = box + list(CLI_HEALTH_ARGS)
        argv_retry = argv_abort + ["--model.on_nonfinite=retry-halved"]
        CoupledModel.step = poisoned
        try:
            abort = cli_run(argv_abort, device, workdir, rec, raises=NonFiniteStateError)
            abort_calls = dict(calls)
            calls.update(full=0, half=0)
            retry = cli_run(argv_retry, device, workdir, rec)
        finally:
            CoupledModel.step = original
        setup = cli_setup(argv_abort, device)
        cli_expect("cli_health_abort", abort, boxed)
        cli_expect("cli_health_retry", retry, boxed)
        counts["cli_health_abort"], counts["cli_health_retry"] = abort.counts, retry.counts
        post_t, post = abort.checkpoints["coupled_failed.post_mortem.chk"]
        if np.all(np.isfinite(post["hice"])) or post_t != 2 * DT:
            raise AssertionError(f"health abort: the post-mortem (t={post_t}) is not the poisoned step-2 state")
        good_t, good = abort.checkpoints["coupled_restart.chk"]
        if good_t != DT or abort_calls != {"full": 2, "half": 0}:
            raise AssertionError(f"health abort: final checkpoint t={good_t}, steps {abort_calls}")
        ref = direct_loop(setup, [DT], {1})
        compare_host("cli_health_abort last healthy state vs one direct step", good, ref[1])
        if calls != {"full": 3, "half": 2}:
            raise AssertionError(f"health retry-halved: steps {calls}, expected 3 full and 2 half")
        times = [t for t, _ in retry.rows]
        if times != [DT, 2 * DT, 3 * DT] or not all(np.all(np.isfinite(p)) for _, r in retry.rows for p in r.values()):
            raise AssertionError(f"health retry-halved: rows at {times}, or a row not finite")
        # The replay is what it says: step 1 at dt, step 2 as two dt/2, step 3.
        ref = direct_loop(setup, [DT, DT / 2, DT / 2, DT], {1, 2, 3})
        compare_host("cli_health_retry final vs the direct loop dt, dt/2, dt/2, dt",
                     retry.checkpoints["coupled_restart.chk"][1], ref[3])
        compare_rows("cli_health_retry", retry.rows, ref, DT)
        log("slice", (
            f"health on the card: abort raised NonFiniteStateError after {abort_calls['full']} steps, post-mortem "
            f"non-finite (t={post_t:g}), coupled_restart.chk the step-1 state (t={good_t:g}); retry-halved replayed "
            f"step 2 as {calls['half']} half steps, rows at {times} finite"
        ))
        del setup, ref
        log("time", f"check_cli health: {time.perf_counter() - t0:.1f} s")
    return counts


# -- the file forcings (phase check_forcing_files, ROADMAP M8b part 2) ------------
#: The phase's archives: (low, high) of each field's values.
ARCHIVE_RANGES = {
    "tair": (-25.0, -5.0), "dew2m": (-27.0, -7.0), "pair": (9.9e4, 1.01e5), "sw_in": (0.0, 60.0),
    "lw_in": (180.0, 280.0), "mld": (8.0, 15.0), "snowfall": (0.0, 2e-4), "wind": (2.0, 12.0),
    "u_atm": (2.0, 12.0), "v_atm": (-4.0, 4.0), "u_ocean": (-0.05, 0.05), "v_ocean": (-0.05, 0.05),
}
#: 6-hourly records spanning run/arctic.cfg's 12 h and more.
ARCHIVE_TIMES = np.arange(4) * 6 * 3600.0
#: BASELINE config 5's size: 3 records bracketing its 2 steps (the second
#: step enters the next interval: one record copied), the four dynamics
#: fields with tair and wind (the rest the dummies, to bound host memory).
ARCHIVE_16M_TIMES = np.array([0.0, 500.0, 1200.0])
ARCHIVE_16M_FIELDS = ("tair", "wind", "u_atm", "v_atm", "u_ocean", "v_ocean")
#: Provider probes: (label, time) against ARCHIVE_TIMES.
PROVIDER_PROBES = (
    ("at a record", 6 * 3600.0), ("between records", 7.3 * 3600.0), ("below the range", -100.0),
    ("above the range", 1e9), ("across the periodic wrap", 18 * 3600.0 + 3.1 * 3600.0),
    ("at the last record", 18 * 3600.0),
)
#: ERA5-style hourly file over run/arctic.cfg's window (55-85N, 40W-40E)
#: and its 12 h: descending latitudes, as the CDS stores them.
ERA5_LATS = np.linspace(86.0, 54.0, 33)
ERA5_LONS = np.linspace(-41.0, 41.0, 83)
ERA5_HOURS = 13
TRACE_ANNOTATION = "nextsim archive box step"


def archive_fields(nx: int, ny: int, times, names, seed: int) -> dict:
    """Series of ``names`` (len(times), nx, ny), float64, each within its
    ARCHIVE_RANGES: a smooth pattern in x plus one in y, both moving with
    time (separable, so that 16.8M elements a record cost one pass)."""
    rng = np.random.default_rng(seed)
    x, y = np.arange(nx) / nx, np.arange(ny) / ny
    out = {}
    for name in names:
        lo, hi = ARCHIVE_RANGES[name]
        kx, ky = rng.integers(1, 4, size=2)
        px, py = rng.uniform(0.0, 2 * np.pi, size=2)
        series = np.empty((len(times), nx, ny))
        for i, t in enumerate(times):
            phase = 2 * np.pi * t / 86400.0
            series[i] = 0.5 + 0.25 * np.sin(2 * np.pi * kx * x + px + phase)[:, None]
            series[i] += 0.2 * np.cos(2 * np.pi * ky * y + py - phase)[None, :]
            series[i] *= hi - lo
            series[i] += lo
        out[name] = series
    return out


def era5_variables(lats, lons, hours: int) -> dict:
    """The raw variables of an ERA5-style file, name -> (values, attributes),
    shaped like tests/test_era5.py's ``_write_era5``: hours since 1900,
    descending latitudes, t2m, u10 and v10 packed as int16 (scale_factor,
    add_offset, _FillValue), ssrd and sf unpacked float64 accumulations
    over the hour."""
    lat2, lon2 = np.meshgrid(lats, lons, indexing="ij")
    t = np.arange(hours, dtype=np.float64)[:, None, None]

    def packed(values, scale, offset):
        raw = np.round((values - offset) / scale).astype(np.int16)
        return raw, {"scale_factor": np.float64(scale), "add_offset": np.float64(offset),
                     "_FillValue": np.int16(-32767)}

    shape = (hours, len(lats), len(lons))
    return {
        "time": (np.arange(hours, dtype=np.int32) + 1_000_000,
                 {"units": np.bytes_("hours since 1900-01-01 00:00:00.0")}),
        "latitude": (np.asarray(lats, np.float64), {}),
        "longitude": (np.asarray(lons, np.float64), {}),
        "t2m": packed(250.0 + 0.1 * t + 0.2 * (lat2 - 70.0) + 0.05 * (lon2 - 10.0), 1e-3, 260.0),
        "u10": packed(5.0 + 0.01 * lon2 + 0.1 * t, 1e-4, 5.0),
        "v10": packed(-2.0 + 0.02 * lat2 + 0.0 * t, 1e-4, -2.0),
        "ssrd": (np.broadcast_to(3600.0 * (50.0 + t), shape).copy(), {}),
        "sf": (np.full(shape, 3600.0 * 1e-7), {}),
    }


class ForcingFiles:
    """The phase's forcing archives and ERA5 files, by path. Where h5py is
    installed they are files, written and read by the port's own functions;
    where it is not (the card machines so far), in-memory stand-ins take the
    place of ``forcing_file.read_forcing_archive``,
    ``forcing_file.write_forcing_archive`` and ``era5.read_era5_variables``
    for the phase, holding each archive's (time, fields) and each ERA5
    file's variables by path; nothing else is patched."""

    def __init__(self, files: bool) -> None:
        self.files = files
        self.archives = {}
        self.era5_files = {}
        self._saved = None

    def _write_archive(self, path, time, fields) -> None:
        time = np.asarray(time, dtype=np.float64)
        held = {}
        for name, series in fields.items():
            held[name] = np.asarray(series, dtype=np.float64)
            if held[name].shape[0] != time.shape[0]:
                raise ValueError(f"field {name!r} has {held[name].shape[0]} steps, time has {time.shape[0]}")
        self.archives[str(path)] = (time, held)

    def _read_archive(self, path) -> tuple:
        return self.archives[str(path)]

    def _read_era5(self, path) -> dict:
        return self.era5_files[str(path)]

    def write_era5(self, path, variables: dict) -> None:
        """An ERA5 file of ``variables`` (name -> (values, attributes))."""
        if not self.files:
            self.era5_files[str(path)] = variables
            return
        import h5py

        with h5py.File(path, "w") as handle:
            for name, (values, attrs) in variables.items():
                dataset = handle.create_dataset(name, data=values)
                for key, value in attrs.items():
                    dataset.attrs[key] = value

    def __enter__(self) -> "ForcingFiles":
        if not self.files:
            self._saved = (forcing_file.read_forcing_archive, forcing_file.write_forcing_archive,
                           era5.read_era5_variables)
            forcing_file.read_forcing_archive = self._read_archive
            forcing_file.write_forcing_archive = self._write_archive
            era5.read_era5_variables = self._read_era5
        return self

    def __exit__(self, *exc) -> None:
        if self._saved is not None:
            (forcing_file.read_forcing_archive, forcing_file.write_forcing_archive,
             era5.read_era5_variables) = self._saved
            self.archives, self.era5_files = {}, {}


def host_interp(time, series, t: float, periodic: bool):
    """The host's blend of one field at time t, in numpy float64: the JAX
    package's ``ForcingProvider._interp``, written out."""
    t0, t1 = float(time[0]), float(time[-1])
    if periodic and t1 > t0:
        t = t0 + (t - t0) % (t1 - t0)
    t = min(max(t, t0), t1)
    idx = min(max(int(np.searchsorted(time, t, side="right") - 1), 0), len(time) - 1)
    if idx == len(time) - 1:
        return series[idx]
    span = time[idx + 1] - time[idx]
    w = (t - time[idx]) / span if span > 0 else 0.0
    return (1.0 - w) * series[idx] + w * series[idx + 1]


def check_provider(device, forcing_dir: Path) -> None:
    """Leg 1: ForcingProvider on the card at 256^2 and 1024^2, clamped and
    periodic: every plane of both forcings at each probe time against the
    host's numpy float64 blend rounded to float32 (expected 0, failing
    above 0)."""
    for n in (N, N4):
        path = str(forcing_dir / f"provider_{n}.h5")
        fields = archive_fields(n, n, ARCHIVE_TIMES, list(ARCHIVE_RANGES), seed=n)
        forcing_file.write_forcing_archive(path, ARCHIVE_TIMES, fields)
        for periodic in (False, True):
            provider = forcing_file.ForcingProvider(path, periodic=periodic, device=device)
            for label, t in PROVIDER_PROBES:
                got = {**vars(provider.thermo_forcing(t, n, n)), **vars(provider.dynamics_forcing(t, n, n))}
                worst = 0.0
                for name, plane in got.items():
                    want = host_interp(ARCHIVE_TIMES, fields[name], t, periodic).astype(np.float32)
                    if plane.dtype != torch.float32 or plane.device.type != device.type:
                        raise AssertionError(f"provider {name}: {plane.dtype} on {plane.device}")
                    worst = max(worst, float(np.abs(plane.cpu().numpy().astype(np.float64) - want).max()))
                log("check", (
                    f"forcing provider {n}x{n} {'periodic' if periodic else 'clamped'} {label} (t={t:g} s): "
                    f"12 planes, max_abs_err={worst:.3e} against the host float64 blend rounded to float32 "
                    f"(tol 0) {'ok' if worst == 0.0 else 'FAIL'}"
                ))
                if worst != 0.0:
                    raise AssertionError(f"forcing provider {n}x{n} at t={t}: error {worst:.3e}")
            del provider
        del fields


def trace_archive_box(out_dir: Path, device) -> int:
    """One step of run/box.cfg on an archive through the CLI on ``device``,
    under ``profiling.device_trace`` into ``out_dir`` with the step's run in
    ``profiling.annotate(TRACE_ANNOTATION)``. ``check_forcing_files`` runs it
    on the card in a process of its own (``chip_smoke.py --trace-archive-box
    DIR``): a profiler session slows the host's later launches, and CUPTI now
    and then stops recording for the rest of a process."""
    files = importlib.util.find_spec("h5py") is not None
    with ForcingFiles(files), CliFiles(files):
        archive = str(out_dir / "box_archive.h5")
        forcing_file.write_forcing_archive(archive, ARCHIVE_TIMES, archive_fields(N, N, ARCHIVE_TIMES,
                                                                                  list(ARCHIVE_RANGES), seed=1))
        argv = ["--config-file", str(RUN_DIR / "box.cfg"), f"--dynamics.forcing=archive:{archive}",
                "--model.stop=600"]
        cwd = Path.cwd()
        os.chdir(out_dir)
        try:
            with profiling.device_trace(str(out_dir / "trace"), device=device):
                with profiling.annotate(TRACE_ANNOTATION):
                    rc = run_coupled(["nextsim", *argv], device=device)
        finally:
            os.chdir(cwd)
    return rc


def check_trace(workdir: Path) -> None:
    """Leg 6: the traced step (``trace_archive_box``, its own process): the
    trace names the annotation and the box schedule's first kernel
    (fused_dynamics on the H100, or mevp_tiled)."""
    out_dir = workdir / "traced"
    out_dir.mkdir()
    done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trace-archive-box", str(out_dir)],
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"the traced archive box step exited {done.returncode}: {done.stderr[-2000:]}")
    (path,) = list((out_dir / "trace").glob("trace_*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    kernel = box_kernels(torch.device("cuda", 0))[0]
    found = [e for e in kernels if kernel in e.get("name", "")]
    annotated = [e for e in events if e.get("name") == TRACE_ANNOTATION]
    log("check", (
        f"traced archive box step ({path.stat().st_size / 1e6:.1f} MB, {len(events)} events, {len(kernels)} kernel "
        f"events): annotation {TRACE_ANNOTATION!r} {len(annotated)}x, {kernel} kernels {len(found)} "
        f"({found[0]['name'][:60] if found else 'none'}) {'ok' if found and annotated else 'FAIL'}"
    ))
    if not (found and TRACE_ANNOTATION in names):
        raise AssertionError(f"the trace of the archive box step names no {kernel} kernel or no annotation")


def check_forcing_files(device, smi: str) -> dict:
    """Phase: the file forcings (ROADMAP M8b part 2) on the card in float32,
    in a temporary directory. (1) The provider's device blend against the
    host's at 256^2 and 1024^2 (expected 0). (2) ``archive:`` runs through
    the CLI on 6-hourly records of all twelve fields that vary in time and
    space: run/box.cfg and run/arctic.cfg as they stand, run/arctic.cfg on
    2 x 2 ranks cut to 12 steps, and health at 256^2 with the step poisoned
    on retry-halved (the replay reads the archive at 0, 600, 600, 900 and
    1200 s); (3) an ``era5:`` run of run/arctic.cfg, the ERA5 variables
    regridded onto its 256^2 centres; (4) BASELINE config 5's size (4096^2
    on 2 x 2 ranks, 2 steps, a probe and a checkpoint every step) on 3
    records of six fields. Each run's final state, checkpoints and rows
    against a direct loop fed the same provider's forcing (expected 0), the
    2 x 2 run against the single-device one, the launches of each run
    (paths ``files_*``); (5) the CLI's ms per step against the bare step in
    turns, its forcing scope, and the provider's refresh alone; (6) one
    traced step. Returns the launch counts by path."""
    files = importlib.util.find_spec("h5py") is not None
    if not files:
        log("files", (
            "forcing archive and ERA5 file I/O not exercised on the card: no h5py here, so in-memory stand-ins "
            "take the place of forcing_file.read_forcing_archive, forcing_file.write_forcing_archive and "
            "era5.read_era5_variables (and CliFiles' recorders of the checkpoint and diagnostics writers); "
            "nothing else is patched"
        ))
    tiled = ("mevp_tiled", "dg1_sample_cfl", "transport_tiled")
    boxed = box_kernels(device)
    ho = ("ho_single", "transport_tiled")
    counts = {}
    with tempfile.TemporaryDirectory() as tmp, ForcingFiles(files) as ffiles, CliFiles(files) as rec:
        # The runs' directory, whose .chk and .h5 files CliFiles collects;
        # the forcing files apart.
        workdir, forcing_dir = Path(tmp) / "runs", Path(tmp) / "forcing"
        workdir.mkdir()
        forcing_dir.mkdir()
        t0 = time.perf_counter()
        check_provider(device, forcing_dir)
        log("time", f"check_forcing_files provider: {time.perf_counter() - t0:.1f} s")

        archive = str(forcing_dir / "archive_256.h5")
        forcing_file.write_forcing_archive(archive, ARCHIVE_TIMES, archive_fields(N, N, ARCHIVE_TIMES,
                                                                                  list(ARCHIVE_RANGES), seed=1))
        forcing = [f"--dynamics.forcing=archive:{archive}"]
        box = ["--config-file", str(RUN_DIR / "box.cfg")] + forcing
        arctic = ["--config-file", str(RUN_DIR / "arctic.cfg")] + forcing
        # 2: run/box.cfg and run/arctic.cfg on the archive, each twice in
        # turns with the bare step.
        for path, argv, kernels in (("files_box", box, boxed), ("files_arctic", arctic, ho)):
            t0 = time.perf_counter()
            setup, run = cli_against_loop(path, argv, kernels, device, workdir, rec)
            counts[path] = run.counts
            cli_in_turns(path, argv, setup, run, device, workdir, rec, smi)
            log("time", f"check_forcing_files {path}: {time.perf_counter() - t0:.1f} s")
            del setup, run

        # run/arctic.cfg on 2 x 2 ranks, 12 steps, against a loop of the
        # global-shaped step and the single-device CLI cut to 12 steps.
        t0 = time.perf_counter()
        cut, grid = ["--model.stop=7200"], ["--parallel.mode=shardmap", "--parallel.mesh_shape=2x2"]
        setup, run = cli_against_loop("files_arctic_2x2", arctic + cut + grid, ho, device, workdir, rec)
        counts["files_arctic_2x2"] = run.counts
        single = cli_run(arctic + cut, device, workdir, rec)
        compare_host("files_arctic_2x2 final vs the single-device CLI run", run.checkpoints["coupled_restart.chk"][1],
                     single.checkpoints["coupled_restart.chk"][1])
        cli_times("files_arctic_2x2", run, setup.n_steps, setup, smi, {
            "bare step (resident blocks)": bare_ms(setup, 4), **isolated_times(setup)})
        log("time", f"check_forcing_files files_arctic_2x2: {time.perf_counter() - t0:.1f} s")
        del setup, run, single

        # Health at 256^2 on the archive, the step poisoned on its second
        # full call: the replay reads the archive at dt/2 steps.
        t0 = time.perf_counter()
        original_step, original_read = CoupledModel.step, forcing_file.ForcingProvider.thermo_forcing
        calls, reads = {"full": 0, "half": 0}, []

        def poisoned(self, state, phys, dyn, dt, *args, **kwargs):
            out = original_step(self, state, phys, dyn, dt, *args, **kwargs)
            calls["full" if dt == DT else "half"] += 1
            if dt == DT and calls["full"] == 2:
                out = replace(out, hice=out.hice * float("nan"))
            return out

        def read(self, t, nx, ny):
            reads.append(t)
            return original_read(self, t, nx, ny)

        argv_retry = box + list(CLI_HEALTH_ARGS[1:]) + ["--model.on_nonfinite=retry-halved"]
        CoupledModel.step, forcing_file.ForcingProvider.thermo_forcing = poisoned, read
        try:
            retry = cli_run(argv_retry, device, workdir, rec)
        finally:
            CoupledModel.step, forcing_file.ForcingProvider.thermo_forcing = original_step, original_read
        cli_expect("files_health_retry", retry, boxed)
        counts["files_health_retry"] = retry.counts
        # configure reads at start; the loop at each (half) step's start.
        if calls != {"full": 3, "half": 2} or reads != [0.0, 0.0, DT, DT, 1.5 * DT, 2 * DT]:
            raise AssertionError(f"health retry-halved on the archive: steps {calls}, archive read at {reads}")
        setup = cli_setup(argv_retry, device)
        ref = direct_loop(setup, [DT, DT / 2, DT / 2, DT], {1, 2, 3})
        compare_host("files_health_retry final vs the direct loop dt, dt/2, dt/2, dt on the archive",
                     retry.checkpoints["coupled_restart.chk"][1], ref[3])
        compare_rows("files_health_retry", retry.rows, ref, DT)
        log("slice", (
            f"health on the archive: retry-halved replayed step 2 as {calls['half']} half steps, the archive read "
            f"at {reads} s"
        ))
        log("time", f"check_forcing_files health: {time.perf_counter() - t0:.1f} s")
        del setup, ref, retry

        # 3: era5: on run/arctic.cfg's window, regridded onto its centres.
        t0 = time.perf_counter()
        era5_path = str(forcing_dir / "era5.nc")
        ffiles.write_era5(era5_path, era5_variables(ERA5_LATS, ERA5_LONS, ERA5_HOURS))
        argv = ["--config-file", str(RUN_DIR / "arctic.cfg"), f"--dynamics.forcing=era5:{era5_path}",
                f"--dynamics.era5_archive={forcing_dir / 'era5_forcing.h5'}"]
        setup, run = cli_against_loop("files_era5_arctic", argv, ho, device, workdir, rec)
        counts["files_era5_arctic"] = run.counts
        provider = setup.provider
        log("slice", (
            f"files_era5_arctic: the archive of {len(provider.time)} hourly records of {sorted(provider.names)} "
            f"on {provider.shape}; tair {provider.fields['tair'].min():.3f}..{provider.fields['tair'].max():.3f} C"
        ))
        cli_times("files_era5_arctic", run, setup.n_steps, setup, smi, {"bare step": bare_ms(setup, setup.n_steps)})
        log("time", f"check_forcing_files files_era5_arctic: {time.perf_counter() - t0:.1f} s")
        del setup, run, provider

        # 4: config 5's size, 2 steps, probed and checkpointed every step.
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        archive16 = str(forcing_dir / "archive_16m.h5")
        forcing_file.write_forcing_archive(archive16, ARCHIVE_16M_TIMES, archive_fields(
            N16, N16, ARCHIVE_16M_TIMES, ARCHIVE_16M_FIELDS, seed=16))
        cfg = forcing_dir / "config5_archive.cfg"
        cfg.write_text(CLI_16M_CFG.replace("forcing = cyclone\n", f"forcing = archive:{archive16}\n"))
        argv = ["--config-file", str(cfg)]
        setup = cli_setup(argv, device)
        n = setup.n_steps
        log("slice", f"files_16m: {N16}^2 on 2x2 ranks, {n} steps, the archive's {len(ARCHIVE_16M_TIMES)} records "
                     f"of {ARCHIVE_16M_FIELDS}, health and checkpoints every step")
        run = cli_run(argv, device, workdir, rec)
        cli_expect("files_16m", run, tiled)
        counts["files_16m"] = run.counts
        ref = direct_loop(setup, [setup.dt] * n, set(range(1, n + 1)))
        for name, (t, host) in sorted(run.checkpoints.items()):
            compare_host(f"files_16m {name} vs a loop of ShardedCoupledModel.__call__", host,
                         ref[int(round(t / setup.dt))])
        del ref
        run.checkpoints = None
        cli_times("files_16m", run, n, setup, smi, {
            "bare step (resident blocks)": bare_ms(setup, n), **isolated_times(setup)})
        del setup, run
        ffiles.archives.pop(archive16, None)  # the stand-in's 2.4 GB
        torch.cuda.empty_cache()
        log("time", f"check_forcing_files files_16m: {time.perf_counter() - t0:.1f} s")

        # 6: one traced step.
        t0 = time.perf_counter()
        check_trace(Path(tmp))
        log("time", f"check_forcing_files trace: {time.perf_counter() - t0:.1f} s")
    return counts


SASS_FORMS = ("fma", "fma_imm", "mul_add")


def start_sass(library: Path) -> subprocess.Popen:
    """``cuobjdump -sass`` of the library, in the background: it takes ~10 s
    for the whole library, so it runs beside the checks."""
    tool = Path(cc._nvcc()).with_name("cuobjdump")
    return subprocess.Popen(
        [str(tool), "-sass", str(library)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )


def sass_report(job: subprocess.Popen) -> str:
    """FFMA, FMUL and FADD in the chain kernel's fma, fma_imm and mul_add
    forms, from ``start_sass``'s job; fails unless --fmad=false left the
    fma forms fused (FFMA) and the mul_add form unfused (FMUL and FADD, no
    FFMA)."""
    sass, errors = job.communicate()
    if job.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({job.returncode}): {errors}")
    counts = {}
    for section in sass.split("Function : ")[1:]:
        found = re.match(r"_ZN3nst12chain_kernelILi(\d)ELi(\d+)E", section)
        if found and roofline.LINKS[int(found.group(1))] in SASS_FORMS:
            form = f"{roofline.LINKS[int(found.group(1))]}/{found.group(2)}"
            counts[form] = {op: len(re.findall(rf"\b{op}\b", section)) for op in ("FFMA", "FMUL", "FADD")}
    expected = [f"{link}/{unroll}" for link in SASS_FORMS for unroll in roofline.UNROLLS]
    if sorted(counts) != sorted(expected):
        raise AssertionError(f"chain forms in the SASS: {sorted(counts)}, expected {expected}")
    for form, ops in counts.items():
        fused = not form.startswith("mul_add/")
        if fused != (ops["FFMA"] > 0) or (not fused and (ops["FMUL"] == 0 or ops["FADD"] == 0)):
            raise AssertionError(f"chain {form}: {ops} (fma must issue FFMA, mul_add FMUL + FADD only)")
    return "chain SASS (cuobjdump): " + "; ".join(
        f"{form}: " + ", ".join(f"{op} {n}" for op, n in ops.items()) for form, ops in sorted(counts.items())
    ) + " (fma and fma_imm fused, mul_add unfused under --fmad=false)"


def check_roofline(device, card: str) -> tuple:
    """The roofline path: the chain kernel against its plain version for
    every link and both unrolls, on seeded planes at 512^2 and a ragged
    shape; then, from zeroed launch counts, ``measure_vpu_peak`` (fma,
    fma_imm and mul_add) and ``measure_hbm_peak``, each held below the data
    sheet's peak. Returns (launch counts, chain's Row, measured ceilings)."""
    rng = np.random.default_rng(SEED + 13)
    err = 0.0
    for nx, ny in ((roofline.PEAK_N, roofline.PEAK_N), RAGGED):
        t = lambda x: torch.tensor(x, device=device, dtype=torch.float32)
        a, b = t(rng.uniform(0.5, 0.9999, (nx, ny))), t(rng.uniform(-1e-3, 1e-3, (nx, ny)))
        for unroll, iters in CHAIN_CHECK_ITERS.items():
            links = unroll * iters
            for link in roofline.LINKS:
                got = roofline.chain(a, b, link, iters, unroll)
                tag = f"chain {link} unroll {unroll} {nx}x{ny} ({links} links)"
                if link in ("fma", "fma_imm"):
                    ref = roofline.chain_reference(a.double(), b.double(), link, iters, unroll)
                    err = max(err, compare(f"{tag} vs float64", got, ref, 2 * links * 2.0**-24))
                else:
                    ref = roofline.chain_reference(a, b, link, iters, unroll)
                    err = max(err, compare(tag, got, ref, TOL_CHAIN))
    log("build", f"chain: tile {roofline.TILE[0]}x{roofline.TILE[1]} per block of 256 threads, 4 elements a thread")
    n, (unroll, iters) = roofline.PEAK_N, roofline.PEAK_CALLS[0]
    a, b = roofline._planes(device)
    # The plain version at the checks' 160 links (a K8 call's 1.6e6 would
    # take minutes of launches).
    plain_ms = time_ms(lambda: roofline.chain_reference(a, b, "fma", CHAIN_CHECK_ITERS[16], 16), 3)

    cc.reset_launches()
    peaks = roofline.measure_vpu_peak(device)
    hbm = roofline.measure_hbm_peak(device)
    torch.cuda.synchronize()
    counts = dict(cc.launches)
    if counts["chain"] == 0:
        raise AssertionError("measure_vpu_peak launched no chain kernel")
    fma, fma_imm, mul_add = (peaks[f"fp32_{link}_chain_ops_per_s"] for link in SASS_FORMS)
    log("roofline", (
        f"fp32 fma chain {fma:.4e} op/s, fma_imm chain {fma_imm:.4e} op/s, mul_add chain "
        f"{mul_add:.4e} op/s (mul_add / fma_imm {mul_add / fma_imm:.3f}), HBM streaming add "
        f"{hbm:.4e} B/s on {card}; best ms per call: "
        + ", ".join(f"{form} {ms:.4f}" for form, ms in peaks["ms"].items())
        + f"; {counts['chain']} chain launches"
    ))
    for what, rate, peak in (
        ("fma", fma, PEAK_FP32), ("fma_imm", fma_imm, PEAK_FP32), ("mul_add", mul_add, PEAK_FP32),
        ("HBM", hbm, PEAK_BYTES),
    ):
        if not 0 < rate < peak:
            raise AssertionError(
                f"{what} ceiling {rate:.4e} is not below the data sheet's {peak:.4e}: a counting fault"
            )
    work = (3 * n * n * 4, 2.0 * unroll * iters * n * n)
    ms = peaks["ms"][f"fma/{unroll}"]
    log("time", (
        f"chain: kernel {ms:.4f} ms per call ({unroll} x {iters} fma links at {n}x{n}), bound "
        f"{bound(*work)[0]:.4f} ms ({bound(*work)[1]}); plain {plain_ms:.4f} ms for 160 links at {n}x{n}"
    ))
    ceilings = {"bytes_per_s": hbm, "ops_per_s": mul_add, "fused_ops_per_s": fma_imm}
    return counts, Row(err, ms, plain_ms, *work, fused=True), ceilings


# -- periodic axes and the TVB limiter (M7c items 1-2) ------------------------------------------
#: Steps of each periodic or TVB path from zeroed launch counts (20 on the
#: earlier paths): every kernel of the path launches in each step.
TVB_STEPS = 3
#: The kernels of each schedule, and with the TVB limiter on a staged one.
SCHEDULE_KERNELS = {
    ("fused", "xla"): ("fused_dynamics",),
    ("pallas", "xla"): ("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage"),
    ("pallas-tiled", "tiled"): ("mevp_tiled", "dg1_sample_cfl", "transport_tiled"),
    ("pallas-tiled", "xla"): ("mevp_tiled", "dg1_sample_cfl", "dg1_rk_stage"),
    ("single", "tiled"): ("mevp_single", "dg1_sample_cfl", "transport_tiled"),
    ("single", "xla"): ("mevp_single", "dg1_sample_cfl", "dg1_rk_stage"),
}
#: The paths of phase check_tvb_periodic: (a) the 256^2 headline periodic in
#: both axes, dG1 rk2, with tvb_m = 0 and the middle M; (b) config 4's
#: 1024^2, periodic in both axes, dG2 rk3, the same two; (c) the 1024^2 ring
#: (lon 0-360, periodic in x, lat 60-85) with the coastline, without TVB and
#: with M = 0. Each on "auto" and on every explicit schedule that applies:
#: (path, mesh kind, tvb: None, 0.0 or "mid", backends, the schedule).
TVB_PATHS = [
    (f"tvb_{kind}_{name}_{m}", kind, tvb, backends, schedule)
    for kind, tvbs, schedules in (
        ("headline", ((0.0, "m0"), ("mid", "mmid")), (
            ("auto", {}, ("fused", "xla")),
            ("k1", {"mevp_backend": "pallas"}, ("pallas", "xla")),  # pinned: "pallas" takes fused there
            ("tiled_staged", {"mevp_backend": "pallas-tiled", "transport_backend": "xla"}, ("pallas-tiled", "xla")),
        )),
        ("config4", ((0.0, "m0"), ("mid", "mmid")), (
            ("auto", {}, ("pallas-tiled", "tiled")),
            ("k1", {"mevp_backend": "pallas"}, ("pallas", "xla")),
            ("tiled_staged", {"mevp_backend": "pallas-tiled", "transport_backend": "xla"}, ("pallas-tiled", "xla")),
        )),
    )
    for tvb, m in tvbs
    for name, backends, schedule in schedules
] + [
    ("ring_auto", "ring", None, {}, ("single", "tiled")),
    ("ring_single_staged", "ring", None, {"transport_backend": "xla"}, ("single", "xla")),
    ("ring_tiled", "ring", None, {"mevp_backend": "pallas-tiled"}, ("pallas-tiled", "tiled")),
    ("tvb_ring_auto_m0", "ring", 0.0, {}, ("single", "xla")),
    ("tvb_ring_tiled_m0", "ring", 0.0, {"mevp_backend": "pallas-tiled"}, ("pallas-tiled", "xla")),
]
PATH_KERNELS.update({
    path: SCHEDULE_KERNELS[schedule] + (
        ("dg1_limit",) if tvb is not None and schedule[1] == "xla" and schedule[0] != "fused" else ())
    for path, _, tvb, _, schedule in TVB_PATHS
})
K1_PINNED.update(path for path, kind, _, _, schedule in TVB_PATHS
                 if kind == "headline" and schedule == ("pallas", "xla"))
#: The new forms' rows of the kernels line: row -> (kernel, source, the
#: paths whose launches of that kernel are the form's). The periodic rows
#: count the launches of their kernel on the periodic paths (all of them);
#: the TVB rows those of the TVB paths, which are periodic too (their
#: closed instances, in transport_tvb.cu and transport_tiled_forms.cu, are
#: the cuda tests').
_TVB = [p for p, _, tvb, _, _ in TVB_PATHS if tvb is not None]
_ALL = [p for p, *_ in TVB_PATHS]
FORM_ROWS = {
    "mevp_stress periodic": ("mevp_stress", "nextsimdg_tpu_torch/csrc/mevp.cu", _ALL),
    "mevp_velocity periodic": ("mevp_velocity", "nextsimdg_tpu_torch/csrc/mevp.cu", _ALL),
    "dg1_sample_cfl periodic": ("dg1_sample_cfl", "nextsimdg_tpu_torch/csrc/transport.cu", _ALL),
    "dg1_rk_stage periodic": ("dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_periodic.cu", _ALL),
    "dg1_rk_stage tvb": ("dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_periodic.cu", _TVB),
    "mevp_tiled periodic": ("mevp_tiled", "nextsimdg_tpu_torch/csrc/mevp_tiled_periodic.cu", _ALL),
    "transport_tiled periodic": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_forms.cu", _ALL),
    "transport_tiled tvb": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_forms.cu", _TVB),
    "mevp_single periodic": ("mevp_single", "nextsimdg_tpu_torch/csrc/mevp_single_periodic.cu", _ALL),
}
FORM_ROWS.update({
    label: ("fused_dynamics", f"nextsimdg_tpu_torch/csrc/{source}", [f"fused_{key}", *paths])
    for key, (label, _, source, paths) in FUSED_FORMS.items()
})
#: Rows of the new forms, and per row the (periodic or TVB form, its
#: closed or untouched instance, plain version, (bytes, operations)) that
#: time_tvb_periodic times in turns.
TVB_FORMS = {}
TVB_TIMED = {}


def ring_mesh(n: int = None):
    """The 360 degree lon-lat ring (lat 60-85), periodic in x; n^2
    elements (config 4's size by default)."""
    n = N4 if n is None else n
    return SphericalMesh(n, n, lon0=0.0, lon1=360.0, lat0=60.0, lat1=85.0, periodic_x=True)


def with_fronts(state, seed: int):
    """``state`` with fronts: a seeded patch of thicker, looser ice with more
    snow, and seeded sub-element moments, so that the TVB limiter has
    slopes to cut."""
    nx, ny = state.hice.shape[-2:]
    rng = np.random.default_rng(seed)
    patch = np.zeros((nx, ny), dtype=np.float32)
    i0, j0 = rng.integers(nx // 8, nx // 2), rng.integers(ny // 8, ny // 2)
    patch[i0: i0 + nx // 3, j0: j0 + ny // 3] = 1.0
    device = state.hice.device
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)

    def front(c, jump):
        c = c.clone()
        c[0] += jump * t(patch)
        c[1:] = t(rng.normal(0.0, 0.02 * abs(jump), tuple(c[1:].shape)))
        return c

    return replace(state, hice=front(state.hice, 1.0), cice=front(state.cice, -0.4),
                   hsnow=front(state.hsnow, 0.05))


def middle_m(coeffs, mesh) -> float:
    """The TVB constant M at which about half of the elements of ``coeffs``
    (K, nx, ny) keep both linear moments within their tolerances M dx^2 and
    M dy^2 (per element on a graded or spherical mesh): the median of the
    larger of |psi1| / dx^2 and |psi2| / dy^2."""
    plane = lambda w: torch.as_tensor(
        np.broadcast_to(np.asarray(w, dtype=np.float64), (mesh.nx, mesh.ny)).copy())
    c = coeffs.double().cpu()
    ratio = torch.maximum(c[1].abs() / plane(mesh.dx) ** 2, c[2].abs() / plane(mesh.dy) ** 2)
    return float(ratio[ratio > 0].median())


def tvb_shares(transport, tracers) -> tuple:
    """(cut, kept): the shares of elements where the TVB limiter (plain)
    changes a linear moment of some tracer, and where it changes none."""
    stacked = torch.stack([tracers.hice, tracers.cice, tracers.hsnow], dim=1)
    limited = transport.limit_slopes(stacked)
    cut = (limited[1:3] != stacked[1:3]).any(dim=0).any(dim=0)
    share = float(cut.float().mean())
    return share, 1.0 - share


def tvb_path_model(device, kind: str, tvb_m, backends: dict):
    """(model, state, phys, dyn, do_thermo) of a TVB or periodic path."""
    if kind == "headline":
        mesh = RectMesh(N, N, dx=512e3 / N, dy=512e3 / N, periodic_x=True, periodic_y=True)
        model = CoupledModel(mesh, degree=1, n_subcycles=N_SUBCYCLES, tvb_m=tvb_m, **backends)
        state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, sst0=-1.6, sss0=32.0,
                                    device=device, dtype=torch.float32)
        full = lambda value: torch.full((N, N), value, device=device, dtype=torch.float32)
        dyn = DynamicsForcing(u_atm=full(8.0), v_atm=full(2.0), u_ocean=full(0.02), v_ocean=full(0.0))
        return model, with_fronts(state, SEED + 30), None, dyn, False
    if kind == "config4":
        mesh = RectMesh(N4, N4, dx=4e3, dy=4e3, periodic_x=True, periodic_y=True)
        model, state, phys, dyn = coupled_model(device, mesh, None, degree=2, tvb_m=tvb_m, **backends)
        return model, with_fronts(state, SEED + 31), phys, dyn, True
    model, state, phys, dyn = coupled_model(device, ring_mesh(), synthetic_coastline(N4), tvb_m=tvb_m, **backends)
    return model, with_fronts(state, SEED + 32), phys, dyn, True


def tvb_plain(model, state, phys, dyn, do_thermo):
    state = model.step_dynamics(state, dyn, DT, phase=cc.fused_dynamics_reference)
    return model.step_thermo(state, phys, DT) if do_thermo else state


def check_tvb_paths(device) -> dict:
    """Each TVB and periodic path (TVB_PATHS) on its schedule: one step
    against the plain path on the card, then TVB_STEPS steps from zeroed
    launch counts (finite, bounded, land untouched, every kernel of the
    path launched). The middle M of a kind comes from the |psi1| of the
    hice that enters its steps (``middle_m``), and each TVB path prints the
    shares of elements its limiter cuts and keeps on the tracers that enter
    the step. Returns the counts by path."""
    counts, mid = {}, {}
    for path, kind, tvb, backends, expected in TVB_PATHS:
        tvb_m = mid[kind] if tvb == "mid" else tvb
        model, state, phys, dyn, do_thermo = tvb_path_model(device, kind, tvb_m, backends)
        mesh = model.mesh
        schedule = model.schedule(device)
        phase = K1_SPLIT if path in K1_PINNED else None
        log("slice", (
            f"{path}: {mesh.nx}x{mesh.ny} {type(mesh).__name__} periodic "
            f"({mesh.periodic_x}, {mesh.periodic_y}), dG{model.transport.basis.degree} "
            f"{model.transport.scheme}, tvb_m {tvb_m}, schedule {schedule}{', K1 pinned' if phase else ''}"
        ))
        if schedule != (("fused", "xla") if phase else expected):
            raise AssertionError(f"{path} does not run {expected}: {schedule}")
        got = path_step(model, state, phys, dyn, do_thermo, phase)
        ref = tvb_plain(model, state, phys, dyn, do_thermo)
        if do_thermo:
            compare_step(f"{path}.step", got, ref)
        else:
            for name, g, r in leaves(got, ref):
                compare(f"{path}.step.{name}", g, r, TOL_STEP_MEVP if name.startswith("velocity") else TOL_STEP_TRACER)
        if tvb == 0.0 and kind not in mid:
            mid[kind] = middle_m(state.hice, mesh)
            log("slice", f"{kind}: the middle M from the step's |psi1|: {mid[kind]:.4e}")
        if tvb is not None:
            cut, kept = tvb_shares(model.transport, state)
            log("slice", f"{path}: the limiter cuts {cut:.4f} of the elements and keeps {kept:.4f} of the step's tracers")
            if tvb == "mid" and not (cut > 0.05 and kept > 0.05):
                raise AssertionError(f"{path}: the middle M does not take both branches ({cut:.4f} cut)")
        counts[path] = drive_path(path, model, state, phys, dyn, do_thermo, n_steps=TVB_STEPS, phase=phase)
    return counts


def periodic_inputs(nx, ny, device, seed, spherical=False, degree=1):
    """``tiled_inputs`` on the periodic counterpart of its mesh: uniform
    periodic in both axes, or the ring (periodic in x) with the coastline;
    (model, carry, consts, psi, faces)."""
    model, carry, _, _, _ = tiled_inputs(nx, ny, device, seed, spherical)
    mesh = ring_mesh(nx) if spherical else RectMesh(nx, ny, 4e3, 4e3, periodic_x=True, periodic_y=True)
    model = CoupledModel(mesh, degree=degree, n_subcycles=N_SUBCYCLES, ocean_mask=model.ocean_mask)
    rng = np.random.default_rng(seed + 200)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    forcing = DynamicsForcing(
        u_atm=t(rng.normal(6.0, 2.0, (nx, ny))), v_atm=t(rng.normal(3.0, 2.0, (nx, ny))),
        u_ocean=t(rng.normal(0.0, 0.05, (nx, ny))), v_ocean=t(rng.normal(0.0, 0.05, (nx, ny))),
    )
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(VelocityState(*carry), t(rng.uniform(0.2, 2.0, (nx, ny))),
                                    t(rng.uniform(0.3, 1.0, (nx, ny))), forcing, mask, DT)
    k = model.transport.basis.n_dofs
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, nx, ny)), rng.normal(0.0, 0.3, (k - 1, 3, nx, ny))]))
    faces = model.face_masks(device=device, dtype=torch.float32) or (torch.ones_like(carry[0]),) * 2
    return model, carry, consts, psi, faces


def closed_twin(model, tvb_m=None):
    """The model on the closed counterpart of its mesh (the closed instance)."""
    m = model.mesh
    mesh = (spherical_mesh(m.nx, m.ny) if isinstance(m, SphericalMesh)
            else RectMesh(m.nx, m.ny, m.dx, m.dy))
    return CoupledModel(mesh, degree=model.transport.basis.degree, n_subcycles=N_SUBCYCLES,
                        ocean_mask=model.ocean_mask, tvb_m=tvb_m)


def tvb_limit_ops(degree: int) -> int:
    """float32 operations of dg1_limit an element and tracer: 4 mean
    differences, each linear moment's tolerance test and minmod (3 signs, 2
    compares, 3 absolute values, 2 minima, a multiply and 2 selects), at dG2
    the cut test (2 differences, 2 absolute values, 2 compares) and 3
    multiplies, then the positivity limiter."""
    positivity = stage_cell_ops(degree, False, True) - stage_cell_ops(degree, False, False)
    return 4 + 2 * 14 + (9 if degree == 2 else 0) + positivity


def timed_form(label: str, err: float, form, closed, plain, work: tuple) -> None:
    """Registers a new form's row: its check error now, its times in turns
    with its closed (or untouched) instance in time_tvb_periodic."""
    TVB_FORMS[label] = Row(err, 0.0, 0.0, *work)
    TVB_TIMED[label] = (form, closed, plain)


def check_tvb_launches(device) -> dict:
    """Each new form launch by launch against its plain version at its
    path's shape, and the periodic schedules against each other: the
    periodic mevp_stress, mevp_velocity, dg1_sample_cfl and dg1_rk_stage at
    256^2 (both axes), dg1_rk_stage's unlimited TVB stage and dg1_limit
    (an M that cuts some slopes and keeps others) at 256^2 dG1, 1024^2 dG2
    and on the 1024^2 ring (its tolerance planes), mevp_tiled (1 and 8
    subcycles) and transport_tiled (TVB at dG2 rk3, periodic at dG1 rk2) at
    1024^2, mevp_single (1 and 100 subcycles) on the ring. Each section is a
    function of its own, so that the timed closures keep its inputs.
    Returns the largest error per kernel."""
    errs = dict.fromkeys(("mevp_stress", "mevp_velocity", "dg1_sample_cfl", "dg1_rk_stage", "dg1_limit",
                          "mevp_tiled", "transport_tiled", "mevp_single"), 0.0)

    def held(kernel, tag, got, ref, tol):
        for i, (g, r) in enumerate(zip(got, ref)):
            errs[kernel] = max(errs[kernel], compare(f"{tag} [{i}]", g, r, tol))

    stream = cc._stream(device)
    _periodic_k1_launches(device, held, errs, stream)
    for tag, case in {
        f"{N}^2 dG1": (N, False, 1), f"{N4}^2 dG2": (N4, False, 2), f"{N4}^2 ring dG1": (N4, True, 1),
    }.items():
        _tvb_stage_launches(device, held, errs, stream, tag, *case)
    _periodic_tiled_launches(device, held, errs)
    _ring_single_launches(device, held, errs)
    for label, row in TVB_FORMS.items():
        TVB_FORMS[label] = replace(row, err=errs[label.split()[0]])
    torch.cuda.synchronize()
    return errs


def _periodic_k1_launches(device, held, errs, stream) -> None:
    """K1's four kernels periodic in both axes at 256^2."""
    n = N * N
    model, carry, consts, psi, faces = periodic_inputs(N, N, device, SEED + 40)
    solver, tr = model.mevp, model.transport
    ref = solver.stress_update(carry, consts)
    held("mevp_stress", f"mevp_stress {N}x{N} periodic", cc.mevp_stress(solver, carry, consts), ref, TOL_LAUNCH)
    carry_v = (carry[0], carry[1], *ref[:3])
    nodes = (ref[3], ref[4], DT)
    held("mevp_velocity", f"mevp_velocity {N}x{N} periodic", cc.mevp_velocity(solver, carry_v, consts, *nodes),
         solver.velocity_update(carry_v, consts, *nodes), TOL_LAUNCH)
    u, v = carry[0] * 5.0, carry[1] * 5.0
    speeds = cc.dg1_sample_cfl(tr, u, v)
    errs["dg1_sample_cfl"] = compare(f"dg1_sample_cfl {N}x{N} periodic speeds", speeds,
                                     cc.dg1_sample_cfl_reference(tr, u, v), 0.0)
    base = psi.flip(-1).contiguous()
    args = (tr, psi, base, carry[0], carry[1], *faces, 0.5, 0.5, 300.0)
    held("dg1_rk_stage", f"dg1_rk_stage {N}x{N} periodic", [cc.dg1_rk_stage(*args)],
         [cc.dg1_rk_stage_reference(*args)], TOL_LAUNCH)
    planes = tuple(p.clone() for p in carry)
    c_w, inv_drag = torch.empty_like(carry[0]), torch.empty_like(carry[0])
    scalars, tables, ptrs = cc._mevp_scalars(solver, DT), cc._dg1_tables(tr), cc._mevp_consts(consts)
    wrap = cc.wrap_bits(model.mesh)
    zeros2, out = torch.zeros(2, device=device), torch.empty_like(psi)

    def half(name, w):
        return lambda: cc._mevp_half_(name, planes, ptrs, c_w, inv_drag, scalars, stream, None, w)

    def stage(w):
        return lambda: cc._dg1_rk_stage_(psi, base, carry[0], carry[1], *faces, None, out, 0.5, 0.5, 300.0,
                                         tables, stream, wrap=w)

    timed_form("mevp_stress periodic", errs["mevp_stress"], half("mevp_stress", wrap), half("mevp_stress", 0),
               lambda: solver.stress_update(carry, consts), (15 * 4 * n, OPS["stress"] * n))
    timed_form("mevp_velocity periodic", errs["mevp_velocity"], half("mevp_velocity", wrap),
               half("mevp_velocity", 0), lambda: solver.velocity_update(carry_v, consts, *nodes),
               (14 * 4 * n, OPS["velocity"] * n))
    timed_form("dg1_sample_cfl periodic", errs["dg1_sample_cfl"],
               lambda: cc._dg1_sample_cfl_(u, v, zeros2, tables, stream, wrap=wrap),
               lambda: cc._dg1_sample_cfl_(u, v, zeros2, tables, stream),
               lambda: cc.dg1_sample_cfl_reference(tr, u, v), (2 * 4 * n + 8, OPS["cfl"] * n))
    timed_form("dg1_rk_stage periodic", errs["dg1_rk_stage"], stage(wrap), stage(0),
               lambda: cc.dg1_rk_stage_reference(*args), stage_work(1, n, False, False, True))


def _tvb_stage_launches(device, held, errs, stream, tag, nx, spherical, degree) -> None:
    """The TVB form at one shape: the unlimited stage and dg1_limit, with M
    cutting some slopes and keeping others; at 256^2 its timed rows."""
    model, carry, consts, psi, faces = periodic_inputs(nx, nx, device, SEED + 41, spherical, degree)
    tr = model.transport
    tr.tvb_m = middle_m(psi[:, 0], model.mesh)
    base = psi.flip(-1).contiguous()
    args = (tr, psi, base, carry[0], carry[1], *faces, 0.5, 0.5, 300.0)
    unlimited = cc.dg1_rk_stage(*args, tvb=True)
    held("dg1_rk_stage", f"dg1_rk_stage TVB stage {tag}", [unlimited],
         [cc.dg1_rk_stage_reference(*args, tvb=True)], TOL_LAUNCH)
    limited = cc.dg1_limit(tr, unlimited)
    held("dg1_limit", f"dg1_limit {tag}", [limited], [cc.dg1_limit_reference(tr, unlimited)], TOL_LAUNCH)
    share = float((limited[1:3] != unlimited[1:3]).any(dim=0).float().mean())
    log("check", f"dg1_limit {tag}: M = {tr.tvb_m:.4e} cuts {share:.4f} of the element tracers, keeps {1 - share:.4f}")
    if not 0.05 < share < 0.95:
        raise AssertionError(f"dg1_limit {tag}: M does not take both branches")
    if nx != N:
        return
    n = N * N
    work = stage_work(1, n, False, False, True)
    limit_ops = stage_cell_ops(1, True, True) - stage_cell_ops(1, True, False)
    out = torch.empty_like(psi)
    wrap, tables = cc.wrap_bits(model.mesh), cc._dg1_tables(tr)

    def stage(tvb):
        return lambda: cc._dg1_rk_stage_(psi, base, carry[0], carry[1], *faces, None, out, 0.5, 0.5, 300.0,
                                         tables, stream, tvb=tvb, wrap=wrap)

    timed_form("dg1_rk_stage tvb", errs["dg1_rk_stage"], stage(True), stage(False),
               lambda: cc.dg1_rk_stage_reference(*args, tvb=True),
               (work[0], work[1] - cc.STAGE_TRACERS * limit_ops * n))
    # In place on a scratch copy: from its second call on the input is the
    # limited stage, which the limiter reads as it would any other.
    tolerances = tr.tvb_tolerances(device=device, dtype=torch.float32)
    scratch = unlimited.clone()
    timed_form("dg1_limit", errs["dg1_limit"], lambda: cc._dg1_limit_(scratch, tolerances, tables, stream, wrap),
               None, lambda: cc.dg1_limit_reference(tr, unlimited),
               ((2 * 3 - 1) * 3 * 4 * n, 3 * tvb_limit_ops(1) * n))


def _periodic_tiled_launches(device, held, errs) -> None:
    """mevp_tiled and transport_tiled at 1024^2, periodic in both axes
    (transport_tiled also in its TVB form at dG2 rk3)."""
    n = N4 * N4
    model, carry, consts, psi, faces = periodic_inputs(N4, N4, device, SEED + 42)
    solver, closed = model.mevp, closed_twin(model)
    for n_sub, tol in ((1, TOL_LAUNCH), (TILED_SUBCYCLES, TOL_STEP_MEVP)):
        got = mt.mevp_subcycles_tiled(solver, carry, consts, DT, n_sub)
        ref = mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, n_sub)
        k1 = cc.mevp_subcycles(solver, carry, consts, DT, n_sub)
        for name, g, r, q in zip(VELOCITY, got, ref, k1):
            tag = f"mevp_tiled {N4}x{N4} periodic N={n_sub} {name}"
            held("mevp_tiled", tag, [g], [r], tol)
            same_schedule(tag, g, q)
    timed_form("mevp_tiled periodic", errs["mevp_tiled"],
               lambda: mt.mevp_subcycles_tiled(solver, carry, consts, DT, TILED_SUBCYCLES),
               lambda: mt.mevp_subcycles_tiled(closed.mevp, carry, consts, DT, TILED_SUBCYCLES),
               lambda: mt.mevp_subcycles_tiled_reference(solver, carry, consts, DT, TILED_SUBCYCLES),
               ((5 + 7 + 5) * 4 * n, TILED_SUBCYCLES * (OPS["stress"] + OPS["velocity"]) * n))
    tr, closed_tr = model.transport, closed.transport
    targs = (tr, psi, carry[0], carry[1], 60.0, 1, faces)
    got = tt.transport_substeps_tiled(*targs)
    held("transport_tiled", f"transport_tiled {N4}x{N4} periodic dG1 rk2 k=1", [got],
         [tt.transport_substeps_tiled_reference(*targs)], TOL_LAUNCH)
    same_schedule(f"transport_tiled {N4}x{N4} periodic", got, cc.transport_substeps(*targs))
    timed_form("transport_tiled periodic", errs["transport_tiled"], lambda: tt.transport_substeps_tiled(*targs),
               lambda: tt.transport_substeps_tiled(closed_tr, *targs[1:]),
               lambda: tt.transport_substeps_tiled_reference(*targs),
               tiled_work(1, n, 1, cc._RK_STAGES[tr.scheme], False))
    model2, carry2, _, psi2, faces2 = periodic_inputs(N4, N4, device, SEED + 43, degree=2)
    tr2 = model2.transport
    tr2.tvb_m = 0.0
    untouched = closed_twin(model2).transport
    targs2 = (tr2, psi2, carry2[0] * 3.0, carry2[1] * 3.0, 60.0, 1, faces2)
    got = tt.transport_substeps_tiled(*targs2)
    held("transport_tiled", f"transport_tiled {N4}x{N4} periodic TVB dG2 rk3 k=1", [got],
         [tt.transport_substeps_tiled_reference(*targs2)], TOL_LAUNCH)
    same_schedule(f"transport_tiled {N4}x{N4} periodic TVB dG2", got, cc.transport_substeps(*targs2),
                  "the staged TVB schedule")
    work = tiled_work(2, n, 1, cc._RK_STAGES[tr2.scheme], False)
    timed_form("transport_tiled tvb", errs["transport_tiled"], lambda: tt.transport_substeps_tiled(*targs2),
               lambda: tt.transport_substeps_tiled(untouched, *targs2[1:]),
               lambda: tt.transport_substeps_tiled_reference(*targs2),
               (work[0], work[1] + 3 * 3 * tvb_limit_ops(2) * n))


def _ring_single_launches(device, held, errs) -> None:
    """mevp_single on the 1024^2 ring, against plain, K1's schedule and
    mevp_tiled."""
    n = N4 * N4
    model, carry, consts, _, _ = periodic_inputs(N4, N4, device, SEED + 44, spherical=True)
    solver, closed = model.mevp, closed_twin(model)
    config = single.tiling(N4, N4, single.sm_count(device), periodic=(True, False))
    log("check", f"mevp_single {N4}x{N4} ring: {config.tiles[0]}x{config.tiles[1]} tiles of {config.tile}")
    for n_sub, tol in ((1, TOL_LAUNCH), (N_SUBCYCLES, TOL_STEP_MEVP)):
        got = single.mevp_subcycles_single(solver, carry, consts, DT, n_sub)
        ref = single.mevp_single_reference(solver, carry, consts, DT, n_sub)
        k1 = cc.mevp_subcycles(solver, carry, consts, DT, n_sub)
        tiled = mt.mevp_subcycles_tiled(solver, carry, consts, DT, n_sub)
        for name, g, r, q, w in zip(VELOCITY, got, ref, k1, tiled):
            tag = f"mevp_single {N4}x{N4} ring N={n_sub} {name}"
            held("mevp_single", tag, [g], [r], tol)
            same_schedule(tag, g, q)
            same_schedule(tag, g, w, "mevp_tiled")
    timed_form("mevp_single periodic", errs["mevp_single"],
               lambda: single.mevp_subcycles_single(solver, carry, consts, DT, N_SUBCYCLES),
               lambda: single.mevp_subcycles_single(closed.mevp, carry, consts, DT, N_SUBCYCLES),
               lambda: single.mevp_single_reference(solver, carry, consts, DT, N_SUBCYCLES),
               ((5 + 12 + 5) * 4 * n, N_SUBCYCLES * (OPS["stress"] + OPS["velocity_metric"]) * n))


def check_tvb_periodic(device) -> tuple:
    """Phase: the periodic and TVB forms launch by launch, then their paths.
    Returns (counts by path, largest error per kernel)."""
    errs = check_tvb_launches(device)
    return check_tvb_paths(device), errs


def time_tvb_periodic(device, card: str) -> None:
    """Each new form in turns with its closed (or untouched) instance,
    back to back, and its plain version once; then the steps: the headline
    closed, periodic and periodic with TVB (M = 0) on K1's schedule, config
    4 at dG2 closed and periodic with TVB on "auto", and the ring against the
    closed window, in turns; one profile of the periodic TVB config-4
    step."""
    for label, (form, closed, plain) in TVB_TIMED.items():
        fns, reps = {"form": form, "plain": plain}, {"form": 50, "plain": None}
        if closed is not None:
            fns["closed"], reps["closed"] = closed, 50
        runs = time_in_turns(fns, reps)
        row = TVB_FORMS[label]
        TVB_FORMS[label] = replace(row, ms=sum(runs["form"]) / len(runs["form"]), plain_ms=runs["plain"][0])
        DEVICE_PROBES[f"{label.split()[0]} {label}"] = form
        if closed is not None:
            DEVICE_PROBES[f"{label.split()[0]} {label} (closed instance)"] = closed
        b = bound(row.n_bytes, row.n_ops)
        log("time", (
            f"{label}: form {', '.join(f'{m:.5f}' for m in runs['form'])} ms"
            + (f", closed instance {', '.join(f'{m:.5f}' for m in runs['closed'])} ms" if closed else "")
            + f" (in turns, back to back), plain {runs['plain'][0]:.4f} ms, bound {b[0]:.5f} ms ({b[1]}) on {card}"
        ))
    steps = {}
    for tag, kind, tvb_m, backends in (
        ("headline closed K1", "closed", None, {"mevp_backend": "pallas"}),
        ("headline periodic K1", "headline", None, {"mevp_backend": "pallas"}),
        ("headline periodic TVB K1", "headline", 0.0, {"mevp_backend": "pallas"}),
        ("headline periodic TVB auto", "headline", 0.0, {}),
    ):
        if kind == "closed":
            model, state, forcing = bench_model(device, N)
            state = with_fronts(state, SEED + 30)
        else:
            model, state, _, forcing, _ = tvb_path_model(device, kind, tvb_m, backends)
        # K1's split schedule: "pallas" takes fused_dynamics in these forms.
        phase = K1_SPLIT if tag.endswith("K1") else None
        steps[tag] = (lambda m=model, s=state, f=forcing, ph=phase: path_step(m, s, None, f, False, ph))
    runs = time_in_turns(steps, dict.fromkeys(steps, 10))
    for tag, ms in runs.items():
        report(f"{tag} step ({N}x{N}, dG1)", ms, N * N, card)
    closed4, state4, phys4, dyn4 = coupled_model(device, RectMesh(N4, N4, dx=4e3, dy=4e3), None, degree=2)
    state4 = with_fronts(state4, SEED + 31)
    periodic4 = tvb_path_model(device, "config4", 0.0, {})[0]
    ring = tvb_path_model(device, "ring", None, {})[0]
    window, state_w, phys_w, dyn_w = spherical_model(device, N4, mevp_backend="pallas")
    runs = time_in_turns({
        "config4 dG2 closed": lambda: closed4.step(state4, phys4, dyn4, DT),
        "config4 dG2 periodic TVB": lambda: periodic4.step(state4, phys4, dyn4, DT),
        "spherical window (closed)": lambda: window.step(state_w, phys_w, dyn_w, DT),
        "ring (periodic x)": lambda: ring.step(state_w, phys_w, dyn_w, DT),
    }, dict.fromkeys(("config4 dG2 closed", "config4 dG2 periodic TVB", "spherical window (closed)",
                      "ring (periodic x)"), 5))
    for tag, ms in runs.items():
        report(f"{tag} coupled step ({N4}x{N4}, auto)", ms, N4 * N4, card)
    profile(f"config4 dG2 periodic TVB coupled step ({N4}x{N4})", lambda: periodic4.step(state4, phys4, dyn4, DT))


# -- the HO solver's A-weighted and periodic forms (phase check_ho_forms) ---------
#: The paths of phase check_ho_forms: the battery's ho_coupled_1m_periodic
#: (config 4's 1024^2 mesh periodic in both axes, HO, "auto": ho_tiled and
#: transport_tiled's periodic qv form), the same with the TVB limiter (M = 0:
#: the qv TVB form), the HO 256^2 step periodic in both axes on ho_single
#: with the staged transport (dg1_rk_stage's periodic qv form), with and
#: without M = 0, and the A-weighted HO step at 1024^2 (ho_tiled) and 256^2
#: (ho_single): (path, n, periodic, A-weighted, tvb_m, backends, schedule).
HO_FORM_PATHS = [
    ("ho_coupled_1m_periodic", N4, True, False, None, {}, ("tiled", "tiled")),
    ("ho_coupled_1m_periodic_tvb", N4, True, False, 0.0, {}, ("tiled", "tiled")),
    ("ho_periodic_256_staged", N, True, False, None, {"mevp_backend": "pallas", "transport_backend": "xla"},
     ("single", "xla")),
    ("ho_periodic_256_staged_tvb", N, True, False, 0.0, {"mevp_backend": "pallas", "transport_backend": "xla"},
     ("single", "xla")),
    ("ho_coupled_1m_aweighted", N4, False, True, None, {}, ("tiled", "tiled")),
    ("ho_coupled_256_aweighted", N, False, True, None, {"mevp_backend": "pallas"}, ("single", "tiled")),
]
_HO_SCHEDULE_KERNELS = {
    ("tiled", "tiled"): ("ho_tiled", "transport_tiled"), ("single", "tiled"): ("ho_single", "transport_tiled"),
    ("single", "xla"): ("ho_single", "dg1_rk_stage"),
}
PATH_KERNELS.update({
    path: _HO_SCHEDULE_KERNELS[schedule] + (("dg1_limit",) if tvb is not None and schedule[1] == "xla" else ())
    for path, _, _, _, tvb, _, schedule in HO_FORM_PATHS
})
FORM_ROWS.update({
    "ho_single A-weighted": ("ho_single", "nextsimdg_tpu_torch/csrc/ho_single_forms.cu", ["ho_coupled_256_aweighted"]),
    "ho_single periodic": ("ho_single", "nextsimdg_tpu_torch/csrc/ho_single_forms.cu",
                           ["ho_periodic_256_staged", "ho_periodic_256_staged_tvb"]),
    "ho_tiled A-weighted": ("ho_tiled", "nextsimdg_tpu_torch/csrc/ho_tiled_forms.cu", ["ho_coupled_1m_aweighted"]),
    "ho_tiled periodic": ("ho_tiled", "nextsimdg_tpu_torch/csrc/ho_tiled_forms.cu",
                          ["ho_coupled_1m_periodic", "ho_coupled_1m_periodic_tvb"]),
    "dg1_rk_stage periodic qv": ("dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_periodic_qv.cu",
                                 ["ho_periodic_256_staged"]),
    "dg1_rk_stage periodic qv tvb": ("dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_periodic_qv.cu",
                                     ["ho_periodic_256_staged_tvb"]),
    "transport_tiled periodic qv": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_qv.cu",
                                    ["ho_coupled_1m_periodic"]),
    "transport_tiled periodic qv tvb": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_qv.cu",
                                        ["ho_coupled_1m_periodic_tvb"]),
})
#: The forms checked launch by launch: (periodic in both axes, A-weighted).
HO_FORMS = {"A-weighted": (False, True), "periodic": (True, False), "A-weighted periodic": (True, True)}


def ho_form_model(device, n: int, periodic: bool, weighted: bool, degree: int = 1, **kwargs):
    """A coupled HO model on an n^2 RectMesh of 4 km elements, periodic in
    both axes or closed, A-weighted or not (the HO solver selected through
    the registry, reset after the build)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        return CoupledModel(
            RectMesh(n, n, 4e3, 4e3, periodic_x=periodic, periodic_y=periodic), degree=degree,
            n_subcycles=N_SUBCYCLES, mevp_params=MEVPParams(a_weighted_stress=weighted), **kwargs,
        )
    finally:
        loader.reset()


def ho_form_inputs(n, device, seed, periodic, weighted, **kwargs):
    """Seeded HO inputs of a form at n^2: (model, carry, consts, psi, faces),
    with partial cover (A in [0.3, 1) and below 0.06 on the first quarter of
    the rows: some nodes below a_dyn_min) and a wind that varies from cell
    to cell, along the seams too (a periodic axis's wrap carries signal)."""
    return ho_seeded_inputs(ho_form_model(device, n, periodic, weighted, **kwargs), device, seed)


def ho_seeded_inputs(model, device, seed):
    """``ho_form_inputs``'s seeded carry, consts, tracers and random face
    masks on the n^2 mesh of an HO ``model``: (model, carry, consts, psi,
    faces)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, device=device, dtype=torch.float32)
    n = model.mesh.nx
    shape = (n, n)
    field = lambda s, m=0.0: mevp_ho.HOField(*(t(m + rng.normal(0.0, s, shape)) for _ in range(4)))
    state = mevp_ho.HOVelocityState(
        u=field(0.2), v=field(0.2), s11=t(rng.normal(0.0, 1e3, (3, *shape))),
        s22=t(rng.normal(0.0, 1e3, (3, *shape))), s12=t(rng.normal(0.0, 5e2, (3, *shape))),
    )
    forcing = mevp_ho.HODynamicsForcing(field(2.0, 6.0), field(2.0, 3.0), field(0.05), field(0.05))
    a = rng.uniform(0.3, 1.0, shape)
    a[: n // 4] = rng.uniform(0.0, 0.06, (n // 4, n))
    mask = model.node_mask(device=device, dtype=torch.float32)
    consts = model.mevp.step_consts(state, t(rng.uniform(0.0, 2.0, shape)), t(a), forcing, mask, DT)
    carry = (state.u, state.v, state.s11, state.s22, state.s12)
    k = model.transport.basis.n_dofs
    psi = t(np.concatenate([rng.uniform(0.1, 1.0, (1, 3, *shape)), rng.normal(0.0, 0.3, (k - 1, 3, *shape))]))
    faces = tuple(t((rng.uniform(size=shape) > 0.1).astype(np.float32)) for _ in range(2))
    return model, carry, consts, psi, faces


def ho_form_coverage(tag: str, solver, consts) -> None:
    """Logs (and requires) the partial cover of an A-weighted form's a_{k}."""
    a = torch.stack([consts[f"a_{k}"] for k in mevp_ho.PLANES])
    low = int(((a > 0) & (a < solver.params.a_dyn_min)).sum())
    inner = int(((a > 0.1) & (a < 0.99)).sum())
    log("check", f"{tag}: a_k in [{float(a.min()):.3f}, {float(a.max()):.3f}], {low} nodes below a_dyn_min, "
                 f"{inner} in (0.1, 0.99)")
    if not low or not inner:
        raise AssertionError(f"{tag}: the cover is not partial")


def check_ho_form_launches(device) -> dict:
    """Each new form launch by launch against its plain version at its
    path's shape, and the schedules against each other: ho_single at 256^2
    and ho_tiled at 1024^2 in the A-weighted, periodic and combined forms
    (one subcycle at TOL_LAUNCH, 100 at TOL_STEP_MEVP; ho_single against
    ho_tiled over 100 subcycles at 256^2 and ho_tiled's shipped window
    against 2 x 2 clusters, expected 0); dg1_rk_stage's periodic qv stage
    and its TVB stage with dg1_limit at 256^2; transport_tiled's periodic
    qv form (dG1 rk2, k = 1 and 4) and its TVB form at 1024^2, against the
    plain version and the staged schedule (expected 0). Registers each
    form's timed row. Returns the largest error per kernel."""
    errs = dict.fromkeys(("ho_single", "ho_tiled", "dg1_rk_stage", "dg1_limit", "transport_tiled"), 0.0)

    def against_plain(kernel, run, tag, solver, carry, consts, n_sub, **kw):
        got = run(solver, carry, consts, DT, n_sub, **kw)
        ref = mevp_ho.ho_subcycles_reference(solver, carry, consts, DT, n_sub)
        tol = TOL_LAUNCH if n_sub == 1 else TOL_STEP_MEVP
        for (name, g), (_, r) in zip(ho_planes(got), ho_planes(ref)):
            errs[kernel] = max(errs[kernel], compare(f"{tag} N={n_sub} {name}", g, r, tol))
        return got

    for form, (periodic, weighted) in HO_FORMS.items():
        for kernel, n, run, n_subs in (
            ("ho_single", N, hsc.ho_subcycles_single, (1, N_SUBCYCLES)),
            ("ho_tiled", N4, htc.ho_subcycles_tiled, (1, 13, N_SUBCYCLES)),
        ):
            model, carry, consts, _, _ = ho_form_inputs(n, device, SEED + 50, periodic, weighted)
            solver = model.mevp
            tag = f"{kernel} {n}x{n} {form}"
            if weighted:
                ho_form_coverage(tag, solver, consts)
            for n_sub in n_subs:
                got = against_plain(kernel, run, tag, solver, carry, consts, n_sub)
            if kernel == "ho_single":
                tiled = htc.ho_subcycles_tiled(solver, carry, consts, DT, N_SUBCYCLES)
                for (name, g), (_, w) in zip(ho_planes(got), ho_planes(tiled)):
                    same_schedule(f"{tag} N={N_SUBCYCLES} {name}", g, w, "ho_tiled")
            else:
                shipped = htc.ho_subcycles_tiled(solver, carry, consts, DT, 13)
                clusters = htc.ho_subcycles_tiled(solver, carry, consts, DT, 13, htc.CLUSTER_2X2)
                for (name, g), (_, w) in zip(ho_planes(clusters), ho_planes(shipped)):
                    same_schedule(f"{tag} {htc.CLUSTER_2X2} N=13 {name}", g, w, f"ho_tiled {htc.SHIPPED}")
            if form == "A-weighted periodic":
                continue
            # The timed row: the form in turns with the closed unweighted
            # instance on the same carry (its 29 consts).
            closed = ho_form_model(device, n, False, False).mevp
            closed_consts = {name: consts[name] for name in mevp_ho.HO_CONSTS}
            n_sub = N_SUBCYCLES if kernel == "ho_single" else htc.HALO
            planes = HO_PLANES_MOVED + (4 if weighted else 0)
            ops = n_sub * (OPS["ho_stress"] + OPS["ho_velocity"] + (4 if weighted else 0)) * n * n
            timed_form(
                f"{kernel} {form}", errs[kernel],
                lambda run=run, s=solver, c=carry, k=consts, m=n_sub: run(s, c, k, DT, m),
                lambda run=run, s=closed, c=carry, k=closed_consts, m=n_sub: run(s, c, k, DT, m),
                lambda s=solver, c=carry, k=consts, m=n_sub: mevp_ho.ho_subcycles_reference(s, c, k, DT, m),
                (planes * 4 * n * n, ops),
            )

    stream = cc._stream(device)
    _ho_qv_stage_launches(device, errs, stream)
    _ho_qv_tiled_launches(device, errs)
    for label in FORM_ROWS:
        if label in TVB_FORMS and label.startswith(("ho_", "dg1_rk_stage periodic qv", "transport_tiled periodic qv")):
            TVB_FORMS[label] = replace(TVB_FORMS[label], err=errs[label.split()[0]])
    torch.cuda.synchronize()
    return errs


def _ho_qv_stage_launches(device, errs, stream) -> None:
    """dg1_rk_stage's periodic qv stage (blended and first) and its TVB
    stage with dg1_limit (a middle M) at 256^2, dG1, on the CG2 samples of
    a seeded velocity."""
    n = N * N
    model, carry, _, psi, faces = ho_form_inputs(N, device, SEED + 51, True, False)
    tr = model.transport
    qv = mevp_ho.ho_velocity_to_quad(model.mesh, tr.basis, *(
        mevp_ho.HOField(*(5.0 * x for x in f.planes())) for f in carry[:2]))
    base = psi.flip(-1).contiguous()
    for a, b in ((0.0, 1.0), (0.5, 0.5)):
        args = (tr, psi, base, None, None, *faces, a, b, 300.0)
        err = compare(f"dg1_rk_stage {N}x{N} periodic qv a={a}", cc.dg1_rk_stage(*args, qv=qv),
                      cc.dg1_rk_stage_reference(*args, qv=qv), TOL_LAUNCH)
        errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], err)
    tr.tvb_m = middle_m(psi[:, 0], model.mesh)
    args = (tr, psi, base, None, None, *faces, 0.5, 0.5, 300.0)
    unlimited = cc.dg1_rk_stage(*args, qv=qv, tvb=True)
    errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], compare(
        f"dg1_rk_stage {N}x{N} periodic qv TVB stage", unlimited,
        cc.dg1_rk_stage_reference(*args, qv=qv, tvb=True), TOL_LAUNCH))
    limited = cc.dg1_limit(tr, unlimited)
    errs["dg1_limit"] = compare(f"dg1_limit {N}x{N} periodic (qv stage)", limited,
                                cc.dg1_limit_reference(tr, unlimited), TOL_LAUNCH)
    share = float((limited[1:3] != unlimited[1:3]).any(dim=0).float().mean())
    log("check", f"dg1_limit {N}x{N} periodic qv: M = {tr.tvb_m:.4e} cuts {share:.4f} of the element tracers")
    tables, wrap = cc._dg1_tables(tr), cc.wrap_bits(model.mesh)
    qv_ptrs = cc._dg1_qv(qv, (N, N), device, tr.basis.degree)
    out = torch.empty_like(psi)

    def stage(tvb, w):
        return lambda: cc._dg1_rk_stage_(psi, base, None, None, *faces, None, out, 0.5, 0.5, 300.0, tables,
                                         stream, qv=qv_ptrs, tvb=tvb, wrap=w)

    work = stage_work(1, n, True, False, True)
    limit_ops = stage_cell_ops(1, True, True) - stage_cell_ops(1, True, False)
    timed_form("dg1_rk_stage periodic qv", errs["dg1_rk_stage"], stage(False, wrap), stage(False, 0),
               lambda: cc.dg1_rk_stage_reference(*args, qv=qv), work)
    timed_form("dg1_rk_stage periodic qv tvb", errs["dg1_rk_stage"], stage(True, wrap), stage(True, 0),
               lambda: cc.dg1_rk_stage_reference(*args, qv=qv, tvb=True),
               (work[0], work[1] - cc.STAGE_TRACERS * limit_ops * n))


def _ho_qv_tiled_launches(device, errs) -> None:
    """transport_tiled's periodic qv form (dG1 rk2) at 1024^2, k = 1 and 4,
    and its TVB form (M = 0), against the plain version and the staged
    schedule; the timed rows in turns with the closed instances."""
    n = N4 * N4
    model, carry, _, psi, faces = ho_form_inputs(N4, device, SEED + 52, True, False)
    closed = ho_form_model(device, N4, False, False)
    tvb = ho_form_model(device, N4, True, False, tvb_m=0.0)
    closed_tvb = ho_form_model(device, N4, False, False, tvb_m=0.0)
    for k in (1, 4):
        qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, *(
            mevp_ho.HOField(*(k * x for x in f.planes())) for f in carry[:2]))
        for tag, tr in (("", model.transport), (" TVB", tvb.transport)):
            args = (tr, psi, None, None, DT / k, k, faces)
            got = tt.transport_substeps_tiled(*args, qv=qv)
            name = f"transport_tiled {N4}x{N4} periodic qv{tag} k={k}"
            errs["transport_tiled"] = max(errs["transport_tiled"], compare(
                name, got, tt.transport_substeps_tiled_reference(*args, qv=qv), TOL_STEP_TRACER))
            same_schedule(name, got, cc.transport_substeps(*args, qv=qv), "the staged qv transport")
    qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, *carry[:2])
    stages = cc._RK_STAGES[model.transport.scheme]
    work = tiled_work(1, n, 1, stages, True)
    for label, form, untouched in (
        ("transport_tiled periodic qv", model.transport, closed.transport),
        ("transport_tiled periodic qv tvb", tvb.transport, closed_tvb.transport),
    ):
        extra = 3 * len(stages) * tvb_limit_ops(1) * n if form.limits_slopes else 0
        timed_form(label, errs["transport_tiled"],
                   lambda tr=form: tt.transport_substeps_tiled(tr, psi, None, None, 60.0, 1, faces, qv=qv),
                   lambda tr=untouched: tt.transport_substeps_tiled(tr, psi, None, None, 60.0, 1, faces, qv=qv),
                   lambda tr=form: tt.transport_substeps_tiled_reference(tr, psi, None, None, 60.0, 1, faces, qv=qv),
                   (work[0], work[1] + extra))


def ho_form_path(device, n: int, periodic: bool, weighted: bool, **backends):
    """``bench_coupled_1m(high_order=True, periodic=, a_weighted=)`` at n^2:
    config 4's state and forcing, the HO solver selected through the
    registry (reset after the build); (model, state, phys, dyn)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        mesh = RectMesh(n, n, dx=4e3, dy=4e3, periodic_x=periodic, periodic_y=periodic)
        return coupled_model(device, mesh, None, mevp_params=MEVPParams(a_weighted_stress=weighted), **backends)
    finally:
        loader.reset()


def check_ho_form_paths(device) -> dict:
    """Each path of HO_FORM_PATHS on its schedule: one step against the
    plain path on the card, then 20 steps from zeroed launch counts (finite,
    bounded, every kernel of the path launched). Returns the counts by
    path."""
    counts = {}
    for path, n, periodic, weighted, tvb_m, backends, expected in HO_FORM_PATHS:
        model, state, phys, dyn = ho_form_path(device, n, periodic, weighted, tvb_m=tvb_m, **backends)
        if tvb_m is not None:
            state = with_fronts(state, SEED + 53)
        schedule = model.schedule(device)
        log("slice", (
            f"{path}: {n}x{n} HO, periodic {periodic}, A-weighted {weighted}, tvb_m {tvb_m}, schedule {schedule}"
        ))
        if not model.is_high_order or schedule != expected:
            raise AssertionError(f"{path} does not run {expected}: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)
    return counts


def check_ho_forms(device) -> tuple:
    """Phase: the A-weighted and periodic forms of ho_single and ho_tiled,
    and the periodic qv forms of dg1_rk_stage and transport_tiled, launch by
    launch, then their paths. Returns (counts by path, largest error per
    kernel)."""
    errs = check_ho_form_launches(device)
    return check_ho_form_paths(device), errs


def time_ho_forms(device, card: str) -> None:
    """ms per step of ho_coupled_1m_periodic beside ho_coupled_1m, of the
    A-weighted HO step beside the unweighted one at 1024^2 and of the
    periodic HO 256^2 staged step beside the closed one, in turns; one
    profile of ho_coupled_1m_periodic."""
    staged = {"transport_backend": "xla", "mevp_backend": "pallas"}
    for n, cases in (
        (N4, (("ho_coupled_1m", False, False, {}), ("ho_coupled_1m_periodic", True, False, {}),
              ("ho_coupled_1m_aweighted", False, True, {}))),
        (N, (("ho_coupled_256_staged", False, False, staged), ("ho_periodic_256_staged", True, False, staged))),
    ):
        steps = {tag: ho_form_path(device, n, periodic, weighted, **backends)
                 for tag, periodic, weighted, backends in cases}
        runs = time_in_turns(
            {tag: (lambda m=m, s=s, p=p, d=d: m.step(s, p, d, DT)) for tag, (m, s, p, d) in steps.items()},
            dict.fromkeys(steps, 10),
        )
        for tag, ms in runs.items():
            report(f"{tag} coupled step ({n}x{n}, {steps[tag][0].schedule(device)})", ms, n * n, card)
    model, state, phys, dyn = ho_form_path(device, N4, True, False)
    profile(f"ho_coupled_1m_periodic coupled step ({N4}x{N4}, {model.schedule(device)})",
            lambda: model.step(state, phys, dyn, DT))


# -- the HO solver on graded and spherical meshes (phase check_ho_metric) ----------
#: The paths of phase check_ho_metric, config 4's state and forcing with the HO
#: solver on a metric mesh: (a) the HO spherical coastline step (the lon-lat
#: window of coupled_1m_spherical at 1024^2 with synthetic_coastline, "auto":
#: ho_tiled's metric form and the closed metric qv transport_tiled), also
#: A-weighted; (b) the same window at 256^2 ("auto": ho_single's metric form
#: and transport_tiled; transport_backend "xla": dg1_rk_stage's metric qv
#: stage); (c) the 1024^2 ring (lon 0-360, lat 60-85, periodic in x) with the
#: coastline ("auto": ho_tiled's metric form wrapped in x and transport_tiled's
#: periodic metric qv form; "xla": dg1_rk_stage's periodic metric qv stage;
#: tvb_m = 0: its TVB stage and dg1_limit with the tolerance planes); (d) a
#: graded 256^2 RectMesh (dx graded along x, dy along y) on ho_single and
#: ho_tiled: (path, mesh kind, n, A-weighted, tvb_m, backends, the schedule).
HO_METRIC_PATHS = [
    ("ho_coupled_1m_spherical", "spherical", N4, False, None, {}, ("tiled", "tiled")),
    ("ho_coupled_1m_spherical_aweighted", "spherical", N4, True, None, {}, ("tiled", "tiled")),
    ("ho_spherical_256", "spherical", N, False, None, {}, ("single", "tiled")),
    ("ho_spherical_256_staged", "spherical", N, False, None, {"transport_backend": "xla"}, ("single", "xla")),
    ("ho_ring_1m", "ring", N4, False, None, {}, ("tiled", "tiled")),
    ("ho_ring_1m_staged", "ring", N4, False, None, {"transport_backend": "xla"}, ("tiled", "xla")),
    ("ho_ring_1m_tvb", "ring", N4, False, 0.0, {}, ("tiled", "xla")),
    ("ho_graded_256_single", "graded", N, False, None, {"mevp_backend": "pallas"}, ("single", "tiled")),
    ("ho_graded_256_tiled", "graded", N, False, None, {"mevp_backend": "pallas-tiled"}, ("tiled", "tiled")),
]
_HO_SCHEDULE_KERNELS[("tiled", "xla")] = ("ho_tiled", "dg1_rk_stage")
PATH_KERNELS.update({
    path: _HO_SCHEDULE_KERNELS[schedule] + (("dg1_limit",) if tvb is not None else ())
    for path, _, _, _, tvb, _, schedule in HO_METRIC_PATHS
})
FORM_ROWS.update({
    "ho_single metric": ("ho_single", "nextsimdg_tpu_torch/csrc/ho_single_metric.cu",
                         [p for p, *_, schedule in HO_METRIC_PATHS if schedule[0] == "single"]),
    "ho_tiled metric": ("ho_tiled", "nextsimdg_tpu_torch/csrc/ho_tiled_metric.cu",
                        [p for p, *_, schedule in HO_METRIC_PATHS if schedule[0] == "tiled"]),
    "dg1_rk_stage periodic metric qv": (
        "dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_periodic_qv_metric.cu", ["ho_ring_1m_staged"]),
    "dg1_rk_stage periodic metric qv tvb": (
        "dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_periodic_qv_metric.cu", ["ho_ring_1m_tvb"]),
    "transport_tiled periodic metric qv": (
        "transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_qv_metric.cu", ["ho_ring_1m"]),
})


def ho_metric_mesh(kind: str, n: int):
    """The n^2 metric mesh of a kind: the lon-lat window of
    coupled_1m_spherical, the 360 degree ring, or a graded RectMesh (dx from
    4 to 6 km along x, dy from 6 to 4 km along y)."""
    if kind == "spherical":
        return spherical_mesh(n)
    if kind == "ring":
        return ring_mesh(n)
    x = np.arange(n) / n
    return RectMesh(n, n, dx=4e3 * (1.0 + 0.5 * x), dy=4e3 * (1.5 - 0.5 * x))


def ho_metric_model(device, kind: str, n: int, weighted: bool = False, **backends):
    """Config 4's model, state and forcing with the HO solver (selected
    through the registry, reset after the build) on the metric mesh of a
    kind, with synthetic_coastline(n) on the lon-lat ones: (model, state,
    phys, dyn)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        ocean = None if kind == "graded" else synthetic_coastline(n)
        return coupled_model(device, ho_metric_mesh(kind, n), ocean,
                             mevp_params=MEVPParams(a_weighted_stress=weighted), **backends)
    finally:
        loader.reset()


def check_ho_metric_launches(device) -> dict:
    """Each metric form launch by launch against its plain version at its
    path's shape, and the schedules against each other: ho_single at 256^2
    on the spherical window (unweighted and A-weighted), the graded mesh and
    the ring, 1 subcycle at TOL_LAUNCH and 100 at TOL_STEP_MEVP, then
    against ho_tiled over 100 (expected 0); ho_tiled at 1024^2 on the window
    (both forms) and the ring, 1, 13 and 100 subcycles, and its 2 x 2
    clusters against the shipped window (expected 0); then the ring's qv
    forms (``_ho_metric_qv_launches``). Registers each form's timed row.
    Returns the largest error per kernel."""
    errs = dict.fromkeys(("ho_single", "ho_tiled", "dg1_rk_stage", "dg1_limit", "transport_tiled"), 0.0)
    sms = hsc.sm_count(device)

    def against_plain(kernel, run, tag, solver, carry, consts, n_sub):
        got = run(solver, carry, consts, DT, n_sub)
        ref = mevp_ho.ho_subcycles_reference(solver, carry, consts, DT, n_sub)
        tol = TOL_LAUNCH if n_sub == 1 else TOL_STEP_MEVP
        for (name, g), (_, r) in zip(ho_planes(got), ho_planes(ref)):
            errs[kernel] = max(errs[kernel], compare(f"{tag} N={n_sub} {name}", g, r, tol))
        return got

    def inputs(kind, n, weighted=False):
        return ho_seeded_inputs(ho_metric_model(device, kind, n, weighted)[0], device, SEED + 60)

    for n in (N, 2 * N):
        for weighted in (False, True):
            config = hsc.tiling(n, n, sms, weighted=weighted, metric=True)
            log("build", (
                f"ho_single metric form at {n}x{n}{' A-weighted' if weighted else ''}: {config.tiles[0]}x"
                f"{config.tiles[1]} tiles of {config.tile}, {config.threads} threads, {config.n_consts} const "
                f"planes {'in shared memory' if config.consts_shared else 'from global memory'}, "
                f"{config.shared_bytes()} B shared"
            ))
    timed = {}
    for kernel, n, run, cases, n_subs in (
        ("ho_single", N, hsc.ho_subcycles_single,
         (("spherical", False), ("spherical", True), ("graded", False), ("ring", False)), (1, N_SUBCYCLES)),
        ("ho_tiled", N4, htc.ho_subcycles_tiled,
         (("spherical", False), ("spherical", True), ("ring", False)), (1, 13, N_SUBCYCLES)),
    ):
        for kind, weighted in cases:
            model, carry, consts, _, _ = inputs(kind, n, weighted)
            solver = model.mevp
            tag = f"{kernel} {n}x{n} {kind}{' A-weighted' if weighted else ''}"
            if weighted:
                ho_form_coverage(tag, solver, consts)
            for n_sub in n_subs:
                got = against_plain(kernel, run, tag, solver, carry, consts, n_sub)
            if kernel == "ho_single":
                tiled = htc.ho_subcycles_tiled(solver, carry, consts, DT, N_SUBCYCLES)
                for (name, g), (_, w) in zip(ho_planes(got), ho_planes(tiled)):
                    same_schedule(f"{tag} N={N_SUBCYCLES} {name}", g, w, "ho_tiled")
            else:
                shipped = htc.ho_subcycles_tiled(solver, carry, consts, DT, 13)
                clusters = htc.ho_subcycles_tiled(solver, carry, consts, DT, 13, htc.CLUSTER_2X2)
                for (name, g), (_, w) in zip(ho_planes(clusters), ho_planes(shipped)):
                    same_schedule(f"{tag} {htc.CLUSTER_2X2} N=13 {name}", g, w, f"ho_tiled {htc.SHIPPED}")
            if (kind, weighted) == ("spherical", False):
                timed[kernel] = (n, run, solver, carry, consts)
    # The timed rows: the form on the spherical window in turns with the
    # closed uniform instance on the same carry (its 29 consts).
    for kernel, (n, run, solver, carry, consts) in timed.items():
        closed = ho_form_model(device, n, False, False).mevp
        closed_consts = {name: consts[name] for name in mevp_ho.HO_CONSTS}
        n_sub = N_SUBCYCLES if kernel == "ho_single" else htc.HALO
        work = ((HO_PLANES_MOVED + 4) * 4 * n * n, n_sub * (OPS["ho_stress"] + OPS["ho_velocity"]) * n * n)
        timed_form(
            f"{kernel} metric", errs[kernel],
            lambda run=run, s=solver, c=carry, k=consts, m=n_sub: run(s, c, k, DT, m),
            lambda run=run, s=closed, c=carry, k=closed_consts, m=n_sub: run(s, c, k, DT, m),
            lambda s=solver, c=carry, k=consts, m=n_sub: mevp_ho.ho_subcycles_reference(s, c, k, DT, m),
            work,
        )
    _ho_metric_qv_launches(device, errs)
    for label in FORM_ROWS:
        if label in TVB_FORMS and "metric" in label:
            TVB_FORMS[label] = replace(TVB_FORMS[label], err=errs[label.split()[0]])
    torch.cuda.synchronize()
    return errs


def _ho_metric_qv_launches(device, errs) -> None:
    """On the 1024^2 ring with the coastline, dG1, the CG2 samples of a
    seeded velocity: transport_tiled's periodic metric qv form (rk2, k = 1
    and 4) against the plain version and the staged schedule (expected 0);
    dg1_rk_stage's periodic metric qv stage (blended and first) and, with a
    middle M, its TVB stage and dg1_limit with the tolerance planes; the
    timed rows in turns with the closed metric qv instances (the window)."""
    n = N4 * N4
    model, carry, _, psi, _ = ho_seeded_inputs(ho_metric_model(device, "ring", N4)[0], device, SEED + 61)
    window = ho_metric_model(device, "spherical", N4)[0]
    faces = model.face_masks(device=device, dtype=torch.float32)
    tr = model.transport
    for k in (1, 4):
        qv = mevp_ho.ho_velocity_to_quad(model.mesh, tr.basis, *(
            mevp_ho.HOField(*(k * x for x in f.planes())) for f in carry[:2]))
        args = (tr, psi, None, None, DT / k, k, faces)
        got = tt.transport_substeps_tiled(*args, qv=qv)
        name = f"transport_tiled {N4}x{N4} ring metric qv k={k}"
        errs["transport_tiled"] = max(errs["transport_tiled"], compare(
            name, got, tt.transport_substeps_tiled_reference(*args, qv=qv), TOL_STEP_TRACER))
        same_schedule(name, got, cc.transport_substeps(*args, qv=qv), "the staged qv transport")
    qv = mevp_ho.ho_velocity_to_quad(model.mesh, tr.basis, *carry[:2])
    stages = cc._RK_STAGES[tr.scheme]
    timed_form("transport_tiled periodic metric qv", errs["transport_tiled"],
               lambda: tt.transport_substeps_tiled(tr, psi, None, None, 60.0, 1, faces, qv=qv),
               lambda: tt.transport_substeps_tiled(window.transport, psi, None, None, 60.0, 1, faces, qv=qv),
               lambda: tt.transport_substeps_tiled_reference(tr, psi, None, None, 60.0, 1, faces, qv=qv),
               tiled_work(1, n, 1, stages, True, metric=True))

    tvb = ho_metric_model(device, "ring", N4, tvb_m=0.0)[0].transport
    tvb.tvb_m = middle_m(psi[:, 0], model.mesh)
    fast = mevp_ho.ho_velocity_to_quad(model.mesh, tr.basis, *(
        mevp_ho.HOField(*(5.0 * x for x in f.planes())) for f in carry[:2]))
    base = psi.flip(-1).contiguous()
    for a, b in ((0.0, 1.0), (0.5, 0.5)):
        args = (tr, psi, base, None, None, *faces, a, b, 300.0)
        errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], compare(
            f"dg1_rk_stage {N4}x{N4} ring metric qv a={a}", cc.dg1_rk_stage(*args, qv=fast),
            cc.dg1_rk_stage_reference(*args, qv=fast), TOL_LAUNCH))
    args = (tvb, psi, base, None, None, *faces, 0.5, 0.5, 300.0)
    unlimited = cc.dg1_rk_stage(*args, qv=fast, tvb=True)
    errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], compare(
        f"dg1_rk_stage {N4}x{N4} ring metric qv TVB stage", unlimited,
        cc.dg1_rk_stage_reference(*args, qv=fast, tvb=True), TOL_LAUNCH))
    limited = cc.dg1_limit(tvb, unlimited)
    errs["dg1_limit"] = compare(f"dg1_limit {N4}x{N4} ring (metric qv stage)", limited,
                                cc.dg1_limit_reference(tvb, unlimited), TOL_LAUNCH)
    share = float((limited[1:3] != unlimited[1:3]).any(dim=0).float().mean())
    log("check", f"dg1_limit {N4}x{N4} ring metric qv: M = {tvb.tvb_m:.4e} cuts {share:.4f} of the element tracers")
    tables, metric, stream = cc._dg1_tables(tr), cc._dg1_metric(tr, device), cc._stream(device)
    qv_ptrs = cc._dg1_qv(fast, (N4, N4), device, tr.basis.degree)
    out = torch.empty_like(psi)

    def stage(tvb_form, w):
        return lambda: cc._dg1_rk_stage_(psi, base, None, None, *faces, metric, out, 0.5, 0.5, 300.0, tables,
                                         stream, qv=qv_ptrs, tvb=tvb_form, wrap=w)

    work = stage_work(1, n, True, True, True)
    limit_ops = stage_cell_ops(1, True, True) - stage_cell_ops(1, True, False)
    wrap = cc.wrap_bits(model.mesh)
    timed_form("dg1_rk_stage periodic metric qv", errs["dg1_rk_stage"], stage(False, wrap), stage(False, 0),
               lambda: cc.dg1_rk_stage_reference(tr, psi, base, None, None, *faces, 0.5, 0.5, 300.0, qv=fast),
               work)
    timed_form("dg1_rk_stage periodic metric qv tvb", errs["dg1_rk_stage"], stage(True, wrap), stage(True, 0),
               lambda: cc.dg1_rk_stage_reference(*args, qv=fast, tvb=True),
               (work[0], work[1] - cc.STAGE_TRACERS * limit_ops * n))


def check_ho_metric_paths(device) -> dict:
    """Each path of HO_METRIC_PATHS on its schedule: one step against the
    plain path on the card, then 20 steps from zeroed launch counts (finite,
    bounded, land untouched, every kernel of the path launched). Returns the
    counts by path."""
    counts = {}
    for path, kind, n, weighted, tvb_m, backends, expected in HO_METRIC_PATHS:
        model, state, phys, dyn = ho_metric_model(device, kind, n, weighted, tvb_m=tvb_m, **backends)
        if tvb_m is not None:
            state = with_fronts(state, SEED + 62)
        schedule = model.schedule(device)
        log("slice", (
            f"{path}: {n}x{n} HO on the {kind} mesh ({type(model.mesh).__name__}, periodic "
            f"({model.mesh.periodic_x}, {model.mesh.periodic_y})), A-weighted {weighted}, tvb_m {tvb_m}, "
            f"schedule {schedule}"
        ))
        if not model.is_high_order or schedule != expected:
            raise AssertionError(f"{path} does not run {expected}: {schedule}")
        compare_step(f"{path}.step", model.step(state, phys, dyn, DT), plain_step(model, state, phys, dyn))
        counts[path] = drive_path(path, model, state, phys, dyn, True)
    return counts


def check_ho_metric(device) -> tuple:
    """Phase: the metric forms of ho_single and ho_tiled and the periodic
    metric qv forms of dg1_rk_stage and transport_tiled, launch by launch,
    then their paths. Returns (counts by path, largest error per kernel)."""
    errs = check_ho_metric_launches(device)
    return check_ho_metric_paths(device), errs


def time_ho_metric(device, card: str) -> None:
    """ms per step and element updates/s of the HO spherical coastline step
    and the HO ring beside ho_coupled_1m, in turns on "auto"; one profile of
    each of the two."""
    steps = {
        "ho_coupled_1m": ho_form_path(device, N4, False, False),
        "ho_coupled_1m_spherical": ho_metric_model(device, "spherical", N4),
        "ho_ring_1m": ho_metric_model(device, "ring", N4),
    }
    runs = time_in_turns(
        {tag: (lambda m=m, s=s, p=p, d=d: m.step(s, p, d, DT)) for tag, (m, s, p, d) in steps.items()},
        dict.fromkeys(steps, 10),
    )
    for tag, ms in runs.items():
        report(f"{tag} coupled step ({N4}x{N4}, {steps[tag][0].schedule(device)})", ms, N4 * N4, card)
    for tag in ("ho_coupled_1m_spherical", "ho_ring_1m"):
        model, state, phys, dyn = steps[tag]
        profile(f"{tag} coupled step ({N4}x{N4}, {model.schedule(device)})",
                lambda: model.step(state, phys, dyn, DT))

# -- M10b part 1: the rank grid on graded, spherical and periodic meshes -----------
#: The paths of phase check_grid_forms, each on a rank grid of the one card:
#: the battery's coupled_1m_spherical_spmd (the spherical coastline window at
#: 1024^2 on 2 x 2 ranks of 512^2, the blocked schedule and rdma); the 1024^2
#: ring with the coastline on 2 x 2, 2 x 1 (a ring of two ranks) and 1 x 2
#: (the ring's axis not split: mevp_tiled's periodic interior, the y bands
#: wrap); config 4 periodic in both axes with tvb_m = 0 and a middle M, and
#: closed with tvb_m = 0 (the spmd transport's TVB walls inside the widened
#: block); coupled_1m_aweighted and box_adaptive's forms on rdma; free drift.
#: (path, mesh kind, rank grid, model keywords, mEVP schedule, steps).
GRID_PATHS = [
    ("coupled_1m_spherical_spmd", "spherical", (2, 2), {"mevp_backend": "blocked"}, "blocked"),
    ("coupled_1m_spherical_spmd_rdma", "spherical", (2, 2), {"mevp_backend": "rdma"}, "rdma"),
    ("grid_ring_2x2", "ring", (2, 2), {"mevp_backend": "rdma"}, "rdma"),
    ("grid_ring_2x1", "ring", (2, 1), {"mevp_backend": "rdma"}, "rdma"),
    ("grid_ring_1x2", "ring", (1, 2), {"mevp_backend": "rdma"}, "rdma"),
    ("grid_ring_1x2_blocked", "ring", (1, 2), {"mevp_backend": "blocked"}, "blocked"),
    ("grid_periodic_tvb_m0", "periodic", (2, 2), {"tvb_m": 0.0}, "blocked"),
    ("grid_periodic_tvb_mmid", "periodic", (2, 2), {"tvb_m": "mid"}, "blocked"),
    ("grid_closed_tvb_m0", "config4", (2, 2), {"tvb_m": 0.0}, "blocked"),
    ("grid_aweighted_rdma", "config4", (2, 2),
     {"mevp_backend": "rdma", "mevp_params": MEVPParams(a_weighted_stress=True)}, "rdma"),
    ("grid_adaptive_rdma", "box", (2, 2),
     {"mevp_backend": "rdma", "mevp_params": MEVPParams(adaptive_alpha=True)}, "rdma"),
    ("grid_free_drift", "config4", (2, 2), {"free_drift": True}, "free-drift"),
]
_GRID_MEVP = {
    "blocked": ("mevp_tiled",), "rdma": ("mevp_tiled", "rdma_stage", "rdma_band"), "free-drift": (),
}
PATH_KERNELS.update({
    path: _GRID_MEVP[schedule] + ("dg1_sample_cfl", "transport_tiled")
    for path, _, _, _, schedule in GRID_PATHS
})
PATH_KERNELS["spherical_16m_spmd"] = ("mevp_tiled", "dg1_sample_cfl", "transport_tiled")
#: Steps of the two cells' paths and the 2 x 2 ring from zeroed launch
#: counts; N5_STEPS on the other grid paths and at 16M (a 2 x 2 step takes
#: ~0.2 s of host issue).
GRID_STEPS = 20
GRID_STEPS_LONG = ("coupled_1m_spherical_spmd", "coupled_1m_spherical_spmd_rdma", "grid_ring_2x2")
#: The rows of the new forms of rdma_band and the spmd transport_tiled (their
#: sources, and the paths whose launches of the kernel are the form's).
_METRIC_RDMA = ["coupled_1m_spherical_spmd_rdma", "grid_ring_2x2", "grid_ring_2x1"]  # not 1x2: the ring row
FORM_ROWS.update({
    "rdma_band metric": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_metric.cu", _METRIC_RDMA),
    "rdma_band ring": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_metric.cu", ["grid_ring_1x2"]),
    "rdma_band A-weighted": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_forms.cu", ["grid_aweighted_rdma"]),
    "rdma_band adaptive": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_forms.cu", ["grid_adaptive_rdma"]),
    "transport_tiled spmd-tvb": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_spmd.cu",
                                 ["grid_periodic_tvb_m0", "grid_periodic_tvb_mmid", "grid_closed_tvb_m0"]),
    "transport_tiled spmd-metric": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled.cu",
                                    [p for p, kind, *_ in GRID_PATHS if kind in ("spherical", "ring")]
                                    + ["spherical_16m_spmd"]),
})


def grid_path_model(device, kind: str, shape, kwargs: dict, n: int = None, mid: dict = None):
    """(single-device model, rank 0's model, the ShardedCoupledModel, state,
    phys, dyn) of a grid path: ``kind`` "spherical" (the window with the
    coastline), "ring" (with the coastline), "periodic" (config 4 periodic
    in both axes, with fronts), "config4" (closed; with fronts under TVB)
    or "box" (box_adaptive's 256^2); ``kwargs`` the models' keywords
    ("free_drift": select Nextsim::FreeDrift; tvb_m "mid": ``mid[kind]``)."""
    n = N4 if n is None else n
    kwargs = dict(kwargs)
    free_drift = kwargs.pop("free_drift", False)
    if kwargs.get("tvb_m") == "mid":
        kwargs["tvb_m"] = mid[kind]
    grid_kw = {k: kwargs.pop(k) for k in ("mevp_backend", "mevp_block_halo") if k in kwargs}
    loader = modules.get_loader()
    if free_drift:
        loader.set_implementation("Nextsim::IDynamics", "Nextsim::FreeDrift")
    try:
        if kind == "box":
            mesh, ocean = RectMesh(N, N, dx=512e3 / N, dy=512e3 / N), None
        elif kind in ("spherical", "ring"):
            mesh, ocean = (spherical_mesh(n) if kind == "spherical" else ring_mesh(n)), synthetic_coastline(n)
        else:
            mesh, ocean = RectMesh(n, n, dx=4e3, dy=4e3, periodic_x=kind == "periodic",
                                   periodic_y=kind == "periodic"), None
        single, state, phys, dyn = coupled_model(device, mesh, ocean, **kwargs)
        model, sharded = build_sharded_coupled_model(
            mesh, RankGrid(*shape, device), degree=1, n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
            **kwargs, **grid_kw,
        )
    finally:
        if free_drift:
            loader.reset()
    if "tvb_m" in kwargs:
        state = with_fronts(state, SEED + 50)
    return single, model, sharded, state, phys, dyn


def rdma_form_launches(device, sharded, state, phys, dyn, tag: str, errs: dict, band_ranks=None) -> dict:
    """One rdma round on every rank of a grid path (its state after a step),
    each rdma_stage and rdma_band launch against its plain version (the
    bands on the ranks of ``band_ranks`` only, default all) and the round
    against the blocked round (with the HO solver K7's 17-plane round);
    returns rank 0's captured x and y launches {axis: (band solver,
    sources, widened consts, state)}."""
    states, _, dyns = blocks_of(sharded, state, phys, dyn)

    def check_round(rank):
        model = sharded.models[rank.rank]
        carry, consts = step_consts_of(model, states[rank.rank], dyns[rank.rank])
        return rdma_round_checked(model, carry, consts, band_ranks is None or rank.rank in band_ranks)

    results = run_ranks(sharded.grid.ring, check_round)
    torch.cuda.synchronize()
    for r, (errors, out, blocked, _) in enumerate(results):
        for kernel, what, g, ref in errors:
            errs[kernel] = max(errs[kernel], compare(f"{tag} {kernel} rank {r} {what}", g, ref, TOL_LAUNCH))
        names = HO_PLANE_NAMES if sharded.models[r].is_high_order else VELOCITY
        for name, g, b in zip(names, out, blocked):
            same_schedule(f"{tag} rdma round rank {r} {name}", g, b, "the blocked round")
    return next(res[3] for res in results if res[3])


def closed_band(local, consts_w):
    """The closed uniform instance's solver and consts at a form's band: the
    uniform 7 consts, a unit mesh closed along the band, fixed alpha."""
    from nextsimdg_tpu_torch.dynamics.mevp import UNIFORM_CONSTS

    mesh = RectMesh(local.mesh.nx, local.mesh.ny, 4e3, 4e3)
    return MEVPSolver(mesh, MEVPParams()), {k: consts_w[k] for k in UNIFORM_CONSTS}


def register_band_form(label: str, captured: dict, errs: dict) -> None:
    """The row of an rdma_band form: its x launch (the y launch where only
    y is split) timed in turns with the closed uniform instance on the same
    band, and its bytes and operations (``rdma_band_work``: the form's
    const planes and bodies); where both axes are split, the y launch's
    device duration and its closed instance's are probed too (the y bands
    run along the rows)."""
    axis = 0 if 0 in captured else 1
    local, src, consts_w, state0 = captured[axis]
    h = src.h
    nx, ny = src.own[0].shape
    closed, closed_consts = closed_band(local, consts_w)
    if axis == 0 and 1 in captured:  # the y launch too: its device duration, and its closed instance's
        local_y, src_y, consts_y, state_y = captured[1]
        closed_y, closed_consts_y = closed_band(local_y, consts_y)
        state_fy, state_cy = [x.clone() for x in state_y], [x.clone() for x in state_y]
        DEVICE_PROBES[f"rdma_band {label} y bands"] = (
            lambda: rdma.rdma_band(local_y, src_y, 1, consts_y, DT, h, state_fy))
        DEVICE_PROBES[f"rdma_band {label} y bands (closed instance)"] = (
            lambda: rdma.rdma_band(closed_y, src_y, 1, closed_consts_y, DT, h, state_cy))
    p = local.params
    stress = OPS["stress_both" if p.a_weighted_stress and p.adaptive_alpha else
                 "stress_weighted" if p.a_weighted_stress else
                 "stress_adaptive" if p.adaptive_alpha else "stress"]
    velocity = OPS["velocity_metric" if not local.mesh.uniform else "velocity"]
    work = rdma_band_work(axis, h, h, nx, ny, src.hx, len(consts_w), stress + velocity)
    state_f, state_c = [x.clone() for x in state0], [x.clone() for x in state0]
    timed_form(label, errs["rdma_band"],
               lambda: rdma.rdma_band(local, src, axis, consts_w, DT, h, state_f),
               lambda: rdma.rdma_band(closed, src, axis, closed_consts, DT, h, state_c),
               lambda: rdma.rdma_band_reference(local, src, axis, consts_w, DT, h, [x.clone() for x in state0]),
               work)


def spmd_transport_launches(device, sharded, state, tag: str, errs: dict) -> list:
    """One call of the spmd transport on every rank (k = 3 substeps of the
    state's tracers and velocity; with the HO solver its CG2 velocity's
    quadrature samples, widened by the wrapper), each transport_tiled launch
    against its plain version on the same widened block (the TVB walls as
    the plain version's wall-delta masks, the widened metric planes, the
    widened samples); returns rank 0's launches (kernel output, plain
    output, arguments, keywords)."""
    import threading

    blocks = sharded.grid.split_tree(state)
    checked = {}
    kernel = tt.transport_substeps_tiled

    def checking(transport, psi, u, v, dt_sub, n, faces_w, **kw):
        got = kernel(transport, psi, u, v, dt_sub, n, faces_w, **kw)
        walls = kw.get("walls")
        masks = None if walls is None else tt.wall_masks(walls, psi.shape[-2:], psi[0, 0])
        ref = tt.transport_substeps_tiled_reference(
            transport, psi, u, v, dt_sub, n, faces_w, qv=kw.get("qv"), metric=kw.get("metric"),
            wall_masks=masks,
        )
        checked.setdefault(threading.current_thread().name, []).append(
            (got, ref, (transport, psi, u, v, dt_sub, n, faces_w), kw))
        return got

    def body(rank):
        model, st = sharded.models[rank.rank], blocks[rank.rank]
        faces = model.face_masks(device=device, dtype=torch.float32)
        tracers = torch.stack([st.hice, st.cice, st.hsnow], dim=1)
        if model.is_high_order:
            qv = mevp_ho.ho_velocity_to_quad(model.mesh, model.transport.basis, st.velocity.u, st.velocity.v,
                                             rank.axes)
            return tt.transport_substeps_tiled_spmd(model, tracers, None, DT / 3, 3, faces, qv=qv)
        velocity_w = tt.widen_velocity(model, st.velocity.u, st.velocity.v)
        return tt.transport_substeps_tiled_spmd(model, tracers, velocity_w, DT / 3, 3, faces)

    tt.transport_substeps_tiled = checking
    try:
        run_ranks(sharded.grid.ring, body)
    finally:
        tt.transport_substeps_tiled = kernel
    torch.cuda.synchronize()
    for name, launches in sorted(checked.items()):
        for i, (got, ref, _, kw) in enumerate(launches):
            what = ((f" walls {kw['walls']}" if kw.get("walls") else "") + (" metric" if kw.get("metric") else "")
                    + (" qv" if kw.get("qv") else ""))
            errs["transport_tiled"] = max(errs["transport_tiled"], compare(
                f"{tag} transport_tiled {name} launch {i}{what}", got, ref, TOL_LAUNCH))
    return checked["rank0"]


def register_transport_form(label: str, launches: list, errs: dict, closed) -> None:
    """The row of an spmd transport_tiled form: rank 0's first launch timed
    in turns with the same launch on the untouched instance (``closed``:
    (transport, keywords) that drop the form), and its bytes and
    operations."""
    _, _, args, kw = launches[0]
    transport, psi, u, v, dt_sub, n, faces_w = args
    nxw, nyw = psi.shape[-2:]
    work = tiled_work(1, nxw * nyw, n, cc._RK_STAGES[transport.scheme], kw.get("qv") is not None,
                      metric=kw.get("metric") is not None)
    if transport.limits_slopes:  # the limiter after each of the 2 stages, 3 tracers
        work = (work[0], work[1] + n * 2 * 3 * tvb_limit_ops(1) * nxw * nyw)
    closed_tr, closed_kw = closed
    masks = None if kw.get("walls") is None else tt.wall_masks(kw["walls"], psi.shape[-2:], psi[0, 0])
    timed_form(label, errs["transport_tiled"],
               lambda: tt.transport_substeps_tiled(*args, **kw),
               lambda: tt.transport_substeps_tiled(closed_tr, *args[1:], **closed_kw),
               lambda: tt.transport_substeps_tiled_reference(*args, qv=kw.get("qv"), metric=kw.get("metric"),
                                                             wall_masks=masks),
               work)


def widened_tiled_launches(tag: str, run):
    """``run()`` with each rank's second mevp_tiled call of the blocked
    schedule (h subcycles on the widened block, from a state whose stresses
    the first call made nonzero) held against its plain version, and one
    subcycle on the same inputs; returns run()'s result. The extra launches
    are made before the launch counts are zeroed."""
    import threading

    kernel = mt.mevp_subcycles_tiled
    calls, checked = {}, {}

    def checking(solver, carry, consts, dt, n_sub, *args, **kw):
        got = kernel(solver, carry, consts, dt, n_sub, *args, **kw)
        name = threading.current_thread().name
        calls[name] = calls.get(name, 0) + 1
        if calls[name] == 2:
            checked[name] = [
                (n_sub, got, mt.mevp_subcycles_tiled_reference(solver, carry, consts, dt, n_sub), carry[0].shape),
                (1, kernel(solver, carry, consts, dt, 1), mt.mevp_subcycles_tiled_reference(solver, carry, consts, dt, 1),
                 carry[0].shape),
            ]
        return got

    mt.mevp_subcycles_tiled = checking
    try:
        out = run()
    finally:
        mt.mevp_subcycles_tiled = kernel
    torch.cuda.synchronize()
    if len(checked) != RANKS[0] * RANKS[1]:
        raise AssertionError(f"{tag}: mevp_tiled ran on {sorted(checked)} only")
    for name, pairs in sorted(checked.items()):
        for n_sub, got, ref, shape in pairs:
            for plane, g, r in zip(VELOCITY, got, ref):
                compare(f"{tag} mevp_tiled {name} widened {shape[0]}x{shape[1]} N={n_sub} {plane}", g, r,
                        TOL_LAUNCH if n_sub == 1 else TOL_STEP_MEVP)
    return out


def check_grid_forms(device) -> tuple:
    """Phase: M10b part 1. Each new form of rdma_band (the metric round, the
    ring along the band, A-weighted, adaptive) and of the spmd
    transport_tiled (the TVB walls inside the widened block, the widened
    metric planes) launch by launch against its plain version (TOL_LAUNCH);
    each grid path (GRID_PATHS) one decomposed step against the
    single-device step (expected 0), then GRID_STEPS steps (N5_STEPS but on
    the two cells and the 2 x 2 ring) from zeroed launch counts (finite,
    bounded, land untouched, every kernel of the path launched; the TVB
    paths print the shares their limiter cuts and keeps); spherical_16m_spmd (BASELINE config 5 on the spherical
    coastline domain, 4096^2 on 2 x 2 ranks) one decomposed step against
    the single-device step (expected 0) with each rank's widened mevp_tiled
    launch and every spmd transport_tiled launch against plain at its 2048^2
    blocks, then N5_STEPS steps. Returns (counts by path, largest error per
    kernel)."""
    errs = {"rdma_band": 0.0, "rdma_stage": 0.0, "transport_tiled": 0.0}
    counts, mid = {}, {}
    band_forms = {
        "coupled_1m_spherical_spmd_rdma": "rdma_band metric", "grid_ring_1x2": "rdma_band ring",
        "grid_aweighted_rdma": "rdma_band A-weighted", "grid_adaptive_rdma": "rdma_band adaptive",
    }
    for path, kind, shape, kwargs, schedule in GRID_PATHS:
        if kwargs.get("tvb_m") == "mid" and kind not in mid:
            mesh = RectMesh(N4, N4, dx=4e3, dy=4e3, periodic_x=True, periodic_y=True)
            mid[kind] = middle_m(with_fronts(coupled_model(device, mesh, None)[1], SEED + 50).hice, mesh)
            log("slice", f"{kind}: the middle M from the state's |psi1|: {mid[kind]:.4e}")
        single, model, sharded, state, phys, dyn = grid_path_model(device, kind, shape, kwargs, mid=mid)
        got_schedule = model.schedule(device)
        mesh = model.mesh
        log("slice", (
            f"{path}: {N4 if kind != 'box' else N}^2 {type(single.mesh).__name__} periodic "
            f"({single.mesh.periodic_x}, {single.mesh.periodic_y}) on a {shape[0]}x{shape[1]} rank grid of "
            f"{mesh.nx}x{mesh.ny} blocks ({type(mesh).__name__}), schedule {got_schedule}, "
            f"single-device {single.schedule(device)}; h = {getattr(model.mevp, 'block_halo', None)}, spmd "
            f"transport (H, k_cap) = {tt.transport_tiled_spmd_config(model)}, tvb_m {model.transport.tvb_m}"
        ))
        if got_schedule != (schedule, "tiled"):
            raise AssertionError(f"{path} does not run {(schedule, 'tiled')}: {got_schedule}")
        if single.transport.limits_slopes:
            cut, kept = tvb_shares(single.transport, state)
            log("slice", f"{path}: the limiter cuts {cut:.4f} of the elements and keeps {kept:.4f} of the step's tracers")
            if kwargs.get("tvb_m") == "mid" and not (cut > 0.05 and kept > 0.05):
                raise AssertionError(f"{path}: the middle M does not take both branches ({cut:.4f} cut)")
        ref = single.step(state, phys, dyn, DT)
        got = sharded(state, phys, dyn, DT)
        torch.cuda.synchronize()
        compare_sharded_step(f"{path}.step vs single-device", got, ref, tol_same=True)
        if path in band_forms:
            captured = rdma_form_launches(device, sharded, got, phys, dyn, path, errs)
            register_band_form(band_forms[path], captured, errs)
        if path == "grid_closed_tvb_m0":
            launches = spmd_transport_launches(device, sharded, got, path, errs)
            transport = launches[0][2][0]
            register_transport_form("transport_tiled spmd-tvb", launches, errs, (transport, {}))
        if path == "coupled_1m_spherical_spmd":
            launches = spmd_transport_launches(device, sharded, got, path, errs)
            nxw, nyw = launches[0][2][1].shape[-2:]
            uniform = tt.DGTransport(RectMesh(nxw, nyw, 4e3, 4e3), 1)
            register_transport_form("transport_tiled spmd-metric", launches, errs, (uniform, {}))
        if kind in ("periodic",) and path.endswith("m0"):
            spmd_transport_launches(device, sharded, got, path, errs)
        n_steps = GRID_STEPS if path in GRID_STEPS_LONG else N5_STEPS
        cc.reset_launches()
        out = sharded.run_blocks(*blocks_of(sharded, state, phys, dyn), DT, n_steps)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        log("slice", f"{path}: {n_steps} steps, launches: {counts[path]}")
        out = sharded.grid.gather_tree(out, device)
        check_bounded(f"{path}: {n_steps} steps", out, state)
        if single.ocean_mask is not None:
            check_land(f"{path}: {n_steps} steps", single, out, state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    # spherical_16m_spmd on 2048^2 blocks: one step against the
    # single-device step, the kernels at the blocks' shapes against plain,
    # then N5_STEPS steps.
    single, model, sharded, state, phys, dyn = grid_path_model(
        device, "spherical", RANKS, {"mevp_backend": "blocked"}, n=N16)
    log("slice", (
        f"spherical_16m_spmd: {N16}^2 spherical window with the coastline on a {RANKS[0]}x{RANKS[1]} rank "
        f"grid of {model.mesh.nx}x{model.mesh.ny} blocks, schedule {model.schedule(device)}, h = "
        f"{model.mevp.block_halo}, spmd transport (H, k_cap) = {tt.transport_tiled_spmd_config(model)}; "
        f"single-device {single.schedule(device)}"
    ))
    if model.schedule(device) != ("blocked", "tiled"):
        raise AssertionError(f"spherical_16m_spmd does not run ('blocked', 'tiled'): {model.schedule(device)}")
    ref = single.step(state, phys, dyn, DT)
    got = widened_tiled_launches("spherical_16m_spmd", lambda: sharded(state, phys, dyn, DT))
    compare_sharded_step("spherical_16m_spmd.step vs single-device", got, ref, tol_same=True)
    del ref
    spmd_transport_launches(device, sharded, got, "spherical_16m_spmd", errs)
    del got
    cc.reset_launches()
    out = sharded.run_blocks(*blocks_of(sharded, state, phys, dyn), DT, N5_STEPS)
    torch.cuda.synchronize()
    counts["spherical_16m_spmd"] = dict(cc.launches)
    log("slice", f"spherical_16m_spmd: {N5_STEPS} steps, launches: {counts['spherical_16m_spmd']}")
    out = sharded.grid.gather_tree(out, device)
    check_bounded(f"spherical_16m_spmd: {N5_STEPS} steps", out, state)
    check_land(f"spherical_16m_spmd: {N5_STEPS} steps", single, out, state)
    for label in ("rdma_band metric", "rdma_band ring", "rdma_band A-weighted", "rdma_band adaptive",
                  "transport_tiled spmd-tvb", "transport_tiled spmd-metric"):
        TVB_FORMS[label] = replace(TVB_FORMS[label], err=errs[label.split()[0]])
    return counts, errs


def time_grid_forms(device, card: str) -> None:
    """coupled_1m_spherical_spmd (spherical_16m_spmd is checked, not timed,
    to keep the run's time): ms per step and element updates/s in chunks of
    N5_STEPS steps on resident blocks, h = 16 (the port's "auto"), in turns
    with the single-device spherical step; a profile of the grid step (its
    idle share). The
    new forms' rows are timed in turns with their closed instances in
    time_tvb_periodic."""
    for n, tag in ((N4, "coupled_1m_spherical_spmd"),):
        fns, grids = {}, {}
        single, _, _, state, phys, dyn = grid_path_model(device, "spherical", RANKS, {}, n=n)
        fns["single-device"] = lambda single=single, state=state, phys=phys, dyn=dyn: single.run(
            state, phys, dyn, DT, N5_STEPS)
        for h in (16,):
            _, model, sharded, *_ = grid_path_model(
                device, "spherical", RANKS, {"mevp_backend": "blocked", "mevp_block_halo": h}, n=n)
            blocks = blocks_of(sharded, state, phys, dyn)
            grids[h] = (sharded, blocks)
            fns[f"2x2 blocked h={h}"] = lambda s=sharded, b=blocks: s.run_blocks(*b, DT, N5_STEPS)
        runs = time_in_turns(fns, dict.fromkeys(fns, 1))
        for name, ms in runs.items():
            report(f"{tag} coupled step, {name} ({n}x{n}, {N5_STEPS} steps a chunk)",
                   [m / N5_STEPS for m in ms], n * n, card)
    sharded, blocks = grids[16]
    profile(f"coupled_1m_spherical_spmd coupled step, 2x2 blocked h=16 ({N4}x{N4})",
            lambda: sharded.run_blocks(*blocks, DT, 1), n_steps=1)




# -- M10b part 2a: the HO solver on the rank grid's blocked schedule -----------------
#: The battery's six HO *_spmd configs (run_benchmarks.CONFIGS), each on
#: 2 x 2 ranks of the one card at the JAX battery's sizes, config 4's state
#: and forcing, 100 subcycles, dG1, f32, the blocked schedule: (path, mesh
#: kind, n, coastline, mEVP ghost width).
HO_GRID_PATHS = [
    ("ho_coupled_1m_spherical_spmd", "spherical", N4, True, "auto"),
    ("ho_ablate_uniform_spmd", "uniform", N4, False, "auto"),
    ("ho_ablate_spherical_spmd", "spherical", N4, False, "auto"),
    ("ho_ablate_h16_spmd", "spherical", N4, True, 16),
    ("ho_ablate_h32_spmd", "spherical", N4, True, 32),
    ("ho_spherical_16m_spmd", "spherical", N16, True, "auto"),
]
#: Ghost widths whose widened ho_tiled launches are checked besides the
#: configs' own (the h sweep's, on the two configs it times), and the
#: widths the timings sweep (the others left out to keep the run's time).
HO_GRID_SWEEP = (16, 32, 64)
HO_GRID_TIMED_SWEEP = (16,)
HO_GRID_TIMED = ("ho_coupled_1m_spherical_spmd", "ho_spherical_16m_spmd")
#: Configs whose spmd qv transport_tiled launches are held against plain:
#: the 512^2 blocks (metric and closed) and the 2048^2 ones.
HO_GRID_TRANSPORT = ("ho_coupled_1m_spherical_spmd", "ho_ablate_uniform_spmd", "ho_spherical_16m_spmd")
#: Steps a timed chunk of time_grid_ho: a 2 x 2 HO step takes 0.4-0.8 s of
#: host issue on the H100 (PERF.md).
HO_GRID_CHUNK = 2
PATH_KERNELS.update({path: ("ho_tiled", "transport_tiled") for path, *_ in HO_GRID_PATHS})
# Each launch counts on one row: the metric ho_tiled launches of the
# spherical configs on the metric form's row, every spmd qv transport_tiled
# launch on its own (the closed and metric qv instances of
# transport_tiled.cu on the widened blocks).
FORM_ROWS["ho_tiled metric"][2].extend(path for path, kind, *_ in HO_GRID_PATHS if kind == "spherical")
FORM_ROWS["transport_tiled spmd-qv"] = (
    "transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled.cu", [path for path, *_ in HO_GRID_PATHS])


def ho_grid_model(device, kind: str, n: int, coast: bool, halo="auto", backend: str = "blocked",
                  shape=RANKS, weighted: bool = False):
    """(single-device model, rank 0's model, the ShardedCoupledModel, state,
    phys, dyn) of an HO grid config: config 4's model, state and forcing
    with the HO solver (selected through the registry, reset after the
    build) on the spherical window, the 360 degree ring ("ring") or config
    4's uniform mesh, with synthetic_coastline(n) or none, A-weighted or
    not, on a ``shape`` grid of the card (2 x 2 by default), on the
    exchange schedule ``backend`` with ghost width ``halo``."""
    mesh = {"spherical": spherical_mesh, "ring": ring_mesh}.get(kind, lambda m: RectMesh(m, m, dx=4e3, dy=4e3))(n)
    ocean = synthetic_coastline(n) if coast else None
    params = MEVPParams(a_weighted_stress=weighted)
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        single, state, phys, dyn = coupled_model(device, mesh, ocean, mevp_params=params)
        model, sharded = build_sharded_coupled_model(
            mesh, RankGrid(*shape, device), degree=1, n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
            mevp_params=params, mevp_backend=backend, mevp_block_halo=halo,
        )
    finally:
        loader.reset()
    return single, model, sharded, state, phys, dyn


def widened_ho_launches(tag: str, run, seen: set, errs: dict):
    """``run()`` with rank 0's second widened-block call of the HO blocked
    schedule (h subcycles, from a state whose stresses the first round made
    nonzero), where its (shape, form) is not in ``seen``, held against the
    plain subcycles on the same inputs, and one ho_tiled launch of one
    subcycle against plain (TOL_LAUNCH); returns run()'s result. The extra
    launches are made before the launch counts are zeroed."""
    import threading

    subcycles = mevp_ho.MEVPSolverHO.subcycles
    calls, checked = {}, []
    sms = cc.sm_count(torch.device("cuda", 0))

    def checking(solver, carry, consts, dt, n_sub):
        got = subcycles(solver, carry, consts, dt, n_sub)
        name = threading.current_thread().name
        calls[name] = calls.get(name, 0) + 1
        key = (tuple(carry[0].v.shape), cc.kernel_form(solver))
        if name == "rank0" and calls[name] == 2 and key not in seen:
            seen.add(key)
            checked.append((key, solver.schedule(sms), n_sub, got,
                            htc.ho_tiled_reference(solver, carry, consts, dt, n_sub),
                            htc.ho_subcycles_tiled(solver, carry, consts, dt, 1),
                            htc.ho_tiled_reference(solver, carry, consts, dt, 1)))
        return got

    mevp_ho.MEVPSolverHO.subcycles = checking
    try:
        out = run()
    finally:
        mevp_ho.MEVPSolverHO.subcycles = subcycles
    torch.cuda.synchronize()
    for (shape, form), schedule, n_sub, got, ref, got1, ref1 in checked:
        metric = bool(form & cc.HO_FORM_METRIC)
        label = "ho_tiled metric" if metric else "ho_tiled"
        if schedule != "tiled":
            raise AssertionError(f"{tag}: the {shape[0]}x{shape[1]} widened block runs {schedule}, not ho_tiled")
        what = f"{tag} ho_tiled {'metric' if metric else 'closed'} form, widened {shape[0]}x{shape[1]}"
        for (name, g), (_, r) in zip(ho_planes(got1), ho_planes(ref1)):
            errs[label] = max(errs[label], compare(f"{what} N=1 {name}", g, r, TOL_LAUNCH))
        for (name, g), (_, r) in zip(ho_planes(got), ho_planes(ref)):
            compare(f"{what} N={n_sub} (a round) {name}", g, r, TOL_STEP_MEVP)
    return out


def register_qv_transport_form(label: str, launches: list, errs: dict) -> None:
    """The row of the spmd qv form of transport_tiled: rank 0's first
    launch timed in turns with the same launch in the CG1 form (the
    velocity sampled from two planes of the samples' shape, which the qv
    form skips), and its bytes and operations."""
    _, _, args, kw = launches[0]
    transport, psi, _, _, dt_sub, n, faces_w = args
    qv, metric = kw["qv"], kw.get("metric")
    nxw, nyw = psi.shape[-2:]
    u, v = qv.vx_vol[0].contiguous(), qv.vy_vol[0].contiguous()
    work = tiled_work(1, nxw * nyw, n, cc._RK_STAGES[transport.scheme], True, metric=metric is not None)
    timed_form(label, errs["transport_tiled"],
               lambda: tt.transport_substeps_tiled(*args, **kw),
               lambda: tt.transport_substeps_tiled(transport, psi, u, v, dt_sub, n, faces_w, metric=metric),
               lambda: tt.transport_substeps_tiled_reference(*args, qv=qv, metric=metric),
               work)


def check_grid_ho(device) -> tuple:
    """Phase: M10b part 2a. Each of the battery's six HO *_spmd configs
    (HO_GRID_PATHS) at full size on 2 x 2 ranks of the card: one decomposed
    step against the single-device HO step (expected 0, failing above
    TOL_SAME_SCHEDULE), with rank 0's widened ho_tiled launch of each new
    (shape, form) against plain (one subcycle at TOL_LAUNCH, a round at
    TOL_STEP_MEVP); on the two timed configs also at the h sweep's other
    ghost widths; each spmd qv transport_tiled launch of one call on every
    rank against plain at the 512^2 (closed and metric) and 2048^2 blocks
    (TOL_LAUNCH); then GRID_STEPS steps (ho_coupled_1m_spherical_spmd) or
    N5_STEPS (the others) from zeroed launch counts: finite, bounded, land
    untouched, ho_tiled and transport_tiled launched. Returns (counts by
    path, largest error per row)."""
    errs = {"ho_tiled": 0.0, "ho_tiled metric": 0.0, "transport_tiled": 0.0}
    counts, seen = {}, set()
    for path, kind, n, coast, halo in HO_GRID_PATHS:
        single, model, sharded, state, phys, dyn = ho_grid_model(device, kind, n, coast, halo)
        schedule = model.schedule(device)
        log("slice", (
            f"{path}: {n}^2 {type(single.mesh).__name__}{' with the coastline' if coast else ''}, HO on a "
            f"{RANKS[0]}x{RANKS[1]} rank grid of {model.mesh.nx}x{model.mesh.ny} blocks "
            f"({type(model.mesh).__name__}), schedule {schedule}, h = {model.mevp.block_halo}, spmd "
            f"transport (H, k_cap) = {tt.transport_tiled_spmd_config(model)}; single-device "
            f"{single.schedule(device)}"
        ))
        if not model.is_high_order or schedule != ("blocked", "tiled"):
            raise AssertionError(f"{path} does not run HO on ('blocked', 'tiled'): {schedule}")
        ref = single.step(state, phys, dyn, DT)
        got = widened_ho_launches(path, lambda: sharded(state, phys, dyn, DT), seen, errs)
        compare_sharded_step(f"{path}.step vs single-device", got, ref, tol_same=True)
        if path in HO_GRID_TIMED:
            for h in HO_GRID_SWEEP:
                if h == model.mevp.block_halo:
                    continue
                swept = ho_grid_model(device, kind, n, coast, h)[2]
                out = widened_ho_launches(f"{path} h={h}", lambda: swept(state, phys, dyn, DT), seen, errs)
                compare_sharded_step(f"{path} h={h}.step vs single-device", out, ref, tol_same=True)
                del swept, out
        del ref
        if path in HO_GRID_TRANSPORT:
            launches = spmd_transport_launches(device, sharded, got, path, errs)
            if path == "ho_coupled_1m_spherical_spmd":
                register_qv_transport_form("transport_tiled spmd-qv", launches, errs)
            del launches
        del got
        n_steps = GRID_STEPS if path == "ho_coupled_1m_spherical_spmd" else N5_STEPS
        cc.reset_launches()
        out = sharded.run_blocks(*blocks_of(sharded, state, phys, dyn), DT, n_steps)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        log("slice", f"{path}: {n_steps} steps, launches: {counts[path]}")
        out = sharded.grid.gather_tree(out, device)
        check_bounded(f"{path}: {n_steps} steps", out, state)
        if coast:
            check_land(f"{path}: {n_steps} steps", single, out, state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
        del single, model, sharded, state, out
    widened = sorted(f"{s[0]}x{s[1]} {'metric' if form & cc.HO_FORM_METRIC else 'closed'}" for s, form in seen)
    log("check", f"widened ho_tiled launches checked at: {', '.join(widened)}")
    TVB_FORMS["transport_tiled spmd-qv"] = replace(TVB_FORMS["transport_tiled spmd-qv"], err=errs["transport_tiled"])
    TVB_FORMS["ho_tiled metric"] = replace(
        TVB_FORMS["ho_tiled metric"], err=max(TVB_FORMS["ho_tiled metric"].err, errs["ho_tiled metric"]))
    return counts, errs["ho_tiled"]


def time_grid_ho(device, card: str) -> None:
    """The HO grid configs: ms per step and element updates/s in chunks of
    HO_GRID_CHUNK steps on resident blocks. ho_coupled_1m_spherical_spmd and
    ho_spherical_16m_spmd at h = 16 (the port's "auto") in turns
    with the single-device HO step, and a profile of each one's step (its
    idle share)."""
    for path, kind, n, coast, halo in HO_GRID_PATHS:
        if path not in HO_GRID_TIMED:  # the other four are checked in check_grid_ho, not timed
            continue
        single, model, sharded, state, phys, dyn = ho_grid_model(device, kind, n, coast, halo)
        fns = {f"2x2 blocked h={model.mevp.block_halo}": (
            lambda s=sharded, b=blocks_of(sharded, state, phys, dyn): s.run_blocks(*b, DT, HO_GRID_CHUNK))}
        if path in HO_GRID_TIMED:
            fns["single-device"] = lambda: single.run(state, phys, dyn, DT, HO_GRID_CHUNK)
            for h in HO_GRID_TIMED_SWEEP:
                if h != model.mevp.block_halo:
                    swept = ho_grid_model(device, kind, n, coast, h)[2]
                    fns[f"2x2 blocked h={h}"] = (
                        lambda s=swept, b=blocks_of(swept, state, phys, dyn): s.run_blocks(*b, DT, HO_GRID_CHUNK))
        runs = time_in_turns(fns, dict.fromkeys(fns, 1))
        for name, ms in runs.items():
            report(f"{path} coupled step, {name} ({n}x{n}, {HO_GRID_CHUNK} steps a chunk)",
                   [m / HO_GRID_CHUNK for m in ms], n * n, card)
        blocks = blocks_of(sharded, state, phys, dyn)
        profile(f"{path} coupled step, 2x2 blocked h={model.mevp.block_halo} ({n}x{n})",
                lambda: sharded.run_blocks(*blocks, DT, 1), n_steps=1)
        if path in HO_GRID_TIMED:
            # ho_tiled's plain version on seeded planes of the widened block's size.
            wide = model.mesh.nx + 2 * model.mevp.block_halo
            m, carry, consts, _, _ = ho_inputs(wide, wide, device, SEED)
            plain = time_ms(lambda: mevp_ho.ho_subcycles_reference(m.mevp, carry, consts, DT, TILED_SUBCYCLES), 1)
            log("time", f"{path}: plain HO subcycles ({TILED_SUBCYCLES}) at the widened block's {wide}^2: {plain:.4f} ms")
            del m, carry, consts
        del single, model, sharded, state, fns, runs, blocks


# -- M10b part 2b, first half: K7's HO round, the HO solver's rdma schedule ----------
#: The paths of phase check_grid_ho_rdma, each the HO solver on the rdma
#: schedule (h = 16) of a rank grid of the card: the battery's
#: ho_coupled_1m_spherical_spmd (512^2 metric blocks, the coastline),
#: ho_ablate_uniform_spmd (512^2 closed uniform blocks) and
#: ho_spherical_16m_spmd (2048^2 blocks), and two small grids for the HO
#: band's other forms: config 4's mesh at 256^2, A-weighted, on 2 x 2, and
#: the 256^2 ring with the coastline on 1 x 2 (the ring's axis on one rank:
#: the y bands wrap along x). (path, mesh kind, n, coastline, rank grid,
#: A-weighted).
HO_RDMA_PATHS = [
    ("ho_coupled_1m_spherical_spmd_rdma", "spherical", N4, True, RANKS, False),
    ("ho_ablate_uniform_spmd_rdma", "uniform", N4, False, RANKS, False),
    ("ho_spherical_16m_spmd_rdma", "spherical", N16, True, RANKS, False),
    ("ho_grid_aweighted_rdma", "uniform", N, False, RANKS, True),
    ("ho_grid_ring_1x2_rdma", "ring", N, True, (1, 2), False),
]
#: The HO band's rows and the path whose launches each is checked and timed
#: on (its x launch, or its y launch where only y is split).
HO_RDMA_ROWS = {
    "rdma_band HO": "ho_ablate_uniform_spmd_rdma", "rdma_band HO metric": "ho_coupled_1m_spherical_spmd_rdma",
    "rdma_band HO A-weighted": "ho_grid_aweighted_rdma", "rdma_band HO ring": "ho_grid_ring_1x2_rdma",
}
PATH_KERNELS.update({
    path: ("ho_tiled" if n >= N4 else "ho_single", "rdma_stage", "rdma_band", "transport_tiled")
    for path, _, n, *_ in HO_RDMA_PATHS
})
_HO_RDMA_METRIC = [p for p, kind, *_ in HO_RDMA_PATHS if kind != "uniform"]
FORM_ROWS.update({
    "rdma_stage HO": ("rdma_stage", "nextsimdg_tpu_torch/csrc/mevp_rdma.cu", [p for p, *_ in HO_RDMA_PATHS]),
    "rdma_band HO": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_ho.cu", ["ho_ablate_uniform_spmd_rdma"]),
    "rdma_band HO metric": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_ho_metric.cu",
                            ["ho_coupled_1m_spherical_spmd_rdma", "ho_spherical_16m_spmd_rdma"]),
    "rdma_band HO A-weighted": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_ho_forms.cu",
                                ["ho_grid_aweighted_rdma"]),
    "rdma_band HO ring": ("rdma_band", "nextsimdg_tpu_torch/csrc/mevp_rdma_ho_metric.cu", ["ho_grid_ring_1x2_rdma"]),
})
FORM_ROWS["ho_tiled metric"][2].extend(_HO_RDMA_METRIC)
FORM_ROWS["ho_single metric"][2].extend(_HO_RDMA_METRIC)
FORM_ROWS["ho_single A-weighted"][2].append("ho_grid_aweighted_rdma")
FORM_ROWS["transport_tiled spmd-qv"][2].extend(p for p, *_ in HO_RDMA_PATHS)
#: rdma_stage's HO row: its x launch on rank 0's sources of the 1M metric
#: path, timed in time_grid_ho (its library yardstick: one torch.stack).
HO_STAGE_TIMED = {}


def closed_ho_band(local, consts_w):
    """The closed unweighted uniform HO instance's solver and consts at a
    form's band: the 29 consts, a 4 km mesh closed along the band."""
    mesh = RectMesh(local.mesh.nx, local.mesh.ny, 4e3, 4e3)
    return mevp_ho.MEVPSolverHO(mesh, MEVPParams()), {k: consts_w[k] for k in mevp_ho.HO_CONSTS}


def register_ho_band_form(label: str, captured: dict, err: float) -> None:
    """The row of an rdma_band HO form: its x launch (the y launch where only
    y is split) timed in turns with the closed unweighted uniform instance
    on the same band (none for that instance's own row), its plain version,
    and its bytes and operations (``rdma_band_work``: 17 planes and the
    form's 29-37 consts, the HO bodies' operations)."""
    axis = 0 if 0 in captured else 1
    local, src, consts_w, state0 = captured[axis]
    h = src.h
    nx, ny = src.own[0].shape
    work = rdma_band_work(axis, h, h, nx, ny, src.hx, len(consts_w), OPS["ho_stress"] + OPS["ho_velocity"],
                          planes=rdma.HO_PLANES)
    state_f, state_c = state0.clone(), state0.clone()
    closed = None
    if label != "rdma_band HO":
        solver_c, consts_c = closed_ho_band(local, consts_w)
        closed = lambda: rdma.rdma_band(solver_c, src, axis, consts_c, DT, h, state_c)
    timed_form(label, err, lambda: rdma.rdma_band(local, src, axis, consts_w, DT, h, state_f), closed,
               lambda: rdma.rdma_band_reference(local, src, axis, consts_w, DT, h, state0.clone()), work)
    along = rdma.band_shape(axis, h, nx, ny, src.hx)[1 - axis]
    log("check", (
        f"{label}: timed on rank 0's {'xy'[axis]} bands of a {nx}x{ny} block, h = {h}, {len(consts_w)} consts, "
        f"launch {rdma.launch_config(axis, rdma.HO_PLANES, h, along)}"
    ))


def ho_band_launches(model) -> str:
    """The HO band's launch geometry on each split axis of a rank model's
    block (``launch_config`` by the band's length and h)."""
    h, nx, ny = model.mevp.block_halo, model.mesh.nx, model.mesh.ny
    split = [ax is not None and ax.size > 1 for ax in model.spmd]
    hx = h if split[0] else 0
    out = []
    for axis in (0, 1):
        if split[axis]:
            along = rdma.band_shape(axis, h, nx, ny, hx)[1 - axis]
            band = rdma.launch_config(axis, rdma.HO_PLANES, h, along)
            out.append(f"{'xy'[axis]}: {band} ({band.rows(h)} rows a block, "
                       f"{2 * band.clusters(along, h) * band.cluster} blocks)")
    return "; ".join(out)


def check_grid_ho_rdma(device) -> tuple:
    """Phase: M10b part 2b, first half. Each HO_RDMA_PATHS path on the rdma
    schedule: one decomposed step from zeroed launch counts against the
    single-device HO step and (the battery's configs) the blocked
    schedule's decomposed step (expected 0, failing above
    TOL_SAME_SCHEDULE); one round on every rank from the state after it,
    each rdma_stage launch (17 planes) and rank 0's HO rdma_band launches,
    x and y, against their plain versions (TOL_LAUNCH, per plane) and every
    rank's round against the blocked round (expected 0); then N5_STEPS
    steps from zeroed launch
    counts (at 16M the one step above): finite, bounded, land untouched,
    the interior kernel, rdma_stage, rdma_band and transport_tiled
    launched. Returns (counts by path, the largest error per kernel)."""
    errs = {"rdma_stage": 0.0, "rdma_band": 0.0}
    counts, rows = {}, {path: label for label, path in HO_RDMA_ROWS.items()}
    for path, kind, n, coast, shape, weighted in HO_RDMA_PATHS:
        t0 = time.perf_counter()
        single, model, sharded, state, phys, dyn = ho_grid_model(
            device, kind, n, coast, backend="rdma", shape=shape, weighted=weighted)
        schedule = model.schedule(device)
        interior = model.mevp.local().schedule(cc.sm_count(device))
        log("slice", (
            f"{path}: {n}^2 {type(single.mesh).__name__}{' with the coastline' if coast else ''}"
            f"{', A-weighted' if weighted else ''}, HO on a {shape[0]}x{shape[1]} rank grid of "
            f"{model.mesh.nx}x{model.mesh.ny} blocks ({type(model.mesh).__name__}), schedule {schedule}, h = "
            f"{model.mevp.block_halo}, interior pass {interior}, HO band launches "
            f"{ho_band_launches(model)}; single-device {single.schedule(device)}"
        ))
        if (not model.is_high_order or schedule != ("rdma", "tiled")
                or PATH_KERNELS[path] and PATH_KERNELS[path][0] != f"ho_{interior}"):
            raise AssertionError(f"{path} does not run HO on ('rdma', 'tiled') with {PATH_KERNELS[path][0]}: "
                                 f"{schedule}, interior {interior}")
        t1 = time.perf_counter()
        ref = single.step(state, phys, dyn, DT)
        cc.reset_launches()
        got = sharded(state, phys, dyn, DT)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        compare_sharded_step(f"{path}.step vs single-device", got, ref, tol_same=True)
        del ref
        if shape == RANKS and n >= N4:  # the battery's configs
            blocked = ho_grid_model(device, kind, n, coast, shape=shape, weighted=weighted)[2]
            compare_sharded_step(f"{path}.step", got, blocked(state, phys, dyn, DT), tol_same=True,
                                 other="the blocked schedule's decomposed step")
            del blocked
        t2 = time.perf_counter()
        # Every rank's round against the blocked round, and each launch of
        # rank 0's round (its x and y bands) against plain: the plain HO
        # band takes ~2.5 s of host issue a pair of bands.
        captured = rdma_form_launches(device, sharded, got, phys, dyn, path, errs, band_ranks=(0,))
        if path in rows:
            register_ho_band_form(rows[path], captured, errs["rdma_band"])
        if path == "ho_coupled_1m_spherical_spmd_rdma":
            HO_STAGE_TIMED["x"] = captured[0][1]
        if n == N16:  # the 16M band's plain version, once (seconds a pair)
            local, src, consts_w, state0 = captured[0]
            plain = time_ms(lambda: rdma.rdma_band_reference(local, src, 0, consts_w, DT, src.h, state0.clone()), 1)
            log("time", (
                f"{path}: plain rdma_band HO (metric) on rank 0's x bands of a {src.own[0].shape[0]}x"
                f"{src.own[0].shape[1]} block, h = {src.h}: {plain:.4f} ms a pair"
            ))
        del captured
        t3 = time.perf_counter()
        # N5_STEPS steps from zeroed launch counts; at 16M the one step above.
        n_steps = 1 if n > N4 else N5_STEPS
        if n_steps > 1:
            del got
            cc.reset_launches()
            got = sharded.grid.gather_tree(
                sharded.run_blocks(*blocks_of(sharded, state, phys, dyn), DT, n_steps), device)
            torch.cuda.synchronize()
            counts[path] = dict(cc.launches)
        log("slice", f"{path}: {n_steps} steps, launches: {counts[path]}")
        check_bounded(f"{path}: {n_steps} steps", got, state)
        if coast:
            check_land(f"{path}: {n_steps} steps", single, got, state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
        log("time", (
            f"check_grid_ho_rdma {path}: build {t1 - t0:.1f} s, steps against single-device and blocked "
            f"{t2 - t1:.1f} s, the round's launches {t3 - t2:.1f} s, {n_steps} steps {time.perf_counter() - t3:.1f} s"
        ))
        del single, model, sharded, state, got
    for label in HO_RDMA_ROWS:
        TVB_FORMS[label] = replace(TVB_FORMS[label], err=errs["rdma_band"])
    src = HO_STAGE_TIMED["x"]
    strip = rdma.HO_PLANES * src.h * src.own[0].shape[1] * 4
    TVB_FORMS["rdma_stage HO"] = Row(errs["rdma_stage"], 0.0, 0.0, 2 * 2 * strip, 0)
    return counts, errs


def time_grid_ho_rdma(device, card: str) -> None:
    """The HO rdma schedule: ms per step of ho_coupled_1m_spherical_spmd on
    it at h = 16, in turns with the
    blocked schedule at h = 16, in chunks of HO_GRID_CHUNK steps on
    resident blocks; a profile of each rdma step (its idle share and the
    HO rdma_band's ms a launch); rdma_stage's HO row (its x launch on a
    round's new sources in turns with one torch.stack of the 34 strips)."""
    for path, kind, n, coast, _ in HO_GRID_PATHS:
        if path != HO_GRID_TIMED[0]:  # the 1M config; the 16M one is checked, not timed, on rdma
            continue
        fns, grids = {}, {}
        for backend, h in (("blocked", 16), ("rdma", 16)):
            _, _, sharded, state, phys, dyn = ho_grid_model(device, kind, n, coast, h, backend=backend)
            grids[(backend, h)] = (sharded, blocks_of(sharded, state, phys, dyn))
            fns[f"2x2 {backend} h={h}"] = lambda g=grids[(backend, h)]: g[0].run_blocks(*g[1], DT, HO_GRID_CHUNK)
        runs = time_in_turns(fns, dict.fromkeys(fns, 1))
        for name, ms in runs.items():
            report(f"{path} coupled step, {name} ({n}x{n}, {HO_GRID_CHUNK} steps a chunk)",
                   [m / HO_GRID_CHUNK for m in ms], n * n, card)
        sharded, blocks = grids[("rdma", 16)]
        profile(f"{path} coupled step, 2x2 rdma h=16 ({n}x{n})", lambda: sharded.run_blocks(*blocks, DT, 1),
                n_steps=2, watch="rdma_band_ho")
        del fns, grids, runs
    src = HO_STAGE_TIMED["x"]
    device = src.own[0].device
    fresh = lambda: rdma.RoundSources(src.own, src.h, src.split, src.gx, src.gy, stream=cc._stream(device))
    nx, h = src.own[0].shape[0], src.h
    runs = time_in_turns({
        "new": lambda: rdma.rdma_stage(fresh(), 0),
        "stack": lambda: torch.stack([p[:h] for p in src.own] + [p[nx - h:] for p in src.own]),
        "plain": lambda: rdma.rdma_stage_reference(src, 0),
    }, {"new": 50, "stack": 50, "plain": None})
    mean = {name: sum(ms) / len(ms) for name, ms in runs.items()}
    row = TVB_FORMS["rdma_stage HO"]
    TVB_FORMS["rdma_stage HO"] = replace(row, ms=mean["new"], plain_ms=mean["plain"], library_ms=mean["stack"])
    cached = fresh()
    DEVICE_PROBES["rdma_stage HO axis 0"] = lambda: rdma.rdma_stage(cached, 0)
    log("time", (
        f"rdma_stage HO axis 0 (17 planes, a {nx}x{src.own[0].shape[1]} block, h = {h}): "
        f"{', '.join(f'{m:.5f}' for m in runs['new'])} ms per call on a round's new sources, library "
        f"yardstick (one torch.stack of the 34 strips) {', '.join(f'{m:.5f}' for m in runs['stack'])} ms "
        f"(in turns), plain {mean['plain']:.5f} ms, bound {bound(row.n_bytes, 0)[0]:.5f} ms on {card}"
    ))


# -- M10b part 2b second half and M10c: TVB on a card's rank grid ---------------------
#: The paths of phase check_grid_tvb, at full width (config 4's state and
#: forcing, 100 subcycles, dG1, f32, 2 x 2 ranks of the card unless said):
#: (path, mesh kind, n, HO, rank grid, CoupledModel keywords, schedule).
#: a: ho_coupled_1m with TVB (M = 0 on blocked h = 16, the middle M on rdma):
#: the spmd transport_tiled's qv + walls instance; b: the HO 256^2 mesh
#: periodic in both axes with the middle M (walls -1 on the rings of ranks);
#: c: coupled_1m_spherical_spmd with TVB (M = 0 blocked, the middle M on
#: rdma): the staged route's CG1 metric halo forms with the tolerance planes;
#: d: ho_coupled_1m_spherical_spmd with the middle M: the staged HO metric qv
#: route; e: the 1024^2 ring with the coastline and M = 0 on 1 x 2 ranks (x
#: not split: the ring's wrap through the ghost ring); f: config 4 with
#: transport_backend="xla" and no TVB: the positivity-limited halo stage.
GRID_TVB_PATHS = [
    ("grid_tvb_ho_1m_m0", "uniform", N4, True, RANKS, {"tvb_m": 0.0}, ("blocked", "tiled")),
    ("grid_tvb_ho_1m_mmid_rdma", "uniform", N4, True, RANKS, {"tvb_m": "mid", "mevp_backend": "rdma"},
     ("rdma", "tiled")),
    ("grid_tvb_ho_256_periodic", "periodic", N, True, RANKS, {"tvb_m": "mid"}, ("blocked", "tiled")),
    ("grid_tvb_spherical_m0", "spherical", N4, False, RANKS, {"tvb_m": 0.0}, ("blocked", "xla")),
    ("grid_tvb_spherical_mmid_rdma", "spherical", N4, False, RANKS, {"tvb_m": "mid", "mevp_backend": "rdma"},
     ("rdma", "xla")),
    ("grid_tvb_ho_spherical", "spherical", N4, True, RANKS, {"tvb_m": "mid"}, ("blocked", "xla")),
    ("grid_tvb_ring_1x2", "ring", N4, False, (1, 2), {"tvb_m": 0.0}, ("blocked", "xla")),
    ("grid_staged_uniform", "uniform", N4, False, RANKS, {"transport_backend": "xla"}, ("blocked", "xla")),
]
#: Steps a path checks against the single-device step, and the first
#: path's steps checked for boundedness.
GRID_TVB_STEPS = 4
GRID_TVB_STEPS_LONG = 20
#: The paths timed in time_grid_tvb beside the single-device step (runs a,
#: c and d), in chunks of HO_GRID_CHUNK steps.
GRID_TVB_TIMED = ("grid_tvb_ho_1m_m0", "grid_tvb_spherical_m0", "grid_tvb_ho_spherical")
#: The paths whose new forms are checked launch by launch (and on which
#: their rows are timed).
GRID_TVB_ROWS = {
    "transport_tiled spmd-qv-tvb": "grid_tvb_ho_1m_m0", "dg1_rk_stage halo": "grid_tvb_spherical_m0",
    "dg1_rk_stage halo-qv": "grid_tvb_ho_spherical", "dg1_limit halo": "grid_tvb_spherical_m0",
}
GRID_TVB_BUILT = {}


def _grid_tvb_kernels(ho: bool, n: int, schedule: tuple, tvb: bool) -> tuple:
    interior = ("ho_tiled" if n >= N4 else "ho_single") if ho else "mevp_tiled"
    rdma_kernels = ("rdma_stage", "rdma_band") if schedule[0] == "rdma" else ()
    if schedule[1] == "tiled":
        return (interior, *rdma_kernels, "transport_tiled")
    cfl = () if ho else ("dg1_sample_cfl",)
    return (interior, *rdma_kernels, *cfl, "dg1_rk_stage") + (("dg1_limit",) if tvb else ())


PATH_KERNELS.update({
    path: _grid_tvb_kernels(ho, n, schedule, "tvb_m" in kwargs)
    for path, _, n, ho, _, kwargs, schedule in GRID_TVB_PATHS
})
_STAGED_CG1 = [p for p, _, _, ho, _, _, s in GRID_TVB_PATHS if s[1] == "xla" and not ho]
_STAGED_TVB = [p for p, _, _, _, _, kw, s in GRID_TVB_PATHS if s[1] == "xla" and "tvb_m" in kw]
FORM_ROWS.update({
    "transport_tiled spmd-qv-tvb": ("transport_tiled", "nextsimdg_tpu_torch/csrc/transport_tiled_spmd_qv.cu",
                                    [p for p, *_, s in GRID_TVB_PATHS if s[1] == "tiled"]),
    "dg1_rk_stage halo": ("dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_spmd.cu", _STAGED_CG1),
    "dg1_rk_stage halo-qv": ("dg1_rk_stage", "nextsimdg_tpu_torch/csrc/transport_spmd_qv.cu",
                             [p for p, _, _, ho, _, _, s in GRID_TVB_PATHS if s[1] == "xla" and ho]),
    "dg1_limit halo": ("dg1_limit", "nextsimdg_tpu_torch/csrc/transport_tvb_spmd.cu", _STAGED_TVB),
})
# The other kernels' forms on these paths count on their forms' rows.
FORM_ROWS["ho_tiled metric"][2].extend(
    p for p, kind, n, ho, *_ in GRID_TVB_PATHS if ho and kind == "spherical" and n >= N4)
FORM_ROWS["rdma_band metric"][2].append("grid_tvb_spherical_mmid_rdma")
FORM_ROWS["rdma_band HO"][2].append("grid_tvb_ho_1m_mmid_rdma")
FORM_ROWS["rdma_stage HO"][2].append("grid_tvb_ho_1m_mmid_rdma")


def grid_tvb_model(device, kind: str, n: int, ho: bool, shape, kwargs: dict, mid: dict):
    """(single-device model, rank 0's model, the ShardedCoupledModel, state,
    phys, dyn) of a GRID_TVB_PATHS path: config 4's model, state (with
    fronts under TVB) and forcing on the spherical window or the ring with
    the coastline, or on config 4's uniform mesh (periodic in both axes for
    "periodic"); the HO solver selected through the registry for ``ho``;
    tvb_m "mid": ``mid[(kind, n)]``."""
    kwargs = dict(kwargs)
    if kwargs.get("tvb_m") == "mid":
        kwargs["tvb_m"] = mid[(kind, n)]
    backend = kwargs.pop("mevp_backend", "blocked")
    mesh, ocean = grid_tvb_mesh(kind, n)
    loader = modules.get_loader()
    if ho:
        loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        single, state, phys, dyn = coupled_model(device, mesh, ocean, **kwargs)
        model, sharded = build_sharded_coupled_model(
            mesh, RankGrid(*shape, device), degree=1, n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
            mevp_backend=backend, **kwargs,
        )
    finally:
        if ho:
            loader.reset()
    if "tvb_m" in kwargs:
        state = with_fronts(state, SEED + 60)
    return single, model, sharded, state, phys, dyn


def grid_tvb_mesh(kind: str, n: int):
    """(mesh, ocean mask or None) of a GRID_TVB_PATHS kind."""
    if kind in ("spherical", "ring"):
        return (spherical_mesh(n) if kind == "spherical" else ring_mesh(n)), synthetic_coastline(n)
    periodic = kind == "periodic"
    return RectMesh(n, n, dx=4e3, dy=4e3, periodic_x=periodic, periodic_y=periodic), None


def widened_block(f, coords, block, periodic):
    """The block at ``coords`` (``block`` its shape) of the global field
    ``f`` (..., nx, ny) widened by one ring: zeros beyond a closed wall, the
    wrapped cells on a periodic axis (what the exchange brings)."""
    for axis, wraps in ((-2, periodic[0]), (-1, periodic[1])):
        n = f.shape[axis]
        lo, hi = f.narrow(axis, n - 1, 1), f.narrow(axis, 0, 1)
        if not wraps:
            lo, hi = torch.zeros_like(lo), torch.zeros_like(hi)
        f = torch.cat([lo, f, hi], dim=axis)
    (ix, iy), (bx, by) = coords, block
    return f[..., ix * bx: (ix + 1) * bx + 2, iy * by: (iy + 1) * by + 2].contiguous()


def halo_form_launches(tag: str, single, model, state, errs: dict, rows=()) -> None:
    """Rank 0's halo forms at the path's shape, on its block of ``state``
    widened by one ring: dg1_rk_stage's halo form (a = 0, then blended;
    positivity-limited, or with TVB unlimited) against its plain version
    (TOL_LAUNCH) and against the single-domain kernel's stage on the
    global state restricted to the block (expected 0); with TVB dg1_limit's
    halo form on that stage (the neighbours' means from the global stage)
    likewise. ``rows``: the form rows to register for timing here (the
    halo stage timed against the single-domain stage on the unwidened
    block, the halo limiter against dg1_limit there)."""
    device = state.hice.device
    tr, mesh = single.transport, single.mesh
    periodic = (mesh.periodic_x, mesh.periodic_y)
    block = (model.mesh.nx, model.mesh.ny)
    wide = lambda f: widened_block(f, (0, 0), block, periodic)
    own = lambda f: f[..., : block[0], : block[1]].contiguous()
    psi = torch.stack([state.hice, state.cice, state.hsnow], dim=1)
    faces = single.face_masks(device=device, dtype=torch.float32) or (torch.ones_like(state.sst),) * 2
    fields = ("vx_vol", "vy_vol", "vn_x", "vn_y")
    u = v = qv = u_w = v_w = qv_w = None
    if single.is_high_order:
        qv = mevp_ho.ho_velocity_to_quad(mesh, tr.basis, state.velocity.u, state.velocity.v)
        qv_w = type(qv)(*(wide(getattr(qv, f)) for f in fields))
    else:
        u, v = state.velocity.u, state.velocity.v
        u_w, v_w = wide(u), wide(v)
    local = model.widened_transport(1)
    metric = model.widened_metric(1, device=device, dtype=torch.float32)
    walls = tt.spmd_walls(model, 1)
    tvb, dt = tr.limits_slopes, DT / 3
    psi_w, base = wide(psi), own(psi)
    args = (local, psi_w, base, u_w, v_w, wide(faces[0]), wide(faces[1]), walls)
    stages = {}
    for a, b in ((0.0, 1.0), (0.5, 0.5)):
        got = cc.dg1_rk_stage_halo(*args, a, b, dt, qv=qv_w, metric=metric, tvb=tvb)
        ref = cc.dg1_rk_stage_halo_reference(*args, a, b, dt, qv=qv_w, metric=metric, tvb=tvb)
        errs["dg1_rk_stage"] = max(errs["dg1_rk_stage"], compare(
            f"{tag} dg1_rk_stage halo{' qv' if qv is not None else ''} rank 0 a = {a}", got, ref, TOL_LAUNCH))
        stages[a] = cc.dg1_rk_stage(tr, psi, psi, u, v, *faces, a, b, dt, qv=qv, tvb=tvb)
        same_schedule(f"{tag} dg1_rk_stage halo rank 0 a = {a}", got, own(stages[a]),
                      "the single-domain stage on its block")
    limit_args = None
    if tvb:
        stage = stages[0.5]
        limit_args = (model.transport, own(stage), wide(stage[0]), walls)
        got = cc.dg1_limit_halo(*limit_args)
        errs["dg1_limit"] = max(errs["dg1_limit"], compare(
            f"{tag} dg1_limit halo rank 0", got, cc.dg1_limit_halo_reference(*limit_args), TOL_LAUNCH))
        same_schedule(f"{tag} dg1_limit halo rank 0", got, own(cc.dg1_limit(tr, stage)),
                      "the single-domain limiter on its block")
    torch.cuda.synchronize()
    n_own = block[0] * block[1]
    stream, out = cc._stream(device), torch.empty_like(base)
    rank_tr = model.transport
    tables_own, wall_array, wrap = cc._dg1_tables(rank_tr), cc._walls(walls), cc.wrap_bits(model.mesh)
    if any(r.startswith("dg1_rk_stage") for r in rows):
        label = next(r for r in rows if r.startswith("dg1_rk_stage"))
        qv_ptrs = None if qv_w is None else cc._dg1_qv(qv_w, psi_w.shape[-2:], device, 1)
        qv_own = None if qv is None else type(qv)(*(own(getattr(qv, f)) for f in fields))
        qv_own_ptrs = None if qv is None else cc._dg1_qv(qv_own, block, device, 1)
        uv_own = (None, None) if u is None else (own(u), own(v))
        faces_own = (own(faces[0]), own(faces[1]))
        metric_ptrs, metric_own = cc._dg1_metric(local, device, metric), cc._dg1_metric(rank_tr, device)
        tables = cc._dg1_tables(local)
        work = stage_work(1, n_own, qv is not None, metric is not None, True)
        limit_ops = stage_cell_ops(1, True, True) - stage_cell_ops(1, True, False)
        if tvb:
            work = (work[0], work[1] - cc.STAGE_TRACERS * limit_ops * n_own)
        timed_form(
            label, errs["dg1_rk_stage"],
            lambda: cc._dg1_rk_stage_halo_(psi_w, base, u_w, v_w, *args[5:7], metric_ptrs, out, 0.5, 0.5, dt,
                                           tables, stream, wall_array, qv=qv_ptrs, tvb=tvb),
            # keep: the planes behind the pointer arrays qv_own_ptrs and metric_own (the block's
            # samples, the rank transport's metric planes) live as long as the timed launch.
            lambda keep=(qv_own, rank_tr): cc._dg1_rk_stage_(
                base, base.flip(0).contiguous(), *uv_own, *faces_own, metric_own, out, 0.5, 0.5, dt, tables_own,
                stream, qv=qv_own_ptrs, tvb=tvb, wrap=wrap),
            lambda: cc.dg1_rk_stage_halo_reference(*args, 0.5, 0.5, dt, qv=qv_w, metric=metric, tvb=tvb),
            work)
    if "dg1_limit halo" in rows:
        tolerances = rank_tr.tvb_tolerances(device=device, dtype=torch.float32)
        scratch, scratch_closed, means_w = limit_args[1].clone(), limit_args[1].clone(), limit_args[2]
        planes = isinstance(tolerances[0], torch.Tensor)
        timed_form(
            "dg1_limit halo", errs["dg1_limit"],
            lambda: cc._dg1_limit_halo_(scratch, means_w, tolerances, tables_own, stream, wall_array),
            lambda: cc._dg1_limit_(scratch_closed, tolerances, tables_own, stream, wrap),
            lambda: cc.dg1_limit_halo_reference(*limit_args),
            ((2 * 3 - 1) * 3 * 4 * n_own + (2 if planes else 0) * 4 * n_own + 3 * 4 * (block[0] + 2) * (block[1] + 2),
             3 * tvb_limit_ops(1) * n_own))


def count_exchanges(run) -> dict:
    """``run()`` with every exchange started (``AxisExchange.start``: one
    strip pair along one axis) counted by rank thread; returns the counts."""
    import threading

    from nextsimdg_tpu_torch.parallel.exchange import AxisExchange

    start, counts, lock = AxisExchange.start, {}, threading.Lock()

    def counting(self, to_prev, to_next):
        with lock:
            name = threading.current_thread().name
            counts[name] = counts.get(name, 0) + 1
        return start(self, to_prev, to_next)

    AxisExchange.start = counting
    try:
        run()
    finally:
        AxisExchange.start = start
    return counts


def check_grid_tvb(device) -> tuple:
    """Phase: M10b part 2b second half and M10c, TVB on a card's rank grid.
    Each GRID_TVB_PATHS path at full width: GRID_TVB_STEPS decomposed steps
    from zeroed launch counts against as many single-device steps (expected
    0, failing above TOL_SAME_SCHEDULE), bounded with land untouched, every
    kernel of the path launched (the first path GRID_TVB_STEPS_LONG steps);
    the middle M's paths print the shares their limiter cuts and keeps; each
    path's exchanges and launches a rank and step (one more step, counted).
    The new forms launch by launch: every spmd transport_tiled launch of the
    qv + walls instance against plain (run a, all ranks), rank 0's halo
    dg1_rk_stage (CG1 and qv forms, positivity-limited and TVB) and halo
    dg1_limit against plain (TOL_LAUNCH) and against the single-domain
    kernels on the block (expected 0). Returns (counts by path, the largest
    error per kernel)."""
    errs = {"transport_tiled": 0.0, "dg1_rk_stage": 0.0, "dg1_limit": 0.0}
    counts, mid = {}, {}
    rows = {}
    for label, path in GRID_TVB_ROWS.items():
        rows.setdefault(path, []).append(label)
    for i, (path, kind, n, ho, shape, kwargs, schedule) in enumerate(GRID_TVB_PATHS):
        t_build = time.perf_counter()
        if kwargs.get("tvb_m") == "mid" and (kind, n) not in mid:
            mesh, ocean = grid_tvb_mesh(kind, n)
            mid[(kind, n)] = middle_m(with_fronts(coupled_model(device, mesh, ocean)[1], SEED + 60).hice, mesh)
            log("slice", f"{kind} {n}^2: the middle M from the state's |psi1|: {mid[(kind, n)]:.4e}")
        single, model, sharded, state, phys, dyn = grid_tvb_model(device, kind, n, ho, shape, kwargs, mid)
        t0 = time.perf_counter()
        got_schedule = model.schedule(device)
        log("slice", (
            f"{path}: {n}^2 {type(single.mesh).__name__} periodic ({single.mesh.periodic_x}, "
            f"{single.mesh.periodic_y}){' with the coastline' if single.ocean_mask is not None else ''}, "
            f"{'HO' if ho else 'CG1'} on a {shape[0]}x{shape[1]} rank grid of {model.mesh.nx}x{model.mesh.ny} "
            f"blocks, schedule {got_schedule}, single-device {single.schedule(device)}, tvb_m "
            f"{model.transport.tvb_m}, spmd transport (H, k_cap) = {tt.transport_tiled_spmd_config(model)}, "
            f"walls {tt.spmd_walls(model, 1)}"
        ))
        if got_schedule != schedule or model.is_high_order != ho:
            raise AssertionError(f"{path} does not run {'HO' if ho else 'CG1'} on {schedule}: {got_schedule}")
        if single.transport.limits_slopes:
            cut, kept = tvb_shares(single.transport, state)
            log("slice", f"{path}: the limiter cuts {cut:.4f} of the elements and keeps {kept:.4f} of the step's tracers")
            if kwargs.get("tvb_m") == "mid" and not (cut > 0.05 and kept > 0.05):
                raise AssertionError(f"{path}: the middle M does not take both branches ({cut:.4f} cut)")
        ref = single.run(state, phys, dyn, DT, GRID_TVB_STEPS)
        blocks = blocks_of(sharded, state, phys, dyn)
        cc.reset_launches()
        got = sharded.grid.gather_tree(sharded.run_blocks(*blocks, DT, GRID_TVB_STEPS), device)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        compare_sharded_step(f"{path}: {GRID_TVB_STEPS} steps vs single-device", got, ref, tol_same=True)
        del ref
        log("slice", f"{path}: {GRID_TVB_STEPS} steps, launches: {counts[path]}")
        check_bounded(f"{path}: {GRID_TVB_STEPS} steps", got, state)
        if single.ocean_mask is not None:
            check_land(f"{path}: {GRID_TVB_STEPS} steps", single, got, state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
        t1 = time.perf_counter()
        cc.reset_launches()
        exchanges = count_exchanges(lambda: sharded.run_blocks(*blocks, DT, 1))
        torch.cuda.synchronize()
        ranks = shape[0] * shape[1]
        log("slice", (
            f"{path}: one step: exchanges a rank {sorted(exchanges.values())}, launches a rank "
            f"{ {k: c / ranks for k, c in cc.launches.items() if c} }"
        ))
        if i == 0:
            long = sharded.grid.gather_tree(sharded.run_blocks(*blocks, DT, GRID_TVB_STEPS_LONG), device)
            torch.cuda.synchronize()
            check_bounded(f"{path}: {GRID_TVB_STEPS_LONG} steps", long, state)
            del long
        t2 = time.perf_counter()
        if schedule[1] == "tiled" and "transport_tiled spmd-qv-tvb" in rows.get(path, ()):
            launches = spmd_transport_launches(device, sharded, got, path, errs)
            if launches[0][3].get("walls") is None or launches[0][3].get("qv") is None:
                raise AssertionError(f"{path}: the spmd transport ran without the samples or the walls")
            transport = launches[0][2][0]
            register_transport_form("transport_tiled spmd-qv-tvb", launches, errs,
                                    (transport, {"qv": launches[0][3]["qv"]}))
        elif schedule[1] == "tiled" and path == "grid_tvb_ho_256_periodic":
            spmd_transport_launches(device, sharded, got, path, errs)
        if schedule[1] == "xla":
            halo_form_launches(path, single, model, got, errs, rows.get(path, ()))
        if path in GRID_TVB_TIMED:
            GRID_TVB_BUILT[path] = (single, sharded, state, phys, dyn)
        del got
        log("time", (
            f"check_grid_tvb {path}: build {t0 - t_build:.1f} s, {GRID_TVB_STEPS} steps on both and checks "
            f"{t1 - t0:.1f} s, counted step{' and the long run' if i == 0 else ''} {t2 - t1:.1f} s, "
            f"launch checks {time.perf_counter() - t2:.1f} s"
        ))
    for label in GRID_TVB_ROWS:
        TVB_FORMS[label] = replace(TVB_FORMS[label], err=errs[label.split()[0]])
    return counts, errs


def time_grid_tvb(device, card: str) -> None:
    """Run a (the first of GRID_TVB_TIMED; c and d are checked, not timed): ms per
    step in chunks of HO_GRID_CHUNK steps on resident blocks, in turns with
    the single-device step; a profile of 1 step of its grid (wall ms, busy
    ms, idle share, device activities a step; the transport kernels' ms a
    launch)."""
    for path in GRID_TVB_TIMED:
        single, sharded, state, phys, dyn = GRID_TVB_BUILT.pop(path)
        if path != GRID_TVB_TIMED[0]:  # built by check_grid_tvb; checked there, not timed, to keep the run's time
            del single, sharded, state, phys, dyn
            continue
        blocks = blocks_of(sharded, state, phys, dyn)
        n = single.mesh.nx
        runs = time_in_turns({
            "single-device": lambda: single.run(state, phys, dyn, DT, HO_GRID_CHUNK),
            "2x2 grid": lambda: sharded.run_blocks(*blocks, DT, HO_GRID_CHUNK),
        }, {"single-device": 1, "2x2 grid": 1})
        for name, ms in runs.items():
            report(f"{path} coupled step, {name} ({n}x{n}, {HO_GRID_CHUNK} steps a chunk)",
                   [m / HO_GRID_CHUNK for m in ms], n * n, card)
        profile(f"{path} coupled step, 2x2 grid ({n}x{n})", lambda: sharded.run_blocks(*blocks, DT, 1),
                n_steps=1, watch="transport_tiled" if single.transport_schedule() == "tiled" else "dg1_")
        del single, sharded, state, blocks


# -- M10d: the mEVP's width-1 ("xla") schedule on a card's rank grid -------------------
#: The paths of phase check_grid_xla, at full width (config 4's state and
#: forcing, 100 subcycles, dG1, f32, 2 x 2 ranks of the card), each on
#: mevp_backend="xla": (path, mesh kind, n, HO, CoupledModel keywords,
#: steps). The battery's coupled_1m_spherical_spmd and
#: ho_coupled_1m_spherical_spmd (the spherical window with the coastline),
#: the uniform 2 x 2 box (config 4's mesh, HO, A-weighted), the 1024^2 ring
#: with the coastline (CG1, A-weighted and adaptive: the ring of ranks
#: through the strips), and BASELINE config 5's spherical cells
#: spherical_16m_spmd and ho_spherical_16m_spmd (4096^2, 2048^2 blocks).
GRID_XLA_PATHS = [
    ("coupled_1m_spherical_spmd_xla", "spherical", N4, False, {}, 4),
    ("ho_coupled_1m_spherical_spmd_xla", "spherical", N4, True, {}, 4),
    ("grid_xla_ho_uniform_aweighted", "uniform", N4, True, {"mevp_params": MEVPParams(a_weighted_stress=True)}, 4),
    ("grid_xla_ring", "ring", N4, False, {"mevp_params": MEVPParams(a_weighted_stress=True, adaptive_alpha=True)}, 4),
    ("spherical_16m_spmd_xla", "spherical", N16, False, {}, 2),
    ("ho_spherical_16m_spmd_xla", "spherical", N16, True, {}, 1),
]
#: The paths whose halo launches are held against their plain versions
#: launch by launch over one step: (ranks, launches of each kernel a rank):
#: None for all. Every rank on the spherical cell; on the ring rank 0 (its
#: -1 strips come round the ring of ranks); the HO halves' plain versions on
#: rank 0 only, and at 16M the first few launches, to fit the budget.
GRID_XLA_CHECKED = {
    "coupled_1m_spherical_spmd_xla": (None, None), "grid_xla_ring": ((0,), None),
    "ho_coupled_1m_spherical_spmd_xla": ((0,), None), "grid_xla_ho_uniform_aweighted": ((0,), None),
    "spherical_16m_spmd_xla": ((0,), 4), "ho_spherical_16m_spmd_xla": ((0,), 4),
}
XLA_HALVES = {False: ("mevp_stress", "mevp_velocity"), True: ("ho_stress", "ho_velocity")}
_XLA_CG1 = [p for p, _, _, ho, _, _ in GRID_XLA_PATHS if not ho]
PATH_KERNELS.update({
    path: XLA_HALVES[ho] + (() if ho else ("dg1_sample_cfl",)) + ("transport_tiled",)
    for path, _, _, ho, _, _ in GRID_XLA_PATHS
})
REPLACES.update(ho_stress="nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py:45",
                ho_velocity="nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py:45")
SOURCES.update(ho_stress="nextsimdg_tpu_torch/csrc/ho_halves_spmd.cu",
               ho_velocity="nextsimdg_tpu_torch/csrc/ho_halves_spmd.cu")
FORM_ROWS.update({
    "mevp_stress halo": ("mevp_stress", "nextsimdg_tpu_torch/csrc/mevp_spmd.cu", _XLA_CG1),
    "mevp_velocity halo": ("mevp_velocity", "nextsimdg_tpu_torch/csrc/mevp_spmd.cu", _XLA_CG1),
})
# The spmd transport's launches on these paths count on its forms' rows.
FORM_ROWS["transport_tiled spmd-metric"][2].extend(_XLA_CG1)
FORM_ROWS["transport_tiled spmd-qv"][2].extend(p for p, _, _, ho, _, _ in GRID_XLA_PATHS if ho)
#: The HO halves' rows (kernels of their own), filled by time_grid_xla.
XLA_ROWS = {}
#: A timed launch of each halo kernel at config 5's 2048^2 block (spherical:
#: the metric forms), captured by check_grid_xla.
XLA_TIMED = {}


def grid_xla_model(device, kind: str, n: int, ho: bool, kwargs: dict, backends=("xla", "blocked")):
    """(single-device model, {backend: ShardedCoupledModel}, state, phys,
    dyn) of a GRID_XLA_PATHS path on 2 x 2 ranks, one sharded model a mEVP
    schedule of ``backends``; the HO solver selected through the registry
    for ``ho``."""
    mesh, ocean = grid_tvb_mesh(kind, n)
    loader = modules.get_loader()
    if ho:
        loader.set_implementation("Nextsim::IDynamics", HO)
    try:
        single, state, phys, dyn = coupled_model(device, mesh, ocean, **kwargs)
        grids = {
            backend: build_sharded_coupled_model(
                mesh, RankGrid(*RANKS, device), degree=1, n_subcycles=N_SUBCYCLES, ocean_mask=ocean,
                mevp_backend=backend, **kwargs,
            )[1]
            for backend in backends
        }
    finally:
        if ho:
            loader.reset()
    return single, grids, state, phys, dyn


def xla_halo_launches(tag: str, sharded, blocks, checked, errs: dict) -> dict:
    """One step of the xla route on ``blocks`` with the halo launches of
    ``checked`` = (ranks, limit) (None: all ranks; the first ``limit``
    launches of each kernel a rank, None: all) held against their plain
    versions on the same inputs (TOL_LAUNCH of each plane's max), one line
    a kernel and rank; the first launch of each kernel at this path's shape
    kept for timing (``XLA_TIMED``); returns the exchanges a rank (each
    started strip exchange along one axis)."""
    ranks, limit = checked
    import threading

    local, lock, seen = threading.local(), threading.Lock(), {}
    launch = {"mevp": cc._mevp_halo_, "ho": cc._ho_halo_}
    route = {name: getattr(cc, name) for name in ("spmd_xla_subcycles", "spmd_xla_ho_subcycles")}
    solvers = {id(m.mevp): r for r, m in enumerate(sharded.models)}

    def routed(name):
        def run(solver, carry, consts, dt, n_sub):
            rank = solvers[id(solver)]
            local.ctx = (solver, consts, dt, rank) if ranks is None or rank in ranks else None
            try:
                return route[name](solver, carry, consts, dt, n_sub)
            finally:
                local.ctx = None
        return run

    def record(kernel, rank, got, ref):
        worst = (0.0, 0.0)
        for g, r in zip(got, ref):
            err, scale = float((g.double() - r.double()).abs().max()), float(r.double().abs().max())
            if not bool(torch.isfinite(g).all()) or err > TOL_LAUNCH * scale:
                raise AssertionError(f"{tag} {kernel} rank {rank}: error {err:.3e} exceeds {TOL_LAUNCH:g} x {scale:.3e}")
            worst = max(worst, (err, err / scale if scale > 0 else 0.0))
        with lock:
            n, err, rel = seen.get((kernel, rank), (0, 0.0, 0.0))
            seen[(kernel, rank)] = (n + 1, max(err, worst[0]), max(rel, worst[1]))

    def context(kernel):
        ctx = getattr(local, "ctx", None)
        if ctx is None or (limit is not None and seen.get((kernel, ctx[3]), (0,))[0] >= limit):
            return None
        return ctx

    def checked_mevp(name, state, const_ptrs, c_w, inv_drag, beta, strips, metric, form, scalars, stream):
        ctx = context(name)
        before = None if ctx is None else state.clone()
        launch["mevp"](name, state, const_ptrs, c_w, inv_drag, beta, strips, metric, form, scalars, stream)
        if ctx is None:
            return
        solver, consts, dt, rank = ctx
        betas = () if beta is None else (beta,)
        if name == "mevp_stress":
            got = (state[2], state[3], state[4], c_w, inv_drag, *betas)
            ref = cc.mevp_stress_halo_reference(solver, tuple(before), consts, *strips)
        else:
            got = (state[0], state[1])
            ref = cc.mevp_velocity_halo_reference(
                solver, tuple(before), consts, c_w, inv_drag, dt, *strips, *(metric or (None, None)), *betas)
        record(name, rank, got, ref)
        XLA_TIMED.setdefault((name, state.shape[1]), (solver, tuple(before), consts, dt, c_w, inv_drag, beta,
                                                      strips, metric))

    def checked_ho(name, state, const_ptrs, strips, widths, form, scalars, tables, stream):
        ctx = context(name)
        before = None if ctx is None else state.clone()
        launch["ho"](name, state, const_ptrs, strips, widths, form, scalars, tables, stream)
        if ctx is None:
            return
        solver, consts, dt, rank = ctx
        if name == "ho_stress":
            ref, planes = cc.ho_stress_halo_reference(solver, before, consts, *strips), range(8, 17)
        else:
            ref, planes = cc.ho_velocity_halo_reference(solver, before, consts, dt, *strips, *(widths or (None, None))), range(8)
        record(name, rank, [state[q] for q in planes], [ref[q] for q in planes])
        XLA_TIMED.setdefault((name, state.shape[1]), (solver, before, consts, dt, strips, widths))

    saved = (cc._mevp_halo_, cc._ho_halo_, *route.values())
    cc._mevp_halo_, cc._ho_halo_ = checked_mevp, checked_ho
    cc.spmd_xla_subcycles, cc.spmd_xla_ho_subcycles = routed("spmd_xla_subcycles"), routed("spmd_xla_ho_subcycles")
    try:
        exchanges = count_exchanges(lambda: sharded.run_blocks(*blocks, DT, 1))
        torch.cuda.synchronize()
    finally:
        cc._mevp_halo_, cc._ho_halo_, cc.spmd_xla_subcycles, cc.spmd_xla_ho_subcycles = saved
    for (kernel, rank), (n, err, rel) in sorted(seen.items()):
        log("check", (
            f"{tag} {kernel} halo rank {rank}: {n} launches against the plain version, max_abs_err={err:.3e}, "
            f"max_rel_err={rel:.3e} (tol {TOL_LAUNCH:g} of each plane's max) ok"
        ))
        errs[kernel] = max(errs[kernel], err)
    return exchanges


def check_grid_xla(device) -> tuple:
    """Phase: M10d, the mEVP's width-1 ("xla") schedule on a card's rank
    grid. Each GRID_XLA_PATHS path at full width: its steps from zeroed
    launch counts against as many single-device steps and as many steps on
    the blocked schedule (the same bodies on the same values: expected 0,
    failing above TOL_SAME_SCHEDULE), bounded with land untouched, each
    halo half launched twice a subcycle and rank and no other mEVP kernel;
    on GRID_XLA_CHECKED one more step with every halo launch (of the ranks
    given) against its plain version (TOL_LAUNCH) and its exchanges a rank
    counted. Returns (counts by path, the largest error per kernel)."""
    errs = dict.fromkeys(("mevp_stress", "mevp_velocity", "ho_stress", "ho_velocity"), 0.0)
    counts = {}
    mevp_kernels = ("mevp_stress", "mevp_velocity", "mevp_tiled", "mevp_single", "ho_single", "ho_tiled",
                    "rdma_stage", "rdma_band", "ho_stress", "ho_velocity")
    for path, kind, n, ho, kwargs, steps in GRID_XLA_PATHS:
        t_build = time.perf_counter()
        single, grids, state, phys, dyn = grid_xla_model(device, kind, n, ho, kwargs)
        sharded = grids["xla"]
        model = sharded.models[0]
        t0 = time.perf_counter()
        log("slice", (
            f"{path}: {n}^2 {type(single.mesh).__name__} periodic ({single.mesh.periodic_x}, "
            f"{single.mesh.periodic_y}){' with the coastline' if single.ocean_mask is not None else ''}, "
            f"{'HO' if ho else 'CG1'} {MOMENTUM_FORM_NAMES[cc.mevp_form(model.mevp.params)]}, on a "
            f"{RANKS[0]}x{RANKS[1]} rank grid of "
            f"{model.mesh.nx}x{model.mesh.ny} blocks, schedule {model.schedule(device)}, single-device "
            f"{single.schedule(device)}"
        ))
        if model.schedule(device)[0] != "xla" or model.is_high_order != ho:
            raise AssertionError(f"{path} does not run {'HO' if ho else 'CG1'} on xla: {model.schedule(device)}")
        ref = single.run(state, phys, dyn, DT, steps)
        blocks = blocks_of(sharded, state, phys, dyn)
        cc.reset_launches()
        got = sharded.grid.gather_tree(sharded.run_blocks(*blocks, DT, steps), device)
        torch.cuda.synchronize()
        counts[path] = dict(cc.launches)
        compare_sharded_step(f"{path}: {steps} steps vs single-device", got, ref, tol_same=True)
        del ref
        blocked = grids["blocked"]
        other = blocked.grid.gather_tree(blocked.run_blocks(*blocks_of(blocked, state, phys, dyn), DT, steps), device)
        torch.cuda.synchronize()
        compare_sharded_step(f"{path}: {steps} steps vs blocked", got, other, tol_same=True, other="the blocked step")
        del other, blocked, grids
        log("slice", f"{path}: {steps} steps, launches: { {k: v for k, v in counts[path].items() if v} }")
        check_bounded(f"{path}: {steps} steps", got, state)
        if single.ocean_mask is not None:
            check_land(f"{path}: {steps} steps", single, got, state)
        missing = [name for name in PATH_KERNELS[path] if counts[path][name] == 0]
        expected = steps * N_SUBCYCLES * RANKS[0] * RANKS[1]
        wrong = {k: counts[path][k] for k in mevp_kernels if counts[path][k] != (expected if k in XLA_HALVES[ho] else 0)}
        if missing or wrong:
            raise AssertionError(f"{path}: kernels not launched {missing}, mEVP launches off {expected} a half: {wrong}")
        t1 = time.perf_counter()
        if path in GRID_XLA_CHECKED:
            exchanges = xla_halo_launches(path, sharded, blocks_of(sharded, got, phys, dyn), GRID_XLA_CHECKED[path],
                                          errs)
            log("slice", f"{path}: one step: exchanges a rank {sorted(exchanges.values())}")
        del got, single, sharded, blocks
        log("time", (
            f"check_grid_xla {path}: build {t0 - t_build:.1f} s, {steps} steps on the three and checks "
            f"{t1 - t0:.1f} s, checked step {time.perf_counter() - t1:.1f} s; device memory reserved "
            f"{torch.cuda.memory_reserved(device) / 2**30:.1f} GiB (peak {torch.cuda.max_memory_reserved(device) / 2**30:.1f})"
        ))
    return counts, errs


def halo_work(kernel: str, solver, nx: int, ny: int) -> tuple:
    """(bytes, float32 operations) of one halo launch on an nx x ny block:
    each plane the kernel reads (state, node and const planes of the form)
    read once, each plane it writes written once, its strips read once."""
    p, metric = solver.params, not solver.mesh.uniform
    strips = {"mevp_stress": 2, "mevp_velocity": 3 + 2 * metric, "ho_stress": 8, "ho_velocity": 9 + 2 * metric}[kernel]
    if kernel == "mevp_stress":  # u, v, 3 stresses; 5 consts (+ metric, a_node, inv_w); 3 stresses, c_w, inv_drag (beta)
        planes = 5 + 5 + 2 * metric + p.a_weighted_stress + (p.adaptive_alpha and metric) + 5 + p.adaptive_alpha
        ops = OPS["stress_both" if p.a_weighted_stress and p.adaptive_alpha else "stress_weighted"
                  if p.a_weighted_stress else "stress_adaptive" if p.adaptive_alpha else "stress"]
    elif kernel == "mevp_velocity":  # u, v, 3 stresses, c_w, inv_drag (beta); 5 consts (+ 3 metric); u, v
        planes = 7 + p.adaptive_alpha + 5 + 3 * metric + 2
        ops = OPS["velocity_metric" if metric else "velocity"]
    elif kernel == "ho_stress":  # 8 velocity + 9 stress planes, strength (+ inv_dx, inv_dy); 9 stresses
        planes, ops = 17 + 1 + 2 * metric + 9, OPS["ho_stress"]
    else:  # 17 planes; 7 consts a CG2 plane (+ a_k) (+ dx, dy); 8 velocity planes
        planes, ops = 17 + 4 * (7 + p.a_weighted_stress) + 2 * metric + 8, OPS["ho_velocity"]
    return 4 * (planes * nx * ny + strips * (nx + ny + 1)), ops * nx * ny


def halo_launches(kernel: str, captured: tuple, stream) -> tuple:
    """(row label, solver, the kernel's in-place launch, its plain version,
    the planes the half reads beyond the block) of a launch that
    check_grid_xla kept (``XLA_TIMED``); the launch holds its inputs."""
    if kernel.startswith("mevp"):
        solver, carry, consts, dt, c_w, inv_drag, beta, strips, metric = captured
        state = torch.stack(list(carry))
        const_ptrs, scalars = cc._mevp_consts(consts), cc._mevp_scalars(solver, dt)
        form = cc.mevp_form(solver.params)
        betas = () if beta is None else (beta,)
        fn = lambda keep=consts: cc._mevp_halo_(kernel, state, const_ptrs, c_w, inv_drag, beta, strips, metric,
                                                form, scalars, stream)
        if kernel == "mevp_stress":
            return (f"{kernel} halo", solver, fn,
                    lambda: cc.mevp_stress_halo_reference(solver, carry, consts, *strips), state[0:2])
        return (f"{kernel} halo", solver, fn,
                lambda: cc.mevp_velocity_halo_reference(solver, carry, consts, c_w, inv_drag, dt, *strips,
                                                        *(metric or (None, None)), *betas), state[2:5])
    solver, before, consts, dt, strips, widths = captured
    state = before.clone()
    const_ptrs, form = cc._ho_consts(consts), cc._ho_halo_form(solver)
    scalars, tables = cc._ho_scalars(solver, dt), cc._ho_tables(solver)
    fn = lambda keep=consts: cc._ho_halo_(kernel, state, const_ptrs, strips, widths, form, scalars, tables, stream)
    if kernel == "ho_stress":
        return kernel, solver, fn, lambda: cc.ho_stress_halo_reference(solver, before, consts, *strips), state[:8]
    return (kernel, solver, fn, lambda: cc.ho_velocity_halo_reference(solver, before, consts, dt, *strips,
                                                                      *(widths or (None, None))), state[8:])


def time_grid_xla(device, card: str, errs: dict) -> None:
    """The halo kernels at config 5's 2048^2 blocks (the CG1 halves' metric
    forms and the HO halves, on the launches check_grid_xla kept): ms per
    launch back to back with their bounds and their plain versions, in
    turns with the copy that a block widened by one ring would take a half
    in place of the strips (the planes the half reads beyond the block,
    padded). (The two 16M cells' steps are checked in check_grid_xla, not
    timed, to keep the run's time.)"""
    stream = cc._stream(device)
    for (kernel, nx), captured in sorted(XLA_TIMED.items()):
        if nx != N16 // 2:
            continue
        label, solver, fn, plain, beyond = halo_launches(kernel, captured, stream)
        ny = beyond.shape[-1]
        work = halo_work(kernel, solver, nx, ny)
        runs = time_in_turns({
            "kernel": fn, "plain": plain, "widen": lambda: torch.nn.functional.pad(beyond, (1, 1, 1, 1)),
        }, {"kernel": 50, "plain": None, "widen": 20})
        mean = {k: sum(v) / len(v) for k, v in runs.items()}
        row = Row(errs[kernel], mean["kernel"], mean["plain"], *work)
        if kernel.startswith("mevp"):
            TVB_FORMS[label] = row
        else:
            XLA_ROWS[kernel] = row
        DEVICE_PROBES[f"{label} {nx}x{ny}"] = fn
        bound_ms, bound_by = bound(*work)
        log("time", (
            f"{label} ({'uniform' if solver.mesh.uniform else 'metric'}"
            f"{', A-weighted' if solver.params.a_weighted_stress else ''}, a {nx}x{ny} block): "
            f"{', '.join(f'{m:.5f}' for m in runs['kernel'])} ms a launch back to back, bound {bound_ms:.5f} ms "
            f"({bound_by}), plain {mean['plain']:.4f} ms; the {beyond.shape[0]} planes it reads beyond the block "
            f"widened by one ring instead (a widened-block design's copy a half): "
            f"{', '.join(f'{m:.5f}' for m in runs['widen'])} ms, on {card}"
        ))
    log("time", f"time_grid_xla: device memory reserved peak {torch.cuda.max_memory_reserved(device) / 2**30:.1f} GiB")


def kernel_summary(kernels: dict, counts: dict, ceilings: dict) -> dict:
    """The kernels' JSON line: per kernel its launches on the main paths,
    check error, times, ``bound_ms`` on the data sheet's peaks and
    ``measured_bound_ms`` on the measured HBM rate and the measured mul_add
    rate (the port's kernels issue unfused float32; the chain's fma form,
    fused, on the fma_imm rate). Each launch counts on one row: a path's
    launches of a kernel go to the last form row (``FORM_ROWS``) that names
    the path for that kernel, else to the kernel's own row."""
    claimed = {}
    for label, (kernel, _, paths) in FORM_ROWS.items():
        claimed.update({(path, kernel): label for path in paths})
    launches = dict.fromkeys(cc.KERNELS, 0)
    for path, names in PATH_KERNELS.items():
        for k in names:
            if (path, k) not in claimed:
                launches[k] += counts[path][k]

    def row_json(k: str) -> dict:
        row = kernels[k]
        bound_ms, bound_by = bound(row.n_bytes, row.n_ops)
        ops_per_s = ceilings["fused_ops_per_s" if row.fused else "ops_per_s"]
        measured = max(row.n_bytes / ceilings["bytes_per_s"], row.n_ops / ops_per_s) * 1e3
        return {
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches[k], "max_abs_err": row.err, "ms": row.ms, "plain_ms": row.plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "measured_bound_ms": measured,
            "library_ms": row.library_ms,
        }

    def form_json(label: str) -> dict:
        kernel, source, paths = FORM_ROWS[label]
        row = TVB_FORMS[label]
        bound_ms, bound_by = bound(row.n_bytes, row.n_ops)
        measured = max(row.n_bytes / ceilings["bytes_per_s"], row.n_ops / ceilings["ops_per_s"]) * 1e3
        return {
            "name": f"{kernel} ({label.split(' ', 1)[1].replace('tvb', 'TVB')} form)", "route": "cuda",
            "source": source,
            "replaces": REPLACES[kernel],
            "launches": sum(counts[p][kernel] for p in paths if claimed[(p, kernel)] == label),
            "max_abs_err": row.err, "ms": row.ms, "plain_ms": row.plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "measured_bound_ms": measured, "library_ms": row.library_ms,
        }

    # No single PyTorch call computes these stencils or the chain, so
    # library_ms is null, except for rdma_stage's strip pack (one torch.stack).
    # The new forms of earlier kernels follow as rows of their own.
    return {"kernels": [row_json(k) for k in cc.KERNELS] + [form_json(label) for label in FORM_ROWS]}


def cluster_report(device, ptxas: str):
    """[build] lines of the cluster kernels at their paths' shapes: the
    shipped launch (and ho_tiled's 2 x 2 clusters), shared bytes,
    registers and spills of the instantiation it runs (ptxas), the
    clusters the card holds at once (cudaOccupancyMaxActiveClusters), the
    blocks of a launch and the SMs it reaches."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    regs = {line.split(":")[0]: line.split(":", 1)[1].strip() for line in ptxas_report(ptxas)}
    n = N4  # the HO 1M path's size
    for config in (htc.launch_config(n, n), htc.CLUSTER_2X2):  # shipped, and the best cluster
        ca, cb = config.clusters(n, n)
        active = htc.max_clusters(device, config)
        blocks = config.grid(n, n)[0] * config.grid(n, n)[1]
        yield (
            f"ho_tiled at {n}x{n}{' (shipped)' if config == htc.launch_config(n, n) else ''}: clusters of "
            f"{config.rows}x{config.cols} blocks of {config.threads} "
            f"threads, {config.sub}^2 sub-windows and their aprons, window {config.window}, interior "
            f"{config.interior}, halo {config.halo} (redundancy {config.redundancy():.3f}), "
            f"{config.shared_bytes()} B shared; ptxas "
            f"{regs.get(f'ho_tiled_kernel<width {config.sub}>', regs.get('ho_tiled_kernel<any width>', '?'))}; "
            f"{active} clusters at once ({active * config.rows * config.cols} blocks); a launch: "
            f"{ca}x{cb} clusters, {blocks} blocks, {ca * cb / active:.2f} waves, reaches "
            f"{min(blocks, active * config.rows * config.cols, sms)} of {sms} SMs"
        )
    h = 16  # config 5's ghost width
    for axis, name in ((0, "along columns, x bands"), (1, "along rows, y bands")):
        band = rdma.launch_config(axis)
        bound = rdma.launch_bound(band.threads)
        along = rdma.band_shape(axis, h, N16 // 2, N16 // 2, h)[1 - axis]
        blocks = 2 * band.cluster * band.clusters(along, h)
        active = rdma.max_clusters(device, axis, h, band)
        yield (
            f"rdma_band {name.split(', ')[1]} of a {N16 // 2}^2 rank block, h = {h}: clusters of "
            f"{band.cluster} blocks of {band.threads} threads, {band.seg} cells along the band each, "
            f"{band.cells_per_thread(h)} cells a thread, {band.shared_bytes(h, axis)} B shared; ptxas "
            f"{regs.get(f'rdma_band_kernel<{name}, {bound} threads>', '?')}; {active} clusters at once; a launch "
            f"(a pair of bands): {blocks} blocks, reaches {min(blocks, active * band.cluster, sms)} "
            f"of {sms} SMs"
        )
    for n, hb, (axis, name) in ((n, hb, a) for n, hb in ((N4 // 2, h), (N16 // 2, h), (N4 // 2, 2 * h), (N4 // 2, 4 * h))
                                for a in ((0, "along columns, x bands"), (1, "along rows, y bands"))):
        along = rdma.band_shape(axis, hb, n, n, hb)[1 - axis]
        band = rdma.launch_config(axis, rdma.HO_PLANES, hb, along)
        clusters = 2 * band.clusters(along, hb)
        active = rdma.max_clusters(device, axis, hb, band, rdma.HO_PLANES, form=3)
        l2 = "" if band.staged else ", L2 consts"
        yield (
            f"rdma_band HO {name.split(', ')[1]} of a {n}^2 rank block, h = {hb}: clusters of {band.along} x "
            f"{band.across} blocks (along x across) of {band.threads} threads, {band.seg} x {band.rows(hb)} cells "
            f"each, {band.cells_per_thread(hb)} cells a thread, consts {'staged' if band.staged else 'from L2'}, "
            f"{band.shared_bytes(hb, axis)} B shared{' (37 consts)' if band.staged else ''}; ptxas closed "
            f"{regs.get(f'rdma_band_ho_kernel<{name}{l2}>', '?')}, metric "
            f"{regs.get(f'rdma_band_ho_kernel<{name}, metric{l2}>', '?')}; {active} metric A-weighted clusters at "
            f"once; a launch (a pair of bands): {band.cluster * clusters} blocks in {clusters} clusters, "
            f"{clusters / max(active, 1):.2f} waves"
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log("device", (
        f"auto thresholds: tiled schedule from {coupled.TILED_MIN_ELEMENTS} elements "
        f"(uniform), mevp_tiled from {coupled.SINGLE_MAX_ELEMENTS} (graded, spherical), "
        f"ho_tiled from {mevp_ho.HO_SINGLE_MAX_ELEMENTS} (HO)"
    ))

    t_start = t0 = time.perf_counter()
    path = cc.build()
    cc._library()
    log("build", f"{path.name} ready in {time.perf_counter() - t0:.2f} s")
    for line in ptxas_report(path.with_suffix(".log").read_text()):
        log("build", line)
    sms = single.sm_count(device)
    for (nx, ny), metric in (((N, N), False), ((N4, N4), True), (RAGGED, True)):
        config = single.tiling(nx, ny, sms)
        log("build", (
            f"mevp_single at {nx}x{ny} ({'metric' if metric else 'uniform'} consts): "
            f"{config.tiles[0]}x{config.tiles[1]} tiles of {config.tile}, {config.threads} threads, "
            f"{config.shared_bytes(metric)} B shared, const planes in shared memory "
            f"{config.resident(metric)} ({len(config.resident(metric, True))} A-weighted); blocks resident "
            f"at once by form: " + ", ".join(
                f"{single.max_blocks(device, config, metric, form)} ({name})"
                for form, name in MOMENTUM_FORM_NAMES.items()
            ) + f"; holds grids up to {single.largest_square(sms)}^2"
        ))
    for size, config in (("large uniform", mt.LARGE), ("other", mt.SMALL)):
        log("build", (
            f"mevp_tiled {size} grids: tile, halo, threads {config}, c_w and inv_drag in registers, "
            f"{mt.cells_per_thread(*config)} cells a thread, {mt.shared_bytes(*config[:2])} B shared; "
            f"resident blocks per SM by form, uniform/metric: " + ", ".join(
                f"{mt.max_blocks(device, *config, form=form)}/{mt.max_blocks(device, *config, metric=True, form=form)} ({name})"
                for form, name in MOMENTUM_FORM_NAMES.items()
            )
        ))
    for line in cluster_report(device, path.with_suffix(".log").read_text()):
        log("build", line)
    sass = start_sass(path)
    try:
        return run_phases(device, smi, sass, t_start)
    finally:
        sass.kill()  # nothing once it has been read
        sass.wait()


def run_phases(device, smi: str, sass: subprocess.Popen, t_start: float) -> int:
    """The phases after the build; the SASS count is read before the timings."""

    def phase(fn, *args):
        """fn(*args), with its wall time logged."""
        t0 = time.perf_counter()
        out = fn(*args)
        log("time", f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s wall")
        return out

    counts_roofline, chain_row, ceilings = phase(check_roofline, device, smi)
    model, _, _ = bench_model(device)
    kernels = phase(check_kernels, model, device)
    kernels.update(phase(check_tiled, device))
    extra = phase(check_single, device)
    kernels["mevp_single"] = extra["mevp_single"]
    cfl_err = phase(check_cfl, device)
    kernels["dg1_sample_cfl"] = replace(kernels["dg1_sample_cfl"], err=max(kernels["dg1_sample_cfl"].err, cfl_err))
    extra_ho = phase(check_ho, device)
    kernels["ho_single"], kernels["ho_tiled"] = extra_ho["ho_single"], extra_ho["ho_tiled"]
    extra["transport_metric"] = max(extra["transport_metric"], extra_ho["transport_qv"])
    # The metric checks of the kernels with a uniform-mesh timing above.
    for kernel, key in (
        ("transport_tiled", "transport_metric"), ("dg1_rk_stage", "dg1_rk_stage_metric"),
    ):
        kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, extra[key]))
    counts = phase(check_slice, device)
    counts_dg, errs_dg = phase(check_degrees, device, smi)
    counts.update(counts_dg)
    for kernel, err in errs_dg.items():
        kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, err))
    counts_forms, errs_forms = phase(check_momentum_forms, device)
    counts.update(counts_forms)
    for kernel, err in errs_forms.items():
        kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, err))
    counts_tvb, errs_tvb = phase(check_tvb_periodic, device)
    counts.update(counts_tvb)
    for kernel, err in errs_tvb.items():
        if kernel != "dg1_limit":
            kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, err))
    counts_hof, errs_hof = phase(check_ho_forms, device)
    counts.update(counts_hof)
    counts_hom, errs_hom = phase(check_ho_metric, device)
    counts.update(counts_hom)
    for errs in (errs_hof, errs_hom):
        for kernel, err in errs.items():
            if kernel != "dg1_limit":
                kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, err))
    counts_5, kernels_5, probes = phase(check_multihost, device)
    counts_grid, errs_grid = phase(check_grid_forms, device)
    counts.update(counts_grid)
    counts_grid_ho, err_grid_ho = phase(check_grid_ho, device)
    counts.update(counts_grid_ho)
    counts_grid_ho_rdma, _ = phase(check_grid_ho_rdma, device)
    counts.update(counts_grid_ho_rdma)
    counts_grid_tvb, _ = phase(check_grid_tvb, device)
    counts.update(counts_grid_tvb)
    counts_grid_xla, errs_xla = phase(check_grid_xla, device)
    counts.update(counts_grid_xla)
    kernels["ho_tiled"] = replace(kernels["ho_tiled"], err=max(kernels["ho_tiled"].err, err_grid_ho))
    phase(check_engine, device, smi)
    counts.update(phase(check_cli, device, smi))
    counts.update(phase(check_forcing_files, device, smi))
    counts.update(counts_5, roofline=counts_roofline)
    kernels.update(kernels_5, chain=chain_row)
    for kernel, err in errs_grid.items():
        kernels[kernel] = replace(kernels[kernel], err=max(kernels[kernel].err, err))
    log("build", sass_report(sass))
    kernels["fused_dynamics"] = phase(check_fused, device, smi)
    counts_fused, err_fused = phase(check_fused_forms, device, smi)
    counts.update(counts_fused)
    kernels["fused_dynamics"] = replace(kernels["fused_dynamics"], err=max(kernels["fused_dynamics"].err, err_fused))
    phase(time_paths, device, smi)
    phase(time_momentum_forms, device, smi)
    phase(time_ho, device, smi)
    phase(time_multihost, device, smi)
    counts.update(phase(check_multiprocess, device, smi))
    phase(time_grid_forms, device, smi)
    phase(time_grid_ho, device, smi)
    phase(time_grid_ho_rdma, device, smi)
    phase(time_grid_tvb, device, smi)
    phase(time_grid_xla, device, smi, errs_xla)
    kernels.update(XLA_ROWS)
    phase(time_tvb_periodic, device, smi)
    phase(time_ho_forms, device, smi)
    phase(time_ho_metric, device, smi)
    kernels["dg1_limit"] = replace(TVB_FORMS["dg1_limit"], err=max(
        TVB_FORMS["dg1_limit"].err, errs_hof["dg1_limit"], errs_hom["dg1_limit"]))
    phase(profile_engine, device)
    # Last, as a profiler session slows the host's later launches. Every
    # row's ms stays the back-to-back time per call; the device durations
    # are logged beside it, with the CUDA events' time of the whole call,
    # which is all there is where the profiler records nothing. One session
    # for all the probes (a session a probe took ~0.8 s each).
    all_probes = {**DEVICE_PROBES, **probes}
    measured = {probe: (launches_per_call(fn, probe.split()[0]), best_ms(fn, reps=3)) for probe, fn in all_probes.items()}
    durations = profiled_ms_many({probe: (fn, probe.split()[0]) for probe, fn in all_probes.items()}, n=10)
    for probe, fn in all_probes.items():
        kernel = probe.split()[0]
        per_call = measured[probe][0]
        events = f"CUDA events {measured[probe][1]:.5f} ms per call of {per_call} launches"
        ms = durations[probe]
        if ms is None:
            log("time", f"{probe}: the profiler recorded no {kernel} kernel in its window; {events}")
            continue
        calls = f", {ms * per_call:.5f} ms per call of {per_call} launches" if per_call > 1 else ""
        log("time", f"{probe} device duration {ms:.5f} ms{calls} (torch.profiler); {events}")
        if probe == "rdma_band axis 0":
            log("time", f"rdma_band: back to back {kernels['rdma_band'].ms:.5f} ms per call, device {ms:.5f} ms")

    forms = {
        **{f"dg1_rk_stage {label}": row for label, row in STAGE_FORMS.items()}, **DEGREE_FORMS,
        **MOMENTUM_FORMS, **TVB_FORMS,
    }
    for label, row in forms.items():
        measured = max(row.n_bytes / ceilings["bytes_per_s"], row.n_ops / ceilings["ops_per_s"]) * 1e3
        log("time", (
            f"{label}: kernel {row.ms:.5f} ms back to back, plain {row.plain_ms:.4f} ms, bound "
            f"{bound(row.n_bytes, row.n_ops)[0]:.5f} ms ({bound(row.n_bytes, row.n_ops)[1]}), measured bound "
            f"{measured:.5f} ms"
        ))
    summary = kernel_summary(kernels, counts, ceilings)
    log("time", f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-archive-box"]:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
            sys.exit(1)
        cc.build()
        sys.exit(trace_archive_box(Path(sys.argv[2]), torch.device("cuda", 0)))
    sys.exit(main())
