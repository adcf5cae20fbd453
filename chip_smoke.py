#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ray_rust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the builds of the CUDA kernels from ray_rust_tpu_torch/csrc, all at once
   (meanwhile the card renders the plain images of phase 3's four small
   march cases, which need no kernel):
   the trace kernel (K1), the march kernel (K3), the trace backward (K2),
   the march backward (K4), each also in its global-table build (``_global``,
   for scenes too large for shared memory), the re-trace gradient oracle
   (K5) and the scene pack with its pull-back (one library, two kernels);
   ptxas registers, stack and spills (K1 with and without its cull, K1b, at
   task stacks of 16 and 64; the trace backward built for three record
   caps, one kernel each, and the 64-task stack at two; the march backward
   in two instances, untextured and textured; KERNEL_COUNTS), and the trace
   backward's TraceBody instances and the march backward's untextured
   instance must keep theirs (PINNED_PTXAS); each kernel must be one
   function (ptxas reports no device function beside the kernel:
   everything is inlined, the texture fetch too);
3. each kernel against its plain PyTorch version on the card, and against
   its full-depth golden image, each within the JAX package's golden budget:
   at most 2% of pixels off by more than 1e-3, mean difference at most 0.01;
   also at the shape of its main path. There (the march kernels at
   1280x720, the trace backward and the re-trace oracle at 1920x1080, and
   the textured twins of each) the kernel launches on the whole frame and
   the plain version renders ``check_rows`` alone in one call (every 8th
   row, the horizon's rows and the glass sphere's edges: 99 of 720 rows,
   144 of 1080): the forward kernels' whole frame is first held bit for bit
   against their own launches on ``partition()``'s 4 bands of rows, and
   the backwards' whole-frame block against the sum of their blocks on
   those bands (REGIME_REL_L2), their images bit for bit, before the
   kernel's frame, or its block for cotangent planes zero off the checked
   rows, is held against the plain version on those rows; a march
   gradient's agreement mask comes from the plain call whose autograd it
   masks (the plain forward renders once). The march's plain calls at
   1280x720 (untextured and in both filters, image and autograd; phase
   10's two images) run in two child processes of this script on the card,
   started once the build is done, while phases 3 and 4 run (a plain march
   takes tens of seconds on its host thread at any pixel count); phase 4b
   waits for them before it times anything. The trace kernel with image
   textures (K1a: the default scene with the goldens' 256x256 noise texture as
   ``bar.png``) against its plain version at 1920x1080 in Nearest and in
   Bilinear, and against the two textured goldens (mean at most 0.015,
   tests/test_parity.py:192-214); the pack kernel against
   ``kernel_trace.pack_scene`` (and the meta rows of ``pack_textures``) bit
   for bit, and the pull-back kernel against autograd of ``pack_scene`` on
   a seeded block, bit for bit but within relative L2 1e-6 on the materials
   two objects share (summation order), on the default scene, the Bilinear
   textured one and 101 objects; the trace backward against torch
   autograd of the plain trace, per scene leaf within relative L2 0.01 (the
   JAX package's budget, tests/test_pallas_bwd.py:84-96), at six small
   cases (among them a 70-sphere field, where the lanes of a warp hit
   different objects, and 4 reflections at refraction_unroll=None, 63 sites
   a pixel at most) and at the training main path's shape, and with textures (K2's
   textured sites) at two small cases and at 1920x1080 in Bilinear, its
   image bit-equal to the trace kernel's; the march backward against
   torch autograd of the plain march (its implicit VJP), per scene leaf
   within relative L2 0.02 (tests/test_pallas_bwd.py:306-321) on the pixels
   where its image agrees with the plain version's within 1e-4 (each other
   pixel on a decision boundary, tests/test_pallas_bwd.py:29-72), at four
   small cases and at the march training path's shape, its image the march
   kernel's bit for bit; the march kernel with the floor tail off
   (``march_floor_skip=False``) bit-equal to its plain version at 1280x720,
   and with it on against it off at 1280x720 and on the JAX package's two
   floor-tail scenes (tests/test_pallas.py:264-322), knife-edge pixels only
   (at most 0.5% of pixels off by more than 1e-3, each on a decision
   boundary: tests/test_pallas.py:238-261); the textured march kernel (K3
   reading the atlas) on the default scene with ``bar.png`` at 1280x720 in
   Nearest and in Bilinear: with the floor tail off bit-equal to the plain
   textured march, with it on within the golden budget of it (a shaded
   march takes no tail toward a textured floor), and on against off
   knife-edge-only at 320x240; the textured march backward (K4's textured
   instance) against torch autograd of the plain textured march under the
   march contract above at 160x120 (a 2000-step budget) and at the march
   training path's shape, in Nearest and in Bilinear, its image the march
   kernel's; the re-trace gradient oracle against torch autograd of the
   plain trace, per scene leaf within relative L2 0.01, at 320x240 (its
   image bit-equal to the trace kernel's) and, beside the trace backward
   against the same plain call, at the gradient oracle's main path's shape
   and cotangent planes;
4. the main paths, each with the launch counts set to 0 just before it and
   read just after: trace mode, the CLI at 1920x1080 then ``render_u8`` at
   three camera poses (three viewer requests), one trace kernel launch and
   one pack launch per render; march mode with glow, the CLI at 1280x720
   ``-m -g 1.0`` then three ``render_u8`` requests, one march kernel launch
   and one pack launch per render;
   textured trace, the CLI at 1920x1080 in a directory holding ``bar.png``
   (its floor must differ from the untextured one) then a Bilinear
   ``render_u8``, one trace kernel launch each; textured march
   (configuration 3 of BASELINE.md), the CLI at 1280x720 ``-m -g 1.0`` where
   ``bar.png`` lies (its PNG ``render_u8`` of the textured scene, its floor
   not the untextured one's) then a Bilinear ``render_u8``, one march
   kernel and one pack launch each; training, five
   ``sgd_train_step``s at 1920x1080 on the default scene against a target
   whose red material is 0.1 redder, one trace, one backward, one pack and
   one pull-back kernel launch per step, the loss falling; the same on the Bilinear textured
   scene, the loss falling at every step; march training with glow, five
   ``sgd_train_step``s at 1280x720 ``-m -g 1.0`` against the same
   kind of target, one march and one march backward launch per step, the
   loss falling at every step; the same on the Bilinear textured scene (K4's
   textured instance), the loss falling at every step, and K4's image at
   1280x720 the march kernel's bit for bit; the gradient oracle,
   ``render_grads_retrace``
   at 1920x1080 on the default scene with cotangent planes from numpy seed
   0, one re-trace launch, its cotangent against the trace
   backward's per scene leaf within relative L2 0.01 (the JAX oracle test's
   budget, tests/test_pallas_bwd.py:250-260) and its image bit-equal to the
   trace kernel's on every pixel; scene files (configuration 4 of
   BASELINE.md): ``serialize_scene`` writes the 101-object scene, which
   loads back to the same leaves, then the CLI's ``-d`` on it in trace mode
   at 1920x1080 and in march + glow at 1280x720 (one kernel and one pack
   launch each, the PNG ``render_u8`` of the file's scene under its caps),
   ``-s`` on the loaded scene (its file loads back to the same leaves bit for
   bit), and the file with two camera keyframes at 320x240 (the JAX
   package's frame count, one frame file and one trace launch a frame), the
   trace request's one K1 launch taking K1b's cull;
4b. many objects: K1 with its cull (K1b) against K1 with
   ``pallas_prefilter`` off, bit for bit, and timed in turns (on, off, off,
   on; 3 warm-ups, 10 frames), at 1920x1080 on configuration 4's 101 objects
   and on 1 024 (past 512), with the mean primary and shadow candidate
   lists from K1's counting build; K1 with the cull against the plain trace
   at 1920x1080 on the 101 objects (its ``plain_ms``) and at 320x240 on the
   1 024; on the 1 024 with glow K3 against the plain march at 160x120 (a
   2000-step budget); K2 and K4 against autograd of the plain versions at
   160x120 within relative L2 0.01 and 0.02 per scene leaf in the build
   their wrappers launch (global tables), and their shared-table builds,
   whose int64 block no longer fits 1 024 objects in a block, at 80x60 on
   SHARED_BWD_FIT objects; each of K1-K4 in its two table regimes (the
   shared-table build and the ``_global`` one) on the same packed words,
   the images bit for bit and the backwards' cotangent blocks within
   relative L2 REGIME_REL_L2, and timed in turns, at its threshold
   (``SHARED_TABLE_MAX`` objects, where both fit its launch shape; K3's 1
   200 is past the 1 024) and at 1 024 objects (the backwards at
   SHARED_BWD_FIT, and at 1 024 their global-table builds alone) at the
   main paths' shapes (K1 and K2 1920x1080, K3 and K4 1280x720); a
   1 024-object scene file through ``-d`` at 1920x1080
   (one K1 launch with the cull); K1 at ``max_reflections=8`` (its 64-task
   stack) against the plain trace at 320x240, and timed at 1920x1080;
5. times with CUDA events: the trace forward at 1920x1080, kernel and plain
   version in turns (3 warm-ups, 10 timed renders each), then the kernel
   through its wrapper and alone on words packed once in turns, beside the
   share of 67 TFLOP/s it reaches with its object tests and with the
   shading and sky operations its counting build counts (a diagnostic);
   the packing by events and by the host's clock (100 calls enqueued): the
   pack kernel untextured and textured, the pull-back kernel and their
   plain versions; the forward and backward step at 1920x1080 through the
   kernels twice by events, then by the host's clock (20 steps enqueued)
   and the card's busy time and idle share from a ``torch.profiler``
   trace, just after ``utils/profiling.device_trace`` around one 1920x1080
   frame, the process's first profiler session, with K1 and the pack
   kernel in its trace; its plain twin phase 3's plain autograd of the same render (one
   call, ~32 s at 1080p); the backward kernel through its wrapper and alone
   (on words packed once) in turns, beside the host counts of its
   accumulator's adds, their distinct (warp, entry) pairs and the sites
   (3 warm-ups, 10 timed calls each), its plain version phase 3's call;
   the march forward and backward step at 1280x720 through the march
   kernels (3 warm-ups, 10 timed calls), its plain twin phase 3's plain
   autograd at 1280x720, the march backward alone (3 warm-ups, 10 timed
   calls), its plain version that same call; the march kernel at
   1280x720, 1920x1080 and 320x240 (3 warm-ups, 10 timed renders each), the
   plain march once at 1280x720 (the comparison of phase 3: a plain frame
   takes tens of seconds at any size); the textured trace
   kernel at 1920x1080 in both filters, the textured training step and the
   backward kernel through its wrapper and alone on the Bilinear scene (3
   warm-ups, 10 timed calls;
   their plain versions once, in phase 3); the textured march kernel and
   the textured march backward at 1280x720 in Nearest and in Bilinear
   beside the untextured ones in turns, and the textured march step
   (Bilinear) (3 warm-ups, 10 timed calls; their plain versions once, in
   phase 3), and the scene-file requests' wall times; the re-trace oracle
   through its
   wrapper and alone on words packed once, and the trace backward, at
   1920x1080 in turns (3 warm-ups, 10 timed calls each; their plain version
   is the trace backward's, timed above), beside the oracle's host counts:
   its Dual passes (their mean, their most, and the mean over rows of 32
   pixels of the longest) and the pixels by their distinct winners; each
   kernel's roofline bound from the operation count of its main path's
   frame, which the kernel's body built for the host with -DRT_COUNT_OPS
   counts on the CPU while phases 3 and 4 run (the same body, bit for bit,
   as the card runs); the re-trace oracle's bound is the trace backward's,
   since it computes the same function on the same inputs (its value
   pass's and forward-mode operations, counted the same way, are printed
   beside it as a diagnostic); the floor tail on and off in turns (on, off,
   off, on) at 1280x720: the march kernel, the march backward and the march
   training step (3 warm-ups, 10 calls each), beside the longest pixel's
   operations and object passes from the counting builds, on and off (the
   march bounds are the tail's counts; the step-by-step ones are printed as
   a diagnostic); K1b's bound from the counting build with the cull on the
   101 objects (and on 1 024, printed); each phase's wall time;
6. the host apps, each path with the launch counts set to 0 just before
   it and read just after: the web viewer (``webserver.make_server`` on
   port 0 on a thread) in trace mode at 1920x1080 (the page, a 404
   ``empty``, three ``/render`` requests at three poses, each PNG decoded
   bit-equal to ``render_u8`` of its pose rebuilt directly, one K1 launch
   a request; each request's wall time split into render + copy and
   encode) and in march + glow at 1280x720 (one request, one K3 launch);
   the inverse-rendering example (``examples/inverse_rendering.main``) at
   320x240 for 200 steps: finite losses, ``|dx_red|`` falling, one K1 and
   one K2 launch a step, its exit code its criterion on the last loss; the
   example's Adam step at 1920x1080 by events and by the host's clock; its
   first 3 steps at 160x120 through K1 and K2 against the same steps of
   the plain version on the CPU, each from the plain run's state (moved
   to the card by ``checkpoint``), the trained leaves within
   ``STEP_ATOL`` (``tests/test_torch_inverse.py``'s rule); checkpoint and
   resume (10 steps, a save, 10 more against a state restored from the
   save): on the CPU at 160x120, in a process started with the phase, the
   10 resumed losses within ``RESUME_RTOL`` of the uninterrupted run's; on
   the card at 320x240 the restored state bit-equal to the saved one
   (Adam's moments and step included), and the resumed run and two twins
   (copies of the saved state in memory) the uninterrupted run bit for bit
   over ``RESUME_STEPS`` steps, losses and leaves, under
   ``torch.use_deterministic_algorithms(True)``; the scan-mode
   march (``differentiable=True``, 256 steps) against K4's implicit VJP at
   160x120 (sphere 3's ``org.y``, rtol 5e-3), K3 and K4 launching for the
   implicit gradient only; ``RenderTimer``'s Mrays/s and
   ``count_traced_rays``;
   a 1920x1080 frame encoded by the native and the stdlib PNG encoders,
   each decoding to the frame bit for bit, both timed (or why the native
   library does not build).

7. the multi-device layer (``parallel/shard.py``, ``parallel/multihost.py``),
   with the launch counts set to 0 just before its main path and read just
   after: ``render_sharded`` on a 2x2 mesh of cuda:0 (each cell a window of
   the frame at its global origin, K1 or K3 launched on it) for trace at
   1920x1080 (untextured, ``bar.png`` in Nearest, configuration 4's 101
   objects with K1b's cull) and march + glow at 1280x720, on a 3x1 mesh
   (1080 / 3 = 360 rows: a window's edge cuts 16x16 blocks) for trace and
   march, and ``render_tiled_u8`` at 3840x2160 in 8 bands of 270 rows:
   each stitched frame bit-equal to the whole-frame launch, the 4K frame to
   ``to_u8`` of one whole-frame launch; the windows against their windowed
   plain versions within the golden budget (trace at 320x240 and at the
   2x2 mesh's 1080p cell, the march at a ragged 320x240 window and at the
   720p cell, whose plain images phase 2 renders under the build), the
   windowed plain march the whole plain frame's crop bit for bit; times by
   events of the whole frame, both meshes and the cell alone, and of 4K
   whole and banded (the banded also by the host's clock); two processes
   on the card joining a gloo group (``init_distributed(backend="gloo")``)
   and gathering a 1920x1080 frame with ``render_multihost`` (one K1
   launch each), both bit-equal to the single-process frame, importing no
   JAX, their wall time;
8. the multi-device layer's gradient half (``parallel/train.py``; K2 and K4
   with a window): K2 on the 2x2 mesh's 1080p cell (untextured and with
   ``bar.png`` in Nearest) and K4 on its 720p cell (the same two scenes)
   against the whole-frame launch with the cotangent zero outside the cell,
   the blocks within relative L2 REGIME_REL_L2 (each launch's fixed-point
   scale), the primal K1's
   (K3's) window bit for bit; both on the ragged window of 320x240 and on
   those cells against torch autograd of the windowed plain version (phase
   2 renders it under the build and keeps its graph), per scene leaf within
   GRAD_BUDGET and, under the march contract, MARCH_GRAD_BUDGET; the main
   path, with the
   launch counts set to 0 just before it and read just after:
   ``sgd_train_step(..., mesh=)`` on the material colours at 1920x1080 on
   the 2x2 and 3x1 meshes of cuda:0, at 1280x720 in march + glow and at
   3840x2160 (BASELINE.md configuration 5) on the 2x2 mesh, and the
   example's Adam step (``make_train_step(cfg, SceneAdam, mesh=)``) at
   1920x1080 on the 2x2 mesh, each against its whole-frame step: the loss
   within 1e-6 relative, the colours' step within REGIME_REL_L2, Adam's
   trained leaves within ``STEP_ATOL`` (lr for a noise entry) and its frozen
   ones bit for bit; each 2x2 SGD step again from the same state, its loss
   and colours bit for bit; times by events (3 warm-ups, 10 steps) of the
   whole-frame and 2x2 steps at the three shapes and of K2 and K4 on the
   cells, with the image and without it; two ranks over gloo and one over NCCL (a group of one) on the
   card, started together, each taking the 1080p step over
   ``multihost.global_mesh()`` (one K1 and one K2 launch) against the
   single-process step, importing no JAX, their host-clock times and wall
   time; ``measure_scaling(devices=[cuda:0])``'s report (the one-card row),
   ``dryrun.run(4)`` on cuda:0 cells, ``entry()``'s 96x128 frame, and the
   CLI at 320x240 with ``--no-pallas``: no launch, its PNG the plain
   ``render_u8``'s bit for bit;
9. deep ray trees (``kernel_trace.stack_tasks``: the task stack K1, K2 and
   K5 run; K2's buffer instance past 192 sites, K4's past 35 laps), with
   the launch counts set to 0 just before its main path and read just
   after: the CLI's ``-d`` on a scene file with ``max_reflections: 12`` at
   1920x1080 (one K1 launch, its PNG ``render_u8`` of the file's scene),
   ``sgd_train_step`` on the material colours at 1920x1080 at 12
   reflections (K1, K2 at record cap 192) and at 7 reflections with
   ``refraction_unroll=None`` (319 sites: K2's buffer instance, one launch
   a band of rows) and at 1280x720 in march + glow at
   ``raymarch_max_reflections=7`` (39 laps: K4's buffer instance); then
   K1 at 12 and 16 reflections and its 64-task instance (17 tasks, on an
   opaque scene, against the plain trace at refraction cap 0) at 320x240
   within the golden budget, K5 and K2 at 8 reflections (320x240), K2 at
   319 sites and K4 at 39 laps (160x120; the step-by-step march at 2 000
   steps) and the 64-task instances of K2 and K5 (64x48) against plain
   autograd per scene leaf (GRAD_BUDGET,
   MARCH_GRAD_BUDGET), their images the forward kernels' bit for bit (the
   plain references rendered in phase 2 under the build); each buffer
   instance forced on the default config at the main paths' shapes
   against its local-record instance (blocks within REGIME_REL_L2, images
   bit for bit), timed in turns; K1 at 12 reflections at 1920x1080 against
   the plain trace and timed, K2 at 319 sites at 1920x1080 and K4 at 39
   laps at 1280x720 timed, and their bounds; past 2^32 fixed-point terms
   (``past_terms``): K2 on the box at TERMS_BOX runs twice, the second run
   with a lo digit narrower than 31 bits (``rt_fixed_stats``:
   csrc/fixed_sum.cuh), bit-equal on a second launch and within
   TERMS_REL_L2 per scene leaf of the float64 sum of its blocks on windows
   of rows each under 2^32 terms, and K2 and K5 at 1920x1080 and K4 at
   1280x720 on the default scene run once at the 31-bit digit;
10. deep marches and large banks (``deep_marches``): with the launch
   counts set to 0 just before each main path and read just after, the
   CLI's ``-m -g 1.0 --max_refractions 12 --refraction_unroll 12`` at
   1280x720 and one march ``sgd_train_step`` at refraction cap 12 (K3's
   deep instance ``march_fwd_deep`` twice, K4's buffer instance on the
   deep march once), then a bank of BANK_TEXTURES textures (the floor's the
   last): ``render_u8`` at 1920x1080 and at 1280x720 march + glow and one
   ``sgd_train_step`` at each (K1-K4 in their global-table builds, which
   read the meta rows from global memory); K3's deep instance forced at
   refraction caps 4 and 10 bit-equal to ``march_fwd`` at 1280x720, at
   cap 12 by phase 3's method (tail off bit for bit, on within the golden
   budget and knife-edge-only against off), and on phase 9's box of
   transparent planes at 160x120 bit-equal to the plain march; K4's buffer
   instance at cap 12 against plain autograd at 160x120 (2 000 steps, tail
   off; MARCH_GRAD_BUDGET on the agreeing pixels) in 1 and DEEP_BANDS
   bands on the default scene and on the box, whose records show a pixel
   nesting more than 10 raymarch calls (a one-band launch into a buffer
   filled with RECORD_FILL, ``kernel_march_bwd.nesting``); the bank's K1
   and K3 by phase 3's method and K2 and K4 against plain autograd at
   160x120; times by events of K3's deep instance forced at cap 4 beside
   ``march_fwd`` in turns, of K3 and K4 at cap 12 and of the bank's four
   kernels at the main paths' shapes, with their bounds;
11. an atlas of 2^31 texels or more (``huge_atlas``): HUGE_BANK textures
   of seeded noise made on the card (2 049 of 1 024 x 1 024: a 24 GiB bank,
   a 32 GiB atlas), the floor reading the last (base texel 2^31) in
   Bilinear; K1 at 1920x1080, K3 at 320x240 (2 000 steps, tail off) and K2
   and K4 on HUGE_WINDOWS each bit-equal to themselves on a twin bank of
   the two textures read (the same texels under 2^31); K1 and K3 bit-equal
   to their plain versions on ``check_rows``, K2 and K4 within GRAD_BUDGET
   and MARCH_GRAD_BUDGET of plain autograd on their windows; with the launch
   counts set to 0 just before and read just after, a frame of each mode
   and a gradient of each window by autograd; times by events and bounds
   (the twin's host counts); the bank freed before the end.

Through every phase, each backward instance (library, launcher, record
cap, task stack, textured or not) is launched a second time on the same
inputs at its first launch and held bit-equal (``repeat_backwards``: the
blocks sum in fixed point, csrc/fixed_sum.cuh), a line each and a summary
before the phase times; phase 6's resume and phase 8's 2x2 steps repeat
themselves bit for bit under ``torch.use_deterministic_algorithms(True)``.

The last two lines are JSON: the kernel table, then
``{"ok": true, "device": {...}}``. Each kernel's ``ms`` is its time through
its public wrapper (for K1, K2 and K5 packing included); the trace
backward's two entries and the re-trace oracle's also give ``alone_ms``,
the kernel alone on the pack kernel's words packed once (``launch_words``).
The pack kernel's and the
pull-back's entries are timed on the default scene, their launches counted
in the five trace training steps. ``trace_fwd_cull`` (K1b) is K1 with its
cull on configuration 4's 101 objects at 1920x1080 (``off_ms``: with
``pallas_prefilter`` off), its launches those of the ``-d`` trace request
that took the cull, its ``max_abs_err`` against K1 without the cull.
``trace_fwd_window`` and ``march_fwd_window`` are K1 and K3 on phase 7's
main path: its launches, the windows' largest error against the windowed
plain versions, the 2x2 mesh's last cell alone by events (``ms``), the
windowed plain version of that cell (``plain_ms``) and its bound.
``trace_bwd_window`` and ``march_bwd_window`` are K2 and K4 on phase 8's
main path: its launches, the largest relative L2 of the windows' cotangents
(a cell's block against the whole frame's, the ragged window's leaves
and the cells' leaves against plain autograd), the 2x2 mesh's last cell
through the wrapper by events with the image (``ms``, the plain version's
function) and without it (``main_ms``, the main path's call), the bound of
the work ``ms`` times, and the plain version's forward and backward of that
cell (``plain_ms``). ``trace_fwd_deep``, ``trace_bwd_buf`` and
``march_bwd_buf`` are phase 9's: K1 at 12 reflections, K2's and K4's
buffer instances at 319 sites and 39 laps, their launches in phase 9's main
path, their largest error against the plain versions (K1's image, the
backwards' largest leaf relative L2), their times by events at the main
paths' shapes with the image, the plain version's ms at ``plain_shape``
(the backwards' plain autograd at 160x120, phase 2) and, for the buffer
instances, ``forced_ms``: the local-record instance and the buffer
instance forced on the default config, in turns (local, buffer, buffer,
local). Where ``plain_rows`` is given, the plain version ran on that many
rows of the frame (phase 3's ``check_rows``; for phase 10's gradients the
160x120 frame's rows). Phase 10's entries, named for the configuration
they ran (``build``: the library): ``march_fwd_deep`` (K3's deep instance
at refraction cap 12 at 1280x720; ``forced_cap4_ms``: it and
``march_fwd`` in turns at cap 4, alone on packed words), the buffer
instance at cap 12 (1280x720 with the image), and each of K1-K4 in its
global-table build on the bank of BANK_TEXTURES textures at the main paths'
shapes; their launches in phase 10's main paths. Phase 11's entries
(``... (2^31 texels)``): K1-K4 in their global-table builds on that bank,
their launches in phase 11's main path, their largest error against the
plain versions (K1's and K3's images, the backwards' largest leaf
relative L2 on their windows), K1 and K3 at the main paths' shapes and K2
and K4 on their windows by events.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# cuBLAS's deterministic workspace, read when cuBLAS starts: the phases that
# run under torch.use_deterministic_algorithms(True) would raise without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HERE = os.path.dirname(os.path.abspath(__file__))
BUDGET = dict(frac=0.02, mean=0.01, tol=1e-3)  # tests/test_parity.py:152-161
W, H = 1920, 1080  # the trace and training main paths
MW, MH = 1280, 720  # the march main path and the march training path
GRAD_BUDGET = 0.01  # per scene leaf, relative L2 (tests/test_pallas_bwd.py:84-96)
MARCH_GRAD_BUDGET = 0.02  # the march's (tests/test_pallas_bwd.py:306-321)
# The training main path's learning rate on the material colours; at 30 the
# five steps bring the red back from 0.8 to ~0.9 (tests/test_torch_grad.py).
TRAIN_LR = 30.0
# March mode with glow renders about twice as bright; at 10 the five steps
# bring the red from 0.8 to ~0.9 with the loss falling at every step (the
# plain path at 64x36 on the CPU).
MARCH_TRAIN_LR = 10.0
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM rate
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# The floor tail's contract against the step-by-step march
# (tests/test_pallas.py:238-261): pixels off by more than 1e-3 at most 0.5%,
# each with a local contrast above 0.05 in the step-by-step image.
KNIFE_EDGE = dict(frac=0.005, tol=1e-3, contrast=0.05)
# ptxas figures the trace backward (one kernel a record cap: 16, 64, 192)
# and the march backward keep while the re-trace oracle, which shares their
# frame (csrc/bwd_kernel.cuh) and the trace body, changes, and while K1's
# cull (K1b), the deep task stack and the global-table builds are added
# beside them: registers, stack frame, spill stores and spill loads in
# bytes, by kernel (PERF.md §6; the trace backward's 125 registers, from
# 119, are its fixed-point sums' digits, csrc/fixed_sum.cuh)
PINNED_PTXAS = {"trace_bwd": [(128, 2512, 0, 0), (128, 7504, 0, 0), (128, 20816, 0, 0)],
                "march_bwd": [(128, 8168, 4188, 5512)]}
# The kernels of a library whose figures are pinned, by a part of their
# mangled names: the trace backward's TraceBody<CAP> (its DeepTraceBody<CAP>
# instances, with the 64-task stack, are reported beside them), the march
# backward's untextured instance (MarchBody<false>; its textured one,
# MarchBody<true>, is reported beside it)
PINNED_KERNELS = {"trace_bwd": "9TraceBodyI", "march_bwd": "MarchBodyILb0E"}
# The kernels each library holds, its global-table build the same: K1 with
# and without K1b's cull at task stacks of 16 and 64, K2 at its three record
# caps and, for 64 and 192, with the deep stack, and its buffer instance at
# both stacks, K4 untextured and textured, K4's buffer instance and K3's
# deep instance (libraries of their own), K5 at both stacks; beside each
# backward's, its launch's two fixed-point kernels (csrc/bwd_kernel.cuh: the
# cotangent planes' largest |g|, the int64 block added to the output as
# floats)
KERNEL_COUNTS = {"trace_fwd": 4, "trace_fwd_global": 4, "march_fwd": 1, "march_fwd_global": 1,
                 "trace_bwd": 9, "trace_bwd_global": 9, "march_bwd": 4, "march_bwd_global": 4,
                 "march_bwd_buf": 3, "march_fwd_deep": 1, "trace_retrace": 4,
                 "pack_scene": 2}
# The largest relative L2 between a backward's cotangent blocks from two
# launches of the same terms (its two table regimes, a frame and its
# windows or bands): each launch rounds each term to its own fixed-point
# grid (csrc/fixed_sum.cuh; the regimes' grids are the same, so their blocks
# are too), twenty times the 2.7e-6 to 4.2e-6 the float atomics gave on 640
# and 1 024 objects (PERF.md §6)
REGIME_REL_L2 = 1e-4
# The most objects whose tables and int64 (n+1, 20) block the backwards'
# shared-table builds hold in one block's 227 KB of shared memory (412
# bytes an object: csrc/bwd_kernel.cuh, bwd_smem), less a margin: where
# phase 4b holds them against autograd and against the global-table builds
SHARED_BWD_FIT = 544
# The many-object scenes: BASELINE.md configuration 4's 101 objects and
# 1 024 (past 512); their plain references run at the smallest shapes the
# checks need (the plain trace loops over the objects in Python)
MANY_SMALL = (320, 240)  # K1 against the plain trace on 1 024 objects
MANY_GRAD = (160, 120)  # K3, K2 and K4 against the plain versions on 1 024 objects
# The host memory a counting build's record buffer may take (the buffer
# instances' host twins, band by band)
HOST_RECORD_BUDGET = 2**30
# frames per keyframe = duration / FRAME_STEP (ray_rust_tpu/animation.py:22)
FRAME_STEP = 0.5
# Phase 3's checks at the main paths' shapes hold the kernel's launch on
# the whole frame against its plain version on CHECK_ROWS rows (check_rows:
# every CHECK_STEP-th row, the horizon and the glass sphere's edges), one
# plain call; the whole frame is held against the kernel's own launches on
# PARTITION bands of rows (kernel against kernel, cheap)
CHECK_STEP = 8
PARTITION = 4


def check_rows(h):
    """The rows of an h-row frame of the default camera on which phase 3
    and phase 10 hold a main-path launch against its plain version: every
    CHECK_STEP-th row from CHECK_STEP // 2, the horizon's two rows (h/2 - 1
    and h/2, where grazing rays crawl and the floor tail's knife edges
    lie) and the glass sphere's top and bottom edges (0.4 h and 0.807 h at
    1280x720 and 1920x1080), each with the rows either side."""
    rows = set(range(CHECK_STEP // 2, h, CHECK_STEP))
    for r in (h // 2 - 1, h // 2, round(0.4 * h), round(0.807 * h)):
        rows.update((r - 1, r, r + 1))
    return sorted(r for r in rows if 0 <= r < h)


def partition(h, n=PARTITION):
    """``n`` bands of rows ``(row0, rows)`` that cover an h-row frame."""
    cuts = [round(k * h / n) for k in range(n + 1)]
    return [(a, b - a) for a, b in zip(cuts, cuts[1:]) if b > a]


def banded_frame(torch, mod, scene, cfg):
    """Forward kernel ``mod``'s image of the whole frame, held bit for bit
    against its own launches on partition()'s bands of rows."""
    with torch.no_grad():
        got = img(mod.render_color_kernel(scene, cfg))
        for r0, h in partition(cfg.yres):
            band = img(mod.render_color_kernel(scene, cfg, (r0, 0), (h, cfg.xres)))
            if not np.array_equal(band, got[r0:r0 + h]):
                raise SystemExit(f"chip_smoke: {mod.__name__} {cfg.xres}x{cfg.yres} on rows "
                                 f"{r0}..{r0 + h - 1} is not the whole frame's")
    print(f"  {mod.__name__.split('.')[-1]} {cfg.xres}x{cfg.yres}: the whole frame bit-equal to "
          f"its launches on {PARTITION} bands of rows")
    return got


def compare(name, ref, got, mean_budget=BUDGET["mean"]):
    """Hold ``got`` against ``ref`` ((H, W, 3) arrays) within BUDGET, with
    ``mean_budget`` for the mean difference."""
    diff = np.abs(got - ref)
    frac = float((diff.max(-1) > BUDGET["tol"]).mean())
    mean, mx = float(diff.mean()), float(diff.max())
    same = float((got == ref).all(-1).mean())
    ok = np.isfinite(got).all() and frac <= BUDGET["frac"] and mean <= mean_budget
    print(f"  {name}: {frac:.4%} pixels > {BUDGET['tol']}, mean {mean:.3g}, "
          f"max {mx:.3g}, {same:.4%} bit-equal -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} outside the budget {BUDGET}, mean {mean_budget}")
    return mx


def off_boundary(ref, bad):
    """How many of the pixels ``bad`` lie off a decision boundary: local
    contrast at most KNIFE_EDGE's in the 3x3 neighbourhood of ``ref``."""
    lum = ref.mean(-1)
    pad = np.pad(lum, 1, mode="edge")
    h, w = lum.shape
    win = np.stack([pad[r:r + h, c:c + w] for r in range(3) for c in range(3)])
    return int((bad & (win.max(0) - win.min(0) <= KNIFE_EDGE["contrast"])).sum())


def leaf_err(name, scene, got, want):
    """The largest relative L2 (norm floor 1e-2) of table cotangents ``got``
    against ``want`` over the scene's leaves, and its leaf; every leaf of
    ``got`` must be finite (``pattern_scale`` is checked finite only)."""
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

    got, want = kb.leaf_grads(scene, got), kb.leaf_grads(scene, want)
    worst, worst_leaf = 0.0, None
    for path, w in want.items():
        a = got[path].detach().cpu().numpy().astype(np.float64)
        if not np.isfinite(a).all():
            raise SystemExit(f"chip_smoke: {name}: {path} cotangent not finite")
        if "pattern_scale" in path:
            continue
        b = w.detach().cpu().numpy().astype(np.float64)
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-2))
        if rel >= worst:
            worst, worst_leaf = rel, path
    return worst, worst_leaf


def knife_edge_only(name, on, off):
    """Hold image ``on`` against ``off`` ((H, W, 3) arrays) to KNIFE_EDGE:
    few pixels differ, each on a decision boundary of ``off``."""
    diff = np.abs(on - off).max(-1)
    bad = diff > KNIFE_EDGE["tol"]
    flat = off_boundary(off, bad)
    ok = np.isfinite(on).all() and bad.mean() <= KNIFE_EDGE["frac"] and flat == 0
    print(f"  {name}: {bad.mean():.4%} pixels > {KNIFE_EDGE['tol']} (max {diff.max():.3g}), "
          f"{flat} of them off a decision boundary -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} is not knife-edge-only ({KNIFE_EDGE})")


def floor_tail_scenes(rtt):
    """tests/test_pallas.py:264-322's two floor-tail scenes with their
    configs: the branch matrix and the escape-glow regression."""
    down = (0.0, -np.pi / 2, -np.pi / 2)
    mats = [rtt.MaterialSpec(name="glowfloor", diffuse=(0.8, 0.8, 0.2), glow_dist=3.0),
            rtt.MaterialSpec(name="glowball", diffuse=(0.8, 0.2, 0.2), glow_dist=4.0),
            rtt.MaterialSpec(name="dull", diffuse=(0.3, 0.3, 0.6))]
    objs = [rtt.FloorSpec("glowfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            rtt.SphereSpec("glowball", 80.0, (400.0, -100.0, 600.0)),
            rtt.SphereSpec("dull", 60.0, (0.0, -180.0, 1500.0))]
    matrix = rtt.build_scene(mats, objs, (0.0, -295.0, -300.0), down, (50.0, 60.0, -50.0))[0]
    mats = [rtt.MaterialSpec(name="floor", diffuse=(0.9, 0.9, 0.3)),
            rtt.MaterialSpec(name="glow", diffuse=(0.9, 0.1, 0.1), glow_dist=1.0)]
    objs = [rtt.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0)),
            rtt.SphereSpec("glow", 100.0, (0.0, -150.0, 2000.0))]
    escape = rtt.build_scene(mats, objs, (0.0, -295.0, -300.0), down, (50.0, 60.0, -50.0))[0]
    march = dict(xres=64, yres=48, use_raymarching=True, max_refractions=1)
    return [("branch matrix 64x48", matrix,
             rtt.RenderConfig(glow_effect=1.5, march_max_iter=600, **march)),
            ("escape-glow regression 64x48", escape,
             rtt.RenderConfig(glow_effect=2.0, march_max_iter=2000, **march))]


def img(col):
    return np.stack([c.detach().cpu().numpy() for c in col], -1)


def spheres_scene(rtt, seed, n_spheres, glow_dist=0.0):
    """tests/test_parity.py:75-102's seeded sphere field (seed 7, 39
    spheres + floor), or another seed and count; ``glow_dist`` makes the
    first material glow in march mode."""
    return spheres_build(rtt, seed, n_spheres, glow_dist)[0]


def spheres_build(rtt, seed, n_spheres, glow_dist=0.0):
    """:func:`spheres_scene` with its ``SceneMeta``."""
    rng = np.random.default_rng(seed)
    mats = [
        rtt.MaterialSpec(name="m0", diffuse=(0.9, 0.4, 0.2), specular=(0.3, 0.3, 0.3), pn=8,
                         glow_dist=glow_dist),
        rtt.MaterialSpec(name="m1", diffuse=(0.1, 0.5, 0.9), specular=(0.0, 0.0, 0.0), pn=0),
    ]
    objs = [rtt.FloorSpec("m0", (0.0, -100.0, 0.0), (0.0, 1.0, 0.0))]
    for _ in range(n_spheres):
        c = rng.uniform(-300, 300, 3)
        c[2] = rng.uniform(100, 600)
        r = rng.uniform(10, 50)
        m = int(rng.integers(0, 2))
        objs.append(rtt.SphereSpec(f"m{m}", float(r), tuple(float(v) for v in c)))
    return rtt.build_scene(mats, objs, (0.0, 0.0, -400.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0))


def ptxas_figures(log, kernel=""):
    """Each kernel's (registers, stack frame, spill stores, spill loads)
    in a ``ptxas -v`` log, in the log's order, of the kernels whose mangled
    names hold ``kernel``."""
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        if kernel not in chunk.split("'", 1)[0]:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        out.append((int(regs.group(1)), *map(int, frame.groups())))
    return out


def roofline(ops, nbytes):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``ops`` f32 operations and ``nbytes`` bytes moved once."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def io_bytes(scene, cfg, pixels=None):
    """Bytes a render must move: the packed tables read once (f32 and i32
    rows of 19 and 4 words, camera and light), the three f32 planes of its
    ``pixels`` (the frame's by default) written once; with textures, the
    atlas's meta rows."""
    meta = 0 if scene.textures is None else 4 * 4 * scene.textures.data.shape[0]
    pixels = cfg.xres * cfg.yres if pixels is None else pixels
    return 4 * (scene.objects.count * (19 + 4) + 8 + 4) + 3 * 4 * pixels + meta


def texel_bytes(scene, fetched):
    """Atlas bytes a frame must read: 16 B for each texture fetch its
    traversal makes (``fetched``, counted by the host build), but no more
    than the whole atlas, read once."""
    if scene.textures is None:
        return 0
    return min(fetched, 16 * scene.textures.data[..., 0].numel())


def _host_scene(texture_dir, texture_filter):
    import ray_rust_tpu_torch as rtt

    return rtt.default_scene(texture_dir=texture_dir, texture_filter=texture_filter,
                             device="cpu")[0]


def count_ops(name, mod, cfg, texture_dir=".", texture_filter=0, scene=None, window=None,
              fn=None):
    """The f32 operations kernel ``name``'s body (``"trace"`` or
    ``"march"``) takes on the default scene (or the CPU ``scene``) under
    ``cfg``, textured from ``texture_dir``, and the texel bytes its texture
    fetches read: its host build with -DRT_COUNT_OPS, run on the CPU. A
    march body also gives the most operations of one pixel, the object
    passes and the most passes of one pixel and the marches the
    never-converges test ended (``kernel_march.OPS_SLOTS`` counts in all);
    the trace body, where it takes K1b's cull (above 64 objects), the
    objects the cull tested, the primary candidates scanned and the scans,
    and the shadow candidates scanned and the scans (eight counts in
    all). ``window`` (row0, col0, h, w) counts that window of the frame
    alone (the multi-device layer's cells); ``fn`` names another host loop
    of the library (``rt_march_deep_host``: the deep march)."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops.rays import fov_scales

    lib = _build.build_host_library(_build.BUILD_DIR, name, count_ops=True)
    if scene is None:
        scene = _host_scene(texture_dir, texture_filter)
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)  # held until the call returns
    window = kt.window(cfg) if window is None else window
    out = torch.empty((3, window[2], window[3]), dtype=torch.float32)
    ops = torch.zeros(max(km.OPS_SLOTS, 8), dtype=torch.int64)
    sx, sy = fov_scales(cfg)
    cpu = torch.device("cpu")
    args = (kt.launch_args(cfg, tex, cpu, scene.objects.count) if mod is kt
            else mod.launch_args(cfg, tex, cpu))
    getattr(lib, fn or f"rt_{name}_host")(
        *(t.data_ptr() for t in tables), scene.objects.count, cfg.xres, cfg.yres,
        *window, sx, sy, *args, *(plane.data_ptr() for plane in out), ops.data_ptr())
    return tuple(int(v) for v in ops)


def count_bwd_ops(name, mod, cfg, texture_dir=".", texture_filter=0, window=None, scene=None):
    """The f32 operations of backward kernel ``name``'s record pass
    (``"trace_bwd"``: its raycasts; ``"march_bwd"``: its SDF steps) on the
    default scene under ``cfg``, textured from ``texture_dir``, and the texel
    bytes the record pass's texture fetches read: its host build with
    -DRT_COUNT_OPS (all ``kernel_march.OPS_SLOTS`` counts, as
    :func:`count_ops`; the trace backward's slots 2-5 are its accumulator's
    adds, their distinct (warp, entry) pairs, the sites and the most sites of
    one pixel, csrc/trace_bwd_host.cpp, for cotangent 1 on every pixel).
    ``window`` (row0, col0, h, w) counts that window of the frame alone;
    ``scene`` (on the CPU) replaces the default scene. A configuration the
    buffer instance takes runs its host twin band by band, as the wrapper
    launches the kernel (within ``HOST_RECORD_BUDGET``)."""
    import torch

    from ray_rust_tpu_torch.models.vec import Color
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

    lib = _build.build_host_library(_build.BUILD_DIR, name, count_ops=True)
    if scene is None:
        scene = _host_scene(texture_dir, texture_filter)
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)
    trace = name == "trace_bwd"
    cpu = torch.device("cpu")
    args = mod.launch_args(cfg, tex, cpu)
    window = kt.window(cfg) if window is None else window
    g = Color(*(torch.ones if trace else torch.zeros)((3, window[2], window[3]),
                                                       dtype=torch.float32))
    ops = torch.zeros(km.OPS_SLOTS, dtype=torch.int64)
    ptrs, n = [t.data_ptr() for t in tables], scene.objects.count
    common = (ptrs, n, cpu, cfg, args, g, False, window[:2], window[2:])
    if mod.buffered(cfg):
        cap = kb.site_cap(cfg) if trace else mod.count_sites(cfg)
        kb.launch_buffered(lib, getattr(lib, f"rt_{name}_buf_host"), *common,
                           cap_words=mod.RECORD_WORDS * cap, extra=() if trace else (cap,),
                           budget=HOST_RECORD_BUDGET, tail=(ops.data_ptr(),))
    else:
        kb.launch_block(lib, getattr(lib, f"rt_{name}_host"), *common, tail=(ops.data_ptr(),))
    return tuple(int(v) for v in ops)


def count_retrace_ops(cfg):
    """The re-trace oracle's counts for one cotangent on the default scene
    under ``cfg``: its host build with -DRT_COUNT_OPS, all
    ``kernel_trace_retrace.OPS_SLOTS`` (the value pass's object tests and
    every forward-mode operation with its tangents, the Dual passes, the
    most passes of one pixel, the sum over rows of 32 pixels of their
    longest pixel's passes, the histogram of distinct winners a pixel).
    The operations are a diagnostic: the oracle's bound is the trace
    backward's, whose function it computes."""
    import torch

    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    lib = _build.build_host_library(_build.BUILD_DIR, "trace_retrace", count_ops=True)
    scene = _host_scene(".", 0)
    g = [torch.zeros((cfg.yres, cfg.xres), dtype=torch.float32) for _ in range(3)]
    ops = torch.zeros(kr.OPS_SLOTS, dtype=torch.int64)
    tables = kt.pack_scene(scene)  # held until the call returns
    kr.launch_all(lib, "rt_trace_retrace_host", [t.data_ptr() for t in tables],
                  scene.objects.count, torch.device("cpu"), cfg, g, False, (ops.data_ptr(),))
    return tuple(int(v) for v in ops)


def event_ms(torch, fn):
    """``fn()`` once, and its ms by events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(torch, fn, warm=3, reps=10):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy(torch, fn, reps=10):
    """The card's busy time and span per call of ``fn`` over ``reps`` calls
    after 3 warm-ups, in ms, from a ``torch.profiler`` trace of the card
    alone, and its kernels, copies and sets per call by name: busy is the
    union of them, the span runs from the first one's start to the last
    one's end. (0, 0, {}) where the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    if not spans:
        return 0.0, 0.0, {}
    busy, end = 0.0, spans[0][0]
    for a, b in spans:  # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    names = {}
    for e in device:
        names[e["name"]] = names.get(e["name"], 0) + 1
    return (busy / 1e3 / reps, (end - spans[0][0]) / 1e3 / reps,
            {k: n / reps for k, n in names.items()})


def host_ms(torch, fn, reps=100):
    """The host's clock per call of ``fn`` over ``reps`` calls after 3
    warm-ups, without waiting for the card inside the loop: the enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def pack_bytes(scene):
    """Bytes the pack must move: each leaf it reads once (the objects' 10
    columns, the materials' 15, the camera's 7 and the light's 3, the
    textures' widths and heights), its words written once."""
    from ray_rust_tpu_torch.ops import kernel_pack as kp

    n, m, n_tex, _ = kp.sizes(scene)
    return 4 * (10 * n + 15 * m + 10 + 2 * n_tex) + 4 * kp.pack_words(n, n_tex)


def pull_back_bytes_ops(scene):
    """Bytes the pull-back must move (the block and the material indices
    read once, a cotangent for each element of the scene's float leaves
    written once) and its f32 operations: each object adds its 12 material
    columns the tables read once."""
    from ray_rust_tpu_torch.ops import kernel_pack as kp

    n = scene.objects.count
    written = sum(t.numel() for t in kp.float_leaves(scene))
    return 4 * ((n + 1) * kp.GRAD_COLS + n) + 4 * written, 12 * n


def training_step(torch, render, cfg, base):
    """The training step without the update, as a function of no arguments:
    render ``base`` with ``render`` under ``cfg``, MSE against a target 0.05
    brighter, the gradient of every float leaf (the texture atlas is u8: a
    constant)."""
    target = torch.full((cfg.yres, cfg.xres, 3), 0.05, device=base.device)
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in base.tensors()]
    params = [t for t in leaves if t.requires_grad]
    s_grad = base.with_tensors(leaves)

    def go():
        loss = (torch.stack(list(render(s_grad, cfg)), -1) - target).square().mean()
        torch.autograd.grad(loss, params, allow_unused=True)
    return go


def textured_bwd_scene(rtt):
    """tests/test_pallas_bwd.py:116-138's scene: a 12x20 noise texture on the
    floor (Bilinear), seen directly, in a mirror and through glass."""
    tex = np.random.default_rng(5).integers(0, 256, (12, 20, 3)).astype(np.uint8)
    mats = [
        rtt.MaterialSpec(name="texfloor", diffuse=(1.0, 1.0, 0.0), pattern=2,
                         pattern_scale=300.0, pattern_angle_scale=0.2, texture_filter=1,
                         texture=tex),
        rtt.MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24),
        rtt.MaterialSpec(name="glass", transparency=1.0, refraction=1.5),
    ]
    objs = [rtt.FloorSpec("texfloor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
            rtt.SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0)),
            rtt.SphereSpec("glass", 100.0, (70.0, -200.0, 150.0))]
    scene, _ = rtt.build_scene(mats, objs, (0.37, -150.3, -300.0),
                               (0.0, -np.pi / 2, -np.pi / 2), (50.0, 60.0, -50.0))
    return scene


# Two keyframes spliced into a scene file: one slerped to its pose, one
# looking at the mirror sphere (tests/test_serialize.py:74-81's form)
MOTION = """camera_motion:
- camera:
    position: {x: 40.0, y: 0.0, z: -400.0}
    pyr: {x: 0.1, y: -1.5707964, z: -1.5707964}
  velocity: {x: 10.0, y: 0.0, z: 0.0}
  duration: 1.0
- camera:
    position: {x: 80.0, y: 20.0, z: -380.0}
    pyr: {x: 0.0, y: -1.5707964, z: -1.5707964}
  velocity: {x: 0.0, y: 0.0, z: 0.0}
  camera_target: {x: 0.0, y: 0.0, z: 300.0}
  duration: 1.5
"""


def scene_files(torch, rtt, cli, kt, km, kp, built):
    """Configuration 4: the scene ``built`` (a scene and its meta) written
    by ``serialize_scene``, then the CLI's ``-d`` on it in trace mode at
    1920x1080 and in march + glow at 1280x720 (one kernel and one pack
    launch each, the PNG ``render_u8`` of the loaded scene under the file's
    caps), ``-s`` on the loaded scene (its file loads back to the same
    leaves, bit for bit, as the scene written), and a file with two camera
    keyframes at 320x240, whose frames must be the JAX package's count for
    the file (the sum of duration / FRAME_STEP, as ray_rust_tpu/animation.py
    renders them), one trace launch each. Returns each request's wall time
    in seconds and the trace request's K1 launches that took K1b's cull."""
    from ray_rust_tpu_torch.models.serialize import deserialize_scene, serialize_scene
    from ray_rust_tpu_torch.utils.image import load_png

    def leaves(scene):
        return rtt.scene_to_numpy(scene)

    def same_leaves(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    scene, meta = built
    wall = {}
    with tempfile.TemporaryDirectory() as sd:
        path = os.path.join(sd, "spheres.yaml")
        with open(path, "w") as f:
            f.write(serialize_scene(scene, meta))
        with open(path) as f:
            loaded, _, caps = deserialize_scene(f.read())
        if not same_leaves(leaves(loaded), leaves(scene)):
            raise SystemExit("chip_smoke: the scene file does not load back to its scene")
        for name, (w, h), march, mod, other in (("trace", (W, H), False, kt, km),
                                                ("march + glow", (MW, MH), True, km, kt)):
            png_path = os.path.join(sd, "out.png")
            kt.LAUNCHES = km.LAUNCHES = kp.LAUNCHES = kt.CULL_LAUNCHES = 0
            t0 = time.time()
            argv = [str(w), str(h), "-d", path, "-o", png_path] + (["-m", "-g", "1.0"] if march
                                                                   else [])
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall[name] = time.time() - t0
            launches = (mod.LAUNCHES, other.LAUNCHES, kp.LAUNCHES)
            if not march:  # above 64 objects K1 takes K1b's cull
                cull_launches = kt.CULL_LAUNCHES
                print(f"  of them with K1b's cull: {cull_launches}")
                if cull_launches != (scene.objects.count > kt.CULL_MIN_OBJECTS):
                    raise SystemExit(f"chip_smoke: -d trace: {cull_launches} K1 launches took "
                                     f"the cull")
            cfg = rtt.RenderConfig(xres=w, yres=h, use_raymarching=march,
                                   glow_effect=1.0 if march else None, **caps)
            png = load_png(png_path)
            print(f"main path, -d {name} (configuration 4, {scene.objects.count} objects): CLI "
                  f"{w}x{h} in {wall[name]:.2f} s, launches (kernel, other kernel, pack) "
                  f"{launches}")
            if rc != 0 or launches != (1, 0, 1):
                raise SystemExit(f"chip_smoke: -d {name}: CLI exit {rc}, launches {launches}")
            if not np.array_equal(png, rtt.render_u8(loaded, cfg)) or png.std() < 10:
                raise SystemExit(f"chip_smoke: -d {name}: the PNG is not render_u8 of the file's "
                                 f"scene")
        copy = os.path.join(sd, "copy.yaml")
        t0 = time.time()
        rc = cli.main(["320", "240", "-d", path, "-s", copy, "-o", os.path.join(sd, "s.png")])
        torch.cuda.synchronize()
        wall["-s"] = time.time() - t0
        with open(copy) as f:
            again = deserialize_scene(f.read())[0]
        ok = rc == 0 and same_leaves(leaves(again), leaves(loaded))
        print(f"main path, -s on the loaded scene: CLI 320x240 in {wall['-s']:.2f} s, its file "
              f"loads back to the same leaves bit for bit: {ok}")
        if not ok:
            raise SystemExit("chip_smoke: -s did not round-trip the loaded scene")
        with open(path) as f:
            text = f.read().replace("camera_motion: []\n", MOTION)
        motion = os.path.join(sd, "motion.yaml")
        with open(motion, "w") as f:
            f.write(text)
        want = sum(int(d / FRAME_STEP) for d in (1.0, 1.5))  # MOTION's durations
        kt.LAUNCHES = km.LAUNCHES = 0
        t0 = time.time()
        rc = cli.main(["320", "240", "-d", motion, "-o", os.path.join(sd, "frame")])
        torch.cuda.synchronize()
        wall["camera_motion"] = time.time() - t0
        files = sorted(n for n in os.listdir(sd) if n.startswith("frame"))
        frames = [load_png(os.path.join(sd, f"frame{i}.png")) for i in range(want)
                  if f"frame{i}.png" in files]
        print(f"main path, camera_motion at 320x240: {len(files)} frames (the JAX package's "
              f"count: {want}) in {wall['camera_motion']:.2f} s, {kt.LAUNCHES} trace launches")
        if (rc != 0 or sorted(files) != sorted(f"frame{i}.png" for i in range(want))
                or kt.LAUNCHES != want or km.LAUNCHES != 0):
            raise SystemExit(f"chip_smoke: camera_motion: CLI exit {rc}, frames {files}, "
                             f"{kt.LAUNCHES} trace launches, want {want}")
        if any(f.shape != (240, 320, 3) for f in frames) or np.array_equal(frames[0], frames[-1]):
            raise SystemExit("chip_smoke: camera_motion: the frames are not a moving camera's")
    return wall, cull_launches


def cli_file(torch, rtt, cli, kt, kp, built, w, h):
    """The CLI's ``-d`` on the scene ``built`` (scene, meta) written by
    ``serialize_scene``, in trace mode at w x h: one K1 launch, with K1b's
    cull above 64 objects, and one pack, the PNG ``render_u8`` of the loaded
    scene. Returns the request's wall time in seconds and its K1 launches
    that took the cull."""
    from ray_rust_tpu_torch.models.serialize import deserialize_scene, serialize_scene
    from ray_rust_tpu_torch.utils.image import load_png

    scene, meta = built
    with tempfile.TemporaryDirectory() as sd:
        path, png_path = os.path.join(sd, "many.yaml"), os.path.join(sd, "out.png")
        with open(path, "w") as f:
            f.write(serialize_scene(scene, meta))
        kt.LAUNCHES = kp.LAUNCHES = kt.CULL_LAUNCHES = 0
        t0 = time.time()
        rc = cli.main([str(w), str(h), "-d", path, "-o", png_path])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = (kt.LAUNCHES, kt.CULL_LAUNCHES, kp.LAUNCHES)
        with open(path) as f:
            loaded, _, caps = deserialize_scene(f.read())
        png = load_png(png_path)
        print(f"main path, -d trace ({scene.objects.count} objects): CLI {w}x{h} in {wall:.2f} s, "
              f"launches (K1, of them with the cull, pack) {launches}")
        if rc != 0 or launches != (1, 1, 1):
            raise SystemExit(f"chip_smoke: -d {scene.objects.count} objects: CLI exit {rc}, "
                             f"launches {launches}")
        want = rtt.render_u8(loaded, rtt.RenderConfig(xres=w, yres=h, **caps))
        if not np.array_equal(png, want) or png.std() < 10:
            raise SystemExit(f"chip_smoke: -d {scene.objects.count} objects: the PNG is not "
                             f"render_u8 of the file's scene")
    return wall, launches[1]


# Phase 6, the host apps: the example's documented size and step count
# (examples/inverse_rendering.py:13, 200 steps), the 3-step comparison's size,
# the scan oracle's (tests/test_grad.py:235-255 at a larger frame)
EXAMPLE_SIZE, EXAMPLE_STEPS = 320, 200
COMPARE_SIZE = 160
SCAN_CFG = dict(xres=160, yres=120, use_raymarching=True, max_refractions=1,
                march_max_iter=512)
SCAN_BUDGET, SCAN_RTOL = 256, 5e-3
# Two Adam runs' steps from one state (tests/test_torch_inverse.py:
# NOISE_MOMENT, STEP_ATOL): entries whose bias-corrected first moment is
# under NOISE_MOMENT may be apart by lr, the others by STEP_ATOL
NOISE_MOMENT, STEP_ATOL = 1e-6, 1e-3
# a resumed run's 10 losses against the uninterrupted run's, on the CPU; on
# the card the resumed run and two twins repeat it bit for bit over
# RESUME_STEPS steps
RESUME_RTOL = 1e-3
RESUME_STEPS = 20


def trace_frame(torch, rtt, scene, cfg) -> None:
    """``utils/profiling.device_trace`` around one frame of ``scene`` under
    ``cfg``: the trace must hold K1 and the pack kernel. Run as the
    process's first profiler session: on torch 2.11 a later one may lose the
    card's records (PERF.md §7), and ``device_trace`` then raises."""
    from ray_rust_tpu_torch.utils.profiling import device_trace

    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with device_trace(log_dir) as prof:
            rtt.render_color(scene, cfg)
        traced_s = time.perf_counter() - t0
        with open(os.path.join(log_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    print(f"  device_trace, one {cfg.xres}x{cfg.yres} frame: {len(events)} events, "
          f"{len(prof.key_averages())} operators, kernels {kernels}; {traced_s:.2f} s with "
          "its settling wait")
    if not any("trace_fwd_kernel" in k for k in kernels) or \
            not any("pack_scene_kernel" in k for k in kernels):
        raise SystemExit(f"chip_smoke: K1 or the pack is not in the device trace: {kernels}")


def resume_run(torch, device, size, n_twins, steps=10):
    """Checkpoint and resume of the example's training at ``size`` on
    ``device``: a run takes 10 steps and is saved; it goes on for ``steps``
    more (uninterrupted), a fresh state restored from the save takes the
    same steps (resumed), and so do ``n_twins`` copies of the saved state in
    memory. Raises SystemExit unless the restored state is the saved one bit
    for bit and every loss is finite. Returns the runs' losses over those
    steps (uninterrupted, resumed, twins), the saved tensors' count and each
    run's leaves at the end (on the CPU)."""
    import copy

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch import checkpoint
    from ray_rust_tpu_torch.examples import inverse_rendering as example
    from ray_rust_tpu_torch.parallel import SceneAdam, TrainState, make_train_step

    cfg = example.example_config(size)
    _, target, s0 = example.problem(cfg, device)
    opt = SceneAdam(0.5)
    step = make_train_step(cfg, opt)
    state = TrainState(s0, opt.init(s0))
    for _ in range(10):
        state, _ = step(state, target)
    with tempfile.TemporaryDirectory() as ck_dir:
        ck = checkpoint.Checkpointer(ck_dir, keep=1)
        ck.save(9, state)
        saved = [(n, t.detach().cpu().clone()) for n, t in checkpoint.leaves(state)]
        s1 = example.perturbed(rtt.default_scene(device=device)[0])
        resumed, start = ck.restore_or(TrainState(s1, opt.init(s1)))
    back = [(n, t.detach().cpu()) for n, t in checkpoint.leaves(resumed)]
    if start != 10 or [n for n, _ in saved] != [n for n, _ in back] or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(saved, back)):
        raise SystemExit(f"chip_smoke: the restored state is not the saved one ({device})")
    twins = [copy.deepcopy(state) for _ in range(n_twins)]
    losses, ends = [], []
    for run in (state, resumed, *twins):
        losses.append([])
        for _ in range(steps):
            run, loss = step(run, target)
            losses[-1].append(float(loss))
        ends.append([t.detach().cpu().clone() for _, t in checkpoint.leaves(run)])
    if not np.isfinite(losses).all():
        raise SystemExit(f"chip_smoke: the losses after the save are not finite ({device}): "
                         f"{losses}")
    return losses, len(saved), ends


# resume_run on the CPU in a process of its own (argv: the size), started at
# the host apps' phase start so that its plain steps overlap the card's work;
# prints the losses and the saved tensors' count as JSON
RESUME_CHILD = """
import json, sys, torch
torch.set_num_threads(2)
import chip_smoke
losses, n_saved, _ = chip_smoke.resume_run(torch, torch.device("cpu"), int(sys.argv[1]), 0)
print(json.dumps({"losses": losses, "saved": n_saved}))
"""


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes to an (H, W, 3) uint8 array with the port's reader."""
    from ray_rust_tpu_torch.utils.image import load_png

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.png")
        with open(path, "wb") as f:
            f.write(data)
        return load_png(path)


def host_apps(torch, card) -> None:
    """Phase 6: the viewer (trace 1920x1080, march + glow 1280x720), the
    inverse-rendering example and its 1080p step, its first steps through
    the kernels against the plain version, checkpoint and resume (on the
    CPU in a process started first), the scan-mode march oracle against K4,
    profiling and ray accounting, and the two PNG encoders. Raises
    SystemExit on any failure."""
    resume_cpu = subprocess.Popen([sys.executable, "-c", RESUME_CHILD, str(COMPARE_SIZE)],
                                  cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
    try:
        host_apps_checks(torch, card, resume_cpu)
    finally:
        if resume_cpu.poll() is None:
            resume_cpu.kill()
            resume_cpu.wait()


def host_apps_checks(torch, card, resume_cpu) -> None:
    """The checks of :func:`host_apps`; ``resume_cpu`` is the running
    process of ``RESUME_CHILD``."""
    import contextlib
    import io
    import threading
    import urllib.error
    import urllib.request

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch import checkpoint, webserver
    from ray_rust_tpu_torch.examples import inverse_rendering as example
    from ray_rust_tpu_torch.models.quat import Quat
    from ray_rust_tpu_torch.models.scene import leaf_paths
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops.accounting import count_traced_rays
    from ray_rust_tpu_torch.parallel import SceneAdam, TrainState, make_train_step
    from ray_rust_tpu_torch.utils import native
    from ray_rust_tpu_torch.utils.image import encode_png as encode_png_stdlib
    from ray_rust_tpu_torch.utils.profiling import RenderTimer

    dev = torch.device("cuda", 0)
    print(f"host apps, on {card}; PNG encoder of save_png and the viewer: stdlib zlib; of the "
          f"CLI's camera-motion frames: " + ("native" if native.native_available() else
                                            f"stdlib zlib ({native.build_error()})"))

    # -- the viewer: each request's render + copy (render_u8) and encode
    split = []
    render_u8, encode_png = webserver.render_u8, webserver.encode_png

    def timed_render(scene, cfg):
        t0 = time.perf_counter()
        img = render_u8(scene, cfg)
        split.append(["render+copy", time.perf_counter() - t0])
        return img

    def timed_encode(img):
        t0 = time.perf_counter()
        data = encode_png(img)
        split[-1] += ["encode", time.perf_counter() - t0]
        return data

    webserver.render_u8, webserver.encode_png = timed_render, timed_encode
    scene, meta = rtt.default_scene(device=dev)
    poses = [(0.0, -150.0, -300.0, -90.0, 0.0), (120.0, -120.0, -320.0, -78.5, 0.0),
             (-80.0, -60.0, -280.0, -95.7, -8.6)]
    try:
        for name, cfg, mod, want_poses in (
                ("trace", rtt.RenderConfig(xres=W, yres=H), kt, poses),
                ("march + glow", rtt.RenderConfig(xres=MW, yres=MH, use_raymarching=True,
                                                  glow_effect=1.0), km, poses[:1])):
            server = webserver.make_server(scene, meta, cfg, 0)
            url = f"http://127.0.0.1:{server.server_address[1]}"
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            try:
                with contextlib.redirect_stdout(io.StringIO()):  # the request log
                    page = urllib.request.urlopen(f"{url}/").read()
                    try:
                        urllib.request.urlopen(f"{url}/nope")
                        raise SystemExit("chip_smoke: the viewer served /nope")
                    except urllib.error.HTTPError as e:
                        if e.code != 404 or e.read() != b"empty":
                            raise SystemExit(f"chip_smoke: /nope gave {e.code}") from None
                if b"ray-rust-tpu web interface" not in page or b"buttonStates" not in page:
                    raise SystemExit("chip_smoke: the viewer's page lacks its client")
                walls, frames = [], []
                for x, y, z, yaw, pitch in want_poses:
                    mod.LAUNCHES = 0
                    split.clear()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        resp = urllib.request.urlopen(
                            f"{url}/render?x={x}&y={y}&z={z}&yaw={yaw}&pitch={pitch}")
                        data = resp.read()
                    walls.append((time.perf_counter() - t0, split[0][1], split[0][3]))
                    if mod.LAUNCHES != 1:
                        raise SystemExit(f"chip_smoke: a {name} request launched its kernel "
                                         f"{mod.LAUNCHES} times")
                    if resp.headers["Content-Type"] != "image/png" or \
                            resp.headers["Cache-Control"] != "no-cache":
                        raise SystemExit("chip_smoke: the viewer's headers")
                    frames.append(decode_png(data))
                    pyr = rtt.v3(pitch * np.pi / 180, yaw * np.pi / 180,
                                 float(scene.camera.pyr.z), device=dev)
                    cam = scene.camera._replace(position=rtt.v3(x, y, z, device=dev), pyr=pyr,
                                                rotation=Quat.from_pyr(pyr))
                    want = render_u8(scene._replace(camera=cam), cfg)
                    if not np.array_equal(frames[-1], want):
                        raise SystemExit(f"chip_smoke: /render ({name}) differs from render_u8 "
                                         "of the same pose")
                    if want.std() < 10:
                        raise SystemExit(f"chip_smoke: the {name} view looks empty")
            finally:
                server.shutdown()
                server.server_close()
                th.join(timeout=10)
            print(f"viewer, {name} {cfg.xres}x{cfg.yres}: " + "; ".join(
                f"request {w * 1e3:.1f} ms (render + copy {r * 1e3:.1f}, encode {e * 1e3:.1f})"
                for w, r, e in walls) + f"; each /render bit-equal to render_u8 of its pose, "
                f"one {mod.__name__.rsplit('.', 1)[1]} launch each")
            if len(frames) > 1 and np.array_equal(frames[0], frames[1]):
                raise SystemExit("chip_smoke: two viewer poses gave the same image")
    finally:
        webserver.render_u8, webserver.encode_png = render_u8, encode_png

    # -- the inverse-rendering example at its documented size
    kt.LAUNCHES = kb.LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = example.main(["--size", str(EXAMPLE_SIZE), "--steps", str(EXAMPLE_STEPS)])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    rows = [line.split() for line in text.splitlines() if line.startswith("step ")]
    losses = {int(r[1]): float(r[3]) for r in rows}
    print(f"example {EXAMPLE_SIZE}x{EXAMPLE_SIZE * 3 // 4}, {EXAMPLE_STEPS} steps in {wall:.2f} s:"
          f" exit code {rc}; " + "; ".join(" ".join(r) for r in rows[::4] + rows[-1:])
          + "; " + text.strip().splitlines()[-1] + f"; launches K1 {kt.LAUNCHES}, K2 {kb.LAUNCHES}")
    if (kt.LAUNCHES, kb.LAUNCHES) != (EXAMPLE_STEPS + 1, EXAMPLE_STEPS):
        raise SystemExit("chip_smoke: want one K1 and one K2 launch a step (and K1 for the "
                         f"target), got {kt.LAUNCHES} and {kb.LAUNCHES}")
    if not rows or "|dx_red|" not in text or not np.isfinite(list(losses.values())).all():
        raise SystemExit("chip_smoke: the example printed no finite losses and |dx_red|")
    if rc != (0 if losses[EXAMPLE_STEPS - 1] < 1e-2 else 1):
        raise SystemExit(f"chip_smoke: the example's exit code {rc} is not its criterion")
    # the loss need not fall: Adam's first steps move every trained leaf by
    # about lr, so it rises from the perturbed start in the JAX example too
    # (PERF.md §6); the red sphere's distance from the target falls in both
    dx_red = {int(r[1]): float(r[5]) for r in rows}
    if not dx_red[EXAMPLE_STEPS - 1] < dx_red[0]:
        raise SystemExit(f"chip_smoke: the example moved the red sphere no nearer its target: "
                         f"|dx_red| {dx_red[0]} -> {dx_red[EXAMPLE_STEPS - 1]}")

    # -- the 1080p Adam step, by events and by the host's clock
    cfg = example.example_config(W).with_(yres=H)
    _, target, scene0 = example.problem(cfg, dev)
    opt = SceneAdam(0.5)
    step = make_train_step(cfg, opt)
    state = TrainState(scene0, opt.init(scene0))
    step_ms = cuda_ms(torch, lambda: step(state, target), warm=3, reps=20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        state, loss = step(state, target)
    torch.cuda.synchronize()
    step_host_ms = (time.perf_counter() - t0) * 1e3 / 20
    print(f"Adam step {W}x{H} (the example's optimizer; K1, K2, the pack, the pull-back): "
          f"{step_ms:.3f} ms by events, {step_host_ms:.3f} ms by the host's clock (20 steps)")

    # -- the first 3 steps through the kernels against the plain version on
    # the CPU, each from the plain run's state before it, held as tests/
    # test_torch_inverse.py:step_apart holds the port to the JAX package:
    # 1e-3 on entries with a gradient, lr on noise entries (a bias-corrected
    # first moment under 1e-6, where Adam's step still depends on |g|
    # against its eps)
    cpu = torch.device("cpu")
    cfg = example.example_config(COMPARE_SIZE)
    _, target_cpu, s_cpu = example.problem(cfg, cpu)
    st_cpu = TrainState(s_cpu, opt.init(s_cpu))
    step_c = make_train_step(cfg, opt)
    worst = [0.0, 0.0]
    with tempfile.TemporaryDirectory() as ck_dir:
        for k in range(3):
            checkpoint.save(ck_dir, k, st_cpu)
            st_cpu, loss_cpu = step_c(st_cpu, target_cpu)
            fresh = example.perturbed(rtt.default_scene(device=dev)[0])
            st_dev, _ = checkpoint.restore(ck_dir, TrainState(fresh, opt.init(fresh)), k)
            st_dev, loss_dev = step_c(st_dev, target_cpu.to(dev))
            worst[1] = max(worst[1], abs(float(loss_dev) / float(loss_cpu) - 1))
            adam = st_cpu.opt_state
            moments = {id(p): adam.state[p]["exp_avg"] for p in adam.param_groups[0]["params"]}
            want = dict(zip(leaf_paths(st_cpu.scene), st_cpu.scene.tensors()))
            got = dict(zip(leaf_paths(st_dev.scene), st_dev.scene.tensors()))
            for path, t in want.items():
                d = np.abs(got[path].detach().cpu().numpy() - t.detach().numpy())
                if path not in opt.trained:
                    if d.max() != 0:
                        raise SystemExit(f"chip_smoke: step {k} moved the frozen {path}")
                    continue
                noise = np.abs(moments[id(t)].numpy() / (1 - 0.9 ** (k + 1))) < NOISE_MOMENT
                worst[0] = max(worst[0], float(d[~noise].max(initial=0.0)))
                if d[~noise].max(initial=0.0) > STEP_ATOL or d[noise].max(initial=0.0) > opt.lr:
                    raise SystemExit(f"chip_smoke: step {k} through the kernels moved {path} "
                                     f"apart from the plain step: {d.max()}")
    print(f"first 3 Adam steps at {COMPARE_SIZE}x{COMPARE_SIZE * 3 // 4} through K1 and K2 "
          f"against the plain version on the CPU (each from its state): trained leaves with a "
          f"gradient within {worst[0]:.3g} ({STEP_ATOL}), losses within {worst[1]:.3g} relative")

    # -- checkpoint and resume: a run takes 10 steps and is saved; it goes on
    # for more (uninterrupted), a fresh state restored from the save takes
    # the same steps (resumed), and so do copies of the state in memory
    # (twins). The restored state must be the saved one bit for bit. On the
    # CPU the 10 resumed losses must be within RESUME_RTOL of the
    # uninterrupted run's. On the card, where the backward kernels sum in
    # fixed point (csrc/fixed_sum.cuh), every run repeats the uninterrupted
    # one bit for bit: RESUME_STEPS losses each and the leaves at the end,
    # under torch.use_deterministic_algorithms(True), so that a torch
    # operation without a deterministic implementation on the path raises.
    def gaps(a, b):
        return [abs(x / y - 1) for x, y in zip(a, b)]

    out, err = resume_cpu.communicate(timeout=600)
    if resume_cpu.returncode != 0:
        raise SystemExit(f"chip_smoke: the CPU resume process failed:\n{err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    (ref, res), n_saved = got["losses"], got["saved"]
    gap_cpu = gaps(res, ref)
    if max(gap_cpu) > RESUME_RTOL:
        raise SystemExit(f"chip_smoke: on the CPU the resumed losses part from the "
                         f"uninterrupted run's by {max(gap_cpu)} (> {RESUME_RTOL})")
    print(f"checkpoint/resume on the CPU at {COMPARE_SIZE}x{COMPARE_SIZE * 3 // 4}: restored "
          f"state bit-equal to the saved one ({n_saved} tensors, Adam's moments and step "
          f"included); the 10 resumed losses within {max(gap_cpu):.3g} relative of the "
          f"uninterrupted run's ({RESUME_RTOL})")
    torch.use_deterministic_algorithms(True)
    try:
        (ref, *others), n_saved, (ref_end, *other_ends) = resume_run(
            torch, dev, EXAMPLE_SIZE, 2, RESUME_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    for name, losses, end in zip(("resumed", "twin 1", "twin 2"), others, other_ends):
        if losses != ref or not all(torch.equal(a, b) for a, b in zip(end, ref_end)):
            raise SystemExit(f"chip_smoke: on the card the {name} run is not the uninterrupted "
                             f"one bit for bit: losses {losses} against {ref}")
    print(f"checkpoint/resume on the card at {EXAMPLE_SIZE}x{EXAMPLE_SIZE * 3 // 4} under "
          f"torch.use_deterministic_algorithms(True): restored state bit-equal to the saved "
          f"one ({n_saved} tensors); the resumed run and two twins (copies of the saved state) "
          f"repeat the uninterrupted run bit for bit over {RESUME_STEPS} Adam steps (K1 + K2 "
          f"each), losses and leaves; losses {ref[0]:.9g} .. {ref[-1]:.9g}")

    # -- the scan-mode march oracle against K4's implicit VJP
    cfg = rtt.RenderConfig(**SCAN_CFG)

    def grad_y3(cfg):
        s = rtt.default_scene(device=dev)[0]
        y = s.objects.org.y.clone().requires_grad_()
        img = rtt.render_color(s._replace(objects=s.objects._replace(
            org=s.objects.org._replace(y=y))), cfg)
        return float(torch.autograd.grad((img.r + img.g + img.b).mean(), y)[0][3])

    km.LAUNCHES = kmb.LAUNCHES = 0
    t0 = time.perf_counter()
    implicit = grad_y3(cfg)
    t1 = time.perf_counter()
    k4 = (km.LAUNCHES, kmb.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    scan = grad_y3(cfg.with_(differentiable=True, march_budget=SCAN_BUDGET))
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    after_scan = (km.LAUNCHES, kmb.LAUNCHES)
    implicit_off = grad_y3(cfg.with_(march_floor_skip=False))
    print(f"scan oracle {cfg.xres}x{cfg.yres} (budget {SCAN_BUDGET}): d mean(rgb) / d org.y[3] "
          f"K4 {implicit:.6g} ({(t1 - t0) * 1e3:.0f} ms; K3, K4 launches {k4}), with the floor "
          f"tail off {implicit_off:.6g}, scan {scan:.6g} ({t2 - t1:.1f} s, peak {peak:.2f} GiB, "
          f"launches after it {after_scan}); relative "
          f"{abs(implicit / scan - 1):.3g} (rtol {SCAN_RTOL})")
    if k4 != (1, 1) or after_scan != (1, 1):
        raise SystemExit("chip_smoke: want K3 and K4 once for the implicit gradient and never "
                         "in scan mode")
    if not abs(implicit - scan) <= SCAN_RTOL * abs(scan):
        raise SystemExit("chip_smoke: K4's gradient is off the scan oracle's")

    # -- RenderTimer and ray accounting at 1080p (device_trace: phase 5)
    cfg = rtt.RenderConfig(xres=W, yres=H)
    for _ in range(3):
        rtt.render_color(scene, cfg)
    with RenderTimer(W, H, emit=False) as timer:
        rtt.render_color(scene, cfg)
    rays = int(count_traced_rays(scene, cfg))
    print(f"RenderTimer, one {W}x{H} frame: {timer.seconds * 1e3:.3f} ms, "
          f"{timer.mrays_per_s:.1f} primary Mrays/s; count_traced_rays {rays} "
          f"({rays / (W * H):.3f} a pixel), {rays / timer.seconds / 1e6:.1f} traced Mrays/s")

    # -- the two PNG encoders on a 1080p frame
    frame = rtt.render_u8(scene, cfg)
    if native.native_available():
        times = {}
        for name, fn in (("native", native.encode_png_native), ("stdlib", encode_png_stdlib)):
            fn(frame)
            t0 = time.perf_counter()
            for _ in range(5):
                data = fn(frame)
            times[name] = ((time.perf_counter() - t0) * 1e3 / 5, len(data))
            if not np.array_equal(decode_png(data), frame):
                raise SystemExit(f"chip_smoke: the {name} PNG does not decode to the frame")
        print(f"PNG encode {W}x{H}: native {times['native'][0]:.1f} ms ({times['native'][1]} "
              f"bytes), stdlib zlib {times['stdlib'][0]:.1f} ms ({times['stdlib'][1]} bytes); "
              "both decode to the frame bit for bit")
    else:
        print(f"PNG encode: the native library does not build here: {native.build_error()}")


# Phase 7, the multi-device layer: the 2x2 meshes' last cell at the trace and
# march main paths' shapes (the windows' timed, bounded and plain-checked
# shape), a ragged window of a 320x240 frame, and 4K in bands of 270 rows
# (2160 = 8 x 270; 256, the default, does not divide it)
CELL = (H // 2, W // 2, H // 2, W // 2)  # (row0, col0, h, w)
MCELL = (MH // 2, MW // 2, MH // 2, MW // 2)
SMALL_WINDOW = (37, 51, 150, 203)
UHD_W, UHD_H, UHD_BAND = 3840, 2160, 270

# Two ranks of the multi-process render on the one card: each joins a gloo
# group from torchrun's variables, renders its half of a 2x1 global mesh at
# 1920x1080 through K1, and gathers the frame; it saves the frame to
# argv[1] and prints its launches (the first call, counted alone) and the
# host's clock of three more calls as its last line.
RANK_CHILD = """
import json, sys, time
import numpy as np
import torch
import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.parallel import multihost

assert multihost.init_distributed(backend="gloo") is True
scene, _ = rtt.default_scene()
cfg = rtt.RenderConfig(xres=1920, yres=1080)
mesh = multihost.global_mesh()
kt.LAUNCHES = 0
img = multihost.render_multihost(scene, cfg, mesh)
launches = kt.LAUNCHES
times = []
for _ in range(3):
    torch.distributed.barrier()
    t0 = time.perf_counter()
    multihost.render_multihost(scene, cfg, mesh)
    times.append((time.perf_counter() - t0) * 1e3)
np.save(sys.argv[1], img)
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ray_rust_tpu."))]
print(json.dumps({"rank": torch.distributed.get_rank(), "launches": launches,
                  "cells": len(mesh.local_cells()), "ms": times, "jax": bad}))
torch.distributed.destroy_process_group()
"""


def two_ranks(ref):
    """Two processes of ``RANK_CHILD`` on the card over gloo; each rank's
    gathered frame must be ``ref`` bit for bit. Returns the wall time from
    the start of both to the end of both (s) and each rank's report."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, os.path.join(d, f"{rank}.npy")], cwd=HERE,
            env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                     RANK=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        reports = []
        for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise SystemExit(f"chip_smoke: rank {rank} failed (rc {p.returncode}):\n{err}")
            reports.append(json.loads(out.strip().splitlines()[-1]))
            got = np.load(os.path.join(d, f"{rank}.npy"))
            if not np.array_equal(got, ref):
                raise SystemExit(f"chip_smoke: rank {rank}'s frame is not the single-process "
                                 f"one: {int((got != ref).any(-1).sum())} pixels differ")
    for r in reports:
        if r["launches"] != 1 or r["cells"] != 1 or r["jax"]:
            raise SystemExit(f"chip_smoke: a rank did not render its cell with one K1 launch "
                             f"or imported JAX: {r}")
    return wall, reports


def multi_device(torch, rtt, kt, km, card, scenes, window_plain, march_small_plain, ops):
    """Phase 7: the multi-device layer on the one card (``parallel/``).
    ``scenes``: the default scene, the Nearest textured one and
    configuration 4's 101 objects, on the card; ``window_plain``: phase 2's
    plain marches of the 2x2 mesh's cell at 1280x720 and of SMALL_WINDOW at
    320x240 (phase 8's, rendered from the packed tables under autograd),
    each with its ms; ``march_small_plain`` phase 2's whole
    320x240 plain march; ``ops`` the counting builds' futures. Returns the
    figures of the windows' kernel lines. Raises SystemExit on any
    failure."""
    from ray_rust_tpu_torch.parallel import make_mesh, render_sharded, render_tiled_u8

    dev = torch.device("cuda", 0)
    default, textured, conf4 = scenes
    cfg_main, cfg_march = rtt.RenderConfig(xres=W, yres=H), rtt.RenderConfig(
        xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0)
    cfg_uhd = rtt.RenderConfig(xres=UHD_W, yres=UHD_H)
    mesh22 = make_mesh([dev] * 4, dp=2, sp=2)
    mesh31 = make_mesh([dev] * 3, dp=3, sp=1)
    cases = [("2x2 trace default", mesh22, default, cfg_main),
             ("2x2 trace bar.png Nearest", mesh22, textured, cfg_main),
             ("2x2 trace 101 objects (K1b)", mesh22, conf4, cfg_main),
             ("2x2 march + glow", mesh22, default, cfg_march),
             ("3x1 trace default", mesh31, default, cfg_main),
             ("3x1 march + glow", mesh31, default, cfg_march)]
    # the main path, the counts set to 0 just before it and read just after:
    # each mesh cell launches K1 (K3) on its window, each 4K band K1 on the
    # one card's 1x1 mesh (make_mesh's default: every CUDA device)
    kt.LAUNCHES = kt.CULL_LAUNCHES = km.LAUNCHES = 0
    with torch.no_grad():
        got = [render_sharded(scene, cfg, mesh) for _, mesh, scene, cfg in cases]
        t0 = time.perf_counter()
        uhd = render_tiled_u8(default, cfg_uhd, make_mesh(), rows_per_tile=UHD_BAND)
        uhd_first_s = time.perf_counter() - t0
    launches = {"trace_fwd": kt.LAUNCHES, "trace_fwd_cull": kt.CULL_LAUNCHES,
                "march_fwd": km.LAUNCHES}
    want = {"trace_fwd": 4 * 3 + 3 + UHD_H // UHD_BAND, "trace_fwd_cull": 4, "march_fwd": 4 + 3}
    print(f"  main path (2x2 and 3x1 meshes of cuda:0, 4K in {UHD_H // UHD_BAND} bands): "
          f"launches {launches}, expected {want}")
    if launches != want:
        raise SystemExit(f"chip_smoke: the multi-device path launched {launches}, not {want}")

    # each stitched frame the whole-frame launch's bit for bit
    with torch.no_grad():
        for (name, _, scene, cfg), col in zip(cases, got):
            ref, mine = img(rtt.render_color(scene, cfg)), img(col)
            off = int((ref != mine).any(-1).sum())
            print(f"  {name} {cfg.xres}x{cfg.yres}: {off} pixels off the whole-frame launch")
            if off:
                raise SystemExit(f"chip_smoke: {name} is not the whole-frame launch")
        uhd_ref = rtt.to_u8(rtt.render_color(default, cfg_uhd)).cpu().numpy()
    if not np.array_equal(uhd, uhd_ref):
        raise SystemExit("chip_smoke: the banded 4K frame is not the whole-frame launch's")
    print(f"  4K {UHD_W}x{UHD_H} in bands of {UHD_BAND}: bit-equal to one whole-frame launch's "
          f"to_u8 (first call {uhd_first_s:.2f} s)")

    # the windows against their plain versions: the 320x240 cells of both
    # meshes and a ragged window, the 1080p cell, within the golden budget
    errs = {"trace_fwd": [], "march_fwd": []}
    small = rtt.RenderConfig(xres=320, yres=240)
    small_march = small.with_(use_raymarching=True, glow_effect=1.0)
    with torch.no_grad():
        for win in ((120, 160, 120, 160), (80, 0, 80, 320), SMALL_WINDOW):
            k = img(rtt.render_color(default, small, win[:2], win[2:]))
            p = img(kt.render_color_plain(default, small, win[:2], win[2:]))
            errs["trace_fwd"].append(compare(f"K1 window {win} of 320x240 vs plain", p, k))
        k = img(rtt.render_color(default, cfg_main, CELL[:2], CELL[2:]))
        p, trace_plain_ms = event_ms(torch, lambda: kt.render_color_plain(default, cfg_main,
                                                                          CELL[:2], CELL[2:]))
        p = img(p)
        errs["trace_fwd"].append(compare(f"K1 window {CELL} of {W}x{H} vs plain", p, k))
        for key, cfg, win in (("small", small_march, SMALL_WINDOW), ("cell", cfg_march, MCELL)):
            k = img(rtt.render_color(default, cfg, win[:2], win[2:]))
            errs["march_fwd"].append(compare(
                f"K3 window {win} of {cfg.xres}x{cfg.yres} vs plain", window_plain[key][0], k))
    r0, c0, h, w = SMALL_WINDOW
    if not np.array_equal(window_plain["small"][0], march_small_plain[r0:r0 + h, c0:c0 + w]):
        raise SystemExit("chip_smoke: the windowed plain march is not the whole frame's crop")
    print("  the windowed plain march at 320x240 is the whole plain frame's crop bit for bit")

    # times by events (3 warm-ups, 10 frames): the whole frame, the meshes,
    # the 2x2 mesh's cell alone; 4K whole and banded (and by the host's clock)
    times = {}
    with torch.no_grad():
        for tag, cfg, cell in (("trace", cfg_main, CELL), ("march", cfg_march, MCELL)):
            times[tag] = {
                "whole": cuda_ms(torch, lambda cfg=cfg: rtt.render_color(default, cfg)),
                "2x2": cuda_ms(torch, lambda cfg=cfg: render_sharded(default, cfg, mesh22)),
                "3x1": cuda_ms(torch, lambda cfg=cfg: render_sharded(default, cfg, mesh31)),
                "cell": cuda_ms(torch, lambda cfg=cfg, cell=cell: rtt.render_color(
                    default, cfg, cell[:2], cell[2:]))}
            print(f"  {tag} {cfg.xres}x{cfg.yres} ({card}), ms by events: " + ", ".join(
                f"{k} {v:.4f}" for k, v in times[tag].items()))
        uhd_mesh = make_mesh()
        times["uhd_whole"] = cuda_ms(torch, lambda: rtt.render_color(default, cfg_uhd))
        times["uhd_whole_u8"] = cuda_ms(torch, lambda: rtt.render_u8(default, cfg_uhd))
        band = lambda: render_tiled_u8(default, cfg_uhd, uhd_mesh, rows_per_tile=UHD_BAND)
        times["uhd_banded"] = cuda_ms(torch, band)
        times["uhd_banded_host"] = host_ms(torch, band, reps=10)
    print(f"  4K {UHD_W}x{UHD_H} ({card}), ms: K1 whole frame by events "
          f"{times['uhd_whole']:.4f}, render_u8 whole {times['uhd_whole_u8']:.3f}, "
          f"render_tiled_u8 in {UHD_H // UHD_BAND} bands by events {times['uhd_banded']:.3f}, "
          f"by the host's clock {times['uhd_banded_host']:.3f}")

    # two ranks on the one card over gloo, each bit-equal to the one-process frame
    with torch.no_grad():
        ref = img(rtt.render_color(default, cfg_main))
    wall, reports = two_ranks(ref)
    print(f"  two ranks over gloo at {W}x{H} ({card}): both frames bit-equal to the "
          f"single-process K1 frame; wall {wall:.2f} s from start to exit; render_multihost by "
          f"the host's clock " + "; ".join(
              f"rank {r['rank']} " + ", ".join(f"{t:.1f}" for t in r["ms"]) + " ms"
              for r in reports))

    bounds = {}
    for name, scene, cfg, cell in (("trace_fwd", default, cfg_main, CELL),
                                   ("march_fwd", default, cfg_march, MCELL)):
        n_ops = ops[f"{name}_window"].result()[0]
        bounds[name] = roofline(n_ops, io_bytes(scene, cfg, cell[2] * cell[3]))
        print(f"  bound, {name} window {cell} of {cfg.xres}x{cfg.yres}: {n_ops} f32 operations "
              f"-> {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return {"launches": launches, "max_abs_err": {k: max(v) for k, v in errs.items()},
            "ms": {"trace_fwd": times["trace"]["cell"], "march_fwd": times["march"]["cell"]},
            "plain_ms": {"trace_fwd": trace_plain_ms, "march_fwd": window_plain["cell"][1]},
            "bounds": bounds, "times": times, "ranks_wall_s": wall}


# Phase 8, the multi-device layer's gradient half: K2 and K4 on phase 7's
# cells and on its ragged window, and the sharded training steps.
# Two ranks on the one card over gloo, and one over NCCL (a group of one,
# where the all-reduce is the identity), each runs the SGD step on the
# material colours over the global mesh (argv: the output file, the
# backend, the learning rate, the width and the height); each saves its
# trained leaves to argv[1] and prints its launches (the first step,
# counted alone), its loss and the host's clock of three more steps as its
# last line.
GRAD_RANK_CHILD = """
import json, sys, time
import numpy as np
import torch
import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.parallel import multihost, sgd_train_step

assert multihost.init_distributed(backend=sys.argv[2], timeout=300) is True
scene, _ = rtt.default_scene(device=multihost.local_device())
cfg = rtt.RenderConfig(xres=int(sys.argv[4]), yres=int(sys.argv[5]))
m = scene.materials
red = m.diffuse.r.clone()
red[2] += 0.1
with torch.no_grad():
    target = rtt.render_color(scene._replace(materials=m._replace(
        diffuse=m.diffuse._replace(r=red))), cfg).to_array()
colours = lambda c: type(c)(*(t.detach().clone().requires_grad_() for t in c))
s = scene._replace(materials=m._replace(diffuse=colours(m.diffuse), specular=colours(m.specular)))
mesh = multihost.global_mesh()
kt.LAUNCHES = kb.LAUNCHES = 0
new, loss = sgd_train_step(s, cfg, target, lr=float(sys.argv[3]), mesh=mesh)
torch.cuda.synchronize()
launches = [kt.LAUNCHES, kb.LAUNCHES]
times = []
for _ in range(3):
    torch.distributed.barrier()
    t0 = time.perf_counter()
    sgd_train_step(s, cfg, target, lr=float(sys.argv[3]), mesh=mesh)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
nm = new.materials
np.save(sys.argv[1], torch.stack([*nm.diffuse, *nm.specular]).detach().cpu().numpy())
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ray_rust_tpu."))]
print(json.dumps({"rank": torch.distributed.get_rank(), "backend": sys.argv[2],
                  "world": torch.distributed.get_world_size(), "launches": launches,
                  "cells": len(mesh.local_cells()), "loss": float(loss), "ms": times,
                  "jax": bad}))
torch.distributed.destroy_process_group()
"""


def grad_ranks(torch, lr, w, h):
    """Two GRAD_RANK_CHILD ranks over gloo and one over NCCL on the card,
    all started together, each taking the step at ``w`` x ``h``: each
    rank's trained leaves and report, and the wall time from the start of
    all three to the end of all three (s). Raises SystemExit if a rank
    fails."""
    import socket

    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    groups = (("gloo", 2, ports[0]), ("nccl", 1, ports[1]))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        procs = [(backend, rank, os.path.join(d, f"{backend}{rank}.npy"), subprocess.Popen(
            [sys.executable, "-c", GRAD_RANK_CHILD, os.path.join(d, f"{backend}{rank}.npy"),
             backend, str(lr), str(w), str(h)], cwd=HERE,
            env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for backend, world, port in groups for rank in range(world)]
        try:
            outs = [p.communicate(timeout=400) for *_, p in procs]
        finally:
            for *_, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        got = []
        for (backend, rank, path, p), (out, err) in zip(procs, outs):
            if p.returncode != 0:
                raise SystemExit(f"chip_smoke: {backend} rank {rank} failed (rc {p.returncode}):"
                                 f"\n{err}")
            got.append((np.load(path), json.loads(out.strip().splitlines()[-1])))
    return got, wall


def sharded_grad(torch, rtt, card, scenes, grad_plain, ops):
    """Phase 8: the multi-device layer's gradient half on the one card
    (``parallel/train.py``, K2 and K4 with a window). ``scenes``: the
    default scene and the Nearest textured one on the card; ``grad_plain``:
    phase 2's plain images of SMALL_WINDOW of 320x240 and of the main
    paths' 2x2 cells, trace and march + glow, with their pull-backs
    (``kernel_trace_bwd.plain_vjp``) and ms;
    ``ops`` the counting builds' futures. Returns the figures of the
    windows' kernel lines. Raises SystemExit on any failure."""
    from ray_rust_tpu_torch import cli
    from ray_rust_tpu_torch.entry import entry
    from ray_rust_tpu_torch.examples import inverse_rendering as example
    from ray_rust_tpu_torch.models.scene import leaf_paths
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_pack as kp
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.parallel import (
        SceneAdam,
        TrainState,
        dryrun,
        format_report,
        make_mesh,
        make_train_step,
        measure_scaling,
        sgd_train_step,
    )
    from ray_rust_tpu_torch.utils.image import load_png

    dev = torch.device("cuda", 0)
    default, textured = scenes
    cfg_main = rtt.RenderConfig(xres=W, yres=H)
    cfg_march = rtt.RenderConfig(xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0)
    cfg_uhd = rtt.RenderConfig(xres=UHD_W, yres=UHD_H)
    mesh22 = make_mesh([dev] * 4, dp=2, sp=2)
    mesh31 = make_mesh([dev] * 3, dp=3, sp=1)

    def planes(shape, seed):
        rng = np.random.default_rng(seed)
        return rtt.Color(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                           .to(dev) for _ in range(3)))

    def flat(tables):
        return torch.cat([t.reshape(-1) for t in tables]).detach().double().cpu().numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    # -- K2 and K4 on a mesh cell against the whole frame with the cotangent
    # zero outside it (each launch at its own fixed-point scale:
    # REGIME_REL_L2), the primal K1's (K3's) window bit for bit
    errs = {"trace_bwd": [], "march_bwd": []}
    cell_g = {}
    print("  K2 and K4 on a cell against the whole frame (cotangent zero outside the cell), "
          "the primal against K1's (K3's) window:")
    for key, bwd, fwd, scene, cfg, win, what in (
            ("trace_bwd", kb, kt, default, cfg_main, CELL, "untextured"),
            ("trace_bwd", kb, kt, textured, cfg_main, CELL, "bar.png Nearest"),
            ("march_bwd", kmb, km, default, cfg_march, MCELL, "untextured"),
            ("march_bwd", kmb, km, textured, cfg_march, MCELL, "bar.png Nearest")):
        r0, c0, h, w = win
        g = planes((h, w), 7)
        cell_g.setdefault(key, g)
        full = [torch.zeros((cfg.yres, cfg.xres), device=dev) for _ in range(3)]
        for plane, part in zip(full, g):
            plane[r0:r0 + h, c0:c0 + w] = part
        got, prim = bwd.render_grads_kernel(scene, cfg, g, return_primal=True,
                                            origin=win[:2], shape=win[2:])
        e = rel(flat(got), flat(bwd.render_grads_kernel(scene, cfg, rtt.Color(*full))))
        with torch.no_grad():
            same = np.array_equal(img(prim), img(fwd.render_color_kernel(scene, cfg, win[:2],
                                                                         win[2:])))
        ok = e <= REGIME_REL_L2 and same
        print(f"    {key} {what}, cell {win} of {cfg.xres}x{cfg.yres}: block relative L2 "
              f"{e:.3g} ({REGIME_REL_L2}), primal bit-equal {same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: windowed {key} ({what}) is not the whole frame's")
        errs[key].append(e)

    # -- the ragged window and the main paths' cells against plain autograd
    # of the windowed plain version (phase 2's graphs), the march under its
    # contract; a cell's plain forward and backward is its kernel line's
    # plain_ms
    plain_ms = {}
    small = rtt.RenderConfig(xres=320, yres=240)
    for key, bwd, fwd, cfg, win, budget in (
            ("trace", kb, kt, small, SMALL_WINDOW, GRAD_BUDGET),
            ("march", kmb, km, small.with_(use_raymarching=True, glow_effect=1.0), SMALL_WINDOW,
             MARCH_GRAD_BUDGET),
            ("trace cell", kb, kt, cfg_main, CELL, GRAD_BUDGET),
            ("march cell", kmb, km, cfg_march, MCELL, MARCH_GRAD_BUDGET)):
        plain_img, vjp, fwd_ms = grad_plain.pop(key)  # the graph goes with its last use
        name = f"{key[:5]}_bwd"
        g = planes(win[2:], 8) if win == SMALL_WINDOW else cell_g[name]
        with torch.no_grad():
            k_img = img(fwd.render_color_kernel(default, cfg, win[:2], win[2:]))
        note = ""
        if key.startswith("march"):  # tests/test_pallas_bwd.py:29-72,306-321
            agree = np.abs(k_img - plain_img).max(-1) < 1e-4
            off = off_boundary(plain_img, ~agree)
            note = (f", forwards agree on {agree.mean():.4%} of pixels, {int((~agree).sum())} "
                    f"masked, {off} off a decision boundary")
            if not agree.mean() > 0.9 or off:
                raise SystemExit(f"chip_smoke: the windowed march forwards disagree off the "
                                 f"boundaries on {win}")
            g = rtt.Color(*(c * torch.from_numpy(agree).to(dev) for c in g))
        got, prim = bwd.render_grads_kernel(default, cfg, g, return_primal=True,
                                            origin=win[:2], shape=win[2:])
        want, bwd_ms = event_ms(torch, lambda: vjp(g))
        if win != SMALL_WINDOW:
            plain_ms[name] = fwd_ms + bwd_ms
        worst, leaf = leaf_err(f"windowed {key} backward", default, got, want)
        same = np.array_equal(img(prim), k_img)
        ok = worst <= budget and same
        print(f"  {bwd.__name__.rsplit('.', 1)[1]} on window {win} of {cfg.xres}x{cfg.yres} vs "
              f"plain autograd of the windowed plain version{note}: largest leaf relative L2 "
              f"{worst:.3g} ({leaf}; budget {budget}), primal bit-equal to the kernel's window "
              f"{same}; plain {fwd_ms:.1f} ms forward (phase 2) + {bwd_ms:.1f} ms backward -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the windowed {key} backward is off its plain version")
        errs[name].append(worst)

    # -- the main path: sharded steps through the public entry points, the
    # counts set to 0 just before it and read just after
    m = default.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    redder = default._replace(materials=m._replace(diffuse=m.diffuse._replace(r=red)))
    with torch.no_grad():
        targets = {c: rtt.render_color(redder, c).to_array() for c in (cfg_main, cfg_march,
                                                                         cfg_uhd)}
        adam_target = rtt.render_color(default, cfg_main).to_array()

    def colours(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    start = default._replace(materials=m._replace(diffuse=colours(m.diffuse),
                                                  specular=colours(m.specular)))
    sgd_cases = [("1080p 2x2", cfg_main, mesh22, TRAIN_LR),
                 ("1080p 3x1", cfg_main, mesh31, TRAIN_LR),
                 ("720p march + glow 2x2", cfg_march, mesh22, MARCH_TRAIN_LR),
                 ("4K 2x2", cfg_uhd, mesh22, TRAIN_LR)]
    opt = SceneAdam(0.5)  # the example's default learning rate
    adam_scenes = [example.perturbed(default) for _ in range(2)]
    adam_states = [TrainState(s, opt.init(s)) for s in adam_scenes]
    kt.LAUNCHES = kb.LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = kp.LAUNCHES = kp.VJP_LAUNCHES = 0
    sharded = [sgd_train_step(start, cfg, targets[cfg], lr=lr, mesh=mesh)
               for _, cfg, mesh, lr in sgd_cases]
    _, adam_loss = make_train_step(cfg_main, opt, mesh=mesh22)(adam_states[0], adam_target)
    torch.cuda.synchronize()
    launches = {"trace_fwd": kt.LAUNCHES, "trace_bwd": kb.LAUNCHES, "march_fwd": km.LAUNCHES,
                "march_bwd": kmb.LAUNCHES, "pack": kp.LAUNCHES, "pull_back": kp.VJP_LAUNCHES}
    want = {"trace_fwd": 4 + 3 + 4 + 4, "trace_bwd": 15, "march_fwd": 4, "march_bwd": 4,
            "pack": 19, "pull_back": 19}
    print(f"  main path (SGD steps on the material colours: 1080p on 2x2 and 3x1 meshes of "
          f"cuda:0, 720p march + glow and 4K on 2x2; the example's Adam step at 1080p on 2x2): "
          f"launches {launches}, expected {want}")
    if launches != want:
        raise SystemExit(f"chip_smoke: the sharded steps launched {launches}, not {want}")

    # each against the whole-frame step: the loss within 1e-6 relative, the
    # trained leaves' step within REGIME_REL_L2
    trained = lambda s: flat([*s.materials.diffuse, *s.materials.specular])  # noqa: E731
    before = trained(start)
    whole = {}
    for (name, cfg, mesh, lr), (new, loss) in zip(sgd_cases, sharded):
        if cfg not in whole:
            whole[cfg] = sgd_train_step(start, cfg, targets[cfg], lr=lr)
        w_new, w_loss = whole[cfg]
        loss_rel = abs(float(loss) / float(w_loss) - 1)
        step_rel = rel(trained(new) - before, trained(w_new) - before)
        ok = loss_rel <= 1e-6 and step_rel <= REGIME_REL_L2
        print(f"  SGD {name} vs the whole frame: loss {float(loss):.8g} ({loss_rel:.3g} "
              f"relative), the colours' step within relative L2 {step_rel:.3g} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the sharded step {name} is not the whole frame's")
    _, w_adam_loss = make_train_step(cfg_main, opt)(adam_states[1], adam_target)
    adam = adam_states[1].opt_state
    moments = {id(p): adam.state[p]["exp_avg"] for p in adam.param_groups[0]["params"]}
    worst = 0.0
    for path, a, b in zip(leaf_paths(adam_scenes[0]), adam_scenes[0].tensors(),
                          adam_scenes[1].tensors()):
        d = np.abs(a.detach().cpu().numpy().astype(np.float64) - b.detach().cpu().numpy())
        if path not in opt.trained:
            if d.max(initial=0.0) != 0:
                raise SystemExit(f"chip_smoke: the sharded Adam step moved the frozen {path}")
            continue
        noise = np.abs(moments[id(b)].cpu().numpy() / 0.1) < NOISE_MOMENT
        worst = max(worst, float(d[~noise].max(initial=0.0)))
        if d[~noise].max(initial=0.0) > STEP_ATOL or d[noise].max(initial=0.0) > opt.lr:
            raise SystemExit(f"chip_smoke: the sharded Adam step moved {path} apart: {d.max()}")
    adam_rel = abs(float(adam_loss) / float(w_adam_loss) - 1)
    print(f"  Adam (make_train_step + SceneAdam) 1080p 2x2 vs the whole frame: loss "
          f"{adam_rel:.3g} relative, trained leaves with a gradient within {worst:.3g} "
          f"({STEP_ATOL}), frozen leaves bit-equal")
    if adam_rel > 1e-6:
        raise SystemExit("chip_smoke: the sharded Adam step's loss is not the whole frame's")
    # the sharded steps on the 2x2 mesh again from the same state: bit for bit
    torch.use_deterministic_algorithms(True)
    try:
        for k, (name, cfg, mesh, lr) in enumerate(sgd_cases):
            if mesh is not mesh22:
                continue
            new, loss = sgd_train_step(start, cfg, targets[cfg], lr=lr, mesh=mesh)
            same = float(loss) == float(sharded[k][1]) and np.array_equal(
                trained(new), trained(sharded[k][0]))
            print(f"  SGD {name} again from the same state: loss and colours bit-equal -> "
                  f"{'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"chip_smoke: the sharded step {name} does not repeat itself")
    finally:
        torch.use_deterministic_algorithms(False)

    # -- times by events (3 warm-ups, 10 steps): whole frame and 2x2 mesh
    times = {}
    for tag, cfg, lr in (("1080p", cfg_main, TRAIN_LR), ("720p march", cfg_march, MARCH_TRAIN_LR),
                         ("4K", cfg_uhd, TRAIN_LR)):
        times[tag] = {k: cuda_ms(torch, lambda cfg=cfg, lr=lr, mesh=mesh: sgd_train_step(
            start, cfg, targets[cfg], lr=lr, mesh=mesh)) for k, mesh in (("whole", None),
                                                                         ("2x2", mesh22))}
        print(f"  SGD step {tag} {cfg.xres}x{cfg.yres} ({card}), ms by events: whole "
              f"{times[tag]['whole']:.4f}, 2x2 {times[tag]['2x2']:.4f}")
    # the cells' K2 and K4 through the wrapper: with the image (the plain
    # version's function, the kernel line's ms and bound) and without it (the
    # backward of the main path's cell)
    cell_ms, cell_main_ms = {}, {}
    for name, bwd, cfg, win in (("trace_bwd", kb, cfg_main, CELL),
                                ("march_bwd", kmb, cfg_march, MCELL)):
        for out, primal in ((cell_ms, True), (cell_main_ms, False)):
            out[name] = cuda_ms(torch, lambda bwd=bwd, cfg=cfg, win=win, primal=primal:
                                bwd.render_grads_kernel(default, cfg, cell_g[name],
                                                        return_primal=primal, origin=win[:2],
                                                        shape=win[2:]))
        print(f"  {name} on the {cfg.xres}x{cfg.yres} cell {win} through the wrapper ({card}): "
              f"{cell_ms[name]:.4f} ms with the image, {cell_main_ms[name]:.4f} ms without "
              f"(the main path's call); plain forward and backward {plain_ms[name]:.1f} ms")

    # -- ranks: two over gloo and one over NCCL, each against the
    # single-process 1080p step
    w_new, w_loss = whole[cfg_main]
    ranks, wall = grad_ranks(torch, TRAIN_LR, W, H)
    for leaves, r in ranks:
        loss_rel = abs(r["loss"] / float(w_loss) - 1)
        step_rel = rel(leaves.astype(np.float64).ravel() - before, trained(w_new) - before)
        ok = (loss_rel <= 1e-6 and step_rel <= REGIME_REL_L2 and r["launches"] == [1, 1]
              and r["cells"] == 1 and not r["jax"])
        print(f"  {r['backend']} rank {r['rank']} of {r['world']}: launches (K1, K2) "
              f"{r['launches']}, loss {loss_rel:.3g} relative, step {step_rel:.3g}, later steps "
              + ", ".join(f"{t:.1f}" for t in r["ms"]) + f" ms by the host's clock -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: a rank's step is not the single-process one: {r}")
    print(f"  three ranks ({card}): wall {wall:.2f} s from start to exit")

    # -- scaling, the dry run, the entry, --no-pallas
    scaling = measure_scaling(devices=[dev])
    print(f"  measure_scaling(devices=[cuda:0]) ({card}):")
    for line in format_report(scaling).splitlines():
        print("    " + line)
    print(f"    {scaling}")
    dryrun.run(4)
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args).to_array()
    if tuple(out.shape) != (96, 128, 3) or not torch.isfinite(out).all():
        raise SystemExit(f"chip_smoke: entry() gave {tuple(out.shape)}")
    kt.LAUNCHES = kb.LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = kp.LAUNCHES = kp.VJP_LAUNCHES = 0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plain.png")
        rc = cli.main(["320", "240", "-o", path, "--no-pallas"])
        png = load_png(path)
    plain_launches = (kt.LAUNCHES, kb.LAUNCHES, km.LAUNCHES, kmb.LAUNCHES, kp.LAUNCHES)
    want_png = rtt.render_u8(default, small.with_(use_pallas=False))
    print(f"  entry() 96x128, dryrun.run(4) on cuda:0 cells; the CLI 320x240 --no-pallas: exit "
          f"{rc}, launches (K1, K2, K3, K4, pack) {plain_launches}, PNG bit-equal to the plain "
          f"render_u8 {np.array_equal(png, want_png)}")
    if rc != 0 or any(plain_launches) or not np.array_equal(png, want_png):
        raise SystemExit("chip_smoke: --no-pallas launched a kernel or is not the plain image")

    # the cells' bounds, of the timed work with the image: the tables read,
    # the cotangent planes read, the primal planes and the block written
    bounds = {}
    for name, cfg, cell in (("trace_bwd", cfg_main, CELL), ("march_bwd", cfg_march, MCELL)):
        n_ops = ops[f"{name}_window"].result()[0]
        pixels = cell[2] * cell[3]
        nbytes = (io_bytes(default, cfg, pixels) + 3 * 4 * pixels
                  + 4 * (default.objects.count + 1) * kb.GRAD_COLS)
        bounds[name] = roofline(n_ops, nbytes)
        print(f"  bound, {name} window {cell} of {cfg.xres}x{cfg.yres}: {n_ops} f32 operations, "
              f"{nbytes} bytes -> {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return {"launches": launches, "max_abs_err": {k: max(v) for k, v in errs.items()},
            "ms": cell_ms, "main_ms": cell_main_ms, "plain_ms": plain_ms, "bounds": bounds,
            "times": times, "ranks_wall_s": wall}


# Phase 9, deep ray trees: the exact task-stack bound (K1, K2 and K5 take
# any max_reflections at the default unroll, their 64-task instances past
# a refraction cap of 17) and the buffer instances of K2 (past 192 sites)
# and K4 (past 35 laps). The checks' shapes, whose plain references phase
# 2 renders under the build (deep_plain):
DEEP_SMALL = (320, 240)  # K1 at 12 and 16 reflections, K5 at 8, against the plain version
DEEP_GRAD = (160, 120)  # K2 at 319 sites and K4 at 39 laps against plain autograd
DEEP_TINY = (64, 48)  # the 64-task instances of K2 and K5 (17 tasks)
# The bands the buffer instances' checks against plain autograd and their
# forced comparisons at the main paths' shapes run in (a record budget of
# a quarter of the frame's rows), beside one band.
DEEP_BANDS = 4
# The bands K2's buffer instance is timed in at 319 sites and 1080p: a 4
# GiB budget's 17, RECORD_BUDGET's 5, and 2.
SWEEP_BANDS = (17, 5, 2)


# Phase 9's launch past 2^32 fixed-point terms (csrc/fixed_sum.cuh: a
# second run takes a lo digit of 63 - n bits for a count of n bits): K2 on
# the box of planes at 3840x2160 (2^34 terms; at 1920x1080 it sums just
# under 2^32, and no K4 or K5 frame that tools/terms_probe.py runs reaches
# 2^31: PERF.md §6), held against the float64 sum of its blocks on
# windows of rows each under 2^32 terms, per scene leaf
TERMS_BOX = (3840, 2160)
TERMS_REL_L2 = 1e-4
# rt_fixed_stats's values (csrc/fixed_sum.cuh: last_fixed)
FIXED_STATS = ("first_scale", "scale", "runs", "log2_terms", "term_exp", "g_exp", "lo_bits")


def fixed_stats(lib):
    """The last launch's fixed-point scale, counts and split of CUDA
    library ``lib``; ``lo_bits`` is None for a library that gives six
    values (an older checkout, whose lo digit is always 31 bits)."""
    import ctypes

    out = (ctypes.c_int * len(FIXED_STATS))(*([-1] * len(FIXED_STATS)))
    lib.rt_fixed_stats(out)
    got = dict(zip(FIXED_STATS, out))
    if got["lo_bits"] == -1:
        got["lo_bits"] = None
    return got


def past_terms(torch, rtt):
    """Phase 9's launch past 2^32 terms: K2 on the box of planes at
    TERMS_BOX through its wrapper on a seeded cotangent must run twice with
    a lo digit narrower than 31 bits, repeat bit for bit on a second
    launch, and lie within TERMS_REL_L2 per scene leaf of the float64 sum of
    its blocks on windows of whole rows (4, or twice as many until each
    window's count is under 2^32, so it sums at the 31-bit digit); K2 and
    K5 at 1920x1080 and K4 at 1280x720 on the default scene must run once
    at the 31-bit digit. Returns the box's ms (one launch, both runs), its
    band launches, its stats, the windows and the relative L2."""
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr

    t0 = time.time()
    dev = torch.device("cuda", 0)

    def planes(cfg, seed):
        rng = np.random.default_rng(seed)
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                            .astype(np.float32)).to(dev) for _ in range(3)))

    default = rtt.default_scene()[0]
    for name, fn, lib, cfg in (
            ("K2", kb.render_grads_kernel, "trace_bwd", rtt.RenderConfig(xres=W, yres=H)),
            ("K5", kr.render_grads_retrace, "trace_retrace", rtt.RenderConfig(xres=W, yres=H)),
            ("K4", kmb.render_grads_kernel, "march_bwd",
             rtt.RenderConfig(xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0))):
        fn(default, cfg, planes(cfg, 21))
        st = fixed_stats(_build.load_cuda_library(lib))
        ok = st["runs"] == 1 and st["lo_bits"] == 31
        print(f"  {name} {cfg.xres}x{cfg.yres}, default scene: fixed point {st} -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} at its main shape left the first run's digits")
    box = box_scene(rtt)
    cfg = rtt.RenderConfig(xres=TERMS_BOX[0], yres=TERMS_BOX[1], max_reflections=42)
    lib = _build.load_cuda_library("trace_bwd")
    g = planes(cfg, 22)
    launches = kb.BUF_LAUNCHES
    block, ms = event_ms(torch, lambda: kb.render_grads_kernel(box, cfg, g))
    launches = kb.BUF_LAUNCHES - launches
    st = fixed_stats(lib)
    again = kb.render_grads_kernel(box, cfg, g)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(block, again))
    del again
    nb = 4
    while True:
        windows, total = [], None
        for r0, h in partition(cfg.yres, nb):
            gw = rtt.Color(*(c[r0:r0 + h].contiguous() for c in g))
            part = kb.render_grads_kernel(box, cfg, gw, origin=(r0, 0), shape=(h, cfg.xres))
            windows.append(fixed_stats(lib))
            total = ([t.double() for t in part] if total is None
                     else [a + t.double() for a, t in zip(total, part)])
        if all(w["lo_bits"] == 31 for w in windows) or nb >= cfg.yres:
            break
        nb *= 2
    worst, leaf = leaf_err("K2 past 2^32 terms", box, block, [t.float() for t in total])
    first = all(w["lo_bits"] == 31 and w["log2_terms"] <= 32 for w in windows)
    ok = (st["runs"] == 2 and st["lo_bits"] < 31 and st["log2_terms"] > 32 and same and first
          and worst <= TERMS_REL_L2)
    print(f"  K2 past 2^32 terms, box of planes {cfg.xres}x{cfg.yres}: {ms:.1f} ms by events "
          f"in {launches} band(s), fixed point {st}; a second launch bit-equal {same}; against "
          f"the float64 sum of its {nb} row windows (log2 terms "
          f"{[w['log2_terms'] for w in windows]}, each at the 31-bit digit {first}): largest "
          f"leaf relative L2 {worst:.3g} ({leaf}, TERMS_REL_L2 {TERMS_REL_L2}) -> "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: K2 past 2^32 terms")
    del block, total
    torch.cuda.empty_cache()
    print(f"  past 2^32 terms: {time.time() - t0:.1f} s")
    return {"ms": ms, "launches": launches, "fixed": st, "windows": nb, "rel_l2": worst}


def opaque_scene(rtt):
    """A checkered floor and two mirror spheres, nothing transparent: no
    pixel pushes a refraction sub-trace, so its image and gradient are the
    same at any refraction cap, and the plain version at cap 0 checks the
    kernels' 64-task instances (17 tasks at a cap of 18) cheaply."""
    mats = [rtt.MaterialSpec(name="floor", diffuse=(0.8, 0.8, 0.8), pattern=1,
                             pattern_scale=40.0),
            rtt.MaterialSpec(name="mirror", diffuse=(0.1, 0.1, 0.3), specular=(0.7, 0.7, 0.7),
                             pn=16)]
    objs = [rtt.FloorSpec("floor", (0.0, -120.0, 0.0), (0.0, 1.0, 0.0), uvmap=2)] + [
        rtt.SphereSpec("mirror", 45.0, (x, -40.0, z)) for x, z in [(-50, 150), (50, 150)]]
    return rtt.build_scene(mats, objs, (0.0, 0.0, -150.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0))[0]


def box_scene(rtt):
    """Six transparent planes facing in, a box round the camera: every ray
    inside hits one, and one that leaves through a plane meets the sides'
    fronts, so a pixel's ray tree fills most of the static one (at 42
    reflections more than 192 of its 319 sites). Object 0, whose hit ends
    the bounce loop, is a small sphere out of reach."""
    mats = [rtt.MaterialSpec(name="dot", diffuse=(0.5, 0.5, 0.5)),
            rtt.MaterialSpec(name="glass", transparency=0.9, refraction=1.3,
                             diffuse=(0.1, 0.2, 0.1), specular=(0.95, 0.95, 0.95), pn=16,
                             pattern=1, pattern_scale=40.0)]
    objs = [rtt.SphereSpec("dot", 1.0, (0.0, 0.0, 5000.0))] + [
        rtt.FloorSpec("glass", tuple(-half * c for c in n), n)
        for half, axis in ((100.0, 0), (120.0, 1), (140.0, 2)) for sign in (1.0, -1.0)
        for n in [tuple(sign if k == axis else 0.0 for k in range(3))]]
    return rtt.build_scene(mats, objs, (10.0, 5.0, -20.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0))[0]


def glass_cluster(rtt):
    """Six overlapping glass spheres over a floor: a march lap below the
    refraction cap pushes a sub-march at nearly every hit, so a pixel runs
    all 39 laps of raymarch_max_reflections=7."""
    mats = [rtt.MaterialSpec(name="floor", diffuse=(0.8, 0.8, 0.8), pattern=1,
                             pattern_scale=40.0),
            rtt.MaterialSpec(name="glass", transparency=0.5, refraction=1.3,
                             diffuse=(0.1, 0.2, 0.1), specular=(0.6, 0.6, 0.6), pn=16)]
    objs = [rtt.FloorSpec("floor", (0.0, -120.0, 0.0), (0.0, 1.0, 0.0), uvmap=2)] + [
        rtt.SphereSpec("glass", 45.0, (x, y, z))
        for x, y, z in [(-50, -40, 150), (0, -40, 180), (50, -40, 150), (-25, 20, 170),
                        (25, 20, 170), (0, -60, 120)]]
    return rtt.build_scene(mats, objs, (0.0, 0.0, -150.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0))[0]


def deep_cases(rtt):
    """Phase 9's checks: name -> (scene, the kernels' cfg, the plain
    reference's cfg, whether the reference is a gradient)."""
    default, opaque = rtt.default_scene()[0], opaque_scene(rtt)
    trace = rtt.RenderConfig(xres=DEEP_SMALL[0], yres=DEEP_SMALL[1])
    deep17 = dict(max_reflections=17, max_refractions=18, refraction_unroll=None)
    k319 = rtt.RenderConfig(xres=DEEP_GRAD[0], yres=DEEP_GRAD[1], max_reflections=7,
                            refraction_unroll=None)
    # the step-by-step march at 2 000 steps, the kernels' floor tail off (its
    # plain reference runs as long as its longest lane's steps)
    k39 = rtt.RenderConfig(xres=DEEP_GRAD[0], yres=DEEP_GRAD[1], use_raymarching=True,
                           glow_effect=1.0, raymarch_max_reflections=7, march_max_iter=2000,
                           march_floor_skip=False)
    tiny = rtt.RenderConfig(xres=DEEP_TINY[0], yres=DEEP_TINY[1], **deep17)
    cases = {"K1 12 reflections": (default, trace.with_(max_reflections=12), False),
             "K1 16 reflections": (default, trace.with_(max_reflections=16), False),
             "K1 17 tasks, opaque": (opaque, trace.with_(**deep17), False),
             "K5 and K2 8 reflections": (default, trace.with_(max_reflections=8), True),
             "K2 319 sites": (default, k319, True),
             "K4 39 laps": (default, k39, True),
             "K5 and K2 17 tasks, opaque": (opaque, tiny, True)}
    return {name: (scene, cfg, cfg.with_(max_refractions=0) if scene is opaque else cfg, grad)
            for name, (scene, cfg, grad) in cases.items()}


def deep_plain(torch, rtt, kb, kt):
    """Phase 9's plain references, rendered in phase 2 under the build:
    name -> (image, vjp or None, ms by events); a gradient's graph is kept
    for one cotangent (``kernel_trace_bwd.plain_vjp``)."""
    out = {}
    for name, (scene, _, cfg, grad) in deep_cases(rtt).items():
        if grad:
            (image, vjp), ms = event_ms(torch, lambda s=scene, c=cfg: kb.plain_vjp(s, c))
        else:
            (image, vjp), ms = event_ms(
                torch, lambda s=scene, c=cfg: (kt.render_color_plain(s, c), None))
        out[name] = (img(image), vjp, ms)
    return out


def deep_trees(torch, rtt, cli, plain, ops):
    """Phase 9: deep ray trees on the card. The main path, with the launch
    counts set to 0 just before it and read just after: the CLI's ``-d`` on
    a scene file with ``max_reflections: 12`` at 1920x1080 (one K1 launch,
    its PNG ``render_u8`` of the file's scene); ``sgd_train_step`` on the
    material colours at 1920x1080 at 12 reflections (3 tasks: K1 and K2 at
    record cap 192), at 7 reflections and refraction_unroll=None (319
    sites: K2's buffer instance, in bands of rows) and at 1280x720 in march
    + glow at raymarch_max_reflections=7 (39 laps: K4's buffer instance).
    Then, against the plain references of phase 2 (``plain``): K1 at 12 and
    16 reflections and its 64-task instance (17 tasks, an opaque scene)
    within the golden budget; K5 and K2 at 8 reflections, K2 at 319 sites,
    K4 at 39 laps (also as the main path runs it: the floor tail on, the
    default step budget) and the 64-task instances of K2 and K5 against
    plain autograd per scene leaf (GRAD_BUDGET, MARCH_GRAD_BUDGET), their
    images the forward kernels' bit for bit, the cotangent masked where the
    kernel's image and the plain one differ (each such pixel on a decision
    boundary), the buffer instances in DEEP_BANDS bands; past the local
    caps, K2 at 319 sites in the box of planes against K5 and K4 at 39 laps
    on the glass cluster against one band, with the most sites or laps one
    pixel recorded; each buffer instance forced on the default
    config at the main paths' shapes against its local-record instance, in
    one band and in 4 or more (blocks within REGIME_REL_L2, images bit for
    bit); K2 at 319 sites at 1920x1080 in SWEEP_BANDS bands, the same block
    and image, timed in turns; times by events of K1 at 12 reflections at
    1920x1080, K2 at 319 sites at 1920x1080 and K4 at 39 laps at 1280x720,
    the forced buffer instances beside the local ones, and their bounds.
    Returns phase 9's entries of the kernels line."""
    from ray_rust_tpu_torch.models.serialize import deserialize_scene, serialize_scene
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_pack as kp
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
    from ray_rust_tpu_torch.parallel import sgd_train_step
    from ray_rust_tpu_torch.utils.image import load_png

    dev = torch.device("cuda", 0)
    default, meta = rtt.default_scene()
    cfg12 = rtt.RenderConfig(xres=W, yres=H, max_reflections=12)
    cfg319 = rtt.RenderConfig(xres=W, yres=H, max_reflections=7, refraction_unroll=None)
    cfg39 = rtt.RenderConfig(xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0,
                             raymarch_max_reflections=7)
    print(f"deep ray trees (the task stack: kernel_trace.stack_tasks; records: "
          f"kernel_trace_bwd.RECORD_BUDGET {kb.RECORD_BUDGET} bytes):")
    for name, cfg in (("12 reflections", cfg12), ("319 sites", cfg319)):
        print(f"  {name}: {kt.stack_tasks(cfg)} tasks, {kb.count_sites(cfg)} sites, record cap "
              f"{kb.site_cap(cfg)}, buffered {kb.buffered(cfg)}")
    print(f"  39 laps: {kmb.count_sites(cfg39)} laps, buffered {kmb.buffered(cfg39)}")
    bands = (len(kb.record_bands(H, W, 4 * kb.RECORD_WORDS * kb.site_cap(cfg319))),
             len(kb.record_bands(MH, MW, 4 * kmb.RECORD_WORDS * kmb.count_sites(cfg39))))

    # -- the main path: the counts set to 0 just before it, read just after
    m = default.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    redder = default._replace(materials=m._replace(diffuse=m.diffuse._replace(r=red)))
    with torch.no_grad():
        targets = {c: rtt.render_color(redder, c).to_array() for c in (cfg12, cfg319, cfg39)}

    def colours(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    start = default._replace(materials=m._replace(diffuse=colours(m.diffuse),
                                                  specular=colours(m.specular)))
    with tempfile.TemporaryDirectory() as sd:
        path, png_path = os.path.join(sd, "deep.yaml"), os.path.join(sd, "deep.png")
        text = serialize_scene(default, meta)
        with open(path, "w") as f:
            f.write(re.sub(r"(?m)^max_reflections: \d+$", "max_reflections: 12", text))
        kt.LAUNCHES = kb.LAUNCHES = kb.BUF_LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = 0
        kmb.BUF_LAUNCHES = kp.LAUNCHES = kp.VJP_LAUNCHES = 0
        t0 = time.time()
        rc = cli.main([str(W), str(H), "-d", path, "-o", png_path])
        losses = [float(sgd_train_step(start, cfg, targets[cfg], lr=lr)[1])
                  for cfg, lr in ((cfg12, TRAIN_LR), (cfg319, TRAIN_LR),
                                  (cfg39, MARCH_TRAIN_LR))]
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"trace_fwd": kt.LAUNCHES, "trace_bwd": kb.LAUNCHES,
                    "trace_bwd_buf": kb.BUF_LAUNCHES, "march_fwd": km.LAUNCHES,
                    "march_bwd": kmb.LAUNCHES, "march_bwd_buf": kmb.BUF_LAUNCHES,
                    "pack_scene": kp.LAUNCHES, "pack_scene_vjp": kp.VJP_LAUNCHES}
        with open(path) as f:
            loaded, _, caps = deserialize_scene(f.read())
        png = load_png(png_path)
    want = {"trace_fwd": 3, "trace_bwd": 1, "trace_bwd_buf": bands[0], "march_fwd": 1,
            "march_bwd": 0, "march_bwd_buf": bands[1], "pack_scene": 4, "pack_scene_vjp": 3}
    print(f"main path, deep trees: the CLI -d (max_reflections {caps['max_reflections']}) at "
          f"{W}x{H}, sgd_train_step at 12 reflections and at 319 sites ({W}x{H}) and at 39 "
          f"laps ({MW}x{MH} march + glow) in {wall:.2f} s; launches {launches}; losses "
          + ", ".join(f"{v:.6g}" for v in losses))
    if rc != 0 or launches != want or not np.isfinite(losses).all():
        raise SystemExit(f"chip_smoke: the deep main path: CLI exit {rc}, launches {launches} "
                         f"(want {want}), losses {losses}")
    if caps["max_reflections"] != 12 or not np.array_equal(
            png, rtt.render_u8(loaded, rtt.RenderConfig(xres=W, yres=H, **caps))):
        raise SystemExit("chip_smoke: the deep -d PNG is not render_u8 of the file's scene")

    # -- each deep instance against its plain version (phase 2's references);
    # the buffer instances in DEEP_BANDS bands, and how many records one
    # pixel wrote
    def record_words(mod, cfg):
        return (kb.RECORD_WORDS * kb.site_cap(cfg) if mod is kb
                else kmb.RECORD_WORDS * kmb.count_sites(cfg))

    def most_recorded(mod, scene, cfg):
        """The most sites (K2) or laps (K4) one pixel of ``cfg``'s frame
        recorded: a one-band launch of the buffer instance into a buffer
        filled with RECORD_FILL (``kernel_trace_bwd.recorded``)."""
        words = kp.launch_pack(scene)
        n = scene.objects.count
        ptrs, meta_ptr = kp.word_pointers(words, n)
        tex = kp.texture_pointers(scene, meta_ptr)
        cap_words, pixels = record_words(mod, cfg), cfg.xres * cfg.yres
        if mod is kb:
            lib = _build.load_cuda_library(kb.library("trace_bwd", n, kb.SHARED_TABLE_MAX))
            fn, cap, first = lib.rt_trace_bwd_buf, kb.site_cap(cfg), kb.SITE_WORDS
            args, extra = kb.kernel_args(cfg) + [cap] + tex, ()
        else:
            lib = _build.load_cuda_library("march_bwd_buf")
            fn, cap, first = lib.rt_march_bwd_buf, kmb.count_sites(cfg), kmb.LAP_WORDS
            args, extra = kmb.kernel_args(cfg) + tex, (cap,)
        buf = torch.full((pixels * cap_words,), kb.RECORD_FILL, dtype=torch.int32, device=dev)
        zero = rtt.Color(*(torch.zeros(cfg.yres, cfg.xres, device=dev) for _ in range(3)))
        kb.launch_buffered(lib, fn, ptrs, n, dev, cfg, args, zero, False, cap_words=cap_words,
                           extra=extra, budget=4 * pixels * cap_words, buf=buf)
        return int(kb.recorded(buf, cap, first, pixels).max())

    def banded(mod, cfg, fn):
        """``fn()`` with the record budget cut to a DEEP_BANDS-th of
        ``cfg``'s frame, and the buffer instance's launches it made."""
        saved, before = kb.RECORD_BUDGET, mod.BUF_LAUNCHES
        kb.RECORD_BUDGET = 4 * record_words(mod, cfg) * cfg.xres * -(-cfg.yres // DEEP_BANDS)
        try:
            out = fn()
        finally:
            kb.RECORD_BUDGET = saved
        return out, mod.BUF_LAUNCHES - before

    errs = {"trace_fwd_deep": [], "trace_bwd_buf": [], "march_bwd_buf": []}
    most = {}
    # K4's buffer instance as the main path runs it too (the floor tail on,
    # the default step budget), against the 2 000-step plain reference: the
    # pixels where either image differs from it (lanes past 2 000 steps, the
    # tail's knife edges) masked, each on a decision boundary
    cfg39s = cfg39.with_(xres=DEEP_GRAD[0], yres=DEEP_GRAD[1])
    also = {"K4 39 laps": [("the tail on, the default step budget", cfg39s)]}
    for name, (scene, cfg, _, grad) in deep_cases(rtt).items():
        ref, vjp, plain_ms = plain[name]
        march = cfg.use_raymarching
        fwd = km if march else kt
        got = img(fwd.render_color_kernel(scene, cfg))
        if not grad:
            errs["trace_fwd_deep"].append(compare(f"{name} {cfg.xres}x{cfg.yres} (plain "
                                                  f"{plain_ms:.1f} ms)", ref, got))
            continue
        runs = [("", cfg, got)] + [(label, c, img(fwd.render_color_kernel(scene, c)))
                                   for label, c in also.get(name, [])]
        agree = np.logical_and.reduce([np.abs(im - ref).max(-1) < 1e-4 for _, _, im in runs])
        flat = off_boundary(ref, ~agree)
        rng = np.random.default_rng(cfg.xres)
        g = rtt.Color(*(torch.from_numpy(rng.standard_normal(agree.shape).astype(np.float32)
                                         * agree).to(dev) for _ in range(3)))
        want_g = vjp(g)
        # the 319-site and 39-lap cases (the 64-task one's 196 607 sites
        # keep the default budget's bands)
        deep = name.startswith(("K2 319", "K4 39"))
        mods = [kmb] if march else [kb] + ([kr] if "K5" in name else [])
        for mod, (label, c, im) in [(m, r) for m in mods for r in runs]:
            bands = 0
            if mod is kr:
                out, prim = kr.render_grads_retrace(scene, c, g, return_primal=True)
            elif deep:
                (out, prim), bands = banded(mod, c, lambda m=mod, c=c: (
                    m.render_grads_kernel(scene, c, g, return_primal=True)))
            else:
                out, prim = mod.render_grads_kernel(scene, c, g, return_primal=True)
            worst, leaf = leaf_err(name, scene, out, want_g)
            same = float((img(prim) == im).all(-1).mean())
            budget = MARCH_GRAD_BUDGET if march else GRAD_BUDGET
            ok = (worst <= budget and same == 1.0 and agree.mean() > 0.9 and flat == 0
                  and bands == (DEEP_BANDS if deep and mod is not kr else 0))
            print(f"  {name}{', ' + label if label else ''} {c.xres}x{c.yres}, "
                  f"{mod.__name__.split('.')[-1]}" + (f" in {bands} bands" if bands else "")
                  + f": forwards agree on {agree.mean():.4%}, {flat} masked off a "
                  f"boundary; image the forward kernel's on {same:.4%}; largest leaf relative "
                  f"L2 {worst:.3g} ({leaf}); plain autograd {plain_ms:.1f} ms (phase 2) -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {name}: {mod.__name__} off plain autograd")
            if mod is not kr and mod.buffered(c):
                errs["march_bwd_buf" if march else "trace_bwd_buf"].append(worst)
            if deep and not label:
                most[name] = (most_recorded(mod, scene, c),
                              kb.SITE_CAPS[-1] if mod is kb else kmb.SITE_CAP)

    # -- past the local caps, where the default scene's pixels stop early:
    # K2 at 319 sites in the box of planes (42 reflections) in DEEP_BANDS
    # bands against K5 (forward-mode duals, held against plain autograd
    # above), K4 at 39 laps on the glass cluster in DEEP_BANDS bands against
    # one band; images the forward kernels' bit for bit (the host twins
    # against autograd on both scenes: tests/test_torch_deep.py)
    box, cluster = box_scene(rtt), glass_cluster(rtt)
    cfg_box = rtt.RenderConfig(xres=DEEP_GRAD[0], yres=DEEP_GRAD[1], max_reflections=42)
    cfg_cluster = cfg39s.with_(march_max_iter=2000, march_floor_skip=False)
    rng = np.random.default_rng(42)
    gd = rtt.Color(*(torch.from_numpy(rng.standard_normal((DEEP_GRAD[1], DEEP_GRAD[0]))
                                      .astype(np.float32)).to(dev) for _ in range(3)))
    got = img(kt.render_color_kernel(box, cfg_box))
    (out, prim), bands = banded(kb, cfg_box, lambda: kb.render_grads_kernel(
        box, cfg_box, gd, return_primal=True))
    want_g, prim5 = kr.render_grads_retrace(box, cfg_box, gd, return_primal=True)
    worst, leaf = leaf_err("K2 319 sites, box", box, out, want_g)
    same = float(((img(prim) == got) & (img(prim5) == got)).all(-1).mean())
    most["K2 319 sites, box"] = (most_recorded(kb, box, cfg_box), kb.SITE_CAPS[-1])
    ok = worst <= GRAD_BUDGET and same == 1.0 and bands == DEEP_BANDS
    print(f"  K2 319 sites, box of planes (42 reflections) {cfg_box.xres}x{cfg_box.yres} in "
          f"{bands} bands vs K5: images K1's on {same:.4%}; largest leaf relative L2 "
          f"{worst:.3g} ({leaf}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: K2 in the box of planes is off K5")
    errs["trace_bwd_buf"].append(worst)
    got = img(km.render_color_kernel(cluster, cfg_cluster))
    (out, prim), bands = banded(kmb, cfg_cluster, lambda: kmb.render_grads_kernel(
        cluster, cfg_cluster, gd, return_primal=True))
    one, prim1 = kmb.render_grads_kernel(cluster, cfg_cluster, gd, return_primal=True)
    rel = float((torch.cat([t.flatten() for t in out]) - torch.cat([t.flatten() for t in one]))
                .norm() / torch.cat([t.flatten() for t in one]).norm())
    same = float(((img(prim) == got) & (img(prim1) == got)).all(-1).mean())
    most["K4 39 laps, glass cluster"] = (most_recorded(kmb, cluster, cfg_cluster), kmb.SITE_CAP)
    ok = rel <= REGIME_REL_L2 and same == 1.0 and bands == DEEP_BANDS
    print(f"  K4 39 laps, glass cluster {cfg_cluster.xres}x{cfg_cluster.yres} in {bands} bands "
          f"vs one band: images K3's on {same:.4%}; cotangents within {rel:.3g} "
          f"(REGIME_REL_L2) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: K4 on the glass cluster depends on its bands")
    print("  the most records one pixel wrote (a one-band launch into a filled buffer): "
          + "; ".join(f"{k} {v} (local cap {c})" for k, (v, c) in most.items()))
    for key in ("K2 319 sites, box", "K4 39 laps, glass cluster"):
        if most[key][0] <= most[key][1]:
            raise SystemExit(f"chip_smoke: {key}: no pixel recorded past the local cap")
    plain_ms = {"trace_fwd_deep": None,
                "trace_bwd_buf": plain["K2 319 sites"][2],
                "march_bwd_buf": plain["K4 39 laps"][2]}
    for name, (image, _, ms) in list(plain.items()):  # the graphs are done with
        plain[name] = (image, None, ms)
    torch.cuda.empty_cache()

    # -- each buffer instance forced on the default config against its
    # local-record instance, at the main paths' shapes, in one band and in
    # DEEP_BANDS, and the times
    cfg_main = rtt.RenderConfig(xres=W, yres=H)
    cfg_march = rtt.RenderConfig(xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0)
    words = kp.launch_pack(default)
    n = default.objects.count
    ptrs, meta_ptr = kp.word_pointers(words, n)
    tex = kp.texture_pointers(default, meta_ptr)
    rng = np.random.default_rng(9)
    gt, gm = (rtt.Color(*(torch.from_numpy(rng.standard_normal((c.yres, c.xres))
                                           .astype(np.float32)).to(dev) for _ in range(3)))
              for c in (cfg_main, cfg_march))
    lib2, lib4 = _build.load_cuda_library("trace_bwd"), _build.load_cuda_library("march_bwd_buf")
    cap4 = kmb.count_sites(cfg_march)

    def quarter(cap_words, h, w):  # the budget of DEEP_BANDS bands
        return 4 * cap_words * w * -(-h // DEEP_BANDS)

    def buf2(cfg, g, budget=None):
        c = kb.site_cap(cfg)
        return kb.launch_buffered(lib2, lib2.rt_trace_bwd_buf, ptrs, n, dev, cfg,
                                  kb.kernel_args(cfg) + [c] + tex, g, True,
                                  cap_words=kb.RECORD_WORDS * c, budget=budget)

    def buf4(budget=None):
        return kb.launch_buffered(lib4, lib4.rt_march_bwd_buf, ptrs, n, dev, cfg_march,
                                  kmb.kernel_args(cfg_march) + tex, gm, True,
                                  cap_words=kmb.RECORD_WORDS * cap4, extra=(cap4,),
                                  budget=budget)

    forced = {
        "trace_bwd_buf": (lambda: kb.launch_words(default, words, cfg_main, gt, True),
                          lambda b=None: buf2(cfg_main, gt, b)),
        "march_bwd_buf": (lambda: kmb.launch_words(default, words, cfg_march, gm, True),
                          buf4)}
    small = {"trace_bwd_buf": quarter(kb.RECORD_WORDS * kb.site_cap(cfg_main), H, W),
             "march_bwd_buf": quarter(kmb.RECORD_WORDS * cap4, MH, MW)}
    forced_ms, forced_bands = {}, {}
    for key, (local, buffered) in forced.items():
        b_local, p_local = local()
        for budget in (None, small[key]):
            b_buf, p_buf, bands = buffered(budget)
            rel = float((b_buf - b_local).norm() / b_local.norm())
            same = bool(torch.equal(torch.stack(list(p_local)), torch.stack(list(p_buf))))
            print(f"  {key} forced on the default config in {bands} band(s): block within "
                  f"{rel:.3g} of the local records' (REGIME_REL_L2 {REGIME_REL_L2}), image "
                  f"bit-equal {same}")
            if rel > REGIME_REL_L2 or not same:
                raise SystemExit(f"chip_smoke: {key} forced is not its local-record instance")
            forced_bands[key] = bands
        if forced_bands[key] != DEEP_BANDS:
            raise SystemExit(f"chip_smoke: {key} forced ran in {forced_bands[key]} bands")
        forced_ms[key] = [cuda_ms(torch, f) for f in (
            local, buffered, lambda f=buffered, b=small[key]: f(b),
            lambda f=buffered, b=small[key]: f(b), buffered, local)]
        print(f"  {key} forced, ms in turns (local, buffer in 1 band, in "
              f"{forced_bands[key]} bands, in {forced_bands[key]} bands, in 1 band, local) "
              + ", ".join(f"{v:.4f}" for v in forced_ms[key]))

    # -- K2 at 319 sites and 1080p in SWEEP_BANDS bands: the same block and
    # image, and the time in turns
    cap_words = kb.RECORD_WORDS * kb.site_cap(cfg319)
    row_bytes = 4 * cap_words * W
    budgets = {nb: row_bytes * -(-H // nb) for nb in SWEEP_BANDS}
    sweep = {}
    for nb, budget in budgets.items():
        block, prim, bands = buf2(cfg319, gt, budget)
        if bands != nb:
            raise SystemExit(f"chip_smoke: K2 at 319 sites ran in {bands} bands, not {nb}")
        sweep[nb] = (block, prim)
    b0, p0 = sweep[SWEEP_BANDS[0]]
    for nb, (block, prim) in sweep.items():
        rel = float((block - b0).norm() / b0.norm())
        same = bool(torch.equal(torch.stack(list(p0)), torch.stack(list(prim))))
        print(f"  trace_bwd_buf at 319 sites {W}x{H} in {nb} bands: block within {rel:.3g} of "
              f"{SWEEP_BANDS[0]} bands' (REGIME_REL_L2), image bit-equal {same}")
        if rel > REGIME_REL_L2 or not same:
            raise SystemExit("chip_smoke: K2's buffer instance depends on its bands")
    del sweep, b0, p0
    order = list(SWEEP_BANDS) + list(reversed(SWEEP_BANDS))
    sweep_ms = [cuda_ms(torch, lambda b=budgets[nb]: buf2(cfg319, gt, b)) for nb in order]
    print(f"  trace_bwd_buf at 319 sites {W}x{H}, ms in turns by bands "
          + ", ".join(f"{nb}: {v:.4f}" for nb, v in zip(order, sweep_ms)))
    bands_ms = {str(nb): [v for b, v in zip(order, sweep_ms) if b == nb] for nb in SWEEP_BANDS}
    torch.cuda.empty_cache()

    with torch.no_grad():
        ms = {"trace_fwd_deep": cuda_ms(torch, lambda: kt.render_color_kernel(default, cfg12))}
        ref12, plain12_ms = event_ms(torch, lambda: kt.render_color_plain(default, cfg12))
    errs["trace_fwd_deep"].append(compare(f"K1 12 reflections {W}x{H}", img(ref12),
                                          img(kt.render_color_kernel(default, cfg12))))
    plain_ms["trace_fwd_deep"] = plain12_ms
    ms["trace_bwd_buf"] = cuda_ms(torch, lambda: kb.render_grads_kernel(
        default, cfg319, gt, return_primal=True))
    ms["march_bwd_buf"] = cuda_ms(torch, lambda: kmb.render_grads_kernel(
        default, cfg39, gm, return_primal=True))
    bounds = {}
    for key, cfg in (("trace_fwd_deep", cfg12), ("trace_bwd_buf", cfg319),
                     ("march_bwd_buf", cfg39)):
        n_ops = ops[key].result()[0]
        nbytes = io_bytes(default, cfg)
        if key != "trace_fwd_deep":  # + the cotangent planes read, the block written
            nbytes += 3 * 4 * cfg.xres * cfg.yres + 4 * (n + 1) * kb.GRAD_COLS
        bounds[key] = roofline(n_ops, nbytes)
        print(f"  {key} {cfg.xres}x{cfg.yres}: {ms[key]:.4f} ms by events with the image "
              f"(plain {plain_ms[key]:.1f} ms), bound {n_ops} f32 operations, {nbytes} bytes -> "
              f"{bounds[key][0]:.4f} ms ({bounds[key][1]})")
    terms = past_terms(torch, rtt)
    return [{
        "name": key, "route": "cuda", "source": f"ray_rust_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches[main_key],
        "max_abs_err": max(errs[key]),
        "ms": ms[key], "plain_ms": plain_ms[key], "plain_shape": plain_shape,
        "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None,
        **({"forced_ms": forced_ms[key], "forced_bands": forced_bands[key]}
           if key in forced_ms else {}),
        **({"bands_ms": bands_ms} if key == "trace_bwd_buf" else {}),
        **({"past_2_32_terms": terms} if key == "trace_bwd_buf" else {}),
    } for key, main_key, source, replaces, plain_shape in (
        ("trace_fwd_deep", "trace_fwd", "trace_fwd.cu", "ray_rust_tpu/ops/pallas_trace.py:1275",
         [W, H]),
        ("trace_bwd_buf", "trace_bwd_buf", "trace_bwd.cu", "ray_rust_tpu/ops/pallas_bwd.py:563",
         list(DEEP_GRAD)),
        ("march_bwd_buf", "march_bwd_buf", "march_bwd_buf.cu",
         "ray_rust_tpu/ops/pallas_bwd.py:1060", list(DEEP_GRAD)))]


# Phase 10's bank of textures: past kernel_trace.TEXTURE_MAX = 1 024, so each
# of K1-K4 runs its global-table build, which reads the meta rows from global
# memory; the floor takes the last
BANK_TEXTURES = 1101
# Phase 10's host counts (the bounds) by its kernels line's keys
DEEP_COUNTS = {"march_fwd_deep": "march_fwd_cap12", "march_bwd_buf": "march_bwd_cap12",
               "trace_fwd_global": "trace_fwd_bank", "trace_bwd_global": "trace_bwd_bank",
               "march_fwd_global": "march_fwd_bank", "march_bwd_global": "march_bwd_bank"}


def deep_counts(pool, rtt, torch):
    """Phase 10's host counts, submitted to ``pool``: K3's deep march and
    K4's buffer instance at refraction cap 12 at 1280x720 on the default
    scene (the deep march's host loop, rt_march_deep_host, and the buffer
    instance's twin), and K1-K4 on the bank at the main paths' shapes."""
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

    cap12, _, cfg_main, cfg_march = deep_configs(rtt)
    bank = bank_scene(rtt, device="cpu")
    return {"march_fwd_cap12": pool.submit(count_ops, "march", km, cap12,
                                           fn="rt_march_deep_host"),
            "march_bwd_cap12": pool.submit(count_bwd_ops, "march_bwd", kmb, cap12),
            "trace_fwd_bank": pool.submit(count_ops, "trace", kt, cfg_main, scene=bank),
            "trace_bwd_bank": pool.submit(count_bwd_ops, "trace_bwd", kb, cfg_main, scene=bank),
            "march_fwd_bank": pool.submit(count_ops, "march", km, cfg_march, scene=bank),
            "march_bwd_bank": pool.submit(count_bwd_ops, "march_bwd", kmb, cfg_march,
                                          scene=bank)}


def bank_scene(rtt, n_tex=BANK_TEXTURES, filt=0, device="cuda"):
    """The default scene whose floor reads texture ``n_tex - 1`` of a bank of
    ``n_tex`` 16x16 crops of the goldens' noise texture
    (tests/goldens/gen_textured.py), crop 1 100 whatever ``n_tex``; the
    other textures belong to materials no object takes
    (tests/test_torch_deep_march.py's)."""
    noise = np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8)

    def crop(k):
        row, col = 16 * (k // 16 % 16), 16 * (k % 16)
        return noise[row:row + 16, col:col + 16]

    mats = [rtt.MaterialSpec(name=f"t{k}", texture=crop(k)) for k in range(n_tex - 1)] + [
        rtt.MaterialSpec(name="floor", diffuse=(1.0, 1.0, 0.0), pattern=2, pattern_scale=300.0,
                         pattern_angle_scale=0.2, texture_filter=filt, texture=crop(1100)),
        rtt.MaterialSpec(name="mirror", specular=(1.0, 1.0, 1.0), pn=24),
        rtt.MaterialSpec(name="red", diffuse=(0.8, 0.0, 0.0), pn=24, glow_dist=5.0),
        rtt.MaterialSpec(name="transparent", transparency=1.0, refraction=1.5,
                         frac=(1.49998, 1.49999, 1.5))]
    objs = [rtt.FloorSpec("floor", (0.0, -300.0, 0.0), (0.0, 1.0, 0.0), uvmap=2),
            rtt.SphereSpec("mirror", 80.0, (0.0, -30.0, 172.0)),
            rtt.SphereSpec("mirror", 80.0, (-200.0, -30.0, 172.0)),
            rtt.SphereSpec("red", 80.0, (-200.0, -200.0, 172.0)),
            rtt.SphereSpec("transparent", 100.0, (70.0, -200.0, 150.0))]
    return rtt.build_scene(mats, objs, (0.0, -150.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2),
                           (50.0, 60.0, -50.0), device=device)[0]


def deep_configs(rtt):
    """Phase 10's configurations: the march main path at refraction cap 12
    (1280x720, glow 1.0), its 2 000-step small twin with the floor tail off
    (the plain autograd's), and the main paths' trace and march."""
    glow = dict(use_raymarching=True, glow_effect=1.0)
    cap12 = rtt.RenderConfig(xres=MW, yres=MH, max_refractions=12, refraction_unroll=None,
                             **glow)
    small12 = cap12.with_(xres=MANY_GRAD[0], yres=MANY_GRAD[1], march_max_iter=2000,
                          march_floor_skip=False)
    return cap12, small12, rtt.RenderConfig(xres=W, yres=H), rtt.RenderConfig(xres=MW, yres=MH,
                                                                              **glow)


def deep_marches(torch, rtt, cli, ops, card, children):
    """Phase 10: deep marches and large banks on the card. The main paths,
    each with the launch counts set to 0 just before it and read just
    after: the CLI's ``-m -g 1.0 --max_refractions 12 --refraction_unroll
    12`` at 1280x720 (one launch of K3's deep instance, its PNG
    ``render_u8`` of the same config) and one ``sgd_train_step`` on the
    material colours at that config (K3's deep instance, K4's buffer
    instance on the deep march); then the bank of BANK_TEXTURES textures:
    ``render_u8`` at 1920x1080 and at 1280x720 -m -g 1.0 and one
    ``sgd_train_step`` at each (K1 twice, K2 once, K3 twice, K4 once, each
    in its global-table build). Then K3's deep instance forced at caps 4
    and 10 on the default 1280x720 march bit-equal to march_fwd; at cap 12
    by phase 3's method (its whole frame against its launches on
    partition()'s bands, the plain march on check_rows): the floor tail off
    bit for bit, on within the golden budget and knife-edge-only against
    off; on the box of planes (160x120, 2 000 steps, tail off) bit-equal
    to the plain march. K4's buffer instance at cap 12 against plain
    autograd at 160x120 (2 000 steps, tail off) per scene leaf within
    MARCH_GRAD_BUDGET on the pixels where K3's image agrees with the plain
    one (each other on a decision boundary), in one band and in
    DEEP_BANDS, on the default scene and on the box, whose records (a
    one-band launch into a buffer filled with RECORD_FILL) show a pixel
    that nests more than 10 raymarch calls; its image K3's. The bank: K1 at
    1920x1080 and K3 at 1280x720 by phase 3's method, K2 and K4 at 160x120
    against plain autograd within GRAD_BUDGET and MARCH_GRAD_BUDGET. Times
    by events (3 warm-ups, 10 calls): K3's deep instance forced at cap 4
    beside march_fwd in turns, K3 and K4 at cap 12, the bank's kernels at
    the main paths' shapes; bounds from the host counts. The plain march
    images at 1280x720 are the plain children's (``plain_jobs``). Returns
    phase 10's entries of the kernels line."""
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_pack as kp
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.parallel import sgd_train_step
    from ray_rust_tpu_torch.utils.image import load_png

    dev = torch.device("cuda", 0)
    default = rtt.default_scene()[0]
    bank = bank_scene(rtt)
    cap12, small12, cfg_main, cfg_march = deep_configs(rtt)
    n_tex = kt.texture_count(bank)
    libs = {"K1": kt.library("trace_fwd", bank.objects.count, kt.SHARED_TABLE_MAX, n_tex),
            "K2": kt.library("trace_bwd", bank.objects.count, kb.SHARED_TABLE_MAX, n_tex),
            "K3": km.library_name(bank, cfg_march),
            "K4": kt.library("march_bwd", bank.objects.count, kb.SHARED_TABLE_MAX, n_tex)}
    print(f"deep marches and large banks: refraction cap 12 ({kmb.count_sites(cap12)} laps, "
          f"{kmb.count_frames(cap12)} frames; K3 {km.library_name(default, cap12)}, K4 buffered "
          f"{kmb.buffered(cap12)}); a bank of {n_tex} textures (staged meta rows "
          f"{kt.staged_meta(n_tex)}; builds {libs})")
    if km.library_name(default, cap12) != "march_fwd_deep" or not kmb.buffered(cap12):
        raise SystemExit("chip_smoke: cap 12 does not route to the deep instances")
    if any(not v.endswith(_build.GLOBAL_SUFFIX) for v in libs.values()):
        raise SystemExit(f"chip_smoke: the bank does not route to the global-table builds: {libs}")

    # -- the main paths: the counts set to 0 just before each, read just after
    def colours(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    def trainable(scene):
        m = scene.materials
        return scene._replace(materials=m._replace(diffuse=colours(m.diffuse),
                                                   specular=colours(m.specular)))

    def redder(scene, cfg):
        m = scene.materials
        red = m.diffuse.r.clone()
        red[-2] += 0.1  # the red sphere's material
        with torch.no_grad():
            return rtt.render_color(scene._replace(materials=m._replace(
                diffuse=m.diffuse._replace(r=red))), cfg).to_array()

    def reset():
        kt.LAUNCHES = kb.LAUNCHES = kb.BUF_LAUNCHES = km.LAUNCHES = km.DEEP_LAUNCHES = 0
        kmb.LAUNCHES = kmb.BUF_LAUNCHES = kp.LAUNCHES = kp.VJP_LAUNCHES = 0

    def counts():
        return {"trace_fwd": kt.LAUNCHES, "trace_bwd": kb.LAUNCHES,
                "trace_bwd_buf": kb.BUF_LAUNCHES, "march_fwd": km.LAUNCHES,
                "march_fwd_deep": km.DEEP_LAUNCHES, "march_bwd": kmb.LAUNCHES,
                "march_bwd_buf": kmb.BUF_LAUNCHES, "pack_scene": kp.LAUNCHES,
                "pack_scene_vjp": kp.VJP_LAUNCHES}

    target12 = redder(default, cap12)
    bank_targets = {c: redder(bank, c) for c in (cfg_main, cfg_march)}
    with tempfile.TemporaryDirectory() as td:
        png_path = os.path.join(td, "deep.png")
        reset()
        t0 = time.time()
        rc = cli.main([str(MW), str(MH), "-m", "-g", "1.0", "--max_refractions", "12",
                       "--refraction_unroll", "12", "-o", png_path])
        loss12 = float(sgd_train_step(trainable(default), cap12, target12, lr=MARCH_TRAIN_LR)[1])
        torch.cuda.synchronize()
        wall = time.time() - t0
        deep_launches = counts()
        png = load_png(png_path)
    want = {"trace_fwd": 0, "trace_bwd": 0, "trace_bwd_buf": 0, "march_fwd": 2,
            "march_fwd_deep": 2, "march_bwd": 0, "march_bwd_buf": 1, "pack_scene": 2,
            "pack_scene_vjp": 1}
    print(f"main path, deep march: the CLI -m -g 1.0 --max_refractions 12 at {MW}x{MH} and "
          f"sgd_train_step at cap 12 in {wall:.2f} s; launches {deep_launches}; loss {loss12:.6g}")
    if rc != 0 or deep_launches != want or not np.isfinite(loss12):
        raise SystemExit(f"chip_smoke: the deep march main path: CLI exit {rc}, launches "
                         f"{deep_launches} (want {want}), loss {loss12}")
    if not np.array_equal(png, rtt.render_u8(default, cap12.with_(refraction_unroll=12))):
        raise SystemExit("chip_smoke: the deep march CLI's PNG is not render_u8 of its config")
    reset()
    t0 = time.time()
    frames = [rtt.render_u8(bank, c) for c in (cfg_main, cfg_march)]
    bank_losses = [float(sgd_train_step(trainable(bank), c, bank_targets[c],
                                        lr=TRAIN_LR if c is cfg_main else MARCH_TRAIN_LR)[1])
                   for c in (cfg_main, cfg_march)]
    torch.cuda.synchronize()
    wall = time.time() - t0
    bank_launches = counts()
    want = {"trace_fwd": 2, "trace_bwd": 1, "trace_bwd_buf": 0, "march_fwd": 2,
            "march_fwd_deep": 0, "march_bwd": 1, "march_bwd_buf": 0, "pack_scene": 4,
            "pack_scene_vjp": 2}
    print(f"main path, {n_tex} textures: render_u8 at {W}x{H} and {MW}x{MH} -m -g 1.0 and "
          f"sgd_train_step at each in {wall:.2f} s; launches {bank_launches}; losses "
          + ", ".join(f"{v:.6g}" for v in bank_losses))
    floor = slice(3 * H // 4, H)
    if (bank_launches != want or not np.isfinite(bank_losses).all()
            or np.array_equal(frames[0][floor], rtt.render_u8(default, cfg_main)[floor])):
        raise SystemExit(f"chip_smoke: the bank's main path: launches {bank_launches} (want "
                         f"{want}), losses {bank_losses}, or its floor is not textured")

    # -- K3's deep instance forced where the recursive instance runs:
    # bit-equal to march_fwd on the whole frame
    words = kp.launch_pack(default)
    n = default.objects.count
    ptrs, meta = kp.word_pointers(words, n)
    deep_lib = _build.load_cuda_library("march_fwd_deep")

    def forced_deep(cfg):
        return lambda: kt.launch(deep_lib, deep_lib.rt_march_fwd, ptrs, n, dev, cfg,
                                 km.kernel_args(cfg) + kp.texture_pointers(default, meta))

    with torch.no_grad():
        for cap in (4, 10):
            c = cfg_march.with_(max_refractions=cap, refraction_unroll=None)
            same = np.array_equal(img(forced_deep(c)()), img(km.render_color_kernel(default, c)))
            print(f"  march_fwd_deep forced at refraction cap {cap}, default {MW}x{MH}: bit-equal "
                  f"to march_fwd {same} -> {'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"chip_smoke: the deep march at cap {cap} is not march_fwd")

    # -- K3 at cap 12 by phase 3's method, and on the box of planes
    errs = {"march_fwd_deep": [], "march_bwd_buf": [], "trace_fwd_global": [],
            "trace_bwd_global": [], "march_fwd_global": [], "march_bwd_global": []}
    plain_ms = {}

    def rows_check(key, scene, cfg, mod, tail_off):
        """The kernel's whole frame against its launches on partition()'s
        bands, then against the plain version on check_rows (a plain
        child's job ``key`` where it has one): within the golden budget, and
        with ``tail_off`` the kernel with the floor tail off bit for bit
        (the tail on against off knife-edge-only)."""
        got = banded_frame(torch, mod, scene, cfg)
        with torch.no_grad():
            rows = check_rows(cfg.yres)
            if any(key in keys for keys in children.keys):
                plain = children.get(key)
                ref, ms = plain["image"], float(plain["ms"])
            else:
                ref, ms = event_ms(torch, lambda: mod.render_color_plain(scene, cfg, rows=rows))
                ref = img(ref)
            plain_ms[key] = (ms, len(rows))
            errs[key].append(compare(f"{key} {cfg.xres}x{cfg.yres} vs plain on {len(rows)} rows "
                                     f"(the whole frame its {PARTITION} bands' bit for bit; "
                                     f"plain {ms:.1f} ms)", ref, got[rows]))
            if tail_off:
                off = img(mod.render_color_kernel(scene, cfg.with_(march_floor_skip=False)))
                same = float((off[rows] == ref).all(-1).mean())
                print(f"  {key} tail off: bit-equal to the plain version on {same:.4%} of the "
                      f"pixels of {len(rows)} rows -> {'ok' if same == 1.0 else 'FAIL'}")
                if same < 1.0:
                    raise SystemExit(f"chip_smoke: {key} with the tail off is not the plain "
                                     f"version")
                knife_edge_only(f"{key} tail on vs off {cfg.xres}x{cfg.yres}", got, off)

    rows_check("march_fwd_deep", default, cap12, km, True)
    box = box_scene(rtt)
    box12 = small12
    box_plain = event_ms(torch, lambda: kb.plain_vjp(box, box12))  # K4's below too
    with torch.no_grad():
        got, ref = img(km.render_color_kernel(box, box12)), img(box_plain[0][0])
    same = np.array_equal(got, ref)
    errs["march_fwd_deep"].append(float(np.abs(got - ref).max()))
    print(f"  march_fwd_deep, box of planes {box12.xres}x{box12.yres} (tail off, 2000 steps): "
          f"bit-equal to the plain march {same} -> {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("chip_smoke: the deep march on the box is not the plain march")

    # -- K4's buffer instance at cap 12 against plain autograd, and the box's
    # records
    def grad_vs_plain(key, label, scene, cfg, mod, fwd, budget, bands_too, plain=None):
        """``mod``'s wrapper against plain autograd on the pixels where
        ``fwd``'s image agrees with the plain one within 1e-4 (each other
        pixel on a decision boundary), in one band and with ``bands_too`` in
        DEEP_BANDS, its image ``fwd``'s bit for bit; the plain time is
        ``key``'s unless ``label`` names another scene. ``plain`` is
        ``((image, vjp), ms)`` of a plain_vjp call made before."""
        (ref, vjp), ms = plain or event_ms(torch, lambda: kb.plain_vjp(scene, cfg))
        ref = img(ref)
        got = img(fwd.render_color_kernel(scene, cfg))
        agree = np.abs(got - ref).max(-1) < 1e-4
        flat = off_boundary(ref, ~agree)
        rng = np.random.default_rng(cfg.xres + len(key))
        g = rtt.Color(*(torch.from_numpy(rng.standard_normal(agree.shape).astype(np.float32)
                                         * agree).to(dev) for _ in range(3)))
        want, vjp_ms = event_ms(torch, lambda: vjp(g))
        if not label:
            plain_ms[key] = (ms + vjp_ms, cfg.yres)
        runs = [(1, lambda: mod.render_grads_kernel(scene, cfg, g, return_primal=True))]
        if bands_too:
            def banded():
                saved = kb.RECORD_BUDGET
                kb.RECORD_BUDGET = (4 * kmb.RECORD_WORDS * kmb.count_sites(cfg) * cfg.xres
                                    * -(-cfg.yres // DEEP_BANDS))
                try:
                    return mod.render_grads_kernel(scene, cfg, g, return_primal=True)
                finally:
                    kb.RECORD_BUDGET = saved
            runs.append((DEEP_BANDS, banded))
        for nb, fn in runs:
            before = kmb.BUF_LAUNCHES
            out, prim = fn()
            bands = kmb.BUF_LAUNCHES - before
            worst, leaf = leaf_err(key, scene, out, want)
            same = float((img(prim) == got).all(-1).mean())
            ok = (worst <= budget and same == 1.0 and agree.mean() > 0.9 and flat == 0
                  and (bands == nb or mod is not kmb or not kmb.buffered(cfg)))
            print(f"  {key}{label} {cfg.xres}x{cfg.yres}" + (f" in {bands} bands" if bands else "")
                  + f": forwards agree on {agree.mean():.4%}, {flat} masked off a boundary; "
                  f"image the forward kernel's on {same:.4%}; largest leaf relative L2 "
                  f"{worst:.3g} ({leaf}); plain autograd {ms + vjp_ms:.1f} ms -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {key}: {mod.__name__} off plain autograd")
            errs[key].append(worst)

    grad_vs_plain("march_bwd_buf", "", default, small12, kmb, km, MARCH_GRAD_BUDGET, True)
    grad_vs_plain("march_bwd_buf", ", box of planes", box, box12, kmb, km, MARCH_GRAD_BUDGET,
                  True, box_plain)
    cap = kmb.count_sites(box12)
    bwords = kp.launch_pack(box)
    bptrs, bmeta = kp.word_pointers(bwords, box.objects.count)
    buf_lib = _build.load_cuda_library("march_bwd_buf")
    pixels = box12.xres * box12.yres
    buf = torch.full((pixels * kmb.RECORD_WORDS * cap,), kb.RECORD_FILL, dtype=torch.int32,
                     device=dev)
    zero = rtt.Color(*(torch.zeros(box12.yres, box12.xres, device=dev) for _ in range(3)))
    kb.launch_buffered(buf_lib, buf_lib.rt_march_bwd_buf, bptrs, box.objects.count, dev, box12,
                       kmb.kernel_args(box12) + kp.texture_pointers(box, bmeta), zero, False,
                       cap_words=kmb.RECORD_WORDS * cap, extra=(cap,),
                       budget=4 * pixels * kmb.RECORD_WORDS * cap, buf=buf)
    nest = kmb.nesting(buf, cap, pixels)
    laps = kb.recorded(buf, cap, kmb.LAP_WORDS, pixels)
    deepest = int(nest.max())
    print(f"  march_bwd_buf records, box of planes {box12.xres}x{box12.yres} at cap 12: the "
          f"deepest chain of nested raymarch calls {deepest} (pixels past 10: "
          f"{int((nest > 10).sum())} of {pixels}), the most laps a pixel {int(laps.max())}")
    if deepest <= km.FRAME_CAP:
        raise SystemExit("chip_smoke: no pixel of the box nests past 10 raymarch calls")
    del buf

    # -- the bank: K1 and K3 by phase 3's method, K2 and K4 against autograd
    rows_check("trace_fwd_global", bank, cfg_main, kt, False)
    rows_check("march_fwd_global", bank, cfg_march, km, True)
    gsmall = rtt.RenderConfig(xres=MANY_GRAD[0], yres=MANY_GRAD[1])
    grad_vs_plain("trace_bwd_global", "", bank, gsmall, kb, kt, GRAD_BUDGET, False)
    grad_vs_plain("march_bwd_global", "", bank,
                  gsmall.with_(use_raymarching=True, glow_effect=1.0, march_max_iter=2000,
                               march_floor_skip=False), kmb, km, MARCH_GRAD_BUDGET, False)

    # -- times by events at the main paths' shapes
    rng = np.random.default_rng(10)
    gt, gm = (rtt.Color(*(torch.from_numpy(rng.standard_normal((c.yres, c.xres))
                                           .astype(np.float32)).to(dev) for _ in range(3)))
              for c in (cfg_main, cfg_march))
    with torch.no_grad():
        turns = [(k, cuda_ms(torch, forced_deep(cfg_march) if k == "march_fwd_deep"
                             else lambda: km.render_words_kernel(default, words, cfg_march)))
                 for k in ("march_fwd", "march_fwd_deep", "march_fwd_deep", "march_fwd")]
        ms = {"march_fwd_deep": cuda_ms(torch, lambda: km.render_color_kernel(default, cap12)),
              "trace_fwd_global": cuda_ms(torch, lambda: kt.render_color_kernel(bank, cfg_main)),
              "march_fwd_global": cuda_ms(torch, lambda: km.render_color_kernel(bank, cfg_march))}
    print(f"  the default {MW}x{MH} march at cap 4 alone on packed words, in turns ({card}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in turns) + " ms")
    ms["march_bwd_buf"] = cuda_ms(torch, lambda: kmb.render_grads_kernel(
        default, cap12, gm, return_primal=True))
    ms["trace_bwd_global"] = cuda_ms(torch, lambda: kb.render_grads_kernel(
        bank, cfg_main, gt, return_primal=True))
    ms["march_bwd_global"] = cuda_ms(torch, lambda: kmb.render_grads_kernel(
        bank, cfg_march, gm, return_primal=True))
    shapes = {"march_fwd_deep": (cap12, default), "march_bwd_buf": (cap12, default),
              "trace_fwd_global": (cfg_main, bank), "trace_bwd_global": (cfg_main, bank),
              "march_fwd_global": (cfg_march, bank), "march_bwd_global": (cfg_march, bank)}
    bounds = {}
    for key, (cfg, scene) in shapes.items():
        n_ops, fetched = ops[DEEP_COUNTS[key]].result()[:2]
        nbytes = io_bytes(scene, cfg) + texel_bytes(scene, fetched)
        if "_bwd" in key:  # + the cotangent planes read, the block written
            nbytes += 3 * 4 * cfg.xres * cfg.yres + 4 * (scene.objects.count + 1) * kb.GRAD_COLS
        bounds[key] = roofline(n_ops, nbytes)
        print(f"  {key} {cfg.xres}x{cfg.yres}: {ms[key]:.4f} ms by events"
              + (" with the image" if "_bwd" in key else "") + f" ({card}); plain "
              f"{plain_ms[key][0]:.1f} ms on {plain_ms[key][1]} rows; bound {n_ops} f32 "
              f"operations, {nbytes} bytes -> {bounds[key][0]:.4f} ms ({bounds[key][1]})")
    forced = {"march_fwd": [v for k, v in turns if k == "march_fwd"],
              "march_fwd_deep": [v for k, v in turns if k == "march_fwd_deep"]}
    launches = {"march_fwd_deep": deep_launches["march_fwd_deep"],
                "march_bwd_buf": deep_launches["march_bwd_buf"],
                "trace_fwd_global": bank_launches["trace_fwd"],
                "trace_bwd_global": bank_launches["trace_bwd"],
                "march_fwd_global": bank_launches["march_fwd"],
                "march_bwd_global": bank_launches["march_bwd"]}
    entries = (("march_fwd_deep", "march_fwd_deep", "march_fwd_deep.cu",
                "ray_rust_tpu/ops/pallas_march.py:814", "refraction cap 12"),
               ("march_bwd_buf", "march_bwd_buf", "march_bwd_buf.cu",
                "ray_rust_tpu/ops/pallas_bwd.py:1060", "refraction cap 12"),
               ("trace_fwd_global", "trace_fwd_global", "trace_fwd.cu",
                "ray_rust_tpu/ops/pallas_trace.py:1275", f"{n_tex} textures"),
               ("trace_bwd_global", "trace_bwd_global", "trace_bwd.cu",
                "ray_rust_tpu/ops/pallas_bwd.py:563", f"{n_tex} textures"),
               ("march_fwd_global", "march_fwd_global", "march_fwd.cu",
                "ray_rust_tpu/ops/pallas_march.py:814", f"{n_tex} textures"),
               ("march_bwd_global", "march_bwd_global", "march_bwd.cu",
                "ray_rust_tpu/ops/pallas_bwd.py:1060", f"{n_tex} textures"))
    return [{
        "name": f"{key} ({what})", "route": "cuda", "build": build,
        "source": f"ray_rust_tpu_torch/csrc/{source}", "replaces": replaces,
        "launches": launches[key], "max_abs_err": max(errs[key]), "ms": ms[key],
        "plain_ms": plain_ms[key][0], "plain_rows": plain_ms[key][1],
        "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None,
        **({"forced_cap4_ms": forced} if key == "march_fwd_deep" else {}),
    } for key, build, source, replaces, what in entries]


# Phase 11: an atlas of 2^31 texels or more. 2 049 textures of 1 024 x
# 1 024 (2^31 + 2^20 texels: the bank's packed u8 24 GiB, the atlas's int32
# words 32 GiB), seeded noise made on the card, the floor reading the last
# texture (base texel 2^31) in Bilinear; the checks' small march config (the
# plain march's cost is its longest lane's steps) and the gradients' windows
# on the floor
HUGE_BANK = (2049, 1024)
HUGE_SEED = 31
HUGE_MARCH = dict(xres=320, yres=240, use_raymarching=True, glow_effect=1.0,
                  march_max_iter=2000, march_floor_skip=False)
HUGE_WINDOWS = {"trace": ((960, 900), (48, 64)), "march": ((640, 600), (48, 64))}


def huge_texels(torch, tids, side, dev):
    """Textures ``tids`` of phase 11's bank, ``(len(tids), side, side, 3)``
    u8: seeded integer-hash noise of (texture, row, column, channel), the
    same bits on the card and on the CPU."""
    t = torch.as_tensor(tids, dtype=torch.int64, device=dev).view(-1, 1, 1, 1)
    y = torch.arange(side, dtype=torch.int64, device=dev).view(1, -1, 1, 1)
    x = torch.arange(side, dtype=torch.int64, device=dev).view(1, 1, -1, 1)
    c = torch.arange(3, dtype=torch.int64, device=dev).view(1, 1, 1, -1)
    h = ((t * side + y) * side + x) * 3 + c + HUGE_SEED * 0x9E3779B1
    h = (h ^ (h >> 15)) * 0x2C1B3C6D & 0xFFFFFFFF
    h = (h ^ (h >> 12)) * 0x297A2D39 & 0xFFFFFFFF
    return ((h ^ (h >> 15)) & 0xFF).to(torch.uint8)


def huge_bank(torch, tids, side, dev):
    """A TextureBank of phase 11's textures ``tids`` on ``dev``: the packed
    2x2 wrap-around taps made 16 textures at a time, ``data`` a view of
    the first tap."""
    from ray_rust_tpu_torch.models.material import TextureBank

    packed = torch.empty((len(tids), side, side, 12), dtype=torch.uint8, device=dev)
    for k in range(0, len(tids), 16):
        t = huge_texels(torch, tids[k:k + 16], side, dev)
        for j, (dy, dx) in enumerate(((0, 0), (0, -1), (-1, 0), (-1, -1))):
            packed[k:k + len(t), ..., 3 * j:3 * j + 3] = t.roll((dy, dx), (1, 2))
        del t
    sizes = torch.full((len(tids),), side, dtype=torch.int32, device=dev)
    return TextureBank(packed[..., 0:3], sizes, sizes.clone(), packed)


def huge_bank_scenes(torch, rtt, dev, twin_only=False):
    """Phase 11's scenes on ``dev``: :func:`bank_scene`'s layout with a bank
    of HUGE_BANK textures (:func:`huge_texels`), the floor's material on the
    last texture in Bilinear, and its twin, whose bank holds only the two
    textures its materials read (the same texels at offsets under 2^31).
    Returns ``(huge, twin)``, or with ``twin_only`` the twin alone."""
    n_tex, side = HUGE_BANK
    small = bank_scene(rtt, n_tex=2, filt=1, device=dev)
    twin = small._replace(textures=huge_bank(torch, [0, n_tex - 1], side, dev))
    if twin_only:
        return twin
    m = small.materials
    tid = torch.where(m.texture_id == 1, n_tex - 1, m.texture_id).to(torch.int32)
    huge = small._replace(materials=m._replace(texture_id=tid),
                          textures=huge_bank(torch, list(range(n_tex)), side, dev))
    return huge, twin


def huge_configs(rtt):
    """Phase 11's configurations: the trace main path, the march main path
    (glow 1.0), the checks' small march (HUGE_MARCH) and the march window's
    (the main path's frame at HUGE_MARCH's step budget, tail off: the plain
    autograd's cost is its longest lane's steps)."""
    cfg_march = rtt.RenderConfig(xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0)
    return (rtt.RenderConfig(xres=W, yres=H), cfg_march, rtt.RenderConfig(**HUGE_MARCH),
            cfg_march.with_(march_max_iter=HUGE_MARCH["march_max_iter"],
                            march_floor_skip=HUGE_MARCH["march_floor_skip"]))


def huge_counts(pool, rtt, torch):
    """Phase 11's host counts (its bounds) by its kernels line's keys,
    submitted to ``pool``, on the twin bank's scene on the CPU (the same
    fetches at smaller offsets): K1 and K3 at the main paths' shapes, K2
    and K4 on their windows."""
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

    cpu = huge_bank_scenes(torch, rtt, torch.device("cpu"), twin_only=True)
    cfg_main, cfg_march, _, grad_march = huge_configs(rtt)
    (tr0, tc0), (th, tw) = HUGE_WINDOWS["trace"]
    (mr0, mc0), (mh, mw) = HUGE_WINDOWS["march"]
    return {"huge_trace_fwd": pool.submit(count_ops, "trace", kt, cfg_main, scene=cpu),
            "huge_march_fwd": pool.submit(count_ops, "march", km, cfg_march, scene=cpu),
            "huge_trace_bwd": pool.submit(count_bwd_ops, "trace_bwd", kb, cfg_main,
                                          window=(tr0, tc0, th, tw), scene=cpu),
            "huge_march_bwd": pool.submit(count_bwd_ops, "march_bwd", kmb, grad_march,
                                          window=(mr0, mc0, mh, mw), scene=cpu)}


def huge_atlas(torch, rtt, card, ops):
    """Phase 11: a bank of 2^31 texels or more through K1-K4 on the card.
    Each kernel against the same kernel on the twin bank (the same texels
    under 2^31) bit for bit: K1 at 1920x1080, K3 at HUGE_MARCH's 320x240,
    K2 and K4 on their HUGE_WINDOWS (block and image); then K1 and K3
    against their plain versions on ``check_rows`` (the plain sampler indexes
    the bank in int64), bit for bit, and K2 and K4 against plain autograd on
    their windows within GRAD_BUDGET and MARCH_GRAD_BUDGET (the textured
    checks' budgets), on the pixels where the forwards agree. Its main path
    (the launches): a frame of each mode and a gradient of each window by
    autograd, counts set to 0 before and read after; times by events at
    the main paths' shapes, bounds from ``ops`` (:func:`huge_counts`); the
    bank is freed before it returns. Returns phase 11's entries of the
    kernels line."""
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_pack as kp
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    t0 = time.time()
    huge, twin = huge_bank_scenes(torch, rtt, dev)
    n_tex, side = HUGE_BANK
    texels = n_tex * side * side
    atlas = kp.texture_atlas(huge.textures.packed)
    torch.cuda.synchronize()
    print(f"  the bank: {n_tex} textures of {side}x{side}, {texels} texels (2^31 = {2**31}); "
          f"packed {huge.textures.packed.numel() / 2**30:.1f} GiB u8, atlas "
          f"{atlas.numel() * 4 / 2**30:.1f} GiB int32, made on the card in "
          f"{time.time() - t0:.1f} s; the floor reads texture {n_tex - 1} (base texel "
          f"{(n_tex - 1) * side * side}) in Bilinear")
    cfg_main, cfg_march, small_march, grad_march = huge_configs(rtt)
    errs, plain_ms = {}, {}

    def same(name, a, b):
        ok = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"  {name}: bit-equal -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} is not bit-equal")

    # -- each kernel against itself on the twin bank
    with torch.no_grad():
        for key, mod, cfg in (("trace_fwd", kt, cfg_main), ("march_fwd", km, small_march)):
            same(f"{key} {cfg.xres}x{cfg.yres} on the 2^31-texel bank vs the twin bank",
                 mod.render_color_kernel(huge, cfg), mod.render_color_kernel(twin, cfg))
    rng = np.random.default_rng(HUGE_SEED)
    grads = {}
    for key, mod, fwd, cfg, budget in (("trace_bwd", kb, kt, cfg_main, GRAD_BUDGET),
                                       ("march_bwd", kmb, km, grad_march, MARCH_GRAD_BUDGET)):
        origin, shape = HUGE_WINDOWS["trace" if key == "trace_bwd" else "march"]
        (ref, vjp), ms = event_ms(torch, lambda: kb.plain_vjp(huge, cfg, origin, shape))
        ref = img(ref)
        with torch.no_grad():
            got = img(fwd.render_color_kernel(huge, cfg, origin, shape))
        agree = np.abs(got - ref).max(-1) < 1e-4
        flat = off_boundary(ref, ~agree)
        g = rtt.Color(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                         * agree).to(dev) for _ in range(3)))
        want, vjp_ms = event_ms(torch, lambda: vjp(g))
        out, prim = mod.render_grads_kernel(huge, cfg, g, True, origin, shape)
        out2, prim2 = mod.render_grads_kernel(twin, cfg, g, True, origin, shape)
        same(f"{key} window {shape[1]}x{shape[0]} at {origin} of {cfg.xres}x{cfg.yres} on the "
             f"2^31-texel bank vs the twin bank (block and image)", (*out, *prim),
             (*out2, *prim2))
        worst, leaf = leaf_err(key, huge, out, want)
        image = float((img(prim) == got).all(-1).mean())
        ok = worst <= budget and image == 1.0 and agree.mean() > 0.9 and flat == 0
        print(f"  {key} window vs plain autograd: forwards agree on {agree.mean():.4%}, {flat} "
              f"masked off a boundary; image the forward kernel's on {image:.4%}; largest leaf "
              f"relative L2 {worst:.3g} ({leaf}; {budget}); plain {ms + vjp_ms:.1f} ms -> "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {key} on the 2^31-texel bank against autograd")
        errs[key], plain_ms[key], grads[key] = worst, ms + vjp_ms, (cfg, g, origin, shape)
    # -- K1 and K3 against their plain versions on check_rows, bit for bit
    with torch.no_grad():
        for key, mod, cfg in (("trace_fwd", kt, cfg_main), ("march_fwd", km, small_march)):
            rows = check_rows(cfg.yres)
            ref, ms = event_ms(torch, lambda: mod.render_color_plain(huge, cfg, rows=rows))
            got = img(mod.render_color_kernel(huge, cfg))[rows]
            ref = img(ref)
            errs[key], plain_ms[key] = float(np.abs(got - ref).max()), ms
            ok = np.array_equal(got, ref)
            print(f"  {key} {cfg.xres}x{cfg.yres} on the 2^31-texel bank vs plain on "
                  f"{len(rows)} rows (plain {ms:.1f} ms): max {errs[key]:.3g}, bit-equal "
                  f"{ok} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {key} on the 2^31-texel bank is not the plain "
                                 f"version")

    # -- the main path: a frame of each mode, a gradient of each window
    def leaves(scene):
        mats = scene.materials
        d = type(mats.diffuse)(*(t.detach().clone().requires_grad_() for t in mats.diffuse))
        return scene._replace(materials=mats._replace(diffuse=d)), list(d)

    kt.LAUNCHES = kb.LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = 0
    kp.LAUNCHES = kp.VJP_LAUNCHES = 0
    with torch.no_grad():
        rtt.render_color(huge, cfg_main)
        rtt.render_color(huge, cfg_march)
    for key in ("trace_bwd", "march_bwd"):
        cfg, g, origin, shape = grads[key]
        scene, params = leaves(huge)
        img_w = rtt.render_color(scene, cfg, origin=origin, shape=shape)
        torch.autograd.grad(tuple(img_w), params, tuple(g))
    torch.cuda.synchronize()
    launches = {"trace_fwd": kt.LAUNCHES, "trace_bwd": kb.LAUNCHES, "march_fwd": km.LAUNCHES,
                "march_bwd": kmb.LAUNCHES, "pack": kp.LAUNCHES, "pull_back": kp.VJP_LAUNCHES}
    want = {"trace_fwd": 2, "trace_bwd": 1, "march_fwd": 2, "march_bwd": 1, "pack": 4,
            "pull_back": 2}
    print(f"  main path on the 2^31-texel bank (a {W}x{H} frame, a {MW}x{MH} march + glow "
          f"frame, a gradient of each window by autograd): launches {launches}, expected {want}")
    if launches != want:
        raise SystemExit(f"chip_smoke: phase 11 launched {launches}, not {want}")

    # -- times by events at the main paths' shapes and windows; bounds
    with torch.no_grad():
        ms = {"trace_fwd": cuda_ms(torch, lambda: kt.render_color_kernel(huge, cfg_main)),
              "march_fwd": cuda_ms(torch, lambda: km.render_color_kernel(huge, cfg_march))}
    for key, mod in (("trace_bwd", kb), ("march_bwd", kmb)):
        cfg, g, origin, shape = grads[key]
        ms[key] = cuda_ms(torch, lambda: mod.render_grads_kernel(huge, cfg, g, True, origin,
                                                                 shape))
    shapes = {"trace_fwd": (cfg_main, None), "march_fwd": (cfg_march, None),
              "trace_bwd": (grads["trace_bwd"][0], grads["trace_bwd"][3]),
              "march_bwd": (grads["march_bwd"][0], grads["march_bwd"][3])}
    bounds = {}
    for key, (cfg, shape) in shapes.items():
        n_ops, fetched = ops[f"huge_{key}"][:2]
        pixels = None if shape is None else shape[0] * shape[1]
        nbytes = io_bytes(twin, cfg, pixels) + texel_bytes(twin, fetched)
        if "_bwd" in key:  # + the cotangent planes read, the block written
            nbytes += 3 * 4 * pixels + 4 * (huge.objects.count + 1) * kb.GRAD_COLS
        bounds[key] = roofline(n_ops, nbytes)
        print(f"  {key} on the 2^31-texel bank "
              + (f"{cfg.xres}x{cfg.yres}" if shape is None else f"window {shape[1]}x{shape[0]}")
              + f": {ms[key]:.4f} ms by events ({card}); plain {plain_ms[key]:.1f} ms; bound "
              f"{n_ops} f32 operations, {nbytes} bytes -> {bounds[key][0]:.4f} ms "
              f"({bounds[key][1]})")
    del huge, twin, atlas, grads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sources = {"trace_fwd": ("trace_fwd.cu", "ray_rust_tpu/ops/pallas_trace.py:1275"),
               "trace_bwd": ("trace_bwd.cu", "ray_rust_tpu/ops/pallas_bwd.py:563"),
               "march_fwd": ("march_fwd.cu", "ray_rust_tpu/ops/pallas_march.py:814"),
               "march_bwd": ("march_bwd.cu", "ray_rust_tpu/ops/pallas_bwd.py:1060")}
    return [{
        "name": f"{key}_global (2^31 texels)", "route": "cuda",
        "source": f"ray_rust_tpu_torch/csrc/{source}", "replaces": replaces,
        "launches": launches[key], "max_abs_err": errs[key], "ms": ms[key],
        "plain_ms": plain_ms[key], "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
        "library_ms": None,
    } for key, (source, replaces) in sources.items()]


# The plain references that two child processes of this script render on
# the card while phases 3 and 4 run (each is launch-bound on its own host
# thread, tens of seconds at any pixel count), by key: the march main
# path's frame on check_rows, untextured and with bar.png in both filters,
# each with its plain autograd under phase 3's cotangent (grad_case's seed
# 0 planes, zero off the rows and where K3's image with the floor tail on
# and off differ by 1e-4), and phase 10's two plain images at 1280x720 on
# check_rows (refraction cap 12; the bank). The main process waits for them
# all before phase 4b, whose kernel times they would share the card with.
PLAIN_CHILD_FLAG = "--plain-child"


def plain_jobs():
    """The two children's job lists (see above)."""
    march = dict(xres=MW, yres=MH, use_raymarching=True, glow_effect=1.0)
    rows = check_rows(MH)
    first = [{"key": f"march_{s}", "scene": s, "cfg": march, "rows": rows, "kind": "vjp",
              "seed": 0} for s in ("default", "tex0", "tex1")]
    second = [{"key": "march_fwd_deep", "scene": "default", "rows": rows, "kind": "image",
               "cfg": dict(march, max_refractions=12, refraction_unroll=None)},
              {"key": "march_fwd_global", "scene": "bank", "rows": rows, "kind": "image",
               "cfg": march}]
    return [first, second]


def cotangent_planes(torch, rtt, seed, cfg, dev):
    """grad_case's cotangent planes: three standard normal (H, W) planes
    from numpy's seed ``seed``."""
    rng = np.random.default_rng(seed)
    return rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                        .astype(np.float32)).to(dev) for _ in range(3)))


def plain_child(jobs_path, out_dir, tex_dir) -> int:
    """A plain child's work: each job of ``jobs_path`` in turn, its result
    written to ``out_dir/<key>.npz`` (whole, by a rename): an ``image`` job
    the plain version's rows and their ms; a ``vjp`` job also the agreement
    mask, the cotangent planes on the rows and the plain autograd's three
    cotangents (the tables', the camera's, the light's)."""
    import torch

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb

    dev = torch.device("cuda", 0)
    scenes = {"default": lambda: rtt.default_scene()[0],
              "tex0": lambda: rtt.default_scene(texture_dir=tex_dir, texture_filter=0)[0],
              "tex1": lambda: rtt.default_scene(texture_dir=tex_dir, texture_filter=1)[0],
              "bank": lambda: bank_scene(rtt)}
    with open(jobs_path) as f:
        jobs = json.load(f)
    for job in jobs:
        scene, cfg, rows = scenes[job["scene"]](), rtt.RenderConfig(**job["cfg"]), job["rows"]
        if job["kind"] == "image":
            with torch.no_grad():
                image, ms = event_ms(torch, lambda: kt.render_color_plain(scene, cfg, rows=rows))
            out = {"image": img(image), "ms": ms}
        else:
            (image, vjp), ms = event_ms(torch, lambda: kb.plain_vjp(scene, cfg, rows=rows))
            with torch.no_grad():  # grad_case's agreement at the main path's frame
                on_img, off_img = (img(km.render_color_kernel(scene, c))
                                   for c in (cfg, cfg.with_(march_floor_skip=False)))
            agree = np.abs(on_img - off_img).max(-1) < 1e-4
            on = torch.zeros(cfg.yres, 1, device=dev)
            on[rows] = 1.0
            g = rtt.Color(*(c * torch.from_numpy(agree).to(dev) * on
                            for c in cotangent_planes(torch, rtt, job["seed"], cfg, dev)))
            g_rows = rtt.Color(*(c[rows] for c in g))
            want, vjp_ms = event_ms(torch, lambda: vjp(g_rows))
            out = {"image": img(image), "ms": ms + vjp_ms, "agree": agree,
                   "g": np.stack([c.cpu().numpy() for c in g_rows]),
                   **{f"want{i}": w.cpu().numpy() for i, w in enumerate(want)}}
        tmp = os.path.join(out_dir, f"{job['key']}.part.npz")
        np.savez(tmp, **out)
        os.replace(tmp, os.path.join(out_dir, f"{job['key']}.npz"))
    return 0


class PlainChildren:
    """The plain children (``plain_jobs``), started together; ``get(key)``
    waits for one result; ``close()`` (also at exit) ends both."""

    def __init__(self, tex_dir):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_plain_")
        self.procs, self.keys = [], []
        for k, jobs in enumerate(plain_jobs()):
            path = os.path.join(self.dir, f"jobs{k}.json")
            with open(path, "w") as f:
                json.dump(jobs, f)
            log = open(os.path.join(self.dir, f"child{k}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), PLAIN_CHILD_FLAG, path, self.dir,
                 tex_dir], cwd=HERE, stdout=log, stderr=subprocess.STDOUT), log))
            self.keys.append([job["key"] for job in jobs])
        self.t0 = time.time()
        atexit.register(self.close)

    def get(self, key, timeout=1800):
        """Job ``key``'s result (a dict of arrays), once it is written."""
        path = os.path.join(self.dir, f"{key}.npz")
        proc, log = next(pl for pl, keys in zip(self.procs, self.keys) if key in keys)
        t0 = time.time()
        while not os.path.exists(path):
            if proc.poll() is not None or time.time() - t0 > timeout:
                log.flush()
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise SystemExit(f"chip_smoke: the plain child gave no {key} (exit "
                                 f"{proc.poll()}):\n{tail}")
            time.sleep(0.2)
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
        print(f"  (the plain child's {key}: {float(out['ms']):.1f} ms by events there; waited "
              f"{time.time() - t0:.1f} s)")
        return out

    def wait_all(self):
        """Every job's result, and both children's exit; returns the
        seconds since they started."""
        for keys in self.keys:
            for key in keys:
                self.get(key)
        for proc, log in self.procs:
            if proc.wait(timeout=600) != 0:
                raise SystemExit(f"chip_smoke: a plain child exited {proc.returncode}")
        return time.time() - self.t0

    def close(self):
        for proc, log in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    def plain(self, torch, key, dev):
        """grad_case's ``plain=`` for a ``vjp`` job: the rows' image, a
        stand-in for the vjp that checks its cotangent planes are the
        child's bit for bit and returns the child's cotangents, and the
        ms."""
        out = self.get(key)

        def vjp(g_rows):
            got = np.stack([c.cpu().numpy() for c in g_rows])
            if not np.array_equal(got, out["g"]):
                raise SystemExit(f"chip_smoke: {key}: the cotangent planes are not the plain "
                                 f"child's")
            return tuple(torch.from_numpy(out[f"want{i}"]).to(dev) for i in range(3))
        return out["image"], vjp, float(out["ms"])


def main() -> int:
    if sys.argv[1:2] == [PLAIN_CHILD_FLAG]:
        return plain_child(*sys.argv[2:5])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the textured phases' bar.png lives here
    with tempfile.TemporaryDirectory() as tex_dir:
        return run(torch, tex_dir)


# Each backward instance (library, launcher, record cap, task stack,
# textured or not) that this run launches is launched a second time on the
# same inputs at its first launch, and its block and image held bit-equal
# to the first launch's (repeat_backwards); by instance, whether they were
REPEATS: dict = {}


def repeat_backwards(torch, kb, kr, kt):
    """Wrap the backward kernels' launchers, ``kernel_trace_bwd.launch_block``
    (K2 and K4, their buffer instances through ``launch_buffered``) and
    ``kernel_trace_retrace.launch_all`` (K5), so that the first launch of
    each instance on the card is made twice on the same inputs and held bit
    for bit: the blocks sum fixed-point integers (csrc/fixed_sum.cuh), the
    same in any order of the kernels' atomics. The wrappers count their
    launches outside these functions, so the second launch counts for no
    path. Prints each instance's result; raises SystemExit on a
    difference."""
    import os.path as op

    def stem(lib):
        return op.basename(lib._name).split("-")[0][3:]

    def check(key, first, again):
        blocks = [(first[0], again[0])] if isinstance(first[0], torch.Tensor) else list(
            zip(first[0], again[0]))
        same = all(torch.equal(a, b) for a, b in blocks)
        if first[1] is not None:
            same = same and all(torch.equal(a, b) for a, b in zip(first[1], again[1]))
        REPEATS[key] = same
        print(f"  backward instance {key}: a second launch on the same inputs bit-equal -> "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"chip_smoke: backward instance {key} does not repeat itself")

    block_launch, retrace_launch = kb.launch_block, kr.launch_all

    def launch_block(lib, fn, ptrs, n, dev, cfg, args, g, return_primal, origin=(0, 0),
                     shape=None, extra=(), tail=None):
        go = lambda: block_launch(lib, fn, ptrs, n, dev, cfg, args, g, return_primal,  # noqa
                                  origin, shape, extra, tail)
        out = go()
        if dev.type == "cuda":
            trace = fn.__name__.startswith("rt_trace")
            key = (stem(lib), fn.__name__, f"cap {kb.site_cap(cfg)}" if trace else "",
                   f"{16 if kt.stack_tasks(cfg) <= kt.STACK_CAP else 64}-task stack"
                   if trace else "", "textured" if args[-3] else "untextured")
            if key not in REPEATS:
                check(key, out, go())
        return out

    def launch_all(lib, fn_name, ptrs, n, dev, cfg, g, return_primal, tail):
        out = retrace_launch(lib, fn_name, ptrs, n, dev, cfg, g, return_primal, tail)
        if dev.type == "cuda":
            key = (stem(lib), fn_name,
                   f"{16 if kt.stack_tasks(cfg) <= kt.STACK_CAP else 64}-task stack")
            if key not in REPEATS:
                again = retrace_launch(lib, fn_name, ptrs, n, dev, cfg, g, return_primal, tail)
                check(key, out if return_primal else (out, None),
                      again if return_primal else (again, None))
        return out

    kb.launch_block, kr.launch_all = launch_block, launch_all


def run(torch, tex_dir) -> int:
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch import cli
    from ray_rust_tpu_torch.models.scene import Camera
    from ray_rust_tpu_torch.ops import _build
    from ray_rust_tpu_torch.ops import kernel_march as km
    from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
    from ray_rust_tpu_torch.ops import kernel_pack as kp
    from ray_rust_tpu_torch.ops import kernel_trace as kt
    from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
    from ray_rust_tpu_torch.ops import kernel_trace_retrace as kr
    from ray_rust_tpu_torch.parallel import sgd_train_step
    from ray_rust_tpu_torch.utils.image import load_png, save_png

    repeat_backwards(torch, kb, kr, kt)
    cfg_main = rtt.RenderConfig(xres=W, yres=H)
    glow = dict(use_raymarching=True, glow_effect=1.0)
    cfg_march = rtt.RenderConfig(xres=MW, yres=MH, **glow)
    cfg_march_off = cfg_march.with_(march_floor_skip=False)  # the step-by-step march
    # bar.png: the textured goldens' 256x256 noise (tests/goldens/gen_textured.py)
    save_png(os.path.join(tex_dir, "bar.png"),
             np.random.default_rng(101).integers(0, 256, (256, 256, 3)).astype(np.uint8))
    # the main paths' operation counts, on the host while the card works
    counting = ThreadPoolExecutor(max_workers=6)
    ops_futures = {"trace_fwd": counting.submit(count_ops, "trace", kt, cfg_main),
                   "march_fwd": counting.submit(count_ops, "march", km, cfg_march),
                   "trace_bwd": counting.submit(count_bwd_ops, "trace_bwd", kb, cfg_main),
                   "march_bwd": counting.submit(count_bwd_ops, "march_bwd", kmb, cfg_march),
                   "march_fwd_off": counting.submit(count_ops, "march", km, cfg_march_off),
                   "march_bwd_off": counting.submit(count_bwd_ops, "march_bwd", kmb,
                                                    cfg_march_off),
                   "trace_fwd_textured": counting.submit(count_ops, "trace", kt, cfg_main,
                                                         tex_dir, 0),
                   "trace_bwd_textured": counting.submit(count_bwd_ops, "trace_bwd", kb,
                                                         cfg_main, tex_dir, 1),
                   "trace_retrace": counting.submit(count_retrace_ops, cfg_main),
                   "march_fwd_textured": counting.submit(count_ops, "march", km, cfg_march,
                                                         tex_dir, 0),
                   "march_fwd_textured_bilinear": counting.submit(count_ops, "march", km,
                                                                  cfg_march, tex_dir, 1),
                   "march_bwd_textured": counting.submit(count_bwd_ops, "march_bwd", kmb,
                                                         cfg_march, tex_dir, 1),
                   # K1 with K1b's cull on configuration 4's 101 objects and on 1 024
                   "trace_fwd_cull": counting.submit(
                       count_ops, "trace", kt, cfg_main,
                       scene=spheres_scene(rtt, 11, 100).to(torch.device("cpu"))),
                   "trace_fwd_cull_1024": counting.submit(
                       count_ops, "trace", kt, cfg_main,
                       scene=spheres_scene(rtt, 11, 1023).to(torch.device("cpu"))),
                   # phase 7's windows: the 2x2 meshes' last cells
                   "trace_fwd_window": counting.submit(count_ops, "trace", kt, cfg_main,
                                                       window=CELL),
                   "march_fwd_window": counting.submit(count_ops, "march", km, cfg_march,
                                                       window=MCELL),
                   # phase 8's: K2 and K4 on the same cells
                   "trace_bwd_window": counting.submit(count_bwd_ops, "trace_bwd", kb, cfg_main,
                                                       window=CELL),
                   "march_bwd_window": counting.submit(count_bwd_ops, "march_bwd", kmb,
                                                       cfg_march, window=MCELL),
                   # phase 9's: K1 at 12 reflections, K2 at 319 sites, K4 at 39 laps
                   "trace_fwd_deep": counting.submit(count_ops, "trace", kt,
                                                     cfg_main.with_(max_reflections=12)),
                   "trace_bwd_buf": counting.submit(
                       count_bwd_ops, "trace_bwd", kb,
                       cfg_main.with_(max_reflections=7, refraction_unroll=None)),
                   "march_bwd_buf": counting.submit(count_bwd_ops, "march_bwd", kmb,
                                                    cfg_march.with_(raymarch_max_reflections=7))}

    # 2. the builds, one nvcc each, all started together; meanwhile the card
    # renders the plain versions of phase 3's small march cases, which need
    # no kernel (each takes tens of seconds: its longest lane's steps)
    dev = torch.device("cuda", 0)
    default, _ = rtt.default_scene()
    march_cases = [
        ("march default 320x240", default, rtt.RenderConfig(xres=320, yres=240, **glow)),
        ("march default 320x240 refraction_unroll=None", default,
         rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None, **glow)),
        ("march 40 objects 320x240", spheres_scene(rtt, 7, 39, glow_dist=3.0),
         rtt.RenderConfig(xres=320, yres=240, max_refractions=1, **glow)),
        ("march 101 objects 160x120", spheres_scene(rtt, 11, 100, glow_dist=3.0),
         rtt.RenderConfig(xres=160, yres=120, **glow)),
    ]
    t0 = time.time()
    stems = tuple(KERNEL_COUNTS)

    def build():
        _build.prebuild(stems)
        return time.time()

    with ThreadPoolExecutor(max_workers=1) as pool:
        building = pool.submit(build)
        # the first case's plain march under autograd, its graph kept: its
        # image is the plain march's, and its vjp serves phase 3's march
        # gradient case on the same frame (one plain forward for both)
        (first, first_vjp), first_ms = event_ms(
            torch, lambda: kb.plain_vjp(default.to(dev), march_cases[0][2]))
        march_first_plain = (img(first), first_vjp, first_ms)
        march_plain = {name: img(km.render_color_plain(scene.to(dev), cfg))
                       for name, scene, cfg in march_cases[1:]}
        march_plain[march_cases[0][0]] = march_first_plain[0]
        # phase 7's windowed plain march of the 2x2 mesh's cell of the march
        # main path
        out, ms = event_ms(torch, lambda: km.render_color_plain(default, cfg_march, MCELL[:2],
                                                               MCELL[2:]))
        window_plain = {"cell": (img(out), ms)}
        # phase 8's plain references: the windowed plain trace and march
        # under autograd of a ragged window of the first case's frame and of
        # the main paths' 2x2 cells, their graphs kept for the kernels'
        # cotangents (the march contract masks them by K3's image); the
        # ragged march's image, rendered from the packed tables, is the plain
        # march's bit for bit and serves phase 7 too
        grad_plain = {}
        for key, cfg, win in (("trace", rtt.RenderConfig(xres=320, yres=240), SMALL_WINDOW),
                              ("march", march_cases[0][2], SMALL_WINDOW),
                              ("trace cell", cfg_main, CELL),
                              ("march cell", cfg_march, MCELL)):
            (out, vjp), ms = event_ms(torch, lambda cfg=cfg, win=win: kb.plain_vjp(
                default, cfg, win[:2], win[2:]))
            grad_plain[key] = (img(out), vjp, ms)
        window_plain["small"] = (grad_plain["march"][0], grad_plain["march"][2])
        # phase 9's plain references, the gradients' graphs kept
        deep_refs = deep_plain(torch, rtt, kb, kt)
        plain_s = time.time() - t0
        built_at = building.result()
    print(f"build: {', '.join(f'{stem}.cu' for stem in stems)} with nvcc in "
          f"{built_at - t0:.1f} s, each: " + ", ".join(
              f"{stem} {_build.build_seconds[stem]:.0f} s" for stem in stems
              if stem in _build.build_seconds)
          + f"; the small march cases' plain images meanwhile, in {plain_s:.1f} s")
    for stem in stems:
        print(f"  ptxas, {stem}:")
        for line in _build.build_logs[stem].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("    " + line.strip())
    ops_futures.update(deep_counts(counting, rtt, torch))  # phase 10's, once nvcc is done
    ops_futures.update(huge_counts(counting, rtt, torch))  # phase 11's
    children = PlainChildren(tex_dir)  # phase 3's and phase 10's plain references
    for stem in stems:
        calls = _build.called_functions(_build.build_logs[stem])
        if calls:
            raise SystemExit(f"chip_smoke: {stem}.cu left device functions as calls: {calls}")
    for stem, want in PINNED_PTXAS.items():
        got = ptxas_figures(_build.build_logs[stem], PINNED_KERNELS[stem])
        print(f"  {stem}: (registers, stack, spill stores, spill loads) {got}, pinned {want}")
        if sorted(got) != sorted(want):
            raise SystemExit(f"chip_smoke: {stem}.cu left its ptxas figures {want}: {got}")
    # the march backward's textured instance (MarchBody<true>), one kernel
    march_bwd_tex_ptxas = ptxas_figures(_build.build_logs["march_bwd"], "MarchBodyILb1E")
    print(f"  march_bwd, textured instance: (registers, stack, spill stores, spill loads) "
          f"{march_bwd_tex_ptxas}")
    if len(march_bwd_tex_ptxas) != 1:
        raise SystemExit("chip_smoke: march_bwd.cu does not hold its textured instance")
    # the instances beside the pinned ones: K1's (cull, stack), K2's deep
    # stack, the global-table builds
    for stem, frag, what in (
            ("trace_fwd", "", "K1: <no cull, 16>, <cull, 16>, <no cull, 64>, <cull, 64>"),
            ("trace_bwd", "13DeepTraceBodyI", "K2 with the 64-task stack: caps 192, 64"),
            ("trace_fwd_global", "", "K1 global tables: <no cull, 16>, <cull, 16>, "
                                     "<no cull, 64>, <cull, 64>"),
            ("march_fwd_global", "", "K3 global tables"),
            ("march_fwd_deep", "", "K3's deep instance (the deep march, global tables)"),
            ("trace_bwd_global", "9TraceBodyI", "K2 global tables: caps 192, 64, 16"),
            ("trace_bwd_global", "13DeepTraceBodyI", "K2 global tables, 64-task stack: caps "
                                                     "192, 64"),
            ("march_bwd_global", "", "K4 global tables: untextured, textured")):
        print(f"  {stem}, {what}: {ptxas_figures(_build.build_logs[stem], frag)}")
    for stem, want in KERNEL_COUNTS.items():
        if len(ptxas_figures(_build.build_logs[stem])) != want:
            raise SystemExit(f"chip_smoke: {stem} does not hold its {want} kernels")

    def both(scene, cfg, mod=kt):
        """Kernel and plain images of one render, and the plain one's ms."""
        scene = scene.to(dev)
        got = img(mod.render_color_kernel(scene, cfg))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = mod.render_color_plain(scene, cfg)
        end.record()
        torch.cuda.synchronize()
        return got, img(ref), start.elapsed_time(end)

    def rows_both(scene, cfg, mod, key):
        """The kernel's image of the whole frame, bit-equal to its own
        launches on partition()'s bands of rows, the plain version's image
        of check_rows (the plain child's job ``key``) and its ms, and the
        rows."""
        got = banded_frame(torch, mod, scene.to(dev), cfg)
        plain = children.get(key)
        return got, plain["image"], float(plain["ms"]), check_rows(cfg.yres)

    # 3. kernel vs plain on the card, and vs the golden
    phase_s = {"2": time.time() - t0}  # the phases' wall times, printed at the end
    t_phase = time.time()
    print("kernel vs plain version:")
    cases = [
        ("default 320x240", default, rtt.RenderConfig(xres=320, yres=240)),
        ("default 320x240 refraction_unroll=None", default,
         rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)),
        ("40 objects 320x240", spheres_scene(rtt, 7, 39),
         rtt.RenderConfig(xres=320, yres=240, max_refractions=1)),
        ("101 objects 160x120", spheres_scene(rtt, 11, 100),
         rtt.RenderConfig(xres=160, yres=120)),
    ]
    for name, scene, cfg in cases:
        got, ref, _ = both(scene, cfg)
        compare(name, ref, got)
    golden = np.load(os.path.join(HERE, "tests", "goldens", "default_trace_320x240.npz"))["img"]
    got = img(kt.render_color_kernel(default.to(dev),
                                     rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)))
    compare("kernel vs golden default_trace_320x240", golden, got)
    got, ref, _ = both(default, cfg_main)
    max_abs_err = compare(f"default {W}x{H} (the main path's shape)", ref, got)

    print("textured trace kernel (K1 with K1a) vs plain version and golden:")
    tex_scenes = {f: rtt.default_scene(texture_dir=tex_dir, texture_filter=f)[0] for f in (0, 1)}
    if any(s.textures is None for s in tex_scenes.values()):
        raise SystemExit("chip_smoke: default_scene did not load bar.png")
    tex_err, tex_plain_ms = {}, {}
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        got, ref, tex_plain_ms[f] = both(tex_scenes[f], cfg_main)
        tex_err[f] = compare(f"textured {fname} {W}x{H} (the main path's shape)", ref, got)
    for gname, f in (("default_textured_nearest_320x240", 0),
                     ("default_textured_bilinear_160x120", 1)):
        golden = np.load(os.path.join(HERE, "tests", "goldens", f"{gname}.npz"))["img"]
        gh, gw = golden.shape[:2]
        got = img(kt.render_color_kernel(tex_scenes[f], rtt.RenderConfig(
            xres=gw, yres=gh, refraction_unroll=None)))
        compare(f"textured kernel vs golden {gname}", golden, got, mean_budget=0.015)

    print("pack kernel vs pack_scene (bit for bit), pull-back kernel vs autograd of pack_scene:")
    pack_cases = [("default", default), ("textured Bilinear", tex_scenes[1]),
                  ("101 objects", spheres_scene(rtt, 11, 100))]
    pack_err, vjp_err = 0.0, 0.0
    for k, (name, scene) in enumerate(pack_cases):
        scene = scene.to(dev)
        tables, meta = kp.pack_tables(scene)
        plain_tex = kt.pack_textures(scene)
        pairs = list(zip(tables, kt.pack_scene(scene)))
        same = all(torch.equal(a.view(torch.int32), b.detach().view(torch.int32))
                   for a, b in pairs)
        same &= (meta is None) == (plain_tex is None) and (
            meta is None or torch.equal(meta, plain_tex[1]))
        if meta is not None and plain_tex is not None:
            pairs.append((meta, plain_tex[1]))
        tab_err = max(float((a.double() - b.detach().double()).abs().max()) for a, b in pairs)
        pack_err = max(pack_err, tab_err)
        n = scene.objects.count
        block = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (n + 1, kb.GRAD_COLS)).astype(np.float32)).to(dev)
        counts = np.bincount(scene.objects.mat.cpu().numpy(),
                             minlength=scene.materials.pn.shape[0])
        worst, err = 0.0, 0.0
        for path, got, want in zip(
                [p for p, x in zip(rtt.scene_to_numpy(scene), scene.tensors())
                 if x.is_floating_point()],
                kp.pack_scene_vjp(scene, block),
                kp.pack_scene_vjp_plain(scene, kp.split_block(block, n))):
            a, b = got.cpu().numpy().astype(np.float64), want.cpu().numpy().astype(np.float64)
            err = max(err, float(np.abs(a - b).max()))
            shared = (counts > 1) if path.startswith("materials.") else np.zeros(a.shape, bool)
            if not np.array_equal(a[~shared], b[~shared]):
                raise SystemExit(f"chip_smoke: pull-back, {name}: {path} not bit-equal")
            if shared.any():
                worst = max(worst, float(np.linalg.norm(a[shared] - b[shared])
                                         / max(np.linalg.norm(b[shared]), 1e-30)))
        vjp_err = max(vjp_err, err)
        ok = same and worst <= 1e-6
        print(f"  {name}: tables and meta bit-equal {same} (max abs {tab_err:.3g}); pull-back "
              f"bit-equal on unshared entries, shared materials relative L2 {worst:.3g} "
              f"(budget 1e-6), max abs {err:.3g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the pack kernels, {name}: outside their budget")

    print("march kernel vs plain version:")
    for name, scene, cfg in march_cases:  # the plain images rendered in phase 2
        compare(name, march_plain[name], img(km.render_color_kernel(scene.to(dev), cfg)))
    golden = np.load(os.path.join(HERE, "tests", "goldens", "default_march_glow_160x120.npz"))["img"]
    got = img(km.render_color_kernel(default.to(dev), rtt.RenderConfig(
        xres=160, yres=120, refraction_unroll=None, **glow)))
    compare("march kernel vs golden default_march_glow_160x120", golden, got)
    for name, scene, cfg in floor_tail_scenes(rtt):
        scene = scene.to(dev)
        knife_edge_only(f"tail on vs off, {name}", img(km.render_color_kernel(scene, cfg)),
                        img(km.render_color_kernel(scene, cfg.with_(march_floor_skip=False))))

    print("backward kernel vs torch autograd of the plain version:")

    def banded_blocks(name, scene, cfg, g, kernels):
        """Each windowed backward wrapper in ``kernels`` on the whole frame
        against the same wrapper on partition()'s bands of rows (the
        cotangent planes cut to each band): the blocks' sum within
        REGIME_REL_L2 of the whole frame's (the atomics add in another
        order), each band's image the whole frame's rows bit for bit."""
        for k in kernels:
            whole, prim = k(scene, cfg, g, return_primal=True)
            parts = [k(scene, cfg, rtt.Color(*(c[r0:r0 + h] for c in g)), return_primal=True,
                       origin=(r0, 0), shape=(h, cfg.xres))
                     for r0, h in partition(cfg.yres)]
            flat = torch.cat([t.flatten() for t in whole])
            summed = sum(torch.cat([t.flatten() for t in part]) for part, _ in parts)
            rel = float((summed - flat).norm() / flat.norm())
            same = all(torch.equal(torch.stack(list(band)), torch.stack(list(prim))[:, r0:r0 + h])
                       for (_, band), (r0, h) in zip(parts, partition(cfg.yres)))
            print(f"  {name}, {k.__module__.split('.')[-1]}: the whole frame against "
                  f"{len(parts)} bands of rows: blocks within {rel:.3g} (REGIME_REL_L2), images "
                  f"bit-equal {same}")
            if rel > REGIME_REL_L2 or not same:
                raise SystemExit(f"chip_smoke: {name}: the whole frame is not its bands")

    def grad_case(name, scene, cfg, seed=0, bwd=kb, fwd=kt.render_color_plain,
                  budget=GRAD_BUDGET, bit_equal=False, kernels=None, agree_with=None,
                  rows=None, plain=None):
        """The table cotangents of each kernel wrapper in ``kernels`` (by
        default ``[bwd.render_grads_kernel]``) against one call of autograd
        of the plain version (``kernel_trace_bwd.plain_vjp``, the function
        of every backward's ``render_grads_plain``) on the same inputs,
        mapped to the scene's leaves, and each one's image against ``fwd``'s
        (on every pixel when ``bit_equal``); returns each kernel's largest
        relative L2 and the plain version's ms (one call, CUDA events).
        With ``agree_with`` (a function giving the plain version's image;
        the plain version itself takes the plain call's own image, so the
        plain forward renders once), the
        JAX package's two steps (tests/test_pallas_bwd.py:29-72, 306-321):
        ``fwd``'s image agrees with it within 1e-4 on more than 90% of
        pixels, each other pixel on a decision boundary, and the cotangent
        planes are zero there. With ``rows`` (check_rows of a main path's
        frame), the plain version covers those rows alone, in one call: the
        kernels launch on the whole frame with the cotangent planes zero
        off those rows, and each windowed kernel's whole-frame block (the
        planes on every row) is held against the sum of its blocks on
        partition()'s bands (REGIME_REL_L2), their images the whole frame's
        bit for bit. ``plain`` is ``(image, vjp, ms)`` of such a plain call
        made before (phase 2's, the plain child's: ``PlainChildren.plain``)."""
        scene = scene.to(dev)
        g = cotangent_planes(torch, rtt, seed, cfg, dev)
        kernels = kernels or [bwd.render_grads_kernel]
        if rows is not None:
            banded_blocks(name, scene, cfg, g,
                          [k for k in kernels if k is not kr.render_grads_retrace])
        torch.cuda.reset_peak_memory_stats()
        if plain is None:
            (plain_img, vjp), plain_ms = event_ms(
                torch, lambda: kb.plain_vjp(scene, cfg, rows=rows))
            plain_img = img(plain_img)
        else:
            plain_img, vjp, plain_ms = plain
        if agree_with is not None:
            ref_img = (plain_img if agree_with is kt.render_color_plain
                       else img(agree_with(scene, cfg)))
            agree = np.abs(img(fwd(scene, cfg)) - ref_img).max(-1) < 1e-4
            flat = off_boundary(ref_img, ~agree)
            print(f"  {name}: forwards agree on {agree.mean():.4%} of pixels, "
                  f"{int((~agree).sum())} masked, {flat} of them off a decision boundary")
            if not agree.mean() > 0.9 or flat:
                raise SystemExit(f"chip_smoke: {name}: the forwards disagree off the boundaries")
            g = rtt.Color(*(c * torch.from_numpy(agree).to(dev) for c in g))
        if rows is not None:
            on = torch.zeros(cfg.yres, 1, device=dev)
            on[rows] = 1.0
            g = rtt.Color(*(c * on for c in g))
        outs = [k(scene, cfg, g, return_primal=True) for k in kernels]
        want, vjp_ms = event_ms(torch, lambda: vjp(rtt.Color(*(
            c if rows is None else c[rows] for c in g))))
        plain_ms += vjp_ms
        peak = torch.cuda.max_memory_allocated()
        plain_fwd = fwd is kt.render_color_plain
        ref = plain_img if plain_fwd else img(fwd(scene, cfg))
        sel = rows if rows is not None and plain_fwd else slice(None)
        where = f" on {len(rows)} rows" if rows is not None else ""
        errs = []
        for k, (got, prim) in zip(kernels, outs):
            label = name if len(kernels) == 1 else f"{name}, {k.__name__}"
            agree = float((img(prim)[sel] == ref).all(-1).mean())
            worst, worst_leaf = leaf_err(label, scene, got, want)
            ok = worst <= budget
            print(f"  {label}: image bit-equal to {fwd.__module__}.{fwd.__name__}'s on "
                  f"{agree:.4%} of pixels, largest leaf relative L2 {worst:.3g} ({worst_leaf}), "
                  f"plain autograd{where} {plain_ms:.1f} ms, peak {peak / 2**30:.2f} GiB -> "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: {label}: {worst_leaf} off by relative L2 "
                                 f"{worst:.3g}")
            if bit_equal and agree < 1.0:
                raise SystemExit(f"chip_smoke: {label}: the image is not {fwd.__name__}'s")
            errs.append(worst)
        return errs, plain_ms

    for name, scene, cfg in [
        ("default 320x240", default, rtt.RenderConfig(xres=320, yres=240)),
        ("default 320x240 refraction_unroll=None", default,
         rtt.RenderConfig(xres=320, yres=240, refraction_unroll=None)),
        ("40 objects 320x240", spheres_scene(rtt, 7, 39),
         rtt.RenderConfig(xres=320, yres=240, max_refractions=1)),
        ("101 objects 160x120", spheres_scene(rtt, 11, 100), rtt.RenderConfig(xres=160, yres=120)),
        # lanes of a warp that hit different objects (the scatter's groups)
        ("70 spheres 160x120", spheres_scene(rtt, 3, 70), rtt.RenderConfig(xres=160, yres=120)),
        # 63 sites a pixel at most: the trace backward's 64-site records
        ("default 160x120 4 reflections refraction_unroll=None", default,
         rtt.RenderConfig(xres=160, yres=120, max_reflections=4, refraction_unroll=None)),
    ]:
        grad_case(name, scene, cfg)
    # the main path's shape, or the largest whose plain autograd graph fits;
    # the trace backward and the re-trace oracle (the gradient oracle's main
    # path: the same cotangent planes) against one plain call
    for pw, ph in ((W, H), (1280, 720), (960, 540)):
        try:
            (bwd_max_err, retrace_max_err), bwd_plain_ms = grad_case(
                f"default {pw}x{ph}", default, cfg_main.with_(xres=pw, yres=ph),
                kernels=[kb.render_grads_kernel, kr.render_grads_retrace], rows=check_rows(ph))
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"  default {pw}x{ph}: the plain autograd graph does not fit the card: {e}")
            torch.cuda.empty_cache()
    else:
        raise SystemExit("chip_smoke: the plain autograd graph fits at no shape tried")
    cfg_plain = cfg_main.with_(xres=pw, yres=ph)  # where the plain versions are timed

    print("textured backward kernel (K2's textured sites) vs torch autograd of the plain "
          "version, its image vs the trace kernel's:")
    tex_grad = dict(fwd=kt.render_color_kernel, bit_equal=True)
    grad_case("textured Bilinear 32x16 (tests/test_pallas_bwd.py:140)", textured_bwd_scene(rtt),
              rtt.RenderConfig(xres=32, yres=16, max_reflections=2, refraction_unroll=1,
                               grad_distance_cutoff=2e3), **tex_grad)
    grad_case("textured Nearest 320x240", tex_scenes[0], rtt.RenderConfig(xres=320, yres=240),
              **tex_grad)
    (tex_bwd_err,), tex_bwd_plain_ms = grad_case(f"textured Bilinear {pw}x{ph}", tex_scenes[1],
                                                  cfg_plain, rows=check_rows(ph), **tex_grad)

    print("march backward kernel vs torch autograd of the plain march (implicit VJP), its "
          "image vs the march kernel's:")
    # K4's image against K3's bit for bit; the floor tail flips knife-edge
    # pixels against the plain march, so the cotangent covers the pixels
    # where K3's image agrees with the plain version's
    mgrad = dict(bwd=kmb, fwd=km.render_color_kernel, budget=MARCH_GRAD_BUDGET, bit_equal=True,
                 agree_with=km.render_color_plain)
    glowing40 = spheres_scene(rtt, 7, 39, glow_dist=3.0)
    for name, scene, cfg in [
        ("march default 320x240", default, rtt.RenderConfig(xres=320, yres=240, **glow)),
        ("march default 320x240 no glow", default,
         rtt.RenderConfig(xres=320, yres=240, use_raymarching=True)),
        ("march default 160x120 refraction_unroll=None", default,
         rtt.RenderConfig(xres=160, yres=120, refraction_unroll=None, **glow)),
        ("march 40 objects 160x120", glowing40,
         rtt.RenderConfig(xres=160, yres=120, max_refractions=1, **glow)),
    ]:
        first = name == march_cases[0][0]  # phase 2's plain call serves it
        grad_case(name, scene, cfg, plain=march_first_plain if first else None, **mgrad)

    def march_grad_main(name, scene, key):
        """``grad_case`` at the march training path's frame (the plain
        autograd on check_rows), or the largest whose plain autograd graph
        fits; at that frame the agreement's reference image is the march
        kernel's with the tail off (bit for bit the plain version on the
        checked rows, above), a thousandth of the plain march's time; the
        plain autograd there is the plain child's job ``key``. Returns the
        largest relative L2, the plain version's ms and the frame."""
        for pw_m, ph_m in ((MW, MH), (960, 540), (640, 360)):
            try:
                main_frame = (pw_m, ph_m) == (MW, MH)
                (err,), plain_ms = grad_case(
                    f"{name} {pw_m}x{ph_m}", scene, cfg_march.with_(xres=pw_m, yres=ph_m),
                    rows=check_rows(ph_m) if main_frame else None,
                    plain=children.plain(torch, key, dev) if main_frame else None,
                    **{**mgrad, "agree_with": (
                        (lambda s, c: km.render_color_kernel(s, c.with_(march_floor_skip=False)))
                        if main_frame else km.render_color_plain)})
                return err, plain_ms, (pw_m, ph_m)
            except torch.cuda.OutOfMemoryError as e:
                print(f"  {name} {pw_m}x{ph_m}: the plain autograd graph does not fit the card: "
                      f"{e}")
                torch.cuda.empty_cache()
        raise SystemExit(f"chip_smoke: {name}: the plain march autograd graph fits at no shape "
                         f"tried")

    print("march kernel at the main path's shape vs plain version (the plain child's rows), "
          "floor tail off bit for bit, on vs off knife-edge-only:")
    got, ref, march_plain_ms, rows = rows_both(default, cfg_march, km, "march_default")
    march_max_abs_err = compare(f"march default {MW}x{MH} (the main path's shape) on "
                                f"{len(rows)} rows", ref, got[rows])
    off = img(km.render_color_kernel(default.to(dev), cfg_march_off))
    same = float((off[rows] == ref).all(-1).mean())
    print(f"  tail off, default {MW}x{MH}: bit-equal to the plain version on {same:.4%} of the "
          f"pixels of {len(rows)} rows -> {'ok' if same == 1.0 else 'FAIL'}")
    if same < 1.0:
        raise SystemExit("chip_smoke: the march kernel with the tail off is not its plain version")
    knife_edge_only(f"tail on vs off, default {MW}x{MH}", got, off)
    print("textured march kernel (K3 reading the atlas) vs plain version: tail off bit for bit, "
          "tail on within the budget, on vs off knife-edge-only:")
    march_tex_err, march_tex_plain_ms = {}, {}
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        got, ref, march_tex_plain_ms[f], rows = rows_both(tex_scenes[f], cfg_march, km,
                                                          f"march_tex{f}")
        march_tex_err[f] = compare(f"march textured {fname} {MW}x{MH}, tail on, on {len(rows)} "
                                   f"rows", ref, got[rows])
        off = img(km.render_color_kernel(tex_scenes[f], cfg_march_off))
        same = float((off[rows] == ref).all(-1).mean())
        print(f"  march textured {fname} {MW}x{MH}, tail off: bit-equal to the plain version on "
              f"{same:.4%} of the pixels of {len(rows)} rows (plain {march_tex_plain_ms[f]:.1f} "
              f"ms) -> {'ok' if same == 1.0 else 'FAIL'}")
        if same < 1.0:
            raise SystemExit(f"chip_smoke: textured K3 ({fname}), tail off, is not its plain "
                             f"version")
        small = cfg_march.with_(xres=320, yres=240)
        knife_edge_only(f"textured {fname} tail on vs off 320x240",
                        img(km.render_color_kernel(tex_scenes[f], small)),
                        img(km.render_color_kernel(tex_scenes[f],
                                                   small.with_(march_floor_skip=False))))

    march_bwd_max_err, march_bwd_plain_ms, (pw_m, ph_m) = march_grad_main(
        "march default", default, "march_default")

    print("textured march backward (K4's textured instance) vs torch autograd of the plain "
          "textured march, its image vs the march kernel's:")
    # two small cases with a 2000-step budget (the plain march's time is its
    # longest lane's steps), then the march training path's frame
    cfg_tex_grad = rtt.RenderConfig(xres=160, yres=120, march_max_iter=2000, **glow)
    march_tex_bwd_err, march_tex_bwd_plain_ms = {}, {}
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        _, march_tex_bwd_plain_ms[f"{fname} 160x120"] = grad_case(
            f"march textured {fname} 160x120 march_max_iter=2000", tex_scenes[f], cfg_tex_grad,
            **mgrad)
    for f, fname in ((0, "Nearest"), (1, "Bilinear")):
        march_tex_bwd_err[fname], march_tex_bwd_plain_ms[fname], march_tex_bwd_frame = (
            march_grad_main(f"march textured {fname}", tex_scenes[f], f"march_tex{f}"))

    print("re-trace gradient oracle (K5) vs torch autograd of the plain trace, its image vs "
          "the trace kernel's:")
    grad_case("retrace default 320x240", default, rtt.RenderConfig(xres=320, yres=240), bwd=kr,
              kernels=[kr.render_grads_retrace], fwd=kt.render_color_kernel, bit_equal=True)

    # 4. the main paths
    poses = [((0.0, -150.0, -300.0), (0.0, -np.pi / 2, -np.pi / 2)),
             ((120.0, -120.0, -320.0), (0.0, -np.pi / 2 + 0.2, -np.pi / 2)),
             ((-80.0, -60.0, -280.0), (-0.15, -np.pi / 2 - 0.1, -np.pi / 2))]
    scene_dev = default.to(dev)
    # each request's camera is built on the host, as the viewer parses it
    views = [default._replace(camera=Camera.from_pyr(rtt.v3(*p), rtt.v3(*a))).to(dev)
             for p, a in poses]

    def main_path(name, argv, cfg, mod, other):
        """The CLI then three viewer requests; ``mod``'s kernel must launch
        once per render and ``other``'s not at all. Returns the launches."""
        with tempfile.TemporaryDirectory() as td:
            png_path = os.path.join(td, "out.png")
            kt.LAUNCHES = km.LAUNCHES = kp.LAUNCHES = 0
            t0 = time.time()
            if cli.main(argv + ["-o", png_path]) != 0:
                raise SystemExit("chip_smoke: the CLI failed")
            frames = [rtt.render_u8(v, cfg) for v in views]
            torch.cuda.synchronize()
            main_s = time.time() - t0
            launches, stray, packs = mod.LAUNCHES, other.LAUNCHES, kp.LAUNCHES
            png = load_png(png_path)
        print(f"main path, {name}: CLI {cfg.xres}x{cfg.yres} + 3 render_u8 in {main_s:.2f} s, "
              f"{launches} kernel launches, {packs} pack launches")
        if launches != 4 or stray != 0 or packs != 4:
            raise SystemExit(f"chip_smoke: want 4 launches of the {name} kernel, 0 of the "
                             f"other and 4 of the pack on its main path, got {launches}, "
                             f"{stray} and {packs}")
        if png.shape != (cfg.yres, cfg.xres, 3):
            raise SystemExit(f"chip_smoke: PNG decodes to {png.shape}")
        if not np.array_equal(png, frames[0]):
            raise SystemExit("chip_smoke: the CLI's PNG differs from render_u8 of the same view")
        for i, f in enumerate(frames):
            if f.shape != (cfg.yres, cfg.xres, 3) or f.std() < 10:
                raise SystemExit(f"chip_smoke: view {i} looks empty ({f.shape}, std {f.std():.2f})")
        if np.array_equal(frames[0], frames[1]) or np.array_equal(frames[1], frames[2]):
            raise SystemExit("chip_smoke: different camera poses gave the same image")
        return launches

    launches = main_path("trace", [str(W), str(H)], cfg_main, kt, km)
    march_launches = main_path("march", [str(MW), str(MH), "-m", "-g", "1.0"], cfg_march, km, kt)

    # textured trace: the CLI where bar.png lies (the reference's Nearest),
    # then one Bilinear request
    png_path = os.path.join(tex_dir, "out.png")
    cwd = os.getcwd()
    kt.LAUNCHES = km.LAUNCHES = 0
    t0 = time.time()
    os.chdir(tex_dir)
    try:
        rc = cli.main([str(W), str(H), "-o", png_path])
    finally:
        os.chdir(cwd)
    frame_bi = rtt.render_u8(tex_scenes[1], cfg_main)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    tex_launches, stray = kt.LAUNCHES, km.LAUNCHES
    png = load_png(png_path)
    print(f"main path, textured trace: CLI {W}x{H} with bar.png + 1 Bilinear render_u8 in "
          f"{main_s:.2f} s, {tex_launches} kernel launches")
    if rc != 0 or tex_launches != 2 or stray != 0:
        raise SystemExit(f"chip_smoke: the textured main path: CLI exit {rc}, want 2 trace and "
                         f"0 march launches, got {tex_launches} and {stray}")
    if not np.array_equal(png, rtt.render_u8(tex_scenes[0], cfg_main)):
        raise SystemExit("chip_smoke: the CLI's PNG with bar.png is not the textured render")
    floor = slice(3 * H // 4, H)  # rows of floor below the spheres
    if np.array_equal(png[floor], rtt.render_u8(scene_dev, cfg_main)[floor]):
        raise SystemExit("chip_smoke: the CLI did not texture the floor with bar.png")
    if np.array_equal(png, frame_bi):
        raise SystemExit("chip_smoke: Nearest and Bilinear gave the same image")

    # configuration 3: the CLI's march + glow where bar.png lies (Nearest),
    # then one Bilinear request
    kt.LAUNCHES = km.LAUNCHES = kp.LAUNCHES = 0
    t0 = time.time()
    os.chdir(tex_dir)
    try:
        rc = cli.main([str(MW), str(MH), "-m", "-g", "1.0", "-o", png_path])
    finally:
        os.chdir(cwd)
    frame_bi = rtt.render_u8(tex_scenes[1], cfg_march)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    march_tex_launches, stray, packs = km.LAUNCHES, kt.LAUNCHES, kp.LAUNCHES
    png = load_png(png_path)
    print(f"main path, textured march (configuration 3): CLI {MW}x{MH} -m -g 1.0 with bar.png + "
          f"1 Bilinear render_u8 in {main_s:.2f} s, {march_tex_launches} march kernel launches, "
          f"{packs} pack launches")
    if rc != 0 or march_tex_launches != 2 or stray != 0 or packs != 2:
        raise SystemExit(f"chip_smoke: the textured march path: CLI exit {rc}, want 2 march, 0 "
                         f"trace and 2 pack launches, got {march_tex_launches}, {stray} and "
                         f"{packs}")
    if not np.array_equal(png, rtt.render_u8(tex_scenes[0], cfg_march)):
        raise SystemExit("chip_smoke: the march CLI's PNG with bar.png is not the textured render")
    mfloor = slice(3 * MH // 4, MH)
    if np.array_equal(png[mfloor], rtt.render_u8(scene_dev, cfg_march)[mfloor]):
        raise SystemExit("chip_smoke: the march CLI did not texture the floor with bar.png")
    if np.array_equal(png, frame_bi):
        raise SystemExit("chip_smoke: textured march in Nearest and Bilinear gave the same image")

    # training: the red material 0.1 redder in the target; the material
    # colours train (the camera and the geometry sit on knife edges of this
    # scene, the x = 0 plane and the horizon, where any step flips pixels)
    m = scene_dev.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    with torch.no_grad():
        target = rtt.render_color(scene_dev._replace(
            materials=m._replace(diffuse=m.diffuse._replace(r=red))), cfg_main).to_array()

    def colours(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    def train(name, cfg, target, lr, want, base=scene_dev):
        """Five sgd_train_step on the material colours of ``base`` against
        ``target``; the launches (K1, K2, K3, K4, the pack, the pull-back)
        must be ``want``. Returns the losses and the launches."""
        bm = base.materials
        s = base._replace(materials=bm._replace(diffuse=colours(bm.diffuse),
                                                specular=colours(bm.specular)))
        kt.LAUNCHES = kb.LAUNCHES = km.LAUNCHES = kmb.LAUNCHES = 0
        kp.LAUNCHES = kp.VJP_LAUNCHES = 0
        t0 = time.time()
        losses = []
        for _ in range(5):
            s, loss = sgd_train_step(s, cfg, target, lr=lr)
            losses.append(float(loss))
        torch.cuda.synchronize()
        train_s = time.time() - t0
        launches = (kt.LAUNCHES, kb.LAUNCHES, km.LAUNCHES, kmb.LAUNCHES, kp.LAUNCHES,
                    kp.VJP_LAUNCHES)
        print(f"main path, {name}: 5 sgd_train_step at {cfg.xres}x{cfg.yres} in {train_s:.2f} s, "
              f"launches (K1 trace, K2 trace backward, K3 march, K4 march backward, pack, "
              f"pull-back) {launches}, "
              f"losses " + ", ".join(f"{v:.6g}" for v in losses)
              + f"; red {float(s.materials.diffuse.r[2].detach()):.4f} (target 0.9, start 0.8)")
        if launches != want:
            raise SystemExit(f"chip_smoke: want launches {want} in {name}, got {launches}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise SystemExit(f"chip_smoke: the {name} loss did not fall: {losses}")
        return losses, launches

    _, train_launches = train("training", cfg_main, target, TRAIN_LR, (5, 5, 0, 0, 5, 5))
    tex_bi = tex_scenes[1]
    with torch.no_grad():
        tex_target = rtt.render_color(tex_bi._replace(materials=tex_bi.materials._replace(
            diffuse=tex_bi.materials.diffuse._replace(r=red))), cfg_main).to_array()
    tex_losses, tex_train_launches = train("textured training (Bilinear)", cfg_main, tex_target,
                                           TRAIN_LR, (5, 5, 0, 0, 5, 5), base=tex_bi)
    if not all(b < a for a, b in zip(tex_losses, tex_losses[1:])):
        raise SystemExit(f"chip_smoke: the textured training loss did not fall at every step: "
                         f"{tex_losses}")
    with torch.no_grad():
        march_target = rtt.render_color(scene_dev._replace(
            materials=m._replace(diffuse=m.diffuse._replace(r=red))), cfg_march).to_array()
    march_losses, march_train_launches = train("march training", cfg_march, march_target,
                                               MARCH_TRAIN_LR, (0, 0, 5, 5, 5, 5))
    if not all(b < a for a, b in zip(march_losses, march_losses[1:])):
        raise SystemExit(f"chip_smoke: the march training loss did not fall at every step: "
                         f"{march_losses}")
    # the textured march step (Bilinear: its uv carries a gradient), and
    # K4's image at its shape K3's bit for bit
    with torch.no_grad():
        march_tex_target = rtt.render_color(tex_bi._replace(materials=tex_bi.materials._replace(
            diffuse=tex_bi.materials.diffuse._replace(r=red))), cfg_march).to_array()
    march_tex_losses, march_tex_train_launches = train(
        "textured march training (Bilinear)", cfg_march, march_tex_target, MARCH_TRAIN_LR,
        (0, 0, 5, 5, 5, 5), base=tex_bi)
    if not all(b < a for a, b in zip(march_tex_losses, march_tex_losses[1:])):
        raise SystemExit(f"chip_smoke: the textured march training loss did not fall at every "
                         f"step: {march_tex_losses}")
    g_tex = rtt.Color(*(torch.from_numpy(np.random.default_rng(3).standard_normal((MH, MW))
                                         .astype(np.float32)).to(dev) for _ in range(3)))
    _, tex_prim = kmb.render_grads_kernel(tex_bi, cfg_march, g_tex, return_primal=True)
    same = float((img(tex_prim) == img(km.render_color_kernel(tex_bi, cfg_march))).all(-1).mean())
    print(f"  textured march backward {MW}x{MH}: image bit-equal to the march kernel's on "
          f"{same:.4%} of pixels")
    if same < 1.0:
        raise SystemExit("chip_smoke: textured K4's image is not K3's")

    # the gradient oracle at the trace main path's shape, held against K2
    rng = np.random.default_rng(0)
    g_oracle = rtt.Color(*(torch.from_numpy(rng.standard_normal((H, W)).astype(np.float32))
                           .to(dev) for _ in range(3)))
    kr.LAUNCHES = 0
    t0 = time.time()
    oracle, oracle_img = kr.render_grads_retrace(scene_dev, cfg_main, g_oracle,
                                                 return_primal=True)
    torch.cuda.synchronize()
    oracle_s = time.time() - t0
    retrace_launches = kr.LAUNCHES
    lanes = _build.load_cuda_library("trace_retrace").rt_trace_retrace_lanes()
    want_launches = 1  # one launch a cotangent
    # the oracle's use: the trace backward held against it (each was held
    # against plain autograd on these inputs in phase 3)
    retrace_err, retrace_leaf = leaf_err(
        "the gradient oracle", scene_dev, oracle,
        kb.render_grads_kernel(scene_dev, cfg_main, g_oracle))
    oracle_same = float((img(oracle_img) == img(kt.render_color_kernel(scene_dev, cfg_main)))
                        .all(-1).mean())
    print(f"main path, gradient oracle: render_grads_retrace {W}x{H} in {oracle_s:.2f} s, "
          f"{retrace_launches} re-trace launch ({lanes} lanes a pass), largest leaf relative L2 "
          f"against the trace backward {retrace_err:.3g} ({retrace_leaf}), image bit-equal to "
          f"the trace kernel's on {oracle_same:.4%} of pixels")
    if retrace_launches != want_launches:
        raise SystemExit(f"chip_smoke: want {want_launches} re-trace launches, got "
                         f"{retrace_launches}")
    if not retrace_err <= GRAD_BUDGET:
        raise SystemExit(f"chip_smoke: the oracle and the trace backward differ in "
                         f"{retrace_leaf} by relative L2 {retrace_err:.3g}")
    if oracle_same < 1.0:
        raise SystemExit("chip_smoke: the oracle's image is not the trace kernel's")

    file_s, cull_launches = scene_files(torch, rtt, cli, kt, km, kp, spheres_build(rtt, 11, 100))
    phase_s["3-4"] = time.time() - t_phase

    # 4b. many objects: K1b (the cull inside K1) against the full scan, the
    # scenes past 512 objects in K1-K4, max_reflections 8
    # the plain children share the card with nothing timed from here on
    print(f"the plain children done {children.wait_all():.1f} s after they started")
    t_phase = time.time()
    print("many objects (K1b, the per-tile cull inside K1; more than 512 objects; "
          "max_reflections 8):")

    def k1_turns(name, scene, cfg):
        """K1 through its wrapper with the cull and with pallas_prefilter
        off, bit for bit, then timed in turns (on, off, off, on: 3 warm-ups,
        10 frames each); returns the largest difference and the two means."""
        off_cfg = cfg.with_(pallas_prefilter=False)
        with torch.no_grad():
            on_img = img(kt.render_color_kernel(scene, cfg))
            err = float(np.abs(on_img - img(kt.render_color_kernel(scene, off_cfg))).max())
            runs = [(k, cuda_ms(torch, lambda c=c: kt.render_color_kernel(scene, c)))
                    for k, c in (("on", cfg), ("off", off_cfg), ("off", off_cfg), ("on", cfg))]
        means = [float(np.mean([ms for k, ms in runs if k == tag])) for tag in ("on", "off")]
        print(f"  K1 {name} {cfg.xres}x{cfg.yres}, cull on vs off: max abs {err} "
              f"({'bit-equal' if err == 0.0 else 'FAIL'}); " + ", ".join(
                  f"{k} {ms:.4f}" for k, ms in runs) + f" ms/frame ({card})")
        if err != 0.0 or not np.isfinite(on_img).all():
            raise SystemExit(f"chip_smoke: K1b, {name}: the cull changes the image")
        return err, means[0], means[1]

    conf4 = spheres_scene(rtt, 11, 100).to(dev)
    cull_err, cull_ms, nocull_ms = k1_turns("configuration 4, 101 objects", conf4, cfg_main)
    got, ref, cull_plain_ms = both(conf4, cfg_main)
    compare(f"K1 with the cull vs plain, 101 objects {W}x{H} (plain one frame "
            f"{cull_plain_ms:.0f} ms)", ref, got)
    counts = {k: ops_futures[k].result() for k in ("trace_fwd_cull", "trace_fwd_cull_1024")}
    for k, c in counts.items():
        print(f"  host counts, {k} {W}x{H}: {c[0]} f32 operations, objects tested by the cull "
              f"{c[3]}, primary lists {c[4] / c[5]:.2f} candidates a scan ({c[5]} scans), "
              f"shadow lists {c[6] / c[7]:.2f} ({c[7]} scans)")
    big_built = spheres_build(rtt, 11, 1023)
    big = big_built[0].to(dev)
    k1_turns("1024 objects", big, cfg_main)
    sw, sh = MANY_SMALL
    got, ref, big_plain_ms = both(big, rtt.RenderConfig(xres=sw, yres=sh))  # noqa: F841
    compare(f"K1 vs plain, 1024 objects {sw}x{sh} (plain one frame {big_plain_ms:.0f} ms)",
            ref, got)
    gw, gh = MANY_GRAD
    # the plain march's time is its longest lane's steps: a 2000-step budget
    cfg_big_march = rtt.RenderConfig(xres=gw, yres=gh, march_max_iter=2000, **glow)
    big_glow = spheres_scene(rtt, 11, 1023, glow_dist=3.0).to(dev)
    # one plain call under autograd: its image here, its vjp for K4 below
    (ref, big_vjp), big_march_plain_ms = event_ms(torch, lambda: kb.plain_vjp(big_glow,
                                                                             cfg_big_march))
    big_march_plain = (img(ref), big_vjp, big_march_plain_ms)
    compare(f"K3 vs plain, 1024 objects {gw}x{gh} march_max_iter=2000 (plain one frame under "
            f"autograd {big_march_plain_ms:.0f} ms)", big_march_plain[0],
            img(km.render_color_kernel(big_glow, cfg_big_march)))

    def regime_args(stem, scene, cfg, tail, cull=None):
        """Launcher ``stem``'s arguments after the field of view for
        ``scene`` under ``cfg``, ``tail`` its texture pointers; K1's cull as
        its wrapper takes it, unless ``cull`` forces it."""
        if cull is None:
            cull = kt.cull_on(cfg, scene.objects.count)
        return {"trace_fwd": kt.kernel_args(cfg) + tail + [int(cull)],
                "march_fwd": km.kernel_args(cfg) + tail,
                "trace_bwd": kb.kernel_args(cfg) + [kb.site_cap(cfg)] + tail,
                "march_bwd": kmb.kernel_args(cfg) + tail}[stem]

    def regime_launch(stem, scene, cfg, g=None, table_regime="", cull=None):
        """Launcher ``stem`` of the build ``stem + table_regime`` ("" stages
        the tables in shared memory, ``_build.GLOBAL_SUFFIX`` reads them from
        global memory) on ``scene`` packed once by the pack kernel (the
        closure holds the words): a function giving the image (a forward)
        or (block, image) for cotangent planes ``g`` (a backward)."""
        n = scene.objects.count
        words = kp.launch_pack(scene)
        ptrs, meta = kp.word_pointers(words, n)
        lib = _build.load_cuda_library(stem + table_regime)
        fn = getattr(lib, f"rt_{stem}")
        args = regime_args(stem, scene, cfg, kp.texture_pointers(scene, meta), cull)
        if g is None:
            return lambda words=words: kt.launch(lib, fn, ptrs, n, dev, cfg, args)
        return lambda words=words: kb.launch_block(lib, fn, ptrs, n, dev, cfg, args, g, True)

    def regimes(label, stem, scene, cfg, g=None, warm=3, reps=10):
        """``stem``'s two table regimes on the same words: the images bit
        for bit, a backward's blocks within relative L2 REGIME_REL_L2 (their
        atomics add in another order), then timed in turns (shared, global,
        global, shared). Returns the two means (ms) and the relative L2 (0
        for a forward)."""
        fns = {tag: regime_launch(stem, scene, cfg, g, suffix)
               for tag, suffix in (("shared", ""), ("global", _build.GLOBAL_SUFFIX))}
        with torch.no_grad():
            a, b = (f() for f in fns.values())
            rel = 0.0
            if g is not None:
                rel = float((a[0] - b[0]).norm() / b[0].norm())
                a, b = a[1], b[1]
            same = float((img(a) == img(b)).all(-1).mean())
            runs = [(tag, cuda_ms(torch, fns[tag], warm, reps))
                    for tag in ("shared", "global", "global", "shared")]
        means = [float(np.mean([ms for k, ms in runs if k == tag])) for tag in ("shared", "global")]
        print(f"  {stem} {label} {cfg.xres}x{cfg.yres}, tables staged vs read from global memory: "
              f"image bit-equal on {same:.4%} of pixels"
              + (f", blocks relative L2 {rel:.3g}" if g is not None else "") + "; "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in runs) + f" ms ({card})")
        if same < 1.0 or not rel <= REGIME_REL_L2 or not np.isfinite(img(a)).all():
            raise SystemExit(f"chip_smoke: {stem} {label}: the two table regimes disagree")
        return means[0], means[1], rel

    def staged(stem):
        """Backward ``stem`` on its shared-table build at any n, returning
        as the wrappers' ``render_grads_kernel(..., return_primal=True)``."""
        def fn(scene, cfg, g, return_primal=True):
            block, prim = regime_launch(stem, scene, cfg, g)()
            return kb.split_block(block, scene.objects.count), prim
        fn.__name__ = f"{stem} with its tables staged"
        return fn

    # K1b's rule: the cull only above kt.CULL_MIN_OBJECTS; below, on the
    # default scene's 5 objects, forced on against off
    fns = {c: regime_launch("trace_fwd", scene_dev, cfg_main, cull=c) for c in (True, False)}
    with torch.no_grad():
        forced_err = float(np.abs(img(fns[True]()) - img(fns[False]())).max())
        runs = [(c, cuda_ms(torch, fns[c])) for c in (True, False, False, True)]
    print(f"  K1 default scene (5 objects) {W}x{H} alone, the cull forced on vs off: max abs "
          f"{forced_err}; " + ", ".join(f"{'on' if c else 'off'} {ms:.4f}" for c, ms in runs)
          + f" ms ({card})")
    if forced_err != 0.0:
        raise SystemExit("chip_smoke: K1b forced on the default scene changes the image")

    # K2 and K4 (past kb.SHARED_TABLE_MAX: their global-table builds)
    # against one autograd call each; their shared-table builds, whose int64
    # block no longer fits 1 024 objects in a block's shared memory, on
    # SHARED_BWD_FIT objects against their own autograd call
    _, big_bwd_plain_ms = grad_case(f"1024 objects {gw}x{gh}", big,
                                    rtt.RenderConfig(xres=gw, yres=gh),
                                    kernels=[kb.render_grads_kernel])
    _, big_march_bwd_plain_ms = grad_case(
        f"march 1024 objects {gw}x{gh} march_max_iter=2000", big_glow, cfg_big_march,
        kernels=[kmb.render_grads_kernel], plain=big_march_plain, **mgrad)
    fit, fit_glow = (spheres_scene(rtt, 11, SHARED_BWD_FIT - 1, glow_dist=d).to(dev)
                     for d in (0.0, 3.0))
    fw, fh = gw // 2, gh // 2  # a quarter of the pixels: the plain autograd's cost
    grad_case(f"{SHARED_BWD_FIT} objects {fw}x{fh}", fit, rtt.RenderConfig(xres=fw, yres=fh),
              kernels=[staged("trace_bwd")])
    grad_case(f"march {SHARED_BWD_FIT} objects {fw}x{fh} march_max_iter=2000", fit_glow,
              cfg_big_march.with_(xres=fw, yres=fh), kernels=[staged("march_bwd")], **mgrad)
    # each kernel's two table regimes (the build a wrapper launches is chosen
    # by n against its SHARED_TABLE_MAX) at its threshold, where both fit its
    # launch shape, and at 1 024 objects, the shapes of the times below
    g_big = rtt.Color(*(torch.from_numpy(np.random.default_rng(5).standard_normal((H, W))
                                         .astype(np.float32)).to(dev) for _ in range(3)))
    g_bigm = rtt.Color(*(c[:MH, :MW].contiguous() for c in g_big))
    regime_ms = {}
    for stem, cfg, g, march, sizes in (
            ("trace_fwd", cfg_main, None, False, (kt.SHARED_TABLE_MAX, 1024)),
            ("march_fwd", cfg_march, None, True, (1024,)),
            ("trace_bwd", cfg_main, g_big, False, (kb.SHARED_TABLE_MAX, SHARED_BWD_FIT)),
            ("march_bwd", cfg_march, g_bigm, True, (kb.SHARED_TABLE_MAX, SHARED_BWD_FIT))):
        for n in sizes:
            scene = (big_glow if march else big) if n == 1024 else spheres_scene(
                rtt, 11, n - 1, glow_dist=3.0 if march else 0.0).to(dev)
            regime_ms[stem, n] = regimes(f"{n} objects", stem, scene, cfg, g,
                                         *((1, 3) if march else (3, 10)))
    # the backwards at 1 024 objects: the global-table build alone
    for stem, cfg, g, scene, reps in (("trace_bwd", cfg_main, g_big, big, (3, 10)),
                                      ("march_bwd", cfg_march, g_bigm, big_glow, (1, 3))):
        with torch.no_grad():
            regime_ms[stem, 1024] = (None, cuda_ms(torch, regime_launch(
                stem, scene, cfg, g, _build.GLOBAL_SUFFIX), *reps), 0.0)
    cli_file(torch, rtt, cli, kt, kp, big_built, W, H)
    print(f"  1024 objects ({card}), alone on words packed once, the build the wrappers launch: "
          f"K1 {W}x{H} with the cull {regime_ms['trace_fwd', 1024][1]:.3f} ms, K2 {W}x{H} with "
          f"the image {regime_ms['trace_bwd', 1024][1]:.3f} ms, K3 {MW}x{MH} -m -g 1.0 "
          f"{regime_ms['march_fwd', 1024][0]:.3f} ms, K4 {MW}x{MH} with the image "
          f"{regime_ms['march_bwd', 1024][1]:.3f} ms (plain versions at {gw}x{gh}: K2's "
          f"autograd {big_bwd_plain_ms:.0f} ms, K3's {big_march_plain_ms:.0f} ms, K4's autograd "
          f"{big_march_bwd_plain_ms:.0f} ms)")
    deep = cfg_main.with_(max_reflections=8)
    got, ref, deep_plain_ms = both(default, deep.with_(xres=sw, yres=sh))
    deep_err = compare(f"K1 max_reflections=8 vs plain, default {sw}x{sh} (plain one frame "
                       f"{deep_plain_ms:.0f} ms)", ref, got)
    with torch.no_grad():
        deep_img = img(kt.render_color_kernel(scene_dev, deep))
        deep_ms = cuda_ms(torch, lambda: kt.render_color_kernel(scene_dev, deep))
    if not np.isfinite(deep_img).all():
        raise SystemExit("chip_smoke: K1 at max_reflections=8 is not finite")
    print(f"  K1 max_reflections=8, default {W}x{H} (64-task stack): {deep_ms:.4f} ms/frame")
    phase_s["4b"] = time.time() - t_phase
    t_phase = time.time()

    # 5. times at the main path's shape, in turns, once the host is free
    ops = {name: f.result() for name, f in ops_futures.items()}
    counting.shutdown()
    plain = lambda: kt.render_color_plain(scene_dev, cfg_main)  # noqa: E731
    kernel = lambda: kt.render_color_kernel(scene_dev, cfg_main)  # noqa: E731
    with torch.no_grad():
        runs = [("plain", cuda_ms(torch, plain)), ("kernel", cuda_ms(torch, kernel)),
                ("kernel", cuda_ms(torch, kernel)), ("plain", cuda_ms(torch, plain))]
    print(f"forward {W}x{H}, default scene, default cfg ({card}):")
    for name, ms in runs:
        print(f"  {name}: {ms:.3f} ms/frame, {W * H / ms / 1e3:.1f} Mrays/s primary")
    k_ms = float(np.mean([ms for n, ms in runs if n == "kernel"]))
    p_ms = float(np.mean([ms for n, ms in runs if n == "plain"]))
    words_once = kp.launch_pack(scene_dev)
    alone = lambda: kt.render_words_kernel(scene_dev, words_once, cfg_main)  # noqa: E731
    with torch.no_grad():
        alone_runs = [(k, cuda_ms(torch, kernel if k == "wrapper" else alone))
                      for k in ("wrapper", "alone", "alone", "wrapper")]
    for name, ms in alone_runs:
        how = "through render_color_kernel" if name == "wrapper" else "alone on words packed once"
        print(f"  kernel {how}: {ms:.4f} ms/frame")
    k_alone_ms = float(np.mean([ms for n, ms in alone_runs if n == "alone"]))
    n_ops, _, shade_ops = ops["trace_fwd"][:3]
    print(f"  diagnostic: the body's object tests {n_ops} and shading and sky {shade_ops} f32 "
          f"operations (host count); with both, the kernel alone reaches "
          f"{(n_ops + shade_ops) / F32_OPS_PER_S / (k_alone_ms / 1e3):.1%} of "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s (the object tests alone: "
          f"{n_ops / F32_OPS_PER_S / (k_alone_ms / 1e3):.1%})")

    print(f"packing {W}x{H}, default scene ({card}): by CUDA events and by the host's clock "
          f"(100 calls enqueued)")
    g_block = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (scene_dev.objects.count + 1, kb.GRAD_COLS)).astype(np.float32)).to(dev)
    pack_fns = {"pack kernel (kernel_pack.launch_pack)": lambda: kp.launch_pack(scene_dev),
                "pack kernel and the cached atlas's arguments, textured Nearest":
                    lambda: kp.texture_pointers(tex_scenes[0], kp.word_pointers(
                        kp.launch_pack(tex_scenes[0]), tex_scenes[0].objects.count)[1]),
                "plain pack_scene": lambda: kt.pack_scene(scene_dev),
                "pull-back kernel (kernel_pack.pack_scene_vjp)":
                    lambda: kp.pack_scene_vjp(scene_dev, g_block),
                "plain pull-back (autograd of pack_scene)":
                    lambda: kp.pack_scene_vjp_plain(
                        scene_dev, kp.split_block(g_block, scene_dev.objects.count))}
    pack_ms = {}
    for name, fn in pack_fns.items():
        pack_ms[name] = cuda_ms(torch, fn)
        print(f"  {name}: {pack_ms[name]:.4f} ms by events, {host_ms(torch, fn):.4f} ms by the "
              f"host's clock")
    pack_ms = list(pack_ms.values())

    print(f"forward + backward {W}x{H}, default scene, default cfg ({card}):")
    def step(render, cfg, base=scene_dev):
        return training_step(torch, render, cfg, base)

    kernel_step = step(rtt.render_color, cfg_main)
    for _ in range(2):
        print(f"  step (kernels at {W}x{H}: render, MSE, gradient of every float leaf): "
              f"{cuda_ms(torch, kernel_step):.3f} ms by events")
    # the plain step is phase 3's plain autograd (the same render and
    # gradient, without the MSE): no yardstick of speed, not run twice
    print(f"  its plain twin (phase 3's plain autograd at {pw}x{ph} on {len(check_rows(ph))} "
          f"rows, one call): {bwd_plain_ms:.3f} ms")
    # the port's device_trace first, then the smoke's own profile of the step
    trace_frame(torch, rtt, scene_dev, cfg_main)
    busy, span, names = device_busy(torch, kernel_step)
    print(f"  step through the kernels: {host_ms(torch, kernel_step, reps=20):.3f} ms by the "
          f"host's clock (20 steps enqueued), the card busy {busy:.3f} ms of a span of "
          f"{span:.3f} ms (idle share {1 - busy / span if span else float('nan'):.3f})")
    packs = [sum(c for k, c in names.items() if f"{kernel}(" in k)
             for kernel in ("pack_scene_kernel", "pack_scene_vjp_kernel")]
    print(f"  profiled step: {sum(names.values()):.1f} kernels, copies and sets a step, of "
          f"them {packs[0]:.1f} pack and {packs[1]:.1f} pull-back launches")
    if names and packs != [1, 1]:
        raise SystemExit("chip_smoke: the profiled step is not one pack and one pull-back")
    rng = np.random.default_rng(0)

    def planes(cfg):
        return rtt.Color(*(torch.from_numpy(rng.standard_normal((cfg.yres, cfg.xres))
                                            .astype(np.float32)).to(dev) for _ in range(3)))

    g_main = planes(cfg_main)

    def bwd_times(scene, name):
        """The backward kernel at the main path's shape, with the image, in
        turns through its wrapper (packing included) and alone on words
        packed once; returns the means (wrapper, alone)."""
        words = kp.launch_pack(scene)
        fns = {"wrapper": lambda: kb.render_grads_kernel(scene, cfg_main, g_main,
                                                         return_primal=True),
               "alone": lambda: kb.launch_words(scene, words, cfg_main, g_main, True)}
        runs = [(k, cuda_ms(torch, fns[k])) for k in ("wrapper", "alone", "alone", "wrapper")]
        for k, ms in runs:
            print(f"  backward kernel, {name} {W}x{H} with the image, "
                  f"{'through its wrapper' if k == 'wrapper' else 'alone on packed words'}: "
                  f"{ms:.3f} ms")
        return tuple(float(np.mean([ms for kind, ms in runs if kind == k])) for k in fns)

    bwd_ms, bwd_alone_ms = bwd_times(scene_dev, "untextured")
    _, _, adds, pairs, sites, most = ops["trace_bwd"]
    print(f"  host counts, {W}x{H}, cotangent 1 on every pixel: {adds} accumulator adds lane "
          f"by lane, {pairs} distinct (warp of 32 pixels, entry) pairs, {sites} sites "
          f"({sites / (W * H):.3f} a pixel, at most {most})")
    print(f"  its plain version (autograd of the plain trace) at {pw}x{ph} on "
          f"{len(check_rows(ph))} rows: {bwd_plain_ms:.3f} ms (one call, phase 3)")

    print(f"textured forward and training step {W}x{H}, default scene with bar.png ({card}):")
    with torch.no_grad():
        tex_runs = [(f, cuda_ms(torch, lambda f=f: kt.render_color_kernel(tex_scenes[f], cfg_main)))
                    for f in (0, 1, 1, 0)]
    tex_k_ms = {f: float(np.mean([ms for g, ms in tex_runs if g == f])) for f in (0, 1)}
    for f, ms in tex_runs:
        print(f"  kernel, {('Nearest', 'Bilinear')[f]}: {ms:.3f} ms/frame (plain "
              f"{tex_plain_ms[f]:.1f} ms, one frame, phase 3)")
    tex_step_ms = cuda_ms(torch, step(rtt.render_color, cfg_main, base=tex_bi))
    print(f"  step through the kernels, Bilinear (render, MSE, gradient of every float leaf): "
          f"{tex_step_ms:.3f} ms")
    tex_bwd_ms, tex_bwd_alone_ms = bwd_times(tex_bi, "Bilinear")
    print(f"  its plain version at {pw}x{ph} on {len(check_rows(ph))} rows: "
          f"{tex_bwd_plain_ms:.3f} ms (one call, phase 3)")

    print(f"gradient oracle {W}x{H}, default scene, default cfg ({card}):")
    oracle_words = kp.launch_pack(scene_dev)
    oracle_fns = {
        "oracle kernel (wrapper, with the image)":
            lambda: kr.render_grads_retrace(scene_dev, cfg_main, g_main, return_primal=True),
        "oracle kernel alone on packed words, with the image":
            lambda: kr.launch_words(scene_dev, oracle_words, cfg_main, g_main, True),
        "backward kernel (wrapper, with the image)":
            lambda: kb.render_grads_kernel(scene_dev, cfg_main, g_main, return_primal=True)}
    names = list(oracle_fns)
    oracle_runs = [(k, cuda_ms(torch, oracle_fns[k])) for k in names + names[::-1]]
    for name, ms in oracle_runs:
        print(f"  {name}: {ms:.3f} ms per cotangent")
    retrace_ms, retrace_alone_ms = (float(np.mean([ms for k, ms in oracle_runs if k == name]))
                                    for name in names[:2])
    print(f"  their plain version (autograd of the plain trace) at {pw}x{ph} on "
          f"{len(check_rows(ph))} rows: {bwd_plain_ms:.3f} ms (one call, above)")
    counts = ops["trace_retrace"]
    hist = counts[kr.HIST_SLOT:]
    print(f"  host counts, {W}x{H}: Dual passes of {lanes} lanes {counts[2]} "
          f"({counts[2] / (W * H):.4f} a pixel, at most {counts[3]}; a row of 32 pixels' "
          f"longest {counts[4] / (H * -(-W // 32)):.4f} on average; seeding every entry "
          f"{-(-kr.n_out(scene_dev.objects.count) // lanes)}); pixels by distinct winners "
          + ", ".join(f"{w}: {c}" for w, c in enumerate(hist) if c))

    print(f"march + glow forward, default scene, default cfg ({card}):")
    with torch.no_grad():
        march_ms = {}
        for w, h in ((MW, MH), (W, H), (320, 240)):
            c = cfg_march.with_(xres=w, yres=h)
            march_ms[(w, h)] = cuda_ms(torch, lambda c=c: km.render_color_kernel(scene_dev, c))
            print(f"  kernel {w}x{h}: {march_ms[(w, h)]:.3f} ms/frame")
    print(f"  plain {MW}x{MH} on {len(check_rows(MH))} rows: {march_plain_ms:.1f} ms (one call, "
          f"phase 3)")

    print(f"march + glow forward + backward {MW}x{MH}, default scene, default cfg ({card}):")
    march_step_ms = cuda_ms(torch, step(rtt.render_color, cfg_march))
    print(f"  step (march kernel + march backward kernel at {MW}x{MH}: render, MSE, gradient "
          f"of every float leaf): {march_step_ms:.3f} ms")
    print(f"  its plain twin (phase 3's plain autograd with the implicit VJP at "
          f"{pw_m}x{ph_m} on {len(check_rows(ph_m))} rows, one call): {march_bwd_plain_ms:.3f} ms")
    g_march = planes(cfg_march)
    march_bwd_ms = cuda_ms(torch, lambda: kmb.render_grads_kernel(scene_dev, cfg_march, g_march,
                                                                  return_primal=True))
    print(f"  march backward kernel alone at {MW}x{MH} (wrapper, with the image): "
          f"{march_bwd_ms:.3f} ms; its plain version at {pw_m}x{ph_m} on "
          f"{len(check_rows(ph_m))} rows: {march_bwd_plain_ms:.3f} ms (one call, phase 3)")

    print(f"textured march {MW}x{MH}, default scene with bar.png, -m -g 1.0, beside the "
          f"untextured in turns ({card}):")
    march_scenes = {"untextured": scene_dev, "Nearest": tex_scenes[0], "Bilinear": tex_scenes[1]}
    order = list(march_scenes) + list(march_scenes)[::-1]
    with torch.no_grad():
        k3_runs = [(k, cuda_ms(torch, lambda k=k: km.render_color_kernel(march_scenes[k],
                                                                        cfg_march)))
                   for k in order]
    k4_runs = [(k, cuda_ms(torch, lambda k=k: kmb.render_grads_kernel(
        march_scenes[k], cfg_march, g_march, return_primal=True))) for k in order]
    for (k, k3), (_, k4) in zip(k3_runs, k4_runs):
        print(f"  {k}: march kernel {k3:.3f} ms/frame, march backward {k4:.3f} ms (with the "
              f"image)")
    k3_tex_ms = {k: float(np.mean([ms for n, ms in k3_runs if n == k])) for k in march_scenes}
    k4_tex_ms = {k: float(np.mean([ms for n, ms in k4_runs if n == k])) for k in march_scenes}
    march_tex_step_ms = cuda_ms(torch, step(rtt.render_color, cfg_march, base=tex_bi))
    print(f"  textured march step, Bilinear (render, MSE, gradient of every float leaf): "
          f"{march_tex_step_ms:.3f} ms")
    print(f"  plain textured march {MW}x{MH} on {len(check_rows(MH))} rows: Nearest "
          f"{march_tex_plain_ms[0]:.1f} ms, Bilinear {march_tex_plain_ms[1]:.1f} ms (one call "
          f"each, phase 3); plain autograd (160x120 with march_max_iter=2000, and the textured "
          f"frame {march_tex_bwd_frame[0]}x{march_tex_bwd_frame[1]} on its check rows): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in march_tex_bwd_plain_ms.items())
          + " (phase 3)")
    print(f"  scene files (configuration 4), wall time a CLI request: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in file_s.items()))

    print(f"floor tail on and off in turns, {MW}x{MH}, default scene, -m -g 1.0 ({card}):")
    tail_runs = []
    for tag, c in (("on", cfg_march), ("off", cfg_march_off), ("off", cfg_march_off),
                   ("on", cfg_march)):
        with torch.no_grad():
            k3_ms = cuda_ms(torch, lambda c=c: km.render_color_kernel(scene_dev, c))
        k4_ms = cuda_ms(torch, lambda c=c: kmb.render_grads_kernel(scene_dev, c, g_march,
                                                                   return_primal=True))
        step_ms = cuda_ms(torch, step(rtt.render_color, c))
        tail_runs.append((tag, k3_ms, k4_ms, step_ms))
        print(f"  tail {tag}: march kernel {k3_ms:.3f} ms/frame, march backward {k4_ms:.3f} ms "
              f"(with the image), march training step {step_ms:.3f} ms")
    for name in ("march_fwd", "march_bwd"):
        for tag, key in (("on", name), ("off", f"{name}_off")):
            n_ops, _, px_ops, passes, px_passes, never = ops[key][:6]
            print(f"  counts, {name} {MW}x{MH}, tail {tag}: {n_ops} f32 operations, "
                  f"{passes} object passes, {never} marches ended by the never-converges "
                  f"test; the longest pixel {px_ops} operations, {px_passes} object passes")

    # roofline bounds from the operation counts of the main paths' frames
    bounds = {}
    for name, cfg, scene in (("trace_fwd", cfg_main, scene_dev),
                             ("march_fwd", cfg_march, scene_dev),
                             ("trace_bwd", cfg_main, scene_dev),
                             ("march_bwd", cfg_march, scene_dev),
                             ("trace_fwd_textured", cfg_main, tex_scenes[0]),
                             ("trace_bwd_textured", cfg_main, tex_bi),
                             ("march_fwd_textured", cfg_march, tex_scenes[0]),
                             ("march_fwd_textured_bilinear", cfg_march, tex_bi),
                             ("march_bwd_textured", cfg_march, tex_bi)):
        n_ops, fetched = ops[name][:2]
        nbytes = io_bytes(scene, cfg) + texel_bytes(scene, fetched)
        if "_bwd" in name:
            # + the cotangent planes read, the block written
            nbytes += 3 * 4 * cfg.xres * cfg.yres + 4 * (scene.objects.count + 1) * kb.GRAD_COLS
        bounds[name] = roofline(n_ops, nbytes)
        print(f"  bound, {name} {cfg.xres}x{cfg.yres}: {n_ops} f32 operations, {nbytes} bytes "
              f"({fetched} B of texel fetches) -> {bounds[name][0]:.4f} ms ({bounds[name][1]})")
        if name in ("march_fwd", "march_bwd"):  # the step-by-step march's work, a diagnostic
            off_ops = ops[f"{name}_off"][0]
            print(f"    with the floor tail off (diagnostic, not the bound): {off_ops} f32 "
                  f"operations -> {roofline(off_ops, nbytes)[0]:.4f} ms")
    bounds["pack_scene"] = roofline(0, pack_bytes(scene_dev))
    vjp_bytes, vjp_ops = pull_back_bytes_ops(scene_dev)
    bounds["pack_scene_vjp"] = roofline(vjp_ops, vjp_bytes)
    for name in ("pack_scene", "pack_scene_vjp"):
        print(f"  bound, {name}, default scene: {bounds[name][0]:.3g} ms ({bounds[name][1]})")
    # the re-trace oracle computes the trace backward's function on the same
    # inputs, so the least time for its work is the trace backward's bound;
    # its forward-mode operations are only a diagnostic
    bounds["trace_retrace"] = bounds["trace_bwd"]
    dual_ops = ops["trace_retrace"][0]
    print(f"  bound, trace_retrace {W}x{H}: the trace backward's, {bounds['trace_retrace'][0]:.4f} "
          f"ms ({bounds['trace_retrace'][1]}); its value pass and forward-mode operations "
          f"(diagnostic, not the bound): {dual_ops} -> {roofline(dual_ops, 0)[0]:.4f} ms")

    cull_ops = ops["trace_fwd_cull"][0]
    bounds["trace_fwd_cull"] = roofline(cull_ops, io_bytes(conf4, cfg_main))
    big_ops = ops["trace_fwd_cull_1024"][0]
    print(f"  bound, trace_fwd_cull {W}x{H}, 101 objects: {cull_ops} f32 operations -> "
          f"{bounds['trace_fwd_cull'][0]:.4f} ms ({bounds['trace_fwd_cull'][1]}); 1024 objects: "
          f"{big_ops} -> {roofline(big_ops, io_bytes(big, cfg_main))[0]:.4f} ms")
    phase_s["5"] = time.time() - t_phase

    # 6. the host apps
    t_phase = time.time()
    host_apps(torch, card)
    phase_s["6"] = time.time() - t_phase

    # 7. the multi-device layer
    t_phase = time.time()
    print("multi-device layer (parallel/shard.py, parallel/multihost.py):")
    md = multi_device(torch, rtt, kt, km, card, (default.to(dev), tex_scenes[0], conf4),
                      window_plain, march_plain["march default 320x240"], ops_futures)
    phase_s["7"] = time.time() - t_phase

    # 8. the multi-device layer's gradient half
    t_phase = time.time()
    print("multi-device layer, gradient half (parallel/train.py; K2 and K4 with a window):")
    md8 = sharded_grad(torch, rtt, card, (default.to(dev), tex_scenes[0]), grad_plain,
                       ops_futures)
    phase_s["8"] = time.time() - t_phase

    # 9. deep ray trees
    t_phase = time.time()
    deep = deep_trees(torch, rtt, cli, deep_refs, ops_futures)
    phase_s["9"] = time.time() - t_phase

    # 10. deep marches and large banks
    t_phase = time.time()
    deep += deep_marches(torch, rtt, cli, ops_futures, card, children)
    phase_s["10"] = time.time() - t_phase

    # 11. an atlas of 2^31 texels or more
    t_phase = time.time()
    print("an atlas of 2^31 texels or more (K1-K4's 64-bit texel index):")
    deep += huge_atlas(torch, rtt, card, ops)
    phase_s["11"] = time.time() - t_phase
    print(f"backward instances launched twice on the same inputs, each bit-equal: "
          f"{len(REPEATS)}: " + "; ".join(" ".join(k for k in key if k) for key in REPEATS))
    print("phase wall times: " + ", ".join(f"{k} {v:.0f} s" for k, v in phase_s.items()))

    if "jax" in sys.modules or "ray_rust_tpu" in sys.modules:
        raise SystemExit("chip_smoke: the port imported jax or the JAX package")
    print(json.dumps({"kernels": [{
        "name": "trace_fwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1275",
        "launches": launches, "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bounds["trace_fwd"][0], "bound_by": bounds["trace_fwd"][1],
        "library_ms": None,
    }, {
        "name": "trace_fwd_cull", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1109",
        "launches": cull_launches, "max_abs_err": cull_err, "ms": cull_ms,
        "off_ms": nocull_ms, "plain_ms": cull_plain_ms,
        "bound_ms": bounds["trace_fwd_cull"][0], "bound_by": bounds["trace_fwd_cull"][1],
        "library_ms": None,
    }, {
        "name": "trace_fwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:618",
        "launches": tex_launches, "max_abs_err": max(tex_err.values()), "ms": tex_k_ms[0],
        "plain_ms": tex_plain_ms[0],
        "bound_ms": bounds["trace_fwd_textured"][0],
        "bound_by": bounds["trace_fwd_textured"][1],
        "library_ms": None,
    }, {
        "name": "march_fwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_march.py:814",
        "launches": march_launches, "max_abs_err": march_max_abs_err,
        "ms": march_ms[(MW, MH)], "plain_ms": march_plain_ms,
        "bound_ms": bounds["march_fwd"][0], "bound_by": bounds["march_fwd"][1],
        "plain_rows": len(check_rows(MH)),
        "library_ms": None,
    }, {
        "name": "trace_bwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:563",
        "launches": train_launches[1], "max_abs_err": bwd_max_err, "ms": bwd_ms,
        "alone_ms": bwd_alone_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["trace_bwd"][0], "bound_by": bounds["trace_bwd"][1],
        "plain_rows": len(check_rows(ph)),
        "library_ms": None,
    }, {
        "name": "trace_bwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:563",
        "launches": tex_train_launches[1], "max_abs_err": tex_bwd_err, "ms": tex_bwd_ms,
        "alone_ms": tex_bwd_alone_ms, "plain_ms": tex_bwd_plain_ms,
        "bound_ms": bounds["trace_bwd_textured"][0],
        "bound_by": bounds["trace_bwd_textured"][1],
        "plain_rows": len(check_rows(ph)),
        "library_ms": None,
    }, {
        "name": "march_bwd", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:1060",
        "launches": march_train_launches[3], "max_abs_err": march_bwd_max_err,
        "ms": march_bwd_ms, "plain_ms": march_bwd_plain_ms,
        "bound_ms": bounds["march_bwd"][0], "bound_by": bounds["march_bwd"][1],
        "plain_rows": len(check_rows(ph_m)),
        "library_ms": None,
    }, {
        "name": "march_fwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_fwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_march.py:814",
        "launches": march_tex_launches, "max_abs_err": max(march_tex_err.values()),
        "ms": k3_tex_ms["Nearest"], "plain_ms": march_tex_plain_ms[0],
        "bound_ms": bounds["march_fwd_textured"][0], "bound_by": bounds["march_fwd_textured"][1],
        "plain_rows": len(check_rows(MH)),
        "library_ms": None,
    }, {
        "name": "march_bwd_textured", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/march_bwd.cu",
        "replaces": "ray_rust_tpu/ops/pallas_bwd.py:1060",
        "launches": march_tex_train_launches[3],
        "max_abs_err": max(march_tex_bwd_err.values()),
        "ms": k4_tex_ms["Bilinear"], "plain_ms": march_tex_bwd_plain_ms["Bilinear"],
        "bound_ms": bounds["march_bwd_textured"][0], "bound_by": bounds["march_bwd_textured"][1],
        "plain_rows": len(check_rows(march_tex_bwd_frame[1])),
        "library_ms": None,
    }, {
        "name": "pack_scene", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/pack_scene.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:127",
        "launches": train_launches[4], "max_abs_err": pack_err, "ms": pack_ms[0],
        "plain_ms": pack_ms[2], "bound_ms": bounds["pack_scene"][0],
        "bound_by": bounds["pack_scene"][1], "library_ms": None,
    }, {
        "name": "pack_scene_vjp", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/pack_scene.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1656",
        "launches": train_launches[5], "max_abs_err": vjp_err, "ms": pack_ms[3],
        "plain_ms": pack_ms[4], "bound_ms": bounds["pack_scene_vjp"][0],
        "bound_by": bounds["pack_scene_vjp"][1], "library_ms": None,
    }, {
        "name": "trace_retrace", "route": "cuda",
        "source": "ray_rust_tpu_torch/csrc/trace_retrace.cu",
        "replaces": "ray_rust_tpu/ops/pallas_trace.py:1555",
        "launches": retrace_launches, "max_abs_err": retrace_max_err, "ms": retrace_ms,
        "alone_ms": retrace_alone_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": bounds["trace_retrace"][0], "bound_by": bounds["trace_retrace"][1],
        "plain_rows": len(check_rows(ph)),
        "library_ms": None,
    }] + [{
        "name": f"{name}_window", "route": "cuda",
        "source": f"ray_rust_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": md["launches"][name], "max_abs_err": md["max_abs_err"][name],
        "ms": md["ms"][name], "plain_ms": md["plain_ms"][name],
        "bound_ms": md["bounds"][name][0], "bound_by": md["bounds"][name][1],
        "library_ms": None,
    } for name, replaces in (("trace_fwd", "ray_rust_tpu/ops/pallas_trace.py:1275"),
                             ("march_fwd", "ray_rust_tpu/ops/pallas_march.py:814"))] + [{
        "name": f"{name}_window", "route": "cuda",
        "source": f"ray_rust_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": md8["launches"][name], "max_abs_err": md8["max_abs_err"][name],
        "ms": md8["ms"][name], "main_ms": md8["main_ms"][name],
        "plain_ms": md8["plain_ms"][name],
        "bound_ms": md8["bounds"][name][0], "bound_by": md8["bounds"][name][1],
        "library_ms": None,
    } for name, replaces in (("trace_bwd", "ray_rust_tpu/ops/pallas_bwd.py:563"),
                             ("march_bwd", "ray_rust_tpu/ops/pallas_bwd.py:1060"))] + deep}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
