"""Drive the PyTorch/CUDA port (forward render and training step) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from csrc/ (one nvcc per source, in parallel): the
     seven of the render and training paths and the 23 capability-probe
     kernels of csrc/probes.cu, with each probe kernel's registers,
     shared memory and spill from ptxas, and every instance's of kernel 3
     (leaf width, slots a row load, shade) and of the bounce kernels 2, 4
     and 5 (sweep, tables, families);
  3. raygen kernel vs its plain version: random bits equal, o/d/g errors;
  4. brute-force bounce kernel vs the plain step on random states of seven
     scenes at the main path's full width (2,097,152 lanes), bounces 0, 3,
     7, 70, under the lane rules of lumillyrender_tpu_torch/parity.py, each
     scene's instance named (small or general sweep, Lambert or all
     families); then the instances of the narrower launches on each scene
     (the small sweep at 262,144 lanes where the scene fits, the group
     sweep at 16,384), bounce 3;
  5. the full-size new-cbox render (256^2, 64 spp in two 2M-lane chunks)
     through the CLI, with the launch counts of that run; then 64^2 x 8 spp
     films: the kernel path twice, and the plain path, all on the card;
     then the CLI again with --checkpoint, --telemetry and --profile (the
     chunk lines, the summary, the checkpoint, the trace's bounce kernels
     from inside the graph replays, and a rerun that resumes at the end);
  6. one new-cbox chunk (256^2 x 32 spp) in which every bounce launch, at
     each stage width (2,097,152 -> 32,768 -> 4,096 lanes), is checked
     against the plain step on the same state; timing of the captured
     stage plan (a ChunkRenderer's graph replays): forward rays/s, launches
     per chunk, the capture's seconds and the graph pool's bytes, the
     card's idle share; each kernel's bare launch time at each width beside
     its bound; each width's instance named (threads per lane at the
     narrow stages);
  7. BVH kernel vs the plain walk on welcome-geo (81,932 triangles): camera
     rays of one chunk and random rays at 2,072,576 lanes, with and without
     the shade outputs, capped occlusion queries and axis-aligned rays;
  8. BVH bounce kernel vs the plain step on random states of welcome-geo
     (IBL sky) and a ~9k-triangle terrain with spheres (uniform sky) at
     2,072,576 lanes, bounces 0, 3, 7, 70;
  9. the full-size welcome-geo render (512x368, 64 spp, hdr) through the
     CLI, and its --aov depth and --aov normal renders, with the launch
     counts of each run and no plain step or plain walk, every chunk a
     captured plan's and every chunk after a plan's first its replay (as
     in every CLI run of the script); 64x48 x 4 spp films of both, kernel
     path twice and plain path once;
 10. one welcome-geo chunk (2,072,576 lanes) in which every bounce launch
     (2,072,576 -> 259,072 -> 32,512 -> 4,096 lanes) is checked against the
     plain step; timing as in phase 6 (the captured plan), with the bounds counted from the
     plain walk's node visits and triangle tests; kernel 3 on the chunk's
     camera rays without and with the shade outputs, beside its bytes and
     operations bounds, with the node visits and triangle tests per ray;
 11. backward kernel vs plain_bounce_bwd on random states and cotangents
     of new-cbox, debug-nee and primitive at 1,048,576 lanes (the 16-spp
     training step's full width), bounces 0, 3, 7, 70, on parity.py's
     comparable lanes within parity.KERNEL_BWD_RTOL, with the recomputed
     alive' equal to the forward kernel's on every lane; then
     plain_bounce_bwd against autograd of the plain step at 65,536 lanes
     within parity.AUTOGRAD_BWD_RTOL;
 12. the training step: FD-vs-AD on the kernel path (12x12 Lambert scene:
     albedo, emission, sky, camera); then film_and_grads on new-cbox at
     256^2 x 4 and x 16 spp per step, Adam from a perturbed albedo toward a
     target rendered at the true one, every step with its counts zeroed
     just before and read just after (80 bounce and 80 bounce_bwd
     launches, no raygen, no plain step); gradients bit-equal over two
     runs, and against the plain path's (autograd of the plain step) on the
     card; then new-cbox with its material table tiled past BWD_MAX_ROWS
     (a Lambert-only scene the backward kernel refuses) through
     make_step_diff: the hybrid step, its gradients against autograd of
     the plain step;
 13. timing of the training step: fwd+bwd rays/s at 4 and 16 spp per step
     (rays counted as bench.py counts them), step time, idle share and
     PyTorch's reduce_kernel launches a step (the backward kernel sums its
     own row table); the backward kernel's bare launch at each stage width
     of a 16-spp step, with its instance, beside its bound and the plain
     backward's time;
 14. huge meshes: the AOV walks' ptxas lines (registers, shared memory,
     spill; one library, bvh_aov.cu, built in phase 2) and the blocks per
     SM they allow,
     the native BVH builder, terrain-1m and terrain-1.5m written
     (scene/terrain.py at 1M and 1.5M triangles, 256^2 x 64 spp pt-direct);
 15. the wide kernel (llr_bvh_wide, csrc/bvh_aov.cu) vs the plain walk on terrain-1m
     (K=128, admitted as wide): camera rays of one 2,097,152-lane chunk,
     random and axis-aligned rays at 2,097,152 lanes, with and without the
     shade outputs, capped occlusion queries, sorted and unsorted; t
     bit-equal, prims equal but on exact-t ties, verdicts equal;
 16. the streamed kernel (llr_bvh_streamed) the same way on
     terrain-1.5m (K=128, not admitted as wide: the auto route) and on
     terrain-1m built at K=32 with streamed=True;
 17. the BVH bounce kernel at K=128 vs the plain step on random states of
     terrain-1m at 2,097,152 lanes, bounces 0, 3, 7, 70;
 18. through the CLI (its scene load served from phases 15-16's compile
     of the same file), with launch counts and no plain step or walk:
     terrain-1m pt-direct at full size and its --aov depth and normal
     renders (bvh_wide), terrain-1.5m --aov depth (bvh_streamed) and
     terrain-1.5m pt-direct at full size (256^2 x 64 spp in two 2M-lane
     chunks: raygen and bounce_bvh alone, 80 bounce_bvh a chunk, the warp
     walk over 119 MB of K=128 tables); 64^2 x 4 spp films of terrain-1m,
     kernel path twice and plain path once, and of terrain-1.5m, whose
     plain path is the `fused="off"` step with kernel 6 its walk;
 19. timing on terrain-1m and terrain-1.5m: forward rays/s, launches per
     chunk, the capture and the idle share of the captured plan; the BVH
     bounce at K=128 at each stage width (on each stage's first state,
     against the plain step); the wide, streamed and per-thread walks
     (and the streamed one on terrain-1.5m), sorted and unsorted, on camera
     and random rays at 2,097,152 lanes beside their bounds and the plain
     walk; the sort itself, and whether the sorted walk plus the sort
     beats the unsorted walk, beside the route's default (no sort);
 20. the capability probes (lumillyrender_tpu_torch/probes/, the
     counterparts of the JAX package's Mosaic probes): their entry point
     once with every launch count zeroed just before and read just after
     (each of the 23 probe kernels launched, smem_input at each of its four
     table sizes); the kernels that read their inputs straight from L2
     (smem_input and scatter_add among them) use no shared
     memory (cudaFuncGetAttributes, and ptxas's line where probes.cu is
     built in the run); onehot_matmul_gather's grid, cluster size and
     static shared memory beside its ptxas line; each kernel bit-equal to
     its plain version; its bare launch (CUDA graph replay), median and
     range over replays taken in turns with the PyTorch call that
     computes the same function where there is one (checked bit-equal to
     the plain version first), beside its bound, the plain version and an
     empty kernel's launch (and, for onehot_matmul_gather, an empty kernel
     of its grid and clusters, without and with a cluster barrier); the
     probes whose median exceeds their call's, by factor;
     vmem_scalar_dynamic_read at 128 seeded index sets, smem_input on
     seeded tables at its four sizes, scatter_add on seeded index sets
     (wrapped and dropped indices) and while_walk_smem on seeded link
     tables bit-equal to their plain versions, while_walk_smem NaN on
     cyclic tables, its time over the empty launch a round of lookups
     beside its add chain's floor; smem_input's time at each size beside
     its add chain's floor;
 21. the captured forward stage loop against the host loop on new-cbox,
     welcome-geo and terrain-1m at full chunks: a fresh ChunkRenderer's
     eager first chunk and its first graph replay against the host loop
     (one read of the card per bounce) over the same kernels, every
     stage-end state (o, d, throughput, accum, alive, lane) and the ray
     count bit-equal, the films through check_films' gate; beside phases
     6, 10 and 19's chunk ms, busy ms, idle share, launches per chunk,
     capture seconds and pool bytes, the host loop's ms per chunk; then
     new-cbox and welcome-geo under `fused="off"` (the plain step's
     PyTorch ops as the captured plan, kernel 3 their walk on
     welcome-geo) held to the host loop over the plain step the same way,
     and their captured chunk timed (ms over two replays, busy ms and idle
     share, launches, capture seconds, pool bytes) beside the host loop's
     ms per chunk;
 22. data parallelism over ranks (lumillyrender_tpu_torch/parallel/shard.py):
     a world-size-1 NCCL group runs render_sharded on new-cbox at full size
     (32 and 16 spp a chunk) against render in chunks of the same size
     (launch counts and ray count equal, no plain step, the film within
     1e-5 of its max: the banks add with atomics, so not bit for bit),
     with its all-reduce's ms a chunk and rays/s beside phase 6's; then
     sharded_train_step at 4 spp (a training plan with the rank's offsets
     as a device input: its first call and a replay) against
     film_and_grads (its captured plan) on the same offsets (loss and every
     gradient bit-equal, 80 bounce and 80 bounce_bwd launches each call),
     and the sharded step eager and through the plan in turns (median,
     range, capture seconds, pool bytes); then two ranks in two processes
     of this script (`--dp-rank`) sharing the card over gloo, which
     all-reduces the CUDA tensors: each rank's launches half the one-rank
     run's, the film within 1e-5 of its max; each rank's sharded training
     step (its first call and a replay of its own plan, 80 + 80 launches at
     half the lanes), the same loss and gradients on both ranks, within
     1e-5 of the two blocks' eager steps added here;
 23. vr.toml on the card: the omnidirectional raygen against its plain
     version at 2,097,152 lanes (random bits equal, g = pdf = 1), timed
     beside its bound; the full-size render (256x128, 16 spp) through the
     CLI with its launch counts and no plain step; 64x32 x 8 spp films,
     kernel path twice and plain path once;
 24. the simple sky (meridian and horizon blended by |d.y|) in kernels 2
     and 4: new-cbox and welcome-geo under it, against the plain step on
     random states at full width, bounces 0, 3, 7, 70, timed beside the
     scene's own sky on one state; small films of each, kernel path twice
     and plain path once;
 25. differentiable BVH, IBL and simple-sky scenes (cuda_bounce.
     make_step_hybrid: kernel 4 or 2 forward, autograd of the plain step
     recomputed on the input state backward, its walk kernel 3 or 7
     through the plane-equation VJP): FD vs AD on welcome-geo at 64x48 x 4
     spp (the albedo, the IBL texel the paths reach most, the thin lens's
     focus distance); the eager step (`eager_film_and_grads`) on
     welcome-geo at 512x368 x 4 spp with its counts zeroed just before and
     read just after (80 bounce_bvh and 160 bvh launches, the plain step
     only inside the 80 recomputes, no plain walk), two runs bit-equal,
     then film_and_grads (the captured TrainPlan: its first call and a
     replay, counts zeroed around each) bit-equal to it with the same
     launches (the capture's seconds and pool bytes), then against the
     plain path (the plain walk) within TRAIN_PLAIN_RTOL; its step timed at 4 and 16 spp (ms, rays/s,
     busy and idle share, peak memory, kernel 3's launches and ms in the
     backward, the row gathers' gradient scatters) and those scatters
     alone at full width (autograd's index_put_, index_add_ and the
     port's table.scatter_rows); ibl-material at
     320x240 x 4 spp and its own 80 bounces (kernel 2, all families), new-cbox
     and welcome-geo under the simple sky (the gradients in its two
     colours) and terrain-1m at 64x64 x 1 spp (kernel 4 at K=128 forward,
     kernel 7 in the backward), each likewise: eager, the plan bit-equal
     to it, the plain path; the example
     examples/invert_materials_torch.py at its defaults (the albedo error
     falls by more than 2x);
 26. remat_policies: `fused="off"` (autograd of the plain step on the
     card, kernel 3 its walk) on welcome-geo's training step at 512x368 x
     4 spp under the recompute policies none, full, hybrid, isect and
     isect+samp: each eager step (`eager_film_and_grads`) with kernel 3's
     launches counted in the forward and the backward pass apart (160
     forward; 160 backward under full, twice the bounces of the stages
     wider than 48k lanes under hybrid, none under none and the isect
     ones), no plain walk and no other kernel; the loss, film and every
     gradient bit-equal across the five, and within TRAIN_PLAIN_RTOL of
     phase 25's default dispatch (the hybrid); then each policy through
     film_and_grads's captured plan (`policy_plan`: its first call and a
     replay at a new seed and albedo, each bit-equal to the eager step
     with the same launches, capture seconds and pool bytes; for
     REMAT_TIMED, one eager step and one replay in turns; for
     REMAT_PROFILED, a replay's busy ms, idle share and peak memory);
     terrain-1m at 64x64 x 1 spp under full and isect (kernel 7 the
     walk: 160 launches forward, 160 and 0 backward, the gradients
     bit-equal; the plan's first call and a replay bit-equal to the eager
     step with its launches); then new-cbox's 256^2 x 64 spp film under
     `fused="off"` (the plain step's brute force, each chunk size a
     captured plan) through check_films against the kernels' film at the
     same chunk width, its chunk ms beside phase 6's;
 27. the environment knobs: kernel 1's threefry instance (LLR_RNG=threefry)
     against its plain version at 2,097,152 lanes (random words bit-equal,
     on the card and on the CPU), timed in turns with its pcg4d instance,
     each beside its bound (the larger of its bytes and the operations a
     lane of the function needs, `raygen_ops`; the build's SASS per pipe
     printed beside it); the CLI under LLR_RNG=threefry without --fused off
     refused by name (a process of its own); a process of this script
     under LLR_RNG=threefry (`--knobs-child`): the CLI on new-cbox at full
     size with --fused off (raygen launched, no bounce kernel, the plain
     step only in the captured plan's first chunk and its capture, no
     chunk in the host loop, its chunk ms as the plan's replay), 64^2 x 8
     spp films on the card and on the CPU under threefry and pcg4d
     (CROSS_DEVICE's bounds, which the card's pcg4d film against the CPU's
     threefry film must fail), a welcome-geo training step at 512x368 x 4
     spp under fused="off" (kernel 3 its walk, loss and gradients finite),
     eager and then through film_and_grads's plan (first call and a
     replay bit-equal to it, the same launches); kernel 4 on
     welcome-geo built at K = 8, 16, 64 (LLR_TREELET_K) and 128
     (LLR_WIDE_MIN_TRIS) against the plain step at 2,072,576 lanes,
     bounces 0 and 70, and on one chunk's stage widths, timed beside
     its bounds; the CLI under LLR_FUSED=0, LLR_FUSED_BVH=0 (welcome-geo
     and new-cbox), LLR_PALLAS=0 and LLR_REORDER=1, each with its launch
     counts and plain-step and sort-key calls (every CLI run of the script
     with no chunk in the host loop);
 28. the hero scenes ridaisai and welcome (2138x1536, IBL, thin lens under
     one and two camera transforms) and BASELINE config 1, sample (512^2):
     kernel 1 against its plain version on ridaisai's and welcome's
     3,283,968-lane chunks (2x32 tiles), random bits equal; kernel 4
     against the plain step on random states of all three at 3,283,968
     lanes, bounces 0, 3, 7, 70 (refraction through closed meshes, GGX on
     triangles, pure pt); one camera chunk of ridaisai and of welcome with
     every bounce launch (3,283,968 -> 410,624 -> 51,456 -> 4,096 lanes)
     checked against the plain step, timed as in phase 10 (kernel 4 at
     each width beside its bound, the captured plan's chunk ms, rays/s,
     launches, capture, pool and idle share); the CLI at each TOML's own
     settings (sample 512^2 x 64 png, welcome x 64 hdr with --checkpoint
     every 16 spp, ridaisai x 4 hdr) with only raygen and bounce_bvh
     launched; 64x48 x 4 spp films of each, kernel path twice and plain
     path once; ridaisai's plain film on the card against the CPU's under
     CROSS_DEVICE, which its film of another seed must fail;
 29. the estimator gates (tools/torch_oracle_gate.py): the JAX package's
     oracle configs (pt-spheres, nee-phong-blinn, ggx, mesh-thinlens,
     ibl-refraction, omni) at ORACLE.json's size, seeds 9000-9009, through
     `render` (kernels 1 and 2, no plain step) against the independent
     oracle's committed stacks (tests/oracle_stacks.npz): frac(|z|>5) <
     0.008, untestable < 0.05, rel mean diff < 0.06 (0.15 ggx), each beside
     ORACLE.json's JAX row; the configs with triangles again under
     intersector="bvh" (kernel 4, not 2); controls on the card's stacks
     (x1.2 on each quadrant in turn, at least one failing a config; x1.5
     on 5% of the lit pixels printed);
     then tests/test_render.py's statistical gates through the kernels:
     the white furnace within 1e-3 of 1 and the gray furnace on its
     8-sample lattice at the test's 48^2 x 8 spp; the white furnace at
     256^2 x 32 spp (2,097,152 lanes) on its 32-sample lattice, with the
     samples trapped inside the sphere (as in the JAX package) under 1e-5
     of them; pt vs pt-direct (film
     means, and the per-pixel z on the big-lamp scene with its +50%
     control failing), compaction overflow through the captured plan
     (256 slots from bounce 2, 40 seeds each way, z < 4), tiled vs raster
     lane order (kernel 1's raster decode against its plain version) and
     many-light pt vs pt-direct (the step its 256 lights take, by the
     launch counts);
 30. the JAX package's gradient gates through the hybrid step
     (make_step_hybrid), each FD case through tools/torch_grad_gates.py's
     fd_vs_ad with the sign its AD must have: through kernel 2, the hybrid
     FD tests on tests/test_fused_bounce.py's GLOSSY_DIFF_SCENE (GGX
     roughness and reflectance), every family on ibl-material at 32x24 x 4
     spp and five bounces (GGX roughness, the Phong and Blinn-Phong
     exponents, the glass's absorbtance, IOR at steps of 1e-2 or less, and
     reflectance) and tests/test_torch_diff.py's hybrid cases on the mixed
     scene (roughness, IOR, camera), with the counts zeroed just before and
     read just after (bounce launched, no bounce_bwd, no bounce_bvh, no
     plain forward step, the recomputes), and each case's AD against the
     CPU's on the same inputs within CARD_CPU_RTOL; tests/test_diff.py's
     analytic direct view (the lamp's emission gradient, pt, one bounce,
     equal to the share of camera samples on the lamp over 3 and to the
     CPU's within 1e-6); then the heroes welcome, ridaisai (2138x1536 x 1
     spp, one 3,283,968-lane chunk) and sample (512^2 x 1) through kernel
     4: film_and_grads from the bunny rows' parameters perturbed toward the
     film at the true ones (80 bounce_bvh, kernel 3 in the 80 recomputes,
     no plain walk, two runs bit-equal, film_and_grads's captured plan
     bit-equal to the eager step with its launches, its capture seconds and
     pool bytes at hero width, against the plain path within
     TRAIN_PLAIN_RTOL, the bunny rows' gradients nonzero), the step's ms,
     busy ms, idle share and peak memory beside phase 25's welcome-geo
     step, and FD vs AD at that width through kernel 4 over the pixels the
     bunny's row moves (welcome's GGX roughness and reflectance; ridaisai's
     orange absorbtance and reflectance) and ridaisai's orange IOR over the
     pixels that cross no texel or edge inside the steps;
 31. (run after phase 13, in a process whose profiler is young) the
     training step as one captured program (`diff.TrainPlan`, which
     `film_and_grads` runs on the card): on new-cbox 256^2 x 4 spp (kernels
     2 + 5, the albedo and the uniform sky colour trained), welcome-geo
     512x368 x 4 (kernel 4, kernel 3 in the recomputes) and ibl-material
     320x240 x 4 at PLAN_IBL_BOUNCES bounces (kernel 2, the IBL texels'
     gradients), PLAN_STEPS Adam
     steps at new seeds, each taken eagerly (`eager_film_and_grads`) and
     through the plan (its first call eager and then captured, every later
     one a replay) with the counts zeroed just before and read just after
     each: loss, film and every gradient bit-equal, the same launches; then
     the eager step and the plan's in turns over PLAN_ROUNDS rounds (host
     clock to a synchronize: median and range), device busy ms and idle
     share of each (profiler; "not measured" where it lost records of the
     replay's kernels), the replay's span between CUDA events, peak memory,
     the capture's seconds and the graph pool's bytes; then the example
     examples/invert_materials_torch.py for PLAN_EXAMPLE_STEPS steps, its
     steps replays of one plan;
 32. (run after phase 19) the AOV chunks as captured plans: welcome-geo
     --aov depth and --aov normal (kernel 3), terrain-1m --aov depth
     (kernel 7), terrain-1.5m --aov depth (kernel 6) and welcome-geo --aov
     depth under LLR_REORDER=1 (kernel 3, the sort captured), each at the
     CLI's chunk size: a ChunkRenderer's first call (eager, then captured)
     and a replay at the next offset, each against the eager chunk with the
     counts zeroed just before and read just after each call, film and
     rays bit-equal, launches equal; the capture's seconds and pool bytes;
     the eager chunk and a replay in turns; two eager AOV renders of
     welcome-geo and terrain-1.5m bit-equal (the ordered bank), beside
     index_add_'s two banks of one chunk (the bank before);
then one `{"kernels": [...]}` line for all 30 kernels (kernel 1's with
both instances).
The last line is `{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SEED = 1234

# A scene with every BSDF family (tests/test_fused_bounce.py).
GGX_REFR_SCENE = """
[renderer]
samples = 4
integrator = "pt"

[film]
resolution = [16, 16]
output = "png"

[sky]
type = "uniform"
color = [0.6, 0.7, 0.9]

[camera]
type = "ideal-pinhole"
fov = 60
[[camera.transform]]
type = "look-at"
origin = [0, 1, 4]
target = [0, 1, 0]
up = [0, 1, 0]

[[object]]
mesh = "ball"
material = "rough"
[[object.transform]]
type = "translate"
vector = [-0.8, 0.6, 0]

[[object]]
mesh = "ball"
material = "glass"
[[object.transform]]
type = "translate"
vector = [0.8, 0.6, 0]

[[object]]
mesh = "ball"
material = "shiny"
[[object.transform]]
type = "translate"
vector = [0, 1.8, 0]

[[object]]
mesh = "ball"
material = "blinn"
[[object.transform]]
type = "translate"
vector = [0, 0.6, -1.6]

[[object]]
mesh = "floor"
material = "diffuse"
[[object.transform]]
type = "translate"
vector = [0, -1000, 0]

[[material]]
name = "rough"
type = "ggx"
reflectance = [0.9, 0.8, 0.7]
roughness = 0.4
ior = 1.8

[[material]]
name = "glass"
type = "ideal-refraction"
reflectance = [0.95, 0.95, 0.95]
ior = 1.5
absorbtance = 0.2

[[material]]
name = "shiny"
type = "phong"
reflectance = [0.8, 0.8, 0.8]
alpha = 40

[[material]]
name = "blinn"
type = "blinn-phong"
reflectance = [0.7, 0.8, 0.9]
alpha = 25

[[material]]
name = "diffuse"
type = "lambert"
albedo = [0.6, 0.5, 0.4]

[[mesh]]
name = "ball"
type = "sphere"
radius = 0.6

[[mesh]]
name = "floor"
type = "sphere"
radius = 1000
"""


# The 12x12 Lambert scene of the JAX package's backward-kernel FD gates
# (tests/test_fused_bounce.py): a sphere lamp and two Lambert balls.
LAMBERT_DIFF_SCENE = """
[renderer]
samples = 4
integrator = "pt-direct"
depth = 3
depth-limit = 8

[film]
resolution = [12, 12]
output = "png"

[sky]
type = "uniform"
color = [0.4, 0.5, 0.6]

[camera]
type = "ideal-pinhole"
fov = 45
[[camera.transform]]
type = "look-at"
origin = [165, 0, 135]
target = [165, 0, 165]
up = [0, 1, 0]

[[light]]
type = "area"
object = "lamp"
emission = [6, 5, 4]

[[object]]
name = "lamp"
mesh = "ball"
material = "black"
[[object.transform]]
type = "translate"
vector = [165, 9, 165]

[[object]]
mesh = "ball"
material = "diffuse"
[[object.transform]]
type = "translate"
vector = [163, 0, 165]

[[object]]
mesh = "ball"
material = "gray"
[[object.transform]]
type = "translate"
vector = [168, 0, 168]

[[material]]
name = "black"
type = "lambert"
albedo = [0, 0, 0]

[[material]]
name = "diffuse"
type = "lambert"
albedo = [0.6, 0.45, 0.3]

[[material]]
name = "gray"
type = "lambert"
albedo = [0.5, 0.5, 0.5]

[[mesh]]
name = "ball"
type = "sphere"
radius = 2
"""

def phase(name):
    print(f"\n== {name}", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unknown"


def events_ms(fn, reps: int) -> float:
    """Mean ms of `fn()` over `reps` runs between CUDA events (warm). Host
    work the device waits for (Python, launch calls) is inside the window."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device ms per call of `fn`: `reps` calls captured in a CUDA graph and
    replayed between CUDA events, so no host work is inside the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def trace_chunk(compiled, sample_offset, spp, raygen, step, seed=SEED):
    """One chunk of `compiled`'s film traced as render_chunk traces it, with
    the given raygen and bounce step: (film_sum (h*w, 3), rays)."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import global_lanes, tile_decode

    scene, st = compiled.data, compiled.settings
    w, h = st.width, st.height
    n = w * h * spp
    o, d, pdf, g = raygen(scene, st, seed, sample_offset, n)
    decode = tile_decode(st)
    pixel_fn = None
    if decode is not None:
        def pixel_fn(lane):
            px, py = decode(lane % (w * h))
            return py * w + px
    return wavefront.trace_film(
        scene, st, o, d, global_lanes(st, sample_offset, n, o.device), seed,
        g * scene.camera.sensor_sensitivity / pdf, w * h,
        pixel_fn=pixel_fn, step=step,
    )


def random_state(scene, n, seed, bounce):
    from lumillyrender_tpu_torch.convert import state_from_numpy

    g = scene.geometry
    pts = torch.cat([g.tri_p0, g.sph_c]).cpu().numpy()
    pts = pts[np.abs(pts).max(axis=1) < 1e4]  # huge ground spheres aside
    rng = np.random.default_rng(seed)
    o = rng.uniform(pts.min(0) - 1, pts.max(0) + 1, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    thr = rng.uniform(0.1, 1.5, size=(n, 3)).astype(np.float32)
    acc = rng.uniform(0.0, 0.5, size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.85
    lane = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    return state_from_numpy(bounce, o, d, thr, acc, alive, lane, device="cuda")


def explain_accum_flips(c, state, got, want, most=4):
    """Print up to `most` lanes whose accum differs beyond parity.py's rtol:
    the ray, both accum increments and the plain primary hit; for a lane
    that escaped to an IBL sky, the texel of the plain lookup and the first
    texel whose radiance gives the kernel's accum; for a lane that hit, the
    plain NEE term."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import bsdf, intersect, sky as sky_ops
    from lumillyrender_tpu_torch.scene.data import SKY_IBL

    scene, st = c.data, c.settings
    rel = ((got.accum - want.accum).abs() / want.accum.abs().clamp(min=1.0)).amax(1)
    for i in (rel > parity.LIMITS["rtol"]).nonzero()[:most, 0].tolist():
        s = slice(i, i + 1)
        o, d = state.o[s], state.d[s]
        hit, sp = intersect.intersect_shade(o, d, scene.geometry, scene.bvh,
                                            st.intersector, plain=True)
        line = (f"  accum flip, lane {i}: o {o[0].tolist()}, d {d[0].tolist()}, "
                f"alive {bool(state.alive[i])}; accum increment kernel "
                f"{(got.accum[i] - state.accum[i]).tolist()}, plain "
                f"{(want.accum[i] - state.accum[i]).tolist()}; plain hit prim "
                f"{int(hit.prim[0])}, t {float(hit.t[0]):.7g}")
        if not bool(sp.hit[0]) and st.sky_kind == SKY_IBL:
            texels = scene.sky.ibl.reshape(-1, 3)
            implied = int((state.accum[i] + state.throughput[i] * texels
                           - got.accum[i]).abs().sum(1).argmin())
            line += (f"; texel: plain lookup {int(sky_ops.ibl_texel(scene.sky, d)[0])}, "
                     f"implied by the kernel's accum {implied}")
        elif bool(sp.hit[0]):
            direct = wavefront._direct_light(
                scene, st, sp, -d, bsdf.gather(scene.materials, sp.mat), state.lane[s],
                SEED, state.bounce * wavefront._SLOTS,
                torch.ones(1, dtype=torch.bool, device=o.device))
            line += f"; plain NEE term {direct[0].tolist()}"
        print(line)


def check_bounce(tag, c, kernel, state):
    """One bounce of `kernel` (cuda_bounce.bounce or bounce_bvh) against the
    plain step on `state` under parity.py's rules; prints the agreement and
    any accum-flip lanes, and returns the agreement."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront

    got = kernel(c.data, c.settings, SEED, state)
    want = wavefront.plain_bounce_step(c.data, c.settings, SEED, state)
    torch.cuda.synchronize()
    m = parity.agreement(want, got)
    bad = parity.failures(m)
    print(f"{tag}: lanes {m['lanes']}, tie {m['tie']:.4%}, "
          f"excluded {m['excluded']:.4%}, accum flips "
          f"{m['accum_flip']:.4%}, max rel "
          + ", ".join(f"{k} {v:.1e}" for k, v in m["max_rel"].items())
          + f", rays {m['rays'][1]:.0f}/{m['rays'][0]:.0f}"
          + (f"  FAIL {bad}" if bad else ""))
    if m["accum_flip"]:
        explain_accum_flips(c, state, got, want)
    if bad:
        fail(f"bounce kernel vs plain on {tag}: {bad}")
    return m


def film_gap(a, b):
    """(|mean| relative gap, share of pixels within 1e-4 of b's max, max
    |a - b|) of two films."""
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    within = float((np.abs(a - b) <= 1e-4 * np.abs(b).max()).mean())
    return mean_rel, within, float(np.abs(a - b).max())


def check_films(tag, films):
    """The film gate: |mean| rel < 1e-4 and >= 99% of pixels within 1e-4 of
    the film max. On the card the two paths, and two runs of one path, gave
    bit-equal or ulp-close films (PERF.md, 6.1); the limits leave room for a
    rare last-bit flip of one lane's decision (its path is then another
    valid sample and moves a pixel or two) and none for a bias: 1% more or
    less energy on any kind of lane moves the mean by far more than 1e-4."""
    checks = {}
    for name, (a, b) in films.items():
        checks[name] = film_gap(a, b)
        mean_rel, within, max_abs = checks[name]
        print(f"{tag} films, {name}: |mean| rel {mean_rel:.3e}, pixels within "
              f"1e-4 of the film max {within:.5f}, max |diff| {max_abs:.3e}")
    for name, (mean_rel, within, _) in checks.items():
        if not (mean_rel < 1e-4 and within >= 0.99):
            fail(f"{tag} films disagree ({name})")
    return checks


# What PlainCalls counts by name and no plain path is: the ray sort key,
# the chunk's work (`trace_film`, an AOV's `aov`), a plan's traces of it and
# its calls.
NOT_PLAIN = ("_ray_sort_key", "trace_film", "aov", "_trace", "__call__")


class PlainCalls:
    """Counts calls of the plain step, the plain backward and the plain BVH
    walk while open, so a kernel-path run can show that it ran none
    (`calls`). The hybrid step's backward runs the plain step by design,
    once a bounce, inside `cuda_bounce.recompute`: those calls are counted
    apart (`recomputes`, one a recompute), and a plain walk counts in
    `calls` wherever it runs. `n` counts every call by name, NOT_PLAIN's
    too: `trace_film`'s and `aov`'s against `ForwardPlan._trace`'s (equal
    where every chunk is a captured plan's: no chunk ran eagerly), and a
    plan's calls (`__call__`; `plans` holds the plans called), so that
    calls - plans chunks were graph replays."""

    def __enter__(self):
        from lumillyrender_tpu_torch.integrator import render, wavefront
        from lumillyrender_tpu_torch.ops import cuda_bounce, intersect

        self.calls = 0
        self.recomputes = 0
        self.inside = 0
        self.plans = set()
        self.saved = [(m, name, getattr(m, name)) for m, name in (
            (wavefront, "plain_bounce_step"), (intersect, "_walk_tris"),
            (cuda_bounce, "plain_bounce_bwd"), (cuda_bounce, "recompute"),
            (intersect, "_ray_sort_key"), (render, "trace_film"), (render, "aov"),
            (render.ForwardPlan, "_trace"), (render.ForwardPlan, "__call__"))]
        self.n = {name: 0 for _, name, _ in self.saved}
        for mod, name, fn in self.saved:
            def counted(*a, _fn=fn, _name=name, **k):
                self.n[_name] += 1
                if _name == "recompute":
                    self.inside += 1
                    try:
                        return _fn(*a, **k)
                    finally:
                        self.inside -= 1
                if _name == "plain_bounce_step" and self.inside:
                    self.recomputes += 1
                elif _name == "__call__":
                    self.plans.add(id(a[0]))
                elif _name not in NOT_PLAIN:
                    self.calls += 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def run_main_path(tag, argv, want, must_be_zero=(), env=None, plain_step=False, loaded=None):
    """One CLI run, under the environment variables `env` if given, with
    every launch count zeroed just before it and read just after; fails
    unless each kernel in `want` launched, none in `must_be_zero` did, and
    neither the plain step nor the plain walk ran, or with `plain_step`,
    unless the plain step ran and the plain walk did not; and unless every
    chunk was a captured plan's (no eager chunk: `trace_film` or, for an
    AOV, `aov` called only by `ForwardPlan._trace`, twice a plan, its first
    call's and its capture's) and every later chunk of a plan its graph's
    replay. `loaded` ({scene path: CompiledScene}) holds scenes this
    process already compiled with the CLI's own `compile_scene_file`
    arguments: the CLI gets a copy of each (its setting overrides stay its
    own) instead of parsing the file again. Returns (result, counts, calls
    by name)."""
    from unittest import mock

    from lumillyrender_tpu_torch import cli
    from lumillyrender_tpu_torch.ops import cuda_bounce
    from lumillyrender_tpu_torch.scene import compiler

    compile_file = compiler.compile_scene_file

    def compiled_once(path, spp=None, device=None):
        if spp is None and str(path) in (loaded or {}):
            return dataclasses.replace(loaded[str(path)])
        return compile_file(path, spp=spp, device=device)

    with mock.patch.dict(os.environ, env or {}), PlainCalls() as plain, \
            mock.patch.object(compiler, "compile_scene_file", compiled_once):
        cuda_bounce.reset_counts()
        result = cli.run(argv)
        torch.cuda.synchronize()
        launches = cuda_bounce.counts()
    knobs = "".join(f" {k}={v}" for k, v in (env or {}).items())
    print(f"launches during the {tag}{knobs} render: {launches}; plain calls by name: "
          f"{plain.n}")
    if any(launches[k] < 1 for k in want):
        fail(f"a kernel of the {tag} path was not launched: {launches}")
    walks = plain.n["_walk_tris"] + plain.n["plain_bounce_bwd"]
    left = walks or not plain.n["plain_bounce_step"] if plain_step else plain.calls
    if left or any(launches[k] for k in must_be_zero):
        fail(f"the {tag} render left its path: {launches}, plain calls {plain.n}")
    aov_run = "--aov" in argv
    traced = plain.n["aov" if aov_run else "trace_film"]
    if traced != plain.n["_trace"] or plain.n["aov" if not aov_run else "trace_film"]:
        fail(f"the {tag} render ran a chunk eagerly: plain calls {plain.n}")
    plans = len(plain.plans)
    replays = plain.n["__call__"] - plans
    if plain.n["_trace"] != 2 * plans:
        fail(f"the {tag} render traced its {plans} plans {plain.n['_trace']} times: a chunk "
             f"after a plan's first was not its graph's replay")
    film = result.film
    print(f"film {film.shape}, mean {film.mean():.6f}, max {film.max():.4f}, "
          f"rays {result.rays:.0f}, rays/s {result.rays_per_second:.4e}; {plans} captured "
          f"plans, {replays} chunks their replays")
    if not (np.isfinite(film).all() and film.max() > 0):
        fail(f"the {tag} film is not finite and non-zero")
    return result, launches, dict(plain.n, plans=plans, replays=replays)


def cli_checkpoint_telemetry_profile(scene):
    """The CLI on `scene` at full size with --checkpoint, --telemetry and
    --profile: one JSON chunk line per chunk on stderr, the summary JSON
    on stdout, the checkpoint at the last sample, and a Chrome trace that
    holds the bounce kernels' records from inside the graph replays; then
    the same command again, which resumes at the end and renders nothing."""
    import contextlib
    import io

    from lumillyrender_tpu_torch import cli
    from lumillyrender_tpu_torch.utils import checkpoint as ckpt
    from lumillyrender_tpu_torch.utils.telemetry import TRACE_FILE

    ck, prof = OUT / "new-cbox.ckpt.npz", OUT / "new-cbox-profile"
    ck.unlink(missing_ok=True)
    (prof / TRACE_FILE).unlink(missing_ok=True)
    argv = [str(scene), "--out", str(OUT / "new-cbox-cli.png"), "--checkpoint", str(ck),
            "--telemetry", "--profile", str(prof)]
    runs = []
    for args in (argv, argv[:-2]):  # the rerun writes no trace
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = cli.run(args)
        torch.cuda.synchronize()
        runs.append((result, out.getvalue(), err.getvalue()))
    (result, out, err), (_, out2, _) = runs
    chunks = [json.loads(x) for x in err.splitlines() if x.startswith('{"ts"')]
    summary = json.loads([x for x in out.splitlines() if x.startswith('{"chunks"')][-1])
    settings = result_settings(scene)
    spp = settings.spp
    saved = ckpt.load(ck, settings, 0)
    trace = json.loads((prof / TRACE_FILE).read_text())
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    bounce_records = sum(1 for e in kernels if "bounce" in e.get("name", ""))
    rec = dict(chunk_lines=len(chunks), summary=summary,
               checkpoint_samples=None if saved is None else saved[1],
               trace_bytes=(prof / TRACE_FILE).stat().st_size, trace_kernels=len(kernels),
               trace_bounce_kernels=bounce_records,
               resumed=f"resumed at {spp}/{spp} spp" in out2)
    print(f"CLI --checkpoint --telemetry --profile: {rec}")
    if (not chunks or [e["done"] for e in chunks][-1] != spp or summary["chunks"] != len(chunks)
            or abs(summary["rays"] - result.rays) > 1e-6 * result.rays):
        fail(f"the CLI's telemetry lines disagree with its render: {rec}")
    if saved is None or saved[1] != spp or saved[2] != result.rays:
        fail(f"the CLI's checkpoint does not hold the render: {rec}")
    if not bounce_records or not rec["resumed"]:
        fail(f"the CLI's profile holds no bounce kernel, or the rerun did not resume: {rec}")
    return rec


def result_settings(scene):
    """The RenderSettings the CLI renders `scene` with (no overrides)."""
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    return compile_scene_file(scene, device="cpu").settings


def instrumented_chunk(c, spp_chunk, kernel, tables):
    """Trace one chunk of `c` with the bounce kernel `kernel` (cuda_bounce.
    bounce or bounce_bvh), checking every launch against the plain step on
    the same state. Returns (checks by width, per-launch records (width,
    live lanes, rays, node visits, triangle tests), first state by width)."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce, intersect

    st = c.settings
    per_launch, first_state, checks = [], {}, {}

    def counted_step(state):
        w = state.o.shape[0]
        first_state.setdefault(w, state)
        # Both sides count this launch's rays from 0: the chunk's running
        # float32 total passes 2^24, where the plain step's two additions
        # (primary, then shadow rays) and the kernel's one round differently.
        zero = dataclasses.replace(state, rays_traced=torch.zeros_like(state.rays_traced))
        out = kernel(c.data, st, SEED, zero, tables)
        # The walks the bound counts are the plain step's, which walks what
        # the kernel walks: a live lane's primary ray, and the shadow ray of
        # a lane that survived RR, faces its light and is not emissive.
        with intersect.count_work() as work:
            want = wavefront.plain_bounce_step(c.data, st, SEED, zero)
        m = parity.agreement(want, out)
        bad = parity.failures(m)
        if bad:
            fail(f"bounce kernel vs plain on the main path, width {w}, "
                 f"bounce {state.bounce}: {bad}")
        agg = checks.setdefault(w, dict(launches=0, tie=0.0, excluded=0.0,
                                        accum_flip=0.0, max_rel=0.0, max_abs=0.0))
        agg["launches"] += 1
        for k in ("tie", "excluded", "accum_flip"):
            agg[k] = max(agg[k], m[k])
        agg["max_rel"] = max(agg["max_rel"], *m["max_rel"].values())
        agg["max_abs"] = max(agg["max_abs"], *m["max_abs"].values())
        per_launch.append((w, state.alive.sum(), out.rays_traced,
                           work["visits"], work["tests"]))
        return dataclasses.replace(out, rays_traced=state.rays_traced + out.rays_traced)

    trace_chunk(c, 0, spp_chunk, cuda_bounce.generate_rays, counted_step)
    torch.cuda.synchronize()
    for w, agg in sorted(checks.items(), reverse=True):
        print(f"main-path bounce, width {w}: {agg['launches']} launches each "
              f"checked against the plain step: worst tie {agg['tie']:.4%}, "
              f"excluded {agg['excluded']:.4%}, accum flips {agg['accum_flip']:.4%}, "
              f"max rel {agg['max_rel']:.1e}, max abs {agg['max_abs']:.1e}")
    return checks, per_launch, first_state


# Operations counted from the sources: a slab test ~25 flops (six
# subtractions and multiplies, min/max per axis, three compares), a
# Moller-Trumbore test ~54, a sphere test ~25, shading a live lane ~150 and
# its NEE ~150 more, beside each ray's intersection.
SLAB_FLOPS, TRI_FLOPS, SPH_FLOPS, SHADE_FLOPS = 25, 54, 25, 150
STATE_BYTES = 106  # bounce: o, d, throughput, accum 48 B each way, alive 1 B
#                    each way, lane id in and ray count out, 4 B each
DEAD_STATE_BYTES = 102  # a dead lane copies its state and reads no lane id
# (a live lane that misses needs no lane id either; it is counted at 106)
# The bytes of a bound are the rays' or the state's alone: the prim and BVH
# tables (at most 6.8 MB) stay in the 50 MB L2 across the warm launches
# that are timed.


def bounce_bounds(c, per_launch, brute):
    """Per width: launches and the summed bound of the bounce launches
    (bytes: the state each way, no lane id on a dead lane; operations: the
    intersections and shading
    of this launch's rays, the BVH walks' node visits and triangle tests
    counted by the plain step, which walks what the kernel walks)."""
    geom = c.data.geometry
    nt, ns = geom.tri_p0.shape[0], geom.sph_c.shape[0]
    by_width = {}
    for w, a_in, r, visits, tests in per_launch:
        a_in, r = float(a_in), float(r)
        isect = (TRI_FLOPS * nt * r if brute
                 else SLAB_FLOPS * float(visits) + TRI_FLOPS * float(tests))
        ops = isect + SPH_FLOPS * ns * r + SHADE_FLOPS * r
        t_bytes = (STATE_BYTES * a_in + DEAD_STATE_BYTES * (w - a_in)) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS_PER_S * 1e3
        agg = by_width.setdefault(w, dict(launches=0, bound_ms=0.0, bytes_ms=0.0,
                                          ops_ms=0.0, rays=0.0, visits=0.0, tests=0.0))
        agg["launches"] += 1
        agg["bound_ms"] += max(t_bytes, t_ops)
        agg["bytes_ms"] += t_bytes
        agg["ops_ms"] += t_ops
        agg["rays"] += r
        agg["visits"] += float(visits)
        agg["tests"] += float(tests)
    return by_width


def time_bounce_widths(c, kernel, launch, tables, first_state, by_width):
    """Bare launch, wrapper and plain-step times at each stage width, on
    that stage's first state."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce

    st = c.settings
    dev = torch.device("cuda")
    for w, s0 in first_state.items():
        a = by_width[w]
        f3 = lambda: torch.empty((w, 3), dtype=torch.float32, device=dev)
        out = (f3(), f3(), f3(), f3(), torch.empty(w, dtype=torch.bool, device=dev),
               torch.empty(w, dtype=torch.float32, device=dev))
        a["ms"] = graph_ms(lambda: launch(c.data, st, SEED, s0, tables, out))
        a["wrapper_ms"] = graph_ms(lambda: kernel(c.data, st, SEED, s0, tables))
        a["host_ms"] = events_ms(lambda: kernel(c.data, st, SEED, s0, tables), 10)
        a["plain_ms"] = events_ms(
            lambda: wavefront.plain_bounce_step(c.data, st, SEED, s0), 2)
    for w, a in sorted(by_width.items(), reverse=True):
        k = a["launches"]
        if kernel is cuda_bounce.bounce:  # the brute-force kernel's instance
            inst, group = cuda_bounce.launch_instance(tables, w)
            a["instance"] = inst.label(group)
        print(f"bounce width {w}" + (f" ({a['instance']})" if "instance" in a else "")
              + f": {k} launches/chunk, kernel {a['ms']:.4f} "
              f"ms/launch (bare launch, CUDA graph + events), bound "
              f"{a['bound_ms'] / k:.4f} ms (bytes {a['bytes_ms'] / k:.4f}, "
              f"operations {a['ops_ms'] / k:.4f}); wrapper with allocation "
              f"and ray-count sum {a['wrapper_ms']:.4f} ms on the device, "
              f"{a['host_ms']:.4f} ms with the host; plain {a['plain_ms']:.3f} ms")


def weighted(by_width):
    """Launch-weighted ms, bound, plain ms and what bounds the launches."""
    n = sum(a["launches"] for a in by_width.values())
    ms = sum(a["ms"] * a["launches"] for a in by_width.values()) / n
    bound = sum(a["bound_ms"] for a in by_width.values()) / n
    plain = sum(a["plain_ms"] * a["launches"] for a in by_width.values()) / n
    by = ("bytes" if sum(a["bytes_ms"] for a in by_width.values())
          >= sum(a["ops_ms"] for a in by_width.values()) else "operations")
    return n, ms, bound, plain, by


def chunk_rate(renderer, spp_chunk, timed, first_offset):
    """Forward rays/s over `timed` chunks of `renderer` (a ChunkRenderer)
    after one warm-up chunk, the one that captures the stage plan's CUDA
    graph (host clock around work that ends in a synchronize): (rays/s, ms
    per chunk, launches per chunk by kernel)."""
    from lumillyrender_tpu_torch.ops import cuda_bounce

    renderer.chunk(first_offset, spp_chunk)
    torch.cuda.synchronize()
    cuda_bounce.reset_counts()
    t0 = time.monotonic()
    rays = []
    for k in range(timed):
        _, r = renderer.chunk(first_offset + (k + 1) * spp_chunk, spp_chunk)
        rays.append(r)
    torch.cuda.synchronize()
    window = time.monotonic() - t0
    launches = {k: v / timed for k, v in cuda_bounce.counts().items() if v}
    return float(sum(float(r) for r in rays)) / window, window / timed * 1e3, launches


def idle_share(renderer, spp_chunk, chunk_ms, offset):
    """Device busy time per chunk from the profiler's kernel records over two
    chunks (graph replays, once the renderer has captured its plan),
    against the unprofiled chunk time: (idle share or None, busy ms,
    {kernel name: (ms, launches) per chunk}). Also prints the replay's span
    between CUDA events (first node's start to last node's end). Not
    measured (None, None) where the profiler recorded fewer bounce kernels
    than the wrappers launched: a long run's profiler has lost records of
    kernels inside graph replays, and the busy sum then misses them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lumillyrender_tpu_torch.ops import cuda_bounce

    torch.cuda.synchronize()
    before = cuda_bounce.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(2):
            renderer.chunk(offset + k * spp_chunk, spp_chunk)
        torch.cuda.synchronize()
    after = cuda_bounce.counts()
    launched = sum(after[k] - before[k] for k in ("bounce", "bounce_bvh")) / 2
    by_name = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 2e3, n + 0.5)
    plan = renderer.plans.get(spp_chunk)
    if plan is not None and plan.graph is not None:
        span = events_ms(plan.graph.replay, 5)
        print(f"graph replay span (CUDA events, no raygen): {span:.4f} ms")
    if not by_name:
        print("idle share: not measured (the profiler recorded no kernels)")
        return None, None, {}
    recorded = sum(n for name, (_, n) in by_name.items() if "bounce_kernel<" in name)
    if recorded < launched:
        print(f"idle share: not measured (the profiler recorded {recorded:.1f} of the "
              f"{launched:.1f} bounce launches a chunk; its busy sum would miss the rest)")
        return None, None, by_name
    busy = sum(t for t, _ in by_name.values())
    idle = 1.0 - busy / chunk_ms
    print(f"device busy {busy:.4f} ms per chunk of {chunk_ms:.4f} ms: "
          f"idle share {idle:.4f}; {sum(n for _, n in by_name.values()):.1f} kernel "
          f"records per chunk (the profiler sees the kernels inside the graph replays)")
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        print(f"  {t:9.4f} ms/chunk {n:7.1f} launches/chunk  {name[:70]}")
    return idle, busy, by_name


def plan_cost(renderer, spp_chunk) -> dict:
    """The capture's seconds and the graph pool's bytes of a renderer's
    plan for `spp_chunk`, printed."""
    plan = renderer.plans[spp_chunk]
    print(f"stage plan of {plan.n} lanes captured in {plan.capture_seconds:.3f} s; graph "
          f"pool {plan.pool_bytes} B ({plan.pool_bytes / plan.n:.1f} B a lane); launches "
          f"per replay {plan.launches}")
    return dict(capture_seconds=plan.capture_seconds, pool_bytes=plan.pool_bytes,
                launches_per_replay=plan.launches)


def host_loop_chunk(c, step, spp, offset):
    """One chunk with the stage loop on the host, as the port ran it before
    the loop was captured (one read of the card per bounce, stopping where
    no lane is alive), over the same raygen, lane ids, step, `_compact` and
    banks as the captured plan: (each stage's end state, film_flat, rays)."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import global_lanes, tile_decode
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng
    from lumillyrender_tpu_torch.ops.intersect import _use_brute

    st = c.settings
    w, h = st.width, st.height
    n, n_pix = w * h * spp, w * h
    o, d, pdf, g = cuda_bounce.generate_rays(c.data, st, SEED, offset, n)
    lane = global_lanes(st, offset, n, o.device)
    weight = g * c.data.camera.sensor_sensitivity / pdf
    state = wavefront.PathState(
        0, o, d, torch.ones_like(o) * weight[..., None], torch.zeros_like(o),
        torch.ones(n, dtype=torch.bool, device=o.device),
        torch.zeros((), device=o.device), lane)
    decode = tile_decode(st)

    def to_pixel(lanes):
        lanes = rng.as_u32(lanes) % n_pix
        if decode is None:
            return lanes
        px, py = decode(lanes)
        return py * w + px

    def bank(film, s, ordered):
        if ordered and s.accum.shape[0] % n_pix == 0:
            by_lane = s.accum.reshape(-1, n_pix, 3).sum(dim=0)
            if decode is None:
                return film + by_lane
            return film.index_add(0, to_pixel(torch.arange(n_pix, device=o.device)), by_lane)
        return film.index_add(0, to_pixel(s.lane), s.accum)

    film = torch.zeros((n_pix, 3), device=o.device)
    ends, first = [], True
    plan = wavefront._stage_plan(n, st, aggressive=_use_brute(c.data.geometry, st.intersector))
    for si, (width, _, b1) in enumerate(plan):
        if width != state.alive.shape[0]:
            film = bank(film, state, first)
            first = False
            state = wavefront._compact(state, width, SEED, 0x50000000 + si, salt=lane[0])
        while state.bounce < b1 and bool(state.alive.any()):
            state = step(state)
        ends.append(state)
    return ends, bank(film, state, first), state.rays_traced


STATE_FIELDS = ("o", "d", "throughput", "accum", "alive", "lane", "rays_traced")


def fused_off_chunks(tag, c, spp_chunk, card) -> dict:
    """Phase 21's `fused="off"` chunks: `graphed_vs_host_loop` over the plain
    step, then a fresh renderer's captured plan timed (chunk ms over two
    replays after the capture, busy ms and idle share from the profiler,
    the capture's seconds and pool bytes) beside the host loop's ms a
    chunk; its film of the first chunk through check_films against the
    kernels' plan's film of the same chunk."""
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer

    rec = graphed_vs_host_loop(tag, c, spp_chunk)
    renderer = ChunkRenderer(c.data, c.settings, SEED, "cuda")
    if not renderer.graphed:
        fail(f"{tag}: the chunk is not a captured plan")
    _, chunk_ms, per_chunk = chunk_rate(renderer, spp_chunk, 2, 0)
    idle, busy, _ = idle_share(renderer, spp_chunk, chunk_ms, 8 * spp_chunk)
    rec.update(chunk_ms=chunk_ms, busy_ms=busy, idle_share=idle, launches_per_chunk=per_chunk,
               **plan_cost(renderer, spp_chunk))
    busy_s = "not measured" if busy is None else f"{busy:.4f} ms"
    idle_s = "not measured" if idle is None else f"{idle:.4f}"
    print(f"{tag}, {rec['lanes']} lanes a chunk: captured plan {chunk_ms:.4f} ms per chunk, "
          f"device busy {busy_s}, idle share {idle_s}, launches per chunk {per_chunk}, capture "
          f"{rec['capture_seconds']:.3f} s, graph pool {rec['pool_bytes']} B; the host loop "
          f"{rec['host_loop_chunk_ms']:.4f} ms per chunk  [{card}]")
    if any(per_chunk.get(k) for k in ("bounce", "bounce_bvh", "bounce_bwd")):
        fail(f"{tag}: a bounce kernel ran under fused='off': {per_chunk}")
    # The plan's film against the kernels' at the same chunk (one width:
    # the brute-force ladder resamples within a chunk).
    kernels = ChunkRenderer(c.data, dataclasses.replace(c.settings, fused="auto"), SEED, "cuda")
    f_off, _ = renderer.chunk(0, spp_chunk)
    f_k, _ = kernels.chunk(0, spp_chunk)
    rec["vs_kernels"] = check_films(f"{tag} captured plan vs the kernels' plan, one chunk", {
        "plain step vs kernel path": (f_off.cpu().numpy(), f_k.cpu().numpy())})
    del renderer, kernels
    torch.cuda.empty_cache()
    return rec


def graphed_vs_host_loop(tag, c, spp_chunk):
    """A fresh ChunkRenderer's first chunk (run eagerly, then captured) and
    second (a graph replay), each stage's end state recorded, against the
    host loop on the same offsets: every field of every stage-end state and
    the ray counts bit-equal, the films through check_films' gate (banks
    after the first add with atomics). Then the host loop's ms per chunk
    (host clock to a synchronize, one chunk after these). Returns a record."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer

    st = c.settings
    n = st.width * st.height * spp_chunk
    ends = []
    run_stage = wavefront.run_stage

    def recorded(step, state, b1):
        out = run_stage(step, state, b1)
        ends.append([getattr(out, k).clone() for k in STATE_FIELDS])
        return out

    wavefront.run_stage = recorded
    try:
        renderer = ChunkRenderer(c.data, st, SEED, "cuda")
        film0, rays0 = renderer.chunk(0, spp_chunk)
        stages = len(ends) // 2
        film1, rays1 = renderer.chunk(spp_chunk, spp_chunk)
        torch.cuda.synchronize()
    finally:
        wavefront.run_stage = run_stage
    got = {0: (ends[:stages], film0, rays0), spp_chunk: (ends[stages:], film1, rays1)}
    step = renderer.step
    rec = dict(lanes=n, stages=stages)
    films = {}
    for offset, (g_ends, film, rays) in got.items():
        w_ends, w_film, w_rays = host_loop_chunk(c, step, spp_chunk, offset)
        torch.cuda.synchronize()
        if len(w_ends) != stages:
            fail(f"{tag}: {stages} stages captured, {len(w_ends)} in the host loop")
        for si, (g_state, w_state) in enumerate(zip(g_ends, w_ends)):
            for k, t in zip(STATE_FIELDS, g_state):
                if not torch.equal(t, getattr(w_state, k)):
                    fail(f"{tag}, chunk at sample {offset}: stage {si}'s {k} differs "
                         "between the captured loop and the host loop")
        if not torch.equal(rays, w_rays + float(n)):
            fail(f"{tag}: rays {float(rays)} (captured) vs {float(w_rays) + n} (host loop)")
        label = "eager first chunk" if offset == 0 else "graph replay"
        films[f"{label} vs host loop"] = (film.reshape(-1, 3).cpu().numpy(),
                                          w_film.cpu().numpy())
        rec[f"rays_{offset}"] = float(rays)
    print(f"{tag}: {stages} stages, every stage-end state (o, d, throughput, accum, alive, "
          f"lane) and the ray count bit-equal to the host loop's on the eager first chunk "
          f"and on a graph replay")
    rec["film_checks"] = check_films(f"{tag} graphed vs host loop", films)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    host_loop_chunk(c, step, spp_chunk, 3 * spp_chunk)
    torch.cuda.synchronize()
    rec["host_loop_chunk_ms"] = (time.monotonic() - t0) * 1e3
    return rec


def welcome_rays(bvh, n, seed):
    """Random rays: origins in the root box, directions uniform; and the same
    count of axis-aligned rays whose origins lie on node planes (the slab
    test's 0 * inf)."""
    rng = np.random.default_rng(seed)
    lo, hi = bvh.node_min[0].cpu().numpy(), bvh.node_max[0].cpu().numpy()
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    oa = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    da = np.zeros((n, 3), np.float32)
    axis = rng.integers(0, 3, size=n)
    da[np.arange(n), axis] = rng.choice([-1.0, 1.0], size=n)
    planes = np.concatenate([bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy()])
    rows = rng.integers(0, planes.shape[0], size=n)
    for shift in (1, 2):
        side = (axis + shift) % 3
        oa[np.arange(n), side] = planes[rows, side]
    cu = lambda x: torch.from_numpy(x).cuda()
    return (cu(o), cu(d)), (cu(oa), cu(da))


# ---------------------------------------------------------------------------
# The training step (phases 11-13)
# ---------------------------------------------------------------------------

# Bytes a lane of the backward kernel must move. A live lane that hits:
# o, d, throughput and 4 cotangents ((n,3) f32), alive 1 B and its lane id
# 4 B in, 3 cotangents out. One that misses needs no lane id. A dead lane
# passes its o, d and throughput cotangents through: alive, 3 in, 3 out.
BWD_HIT_BYTES = 125
BWD_MISS_BYTES = 121
BWD_DEAD_BYTES = 73
BWD_SHADE_FLOPS = 600  # shading recompute (~300) and the VJP (~300) per live lane
# Whole-path gradients, kernel path vs plain path on the card at one seed:
# the two forwards agree lane by lane (phases 4 and 6), the backward kernel
# equals plain_bounce_bwd to a few ulps (phase 11), and the closed form is
# exact where autograd of the plain step evaluates cos/pdf's two cancelling
# terms; measured 2.6e-6 of each leaf's largest magnitude (PERF.md 6.3),
# held to 1e-4.
TRAIN_PLAIN_RTOL = 1e-4
TRAIN_STEPS = 3


def perturbed(mats, seed):
    """A second material table: colours and emissions moved by up to 20%."""
    g = torch.Generator().manual_seed(seed)
    f = lambda t: t * (1.0 + 0.2 * (torch.rand(t.shape, generator=g) - 0.5)).to(t.device)
    return dataclasses.replace(mats, color=f(mats.color), emission=f(mats.emission))


def cotangents(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((n, 3), generator=g, device="cuda") for _ in range(4)]


def check_bwd(tag, c, state, cot, mats_eval=None):
    """The backward kernel against plain_bounce_bwd on one state: the
    cotangents are zeroed on the lanes parity.bwd_comparable excludes
    (kernel forward against the plain forward), then parity.py's backward
    rules, and the kernel's recomputed alive' equals the forward kernel's on
    every lane. Returns the readings."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce, intersect
    from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd

    n = state.o.shape[0]
    fwd_k = cuda_bounce.bounce(c.data, c.settings, SEED, state, mats_eval=mats_eval)
    fwd_p = wavefront.plain_bounce_step(c.data, c.settings, SEED, state, mats_eval)
    _, sp = intersect.intersect_shade_brute(state.o, state.d, c.data.geometry)
    keep = parity.bwd_comparable(fwd_p, fwd_k, sp.normal)
    kt = torch.from_numpy(keep).to(state.o.device)
    cot = [g * kt[:, None] for g in cot]
    got = cuda_bounce.bounce_bwd(c.data, c.settings, SEED, state, *cot, mats_eval=mats_eval,
                                 with_alive=True)
    want = plain_bounce_bwd(c.data, c.settings, SEED, state, *cot, mats_eval=mats_eval)
    torch.cuda.synchronize()
    errs = parity.bwd_errors(want, got, keep)
    lane_rel = max(((getattr(got, k) - getattr(want, k)).abs()
                    / getattr(want, k).abs().clamp(min=1.0))[kt].max().item()
                   for k in ("o", "d", "throughput"))
    max_abs = max((getattr(got, k) - getattr(want, k)).abs().max().item()
                  for k in ("o", "d", "throughput", "albedo", "emission", "sky"))
    rec = dict(lanes=n, comparable=float(keep.mean()),
               alive_mismatch=int((got.alive != fwd_k.alive).sum()), rel_to_max=errs,
               lane_max_rel=lane_rel, max_abs=max_abs)
    bad = parity.bwd_failures(errs, parity.KERNEL_BWD_RTOL)
    if rec["alive_mismatch"]:
        bad.append(f"recomputed alive' differs on {rec['alive_mismatch']} lanes")
    if not rec["comparable"] > parity.BWD_LIMITS["comparable"]:
        bad.append(f"only {rec['comparable']:.2%} comparable")
    print(f"{tag}: lanes {n}, comparable {rec['comparable']:.4%}, alive' mismatches "
          f"{rec['alive_mismatch']}, rel to max " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
          + f", per-lane max rel {lane_rel:.1e}, max abs {max_abs:.1e}"
          + (f"  FAIL {bad}" if bad else ""))
    if bad:
        fail(f"backward kernel vs plain on {tag}: {bad}")
    return rec


def autograd_vs_plain_bwd(tag, c, state, cot):
    """plain_bounce_bwd against autograd of the plain step on one state, on
    the lanes whose sampled direction does not graze (where autograd's
    cancelling cos/pdf terms are noise), under parity.py's backward
    tolerances."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import intersect
    from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd

    rep = dataclasses.replace
    x = [t.clone().requires_grad_() for t in (state.o, state.d, state.throughput, state.accum)]
    mats, sky = c.data.materials, c.data.sky
    col, emi, sky_c = (t.clone().requires_grad_() for t in (mats.color, mats.emission, sky.color))
    out = wavefront.plain_bounce_step(
        rep(c.data, sky=rep(sky, color=sky_c)), c.settings, SEED,
        rep(state, o=x[0], d=x[1], throughput=x[2], accum=x[3]),
        rep(mats, color=col, emission=emi))
    _, sp = intersect.intersect_shade_brute(state.o, state.d, c.data.geometry)
    keep = parity.bwd_comparable(out, out, sp.normal)
    kt = torch.from_numpy(keep).to(state.o.device)[:, None]
    cot = [g * kt for g in cot]
    g = torch.autograd.grad((out.o, out.d, out.throughput, out.accum),
                            x[:3] + [col, emi, sky_c], cot, allow_unused=True)
    g = [torch.zeros_like(v) if a is None else a for a, v in zip(g, x[:3] + [col, emi, sky_c])]
    want = plain_bounce_bwd(c.data, c.settings, SEED, state, *cot)
    errs = parity.bwd_errors(dict(o=g[0], d=g[1], throughput=g[2], albedo=g[3], emission=g[4],
                                  sky=g[5]), want, keep)
    bad = parity.bwd_failures(errs, parity.AUTOGRAD_BWD_RTOL)
    print(f"{tag}: plain_bounce_bwd vs autograd of the plain step, lanes {state.o.shape[0]}, "
          f"comparable {keep.mean():.4%}, rel to max "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()) + (f"  FAIL {bad}" if bad else ""))
    if bad:
        fail(f"plain_bounce_bwd vs autograd on {tag}: {bad}")
    return dict(comparable=float(keep.mean()), rel_to_max=errs)


def fd_gate(c, cases, device="cuda", grad=None) -> dict:
    """tools/torch_grad_gates.py's fd_vs_ad on `c` (a CompiledScene) for
    `cases` ({tag: (part, field, index, eps, atol, rtol[, pixels[,
    sign]])}); fails if a case's gate does not hold."""
    from tools import torch_grad_gates as gg

    out = gg.fd_vs_ad(c.data, c.settings, cases, device, grad)
    bad = [tag for tag, r in out.items() if not r["ok"]]
    if bad:
        fail(f"FD vs AD on the kernel path: {bad}")
    return out


class PlainDiffStep:
    """While open, the differentiable loop steps with autograd of the plain
    step (the plain path) instead of `cuda_bounce.make_step_diff`'s
    kernels, for a comparison at the same seed. It is the oracle of the
    walk as well: its BVH queries take the plain walk (`_walk_tris`,
    autograd through its triangle tests), where `fused="off"` takes the
    walk kernels through their plane-equation VJP (phase 26)."""

    def __enter__(self):
        from lumillyrender_tpu_torch.integrator import wavefront
        from lumillyrender_tpu_torch.ops import cuda_bounce

        self.saved = cuda_bounce.make_step_diff

        def plain(scene, settings, seed, mats_eval=None):
            return lambda s: wavefront.plain_bounce_step(scene, settings, seed, s, mats_eval)

        cuda_bounce.make_step_diff = plain
        return self

    def __exit__(self, *exc):
        from lumillyrender_tpu_torch.ops import cuda_bounce

        cuda_bounce.make_step_diff = self.saved
        return False


def tiled_materials(mats, rows):
    """`mats` repeated to `rows` rows; rows 0 .. nm - 1 keep their values,
    so the scene renders as before."""
    reps = -(-rows // mats.type_id.shape[0])
    return dataclasses.replace(mats, **{f.name: torch.cat([getattr(mats, f.name)] * reps)[:rows]
                                        for f in dataclasses.fields(mats)})


def hybrid_many_rows(cb, n):
    """The hybrid step on a Lambert-only scene that the backward kernel
    refuses for its rows: new-cbox with its material table tiled to
    BWD_MAX_ROWS + 1 rows through make_step_diff on the card, which must
    take `_BounceHybrid` (the bounce kernel forward, autograd of the plain
    step backward: one bounce launch, no bounce_bwd launch). On one bounce
    of a random state at n lanes, its gradients in o, d, throughput and the
    albedo rows against autograd of the plain step on the same state: the
    hybrid's backward is that autograd, recomputed on the same input state,
    so the per-lane gradients must be bit-equal, and the albedo rows (sums
    over lanes) within parity.KERNEL_BWD_RTOL of their largest magnitude.
    Returns the record; fails on a mismatch."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce

    rows = cuda_bounce.BWD_MAX_ROWS + 1
    scene = dataclasses.replace(cb.data, materials=tiled_materials(cb.data.materials, rows))
    st = cb.settings
    if cuda_bounce.diff_supported(scene, st)[0] or not cuda_bounce.hybrid_supported(scene, st)[0]:
        fail(f"new-cbox at {rows} material rows: diff_supported "
             f"{cuda_bounce.diff_supported(scene, st)}, hybrid_supported "
             f"{cuda_bounce.hybrid_supported(scene, st)}")
    state = random_state(scene, n, 91, 3)
    cot = cotangents(n, 92)

    def grads(step_of):
        x = [t.clone().requires_grad_() for t in (state.o, state.d, state.throughput)]
        mats = dataclasses.replace(scene.materials,
                                   color=scene.materials.color.clone().requires_grad_())
        out = step_of(mats)(dataclasses.replace(state, o=x[0], d=x[1], throughput=x[2]))
        return torch.autograd.grad((out.o, out.d, out.throughput, out.accum), x + [mats.color],
                                   cot, allow_unused=True)

    cuda_bounce.reset_counts()
    got = grads(lambda m: cuda_bounce.make_step_diff(scene, st, SEED, m))
    torch.cuda.synchronize()
    launches = cuda_bounce.counts()
    want = grads(lambda m: lambda s: wavefront.plain_bounce_step(scene, st, SEED, s, m))
    torch.cuda.synchronize()
    names = ("o", "d", "throughput", "albedo")
    lanes_equal = {k: torch.equal(a, b) for k, a, b in zip(names[:3], got, want)}
    albedo_rel = ((got[3] - want[3]).abs().max() / want[3].abs().max().clamp(min=1e-30)).item()
    rec = dict(rows=rows, lanes=n, launches=launches, lanes_bit_equal=lanes_equal,
               albedo_rel_to_max=albedo_rel)
    print(f"new-cbox at {rows} material rows (past BWD_MAX_ROWS), make_step_diff on the card: "
          f"launches {launches}; per-lane gradients bit-equal to autograd of the plain step "
          f"{lanes_equal}; albedo rows max |diff| / max |plain| {albedo_rel:.2e}")
    if (launches["bounce"] != 1 or launches["bounce_bwd"] or not all(lanes_equal.values())
            or not albedo_rel < parity.KERNEL_BWD_RTOL):
        fail(f"the hybrid step at {rows} material rows: {rec}")
    return rec


def grads_gap(a, b) -> dict:
    """{part.field: max |a - b| over max |b|} of two DiffParams of gradients
    (float leaves with a nonzero gradient in b)."""
    out = {}
    for pa, pb in zip(a, b):
        for f in dataclasses.fields(pb):
            x, y = getattr(pa, f.name), getattr(pb, f.name)
            if not y.is_floating_point() or not y.abs().max() > 0:
                continue
            out[f"{type(pb).__name__}.{f.name}"] = ((x - y).abs().max() / y.abs().max()).item()
    return out


def train_new_cbox(cb, spp):
    """Phase 12's main path at `spp` per step: film_and_grads from a
    perturbed albedo (x0.8) toward the film at the true one, Adam on the
    albedo, each step with the counts zeroed just before it and read just
    after; then two runs at one point must give bit-equal gradients.
    Returns (record, the last params, target)."""
    from lumillyrender_tpu_torch.diff import film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves
    from lumillyrender_tpu_torch.ops import cuda_bounce

    st = cb.settings
    p_true = params_of(cb.data)
    with torch.no_grad():
        target = render_diff(cb.data, st, p_true, SEED, spp)
    albedo = torch.nn.Parameter(p_true.materials.color * 0.8)
    opt = torch.optim.Adam([albedo], lr=0.02)
    losses, step_launches, total = [], [], {}
    for k in range(TRAIN_STEPS):
        p = p_true._replace(materials=dataclasses.replace(p_true.materials,
                                                          color=albedo.detach()))
        with PlainCalls() as plain:
            cuda_bounce.reset_counts()
            loss, film, grads = film_and_grads(cb.data, st, p, target, SEED, spp)
            torch.cuda.synchronize()
            launches = cuda_bounce.counts()
        err = (p_true.materials.color - albedo.detach()).abs().sum().item()
        print(f"new-cbox 256^2 x {spp} spp, Adam step {k}: loss {float(loss):.6e}, "
              f"sum |albedo - true| {err:.4f}, launches {launches}, plain calls {plain.calls}")
        if (launches["bounce"] != 80 or launches["bounce_bwd"] != 80
                or any(launches[n] for n in ("raygen", "bvh", "bounce_bvh")) or plain.calls):
            fail(f"the training step left the kernel path: {launches}, {plain.calls} plain calls")
        if not all(torch.isfinite(t).all() for t in leaves(grads)):
            fail("a training-step gradient is not finite")
        for name, v in launches.items():
            total[name] = total.get(name, 0) + v
        losses.append(float(loss))
        step_launches.append(launches)
        opt.zero_grad()
        albedo.grad = grads.materials.color
        opt.step()
    p = p_true._replace(materials=dataclasses.replace(p_true.materials, color=albedo.detach()))
    l1, f1, g1 = film_and_grads(cb.data, st, p, target, SEED, spp)
    l2, f2, g2 = film_and_grads(cb.data, st, p, target, SEED, spp)
    torch.cuda.synchronize()
    bit_equal = (torch.equal(l1, l2) and torch.equal(f1, f2)
                 and all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2))))
    print(f"new-cbox 256^2 x {spp} spp: two runs of film_and_grads at one point, loss, film "
          f"and every gradient bit-equal: {bit_equal}")
    if not bit_equal:
        fail(f"the training step's gradients differ between two runs ({spp} spp)")
    return dict(losses=losses, launches_per_step=step_launches, launches=total,
                bit_equal=bit_equal), p, target, g1


def device_busy(fn):
    """(busy device ms of one `fn()`, {kernel name: (ms, launches)}) from
    the profiler's kernel records. Only the card's activity is traced: a
    training step runs tens of thousands of PyTorch ops, whose host-side
    records cost the profiler far more time than the step; and the records
    are read raw, since building the profiler's event list takes seconds a
    step of 100,000 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t + e.duration_ns() / 1e6, n + 1)
    if not by_name:
        fail("the profiler recorded no kernel on the card")
    return sum(t for t, _ in by_name.values()), by_name


def time_train_step(cb, spp, p, target, steps, tag="256^2", top=8):
    """fwd+bwd rays/s of the training step at `spp` per step, counted as
    bench.py counts them (camera, live bounce and NEE shadow rays of the
    forward sweep), over `steps` steps after a warm-up (host clock around
    work that ends in a synchronize), each step at its own seed; the step
    time; the peak device memory of one step (max_memory_allocated past
    what was held before it); the idle share of one profiled step and its
    kernels by name ({name: (ms, launches)})."""
    from lumillyrender_tpu_torch.diff import render_diff
    from lumillyrender_tpu_torch.diff.render import leaves, map_params

    st = cb.settings

    def step(seed):
        live = map_params(p, lambda t: t.detach().requires_grad_(t.is_floating_point()))
        film, rays = render_diff(cb.data, st, live, seed, spp, with_rays=True)
        loss = torch.mean((film - target) ** 2)
        torch.autograd.grad(loss, [t for t in leaves(live) if t.requires_grad],
                            allow_unused=True)
        return rays

    step(SEED + 50)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    rays = [step(SEED + 51 + k) for k in range(steps)]
    torch.cuda.synchronize()
    window = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - held
    total = sum(float(r) for r in rays)
    step_ms = window / steps * 1e3
    busy, by_name = device_busy(lambda: step(SEED + 99))
    idle = 1.0 - busy / step_ms
    print(f"training step {tag} x {spp} spp: {step_ms:.4f} ms per step (mean of {steps}), "
          f"{total / steps:.0f} rays per step: {total / window:.6e} fwd+bwd rays/s; device busy "
          f"{busy:.4f} ms: idle share {idle:.4f}; peak memory {peak / 2**30:.3f} GiB")
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
        print(f"  {t:9.4f} ms/step {n:6d} launches/step  {name[:70]}")
    # PyTorch's reductions (the loss, the ray counts); the backward kernel
    # sums its own row table, so none is its.
    reduce_launches = sum(n for name, (_, n) in by_name.items() if "reduce_kernel" in name)
    print(f"  reduce_kernel launches per step: {reduce_launches}")
    return dict(rays_per_s=total / window, step_ms=step_ms, rays_per_step=total / steps,
                busy_ms=busy, idle_share=idle, reduce_launches=reduce_launches,
                peak_bytes=peak, by_name=by_name,
                top_kernels={k[:70]: v for k, v in sorted(by_name.items(),
                                                          key=lambda x: -x[1][0])[:top]})


def time_bwd_widths(cb, spp, p, target):
    """The backward kernel at each stage width of one training step: the
    first launch's state, cotangents and tables at each width are kept;
    each is checked against plain_bounce_bwd, its bare launch timed (CUDA
    graph + events) beside its bound (bytes: BWD_HIT_BYTES, BWD_MISS_BYTES or
    BWD_DEAD_BYTES a lane by what this state's lane needs, plus the row
    table out; operations: this state's live lanes and shadow rays) and the
    plain backward's time. The step runs eagerly, so that its launches are
    seen. Returns {width: record}."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads
    from lumillyrender_tpu_torch.ops import cuda_bounce, intersect
    from lumillyrender_tpu_torch.ops.bounce_bwd import plain_bounce_bwd

    kept = {}
    launch = cuda_bounce.bounce_bwd_launch

    def keeping(scene, settings, seed, state, cot, tables, out):
        # The backward runs from the last bounce to the first, so the last
        # launch at a width is its stage's first bounce (the most live lanes).
        w = state.o.shape[0]
        n = kept[w]["launches"] if w in kept else 0
        kept[w] = dict(scene=scene, state=state, cot=[g.clone() for g in cot],
                       tables=tables, launches=n + 1)
        return launch(scene, settings, seed, state, cot, tables, out)

    cuda_bounce.bounce_bwd_launch = keeping
    try:
        eager_film_and_grads(cb.data, cb.settings, p, target, SEED, spp)
        torch.cuda.synchronize()
    finally:
        cuda_bounce.bounce_bwd_launch = launch
    st = cb.settings
    geom = cb.data.geometry
    nt, ns = geom.tri_p0.shape[0], geom.sph_c.shape[0]
    out = {}
    for w, k in sorted(kept.items(), reverse=True):
        scene, cot, tables = k["scene"], k["cot"], k["tables"]
        # The backward keeps no accum (it passes through); the forward
        # launches below need one.
        state = dataclasses.replace(k["state"], accum=torch.zeros_like(k["state"].o))
        me = cuda_bounce.materials_of_rows(tables["mats_eval"], scene.materials.type_id)
        rec = check_bwd(f"main-path backward, width {w}", dataclasses.replace(cb, data=scene),
                        state, cot, me)
        nm = tables["mats"].shape[0]
        bufs = (torch.empty_like(state.o), torch.empty_like(state.o), torch.empty_like(state.o),
                torch.empty(6 * nm + 3, dtype=torch.float32, device=state.o.device), None)
        rec["instance"] = cuda_bounce.launch_instance(tables, w, backward=True)[0].label()
        rec["ms"] = graph_ms(lambda: cuda_bounce.bounce_bwd_launch(scene, st, SEED, state, cot,
                                                                   tables, bufs))
        rec["plain_ms"] = events_ms(lambda: plain_bounce_bwd(scene, st, SEED, state, *cot,
                                                             mats_eval=me), 2)
        zero = dataclasses.replace(state, rays_traced=torch.zeros_like(state.rays_traced))
        fwd = cuda_bounce.bounce(scene, st, SEED, zero, tables)
        live = float(state.alive.sum())
        shadow = float(fwd.rays_traced) - live
        _, sp = intersect.intersect_shade_brute(state.o, state.d, geom)
        missed = float((state.alive & ~sp.hit).sum())
        bytes_ = ((live - missed) * BWD_HIT_BYTES + missed * BWD_MISS_BYTES
                  + (w - live) * BWD_DEAD_BYTES + (6 * nm + 3) * 4)
        ops = ((live + shadow) * (TRI_FLOPS * nt + SPH_FLOPS * ns)
               + (live - missed) * BWD_SHADE_FLOPS)
        rec.update(launches=k["launches"], live=live, missed=missed, shadow_rays=shadow,
                   bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_FLOPS_PER_S * 1e3)
        rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
        print(f"backward width {w} ({rec['instance']}): {k['launches']} launches/step, "
              f"kernel {rec['ms']:.4f} "
              f"ms/launch (bare launch, CUDA graph + events), bound {rec['bound_ms']:.4f} ms "
              f"(bytes {rec['bytes_ms']:.4f}, operations {rec['ops_ms']:.4f}; {live:.0f} live "
              f"lanes, {missed:.0f} of them missing, {shadow:.0f} shadow rays); plain "
              f"{rec['plain_ms']:.3f} ms")
        out[w] = rec
    return out



# ---------------------------------------------------------------------------
# Huge meshes (phases 14-19)
# ---------------------------------------------------------------------------

# The terrain scene of scene/terrain.py at 1M and 1.5M triangles; from
# 650,000 triangles the compiler builds 128-wide leaves. Written where
# nothing is copied back (the package's build directory).
BIG_TRIS = {"terrain-1m": 1_000_000, "terrain-1.5m": 1_500_000}
SCENES_DIR = REPO / "lumillyrender_tpu_torch" / "build" / "scenes"
TIE_SHARE = 0.004  # parity.py's tie-flip limit
RAY_BYTES = 40  # o, d, t_init, t_stop in; t, prim out
SHADE_BYTES = 16  # mat and normal out


def write_terrain(name, n_tris):
    """terrain-<n>'s obj and TOML (pt-direct, 256^2 x 64 spp, uniform sky,
    the camera that frames the terrain): (toml path, seconds)."""
    from lumillyrender_tpu_torch.scene import terrain

    t0 = time.monotonic()
    d = SCENES_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    terrain.write_obj(d / "terrain.obj", *terrain.make_terrain(n_tris)[:3])
    (d / "scene.toml").write_text(terrain.terrain_scene_toml(
        "pt-direct", resolution=(256, 256), samples=64, **terrain.TERRAIN_VIEW))
    return d / "scene.toml", time.monotonic() - t0


def terrain_rays(c, n):
    """Ray sets at n lanes of a compiled terrain scene: the camera rays of
    its first chunk, random rays (origins in the root box, uniform
    directions) and axis-aligned rays from origins on node planes."""
    from lumillyrender_tpu_torch.ops import cuda_bounce

    cam_o, cam_d, _, _ = cuda_bounce.generate_rays(c.data, c.settings, SEED, 0, n)
    (rnd_o, rnd_d), (ax_o, ax_d) = welcome_rays(c.data.bvh, n, 9)
    return {"camera": (cam_o, cam_d), "random": (rnd_o, rnd_d), "axis-aligned": (ax_o, ax_d)}


class PlainWalks:
    """The plain walk on a BVH's ray sets, each run once on every lane, with
    its node visits, triangle tests and distinct leaves counted and its
    time kept (~2 s for 2,097,152 random rays of terrain-1m on an H100)."""

    def __init__(self, bvh, n):
        from lumillyrender_tpu_torch.constants import INF

        self.bvh, self.n, self.runs = bvh, n, {}
        self.inf = torch.full((n,), INF, device="cuda")
        self.never = torch.full((n,), -INF, device="cuda")

    def __call__(self, key, o, d, t0, ts, shade):
        """(outputs, visits, tests, distinct leaves, ms) of the plain walk."""
        from lumillyrender_tpu_torch.ops import intersect

        if key not in self.runs:
            torch.cuda.synchronize()
            start = time.monotonic()
            with intersect.count_work() as work:
                outs = intersect._walk_tris(o, d, t0, ts, self.bvh, shade)
            torch.cuda.synchronize()
            ms = (time.monotonic() - start) * 1e3
            seen = 0 if work["seen"] is None else int(work["seen"].sum())
            self.runs[key] = (outs, float(work["visits"]), float(work["tests"]), seen, ms)
        return self.runs[key]


def compare_walk(tag, got, want, dist=None, exact=False):
    """A kernel's outputs against the plain walk's: t bit-equal, prim equal
    but on exact-t ties (fewer than TIE_SHARE of the lanes; none with
    `exact`), mat and normal equal where prims are; with `dist` (a capped
    occlusion query) the verdicts |t - dist| <= EPS equal on every lane.
    Fails otherwise; returns the record."""
    from lumillyrender_tpu_torch.constants import EPS

    t_g, p_g = got[0], got[1]
    t_w, p_w = want[0], want[1]
    n = t_w.shape[0]
    flip = p_g != p_w
    rec = dict(lanes=n, hits=int((p_w >= 0).sum()), t_mismatch=int((t_g != t_w).sum()),
               prim_ties=int((flip & (t_g == t_w)).sum()),
               prim_off_ties=int((flip & (t_g != t_w)).sum()),
               max_abs=(t_g - t_w).abs().max().item())
    if len(got) > 2:
        same = ~flip
        rec["mat_mismatch"] = int((got[2] != want[2])[same].sum())
        rec["n_max_abs"] = (got[3] - want[3])[same].abs().max().item()
    if dist is not None:
        verdict = lambda t, p: (p >= 0) & ((t - dist).abs() <= EPS)
        rec["verdict_flips"] = int((verdict(t_g, p_g) != verdict(t_w, p_w)).sum())
        rec["visible"] = int(verdict(t_w, p_w).sum())
    print(f"{tag}: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                 for k, v in rec.items()))
    ties = 1 if exact else TIE_SHARE * n
    if (rec["t_mismatch"] or rec["prim_off_ties"] or rec["prim_ties"] >= ties
            or rec.get("mat_mismatch") or rec.get("n_max_abs", 0.0) > 0.0
            or rec.get("verdict_flips")):
        fail(f"{tag}: the kernel disagrees with the plain walk: {rec}")
    return rec


def sorted_walk(fn, bvh, o, d, t0, ts, tables, shade):
    """`fn` on the lanes sorted by the ray sort key, back in lane order."""
    from lumillyrender_tpu_torch.ops import intersect

    perm, inv = intersect.sort_rays(o, d, bvh)
    outs = fn(o[perm], d[perm], t0[perm], ts[perm], tables, shade)
    return tuple(x[inv] for x in outs)


def check_walk_sets(tag, fn, bvh, rays, plain, tables, sets, exact=False):
    """Phases 15-16: `fn` (a kernel wrapper taking (o, d, t0, ts, tables,
    shade)) unsorted and sorted against the plain walk on each of `sets`
    ((name, ray set, shade, occlusion)); capped occlusion queries put half
    the lanes' light on their nearest hit; `exact` as compare_walk.
    Returns {case: record}."""
    from lumillyrender_tpu_torch.constants import EPS

    out = {}
    for name, key, shade, occl in sets:
        o, d = rays[key]
        t0, ts, dist = plain.inf, plain.never, None
        if occl:
            near = plain(f"{key}|False|False", o, d, plain.inf, plain.never, False)[0]
            rng = np.random.default_rng(8)
            dist = torch.from_numpy(rng.uniform(0.5, 40.0, size=plain.n).astype(np.float32)).cuda()
            on = (near[1] >= 0) & (torch.arange(plain.n, device="cuda") % 2 == 0)
            dist = torch.where(on, near[0], dist)
            t0 = dist + 2.0 * EPS
            ts = t0 - 4.0 * EPS
        want = plain(f"{key}|{shade}|{occl}", o, d, t0, ts, shade)[0]
        for order in ("unsorted", "sorted"):
            got = (fn(o, d, t0, ts, tables, shade) if order == "unsorted"
                   else sorted_walk(fn, bvh, o, d, t0, ts, tables, shade))
            torch.cuda.synchronize()
            out[f"{name}, {order}"] = compare_walk(f"{tag}, {name}, {order}", got, want, dist,
                                                   exact)
    return out


def walk_bound(n, shade, visits, tests, leaves, k):
    """(bound ms, bytes ms, operations ms) of a nearest-triangle query over
    n rays: the rays in and out, each distinct leaf the walks visit read
    once (nine geometry rows and the prim row of K floats), and the plain
    walk's slab and triangle tests."""
    b = n * (RAY_BYTES + (SHADE_BYTES if shade else 0)) + leaves * 10 * k * 4
    bytes_ms = b / HBM_BYTES_PER_S * 1e3
    ops_ms = (SLAB_FLOPS * visits + TRI_FLOPS * tests) / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def time_walk(tag, launch, bvh, o, d, plain, key, sort, tables):
    """A walk kernel's bare launch (CUDA graph + events) at n lanes on the
    rays, sorted or not, beside its bound and the plain walk's time and
    counts (phases 15-16 ran the plain walk on these rays)."""
    from lumillyrender_tpu_torch.ops import intersect

    n = o.shape[0]
    if sort:
        perm, _ = intersect.sort_rays(o, d, bvh)
        o, d = o[perm].contiguous(), d[perm].contiguous()
    out = (torch.empty(n, dtype=torch.float32, device="cuda"),
           torch.empty(n, dtype=torch.int32, device="cuda"))
    ms = graph_ms(lambda: launch(o, d, plain.inf, plain.never, tables, out))
    # The counts and the plain walk's time do not depend on the lanes' order.
    _, visits, tests, leaves, plain_ms = plain(key, o, d, plain.inf, plain.never, False)
    bound, b_ms, o_ms = walk_bound(n, False, visits, tests, leaves, tables["k"])
    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bytes_ms=b_ms, ops_ms=o_ms,
               bound_by="bytes" if b_ms >= o_ms else "operations", visits_per_ray=visits / n,
               tests_per_ray=tests / n, leaves=leaves)
    print(f"{tag}: {ms:.4f} ms/launch (bare launch), bound {bound:.4f} ms (bytes {b_ms:.4f}, "
          f"operations {o_ms:.4f}: {visits / n:.2f} node visits, {tests / n:.1f} triangle "
          f"tests per ray, {leaves} distinct leaves); plain walk {plain_ms:.1f} ms")
    return rec


def time_bvh_bounce(c, spp_chunk, label="K=128"):
    """Kernel 4 on a BVH scene (`label`: its leaf width): one chunk traced with the kernel alone,
    the first state of each stage width kept; on each, the kernel against
    the plain step (parity.py's rules), its bare launch beside the bound of
    that launch (counted as bounce_bounds counts) and the plain step's time
    (host clock, one run). Returns {width: record}."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce, intersect

    st = c.settings
    tables = cuda_bounce.pack_tables(c.data, bvh=True)
    first, per_width = {}, {}

    def step(state):
        w = state.o.shape[0]
        first.setdefault(w, state)
        per_width[w] = per_width.get(w, 0) + 1
        return cuda_bounce.bounce_bvh(c.data, st, SEED, state, tables)

    trace_chunk(c, 0, spp_chunk, cuda_bounce.generate_rays, step)
    torch.cuda.synchronize()
    recs = {}
    for w, s0 in sorted(first.items(), reverse=True):
        zero = dataclasses.replace(s0, rays_traced=torch.zeros_like(s0.rays_traced))
        got = cuda_bounce.bounce_bvh(c.data, st, SEED, zero, tables)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with intersect.count_work() as work:
            want = wavefront.plain_bounce_step(c.data, st, SEED, zero)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        m = parity.agreement(want, got)
        bad = parity.failures(m)
        if bad:
            fail(f"BVH bounce kernel at {label} vs plain on the main path, width {w}: {bad}")
        b = bounce_bounds(c, [(w, s0.alive.sum(), got.rays_traced, work["visits"],
                               work["tests"])], brute=False)[w]
        f3 = lambda: torch.empty((w, 3), dtype=torch.float32, device="cuda")
        out = (f3(), f3(), f3(), f3(), torch.empty(w, dtype=torch.bool, device="cuda"),
               torch.empty(w, dtype=torch.float32, device="cuda"))
        ms = graph_ms(lambda: cuda_bounce.bounce_bvh_launch(c.data, st, SEED, s0, tables, out))
        recs[w] = dict(launches_per_chunk=per_width[w], ms=ms, bound_ms=b["bound_ms"],
                       bytes_ms=b["bytes_ms"], ops_ms=b["ops_ms"], plain_ms=plain_ms,
                       live=float(s0.alive.sum()), rays=b["rays"], visits=b["visits"],
                       tests=b["tests"], tie=m["tie"], accum_flip=m["accum_flip"])
        print(f"BVH bounce at {label}, width {w} ({per_width[w]} launches/chunk; the stage's "
              f"first state, {recs[w]['live']:.0f} live): kernel {ms:.4f} ms/launch (bare "
              f"launch), bound {b['bound_ms']:.4f} ms (bytes {b['bytes_ms']:.4f}, operations "
              f"{b['ops_ms']:.4f}); plain step {plain_ms:.1f} ms; tie {m['tie']:.4%}, accum "
              f"flips {m['accum_flip']:.4%}")
    return recs


def huge_meshes(card, lap):
    """Phases 14-19: huge meshes (terrain-1m, terrain-1.5m) through the
    AOV walks and the BVH bounce at K=128. Returns (report, the two new
    kernels' entries, the two compiled terrains)."""
    from lumillyrender_tpu_torch.accel import native
    from lumillyrender_tpu_torch.accel.pack import build_tri_bvh
    from lumillyrender_tpu_torch.integrator.render import (
        ChunkRenderer, camera_lanes, default_spp_chunk, render,
    )
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_build, cuda_bvh, intersect
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    dev = torch.device("cuda")
    rep = {}

    phase("14 build (the AOV walks, the native BVH builder; the terrain scenes)")
    t0 = time.monotonic()
    rep["ptxas"] = {}
    ptxas = ptxas_kernels(cuda_build.LOGS.get("bvh_aov", ""))
    if not ptxas:
        print("kernels 6 and 7 (bvh_aov.cu, built in phase 2): built before this run")
    for kernel, props in ptxas.items():
        blocks = blocks_per_sm(props)
        rep["ptxas"][kernel] = dict(ptxas=props, blocks_per_sm=blocks)
        print(f"kernels 6 and 7 (bvh_aov.cu) {kernel}: {props}; {blocks} blocks of 128 per SM")
    t = time.monotonic()
    native.build()
    print(f"native BVH builder: {native.lib_path().name} in {time.monotonic() - t:.1f}s")
    paths = {}
    for name, n_tris in BIG_TRIS.items():
        paths[name], secs = write_terrain(name, n_tris)
        print(f"{name}: make_terrain({n_tris}) and its obj in {secs:.1f}s")
    lap("huge-mesh build", t0)

    def load(name):
        t = time.monotonic()
        c = compile_scene_file(paths[name], device=dev)
        b = c.data.bvh
        print(f"{name}: {c.stats['polygons']} triangles, compiled in "
              f"{time.monotonic() - t:.1f}s (BVH {c.stats['bvh_seconds']:.1f}s): "
              f"{b.node_min.shape[0]} nodes, {b.blk_p0.shape[0]} leaves of "
              f"{b.blk_p0.shape[1]}, wide tables {cuda_bvh.wide_table_bytes(b)} B, "
              f"route {intersect.bvh_route(b)}")
        return c

    sets = [("camera rays", "camera", False, False),
            ("camera rays, shade", "camera", True, False),
            ("random rays", "random", False, False),
            ("random rays, shade", "random", True, False),
            ("random rays, occlusion", "random", False, True),
            ("axis-aligned rays, shade", "axis-aligned", True, False)]

    phase("15 wide-leaf kernel vs the plain walk (terrain-1m, K=128, admitted as wide)")
    t0 = time.monotonic()
    c1 = load("terrain-1m")
    bvh1 = c1.data.bvh
    if intersect.bvh_route(bvh1) != ("wide", False):
        fail(f"terrain-1m does not route to the wide walk: {intersect.bvh_route(bvh1)}")
    spp_chunk = default_spp_chunk(c1.settings)
    n = c1.settings.width * c1.settings.height * spp_chunk
    rays1 = terrain_rays(c1, n)
    tab1 = cuda_bvh.tables_of(bvh1)
    plain1 = PlainWalks(bvh1, n)
    rep["wide_checks"] = check_walk_sets("kernel 7", cuda_bvh.intersect_tris_wide, bvh1,
                                         rays1, plain1, tab1, sets)
    # Kernel 3's K=128 instance, on the rays phase 19 times it on: every
    # output bit-equal to the plain walk's.
    rep["per_thread_checks"] = check_walk_sets(
        "kernel 3 (per thread), terrain-1m K=128", cuda_bvh.intersect_tris, bvh1, rays1, plain1,
        tab1, [sets[0], sets[1], sets[4], sets[5]], exact=True)
    lap("wide parity", t0)

    phase("16 streamed kernel vs the plain walk (terrain-1.5m, auto route; terrain-1m at "
          "K=32, streamed=True)")
    t0 = time.monotonic()
    c15 = load("terrain-1.5m")
    bvh15 = c15.data.bvh
    if intersect.bvh_route(bvh15) != ("streamed", False):
        fail(f"terrain-1.5m does not route to the streamed walk: {intersect.bvh_route(bvh15)}")
    rays15 = terrain_rays(c15, n)
    tab15 = cuda_bvh.tables_of(bvh15)
    plain15 = PlainWalks(bvh15, n)

    def auto(o, d, t0_, ts, tables, shade):
        return intersect._walk_routed(o, d, t0_, ts, bvh15, shade, None, False)

    cuda_bounce.reset_counts()
    rep["streamed_checks"] = check_walk_sets("kernel 6, terrain-1.5m", auto, bvh15, rays15,
                                             plain15, tab15, sets)
    launches = cuda_bounce.counts()
    if launches["bvh_streamed"] != 2 * len(sets) or launches["bvh_wide"] or launches["bvh"]:
        fail(f"terrain-1.5m's auto route launched {launches}")
    t = time.monotonic()
    g = c1.data.geometry
    arrays = build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
        "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")), max_leaf=32)
    bvh32 = Bvh(**{f: tensor_of(v).to(dev) for f, v in arrays.items()})
    print(f"terrain-1m at K=32: built in {time.monotonic() - t:.1f}s, {bvh32.node_min.shape[0]} "
          f"nodes, {bvh32.blk_p0.shape[0]} leaves, route with streamed=True "
          f"{intersect.bvh_route(bvh32, streamed=True)}")
    plain32 = PlainWalks(bvh32, n)

    def streamed32(o, d, t0_, ts, tables, shade):
        return intersect._walk_routed(o, d, t0_, ts, bvh32, shade, True, False)

    rep["streamed_k32_checks"] = check_walk_sets(
        "kernel 6, terrain-1m K=32", streamed32, bvh32, rays1, plain32,
        cuda_bvh.tables_of(bvh32), [sets[0], sets[3], sets[4]])
    lap("streamed parity", t0)

    phase("17 BVH bounce kernel at K=128 vs the plain step (terrain-1m)")
    t0 = time.monotonic()
    rep["bounce_checks"] = {}
    for b in (0, 3, 7, 70):
        rep["bounce_checks"][b] = check_bounce(f"terrain-1m@b{b}", c1, cuda_bounce.bounce_bvh,
                                               random_state(c1.data, n, 4000 * b + 11, b))
    lap("K=128 bounce parity", t0)

    phase("18 end-to-end renders (CLI: terrain-1m 256^2 x 64 spp pt-direct, --aov depth, "
          "--aov normal; terrain-1.5m --aov depth and pt-direct)")
    t0 = time.monotonic()
    chunks = -(-c1.settings.spp // spp_chunk)
    scene1, scene15 = str(paths["terrain-1m"]), str(paths["terrain-1.5m"])
    # The CLI renders the terrains phases 15-16 compiled from these files
    # (~14 and ~21 s a parse and build, which the CLI would repeat 5 times).
    loaded = {scene1: c1, scene15: c15}
    pt, l_pt, _ = run_main_path(
        "terrain-1m", [scene1, "--out", str(OUT / "terrain-1m.png")],
        want=("raygen", "bounce_bvh"), must_be_zero=("bounce", "bvh", "bvh_wide", "bvh_streamed"),
        loaded=loaded)
    _, l_depth, c_depth = run_main_path(
        "terrain-1m --aov depth", [scene1, "--aov", "depth", "--out",
                                   str(OUT / "terrain-1m-depth.png")],
        want=("raygen", "bvh_wide"), must_be_zero=("bounce", "bounce_bvh", "bvh", "bvh_streamed"),
        loaded=loaded)
    _, l_normal, c_normal = run_main_path(
        "terrain-1m --aov normal", [scene1, "--aov", "normal", "--out",
                                    str(OUT / "terrain-1m-normal.png")],
        want=("raygen", "bvh_wide"), must_be_zero=("bounce", "bounce_bvh", "bvh", "bvh_streamed"),
        loaded=loaded)
    _, l_15, c_15 = run_main_path(
        "terrain-1.5m --aov depth", [scene15, "--aov", "depth", "--out",
                                     str(OUT / "terrain-1.5m-depth.png")],
        want=("raygen", "bvh_streamed"), must_be_zero=("bounce", "bounce_bvh", "bvh", "bvh_wide"),
        loaded=loaded)
    pt15, l_pt15, calls_pt15 = run_main_path(
        "terrain-1.5m", [scene15, "--out", str(OUT / "terrain-1.5m.png")],
        want=("raygen", "bounce_bvh"), must_be_zero=("bounce", "bvh", "bvh_wide", "bvh_streamed"),
        loaded=loaded)
    bounces = c15.settings.max_bounces
    print(f"terrain-1.5m pt-direct: {l_pt15['bounce_bvh']} bounce_bvh launches over {chunks} "
          f"chunks ({bounces} a chunk expected), {pt15.seconds:.3f} s, "
          f"{pt15.rays_per_second:.6e} rays/s  [{card}]")
    if l_pt15["bounce_bvh"] != bounces * chunks or l_pt15["raygen"] != chunks:
        fail(f"terrain-1.5m: {l_pt15} for {chunks} chunks of {bounces} bounces")
    for tag, got, k in (("--aov depth", l_depth, "bvh_wide"), ("--aov normal", l_normal, "bvh_wide"),
                        ("terrain-1.5m --aov depth", l_15, "bvh_streamed")):
        if got[k] < chunks:
            fail(f"{tag}: {got[k]} {k} launches for {chunks} chunks")
    for tag, calls in (("terrain-1m --aov depth", c_depth), ("terrain-1m --aov normal", c_normal),
                       ("terrain-1.5m --aov depth", c_15), ("terrain-1.5m", calls_pt15)):
        if calls["replays"] < chunks - 1:
            fail(f"{tag}: {calls['replays']} of {chunks} chunks were graph replays")
    small = resized(c1, 64, 64, 4)
    films = kernel_vs_plain_films("terrain-1m 64^2x4", small)
    films15 = kernel_vs_plain_films("terrain-1.5m 64^2x4", resized(c15, 64, 64, 4),
                                    walk="bvh_streamed")
    small_aov = dataclasses.replace(small, settings=dataclasses.replace(
        small.settings, integrator="depth"))
    a_k = render(small_aov, seed=SEED, device=dev).film
    o, d, _, _ = cuda_bounce.generate_rays(small.data, small_aov.settings, SEED, 0, 64 * 64 * 4)
    hit = intersect.intersect(o, d, small.data.geometry, small.data.bvh,
                              c1.settings.intersector, plain=True)
    _, px, py = camera_lanes(small_aov.settings, 0, o.shape[0], dev)
    depth = torch.where(hit.prim >= 0, hit.t, torch.zeros_like(hit.t))
    a_p = torch.zeros(64 * 64, dtype=torch.float32, device=dev)
    a_p.index_add_(0, py * 64 + px, depth)
    a_p = (a_p / 4).reshape(64, 64, 1).expand(64, 64, 3).cpu().numpy()
    aov_films = check_films("terrain-1m depth 64^2x4", {"kernel path vs plain walk": (a_k, a_p)})
    rep.update(cli=dict(pt_direct=dict(launches=l_pt, rays_per_s=pt.rays_per_second,
                                       seconds=pt.seconds, chunks=chunks),
                        depth_launches=l_depth, normal_launches=l_normal,
                        terrain_15m_depth_launches=l_15,
                        terrain_15m_pt_direct=dict(launches=l_pt15, chunks=chunks,
                                                   rays_per_s=pt15.rays_per_second,
                                                   seconds=pt15.seconds)),
               film_checks=films, film_checks_15m=films15, aov_film_checks=aov_films)
    lap("huge-mesh renders", t0)

    phase(f"19 timing (terrain-1m and terrain-1.5m 256^2, {spp_chunk} spp per chunk; the walks "
          f"at {n} lanes)")
    t0 = time.monotonic()
    r1 = ChunkRenderer(c1.data, c1.settings, SEED, dev)
    rate, chunk_ms, per_chunk = chunk_rate(r1, spp_chunk, 3, 0)
    print(f"forward (the captured stage plan, replayed): 3 chunks, {chunk_ms:.4f} ms each: "
          f"{rate:.6e} rays/s; launches per chunk {per_chunk}  [{card}]")
    idle, busy, _ = idle_share(r1, spp_chunk, chunk_ms, 10 * spp_chunk)
    rep["forward"] = dict(rays_per_s=rate, chunk_ms=chunk_ms, idle_share=idle, busy_ms=busy,
                          launches_per_chunk=per_chunk, **plan_cost(r1, spp_chunk))
    del r1
    r15 = ChunkRenderer(c15.data, c15.settings, SEED, dev)
    rate, chunk_ms, per_chunk = chunk_rate(r15, spp_chunk, 3, 0)
    print(f"terrain-1.5m forward (the captured stage plan, replayed): 3 chunks, {chunk_ms:.4f} "
          f"ms each: {rate:.6e} rays/s; launches per chunk {per_chunk}  [{card}]")
    idle, busy, _ = idle_share(r15, spp_chunk, chunk_ms, 10 * spp_chunk)
    rep["forward_15m"] = dict(rays_per_s=rate, chunk_ms=chunk_ms, idle_share=idle, busy_ms=busy,
                              launches_per_chunk=per_chunk, **plan_cost(r15, spp_chunk))
    del r15
    rep["bounce_k128"] = {str(w): r for w, r in time_bvh_bounce(c1, spp_chunk).items()}
    rep["bounce_k128_15m"] = {str(w): r for w, r in time_bvh_bounce(
        c15, spp_chunk, label="K=128, terrain-1.5m").items()}
    t7, t6, t3, t6_15 = {}, {}, {}, {}
    for key in ("camera", "random"):
        for srt in (False, True):
            case = f"{key} rays, {'sorted' if srt else 'unsorted'}"
            t7[case] = time_walk(f"kernel 7 (bvh_wide), terrain-1m, {case}",
                                 cuda_bvh.intersect_tris_wide_launch, bvh1, *rays1[key],
                                 plain1, f"{key}|False|False", srt, tab1)
            t6[case] = time_walk(f"kernel 6 (bvh_streamed), terrain-1m K=128, {case}",
                                 cuda_bvh.intersect_tris_streamed_launch, bvh1, *rays1[key],
                                 plain1, f"{key}|False|False", srt, tab1)
            t3[case] = time_walk(f"kernel 3 (bvh, per thread), terrain-1m K=128, {case}",
                                 cuda_bvh.intersect_tris_launch, bvh1, *rays1[key],
                                 plain1, f"{key}|False|False", srt, tab1)
            t6_15[case] = time_walk(f"kernel 6 (bvh_streamed), terrain-1.5m, {case}",
                                    cuda_bvh.intersect_tris_streamed_launch, bvh15,
                                    *rays15[key], plain15, f"{key}|False|False", srt, tab15)
    sort_ms = {}
    for key in ("camera", "random"):
        o, d = rays1[key]

        def sort_and_gather():
            perm, inv = intersect.sort_rays(o, d, bvh1)
            return o[perm], d[perm], plain1.inf[perm], plain1.never[perm], inv

        sort_ms[key] = events_ms(sort_and_gather, 5)
        print(f"sort of {n} {key} rays (key, stable argsort, inverse, four gathers): "
              f"{sort_ms[key]:.4f} ms")
    # Whether the route's default sort pays for itself: the walk on sorted
    # rays plus the sort (timed on terrain-1m's rays; the same work on
    # terrain-1.5m's) against the walk on unsorted rays.
    sort_pays = {}
    for tag, timing in (("kernel 7, terrain-1m", t7), ("kernel 6, terrain-1.5m", t6_15)):
        for key in ("camera", "random"):
            unsorted = timing[f"{key} rays, unsorted"]["ms"]
            with_sort = timing[f"{key} rays, sorted"]["ms"] + sort_ms[key]
            pays = sort_pays[f"{tag}, {key} rays"] = with_sort < unsorted
            print(f"{tag}, {key} rays: unsorted {unsorted:.4f} ms; sorted plus the sort "
                  f"{with_sort:.4f} ms: the sort {'pays' if pays else 'does not pay'}")
    route_sorts = intersect.bvh_route(bvh1)[1] or intersect.bvh_route(bvh15)[1]
    print(f"the route's default (reorder=None) {'sorts' if route_sorts else 'does not sort'}; "
          f"in this run the sort pays in {sum(sort_pays.values())} of {len(sort_pays)} cases")
    rep.update(wide_timing=t7, streamed_timing_1m=t6, per_thread_timing_1m=t3,
               streamed_timing_15m=t6_15, sort_ms=sort_ms, sort_pays=sort_pays,
               route_sorts=route_sorts)
    lap("huge-mesh timing", t0)

    def err(checks):
        return max(r["max_abs"] for r in checks.values())

    main7, main6 = t7["camera rays, sorted"], t6_15["camera rays, sorted"]
    kernels = [
        dict(name="bvh_wide", route="cuda",
             source="lumillyrender_tpu_torch/csrc/bvh_aov.cu",
             replaces="lumillyrender_tpu/ops/pallas_bvh_wide.py:76",
             launches=l_depth["bvh_wide"], max_abs_err=err(rep["wide_checks"]),
             ms=main7["ms"], plain_ms=main7["plain_ms"], bound_ms=main7["bound_ms"],
             bound_by=main7["bound_by"], library_ms=None),
        dict(name="bvh_streamed", route="cuda",
             source="lumillyrender_tpu_torch/csrc/bvh_aov.cu",
             replaces="lumillyrender_tpu/ops/pallas_bvh.py:264",
             launches=l_15["bvh_streamed"],
             max_abs_err=max(err(rep["streamed_checks"]), err(rep["streamed_k32_checks"])),
             ms=main6["ms"], plain_ms=main6["plain_ms"], bound_ms=main6["bound_ms"],
             bound_by=main6["bound_by"], library_ms=None),
    ]
    return rep, kernels, c1, c15


# ---------------------------------------------------------------------------
# The AOV chunks as captured plans (phase 32)
# ---------------------------------------------------------------------------

AOV_PLAN_ROUNDS = 3  # rounds of an AOV plan's timing, the eager chunk and a replay in turns


def eager_renderer(c):
    """A ChunkRenderer of `c` on the card whose chunks run eagerly
    (`graphed` false): the chunk a plan captures, op by op."""
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer

    r = ChunkRenderer(c.data, c.settings, SEED, "cuda")
    r.graphed = False
    return r


def aov_plan_vs_eager(tag, c, walk, card, env=None) -> dict:
    """`c`'s AOV chunk at the CLI's chunk size through a ChunkRenderer's
    plan (its first call, eager and then captured, and a replay at the next
    sample offset) against the eager chunk at the same offsets, the counts
    zeroed just before and read just after each call: film and rays
    bit-equal, the same launches, raygen and `walk` once each; under `env`
    (LLR_REORDER=1) the sort key called by the plan's first call and its
    capture; then the eager chunk and a replay in turns over
    AOV_PLAN_ROUNDS rounds (host clock to a synchronize: median, range),
    the capture's seconds and the graph pool's bytes. Returns the record."""
    from unittest import mock

    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, default_spp_chunk
    from lumillyrender_tpu_torch.ops import cuda_bounce

    spp = default_spp_chunk(c.settings)
    want = dict({k: 0 for k in cuda_bounce.counts()}, raygen=1, **{walk: 1})
    rec = dict(lanes=c.settings.width * c.settings.height * spp)
    with mock.patch.dict(os.environ, env or {}), PlainCalls() as calls:
        planned = ChunkRenderer(c.data, c.settings, SEED, "cuda")
        eager = eager_renderer(c)
        for call, offset in (("first", 0), ("replay", spp)):
            got = {}
            for who, r in (("eager", eager), ("plan", planned)):
                keys = calls.n["_ray_sort_key"]
                cuda_bounce.reset_counts()
                film, rays = r.chunk(offset, spp)
                torch.cuda.synchronize()
                got[who] = (film, rays, cuda_bounce.counts(), calls.n["_ray_sort_key"] - keys)
            (f_e, r_e, l_e, k_e), (f_p, r_p, l_p, k_p) = got["eager"], got["plan"]
            equal = torch.equal(f_e, f_p) and torch.equal(r_e, r_p)
            rec[f"{call}_bit_equal"], rec[f"{call}_launches"] = equal, l_p
            sorts = (k_e, k_p) == ((1, 2 if call == "first" else 0) if env else (0, 0))
            if not equal or l_e != want or l_p != want or not sorts:
                fail(f"{tag}: the plan's {call} call is not the eager chunk: launches {l_p}, "
                     f"eager {l_e}, want {want}; bit-equal {equal}; sort keys {k_e}, {k_p}")
        plan = planned.plans[spp]
        ms = {"eager": [], "plan": []}
        for r_ in range(AOV_PLAN_ROUNDS):
            for who in (("eager", "plan") if r_ % 2 == 0 else ("plan", "eager")):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                (eager if who == "eager" else planned).chunk((r_ + 2) * spp, spp)
                torch.cuda.synchronize()
                ms[who].append((time.monotonic() - t0) * 1e3)
    med, rng_ = spread(ms["plan"])
    e_med, e_rng = spread(ms["eager"])
    rec.update(capture_seconds=plan.capture_seconds, pool_bytes=plan.pool_bytes,
               launches_per_replay=plan.launches, ms=ms, median_ms=med, range_ms=rng_,
               eager_median_ms=e_med, eager_range_ms=e_rng)
    print(f"{tag}, {rec['lanes']} lanes a chunk: the plan's first call and a replay bit-equal to "
          f"the eager chunk, launches {want}; capture {plan.capture_seconds:.3f} s, graph pool "
          f"{plan.pool_bytes} B; a replay {med:.4f} ms [{rng_[0]:.4f}, {rng_[1]:.4f}] against "
          f"the eager chunk's {e_med:.4f} [{e_rng[0]:.4f}, {e_rng[1]:.4f}] in turns  [{card}]")
    del planned, eager
    torch.cuda.empty_cache()
    return rec


def eager_aov_repeats(tag, c) -> dict:
    """Two eager renders of `c` (an AOV at the CLI's size, every chunk
    eager): bit-equal films. Beside them, the bank they replace read only:
    index_add_ of one chunk's lane values into the film twice (on the card
    it adds with atomics, in an order that changes between runs)."""
    from unittest import mock

    from lumillyrender_tpu_torch.integrator import render as render_mod
    from lumillyrender_tpu_torch.integrator.render import camera_lanes, default_spp_chunk
    from lumillyrender_tpu_torch.integrator.wavefront import aov
    from lumillyrender_tpu_torch.ops import cuda_bounce

    with mock.patch.object(render_mod, "captures_chunks", lambda device: False):
        films = [render_mod.render(c, seed=SEED, device="cuda").film for _ in range(2)]
    equal = np.array_equal(films[0], films[1])
    st = c.settings
    w, h = st.width, st.height
    n = w * h * default_spp_chunk(st)
    o, d, _, _ = cuda_bounce.generate_rays(c.data, st, SEED, 0, n)
    val = aov(c.data, st, o, d)
    _, px, py = camera_lanes(st, 0, n, o.device)
    old = [torch.zeros((w * h, 3), device=o.device).index_add_(0, py * w + px, val)
           for _ in range(2)]
    old_equal = torch.equal(old[0], old[1])
    old_diff = float((old[0] - old[1]).abs().max())
    print(f"{tag}: two eager renders (the ordered bank) bit-equal: {equal}; index_add_ (the "
          f"bank before) of one chunk's lane values twice: bit-equal {old_equal}, max |diff| "
          f"{old_diff:.3e}")
    if not equal:
        fail(f"{tag}: two eager AOV renders differ")
    return dict(bit_equal=equal, index_add_bit_equal=old_equal, index_add_max_diff=old_diff)


def aov_plans(card, lap, geo, terrain_1m, terrain_15m) -> dict:
    """Phase 32: the AOV chunks as captured plans, each held to the eager
    chunk (`aov_plan_vs_eager`): welcome-geo depth and normal (kernel 3),
    terrain-1m depth (kernel 7), terrain-1.5m depth (kernel 6), welcome-geo
    depth under LLR_REORDER=1 (kernel 3, the sort in the graph); two eager
    renders of welcome-geo's and terrain-1.5m's depth bit-equal."""
    phase("32 the AOV chunks as captured plans (welcome-geo, terrain-1m, terrain-1.5m; "
          "LLR_REORDER=1)")
    t0 = time.monotonic()

    def aov_of(c, integrator):
        return dataclasses.replace(c, settings=dataclasses.replace(c.settings,
                                                                   integrator=integrator))

    rep = {}
    for tag, c, integrator, walk, env in (
            ("welcome-geo --aov depth", geo, "depth", "bvh", None),
            ("welcome-geo --aov normal", geo, "normal", "bvh", None),
            ("terrain-1m --aov depth", terrain_1m, "depth", "bvh_wide", None),
            ("terrain-1.5m --aov depth", terrain_15m, "depth", "bvh_streamed", None),
            ("welcome-geo --aov depth, LLR_REORDER=1", geo, "depth", "bvh",
             dict(LLR_REORDER="1"))):
        rep[tag] = aov_plan_vs_eager(tag, aov_of(c, integrator), walk, card, env)
    for tag, c in (("welcome-geo --aov depth", geo), ("terrain-1.5m --aov depth", terrain_15m)):
        rep[f"{tag}, eager twice"] = eager_aov_repeats(tag, aov_of(c, "depth"))
    lap("32 AOV plans", t0)
    return rep


# ---------------------------------------------------------------------------
# The capability probes (phase 20)
# ---------------------------------------------------------------------------

# Launches captured per CUDA graph when a probe kernel is timed: the kernels
# take microseconds, so a graph of one launch would time the events.
PROBE_REPS = 200
# Replays of each graph, the kernel's and its call's in turns: the verdict
# kernel-vs-call rests on medians, since one replay's spread is as large as
# the gaps between probes.
PROBE_ROUNDS = 9
# Clocks of one dependent FP32 add on an H100: the packet walk's add chain.
WALK_ADD_CLOCKS = 4
# A 128-triangle leaf as a kernel would stage it: nine geometry rows and the
# prim row of 128 float32 or int32 each (ops/cuda_bvh.py::pack_bvh).
LEAF_BYTES = 10 * 128 * 4


def ptxas_kernels(log: str) -> dict:
    """{kernel: "N registers, ... smem, spill ..."} from nvcc's -Xptxas -v
    output."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            out[cur] = ""
        elif cur and "spill" in ln:
            out[cur] = ln.strip()
        elif cur and "Used" in ln:
            out[cur] = ln.split("Used", 1)[1].strip() + "; " + out[cur]
            cur = None
    return out


def kernel_instance(mangled: str) -> str:
    """A kernel's instance from its mangled name: for kernel 3 (bvh.cu's
    k3::kernel<K, V, kShade>) the leaf width (0: any), the slots a row load
    reads and the shade outputs; for a bounce kernel the intersector (for
    kernel 4's per-thread BvhIsect<K> its leaf width),
    and for bounce_kernel the tables (one or two) and the families shaded
    (bounce_body.cuh: FAM_LAMBERT 1, FAM_ALL 31)."""
    width = lambda k: "any K" if k == "0" else f"K={k}"
    m = re.search(r"k36kernelILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return (f"{width(m.group(1))}, {m.group(2)} slots a load"
                f"{', shade' if m.group(3) == '1' else ''}")
    m = re.search(r"I\d+(\w*?Isect)(?:ILi(\d+)EE)?(?:Lb([01])E)?(?:Li(\d+)E)?E", mangled)
    if not m:
        return mangled
    label = m.group(1)
    if m.group(2) is not None:
        label += f" ({width(m.group(2))})"
    if m.group(3) is not None:
        label += ", two tables" if m.group(3) == "1" else ", one table"
    if m.group(4) is not None:
        label += {"1": ", Lambert", "31": ", all families"}.get(m.group(4),
                                                                f", families {m.group(4)}")
    return label


def alternating_ms(fns, reps: int, rounds: int) -> list:
    """Device ms per call of each of `fns`: each warmed, then captured with
    `reps` calls in its own CUDA graph; the graphs are replayed in turns,
    the order reversed every other round (A B, B A, ...), each replay
    between CUDA events. Returns, per fn, its `rounds` readings."""
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            a.record()
            graphs[k].replay()
            b.record()
            b.synchronize()
            out[k].append(a.elapsed_time(b) / reps)
    return out


def spread(vals) -> tuple:
    """(median, [min, max]) of some readings."""
    return statistics.median(vals), [min(vals), max(vals)]


def blocks_per_sm(props: str) -> int | None:
    """Blocks of 128 threads an H100 SM holds for a kernel with the
    registers and static shared memory of ptxas line `props`: 65,536
    registers, allocated per warp in units of 256; 233,472 B of shared
    memory, 1 KB of it reserved per block; at most 2,048 threads. None
    where the line gives no registers."""
    m = re.search(r"(\d+) registers", props)
    if not m:
        return None
    per_warp = -(-int(m.group(1)) * 32 // 256) * 256
    return min(2048 // 128, 65536 // (4 * per_warp), 233472 // (smem_bytes(props) + 1024))


def smem_bytes(props: str) -> int:
    """Bytes of static shared memory in a ptxas "Used ..." line (ptxas
    leaves the field out where there is none)."""
    m = re.search(r"(\d+) bytes smem", props)
    return int(m.group(1)) if m else 0


def ptxas_line(ptxas: dict, kernel: str) -> str:
    """`kernel`'s line in `ptxas` (from `ptxas_kernels`), or a note where
    nvcc did not build probes.cu in this process."""
    return ptxas.get(kernel, "no line, probes.cu was built before this process")


def direct_probe_smem(log: str) -> dict:
    """{name: (bytes of static shared memory, ptxas line)} for each of
    probes.DIRECT_PROBES: the bytes as the loaded kernel reports them (read
    on every run, the library built in this process or before it), the
    line from `log`, nvcc's -Xptxas -v output, or a note where it has none."""
    from lumillyrender_tpu_torch import probes

    ptxas = ptxas_kernels(log)
    return {name: (probes.static_smem(name), ptxas_line(ptxas, f"probe_{name}"))
            for name in probes.DIRECT_PROBES}


def capability_probes(card, lap):
    """Phase 20: the capability probes' kernels (csrc/probes.cu) through the
    probe entry point, then each against its plain version and timed.
    Returns (report, the 23 kernels' entries)."""
    from lumillyrender_tpu_torch import probes
    from lumillyrender_tpu_torch.ops import cuda_build
    from lumillyrender_tpu_torch.probes import mosaic, pallas
    from lumillyrender_tpu_torch.probes.__main__ import main as probes_main

    dev = torch.device("cuda")
    phase("20 probe kernels vs plain (the Mosaic capability probes, csrc/probes.cu)")
    t0 = time.monotonic()
    log = cuda_build.LOGS.get("probes", "")
    for name, (static, props) in direct_probe_smem(log).items():
        print(f"probe_{name} (reads L2 directly): {static} bytes static shared memory "
              f"(cudaFuncGetAttributes); ptxas: {props}")
        if static != 0 or smem_bytes(props) != 0:
            fail(f"probe_{name} uses shared memory: {static} bytes static; ptxas: {props}")
    geometry = probes.onehot_geometry()
    print(f"probe_onehot_matmul_gather: grid {geometry['grid']} blocks of {geometry['block']} "
          f"threads in clusters of {geometry['cluster']} (on up to {geometry['grid']} SMs; the "
          f"card holds {geometry['max_active_clusters']} such clusters at once), "
          f"{geometry['smem_bytes']} bytes static shared memory (cudaFuncGetAttributes); "
          f"ptxas: {ptxas_line(ptxas_kernels(log), 'probe_onehot_matmul_gather')}")
    if geometry["grid"] <= 8 or geometry["cluster"] < 2:
        fail(f"probe_onehot_matmul_gather is not spread over the card: {geometry}")
    probes.reset_counts()
    rc = probes_main([])
    launches = probes.counts()
    print(f"entry point: exit {rc}; launches {json.dumps(launches)}")
    if rc != 0:
        fail(f"the probe entry point exited {rc}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"the probe entry point launched no {missing} kernel")
    for p in probes.PROBES:
        want = sum(q is p for _, q, _ in probes.cases())
        if launches[p.name] != want:
            fail(f"{p.name} launched {launches[p.name]} times, not once per run ({want})")

    floor_ms, floor_range = spread(
        alternating_ms([probes.launch_empty], PROBE_REPS, PROBE_ROUNDS)[0])
    print(f"empty kernel (1 warp), graph-replayed: {floor_ms:.6f} ms per launch "
          f"[{floor_range[0]:.6f}, {floor_range[1]:.6f}]  [{card}]")
    # onehot_matmul_gather's floor: an empty kernel of its grid and clusters,
    # without and with one cluster barrier, timed in turns.
    cluster_ms, sync_ms = (spread(t) for t in alternating_ms(
        [lambda: probes.launch_empty_cluster(False), lambda: probes.launch_empty_cluster(True)],
        PROBE_REPS, PROBE_ROUNDS))
    print(f"empty kernel of {geometry['grid']} blocks in clusters of {geometry['cluster']}: "
          f"{cluster_ms[0]:.6f} ms [{cluster_ms[1][0]:.6f}, {cluster_ms[1][1]:.6f}]; with one "
          f"cluster barrier {sync_ms[0]:.6f} ms [{sync_ms[1][0]:.6f}, {sync_ms[1][1]:.6f}]")
    rows, timed = {}, {}
    for tag, probe, params in probes.cases():
        ins = probe.inputs(dev, *params)
        outs = probe.outputs(dev)
        probe.launch(ins, outs)
        want = probe.compute(*ins)
        torch.cuda.synchronize()
        got = outs[0]
        if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32)):
            fail(f"{tag}: the kernel differs from its plain version "
                 f"(max |diff| {(got - want).abs().max().item()})")
        fns = [lambda: probe.launch(ins, outs)]
        if probe.library is not None:
            if not probe.library_agrees(ins):
                fail(f"{tag}: its library call differs from the plain version")
            fns.append(probe.library(ins))
        times = alternating_ms(fns, PROBE_REPS, PROBE_ROUNDS)
        ms, ms_range = spread(times[0])
        library_ms, library_ms_range = spread(times[1]) if len(times) > 1 else (None, None)
        plain_ms = events_ms(lambda: probe.compute(*ins), 5)
        nbytes, flops = probe.work(ins)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        rec = dict(ms=ms, ms_range=ms_range, plain_ms=plain_ms, library_ms=library_ms,
                   library_ms_range=library_ms_range, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, flops=flops, max_abs_err=0.0,
                   first=got.reshape(-1)[:4].tolist())
        # The share of its bound the kernel reaches, the bound taken at least
        # the empty kernel's launch (the rule that orders the redesigns).
        rec["floored_share"] = max(rec["bound_ms"], floor_ms) / ms
        print(f"{tag}: bit-equal {rec['first']}; kernel {ms:.6f} ms "
              f"[{ms_range[0]:.6f}, {ms_range[1]:.6f}], bound {rec['bound_ms']:.3e} ms "
              f"({rec['bound_by']}; {rec['floored_share']:.0%} of it floored at the empty "
              f"launch), plain {plain_ms:.4f} ms, library "
              + ("none" if library_ms is None else
                 f"{library_ms:.6f} ms [{library_ms_range[0]:.6f}, {library_ms_range[1]:.6f}]"))
        # The kernels line takes each probe's first run (smem_input's
        # 1,024-row table); the others stand in the report's cases.
        rows[tag] = rec
        timed.setdefault(probe.name, rec)

    # The order of the next redesigns: kernels slower than one PyTorch call
    # for the same function, the largest factor first.
    slower = sorted(({"name": tag, "factor": r["ms"] / r["library_ms"], "ms": r["ms"],
                      "library_ms": r["library_ms"]}
                     for tag, r in rows.items()
                     if r["library_ms"] is not None and r["ms"] > r["library_ms"]),
                    key=lambda e: -e["factor"])
    print(f"slower than their PyTorch call (medians of {PROBE_ROUNDS} replays of "
          f"{PROBE_REPS} launches, in turns), largest factor first: "
          + (", ".join(f"{e['name']} {e['factor']:.2f}x ({e['ms']:.6f} vs "
                       f"{e['library_ms']:.6f} ms)" for e in slower) or "none"))

    # packet_walk_core on the tool's table and on each seeded table (votes
    # nowhere, everywhere, at its tiles' edges, scattered): bit-equal to its
    # plain version, timed as every probe is, beside the floor of its add
    # chain (each lane adds its visited rows in walk order: one dependent
    # float add, WALK_ADD_CLOCKS, a step).
    walk = pallas.packet_walk_core
    clk = sm_clock_hz()
    walks = {}
    for pattern in (None,) + pallas.WALK_TABLES:
        ins, outs = walk.inputs(dev, pattern), walk.outputs(dev)
        walk.launch(ins, outs)
        want = walk.compute(*ins)
        torch.cuda.synchronize()
        if not torch.equal(outs[0].view(torch.int32), want.view(torch.int32)):
            fail(f"packet_walk_core differs from its plain version on the {pattern} table "
                 f"(max |diff| {(outs[0] - want).abs().max().item()})")
        ms, ms_range = spread(alternating_ms([lambda: walk.launch(ins, outs)], PROBE_REPS,
                                             PROBE_ROUNDS)[0])
        steps = len(pallas.walk_path(ins[0]))
        nbytes, _ = walk.work(ins)
        walks[pattern or "arange"] = r = dict(
            steps=steps, ms=ms, ms_range=ms_range, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            chain_floor_ms=steps * WALK_ADD_CLOCKS / clk * 1e3)
        print(f"packet_walk_core, {pattern or 'arange'} table: bit-equal; {steps} steps, "
              f"{ms:.6f} ms [{ms_range[0]:.6f}, {ms_range[1]:.6f}], bound {r['bound_ms']:.3e} "
              f"ms (bytes), add chain's floor {r['chain_floor_ms']:.6f} ms ({WALK_ADD_CLOCKS} "
              f"clocks a step at {clk / 1e6:.0f} MHz)  [{card}]")
    # vmem_scalar_dynamic_read at 128 seeded index sets of a seeded table8
    # (-0.0 read first), while_walk_smem on each seeded link table with
    # seeded rays: bit-equal to their plain versions; NaN on a cyclic table.
    sum4 = pallas.vmem_scalar_dynamic_read
    tab8, outs = pallas.sum4_table8(dev), sum4.outputs(dev)
    for k, idx in enumerate(pallas.sum4_sets(device=dev)):
        sum4.launch((tab8, idx), outs)
        if not torch.equal(outs[0].view(torch.int32), sum4.compute(tab8, idx).view(torch.int32)):
            fail(f"vmem_scalar_dynamic_read differs from its plain version at seeded set {k}")
    # smem_input on the seeded table of each size (-0.0 read first) and on
    # a table of -0.0 (+0.0 out); scatter_add on each seeded index set.
    smem = mosaic.smem_input
    for n_rows in probes.SMEM_ROWS:
        tab = mosaic.seeded_smem_tab(n_rows, dev)
        for t in (tab, torch.full_like(tab, -0.0)):
            outs = smem.outputs(dev)
            smem.launch((t,), outs)
            if not torch.equal(outs[0].view(torch.int32), smem.compute(t).view(torch.int32)):
                fail(f"smem_input differs from its plain version on a seeded {n_rows}-row table")
    scatter = pallas.scatter_add
    table = scatter.inputs(dev)[0]
    for name in pallas.SCATTER_SETS:
        idx = pallas.scatter_set(name, dev)
        outs = scatter.outputs(dev)
        scatter.launch((table, idx), outs)
        if not torch.equal(outs[0].view(torch.int32),
                           scatter.compute(table, idx).view(torch.int32)):
            fail(f"scatter_add differs from its plain version on the {name} index set")
    link = mosaic.while_walk_smem
    for table in mosaic.LINK_TABLES + mosaic.CYCLIC_TABLES:
        ins, outs = link.inputs(dev, table), link.outputs(dev)
        link.launch(ins, outs)
        torch.cuda.synchronize()
        if table in mosaic.CYCLIC_TABLES:
            ok = bool(torch.isnan(outs[0]).all())
        else:
            ok = torch.equal(outs[0].view(torch.int32), link.compute(*ins).view(torch.int32))
        if not ok:
            fail(f"while_walk_smem on the {table} link table: "
                 + ("not NaN" if table in mosaic.CYCLIC_TABLES else "differs from plain"))
    # take_along_axis_axis0 and take_rowgather at each seeded index set:
    # negative indices wrap, other out-of-range ones give NaN, as in JAX.
    for gather, sets in ((pallas.take_along_axis_axis0, pallas.take_along_sets),
                         (pallas.take_rowgather, pallas.take_rows_sets)):
        table = gather.inputs(dev)[0]
        for name, idx in sets(dev).items():
            outs = gather.outputs(dev)
            gather.launch((table, idx), outs)
            if not torch.equal(outs[0].view(torch.int32),
                               gather.compute(table, idx).view(torch.int32)):
                fail(f"{gather.name} differs from its plain version on the {name} index set")
    print(f"take_along_axis_axis0, take_rowgather: bit-equal on the "
          f"{', '.join(pallas.INDEX_SETS)} index sets (JAX's index rule)")
    print(f"vmem_scalar_dynamic_read: bit-equal at 128 seeded index sets; smem_input: "
          f"bit-equal on seeded tables of {', '.join(map(str, probes.SMEM_ROWS))} rows and on "
          f"tables of -0.0; scatter_add: bit-equal on the {', '.join(pallas.SCATTER_SETS)} "
          f"index sets; while_walk_smem: bit-equal on the {', '.join(mosaic.LINK_TABLES)} link "
          f"tables, NaN on the {', '.join(mosaic.CYCLIC_TABLES)} ones")
    # smem_input at each table size beside the floor of its add chain (64
    # dependent adds in i order, WALK_ADD_CLOCKS each).
    smem_chain_ms = 64 * WALK_ADD_CLOCKS / clk * 1e3
    print("smem_input (64 reads from L2, 64 dependent adds): " + ", ".join(
        f"{n_rows} rows {rows[f'smem_input({n_rows})']['ms']:.6f} ms" for n_rows in probes.SMEM_ROWS)
        + f"; its add chain's floor {smem_chain_ms:.6f} ms ({WALK_ADD_CLOCKS} clocks an add at "
        f"{clk / 1e6:.0f} MHz)  [{card}]")
    limit = probes.smem_limit(dev)
    onehot_ms = timed["onehot_matmul_gather"]["ms"]
    print(f"onehot_matmul_gather's {onehot_ms:.6f} ms: the launch of its grid and clusters "
          f"{cluster_ms[0]:.6f} ms, one cluster barrier {sync_ms[0] - cluster_ms[0]:.6f} ms more, "
          f"the rest (index and slice loads, products, shuffle tree, remote writes, the second "
          f"barrier, the combine) {onehot_ms - sync_ms[0]:.6f} ms")
    steps = walks["arange"]["steps"]
    walk_ms = timed["packet_walk_core"]["ms"]
    # while_walk_smem on the tool's 100 links: rounds of dependent lookups
    # (pointer doubling up to J_5 = succ^32, ceil(log2 n) rounds but at most
    # 5, then one round for each further 32 cursors), then 99 dependent adds
    # an element in walk order.
    links_ms = timed["while_walk_smem"]["ms"]
    link_ins = mosaic.while_walk_smem.inputs(dev)
    nodes = link_ins[0].shape[0]
    link_rounds = min(math.ceil(math.log2(nodes)), 5) + (nodes - 1) // 32
    link_adds = len(mosaic.walk_cursors(link_ins[0]))
    answers = dict(
        empty_ms=floor_ms, empty_ms_range=floor_range, smem_optin_bytes=limit, leaf_bytes=LEAF_BYTES,
        onehot_geometry=geometry, empty_cluster_ms=cluster_ms[0],
        empty_cluster_ms_range=cluster_ms[1], empty_cluster_barrier_ms=sync_ms[0],
        empty_cluster_barrier_ms_range=sync_ms[1],
        leaves_per_block=limit // LEAF_BYTES, walk_steps=steps, walk_tables=walks,
        slower_than_call=slower, walk_step_us=walk_ms / steps * 1e3,
        walk_step_over_floor_us=(walk_ms - floor_ms) / steps * 1e3,
        link_rounds=link_rounds, link_adds=link_adds, smem_add_chain_floor_ms=smem_chain_ms,
        link_over_floor_per_round_us=(links_ms - floor_ms) / link_rounds * 1e3,
        link_add_chain_floor_ms=link_adds * WALK_ADD_CLOCKS / clk * 1e3)
    print(f"for the BVH kernels: a block's {limit} B of opt-in shared memory hold "
          f"{answers['leaves_per_block']} leaves of 128 triangles ({LEAF_BYTES} B each); "
          f"one step of the packet walk (the table streamed, votes taken ahead; "
          f"{steps} steps) {answers['walk_step_us']:.4f} us "
          f"({answers['walk_step_over_floor_us']:.4f} us over the empty launch)")
    print(f"while_walk_smem (the {nodes}-link chain by {link_rounds} rounds of lookups, pointer "
          f"doubling, then {link_adds} adds an element in walk order): {links_ms:.6f} ms, "
          f"{answers['link_over_floor_per_round_us']:.4f} us a round (its whole time over the "
          f"empty launch, the links' load, the adds and the stores included, over the rounds); its "
          f"add chain's floor {answers['link_add_chain_floor_ms']:.6f} ms ({WALK_ADD_CLOCKS} "
          f"clocks an add at {clk / 1e6:.0f} MHz)  [{card}]")
    lap("capability probes", t0)
    kernels = [
        dict(name=f"probe_{p.name}", route="cuda",
             source="lumillyrender_tpu_torch/csrc/probes.cu", replaces=p.replaces,
             launches=launches[p.name], max_abs_err=timed[p.name]["max_abs_err"],
             ms=timed[p.name]["ms"], ms_range=timed[p.name]["ms_range"],
             plain_ms=timed[p.name]["plain_ms"], bound_ms=timed[p.name]["bound_ms"],
             bound_by=timed[p.name]["bound_by"], library_ms=timed[p.name]["library_ms"],
             library_ms_range=timed[p.name]["library_ms_range"])
        for p in probes.PROBES]
    return dict(cases=rows, launches=launches, **answers), kernels


# ---------------------------------------------------------------------------
# Data parallelism, vr.toml and the simple sky (phases 22-24)
# ---------------------------------------------------------------------------

# The films of two ranks against one rank's, which sums the same samples in
# another order: within 1e-5 of the film's max (and of 1).
DP_FILM_TOL = 1e-5
DP_RANKS = 2
DP_SPP_PER_RANK = 16  # phase 22's one-rank reference renders chunks of this too
# A simple sky whose horizon is not zero (tests/test_camera.py's colours).
SIMPLE_MERIDIAN = (0.1, 0.2, 0.9)
SIMPLE_HORIZON = (0.9, 0.8, 0.7)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rank(rank: int, world: int, port: int, out: Path) -> int:
    """One of phase 22's ranks, started as `chip_smoke.py --dp-rank R
    --dp-world N --dp-port P --dp-out FILE`: the new-cbox film over a gloo
    group whose ranks share the card, its launch counts zeroed just before
    and read just after; writes what it measured to FILE (.npz)."""
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, str(REPO))
    from lumillyrender_tpu_torch.ops import cuda_bounce
    from lumillyrender_tpu_torch.parallel import shard
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    shard.init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        cbox = compile_scene_file(REPO / "assets" / "new-cbox.toml", device="cuda")
        with PlainCalls() as plain:
            cuda_bounce.reset_counts()
            r = shard.render_sharded(cbox, seed=SEED, spp_per_device=DP_SPP_PER_RANK)
            torch.cuda.synchronize()
            launches = cuda_bounce.counts()
        p, target = dp_train_inputs(cbox)
        steps = []
        for _ in range(2):  # the first call (eager, then captured), a replay
            with PlainCalls() as step_plain:
                cuda_bounce.reset_counts()
                loss, grads = shard.sharded_train_step(cbox.data, cbox.settings, p, target,
                                                       np.arange(DP_TRAIN_SPP))
                torch.cuda.synchronize()
                steps.append(dict(launches=cuda_bounce.counts(), plain_calls=step_plain.calls))
        from lumillyrender_tpu_torch.diff.render import kept_plan, leaves

        grads = [g.cpu().numpy() for g in leaves(grads) if g.is_floating_point()]
        steps.append(dict(replays=kept_plan().replays))
    finally:
        shard.dist.destroy_process_group()
    np.savez(out, film=r.film, rays=r.rays, seconds=r.seconds, reduce_ms=r.reduce_ms,
             plain_calls=plain.calls,
             launches=json.dumps(launches), steps=json.dumps(steps),
             loss=loss.cpu().numpy(), **{f"grad{k}": g for k, g in enumerate(grads)})
    return 0


def with_simple_sky(c):
    """`c` (a CompiledScene on the card) under the simple sky."""
    dev = c.data.sky.color.device
    sky = dataclasses.replace(c.data.sky, color=torch.tensor(SIMPLE_MERIDIAN, device=dev),
                              color2=torch.tensor(SIMPLE_HORIZON, device=dev))
    from lumillyrender_tpu_torch.scene.data import SKY_SIMPLE

    return dataclasses.replace(c, data=dataclasses.replace(c.data, sky=sky),
                               settings=dataclasses.replace(c.settings, sky_kind=SKY_SIMPLE))


def resized(c, w, h, spp):
    """`c` at a w x h film of `spp` samples."""
    return dataclasses.replace(c, settings=dataclasses.replace(
        c.settings, width=w, height=h, spp=spp))


def kernel_vs_plain_films(tag, small, walk=None):
    """`small` (a CompiledScene at a small film): the kernel path twice and
    the plain path once, all on the card, through check_films. The plain
    path's BVH queries take the plain walk or, with `walk` (a
    `cuda_bounce.counts()` name), the walk kernel of the `fused="off"` step
    (`plain_walk=False`: the one `bvh_route` picks), which must be `walk`
    and the only kernel the plain path launches."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import render
    from lumillyrender_tpu_torch.ops import cuda_bounce

    st = small.settings
    f_k = render(small, seed=SEED, device="cuda").film
    f_k2 = render(small, seed=SEED, device="cuda").film
    cuda_bounce.reset_counts()
    f_p, _ = trace_chunk(
        small, 0, st.spp, cuda_bounce.plain_generate_rays,
        lambda s: wavefront.plain_bounce_step(small.data, st, SEED, s, plain_walk=walk is None))
    torch.cuda.synchronize()
    launches = cuda_bounce.counts()
    if walk is not None:
        print(f"{tag}: the plain path's launches (the fused=\"off\" step): {launches}")
        if not launches[walk] or any(v for k, v in launches.items() if k != walk):
            fail(f"{tag}: the plain path's walk is not {walk} alone: {launches}")
    f_p = f_p.reshape(st.height, st.width, 3).cpu().numpy() / st.spp
    return check_films(tag, {
        "kernel run vs kernel run": (f_k2, f_k), "kernel path vs plain path": (f_k, f_p)})


DP_TRAIN_SPP = 4  # phase 22's training step: 256^2 x 4 spp over the ranks
DP_TRAIN_ROUNDS = 3  # rounds of the sharded step's timing, eager and plan in turns


def dp_train_inputs(cbox):
    """Phase 22's training step: new-cbox's true parameters' film at seed 0
    (the target), the parameters with the albedo at 0.8 of its value."""
    from lumillyrender_tpu_torch.diff import params_of, render_diff

    p_true = params_of(cbox.data)
    with torch.no_grad():
        target = render_diff(cbox.data, cbox.settings, p_true, 0, DP_TRAIN_SPP)
    return p_true._replace(materials=dataclasses.replace(
        p_true.materials, color=p_true.materials.color * 0.8)), target


def eager_sharded_step(scene, st, p, target, offsets):
    """`sharded_train_step` with its rank's step run op by op (as before the
    step was a plan's): `eager_film_and_grads` on this rank's block at seed
    0, then the same one all-reduce of the loss and the float gradients."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads
    from lumillyrender_tpu_torch.diff.render import leaves
    from lumillyrender_tpu_torch.parallel import shard

    rank, world = shard.ranks()
    per = len(offsets) // world
    local = torch.as_tensor(np.asarray(offsets[rank * per:(rank + 1) * per], np.int64))
    loss, _, grads = eager_film_and_grads(scene, st, p, target, 0, per, sample_offsets=local)
    buf = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in leaves(grads)
                                         if g.is_floating_point()]) / world
    shard.ChunkReducer(loss.device)(buf)
    return buf


def sharded_step_one_rank(card, cbox) -> dict:
    """Phase 22's training step on a world-size-1 NCCL group:
    `sharded_train_step` (a training plan's, with the offsets buffer) at
    DP_TRAIN_SPP spp, its first call (eager, then captured) and a replay
    with the counts zeroed just before and read just after each, against
    `film_and_grads`'s plan on the same offsets (sample ids 0..spp-1 at
    seed 0: loss and every gradient bit-equal, 80 bounce and 80 bounce_bwd
    launches, no plain step); then the step eager (`eager_sharded_step`)
    and through the plan in turns, median and range, with the plan's
    capture seconds and pool bytes."""
    from lumillyrender_tpu_torch.diff import film_and_grads
    from lumillyrender_tpu_torch.diff.render import clear_plans, kept_plan, leaves
    from lumillyrender_tpu_torch.ops import cuda_bounce
    from lumillyrender_tpu_torch.parallel import shard

    st, spp = cbox.settings, DP_TRAIN_SPP
    p, target = dp_train_inputs(cbox)
    clear_plans()
    cuda_bounce.reset_counts()
    loss_ref, _, grads_ref = film_and_grads(cbox.data, st, p, target, 0, spp)
    torch.cuda.synchronize()
    ref_launches = cuda_bounce.counts()
    clear_plans()
    rec = {}
    for call in ("first", "replay"):
        with PlainCalls() as plain:
            cuda_bounce.reset_counts()
            loss, grads = shard.sharded_train_step(cbox.data, st, p, target, np.arange(spp))
            torch.cuda.synchronize()
            launches = cuda_bounce.counts()
        equal = bool(torch.equal(loss, loss_ref) and all(
            torch.equal(a, b) for a, b in zip(leaves(grads), leaves(grads_ref))))
        plan = kept_plan()
        rec[call] = dict(loss=float(loss), bit_equal=equal, launches=launches,
                         plain_calls=plain.calls, replays=plan.replays)
        print(f"sharded_train_step, 1 rank, 256^2 x {spp} spp, {call} call: loss "
              f"{float(loss):.6e} vs film_and_grads {float(loss_ref):.6e}; loss and every "
              f"gradient bit-equal {equal}; launches {launches} (film_and_grads "
              f"{ref_launches}), plain calls {plain.calls}; plan replays {plan.replays}")
        if (not equal or launches["bounce"] != 80 or launches["bounce_bwd"] != 80
                or launches != ref_launches or plain.calls or plan.offsets is None
                or plan.replays != (call == "replay")):
            fail(f"sharded_train_step on one rank is not film_and_grads: {rec[call]}")
    rec.update(capture_seconds=plan.capture_seconds, pool_bytes=plan.pool_bytes,
               launches_per_replay=plan.launches)
    fns = {"eager": lambda: eager_sharded_step(cbox.data, st, p, target, np.arange(spp)),
           "plan": lambda: shard.sharded_train_step(cbox.data, st, p, target, np.arange(spp))}
    ms = {"eager": [], "plan": []}
    for r in range(DP_TRAIN_ROUNDS):
        for who in (("eager", "plan") if r % 2 == 0 else ("plan", "eager")):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fns[who]()
            torch.cuda.synchronize()
            ms[who].append((time.monotonic() - t0) * 1e3)
    for who in ("eager", "plan"):
        med, rng_ = spread(ms[who])
        rec[f"{who}_ms"] = dict(ms=ms[who], median=med, range=rng_)
        print(f"sharded_train_step ({who}), 1 NCCL rank, 256^2 x {spp} spp: median {med:.4f} "
              f"ms [{rng_[0]:.4f}, {rng_[1]:.4f}] over {DP_TRAIN_ROUNDS} in turns  [{card}]")
    print(f"sharded step's plan: captured in {plan.capture_seconds:.3f} s, graph pool "
          f"{plan.pool_bytes} B, launches per replay {plan.launches}")
    clear_plans()
    return rec


def gloo_train_steps(card, cbox, outs) -> dict:
    """The two gloo ranks' `sharded_train_step` (written by `dp_rank`):
    each rank's first call and its replay launch 80 bounce and 80
    bounce_bwd kernels (each rank's step at half the one-rank step's lanes,
    its own plan), no plain step; both ranks hold the same loss and
    gradients, which agree with the ranks' blocks computed here eagerly on
    one process (`eager_film_and_grads` on offsets 0-1 and 2-3, each loss
    and float gradient halved and added) within DP_FILM_TOL of each one's
    largest magnitude (bit-equal printed)."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads
    from lumillyrender_tpu_torch.diff.render import leaves

    got = [np.load(path) for path in outs]
    steps = [json.loads(str(g["steps"])) for g in got]
    p, target = dp_train_inputs(cbox)
    per = DP_TRAIN_SPP // DP_RANKS
    parts = [eager_film_and_grads(cbox.data, cbox.settings, p, target, 0, per,
                                  sample_offsets=torch.arange(r * per, (r + 1) * per))
             for r in range(DP_RANKS)]
    want = [sum(part[0] / DP_RANKS for part in parts).cpu().numpy()]
    floats = [[g for g in leaves(part[2]) if g.is_floating_point()] for part in parts]
    want += [sum(f[k] / DP_RANKS for f in floats).cpu().numpy() for k in range(len(floats[0]))]
    rec = dict(steps=steps)
    for r, g in enumerate(got):
        vals = [g["loss"]] + [g[f"grad{k}"] for k in range(len(want) - 1)]
        gaps = [float(np.abs(a - b).max(initial=0.0) / max(np.abs(b).max(initial=0.0), 1e-30))
                for a, b in zip(vals, want)]
        same = all(np.array_equal(a, b) for a, b in zip(vals, [got[0]["loss"]] + [
            got[0][f"grad{k}"] for k in range(len(want) - 1)]))
        exact = all(np.array_equal(a, b) for a, b in zip(vals, want))
        rec[f"rank{r}"] = dict(max_rel_gap=max(gaps), bit_equal=exact, same_as_rank0=same)
        print(f"rank {r} of {DP_RANKS} (gloo), sharded_train_step 256^2 x {DP_TRAIN_SPP} spp: "
              f"launches {[s['launches'] for s in steps[r][:2]]}, plain calls "
              f"{[s['plain_calls'] for s in steps[r][:2]]}, plan replays "
              f"{steps[r][2]['replays']}; loss and gradients the same as rank 0's {same}, "
              f"against the two blocks' eager steps max rel gap {max(gaps):.3e} (limit "
              f"{DP_FILM_TOL:g}), bit-equal {exact}  [{card}]")
        for s in steps[r][:2]:
            if (s["launches"]["bounce"] != 80 or s["launches"]["bounce_bwd"] != 80
                    or s["plain_calls"]):
                fail(f"rank {r}'s sharded training step: {s}")
        if not same or max(gaps) > DP_FILM_TOL or steps[r][2]["replays"] != 1:
            fail(f"rank {r}'s sharded training step disagrees: {rec[f'rank{r}']}")
    return rec


def data_parallel(card, lap, cbox, phase6_rate) -> dict:
    """Phase 22: render_sharded and sharded_train_step on the card."""
    from lumillyrender_tpu_torch.diff.render import clear_plans
    from lumillyrender_tpu_torch.integrator.render import render
    from lumillyrender_tpu_torch.ops import cuda_bounce
    from lumillyrender_tpu_torch.parallel import shard

    phase("22 data parallelism over ranks (parallel/shard.py; new-cbox 256^2 x 64 spp)")
    t0 = time.monotonic()
    st = cbox.settings
    report = {}
    if not shard.init_distributed(f"127.0.0.1:{free_port()}", 1, 0):
        fail("init_distributed did not join a group")
    try:
        print(f"one rank: backend {shard.dist.get_backend()}, world {shard.ranks()[1]}")
        for spd in (32, DP_SPP_PER_RANK):
            with PlainCalls() as plain:
                cuda_bounce.reset_counts()
                dp = shard.render_sharded(cbox, seed=SEED, spp_per_device=spd)
                torch.cuda.synchronize()
                dp_launches = cuda_bounce.counts()
            cuda_bounce.reset_counts()
            ref = render(cbox, seed=SEED, spp_chunk=spd, device="cuda")
            torch.cuda.synchronize()
            ref_launches = cuda_bounce.counts()
            bit_equal = bool(np.array_equal(dp.film, ref.film))
            max_abs = float(np.abs(dp.film - ref.film).max())
            # Not bit-equal: the banks add with atomics (two renders differ so).
            tol = DP_FILM_TOL * max(1.0, float(np.abs(ref.film).max()))
            print(f"render_sharded, 1 rank (NCCL), {spd} spp a chunk: launches {dp_launches}, "
                  f"plain calls {plain.calls}; render's launches {ref_launches}; rays "
                  f"{dp.rays:.0f} vs {ref.rays:.0f}; film bit-equal {bit_equal}, max |diff| "
                  f"{max_abs:.3e} (limit {tol:.1e}); all-reduce {dp.reduce_ms:.4f} ms a chunk; "
                  f"rays/s over the film {dp.rays_per_second:.4e} (render "
                  f"{ref.rays_per_second:.4e}; phase 6, captured chunks alone "
                  f"{phase6_rate:.4e})  [{card}]")
            if (dp_launches != ref_launches or plain.calls or dp.rays != ref.rays
                    or dp_launches["bounce"] < 1 or dp_launches["raygen"] < 1
                    or not max_abs <= tol):
                fail(f"render_sharded on one rank is not render ({spd} spp a chunk)")
            report[f"one_rank_{spd}"] = dict(
                launches=dp_launches, render_launches=ref_launches, rays=dp.rays,
                film_bit_equal=bit_equal, film_max_abs=max_abs, film_tol=tol,
                reduce_ms=dp.reduce_ms, rays_per_s=dp.rays_per_second,
                render_rays_per_s=ref.rays_per_second, seconds=dp.seconds)
            if spd == DP_SPP_PER_RANK:
                one_rank = (dp.film, dp_launches)

        report["train_step"] = sharded_step_one_rank(card, cbox)
    finally:
        shard.dist.destroy_process_group()
        clear_plans()

    port = free_port()
    outs = [OUT / f"dp_rank{r}.npz" for r in range(DP_RANKS)]
    logs = [open(OUT / f"dp_rank{r}.log", "w") for r in range(DP_RANKS)]
    # gloo's ranks meet on the loopback device: the machine may have no other.
    env = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(r), "--dp-world", str(DP_RANKS), "--dp-port", str(port),
                               "--dp-out", str(outs[r])], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=str(REPO), env=env)
             for r in range(DP_RANKS)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(codes):
        print("\n".join((OUT / f"dp_rank{r}.log").read_text()[-3000:] for r in range(DP_RANKS)))
        fail(f"the {DP_RANKS} gloo ranks exited with {codes}")
    film1, launches1 = one_rank
    ranks = []
    for r, path in enumerate(outs):
        got = np.load(path)
        launches = json.loads(str(got["launches"]))
        gap = float(np.abs(got["film"] - film1).max())
        tol = DP_FILM_TOL * max(1.0, float(np.abs(film1).max()))
        rec = dict(launches=launches, film_max_abs=gap, rays=float(got["rays"]),
                   seconds=float(got["seconds"]), reduce_ms=float(got["reduce_ms"]),
                   plain_calls=int(got["plain_calls"]))
        ranks.append(rec)
        half = {k: v / DP_RANKS for k, v in launches1.items()}
        print(f"rank {r} of {DP_RANKS} (gloo, one card shared): launches {launches} (half of "
              f"one rank's: {half}), plain calls {rec['plain_calls']}; film max |diff| from one "
              f"rank's {gap:.3e} (limit {tol:.1e}); all-reduce {rec['reduce_ms']:.4f} ms a chunk; "
              f"rays/s "
              f"{rec['rays'] / rec['seconds']:.4e}  [{card}]")
        if launches != half or rec["plain_calls"] or gap > tol:
            fail(f"rank {r} of the gloo group: {rec}")
    report["gloo_ranks"] = ranks
    report["gloo_train_step"] = gloo_train_steps(card, cbox, outs)
    lap("data parallelism", t0)
    return report


def vr_on_card(card, lap, raygen_err) -> tuple[dict, float]:
    """Phase 23: the omnidirectional camera (vr.toml) on the card."""
    from lumillyrender_tpu_torch.integrator.render import global_lanes
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    phase("23 vr.toml on the card (the omnidirectional camera: raygen's equirect branch)")
    t0 = time.monotonic()
    dev = torch.device("cuda")
    assets = REPO / "assets"
    vr = compile_scene_file(assets / "vr.toml", device=dev)
    st = vr.settings
    n = 1 << 21
    spp = n // (st.width * st.height)
    uni = torch.empty((n, 4), dtype=torch.float32, device=dev)
    o, d, pdf, g = cuda_bounce.generate_rays(vr.data, st, SEED, 0, n, uniforms=uni)
    o_p, d_p, pdf_p, g_p = cuda_bounce.plain_generate_rays(vr.data, st, SEED, 0, n)
    u_p = torch.stack(rng.uniform4(SEED, global_lanes(st, 0, n, dev), 0x40000000), 1)
    torch.cuda.synchronize()
    bits_equal = torch.equal(uni.view(torch.int32), u_p.view(torch.int32))
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
    errs = dict(o=rel(o, o_p), d=rel(d, d_p), g=rel(g, g_p), pdf=rel(pdf, pdf_p))
    raygen_err = max(raygen_err, (o - o_p).abs().max().item(), (d - d_p).abs().max().item())
    unit = bool((g == 1).all() and (pdf == 1).all())
    print(f"vr 256x128x{spp} omnidirectional: lanes {n}, rng bits equal {bits_equal}, g = pdf = "
          f"1 {unit}, max rel err " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    # As phase 3: the card's sinf/cosf against PyTorch's, an ulp apart.
    if not bits_equal or not unit or max(errs.values()) > 1e-5:
        fail(f"the omnidirectional raygen disagrees with its plain version: {errs}")
    ms = graph_ms(lambda: cuda_bounce.raygen_launch(vr.data, st, SEED, 0, o, d))
    plain_ms = events_ms(lambda: cuda_bounce.plain_generate_rays(vr.data, st, SEED, 0, n), 3)
    bound = 24 * n / HBM_BYTES_PER_S * 1e3
    print(f"omnidirectional raygen at {n} lanes: {ms:.4f} ms/launch (bare launch), bound "
          f"{bound:.4f} ms (bytes), plain {plain_ms:.3f} ms  [{card}]")
    del o, d, uni, o_p, d_p, u_p
    result, launches, _ = run_main_path(
        "vr", [str(assets / "vr.toml"), "--out", str(OUT / "vr.png")],
        want=("raygen", "bounce"), must_be_zero=("bvh", "bounce_bvh"))
    if result.film.shape != (128, 256, 3):
        fail(f"vr film shape {result.film.shape}")
    films = kernel_vs_plain_films("vr 64x32x8", resized(vr, 64, 32, 8))
    lap("vr", t0)
    return dict(raygen=dict(errs=errs, bits_equal=bits_equal, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, lanes=n),
                cli_launches=launches, cli_rays_per_s=result.rays_per_second,
                film_checks=films), raygen_err


def simple_sky(card, lap, cbox, geo) -> tuple[dict, float, float]:
    """Phase 24: kernels 2 and 4 under the simple sky."""
    from lumillyrender_tpu_torch.integrator.render import default_spp_chunk
    from lumillyrender_tpu_torch.ops import cuda_bounce

    phase("24 the simple sky in kernels 2 and 4 (new-cbox, welcome-geo)")
    t0 = time.monotonic()
    report, errs = {}, {}
    for name, c, kernel, launch, bvh in (
            ("new-cbox", cbox, cuda_bounce.bounce, cuda_bounce.bounce_launch, False),
            ("welcome-geo", geo, cuda_bounce.bounce_bvh, cuda_bounce.bounce_bvh_launch, True)):
        cs = with_simple_sky(c)
        n = cs.settings.width * cs.settings.height * default_spp_chunk(cs.settings)
        err = 0.0
        for b in (0, 3, 7, 70):
            state = random_state(cs.data, n, 4000 * b + len(name), b)
            m = check_bounce(f"{name} simple sky@b{b}", cs, kernel, state)
            err = max(err, *m["max_abs"].values())
        errs[name] = err
        # The bare launch at full width under the simple sky and under the
        # scene's own sky, on the same state.
        state = random_state(cs.data, n, 4100, 3)
        times = {}
        for tag, cc in (("simple", cs), ("own sky", c)):
            tables = cuda_bounce.pack_tables(cc.data, bvh=bvh)
            out = cuda_bounce._step_out(state)
            times[tag] = graph_ms(lambda: launch(cc.data, cc.settings, SEED, state, tables, out))
        print(f"{name} at {n} lanes, bounce 3: {times['simple']:.4f} ms/launch under the simple "
              f"sky, {times['own sky']:.4f} under its own sky (bare launch)  [{card}]")
        w, h, spp = (64, 64, 8) if name == "new-cbox" else (64, 48, 4)
        report[name] = dict(lanes=n, ms=times, max_abs=err, film_checks=kernel_vs_plain_films(
            f"{name} simple sky {w}x{h}x{spp}", resized(cs, w, h, spp)))
    lap("simple sky", t0)
    return report, errs["new-cbox"], errs["welcome-geo"]


# ---------------------------------------------------------------------------
# Differentiable BVH, IBL and simple-sky scenes (phase 25)
# ---------------------------------------------------------------------------

# FD vs AD on welcome-geo through the hybrid step (kernel 4 forward, kernel
# 3 in the backward's recompute), sampling pinned at theta0: {tag: (part,
# field, index (None: the texel whose AD gradient is largest), FD step,
# atol, rtol[, pixels])}. The albedo's and the texel's films are
# polynomial and linear in them (tests/test_diff.py's steps and
# tolerances). The focus distance moves every camera ray across the
# bunny's and the box's edges and the IBL's texel borders: the
# detached-sampling gradient leaves those boundary terms out (on the CPU at
# 16x12 x 1 spp, AD 0.00309 against FD 0.00723 over the whole film, 0.01339
# against 0.01344 over the 172 of 192 pixels where no boundary is crossed;
# at 64x48 x 4 spp -1.290e-5 against -1.270e-5 over 73.6% of the pixels),
# so it is compared over those pixels ("interior"), at the camera's rtol of
# tests/test_diff.py (its atol fits that scene's scale, not this one's).
GEO_FD = {
    "albedo": ("materials", "color", (0, 0), 2e-2, 1e-2, 0.08),
    "ibl texel": ("sky", "ibl", None, 0.1, 1e-5, 0.01),
    "focus distance": ("camera", "focus_distance", (), 16.0, 1e-8, 0.25, "interior"),
}


def walks_per_bounce(c) -> int:
    """The BVH queries a bounce of `c`'s recompute walks: the primary ray,
    and under pt-direct with lights the shadow ray."""
    return 2 if c.settings.integrator == "pt-direct" and c.settings.has_lights else 1


def hybrid_film_and_grads(tag, c, spp, want, p=None):
    """film_and_grads on `c` (a CompiledScene on the card) from the parameters
    `p` (default: the albedo at 0.8 of its value) toward the film at the
    true ones, through make_step_diff's hybrid step, with the counts zeroed
    just before and read just after: each kernel of `want` ({name:
    launches}) exactly so often and no other, the plain step once a bounce
    and only inside the recomputes, the plain walk never, the scene's tables
    packed once and the BVH's at most once; every gradient finite; a second
    run bit-equal; then against the plain path (PlainDiffStep, the plain
    walk): the films through check_films' gate and every gradient within
    TRAIN_PLAIN_RTOL of its largest magnitude (kernel 4's forward flips a
    lane's decision now and then against the plain step, and such a lane
    takes another path: at welcome-geo's full width the largest gap was
    2.5e-6, PERF.md §6.14). The steps run eagerly (`eager_film_and_grads`),
    so that the plain step's calls and the packing are counted and the plain
    path can take their place; then `plan_matches_eager` holds the main
    entry, `film_and_grads` (a captured TrainPlan on the card), to the
    eager step at the same point. Returns (record, params, target,
    gradients)."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads as film_and_grads
    from lumillyrender_tpu_torch.diff import params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh

    st = c.settings
    if cuda_bounce.diff_step_kind(c.data, st, on_card=True) != "hybrid":
        fail(f"{tag}: make_step_diff does not take the hybrid step")
    p_true = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, st, p_true, SEED, spp)
    if p is None:
        p = p_true._replace(materials=dataclasses.replace(
            p_true.materials, color=p_true.materials.color * 0.8))
    packs = dict(pack_tables=0, pack_bvh=0)
    saved = [(m, name, getattr(m, name)) for m, name in ((cuda_bounce, "pack_tables"),
                                                         (cuda_bvh, "pack_bvh"))]
    for mod, name, fn in saved:
        def counted(*a, _fn=fn, _name=name, **k):
            packs[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        with PlainCalls() as calls:
            cuda_bounce.reset_counts()
            t0 = time.monotonic()
            loss, film, grads = film_and_grads(c.data, st, p, target, SEED, spp)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            launches = cuda_bounce.counts()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    l2, f2, g2 = film_and_grads(c.data, st, p, target, SEED, spp)
    torch.cuda.synchronize()
    bit_equal = (torch.equal(loss, l2) and torch.equal(film, f2)
                 and all(torch.equal(a, b) for a, b in zip(leaves(grads), leaves(g2))))
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(grads))
    bounces = st.max_bounces
    rec = dict(lanes=st.width * st.height * spp, launches=launches, plain_calls=calls.calls,
               recomputes=calls.recomputes, seconds=seconds, bit_equal=bit_equal,
               finite=finite, loss=float(loss), packs=packs)
    print(f"{tag} x {spp} spp, film_and_grads on the card: launches {launches}; plain forward "
          f"steps or walks {calls.calls}, recomputes {calls.recomputes}; tables packed {packs}; "
          f"{seconds:.3f} s (first call); two runs bit-equal {bit_equal}; every gradient finite "
          f"{finite}")
    bad = [k for k, v in launches.items() if v != want.get(k, 0)]
    # The step packs the scene's tables once, and a BVH's tables are packed
    # at most once per Bvh and kept on it: never in a bounce.
    if (bad or calls.calls or calls.recomputes != bounces or not bit_equal or not finite
            or packs["pack_tables"] != 1 or packs["pack_bvh"] > 1):
        fail(f"{tag}: the hybrid training step: {rec} (expected launches {want})")
    rec["plan"] = plan_matches_eager(tag, c, p, target, spp, (loss, film, grads), launches)
    t0 = time.monotonic()
    with PlainDiffStep():
        _, f_plain, g_plain = film_and_grads(c.data, st, p, target, SEED, spp)
    torch.cuda.synchronize()
    rec["plain_seconds"] = time.monotonic() - t0
    rec["film_checks"] = check_films(f"{tag} x {spp} spp training", {
        "kernel path vs plain path": (film.cpu().numpy(), f_plain.cpu().numpy())})
    rec["vs_plain"] = grads_gap(grads, g_plain)
    print(f"{tag}: kernel path vs plain path (autograd of the plain step, plain walk; "
          f"{rec['plain_seconds']:.3f} s), max |diff| over max |plain| per gradient: "
          + ", ".join(f"{k} {v:.2e}" for k, v in rec["vs_plain"].items())
          + f" (held to {TRAIN_PLAIN_RTOL:g})")
    if not max(rec["vs_plain"].values()) < TRAIN_PLAIN_RTOL:
        fail(f"{tag}: kernel-path gradients disagree with the plain path's: {rec['vs_plain']}")
    return rec, p, target, grads


def plan_matches_eager(tag, c, p, target, spp, want, want_launches):
    """`film_and_grads`, the main training entry, on `c` (a CompiledScene on
    the card) at `p`, `target`, SEED and `spp`, the point of the eager step
    `want` (loss, film, gradients) that launched `want_launches`: on the
    card a TrainPlan, whose first call runs the step eagerly on a side
    stream and then captures it, and whose second call is a replay. The
    counts are zeroed just before each call and read just after: each call
    launches what the eager step launched, and gives its loss, film and
    every gradient bit for bit. Returns the record: the step kind, the
    capture's seconds and the graph pool's bytes, each call's seconds (host
    clock, to a synchronize), launches."""
    from lumillyrender_tpu_torch.diff import film_and_grads
    from lumillyrender_tpu_torch.diff.render import clear_plans, kept_plan
    from lumillyrender_tpu_torch.ops import cuda_bounce

    clear_plans()
    rec = {}
    for call in ("first", "replay"):
        cuda_bounce.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = film_and_grads(c.data, c.settings, p, target, SEED, spp)
        torch.cuda.synchronize()
        rec[f"{call}_seconds"] = time.monotonic() - t0
        rec[f"{call}_launches"] = cuda_bounce.counts()
        rec[f"{call}_bit_equal"] = _bit_equal(got, want)
        del got
    plan = kept_plan()
    rec.update(kind=plan and plan.kind, replays=plan and plan.replays,
               capture_seconds=plan and plan.capture_seconds,
               pool_bytes=plan and plan.pool_bytes)
    print(f"{tag} x {spp} spp through film_and_grads (a {rec['kind']} TrainPlan): first call "
          f"(eager on a side stream, then the capture) {rec['first_seconds']:.3f} s, capture "
          f"{rec['capture_seconds']:.3f} s, graph pool {rec['pool_bytes']} B; a replay "
          f"{rec['replay_seconds']:.4f} s; each bit-equal to the eager step "
          f"{rec['first_bit_equal']} / {rec['replay_bit_equal']}; launches each "
          f"{rec['first_launches'] == want_launches} / {rec['replay_launches'] == want_launches}"
          f" equal to the eager step's")
    if (plan is None or plan.graph is None or plan.replays != 1 or not rec["first_bit_equal"]
            or not rec["replay_bit_equal"] or rec["first_launches"] != want_launches
            or rec["replay_launches"] != want_launches):
        fail(f"{tag}: film_and_grads through the plan is not the eager step: {rec} (eager "
             f"launches {want_launches})")
    clear_plans()
    torch.cuda.empty_cache()
    return rec


def scatter_ms(geo, n):
    """The row gathers' gradient scatters of the plain step at a training
    step's full width, as the hybrid's backward runs them: every lane's
    cotangent row added into a table row. The plain step gathers the sky
    for every lane (and masks after), so the IBL texture gets n rows, and
    so does each live material field (welcome-geo: 2 rows). Timed with
    CUDA events: autograd's own backward of a gather, index_put_(accumulate)
    (sorted; each row's run added serially), index_add_ (atomics, in no
    fixed order) and the port's `table.scatter_rows` (blocks of lanes, then
    a fixed-order sum), on the texels of welcome-geo's camera rays (bounce
    0: a few hundred texels behind the box), of random directions (a
    scattered bounce), and on random material rows; with the longest run
    of one row and each result's largest difference from index_put_'s.
    Returns {case: record}."""
    from lumillyrender_tpu_torch.ops import cuda_bounce, sky as sky_ops
    from lumillyrender_tpu_torch.ops.table import scatter_rows

    sky = geo.data.sky
    _, d_cam, _, _ = cuda_bounce.plain_generate_rays(geo.data, geo.settings, SEED, 0, n)
    g = torch.Generator(device="cuda").manual_seed(5)
    d_rnd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device="cuda"), dim=1)
    texels = sky.ibl.shape[0] * sky.ibl.shape[1]
    nm = geo.data.materials.type_id.shape[0]
    rows = torch.randn((n, 3), generator=g, device="cuda")
    out = {}
    for tag, idx, m in (("IBL texels, camera rays", sky_ops.ibl_texel(sky, d_cam), texels),
                        ("IBL texels, random rays", sky_ops.ibl_texel(sky, d_rnd), texels),
                        (f"material rows ({nm})",
                         torch.randint(0, nm, (n,), generator=g, device="cuda"), nm)):
        runs = torch.bincount(idx, minlength=m)
        zero = lambda: torch.zeros((m, 3), device="cuda")
        fns = dict(index_put=lambda: zero().index_put_((idx,), rows, accumulate=True),
                   index_add=lambda: zero().index_add_(0, idx, rows),
                   scatter_rows=lambda: scatter_rows(idx, rows, m))
        ref = fns["index_put"]()
        scale = ref.abs().max()
        rec = dict(rows_read=int((runs > 0).sum()), longest_run=int(runs.max()))
        for name, fn in fns.items():
            rec[f"{name}_ms"] = events_ms(fn, 5)
            rec[f"{name}_max_rel"] = ((fn() - ref).abs().max() / scale).item()
        rec["scatter_rows_repeats"] = bool(torch.equal(fns["scatter_rows"](),
                                                       fns["scatter_rows"]()))
        print(f"scatter of {n} rows, {tag} into {m} ({rec['rows_read']} read, longest run "
              f"{rec['longest_run']}): index_put_(accumulate) {rec['index_put_ms']:.4f} ms, "
              f"index_add_ {rec['index_add_ms']:.4f} ms (max |diff| / max "
              f"{rec['index_add_max_rel']:.1e}), scatter_rows {rec['scatter_rows_ms']:.4f} ms "
              f"({rec['scatter_rows_max_rel']:.1e}; repeats bit for bit "
              f"{rec['scatter_rows_repeats']})")
        if not (rec["scatter_rows_repeats"] and rec["scatter_rows_max_rel"] < 1e-5):
            fail(f"scatter_rows: {rec}")
        out[tag] = rec
    return out


def run_example():
    """examples/invert_materials_torch.py at its defaults on the card, with
    the counts zeroed just before and read just after: the bounce and
    backward kernels launched, no plain step or walk; fails unless the
    albedo error falls by more than 2x."""
    import importlib.util

    from lumillyrender_tpu_torch.ops import cuda_bounce

    spec = importlib.util.spec_from_file_location(
        "invert_materials_torch", REPO / "examples" / "invert_materials_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with PlainCalls() as calls:
        cuda_bounce.reset_counts()
        t0 = time.monotonic()
        err0, err = example.main([])
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = cuda_bounce.counts()
    rec = dict(err0=err0, err=err, seconds=seconds, launches=launches, plain_calls=calls.calls)
    print(f"the example at its defaults: max albedo error {err0:.4f} -> {err:.4f} in "
          f"{seconds:.2f} s; launches {launches}; plain calls {calls.calls}")
    if (not err < 0.5 * err0 or calls.calls or launches["bounce"] < 1
            or launches["bounce_bwd"] < 1):
        fail(f"the inverse-rendering example: {rec}")
    return rec


def diff_scenes(card, lap, cbox, geo, ibl, terrain_1m):
    """Phase 25: differentiable BVH, IBL and simple-sky scenes on the card
    (make_step_hybrid). Returns (report, kernel 3's launch-weighted ms in
    the welcome-geo step's backward, (the welcome-geo step's parameters,
    target and gradients at 512x368 x 4 spp))."""
    from lumillyrender_tpu_torch.ops import cuda_bounce

    phase("25 differentiable BVH, IBL and simple-sky scenes (make_step_hybrid)")
    t0 = t_part = time.monotonic()
    report = {}

    def part(name):
        nonlocal t_part
        lap(f"25 {name}", t_part)
        t_part = time.monotonic()

    small = resized(geo, 64, 48, 4)
    with PlainCalls() as calls:
        cuda_bounce.reset_counts()
        report["fd_vs_ad"] = fd_gate(small, GEO_FD)
        torch.cuda.synchronize()
        launches = cuda_bounce.counts()
    print(f"FD vs AD on welcome-geo 64x48x4: launches {launches}; plain forward steps or walks "
          f"{calls.calls}, recomputes {calls.recomputes}")
    if (calls.calls or not calls.recomputes or launches["bounce_bvh"] < 1
            or launches["bvh"] < 1 or launches["bounce"] or launches["bounce_bwd"]):
        fail(f"the welcome-geo FD gates left the kernel path: {launches}, {calls.calls} calls")
    part("FD vs AD")
    geo_want = {"bounce_bvh": 80, "bvh": 80 * walks_per_bounce(geo)}
    full = resized(geo, geo.settings.width, geo.settings.height, 4)
    rec, p_geo, t_geo, g_geo = hybrid_film_and_grads("welcome-geo 512x368", full, 4, geo_want)
    report["welcome-geo"] = rec
    part("welcome-geo against the plain path")
    timing = {}
    for spp in (4, 16):
        target = t_geo
        if spp != 4:
            from lumillyrender_tpu_torch.diff import params_of, render_diff

            with torch.no_grad():
                target = render_diff(geo.data, geo.settings, params_of(geo.data), SEED, spp)
        timing[spp] = time_train_step(geo, spp, p_geo, target, 2 if spp == 4 else 1,
                                      tag="welcome-geo 512x368", top=12)
        by_name = timing[spp].pop("by_name")
        k3 = [(t, n) for name, (t, n) in by_name.items() if "k3::kernel" in name]
        scatter = [(t, n) for name, (t, n) in by_name.items() if "indexing_backward" in name]
        timing[spp]["k3"] = [sum(t for t, _ in k3), sum(n for _, n in k3)]
        timing[spp]["index_put_backward"] = [sum(t for t, _ in scatter), sum(n for _, n in scatter)]
        print(f"  kernel 3 in the backward: {timing[spp]['k3'][1]} launches, "
              f"{timing[spp]['k3'][0]:.4f} ms; index_put_(accumulate) kernels (the row "
              f"gathers' gradients through table.scatter_rows, the film banks): "
              f"{timing[spp]['index_put_backward'][1]} launches, "
              f"{timing[spp]['index_put_backward'][0]:.4f} ms  [{card}]")
    report["timing"] = {str(k): v for k, v in timing.items()}
    report["scatter"] = scatter_ms(geo, geo.settings.width * geo.settings.height * 4)
    k3_ms, k3_n = timing[4]["k3"]
    part("timing")
    report["ibl-material"], _, _, _ = hybrid_film_and_grads(
        "ibl-material 320x240", ibl, 4, {"bounce": 80})
    part("ibl-material")
    for name, c, want in (("new-cbox", cbox, {"bounce": 80}), ("welcome-geo", geo, geo_want)):
        w, h = (64, 64) if name == "new-cbox" else (64, 48)
        r, _, _, _ = hybrid_film_and_grads(f"{name} simple sky {w}x{h}",
                                           resized(with_simple_sky(c), w, h, 4), 4, want)
        if not (r["vs_plain"].get("SkyData.color", 1.0) < TRAIN_PLAIN_RTOL
                and r["vs_plain"].get("SkyData.color2", 1.0) < TRAIN_PLAIN_RTOL):
            fail(f"{name} simple sky: no gradient in the sky's colours, or off the plain path's")
        report[f"{name} simple sky"] = r
    part("the simple sky")
    report["terrain-1m"], _, _, _ = hybrid_film_and_grads(
        "terrain-1m 64x64", resized(terrain_1m, 64, 64, 1), 1,
        {"bounce_bvh": 80, "bvh_wide": 80 * walks_per_bounce(terrain_1m)})
    part("terrain-1m")
    report["example"] = run_example()
    lap("differentiable BVH, IBL and simple-sky scenes", t0)
    return report, (k3_ms / k3_n if k3_n else None), (p_geo, t_geo, g_geo)


# ---------------------------------------------------------------------------
# The JAX package's own differentiable path on the card (phase 26)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "full", "hybrid", "isect", "isect+samp")
REMAT_TIMED = "full"  # the policy whose plan is timed against its eager step
# The policies whose replay is profiled (the search share of a replay's
# kernels compares the two).
REMAT_PROFILED = ("full", "isect")


class Phases:
    """While open, counts the kernels' launches inside `torch.autograd.grad`
    (`backward`, by `cuda_bounce.counts()` name: a training step's
    backward pass) apart from the rest, and the plain walk's calls
    (`plain_walks`)."""

    def __enter__(self):
        from lumillyrender_tpu_torch.ops import cuda_bounce, intersect

        self.backward = {k: 0 for k in cuda_bounce.counts()}
        self.plain_walks = 0
        self.saved = [(torch.autograd, "grad", torch.autograd.grad),
                      (intersect, "_walk_tris", intersect._walk_tris)]

        def grad(*a, _fn=torch.autograd.grad, **k):
            before = cuda_bounce.counts()
            try:
                return _fn(*a, **k)
            finally:
                for name, v in cuda_bounce.counts().items():
                    self.backward[name] += v - before[name]

        def walk(*a, _fn=intersect._walk_tris, **k):
            self.plain_walks += 1
            return _fn(*a, **k)

        torch.autograd.grad, intersect._walk_tris = grad, walk
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def policy_plan(tag, c, p, target, spp, want, want_launches, card, timed=True,
                profiled=True) -> dict:
    """`film_and_grads` on `c` (a CompiledScene on the card) through its
    training plan, against the eager step `want` (loss, film, gradients at
    `p`, `target`, SEED) that launched `want_launches`: the first call
    (eager on a side stream, then the capture) and a replay at a new seed
    and albedo, each bit-equal to the eager step at its point with the
    same launches, the capture's seconds and pool bytes; with `timed`, one
    eager step and one replay in turns (host clock to a synchronize); with
    `profiled`, a replay's device busy ms and idle share (profiler) and
    its peak memory. Returns the record."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads, film_and_grads
    from lumillyrender_tpu_torch.diff.render import clear_plans, kept_plan
    from lumillyrender_tpu_torch.ops import cuda_bounce

    st = c.settings
    p2 = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color * 1.1))
    eager = lambda q, seed: eager_film_and_grads(c.data, st, q, target, seed, spp)  # noqa: E731
    planned = lambda q, seed: film_and_grads(c.data, st, q, target, seed, spp)  # noqa: E731
    clear_plans()
    rec = dict(capture_seconds=[], pool_bytes=[])
    checks = (("first", p, SEED, want, want_launches), ("replay", p2, SEED + 1, None, None))
    for call, q, seed, w, w_launches in checks:
        if w is None:
            cuda_bounce.reset_counts()
            w = eager(q, seed)
            torch.cuda.synchronize()
            w_launches = cuda_bounce.counts()
        cuda_bounce.reset_counts()
        got = planned(q, seed)
        torch.cuda.synchronize()
        launches = cuda_bounce.counts()
        equal = _bit_equal(got, w)
        rec[f"{call}_bit_equal"] = equal
        if not equal or launches != w_launches:
            fail(f"{tag}: the plan's {call} call is not the eager step: launches {launches}, "
                 f"eager {w_launches}, bit-equal {equal}")
        del got, w
    plan = kept_plan()
    if plan is None or plan.kind != "plain" or plan.replays != 1:
        fail(f"{tag}: not one plain-kind plan replayed once ({plan and plan.kind})")
    rec["capture_seconds"].append(plan.capture_seconds)
    rec["pool_bytes"].append(plan.pool_bytes)
    rec["launches_per_replay"] = plan.launches
    captured = (f"captures {[round(x, 3) for x in rec['capture_seconds']]} s, pools "
                f"{rec['pool_bytes']} B; first call and replay bit-equal to the eager step, "
                f"launches equal  [{card}]")
    if not (timed or profiled):
        print(f"{tag}: {captured}")
        clear_plans()
        return rec
    ms = {"eager": [], "plan": []}
    for who in ("eager", "plan") if timed else ():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        (eager if who == "eager" else planned)(p2, SEED + 20)
        torch.cuda.synchronize()
        ms[who].append((time.monotonic() - t0) * 1e3)
    peak = {}

    def replay():
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        planned(p2, SEED + 30)
        torch.cuda.synchronize()
        peak["plan"] = torch.cuda.max_memory_allocated() - held

    busy, records, _ = _step_busy(replay) if profiled else (None, None, None)
    rec.update(busy_ms=busy, records=records, peak_bytes=peak.get("plan"))
    line = ""
    if timed:
        (med,), (e_med,) = ms["plan"], ms["eager"]
        rec.update(ms=ms, median_ms=med, eager_median_ms=e_med, speedup=e_med / med,
                   idle_share=None if busy is None else 1.0 - busy / med)
        line += (f"a replay {med:.4f} ms against the eager step's {e_med:.4f} in turns "
                 f"({rec['speedup']:.2f}x); ")
    if profiled:
        idle = rec.get("idle_share")
        line += (f"replay busy {'not measured' if busy is None else f'{busy:.4f} ms'}, idle "
                 f"share {'not measured' if idle is None else f'{idle:.4f}'}, {records} kernel "
                 f"records, peak memory {peak['plan'] / 2**30:.3f} GiB; ")
    print(f"{tag}: {line}{captured}")
    clear_plans()
    return rec


def remat_policies(card, lap, cbox, geo, terrain_1m, geo_step, phase6_chunk_ms) -> dict:
    """Phase 26: `fused="off"`, the JAX package's own differentiable path
    (autograd of the plain step, kernel 3 as its walk), on welcome-geo's
    training step at 512x368 x 4 spp under each recompute policy, eager
    and through `film_and_grads`'s captured plan; kernel 7 as its walk on
    terrain-1m, likewise; and the plain step's forward film on new-cbox
    against the kernels'."""
    from lumillyrender_tpu_torch.diff import eager_film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, render
    from lumillyrender_tpu_torch.ops import cuda_bounce

    phase('26 remat_policies: fused="off" (autograd of the plain step, kernel 3 its walk) '
          "on welcome-geo 512x368 x 4 spp under none, full, hybrid, isect, isect+samp, "
          "eager and as a captured plan")
    t0 = time.monotonic()
    p, target, g_auto = geo_step
    spp = 4
    base = resized(geo, geo.settings.width, geo.settings.height, spp)
    st_off = dataclasses.replace(base.settings, fused="off")
    if cuda_bounce.diff_step_kind(base.data, st_off, on_card=True) != "plain":
        fail('fused="off" does not take the plain step on the card')
    n = st_off.width * st_off.height * spp
    bounces = st_off.max_bounces
    wide = sum(b1 - b0 for w, b0, b1 in wavefront._stage_plan(n, st_off) if w > 48 * 1024)
    want_bwd = {"none": 0, "full": 2 * bounces, "hybrid": 2 * wide, "isect": 0,
                "isect+samp": 0}
    report, runs = {}, {}
    c_off = dataclasses.replace(base, settings=st_off)
    for mode in REMAT_POLICIES:
        st = dataclasses.replace(st_off, bwd_remat=mode)
        with Phases() as ph:
            cuda_bounce.reset_counts()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            loss, film, grads = eager_film_and_grads(base.data, st, p, target, SEED, spp)
            torch.cuda.synchronize()
            first_s = time.monotonic() - t
            peak = torch.cuda.max_memory_allocated() - held
            launches = cuda_bounce.counts()
        k3_bwd = ph.backward["bvh"]
        k3_fwd = launches["bvh"] - k3_bwd
        others = {k: v for k, v in launches.items() if k != "bvh" and v}
        rec = dict(k3_forward=k3_fwd, k3_backward=k3_bwd, k3_backward_want=want_bwd[mode],
                   plain_walks=ph.plain_walks, other_launches=others, eager_s=first_s)
        print(f"{mode}: the eager step {first_s:.2f} s; kernel 3 {k3_fwd} launches forward, "
              f"{k3_bwd} backward (want {2 * bounces} and {want_bwd[mode]}); plain walks "
              f"{ph.plain_walks}; other kernels {others or 'none'}")
        if (k3_fwd != 2 * bounces or k3_bwd != want_bwd[mode] or ph.plain_walks
                or others):
            fail(f'{mode}: the fused="off" training step\'s launches: {rec}')
        runs[mode] = [loss, film] + leaves(grads)
        if mode == "full":
            g_full = grads
        with PlainCalls() as calls:
            rec["plan"] = policy_plan(f'welcome-geo 512x368 x 4, fused="off", {mode}',
                                      dataclasses.replace(c_off, settings=st), p, target, spp,
                                      (loss, film, grads), launches, card,
                                      timed=mode == REMAT_TIMED,
                                      profiled=mode in REMAT_PROFILED)
        rec["eager_peak_bytes"] = peak
        if calls.n["_walk_tris"]:
            fail(f"{mode}: the plain walk ran in the plan's steps")
        del loss, film, grads
        report[mode] = rec
        torch.cuda.empty_cache()
    # Every policy computes the same function in the same order.
    for mode in REMAT_POLICIES[1:]:
        if not all(torch.equal(a, b) for a, b in zip(runs[mode], runs["full"])):
            fail(f"{mode}: the loss, film or gradients differ from full's")
    report["vs_default"] = grads_gap(g_full, g_auto)
    full, isect = (report[m]["plan"]["records"] for m in ("full", "isect"))
    report["search_launch_share"] = (full - isect) / full if full else None
    share = report["search_launch_share"]
    print(f"the five policies bit-equal (loss, film, every gradient); against the default "
          f"dispatch (make_step_hybrid), max |diff| over max per gradient: "
          + ", ".join(f"{k} {v:.2e}" for k, v in report["vs_default"].items())
          + f" (held to {TRAIN_PLAIN_RTOL:g}); the recompute's searches are "
          + ("not measured" if share is None else f"{share:.4f}")
          + " of full's device launches a replay")
    if not max(report["vs_default"].values()) < TRAIN_PLAIN_RTOL:
        fail(f'fused="off" gradients disagree with the default dispatch: {report["vs_default"]}')
    lap("26 welcome-geo policies", t0)

    # Kernel 7 as the walk: terrain-1m at K=128 (phase 25's 64x64 x 1 spp).
    t1 = time.monotonic()
    small = resized(terrain_1m, 64, 64, 1)
    p_t = params_of(small.data)
    with torch.no_grad():
        target_t = render_diff(small.data, small.settings, p_t, SEED, 1)
    p_t = p_t._replace(materials=dataclasses.replace(
        p_t.materials, color=p_t.materials.color * 0.8))
    terrain = {}
    for mode in ("full", "isect"):
        st = dataclasses.replace(small.settings, fused="off", bwd_remat=mode)
        with Phases() as ph:
            cuda_bounce.reset_counts()
            want = eager_film_and_grads(small.data, st, p_t, target_t, SEED, 1)
            torch.cuda.synchronize()
            launches = cuda_bounce.counts()
        g = want[2]
        wide_bwd = ph.backward["bvh_wide"]
        terrain[mode] = dict(k7_forward=launches["bvh_wide"] - wide_bwd, k7_backward=wide_bwd,
                             plain_walks=ph.plain_walks, launches=launches, grads=g)
        terrain[mode]["plan"] = plan_matches_eager(
            f'terrain-1m 64x64 x 1, fused="off", {mode}', dataclasses.replace(small, settings=st),
            p_t, target_t, 1, want, launches)
        del want
        print(f'terrain-1m 64x64 x 1 spp, fused="off", {mode}: kernel 7 '
              f"{launches['bvh_wide'] - wide_bwd} launches forward, {wide_bwd} backward; "
              f"launches {launches}; plain walks {ph.plain_walks}")
        others = {k: v for k, v in launches.items() if k != "bvh_wide" and v}
        if (launches["bvh_wide"] - wide_bwd != 2 * bounces or ph.plain_walks or others
                or wide_bwd != (2 * bounces if mode == "full" else 0)):
            fail(f'terrain-1m fused="off" {mode}: {terrain[mode]}')
    if not all(torch.equal(a, b) for a, b in zip(leaves(terrain["full"].pop("grads")),
                                                 leaves(terrain["isect"].pop("grads")))):
        fail('terrain-1m fused="off": isect\'s gradients differ from full\'s')
    report["terrain-1m"] = terrain
    lap("26 terrain-1m", t1)

    # The plain step's forward film, brute force on the card, at the kernel
    # film's chunk width: the brute-force ladder resamples within a chunk,
    # so a film depends on the chunk width.
    t1 = time.monotonic()
    chunk = 32
    off = dataclasses.replace(cbox, settings=dataclasses.replace(cbox.settings, fused="off"))
    with Phases() as ph:
        cuda_bounce.reset_counts()
        f_off = render(off, seed=SEED, spp_chunk=chunk, device="cuda").film
        torch.cuda.synchronize()
        launches = cuda_bounce.counts()
    f_kernel = render(cbox, seed=SEED, spp_chunk=chunk, device="cuda").film
    films = check_films('new-cbox 256^2 x 64 spp, fused="off"',
                        {"plain step vs kernel path": (f_off, f_kernel)})
    renderer = ChunkRenderer(off.data, off.settings, SEED, "cuda")
    _, chunk_ms, per_chunk = chunk_rate(renderer, chunk, 2, 0)
    where = "the captured plan" if renderer.graphed else "the host loop"
    print(f'new-cbox fused="off": {chunk_ms:.4f} ms a {chunk}-spp chunk in {where} (phase 6, '
          f"the kernels in the captured plan: {phase6_chunk_ms:.4f} ms); launches {launches}, "
          f"per chunk {per_chunk}; plain walks {ph.plain_walks}  [{card}]")
    if launches["raygen"] != 2 or any(launches[k] for k in launches if k != "raygen"):
        fail(f'new-cbox fused="off" launched {launches}: raygen twice and nothing else')
    report["new-cbox"] = dict(chunk_ms=chunk_ms, phase6_chunk_ms=phase6_chunk_ms, loop=where,
                              launches=launches, film_checks=films)
    lap("26 new-cbox film", t1)
    lap("remat policies", t0)
    return report


# Phase 27: the JAX package's render-changing environment knobs.
# Kernel 1's operations bound counts what one lane of the function needs
# (raygen_ops) against the pipes that run it on an H100 SM, per clock: 64
# lanes of integer ALU (add, logic, shift, funnel shift), 64 of integer
# multiply-add, which issues on the FP32 FMA pipe, 128 of FP32 add and
# multiply, and 16 of the special-function unit (reciprocal, reciprocal
# square root, int-to-float conversion) (Hopper white paper; CUDA C++
# Programming Guide, arithmetic instruction throughput).
PIPE_RATES = dict(int_alu=64, int_fma=64, fp32=128, xu=16)
# SASS opcodes by pipe, for the built instances' whole listings (a
# diagnosis of a build, printed beside the bound, not a bound).
PIPE_OPS = dict(int_alu=("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP",
                         "SEL", "PRMT", "IMNMX", "IABS"),
                int_fma=("IMAD", "IMUL"), fp32=("FADD", "FMUL", "FFMA"), xu=("MUFU", "I2F"))
RAYGEN_BYTES = 24  # o and d written, 12 B each (the ideal pinhole writes no g)
KNOB_WIDTHS = (8, 16, 64)  # LLR_TREELET_K values held on welcome-geo
GEO_WIDE_MIN_TRIS = 50_000  # an LLR_WIDE_MIN_TRIS that builds welcome-geo at K=128
THREEFRY_FILM = (64, 64, 8)  # w, h, spp of the card-against-CPU film


# The plain step on the card and on the CPU: both are PyTorch, and both
# round sqrt and the divisions by host numbers as IEEE asks (ops/vec.py:
# `sqrt`, `over`), but the two devices' math libraries give sin, cos, acos,
# atan2 and exp 1-2 ulps apart on up to 42% of elements
# (tools/torch_device_fork.py), so a path forks now and then and the films
# differ in the pixels it touches, under either mixer (the pcg4d pair shows
# the devices' own gap), where two runs on one device agree to
# check_films' gate. Each limit lies between the card's film against the
# CPU's (threefry |mean| rel 5.2e-5, 0.921 of pixels within 1e-4, 8x8
# block rel 0.0008; pcg4d 8.8e-5, 0.916, 0.0019 on an H100; 1.6e-4, 0.914,
# 0.0018 for threefry before sqrt and the divisions were repaired) and the
# control, the card's pcg4d film against the CPU's threefry film, which
# draws another sample of every pixel (2.1e-3, 0.069, 0.084): the control
# must fail each.
CROSS_DEVICE = dict(mean_rel=3e-4, block_rel=0.006, within=0.7)


def cross_device(a, b) -> dict:
    """CROSS_DEVICE's readings of film `a` against film `b` (8x8 blocks),
    with check_films' max |diff|, and which limits hold (`holds`)."""
    mean_rel, within, max_abs = film_gap(a, b)
    h, w = b.shape[:2]
    block = lambda x: x.reshape(h // 8, 8, w // 8, 8, 3).mean(axis=(1, 3))
    block_rel = float(np.abs(block(a) - block(b)).max() / np.abs(block(b)).max())
    holds = dict(mean_rel=mean_rel < CROSS_DEVICE["mean_rel"],
                 block_rel=block_rel < CROSS_DEVICE["block_rel"],
                 within=within >= CROSS_DEVICE["within"])
    return dict(mean_rel=mean_rel, within=within, max_abs=max_abs, block_rel=block_rel,
                holds=holds)


def device_films(tag, films) -> dict:
    """The card's plain-step film against the CPU's, under threefry and
    under pcg4d, and the control (the card's pcg4d film against the CPU's
    threefry film): the threefry pair must hold every CROSS_DEVICE limit,
    the control must fail every one."""
    recs = {}
    for name, a, b in (("threefry", "threefry_cuda", "threefry_cpu"),
                       ("pcg4d", "pcg4d_cuda", "pcg4d_cpu"),
                       ("control", "pcg4d_cuda", "threefry_cpu")):
        r = recs[name] = cross_device(films[a], films[b])
        print(f"{tag}, {name}, card ({a}) vs CPU ({b}): |mean| rel {r['mean_rel']:.3e}, "
              f"pixels within 1e-4 of the film max {r['within']:.5f}, 8x8 block max rel "
              f"{r['block_rel']:.4f}, max |diff| {r['max_abs']:.3e}; CROSS_DEVICE limits held "
              f"{r['holds']}")
    if not all(recs["threefry"]["holds"].values()):
        fail(f"{tag}: the threefry film on the card is not the CPU's: {recs['threefry']}")
    if any(recs["control"]["holds"].values()):
        fail(f"{tag}: CROSS_DEVICE passes a film of another mixer: {recs['control']}")
    return recs


def knobs_child(out: Path) -> int:
    """Phase 27's threefry process, started as `chip_smoke.py --knobs-child
    FILE` with LLR_RNG=threefry (read when ops/rng.py is imported): the CLI
    on new-cbox at full size with --fused off, its launch counts and plain
    step calls (every chunk a captured plan's); that film's chunk ms as
    the plan's replay; the 64^2 film on the card and on the CPU at one
    chunk width; one welcome-geo training step at 512x368 x 4 spp under
    fused="off" taken eagerly, with its launch counts, then through
    `film_and_grads`'s plan (its first call and a replay, each bit-equal
    to the eager step with its launches). Writes what it measured to FILE
    (.npz)."""
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, str(REPO))
    from lumillyrender_tpu_torch.diff import eager_film_and_grads, params_of, render_diff
    from lumillyrender_tpu_torch.diff.render import leaves
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, render
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file

    if rng._MIXER != "threefry":
        fail(f"LLR_RNG=threefry was not read at import: the mixer is {rng._MIXER!r}")
    assets = REPO / "assets"
    rec = {}
    result, rec["cli_launches"], rec["cli_calls"] = run_main_path(
        "new-cbox 256^2 x 64 spp, LLR_RNG=threefry --fused off",
        [str(assets / "new-cbox.toml"), "--fused", "off", "--spp-chunk", "32",
         "--out", str(OUT / "new-cbox-threefry.png")], want=("raygen",),
        must_be_zero=("bounce", "bounce_bvh", "bounce_bwd", "bvh"), plain_step=True)
    rec["cli_seconds"] = result.seconds
    secs = rec["seconds"] = {}
    t0 = time.monotonic()
    cbox = compile_scene_file(assets / "new-cbox.toml", device="cuda")
    off = dataclasses.replace(cbox, settings=dataclasses.replace(cbox.settings, fused="off"))
    renderer = ChunkRenderer(off.data, off.settings, SEED, "cuda")
    _, rec["chunk_ms"], _ = chunk_rate(renderer, 32, 1, 0)
    rec["graphed"] = renderer.graphed
    secs["chunk timing"] = time.monotonic() - t0
    t0 = time.monotonic()
    w, h, spp = THREEFRY_FILM
    small = resized(off, w, h, spp)
    films = {}
    for mixer in ("threefry", "pcg4d"):  # pcg4d: the two devices' own gap
        rng._MIXER = mixer
        for dev in ("cuda", "cpu"):
            films[f"{mixer}_{dev}"] = render(small, seed=SEED, spp_chunk=spp, device=dev).film
    rng._MIXER = "threefry"
    secs["films"] = time.monotonic() - t0
    t0 = time.monotonic()
    geo = compile_scene_file(assets / "welcome-geo.toml", device="cuda")
    st = dataclasses.replace(geo.settings, spp=4, fused="off")
    p = params_of(geo.data)
    with torch.no_grad():
        target = render_diff(geo.data, st, p, SEED, 4)
    p = p._replace(materials=dataclasses.replace(p.materials, color=p.materials.color * 0.8))
    with PlainCalls() as calls:
        cuda_bounce.reset_counts()
        t0 = time.monotonic()
        loss, film, grads = want = eager_film_and_grads(geo.data, st, p, target, SEED, 4)
        torch.cuda.synchronize()
        rec["train_seconds"] = time.monotonic() - t0
        rec["train_launches"] = cuda_bounce.counts()
    rec["train_calls"] = dict(calls.n)
    rec["train_plan"] = plan_matches_eager(
        'welcome-geo 512x368, LLR_RNG=threefry, fused="off"',
        dataclasses.replace(geo, settings=st), p, target, 4, want, rec["train_launches"])
    vals = [loss, film] + leaves(grads)
    rec["train_finite"] = all(bool(torch.isfinite(v).all()) for v in vals)
    rec["train_loss"] = float(loss)
    rec["grad_color_abs_sum"] = float(grads.materials.color.abs().sum())
    secs["training step"] = time.monotonic() - t0
    np.savez(out, rec=json.dumps(rec), **films)
    return 0


def raygen_threefry_check(cbox) -> dict:
    """Kernel 1's threefry instance against its plain version at 2,097,152
    lanes (new-cbox 256^2 x 32 spp, lanes from a sample offset that wraps
    past 2^32), the mixer set as LLR_RNG sets it at import (`rng._MIXER`)."""
    from lumillyrender_tpu_torch.integrator.render import global_lanes
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng

    dev = torch.device("cuda")
    st = cbox.settings
    n = st.width * st.height * 32
    off = 2**32 // (st.width * st.height) - 16
    uni = torch.empty((n, 4), dtype=torch.float32, device=dev)
    rng._MIXER = "threefry"
    try:
        o, d, pdf, g = cuda_bounce.generate_rays(cbox.data, st, SEED, off, n, uniforms=uni)
        o_p, d_p, pdf_p, g_p = cuda_bounce.plain_generate_rays(cbox.data, st, SEED, off, n)
        want = torch.stack(rng.uniform4(SEED, global_lanes(st, off, n, dev), 0x40000000), 1)
        on_cpu = torch.stack(rng.uniform4(SEED, global_lanes(st, off, n, "cpu"), 0x40000000), 1)
    finally:
        rng._MIXER = "pcg4d"
    pcg = torch.stack(rng.uniform4(SEED, global_lanes(st, off, n, dev), 0x40000000), 1)
    torch.cuda.synchronize()
    bits_equal = (torch.equal(uni.view(torch.int32), want.view(torch.int32))
                  and torch.equal(want.cpu().view(torch.int32), on_cpu.view(torch.int32)))
    differ = float((uni != pcg).float().mean())
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
    errs = dict(o=rel(o, o_p), d=rel(d, d_p), g=rel(g, g_p), pdf=rel(pdf, pdf_p))
    max_abs = max((o - o_p).abs().max().item(), (d - d_p).abs().max().item())
    print(f"raygen threefry instance, {n} lanes: random words bit-equal to rng.uniform4 under "
          f"threefry, on the card and on the CPU, {bits_equal} ({differ:.4f} of them differ "
          f"from pcg4d's); max rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not bits_equal or differ < 0.99 or max(errs.values()) > 1e-5:
        fail(f"raygen's threefry instance disagrees with its plain version: {errs}")
    return dict(lanes=n, offset=off, bits_equal=bits_equal, max_rel=errs, max_abs_err=max_abs)


def sass_functions(lib: Path) -> dict:
    """{kernel function: [(address, instruction)]} of a built library
    (`cuobjdump -sass`), NOPs left out."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if cur is not None and m and _SASS.match(m.group(2)).group(3) != "NOP":
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


_SASS = re.compile(r"(?:@(!?)(U?P\w+)\s+)?([A-Z][A-Z0-9_.]*)\s*(.*)")


def opcode_pipes(ops) -> dict:
    """Instructions per pipe (PIPE_OPS) of a list of opcodes, and all of
    them (issue)."""
    c = collections.Counter(ops)
    return dict(issue=sum(c.values()), **{k: sum(c[o] for o in names)
                                          for k, names in PIPE_OPS.items()})


def raygen_sass() -> dict:
    """Kernel 1's two instances in SASS (the built library): per instance,
    its whole listing per pipe (every camera kind, both pixel orders and the
    slow paths: more than any lane issues), and what threefry's adds to
    pcg4d's. A view of the build, printed; the bound is `raygen_ops`."""
    from lumillyrender_tpu_torch.ops import cuda_build

    funcs = sass_functions(cuda_build.lib_path("raygen"))
    out, opcodes = {}, {}
    for fn, code in funcs.items():
        for flag, name in (("ILb1E", "threefry"), ("ILb0E", "pcg4d")):
            if "raygen_kernel" in fn and flag in fn:
                whole = [_SASS.match(ins).group(3).split(".")[0] for _, ins in code]
                out[name], opcodes[name] = opcode_pipes(whole), collections.Counter(whole)
    if set(out) != {"threefry", "pcg4d"}:
        fail(f"raygen's SASS holds no two instances: {list(funcs)}")
    tf, pcg = opcodes["threefry"], opcodes["pcg4d"]
    return dict(out, added={k: tf[k] - pcg[k] for k in sorted(tf | pcg) if tf[k] != pcg[k]})


def raygen_ops(settings, mixer: str) -> dict:
    """The operations one lane of kernel 1 needs at `settings` (the ideal
    pinhole, no random words written), per pipe of PIPE_RATES: counted from
    the function, not from a build. What is the same for every lane (the
    key schedule, the divisors' magic numbers, pcg4d's counter, seed and
    salt words) is the launch's, not the lane's.
    * the lane: its index (a multiply-add) and its id (an add);
    * the pixel: a division by a runtime divisor as a multiply-high (a
      multiply-high, 4 adds and shifts) with its remainder (a multiply-add),
      by w h, then by w in raster order, or by the tile's size, the tiles a
      row and the tile width, with 2 multiply-adds for px and py;
    * the 2 random words the ideal pinhole uses: threefry's first block (20
      rounds of add, rotate and xor, 10 key additions, the key's add to the
      lane id: 71), or pcg4d's (the lane's multiply-add, 3 and 2 more in its
      rounds, an add of a uniform product, 4 shifts and 4 xors); then a
      word's shift, conversion and multiply each;
    * the camera: px and py converted; sx and sy (an add, a divide, a
      subtract, a multiply each); the sensor point (12); the direction (3),
      its normalisation (a dot of 5, a max, a square root, 3 divides). An
      IEEE divide is a reciprocal and 5 FP32 operations, a square root a
      reciprocal square root and 4."""
    from lumillyrender_tpu_torch.integrator.render import tile_dims

    if settings.camera_kind != 0:
        raise ValueError("raygen_ops counts the ideal pinhole's lanes only")
    tiles = tile_dims(settings) is not None
    divisions = 4 if tiles else 2
    ops = collections.Counter(int_fma=1 + 2 * divisions + 2 * tiles,
                              int_alu=1 + 4 * divisions)
    ops.update(dict(int_alu=71) if mixer == "threefry" else dict(int_fma=6, int_alu=9))
    ops.update(int_alu=2, xu=2, fp32=2)  # the words to floats
    ops.update(xu=2, fp32=2 * 3 + 12 + 3 + 5 + 1)
    ops.update(fp32=5 * 5 + 4, xu=5 + 1)  # 5 divides, a square root
    return dict(ops)


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi's clocks.max.sm), in Hz."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True,
                       timeout=60)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def raygen_threefry_times(card, cbox, rec) -> dict:
    """Both instances of kernel 1 timed in turns at `rec`'s lanes (bare
    launch, CUDA graph), each beside its bound: the larger of its bytes and
    the operations a lane needs (`raygen_ops`) on their busiest pipe; the
    SASS of the build per pipe (`raygen_sass`); threefry's plain version."""
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng

    dev = torch.device("cuda")
    st = cbox.settings
    n, off = rec["lanes"], rec["offset"]
    o_buf = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_buf = torch.empty((n, 3), dtype=torch.float32, device=dev)

    def launch(mixer):
        def run():
            rng._MIXER = mixer
            try:
                cuda_bounce.raygen_launch(cbox.data, st, SEED, off, o_buf, d_buf)
            finally:
                rng._MIXER = "pcg4d"
        return run

    pcg_ms, tf_ms, tf_ms2, pcg_ms2 = (graph_ms(launch(m), 20) for m in
                                      ("pcg4d", "threefry", "threefry", "pcg4d"))
    rng._MIXER = "threefry"
    try:
        plain_ms = events_ms(lambda: cuda_bounce.plain_generate_rays(cbox.data, st, SEED, 0, n),
                             3)
    finally:
        rng._MIXER = "pcg4d"
    bytes_ms = RAYGEN_BYTES * n / HBM_BYTES_PER_S * 1e3
    sass = raygen_sass()
    clk = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pipe_ms = lambda counts: {k: counts.get(k, 0) * n / (sms * rate * clk) * 1e3
                              for k, rate in PIPE_RATES.items()}
    bounds = {}
    for name in ("pcg4d", "threefry"):
        ops = raygen_ops(st, name)
        need_ms = pipe_ms(ops)
        ops_ms = max(need_ms.values())
        bounds[name] = dict(ops=ops, ops_pipe_ms=need_ms, ops_ms=ops_ms,
                            sass_whole=sass[name], sass_whole_ms=pipe_ms(sass[name]),
                            bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        b = bounds[name]
        print(f"raygen {name} instance at {sms} SMs x {clk / 1e6:.0f} MHz, {n} lanes: a lane "
              f"needs {ops} ("
              + ", ".join(f"{k} {v:.4f}" for k, v in need_ms.items())
              + f" ms); bound {b['bound_ms']:.4f} ms ({b['bound_by']}: bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f}); the build's whole SASS listing {sass[name]} ("
              + ", ".join(f"{k} {v:.4f}" for k, v in b["sass_whole_ms"].items())
              + " ms: every kind and branch, more than a lane issues)")
    print(f"raygen SASS: threefry's whole listing less pcg4d's: {sass['added']}")
    tf = bounds["threefry"]
    rec = dict(rec, ms=statistics.mean((tf_ms, tf_ms2)), ms_each=[tf_ms, tf_ms2],
               pcg4d_ms=statistics.mean((pcg_ms, pcg_ms2)), pcg4d_ms_each=[pcg_ms, pcg_ms2],
               plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=tf["ops_ms"], bounds=bounds,
               sass_added=sass["added"], sm_clock_hz=clk, sms=sms,
               bound_ms=tf["bound_ms"], bound_by=tf["bound_by"],
               pcg4d_bound_ms=bounds["pcg4d"]["bound_ms"],
               pcg4d_bound_by=bounds["pcg4d"]["bound_by"])
    print(f"raygen at {n} lanes, in turns (pcg4d, threefry, threefry, pcg4d): threefry "
          f"{tf_ms:.4f} / {tf_ms2:.4f} ms, pcg4d {pcg_ms:.4f} / {pcg_ms2:.4f} ms a launch (bare "
          f"launch, CUDA graph); bound over time: threefry {tf['bound_ms'] / rec['ms']:.3f}, "
          f"pcg4d {rec['pcg4d_bound_ms'] / rec['pcg4d_ms']:.3f}; "
          f"plain under threefry {plain_ms:.3f} ms  [{card}]")
    return rec


def leaf_width_scene(geo, k):
    """welcome-geo with its BVH built at leaf width `k` through the knobs'
    attributes, as LLR_TREELET_K / LLR_WIDE_MIN_TRIS set them at import:
    `pack.TREELET_K` for build_tri_bvh's default width, `pack.WIDE_MIN_TRIS`
    for the compiler's K=128."""
    from lumillyrender_tpu_torch.accel import pack
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.scene.data import Bvh, tensor_of

    if k == 128:
        saved, pack.WIDE_MIN_TRIS = pack.WIDE_MIN_TRIS, GEO_WIDE_MIN_TRIS
        try:
            return compile_scene_file(REPO / "assets" / "welcome-geo.toml", device="cuda")
        finally:
            pack.WIDE_MIN_TRIS = saved
    g = geo.data.geometry
    saved, pack.TREELET_K = pack.TREELET_K, k
    try:
        arrays = pack.build_tri_bvh(*(getattr(g, f).cpu().numpy() for f in (
            "tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_mat")))
    finally:
        pack.TREELET_K = saved
    bvh = Bvh(**{f: tensor_of(v).cuda() for f, v in arrays.items()})
    return dataclasses.replace(geo, data=dataclasses.replace(geo.data, bvh=bvh))


def leaf_widths(card, geo, geo_chunk) -> dict:
    """Kernel 4 on welcome-geo at K = 8, 16, 64 and 128 against the plain
    step on random states at the chunk's full width, bounces 0 and 70 (the
    leaf width changes the walk, not a bounce's flags and roulette, which
    phase 8 checks at bounces 0, 3, 7, 70 at K=32; the random rays are
    alike at every bounce; the plain step once a bounce, on the compiled
    K=32 BVH: its nearest hit does not depend on the leaf width, but for
    exact-t ties between triangles, which parity.py counts), then one
    chunk traced with the
    kernel at each K, checked against the plain step at that K and timed at
    each stage width (time_bvh_bounce); kernel 3 on a chunk's camera rays
    and the captured forward chunk at each K and at K=32."""
    from lumillyrender_tpu_torch import parity
    from lumillyrender_tpu_torch.constants import INF
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_bvh, intersect

    n = geo.settings.width * geo.settings.height * geo_chunk
    scenes = {k: leaf_width_scene(geo, k) for k in KNOB_WIDTHS + (128,)}
    rep = {k: dict(leaves=int(c.data.bvh.blk_p0.shape[0]), walk="warp" if k > 32 else
                   "per-thread", route=list(intersect.bvh_route(c.data.bvh)), max_abs=0.0,
                   checks={}) for k, c in scenes.items()}
    for k, r in rep.items():
        print(f"welcome-geo at K={k}: {r['leaves']} leaves, kernel 4's {r['walk']} walk, AOV "
              f"route {tuple(r['route'])}")
        if scenes[k].data.bvh.blk_p0.shape[1] != k:
            fail(f"welcome-geo was built at K={scenes[k].data.bvh.blk_p0.shape[1]}, not {k}")
    if rep[128]["route"] != ["wide", False]:
        fail(f"welcome-geo at K=128 is not admitted as wide: {rep[128]['route']}")
    for b in (0, 70):
        state = random_state(geo.data, n, 5000 * b + 27, b)
        want = wavefront.plain_bounce_step(geo.data, geo.settings, SEED, state)
        for k, c in scenes.items():
            got = cuda_bounce.bounce_bvh(c.data, c.settings, SEED, state)
            torch.cuda.synchronize()
            m = parity.agreement(want, got)
            bad = parity.failures(m)
            print(f"welcome-geo K={k}@b{b}: lanes {m['lanes']}, tie {m['tie']:.4%}, excluded "
                  f"{m['excluded']:.4%}, accum flips {m['accum_flip']:.4%}, max rel "
                  + ", ".join(f"{k2} {v:.1e}" for k2, v in m["max_rel"].items())
                  + (f"  FAIL {bad}" if bad else ""))
            if bad:
                fail(f"kernel 4 at K={k} vs the plain step, bounce {b}: {bad}")
            rep[k]["checks"][b] = dict(tie=m["tie"], excluded=m["excluded"],
                                       accum_flip=m["accum_flip"])
            rep[k]["max_abs"] = max(rep[k]["max_abs"], *m["max_abs"].values())
    for k, c in scenes.items():
        rep[k]["widths"] = {str(w): r for w, r in
                            time_bvh_bounce(c, geo_chunk, f"K={k}").items()}
    # Kernel 3 on one chunk's camera rays and the forward chunk in the
    # captured plan at each width, the compiled K=32 beside them.
    cam_o, cam_d, _, _ = cuda_bounce.generate_rays(geo.data, geo.settings, SEED, 0, n)
    inf = torch.full((n,), INF, device="cuda")
    never = torch.full_like(inf, -INF)
    out = (torch.empty(n, dtype=torch.float32, device="cuda"),
           torch.empty(n, dtype=torch.int32, device="cuda"))
    rep[32] = {}
    for k, c in ((32, geo),) + tuple(scenes.items()):
        bvh = c.data.bvh
        tables = cuda_bvh.tables_of(bvh)
        ms = graph_ms(lambda: cuda_bvh.intersect_tris_launch(cam_o, cam_d, inf, never, tables,
                                                             out))
        with intersect.count_work() as work:
            want = intersect._walk_tris(cam_o, cam_d, inf, never, bvh, False)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail(f"kernel 3 at K={k} differs from the plain walk on camera rays")
        visits, tests = float(work["visits"]), float(work["tests"])
        bound, bytes_ms, ops_ms = walk_bound(n, False, visits, tests, 0, k)
        renderer = ChunkRenderer(c.data, c.settings, SEED, "cuda")
        rate, chunk_ms, per_chunk = chunk_rate(renderer, geo_chunk, 2, 0)
        del renderer
        rep[k].update(k3=dict(ms=ms, bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                              visits_per_ray=visits / n, tests_per_ray=tests / n),
                      chunk_ms=chunk_ms, rays_per_s=rate, launches_per_chunk=per_chunk)
        print(f"welcome-geo at K={k}: kernel 3 on {n} camera rays {ms:.4f} ms/launch (bare "
              f"launch), bound {bound:.4f} ms (bytes {bytes_ms:.4f}, operations {ops_ms:.4f}: "
              f"{visits / n:.2f} node visits and {tests / n:.2f} triangle tests per ray), bit-"
              f"equal to the plain walk; forward chunk in the captured plan {chunk_ms:.4f} ms, "
              f"{rate:.4e} rays/s  [{card}]")
    return rep


def env_knobs(card, lap, cbox, geo, geo_chunk) -> dict:
    """Phase 27: the JAX package's render-changing environment knobs."""
    phase("27 the environment knobs (LLR_RNG=threefry and kernel 1's threefry instance; "
          "LLR_TREELET_K / LLR_WIDE_MIN_TRIS through kernel 4; LLR_FUSED, LLR_FUSED_BVH, "
          "LLR_PALLAS, LLR_REORDER)")
    t0 = time.monotonic()
    rep = {}
    assets = REPO / "assets"
    env = dict(os.environ, LLR_RNG="threefry")
    # The CLI without --fused off: refused by name before anything renders.
    refused = subprocess.Popen(
        [sys.executable, "-m", "lumillyrender_tpu_torch", str(assets / "new-cbox.toml"),
         "--out", str(OUT / "refused.png")], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        check = raygen_threefry_check(cbox)
        log, _ = refused.communicate(timeout=300)
    finally:
        if refused.poll() is None:
            refused.kill()
            refused.wait()
    rep["raygen_threefry"] = raygen_threefry_times(card, cbox, check)
    said = [line for line in log.splitlines() if "LLR_RNG" in line]
    print(f"CLI under LLR_RNG=threefry without --fused off: exit {refused.returncode}; "
          f"{said[-1] if said else 'no line names LLR_RNG'}")
    if refused.returncode == 0 or not said or "--fused off" not in said[-1]:
        print(log[-3000:])
        fail("the CLI under LLR_RNG=threefry with the kernels was not refused by name")
    rep["refused"] = dict(exit=refused.returncode, message=said[-1])
    lap("27 raygen threefry and the refusal", t0)

    t1 = time.monotonic()
    child_out = OUT / "knobs_child.npz"
    with open(OUT / "knobs_child.log", "w") as log_f:
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--knobs-child",
                                  str(child_out)], cwd=str(REPO), env=env, stdout=log_f,
                                 stderr=subprocess.STDOUT)
        try:
            code = child.wait(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    print((OUT / "knobs_child.log").read_text()[-2500:])
    if code:
        fail(f"the threefry process exited with {code}")
    got = np.load(child_out)
    tf = json.loads(str(got["rec"]))
    launches, calls = tf["cli_launches"], tf["cli_calls"]
    print(f"threefry CLI (new-cbox 256^2 x 64 spp, --fused off): launches {launches}, plain "
          f"steps {calls['plain_bounce_step']}, plain walks {calls['_walk_tris']}, chunks "
          f"through the captured plan {calls['_trace']} of trace_film's {calls['trace_film']}; "
          f"{tf['cli_seconds']:.2f} s; "
          f"{tf['chunk_ms']:.4f} ms a 32-spp chunk as the captured plan's replay (graphed "
          f"{tf['graphed']})  [{card}]")
    if (launches["raygen"] != 2 or any(v for k2, v in launches.items() if k2 != "raygen")
            or not calls["plain_bounce_step"] or calls["_walk_tris"] or not tf["graphed"]
            or calls["trace_film"] != calls["_trace"]):
        fail(f"the threefry render left its path: {launches}, {calls}")
    print(f"threefry process: {tf['seconds']}")
    w, h, spp = THREEFRY_FILM
    rep["threefry_film"] = device_films(
        f"new-cbox {w}x{h} x {spp} spp, fused off, one {spp}-spp chunk", got)
    tl = tf["train_launches"]
    print(f"welcome-geo 512x368 x 4 spp training step under threefry, fused=\"off\": "
          f"{tf['train_seconds']:.2f} s (eager); loss {tf['train_loss']:.6e}, finite "
          f"{tf['train_finite']}; launches {tl}; plain steps "
          f"{tf['train_calls']['plain_bounce_step']}, plain walks "
          f"{tf['train_calls']['_walk_tris']}")
    if (not tf["train_finite"] or not tf["grad_color_abs_sum"] > 0 or not tl["bvh"]
            or any(v for k2, v in tl.items() if k2 != "bvh")
            or tf["train_calls"]["_walk_tris"]):
        fail(f"the threefry training step: {tf}")
    tp = tf["train_plan"]
    print(f"  through film_and_grads's plan: capture {tp['capture_seconds']:.3f} s, graph pool "
          f"{tp['pool_bytes']} B, a replay {tp['replay_seconds']:.4f} s (the eager step "
          f"{tf['train_seconds']:.2f} s); first call and replay bit-equal to the eager step "
          f"{tp['first_bit_equal']} / {tp['replay_bit_equal']}  [{card}]")
    rep["threefry"] = tf
    lap("27 threefry process", t1)

    t1 = time.monotonic()
    rep["leaf_widths"] = leaf_widths(card, geo, geo_chunk)
    lap("27 leaf widths", t1)

    t1 = time.monotonic()
    runs = {}
    small_cbox = ["--resolution", "64", "64", "--spp", "8"]
    small_geo = ["--resolution", "128", "92", "--spp", "4"]
    # (tag, scene, extra arguments, knobs, kernels launched, kernels not
    # launched, the plain step run, the rays sorted)
    cases = [
        ("LLR_FUSED=0, new-cbox", "new-cbox", small_cbox, dict(LLR_FUSED="0"),
         ("raygen",), ("bounce",), True, False),
        ("LLR_FUSED_BVH=0, welcome-geo", "welcome-geo", small_geo, dict(LLR_FUSED_BVH="0"),
         ("raygen", "bvh"), ("bounce_bvh",), True, False),
        ("LLR_FUSED_BVH=0, new-cbox", "new-cbox", small_cbox, dict(LLR_FUSED_BVH="0"),
         ("raygen", "bounce"), (), False, False),
        ("LLR_PALLAS=0, welcome-geo", "welcome-geo", small_geo, dict(LLR_PALLAS="0"),
         ("raygen", "bvh"), ("bounce_bvh",), True, False),
        ("LLR_REORDER=1, welcome-geo --aov depth", "welcome-geo",
         small_geo + ["--aov", "depth"], dict(LLR_REORDER="1"), ("raygen", "bvh"), (), False,
         True),
        ("welcome-geo --aov depth (no knob)", "welcome-geo", small_geo + ["--aov", "depth"],
         {}, ("raygen", "bvh"), (), False, False),
    ]
    for tag, scene, extra, knobs, want, zero, plain_step, sorted_ in cases:
        ext = "hdr" if scene == "welcome-geo" else "png"
        _, launches, calls = run_main_path(
            tag, [str(assets / f"{scene}.toml"), *extra, "--out", str(OUT / f"knob.{ext}")],
            want, zero, env=knobs, plain_step=plain_step)
        if bool(calls["_ray_sort_key"]) != sorted_:
            fail(f"{tag}: sort key calls {calls['_ray_sort_key']}, sorted expected {sorted_}")
        runs[tag] = dict(launches=launches, calls=calls)
    rep["cli_runs"] = runs
    lap("27 CLI knob runs", t1)
    lap("environment knobs", t0)
    return rep


HERO_SCENES = ("ridaisai", "welcome", "sample")
HERO_LANES = 2138 * 1536  # a hero film's chunk of 1 spp: the widest launch
HERO_FILM = (64, 48, 4)  # w, h, spp of the small films
HERO_TIMED = 4  # captured chunks timed a hero scene
HERO_CLI = {  # scene: (extra CLI arguments, output, film shape)
    "sample": ([], "sample.png", (512, 512, 3)),
    "welcome": (["--checkpoint-every", "16"], "welcome.hdr", (1536, 2138, 3)),
    "ridaisai": ([], "ridaisai.hdr", (1536, 2138, 3)),
}


def check_raygen(tag, scene, st, spp, offset) -> float:
    """Kernel 1 against its plain version on one chunk: random bits equal,
    o, d, g and pdf within 1e-5 relative. Returns the max |o, d|
    difference."""
    from lumillyrender_tpu_torch.integrator.render import global_lanes
    from lumillyrender_tpu_torch.ops import cuda_bounce, rng

    n = st.width * st.height * spp
    dev = scene.camera.position.device
    uni = torch.empty((n, 4), dtype=torch.float32, device=dev)
    got = cuda_bounce.generate_rays(scene, st, SEED, offset, n, uniforms=uni)
    want = cuda_bounce.plain_generate_rays(scene, st, SEED, offset, n)
    u_p = torch.stack(rng.uniform4(SEED, global_lanes(st, offset, n, dev), 0x40000000), 1)
    torch.cuda.synchronize()
    bits_equal = torch.equal(uni.view(torch.int32), u_p.view(torch.int32))
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
    errs = {k: rel(a, b) for k, a, b in zip(("o", "d", "pdf", "g"), got, want)}
    print(f"{tag}: lanes {n}, rng bits equal {bits_equal}, max rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    # Same IEEE operations in the same order on both sides; the aperture
    # kinds add the card's cosf/sinf against PyTorch's, 1 ulp apart at
    # most: 1e-5 relative leaves room for that and nothing else.
    if not bits_equal or max(errs.values()) > 1e-5:
        fail(f"raygen disagrees with its plain version ({tag}): bits equal {bits_equal}, {errs}")
    return max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())


def hero_timing(card, name, c, chunk) -> dict:
    """Phase 10's readings on one hero chunk size: every bounce launch of
    one camera chunk checked against the plain step, kernel 4's bare launch
    at each stage width beside its bound, the captured plan's chunk ms,
    rays/s, launches, capture and idle share."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer
    from lumillyrender_tpu_torch.ops import cuda_bounce

    st = c.settings
    n = st.width * st.height * chunk
    widths = sorted({w for w, _, _ in wavefront._stage_plan(n, st)}, reverse=True)
    tables = cuda_bounce.pack_tables(c.data, bvh=True)
    checks, per_launch, first = instrumented_chunk(c, chunk, cuda_bounce.bounce_bvh, tables)
    if sorted(checks, reverse=True) != widths:
        fail(f"{name}: the chunk's bounce launches ran at {sorted(checks)}, its stage plan "
             f"has {widths}")
    by_width = bounce_bounds(c, per_launch, brute=False)
    time_bounce_widths(c, cuda_bounce.bounce_bvh, cuda_bounce.bounce_bvh_launch, tables,
                       first, by_width)
    launches, ms, bound, plain, by = weighted(by_width)
    renderer = ChunkRenderer(c.data, st, SEED, "cuda")
    rate, chunk_ms, per_chunk = chunk_rate(renderer, chunk, HERO_TIMED, 0)
    print(f"{name} forward (the captured stage plan, replayed): {HERO_TIMED} chunks of {n} "
          f"lanes, {chunk_ms:.4f} ms each: {rate:.6e} rays/s; launches per chunk {per_chunk}; "
          f"kernel 4 launch-weighted {ms:.4f} ms, bound {bound:.4f} ms ({by})  [{card}]")
    plan = plan_cost(renderer, chunk)
    idle, busy, _ = idle_share(renderer, chunk, chunk_ms, (HERO_TIMED + 1) * chunk)
    del renderer
    return dict(lanes=n, rays_per_s=rate, chunk_ms=chunk_ms, busy_ms=busy, idle_share=idle,
                launches_per_chunk=per_chunk, **plan, weighted_ms=ms, weighted_bound_ms=bound,
                weighted_plain_ms=plain, bound_by=by, launches=launches,
                bounce_by_width={str(w): a for w, a in by_width.items()},
                main_path_checks={str(w): a for w, a in checks.items()},
                max_abs=max(a["max_abs"] for a in checks.values()))


def hero_films(c_card, c_cpu) -> dict:
    """ridaisai's small film on the plain path (plain raygen, plain step,
    plain walk), on the card against the CPU under CROSS_DEVICE's limits,
    which the card's film against the CPU's film of another seed (another
    sample of every pixel) must fail."""
    from lumillyrender_tpu_torch.integrator import wavefront
    from lumillyrender_tpu_torch.ops import cuda_bounce

    w, h, spp = HERO_FILM
    films = {}
    for tag, c, seed in (("card", c_card, SEED), ("cpu", c_cpu, SEED),
                         ("cpu, another seed", c_cpu, SEED + 1)):
        small = resized(c, w, h, spp)
        film, _ = trace_chunk(small, 0, spp, cuda_bounce.plain_generate_rays,
                              lambda s, c=small, seed=seed: wavefront.plain_bounce_step(
                                  c.data, c.settings, seed, s), seed=seed)
        films[tag] = film.reshape(h, w, 3).cpu().numpy() / spp
    rec = {"card vs cpu": cross_device(films["card"], films["cpu"]),
           "control": cross_device(films["card"], films["cpu, another seed"])}
    for k, r in rec.items():
        print(f"ridaisai {w}x{h}x{spp} plain films, {k}: |mean| rel {r['mean_rel']:.3e}, pixels "
              f"within 1e-4 of the film max {r['within']:.5f}, 8x8 block max rel "
              f"{r['block_rel']:.4f}, max |diff| {r['max_abs']:.3e}; CROSS_DEVICE limits held "
              f"{r['holds']}")
    if not all(rec["card vs cpu"]["holds"].values()):
        fail(f"ridaisai's plain film on the card is not the CPU's: {rec['card vs cpu']}")
    if any(rec["control"]["holds"].values()):
        fail(f"CROSS_DEVICE passes ridaisai's film of another seed: {rec['control']}")
    return rec


def hero_scenes(card, lap, assets) -> tuple[dict, float, float]:
    """Phase 28: the JAX package's hero scenes (welcome, ridaisai) and
    BASELINE config 1 (sample) on the card. Returns (report, kernel 1's
    max |o, d| difference, kernel 4's max |state| difference)."""
    from lumillyrender_tpu_torch.integrator.render import default_spp_chunk, tile_dims
    from lumillyrender_tpu_torch.ops import cuda_bounce
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from lumillyrender_tpu_torch.utils import checkpoint as ckpt

    phase("28 hero scenes (ridaisai, welcome, sample): kernels 1 and 4, the CLI, films, timing")
    t0 = time.monotonic()
    heroes = {name: compile_scene_file(assets / f"{name}.toml", device="cuda")
              for name in HERO_SCENES}
    rep = dict(raygen={}, random_states={}, chunks={}, cli={})
    raygen_err = 0.0
    for name in ("ridaisai", "welcome"):
        c = heroes[name]
        chunk = default_spp_chunk(c.settings)
        if tile_dims(c.settings) != (2, 32):
            fail(f"{name}'s film takes tiles {tile_dims(c.settings)}, not 2x32")
        for offset in (0, 3):
            raygen_err = max(raygen_err, check_raygen(
                f"{name} {c.settings.width}x{c.settings.height}x{chunk} off{offset}, 2x32 "
                "tiles, thin lens", c.data, c.settings, chunk, offset))
    rep["raygen"]["max_abs"] = raygen_err
    t1 = time.monotonic()
    lap("28 raygen", t0)
    bounce_err = 0.0
    for name, c in heroes.items():
        for b in (0, 3, 7, 70):
            m = check_bounce(f"{name} ({c.settings.integrator}) {HERO_LANES} lanes@b{b}", c,
                             cuda_bounce.bounce_bvh,
                             random_state(c.data, HERO_LANES, 5000 * b + len(name), b))
            rep["random_states"][f"{name}@b{b}"] = m
            bounce_err = max(bounce_err, *m["max_abs"].values())
    lap("28 random states", t1)
    t1 = time.monotonic()
    for name in ("ridaisai", "welcome"):
        c = heroes[name]
        rec = rep["chunks"][name] = hero_timing(card, name, c, default_spp_chunk(c.settings))
        bounce_err = max(bounce_err, rec["max_abs"])
    lap("28 camera chunks and timing", t1)
    t1 = time.monotonic()
    for name, (extra, out, shape) in HERO_CLI.items():
        argv = [str(assets / f"{name}.toml"), "--out", str(OUT / out)] + extra
        ck = OUT / f"{name}.ckpt.npz"
        if "--checkpoint-every" in extra:
            ck.unlink(missing_ok=True)
            argv += ["--checkpoint", str(ck)]
        result, launches, _ = run_main_path(name, argv, want=("raygen", "bounce_bvh"),
                                            must_be_zero=("bounce", "bvh"))
        if result.film.shape != shape:
            fail(f"{name}'s film has the shape {result.film.shape}, not {shape}")
        rec = rep["cli"][name] = dict(launches=launches, seconds=result.seconds,
                                      rays=result.rays, rays_per_s=result.rays_per_second,
                                      mean=float(result.film.mean()))
        if "--checkpoint-every" in extra:
            st = result_settings(assets / f"{name}.toml")
            saved = ckpt.load(ck, st, 0)
            rec["checkpoint_samples"] = None if saved is None else saved[1]
            if saved is None or saved[1] != st.spp or saved[2] != result.rays:
                fail(f"{name}'s checkpoint does not hold the render: {rec}")
            ck.unlink()
        if out.endswith(".hdr"):  # a 2138x1536 film: ~13 MB this run's output need not keep
            (OUT / out).unlink()
    lap("28 CLI renders", t1)
    t1 = time.monotonic()
    rep["films"] = {name: kernel_vs_plain_films(f"{name} {'x'.join(map(str, HERO_FILM))}",
                                                resized(c, *HERO_FILM))
                    for name, c in heroes.items()}
    rep["cross_device"] = hero_films(heroes["ridaisai"], compile_scene_file(
        assets / "ridaisai.toml", device="cpu"))
    lap("28 films", t1)
    del heroes
    lap("hero scenes", t0)
    return rep, raygen_err, bounce_err


def counted_films(tag, c, seeds, want, must_be_zero, spp_chunk=None):
    """The films of `c` for each seed through `render` on the card, with
    every launch count zeroed just before and read just after; fails unless
    each kernel in `want` launched, none in `must_be_zero` did, and neither
    the plain step nor the plain walk ran. -> (films (S, h, w, 3), counts)."""
    from lumillyrender_tpu_torch.integrator.render import render
    from lumillyrender_tpu_torch.ops import cuda_bounce

    with PlainCalls() as plain:
        cuda_bounce.reset_counts()
        films = np.stack([render(c, seed=s, spp_chunk=spp_chunk, device="cuda").film
                          for s in seeds])
        torch.cuda.synchronize()
        launches = cuda_bounce.counts()
    if (any(launches[k] < 1 for k in want) or any(launches[k] for k in must_be_zero)
            or plain.calls or not np.isfinite(films).all()):
        fail(f"{tag}: left its path or gave a non-finite film: {launches}, plain calls "
             f"{plain.n}")
    return films, {k: v for k, v in launches.items() if v}


def oracle_configs(card, tg, scenes, kernel, off, settings) -> tuple[dict, dict]:
    """Each config of `scenes` (tools/torch_oracle_gate.py's, at ORACLE.json's
    size) rendered at seeds 9000-9009 through `kernel` against the committed
    oracle stack, printed beside ORACLE.json's JAX row. -> (rows, films)."""
    stacks, jax_rows = tg.load_stacks("full"), tg.oracle_json_rows()
    seeds = tg.SIZES["full"]["seeds"]
    rows, films = {}, {}
    for name, c in scenes.items():
        c = dataclasses.replace(c, settings=dataclasses.replace(c.settings, **settings))
        fr, launches = counted_films(f"{name} ({kernel})", c, seeds, ("raygen", kernel), (off,))
        r = tg.gate_fields(name, fr, stacks[name][0], seeds, c)
        r.update(passed=tg.passes(r), launches=launches,
                 jax={k: jax_rows[name][k] for k in tg.ORACLE_FIELDS})
        print(json.dumps(dict(phase=29, kernel=kernel, card=card, **r)))
        rows[name], films[name] = r, fr
    bad = [name for name, r in rows.items() if not r["passed"]]
    if bad:
        fail(f"the oracle gate fails through {kernel}: {bad}")
    return rows, films


def estimator_gates(card, lap) -> dict:
    """Phase 29: the JAX package's estimator gates through the kernels. The
    oracle gate (tools/torch_oracle_gate.py against the committed stacks of
    tests/oracle_stacks.npz) on the six configs through kernels 1 and 2, and
    on the triangle configs through kernel 4, with its controls; then
    tests/test_render.py's statistical gates on the card."""
    from unittest import mock

    from lumillyrender_tpu_torch.integrator import render as render_mod
    from lumillyrender_tpu_torch.integrator import wavefront
    from tools import torch_oracle_gate as tg

    phase("29 estimator gates (the oracle's six configs through kernels 1, 2 and 4; "
          "test_render.py's statistical gates)")
    t0 = time.monotonic()
    scenes = tg.sized_scenes("full", "cuda")
    rep = {}
    rep["oracle"], films = oracle_configs(card, tg, scenes, "bounce", "bounce_bvh", {})
    tris = {name: c for name, c in scenes.items() if c.data.geometry.tri_p0.shape[0]}
    rep["oracle_bvh"], _ = oracle_configs(card, tg, tris, "bounce_bvh", "bounce",
                                          dict(intersector="bvh"))
    lap("29 oracle gate", t0)

    # Controls on the card's own stacks: x1.2 on each quadrant in turn, of
    # which the gate must catch at least one a config, and a sparse bias
    # that records its power at this budget.
    stacks = tg.load_stacks("full")
    seeds = tg.SIZES["full"]["seeds"]
    rep["controls"] = {}
    for name in ("pt-spheres", "mesh-thinlens"):
        fo = stacks[name][0]
        biased = {f"quadrant {q} x1.2": tg.quadrant_bias(films[name], q) for q in range(4)}
        biased["sparse x1.5 on 5% of the lit pixels"] = tg.sparse_bias(films[name])
        recs = rep["controls"][name] = {}
        for kind, f in biased.items():
            r = recs[kind] = tg.gate_fields(name, f, fo, seeds, scenes[name])
            r["passed"] = tg.passes(r)
            print(f"control, {name} {kind}: frac(|z|>5) {r['frac_abs_z_gt5']}, max |z| "
                  f"{r['max_abs_z']}, untestable {r['frac_untestable']}, rel mean diff "
                  f"{r['rel_mean_diff']}, passes the gate {r['passed']}")
        if all(r["passed"] for kind, r in recs.items() if kind.startswith("quadrant")):
            fail(f"the oracle gate passes x1.2 on every quadrant of {name}")
    del films
    t1 = time.monotonic()

    st = rep["statistical"] = {}
    brute = (("raygen", "bounce"), ("bounce_bvh",))
    # The furnaces at tests/test_render.py's size (48^2 x 8 spp): exact.
    f, launches = counted_films("white furnace", tg.furnace_scene(1.0, device="cuda"), [3],
                                *brute)
    st["white_furnace"] = dict(max_abs=float(np.abs(f - 1.0).max()), launches=launches)
    spp = 8
    f, launches = counted_films("gray furnace", tg.furnace_scene(0.37, spp=spp, device="cuda"),
                                [4], *brute)
    st["gray_furnace"] = dict(lattice_max=tg.gray_lattice_max(f, spp, 0.37),
                              sphere_seen=bool(np.abs(f - 0.37).min() < 1e-3), launches=launches)
    # The white furnace at full chunk width (256^2 x 32 spp, 2,097,152
    # lanes): every pixel on the 32-sample lattice, the samples lost inside
    # the sphere (tg.FURNACE_LOST_SHARE) counted.
    side, spp = 256, 32
    f, launches = counted_films(
        "white furnace, full width", tg.furnace_scene(1.0, spp=spp, device="cuda", width=side,
                                                      height=side), [3], *brute)
    lattice_max, lost = tg.furnace_lost_samples(f[0], spp)
    st["white_furnace_full_width"] = dict(
        lanes=side * side * spp, max_abs=float(np.abs(f - 1.0).max()), lattice_max=lattice_max,
        lost_samples=lost, pixels_below_1=int((np.abs(f[0] - 1.0).max(axis=2) > 1e-3).sum()),
        launches=launches)
    print(f"furnaces: {st}")
    if not (st["white_furnace"]["max_abs"] < 1e-3 and st["gray_furnace"]["lattice_max"] < 1e-3
            and st["gray_furnace"]["sphere_seen"] and lattice_max < 1e-3
            and lost < tg.FURNACE_LOST_SHARE * side * side * spp):
        fail(f"a furnace identity fails on the card: {st}")

    a, _ = counted_films("pt", tg.nee_scene("pt", 768, "cuda"), [11], *brute)
    b, _ = counted_films("pt-direct", tg.nee_scene("pt-direct", 192, "cuda"), [12], *brute)
    st["pt_vs_nee"] = means_agree("pt vs pt-direct 32^2", a, b)

    fa, _ = counted_films("pt, big lamp", tg.big_lamp_scene("pt", 768, "cuda"), range(300, 316),
                          *brute)
    fb, _ = counted_films("pt-direct, big lamp", tg.big_lamp_scene("pt-direct", 256, "cuda"),
                          range(400, 416), *brute)
    rec = st["perpixel_z"] = tg.perpixel_z(fa, fb)
    print(f"pt vs pt-direct per-pixel z (big lamp, 16^2, 16 seeds each): {rec}")
    if not tg.perpixel_z_holds(rec, 16 * 16):
        fail(f"the per-pixel z gate fails on the card: {rec}")

    # Compaction overflow, through the captured plan: 32 spp in two chunks
    # of 4,096 lanes (the second a replay of the first's graph).
    shell = tg.compile_toml(tg.shell_toml(), "cuda", spp=32)
    shell_off = dataclasses.replace(shell, settings=dataclasses.replace(
        shell.settings, compaction="off"))
    seeds = range(100, 140)
    f_off, _ = counted_films("shell, uncompacted", shell_off, seeds, *brute, spp_chunk=16)
    forced = ((4096, 0, 2), (256, 2, shell.settings.max_bounces))
    overflowed, orig = [], wavefront._compact

    def spy(state, width, seed, ctr, salt=None):
        if not torch.cuda.is_current_stream_capturing():
            overflowed.append(int(state.alive.sum()) > width)
        return orig(state, width, seed, ctr, salt=salt)

    with mock.patch.object(wavefront, "_stage_plan", lambda n, s, **kw: forced), \
            mock.patch.object(wavefront, "_compact", spy):
        f_on, launches = counted_films("shell, forced plan", shell, seeds, *brute, spp_chunk=16)
    mp, mc = f_off.mean(axis=(1, 2, 3)), f_on.mean(axis=(1, 2, 3))
    rec = st["compaction_overflow"] = dict(
        z=tg.z_of_means(mp, mc), mean_uncompacted=float(mp.mean()), mean_forced=float(mc.mean()),
        eager_overflows=sum(overflowed), eager_chunks=len(overflowed), launches=launches)
    print(f"compaction overflow (16^2 x 32 spp, 256 slots from bounce 2, 40 seeds): {rec}")
    if not (rec["z"] < 4.0 and overflowed and all(overflowed)):
        fail(f"the compaction overflow gate fails on the card: {rec}")

    nee64 = tg.nee_scene("pt-direct", 16, "cuda", width=64, height=64)
    tiled, _ = counted_films("tiled", nee64, [50 + s for s in range(12)], *brute)
    with mock.patch.object(render_mod, "tile_dims", lambda s: None):
        raster_err = check_raygen("kernel 1 in raster order, 64^2 x 16", nee64.data,
                                  nee64.settings, 16, 0)
        raster, _ = counted_films("raster", nee64, [150 + s for s in range(12)], *brute)
    rec = st["tiled_vs_raster"] = dict(z=tg.z_of_means(tiled.mean(axis=(1, 2, 3)),
                                                       raster.mean(axis=(1, 2, 3))),
                                       raygen_raster_max_abs=raster_err)
    print(f"tiled vs raster lane order (64^2 x 16 spp, 12 seeds each): {rec}")
    if not rec["z"] < 4.0:
        fail(f"tiled and raster lane order disagree on the card: {rec}")

    ml = tg.many_light_scene("pt-direct", 192, "cuda")
    a, _ = counted_films("many-light pt", tg.many_light_scene("pt", 768, "cuda"), [21], *brute)
    b, launches = counted_films("many-light pt-direct", ml, [22], *brute)
    rec = st["many_light"] = means_agree("many-light pt vs pt-direct 32^2", a, b)
    rec.update(lights=int(ml.data.lights.prim.shape[0]), launches=launches,
               step="kernel 2 (bounce)" if launches.get("bounce") else "plain step")
    print(f"many-light: {rec['lights']} lights, pt-direct took {rec['step']}: {launches}")
    lap("29 statistical gates", t1)
    lap("estimator gates", t0)
    return rep


def means_agree(tag, a, b) -> dict:
    """tests/test_render.py's film-mean gate (tg.means_agree) on the first
    film of two stacks."""
    from tools import torch_oracle_gate as tg

    rec = tg.means_gap(a[0].mean(axis=2), b[0].mean(axis=2))
    print(f"{tag}: {rec}")
    if not tg.means_agree(rec):
        fail(f"{tag}: the two estimators disagree on the card: {rec}")
    return rec


# ---------------------------------------------------------------------------
# The JAX package's gradient gates through the hybrid step (phase 30)
# ---------------------------------------------------------------------------

def grad_gates(card, lap, assets, geo_step) -> dict:
    """Phase 30: the JAX package's gradient gates through the hybrid step
    (make_step_hybrid: kernel 2 or 4 forward, autograd of the plain step
    recomputed backward, kernel 3 its walk on the heroes). `geo_step` is
    phase 25's welcome-geo step timing at 4 spp, printed beside the heroes'."""
    from unittest import mock

    from lumillyrender_tpu_torch.diff import params_of
    from lumillyrender_tpu_torch.ops import cuda_bounce
    from lumillyrender_tpu_torch.scene.compiler import compile_scene_file
    from tools import torch_grad_gates as gg

    phase("30 gradient gates through the hybrid step (every family on kernel 2; the analytic "
          "direct view; the heroes at full width on kernel 4)")
    t0 = t_part = time.monotonic()
    rep = {}

    def part(name):
        nonlocal t_part
        lap(f"30 {name}", t_part)
        t_part = time.monotonic()

    scenes, view = gg.gate_scenes(assets, "cuda")
    for name, c in list(scenes.items()) + [("direct view", view)]:
        if cuda_bounce.diff_step_kind(c.data, c.settings, on_card=True) != "hybrid":
            fail(f"phase 30: {name} does not take the hybrid step")
    card_fd = {}
    with PlainCalls() as calls:
        cuda_bounce.reset_counts()
        for name, c in scenes.items():
            card_fd[name] = fd_gate(c, {f"{name} {t}": v for t, v in gg.KERNEL2_FD[name].items()})
        g_view, share = gg.direct_view(view.data, view.settings, "cuda")
        torch.cuda.synchronize()
        launches = cuda_bounce.counts()
    print(f"FD vs AD through kernel 2 and the direct view: launches {launches}; plain forward "
          f"steps or walks {calls.calls}, recomputes {calls.recomputes}")
    if (calls.calls or not calls.recomputes or launches["bounce"] < 1 or launches["bounce_bwd"]
            or launches["bounce_bvh"]):
        fail(f"the kernel-2 gradient gates left the hybrid step: {launches}, {calls.calls} calls")
    rep["kernel2_launches"] = launches
    rep["kernel2_recomputes"] = calls.recomputes
    part("FD vs AD on the card")
    # The CPU's AD of each case and of the direct view, through the same step
    # (make_step_hybrid: the plain step forward on the CPU), which
    # tests/test_torch_grad_gates.py holds against the JAX package.
    cpu_scenes, cpu_view = gg.gate_scenes(assets, "cpu")
    rep["fd"], bad = {}, []
    with mock.patch.object(cuda_bounce, "make_step_diff", cuda_bounce.make_step_hybrid):
        for name, c in cpu_scenes.items():
            g_cpu = gg.mean_grad(c.data, c.settings, "cpu")
            for t, (table, field, idx, *_) in gg.KERNEL2_FD[name].items():
                r = dict(card_fd[name][f"{name} {t}"])
                r["ad_cpu"] = float(getattr(getattr(g_cpu, table), field)[idx])
                r["vs_cpu"] = abs(r["ad"] - r["ad_cpu"]) / max(abs(r["ad_cpu"]), 1e-30)
                ok = r["vs_cpu"] <= gg.CARD_CPU_RTOL
                print(f"{name} {t}: AD on the card {r['ad']:.7g}, on the CPU {r['ad_cpu']:.7g}, "
                      f"rel {r['vs_cpu']:.2e} (limit {gg.CARD_CPU_RTOL:g})"
                      + ("" if ok else "  FAIL"))
                if not ok:
                    bad.append(f"{name} {t}")
                rep["fd"][f"{name} {t}"] = r
        g_cpu, share_cpu = gg.direct_view(cpu_view.data, cpu_view.settings, "cpu")
    if bad:
        fail(f"the card's AD against the CPU's: {bad}")
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    view_rec = dict(grad=g_view.tolist(), share=share, grad_cpu=g_cpu.tolist(),
                    share_cpu=share_cpu, vs_share=rel(g_view, np.full(3, share / 3)),
                    vs_cpu=rel(g_view, g_cpu))
    print(f"direct view (pt, 1 bounce, 12x12 x 8 spp): the lamp's emission gradient on the card "
          f"{g_view.tolist()}, the share of camera samples on the lamp {share:.7g} (/3 "
          f"{share / 3:.7g}; rel {view_rec['vs_share']:.1e}); the CPU's gradient "
          f"{g_cpu.tolist()} (rel {view_rec['vs_cpu']:.1e}), share {share_cpu:.7g} (held to 1e-6)")
    if not ((g_view >= 0).all() and g_view[0] == g_view[1] == g_view[2] and 0 < share < 1
            and view_rec["vs_share"] < 1e-6 and view_rec["vs_cpu"] < 1e-6):
        fail(f"the analytic direct view: {view_rec}")
    rep["direct_view"] = view_rec
    del scenes, view, cpu_scenes, cpu_view
    part("the CPU's AD")

    rep["heroes"] = {}
    for name, (w, h) in gg.HERO_WIDTHS.items():
        c = resized(compile_scene_file(assets / f"{name}.toml", device="cuda"), w, h, 1)
        rows = gg.bunny_rows(c.data)
        p_true = params_of(c.data)
        p = p_true._replace(materials=gg.perturbed_rows(p_true.materials, rows))
        rec, p, target, grads = hybrid_film_and_grads(
            f"{name} {w}x{h}", c, 1, {"bounce_bvh": 80, "bvh": 80 * walks_per_bounce(c)}, p=p)
        nonzero = {f"{k}[{r}]": float(getattr(grads.materials, k)[r].abs().sum())
                   for k in gg.HERO_FIELDS[name] for r in rows}
        rec["bunny_rows"], rec["bunny_grads"] = rows, nonzero
        print(f"{name}: |gradient| of the bunny rows {rows}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in nonzero.items()))
        if not all(v > 0 for v in nonzero.values()):
            fail(f"{name}: a bunny row's gradient is zero: {nonzero}")
        timing = time_train_step(c, 1, p, target, 1, tag=f"{name} {w}x{h}", top=4)
        timing.pop("by_name")
        rec["timing"] = timing
        print(f"{name} {w}x{h} x 1 spp step {timing['step_ms']:.1f} ms, device busy "
              f"{timing['busy_ms']:.1f} ms, idle share {timing['idle_share']:.4f}, peak memory "
              f"{timing['peak_bytes'] / 2**30:.3f} GiB; beside welcome-geo 512x368 x 4 spp (phase "
              f"25) {geo_step['step_ms']:.1f} ms, busy {geo_step['busy_ms']:.1f} ms, idle "
              f"{geo_step['idle_share']:.4f}, peak {geo_step['peak_bytes'] / 2**30:.3f} GiB  "
              f"[{card}]")
        del target, grads
        if name in gg.HERO_FD:
            with PlainCalls() as calls:
                cuda_bounce.reset_counts()
                rec["fd_vs_ad"] = fd_gate(c, {f"{name} {w}x{h} {t}": v
                                              for t, v in gg.HERO_FD[name].items()})
                torch.cuda.synchronize()
                launches = cuda_bounce.counts()
            print(f"FD vs AD on {name} {w}x{h}: launches {launches}; plain forward steps or "
                  f"walks {calls.calls}, recomputes {calls.recomputes}")
            if (calls.calls or not calls.recomputes or launches["bounce_bvh"] < 1
                    or launches["bvh"] < 1 or launches["bounce"] or launches["bounce_bwd"]):
                fail(f"the FD gates on {name} left the hybrid step: {launches}, "
                     f"{calls.calls} calls")
            rec["fd_launches"] = launches
        rep["heroes"][name] = rec
        del c, p
        torch.cuda.empty_cache()
        part(name)
    lap("gradient gates", t0)
    return rep


# ---------------------------------------------------------------------------
# Phase 31: the training step as one captured program
# ---------------------------------------------------------------------------

PLAN_STEPS = 3  # Adam steps a scene, each eager and through the plan
PLAN_ROUNDS = 2  # rounds of phase 31's timing, the eager step and the plan's in turns
PLAN_EXAMPLE_STEPS = 5
# ibl-material's depth in phase 31: its all-family recompute is ~4,300
# PyTorch ops a bounce, whose capture took 28.6 s at 80 bounces (PERF.md
# §6.25).
PLAN_IBL_BOUNCES = 20


def _bit_equal(a, b) -> bool:
    from lumillyrender_tpu_torch.diff.render import leaves

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(leaves(a[2]), leaves(b[2]))))


def _step_busy(fn, want_records=None):
    """(device busy ms of one `fn()`, kernel records, {kernel name: (ms,
    launches)}) from the profiler, the busy ms None where it recorded fewer
    kernels than `want_records` (a long process's profiler loses records of
    kernels inside graph replays)."""
    busy, by_name = device_busy(fn)
    records = sum(n for _, n in by_name.values())
    if want_records is not None and records < want_records:
        return None, records, by_name
    return busy, records, by_name


def plan_vs_eager(tag, c, spp, kind, sky_leaf, card):
    """PLAN_STEPS Adam steps on `c` at `spp`, from the albedo at 0.8 of its
    value (and the sky leaf `sky_leaf`, where given, at 1.2) toward the film
    at the true parameters, each step at a new seed taken eagerly and then
    through the plan, with the counts zeroed just before and read just
    after each: loss, film and every gradient bit-equal, the same launches.
    Then both timed in turns. Returns the record."""
    from lumillyrender_tpu_torch.diff import (
        eager_film_and_grads, params_of, render_diff, train_plan)
    from lumillyrender_tpu_torch.diff.render import clear_plans
    from lumillyrender_tpu_torch.ops import cuda_bounce

    st = c.settings
    clear_plans()
    p_true = params_of(c.data)
    with torch.no_grad():
        target = render_diff(c.data, st, p_true, SEED, spp)
    color = torch.nn.Parameter(p_true.materials.color * 0.8)
    trained = [color]
    if sky_leaf:
        sky = torch.nn.Parameter(getattr(p_true.sky, sky_leaf) * 1.2)
        trained.append(sky)
    opt = torch.optim.Adam(trained, lr=0.02)

    def params():
        p = p_true._replace(materials=dataclasses.replace(p_true.materials,
                                                          color=color.detach().clone()))
        if sky_leaf:
            p = p._replace(sky=dataclasses.replace(p.sky, **{sky_leaf: sky.detach().clone()}))
        return p

    plan = train_plan(c.data, st, p_true, target, spp)
    if plan is None or plan.kind != kind:
        fail(f"{tag}: the step is not a {kind} plan ({plan and plan.kind})")
    steps = []
    for k in range(PLAN_STEPS):
        p, seed = params(), SEED + 200 + k
        cuda_bounce.reset_counts()
        want = eager_film_and_grads(c.data, st, p, target, seed, spp)
        torch.cuda.synchronize()
        eager_launches = cuda_bounce.counts()
        cuda_bounce.reset_counts()
        t0 = time.monotonic()
        got = plan(p, target, seed)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = cuda_bounce.counts()
        equal = _bit_equal(got, want)
        rec = dict(seed=seed, loss=float(got[0]), bit_equal=equal, launches=launches,
                   eager_launches=eager_launches, replay=k > 0, seconds=seconds)
        print(f"{tag}, step {k} (seed {seed}, {'a replay' if k else 'eager, then captured'}): "
              f"loss {rec['loss']:.6e}; loss, film and every gradient bit-equal to the eager "
              f"step {equal}; launches {launches} (eager {eager_launches}); {seconds:.3f} s")
        if not equal or launches != eager_launches:
            fail(f"{tag}: the plan's step {k} is not the eager step: {rec}")
        steps.append(rec)
        opt.zero_grad()
        color.grad = got[2].materials.color
        if sky_leaf:
            sky.grad = getattr(got[2].sky, sky_leaf)
        opt.step()
    print(f"{tag}: captured in {plan.capture_seconds:.3f} s, graph pool {plan.pool_bytes} B, "
          f"launches per replay {plan.launches}")

    p = params()
    fns = {"eager": lambda seed: eager_film_and_grads(c.data, st, p, target, seed, spp),
           "plan": lambda seed: plan(p, target, seed)}
    ms = {"eager": [], "plan": []}
    for r in range(PLAN_ROUNDS):
        for who in (("eager", "plan") if r % 2 == 0 else ("plan", "eager")):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fns[who](SEED + 300 + r)
            torch.cuda.synchronize()
            ms[who].append((time.monotonic() - t0) * 1e3)
    rec = dict(steps=steps, capture_seconds=plan.capture_seconds, pool_bytes=plan.pool_bytes,
               launches_per_replay=plan.launches, lanes=st.width * st.height * spp)
    # The peak memory past what was held before, of the profiled step.
    peaks = {}

    def peak_of(who, seed):
        def run():
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fns[who](seed)
            torch.cuda.synchronize()
            peaks[who] = torch.cuda.max_memory_allocated() - held
        return run

    busy_eager, records, names_e = _step_busy(peak_of("eager", SEED + 400))
    busy_plan, plan_records, names_p = _step_busy(peak_of("plan", SEED + 401), records)
    for who, busy in (("eager", busy_eager), ("plan", busy_plan)):
        med, rng_ = spread(ms[who])
        rec[who] = dict(ms=ms[who], median_ms=med, range_ms=rng_, busy_ms=busy,
                        idle_share=None if busy is None else 1.0 - busy / med,
                        peak_bytes=peaks[who])
    rec["plan"]["records"], rec["eager"]["records"] = plan_records, records
    # The kernels the replay runs more often than the eager step.
    more = sorted(((n - names_e.get(k, (0.0, 0))[1], t - names_e.get(k, (0.0, 0))[0], k)
                   for k, (t, n) in names_p.items()), reverse=True)[:5]
    rec["plan"]["more_than_eager"] = {k[:70]: [dn, dt] for dn, dt, k in more if dn > 0}
    rec["plan"]["replay_span_ms"] = events_ms(plan.graph.replay, 3)
    rec["speedup"] = rec["eager"]["median_ms"] / rec["plan"]["median_ms"]
    for who in ("eager", "plan"):
        r = rec[who]
        busy = "not measured" if r["busy_ms"] is None else f"{r['busy_ms']:.4f} ms"
        idle = "not measured" if r["idle_share"] is None else f"{r['idle_share']:.4f}"
        print(f"{tag} {who} step: median {r['median_ms']:.4f} ms [{r['range_ms'][0]:.4f}, "
              f"{r['range_ms'][1]:.4f}] over {PLAN_ROUNDS} in turns; device busy {busy}, idle "
              f"share {idle}; peak memory {r['peak_bytes'] / 2**30:.3f} GiB  [{card}]")
    print(f"{tag}: the replay's span (CUDA events, the graph alone) "
          f"{rec['plan']['replay_span_ms']:.4f} ms; the plan's step {rec['speedup']:.2f}x "
          f"faster than the eager step; profiler kernel records {plan_records} (plan) / "
          f"{records} (eager); records the plan has more of (records, ms): "
          f"{rec['plan']['more_than_eager']}")
    clear_plans()
    return rec


def plan_example():
    """examples/invert_materials_torch.py for PLAN_EXAMPLE_STEPS steps on the
    card: its film_and_grads calls are one plan's, captured at the first and
    replayed at every later one, with the counts zeroed just before and read
    just after."""
    import importlib.util

    from lumillyrender_tpu_torch.diff import render as diff_render
    from lumillyrender_tpu_torch.ops import cuda_bounce

    spec = importlib.util.spec_from_file_location(
        "invert_materials_torch", REPO / "examples" / "invert_materials_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    diff_render.clear_plans()
    cuda_bounce.reset_counts()
    t0 = time.monotonic()
    err0, err = example.main(["--steps", str(PLAN_EXAMPLE_STEPS)])
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = cuda_bounce.counts()
    plans = [] if diff_render.kept_plan() is None else [diff_render.kept_plan()]
    replays = [pl.replays for pl in plans]
    per_step = plans[0].launches.get("bounce_bwd", 0) if plans else 0
    rec = dict(steps=PLAN_EXAMPLE_STEPS, err0=err0, err=err, seconds=seconds,
               launches=launches, plans=len(plans), replays=replays,
               launches_per_replay=plans[0].launches if plans else None)
    print(f"the example, {PLAN_EXAMPLE_STEPS} steps: max albedo error {err0:.4f} -> {err:.4f} "
          f"in {seconds:.2f} s; {len(plans)} plan, replays {replays}, launches per replay "
          f"{rec['launches_per_replay']}; launches {launches}")
    # Its backward launches: one step's for each training step and for the
    # example's pixel_grad (which finds the observable rows), eager.
    if (len(plans) != 1 or replays != [PLAN_EXAMPLE_STEPS - 1] or not per_step
            or launches["bounce_bwd"] != per_step * (PLAN_EXAMPLE_STEPS + 1)):
        fail(f"the example through the plan: {rec}")
    diff_render.clear_plans()
    return rec


def captured_steps(card, lap, cbox, geo, ibl) -> dict:
    """Phase 31 (module docstring). Returns the report."""
    phase("31 the training step as one captured program (TrainPlan: new-cbox, welcome-geo, "
          "ibl-material)")
    t0 = time.monotonic()
    report = {}
    for tag, c, kind, sky_leaf in (
            ("new-cbox 256^2 x 4", cbox, "bwd", "color"),
            ("welcome-geo 512x368 x 4", resized(geo, geo.settings.width, geo.settings.height, 4),
             "hybrid", None),
            (f"ibl-material 320x240 x 4, {PLAN_IBL_BOUNCES} bounces",
             dataclasses.replace(ibl, settings=dataclasses.replace(
                 ibl.settings, max_bounces=PLAN_IBL_BOUNCES)), "hybrid", "ibl")):
        report[tag] = plan_vs_eager(tag, c, 4, kind, sky_leaf, card)
        torch.cuda.empty_cache()
    report["example"] = plan_example()
    lap("captured training step", t0)
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lumillyrender_tpu_torch import cli
    from lumillyrender_tpu_torch.constants import EPS, INF
    from lumillyrender_tpu_torch.integrator.render import ChunkRenderer, default_spp_chunk, render
    from lumillyrender_tpu_torch.ops import cuda_bounce, cuda_build, cuda_bvh, intersect
    from lumillyrender_tpu_torch.scene import terrain
    from lumillyrender_tpu_torch.scene.compiler import compile_scene, compile_scene_file
    from lumillyrender_tpu_torch.scene.data import CAM_PINHOLE
    from lumillyrender_tpu_torch.scene.loader import parse_config
    from lumillyrender_tpu_torch.diff import eager_film_and_grads

    OUT.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    t_start = time.monotonic()
    assets = REPO / "assets"
    secs = {}

    def lap(name, t0):
        secs[name] = time.monotonic() - t0
        print(f"[{name}: {secs[name]:.1f}s]", flush=True)

    phase("1 card")
    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    phase("2 build")
    t0 = time.monotonic()
    built = cuda_build.build(verbose=True)
    print(f"built {sorted(built)} in {time.monotonic() - t0:.1f}s "
          f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    for kernel, props in ptxas_kernels(cuda_build.LOGS.get("probes", "")).items():
        print(f"{kernel}: {props}")
    # Every instance of kernels 2, 4 and 5 (sweep, tables, families): their
    # registers and stack (kernel 5's row tables are dynamic shared memory)
    # set their occupancy.
    ptxas_report = {}
    for num, lib in ((2, "bounce"), (3, "bvh"), (4, "bounce_bvh"), (5, "bounce_bwd")):
        for kernel, props in ptxas_kernels(cuda_build.LOGS.get(lib, "")).items():
            label = kernel_instance(kernel)
            ptxas_report[f"{num} {label}"] = props
            print(f"kernel {num} ({lib}.cu) {label}: {props or 'no ptxas line'} "
                  f"({blocks_per_sm(props)} blocks of 128 per SM by registers)")
    lap("build", t0)

    phase("3 raygen kernel vs plain")
    t0 = time.monotonic()
    cbox = compile_scene_file(assets / "new-cbox.toml", device=dev)
    ibl = compile_scene_file(assets / "ibl-material.toml", device=dev)
    geo = compile_scene_file(assets / "welcome-geo.toml", device=dev)
    geo_chunk = default_spp_chunk(geo.settings)
    cases = [
        ("new-cbox 256^2x32 off0", cbox.data, cbox.settings, 32, 0),
        ("new-cbox 256^2x32 off32", cbox.data, cbox.settings, 32, 32),
        ("ibl-material thin-lens", ibl.data, ibl.settings, 8, 0),
        ("ibl-material realistic-pinhole", ibl.data,
         dataclasses.replace(ibl.settings, camera_kind=CAM_PINHOLE), 8, 0),
        (f"welcome-geo 512x368x{geo_chunk} thin-lens", geo.data, geo.settings,
         geo_chunk, 0),
    ]
    raygen_err = max(check_raygen(tag, scene, st, spp, off) for tag, scene, st, spp, off in cases)
    lap("raygen", t0)

    phase("4 brute-force bounce kernel vs plain step")
    t0 = time.monotonic()
    scenes = {name: compile_scene_file(assets / f"{name}.toml", device=dev)
              for name in ("new-cbox", "primitive", "debug-nee", "brdf",
                           "many-light")}
    scenes["families"] = compile_scene(parse_config(GGX_REFR_SCENE), device=dev)
    scenes["ibl-material"] = ibl
    n_cmp = 1 << 21  # the main path's full width
    bounce_err = 0.0
    for name, c in scenes.items():
        tables = cuda_bounce.pack_tables(c.data)
        inst = cuda_bounce.launch_instance(tables, n_cmp)
        for b in (0, 3, 7, 70):
            m = check_bounce(f"{name} ({inst[0].label(inst[1])})@b{b}", c, cuda_bounce.bounce,
                             random_state(c.data, n_cmp, 1000 * b + len(name), b))
            if name == "new-cbox":
                bounce_err = max(bounce_err, *m["max_abs"].values())
        # The instances the narrower launches take: the small sweep (where
        # the scene fits) and the group sweep, each at the widest launch
        # that takes it.
        for sweep, n_inst, group in (("small", cuda_bounce.SMALL_MAX_LANES, 1),
                                     ("general", 1 << 14, 4)):
            if sweep == "small" and tables["small"] is None:
                continue
            forced = dict(tables, instance=cuda_bounce.Instance(sweep, inst[0].shading),
                          group=group)
            m = check_bounce(f"{name} ({forced['instance'].label(group)})@b3", c,
                             lambda *a, t=forced: cuda_bounce.bounce(*a, t),
                             random_state(c.data, n_inst, 3000 + len(name), 3))
            if name == "new-cbox":
                bounce_err = max(bounce_err, *m["max_abs"].values())
    del scenes
    lap("brute bounce parity", t0)

    phase("5 end-to-end render (CLI, new-cbox 256^2 x 64 spp)")
    t0 = time.monotonic()
    _, cbox_launches, _ = run_main_path(
        "new-cbox", [str(assets / "new-cbox.toml"), "--out", str(OUT / "new-cbox.png")],
        want=("raygen", "bounce"), must_be_zero=("bvh", "bounce_bvh"))
    cbox_films = kernel_vs_plain_films("new-cbox 64^2x8", resized(cbox, 64, 64, 8))
    cli_files = cli_checkpoint_telemetry_profile(assets / "new-cbox.toml")
    lap("new-cbox render", t0)

    phase("6 timing (new-cbox 256^2, 32 spp per chunk)")
    t0 = time.monotonic()
    st = cbox.settings
    spp_chunk = 32
    n = st.width * st.height * spp_chunk
    cbox_renderer = ChunkRenderer(cbox.data, st, SEED, dev)
    rays_per_s, chunk_ms, cbox_per_chunk = chunk_rate(cbox_renderer, spp_chunk, 8, 0)
    print(f"forward (the captured stage plan, replayed): 8 chunks, {chunk_ms:.4f} ms each: "
          f"{rays_per_s:.6e} rays/s; launches per chunk {cbox_per_chunk}  [{card}]")
    cbox_plan = plan_cost(cbox_renderer, spp_chunk)
    tables = cuda_bounce.pack_tables(cbox.data)
    checks, per_launch, first_state = instrumented_chunk(cbox, spp_chunk, cuda_bounce.bounce,
                                                         tables)
    bounce_err = max(bounce_err, *(c["max_abs"] for c in checks.values()))
    by_width = bounce_bounds(cbox, per_launch, brute=True)
    time_bounce_widths(cbox, cuda_bounce.bounce, cuda_bounce.bounce_launch, tables,
                       first_state, by_width)
    bounce_launches, b_ms, b_bound, b_plain, b_by = weighted(by_width)
    print(f"launches per chunk: raygen 1, bounce {bounce_launches}")
    o_buf = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_buf = torch.empty((n, 3), dtype=torch.float32, device=dev)
    raygen_ms = graph_ms(lambda: cuda_bounce.raygen_launch(
        cbox.data, st, SEED, 0, o_buf, d_buf))
    raygen_host_ms = events_ms(
        lambda: cuda_bounce.generate_rays(cbox.data, st, SEED, 0, n), 10)
    raygen_plain_ms = events_ms(
        lambda: cuda_bounce.plain_generate_rays(cbox.data, st, SEED, 0, n), 3)
    raygen_bound = 24 * n / HBM_BYTES_PER_S * 1e3
    print(f"raygen width {n}: kernel {raygen_ms:.4f} ms/launch (bare launch), "
          f"bound {raygen_bound:.4f} ms (bytes); wrapper with allocation and "
          f"pdf/g fill {raygen_host_ms:.4f} ms with the host; plain "
          f"{raygen_plain_ms:.3f} ms")
    cbox_idle, cbox_busy, _ = idle_share(cbox_renderer, spp_chunk, chunk_ms, 10 * spp_chunk)
    del cbox_renderer
    cbox_report = dict(rays_per_s=rays_per_s, chunk_ms=chunk_ms, idle_share=cbox_idle,
                       busy_ms=cbox_busy, launches_per_chunk=cbox_per_chunk, **cbox_plan,
                       bounce_by_width={str(w): a for w, a in by_width.items()},
                       main_path_checks={str(w): c for w, c in checks.items()},
                       film_checks=cbox_films)
    del o_buf, d_buf, tables
    lap("new-cbox timing", t0)

    phase("7 BVH kernel vs the plain walk (welcome-geo)")
    t0 = time.monotonic()
    gst = geo.settings
    bvh = geo.data.bvh
    btab = cuda_bvh.tables_of(bvh)
    n_geo = gst.width * gst.height * geo_chunk
    cam_o, cam_d, _, _ = cuda_bounce.generate_rays(geo.data, gst, SEED, 0, n_geo)
    (rnd_o, rnd_d), (ax_o, ax_d) = welcome_rays(bvh, n_geo, 7)
    inf = torch.full((n_geo,), INF, device=dev)
    never = torch.full((n_geo,), -INF, device=dev)
    # Light distances spanning hit, miss and boundary: half the lanes put
    # the light on their nearest hit, so both verdicts occur.
    dist = torch.from_numpy(np.random.default_rng(8).uniform(
        1.0, 800.0, size=n_geo).astype(np.float32)).to(dev)
    near_t, near_p = intersect._walk_tris(rnd_o, rnd_d, inf, never, bvh, False)
    on = (near_p >= 0) & (torch.arange(n_geo, device=dev) % 2 == 0)
    dist = torch.where(on, near_t, dist)
    del near_t, near_p, on
    cap = dist + 2.0 * EPS
    stop = cap - 4.0 * EPS
    verdict = lambda r: (r[1] >= 0) & ((r[0] - dist).abs() <= EPS)
    bvh_checks = {}
    bvh_err = 0.0
    sets = [("camera rays", cam_o, cam_d, inf, never, False),
            ("camera rays, shade", cam_o, cam_d, inf, never, True),
            ("random rays", rnd_o, rnd_d, inf, never, False),
            ("random rays, shade", rnd_o, rnd_d, inf, never, True),
            ("random rays, occlusion", rnd_o, rnd_d, cap, stop, False),
            ("axis-aligned rays", ax_o, ax_d, inf, never, True)]
    walk_counts = {}
    for tag, o, d, t0_, ts, shade in sets:
        got = cuda_bvh.intersect_tris(o, d, t0_, ts, btab, shade)
        with intersect.count_work() as work:
            want = intersect._walk_tris(o, d, t0_, ts, bvh, shade)
        torch.cuda.synchronize()
        walk_counts[tag] = (float(work["visits"]), float(work["tests"]))
        prim_flips = int((got[1] != want[1]).sum())
        both = (got[1] >= 0) & (want[1] >= 0)
        ulp = ((got[0] - want[0]).abs() / torch.maximum(want[0].abs(), torch.ones_like(want[0]))
               ).max().item()
        rec = dict(lanes=n_geo, prim_flips=prim_flips, t_max_rel=ulp,
                   hits=int(both.sum()), visits=walk_counts[tag][0],
                   tests=walk_counts[tag][1])
        if shade:
            rec["mat_flips"] = int((got[2] != want[2]).sum())
            rec["n_max_abs"] = (got[3] - want[3]).abs().max().item()
        if ts is stop:
            exact = intersect._walk_tris(o, d, t0_, never, bvh, False)
            rec["verdict_flips"] = int((verdict(got) != verdict(want)).sum())
            rec["verdict_flips_vs_nearest"] = int((verdict(got) != verdict(exact)).sum())
            rec["visible"] = int(verdict(got).sum())
        bvh_checks[tag] = rec
        bvh_err = max(bvh_err, (got[0] - want[0]).abs().max().item())
        print(f"{tag}: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                     for k, v in rec.items()))
        # Every output bit-equal: the same operations in the same order, no
        # contraction, each ray's leaves and slots in the plain walk's order.
        if (prim_flips or rec.get("mat_flips") or rec.get("verdict_flips")
                or rec.get("verdict_flips_vs_nearest") or not torch.equal(got[0], want[0])
                or rec.get("n_max_abs", 0.0) > 0.0):
            fail(f"BVH kernel disagrees with the plain walk ({tag}): {rec}")
    del rnd_o, rnd_d, ax_o, ax_d, dist, cap, stop
    lap("bvh parity", t0)

    phase("8 BVH bounce kernel vs plain step (welcome-geo, terrain)")
    t0 = time.monotonic()
    tdir = OUT / "terrain"
    tdir.mkdir(exist_ok=True)
    terrain.write_obj(tdir / "terrain.obj", *terrain.make_terrain(9000)[:3])
    bvh_scenes = {"welcome-geo": geo, "terrain": compile_scene(
        parse_config(terrain.terrain_scene_toml(), base_dir=tdir), device=dev)}
    bvh_bounce_err = 0.0
    for name, c in bvh_scenes.items():
        for b in (0, 3, 7, 70):
            m = check_bounce(f"{name}@b{b}", c, cuda_bounce.bounce_bvh,
                             random_state(c.data, n_geo, 2000 * b + len(name), b))
            bvh_bounce_err = max(bvh_bounce_err, *m["max_abs"].values())
    del bvh_scenes
    lap("bvh bounce parity", t0)

    phase("9 end-to-end render (CLI, welcome-geo 512x368 x 64 spp, hdr; --aov depth)")
    t0 = time.monotonic()
    geo_result, geo_launches, _ = run_main_path(
        "welcome-geo", [str(assets / "welcome-geo.toml"), "--out", str(OUT / "welcome-geo.hdr")],
        want=("raygen", "bounce_bvh"), must_be_zero=("bounce", "bvh"))
    if geo_result.film.shape != (368, 512, 3):
        fail(f"welcome-geo film shape {geo_result.film.shape}")
    _, aov_launches, aov_calls = run_main_path(
        "welcome-geo --aov depth",
        [str(assets / "welcome-geo.toml"), "--aov", "depth",
         "--out", str(OUT / "welcome-geo-depth.hdr")],
        want=("raygen", "bvh"), must_be_zero=("bounce", "bounce_bvh"))
    normal_result, _, normal_calls = run_main_path(
        "welcome-geo --aov normal",
        [str(assets / "welcome-geo.toml"), "--aov", "normal",
         "--out", str(OUT / "welcome-geo-normal.hdr")],
        want=("raygen", "bvh"), must_be_zero=("bounce", "bounce_bvh"))
    if not normal_result.film.max() <= 1.0:
        fail("the normal AOV leaves [0, 1]")
    # 64 spp in chunks of geo_chunk: every chunk after a plan's first replays it.
    geo_chunks = -(-gst.spp // geo_chunk)
    for tag, calls in (("--aov depth", aov_calls), ("--aov normal", normal_calls)):
        if calls["replays"] != geo_chunks - calls["plans"] or calls["plans"] > 2:
            fail(f"welcome-geo {tag}: {calls['plans']} plans and {calls['replays']} replays "
                 f"for {geo_chunks} chunks")
    small = resized(geo, 64, 48, 4)
    geo_films = kernel_vs_plain_films("welcome-geo 64x48x4", small)
    # The depth AOV: the kernel path's film against the plain walk's.
    small_aov = dataclasses.replace(small, settings=dataclasses.replace(
        small.settings, integrator="depth"))
    a_k = render(small_aov, seed=SEED, device=dev).film
    o, d, _, _ = cuda_bounce.generate_rays(small.data, small_aov.settings, SEED, 0, 64 * 48 * 4)
    hit = intersect.intersect(o, d, small.data.geometry, small.data.bvh, gst.intersector,
                              plain=True)
    from lumillyrender_tpu_torch.integrator.render import camera_lanes
    _, px, py = camera_lanes(small_aov.settings, 0, o.shape[0], dev)
    depth = torch.where(hit.prim >= 0, hit.t, torch.zeros_like(hit.t))
    a_p = torch.zeros(64 * 48, dtype=torch.float32, device=dev)
    a_p.index_add_(0, py * 64 + px, depth)
    a_p = (a_p / 4).reshape(48, 64, 1).expand(48, 64, 3).cpu().numpy()
    aov_films = check_films("welcome-geo depth 64x48x4", {"kernel path vs plain walk": (a_k, a_p)})
    lap("welcome-geo render", t0)

    phase(f"10 timing (welcome-geo 512x368, {geo_chunk} spp per chunk)")
    t0 = time.monotonic()
    geo_renderer = ChunkRenderer(geo.data, gst, SEED, dev)
    geo_rate, geo_chunk_ms, geo_per_chunk = chunk_rate(geo_renderer, geo_chunk, 4, 0)
    print(f"forward (the captured stage plan, replayed): 4 chunks, {geo_chunk_ms:.4f} ms "
          f"each: {geo_rate:.6e} rays/s; launches per chunk {geo_per_chunk}  [{card}]")
    geo_plan = plan_cost(geo_renderer, geo_chunk)
    gtables = cuda_bounce.pack_tables(geo.data, bvh=True)
    g_checks, g_per_launch, g_first = instrumented_chunk(geo, geo_chunk, cuda_bounce.bounce_bvh,
                                                         gtables)
    bvh_bounce_err = max(bvh_bounce_err, *(c["max_abs"] for c in g_checks.values()))
    g_by_width = bounce_bounds(geo, g_per_launch, brute=False)
    time_bounce_widths(geo, cuda_bounce.bounce_bvh, cuda_bounce.bounce_bvh_launch, gtables,
                       g_first, g_by_width)
    gb_launches, gb_ms, gb_bound, gb_plain, gb_by = weighted(g_by_width)
    print(f"launches per chunk: raygen 1, BVH bounce {gb_launches}")
    # Kernel 3 on the chunk's camera rays (the AOV path's query), without
    # and with the shade outputs (depth and normal AOVs).
    k3 = {}
    v3_, t3_ = walk_counts["camera rays"]
    for shade in (False, True):
        out3 = (torch.empty(n_geo, dtype=torch.float32, device=dev),
                torch.empty(n_geo, dtype=torch.int32, device=dev))
        if shade:
            out3 += (torch.empty(n_geo, dtype=torch.int32, device=dev),
                     torch.empty((n_geo, 3), dtype=torch.float32, device=dev))
        ms = graph_ms(lambda: cuda_bvh.intersect_tris_launch(cam_o, cam_d, inf, never, btab,
                                                             out3))
        plain_ms = events_ms(lambda: intersect._walk_tris(cam_o, cam_d, inf, never, bvh, shade),
                             2)
        want = intersect._walk_tris(cam_o, cam_d, inf, never, bvh, shade)
        if not all(torch.equal(a, b) for a, b in zip(out3, want)):
            fail(f"kernel 3's timed outputs differ from the plain walk's (shade {shade})")
        bound, k3_bytes, k3_ops = walk_bound(n_geo, shade, v3_, t3_, 0, btab["k"])
        k3[shade] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bytes_ms=k3_bytes,
                         ops_ms=k3_ops, bound_by="bytes" if k3_bytes >= k3_ops else "operations",
                         visits_per_ray=v3_ / n_geo, tests_per_ray=t3_ / n_geo)
        print(f"BVH kernel on {n_geo} camera rays{', shade' if shade else ''}: {ms:.4f} "
              f"ms/launch (bare launch), bound {bound:.4f} ms (bytes {k3_bytes:.4f}, operations "
              f"{k3_ops:.4f}: {v3_ / n_geo:.2f} node visits and {t3_ / n_geo:.2f} triangle "
              f"tests per ray; the tables stay in the L2); {ms / bound:.1f}x the bound; "
              f"plain walk {plain_ms:.3f} ms  [{card}]")
    k3_ms, k3_plain_ms, k3_bound, k3_by = (k3[False][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by"))
    geo_idle, geo_busy, _ = idle_share(geo_renderer, geo_chunk, geo_chunk_ms, 40 * geo_chunk)
    geo_timing = dict(chunk_ms=geo_chunk_ms, busy_ms=geo_busy, idle_share=geo_idle,
                      launches_per_chunk=geo_per_chunk, **geo_plan)
    del geo_renderer
    lap("welcome-geo timing", t0)

    phase("11 backward kernel vs plain (new-cbox, debug-nee, primitive)")
    t0 = time.monotonic()
    bwd_scenes = {"new-cbox": cbox}
    for name in ("debug-nee", "primitive"):
        bwd_scenes[name] = compile_scene_file(assets / f"{name}.toml", device=dev)
    n_bwd = 1 << 20  # the 16-spp training step's full width
    bwd_checks = {}
    for name, c in bwd_scenes.items():
        me = perturbed(c.data.materials, len(name))
        for b in (0, 3, 7, 70):
            tag = f"{name}@b{b}"
            bwd_checks[tag] = check_bwd(tag, c, random_state(c.data, n_bwd, 3000 * b + len(name), b),
                                        cotangents(n_bwd, 7 * b + len(name)), me)
    bwd_err = max(r["max_abs"] for r in bwd_checks.values())
    autograd_checks = {}
    for name in ("new-cbox", "debug-nee"):
        c = bwd_scenes[name]
        autograd_checks[name] = autograd_vs_plain_bwd(
            f"{name}@b3", c, random_state(c.data, 1 << 16, 77, 3), cotangents(1 << 16, 78))
    del bwd_scenes
    lap("backward parity", t0)

    phase("12 training step (FD vs AD on the kernel path; film_and_grads on new-cbox 256^2)")
    t0 = time.monotonic()
    lam = compile_scene(parse_config(LAMBERT_DIFF_SCENE), device=dev)
    fd = {}
    with PlainCalls() as plain:
        cuda_bounce.reset_counts()
        for tag, (part, field, idx, eps, atol, rtol, mb) in {
                "albedo": ("materials", "color", (1, 0), 2e-2, 2e-4, 0.08, 5),
                "emission": ("materials", "emission", (0, 1), 0.5, 1e-5, 0.05, 5),
                "sky": ("sky", "color", 1, 5e-2, 1e-5, 0.05, 5),
                "camera": ("camera", "aperture_position", 2, 5e-2, 2e-3, 0.25, 3)}.items():
            c = dataclasses.replace(lam, settings=dataclasses.replace(lam.settings, max_bounces=mb))
            fd.update(fd_gate(c, {tag: (part, field, idx, eps, atol, rtol)}))
        fd_launches = cuda_bounce.counts()
    print(f"FD vs AD launches: {fd_launches}; plain step or backward calls: {plain.calls}")
    if fd_launches["bounce_bwd"] < 1 or plain.calls:
        fail(f"the FD gates left the kernel path: {fd_launches}, {plain.calls} plain calls")
    training = {}
    for spp in (4, 16):
        rec, p_last, target, g_kernel = train_new_cbox(cbox, spp)
        if spp == 4:
            with PlainDiffStep():
                _, _, g_plain = eager_film_and_grads(cbox.data, cbox.settings, p_last, target,
                                                     SEED, spp)
            torch.cuda.synchronize()
            gap = grads_gap(g_kernel, g_plain)
            print("kernel path vs plain path (autograd of the plain step), 256^2 x 4 spp, "
                  "max |diff| over max |plain| per gradient: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in gap.items()))
            rec["vs_plain"] = gap
            if not max(gap.values()) < TRAIN_PLAIN_RTOL:
                fail(f"kernel-path gradients disagree with the plain path's: {gap}")
        training[spp] = dict(rec, params=p_last, target=target)
    hybrid_rows = hybrid_many_rows(cbox, 1 << 16)
    lap("training step", t0)

    phase("13 timing of the training step (new-cbox 256^2, 4 and 16 spp per step)")
    t0 = time.monotonic()
    train_timing = {spp: time_train_step(cbox, spp, training[spp]["params"],
                                         training[spp]["target"], 3 if spp == 4 else 2)
                    for spp in (4, 16)}
    bwd_widths = time_bwd_widths(cbox, 16, training[16]["params"], training[16]["target"])
    bwd_err = max(bwd_err, *(r["max_abs"] for r in bwd_widths.values()))
    nb = sum(r["launches"] for r in bwd_widths.values())
    bwd_ms = sum(r["ms"] * r["launches"] for r in bwd_widths.values()) / nb
    bwd_plain = sum(r["plain_ms"] * r["launches"] for r in bwd_widths.values()) / nb
    bwd_bound = sum(r["bound_ms"] * r["launches"] for r in bwd_widths.values()) / nb
    bwd_by = ("bytes" if sum(r["bytes_ms"] * r["launches"] for r in bwd_widths.values())
              >= sum(r["ops_ms"] * r["launches"] for r in bwd_widths.values()) else "operations")
    print(f"backward kernel, launch-weighted over the {nb} launches of a 16-spp step: "
          f"{bwd_ms:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by}), plain {bwd_plain:.3f} ms")
    lap("training timing", t0)
    for spp in training:
        del training[spp]["params"], training[spp]["target"]
    plan_report = captured_steps(card, lap, cbox, geo, ibl)

    big_report, big_kernels, terrain_1m, terrain_15m = huge_meshes(card, lap)
    aov_report = aov_plans(card, lap, geo, terrain_1m, terrain_15m)
    del terrain_15m
    probe_report, probe_kernels = capability_probes(card, lap)

    phase("21 the captured stage loop vs the host loop (new-cbox, welcome-geo, terrain-1m; "
          "full chunks)")
    t0 = time.monotonic()
    stage_loop = {}
    for tag, c, spp, graphed, ph in (
            ("new-cbox", cbox, spp_chunk, cbox_report, 6),
            ("welcome-geo", geo, geo_chunk, geo_timing, 10),
            ("terrain-1m", terrain_1m, default_spp_chunk(terrain_1m.settings),
             big_report["forward"], 19)):
        rec = graphed_vs_host_loop(tag, c, spp)
        rec["graphed"] = {k: graphed[k] for k in (
            "chunk_ms", "busy_ms", "idle_share", "launches_per_chunk", "capture_seconds",
            "pool_bytes")}
        g = rec["graphed"]
        busy = "not measured" if g["busy_ms"] is None else f"{g['busy_ms']:.4f} ms"
        idle = "not measured" if g["idle_share"] is None else f"{g['idle_share']:.4f}"
        print(f"{tag}, {rec['lanes']} lanes a chunk: captured plan (phase {ph}) "
              f"{g['chunk_ms']:.4f} ms per chunk, device busy {busy}, idle share {idle}, "
              f"launches per chunk {g['launches_per_chunk']}, capture {g['capture_seconds']:.3f} "
              f"s, graph pool {g['pool_bytes']} B; the host loop {rec['host_loop_chunk_ms']:.4f} "
              f"ms per chunk  [{card}]")
        stage_loop[tag] = rec
    # fused="off": the plain step's PyTorch ops (kernel 3 its walk on
    # welcome-geo) captured as the chunk's ForwardPlan, held the same way.
    for tag, c, spp in (("new-cbox", cbox, spp_chunk), ("welcome-geo", geo, geo_chunk)):
        off = dataclasses.replace(c, settings=dataclasses.replace(c.settings, fused="off"))
        stage_loop[f'{tag} fused="off"'] = fused_off_chunks(f'{tag} fused="off"', off, spp, card)
    lap("stage loop", t0)

    dp_report = data_parallel(card, lap, cbox, rays_per_s)
    vr_report, raygen_err = vr_on_card(card, lap, raygen_err)
    sky_report, sky_err, sky_bvh_err = simple_sky(card, lap, cbox, geo)
    diff_report, k3_bwd_ms, geo_step = diff_scenes(card, lap, cbox, geo, ibl, terrain_1m)
    diff_report["k3_backward_ms_per_launch"] = k3_bwd_ms
    remat_report = remat_policies(card, lap, cbox, geo, terrain_1m, geo_step,
                                  cbox_report["chunk_ms"])
    del terrain_1m
    knob_report = env_knobs(card, lap, cbox, geo, geo_chunk)
    tf = knob_report["raygen_threefry"]
    hero_report, hero_raygen_err, hero_bounce_err = hero_scenes(card, lap, assets)
    estimator_report = estimator_gates(card, lap)
    grad_report = grad_gates(card, lap, assets, diff_report["timing"]["4"])
    bounce_err = max(bounce_err, sky_err)
    bvh_bounce_err = max(bvh_bounce_err, sky_bvh_err, hero_bounce_err)
    raygen_err = max(raygen_err, hero_raygen_err)

    kernels = [
        dict(name="raygen", route="cuda",
             source="lumillyrender_tpu_torch/csrc/raygen.cu",
             replaces="lumillyrender_tpu/ops/pallas_bounce.py:2143",
             launches=cbox_launches["raygen"], max_abs_err=raygen_err,
             ms=raygen_ms, plain_ms=raygen_plain_ms, bound_ms=raygen_bound,
             bound_by="bytes", library_ms=None, instances=["pcg4d", "threefry"],
             threefry=dict(launches=knob_report["threefry"]["cli_launches"]["raygen"],
                           max_abs_err=tf["max_abs_err"], ms=tf["ms"], plain_ms=tf["plain_ms"],
                           bound_ms=tf["bound_ms"], bound_by=tf["bound_by"],
                           library_ms=None)),
        dict(name="bounce", route="cuda",
             source="lumillyrender_tpu_torch/csrc/bounce.cu",
             replaces="lumillyrender_tpu/ops/pallas_bounce.py:786",
             launches=cbox_launches["bounce"], max_abs_err=bounce_err,
             ms=b_ms, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
             library_ms=None),
        dict(name="bvh", route="cuda",
             source="lumillyrender_tpu_torch/csrc/bvh.cu",
             replaces="lumillyrender_tpu/ops/pallas_bvh.py:252",
             launches=aov_launches["bvh"], max_abs_err=bvh_err,
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound, bound_by=k3_by,
             library_ms=None),
        dict(name="bounce_bvh", route="cuda",
             source="lumillyrender_tpu_torch/csrc/bounce_bvh.cu",
             replaces="lumillyrender_tpu/ops/pallas_bounce.py:834",
             launches=geo_launches["bounce_bvh"], max_abs_err=bvh_bounce_err,
             ms=gb_ms, plain_ms=gb_plain, bound_ms=gb_bound, bound_by=gb_by,
             library_ms=None),
        dict(name="bounce_bwd", route="cuda",
             source="lumillyrender_tpu_torch/csrc/bounce_bwd.cu",
             replaces="lumillyrender_tpu/ops/pallas_bounce.py:1305",
             launches=training[16]["launches"]["bounce_bwd"], max_abs_err=bwd_err,
             ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound, bound_by=bwd_by,
             library_ms=None),
    ] + big_kernels + probe_kernels
    report = dict(
        card=card, new_cbox=cbox_report,
        welcome_geo=dict(
            rays_per_s=geo_rate, chunk_ms=geo_chunk_ms, idle_share=geo_idle, busy_ms=geo_busy,
            launches_per_chunk=geo_per_chunk, **geo_plan,
            cli_rays_per_s=geo_result.rays_per_second, cli_seconds=geo_result.seconds,
            launches=geo_launches, aov_launches=aov_launches,
            bounce_by_width={str(w): a for w, a in g_by_width.items()},
            main_path_checks={str(w): c for w, c in g_checks.items()},
            bvh_checks=bvh_checks, film_checks=geo_films, aov_film_checks=aov_films,
            bvh_kernel={"nearest" if not shade else "shade": r for shade, r in k3.items()}),
        training=dict(backward_checks=bwd_checks, autograd_checks=autograd_checks,
                      fd_vs_ad=fd, fd_launches=fd_launches, hybrid_many_rows=hybrid_rows,
                      steps={str(k): v for k, v in training.items()},
                      timing={str(k): v for k, v in train_timing.items()},
                      backward_by_width={str(w): {k: v for k, v in r.items()}
                                         for w, r in bwd_widths.items()}),
        huge_meshes=big_report, aov_plans=aov_report, probes=probe_report, stage_loop=stage_loop, cli_files=cli_files,
        data_parallel=dp_report, vr=vr_report, simple_sky=sky_report,
        differentiable_scenes=diff_report, remat_policies=remat_report,
        environment_knobs=knob_report, hero_scenes=hero_report,
        estimator_gates=estimator_report, gradient_gates=grad_report,
        captured_step=plan_report,
        kernels=kernels, ptxas=ptxas_report,
        phase_seconds=secs,
        seconds=time.monotonic() - t_start)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"\ntotal {time.monotonic() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dp_rank_args(argv) -> int:
    """Phase 22's rank mode: `--dp-rank R --dp-world N --dp-port P --dp-out
    FILE` (started by phase 22 itself); phase 27's threefry process:
    `--knobs-child FILE`."""
    import argparse

    if argv[0] == "--knobs-child" and len(argv) == 2:
        return knobs_child(Path(argv[1]))
    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    for flag, kind in (("--dp-rank", int), ("--dp-world", int), ("--dp-port", int),
                       ("--dp-out", Path)):
        parser.add_argument(flag, type=kind, required=True)
    a = parser.parse_args(argv)
    return dp_rank(a.dp_rank, a.dp_world, a.dp_port, a.dp_out)


if __name__ == "__main__":
    sys.exit(dp_rank_args(sys.argv[1:]) if sys.argv[1:] else main())
