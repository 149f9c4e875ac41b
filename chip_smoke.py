#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (flnerf_tpu_torch) on one NVIDIA
H100.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. the card's name and power limit; build every CUDA kernel of the port
     (one nvcc per source, all at once) and report the build seconds;
  2. the fused cuvol kernels K1 (forward) and K2 (backward) against their
     plain version, models/voxel_sh.voxel_render_rays with autograd, at the
     shapes the main path gives them: a 256^3 grid (a filled sphere, ~10% of
     cells pruned), 1792 steps (3.5 * 256 / 0.5), and the main path's own
     first training batch (5000 rays from the quadtree budgeter over the
     synthetic scene's 48x48 train views, grid radius 1.2, in the trainer's
     ray order on the card, built as cli/opt.py builds them); K1 also on one
     48x48 test view (2304 rays, the eval render's one chunk); K1 (its
     occupancy built by its wrapper) bitwise equal to the kernel it replaced
     (tools/voxel_probe.py) on both, at sigma_thresh 1e-8, 0.5 and 0 (no
     skip); K2 (the forward's occupancy passed, as the main path passes it)
     within 1e-4 of the plain version's gradient and 1e-5 of the replaced
     K2's, exactly zero on pruned cells, and without a merge bitwise the
     replaced K2 on a 1-ray batch, at sigma_thresh 1e-8, 0.5 and 0;
  3. the main path: cli/opt.py main on the synthetic scene at 256^3 for 3
     epochs on the card (syn.json's first-stage width: SH degree 3, batch
     5000, 1792 steps), with the launch counters set to 0 just before and
     read just after (K2 once a step, the dense TV + RMSProp sweep S1 twice
     a step, for density and SH, and its live pairs once), at 4 steps a
     chunk, so that each epoch is one whole chunk and the later epochs
     replay its CUDA graph (the program's recorder counts the graphed
     steps); train PSNR must rise and the test PSNR be finite;
     3b. a profiled rerun (2 epochs, no checkpoints): where the device time
     goes;
     3c. train rays/s over epochs 2-10 of a 10-epoch run (no checkpoints);
     3d. one chunk at the benchmark cell's shapes (256^3, 8 steps of 5000
     rays, syn.json's rates) by the trainer's CUDA graph replay and three
     times step by step from one seeded start: the grid, both RMSProp
     states, the per-leaf statistic and the chunk MSE within 10x the
     step-by-step runs' largest distance (K2's atomic order);
  4. K1 (the occupancy build included, as the main path calls it), K2's
     kernel body (the forward's occupancy passed in, as the main path
     passes it; its gradients zero-filled outside the timed loop; the
     zero-fill timed apart) and the plain version, by CUDA events on phase
     2's training batch, beside the least time the card could take for the
     same work (K1's with the skip, and for every sample); on the phase-2
     sphere grid and on the grid phase 3c trained, the share of 8^3 blocks
     marked, of marched samples skipped, gated and kept, the longest ray's
     steps and those in marked blocks, and the K1 probe
     (tools/voxel_probe.py: K1, without the skip, without density first,
     with 1 and 4 steps a pass, with its rays spread over the SMs, its own
     body before its march was shared with K2, the replaced kernel, each
     bitwise equal to it, and the occupancy build, by
     events and device time); K2 through its wrapper with the forward's
     occupancy, the kept samples and the share whose floor cell repeats the
     previous kept sample's (what a merge of K2's atomics folds), K2's bound with the
     skip, and the K2 probe (K2, without the skip, without density first,
     with the merge flipped, with other steps a pass, the replaced kernel,
     each within 1e-5 of it, and K2 without its atomics, a measurement
     only); then K1/K2 on
     batches in the budgeter's shuffled
     order against the trainer's coherence order (morton, 64-ray blocks) at
     48x48 and 800x800 train views, and on one eval chunk of a test view in
     raster against morton order;
  4b. S1 (ops/csrc/tv_rmsprop.cu, port only) and its live pairs through
     tools/tv_rmsprop_probe.py at 256^3, density and 27-channel SH, all
     alive and 90% alive: bit for bit their plain versions, at the TV
     weight and at 0, S1 with the rate by value and read from a device
     table (the form the trainer's graph replays launch), with their times
     by CUDA events beside their bounds, the plain versions' and the
     replaced autograd passes';
  5. the hash-encoding kernels K3 (forward) and K4 (table gradient) against
     their plain version, ops/hash_kernel.hash_encode_plain with autograd,
     at the NGP main path's shapes and on a trained table: the trainer
     cli/main_nerf builds for `synthetic -O` (16 levels x 2^15, bf16 MLPs)
     trains 256 steps, then the kept points of its next batch (NGPSampler
     on the 64x64 synthetic views, 4096 rays x 96 kept samples, rendered
     through the trainer's field and occupancy grid with the train loss's
     real upstream gradient, and with a dense random one) and the first
     65,536-point chunk of a full occupancy refresh go through both;
  6. the NGP main path: cli/main_nerf main `synthetic -O --iters 512` on the
     card (32 chunks: 16 full and 16 partial refreshes), with the launch
     counters set to 0 just before and read just after: K4 once per step,
     K3 once per step, refresh chunk and eval chunk; the last chunk's mean
     train loss below the first's; a finite test PSNR; then train rays/s over
     steps 257-512 (phase 5's trainer, a second fit of 256 steps between
     two synchronizes);
     6b. a profiled fit of 64 more steps: device busy share, top kernels;
  7. K3, K4's body (its gradient zero-filled outside the timed loop; the
     zero-fill timed apart; on the train loss's gradient, and on the dense
     one) and the plain version by CUDA events on phase 5's batch, beside
     the least time the card could take; K3 and K4 held against the plain
     version on 65,536 points in 4 level-0 cells (contention) with a dense
     and a zero gradient, on the train batch with a dense gradient as a
     column slice of a wider one (read in place) and with a zero gradient
     (K4 exactly zero), and on 1000, 1 and 0 points; the
     K3/K4 probe (tools/hash_probe.py: the replaced kernels, K3 without
     its gathers, with a load for every corner and walking a tile level by
     level, K4's own body before K7 came to share its tile skeleton, K4
     with levels 0-1 or 0 accumulated in shared memory by 33-264
     CTAs, with and without the merge, by CUDA events and by the
     profiler's device time) on the train batch and on the clustered
     points, with its findings;
  8. the lattice engine's kernels, K6 (forward) and K7 (table gradient),
     against their plain versions (ops/hash_lattice.py
     lattice_encode_plain_levels, and lattice_encode_plain with autograd)
     on the trainer cli/main_nerf builds for `synthetic -O
     --log2_hashmap_size 19` (2 small levels on K3/K4, 14 big ones on a
     [14, 2^19, 2] table) after 256 steps: the kept points of its next batch
     with the train loss's gradient, a dense random one and a zero one, a
     65,536-point refresh chunk and 65,536 points in two z-slabs; K3 and
     K4 on the 2 small levels of the same inputs, K4 on the train and a
     dense gradient's first 4 columns read in place (as the split encode
     hands them over) and on a zero one; K5 (the
     radix sort, no longer on this path) on the reference's base keys of
     each, through both variants and on 31 bits, and on [65,536, 128] keys,
     beyond the grid's 65,535 rows, exactly equal to ops/sort_kernel.py
     bitonic_sort_plain (a stable torch.sort and a gather);
  9. the lattice main path: `main_nerf synthetic -O --log2_hashmap_size 19
     --iters 512` with the counters set to 0 just before and read just
     after: K3 == K6 == steps + refresh chunks + eval chunks, K4 == K7 ==
     steps, no K5 and no cuvol launch; the loss falls; a finite test PSNR;
     peak memory; train rays/s over steps 257-512; a 64-step profile, its
     device time a step and K7's device time in it;
 10. K6 and K7's body (in the points' own order; K7 on autograd's view of
     the gradient and on a level-major copy) and their plain versions, by
     CUDA events on phase 8's batch, beside the replaced designs' times and
     the least time the card could take; the split encode's assembly and
     the gradient's level-major copy; K6's stripped variants
     (tools/lattice_probe.py: no gather, no store, the [p, l] store and the
     sorted walk of the kernel it replaced) and the base keys and K5 a
     sorted walk would need, with the finding; K7's variants (the same
     probe: the replaced kernel, the tile without the warp merge, tiles of
     128 and 256 points) on the train, dense and level-major gradients, by
     events and device time; K3 and K4 on the small
     levels (the train gradient's columns in place, and a dense one) with
     their plain versions and bounds, and the K3/K4 probe on them;
 11. the sorted engine's kernels, K5 on the engine's own (corner entry,
     slot) pairs (exactly the stable sort, on the engine's key width and on
     31 bits), K8 (forward) and K9 (table gradient, from the points, on both
     grid shapes, with and without its warp merge), against their plain
     versions (bitonic_sort_plain, ops/hash_kernel.py hash_encode_plain on
     the big levels' packed spec with autograd) on the trainer cli/main_nerf
     builds for `synthetic -O --log2_hashmap_size 19 --hash_engine sorted`
     (2 small levels on K3/K4, 14 big ones on a [14, 2^19, 2] table, the
     xor hash) after 256 steps: the kept points of its next batch with the
     train loss's gradient, a 65,536-point refresh chunk, 65,536 points in
     two z-slabs and 65,536 points whose three z-clusters share sorted
     blocks of a dense level, each with a dense random gradient and a zero
     one (K9 exactly zero);
 12. the sorted main path: `main_nerf synthetic -O --log2_hashmap_size 19
     --hash_engine sorted --iters 512` with the counters set to 0 just
     before and read just after: K3 == K5 == K8 == steps + refresh chunks +
     eval chunks, K4 == K9 == steps, no K1/K2/K6/K7 launch; the loss falls;
     a finite test PSNR, printed beside phase 6's (2^15, xor hash) and
     phase 9's (2^19, lattice hash); peak memory beside the replaced
     design's; train rays/s over steps 257-512; a 64-step profile and its
     device time a step;
 13. K5 on the engine's unsorted pairs (restored before every sort, the
     restore timed apart; beside torch.sort on the same keys), K8 on the
     train batch and a refresh chunk, in point order and adding into a given
     output, with its cluster's residency, K9's body on both grid shapes,
     with and without the warp merge, on the dense and the train gradient,
     beside the replaced design's times, and the plain versions, by CUDA
     events on phase 11's batch, beside the least time the card could take;
 14. quadtree NeRF (cli/run_nerf.py, no kernel of the port on its path):
     14a. render_rays at full width (D8 W256, 64 + 128 samples, bf16
     operands, perturb 0) on one 1920-ray batch from the budgeter over the
     fixture's train views, on the card and on the CPU with the same
     weights: rgb and every weight gradient agree within the stated
     tolerances;
     14b. the main path: data/synthetic.py write_blender_fixture (96 px, 12
     train, 2 val, 2 test views) and run_nerf.main with the fixture_nerf
     flags of tools/golden_run.py (--N_importance 128 --N_rand 1920
     --precrop_iters 500 --n_epoch 8 --init_level 2 --subdivide_every 3,
     D8 W256, 64 samples, bf16) with every kernel counter set to 0 just
     before and read just after: all read 0; the last epoch's train PSNR
     above the first's, leaves subdivided, 8 .tar and 8 .pkl, a test PSNR
     of at least 22.0 dB (printed beside the JAX package's
     GOLDEN_runs.json row); --render_only --render_test from the last .tar
     gives the same PSNR within 1e-3 dB;
     14c. train rays/s over the 8 epochs (the precrop apart), each epoch's
     and the precrop's wall time, peak memory, and a 16-step profile: the
     device's busy share, the top operations by device time, and the f32
     FLOPs a step beside the least time at 67 TFLOP/s and at the 989
     TFLOP/s of the bf16 tensor cores (the products' operands are bf16, so
     the tensor cores could take them exactly); and the host's decode time
     of an 800 x 800 RGBA PNG whose rows all use the Paeth filter (a
     blender dataset's image size) through data/png.py;
     15a. NeRF++ at the width of configs/tat_training_truck.txt (D8 W256,
     fg and bg MLPs, 64 + 128 samples, bf16 operands): both cascade levels
     of one step (no optimizer step) on one 1920-ray batch from the
     budgeter over write_nerfpp_fixture's train views at resolution_level
     2, on the card and on the CPU with the same weights and uniforms: rgb
     and every weight gradient within phase 14a's tolerances;
     15b. the main path: ddp_train_nerf.main --config
     configs/tat_training_truck.txt on the 96-px nerf++ fixture (12 train,
     2 test views; shrunk to 48 px by data/resize.py), every kernel counter
     set to 0 just before and read just after: all read 0; the last
     epoch's train PSNR above the first's, leaves subdivided, 10 .pth and
     10 .pkl, a finite test PSNR and SSIM (printed beside the JAX package's
     GOLDEN_runs.json fixture_nerfpp row), the same test PSNR within 1e-3
     dB from the last .pth loaded into a fresh trainer;
     15c. train rays/s over the 10 epochs, each epoch's wall time, peak
     memory, and a 16-step profile: the device's busy share, the top
     operations by device time, the f32 FLOPs a step beside the least time
     at 67 TFLOP/s and at 989 TFLOP/s;
 16. TensoRF and CCNeRF (cli/main_tensorf.py, cli/main_ccnerf.py; no
     kernel of the port on their path):
     16a. the VM field at 300^3 (ranks 16/48, feature 27, colour MLP 3 x
     128), the CP field (128^3, ranks 32/32) and the CCNeRF field (128^3,
     the CLI's ranks, colour MLP 3 x 64) at each of its 3 levels, bf16
     operands, on the kept samples of one 4096-ray batch of the synthetic
     scene marched on a refreshed occupancy grid, on the card and on the
     CPU with the same weights and uniforms: sigma (relative), the colour
     feature, rgb and every parameter gradient within phase 14a's
     tolerances;
     16b. the main path: main_tensorf.main synthetic -O --iters 1024
     --upsample_model_steps 128 192 256 352 448 (the reference's schedule
     cut by 16: every shrink and upsample, 128^3 to 300^3) with every
     kernel counter set to 0 just before and read just after: all read 0;
     the last resolution within 5% of 300^3, the last chunk's loss below
     the first's, a finite test PSNR and SSIM (printed beside the JAX
     package's BENCH_time_to_psnr_tensorf.json), the checkpoint loaded
     into a fresh trainer gives the same test PSNR within 1e-3 dB; then
     --cp for 256 steps with the same checks;
     16c. main_ccnerf.main synthetic -O --iters 512: three finite level
     PSNRs and an object.pkl; --compose of two copies at offsets 0,0,0 and
     0.6,0,0: 2 objects, a finite PSNR and a PNG per test view; every
     kernel counter 0;
     16d. train rays/s over the steps after the last upsample, peak
     memory, the factor gather's backward by index_add_ and by index_put_
     on one corner set of the step, a 16-step profile at 300^3 (device
     busy share, top operations) beside the step's bound (factor bytes at
     3.35 TB/s, MLP and basis FLOPs at 67 and 989 TFLOP/s);
 17. D-NeRF (cli/main_dnerf.py) on the NGP trainer's time path, at the
     CLI's widths (a 16 x 2^15 canonical grid on K3/K4, bf16, 4096 rays x
     96 kept samples):
     17a. the deform, basis and hyper fields on the kept samples of one
     batch of the synthetic scene marched on a refreshed grid, at their
     frames' times, card against CPU with the same weights: sigma
     (relative), geo, rgb and every parameter gradient within phase 14a's
     tolerances (the deform field's geo on the card's canonical points, its
     deform MLP's dx apart within 2e-2 of the largest; the deform field on
     the CPU with the encoding's points
     given no gradient, as K3/K4 give them none: the deform net's
     gradient is exactly 0 on the card, printed beside the plain
     encode's, R7); on fresh weights each renders another image at t = 0
     and t = 1; K3/K4 against their plain versions on the deform field's
     canonical points x + dx with the train, a dense and a zero gradient;
     17b. main_dnerf.main synthetic -O --iters 512 (deform), then --variant
     basis and --variant hyper for 256 steps, each with every counter set
     to 0 just before and read just after: K3 == steps + refresh chunks +
     eval chunks and K4 == steps for deform and basis, 0 for hyper, the
     rest 0; the loss falls; a finite test PSNR and SSIM (beside phase 6's);
     the trainer's checkpoint in a fresh trainer renders the same test PSNR
     within 1e-3 dB;
     17c. deform train rays/s over steps 257-512, a 16-step profile (busy
     share, top operations) beside the step's bound (the deform MLP's
     FLOPs at 67 and 989 TFLOP/s, the table's bytes at 3.35 TB/s); the
     hyper step's time, the plain 4-D encode's share of it (and of its
     earlier torch.prod form, tools/hyper_probe.py), peak memory;
 18. SDF fitting and meshes:
     18a. the SDF field (16 x 2^15, MLP 3 x 64, f32) on 4096 points of
     sample_sdf_batch, card against CPU (sdf within 1e-5 of the largest
     output, gradients 1e-4 norm-wise); K3/K4 on those points;
     18b. main_sdf.main sphere --iters 1000 with the counters: K3 == 1000 +
     32 mesh chunks, K4 == 1000, the rest 0; the last loss below half the
     first, mean |pred - sdf| < 0.05 on a fresh batch, the mesh's mean
     vertex radius within 0.05 of 0.5; MeshSDF on a 1280-face sphere OBJ
     against the analytic sphere (the faceting) and against MeshSDF on the
     CPU (1e-5); main_sdf.main on that OBJ for 200 steps: the loss falls,
     K3 == 200 + 32, K4 == 200, mesh.obj written;
     18c. extract_mesh on phase 14's last .tar and on a 2-epoch cli/opt.py
     .npz at their sigma's 99th percentile: non-empty meshes, every
     counter 0;
     18d. the SDF step's time and K3/K4's share, MeshSDF's time for a
     batch;
 19. ResUNet (models/resunet.py) at its full width (layers 3/4/6, filters
     64/128/256, 64 output channels) on a seeded [1, 800, 800, 3] image and
     on the 96-px blender fixture's 4 first train views, card against CPU
     with TF32 off: f32 within 1e-4 of the largest output, bf16 within 3e-2
     norm-wise (the 96-px views); the forward's time by CUDA events;
 20. the interactive session (render/interactive.py):
     20a. main_nerf.main synthetic -O --gui --iters 256 at the CLI's
     1920x1080 (headless: dearpygui is absent), every counter 0 just before
     and read just after: K3 == steps + refresh chunks + the previews'
     ceil(rH rW / 8192) chunks, K4 == steps, the rest 0; every downscale in
     {1, 1/2, 1/4}; every frame finite; the checkpoint reloads into a fresh
     trainer; then preview frames of that trainer with the camera still
     (spp rises), orbited and zoomed (spp resets), with K3 == their chunks;
     main_nerf --gui --test (4 frames);
     20b. main_dnerf --gui (64 steps), a set_time change re-renders (spp
     back to 1); main_tensorf --gui and main_ccnerf --gui (64 steps each):
     no K1-K9 launch;
 21. data parallelism (parallel/) on the one card:
     21a. only that a process group of one rank changes nothing: the four
     trainers (Plenoxels 256^3 on K1/K2, NGP on K3/K4, NeRF and NeRF++ at
     D8 W256) take one step under init_distributed with NCCL at world 1,
     where no collective runs and no step is sharded: the loss equals the
     step without a process group bitwise, the weights (NGP: Adam's first
     moment, 0.1 x the gradient) within 1e-4 norm-wise (K2 and K4 add with
     atomics, whose order varies from run to run, and Adam's first step
     takes each gradient's sign);
     21b. two ranks spawned on the card over gloo with CUDA tensors (NCCL
     refuses two ranks on one GPU): one Plenoxels step (K1/K2, 5120 rays)
     and one NGP step at 2^15 (K3/K4, 4096 rays), each rank's gradients
     held against its own world-1 computation at the plain versions'
     tolerances (Plenoxels, f32: 1e-4 of the largest gradient entry; NGP,
     bf16 operands: phase 14a's 2e-2 norm-wise; the losses 1e-5), K1-K4
     launched on each rank; gloo's all-reduce of the SH gradient,
     timed.  This is the check of the sharded path.  No scaling figure: one
     card cannot give one;
     21c. the port's dry run, dryrun_multichip(2) on the card (gloo): one
     step each of NeRF, Plenoxels, NGP 2^15 and the 2^16 lattice engine,
     every rank holding the same weights after it;
 22. the Plenoxels tools:
     22a. cli/opt.py on the synthetic scene's 48x48 views written as an NSVF
     scene (OpenCV poses, intrinsics.txt with the pixel-centre offset) at
     256^3 for 3 epochs: K1 and K2 launch as in phase 3, the train PSNR
     rises and stays within 1 dB of phase 3's each epoch (grid radius 1.5
     against 1.2, 8-bit images), a finite test PSNR (its eval views flipped:
     the reference's fault R8);
     22b. cli/render_imgs.py on phase 3's last checkpoint: K1 = 2, K2 = 0,
     its mean PSNR within 1e-4 dB of the trainer's eval of the checkpoint's
     grid at render_imgs' max_steps (load_npz's default, 512: the
     reference's fault R9), that grid at cli/opt.py's 1792 steps within
     1e-4 dB of phase 3's test PSNR, the --timing FPS; cli/calc_metrics.py
     on its PNGs against the ground truth as PNGs: within 0.1 dB (8-bit
     rounding);
     22c. cli/to_svox1.py on phase 18c's 128^3 checkpoint: lookup_octree at
     10,000 seeded alive voxels equals the grid cast to f16; its wall time;
     22d. cli/autotune.py with 2 variants (lambda_tv 1e-5, 1e-4) of
     `cli/opt.py synthetic --n_epochs 1 --tune_nosave` at 256^3, each in a
     subprocess (its launches not counted): a 2-row leaderboard; the rerun
     skips both;
 23. CLIP guidance: the phase-5 trainer (`main_nerf synthetic -O`, 2^15,
     bf16) after one chunk (16 steps) and after 256 renders 2 rand_poses
     views at 64x64 through render/ngp.ngp_render_rays with autograd;
     CLIPGuidance with a seeded stub encoder (224^2 average-pooled to 8^2,
     a fixed map to 512) and one backward: K3 = K4 = 1 each; the loss and
     every parameter gradient against the same step on the CPU (the plain
     encode, the same marched samples) at phase 14a's tolerances, the
     table's gradient nonzero after 16 steps (after 256 every gradient is
     0 on both: R1); main_nerf's --clip_text and --rand_pose exit with the
     reference's messages;
 24. cli/run_nerf.py at full width (D8 W256, 64 + 128, bf16) for one epoch
     on the synthetic views written as a LINEMOD scene (48 px, the json's K
     and near/far) and as a deepvoxels scene (512 px, the loader's size; one
     train view): no K1-K9 launch, finite test PSNRs;
 25. the Plenoxels MSI background: cli/opt.py on phase 3's scene with
     configs/tnt.json's settings (n_epochs cut to 3) and svox2's
     Tanks&Temples background, --background_nlayers 64 --background_reso
     1024, at 256^3, SH degree 3: K1 = steps + 2 test renders, K2 = steps
     (phase 3's printed beside), rising train PSNR, the peak memory, the
     step time and a profiled epoch; K2 against its plain version on phase
     2's batch and the trained grid, with the cotangents of the background
     composite (log-T channel nonzero) on the trained background and on an
     opaque one, within 1e-4 of the largest gradient entry;
     render_imgs (K1 = 2) and render_orbit (8 frames at 48x48, K1 = 8) on
     its last checkpoint, which carries the background;
 26. NGP's background env-map: `main_nerf synthetic -O --log2_hashmap_size
     19 --iters 512 --bg_radius 32` on the lattice engine: launches equal
     phase 9's exactly (the 2-D background encode is plain torch), test
     PSNR beside phase 9's, and the trained field's test views on the
     env-map and on a white fill, their error split between the gt-white
     and the object's pixels; the trained background on one 4096-ray batch,
     card against CPU (bf16 operands: phase 14a's rgb tolerance);
 27. the Plenoxels options, each for one epoch at 256^3: the renders no
     kernel computes on the plain path, nvol and svox1 (cli/opt.py
     --renderer_backend) and a 3d_texture and an mlp basis (the trainer),
     K1 = K2 = 0 asserted, the path "plain"; the lumisphere TV on the
     kernel path (it reads the SH grid beside K1/K2), K1 = steps + the
     eval's chunks and K2 = steps asserted; step ms beside phase 3's;
     then weight_prune_grid over the 8 training cameras on phase 3's grid;
 28. the inspection tools: rays/visualize.save_debug_images (PNG) on
     phase 3's last quadtree, PhaseTimers around phases 25-28, BenchRecorder
     over phase 25's epochs, view_data's detection, scene load and cam-dict
     and inspect_cameras' epipolar lines without matplotlib.

The last lines are one JSON object describing the kernels (each row with
its launches on the runs of phases 17b, 18b and 20-28 as "launches_by_path"), the card's name
and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.  With no CUDA device, or with the port
missing, it exits non-zero and prints no result.
"""

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, f32 outside the
# tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
RESO = 256
STEP = 0.5
MAX_STEPS = int(3.5 * RESO / STEP)
BATCH = 5000               # cli/opt.py --batch_size: the rays of one train step
SCENE_RADIUS = 1.2         # cli/opt.py's grid radius for the synthetic scene
# floating-point operations per marched sample, counted from the kernels'
# source: sample position (6), trilinear weights (19), 28 channels x 8
# corners multiply-adds (448), 3 SH dot products (54), compositing (15);
# the backward recomputes that and adds a multiply-add per channel and
# corner (448) and the transmittance gradient (30)
FWD_FLOPS_PER_SAMPLE = 542
BWD_FLOPS_PER_SAMPLE = 542 + 448 + 30
# K1's density pass for a sample the gate drops: position (6), trilinear
# weights (19), 8 density multiply-adds (16)
DENSITY_FLOPS_PER_SAMPLE = 41

NGP_ITERS = 512            # 32 chunks of 16 steps: 16 full, 16 partial refreshes
NGP_WINDOW = 256           # steps per fit of the rays/s window
NGP_PROFILE_STEPS = 64
REFRESH_CHUNK = 1 << 16    # render/ngp.update_occupancy's chunk
# f32 operations per (point, level), counted from csrc/hash_encode.cu:
# position (6), frac and 1 - frac (6), 8 corner weights (16), 8 corners x 2
# features multiply-add (32); K4 recomputes the geometry (28) and forms
# the 16 products w * g (16)
K3_FLOPS = 60
K4_FLOPS = 44
LATTICE_FLAGS = ("--log2_hashmap_size", "19")   # torch-ngp's capacity: the lattice engine
SLAB_POINTS = 1 << 16      # the clustered two-z-slab points of phase 8
# K6/K7 do K3/K4's f32 arithmetic per (point, level) (their integer key
# arithmetic is not counted)
K6_FLOPS = K3_FLOPS
K7_FLOPS = K4_FLOPS
SORTED_FLAGS = ("--log2_hashmap_size", "19", "--hash_engine", "sorted")
CLUSTER_POINTS = 1 << 10   # points in each small cluster of phase 11's three-cluster input
# f32 operations per (point, level), 8 corners, counted from
# csrc/hash_sorted.cu: per corner K8 recomputes the position (6), frac and
# 1 - frac (6), the weight (2), w * f (2) and adds it (2); K9 the same
# geometry (14) and w * g (2), its run sums not counted
K8_FLOPS = 8 * 18
K9_FLOPS = 8 * 16
# The replaced designs' figures (K3/K4 before their tiles and paired
# loads, the sorted K6/K7 walks, the pair-walking K9; PERF.md section 6, on
# "NVIDIA H100 80GB HBM3, 700.00 W"), printed beside this run's
BEFORE = {"K1": "1.335 ms", "K2 sphere": "1.3884 ms", "K2 trained": "1.8308 ms",
          "K2 profile": "14.776 ms (8 launches)",
          "K3": "0.1758 ms", "K4 dense": "1.155 ms", "K4 train": "0.060 ms",
          "K6": "0.336 ms sorted, 0.390 point order", "K7 dense": "1.260 ms",
          "K7 train": "0.189 ms", "K7 profile": "13.9 ms (64 launches)",
          "lattice step": "5.135 ms", "K9 dense": "0.667 ms", "K9 train": "0.387 ms",
          "sorted step": "10.67 ms", "peak": {"lattice": "3.85 GB", "sorted": "5.19 GB"}}


NERF_FLAGS = ("--dataset_type", "blender", "--white_bkgd", "--use_viewdirs",
              "--N_importance", "128", "--N_rand", "1920", "--precrop_iters", "500",
              "--n_epoch", "8", "--init_level", "2", "--subdivide_every", "3",
              "--testskip", "1")    # tools/golden_run.py run_fixture_nerf, at the CLI's D8 W256
NERF_BAND_DB = 22.0        # GOLDEN_runs.json fixture_nerf expected.min_psnr
NERF_PROFILE_STEPS = 16
# phase 14a, card against CPU (bf16 operands, f32 sums in another order on
# each device; an operand on a bf16 rounding boundary can round the other
# way): rgb within 2e-3, each weight gradient within 2e-2 of its norm
NERF_RGB_TOL = 2e-3
NERF_GRAD_TOL = 2e-2
# phase 15: NeRF++ at the T&T Truck config's widths (D8 W256, 64 + 128
# samples, batch 1920, bf16) on the 96-px nerf++ fixture; 15a holds both
# cascade levels card against CPU at phase 14a's tolerances
NERFPP_CONFIG = os.path.join("configs", "tat_training_truck.txt")
NERFPP_PROFILE_STEPS = 16
# phase 16: TensoRF and CCNeRF at the CLIs' widths.  The VM schedule is the
# reference's 2000, 3000, 4000, 5500 and 7000 of 30,000 steps cut by 16 and
# rounded to whole 16-step chunks: every shrink and upsample, 128^3 to 300^3
TENSORF_ITERS = 1024
TENSORF_UPSAMPLE = (128, 192, 256, 352, 448)
TENSORF_CP_ITERS = 256
TENSORF_CCNERF_ITERS = 512
TENSORF_PROFILE_STEPS = 16
TENSORF_RES_TOL = 0.05     # the last resolution's product against 300^3
# phase 17: D-NeRF at main_dnerf's widths (16 x 2^15 canonical grid, deform
# MLP 5 x 128, basis and ambient MLPs 5 x 128, bf16); 30,000 steps cut as
# the NGP phases' are
DNERF_VARIANTS = ("deform", "basis", "hyper")
DNERF_ITERS = 512
DNERF_VARIANT_ITERS = 256
DNERF_WINDOW = 256         # steps per fit of the rays/s window
DNERF_PROFILE_STEPS = 16
# phase 18: SDF at main_sdf's widths (16 x 2^15, MLP 3 x 64, f32, batch
# 4096, a 128^3 mesh grid); 20,000 steps cut to 1000, the mesh path to 200
SDF_ITERS = 1000
SDF_MESH_ITERS = 200
SDF_BATCH = 4096
SDF_MESH_RESO = 128
# phase 25: svox2's Tanks&Temples MSI background (opt/configs/tnt.json)
MSI_LAYERS = 64
MSI_RESO = 1024
ORBIT_FRAMES = 8
BG_RADIUS = 32             # torch-ngp's --bg_radius for unbounded scenes


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_kernels(log):
    """Per kernel of an nvcc -Xptxas=-v log: its name, registers, static
    shared memory and spills ("name: 40 registers, 4096 bytes smem, spill
    0/0 bytes")."""
    import re
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            # the first length-prefixed identifier that names a kernel
            at = next(((j, int(mangled[i:j])) for i in range(len(mangled))
                       for j in range(i + 1, len(mangled))
                       if mangled[i:j].isdigit() and mangled[j].isalpha()
                       and mangled[j:j + int(mangled[i:j])].endswith("kernel")), None)
            name = mangled
            if at:
                name = mangled[at[0]:at[0] + at[1]]
                # template arguments: I, then types (9LatticeGeo), ints (Li2E)
                # and bools (Lb1E), then E
                rest, targs = mangled[at[0] + at[1]:], []
                if rest.startswith("I"):
                    k = 1
                    while k < len(rest) and rest[k] != "E":
                        m = re.match(r"L([ib])(\d+)E|(\d+)", rest[k:])
                        if not m:
                            break
                        if m.group(3):
                            n = int(m.group(3))
                            targs.append(rest[k + len(m.group(3)):k + len(m.group(3)) + n])
                            k += len(m.group(3)) + n
                        else:
                            targs.append(m.group(2) if m.group(1) == "i" else
                                         "true" if m.group(2) == "1" else "false")
                            k += m.end()
                if targs:
                    name += "<" + ", ".join(targs) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} bytes"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {m.group(2) or 0} bytes smem, {spill}")
            name, spill = None, ""
    return out


def reset_counts():
    """Every kernel wrapper's launch counter to 0."""
    from flnerf_tpu_torch.ops import hash_kernel, hash_lattice, hash_sorted, sort_kernel
    from flnerf_tpu_torch.ops import tv_rmsprop, voxel_kernel
    for mod in (hash_kernel, hash_lattice, hash_sorted, sort_kernel, tv_rmsprop, voxel_kernel):
        mod.reset_launch_counts()


def launch_counts():
    """{K1..K9, S1 (the dense TV + RMSProp sweep), S1 pairs (live_pairs):
    launches since the last reset_counts}."""
    from flnerf_tpu_torch.ops import hash_kernel as hk, hash_lattice as hl, hash_sorted as hs
    from flnerf_tpu_torch.ops import sort_kernel as sk, tv_rmsprop as tr, voxel_kernel as vk
    return {"K1": vk.FWD_LAUNCHES, "K2": vk.BWD_LAUNCHES, "K3": hk.HASH_FWD_LAUNCHES,
            "K4": hk.HASH_BWD_LAUNCHES, "K5": sk.SORT_LAUNCHES,
            "K6": hl.LATTICE_FWD_LAUNCHES, "K7": hl.LATTICE_BWD_LAUNCHES,
            "K8": hs.SORTED_FWD_LAUNCHES, "K9": hs.SORTED_BWD_LAUNCHES,
            "S1": tr.SWEEP_LAUNCHES, "S1 pairs": tr.PAIRS_LAUNCHES}


def plx_fit_counts(steps, **kernels):
    """The launches of a Plenoxels fit of ``steps`` steps on the card from
    one grid (no resample): ``kernels`` (K1, K2), and a dense TV + RMSProp
    sweep for density and one for SH a step with the grid's live pairs
    computed once; 0 for every other kernel."""
    want = dict({k: 0 for k in launch_counts()}, **kernels)
    want.update({"S1": 2 * steps, "S1 pairs": 1 if steps else 0})
    return want


def recorded(fn):
    """``fn()`` with the program's recorder on: (its result, the recorder's
    counters), the recorder off and empty again after."""
    from flnerf_tpu_torch.core.logging_utils import RECORDER
    RECORDER.reset()
    RECORDER.enable()
    try:
        out = fn()
    finally:
        RECORDER.disable()
    counters = dict(RECORDER.counters)
    RECORDER.reset()
    return out, counters


def cuda_ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sphere_grid(device):
    """The bench's filled sphere at 256^3 (density U(0,2), SH N(0,0.3^2)
    inside r < 0.55), with ~10% of all cells pruned, from a seed."""
    import torch
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid
    gen = torch.Generator(device=device).manual_seed(0)
    idx = (torch.arange(RESO, device=device, dtype=torch.float32) - (RESO - 1) / 2) / (RESO / 2)
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    inside = torch.sqrt(x * x + y * y + z * z) < 0.55
    shape = (RESO,) * 3
    density = torch.where(inside, 2.0 * torch.rand(shape, generator=gen, device=device), 0.0)
    sh = torch.where(inside[..., None],
                     0.3 * torch.randn(shape + (27,), generator=gen, device=device), 0.0)
    alive = torch.rand(shape, generator=gen, device=device) > 0.1
    return VoxelGrid(density, sh, alive)


def scene():
    """The synthetic scene as cli/opt.py loads it: 8 train and 2 test views
    at 48x48, their poses and intrinsics."""
    from flnerf_tpu_torch.data.synthetic import load_synthetic_data
    from flnerf_tpu_torch.rays.camera import intrinsics_matrix
    images, poses, _, hwf, (i_train, _, i_test) = load_synthetic_data(
        n_train=8, n_test=2, H=48, W=48)
    H, W, focal = int(hwf[0]), int(hwf[1]), hwf[2]
    return images, poses, H, W, focal, intrinsics_matrix(H, W, focal), i_train, i_test


def first_epoch(images, poses, H, W, K, i_train):
    """The quadtree budgeter's first epoch, as cli/opt.py and the trainer
    draw it (init_level 2, seed 0): rays in the budgeter's shuffled order."""
    from flnerf_tpu_torch.rays.camera import get_rays_np
    from flnerf_tpu_torch.rays.quadtree import RayBudgeter
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses[i_train]]
    budgeter = RayBudgeter(images[i_train], np.stack([r[0] for r in rays]),
                           np.stack([r[1] for r in rays]), init_level=2, seed=0)
    return budgeter.gen_rays()


def wide_batches(poses, i_train, size, device):
    """One training batch from the train views rendered at size x size (the
    lego views' 800x800): BATCH pixels drawn uniformly over all views (what
    the budgeter's shuffle gives at a full-pixel budget), and the first BATCH
    pixels of the trainer's coherence order of every pixel."""
    import torch
    from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix
    from flnerf_tpu_torch.train.plenoxels_trainer import coherence_order
    K = intrinsics_matrix(size, size, 0.9 * size)
    rays = [get_rays_np(size, size, K, p[:3, :4]) for p in poses[i_train]]
    o_all = np.stack([r[0] for r in rays]).reshape(-1, 3)
    d_all = np.stack([r[1] for r in rays]).reshape(-1, 3)
    n_all = o_all.shape[0]
    shuffled = np.random.default_rng(0).choice(n_all, BATCH, replace=False)
    flat = np.arange(n_all)
    img, pix = flat // (size * size), flat % (size * size)
    ordered = coherence_order(pix // size, pix % size, img, np.random.default_rng(0))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return {"shuffled": (t(o_all[shuffled]), t(d_all[shuffled])),
            "coherent": (t(o_all[ordered[:BATCH]]), t(d_all[ordered[:BATCH]]))}


def eval_chunks(pose, size, chunk, device):
    """The eval chunk (``--eval_chunk`` rays) of a size x size test view that
    holds its center pixel, in raster and in morton order."""
    import torch
    from flnerf_tpu_torch.ops.voxel_kernel import morton_order
    from flnerf_tpu_torch.rays.camera import get_rays_np, intrinsics_matrix
    ro, rd = get_rays_np(size, size, intrinsics_matrix(size, size, 0.9 * size), pose[:3, :4])
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    center = (size // 2) * size + size // 2
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    out = {}
    for name, order in (("raster", np.arange(size * size)),
                        ("morton", morton_order(xx.reshape(-1), yy.reshape(-1),
                                                np.zeros(size * size, np.int64)))):
        k = int(np.nonzero(order == center)[0][0]) // chunk * chunk
        out[name] = (t(ro[order[k:k + chunk]]), t(rd[order[k:k + chunk]]))
    return out


def work_counts(grid, cfg, o, d):
    """What this run's data needs: the marched samples (t <= tmax) and the
    distinct cells their corners touch (all, and alive)."""
    import torch
    from flnerf_tpu_torch.models.voxel_sh import grid_ray_setup
    origins, dirs, tmin, tmax, _, _ = grid_ray_setup(cfg, o, d)
    steps = torch.arange(cfg.max_steps, device=o.device)
    hi = torch.tensor([r - 1.0 for r in cfg.reso], device=o.device)
    cells, n_samples = [], 0
    for i in range(0, o.shape[0], 128):
        ts = tmin[i:i + 128, None] + cfg.step_size * steps[None, :]
        valid = ts <= tmax[i:i + 128, None]
        pos = origins[i:i + 128, None, :] + ts[..., None] * dirs[i:i + 128, None, :]
        pos = pos[valid]
        n_samples += pos.shape[0]
        pos = torch.minimum(torch.clamp(pos, min=0.0), hi)
        l = torch.minimum(torch.floor(pos), hi - 1.0).long()
        for c in range(8):
            ix, iy, iz = l[:, 0] + (c >> 2), l[:, 1] + ((c >> 1) & 1), l[:, 2] + (c & 1)
            cells.append(((ix * cfg.reso[1] + iy) * cfg.reso[2] + iz).unique())
    cells = torch.cat(cells).unique()
    n_alive = int(grid.alive.reshape(-1)[cells].sum())
    return n_samples, int(cells.numel()), n_alive


def hold_k1_bitwise(grid, cfg, o, d, what):
    """K1 through its wrapper (the occupancy built before the launch) is
    equal, bit for bit, to the kernel it replaced (kept by
    tools/voxel_probe.py) on these rays."""
    import torch
    from flnerf_tpu_torch.ops import voxel_kernel as vk
    from flnerf_tpu_torch.tools import voxel_probe
    ray_in = vk.ray_inputs(cfg, o, d)
    new = vk.cuvol_forward(*grid.tensors, *ray_in, cfg)
    old = torch.full_like(new, float("nan"))
    voxel_probe.launch(voxel_probe.REPLACED, grid, ray_in, cfg, None, old)
    torch.cuda.synchronize()
    bad = int((new != old).any(-1).sum())
    print(f"[phase 2] K1 against the replaced K1 on {what} (sigma_thresh {cfg.sigma_thresh}): "
          f"{bad} of {o.shape[0]} rays differ in any bit", flush=True)
    check(bad == 0, f"K1 is not bitwise equal to the replaced K1 ({what})")


def hold_k2(grid, cfg, o, d, gt, what):
    """K2 on these rays (the forward's occupancy passed, as RenderFused
    passes it) against the plain version's gradient (within 1e-4 of its
    largest entry) and the kernel it replaced (tools/voxel_probe.py, within
    1e-5; atomics from many rays add in any order), and K2 without a merge
    bit for bit the replaced kernel on the ray of largest acc alone (one
    warp's atomics apply in program order).  Returns the largest error
    against the plain version."""
    import torch
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid
    from flnerf_tpu_torch.ops import voxel_kernel as vk
    from flnerf_tpu_torch.tools import voxel_probe
    ray_in = vk.ray_inputs(cfg, o, d)
    occ = vk.skip_occupancy(grid.density, grid.alive, cfg)
    out = vk.cuvol_forward(*grid.tensors, *ray_in, cfg, occ=occ)
    grad_out = upstream_grad(out, gt)
    got = vk.cuvol_backward(*grid.tensors, *ray_in, out, grad_out, cfg, occ=occ)
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    plain = torch.autograd.grad(vk.render_rays_plain(VoxelGrid(dens, sh, grid.alive), o, d, cfg),
                                [dens, sh], grad_out)
    del dens, sh
    zeros = lambda: (torch.zeros_like(grid.density), torch.zeros_like(grid.sh))
    want = zeros()
    voxel_probe.launch_backward(voxel_probe.REPLACED_K2_NAME, grid, ray_in, cfg, None, out,
                                grad_out, want)
    torch.cuda.synchronize()
    errs = {k: float((a - b).abs().max()) for k, a, b in
            zip(("grad_density", "grad_sh"), got, plain)}
    scale = {k: float(b.abs().max()) for k, b in zip(("grad_density", "grad_sh"), plain)}
    rel_old = voxel_probe.backward_error(got, want)
    # one ray, the one of largest acc, without the merge
    i = int(out[:, 5].argmax())
    one_in = [t[i:i + 1].contiguous() for t in ray_in]
    one = zeros()
    voxel_probe.launch_backward(voxel_probe.merge_off_variant(), grid, one_in, cfg, occ,
                                out[i:i + 1].contiguous(), grad_out[i:i + 1].contiguous(), one)
    one_old = zeros()
    voxel_probe.launch_backward(voxel_probe.REPLACED_K2_NAME, grid, one_in, cfg, None,
                                out[i:i + 1].contiguous(), grad_out[i:i + 1].contiguous(), one_old)
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(one, one_old))
    pruned = max(float(a[~grid.alive].abs().max()) for a in got)
    print(f"[phase 2] K2 on {what} (sigma_thresh {cfg.sigma_thresh}): max_err against the plain "
          f"version {errs} (scale {scale}); against the replaced K2 {rel_old:.3e} of the largest "
          f"entry; {voxel_probe.merge_off_variant()!r} on ray {i} alone bitwise the replaced K2: "
          f"{bitwise}; pruned cells' largest |gradient| {pruned}", flush=True)
    for k in errs:
        check(scale[k] > 0 and errs[k] <= 1e-4 * scale[k],
              f"K2 {k} differs from the plain version by {errs[k]} > 1e-4 * {scale[k]} ({what}, "
              f"sigma_thresh {cfg.sigma_thresh})")
    check(rel_old <= 1e-5, f"K2 differs from the replaced K2 by {rel_old} of the largest entry "
                           f"({what}, sigma_thresh {cfg.sigma_thresh})")
    check(bitwise, f"K2 without a merge is not bitwise the replaced K2 on one ray ({what}, "
                   f"sigma_thresh {cfg.sigma_thresh})")
    check(pruned == 0.0, f"K2 gave a pruned cell a gradient ({what})")
    return max(errs.values())


def upstream_grad(out, gt):
    """d/d(out) of mean((rgb - gt)^2) + 0.1 * sum(log_T): phase 2's loss."""
    import torch
    g = torch.zeros_like(out)
    g[:, :3] = 2.0 * (out[:, :3] - gt) / gt.numel()
    g[:, 4] = 0.1
    return g


def kernel_ms(grid, cfg, o, d, gt, iters=20):
    """K1 and K2's kernel body on one batch, by CUDA events, as the main
    path calls them: K1 through its wrapper, the occupancy built before the
    launch; K2 with that occupancy passed in, adding into gradient buffers
    zero-filled once, outside the timed loop."""
    import torch
    from flnerf_tpu_torch.ops import voxel_kernel as vk
    ray_in = vk.ray_inputs(cfg, o, d)
    occ = vk.skip_occupancy(grid.density, grid.alive, cfg)
    out = vk.cuvol_forward(*grid.tensors, *ray_in, cfg, occ=occ)
    grad_out = upstream_grad(out, gt)
    grads = (torch.zeros_like(grid.density), torch.zeros_like(grid.sh))
    k1 = cuda_ms(lambda: vk.cuvol_forward(*grid.tensors, *ray_in, cfg), iters)
    k2 = cuda_ms(lambda: vk.cuvol_backward(*grid.tensors, *ray_in, out, grad_out, cfg,
                                           grads=grads, occ=occ), iters)
    return k1, k2


def ngp_setup(workspace, extra=()):
    """The NGP trainer and sampler as cli/main_nerf builds them for
    `synthetic -O --iters 512` (plus ``extra`` flags), the test views'
    indices and [H, W, focal]."""
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler
    args = main_nerf.parse_args(["synthetic", "-O", "--iters", str(NGP_ITERS),
                                 "--workspace", workspace, *extra])
    trainer, _, _, tcfg = main_nerf.build(args)
    images, poses, hwf, K, (i_train, _, i_test) = main_nerf.load_ngp_dataset(args)
    sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)
    return trainer, sampler, i_test, hwf


def expected_hash_launches(trainer, n_test, hwf):
    """K3 launches of one main_nerf run: one per train step, per refresh
    chunk (full sweeps for the first full_refreshes chunks, then one parity
    class) and per eval chunk.  Returns (total, refresh chunks, eval chunks)."""
    tcfg, rcfg = trainer.cfg, trainer.rcfg
    n_chunks = -(-tcfg.max_steps // tcfg.steps_per_chunk)
    g, s = rcfg.grid_size, max(rcfg.partial_stride, 2)
    full = -(-g ** 3 // REFRESH_CHUNK)
    part = -(-(g // s) ** 3 // REFRESH_CHUNK) if g % s == 0 else full
    refresh = sum(part if ci >= tcfg.full_refreshes else full for ci in range(n_chunks))
    n = hwf[0] * hwf[1]
    chunk = min(4096, (n + 127) // 128 * 128)        # main_nerf --max_ray_batch
    n_eval = n_test * -(-n // chunk)
    return n_chunks * tcfg.steps_per_chunk + refresh + n_eval, refresh, n_eval


def bound_of(nbytes, flops):
    """(least ms, what bounds it): bytes over HBM, f32 operations over the
    f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def next_batch_encode(trainer, sampler, to_dev, encoder):
    """The encoding's input and the train loss's real upstream gradient on
    the trainer's next batch: ``encoder`` (the encode's name in
    models/hash_ngp) is wrapped while the batch renders through the
    trainer's field and occupancy grid.  Returns (x01, gradient of the whole
    [N, L*2] encoding).  (The loss is differentiated for the field's first
    table, which every engine's encoding reads.)"""
    import torch
    from flnerf_tpu_torch.models import hash_ngp
    from flnerf_tpu_torch.render.ngp import ngp_render_rays
    drawn = copy.deepcopy(sampler).sample_chunk(1, trainer.cfg.batch_rays)
    bo, bd, brgb = drawn[:3]
    times = to_dev(drawn[5][0]) if len(drawn) == 6 else None      # a D-NeRF sampler's
    seen = {}
    inner = getattr(hash_ngp, encoder)

    def capture(x01, tables, spec_):
        out = inner(x01, tables, spec_)
        seen["x01"] = x01
        out.register_hook(lambda g: seen.setdefault("g", g))
        return out

    setattr(hash_ngp, encoder, capture)
    try:
        out = ngp_render_rays(trainer.field, trainer.occ, to_dev(bo[0]), to_dev(bd[0]),
                              trainer.rcfg, generator=trainer.gen, times=times)
        torch.autograd.grad(torch.mean((out["rgb"] - to_dev(brgb[0])) ** 2),
                            [next(trainer.field.parameters())])
    finally:
        setattr(hash_ngp, encoder, inner)
    return seen["x01"].detach().contiguous(), seen["g"]


def refresh_chunk(trainer, gen):
    """The first REFRESH_CHUNK cells of a full occupancy refresh, jittered,
    as the encoding's input."""
    import torch
    dev = trainer.device
    g_cells = trainer.rcfg.grid_size
    idx = torch.arange(g_cells, device=dev)
    cells = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    cells = cells[:REFRESH_CHUNK].float() + torch.rand((REFRESH_CHUNK, 3), generator=gen,
                                                       device=dev)
    return trainer.field.unit_points(
        (cells / g_cells * 2.0 - 1.0) * trainer.rcfg.bound).contiguous()


def two_slabs(gen, dev):
    """SLAB_POINTS points in two separated z-slabs
    (tests/test_hash_lattice.py:60), where the TPU engines drop corners
    outside their slabs."""
    import torch
    x = torch.rand((SLAB_POINTS, 3), generator=gen, device=dev)
    x[:, 2] *= 0.08
    x[SLAB_POINTS // 2:, 2] += 0.9
    return x


def autograd_view(g_big, n_small):
    """The view of the big levels' [N, Lb*2] gradient that the split
    encode's backward hands K7: [Lb, N, 2], transposed, in rows of the whole
    [N, (Ls + Lb)*2] upstream gradient."""
    import torch
    n, lb = g_big.shape[0], g_big.shape[1] // 2
    full = torch.zeros((n, n_small + lb, 2), device=g_big.device)
    full[:, n_small:] = g_big.view(n, lb, 2)
    return full[:, n_small:].transpose(0, 1)


def hold_hash_kernels(spec, table, cases, tag):
    """K3 and K4 against the plain version on each (name, x01, upstream
    gradient as K4 is handed it) case: K3 within 1e-5 of the largest
    output, K4 within 1e-4 of the largest entry, and exactly zero on a zero
    gradient.  Returns (K3's, K4's) largest error."""
    import torch
    from flnerf_tpu_torch.ops import hash_kernel as hk
    k3_err = k4_err = 0.0
    for name, xx, g_up in cases:
        n = xx.shape[0]
        with torch.no_grad():
            out_k = hk.hash_encode_forward(xx, table, spec)
            out_p = hk.hash_encode_plain(xx, table, spec)
        grad_k = hk.hash_encode_backward(xx, g_up, spec)
        grad_p = torch.zeros_like(table)
        if n:
            tp = table.clone().requires_grad_(True)
            (grad_p,) = torch.autograd.grad(hk.hash_encode_plain(xx, tp, spec), [tp], g_up)
        torch.cuda.synchronize()
        e3 = float((out_k - out_p).abs().max()) if n else 0.0
        s3 = float(out_p.abs().max()) if n else 0.0
        e4, s4 = float((grad_k - grad_p).abs().max()), float(grad_p.abs().max())
        zero = not bool(g_up.any())
        live = float((g_up != 0).any(-1).float().mean()) if n else 0.0
        print(f"[{tag}] K3/K4 on {name} ({n} points, nonzero gradient at {live:.4f} of them, "
              f"gradient strides {tuple(g_up.stride())}): "
              f"K3 max_err {e3:.3e} (largest output {s3:.4e}), K4 max_err {e4:.3e} (largest "
              f"entry {s4:.4e}{', a zero gradient' if zero else ''})", flush=True)
        check(tuple(out_k.shape) == (n, spec.output_dim) and bool(torch.isfinite(out_k).all()),
              f"K3 output of shape {tuple(out_k.shape)} not finite or misshapen ({name})")
        check(e3 <= 1e-5 * s3, f"K3 differs from the plain version by {e3} > 1e-5 * {s3} ({name})")
        if zero:
            check(not bool(grad_k.any()), f"K4 is not exactly zero on a zero gradient ({name})")
        else:
            check(s4 > 0 and e4 <= 1e-4 * s4,
                  f"K4 differs from the plain version by {e4} > 1e-4 * {s4} ({name})")
        k3_err, k4_err = max(k3_err, e3), max(k4_err, e4)
    return k3_err, k4_err


def print_probe(tag, what, ms, gnames):
    """The hash probe's times and its finding for each gradient."""
    from flnerf_tpu_torch.tools import hash_probe
    print(f"[{tag}] K3/K4 probe (flnerf_tpu_torch/tools/hash_probe.py) on {what}, ms by "
          f"events / device ms: " + "; ".join(f"{k} {ev:.4f} / {dt:.4f}"
                                              for k, (ev, dt) in ms.items()), flush=True)
    for g in gnames:
        print(f"[{tag}] finding, {what}, {hash_probe.finding(ms, g)}", flush=True)


def lattice_phases(dev, to_dev):
    """Phases 8-10, the hash-NGP path at 2^19 (the lattice engine: K3, K4,
    K6, K7; K5 is gated on its keys but no longer on the path).  Returns
    phase 9's test PSNR, K5's largest key error, phase 9's launches (K1-K7)
    and the K6 and K7 rows of the kernels line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.ops import hash_kernel as hk
    from flnerf_tpu_torch.ops import hash_lattice as hl
    from flnerf_tpu_torch.ops import sort_kernel as sk
    from flnerf_tpu_torch.ops import voxel_kernel as vk
    from flnerf_tpu_torch.tools import lattice_probe

    # ---- phase 8: K5, K6 and K7 against their plain versions ----
    lat_tmp = tempfile.TemporaryDirectory()
    trainer, sampler, n_test, hwf = ngp_setup(lat_tmp.name, LATTICE_FLAGS)
    spec = trainer.field.spec
    n_small = spec.split.n_small
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)    # steps 1-256
    # the next batch, through the trainer's own loss: the big levels' input
    # and real upstream gradient are read at the split encode
    x_batch, g_seen = next_batch_encode(trainer, sampler, to_dev, "lattice_encode_split")
    table = trainer.field.table_big.detach().clone()
    g_train = g_seen[:, 2 * n_small:].contiguous()
    gen = torch.Generator(device=dev).manual_seed(2)
    x_refresh = refresh_chunk(trainer, gen)
    x_slabs = two_slabs(gen, dev)
    inputs = {"train batch": x_batch, "refresh chunk": x_refresh, "two z-slabs": x_slabs}
    print(f"[phase 8] lattice spec: {n_small} small levels (t_cap {spec.split.small.t_cap}), "
          f"{spec.n_big} big levels (sizes {spec.split.big.sizes.tolist()}), big table "
          f"{tuple(table.shape)} = {table.numel() * 4 / 1e6:.1f} MB", flush=True)

    k5_err = 0
    bits = sk.key_bits_for(spec.t_big)
    for name, xx in inputs.items():
        keys, iota = hl.lattice_sort_inputs(xx, spec)
        want = sk.bitonic_sort_plain(keys, iota)          # torch.sort(stable=True), a gather
        for variant, kb in ((2, bits), (1, bits), (2, sk.KEY_BITS)):
            got = sk.bitonic_sort(keys, iota, variant=variant, key_bits=kb)
            torch.cuda.synchronize()
            wrong = [int((a != b).sum()) for a, b in zip(got, want)]
            print(f"[phase 8] K5 (variant {variant}, {kb} key bits) on the {name}'s keys "
                  f"{tuple(keys.shape)}: {wrong[0]} keys and {wrong[1]} payloads differ from "
                  f"the stable sort", flush=True)
            check(wrong == [0, 0], f"K5 (variant {variant}, {kb} bits) differs from the "
                                   f"stable sort ({name})")
            k5_err = max(k5_err, int((got[0].long() - want[0].long()).abs().max()))
    # more rows than the grid's y axis holds (65,535): the wrapper launches
    # blocks of rows
    keys = torch.randint(0, 1 << 12, (1 << 16, 128), generator=gen, device=dev,
                         dtype=torch.int32)
    pay = torch.arange(keys.numel(), dtype=torch.int32, device=dev).view(keys.shape)
    got, want = sk.bitonic_sort(keys, pay), sk.bitonic_sort_plain(keys, pay)
    torch.cuda.synchronize()
    wrong = [int((a != b).sum()) for a, b in zip(got, want)]
    print(f"[phase 8] K5 on {tuple(keys.shape)} keys with payloads (row blocks "
          f"{sk.row_blocks(keys.shape[0])}): {wrong[0]} keys and {wrong[1]} payloads differ "
          f"from the stable sort", flush=True)
    check(wrong == [0, 0], "K5 beyond 65,535 rows differs from the stable sort")
    del got, want, keys, pay

    k6_err = k7_err = 0.0
    for name, xx in inputs.items():
        with torch.no_grad():
            out_k = hl.lattice_encode_forward(xx, table, spec)        # [Lb, N, 2]
            out_p = hl.lattice_encode_plain_levels(xx, table, spec)
        torch.cuda.synchronize()
        err, scale = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        print(f"[phase 8] K6 on the {name} {tuple(xx.shape)}: max_err {err:.3e} "
              f"(largest output {scale:.4e})", flush=True)
        check(bool(torch.isfinite(out_k).all()), f"K6 output not finite ({name})")
        check(scale > 0 and err <= 1e-6 * scale,
              f"K6 differs from the plain version by {err} > 1e-6 * {scale} ({name})")
        k6_err = max(k6_err, err)
    del out_k, out_p
    grads = [("train batch", "train gradient", g_train)] + [
        (name, "dense gradient", torch.randn((xx.shape[0], 2 * spec.n_big), generator=gen,
                                             device=dev))
        for name, xx in inputs.items()] + [
        ("train batch", "zero gradient", torch.zeros_like(g_train))]
    for name, what, g_up in grads:
        xx = inputs[name]
        # K7 reads the gradient as autograd hands it back from the split
        # encode's assembly: a transposed view, in place
        grad_k = hl.lattice_encode_backward(xx, autograd_view(g_up, n_small), spec)
        tp = table.clone().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(hl.lattice_encode_plain(xx, tp, spec), [tp], g_up)
        torch.cuda.synchronize()
        err, scale = float((grad_k - grad_p).abs().max()), float(grad_p.abs().max())
        live = float((g_up != 0).any(-1).float().mean())
        print(f"[phase 8] K7 on the {name}, {what} (nonzero at {live:.4f} of the points): "
              f"max_err {err:.3e} (largest entry {scale:.4e})", flush=True)
        # a zero gradient (the train gradient on a plateau) must give exactly zero
        check((scale > 0 or what != "dense gradient") and err <= 1e-4 * scale,
              f"K7 differs from the plain version by {err} > 1e-4 * {scale} ({name}, {what})")
        k7_err = max(k7_err, err)
    g_dense = grads[1][2]
    del grad_k, grad_p, tp, grads
    # K3 and K4 on the small levels, K4 on the gradient as the split
    # encode's assembly hands it over: the first 2 * n_small columns of the
    # whole upstream gradient, read in place
    small_spec = spec.split.small
    table_small = trainer.field.table_small.detach().clone()
    g_small = g_seen[:, :2 * n_small]
    g_small_dense = torch.randn((x_batch.shape[0], g_seen.shape[1]), generator=gen,
                                device=dev)[:, :2 * n_small]
    hold_hash_kernels(small_spec, table_small, [
        ("the train batch's small levels, the train gradient's columns", x_batch, g_small),
        ("the train batch's small levels, a dense gradient's columns", x_batch, g_small_dense),
        ("the train batch's small levels, a zero gradient", x_batch, torch.zeros_like(g_small)),
    ] + [(f"the {name}'s small levels, a dense gradient", xx,
          torch.randn((xx.shape[0], 2 * n_small), generator=gen, device=dev))
         for name, xx in inputs.items() if name != "train batch"], "phase 8")

    # ---- phase 9: the lattice main path, through the CLI on the card ----
    for mod in (hk, hl, sk, vk):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = main_nerf.main(["synthetic", "-O", *LATTICE_FLAGS, "--iters", str(NGP_ITERS),
                              "--workspace", tmp])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"K3": hk.HASH_FWD_LAUNCHES, "K4": hk.HASH_BWD_LAUNCHES,
                    "K5": sk.SORT_LAUNCHES, "K6": hl.LATTICE_FWD_LAUNCHES,
                    "K7": hl.LATTICE_BWD_LAUNCHES}
        with open(os.path.join(tmp, "results.txt")) as f:
            results = f.read().split()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["steps"]
    losses = [h["chunk_loss"] for h in res["history"]]
    want_fwd, n_refresh, n_eval = expected_hash_launches(trainer, len(n_test), hwf)
    print(f"[phase 9] launches {launches} (K1 {vk.FWD_LAUNCHES}, K2 {vk.BWD_LAUNCHES}); "
          f"steps {steps}, refresh chunks {n_refresh}, eval chunks {n_eval}; mean train loss "
          f"per chunk first {losses[0]:.5f} last {losses[-1]:.5f} (min {min(losses):.5f} max "
          f"{max(losses[1:]):.5f} after the first); test PSNR {res['psnr']:.3f} SSIM "
          f"{res['ssim']:.4f}; main {wall:.1f} s; peak memory {peak_gb:.2f} GB (before: "
          f"{BEFORE['peak']['lattice']}); results.txt {results}", flush=True)
    check(launches["K4"] == launches["K7"] == steps == NGP_ITERS,
          f"K4/K7 launches {launches} != steps {steps}")
    check(launches["K3"] == launches["K6"] == want_fwd,
          f"K3/K6 launches {launches} != steps + refresh + eval chunks {want_fwd}")
    check(launches["K5"] == 0, f"the lattice path sorted: {launches}")
    check(vk.FWD_LAUNCHES == vk.BWD_LAUNCHES == 0, "the NGP path launched a cuvol kernel")
    check(all(math.isfinite(v) for v in losses), f"train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")

    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)
    torch.cuda.synchronize()
    win_s = time.time() - t0
    print(f"[phase 9] train rays/s over steps {NGP_WINDOW + 1}-{2 * NGP_WINDOW}: "
          f"{NGP_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({NGP_WINDOW} steps, "
          f"{NGP_WINDOW // trainer.cfg.steps_per_chunk} partial refreshes, {win_s:.3f} s); "
          f"loss {trainer.history[-1]['loss']:.5f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=NGP_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 9] profiled lattice fit of {NGP_PROFILE_STEPS} steps: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%), "
          f"{dev_ms / NGP_PROFILE_STEPS:.3f} ms of device time a step (before: "
          f"{BEFORE['lattice step']}); top kernels by device time:")
    for e in dev_events[:14] + [e for e in dev_events[14:]
                                if "hash_" in e.key or "lattice" in e.key or "radix" in e.key
                                or "tile_bwd" in e.key]:
        print(f"[phase 9]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    k7_prof = [e for e in dev_events if "LatticeGeo" in e.key]
    k7_prof_ms = sum(e.self_device_time_total for e in k7_prof) / 1e3
    k7_prof_n = sum(e.count for e in k7_prof)
    print(f"[phase 9] K7 in the profile: {k7_prof_ms:.3f} ms of device time in {k7_prof_n} "
          f"launches, {k7_prof_ms / max(k7_prof_n, 1):.4f} ms a launch (before: "
          f"{BEFORE['K7 profile']})", flush=True)
    lat_tmp.cleanup()

    # ---- phase 10: K6 and K7 times on phase 8's batch, and what sets K6's ----
    n_pts, lb = x_batch.shape[0], spec.n_big
    # K7 as the main path calls it, on autograd's transposed view, and on a
    # level-major copy of it (the copy timed apart)
    g_dense_v, g_train_v = autograd_view(g_dense, n_small), autograd_view(g_train, n_small)
    g_train_c = g_train_v.contiguous()
    grad_buf = torch.zeros((lb, spec.t_big, 2), device=dev)
    ms = {"K6": cuda_ms(lambda: hl.lattice_encode_forward(x_batch, table, spec), 20)}
    for name, g_up in (("dense", g_dense_v), ("train", g_train_v),
                       ("train level-major", g_train_c)):
        ms[f"K7 {name}"] = cuda_ms(lambda: hl.lattice_encode_backward(
            x_batch, g_up, spec, grad_table=grad_buf), 20)
    zero_ms = cuda_ms(lambda: torch.zeros((lb, spec.t_big, 2), device=dev), 20)
    gcopy_ms = cuda_ms(lambda: g_train_v.contiguous(), 20)
    # the split encode's assembly: the one copy that joins the small and
    # big levels
    small = torch.zeros((n_pts, 2 * n_small), device=dev)
    big = torch.empty((lb, n_pts, 2), device=dev)
    asm_ms = cuda_ms(lambda: hl.assemble_split(small, big), 20)
    del small, big
    # K7 and its variants (tools/lattice_probe.py: the replaced kernel, the
    # tile without the merge, tiles of 64 and 256 points) by events and
    # device time, on the same gradients
    k7_probe = lattice_probe.probe_backward(x_batch, spec, {
        "train": g_train_v, "dense": g_dense_v, "train level-major": g_train_c})
    del g_train_c
    with torch.no_grad():
        k6_plain_ms = cuda_ms(lambda: hl.lattice_encode_plain_levels(x_batch, table, spec), 5)
    tp = table.clone().requires_grad_(True)
    out_g = hl.lattice_encode_plain(x_batch, tp, spec)
    k7_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_dense, retain_graph=True), 5)
    del out_g, tp
    # the sort the lattice path no longer runs: the base keys and K5 on them
    keys, iota = hl.lattice_sort_inputs(x_batch, spec)
    keys_ms = cuda_ms(lambda: hl.lattice_sort_inputs(x_batch, spec), 20)
    k5_ms = cuda_ms(lambda: sk.bitonic_sort(keys, iota, key_bits=bits), 20)
    del keys, iota
    probe_ms = lattice_probe.probe(x_batch, table, spec)
    # what this batch's data needs: the distinct big-table entries its
    # corners touch (K6), and those of the points with a nonzero gradient
    cidx, _ = hl.corner_indices_weights(x_batch, spec)                 # [Lb, N, 8]
    cidx = cidx + torch.arange(lb, device=dev)[:, None, None] * spec.t_big
    touched = int(cidx.unique().numel())
    live = (g_train != 0).any(-1)
    live_pts = int(live.sum())
    touched_live = int(cidx[:, live].unique().numel())
    del cidx
    # the encode's own bytes: x01 and the [Lb, N, 2] output (K6) or upstream
    # gradient (K7) once, each touched entry read once (K6) or read and
    # written once (K7's body adds into the gradient)
    x_bytes, io_bytes = n_pts * 12, n_pts * lb * 8
    bounds = {
        "K6": bound_of(x_bytes + io_bytes + touched * 8, n_pts * lb * K6_FLOPS),
        "K7": bound_of(x_bytes + io_bytes + touched * 16, n_pts * lb * K7_FLOPS),
        "K7 train": bound_of(x_bytes + io_bytes + touched_live * 16, live_pts * lb * K7_FLOPS),
    }
    print(f"[phase 10] train batch: {n_pts} points x {lb} big levels, {touched} distinct "
          f"big-table entries touched ({touched_live} by the {live_pts} points with a "
          f"gradient)", flush=True)
    print(f"[phase 10] K6, point order, level-major output: {ms['K6']:.4f} ms (before: "
          f"{BEFORE['K6']}; plain {k6_plain_ms:.3f} ms, bound {bounds['K6'][0]:.4f} ms by "
          f"{bounds['K6'][1]}); K7 body on the dense gradient {ms['K7 dense']:.4f} ms (before: "
          f"{BEFORE['K7 dense']}; plain backward {k7_plain_ms:.3f} ms, bound "
          f"{bounds['K7'][0]:.4f} ms by {bounds['K7'][1]}), on the train gradient "
          f"{ms['K7 train']:.4f} ms (before: {BEFORE['K7 train']}; bound "
          f"{bounds['K7 train'][0]:.4f} ms), on a level-major copy of the train gradient "
          f"{ms['K7 train level-major']:.4f} ms plus the copy's {gcopy_ms:.4f} ms; zero-fill "
          f"{zero_ms:.4f} ms; split assembly {asm_ms:.4f} ms", flush=True)
    print("[phase 10] K6 probe (flnerf_tpu_torch/tools/lattice_probe.py) on this batch: " +
          "; ".join(f"{k} {v:.4f} ms" for k, v in probe_ms.items()), flush=True)
    print("[phase 10] K7 probe (flnerf_tpu_torch/tools/lattice_probe.py) on this batch, ms by "
          "events / device ms: " + "; ".join(f"{k} {ev:.4f} / {dt:.4f}"
                                             for k, (ev, dt) in k7_probe.items()), flush=True)
    for gname in ("train", "dense", "train level-major"):
        print(f"[phase 10] finding, K7, {lattice_probe.finding_backward(k7_probe, gname)}",
              flush=True)
    sorted_fwd = keys_ms + k5_ms + probe_ms["sorted order, [l, p] store"]
    print(f"[phase 10] finding: {lattice_probe.finding(probe_ms)}; the sort it would need: "
          f"base keys {keys_ms:.4f} ms + K5 {k5_ms:.4f} ms, so a sorted forward takes "
          f"{sorted_fwd:.4f} ms against {ms['K6']:.4f} ms in point order: "
          f"{'sorted' if sorted_fwd < ms['K6'] else 'point'} order is faster; launches per "
          f"train step K5 {launches['K5'] / steps:.4f}, K6 {launches['K6'] / steps:.4f}, "
          f"K7 {launches['K7'] / steps:.4f}", flush=True)

    # K3 and K4 on the small levels (phase 7's measure, on this batch)
    from flnerf_tpu_torch.tools import hash_probe
    ms_small = hash_probe.probe(x_batch, table_small, small_spec,
                                {"train": g_small, "dense": g_small_dense})
    with torch.no_grad():
        k3s_plain_ms = cuda_ms(lambda: hk.hash_encode_plain(x_batch, table_small, small_spec), 5)
    tp = table_small.clone().requires_grad_(True)
    out_g = hk.hash_encode_plain(x_batch, tp, small_spec)
    k4s_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_small,
                                                       retain_graph=True), 5)
    del out_g, tp
    ls = n_small
    sidx, _ = hk.corner_indices_weights(x_batch, small_spec)
    slvl = torch.arange(ls, device=dev)[:, None] * small_spec.t_cap
    s_touched = int((sidx + slvl).unique().numel())
    s_live = (g_small != 0).any(-1)
    s_live_pts = int(s_live.sum())
    s_touched_live = int((sidx.reshape(ls, n_pts, 8)[:, s_live].reshape(ls, -1)
                          + slvl).unique().numel())
    del sidx
    sb = {"K3": bound_of(n_pts * 12 + n_pts * ls * 8 + s_touched * 8, n_pts * ls * K3_FLOPS),
          "K4 train": bound_of(n_pts * 12 + n_pts * ls * 8 + s_touched_live * 16,
                               s_live_pts * ls * K4_FLOPS),
          "K4 dense": bound_of(n_pts * 12 + n_pts * ls * 8 + s_touched * 16,
                               n_pts * ls * K4_FLOPS)}
    print(f"[phase 10] small levels: {n_pts} points x {ls} levels, {s_touched} distinct "
          f"entries touched ({s_touched_live} by the {s_live_pts} points with a gradient); "
          f"K3 {ms_small['K3'][0]:.4f} ms by events, "
          f"{ms_small['K3'][1]:.4f} device (plain {k3s_plain_ms:.3f} ms, bound "
          f"{sb['K3'][0]:.4f} ms by {sb['K3'][1]}); K4 body on the train gradient's columns in "
          f"place {ms_small['K4 train'][0]:.4f} ms by events, {ms_small['K4 train'][1]:.4f} "
          f"device (plain backward {k4s_plain_ms:.3f} ms, bound {sb['K4 train'][0]:.4f} ms by "
          f"{sb['K4 train'][1]}), on a dense gradient's columns {ms_small['K4 dense'][0]:.4f} "
          f"ms by events, {ms_small['K4 dense'][1]:.4f} device (bound "
          f"{sb['K4 dense'][0]:.4f} ms by {sb['K4 dense'][1]})", flush=True)
    print_probe("phase 10", "the 2^19 small levels", ms_small, ("train", "dense"))

    src = "flnerf_tpu_torch/ops/csrc/hash_lattice.cu"
    phase9 = dict(launches, K1=vk.FWD_LAUNCHES, K2=vk.BWD_LAUNCHES)
    return res["psnr"], k5_err, phase9, [
        {"name": "lattice_encode_forward (K6)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_lattice.py:415", "launches": launches["K6"],
         "max_abs_err": k6_err, "ms": ms["K6"], "plain_ms": k6_plain_ms,
         "bound_ms": bounds["K6"][0], "bound_by": bounds["K6"][1], "library_ms": None},
        {"name": "lattice_encode_backward (K7)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_lattice.py:502", "launches": launches["K7"],
         "max_abs_err": k7_err, "ms": ms["K7 dense"], "plain_ms": k7_plain_ms,
         "bound_ms": bounds["K7"][0], "bound_by": bounds["K7"][1], "library_ms": None},
    ]


def three_clusters(gen, dev):
    """SLAB_POINTS points: a bulk in z < 0.15 and three tiny z-clusters of
    CLUSTER_POINTS (tests/test_hash_sorted.py:180 at this scale), whose
    keys share sorted blocks of a dense level; the TPU engine gives zeros
    for the middle cluster's corners outside its head and tail slabs."""
    import torch
    x = torch.rand((SLAB_POINTS, 3), generator=gen, device=dev)
    nf = SLAB_POINTS - 3 * CLUSTER_POINTS
    x[:nf, 2] *= 0.15
    for k, z in enumerate((0.40, 0.82, 0.95)):
        sl = slice(nf + k * CLUSTER_POINTS, nf + (k + 1) * CLUSTER_POINTS)
        x[sl, 2] = z + 0.001 * x[sl, 2]
    return x


def sorted_phases(dev, to_dev, other_psnrs=None, lattice_k5_err=0):
    """Phases 11-13, the hash-NGP path at 2^19 on the sorted engine (K3, K4,
    K5, K8, K9).  ``other_psnrs`` names the other NGP paths' test PSNRs, to
    print beside this one's; ``lattice_k5_err`` is K5's largest key error
    on phase 8's keys.  Returns the K5, K5', K8 and K9 rows of the kernels
    line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.ops import hash_kernel as hk
    from flnerf_tpu_torch.ops import hash_lattice as hl
    from flnerf_tpu_torch.ops import hash_sorted as hs
    from flnerf_tpu_torch.ops import sort_kernel as sk
    from flnerf_tpu_torch.ops import voxel_kernel as vk

    # ---- phase 11: K5 on the engine's pairs, K8 and K9 against their plain versions ----
    tmp_dir = tempfile.TemporaryDirectory()
    trainer, sampler, n_test, hwf = ngp_setup(tmp_dir.name, SORTED_FLAGS)
    spec = trainer.field.spec
    bspec = hs._big_packed_spec(spec)
    lb = spec.n_big
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)    # steps 1-256
    x_batch, g_seen = next_batch_encode(trainer, sampler, to_dev, "hash_encode_split")
    table = trainer.field.table_big.detach().clone()
    g_train_view = g_seen[:, 2 * spec.n_small:]       # what SortedEncode's backward receives
    g_train = g_train_view.contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    inputs = {"train batch": x_batch, "refresh chunk": refresh_chunk(trainer, gen),
              "two z-slabs": two_slabs(gen, dev), "three z-clusters": three_clusters(gen, dev)}
    print(f"[phase 11] split spec: {spec.n_small} small levels (t_cap {spec.small.t_cap}), "
          f"{lb} big levels (sizes {spec.big.sizes.tolist()}, hashed "
          f"{spec.big.use_hash.astype(int).tolist()}), big table {tuple(table.shape)} = "
          f"{table.numel() * 4 / 1e6:.1f} MB; {hs.POINT_CAP} points a chunk", flush=True)

    pairs = {}
    bits = sk.key_bits_for(spec.t_cap_big)
    k5_err = 0
    for name, xx in inputs.items():
        unsorted = hs.sort_inputs(xx, spec)
        keys, pay = unsorted[..., 0].contiguous(), unsorted[..., 1].contiguous()
        want = sk.bitonic_sort_plain(keys, pay)           # torch.sort(stable=True), a gather
        for kb in (bits, sk.KEY_BITS):
            got = sk.sort_pairs_(unsorted.clone(), kb)
            torch.cuda.synchronize()
            wrong = [int((got[..., i] != want[i]).sum()) for i in (0, 1)]
            print(f"[phase 11] K5 ({kb} key bits) on the {name}'s pairs "
                  f"{tuple(unsorted.shape)}: {wrong[0]} keys and {wrong[1]} payloads differ "
                  f"from the stable sort", flush=True)
            check(wrong == [0, 0], f"K5 ({kb} bits) differs from the stable sort ({name})")
            k5_err = max(k5_err, int((got[..., 0].long() - want[0].long()).abs().max()))
        check(torch.equal(hs.sorted_pairs(xx, spec), got), f"sorted_pairs differs ({name})")
        pairs[name] = (unsorted, got)
    del keys, pay, want

    k8_err = k9_err = 0.0
    for name, xx in inputs.items():
        with torch.no_grad():
            out_k = hs.sorted_encode_forward(xx, table, spec, pairs[name][1])
            out_p = hk.hash_encode_plain(xx, table, bspec)
        torch.cuda.synchronize()
        err, scale = float((out_k - out_p).abs().max()), float(out_p.abs().max())
        print(f"[phase 11] K8 on the {name} {tuple(xx.shape)}: max_err {err:.3e} "
              f"(largest output {scale:.4e})", flush=True)
        check(bool(torch.isfinite(out_k).all()), f"K8 output not finite ({name})")
        check(scale > 0 and err <= 1e-6 * scale,
              f"K8 differs from the plain version by {err} > 1e-6 * {scale} ({name})")
        k8_err = max(k8_err, err)
    del out_k, out_p
    grads = [("train batch", "train gradient", g_train)] + [
        (name, "dense gradient", torch.randn((xx.shape[0], 2 * lb), generator=gen, device=dev))
        for name, xx in inputs.items()] + [
        (name, "zero gradient", torch.zeros((xx.shape[0], 2 * lb), device=dev))
        for name, xx in inputs.items()]
    for name, what, g_up in grads:
        xx = inputs[name]
        tp = table.clone().requires_grad_(True)
        (grad_p,) = torch.autograd.grad(hk.hash_encode_plain(xx, tp, bspec), [tp], g_up)
        scale = float(grad_p.abs().max())
        live = float((g_up != 0).any(-1).float().mean())
        # K9 needs no pairs: both grid shapes, with and without the warp merge
        for shape, lm in (("level fastest", False), ("level-major", True)):
            for merge in (True, False):
                grad_k = hs.sorted_encode_backward(xx, g_up, spec, level_major=lm, merge=merge)
                torch.cuda.synchronize()
                err = float((grad_k - grad_p).abs().max())
                print(f"[phase 11] K9 ({shape}, merge {merge}) on the {name}, {what} (nonzero "
                      f"at {live:.4f} of the points): max_err {err:.3e} (largest entry "
                      f"{scale:.4e})", flush=True)
                # a zero gradient (the train gradient on a plateau) must give exactly zero
                check((scale > 0 or what != "dense gradient") and err <= 1e-4 * scale,
                      f"K9 ({shape}, merge {merge}) differs from the plain version by {err} > "
                      f"1e-4 * {scale} ({name}, {what})")
                k9_err = max(k9_err, err)
    g_dense = grads[1][2]
    del grad_k, grad_p, tp, grads

    # ---- phase 12: the sorted main path, through the CLI on the card ----
    for mod in (hk, hl, hs, sk, vk):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = main_nerf.main(["synthetic", "-O", *SORTED_FLAGS, "--iters", str(NGP_ITERS),
                              "--workspace", tmp])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"K3": hk.HASH_FWD_LAUNCHES, "K4": hk.HASH_BWD_LAUNCHES,
                    "K5": sk.SORT_LAUNCHES, "K8": hs.SORTED_FWD_LAUNCHES,
                    "K9": hs.SORTED_BWD_LAUNCHES}
        others = {"K1": vk.FWD_LAUNCHES, "K2": vk.BWD_LAUNCHES,
                  "K6": hl.LATTICE_FWD_LAUNCHES, "K7": hl.LATTICE_BWD_LAUNCHES}
        with open(os.path.join(tmp, "results.txt")) as f:
            results = f.read().split()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = res["steps"]
    losses = [h["chunk_loss"] for h in res["history"]]
    want_fwd, n_refresh, n_eval = expected_hash_launches(trainer, len(n_test), hwf)
    print(f"[phase 12] launches {launches} (others {others}); steps {steps}, refresh chunks "
          f"{n_refresh}, eval chunks {n_eval}; mean train loss per chunk first "
          f"{losses[0]:.5f} last {losses[-1]:.5f} (min {min(losses):.5f} max "
          f"{max(losses[1:]):.5f} after the first); test PSNR {res['psnr']:.3f} SSIM "
          f"{res['ssim']:.4f}; main {wall:.1f} s; peak memory {peak_gb:.2f} GB (before, when the "
          f"backward kept the sorted pairs: {BEFORE['peak']['sorted']}); results.txt {results}",
          flush=True)
    psnrs = dict(other_psnrs or {})
    psnrs["2^19, xor hash (phase 12, the sorted engine)"] = res["psnr"]
    print("[phase 12] test PSNR after " + str(NGP_ITERS) + " steps: " + "; ".join(
        f"{k} {v:.3f}" for k, v in psnrs.items()), flush=True)
    check(launches["K4"] == launches["K9"] == steps == NGP_ITERS,
          f"K4/K9 launches {launches} != steps {steps}")
    check(launches["K3"] == launches["K5"] == launches["K8"] == want_fwd,
          f"K3/K5/K8 launches {launches} != steps + refresh + eval chunks {want_fwd}")
    check(not any(others.values()), f"the sorted path launched another engine's kernel: "
                                    f"{others}")
    check(all(math.isfinite(v) for v in losses), f"train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")

    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)
    torch.cuda.synchronize()
    win_s = time.time() - t0
    print(f"[phase 12] train rays/s over steps {NGP_WINDOW + 1}-{2 * NGP_WINDOW}: "
          f"{NGP_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({NGP_WINDOW} steps, "
          f"{NGP_WINDOW // trainer.cfg.steps_per_chunk} partial refreshes, {win_s:.3f} s); "
          f"loss {trainer.history[-1]['loss']:.5f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=NGP_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 12] profiled sorted-engine fit of {NGP_PROFILE_STEPS} steps: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%), "
          f"{dev_ms / NGP_PROFILE_STEPS:.3f} ms of device time a step (before: "
          f"{BEFORE['sorted step']}); top kernels by device time:")
    for e in dev_events[:14] + [e for e in dev_events[14:]
                                if "hash_" in e.key or "sorted" in e.key or "radix" in e.key]:
        print(f"[phase 12]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    del trainer, sampler
    tmp_dir.cleanup()

    # ---- phase 13: K5, K8 and K9 times on phase 11's batch ----
    n_pts = x_batch.shape[0]
    unsorted, spairs = pairs["train batch"]
    keys, pay = unsorted[..., 0].contiguous(), unsorted[..., 1].contiguous()
    # K5 on unsorted pairs every time: restored from the unsorted copy before
    # every sort, the restore timed on its own and taken off
    work = torch.empty_like(unsorted)
    restore_ms = cuda_ms(lambda: work.copy_(unsorted), 10)
    k5_ms = cuda_ms(lambda: sk.sort_pairs_(work.copy_(unsorted), bits), 10) - restore_ms
    k5_31_ms = cuda_ms(lambda: sk.sort_pairs_(work.copy_(unsorted)), 10) - restore_ms
    k5_plain_ms = cuda_ms(lambda: sk.bitonic_sort_plain(keys, pay), 5)
    k5_lib_ms = cuda_ms(lambda: torch.sort(keys, dim=-1, stable=True), 5)
    k5_lib_unstable_ms = cuda_ms(lambda: torch.sort(keys, dim=-1), 5)
    k5_cfg = sk.sort_config(unsorted.shape[1], bits)
    prep_ms = cuda_ms(lambda: hs.sort_inputs(x_batch, spec), 10)
    del work
    out_buf = torch.zeros((n_pts, 2 * lb), device=dev)
    grad_buf = torch.zeros((lb, spec.t_cap_big, 2), device=dev)
    ms = {}
    # K8 as the main path calls it (out=None: no zero-fill), on the train
    # batch (336 rows) and on phase 11's refresh chunk (56 rows)
    x_ref, ref_pairs = inputs["refresh chunk"], pairs["refresh chunk"][1]
    active = hs.forward_active_clusters(hs.POINT_CAP)
    ms["K8 sorted"] = cuda_ms(lambda: hs.sorted_encode_forward(x_batch, table, spec, spairs), 20)
    ms["K8 refresh"] = cuda_ms(lambda: hs.sorted_encode_forward(x_ref, table, spec, ref_pairs),
                               20)
    ms["K8 point"] = cuda_ms(lambda: hs.sorted_encode_forward(x_batch, table, spec, unsorted), 20)
    ms["K8 sorted add"] = cuda_ms(lambda: hs.sorted_encode_forward(
        x_batch, table, spec, spairs, out=out_buf), 20)
    for shape, lm in (("level fastest", False), ("level-major", True)):
        for merge in (True, False):
            for gname, g_up in (("dense", g_dense), ("train", g_train)):
                ms[f"K9 {shape} {gname} merge {merge}"] = cuda_ms(
                    lambda: hs.sorted_encode_backward(x_batch, g_up, spec, grad_table=grad_buf,
                                                      level_major=lm, merge=merge), 20)
    main_k9 = "level-major" if hs.BWD_LEVEL_MAJOR else "level fastest"
    # as the main path calls it: on the columns of the whole gradient, in
    # place; and the copy that reading them in place saves
    ms["K9 train in place"] = cuda_ms(lambda: hs.sorted_encode_backward(
        x_batch, g_train_view, spec, grad_table=grad_buf), 20)
    ms["gradient copy"] = cuda_ms(lambda: g_train_view.contiguous(), 20)
    grad_zero_ms = cuda_ms(lambda: torch.zeros((lb, spec.t_cap_big, 2), device=dev), 20)
    del out_buf, grad_buf
    with torch.no_grad():
        k8_plain_ms = cuda_ms(lambda: hk.hash_encode_plain(x_batch, table, bspec), 5)
    tp = table.clone().requires_grad_(True)
    out_g = hk.hash_encode_plain(x_batch, tp, bspec)
    k9_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_dense, retain_graph=True), 5)
    del out_g, tp
    # what this batch's data needs: the distinct big-table entries its
    # corners touch (K8), and those of the points with a nonzero gradient
    ck = hs.corner_keys(x_batch, spec).long()
    ck = ck + torch.arange(lb, device=dev)[:, None, None] * spec.t_cap_big
    touched = int(ck.unique().numel())
    live = (g_train != 0).any(-1)
    live_pts = int(live.sum())
    touched_live = int(ck[:, live].unique().numel())
    del ck
    # the encode's own bytes: x01 and the [N, Lb*2] output (K8) or upstream
    # gradient (K9) once, each touched entry read once (K8) or read and
    # written once (K9's body adds into the gradient); K8's pairs are the
    # sorted design's own and are not counted
    x_bytes, io_bytes = n_pts * 12, n_pts * lb * 8
    bounds = {
        "K5": bound_of(2 * spairs.numel() * 4, 0),
        "K8": bound_of(x_bytes + io_bytes + touched * 8, n_pts * lb * K8_FLOPS),
        "K9": bound_of(x_bytes + io_bytes + touched * 16, n_pts * lb * K9_FLOPS),
        "K9 train": bound_of(x_bytes + io_bytes + touched_live * 16, live_pts * lb * K9_FLOPS),
    }
    print(f"[phase 13] train batch: {n_pts} points x {lb} big levels in "
          f"{spairs.shape[0] // lb} chunks, pairs {tuple(spairs.shape)} = "
          f"{spairs.numel() * 4 / 1e6:.1f} MB; {touched} distinct big-table entries touched "
          f"({touched_live} by the {live_pts} points with a gradient)", flush=True)
    print(f"[phase 13] K5 on the engine's unsorted pairs ({k5_cfg}): {k5_ms:.4f} ms "
          f"({k5_31_ms:.4f} ms on 31 bits; restore {restore_ms:.4f} ms taken off; plain "
          f"{k5_plain_ms:.4f} ms; torch.sort of the keys stable {k5_lib_ms:.4f} ms, unstable "
          f"{k5_lib_unstable_ms:.4f} ms; bound {bounds['K5'][0]:.4f} ms by {bounds['K5'][1]}); "
          f"keys, payloads and padding (sort_inputs) {prep_ms:.4f} ms", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[phase 13] K8, clusters of {hs.CLUSTER} CTAs with "
          f"{-(-hs.POINT_CAP // hs.CLUSTER) * 64} B of shared memory each, {active} clusters "
          f"resident ({active * hs.CLUSTER / n_sm:.2f} CTAs a SM of {n_sm}): train batch "
          f"({spairs.shape[0]} rows, {spairs.shape[0] * hs.CLUSTER} CTAs) sorted order "
          f"{ms['K8 sorted']:.4f} ms, point order {ms['K8 point']:.4f} ms, adding into a given "
          f"output {ms['K8 sorted add']:.4f} ms; refresh chunk ({ref_pairs.shape[0]} rows, "
          f"{ref_pairs.shape[0] * hs.CLUSTER} CTAs) {ms['K8 refresh']:.4f} ms (plain "
          f"{k8_plain_ms:.3f} ms, bound {bounds['K8'][0]:.4f} ms by {bounds['K8'][1]})",
          flush=True)
    for gname, bname in (("dense", "K9"), ("train", "K9 train")):
        print(f"[phase 13] K9 body on the {gname} gradient (before, over the sorted pairs: "
              f"{BEFORE[f'K9 {gname}']}): " + "; ".join(
                  f"{shape} {ms[f'K9 {shape} {gname} merge True']:.4f} ms with the warp merge, "
                  f"{ms[f'K9 {shape} {gname} merge False']:.4f} ms without"
                  for shape in ("level fastest", "level-major")) +
              f" (bound {bounds[bname][0]:.4f} ms by {bounds[bname][1]})", flush=True)
    print(f"[phase 13] K9 plain backward {k9_plain_ms:.3f} ms; gradient zero-fill "
          f"{grad_zero_ms:.4f} ms; the main path's K9: {main_k9}, with the merge, "
          f"{ms['K9 train in place']:.4f} ms on the train gradient's columns in place (a copy "
          f"of them: {ms['gradient copy']:.4f} ms); launches per "
          f"train step K5 {launches['K5'] / steps:.4f}, K8 {launches['K8'] / steps:.4f}, K9 "
          f"{launches['K9'] / steps:.4f}", flush=True)

    src = "flnerf_tpu_torch/ops/csrc/hash_sorted.cu"
    ssrc = "flnerf_tpu_torch/ops/csrc/radix_sort.cu"
    # K5 runs on the sorted path alone: its rows take that path's launches
    # and its time on that path's pairs
    k5 = {"route": "cuda", "source": ssrc, "launches": launches["K5"],
          "max_abs_err": float(max(k5_err, lattice_k5_err)), "ms": k5_ms,
          "plain_ms": k5_plain_ms, "bound_ms": bounds["K5"][0], "bound_by": bounds["K5"][1],
          "library_ms": k5_lib_ms}
    return [
        dict(name="bitonic_sort (K5, a radix sort)",
             replaces="flnerf_tpu/ops/sort_pallas.py:118", **k5),
        # K5' is K5's kernel: the variant chose a TPU schedule only, so the
        # row repeats K5's launches and times
        dict(name="bitonic_sort variant=1 (K5', the same kernel as K5)",
             replaces="flnerf_tpu/ops/sort_pallas.py:61", **k5),
        {"name": "sorted_encode_forward (K8)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_sorted.py:261", "launches": launches["K8"],
         "max_abs_err": k8_err, "ms": ms["K8 sorted"], "plain_ms": k8_plain_ms,
         "bound_ms": bounds["K8"][0], "bound_by": bounds["K8"][1], "library_ms": None},
        {"name": "sorted_encode_backward (K9)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/hash_sorted.py:340", "launches": launches["K9"],
         "max_abs_err": k9_err, "ms": ms[f"K9 {main_k9} dense merge True"],
         "plain_ms": k9_plain_ms, "bound_ms": bounds["K9"][0], "bound_by": bounds["K9"][1],
         "library_ms": None},
    ]


def _time_png_decode(tmp_dir):
    """Seconds data/png.py takes to read an 800 x 800 RGBA PNG whose rows
    all use the Paeth filter, the slowest to undo (any bytes are a valid
    filtered row); its first rows are checked against a plain pixel-by-pixel
    undo."""
    import struct
    import zlib

    from flnerf_tpu_torch.data import png

    h = w = 800
    rows = np.random.default_rng(0).integers(0, 256, (h, w * 4 + 1), dtype=np.uint8)
    rows[:, 0] = 4
    path = os.path.join(tmp_dir, "paeth.png")
    with open(path, "wb") as f:
        f.write(png._SIGNATURE)
        f.write(png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(png._chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(png._chunk(b"IEND", b""))
    t0 = time.perf_counter()
    img = png.imread(path)
    seconds = time.perf_counter() - t0
    n_check = 8
    want = np.zeros((n_check + 1, (w + 1) * 4), np.int32)   # a zero row above, a zero pixel left
    for y in range(n_check):
        for x in range(w):
            a, b, c = want[y + 1, 4 * x:4 * x + 4], want[y, 4 * x + 4:4 * x + 8], \
                want[y, 4 * x:4 * x + 4]
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            want[y + 1, 4 * x + 4:4 * x + 8] = (rows[y, 1 + 4 * x:5 + 4 * x] + pred) & 0xFF
    check(np.array_equal(img.reshape(h, w * 4)[:n_check], want[1:, 4:]),
          "phase 14c: data/png.py misread the Paeth-filtered PNG")
    return seconds


def nerf_phases(dev, keep_tar=None):
    """Phase 14: quadtree NeRF (cli/run_nerf.py) on the card.  Its path
    launches none of the port's kernels (no TPU kernel lies on it in the
    reference: a dot_general chain and jnp sampling and compositing).
    ``keep_tar``: where to copy the trained run's last .tar (phase 18c)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flnerf_tpu_torch.cli import run_nerf
    from flnerf_tpu_torch.data.synthetic import write_blender_fixture
    from flnerf_tpu_torch.rays.camera import get_rays_np
    from flnerf_tpu_torch.rays.quadtree import RayBudgeter
    from flnerf_tpu_torch.render.renderer import render_rays

    tmp = tempfile.TemporaryDirectory()
    fixture = write_blender_fixture(os.path.join(tmp.name, "fixture"), H=96, n_train=12,
                                    n_val=2, n_test=2)
    base = ["--expname", "fixture_nerf", "--basedir", os.path.join(tmp.name, "logs"),
            "--datadir", fixture, "--device", str(dev), *NERF_FLAGS]
    args = run_nerf.config_parser().parse_args(base)
    images, poses, _, hwf, K, i_train, _, i_test, near, far = run_nerf.load_dataset(args)
    H, W, focal = hwf

    # ---- phase 14a: render_rays at full width, card against CPU ----
    trainer = run_nerf.build(args, near, far, focal)     # weights drawn on the CPU from the seed
    rcfg = trainer.render_cfg._replace(perturb=0.0)
    origins = np.stack([get_rays_np(H, W, K, p[:3, :4])[0] for p in poses[i_train]], 0)
    dirs = np.stack([get_rays_np(H, W, K, p[:3, :4])[1] for p in poses[i_train]], 0)
    epoch = RayBudgeter(images[i_train], origins, dirs, init_level=args.init_level,
                        seed=args.seed).gen_rays()
    n = args.N_rand
    batch = [np.ascontiguousarray(a[:n]) for a in (epoch.origins, epoch.dirs, epoch.rgb)]
    batch.append(batch[1] / np.linalg.norm(batch[1], axis=-1, keepdims=True))
    got = {}
    for where in (str(dev), "cpu"):
        coarse, fine = (copy.deepcopy(m).to(where) for m in (trainer.coarse, trainer.fine))
        o, d, rgb, vd = (torch.as_tensor(a, device=where) for a in batch)
        t0 = time.time()
        out = render_rays(coarse, fine, o, d, rcfg, viewdirs=vd)
        loss = (torch.sum((out["rgb"] - rgb) ** 2) + torch.sum((out["rgb0"] - rgb) ** 2)) / (3 * n)
        loss.backward()
        torch.cuda.synchronize()
        got[where] = ({k: out[k].detach().cpu() for k in ("rgb", "rgb0", "acc")},
                      {f"{tag}.{k}": p.grad.cpu() for tag, net in (("coarse", coarse),
                                                                  ("fine", fine))
                       for k, p in net.named_parameters()},
                      time.time() - t0)
        del out, loss, coarse, fine
    (out_c, g_c, s_c), (out_h, g_h, s_h) = got[str(dev)], got["cpu"]
    rgb_err = max(float((out_c[k] - out_h[k]).abs().max()) for k in ("rgb", "rgb0"))
    grad_err = {k: float((g_c[k] - g_h[k]).norm() / g_h[k].norm().clamp(min=1e-30))
                for k in g_h}
    worst = max(grad_err, key=grad_err.get)
    print(f"[phase 14a] render_rays on {n} rays x ({rcfg.n_samples} + "
          f"{rcfg.n_samples + rcfg.n_importance}) samples, D{args.netdepth} W{args.netwidth}, "
          f"bf16 operands, perturb 0: card {s_c:.2f} s (first call), CPU {s_h:.2f} s; rgb and "
          f"rgb0 max abs err {rgb_err:.3e} (tolerance {NERF_RGB_TOL}); acc max abs err "
          f"{float((out_c['acc'] - out_h['acc']).abs().max()):.3e}; weight gradients, norm-wise "
          f"error per parameter: median {float(np.median(list(grad_err.values()))):.3e}, "
          f"largest {grad_err[worst]:.3e} ({worst}; tolerance {NERF_GRAD_TOL})", flush=True)
    check(rgb_err <= NERF_RGB_TOL, f"phase 14a: rgb differs card/CPU by {rgb_err}")
    check(grad_err[worst] <= NERF_GRAD_TOL,
          f"phase 14a: gradient {worst} differs card/CPU by {grad_err[worst]}")
    del trainer, got, g_c, g_h

    # ---- phase 14b: the main path, through the CLI on the card ----
    reset_counts()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run_nerf.main(base + ["--no_reload"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    files = sorted(os.listdir(res["run_dir"]))
    tars = [f for f in files if f.endswith(".tar")]
    pkls = [f for f in files if f.startswith("treeDivide_")]
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "GOLDEN_runs.json")) as f:
        golden = json.load(f)["fixture_nerf"]
    print(f"[phase 14b] run_nerf.main {' '.join(NERF_FLAGS)} (D{args.netdepth} W{args.netwidth}, "
          f"N_samples {args.N_samples}, {args.compute_dtype}): kernel launches {launches}; "
          f"{len(tars)} .tar, {len(pkls)} .pkl; main {wall:.1f} s", flush=True)
    for h in hist:
        print(f"[phase 14b]   epoch {h['epoch']}: {h['rays']} rays, train PSNR "
              f"{h['train_psnr']:.3f}, {h['n_leaves']} leaves after it, {h['epoch_s']:.2f} s")
    print(f"[phase 14b] test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f} LPIPS {res['lpips']} "
          f"(band {NERF_BAND_DB} dB); the JAX package's result in GOLDEN_runs.json fixture_nerf: "
          f"{golden['psnr']:.2f} dB, SSIM {golden['ssim']:.4f}", flush=True)
    check(all(v == 0 for v in launches.values()), f"the NeRF path launched a kernel: {launches}")
    check(len(tars) == len(pkls) == args.n_epoch, f"phase 14b: checkpoints {files}")
    check(len(hist) == args.n_epoch and all(math.isfinite(h["train_psnr"]) for h in hist),
          f"phase 14b: history {hist}")
    check(hist[-1]["train_psnr"] > hist[0]["train_psnr"], "phase 14b: train PSNR did not rise")
    check(max(h["n_leaves"] for h in hist) > len(i_train) * 4 ** (args.init_level - 1),
          "phase 14b: no leaf was subdivided")
    check(res["psnr"] >= NERF_BAND_DB, f"phase 14b: test PSNR {res['psnr']} < {NERF_BAND_DB}")
    res_r = run_nerf.main(base + ["--render_only", "--render_test"])
    print(f"[phase 14b] --render_only --render_test from {tars[-1]}: PSNR {res_r['psnr']:.4f} "
          f"(trained run {res['psnr']:.4f}, difference "
          f"{abs(res_r['psnr'] - res['psnr']):.2e} dB)", flush=True)
    check(abs(res_r["psnr"] - res["psnr"]) <= 1e-3, "phase 14b: the resumed render differs")

    # ---- phase 14c: speed and profile ----
    rays = sum(h["rays"] for h in hist)
    steps = sum(-(-h["rays"] // n) for h in hist)
    train_s = sum(h["epoch_s"] for h in hist)
    print(f"[phase 14c] train rays/s over the {len(hist)} epochs (precrop apart): "
          f"{rays / train_s:.1f} ({rays} rays, {steps} steps of <= {n} rays, "
          f"{train_s:.2f} s); precrop {res['precrop_rays']} rays in {res['precrop_s']:.2f} s "
          f"({res['precrop_rays'] / res['precrop_s']:.1f} rays/s); epochs "
          f"{[round(h['epoch_s'], 3) for h in hist]} s; peak memory {peak_gb:.2f} GB "
          f"({peak_gb - base_gb:.2f} GB above the {base_gb:.2f} GB held before the run)",
          flush=True)
    trainer = run_nerf.build(args, near, far, focal)
    layers = [mod for mod in trainer.coarse.modules() if isinstance(mod, torch.nn.Linear)]
    flops_pt = 2 * sum(mod.in_features * mod.out_features for mod in layers)
    pts = n * (args.N_samples + args.N_samples + args.N_importance)
    step_flops = 3 * flops_pt * pts
    prof_epoch = type(epoch)(*(a[:NERF_PROFILE_STEPS * n] if isinstance(a, np.ndarray) else a
                               for a in epoch))
    warm = type(epoch)(*(a[:2 * n] if isinstance(a, np.ndarray) else a for a in epoch))
    trainer.run_epoch_rays(warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.run_epoch_rays(prof_epoch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    check(math.isfinite(dev_ms) and dev_ms > 0, "phase 14c: the profile saw no device time")
    least_ms = step_flops / F32_FLOPS * 1e3
    least_tc_ms = step_flops / BF16_TC_FLOPS * 1e3
    print(f"[phase 14c] profiled {NERF_PROFILE_STEPS} steps of {n} rays: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%), "
          f"{dev_ms / NERF_PROFILE_STEPS:.2f} ms of device time a step; f32 FLOPs a step "
          f"{step_flops:.4e} = 3 (forward + backward) x {flops_pt} a point forward (2 x the "
          f"multiply-adds of the {len(layers)} layers' shapes) x {pts} points ({n} rays x "
          f"({args.N_samples} + {args.N_samples + args.N_importance})); least time at "
          f"{F32_FLOPS / 1e12:.0f} TFLOP/s: {least_ms:.2f} ms a step, "
          f"{100 * least_ms * NERF_PROFILE_STEPS / dev_ms:.1f}% of the device time; at "
          f"{BF16_TC_FLOPS / 1e12:.0f} TFLOP/s (bf16 tensor cores, which take the bf16 "
          f"operands exactly): {least_tc_ms:.3f} ms a step, "
          f"{100 * least_tc_ms * NERF_PROFILE_STEPS / dev_ms:.2f}% of the device time; top "
          f"operations by device time:", flush=True)
    for e in dev_events[:14]:
        print(f"[phase 14c]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    print(f"[phase 14c] host decode of an 800 x 800 RGBA PNG, every row Paeth-filtered, "
          f"through data/png.py: {_time_png_decode(tmp.name):.3f} s", flush=True)
    if keep_tar is not None:
        shutil.copy(os.path.join(res["run_dir"], tars[-1]), keep_tar)
    del trainer, prof
    tmp.cleanup()
    return res["psnr"]


def _nerfpp_levels(trainer, batch, draws):
    """Both cascade levels of one step with no optimizer step: the
    level-0 loss's backward, then level 1 sampled from level 0's detached
    weights and its backward (``NerfPPTrainer._step`` without Adam).
    Returns (per-level rgb on the host, {parameter: gradient on the host})."""
    import torch

    from flnerf_tpu_torch.models.nerfpp import intersect_sphere

    o, d, rgb, img = (torch.as_tensor(a, device=trainer.device) for a in batch)
    fg_z_max, _ = intersect_sphere(o, d)
    prev, rgbs = None, []
    for m, net in enumerate(trainer.nets):
        net.zero_grad(set_to_none=True)
        out = trainer._render_level(m, o, d, fg_z_max, prev, draws[m])
        trainer._loss(net, out["rgb"], rgb, img).backward()
        prev = {k: v.detach() for k, v in out.items()}
        rgbs.append(prev["rgb"].cpu())
    grads = {f"level{m}.{k}": p.grad.cpu() for m, net in enumerate(trainer.nets)
             for k, p in net.named_parameters()}
    return rgbs, grads


def nerfpp_phases(dev):
    """Phase 15: quadtree NeRF++ (cli/ddp_train_nerf.py) on the card.  Its
    path launches none of the port's kernels (no TPU kernel lies on it in
    the reference: dot_general chains and jnp sampling and compositing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flnerf_tpu_torch.cli import ddp_train_nerf
    from flnerf_tpu_torch.data.nerfpp_dataset import write_nerfpp_fixture
    from flnerf_tpu_torch.rays.quadtree import RayBudgeter, RayEpoch

    tmp = tempfile.TemporaryDirectory()
    write_nerfpp_fixture(os.path.join(tmp.name, "fixture"), H=96, n_train=12, n_test=2)
    root = os.path.dirname(os.path.abspath(__file__))
    base = ["--config", os.path.join(root, NERFPP_CONFIG), "--datadir", tmp.name, "--scene",
            "fixture", "--basedir", os.path.join(tmp.name, "logs"), "--testskip", "1"]
    args = ddp_train_nerf.config_parser().parse_args(base)
    train, test = ddp_train_nerf.load_splits(args)
    n_train = train["images"].shape[0]
    samples = [int(x) for x in args.cascade_samples.split(",")][:args.cascade_level]

    # ---- phase 15a: both cascade levels at full width, card against CPU ----
    budgeter = RayBudgeter(train["images"], train["origins"], train["dirs"],
                           init_level=args.init_level, seed=args.seed)
    epoch = budgeter.gen_rays()
    n = args.batch_size
    batch = [np.ascontiguousarray(a[:n]) for a in (epoch.origins, epoch.dirs, epoch.rgb)]
    batch.append(epoch.img[:n].astype(np.int64))
    rng = np.random.default_rng(args.seed)
    draws = [tuple(rng.random((n, s), dtype=np.float32) for _ in range(2)) for s in samples]
    cpu_args = ddp_train_nerf.config_parser().parse_args(base + ["--device", "cpu"])
    got = {}
    for where, a in ((str(dev), args), ("cpu", cpu_args)):
        trainer = ddp_train_nerf.build(a, n_train)      # weights drawn on the CPU from the seed
        t0 = time.time()
        got[where] = _nerfpp_levels(trainer, batch, draws) + (time.time() - t0,)
        del trainer
    (rgb_c, g_c, s_c), (rgb_h, g_h, s_h) = got[str(dev)], got["cpu"]
    rgb_err = max(float((a - b).abs().max()) for a, b in zip(rgb_c, rgb_h))
    grad_err = {k: float((g_c[k] - g_h[k]).norm() / g_h[k].norm().clamp(min=1e-30))
                for k in g_h}
    worst = max(grad_err, key=grad_err.get)
    print(f"[phase 15a] both cascade levels on {n} rays x ({samples[0]} + "
          f"{samples[0] + samples[1]}) fg and bg samples, D{args.netdepth} W{args.netwidth}, "
          f"{args.compute_dtype} operands, the same uniforms: card {s_c:.2f} s (first call), "
          f"CPU {s_h:.2f} s; rgb max abs err per level "
          f"{[float((a - b).abs().max()) for a, b in zip(rgb_c, rgb_h)]} (tolerance "
          f"{NERF_RGB_TOL}); weight gradients, norm-wise error per parameter: median "
          f"{float(np.median(list(grad_err.values()))):.3e}, largest {grad_err[worst]:.3e} "
          f"({worst}; tolerance {NERF_GRAD_TOL})", flush=True)
    check(rgb_err <= NERF_RGB_TOL, f"phase 15a: rgb differs card/CPU by {rgb_err}")
    check(grad_err[worst] <= NERF_GRAD_TOL,
          f"phase 15a: gradient {worst} differs card/CPU by {grad_err[worst]}")
    del got, g_c, g_h

    # ---- phase 15b: the main path, through the CLI on the card ----
    reset_counts()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = ddp_train_nerf.main(base)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    files = sorted(os.listdir(res["run_dir"]))
    pths = [f for f in files if f.endswith(".pth")]
    pkls = [f for f in files if f.startswith("treeDivide_")]
    with open(os.path.join(root, "GOLDEN_runs.json")) as f:
        golden = json.load(f)["fixture_nerfpp"]
    print(f"[phase 15b] ddp_train_nerf.main --config {NERFPP_CONFIG} on the 96-px fixture at "
          f"resolution_level {args.resolution_level} ({train['H']}x{train['W']}, {n_train} "
          f"train and {test['images'].shape[0]} test views; D{args.netdepth} "
          f"W{args.netwidth}, cascade {args.cascade_samples}, batch {n}, "
          f"{args.compute_dtype}): kernel launches {launches}; {len(pths)} .pth, "
          f"{len(pkls)} .pkl; main {wall:.1f} s", flush=True)
    for h in hist:
        print(f"[phase 15b]   epoch {h['epoch']}: {h['rays']} rays, train PSNR "
              f"{h['train_psnr']:.3f}, {h['n_leaves']} leaves after it, {h['epoch_s']:.2f} s")
    print(f"[phase 15b] test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f}; the JAX "
          f"package's result in GOLDEN_runs.json fixture_nerfpp (3 epochs, cascade 64,64, "
          f"batch 2880; no band gates it, ROADMAP R2): {golden['psnr']:.2f} dB, SSIM "
          f"{golden['ssim']:.4f}", flush=True)
    check(all(v == 0 for v in launches.values()), f"the NeRF++ path launched a kernel: {launches}")
    check(len(pths) == len(pkls) == args.n_epoch, f"phase 15b: checkpoints {files}")
    check(len(hist) == args.n_epoch and all(math.isfinite(h["train_psnr"]) for h in hist),
          f"phase 15b: history {hist}")
    check(hist[-1]["train_psnr"] > hist[0]["train_psnr"], "phase 15b: train PSNR did not rise")
    check(max(h["n_leaves"] for h in hist) > n_train * 4 ** (args.init_level - 1),
          "phase 15b: no leaf was subdivided")
    check(math.isfinite(res["psnr"]) and math.isfinite(res["ssim"]),
          f"phase 15b: test PSNR {res['psnr']}, SSIM {res['ssim']}")
    trainer = ddp_train_nerf.build(args, n_train)
    epoch_r = ddp_train_nerf.load_checkpoint(os.path.join(res["run_dir"], pths[-1]), trainer)
    psnr_r, _ = trainer.eval_images(test["poses"], test["images"], test["H"], test["W"],
                                    test["intrinsics"][0], chunk=args.chunk_size)
    print(f"[phase 15b] {pths[-1]} (epoch {epoch_r}) reloaded into a fresh trainer: test PSNR "
          f"{psnr_r:.4f} (trained run {res['psnr']:.4f}, difference "
          f"{abs(psnr_r - res['psnr']):.2e} dB)", flush=True)
    check(abs(psnr_r - res["psnr"]) <= 1e-3, "phase 15b: the reloaded checkpoint renders "
          "another test PSNR")

    # ---- phase 15c: speed and profile ----
    rays = sum(h["rays"] for h in hist)
    steps = sum(-(-h["rays"] // n) for h in hist)
    train_s = sum(h["epoch_s"] for h in hist)
    print(f"[phase 15c] train rays/s over the {len(hist)} epochs: {rays / train_s:.1f} "
          f"({rays} rays, {steps} steps of <= {n} rays, {train_s:.2f} s); epochs "
          f"{[round(h['epoch_s'], 3) for h in hist]} s; peak memory {peak_gb:.2f} GB "
          f"({peak_gb - base_gb:.2f} GB above the {base_gb:.2f} GB held before the run)",
          flush=True)
    macs = {net: sum(mod.in_features * mod.out_features
                     for mod in getattr(trainer.nets[0], net).modules()
                     if isinstance(mod, torch.nn.Linear)) for net in ("fg", "bg")}
    pts = n * (samples[0] + samples[0] + samples[1])      # per MLP, both levels
    step_flops = 3 * 2 * pts * (macs["fg"] + macs["bg"])
    # two epochs' rays, so the profile takes 16 whole steps
    more = budgeter.gen_rays()
    epoch = RayEpoch(*(np.concatenate([a, b]) if isinstance(a, np.ndarray) else a
                       for a, b in zip(epoch, more)))
    prof_epoch = RayEpoch(*(a[:NERFPP_PROFILE_STEPS * n] if isinstance(a, np.ndarray) else a
                            for a in epoch))
    warm = RayEpoch(*(a[:2 * n] if isinstance(a, np.ndarray) else a for a in epoch))
    trainer.run_epoch_rays(warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.run_epoch_rays(prof_epoch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    check(math.isfinite(dev_ms) and dev_ms > 0, "phase 15c: the profile saw no device time")
    least_ms = step_flops / F32_FLOPS * 1e3
    least_tc_ms = step_flops / BF16_TC_FLOPS * 1e3
    print(f"[phase 15c] profiled {NERFPP_PROFILE_STEPS} steps of {n} rays: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%), "
          f"{dev_ms / NERFPP_PROFILE_STEPS:.2f} ms of device time a step; f32 FLOPs a step "
          f"{step_flops:.4e} = 3 (forward + backward) x 2 x ({macs['fg']} fg + {macs['bg']} bg "
          f"multiply-adds a sample) x {pts} samples of each MLP ({n} rays x ({samples[0]} + "
          f"{samples[0] + samples[1]})); least time at {F32_FLOPS / 1e12:.0f} TFLOP/s: "
          f"{least_ms:.2f} ms a step, {100 * least_ms * NERFPP_PROFILE_STEPS / dev_ms:.1f}% of "
          f"the device time; at {BF16_TC_FLOPS / 1e12:.0f} TFLOP/s (bf16 tensor cores, which "
          f"take the bf16 operands exactly): {least_tc_ms:.3f} ms a step, "
          f"{100 * least_tc_ms * NERFPP_PROFILE_STEPS / dev_ms:.2f}% of the device time; top "
          f"operations by device time:", flush=True)
    for e in dev_events[:14]:
        print(f"[phase 15c]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    del trainer, prof
    tmp.cleanup()
    return res["psnr"]


def _field_outputs(field, marched, d, gt, rcfg, times=None):
    """The field on the marched samples (at the rays' ``times`` for a
    D-NeRF field): (the kept samples' sigma and colour feature and the rays'
    rgb on the host, {parameter: gradient of the mean squared error on the
    host}, zero for a parameter the loss does not reach)."""
    import torch

    from flnerf_tpu_torch.render.ngp import render_marched

    with torch.no_grad():
        sigma, feat = (field.density(marched[2]) if times is None else
                       field.density(marched[2], times[:, None].expand(marched[0].shape)))
    out = render_marched(field, marched, d, rcfg, times=times)
    loss = torch.mean((out["rgb"] - gt) ** 2)
    named = list(field.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return ({"sigma": sigma.cpu(), "feat": feat.cpu(), "rgb": out["rgb"].detach().cpu()},
            {n: (torch.zeros_like(p) if g is None else g).cpu()
             for (n, p), g in zip(named, grads)})


def field_errors(out_c, g_c, out_h, g_h):
    """Card (c) against CPU (h) outputs of ``_field_outputs``: ({sigma: max
    relative, feat: max absolute over the largest entry, rgb: max absolute,
    grad: the largest norm-wise}, {parameter: norm-wise error}, the
    parameter of the largest)."""
    errs = {"sigma": float(((out_c["sigma"] - out_h["sigma"]).abs()
                            / out_h["sigma"].abs().clamp(min=1e-6)).max()),
            "feat": float((out_c["feat"] - out_h["feat"]).abs().max()
                          / out_h["feat"].abs().max()),
            "rgb": float((out_c["rgb"] - out_h["rgb"]).abs().max())}
    grad_err = {k: float((g_c[k] - g_h[k]).norm() / g_h[k].norm().clamp(min=1e-30))
                for k in g_h}
    gworst = max(grad_err, key=grad_err.get)
    errs["grad"] = grad_err[gworst]
    return errs, grad_err, gworst


def tensorf_phases(dev):
    """Phase 16: TensoRF (VM, CP) and CCNeRF (cli/main_tensorf.py,
    cli/main_ccnerf.py) on the card.  Their path launches none of the port's
    kernels (no TPU kernel lies on it in the reference: jnp gathers for the
    factor samples, dot_general for the basis and the colour MLP)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flnerf_tpu_torch.cli import main_ccnerf, main_tensorf
    from flnerf_tpu_torch.cli.main_nerf import load_ngp_dataset
    from flnerf_tpu_torch.models.tensorf import TensoRFConfig, TensoRFField
    from flnerf_tpu_torch.models.tensorf_variants import (
        CCNeRFConfig,
        CCNeRFField,
        CPConfig,
        CPField,
    )
    from flnerf_tpu_torch.render.ngp import march
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler, NGPTrainer

    t_phase = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    base = ["synthetic", "-O"]
    args = main_tensorf.parse_o(main_tensorf.make_tensorf_parser(), base)
    images, poses, hwf, K, i_split = load_ngp_dataset(args)
    i_train = i_split[0]
    rcfg, tcfg = main_tensorf.render_train_configs(args)
    bf16 = torch.bfloat16

    # ---- phase 16a: the fields at full width, card against CPU ----
    vm = TensoRFField(TensoRFConfig(resolution=(args.resolution1,) * 3, bound=args.bound), bf16,
                      torch.Generator().manual_seed(0))
    cp = CPField(CPConfig(resolution=(args.resolution0,) * 3, bound=args.bound), bf16,
                 torch.Generator().manual_seed(1))
    cc_args = main_ccnerf.make_ccnerf_parser().parse_args(base)
    cc = CCNeRFField(CCNeRFConfig(resolution=(cc_args.resolution0,) * 3,
                                  rank_vec_density=tuple(cc_args.rank_vec_density),
                                  rank_mat_density=tuple(cc_args.rank_mat_density),
                                  rank_vec=tuple(cc_args.rank_vec),
                                  rank_mat=tuple(cc_args.rank_mat), bound=args.bound), bf16,
                     torch.Generator().manual_seed(2))
    trainer = NGPTrainer(copy.deepcopy(vm), rcfg, tcfg, device=dev)
    trainer.refresh_occupancy(partial=False)
    o, d, rgb, _, _ = NGPSampler(images[i_train], poses[i_train], K, tcfg,
                                 seed=args.seed).sample_chunk(1, tcfg.batch_rays)
    noise = np.random.default_rng(0).random((tcfg.batch_rays, rcfg.n_candidates),
                                            dtype=np.float32)
    with torch.no_grad():
        marched = march(trainer.occ, torch.as_tensor(o[0], device=dev),
                        torch.as_tensor(d[0], device=dev), rcfg, perturb=True,
                        noise=torch.as_tensor(noise, device=dev))
    occupied = float(marched[1].float().mean())
    del trainer
    n_rays, n_keep = tcfg.batch_rays, rcfg.n_keep
    cases = [("VM", vm, None), ("CP", cp, None)] + [
        (f"CCNeRF level {k}", cc, k) for k in range(cc.cfg.K, 0, -1)]
    worst = {"sigma": 0.0, "feat": 0.0, "rgb": 0.0, "grad": 0.0}
    for name, field, level in cases:
        got, secs = {}, {}
        for where in (str(dev), "cpu"):
            f = copy.deepcopy(field).to(where)
            if level is not None:
                f.level = level
            t0 = time.time()
            got[where] = _field_outputs(
                f, [m.to(where) for m in marched], torch.as_tensor(d[0], device=where),
                torch.as_tensor(rgb[0], device=where), rcfg)
            if where != "cpu":
                torch.cuda.synchronize()
            secs[where] = time.time() - t0
            del f
        (out_c, g_c), (out_h, g_h) = got[str(dev)], got["cpu"]
        errs, grad_err, gworst = field_errors(out_c, g_c, out_h, g_h)
        worst = {k: max(worst[k], errs[k]) for k in worst}
        print(f"[phase 16a] {name} ({field.cfg.resolution[0]}^3, bf16) on {n_rays} rays x "
              f"{n_keep} kept samples ({100 * occupied:.1f}% occupied): card "
              f"{secs[str(dev)]:.2f} s "
              f"(first call), CPU {secs['cpu']:.2f} s; sigma max relative err "
              f"{errs['sigma']:.3e}, colour feature max abs err {errs['feat']:.3e} of its "
              f"largest entry, ray rgb max abs err {errs['rgb']:.3e} (tolerance {NERF_RGB_TOL} "
              f"each); parameter gradients norm-wise: median "
              f"{float(np.median(list(grad_err.values()))):.3e}, largest {errs['grad']:.3e} "
              f"({gworst}; tolerance {NERF_GRAD_TOL})", flush=True)
        for k in ("sigma", "feat", "rgb"):
            check(errs[k] <= NERF_RGB_TOL, f"phase 16a: {name} {k} differs card/CPU by {errs[k]}")
        check(errs["grad"] <= NERF_GRAD_TOL,
              f"phase 16a: {name} gradient {gworst} differs card/CPU by {errs['grad']}")
        del got, g_c, g_h
    del vm, cp, cc

    # ---- phase 16b: the VM main path, through the CLI on the card ----
    with open(os.path.join(root, "BENCH_time_to_psnr_tensorf.json")) as f:
        jax_psnr = json.load(f)["samples"][-1]["psnr"]
    ws = os.path.join(tmp.name, "vm")
    vm_argv = base + ["--iters", str(TENSORF_ITERS), "--upsample_model_steps",
                      *map(str, TENSORF_UPSAMPLE), "--workspace", ws]
    reset_counts()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = main_tensorf.main(vm_argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = launch_counts()
    cfg = res["field_cfg"]
    hist = res["history"]
    res_ratio = float(np.prod(cfg.resolution)) / args.resolution1 ** 3
    print(f"[phase 16b] main_tensorf.main {' '.join(vm_argv[:-2])} (VM, ranks "
          f"{cfg.sigma_rank}/{cfg.color_rank}, feature {cfg.color_feat_dim}, colour MLP "
          f"{cfg.num_layers} x {cfg.hidden_dim}, {tcfg.batch_rays} rays x {rcfg.n_candidates} "
          f"candidates / {rcfg.n_keep} kept, grid {rcfg.grid_size}): kernel launches {counts}; "
          f"main {wall:.1f} s; the last resolution {cfg.resolution} ({100 * res_ratio:.2f}% "
          f"of {args.resolution1}^3), aabb {cfg.aabb}; segments "
          f"{[(sg['steps'], round(sg['wall_s'], 2)) for sg in res['segments']]}", flush=True)
    print(f"[phase 16b]   chunk losses (mean over each chunk): first {hist[0]['chunk_loss']:.5f}, "
          f"last {hist[-1]['chunk_loss']:.5f}; every 8th "
          f"{[round(h['chunk_loss'], 5) for h in hist[::8]]}")
    print(f"[phase 16b] test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f}; the JAX package's "
          f"BENCH_time_to_psnr_tensorf.json (its last sample; no band gates it, ROADMAP R1): "
          f"{jax_psnr:.3f} dB", flush=True)
    check(all(v == 0 for v in counts.values()), f"the TensoRF path launched a kernel: {counts}")
    check(res["steps"] == TENSORF_ITERS and len(res["segments"]) == len(TENSORF_UPSAMPLE) + 1,
          f"phase 16b: {res['steps']} steps, segments {res['segments']}")
    check(abs(res_ratio - 1.0) <= TENSORF_RES_TOL,
          f"phase 16b: the last resolution {cfg.resolution} is not within 5% of 300^3")
    check(all(math.isfinite(h["chunk_loss"]) for h in hist), f"phase 16b: history {hist}")
    check(hist[-1]["chunk_loss"] < hist[0]["chunk_loss"], "phase 16b: the loss did not fall")
    check(math.isfinite(res["psnr"]) and math.isfinite(res["ssim"]),
          f"phase 16b: test PSNR {res['psnr']}, SSIM {res['ssim']}")
    trainer = NGPTrainer(TensoRFField(cfg, bf16), rcfg, tcfg, device=dev)
    trainer.load_checkpoint(ws)
    H, W, _ = hwf
    i_test = i_split[2]
    psnr_r, _ = trainer.eval_images(poses[i_test], images[i_test], H, W, K,
                                    chunk=args.max_ray_batch)
    print(f"[phase 16b] the checkpoint (step {trainer.step}) loaded into a fresh trainer: test "
          f"PSNR {psnr_r:.4f} (trained run {res['psnr']:.4f}, difference "
          f"{abs(psnr_r - res['psnr']):.2e} dB)", flush=True)
    check(abs(psnr_r - res["psnr"]) <= 1e-3, "phase 16b: the reloaded checkpoint renders "
          "another test PSNR")
    seg = res["segments"][-1]
    rays_s = seg["steps"] * tcfg.batch_rays / seg["wall_s"]

    ws_cp = os.path.join(tmp.name, "cp")
    reset_counts()
    res_cp = main_tensorf.main(base + ["--cp", "--iters", str(TENSORF_CP_ITERS),
                                       "--workspace", ws_cp])
    counts = launch_counts()
    hist_cp = res_cp["history"]
    t_cp = NGPTrainer(CPField(res_cp["field_cfg"], bf16), rcfg, tcfg, device=dev)
    t_cp.load_checkpoint(ws_cp)
    psnr_cp, _ = t_cp.eval_images(poses[i_test], images[i_test], H, W, K,
                                  chunk=args.max_ray_batch)
    del t_cp
    cp_rays_s = res_cp["segments"][0]["steps"] * tcfg.batch_rays / res_cp["segments"][0]["wall_s"]
    print(f"[phase 16b] --cp --iters {TENSORF_CP_ITERS} (ranks "
          f"{res_cp['field_cfg'].sigma_rank}/{res_cp['field_cfg'].color_rank} at "
          f"{res_cp['field_cfg'].resolution[0]}^3): kernel launches {counts}; chunk losses first "
          f"{hist_cp[0]['chunk_loss']:.5f}, last {hist_cp[-1]['chunk_loss']:.5f}; test PSNR "
          f"{res_cp['psnr']:.3f} SSIM {res_cp['ssim']:.4f}, reloaded {psnr_cp:.4f}; "
          f"{cp_rays_s:.1f} train rays/s", flush=True)
    check(all(v == 0 for v in counts.values()), f"the CP path launched a kernel: {counts}")
    check(hist_cp[-1]["chunk_loss"] < hist_cp[0]["chunk_loss"],
          "phase 16b: the CP loss did not fall")
    check(math.isfinite(res_cp["psnr"]) and abs(psnr_cp - res_cp["psnr"]) <= 1e-3,
          f"phase 16b: CP test PSNR {res_cp['psnr']}, reloaded {psnr_cp}")

    # ---- phase 16c: CCNeRF through the CLI: three levels, then two objects ----
    ws_cc = os.path.join(tmp.name, "cc")
    reset_counts()
    t0 = time.time()
    levels = main_ccnerf.main(base + ["--iters", str(TENSORF_CCNERF_ITERS), "--workspace", ws_cc])
    cc_s = time.time() - t0
    obj = os.path.join(ws_cc, "object.pkl")
    ws_co = os.path.join(tmp.name, "compose")
    composed = main_ccnerf.main(base + ["--compose", obj, obj, "--offsets", "0,0,0", "0.6,0,0",
                                        "--iters", "0", "--workspace", ws_co])
    counts = launch_counts()
    pngs = sorted(f for f in os.listdir(ws_co) if f.endswith(".png"))
    print(f"[phase 16c] main_ccnerf.main synthetic -O --iters {TENSORF_CCNERF_ITERS} (ranks "
          f"{cc_args.rank_vec_density}/{cc_args.rank_mat_density}, {cc_args.resolution0}^3, "
          f"colour MLP 3 x 64; {cc_s:.1f} s): test PSNR by level {levels}; --compose of two "
          f"copies at offsets 0,0,0 and 0.6,0,0: {composed['n_objects']} objects, PSNR "
          f"{composed['psnr']:.3f}, PNGs {pngs}; kernel launches {counts}", flush=True)
    check(all(v == 0 for v in counts.values()), f"the CCNeRF path launched a kernel: {counts}")
    check(len(levels) == 3 and all(math.isfinite(p) for p in levels.values()),
          f"phase 16c: level PSNRs {levels}")
    check(os.path.exists(obj), "phase 16c: no object.pkl")
    check(composed["n_objects"] == 2 and math.isfinite(composed["psnr"])
          and len(pngs) == len(i_test), f"phase 16c: composed {composed}, PNGs {pngs}")

    # ---- phase 16d: speed, the gather's backward, a profile, the bound ----
    n = tcfg.batch_rays * rcfg.n_keep
    gen = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((args.resolution1 ** 2, 48), device=dev, requires_grad=True)
    idx = torch.randint(0, args.resolution1 ** 2, (4 * n,), generator=gen, device=dev)
    g_out = torch.randn((4 * n, 48), generator=gen, device=dev)
    gather_ms = {}
    for name, fn in (("index_select / index_add_", lambda: torch.index_select(table, 0, idx)),
                     ("advanced indexing / index_put_", lambda: table[idx])):
        with torch.no_grad():
            fwd = cuda_ms(fn, 10)
        both = cuda_ms(lambda: torch.autograd.grad(fn(), [table], g_out), 10)
        gather_ms[name] = (fwd, both - fwd)
    sampler = NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed + 1)
    trainer.fit(sampler, verbose=False, n_steps=TENSORF_PROFILE_STEPS)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=TENSORF_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    check(math.isfinite(dev_ms) and dev_ms > 0, "phase 16d: the profile saw no device time")
    ranks = sum(cfg.sigma_rank) + sum(cfg.color_rank)
    # a sample reads 4 corners of axis i's plane and 2 of its line at axis
    # i's sigma and colour ranks, once (forward), and adds as many into the
    # gradients
    gather_bytes = n * (4 + 2) * ranks * 4
    in_dim = cfg.color_feat_dim * 5 + 15
    macs = (in_dim * cfg.hidden_dim + cfg.hidden_dim ** 2 * (cfg.num_layers - 2)
            + cfg.hidden_dim * 3 + sum(cfg.color_rank) * cfg.color_feat_dim)
    step_flops = 3 * 2 * n * macs
    bytes_ms = 2 * gather_bytes / HBM_BYTES_PER_S * 1e3
    f32_ms, tc_ms = step_flops / F32_FLOPS * 1e3, step_flops / BF16_TC_FLOPS * 1e3
    step_ms = dev_ms / TENSORF_PROFILE_STEPS
    print(f"[phase 16d] VM train rays/s over the {seg['steps']} steps after the last upsample "
          f"(refreshes included): {rays_s:.1f}; peak memory {peak_gb:.2f} GB "
          f"({peak_gb - base_gb:.2f} "
          f"GB above the {base_gb:.2f} GB held before phase 16b)", flush=True)
    for name, (fwd, bwd) in gather_ms.items():
        print(f"[phase 16d] gather of {4 * n} rows of a [{args.resolution1 ** 2}, 48] f32 table "
              f"(one corner set of the colour planes' step) by {name}: forward {fwd:.4f} ms, "
              f"backward {bwd:.4f} ms")
    print(f"[phase 16d] profiled {TENSORF_PROFILE_STEPS} steps at {cfg.resolution}: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%), "
          f"{step_ms:.3f} ms of device time a step; bound a step: factor bytes "
          f"{gather_bytes / 1e9:.3f} GB gathered + as many added ({n} samples x (4 plane + 2 line "
          f"corners) x {ranks} ranks over the 3 axes x 4 B) -> {bytes_ms:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; MLP "
          f"and basis FLOPs {step_flops:.4e} ({macs} multiply-adds a sample, x 2 x 3) -> "
          f"{f32_ms:.3f} ms at {F32_FLOPS / 1e12:.0f} TFLOP/s, {tc_ms:.4f} ms at "
          f"{BF16_TC_FLOPS / 1e12:.0f} TFLOP/s; bound {max(bytes_ms, f32_ms):.3f} ms by "
          f"{'bytes' if bytes_ms >= f32_ms else 'operations'} "
          f"({100 * max(bytes_ms, f32_ms) / step_ms:.1f}% "
          f"of the device time a step); top operations by device time:", flush=True)
    for e in dev_events[:14]:
        print(f"[phase 16d]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    print(f"[phase 16] {time.time() - t_phase:.1f} s", flush=True)
    del trainer, prof
    tmp.cleanup()


def _profile_fit(trainer, sampler, n_steps):
    """A profiled fit of ``n_steps`` (after a warm one): (device ms, wall ms,
    device events by self time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.fit(sampler, verbose=False, n_steps=n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=n_steps)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    return sum(e.self_device_time_total for e in events) / 1e3, wall_ms, events


def _capture_encode(module, name, fn):
    """Run ``fn()`` with ``module.name`` (an encode) wrapped: returns (fn's
    result, the first call's (x01, output))."""
    inner = getattr(module, name)
    seen = {}

    def capture(x01, table, spec):
        out = inner(x01, table, spec)
        seen.setdefault("call", (x01.detach().contiguous(), out))
        return out

    setattr(module, name, capture)
    try:
        res = fn()
    finally:
        setattr(module, name, inner)
    return res, seen["call"]


def dnerf_phases(dev, to_dev, ngp_psnr):
    """Phase 17: D-NeRF (cli/main_dnerf.py) on the time path of the NGP
    trainer.  The deform and basis fields encode through K3/K4 (the packed
    2^15 spec main_dnerf always builds, R6); hyper's 4-D grid through the
    plain encode.  Returns {run: launch counts} of 17b's three runs."""
    import torch

    from flnerf_tpu_torch.cli import main_dnerf
    from flnerf_tpu_torch.cli.main_nerf import load_ngp_dataset
    from flnerf_tpu_torch.models import dnerf, hash_ngp
    from flnerf_tpu_torch.models.dnerf import DNeRFConfig, make_dnerf_variant_field
    from flnerf_tpu_torch.models.hash_ngp import NGPConfig
    from flnerf_tpu_torch.ops import hash_kernel as hk
    from flnerf_tpu_torch.render.ngp import march, ngp_render_rays
    from flnerf_tpu_torch.tools import hyper_probe
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler, NGPTrainer

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    bf16 = torch.bfloat16
    args = main_dnerf.parse_args(["synthetic", "-O", "--iters", str(DNERF_ITERS)])
    images, poses, hwf, K, (i_train, _, i_test) = load_ngp_dataset(args)
    H, W, _ = hwf
    times = main_dnerf.frame_times(images.shape[0])
    cfgs = {v: DNeRFConfig(ngp=NGPConfig(bound=args.bound), variant=v) for v in DNERF_VARIANTS}

    # ---- phase 17a: the three fields at full width, card against CPU ----
    trainer = main_dnerf.build(args)
    trainer.refresh_occupancy(partial=False)
    sampler = NGPSampler(images[i_train], poses[i_train], K, trainer.cfg, seed=args.seed,
                         times=times[i_train])
    o, d, rgb, _, _, tt = copy.deepcopy(sampler).sample_chunk(1, trainer.cfg.batch_rays)
    noise = np.random.default_rng(0).random((trainer.cfg.batch_rays, trainer.rcfg.n_candidates),
                                            dtype=np.float32)
    rcfg = trainer.rcfg
    with torch.no_grad():
        marched = march(trainer.occ, to_dev(o[0]), to_dev(d[0]), rcfg, perturb=True,
                        noise=to_dev(noise))
    occupied = float(marched[1].float().mean())
    worst = {"sigma": 0.0, "feat": 0.0, "rgb": 0.0, "grad": 0.0}
    encode = hash_ngp.hash_encode
    encodes = {"kernel": encode,
               # the CPU as the card computes: the encoding's points take no
               # gradient (K3/K4, as the reference's TPU kernel; R7)
               "points cut": lambda x01, table, spec_: encode(x01.detach(), table, spec_),
               # the plain version on the card: they do (the reference's CPU)
               "plain": hk.hash_encode_plain}
    for i, v in enumerate(DNERF_VARIANTS):
        field = make_dnerf_variant_field(cfgs[v], bf16, torch.Generator().manual_seed(i))
        runs = [(str(dev), "kernel"), ("cpu", "points cut" if v == "deform" else "kernel")]
        runs += [(str(dev), "plain")] if v == "deform" else []
        got, secs = {}, {}
        for where, how in runs:
            f = copy.deepcopy(field).to(where)
            hash_ngp.hash_encode = encodes[how]
            t0 = time.time()
            try:
                got[where, how] = _field_outputs(
                    f, [m_.to(where) for m_ in marched], torch.as_tensor(d[0], device=where),
                    torch.as_tensor(rgb[0], device=where), rcfg,
                    times=torch.as_tensor(tt[0], device=where))
            finally:
                hash_ngp.hash_encode = encode
            if where != "cpu":
                torch.cuda.synchronize()
            secs[where] = secs.get(where, time.time() - t0)
            del f
        (out_c, g_c), (out_h, g_h) = got[runs[0]], got[runs[1]]
        errs, grad_err, gworst = field_errors(out_c, g_c, out_h, g_h)
        if v == "deform":
            # geo is held on the canonical points the card used: one bf16
            # rounding that the deform MLP's other sum order flips moves a
            # point ~1e-4, and the fresh field's geo (~4e-5) by a few % at
            # the fine levels (a float64 sum order on the CPU alone moves it
            # 2%); the deform MLP's dx is held apart
            chain_geo = errs["feat"]
            fc, fh = copy.deepcopy(field).to(dev), copy.deepcopy(field)
            tk = to_dev(tt[0])[:, None, None].expand(*marched[0].shape, 1)
            with torch.no_grad():
                dx_c = fc.deform(marched[2], tk)
                dx_h = fh.deform(marched[2].cpu(), tk.cpu())
                x_can = torch.clamp(marched[2] + dx_c, -args.bound, args.bound)
                geo_c = fc.canonical.density(x_can)[1].cpu()
                geo_h = fh.canonical.density(x_can.cpu())[1]
            errs["feat"] = float((geo_c - geo_h).abs().max() / geo_h.abs().max())
            errs["dx"] = float((dx_c.cpu() - dx_h).abs().max() / dx_h.abs().max())
            print(f"[phase 17a] deform: dx (the deform MLP) max abs err {errs['dx']:.3e} of its "
                  f"largest entry (tolerance {NERF_GRAD_TOL}); geo through the whole chain "
                  f"{chain_geo:.3e} of its largest entry, on the card's canonical points "
                  f"{errs['feat']:.3e}", flush=True)
            check(errs["dx"] <= NERF_GRAD_TOL, f"phase 17a: dx differs card/CPU by {errs['dx']}")
            del fc, fh, dx_c, dx_h, x_can
        worst = {k: max(worst[k], errs[k]) for k in worst}
        print(f"[phase 17a] {v} (16 x 2^15, bf16) on {trainer.cfg.batch_rays} rays x "
              f"{rcfg.n_keep} kept samples ({100 * occupied:.1f}% occupied) at their frames' "
              f"times: card {secs[str(dev)]:.2f} s (first call), CPU "
              f"{secs['cpu']:.2f} s; sigma max relative err "
              f"{errs['sigma']:.3e}, geo ({out_c['feat'].shape[-1]} wide) max abs err "
              f"{errs['feat']:.3e} of its largest entry, ray rgb max abs err {errs['rgb']:.3e} "
              f"(tolerance {NERF_RGB_TOL} each); parameter gradients norm-wise: median "
              f"{float(np.median(list(grad_err.values()))):.3e}, largest {errs['grad']:.3e} "
              f"({gworst}; tolerance {NERF_GRAD_TOL})", flush=True)
        for k in ("sigma", "feat", "rgb"):
            check(errs[k] <= NERF_RGB_TOL, f"phase 17a: {v} {k} differs card/CPU by {errs[k]}")
        check(errs["grad"] <= NERF_GRAD_TOL,
              f"phase 17a: {v} gradient {gworst} differs card/CPU by {errs['grad']}")
        if v == "deform":
            deform_keys = [k for k in g_c if k.startswith("deform_net")]
            plain = sum(float(got[str(dev), "plain"][1][k].norm()) ** 2
                        for k in deform_keys) ** 0.5
            print(f"[phase 17a] deform net's gradient (R7): through K3/K4 "
                  f"{sum(float(g_c[k].norm()) ** 2 for k in deform_keys) ** 0.5:.3e} (they "
                  f"give the points none, as the reference's TPU kernel does), through the "
                  f"plain encode's point gradient {plain:.3e} (the reference's CPU path)",
                  flush=True)
            check(all(not bool(g_c[k].any()) for k in deform_keys),
                  "phase 17a: the card gave the deform net a gradient")
        # fresh weights render another image at t = 0 and at t = 1
        f = copy.deepcopy(field).to(dev)
        with torch.no_grad():
            rgbs = [ngp_render_rays(f, trainer.occ, to_dev(o[0]), to_dev(d[0]), rcfg,
                                    perturb=False,
                                    times=torch.full((len(o[0]),), tv, device=dev))["rgb"]
                    for tv in (0.0, 1.0)]
        diff = float((rgbs[0] - rgbs[1]).abs().max())
        print(f"[phase 17a] {v}: the render at t = 0 against t = 1 on fresh weights, max "
              f"|rgb difference| {diff:.3e}", flush=True)
        check(diff > 0, f"phase 17a: the {v} render does not depend on the time")
        del got, g_c, g_h, f, field

    # K3 and K4 on the deform field's canonical points x + dx (the trainer's
    # next batch at its times, its train loss's gradient)
    x_can, g_train = next_batch_encode(trainer, sampler, to_dev, "hash_encode")
    spec = trainer.field.canonical.spec
    table = trainer.field.canonical.table.detach().clone()
    gen = torch.Generator(device=dev).manual_seed(17)
    g_dense = torch.randn(g_train.shape, generator=gen, device=dev)
    k3_err, k4_err = hold_hash_kernels(spec, table, [
        ("the deform field's canonical points, the train gradient", x_can,
         g_train.contiguous()),
        ("the deform field's canonical points, a dense gradient", x_can, g_dense),
        ("the deform field's canonical points, a zero gradient", x_can,
         torch.zeros_like(g_dense))], "phase 17a")
    del trainer, marched, x_can, g_train, g_dense

    # ---- phase 17b: the main path, through the CLI on the card ----
    counts_by_run, psnrs = {}, {}
    for v, iters in (("deform", DNERF_ITERS), ("basis", DNERF_VARIANT_ITERS),
                     ("hyper", DNERF_VARIANT_ITERS)):
        ws = os.path.join(tmp.name, v)
        argv = ["synthetic", "-O", "--iters", str(iters), "--variant", v, "--workspace", ws]
        reset_counts()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = main_dnerf.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        counts_by_run[f"17b {v}"] = counts
        tr = res["trainer"]
        losses = [h["chunk_loss"] for h in res["history"]]
        want_k3, n_refresh, n_eval = expected_hash_launches(tr, len(i_test), hwf)
        if v == "hyper":
            want_k3 = 0
        want = {k: 0 for k in counts}
        want.update({"K3": want_k3, "K4": 0 if v == "hyper" else iters})
        print(f"[phase 17b] main_dnerf.main {' '.join(argv[:-2])}: kernel launches {counts} "
              f"(predicted {want}: steps {iters}, refresh chunks {n_refresh}, eval chunks "
              f"{n_eval}); main {wall:.1f} s; peak memory {peak_gb:.2f} GB "
              f"({peak_gb - base_gb:.2f} GB above the {base_gb:.2f} GB held before); mean "
              f"train loss per chunk first {losses[0]:.5f} last {losses[-1]:.5f}; test PSNR "
              f"{res['psnr']:.3f} SSIM {res['ssim']:.4f} (phase 6's NGP at 2^15: "
              f"{ngp_psnr:.3f}; ROADMAP R1)", flush=True)
        check(counts == want, f"phase 17b: {v} launches {counts} != {want}")
        check(res["steps"] == iters and all(math.isfinite(x) for x in losses),
              f"phase 17b: {v} steps {res['steps']}, losses {losses}")
        check(losses[-1] < losses[0], f"phase 17b: the {v} loss did not fall: {losses}")
        check(math.isfinite(res["psnr"]) and math.isfinite(res["ssim"]),
              f"phase 17b: {v} test PSNR {res['psnr']}, SSIM {res['ssim']}")
        # main_dnerf writes no checkpoint (as the reference): save the
        # trainer's and load it into a fresh trainer of a fresh field
        path = tr.save_checkpoint(ws)
        t2 = NGPTrainer(make_dnerf_variant_field(cfgs[v], bf16, device=dev), tr.rcfg, tr.cfg,
                        device=dev)
        t2.load_checkpoint(path)
        psnr_r, _ = t2.eval_images(poses[i_test], images[i_test], H, W, K,
                                   chunk=args.max_ray_batch, times=times[i_test])
        print(f"[phase 17b] {v}: the checkpoint (step {t2.step}) in a fresh trainer: test "
              f"PSNR {psnr_r:.4f} (difference {abs(psnr_r - res['psnr']):.2e} dB)", flush=True)
        check(abs(psnr_r - res["psnr"]) <= 1e-3,
              f"phase 17b: the reloaded {v} checkpoint renders another test PSNR")
        psnrs[v] = res["psnr"]
        del res, tr, t2

    # ---- phase 17c: speed (printed, not gated) ----
    trainer = main_dnerf.build(args)
    sampler = NGPSampler(images[i_train], poses[i_train], K, trainer.cfg, seed=args.seed,
                         times=times[i_train])
    trainer.fit(sampler, verbose=False, n_steps=DNERF_WINDOW)               # steps 1-256
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=DNERF_WINDOW)               # steps 257-512
    torch.cuda.synchronize()
    win_s = time.time() - t0
    dev_ms, wall_ms, events = _profile_fit(trainer, sampler, DNERF_PROFILE_STEPS)
    n = trainer.cfg.batch_rays * trainer.rcfg.n_keep
    canon = trainer.field.canonical
    deform_macs = sum(w.numel() for w in trainer.field.deform_net)
    ngp_macs = sum(w.numel() for w in list(canon.sigma_net) + list(canon.color_net))
    deform_flops, ngp_flops = 3 * 2 * n * deform_macs, 3 * 2 * n * ngp_macs
    table_bytes = 2 * spec.num_levels * spec.t_cap * 2 * 4     # read + gradient
    step_ms = dev_ms / DNERF_PROFILE_STEPS
    print(f"[phase 17c] deform train rays/s over steps {DNERF_WINDOW + 1}-{2 * DNERF_WINDOW}: "
          f"{DNERF_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({win_s:.3f} s, refreshes "
          f"included); profiled {DNERF_PROFILE_STEPS} steps: device busy {dev_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * dev_ms / wall_ms:.1f}%), {step_ms:.3f} ms of device "
          f"time a step", flush=True)
    print(f"[phase 17c] a deform step's bound: the deform MLP {deform_flops:.4e} FLOPs ({n} "
          f"samples x {deform_macs} multiply-adds x 2 x 3) -> "
          f"{deform_flops / F32_FLOPS * 1e3:.3f} ms at {F32_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{deform_flops / BF16_TC_FLOPS * 1e3:.4f} ms at {BF16_TC_FLOPS / 1e12:.0f} TFLOP/s; "
          f"the canonical MLPs {ngp_flops:.4e} FLOPs -> {ngp_flops / F32_FLOPS * 1e3:.3f} ms at "
          f"{F32_FLOPS / 1e12:.0f}; the table {table_bytes / 1e6:.1f} MB read and its gradient "
          f"written -> {table_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; top operations by device time:", flush=True)
    for e in events[:14] + [e for e in events[14:] if "hash_" in e.key]:
        print(f"[phase 17c]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    del trainer, sampler

    hyper_args = main_dnerf.parse_args(["synthetic", "-O", "--iters", str(DNERF_ITERS),
                                        "--variant", "hyper"])
    trainer = main_dnerf.build(hyper_args)
    sampler = NGPSampler(images[i_train], poses[i_train], K, trainer.cfg, seed=args.seed,
                         times=times[i_train])
    trainer.fit(sampler, verbose=False, n_steps=DNERF_PROFILE_STEPS)        # warm
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=DNERF_PROFILE_STEPS)
    torch.cuda.synchronize()
    hyper_ms = (time.time() - t0) * 1e3 / DNERF_PROFILE_STEPS
    hyper_peak = torch.cuda.max_memory_allocated() / 1e9
    drawn = copy.deepcopy(sampler).sample_chunk(1, trainer.cfg.batch_rays)
    with torch.no_grad():
        _, (x4, _) = _capture_encode(dnerf, "hash_encode", lambda: ngp_render_rays(
            trainer.field, trainer.occ, to_dev(drawn[0][0]), to_dev(drawn[1][0]),
            trainer.rcfg, generator=trainer.gen, times=to_dev(drawn[5][0])))
    hp = hyper_probe.probe(x4, trainer.field.table, trainer.field.spec)
    enc_ms = hp["chain"][1]
    print(f"[phase 17c] hyper: {hyper_ms:.2f} ms a train step (host clock over "
          f"{DNERF_PROFILE_STEPS} steps, refresh included); the plain 4-D encode's forward and "
          f"backward (table and points) on one step's {x4.shape[0]} lifted points "
          f"{enc_ms:.2f} ms ({100 * enc_ms / hyper_ms:.1f}% of the step), forward alone "
          f"{hp['chain'][0]:.2f} ms; with the corner weight as torch.prod (its earlier form, "
          f"flnerf_tpu_torch/tools/hyper_probe.py) {hp['prod'][1]:.2f} ms and "
          f"{hp['prod'][0]:.2f} ms (forwards {hp['max_abs_err']:.1e} apart); peak memory "
          f"{hyper_peak:.2f} GB ({hyper_peak - base_gb:.2f} GB above the {base_gb:.2f} GB "
          f"held before)", flush=True)
    check(hp["max_abs_err"] <= 1e-6, "phase 17c: the two 4-D encodes differ")
    print(f"[phase 17] test PSNRs {psnrs}; {time.time() - t_phase:.1f} s", flush=True)
    del trainer, sampler, x4
    tmp.cleanup()
    return counts_by_run, (k3_err, k4_err)


def icosphere(subdiv, radius=0.5):
    """A sphere mesh: an icosahedron subdivided ``subdiv`` times (20 * 4^s
    outward-wound faces), vertices on the sphere."""
    g = (1 + 5 ** 0.5) / 2
    v = [[-1, g, 0], [1, g, 0], [-1, -g, 0], [1, -g, 0], [0, -1, g], [0, 1, g], [0, -1, -g],
         [0, 1, -g], [g, 0, -1], [g, 0, 1], [-g, 0, -1], [-g, 0, 1]]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    v = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdiv):
        mid, nf = {}, []

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                p = v[a] + v[b]
                v.append(p / np.linalg.norm(p))
                mid[k] = len(v) - 1
            return mid[k]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    return (np.asarray(v) * radius).astype(np.float32), np.asarray(f, np.int32)


def sdf_phases(dev, nerf_tar, keep_npz=None):
    """Phase 18: SDF fitting (cli/main_sdf.py) through K3/K4 and mesh export
    (cli/extract_mesh.py, which launches no kernel).  Returns {run: launch
    counts} of 18b's two runs.  ``keep_npz``: where to copy 18c's cli/opt.py
    checkpoint (phase 22c)."""
    import torch

    from flnerf_tpu_torch.cli import extract_mesh, main_sdf, opt
    from flnerf_tpu_torch.core.losses import mape_loss
    from flnerf_tpu_torch.data.mesh_sdf import MeshSDF, SDFMeshDataset
    from flnerf_tpu_torch.models import sdf
    from flnerf_tpu_torch.models.nerf_mlp import make_nerf_mlp
    from flnerf_tpu_torch.core.checkpoint import load_nerf_query_network
    from flnerf_tpu_torch.models.voxel_sh import load_npz
    from flnerf_tpu_torch.ops.marching import save_obj

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    sphere = main_sdf._analytic_oracle("sphere")
    cfg = sdf.SDFConfig()
    gen = torch.Generator(device=dev).manual_seed(18)

    # ---- phase 18a: the SDF field at full width, card against CPU ----
    field = sdf.SDFField(cfg, torch.float32, torch.Generator().manual_seed(0))
    pts, gt = sdf.sample_sdf_batch(np.random.default_rng(0), sphere, SDF_BATCH)
    got = {}
    for where in (str(dev), "cpu"):
        f = copy.deepcopy(field).to(where)
        pred, call = _capture_encode(sdf, "hash_encode", lambda: f(torch.as_tensor(
            pts, device=where)))
        call[1].retain_grad()
        mape_loss(pred, torch.as_tensor(gt, device=where)).backward()
        got[where] = (pred.detach().cpu(), [p.grad.cpu() for p in f.parameters()],
                      call[0], call[1].grad)
    (p_c, g_c, x01, g_enc), (p_h, g_h, _, _) = got[str(dev)], got["cpu"]
    scale = float(p_h.abs().max())
    err = float((p_c - p_h).abs().max())
    gerr = max(float((a - b).norm() / b.norm()) for a, b in zip(g_c, g_h))
    print(f"[phase 18a] SDF field (16 x 2^15, MLP 3 x 64, f32) on {SDF_BATCH} points of "
          f"sample_sdf_batch: sdf max abs err {err:.3e} (largest output {scale:.4e}, "
          f"tolerance 1e-5 of it); parameter gradients norm-wise largest {gerr:.3e} "
          f"(tolerance 1e-4)", flush=True)
    check(err <= 1e-5 * scale, f"phase 18a: sdf differs card/CPU by {err}")
    check(gerr <= 1e-4, f"phase 18a: a gradient differs card/CPU by {gerr} norm-wise")
    table = field.table.detach().to(dev)
    g_dense = torch.randn(g_enc.shape, generator=gen, device=dev)
    k3_err, k4_err = hold_hash_kernels(field.spec, table, [
        ("the SDF batch, the train gradient", x01, g_enc.contiguous()),
        ("the SDF batch, a dense gradient", x01, g_dense),
        ("the SDF batch, a zero gradient", x01, torch.zeros_like(g_dense))], "phase 18a")
    del got, field, f

    # ---- phase 18b: the main path, through the CLI on the card ----
    counts_by_run = {}
    ws = os.path.join(tmp.name, "sphere")
    argv = ["sphere", "--iters", str(SDF_ITERS), "--batch", str(SDF_BATCH), "--mesh_reso",
            str(SDF_MESH_RESO), "--workspace", ws]
    reset_counts()
    t0 = time.time()
    res = main_sdf.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    counts_by_run["18b sphere"] = counts
    mesh_chunks = -(-SDF_MESH_RESO ** 3 // (1 << 16))
    want = {k: 0 for k in counts}
    want.update({"K3": SDF_ITERS + mesh_chunks, "K4": SDF_ITERS})
    losses = res["losses"]
    trainer = res["trainer"]
    pts, gt = sdf.sample_sdf_batch(np.random.default_rng(1), sphere, SDF_BATCH)
    with torch.no_grad():
        mae = float(np.abs(trainer.field(torch.as_tensor(pts, device=dev)).cpu().numpy()
                           - gt).mean())
    verts, tris = res["mesh"]
    radius = float(np.linalg.norm(verts, axis=-1).mean())
    print(f"[phase 18b] main_sdf.main {' '.join(argv[:-2])}: "
          f"kernel launches {counts} (predicted {want}: {SDF_ITERS} steps, {mesh_chunks} mesh "
          f"chunks); main {wall:.1f} s; mape loss first {losses[0]:.5f} last {losses[-1]:.5f}; "
          f"on a fresh batch mean |pred - sdf| {mae:.5f} (gate 0.05); {len(verts)} vertices, "
          f"{len(tris)} triangles, mean vertex radius {radius:.5f} (gate 0.5 +- 0.05)",
          flush=True)
    check(counts == want, f"phase 18b: launches {counts} != {want}")
    check(losses[-1] < 0.5 * losses[0], f"phase 18b: loss {losses[0]} -> {losses[-1]}")
    check(mae < 0.05, f"phase 18b: mean |pred - sdf| {mae}")
    check(len(tris) > 0 and abs(radius - 0.5) < 0.05, f"phase 18b: mesh radius {radius}")
    step_pts = torch.as_tensor(pts, device=dev)
    step_ms = cuda_ms(lambda: trainer.step(step_pts, gt), 20)
    x01 = torch.clamp((step_pts + 1.0) * 0.5, 0.0, 1.0)
    g_enc = torch.randn((SDF_BATCH, trainer.field.spec.output_dim), generator=gen, device=dev)
    from flnerf_tpu_torch.ops import hash_kernel as hk
    k3_ms = cuda_ms(lambda: hk.hash_encode_forward(x01, trainer.field.table.detach(),
                                                   trainer.field.spec), 20)
    k4_ms = cuda_ms(lambda: hk.hash_encode_backward(x01, g_enc, trainer.field.spec), 20)
    print(f"[phase 18d] SDF train step {step_ms:.4f} ms by CUDA events over 20 steps (its "
          f"host-side batch draw apart); K3 {k3_ms:.4f} ms and K4 {k4_ms:.4f} ms on its "
          f"{SDF_BATCH} points ({100 * (k3_ms + k4_ms) / step_ms:.1f}% of the step)",
          flush=True)
    del res, trainer

    # the mesh path: a sphere OBJ written here
    verts, faces = icosphere(3)
    obj = os.path.join(tmp.name, "sphere.obj")
    save_obj(obj, verts, faces)
    mesh_c = MeshSDF(verts, faces, device=dev)
    mesh_h = MeshSDF(verts, faces, device="cpu")
    q = np.random.default_rng(2).uniform(-1, 1, (SDF_BATCH, 3)).astype(np.float32)
    s_c, s_h = mesh_c(q), mesh_h(q)
    facet = float(np.abs(s_c + sphere(q)).max())
    agree = float(np.abs(s_c - s_h).max())
    mesh_ms = cuda_ms(lambda: mesh_c.query(torch.as_tensor(q[:SDF_BATCH // 2], device=dev)), 5)
    print(f"[phase 18b] MeshSDF on a {len(faces)}-face sphere (radius 0.5) at {SDF_BATCH} "
          f"uniform points: max |mesh sdf - analytic| {facet:.3e} (the faceting; gate 5e-3), "
          f"card against CPU max abs err {agree:.3e} (gate 1e-5)", flush=True)
    check(facet < 5e-3, f"phase 18b: MeshSDF is {facet} from the analytic sphere")
    check(agree <= 1e-5, f"phase 18b: MeshSDF differs card/CPU by {agree}")
    ws = os.path.join(tmp.name, "mesh")
    argv = [obj, "--iters", str(SDF_MESH_ITERS), "--batch", str(SDF_BATCH), "--mesh_reso",
            str(SDF_MESH_RESO), "--workspace", ws]
    reset_counts()
    t0 = time.time()
    res = main_sdf.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    counts_by_run["18b mesh"] = counts
    want = {k: 0 for k in counts}
    want.update({"K3": SDF_MESH_ITERS + mesh_chunks, "K4": SDF_MESH_ITERS})
    losses = res["losses"]
    print(f"[phase 18b] main_sdf.main sphere.obj --iters {SDF_MESH_ITERS}: kernel launches "
          f"{counts} (predicted {want}); main {wall:.1f} s; mape loss first {losses[0]:.5f} "
          f"last {losses[-1]:.5f}; {res['n_verts']} vertices in mesh.obj", flush=True)
    check(counts == want, f"phase 18b: mesh path launches {counts} != {want}")
    check(losses[-1] < losses[0], "phase 18b: the mesh path's loss did not fall")
    check(os.path.exists(os.path.join(ws, "mesh.obj")) and res["n_verts"] > 0,
          "phase 18b: no mesh.obj")
    ds = SDFMeshDataset(obj, num_samples=SDF_BATCH, seed=3, device=dev)
    t0 = time.time()
    ds.sample_batch()
    batch_ms = (time.time() - t0) * 1e3
    print(f"[phase 18d] MeshSDF query of {SDF_BATCH // 2} points x {len(faces)} faces "
          f"{mesh_ms:.3f} ms by CUDA events; one SDFMeshDataset batch of {SDF_BATCH} "
          f"(surface draws and the query, host clock) {batch_ms:.2f} ms", flush=True)
    del res, mesh_c, mesh_h, ds

    # ---- phase 18c: extract_mesh on a NeRF .tar and a Plenoxels .npz ----
    opt_dir = os.path.join(tmp.name, "opt")
    opt.main(["synthetic", "-t", opt_dir, "--n_epochs", "2"])
    npz = None
    for name in sorted(os.listdir(opt_dir)):
        if name.endswith(".npz"):
            npz = os.path.join(opt_dir, name)
    if npz is None:
        raise RuntimeError("phase 18c: cli/opt.py wrote no .npz")
    if keep_npz:
        shutil.copy(npz, keep_npz)
    grid, _ = load_npz(npz)
    grid_sigma = grid.density[grid.alive].numpy()
    mlp = make_nerf_mlp(compute_dtype=torch.float32, device=dev)
    load_nerf_query_network(nerf_tar, mlp)
    nerf_sigma, _ = extract_mesh.density_grid_from_nerf(mlp, 1.2, 64)
    del mlp, grid
    for what, ckpt, sigma in (("the phase-14 NeRF .tar", nerf_tar, nerf_sigma),
                              ("a 2-epoch cli/opt.py .npz", npz, grid_sigma)):
        iso = float(np.percentile(sigma, 99))
        out = os.path.join(tmp.name, "extracted.ply" if ckpt.endswith(".npz") else
                           "extracted.obj")
        reset_counts()
        t0 = time.time()
        nv, nt = extract_mesh.main(["--ckpt", ckpt, "--out", out, "--sigma_thresh", str(iso)])
        wall = time.time() - t0
        counts = launch_counts()
        print(f"[phase 18c] extract_mesh on {what} at --sigma_thresh {iso:.4f} (its sigma's "
              f"99th percentile): {nv} vertices, {nt} triangles in {os.path.basename(out)}, "
              f"{wall:.1f} s; kernel launches {counts}", flush=True)
        check(nv > 0 and nt > 0 and os.path.exists(out), f"phase 18c: empty mesh from {what}")
        check(all(c == 0 for c in counts.values()), f"phase 18c: {what} launched {counts}")
    print(f"[phase 18] {time.time() - t_phase:.1f} s", flush=True)
    tmp.cleanup()
    return counts_by_run, (k3_err, k4_err)



RESUNET_IMAGE = 800        # blender's width; the data are not in the repo
RESUNET_F32_TOL = 1e-4     # card against CPU, of the largest output (TF32 off)
RESUNET_BF16_TOL = 3e-2    # norm-wise: bf16 roundings that fall the other way
GUI_ITERS = 256            # phase 20a: 16 frames of 16 steps
GUI_SHORT_ITERS = 64       # phase 20b: the other CLIs' --gui runs
DDP_PLX_BATCH = 5120       # phase 21b: divides by RB x 2, so each rank takes 2560


def resunet_phase(dev):
    """Phase 19: ResUNet at its full width, card against CPU."""
    import torch

    from flnerf_tpu_torch.data.blender import load_blender_data
    from flnerf_tpu_torch.data.synthetic import write_blender_fixture
    from flnerf_tpu_torch.models.resunet import ResUNetConfig, apply_resunet, init_resunet

    t_phase = time.time()
    cfg = ResUNetConfig()
    params = init_resunet(torch.Generator().manual_seed(19), cfg)
    to = lambda tree: ({k: to(v) for k, v in tree.items()} if isinstance(tree, dict) else
                       [to(v) for v in tree] if isinstance(tree, list) else tree.to(dev))
    params_d = to(params)
    big = torch.rand((1, RESUNET_IMAGE, RESUNET_IMAGE, 3), generator=torch.Generator().manual_seed(20))
    with tempfile.TemporaryDirectory() as tmp:
        write_blender_fixture(os.path.join(tmp, "fixture"), H=96, n_train=4, n_val=1, n_test=1)
        views = torch.from_numpy(np.ascontiguousarray(
            load_blender_data(os.path.join(tmp, "fixture"))[0][:4, ..., :3], np.float32))
    errs = {}
    with torch.no_grad():
        for name, x, dtype, tol in (("800x800 f32", big, torch.float32, RESUNET_F32_TOL),
                                    ("96-px views f32", views, torch.float32, RESUNET_F32_TOL),
                                    ("96-px views bf16", views, torch.bfloat16, RESUNET_BF16_TOL)):
            t0 = time.time()
            want = apply_resunet(params, x, cfg, dtype).float()
            cpu_s = time.time() - t0
            got = apply_resunet(params_d, x.to(dev), cfg, dtype).float().cpu()
            check(bool(torch.isfinite(got).all()), f"phase 19: ResUNet {name} not finite")
            if dtype == torch.float32:
                err = float((got - want).abs().max() / want.abs().max())
            else:
                err = float((got - want).norm() / want.norm())
            errs[name] = err
            print(f"[phase 19] ResUNet {name}: input {tuple(x.shape)} -> {tuple(got.shape)}; "
                  f"card against CPU {err:.3e} ({'of the largest output' if dtype == torch.float32 else 'norm-wise'}, "
                  f"tolerance {tol}); CPU forward {cpu_s:.2f} s", flush=True)
            check(err <= tol, f"phase 19: ResUNet {name} card against CPU {err} > {tol}")
        xb = big.to(dev)
        ms = {str(dt).split(".")[-1]: cuda_ms(lambda: apply_resunet(params_d, xb, cfg, dt), 10)
              for dt in (torch.float32, torch.bfloat16)}
        bf_vs_f32 = apply_resunet(params_d, xb, cfg, torch.bfloat16).float()
        f32 = apply_resunet(params_d, xb, cfg).float()
        rel = float((bf_vs_f32 - f32).norm() / f32.norm())
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[phase 19] ResUNet forward at {RESUNET_IMAGE}x{RESUNET_IMAGE} by CUDA events: "
          f"f32 {ms['float32']:.3f} ms, bf16 operands {ms['bfloat16']:.3f} ms (bf16 against f32 "
          f"on the card {rel:.3e} norm-wise); {n_params} parameters; card {smi_line()}; "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return errs


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class _SessionSpy:
    """Records every render of the interactive session (its downscale, rH x
    rW, wall ms, finiteness) and the last session, through
    InteractiveSession._render and render_frame."""

    def __init__(self):
        from flnerf_tpu_torch.render.interactive import InteractiveSession
        self.cls = InteractiveSession
        self.render, self.frame = InteractiveSession._render, InteractiveSession.render_frame
        self.renders, self.frames, self.session = [], [], None
        spy = self

        def _render(sess, downscale):
            spy.session = sess
            rgb, depth = spy.render(sess, downscale)
            spy.renders.append((downscale, int(sess.H * downscale), int(sess.W * downscale),
                                bool(np.isfinite(rgb).all() and np.isfinite(depth).all())))
            return rgb, depth

        def render_frame(sess):
            out = spy.frame(sess)
            spy.frames.append((out["downscale"], out["spp"], out["time_ms"]))
            return out

        InteractiveSession._render, InteractiveSession.render_frame = _render, render_frame

    def chunks(self, renders=None):
        """K3 launches of the recorded renders: ceil(rH rW / chunk) each, the
        chunk min(8192, rH rW) rounded as ngp_render_image rounds it."""
        total = 0
        for _, rh, rw, _ in (self.renders if renders is None else renders):
            n = rh * rw
            chunk = min(min(8192, n), (n + 127) // 128 * 128)
            total += -(-n // chunk)
        return total

    def close(self):
        self.cls._render, self.cls.render_frame = self.render, self.frame


def gui_phases(dev):
    """Phase 20: the interactive session through the four CLIs' --gui.
    Returns {run: launch counts}."""
    import torch

    from flnerf_tpu_torch.cli import main_ccnerf, main_dnerf, main_nerf, main_tensorf
    from flnerf_tpu_torch.render.interactive import DOWNSCALES, InteractiveSession

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    counts_by_run = {}
    ws = os.path.join(tmp.name, "gui")
    argv = ["synthetic", "-O", "--gui", "--iters", str(GUI_ITERS), "--workspace", ws]
    spy = _SessionSpy()
    try:
        reset_counts()
        t0 = time.time()
        res = main_nerf.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        counts_by_run["20a main_nerf --gui"] = counts
        sess = spy.session
        tr = sess.trainer
        n_chunks = GUI_ITERS // tr.cfg.steps_per_chunk
        g, st = tr.rcfg.grid_size, max(tr.rcfg.partial_stride, 2)
        full, part = -(-g ** 3 // REFRESH_CHUNK), -(-(g // st) ** 3 // REFRESH_CHUNK)
        refresh = sum(part if ci >= tr.cfg.full_refreshes else full for ci in range(n_chunks))
        previews = spy.chunks()
        want = {k: 0 for k in counts}
        want.update({"K3": GUI_ITERS + refresh + previews, "K4": GUI_ITERS})
        downs = [r[0] for r in spy.renders]
        frame_ms = [round(f[2], 1) for f in spy.frames]
        print(f"[phase 20a] main_nerf.main {' '.join(argv[:-2])} at {sess.W}x{sess.H}: "
              f"{len(spy.renders)} frames, {res['step']} steps, kernel launches {counts} "
              f"(predicted {want}: steps {GUI_ITERS}, refresh chunks {refresh}, preview "
              f"chunks {previews}); main {wall:.1f} s; downscale trajectory {downs}; frame "
              f"render ms {frame_ms}; train steps a frame {sess.train_steps}", flush=True)
        check(counts == want, f"phase 20a: launches {counts} != {want}")
        check(res["step"] == GUI_ITERS, f"phase 20a: {res['step']} steps")
        check(all(d in DOWNSCALES for d in downs) and sess.downscale in DOWNSCALES,
              f"phase 20a: downscales {downs}")
        check(all(r[3] for r in spy.renders), "phase 20a: a frame is not finite")
        trainer = main_nerf.build(main_nerf.parse_args(argv))[0]
        trainer.load_checkpoint(ws)
        for a, b in zip(trainer.params, tr.params):
            check(torch.equal(a, b), "phase 20a: the checkpoint reloads other weights")
        check(trainer.step == GUI_ITERS, f"phase 20a: the checkpoint's step {trainer.step}")

        # previews of the reloaded trainer: still, orbit, zoom, still
        args = main_nerf.parse_args(argv)
        view = InteractiveSession(trainer, None, W=args.W, H=args.H, radius=args.radius,
                                  fovy=args.fovy, max_spp=args.max_spp)
        spy.renders, spy.frames = [], []
        reset_counts()
        seq = []
        for act in ("still", "still", "still", "orbit", "still", "zoom", "still"):
            if act == "orbit":
                view.orbit(120.0, 30.0)
            elif act == "zoom":
                view.zoom(2.0)
            out = view.render_frame()
            check(bool(np.isfinite(out["image"]).all()), f"phase 20a: {act} frame not finite")
            seq.append((act, out["spp"], out["downscale"], round(out["time_ms"], 1)))
        torch.cuda.synchronize()
        counts = launch_counts()
        counts_by_run["20a previews"] = counts
        want = {k: 0 for k in counts}
        want["K3"] = spy.chunks()
        spps = [x[1] for x in seq]
        print(f"[phase 20a] the reloaded trainer's previews (action, spp, downscale, ms): {seq}; "
              f"launches {counts} (predicted {want})", flush=True)
        check(counts == want, f"phase 20a: preview launches {counts} != {want}")
        check(spps == [1, 2, 3, 1, 2, 1, 2], f"phase 20a: spp {spps}")
        del trainer, view, tr, sess

        spy.renders, spy.frames = [], []
        reset_counts()
        res = main_nerf.main(argv + ["--test"])
        counts = launch_counts()
        want = {k: 0 for k in counts}
        want["K3"] = spy.chunks()
        print(f"[phase 20a] main_nerf --gui --test: {res}, downscales "
              f"{[r[0] for r in spy.renders]}, launches {counts} (predicted {want})", flush=True)
        check(res["spp"] == 4 and counts == want, f"phase 20a: --gui --test {res} {counts}")

        # ---- 20b: the other CLIs' --gui, at a reduced depth ----
        short = ["synthetic", "-O", "--gui", "--iters", str(GUI_SHORT_ITERS)]
        for name, cli in (("main_dnerf", main_dnerf), ("main_tensorf", main_tensorf),
                          ("main_ccnerf", main_ccnerf)):
            spy.renders, spy.frames = [], []
            reset_counts()
            t0 = time.time()
            res = cli.main(short + ["--workspace", os.path.join(tmp.name, name)])
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = launch_counts()
            counts_by_run[f"20b {name} --gui"] = counts
            want = {k: 0 for k in counts}
            if name == "main_dnerf":
                tr = spy.session.trainer
                n_chunks = GUI_SHORT_ITERS // tr.cfg.steps_per_chunk
                g = tr.rcfg.grid_size
                refresh = n_chunks * -(-g ** 3 // REFRESH_CHUNK)   # full: fewer than 16 chunks
                want.update({"K3": GUI_SHORT_ITERS + refresh + spy.chunks(),
                             "K4": GUI_SHORT_ITERS})
            print(f"[phase 20b] {name}.main {' '.join(short)}: {res}, launches {counts} "
                  f"(predicted {want}); downscales {[r[0] for r in spy.renders]}; {wall:.1f} s",
                  flush=True)
            check(counts == want, f"phase 20b: {name} launches {counts} != {want}")
            check(res["step"] == GUI_SHORT_ITERS and all(r[3] for r in spy.renders),
                  f"phase 20b: {name} {res}")
            if name == "main_dnerf":
                sess = spy.session
                sess.render_frame()
                before = len(spy.renders)
                sess.set_time(1.0)
                out = sess.render_frame()
                print(f"[phase 20b] main_dnerf: set_time(1.0) re-rendered: spp {out['spp']}, "
                      f"{out['time_ms']:.1f} ms", flush=True)
                check(len(spy.renders) == before + 1 and out["spp"] == 1 and sess.time == 1.0,
                      "phase 20b: set_time did not re-render")
            del res
    finally:
        spy.close()
        tmp.cleanup()
    print(f"[phase 20] {time.time() - t_phase:.1f} s", flush=True)
    return counts_by_run


def _ddp_plx_batch(dev, n):
    """The Plenoxels trainer's first n rays on the card (its coherence
    order, rng 0) as a RayEpoch, and the phase-2 sphere grid."""
    from flnerf_tpu_torch.rays.quadtree import RayEpoch
    from flnerf_tpu_torch.train.plenoxels_trainer import coherence_order
    images, poses, H, W, focal, K, i_train, i_test = scene()
    e = first_epoch(images, poses, H, W, K, i_train)
    first = coherence_order(e.px, e.py, e.img, np.random.default_rng(0))[:n]
    return RayEpoch(e.origins[first], e.dirs[first], e.rgb[first], e.leaf_id[first],
                    e.n_leaves, None, e.px[first], e.py[first], e.img[first])


def _plx_trainer(dev, batch, group=None):
    from flnerf_tpu_torch.models.voxel_sh import VoxelGridConfig
    from flnerf_tpu_torch.train.plenoxels_trainer import (
        PlenoxelsState, PlenoxelsTrainConfig, PlenoxelsTrainer)
    import torch
    cfg = VoxelGridConfig(reso=(RESO,) * 3, radius=(SCENE_RADIUS,) * 3, max_steps=MAX_STEPS,
                          step_size=STEP)
    t = PlenoxelsTrainer(cfg, PlenoxelsTrainConfig(batch_size=batch, steps_per_chunk=1),
                         device=dev, group=group)
    g = sphere_grid(dev)
    t.state = PlenoxelsState(g, torch.zeros_like(g.density), torch.zeros_like(g.sh), 0)
    return t


def _ngp_ddp_trainer(group=None):
    """The NGP trainer main_nerf builds for `synthetic -O` (2^15, bf16
    MLPs, 4096 rays a step) on ``group``, and its sampler."""
    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.train.ngp_trainer import NGPSampler, NGPTrainer
    args = main_nerf.parse_args(["synthetic", "-O", "--iters", str(NGP_ITERS)])
    _, cfg, rcfg, tcfg = main_nerf.build(args)
    import torch
    trainer = NGPTrainer(cfg, rcfg, tcfg, device="cuda", compute_dtype=torch.bfloat16,
                         group=group)
    images, poses, hwf, K, (i_train, _, _) = main_nerf.load_ngp_dataset(args)
    return trainer, NGPSampler(images[i_train], poses[i_train], K, tcfg, seed=args.seed)


def _ddp_rank(rank, world, out_dir):
    """Phase 21b, one rank of two on the card (gloo, CUDA tensors): a
    Plenoxels and an NGP step, each rank's gradients against its own
    world-1 computation (a process group of itself)."""
    import torch
    import torch.distributed as dist

    from flnerf_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    solo = [dist.new_group([r]) for r in range(world)][rank]
    out = {"rank": rank}
    batch = _ddp_plx_batch(dev, DDP_PLX_BATCH)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    o, d, rgb = to(batch.origins), to(batch.dirs), to(batch.rgb)
    mask = torch.ones(o.shape[0], device=dev)
    one = _plx_trainer(dev, DDP_PLX_BATCH, group=solo)
    grads1, mse1, _, err1 = one._grads(o, d, rgb, mask)
    del one
    two = _plx_trainer(dev, DDP_PLX_BATCH)
    check(two.shard_kernel and two.world == 2, "phase 21b: the Plenoxels step is not sharded")
    reset_counts()
    grads2, mse2, _, err2 = two._grads(o, d, rgb, mask)    # the same function, this rank's slice
    torch.cuda.synchronize()
    out["plx_grad_counts"] = launch_counts()
    for name, a, b in zip(("grad_density", "grad_sh"), grads2, grads1):
        out[f"plx_{name}"] = (float((a - b).abs().max()), float(b.abs().max()))
    out["plx_mse"] = (float(mse2), float(mse1))
    out["plx_err"] = float((err2 - err1).abs().max())
    # gloo's all-reduce of the SH gradient (CUDA tensors through the host)
    buf = grads2[1].clone()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.time()
    mesh.all_reduce_([buf])
    torch.cuda.synchronize()
    out["allreduce_s"] = time.time() - t0
    out["allreduce_gb"] = buf.numel() * 4 / 1e9
    del buf, grads1, grads2
    reset_counts()
    _, rec = recorded(lambda: two.run_epoch_rays(batch))     # the trainer's own step
    torch.cuda.synchronize()
    out["plx_step_counts"] = launch_counts()
    out["plx_graph_steps"] = rec.get("flnerf.train.graph_steps", 0)
    del two
    torch.cuda.empty_cache()

    t1, sampler = _ngp_ddp_trainer(group=solo)
    t2, _ = _ngp_ddp_trainer()
    check(t2.shard_grads and t2.world == 2, "phase 21b: the NGP step is not sharded")
    drawn = sampler.sample_chunk(1, t1.cfg.batch_rays)
    o, d, rgb = (to(a[0]) for a in drawn[:3])
    losses = {}
    for name, t in (("one", t1), ("two", t2)):
        t.refresh_occupancy(partial=False)
        reset_counts()
        loss, per_ray = t.train_step(o, d, rgb)
        torch.cuda.synchronize()
        out[f"ngp_{name}_counts"] = launch_counts()
        losses[name] = (float(loss), per_ray)
    out["ngp_loss"] = (losses["two"][0], losses["one"][0])
    out["ngp_per_ray"] = float((losses["two"][1] - losses["one"][1]).abs().max())
    # Adam's first moment after one step is 0.1 x the gradient
    out["ngp_grads"] = [(float((a - b).abs().max()), float(b.abs().max()),
                         float((a - b).norm()), float(b.norm())) for a, b in zip(t2.mu, t1.mu)]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ddp_phases(dev):
    """Phase 21: data parallelism on the one card.  Returns {run: launch
    counts} of 21b's ranks."""
    import torch
    import torch.distributed as dist

    from flnerf_tpu_torch.models.nerfpp import NerfPPConfig
    from flnerf_tpu_torch.parallel import dryrun, mesh
    from flnerf_tpu_torch.rays.quadtree import RayEpoch
    from flnerf_tpu_torch.render.renderer import RenderConfig
    from flnerf_tpu_torch.train import nerfpp_trainer, trainer as nerf_trainer

    t_phase = time.time()
    rng = np.random.default_rng(21)
    n = 1920
    u = rng.standard_normal((n, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    dirs = (-u + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = rng.random((n, 3)).astype(np.float32)
    leaf = rng.integers(0, 64, n).astype(np.int32)
    nerf_epoch = RayEpoch(4.0 * u, dirs, rgb, leaf, 64)
    npp_epoch = RayEpoch(0.5 * u, dirs, rgb, leaf, 64)
    plx_batch = _ddp_plx_batch(dev, BATCH)

    def steps():
        """One step of each trainer; (losses, weights) on the card."""
        out = {}
        t = _plx_trainer(dev, BATCH)
        _, mse = t.run_epoch_rays(plx_batch)
        out["Plenoxels"] = (mse, [t.state.grid.density.clone(), t.state.grid.sh.clone()], t.world)
        del t
        t, sampler = _ngp_ddp_trainer()
        drawn = sampler.sample_chunk(1, t.cfg.batch_rays)
        to = lambda a: torch.from_numpy(a[0]).to(dev)
        t.refresh_occupancy(partial=False)
        loss, _ = t.train_step(*(to(a) for a in drawn[:3]))
        # Adam's first step moves each entry by lr x the sign of its
        # gradient, so K4's atomic sum order flips tiny entries: hold its
        # first moment, 0.1 x the gradient
        out["NGP"] = (float(loss), [m.clone() for m in t.mu], t.world)
        t = nerf_trainer.NerfTrainer(nerf_trainer.NerfConfig(), RenderConfig(
            n_samples=64, n_importance=128, perturb=1.0, near=2.0, far=6.0),
            nerf_trainer.TrainConfig(n_rand=n, precrop_iters=0), device=dev)
        _, mse = t.run_epoch_rays(nerf_epoch)
        out["NeRF"] = (mse, [p.detach().clone() for p in t.parameters()], t.world)
        t = nerfpp_trainer.NerfPPTrainer(NerfPPConfig(cascade_samples=(64, 128)),
                                         nerfpp_trainer.NerfPPTrainConfig(batch_size=n),
                                         device=dev)
        _, mse = t.run_epoch_rays(npp_epoch)
        out["NeRF++"] = (mse, [p.detach().clone() for net in t.nets for p in net.parameters()],
                         t.world)
        torch.cuda.synchronize()
        return out

    plain = steps()
    check(mesh.init_distributed(f"localhost:{dryrun.free_port()}", 1, 0, device=dev),
          "phase 21a: init_distributed did not start a process group")
    try:
        check(dist.get_backend() == "nccl" and mesh.world() == 1, "phase 21a: not NCCL world 1")
        grouped = steps()
        for name in plain:
            (l0, w0, world0), (l1, w1, world1) = plain[name], grouped[name]
            bitwise = all(torch.equal(a, b) for a, b in zip(w0, w1))
            err = max(float((a - b).norm() / max(float(b.norm()), 1e-30))
                      for a, b in zip(w0, w1))
            what = "Adam's first moment" if name == "NGP" else "weights"
            print(f"[phase 21a] {name}: one step without a process group and under NCCL at "
                  f"world {world1} (no collective runs, nothing sharded): loss {l0!r} and "
                  f"{l1!r}, {what} bitwise {bitwise} (largest difference {err:.2e} norm-wise)",
                  flush=True)
            check(world0 == 1 and world1 == 1 and l0 == l1,
                  f"phase 21a: {name} loss {l0} != {l1} at world 1")
            check(bitwise or err <= 1e-4, f"phase 21a: {name} {what} differ by {err}")
        del plain, grouped
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- 21b: two ranks on the one card over gloo ----
    tmp = tempfile.TemporaryDirectory()
    t0 = time.time()
    dryrun.spawn(_ddp_rank, 2, tmp.name, device="cuda", backend="gloo")
    wall = time.time() - t0
    counts_by_run = {}
    for r in range(2):
        with open(os.path.join(tmp.name, f"rank{r}.json")) as f:
            res = json.load(f)
        want_g = {k: 0 for k in res["plx_grad_counts"]}
        want_g.update({"K1": 1, "K2": 1})
        want_n = {k: 0 for k in res["ngp_two_counts"]}
        want_n.update({"K3": 1, "K4": 1})
        counts_by_run[f"21b rank {r}"] = {k: res["plx_step_counts"][k] + res["ngp_two_counts"][k]
                                         for k in want_n}
        gerr = {k: res[f"plx_{k}"] for k in ("grad_density", "grad_sh")}
        rel = [float(f"{en / max(sn, 1e-30):.2e}") for _, _, en, sn in res["ngp_grads"]]
        print(f"[phase 21b] rank {r} of 2 (gloo, CUDA tensors): Plenoxels gradients against its "
              f"world-1 computation (max |diff|, scale) {gerr}, mse {res['plx_mse']}, per-ray "
              f"error {res['plx_err']:.2e}; launches: the sharded gradient {res['plx_grad_counts']}, "
              f"the trainer's step {res['plx_step_counts']}; NGP loss {res['ngp_loss']}, per-ray "
              f"loss {res['ngp_per_ray']:.2e}, gradients (0.1 x, Adam's first moment) apart norm-wise, "
              f"table first: {rel}; launches world 2 {res['ngp_two_counts']}, "
              f"world 1 {res['ngp_one_counts']}; gloo all_reduce of the SH gradient "
              f"({res['allreduce_gb']:.2f} GB) {res['allreduce_s'] * 1e3:.1f} ms (host clock)",
              flush=True)
        for k, (e, s) in gerr.items():
            check(s > 0 and e <= 1e-4 * s, f"phase 21b: rank {r} Plenoxels {k} {e} > 1e-4 * {s}")
        a, b = res["plx_mse"]
        check(abs(a - b) <= 1e-5 * abs(b), f"phase 21b: rank {r} Plenoxels mse {a} != {b}")
        # the step sweeps after the all-reduce, on every rank
        check(res["plx_grad_counts"] == want_g
              and res["plx_step_counts"] == plx_fit_counts(1, K1=1, K2=1),
              f"phase 21b: rank {r} Plenoxels launches")
        # the sharded step reduces across ranks: never a graph
        check(res["plx_graph_steps"] == 0,
              f"phase 21b: rank {r} graphed {res['plx_graph_steps']} sharded steps")
        a, b = res["ngp_loss"]
        check(abs(a - b) <= 1e-5 * abs(b) and res["ngp_per_ray"] <= 1e-5,
              f"phase 21b: rank {r} NGP loss {a} != {b}")
        # bf16 operands: autograd rounds each layer's cotangent to bf16, so
        # the halves' other sum order moves entries by a bf16 ulp; held at
        # phase 14a's bf16 gradient tolerance, norm-wise
        for e, s, en, sn in res["ngp_grads"]:
            check(en <= NERF_GRAD_TOL * sn,
                  f"phase 21b: rank {r} NGP gradient {en} > {NERF_GRAD_TOL} * {sn} norm-wise")
        check(res["ngp_two_counts"] == want_n, f"phase 21b: rank {r} NGP launches")
    tmp.cleanup()
    print(f"[phase 21b] 2 ranks spawned and joined in {wall:.1f} s; no scaling figure: both "
          f"ranks share one card", flush=True)

    # ---- 21c: the port's dry run on the card ----
    t0 = time.time()
    dryrun.dryrun_multichip(2, device="cuda")   # raises if a rank fails or the ranks disagree
    print(f"[phase 21c] dryrun_multichip(2) on the card over gloo: NeRF, Plenoxels (K1/K2), "
          f"NGP 2^15 (K3/K4) and the 2^16 lattice engine (K6/K7) ok in {time.time() - t0:.1f} s; "
          f"[phase 21] {time.time() - t_phase:.1f} s", flush=True)
    return counts_by_run


# phases 22-24: the loaders and tools.  22a trains cli/opt.py on the
# synthetic scene written as an NSVF scene; its grid radius is 1.5 where the
# synthetic scene's is 1.2 and its images are 8-bit, so its train PSNR is not
# phase 3's: on the CPU (32^3 and 64^3, the same flags otherwise) the two
# differed by at most 0.45 dB an epoch
NSVF_TRAIN_TOL_DB = 1.0
RENDER_IMGS_TOL_DB = 1e-4  # 22b: the same grid (SH stored in f16), views and march
CALC_METRICS_TOL_DB = 0.1  # 22b: the renders and the ground truth rounded to 8 bits
SVOX1_VOXELS = 10_000      # 22c: alive voxels looked up in the exported tree
CLIP_VIEWS, CLIP_SIZE = 2, 64    # 23: rand_poses views rendered a guided step
FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)   # OpenGL c2w <-> OpenCV c2w
# 24: run_nerf at its defaults' widths (D8 W256, 64 + 128 samples, bf16)
# for one epoch; a deepvoxels frame is 512 x 512, so one train view there
LOADER_NERF_FLAGS = ("--use_viewdirs", "--N_importance", "128", "--N_rand", "1920",
                     "--n_epoch", "1", "--init_level", "2", "--testskip", "1")


def write_nsvf_scene(root, n_train=8, n_test=2, H=48):
    """The synthetic scene's views as an NSVF scene (rgb/0_* train and
    rgb/2_* test PNGs, pose/*.txt = c2w . diag(1, -1, -1, 1), intrinsics.txt
    = f W/2+0.5 H/2+0.5): its OpenCV training rays, with pixel centres at
    +0.5, are the synthetic scene's rays up to rounding.  Returns the scene
    (images, poses, hwf, i_train, i_test)."""
    from flnerf_tpu_torch.core.metrics import to8b
    from flnerf_tpu_torch.data.png import write_png
    from flnerf_tpu_torch.data.synthetic import load_synthetic_data

    images, poses, _, hwf, (tr, _, te) = load_synthetic_data(n_train=n_train, n_test=n_test,
                                                             H=H, W=H)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "pose"))
    for prefix, idx in (("0", tr), ("2", te)):
        for j, i in enumerate(idx):
            write_png(os.path.join(root, "rgb", f"{prefix}_{j:04d}.png"), to8b(images[i]))
            np.savetxt(os.path.join(root, "pose", f"{prefix}_{j:04d}.txt"),
                       poses[i].astype(np.float64) @ FLIP_YZ)
    h, w, f = hwf
    with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
        fh.write(f"{f} {w / 2 + 0.5} {h / 2 + 0.5}\n")
    return images, poses, hwf, tr, te


def tools_phases(dev, plx, npz_128):
    """Phase 22: the Plenoxels tools on the card.  ``plx``: phase 3's run
    (its last checkpoint, test PSNR, train PSNRs and K1/K2 launches);
    ``npz_128``: phase 18c's 128^3 checkpoint.  Returns {run: launch
    counts} of 22a and 22b."""
    import contextlib
    import io

    import torch

    from flnerf_tpu_torch.cli import autotune, calc_metrics, opt, render_imgs, to_svox1
    from flnerf_tpu_torch.core.metrics import to8b
    from flnerf_tpu_torch.core.svox1_export import lookup_octree
    from flnerf_tpu_torch.data.png import write_png
    from flnerf_tpu_torch.models.voxel_sh import load_npz
    from flnerf_tpu_torch.rays.camera import intrinsics_matrix
    from flnerf_tpu_torch.train.plenoxels_trainer import (
        PlenoxelsState,
        PlenoxelsTrainConfig,
        PlenoxelsTrainer,
    )

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    counts_by_run = {}
    reso_arg = f"[[{RESO},{RESO},{RESO}]]"

    # ---- phase 22a: cli/opt.py on an NSVF scene (OpenCV rays, R8 eval) ----
    nsvf = os.path.join(tmp.name, "nsvf")
    images, poses, hwf, _, i_test = write_nsvf_scene(nsvf)
    reset_counts()
    t0 = time.time()
    res = opt.main([nsvf, "-t", os.path.join(tmp.name, "nsvf_run"), "--reso", reso_arg,
                    "--n_epochs", "3", "--device", str(dev)])
    wall = time.time() - t0
    counts = counts_by_run["22a nsvf"] = launch_counts()
    want = plx_fit_counts(plx["k2"], K1=plx["k1"], K2=plx["k2"])
    train = [h["train_psnr"] for h in res["history"]]
    gaps = [a - b for a, b in zip(train, plx["train"])]
    print(f"[phase 22a] opt.main on the synthetic scene as NSVF (48x48, 8 + 2 views, {RESO}^3, "
          f"3 epochs): launches {counts} (phase 3's K1 {plx['k1']}, K2 {plx['k2']}); train PSNR "
          f"{[round(p, 4) for p in train]}, minus phase 3's {[round(g, 4) for g in gaps]} dB; "
          f"test PSNR {res['psnr']:.4f} (R8: eval views flipped); main {wall:.1f} s", flush=True)
    check(counts == want, f"phase 22a: launches {counts} != {want}")
    check(train[-1] > train[0], f"phase 22a: train PSNR did not rise: {train}")
    check(len(gaps) == 3 and max(abs(g) for g in gaps) <= NSVF_TRAIN_TOL_DB,
          f"phase 22a: train PSNR {train} against phase 3's {plx['train']}")
    check(math.isfinite(res["psnr"]), f"phase 22a: test PSNR {res['psnr']}")
    del res

    # ---- phase 22b: render_imgs on phase 3's checkpoint, calc_metrics ----
    rd = os.path.join(tmp.name, "renders")
    reset_counts()
    t0 = time.time()
    out = render_imgs.main([plx["ckpt"], "synthetic", "--render_dir", rd, "--device", str(dev)])
    wall = time.time() - t0
    counts = counts_by_run["22b render_imgs"] = launch_counts()
    want = {k: 0 for k in counts}
    want["K1"] = 2
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        timing = render_imgs.main([plx["ckpt"], "synthetic", "--timing", "--device", str(dev),
                                   "--render_dir", os.path.join(tmp.name, "timing")])
    gt = os.path.join(tmp.name, "gt")
    os.makedirs(gt)
    for j, i in enumerate(i_test):
        write_png(os.path.join(gt, f"{j:04d}.png"), to8b(images[i]))
    cm = calc_metrics.main([rd, gt])
    # R9: render_imgs marches with load_npz's config, whose max_steps is the
    # default 512, where opt.py marched 3.5 * 256 / 0.5 = 1792: the same
    # checkpoint's grid through the trainer's eval at both budgets
    evals = {}
    grid, gcfg = load_npz(plx["ckpt"], device=dev)
    K = intrinsics_matrix(48, 48, hwf[2])
    opt_steps = int(3.5 * RESO / STEP)
    for steps in (gcfg.max_steps, opt_steps):
        tr = PlenoxelsTrainer(gcfg._replace(max_steps=steps), PlenoxelsTrainConfig(), device=dev)
        tr.state = PlenoxelsState(grid, torch.zeros_like(grid.density),
                                  torch.zeros_like(grid.sh), 0)
        evals[steps] = tr.eval_images(poses[i_test], images[i_test], 48, 48, K)[0]
    del grid, tr
    print(f"[phase 22b] render_imgs on phase 3's {os.path.basename(plx['ckpt'])}: launches "
          f"{counts}; mean PSNR {out['psnr']:.6f} SSIM {out['ssim']:.4f}; the checkpoint's grid "
          f"through the trainer's eval at max_steps {gcfg.max_steps} (render_imgs' config) "
          f"{evals[gcfg.max_steps]:.6f}, at {opt_steps} (opt.py's) {evals[opt_steps]:.6f}; "
          f"phase 3's test PSNR {plx['psnr']:.6f} (render_imgs {out['psnr'] - plx['psnr']:+.3e} "
          f"dB: R9); main {wall:.2f} s; --timing {buf.getvalue().strip()!r}; calc_metrics on "
          f"its 8-bit PNGs against the 8-bit ground truth: PSNR {cm['psnr']:.4f} SSIM "
          f"{cm['ssim']:.4f} ({cm['psnr'] - out['psnr']:+.4f} dB)", flush=True)
    check(counts == want, f"phase 22b: launches {counts} != {want}")
    check(abs(out["psnr"] - evals[gcfg.max_steps]) <= RENDER_IMGS_TOL_DB,
          f"phase 22b: render_imgs PSNR {out['psnr']} against its config's eval "
          f"{evals[gcfg.max_steps]}")
    check(abs(evals[opt_steps] - plx["psnr"]) <= RENDER_IMGS_TOL_DB,
          f"phase 22b: the checkpoint's grid at {opt_steps} steps {evals[opt_steps]} against "
          f"phase 3's test PSNR {plx['psnr']}")
    check(timing["fps"] > 0, "phase 22b: --timing gave no FPS")
    check(abs(cm["psnr"] - out["psnr"]) <= CALC_METRICS_TOL_DB,
          f"phase 22b: calc_metrics PSNR {cm['psnr']} against render_imgs' {out['psnr']}")

    # ---- phase 22c: to_svox1 on phase 18c's 128^3 grid ----
    t0 = time.time()
    path = to_svox1.main([npz_128, "--out", os.path.join(tmp.name, "svox1.npz")])
    wall = time.time() - t0
    tree = dict(np.load(path, allow_pickle=True))
    grid, _ = load_npz(npz_128)      # on the host, as to_svox1 loads it
    reso = grid.alive.shape[0]
    alive = np.argwhere(grid.alive.numpy())
    pick = alive[np.random.default_rng(22).choice(len(alive), min(SVOX1_VOXELS, len(alive)),
                                                  replace=False)]
    dens = grid.density.numpy().astype(np.float16)
    sh = grid.sh.numpy().astype(np.float16)
    bad = sum(not (np.array_equal(leaf[:-1], sh[tuple(c)]) and leaf[-1] == dens[tuple(c)])
              for c, leaf in ((c, lookup_octree(tree, c, reso)) for c in pick))
    print(f"[phase 22c] to_svox1 on phase 18c's {reso}^3 grid ({len(alive)} alive voxels): "
          f"{tree['child'].shape[0]} nodes, {os.path.getsize(path) / 1e6:.1f} MB compressed, "
          f"{wall:.1f} s; lookup_octree at {len(pick)} seeded alive voxels: {bad} differ "
          f"from the grid cast to f16", flush=True)
    check(len(pick) > 0 and bad == 0, f"phase 22c: {bad} of {len(pick)} leaves differ")
    del tree, grid, dens, sh

    # ---- phase 22d: autotune, 2 variants of cli/opt.py in subprocesses ----
    task = {"base_args": ["synthetic", "--n_epochs", "1", "--tune_nosave", "--reso", reso_arg,
                          "--device", str(dev)],
            "train_root": os.path.join(tmp.name, "tune"),
            "grid": {"lambda_tv": [1e-5, 1e-4]}}
    task_json = os.path.join(tmp.name, "task.json")
    with open(task_json, "w") as f:
        json.dump(task, f)
    t0 = time.time()
    rows = autotune.main([task_json])
    wall = time.time() - t0
    with open(os.path.join(task["train_root"], "leaderboard.txt")) as f:
        board = f.read().splitlines()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rerun = autotune.main([task_json])
    rerun_s = time.time() - t0
    skipped = buf.getvalue().count("skip finished")
    print(f"[phase 22d] autotune of lambda_tv 1e-5, 1e-4 on `cli/opt.py synthetic --n_epochs 1 "
          f"--tune_nosave` at {RESO}^3: leaderboard {board}, {wall:.1f} s (the variants' "
          f"kernels launch in their subprocesses: not counted); the rerun skipped {skipped} in "
          f"{rerun_s:.2f} s", flush=True)
    check(len(rows) == 2 and len(board) == 2, f"phase 22d: leaderboard {board}")
    check(all(math.isfinite(p) for p, _ in rows), f"phase 22d: {rows}")
    check(skipped == 2 and "launch:" not in buf.getvalue() and rerun == rows,
          f"phase 22d: the rerun skipped {skipped}")
    tmp.cleanup()
    print(f"[phase 22] {time.time() - t_phase:.1f} s", flush=True)
    return counts_by_run


def clip_phase(dev):
    """Phase 23: CLIP guidance on NGP renders of rand_poses views, card
    against CPU, after one chunk of training (a live field) and after
    NGP_WINDOW steps (R1's dead sigma net at 2^15: every gradient exactly
    0), and main_nerf's gate.  Returns {run: launch counts}."""
    import torch
    import torch.nn.functional as F

    from flnerf_tpu_torch.cli import main_nerf
    from flnerf_tpu_torch.core.clip_guidance import CLIPGuidance
    from flnerf_tpu_torch.rays.camera import get_rays, intrinsics_matrix, rand_poses
    from flnerf_tpu_torch.render.ngp import march, ngp_render_rays, render_marched

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    trainer, sampler, _, _ = ngp_setup(tmp.name)
    _, poses, _, _, _ = main_nerf.load_ngp_dataset(main_nerf.parse_args(["synthetic", "-O"]))
    radius = float(np.linalg.norm(poses[:, :3, 3], axis=-1).mean())
    # rand_poses' forward column looks at the origin along +z (the
    # reference's convention); get_rays' camera looks along -z
    views = rand_poses(CLIP_VIEWS, np.random.default_rng(23), radius=radius) @ FLIP_YZ
    K = intrinsics_matrix(CLIP_SIZE, CLIP_SIZE, 0.9 * CLIP_SIZE)
    rays = [get_rays(CLIP_SIZE, CLIP_SIZE, K, v[:3, :4], dev) for v in views]
    o = torch.cat([r[0].reshape(-1, 3) for r in rays])
    d = torch.cat([r[1].reshape(-1, 3) for r in rays])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    # the stub encoder: average-pool 224^2 -> 8^2, a fixed map to 512
    gen = torch.Generator().manual_seed(23)
    w, text = torch.randn((3 * 64, 512), generator=gen), torch.randn((1, 512), generator=gen)

    def encoder(x):
        return F.avg_pool2d(x, 28).reshape(x.shape[0], -1) @ w.to(x.device)

    def guided(field, out):
        guide = CLIPGuidance(encoder, text.to(out["rgb"].device))
        loss = guide(out["rgb"].reshape(CLIP_VIEWS, CLIP_SIZE, CLIP_SIZE, 3))
        named = list(field.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        return float(loss), {n: (torch.zeros_like(p) if g is None else g).cpu()
                             for (n, p), g in zip(named, grads)}

    counts_by_run = {}
    for run, steps in (("23 clip at 16", trainer.cfg.steps_per_chunk),
                       ("23 clip at 256", NGP_WINDOW)):
        trainer.fit(sampler, verbose=False, n_steps=steps - trainer.step)
        rcfg = trainer.rcfg
        reset_counts()
        t0 = time.time()
        out = ngp_render_rays(trainer.field, trainer.occ, o, d, rcfg, perturb=False)
        loss_c, g_c = guided(trainer.field, out)
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) * 1e3
        counts = counts_by_run[run] = launch_counts()
        want = {k: 0 for k in counts}
        want.update({"K3": 1, "K4": 1})
        marched = march(trainer.occ, o, d, rcfg, perturb=False)
        acc = float(out["acc"].max())
        field_h = copy.deepcopy(trainer.field).to("cpu")
        loss_h, g_h = guided(field_h, render_marched(field_h, tuple(m.cpu() for m in marched),
                                                     d.cpu(), rcfg))
        norms = {k: float(g_h[k].norm()) for k in g_h}
        grad_err = {k: float((g_c[k] - g_h[k]).norm()) / norms[k] if norms[k] > 0
                    else float(g_c[k].abs().max()) for k in g_h}
        worst = max(grad_err, key=grad_err.get)
        print(f"[phase {run}] a guided step on {CLIP_VIEWS} rand_poses views at "
              f"{CLIP_SIZE}x{CLIP_SIZE} ({o.shape[0]} rays, {int(marched[1].sum())} kept "
              f"samples, max acc {acc:.4f}) of the 2^15 -O trainer after {trainer.step} steps: "
              f"launches {counts}; loss card {loss_c:.7f} CPU {loss_h:.7f}; the CPU's gradient "
              f"norms {({k: float(f'{v:.4g}') for k, v in norms.items()})}; the largest card "
              f"error {grad_err[worst]:.2e} ({worst}; norm-wise, absolute where the CPU's is 0); "
              f"step {step_ms:.1f} ms (host clock, synchronized)", flush=True)
        check(counts == want, f"phase {run}: launches {counts} != {want}")
        check(math.isfinite(loss_c) and abs(loss_c - loss_h) <= NERF_RGB_TOL,
              f"phase {run}: loss {loss_c} against the CPU's {loss_h}")
        check(grad_err[worst] <= NERF_GRAD_TOL, f"phase {run}: {worst} gradient {grad_err[worst]}")
        if run == "23 clip at 16":
            check(norms["table"] > 0, f"phase {run}: the table's gradient is 0 on the CPU")
    gate = {}
    for flags, expect in ((["--clip_text", "x"], "CLIP encoder"),
                          (["--rand_pose", "0"], "rand_pose needs --clip_text")):
        try:
            main_nerf.main(["synthetic", "--workspace", os.path.join(tmp.name, "gate")] + flags)
            gate[flags[0]] = None
        except SystemExit as e:
            gate[flags[0]] = str(e)
        check(gate[flags[0]] is not None and expect in gate[flags[0]],
              f"phase 23: main_nerf {flags} gave {gate[flags[0]]!r}")
    print(f"[phase 23] main_nerf's gate: {gate}", flush=True)
    tmp.cleanup()
    print(f"[phase 23] {time.time() - t_phase:.1f} s", flush=True)
    return counts_by_run


def loader_phases(dev):
    """Phase 24: cli/run_nerf.py on the synthetic views written as a
    LINEMOD scene (48 px) and as a deepvoxels scene (512 px, its loader's
    size), at full width for one epoch each.  Returns {run: launch counts}."""
    from flnerf_tpu_torch.cli import run_nerf
    from flnerf_tpu_torch.core.metrics import to8b
    from flnerf_tpu_torch.data.png import write_png
    from flnerf_tpu_torch.data.synthetic import load_synthetic_data

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    counts_by_run = {}

    lm = os.path.join(tmp.name, "linemod")
    os.makedirs(os.path.join(lm, "rgb"))
    images, poses, _, (H, W, focal), (tr, _, te) = load_synthetic_data(n_train=8, n_test=2,
                                                                       H=48, W=48)
    K = [[focal, 0.0, W / 2], [0.0, focal, H / 2], [0.0, 0.0, 1.0]]
    for split, idx in (("train", tr), ("val", te[:1]), ("test", te)):
        frames = []
        for i in idx:
            name = f"rgb/{split}_{i:03d}.png"
            write_png(os.path.join(lm, name), to8b(images[i]))
            frames.append({"file_path": name, "transform_matrix": poses[i].tolist(),
                           "intrinsic_matrix": K})
        with open(os.path.join(lm, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(2 * np.arctan(W / (2 * focal))),
                       "near": 2.0, "far": 6.0, "frames": frames}, f)

    dv = os.path.join(tmp.name, "deepvoxels")
    images, poses, _, (H, W, focal), _ = load_synthetic_data(n_train=1, n_test=2, H=512, W=512)
    for split, i in (("train", 0), ("validation", 1), ("test", 2)):
        base = os.path.join(dv, split, "synthetic")
        os.makedirs(os.path.join(base, "rgb"))
        os.makedirs(os.path.join(base, "pose"))
        write_png(os.path.join(base, "rgb", "0000.png"), to8b(images[i]))
        np.savetxt(os.path.join(base, "pose", "0000.txt"), poses[i].reshape(1, -1))
    with open(os.path.join(dv, "train", "synthetic", "intrinsics.txt"), "w") as f:
        f.write(f"{focal} {W / 2} {H / 2} 0.\n0 0 0\n1.\n1.\n{H}. {W}.\n0\n")
    del images

    for name, argv in (("24 LINEMOD", ["--dataset_type", "LINEMOD", "--datadir", lm]),
                       ("24 deepvoxels", ["--dataset_type", "deepvoxels", "--datadir", dv,
                                          "--shape", "synthetic"])):
        reset_counts()
        t0 = time.time()
        res = run_nerf.main(argv + ["--basedir", os.path.join(tmp.name, "logs"), "--expname",
                                    name.split()[1], "--device", str(dev), *LOADER_NERF_FLAGS])
        wall = time.time() - t0
        counts = counts_by_run[name] = launch_counts()
        h = res["history"][0]
        print(f"[phase {name}] run_nerf.main (D8 W256, 64 + 128, bf16, 1 epoch): launches "
              f"{counts}; {h['rays']} rays, train PSNR {h['train_psnr']:.3f}, test PSNR "
              f"{res['psnr']:.3f}; main {wall:.1f} s", flush=True)
        check(all(c == 0 for c in counts.values()), f"phase {name}: launched {counts}")
        check(math.isfinite(res["psnr"]), f"phase {name}: test PSNR {res['psnr']}")
    tmp.cleanup()
    print(f"[phase 24] {time.time() - t_phase:.1f} s", flush=True)
    return counts_by_run


def slice11_phases(dev, plx, batch, phase9, lattice_psnr):
    """Phases 25-28: the MSI background, NGP's background env-map, the
    Plenoxels options (off the kernel where no kernel computes them), the
    inspection tools.  ``plx``: phase 3's run (its launches, train PSNRs,
    epoch times and last quadtree); ``batch``: phase 2's (origins, dirs, rgb) training batch; ``phase9``:
    phase 9's launches; ``lattice_psnr``: its test PSNR.  Returns ({run:
    launch counts}, K2's largest error against its plain version on the
    MSI batch)."""
    import torch

    from flnerf_tpu_torch.cli import main_nerf, opt, render_imgs
    from flnerf_tpu_torch.cli import render_orbit, view_data
    from flnerf_tpu_torch.core.benchmark import BenchRecorder
    from flnerf_tpu_torch.core.logging_utils import PhaseTimers
    from flnerf_tpu_torch.data.pose_tools import inspect_epipolar_geometry
    from flnerf_tpu_torch.data.png import read_png
    from flnerf_tpu_torch.models.voxel_sh import (
        VoxelGrid,
        VoxelGridConfig,
        compose_msi_background,
        load_npz,
        max_weight_grid,
        weight_prune_grid,
    )
    from flnerf_tpu_torch.ops import voxel_kernel as vk
    from flnerf_tpu_torch.rays import visualize
    from flnerf_tpu_torch.rays.camera import get_rays_np
    from flnerf_tpu_torch.rays.quadtree import QuadTreeForest, RayBudgeter
    from flnerf_tpu_torch.rays.sharpness import sharp_image
    from flnerf_tpu_torch.render.ngp import ngp_render_image
    from flnerf_tpu_torch.train.plenoxels_trainer import PlenoxelsTrainConfig, PlenoxelsTrainer

    timers = PhaseTimers()
    tmp = tempfile.TemporaryDirectory()
    counts_by_run = {}
    zero = {k: 0 for k in launch_counts()}

    def step_ms(hist):
        """ms a step over the epochs after the first (ray generation,
        subdivision and the epoch's host sync included)."""
        later = hist[1:] or hist
        n = later[-1]["steps"] - (hist[0]["steps"] if len(hist) > 1 else 0)
        return 1e3 * sum(h["epoch_s"] for h in later) / max(n, 1)

    # ---- phase 25: the MSI background on K1/K2 ----
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "tnt.json")) as f:
        tnt = json.load(f)
    tnt_flags = [a for k, v in tnt.items() if k not in ("dataset_type", "n_epochs")
                 for a in (f"--{k}", str(v))]
    msi_flags = ["--background_nlayers", str(MSI_LAYERS), "--background_reso", str(MSI_RESO),
                 "--device", str(dev)]
    run = os.path.join(tmp.name, "msi")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with timers.phase("25 MSI fit (opt.py)"):
        res, rec = recorded(lambda: opt.main(["synthetic", "-t", run, *tnt_flags, "--n_epochs",
                                              "3", *msi_flags]))
        torch.cuda.synchronize()
    counts = counts_by_run["25 MSI fit"] = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    steps = hist[-1]["steps"]
    train = [h["train_psnr"] for h in hist]
    grid = res["grid"]
    bg_gb = grid.background.numel() * 4 / 1e9
    print(f"[phase 25] opt.main synthetic, configs/tnt.json's settings (3 epochs), "
          f"--background_nlayers {MSI_LAYERS} --background_reso {MSI_RESO} ({bg_gb:.2f} GB "
          f"background) at {RESO}^3: launches {counts} (phase 3's K1 {plx['k1']}, K2 "
          f"{plx['k2']}); steps {steps}; path {hist[-1]['path']}; train PSNR "
          f"{[round(p, 4) for p in train]} (phase 3's {[round(p, 4) for p in plx['train']]}); "
          f"test PSNR {res['psnr']:.4f}; step {step_ms(hist):.2f} ms over epochs 2-3 (phase "
          f"3's {step_ms(plx['hist']):.2f}); epoch s {[round(h['epoch_s'], 3) for h in hist]}; "
          f"peak memory {peak_gb:.2f} GB (phase 3's {plx['peak_gb']:.2f})", flush=True)
    want = plx_fit_counts(steps, K1=steps + 2, K2=steps)
    check(counts == want, f"phase 25: launches {counts} != {want}")
    check(hist[-1]["path"] == "kernel", "phase 25: the MSI fit left the kernel path")
    check(rec.get("flnerf.train.graph_steps", 0) == 0,
          f"phase 25: the MSI fit graphed {rec.get('flnerf.train.graph_steps')} steps")
    check(all(math.isfinite(p) for p in train) and train[-1] > train[0],
          f"phase 25: train PSNR {train}")
    check(math.isfinite(res["psnr"]), f"phase 25: test PSNR {res['psnr']}")
    check(float(grid.background[..., :3].abs().max()) > 0, "phase 25: the background never moved")

    # where a step of the MSI fit spends its device time: a profiled rerun
    # of one epoch without checkpoints (its launches are not counted)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        r1 = opt.main(["synthetic", "-t", os.path.join(tmp.name, "msi_prof"), *tnt_flags,
                       "--n_epochs", "1", *msi_flags, "--tune_nosave"])
        torch.cuda.synchronize()
        prof_ms = (time.time() - t0) * 1e3
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[phase 25] profiled MSI fit of 1 epoch ({r1['history'][-1]['steps']} steps, eval "
          f"included): device busy {busy:.1f} ms of {prof_ms:.1f} ms wall; top kernels by device "
          f"time:", flush=True)
    for e in events[:10]:
        print(f"[phase 25]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    del r1, prof, events

    # K2 on phase 2's batch and the trained grid, with the cotangents of
    # the composite on the trained background and on an opaque, bright one
    # (sigma 500 and colour coefficients 2 in every cell: the trained one is
    # nearly transparent and grey, so its log-T cotangent nearly cancels)
    o, d, gt = batch
    cfg = VoxelGridConfig(reso=(RESO,) * 3, radius=(SCENE_RADIUS,) * 3, max_steps=MAX_STEPS,
                          step_size=STEP, background_brightness=tnt["background_brightness"],
                          background_nlayers=MSI_LAYERS, background_reso=MSI_RESO)
    ray_in = vk.ray_inputs(cfg, o, d)
    occ = vk.skip_occupancy(grid.density, grid.alive, cfg)
    out = vk.cuvol_forward(*grid.tensors, *ray_in, cfg, occ=occ)
    opaque = grid.background.clone()
    opaque[..., :3] = 2.0
    opaque[..., 3] = 500.0
    k2_err = 0.0
    for bname, bg in (("trained", grid.background), ("opaque", opaque)):
        out_l = out.clone().requires_grad_(True)
        rgb = compose_msi_background(bg, out_l[:, 0:3], out_l[:, 4], o, d, cfg)
        (grad_out,) = torch.autograd.grad(torch.sum((rgb - gt) ** 2) / (3.0 * o.shape[0]),
                                          [out_l])
        got = vk.cuvol_backward(*grid.tensors, *ray_in, out, grad_out, cfg, occ=occ)
        dens = grid.density.clone().requires_grad_(True)
        sh = grid.sh.clone().requires_grad_(True)
        plain = torch.autograd.grad(vk.render_rays_plain(VoxelGrid(dens, sh, grid.alive), o, d,
                                                         cfg), [dens, sh], grad_out)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, plain)]
        scales = [float(b.abs().max()) for b in plain]
        go4 = float(grad_out[:, 4].abs().max())
        print(f"[phase 25] K2 on phase 2's {o.shape[0]}-ray batch, the trained grid, the "
              f"composite's cotangents on the {bname} background (largest |log-T cotangent| "
              f"{go4:.3e}, largest |rgb cotangent| {float(grad_out[:, :3].abs().max()):.3e}): "
              f"max_err density {errs[0]:.3e} (largest {scales[0]:.3e}), SH {errs[1]:.3e} "
              f"(largest {scales[1]:.3e})", flush=True)
        check(go4 > 0, f"phase 25: the composite ({bname}) sent K2 no log-T cotangent")
        for e, sc in zip(errs, scales):
            check(sc > 0 and e <= 1e-4 * sc, f"phase 25: K2 differs from the plain version by "
                                             f"{e} > 1e-4 * {sc} ({bname} background)")
        k2_err = max(k2_err, *errs)
        del out_l, rgb, grad_out, got, plain, dens, sh
    del out, occ, opaque

    ckpt = os.path.join(run, sorted(f for f in os.listdir(run) if f.endswith(".npz"))[-1])
    # the tools' time split: the npz load alone (each tool loads it once,
    # then renders the loaded grid without a trainer)
    with timers.phase("25 load_npz"):
        g_l, _ = load_npz(ckpt, device=dev)
        torch.cuda.synchronize()
    del g_l
    reset_counts()
    with timers.phase("25 render_imgs"):
        rimg = render_imgs.main([ckpt, "synthetic", "--render_dir", os.path.join(tmp.name, "ri"),
                                 "--device", str(dev)])
    counts = counts_by_run["25 render_imgs"] = launch_counts()
    check(counts == dict(zero, K1=2), f"phase 25: render_imgs launches {counts}")
    odir = os.path.join(tmp.name, "orbit")
    reset_counts()
    with timers.phase("25 render_orbit"):
        n_frames = render_orbit.main(["--ckpt", ckpt, "--out", odir, "--n_frames",
                                      str(ORBIT_FRAMES), "--H", "48", "--W", "48", "--no_gif",
                                      "--device", str(dev)])
    counts_o = counts_by_run["25 render_orbit"] = launch_counts()
    frames = [read_png(os.path.join(odir, f)) for f in sorted(os.listdir(odir))]
    print(f"[phase 25] render_imgs on {os.path.basename(ckpt)} (its background read back): "
          f"launches {counts}; mean PSNR {rimg['psnr']:.4f} (the fit's eval {res['psnr']:.4f}; "
          f"R9: load_npz marches 512 steps); render_orbit {n_frames} frames at 48x48: launches "
          f"{counts_o}; frame value range {min(int(f.min()) for f in frames)}-"
          f"{max(int(f.max()) for f in frames)}; wall s: load_npz alone "
          f"{timers.totals['25 load_npz']:.3f}, render_imgs {timers.totals['25 render_imgs']:.3f}"
          f", render_orbit {timers.totals['25 render_orbit']:.3f} (each with its own load)",
          flush=True)
    check(counts_o == dict(zero, K1=ORBIT_FRAMES) and len(frames) == n_frames == ORBIT_FRAMES,
          f"phase 25: render_orbit launches {counts_o}, {len(frames)} frames")
    check(math.isfinite(rimg["psnr"]), f"phase 25: render_imgs PSNR {rimg['psnr']}")
    msi_hist, msi_psnr = hist, res["psnr"]
    del res, grid

    # ---- phase 26: NGP's background env-map beside K3/K4 (and K6/K7) ----
    ws = os.path.join(tmp.name, "ngp_bg")
    flags = ["synthetic", "-O", *LATTICE_FLAGS, "--iters", str(NGP_ITERS),
             "--bg_radius", str(BG_RADIUS), "--workspace", ws]
    reset_counts()
    with timers.phase("26 main_nerf --bg_radius"):
        res = main_nerf.main(flags)
        torch.cuda.synchronize()
    counts = counts_by_run["26 NGP bg_radius"] = launch_counts()
    losses = [h["chunk_loss"] for h in res["history"]]
    want = dict(zero, **phase9)
    trainer, sampler, _, _ = ngp_setup(os.path.join(tmp.name, "unused"),
                                       (*LATTICE_FLAGS, "--bg_radius", str(BG_RADIUS)))
    trainer.load_checkpoint(ws)
    o_b, d_b = (torch.from_numpy(a[0]).to(dev) for a in sampler.sample_chunk(1, 4096)[:2])
    field = trainer.field
    with torch.no_grad():
        bg_card = field.background(o_b, d_b)
        field_cpu = copy.deepcopy(field).to("cpu")
        bg_cpu = field_cpu.background(o_b.cpu(), d_b.cpu())
    bg_err = float((bg_card.cpu() - bg_cpu).abs().max())
    # where the test PSNR goes: the test views rendered on the env-map (as
    # main_nerf's eval) and on the white fill of phase 9, split into the
    # pixels whose gt is the white background and the object's pixels
    args26 = main_nerf.parse_args(flags)
    imgs26, poses26, hwf26, K26, (_, _, i_test26) = main_nerf.load_ngp_dataset(args26)
    H26, W26 = int(hwf26[0]), int(hwf26[1])
    split = {}
    for fill, fn in (("env-map", field.background), ("white", None)):
        sq_w = sq_o = 0.0
        psnrs26, bg_means = [], []
        for i in i_test26:
            rgb26, _ = ngp_render_image(field, trainer.occ, trainer.rcfg, H26, W26, K26,
                                        poses26[i][:3, :4], chunk=args26.max_ray_batch,
                                        bg_fn=fn)
            gt26 = np.asarray(imgs26[i], np.float32)[..., :3]
            white = np.all(gt26 > 0.99, -1)
            err = ((rgb26 - gt26) ** 2).sum(-1)
            sq_w, sq_o = sq_w + float(err[white].sum()), sq_o + float(err[~white].sum())
            psnrs26.append(-10.0 * math.log10(float(np.mean((rgb26 - gt26) ** 2))))
            bg_means.append(float(rgb26[white].mean()))
        n_w = sum(int(np.all(np.asarray(imgs26[i])[..., :3] > 0.99, -1).sum())
                  for i in i_test26)
        n_all = len(i_test26) * H26 * W26
        split[fill] = (float(np.mean(psnrs26)), sq_w / max(3 * n_w, 1),
                       sq_o / max(3 * (n_all - n_w), 1), float(np.mean(bg_means)), n_w / n_all)
    for fill, (p26, mse_w, mse_o, mean_w, share) in split.items():
        print(f"[phase 26] the trained field on the test views with the {fill} behind it: "
              f"PSNR {p26:.4f}; MSE on the gt-white pixels ({100 * share:.1f}%) {mse_w:.6f}, "
              f"their mean rendered value {mean_w:.4f}; MSE on the object's pixels "
              f"{mse_o:.6f}", flush=True)
    print(f"[phase 26] main_nerf {' '.join(flags[:-2])}: launches {counts} (phase 9's "
          f"{phase9}); test PSNR {res['psnr']:.4f} (phase 9's, no background, "
          f"{lattice_psnr:.4f}); mean train loss per chunk first {losses[0]:.5f} last "
          f"{losses[-1]:.5f}; the trained background on 4096 rays card against CPU: max_err "
          f"{bg_err:.3e} (range {float(bg_cpu.min()):.4f}-{float(bg_cpu.max()):.4f})",
          flush=True)
    check(counts == want, f"phase 26: launches {counts} != phase 9's {want}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"phase 26: train loss {losses}")
    check(math.isfinite(res["psnr"]), f"phase 26: test PSNR {res['psnr']}")
    check(bg_err <= NERF_RGB_TOL, f"phase 26: the background differs card/CPU by {bg_err}")
    check(abs(split["env-map"][0] - res["psnr"]) <= 1e-3,
          f"phase 26: the env-map reading {split['env-map'][0]} is not main_nerf's {res['psnr']}")
    del trainer, sampler, field, field_cpu

    # ---- phase 27: the Plenoxels options: the renders no kernel computes
    # (nvol, svox1, the learned bases) on the plain path, the lumisphere TV
    # beside K1/K2 ----
    images, poses, H, W, focal, K, i_train, i_test = scene()
    rays = [get_rays_np(H, W, K, p[:3, :4]) for p in poses[i_train]]
    reso_arg = f"[[{RESO},{RESO},{RESO}]]"
    gcfg = VoxelGridConfig(reso=(RESO,) * 3, radius=(SCENE_RADIUS,) * 3, max_steps=MAX_STEPS,
                           step_size=STEP)
    options = {"nvol": None, "svox1": None,
               "3d_texture": (gcfg._replace(basis_type="3d_texture"), {}),
               "mlp": (gcfg._replace(basis_type="mlp"), {}),
               "lumisphere TV": (gcfg, {"lambda_tv_lumisphere": 1e-3,
                                        "tv_lumisphere_dir_factor": 0.5})}
    pruned = None
    for name, spec in options.items():
        reset_counts()
        with timers.phase(f"27 {name}"):
            if spec is None:
                res, rec = recorded(lambda: opt.main(
                    ["synthetic", "-t", os.path.join(tmp.name, name), "--reso", reso_arg,
                     "--n_epochs", "1", "--renderer_backend", name, "--tune_nosave",
                     "--device", str(dev)]))
                hist, psnr = res["history"], res["psnr"]
            else:
                tr = PlenoxelsTrainer(spec[0], PlenoxelsTrainConfig(n_epoch=1, **spec[1]),
                                      device=dev)
                budgeter = RayBudgeter(images[i_train], np.stack([r[0] for r in rays]),
                                       np.stack([r[1] for r in rays]), init_level=2, seed=0)
                _, rec = recorded(lambda: tr.fit(budgeter, verbose=False))
                hist = tr.history
                psnr = tr.eval_images(poses[i_test], images[i_test], H, W, K)[0]
            torch.cuda.synchronize()
        counts = counts_by_run[f"27 {name}"] = launch_counts()
        h = hist[-1]
        on_kernel = name == "lumisphere TV"
        n_eval = len(i_test) * -(-H * W // 4096)      # eval_images' chunks
        # every option sweeps density and SH on the card; only the
        # lumisphere TV renders through K1/K2
        want = (plx_fit_counts(h["steps"], K1=h["steps"] + n_eval, K2=h["steps"]) if on_kernel
                else plx_fit_counts(h["steps"]))
        h3 = plx["hist"][0]
        print(f"[phase 27] {name}: path {h['path']}; launches {counts}; {h['steps']} steps of "
              f"{BATCH} rays in {h['epoch_s']:.3f} s ({1e3 * h['epoch_s'] / h['steps']:.1f} ms a "
              f"step, the epoch's ray generation and sync included; phase 3's first epoch "
              f"{1e3 * h3['epoch_s'] / h3['steps']:.1f}, its epochs 2-3 "
              f"{step_ms(plx['hist']):.1f}); train PSNR "
              f"{h['train_psnr']:.4f}; test PSNR {psnr:.4f}", flush=True)
        check(counts == want, f"phase 27: {name} launched {counts}, not {want}")
        # a learned basis, a plain render or the lumisphere TV: never a graph
        check(rec.get("flnerf.train.graph_steps", 0) == 0,
              f"phase 27: {name} graphed {rec.get('flnerf.train.graph_steps')} steps")
        check(h["path"] == ("kernel" if on_kernel else "plain"),
              f"phase 27: {name} took the {h['path']} path")
        check(math.isfinite(h["train_psnr"]) and math.isfinite(psnr),
              f"phase 27: {name} PSNRs {h['train_psnr']}, {psnr}")
        del hist
    # max-weight pruning of phase 3's last grid (its 3 epochs), marched at
    # cli/opt.py's 1792 steps: at the default threshold (0.0256), and at a
    # tenth of the largest weight (a 3-epoch grid spreads its opacity over
    # many samples, each below the default)
    g3, c3 = load_npz(plx["ckpt"], device=dev)
    c3 = c3._replace(max_steps=MAX_STEPS)
    with timers.phase("27 weight_prune_grid"):
        pruned = weight_prune_grid(g3, c3, poses[i_train], H, W, K)
        before, after = int(g3.alive.sum()), int(pruned.alive.sum())
        torch.cuda.synchronize()
    top = float(max_weight_grid(g3, c3, poses[i_train], H, W, K).max())
    tenth = int(weight_prune_grid(g3, c3, poses[i_train], H, W, K,
                                  weight_thresh=0.1 * top).alive.sum())
    print(f"[phase 27] weight_prune_grid (dilation 2) over the {len(i_train)} training cameras "
          f"(every 2nd pixel) on phase 3's last grid: alive {before} -> {after} cells at the "
          f"default threshold 0.0256 ({timers.totals['27 weight_prune_grid']:.3f} s); the "
          f"largest sample weight {top:.4f}; at a tenth of it {tenth} cells", flush=True)
    check(after <= before and 0 < tenth < before,
          f"phase 27: weight pruning kept {after} (default) and {tenth} of {before}")
    del pruned, g3

    # ---- phase 28: the inspection tools ----
    with timers.phase("28 tools"):
        forest = QuadTreeForest.load(plx["tree"])
        sharp = np.stack([sharp_image(im) for im in images[i_train]])
        paths = visualize.save_debug_images(os.path.join(tmp.name, "debug"), images[i_train],
                                            forest, sharp, ext="png")
        overlay = read_png(paths[0])
        rec = BenchRecorder({"phase": 25, "card": smi_line()})
        for h in msi_hist:
            rec.record(wall_s=h["wall_s"], psnr=h["train_psnr"], rays=h["rays"])
        rec.record(wall_s=msi_hist[-1]["wall_s"], test_psnr=msi_psnr)
        rec.save(os.path.join(tmp.name, "bench.json"))
        rec2 = BenchRecorder.load(os.path.join(tmp.name, "bench.json"))
        target = msi_hist[1]["train_psnr"]
        kind = view_data.detect_dataset_type("synthetic")
        v_poses, v_hwf = view_data.load_scene("synthetic", kind)
        cams = view_data.cam_dict_from_poses(v_poses, v_hwf)
        a, b = (cams[f"{i:04d}"] for i in i_train[:2])
        mats = [np.asarray(c[k]).reshape(4, 4) for c in (a, b) for k in ("K", "W2C")]
        lines = inspect_epipolar_geometry((images[i_train[0]] * 255).astype(np.uint8),
                                          *mats[:2], (images[i_train[1]] * 255).astype(np.uint8),
                                          *mats[2:], n_points=8)
    print(f"[phase 28] save_debug_images: {len(paths)} PNGs of phase 3's last quadtree "
          f"({forest.n_leaves} leaves) and sharpness heat maps, overlay {overlay.shape}; "
          f"BenchRecorder over phase 25's epochs: time to {target:.3f} dB "
          f"{rec2.time_to_psnr(target):.3f} s, "
          f"{len(rec2.samples)} samples read back; view_data: {kind}, {len(cams)} cameras; "
          f"inspect_cameras' epipolar lines {lines.shape}, finite "
          f"{bool(np.isfinite(lines).all())}; their matplotlib plots not drawn", flush=True)
    check(len(paths) == 2 * len(i_train) and overlay.shape == (H, W, 3),
          f"phase 28: debug images {paths}")
    check(rec2.samples == rec.samples and rec2.time_to_psnr(target) is not None,
          "phase 28: BenchRecorder")
    check(kind == "synthetic" and len(cams) == len(v_poses) and lines.ndim == 2
          and lines.shape[1] == 3 and bool(np.isfinite(lines).all()),
          "phase 28: view_data / inspect_cameras")
    print("[phase 28] PhaseTimers over phases 25-28:\n" + "\n".join(
        f"[phase 28]   {line}" for line in timers.summary().splitlines()), flush=True)
    tmp.cleanup()
    return counts_by_run, k2_err


def graph_chunk_phase(dev, seed=0):
    """Phase 3d: one chunk at the benchmark cell's shapes (256^3, 8 steps of
    5000 rays, syn.json's rates, from step 0) trained by the trainer's CUDA
    graph replay and three times step by step, each from the same seeded
    start (10% of the cells dead).  The graph is captured on another chunk
    first, and the start is then written back into the same buffers.  The
    replay's gaps from the first step-by-step run (density and SH over the
    change that run made, both RMSProp states over their norm, the
    per-leaf statistic and the chunk MSE over that run's largest) must lie
    within 10x the largest gap between two step-by-step runs, as
    tests/test_torch_plenoxels_graph_cuda.py holds them: K2's atomics add
    in another order each run.  Returns (gaps, noise), 6 numbers each."""
    import numpy as np
    import torch
    from flnerf_tpu_torch.core.logging_utils import RECORDER
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid, VoxelGridConfig
    from flnerf_tpu_torch.rays.quadtree import RayEpoch
    from flnerf_tpu_torch.train import plenoxels_trainer as pt

    K, leaves = 8, 4096
    gcfg = VoxelGridConfig(reso=(RESO,) * 3, radius=(SCENE_RADIUS,) * 3, max_steps=MAX_STEPS,
                           step_size=STEP)
    tcfg = pt.PlenoxelsTrainConfig(batch_size=BATCH, steps_per_chunk=K)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (RESO,) * 3
    start = VoxelGrid(2.0 * torch.rand(shape, device=dev, generator=gen),
                      0.3 * torch.randn(shape + (27,), device=dev, generator=gen),
                      torch.rand(shape, device=dev, generator=gen) > 0.1)
    rng = np.random.default_rng(seed)

    def epoch():
        """A chunk of rays from a sphere around the grid toward it."""
        n = K * BATCH
        u = rng.standard_normal((n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        d = -u + 0.3 * rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        f32 = lambda a: a.astype(np.float32)
        return RayEpoch(f32(2.5 * SCENE_RADIUS * u), f32(d), f32(rng.random((n, 3))),
                        rng.integers(0, leaves, n).astype(np.int32), leaves)

    def trainer():
        t = pt.PlenoxelsTrainer(gcfg, tcfg, device=dev)
        t.state = pt.PlenoxelsState(
            VoxelGrid(start.density.clone(), start.sh.clone(), start.alive),
            torch.zeros_like(start.density), torch.zeros_like(start.sh), 0)
        return t

    def kept(t, out):
        st = t.state
        return ([x.clone() for x in (st.grid.density, st.grid.sh, st.rms_density, st.rms_sh)],
                out)

    capture_on, chunk = epoch(), epoch()
    t = trainer()
    t.run_epoch_rays(capture_on)     # warm-up and capture, in the start's buffer order
    check(len(t._graphs) == 1, f"phase 3d: {len(t._graphs)} graphs after the warm-up")
    st = t.state
    st.grid.density.copy_(start.density)
    st.grid.sh.copy_(start.sh)
    st.rms_density.zero_()
    st.rms_sh.zero_()
    t.state = st._replace(step=0)
    RECORDER.reset()
    RECORDER.enable()
    try:
        out = t.run_epoch_rays(chunk)
    finally:
        RECORDER.disable()
    graphed = RECORDER.counters.get("flnerf.train.graph_steps", 0)
    RECORDER.reset()
    check(graphed == K, f"phase 3d: {graphed} graphed steps, not {K}")
    runs = [kept(t, out)]
    del t, st
    rule = pt.graph_rule
    pt.graph_rule = lambda *a: False
    try:
        for _ in range(3):
            t = trainer()
            runs.append(kept(t, t.run_epoch_rays(chunk)))
            del t
    finally:
        pt.graph_rule = rule
    torch.cuda.synchronize()

    def gaps(a, b):
        (xa, (sa, ma)), (xb, (sb, mb)) = a, b
        row = [float(torch.linalg.vector_norm(x - y))
               / float(torch.linalg.vector_norm(y - (start.density, start.sh)[k] if k < 2 else y))
               for k, (x, y) in enumerate(zip(xa, xb))]
        fa, fb = np.isfinite(sa), np.isfinite(sb)
        check(np.array_equal(fa, fb), "phase 3d: the leaves with a statistic differ")
        row.append(float(np.abs(sa[fa] - sb[fb]).max() / np.abs(sb[fb]).max()))
        row.append(abs(ma - mb) / mb)
        return row

    gap = gaps(runs[0], runs[1])
    noise = [max(col) for col in zip(gaps(runs[2], runs[1]), gaps(runs[3], runs[1]),
                                     gaps(runs[3], runs[2]))]
    names = ("density", "SH", "density RMSProp", "SH RMSProp", "per-leaf statistic",
             "chunk MSE")
    print("[phase 3d] one 8-step chunk of 5000 rays at 256^3 by graph replay against step "
          "by step, relative gaps (the largest between step-by-step runs in brackets): "
          + "; ".join(f"{n} {g:.3e} ({z:.3e})" for n, g, z in zip(names, gap, noise)),
          flush=True)
    check(all(g <= 10 * z + 1e-6 for g, z in zip(gap, noise)),
          f"phase 3d: the replayed chunk is off step by step's: {gap} against noise {noise}")
    del runs, start
    torch.cuda.empty_cache()
    return gap, noise


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from flnerf_tpu_torch.cli import opt
    from flnerf_tpu_torch.models.voxel_sh import VoxelGrid, VoxelGridConfig, voxel_render_rays
    from flnerf_tpu_torch.ops import _build, voxel_kernel as vk
    from flnerf_tpu_torch.rays.camera import get_rays
    from flnerf_tpu_torch.train.plenoxels_trainer import coherence_order

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[phase 1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.time()
    _build.build_all()
    build_s = time.time() - t0
    for name in _build.sources():
        print(f"[phase 1] {name}.cu ptxas: " + "; ".join(ptxas_kernels(_build.build_log(name))))
    print(f"[phase 1] built {_build.sources()} in {build_s:.1f} s", flush=True)

    # ---- phase 2: K1 and K2 against the plain version, main-path shapes ----
    cfg = VoxelGridConfig(reso=(RESO,) * 3, radius=(SCENE_RADIUS,) * 3,
                          max_steps=MAX_STEPS, step_size=STEP)
    grid = sphere_grid(dev)
    images, poses, H, W, focal, K, i_train, i_test = scene()
    epoch = first_epoch(images, poses, H, W, K, i_train)
    # the trainer's first batch on the card: its order rng is seeded with 0
    first = coherence_order(epoch.px, epoch.py, epoch.img, np.random.default_rng(0))[:BATCH]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    o, d, gt = t(epoch.origins[first]), t(epoch.dirs[first]), t(epoch.rgb[first])
    eo, ed = (r.reshape(-1, 3).contiguous() for r in get_rays(H, W, K, poses[i_test[0]][:3, :4], dev))

    def render_and_grad(fn):
        dens = grid.density.clone().requires_grad_(True)
        sh = grid.sh.clone().requires_grad_(True)
        out = fn(VoxelGrid(dens, sh, grid.alive))
        # loss with an upstream gradient on log-T as well as on rgb
        loss = torch.mean((out[:, :3] - gt) ** 2) + 0.1 * torch.sum(out[:, 4])
        gd, gs = torch.autograd.grad(loss, [dens, sh])
        return out.detach(), gd, gs

    def channel_errs(a, b):
        err = (a - b).abs().amax(0).tolist()
        return {"rgb": max(err[0:3]), "depth": err[3], "log_t": err[4], "acc": err[5]}

    def check_fwd(errs, what):
        for k, tol in (("rgb", 1e-4), ("acc", 1e-4), ("log_t", 1e-4), ("depth", 1e-2)):
            check(errs[k] <= tol, f"K1 {k} differs from the plain version by "
                                  f"{errs[k]} > {tol} ({what})")

    out_k, gd_k, gs_k = render_and_grad(lambda gr: vk.render_rays_fused(gr, o, d, cfg))
    out_p, gd_p, gs_p = render_and_grad(lambda gr: vk.render_rays_plain(gr, o, d, cfg))
    torch.cuda.synchronize()
    errs = channel_errs(out_k, out_p)
    g_err = {"grad_density": float((gd_k - gd_p).abs().max()),
             "grad_sh": float((gs_k - gs_p).abs().max())}
    g_scale = {"grad_density": float(gd_p.abs().max()), "grad_sh": float(gs_p.abs().max())}
    print(f"[phase 2] {BATCH}-ray training batch: K1 max_err per channel {errs}; "
          f"K2 max_err {g_err} (scale {g_scale})", flush=True)
    check_fwd(errs, "training batch")
    for k in g_err:
        check(g_scale[k] > 0 and g_err[k] <= 1e-4 * g_scale[k],
              f"K2 {k} differs from the plain version by {g_err[k]} > 1e-4 * {g_scale[k]}")
    check(bool(torch.isfinite(out_k).all()), "K1 output not finite")
    check(float(out_k[:, 5].max()) > 0.1, "the training batch's rays miss the sphere")
    with torch.no_grad():
        eval_errs = channel_errs(vk.render_rays_fused(grid, eo, ed, cfg),
                                 vk.render_rays_plain(grid, eo, ed, cfg))
    print(f"[phase 2] {eo.shape[0]}-ray test view: K1 max_err per channel {eval_errs}",
          flush=True)
    check_fwd(eval_errs, "test view")
    for what, (ho, hd), hcfg in (
            ("the training batch", (o, d), cfg), ("the test view", (eo, ed), cfg),
            ("the training batch", (o, d), cfg._replace(sigma_thresh=0.5)),
            ("the training batch, no skip", (o, d), cfg._replace(sigma_thresh=0.0))):
        hold_k1_bitwise(grid, hcfg, ho, hd, what)
    k2_errs = [hold_k2(grid, hcfg, o, d, gt, "the training batch")
               for hcfg in (cfg, cfg._replace(sigma_thresh=0.5), cfg._replace(sigma_thresh=0.0))]
    k1_err = max(float((out_k - out_p).abs().max()), max(eval_errs.values()))
    k2_err = max(max(g_err.values()), *k2_errs)
    del out_k, out_p, gd_k, gs_k, gd_p, gs_p

    # ---- phase 3: the main path, through the CLI on the card ----
    reso_arg = f"[[{RESO},{RESO},{RESO}]]"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        # an epoch of 18,432 rays is 4 steps of 5000: at 4 steps a chunk each
        # epoch is one whole chunk, and the epochs after the first replay
        # its CUDA graph (at cli/opt.py's 8 every chunk holds dead steps)
        res, rec = recorded(lambda: opt.main(["synthetic", "-t", tmp, "--reso", reso_arg,
                                              "--n_epochs", "3", "--steps_per_chunk", "4"]))
        torch.cuda.synchronize()
        wall = time.time() - t0
        plx_counts = launch_counts()
        fwd_launches, bwd_launches = plx_counts["K1"], plx_counts["K2"]
        ckpts = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
        trees = sorted(f for f in os.listdir(tmp) if f.startswith("treeDivide_"))
        keep = tempfile.TemporaryDirectory()      # phase 22b renders the last one
        for f in ckpts[-1:] + trees[-1:]:        # phase 28 draws the last quadtree
            shutil.copy(os.path.join(tmp, f), keep.name)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    psnrs = [h["train_psnr"] for h in hist]
    steps = hist[-1]["steps"]
    graphed = rec.get("flnerf.train.graph_steps", 0)
    print(f"[phase 3] launches K1 {fwd_launches} K2 {bwd_launches} S1 {plx_counts['S1']} "
          f"(S1 pairs {plx_counts['S1 pairs']}); steps {steps}, {graphed} of them by "
          f"CUDA graph replays; "
          f"train PSNR {psnrs}; test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f}; "
          f"rays per epoch {[h['rays'] for h in hist]}, epoch s "
          f"{[round(h['epoch_s'], 4) for h in hist]}; fit with checkpoints "
          f"{res['mins'] * 60:.1f} s, main {wall:.1f} s; peak memory {peak_gb:.2f} GB; "
          f"checkpoints {ckpts}", flush=True)
    check(fwd_launches > 0 and bwd_launches > 0, "the main path launched no kernel")
    check(bwd_launches == steps, f"K2 launches {bwd_launches} != steps {steps}")
    check(plx_counts == plx_fit_counts(steps, K1=fwd_launches, K2=steps),
          f"phase 3: launches {plx_counts}: not 2 sweeps a step and the live pairs once")
    # whole chunks replay one CUDA graph each, once a warm-up chunk has run
    # (here epoch 1's; a new error-buffer size warms up again)
    check(0 < graphed < steps and rec["flnerf.train.steps"] == steps,
          f"phase 3: {graphed} graphed steps of {rec.get('flnerf.train.steps')} ({steps})")
    check(all(math.isfinite(p) for p in psnrs), f"train PSNR not finite: {psnrs}")
    check(psnrs[-1] > psnrs[0], f"train PSNR did not rise: {psnrs}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")
    check(len(ckpts) == 3, f"expected 3 checkpoints, got {ckpts}")
    plx = {"ckpt": os.path.join(keep.name, ckpts[-1]), "psnr": res["psnr"], "train": psnrs,
           "k1": fwd_launches, "k2": bwd_launches, "counts": plx_counts, "hist": hist,
           "peak_gb": peak_gb,
           "tree": os.path.join(keep.name, trees[-1])}

    # ---- phase 3b: where the main path's device time goes (a profiled
    # rerun of 2 epochs without checkpoints; its launches are not counted) ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as tmp, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        opt.main(["synthetic", "-t", tmp, "--reso", reso_arg, "--n_epochs", "2",
                  "--tune_nosave"])
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 3b] profiled main path: device busy {dev_ms:.1f} ms of "
          f"{prof_wall_ms:.1f} ms wall; top kernels by device time:")
    for e in dev_events[:10] + [e for e in dev_events[10:]
                                if "cuvol" in e.key or "tv_" in e.key]:
        print(f"[phase 3b]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    k2_prof = [e for e in dev_events if "cuvol_bwd_kernel" in e.key]
    print(f"[phase 3b] cuvol_bwd_kernel (K2) in the profile: "
          f"{sum(e.self_device_time_total for e in k2_prof) / 1e3:.3f} ms in "
          f"{sum(e.count for e in k2_prof)} launches (before: {BEFORE['K2 profile']})", flush=True)

    # ---- phase 3c: train rays/s over a longer window (epochs 2-10) ----
    with tempfile.TemporaryDirectory() as tmp:
        res10 = opt.main(["synthetic", "-t", tmp, "--reso", reso_arg, "--n_epochs", "10",
                          "--tune_nosave"])
    hist, trained = res10["history"], res10["grid"]
    del res10
    window = hist[1:]
    rates = [h["rays"] / h["epoch_s"] for h in window]
    win_rays = sum(h["rays"] for h in window)
    win_s = sum(h["epoch_s"] for h in window)
    print(f"[phase 3c] train rays/s over epochs 2-{len(hist)}: {win_rays / win_s:.1f} "
          f"({win_rays} rays, {hist[-1]['steps'] - hist[0]['steps']} steps in {win_s:.4f} s "
          f"of epochs); per epoch min {min(rates):.1f} max {max(rates):.1f}; "
          f"train PSNR {hist[0]['train_psnr']:.2f} -> {hist[-1]['train_psnr']:.2f}", flush=True)

    # ---- phase 3d: a replayed chunk against step by step at 256^3 ----
    graph_chunk_phase(dev)

    # ---- phase 4: times on phase 2's training batch ----
    k1_ms, k2_ms = kernel_ms(grid, cfg, o, d, gt)
    zero_ms = cuda_ms(lambda: (torch.zeros_like(grid.density), torch.zeros_like(grid.sh)), 10)
    with torch.no_grad():
        plain_fwd_ms = cuda_ms(lambda: voxel_render_rays(grid, o, d, cfg), 5)
    dens = grid.density.clone().requires_grad_(True)
    sh = grid.sh.clone().requires_grad_(True)
    out_g = vk.render_rays_plain(VoxelGrid(dens, sh, grid.alive), o, d, cfg)
    grad_out = upstream_grad(out_g.detach(), gt)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [dens, sh], grad_out,
                                                       retain_graph=True), 5)
    del out_g, dens, sh

    n_samples, n_cells, n_alive = work_counts(grid, cfg, o, d)
    ray_bytes = BATCH * (3 + 3 + 1 + 1 + 1 + 9) * 4
    # unique bytes: each touched alive cell's density + 27 SH (f32) read,
    # each touched cell's alive byte, the per-ray inputs, the [N,8] output;
    # K2 also reads K1's output and the upstream gradient and writes each
    # touched alive cell's 28 gradients once (the zero-fill of the rest of
    # the dense gradients is timed apart)
    k1_bytes = n_alive * 4 * 28 + n_cells + ray_bytes + BATCH * 32
    k2_bytes = k1_bytes + BATCH * 32 + n_alive * 4 * 28
    bounds = {}
    for name, nbytes, flops in (("K1 every sample", k1_bytes, n_samples * FWD_FLOPS_PER_SAMPLE),
                                ("K2", k2_bytes, n_samples * BWD_FLOPS_PER_SAMPLE)):
        bounds[name] = bound_of(nbytes, flops)
    zero_bound = grid.density.numel() * 4 * 28 / HBM_BYTES_PER_S * 1e3
    # K1 with the skip and the gate: what this data needs is each touched
    # cell's alive byte and density where a sample lies in a marked block,
    # the SH only of the touched cells alive with density > 0, the
    # occupancy once, the per-ray inputs and the output; a kept sample's
    # full arithmetic, a gated one's density pass
    # K2 with the skip and the gate: the alive byte and density of the same
    # touched cells, the SH of the alive corner cells of kept samples, a
    # read and a write of those cells' 28 gradients, the occupancy, the
    # per-ray inputs, K1's output and the upstream gradient; a kept
    # sample's full backward arithmetic, a gated one's density pass
    from flnerf_tpu_torch.tools import voxel_probe
    k1_stats, k1_probe, k2_stats = {}, {}, {}
    for gname, g in (("the phase-2 sphere grid", grid),
                     ("the main path's grid after phase 3c's 10 epochs", trained)):
        c = voxel_probe.sample_counts(g, cfg, o, d)
        pm = voxel_probe.probe(g, cfg, o, d)
        out_g = vk.cuvol_forward(*g.tensors, *vk.ray_inputs(cfg, o, d), cfg)
        pb = voxel_probe.probe_backward(g, cfg, o, d, upstream_grad(out_g, gt))
        del out_g
        k2_same = kernel_ms(g, cfg, o, d, gt)[1]
        occ_bytes = math.prod(vk.occupancy_shape(cfg.reso))
        sb = bound_of(c["touched_cells"] * 5 + c["sh_cells"] * 4 * 27 + occ_bytes + ray_bytes
                      + BATCH * 32, c["kept"] * FWD_FLOPS_PER_SAMPLE
                      + c["gated"] * DENSITY_FLOPS_PER_SAMPLE)
        sb2 = bound_of(c["touched_cells"] * 5 + c["kept_cells"] * 4 * (27 + 2 * 28) + occ_bytes
                       + ray_bytes + 2 * BATCH * 32, c["kept"] * BWD_FLOPS_PER_SAMPLE
                       + c["gated"] * DENSITY_FLOPS_PER_SAMPLE)
        k1_stats[gname], k1_probe[gname] = (c, sb), pm
        k2_stats[gname] = (k2_same, sb2)
        left = 1.0 - c["skipped"] / c["samples"]
        print(f"[phase 4] K1 on {gname}: {100 * c['marked_blocks']:.2f}% of the 8^3 blocks "
              f"marked; of {c['samples']} marched samples {100 * c['skipped'] / c['samples']:.2f}% "
              f"skipped (in unmarked blocks), {100 * c['gated'] / c['samples']:.2f}% gated (in "
              f"marked blocks, sigma < sigma_thresh), {100 * c['kept'] / c['samples']:.2f}% kept; "
              f"{100 * left:.2f}% left in marked blocks; the longest ray marches {c['longest_steps']} "
              f"steps, {c['longest_marked_steps']} of them in marked blocks; "
              f"{c['touched_cells']} touched cells, {c['sh_cells']} alive with density > 0",
              flush=True)
        print(f"[phase 4] K1 probe (flnerf_tpu_torch/tools/voxel_probe.py) on {gname}, ms by "
              f"events / device ms: " + "; ".join(f"{k} {ev:.4f} / {dt:.4f}"
                                                  for k, (ev, dt) in pm.items()), flush=True)
        print(f"[phase 4] finding, {gname}: {voxel_probe.finding(pm)}; K1's bound with the skip "
              f"{sb[0]:.4f} ms by {sb[1]}", flush=True)
        print(f"[phase 4] K2 on {gname}: {c['kept']} kept samples, "
              f"{100 * c['repeated'] / max(c['kept'], 1):.2f}% of them in the floor cell of the "
              f"previous kept sample of their ray (what a merge folds); {c['kept_cells']} alive "
              f"corner cells of kept samples; K2 through its wrapper, the forward's occupancy "
              f"passed, {k2_same:.4f} ms (before: {BEFORE['K2 sphere' if grid is g else 'K2 trained']}"
              f"); its bound with the skip {sb2[0]:.4f} ms by {sb2[1]}", flush=True)
        print(f"[phase 4] K2 probe (flnerf_tpu_torch/tools/voxel_probe.py) on {gname}, ms by "
              f"events / device ms: " + "; ".join(f"{k} {ev:.4f} / {dt:.4f}"
                                                  for k, (ev, dt) in pb.items()), flush=True)
        print(f"[phase 4] finding, {gname}: {voxel_probe.finding_backward(pb)}", flush=True)
    bounds["K1"] = k1_stats["the phase-2 sphere grid"][1]
    sphere_k2, trained_k2 = (k2_stats["the phase-2 sphere grid"],
                             k2_stats["the main path's grid after phase 3c's 10 epochs"])
    dens = trained.density.clone().requires_grad_(True)
    sh = trained.sh.clone().requires_grad_(True)
    out_g = vk.render_rays_plain(VoxelGrid(dens, sh, trained.alive), o, d, cfg)
    grad_out = upstream_grad(out_g.detach(), gt)
    plain_bwd_trained_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [dens, sh], grad_out,
                                                               retain_graph=True), 5)
    del out_g, dens, sh
    print(f"[phase 4] training batch: {n_samples} marched samples, {n_cells} distinct corner "
          f"cells ({n_alive} alive); K1 {k1_ms:.4f} ms through its wrapper, the occupancy build "
          f"included (before: {BEFORE['K1']}; plain {plain_fwd_ms:.3f} ms, bound "
          f"{bounds['K1'][0]:.4f} ms by {bounds['K1'][1]} with the skip, "
          f"{bounds['K1 every sample'][0]:.4f} ms by {bounds['K1 every sample'][1]} for every "
          f"sample); K2 body {k2_ms:.4f} ms (plain backward {plain_bwd_ms:.3f} ms, on the "
          f"trained grid {plain_bwd_trained_ms:.3f} ms; bound for every sample "
          f"{bounds['K2'][0]:.4f} ms); K2's zero-fill of the "
          f"dense gradients {zero_ms:.4f} ms (bound {zero_bound:.4f} ms); K1 launches per "
          f"train step {fwd_launches / steps:.3f} ({fwd_launches - bwd_launches} of "
          f"{fwd_launches} are the test renders)", flush=True)
    del trained

    # ray order: the budgeter's shuffle against the trainer's coherence
    # order (train batches), raster against morton order (eval chunks)
    batches = {"train 48x48 shuffled": (t(epoch.origins[:BATCH]), t(epoch.dirs[:BATCH])),
               "train 48x48 coherent": (o, d)}
    for k, v in wide_batches(poses, i_train, 800, dev).items():
        batches[f"train 800x800 {k}"] = v
    for size in (48, 800):
        for k, v in eval_chunks(poses[i_test[0]], size, 4096, dev).items():
            batches[f"eval {size}x{size} {k}"] = v
    for name, (bo, bd) in batches.items():
        ms1, ms2 = kernel_ms(grid, cfg, bo, bd, torch.full_like(bo, 0.5))
        ns, nc, _ = work_counts(grid, cfg, bo, bd)
        print(f"[phase 4] order {name}: K1 {ms1:.4f} ms, K2 body {ms2:.4f} ms "
              f"({ns} samples, {nc} distinct cells)", flush=True)

    # ---- phase 4b: S1, the dense TV + RMSProp sweep, and its live pairs
    # against their plain versions at the main path's 256^3, beside their
    # bounds and the autograd passes the sweep replaced ----
    from flnerf_tpu_torch.tools import tv_rmsprop_probe
    s1 = {(f, frac): tv_rmsprop_probe.probe_field(f, RESO, frac, 20)
          for f in tv_rmsprop_probe.FIELDS for frac in (1.0, 0.9)}
    for (f, frac), r in s1.items():
        print(f"[phase 4b] S1 on {f} {r['shape']}, {100 * frac:.0f}% alive: bit for bit its "
              f"plain version at its TV weight {r['exact']}, at weight 0 {r['exact_weight0']}, "
              f"with the rate read from a device table (the graph replays' form) "
              f"{r['exact_lr_table']}, at weight 0 {r['exact_lr_table_weight0']} "
              f"(max abs err {r['max_abs_err']:.3e}); {r['kernel_ms']:.4f} ms, the table's "
              f"rate {r['kernel_lr_table_ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} ms by its {r['bytes']} bytes, {r['roofline_pct']:.1f}%), "
              f"weight 0 {r['rmsprop_only_ms']:.4f} ms; plain {r['plain_ms']:.3f} ms; the "
              f"replaced autograd tv_loss + _rmsprop {r['replaced_ms']:.3f} ms; live_pairs "
              f"{r['pairs_ms']:.4f} ms (bound {r['pairs_bound_ms']:.4f}, plain "
              f"{r['pairs_plain_ms']:.3f}), equal to the plain pairs {r['pairs_exact']}",
              flush=True)
        check(r["exact"] and r["exact_weight0"] and r["exact_lr_table"]
              and r["exact_lr_table_weight0"],
              f"S1 differs from its plain version on {f}, {frac} alive: {r['max_abs_err']}")
        check(r["pairs_exact"], f"live_pairs differs from its plain version, {frac} alive")


    # ---- phase 5: K3 and K4 against the plain version, NGP main-path shapes ----
    from flnerf_tpu_torch.ops import hash_kernel as hk
    ngp_tmp = tempfile.TemporaryDirectory()
    trainer, sampler, n_test, n_hwf = ngp_setup(ngp_tmp.name)
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)    # steps 1-256
    # the next batch the trainer draws, through the trainer's own loss: the
    # encoding's input (the kept samples) and its real upstream gradient are
    # read at the hash_encode call
    x_batch, g_train = next_batch_encode(trainer, sampler, t, "hash_encode")
    g_train = g_train.contiguous()
    spec = trainer.field.spec
    table = trainer.field.table.detach().clone()
    gen = torch.Generator(device=dev).manual_seed(1)
    x_refresh = refresh_chunk(trainer, gen)
    # a dense N(0, 1) upstream gradient: every point adds its atomics
    g_dense = torch.randn((x_batch.shape[0], spec.output_dim), generator=gen, device=dev)
    k3_err, k4_err = hold_hash_kernels(spec, table, [
        ("the train batch, the train gradient", x_batch, g_train),
        ("the train batch, a dense gradient", x_batch, g_dense),
        ("the refresh chunk, a dense gradient", x_refresh,
         torch.randn((x_refresh.shape[0], spec.output_dim), generator=gen, device=dev))],
        "phase 5")
    print(f"[phase 5] table after {NGP_WINDOW} steps: max |entry| "
          f"{float(table.abs().max()):.4f}, mean |entry| {float(table.abs().mean()):.3e}",
          flush=True)

    # ---- phase 6: the NGP main path, through the CLI on the card ----
    from flnerf_tpu_torch.cli import main_nerf
    hk.reset_launch_counts()
    vk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        res = main_nerf.main(["synthetic", "-O", "--iters", str(NGP_ITERS),
                              "--workspace", tmp])
        torch.cuda.synchronize()
        ngp_wall = time.time() - t0
        h_fwd, h_bwd = hk.HASH_FWD_LAUNCHES, hk.HASH_BWD_LAUNCHES
        with open(os.path.join(tmp, "results.txt")) as f:
            results = f.read().split()
    ngp_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_ngp, ngp_psnr = res["steps"], res["psnr"]
    losses = [h["chunk_loss"] for h in res["history"]]
    want_fwd, n_refresh, n_eval = expected_hash_launches(trainer, len(n_test), n_hwf)
    print(f"[phase 6] launches K3 {h_fwd} K4 {h_bwd} (K1 {vk.FWD_LAUNCHES}, K2 "
          f"{vk.BWD_LAUNCHES}); steps {steps_ngp}, refresh chunks {n_refresh}, eval chunks "
          f"{n_eval}; mean train loss per chunk first {losses[0]:.5f} last {losses[-1]:.5f} "
          f"(min {min(losses):.5f} max {max(losses[1:]):.5f} after the first); "
          f"test PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f}; "
          f"main {ngp_wall:.1f} s; peak memory {ngp_peak_gb:.2f} GB; results.txt "
          f"{results}", flush=True)
    check(h_bwd == steps_ngp == NGP_ITERS, f"K4 launches {h_bwd} != steps {steps_ngp}")
    check(h_fwd == want_fwd, f"K3 launches {h_fwd} != steps + refresh + eval chunks "
                             f"{want_fwd}")
    check(vk.FWD_LAUNCHES == vk.BWD_LAUNCHES == 0, "the NGP path launched a cuvol kernel")
    check(all(math.isfinite(v) for v in losses), f"train loss not finite: {losses}")
    # the first chunk's mean holds the fall from the initial field; after
    # it, this configuration sits on the reference's plateau (fault R1)
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(math.isfinite(res["psnr"]), f"test PSNR not finite: {res['psnr']}")

    # train rays/s over steps 257-512: phase 5's trainer, a second fit
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.fit(sampler, verbose=False, n_steps=NGP_WINDOW)
    torch.cuda.synchronize()
    win_s = time.time() - t0
    print(f"[phase 6] train rays/s over steps {NGP_WINDOW + 1}-{2 * NGP_WINDOW}: "
          f"{NGP_WINDOW * trainer.cfg.batch_rays / win_s:.1f} ({NGP_WINDOW} steps, "
          f"{NGP_WINDOW // trainer.cfg.steps_per_chunk} partial refreshes, {win_s:.3f} s); "
          f"loss {trainer.history[-1]['loss']:.5f}", flush=True)

    # ---- phase 6b: where the NGP step's device time goes ----
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.fit(sampler, verbose=False, n_steps=NGP_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    dev_events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    print(f"[phase 6b] profiled NGP fit of {NGP_PROFILE_STEPS} steps: device busy "
          f"{dev_ms:.1f} ms of {prof_wall_ms:.1f} ms wall ({100 * dev_ms / prof_wall_ms:.1f}%); "
          f"top kernels by device time:")
    for e in dev_events[:12] + [e for e in dev_events[12:] if "hash_" in e.key]:
        print(f"[phase 6b]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    ngp_tmp.cleanup()

    # ---- phase 7: K3 and K4 times on phase 5's batch ----
    n_pts = x_batch.shape[0]
    k3_ms = cuda_ms(lambda: hk.hash_encode_forward(x_batch, table, spec), 20)
    grad_buf = torch.zeros((spec.num_levels, spec.t_cap, 2), device=dev)
    k4_ms = cuda_ms(lambda: hk.hash_encode_backward(x_batch, g_train, spec,
                                                    grad_table=grad_buf), 20)
    k4_dense_ms = cuda_ms(lambda: hk.hash_encode_backward(x_batch, g_dense, spec,
                                                          grad_table=grad_buf), 20)
    k4_zero_ms = cuda_ms(lambda: torch.zeros((spec.num_levels, spec.t_cap, 2), device=dev), 20)
    with torch.no_grad():
        k3_plain_ms = cuda_ms(lambda: hk.hash_encode_plain(x_batch, table, spec), 5)
    tp = table.clone().requires_grad_(True)
    out_g = hk.hash_encode_plain(x_batch, tp, spec)
    k4_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_train,
                                                      retain_graph=True), 5)
    k4_dense_plain_ms = cuda_ms(lambda: torch.autograd.grad(out_g, [tp], g_dense,
                                                            retain_graph=True), 5)
    del out_g, tp
    # what this batch's data needs: distinct table entries its corners touch
    # (K3), and those of the points with a nonzero upstream gradient (K4)
    idx, _ = hk.corner_indices_weights(x_batch, spec)
    lvl = torch.arange(spec.num_levels, device=dev)[:, None] * spec.t_cap
    touched = int((idx + lvl).unique().numel())
    live = (g_train != 0).any(-1)
    live_pts = int(live.sum())
    touched_live = int((idx.reshape(spec.num_levels, n_pts, 8)[:, live].reshape(
        spec.num_levels, -1) + lvl).unique().numel())
    del idx
    L2 = spec.num_levels
    # K4 on the dense gradient: every point adds its atomics, every touched
    # entry is read and written (the body adds into the gradient); on the
    # train gradient only the entries of the points it reaches
    k3_bytes = n_pts * 12 + n_pts * L2 * 8 + touched * 8
    k4_bytes = n_pts * 12 + n_pts * L2 * 8 + touched * 16
    k4_train_bytes = n_pts * 12 + n_pts * L2 * 8 + touched_live * 16
    for name, nbytes, flops in (("K3", k3_bytes, n_pts * L2 * K3_FLOPS),
                                ("K4", k4_bytes, n_pts * L2 * K4_FLOPS),
                                ("K4 train", k4_train_bytes, live_pts * L2 * K4_FLOPS)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    zero_bound = spec.num_levels * spec.t_cap * 8 / HBM_BYTES_PER_S * 1e3
    print(f"[phase 7] train batch: {n_pts} points x {L2} levels, {touched} distinct table "
          f"entries touched ({touched_live} by the {live_pts} points with a gradient); L2 "
          f"gather volume {n_pts * L2 * 8 * 8 / 1e6:.1f} MB (8 corners x 8 B per point and "
          f"level); K3 {k3_ms:.4f} ms (before: {BEFORE['K3']}; plain {k3_plain_ms:.3f} ms, "
          f"bound {bounds['K3'][0]:.4f} ms by {bounds['K3'][1]}); K4 body on the dense "
          f"gradient {k4_dense_ms:.4f} ms (before: {BEFORE['K4 dense']}; plain backward "
          f"{k4_dense_plain_ms:.3f} ms, bound {bounds['K4'][0]:.4f} ms by {bounds['K4'][1]}), "
          f"on the train gradient {k4_ms:.4f} ms (before: {BEFORE['K4 train']}; plain "
          f"backward {k4_plain_ms:.3f} ms, bound "
          f"{bounds['K4 train'][0]:.4f} ms by {bounds['K4 train'][1]}); K4's zero-fill "
          f"{k4_zero_ms:.4f} ms (bound {zero_bound:.4f} ms); launches per train step K3 "
          f"{h_fwd / steps_ngp:.4f}, K4 {h_bwd / steps_ngp:.4f}", flush=True)

    # K3 and K4 held on a contention input (every point in a few level-0
    # cells), a non-contiguous gradient (a column slice, read in place),
    # zero gradients, a ragged last tile, one point and none
    from flnerf_tpu_torch.tools import hash_probe
    x_cl = hash_probe.clustered(REFRESH_CHUNK, gen, dev)
    g_cl = torch.randn((x_cl.shape[0], spec.output_dim), generator=gen, device=dev)
    g_wide = torch.randn((n_pts, spec.output_dim + 8), generator=gen, device=dev)
    g_zero = torch.zeros_like(g_dense)
    e3, e4 = hold_hash_kernels(spec, table, [
        ("clustered points (4 level-0 cells), a dense gradient", x_cl, g_cl),
        ("clustered points, a zero gradient", x_cl, torch.zeros_like(g_cl)),
        ("the train batch, a dense gradient as a column slice", x_batch,
         g_wide[:, 4:4 + spec.output_dim]),
        ("the train batch, a zero gradient", x_batch, g_zero),
        ("a ragged last tile (1000 points)", x_batch[:1000], g_dense[:1000]),
        ("one point", x_batch[:1], g_dense[:1]),
        ("no point", x_batch[:0], g_dense[:0])], "phase 7")
    k3_err, k4_err = max(k3_err, e3), max(k4_err, e4)
    print_probe("phase 7", "the 2^15 train batch", hash_probe.probe(
        x_batch, table, spec, {"train": g_train, "dense": g_dense, "zero": g_zero}),
        ("train", "dense", "zero"))
    print_probe("phase 7", "the clustered points", hash_probe.probe(
        x_cl, table, spec, {"clustered": g_cl}), ("clustered",))
    del x_cl, g_cl, g_wide, g_zero

    src = "flnerf_tpu_torch/ops/csrc/voxel_cuvol.cu"
    hsrc = "flnerf_tpu_torch/ops/csrc/hash_encode.cu"
    tsrc = "flnerf_tpu_torch/ops/csrc/tv_rmsprop.cu"
    s1_sh, s1_density = s1[("sh", 1.0)], s1[("density", 1.0)]
    kernels = [
        {"name": "cuvol_forward (K1)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/voxel_pallas.py:430", "launches": fwd_launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": plain_fwd_ms,
         "bound_ms": bounds["K1"][0], "bound_by": bounds["K1"][1], "library_ms": None},
        {"name": "cuvol_backward (K2)", "route": "cuda", "source": src,
         "replaces": "flnerf_tpu/ops/voxel_pallas.py:511", "launches": bwd_launches,
         "max_abs_err": k2_err, "ms": trained_k2[0], "plain_ms": plain_bwd_trained_ms,
         "bound_ms": trained_k2[1][0], "bound_by": trained_k2[1][1], "library_ms": None,
         "sphere_ms": sphere_k2[0], "sphere_bound_ms": sphere_k2[1][0]},
        {"name": "hash_encode_forward (K3)", "route": "cuda", "source": hsrc,
         "replaces": "flnerf_tpu/ops/hash_pallas.py:142", "launches": h_fwd,
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": bounds["K3"][0], "bound_by": bounds["K3"][1], "library_ms": None},
        {"name": "hash_encode_backward (K4)", "route": "cuda", "source": hsrc,
         "replaces": "flnerf_tpu/ops/hash_pallas.py:185", "launches": h_bwd,
         "max_abs_err": k4_err, "ms": k4_dense_ms, "plain_ms": k4_dense_plain_ms,
         "bound_ms": bounds["K4"][0], "bound_by": bounds["K4"][1], "library_ms": None},
        # port only: the JAX package leaves the TV and RMSProp to XLA
        {"name": "tv_rmsprop (S1)", "route": "cuda", "source": tsrc, "replaces": None,
         "launches": plx["counts"]["S1"],
         "max_abs_err": max(r["max_abs_err"] for r in s1.values()),
         "ms": s1_sh["kernel_ms"], "plain_ms": s1_sh["plain_ms"],
         "bound_ms": s1_sh["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "replaced_ms": s1_sh["replaced_ms"], "density_ms": s1_density["kernel_ms"],
         "density_bound_ms": s1_density["bound_ms"],
         # the form the graph replays launch: bit for bit the plain version too
         "lr_table_exact": all(r["exact_lr_table"] and r["exact_lr_table_weight0"]
                               for r in s1.values()),
         "lr_table_ms": s1_sh["kernel_lr_table_ms"]},
        {"name": "live_pairs (S1 pairs)", "route": "cuda", "source": tsrc, "replaces": None,
         "launches": plx["counts"]["S1 pairs"],
         "max_abs_err": 0.0,                  # held equal in phase 4b
         "ms": s1_sh["pairs_ms"], "plain_ms": s1_sh["pairs_plain_ms"],
         "bound_ms": s1_sh["pairs_bound_ms"], "bound_by": "bytes", "library_ms": None},
    ]
    del trainer, sampler, x_batch, x_refresh, g_train, g_dense, table, grad_buf
    lattice_psnr, lattice_k5_err, phase9, lattice_rows = lattice_phases(dev, t)
    sorted_rows = sorted_phases(dev, t, {"2^15, xor hash (phase 6)": ngp_psnr,
                                         "2^19, lattice hash (phase 9)": lattice_psnr},
                                lattice_k5_err)
    kernels += sorted_rows[:2] + lattice_rows + sorted_rows[2:]
    nerf_tar = os.path.join(keep.name, "nerf.tar")
    npz_128 = os.path.join(keep.name, "opt128.npz")
    nerf_phases(dev, keep_tar=nerf_tar)
    nerfpp_phases(dev)
    tensorf_phases(dev)
    dnerf_counts, dnerf_errs = dnerf_phases(dev, t, ngp_psnr)
    sdf_counts, sdf_errs = sdf_phases(dev, nerf_tar, keep_npz=npz_128)
    resunet_phase(dev)
    gui_counts = gui_phases(dev)
    ddp_counts = ddp_phases(dev)
    tools_counts = tools_phases(dev, plx, npz_128)
    clip_counts = clip_phase(dev)
    loader_counts = loader_phases(dev)
    slice11_counts, msi_k2_err = slice11_phases(dev, plx, (o, d, gt), phase9, lattice_psnr)
    keep.cleanup()
    # each kernel's launches on the paths of slices 8-11 (phases 17b, 18b,
    # 20-28), beside the main path's; K2's and K3/K4's error over every
    # input they were held on
    runs = {**dnerf_counts, **sdf_counts, **gui_counts, **ddp_counts, **tools_counts,
            **clip_counts, **loader_counts, **slice11_counts}
    for row in kernels:
        k = re.search(r"\((K\d|S1 pairs|S1)", row["name"]).group(1)
        row["launches_by_path"] = {run: c[k] for run, c in runs.items()}
        if k in ("K3", "K4"):
            i = 0 if k == "K3" else 1
            row["max_abs_err"] = max(row["max_abs_err"], dnerf_errs[i], sdf_errs[i])
        if k == "K2":
            row["max_abs_err"] = max(row["max_abs_err"], msi_k2_err)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
