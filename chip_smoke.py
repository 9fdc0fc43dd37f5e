#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py                  # the check
    python3 chip_smoke.py --profile DIR    # also profile the lanes and paths into DIR

Drives ``darsia_tpu_torch`` only (no JAX; OpenCV for the contours of
phase L and the photographs, videos and EMD of phase M), from the root of a
checkout, in phases; any failure raises and exits non-zero:

1. Build the kernels K1 (``csrc/warp_rows_t.cu``), K2 and K3
   (``csrc/warp_rows.cu``), one nvcc per source started together, sm_90a;
   print the card's name and power limit.
2. K1 against its plain PyTorch version on the card, at the schedule-test
   shapes and both production passes of a 1788x3180 frame (D=120): max |diff|
   <= 1e-6; time both at the production passes, and the library call that
   computes K1's function (one ``F.grid_sample`` of the (1, C, R, W_in)
   data on a (1, W_out, R, 2) grid of entries (cols[r, j], r), bilinear,
   border, ``align_corners=True``: the (C, W_out, R) output; its max |diff|
   to K1 printed, below 1e-2).
3. K2 and K3 against their plain version (``warp_rows_reference``) at the
   schedule-test shapes, a ragged case, a violated bound and the 4K row case
   (3 channels folded into rows, 5364x3180, D=120 and D=30): max |diff| <=
   1e-6, and K2 == K3 == K1 transposed (shared cols), bitwise; time both
   schedules, the plain version and the library call that computes the same
   row resample (one ``F.grid_sample`` on the (1, 1, R, W_in) rows, y on the
   row centres, x the clipped cols; its max |diff| to K2 printed) at the 4K
   cases.  Then the warp_rows
   path: every launch count set to 0, ``warp_rows`` called at the two 4K
   cases on each schedule, the counts read.
4. The two-pass warp against the exact gather warp on the 4K curvature field
   of the bench configuration, interior [8:-8, 8:-8], within the bench gate
   (mean < 2e-3, p99.9 < 0.05, max < 0.45).
5. The production path ``FusedAnalysisPipeline`` (translation + curvature
   correction -> 8x16-patch registration -> concentration with 10 Jacobi
   sweeps) on a seeded synthetic 1788x3180 uint8 frame: 1 warm-up frame, then
   3 windows of 5 timed frames (ms/frame: all 15 frames over all their time;
   each window's printed beside it), exactly 4 K1 launches per frame, finite
   output of the corrected shape, the staged public objects (corrected Image -> ImageRegistration ->
   ConcentrationAnalysis) within mean |diff| <= 1e-3 (the bench's full-path
   gate), and the same frame with K1 swapped for its plain version within
   mean |diff| <= 1e-5.
6. The single-warp lane (``single_warp=True``) of the same configuration,
   timed as in 5, exactly 4 K1 launches per frame, finite
   output of the corrected shape, the blob gate of bench.py:207-237 against
   the two-warp lane (blob_rel_err <= 5e-2, noise_ratio <= 1.3), and the frame
   with plain K1 within mean |diff| <= 1e-5.
7. The series lane: an 8-frame (1788, 3180, 8, 3) uint8 series (rolled as
   bench.py:254-257 rolls it) through both lanes, 3 timed runs each
   (ms/frame: all 24 frames over all their time): exactly 32 K1 launches per
   series, each frame equal to that lane's single-frame call.
8. The flexible registration lane (``ImageRegistration(..., fused=False)``) on
   the staged corrected probe: 2 K1 launches per call (ms per call, median of
   5), the registered frame against plain K1 within mean |diff| <= 1e-5, its
   field against the fused lane's on the same frame (every patch passing)
   within 2e-3 px (twice tests/test_torch_registration.py's FUSED_TPS_ERR_4K),
   and displacement(), apply() and evaluate() in both units finite and of the
   right shape.
9. ``registration.displacement()`` after a two-warp pipeline frame (4 K1
   launches) against the flexible field built from the frame's staged
   shifts: max |diff| <= 1e-5 px.
10. Multiscale registration (``num_levels=3``): 6 K1 launches per call (one
   warp per level; ms per call, median of 5), against plain K1 within mean
   |diff| <= 1e-5.
11. Series correction: an 8-frame (1788, 3180, 8, 3) uint8 series built with
   ``transformations=[translation, curvature]``: 2 K1 launches per series (the
   frames folded into K1's channels; ms per series, median of 5), every frame
   bitwise equal to the frame corrected alone; the folded warp and a frame
   loop of warps timed beside each other.
12. Series concentration: ``ConcentrationAnalysis`` with 2 extra baselines
   (the cleaning filter) on the corrected series, every frame equal to its
   single-frame result.
13. K1 alone where the frame runs it, on the frame's own data and fields (one
   frame of each lane, recorded at the wrapper): the correction chain's field
   at its bound and the registration's TPS field at D=120 (C=3), the
   single-warp lane's gray warp (C=1) and its composed colour warp, and the
   registration field stretched 1.5x (a violated bound), the series
   correction's pair (C = 24), the drift + curvature chain's pair at its
   own bound (static + 1 + 64, C = 3), a drifting series' per-frame pair,
   and the colour checker crop's pair (its warp to the checker's aspect
   ratio in a rig reading call), and the piecewise perspective's pair at
   the bound derived from its field: bitwise against the plain version,
   timed (ms, GB/s, share of the bound, launch geometry) beside K1's
   library call on the same data and field (phase 2).
14. The rig's reading path (``presets/workflows/rig.py:103-214`` of the JAX
   package): the bench frame with a 4x6 checker of the post-2014 reference
   swatches painted at (200, 2600), 60 px per swatch; ``find_colorchecker``
   on it within 16 px of the painted corners; shape corrections [Resize,
   DriftCorrection (ROI from the finder), CurvatureCorrection]; on the
   corrected baseline the finder again, ``IlluminationCorrection`` (width
   100, 30 samples, seed 42, hsl-scalar, illumination, outliers 0.1) and
   ``ColorCorrection``.  Then ``OpticalImage(probe, transformations=shape +
   colour)`` (median of 5 after a warm-up): exactly 4 K1 launches per call
   (the drift + curvature pair and the checker crop's pair),
   the drift estimate within 0.05 px of the roll, the call with plain K1
   within mean |diff| <= 1e-5, the corrected probe against the corrected
   baseline on the interior within mean |diff| <= 0.02, finite output of the
   corrected shape; the call's device busy time and host time, and the
   time of the swatch extraction (the crop's warp and resize on the card,
   its copy to the host, the 24 k-means there).
15. ``FusedAnalysisPipeline(transformations=[drift, curvature,
   illumination])`` with the bench's registration and analysis, two-warp
   lane, on the float32 probe, timed as phase 5: 4 K1 launches per frame,
   plain K1 within mean |diff| <= 1e-5, the staged public objects within
   mean |diff| <= 1e-3.
16. A drifting 8-frame series (frame k rolled by (2 + k, 3 - k)) corrected
   with [drift, curvature] at construction: 16 K1 launches per series (one
   pair per frame; ms per series, median of 3), every frame bitwise equal to
   the frame corrected alone.

17. The shape zoo on the bench frame (uint8, 4K): ``RotationCorrection``
   (0.5 degrees about the centre), ``AffineCorrection`` (fit from 4
   coordinate pairs of a 3 px shift and a 0.2 degree turn: rotation,
   translation and scaling recovered within 1e-9) and
   ``GeneralizedPerspectiveCorrection`` (fit from 16 coordinate pairs of a
   mild perspective: A, b and c recovered within 1e-6).  Each output on the
   card is bitwise equal to the same object's output for the frame as a CPU
   tensor; 0 K1 launches; ms per call (median of 5 after a warm-up), and
   the set-up time of each host-built field on its own.
18. ``PiecewisePerspectiveTransform.find_and_warp`` on ``Patches(image,
   [8, 16])`` of the smooth 4K image with a smooth displacement of at most
   20 px: exactly 2 K1 launches per call, at the bound derived from the
   field; the result against the gather warp of the same field within the
   bench gate (phase 4's thresholds) and against plain K1 within mean
   |diff| <= 1e-5; ``blend_and_assemble`` of untouched patches (overlap
   0.1) returns the base within 1e-6.  Its K1 pair joins phase 13.
19. Colour.  ``RelativeColorCorrection`` (degree 2) calibrated from 48
   samples each of 4 flat colour cards under a known smooth gain: the
   smooth image under that gain returns to itself within 1e-3; set-up ms
   (the field evaluated on the card), ms per call, device busy ms and peak
   memory; 0 K1 launches.  ``ExperimentalColorCorrection`` on the rig
   frame with its painted checker: 2 K1 launches per call (the checker
   crop's pair), the checker within mean |diff| <= 0.02 of the reference
   swatches, ms per call and the host's share.
20. The rig's saved state: its baseline saved with ``Image.save`` and each
   of its corrections with ``save`` into a temporary folder (as
   ``presets/workflows/rig.py:534-554`` of the JAX package does), read back
   with ``imread`` and ``read_correction``; the reading path through the
   loaded objects is bitwise equal to the path through the originals, 4 K1
   launches per call.  ``DeformationCorrection`` in ``transformations=``
   equals ``ImageRegistration(base)(probe)``: 2 K1 launches each.

A. Solvers and the TVD row of the JAX package's bench (``bench.py:726-731``):
   ``split_bregman_tvd`` at 512 x 512, mu = 10, ell = 1, 30 iterations,
   anisotropic, ``eps=None``, 10 calls closed by one synchronize
   (``tvd_512_iters_per_s``); Jacobi(600), CG and MG on one 512 x 512 H1
   problem agree with each other and the known solution within 5e-4 (the
   CPU test's tolerance); MG (5 cycles, depth 4) at 1703 x 3180 with
   heterogeneous mass and diffusion fields lowers the residual at least
   tenfold; ms per call.
B. Restoration on the main path: the two-warp lane of phase 5 with
   ``ConcentrationAnalysis(restoration=CombinedModel([Resize(0.5x),
   TVD("isotropic bregman", weight 5, 30 iterations, eps 1e-4),
   Resize(original)]))``, timed as phase 5 and in turns with phase 5's lane:
   exactly 4 K1 launches per frame, each bitwise equal to plain K1 on the
   frame's own data, the frame with plain K1 within mean |diff| <= 1e-5.
   Then ``TVD`` alone on that lane's full-resolution concentration map for
   each method (Chambolle with its eps; isotropic Bregman, 30 iterations,
   eps 1e-4, with Jacobi(20), CG(20) and MG(1 cycle, depth 3)): ms per call
   (median of 3), iterations taken (counted in the timed call), the ROF
   energy before and after (it must fall), and the card's result against the
   same call on the CPU tensor at a 256 x 384 crop (fixed-count Bregman:
   2e-5; Chambolle with its eps: 1e-4).  Last, how the stop flag is read: the
   port's loop (one host read per iteration) in turns with a loop that
   freezes its state on the device and reads the flag every eighth
   iteration, on Chambolle at 4K and at 512 x 512 and on Bregman with CG(20)
   at 4K: bitwise equal results and counts, ms and peak memory each.
C. A CT-sized volume: a seeded 256 x 512 x 512 float32 ``ScalarImage``
   (``space_dim=3``; 32-voxel blocks plus noise): ``chambolle_tvd``,
   ``split_bregman_tvd(dim=3, max_num_iter=10)`` and
   ``H1_regularization(dim=3)`` (ms per call, total variation lowered);
   ``slice`` along x, y and z by coordinate equals the index slice;
   ``reduce_axis`` average against the tensor's mean; ``Geometry.integrate``
   against the float64 numpy sum times the voxel volume within 1e-5
   relative; ``subregion``, ``roi`` (on a slice) and ``eval``; saved with
   ``Image.save`` and read back with ``imread``, equal.  Peak device memory.
D. Filters at 4K on the lane's concentration map: ``median_filter`` (radius
   1 and 2), ``VolumeAveraging`` (REV of 5 and of 8 voxels),
   ``uniform_refinement`` (+1, -1) and ``equalize_voxel_size``: ms per call
   (median of 3); each equal to the same call on the CPU tensor (median:
   exactly; averaging: 1e-6; resizes: 1e-5).

E. The heterogeneous colour-to-mass analysis behind the rig's reading path
   (run after phase 14, on its rig): 12 seeded wavy layers as labels, per
   label a seeded 5-colour relative ``ColorPath`` with its
   ``ColorPathInterpolation`` at equidistant values and a 3-support
   ``PWTransformation``; ``SimpleFlash(0.05, 0.5, 0.5, 1.0)``,
   ``CO2MassAnalysis(baseline, 1.01, 23.0)``, an ``ExtrudedPorousGeometry``
   (porosity 0.44, depth 0.019 m) and an ``ExpertKnowledgeAdapter`` with one
   gas ROI.  The photograph read with ``OpticalImage(frame,
   transformations=shape + colour)``, then
   ``HeterogeneousColorToMassAnalysis(...)(image)``, then
   ``geometry.integrate(result.mass)``: exactly 4 K1 launches per reading
   call and none in the chain; every output finite; gas saturation 0 outside
   the ROI.  A plume painted on the card along each label's path at seeded
   parameters: the colour interpretation recovers them within 1e-4, the
   integrated mass matches a float64 numpy reckoning of the chain within
   1e-4 relative.  The chain on the card against the same chain on the CPU
   tensor of a 512 x 1024 crop of the photograph read: every output within
   1e-5 (mass maps relative to their largest value) but at ties of ``fit``
   (two segments within 1e-6 of equally close with parameters more than 1e-6
   apart; counted, fewer than 0.1% of the crop).  The calibration folder
   written and read back gives the same mass.  Times: the chain per
   photograph at 12 and 40 labels (median of 5 after a warm-up; device busy,
   idle share, peak GiB), reading plus chain, save and ``from_folder``.

F. Optimal transport (after phase D), through ``wasserstein_distance`` and the
   Beckmann solvers on the card.  F1: the bench's weighted block problem at
   512 x 512 (``bench.py:344-362``: blocks of unit mass, weight 2 + sin cos in
   [1, 3]), Newton with AA(5) and the bench's options:
   ``solve_beckmann_problem`` timed, its first call (CG iterations of every
   pressure solve counted, all of them trips of the kernels, and each
   kernel's launches); converged, distance within 1e-3 relative of the
   JAX package's 0.697882, 0 <= certified gap (polish 2000 per chunk,
   target 1e-3, at most 2000, one chunk; the bench's 30000 took 85 s) <=
   raw gap; peak GiB.  F2: the smooth
   two-Gaussian problem at 256 x 256 (``bench.py:444-478``): distance within
   1e-3 of 0.467866, certified gap <= 2e-3 (its polish, 2000 steps a chunk,
   stops at that bound; at most 20000).  F3: the split-square anchor
   refined to 160 x 160 with ``np.repeat`` (the example's options, the
   iteration cap 30, not 200): within 0.02 of 0.379543951823.  F4: Bregman and G-prox on F1's problem at 256 x
   256, 100 iterations each (tolerances 0), options as the JAX package's tests
   set them: finite, certified gap >= -1e-4; distance against Newton's on the
   same problem (not gated).  F5: F1's problem at 64 x 64 on the card and as
   CPU tensors: distances within 1e-5 relative; on the card
   ``wasserstein_distance``'s distance and raw gap equal to its solver's.  F6: two cubes at 64^3 (the
   JAX tests' 12^3 case scaled): seconds, iterations, distance, peak GiB.  No
   K1 launch (counted).  With ``--profile``: tensor ops per solve, per Newton
   and per CG iteration, a profile of a short solve (busy, idle share, the
   coarsest multigrid level's share), and at the converged mobility one
   CG trip of the kernels, its coarsest level's product and the hierarchy's
   build on the card timed.

G. Batched W1 and the cross-run comparison (after phase F).  The bench's
   batch row (``bench.py:485-521``) uncut: 8 pairs at 256 x 256 (the blocks
   plus 0.02 U(0, 1) noise from ``default_rng(0)``, normalised per pair;
   voxel size 1/256; num_iter 100, tol_distance 1e-4) through
   ``parallel.batched_wasserstein``, one warm-up call, then a timed one
   (``w1_batch8_256_pairs_per_s``, the largest Newton iteration count, CG
   iterations run by the batch against each pair's): every pair converged;
   pair 0 solved alone by the single Newton device path within 1e-4
   relative of the batch.  B = 1, 8 and 32 of the same problem: seconds per
   batch, pairs/s, launches per CG iteration (equal for every B, checked;
   beside one problem without a batch axis) and peak GiB.  Then the
   comparison's compute and assemble steps in a temporary folder: 4 runs x 2
   times of seeded 256 x 256 mass maps saved with ``Image.save``, each run
   with a CSV imaging protocol: 12 pairs in one batched solve, 12 result
   files, a 12-row CSV, two distances within 1e-4 of their single solves.
   No K1 launch (counted).  With ``--profile``: the idle share of a short
   batched solve at B = 1, 8 and 32.

H. The FluidFlower CO2 and tracer analyses and the rig (after phase G), on
   seeded 1788x3180 uint8 photographs saved as npz: 12 wavy layers in
   seeded colours under sensor noise with the checker painted; the probe
   drifted by (2, 3) px with a CO2 plume and a stronger gas core painted in.
   H1: ``FluidFlowerCO2Analysis`` from a JSON config with the rig's drift,
   colour-checker and curvature sections, the 12 layers (through the
   curvature correction) set as labels by a subclass, ``co2`` with a
   per-label static threshold list and ``co2(g)`` with per-label dynamic
   Otsu in [0.1, 0.9] (the option keys of
   ``tests/unit/test_fluidflower_presets.py:30-58``: resize 0.5, Chambolle
   0.05 x 30, posterior "value" 0.02).  Set-up with the cleaning filter
   learnt from 2 baselines (28 K1 launches: the drift-corrected baseline 2,
   the corrected baseline 6, the curvature correction's pull-back grid 8 on
   its first call, each baseline again 6), then read from its cache (16,
   the filter equal to the file); the photograph with its
   segmentation written: exactly 6 K1 launches per reading call (the chain's
   order, drift -> colour -> curvature, splits the geometric corrections
   into two runs, a pair each, and the checker crop is one more pair), each
   bitwise equal to plain K1 and timed beside K1's library call (phase 2);
   no CO2(g) pixel outside CO2; the plume and the
   gas core found at seeded points, the background clean (CO2 on fewer than
   0.1% of the pixels off the plume, 32 px from the border); the per-label
   histograms of CO2(g)'s signal on the card equal ``np.histogram`` and give
   its Otsu thresholds; on a 512x1024 crop of the corrected frames, the
   analysis on the card against the same on the CPU: fewer than 0.1% of the
   pixels differ, as are within 1e-6 of a threshold (counted).  Times: the
   set-ups, ms per photograph (median of 3 after a warm-up, peak GiB), and
   1 call split into read / co2 / co2(g) / the host posterior and binary
   clean-up; with ``--profile`` device busy and idle share.  H2:
   ``FluidFlowerTracerAnalysis`` over the same labels
   (``HeterogeneousLinearModel``): set-up, ``calibrate_balancing`` on 2
   seeded tracer photographs (per-layer gains; 12 K1 launches), its
   scalings against a float64 numpy reckoning (scipy's dilation, strip
   means, lstsq) within 1e-5, ms per photograph (median of 3).  H3:
   ``FluidFlowerRig`` on the baseline halved (894x1590: the host median of
   the default disk takes ~4x as long at full size) with one supervised
   marker per layer and Scharr edges: segmentation s, 12 labels, and a
   second construction from the labels cache gives equal labels; no K1.
   The phase checks its 162 K1 launches exactly.

I. The rig workflow from its TOML config (after phase H), through the public
   functions, in a temporary folder: the baseline (phase 14's rig frame
   with its checker) and 4 photographs drifted by 1-4 px with a painted
   plume as uint8 npz files, a sketch of 12 seeded wavy layers in colours
   1/16 apart, 20 seeded depth measurements, imaging, injection and
   pressure/temperature CSV protocols; [corrections] drift and colour on
   the checker, phase 14's CURVATURE and ILLUMINATION; [image_porosity]
   from the image; one channel (HSV saturation), one range (a blue HSV box)
   and one relative path embedding per label (its paths written with
   ``LabelColorPathMap.save``).  I1: ``setup_depth_map``,
   ``segment_colored_image`` (12 labels) and ``setup_rig`` timed, the rig's
   "inactive" and "Porosity analysis failed" warnings as errors: exactly 18
   K1 launches in ``setup_rig``, the image porosity float32, finite, in
   [0, 1] and below 1 on average, the drift ROI and shape-corrected
   baseline bitwise equal to phase 14's.  I2: ``Rig.load`` of the saved
   folder; each photograph read by both rigs (4 K1 launches per read; 8
   more in the loaded rig's first, its curvature grid) and equal bitwise,
   and equal bitwise to phase 14's chain with the rig's illumination
   correction (phase 14's own illumination samples are unmasked, the rig's
   are masked by its boolean image porosity: that chain's difference is
   printed); ms per photograph (median of 5 after a warm-up, peak GiB;
   with ``--profile`` device busy and idle share).  I3: the three
   embeddings on a read photograph (ms per call, median of 5), the path
   embedding high on the plume and low off it, and on a 512x1024 crop the
   card against the CPU: saturation within 1e-6, range masks equal but
   within 1e-6 of a bound (counted), the path embedding within 1e-5 but at
   counted fit ties.  I4: ``comparison_wasserstein(Rig, path,
   compute=True)`` then ``assemble=True`` on phase G's maps through a
   ``MultiFluidFlowerConfig`` file: the 12 JSON files and the CSV equal to
   ``_compute``/``_assemble`` on phase G's config object.  The phase checks
   its 120 K1 launches exactly and hands its folder to phase J.

J. The config-driven analysis run (after phase I) over phase I's rig: its 4
   photographs and 4 more drifted by 5-8 px with the plume grown (seeded
   1788x3180 uint8 npz) in a folder of their own, imaging and injection
   protocols, a colour-to-mass chain over the rig's 12 labels saved where
   ``[color.path.co2]`` names it (phase E's signal functions and flash,
   paths towards the plume's colour), two ROIs and ``[analysis]`` formats
   npz, ``[analysis.mass]`` (export mass and rescaled mass),
   ``[analysis.volume]``, ``[analysis.cropping]`` npz.  Every
   ``Rig.read_image`` of the phase is recorded: a frame the loader would
   skip fails it.  J1: ``user_interface_analysis.main(["--config", ...,
   "--mass", "--volume", "--cropping", "--all"])``: 8 rows in each CSV, the
   late row's rescaled mass within rel 1e-3 of the injected mass (itself
   the protocol's rate times the time, within 1e-9), each ROI's mass within
   the total, 16 mass fields and 8 cropped photographs.  J2:
   ``analysis_mass_from_context`` on a context of its own, prefetched (the
   default workers and depth) and sequential (``iter_prefetched_images``
   patched to depth 0 here), one loop each into fresh folders: ms
   per photograph, ``loader_prefetch_speedup`` (sequential / prefetched
   median), peak GiB, the progress events; the CSV bytes and every exported
   field equal across all loops, each photograph's mass field and total
   bitwise equal to the chain called on ``rig.read_image``; one more
   sequential loop over the first 2 photographs split into read, chain,
   products, export, integrals and CSV (each step closed by a synchronize).
   J3: the loop with plain K1, every field within mean |diff| <= 1e-5.  J4 (``--profile``): one
   prefetched loop profiled (device ops and busy ms per photograph, idle
   share, peak GiB).  J5: ``user_interface_setup.main(["--config", ...,
   "--protocols", "--overwrite"])`` on a copy of the config whose protocols
   lie in a scratch folder (the CSV lists the 8 photographs: npz carries no
   EXIF, so the dates are the file times), and
   ``user_interface_comparison.main([... "--wasserstein-compute",
   "--wasserstein-assemble"])`` on phase G's runs: the 12 JSON files and
   the CSV equal to phase I4's.  The phase checks its 216 K1 launches
   exactly (104 in J1, 112 in J2) and hands its folder to phase K.

K. The calibration workflows (after phase J) over phase J's photographs:
   its config with a data registry (the baseline photograph, the 8
   photographs, the last 4), a ``[color.path.calib]`` embedding with the
   template's settings (``templates/config.toml:62-79``: resolution 51, 2
   segments, "threshold" weighting, the expanded baseline spectrum
   ignored) over the rig's 12 labels, ``[calibration.color]`` and
   ``[calibration.mass]`` (mode "auto", threshold 0.3, maxiter 20, the last
   4 photographs).  K1: ``user_interface_calibration.main([..., "--color"])``
   then ``[..., "--mass"]``: 12 saved paths of 3 nodes, the metadata naming
   the basis, the Nelder-Mead objective at its result no higher than at the
   initial dofs (both printed), the chain read back with ``from_folder``
   giving each calibration photograph's mass bitwise.  K2: each
   photograph's per-label spectrum on the card (one pass, one
   ``bincount``) equal to the JAX package's host loop copied here, ms per
   photograph of both; per label the batched path fit against the plain
   version (``_fit_path_rdp_reference``): equal nodes but at counted ties
   (a split chosen differently where the two smoothed left - right
   differences agree within 1e-12), occupied bins and seconds per label of
   both.  K3: the colour step with plain K1: every path file equal.  K4:
   ``--delete --dry-run`` lists the calibration files and keeps them;
   ``user_interface_utils.main`` exports the calibration bundle and imports
   it into a second results folder, byte for byte.  K5:
   ``user_interface_helper.main([..., "--color", "--results"])`` on phase
   J's mass fields (the histograms warn that matplotlib is missing; the
   fields re-exported equal), ``helper_roi`` with two points,
   ``load_images_with_cache`` twice over 2 photographs (the second pass
   launches no K1 and is bitwise equal), ``--media`` raising and naming
   OpenCV.  The phase checks its 84 K1 launches exactly (44 in the colour
   step, 24 in the mass step, 16 in K5) and deletes the folder.

L. The segmentation, finger and thresholding steps, SimpleFluidFlower, the
   multiphase calibration session and the numerics utilities (after phase
   K, on phase J's rig, chain and config): 4 photographs of phase J's frame,
   one hour apart, with a noise-free grey patch under each of two ROIs and,
   painted on the patches in the grey plus phase J's plume colour change, a
   plume whose front carries 6 flat-topped fingers that rise 40 px per
   photograph (the ROI cuts its body, so within the ROI its boundary is the
   front and the ROI's edges) and a growing dome; ``[analysis.fingers]``
   reads phase I's "blue" colour range (threshold 0.5) over both ROIs with
   the skeleton analysis and holes filled, and over a third, "interface"
   (the fingered ROI again), with the gradient-based interface; a fourth
   ROI, "unchanged", left as the baseline, is read from phase J's chain
   (gas saturation, threshold 0.5).  L1:
   ``user_interface_analysis.main([..., "--fingers", "--all"])``: 4 rows per
   ROI in statistics.csv, no tip and no contour in the unchanged ROI, 6
   tips on every photograph in the fingered ROI, 6
   continuing fingers from the second on, the tracked tips mapped back to
   the raw frame through the rig's curvature grid rising 40 px per
   photograph within 1 px and at the painted columns, the advance rates
   (px/h and mm/h), statistics.json and the interface .npy files written.
   L1b: the step on a context of its own, sequential, split into read,
   chain (which must have run), mask, contours, skeleton, tracking and
   write (each closed by a synchronize): its CSVs and JSON equal to the
   CLI's, and every count and
   length equal to a host reckoning on the step's own masks (OpenCV
   contours of the host copy, the card's skeleton classified on the host);
   with ``--profile`` one more run profiled (idle share).  L2: the largest
   mask's skeleton on the card against ``utils/morphology.py::skeletonize``:
   bitwise equal, the number of erosions, seconds of both.  L3:
   ``--segmentation`` and ``--thresholding`` raise naming matplotlib (or run
   where it imports); their masks on the card (``SegmentationContours.
   extract_mask`` per threshold, the thresholding layers) equal to the host
   threshold of the same field but within 1e-6 of a bound (counted).  L4:
   ``SimpleFluidFlower`` set up from phase I's baseline with the default
   corrections and phase 14's CURVATURE: the chain type, drift, curvature,
   colour; 4 timed reads; saved, loaded and read bitwise as before; the read
   with plain K1 within mean |diff| <= 1e-5.  L4b: a second
   ``SimpleFluidFlower`` with ``DynamicIlluminationCorrection`` (3 sample
   patches) between curvature and colour: its baseline colours equal to
   those of a host copy of the baseline the set-up corrected (1e-6), 4
   timed reads beside L4's (the baseline photograph's read printed against
   L4's), the read with plain K1 within mean |diff| <= 1e-5.  L5: ``TransformationCalibrationSession``
   over the 4 photographs, the chain split into pre-mass (colour
   interpretation and signal) and mass-from-pre (gas and aqueous
   transformations, CO2 mass), Nelder-Mead maxiter 10: the error at the
   result no higher than at the start, the log written.  L6:
   ``FeatureDetection.find_matches`` between the 4K frame and a copy shifted
   7 px (the shift within 0.05 px), ``detect_color`` of the painted checker's
   first swatch (all its 3600 px), ``linalg_cg`` and ``linalg_gmres`` on a
   256x256 TPFA operator (plus a convection term for GMRES) as a callable on
   the card against scipy's sparse solve within 1e-6 relative.  The phase
   checks its 168 K1 launches exactly (24 in L1, 24 in L1b, 16 in L3, 46 in
   L4, 42 in L4b, 16 in L5) and hands its folder, its ``SimpleFluidFlower`` and the
   rig's labels to phase M.

M. Photographs, the assistants and a GUI worker (after phase L).  M1: phase
   L's 4 photographs written from the card by ``OpticalImage.write`` as JPEG
   (quality 95), the first also as PNG and TIFF, and ``encode(".png")``:
   the bytes equal to ``cv2.imencode`` of the host array; each read back by
   ``imread`` onto the card bitwise equal to ``cv2.imread`` + ``cvtColor``
   (PNG and TIFF equal to the written array), and with
   ``transfer="yuv420"`` bitwise the reconstruction of OpenCV's planes; on
   a smooth 4K JPEG the yuv420 read within tests/test_torch_transfer.py's
   bound of the full read (mean < 1, p99 <= 4 levels); ``ScalarImage.write``
   png/jpg/tif of a card image equal to ``cv2.imencode``; host decode ms per
   photograph and bytes copied.  M2: ``user_interface_analysis.main([...,
   "--mass", "--all"])`` over the 4 JPEGs (phase J's config, rig and chain,
   npy export) and over npz files holding their decoded arrays: every read
   recorded (none skipped), the CSVs byte for byte and the mass fields
   bitwise equal.  M3: ``wasserstein_distance(method="cv2.emd")`` of card
   images on the 10x10 two-squares problem and a seeded 64x64 pair within
   1e-6 relative of the JAX package's values (pinned by
   tests/test_torch_emd.py), ``EMD().distance_matrix`` of 4 maps symmetric;
   |EMD - Newton| / Newton printed.  M4: a flat grey 4K ROI photograph with
   four white 16-px marks near its corners, written as JPEG;
   ``SimpleFluidFlower.setup_curvature_correction(roi, "automatic",
   white)`` on phase L's rig: the corners within 1 px of the painted ones
   and equal to the ``CropAssistant``'s on a CPU copy; two reads through
   the new correction and one with plain K1, bitwise; ``LabelsAssistant``
   pick and merge and a mask selection on phase I's labels on the card equal
   to a CPU copy's.  M5: a ``GuiSession`` (device "cuda") starts "analysis:
   mass" on M2's JPEG config in a spawned worker (the registry pointed for
   the run at this script's ``analysis_mass_from_context``, which calls the
   port's step and reports the worker's K1 launches over the progress
   queue), polled to ``__done__``: 4 progress events, every PNG preview
   decodes, no error sentinel, the CSV byte for byte M2's; a second worker
   stopped after 2 s ends within 5 s.  M6: ``build_media`` over the JPEGs
   (mp4 and avi): each video opens with 4 frames; ``render_active_region``
   on the card equal to the CPU's.  The phase checks its 80 K1 launches
   exactly (48 in M2, 8 in M4, 24 counted in the GUI worker) and deletes the
   folder.

N. The multi-device layer (``darsia_tpu_torch/parallel/``, after phase M)
   on meshes that name ``cuda:0`` eight times, after the JAX package's
   multi-device dry run (``__graft_entry__.py:54-383``).  N1:
   ``sharded_production_pipeline`` (the fused chain of a translation and a
   shape-preserving curvature, the fused 8x16-patch registration at bound
   120, ``ConcentrationAnalysis`` with 10 Jacobi sweeps) on 4 seeded
   1788x3180 uint8 frames over a (batch 2, space 4) mesh and a (1, 8) mesh
   (1788 rows pad to 1792): 0 K1 launches; against the public
   ``FusedAnalysisPipeline`` with every warp the gather warp
   (``warp_backend(force="gather")``, as the sharded warps) max |diff| <=
   2e-3 and mean <= 5e-5 per frame (the dry run's gate), against the public
   K1 lane mean <= 1e-3 (phase 5's full-path tier); ms per frame of each
   mesh and of the public K1 lane (one call of the 4 frames after one).  N2:
   ``sharded_tpfa_cg`` over 8 shards at the dry run's 64x16 (tol 1e-6,
   maxiter 2000) and at 1024x1024 (tol 1e-8, 1000 iterations) against
   ``tpfa_cg``, up to the constant, within 1e-3 of the pressure's scale.  N3: ``sharded_warp`` on a (rows 2,
   cols 4) mesh at 256x256x3 (D = 8) and 1788x3180x3 (D = 120) against the
   gather warp within 1e-4, then ``sharded_tvd_2d`` against its unsharded
   sweeps within 1e-5.  N4: ``sharded_wasserstein_batch`` of the dry run's
   8 pairs (10x10) against ``batched_wasserstein`` within 1e-4, all
   converged.  N5: ``sharded_beckmann_newton`` over 8 shards on the dry
   run's problem, AA(5), CG tolerance 1e-5, at most 60 Newton iterations:
   Jacobi (called directly) and two-level (through
   ``wasserstein_distance(method="sharded_newton")``), each within rel 1e-3
   of the single-device Newton solve; Newton and CG iterations, launches
   per CG iteration (tensor ops of a fixed 4- minus a fixed 2-iteration CG
   solve, halved); Jacobi at 128x128 with its CG capped at 200 iterations
   (at 256x256 and the default 500 the CG runs at its cap in every Newton
   step), two-level at 256x256.  The phase
   checks its 38 K1 launches exactly (the corrected baseline: the new
   curvature correction's grid and the chain's pair; 4 per public-lane
   frame).

O. The display and export layer (after phase N).  O1: phase 5's
   concentration map (the two-warp lane's last frame, 1703x3180 float32 on
   the card) through ``Image.to_vtk``: timed, its MB printed, re-read with a
   vectorised parse, every value exactly the map's (the printed float64
   reprs round-trip).  O2: ``wasserstein_distance_to_vtk`` of phase F5's
   card solution (64x64, weighted, no new solve): its 9 fields re-read,
   each exactly the info's tensor (rows bottom-up, vectors (v1, -v0, 0),
   the weights' first component).  O3: where matplotlib, plotly, pydicom,
   meshio, pandas or openpyxl does not import, every drawing function (Image.show,
   the W1 plot, the three overlay plots, the time-series and run-analysis
   plots, the logs, the colour-path views), ``show_plotly``, ``imread`` of a
   ``.dcm`` and a ``.vtu`` file and the Excel protocol and facies readers
   raise ``ImportError`` naming it; where matplotlib imports, every drawing
   function renders on Agg and a scalar view's array, a statistics profile
   and a contour level are held against the tensors.  O4:
   ``plot_image_statistics``' profiles (``utils/augmented_plotting.py::
   _statistics``, float64 on the card) of the 4K map and of the 4K uint8
   photograph, both axes, against a float64 numpy reckoning of the host
   copy: within 1e-6 of the data's scale (float32 profiles), 1e-12
   (uint8); timed beside numpy.  No kernel launches (checked).

P. The port's last gaps against the JAX package (after phase O).  P1:
   ``TranslationAnalysis.build_fused_aligner(120)`` on the bench's
   registration set-up (8x16 patches) and phase 8's staged 4K probe: its
   frame bitwise ``fused_align``'s, every patch passing, exactly 2 K1
   launches per call; built and timed (median of 5 calls after a
   warm-up).  P2: a 1788x3180 float32 numpy array assigned to a card
   image's ``img`` lands on cuda:0; ``copy`` and a nearest ``resize`` stay
   there (the resize bitwise the CPU tensor's) and ``Geometry.integrate``
   is within 1e-6 of float64 numpy.  P3: ``extract_quadrilateral_ROI`` of
   phase 4's smooth 4K image with ``shape`` (1500, 2800) and ``pts_dst``:
   bilinear (one K1 pair; bitwise its plain version on the same field;
   against a float64 numpy pull-back at 4096 sampled pixels, the two-pass
   approximation of this field: mean < 5e-3, max < 0.05) and
   ``inter_nearest`` (the gather warp, no K1; exact at every sample not
   within 1e-3 of a cell edge).  P4: ``masked_normalized_cross_correlation``
   of two 4K frames within 1e-5 of float64 numpy.  P5: where matplotlib
   does not import, the new drawing calls (``plot_translation``,
   ``ImageRegistration.plot``, ``call_with_output(plot_patch_translation=
   True)``, ``ColorChecker.plot``, ``ConcentrationAnalysis(verbosity=2)``)
   raise naming it (5 more than phase O's); where it imports, they render
   on Agg and the concentration at verbosity 2 equals that at 0.  Each
   step's launches, the staged probe's correction pair included, are read
   from 0 and added up; the phase's count is that sum.

Q. The port's example suite (after phase P): every module of
   ``darsia_tpu_torch.examples`` (the JAX package's ``examples/``) runs
   ``main(device="cuda", fast=True)``, then ``fused_pipeline``,
   ``image_registration`` and ``co2_and_tracer_analysis`` (their default
   mode differs) and ``color_correction`` and ``optical_images`` (no fast
   switch: the same run, pinned as their default mode) at default size
   (``Q_DEFAULT``); its printed lines are held to the JAX
   examples' lines in ``expected.json`` with their tolerances (on the card
   two lines have their own: its warps are K1's two passes where the CPU's
   are the gather warp), its K1 launches read from 0 and checked exactly
   (``Q_K1``), each K1 call's inputs and output copied at the wrapper and
   held bitwise to the plain K1 on them, its wall ms printed.  Where
   matplotlib does not import, the contour plots of ``co2_analysis`` (3)
   and the window check of ``readme_example`` (1) raise naming it and the
   examples go on (``phase_segmentation``'s batch logs the same and goes
   on, as in the JAX package).  ``distances`` runs without its host EMD
   (OpenCV on 4096-point signatures, minutes; phase M runs ``cv2.emd``),
   its EMD line left out of the comparison.

R. The device-parity sweep (after phase Q): every case of
   ``tests/torch_device_cases.py`` (one or more of the port's public classes
   and functions each, at 16x16 to 120x200, W1 grids of 16x16, capped
   solver iterations; ``EXEMPT`` lists the rest: abstract bases, enums,
   dataclasses, type aliases) runs on ``cpu`` and on ``cuda:0``: the outputs
   within the case's stated tolerance (a case that warps through
   ``warp_backend`` at ``bench.py:1133``'s two-pass tier), every tensor and
   image of a card case on ``cuda:0``, each K1 call copied at the wrapper
   and held bitwise to the plain K1 on its inputs, each case's K1 launches
   read from 0 and equal to its table count (``K1_IN_R`` in all), K2 and K3
   never launched; a case whose library does not import raises the
   ImportError naming it on both devices.  Per layer it prints the cases,
   card and host cases, the worst ratio of difference to tolerance and the
   seconds, then the phase's seconds; any miss fails the script.

S. The pressure solve's CG-trip kernels (``csrc/tpfa_mg.cu``; after phase
   G) against their plain versions on the same state, at the shapes the
   main path runs: the W1 benchmark cell's 1024 pairs at 120 x 280
   (per-pair faces), F1's one problem at 512 x 512 (shared faces) and G1's
   8 pairs at 256 x 256, seeded faces over three decades.  The coarsest
   level's matrix against ``tpfa_mg_hierarchy``'s; after three trips of the
   mirror (``FusedMGPCG(kernels=False)``), each step of a trip from the
   mirror's state (A p, the update, the V-cycle, the direction, the trip's
   end), and per V-cycle level the pre pass (x and the restriction) and the
   post pass against the tensor V-cycle's own steps on the kernels' inputs:
   within 1e-5 of the largest value, the flags equal.  At the cell's shape
   each kernel is timed (CUDA events, device-paced) beside its plain version
   and its byte bound.  In F1 and G1 each kernel's launches are counted from
   0 and their sum held to the program's ``beckmann.mg_launches``.

Every launch count (the counters ``k1.launches``, ``k2.launches`` and
``k3.launches`` of ``darsia_tpu_torch/utils/tracing.py``, read from a mark
that ``reset_counts`` sets) is set to 0 just before each path of phases 3, 5-7,
8-11, 14-20, B, E, F, G, H, I, J, K, L, M, N, O, P, Q and of each case
of R and read just after it (in M5 the worker's process counts from its
start); the ``kernels`` line's K1 launches are their sum, 586 before phase
E, 28 in it, none in F or G, 162 in H, 120 in I, 216 in J, 84 in K, 168 in
L, 80 in M, 38 in N, none in O, 22 in P, 80 in Q and 84 in R (1668;
checked exactly).  Each of phases 8-12, 14-20, A-S prints its seconds.  The
second-to-last line is a JSON object of per-kernel results (K1-K3, then the
seven kernels of phase S with their launches in F1 and G1, their worst
difference there and their times at the cell's shape); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from datetime import datetime, timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
H, W = 1788, 3180  # the production frame (baseline.jpg's size)
D_REG = 120  # registration warp bound (FusedAnalysisPipeline default)
SCHEDULE_SHAPES = [(3, 64, 300, 7), (3, 130, 515, 40), (3, 96, 257, 121)]
# K2/K3 cases (R, W_in, D, W_out, cols scale): the schedule-test shapes, a
# ragged case, a violated bound, and the 4K row case at the two bounds at
# which the TPU measured the ring schedule (warp2pass.py:144-147); each runs
# with 3 channels folded into rows.
ROW_CASES = [
    (64, 300, 7, None, 1.0),
    (130, 515, 40, None, 1.0),
    (96, 257, 121, None, 1.0),
    (33, 200, 3, 150, 1.0),
    (40, 90, 2, 300, 1.5),
    (H, W, 120, None, 1.0),
    (H, W, 30, None, 1.0),
]
SERIES_T = 8
# K1 launches in the counted paths: phases 3-20 and B, then phase E (the
# baseline read, one reading call, five timed reading calls: 4 each).
K1_BEFORE_E, K1_IN_E = 586, 28
WINDOWS = 3  # timed windows per lane
# The card's published peaks (H100 SXM data sheet, 700 W): the bound of a
# kernel is the larger of its bytes over the memory rate and its f32
# operations (outside the tensor cores) over the f32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
KERNELS = {
    "warp_rows_t": ("k1.launches", "csrc/warp_rows_t.cu", 323),
    "warp_rows": ("k2.launches", "csrc/warp_rows.cu", 218),
    "warp_rows_ring": ("k3.launches", "csrc/warp_rows.cu", 188),
}
# The launch counters (``darsia_tpu_torch/utils/tracing.py``) count from the
# process's start; a path's launches are read from the mark ``reset_counts``
# sets.
_COUNT_MARK: dict = {}
CURVATURE = {
    "crop": {
        "pts_src": [[8, 11], [H - 33, 16], [H - 40, W - 15], [5, W - 15]],
        "width": 2.8,
        "height": 1.5,
    },
    "bulge": {
        "horizontal_bulge": -1e-9,
        "vertical_bulge": -2.7e-8,
        "vertical_center_offset": -31,
    },
}
META = {"width": 2.8, "height": 1.5}
# Height of the corrected frame: the crop keeps the 2.8 : 1.5 aspect ratio.
OH = min(H, int(W / (META["width"] / META["height"])))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, device_paced: bool = False) -> float:
    """Mean time of ``fn()`` over ``reps`` back-to-back runs (CUDA events).

    ``device_paced``: the device first spins for ~20 ms, so the host has
    queued every launch before the first one starts; a kernel shorter than
    its launch overhead is then timed by the device, not by the host's launch
    rate.
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if device_paced:
        torch.cuda._sleep(40_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(least ms on the card, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, flops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def reset_counts(w2p) -> None:
    from darsia_tpu_torch.utils import tracing

    for counter, _, _ in KERNELS.values():
        _COUNT_MARK[counter] = tracing.counter(counter)


def read_counts(w2p) -> dict:
    from darsia_tpu_torch.utils import tracing

    return {
        name: tracing.counter(counter) - _COUNT_MARK.get(counter, 0)
        for name, (counter, _, _) in KERNELS.items()
    }


def check_counts(counts: dict, want: dict, path: str) -> None:
    """The path launched exactly ``want`` of each kernel (others: none)."""
    full = {name: want.get(name, 0) for name in KERNELS}
    if counts != full:
        raise AssertionError(f"{path}: launches {counts}, want {full}")


def rows_case(C, R, W_in, D, W_out=None, seed=0, device="cuda"):
    """(data, cols) with |cols - j| <= D on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    W_out = W_out or W_in
    data = torch.randn((C, R, W_in), generator=g, device=device)
    j = torch.arange(W_out, dtype=torch.float32, device=device)
    noise = torch.rand((R, W_out), generator=g, device=device) * (2 * D) - D
    return data, (j + noise).contiguous()


def frame_k1_calls(w2p, fn) -> list:
    """``(data, cols, max_disp)`` of each K1 call of ``fn()`` (one frame of
    a pipeline, a series correction), in order, recorded at the wrapper."""
    calls, wrapper = [], w2p.warp_rows_t

    def record(data, cols, max_disp, impl="auto"):
        calls.append((data, cols, max_disp))
        return wrapper(data, cols, max_disp, impl)

    w2p.warp_rows_t = record
    try:
        fn()
    finally:
        w2p.warp_rows_t = wrapper
    torch.cuda.synchronize()
    return calls


def k1_cases(w2p, lanes, device) -> list:
    """K1's launches in a frame, on the frame's own data and fields: ``[{name,
    data, cols, D}]`` from one frame of each lane.  Two-warp: the correction
    chain's field, then the registration's TPS field; single-warp: the gray
    warp (C = 1) of the correction field, then the composed colour warp.
    Then the series correction's pair: 8 frames x 3 channels folded (C = 24)."""
    from darsia_tpu_torch.corrections.fuse import fused_chain

    probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    cases = []
    for lane, warps in (
        ("two_warp", ("correction", "registration")),
        ("single_warp", ("gray", "single warp")),
    ):
        calls = frame_k1_calls(w2p, lambda: lanes[lane](probe))
        if len(calls) != 4:
            raise AssertionError(f"{lane}: {len(calls)} K1 calls per frame, want 4")
        for k, (data, cols, D) in enumerate(calls):
            name = f"{warps[k // 2]} pass {k % 2 + 1}"
            cases.append({"name": name, "data": data, "cols": cols, "D": D})
    series = torch.from_numpy(series_frames(lanes["base_u8"])).to(device)
    chain = fused_chain([lanes["trans"], lanes["curv"]], (H, W), device)
    calls = frame_k1_calls(w2p, lambda: chain.correct_series_array(series, 2))
    if len(calls) != 2:
        raise AssertionError(f"series correction: {len(calls)} K1 calls, want 2")
    for k, (data, cols, D) in enumerate(calls):
        cases.append({"name": f"series pass {k + 1}", "data": data, "cols": cols, "D": D})
    rig = lanes.get("rig")
    if rig is not None:
        chain = fused_chain([rig["drift"], rig["curv"]], (H, W), device)
        calls = frame_k1_calls(w2p, lambda: chain.correct_array(rig["probe"]))
        if len(calls) != 2 or any(D != chain.max_disp for _, _, D in calls):
            raise AssertionError(f"drift chain: K1 calls {[c[2] for c in calls]}, want 2 at {chain.max_disp}")
        for k, (data, cols, D) in enumerate(calls):
            cases.append({"name": f"drift chain pass {k + 1}", "data": data, "cols": cols, "D": D})
        # A drifting series: one pair per frame (the second frame's pair).
        drifting = torch.stack([rig["probe"], torch.roll(rig["probe"], (1, -1), (0, 1))], dim=2)
        calls = frame_k1_calls(w2p, lambda: chain.correct_series_array(drifting, 2))
        if len(calls) != 4:
            raise AssertionError(f"drifting series: {len(calls)} K1 calls for 2 frames, want 4")
        for k, (data, cols, D) in enumerate(calls[2:]):
            cases.append({"name": f"drifting series pass {k + 1}", "data": data, "cols": cols, "D": D})
        # A rig reading call: the drift chain's pair, then the checker crop's.
        from darsia_tpu_torch import OpticalImage

        transformations = rig["shape"] + rig["colour"]
        calls = frame_k1_calls(
            w2p, lambda: OpticalImage(rig["probe"], transformations=transformations, **META)
        )
        if len(calls) != 4:
            raise AssertionError(f"rig reading call: {len(calls)} K1 calls, want 4")
        for k, (data, cols, D) in enumerate(calls[2:]):
            cases.append({"name": f"checker crop pass {k + 1}", "data": data, "cols": cols, "D": D})
    piecewise = lanes.get("piecewise")
    if piecewise is not None:
        calls = frame_k1_calls(w2p, piecewise["warp"])
        if len(calls) != 2 or any(D != piecewise["max_disp"] for _, _, D in calls):
            raise AssertionError(
                f"piecewise perspective: K1 calls {[c[2] for c in calls]}, want 2 at "
                f"{piecewise['max_disp']}"
            )
        for k, (data, cols, D) in enumerate(calls):
            cases.append({"name": f"piecewise pass {k + 1}", "data": data, "cols": cols, "D": D})
    return cases


def series_frames(base_u8) -> np.ndarray:
    """(H, W, T, C) uint8: the base rolled by (2 + k, 3 - k) for frame k."""
    frames = [np.roll(base_u8, shift=(2 + k, 3 - k), axis=(0, 1)) for k in range(SERIES_T)]
    return np.stack(frames, axis=2)


def k1_bound(C, R, W_in, W_out) -> tuple:
    """(bytes, bound ms, bound_by) of one K1 call: each input read once, the
    output written once; per (r, j) 2 clamp, add, floor, sub, 2 clamp, per
    output a lerp."""
    moved = 4.0 * (C * R * W_in + R * W_out + C * R * W_out)
    return (moved, *bound(moved, 7.0 * R * W_out + 3.0 * C * R * W_out))


def k1_library_call(data: torch.Tensor, cols: torch.Tensor):
    """One ``F.grid_sample`` that computes K1's function: the (1, C, R, W_in)
    data sampled on a (1, W_out, R, 2) grid whose entry [j, r] is (x =
    cols[r, j], y = r), bilinear, border padding, ``align_corners=True``,
    returns the (C, W_out, R) transposed output.  The grid is built once,
    outside the call."""
    import torch.nn.functional as F

    C, R, W_in = data.shape
    gx = (2.0 * cols.clamp(0.0, float(W_in - 1)) / (W_in - 1) - 1.0).t()
    gy = (2.0 * torch.arange(R, device=data.device) / (R - 1) - 1.0)[None, :]
    grid = torch.stack([gx, gy.expand_as(gx)], dim=-1)[None].contiguous()
    img = data[None]

    def grid_sample():
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True)[0]

    return grid_sample


def phase_kernel(w2p) -> dict:
    """K1 vs its plain version; times at the two production passes."""
    # Production shapes: pass 1 (3, H, W) -> (3, W, H); pass 2 (3, W, H) ->
    # (3, OH, W).
    cases = [(*s, None) for s in SCHEDULE_SHAPES]
    cases += [(3, H, W, D_REG, W), (3, W, H, D_REG, OH)]
    max_err, bitwise = 0.0, True
    timed = {}
    for k, (C, R, W_in, D, W_out) in enumerate(cases):
        data, cols = rows_case(C, R, W_in, D, W_out, seed=k)
        out = w2p.warp_rows_t(data, cols, D)
        torch.cuda.synchronize()
        ref = w2p.warp_rows_t_reference(data, cols, D)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = bool(torch.equal(out, ref))
        print(f"K1 {(C, R, W_in, W_out or W_in)} D={D}: max|kernel-plain|={err} bitwise={same}")
        if not err <= 1e-6:
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        max_err, bitwise = max(max_err, err), bitwise and same
        if W_out is not None:
            # plain, kernel, kernel, plain: drift on the card shows as a gap
            # between the two readings of one version.
            p1 = cuda_ms(lambda: w2p.warp_rows_t_reference(data, cols, D), 10)
            k1 = cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20)
            k2 = cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20)
            p2 = cuda_ms(lambda: w2p.warp_rows_t_reference(data, cols, D), 10)
            paced = cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20, device_paced=True)
            grid_sample = k1_library_call(data, cols)
            g_ms = [cuda_ms(grid_sample, 20), cuda_ms(grid_sample, 20)]
            g_paced = cuda_ms(grid_sample, 20, device_paced=True)
            g_err = float((grid_sample() - w2p.warp_rows_t(data, cols, D)).abs().max())
            if not g_err < 1e-2:  # float32 grid rounding only; a layout fault is O(1)
                raise AssertionError(f"K1's library call disagrees with K1: {g_err}")
            name = "pass1" if len(timed) == 0 else "pass2"
            moved, bound_ms, bound_by = k1_bound(C, R, W_in, W_out)
            timed[name] = {
                "kernel_ms": [k1, k2],
                "plain_ms": [p1, p2],
                "library_ms": g_ms,
                "library_paced_ms": g_paced,
                "library_max_abs_diff": g_err,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            print(
                f"K1 {name}: kernel {k1} / {k2} ms, plain {p1} / {p2} ms, "
                f"{moved / (min(k1, k2) * 1e6):.1f} GB/s by the 12 B/element count, "
                f"bound {bound_ms} ms ({bound_by}), "
                f"{100 * bound_ms / min(k1, k2):.1f}% of bound, device-paced {paced} ms, "
                f"geometry {w2p.warp_rows_t_geometry(C, R, W_out)}; library call "
                f"F.grid_sample {g_ms[0]} / {g_ms[1]} ms, device-paced {g_paced} ms, "
                f"max|diff| to K1 {g_err}"
            )
        del data, cols, out, ref
    return {"max_abs_err": max_err, "bitwise": bitwise, **timed}


def phase_kernel_fields(w2p, lanes, device) -> None:
    """K1 where the frame runs it: bitwise against its plain version and
    timed at each of ``k1_cases``, then at a violated bound."""
    cases = k1_cases(w2p, lanes, device)
    # The registration pass 1 field, stretched 1.5x: far beyond its bound.
    over = next(c for c in cases if c["name"] == "registration pass 1")
    stretched = (over["cols"] * 1.5).contiguous()
    cases.append({**over, "name": "violated bound", "cols": stretched})
    for case in cases:
        data, cols, D = case["data"], case["cols"], case["D"]
        C, R, W_in = data.shape
        W_out = cols.shape[1]
        out = w2p.warp_rows_t(data, cols, D)
        ref = w2p.warp_rows_t_reference(data, cols, D)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            err = float((out - ref).abs().max())
            raise AssertionError(f"K1 {case['name']}: != plain, max |diff| {err}")
        grid_sample = k1_library_call(data, cols)
        lib_err = float((grid_sample() - out).abs().max())
        del out, ref
        ms = [cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20) for _ in range(2)]
        paced = cuda_ms(lambda: w2p.warp_rows_t(data, cols, D), 20, device_paced=True)
        plain = cuda_ms(lambda: w2p.warp_rows_t_reference(data, cols, D), 5)
        lib_ms = cuda_ms(grid_sample, 20)
        lib_paced = cuda_ms(grid_sample, 20, device_paced=True)
        moved, bound_ms, bound_by = k1_bound(C, R, W_in, W_out)
        print(
            f"K1 {case['name']} {(C, R, W_in)} -> {(C, W_out, R)} D={D}: bitwise, "
            f"{ms[0]} / {ms[1]} ms, {moved / (min(ms) * 1e6):.1f} GB/s, bound "
            f"{bound_ms} ms ({bound_by}), {100 * bound_ms / min(ms):.1f}% of bound; "
            f"device-paced {paced} ms ({100 * bound_ms / paced:.1f}% of bound); plain "
            f"{plain} ms; library call F.grid_sample {lib_ms} ms (device-paced {lib_paced} ms, "
            f"max|diff| to K1 {lib_err}); geometry {w2p.warp_rows_t_geometry(C, R, W_out)}"
        )


def phase_rows(w2p) -> dict:
    """K2 and K3 vs their plain version, vs each other and vs K1; times and
    the warp_rows path at the 4K cases."""
    import torch.nn.functional as F

    max_err = {"warp_rows": 0.0, "warp_rows_ring": 0.0}
    timed, path_inputs = [], []
    for k, (R, W_in, D, W_out, scale) in enumerate(ROW_CASES):
        data3, cols = rows_case(3, R, W_in, D, W_out, seed=10 + k)
        cols = (cols * scale).contiguous()
        data = data3.reshape(3 * R, W_in)  # channels folded into rows
        cols3 = cols.repeat(3, 1)
        out2 = w2p.warp_rows(data, cols3, D)
        out3 = w2p.warp_rows(data, cols3, D, ring=True)
        t_out = w2p.warp_rows_t(data3, cols, D)
        torch.cuda.synchronize()
        ref = w2p.warp_rows_reference(data, cols3, D)
        torch.cuda.synchronize()
        errs = {
            "warp_rows": float((out2 - ref).abs().max()),
            "warp_rows_ring": float((out3 - ref).abs().max()),
        }
        same = {
            "K2==plain": bool(torch.equal(out2, ref)),
            "K3==plain": bool(torch.equal(out3, ref)),
            "K2==K3": bool(torch.equal(out2, out3)),
            "K2==K1T": bool(torch.equal(out2.reshape(3, R, -1), t_out.transpose(1, 2))),
        }
        shape = (3 * R, W_in, W_out or W_in)
        print(
            f"K2/K3 {shape} D={D} cols x{scale}: max|kernel-plain| {errs}, "
            f"bitwise {same}"
        )
        if not max(errs.values()) <= 1e-6:
            raise AssertionError(f"K2/K3 disagree with their plain version: {errs}")
        if not (same["K2==K3"] and same["K2==K1T"]):
            raise AssertionError(f"K2, K3 and K1 transposed differ: {same}")
        for name, err in errs.items():
            max_err[name] = max(max_err[name], err)
        del out2, out3, t_out, ref
        if R != H:
            continue
        # plain, K2, K3, K3, K2, plain: drift on the card shows as a gap
        # between the two readings of one version.
        p1 = cuda_ms(lambda: w2p.warp_rows_reference(data, cols3, D), 10)
        k2a = cuda_ms(lambda: w2p.warp_rows(data, cols3, D), 20)
        k3a = cuda_ms(lambda: w2p.warp_rows(data, cols3, D, ring=True), 20)
        k3b = cuda_ms(lambda: w2p.warp_rows(data, cols3, D, ring=True), 20)
        k2b = cuda_ms(lambda: w2p.warp_rows(data, cols3, D), 20)
        p2 = cuda_ms(lambda: w2p.warp_rows_reference(data, cols3, D), 10)
        paced = [
            cuda_ms(lambda: w2p.warp_rows(data, cols3, D, ring=ring), 20, device_paced=True)
            for ring in (False, True)
        ]
        # The library call: one F.grid_sample on the (1, 1, R, W_in) rows,
        # y on each row's centre, x the clipped cols, bilinear, border
        # padding (the chain-edge clamp never binds within the bound D).
        Rf, Wo = data.shape[0], cols3.shape[1]
        gx = 2.0 * cols3.clamp(0.0, float(W_in - 1)) / (W_in - 1) - 1.0
        gy = (2.0 * torch.arange(Rf, device=data.device) / (Rf - 1) - 1.0)[:, None]
        grid = torch.stack([gx, gy.expand(Rf, Wo)], dim=-1)[None].contiguous()
        img = data[None, None]

        def grid_sample():
            return F.grid_sample(
                img, grid, mode="bilinear", padding_mode="border", align_corners=True
            )

        g_ms = [cuda_ms(grid_sample, 20), cuda_ms(grid_sample, 20)]
        g_paced = cuda_ms(grid_sample, 20, device_paced=True)
        g_err = float((grid_sample()[0, 0] - w2p.warp_rows(data, cols3, D)).abs().max())
        moved = 4.0 * (Rf * W_in + 2 * Rf * Wo)
        # Per output: 2 clamp, add, floor, sub, 2 clamp, lerp (3).
        bound_ms, bound_by = bound(moved, 10.0 * Rf * Wo)
        row = {
            "D": D,
            "K2_ms": [k2a, k2b],
            "K3_ms": [k3a, k3b],
            "plain_ms": [p1, p2],
            "library_ms": g_ms,
            "library_paced_ms": g_paced,
            "library_max_abs_diff": g_err,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        timed.append(row)
        print(
            f"K2/K3 {shape} D={D}: K2 {k2a} / {k2b} ms, K3 {k3a} / {k3b} ms, plain "
            f"{p1} / {p2} ms, device-paced K2 {paced[0]} ms, K3 {paced[1]} ms, bound "
            f"{bound_ms} ms ({bound_by}, {moved / 1e6:.1f} MB); "
            f"library call F.grid_sample {g_ms[0]} / {g_ms[1]} ms, device-paced {g_paced} ms, "
            f"max|diff| to K2 {g_err}"
        )
        path_inputs.append((data, cols3, D))
        del grid, gx, gy

    # The warp_rows path: the public entry point at the 4K cases, each schedule.
    reset_counts(w2p)
    torch.cuda.synchronize()
    for data, cols3, D in path_inputs:
        for ring in (False, True):
            w2p.warp_rows(data, cols3, D, ring=ring)
    torch.cuda.synchronize()
    launches = read_counts(w2p)
    n = len(path_inputs)
    check_counts(launches, {"warp_rows": n, "warp_rows_ring": n}, "warp_rows path")
    print(f"warp_rows path: launches {launches}")
    return {"max_abs_err": max_err, "timed": timed, "launches": launches}


def smooth_image(device) -> torch.Tensor:
    """Photograph-like smooth RGB in [0, 1]: a few seeded low-frequency waves."""
    rng = np.random.default_rng(1)
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    chans = []
    for _ in range(3):
        acc = torch.zeros((H, W), device=device)
        for _ in range(6):
            wl = rng.uniform(40.0, 400.0)
            ang, ph = rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
            acc += torch.sin(2 * np.pi * (yy * np.sin(ang) + xx * np.cos(ang)) / wl + ph)
        chans.append((acc - acc.min()) / (acc.max() - acc.min()))
    return torch.stack(chans, dim=-1)


def phase_two_pass(dt, device) -> dict:
    from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

    field, _ = dt.CurvatureCorrection(config=CURVATURE).pullback_field((H, W), device)
    bound = float((field - identity_grid(tuple(field.shape[1:]), device)).abs().max())
    max_disp = int(np.ceil(bound)) + 1
    img = smooth_image(device)
    two = warp_backend(img, field, order=1, max_disp=max_disp, force="kernel")
    ref = warp_backend(img, field, order=1, force="gather")
    torch.cuda.synchronize()
    err = (two - ref)[8:-8, 8:-8].abs().cpu().numpy()
    gate = {
        "mean": float(err.mean()),
        "p999": float(np.percentile(err, 99.9)),
        "max": float(err.max()),
        "max_disp": max_disp,
    }
    print(f"two-pass vs gather on the 4K curvature field: {gate}")
    if not (gate["mean"] < 2e-3 and gate["p999"] < 0.05 and gate["max"] < 0.45):
        raise AssertionError(f"two-pass gate failed: {gate}")
    return gate


def build_lanes(dt, device) -> dict:
    """The bench configuration's public objects and both lanes' pipelines,
    on a seeded synthetic frame (bench.py:42-49, :92)."""
    rng = np.random.default_rng(0)
    base_u8 = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    curv = dt.CurvatureCorrection(config=CURVATURE)
    trans = dt.TranslationCorrection([2.0, -3.0])
    base_img = dt.OpticalImage(
        torch.from_numpy(base_u8).to(device), transformations=[trans, curv], **META
    ).img_as(torch.float32)
    analysis = dt.ConcentrationAnalysis(
        base=base_img,
        signal_reduction=dt.MonochromaticReduction(color="gray"),
        restoration=lambda s: dt.H1_regularization(
            s, mu=1.0, omega=0.2, dim=2, solver=dt.Jacobi(maxiter=10)
        ),
        model=dt.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )
    registration = dt.ImageRegistration(
        base_img, N_patches=[8, 16], rel_overlap=0.1, quality_tol=0.02
    )
    objs = {"transformations": [trans, curv], "registration": registration}
    return {
        "base_u8": base_u8,
        "probe_u8": np.roll(base_u8, shift=(2, 3), axis=(0, 1)),
        "trans": trans,
        "curv": curv,
        "analysis": analysis,
        "registration": registration,
        "two_warp": dt.FusedAnalysisPipeline(analysis=analysis, **objs),
        "single_warp": dt.FusedAnalysisPipeline(
            analysis=analysis, single_warp=True, **objs
        ),
    }


def run_frames(w2p, pipeline, probe, frames: int, path: str):
    """``WINDOWS`` back-to-back windows of ``frames`` timed frames (host
    clock, each closed by a synchronize), every count set to 0 just before
    and read just after; exactly 4 K1 launches per frame.  Returns (out,
    ms/frame of all frames over all their time, counts, ms/frame of each
    window)."""
    reset_counts(w2p)
    torch.cuda.synchronize()
    per_window = []
    for _ in range(WINDOWS):
        tic = time.perf_counter()
        for _ in range(frames):
            out = pipeline(probe)
        torch.cuda.synchronize()
        per_window.append((time.perf_counter() - tic) / frames * 1e3)
    counts = read_counts(w2p)
    check_counts(counts, {"warp_rows_t": 4 * frames * WINDOWS}, path)
    conc = out.img
    if tuple(conc.shape) != (OH, W) or not bool(torch.isfinite(conc).all()):
        raise AssertionError(f"{path}: bad concentration, shape {tuple(conc.shape)}")
    return out, float(np.mean(per_window)), counts, per_window


def plain_frames(w2p, pipeline, probe, conc, frames: int, path: str):
    """The frame with K1 swapped for its plain version: (mean |dconc|, ms)."""
    before = read_counts(w2p)
    plain = pipeline(probe, warp_impl="plain").img
    torch.cuda.synchronize()
    if read_counts(w2p) != before:
        raise AssertionError(f"{path}: the plain run launched a kernel")
    diff = float((plain - conc).abs().mean())
    if not diff <= 1e-5:
        raise AssertionError(f"{path}: kernel vs plain frame, mean |dconc| = {diff}")
    tic = time.perf_counter()
    for _ in range(frames):
        pipeline(probe, warp_impl="plain")
    torch.cuda.synchronize()
    return diff, (time.perf_counter() - tic) / frames * 1e3


def phase_main_path(dt, w2p, lanes, device, card: str, profile) -> dict:
    pipeline = lanes["two_warp"]
    probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    tic = time.perf_counter()
    pipeline(probe)  # warm-up: builds the setup products
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic

    frames = 5
    torch.cuda.reset_peak_memory_stats(device)
    out, ms, counts, windows = run_frames(w2p, pipeline, probe, frames, "two-warp lane")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    conc = out.img

    # The bench's full-path gate (bench.py:162-180): the same public objects
    # run as separate stages must give the same concentration.
    registered = lanes["registration"](staged_probe(dt, lanes, device))
    staged = lanes["analysis"](registered).img
    staged_err = float((staged - conc).abs().mean())
    if not staged_err <= 1e-3:
        raise AssertionError(f"staged vs fused path: mean |dconc| = {staged_err}")

    diff, plain_ms = plain_frames(w2p, pipeline, probe, conc, frames, "two-warp lane")
    mpix = H * W / 1e3 / ms
    result = {
        "ms_per_frame": ms,
        "ms_per_frame_windows": windows,
        "mpix_s": mpix,
        "plain_k1_ms_per_frame": plain_ms,
        "launches": counts["warp_rows_t"],
        "frames": frames,
        "setup_s": setup_s,
        "peak_gib": peak_gib,
        "mean_abs_dconc_plain": diff,
        "mean_abs_dconc_staged": staged_err,
        "image": out,
    }
    print(
        f"main path (two-warp lane): {ms} ms/frame ({WINDOWS} windows of "
        f"{frames} frames, each {windows}), {mpix} Mpix/s ({H}x{W} uint8 in, "
        f"launches {counts}) on {card}; with plain K1 "
        f"{plain_ms} ms/frame; mean|dconc| vs plain K1 {diff}, vs staged objects "
        f"{staged_err}; peak {peak_gib:.2f} GiB; first frame (setup) {setup_s:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: pipeline(probe), ms, profile, "two_warp")
        stage_times(pipeline, probe)
    return result


def phase_single_warp(w2p, lanes, device, card: str, profile) -> dict:
    pipeline = lanes["single_warp"]
    probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    tic = time.perf_counter()
    pipeline(probe)  # warm-up: builds the lane's setup products
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    frames = 5
    out, ms, counts, windows = run_frames(
        w2p, pipeline, probe, frames, "single-warp lane"
    )
    diff, plain_ms = plain_frames(
        w2p, pipeline, probe, out.img, frames, "single-warp lane"
    )

    # The blob gate of bench.py:207-237: a synthetic tracer blob's integrated
    # concentration matches the two-warp lane's, and the off-blob noise
    # floor does not grow.
    yy, xx = np.ogrid[:H, :W]
    blob = 40.0 * np.exp(
        -(((yy - H * 0.6) / 160.0) ** 2 + ((xx - W * 0.4) / 260.0) ** 2)
    )
    blob_u8 = np.clip(lanes["probe_u8"].astype(np.int32) + blob[..., None], 0, 255)
    blob_probe = torch.from_numpy(blob_u8.astype(np.uint8)).to(device)
    conc_two = lanes["two_warp"](blob_probe).img.cpu().numpy()
    conc_one = pipeline(blob_probe).img.cpu().numpy()
    bmask = (blob > 4.0)[: conc_two.shape[0], : conc_two.shape[1]]
    integral_two = float(conc_two[bmask].sum())
    blob_rel_err = abs(float(conc_one[bmask].sum()) - integral_two) / max(
        abs(integral_two), 1e-12
    )
    noise_ratio = float(conc_one[~bmask].mean()) / max(
        float(conc_two[~bmask].mean()), 1e-12
    )
    print(
        f"single-warp blob gate: blob_rel_err={blob_rel_err} "
        f"noise_ratio={noise_ratio}"
    )
    if not (blob_rel_err <= 5e-2 and noise_ratio <= 1.3):
        raise AssertionError(f"single-warp gate: {blob_rel_err}, {noise_ratio}")

    mpix = H * W / 1e3 / ms
    print(
        f"single-warp lane: {ms} ms/frame ({WINDOWS} windows of {frames} "
        f"frames, each {windows}), {mpix} Mpix/s (launches {counts}) on {card}; "
        f"with plain K1 {plain_ms} ms/frame; mean|dconc| vs plain K1 {diff}; "
        f"first frame (setup) {setup_s:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: pipeline(probe), ms, profile, "single_warp")
    return {
        "ms_per_frame": ms,
        "ms_per_frame_windows": windows,
        "mpix_s": mpix,
        "plain_k1_ms_per_frame": plain_ms,
        "launches": counts["warp_rows_t"],
        "mean_abs_dconc_plain": diff,
        "blob_rel_err": blob_rel_err,
        "noise_ratio": noise_ratio,
    }


def phase_series(w2p, lanes, device, card: str) -> dict:
    """An 8-frame series through both lanes: 32 K1 launches per series, each
    frame equal to the lane's single-frame call."""
    base_u8 = lanes["base_u8"]
    frames = [np.roll(base_u8, shift=(2 + k, 3), axis=(0, 1)) for k in range(SERIES_T)]
    series = torch.from_numpy(np.stack(frames, axis=2)).to(device)  # (H, W, T, C)
    result = {}
    for lane in ("two_warp", "single_warp"):
        pipeline = lanes[lane]
        pipeline(series)  # warm-up
        reps = 3
        reset_counts(w2p)
        torch.cuda.synchronize()
        per_run = []
        for _ in range(reps):
            tic = time.perf_counter()
            out = pipeline(series)
            torch.cuda.synchronize()
            per_run.append((time.perf_counter() - tic) / SERIES_T * 1e3)
        counts = read_counts(w2p)
        check_counts(counts, {"warp_rows_t": 4 * SERIES_T * reps}, f"{lane} series")
        conc = out.img
        if not out.series or tuple(conc.shape) != (OH, W, SERIES_T):
            raise AssertionError(f"{lane} series: bad output {tuple(conc.shape)}")
        if not bool(torch.isfinite(conc).all()):
            raise AssertionError(f"{lane} series: non-finite output")
        for k in range(SERIES_T):
            single = pipeline(series[:, :, k].contiguous()).img
            if not torch.equal(conc[..., k], single):
                err = float((conc[..., k] - single).abs().max())
                raise AssertionError(f"{lane} series frame {k} != single frame: {err}")
        ms = float(np.mean(per_run))
        mpix = H * W / 1e3 / ms
        print(
            f"{lane} series ({H}x{W}x{SERIES_T} uint8): {ms} ms/frame ({reps} "
            f"runs, each {per_run}), {mpix} Mpix/s, launches {counts} on {card}; "
            "every frame == its single-frame call"
        )
        result[lane] = {
            "ms_per_frame": ms,
            "ms_per_frame_runs": per_run,
            "mpix_s": mpix,
            "launches": counts["warp_rows_t"],
        }
    return result


def median_call_ms(w2p, fn, reps: int, want_k1: int, path: str):
    """``reps`` calls of ``fn`` (host clock, each closed by a synchronize),
    every count set to 0 just before and read just after: exactly ``want_k1``
    K1 launches per call.  Returns (last output, median ms, each ms, counts)."""
    reset_counts(w2p)
    torch.cuda.synchronize()
    each = []
    for _ in range(reps):
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        each.append((time.perf_counter() - tic) * 1e3)
    counts = read_counts(w2p)
    check_counts(counts, {"warp_rows_t": want_k1 * reps}, path)
    return out, float(np.median(each)), each, counts


def staged_probe(dt, lanes, device):
    """The probe corrected as a staged Image, float32: what registration takes."""
    probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    trans, curv = lanes["trans"], lanes["curv"]
    return dt.OpticalImage(probe, transformations=[trans, curv], **META).img_as(torch.float32)


def phase_flexible(dt, w2p, lanes, device, card: str, profile) -> dict:
    """The flexible registration lane (``fused=False``) at 4K: one K1 pair per
    call, against plain K1, its field against the fused lane's, and
    displacement/apply/evaluate."""
    from darsia_tpu_torch.analysis.translationanalysis import _to_gray
    from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

    tic = time.perf_counter()
    base = lanes["analysis"].base
    probe = staged_probe(dt, lanes, device)
    reg = dt.ImageRegistration(
        base, N_patches=[8, 16], rel_overlap=0.1, quality_tol=0.02, fused=False
    )
    reg(probe)  # warm-up: the base spectra
    out, ms, each, counts = median_call_ms(w2p, lambda: reg(probe), 5, 2, "flexible lane")

    ta = reg._engine.translation_analysis
    shape = tuple(base.num_voxels)
    field = reg.displacement()
    coords = identity_grid(shape, device) - field
    max_disp = int(np.ceil(field.abs().max().item())) + 1
    plain = warp_backend(probe.img, coords, max_disp=max_disp, warp_impl="plain")
    d_plain = float((out.img - plain).abs().mean())
    if not d_plain <= 1e-5:
        raise AssertionError(f"flexible lane vs plain K1: mean |diff| = {d_plain}")

    # The fused lane on the same frame, where every patch passes: its field
    # differs only by its float32 TPS evaluation, bounded by twice the 6e-4
    # px figure of tests/test_torch_registration.py::FUSED_TPS_ERR_4K (1e-3).
    estimate, ops, geom = lanes["registration"]._engine.translation_analysis.fused_estimator_parts(D_REG)
    field_c, _, quality = estimate(_to_gray(probe.img), ops)
    if not bool((quality > geom["tol"]).all()) or not ta.have_translation.all():
        raise AssertionError("not every patch passes: the fields differ by design")
    fused = torch.nn.functional.interpolate(
        field_c[None], size=shape, mode="bilinear", align_corners=False
    )[0].clamp(-geom["clip"], geom["clip"])
    d_fused = float((fused - field).abs().max())
    if not d_fused <= 2e-3:
        raise AssertionError(f"fused vs flexible field: max |diff| = {d_fused} px")

    applied = reg.apply(probe)
    pts_px = np.array([[100.0, 200.0], [1500.0, 900.0]])
    pts_m = np.array([[0.5, 0.5], [2.0, 1.0]])
    ok = (
        tuple(field.shape) == (2, *shape)
        and bool(torch.isfinite(field).all())
        and applied.img.shape == probe.img.shape
        and bool(torch.isfinite(applied.img).all())
        and reg.evaluate(pts_px, units="pixel").shape == (2, 2)
        and bool(np.isfinite(reg.evaluate(pts_px, units="pixel")).all())
        and bool(np.isfinite(reg.evaluate(pts_m, units="metric")).all())
    )
    if not ok:
        raise AssertionError("flexible lane: displacement/apply/evaluate not finite or misshaped")
    seconds = time.perf_counter() - tic
    print(
        f"flexible registration ({shape[0]}x{shape[1]}, 8x16 patches): {ms} ms per call "
        f"(median of 5: {each}), launches {counts} on {card}; mean|diff| vs plain K1 "
        f"{d_plain}; max|fused - flexible field| {d_fused} px (bound 2e-3); "
        f"phase {seconds:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: reg(probe), ms, profile, "flexible")
    return {"ms": ms, "launches": counts["warp_rows_t"], "fused_vs_flexible_px": d_fused}


def phase_pipeline_displacement(dt, w2p, lanes, device) -> dict:
    """``registration.displacement()`` after a two-warp pipeline frame against
    the flexible field built from the frame's staged shifts."""
    tic = time.perf_counter()
    pipeline = lanes["two_warp"]
    probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    reset_counts(w2p)
    torch.cuda.synchronize()
    pipeline(probe)
    torch.cuda.synchronize()
    counts = read_counts(w2p)
    check_counts(counts, {"warp_rows_t": 4}, "pipeline frame")
    ta = pipeline._translation_analysis
    shifts, quality, centers = ta._pending_shifts
    field = lanes["registration"].displacement()
    fresh = dt.TranslationAnalysis(
        ta.base, N_patches=ta.N_patches, rel_overlap=ta.rel_overlap, quality_tol=ta.quality_tol
    )
    fresh._ingest_shifts(shifts.cpu().numpy(), quality.cpu().numpy(), centers)
    ref = fresh.displacement_field(tuple(ta.base.num_voxels))
    diff = float((field - ref).abs().max())
    if not diff <= 1e-5:
        raise AssertionError(f"displacement() after a frame: max |diff| = {diff} px")
    print(
        f"displacement() after a pipeline frame: max|diff| to the flexible field of "
        f"its shifts {diff} px; phase {time.perf_counter() - tic:.2f} s"
    )
    return {"launches": counts["warp_rows_t"]}


def phase_multiscale(dt, w2p, lanes, device, card: str, profile) -> dict:
    """Multiscale registration with 3 levels at 4K: one K1 pair per level."""
    from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

    tic = time.perf_counter()
    base = lanes["analysis"].base
    probe = staged_probe(dt, lanes, device)
    reg = dt.ImageRegistration(
        base, N_patches=[8, 16], rel_overlap=0.1, quality_tol=0.02, num_levels=3
    )
    reg(probe)  # warm-up
    out, ms, each, counts = median_call_ms(w2p, lambda: reg(probe), 5, 6, "multiscale")
    field = reg.displacement()
    coords = identity_grid(tuple(base.num_voxels), device) - field
    max_disp = int(np.ceil(field.abs().max().item())) + 1
    plain = warp_backend(probe.img, coords, max_disp=max_disp, warp_impl="plain")
    diff = float((out.img - plain).abs().mean())
    if not diff <= 1e-5:
        raise AssertionError(f"multiscale vs plain K1: mean |diff| = {diff}")
    if not (bool(torch.isfinite(out.img).all()) and out.img.shape == probe.img.shape):
        raise AssertionError("multiscale: bad output")
    print(
        f"multiscale registration (3 levels, {tuple(base.num_voxels)}): {ms} ms per call "
        f"(median of 5: {each}), launches {counts} on {card}; mean|diff| vs plain K1 "
        f"{diff}; phase {time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: reg(probe), ms, profile, "multiscale")
    return {"ms": ms, "launches": counts["warp_rows_t"]}


def phase_series_correction(dt, w2p, lanes, device, card: str, profile) -> dict:
    """An 8-frame uint8 series corrected by the translation + curvature chain
    at construction: one K1 pair per series, each frame bitwise equal to the
    frame corrected alone; the frame loop timed beside it."""
    from darsia_tpu_torch.corrections.base import BaseCorrection
    from darsia_tpu_torch.corrections.fuse import fused_chain

    tic = time.perf_counter()
    series = torch.from_numpy(series_frames(lanes["base_u8"])).to(device)
    chain_members = [lanes["trans"], lanes["curv"]]
    meta = {**META, "series": True, "time": [30.0 * k for k in range(SERIES_T)]}

    def correct():
        return dt.OpticalImage(series, transformations=chain_members, **meta)

    correct()  # warm-up
    out, ms, each, counts = median_call_ms(w2p, correct, 5, 2, "series correction")
    for k in range(SERIES_T):
        single = dt.OpticalImage(
            series[:, :, k].contiguous(), transformations=chain_members, **META
        ).img
        if not torch.equal(out.img[:, :, k], single):
            err = float((out.img[:, :, k].float() - single.float()).abs().max())
            raise AssertionError(f"series correction frame {k} != the frame alone: {err}")
    # The two ways to warp a series, in turns (folded, loop, loop, folded),
    # 10 back-to-back series each.
    chain = fused_chain(chain_members, (H, W), device)
    fold = lambda: chain.correct_series_array(series, 2)  # noqa: E731
    loop = lambda: BaseCorrection.correct_series_array(chain, series, 2)  # noqa: E731
    turns = [cuda_ms(f, 10) for f in (fold, loop, loop, fold)]
    print(
        f"series correction ({H}x{W}x{SERIES_T}x3 uint8): {ms} ms per series (median "
        f"of 5: {each}), launches {counts} on {card}; every frame == the frame alone; "
        f"the warp alone, in turns: folded (1 K1 pair) {turns[0]} / {turns[3]} ms, "
        f"frame loop ({SERIES_T} pairs) {turns[1]} / {turns[2]} ms; phase "
        f"{time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(fold, turns[0], profile, "series_correction_folded")
        profile_frame(loop, turns[1], profile, "series_correction_loop")
    return {"ms": ms, "launches": counts["warp_rows_t"], "image": out}


def phase_series_concentration(dt, lanes, device, corrected, card: str) -> None:
    """ConcentrationAnalysis with 2 extra baselines (the cleaning filter) on
    the corrected series: every frame equal to its single-frame result."""
    tic = time.perf_counter()
    trans, curv = lanes["trans"], lanes["curv"]
    extras = [
        dt.OpticalImage(
            torch.from_numpy(np.roll(lanes["base_u8"], s, axis=(0, 1))).to(device),
            transformations=[trans, curv],
            **META,
        ).img_as(torch.float32)
        for s in ((0, 1), (1, 0))
    ]
    ref = lanes["analysis"]
    analysis = dt.ConcentrationAnalysis(
        base=[ref.base] + extras,
        signal_reduction=ref.signal_reduction,
        restoration=ref.restoration,
        model=ref.model,
        **{"diff option": "positive"},
    )
    if analysis.threshold_cleaning_filter is None:
        raise AssertionError("no cleaning filter from the extra baselines")
    series = corrected.img_as(torch.float32)
    analysis(series)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = analysis(series)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    conc = out.img
    if not (out.series and tuple(conc.shape) == (OH, W, SERIES_T)):
        raise AssertionError(f"series concentration: bad output {tuple(conc.shape)}")
    if not bool(torch.isfinite(conc).all()):
        raise AssertionError("series concentration: non-finite output")
    for k in range(SERIES_T):
        frame = dt.OpticalImage(series.img[:, :, k].contiguous(), **META)
        if not torch.equal(conc[..., k], analysis(frame).img):
            raise AssertionError(f"series concentration frame {k} != single frame")
    print(
        f"series concentration with the cleaning filter ({OH}x{W}x{SERIES_T}): {ms} ms "
        f"per series on {card}; every frame == its single-frame result; phase "
        f"{time.perf_counter() - tic:.2f} s"
    )


# The rig frame: the bench frame with a 4x6 checker of the post-2014 reference
# swatches painted at CHECKER_AT, SWATCH_PX per swatch.
CHECKER_AT, SWATCH_PX = (200, 2600), 60
# The rig's illumination config (IlluminationCorrectionConfig's defaults).
ILLUMINATION = {"width": 100, "num_samples": 30, "seed": 42}
RIG_INTERIOR = (slice(32, -32), slice(32, -32))


def rig_frame(dt, base_u8) -> tuple[np.ndarray, np.ndarray]:
    """(frame, painted corners TL-BL-BR-TR (row, col))."""
    ref = dt.ColorCheckerAfter2014().swatches_rgb
    frame = base_u8.copy()
    r0, c0 = CHECKER_AT
    h, w = 4 * SWATCH_PX, 6 * SWATCH_PX
    patch = np.kron(ref, np.ones((SWATCH_PX, SWATCH_PX, 1))) * 255
    frame[r0 : r0 + h, c0 : c0 + w] = patch.astype(np.uint8)
    corners = np.array([[r0, c0], [r0 + h, c0], [r0 + h, c0 + w], [r0, c0 + w]])
    return frame, corners


def build_rig(dt, lanes, device) -> dict:
    """The rig's corrections, set up as presets/workflows/rig.py:103-214 of the
    JAX package sets them up, on the rig frame."""
    from types import SimpleNamespace

    tic = time.perf_counter()
    frame, corners = rig_frame(dt, lanes["base_u8"])
    baseline = dt.OpticalImage(torch.from_numpy(frame).to(device), **META)
    t0 = time.perf_counter()
    _, voxels = dt.find_colorchecker(baseline)
    finder_s = time.perf_counter() - t0
    off = int(np.abs(np.asarray(voxels) - corners).max())
    if off > 16:
        raise AssertionError(f"find_colorchecker: {voxels.tolist()} is {off} px off {corners.tolist()}")
    drift = dt.DriftCorrection(baseline, config={"roi": voxels})
    curv = dt.CurvatureCorrection(config=CURVATURE)
    shape = [dt.Resize(shape=(H, W)), drift, curv]
    corrected = dt.OpticalImage(baseline.img, transformations=shape, **META)
    _, color_voxels = dt.find_colorchecker(corrected)
    illumination = dt.IlluminationCorrection()
    config = SimpleNamespace(**ILLUMINATION)
    samples = illumination.select_random_samples(
        np.ones(corrected.img.shape[:2], dtype=bool), config
    )
    t0 = time.perf_counter()
    illumination.setup(
        corrected,
        [samples],
        outliers=0.1,
        colorspace="hsl-scalar",
        interpolation="illumination",
    )
    illumination_s = time.perf_counter() - t0
    color = dt.ColorCorrection(corrected, {"roi": color_voxels, "clip": False})
    torch.cuda.synchronize()
    print(
        f"rig setup: checker at {voxels.tolist()} ({off} px off the painted corners, "
        f"finder {finder_s:.3f} s), on the corrected baseline at "
        f"{np.asarray(color_voxels).tolist()}; {len(samples)} illumination samples, "
        f"setup {illumination_s:.2f} s; all {time.perf_counter() - tic:.2f} s"
    )
    probe = torch.from_numpy(np.roll(frame, shift=(2, 3), axis=(0, 1))).to(device)
    return {
        "frame": frame,
        "baseline": baseline,
        "probe": probe,
        "drift": drift,
        "curv": curv,
        "shape": shape,
        "colour": [illumination, color],
        "illumination": illumination,
    }


def device_busy_ms(fn, calls: int = 2) -> float:
    """Device busy time per call of ``fn`` (the union of its kernel, memcpy and
    memset intervals in a torch.profiler trace)."""
    import tempfile

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    return busy_us(events) / 1e3 / calls


def busy_us(events: list) -> float:
    """The union of the device intervals (kernels, copies, sets) of a trace, us."""
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"])
        for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
    )
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy


def plain_k1(w2p):
    """A context in which every K1 call takes the plain version."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        wrapper = w2p.warp_rows_t
        w2p.warp_rows_t = lambda data, cols, max_disp, impl="auto": wrapper(
            data, cols, max_disp, "plain"
        )
        try:
            yield
        finally:
            w2p.warp_rows_t = wrapper

    return swapped()


def phase_rig_read(dt, w2p, rig, device, card: str, profile) -> dict:
    """The rig's reading path: one photograph through the shape and colour
    corrections, as ``OpticalImage(frame, transformations=...)``."""
    from darsia_tpu_torch.corrections.color.colorcorrection import CustomColorChecker

    tic = time.perf_counter()
    transformations = rig["shape"] + rig["colour"]

    def read(img):
        return dt.OpticalImage(img, transformations=transformations, **META)

    read(rig["probe"])  # warm-up
    # The time of the swatch extraction (the crop's warp and resize on the
    # card, its copy to the host, 24 k-means).
    extract, spent = CustomColorChecker._extract_from_image, []

    def timed_extract(img):
        t0 = time.perf_counter()
        out = extract(img)
        spent.append(time.perf_counter() - t0)
        return out

    CustomColorChecker._extract_from_image = staticmethod(timed_extract)
    try:
        out, ms, each, counts = median_call_ms(
            w2p, lambda: read(rig["probe"]), 5, 4, "rig reading path"
        )
    finally:
        CustomColorChecker._extract_from_image = staticmethod(extract)
    extract_ms = 1e3 * sum(spent) / len(spent)
    img = out.img
    if tuple(img.shape) != (OH, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"rig reading path: bad output {tuple(img.shape)}")
    t = rig["drift"].pullback_translation(rig["probe"]).cpu().numpy()
    drift_err = float(np.abs(t - np.array([2.0, 3.0])).max())
    if not drift_err <= 0.05:
        raise AssertionError(f"drift estimate {t.tolist()}, {drift_err} px off the roll (2, 3)")
    with plain_k1(w2p):
        before = read_counts(w2p)
        plain = read(rig["probe"]).img
        torch.cuda.synchronize()
        if read_counts(w2p) != before:
            raise AssertionError("rig reading path: the plain run launched a kernel")
    d_plain = float((plain - img).abs().mean())
    if not d_plain <= 1e-5:
        raise AssertionError(f"rig reading path vs plain K1: mean |diff| = {d_plain}")
    base = read(rig["baseline"].img).img
    d_base = float((img - base)[RIG_INTERIOR].abs().mean())
    if not d_base <= 0.02:
        raise AssertionError(f"corrected probe vs corrected baseline: mean |diff| = {d_base}")
    busy = device_busy_ms(lambda: read(rig["probe"]))
    print(
        f"rig reading path ({H}x{W} uint8 -> {OH}x{W} float32, Resize + drift + curvature "
        f"+ illumination + colour): {ms} ms per call (median of 5: {each}), launches "
        f"{counts} on {card}; device busy {busy:.3f} ms per call, host "
        f"{ms - busy:.3f} ms (of which the swatch extraction {extract_ms:.3f} ms); "
        f"drift estimate {t.tolist()} ({drift_err} px off the roll); mean|diff| vs "
        f"plain K1 {d_plain}, vs the corrected baseline (interior) {d_base}; phase "
        f"{time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: read(rig["probe"]), ms, profile, "rig_read")
    return {
        "ms": ms,
        "launches": counts["warp_rows_t"],
        "device_busy_ms": busy,
        "extract_ms": extract_ms,
        "drift_err_px": drift_err,
    }


def phase_drift_pipeline(dt, w2p, lanes, rig, device, card: str, profile) -> dict:
    """The two-warp lane with [drift, curvature, illumination] as its chain."""
    tic = time.perf_counter()
    members = [rig["drift"], rig["curv"], rig["illumination"]]
    pipeline = dt.FusedAnalysisPipeline(
        transformations=members,
        registration=lanes["registration"],
        analysis=lanes["analysis"],
    )
    probe = rig["probe"].to(torch.float32) / 255.0
    pipeline(probe)  # warm-up
    torch.cuda.synchronize()
    frames = 5
    out, ms, counts, windows = run_frames(w2p, pipeline, probe, frames, "drift lane")
    conc = out.img
    corrected = dt.OpticalImage(probe, transformations=members, **META)
    staged = lanes["analysis"](lanes["registration"](corrected.img_as(torch.float32))).img
    staged_err = float((staged - conc).abs().mean())
    if not staged_err <= 1e-3:
        raise AssertionError(f"drift lane vs staged objects: mean |dconc| = {staged_err}")
    diff, plain_ms = plain_frames(w2p, pipeline, probe, conc, frames, "drift lane")
    # Against phase 5's lane, in turns (phase 5, drift, drift, phase 5), one
    # window of 5 frames each: the host's pace drifts between phases.
    bench_probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    turns = []
    for lane, x in (
        (lanes["two_warp"], bench_probe),
        (pipeline, probe),
        (pipeline, probe),
        (lanes["two_warp"], bench_probe),
    ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            lane(x)
        torch.cuda.synchronize()
        turns.append((time.perf_counter() - t0) / frames * 1e3)
    print(
        f"two-warp lane with a drift member ([drift, curvature, illumination], float32 "
        f"probe): {ms} ms/frame ({WINDOWS} windows of {frames} frames, each {windows}), "
        f"launches {counts} on {card}; with plain K1 {plain_ms} ms/frame; mean|dconc| vs "
        f"plain K1 {diff}, vs staged objects {staged_err}; in turns with phase 5's lane "
        f"(ms/frame, 5 frames each): phase 5 {turns[0]}, drift {turns[1]}, drift "
        f"{turns[2]}, phase 5 {turns[3]}; phase {time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: pipeline(probe), ms, profile, "drift_lane")
    return {"ms_per_frame": ms, "launches": counts["warp_rows_t"], "staged": staged_err}


def phase_drifting_series(dt, w2p, rig, device, card: str) -> dict:
    """An 8-frame series, each frame drifted differently, corrected by
    [drift, curvature] at construction: one K1 pair per frame."""
    tic = time.perf_counter()
    frames = [np.roll(rig["frame"], shift=(2 + k, 3 - k), axis=(0, 1)) for k in range(SERIES_T)]
    series = torch.from_numpy(np.stack(frames, axis=2)).to(device)
    members = [rig["drift"], rig["curv"]]
    meta = {**META, "series": True, "time": [30.0 * k for k in range(SERIES_T)]}

    def correct():
        return dt.OpticalImage(series, transformations=members, **meta)

    correct()  # warm-up
    out, ms, each, counts = median_call_ms(
        w2p, correct, 3, 2 * SERIES_T, "drifting series"
    )
    for k in range(SERIES_T):
        single = dt.OpticalImage(
            series[:, :, k].contiguous(), transformations=members, **META
        ).img
        if not torch.equal(out.img[:, :, k], single):
            err = float((out.img[:, :, k].float() - single.float()).abs().max())
            raise AssertionError(f"drifting series frame {k} != the frame alone: {err}")
    print(
        f"drifting series ({H}x{W}x{SERIES_T}x3 uint8, [drift, curvature]): {ms} ms per "
        f"series (median of 3: {each}), launches {counts} on {card}; every frame == the "
        f"frame alone; phase {time.perf_counter() - tic:.2f} s"
    )
    return {"ms": ms, "launches": counts["warp_rows_t"]}


def bitwise_on_cpu(correction, frame: torch.Tensor, out: torch.Tensor, path: str) -> float:
    """The same object's output for the frame as a CPU tensor, bitwise equal
    to ``out`` from the card; returns the CPU call's seconds."""
    tic = time.perf_counter()
    on_cpu = correction.correct_array(frame.cpu())
    seconds = time.perf_counter() - tic
    if on_cpu.device.type != "cpu" or not torch.equal(out.cpu(), on_cpu):
        differ = int((out.cpu() != on_cpu).sum())
        raise AssertionError(f"{path}: card and CPU outputs differ in {differ} values")
    return seconds


def phase_shape_zoo(dt, w2p, lanes, device, card: str) -> dict:
    """Rotation, affine and generalized perspective corrections on the bench
    frame: nearest-voxel gather warps, no K1."""
    tic = time.perf_counter()
    frame = torch.from_numpy(lanes["base_u8"]).to(device)
    image = dt.OpticalImage(frame, **META)
    cs = image.coordinatesystem
    rng = np.random.default_rng(6)
    results = {}

    def run(name, correction, setup_s):
        correction.correct_array(frame)  # warm-up (and the field's first use)
        out, ms, each, counts = median_call_ms(
            w2p, lambda: correction.correct_array(frame), 5, 0, name
        )
        if out.shape != frame.shape or out.dtype != frame.dtype:
            raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}")
        cpu_s = bitwise_on_cpu(correction, frame, out, name)
        moved = float((out != frame).any(dim=-1).float().mean())
        print(
            f"{name} ({H}x{W} uint8, gather warp order 0): {ms} ms per call (median of 5: "
            f"{each}), launches {counts} on {card}; bitwise equal to the CPU tensor's output "
            f"({cpu_s:.2f} s there); field set-up (host) {setup_s:.3f} s; {100 * moved:.1f}% "
            "of the pixels change"
        )
        results[name] = {"ms": ms, "setup_s": setup_s}

    rotation = dt.RotationCorrection([H / 2, W / 2], rotations=[np.deg2rad(0.5)])
    run("RotationCorrection", rotation, 0.0)

    # 4 coordinate pairs of a 3 px shift and a 0.2 degree turn.
    angle = np.deg2rad(0.2)
    R = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    shift = np.array([3 * cs.voxel_size["x"], -3 * cs.voxel_size["y"]])
    src = np.asarray(cs.coordinate([[200, 300], [1500, 400], [1400, 2900], [300, 2700]]))
    dst = shift + (R @ src.T).T
    affine = dt.AffineCorrection(cs, cs, dt.make_coordinate(src), dt.make_coordinate(dst))
    t = affine.transformation
    fit_err = max(
        np.abs(t.rotation - R).max(), np.abs(t.translation - shift).max(), abs(t.scaling - 1.0)
    )
    if not fit_err <= 1e-9:
        raise AssertionError(f"AffineCorrection: fit off its generating parameters by {fit_err}")
    t0 = time.perf_counter()
    affine._coords(device)
    run("AffineCorrection", affine, time.perf_counter() - t0)

    # 16 coordinate pairs of a mild perspective, in the model's own (inverse)
    # direction: src = (A dst + b) / (c . dst + 1).
    A = np.array([[1.002, 0.003], [-0.002, 0.999]])
    b = np.array([0.004, -0.006])
    c = np.array([2e-3, 1e-3])
    dst = rng.random((16, 2)) * np.array([META["width"], META["height"]])
    src = ((A @ dst.T).T + b) / ((dst @ c) + 1)[:, None]
    t0 = time.perf_counter()
    perspective = dt.GeneralizedPerspectiveCorrection(
        cs, cs, dt.make_coordinate(src), dt.make_coordinate(dst)
    )
    fit_s = time.perf_counter() - t0
    t = perspective.transformation
    fit_err_p = max(np.abs(t.A - A).max(), np.abs(t.b - b).max(), np.abs(t.c - c).max())
    if not fit_err_p <= 1e-6:
        raise AssertionError(f"GeneralizedPerspectiveCorrection: fit off A, b, c by {fit_err_p}")
    t0 = time.perf_counter()
    perspective._coords(device)
    run("GeneralizedPerspectiveCorrection", perspective, time.perf_counter() - t0)
    print(
        f"shape zoo: affine fit off its parameters by {fit_err} (bound 1e-9), perspective fit "
        f"by {fit_err_p} (bound 1e-6, fit {fit_s:.2f} s); phase {time.perf_counter() - tic:.2f} s"
    )
    return results


def phase_piecewise(dt, w2p, lanes, device, card: str, profile) -> dict:
    """``find_and_warp`` on 8x16 patches of the smooth 4K image: one K1 pair
    per call at the bound derived from the field."""
    from darsia_tpu_torch.corrections.shape import piecewiseperspective as module
    from darsia_tpu_torch.ops.warp import identity_grid, warp_backend

    tic = time.perf_counter()
    image = dt.OpticalImage(smooth_image(device), **META)
    patches = dt.Patches(image, [8, 16])
    centers = patches.centers_voxels
    # (x, y) px at the patch centers: smooth, at most 20 px.
    disp = np.stack(
        [
            20.0 * np.sin(np.pi * centers[..., 1] / W) * np.cos(np.pi * centers[..., 0] / H),
            -16.0 * np.sin(np.pi * centers[..., 0] / H),
        ],
        axis=-1,
    )
    transform = dt.PiecewisePerspectiveTransform()

    def warp_once():
        return transform.find_and_warp(patches, disp)

    # The field and bound of a call, recorded where it reaches the warp.
    seen = {}

    def recording(data, coords, **kwargs):
        seen.update(data=data, coords=coords, **kwargs)
        return warp_backend(data, coords, **kwargs)

    module.warp_backend = recording
    try:
        warp_once()  # warm-up
    finally:
        module.warp_backend = warp_backend
    ident = identity_grid((H, W), device)
    derived = int(np.ceil(float((seen["coords"] - ident).abs().max()))) + 1
    if seen["max_disp"] != derived or not 2 <= derived <= 24:
        raise AssertionError(f"piecewise: bound {seen['max_disp']}, derived {derived}")
    out, ms, each, counts = median_call_ms(w2p, warp_once, 5, 2, "piecewise perspective")
    img = out.img
    if img.shape != image.img.shape or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"piecewise: bad output {tuple(img.shape)}")
    ref = warp_backend(seen["data"], seen["coords"], order=1, force="gather")
    plain = warp_backend(
        seen["data"], seen["coords"], order=1, max_disp=derived, warp_impl="plain"
    )
    torch.cuda.synchronize()
    d_plain = float((img - plain).abs().mean())
    if not d_plain <= 1e-5:
        raise AssertionError(f"piecewise vs plain K1: mean |diff| = {d_plain}")
    err = (img - ref)[8:-8, 8:-8].abs().cpu().numpy()
    gate = {
        "mean": float(err.mean()),
        "p999": float(np.percentile(err, 99.9)),
        "max": float(err.max()),
    }
    if not (gate["mean"] < 2e-3 and gate["p999"] < 0.05 and gate["max"] < 0.45):
        raise AssertionError(f"piecewise vs gather warp: {gate}")
    blended = dt.Patches(image, [8, 16], rel_overlap=0.1).blend_and_assemble()
    d_blend = float((blended.img - image.img).abs().max())
    if not d_blend <= 1e-6 or blended.img.device != image.img.device:
        raise AssertionError(f"blend_and_assemble of untouched patches: max |diff| {d_blend}")
    print(
        f"piecewise perspective ({H}x{W}x3 float32, 8x16 patches, |d| <= 20 px, bound "
        f"{derived}): {ms} ms per call (median of 5: {each}), launches {counts} on {card}; "
        f"vs the gather warp of the same field {gate}; mean|diff| vs plain K1 {d_plain}; "
        f"blend_and_assemble of untouched patches max|diff| {d_blend}; phase "
        f"{time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(warp_once, ms, profile, "piecewise")
    lanes["piecewise"] = {"warp": warp_once, "max_disp": derived}
    return {"ms": ms, "launches": counts["warp_rows_t"]}


# The painted checker's box on the rig frame, as slices.
CHECKER_ROI = (
    slice(CHECKER_AT[0], CHECKER_AT[0] + 4 * SWATCH_PX),
    slice(CHECKER_AT[1], CHECKER_AT[1] + 6 * SWATCH_PX),
)


def phase_colour(dt, w2p, rig, device, card: str, profile) -> dict:
    """``RelativeColorCorrection`` (degree 2) against a known gain, and
    ``ExperimentalColorCorrection`` on the rig frame."""
    tic = time.perf_counter()
    reference = smooth_image(device)
    image = dt.OpticalImage(reference, **META)
    cs = image.coordinatesystem
    # The gain 1 / q, q in the span of the degree-2 space (1, y, y^2, x, xy,
    # xy^2): the fit can undo it exactly.
    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    x = float(cs._coordinate_of_origin_voxel[0]) + xx * cs.voxel_size["x"] + 0 * yy
    y = float(cs._coordinate_of_origin_voxel[1]) - yy * cs.voxel_size["y"] + 0 * xx
    q = torch.stack([1.0 + 0.05 * x - 0.1 * y, 0.9 + 0.04 * x * y, 1.1 - 0.06 * y * y + 0.02 * x], -1)
    gain = 1.0 / q
    frame = reference * gain
    relative = dt.RelativeColorCorrection(dt.OpticalImage(frame, **META), config={"degree": 2})
    rng = np.random.default_rng(7)
    for colour in ([0.7, 0.3, 0.4], [0.2, 0.6, 0.5], [0.5, 0.5, 0.8], [0.4, 0.7, 0.2]):
        # A flat colour card under the gain, sampled at 48 voxels.
        voxels = np.stack([rng.integers(0, H, 48), rng.integers(0, W, 48)], axis=1)
        card_frame = torch.tensor(colour, dtype=torch.float32, device=device) * gain
        observed = card_frame[torch.from_numpy(voxels[:, 0]).to(device), torch.from_numpy(voxels[:, 1]).to(device)]
        relative.add_calibration_data(cs.coordinate(voxels), observed.cpu().numpy(), colour)
    del card_frame
    t0 = time.perf_counter()
    relative.calibrate()
    calibrate_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    relative.setup()
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    if relative._evaluated.device != frame.device or tuple(relative._evaluated.shape) != (H, W, 3, 3):
        raise AssertionError("relative colour field: not on the card at (H, W, 3, 3)")
    relative.correct_array(frame)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    out, ms, each, counts = median_call_ms(
        w2p, lambda: relative.correct_array(frame), 5, 0, "relative colour correction"
    )
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    back = float((out - reference).abs().max())
    if not back <= 1e-3:
        raise AssertionError(f"relative colour: corrected frame off its reference by {back}")
    busy = device_busy_ms(lambda: relative.correct_array(frame))
    print(
        f"relative colour correction ({H}x{W}x3 float32, degree 2, field "
        f"{relative._evaluated.numel() * 4 / 1e6:.0f} MB on the card): {ms} ms per call (median "
        f"of 5: {each}), launches {counts} on {card}; device busy {busy:.3f} ms per call; peak "
        f"{peak_gib:.2f} GiB; calibrate {calibrate_ms:.1f} ms (host), set-up {setup_ms:.1f} ms; "
        f"corrected frame vs its reference max|diff| {back} (bound 1e-3)"
    )
    if profile is not None:
        profile_frame(lambda: relative.correct_array(frame), ms, profile, "relative_colour")
    result = {"relative_ms": ms, "relative_setup_ms": setup_ms, "relative_busy_ms": busy}
    del relative, frame, gain, q, out

    rig_frame_t = torch.from_numpy(rig["frame"]).to(device)
    experimental = dt.ExperimentalColorCorrection(roi=CHECKER_ROI)
    experimental.correct_array(rig_frame_t)  # warm-up
    out, ms, each, counts = median_call_ms(
        w2p, lambda: experimental.correct_array(rig_frame_t), 5, 2, "experimental colour correction"
    )
    if tuple(out.shape) != (H, W, 3) or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"experimental colour: bad output {tuple(out.shape)} {out.dtype}")
    swatches = torch.from_numpy(
        np.kron(dt.ColorCheckerAfter2014().swatches_rgb, np.ones((SWATCH_PX, SWATCH_PX, 1))).astype(np.float32)
    ).to(device)
    d_checker = float((out[CHECKER_ROI] - swatches).abs().mean())
    if not d_checker <= 0.02:
        raise AssertionError(f"experimental colour: checker off its reference by {d_checker}")
    busy = device_busy_ms(lambda: experimental.correct_array(rig_frame_t))
    print(
        f"experimental colour correction ({H}x{W} uint8 -> float32): {ms} ms per call (median "
        f"of 5: {each}), launches {counts} on {card}; device busy {busy:.3f} ms per call, the "
        f"host's share {1 - busy / ms:.4f}; checker vs the reference swatches mean|diff| "
        f"{d_checker}; phase {time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: experimental.correct_array(rig_frame_t), ms, profile, "experimental_colour")
    result.update(
        experimental_ms=ms,
        experimental_busy_ms=busy,
        launches=counts["warp_rows_t"],
    )
    return result


def phase_saved_state(dt, w2p, lanes, rig, device, card: str) -> dict:
    """The rig's baseline and corrections saved to a folder and read back;
    ``DeformationCorrection`` in a transformation chain."""
    import tempfile

    tic = time.perf_counter()
    originals = rig["shape"] + rig["colour"]
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp)
        t0 = time.perf_counter()
        rig["baseline"].save(folder / "baseline.npz")
        paths = []
        for kind, corrections in (("shape", rig["shape"]), ("color", rig["colour"])):
            for i, correction in enumerate(corrections):
                name = type(correction).__name__.lower()
                paths.append(folder / f"{kind}_correction_{i}_{name}.npz")
                correction.save(paths[-1])
        save_s = time.perf_counter() - t0
        size_mb = sum(p.stat().st_size for p in folder.iterdir()) / 1e6
        t0 = time.perf_counter()
        baseline = dt.imread(folder / "baseline.npz")
        loaded = [dt.read_correction(p) for p in paths]
        load_s = time.perf_counter() - t0
    if baseline.img.device != rig["baseline"].img.device or not torch.equal(
        baseline.img, rig["baseline"].img
    ):
        raise AssertionError("saved baseline: not read back onto the card, or not equal")
    if type(baseline) is not type(rig["baseline"]) or baseline.dimensions != rig["baseline"].dimensions:
        raise AssertionError("saved baseline: class or dimensions changed")
    if [type(c) for c in loaded] != [type(c) for c in originals]:
        raise AssertionError(f"read_correction: {[type(c).__name__ for c in loaded]}")

    def read(transformations):
        return dt.OpticalImage(rig["probe"], transformations=transformations, **META)

    # A correction read from a file sets itself up at its first use (the
    # curvature's composed field, the drift's baseline spectrum), as the
    # originals did in phase 14: one call apart, then the counted ones.
    t0 = time.perf_counter()
    read(loaded)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    via_loaded, ms_loaded, _, counts = median_call_ms(
        w2p, lambda: read(loaded), 1, 4, "reading path through loaded corrections"
    )
    via_originals, ms_originals, _, counts2 = median_call_ms(
        w2p, lambda: read(originals), 1, 4, "reading path through the original corrections"
    )
    if not torch.equal(via_loaded.img, via_originals.img):
        err = float((via_loaded.img - via_originals.img).abs().max())
        raise AssertionError(f"loaded vs original corrections: max |diff| {err}")

    # DeformationCorrection in a chain == the registration called directly.
    config = {"N_patches": [8, 16], "rel_overlap": 0.1, "quality_tol": 0.02}
    base = lanes["analysis"].base
    probe = staged_probe(dt, lanes, device)
    deformation = dt.DeformationCorrection(base, config)
    metadata = probe.metadata()

    def chained():
        return dt.OpticalImage(probe.img, transformations=[deformation], **metadata)

    chained()  # warm-up: the base spectra
    via_chain, ms_chain, _, counts3 = median_call_ms(w2p, chained, 1, 2, "DeformationCorrection")
    direct, _, _, counts4 = median_call_ms(
        w2p, lambda: dt.ImageRegistration(base, **config)(probe), 1, 2, "ImageRegistration"
    )
    if not torch.equal(via_chain.img, direct.img):
        err = float((via_chain.img - direct.img).abs().max())
        raise AssertionError(f"DeformationCorrection vs ImageRegistration: max |diff| {err}")
    launches = sum(c["warp_rows_t"] for c in (counts, counts2, counts3, counts4))
    print(
        f"saved rig state: baseline + {len(paths)} corrections, {size_mb:.1f} MB, saved in "
        f"{save_s:.2f} s, read back in {load_s:.2f} s (the baseline onto the card); reading "
        f"path through the loaded objects {ms_loaded:.1f} ms (their first call, with its "
        f"set-up, {first_ms:.1f} ms), through the originals "
        f"{ms_originals:.1f} ms, bitwise equal, launches {counts} each on {card}; "
        f"DeformationCorrection in transformations= {ms_chain:.2f} ms, == "
        f"ImageRegistration(base)(probe), launches {counts3} each; phase "
        f"{time.perf_counter() - tic:.2f} s"
    )
    return {"launches": launches}


def rof_energy(u: torch.Tensor, f: torch.Tensor, tv_weight: float) -> float:
    """``1/2 |u - f|^2 + tv_weight * TV_iso(u)`` in float64 on the card."""
    u64, f64 = u.double(), f.double()
    squares = None
    for ax in range(u.dim()):
        g = torch.diff(u64, dim=ax, append=u64.narrow(ax, u64.shape[ax] - 1, 1)) ** 2
        squares = g if squares is None else squares + g
    return float(0.5 * ((u64 - f64) ** 2).sum() + tv_weight * squares.sqrt().sum())


def median_ms(fn, reps: int = 3):
    """(last output, median ms, each ms) of ``reps`` calls, each closed by a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    each = []
    for _ in range(reps):
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        each.append((time.perf_counter() - tic) * 1e3)
    return out, float(np.median(each)), each


def frozen_loop(read_every: int):
    """The loop the port's ``iterate_while`` is timed against: the stopping
    rule never leaves the device.  Every iteration computes the next state and
    keeps the old one where the test has failed (``torch.where``), so the
    result is bitwise what leaving at that iteration gives; the flag is read
    on the host only every ``read_every`` iterations, to leave the loop."""

    def loop(cond, body, state, maxiter, start=0):
        device = state[0].device
        active = torch.ones((), dtype=torch.bool, device=device)
        taken = torch.full((), start, dtype=torch.int64, device=device)
        for it in range(start, maxiter):
            active = active & cond(state, it)
            new_state = body(state, it)
            state = tuple(torch.where(active, new, old) for new, old in zip(new_state, state))
            taken = taken + active
            if (it - start) % read_every == read_every - 1 and not active.item():
                break
        return state, int(taken)

    return loop


@contextlib.contextmanager
def stopping_loops(loop=None):
    """Record the iteration count of every loop with a stopping rule that
    runs inside (the outermost loop's is the last), and run them through
    ``loop`` in place of the port's ``iterate_while`` where one is given."""
    import importlib

    modules = [
        importlib.import_module(f"darsia_tpu_torch.{name}")
        for name in ("ops.solvers", "ops.tv", "restoration.split_bregman_tvd")
    ]
    original = modules[0].iterate_while
    counts = []

    def recorded(*args, **kwargs):
        state, taken = (loop or original)(*args, **kwargs)
        counts.append(taken)
        return state, taken

    for module in modules:
        module.iterate_while = recorded
    try:
        yield counts
    finally:
        for module in modules:
            module.iterate_while = original


def bench_tvd_image(n: int) -> np.ndarray:
    """The image of the JAX package's TVD bench row (bench.py:727-729)."""
    rng = np.random.default_rng(0)
    blocks = np.kron(rng.random((n // 32, n // 32)), np.ones((32, 32)))
    return np.clip(blocks + 0.1 * rng.standard_normal((n, n)), 0, 1).astype(np.float32)


def phase_solvers(dt, device, card: str, profile) -> dict:
    """Phase A: the bench's TVD row and the three solvers."""
    tic = time.perf_counter()
    n, iters, reps = 512, 30, 10
    img = torch.from_numpy(bench_tvd_image(n)).to(device)

    def run():
        return dt.split_bregman_tvd(
            img, mu=10.0, ell=1.0, max_num_iter=iters, isotropic=False, eps=None
        )

    out = run()  # warm-up
    torch.cuda.synchronize()
    if tuple(out.shape) != (n, n) or not bool(torch.isfinite(out).all()):
        raise AssertionError("TVD at 512: bad output")
    energy = (rof_energy(img, img, 10.0), rof_energy(out, img, 10.0))
    if not energy[1] < energy[0]:
        raise AssertionError(f"TVD at 512: ROF energy {energy[0]} -> {energy[1]}")
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / reps
    iters_per_s = iters / seconds
    print(
        f"TVD bench row (split_bregman_tvd, {n}x{n}, mu=10, ell=1, {iters} iterations, "
        f"anisotropic, eps=None, Jacobi(20); {reps} calls, one synchronize): "
        f"tvd_512_iters_per_s {iters_per_s}, {seconds * 1e3} ms per call on {card}; ROF "
        f"energy {energy[0]:.1f} -> {energy[1]:.1f}"
    )
    if profile is not None:
        profile_frame(run, seconds * 1e3, profile, "tvd_512", frames=2)

    # One H1 problem, three solvers (tests/test_torch_solvers.py's tolerance).
    g = torch.Generator(device=device).manual_seed(5)
    x_true = torch.rand((n, n), generator=g, device=device)
    mass, diff = 1.0, 0.5
    rhs = mass * x_true - dt.fv_laplace(x_true, dim=2, diffusion_coeff=diff)
    solvers = {
        "Jacobi(600)": dt.Jacobi(maxiter=600, mass_coeff=mass, diffusion_coeff=diff),
        "CG(400, 1e-12)": dt.CG(maxiter=400, tol=1e-12, mass_coeff=mass, diffusion_coeff=diff),
        "MG(60, 1e-12)": dt.MG(maxiter=60, tol=1e-12, mass_coeff=mass, diffusion_coeff=diff),
    }
    zero = torch.zeros_like(x_true)
    sols, times = {}, {}
    for name, solver in solvers.items():
        sols[name], times[name], _ = median_ms(lambda: solver(zero, rhs))
    errs = {name: float((sol - x_true).abs().max()) for name, sol in sols.items()}
    names = list(sols)
    apart = max(
        float((sols[a] - sols[b]).abs().max()) for a in names for b in names if a < b
    )
    if not (max(errs.values()) <= 5e-4 and apart <= 5e-4):
        raise AssertionError(f"solver family at 512: errors {errs}, apart {apart}")
    print(
        f"solver family on one {n}x{n} H1 problem: max |x - x_true| {errs}, apart "
        f"{apart}; ms per call {times}"
    )

    # Multigrid at 4K with heterogeneous fields.
    shape = (OH, W)
    x = torch.rand(shape, generator=g, device=device)
    mass_f = 0.5 + torch.rand(shape, generator=g, device=device)
    diff_f = 0.2 + torch.rand(shape, generator=g, device=device)
    rhs = mass_f * x
    mg = dt.MG(depth=4, smoother_iterations=3, maxiter=5, mass_coeff=mass_f, diffusion_coeff=diff_f)
    torch.cuda.reset_peak_memory_stats(device)
    solved, mg_ms, _ = median_ms(lambda: mg(x, rhs))
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    before = float(torch.linalg.vector_norm(rhs - mg.operator(x)))
    after = float(torch.linalg.vector_norm(rhs - mg.operator(solved)))
    if not after <= 0.1 * before:
        raise AssertionError(f"MG at 4K: residual {before} -> {after}")
    print(
        f"MG (5 V-cycles, depth 4, 3 sweeps) at {shape} with heterogeneous mass and "
        f"diffusion: {mg_ms} ms per call, residual {before:.3f} -> {after:.5f}, peak "
        f"{peak_gib:.2f} GiB; phase {time.perf_counter() - tic:.2f} s"
    )
    return {"tvd_512_iters_per_s": iters_per_s, "mg_4k_ms": mg_ms}


TVD_WEIGHT = 5.0  # Bregman methods: mu = 1 / weight = 0.2
TVD_ITERS = 30
TVD_EPS = 1e-4
CHAMBOLLE = {"weight": 0.1, "eps": 2e-4, "max_num_iter": 200}


def restoration_chain(dt):
    """Resize(0.5x) -> TVD -> Resize(original), as the FluidFlower presets
    build their ``restoration=`` (presets/fluidflower/benchmarkco2model.py:52-58
    of the JAX package)."""
    return dt.CombinedModel(
        [
            dt.Resize(fx=0.5, fy=0.5),
            dt.TVD(
                method="isotropic bregman",
                weight=TVD_WEIGHT,
                max_num_iter=TVD_ITERS,
                eps=TVD_EPS,
            ),
            dt.Resize(shape=(OH, W)),
        ]
    )


def phase_restoration_lane(dt, w2p, lanes, device, card: str, profile) -> dict:
    """Phase B: the two-warp lane with the TVD restoration chain, then TVD
    alone at full resolution with each method."""
    tic = time.perf_counter()
    analysis = dt.ConcentrationAnalysis(
        base=lanes["analysis"].base,
        signal_reduction=dt.MonochromaticReduction(color="gray"),
        restoration=restoration_chain(dt),
        model=dt.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )
    pipeline = dt.FusedAnalysisPipeline(
        transformations=[lanes["trans"], lanes["curv"]],
        registration=lanes["registration"],
        analysis=analysis,
    )
    probe = torch.from_numpy(lanes["probe_u8"]).to(device)
    pipeline(probe)  # warm-up
    torch.cuda.synchronize()
    frames = 5
    torch.cuda.reset_peak_memory_stats(device)
    out, ms, counts, windows = run_frames(w2p, pipeline, probe, frames, "restoration lane")
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    diff, plain_ms = plain_frames(w2p, pipeline, probe, out.img, frames, "restoration lane")
    # K1 at this pipeline's own calls: bitwise equal to its plain version.
    calls = frame_k1_calls(w2p, lambda: pipeline(probe))
    if len(calls) != 4:
        raise AssertionError(f"restoration lane: {len(calls)} K1 calls per frame, want 4")
    for k, (data, cols, D) in enumerate(calls):
        if not torch.equal(w2p.warp_rows_t(data, cols, D), w2p.warp_rows_t_reference(data, cols, D)):
            raise AssertionError(f"restoration lane: K1 call {k} != plain")
    # The staged objects (the restoration chain on the staged concentration).
    staged = analysis(lanes["registration"](staged_probe(dt, lanes, device))).img
    staged_err = float((staged - out.img).abs().mean())
    if not staged_err <= 1e-3:
        raise AssertionError(f"restoration lane vs staged objects: mean |dconc| = {staged_err}")
    # Against phase 5's lane (10 Jacobi sweeps as its restoration), in turns.
    turns = []
    for lane in (lanes["two_warp"], pipeline, pipeline, lanes["two_warp"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            lane(probe)
        torch.cuda.synchronize()
        turns.append((time.perf_counter() - t0) / frames * 1e3)
    print(
        f"two-warp lane with the TVD restoration chain (Resize 0.5x -> isotropic Bregman "
        f"weight {TVD_WEIGHT}, {TVD_ITERS} iterations, eps {TVD_EPS}, Jacobi(20) -> Resize): "
        f"{ms} ms/frame ({WINDOWS} windows of {frames} frames, each {windows}), launches "
        f"{counts} on {card}; K1 bitwise at its 4 calls; with plain K1 {plain_ms} ms/frame, "
        f"mean|dconc| vs plain K1 {diff}, vs staged objects {staged_err}; in turns with "
        f"phase 5's lane (ms/frame, 5 frames each): phase 5 {turns[0]}, restoration "
        f"{turns[1]}, restoration {turns[2]}, phase 5 {turns[3]}; peak {peak_gib:.2f} GiB"
    )
    if profile is not None:
        profile_frame(lambda: pipeline(probe), ms, profile, "restoration_lane", frames=2)

    # TVD alone on the lane's full-resolution concentration map (the map the
    # chain restores, before it).
    conc = lanes["two_warp"](probe).img.contiguous()
    crop = conc[700:956, 1400:1784].contiguous()
    methods = {
        "chambolle": ({"method": "chambolle", **CHAMBOLLE}, None),
        "bregman Jacobi(20)": ({}, lambda: dt.Jacobi(maxiter=20)),
        "bregman CG(20)": ({}, lambda: dt.CG(maxiter=20, tol=1e-6)),
        "bregman MG(1, depth 3)": ({}, lambda: dt.MG(maxiter=1, depth=3, smoother_iterations=3)),
    }
    report = {}
    for name, (options, make_solver) in methods.items():
        if make_solver is None:
            call = lambda x, eps=options["eps"]: dt.TVD(**{**options, "eps": eps})(x)  # noqa: E731
            tv_weight, fixed_eps, tol = options["weight"], options["eps"], 1e-4
        else:
            def call(x, eps=TVD_EPS, make_solver=make_solver):
                return dt.TVD(
                    method="isotropic bregman", weight=TVD_WEIGHT, max_num_iter=TVD_ITERS,
                    eps=eps, solver=make_solver(),
                )(x)

            tv_weight, fixed_eps, tol = 1.0 / TVD_WEIGHT, None, 2e-5
        torch.cuda.reset_peak_memory_stats(device)
        with stopping_loops() as loop_counts:
            restored, call_ms, each = median_ms(lambda: call(conc))
        taken = loop_counts[-1]  # of the last timed call
        method_peak = torch.cuda.max_memory_allocated(device) / 2**30
        if tuple(restored.shape) != tuple(conc.shape) or not bool(torch.isfinite(restored).all()):
            raise AssertionError(f"TVD {name} at 4K: bad output")
        energy = (rof_energy(conc, conc, tv_weight), rof_energy(restored, conc, tv_weight))
        if not energy[1] < energy[0]:
            raise AssertionError(f"TVD {name} at 4K: ROF energy {energy[0]} -> {energy[1]}")
        # The card against the CPU tensor, at a crop: Chambolle with its eps
        # (it may stop an iteration apart), Bregman with a fixed count.
        on_card = call(crop, fixed_eps)
        on_cpu = call(crop.cpu(), fixed_eps)
        apart = float((on_card.cpu() - on_cpu).abs().max())
        if not apart <= tol:
            raise AssertionError(f"TVD {name}: card vs CPU at the crop, max |diff| {apart} > {tol}")
        report[name] = {"ms": call_ms, "iterations": taken}
        print(
            f"TVD {name} at {tuple(conc.shape)}: {call_ms} ms per call (each {each}), "
            f"{taken} iterations, ROF energy {energy[0]:.2f} -> {energy[1]:.2f}, peak "
            f"{method_peak:.2f} GiB; card vs CPU at a 256x384 crop: max |diff| {apart} "
            f"(tolerance {tol})"
        )
        if profile is not None and name == "bregman Jacobi(20)":
            profile_frame(lambda: call(conc), call_ms, profile, "tvd_4k", frames=1)

    # The stop flag: the port's loop (one host read per iteration) against a
    # loop that freezes its state on the device and reads every eighth, in
    # turns, on a device-bound call, a launch-bound one and one whose inner
    # solver stops by a rule of its own.
    small = torch.from_numpy(bench_tvd_image(512)).to(device)
    cases = {
        "Chambolle at 4K": lambda: dt.TVD(method="chambolle", **CHAMBOLLE)(conc),
        "Chambolle at 512x512": lambda: dt.TVD(method="chambolle", **CHAMBOLLE)(small),
        "isotropic Bregman with CG(20) at 4K": lambda: dt.TVD(
            method="isotropic bregman", weight=TVD_WEIGHT, max_num_iter=TVD_ITERS,
            eps=TVD_EPS, solver=dt.CG(maxiter=20, tol=1e-6),
        )(conc),
    }
    cadence = {}
    for name, run in cases.items():
        readings = {"every iteration": [], "frozen, every eighth": []}
        results = {}
        for key in ("every iteration", "frozen, every eighth") * 2:
            loop = None if key == "every iteration" else frozen_loop(8)
            torch.cuda.reset_peak_memory_stats(device)
            with stopping_loops(loop) as loop_counts:
                restored, call_ms, _ = median_ms(run, reps=2)
            readings[key].append(call_ms)
            results[key] = (restored, loop_counts[-1], torch.cuda.max_memory_allocated(device) / 2**30)
        (plain_out, plain_taken, plain_peak), (frozen_out, frozen_taken, frozen_peak) = results.values()
        if not torch.equal(plain_out, frozen_out) or plain_taken != frozen_taken:
            raise AssertionError(f"{name}: the result depends on how the stop flag is read")
        cadence[name] = readings
        print(
            f"{name}, stop flag read every iteration {readings['every iteration']} ms (peak "
            f"{plain_peak:.2f} GiB), state frozen on the device and flag read every eighth "
            f"{readings['frozen, every eighth']} ms (peak {frozen_peak:.2f} GiB), in turns, "
            f"median of 2 each; {plain_taken} iterations, results bitwise equal"
        )
    print(f"restoration phase {time.perf_counter() - tic:.2f} s")
    return {
        "launches": counts["warp_rows_t"],
        "ms_per_frame": ms,
        "conc": conc,
        "methods": report,
        "flag_ms": cadence,
    }


def total_variation(u: torch.Tensor) -> float:
    return float(sum(torch.diff(u, dim=ax).abs().sum(dtype=torch.float64) for ax in range(u.dim())))


def phase_volume(dt, device, card: str) -> dict:
    """Phase C: a CT-sized 3-D image through TVD, H1 and the N-d image core."""
    import tempfile

    tic = time.perf_counter()
    shape, block = (256, 512, 512), 32
    g = torch.Generator(device=device).manual_seed(0)
    coarse = torch.rand(tuple(n // block for n in shape), generator=g, device=device)
    for ax in range(3):
        coarse = coarse.repeat_interleave(block, dim=ax)
    data = (coarse + 0.1 * torch.randn(shape, generator=g, device=device)).clamp_(0, 1)
    del coarse
    dimensions = [n * 1e-4 for n in shape]  # 0.1 mm voxels
    volume = dt.ScalarImage(data, space_dim=3, dimensions=dimensions, name="ct")
    tv0 = total_variation(data)
    torch.cuda.reset_peak_memory_stats(device)
    runs = {
        "chambolle_tvd(weight 0.1, eps 2e-4, <= 50)": lambda: dt.chambolle_tvd(
            data, weight=0.1, eps=2e-4, max_num_iter=50
        ),
        "split_bregman_tvd(dim=3, mu 0.2, 10 iterations)": lambda: dt.split_bregman_tvd(
            data, mu=0.2, dim=3, max_num_iter=10
        ),
        "H1_regularization(dim=3, mu 1, Jacobi(30))": lambda: dt.H1_regularization(
            volume, mu=1.0, omega=1.0, dim=3
        ).img,
    }
    times = {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        tv = total_variation(out)
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()) or not tv < tv0:
            raise AssertionError(f"{name}: bad output (TV {tv0} -> {tv})")
        print(f"3-D {name} at {shape}: {times[name]} ms (one call), TV {tv0:.4g} -> {tv:.4g}")
        del out
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30

    # The N-d core: slices, reduction, integration, subregion, roi, eval.
    cs = volume.coordinatesystem
    for axis, matrix_axis in (("x", 1), ("y", 2), ("z", 0)):
        index = shape[matrix_axis] // 3
        voxel = np.zeros(3)
        voxel[matrix_axis] = index + 0.5
        cut = float(np.asarray(cs.coordinate(voxel))["xyz".find(axis)])
        by_coordinate, by_index = volume.slice(cut, axis), volume.slice(index, matrix_axis)
        if not (
            torch.equal(by_coordinate.img, by_index.img)
            and torch.equal(by_index.img, data.select(matrix_axis, index))
            and by_coordinate.dimensions == by_index.dimensions
            and by_coordinate.space_dim == 2
        ):
            raise AssertionError(f"slice along {axis}: coordinate and index slices differ")
    averaged, reduce_ms, _ = median_ms(lambda: dt.reduce_axis(volume, "z", mode="average"))
    mean_err = float((averaged.img - data.mean(dim=0)).abs().max())
    if averaged.shape != shape[1:] or not mean_err <= 1e-5:
        raise AssertionError(f"reduce_axis average: max |diff| {mean_err}")
    integral, integrate_ms, _ = median_ms(lambda: volume.geometry().integrate(volume))
    host = data.cpu().numpy()
    exact = float(host.sum(dtype=np.float64) * np.prod(volume.voxel_size))
    if not abs(integral - exact) <= 1e-5 * abs(exact):
        raise AssertionError(f"Geometry.integrate: {integral} vs {exact}")
    # A host array goes to the card and is summed there: the same number.
    if volume.geometry().integrate(host) != integral:
        raise AssertionError("Geometry.integrate: a numpy array and the card's tensor differ")
    box = (slice(10, 138), slice(100, 356), slice(7, 263))
    sub = volume.subregion(box)
    if not (torch.equal(sub.img, data[box]) and np.allclose(sub.dimensions, [0.0128, 0.0256, 0.0256])):
        raise AssertionError("subregion of the volume: wrong box or dimensions")
    plane = volume.slice(100, 0)
    roi = dt.ROI([[0.01, 0.01], [0.04, 0.012], [0.035, 0.04]])
    picked = plane.roi(roi)
    if picked.img.numel() == 0 or picked.img.shape[0] >= plane.img.shape[0]:
        raise AssertionError(f"roi of a slice: shape {tuple(picked.img.shape)}")
    rng = np.random.default_rng(1)
    voxels = rng.integers(0, 256, (1000, 3))
    points = dt.make_coordinate(np.asarray(cs.coordinate(voxels + 0.5)))
    values = volume.eval(points)
    if not np.array_equal(values, host[voxels[:, 0], voxels[:, 1], voxels[:, 2]]):
        raise AssertionError("eval at voxel centres: not the voxels' values")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        volume.save(Path(tmp) / "volume")
        save_s = time.perf_counter() - t0
        size_mb = (Path(tmp) / "volume.npz").stat().st_size / 1e6
        t0 = time.perf_counter()
        back = dt.imread(Path(tmp) / "volume.npz")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    if not (
        type(back) is dt.ScalarImage
        and back.img.device.type == "cuda"
        and torch.equal(back.img, data)
        and back.space_dim == 3
        and back.indexing == "ijk"
        and back.dimensions == volume.dimensions
        and np.array_equal(back.origin, volume.origin)
        and back.name == "ct"
    ):
        raise AssertionError("the volume read back differs from the one saved")
    print(
        f"3-D image core at {shape}: slices by coordinate == by index along x, y, z; "
        f"reduce_axis average {reduce_ms} ms (max |diff| vs mean {mean_err}); "
        f"Geometry.integrate {integrate_ms} ms ({integral} vs float64 numpy {exact}); "
        f"subregion, roi {tuple(picked.img.shape)}, eval at 1000 points; saved {size_mb:.1f} MB "
        f"in {save_s:.2f} s, read back in {read_s:.2f} s; peak {peak_gib:.2f} GiB on {card}; "
        f"phase {time.perf_counter() - tic:.2f} s"
    )
    return {"ms": times, "peak_gib": peak_gib}


def phase_filters(dt, conc: torch.Tensor, device, card: str) -> dict:
    """Phase D: median, volume averaging and the resizes at 4K, each against
    the same call on the CPU tensor."""
    tic = time.perf_counter()
    image = dt.ScalarImage(conc, **META)
    on_cpu = dt.ScalarImage(conc.cpu(), **META)
    g = torch.Generator(device=device).manual_seed(3)
    mask = (torch.rand(conc.shape, generator=g, device=device) > 0.3).to(torch.float32)
    voxel = image.voxel_size[0]
    filters = {}
    for radius in (1, 2):
        filters[f"median_filter(radius {radius})"] = (
            lambda img, radius=radius: dt.median_filter(img.img, radius), 0.0
        )
    for size in (5, 8):
        def average(img, size=size):
            rev = dt.REV((size - 0.5) * voxel, img)
            if rev.size != size:
                raise AssertionError(f"REV of {size} voxels has size {rev.size}")
            return dt.VolumeAveraging(rev, mask.to(img.device))(img).img

        filters[f"VolumeAveraging(REV {size} voxels)"] = (average, 1e-6)
    for levels in (1, -1):
        filters[f"uniform_refinement({levels:+d})"] = (
            lambda img, levels=levels: dt.uniform_refinement(img, levels).img, 1e-5
        )
    filters["equalize_voxel_size"] = (lambda img: dt.equalize_voxel_size(img).img, 1e-5)
    times = {}
    for name, (fn, tol) in filters.items():
        out, times[name], _ = median_ms(lambda: fn(image))
        want = fn(on_cpu)
        apart = float((out.cpu() - want).abs().max())
        if tuple(out.shape) != tuple(want.shape) or not apart <= tol:
            raise AssertionError(f"{name}: card vs CPU max |diff| {apart} > {tol}")
        print(
            f"{name} at {tuple(conc.shape)} -> {tuple(out.shape)}: {times[name]} ms per "
            f"call; card vs CPU max |diff| {apart} (tolerance {tol})"
        )
    print(f"filters at 4K on {card}: phase {time.perf_counter() - tic:.2f} s")
    return times


# Phase E: the heterogeneous colour-to-mass analysis behind the rig's
# reading path.  Twelve sand layers (a FluidFlower rig's), forty for a finely
# segmented rig; the crop of the card-vs-CPU gate; the gas ROI (x, y in m).
E_LAYERS, E_LAYERS_FINE = 12, 40
E_CROP = (slice(600, 1112), slice(1000, 2024))
E_GAS_ROI = np.array([[0.9, 1.25], [2.2, 0.55]])
E_FLASH = (0.05, 0.5, 0.5, 1.0)  # tests/unit/test_color_to_mass.py:43-45
E_POROSITY, E_DEPTH = 0.44, 0.019


def layer_labels(layers: int, device, seed: int = 8) -> torch.Tensor:
    """``layers`` seeded wavy horizontal layers over the corrected frame:
    label k between boundaries k and k + 1 (amplitudes below a quarter of a
    layer's height, so no two boundaries cross)."""
    rng = np.random.default_rng(seed)
    rows = torch.arange(OH, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    labels = torch.zeros((OH, W), dtype=torch.int64, device=device)
    height = OH / layers
    for k in range(1, layers):
        amp = rng.uniform(0.05, 0.25) * height
        wave = rng.uniform(600.0, 2400.0)
        boundary = k * height + amp * torch.sin(2 * np.pi * cols / wave + rng.uniform(0, 2 * np.pi))
        labels += (rows >= boundary).to(torch.int64)
    return labels


def layer_models(dt, layers: int, seed: int = 9) -> tuple:
    """Per label a seeded 5-colour RELATIVE colour path with its
    interpolation at equidistant values, and a 3-support signal function.
    Each path moves the same way in every channel (no fold back onto
    itself), so a colour on it is far from its other segments."""
    rng = np.random.default_rng(seed)
    interps, functions = {}, {}
    for label in range(layers):
        direction = rng.choice([-1.0, 1.0], 3) * rng.uniform(0.3, 1.0, 3)
        steps = rng.uniform(0.02, 0.06, (4, 1)) * direction
        relative = np.cumsum(np.vstack([np.zeros(3), steps]), axis=0)
        path = dt.ColorPath(
            relative_colors=list(relative), base_color=rng.uniform(0.2, 0.6, 3), name=f"layer {label}"
        )
        interps[label] = dt.ColorPathInterpolation(
            path, dt.ColorMode.RELATIVE, values=path.equidistant_distances
        )
        functions[label] = dt.PWTransformation(
            supports=[0.0, rng.uniform(0.3, 0.7), 1.0], values=[0.0, rng.uniform(0.2, 0.8), 1.0]
        )
    return interps, functions


def colour_to_mass_chain(dt, baseline, labels, layers: int, adapter):
    """(chain, geometry) on the baseline's device."""
    interps, functions = layer_models(dt, layers)
    shape = tuple(baseline.img.shape[:2])
    geometry = dt.ExtrudedPorousGeometry(
        np.full(shape, E_POROSITY), np.full(shape, E_DEPTH), **baseline.shape_metadata()
    )
    chain = dt.HeterogeneousColorToMassAnalysis(
        baseline=baseline,
        labels=dt.Image(labels, scalar=True, **{k: v for k, v in baseline.metadata().items() if k != "scalar"}),
        color_mode=dt.ColorMode.RELATIVE,
        color_path_interpretation=interps,
        signal_functions=functions,
        flash=dt.SimpleFlash(*E_FLASH),
        co2_mass_analysis=dt.CO2MassAnalysis(baseline, 1.01, 23.0),
        geometry=geometry,
        expert_knowledge_adapter=adapter,
    )
    return chain, geometry


def chain_outputs(chain, image) -> dict:
    """Every stage's output of ``chain`` on ``image``, by name."""
    colour = chain.call_color_interpretation(image)
    ph = chain.call_pH_analysis(colour)
    result = chain.call_flash_and_mass_analysis(ph)
    out = {"colour": colour.img, "pH": ph.img}
    for key in ("saturation_g", "concentration_aq", "mass", "mass_g", "mass_aq"):
        out[key] = getattr(result, key).img
    return out


def fit_ties(chain, image) -> torch.Tensor:
    """Pixels where ``fit`` of the pixel's own label has two segments within
    1e-6 of equally close that give different parameters (more than 1e-6
    apart): there a last-bit difference may pick either."""
    labels = chain.labels.img
    diff = image.img - chain.color_analysis.base.img
    ties = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for label, interp in chain.color_path_interpretation.items():
        params, l1 = interp.color_path.fit_terms(diff, interp.color_mode, "equidistant")
        near = l1 <= l1.min(dim=-1, keepdim=True).values + 1e-6
        spread = torch.where(near, params, -torch.inf).amax(-1) - torch.where(near, params, torch.inf).amin(-1)
        ties |= (labels == label) & (spread > 1e-6)
    return ties


def plume_reckoning(chain, labels: np.ndarray, params: np.ndarray, plume: np.ndarray, gas: np.ndarray) -> float:
    """The integrated mass of the painted plume, in float64 numpy from the
    painted parameters: the same chain reckoned independently."""
    p = np.where(plume, params, 0.0)
    x = np.clip(p, 0.0, 1.0)  # the signal functions' common domain
    ph = np.zeros_like(x)
    for label, function in chain.signal_model.model[1].models.items():
        inside = labels == label
        ph[inside] = np.interp(x[inside], function.supports, function.values)
    lo_aq, hi_aq, lo_g, hi_g = E_FLASH
    c_aq = np.clip((ph - lo_aq) / (hi_aq - lo_aq), 0.0, 1.0)
    s_g = np.where(gas, np.clip((ph - lo_g) / (hi_g - lo_g), 0.0, 1.0), 0.0)
    mass_analysis = chain.co2_mass_analysis
    mass = mass_analysis.density_gaseous_co2 * s_g + mass_analysis.solubility_co2 * c_aq * np.clip(1 - s_g, 0, None)
    voxel = np.prod(chain.geometry.voxel_size)
    return float((mass * voxel * E_POROSITY * E_DEPTH).sum())


def phase_colour_to_mass(dt, w2p, rig, device, card: str, profile) -> dict:
    """Phase E: the rig's reading path, then the heterogeneous colour-to-mass
    analysis, then the integrated mass."""
    import tempfile
    from types import SimpleNamespace

    tic = time.perf_counter()
    transformations = rig["shape"] + rig["colour"]

    def read(img):
        return dt.OpticalImage(img, transformations=transformations, **META)

    launches = 0
    baseline, _, _, counts = median_call_ms(w2p, lambda: read(rig["baseline"].img), 1, 4, "E: baseline read")
    launches += counts["warp_rows_t"]
    labels = layer_labels(E_LAYERS, device)
    adapter = dt.ExpertKnowledgeAdapter(saturation_g_rois={"seal": SimpleNamespace(roi=E_GAS_ROI)})
    t0 = time.perf_counter()
    chain, geometry = colour_to_mass_chain(dt, baseline, labels, E_LAYERS, adapter)
    setup_s = time.perf_counter() - t0

    # The path: reading the photograph (4 K1 launches), the chain (none).
    reset_counts(w2p)
    image = read(rig["probe"])
    torch.cuda.synchronize()
    after_read = read_counts(w2p)
    result = chain(image)
    mass = geometry.integrate(result.mass)
    counts = read_counts(w2p)
    check_counts(after_read, {"warp_rows_t": 4}, "E: reading call")
    check_counts(counts, {"warp_rows_t": 4}, "E: reading call + chain")
    launches += counts["warp_rows_t"]
    outputs = chain_outputs(chain, image)
    for key, value in outputs.items():
        if tuple(value.shape) != (OH, W) or not bool(torch.isfinite(value).all()):
            raise AssertionError(f"E: {key} of the photograph: shape {tuple(value.shape)} or not finite")
    if not torch.equal(outputs["mass"], result.mass.img):
        raise AssertionError("E: the chain's stages differ from its call")
    gas = adapter.mask_for(result.saturation_g, "saturation_g")
    if bool((result.saturation_g.img[~gas] != 0).any()):
        raise AssertionError("E: gas saturation outside the gas ROI")

    # A plume painted on the corrected baseline along each label's path.
    g = torch.Generator(device=device).manual_seed(10)
    rows = torch.linspace(-1, 1, OH, device=device)[:, None]
    cols = torch.linspace(-1, 1, W, device=device)[None, :]
    plume = ((rows - 0.1) / 0.55) ** 2 + ((cols + 0.1) / 0.6) ** 2 < 1.0
    params = (0.05 + 0.9 * torch.rand((OH, W), generator=g, device=device, dtype=torch.float64))
    painted = baseline.img.clone()
    for label, interp in chain.color_path_interpretation.items():
        colour = interp.color_path.interpret(params, dt.ColorMode.RELATIVE, mode="equidistant")
        where = (plume & (labels == label))[..., None]
        painted = torch.where(where, baseline.img + colour.to(torch.float32), painted)
    plume_image = dt.OpticalImage(painted, **META)
    plume_out = chain_outputs(chain, plume_image)
    recovered = float((plume_out["colour"] - params.to(torch.float32))[plume].abs().max())
    outside = float(plume_out["colour"][~plume].abs().max())
    if not (recovered <= 1e-4 and outside == 0.0):
        raise AssertionError(f"E: plume parameters recovered within {recovered}, outside {outside}")
    for key, value in plume_out.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"E: {key} of the plume not finite")
    if bool((plume_out["saturation_g"][~gas] != 0).any()) or not bool((plume_out["saturation_g"][gas] > 0).any()):
        raise AssertionError("E: the plume's gas saturation is not confined to the gas ROI")
    plume_mass = geometry.integrate(plume_out["mass"])
    want = plume_reckoning(
        chain, labels.cpu().numpy(), params.cpu().numpy(), plume.cpu().numpy(), gas.cpu().numpy()
    )
    plume_err = abs(plume_mass - want) / abs(want)
    if not plume_err <= 1e-4:
        raise AssertionError(f"E: plume mass {plume_mass} vs float64 reckoning {want}: {plume_err}")

    # The card against the CPU tensor on a crop of the photograph read.
    crop_base = baseline.subregion(E_CROP)
    crop_image = image.subregion(E_CROP)
    crops = {}
    for name, where in (("card", device), ("cpu", "cpu")):
        base_w = dt.OpticalImage(crop_base.img.to(where).contiguous(), **crop_base.metadata())
        image_w = dt.OpticalImage(crop_image.img.to(where).contiguous(), **crop_image.metadata())
        crop_chain, _ = colour_to_mass_chain(
            dt, base_w, labels[E_CROP].to(where).contiguous(), E_LAYERS, adapter
        )
        crops[name] = (crop_chain, image_w, chain_outputs(crop_chain, image_w))
    ties = fit_ties(*crops["card"][:2])
    n_ties = int(ties.sum())
    if not n_ties < 1e-3 * ties.numel():
        raise AssertionError(f"E: {n_ties} tie pixels in the crop")
    keep = ~ties.cpu()
    apart = {}
    for key, on_card in crops["card"][2].items():
        ref = crops["cpu"][2][key]
        scale = float(ref.abs().max()) if key.startswith("mass") else 1.0
        apart[key] = float((on_card.cpu() - ref)[keep].abs().max()) / max(scale, 1e-30)
        if not apart[key] <= 1e-5:
            raise AssertionError(f"E: crop {key}, card vs CPU {apart[key]} > 1e-5")

    # Times: the chain at 12 and 40 labels, reading plus chain.
    torch.cuda.reset_peak_memory_stats(device)
    _, ms12, each12, _ = median_call_ms(w2p, lambda: chain(image), 5, 0, "E: chain, 12 labels")
    peak12 = torch.cuda.max_memory_allocated(device) / 2**30
    busy12 = device_busy_ms(lambda: chain(image))
    labels40 = layer_labels(E_LAYERS_FINE, device)
    chain40, _ = colour_to_mass_chain(dt, baseline, labels40, E_LAYERS_FINE, adapter)
    chain40(image)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    _, ms40, each40, _ = median_call_ms(w2p, lambda: chain40(image), 5, 0, "E: chain, 40 labels")
    peak40 = torch.cuda.max_memory_allocated(device) / 2**30
    _, ms_read, each_read, counts = median_call_ms(
        w2p, lambda: chain(read(rig["probe"])), 5, 4, "E: reading + chain"
    )
    launches += counts["warp_rows_t"]

    # The calibration folder written and read back.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        chain.save(Path(tmp) / "c2m")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = dt.HeterogeneousColorToMassAnalysis.from_folder(
            Path(tmp) / "c2m", baseline, chain.labels, chain.co2_mass_analysis, geometry,
            expert_knowledge_adapter=adapter,
        )
        load_s = time.perf_counter() - t0
    again = loaded(image)
    if not torch.equal(again.mass.img, result.mass.img) or geometry.integrate(again.mass) != mass:
        raise AssertionError("E: the chain read back from its folder gives another mass")
    print(
        f"E. colour-to-mass behind the rig's reading path ({OH}x{W}, {E_LAYERS} layers, 5-colour "
        f"relative paths, 3-support signal functions, SimpleFlash{E_FLASH}, CO2 mass at 1.01 bar, "
        f"23 C, gas ROI): reading call {after_read} + chain 0 launches; mass {mass:.6g} kg; plume "
        f"parameters recovered within {recovered:.3g} (bound 1e-4), its mass {plume_mass:.9g} vs "
        f"float64 reckoning {want:.9g} (rel {plume_err:.3g}, bound 1e-4); card vs CPU at a "
        f"512x1024 crop: max rel {max(apart.values()):.3g} ({apart}), {n_ties} tie pixels of "
        f"{ties.numel()}; chain set-up {setup_s:.2f} s"
    )
    print(
        f"E. on {card}: chain {ms12} ms per photograph at {E_LAYERS} labels (median of 5: {each12}; "
        f"device busy {busy12:.3f} ms, idle {1 - busy12 / ms12:.3f}, peak {peak12:.2f} GiB), "
        f"{ms40} ms at {E_LAYERS_FINE} labels ({each40}; peak {peak40:.2f} GiB); reading + chain "
        f"{ms_read} ms ({each_read}); save {save_s:.3f} s, from_folder {load_s:.3f} s; phase "
        f"{time.perf_counter() - tic:.2f} s"
    )
    if profile is not None:
        profile_frame(lambda: chain(image), ms12, profile, "colour_to_mass_12")
        profile_frame(lambda: chain40(image), ms40, profile, "colour_to_mass_40", frames=2)
    return {
        "launches": launches,
        "ms12": ms12,
        "ms40": ms40,
        "read_ms": ms_read,
        "busy12": busy12,
        "ties": n_ties,
    }


# Phase F: optimal transport.  The bench's W1 rows (bench.py:334-482): the
# weighted block problem at 512^2 with its options, the smooth two-Gaussian
# problem at 256^2, the split-square anchor refined to 160^2
# (examples/wasserstein_split_square.py), the splitting solvers on the block
# problem at 256^2, card against CPU tensor at 64^2, and two cubes at 64^3.
F_NEWTON = {"num_iter": 500, "L": 1e9, "tol_increment": 1e-4, "tol_distance": 1e-4, "aa_depth": 5}
F1_DISTANCE = 0.697882  # the JAX package's result for F1 (BENCH_r05.json): a result, not a time
F2_DISTANCE = 0.467866  # and for F2
F3_DISTANCE = 0.379543951823  # the split-square anchor (BASELINE.md)
# The bench's polish (2000 per chunk, target 1e-3) capped at 6000 steps, not
# its 30000: at ~2 ms of host time per step on the H100 the cap alone took
# 85 s, and the gap stays above the target either way.
F1_POLISH = {"polish_iters": 2000, "polish_target": 1e-3, "polish_max_iters": 2000}
# F2's polish stops once the certified gap is within the gate (2e-3): the
# bench's target (5e-4) ran its 20000-step cap, ~100 s of phase F.
F2_POLISH = {"polish_iters": 2000, "polish_target": 2e-3, "polish_max_iters": 20000}
F_BUDGET = 100  # fixed iterations of Bregman and G-prox (tolerances 0: never met)
# Sizes: F1, F2, F3's refinement of the 10x10 anchor, F4, F5, F6 (cubes).
F_SIZES = {"F1": 512, "F2": 256, "F3": 16, "F4": 256, "F5": 64, "F6": 64}


def ot_blocks(n: int) -> tuple:
    """(src, dst, weight) of bench.py:344-362: blocks of unit mass, weight
    2 + sin(4 pi x) cos(2 pi y) in [1, 3]."""
    src = np.zeros((n, n))
    dst = np.zeros((n, n))
    q = n // 10
    src[2 * q : 5 * q, 2 * q : 5 * q] = 1.0
    dst[1 * q : 3 * q, 1 * q : 2 * q] = 1.0
    dst[4 * q : 7 * q, 7 * q : 9 * q] = 1.0
    src = (src / (src.sum() / n**2)).astype(np.float32)
    dst = (dst / (dst.sum() / n**2)).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    weight = (2.0 + np.sin(4 * np.pi * xx) * np.cos(2 * np.pi * yy)).astype(np.float32)
    return src, dst, weight


def ot_gaussians(n: int) -> tuple:
    """(src, dst) of bench.py:444-453: two Gaussians of unit mean."""
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    src = np.exp(-((xx - 0.3) ** 2 + (yy - 0.35) ** 2) / 0.02)
    dst = np.exp(-((xx - 0.7) ** 2 + (yy - 0.6) ** 2) / 0.03)
    return (src / src.mean()).astype(np.float32), (dst / dst.mean()).astype(np.float32)


def pcg_counter(bk):
    """Count the iterations of every pressure solve's CG loop: wraps the
    ``iterate_while`` that ``beckmann_kernels`` calls and, where it has one,
    its kernels' loop ``mg_pcg_fused``; returns (counts, undo)."""
    counts, original = [], bk.iterate_while
    fused = getattr(bk, "mg_pcg_fused", None)

    def counting(cond, body, state, maxiter, start=0):
        out, it = original(cond, body, state, maxiter, start)
        counts.append(it)
        return out, it

    def counting_fused(*args, **kwargs):
        x, trips = fused(*args, **kwargs)
        counts.append(int(trips.max()) if trips.size else 0)
        return x, trips

    bk.iterate_while = counting
    if fused is not None:
        bk.mg_pcg_fused = counting_fused

    def undo():
        bk.iterate_while = original
        if fused is not None:
            bk.mg_pcg_fused = fused

    return counts, undo


class OpCounter:
    """Counts the tensor operations that launch work (views excluded) while
    it is entered: a TorchDispatchMode."""

    VIEWS = ("slice", "view", "expand", "permute", "select", "as_strided", "unsqueeze", "alias",
             "transpose", "aten.t.", "unbind", "split", "narrow", "detach", "real", "imag",
             "squeeze", "_local_scalar_dense", "lift_fresh")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func)
                if not any(v in name for v in OpCounter.VIEWS):
                    counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def ot_images(dt, src, dst, **meta):
    """Scalar images of ``src``/``dst`` (numpy: on the card)."""
    meta = {"width": 1, "height": 1, "scalar": True, **meta}
    return dt.Image(src, **meta), dt.Image(dst, **meta)


def phase_transport(dt, device, card: str, profile) -> dict:
    """Phase F: the Beckmann W1 solvers behind ``wasserstein_distance``."""
    from darsia_tpu_torch.measure import beckmann_kernels as bk

    tic = time.perf_counter()
    out = {}

    # F1: the bench's weighted block problem at 512^2, Newton with AA(5).
    n = F_SIZES["F1"]
    src, dst, weight = ot_blocks(n)
    src_img, dst_img = ot_images(dt, src, dst)
    weight_img = dt.ScalarImage(weight, width=1, height=1)
    if src_img.device.type != "cuda" or weight_img.device.type != "cuda":
        raise AssertionError("F1: images built from numpy are not on the card")
    solver = dt.BeckmannNewtonSolver(dt.generate_grid(dst_img), weight_img, F_NEWTON)
    mass_diff = dst_img.img - src_img.img
    counts, undo = pcg_counter(bk)
    launches, undo_launches = mg_launch_counter(bk)
    kernel_trips = mg_kernel_trips()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        distance, fluxes, pressure, info = solver.solve_beckmann_problem(mass_diff)
        torch.cuda.synchronize()
    finally:
        undo()
        undo_launches()
    f1_s = time.perf_counter() - t0
    kernel_trips = mg_kernel_trips() - kernel_trips
    if not kernel_trips > 0 or kernel_trips != sum(counts):
        raise AssertionError(f"F1: {kernel_trips} CG trips in the kernels, {sum(counts)} counted")
    check_mg_launches(launches, kernel_trips, "F1")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    if fluxes[0].device.type != "cuda" or pressure.device.type != "cuda":
        raise AssertionError("F1: the solve's fields are not on the card")
    iterations = info["number_iterations"] + 1
    gap_raw = solver.duality_gap(fluxes, pressure, mass_diff, polish_iters=0)
    t0 = time.perf_counter()
    gap = solver.duality_gap(fluxes, pressure, mass_diff, **F1_POLISH)
    polish_s = time.perf_counter() - t0
    rel = abs(distance - F1_DISTANCE) / F1_DISTANCE
    if not info["converged"] or not rel <= 1e-3:
        raise AssertionError(f"F1: converged {info['converged']}, distance {distance} vs {F1_DISTANCE}: {rel}")
    if not 0.0 <= gap <= gap_raw:
        raise AssertionError(f"F1: gap {gap} outside [0, gap_raw {gap_raw}]")
    pcg = np.array(counts[1:])  # the Darcy initialization's solve first
    out["F1"] = {
        "s": f1_s, "iterations": iterations, "distance": distance, "pcg_mean": float(pcg.mean()),
        "mg_launches": launches,
    }
    print(
        f"F1. W1 Newton AA(5), weighted blocks {n}x{n} on {card}: {f1_s:.3f} s per solve "
        f"(the first: no warm-up call), "
        f"{iterations} Newton iterations (the JAX package: 68), distance {distance:.6f} "
        f"(JAX package {F1_DISTANCE}, rel {rel:.2e}), converged; pressure solves {len(counts)}: "
        f"CG iterations per solve mean {pcg.mean():.1f}, median {np.median(pcg):.0f}, max "
        f"{pcg.max()} (cap {solver._mg_maxiter}), total {int(np.sum(counts))}; gap_raw "
        f"{gap_raw:.6f}, gap {gap:.6f} (polish {polish_s:.2f} s, {F1_POLISH}); peak {peak:.3f} GiB"
    )
    if profile is not None:
        from darsia_tpu_torch.utils import tracing

        mark = tracing.counter("beckmann.mg_launches")
        with OpCounter() as ops:
            solver.solve_beckmann_problem(mass_diff)
        per_solve = ops.n + tracing.counter("beckmann.mg_launches") - mark
        print(
            f"F1 ops: {per_solve} tensor ops and CG-trip kernel launches per solve (one more "
            f"solve, views excluded; {ops.n} tensor ops), "
            f"{per_solve / iterations:.0f} per Newton iteration, "
            f"{per_solve / max(int(np.sum(counts)), 1):.0f} per CG iteration"
        )
        profile_transport(dt, bk, solver, mass_diff, fluxes, profile)

    # F2: the smooth two-Gaussian problem at 256^2.
    n = F_SIZES["F2"]
    g_src, g_dst = ot_gaussians(n)
    s_img, d_img = ot_images(dt, g_src, g_dst)
    opts = {**F_NEWTON, "tol_increment": 1e-5, "tol_distance": 1e-5}
    smooth = dt.BeckmannNewtonSolver(dt.generate_grid(d_img), None, opts)
    md = d_img.img - s_img.img
    t0 = time.perf_counter()
    d2, fl2, p2, info2 = smooth.solve_beckmann_problem(md)
    torch.cuda.synchronize()
    f2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gap2 = smooth.duality_gap(fl2, p2, md, **F2_POLISH)
    polish2_s = time.perf_counter() - t0
    rel2 = abs(d2 - F2_DISTANCE) / F2_DISTANCE
    if not rel2 <= 1e-3 or not -1e-4 <= gap2 <= 2e-3:
        raise AssertionError(f"F2: distance {d2} vs {F2_DISTANCE} ({rel2}), gap {gap2}")
    out["F2"] = {"s": f2_s, "iterations": info2["number_iterations"] + 1, "distance": d2, "gap": gap2}
    print(
        f"F2. smooth Gaussians {n}x{n}: {f2_s:.3f} s, {info2['number_iterations'] + 1} "
        f"iterations, distance {d2:.6f} (JAX package {F2_DISTANCE}, rel {rel2:.2e}), certified "
        f"gap {gap2:.6f} (JAX package 0.001039; bound 2e-3; polish {polish2_s:.2f} s, {F2_POLISH})"
    )

    # F3: the split-square anchor refined 16x (np.repeat: the nearest resize).
    coarse = np.zeros((10, 10))
    coarse[2:5, 2:5] = 1
    coarse_dst = np.zeros((10, 10))
    coarse_dst[1:3, 1:2] = 1
    coarse_dst[4:7, 7:9] = 1
    k = F_SIZES["F3"]
    fine = [np.repeat(np.repeat(a / (a.sum() / 100), k, 0), k, 1) for a in (coarse, coarse_dst)]
    a_img, b_img = ot_images(dt, *fine, space_dim=2)
    # The example's options but the iteration cap (30, not 200): the solve
    # caps out at either, and the gate reads the distance.
    opts3 = {"num_iter": 30, "tol_residual": 1e-3, "tol_increment": 1e-3, "tol_distance": 1e-3,
             "L": 1e9, "return_info": True}
    t0 = time.perf_counter()
    d3, info3 = dt.wasserstein_distance(a_img, b_img, method="newton", options=opts3)
    torch.cuda.synchronize()
    f3_s = time.perf_counter() - t0
    if not abs(d3 - F3_DISTANCE) < 0.02:
        raise AssertionError(f"F3: distance {d3} vs the anchor {F3_DISTANCE}")
    out["F3"] = {"s": f3_s, "iterations": info3["number_iterations"] + 1, "distance": d3}
    print(
        f"F3. split square at {10 * k}x{10 * k}: distance {d3:.6f} (anchor {F3_DISTANCE}, |diff| "
        f"{abs(d3 - F3_DISTANCE):.4f} < 0.02), {info3['number_iterations'] + 1} iterations, "
        f"{f3_s:.3f} s (return_info included)"
    )

    # F4: Bregman and G-prox on F1's problem at 256^2, fixed budgets.
    n = F_SIZES["F4"]
    src, dst, weight = ot_blocks(n)
    src_img, dst_img = ot_images(dt, src, dst)
    weight_img = dt.ScalarImage(weight, width=1, height=1)
    d_newton = dt.wasserstein_distance(src_img, dst_img, method="newton", weight=weight_img,
                                       options=F_NEWTON)
    fixed = {"num_iter": F_BUDGET, "tol_residual": 0.0, "tol_increment": 0.0, "tol_distance": 0.0,
             "return_info": True}
    splitting = {
        "bregman": {**fixed, "l1_mode": "constant_cell_projection", "mobility_mode": "face_based",
                    "L": 1.0},
        "gprox": {**fixed, "l1_mode": "raviart_thomas"},
    }
    out["F4"] = {}
    for method, options in splitting.items():
        t0 = time.perf_counter()
        d4, info4 = dt.wasserstein_distance(src_img, dst_img, method=method, weight=weight_img,
                                            options=options)
        torch.cuda.synchronize()
        f4_s = time.perf_counter() - t0
        gap4 = info4["duality_gap"]
        if not (np.isfinite(d4) and np.isfinite(gap4)) or not gap4 >= -1e-4:
            raise AssertionError(f"F4 {method}: distance {d4}, certified gap {gap4} (dual > primal)")
        out["F4"][method] = {"s": f4_s, "distance": d4, "rel_newton": abs(d4 - d_newton) / d_newton}
        print(
            f"F4. {method} on the weighted blocks {n}x{n}: distance {d4:.6f} vs Newton "
            f"{d_newton:.6f} (rel {abs(d4 - d_newton) / d_newton:.2e}; not gated), "
            f"{info4['number_iterations'] + 1} iterations, {f4_s:.3f} s, certified gap {gap4:.4f}"
        )

    # F5: card against CPU tensor, F1's problem at 64^2.
    n = F_SIZES["F5"]
    src, dst, weight = ot_blocks(n)
    runs = {}
    for name, where in (("card", device), ("cpu", "cpu")):
        a, b = ot_images(dt, src, dst, device=where)
        t0 = time.perf_counter()
        d5, info5 = dt.wasserstein_distance(a, b, method="newton", weight=weight,
                                            options={**F_NEWTON, "return_info": True})
        runs[name] = (d5, info5["number_iterations"] + 1, time.perf_counter() - t0,
                      info5["pressure"].device.type)
        if name == "card":
            card_info = info5
            # The facade against the solver it builds: distance and raw gap.
            solver5 = dt.BeckmannNewtonSolver(dt.generate_grid(b), weight, F_NEWTON)
            md5 = b.img - a.img
            d_s, fl5, p5, _ = solver5.solve_beckmann_problem(md5)
            gap5 = solver5.duality_gap(fl5, p5, md5, polish_iters=0)
            if abs(d5 - d_s) > 1e-6 * d_s or abs(info5["duality_gap"] - gap5) > 1e-6:
                raise AssertionError(
                    f"F5: wasserstein_distance {d5} (gap {info5['duality_gap']}) vs the solver "
                    f"{d_s} (gap {gap5})"
                )
    rel5 = abs(runs["card"][0] - runs["cpu"][0]) / runs["cpu"][0]
    if runs["card"][3] != "cuda" or runs["cpu"][3] != "cpu" or not rel5 <= 1e-5:
        raise AssertionError(f"F5: card {runs['card']} vs CPU {runs['cpu']}: rel {rel5}")
    out["F5"] = {"rel": rel5, "info": card_info}
    print(
        f"F5. card vs CPU tensor at {n}x{n} (on the card, wasserstein_distance == its solver): distances {runs['card'][0]:.8f} / "
        f"{runs['cpu'][0]:.8f} (rel {rel5:.2e}, bound 1e-5), iterations {runs['card'][1]} / "
        f"{runs['cpu'][1]}, {runs['card'][2]:.2f} / {runs['cpu'][2]:.2f} s"
    )

    # F6: two cubes at 64^3 (tests/unit/test_wasserstein.py's 12^3 case scaled).
    n = F_SIZES["F6"]
    s = n // 12
    cubes = np.zeros((2, n, n, n), np.float32)
    cubes[0, 2 * s : 5 * s, 2 * s : 5 * s, 2 * s : 5 * s] = 1.0
    cubes[1, 6 * s : 9 * s, 6 * s : 9 * s, 6 * s : 9 * s] = 1.0
    c_src, c_dst = (dt.Image(c, dimensions=[1.0, 1.0, 1.0], scalar=True, dim=3) for c in cubes)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    d6 = dt.wasserstein_distance_3d(c_src, c_dst, method="newton",
                                    options={"num_iter": 60, "tol_residual": 1e-5,
                                             "return_info": True})
    d6, info6 = d6
    torch.cuda.synchronize()
    f6_s = time.perf_counter() - t0
    peak6 = torch.cuda.max_memory_allocated(device) / 2**30
    mass = (3 * s) ** 3 / n**3
    expected = np.sqrt(3) * 4 * s / n * mass
    if not np.isfinite(d6):
        raise AssertionError(f"F6: distance {d6}")
    out["F6"] = {"s": f6_s, "distance": d6}
    print(
        f"F6. two cubes {n}^3: distance {d6:.6f} (straight-line {expected:.6f}, rel "
        f"{abs(d6 - expected) / expected:.3f}), {info6['number_iterations'] + 1} iterations, "
        f"{f6_s:.3f} s (return_info included), peak {peak6:.3f} GiB"
    )
    out["phase_s"] = time.perf_counter() - tic
    print(f"transport on {card}: phase {out['phase_s']:.2f} s")
    return out


# Phase G: batched W1 and the cross-run comparison.  The bench's batch row
# (bench.py:485-521) uncut: B = 8 pairs at 256^2, the blocks plus 0.02 U(0, 1)
# noise from default_rng(0), normalised per pair, voxel size 1/n; then the
# batch at B = 1, 8 and 32; then the comparison's compute and assemble steps
# on 4 runs x 2 times of seeded 256^2 mass maps.
G_N, G_B = 256, 8
G_OPTIONS = {"num_iter": 100, "tol_distance": 1e-4}
G_SIZES = (1, 8, 32)
G_RUNS, G_TIMES = ("run_a", "run_b", "run_c", "run_d"), (0.0, 1.0)


def ot_batch(n: int, B: int, seed: int = 0) -> tuple:
    """(src, dst), each (B, n, n) float32: bench.py:499-511's batch."""
    q = n // 10
    src0 = np.zeros((n, n))
    src0[2 * q : 5 * q, 2 * q : 5 * q] = 1
    dst0 = np.zeros((n, n))
    dst0[1 * q : 3 * q, 1 * q : 2 * q] = 1
    dst0[4 * q : 7 * q, 7 * q : 9 * q] = 1
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for _ in range(B):
        s = src0 + 0.02 * rng.random((n, n))
        d = dst0 + 0.02 * rng.random((n, n))
        srcs.append(s / (s.sum() / (n * n)))
        dsts.append(d / (d.sum() / (n * n)))
    return np.stack(srcs).astype(np.float32), np.stack(dsts).astype(np.float32)


def cg_launches(dt, src, dst) -> float:
    """Launches (tensor ops, views excluded, and the pressure solve's own
    kernels) of one CG iteration of the batch's pressure solve (the solver's
    own: MG-PCG at 256^2) at its first Newton mobility: two fixed-count
    solves (tol 0) of 2 and 4 iterations, differenced."""
    from darsia_tpu_torch.utils import tracing

    n = src.shape[-1]
    counts = []
    for maxiter in (2, 4):
        options = {**G_OPTIONS, "linear_solver_options": {"rtol": 0.0, "maxiter": maxiter}}
        solver = dt.BeckmannNewtonSolver(dt.Grid((n, n), 1.0 / n), None, options)
        rhs = solver.cell_vol * (dst - src)
        c = solver._constants(rhs.device)
        p = solver.pressure_solve(c.base_face_weights, rhs, torch.zeros_like(rhs))
        weights = solver._cell_based_face_weights(solver.flux_from_pressure(c.base_face_weights, p))
        torch.cuda.synchronize()
        kernels = tracing.counter("beckmann.mg_launches")
        with OpCounter() as counter:
            solver.pressure_solve(weights, rhs, torch.zeros_like(rhs))
            torch.cuda.synchronize()
        counts.append(counter.n + tracing.counter("beckmann.mg_launches") - kernels)
    return (counts[1] - counts[0]) / 2


def batch_cg_counter(bk):
    """Record each batched CG solve's per-pair iteration counts: wraps the
    ``iterate_while_batched`` that ``beckmann_kernels`` calls and, where it
    has one, its kernels' loop ``mg_pcg_fused``."""
    counts, original = [], bk.iterate_while_batched
    fused = getattr(bk, "mg_pcg_fused", None)

    def counting(*args, **kwargs):
        out = original(*args, **kwargs)
        counts.append(out[1])
        return out

    def counting_fused(*args, **kwargs):
        out = fused(*args, **kwargs)
        counts.append(out[1])
        return out

    bk.iterate_while_batched = counting
    if fused is not None:
        bk.mg_pcg_fused = counting_fused

    def undo():
        bk.iterate_while_batched = original
        if fused is not None:
            bk.mg_pcg_fused = fused

    return counts, undo


def mg_launch_counter(bk):
    """Count the launches of each CG-trip kernel (``csrc/tpfa_mg.cu``) by
    its C entry, and those of ``beckmann.mg_launches`` from a mark set now:
    wraps the ``_launch_kernel`` that ``beckmann_kernels`` calls; returns
    (counts, undo)."""
    from darsia_tpu_torch.utils import tracing

    counts = {name: 0 for name in CG_KERNELS}
    original = bk._launch_kernel
    mark = tracing.counter("beckmann.mg_launches")

    def counting(name, args, stream):
        original(name, args, stream)
        counts[name.removeprefix("darsia_")] += 1

    bk._launch_kernel = counting

    def undo():
        bk._launch_kernel = original
        counts["beckmann.mg_launches"] = tracing.counter("beckmann.mg_launches") - mark

    return counts, undo


def check_mg_launches(launches: dict, trips: int, where: str) -> None:
    """The CG-trip kernels' launches in a main-path run: the program's
    ``beckmann.mg_launches`` equal to their sum, and each trip's kernels
    (A p, the update, the direction, the finalize) launched at least once a
    trip."""
    counter = launches.pop("beckmann.mg_launches")
    if counter != sum(launches.values()):
        raise AssertionError(f"{where}: beckmann.mg_launches {counter}, launches {launches}")
    for name in ("tpfa_apply", "cg_update", "cg_direction", "cg_finalize"):
        if launches[name] < trips:
            raise AssertionError(f"{where}: {launches[name]} launches of {name}, {trips} CG trips")
    if not launches["mg_pre"] >= trips or launches["mg_pre"] != launches["mg_post"]:
        raise AssertionError(f"{where}: V-cycle launches {launches}, {trips} CG trips")
    if launches["mg_coarse_matrix"] < 1:
        raise AssertionError(f"{where}: the coarsest level's matrix was never built: {launches}")


def mg_kernel_trips() -> int:
    """CG trips run by the pressure solve's kernels so far (the counter
    ``beckmann.mg_kernel_trips``)."""
    from darsia_tpu_torch.utils import tracing

    return tracing.counter("beckmann.mg_kernel_trips")


def comparison_maps(dt, root: Path, n: int) -> SimpleNamespace:
    """4 runs x 2 times of seeded n x n mass maps (the batch's blocks moved
    per run, plus noise, unit mass), saved with ``Image.save`` as an analysis
    exports them, each run with a CSV imaging protocol; the config object the
    comparison's compute step reads (``tests/unit/test_comparison_wasserstein.py``'s
    kind, with each run's data, protocol and mass folder)."""
    start = datetime(2024, 3, 1, 9)
    src, _ = ot_batch(n, 1)
    runs = {}
    for r, run in enumerate(G_RUNS):
        folder = root / run
        (folder / "mass" / "npz").mkdir(parents=True)
        lines = ["image_id,datetime"]
        for i, _ in enumerate(G_TIMES):
            rng = np.random.default_rng(100 + 10 * r + i)
            arr = np.roll(src[0], (3 * r + i, 5 * r), axis=(0, 1)) + 0.02 * rng.random((n, n))
            arr = (arr / (arr.sum() / (n * n))).astype(np.float32)
            image = dt.Image(torch.from_numpy(arr).cuda(), width=1, height=1, scalar=True)
            image.save(folder / "mass" / "npz" / f"mass_{i:05d}.npz")
            lines.append(f"{i},{(start + timedelta(hours=i)).isoformat(sep=' ')}")
        (folder / "imaging.csv").write_text("\n".join(lines) + "\n")
        runs[run] = SimpleNamespace(
            analysis=SimpleNamespace(mass=SimpleNamespace(folder=folder)),
            data=SimpleNamespace(data=[], pad=5),
            protocol=SimpleNamespace(imaging=folder / "imaging.csv", injection=None,
                                     pressure_temperature=None, blacklist=None),
        )
    wasserstein = SimpleNamespace(results=root / "results", runs=list(G_RUNS), resize_factor=None,
                                  relative_tol=0.5, times=[(t, 0.1) for t in G_TIMES])
    return SimpleNamespace(runs=SimpleNamespace(config=runs), wasserstein=wasserstein)


def phase_batched(dt, device, card: str, profile) -> dict:
    """Phase G: ``batched_wasserstein`` on the bench's batch row, then the
    comparison's compute and assemble steps."""
    import importlib
    import tempfile

    from darsia_tpu_torch.measure import beckmann_kernels as bk
    from darsia_tpu_torch.parallel import batched_wasserstein

    tic = time.perf_counter()
    out = {}
    n = G_N
    src_np, dst_np = ot_batch(n, max(G_SIZES))
    src_all = torch.from_numpy(src_np).to(device)
    dst_all = torch.from_numpy(dst_np).to(device)
    solve = batched_wasserstein((n, n), voxel_size=1.0 / n, options=G_OPTIONS)

    # The bench row: B = 8, one warm-up call, then the timed one.
    src, dst = src_all[:G_B], dst_all[:G_B]
    t0 = time.perf_counter()
    solve(src, dst)
    warm_s = time.perf_counter() - t0
    counts, undo = batch_cg_counter(bk)
    launches, undo_launches = mg_launch_counter(bk)
    kernel_trips = mg_kernel_trips()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        distances, iterations, statuses = solve(src, dst)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    finally:
        undo()
        undo_launches()
    if distances.shape != (G_B,) or not np.all(np.isfinite(distances)) or not np.all(statuses == 1):
        raise AssertionError(f"G: distances {distances}, statuses {statuses}: not all converged")
    trips = np.array([int(c.max()) for c in counts])
    kernel_trips = mg_kernel_trips() - kernel_trips
    if not kernel_trips > 0 or kernel_trips != int(trips.sum()):
        raise AssertionError(f"G1: {kernel_trips} CG trips in the kernels, {int(trips.sum())} counted")
    check_mg_launches(launches, kernel_trips, "G1")
    per_pair = np.sum(counts, axis=0)
    out["batch8"] = {
        "s": batch_s, "pairs_per_s": G_B / batch_s, "iterations": int(iterations.max()),
        "mg_launches": launches,
    }
    print(
        f"G1. batched W1, B = {G_B} at {n}x{n} on {card}: {batch_s:.3f} s per batch "
        f"(warm-up {warm_s:.3f} s), "
        f"w1_batch8_256_pairs_per_s {G_B / batch_s:.3f}, Newton iterations per pair "
        f"{iterations.tolist()} (w1_batch8_256_iterations {int(iterations.max())}), all "
        f"converged; distances {np.round(distances, 6).tolist()}; CG: {int(trips.sum())} "
        f"iterations run by the batch over {len(counts)} pressure solves, per pair "
        f"{per_pair.min()}-{per_pair.max()} (mean {per_pair.mean():.0f}: the batch ran "
        f"{trips.sum() / per_pair.mean():.2f}x a mean pair's)"
    )

    # Pair 0 alone, through the single Newton device path (the last pair
    # alone too is depth cut for the script's time: PERF.md section 4).
    singles = {}
    for i in (0,):
        solver = dt.BeckmannNewtonSolver(dt.Grid((n, n), 1.0 / n), None, dict(G_OPTIONS))
        t0 = time.perf_counter()
        d_i, _, _, info = solver.solve_beckmann_problem(dst[i] - src[i])
        s_i = time.perf_counter() - t0
        rel = abs(d_i - distances[i]) / d_i
        if not info["converged"] or not rel <= 1e-4:
            raise AssertionError(f"G: pair {i} alone {d_i} vs in the batch {distances[i]}: {rel}")
        singles[i] = (d_i, info["number_iterations"] + 1, s_i, rel)
    print(
        f"G2 (at {time.perf_counter() - tic:.1f} s). pairs alone (single Newton device path): "
        + "; ".join(
            f"pair {i} {d:.6f} ({k} iterations, {s:.3f} s; rel to the batch {r:.2e})"
            for i, (d, k, s, r) in singles.items()
        )
    )

    # B = 1, 8, 32: seconds per batch, pairs/s, launches per CG iteration, peak.
    single_launches = cg_launches(dt, src_all[0], dst_all[0])
    sizes = {}
    for B in G_SIZES:
        s_b, d_b = src_all[:B], dst_all[:B]
        launches = cg_launches(dt, s_b, d_b)
        if B == G_B:
            seconds, k_b, st_b = batch_s, iterations, statuses
            peak = torch.cuda.max_memory_allocated(device) / 2**30
        else:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            _, k_b, st_b = solve(s_b, d_b)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) / 2**30
        if not np.all(st_b == 1):
            raise AssertionError(f"G: B = {B}: statuses {st_b}")
        sizes[B] = {"s": seconds, "pairs_per_s": B / seconds, "launches_per_cg": launches,
                    "peak_gib": peak, "iterations": (int(k_b.min()), int(k_b.max()))}
        print(
            f"G3 (at {time.perf_counter() - tic:.1f} s). B = {B}: {seconds:.3f} s per batch, "
            f"{B / seconds:.3f} pairs/s, Newton "
            f"iterations {int(k_b.min())}-{int(k_b.max())}, {launches:.0f} launches per CG "
            f"iteration (one problem without a batch axis: {single_launches:.0f}), peak "
            f"{peak:.3f} GiB"
        )
    if len({v["launches_per_cg"] for v in sizes.values()}) != 1:
        raise AssertionError(f"G: launches per CG iteration differ with B: {sizes}")
    out["sizes"] = sizes

    # The comparison's compute and assemble steps on saved maps.
    cw = importlib.import_module(
        "darsia_tpu_torch.presets.workflows.comparison.comparison_wasserstein"
    )
    with tempfile.TemporaryDirectory() as tmp:
        config = comparison_maps(dt, Path(tmp), n)
        t0 = time.perf_counter()
        results = cw._compute(None, config, skip_existing=False)
        compute_s = time.perf_counter() - t0
        files = sorted(config.wasserstein.results.glob("wasserstein_*.json"))
        rows = cw._assemble(config)
        lines = (config.wasserstein.results / "wasserstein_distances.csv").read_text().splitlines()
        if len(results) != 12 or len(files) != 12 or len(rows) != 12 or len(lines) != 13:
            raise AssertionError(
                f"G: {len(results)} results, {len(files)} files, {len(rows)} rows, "
                f"{len(lines)} CSV lines; want 12, 12, 12, 13"
            )
        checked = []
        for result in (results[0], results[-1]):
            i = G_TIMES.index(result.time)
            a, b = (
                dt.imread(Path(tmp) / run / "mass" / "npz" / f"mass_{i:05d}.npz")
                for run in (result.run_a, result.run_b)
            )
            alone = dt.wasserstein_distance(a, b, method="newton")
            rel = abs(alone - result.distance) / alone
            if not np.isfinite(result.distance) or not rel <= 1e-4:
                raise AssertionError(f"G: {result} vs alone {alone}: {rel}")
            checked.append(f"{result.run_a}/{result.run_b} t={result.time} rel {rel:.2e}")
    out["compare_s"] = compute_s
    print(
        f"G4 (at {time.perf_counter() - tic:.1f} s). comparison compute step: 4 runs x 2 times at {n}x{n}, 12 pairs in one group "
        f"(one batched solve without options, as the JAX package's: the default tolerances "
        f"stop each pair at its third iteration), {compute_s:.3f} s "
        f"({12 / compute_s:.3f} pairs/s, map loading included); 12 result files, a 12-row "
        f"CSV; against single solves: {'; '.join(checked)}"
    )
    if profile is not None:
        for B in G_SIZES:
            profile_batch(dt, src_all[:B], dst_all[:B], profile, f"w1_batch{B}")
    out["phase_s"] = time.perf_counter() - tic
    print(f"batched W1 and comparison on {card}: phase {out['phase_s']:.2f} s")
    return out


# Phase S: the pressure solve's CG-trip kernels (``csrc/tpfa_mg.cu``), each
# step against its plain version (``FusedMGPCG(kernels=False)``, and per
# V-cycle level the tensor V-cycle's own steps) at the shapes the main path
# runs: the W1 benchmark cell's 1024 pairs at 120 x 280 (per-pair faces),
# F1's one problem at 512^2 (shared faces, B = 1) and G1's 8 pairs at 256^2.
# A pass of a kernel differs from its plain version by a few float32
# roundings of its largest term: 1e-5 of the output's largest value.
S_CASES = (("cell", 1024, (120, 280)), ("F1", 1, (512, 512)), ("G1", G_B, (G_N, G_N)))
S_TOL = 1e-5
#: The CG-trip kernels by their C entry (``darsia_<name>``), as the
#: ``kernels`` line names them.
CG_KERNELS = (
    "tpfa_apply", "cg_update", "mg_pre", "mg_post", "cg_direction", "cg_finalize",
    "mg_coarse_matrix",
)
#: The per-pair state of ``FusedMGPCG`` that a step reads or writes.
S_STATE = ("X", "R", "P", "AP", "Z", "sel", "mx", "rn", "rz", "rz_next", "thr", "act")


def mg_problem(B: int, shape: tuple, device, seed: int = 0) -> tuple:
    """Seeded transmissibilities spanning three decades (per pair for B > 1,
    shared for B = 1, as a single solve has them) and standard normal
    right-hand sides ``(B, h, w)``."""
    rng = np.random.default_rng(seed)
    lead = (B,) if B > 1 else ()
    faces = [(shape[0] - 1, shape[1]), (shape[0], shape[1] - 1)]
    trans = tuple(
        torch.from_numpy((10.0 ** rng.uniform(-1.5, 1.5, lead + f)).astype(np.float32)).to(device)
        for f in faces
    )
    rhs = torch.from_numpy(rng.standard_normal((B,) + shape).astype(np.float32)).to(device)
    return trans, rhs


def mg_state_copy(dst, src) -> None:
    """``dst``'s state := ``src``'s, per-pair partial sums folded into their
    first block (what a step reads of them is their sum)."""
    for name in S_STATE:
        getattr(dst, name).copy_(getattr(src, name))
    for name in ("part_a", "part_u", "part_v"):
        d, s = getattr(dst, name), getattr(src, name)
        d.zero_()
        d[:, 0] = s.sum(dim=1)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    scale = float(want.abs().max()) or 1.0
    return float((got.double() - want.double()).abs().max()) / scale


def mg_level_steps(bk, ker) -> list:
    """Per V-cycle level above the coarsest, on the kernels' own inputs of
    their last V-cycle (``vcycle(1)``): ``(b, x_pre, rc, post)``: the
    level's right-hand side, and the plain pre pass (``nu`` sweeps from zero,
    the residual restricted) and post pass (the kernels' pre-smoothed x plus
    the prolonged coarse correction, ``nu`` sweeps) as functions."""
    h, nu = ker.hierarchy, ker.nu
    out = []
    for l in range(len(ker.trans) - 1):
        b = ker.R[ker.sel.long() ^ 1, ker._ar] if l == 0 else ker.rc[l]
        t, step = h.trans[l], h.steps[l]
        shape = tuple(b.shape)

        def pre(b=b, t=t, step=step):
            x = bk._tpfa_sweeps(None, b, t, step, 2, nu)
            return x, bk._restrict_cells(bk._tpfa_residual(x, b, t, 2), 2)

        def post(b=b, t=t, step=step, l=l, shape=shape):
            ec = bk._prolong_cells(ker.zl[l + 1].float(), shape, 2)
            return bk._tpfa_sweeps(ker.xs[l] + ec, b, t, step, 2, nu)

        out.append((b, pre, post))
    return out


def cg_kernel_rows(bk, ker, ref, trans, levels: int) -> list:
    """``(kernel, label, launch, plain, bytes)`` for each launch of a CG trip
    (both passes of every V-cycle level) and the coarsest level's matrix:
    each input read once, each output written once."""

    def size(t) -> int:
        return t.numel() * t.element_size()

    field = size(ker.Z)
    rows = [
        ("tpfa_apply", "A p", ker.apply, ref.apply, 2 * field + sum(size(t) for t in ker.trans[0])),
        ("cg_update", "x, r update", ker.update, ref.update, 6 * field),
    ]
    for l, (b, pre, post) in enumerate(mg_level_steps(bk, ker)):
        t = sum(size(x) for x in ker.trans[l])
        flip = int(l == 0)
        # pre reads b and the faces, writes its x and the restriction; post
        # reads b, that x, the faces and the coarse correction, writes z.
        rows.append(("mg_pre", f"pre {ker.shapes[l]}", lambda a=ker._pre[l][flip]: ker._launch(*a),
                     pre, 2 * size(b) + t + size(ker.rc[l + 1])))
        rows.append(("mg_post", f"post {ker.shapes[l]}",
                     lambda a=ker._post[l][flip]: ker._launch(*a), post,
                     3 * size(b) + t + size(ker.zl[l + 1])))
    rows.append(("cg_direction", "direction", ker.direction, ref.direction, 3 * field))
    rows.append(("cg_finalize", "finalize", ker.finalize, ref.finalize,
                 5 * 4 * ker.B + size(ker.part_u)))
    coarse = ker.hierarchy.coarse
    if coarse is not None:
        faces = sum(size(t) for t in ker.trans[-1])
        sweeps = ker.nu + ker.nu_coarse
        # Its plain version: the tensor hierarchy's build less its levels'.
        rows.append(("mg_coarse_matrix", f"coarse matrix {ker.shapes[-1]}",
                     lambda: bk.mg_coarse_matrix(ker.trans[-1], sweeps),
                     lambda: bk.tpfa_mg_hierarchy(trans, 2, levels), size(coarse) + faces))
    return rows


def phase_cg_kernels(dt, device, card: str) -> dict:
    """Phase S: each step of the pressure solve's CG trip in the kernels
    against its plain version, at the main path's shapes; the kernels timed
    at the W1 cell's shape."""
    from darsia_tpu_torch.measure import beckmann_kernels as bk

    tic = time.perf_counter()
    worst = {name: 0.0 for name in CG_KERNELS}

    def check(name, got, want, what) -> None:
        err = rel_err(got, want)
        worst[name] = max(worst[name], err)
        if not err <= S_TOL:
            raise AssertionError(f"S: {what}: max |diff| {err:.3e} of the largest value > {S_TOL}")

    timed = {}
    for case, B, shape in S_CASES:
        trans, rhs = mg_problem(B, shape, device)
        levels = bk.tpfa_mg_levels(shape)
        hierarchy = bk.mg_hierarchy_on_card(trans, levels)
        plain_h = bk.tpfa_mg_hierarchy(trans, 2, levels)
        if hierarchy.coarse is None or plain_h.coarse is None:
            raise AssertionError(f"S {case}: no coarsest-level matrix at {levels} levels")
        check("mg_coarse_matrix", hierarchy.coarse, plain_h.coarse, f"{case} coarse matrix")
        ker, ref = (bk.FusedMGPCG(hierarchy, B, shape, 2, 40, kernels=k) for k in (True, False))
        x0 = torch.zeros_like(rhs)
        for solver in (ker, ref):
            solver.start(rhs, x0, 1e-6)
        # A few trips of the mirror, so that the steps see a CG state.
        for _ in range(3):
            ref.trip()
        for step in ("apply", "update", "vcycle", "direction", "finalize"):
            mg_state_copy(ker, ref)
            ker.act.fill_(1)
            ref.act.fill_(1)
            for solver in (ker, ref):
                getattr(solver, step)(*((1,) if step == "vcycle" else ()))
            torch.cuda.synchronize()
            what = f"{case} {step}"
            if step == "apply":
                check("tpfa_apply", ker.AP, ref.AP, what)
                check("tpfa_apply", ker.part_a.sum(1), ref.part_a.sum(1), what + " <p, A p>")
            elif step == "update":
                check("cg_update", ker.X, ref.X, what + " x")
                check("cg_update", ker.R, ref.R, what + " r")
                check("cg_update", ker.part_u.sum(1), ref.part_u.sum(1), what + " sums")
            elif step == "vcycle":
                check("mg_post", ker.Z, ref.Z, what)
                check("mg_post", ker.part_v.sum(1), ref.part_v.sum(1), what + " sums")
                for l, (b, pre, post) in enumerate(mg_level_steps(bk, ker)):
                    x, rc = pre()
                    check("mg_pre", ker.xs[l], x, f"{case} pre level {l} x")
                    check("mg_pre", ker.rc[l + 1], rc, f"{case} pre level {l} restriction")
                    check("mg_post", ker.zl[l], post(), f"{case} post level {l}")
            elif step == "direction":
                check("cg_direction", ker.P, ref.P, what)
                check("cg_direction", ker.rz_next, ref.rz_next, what + " rz")
            else:
                for name in ("sel", "act"):
                    if not torch.equal(getattr(ker, name), getattr(ref, name)):
                        raise AssertionError(f"S: {what}: {name} differs")
                for name in ("mx", "rn", "rz"):
                    check("cg_finalize", getattr(ker, name), getattr(ref, name), f"{what} {name}")
        print(
            f"S ({case}, B = {B} at {shape[0]}x{shape[1]}, {levels} levels, "
            f"{'shared' if B == 1 else 'per-pair'} faces): every step and level within "
            f"{S_TOL:.0e} of the largest value (at {time.perf_counter() - tic:.1f} s)"
        )
        if case == "cell":
            ker.vcycle(1)
            rows = cg_kernel_rows(bk, ker, ref, trans, levels)
            for name, label, fn, plain, nbytes in rows:
                ker.act.fill_(1)
                ref.act.fill_(1)
                ms = cuda_ms(fn, 20, device_paced=True)
                plain_ms = cuda_ms(plain, 5)
                if name == "mg_coarse_matrix":
                    plain_ms -= cuda_ms(lambda: bk._mg_levels(trans, 2, levels, bk._OMEGA), 5)
                bound_ms = nbytes / PEAK_BYTES_S * 1e3
                print(f"S time {label:>26}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_ms / ms:.0%}), plain {plain_ms:.4f} ms")
                row = timed.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0})
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["bound_ms"] += bound_ms
        del ker, ref, hierarchy, plain_h
    out = {name: {"max_rel_err": worst[name], **timed[name]} for name in CG_KERNELS}
    out["phase_s"] = time.perf_counter() - tic
    print(f"CG-trip kernels against their plain versions on {card}: phase {out['phase_s']:.2f} s")
    return out


# Phase H: the FluidFlower CO2 and tracer analyses and the rig, through their
# public objects, on seeded 1788x3180 uint8 photographs saved as npz: the
# rig's 12 wavy layers in seeded colours under sensor noise, its checker, a
# drift of the probe, a CO2 plume and a stronger gas core painted in.
H_LAYERS = 12
H_SHIFT = (2, 3)
H_PLUME = ((1000, 1600), (350, 700))  # raw frame: centre (row, col), radii
H_CORE = ((850, 1600), (120, 300))
H_NOISE = 2.0 / 255
# The option keys of tests/unit/test_fluidflower_presets.py:30-58.
H_OPTIONS = {
    "diff option": "absolute",
    "restoration -> model": True,
    "restoration resize": 0.5,
    "restoration method": "chambolle",
    "restoration weight": 0.05,
    "restoration max_num_iter": 30,
    "prior remove small objects size": 5,
    "prior fill holes size": 5,
    "prior resize": 0.5,
    "prior method": "chambolle",
    "prior weight": 0.05,
    "prior max_num_iter": 30,
    "posterior criterion": "value",
    "posterior threshold": 0.02,
}
H_TRACER = {
    "color": "gray",
    "diff option": "absolute",
    "restoration resize": 0.5,
    "restoration method": "chambolle",
    "restoration weight": 0.05,
    "restoration max_num_iter": 30,
}
# K1 launches of the managers' reading calls with drift, colour and
# curvature configured: _PIPELINE's order (drift, colour, curvature) splits
# the geometric corrections into two runs, a K1 pair each, and the colour
# correction warps its checker crop (one more pair).
H_READ_K1 = 2 + 2 + 2
# The set-up: the uncorrected baseline and the drift's own baseline (no
# chain yet, none), the drift-corrected baseline (the drift alone: 2), the
# baseline through the whole chain (6, and 8 more: the new curvature
# correction's first call builds its pull-back grid by warping the
# identity's two coordinate images through the crop and the bulge), and,
# learning the cleaning filter, each of the 2 baselines once more (12; read
# from the cache: none).
H_GRID_K1 = 2 * 2 * 2
H_SETUP_K1 = {
    "learn": 2 + H_READ_K1 + H_GRID_K1 + 2 * H_READ_K1,
    "cached": 2 + H_READ_K1 + H_GRID_K1,
}
# H1: set-up learnt and cached, the path, its K1 calls recorded against
# plain K1, a warm-up, H_TIMED timed calls, H_SPLIT calls split by stage;
# H2: set-up, the balancing calibration (2 reads), the reckoning's 2 reads,
# a warm-up and H_TIMED timed calls; H3: no correction, none.
H_TIMED, H_SPLIT = 3, 1
K1_IN_H = (
    H_SETUP_K1["learn"] + H_SETUP_K1["cached"] + (1 + 1 + 1 + H_TIMED + H_SPLIT) * H_READ_K1
    + H_SETUP_K1["learn"] + (2 + 2 + 1 + H_TIMED) * H_READ_K1
)


def h_raw_layers(rows: int, cols: int, layers: int, seed: int = 8) -> np.ndarray:
    """``layer_labels``'s wavy layers over a raw frame of ``rows`` rows."""
    rng = np.random.default_rng(seed)
    r = np.arange(rows, dtype=np.float64)[:, None]
    c = np.arange(cols, dtype=np.float64)[None, :]
    labels = np.zeros((rows, cols), dtype=np.int64)
    height = rows / layers
    for k in range(1, layers):
        amp = rng.uniform(0.05, 0.25) * height
        wave = rng.uniform(600.0, 2400.0) * cols / W
        labels += r >= k * height + amp * np.sin(2 * np.pi * c / wave + rng.uniform(0, 2 * np.pi))
    return labels


def h_labels(dt, device) -> torch.Tensor:
    """The painted layers in the corrected frame: the raw layer map through
    the rig's curvature correction, rounded (the labels a segmentation of the
    corrected baseline gives)."""
    raw = torch.from_numpy(h_raw_layers(H, W, H_LAYERS).astype(np.float32)).to(device)
    warped = dt.CurvatureCorrection(config=CURVATURE)(dt.Image(raw, scalar=True, **META)).img
    return torch.round(warped).to(torch.int64)


def h_ellipse(shape: tuple, spec: tuple, scale: float = 1.0) -> np.ndarray:
    (r0, c0), (a, b) = spec
    r = np.arange(shape[0])[:, None]
    c = np.arange(shape[1])[None, :]
    return ((r - r0) / (a * scale)) ** 2 + ((c - c0) / (b * scale)) ** 2 < 1.0


def h_scene(rows: int, cols: int, seed: int) -> np.ndarray:
    """The layered rig in seeded colours, float64 in [0, 1], noise-free."""
    rng = np.random.default_rng(seed)
    colours = rng.uniform(0.3, 0.7, (H_LAYERS, 3))
    return colours[h_raw_layers(rows, cols, H_LAYERS)]


def h_photo(scene: np.ndarray, seed: int) -> np.ndarray:
    """A uint8 photograph of the scene under seeded sensor noise."""
    rng = np.random.default_rng(seed)
    img = scene + rng.normal(0.0, H_NOISE, scene.shape)
    return np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def h_save(dt, path: Path, arr: np.ndarray) -> Path:
    dt.OpticalImage(torch.from_numpy(arr), **META).save(path)
    return path


def h_layered(cls, labels):
    """``cls`` with the rig's labels set before the manager's set-up."""

    class Layered(cls):
        def __init__(self, *args, **kwargs):
            self.labels = labels
            super().__init__(*args, **kwargs)

    return Layered


def h_config(root: Path, name: str, voxels, sections: dict) -> Path:
    config = {
        "physical_asset": {"dimensions": {"width": META["width"], "height": META["height"]}},
        **sections,
    }
    if voxels is not None:
        config.update(
            {
                "drift": {"roi": voxels},
                "color": {"roi": voxels, "clip": False},
                "curvature": CURVATURE,
            }
        )
    path = root / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def h_co2_sections(root: Path, tag: str, thresholds: list) -> dict:
    return {
        "co2": dict(
            H_OPTIONS,
            color="negative-key",
            cleaning_filter=str(root / "cache" / f"{tag}_co2.npy"),
            **{"prior threshold value": thresholds},
        ),
        "co2(g)": dict(
            H_OPTIONS,
            color="blue",
            cleaning_filter=str(root / "cache" / f"{tag}_co2_gas.npy"),
            **{
                "prior threshold dynamic": True,
                "prior threshold method": "otsu",
                "prior threshold value min": 0.1,
                "prior threshold value max": 0.9,
            },
        ),
    }


def counted(w2p, fn, want_k1: int, path: str):
    """``fn()`` with every count set to 0 just before and read just after:
    exactly ``want_k1`` K1 launches.  Returns (output, seconds, K1 count)."""
    reset_counts(w2p)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    counts = read_counts(w2p)
    check_counts(counts, {"warp_rows_t": want_k1}, path)
    return out, seconds, counts["warp_rows_t"]


def corrected_indicator(dt, analysis, mask: np.ndarray, device) -> torch.Tensor:
    """A raw-frame region (of the photograph before its drift) in the
    corrected frame: its indicator through the manager's curvature
    correction."""
    indicator = dt.Image(torch.from_numpy(mask.astype(np.float32)).to(device), scalar=True, **META)
    return analysis.curvature_correction(indicator).img > 0.5


def seeded_points(mask: torch.Tensor, count: int, seed: int) -> tuple:
    """``count`` seeded (rows, cols) of ``mask`` (host arrays)."""
    where = np.argwhere(mask.cpu().numpy())
    pick = np.random.default_rng(seed).choice(len(where), count, replace=False)
    return tuple(where[pick].T)


def phase_fluidflower(dt, w2p, device, card: str, profile) -> dict:
    """Phase H: FluidFlowerCO2Analysis, FluidFlowerTracerAnalysis and
    FluidFlowerRig at the rig's size."""
    import tempfile

    from scipy import ndimage

    from darsia_tpu_torch.signals.models.dynamicthresholdmodel import StandardOtsu, label_histograms

    tic = time.perf_counter()
    # The entry points' default is the card; on a CPU device, the CPU.
    dev = None if device.type == "cuda" else device
    root = Path(tempfile.mkdtemp(prefix="phase_h_"))
    scene = h_scene(H, W, seed=21)
    base_u8, _ = rig_frame(dt, h_photo(scene, 22))
    base2_u8, _ = rig_frame(dt, h_photo(scene, 23))
    def paint_co2(img):
        img = np.roll(img, H_SHIFT, axis=(0, 1))
        plume = np.roll(h_ellipse((H, W), H_PLUME), H_SHIFT, axis=(0, 1))
        core = np.roll(h_ellipse((H, W), H_CORE), H_SHIFT, axis=(0, 1))
        img[plume] += [-0.25, -0.1, 0.2]
        img[core] += [-0.2, -0.15, 0.25]
        return img

    probe_u8, _ = rig_frame(dt, h_photo(scene, 24))
    probe_u8 = np.round(np.clip(paint_co2(probe_u8 / 255.0), 0, 1) * 255).astype(np.uint8)
    paths = {
        name: h_save(dt, root / f"{name}.npz", arr)
        for name, arr in (("base", base_u8), ("base2", base2_u8), ("probe", probe_u8))
    }
    _, voxels = dt.find_colorchecker(dt.OpticalImage(torch.from_numpy(base_u8).to(device), **META))
    voxels = np.asarray(voxels).tolist()
    labels = h_labels(dt, device)
    thresholds = list(np.random.default_rng(26).uniform(0.08, 0.14, H_LAYERS))
    config = h_config(root, "co2", voxels, h_co2_sections(root, "h1", thresholds))
    Layered = h_layered(dt.FluidFlowerCO2Analysis, labels)
    baselines = [paths["base"], paths["base2"]]
    frames_s = time.perf_counter() - tic

    # H1. Set-up: the cleaning filter learnt, then read from its cache.
    launches = 0
    make = lambda: Layered(baselines, config, root / "results", device=dev)  # noqa: E731
    _, learn_s, n = counted(w2p, make, H_SETUP_K1["learn"], "H1: set-up, filter learnt")
    launches += n
    analysis, cached_s, n = counted(w2p, make, H_SETUP_K1["cached"], "H1: set-up, filter cached")
    launches += n
    for key in ("co2", "co2(g)"):
        cached = np.load(json.loads(config.read_text())[key]["cleaning_filter"])
        target = analysis.co2_analysis if key == "co2" else analysis.co2_gas_analysis
        if not np.array_equal(target.threshold_cleaning_filter.cpu().numpy(), cached):
            raise AssertionError(f"H1: the {key} cleaning filter read back differs from its cache")
    if analysis.base.img.device.type != device.type or tuple(analysis.base.img.shape[:2]) != (OH, W):
        raise AssertionError(f"H1: baseline {tuple(analysis.base.img.shape)} on {analysis.base.img.device}")

    # The path: one photograph, its segmentation written.
    (co2, gas), _, n = counted(
        w2p,
        lambda: analysis.single_image_analysis(paths["probe"], write_segmentation_to_file=True),
        H_READ_K1,
        "H1: photograph",
    )
    launches += n
    c, g = co2.img.to(torch.bool), gas.img.to(torch.bool)
    if tuple(c.shape) != (OH, W) or c.device.type != device.type:
        raise AssertionError(f"H1: CO2 mask {tuple(c.shape)} on {c.device}")
    outside = int((g & ~c).sum())
    seg = np.load(root / "results" / "npy_segmentation" / "probe_segmentation.npy")
    want_seg = np.where(g.cpu().numpy(), 2, c.cpu().numpy().astype(np.int64))
    if outside != 0 or seg.dtype != np.int64 or not np.array_equal(seg, want_seg):
        raise AssertionError(f"H1: {outside} CO2(g) pixels outside CO2, or the segmentation file differs")

    # Each of the reading call's K1 launches against plain K1, bitwise.
    calls, _, n = counted(
        w2p,
        lambda: frame_k1_calls(w2p, lambda: analysis.load_and_process_image(paths["probe"])),
        H_READ_K1,
        "H1: reading call, recorded",
    )
    launches += n
    for name, (data, cols, max_disp) in zip(("drift", "drift", "checker crop", "checker crop", "curvature", "curvature"), calls):
        if not torch.equal(w2p.warp_rows_t(data, cols, max_disp), w2p.warp_rows_t(data, cols, max_disp, "plain")):
            raise AssertionError("H1: a reading call's K1 launch differs from plain K1")
        C, R, W_in = data.shape
        k1_ms = cuda_ms(lambda: w2p.warp_rows_t(data, cols, max_disp), 20)
        paced = cuda_ms(lambda: w2p.warp_rows_t(data, cols, max_disp), 20, device_paced=True)
        plain = cuda_ms(lambda: w2p.warp_rows_t_reference(data, cols, max_disp), 5)
        grid_sample = k1_library_call(data, cols)
        lib_err = float((grid_sample() - w2p.warp_rows_t(data, cols, max_disp)).abs().max())
        lib_ms = cuda_ms(grid_sample, 20)
        lib_paced = cuda_ms(grid_sample, 20, device_paced=True)
        _, bound_ms, bound_by = k1_bound(C, R, W_in, cols.shape[1])
        print(
            f"H1. K1 {name} {(C, R, W_in)} -> {(C, cols.shape[1], R)} D={max_disp}: bitwise, {k1_ms} ms "
            f"(device-paced {paced}), bound {bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / k1_ms:.1f}% "
            f"of bound; plain {plain} ms; library call F.grid_sample {lib_ms} ms (device-paced "
            f"{lib_paced}), max|diff| to K1 {lib_err}"
        )

    # The plume at seeded points, the background clean, the gas core found.
    plume_c = corrected_indicator(dt, analysis, h_ellipse((H, W), H_PLUME, 0.85), device)
    core_c = corrected_indicator(dt, analysis, h_ellipse((H, W), H_CORE, 0.7), device)
    near_plume = corrected_indicator(dt, analysis, h_ellipse((H, W), H_PLUME, 1.15), device)
    # Off the plume, away from the border strips the drift leaves uncovered.
    off_plume = ~near_plume
    off_plume[:32], off_plume[-32:], off_plume[:, :32], off_plume[:, -32:] = False, False, False, False
    stray = float(c[off_plume].float().mean())
    pr, pc = seeded_points(plume_c, 20, 27)
    br, bc = seeded_points(off_plume, 20, 28)
    cr, cc = seeded_points(core_c, 10, 29)
    c_h, g_h = c.cpu().numpy(), g.cpu().numpy()
    if not (c_h[pr, pc].all() and not c_h[br, bc].any() and g_h[cr, cc].all() and stray < 1e-3):
        raise AssertionError(
            f"H1: plume {c_h[pr, pc].mean()}, background {c_h[br, bc].mean()}, core "
            f"{g_h[cr, cc].mean()}, CO2 share off the plume {stray}"
        )

    # The per-label histograms of CO2(g)'s dynamic thresholds, card vs numpy.
    ga = analysis.co2_gas_analysis
    diff = ga._subtract_background(analysis.img)
    signal = ga._restore_signal(ga._balance_signal(ga._clean_signal(ga._reduce_signal(diff))))
    dynamic = ga.model.models[0].model
    index = dynamic._label_index.on(signal.device)
    counts, edges, sizes = label_histograms(signal, index, H_LAYERS)
    host, host_index = signal.cpu().numpy().astype(np.float64), index.cpu().numpy()
    for k in range(H_LAYERS):
        ref_counts, ref_edges = np.histogram(host[host_index == k], bins=256)
        if not (np.array_equal(counts[k], ref_counts) and np.array_equal(edges[k], ref_edges)):
            raise AssertionError(f"H1: label {k}'s histogram differs from np.histogram")
        t = float(np.clip(StandardOtsu().from_histogram(ref_counts, ref_edges), 0.1, 0.9))
        if t != dynamic._threshold_lower[k]:
            raise AssertionError(f"H1: label {k}'s Otsu threshold {dynamic._threshold_lower[k]} != {t}")

    # The card against the CPU on a 512x1024 crop of the corrected frames.
    crop_paths = {}
    for name, img in (("base", analysis.base), ("probe", analysis.img)):
        crop = img.img[E_CROP].cpu().contiguous()
        dt.OpticalImage(crop, width=crop.shape[1] / W * META["width"], height=crop.shape[0] / OH * META["height"]).save(
            root / f"crop_{name}.npz"
        )
        crop_paths[name] = root / f"crop_{name}.npz"
    crops = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        crop_labels = labels[E_CROP].to(device if where is None else where).contiguous()
        # The per-label thresholds of the labels the crop holds.
        present = [thresholds[k] for k in torch.unique(crop_labels).tolist()]
        crop_config = h_config(root, f"crop_{name}", None, h_co2_sections(root, f"crop_{name}", present))
        crop_analysis = h_layered(dt.FluidFlowerCO2Analysis, crop_labels)(
            crop_paths["base"], crop_config, root / f"results_{name}", device=where
        )
        (cc2, gc2), _, n = counted(
            w2p, lambda: crop_analysis.single_image_analysis(crop_paths["probe"]), 0, f"H1: crop on {name}"
        )
        crops[name] = (crop_analysis, cc2.img.to(torch.bool).cpu(), gc2.img.to(torch.bool).cpu())
    crop_pixels = crops["cpu"][1].numel()
    mismatch = int((crops["card"][1] != crops["cpu"][1]).sum() + (crops["card"][2] != crops["cpu"][2]).sum())
    near = 0
    crop_analysis = crops["card"][0]
    for sub in (crop_analysis.co2_analysis, crop_analysis.co2_gas_analysis):
        d = sub._subtract_background(crop_analysis.img)
        s = sub._restore_signal(sub._balance_signal(sub._clean_signal(sub._reduce_signal(d))))
        lower, _ = sub.model.models[0].model._bounds(s.device)
        near += int(((s - lower).abs() <= 1e-6).sum())
    if not (mismatch < 1e-3 * crop_pixels and near < 1e-3 * crop_pixels and (mismatch == 0 or near > 0)):
        raise AssertionError(f"H1: crop card vs CPU: {mismatch} pixels differ, {near} within 1e-6 of a threshold")

    # Times: a warm-up, then the median of H_TIMED; then H_SPLIT calls split by stage.
    _, warm_s, n = counted(w2p, lambda: analysis.single_image_analysis(paths["probe"]), H_READ_K1, "H1: warm-up")
    launches += n
    torch.cuda.reset_peak_memory_stats(device)
    _, ms, each, counts5 = median_call_ms(
        w2p, lambda: analysis.single_image_analysis(paths["probe"]), H_TIMED, H_READ_K1, "H1: photograph, timed"
    )
    launches += counts5["warp_rows_t"]
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    host_s = []

    def host_timed(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host_s.append(time.perf_counter() - t0)
            return out

        return timed

    hooked = []
    for sub, cleaning in (
        (analysis.co2_analysis, analysis.co2_binary_cleaning),
        (analysis.co2_gas_analysis, analysis.co2_gas_binary_cleaning),
    ):
        hooked.append((sub, "posterior_model", sub.posterior_model))
        sub.posterior_model = host_timed(sub.posterior_model)
        for chain in (sub.model.models[1], cleaning):
            for k in (0, 1):
                hooked.append((chain.models, k, chain.models[k]))
                chain.models[k] = host_timed(chain.models[k])
    split = {"read": [], "co2": [], "co2(g)": [], "host": []}
    reset_counts(w2p)
    for _ in range(H_SPLIT):
        host_s.clear()
        t0 = time.perf_counter()
        analysis.load_and_process_image(paths["probe"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        co2_s = analysis.determine_co2_mask()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        analysis.determine_co2_gas_mask(co2_s)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, value in zip(split, (t1 - t0, t2 - t1, t3 - t2, sum(host_s))):
            split[key].append(value * 1e3)
    split_counts = read_counts(w2p)
    check_counts(split_counts, {"warp_rows_t": H_SPLIT * H_READ_K1}, "H1: split calls")
    launches += split_counts["warp_rows_t"]
    for owner, key, original in hooked:
        if isinstance(owner, list):
            owner[key] = original
        else:
            setattr(owner, key, original)
    split_ms = {k: float(np.median(v)) for k, v in split.items()}
    h1_s = time.perf_counter() - tic
    print(
        f"H1. FluidFlowerCO2Analysis at {H}x{W} -> {OH}x{W} ({H_LAYERS} layers; drift, colour "
        f"checker and curvature sections; co2: per-label static thresholds, co2(g): per-label Otsu "
        f"in [0.1, 0.9]; restoration and prior resize 0.5, Chambolle 0.05 x 30, posterior value "
        f"0.02): {H_READ_K1} K1 launches per reading call (each == plain K1), 0 CO2(g) pixels "
        f"outside CO2, plume/background/core at seeded points, CO2 share off the plume {stray:.2e}; "
        f"{H_LAYERS} per-label histograms == np.histogram, Otsu thresholds "
        f"{np.round(dynamic._threshold_lower, 4).tolist()}; crop card vs CPU: {mismatch} of "
        f"{crop_pixels} pixels differ, {near} within 1e-6 of a threshold; frames made in "
        f"{frames_s:.2f} s"
    )
    print(
        f"H1. on {card}: set-up {learn_s:.2f} s (cleaning filter learnt from 2 baselines), "
        f"{cached_s:.2f} s (read from its cache); {ms:.1f} ms per photograph (median of {H_TIMED} after a "
        f"{warm_s * 1e3:.0f} ms warm-up: {[round(e, 1) for e in each]}; peak {peak:.2f} GiB), split "
        f"(median of {H_SPLIT}, each stage closed by a synchronize): read {split_ms['read']:.1f} ms, co2 "
        f"{split_ms['co2']:.1f} ms, co2(g) {split_ms['co2(g)']:.1f} ms, of which host posterior and "
        f"binary cleaning {split_ms['host']:.1f} ms; phase so far {h1_s:.2f} s"
    )
    result = {"ms": ms, "split_ms": split_ms, "learn_s": learn_s, "cached_s": cached_s, "mismatch": mismatch}
    if profile is not None:
        busy = device_busy_ms(lambda: analysis.single_image_analysis(paths["probe"]), calls=2)
        print(f"H1. device busy {busy:.2f} ms per photograph, idle share {1 - busy / ms:.3f}, peak {peak:.2f} GiB")
        profile_frame(lambda: analysis.single_image_analysis(paths["probe"]), ms, profile, "fluidflower_co2", frames=2)
        result["busy_ms"] = busy

    # H2. The tracer: per-label balancing over the 12 layers.
    t_h2 = time.perf_counter()
    gains = np.random.default_rng(30).uniform(0.6, 1.4, H_LAYERS)
    raw_gain = gains[h_raw_layers(H, W, H_LAYERS)][..., None]
    tracer_paths = []
    for k, width in enumerate((0.38, 0.63)):
        def paint_tracer(img, width=width):
            img = np.roll(img, H_SHIFT, axis=(0, 1))
            region = np.zeros((H, W), dtype=bool)
            region[:, int(0.16 * W) : int((0.16 + width) * W)] = True
            img[region] += 0.25 * np.roll(raw_gain, H_SHIFT, axis=(0, 1))[region]
            return img

        photo, _ = rig_frame(dt, h_photo(scene, 31 + k))
        photo = np.round(np.clip(paint_tracer(photo / 255.0), 0, 1) * 255).astype(np.uint8)
        tracer_paths.append(h_save(dt, root / f"tracer_{k}.npz", photo))
    tracer_config = h_config(
        root, "tracer", voxels, {"tracer": dict(H_TRACER, cleaning_filter=str(root / "cache" / "tracer.npy"))}
    )
    Tracer = h_layered(dt.FluidFlowerTracerAnalysis, labels)
    tracer, tracer_setup_s, n = counted(
        w2p, lambda: Tracer(baselines, tracer_config, root / "tracer_results", device=dev),
        H_SETUP_K1["learn"], "H2: set-up",
    )
    launches += n
    options = {"labels": labels, "balancing_dofs": ["scaling"]}
    _, balance_s, n = counted(
        w2p, lambda: tracer.calibrate_balancing(tracer_paths, options), 2 * H_READ_K1, "H2: calibrate_balancing"
    )
    launches += n
    scalings = np.asarray(tracer.tracer_analysis.balancing._scaling, dtype=float)
    # The float64 numpy reckoning: scipy's dilation, strip means, lstsq.
    ta = tracer.tracer_analysis
    images, _, n = counted(w2p, lambda: [tracer._read(p) for p in tracer_paths], 2 * H_READ_K1, "H2: reckoning reads")
    launches += n
    signals = [ta._reduce_signal(ta._subtract_background(img)).cpu().numpy().astype(np.float64) for img in images]
    t0 = time.perf_counter()
    labels_h = labels.cpu().numpy()
    masks = [labels_h == k for k in range(H_LAYERS)]
    dilated = [ndimage.binary_dilation(m, iterations=3) for m in masks]
    rows, rhs = [], []
    for s in signals:
        for a in range(H_LAYERS):
            for b in range(a + 1, H_LAYERS):
                if not (dilated[a] & masks[b]).any():
                    continue
                mean_a, mean_b = s[dilated[b] & masks[a]].mean(), s[dilated[a] & masks[b]].mean()
                if mean_a > 1e-12 and mean_b > 1e-12:
                    row = np.zeros(H_LAYERS)
                    row[a], row[b] = 1.0, -1.0
                    rows.append(row)
                    rhs.append(np.log(mean_b) - np.log(mean_a))
    rows.append(np.eye(H_LAYERS)[0])
    rhs.append(0.0)
    want = np.exp(np.linalg.lstsq(np.stack(rows), np.asarray(rhs), rcond=None)[0])
    reckon_s = time.perf_counter() - t0
    scaling_err = float(np.abs(scalings / want - 1).max())
    if not scaling_err <= 1e-5:
        raise AssertionError(f"H2: scalings {scalings} vs float64 reckoning {want}: {scaling_err}")
    conc, _, n = counted(w2p, lambda: tracer.single_image_analysis(tracer_paths[1]), H_READ_K1, "H2: warm-up")
    launches += n
    if tuple(conc.img.shape) != (OH, W) or not bool(torch.isfinite(conc.img).all()) or float(conc.img.max()) <= 0:
        raise AssertionError(f"H2: concentration {tuple(conc.img.shape)}, finite and positive expected")
    _, tracer_ms, tracer_each, counts5 = median_call_ms(
        w2p, lambda: tracer.single_image_analysis(tracer_paths[1]), H_TIMED, H_READ_K1, "H2: photograph, timed"
    )
    launches += counts5["warp_rows_t"]
    print(
        f"H2. on {card}: FluidFlowerTracerAnalysis at {H}x{W}, HeterogeneousLinearModel over "
        f"{H_LAYERS} labels: set-up {tracer_setup_s:.2f} s; calibrate_balancing on 2 photographs "
        f"{balance_s:.2f} s ({2 * H_READ_K1} K1 launches), scalings {np.round(scalings, 5).tolist()} "
        f"against the float64 numpy reckoning (scipy dilation, {reckon_s:.2f} s on the host) within "
        f"{scaling_err:.2e} (bound 1e-5), seeded layer gains undone within "
        f"{float(np.abs(scalings * gains / gains[0] - 1).max()):.3f}; {tracer_ms:.1f} ms per "
        f"photograph (median of {H_TIMED}: {[round(e, 1) for e in tracer_each]}); {time.perf_counter() - t_h2:.2f} s"
    )

    # H3. The rig: watershed segmentation of the baseline halved.
    t_h3 = time.perf_counter()
    half = (H // 2, W // 2)
    rig_layers = h_raw_layers(*half, H_LAYERS)
    rig_u8 = h_photo(h_scene(*half, seed=21), 40)
    rig_path = h_save(dt, root / "rig.npz", rig_u8)
    centre_col = half[1] // 2
    marker_rows = [int(np.flatnonzero(rig_layers[:, centre_col] == k).mean()) for k in range(H_LAYERS)]
    rig_config = h_config(
        root,
        "rig",
        None,
        {
            "segmentation": {
                "labels_path": str(root / "cache" / "labels.npy"),
                "marker_points": [[r, centre_col] for r in marker_rows],
            }
        },
    )
    rig, segment_s, _ = counted(w2p, lambda: dt.FluidFlowerRig(rig_path, rig_config, device=dev), 0, "H3: segmentation")
    again, cached_rig_s, _ = counted(w2p, lambda: dt.FluidFlowerRig(rig_path, rig_config, device=dev), 0, "H3: cached")
    agree = float((rig.labels == rig_layers).mean())
    if not (np.array_equal(again.labels, rig.labels) and np.array_equal(np.load(root / "cache" / "labels.npy"), rig.labels)):
        raise AssertionError("H3: the labels read from the cache differ")
    if len(np.unique(rig.labels)) != H_LAYERS:
        raise AssertionError(f"H3: {len(np.unique(rig.labels))} labels, one per marker expected")
    print(
        f"H3. on {card}: FluidFlowerRig, supervised markers (one per layer) and Scharr edges on the "
        f"baseline halved ({half[0]}x{half[1]}; the host median of the default disk, radius 15, "
        f"scales with the pixels): segmentation {segment_s:.2f} s, {agree:.4f} of the pixels on "
        f"their seeded layer; a second construction from the labels cache {cached_rig_s:.2f} s, "
        f"equal labels; {time.perf_counter() - t_h3:.2f} s"
    )
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    if launches != K1_IN_H:
        raise AssertionError(f"H: {launches} K1 launches, want {K1_IN_H}")
    print(f"H. phase {time.perf_counter() - tic:.2f} s, {launches} K1 launches")
    return {"launches": launches, "ms": ms, "tracer_ms": tracer_ms, "segment_s": segment_s, **result}


# ---------------------------------------------------------------- phase I
I_SHIFTS = ((2, 3), (3, 1), (1, -2), (4, 2))  # photographs 1-4: their drift (rows, cols)
I_PLUME = ((1100, 1300), (320, 640))  # raw frame: centre (row, col), radii
I_PLUME_COLOUR = (-0.25, -0.1, 0.2)
I_START = datetime(2024, 3, 1, 9)
I_DEPTHS = 20
I_PATH_SEGMENTS = 3
I_RANGE = [[180.0, 260.0], [0.1, "none"], ["none", "none"]]
#: The image porosity from the baseline's colours, as config/image_porosity.py
#: reads it; a low threshold keeps enough of the noise frame in the boolean
#: porosity that masks the illumination correction's samples.
I_POROSITY = {"mode": "from_image", "tol": 0.2, "num_clusters": 5, "sample_width": 50}
# K1 launches of Rig.read_image: [Resize, drift, curvature] fuse into one
# pair, the colour checker's crop is a second (as phase 14's reading path).
I_READ_K1 = 2 + 2
# setup_rig: the curvature correction applied to the raw baseline (a pair,
# and the pull-back grid its first call builds: 8), the shape-corrected
# baseline (a pair), the labels through the curvature correction (a pair),
# the colour correction's set-up crop (a pair) and the baseline through it
# (a pair).
I_SETUP_K1 = 2 + 8 + 2 + 2 + 2 + 2
# Phase 14's shape corrections on the baseline (a pair); I2: per photograph
# the set-up rig's read, the loaded rig's read, the emulated chain with the
# rig's illumination and phase 14's own chain (4 x 4 reads; the loaded
# curvature correction builds its pull-back grid in its first read: 8
# more), a warm-up and 5 timed reads; I3: the plume's two indicators
# through the curvature correction (a pair each).
I_READS = 4 * 4 + 1 + 5
K1_IN_I = I_SETUP_K1 + 2 + I_READS * I_READ_K1 + H_GRID_K1 + 2 * 2


def toml_text(tables: dict) -> str:
    """A TOML document of nested tables whose leaves are numbers, strings,
    paths, booleans and lists of them (``"none"`` stands for a missing
    bound, as the config layer reads it)."""

    def value(v) -> str:
        if isinstance(v, (bool, np.bool_)):
            return "true" if v else "false"
        if isinstance(v, (int, np.integer)):
            return str(int(v))
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        if isinstance(v, (str, Path)):
            return json.dumps(str(v))
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(value(x) for x in v) + "]"
        raise TypeError(f"no TOML value for {v!r}")

    lines = []

    def table(name: str, body: dict) -> None:
        leaves = {k: v for k, v in body.items() if not isinstance(v, dict)}
        if leaves:
            lines.append(f"[{name}]")
            lines.extend(f"{k} = {value(v)}" for k, v in leaves.items())
            lines.append("")
        for k, v in body.items():
            if isinstance(v, dict):
                table(f"{name}.{k}", v)

    for name, body in tables.items():
        table(name, body)
    return "\n".join(lines)


def i_assets(dt, frame: np.ndarray, root: Path) -> tuple:
    """Phase I's files: the baseline (the rig frame) and 4 drifted
    photographs with a painted plume as npz, a sketch of 12 seeded layers in
    colours 1/16 apart, ~20 seeded depth measurements, the imaging,
    injection and pressure/temperature protocols.  Returns (photograph
    paths, plume indicator of the raw frame)."""
    (root / "images").mkdir(parents=True)
    h_save(dt, root / "images" / "img_00000.npz", frame)
    plume = h_ellipse((H, W), I_PLUME)
    photos = []
    for k, shift in enumerate(I_SHIFTS, start=1):
        img = frame.astype(np.float64) / 255.0
        img[plume] += I_PLUME_COLOUR
        img = np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        photos.append(h_save(dt, root / "images" / f"img_{k:05d}.npz", np.roll(img, shift, axis=(0, 1))))
    layers = h_raw_layers(H, W, H_LAYERS)
    palette = np.array([[(k % 4) / 4 + 0.125, (k // 4) / 3 + 0.1, 0.5] for k in range(H_LAYERS)])
    dt.OpticalImage(torch.from_numpy(palette[layers].astype(np.float32)), **META).save(root / "sketch.npz")
    rng = np.random.default_rng(41)
    x, y = rng.uniform(0, META["width"], I_DEPTHS), rng.uniform(0, META["height"], I_DEPTHS)
    depth = 0.019 + 0.003 * np.sin(2.0 * x) * np.cos(3.0 * y)
    (root / "depth.csv").write_text(
        "x,y,mean\n" + "".join(f"{a!r},{b!r},{c!r}\n" for a, b, c in zip(x.tolist(), y.tolist(), depth.tolist()))
    )
    (root / "imaging.csv").write_text(
        "path,image_id,datetime\n"
        + "".join(
            f"img_{k:05d}.npz,{k},{(I_START + timedelta(hours=k)).isoformat(sep=' ')}\n"
            for k in range(len(I_SHIFTS) + 1)
        )
    )
    (root / "injection.csv").write_text(
        "id,location_x,location_y,start,end,rate_kg/s\n"
        f"1,1.4,0.3,{(I_START + timedelta(minutes=30)).isoformat(sep=' ')},"
        f"{(I_START + timedelta(hours=5)).isoformat(sep=' ')},1e-6\n"
    )
    (root / "pressure_temperature.csv").write_text(
        "datetime,pressure_bar,temperature_celsius\n"
        f"{I_START.isoformat(sep=' ')},1.013,20.0\n{(I_START + timedelta(hours=6)).isoformat(sep=' ')},1.02,21.5\n"
    )
    return photos, plume


def i_config(root: Path) -> Path:
    """The rig's TOML config over phase I's files (the corrections of phase
    14: drift and colour on the checker, CURVATURE, the illumination of
    ILLUMINATION; the image porosity from the baseline; one channel, one
    range and one path embedding)."""
    path = root / "config.toml"
    path.write_text(toml_text(i_tables(root)))
    return path


def i_tables(root: Path) -> dict:
    """Phase I's config as nested tables."""
    return {
        "data": {"folder": root / "images", "baseline": "img_00000.npz", "results": root / "results"},
        "rig": {"width": META["width"], "height": META["height"], "dim": 2, "resolution": [H, W]},
        "depth": {"measurements": root / "depth.csv"},
        "labeling": {"colored_image": root / "sketch.npz"},
        "protocols": {
            "imaging": root / "imaging.csv",
            "injection": root / "injection.csv",
            "pressure_temperature": root / "pressure_temperature.csv",
        },
        "image_porosity": I_POROSITY,
        "corrections": {
            "drift": {"colorchecker": "upper_right"},
            "color": {"colorchecker": "upper_right"},
            "curvature": {"config": CURVATURE},
            "illumination": dict(
                ILLUMINATION, colorspace="hsl-scalar", interpolation="illumination", outliers=0.1
            ),
        },
        "color": {
            "channel": {"saturation": {"color_space": "HSV", "channel": "s"}},
            "range": {"blue": {"color_space": "HSV", "range": I_RANGE}},
            "path": {
                "co2": {
                    "mode": "relative",
                    "basis": "labels",
                    "num_segments": I_PATH_SEGMENTS,
                    "calibration_folder": root / "calibration" / "co2",
                }
            },
        },
    }


def i_color_paths(dt, labels: torch.Tensor, folder: Path) -> None:
    """Per label a seeded relative colour path towards the plume's colour
    change, written with the port's ``LabelColorPathMap.save``."""
    rng = np.random.default_rng(42)
    target = np.asarray(I_PLUME_COLOUR)
    paths = {}
    for label in torch.unique(labels).tolist():
        steps = [np.zeros(3)]
        for s in range(1, I_PATH_SEGMENTS + 1):
            steps.append(target * s / I_PATH_SEGMENTS + rng.normal(0.0, 0.01, 3))
        paths[int(label)] = dt.ColorPath(relative_colors=steps, base_color=np.zeros(3))
    dt.LabelColorPathMap(paths).save(folder)


def i_comparison_configs(root: Path, config) -> Path:
    """Phase G's comparison as TOML: per run a FluidFlowerConfig naming its
    folder (mass maps, imaging protocol), and a MultiFluidFlowerConfig over
    them with the [wasserstein] section of phase G's config object."""
    for run in G_RUNS:
        folder = root / run
        (folder / "config.toml").write_text(
            toml_text(
                {
                    "data": {"folder": folder / "mass" / "npz", "baseline": "mass_00000.npz", "results": folder},
                    "protocols": {"imaging": folder / "imaging.csv"},
                    "color": {"path": {"co2": {"mode": "relative"}}},
                    "analysis": {"mass": {"color": "co2", "folder": folder}},
                }
            )
        )
    wconfig = config.wasserstein
    multi = root / "multi.toml"
    multi.write_text(
        toml_text(
            {
                "data": {"results": root / "multi_results"},
                "run": {run: {"config": f"{run}/config.toml"} for run in G_RUNS},
                "wasserstein": {
                    "runs": list(wconfig.runs),
                    "times": [t for t, _ in wconfig.times],
                    "tol": wconfig.times[0][1],
                    "relative_tol": wconfig.relative_tol,
                },
            }
        )
    )
    return multi


def i_crop(image, where):
    """``image``'s E_CROP on ``where`` as an image of its own."""
    sub = image.subregion(E_CROP)
    return type(image)(sub.img.to(where).contiguous(), **sub.metadata())


def phase_rig_config(dt, w2p, lanes, device, card: str, profile, keep: bool = False) -> dict:
    """Phase I: the rig workflow from its TOML config through the public
    functions (set-up, load, reading, embeddings, the config-driven
    comparison).  With ``keep`` its folder stays and the result hands it on
    (``root``, ``photos``, the loaded rig, phase G's comparison config)."""
    import importlib
    import shutil
    import tempfile
    import warnings

    from darsia_tpu_torch.experiment import ProtocolledExperiment
    from darsia_tpu_torch.presets.workflows import setup as rig_setup
    from darsia_tpu_torch.presets.workflows.comparison import comparison_wasserstein
    from darsia_tpu_torch.presets.workflows.config import FluidFlowerConfig

    tic = time.perf_counter()
    dev = None if device.type == "cuda" else device
    emulated = lanes["rig"]
    root = Path(tempfile.mkdtemp(prefix="phase_i_"))
    photos, plume = i_assets(dt, emulated["frame"], root)
    config_path = i_config(root)
    files_s = time.perf_counter() - tic

    # I1. The set-up steps; the rig's "inactive" and porosity-fallback
    # warnings are errors here.
    launches = 0
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*inactive.*")
        warnings.filterwarnings("error", message="Porosity analysis failed.*")
        warnings.filterwarnings("ignore", message="Section .* not found")
        _, depth_s, _ = counted(w2p, lambda: rig_setup.setup_depth_map(config_path, device=dev), 0, "I1: depth")
        labels_img, labels_s, _ = counted(
            w2p, lambda: rig_setup.segment_colored_image(config_path, device=dev), 0, "I1: labels"
        )
        torch.cuda.reset_peak_memory_stats(device)
        rig, setup_s, n = counted(
            w2p, lambda: rig_setup.setup_rig(dt.Rig, config_path, device=dev), I_SETUP_K1, "I1: setup_rig"
        )
        launches += n
        setup_peak = torch.cuda.max_memory_allocated(device) / 2**30
        config = FluidFlowerConfig(config_path)
    n_labels = len(torch.unique(labels_img.img))
    if n_labels != H_LAYERS:
        raise AssertionError(f"I1: {n_labels} labels from the sketch, want {H_LAYERS}")
    porosity = rig.image_porosity.img
    if not (
        porosity.dtype == torch.float32
        and tuple(porosity.shape) == (OH, W)
        and bool(torch.isfinite(porosity).all())
        and float(porosity.min()) >= 0.0
        and float(porosity.max()) <= 1.0
        and float(porosity.mean()) < 1.0
    ):
        raise AssertionError(f"I1: image porosity {porosity.dtype} {tuple(porosity.shape)}, mean {float(porosity.mean())}")
    boolean_share = float(rig.boolean_porosity.img.float().mean())
    if [type(c).__name__ for c in rig.corrections] != [
        "Resize", "DriftCorrection", "CurvatureCorrection", "IlluminationCorrection", "ColorCorrection"
    ]:
        raise AssertionError(f"I1: corrections {[type(c).__name__ for c in rig.corrections]}")
    # The shape corrections agree with phase 14's: the same checker ROI, the
    # same shape-corrected baseline, bitwise.
    frame = torch.from_numpy(emulated["frame"]).to(device)
    shape_emulated, _, n = counted(
        w2p, lambda: dt.OpticalImage(frame, transformations=emulated["shape"], **META), 2, "I1: phase 14's shape"
    )
    launches += n
    if rig.drift_correction.roi != emulated["drift"].roi or not torch.equal(
        rig.shape_corrected_baseline.img, shape_emulated.img
    ):
        raise AssertionError("I1: the rig's shape corrections differ from phase 14's")
    print(
        f"I1. on {card}: setup_depth_map {depth_s:.2f} s ({I_DEPTHS} measurements onto {H}x{W}), "
        f"segment_colored_image {labels_s:.2f} s ({n_labels} labels), setup_rig {setup_s:.2f} s "
        f"({I_SETUP_K1} K1 launches, peak {setup_peak:.2f} GiB; no checker or porosity fallback); "
        f"image porosity mean {float(porosity.mean()):.4f} (min {float(porosity.min()):.3f}, max "
        f"{float(porosity.max()):.3f}), boolean share {boolean_share:.4f}; drift ROI and "
        f"shape-corrected baseline == phase 14's, bitwise; files made in {files_s:.2f} s"
    )

    # I2. Rig.load, then every photograph through both rigs and the
    # emulation.
    t_i2 = time.perf_counter()
    loaded, load_s, n = counted(w2p, lambda: dt.Rig.load(config.rig.path, device=dev), 0, "I2: Rig.load")
    loaded.load_experiment(ProtocolledExperiment.init_from_config(config))
    colour = emulated["colour"][1]
    with_rig_illumination = emulated["shape"] + [rig.illumination_correction, colour]
    phase14 = emulated["shape"] + emulated["colour"]
    read_diff = []
    for k, path in enumerate(photos):
        a, _, n1 = counted(w2p, lambda: rig.read_image(path), I_READ_K1, "I2: set-up rig read")
        b, _, n2 = counted(
            w2p, lambda: loaded.read_image(path), I_READ_K1 + (H_GRID_K1 if k == 0 else 0), "I2: loaded rig read"
        )
        raw = dt.imread(path, device=device).img
        c, _, n3 = counted(
            w2p, lambda: dt.OpticalImage(raw, transformations=with_rig_illumination, **META), I_READ_K1, "I2: emulated"
        )
        d, _, n4 = counted(
            w2p, lambda: dt.OpticalImage(raw, transformations=phase14, **META), I_READ_K1, "I2: phase 14's chain"
        )
        launches += n1 + n2 + n3 + n4
        if tuple(a.img.shape) != (OH, W, 3) or not bool(torch.isfinite(a.img).all()):
            raise AssertionError(f"I2: read {tuple(a.img.shape)}")
        if not (torch.equal(a.img, b.img) and torch.equal(a.img, c.img)):
            raise AssertionError(f"I2: {path.name}: the loaded rig's or the emulated read differs from the rig's")
        read_diff.append(float((a.img - d.img).abs().mean()))
    _, warm_s, n = counted(w2p, lambda: loaded.read_image(photos[0]), I_READ_K1, "I2: warm-up")
    launches += n
    torch.cuda.reset_peak_memory_stats(device)
    image, ms, each, counts5 = median_call_ms(w2p, lambda: loaded.read_image(photos[0]), 5, I_READ_K1, "I2: timed")
    launches += counts5["warp_rows_t"]
    read_peak = torch.cuda.max_memory_allocated(device) / 2**30
    result = {"ms": ms, "setup_s": setup_s, "load_s": load_s, "read_diff": read_diff}
    busy_text = ""
    if profile is not None:
        busy = device_busy_ms(lambda: loaded.read_image(photos[0]))
        result["busy_ms"] = busy
        busy_text = f", device busy {busy:.3f} ms, idle share {1 - busy / ms:.3f}"
        profile_frame(lambda: loaded.read_image(photos[0]), ms, profile, "rig_config_read", frames=2)
    print(
        f"I2. on {card}: Rig.load {load_s:.2f} s; Rig.read_image {ms:.1f} ms per photograph (median "
        f"of 5 after a {warm_s * 1e3:.0f} ms warm-up: {[round(e, 1) for e in each]}; peak "
        f"{read_peak:.2f} GiB{busy_text}), {I_READ_K1} K1 launches per read; each of "
        f"{len(photos)} photographs: the loaded rig's read and phase 14's chain with the rig's "
        f"illumination correction == the rig's read, bitwise; phase 14's own chain (its "
        f"illumination samples unmasked; the rig masks them with the boolean image porosity) "
        f"mean|diff| {[f'{v:.2e}' for v in read_diff]}; {time.perf_counter() - t_i2:.2f} s"
    )

    # I3. The three embeddings on the read photograph.
    t_i3 = time.perf_counter()
    i_color_paths(dt, loaded.labels.img, root / "calibration" / "co2" / "color_paths" / "from_labels")
    runtime = dt.ColorEmbeddingRuntime(rig=loaded, device=dev)
    embeddings = {key: config.color[key] for key in ("saturation", "blue", "co2")}
    outputs, times = {}, {}
    for key, embedding in embeddings.items():
        counted(w2p, lambda: embedding.to_scalar_image(image, runtime), 0, f"I3: {key}")
        outputs[key], times[key], _, _ = median_call_ms(
            w2p, lambda: embedding.to_scalar_image(image, runtime), 5, 0, f"I3: {key}, timed"
        )
        out = outputs[key].img
        if tuple(out.shape) != (OH, W) or out.device.type != device.type or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"I3: {key} {tuple(out.shape)} on {out.device}")
    plume_c, _, n1 = counted(
        w2p, lambda: corrected_indicator(dt, loaded, h_ellipse((H, W), I_PLUME, 0.8), device), 2, "I3: plume"
    )
    near_plume, _, n2 = counted(
        w2p, lambda: corrected_indicator(dt, loaded, h_ellipse((H, W), I_PLUME, 1.2), device), 2, "I3: near plume"
    )
    launches += n1 + n2
    far = ~near_plume
    far[:32], far[-32:], far[:, :32], far[:, -32:] = False, False, False, False
    co2 = outputs["co2"].img
    inside, outside = float(co2[plume_c].mean()), float(co2[far].mean())
    if not inside > outside + 0.5:
        raise AssertionError(f"I3: the path embedding's mean {inside} on the plume, {outside} off it")
    # Card against CPU on a crop: the rig's fields and the photograph cropped.
    crop_out = {}
    for name, where in (("card", device), ("cpu", torch.device("cpu"))):
        labels_w = i_crop(loaded.labels, where)
        crop_rig = SimpleNamespace(baseline=i_crop(loaded.baseline, where), labels=labels_w, facies=labels_w)
        crop_runtime = dt.ColorEmbeddingRuntime(rig=crop_rig, device=where)
        photo = i_crop(image, where)
        crop_out[name] = {key: e.to_scalar_image(photo, crop_runtime).img.cpu() for key, e in embeddings.items()}
    card_crop, cpu_crop = crop_out["card"], crop_out["cpu"]
    sat_err = float((card_crop["saturation"] - cpu_crop["saturation"]).abs().max())
    differ = card_crop["blue"] != cpu_crop["blue"]
    photo = i_crop(image, device)
    hsv, _ = dt.normalized_trichromatic(photo, "HSV", dt.ColorMode.ABSOLUTE)
    hsv = hsv.cpu()
    near_edge = torch.zeros(differ.shape, dtype=torch.bool)
    for channel, bounds in enumerate(I_RANGE):
        for bound in bounds:
            if bound != "none":
                near_edge |= (hsv[..., channel] - bound).abs() <= 1e-6 * max(1.0, abs(bound))
    n_differ, n_edge = int(differ.sum()), int(near_edge.sum())
    path_model = crop_runtime.cache["co2"].model
    def unit(x):  # the embeddings' scaling: by 255 where the data exceed 1.5
        x = x.to(torch.float32)
        return x / 255.0 if float(x.max()) > 1.5 else x

    relative = unit(photo.img) - unit(i_crop(loaded.baseline, device).img)
    crop_labels = i_crop(loaded.labels, device).img
    ties = torch.zeros(crop_labels.shape, dtype=torch.bool, device=device)
    for label, model in path_model.models.items():
        params, l1 = model.color_path.fit_terms(relative, model.color_mode, "equidistant")
        near = l1 <= l1.min(dim=-1, keepdim=True).values + 1e-6
        spread = torch.where(near, params, -torch.inf).amax(-1) - torch.where(near, params, torch.inf).amin(-1)
        ties |= (crop_labels == label) & (spread > 1e-6)
    ties = ties.cpu()
    path_err = float((card_crop["co2"] - cpu_crop["co2"])[~ties].abs().max())
    pixels = differ.numel()
    if not (
        sat_err <= 1e-6
        and bool(near_edge[differ].all())
        and path_err <= 1e-5
        and int(ties.sum()) < 1e-3 * pixels
    ):
        raise AssertionError(
            f"I3: crop card vs CPU: saturation {sat_err}, range masks differ at {n_differ} pixels "
            f"({int((differ & ~near_edge).sum())} away from an edge), path {path_err} off "
            f"{int(ties.sum())} ties"
        )
    print(
        f"I3. on {card}: embeddings on the read photograph, ms per call (median of 5): "
        + ", ".join(f"{k} {times[k]:.2f}" for k in embeddings)
        + f"; the path embedding {inside:.3f} on the plume, {outside:.3f} off it; 512x1024 "
        f"crop, card vs CPU: "
        f"saturation within {sat_err:.1e}, range masks differ at {n_differ} of {pixels} pixels "
        f"({n_edge} within 1e-6 of a bound), path within {path_err:.1e} off {int(ties.sum())} fit "
        f"ties; {time.perf_counter() - t_i3:.2f} s"
    )
    result["embedding_ms"] = times

    # I4. The config-driven comparison on phase G's maps.
    t_i4 = time.perf_counter()
    cw = importlib.import_module("darsia_tpu_torch.presets.workflows.comparison.comparison_wasserstein")
    compare_root = root / "comparison"
    reference = comparison_maps(dt, compare_root, G_N)
    multi = i_comparison_configs(compare_root, reference)
    cw._compute(None, reference, skip_existing=False, device=dev)
    cw._assemble(reference)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Section .* not found")
        (results, compute_s, _) = counted(
            w2p, lambda: comparison_wasserstein(dt.Rig, multi, compute=True, device=dev), 0, "I4: compute"
        )
        rows = comparison_wasserstein(dt.Rig, multi, assemble=True)
    ours = compare_root / "multi_results" / "wasserstein"
    want_files = sorted(reference.wasserstein.results.glob("wasserstein_*.json"))
    got_files = sorted(ours.glob("wasserstein_*.json"))
    same = [p.name for p in got_files] == [p.name for p in want_files] and all(
        json.loads(a.read_text()) == json.loads(b.read_text()) for a, b in zip(got_files, want_files)
    )
    csv_same = (ours / "wasserstein_distances.csv").read_bytes() == (
        reference.wasserstein.results / "wasserstein_distances.csv"
    ).read_bytes()
    if not (same and csv_same and len(results) == len(rows) == 12):
        raise AssertionError(f"I4: {len(results)} results, JSON equal {same}, CSV equal {csv_same}")
    print(
        f"I4. on {card}: comparison_wasserstein(Rig, multi.toml, compute=True) {compute_s:.2f} s "
        f"(4 runs x 2 times at {G_N}x{G_N}, 12 pairs), then assemble=True: 12 JSON files and the "
        f"CSV equal to _compute/_assemble on phase G's config object; {time.perf_counter() - t_i4:.2f} s"
    )
    if keep:
        result["handoff"] = {"root": root, "photos": photos, "rig": loaded, "multi": multi}
    else:
        shutil.rmtree(root, ignore_errors=True)
    if launches != K1_IN_I:
        raise AssertionError(f"I: {launches} K1 launches, want {K1_IN_I}")
    result["phase_s"] = time.perf_counter() - tic
    print(f"I. phase {result['phase_s']:.2f} s, {launches} K1 launches")
    return {"launches": launches, **result}


# ---------------------------------------------------------------- phase J
J_SHIFTS = ((5, 6), (6, -5), (7, 3), (8, -7))  # photographs 5-8: their drift (rows, cols)
J_GROWTH = (1.1, 1.2, 1.3, 1.4)  # photographs 5-8: the plume's radii over I_PLUME's
J_PHOTOS = len(I_SHIFTS) + len(J_SHIFTS)
J_REPS = 1  # timed loops per mode (more than one: interleaved in turns)
J_INJECTION = (1.3, 0.5)  # (x, y): inside the "left" ROI
J_RATE = 1e-6  # kg/s, from I_START + 30 min to I_START + 10 h
J_ROIS = {"left": [[0.0, 0.0], [1.4, 1.5]], "right": [[1.4, 0.0], [2.8, 1.5]]}
J_STEPS = ("read", "chain", "products", "export", "integrals", "csv")
# K1 launches: I_READ_K1 per Rig.read_image, and H_GRID_K1 in the first read
# through a freshly loaded rig (its curvature grid).  J1: the CLI's mass,
# volume and cropping steps each read every photograph through one loaded
# rig.  J2: a context of its own, 2 x J_REPS timed loops and one
# instrumented loop over every photograph, then every photograph read once
# more for the direct check.  J3 takes the plain K1; J4 and J5 launch none
# that is counted.
J1_K1 = 3 * J_PHOTOS * I_READ_K1 + H_GRID_K1
J_SPLIT = 2  # photographs of J2's split loop (all 8 is depth cut for the script's time: PERF.md section 4)
J2_K1 = 2 * J_REPS * J_PHOTOS * I_READ_K1 + J_SPLIT * I_READ_K1 + H_GRID_K1 + J_PHOTOS * I_READ_K1
K1_IN_J = J1_K1 + J2_K1


def j_assets(dt, frame: np.ndarray, root: Path, photos: list) -> list:
    """Phase J's photographs in a folder of their own: phase I's 4 and 4
    more, drifted by 5-8 px with the plume grown; the imaging protocol of
    the baseline and the 8, and an injection protocol.  Returns the 8 paths."""
    folder = root / "photos"
    folder.mkdir()
    out = [p.rename(folder / p.name) for p in photos]
    for k, (shift, growth) in enumerate(zip(J_SHIFTS, J_GROWTH), start=len(I_SHIFTS) + 1):
        img = frame.astype(np.float64) / 255.0
        img[h_ellipse((H, W), I_PLUME, growth)] += I_PLUME_COLOUR
        img = np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        out.append(h_save(dt, folder / f"img_{k:05d}.npz", np.roll(img, shift, axis=(0, 1))))
    protocols = root / "analysis"
    protocols.mkdir()
    (protocols / "imaging.csv").write_text(
        "path,image_id,datetime\n"
        + "".join(
            f"img_{k:05d}.npz,{k},{(I_START + timedelta(hours=k)).isoformat(sep=' ')}\n"
            for k in range(J_PHOTOS + 1)
        )
    )
    (protocols / "injection.csv").write_text(
        "id,location_x,location_y,start,end,rate_kg/s\n"
        f"1,{J_INJECTION[0]},{J_INJECTION[1]},{(I_START + timedelta(minutes=30)).isoformat(sep=' ')},"
        f"{(I_START + timedelta(hours=10)).isoformat(sep=' ')},{J_RATE!r}\n"
    )
    return out


def j_tables(root: Path, protocols: Path) -> dict:
    """Phase I's config over phase J's photographs, its protocols in
    ``protocols``, two ROIs and the analysis sections (npz only: the card's
    machine has no JPEG writer)."""
    tables = i_tables(root)
    tables["data"] = {
        "folder": root / "photos",
        "baseline": root / "images" / "img_00000.npz",
        "results": root / "results",
    }
    tables["protocols"] = dict(
        tables["protocols"], imaging=protocols / "imaging.csv", injection=protocols / "injection.csv"
    )
    tables["roi"] = {name: {"name": name, "corner_1": a, "corner_2": b} for name, (a, b) in J_ROIS.items()}
    tables["analysis"] = {
        "formats": ["npz"],
        "mass": {"color": "co2", "roi": list(J_ROIS), "export": ["mass", "rescaled_mass"]},
        "volume": {"roi": ["left"]},
        "cropping": {"formats": ["npz"]},
    }
    return tables


def j_chain(dt, rig, folder: Path) -> None:
    """A colour-to-mass chain over the rig's labels, built as phase E builds
    its chain (phase E's signal functions and flash) with each label's
    colour path towards the plume's colour change (as phase I's path
    embedding), saved to ``folder``."""
    labels = sorted(int(v) for v in torch.unique(rig.labels.img).tolist())
    _, functions = layer_models(dt, len(labels))
    rng = np.random.default_rng(42)
    target = np.asarray(I_PLUME_COLOUR)
    interps = {}
    for label in labels:
        steps = [np.zeros(3)] + [
            target * s / I_PATH_SEGMENTS + rng.normal(0.0, 0.01, 3) for s in range(1, I_PATH_SEGMENTS + 1)
        ]
        path = dt.ColorPath(relative_colors=steps, base_color=np.zeros(3), name=f"layer {label}")
        interps[label] = dt.ColorPathInterpolation(path, dt.ColorMode.RELATIVE, values=path.equidistant_distances)
    chain = dt.HeterogeneousColorToMassAnalysis(
        baseline=rig.baseline,
        labels=rig.labels,
        color_mode=dt.ColorMode.RELATIVE,
        color_path_interpretation=interps,
        signal_functions={label: functions[k] for k, label in enumerate(labels)},
        flash=dt.SimpleFlash(*E_FLASH),
        co2_mass_analysis=dt.CO2MassAnalysis(rig.baseline, 1.01, 23.0),
        geometry=rig.geometry,
    )
    chain.save(folder)


def j_csv(path: Path) -> list:
    """The rows of a CSV as dicts of strings."""
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def j_fields(folder: Path) -> dict:
    """Every exported npz field under ``folder`` (mode/npz/stem.npz): its
    array by (mode, stem)."""
    return {
        (p.parent.parent.name, p.stem): np.load(p, allow_pickle=True)["array"]
        for p in sorted(folder.glob("*/npz/*.npz"))
    }


class JTimed:
    """``inner`` with its call replaced by ``call`` (other attributes pass)."""

    def __init__(self, inner, call):
        self._inner, self._call = inner, call

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)


def phase_analysis_run(dt, w2p, lanes, handoff: dict, device, card: str, profile, keep: bool = False) -> dict:
    """Phase J: the config-driven analysis run over phase I's rig through its
    CLIs, the prefetching loader against the sequential loop, the plain K1,
    the set-up and comparison CLIs.  With ``keep`` its folder stays and the
    result hands it on (``root``, ``photos``: the 8 photographs)."""
    import logging
    import shutil
    import warnings

    from darsia_tpu_torch.presets.workflows import (
        user_interface_analysis,
        user_interface_comparison,
        user_interface_setup,
    )
    from darsia_tpu_torch.presets.workflows.analysis import analysis_context, analysis_mass
    from darsia_tpu_torch.presets.workflows.analysis.image_export_formats import ImageExportFormats
    from darsia_tpu_torch.presets.workflows.config import FluidFlowerConfig
    from darsia_tpu_torch.utils.csv_table import CsvTable
    from darsia_tpu_torch.utils.prefetch import default_workers

    warnings.filterwarnings("ignore", message="Section .* not found")
    tic = time.perf_counter()
    dev = None if device.type == "cuda" else device
    root = handoff["root"]
    photos = j_assets(dt, lanes["rig"]["frame"], root, handoff["photos"])
    config_path = root / "analysis.toml"
    config_path.write_text(toml_text(j_tables(root, root / "analysis")))
    config = FluidFlowerConfig(config_path)
    j_chain(dt, handoff["rig"], config.color["co2"].color_to_mass_folder)
    files_s = time.perf_counter() - tic
    stems = [p.stem for p in photos]

    # Every read of the phase is recorded: a frame the loader would skip
    # fails the phase.
    failures = []
    read_image = dt.Rig.read_image

    def recording(self, path):
        try:
            return read_image(self, path)
        except Exception as err:
            failures.append(f"{Path(path).name}: {err!r}")
            raise

    dt.Rig.read_image = recording
    try:
        # J1. The analysis CLI: mass, volume and cropping over every photograph.
        argv = ["--config", str(config_path), "--mass", "--volume", "--cropping", "--all"]
        _, j1_s, launches = counted(
            w2p, lambda: user_interface_analysis.main(argv, device=dev), J1_K1, "J1: the analysis CLI"
        )
        logging.getLogger().setLevel(logging.WARNING)  # main() set INFO for the CLI
        results = root / "results"
        mass_rows = j_csv(results / "mass" / "mass_analysis_results.csv")
        volume_rows = j_csv(results / "volume" / "volume_analysis_results.csv")
        if failures or len(mass_rows) != J_PHOTOS or len(volume_rows) != J_PHOTOS:
            raise AssertionError(f"J1: {len(mass_rows)} mass rows, {len(volume_rows)} volume rows; {failures}")
        if [r["image_stem"] for r in mass_rows] != stems or [r["image_stem"] for r in volume_rows] != stems:
            raise AssertionError(f"J1: rows {[r['image_stem'] for r in mass_rows]}, want {stems}")
        late = mass_rows[-1]
        exact = J_RATE * (timedelta(hours=J_PHOTOS) - timedelta(minutes=30)).total_seconds()
        rescaled_rel = abs(float(late["detected_mass_total_rescaled"]) / float(late["exact_mass_total"]) - 1)
        if not (rescaled_rel <= 1e-3 and abs(float(late["exact_mass_total"]) / exact - 1) <= 1e-9):
            raise AssertionError(f"J1: late row {late}, exact {exact}")
        for row in mass_rows:
            total = float(row["detected_mass_total"])
            for name in J_ROIS:
                if not float(row[f"{name}_detected_mass"]) <= total * (1 + 1e-6) + 1e-12:
                    raise AssertionError(f"J1: {row['image_stem']}: {name} {row[f'{name}_detected_mass']} > {total}")
        fields = sorted((results / "mass").glob("*/npz/*.npz"))
        cropped = sorted((results / "cropped").glob("*.npz"))
        if len(fields) != 2 * J_PHOTOS or [p.stem for p in cropped] != stems:
            raise AssertionError(f"J1: {len(fields)} mass fields, {len(cropped)} cropped photographs")
        print(
            f"J1. on {card}: user_interface_analysis.main(--mass --volume --cropping --all) over "
            f"{J_PHOTOS} photographs {j1_s:.2f} s ({J1_K1} K1 launches, none skipped): 8 rows in each "
            f"CSV, late rescaled mass {float(late['detected_mass_total_rescaled']):.6g} kg against "
            f"{float(late['exact_mass_total']):.6g} injected (rel {rescaled_rel:.2e}), ROIs within the "
            f"total, {len(fields)} mass fields and {len(cropped)} cropped photographs (npz); files made "
            f"in {files_s:.2f} s"
        )

        # J2. The mass loop prefetched (default depth) and sequential, in turns.
        t_j2 = time.perf_counter()
        ctx, context_s, _ = counted(
            w2p,
            lambda: analysis_context.prepare_analysis_context(
                cls=dt.Rig, path=config_path, all=True, require_color_to_mass=True, device=dev
            ),
            0,
            "J2: the context",
        )
        prefetched_iter = analysis_context.iter_prefetched_images

        def sequential_iter(ctx_, image_paths=None, depth=None):
            return prefetched_iter(ctx_, image_paths, depth=0)

        def loop(mode: str, folder: Path, events=None):
            ctx.config.analysis.mass.folder = folder
            if mode == "sequential":
                analysis_context.iter_prefetched_images = sequential_iter
            try:
                return analysis_mass.analysis_mass_from_context(
                    ctx, progress_callback=None if events is None else events.append
                )
            finally:
                analysis_context.iter_prefetched_images = prefetched_iter

        modes = (["prefetched", "sequential", "sequential", "prefetched"] * J_REPS)[: 2 * J_REPS]
        seconds = {"prefetched": [], "sequential": []}
        csv_bytes, reference = set(), None
        torch.cuda.reset_peak_memory_stats(device)
        for k, mode in enumerate(modes):
            folder = root / "j2" / f"{k}_{mode}"
            events = []
            want = J_PHOTOS * I_READ_K1 + (H_GRID_K1 if k == 0 else 0)
            _, s, n = counted(w2p, lambda: loop(mode, folder, events), want, f"J2: {mode} loop {k}")
            launches += n
            seconds[mode].append(s)
            if [e["event"] for e in events] != ["step_start"] + ["image_progress"] * J_PHOTOS + ["step_complete"]:
                raise AssertionError(f"J2: {mode} loop {k}: events {[e['event'] for e in events]}")
            csv_bytes.add((folder / "mass_analysis_results.csv").read_bytes())
            got = j_fields(folder)
            if reference is None:
                reference = got
            elif got.keys() != reference.keys() or not all(np.array_equal(got[key], reference[key]) for key in got):
                raise AssertionError(f"J2: {mode} loop {k}: exported fields differ from loop 0's")
        loop_peak = torch.cuda.max_memory_allocated(device) / 2**30
        if len(csv_bytes) != 1 or len(reference) != 2 * J_PHOTOS:
            raise AssertionError(f"J2: {len(csv_bytes)} distinct CSVs, {len(reference)} fields")
        ms = {mode: [1e3 * s / J_PHOTOS for s in each] for mode, each in seconds.items()}
        median = {mode: float(np.median(each)) for mode, each in ms.items()}
        speedup = median["sequential"] / median["prefetched"]

        # The split of one sequential loop, each step closed by a synchronize.
        split = dict.fromkeys(J_STEPS, 0.0)

        def timed(key, fn):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t0
                return out

            return wrapper

        chain = ctx.color_to_mass_analysis
        products, export, write = analysis_mass.analysis_scalar_products, ImageExportFormats.export, CsvTable.write
        ctx.fluidflower.read_image = timed("read", ctx.fluidflower.read_image)
        ctx.color_to_mass_analysis = JTimed(chain, timed("chain", chain))
        analysis_mass.analysis_scalar_products = timed("products", products)
        ImageExportFormats.export = timed("export", export)
        CsvTable.write = timed("csv", write)
        events = []
        all_paths = ctx.image_paths
        ctx.image_paths = all_paths[:J_SPLIT]
        try:
            _, split_s, n = counted(
                w2p, lambda: loop("sequential", root / "j2" / "split", events), J_SPLIT * I_READ_K1, "J2: split"
            )
        finally:
            ctx.image_paths = all_paths
            del ctx.fluidflower.read_image
            ctx.color_to_mass_analysis = chain
            analysis_mass.analysis_scalar_products, ImageExportFormats.export, CsvTable.write = (
                products, export, write
            )
        launches += n
        after_read = sum(e["image_duration_s"] for e in events if e["event"] == "image_progress")
        split["integrals"] = after_read - split["chain"] - split["products"] - split["export"] - split["csv"]
        split_ms = {key: 1e3 * v / J_SPLIT for key, v in split.items()}
        rest_ms = 1e3 * split_s / J_SPLIT - sum(split_ms.values())

        # Each photograph's mass against the chain called on the rig's read.
        geometry = ctx.fluidflower.geometry
        rows = j_csv(root / "j2" / "0_prefetched" / "mass_analysis_results.csv")

        def direct():
            out = []
            for path in photos:
                result = ctx.color_to_mass_analysis(ctx.fluidflower.read_image(path))
                out.append((result.mass.img.cpu().numpy(), float(geometry.integrate(result.mass))))
            return out

        direct_out, _, n = counted(w2p, direct, J_PHOTOS * I_READ_K1, "J2: direct")
        launches += n
        for stem, row, (field, total) in zip(stems, rows, direct_out):
            if not (np.array_equal(reference[("mass", stem)], field) and float(row["detected_mass_total"]) == total):
                raise AssertionError(f"J2: {stem}: the loop's mass differs from the chain on the rig's read")
        print(
            f"J2. on {card}: the mass loop over {J_PHOTOS} photographs, ms per photograph in turns "
            f"(prefetched: {default_workers()} workers, depth {default_workers() + 1}): prefetched "
            f"{[round(v, 1) for v in ms['prefetched']]}, sequential {[round(v, 1) for v in ms['sequential']]}; "
            f"medians {median['prefetched']:.1f} / {median['sequential']:.1f} ms, "
            f"loader_prefetch_speedup {speedup:.3f}; peak {loop_peak:.2f} GiB; context {context_s:.2f} s; "
            f"CSV bytes and every exported field equal across the {len(modes)} loops, each "
            f"photograph's mass == the chain on rig.read_image, bitwise; {I_READ_K1} K1 launches per "
            f"photograph (+{H_GRID_K1} in the first read)"
        )
        print(
            f"J2. split of a sequential loop over {J_SPLIT} photographs, ms per photograph (each step closed by a "
            "synchronize): "
            + ", ".join(f"{key} {split_ms[key]:.1f}" for key in J_STEPS)
            + f", rest {rest_ms:.1f}; loop {1e3 * split_s / J_SPLIT:.1f}; {time.perf_counter() - t_j2:.2f} s"
        )

        # J3. The same loop with K1 swapped for its plain version.
        with plain_k1(w2p):
            _, _, _ = counted(w2p, lambda: loop("prefetched", root / "j2" / "plain"), 0, "J3: plain K1")
        plain = j_fields(root / "j2" / "plain")
        diffs = [float(np.abs(plain[key] - reference[key]).mean()) for key in reference]
        if plain.keys() != reference.keys() or not max(diffs) <= 1e-5:
            raise AssertionError(f"J3: plain K1 fields mean|diff| {max(diffs) if diffs else None}")
        print(f"J3. on {card}: the loop with plain K1: every exported field within mean|diff| {max(diffs):.2e}")

        # J4. One prefetched loop profiled.
        result = {"ms": median, "ms_each": ms, "speedup": speedup, "split_ms": split_ms, "peak_gib": loop_peak}
        if profile is not None:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            torch.cuda.reset_peak_memory_stats(device)
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                loop("prefetched", root / "j2" / "profiled")
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            averages = prof.key_averages()
            profile.mkdir(parents=True, exist_ok=True)
            (profile / "profile_analysis_run.txt").write_text(
                averages.table(sort_by="cuda_time_total", row_limit=30)
                + "\n"
                + averages.table(sort_by="self_cpu_time_total", row_limit=30)
            )
            trace = profile / "profile_analysis_run.json"
            prof.export_chrome_trace(str(trace))
            events = [
                e
                for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
            ]
            if trace.stat().st_size > 8e6:
                trace.unlink()
            busy = busy_us(events) / 1e3 / J_PHOTOS
            result.update(busy_ms=busy, idle=1 - busy / median["prefetched"])
            print(
                f"J4. profile of a prefetched loop: {len(events) / J_PHOTOS:.0f} device ops per photograph, "
                f"device busy {busy:.2f} ms per photograph, idle share against the unprofiled "
                f"{median['prefetched']:.1f} ms: {1 - busy / median['prefetched']:.3f}; peak {peak:.2f} GiB"
            )

        # J5. The set-up CLI's protocol, and the comparison CLI on phase G's runs.
        t_j5 = time.perf_counter()
        scratch = root / "j5"
        scratch.mkdir()
        setup_config = scratch / "config.toml"
        setup_config.write_text(toml_text(j_tables(root, scratch)))
        counted(
            w2p,
            lambda: user_interface_setup.main(["--config", str(setup_config), "--protocols", "--overwrite"], device=dev),
            0,
            "J5: the set-up CLI",
        )
        protocol = j_csv(scratch / "imaging.csv")
        if [r["path"] for r in protocol] != [p.name for p in photos] or not (scratch / "injection.csv").exists():
            raise AssertionError(f"J5: imaging protocol {[r['path'] for r in protocol]}")
        multi = handoff["multi"]
        i4 = multi.parent / "multi_results" / "wasserstein"
        before = {p.name: p.read_bytes() for p in sorted(i4.iterdir())}
        i4.rename(i4.with_name("wasserstein_i4"))
        argv = ["--config", str(multi), "--wasserstein-compute", "--wasserstein-assemble"]
        _, compare_s, _ = counted(
            w2p, lambda: user_interface_comparison.main(argv, device=dev), 0, "J5: the comparison CLI"
        )
        after = {p.name: p.read_bytes() for p in sorted(i4.iterdir())}
        same = after.keys() == before.keys() and all(
            json.loads(after[k]) == json.loads(before[k]) if k.endswith(".json") else after[k] == before[k]
            for k in before
        )
        if not (same and sum(k.endswith(".json") for k in before) == 12 and "wasserstein_distances.csv" in before):
            raise AssertionError(f"J5: comparison CLI {sorted(after)} against phase I4's {sorted(before)}")
        logging.getLogger().setLevel(logging.WARNING)
        print(
            f"J5. on {card}: user_interface_setup.main(--protocols --overwrite) wrote the imaging "
            f"protocol of the {J_PHOTOS} photographs (file times: npz has no EXIF) and the templates; "
            f"user_interface_comparison.main(--wasserstein-compute --wasserstein-assemble) {compare_s:.2f} s: "
            f"12 JSON files and the CSV equal to phase I4's; {time.perf_counter() - t_j5:.2f} s"
        )
    finally:
        dt.Rig.read_image = read_image
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    if keep:
        result["handoff"] = {"root": root, "photos": photos}
    if failures:
        raise AssertionError(f"J: frames that could not be read: {failures}")
    if launches != K1_IN_J:
        raise AssertionError(f"J: {launches} K1 launches, want {K1_IN_J}")
    result["phase_s"] = time.perf_counter() - tic
    print(f"J. phase {result['phase_s']:.2f} s, {launches} K1 launches")
    return {"launches": launches, **result}


# ---------------------------------------------------------------- phase K
K_SEGMENTS = 2  # the template's [color.path.co2] (templates/config.toml:62-79)
K_RESOLUTION = 51
K_THRESHOLD = 0.3
K_MAXITER = 20
K_MASS_PHOTOS = 4  # [calibration.mass] data: the last 4 photographs (the plume grown)
K_CACHE_PHOTOS = 2
K_ROI_POINTS = [[200, 400], [1200, 2400]]
# K1 launches: I_READ_K1 per Rig.read_image, H_GRID_K1 in the first read
# through a freshly loaded rig.  K1: the colour step loads the rig and reads
# the baseline and the 8 photographs, the mass step loads it again and reads
# K_MASS_PHOTOS; K3 takes the plain K1; K5 reads K_CACHE_PHOTOS through a
# rig loaded for the cache (the second pass reads the cache).
K1_COLOR_K1 = H_GRID_K1 + (1 + J_PHOTOS) * I_READ_K1
K1_MASS_K1 = H_GRID_K1 + K_MASS_PHOTOS * I_READ_K1
K5_K1 = H_GRID_K1 + K_CACHE_PHOTOS * I_READ_K1
K1_IN_K = K1_COLOR_K1 + K1_MASS_K1 + K5_K1


def k_tables(root: Path, photos: list, results: Path, bundle: Path) -> dict:
    """Phase J's config with a data registry (the baseline photograph, the
    8 photographs, the last K_MASS_PHOTOS), a path embedding with the
    template's settings calibrated into ``results``, [calibration],
    [helper.results] over phase J's mass fields and the [utils] bundle."""
    tables = j_tables(root, root / "analysis")
    # Phase I's rig, set up under its results folder.
    tables["rig"]["path"] = root / "results" / "setup" / "rig"
    tables["data"]["results"] = results
    tables["data"]["path"] = {
        "baseline_imgs": {"paths": [root / "images" / "img_00000.npz"]},
        "calibration_imgs": {"paths": list(photos)},
        "mass_imgs": {"paths": list(photos[-K_MASS_PHOTOS:])},
    }
    tables["color"]["path"]["calib"] = {
        "mode": "relative",
        "basis": "labels",
        "num_segments": K_SEGMENTS,
        "resolution": K_RESOLUTION,
        "histogram_weighting": "threshold",
        "baseline": "baseline_imgs",
        "data": "calibration_imgs",
    }
    tables["calibration"] = {
        "data": "calibration_imgs",
        "color": {"color": "calib"},
        "mass": {
            "color": "calib",
            "mode": "auto",
            "threshold": K_THRESHOLD,
            "maxiter": K_MAXITER,
            "data": "mass_imgs",
        },
    }
    tables["analysis"]["mass"]["folder"] = root / "results" / "mass"
    tables["helper"] = {"results": {"mode": "mass", "format": "npz"}}
    tables["utils"] = {"export_calibration_bundle": bundle, "import_calibration_bundle": bundle}
    return tables


def k_host_counts(labels: np.ndarray, mask: np.ndarray, image: np.ndarray, baseline: np.ndarray, resolution: int):
    """The JAX package's per-label spectrum loop on one photograph
    (``color_path_regression.py:149-161``, quantised as its
    ``color_to_index`` quantises into the box [-1, 1]^3): per label
    (ascending) the occupied bin ids and their counts."""
    relative = image.astype(float) - baseline.astype(float)
    relative[~mask] = 0.0
    out = []
    for label in np.unique(labels):
        colors = relative[labels == label].reshape(-1, 3)
        index = np.round(np.clip((colors + 1.0) / 2.0, 0.0, 1.0) * (resolution - 1)).astype(np.int64)
        ids = index[:, 0] * resolution * resolution + index[:, 1] * resolution + index[:, 2]
        out.append(np.unique(ids, return_counts=True))
    return out


def k_rdp_agree(trace: list, trace_ref: list) -> tuple:
    """(agree, tie) of the batched and the plain fits' sequences of splits:
    a tie is a split where the two chose differently while their smoothed
    left - right differences agree within 1e-12 at every candidate."""
    for a, b in zip(trace, trace_ref):
        if a[:2] != b[:2]:
            return False, False
        if a[2] != b[2]:
            return False, bool(np.max(np.abs(a[3] - b[3])) <= 1e-12)
    return len(trace) == len(trace_ref), False


def phase_calibration(dt, w2p, handoff: dict, device, card: str, keep: bool = False) -> dict:
    """Phase K: the calibration workflows over phase J's photographs through
    the calibration CLI (the spectra gathered on the card against the JAX
    package's host loop, the batched path fit against its plain version,
    the calibrated chain saved and read back), the colour step with plain
    K1, deletion and a bundle round trip through the utils CLI, the helper
    CLI and the cached image loader on phase J's results.  With ``keep`` the
    folder stays and the result hands it on (``root``)."""
    import io
    import logging
    import shutil
    import warnings
    from contextlib import redirect_stdout

    import scipy.optimize

    from darsia_tpu_torch.presets.workflows import (
        calibration,
        helper,
        user_interface_calibration,
        user_interface_helper,
        user_interface_utils,
        utils,
    )
    from darsia_tpu_torch.presets.workflows.config import FluidFlowerConfig

    warnings.filterwarnings("ignore", message="Section .* not found")
    tic = time.perf_counter()
    dev = None if device.type == "cuda" else device
    root, photos = handoff["root"], handoff["photos"]
    results, bundle = root / "k", root / "k_bundle"
    config_path = root / "calibration.toml"
    config_path.write_text(toml_text(k_tables(root, photos, results, bundle)))
    config = FluidFlowerConfig(config_path)
    embedding = config.color["calib"]
    launches = 0
    try:
        # K1. The calibration CLI: the colour paths, then the colour-to-mass
        # chain; the spectra, the chain and the objective recorded.
        spectra_calls, calibrations, objectives = [], [], []
        get_color_spectrum = dt.LabelColorPathMapRegression.get_color_spectrum
        automatic_calibration = dt.HeterogeneousColorToMassAnalysis.automatic_calibration
        minimize = scipy.optimize.minimize

        def recording_spectrum(self, images, baseline=None, ignore=None, threshold_zero=0.0, **kwargs):
            out = get_color_spectrum(self, images, baseline, ignore, threshold_zero, **kwargs)
            spectra_calls.append((self, images, baseline, ignore, threshold_zero, out))
            return out

        def recording_calibration(self, images, experiment, **kwargs):
            calibrations.append((self, images))
            return automatic_calibration(self, images, experiment, **kwargs)

        def recording_minimize(fun, x0, **kwargs):
            start = fun(x0)
            out = minimize(fun, x0, **kwargs)
            objectives.append((start, float(out.fun), int(out.nfev)))
            return out

        dt.LabelColorPathMapRegression.get_color_spectrum = recording_spectrum
        dt.HeterogeneousColorToMassAnalysis.automatic_calibration = recording_calibration
        scipy.optimize.minimize = recording_minimize
        try:
            argv = ["--config", str(config_path), "--color"]
            _, color_s, n = counted(
                w2p, lambda: user_interface_calibration.main(argv, device=dev), K1_COLOR_K1, "K1: the colour step"
            )
            launches += n
            argv = ["--config", str(config_path), "--mass"]
            _, mass_s, n = counted(
                w2p, lambda: user_interface_calibration.main(argv, device=dev), K1_MASS_K1, "K1: the mass step"
            )
            launches += n
        finally:
            dt.LabelColorPathMapRegression.get_color_spectrum = get_color_spectrum
            dt.HeterogeneousColorToMassAnalysis.automatic_calibration = automatic_calibration
            scipy.optimize.minimize = minimize
        logging.getLogger().setLevel(logging.WARNING)  # main() set INFO for the CLI
        rig = dt.Rig.load(config.rig.path, config.corrections, device=dev)
        rig.load_experiment(dt.ProtocolledExperiment.init_from_config(config))
        labels = sorted(int(v) for v in torch.unique(rig.labels.img).tolist())
        paths = dt.LabelColorPathMap.load(embedding.color_paths_folder)
        nodes = {label: np.asarray(p.relative_colors) for label, p in paths.items()}
        if sorted(paths) != labels or len(labels) != H_LAYERS or any(
            v.shape != (K_SEGMENTS + 1, 3) for v in nodes.values()
        ):
            raise AssertionError(f"K1: paths {sorted(paths)} of shapes {[v.shape for v in nodes.values()]}")
        for folder in (embedding.color_paths_folder, embedding.color_to_mass_folder):
            metadata = calibration.read_calibration_metadata(folder) or {}
            if metadata.get("basis") != "labels":
                raise AssertionError(f"K1: {folder}: metadata {metadata}")
        ((start, best, nfev),) = objectives
        if not best <= start:
            raise AssertionError(f"K1: objective {best} after the calibration, {start} at the initial dofs")
        ((chain, images),) = calibrations
        loaded = dt.HeterogeneousColorToMassAnalysis.from_folder(
            embedding.color_to_mass_folder,
            baseline=rig.baseline,
            labels=rig.labels,
            co2_mass_analysis=chain.co2_mass_analysis,
            geometry=rig.geometry,
            basis=embedding.basis,
            color_mode=embedding.mode,
        )
        masses = []
        for image in images:
            want = chain(image).mass
            if not torch.equal(want.img, loaded(image).mass.img):
                raise AssertionError(f"K1: {image.name}: the saved chain's mass differs from the calibrated chain's")
            masses.append(float(chain.geometry.integrate(want)))
        print(
            f"K1. on {card}: user_interface_calibration.main(--color) {color_s:.2f} s ({K1_COLOR_K1} K1 "
            f"launches: the baseline and {J_PHOTOS} photographs read), --mass {mass_s:.2f} s "
            f"({K1_MASS_K1} K1 launches, {K_MASS_PHOTOS} photographs, Nelder-Mead maxiter {K_MAXITER}: "
            f"{nfev} objective calls, objective {start!r} at the initial dofs -> {best!r}); "
            f"{len(paths)} paths of {K_SEGMENTS + 1} nodes, metadata basis 'labels'; the saved chain "
            f"(from_folder) gives each calibration photograph's mass bitwise: {masses} kg"
        )

        # K2. The spectra on the card against the host loop; the batched
        # path fit against the plain version.
        regression, cal_images, cal_base, ignore, threshold_zero, spectra = spectra_calls[-1]
        if len(cal_images) != J_PHOTOS or cal_base is None or ignore is None:
            raise AssertionError(f"K2: a calibration spectrum of {len(cal_images)} photographs")
        labels_np = regression._labels.cpu().numpy()
        mask_np = regression._mask_on(torch.device("cpu")).numpy()
        base_np = cal_base.img.cpu().numpy()
        device_ms, host_ms = [], []
        for image in cal_images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = regression.image_counts(image, cal_base, threshold_zero)
            device_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            want = k_host_counts(labels_np, mask_np, image.img.cpu().numpy(), base_np, K_RESOLUTION)
            host_ms.append(1e3 * (time.perf_counter() - t0))
            if len(got) != len(want) or not all(
                np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(got, want)
            ):
                raise AssertionError(f"K2: {image.name}: the spectrum's counts differ from the host loop's")
        sizes, fit_s, ref_s, ties = {}, [], [], 0
        for label in labels:
            colors, weights = regression._fit_inputs(spectra[label], ignore[label], "threshold")
            sizes[label] = len(colors)
            if len(colors) <= 1:
                continue
            embedding_1d = regression._embed_1d(colors, weights)
            trace, trace_ref = [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched = regression._fit_path_rdp(colors, weights, embedding_1d, K_SEGMENTS, trace)
            fit_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            plain = regression._fit_path_rdp_reference(colors, weights, embedding_1d, K_SEGMENTS, trace_ref)
            ref_s.append(time.perf_counter() - t0)
            agree, tie = k_rdp_agree(trace, trace_ref)
            if tie:
                ties += 1
                continue
            if not (agree and np.array_equal(batched, plain)):
                raise AssertionError(f"K2: label {label}: the batched fit's nodes differ from the plain version's")
            if not np.array_equal(batched, nodes[label]):
                raise AssertionError(f"K2: label {label}: the saved path's nodes differ from the fit's")
        if not fit_s:
            raise AssertionError(f"K2: no label with a spectrum to fit: {sizes}")
        print(
            f"K2. on {card}: the calibration spectrum of each of the {J_PHOTOS} photographs (resolution "
            f"{K_RESOLUTION}, {len(labels)} labels, {labels_np.size} pixels) on the card == the host loop's "
            f"counts; ms per photograph: card {[round(v, 1) for v in device_ms]}, host "
            f"{[round(v) for v in host_ms]}; occupied bins fitted per label (the baseline's expanded "
            f"spectrum removed) {list(sizes.values())}; the batched path fit == the plain version on "
            f"{len(fit_s)} labels ({ties} ties), s per label: batched {[round(v, 3) for v in fit_s]}, "
            f"plain {[round(v, 3) for v in ref_s]}"
        )

        # K3. The colour step with plain K1: the same paths.
        before = {p.name: p.read_bytes() for p in sorted(embedding.color_paths_folder.glob("label_*.json"))}
        with plain_k1(w2p):
            argv = ["--config", str(config_path), "--color"]
            _, plain_s, _ = counted(w2p, lambda: user_interface_calibration.main(argv, device=dev), 0, "K3: plain K1")
        logging.getLogger().setLevel(logging.WARNING)
        after = {p.name: p.read_bytes() for p in sorted(embedding.color_paths_folder.glob("label_*.json"))}
        if after != before or len(after) != H_LAYERS:
            raise AssertionError(f"K3: the paths with plain K1 differ ({len(after)} files)")
        print(f"K3. on {card}: the colour step with plain K1 {plain_s:.2f} s: every path file equal")

        # K4. Deletion listed, then a bundle round trip through the utils CLI.
        listing = io.StringIO()
        with redirect_stdout(listing):
            user_interface_calibration.main(["--config", str(config_path), "--delete", "--dry-run"], device=dev)
        listed = listing.getvalue().split()
        files = [str(p) for p in calibration.collect_existing_calibration_paths_to_delete(config_path)]
        if listed != files or not files or not all(Path(p).exists() for p in listed):
            raise AssertionError(f"K4: --delete --dry-run listed {listed}, want {files}")
        second = root / "k_import"
        second.mkdir()
        second_config = root / "calibration_import.toml"
        second_config.write_text(toml_text(k_tables(root, photos, second, bundle)))
        with redirect_stdout(io.StringIO()):
            user_interface_utils.main(["--config", str(config_path), "--export-calibration"], device=dev)
            user_interface_utils.main(["--config", str(second_config), "--import-calibration"], device=dev)
        logging.getLogger().setLevel(logging.WARNING)

        def tree(folder: Path) -> dict:
            return {p.relative_to(folder): p.read_bytes() for p in sorted(folder.rglob("*")) if p.is_file()}

        source = tree(results / "calibration" / "color")
        if not source or tree(second / "calibration" / "color") != source or tree(bundle) != source:
            raise AssertionError("K4: the imported calibration differs from the exported one")
        print(
            f"K4. --delete --dry-run listed {len(listed)} files and kept them; --export-calibration, then "
            f"--import-calibration into a second results folder: {len(source)} files, "
            f"{sum(len(v) for v in source.values())} bytes, equal"
        )

        # K5. The helper CLI, helper_roi and the cached loader on phase J's
        # results; the media step as without OpenCV.
        t_k5 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            user_interface_helper.main(["--config", str(config_path), "--color", "--results"], device=dev)
        logging.getLogger().setLevel(logging.WARNING)
        drawn = (results / "helper" / "color_histograms.png").exists()
        if not drawn and not any("matplotlib" in str(w.message) for w in caught):
            raise AssertionError("K5: no histograms and no warning naming matplotlib")
        fields = sorted((root / "results" / "mass" / "mass" / "npz").glob("*.npz"))
        exported = sorted((results / "helper" / "mass").glob("*.npz"))
        if [p.name for p in exported] != [p.name for p in fields] or len(fields) != J_PHOTOS:
            raise AssertionError(f"K5: re-exported {[p.name for p in exported]}")
        for a, b in zip(helper.load_result_frames(exported, device=dev), helper.load_result_frames(fields, device=dev)):
            if not (torch.equal(a.image.img, b.image.img) and a.integral == b.integral):
                raise AssertionError(f"K5: {a.source_name}: the re-exported field differs")
        report = helper.color_report(rig.baseline)
        with redirect_stdout(io.StringIO()):
            roi = helper.helper_roi(config_path, points=K_ROI_POINTS, device=dev)
        if not (roi["corner_1"][1] > roi["corner_2"][1] and roi["corner_1"][0] < roi["corner_2"][0]):
            raise AssertionError(f"K5: helper_roi corners {roi}")
        cache = root / "k_cache"
        cached = photos[:K_CACHE_PHOTOS]
        first, _, n = counted(
            w2p,
            lambda: utils.load_images_with_cache(rig, cached, use_cache=True, cache_dir=cache),
            K5_K1,
            "K5: the loader, first pass",
        )
        launches += n
        again, cache_s, _ = counted(
            w2p,
            lambda: utils.load_images_with_cache(rig, cached, use_cache=True, cache_dir=cache),
            0,
            "K5: the loader, from the cache",
        )
        if not all(torch.equal(a.img, b.img) and a.img.device == b.img.device for a, b in zip(first, again)):
            raise AssertionError("K5: the cached images differ from the read ones")
        # --media as on a machine without OpenCV (cv2 blocked where it is installed).
        import importlib

        try:
            opencv = f"OpenCV {importlib.import_module('cv2').__version__} imports here"
        except ImportError as err:
            opencv = f"OpenCV does not import here: {err}"
        had, held = "cv2" in sys.modules, sys.modules.get("cv2")
        sys.modules["cv2"] = None
        try:
            user_interface_utils.main(["--config", str(config_path), "--media"], device=dev)
        except ImportError as err:
            if "OpenCV" not in str(err):
                raise
            media = str(err)
        else:
            raise AssertionError("K5: --media ran without OpenCV")
        finally:
            if had:
                sys.modules["cv2"] = held
            else:
                del sys.modules["cv2"]
        print(
            f"K5. on {card}: user_interface_helper.main(--color --results): histograms "
            f"{'drawn' if drawn else 'not drawn, matplotlib named'}, the baseline's LAB mean "
            f"{[round(v, 3) for v in report['LAB']['mean']]}, {len(exported)} mass fields re-exported as npz, "
            f"equal; helper_roi at {K_ROI_POINTS}: {roi}; load_images_with_cache over {K_CACHE_PHOTOS} "
            f"photographs: {K5_K1} K1 launches, then from the cache {cache_s:.2f} s, 0 launches, bitwise "
            f"equal; --media with cv2 blocked ({opencv}): {media!r}; {time.perf_counter() - t_k5:.2f} s"
        )
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    if launches != K1_IN_K:
        raise AssertionError(f"K: {launches} K1 launches, want {K1_IN_K}")
    phase_s = time.perf_counter() - tic
    print(f"K. phase {phase_s:.2f} s, {launches} K1 launches")
    result = {"launches": launches, "phase_s": phase_s}
    if keep:
        result["handoff"] = {"root": root}
    return result


# ---------------------------------------------------------------- phase L
L_PHOTOS = 4
L_GROWTH = 40  # raw-frame px the fingers rise per photograph
L_FINGERS = 6
L_HALF = 75  # half the width of a finger at its base (raw px)
L_FLAT = 3  # half the width of a finger's flat top (raw px)
L_NOTCH = (700, 600)  # raw (row, col) of the plume's left end, on the notch line
L_RISE = 400  # the fingers' height above the notch line in photograph 1 (raw px)
L_BODY = 1300  # raw row of the plume body's bottom, below the fingered ROI
L_DOME = ((1300, 2300), (120, 260))  # the second ROI's plume: an ellipse, centre and radii (raw)
# Noise-free grey patches (raw rows, cols) under each ROI, 40+ px beyond it:
# the plumes are painted there in the grey plus phase J's plume colour.
L_PATCHES = ((slice(60, 1350), slice(560, 1540)), (slice(950, 1570), slice(1770, 2870)))
L_GREY = 0.5
L_START = I_START + timedelta(hours=J_PHOTOS + 1)
# ROIs in metres.  The fingered one cuts the plume's body: its bottom edge
# runs ~100 px above the body's bottom and its sides ~20 px inside the
# plume's ends, on the outer fingers' flanks, so within it the mask's
# boundary is the fingered front (flanks of at least 5 rows per column,
# flat tops) and the ROI's own edges; the dome's ROI holds the whole dome.
L_ROIS = {"fingers": [[0.54, 0.47], [1.30, 1.41]], "dome": [[1.6, 0.1], [2.5, 0.65]]}
L_INTERFACE = {"interface": {"name": "interface", "corner_1": L_ROIS["fingers"][0], "corner_2": L_ROIS["fingers"][1]}}
# The fingers are read from phase I's "blue" colour range (absolute HSV): on
# the grey patches it is exactly 1 on the plume and 0 off it, with a
# boundary where the warp's mixing crosses the range's saturation bound.
L_MODE, L_THRESHOLD = "blue", 0.5
# The finger step's colour-to-mass branch: gas saturation from phase J's
# chain, over a region that the photographs leave as the baseline (clear of
# the patches and the checker), where the saturation is below its threshold
# and the step reads no fingers.  A front read from this branch is not
# checked on the card: on J's uniform-noise frame no painted plume keeps a
# noise-free front through a baseline-relative mode (see above).
L_MASS_MODE, L_MASS_THRESHOLD = "saturation_g", 0.5
L_UNCHANGED = {"unchanged": [[1.6, 1.0], [2.2, 1.4]]}
L_SEGMENTATION = ("mass", [0.05, 0.5])  # phase J's chain on phase L's photographs
L_LAYERS = {"gas": ("saturation_g", 0.5, None), "dissolved": ("concentration_aq", 0.05, 0.9)}
L_STEPS = ("read", "chain", "mask", "contours", "skeleton", "tracking", "write")
L_MAXITER = 10
L_SHIFT = 7  # px: L6's shifted copy
# K1 launches: L1 the CLI and L1b the step on a context of its own (each a
# freshly loaded rig: its grid, then every photograph read once); L3 every
# photograph read once more through L1b's rig; L4 SimpleFluidFlower's
# set-up (the drift applied alone to the raw baseline: a pair; the curvature
# alone, with its pull-back grid: a pair + H_GRID_K1; the colour correction
# on the baseline: the checker crop's pair), its 1 + 4 timed reads, the read
# through the loaded rig (its fused chain builds the grid again: H_GRID_K1)
# and the read with the plain K1 (none counted); L5 the session's reads
# through L1b's rig.
L_READS_K1 = H_GRID_K1 + L_PHOTOS * I_READ_K1
L4_SETUP_K1 = 2 + 2 + H_GRID_K1 + 2
L4_READS_K1 = (1 + L_PHOTOS) * I_READ_K1
L4_LOADED_K1 = H_GRID_K1 + I_READ_K1
# L4b: a SimpleFluidFlower with the dynamic illumination correction: the
# set-up as L4's (the correction itself warps nothing), the baseline
# photograph read through it and through L4's rig, and the 1 + 4 timed reads.
L4B_K1 = L4_SETUP_K1 + 2 * I_READ_K1 + L4_READS_K1
L4B_SAMPLES = ((slice(200, 264), slice(300, 364)), (slice(900, 964), slice(2500, 2564)),
               (slice(1400, 1464), slice(1200, 1264)))
K1_IN_L = (
    2 * L_READS_K1 + L_PHOTOS * I_READ_K1 + L4_SETUP_K1 + L4_READS_K1 + L4_LOADED_K1 + L4B_K1
    + L_PHOTOS * I_READ_K1
)


def l_plume(k: int) -> np.ndarray:
    """The raw-frame region of photograph ``k`` (1-based): a plume whose
    upper front carries L_FINGERS fingers with flat tops, L_RISE + (k - 1)
    L_GROWTH px above the notch line, V notches between them (and at both
    ends), over a body down to row L_BODY; and the dome of the second ROI."""
    r0, c0 = L_NOTCH
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    t = cols - c0
    inside = (t >= 0) & (t < 2 * L_FINGERS * L_HALF)
    u = np.abs(np.mod(t, 2 * L_HALF) - L_HALF + 0.5)
    rise = L_RISE + (k - 1) * L_GROWTH
    top = r0 - rise * np.clip((L_HALF - u) / (L_HALF - L_FLAT), 0.0, 1.0)
    fingers = inside & (rows >= top) & (rows <= L_BODY)
    (dr, dc), (a, b) = L_DOME
    grow = (k - 1) * L_GROWTH
    return fingers | h_ellipse((H, W), ((dr, dc), (a + grow, b + grow)))


def l_tips(k: int) -> np.ndarray:
    """Raw (row, col) of each finger's top centre in photograph ``k``."""
    r0, c0 = L_NOTCH
    rise = L_RISE + (k - 1) * L_GROWTH
    return np.array([[r0 - rise, c0 + (2 * f + 1) * L_HALF] for f in range(L_FINGERS)], dtype=float)


def l_photo(frame: np.ndarray, k: int) -> np.ndarray:
    """Phase L's photograph ``k`` (1-based) as uint8 RGB: phase J's frame
    with the grey patches and the plumes painted on them."""
    img = frame.astype(np.float64) / 255.0
    for patch in L_PATCHES:
        img[patch] = L_GREY
    img[l_plume(k)] = L_GREY + np.asarray(I_PLUME_COLOUR)
    return np.round(np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def l_assets(dt, frame: np.ndarray, root: Path) -> list:
    """Phase L's photographs: phase J's frame with a noise-free grey patch
    under each ROI and the plumes painted on the patches in the grey plus
    phase J's plume colour change, one hour apart after phase J's, no drift,
    in a folder of their own, with their imaging protocol."""
    folder = root / "l_photos"
    folder.mkdir()
    photos = [h_save(dt, folder / f"img_{k:05d}.npz", l_photo(frame, k)) for k in range(1, L_PHOTOS + 1)]
    (root / "l_protocols").mkdir()
    (root / "l_protocols" / "imaging.csv").write_text(
        "path,image_id,datetime\n"
        + "".join(
            f"img_{k:05d}.npz,{k},{(L_START + timedelta(hours=k - 1)).isoformat(sep=' ')}\n"
            for k in range(1, L_PHOTOS + 1)
        )
    )
    return photos


def l_tables(root: Path, results: Path) -> dict:
    """Phase J's config over phase L's photographs with [analysis.fingers]
    (the fingered plume's ROI and the dome's, the skeleton analysis, holes
    filled; an entry of its own for the gradient-based interface),
    [analysis.segmentation] and [analysis.thresholding], all results under
    ``results`` (phase J's rig and chain stay where phase J put them)."""
    tables = j_tables(root, root / "analysis")
    tables["data"]["folder"] = root / "l_photos"
    tables["protocols"]["imaging"] = root / "l_protocols" / "imaging.csv"
    tables["roi"].update(
        {name: {"name": name, "corner_1": a, "corner_2": b} for name, (a, b) in {**L_ROIS, **L_UNCHANGED}.items()}
    )
    tables["analysis"]["fingers"] = {
        "folder": results / "fingers",
        "plume": {
            "mode": L_MODE,
            "threshold": L_THRESHOLD,
            "roi": list(L_ROIS),
            "fill_holes": True,
            "include_skeleton_analysis": True,
        },
        "front": {
            "mode": L_MODE,
            "threshold": L_THRESHOLD,
            "roi": L_INTERFACE,
            "fill_holes": True,
            "include_skeleton_analysis": True,
            "include_gradient_based_analysis": True,
            "gradient_mode": L_MODE,
        },
        "saturation": {
            "mode": L_MASS_MODE,
            "threshold": L_MASS_THRESHOLD,
            "roi": list(L_UNCHANGED),
            "fill_holes": True,
            "include_skeleton_analysis": True,
        },
    }
    tables["analysis"]["segmentation"] = {
        "folder": results / "segmentation",
        "label": "CO2",
        "mode": L_SEGMENTATION[0],
        "thresholds": L_SEGMENTATION[1],
        "color": [[255, 255, 0], [0, 255, 255]],
    }
    tables["analysis"]["thresholding"] = {
        "folder": results / "thresholding",
        "layer": {
            key: {"mode": mode, "threshold_min": lo, **({} if hi is None else {"threshold_max": hi})}
            for key, (mode, lo, hi) in L_LAYERS.items()
        },
    }
    return tables


def l_rows(path: Path, key: str) -> list:
    return [r for r in j_csv(path) if r["key"] == key]


def phase_fingers(dt, w2p, lanes, handoff: dict, device, card: str, profile, keep: bool = False) -> dict:
    """Phase L: the finger analysis through the analysis CLI on 4K
    photographs (tips, tracking, advance rates, the skeleton on the card),
    its split and a host reckoning of its counts, the card's skeleton
    against the host one, the segmentation and thresholding masks, the
    SimpleFluidFlower rig, the multiphase calibration session and the
    numerics utilities.  With ``keep`` its folder stays and the result hands
    it on (``root``, the SimpleFluidFlower ``rig``, the rig's ``labels``)."""
    import logging
    import shutil
    import warnings

    from scipy import ndimage

    import importlib

    from darsia_tpu_torch.presets.workflows import user_interface_analysis
    from darsia_tpu_torch.presets.workflows.analysis import analysis_context
    from darsia_tpu_torch.presets.workflows.analysis.analysis_thresholding import layer_mask
    from darsia_tpu_torch.presets.workflows.mode_resolution import resolve_mode_image
    from darsia_tpu_torch.presets.workflows.segmentation_contours import SegmentationContours
    from darsia_tpu_torch.utils.csv_table import CsvTable
    from darsia_tpu_torch.utils.morphology import skeletonize as host_skeletonize

    # The module (the package's attribute of that name is the step's function).
    af = importlib.import_module("darsia_tpu_torch.presets.workflows.analysis.analysis_fingers")
    warnings.filterwarnings("ignore", message="Section .* not found")
    tic = time.perf_counter()
    dev = None if device.type == "cuda" else device
    root = handoff["root"]
    photos = l_assets(dt, lanes["rig"]["frame"], root)
    stems = [p.stem for p in photos]
    config_path = root / "fingers.toml"
    config_path.write_text(toml_text(l_tables(root, root / "l_results")))
    split_config = root / "fingers_split.toml"
    split_config.write_text(toml_text(l_tables(root, root / "l_split")))
    files_s = time.perf_counter() - tic
    launches = 0
    result: dict = {}
    try:
        # L1. The analysis CLI's finger step over the 4 photographs.
        argv = ["--config", str(config_path), "--fingers", "--all"]
        _, l1_s, n = counted(w2p, lambda: user_interface_analysis.main(argv, device=dev), L_READS_K1, "L1: the CLI")
        launches += n
        logging.getLogger().setLevel(logging.WARNING)
        folder = root / "l_results" / "fingers"
        stats = j_csv(folder / "statistics.csv")
        keys = [r["key"] for r in stats]
        if sorted(keys) != sorted(["fingers", "dome", "interface", *L_UNCHANGED] * L_PHOTOS):
            raise AssertionError(f"L1: statistics.csv rows per ROI {keys}")
        unchanged = l_rows(folder / "statistics.csv", *L_UNCHANGED)
        unchanged_counts = [[int(r["number_tips"]), float(r["contour_length"])] for r in unchanged]
        if unchanged_counts != [[0, 0.0]] * L_PHOTOS:
            raise AssertionError(f"L1: {L_MASS_MODE} over the unchanged region: tips, length {unchanged_counts}")
        fingers = l_rows(folder / "statistics.csv", "fingers")
        if [r["image"] for r in fingers] != [p.name for p in photos]:
            raise AssertionError(f"L1: rows {[r['image'] for r in fingers]}")
        tips = [int(r["number_tips"]) for r in fingers]
        continuing = [int(r["number_continuing_fingers"]) for r in fingers]
        if tips != [L_FINGERS] * L_PHOTOS or continuing != [0] + [L_FINGERS] * (L_PHOTOS - 1):
            raise AssertionError(f"L1: tips {tips}, continuing fingers {continuing}")
        drawn = len(list(folder.rglob("*.png")))
        print(
            f"L1. on {card}: user_interface_analysis.main(--fingers --all) over {L_PHOTOS} 4K photographs "
            f"{l1_s:.2f} s ({1e3 * l1_s / L_PHOTOS:.1f} ms per photograph, context included; {L_READS_K1} K1 "
            f"launches): statistics.csv 4 rows per ROI, tips {tips}, continuing fingers {continuing}; "
            f"{L_MASS_MODE} > {L_MASS_THRESHOLD} over the unchanged region: no tips, no contour; "
            f"overlays drawn: {drawn}; files made in {files_s:.2f} s"
        )

        # L1b. The step on a context of its own, sequential, split; the
        # masks and results recorded for the host reckoning.
        t_split = time.perf_counter()
        ctx, context_s, _ = counted(
            w2p,
            lambda: analysis_context.prepare_analysis_context(
                cls=dt.Rig, path=split_config, all=True, require_color_to_mass=True, device=dev
            ),
            0,
            "L1b: the context",
        )
        split = dict.fromkeys(L_STEPS, 0.0)
        depth = [0]

        def timed(key, fn):
            """``fn`` timed into ``split[key]``, closed by a synchronize; a
            timed call inside another one counts for the outer one only."""

            def wrapper(*args, **kwargs):
                if depth[0]:
                    return fn(*args, **kwargs)
                depth[0] = 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    out = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                finally:
                    depth[0] = 0
                split[key] += time.perf_counter() - t0
                return out

            return wrapper

        masks = []

        class Segmentation(af.SimpleSegmentation):
            extract_mask = timed("mask", af.SimpleSegmentation.extract_mask)

        class Contours(af.ContourAnalysis):
            contours = timed("contours", af.ContourAnalysis.contours)
            local_extrema = timed("contours", af.ContourAnalysis.local_extrema)

        skeleton_load = timed("skeleton", af.SkeletonAnalysis.load)

        class Skeleton(af.SkeletonAnalysis):
            def load(self, img, roi=None, fill_holes=False):
                skeleton_load(self, img, roi, fill_holes)
                masks.append({"mask": img, "skeleton": self.skeleton_mask, "iterations": self.iterations})

            leaves_and_junctions = timed("skeleton", af.SkeletonAnalysis.leaves_and_junctions)

        class Tracker(af.PathEvolutionAnalysis):
            add = timed("tracking", af.PathEvolutionAnalysis.add)
            find_paths = timed("tracking", af.PathEvolutionAnalysis.find_paths)
            path_counts = timed("tracking", af.PathEvolutionAnalysis.path_counts)

        originals = {
            name: getattr(af, name)
            for name in (
                "SimpleSegmentation", "ContourAnalysis", "SkeletonAnalysis", "PathEvolutionAnalysis",
                "contour_length", "extract_lower_arc", "_path_log", "_category_statistics", "json",
            )
        }
        chain = ctx.color_to_mass_analysis
        write = CsvTable.write
        prefetched = analysis_context.iter_prefetched_images
        timed_json = SimpleNamespace(dump=timed("write", json.dump), loads=json.loads, dumps=json.dumps)
        af.SimpleSegmentation, af.ContourAnalysis, af.SkeletonAnalysis, af.PathEvolutionAnalysis = (
            Segmentation, Contours, Skeleton, Tracker
        )
        af.contour_length = timed("contours", originals["contour_length"])
        af.extract_lower_arc = timed("contours", originals["extract_lower_arc"])
        af._path_log = timed("tracking", originals["_path_log"])
        af._category_statistics = timed("tracking", originals["_category_statistics"])
        af.json = timed_json
        CsvTable.write = timed("write", write)
        ctx.fluidflower.read_image = timed("read", ctx.fluidflower.read_image)
        ctx.color_to_mass_analysis = JTimed(chain, timed("chain", chain))
        analysis_context.iter_prefetched_images = lambda c, paths=None, depth=None: prefetched(c, paths, depth=0)
        events = []
        try:
            _, split_s, n = counted(
                w2p,
                lambda: af.analysis_fingers_from_context(ctx, progress_callback=events.append),
                L_READS_K1,
                "L1b: the split step",
            )
        finally:
            for name, value in originals.items():
                setattr(af, name, value)
            CsvTable.write = write
            del ctx.fluidflower.read_image
            ctx.color_to_mass_analysis = chain
            analysis_context.iter_prefetched_images = prefetched
        launches += n
        if split["chain"] <= 0.0:
            raise AssertionError("L1b: the colour-to-mass chain did not run in the finger step")
        after_read = sum(e["image_duration_s"] for e in events if e["event"] == "image_progress")
        split_ms = {key: 1e3 * v / L_PHOTOS for key, v in split.items()}
        rest_ms = 1e3 * after_read / L_PHOTOS - sum(v for k, v in split_ms.items() if k != "read")
        per_photo = 1e3 * split_s / L_PHOTOS
        split_folder = root / "l_split" / "fingers"
        for name in ("statistics.csv", "fingers_analysis_results.csv", "statistics.json"):
            if (split_folder / name).read_bytes() != (folder / name).read_bytes():
                raise AssertionError(f"L1b: {name} differs from the CLI's")
        # The host reckoning of every count and length on the step's masks
        # (the card's skeleton copied to the host; the plain skeleton on the
        # largest mask in L2).
        rows = j_csv(split_folder / "statistics.csv")
        if len(rows) != len(masks):
            raise AssertionError(f"L1b: {len(rows)} rows, {len(masks)} masks recorded")
        for row, rec in zip(rows, masks):
            host_mask = rec["mask"].cpu().numpy()
            contours = af.ContourAnalysis(reduce_to_main_contour=True)
            contours.load_labels(host_mask, fill_holes=False)
            peaks, fjords = contours.local_extrema()
            skel = af.SkeletonAnalysis(device="cpu")
            skel.skeleton_mask = rec["skeleton"].cpu()
            leaves, junctions, base = skel.leaves_and_junctions()
            got = [int(row[c]) for c in ("number_tips", "number_fjords", "number_leaves", "number_junctions", "number_base_junctions")]
            if got != [len(peaks), len(fjords), len(leaves), len(junctions), len(base)] or float(
                row["contour_length"]
            ) != float(af.contour_length(host_mask)):
                raise AssertionError(f"L1b: {row['image']} {row['key']}: {got} against the host reckoning")
        print(
            f"L1b. on {card}: the finger step on a context of its own, sequential, {per_photo:.1f} ms per "
            f"photograph (context {context_s:.2f} s): "
            + ", ".join(f"{key} {split_ms[key]:.1f}" for key in L_STEPS)
            + f", rest {rest_ms:.1f} ms (each step closed by a synchronize); the CSVs and statistics.json equal "
            f"to the CLI's; {len(masks)} masks' counts and lengths equal to a host reckoning; "
            f"{time.perf_counter() - t_split:.2f} s"
        )
        # The tracked tips, mapped back to the raw frame through the rig's
        # curvature correction (its grid is built): each rises L_GROWTH px
        # per photograph.
        record = json.loads((folder / "statistics.json").read_text())
        grid, _ = ctx.fluidflower.curvature_correction.pullback_field((H, W), device)
        cs = ctx.fluidflower.baseline.coordinatesystem
        (x0, y0), (x1, y1) = [np.asarray(cs.coordinate(np.array([[v, v]])), dtype=float).reshape(2) for v in (0, 1)]
        paths = {k: v for k, v in record["paths"]["fingers"].items() if isinstance(v, dict) and "time" in v}
        raw = []
        for entry in paths.values():
            xy = np.asarray(entry["coordinates"], dtype=float)
            voxels = np.rint(np.stack([(xy[:, 1] - y0) / (y1 - y0), (xy[:, 0] - x0) / (x1 - x0)], axis=1)).astype(int)
            index = torch.from_numpy(voxels).to(grid.device)
            raw.append(grid[:, index[:, 0], index[:, 1]].T.cpu().numpy())
        steps = np.array([np.diff(r[:, 0]) for r in raw if len(r) == L_PHOTOS])
        want = np.sort(l_tips(L_PHOTOS)[:, 1])
        got_cols = np.sort([r[-1, 1] for r in raw if len(r) == L_PHOTOS])
        if steps.shape != (L_FINGERS, L_PHOTOS - 1) or np.abs(steps + L_GROWTH).max() > 1.0:
            raise AssertionError(f"L1: raw-frame tip advance per photograph {steps.tolist()}, want -{L_GROWTH}")
        if np.abs(got_cols - want).max() > L_FLAT + 2:
            raise AssertionError(f"L1: tip columns {got_cols.tolist()}, painted {want.tolist()}")
        rates = j_csv(folder / "paths" / "fingers" / "fingers_advance_rates.csv")
        per_hour = [float(r["advance_rate"]) * 3600.0 for r in rates if int(r["lifetime_steps"]) == L_PHOTOS]
        metres = [v * float(np.mean(ctx.fluidflower.baseline.voxel_size)) for v in per_hour]
        arcs = sorted((folder / "interface-contour-npy" / "interface").glob("*.npy"))
        if len(per_hour) != L_FINGERS or [p.stem for p in arcs] != stems:
            raise AssertionError(f"L1: {len(per_hour)} advance rates, interface files {[p.name for p in arcs]}")
        print(
            f"L1. the tracked tips in the raw frame rise {np.round(-steps, 2).tolist()} px per photograph "
            f"(painted {L_GROWTH}); advance rates {[round(v, 3) for v in per_hour]} px/h = "
            f"{[round(v * 1e3, 3) for v in metres]} mm/h; statistics.json and {len(arcs)} interface .npy files written"
        )
        result = {"ms": per_photo, "split_ms": split_ms, "cli_s": l1_s}
        if profile is not None:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                af.analysis_fingers_from_context(ctx)
                torch.cuda.synchronize()
            averages = prof.key_averages()
            profile.mkdir(parents=True, exist_ok=True)
            (profile / "profile_fingers.txt").write_text(
                averages.table(sort_by="cuda_time_total", row_limit=30)
                + "\n"
                + averages.table(sort_by="self_cpu_time_total", row_limit=30)
            )
            trace = profile / "profile_fingers.json"
            prof.export_chrome_trace(str(trace))
            events = [
                e
                for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
            ]
            if trace.stat().st_size > 8e6:
                trace.unlink()
            busy = busy_us(events) / 1e3 / L_PHOTOS
            result.update(busy_ms=busy, idle=1 - busy / per_photo)
            print(
                f"L1c. profile of the step (prefetched): {len(events) / L_PHOTOS:.0f} device ops per photograph, "
                f"device busy {busy:.2f} ms per photograph, idle share against the unprofiled {per_photo:.1f} "
                f"ms: {1 - busy / per_photo:.3f}"
            )

        # L2. The card's skeleton against the host one on the largest mask.
        largest = max(masks, key=lambda rec: int(rec["mask"].sum()))
        mask = largest["mask"]
        from darsia_tpu_torch.ops.morphology import skeletonize

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_skeleton, iterations = skeletonize(mask)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host_mask = mask.cpu().numpy()
        t0 = time.perf_counter()
        host_skeleton = host_skeletonize(host_mask)
        host_s = time.perf_counter() - t0
        eroded, count = host_mask, 0
        while eroded.any():
            eroded = ndimage.binary_erosion(eroded, structure=ndimage.generate_binary_structure(2, 1))
            count += 1
        if not (np.array_equal(card_skeleton.cpu().numpy(), host_skeleton) and iterations == count == largest["iterations"]):
            raise AssertionError(f"L2: the card's skeleton differs from the host's ({iterations} / {count} iterations)")
        skel = af.SkeletonAnalysis(device="cpu")
        skel.skeleton_mask = torch.from_numpy(host_skeleton)
        host_counts = [len(x) for x in skel.leaves_and_junctions()]
        skel.skeleton_mask = largest["skeleton"].cpu()
        if host_counts != [len(x) for x in skel.leaves_and_junctions()]:
            raise AssertionError("L2: leaves and junctions of the host skeleton differ")
        print(
            f"L2. on {card}: the skeleton of the largest mask ({tuple(mask.shape)}, {int(mask.sum())} px): on the "
            f"card {card_s:.3f} s, on the host (utils/morphology.py) {host_s:.2f} s, bitwise equal, {iterations} "
            f"erosions; leaves, junctions, base junctions {host_counts}"
        )
        result.update(skeleton_card_s=card_s, skeleton_host_s=host_s, iterations=iterations)

        # L3. Segmentation and thresholding: the steps name matplotlib; their
        # masks on the card against the host threshold of the same field.
        t_l3 = time.perf_counter()
        try:
            importlib.import_module("matplotlib")
            have_matplotlib = True
        except ImportError:
            have_matplotlib = False
        named = []
        for step in ("segmentation", "thresholding"):
            try:
                user_interface_analysis.main(["--config", str(split_config), f"--{step}", "--all"], device=dev)
            except ImportError as err:
                if have_matplotlib or "matplotlib" not in str(err):
                    raise
                named.append(str(err))
            else:
                if not have_matplotlib:
                    raise AssertionError(f"L3: --{step} ran without matplotlib")
        logging.getLogger().setLevel(logging.WARNING)
        seg = ctx.config.analysis.segmentation.config
        layers = ctx.config.analysis.thresholding.layers
        near_total = differ = 0

        def field_of(mode, img, res):
            return resolve_mode_image(
                mode,
                img,
                mass_analysis_result=res,
                color_embedding_registry=ctx.config.color,
                color_embedding_runtime=ctx.color_embedding_runtime,
            ).img

        def l3():
            nonlocal near_total, differ
            for path in photos:
                img = ctx.fluidflower.read_image(path)
                res = ctx.color_to_mass_analysis(img)
                field = field_of(seg.mode, img, res)
                host = field.cpu().numpy()
                for threshold in seg.thresholds:
                    got = SegmentationContours(seg).extract_mask(img, threshold, mass_analysis_result=res)
                    bad = got.cpu().numpy() != (host > threshold)
                    near = np.abs(host - threshold) <= 1e-6
                    near_total += int(near.sum())
                    differ += int(bad.sum())
                    if (bad & ~near).any():
                        raise AssertionError(f"L3: {path.name}: segmentation mask at {threshold}")
                for key, layer in layers.items():
                    f = field_of(layer.mode, img, res)
                    h = f.cpu().numpy()
                    want = np.ones(h.shape, bool)
                    near = np.zeros(h.shape, bool)
                    if layer.threshold_min is not None:
                        want &= h >= layer.threshold_min
                        near |= np.abs(h - layer.threshold_min) <= 1e-6
                    if layer.threshold_max is not None:
                        want &= h <= layer.threshold_max
                        near |= np.abs(h - layer.threshold_max) <= 1e-6
                    bad = layer_mask(layer, f).cpu().numpy() != want
                    near_total += int(near.sum())
                    differ += int(bad.sum())
                    if (bad & ~near).any():
                        raise AssertionError(f"L3: {path.name}: thresholding layer {key}")

        _, _, n = counted(w2p, l3, L_PHOTOS * I_READ_K1, "L3: the masks")
        launches += n
        print(
            f"L3. on {card}: --segmentation and --thresholding "
            + (f"raise without matplotlib: {named[0]!r}" if named else "ran (matplotlib imports here)")
            + f"; {len(seg.thresholds)} segmentation masks and {len(layers)} thresholding layers per photograph "
            f"on the card equal to the host threshold of the same field but {differ} pixels, of {near_total} "
            f"within 1e-6 of a bound; {time.perf_counter() - t_l3:.2f} s"
        )

        # L4. SimpleFluidFlower on phase I's baseline.
        t_l4 = time.perf_counter()
        baseline_path = root / "images" / "img_00000.npz"

        def setup():
            rig4 = dt.SimpleFluidFlower(baseline_path, device=dev)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rig4.setup(specs=dict(META), curvature_options={"config": CURVATURE})
            return rig4, caught

        (rig4, caught), setup_s, n = counted(w2p, setup, L4_SETUP_K1, "L4: SimpleFluidFlower.setup")
        launches += n
        names = [type(c).__name__ for c in rig4.corrections]
        if names != ["TypeCorrection", "DriftCorrection", "CurvatureCorrection", "ColorCorrection"]:
            raise AssertionError(f"L4: chain {names}; warnings {[str(w.message) for w in caught]}")

        def reads():
            first = rig4.read_image(photos[0])
            seconds = []
            for path in photos:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = rig4.read_image(path)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            return first, out, seconds

        (first, last, seconds), _, n = counted(w2p, reads, L4_READS_K1, "L4: read_image")
        launches += n
        if not (first.img.dtype == torch.float32 and torch.isfinite(last.img).all() and tuple(last.img.shape) == (OH, W, 3)):
            raise AssertionError(f"L4: read {first.img.dtype} {tuple(last.img.shape)}")
        saved = root / "l_simple"
        save_t = time.perf_counter()
        rig4.save(saved)
        loaded = dt.SimpleFluidFlower(baseline_path, device=dev)
        loaded.load(saved)
        save_s = time.perf_counter() - save_t
        again, _, n = counted(w2p, lambda: loaded.read_image(photos[-1]), L4_LOADED_K1, "L4: the loaded rig's read")
        launches += n
        if not torch.equal(again.img, last.img):
            raise AssertionError("L4: the loaded rig reads differently")
        with plain_k1(w2p):
            plain = rig4.read_image(photos[-1])
        diff = float((plain.img - last.img).abs().mean())
        if not diff <= 1e-5:
            raise AssertionError(f"L4: plain K1 mean|diff| {diff}")
        ms4 = [1e3 * s for s in seconds]
        print(
            f"L4. on {card}: SimpleFluidFlower set up from phase I's baseline in {setup_s:.2f} s ({L4_SETUP_K1} K1 "
            f"launches), chain {names}; read_image ms {[round(v, 1) for v in ms4]} (median "
            f"{float(np.median(ms4)):.1f}; {I_READ_K1} K1 launches per read); save + load {save_s:.2f} s, the "
            f"loaded rig's read bitwise equal; plain K1 mean|diff| {diff:.2e}; {time.perf_counter() - t_l4:.2f} s"
        )
        result.update(read_ms=float(np.median(ms4)), setup_s=setup_s)

        # L4b. SimpleFluidFlower with the dynamic illumination correction.
        t_l4b = time.perf_counter()
        samples = [tuple(s) for s in L4B_SAMPLES]

        def dynamic_setup():
            rig = dt.SimpleFluidFlower(
                baseline_path, device=dev,
                active_corrections=["type", "drift", "curvature", "dynamic-illumination", "color"],
            )
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rig.setup(specs=dict(META), curvature_options={"config": CURVATURE},
                          dynamic_illumination_options={"samples": samples})
            first = rig.read_image(baseline_path)
            return rig, first

        def dynamic_reads():
            first = rig4b.read_image(photos[0])
            seconds = []
            for path in photos:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = rig4b.read_image(path)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            return first, out, seconds

        reset_counts(w2p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rig4b, on_base = dynamic_setup()
        torch.cuda.synchronize()
        setup_b = time.perf_counter() - t0
        first_b, last_b, seconds_b = dynamic_reads()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            base_l4 = rig4.read_image(baseline_path)
        counts = read_counts(w2p)
        check_counts(counts, {"warp_rows_t": L4B_K1}, "L4b: dynamic illumination set-up and reads")
        launches += counts["warp_rows_t"]
        names_b = [type(c).__name__ for c in rig4b.corrections]
        want_b = ["TypeCorrection", "DriftCorrection", "CurvatureCorrection", "DynamicIlluminationCorrection",
                  "ColorCorrection"]
        if names_b != want_b:
            raise AssertionError(f"L4b: chain {names_b}")
        dynamic = rig4b.dynamic_illumination_correction
        # The baseline's colours, extracted again from a host copy of the
        # baseline the set-up saw (type, drift, curvature applied in turn,
        # under the plain K1: bitwise K1's), and the baseline photograph read
        # beside L4's read of it (printed: a rescaling near 1).
        with plain_k1(w2p):
            staged = rig4b.raw_baseline
            for correction in rig4b.corrections[:3]:
                staged = correction(staged)
            plain_b = rig4b.read_image(photos[-1])
        host = dt.DynamicIlluminationCorrection()
        host.setup(staged.img.cpu(), samples)
        colour_diff = float(np.abs(np.asarray(host.base_colors) - np.asarray(dynamic.base_colors)).max())
        base_diff = float((on_base.img - base_l4.img).abs().max())
        plain_diff = float((plain_b.img - last_b.img).abs().mean())
        finite_b = bool(torch.isfinite(last_b.img).all()) and tuple(last_b.img.shape) == (OH, W, 3)
        if not (colour_diff <= 1e-6 and plain_diff <= 1e-5 and finite_b):
            raise AssertionError(
                f"L4b: host colours {colour_diff:.2e}, plain K1 mean|diff| {plain_diff:.2e}, finite and shaped "
                f"{finite_b}"
            )
        ms4b = [1e3 * v for v in seconds_b]
        print(
            f"L4b. on {card}: SimpleFluidFlower with DynamicIlluminationCorrection ({len(samples)} 64x64 samples) "
            f"set up and the baseline read in {setup_b:.2f} s; read_image ms {[round(v, 1) for v in ms4b]} (median "
            f"{float(np.median(ms4b)):.1f}, L4's {float(np.median(ms4)):.1f}); {L4B_K1} K1 launches; host colours "
            f"within {colour_diff:.1e}, the baseline photograph's read max |diff| {base_diff:.1e} to L4's, plain K1 mean|diff| "
            f"{plain_diff:.2e}; {time.perf_counter() - t_l4b:.2f} s"
        )
        result.update(dynamic_read_ms=float(np.median(ms4b)))

        # L5. The multiphase calibration session over phase L's photographs.
        t_l5 = time.perf_counter()
        chain = ctx.color_to_mass_analysis
        geometry = ctx.fluidflower.geometry
        injection = ctx.experiment.injection_protocol
        tf_g = dt.PWTransformation(supports=[0.0, 0.5, 1.0], values=[0.0, 0.0, 1.0])
        tf_aq = dt.PWTransformation(supports=[0.0, 0.05, 0.5, 1.0], values=[0.0, 0.0, 1.0, 1.0])

        def pre_mass(img):
            return img, chain.call_pH_analysis(chain.call_color_interpretation(img))

        def mass_from_pre(pre):
            img, signal = pre
            out = chain.co2_mass_analysis.mass_analysis(c_aq=tf_aq(signal), s_g=tf_g(signal))
            out.time = float(np.asarray(img.time)) / 3600.0
            return out

        def expected(t):
            return float(injection.injected_mass(date=I_START + timedelta(hours=t)))

        log = root / "l_calibration"
        sessions = []

        def calibrate():
            session = dt.TransformationCalibrationSession(
                tf_g, tf_aq, photos, dt.MultiphaseTimeSeriesAnalysis(geometry), 11.0,
                ctx.fluidflower.read_image, pre_mass, mass_from_pre, expected_mass=expected, log=log,
            )
            sessions.append(session)
            start = session.propose()
            session.auto(maxiter=L_MAXITER)
            session.accept()
            return start

        start, calibration_s, n = counted(w2p, calibrate, L_PHOTOS * I_READ_K1, "L5: the calibration session")
        launches += n
        session = sessions[0]
        errors = [it["error"] for it in session.iterations]
        if not ((log / "calibration_log.npz").exists() and errors[-1] <= start["error"]):
            raise AssertionError(f"L5: error {start['error']} -> {errors[-1]}")
        print(
            f"L5. on {card}: TransformationCalibrationSession over {L_PHOTOS} photographs (the chain split into "
            f"pre-mass and mass-from-pre), Nelder-Mead maxiter {L_MAXITER}: {len(errors)} proposals, error "
            f"{start['error']:.6g} at the start -> {errors[-1]:.6g} (lowest {min(errors):.6g}), log written; "
            f"{calibration_s:.2f} s ({time.perf_counter() - t_l5:.2f} s with the set-up)"
        )
        result["calibration_s"] = calibration_s

        # L6. The numerics utilities at 4K.
        t_l6 = time.perf_counter()
        frame = torch.from_numpy(lanes["rig"]["frame"]).to(device)
        moved = torch.roll(frame, L_SHIFT, dims=1)
        src, dst, ok = dt.FeatureDetection(device=dev).find_matches(frame, moved)
        shift = np.median(dst - src, axis=0)
        if not (ok and abs(shift[0]) <= 0.05 and abs(shift[1] - L_SHIFT) <= 0.05):
            raise AssertionError(f"L6: find_matches shift {shift}, {len(src)} matches")
        # The first swatch as rig_frame paints it (8 bits, truncated).
        swatch = dt.ColorCheckerAfter2014().swatches_rgb[0, 0]
        painted = (swatch * 255).astype(np.uint8) / 255.0
        r0, c0 = CHECKER_AT
        found = np.asarray(dt.detect_color(frame.to(torch.float32) / 255, painted, tolerance=1e-3))
        in_swatch = (found[:, 0] >= r0) & (found[:, 0] < r0 + SWATCH_PX) & (found[:, 1] >= c0) & (found[:, 1] < c0 + SWATCH_PX)
        if int(in_swatch.sum()) != SWATCH_PX**2:
            raise AssertionError(f"L6: detect_color found {int(in_swatch.sum())} swatch pixels of {SWATCH_PX ** 2}")
        n = 256
        mass_term, convection = 1.0, 0.4

        def stencil(v, skew: float):
            u = v.reshape(n, n)
            out = (4.0 + mass_term) * u
            out[1:] -= u[:-1]
            out[:-1] -= u[1:]
            out[:, 1:] -= u[:, :-1]
            out[:, :-1] -= u[:, 1:]
            if skew:
                out[:, :-1] += skew * u[:, 1:]
            return out.reshape(-1)

        import scipy.sparse as sps
        import scipy.sparse.linalg  # noqa: F401

        lap = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
        eye = sps.eye(n)
        matrix = (sps.kron(lap, eye) + sps.kron(eye, lap) + mass_term * sps.eye(n * n)).tocsc()
        rhs = np.random.default_rng(15).normal(size=n * n)
        agreement = {}
        for name, skew in (("cg", 0.0), ("gmres", convection)):
            A = matrix if not skew else (matrix + skew * sps.kron(eye, sps.diags([1.0], [1], shape=(n, n)))).tocsc()
            exact = sps.linalg.spsolve(A, rhs)
            t0 = time.perf_counter()
            got, info = getattr(dt, f"linalg_{name}")(
                lambda v, skew=skew: stencil(v, skew), torch.from_numpy(rhs).to(device), tol=1e-9
            )
            seconds_solve = time.perf_counter() - t0
            rel = float(np.linalg.norm(got - exact) / np.linalg.norm(exact))
            if not (info == 0 and rel <= 1e-6):
                raise AssertionError(f"L6: linalg_{name} rel {rel}")
            agreement[name] = (rel, seconds_solve)
        print(
            f"L6. on {card}: find_matches on the 4K frame and its copy shifted {L_SHIFT} px: {len(src)} matches, "
            f"shift {np.round(shift, 4).tolist()}; detect_color found the painted swatch ({SWATCH_PX ** 2} px, "
            f"{len(found)} in all); on a {n}x{n} TPFA operator as a callable on the card: "
            + ", ".join(f"linalg_{k} rel {v[0]:.2e} against scipy's sparse solve ({v[1]:.2f} s)" for k, v in agreement.items())
            + f"; {time.perf_counter() - t_l6:.2f} s"
        )
        if keep:
            result["handoff"] = {"root": root, "rig": rig4, "labels": ctx.fluidflower.labels}
    finally:
        if "handoff" not in result:
            shutil.rmtree(root, ignore_errors=True)
    if launches != K1_IN_L:
        raise AssertionError(f"L: {launches} K1 launches, want {K1_IN_L}")
    result["phase_s"] = time.perf_counter() - tic
    print(f"L. phase {result['phase_s']:.2f} s, {launches} K1 launches")
    return {"launches": launches, **result}


# ---------------------------------------------------------------- phase M
M_QUALITY = 95  # JPEG quality of the written photographs
M_BLOCK = 16  # px: the ROI photograph's marks, on the JPEG's 16-px blocks
M_MARKS = ((16, 16), (1760, 16), (1760, 3152), (16, 3152))  # the marks' top-left pixels
#: The marks' pixels nearest to the frame's corners, in the crop assistant's
#: order (top left, bottom left, bottom right, top right).
M_CORNERS = [[16, 16], [1775, 16], [1775, 3167], [16, 3167]]
M_MARK_COLOUR = [255, 255, 255]
M_BACKGROUND = 118  # the ROI photograph's flat grey
#: cv2.EMD through the JAX package on the CPU (tests/test_torch_emd.py).
M_EMD_TWO_SQUARES = 0.3809106647968293
M_EMD_SEEDED_64 = 0.11485148221254349
M_EMD_RTOL = 1e-6
M_STOP_S = 5.0  # a stopped GUI worker has ended within this
M_WORKER_S = 300.0  # the GUI worker's whole run
M_VIDEO_SHAPE = (446, 794)  # the videos' frames: near a quarter of the photograph, even for the mp4 encoder
# K1 launches: M2 the analysis CLI over the JPEG photographs and over their
# decoded npz copies (each a freshly loaded rig: its grid, then every
# photograph read once); M4 two reads through the new curvature correction
# alone (its grid: X and Y through the crop's warp, a pair each; then a pair
# per read; the plain-K1 read not counted); M5 the GUI worker's step, counted
# in the worker's process and reported over its progress queue (the loaded
# rig's grid, then every photograph read once).
M2_K1 = 2 * (H_GRID_K1 + L_PHOTOS * I_READ_K1)
M4_K1 = 2 * 2 + 2 * 2
M5_K1 = H_GRID_K1 + L_PHOTOS * I_READ_K1
K1_IN_M = M2_K1 + M4_K1 + M5_K1


def m_photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth photograph-like content, uint8 RGB (tests/test_torch_transfer.py's
    ``_photo_like``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    chans = []
    for k in range(3):
        a, b, c = rng.uniform(0.5, 2.0, 3)
        chans.append(np.clip(0.5 + 0.4 * np.sin(a * 4 * xx + k) * np.cos(b * 3 * yy) + 0.05 * c, 0, 1))
    return (np.stack(chans, axis=-1) * 255).astype(np.uint8)


def m_roi_photo() -> np.ndarray:
    """The ROI photograph: flat grey with four white marks near the corners."""
    roi = np.full((H, W, 3), M_BACKGROUND, np.uint8)
    for r0, c0 in M_MARKS:
        roi[r0 : r0 + M_BLOCK, c0 : c0 + M_BLOCK] = M_MARK_COLOUR
    return roi


def m_mass_tables(root: Path, photos: Path, protocols: Path, results: Path, suffix: str) -> dict:
    """Phase J's config over the photographs in ``photos`` (imaging protocol
    in ``protocols``), the mass step only, its field exported as npy.  The
    config's baseline (only its suffix matters to the run: it selects the
    photographs) is phase I's, as ``suffix``."""
    tables = j_tables(root, protocols)
    tables["data"]["folder"] = photos
    tables["data"]["baseline"] = root / ("images" if suffix == ".npz" else "m_baseline") / f"img_00000{suffix}"
    tables["data"]["results"] = results
    tables["rig"]["path"] = root / "results" / "setup" / "rig"  # phase I's rig
    results.mkdir(exist_ok=True)
    tables["analysis"] = {
        "formats": ["npy"],
        "mass": {"color": "co2", "roi": list(J_ROIS), "export": ["mass"]},
    }
    return tables


def m_protocols(root: Path, folder: Path, names: list) -> Path:
    """An imaging protocol of ``names`` (phase L's times) and phase J's
    injection protocol, in ``folder``."""
    import shutil

    folder.mkdir()
    (folder / "imaging.csv").write_text(
        "path,image_id,datetime\n"
        + "".join(
            f"{name},{k},{(L_START + timedelta(hours=k - 1)).isoformat(sep=' ')}\n"
            for k, name in enumerate(names, start=1)
        )
    )
    shutil.copy(root / "analysis" / "injection.csv", folder / "injection.csv")
    return folder


def analysis_mass_from_context(ctx, show: bool = False, stream_callback=None, progress_callback=None):
    """Phase M5's step in the GUI worker's process: the port's mass step,
    then the worker's K1 launches (counted from the process's start) and
    its device reported over the progress queue.  Phase M5 points the
    registry's "analysis: mass" here for its run; the name keeps the
    worker's colour-to-mass context."""
    from darsia_tpu_torch.ops import warp2pass as w2p
    from darsia_tpu_torch.presets.workflows.analysis import analysis_mass

    progress_callback({"event": "smoke_worker", "entered_unix": time.time()})
    rows = analysis_mass.analysis_mass_from_context(
        ctx, show=show, stream_callback=stream_callback, progress_callback=progress_callback
    )
    if ctx.fluidflower.baseline.img.is_cuda:
        torch.cuda.synchronize()
    progress_callback(
        {
            "event": "smoke_worker",
            "launches": read_counts(w2p),
            "rows": len(rows),
            "device": str(ctx.fluidflower.baseline.img.device),
        }
    )
    return rows


def m_media(dt, root: Path, jpg_dir: Path, frame: np.ndarray, card: str) -> None:
    """Phase M6: ``build_media`` over the JPEG photographs in ``jpg_dir``
    (mp4 and avi, each opened and its frames counted), and
    ``render_active_region`` of ``frame`` on the card against the CPU."""
    import cv2

    from darsia_tpu_torch.presets.workflows.utils import build_media, roi_visualization

    t_m6 = time.perf_counter()
    media = root / "m_media.toml"
    media.write_text(
        toml_text(
            {
                "data": {"results": root / "m_media"},
                "video": {
                    "folder": root / "m_media" / "videos",
                    "source": {"folder": jpg_dir, "extensions": [".jpg"], "sorting": "name"},
                    "output": {"formats": ["mp4", "avi"], "fps": 2.0, "resolution": list(M_VIDEO_SHAPE), "filename": "m6"},
                },
            }
        )
    )
    written = build_media(media)
    frame_counts = {}
    for fmt, path in written.items():
        capture = cv2.VideoCapture(str(path))
        count = 0
        while capture.isOpened():
            ok, shot = capture.read()
            if not ok:
                break
            if shot.shape[:2] != M_VIDEO_SHAPE:
                raise AssertionError(f"M6: {fmt} frame {shot.shape}")
            count += 1
        capture.release()
        frame_counts[fmt] = count
    if frame_counts != {"mp4": L_PHOTOS, "avi": L_PHOTOS}:
        raise AssertionError(f"M6: frames per video {frame_counts}")
    unit = frame.astype(np.float32) / 255.0
    photo = dt.OpticalImage(unit, **META)
    mask = roi_visualization.build_active_mask_from_rois({"left": dt.make_coordinate(J_ROIS["left"])}, photo)
    rendered = roi_visualization.render_active_region(photo, mask)
    host_photo = dt.OpticalImage(torch.from_numpy(unit), **META)
    host = roi_visualization.render_active_region(host_photo, mask.cpu())
    if not (
        rendered.image.device.type == "cuda"
        and torch.equal(rendered.image.cpu(), host.image)
        and len(rendered.contours) == len(host.contours)
        and all(np.array_equal(a, b) for a, b in zip(rendered.contours, host.contours))
    ):
        raise AssertionError("M6: render_active_region on the card differs from the CPU")
    print(
        f"M6. on {card}: build_media over the 4 JPEG photographs: {', '.join(f'{k} {v.name}' for k, v in written.items())}, "
        f"each with {L_PHOTOS} frames of {M_VIDEO_SHAPE}; render_active_region of the left ROI on the card "
        f"equal to the CPU's ({len(rendered.contours)} contour); {time.perf_counter() - t_m6:.2f} s"
    )


def phase_photographs(dt, w2p, lanes, handoff: dict, device, card: str) -> dict:
    """Phase M: photographs through OpenCV (JPEG, PNG, TIFF written and read
    back, the YUV 4:2:0 transfer), JPEG photographs through the rig's
    analysis CLI, the earth mover's distance, the crop assistant with
    ``SimpleFluidFlower.setup_curvature_correction``, the label assistant,
    a GUI worker on the card, and the media utilities."""
    import logging
    import shutil
    import warnings

    import cv2

    from darsia_tpu_torch.presets.workflows import user_interface_analysis
    from darsia_tpu_torch.presets.workflows import user_interface_gui as gui
    from darsia_tpu_torch.presets.workflows.analysis import analysis_context
    from darsia_tpu_torch.utils.transfer import reconstruct_rgb_yuv420, split_rgb_yuv420

    warnings.filterwarnings("ignore", message="Section .* not found")
    warnings.filterwarnings("ignore", message="No time information")
    tic = time.perf_counter()
    dev = None if device.type == "cuda" else device
    root = handoff["root"]
    launches = 0
    result: dict = {}
    try:
        # M1. Phase L's photographs written as JPEG, PNG and TIFF by the
        # port from the card, the bytes OpenCV's; read back onto the card.
        t_m1 = time.perf_counter()
        frames = [l_photo(lanes["rig"]["frame"], k) for k in range(1, L_PHOTOS + 1)]
        jpg_dir, lossless = root / "m_jpg", root / "m_lossless"
        jpg_dir.mkdir()
        lossless.mkdir()
        jpgs, write_ms = [], {}
        for k, frame in enumerate(frames, start=1):
            image = dt.OpticalImage(frame, **META)
            if image.img.device.type != "cuda":
                raise AssertionError(f"M1: the photograph lies on {image.img.device}")
            suffixes = (".jpg", ".png", ".tif") if k == 1 else (".jpg",)
            for suffix in suffixes:
                path = (jpg_dir if suffix == ".jpg" else lossless) / f"img_{k:05d}{suffix}"
                params = [int(cv2.IMWRITE_JPEG_QUALITY), M_QUALITY] if suffix == ".jpg" else []
                t0 = time.perf_counter()
                image.write(path, quality=M_QUALITY)
                write_ms.setdefault(suffix, []).append(1e3 * (time.perf_counter() - t0))
                ok, want = cv2.imencode(suffix, np.ascontiguousarray(frame[..., ::-1]), params)
                if not (ok and path.read_bytes() == want.tobytes()):
                    raise AssertionError(f"M1: {path.name} differs from cv2.imencode")
                if suffix == ".jpg":
                    jpgs.append(path)
            if k == 1:
                encoded = image.encode(".png")
                ok, want = cv2.imencode(".png", np.ascontiguousarray(frame[..., ::-1]), [int(cv2.IMWRITE_PNG_COMPRESSION), 6])
                if encoded != want.tobytes():
                    raise AssertionError("M1: encode('.png') differs from cv2.imencode")
        decode_ms, yuv_ms, transfer_bytes = [], [], {}
        for path in [*jpgs, lossless / "img_00001.png", lossless / "img_00001.tif"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            read = dt.imread(path)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            yuv = dt.imread(path, transfer="yuv420")
            torch.cuda.synchronize()
            yuv_s = time.perf_counter() - t0
            if path.suffix == ".jpg":
                decode_ms.append(1e3 * plain_s)
                yuv_ms.append(1e3 * yuv_s)
            host = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)
            if not (read.img.device.type == "cuda" and np.array_equal(read.img.cpu().numpy(), host)):
                raise AssertionError(f"M1: {path.name}: the read differs from cv2.imread")
            if path.suffix != ".jpg" and not np.array_equal(host, frames[0]):
                raise AssertionError(f"M1: {path.name} is not the written photograph")
            planes = split_rgb_yuv420(host)
            if not torch.equal(yuv.img, reconstruct_rgb_yuv420(*planes)):
                raise AssertionError(f"M1: {path.name}: the yuv420 read differs from the reconstruction of cv2's planes")
            transfer_bytes = {"rgb": host.nbytes, "yuv420": sum(p.nbytes for p in planes)}
            err = (yuv.img.float() - read.img.float()).abs()
            result.setdefault("yuv_err", []).append((path.name, float(err.mean()), float(torch.quantile(err.flatten()[::97], 0.99))))
        # The transfer's bound (tests/test_torch_transfer.py) holds on
        # photograph-like content; phase L's frames are iid noise, whose
        # chroma 4:2:0 cannot carry, so there it is printed only.
        smooth = m_photo_like(H, W, seed=7)
        smooth_path = lossless / "smooth.jpg"
        dt.OpticalImage(smooth, **META).write(smooth_path, quality=M_QUALITY)
        full = dt.imread(smooth_path).img.float()
        err = (dt.imread(smooth_path, transfer="yuv420").img.float() - full).abs()
        smooth_err = (float(err.mean()), float(torch.quantile(err.flatten()[::13], 0.99)))
        if not (smooth_err[0] < 1.0 and smooth_err[1] <= 4.0):
            raise AssertionError(f"M1: yuv420 on smooth content mean {smooth_err[0]}, p99 {smooth_err[1]}")
        scalar = dt.ScalarImage(torch.from_numpy(frames[0][..., 1].astype(np.float32) / 255.0).to(device), **META)
        for suffix in (".png", ".jpg", ".tif"):
            path = lossless / f"scalar{suffix}"
            scalar.write(path)
            want = (np.clip(scalar.img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            params = [int(cv2.IMWRITE_JPEG_QUALITY), 90] if suffix == ".jpg" else []
            ok, buf = cv2.imencode(suffix, want, params)
            if path.read_bytes() != buf.tobytes():
                raise AssertionError(f"M1: ScalarImage.write({suffix}) differs from cv2.imencode")
        result.update(decode_ms=float(np.median(decode_ms)), yuv_ms=float(np.median(yuv_ms)))
        print(
            f"M1. on {card}: phase L's 4 photographs written by OpticalImage.write from the card as JPEG "
            f"(quality {M_QUALITY}; ms {[round(v, 1) for v in write_ms['.jpg']]}), the first also as PNG "
            f"({write_ms['.png'][0]:.1f} ms) and TIFF ({write_ms['.tif'][0]:.1f} ms), bytes equal to cv2.imencode, "
            f"encode('.png') too; imread onto the card bitwise cv2.imread + cvtColor: host decode + copy ms per "
            f"JPEG {[round(v, 1) for v in decode_ms]} (median {result['decode_ms']:.1f}), yuv420 "
            f"{[round(v, 1) for v in yuv_ms]} (median {result['yuv_ms']:.1f}); bytes to the card per photograph "
            f"{transfer_bytes['rgb']} (RGB) and {transfer_bytes['yuv420']} (yuv420); the yuv420 read bitwise the "
            f"reconstruction of cv2's planes, against the full read on a smooth 4K JPEG mean |diff| "
            f"{smooth_err[0]:.3f}, p99 {smooth_err[1]:.1f} (bound 1.0, 4); on phase L's noise frames "
            + ", ".join(f"{n} {m:.2f}/{q:.0f}" for n, m, q in result.pop("yuv_err")[:2])
            + f" (not gated); ScalarImage.write png/jpg/tif of a card image equal to cv2.imencode; "
            f"{time.perf_counter() - t_m1:.2f} s"
        )

        # M2. The analysis CLI's mass step over the 4 JPEG photographs and
        # over npz files that hold exactly their decoded arrays.
        t_m2 = time.perf_counter()
        npz_dir = root / "m_npz"
        npz_dir.mkdir()
        for path in jpgs:
            dt.imread(path, device="cpu").save(npz_dir / f"{path.stem}.npz")
        (root / "m_baseline").mkdir()
        dt.imread(root / "images" / "img_00000.npz", device="cpu").write(root / "m_baseline" / "img_00000.jpg")
        configs = {}
        for kind, folder in (("jpg", jpg_dir), ("npz", npz_dir)):
            names = [f"{p.stem}.{kind}" for p in jpgs]
            protocols = m_protocols(root, root / f"m_protocols_{kind}", names)
            configs[kind] = root / f"m_{kind}.toml"
            tables = m_mass_tables(root, folder, protocols, root / f"m_results_{kind}", f".{kind}")
            configs[kind].write_text(toml_text(tables))
        runs = {}
        reads = []
        read_image = dt.Rig.read_image

        def recording(self, path):
            out = read_image(self, path)
            reads.append(Path(path).name)
            return out

        dt.Rig.read_image = recording
        try:
            for kind in ("jpg", "npz"):
                argv = ["--config", str(configs[kind]), "--mass", "--all"]
                _, seconds, n = counted(
                    w2p, lambda: user_interface_analysis.main(argv, device=dev), M2_K1 // 2, f"M2: the CLI over {kind}"
                )
                launches += n
                runs[kind] = seconds
        finally:
            dt.Rig.read_image = read_image
        logging.getLogger().setLevel(logging.WARNING)
        want_reads = [f"{p.stem}.{kind}" for kind in ("jpg", "npz") for p in jpgs]
        if sorted(reads) != sorted(want_reads):
            raise AssertionError(f"M2: reads {reads}")
        csvs = {kind: root / f"m_results_{kind}" / "mass" / "mass_analysis_results.csv" for kind in runs}
        rows = j_csv(csvs["jpg"])
        if csvs["jpg"].read_bytes() != csvs["npz"].read_bytes() or [r["image_stem"] for r in rows] != [p.stem for p in jpgs]:
            raise AssertionError("M2: the JPEG run's CSV differs from the npz run's")
        for path in jpgs:
            a, b = (np.load(root / f"m_results_{kind}" / "mass" / "mass" / "npy" / f"{path.stem}.npy") for kind in runs)
            if not np.array_equal(a, b):
                raise AssertionError(f"M2: {path.stem}: mass fields differ")
        masses = [float(r["detected_mass_total"]) for r in rows]
        read_ms = {kind: 1e3 * s / L_PHOTOS for kind, s in runs.items()}
        result.update(cli_ms=read_ms)
        print(
            f"M2. on {card}: user_interface_analysis.main(--mass --all) over the 4 JPEG photographs "
            f"{runs['jpg']:.2f} s ({read_ms['jpg']:.1f} ms per photograph with the context, of which the host "
            f"decode ~{result['decode_ms']:.1f} ms) and over their decoded npz copies {runs['npz']:.2f} s "
            f"({read_ms['npz']:.1f} ms); {len(reads)} reads, none skipped; CSVs byte for byte and mass fields "
            f"bitwise equal; masses {[f'{m:.6g}' for m in masses]}; {M2_K1} K1 launches; "
            f"{time.perf_counter() - t_m2:.2f} s"
        )

        # M3. The earth mover's distance (cv2.EMD on the host) of card images.
        t_m3 = time.perf_counter()
        meta = {"width": 1, "height": 1, "space_dim": 2, "scalar": True}

        def m3():
            src = np.zeros((10, 10))
            src[2:5, 2:5] = 1
            dst = np.zeros((10, 10))
            dst[1:3, 1:2] = 1
            dst[4:7, 7:9] = 1
            squares = [a / (a.sum() / 100) for a in (src, dst)]
            rng = np.random.default_rng(16)
            seeded = []
            for _ in range(2):
                a = np.zeros((64, 64))
                a.flat[rng.choice(64 * 64, 160, replace=False)] = rng.uniform(0.5, 1.5, 160)
                seeded.append(a / (a.sum() / 64**2))
            images = {key: [dt.Image(a, **meta) for a in arrays] for key, arrays in (("squares", squares), ("seeded", seeded))}
            got = {key: dt.wasserstein_distance(*imgs, method="cv2.emd") for key, imgs in images.items()}
            maps = images["squares"] + [dt.Image(np.roll(a, 3, axis=1), **meta) for a in squares]
            matrix = dt.EMD().distance_matrix(maps)
            options = {
                "l1_mode": dt.L1Mode.CONSTANT_CELL_PROJECTION,
                "mobility_mode": dt.MobilityMode.FACE_BASED,
                "num_iter": 400,
                "tol_residual": 1e-3,
                "tol_increment": 1e-3,
                "tol_distance": 1e-3,
                "L": 1e9,
            }
            newton = dt.wasserstein_distance(*images["squares"], method="newton", options=options)
            return images, got, matrix, newton

        (images, got, matrix, newton), _, n = counted(w2p, m3, 0, "M3: EMD")
        if images["squares"][0].img.device.type != "cuda":
            raise AssertionError("M3: the images are not on the card")
        for key, pinned in (("squares", M_EMD_TWO_SQUARES), ("seeded", M_EMD_SEEDED_64)):
            if not abs(got[key] - pinned) <= M_EMD_RTOL * pinned:
                raise AssertionError(f"M3: {key} EMD {got[key]!r}, the JAX package's {pinned!r}")
        if not (np.array_equal(matrix, matrix.T) and np.all(np.diag(matrix) == 0) and (matrix[~np.eye(4, dtype=bool)] > 0).all()):
            raise AssertionError(f"M3: distance matrix {matrix}")
        newton = float(newton)
        print(
            f"M3. on {card}: wasserstein_distance(method='cv2.emd') of card images: two squares "
            f"{got['squares']!r}, seeded 64x64 pair {got['seeded']!r}, each within {M_EMD_RTOL} relative of the "
            f"JAX package's; EMD().distance_matrix of 4 maps symmetric, zero diagonal; |EMD - Newton| / Newton "
            f"on the two squares {abs(got['squares'] - newton) / newton:.3e} (Newton {newton:.6f}, not gated); "
            f"0 K1 launches; {time.perf_counter() - t_m3:.2f} s"
        )

        # M4. The crop assistant through SimpleFluidFlower.setup_curvature_correction
        # on a marked JPEG ROI photograph; the label assistant.
        t_m4 = time.perf_counter()
        rig = handoff["rig"]
        roi_path = root / "m_roi.jpg"
        dt.OpticalImage(m_roi_photo(), **META).write(roi_path, quality=M_QUALITY)

        def m4_setup():
            return rig.setup_curvature_correction(roi_path, roi_mode="automatic", roi_color=M_MARK_COLOUR)

        curvature, setup_s, n = counted(w2p, m4_setup, 0, "M4: setup_curvature_correction")
        pts = np.asarray(rig.curvature_config["crop"]["pts_src"])
        cpu_roi = dt.resize(dt.imread(roi_path, device="cpu"), ref_image=rig.raw_baseline)
        cpu_pts = np.asarray(
            dt.CropAssistant(cpu_roi, width=rig.width, height=rig.height).from_image(color=M_MARK_COLOUR)["crop"]["pts_src"]
        )
        if not (np.abs(pts - np.asarray(M_CORNERS)).max() <= 1 and np.array_equal(pts, cpu_pts)):
            raise AssertionError(f"M4: corners {pts.tolist()} (CPU {cpu_pts.tolist()}), painted {M_CORNERS}")
        chain = [dt.TypeCorrection(np.float32), curvature]

        def m4_reads():
            first = dt.imread(jpgs[0], transformations=chain, device=dev)
            return first, dt.imread(jpgs[1], transformations=chain, device=dev)

        (first, second), reads_s, n = counted(w2p, m4_reads, M4_K1, "M4: reads through the new correction")
        launches += n
        with plain_k1(w2p):
            plain = dt.imread(jpgs[1], transformations=chain, device=dev)
        if not torch.equal(plain.img, second.img):
            raise AssertionError("M4: the read with plain K1 differs")
        shape = tuple(second.img.shape)
        labels = handoff["labels"]
        host_labels = dt.Image(labels.img.cpu(), **labels.metadata())
        ids = sorted(int(v) for v in torch.unique(labels.img).tolist())[:3]
        outs = {}
        for where, lab in (("card", labels), ("cpu", host_labels)):
            assistant = dt.LabelsAssistant(lab)
            picked = assistant.pick(ids=ids[:2])
            merged = assistant.merge(ids=ids)
            mask = dt.LabelsMaskSelectionAssistant(merged)(points=[[H // 2, W // 2]])
            outs[where] = [picked.img, merged.img, mask]
        if outs["card"][0].device.type != "cuda" or not all(
            torch.equal(a.cpu(), b) for a, b in zip(outs["card"], outs["cpu"])
        ):
            raise AssertionError("M4: the label assistant on the card differs from the CPU")
        n_labels = len(torch.unique(labels.img))
        print(
            f"M4. on {card}: SimpleFluidFlower.setup_curvature_correction(marked JPEG, 'automatic', white) "
            f"{setup_s:.2f} s: corners {pts.tolist()} within 1 px of the painted {M_CORNERS}, equal to the "
            f"CropAssistant's on a CPU copy; two reads through the new correction {reads_s:.2f} s ({M4_K1} K1 "
            f"launches, {shape}), the read with plain K1 bitwise equal; LabelsAssistant pick and merge of ids "
            f"{ids} on phase I's {n_labels} labels on the card equal to a CPU copy's; "
            f"{time.perf_counter() - t_m4:.2f} s"
        )

        # M5. A GUI session starts "analysis: mass" on the JPEG config in a
        # spawned worker on the card, and polls it to its end.
        t_m5 = time.perf_counter()
        gui_config = root / "m_gui.toml"
        gui_config.write_text(
            toml_text(m_mass_tables(root, jpg_dir, root / "m_protocols_jpg", root / "m_results_gui", ".jpg"))
        )
        session = gui.GuiSession(cache_path=root / "m_gui_session.json", device="cuda")
        session.set_config(gui_config)
        registered = gui.STEP_REGISTRY["analysis: mass"]
        gui.STEP_REGISTRY["analysis: mass"] = ("chip_smoke", "analysis_mass_from_context", "context")
        try:
            started = time.time()
            handle = session.start_step("analysis: mass", all_images=True)
        finally:
            gui.STEP_REGISTRY["analysis: mass"] = registered
        logs, events, previews = [], [], []
        deadline = time.perf_counter() + M_WORKER_S
        while time.perf_counter() < deadline:
            handle.poll(on_log=logs.append, on_progress=events.append, on_preview=previews.append)
            if handle.finished and not handle.alive():
                break
            time.sleep(0.05)
        handle.poll(on_log=logs.append, on_progress=events.append, on_preview=previews.append)
        worker_s = time.time() - started
        if not handle.finished or handle.failed:
            handle.stop()
            raise AssertionError(f"M5: the worker failed or did not finish: {logs[-3:]}")
        smoke = [e for e in events if e.get("event") == "smoke_worker"]
        progress = [e for e in events if e.get("event") == "image_progress"]
        if [e["image_index"] for e in progress] != list(range(1, L_PHOTOS + 1)):
            raise AssertionError(f"M5: progress events {[e.get('image_index') for e in progress]}")
        decoded = 0
        for payload in previews:
            for key, data in payload.items():
                if not isinstance(data, bytes) or cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None:
                    raise AssertionError(f"M5: preview {key} does not decode")
                decoded += 1
        report = smoke[-1]
        worker_k1 = report["launches"]
        check_counts(worker_k1, {"warp_rows_t": M5_K1}, "M5: the GUI worker")
        launches += worker_k1["warp_rows_t"]
        gui_csv = root / "m_results_gui" / "mass" / "mass_analysis_results.csv"
        if gui_csv.read_bytes() != csvs["jpg"].read_bytes() or not report["device"].startswith("cuda"):
            raise AssertionError(f"M5: the worker's CSV differs from M2's JPEG run (device {report['device']})")
        start_s = smoke[0]["entered_unix"] - started
        worker_ms = [1e3 * e["image_duration_s"] for e in progress]
        t_ctx = time.perf_counter()
        analysis_context.prepare_analysis_context(
            cls=dt.Rig, path=gui_config, all=True, require_color_to_mass=True, device=dev
        )
        context_s = time.perf_counter() - t_ctx
        stopped = session.start_step("analysis: mass", all_images=True)
        time.sleep(2.0)
        t0 = time.perf_counter()
        stopped.stop()
        stop_s = time.perf_counter() - t0
        if stopped.alive() or stop_s > M_STOP_S:
            raise AssertionError(f"M5: stop() took {stop_s:.2f} s, alive {stopped.alive()}")
        session.stop_all()
        result.update(worker_start_s=start_s, worker_ms=float(np.mean(worker_ms)), worker_s=worker_s)
        print(
            f"M5. on {card}: GuiSession.start_step('analysis: mass') on the card in a spawned worker: "
            f"finished in {worker_s:.2f} s; its step entered {start_s:.2f} s after the start (spawn, imports, "
            f"CUDA initialisation and the context; the same context in this process {context_s:.2f} s); ms per "
            f"photograph in the worker {[round(v, 1) for v in worker_ms]}; {len(progress)} progress events, "
            f"{decoded} PNG previews decoded, no error; the CSV byte for byte M2's JPEG run's; K1 launches "
            f"counted in the worker and reported over its progress queue: {worker_k1['warp_rows_t']}; a second "
            f"worker stopped after 2 s ended in {stop_s:.2f} s; {time.perf_counter() - t_m5:.2f} s"
        )

        # M6. The media utility over the JPEG photographs; the active
        # region rendered on the card.
        m_media(dt, root, jpg_dir, frames[-1], card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if launches != K1_IN_M:
        raise AssertionError(f"M: {launches} K1 launches, want {K1_IN_M}")
    result["phase_s"] = time.perf_counter() - tic
    print(f"M. phase {result['phase_s']:.2f} s, {launches} K1 launches ({M5_K1} of them in the GUI worker)")
    return {"launches": launches, **result}


# ---------------------------------------------------------------- phase N
# The multi-device layer (darsia_tpu_torch/parallel/) on meshes that name
# the card 8 times, after __graft_entry__.py:54-383, the JAX package's
# multi-device dry run.  N1: its production configuration (the bench frame's
# size, shape-preserving corrections, 8x16 patches, 10 Jacobi sweeps) on
# N_FRAMES seeded frames.
N_FRAMES = 4
N_MESHES = ((2, 4), (1, 8))
N_BULGE = {"horizontal_bulge": -5e-10, "vertical_bulge": -1e-8, "vertical_center_offset": -31}
N_REST = {"mu": 1.0, "omega": 0.2, "maxiter": 10}
N_TIMED = 1  # timed calls of the N_FRAMES frames, per mesh and for the public lane
# The dry run's Newton options; the CG tolerance 1e-5, not the default 1e-6,
# which lies at float32's floor on these problems: there the CG's iteration
# counts swing with the rounding of its sums (two-level at 256^2: 42 Newton
# and 3650 CG iterations in one arithmetic, 108 and 15291 in another).
N_W1 = {"num_iter": 200, "tol_increment": 1e-4, "tol_distance": 1e-4, "aa_depth": 5, "cg_tol": 1e-5}
# The dry run's 256^2 for two-level.  Jacobi's CG at 256^2 runs at its cap of
# 500 iterations per Newton step (94.5 s on an H100 at 700 W), so N5's Jacobi
# solve runs at 128^2, its CG capped at 200 iterations as the single-device
# solver caps its multigrid CG (at 500 it took 126.75 s there: 80 Newton
# iterations of ~370 CG iterations).
N_W1_SIZE = {"jacobi": 128, "two_level": 256}
N_JACOBI_CG_MAXITER = 200
# The sharded solves' Newton cap (the dry run's is 200): with AA(5) their
# iteration counts swing with the rounding of the sums (two-level at 256^2:
# 42 Newton iterations in one arithmetic, 108-113 in another, 72.6 s on an
# H100 at 700 W); the gate reads the distance.
N_NEWTON_CAP = 60
N_MAX_DISP = 120  # the registration's bound
# N2: (rows, cols, tol, maxiter).  At 64x16 the dry run's tol 1e-8 lies below
# float32's floor (the CG then stops on its health test or runs to its cap of
# 2000, as its rounding decides), so 1e-6; at 1024^2 the CG runs to its cap
# either way, 1000 iterations.
N_TPFA = ((64, 16, 1e-6, 2000), (1024, 1024, 1e-8, 1000))
N_WARPS = ((256, 256, 8), (H, W, 120))  # N3: (rows, cols, D)
# K1: the corrected baseline (the new curvature correction's pull-back grid,
# X and Y through the bulge, a pair each, then the chain's pair), then 4
# per public-lane frame (the gated frames and the timed ones); the sharded
# calls, the gather-warp reference and N2-N5 launch none.
K1_IN_N = 2 * 2 + 2 + 4 * N_FRAMES * (1 + N_TIMED)


@contextlib.contextmanager
def gather_warps(dt):
    """The public lane's warps through the exact gather warp
    (``warp_backend(force="gather")``), for a reference that warps as the
    sharded pipeline does; K1 is not called."""
    import functools

    from darsia_tpu_torch.analysis import fusedpipeline, translationanalysis
    from darsia_tpu_torch.corrections import fuse
    from darsia_tpu_torch.ops.warp import warp_backend

    modules = (fuse, translationanalysis, fusedpipeline)
    gather = functools.partial(warp_backend, force="gather")
    for module in modules:
        module.warp_backend = gather
    try:
        yield
    finally:
        for module in modules:
            module.warp_backend = warp_backend


def n_sync_s(fn):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - tic


def n_pipeline(dt, w2p, device, card: str) -> dict:
    """N1: ``sharded_production_pipeline`` against the public lane."""
    from darsia_tpu_torch.corrections.fuse import fused_chain
    from darsia_tpu_torch.parallel import create_mesh, sharded_production_pipeline

    rng = np.random.default_rng(1)
    base_u8 = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    frames = torch.from_numpy(
        np.stack([np.roll(base_u8, shift=(2 + k, 3), axis=(0, 1)) for k in range(N_FRAMES)])
    ).to(device)
    meta = {"width": 2.8, "height": 1.5}
    corrections = [dt.TranslationCorrection([2.0, -3.0]), dt.CurvatureCorrection(config={"bulge": N_BULGE})]
    reset_counts(w2p)
    base_img = dt.OpticalImage(
        torch.from_numpy(base_u8).to(device), transformations=corrections, **meta
    ).img_as(torch.float32)
    launches = read_counts(w2p)["warp_rows_t"]
    analysis = dt.ConcentrationAnalysis(
        base=base_img,
        signal_reduction=dt.MonochromaticReduction(color="gray"),
        restoration=lambda s: dt.H1_regularization(
            s, mu=N_REST["mu"], omega=N_REST["omega"], dim=2, solver=dt.Jacobi(maxiter=N_REST["maxiter"])
        ),
        model=dt.LinearModel(scaling=2.0),
        **{"diff option": "positive"},
    )
    registration = dt.ImageRegistration(base_img, N_patches=[8, 16], rel_overlap=0.1, quality_tol=0.02)
    chain = fused_chain(corrections, (H, W), device)
    pipe = dt.FusedAnalysisPipeline(
        transformations=corrections, registration=registration, analysis=analysis, max_disp=N_MAX_DISP
    )
    images = [dt.OpticalImage(frames[k], **meta) for k in range(N_FRAMES)]

    # The references: the public lane with the gather warp, and with K1.
    with gather_warps(dt):
        reset_counts(w2p)
        gather_ref = [pipe(image).img for image in images]
        check_counts(read_counts(w2p), {}, "N1: the gather-warp reference")
    reset_counts(w2p)
    public = [pipe(image).img for image in images]
    _, public_s = n_sync_s(lambda: [pipe(image).img for _ in range(N_TIMED) for image in images])
    counts = read_counts(w2p)
    check_counts(counts, {"warp_rows_t": 4 * N_FRAMES * (1 + N_TIMED)}, "N1: the public lane")
    launches += counts["warp_rows_t"]
    out = {"public_ms": public_s / (N_TIMED * N_FRAMES) * 1e3}

    for shape in N_MESHES:
        mesh = create_mesh(shape, ("batch", "space"), devices=[device] * 8)
        step, setup_s = n_sync_s(
            lambda: sharded_production_pipeline(
                mesh, chain, analysis, (H, W), N_REST, registration=registration, max_disp=N_MAX_DISP
            )
        )
        reset_counts(w2p)
        conc, first_s = n_sync_s(lambda: step(frames, base_img.img))
        _, timed_s = n_sync_s(lambda: [step(frames, base_img.img) for _ in range(N_TIMED)])
        check_counts(read_counts(w2p), {}, f"N1: sharded pipeline on {shape}")
        if tuple(conc.shape) != (N_FRAMES, H, W) or not bool(torch.isfinite(conc).all()):
            raise AssertionError(f"N1 {shape}: bad concentration, shape {tuple(conc.shape)}")
        gather_err = [(conc[k] - gather_ref[k]).abs() for k in range(N_FRAMES)]
        g_max = max(float(e.max()) for e in gather_err)
        g_mean = max(float(e.mean()) for e in gather_err)
        k1_mean = max(float((conc[k] - public[k]).abs().mean()) for k in range(N_FRAMES))
        # The gather-warp reference: the dry run's gate
        # (__graft_entry__.py:186-204); the K1 lane: phase 5's full-path
        # tier (K1 is not exact bilinear).
        if not (g_max <= 2e-3 and g_mean <= 5e-5 and k1_mean <= 1e-3):
            raise AssertionError(
                f"N1 {shape}: vs the gather-warp lane max {g_max} mean {g_mean}, vs the K1 "
                f"lane mean {k1_mean}"
            )
        pad = -(-H // shape[1]) * shape[1] - H
        ms = timed_s / (N_TIMED * N_FRAMES) * 1e3
        out[shape] = {"ms": ms, "max": g_max, "mean": g_mean, "k1_mean": k1_mean}
        print(
            f"N1. sharded_production_pipeline on a {shape} (batch, space) mesh of {device} x 8, "
            f"{N_FRAMES} frames {H}x{W} uint8 ({pad} pad rows) on {card}: {ms:.1f} ms per frame "
            f"({N_TIMED} calls of {N_FRAMES} frames; first call {first_s:.2f} s, set-up "
            f"{setup_s:.2f} s), 0 K1 launches; vs the public lane with the gather warp max "
            f"{g_max:.3e} mean {g_mean:.3e} (gate 2e-3 / 5e-5), vs the public K1 lane mean "
            f"{k1_mean:.3e} (gate 1e-3)"
        )
    print(
        f"N1. the public lane (FusedAnalysisPipeline, K1) on the same frames: "
        f"{out['public_ms']:.2f} ms per frame; {launches} K1 launches with the baseline's pair"
    )
    out["launches"] = launches
    return out


def n_tpfa(dt, device, card: str) -> dict:
    """N2: ``sharded_tpfa_cg`` over 8 shards against ``tpfa_cg``."""
    from darsia_tpu_torch.measure.beckmann_kernels import tpfa_cg
    from darsia_tpu_torch.parallel import create_mesh, sharded_tpfa_cg

    mesh = create_mesh((8,), ("space",), devices=[device] * 8)
    rng = np.random.default_rng(1)
    out = {}
    for Hs, Ws, tol, maxiter in N_TPFA:
        tr = torch.from_numpy((rng.random((Hs - 1, Ws)) + 0.5).astype(np.float32)).to(device)
        tc = torch.from_numpy((rng.random((Hs, Ws - 1)) + 0.5).astype(np.float32)).to(device)
        rhs = rng.standard_normal((Hs, Ws)).astype(np.float32)
        rhs = torch.from_numpy(rhs - rhs.mean()).to(device)
        p, sharded_s = n_sync_s(lambda: sharded_tpfa_cg(mesh, (Hs, Ws), tol=tol, maxiter=maxiter)(tr, tc, rhs))
        q, single_s = n_sync_s(
            lambda: tpfa_cg((tr, tc), rhs, torch.zeros_like(rhs), dim=2, tol=tol, maxiter=maxiter)
        )
        a, b = p - p.mean(), q - q.mean()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        if not (bool(torch.isfinite(p).all()) and err <= 1e-3 * max(scale, 1e-30)):
            raise AssertionError(f"N2 {Hs}x{Ws}: sharded vs single {err} of scale {scale}")
        out[(Hs, Ws)] = {"sharded_s": sharded_s, "single_s": single_s, "rel": err / scale}
        print(
            f"N2. sharded_tpfa_cg {Hs}x{Ws} over {device} x 8 (tol {tol}, maxiter {maxiter}) on "
            f"{card}: {sharded_s:.3f} s (tpfa_cg on one device {single_s:.3f} s); up to the "
            f"constant, max|diff| {err:.3e} of the scale {scale:.3e} (gate 1e-3)"
        )
    return out


def n_warp(dt, device, card: str) -> dict:
    """N3: ``sharded_warp`` and ``sharded_tvd_2d`` on a (rows 2, cols 4) mesh."""
    from darsia_tpu_torch.ops.warp import identity_grid, warp
    from darsia_tpu_torch.parallel import create_mesh, sharded_tvd_2d, sharded_warp
    from darsia_tpu_torch.parallel.pipeline import _local_smooth_sweeps

    mesh = create_mesh((2, 4), ("rows", "cols"), devices=[device] * 8)
    rng = np.random.default_rng(1)
    out = {}
    for Hw, Ww, Dw in N_WARPS:
        img = torch.from_numpy(rng.random((Hw, Ww, 3)).astype(np.float32)).to(device)
        yy, xx = np.meshgrid(np.linspace(0, np.pi, Hw), np.linspace(0, np.pi, Ww), indexing="ij")
        disp = np.stack([Dw * 0.9 * np.sin(2 * xx), -Dw * 0.9 * np.cos(yy)]).astype(np.float32)
        coords = identity_grid((Hw, Ww), device) + torch.from_numpy(disp).to(device)
        apply = sharded_warp(mesh, (Hw, Ww), max_disp=Dw)
        warped, s = n_sync_s(lambda: apply(img, coords))
        ref = warp(img, coords, order=1)
        err = float((warped - ref).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"N3 {Hw}x{Ww}: sharded warp vs warp {err}")
        out[(Hw, Ww)] = {"s": s, "err": err}
        print(
            f"N3. sharded_warp {Hw}x{Ww}x3 (D = {Dw}) on a (2, 4) mesh of {device} x 8 on "
            f"{card}: {s * 1e3:.1f} ms, max|diff| to warp {err:.3e} (gate 1e-4)"
        )
    gray = img @ torch.tensor([0.299, 0.587, 0.114], device=device)
    smooth, s = n_sync_s(lambda: sharded_tvd_2d(mesh, mu=0.15, iters=5)(gray))
    err = float((smooth - _local_smooth_sweeps(gray, gray, 0.15, 1.0, 5)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"N3: sharded_tvd_2d vs the sweeps {err}")
    print(f"N3. sharded_tvd_2d {H}x{W} (5 sweeps): {s * 1e3:.1f} ms, max|diff| {err:.3e} (gate 1e-5)")
    return out


def n_batch(dt, device, card: str) -> dict:
    """N4: ``sharded_wasserstein_batch`` of 8 pairs against ``batched_wasserstein``."""
    from darsia_tpu_torch.parallel import batched_wasserstein, create_mesh, sharded_wasserstein_batch

    nw = 10
    src0 = np.zeros((nw, nw))
    src0[2:5, 2:5] = 1
    dst0 = np.zeros((nw, nw))
    dst0[1:3, 1:2] = 1
    dst0[4:7, 7:9] = 1
    srcs, dsts = [], []
    for i in range(8):
        r = np.random.default_rng(10 + i)
        s = src0 + 0.02 * r.random((nw, nw))
        d = dst0 + 0.02 * r.random((nw, nw))
        srcs.append(s / (s.sum() * 0.01))
        dsts.append(d / (d.sum() * 0.01))
    srcs = torch.from_numpy(np.stack(srcs).astype(np.float32)).to(device)
    dsts = torch.from_numpy(np.stack(dsts).astype(np.float32)).to(device)
    options = {"num_iter": 150, "tol_distance": 1e-5}
    mesh = create_mesh((8,), ("batch",), devices=[device] * 8)
    (dist, _, status), s = n_sync_s(
        lambda: sharded_wasserstein_batch(mesh, (nw, nw), voxel_size=0.1, options=options)(srcs, dsts)
    )
    (ref, _, _), ref_s = n_sync_s(
        lambda: batched_wasserstein((nw, nw), voxel_size=0.1, options=options)(srcs, dsts)
    )
    err = float(np.abs(dist - ref).max())
    if not ((status == 1).all() and err <= 1e-4):
        raise AssertionError(f"N4: statuses {status}, vs the batch {err}")
    print(
        f"N4. sharded_wasserstein_batch, 8 pairs {nw}x{nw} over {device} x 8 on {card}: {s:.2f} s "
        f"(batched_wasserstein on one device {ref_s:.2f} s), all converged, max|diff| {err:.3e} "
        "(gate 1e-4)"
    )
    return {"s": s, "batch_s": ref_s, "err": err}


def n_cg_launches(solve_fn, mass_diff) -> float:
    """Launches (tensor ops, views excluded) per CG iteration of a sharded
    Newton solve: one Newton iteration with the CG run to 2 and to 4
    iterations (tolerance 0), differenced."""
    counts = []
    for maxiter in (2, 4):
        solve = solve_fn(num_iter=1, cg_tol=0.0, cg_maxiter=maxiter)
        torch.cuda.synchronize()
        with OpCounter() as counter:
            solve(mass_diff)
            torch.cuda.synchronize()
        counts.append(counter.n)
    return (counts[1] - counts[0]) / 2


def n_problem(ns: int, device) -> torch.Tensor:
    """The dry run's spatial W1 problem (__graft_entry__.py:330-336) at
    ns x ns: src - dst, unit mean mass each."""
    src = np.zeros((ns, ns))
    src[2 : ns // 3, 2 : ns // 3] = 1
    dst = np.zeros((ns, ns))
    dst[ns // 2 :, ns // 2 :] = 1
    src, dst = src / src.sum() * ns * ns, dst / dst.sum() * ns * ns
    return torch.from_numpy((src - dst).astype(np.float32)).to(device)


def n_newton(dt, device, card: str) -> dict:
    """N5: ``sharded_beckmann_newton`` over 8 shards against the
    single-device Newton solve: Jacobi called directly, two-level through
    ``wasserstein_distance(method="sharded_newton")``."""
    import functools

    from darsia_tpu_torch.parallel import create_mesh, sharded_beckmann_newton
    from darsia_tpu_torch.parallel import tpfa as ptpfa

    mesh = create_mesh((8,), ("space",), devices=[device] * 8)
    out, single = {}, {}
    for precond, ns in N_W1_SIZE.items():
        md = n_problem(ns, device)
        if ns not in single:
            solver = dt.BeckmannNewtonSolver(
                dt.Grid((ns, ns), 1.0 / ns),
                None,
                {**N_W1, "mobility_mode": "cell_based", "l1_mode": "constant_cell_projection", "L": 1e9},
            )
            (ref, _, _, info), single_s = n_sync_s(lambda: solver.solve_beckmann_problem(md))
            single[ns] = (float(ref), info["number_iterations"] + 1, single_s)
        ref, ref_k, single_s = single[ns]
        build = functools.partial(
            sharded_beckmann_newton, mesh, (ns, ns), voxel_size=1.0 / ns, precond=precond
        )
        cg_counts, undo = pcg_counter(ptpfa)
        try:
            if precond == "jacobi":
                options = {**N_W1, "num_iter": N_NEWTON_CAP, "cg_maxiter": N_JACOBI_CG_MAXITER}
                (dist, p, k), s = n_sync_s(lambda: build(**options)(md))
                dist = float(dist)
            else:
                # The facade solves on dst - src: src = 0, dst = -md.
                zero = torch.zeros_like(md)
                images = [dt.ScalarImage(a, width=1.0, height=1.0) for a in (zero, -md)]
                options = {"mesh": mesh, "precond": precond, "return_info": True, **N_W1,
                           "num_iter": N_NEWTON_CAP}
                (dist, info), s = n_sync_s(
                    lambda: dt.wasserstein_distance(*images, method="sharded_newton", options=options)
                )
                p, k = info["pressure"], info["number_iterations"]
        finally:
            undo()
        rel = abs(dist - ref) / ref
        if not (np.isfinite(dist) and p.device == md.device and rel <= 1e-3):
            raise AssertionError(f"N5 {precond} {ns}: {dist} vs single device {ref}: {rel}")
        launches = n_cg_launches(build, md)
        out[precond] = {"n": ns, "s": s, "single_s": single_s, "rel": rel, "newton": k,
                        "cg": int(np.sum(cg_counts)), "launches_per_cg": launches}
        how = "sharded_beckmann_newton" if precond == "jacobi" else "wasserstein_distance(method='sharded_newton')"
        print(
            f"N5. {how} {ns}x{ns}, AA(5), precond {precond}, over {device} x 8 on {card}: "
            f"{s:.2f} s, {k} Newton iterations{' (the cap)' if k >= N_NEWTON_CAP else ''}, CG iterations {int(np.sum(cg_counts))} (per solve "
            f"mean {np.mean(cg_counts):.1f}, max {max(cg_counts)}), {launches:.0f} launches per CG "
            f"iteration; distance {dist:.6f} vs the single-device Newton solve (AA(5)) {ref:.6f} "
            f"({ref_k} iterations, {single_s:.2f} s): rel {rel:.2e} (gate 1e-3)"
        )
    return out


def phase_sharded(dt, w2p, device, card: str) -> dict:
    """Phase N: the multi-device layer on meshes of the one card."""
    tic = time.perf_counter()
    result = {"N1": n_pipeline(dt, w2p, device, card)}
    reset_counts(w2p)
    result["N2"] = n_tpfa(dt, device, card)
    result["N3"] = n_warp(dt, device, card)
    result["N4"] = n_batch(dt, device, card)
    result["N5"] = n_newton(dt, device, card)
    check_counts(read_counts(w2p), {}, "N2-N5")
    launches = result["N1"]["launches"]
    if launches != K1_IN_N:
        raise AssertionError(f"N: {launches} K1 launches, want {K1_IN_N}")
    result["phase_s"] = time.perf_counter() - tic
    print(f"N. phase {result['phase_s']:.2f} s, {launches} K1 launches")
    return {"launches": launches, **result}


# ---------------------------------------------------------------- phase O


def vtk_fields(path: Path) -> dict:
    """(header lines, field name -> float64 values) of a legacy VTK file:
    scalars as (N,), vectors as (N, 3); one split and one vectorised parse
    per field."""
    lines = path.read_text().split("\n")
    n, k, fields = int(lines[7].split()[1]), 8, {}
    while k < len(lines) and lines[k]:
        kind, name = lines[k].split()[:2]
        skip = 2 if kind == "SCALARS" else 1
        body = lines[k + skip : k + skip + n]
        values = np.array(" ".join(body).split(), dtype=np.float64)
        fields[name] = values if kind == "SCALARS" else values.reshape(n, 3)
        k += skip + n
    return lines[:8], fields


def vtk_expected(array: torch.Tensor, vector: bool) -> np.ndarray:
    """What the writer must hold: rows bottom-up; a vector (v1, -v0, v2 or
    0); else the first component; as float64 (exact for float32 data)."""
    flat = array.detach().flip(0).reshape(array.shape[0] * array.shape[1], -1).double()
    if not vector:
        return flat[:, 0].cpu().numpy()
    vz = flat[:, 2] if flat.shape[1] > 2 else torch.zeros_like(flat[:, 0])
    return torch.stack([flat[:, 1], -flat[:, 0], vz], dim=1).cpu().numpy()


def o_export(dt, conc_image, w1_info: dict, root: Path, card: str) -> dict:
    """O1 and O2: the 4K map and a W1 solution exported, re-read, held exactly."""
    conc = conc_image.img
    t0 = time.perf_counter()
    conc_image.to_vtk(root / "concentration", name="concentration")
    export_s = time.perf_counter() - t0
    path = root / "concentration.vtk"
    t0 = time.perf_counter()
    header, fields = vtk_fields(path)
    parse_s = time.perf_counter() - t0
    rows, cols = conc.shape
    if header[4] != f"DIMENSIONS {cols} {rows} 1" or list(fields) != ["concentration"]:
        raise AssertionError(f"O1: header {header[4]!r}, fields {list(fields)}")
    values, want = fields["concentration"], vtk_expected(conc[..., None], vector=False)
    if not np.array_equal(values, want) or not np.array_equal(values.astype(np.float32), want.astype(np.float32)):
        raise AssertionError(f"O1: {int((values != want).sum())} values differ from the map")
    mb = path.stat().st_size / 1e6
    print(
        f"O1. Image.to_vtk of the two-warp lane's {rows}x{cols} float32 concentration map: "
        f"{export_s:.3f} s, {mb:.1f} MB ({rows * cols / export_s / 1e6:.2f} Mvalues/s), re-read in "
        f"{parse_s:.3f} s, every value's repr round-trips to the map's exactly on {card}"
    )

    t0 = time.perf_counter()
    dt.wasserstein_distance_to_vtk(root / "w1", w1_info)
    w1_s = time.perf_counter() - t0
    _, fields = vtk_fields(root / "w1.vtk")
    keys = ["src", "dst", "mass_diff", "flux", "weighted_flux", "pressure", "transport_density", "weight", "weight_inv"]
    if list(fields) != keys:
        raise AssertionError(f"O2: fields {list(fields)}, want {keys}")
    for key in keys:
        field = w1_info[key]
        field = field.img if hasattr(field, "img") else field
        if field.device != conc.device:
            raise AssertionError(f"O2: {key} is on {field.device}, the map on {conc.device}")
        vector = key in ("flux", "weighted_flux")
        want = vtk_expected(field if vector else field.reshape(field.shape[0], field.shape[1], -1), vector)
        if not np.array_equal(fields[key], want):
            raise AssertionError(f"O2: {key}: {int((fields[key] != want).sum())} values differ")
    n = w1_info["flux"].shape[0]
    print(
        f"O2. wasserstein_distance_to_vtk of phase F5's {n}x{n} card solution: {w1_s:.3f} s, "
        f"{(root / 'w1.vtk').stat().st_size / 1e6:.2f} MB, {len(keys)} fields re-read exactly on {card}"
    )
    return {"O1_export_s": export_s, "O1_parse_s": parse_s, "O1_mb": mb, "O2_s": w1_s}


def o_gates(dt, conc_image, w1_info: dict, root: Path, card: str) -> dict:
    """O3: every drawing function, show_plotly and the DICOM, VTU and Excel
    readers raise naming their library where it does not import; where
    matplotlib imports, the figures' arrays are held against the tensors."""
    import importlib

    conc = conc_image.img
    crop = dt.ScalarImage(conc[:256, :384].clone(), width=0.384, height=0.256)
    mask = crop.img > crop.img.mean()
    result = SimpleNamespace(
        normalized_signal_aq=crop, normalized_signal_g=crop, mass=crop, saturation_g=crop, concentration_co2_aq=crop
    )
    series = dt.MultiphaseTimeSeriesAnalysis(None)
    series.data.append(0.0, 1.0, 0.5, 0.5, 0.0)
    run = dt.SimpleRunAnalysis(None)
    path = dt.ColorPath(colors=[np.zeros(3), np.full(3, 0.5), np.ones(3)])
    co2 = dt.CO2MassAnalysis(crop, 1.01, 23.0)
    drawing = {
        "Image.show": lambda: crop.show(),
        "plot_2d_wasserstein_distance": lambda: dt.plotting.plot_2d_wasserstein_distance(w1_info, show=False),
        "plot_contour_on_image": lambda: dt.plot_contour_on_image(crop, mask, return_image=True),
        "plot_distribution_on_image": lambda: dt.plot_distribution_on_image(crop, crop),
        "plot_image_statistics": lambda: dt.plot_image_statistics(crop),
        "plot_mass_over_time": lambda: series.plot_mass_over_time(root / "mass.png"),
        "plot_volume_over_time": lambda: series.plot_volume_over_time(root / "volume.png"),
        "plot_result": lambda: series.plot_result(result, "mass", root / "result.png"),
        "plot_contour_signal": lambda: series.plot_contour_signal(crop, result, [0.5], [0.8], None),
        "plot_contour_mass": lambda: series.plot_contour_mass(crop, result, [0.5], None),
        **{
            f"SimpleRunAnalysis.{name}": (lambda name=name, extra=extra: getattr(run, name)(crop, *extra, None))
            for name, extra in (
                ("plot_pure_contour_signal", (result, "aqueous", 0.5)),
                ("plot_simple_contour_signal", (result,)),
                ("plot_contour_saturation_concentration", (result,)),
                ("plot_contour_saturation", (result,)),
                ("plot_contour_concentration", (result,)),
                ("plot_dissolved_CO2", (crop, result)),
                ("plot_gas", (crop, result)),
            )
        },
        "CO2MassAnalysis.log": lambda: co2.log(root / "log"),
        "PWTransformation.log": lambda: dt.PWTransformation([0, 1], [0, 1]).log(root / "pw.png"),
        "ColorPath.get_color_map": lambda: path.get_color_map(),
        "ColorPath.show_cmap": lambda: path.show_cmap(),
        "ColorPath.show_path": lambda: path.show_path(),
    }
    (root / "a.dcm").write_bytes(b"DICM")
    (root / "a.vtu").write_bytes(b"<VTKFile/>")
    (root / "a.xlsx").write_bytes(b"PK")
    # (the libraries a call needs, in the order it imports them; the calls)
    gated = [
        (("matplotlib",), drawing),
        (("plotly",), {"Image.show_plotly": lambda: crop.show_plotly()}),
        (("pydicom",), {"imread .dcm": lambda: dt.imread(root / "a.dcm")}),
        (("meshio",), {"imread .vtu": lambda: dt.imread(root / "a.vtu")}),
        (
            ("pandas", "openpyxl"),
            {
                "InjectionProtocol .xlsx": lambda: dt.InjectionProtocol(root / "a.xlsx"),
                "FaciesProps.load .xlsx": lambda: dt.FaciesProps.load(crop, root / "a.xlsx"),
            },
        ),
    ]
    present, raised = {}, 0

    def imports(name: str) -> bool:
        try:
            importlib.import_module(name)
            return True
        except ImportError:
            return False

    for libraries, calls in gated:
        present.update({name: imports(name) for name in libraries})
        missing = [name for name in libraries if not present[name]]
        if not missing:
            continue
        library = missing[0]
        for what, call in calls.items():
            try:
                call()
            except ImportError as err:
                if library not in str(err):
                    raise AssertionError(f"O3: {what} raised {err!r}, not naming {library}") from err
                raised += 1
                continue
            raise AssertionError(f"O3: {what} did not raise without {library}")
    rendered = o_figures(dt, crop, mask, drawing) if present["matplotlib"] else 0
    print(
        f"O3. libraries on this machine: {present}; {raised} calls raised naming their "
        f"library; {rendered} drawing calls rendered on Agg{' (3 held against the tensors)' if rendered else ''} "
        f"on {card}"
    )
    return {"raised": raised, "present": present, "rendered": rendered}


def o_figures(dt, crop, mask, drawing: dict) -> int:
    """Where matplotlib imports: every drawing call renders on Agg (their
    count is returned), and the arrays of a scalar view, the statistics
    profile and a contour overlay's level are the tensors'."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    show, close = plt.show, plt.close
    plt.show = lambda *a, **k: None
    try:
        for call in drawing.values():
            call()
            plt.close("all")
        plt.close = lambda *a, **k: None
        crop.show()
        shown = plt.gcf().axes[0].images[0].get_array()
        if not np.array_equal(np.asarray(shown), crop.img.cpu().numpy()):
            raise AssertionError("O3: Image.show's array is not the tensor's")
        close("all")
        fig = dt.plot_image_statistics(crop)
        line = fig.axes[0].get_lines()[0].get_ydata()
        want = crop.img.double().mean(dim=1).float().cpu().numpy()
        if not np.array_equal(np.asarray(line), want):
            raise AssertionError("O3: the statistics profile is not the tensor's")
        close("all")
        fig = dt.plot_contour_on_image(crop, mask)
        levels = fig.axes[0].collections[0].levels
        if list(levels) != [0.5]:
            raise AssertionError(f"O3: contour levels {levels}")
        close("all")
    finally:
        plt.show, plt.close = show, close
    return len(drawing)


def o_statistics(dt, conc_image, probe_u8: np.ndarray, device, card: str) -> dict:
    """O4: plot_image_statistics' profiles at 4K on the card against a
    float64 numpy reckoning of the host copy."""
    from darsia_tpu_torch.utils.augmented_plotting import _statistics

    out = {}
    for name, data in (("concentration", conc_image.img), ("photograph", torch.from_numpy(probe_u8).to(device))):
        host = data.cpu().numpy().astype(np.float64)
        host = host.mean(axis=-1) if host.ndim == 3 else host
        for axis in (0, 1):
            _statistics(data, axis)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, std = _statistics(data, axis)
            card_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ref_mean, ref_std = host.mean(axis=1 - axis), host.std(axis=1 - axis)
            host_ms = (time.perf_counter() - t0) * 1e3
            scale = max(float(np.abs(host).max()), 1e-30)
            err = max(float(np.abs(mean - ref_mean).max()), float(np.abs(std - ref_std).max())) / scale
            bound = 1e-6 if data.dtype == torch.float32 else 1e-12
            if mean.shape != (data.shape[axis],) or not err <= bound:
                raise AssertionError(f"O4: {name} axis {axis}: rel err {err} (bound {bound})")
            out[f"{name}_{axis}"] = {"card_ms": card_ms, "host_ms": host_ms, "rel_err": err}
            print(
                f"O4. image statistics of the {tuple(data.shape)} {name} ({data.dtype}), axis {axis}: "
                f"{card_ms:.3f} ms on the card (profiles copied: {2 * mean.size} values), float64 numpy "
                f"of the host copy {host_ms:.3f} ms, max rel err {err:.2e} (bound {bound}) on {card}"
            )
    return out


def phase_display(dt, w2p, conc_image, w1_info: dict, probe_u8: np.ndarray, device, card: str) -> dict:
    """Phase O: the display and export layer."""
    import tempfile

    tic = time.perf_counter()
    if conc_image.img.device.type != "cuda":
        raise AssertionError("O: the lane's concentration map is not on the card")
    reset_counts(w2p)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        result = o_export(dt, conc_image, w1_info, root, card)
        result["O3"] = o_gates(dt, conc_image, w1_info, root, card)
    result["O4"] = o_statistics(dt, conc_image, probe_u8, device, card)
    torch.cuda.synchronize()
    check_counts(read_counts(w2p), {}, "O: display and export")
    result["phase_s"] = time.perf_counter() - tic
    print(f"O. phase {result['phase_s']:.2f} s, no kernel launch, on {card}")
    return result


# ---------------------------------------------------------------- phase P

P_TIMED = 5  # timed aligner calls (median printed)
# K1 launches in phase P: the staged probe's corrections (one pair), the
# aligner's first call and fused_align's (a pair each), the timed calls, the
# bilinear 4K crop's pair, and in P5 the crop's registration and its
# call_with_output (a pair each).
P1_SETUP_K1 = 2
P5_K1 = 2 * 2
K1_IN_P = P1_SETUP_K1 + 2 * 2 + 2 * P_TIMED + 2 + P5_K1
# A quadrilateral inside the 4K frame and where it lands in a (1500, 2800)
# crop, (row, col): displacements within K1's bound, every sample inside.
P_SRC = np.array([[60.5, 90.25], [1600.0, 70.0], [1650.75, 3000.5], [40.0, 3050.0]])
P_DST = np.array([[30.0, 40.0], [1460.0, 25.0], [1480.0, 2760.0], [15.0, 2790.0]])
P_SHAPE = (1500, 2800)


def p_homography(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """The float64 3x3 map of (row, col, 1) from ``dst`` to ``src`` points."""
    A, b = [], []
    for (x, y), (u, v) in zip(dst, src):
        A += [[x, y, 1, 0, 0, 0, -u * x, -u * y], [0, 0, 0, x, y, 1, -v * x, -v * y]]
        b += [u, v]
    return np.append(np.linalg.solve(np.array(A), np.array(b)), 1.0).reshape(3, 3)


def p_flush(w2p, tally: dict) -> dict:
    """The launches since the last flush: added to ``tally``, then every count
    set to 0, so that each step of phase P is read from 0 and none is lost."""
    torch.cuda.synchronize()
    counts = read_counts(w2p)
    for name, n in counts.items():
        tally[name] += n
    reset_counts(w2p)
    return counts


def p_aligner(dt, w2p, lanes, device, card: str, tally: dict) -> dict:
    """P1: ``build_fused_aligner`` on the bench's registration set-up at 4K."""
    probe = staged_probe(dt, lanes, device)
    ta = dt.ImageRegistration(lanes["analysis"].base, N_patches=[8, 16], rel_overlap=0.1, quality_tol=0.02)
    ta = ta._engine.translation_analysis
    torch.cuda.synchronize()
    tic = time.perf_counter()
    aligner = ta.build_fused_aligner(D_REG)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - tic) * 1e3
    check_counts(p_flush(w2p, tally), {"warp_rows_t": P1_SETUP_K1}, "P1: the staged probe and the set-up")
    out, shifts, quality = aligner(probe.img)
    aligned = ta.fused_align(probe, max_disp=D_REG)
    check_counts(p_flush(w2p, tally), {"warp_rows_t": 4}, "P1: aligner + fused_align")
    if not torch.equal(aligned.img, out):
        raise AssertionError("P1: build_fused_aligner's frame is not fused_align's")
    if tuple(out.shape) != tuple(probe.img.shape) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"P1: bad registered frame {tuple(out.shape)}")
    if tuple(shifts.shape) != (128, 2) or not bool((quality > 0.02).all()):
        raise AssertionError("P1: not every one of the 128 patches passed")
    again, ms, each, counts = median_call_ms(w2p, lambda: aligner(probe.img), P_TIMED, 2, "P1: aligner")
    p_flush(w2p, tally)  # the timed calls, which median_call_ms read and checked
    if not torch.equal(again[0], out):
        raise AssertionError("P1: the aligner is not deterministic")
    print(
        f"P1. build_fused_aligner({D_REG}) on the {tuple(probe.img.shape)} probe (8x16 patches): "
        f"built in {build_ms:.3f} ms, {ms:.4f} ms per call (median of {P_TIMED} after a warm-up: "
        f"{each}), launches {counts}, bitwise fused_align's frame, on {card}"
    )
    return {"build_ms": build_ms, "ms": ms, "each_ms": each}


def p_assignment(dt, device, card: str) -> dict:
    """P2: a 4K numpy array assigned to a card image stays on the card;
    copy, resize and integrate there."""
    rng = np.random.default_rng(31)
    host = rng.random((H, W)).astype(np.float32)
    image = dt.ScalarImage(torch.zeros((H, W), device=device), **META)
    tic = time.perf_counter()
    image.img = host
    torch.cuda.synchronize()
    assign_ms = (time.perf_counter() - tic) * 1e3
    if image.img.device != device or not torch.equal(image.img.cpu(), torch.from_numpy(host)):
        raise AssertionError(f"P2: the assigned array is on {image.img.device}")
    copied = image.copy()
    resized = dt.resize(image, shape=(H // 2, W // 2), interpolation="inter_nearest")
    on_cpu = dt.resize(
        dt.ScalarImage(torch.from_numpy(host), **META), shape=(H // 2, W // 2), interpolation="inter_nearest"
    )
    if copied.img.device != device or resized.img.device != device:
        raise AssertionError("P2: copy or resize left the card")
    if not torch.equal(copied.img, image.img) or not torch.equal(resized.img.cpu(), on_cpu.img):
        raise AssertionError("P2: copy or resize differs from the host's")
    integral = float(dt.Geometry(**image.shape_metadata()).integrate(image))
    want = float(host.astype(np.float64).sum()) * (META["width"] / W) * (META["height"] / H)
    rel = abs(integral - want) / abs(want)
    if not rel <= 1e-6:
        raise AssertionError(f"P2: integral {integral} vs {want} (rel {rel})")
    print(
        f"P2. a ({H}, {W}) float32 numpy array assigned to a card image: on {image.img.device} "
        f"({assign_ms:.3f} ms with its copy), copy and nearest resize on the card (resize == the CPU "
        f"tensor's), integral rel err {rel:.2e} against float64 numpy (bound 1e-6), on {card}"
    )
    return {"assign_ms": assign_ms, "integral_rel_err": rel}


def p_quad(dt, w2p, device, card: str, tally: dict) -> dict:
    """P3: ``extract_quadrilateral_ROI`` at 4K with ``shape`` + ``pts_dst``,
    bilinear (one K1 pair) and nearest (the gather warp), against a float64
    numpy pull-back at 4096 sampled pixels."""
    from darsia_tpu_torch.corrections.shape.quad import quad_coordinate_grid
    from darsia_tpu_torch.ops.warp import warp_backend

    data = smooth_image(device)
    host = data.cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(37)
    rows, cols = rng.integers(0, P_SHAPE[0], 4096), rng.integers(0, P_SHAPE[1], 4096)
    pull = p_homography(P_DST, P_SRC) @ np.stack([rows, cols, np.ones(4096)])
    r, c = pull[0] / pull[2], pull[1] / pull[2]
    if not (r.min() >= 0 and c.min() >= 0 and r.max() <= H - 1 and c.max() <= W - 1):
        raise AssertionError("P3: a sample falls outside the frame")
    r0, c0 = np.floor(r).astype(int), np.floor(c).astype(int)
    r1, c1 = np.minimum(r0 + 1, H - 1), np.minimum(c0 + 1, W - 1)
    fr, fc = (r - r0)[:, None], (c - c0)[:, None]
    bilinear = (
        (1 - fr) * ((1 - fc) * host[r0, c0] + fc * host[r0, c1]) + fr * ((1 - fc) * host[r1, c0] + fc * host[r1, c1])
    )
    nearest = host[np.round(r).astype(int), np.round(c).astype(int)]
    near_edge = (np.abs(r - np.floor(r) - 0.5) < 1e-3) | (np.abs(c - np.floor(c) - 0.5) < 1e-3)
    out, kw = {}, {"pts_src": P_SRC, "indexing": "matrix", "shape": P_SHAPE, "pts_dst": P_DST}
    for interpolation, want_k1, ref in (("inter_linear", 2, bilinear), ("inter_nearest", 0, nearest)):
        check_counts(p_flush(w2p, tally), {}, f"P3: before the {interpolation} crop")
        tic = time.perf_counter()
        crop = dt.extract_quadrilateral_ROI(data, interpolation=interpolation, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - tic) * 1e3
        check_counts(p_flush(w2p, tally), {"warp_rows_t": want_k1} if want_k1 else {}, f"P3: {interpolation}")
        if tuple(crop.shape) != P_SHAPE + (3,) or crop.device != device:
            raise AssertionError(f"P3: {interpolation} crop of shape {tuple(crop.shape)} on {crop.device}")
        got = crop[torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)].cpu().numpy()
        err = np.abs(got - ref).max(axis=1)
        if interpolation == "inter_linear":
            # The crop is K1's two-pass warp: bitwise its plain version on the
            # same field, and off the exact bilinear pull-back by the two-pass
            # approximation of this perspective field (its plain version on
            # the CPU: mean 4.2e-3, max 0.023 over the whole crop).
            coords = quad_coordinate_grid(P_SRC, P_SHAPE, P_DST, device=device)
            plain = warp_backend(data, coords, order=1, warp_impl="plain")
            d_plain = float((crop - plain).abs().max())
            worst, ties = float(err.max()), 0
            if not (d_plain <= 1e-6 and float(err.mean()) < 5e-3 and worst < 0.05):
                raise AssertionError(
                    f"P3: bilinear crop vs plain K1 {d_plain}; vs float64 numpy mean {float(err.mean())}, max {worst}"
                )
        else:
            ties = int(near_edge.sum())
            worst = float(err[~near_edge].max())
            if not worst == 0.0:
                raise AssertionError(f"P3: nearest crop vs float64 numpy, max |diff| {worst} off the cell edges")
        print(
            f"P3. extract_quadrilateral_ROI({interpolation}, shape={P_SHAPE}, pts_dst) of the ({H}, {W}, 3) "
            f"frame: {ms:.3f} ms (one call, set-up included), {want_k1} K1 launches, max |diff| {worst:.2e} "
            f"(mean {float(err.mean()):.2e}) against a float64 numpy pull-back at 4096 pixels ({ties} within "
            f"1e-3 of a cell edge left out; bilinear: the two-pass warp, bitwise plain K1; nearest: exact), "
            f"on {card}"
        )
        out[interpolation] = {"ms": ms, "max_abs_err": worst, "mean_abs_err": float(err.mean()), "edge_samples": ties}
    return out


def p_ncc(dt, device, card: str) -> dict:
    """P4: ``masked_normalized_cross_correlation`` of two 4K frames against
    float64 numpy."""
    from darsia_tpu_torch.ops.fft import masked_normalized_cross_correlation

    src = smooth_image(device)[..., 0]
    rng = np.random.default_rng(41)
    dst = 0.7 * src + 0.3 * torch.from_numpy(rng.random((H, W)).astype(np.float32)).to(device)
    a, b = src.cpu().numpy().astype(np.float64), dst.cpu().numpy().astype(np.float64)
    a, b = a - a.mean(), b - b.mean()
    want = float((a * b).sum() / (np.sqrt((a * a).sum() * (b * b).sum()) + 1e-12))
    masked_normalized_cross_correlation(src, dst)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    score = masked_normalized_cross_correlation(src, dst)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - tic) * 1e3
    err = abs(float(score) - want)
    if score.dtype != torch.float32 or score.device != device or not err <= 1e-5:
        raise AssertionError(f"P4: NCC {float(score)} ({score.dtype}, {score.device}) vs float64 {want}")
    print(
        f"P4. masked_normalized_cross_correlation of two ({H}, {W}) frames: {float(score):.7f} in "
        f"{ms:.3f} ms on the card, float64 numpy {want:.7f} (|diff| {err:.2e}, bound 1e-5), on {card}"
    )
    return {"ms": ms, "abs_err": err}


def p_plots(dt, lanes, device, raised_in_o: int, card: str) -> dict:
    """P5: where matplotlib does not import, the new plots raise naming it;
    where it does, they render on Agg."""
    import importlib

    base = lanes["analysis"].base
    crop = dt.OpticalImage(base.img[:256, :384].clone(), width=0.384, height=0.256)
    reg = dt.ImageRegistration(crop, N_patches=[2, 3], rel_overlap=0.1)
    reg(crop)
    loud = dt.ConcentrationAnalysis(
        base=crop, signal_reduction=dt.MonochromaticReduction(color="gray"), verbosity=2
    )
    calls = {
        "TranslationAnalysis.plot_translation": lambda: reg._engine.translation_analysis.plot_translation(),
        "ImageRegistration.plot": lambda: reg.plot(),
        "call_with_output(plot_patch_translation=True)": lambda: reg._engine.call_with_output(
            crop, plot_patch_translation=True
        ),
        "ColorChecker.plot": lambda: dt.ColorCheckerAfter2014().plot(),
        "ConcentrationAnalysis(verbosity=2)": lambda: loud(crop),
    }
    try:
        importlib.import_module("matplotlib")
        present = True
    except ImportError:
        present = False
    raised = 0
    if present:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        show, plt.show = plt.show, lambda *a, **k: None
        try:
            for call in calls.values():
                call()
                plt.close("all")
            quiet = dt.ConcentrationAnalysis(base=crop, signal_reduction=dt.MonochromaticReduction(color="gray"))
            probe = dt.OpticalImage(torch.roll(crop.img, 3, dims=1), width=0.384, height=0.256)
            if not torch.equal(loud(probe).img, quiet(probe).img):
                raise AssertionError("P5: the concentration depends on verbosity")
            plt.close("all")
        finally:
            plt.show = show
    else:
        for what, call in calls.items():
            try:
                call()
            except ImportError as err:
                if "matplotlib" not in str(err):
                    raise AssertionError(f"P5: {what} raised {err!r}, not naming matplotlib") from err
                raised += 1
                continue
            raise AssertionError(f"P5: {what} did not raise without matplotlib")
    print(
        f"P5. matplotlib {'imports' if present else 'does not import'} here: "
        + (
            f"{raised} new drawing calls raised naming it ({raised_in_o} in phase O, {raised_in_o + raised} in all)"
            if not present
            else f"{len(calls)} new drawing calls rendered on Agg, the concentration at verbosity 2 == at 0"
        )
        + f"; on {card}"
    )
    return {"raised": raised, "present": present}


def phase_gaps(dt, w2p, lanes, device, raised_in_o: int, card: str) -> dict:
    """Phase P: the port's last gaps against the JAX package."""
    tic = time.perf_counter()
    # Every step's launches are read from 0 and added up here: the phase's
    # count is what its steps launched, set-up included.
    tally = dict.fromkeys(KERNELS, 0)
    reset_counts(w2p)
    result = {"P1": p_aligner(dt, w2p, lanes, device, card, tally)}
    result["P2"] = p_assignment(dt, device, card)
    check_counts(p_flush(w2p, tally), {}, "P2: assignment, copy, resize and integrate")
    result["P3"] = p_quad(dt, w2p, device, card, tally)
    result["P4"] = p_ncc(dt, device, card)
    check_counts(p_flush(w2p, tally), {}, "P4: NCC")
    result["P5"] = p_plots(dt, lanes, device, raised_in_o, card)
    check_counts(p_flush(w2p, tally), {"warp_rows_t": P5_K1}, "P5: plots")
    check_counts(tally, {"warp_rows_t": K1_IN_P}, "P: the phase")
    launches = tally["warp_rows_t"]
    result["launches"] = launches
    result["phase_s"] = time.perf_counter() - tic
    print(f"P. phase {result['phase_s']:.2f} s, {launches} K1 launches, on {card}")
    return result


# ---------------------------------------------------------------- phase Q

# K1 launches of each example of ``darsia_tpu_torch.examples`` (fast mode,
# on the card), each read from 0 (a pair per two-pass warp): fused_pipeline
# the crop's and the bulge's coordinate maps, twice (the base's correction,
# the pipeline's chain), the base's correction, then a gray and a colour
# warp per frame, one frame and a 3-frame series; image_registration the
# flexible lane's warp; color_correction the checker crop, at set-up and
# in the call; optical_images per photograph the bulge's coordinate map and
# the warp.
Q_K1 = {
    "fused_pipeline": 2 * (2 * 2 + 1 + 2 * (1 + 3)),
    "image_registration": 2,
    "color_correction": 2 * 2,
    "optical_images": 2 * 2 * 2,
}
# Run once more at default size, the K1 ones with the same warps: the
# examples whose default mode differs from fast mode, the two Newton
# transport ones aside (their default mode: PERF.md), and color_correction
# and optical_images, which read no fast switch (their default mode is the
# fast mode's run).
Q_DEFAULT = ("fused_pipeline", "image_registration", "co2_and_tracer_analysis", "color_correction", "optical_images")
# Pinned at default size too, run on the card apart (about 70 and 30 s
# there, PERF.md): the script's time has no room for them.
Q_DEFAULT_APART = ("sharded_wasserstein", "wasserstein_split_square")
K1_IN_Q = sum(Q_K1.values()) + sum(Q_K1.get(name, 0) for name in Q_DEFAULT)
# The steps that need matplotlib: where it does not import, each raises
# naming it and the example goes on (co2_analysis: one contour plot per
# frame; readme_example: the check for a window).
Q_MISSING = {"co2_analysis": 3, "readme_example": 1}


def q_run(examples, w2p, name: str, device, fast: bool) -> tuple:
    """(``main``'s result, its K1 calls, their faults against the plain K1,
    wall ms) of one example; ``distances`` without its host EMD."""
    import importlib
    import io

    sys.path.insert(0, str(REPO / "tests"))
    from torch_device_cases import k1_held

    module = importlib.import_module(f"{examples.__name__}.{name}")
    # cv2.EMD on 4096-point signatures takes minutes on the host; phase M
    # runs cv2.emd on the card's machine, the slow CPU test runs this one.
    options = {"emd": False} if name == "distances" else {}
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, calls, faults = k1_held(w2p, lambda: module.main(device=device, fast=fast, **options))
    ms = (time.perf_counter() - tic) * 1e3
    return out, calls, faults, ms


def phase_examples(dt, w2p, device, card: str) -> dict:
    """Phase Q: every example of the port's suite on the card in fast mode,
    and ``Q_DEFAULT`` at default size, held to the JAX examples' lines in
    ``expected.json`` with their tolerances, its K1 launches read from 0 and
    checked exactly, each launch held bitwise to the plain K1 on its own
    inputs, its wall ms printed."""
    import tempfile

    from darsia_tpu_torch import examples

    try:
        import matplotlib  # noqa: F401

        has_matplotlib = True
    except ImportError:
        has_matplotlib = False
    pinned = sorted(name for name, entry in examples.expected().items() if "default" in entry)
    if pinned != sorted(Q_DEFAULT + Q_DEFAULT_APART):
        raise AssertionError(
            f"Q: expected.json pins default-mode lines of {pinned}, Q_DEFAULT {Q_DEFAULT} + {Q_DEFAULT_APART}"
        )
    tic = time.perf_counter()
    result, faults, launches, held = {"ms": {}, "k1": {}}, [], 0, 0
    runs = [(name, True) for name in examples.EXAMPLES] + [(name, False) for name in Q_DEFAULT]
    saved = tempfile.tempdir
    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp  # the examples' results folders
        try:
            for name, fast in runs:
                label = name if fast else f"{name} (default mode)"
                reset_counts(w2p)
                # The card's warps are K1's two passes, the CPU's the exact
                # gather warp: where that shows, the card's own tolerance.
                spec = examples.spec(name, fast=fast, card=True)
                if name == "distances":
                    spec["lines"] = [line for line in spec["lines"] if not line.startswith("EMD (cv2)")]
                out, calls, wrong, ms = q_run(examples, w2p, name, device, fast)
                counts = read_counts(w2p)
                launches += counts["warp_rows_t"]
                held += len(calls)
                result["ms"][label], result["k1"][label] = ms, counts["warp_rows_t"]
                wrong += examples.compare_lines(out["lines"], spec)
                want = {"warp_rows_t": Q_K1.get(name, 0)}
                if counts != {k: want.get(k, 0) for k in KERNELS} or len(calls) != counts["warp_rows_t"]:
                    wrong.append(f"launches {counts}, {len(calls)} K1 calls recorded, want {want}")
                missing = out.get("missing", [])
                want_missing = 0 if has_matplotlib else Q_MISSING.get(name, 0)
                if len(missing) != want_missing or not all("matplotlib" in m for m in missing):
                    wrong.append(f"{len(missing)} steps raised naming a library, want {want_missing}: {missing}")
                faults += [f"Q {label}: {w}" for w in wrong]
                shapes = sorted({f"{tuple(c[0].shape)}->{c[3].shape[1]}" for c in calls})
                print(
                    f"Q {label}: {ms:.1f} ms, {counts['warp_rows_t']} K1 launches"
                    + (f" (each == plain K1 on its inputs; C,R,W_in->W_out {shapes})" if calls else "")
                    + f", {len(spec['lines'])} lines "
                    + ("within expected.json" if not wrong else f"{len(wrong)} faults (below)")
                    + (f", {len(missing)} steps raised naming matplotlib" if missing else "")
                )
                for line in out["lines"]:
                    print(f"  {line}")
        finally:
            tempfile.tempdir = saved
    if faults:
        raise AssertionError("phase Q:\n" + "\n".join(faults))
    if launches != K1_IN_Q:
        raise AssertionError(f"Q: {launches} K1 launches, want {K1_IN_Q}")
    result["launches"] = launches
    result["phase_s"] = time.perf_counter() - tic
    print(
        f"Q. phase {result['phase_s']:.2f} s, {launches} K1 launches ({held} held bitwise to the plain K1), "
        f"on {card}"
    )
    return result


# Phase R: the device-parity sweep of tests/torch_device_cases.py, each
# case's K1 launches counted from 0 (the table's ``k1``), their sum checked.
K1_IN_R = 84


def phase_device_cases(dt, w2p, card: str) -> dict:
    """Phase R: every case of ``tests/torch_device_cases.py`` (the port's
    public classes and functions, small sizes) on ``cpu`` and on ``cuda:0``:
    outputs within each case's tolerance, a card case's tensors and images
    on ``cuda:0``, each K1 call held bitwise to the plain K1, each case's K1
    launches equal to its count and K2/K3 never launched; per layer the
    cases, card and host cases, the worst ratio of difference to tolerance
    and the seconds."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_device_cases as sweep

    if sum(c.k1 for c in sweep.CASES.values()) != K1_IN_R:
        raise AssertionError(f"R: the cases' K1 counts sum to {sum(c.k1 for c in sweep.CASES.values())}, "
                             f"K1_IN_R is {K1_IN_R}")
    tic = time.perf_counter()
    layers = {
        layer: {"cases": 0, "card": 0, "host": 0, "library": 0, "worst": 0.0, "s": 0.0}
        for layer in sweep.LAYERS
    }
    faults, launches, held = [], 0, 0
    for c in sweep.CASES.values():
        reset_counts(w2p)
        r = sweep.card_parity(c, w2p)
        counts = read_counts(w2p)
        if counts["warp_rows"] or counts["warp_rows_ring"]:
            r["faults"].append(f"K2/K3 launched: {counts}")
        launches += r["launches"]
        held += r["held"]
        row = layers[c.layer]
        row["cases"] += 1
        row["card" if c.where == "card" else "host"] += 1
        row["library"] += r["import_error"]
        row["worst"] = max(row["worst"], r["worst"])
        row["s"] += r["s"]
        faults += [f"R {c.name}: {fault}" for fault in r["faults"]]
    for layer, row in layers.items():
        print(
            f"R {layer}: {row['cases']} cases ({row['card']} card, {row['host']} host; "
            f"{row['library']} raised naming an absent library), worst |diff| / tolerance "
            f"{row['worst']:.3g}, {row['s']:.2f} s"
        )
    if faults:
        raise AssertionError("phase R:\n" + "\n".join(faults))
    if launches != K1_IN_R:
        raise AssertionError(f"R: {launches} K1 launches, want {K1_IN_R}")
    result = {"launches": launches, "phase_s": time.perf_counter() - tic}
    print(
        f"R. phase {result['phase_s']:.2f} s, {len(sweep.CASES)} cases, {launches} K1 launches "
        f"({held} held bitwise to the plain K1), on {card}"
    )
    return result


def profile_batch(dt, src, dst, out_dir: Path, name: str) -> None:
    """torch.profiler over a short batched solve (the Darcy solve and one
    Newton iteration): device busy against the unprofiled time."""
    from darsia_tpu_torch.parallel import batched_wasserstein
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    n = src.shape[-1]
    short = batched_wasserstein((n, n), 1.0 / n, options={**G_OPTIONS, "num_iter": 1})
    short(src, dst)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short(src, dst)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        short(src, dst)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(averages.table(sort_by="cuda_time_total", row_limit=20))
    trace = out_dir / f"profile_{name}.json"
    prof.export_chrome_trace(str(trace))
    events = [
        e
        for e in json.loads(trace.read_text())["traceEvents"]
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
    ]
    if trace.stat().st_size > 8e6:
        trace.unlink()
    if not events:
        print(f"profile {name}: the trace holds no device events")
        return
    busy_ms = busy_us(events) / 1e3
    print(
        f"profile {name} (B = {src.shape[0]}, Darcy solve + 1 Newton iteration; unprofiled "
        f"{plain_ms:.1f} ms): {len(events)} device ops, device busy {busy_ms:.2f} ms, idle "
        f"share {1 - busy_ms / plain_ms:.3f}"
    )


def profile_transport(dt, bk, solver, mass_diff, fluxes, out_dir: Path) -> None:
    """Phase F's profile: torch.profiler over a short Newton solve on F1's
    problem (the Darcy solve and one iteration), the CG trips' coarsest
    multigrid level (``FusedMGPCG._coarsest``) in a named range; then, at
    the converged mobility, one CG trip of the kernels, the coarsest level's
    product alone, and the hierarchy built on the card against its tensor
    form."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from darsia_tpu_torch.utils import tracing

    coarsest = bk.FusedMGPCG._coarsest

    def marked(self):
        with record_function("mg_coarsest_level"):
            return coarsest(self)

    short = dt.BeckmannNewtonSolver(solver.grid, solver.weight, {**F_NEWTON, "num_iter": 1})
    short.solve_beckmann_problem(mass_diff)  # its constants on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short.solve_beckmann_problem(mass_diff)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bk.FusedMGPCG._coarsest = marked
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            short.solve_beckmann_problem(mass_diff)
            torch.cuda.synchronize()
    finally:
        bk.FusedMGPCG._coarsest = coarsest
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=20)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_w1_newton.txt").write_text(
        table + "\n" + averages.table(sort_by="self_cpu_time_total", row_limit=20)
    )
    print(table)
    trace = out_dir / "profile_w1_newton.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    if trace.stat().st_size > 8e6:
        trace.unlink()  # ~10^4-10^5 ops: the tables are kept, the trace is not
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not device:
        print("profile F1: the trace holds no device events")
        return
    busy_ms = busy_us(device) / 1e3
    # The coarsest level's kernels: launched inside its named host ranges.
    ranges = sorted(
        (e["ts"], e["ts"] + e["dur"])
        for e in events
        if e.get("name") == "mg_coarsest_level" and e.get("cat") == "user_annotation"
    )
    if not ranges:
        raise AssertionError("profile F1: no CG trip's coarsest level ran in the profiled solve")
    starts = np.array([r[0] for r in ranges])
    ends = np.array([r[1] for r in ranges])
    inside = set()
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            k = np.searchsorted(starts, e["ts"], side="right") - 1
            if k >= 0 and e["ts"] <= ends[k]:
                inside.add(e["args"]["correlation"])
    coarse_us = sum(e["dur"] for e in device if e.get("args", {}).get("correlation") in inside)
    print(
        f"profile F1 (Darcy solve + 1 Newton iteration; unprofiled {plain_ms:.1f} ms): "
        f"{len(device)} device ops, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / plain_ms:.3f}; coarsest MG level: {coarse_us / 1e3:.2f} ms of "
        f"device time ({coarse_us / 1e3 / busy_ms:.3f} of busy) over {len(ranges)} "
        f"products, {float((ends - starts).sum()) / 1e3:.1f} ms in its host ranges (profiled)"
    )
    # At the converged mobility: a CG trip of the kernels (two fixed-count
    # solves, tol 0, differenced), the coarsest level's product alone, and
    # the hierarchy's build on the card and in its tensor form.
    trans = solver.transmissibilities(solver._cell_based_face_weights(fluxes))
    levels = solver._mg_levels
    hierarchy = bk.mg_hierarchy_on_card(trans, levels)
    r = (mass_diff - mass_diff.mean())[None].contiguous()
    x0 = torch.zeros_like(r)
    trip = trip_ms(lambda n: bk.mg_pcg_fused(hierarchy, r, x0, 0.0, n), 10, 30)
    mark = tracing.counter("beckmann.mg_launches")
    bk.mg_pcg_fused(hierarchy, r, x0, 0.0, 10)
    short_launches = tracing.counter("beckmann.mg_launches") - mark
    bk.mg_pcg_fused(hierarchy, r, x0, 0.0, 30)
    per_trip = (tracing.counter("beckmann.mg_launches") - mark - 2 * short_launches) / 20
    fused = bk.FusedMGPCG(hierarchy, 1, tuple(r.shape[1:]), 2, 40)
    fused.start(r, x0, 1e-6)
    coarse_ms = cuda_ms(fused._coarsest, 20)
    build_ms = cuda_ms(lambda: bk.mg_hierarchy_on_card(trans, levels), 5)
    tensor_ms = cuda_ms(lambda: bk.tpfa_mg_hierarchy(trans, 2, levels), 5)
    print(
        f"CG trip of the kernels ({levels} levels, coarsest {fused.shapes[-1]}): {trip:.3f} ms "
        f"(host clock, the flag read included), {per_trip:.1f} kernel launches; the coarsest "
        f"level's product alone {coarse_ms:.3f} ms; hierarchy built on the card "
        f"{build_ms:.3f} ms per pressure solve (tensor form {tensor_ms:.3f} ms)"
    )


def trip_ms(solve, lo: int, hi: int) -> float:
    """Host ms a CG trip: two fixed-count solves ``solve(n)``, differenced
    (the better of two runs each)."""
    times = []
    for n in (lo, hi, lo, hi):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        solve(n)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
    return 1e3 * (min(times[1::2]) - min(times[0::2])) / (hi - lo)


def profile_frame(fn, ms_per_call: float, out_dir: Path, name: str, frames: int = 3):
    """torch.profiler over a few calls of ``fn`` (a frame, or a call of a
    path): kernel tables (by device time, and by the host's own time) and
    a Chrome trace (dropped above 8 MB) into ``out_dir``
    (``profile_<name>.*``), device busy time and idle share printed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=30)
    host = averages.table(sort_by="self_cpu_time_total", row_limit=30)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(table + "\n" + host)
    trace = out_dir / f"profile_{name}.json"
    prof.export_chrome_trace(str(trace))
    print(table)
    events = [
        e
        for e in json.loads(trace.read_text())["traceEvents"]
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
    ]
    if trace.stat().st_size > 8e6:
        trace.unlink()  # ~10^4 ops per call: the tables are kept, the trace is not
    busy = busy_us(events)
    busy_ms = busy / 1e3 / frames
    if not events:
        # CUPTI delivered no device activity for this window (seen once on a
        # 2-op call): nothing to report, and no share to divide by.
        print(f"profile {name}: the trace holds no device events")
        return
    k1 = [e["dur"] for e in events if "warp_rows_t_kernel" in e.get("name", "")]
    print(
        f"profile {name}: {len(events) / frames:.0f} device ops per call, device busy "
        f"{busy_ms:.3f} ms per call; idle share against the unprofiled "
        f"{ms_per_call:.3f} ms/call: {1 - busy_ms / ms_per_call:.3f}; K1 "
        f"{sum(k1) / 1e3 / frames:.4f} ms per call over {len(k1) / frames:.0f} "
        "launches "
        f"({sum(k1) / 1e3 / busy_ms / frames:.3f} of the busy time)"
    )


def stage_times(pipeline, probe, reps: int = 10) -> None:
    """Stream time of each stage of the frame, run back to back (CUDA events)."""
    from darsia_tpu_torch.analysis.translationanalysis import _to_gray
    from darsia_tpu_torch.utils.dtype import convert_dtype

    stages, _ = pipeline._stage_plan(tuple(probe.shape[:2]), probe.device)
    ((_, chain),) = stages
    apply = chain.apply_fn(probe.dtype)
    ta = pipeline._translation_analysis
    estimate, reg_ops, _ = ta.fused_estimator_parts(pipeline.max_disp)
    aligner, _ = ta.fused_aligner_parts(pipeline.max_disp)
    conc_fn = pipeline.analysis.pipeline_fn()
    base = pipeline.analysis.base.img
    corrected = apply(probe, chain.field)
    x = convert_dtype(corrected, torch.float32)
    registered = aligner(x, reg_ops)[0]
    times = {
        "correction warp (2 K1 + mask + round)": lambda: apply(probe, chain.field),
        "u8 -> f32": lambda: convert_dtype(corrected, torch.float32),
        "registration estimate (gray, windows, FFT, TPS)": lambda: estimate(
            _to_gray(x), reg_ops
        ),
        "registration total (+ upsample, 2 K1 warp)": lambda: aligner(x, reg_ops),
        "concentration (diff, gray, model, 10 Jacobi)": lambda: conc_fn(registered, base),
    }
    for name, fn in times.items():
        print(f"stage {name}: {cuda_ms(fn, reps):.3f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile",
        type=Path,
        metavar="DIR",
        help="also profile 3 frames of each lane and 3 calls of the flexible, "
        "multiscale and series-correction paths (tables + Chrome traces into "
        "DIR) and time the two-warp lane's stages",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only on a card")
    sys.path.insert(0, str(REPO))
    import darsia_tpu_torch as dt
    from darsia_tpu_torch.ops import warp2pass as w2p

    device = torch.device("cuda:0")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    card = card_line()
    print(card)

    from darsia_tpu_torch.measure import beckmann_kernels as bk
    from darsia_tpu_torch.ops import cuda_build

    tic = time.perf_counter()
    w2p.build_kernel()
    build_s = time.perf_counter() - tic
    print(f"kernel build + load (K1, K2, K3): {build_s:.2f} s")
    tic = time.perf_counter()
    bk.build_kernels()
    print(f"kernel build + load (the pressure solve's CG trip): {time.perf_counter() - tic:.2f} s")
    for stem, log in cuda_build.build_log.items():
        for line in log.splitlines():
            if any(key in line for key in ("entry function", "registers", "spill")):
                print(f"ptxas [{stem}]:", line.strip())

    k1 = phase_kernel(w2p)
    rows = phase_rows(w2p)
    phase_two_pass(dt, device)
    lanes = build_lanes(dt, device)
    main_path = phase_main_path(dt, w2p, lanes, device, card, args.profile)
    single = phase_single_warp(w2p, lanes, device, card, args.profile)
    series = phase_series(w2p, lanes, device, card)
    flexible = phase_flexible(dt, w2p, lanes, device, card, args.profile)
    after_frame = phase_pipeline_displacement(dt, w2p, lanes, device)
    multiscale = phase_multiscale(dt, w2p, lanes, device, card, args.profile)
    series_corr = phase_series_correction(dt, w2p, lanes, device, card, args.profile)
    phase_series_concentration(dt, lanes, device, series_corr.pop("image"), card)
    lanes["rig"] = build_rig(dt, lanes, device)
    rig_read = phase_rig_read(dt, w2p, lanes["rig"], device, card, args.profile)
    colour_to_mass = phase_colour_to_mass(dt, w2p, lanes["rig"], device, card, args.profile)
    drift_lane = phase_drift_pipeline(dt, w2p, lanes, lanes["rig"], device, card, args.profile)
    drifting = phase_drifting_series(dt, w2p, lanes["rig"], device, card)
    phase_shape_zoo(dt, w2p, lanes, device, card)
    piecewise = phase_piecewise(dt, w2p, lanes, device, card, args.profile)
    colour = phase_colour(dt, w2p, lanes["rig"], device, card, args.profile)
    saved = phase_saved_state(dt, w2p, lanes, lanes["rig"], device, card)
    phase_solvers(dt, device, card, args.profile)
    restoration = phase_restoration_lane(dt, w2p, lanes, device, card, args.profile)
    phase_filters(dt, restoration.pop("conc"), device, card)
    reset_counts(w2p)
    transport = phase_transport(dt, device, card, args.profile)
    check_counts(read_counts(w2p), {}, "F: transport")
    reset_counts(w2p)
    batched = phase_batched(dt, device, card, args.profile)
    check_counts(read_counts(w2p), {}, "G: batched W1 and comparison")
    cg_kernels = phase_cg_kernels(dt, device, card)
    fluidflower = phase_fluidflower(dt, w2p, device, card, args.profile)
    rig_config = phase_rig_config(dt, w2p, lanes, device, card, args.profile, keep=True)
    analysis_run = phase_analysis_run(
        dt, w2p, lanes, rig_config.pop("handoff"), device, card, args.profile, keep=True
    )
    calibration_run = phase_calibration(dt, w2p, analysis_run.pop("handoff"), device, card, keep=True)
    fingers_run = phase_fingers(
        dt, w2p, lanes, calibration_run.pop("handoff"), device, card, args.profile, keep=True
    )
    photographs = phase_photographs(dt, w2p, lanes, fingers_run.pop("handoff"), device, card)
    sharded = phase_sharded(dt, w2p, device, card)
    display = phase_display(
        dt, w2p, main_path.pop("image"), transport["F5"].pop("info"), lanes["probe_u8"], device, card
    )
    gaps = phase_gaps(dt, w2p, lanes, device, display["O3"]["raised"], card)
    examples_run = phase_examples(dt, w2p, device, card)
    device_cases = phase_device_cases(dt, w2p, card)
    phase_volume(dt, device, card)
    phase_kernel_fields(w2p, lanes, device)

    passes = [k1["pass1"], k1["pass2"]]
    earlier = (
        main_path["launches"]
        + single["launches"]
        + sum(lane["launches"] for lane in series.values())
        + sum(p["launches"] for p in (flexible, after_frame, multiscale, series_corr))
        + sum(p["launches"] for p in (rig_read, drift_lane, drifting))
        + sum(p["launches"] for p in (piecewise, colour, saved, restoration))
    )
    later = tuple(
        p["launches"]
        for p in (
            colour_to_mass, fluidflower, rig_config, analysis_run, calibration_run, fingers_run,
            photographs, sharded, gaps, examples_run, device_cases,
        )
    )
    want = (
        K1_BEFORE_E, K1_IN_E, K1_IN_H, K1_IN_I, K1_IN_J, K1_IN_K, K1_IN_L, K1_IN_M, K1_IN_N, K1_IN_P, K1_IN_Q,
        K1_IN_R,
    )
    if (earlier, *later) != want:
        raise AssertionError(
            f"K1 launches: {earlier} before phase E (want {K1_BEFORE_E}), "
            f"{later[0]} in it (want {K1_IN_E}), {later[1]} in phase H (want {K1_IN_H}), "
            f"{later[2]} in phase I (want {K1_IN_I}), {later[3]} in phase J (want {K1_IN_J}), "
            f"{later[4]} in phase K (want {K1_IN_K}), {later[5]} in phase L (want {K1_IN_L}), "
            f"{later[6]} in phase M (want {K1_IN_M}), {later[7]} in phase N (want {K1_IN_N}), "
            f"{later[8]} in phase P (want {K1_IN_P}), {later[9]} in phase Q (want {K1_IN_Q}), "
            f"{later[10]} in phase R (want {K1_IN_R})"
        )
    k1_launches = earlier + sum(later)
    # The docstring's launch table states the same total.
    stated = int(re.search(r"\((\d+);\s+checked exactly\)", __doc__).group(1))
    if stated != k1_launches:
        raise AssertionError(f"K1 launches {k1_launches}, the docstring's table {stated}")
    results = {
        "warp_rows_t": {
            "launches": k1_launches,
            "max_abs_err": k1["max_abs_err"],
            "ms": sum(min(t["kernel_ms"]) for t in passes),
            "plain_ms": sum(min(t["plain_ms"]) for t in passes),
            "bound_ms": sum(t["bound_ms"] for t in passes),
            "bound_by": passes[0]["bound_by"],
            # One F.grid_sample on a transposed grid computes K1's function.
            "library_ms": sum(min(t["library_ms"]) for t in passes),
        }
    }
    for name, key in (("warp_rows", "K2_ms"), ("warp_rows_ring", "K3_ms")):
        results[name] = {
            "launches": rows["launches"][name],
            "max_abs_err": rows["max_abs_err"][name],
            "ms": sum(min(t[key]) for t in rows["timed"]),
            "plain_ms": sum(min(t["plain_ms"]) for t in rows["timed"]),
            "bound_ms": sum(t["bound_ms"] for t in rows["timed"]),
            "bound_by": rows["timed"][0]["bound_by"],
            # One F.grid_sample per case computes the row resample.
            "library_ms": sum(min(t["library_ms"]) for t in rows["timed"]),
        }
    kernels = []
    for name, (_, source, line) in KERNELS.items():
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": f"darsia_tpu_torch/{source}",
                "replaces": f"darsia_tpu/ops/pallas/warp2pass.py:{line}",
                **results[name],
            }
        )
    # The pressure solve's kernels: launches in the main path's runs (F1 and
    # G1), each read from 0 just before; times at the W1 cell's shape.
    main_runs = (transport["F1"]["mg_launches"], batched["batch8"]["mg_launches"])
    for name in CG_KERNELS:
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": "darsia_tpu_torch/csrc/tpfa_mg.cu",
                "replaces": None,
                "launches": sum(run[name] for run in main_runs),
                **cg_kernels[name],
            }
        )
    print(json.dumps({"kernels": kernels}))
    device_info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
